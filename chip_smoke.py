#!/usr/bin/env python3
"""Drive icikit_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``).
2. build: the kernels from ``icikit_torch/csrc`` with ``nvcc`` (sm_90a),
   with each listed kernel's registers and local (spill) bytes a thread
   and the recompute head's clusters the card holds at once; the sort,
   Adam, save-stack, recompute head, saved head backward, decode step
   (bf16 and int8), int8 matvec (skinny and tile), tile-floor and
   checksum kernels must use no local memory.
3. kernels: each kernel held against its plain PyTorch version on the
   card: K1 at T_GRID (the in-tile sort; a round pass in place) and K2
   at G_MAX bits, 1 bit and a middle range, merge_only and in place,
   ``local_sort`` at 2^16 and 2^20 for int32, float32, uint32 and
   bfloat16 plus a non-power-of-two length (int32, float32), and
   ``merge_bitonic`` at 2^20. Integers must agree bitwise, floats by
   value (the tolerance is exact).
4. main: ``sort`` of 2^28 int32 keys with p = 1 (the headline): 0
   inversions, bitwise equal to ``torch.sort`` (an oracle only), both
   kernels launched; timed by the median-of-windows protocol beside
   ``torch.sort`` and the memory-bandwidth bound of its launches.
5. ranks: the rank-vectorised sort of 2^24 keys at p = 2, 4, 8, whose
   merges run K2's merge-only pass.
6. timed launches: K1 and K2 timed at the main path's shapes (K1's
   in-tile sort, K2's most strided pass), and every launch of the
   2^28 schedule timed by events between launches and summed by kind
   (the in-tile sort, the round passes, the cross passes), beside the
   byte bound and the in-tile sort's int32 issue time.
7. attention kernels held against their plain versions on the card:
   ``flash_fwd`` at (b, h, d) = (8, 8, 128), s = 512 and 768, and at
   (1, 8, 128), s = 2048, in bf16 and float32, causal and not; at its
   tile edges (FWD_EDGES: s 65, 127, 129, 1000, 4097 at d 32, 64, 128,
   256, b 2, h 3), online and shift 16, causal and not;
   ``decode_step`` at 64 rows, dh 128, 576 columns, cur = 0, 1, 79, 80
   (where its splits go from 4 to 5), 300, 543, 575, RoPE on and off,
   bf16 and float32. Tolerances: float32 out and
   lse 1e-4; bf16 out 2e-2 (P is rounded to bf16 before PV in the
   kernel, against its running row max) and lse 1e-3; the cache columns
   bitwise. TF32 is off for both matmul backends.
8. the decode path: ``greedy_generate`` of the ``base`` preset (random
   float32 masters from a seeded generator, bf16 compute), batch 8,
   prompt 512, 64 new tokens, decode_step="fused", attention "flash":
   12 ``flash_fwd`` and 756 ``decode_step`` launches asserted; held
   against the same generate through the plain arms JAX itself offers
   (decode_step "unfused", attention "dense"): at float32 the tokens
   must agree except after a near-tie (a top-2 logit gap below 1e-3 at
   the first differing step), at bf16 the first step's logits within
   0.25; then tokens/s by the chained median-of-windows protocol beside
   the unfused arm, prefill ms, the byte-model bound per token and the
   device's idle share from a ``torch.profiler`` trace, which must show
   756 ``decode_step_kernel`` launches.
9. per-kernel numbers of the decode path's kernels at its shapes:
   ``decode_step`` by device time a launch behind a sleep kernel, its
   caches rotated past the L2 as the path's 12 layers' are, beside its
   bound and its device time a launch in phase 8's trace.
10. train kernels held against their plain versions on the card:
   ``flash_fwd`` in constant-shift mode and ``flash_bwd`` at (8, 8,
   1024, 128) and (1, 8, 2048, 128), causal and full, plus q x 400
   (the overflow the kernel redoes online), bf16 and float32; the redo
   where q x 400 lies only in the second warpgroup's rows or only in the
   ragged last Q tile (REDO_EDGES, d 64, 128, 256), its hot rows bitwise
   equal to the online pass's, their lse held relative to their largest
   |lse| and the other rows' absolute; the three
   cross-entropy kernels at T 8192, D 1024, V 32768. Tolerances are in
   the phase's line (FLASH_TOL, XENT_TOL).
11. the train path: ``make_train_step`` of the ``base`` preset (random
   float32 masters from a seeded generator), batch 8, s 1024, bf16,
   ``remat_policy="except_attn"``, ``softmax_shift=16``, the saved-exp
   fused head, ``FusedAdam(1e-4)`` with bf16 moments; tokens and targets
   from ``numpy.random.default_rng(0)``. 12 ``flash_fwd``, 12
   ``flash_bwd`` and one launch of each cross-entropy kernel per step
   asserted. At b = 2 the kernel arms are held against the plain arms
   (dense attention, unfused head) at float32: loss within 1e-4, every
   gradient leaf within a relative L2 error of 1e-3; the bf16 first-step
   loss within 1% of that; the loss falling over 5 steps. Then step ms,
   tokens/s and mfu by median-of-windows, and a ``torch.profiler``
   trace of one step (idle share, device time by kernel).
12. per-kernel numbers of the train path's kernels at its shapes; the
   saved head's dx and dw beside cuBLAS's product of the same shape on a
   materialized bf16 g (``g @ w``, ``g.T @ x``), the nearest yardstick.
13. the train step's other kernels held against their plain versions on
   the card: ``xent_g``, ``xent_g_saved``, ``xent_dx`` and ``xent_dw`` at
   T 8192, D 1024, V 32768 (XENT_TOL), ``xent_dx`` and ``xent_dw`` also at
   the ragged RECOMPUTE_RAGGED in bf16, and past one cluster's D 2048
   (the chunk walk: ``xent_g_bf16`` then ``xent_dx_g_bf16`` /
   ``xent_dw_g_bf16`` a chunk) at WIDE_EDGE and WIDE_SHAPE, each with the
   true lse and with lse less log V (``_lse_cases``: there g's softmax
   part outweighs the -dnll at a row's target, and a g without it must
   miss the tolerance), timed at
   WIDE_SHAPE beside their plain versions and their bound (two products
   each), one call of each traced: its logits launches one a chunk (the
   chunks partition the rows, so the logits are formed once), no kernel
   but the walk's (no cuBLAS), its scratch within a quarter of (T, V)
   in bf16; the Adam kernel on the base
   preset's leaves with each (m, v) pair of bf16 and float32 moments, ok
   absent, true and false, bit for bit; a bf16 step at V = 61, d_model
   128 (RAGGED_CFG), whose head the gate sends to the unfused path, its
   loss within TRAIN_BF16_TOL of the float32 plain arms', no xent
   launch; ``flash_bwd_dq``/``flash_bwd_dkv`` at (1, 8, 2048,
   128) and (1, 4, 8192, 128), causal and full, bf16 and float32, against
   ``flash_bwd_plain`` and against ``flash_bwd`` (FLASH_TOL of the largest
   entry, and BLOCK_L2_TOL relative L2 in every 64-row block).
14. the train arms: ``make_train_step`` of the ``base`` preset, b 8, s
   1024, bf16, with the recompute head (B10 recompute), the matmul head
   backward after the saved and the recompute forward (B11), and the
   one-pass Adam kernel (B12, float32 moments, as ``bench/train.py
   --optimizer fused-pallas``: one launch a step over the whole tree).
   Each arm's launches a step asserted; at b
   2 and float32 each arm held against the plain arms (dense attention,
   unfused head, PyTorch Adam) and the default arm: loss within 1e-4,
   every gradient leaf (the Adam arm: every parameter leaf after a step)
   within a relative L2 error of 1e-3; then step ms, tokens/s and mfu by
   phase 11's median-of-windows (one function runs every arm); the
   standalone Adam bench (``bench/adam.py``, 211 M parameters, bf16 and
   float32 gradients); and the kernels of this phase timed at the arms'
   shapes: the Adam kernel over the base tree at the step's gradient
   dtypes and at float32 gradients, each beside the bound of its own
   bytes, ``torch._fused_adam_`` at float32 gradients beside the second.
15. the long-context path: ``bench.attention.sweep_attention`` at s =
   32768 and 131072, b 1, h 4, d 128, bf16, causal, fwdbwd, impl
   ``flash``: one ``flash_bwd`` launch at 32768 and one of each two-pass
   kernel at 131072 asserted, each verified against the chunked plain
   oracle; TFLOP/s; the backward's dq, dk and dv at both lengths (``flash_bwd``
   at 32768, the two-pass kernels at 131072) held to the chunked plain
   versions within BLOCK_L2_TOL relative L2 in every 64-row block, and
   the two-pass outputs bitwise equal across two calls; then
   ``flash_bwd_dq`` and ``flash_bwd_dkv`` timed at (1, 4, 131072, 128)
   beside their chunked plain versions and SDPA's backward, each bounded
   by its share (3:4) of the function's five causal products;
   ``flash_fwd`` held to its chunked plain version at 131072 (out by
   BLOCK_L2_TOL in every 64-row block, lse by FLASH_TOL) and timed alone beside SDPA's causal forward and its bound (the two
   causal products, 17.8 ms); the bf16 flash kernels' registers, shared
   memory a CTA and CTAs an SM at every head dim.
16. the head dim 256: ``flash_fwd``, ``flash_bwd`` and the two-pass pair
   at d = 256 (WIDE_SHAPES) against their plain versions, bf16 and
   float32, with FLASH_TOL and BLOCK_L2_TOL; ``decode_step`` at dh 256
   and 384; ``greedy_generate`` of a d_head-256 MHA config (the base
   width, 4 heads, 2 layers), b 8, prompt 512, 16 new, its prefill
   ``flash_fwd`` and step launches asserted and its float32 tokens held
   to the plain arms; a float32 b 2 train step of that config against
   the plain arms (loss and gradients, flash launches asserted).
17. the int8 kernels against their plain versions: ``quant_matvec``
   (B15) at every (N, K) of the int8 path, rows 8, 4096 and 4095 (the
   tile kernel's last row tile cut short), and at a tp = 2 rank's (N, K)
   (Q8_TP_SHAPES, phase 30's int8 mesh), rows 8 and 4096, x in bf16 and
   float32 (QMV_TOL, relative to the largest entry);
   ``decode_step_q8`` (B14) at 64 rows, dh 128 and 256, 576 columns, cur
   0, 1, 127, 128, 300, 543, 575, and at rows 8, cur 543 and rows 1, cur
   575, where the picker leaves the last split empty (Q8_STEP_TOL; the
   int8 cache columns bit for bit).
18. the int8 decode path: ``greedy_generate`` of the ``base`` preset with
   decode_quant="int8", decode_step="fused", quant_matvec="auto",
   attention "flash", bf16, b 8, prompt 512, 64 new, the weights
   quantized once outside the timing: 12 ``flash_fwd``, 756
   ``decode_step_q8`` and 3136 ``quant_matvec`` launches asserted, no
   ``decode_step``; the caches int8 with float32 scales; at float32 the
   tokens equal the plain arms' (decode_step "unfused", quant_matvec
   "xla", attention "dense") except after a near-tie
   (INT8_FP32_LOGIT_TOL); at bf16 the first step's logits within
   BF16_LOGIT_TOL; the int8-vs-bf16 token agreement as information;
   tokens/s by the chained median-of-windows beside the bf16 fused arm,
   prefill ms, the int8 byte-model bound and the idle share; the trace
   must show 756 ``decode_step_q8_kernel`` launches.
19. per-kernel numbers of B15 and B14 at the int8 path's shapes: at
   rows 8 B15 at each of the five products, ``torch._weight_int8pack_mm``
   and cuBLAS's bf16 product, and B14, by device time a launch behind a
   sleep kernel, weights or caches rotated past the L2, each beside its
   bound, and B15's sum a step; rows 4096 the same on one copy of the
   weights, each of the prefill's four products beside its own bound,
   its library call and cuBLAS's bf16 product, and their sum a layer.
20. B17's kernels against their plain versions: ``tile_mxu`` and the
   four ``tile_ablate`` variants at (1, 2, s, d), s = 128, 384 and 512
   (one, three and four 128-key tiles: the ring's first pass, then its
   stages reused after an odd and an even count), d = 64
   and 128, bq = bk = 128 (``cuda_tile_floor.TILE``), within TILE_TOL of
   the largest |plain| entry (both round w to bf16 at scores whose
   float32 sums differ in order).
21. the tile-floor path: ``bench.tile_floor.measure`` at s = 32768, h 8,
   d = 64 and 128, 3 windows: the six variants' per-tile us in the
   kernels' 128 x 128 tiles beside the per-tile bound (4 TILE^2 d
   operations at 989 TFLOP/s) and the render's decomposition (what exp2
   and the running max cost inside ``flash_fwd``'s wgmma loop, and what
   ``flash_fwd`` itself loses against it); ``tile_mxu``, ``tile_ablate``
   and ``flash_fwd`` launched; then the five kernels against their plain
   versions at (1, 8, 32768, d), d = 64 and 128, within TILE_TOL, and
   at both d timed, ``softmax_ks1`` beside non-causal
   ``scaled_dot_product_attention`` (the same function) at that d.
22. B16's kernels against their plain versions, bit for bit: every slice
   shape and dtype of the save-stack path's stacks at slices 0, 5, 11,
   and a slice off JAX's gate, which takes the plain copy and launches
   nothing.
23. the save-stack train path: ``make_train_step`` of the ``base`` preset,
   b 8, s 1024, bf16, phase 11's config with ``save_stack="pallas"``:
   84 ``stack_write``, 12 ``stack_read``, 24 ``flash_fwd``, 12
   ``flash_bwd`` and one launch of each cross-entropy kernel a step
   asserted (SAVE_STACK_LAUNCHES); at b 2 and float32 held against the
   default and the plain arms with phase 11's tolerances, the bf16
   first-step loss and the loss falling over 5 steps; step ms, tokens/s
   and mfu by phase 11's median-of-windows beside a second run of the
   default arm, and the idle share from a ``torch.profiler`` trace; then
   B16's kernels timed cold at the residual slice (the 12 slices of the
   stack in rotation, device time behind a sleep kernel) beside
   ``copy_`` timed the same way, their device time a launch in the
   step's trace, the host's time a call (the full per-call path, the
   layer loop's checked-once copier and ``copy_``) and the card's copy
   rate at 1 GiB.
24. the collectives (``icikit_torch.parallel``, ``bench.harness``): the
   reference sweep in int32 (1 to 65536 elements a block, to 4096 for
   alltoall) through every variant of the nine families at p = 8 and
   through those that take any p at p = 6; BASELINE.json's two
   configurations in float32 at p = 8, allreduce at 2^20 elements and
   broadcast, scatter and gather at 1 KB to 64 MB a block (COLL_*):
   each record with JAX's fields (per rank), the card's aggregate rate
   (p x bus bytes / best time) and the least-bytes bound (every rank's
   input read once and output written once); the allreduce's device
   enqueues a call by variant from the host's side of a
   ``torch.profiler`` trace of COLL_TRACE_CALLS calls (in a fresh
   process, as phase 26's), and its device
   events where the trace kept them all, with its copies by direction
   (no host-to-device copy in a repeated call; a trace that lost a
   copy's or set's record counts as no trace).
   Every record must verify, and every hand-rolled schedule (with
   ``all_to_all_v``'s carriers, ``top_k_dist`` and ``allreduce_loc``)
   must equal the same schedule on a CPU ``RankMesh`` bit for bit at
   4096 elements a block.
25. the four-sort study (``bench.sort.sweep_sorts``): BASELINE.json's
   2^24 int32 keys at p = 8, uniform and odd_dist, all four algorithms,
   each with 0 inversions, equal to ``torch.sort`` (an oracle only),
   ``net_kernel`` and ``cross_kernel`` launched, keys/s by the
   median-of-windows protocol beside ``torch.sort``'s time and the sort
   floor; the same at p = 1, checked; the reference's float study at
   50,000,000 keys (odd_dist float32, all four, and one bfloat16 row),
   checked; the forced retries (sample at cap_factor 0.5, quicksort at
   1.0, odd_dist keys) taken and still sorted; ``sort_kv`` and
   ``argsort_dist`` at 2^24 int32 keys with int32 values, values
   following keys as ``torch.argsort(stable=True)``; and the stages of
   the sample sort and quicksort at 2^24 timed apart (the post-exchange
   sort of p x cap keys a rank, quicksort's re-sorts of its 2 n_loc
   buffers).
26. the checked transport (``parallel.integrity``): the checksum kernel
   against its plain version bit for bit at every element width (8, 16,
   32, 64 bits; bool and bf16 views), rows of CHECKSUM_NS elements and
   the checked sort's 8 x 2^21 int32, on aligned and misaligned bases;
   every checked family x hand-rolled variant at p = 8 (the any-p ones
   also at 6), COLL_CHECK_MSIZE a block: clean output bitwise equal to
   the unchecked one, and one scheduled drill each, detected once,
   recovered, output equal; ``sort(checked=True)`` of 2^24 int32 keys at
   p = 8 equal to ``sort()``, 0 inversions, and one drill recovered, its
   checksum launches counted; the kernel timed at 8 x 2^21 int32 beside
   its bound and its plain version; checked against unchecked ms for
   allreduce float32[2^20] a rank at p = 8 (ring, recursive_doubling)
   and the 2^24 sort, in turns; a ``torch.profiler`` trace of clean
   checked ring allreduces, taken in a fresh process: no host-to-device
   copy, one device-to-host copy a call (the verdict).
27. the load-balancing study (``models.solitaire``): the port's native
   runtime built from ``icikit_torch/native/src`` and active; the DFS
   kernel (I2) against its plain version bit for bit on all five outputs
   at DFS_CHECK_STEPS (DFS_CHECK_SETS, seed 0) and on the edge boards at
   DFS_EDGE_STEPS; at full size (DFS_FULL, seed 0, DFS_MAX_STEPS)
   against the native host solver, bit for bit on solved, n_moves, moves
   and steps; the main path: ``solve_static`` and ``solve_dynamic`` with
   DFS_WORKERS workers (streams of the card) on each full-size grade and
   on northstar's skewed set (DFS_SKEW), agreeing with each other and
   the host on the solutions and steps, I2 launched, per-worker steps
   and the imbalance printed; one ``solve_dynamic`` drill (a scheduled
   death of worker 1) healed, its output equal to the clean run's; I2
   timed by events, median of windows, at each full-size batch beside
   its two bounds (the critical path: max steps x DFS_STEP_CHAIN
   dependent ops of DEP_CYCLES at SM_CLOCK_HZ, and beside it the same
   at the compiled step's DFS_SASS_CHAIN; the throughput: the
   steps x DFS_STEP_OPS at VECTOR_OPS), the native host solver's wall
   time, and the plain version's time at DFS_CHECK_STEPS; two probes of
   a step's cost at DFS_MAX_STEPS, the lone lane (the first capped hard
   board alone in a launch) and the full warp (the first 32 capped hard
   boards), each in ns and cycles a step at the SM clock ``nvidia-smi``
   reads while it runs, their outputs equal to the host's; I2's
   registers, spill and shared bytes on the ``build`` line; and
   ``python -m icikit_torch.bench.northstar --quick`` in a child
   process, every check it prints passed.
28. the multi-process layer (``parallel.multihost``, ``parallel.pt2pt``,
   the transport's process backend): in this process on the card, the
   four hierarchical collectives at each (dcn, ici) of HIER_MESHES,
   HIER_M elements a rank, int32 and float32, every tier algorithm and
   op the JAX tests name (``_hier_cases``): int32 bitwise equal to the
   flat ``xla`` collective (the reduce-scatter's rows reordered by
   ``hier_chunk_index``), float32 bitwise equal to the port's CPU run of
   the same call, except a float sum through an ``xla`` tier (torch's
   own reduction adds in the device's order), held within 2 (p - 1)
   2^-24 sum|x| of it; the hierarchical ring/ring allreduce timed beside
   the flat ring and ``xla`` at float32 HIER_M a rank, (2, 4), by the
   median-of-windows protocol. Then two child processes on the one card
   (``examples.multihost``: gloo on a ``utils.net.free_port`` port,
   retried on a port race, each child with its own deadline
   MH_TIMEOUT), four ranks each: the flat families' variants at p = 8,
   the hierarchical four at (2, 4) and the pt2pt primitives at MH_M a
   rank, and the cases the process backend gained (broadcast, scatter
   and gather in every variant, ``allreduce_loc``, ``all_gather_v``,
   ``all_to_all_v``, a checked ring allreduce clean and with one drilled
   bit flip, the sample, sample-bitonic, quicksort and checked bitonic
   sorts and ``sort_kv`` of 2^SORT_LOG2N keys), each child's rows stacked
   equal to this process's run of the same cases on the card bit for
   bit, each child seeing the drill once, retrying once and recovering,
   each sort case launching the sort kernels and each checked case the
   fold I1 in each child; the bitonic sort of 2^MH_LOG2N
   int32 keys at p = 8, each child's sorted rows (by sha256) equal to
   this process's sort, 0 inversions counted across the processes,
   both sort kernels launched in each child; its wall time, the bytes
   that crossed the process boundary and the launches a child printed,
   labelled as the host's wire.
29. the model mesh (``models/transformer`` at dp, tp, sp > 1, its ranks
   rows of the card): at the base width, float32, b 2, s 1024,
   MESH_CHECK_LAYERS layers, each mesh of MESH_CHECKS (dp, tp and sp
   alone, sp under ring, zigzag and ulysses, (2, 2, 2) ring, tp with the
   vocab-parallel head, dp with the matmul head backward) held against
   the (1, 1, 1) step's loss (TRAIN_LOSS_TOL) and every gradient leaf
   (TRAIN_GRAD_TOL relative L2), each with the flash and head kernels
   it runs launched; at phase 11's bf16 config (b 8, s 1024, 12
   layers) the MESH_TIMED ring step and the (1, 1, 1) step, each's
   launches a step by kernel asserted (the ring's flash calls: sp a
   layer and dp rank; the fused head: one call a rank), timed by the
   median-of-windows protocol, the gradient sync (every pvary's psum)
   and its dp part timed by events, and a ``torch.profiler`` trace of
   the MESH_TIMED step in a fresh process (device time by kernel, the
   idle share); ``grad_check="ring"`` at (2, 2, 2) on the checks'
   config, a clean step committed (its loss bitwise the unchecked
   step's, its parameters within MESH_RING_TOL relative L2 of them, the
   fold I1 launched) and a drilled one
   (``corrupt:collective.train.grad_sync``) committing nothing; and two
   child processes (``examples.multihost --mode train``, gloo on the
   one card) taking two dp = 2 steps, one dp rank each, their loss,
   first gradients and parameters bit for bit this process's dp = 2
   steps, the flash and head kernels launched in each.
30. decode on the mesh and sampled decode (``greedy_generate`` and
   ``sample_generate`` at dp, tp > 1, the ranks rows of the card) at
   phase 8's cell (base, b 8, prompt 512, 64 new, decode_step="fused",
   attention "flash"), each generate's launches asserted by kernel (one
   ``flash_fwd`` and one ``decode_step`` or ``decode_step_q8`` a layer
   at every mesh; under int8 one ``quant_matvec`` a tp rank a product
   and one for the head): float32 greedy at each mesh of MESH_DECODE
   ((1, 4, 1) with the vocab-parallel head) against the (1, 1, 1)
   generate, the tokens equal except after a near-tie (phase 8's rule,
   FP32_LOGIT_TOL); bf16 at MESH_DECODE_TIMED, the first step's logits
   within BF16_LOGIT_TOL of (1, 1, 1)'s; int8 at float32 there against
   int8 at (1, 1, 1) (INT8_FP32_LOGIT_TOL, phase 18's reason), and the
   int8 bf16 generate there (B15's ``qmv_bf16_*``) its first step's
   logits within BF16_LOGIT_TOL of int8 bf16 at (1, 1, 1)'s; the sampled
   arm at float32 (``bench/decode.py``'s SAMPLE_KNOBS with top_p
   SAMPLE_TOP_P, key data of its SAMPLE_SEED) at
   MESH_DECODE_TIMED against (1, 1, 1): equal except after a draw whose
   top-2 gap of Gumbel plus filtered logits is below DRAW_TIE_TOL;
   temperature 0 bitwise the greedy tokens; every draw's key data and
   the first draws' bits on the card bitwise the CPU's; CHI2_DRAWS draws
   from one filtered row against its softmax by chi-square (p above
   CHI2_P, none outside the support); then bf16 tokens/s by the chained
   median-of-windows protocol at (1, 1, 1) and MESH_DECODE_TIMED and of
   the sampled arm at (1, 1, 1), one window an arm in each of
   TIMING_TURNS alternating turns (a draw's cost a token: the median of
   each turn's sampled less greedy), and a ``torch.profiler`` trace, in
   a fresh process, of the MESH_DECODE_TIMED generate (device time by
   kernel, the idle share), of one step's draw and of a generate's
   Gumbel noise (their launches).
31. the collectives study (``bench.scaling``, ``bench.crossover``, the
   examples): ``run_scaling_sweep`` of allgather and alltoall, every
   variant, at p in STUDY_PS ranks on the card, STUDY_SIZES, STUDY_RUNS
   runs (each scale point a subprocess of ``bench.run``), every record
   verified; one sort point (``bench.sort`` in a subprocess) of
   2^STUDY_SORT_LOG2N int32 keys at p = STUDY_SORT_P, the four sorts, 0
   inversions and equal to ``torch.sort``; one broadcast point with its
   ranks split across two processes (``--processes 2``, gloo), verified;
   the crossover model's merge rate (``measure_merge_rate``, 2^22 int32
   on the card) and the comparator rate phase 4's sort implies;
   ``dryrun_multichip(8)`` on the card; ``collectives_study`` on the
   card, every record verified. Records, rates and ``nvidia-smi``'s line
   on the phase's lines.
32. kernels line: every ported kernel with its launches on its main path,
   its time at that path's shapes, its plain version's time, a library
   call's time where one computes the same function, and its bound; the
   sort kernels also with their launches on each algorithm's 2^24 path
   and in each child of the two-process 2^28 sort and sort cases, the
   fold I1 in each child's checked cases, the train path's
   kernels with their launches on phase 29's mesh step, and the decode
   path's with their launches a phase-30 generate at each mesh.

The line before the last is ``nvidia-smi``'s name and power limit; the
last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

# Published H100 SXM peaks (NVIDIA data sheet): device memory, and the
# 32-bit rate outside the tensor cores, used for the bound of a kernel's
# compare-exchange work (a compare-exchange counted as 2 operations).
MEM_BPS_SXM = 3.35e12
VECTOR_OPS = 67e12
BF16_TENSOR_OPS = 989e12
MULT = -1640531527

# Decode path (phase 8): the base preset at batch 8, prompt 512, 64 new.
DEC_PRESET, DEC_BATCH, DEC_PROMPT, DEC_NEW = "base", 8, 512, 64
FP32_LOGIT_TOL = 1e-3
BF16_LOGIT_TOL = 0.25

# Phase 7: the forward's tile edges, lengths on and beside its 64- and
# 128-row (and key) tiles at every head dim built, at (b, h) = (2, 3)
FWD_EDGES = tuple((s, d) for s in (65, 127, 129, 1000, 4097)
                  for d in (32, 64, 128, 256))

# Train path (phases 10-12): the base preset at batch 8, s = 1024.
TRAIN_PRESET, TRAIN_BATCH, TRAIN_CHECK_BATCH = "base", 8, 2
TRAIN_TOKENS = TRAIN_BATCH * 1024
TRAIN_LR = 1e-4
SHIFT = 16.0
# (b, h, s, d) of the path's flash launches, and the many-block regime
FLASH_SHAPES = {"B5-shift": (TRAIN_BATCH, 8, 1024, 128),
                "B4": (1, 8, 2048, 128)}
# Phase 10: the shift's overflow redo at the forward's tile edges, (s,
# rows x 400): the second warpgroup's 64 rows of each 128-row CTA, and
# the ragged last Q tile
REDO_EDGES = ((256, ((64, 128), (192, 256))), (1000, ((960, 1000),)))
XENT_SHAPE = (TRAIN_TOKENS, 1024, 32768)   # (T, D, V) of the head
TRAIN_LOSS_TOL = 1e-4      # float32 kernel arms vs plain arms
TRAIN_GRAD_TOL = 1e-3      # relative L2, each gradient leaf
TRAIN_BF16_TOL = 1e-2      # bf16 first-step loss vs the fp32 plain arm
FLASH_TOL = {"bf16": {"out": 2e-2, "lse": 1e-3, "grad": 2e-2,
                      "grad_hot": 2e-2},
             "f32": {"out": 1e-4, "lse": 1e-4, "grad": 1e-4,
                     "grad_hot": 1e-3}}
XENT_TOL = {"bf16": {"lse": 1e-3, "grad": 2e-2},
            "f32": {"lse": 1e-4, "grad": 1e-4}}
# B9's and B11's nearest yardstick (phases 12 and 14): no PyTorch call
# forms the logits' lse or g; cuBLAS forms the same product
XW_YARDSTICK = ("cuBLAS x @ w.T, bf16 out: the same logits product (and "
                "the (T, V) bytes of e and g), not the same function")
# Phase 13: a config whose bf16 head the gate sends to the unfused path
# (V not a multiple of 8) at d_model 128
RAGGED_CFG = dict(vocab=61, d_model=128, n_heads=4, d_head=32, d_ff=512,
                  n_layers=2, max_seq=256)
# Phase 13: the recompute head kernels (B10 recompute) at (T, D, V) off
# every tile of theirs (128 rows, 256-column slices of D, 64-wide steps),
# and past one cluster's D 2048 (the chunk walk)
RECOMPUTE_RAGGED = ((300, 136, 1000), (1000, 520, 4104), (300, 2176, 1000))
# The two-pass backward's check shapes, and the long-context path's
TWO_PASS_SHAPES = ((1, 8, 2048, 128), (1, 4, 8192, 128))
LONG_SEQS = (32768, 131072)
LONG_SHAPE = (1, 4, 128)                      # (b, h, d)
# Long-sequence gradients against their plain versions: relative L2 in
# each 64-row block (a kernel's tile), the largest over the blocks. dq
# and dk shrink along the rows, so an error relative to the largest
# entry would pass a kernel that got the later tiles wrong.
BLOCK_ROWS = 64
BLOCK_L2_TOL = {"bf16": 1e-2, "f32": 1e-4}
# The train arms (phases 11 and 14): config overrides, FusedAdam's
# use_pallas, and the kernels the arm launches once a step (the Adam
# kernel once, over the whole tree) beside flash_fwd, flash_bwd and
# xent_fwd
ARMS = {"default": ({}, False, ("xent_dx_saved", "xent_dw_saved")),
        "head-recompute": (dict(xent_save_exp=False), False,
                           ("xent_dx", "xent_dw")),
        "hb-matmul-saved": (dict(xent_fused_bwd=False), False,
                            ("xent_g_saved",)),
        "hb-matmul-recompute": (dict(xent_save_exp=False,
                                     xent_fused_bwd=False), False,
                                ("xent_g",)),
        "adam-kernel": ({}, True, ("xent_dx_saved", "xent_dw_saved",
                                   "adam"))}
# The save-stack arm (phase 23), an arm in ARMS' form run on its own
# path; a step at base: 12 layers, each writing its input and its six
# gradient slices (ln1, ln2, wqkv, wo, w1, w2, all on JAX's gate)
# through stack_write, reading its input back through stack_read and
# running its forward again in the backward
SAVE_STACK_ARM = (dict(save_stack="pallas"), False,
                  ("xent_dx_saved", "xent_dw_saved"))
SAVE_STACK_LAUNCHES = {"stack_write": 12 * 7, "stack_read": 12,
                       "flash_fwd": 24, "flash_bwd": 12}
# bitonic_net.cu's kernels in icikit_kernel_regs' order: K1 at tiles of
# 2^10..2^15 keys, K2 at 1..10 bits
SORT_KERNELS = tuple(f"net_kernel<{L}>" for L in range(10, 16)) + tuple(
    f"cross_kernel<{g}>" for g in range(1, 11))
# tile_floor.cu's kernels in icikit_tile_floor_regs' order (B17)
TILE_KERNELS = tuple(
    f"{k}<{d}{a}>" for d in (64, 128)
    for k, a in (("tile_mxu", ""), ("tile_ablate", ", SOFTMAX"),
                 ("tile_ablate", ", NO_EXP2"), ("tile_ablate", ", NO_MAX"),
                 ("tile_ablate", ", NO_EXP2_NO_MAX")))
# integrity.cu's kernels in icikit_integrity_regs' order: 8-, 16-, 32-
# and 64-bit elements, each by 16-byte words and by elements
INTEGRITY_KERNELS = tuple(
    f"segment_checksum_kernel<u{b}, {how}>" for b in (8, 16, 32, 64)
    for how in ("vec", "scalar"))
# Phase 2: kernels that must use no local memory (registers only)
NO_LOCAL_MEMORY = SORT_KERNELS + INTEGRITY_KERNELS + (
    "adam_tree_kernel<f32 moments>", "adam_tree_kernel<bf16 moments>",
    "adam_tree_kernel<f32 m, bf16 v>", "adam_tree_kernel<bf16 m, f32 v>",
    "stack_write_kernel", "stack_read_kernel",
    "xent_recompute_bf16<dx>", "xent_recompute_bf16<dw>",
    "xent_dx_g_bf16", "xent_dw_g_bf16",
    "decode_step_q8_kernel<bf16>", "decode_step_q8_kernel<float>",
    "decode_step_kernel<bf16>", "decode_step_kernel<float>",
    "qmv_bf16_tile", "xent_dx_bf16", "xent_dw_bf16", "xent_fwd_bf16",
    "xent_g_bf16", "xent_merge") + TILE_KERNELS + tuple(
    f"qmv_bf16_skinny<{cpw}, 1>" for cpw in (1, 2, 4, 8)) + tuple(
    f"qmv_bf16_skinny<{cpw}, 2>" for cpw in (1, 2, 4))
# Phases 20-21, B17: the check shapes (b, h, s), one, three and four
# 128-key tiles, and the tile-floor path's (h, seq) at head dims 64 and
# 128; the check tolerance, relative to the largest |plain| entry
TILE_CHECK = ((1, 2, 128), (1, 2, 384), (1, 2, 512))
TILE_PATH = (8, 32768)
TILE_DIMS = (64, 128)
TILE_TOL = 2e-2
# Phase 22, B16: the slice shapes and dtypes of the save-stack path's
# stacks (the residual, then the gradient leaves at grad_dtype="compute"),
# the slices checked, and a slice off JAX's gate (9 rows of bf16)
STACK_SLICES = {"residual": ((TRAIN_BATCH, 1024, 1024), "bfloat16"),
                "wqkv": ((1024, 3, 8, 128), "bfloat16"),
                "wo": ((8, 128, 1024), "bfloat16"),
                "w1": ((1024, 4096), "bfloat16"),
                "w2": ((4096, 1024), "bfloat16"),
                "ln1, ln2": ((1024,), "float32")}
STACK_CHECK_I = (0, 5, 11)
STACK_OFF_GATE = ((9, 128), "bfloat16")
# Phase 16: the flash kernels' d = 256 builds at (b, h, s, d), and a
# d_head-256 MHA config at the base width cut to two layers
WIDE_SHAPES = ((2, 4, 1024, 256), (1, 4, 2048, 256))
WIDE_CFG = dict(n_heads=4, d_head=256, n_layers=2)
WIDE_NEW = 16
TRAIN_SEQ_WIDE = 1024
# Phases 17-19, the int8 decode path: B15's (N, K) on it, its rows (the
# step's b and the prefill's b * s), the rows the kernels line reports,
# and the tolerances (relative to the largest |reference| entry for B15,
# absolute for B14's float32 output)
Q8_SHAPES = {"wqkv": (3072, 1024), "wo": (1024, 1024), "w1": (4096, 1024),
             "w2": (1024, 4096), "w_out": (32768, 1024)}
Q8_ROWS = (DEC_BATCH, DEC_BATCH * DEC_PROMPT)
# phase 17 also checks a ragged prefill row count (the tile kernel's
# 256-row tile cut short)
Q8_CHECK_ROWS = Q8_ROWS + (DEC_BATCH * DEC_PROMPT - 1,)
Q8_PREFILL = ("wqkv", "wo", "w1", "w2")   # a layer's products
Q8_ROW_ENTRIES = (("wqkv", DEC_BATCH), ("w_out", DEC_BATCH)) + tuple(
    (nm, DEC_BATCH * DEC_PROMPT) for nm in Q8_PREFILL)
# B15's (N, K) on a tp = 2 rank: wqkv's and w1's columns split in two,
# wo's and w2's contraction
Q8_TP_SHAPES = {"wqkv": (1536, 1024), "wo": (1024, 512), "w1": (2048, 1024),
                "w2": (1024, 2048)}
QMV_TOL = {"bf16": 1e-4, "f32": 1e-5}
Q8_STEP_TOL = 1e-5
# int8 float32 tokens against the plain arms: a K/V element that sits
# within float32 rounding of an int8 rounding boundary lands on the
# neighbouring int8 value in one arm, which moves the logits by far more
# than float32 rounding does
INT8_FP32_LOGIT_TOL = 5e-2
# Phase 13: B10 recompute past one cluster's D 2048 (the chunk walk,
# cuda_xent.recompute_walk) timed at (T, D, V), bf16, and held at a card
# test's shape off the chunk edges (dx: four chunks of 272 tokens and one
# of 12; dw: four of 1024 vocabulary rows and one of 8); the walk's
# kernels (a chunk's logits and g, its product) and the traces taken at
# most to get one that kept every device record
WIDE_SHAPE = (TRAIN_TOKENS, 4096, 32768)
WIDE_EDGE = (1100, 4096, 4104)
WIDE_KERNELS = {"dx": ("xent_g_bf16", "xent_dx_g_bf16"),
                 "dw": ("xent_g_bf16", "xent_dw_g_bf16")}
WIDE_TRACE_ATTEMPTS = 8
# Phase 24, the collectives: every variant at p = 8 and, where it takes
# any p, at 6; BASELINE.json's two configurations in float32 at p = 8
# (allreduce at 2^20 elements; broadcast, scatter and gather at 1 KB to
# 64 MB a block in steps of x4); the card held bitwise to the CPU at
# 4096 elements a block
COLL_P, COLL_P_ODD = 8, 6
COLL_BASELINE_ALLREDUCE = 1 << 20
COLL_BASELINE_SWEEP = tuple(1 << l for l in range(8, 25, 2))
COLL_CHECK_MSIZE = 4096
# calls a launch-count trace spans, and traces taken at most to get one
# that kept every device record (or, failing that, every copy's and
# set's: a lost kernel's launch is still counted on the host)
COLL_TRACE_CALLS = 5
COLL_TRACE_ATTEMPTS = 8
COLL_LAUNCH_CALL = re.compile(r"cu(da)?Launch")
# traces of a generate or a train step taken at most to get one that
# kept every device record (utils/trace.summarize)
TRACE_ATTEMPTS = 3
COLL_ROOTS = (0, 3, 7)
# the variants that refuse a p that is not a power of two, as JAX's do
COLL_POW2_ONLY = {("allgather", "recursive_doubling"), ("alltoall", "ecube"),
                  ("alltoall", "hypercube"),
                  ("allreduce", "recursive_doubling"),
                  ("reducescatter", "recursive_halving"),
                  ("scatter", "binomial"), ("gather", "binomial")}


# Phase 25, the four-sort study: BASELINE.json's configuration (2^24
# int32 keys at p = 8), the reference's float study (50,000,000 keys),
# the bfloat16 row's algorithm, and the capacity factors that force each
# retry path
STUDY_N, STUDY_P = 1 << 24, 8
STUDY_FLOAT_N = 50_000_000
STUDY_BF16_ALG = "quicksort"
STUDY_RETRY = (("sample", 0.5), ("quicksort", 1.0))
# Phase 26, the checked transport: the checksum kernel's check lengths
# (rows of CHECKSUM_P) and its timed shape (the checked sort's exchange
# block at 2^24 keys, p = 8); the checked collectives at COLL_P (the
# any-p variants also at COLL_P_ODD), COLL_CHECK_MSIZE a block; the
# checked/unchecked timings (allreduce float32[2^20] a rank, the
# 2^24-key sort), in CHECKED_WINDOWS windows of CHECKED_CALLS calls
# taken in turns (unchecked, checked, checked, unchecked)
CHECKSUM_P, CHECKSUM_NS = 3, (0, 1, (1 << 20) + 3)
CHECKSUM_SHAPE = (8, 1 << 21)
CHECKED_ALGS = ("ring", "recursive_doubling")
CHECKED_WINDOWS, CHECKED_CALLS = 4, 8
# Phase 27, the load-balancing study: I2's check sets (grade, boards) and
# budget, the edge boards of tests/test_solitaire.py (one peg, empty,
# full, three in a row, domino, square, NA cells) and their budgets; the
# full-size batches (seed 0) at northstar's budget; the workers (streams
# of the card); northstar's skewed set (boards, hard fraction, chunk,
# seed); the bounds: 32-bit ops a DFS step, the dependent ones among
# them, cycles a dependent integer op and the SM clock (H100 SXM boost);
# the timing windows and launches a window
DFS_CHECK_SETS = (("easy", 512), ("medium", 256), ("hard", 64))
DFS_CHECK_STEPS = 2000
DFS_EDGE_BOARDS = ("1" + "0" * 24, "0" * 25, "1" * 25, "111" + "0" * 22,
                   "110" + "0" * 22, "11000" * 2 + "0" * 15,
                   "112" + "0" * 22)
DFS_EDGE_STEPS = (1, 3, DFS_CHECK_STEPS)
DFS_FULL = (("easy", 20_000), ("medium", 20_000), ("hard", 1_000))
DFS_MAX_STEPS = 500_000
DFS_WORKERS = 8
DFS_SKEW = (256, 0.25, 4, 3)
DFS_STEP_OPS, DFS_STEP_CHAIN = 80, 16
# the dependent chain of one step as the kernel compiles it (cuobjdump
# -sass of solve_dfs_kernel: 7 LOP3, 3 IMAD, LEA.HI, 2 SHF), a tighter
# critical path given beside DFS_STEP_CHAIN's
DFS_SASS_CHAIN = 13

# Phase 28: the hierarchical collectives at each (dcn, ici) of
# HIER_MESHES with HIER_M elements a rank, one process on the card; the
# two-process run (``examples.multihost``) at MH_M a rank for the
# collectives and 2^MH_LOG2N int32 keys for the sort, MH_SORT_RUNS sorts
# timed, each child's deadline MH_TIMEOUT seconds.
HIER_MESHES = ((2, 4), (4, 2))
HIER_M = 1 << 20
MH_M = 1 << 16
MH_LOG2N = 28
MH_SORT_RUNS = 2
MH_TIMEOUT = 240
# Phase 29: the model mesh. Checks at the base width, float32, b 2, s
# 1024 and MESH_CHECK_LAYERS layers (cut from 12: the mesh's math is a
# layer's, repeated), each mesh's loss and gradients against the (1, 1,
# 1) step's with phase 11's tolerances; the (2, 2, 2) ring step timed
# beside the (1, 1, 1) step at phase 11's bf16 config.
MESH_CHECK_LAYERS = 2
MESH_CHECKS = (
    ((2, 1, 1), {}), ((1, 2, 1), {}),
    ((1, 1, 2), dict(sequence_schedule="ring")),
    ((1, 1, 2), dict(sequence_schedule="zigzag")),
    ((1, 1, 2), dict(sequence_schedule="ulysses")),
    ((2, 2, 2), dict(sequence_schedule="ring")),
    ((1, 2, 1), dict(vocab_parallel=True)),
    ((2, 1, 1), dict(xent_fused_bwd=False)))
MESH_TIMED = (2, 2, 2)
# A clean checked step's parameters against the unchecked step's: the
# same update but for flash_bwd's dq, whose atomic sums differ in their
# last bits from run to run; Adam's first step moves every element by
# about its learning rate whatever its gradient's size, so a tiny
# gradient's flipped sign shows (1.1e-6 on an H100 at 700 W).
MESH_RING_TOL = 1e-5
MESH_STEPS_A_RUN = 2
# Phase 30: decode on the mesh, at phase 8's cell (base, b 8, prompt 512,
# 64 new, fused, flash): float32 greedy at each (dp, tp, 1) of
# MESH_DECODE (with its config overrides) against the (1, 1, 1) generate;
# bf16, int8 and the sampled arm at MESH_DECODE_TIMED against (1, 1, 1);
# JAX's sampled arm (bench/decode.py's key seed and knobs) with a
# nucleus, held by the draw's top-2 gap (Gumbel plus filtered logits);
# the frequency check's draws, their chunk and its chi-square level; the
# timing's alternating turns.
MESH_DECODE = (((2, 1), {}), ((1, 2), {}), ((2, 2), {}),
               ((1, 4), dict(vocab_parallel=True)))
MESH_DECODE_TIMED = (2, 2)
SAMPLE_TOP_P = 0.9
DRAW_TIE_TOL = 1e-5
CHI2_DRAWS, CHI2_CHUNK, CHI2_P, CHI2_MIN_EXPECTED = 1 << 17, 8192, 1e-3, 5
TIMING_TURNS = 2
# Phase 31, the collectives study: the scaling sweep's rank counts,
# sizes, runs a point and a point's deadline; the sort point's ranks
# and keys (each point a subprocess of the bench CLI, as JAX's study)
STUDY_PS = (2, 4, 8)
STUDY_SIZES = (256, 65536)
STUDY_RUNS = 3
STUDY_TIMEOUT = 300
STUDY_SORT_P, STUDY_SORT_LOG2N = 8, 20
SORT_ALGS = ("bitonic", "sample", "sample_bitonic", "quicksort")
DEP_CYCLES, SM_CLOCK_HZ = 4, 1.98e9
DFS_WINDOWS, DFS_ITERS = 3, 2


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also says how long the script had
    run when it was printed."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - _T0, 1)}
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60,
                       check=True)
    return q.stdout.strip().splitlines()[0]


def attention_checks(torch, dev) -> None:
    """Phase 7: each attention kernel against its plain version."""
    from icikit_torch.ops import _build
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops.rope import rope_sincos

    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def err(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    checks = []
    for dtype, o_tol, l_tol in ((torch.bfloat16, 2e-2, 1e-3),
                                (torch.float32, 1e-4, 1e-4)):
        for b, h, s in ((8, 8, 512), (8, 8, 768), (1, 8, 2048)):
            q, k, v = (randn((b, h, s, 128), dtype) for _ in range(3))
            for causal in (True, False):
                out, lse = ca.flash_fwd(q, k, v, causal, 128 ** -0.5)
                want, want_lse = ca.flash_fwd_plain(q, k, v, causal,
                                                    128 ** -0.5)
                e_o, e_l = err(out, want), err(lse, want_lse)
                checks.append({"kernel": "flash_fwd", "dtype": str(dtype),
                               "shape": [b, h, s, 128], "causal": causal,
                               "out_err": e_o, "lse_err": e_l,
                               "ok": e_o <= o_tol and e_l <= l_tol})
            del q, k, v, out, lse, want, want_lse
        for s, d in FWD_EDGES:
            q, k, v = (randn((2, 3, s, d), dtype) for _ in range(3))
            for causal in (True, False):
                for shift in (None, SHIFT):
                    out, lse = ca.flash_fwd(q, k, v, causal, d ** -0.5,
                                            shift=shift)
                    want, want_lse = ca.flash_fwd_plain(
                        q, k, v, causal, d ** -0.5, shift=shift)
                    e_o, e_l = err(out, want), err(lse, want_lse)
                    checks.append({"kernel": "flash_fwd", "edge": True,
                                   "dtype": str(dtype),
                                   "shape": [2, 3, s, d], "causal": causal,
                                   "shift": shift, "out_err": e_o,
                                   "lse_err": e_l,
                                   "ok": e_o <= o_tol and e_l <= l_tol})
            del q, k, v, out, lse, want, want_lse
        rows, total, dh = 64, 576, 128
        for rope in (True, False):
            # 4 splits at cur 79, 5 from 80 (decode_splits at 132 SMs)
            for cur in (0, 1, 79, 80, 300, 543, 575):
                q, k, v = (randn((rows, dh), dtype) for _ in range(3))
                kc, vc = (randn((rows, total, dh), dtype) for _ in range(2))
                c, s_ = rope_sincos(torch.tensor([cur], device=dev), dh)
                cos2, sin2 = torch.cat([c, c], -1), torch.cat([s_, s_], -1)
                kc2, vc2 = kc.clone(), vc.clone()
                got = ca.decode_step(q, k, v, kc, vc, cur, cos2, sin2,
                                     scale=dh ** -0.5, rope=rope)
                want = ca.decode_step_plain(q, k, v, kc2, vc2, cur, cos2,
                                            sin2, scale=dh ** -0.5,
                                            rope=rope)
                e_o = err(got, want)
                same = bool(torch.equal(kc, kc2) and torch.equal(vc, vc2))
                checks.append({"kernel": "decode_step", "dtype": str(dtype),
                               "rows": rows, "total": total, "cur": cur,
                               "splits": ca.decode_splits(
                                   rows, cur, _build.sm_count(q.device)),
                               "rope": rope, "out_err": e_o,
                               "cache_bitwise": same,
                               "ok": e_o <= o_tol and same})
    torch.cuda.synchronize()
    emit({"phase": "attention_kernels",
          "tolerance": "float32 out and lse 1e-4; bf16 out 2e-2 (P is "
                       "rounded to bf16 before PV, against the kernel's "
                       "running row max, or the decode split's own max, "
                       "and the plain version's final one) and lse 1e-3; "
                       "cache columns bitwise; TF32 off",
          "checks": checks})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"attention kernel disagrees with its plain "
                             f"version: {bad}")


def _first_divergence(tok_a, tok_b, lg_a, lg_b, s_prompt, tol):
    """Per row: the first new-token index where two generates differ,
    with the top-2 logit gap of each arm there (a near-tie when below
    ``tol``), and the largest logit difference up to that step."""
    rows = []
    for r in range(tok_a.shape[0]):
        diff = (tok_a[r, s_prompt:] != tok_b[r, s_prompt:]).nonzero()
        j = int(diff[0]) if diff.numel() else None
        upto = tok_a.shape[1] - s_prompt if j is None else j + 1
        max_d = float((lg_a[:upto, r] - lg_b[:upto, r]).abs().max())
        row = {"row": r, "first_diff": j, "max_logit_diff": max_d}
        if j is not None:
            gaps = [float(t[0] - t[1]) for t in (
                lg_a[j, r].topk(2).values, lg_b[j, r].topk(2).values)]
            row["top2_gap"] = gaps
            row["near_tie"] = max(gaps) < tol
        rows.append(row)
    return rows


def decode_path(torch, dev, bw, smi) -> dict:
    """Phase 8: the decode path at the base preset; returns the kernel
    launches of its main run."""
    from icikit_torch.bench.decode import decode_bytes_per_token, make_config
    from icikit_torch.models.transformer import (greedy_generate,
                                                 init_params,
                                                 make_model_mesh)
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.utils.timing import cuda_time_ms, timeit_windows
    from icikit_torch.utils.trace import device_activity

    t0 = time.perf_counter()
    mesh = make_model_mesh(device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    plain = dict(decode_step="unfused", attention_impl="dense")

    def config(dtype, **over):
        return make_config(DEC_PRESET, DEC_PROMPT, DEC_NEW,
                           **{"decode_step": "fused",
                              "attention_impl": "flash",
                              "compute_dtype": dtype, **over})

    cfg = config("bfloat16")
    params = init_params(cfg, gen, dev)
    prompt = torch.randint(0, cfg.vocab, (DEC_BATCH, DEC_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)

    # the main path's run, counted
    greedy_generate(params, prompt, mesh, cfg, 2)  # first-call set-up
    torch.cuda.synchronize()
    ca.reset_launches()
    out, lg16 = greedy_generate(params, prompt, mesh, cfg, DEC_NEW,
                                return_logits=True)
    torch.cuda.synchronize()
    launches = dict(ca.LAUNCHES)
    want = {**dict.fromkeys(ca.LAUNCHES, 0), "flash_fwd": cfg.n_layers,
            "decode_step": cfg.n_layers * (DEC_NEW - 1)}
    if launches != want:
        raise AssertionError(f"decode path launches {launches}, want "
                             f"{want}")
    ok_shape = (tuple(out.shape) == (DEC_BATCH, DEC_PROMPT + DEC_NEW)
                and bool(torch.equal(out[:, :DEC_PROMPT], prompt))
                and int(out.min()) >= 0 and int(out.max()) < cfg.vocab
                and bool(torch.isfinite(lg16).all()))
    if not ok_shape:
        raise AssertionError("decode path output malformed")

    # bf16 against the plain arms: first-step logits, token agreement
    out_p, lg16_p = greedy_generate(params, prompt, mesh,
                                    config("bfloat16", **plain), DEC_NEW,
                                    return_logits=True)
    d16 = (lg16[0] - lg16_p[0]).abs()
    bf16 = {"first_logits_max_diff": float(d16.max()),
            "first_logits_mean_diff": float(d16.mean()),
            "tolerance": BF16_LOGIT_TOL,
            "first_token_equal_share": float(
                (out[:, DEC_PROMPT] == out_p[:, DEC_PROMPT]).float().mean()),
            "token_equal_share": float(
                (out[:, DEC_PROMPT:] == out_p[:, DEC_PROMPT:]).float()
                .mean())}
    del lg16, lg16_p

    # float32: tokens identical up to near-ties
    t32, lg32 = greedy_generate(params, prompt, mesh, config("float32"),
                                DEC_NEW, return_logits=True)
    t32p, lg32p = greedy_generate(params, prompt, mesh,
                                  config("float32", **plain), DEC_NEW,
                                  return_logits=True)
    rows = _first_divergence(t32, t32p, lg32, lg32p, DEC_PROMPT,
                             FP32_LOGIT_TOL)
    fp32 = {"tokens_identical": bool(torch.equal(t32, t32p)),
            "logit_tolerance": FP32_LOGIT_TOL, "rows": rows}
    del lg32, lg32p
    emit({"phase": "decode_check", "preset": DEC_PRESET, "batch": DEC_BATCH,
          "prompt": DEC_PROMPT, "n_new": DEC_NEW, "launches": launches,
          "bf16": bf16, "fp32": fp32,
          "seconds": round(time.perf_counter() - t0, 1)})
    bad32 = [r for r in rows if r["max_logit_diff"] > FP32_LOGIT_TOL
             or (r["first_diff"] is not None and not r["near_tie"])]
    if bad32 or bf16["first_logits_max_diff"] > BF16_LOGIT_TOL:
        raise AssertionError(f"decode path disagrees with its plain arms: "
                             f"fp32 {bad32}, bf16 {bf16}")

    # timing: the fused arm and the unfused arm, the same protocol
    ctr = [0]

    def chain(args, o):
        ctr[0] += 1
        nxt = o[:, -DEC_PROMPT:].clone()
        nxt[0, 0] = ctr[0] % cfg.vocab
        return (nxt,)

    per_token_bytes = decode_bytes_per_token(cfg, DEC_BATCH,
                                             DEC_PROMPT + DEC_NEW)
    floor_s = DEC_NEW * per_token_bytes / bw
    arms = {}
    for name, c in (("fused", cfg),
                    ("unfused", config("bfloat16",
                                       decode_step="unfused"))):
        res = timeit_windows(
            lambda p, c=c: greedy_generate(params, p, mesh, c, DEC_NEW),
            (prompt,), chain, windows=3, runs=2, warmup=1, floor_s=floor_s,
            max_windows=3)
        arms[name] = {"per_token_ms": res.median_s / DEC_NEW * 1e3,
                      "spread_ms": [res.min_s / DEC_NEW * 1e3,
                                    res.max_s / DEC_NEW * 1e3],
                      "tokens_per_s": DEC_BATCH * DEC_NEW / res.median_s,
                      "generate_ms": res.median_s * 1e3,
                      "windows": res.windows, "suspect": res.suspect}
    prefill_ms = cuda_time_ms(
        lambda: greedy_generate(params, prompt, mesh, cfg, 1), iters=5)
    activity = device_activity(
        lambda: greedy_generate(params, prompt, mesh, cfg, DEC_NEW),
        attempts=TRACE_ATTEMPTS)
    traced = activity["by_name"].get("decode_step_kernel",
                                     {}).get("count", 0)
    emit({"phase": "decode_timing", "card": smi, "arms": arms,
          "traced_decode_step_launches": traced,
          "prefill_ms": prefill_ms,
          "step_ms_excluding_prefill": (arms["fused"]["generate_ms"]
                                        - prefill_ms) / (DEC_NEW - 1),
          "bound_ms_per_token": per_token_bytes / bw * 1e3,
          "bytes_per_token": per_token_bytes,
          "read_gbps": per_token_bytes
          / (arms["fused"]["per_token_ms"] * 1e-3) / 1e9,
          "profile": activity,
          "seconds": round(time.perf_counter() - t0, 1)})
    if traced != want["decode_step"]:
        raise AssertionError(f"the traced generate ran decode_step_kernel "
                             f"{traced} times, want {want['decode_step']}")
    return launches, activity["by_name"]


def attention_rows(torch, dev, bw, launches, path_trace) -> list:
    """Phase 9's rows for the attention kernels, timed at the decode
    path's shapes; ``decode_step`` by device time a launch behind a
    sleep kernel on caches rotated past the L2 (each layer of the path
    has its own), beside its device time a launch in phase 8's trace of
    the path (``path_trace``: its ``by_name``)."""
    import torch.nn.functional as F

    from icikit_torch.bench.stream_ab import (copies_past_l2, device_ms,
                                              rotating)
    from icikit_torch.ops import _build
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.utils.timing import cuda_time_ms

    gen = torch.Generator(device=dev).manual_seed(3)
    b, h, s, d = DEC_BATCH, 8, DEC_PROMPT, 128  # the base preset's heads
    scale = d ** -0.5
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    f_ms = cuda_time_ms(lambda: ca.flash_fwd(q, k, v, True, scale),
                        iters=50, warmup=5)
    f_plain = cuda_time_ms(lambda: ca.flash_fwd_plain(q, k, v, True, scale),
                           iters=5)
    f_lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale), iters=50, warmup=5)
    f_err = float((ca.flash_fwd(q, k, v, True, scale)[0].float()
                   - ca.flash_fwd_plain(q, k, v, True, scale)[0].float())
                  .abs().max())
    pairs = b * h * s * (s + 1) // 2            # causal (q, k) pairs
    f_bytes = 4 * b * h * s * d * 2 + b * h * s * 4
    f_ops = 2 * 2 * d * pairs                   # QK^T and PV
    f_bound = max(f_bytes / bw, f_ops / BF16_TENSOR_OPS) * 1e3
    f_by = "bytes" if f_bytes / bw >= f_ops / BF16_TENSOR_OPS \
        else "operations"

    rows, total, dh = b * h, DEC_PROMPT + DEC_NEW, 128
    cur = DEC_PROMPT + (DEC_NEW - 1) // 2       # the steps' mean column
    dq, dk, dv = (torch.randn((rows, dh), generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(3))
    caches = [tuple(torch.randn((rows, total, dh), generator=gen,
                                device=dev).to(torch.bfloat16)
                    for _ in range(2))
              for _ in range(copies_past_l2(4 * rows * total * dh))]
    cos2 = torch.ones((1, dh), device=dev)
    sin2 = torch.zeros((1, dh), device=dev)
    step = rotating(lambda c: ca.decode_step(
        dq, dk, dv, *c, cur, cos2, sin2, scale=scale, rope=True), caches)
    d_ms = device_ms(step, 100, 250.0)
    d_events = cuda_time_ms(step, iters=100, warmup=5)
    kc, vc = caches[0]
    d_plain = cuda_time_ms(lambda: ca.decode_step_plain(
        dq, dk, dv, kc, vc, cur, cos2, sin2, scale=scale, rope=True),
        iters=10)
    d_err = float((ca.decode_step(dq, dk, dv, kc, vc, cur, cos2, sin2,
                                  scale=scale, rope=True).float()
                   - ca.decode_step_plain(dq, dk, dv, kc.clone(), vc.clone(),
                                          cur, cos2, sin2, scale=scale,
                                          rope=True).float()).abs().max())
    d_bytes = (2 * rows * cur * dh * 2          # K and V past columns
               + 3 * rows * dh * 2 + rows * dh * 2  # q, k, v in, out
               + 2 * rows * dh * 2 + 2 * dh * 4)    # column writes, tables
    d_ops = 2 * 2 * rows * (cur + 1) * dh       # logits and PV, float32
    d_bound = max(d_bytes / bw, d_ops / VECTOR_OPS) * 1e3
    d_by = "bytes" if d_bytes / bw >= d_ops / VECTOR_OPS else "operations"
    path = path_trace.get("decode_step_kernel", {"ms": 0.0, "count": 0})
    torch.cuda.synchronize()
    emit({"phase": "attention_timing",
          "flash_fwd": f"b={b} h={h} s={s} d={d} bf16 causal",
          "decode_step": f"rows={rows} total={total} dh={dh} cur={cur} "
                         f"bf16 rope, splits "
                         f"{ca.decode_splits(rows, cur, _build.sm_count(dev))}",
          "decode_step_ms": "device time a launch behind a sleep kernel, "
                            f"the caches rotated through {len(caches)} "
                            "copies (past the L2, as the path's 12 "
                            "layers); by CUDA events around 100 "
                            f"back-to-back calls (the host's rate): "
                            f"{d_events}",
          "path_trace_device_us_per_launch": {
              "decode_step_kernel": 1e3 * path["ms"] / max(1, path["count"]),
              "launches": path["count"]},
          "decode_step_library": "none: no one PyTorch call applies RoPE, "
                                 "writes the cache column and attends"})
    del caches, kc, vc
    return [
        {"name": "flash_fwd (B3/B5)", "route": "cuda",
         "source": "icikit_torch/csrc/attention.cu",
         "replaces": "icikit/ops/flash_attention.py:421 (B3), :349 (B5)",
         "launches": launches["flash_fwd"], "max_abs_err": f_err,
         "ms": f_ms, "plain_ms": f_plain, "bound_ms": f_bound,
         "bound_by": f_by, "library_ms": f_lib},
        {"name": "decode_step (B13)", "route": "cuda",
         "source": "icikit_torch/csrc/attention.cu",
         "replaces": "icikit/ops/flash_attention.py:1120",
         "launches": launches["decode_step"], "max_abs_err": d_err,
         "ms": d_ms, "plain_ms": d_plain, "bound_ms": d_bound,
         "bound_by": d_by, "library_ms": None},
    ]


def _lse_cases(lse, v: int) -> dict:
    """The lse a recompute head kernel is held at: the true one, where the
    -dnll at a row's target makes up nearly all of g's largest entries
    (the softmax part, p ~ 1/V, adds ~1e-4 of them), and lse less log V,
    where p ~ 1 and the softmax part outweighs it, so a wrong exp2 or lse
    shows."""
    return {"lse": lse, "lse less log V": lse - math.log(v)}


def _softmax_dropped(torch, cx, which: str, x, w, targets, dnll):
    """dx or dw from g = -onehot(target) dnll alone, g's softmax part
    dropped, through the plain product (``g_product_plain``): what a check
    of the recompute head must tell apart from the right answer."""
    t, v = x.shape[0], w.shape[0]
    g = torch.zeros((t, v), device=x.device)
    g[torch.arange(t, device=x.device), targets.long()] = -dnll.float()
    out = torch.empty((t if which == "dx" else v, x.shape[1]),
                      device=x.device)
    cx.g_product_plain(which, g, w if which == "dx" else x, out)
    return out


def _rel(a, b) -> float:
    """Largest |a - b| over the largest |b|."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def _rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def _block_rel_l2(a, b) -> float:
    """The largest ||a - b|| / ||b|| over the BLOCK_ROWS-row blocks of
    (b, h, s, d) tensors, in float64."""
    a, b = (t.double().unflatten(2, (-1, BLOCK_ROWS)) for t in (a, b))
    num = (a - b).square().sum((-2, -1)).sqrt()
    den = b.square().sum((-2, -1)).sqrt().clamp_min(1e-300)
    return float((num / den).max())


def train_kernel_checks(torch, dev) -> None:
    """Phase 10: the train path's kernels against their plain versions
    on the card, at the path's shapes and the many-block (B4/B7) shape."""
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops import cuda_xent as cx

    gen = torch.Generator(device=dev).manual_seed(4)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def err(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    checks = []
    for dtype, tol in ((torch.bfloat16, FLASH_TOL["bf16"]),
                       (torch.float32, FLASH_TOL["f32"])):
        for b, h, s, d in FLASH_SHAPES.values():
            q, k, v, do = (randn((b, h, s, d), dtype) for _ in range(4))
            scale = d ** -0.5
            for causal, hot in ((True, False), (False, False), (True, True)):
                qq = (q.float() * 400.0).to(dtype) if hot else q
                out, lse = ca.flash_fwd(qq, k, v, causal, scale,
                                        shift=SHIFT)
                w_out, w_lse = ca.flash_fwd_plain(qq, k, v, causal, scale,
                                                  shift=SHIFT)
                delta = (do.float() * out.float()).sum(-1)
                got = ca.flash_bwd(qq, k, v, do, lse, delta, causal, scale)
                want = ca.flash_bwd_plain(qq, k, v, do, lse, delta, causal,
                                          scale)
                e_o = err(out, w_out)
                e_l = err(lse, w_lse) / (float(w_lse.abs().max())
                                         if hot else 1.0)
                e_g = max(_rel(a, c) for a, c in zip(got, want))
                finite = bool(torch.isfinite(lse).all()) and all(
                    bool(torch.isfinite(g.float()).all()) for g in got)
                g_tol = tol["grad_hot"] if hot else tol["grad"]
                checks.append({
                    "kernel": "flash_fwd shift + flash_bwd",
                    "dtype": str(dtype), "shape": [b, h, s, d],
                    "causal": causal, "q_times_400": hot, "out_err": e_o,
                    "lse_err": e_l, "grad_rel_err": e_g, "finite": finite,
                    "ok": finite and e_o <= tol["out"]
                    and e_l <= tol["lse"] and e_g <= g_tol})
            del q, k, v, do, out, lse, w_out, w_lse, got, want, delta
    # the shift's redo where q x 400 lies only in the second warpgroup's
    # rows of each 128-row CTA, or only in the ragged last Q tile: the
    # hot rows carry the online pass's bits
    for dtype, tol in ((torch.bfloat16, FLASH_TOL["bf16"]),
                       (torch.float32, FLASH_TOL["f32"])):
        for s, hot in REDO_EDGES:
            for d in (64, 128, 256):
                q, k, v = (randn((1, 4, s, d), dtype) for _ in range(3))
                for a, b_ in hot:
                    q[:, :, a:b_] = (q[:, :, a:b_].float() * 400.0).to(dtype)
                out, lse = ca.flash_fwd(q, k, v, True, 0.125, shift=SHIFT)
                ref, ref_lse = ca.flash_fwd(q, k, v, True, 0.125)
                w_out, w_lse = ca.flash_fwd_plain(q, k, v, True, 0.125,
                                                  shift=SHIFT)
                rows = torch.cat([torch.arange(a, b_) for a, b_ in hot]
                                 ).to(dev)
                same = bool(torch.equal(out[:, :, rows], ref[:, :, rows])
                            and torch.equal(lse[:, :, rows],
                                            ref_lse[:, :, rows]))
                e_o = err(out, w_out)
                # the hot rows' lse relative to their largest |lse|, the
                # other rows' absolute
                is_hot = torch.zeros(s, dtype=torch.bool, device=dev)
                is_hot[rows] = True
                e_hot = (err(lse[:, :, is_hot], w_lse[:, :, is_hot])
                         / float(w_lse[:, :, is_hot].abs().max()))
                e_cold = err(lse[:, :, ~is_hot], w_lse[:, :, ~is_hot])
                finite = bool(torch.isfinite(lse).all()) and bool(
                    torch.isfinite(out.float()).all())
                checks.append({
                    "kernel": "flash_fwd shift redo", "dtype": str(dtype),
                    "shape": [1, 4, s, d], "hot_rows": hot,
                    "hot_rows_bitwise_online": same, "out_err": e_o,
                    "lse_err_hot_rows_rel": e_hot,
                    "lse_err_other_rows": e_cold, "finite": finite,
                    "ok": finite and same and e_o <= tol["out"]
                    and e_hot <= tol["lse"] and e_cold <= tol["lse"]})
                del q, k, v, out, lse, ref, ref_lse, w_out, w_lse
    t, d, v = XENT_SHAPE
    for dtype, tol in ((torch.bfloat16, XENT_TOL["bf16"]),
                       (torch.float32, XENT_TOL["f32"])):
        x = randn((t, d), dtype)
        w = randn((v, d), dtype, d ** -0.5)
        tg = torch.randint(0, v, (t,), generator=gen, device=dev,
                           dtype=torch.int32)
        dn = randn((t,), torch.float32, 1.0 / t)
        lse, tgt, e, mrun = cx.xent_fwd(x, w, tg, save=True)
        chunk = cx.TILE[dtype]
        p_lse, p_tgt, p_e, p_m = cx.xent_fwd_plain(x, w, tg, True, chunk)
        e_l = max(err(lse, p_lse), err(tgt, p_tgt))
        dx = cx.xent_dx_saved(e, mrun, w, tg, lse, dn)
        e_dx = _rel(dx, cx.xent_dx_saved_plain(p_e, p_m, w, tg, p_lse, dn,
                                               chunk))
        dw = cx.xent_dw_saved(e, mrun, x, tg, lse, dn)
        e_dw = _rel(dw, cx.xent_dw_saved_plain(p_e, p_m, x, tg, p_lse, dn,
                                               chunk))
        checks.append({"kernel": "xent_fwd + xent_dx_saved + xent_dw_saved",
                       "dtype": str(dtype), "shape": [t, d, v],
                       "lse_tgt_err": e_l, "dx_rel_err": e_dx,
                       "dw_rel_err": e_dw,
                       "ok": e_l <= tol["lse"] and e_dx <= tol["grad"]
                       and e_dw <= tol["grad"]})
        del x, w, e, mrun, p_e, p_m, dx, dw
    torch.cuda.synchronize()
    emit({"phase": "train_kernels", "shift": SHIFT,
          "tolerance": {"flash": FLASH_TOL, "xent": XENT_TOL,
                        "why": "float32: sums in other orders, dq by "
                               "atomics; bf16: P and dS rounded to bf16 "
                               "against lse values that differ in the "
                               "last bits, and g rounded to bf16 for "
                               "the tensor cores where the plain "
                               "version contracts it in float32; q x 400: "
                               "logits of ~400 nats, where one float32 "
                               "ulp of the lse moves P by 3e-5; lse "
                               "errors there relative to the largest "
                               "|lse|; TF32 off"},
          "checks": checks})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"train kernel disagrees with its plain "
                             f"version: {bad}")


def _train_config(dtype, **over):
    from icikit_torch.bench.train import PRESETS
    from icikit_torch.models.transformer import TransformerConfig
    return TransformerConfig(**{**PRESETS[TRAIN_PRESET],
                                "compute_dtype": dtype,
                                "remat_policy": "except_attn",
                                "softmax_shift": SHIFT, **over})


def train_cell(torch, dev) -> dict:
    """The train cell of phases 11 and 14: the base preset's masters (a
    seeded generator), the b = 8 data (``numpy.random.default_rng(0)``)
    and, at b = 2 and float32, the loss and gradients of the plain arms
    (dense attention, unfused head) and of the default arm."""
    import numpy as np

    from icikit_torch.bench.train import detect_peak, step_flops
    from icikit_torch.models.transformer import (init_params,
                                                 loss_and_metrics,
                                                 make_model_mesh)

    mesh = make_model_mesh(device=dev)
    cfg = _train_config("bfloat16")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    rng = np.random.default_rng(0)
    tok, tgt = (torch.from_numpy(rng.integers(0, cfg.vocab,
                                              (TRAIN_BATCH, cfg.max_seq))
                                 .astype(np.int32)).to(dev)
                for _ in range(2))
    b2 = (tok[:TRAIN_CHECK_BATCH], tgt[:TRAIN_CHECK_BATCH])
    plain_cfg = _train_config("float32", attention_impl="dense",
                              fused_head=False)
    loss_p, g_p, _ = loss_and_metrics(params, *b2, mesh, plain_cfg)
    loss_d, g_d, _ = loss_and_metrics(params, *b2, mesh,
                                      _train_config("float32"))
    return {"mesh": mesh, "params": params, "tok": tok, "tgt": tgt,
            "b2": b2, "seq": cfg.max_seq, "plain_cfg": plain_cfg,
            "plain": (float(loss_p), g_p), "default": (float(loss_d), g_d),
            "flops": step_flops(cfg, TRAIN_BATCH, cfg.max_seq),
            "peak": detect_peak(dev)}


def train_arm(torch, cell, arm, spec, smi=None, phase="train") -> dict:
    """One arm of the train cell, ``spec`` in ``ARMS``' form: at b = 2
    and float32 held against the plain arms and the default arm (the Adam
    kernel's arm by its parameters after one step); the b = 8 bf16 step
    with its launches counted on the second step; step ms, tokens/s and
    mfu by median-of-windows; a profiler trace of one step (its kernels'
    device time by name, the idle share). With ``smi`` (the main paths
    of phases 11 and 23) also the bf16 first-step loss, the loss falling
    over 5 steps and the lines ``{phase}_check`` and ``{phase}_timing``.
    Returns the arm's record, ``ok`` in it."""
    import numpy as np

    from icikit_torch.models.transformer import (FusedAdam,
                                                 loss_and_metrics,
                                                 make_train_step)
    from icikit_torch.ops import cuda_adam, cuda_stack
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops import cuda_xent as cx
    from icikit_torch.utils.timing import timeit_windows
    from icikit_torch.utils.trace import device_activity

    t0 = time.perf_counter()
    over, pallas, kernels = spec
    mesh, params, b2 = cell["mesh"], cell["params"], cell["b2"]
    tok, tgt, seq = cell["tok"], cell["tgt"], cell["seq"]
    (loss_p, g_p), (loss_d, g_d) = cell["plain"], cell["default"]
    flops, peak = cell["flops"], cell["peak"]

    # float32, b = 2: against the plain arms and the default arm
    if pallas:
        def one_step(cfg, adam):
            p = {k: x.clone() for k, x in params.items()}
            opt, step = make_train_step(mesh, cfg, adam)
            p, _, loss = step(p, opt.init(p), *b2)
            return p, float(loss)

        got, loss_k = one_step(_train_config("float32"),
                               FusedAdam(TRAIN_LR, use_pallas=True))
        ref_p = one_step(cell["plain_cfg"], FusedAdam(TRAIN_LR))[0]
        ref_d = one_step(_train_config("float32"), FusedAdam(TRAIN_LR))[0]
        what = "parameter leaves after one step"
    else:
        got, ref_p, ref_d, what = g_d, g_p, g_d, "gradient leaves"
        loss_k = loss_d
        if over:
            loss_k, got, _ = loss_and_metrics(
                params, *b2, mesh, _train_config("float32", **over))
            loss_k = float(loss_k)
    leaf_p = {k: _rel_l2(got[k], ref_p[k]) for k in ref_p}
    err_d = max(_rel_l2(got[k], ref_d[k]) for k in ref_d)
    fp32 = {"loss": loss_k, "loss_plain": loss_p, "loss_default_arm": loss_d,
            "loss_diff_plain": abs(loss_k - loss_p),
            "loss_diff_default": abs(loss_k - loss_d),
            "rel_l2_max_plain": max(leaf_p.values()),
            "rel_l2_max_default": err_d, "compared": what}
    del got, ref_p, ref_d
    ok = (fp32["loss_diff_plain"] <= TRAIN_LOSS_TOL
          and fp32["loss_diff_default"] <= TRAIN_LOSS_TOL
          and fp32["rel_l2_max_plain"] <= TRAIN_GRAD_TOL
          and err_d <= TRAIN_GRAD_TOL)

    # b = 8, bf16, the second step counted
    cfg = _train_config("bfloat16", **over)
    adam = (FusedAdam(TRAIN_LR, use_pallas=True) if pallas else
            FusedAdam(TRAIN_LR, mu_dtype=torch.bfloat16,
                      nu_dtype=torch.bfloat16))
    p = {k: x.clone() for k, x in params.items()}
    opt, step = make_train_step(mesh, cfg, adam)
    st = opt.init(p)
    p, st, loss = step(p, st, tok, tgt)           # first-call set-up
    losses = [float(loss)]
    mods = (ca, cx, cuda_adam, cuda_stack)
    for mod in mods:
        mod.reset_launches()
    p, st, loss = step(p, st, tok, tgt)
    torch.cuda.synchronize()
    launches = {k: n for mod in mods for k, n in mod.LAUNCHES.items()}
    losses.append(float(loss))
    want = {**dict.fromkeys(launches, 0), "flash_fwd": cfg.n_layers,
            "flash_bwd": cfg.n_layers, "xent_fwd": 1,
            **dict.fromkeys(kernels, 1)}
    if cfg.save_stack == "pallas":
        want.update(SAVE_STACK_LAUNCHES)
    ok = ok and launches == want
    if smi is not None:
        for _ in range(3):
            p, st, loss = step(p, st, tok, tgt)
            losses.append(float(loss))
        loss_b = float(loss_and_metrics(params, *b2, mesh, cfg)[0])
        bf16_first = {"loss": loss_b,
                      "rel_diff_to_fp32_plain": abs(loss_b - loss_p) / loss_p,
                      "tolerance": TRAIN_BF16_TOL}
        ok = (ok and bf16_first["rel_diff_to_fp32_plain"] <= TRAIN_BF16_TOL
              and losses[-1] < losses[0])
        emit({"phase": f"{phase}_check", "preset": TRAIN_PRESET,
              "arm": arm,
              "batch": TRAIN_BATCH, "seq": seq,
              "check_batch": TRAIN_CHECK_BATCH, "launches_per_step": launches,
              "fp32": {"loss_kernels": loss_k, "loss_plain": loss_p,
                       "loss_diff": fp32["loss_diff_plain"],
                       "loss_tolerance": TRAIN_LOSS_TOL,
                       "grad_rel_l2_max": fp32["rel_l2_max_plain"],
                       "grad_rel_l2": leaf_p,
                       "grad_tolerance": TRAIN_GRAD_TOL},
              "bf16_first_step": bf16_first, "bf16_losses_5_steps": losses,
              "seconds": round(time.perf_counter() - t0, 1)})
    ok = ok and bool(np.isfinite(losses).all())

    # timing: chained steps carried in place, median of windows of at
    # least 1 s (a step is ~0.1 s, and host noise spreads short
    # windows); at most 3 windows, so the five arms fit the time limit
    n_steps = 5

    def multi(p, s):
        out = (p, s, None)
        for _ in range(n_steps):
            out = step(out[0], out[1], tok, tgt)
        return out

    res = timeit_windows(multi, (p, st), lambda a, o: (o[0], o[1]),
                         windows=3, runs=1, warmup=1, target_window_s=1.0,
                         max_windows=3,
                         floor_s=n_steps * flops / peak if peak else None)
    step_s = res.median_s / n_steps
    rec = {"fp32_b2": fp32, "launches_per_step": launches, "want": want,
           "bf16_losses": losses, "step_ms": step_s * 1e3,
           "step_ms_spread": [res.min_s / n_steps * 1e3,
                              res.max_s / n_steps * 1e3],
           "windows": res.windows, "suspect": res.suspect,
           "tokens_per_s": TRAIN_BATCH * seq / step_s,
           "mfu": flops / step_s / peak if peak else None, "ok": ok}
    rec["profile"] = device_activity(lambda: step(p, st, tok, tgt),
                                     attempts=TRACE_ATTEMPTS)
    if smi is not None:
        emit({"phase": f"{phase}_timing", "card": smi, "arm": arm,
              **{k: rec[k] for k in ("step_ms", "step_ms_spread", "windows",
                                     "suspect", "tokens_per_s")},
              "model_tflops_per_s": flops / step_s / 1e12, "mfu": rec["mfu"],
              "step_flops": flops, "peak_flops": peak,
              "bound_ms": flops / BF16_TENSOR_OPS * 1e3,
              "profile": rec["profile"],
              "seconds": round(time.perf_counter() - t0, 1)})
    del p, st, opt, step
    torch.cuda.empty_cache()
    return rec


def train_rows(torch, dev, bw, launches) -> list:
    """Phase 12's rows for the train path's kernels: each timed at the
    path's shapes (and B4/B7 at the many-block shape), beside its plain
    version, a library call and its bound."""
    import torch.nn.functional as F

    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops import cuda_xent as cx
    from icikit_torch.utils.timing import cuda_time_ms

    gen = torch.Generator(device=dev).manual_seed(5)
    bf = torch.bfloat16

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(bf)

    def bound(nbytes, ops):
        t_b, t_o = nbytes / bw, ops / BF16_TENSOR_OPS
        return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"

    rows, notes = [], {}
    for tag, (b, h, s, d) in FLASH_SHAPES.items():
        q, k, v, do = (randn((b, h, s, d)) for _ in range(4))
        scale = d ** -0.5
        pairs = b * h * s * (s + 1) // 2
        f_ms = cuda_time_ms(lambda: ca.flash_fwd(q, k, v, True, scale,
                                                 shift=SHIFT),
                            iters=50, warmup=5)
        f_plain = cuda_time_ms(lambda: ca.flash_fwd_plain(
            q, k, v, True, scale, shift=SHIFT), iters=5)
        f_lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale), iters=50, warmup=5)
        out, lse = ca.flash_fwd(q, k, v, True, scale, shift=SHIFT)
        f_err = float((out.float() - ca.flash_fwd_plain(
            q, k, v, True, scale, shift=SHIFT)[0].float()).abs().max())
        f_bound, f_by = bound(4 * b * h * s * d * 2 + b * h * s * 4,
                              2 * 2 * d * pairs)
        rows.append({"name": f"flash_fwd shift ({tag})", "route": "cuda",
                     "source": "icikit_torch/csrc/attention.cu",
                     "replaces": ("icikit/ops/flash_attention.py:349 (B5, "
                                  "shift branch :328)" if tag == "B5-shift"
                                  else "icikit/ops/flash_attention.py:421 "
                                       "(B4, _fwd_const_kernel :230)"),
                     "launches": launches["flash_fwd"], "max_abs_err": f_err,
                     "ms": f_ms, "plain_ms": f_plain, "bound_ms": f_bound,
                     "bound_by": f_by, "library_ms": f_lib})
        delta = (do.float() * out.float()).sum(-1)
        b_ms = cuda_time_ms(lambda: ca.flash_bwd(q, k, v, do, lse, delta,
                                                 True, scale),
                            iters=20, warmup=3)
        b_plain = cuda_time_ms(lambda: ca.flash_bwd_plain(
            q, k, v, do, lse, delta, True, scale), iters=3)
        b_err = max(_rel(a, c) for a, c in zip(
            ca.flash_bwd(q, k, v, do, lse, delta, True, scale),
            ca.flash_bwd_plain(q, k, v, do, lse, delta, True, scale)))
        lq, lk, lv = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                            scale=scale)
        b_lib = cuda_time_ms(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), do, retain_graph=True), iters=20, warmup=3)
        b_bound, b_by = bound(7 * b * h * s * d * 2 + 2 * b * h * s * 4,
                              5 * 2 * d * pairs)
        btag = "B6" if tag == "B5-shift" else "B7"
        rows.append({"name": f"flash_bwd ({btag})", "route": "cuda",
                     "source": "icikit_torch/csrc/attention.cu",
                     "replaces": ("icikit/ops/flash_attention.py:701 (B6)"
                                  if btag == "B6" else
                                  "icikit/ops/flash_attention.py:653 (B7)"),
                     "launches": launches["flash_bwd"],
                     "max_abs_err": b_err,
                     "ms": b_ms, "plain_ms": b_plain, "bound_ms": b_bound,
                     "bound_by": b_by, "library_ms": b_lib})
        notes[tag] = f"b={b} h={h} s={s} d={d} bf16 causal shift={SHIFT}"
        del q, k, v, do, out, lse, delta, lq, lk, lv, lo

    t, d, v = XENT_SHAPE
    x = randn((t, d))
    w = randn((v, d), d ** -0.5)
    tg = torch.randint(0, v, (t,), generator=gen, device=dev,
                       dtype=torch.int32)
    dn = torch.full((t,), 1.0 / t, device=dev)
    ops = 2 * t * v * d
    chunk = cx.TILE[bf]
    fx_ms = cuda_time_ms(lambda: cx.xent_fwd(x, w, tg, save=True), iters=10)
    fx_plain = cuda_time_ms(lambda: cx.xent_fwd_plain(x, w, tg, True, chunk),
                            iters=3)
    lse, tgt, e, mrun = cx.xent_fwd(x, w, tg, save=True)
    fx_err = float((lse - cx.xent_fwd_plain(x, w, tg, True, chunk)[0])
                   .abs().max())
    mm_ms = cuda_time_ms(lambda: torch.matmul(x, w.t()), iters=10)
    nc = -(-v // chunk)
    fx_bound, fx_by = bound(t * d * 2 + v * d * 2 + t * 4 + 2 * t * 4
                            + t * v * 2 + nc * t * 4, ops)
    rows.append({"name": "xent_fwd (B9)", "route": "cuda",
                 "source": "icikit_torch/csrc/xent.cu",
                 "replaces": "icikit/ops/xent.py:283 (B9)",
                 "launches": launches["xent_fwd"], "max_abs_err": fx_err,
                 "ms": fx_ms, "plain_ms": fx_plain, "bound_ms": fx_bound,
                 "bound_by": fx_by, "library_ms": None,
                 "nearest_yardstick_ms": mm_ms,
                 "nearest_yardstick": XW_YARDSTICK})
    # the nearest yardstick of dx and dw (not the same function): cuBLAS's
    # product of the same shape on a materialized bf16 g
    g = cx.xent_g_saved_plain(e, mrun, tg, lse, dn, chunk)
    g_mm = {"dx (g @ w)": cuda_time_ms(lambda: torch.matmul(g, w),
                                       iters=10),
            "dw (g.T @ x)": cuda_time_ms(lambda: torch.matmul(g.t(), x),
                                         iters=10)}
    del g
    for which, fn, plain, other, out_rows in (
            ("dx", cx.xent_dx_saved, cx.xent_dx_saved_plain, w, t),
            ("dw", cx.xent_dw_saved, cx.xent_dw_saved_plain, x, v)):
        k_ms = cuda_time_ms(lambda: fn(e, mrun, other, tg, lse, dn),
                            iters=10)
        p_ms = cuda_time_ms(lambda: plain(e, mrun, other, tg, lse, dn, chunk),
                            iters=3)
        k_err = _rel(fn(e, mrun, other, tg, lse, dn),
                     plain(e, mrun, other, tg, lse, dn, chunk))
        k_bound, k_by = bound(t * v * 2 + nc * t * 4 + other.numel() * 2
                              + 3 * t * 4 + out_rows * d * 2, ops)
        rows.append({"name": f"xent_{which}_saved (B10)", "route": "cuda",
                     "source": "icikit_torch/csrc/xent.cu",
                     "replaces": ("icikit/ops/xent.py:374 (B10)"
                                  if which == "dx"
                                  else "icikit/ops/xent.py:411 (B10)"),
                     "launches": launches[f"xent_{which}_saved"],
                     "max_abs_err": k_err, "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": k_bound, "bound_by": k_by,
                     "library_ms": None})
    torch.cuda.synchronize()
    emit({"phase": "train_timing_kernels", **notes,
          "xent": f"T={t} D={d} V={v} bf16, saved flavour",
          "xent_library": "none: no one PyTorch call forms the logits, "
                          "their lse and target, or dx/dw from saved "
                          "exponentials; torch.matmul of x w^T alone "
                          "(cuBLAS) beside it",
          "matmul_x_wT_ms": mm_ms,
          "cublas_g_product_ms": g_mm,
          "flash_bwd_library": "SDPA's backward through autograd on the "
                               "same tensors",
          "max_abs_err_of_bwd_and_dx_dw": "relative to the largest entry"})
    return rows


def _base_tree_grads(torch, params, gen, cdt):
    """Random gradients shaped as the train step gives them: the matmul
    weights' in the compute dtype, the rest float32."""
    from icikit_torch.models.transformer.model import NARROW_OK
    return {k: torch.randn(p.shape, generator=gen, device=p.device)
            .to(cdt if k in NARROW_OK else torch.float32)
            for k, p in params.items()}


def train_arm_kernel_checks(torch, dev, bw) -> list:
    """Phase 13: the recompute and matmul head kernels, the Adam kernel
    and the two-pass backward against their plain versions on the card;
    returns the kernels line's rows of the recompute head past D 2048."""
    from icikit_torch.bench.train import PRESETS
    from icikit_torch.models.transformer import (TransformerConfig,
                                                 init_params)
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops import cuda_xent as cx
    from icikit_torch.ops.adam import adam_apply

    gen = torch.Generator(device=dev).manual_seed(6)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    checks = []
    t, d, v = XENT_SHAPE
    for dtype, tol in ((torch.bfloat16, XENT_TOL["bf16"]),
                       (torch.float32, XENT_TOL["f32"])):
        x = randn((t, d), dtype)
        w = randn((v, d), dtype, d ** -0.5)
        tg = torch.randint(0, v, (t,), generator=gen, device=dev,
                           dtype=torch.int32)
        dn = randn((t,), torch.float32, 1.0 / t)
        lse, _, e, mrun = cx.xent_fwd(x, w, tg, save=True)
        errs = {}
        for case, ls in _lse_cases(lse, v).items():
            tag = "" if case == "lse" else f" ({case})"
            errs.update({
                "xent_g" + tag: _rel(cx.xent_g(x, w, tg, ls, dn),
                                     cx.xent_g_plain(x, w, tg, ls, dn)),
                "xent_g_saved" + tag: _rel(
                    cx.xent_g_saved(e, mrun, tg, ls, dn),
                    cx.xent_g_saved_plain(e, mrun, tg, ls, dn,
                                          cx.TILE[dtype])),
                "xent_dx" + tag: _rel(cx.xent_dx(x, w, tg, ls, dn),
                                      cx.xent_dx_plain(x, w, tg, ls, dn)),
                "xent_dw" + tag: _rel(cx.xent_dw(x, w, tg, ls, dn),
                                      cx.xent_dw_plain(x, w, tg, ls, dn))})
        checks.append({"kernel": "xent_g, xent_g_saved, xent_dx, xent_dw",
                       "dtype": str(dtype), "shape": [t, d, v],
                       "rel_err": errs,
                       "ok": max(errs.values()) <= tol["grad"]})
        del x, w, e, mrun
        torch.cuda.empty_cache()
    for t_, d_, v_ in RECOMPUTE_RAGGED:
        x = randn((t_, d_), torch.bfloat16)
        w = randn((v_, d_), torch.bfloat16, d_ ** -0.5)
        tg = torch.randint(0, v_, (t_,), generator=gen, device=dev,
                           dtype=torch.int32)
        dn = randn((t_,), torch.float32, 1.0 / t_)
        lse, _ = cx.xent_fwd(x, w, tg, save=False)
        errs = {}
        for case, ls in _lse_cases(lse, v_).items():
            tag = "" if case == "lse" else f" ({case})"
            errs.update({
                "xent_dx" + tag: _rel(cx.xent_dx(x, w, tg, ls, dn),
                                      cx.xent_dx_plain(x, w, tg, ls, dn)),
                "xent_dw" + tag: _rel(cx.xent_dw(x, w, tg, ls, dn),
                                      cx.xent_dw_plain(x, w, tg, ls, dn))})
        checks.append({"kernel": "xent_dx, xent_dw (ragged)",
                       "dtype": "torch.bfloat16", "shape": [t_, d_, v_],
                       "rel_err": errs,
                       "ok": max(errs.values()) <= XENT_TOL["bf16"]["grad"]})
    del x, w, tg, dn, lse
    wide = recompute_wide_times(torch, dev, randn, bw)
    for key, rec in wide.items():
        checks.append({"kernel": f"xent_{key} (past D 2048, the chunk walk)",
                       "dtype": "torch.bfloat16", "shape": rec["shape"],
                       "rel_err": rec["rel_err_by_lse"],
                       "softmax_dropped_rel_err":
                           rec["softmax_dropped_rel_err"],
                       "ok": rec["ok"]})

    cfg = TransformerConfig(**PRESETS[TRAIN_PRESET])
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    grads = _base_tree_grads(torch, params, gen, torch.bfloat16)
    f32, bf = torch.float32, torch.bfloat16
    for mom, vdt in ((bf, bf), (f32, f32), (f32, bf), (bf, f32)):
        m0 = {k: randn(p.shape, mom, 0.01) for k, p in params.items()}
        v0 = {k: randn(p.shape, torch.float32, 0.01).square().to(vdt)
              for k, p in params.items()}
        for ok in (None, True, False):
            flag = None if ok is None else torch.tensor(ok, device=dev)
            runs = []
            for pallas in (True, False):
                p1 = {k: x.clone() for k, x in params.items()}
                m1 = {k: x.clone() for k, x in m0.items()}
                v1 = {k: x.clone() for k, x in v0.items()}
                adam_apply(p1, m1, v1, grads, TRAIN_LR, 3,
                           use_pallas=pallas, ok=flag)
                runs.append((p1, m1, v1))
            same = all(torch.equal(a[k], b[k]) for a, b in
                       zip(runs[0], runs[1]) for k in params)
            checks.append({"kernel": "adam", "m": str(mom), "v": str(vdt),
                           "ok_flag": ok, "leaves": len(params),
                           "bitwise": same, "ok": same})
            del runs
    del params, grads, m0, v0
    torch.cuda.empty_cache()
    checks.append(ragged_vocab_check(torch, dev))

    for dtype, key in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        tol, l2_tol = FLASH_TOL[key]["grad"], BLOCK_L2_TOL[key]
        for b, h, s_, d_ in TWO_PASS_SHAPES:
            q, k, v_, do = (randn((b, h, s_, d_), dtype) for _ in range(4))
            scale = d_ ** -0.5
            for causal in (True, False):
                out, lse = ca.flash_fwd(q, k, v_, causal, scale)
                delta = (do.float() * out.float()).sum(-1)
                args = (q, k, v_, do, lse, delta, causal, scale)
                got = (ca.flash_bwd_dq(*args), *ca.flash_bwd_dkv(*args))
                e, l2 = {}, {}
                for ref, want in (("plain", ca.flash_bwd_plain(*args)),
                                  ("flash_bwd", ca.flash_bwd(*args))):
                    e[ref] = max(_rel(a, c) for a, c in zip(got, want))
                    l2[ref] = max(_block_rel_l2(a, c)
                                  for a, c in zip(got, want))
                again = torch.equal(got[0], ca.flash_bwd_dq(*args))
                checks.append({
                    "kernel": "flash_bwd_dq + flash_bwd_dkv",
                    "dtype": str(dtype), "shape": [b, h, s_, d_],
                    "causal": causal, "rel_err": e, "block_rel_l2": l2,
                    "dq_repeatable": again,
                    "ok": max(e.values()) <= tol
                    and max(l2.values()) <= l2_tol and again})
            del q, k, v_, do, out, lse, delta, got
    torch.cuda.synchronize()
    emit({"phase": "train_arm_kernels",
          "tolerance": {"xent": XENT_TOL, "flash": FLASH_TOL,
                        "flash_block_rel_l2": BLOCK_L2_TOL,
                        "block_rows": BLOCK_ROWS,
                        "adam": "bit for bit",
                        "why": "xent: the logits summed in other orders, "
                               "g rounded to bf16 for the tensor cores "
                               "against the plain version's float32; the "
                               "two-pass backward as flash_bwd's, and in "
                               "each 64-row block by relative L2; Adam: "
                               "the same float32 operations, each "
                               "rounded once, in the same order; "
                               "rel_err relative to the largest entry"},
          "checks": checks, "recompute_wide": wide})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"train-arm kernel disagrees with its plain "
                             f"version: {bad}")
    t, d, v = WIDE_SHAPE
    return [{"name": f"xent_{which} (B10 recompute past D 2048: the chunk "
                     f"walk, {' + '.join(WIDE_KERNELS[which])} a chunk)",
             "route": "cuda", "source": "icikit_torch/csrc/xent.cu",
             "replaces": "icikit/ops/xent.py:" + (
                 "374 (B10, _dx_kernel, e_ref=None)" if which == "dx"
                 else "411 (B10, _dw_kernel, e_ref=None)"),
             "launches": rec["launches"], "max_abs_err": rec["rel_err"],
             "ms": rec["ms"], "plain_ms": rec["plain_ms"],
             "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
             "library_ms": None, "shape": rec["shape"]}
            for which in ("dx", "dw")
            for rec in [wide[f"{which}@{t}x{d}x{v}"]]]


def recompute_wide_times(torch, dev, randn, bw=MEM_BPS_SXM) -> dict:
    """B10 recompute past one cluster's D 2048, the chunk walk
    (``cuda_xent.recompute_walk``: ``xent_g_bf16`` forms a chunk's logits
    and g, then ``xent_dx_g_bf16`` / ``xent_dw_g_bf16`` its product): dx
    and dw in bf16 held to their plain versions at WIDE_EDGE and
    WIDE_SHAPE at both of ``_lse_cases`` (the worse is ``rel_err``), and
    a g without its softmax part (``_softmax_dropped``) shown to miss the
    tolerance at lse less log V, one launch counted a call; g's scratch (a chunk of g in
    bf16) held within a quarter of (T, V) in bf16, and at WIDE_SHAPE
    also what the call takes beyond its output by the allocator's peak
    (at WIDE_EDGE a cached block a little larger than the request could
    count whole). At WIDE_SHAPE each is timed by CUDA events beside its
    plain version and its bound (the rebuild and the contraction, 2 x 2 T
    V D operations at 989 TFLOP/s, against x, w, the output and the token
    vectors once at ``bw``: the larger), and one call is traced: only the
    walk's two kernels may run (no cuBLAS), each once a chunk, and the
    chunks partition the rows (T for dx, V for dw), so its logits
    launches form each logits tile once. The host's launches (two a
    chunk) are counted in every trace; the device's by name where the
    trace kept every device record (``utils/trace``: a trace late in a
    long process can lose some). Records keyed "dx@TxDxV"."""
    from icikit_torch.ops import _build
    from icikit_torch.ops import cuda_xent as cx
    from icikit_torch.utils.timing import cuda_time_ms
    from icikit_torch.utils.trace import device_activity

    out = {}
    for t, d, v in (WIDE_EDGE, WIDE_SHAPE):
        x = randn((t, d), torch.bfloat16)
        w = randn((v, d), torch.bfloat16, d ** -0.5)
        tg = torch.randint(0, v, (t,), device=dev, dtype=torch.int32)
        dn = randn((t,), torch.float32, 1.0 / t)
        lse, _ = cx.xent_fwd(x, w, tg, save=False)
        for which, fn, plain in (("dx", cx.xent_dx, cx.xent_dx_plain),
                                 ("dw", cx.xent_dw, cx.xent_dw_plain)):
            name = f"xent_{which}"
            n = t if which == "dx" else v
            chunk = cx.recompute_chunk(n, d, _build.sm_count(x.device))
            chunks = -(-n // chunk)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            before = cx.LAUNCHES[name]
            got = fn(x, w, tg, lse, dn)
            torch.cuda.synchronize()
            launches = cx.LAUNCHES[name] - before
            peak = (torch.cuda.max_memory_allocated() - base
                    - got.numel() * got.element_size())
            dropped = _softmax_dropped(torch, cx, which, x, w, tg, dn)
            rel, blind = {}, {}
            for case, ls in _lse_cases(lse, v).items():
                out_c = got if case == "lse" else fn(x, w, tg, ls, dn)
                want = plain(x, w, tg, ls, dn)
                rel[case] = _rel(out_c, want)
                blind[case] = _rel(dropped, want)
                del out_c, want
            tol = XENT_TOL["bf16"]["grad"]
            rec = {"kernels": list(WIDE_KERNELS[which]),
                   "shape": [t, d, v], "chunk": chunk,
                   "chunks": chunks,
                   "launches": launches,
                   "scratch_bytes": chunk * (v if which == "dx" else t) * 2,
                   "peak_beyond_output_bytes": peak,
                   "scratch_cap_bytes": t * v * 2 // 4,
                   "rel_err": max(rel.values()), "rel_err_by_lse": rel,
                   "softmax_dropped_rel_err": blind}
            del got, dropped
            ok = (launches == 1
                  and rec["scratch_bytes"] <= rec["scratch_cap_bytes"]
                  and rec["rel_err"] <= tol
                  and blind["lse less log V"] > tol)
            if (t, d, v) == WIDE_SHAPE:
                nbytes = (t * d + v * d + n * d) * 2 + 3 * t * 4
                t_b = nbytes / bw
                t_o = 2 * 2 * t * v * d / BF16_TENSOR_OPS
                act = device_activity(lambda: fn(x, w, tg, lse, dn),
                                      attempts=WIDE_TRACE_ATTEMPTS)
                counts = {k: c["count"] for k, c in act["by_name"].items()}
                whole = not act["lost_device_events"]
                rec.update(
                    ms=cuda_time_ms(lambda: fn(x, w, tg, lse, dn), iters=5,
                                    warmup=1),
                    plain_ms=cuda_time_ms(lambda: plain(x, w, tg, lse, dn),
                                          iters=1, warmup=1),
                    bound_ms=max(t_b, t_o) * 1e3,
                    bound_by="bytes" if t_b >= t_o else "operations",
                    trace=act["by_name"],
                    host_launches=act["host_enqueue_calls"],
                    trace_lost_device_events=act["lost_device_events"],
                    trace_attempts=act["attempts"],
                    logits_passes=counts.get("xent_g_bf16", 0)
                    / chunks if whole else None)
                ok &= peak <= rec["scratch_cap_bytes"]
                ok &= act["host_enqueue_calls"] == 2 * chunks
                ok &= set(counts) <= set(WIDE_KERNELS[which]) and (
                    not whole or all(counts.get(k) == chunks
                                     for k in WIDE_KERNELS[which]))
            rec["ok"] = bool(ok)
            out[f"{which}@{t}x{d}x{v}"] = rec
        del x, w, tg, dn, lse
        torch.cuda.empty_cache()
    return out


def ragged_vocab_check(torch, dev) -> dict:
    """A bf16 train step at V = 61, d_model = 128 (RAGGED_CFG): the gate
    sends its head to the unfused path before any launch, since the bf16
    head kernels read 16-byte rows of V. At b 2 the bf16 loss is held to
    the float32 plain arms' (dense attention, unfused head) within
    TRAIN_BF16_TOL, no xent kernel runs and flash_fwd does (twice a
    layer: the config's default remat recomputes the layer); a FusedAdam
    step gives a finite loss."""
    import numpy as np

    from icikit_torch.models.transformer import (FusedAdam,
                                                 TransformerConfig,
                                                 init_params,
                                                 loss_and_metrics,
                                                 make_model_mesh,
                                                 make_train_step)
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops import cuda_xent as cx

    mesh = make_model_mesh(device=dev)
    cfg = TransformerConfig(**RAGGED_CFG, compute_dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(3),
                         dev)
    rng = np.random.default_rng(3)
    tok, tgt = (torch.from_numpy(rng.integers(0, cfg.vocab,
                                              (2, cfg.max_seq))
                                 .astype(np.int32)).to(dev)
                for _ in range(2))
    plain = TransformerConfig(**RAGGED_CFG, compute_dtype="float32",
                              attention_impl="dense", fused_head=False)
    loss_p = float(loss_and_metrics(params, tok, tgt, mesh, plain)[0])
    ca.reset_launches()
    cx.reset_launches()
    loss_b = float(loss_and_metrics(params, tok, tgt, mesh, cfg)[0])
    launches = {**{k: n for k, n in ca.LAUNCHES.items() if n},
                **{k: n for k, n in cx.LAUNCHES.items() if n}}
    opt, step = make_train_step(mesh, cfg, FusedAdam(TRAIN_LR))
    p = {k: x.clone() for k, x in params.items()}
    _, _, loss_s = step(p, opt.init(p), tok, tgt)
    rel = abs(loss_b - loss_p) / loss_p
    return {"kernel": "bf16 head at a ragged V (the unfused route)",
            "config": RAGGED_CFG, "loss_bf16": loss_b, "loss_fp32_plain":
            loss_p, "rel_diff": rel, "tolerance": TRAIN_BF16_TOL,
            "launches": launches, "step_loss": float(loss_s),
            "ok": rel <= TRAIN_BF16_TOL and "xent_fwd" not in launches
            and launches.get("flash_fwd", 0) > 0
            and bool(np.isfinite(float(loss_s)))}


def train_arms(torch, dev, bw, smi, cell) -> list:
    """Phase 14: the base train step through each of the other arms;
    returns the rows of the kernels these arms launch."""
    from icikit_torch.bench.adam import run_bench as adam_bench
    from icikit_torch.bench.stream_ab import adam_bytes, device_ms
    from icikit_torch.ops import cuda_adam
    from icikit_torch.ops import cuda_xent as cx
    from icikit_torch.ops.adam import adam_scalars
    from icikit_torch.utils.timing import cuda_time_ms

    t0 = time.perf_counter()
    results = {arm: train_arm(torch, cell, arm, spec)
               for arm, spec in ARMS.items() if arm != "default"}
    emit({"phase": "train_arms", "card": smi, "preset": TRAIN_PRESET,
          "batch": TRAIN_BATCH, "seq": cell["seq"],
          "check_batch": TRAIN_CHECK_BATCH,
          "tolerance": {"loss": TRAIN_LOSS_TOL, "rel_l2": TRAIN_GRAD_TOL},
          "arms": results, "seconds": round(time.perf_counter() - t0, 1)})
    if not all(r["ok"] for r in results.values()):
        raise AssertionError(f"a train arm failed: {results}")

    # the standalone Adam bench: 211 M parameters, float32 moments, bf16
    # and float32 gradients (the library's yardstick takes float32)
    recs = [r for gdt in ("bfloat16", "float32")
            for r in adam_bench(211.0, runs=2, grad_dtype=gdt, device=dev,
                                windows=3)]
    emit({"phase": "adam_bench", "card": smi, "records": recs})

    # the kernels of this phase at the arms' shapes
    gen = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16

    def bound(nbytes, ops):
        t_b, t_o = nbytes / bw, ops / BF16_TENSOR_OPS
        return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"

    t, d, v = XENT_SHAPE
    x = torch.randn((t, d), generator=gen, device=dev).to(bf)
    w = (torch.randn((v, d), generator=gen, device=dev) * d ** -0.5).to(bf)
    tg = torch.randint(0, v, (t,), generator=gen, device=dev,
                       dtype=torch.int32)
    dn = torch.full((t,), 1.0 / t, device=dev)
    lse, _, e, mrun = cx.xent_fwd(x, w, tg, save=True)
    chunk = cx.TILE[bf]
    nc = -(-v // chunk)
    ops = 2 * t * v * d
    rows_io = 3 * t * 4
    kernel_rows = []
    specs = (
        ("xent_dx", "xent_dx (B10 recompute)", "icikit/ops/xent.py:374 "
         "(B10, _dx_kernel, e_ref=None)", "head-recompute",
         lambda: cx.xent_dx(x, w, tg, lse, dn),
         lambda: cx.xent_dx_plain(x, w, tg, lse, dn),
         bound((t * d + v * d + t * d) * 2 + rows_io, 2 * ops)),
        ("xent_dw", "xent_dw (B10 recompute)", "icikit/ops/xent.py:411 "
         "(B10, _dw_kernel, e_ref=None)", "head-recompute",
         lambda: cx.xent_dw(x, w, tg, lse, dn),
         lambda: cx.xent_dw_plain(x, w, tg, lse, dn),
         bound((t * d + v * d + v * d) * 2 + rows_io, 2 * ops)),
        ("xent_g", "xent_g (B11 recompute)", "icikit/ops/xent.py:312 "
         "(B11, _bwd_kernel)", "hb-matmul-recompute",
         lambda: cx.xent_g(x, w, tg, lse, dn),
         lambda: cx.xent_g_plain(x, w, tg, lse, dn),
         bound((t * d + v * d + t * v) * 2 + rows_io, ops)),
        ("xent_g_saved", "xent_g_saved (B11 saved)", "icikit/ops/xent.py:335 "
         "(B11, _g_saved_kernel)", "hb-matmul-saved",
         lambda: cx.xent_g_saved(e, mrun, tg, lse, dn),
         lambda: cx.xent_g_saved_plain(e, mrun, tg, lse, dn, chunk),
         bound(2 * t * v * 2 + nc * t * 4 + rows_io, 0)))
    mm_ms = cuda_time_ms(lambda: torch.matmul(x, w.t()), iters=5)
    for key, name, replaces, arm, kern, plain, (b_ms, b_by) in specs:
        k_ms = cuda_time_ms(kern, iters=5, warmup=1)
        p_ms = cuda_time_ms(plain, iters=2, warmup=1)
        kernel_rows.append({
            "name": name, "route": "cuda",
            "source": "icikit_torch/csrc/xent.cu", "replaces": replaces,
            "launches": results[arm]["launches_per_step"][key],
            "max_abs_err": _rel(kern(), plain()), "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
        if key == "xent_g":
            kernel_rows[-1].update(nearest_yardstick_ms=mm_ms,
                                   nearest_yardstick=XW_YARDSTICK)
    del x, w, e, mrun
    torch.cuda.empty_cache()

    # Adam over the base tree as the fused-pallas arm runs it: the tree
    # kernel at the step's gradient dtypes and at float32 gradients, the
    # library's fused Adam at float32 gradients (the same bytes as the
    # second), each beside the bound of its own bytes; device time by
    # CUDA events over calls queued behind a sleep kernel
    keys = list(cell["params"])
    tree = [cell["params"][k].clone() for k in keys]
    g_step = _base_tree_grads(torch, cell["params"], gen, bf)
    g_step = [g_step[k] for k in keys]
    g32 = [g.float() for g in g_step]
    mom = [[torch.zeros_like(x) for x in tree] for _ in range(2)]
    sc = adam_scalars(TRAIN_LR, torch.tensor(1, device=dev))
    a_launches = results["adam-kernel"]["launches_per_step"]["adam"]
    steps = [torch.ones((), device=dev) for _ in tree]
    a_lib = device_ms(lambda: torch._fused_adam_(
        tree, g32, *mom, [], steps, amsgrad=False, lr=TRAIN_LR, beta1=0.9,
        beta2=0.999, weight_decay=0.0, eps=1e-8, maximize=False), 10, 500.0)
    adam_info = {}
    for tag, gs in (("the step's gradients", g_step),
                    ("float32 gradients", g32)):
        a_ms = device_ms(lambda: cuda_adam.adam_tree(
            tree, *mom, gs, sc, 0.9, 0.999, 1e-8), 10, 500.0)
        a_plain = device_ms(lambda: cuda_adam.adam_tree_plain(
            tree, *mom, gs, sc, 0.9, 0.999, 1e-8), 3, 5000.0)
        runs = []
        for kern in (cuda_adam.adam_tree, cuda_adam.adam_tree_plain):
            st = [[x.clone() for x in t] for t in (tree, *mom)]
            kern(*st, gs, sc, 0.9, 0.999, 1e-8)
            runs.append(st)
        a_err = max(float((a - b).abs().max()) for x, y in zip(*runs)
                    for a, b in zip(x, y))
        del runs
        a_bytes = adam_bytes(tree, gs)
        adam_info[tag] = {"bytes": a_bytes, "ms": a_ms,
                          "tb_per_s": a_bytes / (a_ms * 1e-3) / 1e12}
        kernel_rows.append({
            "name": f"adam (B12), base tree, {tag}", "route": "cuda",
            "source": "icikit_torch/csrc/adam.cu",
            "replaces": "icikit/ops/adam.py:71 (B12, _adam_kernel)",
            "launches": a_launches, "max_abs_err": a_err, "ms": a_ms,
            "plain_ms": a_plain, "bound_ms": a_bytes / bw * 1e3,
            "bound_by": "bytes",
            "library_ms": a_lib if tag == "float32 gradients" else None})
    torch.cuda.synchronize()
    emit({"phase": "train_arm_timing_kernels",
          "xent": f"T={t} D={d} V={v} bf16", "matmul_x_wT_ms": mm_ms,
          "xent_library": "none: no one PyTorch call forms g or dx/dw "
                          "from recomputed logits; torch.matmul of x w^T "
                          "alone (cuBLAS) beside it",
          "adam": f"the base tree, {len(tree)} leaves, float32 moments, "
                  "at the step's gradient dtypes (matmul weights bf16) "
                  "and at float32 gradients; ms for the whole tree, one "
                  "launch, device time behind a sleep kernel",
          "adam_rows": adam_info, "adam_library_ms": a_lib,
          "adam_library": "torch._fused_adam_ over the same tree with "
                          "float32 gradients (28 B an element, the bytes "
                          "of the float32-gradient row), a yardstick: "
                          "torch's Adam without weight decay is optax's "
                          "with eps_root = 0",
          "max_abs_err": "xent rows relative to the largest entry; adam "
                         "absolute, p, m and v after one update"})
    del tree, g_step, g32, mom
    torch.cuda.empty_cache()
    return kernel_rows


def flash_occupancy() -> dict:
    """The bf16 flash kernels at every head dim: registers and local
    bytes a thread, dynamic shared memory a CTA and CTAs an SM."""
    from icikit_torch.ops import _build
    lib = _build.load("attention")
    # indices into icikit_attention_regs: flash_bwd, flash_bwd_dq,
    # flash_bwd_dkv, flash_fwd (icikit_flash_occupancy's order)
    regs_at = {32: (18, 20, 22, 24), 64: (19, 21, 23, 25),
               128: (3, 5, 7, 0), 256: (10, 12, 14, 8)}
    occ = {}
    for d, idx in regs_at.items():
        for which, (name, ri) in enumerate(zip(
                ("flash_bwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd"),
                idx)):
            r, loc, smem, ctas = (ctypes.c_int() for _ in range(4))
            _build.check(lib.icikit_attention_regs(
                ri, ctypes.byref(r), ctypes.byref(loc)), "kernel attributes")
            _build.check(lib.icikit_flash_occupancy(
                which, d, ctypes.byref(smem), ctypes.byref(ctas)),
                "occupancy")
            occ[f"{name} d{d}"] = {
                "registers": r.value, "local_bytes": loc.value,
                "smem_bytes": smem.value, "ctas_per_sm": ctas.value}
    return occ


def long_context(torch, dev, bw, smi) -> list:
    """Phase 15: the long-context attention bench through flash (B7 at
    32768, the two-pass B8 at 131072); returns the B8 rows."""
    import torch.nn.functional as F

    from icikit_torch.bench.attention import ORACLE_CHUNK, sweep_attention
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.utils.timing import cuda_time_ms

    t0 = time.perf_counter()
    b, h, d = LONG_SHAPE
    # one fwdbwd call's launches (each record's verification call), and
    # the kernels the whole sweep point launched, timing runs included
    want = {LONG_SEQS[0]: {"flash_fwd": 1, "flash_bwd": 1},
            LONG_SEQS[1]: {"flash_fwd": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1}}
    recs, totals = [], {}
    for seq in LONG_SEQS:
        ca.reset_launches()
        recs += sweep_attention((seq,), impls=["flash"], batch=b, heads=h,
                                d_head=d, dtype="bfloat16", causal=True,
                                mode="fwdbwd", runs=1, warmup=1, device=dev,
                                windows=2)
        torch.cuda.synchronize()
        totals[seq] = {k: n for k, n in ca.LAUNCHES.items() if n}
    emit({"phase": "long_context", "card": smi,
          "command": "sweep_attention((32768, 131072), impls=['flash'], "
                     "batch=1, heads=4, d_head=128, mode='fwdbwd')",
          "records": [json.loads(r.to_json()) for r in recs],
          "sweep_launches": totals,
          "seconds": round(time.perf_counter() - t0, 1)})
    bad = [r for r in recs if not r.verified or r.launches != want[r.seq]]
    bad += [(seq, got) for seq, got in totals.items()
            if set(got) != set(want[seq])]
    if bad:
        raise AssertionError(f"long-context path failed: {bad}")

    # the backward's gradients at each length against the chunked plain
    # versions, block by block (flash_bwd at 32768, the two-pass kernels
    # at 131072), and the two-pass kernels timed at 131072
    gen = torch.Generator(device=dev).manual_seed(8)
    scale = d ** -0.5
    checks = []
    for s in LONG_SEQS:
        q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        out, lse = ca.flash_fwd(q, k, v, True, scale)
        delta = (do.float() * out.float()).sum(-1)
        two = s == LONG_SEQS[1]
        if two:  # the forward against its chunked plain version
            w_out, w_lse = ca.flash_fwd_plain(q, k, v, True, scale,
                                              chunk=ORACLE_CHUNK)
            # out shrinks along the rows as the gradients do: held by
            # block, its error relative to the largest entry only shown
            fwd_err = {"out_block_rel_l2": _block_rel_l2(out, w_out),
                       "out_rel": _rel(out, w_out),
                       "lse": float((lse - w_lse).abs().max())}
            del w_out, w_lse
        del out
        args = (q, k, v, do, lse, delta, True, scale)
        got = ((ca.flash_bwd_dq(*args), *ca.flash_bwd_dkv(*args)) if two
               else ca.flash_bwd(*args))
        names = ("dq", "dk", "dv")
        # the two-pass kernels write every output once: a second call
        # gives the same bits
        same = ({n: torch.equal(a, c) for n, a, c in zip(
            names, got, (ca.flash_bwd_dq(*args), *ca.flash_bwd_dkv(*args)))}
            if two else {})
        want_ = ca.flash_bwd_plain(*args, chunk=ORACLE_CHUNK)
        rel = {n: _rel(a, c) for n, a, c in zip(names, got, want_)}
        l2 = {n: _block_rel_l2(a, c) for n, a, c in zip(names, got, want_)}
        checks.append({"seq": s, "kernels": ("flash_bwd_dq + flash_bwd_dkv"
                                             if two else "flash_bwd"),
                       "block_rel_l2": l2, "rel_err": rel,
                       **({"repeat_bitwise": same} if two else {}),
                       "ok": (max(l2.values()) <= BLOCK_L2_TOL["bf16"]
                              and all(same.values()))})
        del got, want_
        if not two:
            del q, k, v, do, lse, delta
            torch.cuda.empty_cache()
    pairs = b * h * s * (s + 1) // 2
    prod = 2 * d * pairs                      # one causal product
    io = 4 * b * h * s * d * 2 + 2 * b * h * s * 4
    rows = []
    # the function's five causal products, shared 3:4 as the kernels run
    # three (dq) and four (dk, dv) of the seven
    for name, kern, plain, n_prod, out_bytes, errs in (
            ("flash_bwd_dq", ca.flash_bwd_dq, ca.flash_bwd_dq_plain, 3,
             b * h * s * d * 2, ("dq",)),
            ("flash_bwd_dkv", ca.flash_bwd_dkv, ca.flash_bwd_dkv_plain, 4,
             2 * b * h * s * d * 2, ("dk", "dv"))):
        k_ms = cuda_time_ms(lambda: kern(*args), iters=3, warmup=1)
        p_ms = cuda_time_ms(lambda: plain(*args, chunk=ORACLE_CHUNK),
                            iters=1, warmup=0)
        t_b = (io + out_bytes) / bw
        t_o = 5 * n_prod / 7 * prod / BF16_TENSOR_OPS
        rows.append({"name": f"{name} (B8)", "route": "cuda",
                     "source": "icikit_torch/csrc/attention.cu",
                     "replaces": ("icikit/ops/flash_attention.py:745 (B8, "
                                  "_bwd_dq_kernel)" if name.endswith("dq")
                                  else "icikit/ops/flash_attention.py:771 "
                                       "(B8, _bwd_dkv_kernel)"),
                     "launches": recs[1].launches[name],
                     "max_abs_err": max(checks[1]["rel_err"][n]
                                        for n in errs),
                     "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": max(t_b, t_o) * 1e3,
                     "bound_by": "bytes" if t_b >= t_o else "operations"})
    lq, lk, lv = (t_.detach().clone().requires_grad_(True)
                  for t_ in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                        scale=scale)
    lib_ms = cuda_time_ms(lambda: torch.autograd.grad(
        lo, (lq, lk, lv), do, retain_graph=True), iters=3, warmup=1)
    for r in rows:
        r["library_ms"] = lib_ms
    # the forward alone, beside SDPA's causal forward and its bound (the
    # two causal products)
    f_ms = cuda_time_ms(lambda: ca.flash_fwd(q, k, v, True, scale),
                        iters=3, warmup=1)
    f_plain = cuda_time_ms(lambda: ca.flash_fwd_plain(
        q, k, v, True, scale, chunk=ORACLE_CHUNK), iters=1, warmup=0)
    f_lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale), iters=3, warmup=1)
    t_b = (4 * b * h * s * d * 2 + b * h * s * 4) / bw
    t_o = 2 * prod / BF16_TENSOR_OPS
    fwd_ok = (fwd_err["out_block_rel_l2"] <= BLOCK_L2_TOL["bf16"]
              and fwd_err["lse"] <= FLASH_TOL["bf16"]["lse"])
    rows.append({"name": "flash_fwd (B3, long context)", "route": "cuda",
                 "source": "icikit_torch/csrc/attention.cu",
                 "replaces": "icikit/ops/flash_attention.py:421 (B3, "
                             "_fwd_kernel)",
                 "launches": recs[1].launches["flash_fwd"],
                 "max_abs_err": fwd_err["out_rel"], "ms": f_ms,
                 "plain_ms": f_plain, "bound_ms": max(t_b, t_o) * 1e3,
                 "bound_by": "bytes" if t_b >= t_o else "operations",
                 "library_ms": f_lib})
    torch.cuda.synchronize()
    emit({"phase": "long_context_kernels", "card": smi,
          "shape": f"b={b} h={h} s={s} d={d} bf16 causal",
          "flash_fwd": {"ms": f_ms, "sdpa_forward_ms": f_lib,
                        "bound_ms": max(t_b, t_o) * 1e3,
                        "err_vs_chunked_plain": fwd_err,
                        "tolerance": {
                            "out_block_rel_l2": BLOCK_L2_TOL["bf16"],
                            "lse": FLASH_TOL["bf16"]["lse"]},
                        "ok": fwd_ok},
          "checks": checks,
          "occupancy": flash_occupancy(),
          "tolerance": {"block_rel_l2": BLOCK_L2_TOL["bf16"],
                        "block_rows": BLOCK_ROWS},
          "library": "SDPA's backward (dq, dk and dv together) through "
                     "autograd on the same tensors, beside each of the two "
                     "kernels",
          "bound": "the function's five causal products "
                   f"({5 * prod / BF16_TENSOR_OPS * 1e3:.2f} ms) shared "
                   "3:4 between the kernels, which run seven",
          "ms_sum": rows[0]["ms"] + rows[1]["ms"],
          "plain": f"the chunked plain versions, {ORACLE_CHUNK} Q rows a "
                   "step",
          "max_abs_err": "relative to the largest entry"})
    del q, k, v, do, lse, delta, lq, lk, lv, lo
    torch.cuda.empty_cache()
    bad = [c for c in checks if not c["ok"]]
    if bad or not fwd_ok:
        raise AssertionError(f"long-context forward or gradients disagree "
                             f"with the chunked plain versions: {bad}, "
                             f"forward {fwd_err}")
    return rows


def wide_head_checks(torch, dev, smi) -> None:
    """Phase 16: the flash kernels at d = 256 and the fused step at dh 256
    and 384 against their plain versions; a d_head-256 generate and a
    float32 train step of that config against the plain arms."""
    import dataclasses

    from icikit_torch.bench.train import PRESETS
    from icikit_torch.models.transformer import (TransformerConfig,
                                                 greedy_generate,
                                                 init_params,
                                                 loss_and_metrics,
                                                 make_model_mesh)
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops.rope import rope_sincos

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(9)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def err(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    checks = []
    for dtype, key in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        tol, l2_tol = FLASH_TOL[key], BLOCK_L2_TOL[key]
        for b, h, s_, d in WIDE_SHAPES:
            q, k, v, do = (randn((b, h, s_, d), dtype) for _ in range(4))
            scale = d ** -0.5
            for causal in (True, False):
                out, lse = ca.flash_fwd(q, k, v, causal, scale)
                w_out, w_lse = ca.flash_fwd_plain(q, k, v, causal, scale)
                delta = (do.float() * out.float()).sum(-1)
                args = (q, k, v, do, lse, delta, causal, scale)
                want = ca.flash_bwd_plain(*args)
                got = {"flash_bwd": ca.flash_bwd(*args),
                       "two_pass": (ca.flash_bwd_dq(*args),
                                    *ca.flash_bwd_dkv(*args))}
                rel = {n: max(_rel(a, c) for a, c in zip(g, want))
                       for n, g in got.items()}
                l2 = {n: max(_block_rel_l2(a, c) for a, c in zip(g, want))
                      for n, g in got.items()}
                e_o, e_l = err(out, w_out), err(lse, w_lse)
                checks.append({
                    "kernel": "flash_fwd, flash_bwd, flash_bwd_dq + "
                              "flash_bwd_dkv", "dtype": key,
                    "shape": [b, h, s_, d], "causal": causal,
                    "out_err": e_o, "lse_err": e_l, "grad_rel_err": rel,
                    "grad_block_rel_l2": l2,
                    "ok": e_o <= tol["out"] and e_l <= tol["lse"]
                    and max(rel.values()) <= tol["grad"]
                    and max(l2.values()) <= l2_tol})
                del out, lse, w_out, w_lse, delta, want, got
            del q, k, v, do
        rows, total = 64, DEC_PROMPT + DEC_NEW
        for dh in (256, 384):
            for cur in sorted({0, min(300, total - 1), total - 1}):
                q, k, v = (randn((rows, dh), dtype) for _ in range(3))
                kc, vc = (randn((rows, total, dh), dtype) for _ in range(2))
                c, s_ = rope_sincos(torch.tensor([cur], device=dev), dh)
                cos2, sin2 = torch.cat([c, c], -1), torch.cat([s_, s_], -1)
                kc2, vc2 = kc.clone(), vc.clone()
                got = ca.decode_step(q, k, v, kc, vc, cur, cos2, sin2,
                                     scale=dh ** -0.5, rope=True)
                want = ca.decode_step_plain(q, k, v, kc2, vc2, cur, cos2,
                                            sin2, scale=dh ** -0.5, rope=True)
                e_o = err(got, want)
                same = bool(torch.equal(kc, kc2) and torch.equal(vc, vc2))
                checks.append({"kernel": "decode_step", "dtype": key,
                               "rows": rows, "total": total, "dh": dh,
                               "cur": cur, "out_err": e_o,
                               "cache_bitwise": same,
                               "ok": e_o <= tol["out"] and same})
    torch.cuda.synchronize()
    bad = [c for c in checks if not c["ok"]]

    # the d_head-256 path: a generate at bf16 with its launches counted
    # and at float32 against the plain arms; a float32 b 2 train step
    mesh = make_model_mesh(device=dev)
    base = dict(PRESETS[DEC_PRESET], **WIDE_CFG)
    cfg = TransformerConfig(**base, decode_step="fused",
                            attention_impl="flash")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    prompt = torch.randint(0, cfg.vocab, (DEC_BATCH, DEC_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    greedy_generate(params, prompt, mesh, cfg, 2)
    torch.cuda.synchronize()
    ca.reset_launches()
    out = greedy_generate(params, prompt, mesh, cfg, WIDE_NEW)
    torch.cuda.synchronize()
    launches = {k: n for k, n in ca.LAUNCHES.items() if n}
    want_l = {"flash_fwd": cfg.n_layers,
              "decode_step": cfg.n_layers * (WIDE_NEW - 1)}
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    t32, lg32 = greedy_generate(params, prompt, mesh, f32, WIDE_NEW,
                                return_logits=True)
    t32p, lg32p = greedy_generate(params, prompt, mesh, dataclasses.replace(
        f32, decode_step="unfused", attention_impl="dense"), WIDE_NEW,
        return_logits=True)
    div = _first_divergence(t32, t32p, lg32, lg32p, DEC_PROMPT,
                            FP32_LOGIT_TOL)
    bad_div = [r for r in div if r["max_logit_diff"] > FP32_LOGIT_TOL
               or (r["first_diff"] is not None and not r["near_tie"])]
    del lg32, lg32p
    tcfg = _train_config("float32", **WIDE_CFG)
    tok = torch.randint(0, cfg.vocab, (TRAIN_CHECK_BATCH, TRAIN_SEQ_WIDE),
                        generator=gen, device=dev, dtype=torch.int32)
    tgt = tok.roll(1, 1)
    ca.reset_launches()
    loss_k, g_k, _ = loss_and_metrics(params, tok, tgt, mesh, tcfg)
    torch.cuda.synchronize()
    t_launches = {k: n for k, n in ca.LAUNCHES.items() if n}
    loss_p, g_p, _ = loss_and_metrics(params, tok, tgt, mesh,
                                      dataclasses.replace(
                                          tcfg, attention_impl="dense",
                                          fused_head=False))
    train = {"loss": float(loss_k), "loss_plain": float(loss_p),
             "loss_diff": abs(float(loss_k) - float(loss_p)),
             "rel_l2_max": max(_rel_l2(g_k[k], g_p[k]) for k in g_p),
             "launches": t_launches}
    ok_path = (launches == want_l and not bad_div
               and tuple(out.shape) == (DEC_BATCH, DEC_PROMPT + WIDE_NEW)
               and t_launches == {"flash_fwd": tcfg.n_layers,
                                  "flash_bwd": tcfg.n_layers}
               and train["loss_diff"] <= TRAIN_LOSS_TOL
               and train["rel_l2_max"] <= TRAIN_GRAD_TOL)
    emit({"phase": "wide_head", "card": smi,
          "tolerance": {"flash": FLASH_TOL, "block_rel_l2": BLOCK_L2_TOL,
                        "decode_step": "out as flash's, cache bitwise",
                        "generate_fp32_logits": FP32_LOGIT_TOL,
                        "train_loss": TRAIN_LOSS_TOL,
                        "train_rel_l2": TRAIN_GRAD_TOL},
          "checks": checks,
          "generate": {"config": base, "batch": DEC_BATCH,
                       "prompt": DEC_PROMPT, "n_new": WIDE_NEW,
                       "launches_bf16": launches, "want": want_l,
                       "fp32_tokens_identical": bool(torch.equal(t32, t32p)),
                       "fp32_rows": div},
          "train_fp32_b2": dict(train, seq=TRAIN_SEQ_WIDE),
          "seconds": round(time.perf_counter() - t0, 1)})
    del params, g_k, g_p
    torch.cuda.empty_cache()
    if bad or not ok_path:
        raise AssertionError(f"d = 256 checks failed: kernels {bad}, path "
                             f"{launches} {bad_div} {train}")


def _q8_step_operands(torch, gen, dev, rows, total, dh, cur, qdtype):
    """The int8 step's operands: q, the fresh column (int8 and its
    dequant), int8 caches and their scale rows holding the column's."""
    from icikit_torch.ops.quant import dequantize_last, quantize_last

    q = torch.randn((rows, dh), generator=gen, device=dev).to(qdtype)
    kq, ks = quantize_last(torch.randn((rows, dh), generator=gen,
                                       device=dev))
    vq, vs = quantize_last(torch.randn((rows, dh), generator=gen,
                                       device=dev))
    kc, kcs = quantize_last(torch.randn((rows, total, dh), generator=gen,
                                        device=dev))
    vc, vcs = quantize_last(torch.randn((rows, total, dh), generator=gen,
                                        device=dev))
    kcs[:, cur], vcs[:, cur] = ks, vs
    return (q, kq, vq, dequantize_last(kq, ks), dequantize_last(vq, vs),
            kc, vc, kcs, vcs)


def int8_kernel_checks(torch, dev) -> None:
    """Phase 17: B15 at every (N, K) of the int8 path, rows 8, 4095 and
    4096, and B14 at the path's step shape, against their plain
    versions."""
    from icikit_torch.ops import _build
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops import cuda_quant as cq

    gen = torch.Generator(device=dev).manual_seed(10)
    checks = []
    for dtype, key in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for rows, n, k, tp in [
                (r, n, k, 1) for r in Q8_CHECK_ROWS
                for n, k in Q8_SHAPES.values()] + [
                (r, n, k, 2) for r in Q8_ROWS
                for n, k in Q8_TP_SHAPES.values()]:
            x = torch.randn((rows, k), generator=gen,
                            device=dev).to(dtype)
            w8 = torch.randint(-127, 128, (n, k), generator=gen,
                               device=dev, dtype=torch.int8)
            sc = torch.rand((n,), generator=gen, device=dev) / 127
            got, want = cq.quant_matvec(x, w8, sc), \
                cq.quant_matvec_plain(x, w8, sc)
            e = _rel(got, want)
            checks.append({"kernel": "quant_matvec", "dtype": key,
                           "rows": rows, "n": n, "k": k, "tp": tp,
                           "rel_err": e,
                           "ok": e <= QMV_TOL[key]})
            del x, w8, sc, got, want
        total = DEC_PROMPT + DEC_NEW
        for dh in (128, 256):
            # the path's rows; then rows 8 at cur 543 (33 splits of 17
            # columns) and rows 1 at cur 575 (35 of 17), whose last split
            # the picker leaves empty
            for rows, cur in [(DEC_BATCH * 8, c) for c in sorted(
                    {0, 1, 127, 128, min(300, total - 1), 543, total - 1})
                    ] + [(8, 543), (1, total - 1)]:
                ops = _q8_step_operands(torch, gen, dev, rows, total, dh,
                                        cur, dtype)
                kc2, vc2 = ops[5].clone(), ops[6].clone()
                want = ca.decode_step_q8_plain(*ops[:5], kc2, vc2, *ops[7:],
                                               cur, scale=dh ** -0.5)
                got = ca.decode_step_q8(*ops, cur, scale=dh ** -0.5)
                e = float((got - want).abs().max())
                same = bool(torch.equal(ops[5], kc2)
                            and torch.equal(ops[6], vc2))
                checks.append({"kernel": "decode_step_q8", "q_dtype": key,
                               "rows": rows, "total": total, "dh": dh,
                               "cur": cur, "splits": ca.decode_splits(
                                   rows, cur, _build.sm_count(ops[0].device)),
                               "out_err": e, "cache_bitwise": same,
                               "ok": e <= Q8_STEP_TOL and same})
    torch.cuda.synchronize()
    emit({"phase": "int8_kernels",
          "tolerance": {"quant_matvec": QMV_TOL, "decode_step_q8":
                        Q8_STEP_TOL,
                        "why": "quant_matvec: rel_err is the largest |error| "
                               "over the largest |reference| entry; the "
                               "products are exact in both (int8 in bf16 or "
                               "float32), the sums of K terms in other "
                               "orders (bf16 x on the tensor cores, float32 "
                               "x by FMA); decode_step_q8: the output "
                               "absolute, float32 sums in other orders, the "
                               "int8 cache columns bit for bit; TF32 off"},
          "checks": checks})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"int8 kernel disagrees with its plain version: "
                             f"{bad}")


def int8_decode_path(torch, dev, bw, smi) -> dict:
    """Phase 18: the int8 decode path at the base preset; returns the
    kernel launches of its main run and its trace's device time by
    kernel."""
    import dataclasses

    from icikit_torch.bench.decode import decode_bytes_per_token, make_config
    from icikit_torch.models.transformer import (greedy_generate,
                                                 init_params,
                                                 make_model_mesh)
    from icikit_torch.models.transformer.decode import (
        _DecodeCtx, _prefill, maybe_quantize_params)
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops import cuda_quant as cq
    from icikit_torch.utils.timing import cuda_time_ms, timeit_windows
    from icikit_torch.utils.trace import device_activity

    t0 = time.perf_counter()
    mesh = make_model_mesh(device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    plain = dict(decode_step="unfused", quant_matvec="xla",
                 attention_impl="dense")

    def config(dtype, **over):
        return make_config(DEC_PRESET, DEC_PROMPT, DEC_NEW,
                           **{"decode_step": "fused",
                              "attention_impl": "flash",
                              "decode_quant": "int8",
                              "quant_matvec": "auto",
                              "compute_dtype": dtype, **over})

    cfg = config("bfloat16")
    fp = init_params(cfg, gen, dev)          # phase 8's masters and prompt
    prompt = torch.randint(0, cfg.vocab, (DEC_BATCH, DEC_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    params = maybe_quantize_params(fp, mesh, cfg)   # once, outside timing

    # the main path's run, counted
    greedy_generate(params, prompt, mesh, cfg, 2)   # first-call set-up
    torch.cuda.synchronize()
    ca.reset_launches()
    cq.reset_launches()
    out, lg16 = greedy_generate(params, prompt, mesh, cfg, DEC_NEW,
                                return_logits=True)
    torch.cuda.synchronize()
    launches = {**ca.LAUNCHES, **cq.LAUNCHES}
    per_call = 4 * cfg.n_layers + 1
    want = {**dict.fromkeys(launches, 0), "flash_fwd": cfg.n_layers,
            "decode_step_q8": cfg.n_layers * (DEC_NEW - 1),
            "quant_matvec": per_call * DEC_NEW}
    if launches != want:
        raise AssertionError(f"int8 decode path launches {launches}, want "
                             f"{want}")
    ok_shape = (tuple(out.shape) == (DEC_BATCH, DEC_PROMPT + DEC_NEW)
                and bool(torch.equal(out[:, :DEC_PROMPT], prompt))
                and int(out.min()) >= 0 and int(out.max()) < cfg.vocab
                and bool(torch.isfinite(lg16).all()))
    if not ok_shape:
        raise AssertionError("int8 decode path output malformed")
    ctx = _DecodeCtx(cfg, params)
    _, (kcs, vcs, kss, vss) = _prefill(ctx, prompt, DEC_PROMPT,
                                       DEC_PROMPT + DEC_NEW, True)
    caches = {"k_v": sorted({str(c.dtype) for c in kcs + vcs}),
              "scales": sorted({str(c.dtype) for c in kss + vss}),
              "k_shape": list(kcs[0].shape), "scale_shape": list(kss[0].shape)}
    del ctx, kcs, vcs, kss, vss
    if caches["k_v"] != ["torch.int8"] or caches["scales"] != [
            "torch.float32"]:
        raise AssertionError(f"int8 path caches: {caches}")

    # bf16 against the plain arms: first-step logits; token agreement with
    # the bf16 (unquantized) fused path, as information
    out_p, lg16_p = greedy_generate(params, prompt, mesh,
                                    config("bfloat16", **plain), DEC_NEW,
                                    return_logits=True)
    d16 = (lg16[0] - lg16_p[0]).abs()
    out_fp = greedy_generate(fp, prompt, mesh, config(
        "bfloat16", decode_quant="none"), DEC_NEW)
    bf16 = {"first_logits_max_diff": float(d16.max()),
            "first_logits_mean_diff": float(d16.mean()),
            "tolerance": BF16_LOGIT_TOL,
            "token_equal_share_plain_arms": float(
                (out[:, DEC_PROMPT:] == out_p[:, DEC_PROMPT:]).float().mean()),
            "token_agreement_with_bf16_path_info": float(
                (out[:, DEC_PROMPT:] == out_fp[:, DEC_PROMPT:]).float()
                .mean())}
    del lg16, lg16_p

    # float32: tokens identical up to near-ties
    c32 = config("float32")
    t32, lg32 = greedy_generate(params, prompt, mesh, c32, DEC_NEW,
                                return_logits=True)
    t32p, lg32p = greedy_generate(params, prompt, mesh,
                                  config("float32", **plain), DEC_NEW,
                                  return_logits=True)
    rows = _first_divergence(t32, t32p, lg32, lg32p, DEC_PROMPT,
                             INT8_FP32_LOGIT_TOL)
    fp32 = {"tokens_identical": bool(torch.equal(t32, t32p)),
            "logit_tolerance": INT8_FP32_LOGIT_TOL, "rows": rows}
    del lg32, lg32p
    emit({"phase": "int8_decode_check", "preset": DEC_PRESET,
          "batch": DEC_BATCH, "prompt": DEC_PROMPT, "n_new": DEC_NEW,
          "launches": launches, "caches": caches, "bf16": bf16, "fp32": fp32,
          "fp32_tolerance_why": "a K/V element within float32 rounding of "
                                "an int8 rounding boundary quantizes to the "
                                "neighbouring value in one arm (the kernel "
                                "and cuBLAS sum the projections in other "
                                "orders); one int8 step of a K column moves "
                                "an attention logit by "
                                "|q_d| amax/127/sqrt(dh)",
          "seconds": round(time.perf_counter() - t0, 1)})
    bad32 = [r for r in rows if r["max_logit_diff"] > INT8_FP32_LOGIT_TOL
             or (r["first_diff"] is not None and not r["near_tie"])]
    if bad32 or bf16["first_logits_max_diff"] > BF16_LOGIT_TOL:
        raise AssertionError(f"int8 decode path disagrees with its plain "
                             f"arms: fp32 {bad32}, bf16 {bf16}")

    # timing: the int8 fused arm beside phase 8's bf16 fused arm
    ctr = [0]

    def chain(args, o):
        ctr[0] += 1
        nxt = o[:, -DEC_PROMPT:].clone()
        nxt[0, 0] = ctr[0] % cfg.vocab
        return (nxt,)

    cache_len = DEC_PROMPT + DEC_NEW
    bytes8 = decode_bytes_per_token(cfg, DEC_BATCH, cache_len,
                                    bytes_dtype="int8")
    bytes16 = decode_bytes_per_token(cfg, DEC_BATCH, cache_len)
    arms = {}
    for name, c, p, nbytes in (
            ("int8_fused", cfg, params, bytes8),
            ("bf16_fused", dataclasses.replace(cfg, decode_quant="none"), fp,
             bytes16)):
        res = timeit_windows(
            lambda x, c=c, p=p: greedy_generate(p, x, mesh, c, DEC_NEW),
            (prompt,), chain, windows=3, runs=2, warmup=1,
            floor_s=DEC_NEW * nbytes / bw, max_windows=3)
        arms[name] = {"per_token_ms": res.median_s / DEC_NEW * 1e3,
                      "spread_ms": [res.min_s / DEC_NEW * 1e3,
                                    res.max_s / DEC_NEW * 1e3],
                      "tokens_per_s": DEC_BATCH * DEC_NEW / res.median_s,
                      "generate_ms": res.median_s * 1e3,
                      "bound_ms_per_token": nbytes / bw * 1e3,
                      "windows": res.windows, "suspect": res.suspect}
    prefill_ms = cuda_time_ms(
        lambda: greedy_generate(params, prompt, mesh, cfg, 1), iters=5)
    activity = device_activity(
        lambda: greedy_generate(params, prompt, mesh, cfg, DEC_NEW),
        attempts=TRACE_ATTEMPTS)
    traced_q8 = activity["by_name"].get("decode_step_q8_kernel",
                                        {}).get("count", 0)
    emit({"phase": "int8_decode_timing", "card": smi, "arms": arms,
          "traced_decode_step_q8_launches": traced_q8,
          "prefill_ms": prefill_ms,
          "step_ms_excluding_prefill": (arms["int8_fused"]["generate_ms"]
                                        - prefill_ms) / (DEC_NEW - 1),
          "bound_ms_per_token": bytes8 / bw * 1e3, "bytes_per_token": bytes8,
          "read_gbps": bytes8 / (arms["int8_fused"]["per_token_ms"] * 1e-3)
          / 1e9,
          "profile": activity,
          "seconds": round(time.perf_counter() - t0, 1)})
    del params, fp
    torch.cuda.empty_cache()
    if traced_q8 != want["decode_step_q8"]:
        raise AssertionError(f"the traced int8 generate ran "
                             f"decode_step_q8_kernel {traced_q8} times, "
                             f"want {want['decode_step_q8']}")
    return launches, activity["by_name"]


def int8_rows(torch, dev, bw, launches, path_trace) -> list:
    """Phase 19's rows for B15 and B14 at the int8 path's shapes; beside
    them in the phase line, each kernel's device time a launch in phase
    18's trace of the main path (``path_trace``: its ``by_name``). At
    the step's 8 rows a launch takes less device time than the host
    takes to issue it, so B15 there (and its library call and cuBLAS's
    bf16 product), like B14, is timed by device time a launch behind a
    sleep kernel, each call on the next of enough copies of the weights
    to pass the L2, as on the path; at the prefill's 4096 rows by device
    time a launch behind a sleep kernel too (the wrapper's host time
    exceeds wo's device time), on one copy: the products bound them."""
    from icikit_torch.bench.quant_ab import PER_STEP
    from icikit_torch.bench.stream_ab import (copies_past_l2, device_ms,
                                              rotating)
    from icikit_torch.ops import _build
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops import cuda_quant as cq
    from icikit_torch.utils.timing import cuda_time_ms

    gen = torch.Generator(device=dev).manual_seed(11)
    bf = torch.bfloat16

    def bound(nbytes, ops, rate):
        t_b, t_o = nbytes / bw, ops / rate
        return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"

    rows_out, shapes = [], {}
    for rows in Q8_ROWS:
        for name, (n, k) in Q8_SHAPES.items():
            skinny = rows <= cq.SKINNY_ROWS
            x = torch.randn((rows, k), generator=gen, device=dev).to(bf)
            w8s = [torch.randint(-127, 128, (n, k), generator=gen,
                                 device=dev, dtype=torch.int8)
                   for _ in range(copies_past_l2(n * k) if skinny else 1)]
            w8 = w8s[0]
            sc = torch.rand((n,), generator=gen, device=dev) / 127
            s16 = sc.to(bf)
            w16s = [w.to(bf) for w in w8s[:copies_past_l2(2 * n * k)]]

            def timed(fn, ops):
                if skinny:
                    return device_ms(rotating(fn, ops), 100, 250.0)
                return device_ms(lambda: fn(ops[0]), 10, 400.0)

            k_ms = timed(lambda w: cq.quant_matvec(x, w, sc), w8s)
            p_ms = cuda_time_ms(lambda: cq.quant_matvec_plain(x, w8, sc),
                                iters=10, warmup=2)
            mm_ms = timed(lambda w: torch.matmul(x, w.t()), w16s)
            try:
                lib_ms = timed(lambda w: torch._weight_int8pack_mm(
                    x, w, s16), w8s)
            except (RuntimeError, NotImplementedError) as exc:
                lib_ms, lib_why = None, f"{type(exc).__name__}: {exc}"[:160]
            else:
                lib_why = "torch._weight_int8pack_mm (bf16 out)"
            b_ms, b_by = bound(n * k + rows * k * 2 + n * 4 + rows * n * 4,
                               2 * rows * n * k, BF16_TENSOR_OPS)
            e = _rel(cq.quant_matvec(x, w8, sc), cq.quant_matvec_plain(x, w8,
                                                                       sc))
            shapes[f"{name} rows {rows}"] = {
                "n": n, "k": k, "ms": k_ms, "plain_ms": p_ms,
                "splits": cq.skinny_splits(rows, k) if skinny else None,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "library": lib_why, "cublas_bf16_ms": mm_ms, "rel_err": e}
            if (name, rows) in Q8_ROW_ENTRIES:
                rows_out.append({
                    "name": f"quant_matvec (B15) {name}, rows {rows}",
                    "route": "cuda", "source": "icikit_torch/csrc/quant.cu",
                    "replaces": "icikit/ops/quant.py:167 (B15, "
                                "_matvec_kernel :108)",
                    "launches": launches["quant_matvec"], "max_abs_err": e,
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": lib_ms})
            del x, w8, w8s, sc, w16s
    r_, total, dh = DEC_BATCH * 8, DEC_PROMPT + DEC_NEW, 128
    cur = DEC_PROMPT + (DEC_NEW - 1) // 2       # the steps' mean column
    # device time a launch behind a sleep kernel (the host issues a call
    # more slowly than the card runs it), the caches rotated past the L2
    # as the path's 12 layers' are
    copies = [_q8_step_operands(torch, gen, dev, r_, total, dh, cur, bf)
              for _ in range(copies_past_l2(2 * r_ * total * (dh + 4)))]
    ops = copies[0]
    s_ms = device_ms(rotating(lambda o: ca.decode_step_q8(
        *o, cur, scale=dh ** -0.5), copies), 100, 250.0)
    s_events = cuda_time_ms(lambda: ca.decode_step_q8(*ops, cur,
                                                      scale=dh ** -0.5),
                            iters=100, warmup=5)
    s_plain = cuda_time_ms(lambda: ca.decode_step_q8_plain(
        *ops, cur, scale=dh ** -0.5), iters=10)
    s_err = float((ca.decode_step_q8(*ops, cur, scale=dh ** -0.5)
                   - ca.decode_step_q8_plain(*ops[:5], ops[5].clone(),
                                             ops[6].clone(), *ops[7:], cur,
                                             scale=dh ** -0.5)).abs().max())
    s_bytes = (2 * r_ * cur * dh + 2 * r_ * cur * 4   # int8 K/V, scales
               + r_ * dh * 2 + 2 * r_ * dh + 2 * r_ * dh * 4  # q, columns
               + r_ * dh * 4 + 2 * r_ * dh)           # out, column writes
    s_bound, s_by = bound(s_bytes, 2 * 2 * r_ * (cur + 1) * dh, VECTOR_OPS)
    rows_out.append({
        "name": "decode_step_q8 (B14)", "route": "cuda",
        "source": "icikit_torch/csrc/attention.cu",
        "replaces": "icikit/ops/flash_attention.py:1229 (B14, "
                    "_decode_step_q8_kernel :1137)",
        "launches": launches["decode_step_q8"], "max_abs_err": s_err,
        "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound,
        "bound_by": s_by, "library_ms": None})
    torch.cuda.synchronize()
    path_us = {k: 1e3 * v["ms"] / v["count"] for k, v in path_trace.items()
               if k in ("qmv_bf16_skinny", "qmv_bf16_tile",
                        "decode_step_q8_kernel")}
    step = {key: sum(PER_STEP[nm] * shapes[f"{nm} rows {DEC_BATCH}"][key]
                     for nm in Q8_SHAPES) for key in ("ms", "bound_ms")}
    prefill = DEC_BATCH * DEC_PROMPT
    layer = {key: sum(shapes[f"{nm} rows {prefill}"][key]
                      for nm in Q8_PREFILL)
             for key in ("ms", "bound_ms", "cublas_bf16_ms")}
    emit({"phase": "int8_timing_kernels", "quant_matvec": shapes,
          "quant_matvec_step_rows8": {**step, "per_step": PER_STEP},
          "quant_matvec_layer_rows4096": {
              **layer, "products": Q8_PREFILL,
              "launches_a_generate": 12 * len(Q8_PREFILL)},
          "ms": "rows 8: device time a launch behind a sleep kernel, "
                "the weights rotated through copies past 256 MiB (from "
                "device memory, as on the path), the library call and "
                "cuBLAS bf16 the same; rows 4096: the same on one copy of "
                "the weights, 10 calls",
          "path_trace_device_us_per_launch": path_us,
          "quant_matvec_bound": "int8 weights, bf16 x, float32 scales and "
                                "out once; products at the bf16 tensor "
                                "rate",
          "decode_step_q8": f"rows={r_} total={total} dh={dh} cur={cur} "
                            f"bf16 q, {s_bytes} bytes, splits "
                            f"{ca.decode_splits(r_, cur, _build.sm_count(dev))}",
          "decode_step_q8_ms": "device time a launch behind a sleep "
                               "kernel, the caches rotated through "
                               f"{len(copies)} copies; by CUDA events "
                               "around 100 back-to-back calls on one "
                               f"(the host's rate): {s_events}",
          "decode_step_q8_library": "none: no one PyTorch call writes the "
                                    "int8 column and attends over int8 "
                                    "caches with folded scales",
          "max_abs_err": "quant_matvec relative to the largest entry; "
                         "decode_step_q8 absolute"})
    return rows_out


def tile_floor_kernel_checks(torch, dev) -> None:
    """Phase 20: B17's five kernels against their plain versions at each
    TILE_CHECK shape, head dims 64 and 128, bq = bk = ``ctf.TILE``."""
    from icikit_torch.bench.tile_floor import ABLATIONS, LOG2E_JAX
    from icikit_torch.ops import cuda_tile_floor as ctf

    gen = torch.Generator(device=dev).manual_seed(8)
    checks = []
    for (b, h, s), d in itertools.product(TILE_CHECK, TILE_DIMS):
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        scale_log2 = d ** -0.5 * LOG2E_JAX
        pairs = [("mxu", ctf.tile_mxu(q, k, v, scale_log2),
                  ctf.mxu_plain(q, k, v, scale_log2))]
        pairs += [(name, ctf.tile_ablate(q, k, v, scale_log2, e, m),
                   ctf.ablate_plain(q, k, v, scale_log2, e, m))
                  for name, e, m in ABLATIONS]
        for name, got, want in pairs:
            err = _rel(got, want)
            finite = bool(torch.isfinite(got.float()).all())
            checks.append({"variant": name, "s": s, "d": d, "rel_err": err,
                           "finite": finite,
                           "ok": finite and err <= TILE_TOL})
    torch.cuda.synchronize()
    emit({"phase": "tile_floor_kernels", "shapes": [list(t) for t in
                                                   TILE_CHECK],
          "dims": list(TILE_DIMS), "tile": ctf.TILE, "tolerance": TILE_TOL,
          "why": "bf16: the kernel and the plain version round w to bf16 "
                 "at scores whose float32 sums differ in order, so a "
                 "score on a rounding boundary rounds apart; the error "
                 "is relative to the largest |plain| entry",
          "checks": checks})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"tile-floor kernel disagrees with its plain "
                             f"version: {bad}")


def tile_floor_path(torch, dev, bw, smi) -> list:
    """Phase 21: the tile-floor study (``bench.tile_floor.measure``) at
    TILE_PATH for each head dim, its launches counted; then B17's five
    kernels against their plain versions at the path's shapes, both head
    dims, within TILE_TOL; returns the rows of B17's kernels timed at the
    path's shapes, both head dims."""
    from icikit_torch.bench.tile_floor import (ABLATIONS, LOG2E_JAX,
                                               measure, render, tile_ops)
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops import cuda_tile_floor as ctf
    from icikit_torch.utils.timing import cuda_time_ms

    t0 = time.perf_counter()
    h, seq = TILE_PATH
    tile = ctf.TILE
    results = {}
    ctf.reset_launches()
    ca.reset_launches()
    for d in TILE_DIMS:
        recs = measure(seq, d=d, h=h, windows=3, device=dev)
        results[d] = {r["variant"]: r for r in recs}
    torch.cuda.synchronize()
    launches = {**ctf.LAUNCHES, "flash_fwd": ca.LAUNCHES["flash_fwd"]}
    ok = all(n > 0 for n in launches.values()) and all(
        r["per_tile_us"] > 0 and r["tiles"] == (
            h * (seq // tile) * (seq // tile + 1) // 2 if n == "full"
            else h * (seq // tile) ** 2) and r["bq"] == r["bk"] == tile
        for by in results.values() for n, r in by.items())
    for d, by in results.items():
        bound_us = tile_ops(tile, tile, d) / BF16_TENSOR_OPS * 1e6
        emit({"phase": "tile_floor", "card": smi, "h": h, "seq": seq,
              "d": d, "tile": tile, "launches": launches,
              "per_tile_us": {n: r["per_tile_us"] for n, r in by.items()},
              "per_tile_bound_us": bound_us,
              "bound_by": f"operations (4 x {tile} x {tile} x d at 989 "
                          "TFLOP/s)",
              "tiles": {n: r["tiles"] for n, r in by.items()},
              "median_s": {n: r["median_s"] for n, r in by.items()},
              "spread_s": {n: r["spread_s"] for n, r in by.items()},
              "session_quality": by["mxu"]["session_quality"],
              "render": render(list(by.values())).splitlines(),
              "seconds": round(time.perf_counter() - t0, 1)})
    if not ok:
        raise AssertionError(f"tile-floor path: a kernel was not launched, "
                             f"a variant gave no time or another tile "
                             f"count: {launches}")

    # B17's five kernels against their plain versions at the path's
    # shapes, both head dims (these launches come after the count), each
    # timed beside its plain version, and softmax_ks1 beside the one
    # PyTorch call that computes its function, non-causal
    # scaled_dot_product_attention, at that d
    gen = torch.Generator(device=dev).manual_seed(9)
    checks, rows, timing = [], [], {}
    for d in TILE_DIMS:
        q, k, v = (torch.randn((1, h, seq, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        scale_log2 = d ** -0.5 * LOG2E_JAX
        variants = {"mxu": (
            "tile_mxu", lambda: ctf.tile_mxu(q, k, v, scale_log2),
            lambda: ctf.mxu_plain(q, k, v, scale_log2))}
        for name, e, m in ABLATIONS:
            variants[name] = (
                "tile_ablate",
                lambda e=e, m=m: ctf.tile_ablate(q, k, v, scale_log2, e, m),
                lambda e=e, m=m: ctf.ablate_plain(q, k, v, scale_log2, e, m))
        errs = {}
        for name, (_, kern, plain) in variants.items():
            got, want = kern(), plain()
            errs[name] = _rel(got, want)
            finite = bool(torch.isfinite(got.float()).all())
            checks.append({"variant": name, "d": d, "rel_err": errs[name],
                           "finite": finite,
                           "ok": finite and errs[name] <= TILE_TOL})
            del got, want
        tiles = h * (seq // tile) ** 2
        t_ops = tiles * tile_ops(tile, tile, d) / BF16_TENSOR_OPS
        t_bytes = 4 * q.numel() * 2 / bw
        bound_ms = max(t_ops, t_bytes) * 1e3
        bound_by = "operations" if t_ops >= t_bytes else "bytes"

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, scale=d ** -0.5)

        lib_ms = cuda_time_ms(sdpa, iters=3, warmup=1)
        timing[d] = {"sdpa_noncausal_ms": lib_ms,
                     "library_rel_err_vs_softmax_ks1": _rel(
                         sdpa(), ctf.ablate_plain(q, k, v, scale_log2,
                                                  True, True)),
                     "ms": {}, "plain_ms": {}}
        for name, (key, kern, plain) in variants.items():
            ms = cuda_time_ms(kern, iters=3, warmup=1)
            p_ms = cuda_time_ms(plain, iters=1, warmup=1)
            timing[d]["ms"][name], timing[d]["plain_ms"][name] = ms, p_ms
            if name not in ("mxu", "softmax_ks1"):
                continue
            label = key if name == "mxu" else f"{key} {name}"
            rows.append({
                "name": f"{label} (B17), d {d}", "route": "cuda",
                "source": "icikit_torch/csrc/tile_floor.cu",
                "replaces": (
                    "icikit/bench/tile_floor.py:174 (B17, _mxu_kernel)"
                    if key == "tile_mxu" else
                    "icikit/bench/tile_floor.py:199 (B17, _ablate_kernel)"),
                "launches": launches[key], "max_abs_err": errs[name],
                "ms": ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": lib_ms if name == "softmax_ks1" else None})
        timing[d]["bound_ms"], timing[d]["bound_by"] = bound_ms, bound_by
        del q, k, v
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    emit({"phase": "tile_floor_path_checks", "h": h, "seq": seq,
          "dims": list(TILE_DIMS), "tolerance": TILE_TOL,
          "why": "as phase 20, at the path's shapes",
          "checks": checks})
    emit({"phase": "tile_floor_timing_kernels", "card": smi,
          "shape": f"b=1 h={h} s={seq} d={list(TILE_DIMS)} bf16, the full "
                   f"rectangle of {h * (seq // tile) ** 2} {tile} x {tile} "
                   "tiles",
          "launches": "the tile-floor path's, both head dims (tile_ablate "
                      "over its four variants)",
          "library": "softmax_ks1: non-causal scaled_dot_product_attention "
                     "at scale d**-0.5 (softmax attention, the function "
                     "the online softmax computes); mxu and the other "
                     "ablations: none, no PyTorch call computes them",
          "ms": "CUDA events over 3 back-to-back calls (the plain "
                "versions 1), after a warm-up call",
          "max_abs_err": "relative to the largest |plain| entry",
          "by_dim": timing})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"tile-floor kernel disagrees with its plain "
                             f"version at the path's shapes: {bad}")
    return rows


def stack_kernel_checks(torch, dev) -> None:
    """Phase 22: B16's kernels against their plain versions, bit for bit,
    at every slice shape and dtype of the save-stack path's stacks and
    the slices STACK_CHECK_I; a slice off JAX's gate takes the plain copy
    and launches nothing."""
    from icikit_torch.ops import cuda_stack as cst
    from icikit_torch.ops import stack_write as sw

    gen = torch.Generator(device=dev).manual_seed(10)
    n_layers = SAVE_STACK_LAUNCHES["stack_read"]
    checks = []

    def bits(t):
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32)

    for name, (shape, dtype) in {**STACK_SLICES,
                                 "off the gate": STACK_OFF_GATE}.items():
        dt = getattr(torch, dtype)
        stack = torch.randn((n_layers,) + shape, generator=gen,
                            device=dev).to(dt)
        want = stack.clone()
        gated = sw.stack_supported(shape, dt)
        cst.reset_launches()
        same = True
        for i in STACK_CHECK_I:
            x = torch.randn(shape, generator=gen, device=dev)
            sw.stack_write(stack, x, i)
            cst.stack_write_plain(want, x.to(dt), i)
            same = (same and torch.equal(bits(stack), bits(want))
                    and torch.equal(bits(sw.stack_read(stack, i)),
                                    bits(cst.stack_read_plain(want, i))))
        torch.cuda.synchronize()
        n = len(STACK_CHECK_I) if gated else 0
        launched = dict(cst.LAUNCHES)
        checks.append({"stack": name, "slice": list(shape), "dtype": dtype,
                       "on_gate": gated, "launches": launched,
                       "bitwise": same,
                       "ok": same and launched == {"stack_write": n,
                                                   "stack_read": n}})
        del stack, want
    emit({"phase": "stack_kernels", "layers": n_layers,
          "slices": list(STACK_CHECK_I), "tolerance": "bit for bit (a copy)",
          "checks": checks})
    bad = [c for c in checks if not c["ok"]]
    if bad or checks[-1]["on_gate"]:
        raise AssertionError(f"save-stack kernel disagrees with its plain "
                             f"version or routes wrongly: {checks}")


def save_stack_path(torch, dev, bw, smi, default_ms) -> list:
    """Phase 23: the base train step with ``save_stack="pallas"``
    (``SAVE_STACK_ARM``), its launches asserted, held at b = 2
    and float32 against the default and plain arms, then timed beside a
    second run of the default arm; returns B16's rows at the path's
    shapes."""
    from icikit_torch.bench.stream_ab import device_ms, run_copy, run_host
    from icikit_torch.ops import cuda_stack as cst

    t0 = time.perf_counter()
    cell = train_cell(torch, dev)
    rec = train_arm(torch, cell, "save-stack", SAVE_STACK_ARM, smi,
                    phase="save_stack")
    again = train_arm(torch, cell, "default", ARMS["default"])
    emit({"phase": "save_stack_ab", "card": smi,
          "step_ms": {"default (phase 11)": default_ms,
                      "save-stack": rec["step_ms"],
                      "default (again)": again["step_ms"]},
          "spread_ms": {"save-stack": rec["step_ms_spread"],
                        "default (again)": again["step_ms_spread"]},
          "tokens_per_s": {"save-stack": rec["tokens_per_s"],
                           "default (again)": again["tokens_per_s"]},
          "mfu": {"save-stack": rec["mfu"], "default (again)": again["mfu"]},
          "seconds": round(time.perf_counter() - t0, 1)})
    if not (rec["ok"] and again["ok"]):
        raise AssertionError(f"save-stack path disagrees with its plain "
                             f"arms, launches otherwise or does not learn: "
                             f"{rec} {again}")
    del cell
    torch.cuda.empty_cache()

    # B16's kernels at the residual slice, the path's largest, cold: the
    # 12 slices of a (12, ...) stack in rotation (192 MiB, past the 50 MB
    # L2); device time a launch by CUDA events over launches queued
    # behind a sleep kernel, beside copy_ timed the same way
    gen = torch.Generator(device=dev).manual_seed(11)
    shape = STACK_SLICES["residual"][0]
    n_slices = SAVE_STACK_LAUNCHES["stack_read"]
    stack = torch.randn((n_slices,) + shape, generator=gen,
                        device=dev).to(torch.bfloat16)
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    out = torch.empty_like(x)
    nbytes = x.numel() * 2
    launches = rec["launches_per_step"]
    traced = {k: v for k, v in rec["profile"]["by_name"].items()
              if k.startswith("stack_")}

    def rotating(fn):
        it = itertools.cycle(range(n_slices))
        return lambda: fn(next(it))

    rows = []
    for key, kern, plain, lib, check in (
            ("stack_write", lambda i: cst.stack_write(stack, x, i),
             lambda i: cst.stack_write_plain(stack, x, i),
             lambda i: stack[i].copy_(x),
             lambda: float((cst.stack_write(stack.clone(), x, 5)[5].float()
                            - x.float()).abs().max())),
            ("stack_read", lambda i: cst.stack_read(stack, i),
             lambda i: cst.stack_read_plain(stack, i),
             lambda i: out.copy_(stack[i]),
             lambda: float((cst.stack_read(stack, 5).float()
                            - stack[5].float()).abs().max()))):
        rows.append({
            "name": f"{key} (B16)", "route": "cuda",
            "source": "icikit_torch/csrc/stack_write.cu",
            "replaces": ("icikit/ops/stack_write.py:126 (B16, "
                         "_write_kernel)" if key == "stack_write" else
                         "icikit/ops/stack_write.py:158 (B16, _read_kernel)"),
            "launches": launches[key], "max_abs_err": check(),
            "ms": device_ms(rotating(kern), 240, 60.0),
            "plain_ms": device_ms(rotating(plain), 240, 60.0),
            "bound_ms": 2 * nbytes / bw * 1e3, "bound_by": "bytes",
            "library_ms": device_ms(rotating(lib), 240, 60.0)})
    torch.cuda.synchronize()
    del stack, x, out
    torch.cuda.empty_cache()
    host = run_host(gen)
    copy = run_copy()
    emit({"phase": "save_stack_timing_kernels", "card": smi,
          "shape": f"the residual slice {list(shape)} bf16 ({nbytes} "
                   f"bytes) of a ({n_slices}, ...) stack, the slices in "
                   "rotation (cold)",
          "ms": "device time a launch: CUDA events over 240 launches "
                "queued behind a sleep kernel, so the host's call rate "
                "does not show",
          "device_ms_a_launch_in_step_trace": {
              k: v["ms"] / v["count"] for k, v in traced.items()},
          "device_ms_in_step_trace": traced,
          "library": "stack[i].copy_(x) for the write, out.copy_(stack[i]) "
                     "into a preallocated slice for the read, rotating",
          "host_us_a_call": host, "copy_1GiB": copy,
          "launches": "a save-stack step's"})
    return rows


def _least_bytes(family: str, p: int, b: int) -> int:
    """Bytes a collective must move at the least: every rank's input
    read once and its output written once (b bytes a block): root's
    block alone is broadcast's input, root's buffer scatter's and root's
    assembled row gather's output."""
    ins = {"allgather": p * b, "alltoall": p * p * b, "allreduce": p * b,
           "reducescatter": p * p * b, "broadcast": b, "scatter": p * b,
           "gather": p * b, "scan": p * b, "reduce": p * b}[family]
    outs = {"allgather": p * p * b, "alltoall": p * p * b,
            "reducescatter": p * b, "gather": p * b}.get(family, p * b)
    return ins + outs


def _coll_row(rec, bw) -> dict:
    """A harness record with JAX's fields (per rank), the card's
    aggregate rate (p x bus bytes / best time) and the least-bytes
    bound."""
    from icikit_torch.bench.harness import _bus_bytes
    row = json.loads(rec.to_json())
    row["aggregate_GBps"] = (rec.p * _bus_bytes(rec.family, rec.p,
                                                rec.bytes_per_block)
                             / rec.best_s / 1e9)
    row["bound_us"] = _least_bytes(rec.family, rec.p,
                                   rec.bytes_per_block) / bw * 1e6
    return row


def _coll_cases(torch, gen, p):
    """(family, variant, kwargs, operand) for every hand-rolled schedule
    at p ranks, COLL_CHECK_MSIZE elements a block: int32 and float32,
    sum, max and min, the roots COLL_ROOTS, inclusive and exclusive."""
    from icikit_torch.utils.registry import list_algorithms
    m = COLL_CHECK_MSIZE
    shapes = {"allgather": (p, m), "alltoall": (p, p, m),
              "allreduce": (p, m), "reducescatter": (p, p * m),
              "scan": (p, m), "broadcast": (p, m), "scatter": (p, m),
              "gather": (p, m), "reduce": (p, m)}
    for family, shape in shapes.items():
        for dtype in (torch.int32, torch.float32):
            x = (torch.randn(shape, generator=gen).to(dtype)
                 if dtype == torch.float32 else
                 torch.randint(-2**20, 2**20, shape, generator=gen,
                               dtype=dtype))
            kws = [{}]
            if family in ("allreduce", "reducescatter", "scan", "reduce"):
                kws = [{"op": op} for op in ("sum", "max", "min")]
            if family == "scan":
                kws += [dict(k, inclusive=False) for k in kws]
            if family in ("broadcast", "scatter", "gather", "reduce"):
                kws = [dict(k, root=r) for k in kws for r in COLL_ROOTS]
            for alg in list_algorithms(family):
                if alg != "xla":
                    for kw in kws:
                        yield family, alg, kw, x


def allreduce_launches(torch, mesh, x) -> dict:
    """Each allreduce variant's work a call on ``x``, from a
    ``torch.profiler`` trace of COLL_TRACE_CALLS calls after a first
    call (the first trace that kept every device record, of up to
    COLL_TRACE_ATTEMPTS, else the last): the host's enqueue calls (a
    launch, copy or set each; the trace keeps every one), the device
    events where the trace kept them all, and its copies by direction
    (``host_to_device_copies`` must be 0: the transport's index tensors
    are built in the first call). Only a lost kernel record is borne: a
    lost copy's could hide a host-to-device copy, so it fails."""
    from icikit_torch import parallel as tp
    from icikit_torch.utils.registry import list_algorithms
    from icikit_torch.utils.trace import device_activity

    out = {}
    for alg in list_algorithms("allreduce"):
        tp.all_reduce(x, mesh, algorithm=alg)
        torch.cuda.synchronize()
        # a short trace late in a long process can lose device records
        # (utils/trace.summarize): trace again until one is whole
        act = device_activity(lambda: [tp.all_reduce(x, mesh, algorithm=alg)
                                       for _ in range(COLL_TRACE_CALLS)],
                              attempts=COLL_TRACE_ATTEMPTS)
        lost_copies = {k: n for k, n in act["lost_by_call"].items()
                       if not COLL_LAUNCH_CALL.match(k)}
        if lost_copies:
            raise AssertionError(
                f"allreduce {alg}: {COLL_TRACE_ATTEMPTS} traces all lost "
                f"device records, copies or sets among them "
                f"({act['lost_by_call']} of {act['host_enqueue_calls']} "
                f"host calls in the last)")
        whole = not act["lost_device_events"]
        out[alg] = {
            "calls_traced": COLL_TRACE_CALLS,
            "trace_attempts": act["attempts"],
            "host_enqueues_a_call":
                act["host_enqueue_calls"] / COLL_TRACE_CALLS,
            "device_events_a_call": act["device_events"] / COLL_TRACE_CALLS
            if whole else None,
            "trace_lost_device_events": act["lost_by_call"],
            "by_name": {k: v["count"] for k, v in act["by_name"].items()},
            "copies": act["copies"],
            "host_to_device_copies": act["copies"].get("HtoD", 0),
            "busy_ms": act["busy_ms"], "host_wall_ms": act["host_wall_ms"]}
    return out


def allreduce_launches_in_child() -> dict:
    """:func:`allreduce_launches` on float32[COLL_P, 2^20] in a new
    Python process on the card, its record read from its last line: a
    trace late in the long script lost the copies' device records in
    all COLL_TRACE_ATTEMPTS attempts (as phase 26's did)."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys, torch; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke as cs; "
            "from icikit_torch.utils.mesh import make_mesh; "
            "x = torch.randn((cs.COLL_P, cs.COLL_BASELINE_ALLREDUCE), "
            "device='cuda'); "
            "print(json.dumps(cs.allreduce_launches(torch, "
            "make_mesh(cs.COLL_P, device='cuda'), x)))")
    r = subprocess.run([sys.executable, "-c", code, here], cwd=here,
                       capture_output=True, text=True, timeout=600)
    if r.returncode:
        raise AssertionError(f"allreduce trace failed: {r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def collectives_phase(torch, dev, bw, smi) -> None:
    """Phase 24: the collective library on the card (see the module
    docstring)."""
    from icikit_torch import parallel as tp
    from icikit_torch.bench.harness import (COLLECTIVES, FAMILIES,
                                            REFERENCE_SWEEP,
                                            REFERENCE_SWEEP_PERSONALIZED,
                                            sweep_family)
    from icikit_torch.utils.mesh import make_mesh
    from icikit_torch.utils.registry import list_algorithms

    t0 = time.perf_counter()
    bad = []

    def check(recs, want_algs, what):
        got = {r.algorithm for r in recs}
        if got != set(want_algs) or not all(r.verified for r in recs):
            bad.append({"what": what, "variants": sorted(got),
                        "unverified": [(r.algorithm, r.msize) for r in recs
                                       if not r.verified]})

    # the reference sweep in int32, every variant at p = 8; at p = 6 the
    # variants that take any p
    odd = {}
    for p in (COLL_P, COLL_P_ODD):
        mesh = make_mesh(p, device=dev)
        for family in FAMILIES:
            sizes = (REFERENCE_SWEEP_PERSONALIZED if family == "alltoall"
                     else REFERENCE_SWEEP)
            recs = sweep_family(mesh, family, sizes=sizes,
                                dtype=torch.int32)
            algs = [a for a in list_algorithms(family)
                    if p == COLL_P or (family, a) not in COLL_POW2_ONLY]
            if p == COLL_P_ODD:
                odd[family] = algs
            check(recs, algs, f"reference sweep {family} p={p}")
            emit({"phase": "collectives", "part": "reference_sweep",
                  "family": family, "p": p, "dtype": "int32",
                  "records": [_coll_row(r, bw) for r in recs]})
    # BASELINE.json's configurations, float32 at p = 8
    mesh = make_mesh(COLL_P, device=dev)
    recs = sweep_family(mesh, "allreduce", sizes=(COLL_BASELINE_ALLREDUCE,),
                        dtype=torch.float32)
    check(recs, list_algorithms("allreduce"), "baseline allreduce")
    launches = allreduce_launches_in_child()
    for alg, n in launches.items():
        if n["host_to_device_copies"]:
            bad.append({"what": "host-to-device copy in a repeated call",
                        "variant": alg, **n})
    emit({"phase": "collectives", "part": "baseline_allreduce",
          "config": "allreduce float32[2^20] a rank, p = 8",
          "records": [_coll_row(r, bw) for r in recs],
          "launches_a_call": launches, "card": smi})
    for family in ("broadcast", "scatter", "gather"):
        recs = sweep_family(mesh, family, sizes=COLL_BASELINE_SWEEP,
                            dtype=torch.float32)
        check(recs, list_algorithms(family), f"baseline {family}")
        emit({"phase": "collectives", "part": "baseline_sweep",
              "config": "broadcast + scatter/gather 1KB-64MB, float32",
              "family": family, "records": [_coll_row(r, bw) for r in recs],
              "card": smi})
        torch.cuda.empty_cache()
    # each hand-rolled schedule on the card against the same schedule
    # on a CPU RankMesh, bit for bit
    cpu = make_mesh(COLL_P, device="cpu")
    gen = torch.Generator().manual_seed(24)
    n_same = 0
    for family, alg, kw, x in _coll_cases(torch, gen, COLL_P):
        want = COLLECTIVES[family](x, cpu, algorithm=alg, **kw)
        got = COLLECTIVES[family](x.to(dev), mesh, algorithm=alg,
                                  **kw).cpu()
        if got.shape == want.shape and torch.equal(
                got.contiguous().view(torch.int32),
                want.contiguous().view(torch.int32)):
            n_same += 1
        else:
            bad.append({"what": "card vs cpu", "family": family,
                        "variant": alg, **kw, "dtype": str(x.dtype)})
    for alg in ("wraparound", "naive", "ecube", "hypercube"):
        counts = torch.randint(0, 9, (COLL_P, COLL_P), generator=gen,
                               dtype=torch.int32)
        data = torch.randint(0, 1000, (COLL_P, 64), generator=gen,
                             dtype=torch.int32)
        outs = [tp.all_to_all_v(data.to(d), counts.to(d), m, capacity=8,
                                algorithm=alg)
                for d, m in (("cpu", cpu), (dev, mesh))]
        same = all(torch.equal(a, b.cpu()) for a, b in zip(*outs))
        n_same += same
        if not same:
            bad.append({"what": "card vs cpu", "family": "alltoallv",
                        "variant": alg})
    for largest in (True, False):
        data = torch.randint(0, 50, (COLL_P, 4096), generator=gen,
                             dtype=torch.int32)
        outs = [tp.top_k_dist(data.to(d), m, 16, largest=largest)
                + tp.allreduce_loc(data.to(d), m,
                                   op="maxloc" if largest else "minloc")
                for d, m in (("cpu", cpu), (dev, mesh))]
        same = all(torch.equal(a, b.cpu()) for a, b in zip(*outs))
        n_same += same
        if not same:
            bad.append({"what": "card vs cpu", "family": "reduceloc",
                        "largest": largest})
    seconds = time.perf_counter() - t0
    emit({"phase": "collectives", "part": "summary",
          "card_equals_cpu_bitwise": n_same,
          "check_msize": COLL_CHECK_MSIZE, "p6_variants": odd,
          "bound": "every rank's input read once and output written once "
                   f"at {bw / 1e12:.2f} TB/s", "card": smi,
          "seconds": round(seconds, 1), "failures": bad})
    if bad:
        raise AssertionError(f"collectives failed: {bad}")


def _study_row(r) -> dict:
    return {"algorithm": r.algorithm, "p": r.p, "n": r.n, "dtype": r.dtype,
            "dist": r.distribution, "errors": r.errors,
            "equal_to_torch_sort": r.matches_torch_sort,
            "launches": r.launches, "retries": r.retries,
            "timed_runs": r.timed_runs, "timed_retries": r.timed_retries,
            "protocol": r.protocol, "median_ms": r.mean_s * 1e3,
            "spread_ms": [r.min_s * 1e3, r.max_s * 1e3],
            "windows": r.windows, "discarded": r.discarded,
            "keys_per_s": r.keys_per_s,
            "torch_sort_ms": (None if r.torch_sort_s is None
                              else r.torch_sort_s * 1e3),
            "floor_ms": None if r.floor_s is None else r.floor_s * 1e3}


def sort_stages(torch, mesh, keys) -> dict:
    """The sample sort's and quicksort's stages at the study's shapes,
    each timed apart by events (the stages of ``sample_sort_shard`` and
    ``hypercube_quicksort_shard`` called one by one), beside each whole
    sort."""
    from icikit_torch.models.sort.common import (ragged_all_to_all,
                                                 rebalance_sorted,
                                                 unpack_rows)
    from icikit_torch.models.sort.quicksort import (
        DEFAULT_CAP_FACTOR as Q_CAP, hypercube_quicksort_blocks)
    from icikit_torch.models.sort.sample import (DEFAULT_CAP_FACTOR,
                                                 bucket_route,
                                                 sample_sort_blocks)
    from icikit_torch.ops import cuda_sort as cs
    from icikit_torch.utils.timing import cuda_time_ms

    p = mesh.p
    x2d = keys.view(p, -1)
    n_loc = x2d.shape[1]
    cap = int(DEFAULT_CAP_FACTOR * n_loc / p)
    a = cs.local_sort(x2d)
    st, ct = bucket_route(a, p, "allgather")
    rows, rc, _ = ragged_all_to_all(a, st, ct, cap, p)
    flat, valid = unpack_rows(rows, rc)
    fs = cs.local_sort(flat)
    qcap = int(Q_CAP * n_loc)
    qbuf = torch.cat([x2d, x2d[:, : qcap - n_loc]], 1)
    out = {
        "sample": {
            "first local sort": cuda_time_ms(lambda: cs.local_sort(x2d),
                                             iters=5),
            "bucket route (allgather splitters)": cuda_time_ms(
                lambda: bucket_route(a, p, "allgather"), iters=5),
            "exchange (pack, alltoall, counts)": cuda_time_ms(
                lambda: ragged_all_to_all(a, st, ct, cap, p), iters=5),
            "unpack": cuda_time_ms(lambda: unpack_rows(rows, rc), iters=5),
            f"post-exchange sort ({p} x {flat.shape[1]} keys)":
                cuda_time_ms(lambda: cs.local_sort(flat), iters=5),
            "rebalance": cuda_time_ms(
                lambda: rebalance_sorted(fs, valid, n_loc, p), iters=5),
            "whole sort": cuda_time_ms(
                lambda: sample_sort_blocks(x2d, mesh), iters=5)},
        "quicksort": {
            f"one local sort of the {p} x {qcap} buffers (x "
            f"{cs.ilog2(p) + 1} a sort)": cuda_time_ms(
                lambda: cs.local_sort(qbuf), iters=5),
            "whole sort": cuda_time_ms(
                lambda: hypercube_quicksort_blocks(x2d, mesh), iters=5)},
        "first local sort, a loop over the rows": cuda_time_ms(
            lambda: [cs.local_sort(r) for r in x2d], iters=5)}
    out["sample"]["sum of stages"] = sum(
        v for k, v in out["sample"].items() if k != "whole sort")
    return out


def sort_study_phase(torch, dev, smi) -> dict:
    """Phase 25: the four-sort study (see the module docstring). Returns
    each algorithm's kernel launches in one sort of the uniform 2^24
    int32 keys at p = 8."""
    from icikit_torch.bench.sort import failed, study_keys, sweep_sorts
    from icikit_torch.models.sort import (SORT_ALGORITHMS, argsort_dist,
                                          sort, sort_kv)
    from icikit_torch.models.sort.common import RETRIES, reset_retries
    from icikit_torch.ops import cuda_sort as cs
    from icikit_torch.utils.mesh import make_mesh
    from icikit_torch.utils.timing import cuda_time_ms

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    bad = []
    mesh = make_mesh(STUDY_P, device=dev)

    def check(recs, what, algs=SORT_ALGORITHMS):
        if [r.algorithm for r in recs] != list(algs):
            bad.append({"what": what, "algorithms": [r.algorithm
                                                     for r in recs]})
        for r in recs:
            if failed(r) or not (r.launches["net"] and r.launches["cross"]):
                bad.append({"what": what, **_study_row(r)})

    timed = []
    for odd in (False, True):
        recs = sweep_sorts(mesh, (STUDY_N,), dtype="int32", odd_dist=odd,
                           runs=2, warmup=1, windows=3)
        check(recs, f"2^24 int32 p=8 odd_dist={odd}")
        timed += recs
    emit({"phase": "sort_study", "part": "timed",
          "config": "2^24 int32 keys, p = 8 (BASELINE.json)", "card": smi,
          "records": [_study_row(r) for r in timed]})
    checked = []
    for odd in (False, True):
        recs = sweep_sorts(make_mesh(1, device=dev), (STUDY_N,),
                           dtype="int32", odd_dist=odd, windows=0)
        check(recs, f"2^24 int32 p=1 odd_dist={odd}")
        checked += recs
    recs = sweep_sorts(mesh, (STUDY_FLOAT_N,), dtype="float32",
                       odd_dist=True, windows=0)
    check(recs, "50M float32 odd_dist p=8")
    checked += recs
    recs = sweep_sorts(mesh, (STUDY_FLOAT_N,), dtype="bfloat16",
                       odd_dist=True, windows=0,
                       algorithms=[STUDY_BF16_ALG])
    check(recs, "50M bfloat16 odd_dist p=8", [STUDY_BF16_ALG])
    checked += recs
    emit({"phase": "sort_study", "part": "checked",
          "records": [_study_row(r) for r in checked]})
    # the forced retries, on odd_dist keys
    keys = study_keys(STUDY_N, torch.int32, True, device=dev)
    oracle = torch.sort(keys).values
    forced = []
    for alg, factor in STUDY_RETRY:
        reset_retries()
        cs.reset_launches()
        out = sort(keys, mesh, algorithm=alg, cap_factor=factor)
        torch.cuda.synchronize()
        rec = {"algorithm": alg, "cap_factor": factor,
               "retries": dict(RETRIES), "launches": dict(cs.LAUNCHES),
               "equal_to_torch_sort": bool(torch.equal(out, oracle)),
               "ms": cuda_time_ms(lambda: sort(keys, mesh, algorithm=alg,
                                               cap_factor=factor),
                                  iters=3, warmup=1)}
        forced.append(rec)
        kind = "quicksort" if alg == "quicksort" else "sample"
        if not rec["retries"][kind] or not rec["equal_to_torch_sort"]:
            bad.append({"what": "forced retry", **rec})
    del out, oracle
    # the KV sort and argsort on uniform keys with int32 values
    keys = study_keys(STUDY_N, torch.int32, False, device=dev)
    vals = torch.arange(STUDY_N, dtype=torch.int32, device=dev)
    order = torch.argsort(keys, stable=True)
    sk, sv = sort_kv(keys, vals, mesh)
    perm = argsort_dist(keys, mesh)
    kv = {"n": STUDY_N, "p": STUDY_P,
          "keys_sorted": bool(torch.equal(sk, keys[order])),
          "values_follow_keys": bool(torch.equal(sv.long(), order)),
          "argsort_equals_torch": bool(torch.equal(perm.long(), order)),
          "sort_kv_ms": cuda_time_ms(lambda: sort_kv(keys, vals, mesh),
                                     iters=3, warmup=1),
          "torch_sort_stable_ms": cuda_time_ms(
              lambda: torch.sort(keys, stable=True), iters=3, warmup=1)}
    del sk, sv, perm, order, vals
    if not (kv["keys_sorted"] and kv["values_follow_keys"]
            and kv["argsort_equals_torch"]):
        bad.append({"what": "sort_kv", **kv})
    stages = sort_stages(torch, mesh, keys)
    del keys
    emit({"phase": "sort_study", "part": "summary", "forced_retries": forced,
          "sort_kv": kv, "stages_ms": stages, "card": smi,
          "seconds": round(time.perf_counter() - t0, 1), "failures": bad})
    if bad:
        raise AssertionError(f"sort study failed: {bad}")
    torch.cuda.empty_cache()
    return {r.algorithm: r.launches for r in timed
            if r.distribution == "uniform"}


def _turns_ms(torch, fa, fb) -> tuple:
    """Median host ms a call of ``fa`` and of ``fb``, each call ending
    in a synchronise, over CHECKED_WINDOWS windows of CHECKED_CALLS
    calls taken in turns (a, b, b, a, ...)."""
    ms = {0: [], 1: []}
    for fn in (fa, fb):
        fn()
        torch.cuda.synchronize()
    for w in range(CHECKED_WINDOWS):
        for k in ((0, 1) if w % 2 == 0 else (1, 0)):
            fn = (fa, fb)[k]
            t0 = time.perf_counter()
            for _ in range(CHECKED_CALLS):
                fn()
                torch.cuda.synchronize()
            ms[k].append((time.perf_counter() - t0) * 1e3 / CHECKED_CALLS)
    med = [sorted(v)[len(v) // 2] for v in (ms[0], ms[1])]
    return med[0], med[1], ms[0], ms[1]


def checked_trace(torch, dev) -> dict:
    """``torch.profiler``'s view of COLL_TRACE_CALLS clean checked ring
    allreduces of float32[2^20] at p = 8 after a first call: copies by
    direction, copies or sets whose device record the trace lost, host
    enqueues and checksum launches a call."""
    from icikit_torch import parallel as tp
    from icikit_torch.utils.mesh import make_mesh
    from icikit_torch.utils.trace import device_activity

    mesh = make_mesh(COLL_P, device=dev)
    x = torch.randn((COLL_P, COLL_BASELINE_ALLREDUCE), device=dev)
    tp.all_reduce(x, mesh, algorithm="ring", checked=True)
    torch.cuda.synchronize()
    act = device_activity(
        lambda: [tp.all_reduce(x, mesh, algorithm="ring", checked=True)
                 for _ in range(COLL_TRACE_CALLS)],
        attempts=COLL_TRACE_ATTEMPTS)
    return {"calls": COLL_TRACE_CALLS, "attempts": act["attempts"],
            "copies": act["copies"],
            "lost_copies": {k: n for k, n in act["lost_by_call"].items()
                            if not COLL_LAUNCH_CALL.match(k)},
            "host_enqueues_a_call":
                act["host_enqueue_calls"] / COLL_TRACE_CALLS,
            "checksum_launches_a_call":
                act["by_name"].get("segment_checksum_kernel",
                                   {}).get("count", 0) / COLL_TRACE_CALLS,
            "busy_ms": act["busy_ms"], "host_wall_ms": act["host_wall_ms"]}


def checked_trace_in_child() -> dict:
    """:func:`checked_trace` in a new Python process (the kernels are
    already built), its record read from its last line."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys, torch; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; "
            "print(json.dumps(chip_smoke.checked_trace(torch, 'cuda')))")
    r = subprocess.run([sys.executable, "-c", code, here], cwd=here,
                       capture_output=True, text=True, timeout=300)
    if r.returncode:
        raise AssertionError(f"checked trace failed: {r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def integrity_phase(torch, dev, bw, smi) -> dict:
    """Phase 26: the checked transport on the card (see the module
    docstring). Returns the checksum kernel's row of the kernels line."""
    from icikit_torch import chaos
    from icikit_torch import parallel as tp
    from icikit_torch.bench.harness import COLLECTIVES
    from icikit_torch.models.sort import check_sort, sort
    from icikit_torch.models.sort.bitonic import exchange_steps
    from icikit_torch.ops import cuda_integrity as ci
    from icikit_torch.ops import cuda_sort as cs
    from icikit_torch.parallel import integrity
    from icikit_torch.utils.mesh import make_mesh
    from icikit_torch.utils.registry import list_algorithms
    from icikit_torch.utils.timing import cuda_time_ms

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    bad = []
    gen = torch.Generator(device=dev).manual_seed(26)

    def rand_rows(p, n, dtype, width, offset=0):
        """(p, n) random bits of ``dtype``, starting ``offset`` bytes into
        a fresh buffer (0/1 bytes for bool)."""
        buf = torch.randint(0, 2 if dtype == torch.bool else 256,
                            (p * n * width + offset,), generator=gen,
                            dtype=torch.uint8, device=dev)
        return buf[offset:].view(dtype).view(p, n)

    # the kernel against its plain version, bit for bit
    checks = []
    views = ((torch.uint8, 1), (torch.bool, 1), (torch.int16, 2),
             (torch.bfloat16, 2), (torch.int32, 4), (torch.float32, 4),
             (torch.int64, 8))
    for dtype, width in views:
        for p, n in ([(CHECKSUM_P, n) for n in CHECKSUM_NS]
                     + [CHECKSUM_SHAPE]):
            for offset in (0, width):   # a 16-byte base, and one off it
                x = rand_rows(p, n, dtype, width, offset)
                got = ci.segment_checksum(x)
                want = ci.segment_checksum(x, plain=True)
                checks.append({"dtype": str(dtype), "p": p, "n": n,
                               "aligned": x.data_ptr() % 16 == 0,
                               "ok": bool(torch.equal(got, want))})
    torch.cuda.synchronize()
    if not all(c["ok"] for c in checks):
        bad.append({"what": "checksum kernel vs plain",
                    "failed": [c for c in checks if not c["ok"]]})
    emit({"phase": "integrity", "part": "checksum_kernel",
          "tolerance": "exact (bitwise)", "checks": checks})

    # every checked family and hand-rolled variant: clean equal to the
    # unchecked output, one scheduled drill detected and recovered
    m = COLL_CHECK_MSIZE
    shapes = {"allgather": lambda p: (p, m), "alltoall": lambda p: (p, p, m),
              "allreduce": lambda p: (p, m),
              "reducescatter": lambda p: (p, p * m),
              "scan": lambda p: (p, m)}
    fams = []
    for p in (COLL_P, COLL_P_ODD):
        mesh = make_mesh(p, device=dev)
        for family in integrity.CHECKED_FAMILIES:
            x = torch.randn(shapes[family](p), generator=gen, device=dev)
            for alg in list_algorithms(family):
                if alg == "xla" or (p == COLL_P_ODD
                                    and (family, alg) in COLL_POW2_ONLY):
                    continue
                fn = COLLECTIVES[family]
                base = fn(x, mesh, algorithm=alg)
                clean = fn(x, mesh, algorithm=alg, checked=True)
                integrity.reset_stats()
                plan = chaos.FaultPlan(
                    seed=p + len(alg),
                    schedule={f"corrupt:collective.{family}": (0,)})
                with chaos.inject(plan):
                    healed = fn(x, mesh, algorithm=alg, checked=True)
                st = integrity.stats()
                rec = {"family": family, "variant": alg, "p": p,
                       "clean_equal": bool(torch.equal(
                           clean.view(torch.int32), base.view(torch.int32))),
                       "drill_equal": bool(torch.equal(
                           healed.view(torch.int32),
                           base.view(torch.int32))),
                       "detected": st["detected"],
                       "recoveries": st["recoveries"],
                       "rank_step": [st["last"].get("devices"),
                                     st["last"].get("steps")]}
                fams.append(rec)
                if not (rec["clean_equal"] and rec["drill_equal"]
                        and rec["detected"] == 1 and rec["recoveries"] == 1
                        and plan.fired("corrupt") == 1):
                    bad.append({"what": "checked collective", **rec})
    emit({"phase": "integrity", "part": "checked_collectives",
          "msize": m, "records": fams})

    # the checked sort: 2^24 int32 keys at p = 8, clean and under a drill
    mesh = make_mesh(STUDY_P, device=dev)
    keys = torch.randint(-2**31, 2**31 - 1, (STUDY_N,), generator=gen,
                         dtype=torch.int32, device=dev)
    base = sort(keys, mesh)
    torch.cuda.synchronize()
    ci.reset_launches()
    cs.reset_launches()
    integrity.reset_stats()
    out = sort(keys, mesh, checked=True)
    torch.cuda.synchronize()
    launches = {**ci.LAUNCHES, **cs.LAUNCHES}
    inversions = check_sort(out.reshape(STUDY_P, -1), mesh)
    plan = chaos.FaultPlan(
        seed=26, schedule={"corrupt:sort.bitonic.exchange": (0,)})
    with chaos.inject(plan):
        healed = sort(keys, mesh, checked=True)
    st = integrity.stats()
    srt = {"n": STUDY_N, "p": STUDY_P, "launches_a_checked_sort": launches,
           "exchanges": exchange_steps(STUDY_P),
           "equal_to_unchecked": bool(torch.equal(out, base)),
           "inversions": inversions,
           "drill_equal": bool(torch.equal(healed, base)),
           "drill": {k: st[k] for k in ("detected", "retries",
                                        "recoveries")},
           "drill_rank_step": [st["last"].get("devices"),
                               st["last"].get("steps")]}
    if not (srt["equal_to_unchecked"] and inversions == 0
            and srt["drill_equal"] and st["detected"] == 1
            and st["recoveries"] == 1
            and launches["segment_checksum"] == 2 * srt["exchanges"]
            and launches["net"] and launches["cross"]):
        bad.append({"what": "checked sort", **srt})
    del out, healed

    # the kernel at the checked sort's block, beside its bound and plain
    x = torch.randint(-2**31, 2**31 - 1, CHECKSUM_SHAPE, generator=gen,
                      dtype=torch.int32, device=dev)
    k_ms = cuda_time_ms(lambda: ci.segment_checksum(x), iters=20)
    plain_ms = cuda_time_ms(lambda: ci.segment_checksum(x, plain=True),
                            iters=3, warmup=1)
    err = int((ci.segment_checksum(x).long()
               - ci.segment_checksum(x, plain=True).long()).abs().max())
    k_bound = x.numel() * x.element_size() / bw * 1e3
    del x

    # checked against unchecked, in turns
    overhead = []
    xr = torch.randn((COLL_P, COLL_BASELINE_ALLREDUCE), generator=gen,
                     device=dev)
    cmesh = make_mesh(COLL_P, device=dev)
    for alg in CHECKED_ALGS:
        u, c, us, cs_ = _turns_ms(
            torch, lambda: tp.all_reduce(xr, cmesh, algorithm=alg),
            lambda: tp.all_reduce(xr, cmesh, algorithm=alg, checked=True))
        overhead.append({"what": f"allreduce {alg} float32[2^20] p=8",
                         "unchecked_ms": u, "checked_ms": c,
                         "ratio": c / u, "windows_ms": [us, cs_]})
    u, c, us, cs_ = _turns_ms(torch, lambda: sort(keys, mesh),
                              lambda: sort(keys, mesh, checked=True))
    overhead.append({"what": "sort bitonic 2^24 int32 p=8 uniform",
                     "unchecked_ms": u, "checked_ms": c, "ratio": c / u,
                     "added_ms": c - u, "windows_ms": [us, cs_]})
    del keys, base

    # a trace of clean checked ring allreduces: no host-to-device copy,
    # one device-to-host copy (the verdict) a call; taken in a fresh
    # process, since a trace late in a long one loses device records
    trace = checked_trace_in_child()
    if (trace["lost_copies"] or trace["copies"].get("HtoD", 0)
            or trace["copies"].get("DtoH", 0) != COLL_TRACE_CALLS):
        bad.append({"what": "checked allreduce trace", **trace})
    del xr
    emit({"phase": "integrity", "part": "summary", "checked_sort": srt,
          "checksum_kernel": {"shape": list(CHECKSUM_SHAPE),
                              "dtype": "int32", "ms": k_ms,
                              "plain_ms": plain_ms, "bound_ms": k_bound,
                              "max_abs_err": err},
          "checked_vs_unchecked": overhead, "trace": trace, "card": smi,
          "seconds": round(time.perf_counter() - t0, 1), "failures": bad})
    if bad:
        raise AssertionError(f"checked transport failed: {bad}")
    torch.cuda.empty_cache()
    return {"name": "segment_checksum_kernel", "route": "cuda",
            "source": "icikit_torch/csrc/integrity.cu",
            "replaces": "icikit/parallel/transport.py:124 (no pallas_call: "
                        "XLA fuses the fold into the exchange)",
            "launches": launches["segment_checksum"], "max_abs_err": err,
            "ms": k_ms, "plain_ms": plain_ms, "bound_ms": k_bound,
            "bound_by": "bytes", "library_ms": None,
            "library": "none (torch has no XOR reduction)",
            "launches_on": "sort(checked=True) of 2^24 int32 keys, p = 8"}


def _same_outputs(torch, a, b) -> bool:
    """Five solve outputs equal, dtypes included."""
    return all(x.dtype == y.dtype and bool(torch.equal(x, y))
               for x, y in zip(a, b))


def _host_arrays(out) -> tuple:
    return tuple(o.cpu().numpy() for o in out)


def _dfs_bounds(steps) -> dict:
    """I2's two bounds in ms for one batch's step counts (numpy)."""
    thr = float(steps.astype("int64").sum()) * DFS_STEP_OPS / VECTOR_OPS
    crit = float(steps.max()) * DFS_STEP_CHAIN * DEP_CYCLES / SM_CLOCK_HZ
    sass = float(steps.max()) * DFS_SASS_CHAIN * DEP_CYCLES / SM_CLOCK_HZ
    return {"throughput_ms": thr * 1e3, "critical_path_ms": crit * 1e3,
            "critical_path_sass_ms": sass * 1e3,
            "bound_ms": max(thr, crit) * 1e3,
            "bound_kind": "critical path" if crit >= thr else "throughput"}


def northstar_quick_in_child() -> dict:
    """``python -m icikit_torch.bench.northstar --quick`` in a new
    process on the card: its exit code and the checks it printed."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "icikit_torch.bench.northstar",
                        "--quick"], cwd=here, env=env, capture_output=True,
                       text=True, timeout=900)
    checks = {}
    dlb = []
    for line in r.stdout.splitlines():
        word, _, name = line.partition(" ")
        if word in ("PASS", "FAIL") and name and " " not in name:
            checks[name] = word == "PASS"
        elif line.startswith("| ") and line.count("|") == 6 \
                and line.split("|")[1].strip() in ("easy", "hard",
                                                   "skewed"):
            dlb.append([c.strip() for c in line.split("|")[1:-1]])
    return {"rc": r.returncode, "checks": checks, "dlb_rows": dlb,
            "seconds": round(time.perf_counter() - t0, 1),
            "stderr_tail": r.stderr[-1500:] if r.returncode else ""}


def solitaire_phase(torch, dev, smi) -> dict:
    """Phase 27: the load-balancing study on the card (see the module
    docstring). Returns I2's row of the kernels line."""
    import warnings

    import numpy as np

    from icikit_torch import chaos, native
    from icikit_torch.bench.solitaire_ab import sm_clock
    from icikit_torch.models.solitaire.dataset import (
        generate_dataset, generate_skewed_dataset)
    from icikit_torch.models.solitaire.game import (BoardBatch, solve_batch,
                                                    solve_batch_plain)
    from icikit_torch.models.solitaire.scheduler import (solve_dynamic,
                                                         solve_host,
                                                         solve_static)
    from icikit_torch.ops import _build
    from icikit_torch.ops import cuda_solitaire as cso
    from icikit_torch.utils.timing import cuda_time_ms

    t0 = time.perf_counter()
    bad = []

    # the native runtime, from the checkout's sources
    if not native.available():
        raise AssertionError(f"native runtime: {native.build_error()}")
    r, loc, shm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _build.check(_build.load("solitaire").icikit_solitaire_regs(
        0, ctypes.byref(r), ctypes.byref(loc), ctypes.byref(shm)),
        "kernel attributes")
    emit({"phase": "solitaire", "part": "build",
          "native_library": native._LIB_PATH.split("icikit_torch/")[-1],
          "solve_dfs_kernel": {"registers": r.value,
                               "local_bytes": loc.value,
                               "shared_bytes": shm.value}})

    def on_card(batch):
        return (cso.as_u32(torch.from_numpy(batch.pegs.view(np.int32))
                           .to(dev)),
                cso.as_u32(torch.from_numpy(batch.playable.view(np.int32))
                           .to(dev)))

    # I2 against its plain version, bit for bit, at a small budget
    checks = []
    cases = [(f"{g} {n}", generate_dataset(n, g, seed=0), DFS_CHECK_STEPS)
             for g, n in DFS_CHECK_SETS]
    edge = BoardBatch.from_strings(list(DFS_EDGE_BOARDS))
    cases += [("edge boards", edge, ms) for ms in DFS_EDGE_STEPS]
    plain_ms = kernel_small_ms = None
    for what, batch, ms in cases:
        pg, pl = on_card(batch)
        got = solve_batch(pg, pl, ms)
        torch.cuda.synchronize()
        tp = time.perf_counter()
        want = solve_batch_plain(pg, pl, ms)
        torch.cuda.synchronize()
        if plain_ms is None:
            plain_ms = (time.perf_counter() - tp) * 1e3
            kernel_small_ms = cuda_time_ms(lambda: solve_batch(pg, pl, ms),
                                           iters=5, warmup=1)
            plain_at = f"{what} boards, max_steps {ms}"
        ok = _same_outputs(torch, got, want)
        checks.append({"what": what, "max_steps": ms, "ok": ok,
                       "status_counts": np.bincount(
                           got[4].cpu().numpy(), minlength=4).tolist()})
    if not all(c["ok"] for c in checks):
        bad.append({"what": "solve_dfs vs plain",
                    "failed": [c for c in checks if not c["ok"]]})
    emit({"phase": "solitaire", "part": "kernel_vs_plain",
          "tolerance": "exact (bitwise, all five outputs)",
          "checks": checks})

    # full size: I2 against the native host solver
    full = {}
    for grade, n in DFS_FULL:
        batch = generate_dataset(n, grade, seed=0)
        host = solve_host(batch, max_steps=DFS_MAX_STEPS)
        pg, pl = on_card(batch)
        card = _host_arrays(solve_batch(pg, pl, DFS_MAX_STEPS))
        same = {k: bool(np.array_equal(card[i], host_v))
                for k, i, host_v in (("solved", 0, host.solved),
                                     ("n_moves", 1, host.n_moves),
                                     ("moves", 2, host.moves),
                                     ("steps", 3, host.steps),
                                     ("status", 4, host.status))}
        err = int(np.abs(card[3].astype(np.int64) - host.steps).max())
        full[grade] = {"batch": batch, "pg": pg, "pl": pl, "card": card,
                       "host": host, "same": same, "err": err}
        if not all(same.values()):
            bad.append({"what": f"solve_dfs vs host, {grade}", **same})

    # the main path: both schedulers, DFS_WORKERS streams of the card
    workers = [dev] * DFS_WORKERS
    n_sk, frac, sk_chunk, sk_seed = DFS_SKEW
    skewed = generate_skewed_dataset(n_sk, seed=sk_seed, hard_fraction=frac)
    sk_host = solve_host(skewed, max_steps=DFS_MAX_STEPS)
    runs = []
    torch.cuda.synchronize()
    cso.reset_launches()
    t_main = time.perf_counter()
    reports = {}
    for name, batch, host, chunk in (
            [(g, full[g]["batch"], full[g]["host"], 8) for g, _ in DFS_FULL]
            + [("skewed", skewed, sk_host, sk_chunk)]):
        st = solve_static(batch, devices=workers, max_steps=DFS_MAX_STEPS)
        dy = solve_dynamic(batch, devices=workers, chunk_size=chunk,
                           max_steps=DFS_MAX_STEPS)
        reports[name] = (st, dy)
        for rep in (st, dy):
            rec = {"set": name, "strategy": rep.strategy,
                   "boards": len(batch), "chunk": rep.chunk_size,
                   "n_solutions": rep.n_solutions,
                   "host_solutions": host.n_solutions,
                   "equal_to_host": bool(
                       np.array_equal(rep.solved, host.solved)
                       and np.array_equal(rep.steps, host.steps)
                       and np.array_equal(rep.moves, host.moves)),
                   "wall_s": rep.wall_s, "pulls": rep.n_pulls,
                   "per_worker_games": rep.per_worker_games,
                   "per_worker_steps": rep.per_worker_steps,
                   "imbalance": rep.imbalance}
            runs.append(rec)
            if not rec["equal_to_host"]:
                bad.append({"what": "scheduler vs host",
                            **{k: rec[k] for k in ("set", "strategy")}})
    main_s = time.perf_counter() - t_main
    launches = cso.LAUNCHES["solve_dfs"]
    if launches == 0:
        bad.append({"what": "the study launched no solve_dfs"})
    emit({"phase": "solitaire", "part": "schedulers", "workers": DFS_WORKERS,
          "max_steps": DFS_MAX_STEPS, "runs": runs,
          "solve_dfs_launches": launches, "seconds": main_s})

    # a healed drill: worker 1 dies at its first pull
    clean = reports["skewed"][1]
    plan = chaos.FaultPlan(schedule={"die:solitaire.worker.1": (0,)})
    with warnings.catch_warnings(record=True) as caught, chaos.inject(plan):
        warnings.simplefilter("always")
        healed = solve_dynamic(skewed, devices=workers, chunk_size=sk_chunk,
                               max_steps=DFS_MAX_STEPS)
    drill = {"n_deaths": healed.n_deaths,
             "worker_deaths": healed.worker_deaths,
             "n_reissues": healed.n_reissues,
             "warned": any("worker 1" in str(w.message) for w in caught),
             "equal_to_clean": all(
                 np.array_equal(getattr(healed, k), getattr(clean, k))
                 for k in ("solved", "n_moves", "moves", "steps",
                           "status")),
             "per_worker_games": healed.per_worker_games}
    if not (drill["n_deaths"] == 1 and drill["worker_deaths"] == [1]
            and drill["warned"] and drill["equal_to_clean"]):
        bad.append({"what": "dynamic drill", **drill})
    emit({"phase": "solitaire", "part": "drill", **drill})

    # I2 timed at each full-size batch, beside its bounds and the host
    timed = {}
    for grade, n in DFS_FULL:
        f = full[grade]
        pg, pl = f["pg"], f["pl"]

        def call(pg=pg, pl=pl):
            return solve_batch(pg, pl, DFS_MAX_STEPS)

        call()
        ms = sorted(cuda_time_ms(call, iters=DFS_ITERS, warmup=0)
                    for _ in range(DFS_WINDOWS))
        steps = f["card"][3]
        timed[grade] = {"boards": n, "ms": ms[len(ms) // 2],
                        "windows_ms": ms, **_dfs_bounds(steps),
                        "sum_steps": int(steps.astype(np.int64).sum()),
                        "max_steps_taken": int(steps.max()),
                        "at_the_cap": int((steps >= DFS_MAX_STEPS).sum()),
                        "solved": int(f["card"][0].sum()),
                        "host_s": f["host"].wall_s,
                        "host_threads": len(f["host"].per_worker_steps)}
    emit({"phase": "solitaire", "part": "timing", "max_steps": DFS_MAX_STEPS,
          "batches": timed, "plain_ms": plain_ms,
          "kernel_ms_at_plain_budget": kernel_small_ms, "plain_at": plain_at,
          "card": smi})

    # a step's cost: one capped lane alone, then a warp of capped lanes
    hard = full["hard"]
    capped = np.flatnonzero(hard["host"].steps >= DFS_MAX_STEPS)
    probes = {}
    for name, idx in (("lone lane", capped[:1]), ("full warp",
                                                  capped[:32])):
        pg, pl = on_card(hard["batch"][idx])

        def call(pg=pg, pl=pl):
            return solve_batch(pg, pl, DFS_MAX_STEPS)

        got = _host_arrays(call())
        h = hard["host"]
        want = [x[idx] for x in (h.solved, h.n_moves, h.moves, h.steps,
                                 h.status)]
        ok = len(idx) == (1 if name == "lone lane" else 32) and len(
            got) == len(want) and all(
            np.array_equal(g, w) for g, w in zip(got, want))
        ms = sorted(cuda_time_ms(call, iters=DFS_ITERS, warmup=0)
                    for _ in range(DFS_WINDOWS))
        clock = sm_clock(call, ms[0])
        mhz = float(clock.split()[0]) if clock[:1].isdigit() else None
        med = ms[len(ms) // 2]
        probes[name] = {"boards": len(idx), "ms": med, "windows_ms": ms,
                        "ns_a_step": med * 1e6 / DFS_MAX_STEPS,
                        "sm_clock": clock,
                        "cycles_a_step": (med * 1e-3 * mhz * 1e6
                                          / DFS_MAX_STEPS if mhz else None),
                        "equal_to_host": ok}
        if not ok:
            bad.append({"what": f"probe {name} vs host"})
    emit({"phase": "solitaire", "part": "probes", "max_steps": DFS_MAX_STEPS,
          "chain_ops": DFS_STEP_CHAIN, "sass_chain_ops": DFS_SASS_CHAIN,
          "dep_cycles": DEP_CYCLES, "probes": probes, "card": smi})

    # northstar, every target, in a fresh process
    ns = northstar_quick_in_child()
    if ns["rc"] != 0 or not ns["checks"] or not all(ns["checks"].values()):
        bad.append({"what": "northstar --quick", **ns})
    emit({"phase": "solitaire", "part": "northstar_quick", **ns})
    emit({"phase": "solitaire", "part": "summary",
          "seconds": round(time.perf_counter() - t0, 1), "failures": bad})
    if bad:
        raise AssertionError(f"load-balancing study failed: {bad}")
    for f in full.values():
        del f["pg"], f["pl"]
    torch.cuda.empty_cache()
    med = timed["medium"]
    return {"name": "solve_dfs_kernel (I2)", "route": "cuda",
            "source": "icikit_torch/csrc/solitaire.cu",
            "replaces": "icikit/models/solitaire/game.py:242 (no "
                        "pallas_call: lax.while_loop under vmap)",
            "launches": launches,
            "max_abs_err": max(f["err"] for f in full.values()),
            "ms": med["ms"], "plain_ms": plain_ms,
            "bound_ms": med["bound_ms"], "bound_by": "operations",
            "bound_kind": med["bound_kind"],
            "bound_sass_ms": med["critical_path_sass_ms"],
            "library_ms": None,
            "library": "none (native host solver: "
                       f"{med['host_s']:.3f} s on {med['host_threads']} "
                       "threads)",
            "ms_by_batch": {g: t["ms"] for g, t in timed.items()},
            "bounds_by_batch": {g: {k: t[k] for k in (
                "throughput_ms", "critical_path_ms",
                "critical_path_sass_ms")}
                for g, t in timed.items()},
            "host_s_by_batch": {g: t["host_s"] for g, t in timed.items()},
            "plain_at": plain_at,
            "kernel_ms_at_plain_budget": kernel_small_ms,
            "probes": {k: {x: v[x] for x in ("ms", "ns_a_step",
                                             "cycles_a_step", "sm_clock")}
                       for k, v in probes.items()},
            "ms_at": "medium, 20,000 boards, max_steps 500,000",
            "launches_on": "solve_static and solve_dynamic, 8 workers, on "
                           "the three full-size grades and the skewed set"}


def _hier_cases():
    """(collective, keyword arguments): every tier algorithm and op the
    JAX tests of the hierarchical collectives name."""
    return ([("allreduce", {"ici_algorithm": a})
             for a in ("ring", "recursive_doubling", "xla")]
            + [("allreduce", {"dcn_algorithm": a})
               for a in ("recursive_doubling", "xla")]
            + [("allreduce", {"op": o}) for o in ("max", "min")]
            + [("allgather", {"ici_algorithm": a, "dcn_algorithm": a})
               for a in ("ring", "xla")]
            + [("reducescatter", {"op": o}) for o in ("sum", "max")]
            + [("alltoall", {}),
               ("alltoall", {"ici_algorithm": "hypercube",
                             "dcn_algorithm": "wraparound"})])


def _vendor_sum(coll: str, kw: dict) -> bool:
    """Whether a hierarchical case sums through an ``xla`` tier (the
    vendor reduction, whose float order is the device's own)."""
    return (coll == "allreduce" and kw.get("op", "sum") == "sum"
            and "xla" in (kw.get("ici_algorithm"), kw.get("dcn_algorithm")))


def multihost_phase(torch, dev, smi) -> tuple:
    """Phase 28: the multi-process layer (see the module docstring).
    Returns each child's sort-kernel launches of the bitonic 2^MH_LOG2N
    sort, ``{"net": [..], "cross": [..]}``, and of each sort and checked
    case, ``{case: {"net": [..], "cross": [..], "segment_checksum":
    [..]}}``."""
    import hashlib

    import numpy as np

    from icikit_torch import parallel as tp
    from icikit_torch.examples import multihost as mh
    from icikit_torch.models.sort import sort
    from icikit_torch.utils.mesh import make_mesh
    from icikit_torch.utils.timing import timeit_windows

    t0 = time.perf_counter()
    hier = {"allreduce": tp.hierarchical_all_reduce,
            "allgather": tp.hierarchical_all_gather,
            "reducescatter": tp.hierarchical_reduce_scatter,
            "alltoall": tp.hierarchical_all_to_all}

    def flat(coll, x, mesh, chunk_of, op="sum", **_):
        if coll == "allreduce":
            return tp.all_reduce(x, mesh, algorithm="xla", op=op)
        if coll == "allgather":
            return tp.all_gather_blocks(x, mesh, algorithm="xla")
        if coll == "alltoall":
            return tp.all_to_all_blocks(x, mesh, algorithm="xla")
        return tp.reduce_scatter(x, mesh, algorithm="xla", op=op)[chunk_of]

    def bits(t):  # float32 as its int32 image: equality is bitwise
        return t.contiguous().view(torch.int32) if t.is_floating_point() \
            else t

    # -- one process on the card: int32 against the flat collective,
    # float32 against the port's CPU run of the same call, bitwise
    rng = np.random.default_rng(11)
    checks = []
    for dcn, ici in HIER_MESHES:
        p = dcn * ici
        mesh = tp.make_hybrid_mesh(dcn, ici, device=dev)
        cpu_mesh = tp.make_hybrid_mesh(dcn, ici, device="cpu")
        fmesh = make_mesh(p, device=dev)
        chunk_of = tp.hier_chunk_index(mesh).to(dev)
        for dt in ("int32", "float32"):
            a = (rng.integers(-1000, 1000, (p, HIER_M)).astype(np.int32)
                 if dt == "int32"
                 else rng.standard_normal((p, HIER_M)).astype(np.float32))
            for coll, kw in _hier_cases():
                src = torch.from_numpy(
                    a.reshape(p, p, HIER_M // p) if coll == "alltoall"
                    else a)
                x = src.to(dev)
                got = hier[coll](x, mesh, **kw)
                if dt == "int32":
                    want = flat(coll, x, fmesh, chunk_of, **kw)
                else:
                    want = hier[coll](src, cpu_mesh, **kw).to(dev)
                bitwise = bool(torch.equal(bits(got), bits(want)))
                check = {"mesh": [dcn, ici], "collective": coll, **kw,
                         "dtype": dt, "against": ("flat" if dt == "int32"
                                                  else "cpu"),
                         "bitwise": bitwise, "ok": bitwise}
                if dt == "float32" and _vendor_sum(coll, kw):
                    # torch.sum adds p terms in the device's own order:
                    # two orders differ by at most 2 (p - 1) u sum|x|
                    bound = 2 * (p - 1) * 2.0**-24 * x.abs().sum(0)
                    check["against"] = "cpu, within 2(p-1) u sum|x|"
                    check["ok"] = bool(((got - want).abs() <= bound).all())
                checks.append(check)
        del a, src, x, got, want
    # the hierarchical against the flat allreduce, float32 HIER_M a rank
    # at (2, 4), by the median-of-windows protocol
    mesh = tp.make_hybrid_mesh(2, 4, device=dev)
    fmesh = make_mesh(8, device=dev)
    x = torch.from_numpy(rng.standard_normal((8, HIER_M)).astype(
        np.float32)).to(dev)
    timed = {}
    for name, fn in (
            ("hierarchical ring/ring",
             lambda v: tp.hierarchical_all_reduce(v, mesh)),
            ("flat ring", lambda v: tp.all_reduce(v, fmesh, "p", "ring")),
            ("flat xla", lambda v: tp.all_reduce(v, fmesh, "p", "xla"))):
        res = timeit_windows(fn, (x,), lambda a, o: (o * 0.125,),
                             windows=3, runs=4, warmup=1, max_windows=5)
        timed[name] = {"median_ms": res.median_s * 1e3,
                       "spread_ms": [res.min_s * 1e3, res.max_s * 1e3],
                       "windows": res.windows}
    del x
    one_s = time.perf_counter() - t0
    emit({"phase": "multihost", "part": "one_process", "device": dev,
          "nvidia_smi": smi, "m_per_rank": HIER_M, "checks": checks,
          "allreduce_float32_ms": timed, "seconds": round(one_s, 1)})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"hierarchical collectives disagree: {bad}")

    # -- two processes on the one card (gloo, staged through host)
    t1 = time.perf_counter()
    data = mh.inputs(MH_M, MH_LOG2N)
    one = {k: v.cpu().numpy() for k, v in mh.run_cases(
        make_mesh(mh.RANKS, device=dev),
        tp.make_hybrid_mesh(*mh.HYBRID, device=dev), data).items()}
    keys = torch.from_numpy(data["keys"]).to(dev)
    out = sort(keys, make_mesh(mh.RANKS, device=dev)).view(mh.RANKS, -1)
    half = mh.RANKS // mh.PROCESSES
    digests = [hashlib.sha256(out[i * half:(i + 1) * half].cpu().numpy()
                              .tobytes()).hexdigest()
               for i in range(mh.PROCESSES)]
    del keys, out, data
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [q for q in env.get("PYTHONPATH", "").split(os.pathsep)
                  if q])
    t2 = time.perf_counter()
    # the children's rows (~130 MB) and logs go to a temporary directory
    with tempfile.TemporaryDirectory(prefix="icikit_multihost_") as out_dir:
        res = mh.launch(mh.worker_argv(dev, out_dir, MH_M, MH_LOG2N,
                                       sort_runs=MH_SORT_RUNS,
                                       keep_sorted=False,
                                       timeout=MH_TIMEOUT),
                        out_dir, timeout=MH_TIMEOUT + 60, env=env, cwd=repo)
        children_s = time.perf_counter() - t2
        for i, (code, text) in enumerate(res):
            if code != 0 or "WORKER_OK" not in text:
                raise AssertionError(f"two-process worker {i} exit "
                                     f"{code}:\n{text[-3000:]}")
        recs = [mh.worker_result(text) for _, text in res]
        rows = [np.load(os.path.join(out_dir, f"rank{i}.npz"))
                for i in range(mh.PROCESSES)]
        mismatched = [
            k for k, v in one.items()
            if not np.array_equal(
                np.ascontiguousarray(np.concatenate([r[k] for r in rows]))
                .view(np.uint8), np.ascontiguousarray(v).view(np.uint8))]
    launches = {c: [r["launches"][c] for r in recs] for c in ("net",
                                                              "cross")}
    cases = {case: {c: [r["case_launches"][case][c] for r in recs]
                    for c in recs[0]["case_launches"][case]}
             for case in recs[0]["case_launches"]}
    # every child saw the drilled flip once, retried once and recovered
    drills = [r["drill"] for r in recs]
    record = {
        "phase": "multihost", "part": "two_processes",
        "note": (mh.BACKEND_NOTE + "; the times and bytes are the host's "
                 "wire (gloo over the loopback, pinned host staging), "
                 "not the card's"),
        "processes": mh.PROCESSES, "ranks": mh.RANKS,
        "cases": len(one), "mismatched": mismatched,
        "sort": {"n": 1 << MH_LOG2N, "dtype": "int32", "p": mh.RANKS,
                 "wall_s_each_process": [r["sort_s"] for r in recs],
                 "wall_s_slowest": [max(t) for t in
                                    zip(*(r["sort_s"] for r in recs))],
                 "inversions": [r["inversions"] for r in recs],
                 "equal_to_one_process": [r["sha256"] == d for r, d in
                                          zip(recs, digests)],
                 "launches_each_process": launches,
                 "wire_each_process": [r["wire"] for r in recs]},
        "launches_each_process_by_case": cases, "drill": drills,
        "children_s": round(children_s, 1),
        "seconds": round(time.perf_counter() - t1, 1),
        "nvidia_smi": smi}
    emit(record)
    sort_rec = record["sort"]
    sorts_ran = all(0 not in n["net"] for case, n in cases.items()
                    if "sort" in case)
    folds_ran = all(0 not in n["segment_checksum"]
                    for case, n in cases.items() if "checked" in case)
    if (mismatched or any(sort_rec["inversions"])
            or not all(sort_rec["equal_to_one_process"])
            or 0 in launches["net"] or 0 in launches["cross"]
            or not (sorts_ran and folds_ran)
            or any(d != {"detected": 1, "retries": 1, "recoveries": 1,
                         "fired": 1} for d in drills)):
        raise AssertionError(f"two-process run: {record}")
    return launches, cases


def _mesh_launches(torch, run) -> dict:
    """``run()``'s launches of the train path's kernels (non-zero ones),
    synchronised."""
    from icikit_torch.ops import cuda_adam, cuda_integrity, cuda_stack
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops import cuda_xent as cx

    mods = (ca, cx, cuda_adam, cuda_stack, cuda_integrity)
    for mod in mods:
        mod.reset_launches()
    out = run()
    torch.cuda.synchronize()
    return out, {k: n for mod in mods for k, n in mod.LAUNCHES.items()
                 if n}


def _mesh_timed_cell(torch, dev):
    """Phase 11's bf16 train cell: config, float32 masters from seed 0,
    the b 8 tokens from ``default_rng(0)``."""
    import numpy as np

    from icikit_torch.models.transformer import init_params
    cfg = _train_config("bfloat16")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    rng = np.random.default_rng(0)
    tok, tgt = (torch.from_numpy(rng.integers(0, cfg.vocab,
                                              (TRAIN_BATCH, cfg.max_seq))
                                 .astype(np.int32)).to(dev)
                for _ in range(2))
    return cfg, params, tok, tgt


def _mesh_step(torch, mesh, cfg, params):
    from icikit_torch.models.transformer import FusedAdam, make_train_step
    p = {k: x.clone() for k, x in params.items()}
    opt, step = make_train_step(mesh, cfg, FusedAdam(
        TRAIN_LR, mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16))
    return p, opt.init(p), step


def mesh_trace(torch, dev) -> dict:
    """``torch.profiler``'s view of one MESH_TIMED ring step of phase
    11's bf16 cell after two steps: device time and launches by kernel,
    busy ms, the idle share."""
    from icikit_torch.models.transformer import make_model_mesh
    from icikit_torch.utils.trace import device_activity

    cfg, params, tok, tgt = _mesh_timed_cell(torch, dev)
    p, st, step = _mesh_step(torch, make_model_mesh(*MESH_TIMED,
                                                    device=dev), cfg, params)
    del params
    for _ in range(2):
        p, st, _ = step(p, st, tok, tgt)
    torch.cuda.synchronize()
    act = device_activity(lambda: step(p, st, tok, tgt),
                          attempts=TRACE_ATTEMPTS)
    top = sorted(act["by_name"].items(), key=lambda kv: -kv[1]["ms"])
    return {"mesh": list(MESH_TIMED), "attempts": act["attempts"],
            "device_events": act["device_events"],
            "lost_device_events": act["lost_device_events"],
            "busy_ms": act["busy_ms"], "host_wall_ms": act["host_wall_ms"],
            "idle_share_of_wall": act["idle_share_of_wall"],
            "idle_share_of_span": act["idle_share_of_span"],
            "by_name_top": dict(top[:16])}


def mesh_trace_in_child() -> dict:
    """:func:`mesh_trace` in a new Python process (the kernels are
    already built), its record read from its last line: a trace late in
    this script loses device records (phases 24, 26)."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys, torch; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; "
            "print(json.dumps(chip_smoke.mesh_trace(torch, 'cuda')))")
    r = subprocess.run([sys.executable, "-c", code, here], cwd=here,
                       capture_output=True, text=True, timeout=300)
    if r.returncode:
        raise AssertionError(f"mesh trace failed: {r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def model_mesh_phase(torch, dev, smi) -> dict:
    """Phase 29: the model mesh (see the module docstring). Returns the
    MESH_TIMED step's launches by kernel and the clean checked step's
    checksum launches."""
    import numpy as np

    from icikit_torch import chaos
    from icikit_torch.examples import multihost as mh
    from icikit_torch.models.transformer import (init_params,
                                                 loss_and_metrics,
                                                 make_model_mesh,
                                                 make_train_step)
    from icikit_torch.models.transformer import model as tmodel
    from icikit_torch.parallel.model_axes import psum
    from icikit_torch.utils.timing import cuda_time_ms, timeit_windows

    t0 = time.perf_counter()
    # -- the checks: base width, float32, b 2
    cfg = _train_config("float32", n_layers=MESH_CHECK_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    rng = np.random.default_rng(0)
    tok, tgt = (torch.from_numpy(rng.integers(
        0, cfg.vocab, (TRAIN_CHECK_BATCH, cfg.max_seq)).astype(np.int32))
        .to(dev) for _ in range(2))
    loss1, g1, _ = loss_and_metrics(params, tok, tgt,
                                    make_model_mesh(device=dev), cfg)
    loss1 = float(loss1)
    checks = []
    for mesh, over in MESH_CHECKS:
        c = _train_config("float32", n_layers=MESH_CHECK_LAYERS, **over)
        (loss, g, _), launches = _mesh_launches(torch, lambda: (
            loss_and_metrics(params, tok, tgt,
                             make_model_mesh(*mesh, device=dev), c)))
        rel = {k: _rel_l2(g[k], g1[k]) for k in g1}
        want = {"flash_fwd", "flash_bwd"}
        if not c.vocab_parallel:
            want |= {"xent_fwd"} | ({"xent_dx_saved", "xent_dw_saved"}
                                    if c.xent_fused_bwd else
                                    {"xent_g_saved"})
        checks.append({
            "mesh": list(mesh), "over": over, "loss": float(loss),
            "loss_diff": abs(float(loss) - loss1),
            "rel_l2_max": max(rel.values()),
            "worst_leaf": max(rel, key=rel.get), "launches": launches,
            "ok": (abs(float(loss) - loss1) <= TRAIN_LOSS_TOL
                   and max(rel.values()) <= TRAIN_GRAD_TOL
                   and want <= set(launches))})
        del g
    del g1
    # the checked gradient ring at (2, 2, 2): a clean step, a drilled one
    ring_mesh = make_model_mesh(2, 2, 2, device=dev)

    def ring_step(grad_check, taint=None):
        p = {k: x.clone() for k, x in params.items()}
        opt, step = make_train_step(ring_mesh, cfg, guard="device",
                                    grad_check=grad_check)
        st = opt.init(p)
        before = ({k: x.clone() for k, x in p.items()},
                  {k: x.clone() for k, x in st[0].items()})
        return before, step(p, st, tok, tgt, taint)

    _, plain = ring_step("none")
    (_, clean), ring_launches = _mesh_launches(torch,
                                               lambda: ring_step("ring"))
    plan = chaos.FaultPlan(
        seed=2, schedule={f"corrupt:{tmodel.GRAD_SYNC_SITE}": (0,)})
    with chaos.inject(plan):
        taint = chaos.traced_corrupt_spec(
            tmodel.GRAD_SYNC_SITE, tmodel.grad_sync_n_steps(ring_mesh),
            ring_mesh.dp)
    before, drilled = ring_step("ring", taint)
    grad_ring = {
        "mesh": [2, 2, 2], "clean_ok": bool(clean[3]),
        "clean_committed": int(clean[1][2]) == 1,
        "clean_loss_bitwise_unchecked": bool(torch.equal(clean[2],
                                                         plain[2])),
        "clean_params_rel_l2_to_unchecked": max(
            _rel_l2(clean[0][k], plain[0][k]) for k in params),
        "checksum_launches": ring_launches.get("segment_checksum", 0),
        "drill_fired": plan.fired("corrupt", tmodel.GRAD_SYNC_SITE),
        "drilled_ok": bool(drilled[3]),
        "drilled_params_untouched": all(
            torch.equal(drilled[0][k], before[0][k]) for k in params),
        "drilled_moments_untouched": all(
            torch.equal(drilled[1][0][k], before[1][k]) for k in params),
        "drilled_step_count": int(drilled[1][2])}
    grad_ring["ok"] = (
        grad_ring["clean_ok"] and grad_ring["clean_committed"]
        and grad_ring["clean_loss_bitwise_unchecked"]
        and grad_ring["clean_params_rel_l2_to_unchecked"] <= MESH_RING_TOL
        and grad_ring["checksum_launches"] > 0
        and grad_ring["drill_fired"] == 1 and not grad_ring["drilled_ok"]
        and grad_ring["drilled_params_untouched"]
        and grad_ring["drilled_moments_untouched"]
        and grad_ring["drilled_step_count"] == 0)
    del params, plain, clean, drilled, before
    torch.cuda.empty_cache()
    emit({"phase": "model_mesh", "part": "checks", "nvidia_smi": smi,
          "config": {"preset": TRAIN_PRESET, "dtype": "float32",
                     "batch": TRAIN_CHECK_BATCH, "seq": cfg.max_seq,
                     "layers": MESH_CHECK_LAYERS},
          "reference": "the (1, 1, 1) step's loss and gradients",
          "loss_tolerance": TRAIN_LOSS_TOL,
          "grad_tolerance": TRAIN_GRAD_TOL, "checks": checks,
          "grad_ring": grad_ring,
          "seconds": round(time.perf_counter() - t0, 1)})
    bad = [c for c in checks if not c["ok"]]
    if bad or not grad_ring["ok"]:
        raise AssertionError(f"model mesh checks: {bad} {grad_ring}")

    # -- the timed cell: phase 11's bf16 config at MESH_TIMED and (1,1,1)
    t1 = time.perf_counter()
    cfg, params, tok, tgt = _mesh_timed_cell(torch, dev)
    timed = {}
    for shape in ((1, 1, 1), MESH_TIMED):
        mesh = make_model_mesh(*shape, device=dev)
        p, st, step = _mesh_step(torch, mesh, cfg, params)
        p, st, _ = step(p, st, tok, tgt)              # first-call set-up
        (p, st, loss), launches = _mesh_launches(
            torch, lambda: step(p, st, tok, tgt))
        dp, tp, sp = shape
        want = {"flash_fwd": dp * sp * cfg.n_layers,
                "flash_bwd": dp * sp * cfg.n_layers,
                "xent_fwd": dp * tp * sp, "xent_dx_saved": dp * tp * sp,
                "xent_dw_saved": dp * tp * sp}

        def multi(p, s):
            out = (p, s, None)
            for _ in range(MESH_STEPS_A_RUN):
                out = step(out[0], out[1], tok, tgt)
            return out

        res = timeit_windows(multi, (p, st), lambda a, o: (o[0], o[1]),
                             windows=3, runs=1, warmup=1,
                             target_window_s=1.0, max_windows=3)
        timed[shape] = {
            "mesh": list(shape), "launches_per_step": launches,
            "launches_want": want, "launches_ok": launches == want,
            "loss": float(loss),
            "step_ms": res.median_s / MESH_STEPS_A_RUN * 1e3,
            "step_ms_spread": [res.min_s / MESH_STEPS_A_RUN * 1e3,
                               res.max_s / MESH_STEPS_A_RUN * 1e3],
            "windows": res.windows}
        del p, st, step
        torch.cuda.empty_cache()
    # the gradient sync of MESH_TIMED: every leaf's pvary backward (its
    # psums over sp, tp, dp), and the dp psums alone, by events
    mesh = make_model_mesh(*MESH_TIMED, device=dev)
    specs = tmodel.param_specs(cfg)
    layered = set(tmodel._layer_keys(cfg))
    leaves, entered, cots = [], [], []
    for k, v in params.items():
        leaf = (v if k in tmodel.KEEP_FP32 else v.to(torch.bfloat16)
                ).detach().requires_grad_(True)
        x = tmodel._enter(leaf, specs[k], k in layered, mesh)
        leaves.append(leaf)
        entered.append(x)
        cots.append(torch.randn_like(x))
    sync_ms = cuda_time_ms(lambda: torch.autograd.grad(
        entered, leaves, cots, retain_graph=True), iters=5, warmup=1)
    dp_ms = cuda_time_ms(lambda: [psum(c, mesh, "dp", 0) for c in cots],
                         iters=5, warmup=1)
    del leaves, entered, cots, params
    torch.cuda.empty_cache()
    t_trace = time.perf_counter()
    trace = mesh_trace_in_child()
    trace["seconds"] = round(time.perf_counter() - t_trace, 1)
    step_ms = timed[MESH_TIMED]["step_ms"]
    emit({"phase": "model_mesh", "part": "timing", "card": smi,
          "config": {"preset": TRAIN_PRESET, "dtype": "bfloat16",
                     "batch": TRAIN_BATCH, "seq": cfg.max_seq,
                     "layers": cfg.n_layers},
          "steps": {"x".join(map(str, k)): v for k, v in timed.items()},
          "ratio_to_1_1_1": step_ms / timed[(1, 1, 1)]["step_ms"],
          "grad_sync_ms": sync_ms, "dp_psum_ms": dp_ms,
          "grad_sync_share": sync_ms / step_ms,
          "dp_psum_share": dp_ms / step_ms, "trace": trace,
          "seconds": round(time.perf_counter() - t1, 1)})
    if not all(v["launches_ok"] for v in timed.values()):
        raise AssertionError(f"model mesh launches: {timed}")

    # -- dp across two OS processes (gloo on the one card)
    t2 = time.perf_counter()
    one, one_launches = mh.train_case(
        make_model_mesh(*mh.TRAIN_MESH, device=dev))
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [q for q in env.get("PYTHONPATH", "").split(os.pathsep)
                  if q])
    with tempfile.TemporaryDirectory(prefix="icikit_mesh_") as out_dir:
        res = mh.launch(mh.train_argv(dev, out_dir, timeout=MH_TIMEOUT),
                        out_dir, timeout=MH_TIMEOUT + 60, env=env, cwd=repo)
        for i, (code, text) in enumerate(res):
            if code != 0 or "WORKER_OK" not in text:
                raise AssertionError(f"two-process train worker {i} exit "
                                     f"{code}:\n{text[-3000:]}")
        recs = [mh.worker_result(text) for _, text in res]
        rows = [np.load(os.path.join(out_dir, f"rank{i}.npz"))
                for i in range(mh.PROCESSES)]
        mismatched = [[k for k, v in one.items() if not np.array_equal(
            np.ascontiguousarray(r[k]).view(np.uint8),
            np.ascontiguousarray(v).view(np.uint8))] for r in rows]
    kernels = {"flash_fwd", "flash_bwd", "xent_fwd", "xent_dx_saved",
               "xent_dw_saved"}
    two = {"mesh": list(mh.TRAIN_MESH), "config": mh.TRAIN_CFG,
           "batch": mh.TRAIN_BATCH, "steps": mh.TRAIN_STEPS,
           "note": mh.BACKEND_NOTE + "; the dp psums cross the host",
           "loss_one_process": one["loss"].tolist(),
           "loss_each_process": [r["loss"] for r in recs],
           "mismatched_each_process": mismatched,
           "launches_last_step_each_process": [r["launches_last_step"]
                                               for r in recs],
           "launches_last_step_one_process": one_launches,
           "wire_each_process": [r["wire"] for r in recs],
           "train_s_each_process": [r["train_s"] for r in recs],
           "seconds": round(time.perf_counter() - t2, 1)}
    two["ok"] = (not any(mismatched) and all(
        kernels <= set(r["launches_last_step"]) for r in recs))
    emit({"phase": "model_mesh", "part": "two_processes", **two,
          "seconds_phase": round(time.perf_counter() - t0, 1)})
    if not two["ok"]:
        raise AssertionError(f"two-process dp = 2 step: {two}")
    return {"step": timed[MESH_TIMED]["launches_per_step"],
            "grad_ring": grad_ring["checksum_launches"]}


def _decode_launches(torch, run):
    """``run()``'s launches of the decode path's kernels (non-zero ones),
    synchronised."""
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops import cuda_quant as cq

    ca.reset_launches()
    cq.reset_launches()
    out = run()
    torch.cuda.synchronize()
    return out, {k: n for k, n in {**ca.LAUNCHES, **cq.LAUNCHES}.items()
                 if n}


def _mesh_decode_want(cfg, tp: int) -> dict:
    """A generate's launches at phase 8's cell on a (dp, tp, 1) mesh: one
    ``flash_fwd`` and one step a layer (every rank's rows in the one
    launch); under int8 one B15 launch a tp rank a product and one for
    the head (tp under ``vocab_parallel``), at the prefill and each step."""
    L = cfg.n_layers
    if cfg.decode_quant != "int8":
        return {"flash_fwd": L, "decode_step": L * (DEC_NEW - 1)}
    head = tp if cfg.vocab_parallel else 1
    return {"flash_fwd": L, "decode_step_q8": L * (DEC_NEW - 1),
            "quant_matvec": (4 * L * tp + head) * DEC_NEW}


def _sample_arm() -> tuple:
    """JAX's sampled arm as ``bench/decode.py`` runs it (its key seed and
    knobs) with the nucleus SAMPLE_TOP_P: (seed, knobs dict, knobs as
    ``select_tokens`` takes them)."""
    from icikit_torch.bench.decode import SAMPLE_KNOBS, SAMPLE_SEED

    kn = dict(SAMPLE_KNOBS, top_p=SAMPLE_TOP_P)
    return SAMPLE_SEED, kn, [kn["temperature"], kn["top_p"], kn["top_k"]]


def _draw_gap(torch, lg, key, seed: int, pos: int) -> float:
    """The top-2 gap of the draw of the token at ``pos`` from float32
    logits ``lg (V,)`` under :func:`_sample_arm`'s knobs."""
    from icikit_torch.models.transformer import decode as td

    d = lg.device
    draw = td.fold_positions(td.fold_streams(key.to(d), torch.tensor(
        [seed], device=d)), torch.tensor([pos], device=d))
    return float(td.draw_gap(lg[None].float(), draw, _sample_arm()[2])[0])


def _draw_divergence(torch, tok_a, tok_b, lg_a, lg_b, key, seeds) -> list:
    """:func:`_first_divergence` for sampled generates: a row that
    differs must do so first at a draw whose top-2 gap (either arm's
    logits) is below DRAW_TIE_TOL."""
    rows = _first_divergence(tok_a, tok_b, lg_a, lg_b, DEC_PROMPT, 0.0)
    for row in rows:
        row.pop("top2_gap", None)
        row.pop("near_tie", None)
        j = row["first_diff"]
        if j is not None:
            gaps = [_draw_gap(torch, lg[j, row["row"]], key,
                              int(seeds[row["row"]]), DEC_PROMPT + j)
                    for lg in (lg_a, lg_b)]
            row["draw_top2_gap"] = gaps
            row["near_tie"] = max(gaps) < DRAW_TIE_TOL
    return rows


def _bad_rows(rows, tol) -> list:
    return [r for r in rows if r["max_logit_diff"] > tol
            or (r["first_diff"] is not None and not r["near_tie"])]


def _chi_square(torch, dev, lg) -> dict:
    """CHI2_DRAWS draws through ``select_tokens`` from the one raw row
    ``lg (V,)`` under :func:`_sample_arm`'s knobs, each keyed
    ``fold_in(key(7), i)``,
    against the softmax of the row's filtered logits: Pearson's
    chi-square over the support's tokens (those expected fewer than
    CHI2_MIN_EXPECTED times pooled), and no draw outside the support."""
    from scipy.stats import chi2

    from icikit_torch.models.transformer import decode as td
    from icikit_torch.utils import threefry

    knobs = torch.tensor(_sample_arm()[2], device=dev)
    x = td._sample_filter(lg[None].float(), knobs[0:1], knobs[2:3],
                          knobs[1:2])[0]
    support = torch.isfinite(x)
    p = torch.softmax(x.double(), dim=-1)
    counts = torch.zeros(lg.shape[-1], dtype=torch.int64, device=dev)
    base = threefry.key_data(7, dev)
    for i in range(0, CHI2_DRAWS, CHI2_CHUNK):
        keys = threefry.fold_in(base, torch.arange(i, i + CHI2_CHUNK,
                                                   device=dev))
        tok = td.select_tokens(lg.float().expand(CHI2_CHUNK, -1), keys,
                               knobs)
        counts += torch.bincount(tok.long(), minlength=lg.shape[-1])
    want = (p * CHI2_DRAWS)[support].cpu().numpy()
    got = counts[support].cpu().numpy().astype(float)
    big = want >= CHI2_MIN_EXPECTED
    obs = list(got[big]) + ([got[~big].sum()] if (~big).any() else [])
    exp = list(want[big]) + ([want[~big].sum()] if (~big).any() else [])
    stat = float(sum((o - e) ** 2 / e for o, e in zip(obs, exp)))
    df = len(obs) - 1
    p_value = float(chi2.sf(stat, df))
    outside = int(counts[~support].sum())
    return {"draws": CHI2_DRAWS, "support": int(support.sum()),
            "bins": len(obs), "chi2": stat, "df": df, "p_value": p_value,
            "level": CHI2_P, "outside_support": outside,
            "ok": p_value > CHI2_P and outside == 0}


def mesh_decode_trace(torch, dev) -> dict:
    """``torch.profiler``'s view of one bf16 MESH_DECODE_TIMED generate at
    phase 8's cell (after a first call), of one step's draw at its width
    (the filter and argmax over (b, V) float32 logits and their Gumbel
    noise under :func:`_sample_arm`'s knobs) and of the Gumbel noise a
    sampled generate makes for its draws: device time and launches by
    kernel, busy ms, the idle share."""
    from icikit_torch.bench.decode import make_config
    from icikit_torch.models.transformer import (greedy_generate,
                                                 init_params,
                                                 make_model_mesh)
    from icikit_torch.models.transformer import decode as td
    from icikit_torch.utils import threefry
    from icikit_torch.utils.trace import device_activity

    cfg = make_config(DEC_PRESET, DEC_PROMPT, DEC_NEW, decode_step="fused",
                      attention_impl="flash", compute_dtype="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    prompt = torch.randint(0, cfg.vocab, (DEC_BATCH, DEC_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    mesh = make_model_mesh(*MESH_DECODE_TIMED, device=dev)
    greedy_generate(params, prompt, mesh, cfg, DEC_NEW)
    torch.cuda.synchronize()
    act = device_activity(
        lambda: greedy_generate(params, prompt, mesh, cfg, DEC_NEW),
        attempts=TRACE_ATTEMPTS)
    seed, _, kn = _sample_arm()
    lg = torch.randn((DEC_BATCH, cfg.vocab), generator=gen, device=dev)
    streams = td.fold_streams(threefry.key_data(seed, dev),
                              torch.arange(DEC_BATCH, device=dev))
    keys = td.fold_positions(streams, (DEC_PROMPT + torch.arange(
        DEC_NEW, device=dev)).expand(DEC_BATCH, -1))
    knobs = torch.tensor(kn, device=dev)

    def noise():
        return list(td._step_noise(keys, cfg.vocab))

    g = noise()[0]
    out = {}
    for name, fn in (("draw_step", lambda: td._select_token(lg, g, knobs)),
                     ("draw_noise_a_generate", noise)):
        fn()
        torch.cuda.synchronize()
        out[name] = device_activity(fn, attempts=TRACE_ATTEMPTS)
    top = sorted(act["by_name"].items(), key=lambda kv: -kv[1]["ms"])
    pick = ("attempts", "device_events", "lost_device_events", "busy_ms",
            "host_wall_ms", "idle_share_of_wall", "idle_share_of_span")
    return {"mesh": list(MESH_DECODE_TIMED) + [1],
            **{k: act[k] for k in pick}, "by_name_top": dict(top[:12]),
            **{name: {k: a[k] for k in pick} for name, a in out.items()}}


def mesh_decode_trace_in_child() -> dict:
    """:func:`mesh_decode_trace` in a new Python process (the kernels are
    already built), its record read from its last line: a trace late in
    this script loses device records (phases 24, 26, 29)."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys, torch; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; "
            "print(json.dumps(chip_smoke.mesh_decode_trace(torch, "
            "'cuda')))")
    r = subprocess.run([sys.executable, "-c", code, here], cwd=here,
                       capture_output=True, text=True, timeout=300)
    if r.returncode:
        raise AssertionError(f"mesh decode trace failed: "
                             f"{r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def mesh_decode_phase(torch, dev, smi) -> dict:
    """Phase 30: decode on the mesh and sampled decode (see the module
    docstring). Returns each kernel's launches a generate by mesh."""
    from icikit_torch.bench.decode import make_config
    from icikit_torch.models.transformer import (greedy_generate,
                                                 init_params,
                                                 make_model_mesh,
                                                 maybe_quantize_params,
                                                 sample_generate)
    from icikit_torch.models.transformer import decode as td
    from icikit_torch.utils import threefry
    from icikit_torch.utils.timing import timeit_windows

    t0 = time.perf_counter()

    def config(dtype, **over):
        return make_config(DEC_PRESET, DEC_PROMPT, DEC_NEW,
                           **{"decode_step": "fused",
                              "attention_impl": "flash",
                              "compute_dtype": dtype, **over})

    def mesh(dp=1, tp=1):
        return make_model_mesh(dp, tp, device=dev)

    def tag(dp, tp):
        return f"{dp}x{tp}x1"

    gen = torch.Generator(device=dev).manual_seed(0)
    fp = init_params(config("float32"), gen, dev)   # phase 8's masters
    prompt = torch.randint(0, fp["emb"].shape[0], (DEC_BATCH, DEC_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    launches, checks = {}, []

    def counted(name, dp, tp, cfg, run):
        out, got = _decode_launches(torch, run)
        want = _mesh_decode_want(cfg, tp)
        launches.setdefault(name, {})[tag(dp, tp)] = got
        if got != want:
            raise AssertionError(f"{name} at {tag(dp, tp)}: launches {got}, "
                                 f"want {want}")
        return out

    # -- float32 greedy at each mesh against (1, 1, 1)
    c32 = config("float32")
    ref = counted("float32 greedy", 1, 1, c32, lambda: greedy_generate(
        fp, prompt, mesh(), c32, DEC_NEW, return_logits=True))
    greedy_221 = None
    for (dp, tp), over in MESH_DECODE:
        c = config("float32", **over)
        tok, lg = counted("float32 greedy", dp, tp, c,
                          lambda: greedy_generate(fp, prompt, mesh(dp, tp),
                                                  c, DEC_NEW,
                                                  return_logits=True))
        rows = _first_divergence(tok, ref[0], lg, ref[1], DEC_PROMPT,
                                 FP32_LOGIT_TOL)
        if (dp, tp) == MESH_DECODE_TIMED:
            greedy_221 = tok
        checks.append({"what": "float32 greedy", "mesh": tag(dp, tp),
                       "over": over, "tolerance": FP32_LOGIT_TOL,
                       "tokens_identical": bool(torch.equal(tok, ref[0])),
                       "rows": rows, "ok": not _bad_rows(rows,
                                                         FP32_LOGIT_TOL)})
        del lg
    dp, tp = MESH_DECODE_TIMED

    # -- bf16: the first step's logits
    c16 = config("bfloat16")
    _, l16 = greedy_generate(fp, prompt, mesh(), c16, DEC_NEW,
                             return_logits=True)
    t16, m16 = counted("bf16 greedy", dp, tp, c16, lambda: greedy_generate(
        fp, prompt, mesh(dp, tp), c16, DEC_NEW, return_logits=True))
    d16 = float((m16[0] - l16[0]).abs().max())
    checks.append({"what": "bf16 first-step logits", "mesh": tag(dp, tp),
                   "max_diff": d16, "tolerance": BF16_LOGIT_TOL,
                   "ok": d16 <= BF16_LOGIT_TOL})
    del l16, m16

    # -- int8 at float32 against int8 at (1, 1, 1); B14 and B15 launched
    q32 = config("float32", decode_quant="int8")
    qp = maybe_quantize_params(fp, mesh(), q32)
    qref = counted("int8 float32 greedy", 1, 1, q32, lambda: greedy_generate(
        qp, prompt, mesh(), q32, DEC_NEW, return_logits=True))
    qt, ql = counted("int8 float32 greedy", dp, tp, q32,
                     lambda: greedy_generate(qp, prompt, mesh(dp, tp), q32,
                                             DEC_NEW, return_logits=True))
    rows = _first_divergence(qt, qref[0], ql, qref[1], DEC_PROMPT,
                             INT8_FP32_LOGIT_TOL)
    checks.append({"what": "int8 float32 greedy", "mesh": tag(dp, tp),
                   "tolerance": INT8_FP32_LOGIT_TOL,
                   "tokens_identical": bool(torch.equal(qt, qref[0])),
                   "rows": rows,
                   "ok": not _bad_rows(rows, INT8_FP32_LOGIT_TOL)})
    del qref, ql
    q16 = config("bfloat16", decode_quant="int8")
    _, ql1 = counted("int8 bf16 greedy (qmv_bf16_*)", 1, 1, q16,
                     lambda: greedy_generate(qp, prompt, mesh(), q16,
                                             DEC_NEW, return_logits=True))
    _, qlm = counted("int8 bf16 greedy (qmv_bf16_*)", dp, tp, q16,
                     lambda: greedy_generate(qp, prompt, mesh(dp, tp), q16,
                                             DEC_NEW, return_logits=True))
    dq16 = float((qlm[0] - ql1[0]).abs().max())
    checks.append({"what": "int8 bf16 first-step logits", "mesh": tag(dp, tp),
                   "max_diff": dq16, "tolerance": BF16_LOGIT_TOL,
                   "ok": dq16 <= BF16_LOGIT_TOL})
    del ql1, qlm

    # -- sampled at float32: (2, 2, 1) against (1, 1, 1), temperature 0,
    # the draw keys on the card against the CPU's, the frequencies
    sample_seed, sample_knobs, _ = _sample_arm()
    key = threefry.key_data(sample_seed)
    seeds = torch.arange(DEC_BATCH, dtype=torch.int32)
    s1, sl1 = counted("float32 sampled", 1, 1, c32, lambda: sample_generate(
        fp, prompt, mesh(), c32, DEC_NEW, key, **sample_knobs,
        return_logits=True))
    sm, slm = counted("float32 sampled", dp, tp, c32,
                      lambda: sample_generate(fp, prompt, mesh(dp, tp), c32,
                                              DEC_NEW, key, **sample_knobs,
                                              return_logits=True))
    rows = _draw_divergence(torch, sm, s1, slm, sl1, key, seeds)
    checks.append({"what": "float32 sampled", "mesh": tag(dp, tp),
                   "knobs": sample_knobs, "key_seed": sample_seed,
                   "draw_tie_tolerance": DRAW_TIE_TOL,
                   "logit_tolerance": FP32_LOGIT_TOL,
                   "tokens_identical": bool(torch.equal(sm, s1)),
                   "tokens_equal_greedy_share": float(
                       (sm[:, DEC_PROMPT:] == greedy_221[:, DEC_PROMPT:])
                       .float().mean()),
                   "rows": rows, "ok": not _bad_rows(rows, FP32_LOGIT_TOL)})
    t0_tok = sample_generate(fp, prompt, mesh(dp, tp), c32, DEC_NEW, key,
                             temperature=0.0)
    checks.append({"what": "temperature 0 is greedy", "mesh": tag(dp, tp),
                   "ok": bool(torch.equal(t0_tok, greedy_221))})
    pos = DEC_PROMPT + torch.arange(DEC_NEW).expand(DEC_BATCH, -1)
    keys = {d: td.fold_positions(td.fold_streams(key.to(d), seeds.to(d)),
                                 pos.to(d)) for d in ("cpu", dev)}
    bits = {d: threefry.random_bits(keys[d][:, :2], (sl1.shape[-1],))
            for d in keys}
    gum = {d: threefry.gumbel(keys[d][:, :2], (sl1.shape[-1],))
           for d in keys}
    checks.append({
        "what": "draw keys on the card against the CPU",
        "keys": int(keys["cpu"].numel() // 2),
        "key_data_bitwise": bool(torch.equal(keys[dev].cpu(), keys["cpu"])),
        "bits_bitwise": bool(torch.equal(bits[dev].cpu(), bits["cpu"])),
        "gumbel_max_abs_diff": float((gum[dev].cpu() - gum["cpu"]).abs()
                                     .max()),
        "ok": bool(torch.equal(keys[dev].cpu(), keys["cpu"])
                   and torch.equal(bits[dev].cpu(), bits["cpu"]))})
    chi = _chi_square(torch, dev, sl1[0, 0])
    checks.append({"what": "chi-square of the draws", "row": "the (1, 1, 1) "
                   "sampled arm's first-step logits of row 0", **chi})
    del sl1, slm, keys, bits, gum
    emit({"phase": "mesh_decode", "part": "checks", "nvidia_smi": smi,
          "config": {"preset": DEC_PRESET, "batch": DEC_BATCH,
                     "prompt": DEC_PROMPT, "n_new": DEC_NEW,
                     "decode_step": "fused", "attention_impl": "flash"},
          "reference": "the same generate at (1, 1, 1)",
          "checks": checks, "launches": launches,
          "seconds": round(time.perf_counter() - t0, 1)})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"decode on the mesh: {bad}")

    # -- timing: bf16 greedy at (1, 1, 1) and MESH_DECODE_TIMED, and the
    # sampled arm at (1, 1, 1), by the chained median-of-windows protocol,
    # one window an arm in each of TIMING_TURNS alternating turns, so a
    # draw's cost is read within each turn
    t1 = time.perf_counter()
    del qp
    ctr = [0]

    def chain(args, o):
        ctr[0] += 1
        nxt = o[:, -DEC_PROMPT:].clone()
        nxt[0, 0] = ctr[0] % c16.vocab
        return (nxt,)

    runs = {"greedy 1x1x1": (mesh(), greedy_generate),
            f"greedy {tag(dp, tp)}": (mesh(dp, tp), greedy_generate),
            "sampled 1x1x1": (mesh(), lambda p, pr, m, c, n: sample_generate(
                p, pr, m, c, n, key, **sample_knobs))}
    per = {name: [] for name in runs}
    for _ in range(TIMING_TURNS):
        for name, (m, run) in runs.items():
            res = timeit_windows(
                lambda pr, m=m, run=run: run(fp, pr, m, c16, DEC_NEW),
                (prompt,), chain, windows=1, runs=1, warmup=1,
                max_windows=1)
            per[name].append(res.median_s / DEC_NEW * 1e3)
    arms = {name: {"per_token_ms": statistics.median(v),
                   "spread_ms": [min(v), max(v)],
                   "tokens_per_s": DEC_BATCH * 1e3 / statistics.median(v),
                   "per_turn_ms": v} for name, v in per.items()}
    draw = [a - b for a, b in zip(per["sampled 1x1x1"],
                                  per["greedy 1x1x1"])]
    del fp
    torch.cuda.empty_cache()
    t_trace = time.perf_counter()
    trace = mesh_decode_trace_in_child()
    trace["seconds"] = round(time.perf_counter() - t_trace, 1)
    g1 = arms["greedy 1x1x1"]["per_token_ms"]
    emit({"phase": "mesh_decode", "part": "timing", "card": smi,
          "dtype": "bfloat16", "arms": arms,
          "mesh_ratio_to_1x1x1": arms[f"greedy {tag(dp, tp)}"]
          ["per_token_ms"] / g1,
          "draw_ms_a_token": statistics.median(draw),
          "draw_ms_a_token_per_turn": draw,
          "draw_knobs": sample_knobs, "trace": trace,
          "seconds": round(time.perf_counter() - t1, 1),
          "seconds_phase": round(time.perf_counter() - t0, 1)})
    return launches


def collectives_study_phase(torch, dev, smi, sort_s: float) -> dict:
    """Phase 31: the collectives study end to end (see the module
    docstring). ``sort_s`` is phase 4's median seconds for 2^28 keys.
    Returns the measured rates."""
    from icikit_torch import parallel  # noqa: F401 (the registry)
    from icikit_torch.bench import crossover, scaling
    from icikit_torch.examples import collectives_study
    from icikit_torch.examples.dryrun_multichip import dryrun_multichip
    from icikit_torch.utils.registry import list_algorithms

    t0 = time.perf_counter()
    bad = []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # the strong-scaling sweep: a scale point a subprocess, p ranks as
    # rows of the card
    for family in ("allgather", "alltoall"):
        recs = scaling.run_scaling_sweep(
            family, STUDY_PS, sizes=STUDY_SIZES, runs=STUDY_RUNS,
            device=dev, timeout_s=STUDY_TIMEOUT)
        want = {(a, p, m) for p in STUDY_PS for m in STUDY_SIZES
                for a in list_algorithms(family)
                if p & (p - 1) == 0 or (family, a) not in COLL_POW2_ONLY}
        got = {(r["algorithm"], r["p"], r["msize"]) for r in recs}
        if got != want or not all(r["verified"] for r in recs):
            bad.append({"what": f"scaling {family}", "missing":
                        sorted(want - got), "unverified": [
                            (r["algorithm"], r["p"], r["msize"])
                            for r in recs if not r["verified"]]})
        emit({"phase": "collectives_study", "part": "scaling",
              "family": family, "ps": list(STUDY_PS), "card": smi,
              "records": [{k: r[k] for k in (
                  "algorithm", "p", "msize", "processes", "best_s",
                  "mean_s", "busbw_gbps", "verified")} for r in recs]})
    # one sort scale point: the four sorts at p = 8
    recs = scaling.run_scale_point(
        None, STUDY_SORT_P, sizes=(1 << STUDY_SORT_LOG2N,), runs=1,
        device=dev, timeout_s=STUDY_TIMEOUT, bench="sort")
    if (sorted(r["algorithm"] for r in recs) != sorted(SORT_ALGS)
            or any(r["errors"] or not r["matches_torch_sort"]
                   for r in recs)):
        bad.append({"what": "sort scale point", "records": recs})
    emit({"phase": "collectives_study", "part": "sort_point",
          "p": STUDY_SORT_P, "n": 1 << STUDY_SORT_LOG2N, "dtype": "int32",
          "card": smi,
          "records": [{k: r[k] for k in (
              "algorithm", "p", "n", "processes", "best_s", "keys_per_s",
              "errors", "matches_torch_sort", "launches", "retries")}
              for r in recs]})
    # one point with the ranks split across two processes (gloo)
    recs = scaling.run_scale_point(
        "broadcast", STUDY_SORT_P, sizes=STUDY_SIZES, runs=STUDY_RUNS,
        device=dev, processes=2, timeout_s=STUDY_TIMEOUT)
    if (len(recs) != 3 * len(STUDY_SIZES)
            or not all(r["verified"] and r["processes"] == 2
                       for r in recs)):
        bad.append({"what": "two-process point", "records": recs})
    emit({"phase": "collectives_study", "part": "two_process_point",
          "family": "broadcast", "p": STUDY_SORT_P, "processes": 2,
          "note": "the times are the host's wire (gloo, pinned host "
                  "staging), not the card's", "card": smi,
          "records": [{k: r[k] for k in (
              "algorithm", "p", "msize", "processes", "best_s", "mean_s",
              "verified")} for r in recs]})
    # the crossover model's two compute rates, measured on this card
    merge = crossover.measure_merge_rate(device=dev)
    r_cmp = crossover.comparator_rate(1 << 28, sort_s)
    rates = {"r_cmp": r_cmp, "r_cmp_from": "phase 4: 2^28 int32 keys, p = "
             f"1, median {sort_s * 1e3:.3f} ms",
             "r_merge": merge["r_merge_measured_keys_per_s"],
             "r_merge_bench": merge, "b_link_spec": crossover.B_LINK,
             "module_constants": {"R_CMP": crossover.R_CMP,
                                  "R_MERGE": crossover.R_MERGE}}
    emit({"phase": "collectives_study", "part": "rates", "card": smi,
          **rates})
    # the dry run of every distributed part, and the collectives study
    dryrun_multichip(STUDY_SORT_P, device=dev)
    recs = collectives_study.study(dev)
    emit({"phase": "collectives_study", "part": "examples",
          "dryrun_multichip": f"{STUDY_SORT_P} ranks passed",
          "collectives_study": [
              {"family": r.family, "algorithm": r.algorithm,
               "msize": r.msize, "best_us": r.best_s * 1e6,
               "verified": r.verified} for r in recs],
          "seconds": round(time.perf_counter() - t0, 1),
          "failures": bad})
    if bad:
        raise AssertionError(f"collectives study failed: {bad}")
    return rates


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from icikit_torch.bench import sort_ab
    from icikit_torch.bench.sort import hbm_nameplate_bytes
    from icikit_torch.models.sort import check_sort, sort
    from icikit_torch.ops import _build
    from icikit_torch.ops import cuda_sort as cs
    from icikit_torch.utils.mesh import make_mesh
    from icikit_torch.utils.timing import cuda_time_ms, timeit_windows

    t_start = time.perf_counter()
    dev = "cuda"
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    emit({"phase": "device", "torch_name": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    bw = hbm_nameplate_bytes(kind) or MEM_BPS_SXM

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    regs = {}
    for which, name in enumerate(SORT_KERNELS):
        r, loc = ctypes.c_int(), ctypes.c_int()
        _build.check(libs["bitonic_net"].icikit_kernel_regs(
            which, ctypes.byref(r), ctypes.byref(loc)), "kernel attributes")
        regs[name] = {"registers": r.value, "local_bytes": loc.value}
    for lib, fn, names in (
            ("attention", "icikit_attention_regs",
             ("flash_fwd_bf16<128>", "flash_fwd_f32<128>",
              "decode_step_kernel<bf16>", "flash_bwd_bf16<128>",
              "flash_bwd_f32<128>", "flash_bwd_dq_bf16<128>",
              "flash_bwd_dq_f32<128>", "flash_bwd_dkv_bf16<128>",
              "flash_fwd_bf16<256>", "flash_fwd_f32<256>",
              "flash_bwd_bf16<256>", "flash_bwd_f32<256>",
              "flash_bwd_dq_bf16<256>", "flash_bwd_dq_f32<256>",
              "flash_bwd_dkv_bf16<256>", "flash_bwd_dkv_f32<256>",
              "decode_step_q8_kernel<bf16>",
              "decode_step_q8_kernel<float>",
              "flash_bwd_bf16<32>", "flash_bwd_bf16<64>",
              "flash_bwd_dq_bf16<32>", "flash_bwd_dq_bf16<64>",
              "flash_bwd_dkv_bf16<32>", "flash_bwd_dkv_bf16<64>",
              "flash_fwd_bf16<32>", "flash_fwd_bf16<64>",
              "decode_step_kernel<float>")),
            ("quant", "icikit_quant_regs",
             tuple(f"qmv_bf16_skinny<{cpw}, 1>" for cpw in (1, 2, 4, 8))
             + tuple(f"qmv_bf16_skinny<{cpw}, 2>" for cpw in (1, 2, 4))
             + ("qmv_bf16_tile", "qmv_f32<16, 32>", "qmv_f32<64, 64>")),
            ("xent", "icikit_xent_regs",
             ("xent_fwd_bf16", "xent_dx_bf16", "xent_dw_bf16",
              "xent_fwd_f32", "xent_g_bf16", "xent_g_saved_bf16",
              "xent_recompute_bf16<dx>", "xent_recompute_bf16<dw>",
              "xent_dx_g_bf16", "xent_dw_g_bf16", "xent_merge")),
            ("adam", "icikit_adam_regs",
             ("adam_tree_kernel<f32 moments>",
              "adam_tree_kernel<bf16 moments>",
              "adam_tree_kernel<f32 m, bf16 v>",
              "adam_tree_kernel<bf16 m, f32 v>")),
            ("stack_write", "icikit_stack_regs",
             ("stack_write_kernel", "stack_read_kernel")),
            ("tile_floor", "icikit_tile_floor_regs", TILE_KERNELS),
            ("integrity", "icikit_integrity_regs", INTEGRITY_KERNELS)):
        for which, name in enumerate(names):
            r, loc = ctypes.c_int(), ctypes.c_int()
            _build.check(getattr(libs[lib], fn)(
                which, ctypes.byref(r), ctypes.byref(loc)),
                "kernel attributes")
            regs[name] = {"registers": r.value, "local_bytes": loc.value}
    # the recompute head's clusters (B10): how many the card holds at
    # once at the base width
    clusters = {}
    for side, name in ((1, "xent_dx"), (0, "xent_dw")):
        c, size = ctypes.c_int(), ctypes.c_int()
        _build.check(libs["xent"].icikit_xent_recompute_clusters(
            side, XENT_SHAPE[1], ctypes.byref(c), ctypes.byref(size)),
            "cluster occupancy")
        clusters[name] = {"clusters_resident": c.value,
                          "cluster_size": size.value}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 2),
          "log": {k: {"seconds": round(v["seconds"], 2),
                      "cached": v["cached"]}
                  for k, v in _build.BUILD_LOG.items()},
          "kernels": regs, "recompute_clusters": clusters})
    spilled = {k: regs[k] for k in NO_LOCAL_MEMORY
               if regs[k]["local_bytes"]}
    if spilled:
        raise AssertionError(f"kernels use local memory: {spilled}")

    # -- 3. kernels against their plain versions ------------------------
    gen = torch.Generator(device=dev).manual_seed(1)

    def rand(n, dtype):
        if dtype in (torch.float32, torch.bfloat16):
            return torch.randn(n, generator=gen, device=dev).to(dtype)
        if dtype == torch.uint32:
            return torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                                 dtype=torch.int32, device=dev
                                 ).view(torch.uint32)
        return torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                             dtype=torch.int32, device=dev)

    def same(a, b) -> bool:
        if a.dtype == torch.uint32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if a.dtype in (torch.float32, torch.bfloat16):
            return bool(torch.equal(a.float(), b.float()))
        return bool(torch.equal(a, b))

    def max_err(a, b) -> float:
        if a.dtype == torch.uint32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return float((a.double() - b.double()).abs().max())

    checks = []
    cs.reset_launches()
    t = cs.T_GRID
    log2t = cs.ilog2(t)
    for dtype in (torch.int32, torch.float32):
        x = rand(t, dtype)
        rounds = cs._sort_rounds(log2t)
        got = cs.net_pass(x, t, rounds)
        want = cs.net_pass_plain(x, t, rounds)
        checks.append(("net_pass single tile", str(dtype), t,
                       same(got, want) and same(got, torch.sort(x).values)))
        # a round pass whose direction bit lies above the tile, in place;
        # K2 at G_MAX bits (the top of a 2^26 span), 1 bit and a middle
        # range, merge_only, and in place
        span = 1 << 26
        x = rand(span * 2, dtype)
        rnd = [(27, tuple(t >> i for i in range(1, log2t + 1)))]
        y = x.clone()
        cs.net_pass(y, t, rnd, out=y)
        checks.append(("net_pass round, in place", str(dtype), span * 2,
                       same(y, cs.net_pass_plain(x, t, rnd))))
        top = cs.ilog2(span // t) - 1
        for lo, hi in ((top - cs.G_MAX + 1, top), (0, 0), (3, 6)):
            for mo in (False, True):
                want = cs.cross_pass_plain(x, span, t, lo, hi, mo)
                got = cs.cross_pass(x, span, t, lo, hi, mo)
                y = x.clone()
                cs.cross_pass(y, span, t, lo, hi, mo, out=y)
                checks.append((f"cross_pass bits[{lo},{hi}] merge={mo}, "
                               f"and in place", str(dtype), span * 2,
                               same(got, want) and same(y, want)))
        del x, y, got, want
    for n in (1 << 16, 1 << 20):
        for dtype in (torch.int32, torch.float32, torch.uint32,
                      torch.bfloat16):
            x = rand(n, dtype)
            got = cs.local_sort(x)
            want = cs.local_sort(x, plain=True)
            checks.append(("local_sort", str(dtype), n, same(got, want)))
    for dtype in (torch.int32, torch.float32):
        x = rand(1_000_003, dtype)
        got = cs.local_sort(x)
        checks.append(("local_sort non-pow2", str(dtype), x.numel(),
                       same(got, cs.local_sort(x, plain=True))
                       and same(got, torch.sort(x).values)))
    a = torch.sort(rand(1 << 19, torch.int32)).values
    b = torch.sort(rand(1 << 19, torch.int32), descending=True).values
    v = torch.cat([a, b])
    checks.append(("merge_bitonic", "torch.int32", v.numel(),
                   same(cs.merge_bitonic(v),
                        cs.merge_bitonic(v, plain=True))))
    torch.cuda.synchronize()
    emit({"phase": "kernels",
          "tolerance": "exact: integers bitwise, floats by value",
          "checks": [{"what": w, "dtype": d, "n": n, "ok": ok}
                     for w, d, n, ok in checks],
          "launches": dict(cs.LAUNCHES)})
    bad = [c for c in checks if not c[3]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")

    # -- 4. the main path: sort 2^28 int32 keys, p = 1 -----------------
    n = 1 << 28
    mesh = make_mesh(1, device=dev)
    keys = torch.randint(-2**31, 2**31 - 1, (n,),
                         generator=torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    cs.reset_launches()
    out = sort(keys, mesh, algorithm="bitonic")
    torch.cuda.synchronize()
    main_launches = dict(cs.LAUNCHES)
    inversions = check_sort(out.reshape(1, -1), mesh)
    oracle = torch.sort(keys).values
    equal = bool(torch.equal(out, oracle))
    del oracle
    if inversions != 0 or not equal:
        raise AssertionError(f"main path: {inversions} inversions, "
                             f"equal to oracle: {equal}")
    if main_launches["net"] == 0 or main_launches["cross"] == 0:
        raise AssertionError(f"main path skipped a kernel: {main_launches}")
    del out

    def run(x):
        return sort(x, mesh, algorithm="bitonic")

    res = timeit_windows(run, (keys,), lambda a, o: (o * MULT,),
                         windows=3, runs=2, warmup=1)
    lib_ms = cuda_time_ms(lambda: torch.sort(keys), iters=5, warmup=1)
    per_sort = main_launches["net"] + main_launches["cross"]
    bound_ms = per_sort * 2 * n * 4 / bw * 1e3
    emit({"phase": "main", "n": n, "p": 1, "dtype": "int32",
          "inversions": inversions, "equal_to_oracle": equal,
          "launches_per_sort": main_launches,
          "median_ms": res.median_s * 1e3,
          "spread_ms": [res.min_s * 1e3, res.max_s * 1e3],
          "windows": res.windows, "keys_per_s": n / res.median_s,
          "library_ms": lib_ms, "bound_ms": bound_ms,
          "bound_by": "bytes", "nameplate_Bps": bw})
    main_sort_s = res.median_s

    # -- 5. rank-vectorised sort, p = 2, 4, 8 --------------------------
    ranks = []
    x = keys[: 1 << 24].clone()
    oracle = torch.sort(x).values
    for p in (2, 4, 8):
        cs.reset_launches()
        m = make_mesh(p, device=dev)
        o = sort(x, m, algorithm="bitonic")
        torch.cuda.synchronize()
        inv = check_sort(o.reshape(p, -1), m)
        eq = bool(torch.equal(o, oracle))
        ranks.append({"p": p, "n": x.numel(), "inversions": inv,
                      "equal_to_oracle": eq, "launches": dict(cs.LAUNCHES)})
        if inv != 0 or not eq or cs.LAUNCHES["cross"] == 0:
            raise AssertionError(f"rank sort p={p}: {ranks[-1]}")
    emit({"phase": "ranks", "runs": ranks})

    # -- 6. per-kernel numbers at the main path's shapes ---------------
    log2t = cs.ilog2(cs.T_GRID)
    buf = torch.empty_like(keys)
    rounds = cs._sort_rounds(log2t)
    stages = sum(len(s) for _, s in rounds)
    k1_ms = cuda_time_ms(lambda: cs.net_pass(keys, cs.T_GRID, rounds,
                                             out=buf), iters=10)
    k1_plain_ms = cuda_time_ms(
        lambda: cs.net_pass_plain(keys, cs.T_GRID, rounds), iters=1,
        warmup=1)
    k1_err = max_err(cs.net_pass(keys, cs.T_GRID, rounds, out=buf),
                     cs.net_pass_plain(keys, cs.T_GRID, rounds))
    # K2: the last round's most strided pass, as the schedule splits it
    plan = cs.sort_schedule(n)
    lo, hi = next((s[3], s[4]) for s in plan
                  if s[0] == "cross" and s[1] == n)
    k2_ms = cuda_time_ms(lambda: cs.cross_pass(keys, n, cs.T_GRID, lo, hi,
                                               False, out=buf), iters=10)
    k2_plain_ms = cuda_time_ms(
        lambda: cs.cross_pass_plain(keys, n, cs.T_GRID, lo, hi, False),
        iters=1, warmup=1)
    k2_err = max_err(cs.cross_pass(keys, n, cs.T_GRID, lo, hi, False,
                                   out=buf),
                     cs.cross_pass_plain(keys, n, cs.T_GRID, lo, hi, False))
    torch.cuda.synchronize()

    def bound(n_stages):
        t_bytes = 2 * n * 4 / bw * 1e3
        t_ops = 2 * (n // 2) * n_stages / VECTOR_OPS * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")

    k1_bound, k1_by = bound(stages)
    k2_bound, k2_by = bound(hi - lo + 1)
    if k1_err != 0 or k2_err != 0:
        raise AssertionError(f"kernel error at main shapes: {k1_err} "
                             f"{k2_err}")
    # every launch of the main path's schedule, timed by events between
    # launches (the sort A/B bench's launch loop), summed by kind: the median
    # of three sorts a launch
    calls = sort_ab.plan_calls(_build.load("bitonic_net"), keys, buf, plan)
    sort_ab.timed_sort(calls)
    runs = [sort_ab.timed_sort(calls) for _ in range(3)]
    if not torch.equal(buf, torch.sort(keys).values):
        raise AssertionError("the timed schedule did not sort")
    kinds = sort_ab.by_kind(plan, [sorted(ms)[1] for ms in zip(*runs)], n)
    rows_ms = cuda_time_ms(lambda: torch.sort(keys.view(-1, cs.T_GRID),
                                              dim=-1), iters=3)
    emit({"phase": "timed_launches",
          "net_kernel": f"n=2^28 int32, tile 2^{log2t}, {stages} stages",
          "cross_kernel": f"n=2^28 int32, span 2^28, bits [{lo}, {hi}]",
          "by_kind": kinds, "sorts_ms": [sum(ms) for ms in runs],
          "net_kernel_int32_issue_ms": sort_ab.int32_issue_ms(n, stages),
          "nearest_library_to_the_tile_sort": {
              "call": f"torch.sort(x.view(-1, {cs.T_GRID}), dim=-1)",
              "ms": rows_ms,
              "why": "not the same function: every row ascending"},
          "seconds": round(time.perf_counter() - t_start, 1)})
    rows = [
        {"name": "net_kernel (K1)", "route": "cuda",
         "source": "icikit_torch/csrc/bitonic_net.cu",
         "replaces": "icikit/ops/pallas_sort.py:206",
         "launches": main_launches["net"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "cross_kernel (K2)", "route": "cuda",
         "source": "icikit_torch/csrc/bitonic_net.cu",
         "replaces": "icikit/ops/pallas_sort.py:267",
         "launches": main_launches["cross"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
    ]
    del keys, buf, x, oracle

    # -- 7. attention kernels against their plain versions -------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    attention_checks(torch, dev)

    # -- 8. the decode path: base, b = 8, prompt 512, 64 new -----------
    dec_launches, dec_trace = decode_path(torch, dev, bw, smi)

    # -- 9. per-kernel numbers at the decode path's shapes -------------
    rows += attention_rows(torch, dev, bw, dec_launches, dec_trace)

    # -- 10. train kernels against their plain versions ----------------
    train_kernel_checks(torch, dev)

    # -- 11. the train path: base, b = 8, s = 1024 ---------------------
    cell = train_cell(torch, dev)
    main_arm = train_arm(torch, cell, "default", ARMS["default"], smi)
    if not main_arm["ok"]:
        raise AssertionError(f"train path disagrees with its plain arms or "
                             f"does not learn: {main_arm}")
    train_launches = main_arm["launches_per_step"]

    # -- 12. per-kernel numbers at the train path's shapes -------------
    rows += train_rows(torch, dev, bw, train_launches)

    # -- 13. the train step's other kernels against their plain versions
    rows += train_arm_kernel_checks(torch, dev, bw)

    # -- 14. the train arms: base, b = 8, s = 1024 -----------------------
    rows += train_arms(torch, dev, bw, smi, cell)
    del cell

    # -- 15. the long-context path: s = 32768 and 131072 ----------------
    rows += long_context(torch, dev, bw, smi)

    # -- 16. d = 256: the flash kernels, the step, a generate, a step ----
    wide_head_checks(torch, dev, smi)

    # -- 17. the int8 kernels against their plain versions --------------
    int8_kernel_checks(torch, dev)

    # -- 18. the int8 decode path: base, b = 8, prompt 512, 64 new ------
    q8_launches, q8_trace = int8_decode_path(torch, dev, bw, smi)

    # -- 19. per-kernel numbers at the int8 path's shapes ---------------
    rows += int8_rows(torch, dev, bw, q8_launches, q8_trace)

    # -- 20. B17's kernels against their plain versions ------------------
    tile_floor_kernel_checks(torch, dev)

    # -- 21. the tile-floor path: s = 32768, h 8, d 64 and 128 ----------
    rows += tile_floor_path(torch, dev, bw, smi)

    # -- 22. B16's kernels against their plain versions ------------------
    stack_kernel_checks(torch, dev)

    # -- 23. the save-stack train path: base, b = 8, s = 1024 ----------
    rows += save_stack_path(torch, dev, bw, smi, main_arm["step_ms"])

    # -- 24. the collectives: p = 8 and 6 ------------------------------
    collectives_phase(torch, dev, bw, smi)

    # -- 25. the four-sort study: 2^24 int32 at p = 8, 50M float32 --------
    study = sort_study_phase(torch, dev, smi)
    for row, counter in ((rows[0], "net"), (rows[1], "cross")):
        row["launches_on_sort_paths"] = {
            "bitonic 2^28 int32 p=1 (main)": main_launches[counter],
            **{f"{alg} 2^24 int32 p={STUDY_P}": n[counter]
               for alg, n in study.items()}}

    # -- 26. the checked transport: checksum kernel, drills, overhead ----
    rows.append(integrity_phase(torch, dev, bw, smi))

    # -- 27. the load-balancing study: I2, the schedulers, northstar -----
    rows.append(solitaire_phase(torch, dev, smi))

    # -- 28. the multi-process layer: hierarchical, two processes --------
    from icikit_torch.examples.multihost import SORT_LOG2N as mh_sort_log2n
    mh_launches, mh_cases = multihost_phase(torch, dev, smi)
    for row, counter in ((rows[0], "net"), (rows[1], "cross")):
        row["launches_on_sort_paths"][
            f"bitonic 2^{MH_LOG2N} int32 p=8, two processes (each)"] = \
            mh_launches[counter]
        for case, n in mh_cases.items():
            if "sort" in case:
                row["launches_on_sort_paths"][
                    f"{case} 2^{mh_sort_log2n} int32 p=8, two processes "
                    "(each)"] = n[counter]
    for row in rows:
        if row["name"].startswith("segment_checksum_kernel"):
            row["launches_on_two_processes"] = {
                f"{case}, p=8 (each)": n["segment_checksum"]
                for case, n in mh_cases.items() if "checked" in case}

    # -- 29. the model mesh: dp, tp, sp > 1 on the card ------------------
    mesh_launches = model_mesh_phase(torch, dev, smi)
    for row in rows:
        first = row["name"].split()[0]
        if first in mesh_launches["step"]:
            row["launches_on_model_mesh_step"] = {
                "x".join(map(str, MESH_TIMED)): mesh_launches["step"][first]}
        if first == "segment_checksum_kernel":
            row["launches_on_grad_ring_step"] = mesh_launches["grad_ring"]

    # -- 30. decode on the mesh and sampled decode ------------------------
    dec_mesh = mesh_decode_phase(torch, dev, smi)
    for row in rows:
        first = row["name"].split()[0]
        if row["name"] != "flash_fwd (B3/B5)" and first not in (
                "decode_step", "decode_step_q8", "quant_matvec"):
            continue
        by_mesh = {f"{arm} {m}": n[first] for arm, ms in dec_mesh.items()
                   for m, n in ms.items() if first in n}
        if by_mesh:
            row["launches_on_mesh_generate"] = by_mesh

    # -- 31. the collectives study: scaling, crossover rates, dry run -----
    collectives_study_phase(torch, dev, smi, main_sort_s)

    # -- 32. the kernels line --------------------------------------------
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start,
                                            1)})
    emit({"kernels": rows})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

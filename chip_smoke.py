#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py            # full size (below)
    python3 chip_smoke.py --log2-n 14 --log2-i 13 --log2-jk 9 \
        --log2-dense 10 --reps 4 --attn-layers 2 --attn-seq 512
                                     # a quick rehearsal

Phases, one line each (a failing phase raises and the script exits non-zero):

1. device  — the card's name, count, and ``nvidia-smi`` name and power limit;
             a ``clocks`` line (SM clock, its maximum, power draw,
             temperature) here and after each path and timing phase; the
             read rates of ``torch.sum`` from L2 and from device memory
             (``memory``).
2. build   — ``nvcc`` for ``sm_90a`` over every CUDA source (in parallel),
             with each kernel's registers, shared memory and spills; then
             the HMMA (tensor-core) instructions of each flash kernel in
             the built library's SASS (``cuobjdump -sass``): every bf16
             and f16 instance, and the column-chunk ones, must have some,
             and every f32 one (FFMA on the CUDA cores) none; the split
             sLSTM forward's six instances (``[slstm-registers]``) must
             spill nothing.
3. kernels — each Hopper kernel against its plain PyTorch version on the
             card: first at edge-case shapes (empty rows, an empty piece, a
             row longer than 128 entries, a slice longer than one 256-entry
             segment, J in {1, 16, 130}, K in {1, 4, 7, 8, 16, 32, 33,
             64, 128, 256} (every lane-group size of sddmm_coo) with C
             views 4 bytes off an aligned base at K in {1, 4, 7, 32, 33,
             64} (its scalar kernel), L in {1, 7, 32, 33}; for
             SpAdd3 an empty operand, a row longer than one merge task,
             coordinates in all three operands and sums that cancel to 0,
             shard padding that must not be read, block shapes (2, 2) and
             (4, 4) with a ragged last block column; for the blocked SpMV,
             SpMM and SDDMM an empty piece and block-row, a block-row
             longer than several 128-block segments, runs that start and
             end on segment edges, ids below 0 and padding that must not
             be read, blocks (1, 1), (2, 2), (3, 5), (4, 4), (4, 8),
             (8, 4), (32, 8), (33, 1) and (64, 8) with a ragged last
             block-row and block-column, J in {1, 16, 33}, K in {1, 7,
             32, 33}, and (4, 4) tiles (SpMV, SpMM) and SDDMM's C 4 bytes
             off an aligned base, and block-rows over 70 and 128 segments
             (the fold's 64-segment group sums) at (4, 4) and (3, 5); for
             the SpMM nnz kernel the SpMV nnz and SpMTTKRP streams, runs
             across one and two 256-entry segments, J in {1, 7, 16, 32,
             33, 130}; for the rows kernels' merge-path split (chunks of
             256 items) a row of 60,000 entries among short rows, rows of
             exactly 256 and 257 entries, rows ending on the last item of
             a chunk and on the first of the next, 300 empty rows in a
             row, an empty piece and pieces whose pos[R] lies below the
             padded N, J in {1, 32, 130}; for the SpMV nnz kernel's
             1024-entry blocks runs ending on a block's last entry, of 1024
             and 1025 entries and over six blocks, 1,190 empty rows,
             padding with the dropped id, an empty piece and a piece of
             one row; for the SpMM nnz kernel the same pieces and rows
             over 64, 65, 128 and 129 segments of 256 (its group fold's
             edges), J in {1, 7, 32, 33}, and the SpMTTKRP kernel over
             those rows at L in {1, 32, 33}; for the SpAdd3 rows unions
             rows of nine merge tasks with repeated columns at the split
             values, a column of 901 entries (longer than a task and a
             128-entry window), three identical lists, one list alone
             over two windows, empty rows and pieces, tiles (), (1, 3),
             (3, 2), (2, 2) and (4, 4); for the nnz unions a stream of
             59 runs (not a multiple of 32) among which 40 of 40 entries
             over 8 segments, tiles (), (4, 4) and (3, 5), and (4, 4)
             values 4 bytes off an aligned base;
             for flash_attention every case of
             tests/test_flash_kernel.py with hd 128 added: G in {1, 2, 3,
             4, 8}, ragged S = 100, 200 and 300, f32 and bf16, and the
             bf16 kernel's tile edges S in {1, 15, 17, 65} at hd in
             {16, 32, 64} and G in {1, 3, 8}, and hd 24, 112 (zero-padded
             to 32 and 128) and 256 in f32 and bf16; float16 at the
             llama3-8b layer's heads, tile edges and hd 24, 112 and 256;
             hd 320 (padded to 384) and 512 in all three dtypes; hd
             640, 768 and 1024 in f32 (the f32 cluster kernel) at G 1
             and 3, 2048 (its widest cluster of 128-column blocks),
             2176 and 2432 (blocks of 256 columns, the last one's
             second half past hd), 4096 (its widest) and 4224 (past
             it: the f32 column-chunk kernel); the wide 16-bit kernel's
             tile edges
             at hd 200, 256, 320 and 512 and hd 130 (padded to 256);
             the f32 kernel's tile edges: S one below and one past its
             stacked rows a block (``f32_plan``, held equal to the
             library's ``flash_f32_plan`` at every width in
             ``[f32-plan]``; the cluster kernel's ``f32_cluster_plan``
             in ``[f32-cluster-plan]``) and one past a 64-key stage at
             hd 128, 256 and 512 and G in {1, 3, 8}), later
             at the main path's shapes. Per-entry tolerance
             |got - plain| <= 1e-4 * scale + 1e-6, with ``scale`` the same
             computation on absolute values: f32 sums of up to a million
             terms, taken in a different order. A compressed result must
             have the plain version's pattern exactly. flash_attention is
             held at atol = rtol = 2e-5 in f32 and 3e-2 in bf16 (the
             reference test's) and 1e-2 in f16 (three more mantissa
             bits), and its position 0 must equal v[0].
             Then the sLSTM scan (``slstm_fwd``, and ``slstm_bwd`` under
             autograd) against the plain loop and autograd through it,
             at 2 heads (``SLSTM_CASES``): S in {1, 2, 127} over B in
             {1, 3} and hd in {16, 64, 192, 256} in f32 and bf16, S in
             {1, 127} over B in {1, 3} and hd in {16, 192} in f16, S =
             4096 at hd 192 (B 1 in f32, B 3 in bf16 and f16), hd 640
             (bf16, B 3 and 5: clusters of 16 and of 8), past the
             cluster kernels' 480: the split cluster forward (its plan
             held equal to ``slstm.split_shape``'s in
             ``[slstm-split-plan]``) and the one-block backward, and hd
             1024 (bf16),
             past the split forward's 960: both one-block kernels (each
             case's design checked); a nonzero
             initial state (without gradient at B = 1, as on the
             training path), |c| crossing 1, one gate pre-activation in
             200 above the clamp at 6. y and the final state at atol =
             rtol = 1e-4 in f32, 3e-2 in bf16 and 1e-2 in f16, each
             gradient at 1e-3, 5e-2 and 1e-2 relative Frobenius
             (``[kernels-slstm]``: the worst of each).
4. main    — eleven paths (a-d, f, h, i, g, e, j, then k), each driven
             through the public entry points with the kernel launch counts
             reset just before and read just after; each of the path's
             kernels must have launched (path k's: the sLSTM kernels of
             its part 5 alone).
   a. ``powerlaw_matrix`` (n = m = 2^21, 16 entries per row on average,
      alpha 1.6, seed 0) in CSR on ``Machine(("x", 4))``: SpMV and SpMM
      (J = 32) under the rows and nnz strategies.
   b. SDDMM over the same matrix (K = 32), and SpTTV and SpMTTKRP (L = 32)
      over ``powerlaw_tensor3`` (2^20 x 2^16 x 2^16, 16 entries per slice
      on average, alpha 1.8, seed 0) in CSF, under rows and nnz.
   c. SpAdd3 ``A = B + C + D`` under rows and nnz: over the same matrix B
      with C and D its pattern shifted by 1 and 2 columns (values from
      seeds 1 and 2), and over BCSR((4, 4)) operands of the same side whose
      block pattern is ``powerlaw_matrix`` (side / 4, 4 blocks per
      block-row) and its shifts by 1 and 2 block columns; plus the dense
      sums of ``ops.spadd3_dense`` and ``ops.spadd3_bcsr_dense`` over such
      operands of side 2^15 (the dense output of side 2^21 would be 16 TiB).
   d. The blocked SpMV, SpMM (J = 32) and SDDMM (K = 32) under rows and
      nnz over the add path's BCSR((4, 4)) operand B (1,977,760 stored
      blocks at the default side; its longest block-row 331,322) and the
      matrix path's dense operands.
   f. The machine grids (``core/grid.py``) over the same operands, sizes
      and seeds, nothing cut: on ``Machine(("x", 2), ("y", 2))`` SpMV, SpMM
      and SDDMM over B and over the BCSR((4, 4)) B of path d under
      ``default_grid_schedule`` (2x2 tiles, every tile in one launch of
      the 1-D kernel), SpMV and SpMM under ``default_grid_nnz_schedule``
      (the 1-D nnz kernels at 4 pieces); on ``Machine(("x", 2), ("y", 2),
      ("z", 2))`` SpMTTKRP over the 3-tensor of path b in 2x2x2 bricks,
      SpAdd3 over B and its shifts on the nested column split (the union
      assembled on the host with ``Tensor.from_coo``, as the reference
      does), and SpMM and SDDMM under ``default_replicated_schedule``
      (2x2x2r: one launch per z-slice, two); on ``Machine(("x", 4))``
      SpMV over path d's block pattern stored as compressed-root
      BCSR((4, 4)), b[dcsr], which no leaf iterates: converted to CSR
      (one convert miss cold, one hit warm, one ``fallbacks`` entry), then
      ``spmv_csr_rows``; and ``A(i,j) = B(i,j) * c(j)``, outside the
      emitter table, on the generic path (the interpreter on the card) at
      side 2^10. Each cell's line adds its ``fallbacks`` and its per-axis
      network bytes.
   g. The distributed executor (``repro_torch.distributed``), after the
      sparse paths have freed their data: their operands and float64 host
      products, written once under ``build/spmd/`` as .npy files that the
      ranks memory-map; ranks spawned after the build, sharing the card
      over gloo (a FileStore under ``build/spmd/``, every join timed). Four
      ranks run the 1-D SpMV, SpMM and SDDMM cells over B and over the
      BCSR((4, 4)) B (rows and nnz) on ``Machine(("x", 4))``, the 2x2 grid
      rows SpMV, SpMM, SDDMM and blocked SpMM, the 2x2 nnz SpMV and SpMM
      and the overlapped 2x2 SpMM at two chunks; eight ranks the 2x2x2
      SpMTTKRP bricks and the 2x2x2r SpMM and SDDMM. Each rank lowers each
      cell itself and calls ``to_spmd(k, mesh)()``: the result must be its
      ``k.run()`` bit for bit (on rank 0 also within the tolerance of the
      host product), and the cell's kernel must launch ``launches`` times
      a call on every rank and no other kernel. Rank 0 prints one
      ``[spmd]`` line a cell: the call's host-clock median (max over
      ranks), the rank's kernel alone by CUDA events (one rank at a time;
      min and max over ranks), the blocking gathers' ms, the bytes sent
      and received beside ``k.comm``'s modelled network bytes, whether a
      collective staged through the host, the peak device memory of the
      largest rank. Then, in this process, ``profile_pieces`` over six
      leaves (``[spmd-profile]``) and ``run_overlapped`` on the rows and
      2x2 SpMM at chunks 2 and 4, overlap on and off, bits equal to
      ``k.run()`` (``[spmd-overlap]``). The kernels line adds each
      kernel's launches in the ranks' counted calls as
      ``executor_launches``.
   h. The runtime and sparse serving, after the other sparse paths' kernels
      are timed, over path a's B and path d's BCSR((4, 4)) B with their
      values redrawn as integers in [-3, 3] (seed 7 past the path's), and
      integer c and C (J = 32): sums of such values are exact in f32, so a
      P = 4 -> 3 shrink or an SpMV -> SpMM promotion, which reorder them,
      keep the bits. (1) Recovery, three cells on ``Machine(("x", 4))``:
      spmv/rows, spmm/nnz and spmv_bcsr/rows. Per cell a cold elastic
      lower at P = 4, ``relower(dead=1)`` after it (its ``shard_reuse``)
      and a cold re-lower at P = 3 with nothing cached, each timed; then
      ``run_with_recovery`` for 8 steps, unfaulted and faulted (a device
      loss of piece 1 at step 3, B corrupted at step 5; on the nnz cell
      stragglers on piece 2 at steps 1 and 2 sleeping 0.25 and 1 s, with
      ``StragglerMitigator(4, report_budget=2)``), each from cold caches,
      checkpoints under ``build/recovery/`` every step (every 4 steps for
      SpMM), removed after. The faulted state must be the unfaulted one's
      bits and 36 x the host product's values; one restart, 3 pieces at
      the end, B healed (and its fingerprint its own again), reuse >= 0.5
      on the rows cells, a straggler re-plan on the nnz cell, the three
      splits summing to ``recovery_s``; the cell's kernel launches once a
      ``run()`` (1 + 8 steps, plus the steps replayed from the restored
      checkpoint) and nothing else launches. One ``[recovery]`` line a
      cell: the three lower times, the reuse, the recovery phases, one
      checkpoint's MB and write seconds, the cell's peak device memory
      above what earlier paths hold. (2) ``verify_byte_ledger`` on every
      kernel paths a-d and f lowered (host work, ``[ledger]``), and
      ``smoke_trace`` on the card into ``build/TRACE_smoke.json``,
      validated (``[trace]``: its span counts). (3) ``SparseKernelServer``
      over the integer B with SpMV requests, rows then nnz, ``max_batch``
      8, the default buckets (1, 2 and 4 warmed besides 8): 64 requests of
      2^21 integers, in bursts of 1, 3, 8, 5, 8, 2, 8, 8, 7, 6 and 8, a
      burst a ``step()``. No runner may be built after the warm-up, each
      batch launches its SpMM kernel once, every output must be the
      per-request loop's bits and the first 8 agree with the host. One
      ``[serve]`` line a schedule: requests/s, p50 and p99 latency,
      occupancy, padded-slot waste, MB copied to the card per batch, the
      8-column copy's host-clock ms and the kernel's CUDA-event ms at
      bucket 8. Then ``band_decode_kernel(131072, 128, 8192)`` and
      ``combine_kernel`` over olmoe-1b-7b's router (64 experts, top 8,
      2 x 4096 tokens, a seeded top-k), one batch of 8 each against the
      host (``[band]``, ``[moe]``). The kernels line adds each kernel's
      launches here as ``runtime_launches`` (1, 2) and
      ``serving_launches`` (3).
   i. The autoscheduler, after path h, over the same operands, sizes and
      seeds, nothing cut: ``lower(schedule="auto")`` on ``Machine(("x",
      4))`` with the default ``SearchConfig`` (the model's top 3 lowered
      and timed on the card, a warm-up and 3 calls each) for SpMV and SpMM
      (J = 32) over path a's B, SpMV over path d's BCSR((4, 4)) B (every
      candidate with the tuned tile) and SpMTTKRP (L = 32) over path b's
      3-tensor, each from cold caches. Per cell: ``structural_stats``
      timed alone; the cold lower traced (one tuned miss, one
      ``plan_search.search`` span, the measured candidates its
      ``plan_search.measure`` spans); the warm lower (one tuned hit, no
      search, every cache warm); the winner's ``run()`` median, each call
      launching exactly its kernel ``launches_per_run`` times, its result
      the bits of a hand lower of ``winner.build()`` and checked against
      the host product; then every enumerated point lowered by hand and
      its ``run()`` median. One ``[auto]`` line a cell: the seconds of
      the stats, the cold lower, the search and the warm lower, each
      candidate's model cost and measured seconds, the model's and the
      measured order, the winner, the hand cells' medians and the ratio
      of the winner's to the best; one ``[autosched]`` line with the
      path's seconds and peak memory. The kernels line adds each kernel's
      launches here as ``autosched_launches``.
   e. The attention path, on a card freed of the sparse paths' data:
      llama3-8b at full width (d 4096, 32 heads, 8 KV heads, head_dim 128,
      d_ff 14336, vocab 128256), all 32 layers, bf16 weights from a seeded
      generator on the card (about 16 GB), ``LM.apply(variant="flash",
      last_only=True)`` over a prefill of 2 prompts of 4096 tokens (numpy
      seed 0): the host-clock median of the prefill, tokens/s and the peak
      memory. flash_attention must launch exactly once per layer and apply,
      and nothing else; two prefills must give the same bits. Checks: (a)
      the same weights under ``variant="dense"``, relative Frobenius error
      of the logits <= 5e-2; (b) f32 at full width and 2 layers, flash
      against dense on every position at atol = rtol = 1e-3.
   j. LM decode and serving, after e: (1) the LM ``Server`` on llama3-8b
      at full width and depth, bf16 weights from seed 0 on the card, 8
      slots of 4096 positions, 16 requests drawn as the reference's
      ``main`` draws them (seed 0, prompts of 4-16 tokens), 32 new tokens
      each: requests, tokens, tokens/s, the median and p99 step ms (host
      clock, one sync a step) and the peak memory; every request must get
      32 tokens, a second run the same tokens, and each request that took
      a freed slot, alone in a fresh ``Server`` on the same weights, the
      same tokens; then one step with the cache written in place against
      one on a copy of the whole cache (``[serve-lm]``). (2) Each of the
      ten architectures at full width with bf16 weights from seed 0, its
      depth cut only to fit the card (llama4-scout-17b-a16e to 12 of its
      48 layers; the cut printed): a prefill of 2 x 128 tokens (numpy
      seed 0) through ``LM.apply(variant="flash", last_only=True)``, with
      llava's 576 prefix embeddings and seamless's 1024 encoder frames
      (seed 2); 8 decode steps from an empty cache, twice; two prefills
      and the two decodes must give the same bits, flash_attention must
      launch once per causal self-attention layer and prefill and nothing
      else launch (xlstm-125m: slstm_fwd once per sLSTM layer, 6, a
      prefill and a decode step, and nothing else). Then, its launches not
      counted, one more flash prefill over all positions with every
      flash_attention call held against the plain version on the same q,
      k and v (FLASH_TOL, as phase 3) and every sLSTM scan against the
      plain loop on its own inputs (SLSTM_TOL), and
      its logits against ``variant="dense"`` on the same weights and
      tokens: relative Frobenius error <= 5e-2, or no more than 1.5 times
      the ``chunked`` variant's against dense (printed; zamba2-7b's depth
      and llama4's routing amplify any change of the attention's
      rounding).
      For llama3-8b, zamba2-7b, xlstm-125m, olmoe-1b-7b
      (``moe_capacity_factor=16``) and seamless-m4t-medium, the
      teacher-forced decode over the 128 positions against the forward:
      relative Frobenius error of the logits <= 5e-2 with f32 activations
      over the same weights for all five, and in bf16 for the attention
      stacks (llama3, olmoe, seamless); the bf16 error of the recurrent
      two is printed beside their bf16 forward's against the f32 one.
      One ``[lm]`` line each: weights, init s, prefill and decode-step ms
      (host clock), peak memory.
   k. The training stack, after j (``train_path``): (1) the ``Trainer`` on
      internlm2-1.8b at full width and depth (24 layers, d 2048, 16 heads,
      8 KV heads, head_dim 128, d_ff 8192, vocab 92544; f32 params from
      seed 0 on the card, bf16 activations, remat on), 5 steps of a global
      batch of 8 x 4096 tokens (the reference's train_4k length) in 4
      microbatches from ``Pipeline`` seed 0, the first 5 steps of a
      10,000-step run at peak lr 3e-4 (a 200-step warm-up: lr 1.5e-6 to
      7.5e-6), no checkpoint: one ``[train]`` line a step (loss,
      gnorm, lr, step seconds on the host clock, one sync a step), then
      ``[train-summary]`` (tokens/s over the steps after the first, the peak
      memory, the GiB of parameters and moments). Checks: every loss and
      gnorm finite, the last loss below the first, every attention call
      ``dense`` (24 layers x 4 microbatches x 2 a step: the forward and
      its recomputation) and no kernel of the kernels line launched. (2)
      The f32 twin: internlm2-1.8b at full width and 2 layers, f32
      activations, weights from seed 1 on the card; one ``loss_and_grads``
      on 2 x 256 tokens on the card and on the host's CPU: the loss within
      1e-5 relative, each leaf's gradient within 1e-3 relative Frobenius
      (TF32 off); one ``adamw_update`` on each from the card's gradients:
      new parameters and moments within 1e-6 (``[train-twin]``). (3) The
      reduced config: a ``Trainer`` checkpointing every 2 steps under
      ``build/train/`` runs 4 steps; a second ``Trainer`` on a copy
      resumes at step 4 and draws the same next batch; both run 2 more
      steps, losses within 1e-5 (``[train-restart]``; the directories
      removed after). (4) One step of the reduced config in f32
      activations on a (data=2, model=2) mesh of 4 gloo ranks sharing the
      card, each holding only its planned blocks of the parameters and
      moments, against the same step in this process (the Trainer's
      schedule: lr 1.5e-6): loss, gnorm and the gathered first moments
      within 1e-5 relative, the gathered new parameters within 1e-5, every
      rank's local shapes its spec's blocks (``[train-mesh]``, with the
      largest share of the whole state a rank holds). (5) xlstm-125m at
      full width and depth (12 layers, d 768, 4 heads of 192; f32 params,
      bf16 activations, remat on) through the same Trainer at (1)'s shape,
      the first 3 steps of a 30-step run (peak lr 3e-4 after a 3-step
      warm-up): losses and gnorms finite, the first step's batch taken
      again after the third below its first loss, slstm_fwd launched 6 x
      4 x 2 times a step (forward and remat replay) and slstm_bwd 6 x 4
      (``[train-xlstm]``, ``[train-xlstm-summary]``); its f32 twin at 2
      layers as (2), but with the whole model's card-vs-CPU gradient gap
      reported, not held (the kink of h at |c| = 1 makes it depend on the
      devices' f32 ulps): the card's gradients through the kernels within
      1e-3 of the card's through the plain loop, and each sLSTM scan's
      gradients on the card within 1e-3 of the CPU's from the same inputs
      (``[train-xlstm-twin]``, with the count of c across the kink).
      ``[train-path]`` gives the path's seconds. The last step of (1) and of (5) runs under
      ``FlopCounterMode`` and is left out of the median step time.
   l. The dry-run and the examples, after k (``dryrun_path``): (a)
      ``launch/dryrun.run_card_cell`` on ``meta`` for path 4k's train
      steps (internlm2-1.8b and xlstm-125m, 8 x 4096 in 4 microbatches,
      mesh (1, 1); each counted by the CLI's ``--mesh card`` in a process
      of its own, started before path 4j so that it runs beside 4j and
      4k) and path 4e's flash prefill (llama3-8b, 2 x 4096): the
      predicted peak beside the peak the path measured in this run above
      its base
      (``max_memory_allocated`` less the bytes allocated before it), the
      predicted FLOPs (each train step's must equal ``FlopCounterMode``'s
      count over its last step in 4k), the achieved TFLOP/s and the
      model-FLOPs share (6·N·D or 2·N·D over the step time over 989
      TFLOP/s) (``[dryrun-train]``, ``[dryrun-prefill]``); (b) the
      dry-run CLI on this host for xlstm-125m's four shapes on pod256 in a
      process of its own, started before path 4j so that it
      runs beside 4j and 4k on the card, every cell ok, with its wall
      seconds (``[dryrun-cli]``); (c) the six
      examples of ``repro_torch.examples`` in this process with their own
      asserts (train_e2e 100 steps of its 300), the launches of each
      (``[example]``): quickstart, spmv_distributed and serve_batched must
      launch a Hopper kernel. ``[dryrun-path]`` gives the path's seconds.
   Every sparse cell is lowered cold and warm and run; its result is
   checked per entry against a float64 host computation on the numpy
   arrays (same tolerance form; a SpAdd3 union must have the host union's
   stored coordinates exactly), and the line reports the cold and warm
   lower times, the median ``run()`` time and the peak device memory. Every
   cell must give the same bits on two ``run()``s. The counts are read
   before any other launch: each cell's kernel must have launched exactly
   as often per ``run()`` as its emitter documents (once; once per
   z-slice for the replicated grid cells; never on the generic path) and
   no other kernel at all.
5. timing, after every count is read: the median time of each cell's
   kernel on the cell's own inputs (CUDA events, median of 20), and the
   ``{"kernels": [...]}`` line: per kernel its launches on the main path,
   its time, its bound at these shapes, its plain version's time and one
   PyTorch library call's time on the same inputs (a yardstick only; the
   port never calls it, and for the blocked SpAdd3 kernels none exists),
   and a line for the SpMV rows kernel's second use, SpTTV over the (i, j)
   fibres; then a record per grid cell's kernel at the cell's tile shapes
   (named ``kernel(cell_id)``, with the cell's launches and the 1-D
   path's yardstick). A ``profile`` line per rows cell (spmv/rows, spmm/rows,
   spttv/rows), for spmv/nnz and spmm/nnz (the memset, phase 1, the group
   pass and phase 2), for sddmm/nnz (its one kernel), for spmttkrp/rows
   (the wrapper's zeroing of A, phase 1, the group pass and the edge
   fold), for spmv_bcsr/rows and spmm_bcsr/rows (the wrapper's zeroing,
   phase 1, the group sums and the edge fold), for sddmm_bcsr/nnz (its
   one kernel), for the two SpAdd3 rows unions (bounds and count, fill,
   and the wrapper's torch ops) and the two nnz unions (their one kernel)
   gives the device time of each phase of its kernel
   (``torch.profiler``). The blocked kernels' yardsticks are
   ``torch.sparse`` BSR products and ``sampled_addmm`` over the
   scalarised block pattern.
   The sLSTM kernels at path 4k's shape (xlstm-125m's layer over one
   microbatch: B 2, S 4096, 4 heads of 192, the forward keeping its
   states), a record a dtype (bf16; float16 and f32 as
   ``slstm_fwd(f16)``, ``slstm_fwd(f32)``, ...), each against its plain
   loop on the same inputs, their launches those of paths j and k in
   that dtype as the wrapper counted them (``slstm.ROUTES``, with phase
   3's beside them as ``edge_launches``); the bound is the larger of the
   bytes over 3.35 TB/s and the recurrent products' FLOPs over 67
   TFLOP/s, and ``serial_floor_ms`` beside it is S times one dependent
   step (the record's own kernel, forward or backward, over a single
   (b, head) chain over S); ``library_ms`` null
   (``[slstm-timing]``, with the launch shape: blocks a cluster,
   k-slices, threads). Before
   them ``[cluster-step]``: the exchange alone, hd / C doubles a block at
   C = 2, 4, 8 and 16 over 8 clusters and S steps, by a split cluster
   barrier a step and by st.async counted on mbarriers (the kernels').
   Then phase 3's hd-640 case (B 3, 2 heads, bf16) at S 4096, past the
   cluster kernels' 480 (``slstm_fwd(hd640)``: the split cluster
   forward, with its exchange's ``[cluster-step]`` at its C;
   ``slstm_bwd(hd640)``: the one-block backward), bound as above,
   launches phase 3's at hd 640 (its B 3 and B 5 cases). flash_attention's wrapper counts its launches by dtype and
   padded width (``flash_attention.ROUTES``; ``[flash-launches]`` prints
   paths e's and j's). Its record counts the bf16 launches of paths e and
   j at every width, every call included (j's alone as
   ``lm_launches``). It is timed at the model's layer shapes (q (2, 4096,
   32, 128), k and v (2, 4096, 8, 128)) in bf16 (the record), f32 and f16,
   in f32 at head_dim 64 (path j's seamless-m4t-medium), and at head_dim
   256, 320 and 512 in all three (lines of their own, each with the
   launches of its dtype and width on paths e and j, the f32 twin and
   teacher-forced forwards included, and in phase 3), beside
   ``scaled_dot_product_attention(
   is_causal=True, enable_gqa=True)``; its bound is the causal flops over
   989 TFLOP/s bf16 and f16 (67 f32) against q, k, v and o moved once.

The last line is ``{"ok": true, "device": {...}}``. Without a card, or
without the package beside this file, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import argparse
import atexit
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM bf16 (and fp16) tensor cores, dense
RTOL_ROW, ATOL = 1e-4, 1e-6
AVG_NNZ, PIECES, SPMM_J, SEED = 16, 4, 32, 0    # the main path's cells
LOG2_N, LOG2_I, LOG2_JK, REPS = 21, 20, 16, 20  # its sizes, timed launches
AVG_SLICE, RANK = 16, 32       # powerlaw_tensor3's slices; SDDMM K, MTTKRP L
ADD_BLOCK, AVG_BLOCKS = (4, 4), 4   # the blocked SpAdd3 operands

KERNELS = {
    "spmv_csr_rows": ("src/repro_torch/kernels/csrc/spmv.cu",
                      "src/repro/kernels/spmv.py:72"),
    "spmv_coo_nnz": ("src/repro_torch/kernels/csrc/spmv.cu",
                     "src/repro/kernels/spmv.py:126"),
    "spmm_csr_rows": ("src/repro_torch/kernels/csrc/spmm.cu",
                      "src/repro/kernels/spmm.py:54"),
    "spmm_coo_nnz": ("src/repro_torch/kernels/csrc/spmm.cu",
                     "none; src/repro/kernels/ref.py:106 leaf_spmm_nnz"),
    "sddmm_coo": ("src/repro_torch/kernels/csrc/sddmm.cu",
                  "src/repro/kernels/sddmm.py:45"),
    "spmttkrp_coo": ("src/repro_torch/kernels/csrc/spmttkrp.cu",
                     "src/repro/kernels/spmttkrp.py:70"),
    # the union kernels compute the TPU kernels' sums in compressed form
    "spadd3_dense_rows": ("src/repro_torch/kernels/csrc/spadd3.cu",
                          "src/repro/kernels/spadd3.py:57"),
    "bcsr_spadd3_dense_rows": ("src/repro_torch/kernels/csrc/spadd3.cu",
                               "src/repro/kernels/bcsr.py:214"),
    "spadd3_union_rows": ("src/repro_torch/kernels/csrc/spadd3.cu",
                          "src/repro/kernels/spadd3.py:57"),
    "spadd3_union_nnz": ("src/repro_torch/kernels/csrc/spadd3.cu",
                         "src/repro/kernels/spadd3.py:57"),
    "bcsr_spadd3_union_rows": ("src/repro_torch/kernels/csrc/spadd3.cu",
                               "src/repro/kernels/bcsr.py:214"),
    "bcsr_spadd3_union_nnz": ("src/repro_torch/kernels/csrc/spadd3.cu",
                              "src/repro/kernels/bcsr.py:214"),
    "bcsr_spmv": ("src/repro_torch/kernels/csrc/bcsr.cu",
                  "src/repro/kernels/bcsr.py:68"),
    "bcsr_spmm": ("src/repro_torch/kernels/csrc/bcsr.cu",
                  "src/repro/kernels/bcsr.py:118"),
    "bcsr_sddmm": ("src/repro_torch/kernels/csrc/bcsr.cu",
                   "src/repro/kernels/bcsr.py:160"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:82"),
    # the sLSTM scan and its transpose: a lax.scan, no Pallas kernel
    "slstm_fwd": ("src/repro_torch/kernels/csrc/slstm.cu",
                  "none; src/repro/models/xlstm.py:145 slstm_apply"),
    "slstm_bwd": ("src/repro_torch/kernels/csrc/slstm.cu",
                  "none; src/repro/models/xlstm.py:145 slstm_apply"),
}
MATRIX_CELLS = (("spmv", "rows"), ("spmv", "nnz"), ("spmm", "rows"),
                ("spmm", "nnz"))
SLICE_CELLS = (("sddmm", "rows"), ("sddmm", "nnz"), ("spttv", "rows"),
               ("spttv", "nnz"), ("spmttkrp", "rows"), ("spmttkrp", "nnz"))
# lowered cells, then the dense sums driven through kernels.ops ("ops")
ADD_CELLS = (("spadd3", "rows"), ("spadd3", "nnz"), ("spadd3_bcsr", "rows"),
             ("spadd3_bcsr", "nnz"), ("spadd3_dense", "ops"),
             ("spadd3_bcsr_dense", "ops"))
BLOCKED_CELLS = (("spmv_bcsr", "rows"), ("spmv_bcsr", "nnz"),
                 ("spmm_bcsr", "rows"), ("spmm_bcsr", "nnz"),
                 ("sddmm_bcsr", "rows"), ("sddmm_bcsr", "nnz"))
# the machine grids: (statement, strategy, mesh); "2x2x2r" is the replicated
# 2.5-D schedule, "4x1" the 1-D conversion and generic cells
GRID_CELLS = (("spmv", "rows", "2x2"), ("spmm", "rows", "2x2"),
              ("sddmm", "rows", "2x2"), ("spmv_bcsr", "rows", "2x2"),
              ("spmm_bcsr", "rows", "2x2"), ("sddmm_bcsr", "rows", "2x2"),
              ("spmv", "nnz", "2x2"), ("spmm", "nnz", "2x2"),
              ("spmttkrp", "rows", "2x2x2"), ("spadd3", "rows", "2x2x2"),
              ("spmm", "rows", "2x2x2r"), ("sddmm", "rows", "2x2x2r"),
              ("spmv_bdcsr", "rows", "4x1"), ("generic", "rows", "4x1"))
PATH_CELLS = {"matrix": MATRIX_CELLS, "slice": SLICE_CELLS,
              "add": ADD_CELLS, "blocked": BLOCKED_CELLS, "grid": GRID_CELLS}
# the kernels each path must launch
PATH_KERNELS = {"matrix": ("spmv_csr_rows", "spmv_coo_nnz", "spmm_csr_rows",
                           "spmm_coo_nnz"),
                "slice": ("sddmm_coo", "spmttkrp_coo", "spmv_csr_rows"),
                "add": ("spadd3_union_rows", "spadd3_union_nnz",
                        "bcsr_spadd3_union_rows", "bcsr_spadd3_union_nnz",
                        "spadd3_dense_rows", "bcsr_spadd3_dense_rows"),
                "blocked": ("bcsr_spmv", "bcsr_spmm", "bcsr_sddmm"),
                "grid": ("spmv_csr_rows", "spmm_csr_rows", "sddmm_coo",
                         "bcsr_spmv", "bcsr_spmm", "bcsr_sddmm",
                         "spmv_coo_nnz", "spmm_coo_nnz", "spmttkrp_coo",
                         "spadd3_union_rows"),
                "attention": ("flash_attention",)}
GENERIC_SIDE = 1 << 10     # the generic path's dense output is side²
# the executor path (4g): (statement, strategy, mesh) per rank group; the
# ranks share the card over gloo. "overlap2" is the overlapped grid SpMM at
# two column chunks.
SPMD_CELLS = {
    4: (("spmv", "rows", "4x1"), ("spmv", "nnz", "4x1"),
        ("spmm", "rows", "4x1"), ("spmm", "nnz", "4x1"),
        ("sddmm", "rows", "4x1"), ("sddmm", "nnz", "4x1"),
        ("spmv_bcsr", "rows", "4x1"), ("spmv_bcsr", "nnz", "4x1"),
        ("spmm_bcsr", "rows", "4x1"), ("spmm_bcsr", "nnz", "4x1"),
        ("sddmm_bcsr", "rows", "4x1"), ("sddmm_bcsr", "nnz", "4x1"),
        ("spmv", "rows", "2x2"), ("spmm", "rows", "2x2"),
        ("sddmm", "rows", "2x2"), ("spmm_bcsr", "rows", "2x2"),
        ("spmv", "nnz", "2x2"), ("spmm", "nnz", "2x2"),
        ("spmm", "overlap2", "2x2")),
    8: (("spmttkrp", "rows", "2x2x2"), ("spmm", "rows", "2x2x2r"),
        ("sddmm", "rows", "2x2x2r")),
}
# the parent's single-process cells: profile_pieces' six leaves, and the
# two run_overlapped ones (at chunks 2 and 4, overlap on and off)
SPMD_PROFILED = (("spmv", "rows", "4x1"), ("spmm", "rows", "4x1"),
                 ("spmv", "nnz", "4x1"), ("spmm", "nnz", "4x1"),
                 ("spmv", "rows", "2x2"), ("spmm", "rows", "2x2"))
SPMD_OVERLAPPED = (("spmm", "rows", "4x1"), ("spmm", "rows", "2x2"))
SPMD_KERNELS = ("spmv_csr_rows", "spmv_coo_nnz", "spmm_csr_rows",
                "spmm_coo_nnz", "sddmm_coo", "spmttkrp_coo", "bcsr_spmv",
                "bcsr_spmm", "bcsr_sddmm")
SPMD_EXPRS = ("spmv", "spmm", "sddmm", "spmv_bcsr", "spmm_bcsr",
              "sddmm_bcsr", "spmttkrp")
SPMD_TIMEOUT_S = 420       # a rank group, from spawn to its last exit
SPMD_DIR = ROOT / "build" / "spmd"


def phase(tag: str, /, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def clocks(at: str) -> None:
    """A ``clocks`` line: the card's SM clock and its maximum (MHz), power
    draw (W) and temperature (C) as ``nvidia-smi`` reads them now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader,nounits"], check=True,
        capture_output=True, text=True).stdout.splitlines()[0]
    sm, sm_max, watts, temp = (x.strip() for x in out.split(","))
    phase("clocks", at=at, sm_mhz=sm, sm_max_mhz=sm_max, power_w=watts,
          temp_c=temp)


# ---------------------------------------------------------------------------
# Tolerance and timing
# ---------------------------------------------------------------------------

def check_rows(name: str, got, want, scale) -> float:
    """Per-entry check |got - want| <= RTOL_ROW * scale + ATOL, where
    ``scale`` is the same computation on absolute values; returns the max
    abs error. Computed in float64 on ``got``'s device, in chunks (a dense
    SpAdd3 result holds 2^30 entries)."""
    import torch
    dev = got.device if torch.is_tensor(got) else torch.device("cpu")
    got, want, scale = (torch.as_tensor(x).to(dev)
                        for x in (got, want, scale))
    if got.shape != want.shape or got.shape != scale.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    got, want, scale = (x.reshape(-1) for x in (got, want, scale))
    worst, step = 0.0, 1 << 26
    for lo in range(0, got.numel(), step):
        g, w, sc = (x[lo:lo + step].double() for x in (got, want, scale))
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite values")
        err = (g - w).abs()
        bad = err > RTOL_ROW * sc + ATOL
        if bad.any():
            i = int(bad.nonzero()[0])
            raise AssertionError(
                f"{name}: {int(bad.sum())} entries off; first at flat index "
                f"{lo + i}: got {g[i]} want {w[i]} scale {sc[i]}")
        if err.numel():
            worst = max(worst, float(err.max()))
    return worst


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn):
    """(fn(), its milliseconds by CUDA events): one call, no warm-up."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def time_events(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``reps`` calls, each timed by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def memory_rates(device) -> None:
    """A ``memory`` line: the rate (GB/s) at which ``torch.sum`` reads a
    float32 tensor of 16 MB, which stays in the 50 MB L2, and one of 256 MB,
    which does not, each read 64 times in one call (the sum over dim 1 of
    the tensor expanded, with stride 0, to 64 rows: 1 GB and 16 GB of loads
    behind one launch), and one 2 GB tensor read once. Per call, the median
    of 5 CUDA-event windows of 3 calls after a warm-up. The gather floors
    in PERF.md reckon with these rates."""
    import torch

    def rate(nbytes: int, rows: int) -> float:
        x = torch.ones(nbytes // 4, device=device)
        fn = (lambda: x.expand(rows, x.numel()).sum(1)) if rows > 1 \
            else x.sum
        for _ in range(2):
            fn()
        windows = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                fn()
            end.record()
            end.synchronize()
            windows.append(start.elapsed_time(end) / 3)
        return nbytes * rows / statistics.median(windows) / 1e6

    phase("memory", gb_s_16mb_x64=f"{rate(16 << 20, 64):.1f}",
          gb_s_256mb_x64=f"{rate(256 << 20, 64):.1f}",
          gb_s_2gb=f"{rate(2 << 30, 1):.1f}")


def time_host(fn, device, reps: int, warmup: int = 1,
              budget_s: float = 8.0) -> float:
    """Median milliseconds of up to ``reps`` calls on the host clock, each
    ending in a device synchronize; stops after ``budget_s`` seconds once 3
    calls are timed (a run() with host assembly takes seconds)."""
    for _ in range(warmup):
        fn()
    _sync(device)
    times = []
    t_end = time.perf_counter() + budget_s
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        if len(times) >= 3 and time.perf_counter() > t_end:
            break
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _abs_args(args):
    import torch
    return [a.abs() if torch.is_tensor(a) and a.is_floating_point() else a
            for a in args]


def _unaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes past an aligned
    base (a view off a 16-byte boundary)."""
    import torch
    return torch.empty(t.numel() + 1, device=t.device)[1:].view(t.shape) \
        .copy_(t)


def kernel_cases(rng, device):
    """Edge-case batched inputs per kernel: (label, kernel name, args,
    args with absolute values for the tolerance). Pieces of one batch share
    R and the padded entry count N; one piece of every batch is empty,
    every matrix has an empty row, the (4, 300) one a row longer than 128
    entries; the SpMTTKRP streams have an empty row and rows longer than
    one and than two 256-entry segments."""
    import numpy as np
    import torch

    def csr(n, m, density):
        d = ((rng.random((n, m)) < density)
             * rng.standard_normal((n, m))).astype(np.float32)
        d[rng.integers(0, n)] = 0                                # empty row
        d[rng.integers(0, n)] = rng.standard_normal(m)           # dense row
        rows, cols = np.nonzero(d)
        pos = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=n), out=pos[1:])
        return pos, cols, d[rows, cols]

    def stack(pieces, R, N):
        P = len(pieces)
        pos = np.zeros((P, R + 1), np.int32)
        crd = np.zeros((P, N), np.int32)
        vals = np.zeros((P, N), np.float32)
        for p, (pp, cc, vv) in enumerate(pieces):
            pos[p, :pp.shape[0]] = pp
            pos[p, pp.shape[0]:] = pp[-1]
            crd[p, :cc.shape[0]] = cc
            vals[p, :vv.shape[0]] = vv
        return pos, crd, vals

    def dev(*xs):
        return [torch.as_tensor(x).to(device).contiguous() for x in xs]

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    shapes = [(8, 8), (37, 53), (64, 128), (130, 65), (1, 7), (256, 17),
              (4, 300)]
    for n, m in shapes:
        mats = [csr(n, m, 0.3), (np.zeros(n + 1, np.int64),
                                 np.zeros(0, np.int64),
                                 np.zeros(0, np.float32)), csr(n, m, 0.05)]
        N = max(1, max(x[1].shape[0] for x in mats))
        pos, crd, vals = stack(mats, n, N)
        c = normal(m)
        pos_t, crd_t, vals_t, c_t = dev(pos, crd, vals, c)
        yield (f"spmv_csr_rows {n}x{m}", "spmv_csr_rows",
               (pos_t, crd_t, vals_t, c_t),
               (pos_t, crd_t, vals_t.abs(), c_t.abs()))
        # the nnz kernel's input: row-sorted rebased rows, padding dropped
        rows = np.full((3, N), n, np.int32)
        for p in range(3):
            cnt = int(pos[p, -1])
            rows[p, :cnt] = np.repeat(np.arange(n), np.diff(pos[p]))
        rows_t, = dev(rows)
        yield (f"spmv_coo_nnz {n}x{m}", "spmv_coo_nnz",
               (rows_t, crd_t, vals_t, c_t, n),
               (rows_t, crd_t, vals_t.abs(), c_t.abs(), n))
        for J in (1, 16, 130):
            C_t, = dev(normal(m, J))
            yield (f"spmm_csr_rows {n}x{m} J={J}", "spmm_csr_rows",
                   (pos_t, crd_t, vals_t, C_t),
                   (pos_t, crd_t, vals_t.abs(), C_t.abs()))
            yield (f"spmm_coo_nnz {n}x{m} J={J}", "spmm_coo_nnz",
                   (rows_t, crd_t, vals_t, C_t, n),
                   (rows_t, crd_t, vals_t.abs(), C_t.abs(), n))
        # SDDMM over the same pieces: C shared (nnz) or per piece (rows);
        # every lane-group size (K = 4 .. 256), K % 4 != 0, and C views 4
        # bytes past an aligned base (the scalar kernel)
        srows_t, = dev(np.minimum(rows, n - 1))
        for K, shared in ((1, True), (4, False), (7, False), (8, True),
                          (16, False), (32, True), (33, False), (64, True),
                          (128, False), (256, True)):
            C_t, Dt_t = dev(normal(n, K) if shared else normal(3, n, K),
                            normal(m, K))
            kind = "shared" if shared else "per-piece"
            args = (srows_t, crd_t, vals_t, C_t, Dt_t)
            yield (f"sddmm_coo {n}x{m} K={K} {kind}", "sddmm_coo", args,
                   _abs_args(args))
            if K in (1, 4, 7, 32, 33, 64):
                args = (srows_t, crd_t, vals_t, _unaligned(C_t), Dt_t)
                yield (f"sddmm_coo {n}x{m} K={K} {kind} C at a 4-byte offset",
                       "sddmm_coo", args, _abs_args(args))

    # the rows kernels' merge-path split: chunks of 256 items (row ends and
    # entries)
    pos, crd, vals, m = merge_split_pieces(rng)
    pos_t, crd_t, vals_t, c_t = dev(pos, crd, vals, normal(m))
    yield ("spmv_csr_rows merge-path edges", "spmv_csr_rows",
           (pos_t, crd_t, vals_t, c_t),
           (pos_t, crd_t, vals_t.abs(), c_t.abs()))
    for J in (1, 32, 130):
        C_t, = dev(normal(m, J))
        yield (f"spmm_csr_rows merge-path edges J={J}", "spmm_csr_rows",
               (pos_t, crd_t, vals_t, C_t),
               (pos_t, crd_t, vals_t.abs(), C_t.abs()))
    # the nnz kernel's 1024-entry blocks
    rows, cols, vals, m, R = nnz_split_pieces(rng)
    rows_t, cols_t, vals_t, c_t = dev(rows, cols, vals, normal(m))
    yield ("spmv_coo_nnz block edges", "spmv_coo_nnz",
           (rows_t, cols_t, vals_t, c_t, R),
           (rows_t, cols_t, vals_t.abs(), c_t.abs(), R))
    # the SpMM nnz kernel over the same pieces and over rows whose fold
    # crosses its 64-segment group edges
    grows, gcols, gvals, _, gR = nnz_group_pieces(rng, m=m)
    pieces = {"block edges": (rows_t, cols_t, vals_t, R),
              "group edges": (*dev(grows, gcols, gvals), gR)}
    for J in (1, 7, 32, 33):
        for tag, (r_t, k_t, v_t, max_rows) in pieces.items():
            C_t, = dev(normal(m, J))
            args = (r_t, k_t, v_t, C_t, max_rows)
            yield (f"spmm_coo_nnz {tag} J={J}", "spmm_coo_nnz", args,
                   _abs_args(args))
    # the SpMTTKRP kernel over the group-edge pieces (the same fold)
    r_t, j_t, v_t, max_rows = pieces["group edges"]
    k_t, = dev(rng.integers(0, 37, r_t.shape).astype(np.int32))
    for L in (1, 32, 33):
        C_t, D_t = dev(normal(m, L), normal(37, L))
        args = (r_t, j_t, k_t, v_t, C_t, D_t, max_rows)
        yield (f"spmttkrp_coo group edges L={L}", "spmttkrp_coo", args,
               _abs_args(args))

    # SpMTTKRP streams: three pieces, the middle one empty; row lengths
    # with an empty row, rows across one and two segment edges, a run that
    # starts on a segment edge, and a piece that is one row
    R, J, K = 40, 50, 30
    counts = rng.integers(0, 20, R)
    counts[[3, 7, 8, 20]] = [0, 700, 256, 300]
    lens = [counts, np.zeros(R, np.int64),
            np.bincount([R - 1] * 900, minlength=R)]
    N = int(max(x.sum() for x in lens)) + 5                  # a padding tail
    rows = np.full((3, N), R, np.int32)
    for p, cnt in enumerate(lens):
        rows[p, :cnt.sum()] = np.repeat(np.arange(R), cnt)
    jj = rng.integers(0, J, (3, N)).astype(np.int32)
    kk = rng.integers(0, K, (3, N)).astype(np.int32)
    vals = np.where(rows < R, normal(3, N), 0).astype(np.float32)
    rows_t, jj_t, kk_t, vals_t = dev(rows, jj, kk, vals)
    for L in (1, 7, 32, 33):
        C_t, D_t = dev(normal(J, L), normal(K, L))
        args = (rows_t, jj_t, kk_t, vals_t, C_t, D_t, R)
        yield (f"spmttkrp_coo R={R} N={N} L={L}", "spmttkrp_coo", args,
               _abs_args(args))
        # the same streams through the SpMM nnz kernel: runs across one and
        # two 256-entry segments and starting on a segment edge
        args = (rows_t, jj_t, vals_t, C_t, R)
        yield (f"spmm_coo_nnz R={R} N={N} J={L}", "spmm_coo_nnz", args,
               _abs_args(args))
    yield from spadd3_cases(rng, device)
    yield from bcsr_cases(rng, device)
    yield from flash_cases(rng, device)


def merge_split_pieces(rng, R: int = 700, m: int = 90, pad: int = 37):
    """Four CSR row pieces (pos (4, R+1), crd and vals (4, N), m columns)
    at the edges of the rows kernels' merge-path split into chunks of 256
    items: piece 0 has a row of 60,000 entries (235 chunks, two of
    spmm_csr_rows' 64-chunk group sums among them) and rows of
    exactly 256 and 257 among rows of 0-3; piece 1 is empty; in piece 2
    rows 0 and 1 end on the last item of chunks 0 and 1, then 300 empty
    rows follow; in piece 3 row 0's end is the first item of chunk 1. Every
    piece's pos[R] lies below the padded N; the padding holds value 0 (the
    shards' contract) and out-of-range columns."""
    import numpy as np
    lens = [rng.integers(0, 4, R), np.zeros(R, np.int64),
            rng.integers(0, 3, R), rng.integers(0, 3, R)]
    lens[0][[10, 20, 21]] = [60000, 256, 257]
    lens[2][:302] = [255, 255] + [0] * 300
    lens[3][:2] = [256, 0]
    N = max(int(x.sum()) for x in lens) + pad
    pos = np.zeros((4, R + 1), np.int32)
    crd = np.full((4, N), m + 5, np.int32)
    vals = np.zeros((4, N), np.float32)
    for p, x in enumerate(lens):
        np.cumsum(x, out=pos[p, 1:])
        nnz = int(pos[p, -1])
        crd[p, :nnz] = rng.integers(0, m, nnz)
        vals[p, :nnz] = rng.standard_normal(nnz)
    return pos, crd, vals, m


def nnz_split_pieces(rng, R: int = 2400, m: int = 90, pad: int = 37):
    """Four row-sorted COO pieces (rows, cols, vals (4, N), m columns,
    max_rows R) at the edges of spmv_coo_nnz's 1024-entry blocks (4 entries
    a thread, 128 a warp): in piece 0 row 0 ends on block 0's last entry,
    rows 1 and 2 hold exactly 1024 and 1025 entries, row 5 spans 6,000
    entries (six blocks) and rows 10-1199 are empty (more than 1024 ids in
    a row); piece 1 is empty; in piece 2 row 1 is one entry on block 0's
    last, row 2 crosses into block 2 by one entry, row 3 ends on block 2's
    last entry; piece 3 is one row over all N entries. Pieces 0-2 end in
    padding with the dropped id R, value 0 and out-of-range columns."""
    import numpy as np
    lens = [rng.integers(0, 4, R), np.zeros(R, np.int64),
            rng.integers(0, 3, R)]
    lens[0][:6] = [1024, 1024, 1025, 0, 0, 6000]
    lens[0][10:1200] = 0
    lens[2][:4] = [1023, 1, 1025, 1023]
    N = max(int(x.sum()) for x in lens) + pad
    rows = np.full((4, N), R, np.int32)
    cols = np.full((4, N), m + 5, np.int32)
    vals = np.zeros((4, N), np.float32)
    for p, x in enumerate(lens):
        rows[p, :x.sum()] = np.repeat(np.arange(R), x)
    rows[3] = 7
    for p in range(4):
        nnz = int((rows[p] < R).sum())
        cols[p, :nnz] = rng.integers(0, m, nnz)
        vals[p, :nnz] = rng.standard_normal(nnz)
    return rows, cols, vals, m, R


def nnz_group_pieces(rng, R: int = 300, m: int = 90, pad: int = 37):
    """Four row-sorted COO pieces (rows, cols, vals (4, N), m columns,
    max_rows R) at the edges of spmm_coo_nnz's fold through sums of 64
    segments of 256 entries: in piece p row 1 starts at entry (100, 256,
    16,133, 0)[p] and spans exactly (64, 65, 129, 128)[p] segments (piece
    2's row 0 spans 64 segments itself, and its row 1 folds the whole
    groups 1 and 2 with no head before or after them); short rows follow,
    then padding with the dropped id R, value 0 and out-of-range
    columns."""
    import numpy as np
    seg = 256
    pieces = []
    for start, span in ((100, 64), (256, 65), (63 * seg + 5, 129),
                        (0, 128)):
        end = (start // seg + span - 1) * seg + 17
        lens = np.concatenate([[start, end - start],
                               rng.integers(0, 4, R - 2)])
        pieces.append(np.repeat(np.arange(R, dtype=np.int32), lens))
    N = max(x.shape[0] for x in pieces) + pad
    rows = np.full((4, N), R, np.int32)
    cols = np.full((4, N), m + 5, np.int32)
    vals = np.zeros((4, N), np.float32)
    for p, x in enumerate(pieces):
        rows[p, :x.shape[0]] = x
        cols[p, :x.shape[0]] = rng.integers(0, m, x.shape[0])
        vals[p, :x.shape[0]] = rng.standard_normal(x.shape[0])
    return rows, cols, vals, m, R


def _addends(rng, n, m, tile=()):
    """Three operands' (rows, cols, vals) of an n x m (block) grid with the
    edge cases of SpAdd3: row 1 empty in all three, row 3 longer than two
    256-entry merge tasks, coordinates in all three operands, one in B and
    C whose sum cancels to 0, and operand D empty in rows >= n // 2."""
    import numpy as np
    out = []
    for t in range(3):
        d = rng.random((n, m)) < 0.25
        if n > 3:
            d[1] = False
            d[3] = rng.random(m) < 0.9                 # a long row
        d[0, :5] = True                                # in all three
        if t == 2:
            d[n // 2:] = False
        r, c = np.nonzero(d)
        out.append((r, c, rng.standard_normal((r.shape[0],) + tile)
                    .astype(np.float32)))
    (r0, c0, v0), (r1, c1, v1) = out[:2]
    k0 = np.flatnonzero((r0 == 2) & (c0 == 7))
    k1 = np.flatnonzero((r1 == 2) & (c1 == 7))
    if k0.size and k1.size:
        v1[k1] = -v0[k0]                               # cancels to 0
    return out


def _csr_of(n, rows, cols, vals):
    import numpy as np
    pos = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=n), out=pos[1:])
    return pos, cols.astype(np.int32), vals


def union_task_pieces(rng, tile=(), R: int = 40, m: int = 1000):
    """Three stacked row shards (pos (3, R + 1), crd (3, N_t), vals
    (3, N_t, *tile) per operand B, C, D) at the edges of the rows union's
    merge tasks (256 entries) and its 128-entry windows. Piece 0: row 0
    empty in all three; row 1 three identical column lists; row 2 about
    700 columns a list drawn with repeats from 300 (nine tasks, equal
    columns at the split values); row 3 column 7 held 700 times by B, 200
    by C and once by D (longer than a window; the row's three splits all
    fall after it, so two of its four tasks are empty); row 4 600
    columns in D alone (single-list tasks of two windows); then short rows
    with repeats. Piece 1 is empty; piece 2 has short rows and D empty.
    Each shard ends in padding that must not be read (column 2^30, value
    1e30)."""
    import numpy as np

    def short():
        return np.sort(rng.integers(0, m, rng.integers(0, 6)))

    rows = [[[] for _ in range(R)] for _ in range(3)]     # [piece][row][t]
    same = np.sort(rng.choice(m, 50, replace=False))
    rows[0][0] = [np.zeros(0, np.int64)] * 3
    rows[0][1] = [same] * 3
    rows[0][2] = [np.sort(rng.integers(0, 300, 700 + 3 * t))
                  for t in range(3)]
    rows[0][3] = [np.sort(np.concatenate([np.full(k, 7), short()]))
                  for k in (700, 200, 1)]
    rows[0][4] = [np.zeros(0, np.int64)] * 2 + [np.sort(
        rng.choice(m, 600, replace=False))]
    for r in range(5, R):
        rows[0][r] = [short() for _ in range(3)]
    rows[1] = [[np.zeros(0, np.int64)] * 3 for _ in range(R)]
    rows[2] = [[short(), short(), np.zeros(0, np.int64)] for _ in range(R)]
    out = []
    for t in range(3):
        lens = np.array([[rows[p][r][t].size for r in range(R)]
                         for p in range(3)])
        N = int(lens.sum(1).max()) + 7
        pos = np.zeros((3, R + 1), np.int32)
        np.cumsum(lens, axis=1, out=pos[:, 1:])
        crd = np.full((3, N), 1 << 30, np.int32)
        vals = np.full((3, N) + tile, 1e30, np.float32)
        for p in range(3):
            k = int(pos[p, -1])
            crd[p, :k] = np.concatenate([rows[p][r][t] for r in range(R)])
            vals[p, :k] = rng.standard_normal((k,) + tile)
        out += [pos, crd, vals]
    return out


def union_run_stream(rng, counts, P, shape, tile=(), spread=None):
    """An add stream of P chunks (dim0, dim1 (P, C) int32, nnz_count (P,),
    vals (P, C, *tile) f32) holding counts[i] entries of coordinate i
    (coordinates drawn without repeats from ``shape``): the entries of
    coordinate i go to random chunks, or round-robin over ``spread[i]``
    chunks where that is not 0 (so its run has that many segments), each
    chunk in shuffled order. Padding slots hold coordinate (0, 0) and
    1e30, which must not be read."""
    import numpy as np
    flat = rng.choice(shape[0] * shape[1], len(counts), replace=False)
    coords = np.stack([flat // shape[1], flat % shape[1]], 1)
    chunks = [[] for _ in range(P)]
    for i, c in enumerate(counts):
        for j in range(c):
            p = (j % spread[i] if spread is not None and spread[i]
                 else int(rng.integers(0, P)))
            chunks[p].append(coords[i])
    for ch in chunks:
        rng.shuffle(ch)
    C = max(1, max(len(ch) for ch in chunks)) + 3
    dims = np.zeros((2, P, C), np.int32)
    vals = np.full((P, C) + tuple(tile), 1e30, np.float32)
    count = np.zeros(P, np.int32)
    for p, ch in enumerate(chunks):
        count[p] = len(ch)
        if ch:
            dims[:, p, :len(ch)] = np.asarray(ch).T
            vals[p, :len(ch)] = rng.standard_normal((len(ch),) + tuple(tile))
    return dims[0], dims[1], count, vals


def spadd3_cases(rng, device):
    """SpAdd3 edge cases: the dense kernels on CSR / BCSR operands with a
    ragged last block row and column; the rows union over three pieces
    (the middle one empty, operand D empty in a whole piece, shard padding
    filled with values that would show if read, a row longer than one merge
    task); the nnz runs over an add stream with duplicates inside and
    across chunks and an empty chunk, and over :func:`union_run_stream`'s
    runs of up to 40 entries in 8 segments."""
    import numpy as np
    import torch
    from repro_torch.kernels import spadd3

    def dev(*xs):
        return [torch.as_tensor(x).to(device).contiguous() for x in xs]

    for (n, m), block in (((37, 600), None), ((1, 7), None),
                          ((130, 45), (2, 2)), ((37, 53), (4, 4))):
        br, bc = block or (1, 1)
        tri = [_csr_of(-(-n // br), *x) for x in
               _addends(rng, -(-n // br), -(-m // bc), tuple(block or ()))]
        args = tuple(dev(*(x for t in tri for x in t))) + (n, m)
        name = "bcsr_spadd3_dense_rows" if block else "spadd3_dense_rows"
        yield (f"{name} {n}x{m} block={block}", name, args, _abs_args(args))
    P, R, garbage = 3, 40, 1e30
    for block in (None, (2, 2), (4, 4)):
        tile = tuple(block or ())
        pieces = [_addends(rng, R, 300, tile), None, _addends(rng, R, 300,
                                                               tile)]
        pieces[2][2] = tuple(x[:0] for x in pieces[2][2])   # D empty
        flat = []
        for t in range(3):
            N = max(x[t][0].shape[0] for x in pieces if x) + 7
            pos = np.zeros((P, R + 1), np.int32)
            crd = np.full((P, N), 1 << 30, np.int32)      # never read
            vals = np.full((P, N) + tile, garbage, np.float32)
            for p, x in enumerate(pieces):
                if x is not None:
                    pp, cc, vv = _csr_of(R, *x[t])
                    pos[p], crd[p, :cc.shape[0]] = pp, cc
                    vals[p, :cc.shape[0]] = vv
            flat += dev(pos, crd, vals)
        name = "bcsr_spadd3_union_rows" if block else "spadd3_union_rows"
        yield (f"{name} P={P} R={R} block={block}", name, tuple(flat),
               _abs_args(flat))
        tiles = ((), (1, 3), (3, 2)) if block is None else (block,)
        for tl in tiles:
            flat = dev(*union_task_pieces(rng, tl))
            name = "bcsr_spadd3_union_rows" if tl else "spadd3_union_rows"
            yield (f"{name} task edges tile={tl}", name, tuple(flat),
                   _abs_args(flat))
        # nnz: a 4-chunk add stream, chunk 2 empty, padding garbage
        rr, cc, vv = (np.concatenate(x) for x in zip(*pieces[0]))
        C = -(-rr.shape[0] // 3) + 5
        dims = np.zeros((2, 4, C), np.int32)
        svals = np.full((4, C) + tile, garbage, np.float32)
        counts = np.zeros(4, np.int32)
        for p, (lo, hi) in zip((0, 1, 3), ((0, C - 5), (C - 5, 2 * C - 10),
                                           (2 * C - 10, rr.shape[0]))):
            counts[p] = hi - lo
            dims[0, p, :hi - lo], dims[1, p, :hi - lo] = rr[lo:hi], cc[lo:hi]
            svals[p, :hi - lo] = vv[lo:hi]
        d0, d1, cnt, sv = dev(dims[0], dims[1], counts, svals)
        perm, seg_ptr, run_ptr, _, _ = spadd3.plan_runs(d0, d1, cnt,
                                                        (R, 300))
        args = (sv, perm, seg_ptr, run_ptr)
        name = "bcsr_spadd3_union_nnz" if block else "spadd3_union_nnz"
        yield (f"{name} chunks=4 block={block}", name, args,
               _abs_args(args))
    # the nnz union's warps of 32 runs: U = 59, 40 runs of 40 entries over
    # 8 segments among runs of 1-3 (a warp's walk longer than it stages),
    # tiles (), (4, 4) and (3, 5), and (4, 4) values 4 bytes off an
    # aligned base (the 4-byte kernel)
    counts = np.concatenate([rng.integers(1, 4, 10), [40] * 40,
                             rng.integers(1, 4, 9)])
    spread = np.where(counts == 40, 8, 0)
    for tile in ((), (4, 4), (3, 5)):
        d0, d1, cnt, sv = dev(*union_run_stream(rng, counts, 8, (60, 70),
                                                tile, spread))
        perm, seg_ptr, run_ptr, _, _ = spadd3.plan_runs(d0, d1, cnt, (60, 70))
        name = "bcsr_spadd3_union_nnz" if tile else "spadd3_union_nnz"
        for off in (False, True) if tile == (4, 4) else (False,):
            args = (_unaligned(sv) if off else sv, perm, seg_ptr, run_ptr)
            yield (f"{name} runs=59 over 8 segments tile={tile}"
                   + (" vals at a 4-byte offset" if off else ""), name, args,
                   _abs_args(args))


def long_block_row_pieces(rng, R: int = 8, grid_cols: int = 9,
                          pad: int = 11):
    """Two pieces (brow, bcol (2, N) int32) whose block-row 1 crosses more
    than 64 128-block segments, so the fold folds whole groups of 64: in
    piece 0 it starts at block 37 and ends 5 blocks into segment 69 (70
    segments); in piece 1 it starts on segment 1's first block (its first
    partial is a tail) and fills exactly 128 segments; short runs follow,
    then padding with the dropped id R."""
    import numpy as np
    seg = 128
    lens = [np.concatenate([[37, 69 * seg + 5 - 37],
                            rng.integers(0, 4, R - 2)]),
            np.concatenate([[seg, 128 * seg], rng.integers(0, 4, R - 2)])]
    N = int(max(x.sum() for x in lens)) + pad
    brow = np.full((2, N), R, np.int32)
    for p, x in enumerate(lens):
        brow[p, :x.sum()] = np.repeat(np.arange(R), x)
    bcol = rng.integers(0, grid_cols, brow.shape).astype(np.int32)
    return brow, bcol


def bcsr_cases(rng, device):
    """Blocked SpMV, SpMM and SDDMM edge cases over four pieces per block
    shape ((1, 1), (2, 2), (3, 5), (4, 4), (4, 8), (8, 4), (32, 8), and
    (33, 1) and (64, 8), more than 32 rows or 256 entries), then SpMV and
    SpMM over :func:`long_block_row_pieces` at (4, 4) and (3, 5): piece
    0 holds an empty block-row, a run that ends on the last block of
    segment 0, one that starts on the first block of segment 1 and spans
    four segments, one cut by a segment edge and one that ends on a
    32-block chunk edge inside a segment; piece 1 is empty; piece 2 has a
    run ending on the first chunk edge and a block-row longer than two
    segments; piece 3 starts with 130 dropped ids below 0 (across a
    segment edge), then short runs. Padding slots carry the dropped id R,
    huge block-columns and 1e30 tiles (as do the ids below 0), which must
    not reach a sum. The dense operands are packed from matrices whose
    side is not a multiple of the block (a ragged last block-row and
    block-column). SDDMM also takes a C view 4 bytes off an aligned base
    at (4, 4) and K = 32 (its 4-byte loads), and SpMV and SpMM (4, 4)
    tiles 4 bytes off one (their generic instances)."""
    import numpy as np
    import torch
    from repro_torch.kernels.layout import (pack_mat_inner_blocks,
                                            pack_mat_row_blocks,
                                            pack_vec_blocks)

    def dev(*xs):
        return [torch.as_tensor(x).to(device).contiguous() for x in xs]

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    P, R, grid_cols = 4, 12, 9
    lens = [np.array([3, 0, 125, 400, 128, 7, 0, 2, 7, 30, 0, 5]),
            np.zeros(R, np.int64),
            np.array([0, 32, 300, 0, 0, 0, 0, 0, 0, 0, 2, 0]),
            np.array([1, 2, 3, 0, 5, 1, 1, 0, 0, 9, 33, 4])]
    lead = [0, 0, 0, 130]                        # dropped ids below 0
    N = int(max(x.sum() + a for x, a in zip(lens, lead))) + 9   # padding
    brow = np.full((P, N), R, np.int32)
    bcol = np.full((P, N), 1 << 30, np.int32)
    for p, (cnt, a) in enumerate(zip(lens, lead)):
        brow[p, :a] = -1 - (np.arange(a) < 100)
        brow[p, a:a + cnt.sum()] = np.repeat(np.arange(R), cnt)
        bcol[p, a:a + cnt.sum()] = rng.integers(0, grid_cols, cnt.sum())
    kept = (brow >= 0) & (brow < R)
    for br, bc in ((1, 1), (2, 2), (3, 5), (4, 4), (4, 8), (8, 4), (32, 8),
                   (33, 1), (64, 8)):
        tiles = np.where(kept[:, :, None, None], normal(P, N, br, bc),
                         np.float32(1e30)).astype(np.float32)
        n, m = R * br - 1, grid_cols * bc - 3                  # ragged
        brow_t, bcol_t, tiles_t = dev(brow, bcol, tiles)
        c_t, = dev(pack_vec_blocks(normal(m), grid_cols, bc))
        label = f"P={P} N={N} block=({br}, {bc})"
        yield (f"bcsr_spmv {label}", "bcsr_spmv",
               (brow_t, bcol_t, tiles_t, c_t, R),
               (brow_t, bcol_t, tiles_t.abs(), c_t.abs(), R))
        for J in (1, 16, 33):
            C_t, = dev(pack_mat_row_blocks(normal(m, J), grid_cols, bc))
            yield (f"bcsr_spmm {label} J={J}", "bcsr_spmm",
                   (brow_t, bcol_t, tiles_t, C_t, R),
                   (brow_t, bcol_t, tiles_t.abs(), C_t.abs(), R))
        if (br, bc) == (4, 4):        # tiles 4 bytes off an aligned base
            t_off = _unaligned(tiles_t)
            yield (f"bcsr_spmm {label} J=33 tiles at a 4-byte offset",
                   "bcsr_spmm", (brow_t, bcol_t, t_off, C_t, R),
                   (brow_t, bcol_t, t_off.abs(), C_t.abs(), R))
        # SDDMM reads every slot: zero tiles on the padding, as the shards
        for K, shared in ((1, True), (7, False), (32, True), (33, False)):
            Cm = pack_mat_row_blocks(normal(n, K), R, br).reshape(R * br, K)
            if not shared:
                Cm = np.stack([pack_mat_row_blocks(normal(n, K), R, br)
                               .reshape(R * br, K) for _ in range(P)])
            Dt = pack_mat_inner_blocks(normal(K, m), grid_cols, bc) \
                .transpose(0, 2, 1).reshape(grid_cols * bc, K)
            args = tuple(dev(brow, bcol, np.where(tiles < 1e29, tiles, 0),
                             Cm, Dt))
            kind = "shared" if shared else "per-piece"
            yield (f"bcsr_sddmm {label} K={K} {kind}", "bcsr_sddmm", args,
                   _abs_args(args))
            if K == 32 and (br, bc) == (4, 4):   # its 4-byte-load path
                args = (*args[:3], _unaligned(args[3]), args[4])
                yield (f"bcsr_sddmm {label} K={K} {kind} C at a 4-byte "
                       "offset", "bcsr_sddmm", args, _abs_args(args))
        if (br, bc) == (4, 4):    # the (4, 4) SpMV instance's 4-byte twin
            t_off = _unaligned(tiles_t)
            yield (f"bcsr_spmv {label} tiles at a 4-byte offset",
                   "bcsr_spmv", (brow_t, bcol_t, t_off, c_t, R),
                   (brow_t, bcol_t, t_off.abs(), c_t.abs(), R))
    # block-rows over 70 and 128 segments: the fold's group sums
    R, grid_cols = 8, 9
    lbrow, lbcol = long_block_row_pieces(rng, R, grid_cols)
    for br, bc in ((4, 4), (3, 5)):
        brow_t, bcol_t, tiles_t = dev(lbrow, lbcol,
                                      normal(*lbrow.shape, br, bc))
        c_t, = dev(normal(grid_cols, bc))
        label = f"long block-rows block=({br}, {bc})"
        yield (f"bcsr_spmv {label}", "bcsr_spmv",
               (brow_t, bcol_t, tiles_t, c_t, R),
               (brow_t, bcol_t, tiles_t.abs(), c_t.abs(), R))
        for J in (1, 33):
            C_t, = dev(normal(grid_cols, bc, J))
            yield (f"bcsr_spmm {label} J={J}", "bcsr_spmm",
                   (brow_t, bcol_t, tiles_t, C_t, R),
                   (brow_t, bcol_t, tiles_t.abs(), C_t.abs(), R))


# tests/test_flash_kernel.py's cases (B, S, H, Hkv, hd) and dtypes, with
# hd 128 added: G in {1, 2, 3, 4, 8}, ragged S = 200 and 100; then the bf16
# kernel's tile edges: S shorter than a warp's 16 rows, one past them and
# one past a 64-key stage, at G in {1, 3, 8} (3 leaves stacked rows unused);
# then widths outside the instances (24, zamba2-7b's 112: zero-padded to 32
# and 128) and 256 (the wide 16-bit kernel's narrowest), in both dtypes;
# then float16 (the
# f16 instances of the tensor-core kernel): the llama3-8b layer's heads
# (32 / 8, hd 128), tile edges at G in {1, 3}, and hd 24, 112, 256; then
# hd 320 (padded to 384) and 512 in all three dtypes (the wide 16-bit
# kernel, the f32 kernel's own instances); then the causal attention heads
# of path 4j's architectures at a ragged length past two 64-key stages;
# then f32 past 512 (flash_f32_cluster_kernel, a cluster of hd / 128
# blocks) at hd 640, 768 and 1024 and G 1 and 3, at 2048 (the widest
# cluster of 128-column blocks), at 2176 and 2432 at G 1 and 3 (blocks of
# 256 columns, the last one's second half past hd), at 4096 (its widest)
# and at 4224, past it (the f32 column-chunk kernel); then the wide 16-bit
# kernel's tile edges (flash_mma_wide_kernel at 256, 384 and 512): S one
# below, at and one past 16 rows, a 32-row group, 64 keys and a 128-key
# tile, at G in {1, 3, 8}, hd 200 and 256 (rows read unpadded), 320 and
# 512 in bf16 and f16, and hd 130 (zero-padded to 256); then hd 640 in bf16
# and f16 (the 16-bit column-chunk kernel) at G 1 and 3; last, the f32
# kernel's tile edges (:func:`f32_edge_cases`). Every case is launched
# twice and must repeat bit for bit.
WIDE16_EDGE_CASES = tuple(
    (1, S, 2 * G, 2, hd, dt) for hd in (200, 256, 320, 512)
    for dt in ("bfloat16", "float16")
    for S in (15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129)
    for G in (1, 3, 8)) + tuple(
    (1, S, 2 * G, 2, 130, dt) for dt in ("bfloat16", "float16")
    for S in (17, 129) for G in (1, 3)) + tuple(
    (1, 130, 2 * G, 2, 640, dt) for dt in ("bfloat16", "float16")
    for G in (1, 3))
ARCH_HEADS = ((16, 8, 128), (40, 8, 128), (56, 8, 128), (16, 16, 128),
              (48, 4, 128), (32, 32, 112))
# (H, Hkv, hd): internlm2; llama4 and qwen3; llava; olmoe; starcoder2;
# zamba2 (llama3's heads are above)
FLASH_CASES = ((2, 256, 4, 2, 32, "float32"), (1, 200, 8, 8, 16, "float32"),
               (2, 384, 6, 2, 64, "float32"), (1, 128, 16, 2, 32, "float32"),
               (2, 256, 4, 2, 64, "bfloat16"), (1, 100, 2, 1, 16, "float32"),
               (2, 200, 8, 2, 128, "float32"), (2, 200, 8, 2, 128, "bfloat16"),
               (1, 300, 32, 8, 128, "float32"),
               (1, 300, 32, 8, 128, "bfloat16")) + tuple(
    (1, S, 2 * G, 2, hd, "bfloat16") for S in (1, 15, 17, 65)
    for hd in (16, 32, 64) for G in (1, 3, 8)) + tuple(
    (1, 200, 8, 2, hd, dt) for hd in (24, 112, 256)
    for dt in ("float32", "bfloat16")) + (
    (1, 300, 32, 8, 128, "float16"), (2, 256, 4, 2, 64, "float16")) + tuple(
    (1, S, 2 * G, 2, 32, "float16") for S in (1, 17, 65) for G in (1, 3)) \
    + tuple((1, 200, 8, 2, hd, "float16") for hd in (24, 112, 256)) + tuple(
    (1, 200, 8, 2, hd, dt) for hd in (320, 512)
    for dt in ("float32", "bfloat16", "float16")) + tuple(
    (1, 130, H, Hkv, hd, "bfloat16") for H, Hkv, hd in ARCH_HEADS) + tuple(
    (1, 130, 2 * G, 2, hd, "float32") for hd in (640, 768, 1024)
    for G in (1, 3)) + (
    (1, 130, 2, 1, 2048, "float32"), (1, 70, 2, 1, 2176, "float32"),
    (1, 130, 6, 2, 2176, "float32"), (1, 70, 6, 2, 2432, "float32"),
    (1, 70, 2, 1, 4096, "float32"), (1, 70, 2, 1, 4224, "float32")) \
    + WIDE16_EDGE_CASES
F32_EDGE_WIDTHS = (128, 256, 512)


def f32_edge_cases() -> tuple:
    """The f32 kernel's tile edges at hd in F32_EDGE_WIDTHS: S one below
    and one past a block's stacked rows (``f32_plan``'s BM, the kernel's
    rule) and one past a 64-key stage, at G in {1, 3, 8} (3 leaves stacked
    rows unused)."""
    from repro_torch.kernels.flash_attention import f32_plan
    return tuple(
        (1, S, 2 * G, 2, hd, "float32") for hd in F32_EDGE_WIDTHS
        for S in sorted({f32_plan(hd)["BM"] - 1, f32_plan(hd)["BM"] + 1, 65})
        for G in (1, 3, 8))


def check_f32_plan() -> dict:
    """The built library's F32Plan (``flash_f32_plan``) against the
    wrapper's mirror ``f32_plan`` at every f32 width; returns {hd: BM}."""
    from repro_torch.kernels.flash_attention import (F32_WIDTHS, f32_plan,
                                                     f32_plan_card)
    out = {}
    for hd in F32_WIDTHS:
        card, mirror = f32_plan_card(hd), f32_plan(hd)
        if any(mirror[key] != n for key, n in card.items()):
            raise AssertionError(f"f32 flash hd {hd}: the library's plan "
                                 f"{card} is not f32_plan's {mirror}")
        out[hd] = card["BM"]
    return out


# the f32 cluster kernel's widths held in [f32-cluster-plan]: hd 640 (the
# timed width), 1024 (the widest portable cluster, 8 blocks), 2048 (16
# blocks of 128 columns), 2176 (the timed width past it: 9 blocks of 256)
# and 4096 (its widest, 16 blocks of 256)
F32_CLUSTER_WIDTHS = (640, 1024, 2048, 2176, 4096)


def check_f32_cluster_plan() -> dict:
    """The built library's ClusterPlan (``flash_f32_cluster_plan``) against
    the wrapper's mirror ``f32_cluster_plan`` at F32_CLUSTER_WIDTHS;
    returns {hd: clusters of hd / 128 blocks the card holds at once},
    each at least 1."""
    from repro_torch.kernels.flash_attention import (f32_cluster_plan,
                                                     f32_cluster_plan_card)
    out = {}
    for hd in F32_CLUSTER_WIDTHS:
        card, mirror = f32_cluster_plan_card(hd), f32_cluster_plan(hd)
        if any(mirror[key] != n for key, n in card.items()
               if key != "resident") or card["resident"] < 1:
            raise AssertionError(f"f32 cluster flash hd {hd}: the library's "
                                 f"plan {card} is not f32_cluster_plan's "
                                 f"{mirror}, or no cluster is resident")
        out[hd] = card["resident"]
    return out
# atol = rtol; f16 keeps three more mantissa bits than bf16
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2, "float16": 1e-2}


def flash_cases(rng, device):
    """flash_attention's edge cases: standard-normal q, k, v (made in
    float32 and cast) per FLASH_CASES, then :func:`f32_edge_cases`."""
    import numpy as np
    import torch
    for B, S, H, Hkv, hd, dt in FLASH_CASES + f32_edge_cases():
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=getattr(torch, dt))
            for shape in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
        yield (f"flash_attention B={B} S={S} H={H} Hkv={Hkv} hd={hd} {dt}",
               "flash_attention", (q, k, v), None)


def compare_flash(label, got, want, q, v) -> float:
    """flash_attention's result against its plain version's, entry by entry
    at FLASH_TOL (atol = rtol) of q's dtype, and its first position against
    v there (row 0 attends only to itself); returns the max abs error."""
    import torch
    tol = FLASH_TOL[str(q.dtype).split(".")[-1]]
    if got.shape != want.shape or got.dtype != q.dtype:
        raise AssertionError(f"{label}: {tuple(got.shape)} {got.dtype}, "
                             f"want {tuple(want.shape)} {q.dtype}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{label}: non-finite values")
    err = (g - w).abs()
    bad = err > tol + tol * w.abs()
    if bad.any():
        raise AssertionError(f"{label}: {int(bad.sum())} entries off by up "
                             f"to {float(err.max())} (tolerance {tol})")
    G = q.shape[2] // v.shape[2]
    first = v[:, 0].float().repeat_interleave(G, dim=1)
    if not torch.allclose(g[:, 0], first, atol=1e-5, rtol=1e-5):
        raise AssertionError(f"{label}: position 0 is not v[0]")
    return float(err.max()) if err.numel() else 0.0


def flash_kernel_name(symbol: str):
    """The short name of a flash kernel's mangled symbol, or None:
    ``mma_hd<d>_<bf16|f16>`` and ``f32_hd<d>`` (flash_mma_kernel,
    flash_f32_kernel), ``mma_wide<W>_<bf16|f16>`` (flash_mma_wide_kernel),
    ``f32_cluster<BW>`` (flash_f32_cluster_kernel<BW>),
    ``mma_chunk_<bf16|f16>`` and ``f32_wide`` (the column-chunk kernels
    past hd 512 and, in f32, 4096)."""
    import re
    kind = re.search(r"flash_(mma|f32)_(?:(wide|chunk|cluster)_)?kernelI?"
                     r"(?:Li(\d+)E)?(13__nv_bfloat16|6__half)?", symbol)
    if not kind:
        return None
    route, variant, width, dtype = kind.groups()
    return (f"{route}_{variant or 'hd'}{width or ''}"
            + {None: "", "13__nv_bfloat16": "_bf16",
               "6__half": "_f16"}[dtype])


# the flash library's kernels by flash_kernel_name: every instance
FLASH_KERNELS = tuple(
    [f"mma_hd{d}_{t}" for d in (16, 32, 64, 128) for t in ("bf16", "f16")]
    + [f"f32_hd{d}" for d in (16, 32, 64, 128, 256, 384, 512)]
    + [f"mma_wide{w}_{t}" for w in (256, 384, 512) for t in ("bf16", "f16")]
    + ["f32_cluster128", "f32_cluster256", "mma_chunk_bf16",
       "mma_chunk_f16", "f32_wide"])
# the kernels whose build must spill nothing (checked in [flash-registers])
NO_SPILL = tuple(f for f in FLASH_KERNELS
                 if f.startswith(("mma_wide", "f32_cluster")))


def hmma_counts(lib):
    """{kernel: tensor-core (HMMA) instructions} in the SASS of the built
    flash library (``cuobjdump -sass``), by :func:`flash_kernel_name`
    (other functions by their symbol); each kernel of FLASH_KERNELS must
    appear once."""
    import re
    from repro_torch.kernels._build import nvcc_path
    tool = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            name = flash_kernel_name(fn.group(1)) or fn.group(1)
            if name in counts:
                raise AssertionError(f"two SASS functions named {name}")
            counts[name] = 0
        elif name and re.search(r"/\*[0-9a-f]+\*/\s+HMMA", line):
            counts[name] += 1
    missing = set(FLASH_KERNELS) - set(counts)
    extra = {f for f in counts if f.startswith(("mma_", "f32_"))} \
        - set(FLASH_KERNELS)
    if missing or extra:
        raise AssertionError(f"flash kernels not in the SASS: "
                             f"{sorted(missing)}; in it and not in "
                             f"FLASH_KERNELS: {sorted(extra)}")
    return counts


def slstm_split_name(symbol: str):
    """``fwd_split_<f32|bf16|f16>`` for the mangled symbol of a split sLSTM
    forward (``slstm_fwd_cluster<T, KT, true>``), or None."""
    import re
    kind = re.search(r"slstm_fwd_clusterI(f|13__nv_bfloat16|6__half)"
                     r"Li\d+ELb1EE", symbol)
    if not kind:
        return None
    return "fwd_split_" + {"f": "f32", "13__nv_bfloat16": "bf16",
                           "6__half": "f16"}[kind.group(1)]


# the split sLSTM forward's instances, one a dtype, which must spill
# nothing ([slstm-registers])
SLSTM_SPLIT_KERNELS = tuple(f"fwd_split_{t}" for t in ("f32", "bf16",
                                                       "f16"))


def ptxas_usage(log: str, name_of=flash_kernel_name) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} from a
    build's ``ptxas -v`` output, by ``name_of`` (a symbol's short name, or
    None to skip it)."""
    import re
    out, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name, spills = name_of(entry.group(1)), (0, 0)
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            spills = (int(spill.group(1)), int(spill.group(2)))
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            out[name] = (int(used.group(1)), *spills)
            name = None
    return out


def kernel_fns():
    from repro_torch.kernels import (bcsr, flash_attention, sddmm, spadd3,
                                     spmm, spmttkrp, spmv)
    return {
        "spmv_csr_rows": (spmv.spmv_csr_rows, spmv.spmv_csr_rows_plain),
        "spmv_coo_nnz": (spmv.spmv_coo_nnz, spmv.spmv_coo_nnz_plain),
        "spmm_csr_rows": (spmm.spmm_csr_rows, spmm.spmm_csr_rows_plain),
        "spmm_coo_nnz": (spmm.spmm_coo_nnz, spmm.spmm_coo_nnz_plain),
        "sddmm_coo": (sddmm.sddmm_coo, sddmm.sddmm_coo_plain),
        "spmttkrp_coo": (spmttkrp.spmttkrp_coo,
                         spmttkrp.spmttkrp_coo_plain),
        "spadd3_dense_rows": (spadd3.spadd3_dense_rows,
                              spadd3.spadd3_dense_rows_plain),
        "bcsr_spadd3_dense_rows": (spadd3.bcsr_spadd3_dense_rows,
                                   spadd3.bcsr_spadd3_dense_rows_plain),
        "spadd3_union_rows": (spadd3.spadd3_union_rows,
                              spadd3.spadd3_union_rows_plain),
        "bcsr_spadd3_union_rows": (spadd3.bcsr_spadd3_union_rows,
                                   spadd3.bcsr_spadd3_union_rows_plain),
        "spadd3_union_nnz": (spadd3.spadd3_union_nnz,
                             spadd3.union_runs_plain),
        "bcsr_spadd3_union_nnz": (spadd3.bcsr_spadd3_union_nnz,
                                  spadd3.union_runs_plain),
        "bcsr_spmv": (bcsr.bcsr_spmv, bcsr.bcsr_spmv_plain),
        "bcsr_spmm": (bcsr.bcsr_spmm, bcsr.bcsr_spmm_plain),
        "bcsr_sddmm": (bcsr.bcsr_sddmm, bcsr.bcsr_sddmm_plain),
        "flash_attention": (flash_attention.flash_attention,
                            flash_attention.flash_attention_plain),
    }


def compare_kernel(label, name, args, abs_args) -> float:
    """A kernel's result against its plain version's on the same inputs.
    A compressed result (pos, crd, vals) must have the plain version's
    pattern exactly; the values are held to the per-entry tolerance
    (flash_attention's to its own, :func:`compare_flash`)."""
    import torch
    kernel, plain = kernel_fns()[name]
    got = kernel(*args)
    want = plain(*args)
    if name == "flash_attention":
        _sync(got.device)
        err = compare_flash(label, got, want, args[0], args[2])
        if not torch.equal(got, kernel(*args)):
            raise AssertionError(f"{label}: a second launch gave other "
                                 "bits")
        return err
    scale = plain(*abs_args)
    if isinstance(got, tuple):
        for g, w in zip(got[:-1], want[:-1]):
            if not torch.equal(g.long(), w.long()):
                raise AssertionError(f"{label}: the pattern differs from "
                                     "the plain version's")
        got, want, scale = got[-1], want[-1], scale[-1]
    _sync(got.device)
    return check_rows(label, got, want, scale)


# the sLSTM scan's edge cases, (B, S, hd, dtype) at SLSTM_HEADS heads: S in
# {1, 2, 127} over B in {1, 3}, every hd (192 is xlstm-125m's, on a
# cluster of slstm.plan's C blocks a recurrence; 16 takes one block; 256
# the widest phase 3 sends to the cluster kernels) in f32 and bf16;
# float16 at S in {1, 127}, B in {1, 3} and hd in {16, 192}; S = 4096 at
# the model's hd, B 1 in f32 and B 3 in bf16 and f16; then hd 640, past
# the cluster kernels' limit (480, csrc/slstm.cu kClusterMaxHd), which
# launches the split cluster forward (up to kSplitMaxHd, 960) and the
# one-block backward, at B 3 (6 chains: clusters of 16 on the H100) and
# B 5 (10 chains: the rule halves C to 8), and hd 1024, past the split
# forward's limit, which launches both one-block kernels
SLSTM_HEADS = 2
SLSTM_CASES = tuple((B, S, hd, dt) for S in (1, 2, 127) for B in (1, 3)
                    for hd in (16, 64, 192, 256)
                    for dt in ("float32", "bfloat16")) + tuple(
    (B, S, hd, "float16") for S in (1, 127) for B in (1, 3)
    for hd in (16, 192)) + (
    (1, 4096, 192, "float32"), (3, 4096, 192, "bfloat16"),
    (3, 4096, 192, "float16"), (3, 127, 640, "bfloat16"),
    (5, 127, 640, "bfloat16"), (1, 127, 1024, "bfloat16"))
# y and the final (c, h): atol = rtol; each gradient: relative Frobenius.
# float16 keeps three more mantissa bits than bf16: 1e-2 for both
SLSTM_TOL = {"float32": 1e-4, "bfloat16": 3e-2, "float16": 1e-2}
SLSTM_GRAD_TOL = {"float32": 1e-3, "bfloat16": 5e-2, "float16": 1e-2}
SLSTM_INPUTS = ("zx", "ip", "fp", "op", "r", "c0", "h0")


def slstm_inputs(rng, B: int, S: int, H: int, hd: int, dtype: str, device,
                 grad: bool = True):
    """The scan's inputs, standard normal from ``rng`` unless said: zx in
    ``dtype``; ip with one entry in 200 raised above the clamp at 6; fp
    centred on 1; r scaled by hd ** -0.5 (the model's init); a nonzero
    initial state, c0 of scale 2 so that |c| crosses 1."""
    import numpy as np
    import torch
    d = H * hd

    def t(a, dt="float32"):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device=device, dtype=getattr(torch, dt)).requires_grad_(grad)
    ip = rng.standard_normal((B, S, d))
    hot = rng.random((B, S, d)) < 5e-3
    ip[hot] = 6.0 + 3.0 * rng.random(int(hot.sum()))
    return [t(rng.standard_normal((B, S, d)), dtype), t(ip),
            t(rng.standard_normal((B, S, d)) + 1.0),
            t(rng.standard_normal((B, S, d))),
            t(rng.standard_normal((H, hd, hd)) * hd ** -0.5),
            t(rng.standard_normal((B, d)) * 2.0),
            t(rng.standard_normal((B, d)))]


def slstm_check(label: str, ins, rng) -> dict:
    """``slstm_scan`` on the card (``slstm_fwd``, then ``slstm_bwd`` under
    autograd) against the plain loop on the same inputs and autograd
    through it: y and the final (c, h) entry by entry at SLSTM_TOL of the
    dtype (atol = rtol), the gradients of a random weighting of y, c and h
    with respect to every input at SLSTM_GRAD_TOL (relative Frobenius).
    Returns the worst of each."""
    import numpy as np
    import torch
    from repro_torch.kernels import slstm as K
    dt = str(ins[0].dtype).split(".")[-1]
    tol = SLSTM_TOL[dt]
    B, S, d = ins[0].shape
    w = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
         .to(ins[0].device) for shape in ((B, S, d), (B, d), (B, d))]

    need = [t for t in ins if t.requires_grad]

    def run(fn):
        y, c, h = fn(*ins)[:3]
        loss = ((y.float() * w[0]).sum() + (c * w[1]).sum()
                + (h * w[2]).sum())
        return (y, c, h), torch.autograd.grad(loss, need)
    got, g_got = run(K.slstm_scan)
    want, g_want = run(K.slstm_scan_plain)
    _sync(ins[0].device)
    out = {}
    for name, a, b in zip(("y", "c", "h"), got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{label}: {name} {tuple(a.shape)} "
                                 f"{a.dtype}, want {tuple(b.shape)} "
                                 f"{b.dtype}")
        a, b = a.detach().float(), b.detach().float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{label}: non-finite {name}")
        err = (a - b).abs()
        bad = err > tol + tol * b.abs()
        if bad.any():
            raise AssertionError(f"{label}: {name}: {int(bad.sum())} "
                                 f"entries off by up to {float(err.max())} "
                                 f"(tolerance {tol})")
        out[name] = float(err.max()) if err.numel() else 0.0
    names = [n for n, t in zip(SLSTM_INPUTS, ins) if t.requires_grad]
    for name, a, b in zip(names, g_got, g_want):
        rel = _rel(a.float(), b.float())
        if not rel <= SLSTM_GRAD_TOL[dt]:
            raise AssertionError(f"{label}: d{name} relative Frobenius "
                                 f"{rel} > {SLSTM_GRAD_TOL[dt]}")
        out["d" + name] = rel
    return out


def slstm_checks(rng, device, cases=SLSTM_CASES, by_width=None) -> dict:
    """Phase 3 for the sLSTM scan: :func:`slstm_check` over ``cases``; at
    B = 1 the initial state takes no gradient (the training path's zero
    state: the backward skips dh0's product). On the card each case must
    launch one forward and one backward in its dtype, of the design
    ``slstm.plan`` names for its width (the cluster kernels up to hd 480,
    the forward's split cluster kernel up to 960, the one-block kernels
    past them); ``by_width``, where given, gathers those launches by
    (kernel, design, dtype, hd). Returns {dtype: {quantity: worst}}."""
    import torch
    from repro_torch.kernels import slstm as K
    worst = {}
    for B, S, hd, dt in cases:
        ins = slstm_inputs(rng, B, S, SLSTM_HEADS, hd, dt, device)
        if B == 1:
            for t in ins[5:]:
                t.requires_grad_(False)
        label = f"slstm B={B} S={S} hd={hd} {dt}"
        before = dict(K.ROUTES)
        errs = slstm_check(label, ins, rng)
        if device.type == "cuda":
            ran = {key: n - before[key] for key, n in K.ROUTES.items()
                   if n != before[key]}
            want = {}
            for k in ("slstm_fwd", "slstm_bwd"):
                shape = K.plan(B * SLSTM_HEADS, hd, getattr(torch, dt),
                               k == "slstm_bwd")
                want[(k, "cluster" if shape["C"] else "block", dt)] = 1
            if ran != want:
                raise AssertionError(f"{label}: launched {ran}, want {want}")
            if by_width is not None:
                for key, n in ran.items():
                    by_width[key + (hd,)] = by_width.get(key + (hd,), 0) + n
        for k, v in errs.items():
            worst.setdefault(dt, {})[k] = max(worst.get(dt, {}).get(k, 0.0),
                                              v)
    return worst


def check_split_plans() -> dict:
    """{f"chains{B·H}_hd{hd}": "C:KS:KX"} of the split forward's plan for
    each SLSTM_CASES case past the cluster kernels' width up to the split
    forward's, each equal to ``slstm.split_shape``'s at its C; raises if
    one differs or if these cases do not take two values of C."""
    import torch
    from repro_torch.kernels import slstm as K
    out, Cs = {}, set()
    for B, _, hd, dt in SLSTM_CASES:
        if not K.CLUSTER_MAX_HD < hd <= K.SPLIT_MAX_HD:
            continue
        chains = B * SLSTM_HEADS
        got = K.plan(chains, hd, getattr(torch, dt))
        want = K.split_shape(hd, got["C"])
        keys = ("C", "KS", "KT", "KX", "threads")
        if want is None or any(got[k] != want[k] for k in keys):
            raise AssertionError(f"split sLSTM plan at {chains} chains of "
                                 f"hd {hd}: {got}, split_shape: {want}")
        out[f"chains{chains}_hd{hd}"] = "{C}:{KS}:{KX}".format(**got)
        Cs.add(got["C"])
    if len(Cs) < 2:
        raise AssertionError(f"the split sLSTM cases launch one cluster "
                             f"width only: {out}")
    return out


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

def make_inputs(n: int, avg_nnz: int, J: int, seed: int,
                dims3=None, rank: int = RANK):
    """The operands, all from ``seed``: the sparse matrix B (reference
    generator, CSR) with c (m,), C (m, J) and SDDMM's Cs (n, K), Ds (K, m);
    when ``dims3`` is given, the 3-tensor B3 (CSF) with c3 (K3,),
    C3 (J3, L) and D3 (K3, L)."""
    import numpy as np
    from repro_torch.data.spdata import powerlaw_matrix, powerlaw_tensor3
    data = {"B": powerlaw_matrix("B", n, n, avg_nnz, alpha=1.6, seed=seed)}
    rng = np.random.default_rng(seed + 1)
    data["c"] = rng.standard_normal(n).astype(np.float32)
    data["C"] = rng.standard_normal((n, J)).astype(np.float32)
    data["Cs"] = rng.standard_normal((n, rank)).astype(np.float32)
    data["Ds"] = rng.standard_normal((rank, n)).astype(np.float32)
    if dims3 is not None:
        data["B3"] = powerlaw_tensor3("B", dims3, avg_nnz_per_slice=AVG_SLICE,
                                      alpha=1.8, seed=seed)
        rng = np.random.default_rng(seed + 1)
        data["c3"] = rng.standard_normal(dims3[2]).astype(np.float32)
        data["C3"] = rng.standard_normal((dims3[1], rank)).astype(np.float32)
        data["D3"] = rng.standard_normal((dims3[2], rank)).astype(np.float32)
    return data


def _shifted(T, name: str, shift: int, seed: int):
    """T's pattern (blocks for a blocked T) with every column moved right by
    ``shift`` (mod the width) and fresh standard-normal values or tiles
    from ``seed``."""
    import numpy as np
    import repro_torch.core as tc
    rng = np.random.default_rng(seed)
    if T.format.is_blocked:
        bc = T.block_coords().astype(np.int64)
        bc[:, 1] = (bc[:, 1] + shift) % T.levels[1].size
        tiles = rng.standard_normal(T.vals.shape).astype(np.float32)
        return tc.Tensor.from_blocks(name, T.shape, T.format, bc, tiles,
                                     dedupe=False)
    coords = T.coords().astype(np.int64)
    coords[:, 1] = (coords[:, 1] + shift) % T.shape[1]
    vals = rng.standard_normal(T.nnz).astype(np.float32)
    return tc.Tensor.from_coo(name, T.shape, coords, vals, T.format,
                              dedupe=False)


def add_operands(n: int, seed: int, B=None):
    """SpAdd3's addends, all from ``seed``: the scalar ones (B, B shifted by
    one and by two columns, CSR; ``B`` is the matrix path's when given) and
    the blocked ones (BCSR((4, 4)) over n x n: the block pattern of
    ``powerlaw_matrix`` (n / 4, 4 blocks per block-row), normal tiles, and
    its shifts by one and two block columns)."""
    import numpy as np
    import repro_torch.core as tc
    from repro_torch.data.spdata import powerlaw_matrix
    if B is None:
        B = powerlaw_matrix("B", n, n, AVG_NNZ, alpha=1.6, seed=seed)
    g = n // ADD_BLOCK[0]
    grid = powerlaw_matrix("Bg", g, g, AVG_BLOCKS, alpha=1.6, seed=seed)
    Bb = tc.Tensor.from_blocks(
        "B", (n, n), tc.BCSR(ADD_BLOCK), grid.coords(),
        np.random.default_rng(seed + 1).standard_normal(
            (grid.nnz,) + ADD_BLOCK).astype(np.float32), dedupe=False)
    return {"scalar": (B, _shifted(B, "C", 1, seed + 1),
                       _shifted(B, "D", 2, seed + 2)),
            "blocked": (Bb, _shifted(Bb, "C", 1, seed + 2),
                        _shifted(Bb, "D", 2, seed + 3))}


def grid_operands(data, n_generic: int, seed: int):
    """The grid path's two statements besides the other paths': the add
    path's blocked B stored as compressed-root BCSR((4, 4)) (b[dcsr], which
    no leaf iterates: the conversion cell), and a ``powerlaw_matrix`` of
    side ``n_generic`` with a vector, from ``seed`` (the generic path)."""
    import numpy as np
    import repro_torch.core as tc
    from repro_torch.data.spdata import powerlaw_matrix
    Bb = data["add"]["blocked"][0]
    bdcsr = tc.Tensor.from_blocks(
        "B", Bb.shape, tc.Format(tc.DCSR().levels, block_shape=ADD_BLOCK),
        Bb.block_coords(), Bb.vals, dedupe=False)
    G = powerlaw_matrix("B", n_generic, n_generic, AVG_NNZ, alpha=1.6,
                        seed=seed)
    cg = np.random.default_rng(seed + 1).standard_normal(n_generic)
    return {"bdcsr": bdcsr, "generic": (G, cg.astype(np.float32))}


def statements(data):
    import numpy as np
    import repro_torch.core as tc
    B = data["B"]
    n, m = B.shape
    J = data["C"].shape[1]
    dense = tc.Tensor.from_dense
    out = {
        "spmv": tc.parse_tin("a(i) = B(i,j) * c(j)",
                             a=tc.Tensor.zeros_dense("a", (n,)), B=B,
                             c=dense("c", data["c"])),
        "spmm": tc.parse_tin("A(i,j) = B(i,k) * C(k,j)",
                             A=tc.Tensor.zeros_dense("A", (n, J)), B=B,
                             C=dense("C", data["C"])),
        # the output is declared CSR with B's pattern (tests/conformance.py)
        "sddmm": tc.parse_tin(
            "A(i,j) = B(i,j) * C(i,k) * D(k,j)",
            A=tc.Tensor("A", B.shape, B.format, B.levels,
                        np.ones_like(B.vals)),
            B=B, C=dense("C", data["Cs"]), D=dense("D", data["Ds"])),
    }
    if "B3" in data:
        B3 = data["B3"]
        out["spttv"] = tc.parse_tin(
            "A(i,j) = B(i,j,k) * c(k)",
            A=tc.Tensor.from_coo("A", B3.shape[:2], np.zeros((0, 2)),
                                 np.zeros(0, np.float32), tc.CSR()),
            B=B3, c=dense("c", data["c3"]))
        out["spmttkrp"] = tc.parse_tin(
            "A(i,l) = B(i,j,k) * C(j,l) * D(k,l)",
            A=tc.Tensor.zeros_dense("A", (B3.shape[0],
                                          data["C3"].shape[1])),
            B=B3, C=dense("C", data["C3"]), D=dense("D", data["D3"]))
    if "blocked" in data.get("add", {}):
        # the blocked path: the add path's BCSR B and the dense operands
        Bb = data["add"]["blocked"][0]
        out["spmv_bcsr"] = tc.parse_tin(
            "a(i) = B(i,j) * c(j)", a=tc.Tensor.zeros_dense("a", (n,)), B=Bb,
            c=dense("c", data["c"]))
        out["spmm_bcsr"] = tc.parse_tin(
            "A(i,j) = B(i,k) * C(k,j)", A=tc.Tensor.zeros_dense("A", (n, J)),
            B=Bb, C=dense("C", data["C"]))
        # the output keeps B's blocks (its values are not read)
        out["sddmm_bcsr"] = tc.parse_tin(
            "A(i,j) = B(i,j) * C(i,k) * D(k,j)",
            A=tc.Tensor("A", Bb.shape, Bb.format, Bb.levels, Bb.vals),
            B=Bb, C=dense("C", data["Cs"]), D=dense("D", data["Ds"]))
    if "grid" in data:
        out["spmv_bdcsr"] = tc.parse_tin(
            "a(i) = B(i,j) * c(j)", a=tc.Tensor.zeros_dense("a", (n,)),
            B=data["grid"]["bdcsr"], c=dense("c", data["c"]))
        G, cg = data["grid"]["generic"]
        out["generic"] = tc.parse_tin(
            "A(i,j) = B(i,j) * c(j)", A=tc.Tensor.zeros_dense("A", G.shape),
            B=G, c=dense("c", cg))
    for kind, expr in (("scalar", "spadd3"), ("blocked", "spadd3_bcsr")):
        if len(data.get("add", {}).get(kind, ())) == 3:
            ops_ = dict(zip("BCD", data["add"][kind]))
            out[expr] = tc.parse_tin(
                "A(i,j) = B(i,j) + C(i,j) + D(i,j)",
                A=tc.Tensor.from_coo("A", ops_["B"].shape, np.zeros((0, 2)),
                                     np.zeros(0, np.float32), tc.CSR()),
                **ops_)
    return out


def _same_bits(a, b) -> bool:
    import numpy as np
    import torch
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):                 # the generic path's
        return np.array_equal(a, b)
    return np.array_equal(a.vals, b.vals) and all(
        (x.pos is None or np.array_equal(x.pos, y.pos))
        and (x.crd is None or np.array_equal(x.crd, y.crd))
        for x, y in zip(a.levels, b.levels))


def dense_call(data, expr: str, device):
    """(wrapper name, ops entry point, its arguments) of a dense SpAdd3
    cell: the three operands' storage, on the device."""
    import torch
    from repro_torch.kernels import ops
    ts = data["dense"]["blocked" if "bcsr" in expr else "scalar"]
    n, m = ts[0].shape
    trips = tuple(tuple(torch.as_tensor(x).to(device) for x in
                        (t.levels[1].pos, t.levels[1].crd, t.vals))
                  for t in ts)
    if "bcsr" in expr:
        return "bcsr_spadd3_dense_rows", ops.spadd3_bcsr_dense, trips + (n, m)
    return "spadd3_dense_rows", ops.spadd3_dense, trips + (n, m)


def drive_dense(data, expr: str, device, reps: int):
    """A dense SpAdd3 cell through ``kernels.ops`` (no lowering: the
    reference reaches its TPU kernels only there)."""
    import torch
    from repro_torch.kernels import _build
    name, entry, args = dense_call(data, expr, device)
    calls = []
    before = dict(_build.LAUNCHES)

    def run():
        calls.append(1)
        return entry(*args, impl="cuda" if device.type == "cuda"
                     else "torch", device=device)

    base = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    run_ms = time_host(run, device, reps)
    res = run()
    bitwise = torch.equal(res, run())
    _sync(device)
    return {"kernel": None, "cold_s": 0.0, "warm_s": 0.0, "run_ms": run_ms,
            "runs": len(calls), "out": res, "bitwise": bitwise, "per_run": 1,
            "launches": _launched_since(before),
            "call": (name, tuple(x for t in args[:3] for x in t)
                     + args[3:]),
            "max_mem": (torch.cuda.max_memory_allocated(device) - base
                        if device.type == "cuda" else 0)}


def cell_name(cell) -> str:
    """``expr/strategy``, and the mesh label of a grid path cell."""
    return "/".join(str(x) for x in cell)


def cell_schedule(stmt, strat: str, mesh, pieces: int):
    """(machine, schedule) of a cell: the 1-D row or nnz schedule over
    ``pieces`` when ``mesh`` is None or 1-D (``"Nx1"``), else the grid
    schedule its label and strategy name (``"2x2"``, ``"2x2x2"``,
    ``"2x2x2r"``: the replicated 2.5-D schedule)."""
    import repro_torch.core as tc
    from repro_torch.core import lower as L
    dims = [int(x) for x in (mesh or f"{pieces}x1").rstrip("r").split("x")]
    if mesh is None or dims[1:] == [1]:
        machine = tc.Machine(("x", dims[0]))
        return machine, (L.default_row_schedule if strat == "rows"
                         else L.default_nnz_schedule)(stmt, machine)
    machine = tc.Machine(*zip("xyz", dims))
    if mesh.endswith("r"):
        return machine, L.default_replicated_schedule(stmt, machine)
    if strat == "nnz":
        return machine, L.default_grid_nnz_schedule(stmt, machine)
    return machine, (L.default_grid3_schedule if len(dims) == 3
                     else L.default_grid_schedule)(stmt, machine)


def _launched_since(before) -> dict:
    """{kernel: launches} counted since the snapshot ``before`` of
    ``_build.LAUNCHES``, for the kernels that launched at all."""
    from repro_torch.kernels import _build
    return {k: n - before[k] for k, n in _build.LAUNCHES.items()
            if n != before[k]}


def drive(stmts, cells, pieces: int, device, reps: int, data=None):
    """Lower (cold, then warm) and run each cell through the public entry
    points (the dense SpAdd3 cells through ``kernels.ops``). Returns
    {cell: record}; each record's ``launches`` counts every kernel launch
    from the cell's cold lower to its last ``run()``."""
    import torch
    from repro_torch.core import lower as L
    from repro_torch.kernels import _build

    out = {}
    for cell in cells:
        expr, strat = cell[:2]
        if strat == "ops":
            out[cell_name(cell)] = drive_dense(data, expr, device, reps)
            continue
        stmt = stmts[expr]
        machine, sched = cell_schedule(stmt, strat, (cell[2:] or (None,))[0],
                                       pieces)
        base = 0
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        L.clear_lowering_caches()
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        k = L.lower(stmt, machine, schedule=sched, device=device)
        cold_s = time.perf_counter() - t0
        cold_cache = k.cache
        t0 = time.perf_counter()
        k = L.lower(stmt, machine, schedule=sched, device=device)
        warm_s = time.perf_counter() - t0
        if not k.cache.warm:
            raise AssertionError(f"{k.cell_id()}: warm re-lower missed a "
                                 f"cache: {k.cache.as_dict()}")
        calls, last = [], []

        def run(k=k, calls=calls, last=last):
            calls.append(1)
            out = k.run()
            last[:] = last[-1:] + [out]
            return out

        # the last two timed runs' results are the bit check
        run_ms = time_host(run, device, max(reps, 2))
        res, again = last
        _sync(device)
        out[cell_name(cell)] = {
            "kernel": k, "cold_s": cold_s, "warm_s": warm_s,
            "run_ms": run_ms, "runs": len(calls), "out": res,
            "bitwise": _same_bits(res, again), "call": leaf_call(k),
            "per_run": launches_per_run(k), "cold_cache": cold_cache,
            "launches": _launched_since(before),
            # this cell's own peak, above what earlier cells still hold
            "max_mem": (torch.cuda.max_memory_allocated(device) - base
                        if device.type == "cuda" else 0)}
    return out


def reference_products(data, exprs):
    """float64 host results of ``exprs`` and their scales, each computed
    once per ``data`` and kept there: the grid path checks its cells
    against the same products as the other paths' cells."""
    done = data.setdefault("host_products", {})
    todo = set(exprs) - set(done)
    if todo:
        done.update(_reference_products(data, todo))
    return {expr: done[expr] for expr in exprs}


def _reference_products(data, exprs):
    """float64 host results of ``exprs`` and their scales (the same
    computation on absolute values): SpMV and SpMM with np.bincount over the
    CSR arrays, SDDMM per stored entry in chunks, SpTTV per (i, j) fibre and
    SpMTTKRP per row of the 3-tensor."""
    import numpy as np
    out = {}

    def per_column(seg, w, gather, n_out, n_cols):
        """np.bincount of w·gather(l) per column l: (n_out, n_cols) and its
        scale."""
        Y = np.empty((n_out, n_cols))
        S = np.empty_like(Y)
        for l in range(n_cols):
            t = w * gather(l)
            Y[:, l] = np.bincount(seg, t, minlength=n_out)
            S[:, l] = np.bincount(seg, np.abs(t), minlength=n_out)
        return Y, S

    B = data["B"]
    n = B.shape[0]
    pos, crd = B.levels[1].pos, B.levels[1].crd
    rows = np.repeat(np.arange(n), np.diff(pos))
    v = B.vals.astype(np.float64)
    if "spmv" in exprs:
        out["spmv"] = per_column(rows, v, lambda _: data["c"][crd], n, 1)
        out["spmv"] = tuple(x[:, 0] for x in out["spmv"])
    if "spmm" in exprs:
        C = data["C"]
        out["spmm"] = per_column(rows, v, lambda l: C[:, l][crd], n,
                                 C.shape[1])
    if "sddmm" in exprs:
        Cs = data["Cs"].astype(np.float64)
        Ds = data["Ds"].T.astype(np.float64)
        want, scale = np.empty(B.nnz), np.empty(B.nnz)
        for lo in range(0, B.nnz, 1 << 20):
            hi = min(lo + (1 << 20), B.nnz)
            prod = Cs[rows[lo:hi]] * Ds[crd[lo:hi]]
            want[lo:hi] = v[lo:hi] * prod.sum(1)
            scale[lo:hi] = np.abs(v[lo:hi]) * np.abs(prod).sum(1)
        out["sddmm"] = (want, scale)
    if "spttv" in exprs or "spmttkrp" in exprs:
        B3 = data["B3"]
        p1, c1 = B3.levels[1].pos, B3.levels[1].crd
        p2, c2 = B3.levels[2].pos, B3.levels[2].crd
        ij = np.repeat(np.arange(c1.shape[0]), np.diff(p2))
        v3 = B3.vals.astype(np.float64)
        c3 = data["c3"]
        out["spttv"] = tuple(x[:, 0] for x in per_column(
            ij, v3, lambda _: c3[c2], c1.shape[0], 1))
        i = np.repeat(np.arange(B3.shape[0]), np.diff(p1))[ij]
        j = c1[ij]
        C3, D3 = data["C3"], data["D3"]
        out["spmttkrp"] = per_column(
            i, v3, lambda l: C3[:, l][j].astype(np.float64) * D3[:, l][c2],
            B3.shape[0], C3.shape[1])
    if {"spmv_bcsr", "spmm_bcsr", "sddmm_bcsr", "spmv_bdcsr"} & set(exprs):
        Bb = data["add"]["blocked"][0]
        if {"spmv_bcsr", "spmv_bdcsr"} & set(exprs):
            y, sc = blocked_products(Bb, data["c"][:, None])
            out["spmv_bcsr"] = out["spmv_bdcsr"] = (y[:, 0], sc[:, 0])
        if "spmm_bcsr" in exprs:
            out["spmm_bcsr"] = blocked_products(Bb, data["C"])
        if "sddmm_bcsr" in exprs:
            out["sddmm_bcsr"] = blocked_sampled(Bb, data["Cs"], data["Ds"])
    if "generic" in exprs:
        G, cg = data["grid"]["generic"]
        dG = G.to_dense().astype(np.float64)
        out["generic"] = (dG * cg, np.abs(dG) * np.abs(cg))
    for expr, (where, kind) in ADD_SOURCES.items():
        if expr in exprs:
            out[expr] = host_union(data[where][kind])
    return out


def blocked_products(T, X, step: int = 1 << 17):
    """float64 host T @ X (n, J) and its scale for a BCSR T, in chunks of
    stored blocks: each chunk's (br, bc) @ (bc, J) products summed per
    block-row (the blocks are stored block-row by block-row)."""
    import numpy as np
    br, bc = T.format.block_shape
    n, m = T.shape
    brow, bcol = T.block_coords().astype(np.int64).T
    Xb = np.zeros((-(-m // bc) * bc, X.shape[1]))
    Xb[:m] = X
    Xb = Xb.reshape(-1, bc, X.shape[1])
    Y = np.zeros((-(-n // br), br, X.shape[1]))
    S = np.zeros_like(Y)
    for lo in range(0, brow.shape[0], step):
        b, t = brow[lo:lo + step], T.vals[lo:lo + step].astype(np.float64)
        xg = Xb[bcol[lo:lo + step]]
        start = np.flatnonzero(np.r_[True, b[1:] != b[:-1]])
        Y[b[start]] += np.add.reduceat(t @ xg, start, axis=0)
        S[b[start]] += np.add.reduceat(np.abs(t) @ np.abs(xg), start, axis=0)
    return (Y.reshape(-1, X.shape[1])[:n], S.reshape(-1, X.shape[1])[:n])


def blocked_sampled(T, Cs, Ds, step: int = 1 << 17):
    """float64 host SDDMM over a BCSR T: each stored tile times the (br, bc)
    block of Cs @ Ds it samples, and the scale, in T's storage order."""
    import numpy as np
    br, bc = T.format.block_shape
    n, m = T.shape
    K = Cs.shape[1]
    brow, bcol = T.block_coords().astype(np.int64).T
    Cb = np.zeros((-(-n // br) * br, K))
    Cb[:n] = Cs
    Db = np.zeros((-(-m // bc) * bc, K))
    Db[:m] = Ds.T
    Cb, Db = Cb.reshape(-1, br, K), Db.reshape(-1, bc, K)
    want = np.empty(T.vals.shape)
    scale = np.empty(T.vals.shape)
    for lo in range(0, brow.shape[0], step):
        t = T.vals[lo:lo + step].astype(np.float64)
        cg, dg = Cb[brow[lo:lo + step]], Db[bcol[lo:lo + step]]
        want[lo:lo + step] = t * (cg @ dg.transpose(0, 2, 1))
        scale[lo:lo + step] = np.abs(t) * (np.abs(cg)
                                           @ np.abs(dg).transpose(0, 2, 1))
    return want, scale


# the SpAdd3 cells' operands: (data key, kind)
ADD_SOURCES = {"spadd3": ("add", "scalar"), "spadd3_bcsr": ("add", "blocked"),
               "spadd3_dense": ("dense", "scalar"),
               "spadd3_bcsr_dense": ("dense", "blocked")}


def host_union(ts):
    """The float64 union B + C + D of three row-major (B)CSR operands on the
    host: its compressed levels (pos over the root, crd), its values and
    their scale (the sum of absolute values), per stored entry or tile."""
    import numpy as np
    n_root, width = ts[0].levels[0].size, ts[0].levels[1].size
    tile = ts[0].vals.shape[1:]
    keys, vals = [], []
    for t in ts:
        pos = t.levels[1].pos
        keys.append(np.repeat(np.arange(n_root, dtype=np.int64),
                              np.diff(pos)) * width + t.levels[1].crd)
        vals.append(t.vals.reshape(t.vals.shape[0], -1))
    key = np.concatenate(keys)
    order = np.argsort(key, kind="stable")      # three sorted runs
    key = key[order]
    v = np.concatenate(vals)[order].astype(np.float64)
    start = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    ukey = key[start]
    pos = np.zeros(n_root + 1, np.int64)
    np.cumsum(np.bincount(ukey // width, minlength=n_root), out=pos[1:])
    shape = (-1,) + tuple(tile)
    return {"pos": pos, "crd": ukey % width,
            "vals": np.add.reduceat(v, start, axis=0).reshape(shape),
            "scale": np.add.reduceat(np.abs(v), start, axis=0).reshape(shape),
            "block": tile or (1, 1)}


def check_union(name: str, got, want) -> float:
    """A SpAdd3 result: a union Tensor must store exactly the host union's
    coordinates; a dense sum must hold the union's values at its cells and
    zero everywhere else."""
    import numpy as np
    import torch
    if not torch.is_tensor(got):
        for key in ("pos", "crd"):
            if not np.array_equal(getattr(got.levels[1], key), want[key]):
                raise AssertionError(f"{name}: stored {key} differs from "
                                     "the host union's")
        return check_rows(name, got.vals, want["vals"], want["scale"])
    br, bc = want["block"]
    n, m = got.shape
    brow = np.repeat(np.arange(want["pos"].shape[0] - 1), np.diff(
        want["pos"]))
    r = (brow[:, None] * br + np.arange(br)[None, :])[:, :, None]
    c = (want["crd"][:, None] * bc + np.arange(bc)[None, :])[:, None, :]
    r, c = np.broadcast_arrays(r, c)
    keep = ((r < n) & (c < m)).reshape(-1)
    rows, cols = (torch.from_numpy(x.reshape(-1)[keep]).to(got.device)
                  for x in (r, c))
    at = got[rows, cols]
    if int(torch.count_nonzero(got)) != int(torch.count_nonzero(at)):
        raise AssertionError(f"{name}: non-zero values outside the union")
    return check_rows(name, at, want["vals"].reshape(-1)[keep],
                      want["scale"].reshape(-1)[keep])


def check_cell(name: str, rec, data, want) -> float:
    """Hold one cell's result against the host computation. Every cell
    must give the same bits on two run()s. A sparse output must keep B's
    (i, j) pattern: SDDMM's values are compared in B's storage order,
    SpTTV's per (i, j) fibre of the 3-tensor."""
    import numpy as np
    expr = name.split("/")[0]
    got = rec["out"]
    if not rec["bitwise"]:
        raise AssertionError(f"{name}: two run()s gave different bits")
    k = rec["kernel"]
    if k is not None and (k.fallbacks or expr == "spmv_bdcsr") and (
            k.fallbacks != ["B: b[dcsr] -> csr"]
            or rec["cold_cache"].convert_misses != 1
            or k.cache.convert_hits != 1):
        raise AssertionError(
            f"{name}: the conversion is not B's, once cold and cached warm: "
            f"{k.fallbacks}, cold {rec['cold_cache'].as_dict()}, warm "
            f"{k.cache.as_dict()}")
    if expr.startswith("spadd3"):
        return check_union(name, got, want[expr])
    if expr in ("sddmm", "spttv", "sddmm_bcsr"):
        src = (data["B"] if expr == "sddmm" else data["B3"]
               if expr == "spttv" else data["add"]["blocked"][0])
        if expr != "spttv" and got.levels is not src.levels:
            raise AssertionError(f"{name}: the output lost B's pattern")
        if expr == "spttv":
            fibres = np.stack([np.repeat(np.arange(src.shape[0]),
                                         np.diff(src.levels[1].pos)),
                               src.levels[1].crd], 1)
            if not np.array_equal(got.coords(), fibres):
                raise AssertionError(f"{name}: the output's pattern is not "
                                     "B's (i, j) fibres")
        got = got.vals
    return check_rows(name, got, *want[expr])


def leaf_call(k):
    """(kernel name, args) of the Hopper kernel a lowered cell launches, on
    the cell's own inputs (a replicated grid cell's first z-slice); None for
    a leaf with no kernel (the flat SpTTV products, the generic path)."""
    name = k.leaf_name
    if name.startswith("generic["):
        return None
    if name in ("bcsr_spmv_grid_rows", "bcsr_spmm_grid_rows"):
        return name[:9], (*k.args[:4], int(k.shards["B"].meta["max_brows"]))
    if name == "spmm_grid_rep_rows":
        return "spmm_csr_rows", (*k.args[:3], k.args[3][0])
    if name == "sddmm_grid_rep_rows":
        return "sddmm_coo", (*k.args[:3], k.args[3][0], k.args[4][0])
    if name == "spmttkrp_grid3_rows":
        return "spmttkrp_coo", (*k.args[:6],
                                int(k.shards["B"].meta["max_rows"]))
    if name == "spadd3_grid_rows":
        return "spadd3_union_rows", k.args[:9]
    if name in ("spmv_grid_rows", "spmm_grid_rows"):
        return name.replace("_grid_rows", "_csr_rows"), k.args[:4]
    if name.startswith(("bcsr_spmv", "bcsr_spmm")):
        # (brow, bcol, tiles, packed dense operand, max_brows)
        return name[:9], (*k.args[:4], int(k.args[4]))
    if name.startswith("bcsr_sddmm"):
        return "bcsr_sddmm", k.args[:5]
    if name in ("spadd3_rows", "bcsr_spadd3_rows"):
        return name.replace("_rows", "_union_rows"), k.args[:9]
    if name in ("spadd3_nnz", "bcsr_spadd3_nnz"):
        return name.replace("_nnz", "_union_nnz"), k.args[:4]
    max_rows = int(k.shards["B"].meta["max_rows"])
    if name in ("spmv_rows", "spttv_rows"):
        return "spmv_csr_rows", k.args[:4]
    if name == "spmv_nnz":
        return "spmv_coo_nnz", (*k.args[:4], max_rows)
    if name == "spmm_rows":
        return "spmm_csr_rows", k.args[:4]
    if name == "spmm_nnz":
        return "spmm_coo_nnz", (*k.args[:4], max_rows)
    if name.startswith("sddmm"):
        return "sddmm_coo", k.args[:5]
    if name.startswith("spmttkrp"):
        return "spmttkrp_coo", (*k.args[:6], max_rows)
    return None


def launches_per_run(k) -> int:
    """The launches of the cell's kernel in one ``run()``, as its emitter
    documents them: one for every tile of a grid stacked into one launch,
    one per z-slice (R) for the replicated 2.5-D emitters, none on the
    generic path."""
    if k.leaf_name.startswith("generic["):
        return 0
    if k.leaf_name.endswith("_grid_rep_rows"):
        return k.strategy.grid_shape[2]
    return 1


def run_slice(data, cells, pieces: int, device, reps: int = 10):
    """Phase 4 for one path: drive its cells and check every result
    against the host computation. Returns ({cell: record}, launches), the
    launches of each kernel during the drive alone, read straight after
    it. Each cell's own launches are read around that cell: on the card
    its kernel must have launched as often per ``run()`` as its emitter
    documents and no other kernel at all, on the CPU none; the path's
    totals must be the sum of those."""
    from repro_torch.core.device import resolve_device
    from repro_torch.kernels import _build
    device = resolve_device(device)
    before = dict(_build.LAUNCHES)
    recs = drive(statements(data), cells, pieces, device, reps, data)
    launches = {k: n - before[k] for k, n in _build.LAUNCHES.items()}
    expected = dict.fromkeys(launches, 0)
    for name, rec in recs.items():
        own = {}
        if (rec["call"] is not None and device.type == "cuda"
                and rec["per_run"]):
            own[rec["call"][0]] = rec["runs"] * rec["per_run"]
        if rec["launches"] != own:
            raise AssertionError(f"{name}: launches {rec['launches']} are "
                                 f"not those documented per run() of its "
                                 f"kernel: {own}")
        for k, n in own.items():
            expected[k] += n
    if launches != expected:
        raise AssertionError(f"launches during the drive {launches} are not "
                             f"those documented per run() of each cell's "
                             f"kernel: {expected}")
    want = reference_products(data, {cell[0] for cell in cells})
    for name, rec in recs.items():
        rec["max_abs_err"] = check_cell(name, rec, data, want)
    return recs, launches


# ---------------------------------------------------------------------------
# Phase 5: the kernels line
# ---------------------------------------------------------------------------

def _moved(name: str, args, nnz: int, n_out: int):
    """(bytes, f32 operations) of one kernel call: each input read once and
    each output written once (real entries and outputs), and the operations
    the data needs. For SpAdd3, ``nnz`` counts the three operands' stored
    entries (or blocks) and ``n_out`` the union's (dense: its cells)."""
    if "spadd3" in name and "union_nnz" not in name:
        tile = args[2][(0,) * (1 if "dense" in name else 2)].numel()
        pos_bytes = sum(args[i].numel() * 4 for i in (0, 3, 6))
        if "dense" in name:                       # + the dense output
            return (nnz * (4 + 4 * tile) + pos_bytes + n_out * 4,
                    nnz * tile)
        P, R = args[0].shape[0], args[0].shape[1] - 1
        return (nnz * (4 + 4 * tile) + pos_bytes
                + n_out * (4 + 4 * tile) + (P * R + 1) * 8,
                (nnz - n_out) * tile)
    if "union_nnz" in name:
        vals, perm, seg_ptr, run_ptr = args
        tile = vals[0, 0].numel()
        return (nnz * (4 + 4 * tile) + (seg_ptr.numel() + run_ptr.numel()) * 4
                + n_out * 4 * tile, (nnz - n_out) * tile)
    if name in ("bcsr_spmv", "bcsr_spmm"):
        # nnz: stored blocks; the output is the kernel's block-row windows
        brow, _, tiles, x, max_brows = args
        tile = tiles[0, 0].numel()
        w = x.shape[2] if x.dim() == 3 else 1
        return (nnz * (8 + 4 * tile) + x.numel() * 4
                + brow.shape[0] * max_brows * tiles.shape[2] * w * 4,
                2 * nnz * tile * w)
    if name == "bcsr_sddmm":
        C, Dt = args[3], args[4]
        tile = args[2][0, 0].numel()
        return (nnz * (8 + 8 * tile) + C.numel() * 4 + Dt.numel() * 4,
                nnz * tile * (2 * Dt.shape[1] + 1))
    if name in ("spmv_csr_rows", "spmm_csr_rows"):
        pos, _, _, x = args
        P, R = pos.shape[0], pos.shape[1] - 1
        w = x.shape[1] if x.dim() == 2 else 1
        return (nnz * 8 + P * (R + 1) * 4 + x.numel() * 4 + P * R * w * 4,
                2 * nnz * w)
    if name == "spmv_coo_nnz":
        c, max_rows = args[3], args[4]
        return nnz * 12 + c.numel() * 4 + args[0].shape[0] * max_rows * 4, \
            2 * nnz
    if name == "spmm_coo_nnz":
        C, max_rows = args[3], args[4]
        J = C.shape[1]
        return (nnz * 12 + C.numel() * 4
                + args[0].shape[0] * max_rows * J * 4, 2 * nnz * J)
    if name == "sddmm_coo":
        C, Dt = args[3], args[4]
        K = Dt.shape[1]
        return nnz * 16 + C.numel() * 4 + Dt.numel() * 4, nnz * (2 * K + 1)
    C, D = args[4], args[5]                       # spmttkrp_coo
    L = C.shape[1]
    return nnz * 16 + (C.numel() + D.numel()) * 4 + n_out * L * 4, \
        3 * nnz * L


def kernel_record(name, args, launches, nnz, n_out, library, reps):
    """Time one kernel, its plain version and a library yardstick
    (``library`` = (what it calls, fn or None)) at the main path's shapes,
    and compute its bound from this run's inputs."""
    kernel, plain = kernel_fns()[name]
    nbytes, flops = _moved(name, args, nnz, n_out)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    source, replaces = KERNELS[name]
    err = compare_kernel(f"{name} main-path shapes", name, args,
                         _abs_args(args))
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": err,
        "ms": time_events(lambda: kernel(*args), reps),
        "plain_ms": time_events(lambda: plain(*args), max(reps // 4, 3)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": (time_events(library[1], max(reps // 4, 3))
                       if library[1] is not None else None),
        "library_call": library[0],
    }


def kernel_records(data, cells, launches, reps: int):
    """The six kernels at the main path's shapes, each on the inputs of
    the cell it serves: spmv/rows, spmv/nnz, spmm/rows, spmm/nnz, sddmm/nnz,
    spmttkrp/rows. Plus the SpMV rows kernel on SpTTV's (i, j) fibres
    (spttv/rows), returned apart, and {cell: ms} of every cell's kernel on
    its own inputs (those cells' times, and the other cells timed here)."""
    import torch
    B, B3 = data["B"], data["B3"]
    dev = cells["spmv/rows"]["kernel"].device
    n, m = B.shape

    def csr(pos, crd, vals, shape):
        return torch.sparse_csr_tensor(
            torch.as_tensor(pos).to(dev), torch.as_tensor(crd).to(dev),
            torch.as_tensor(vals).to(dev), size=shape)

    Bcsr = csr(B.levels[1].pos, B.levels[1].crd, B.vals, (n, m))
    n_ij = B3.levels[1].crd.shape[0]
    B3ij = csr(B3.levels[2].pos, B3.levels[2].crd, B3.vals,
               (n_ij, B3.shape[2]))
    order = ("spmv/rows", "spmv/nnz", "spmm/rows", "spmm/nnz", "sddmm/nnz",
             "spmttkrp/rows", "spttv/rows")
    call = {c: leaf_call(cells[c]["kernel"]) for c in order}
    sd = call["sddmm/nnz"][1]
    D_lib = sd[4].t().contiguous()
    ttv = call["spttv/rows"][1]
    on_b = "torch.sparse_csr_tensor(B) @ x, the whole matrix"
    library = {
        "spmv/rows": (on_b, lambda: Bcsr @ call["spmv/rows"][1][3]),
        "spmv/nnz": (on_b, lambda: Bcsr @ call["spmv/nnz"][1][3]),
        "spmm/rows": (on_b, lambda: Bcsr @ call["spmm/rows"][1][3]),
        "spmm/nnz": (on_b, lambda: Bcsr @ call["spmm/nnz"][1][3]),
        "sddmm/nnz": (
            "torch.sparse.sampled_addmm(B, C, D, beta=0).values() * B's "
            "values", lambda: torch.sparse.sampled_addmm(
                Bcsr, sd[3], D_lib, beta=0.0).values() * Bcsr.values()),
        "spmttkrp/rows": ("none: no single PyTorch call computes MTTKRP",
                          None),
        "spttv/rows": ("torch.sparse_csr_tensor(pos2, crd2, vals) @ c",
                       lambda: B3ij @ ttv[3]),
    }
    records, cell_ms = [], {}
    fns = kernel_fns()
    for cell in order:
        name, args = call[cell]
        three = cell.startswith(("spmttkrp", "spttv"))
        records.append(kernel_record(
            name, args, launches[name], B3.nnz if three else B.nnz,
            B3.shape[0] if three else n, library[cell], reps))
        cell_ms[cell] = records[-1]["ms"]
        if name in ("spmv_csr_rows", "spmm_csr_rows", "spmv_coo_nnz",
                    "spmm_coo_nnz", "sddmm_coo", "spmttkrp_coo"):
            phase("profile", name=name, cell=cell, **{
                k.replace(" ", "_"): f"{v:.4f}" for k, v in
                device_breakdown(lambda: fns[name][0](*args)).items()})
    for cell, rec in cells.items():
        other = rec["call"]
        if cell not in cell_ms and other is not None:
            cell_ms[cell] = time_events(
                lambda: fns[other[0]][0](*other[1]), reps)
    return records[:-1], records[-1], cell_ms


def blocked_library_operands(Bb, dev):
    """The yardsticks' operands for a BCSR Bb on ``dev``: a
    ``torch.sparse_bsr_tensor`` and B as a scalar CSR, whose row b·br + r
    holds, block by block in block-column order, the bc entries of row r of
    each stored block of block-row b."""
    import torch
    br, bc = Bb.format.block_shape
    pos, crd, tiles = (torch.as_tensor(x).to(dev) for x in
                       (Bb.levels[1].pos, Bb.levels[1].crd, Bb.vals))
    bsr = torch.sparse_bsr_tensor(pos, crd, tiles, size=Bb.shape)
    nb, L = crd.numel(), (pos[1:] - pos[:-1]).long()
    brow = torch.repeat_interleave(torch.arange(L.numel(), device=dev), L)
    start = pos[:-1].long()[brow]
    r = torch.arange(br, device=dev)[None, :, None]
    cc = torch.arange(bc, device=dev)[None, None, :]
    at = (start * br * bc + (torch.arange(nb, device=dev) - start) * bc
          )[:, None, None] + r * (L[brow] * bc)[:, None, None] + cc
    at = at.reshape(-1)
    svals = torch.empty(nb * br * bc, device=dev)
    svals[at] = tiles.reshape(-1)
    scols = torch.empty(nb * br * bc, dtype=torch.int64, device=dev)
    scols[at] = (crd.long()[:, None, None] * bc + cc).expand(
        nb, br, bc).reshape(-1)
    crow = torch.zeros(L.numel() * br + 1, dtype=torch.int64, device=dev)
    torch.cumsum(L.repeat_interleave(br) * bc, 0, out=crow[1:])
    return bsr, torch.sparse_csr_tensor(crow, scols, svals, size=Bb.shape)


def blocked_kernel_records(data, cells, launches, reps: int):
    """The three blocked kernels, each on the inputs of one cell it serves
    (spmv_bcsr/rows, spmm_bcsr/rows, sddmm_bcsr/nnz), and {cell: ms} of
    all six blocked cells' kernels. Yardsticks: ``torch.sparse`` BSR @ c
    and @ C, and ``sampled_addmm`` over the scalarised block pattern."""
    import torch
    Bb = data["add"]["blocked"][0]
    dev = cells["spmv_bcsr/rows"]["kernel"].device
    bsr, scalar = blocked_library_operands(Bb, dev)
    call = {c: leaf_call(cells[c]["kernel"]) for c in
            ("spmv_bcsr/rows", "spmm_bcsr/rows", "sddmm_bcsr/nnz")}
    c = torch.as_tensor(data["c"]).to(dev)
    C = torch.as_tensor(data["C"]).to(dev)
    Cs = torch.as_tensor(data["Cs"]).to(dev)
    Ds = torch.as_tensor(data["Ds"]).to(dev)
    library = {
        "spmv_bcsr/rows": ("torch.sparse_bsr_tensor(B) @ c, the whole "
                           "matrix", lambda: bsr @ c),
        "spmm_bcsr/rows": ("torch.sparse_bsr_tensor(B) @ C",
                           lambda: bsr @ C),
        "sddmm_bcsr/nnz": (
            "torch.sparse.sampled_addmm(B as scalar CSR, C, D, beta=0)"
            ".values() * B's values",
            lambda: torch.sparse.sampled_addmm(
                scalar, Cs, Ds, beta=0.0).values() * scalar.values()),
    }
    records, cell_ms = [], {}
    fns = kernel_fns()
    for cell, (name, args) in call.items():
        records.append(kernel_record(name, args, launches[name],
                                     Bb.vals.shape[0], Bb.shape[0],
                                     library[cell], reps))
        cell_ms[cell] = records[-1]["ms"]
        if name in ("bcsr_spmv", "bcsr_spmm", "bcsr_sddmm"):   # phases
            phase("profile", name=name, cell=cell, **{
                k.replace(" ", "_"): f"{v:.4f}" for k, v in
                device_breakdown(lambda: fns[name][0](*args)).items()})
    for cell, rec in cells.items():
        if cell not in cell_ms:
            other = rec["call"]
            cell_ms[cell] = time_events(
                lambda: fns[other[0]][0](*other[1]), reps)
    return records, cell_ms


def grid_kernel_records(data, cells, reps: int):
    """Each grid path cell's kernel on the cell's own inputs (a replicated
    cell's first z-slice), labelled with the cell: its launches on the path
    (counted around that cell's drive alone), its time, its bound at
    the tile shapes, its plain version's time and the 1-D path's library
    yardstick for the same function."""
    import torch
    dev = next(r["kernel"].device for r in cells.values() if r["kernel"])
    Bb = data["add"]["blocked"][0]

    def csr(t):
        return torch.sparse_csr_tensor(
            *(torch.as_tensor(x).to(dev) for x in
              (t.levels[1].pos, t.levels[1].crd, t.vals)), size=t.shape)

    Bcsr = csr(data["B"])
    adds = [csr(t) for t in data["add"]["scalar"]]
    bsr, scalar = blocked_library_operands(Bb, dev)
    c, C, Cs, Ds = (torch.as_tensor(data[x]).to(dev)
                    for x in ("c", "C", "Cs", "Ds"))
    on_b = "torch.sparse_csr_tensor(B) @ "
    sampled = "torch.sparse.sampled_addmm(B{}, C, D, beta=0).values() * " \
        "B's values"
    library = {
        "spmv": (on_b + "c", lambda: Bcsr @ c),
        "spmm": (on_b + "C", lambda: Bcsr @ C),
        "sddmm": (sampled.format(""), lambda: torch.sparse.sampled_addmm(
            Bcsr, Cs, Ds, beta=0.0).values() * Bcsr.values()),
        "spmv_bcsr": ("torch.sparse_bsr_tensor(B) @ c", lambda: bsr @ c),
        "spmm_bcsr": ("torch.sparse_bsr_tensor(B) @ C", lambda: bsr @ C),
        "sddmm_bcsr": (sampled.format(" as scalar CSR"),
                       lambda: torch.sparse.sampled_addmm(
                           scalar, Cs, Ds, beta=0.0).values()
                       * scalar.values()),
        "spmttkrp": ("none: no single PyTorch call computes MTTKRP", None),
        "spadd3": ("torch.sparse_csr_tensor addition B + C + D (cuSPARSE)",
                   lambda: adds[0] + adds[1] + adds[2]),
    }

    def converted(k):
        """The conversion cell's yardstick: the same SpMV on the kernel's
        own operand, B as converted to CSR."""
        Bk = csr(k.plans["B"].tensor)
        return ("torch.sparse_csr_tensor(B converted to CSR) @ c",
                lambda: Bk @ c)

    records = []
    for cell, rec in cells.items():
        if rec["call"] is None:
            continue                      # the generic path: no kernel
        name, args = rec["call"]
        k = rec["kernel"]
        ops_ = [k.plans[acc.tensor.name].tensor
                for acc in k.stmt.rhs.accesses() if acc.tensor.format.is_sparse]
        nnz = sum(t.vals.shape[0] for t in ops_)
        n_out = (rec["out"].levels[1].crd.shape[0] if name.startswith("spadd3")
                 else args[0].shape[0] * args[-1] if name == "spmttkrp_coo"
                 else k.stmt.lhs.tensor.shape[0])
        expr = cell.split("/")[0]
        r = kernel_record(name, args, rec["launches"].get(name, 0), nnz,
                          n_out, converted(k) if expr == "spmv_bdcsr"
                          else library[expr], reps)
        records.append(dict(r, name=f"{name}({k.cell_id()})",
                            cell=k.cell_id()))
    return records


def device_breakdown(fn, reps: int = 3):
    """Device milliseconds per call of each CUDA kernel that ``fn``
    launches, from ``torch.profiler`` over ``reps`` calls (a wrapper with a
    count and a fill phase launches two). One call more runs first inside
    the profiler as its warm-up step: without it the tracer dropped the
    first calls' kernels (a breakdown at two thirds of the kernel's time,
    or none at all); a window that still records nothing is taken again,
    up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=reps,
                                       repeat=1)) \
                as prof:
            for _ in range(reps + 1):
                fn()
                torch.cuda.synchronize()
                prof.step()
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
            name = evt.key.replace("(anonymous namespace)::", "")
            name = name.replace("void ", "").split("(")[0].split(",")[0]
            if us > 0:
                out[name[-48:]] = out.get(name[-48:], 0.0) + us / 1e3 / reps
        if out:
            break
    return out


def add_kernel_records(data, cells, launches, reps: int):
    """The six SpAdd3 kernels, each on the inputs of the cell it serves (the
    add path's four lowered cells and two dense ops cells), and {cell: ms}
    of those cells' kernels."""
    import torch
    dev = cells["spadd3/rows"]["kernel"].device

    def csr_sum(ts):
        mats = [torch.sparse_csr_tensor(
            *(torch.as_tensor(x).to(dev) for x in
              (t.levels[1].pos, t.levels[1].crd, t.vals)), size=t.shape)
            for t in ts]
        return lambda: mats[0] + mats[1] + mats[2]

    union = csr_sum(data["add"]["scalar"])
    dense = csr_sum(data["dense"]["scalar"])
    on_add = "torch.sparse_csr_tensor addition B + C + D (cuSPARSE)"
    no_bsr = "none: no single PyTorch call adds BSR matrices"
    library = {
        "spadd3_dense/ops": (on_add + ", .to_dense()",
                             lambda: dense().to_dense()),
        "spadd3/rows": (on_add, union), "spadd3/nnz": (on_add, union),
        "spadd3_bcsr_dense/ops": (no_bsr, None),
        "spadd3_bcsr/rows": (no_bsr, None), "spadd3_bcsr/nnz": (no_bsr, None),
    }
    records, cell_ms = [], {}
    for cell in ("spadd3_dense/ops", "spadd3_bcsr_dense/ops", "spadd3/rows",
                 "spadd3/nnz", "spadd3_bcsr/rows", "spadd3_bcsr/nnz"):
        rec = cells[cell]
        name, args = rec["call"]
        expr = cell.split("/")[0]
        where, kind = ADD_SOURCES[expr]
        nnz = sum(t.vals.shape[0] for t in data[where][kind])
        out = rec["out"]
        n_out = (out.numel() if torch.is_tensor(out)
                 else out.levels[1].crd.shape[0])
        records.append(kernel_record(name, args, launches[name], nnz, n_out,
                                     library[cell], reps))
        cell_ms[cell] = records[-1]["ms"]
        if "union" in name:
            fn = kernel_fns()[name][0]
            phase("profile", name=name, cell=cell, **{
                k.replace(" ", "_"): f"{v:.4f}" for k, v in
                device_breakdown(lambda: fn(*args)).items()})
    return records, cell_ms


# ---------------------------------------------------------------------------
# Phase 4e and 5: the attention path (the LM forward) and its kernel
# ---------------------------------------------------------------------------

ARCH = "llama3-8b"
PREFILL_BATCH, PREFILL_SEQ = 2, 4096
LOGITS_RTOL = 5e-2     # (a): bf16 flash vs dense logits, relative Frobenius
F32_TOL = 1e-3         # (b): f32 flash vs dense logits, atol = rtol
CHECK_LAYERS = 2       # (b)'s depth, at full width


def lm_config(**over):
    """llama3-8b with its weights in bf16, as the serving path builds it
    (``param_dtype="bfloat16"``; activations bf16, the config's default),
    with ``over`` replaced."""
    import dataclasses
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(ARCH), param_dtype="bfloat16",
                               **over)


def prefill_tokens(cfg, batch: int, seq: int, device):
    """(batch, seq) token ids from numpy seed 0."""
    import numpy as np
    import torch
    ids = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                               (batch, seq))
    return torch.from_numpy(ids).to(device)


def run_attention(cfg, batch: int, seq: int, device, reps: int):
    """Phase 4 for the attention path: ``LM(cfg).apply(variant="flash",
    last_only=True)`` over a prefill of ``batch`` prompts of ``seq`` tokens,
    with weights from a seeded generator on the device. The flash applies
    (warm-up, timed, and two more whose bits must agree) run with the
    launch counts read straight after them: on the card flash_attention
    must have launched once per layer and apply, and no other kernel at
    all. Then the checks: (a) the same weights under ``variant="dense"``,
    relative Frobenius error of the logits <= LOGITS_RTOL; (b) an f32 model
    of CHECK_LAYERS layers at the same width, flash against dense on all
    positions at F32_TOL. Returns the record and the launches."""
    import dataclasses
    import torch
    from repro_torch.core.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.models import LM
    device = resolve_device(device)
    lm = LM(cfg)
    base = (torch.cuda.memory_allocated(device) if device.type == "cuda"
            else 0)
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device).manual_seed(SEED),
                            device)
    _sync(device)
    init_s = time.perf_counter() - t0
    tokens = prefill_tokens(cfg, batch, seq, device)
    calls = []

    def prefill(variant="flash"):
        calls.append(variant)
        return lm.apply(params, tokens, variant=variant, last_only=True)[0]

    param_bytes = sum(t.numel() * t.element_size() for t in
                      _tensors(params))
    with torch.inference_mode():
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        before = dict(_build.LAUNCHES)
        run_ms = time_host(prefill, device, reps)
        out, again = prefill(), prefill()
        _sync(device)
        launches = {k: n - before[k] for k, n in _build.LAUNCHES.items()}
        runs = len(calls)
        max_mem = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
        expected = dict.fromkeys(launches, 0)
        if device.type == "cuda":
            expected["flash_attention"] = cfg.n_layers * runs
        if launches != expected:
            raise AssertionError(f"launches during the prefill {launches} are "
                                 f"not one flash_attention per layer and "
                                 f"apply: {expected}")
        # device ms per kernel of one prefill, after the counts are read
        profile = (device_breakdown(prefill, reps=1)
                   if device.type == "cuda" else {})
        dense = prefill("dense")
    if out.shape != (batch, 1, lm.vp) or not torch.isfinite(out).all():
        raise AssertionError(f"prefill logits: shape {tuple(out.shape)}, "
                             f"want {(batch, 1, lm.vp)}, all finite")
    bitwise = torch.equal(out, again)
    if not bitwise:
        raise AssertionError("two prefills gave different bits")
    rel = float((out.float() - dense.float()).norm()
                / dense.float().norm())
    if not rel <= LOGITS_RTOL:
        raise AssertionError(f"flash vs dense logits: relative Frobenius "
                             f"error {rel} > {LOGITS_RTOL}")
    del params, out, again, dense
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                                n_layers=CHECK_LAYERS)
    lm32 = LM(cfg32)
    p32 = lm32.init_params(torch.Generator(device).manual_seed(SEED + 1),
                           device)
    with torch.inference_mode():
        flash = lm32.apply(p32, tokens, variant="flash")[0]
        dense = lm32.apply(p32, tokens, variant="dense")[0]
    err = (flash - dense).abs()
    bad = int((err > F32_TOL + F32_TOL * dense.abs()).sum())
    if bad:
        raise AssertionError(f"f32 flash vs dense logits: {bad} entries off "
                             f"by up to {float(err.max())} (tolerance "
                             f"{F32_TOL})")
    rec = {"init_s": init_s, "run_ms": run_ms, "runs": runs,
           "tokens_per_s": batch * seq / (run_ms / 1e3),
           "param_bytes": param_bytes, "max_mem": max_mem,
           "base_mem": base,
           "bitwise": bitwise, "rel_frobenius": rel,
           "f32_max_abs_err": float(err.max()), "layers": cfg.n_layers,
           "profile": profile}
    del p32, flash, dense, err
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rec, launches


def _tensors(tree):
    """The tensors of a nested dict / list of parameters."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


def flash_record(cfg, batch: int, seq: int, device, dtype: str,
                 launches: int, reps: int, head_dim=None):
    """flash_attention at the model's layer shapes (q (batch, seq, H, hd);
    k, v (batch, seq, Hkv, hd); hd the model's unless ``head_dim`` is
    given; standard normal from a seeded generator) in ``dtype``: checked
    against the plain version, timed beside it and beside
    ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)`` (a
    yardstick the port never calls), with its bound: the causal flops
    2·2·B·H·hd·S²/2 over the dtype's peak (the tensor cores' for bf16 and
    f16) against q, k, v and o moved once over the memory rate."""
    import torch
    import torch.nn.functional as F
    kernel, plain = kernel_fns()["flash_attention"]
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    hd = head_dim or cfg.resolved_head_dim
    gen = torch.Generator(device).manual_seed(SEED)
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(
        getattr(torch, dtype)) for shape in
        ((batch, seq, H, hd), (batch, seq, Hkv, hd), (batch, seq, Hkv, hd)))
    err = compare_flash(f"flash_attention {dtype} hd {hd} layer shapes",
                        kernel(q, k, v), plain(q, k, v), q, v)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    flops = 2 * 2 * batch * H * hd * seq * seq / 2
    nbytes = q.element_size() * 2 * batch * seq * hd * (H + Hkv)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (F32_FLOPS if dtype == "float32" else BF16_FLOPS) * 1e3
    source, replaces = KERNELS["flash_attention"]
    return {
        "name": "flash_attention", "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": time_events(lambda: kernel(q, k, v), reps),
        "plain_ms": time_events(lambda: plain(q, k, v), max(reps // 4, 3)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": time_events(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps),
        "library_call": "torch.nn.functional.scaled_dot_product_attention("
                        "is_causal=True, enable_gqa=True)",
        "dtype": dtype,
    }


# the sLSTM kernels' phase-5 records a dtype: bf16 (path 4k's), then the
# float16 of path 4j's last run and the f32 of path 4k's twin
SLSTM_RECORD_DTYPES = (("bfloat16", ""), ("float16", "(f16)"),
                       ("float32", "(f32)"))


def slstm_launch_fields(routes: dict) -> dict:
    """A phase line's fields for a copy of ``slstm.ROUTES``: the nonzero
    counts as ``<kernel>_<design>_<dtype>``."""
    return {"_".join(key): n for key, n in routes.items() if n} or {
        "slstm": "none"}


def slstm_records(device, lm_scans: dict, train_scans: dict,
                  edge_scans: dict, edge_by_width: dict, reps: int) -> list:
    """Phase 5 for the sLSTM kernels at the shape path 4k gives them:
    xlstm-125m's sLSTM layer over one microbatch (B 2, S 4096, d 768, 4
    heads of 192), from the zero state, the forward keeping every step's
    state for the backward (training); a record a dtype of
    :data:`SLSTM_RECORD_DTYPES` (``slstm_fwd``, ``slstm_bwd`` in bf16,
    ``slstm_fwd(f16)``, ``slstm_fwd(f32)``, ...). Each kernel against its
    plain version on the same
    inputs (the largest absolute error of every output), CUDA-event
    medians of ``reps`` (the plain loops': the compared call, CUDA events
    around it), and the bound: the inputs read and outputs written once
    over 3.35 TB/s against the recurrent products' FLOPs over 67 TFLOP/s
    (f32). ``serial_floor_ms`` is S times one dependent step, measured as
    the record's own kernel over a single (b, head) chain (B = 1, one
    head) over S (:func:`_slstm_chain`).
    ``launches`` are the main path's in the record's dtype, as the wrapper
    counted them (``slstm.ROUTES``: ``lm_scans`` over the calls path 4j
    counts, ``train_scans`` over 4k, reset just before), beside
    ``lm_launches``, ``train_launches`` and ``edge_launches`` (phase 3's,
    ``edge_scans``). No single
    PyTorch call computes this recurrence: ``library_ms`` null. Each
    record names the launch shape (``slstm.plan``: blocks a cluster,
    k-slices, threads) and the exchange's own ns a step at that cluster
    width (:func:`cluster_steps`, whose ``[cluster-step]`` lines it
    prints). ``max_abs_plain`` is the
    largest plain output beside the error (the backward's gradients grow
    over S where the input gate is large). Then ``slstm_fwd(hd640)`` and
    ``slstm_bwd(hd640)``: phase 3's hd-640 case (B 3, SLSTM_HEADS heads,
    bf16), past the cluster kernels' 480, with S raised to 4096: the split
    cluster forward (``shared_terms`` a lane in shared memory, its
    exchange's ns a step at its C in ``[cluster-step]``) and the one-block
    backward (no exchange: ``cluster_step_ns`` None), the same bound and
    serial floor over a quarter of the timed launches, their launches
    phase 3's at hd 640, its B 3 and B 5 cases (``edge_by_width``,
    gathered by :func:`slstm_checks`; the main path sends them none)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import slstm as K
    cfg = get_arch(XLSTM_ARCH)
    B, S = TRAIN["batch"] // TRAIN["accum"], TRAIN["seq"]
    H = cfg.n_heads
    hd = cfg.d_model // H
    rng = np.random.default_rng(SEED + 9)
    with torch.no_grad():
        timed = {"bfloat16": _slstm_timed(rng, device, B, S, H, hd,
                                          "bfloat16", reps)}
        chain_ms = _slstm_chain(rng, device, S, hd, reps)
        step_ns = cluster_steps(device, hd, B * H, S, reps)
        for dtype, _ in SLSTM_RECORD_DTYPES[1:]:
            timed[dtype] = _slstm_timed(rng, device, B, S, H, hd, dtype,
                                        reps)
        # phase 3's case past the limit, over fewer timed launches (its
        # forward takes about 0.33 s)
        wide_B, wide_hd, wide_reps = 3, 640, max(reps // 4, 3)
        timed["hd640"] = _slstm_timed(rng, device, wide_B, S, SLSTM_HEADS,
                                      wide_hd, "bfloat16", wide_reps)
        wide_chain_ms = _slstm_chain(rng, device, S, wide_hd, wide_reps)
        wide_C = K.plan(wide_B * SLSTM_HEADS, wide_hd, torch.bfloat16)["C"]
        wide_step = cluster_steps(device, wide_hd, wide_B * SLSTM_HEADS, S,
                                  wide_reps, Cs=(wide_C,)) if wide_C else {}
    recs = []

    def record(part, tag, dtype, measured, shape, chain, counts, step,
               launches):
        err, ref, ms, plain_ms, moved, flops = measured
        base = f"slstm_{part}"
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS * 1e3
        source, replaces = KERNELS[base]
        b, s, h, d = shape
        plan = K.plan(b * h, d, getattr(torch, dtype), part == "bwd")
        return {
            "name": base + tag, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "lm_launches": counts["lm"], "train_launches": counts["train"],
            "edge_launches": counts["edge"], "max_abs_err": err,
            "max_abs_plain": ref, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "library_call": "none: no PyTorch call computes the sLSTM "
                            "recurrence",
            "serial_floor_ms": chain[part],
            "step_us": chain[part] / s * 1e3,
            "shape": f"B{b} S{s} H{h} hd{d} {dtype}", "cluster": plan["C"],
            "k_slices": plan["KS"], "threads": plan["threads"],
            "shared_terms": plan["KX"],
            "cluster_step_ns": step.get(("st.async", plan["C"]))}

    for dtype, tag in SLSTM_RECORD_DTYPES:
        for part, measured in timed[dtype].items():
            base = f"slstm_{part}"
            counts = {which: K.route_count(base, dtype=dtype, routes=routes)
                      for which, routes in (("lm", lm_scans),
                                            ("train", train_scans),
                                            ("edge", edge_scans))}
            recs.append(record(part, tag, dtype, measured, (B, S, H, hd),
                               chain_ms, counts, step_ns,
                               counts["lm"] + counts["train"]))
    for part, measured in timed["hd640"].items():
        design = "cluster" if K.plan(wide_B * SLSTM_HEADS, wide_hd,
                                     torch.bfloat16, part == "bwd")["C"] \
            else "block"
        edge = edge_by_width.get((f"slstm_{part}", design, "bfloat16",
                                  wide_hd), 0)
        recs.append(record(part, f"(hd{wide_hd})", "bfloat16", measured,
                           (wide_B, S, SLSTM_HEADS, wide_hd), wide_chain_ms,
                           {"lm": 0, "train": 0, "edge": edge},
                           wide_step if design == "cluster" else {}, edge))
    return recs


def _slstm_chain(rng, device, S, hd, reps) -> dict:
    """{"fwd" | "bwd": ms} of slstm_fwd (without the saved states) and of
    slstm_bwd over one (b, head) chain of S steps at width hd in bf16: the
    serial floor of :func:`slstm_records`' records."""
    import numpy as np
    import torch
    ins = slstm_inputs(rng, 1, S, 1, hd, "bfloat16", device, grad=False)
    zx, ip, fp, op, r, c0, h0 = ins
    y, c, h, cs, hs, zs = torch.ops.repro_torch.slstm_scan(*ins, True)
    gy = torch.from_numpy(rng.standard_normal(y.shape).astype(
        np.float32)).to(device=device, dtype=y.dtype)
    bwd_args = (gy, None, None, ip, fp, op, r, c0, cs, zs, False)
    return {"fwd": time_events(
                lambda: torch.ops.repro_torch.slstm_scan(*ins, False), reps),
            "bwd": time_events(
                lambda: torch.ops.repro_torch.slstm_scan_bwd(*bwd_args),
                reps)}


def _slstm_timed(rng, device, B, S, H, hd, dtype, reps) -> dict:
    """slstm_fwd and slstm_bwd at (B, S, H, hd) in ``dtype`` against the
    plain loops (:func:`slstm_records`): {"fwd" | "bwd": (max abs error,
    max abs plain output, kernel ms, plain ms, bytes moved, FLOPs)}."""
    import numpy as np
    import torch
    from repro_torch.kernels import slstm as K
    ins = slstm_inputs(rng, B, S, H, hd, dtype, device, grad=False)
    zx, ip, fp, op, r, c0, h0 = ins
    c0.zero_()
    h0.zero_()
    out = torch.ops.repro_torch.slstm_scan(*ins, True)
    # the plain loops take seconds: the compared call is the timed one
    want, fwd_plain = _timed(lambda: K.slstm_scan_plain(*ins, save=True))
    y, c, h, cs, hs, zs = out
    gy = torch.from_numpy(rng.standard_normal(y.shape).astype(
        np.float32)).to(device=device, dtype=y.dtype)
    bwd_args = (gy, None, None, ip, fp, op, r, c0, cs, zs, False)
    got_b = torch.ops.repro_torch.slstm_scan_bwd(*bwd_args)
    want_b, bwd_plain = _timed(lambda: K.slstm_scan_bwd_plain(*bwd_args))

    def worst(got, want):
        return (max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(got, want)),
                max(float(b.float().abs().max()) for b in want))

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts
                   if t is not None)
    d = H * hd
    fwd_ms = time_events(
        lambda: torch.ops.repro_torch.slstm_scan(*ins, True), reps)
    bwd_ms = time_events(
        lambda: torch.ops.repro_torch.slstm_scan_bwd(*bwd_args), reps)
    return {"fwd": (*worst(out, want), fwd_ms, fwd_plain,
                    nbytes(ins) + nbytes(out), 2 * B * S * d * hd),
            "bwd": (*worst(got_b, want_b), bwd_ms, bwd_plain,
                    nbytes(bwd_args[:-1]) + nbytes(got_b[:-1]),
                    2 * B * (S - 1) * d * hd)}


def cluster_steps(device, hd: int, clusters: int, steps: int,
                  reps: int, Cs=(2, 4, 8, 16)) -> dict:
    """``[cluster-step]``: the cluster kernels' exchange alone
    (``slstm_cluster_probe``), ``steps`` steps in ``clusters`` clusters of
    C blocks at each C of ``Cs``, each block storing ceil(hd / C) doubles
    (8 lanes a column, 4 where 8 would pass 512 threads) to every block of
    its cluster: by a split cluster barrier a step (``barrier``), and by
    st.async stores counted on the receivers' mbarriers (``st.async``, the
    kernels' way). CUDA-event medians of ``reps``; returns {(exchange, C):
    ns a step} and prints one line per pair."""
    import torch
    from repro_torch.kernels import slstm as K
    lib = K.library("slstm", K._SIGNATURES)
    sink = torch.empty(16 * clusters, dtype=torch.float64, device=device)
    out = {}
    for C in Cs:
        W = -(-hd // C)
        ks = 8 if W * 8 <= 512 else 4
        for mode, how in ((0, "barrier"), (1, "st.async")):
            def probe():
                err = lib.slstm_cluster_probe(
                    C, W, ks, clusters, steps, mode, sink.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"slstm_cluster_probe C={C}: CUDA "
                                       f"error {err}")
            ns = time_events(probe, reps) / steps * 1e6
            out[(how, C)] = ns
            phase("cluster-step", exchange=how, C=C, columns=W,
                  clusters=clusters, steps=steps, ns_per_step=f"{ns:.1f}")
    return out


# ---------------------------------------------------------------------------
# Path 4j: LM decode, the Server loop and the ten architectures
# ---------------------------------------------------------------------------

SERVE = dict(slots=8, context=4096, requests=16, max_new=32)
ARCH_BATCH, ARCH_SEQ = 2, 128      # each architecture's prefill
ARCH_DECODE_STEPS = 8              # decode steps timed per architecture
# the architectures of tests/test_archs.py::test_decode_matches_forward
TEACHER_FORCED = ("llama3-8b", "zamba2-7b", "xlstm-125m", "olmoe-1b-7b",
                  "seamless-m4t-medium")
TF_RTOL = 5e-2          # teacher-forced decode vs forward, rel. Frobenius
# the recurrent stacks' bf16 forward lies as far from their f32 forward as
# from their bf16 decode (xlstm-125m at full width: 0.25; zamba2-7b's 81
# layers: about 1), so their bf16 error is reported (with the bf16
# forward's against the f32 one) and the f32 one is held
BF16_HELD = ("llama3-8b", "olmoe-1b-7b", "seamless-m4t-medium")
# flash against dense logits over a whole model: within LOGITS_RTOL, or no
# farther than SENSITIVITY times the chunked variant (a second plain
# attention, the same math rounded otherwise) lies from dense on the same
# weights and tokens; zamba2's 81 bf16 layers and llama4's routing carry
# any change of the attention's rounding to about 0.4 and 0.12 (flash and
# chunked alike), while every flash call is held to its plain version
SENSITIVITY = 1.5
DEPTH_CAP = {"llama4-scout-17b-a16e": 12}    # about 204 GB at 48 layers
FIT_HEADROOM = 10 << 30      # bytes kept free beside the weights


def arch_config(name: str, free_bytes: int, **over):
    """``name`` with bf16 weights (``param_dtype="bfloat16"``, the serving
    rule) and ``over`` replaced; its depth cut to DEPTH_CAP, and further to
    what fits in ``free_bytes`` less FIT_HEADROOM at two bytes a parameter.
    Returns (config, the cut or None)."""
    import dataclasses
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch(name), param_dtype="bfloat16", **over)
    per_layer = (cfg.param_count()
                 - dataclasses.replace(cfg, n_layers=0).param_count()
                 ) / cfg.n_layers
    fixed = cfg.param_count() - per_layer * cfg.n_layers
    fit = int((free_bytes - FIT_HEADROOM - 2 * fixed) // (2 * per_layer))
    layers = min(cfg.n_layers, DEPTH_CAP.get(name, cfg.n_layers), fit)
    if layers < 1:
        raise AssertionError(f"{name} does not fit: {free_bytes} bytes free")
    if layers == cfg.n_layers:
        return cfg, None
    return (dataclasses.replace(cfg, n_layers=layers),
            f"{cfg.n_layers}->{layers} layers")


def frontend_embeds(cfg, batch: int, device):
    """(batch, frontend_tokens, d_model) standard normal from seed 2, or
    None for a model without a frontend."""
    import torch
    if cfg.frontend == "none":
        return None
    gen = torch.Generator(device).manual_seed(SEED + 2)
    return torch.randn((batch, cfg.frontend_tokens, cfg.d_model),
                       generator=gen, device=device)


def flash_layers(lm) -> int:
    """Causal self-attention layers of one forward: flash_attention's
    launches per apply under ``variant="flash"`` (the encoder and the
    cross-attention are not causal and take the plain path)."""
    kind = lm.group_kind
    if kind in ("dense", "moe", "moe_interleaved"):
        return lm.cfg.n_layers
    return lm.n_groups if kind == "hybrid" else 0


def fill_cross(lm, params, cache, fe) -> None:
    """Encode ``fe`` once and stash each decoder layer's cross K/V in the
    cache (tests/test_archs.py::test_decode_matches_forward's way)."""
    enc = lm._run_encoder(params, fe, 0, "auto")
    for g in range(lm.n_groups):
        k, v = lm._encode_kv(params["cross"][g]["attn"], enc)
        cache["enc_k"][g].copy_(k)
        cache["enc_v"][g].copy_(v)


def _rel(got, want) -> float:
    """Relative Frobenius error (the largest |got| where want is 0)."""
    den = float(want.double().norm())
    return float((got.double() - want.double()).norm()) / den if den else \
        float(got.abs().max())


def slstm_layers(lm) -> int:
    """sLSTM layers of one forward: slstm_fwd's launches per apply and per
    decode step."""
    if lm.group_kind != "xlstm":
        return 0
    return lm.n_groups * lm.cfg.xlstm_pattern.count("s")


def checked_flash_apply(lm, params, tokens, fe, label):
    """``lm.apply(variant="flash")`` over every position, with each
    flash_attention call held against its plain version on the same q, k
    and v (:func:`compare_flash`: FLASH_TOL of the dtype, position 0 equal
    to v[0]), and each sLSTM scan (``slstm_fwd``) against the plain loop
    on the same inputs (y and the final state at SLSTM_TOL of the dtype),
    so the kernels are checked at every shape and on every input the main
    path gives them. Returns the logits, flash's largest error, the
    calls' shapes ("HxHkvxhd" each) and the scans' largest error."""
    import torch
    from repro_torch.kernels import slstm as K
    from repro_torch.models import attention
    from repro_torch.models import xlstm as XL
    kernel, plain = kernel_fns()["flash_attention"]
    errs, shapes, scan_errs = [], set(), []

    def checked(q, k, v, **kw):
        got = kernel(q, k, v, **kw)
        shape = f"{q.shape[2]}x{k.shape[2]}x{q.shape[3]}"
        errs.append(compare_flash(f"{label} flash_attention "
                                  f"{tuple(q.shape)} {tuple(k.shape)}",
                                  got, plain(q, k, v), q, v))
        shapes.add(shape)
        return got

    def checked_scan(*ins):
        got = K.slstm_scan(*ins)
        want = K.slstm_scan_plain(*ins)[:3]
        tol = SLSTM_TOL[str(ins[0].dtype).split(".")[-1]]
        for name, a, b in zip(("y", "c", "h"), got, want):
            a, b = a.float(), b.float()
            err = (a - b).abs()
            if not torch.isfinite(a).all() or (err > tol + tol
                                                * b.abs()).any():
                raise AssertionError(f"{label} slstm_fwd "
                                     f"{tuple(ins[0].shape)}: {name} off by "
                                     f"up to {float(err.max())} (tolerance "
                                     f"{tol})")
            scan_errs.append(float(err.max()))
        return got

    attention.flash_attention = checked
    XL.slstm_scan = checked_scan
    try:
        logits = lm.apply(params, tokens, fe, variant="flash")[0]
    finally:
        attention.flash_attention = kernel
        XL.slstm_scan = K.slstm_scan
    return logits, max(errs, default=0.0), ",".join(sorted(shapes)), \
        max(scan_errs, default=0.0)


def teacher_forced(lm, params, tokens, fe, device):
    """Decode ``tokens`` one step at a time from an empty cache; returns
    the relative Frobenius error of the steps' logits against the
    forward's (``variant="flash"``) over every position, and the
    forward's logits."""
    import torch
    B, S = tokens.shape
    full, _ = lm.apply(params, tokens, fe if lm.cfg.is_encdec else None,
                       variant="flash")
    cache = lm.init_cache(B, S, device=device,
                          src_len=lm.cfg.frontend_tokens
                          if lm.cfg.is_encdec else 0)
    if lm.cfg.is_encdec:
        fill_cross(lm, params, cache, fe)
    steps = [lm.decode_step(params, cache, tokens[:, s])[0]
             for s in range(S)]
    return _rel(torch.stack(steps, 1), full), full


def run_arch(cfg, batch: int, seq: int, device, steps: int,
             teacher: bool):
    """One architecture at ``cfg``'s width: weights from a seeded
    generator on the device; the ``flash`` prefill of ``batch`` x ``seq``
    tokens (with its frontend: llava's prefix, seamless's encoder frames)
    through ``LM.apply(last_only=True)``: a warm-up, a timed median, two
    more whose bits must agree; ``steps`` decode steps from an empty cache,
    each timed, twice from two caches with the same bits. Launches are
    read straight after the prefills and decodes: flash_attention once per
    causal self-attention layer and prefill, nothing else. Then, not
    counted, :func:`checked_flash_apply` over all positions, and the same
    weights and tokens under ``variant="dense"`` and ``"chunked"``: the
    flash logits' relative Frobenius error against dense <= LOGITS_RTOL,
    or <= SENSITIVITY x chunked's against dense. With
    ``teacher``, the teacher-forced decode over the ``seq`` positions
    against the forward in bf16 (held to TF_RTOL for BF16_HELD) and with
    f32 activations over the same weights (always held). Returns the
    record and the launches."""
    import dataclasses
    import torch
    from repro_torch.kernels import _build, slstm as K
    from repro_torch.models import LM
    lm = LM(cfg)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device).manual_seed(SEED),
                            device)
    _sync(device)
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size() for t in
                      _tensors(params))
    tokens = prefill_tokens(cfg, batch, seq, device)
    fe = frontend_embeds(cfg, batch, device)
    runs, last = [], []

    def prefill():
        runs.append(1)
        out = lm.apply(params, tokens, fe, variant="flash",
                       last_only=True)[0]
        last[:] = last[-1:] + [out]
        return out

    src = cfg.frontend_tokens if cfg.is_encdec else 0

    def decode(timed):
        cache = lm.init_cache(batch, seq + steps, device=device,
                              src_len=src)
        if cfg.is_encdec:
            fill_cross(lm, params, cache, fe)
        for s in range(steps):
            t = time.perf_counter()
            logits, cache = lm.decode_step(params, cache, tokens[:, s])
            _sync(device)
            timed.append((time.perf_counter() - t) * 1e3)
        return logits

    with torch.inference_mode():
        before, before_scans = dict(_build.LAUNCHES), dict(K.ROUTES)
        # the last two timed prefills' logits are the bit check
        prefill_ms = time_host(prefill, device, 3)
        out, again = last
        step_ms, spare = [], []
        last, last2 = decode(step_ms), decode(spare)
        _sync(device)
        launches = {k: n - before[k] for k, n in _build.LAUNCHES.items()}
        scans = {key: n - before_scans[key] for key, n in K.ROUTES.items()
                 if n != before_scans[key]}
        expected = dict.fromkeys(launches, 0)
        if device.type == "cuda":
            expected["flash_attention"] = flash_layers(lm) * len(runs)
            expected["slstm_fwd"] = slstm_layers(lm) * (len(runs)
                                                        + 2 * steps)
        if launches != expected or any(
                K.route_count(k, routes=scans) != launches[k]
                for k in ("slstm_fwd", "slstm_bwd")):
            raise AssertionError(f"{cfg.name}: launches {launches}, want "
                                 f"{expected}; sLSTM's by design and dtype "
                                 f"{scans}")
        for name, t in (("prefill", out), ("decode", last)):
            if not torch.isfinite(t.float()).all():
                raise AssertionError(f"{cfg.name}: non-finite {name} logits")
        if out.shape != (batch, 1, lm.vp) or last.shape != (batch, lm.vp):
            raise AssertionError(f"{cfg.name}: logits {tuple(out.shape)}, "
                                 f"{tuple(last.shape)}")
        if not (torch.equal(out, again) and torch.equal(last, last2)):
            raise AssertionError(f"{cfg.name}: two calls gave other bits")
        flash, kernel_err, shapes, slstm_err = checked_flash_apply(
            lm, params, tokens, fe, cfg.name)
        dense = lm.apply(params, tokens, fe, variant="dense")[0]
        vs_dense = _rel(flash, dense)
        del flash
        chunked_vs_dense = _rel(
            lm.apply(params, tokens, fe, variant="chunked")[0], dense)
        del dense
        limit = max(LOGITS_RTOL, SENSITIVITY * chunked_vs_dense)
        if not vs_dense <= limit:
            raise AssertionError(f"{cfg.name}: flash vs dense logits: "
                                 f"relative Frobenius {vs_dense} > {limit} "
                                 f"(chunked vs dense {chunked_vs_dense})")
        rec = {"arch": cfg.name, "layers": cfg.n_layers,
               "d_model": cfg.d_model, "init_s": init_s,
               "param_bytes": param_bytes, "prefill_ms": prefill_ms,
               "decode_ms": statistics.median(step_ms + spare),
               "flash_launches": launches.get("flash_attention", 0),
               "flash_vs_dense": vs_dense,
               "chunked_vs_dense": chunked_vs_dense, "kernel_err": kernel_err,
               "kernel_shapes": shapes,
               "slstm_launches": launches.get("slstm_fwd", 0),
               "slstm_scans": scans, "slstm_err": slstm_err}
        if teacher:
            rec["tf_rel_bf16"], full16 = teacher_forced(lm, params, tokens,
                                                        fe, device)
            lm32 = LM(dataclasses.replace(cfg, dtype="float32"))
            rec["tf_rel_f32"], full32 = teacher_forced(lm32, params, tokens,
                                                       fe, device)
            # how far bf16 activations alone carry the forward
            rec["fwd_rel_bf16_f32"] = _rel(full16, full32)
            del full16, full32
            held = [("f32", rec["tf_rel_f32"])]
            if cfg.name in BF16_HELD:
                held.append(("bf16", rec["tf_rel_bf16"]))
            for label, rel in held:
                if not rel <= TF_RTOL:
                    raise AssertionError(
                        f"{cfg.name}: teacher-forced decode vs forward in "
                        f"{label}: relative Frobenius {rel} > {TF_RTOL}")
    rec["max_mem"] = (torch.cuda.max_memory_allocated(device)
                      if device.type == "cuda" else 0)
    del params
    return rec, launches


def run_server(cfg, device, slots: int, context: int, requests: int,
               max_new: int):
    """The LM Server at ``cfg`` (weights from seed 0 on the device):
    ``requests`` requests drawn as the reference's ``main`` draws them
    (seed 0, prompts of 4-16 tokens), ``max_new`` tokens each, on
    ``slots`` slots of ``context`` positions. Checks: every request gets
    ``max_new`` tokens; a second run on the same Server gives the same
    tokens; every request that took a freed slot gets, alone in a fresh
    Server on the same weights, the same tokens. Returns the record."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import Server, draw_requests
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    srv = Server(cfg, slots=slots, context=context, device=device)
    _sync(device)
    t0 = time.perf_counter()
    out = srv.run(draw_requests(cfg.vocab_size, requests, max_new))
    run_s = time.perf_counter() - t0
    step_ms = list(srv.step_ms)
    max_mem = (torch.cuda.max_memory_allocated(device)
               if device.type == "cuda" else 0)
    if sorted(out) != list(range(requests)) or any(
            len(v) != max_new for v in out.values()):
        raise AssertionError(f"server: token counts "
                             f"{[len(v) for v in out.values()]}")
    if srv.run(draw_requests(cfg.vocab_size, requests, max_new)) != out:
        raise AssertionError("server: a second run gave other tokens")
    # one decode step over the full slots, the cache written in place
    # against a copy of the whole cache a step (the bytes the reference's
    # functional attention_decode copies, layer by layer)
    lm, params, cache = srv.lm, srv.params, srv.cache
    toks = torch.zeros(slots, dtype=torch.long, device=device)
    with torch.inference_mode():
        inplace_ms = time_host(
            lambda: lm.decode_step(params, cache, toks), device, 5)
        copied_ms = time_host(
            lambda: lm.decode_step(params, {k: v.clone() for k, v in
                                            cache.items()}, toks), device, 5)
        # device ms per kernel of one full step: the rest of the step's
        # host-clock time the card waits on the host
        profile = (device_breakdown(
            lambda: lm.decode_step(params, cache, toks), reps=2)
            if device.type == "cuda" else {})
    cache_bytes = sum(v.numel() * v.element_size() for v in cache.values())
    del srv, cache
    reused = draw_requests(cfg.vocab_size, requests, max_new)[slots:]
    for r in reused:
        alone = Server(cfg, slots=slots, context=context, device=device,
                       params=params)
        got = alone.run([r])[r.rid]
        del alone
        if got != out[r.rid]:
            raise AssertionError(f"server: request {r.rid} in a reused slot "
                                 f"gave {out[r.rid]}, alone {got}")
    tokens = sum(len(v) for v in out.values())
    return {"requests": requests, "tokens": tokens, "run_s": run_s,
            "tokens_per_s": tokens / run_s, "steps": len(step_ms),
            "step_ms_median": statistics.median(step_ms),
            "step_ms_p99": float(np.percentile(step_ms, 99)),
            "max_mem": max_mem, "fresh_slot_checked": len(reused),
            "step_ms_inplace": inplace_ms, "step_ms_copied": copied_ms,
            "cache_bytes": cache_bytes, "profile": profile}


def lm_path(device, serve=SERVE,
            batch: int = ARCH_BATCH, seq: int = ARCH_SEQ,
            steps: int = ARCH_DECODE_STEPS, reduce=None):
    """Path 4j: (a) the Server on llama3-8b at full width and depth, bf16
    weights; (b) every architecture at full width (depth cut only to fit
    the card, printed), bf16 weights, then xlstm-125m again with float16
    activations; one ``[serve-lm]`` line and one ``[lm]`` line per
    architecture and dtype. ``reduce`` (a config -> config map)
    shrinks the models for a rehearsal on the CPU. Returns the launches
    summed over the path and the sLSTM kernels' launches of the same
    calls by (kernel, design, dtype) (``slstm.ROUTES``' keys)."""
    import torch
    from repro_torch.configs import all_archs
    free = (torch.cuda.mem_get_info(device)[0] if device.type == "cuda"
            else 1 << 40)
    cfg, _ = arch_config(ARCH, free)
    srv = run_server(reduce(cfg) if reduce else cfg, device, **serve)
    phase("serve-lm", arch=ARCH, slots=serve["slots"],
          context=serve["context"], requests=srv["requests"],
          tokens=srv["tokens"], steps=srv["steps"],
          run_s=f"{srv['run_s']:.3f}",
          tokens_per_s=f"{srv['tokens_per_s']:.1f}",
          step_ms_median=f"{srv['step_ms_median']:.3f}",
          step_ms_p99=f"{srv['step_ms_p99']:.3f}",
          max_mem_gb=f"{srv['max_mem'] / 2**30:.2f}",
          cache_gb=f"{srv['cache_bytes'] / 2**30:.2f}",
          step_ms_in_place=f"{srv['step_ms_inplace']:.3f}",
          step_ms_cache_copied=f"{srv['step_ms_copied']:.3f}",
          step_device_ms=f"{sum(srv['profile'].values()):.3f}",
          repeat_bitwise=True,
          fresh_slot_requests=srv["fresh_slot_checked"])
    top = sorted(srv["profile"].items(), key=lambda kv: -kv[1])[:8]
    phase("profile", name="server decode step",
          total_ms=f"{sum(srv['profile'].values()):.3f}",
          **{k.replace(" ", "_"): f"{v:.3f}" for k, v in top})
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    total, scans = {}, {}
    # the ten in bf16 activations, then xlstm-125m in float16 (the sLSTM
    # kernels' f16 instances, every scan held to the plain loop)
    runs = [(name, {}) for name in sorted(all_archs())] + [
        (XLSTM_ARCH, {"dtype": "float16"})]
    for name, dtype in runs:
        free = (torch.cuda.mem_get_info(device)[0]
                if device.type == "cuda" else 1 << 40)
        over = dict(dtype, **({"moe_capacity_factor": 16.0}
                              if name == "olmoe-1b-7b" else {}))
        cfg, cut = arch_config(name, free, **over)
        rec, launches = run_arch(reduce(cfg) if reduce else cfg, batch, seq,
                                 device, steps,
                                 name in TEACHER_FORCED and not dtype)
        _add_launches(total, launches)
        _add_launches(scans, rec["slstm_scans"])
        tf = {}
        if "tf_rel_f32" in rec:
            tf = {"tf_rel_bf16": f"{rec['tf_rel_bf16']:.4g}",
                  "tf_rel_f32": f"{rec['tf_rel_f32']:.4g}",
                  "fwd_rel_bf16_vs_f32": f"{rec['fwd_rel_bf16_f32']:.4g}",
                  "bf16_held": name in BF16_HELD}
        phase("lm", arch=name, dtype=cfg.dtype, layers=rec["layers"],
              cut=cut or "none", d_model=rec["d_model"],
              weights_gb=f"{rec['param_bytes'] / 2**30:.2f}",
              init_s=f"{rec['init_s']:.2f}",
              prefill_ms=f"{rec['prefill_ms']:.3f}",
              decode_ms=f"{rec['decode_ms']:.3f}",
              max_mem_gb=f"{rec['max_mem'] / 2**30:.2f}",
              flash_launches=rec["flash_launches"], bitwise_repeat=True,
              flash_shapes=rec["kernel_shapes"] or "none",
              kernel_max_abs_err=f"{rec['kernel_err']:.4g}",
              slstm_launches=rec["slstm_launches"],
              slstm_max_abs_err=f"{rec['slstm_err']:.4g}",
              flash_vs_dense=f"{rec['flash_vs_dense']:.4g}",
              chunked_vs_dense=f"{rec['chunked_vs_dense']:.4g}", **tf)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return total, scans


# ---------------------------------------------------------------------------
# Path 4k: the training stack
# ---------------------------------------------------------------------------

TRAIN_ARCH = "internlm2-1.8b"
# the reference's train_4k length; a global batch of 8 in 4 microbatches;
# the first 5 steps of a 10,000-step run at peak lr 3e-4 (the Trainer's
# default schedule: a 200-step warm-up). Without a warm-up (total_steps 8)
# the loss rose from 11.85 to 12.34 and gnorm to 104 (PERF.md §6).
TRAIN = dict(seq=4096, batch=8, accum=4, steps=5, lr=3e-4,
             total_steps=10000)
# (5) xlstm-125m through the same Trainer at 4k's shape: the first 3 steps
# of a 30-step run (a 3-step warm-up to peak lr 3e-4)
XLSTM_ARCH = "xlstm-125m"
XLSTM_TRAIN = dict(TRAIN, steps=3, total_steps=30)
TWIN = dict(layers=2, batch=2, seq=256)     # the f32 twin, full width
TWIN_LOSS_RTOL, TWIN_GRAD_RTOL, TWIN_ADAMW_TOL = 1e-5, 1e-3, 1e-6
RESTART = dict(seq=64, batch=8, accum=2, ckpt_every=2, first=4, more=2)
# the Trainer's schedule: the first step's lr is 3e-4 / 200 = 1.5e-6, so an
# AdamW step near lr * sign(g) that flips where |g| is near 0 (up to 2 lr)
# stays inside TRAIN_TOL; the first moments (the reduced gradient) are held
# too. At lr 1e-3 a flip moved a parameter by 1.6e-5 (PERF.md §6).
MESH_TRAIN = dict(shape=(2, 2), seq=32, batch=8, accum=2, lr=3e-4)
TRAIN_TOL = 1e-5     # (3)'s losses and (4)'s against one process
TRAIN_DIR = ROOT / "build" / "train"


def _train_shape(seq: int, batch: int, accum: int):
    from repro_torch.configs import ShapeConfig
    return ShapeConfig("train", "train", seq_len=seq, global_batch=batch,
                       grad_accum=accum)


def _state_bytes(tr) -> int:
    from repro_torch.tree import leaves
    return sum(x.numel() * x.element_size()
               for x in leaves((tr.params, tr.opt.mu, tr.opt.nu)))


def _count_calls(module, names):
    """Wrap ``module``'s functions ``names`` so each call adds one to its
    count; returns the counts and a function that undoes the wrapping."""
    counts = dict.fromkeys(names, 0)
    orig = {n: getattr(module, n) for n in names}

    def wrap(n):
        def counted(*a, **k):
            counts[n] += 1
            return orig[n](*a, **k)
        return counted
    for n in names:
        setattr(module, n, wrap(n))
    return counts, lambda: [setattr(module, n, f) for n, f in orig.items()]


def train_full(cfg, device, seq: int, batch: int, accum: int, steps: int,
               lr: float, total_steps: int, tag: str = "train",
               same_batch: bool = False):
    """(1) The ``Trainer`` on ``cfg`` (remat on, f32 params, bf16
    activations), ``steps`` steps of ``batch`` x ``seq`` tokens in
    ``accum`` microbatches from ``Pipeline`` seed 0 on the schedule of
    ``total_steps`` at peak ``lr``, no checkpoint. One
    ``[<tag>]`` line a step. Checks: finite losses and gnorms, the last
    loss below the first (with ``same_batch``: the loss of the first
    step's batch, taken again after the last step under ``no_grad`` over
    its microbatches, below the first step's: a falling loss seen through
    the batch-to-batch spread of a few steps), every attention call
    ``dense`` (the layers times
    the microbatches, twice a step under remat: the forward and its
    recomputation) and, of the kernel table, only the sLSTM kernels
    launched, exactly: ``slstm_fwd`` once per sLSTM layer and microbatch
    for the forward and again for its recomputation, ``slstm_bwd`` once
    for the backward (none for internlm2-1.8b). The last step runs under
    ``FlopCounterMode`` (its count is ``step_flops``) and is left out of
    the median step time."""
    import math
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import _build
    from repro_torch.launch.train import Trainer
    from repro_torch.models import attention as A
    from repro_torch.tree import leaves
    base = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)        # the context, made if new
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    tr = Trainer(cfg, _train_shape(seq, batch, accum), peak_lr=lr,
                 total_steps=total_steps, device=device)
    init_s = time.perf_counter() - t0
    counts, undo = _count_calls(A, ("_dense_attention",
                                    "_chunked_attention",
                                    "_windowed_attention", "flash_attention"))
    _build.reset_launches()
    try:
        tr.run(steps - 1, log_every=steps + 1)
        # the last step's FLOPs as FlopCounterMode counts them (path 4l
        # holds the dry-run's count to it); its time is left out below
        with FlopCounterMode(display=False) as fc:
            tr.run(steps, log_every=steps + 1)
    finally:
        undo()
        tr.pipeline.close()
    launched = {k: n for k, n in _build.LAUNCHES.items() if n}
    log = tr.metrics_log
    for rec in log:
        phase(tag, step=rec["step"], loss=f"{rec['loss']:.6f}",
              gnorm=f"{rec['gnorm']:.6f}", lr=f"{rec['lr']:.6g}",
              step_s=f"{rec['seconds']:.3f}")
    losses = [r["loss"] for r in log]
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["gnorm"])
               for r in log):
        raise AssertionError(f"train: a loss or gnorm is not finite: {log}")
    again = None
    if same_batch:
        from repro_torch.data.pipeline import DataConfig, TokenSource
        tok = torch.from_numpy(TokenSource(DataConfig(
            cfg.vocab_size, seq, batch)).batch_at(0)["tokens"]).to(device)
        with torch.no_grad():
            again = sum(float(tr.lm.loss(tr.params, t))
                        for t in tok.chunk(tr.accum)) / tr.accum
        if not (math.isfinite(again) and again < losses[0]):
            raise AssertionError(f"train: the first step's batch has loss "
                                 f"{again} after {steps} steps, not below "
                                 f"its first {losses[0]}")
    elif not losses[-1] < losses[0]:
        raise AssertionError(f"train: the last loss {losses[-1]} is not "
                             f"below the first {losses[0]}")
    replays = 2 if cfg.remat else 1
    scans = slstm_layers(tr.lm) * tr.accum * steps
    attn = 0 if tr.lm.group_kind == "xlstm" else cfg.n_layers
    if counts != {"_dense_attention": replays * attn * tr.accum * steps,
                  "_chunked_attention": 0, "_windowed_attention": 0,
                  "flash_attention": 0}:
        raise AssertionError(f"train: attention calls {counts}, want "
                             f"{replays * attn * tr.accum * steps} dense")
    want = ({"slstm_fwd": replays * scans, "slstm_bwd": scans}
            if scans and device.type == "cuda" else {})
    if launched != want:
        raise AssertionError(f"train: kernels launched on the training "
                             f"path: {launched}, want {want}")
    later = sorted(r["seconds"] for r in log[1:-1]) or [log[0]["seconds"]]
    med = later[len(later) // 2]
    rec = {"init_s": init_s, "step_s_median": med,
           "first_step_s": log[0]["seconds"],
           "tokens_per_s": batch * seq / med,
           "max_mem": (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else 0),
           "base_mem": base, "step_flops": fc.get_total_flops(),
           "state_bytes": _state_bytes(tr), "losses": losses,
           "attention_calls": counts["_dense_attention"],
           "launches": launched, "first_batch_again": again,
           "params": sum(x.numel() for x in leaves(tr.params))}
    del tr
    return rec


def train_twin(cfg, device, seq: int, batch: int):
    """(2) The f32 twin: ``cfg`` in f32 activations, one ``loss_and_grads``
    on ``batch`` x ``seq`` tokens (``Pipeline`` seed 0) from the same
    weights (seed 1, drawn on the card and copied) on the card and on the
    host's CPU: the loss within TWIN_LOSS_RTOL, each leaf's gradient
    within TWIN_GRAD_RTOL (relative Frobenius; TF32 off). Then one
    ``adamw_update`` on the card and on the CPU from the card's gradients:
    the new parameters and moments within TWIN_ADAMW_TOL.

    With sLSTM layers the whole model's gradient is not held card against
    CPU: h = o c / max(|c|, 1) has a kink at |c| = 1, and the f32 ulps
    by which the two devices' earlier layers differ move a few of the
    S·B·d values of c across it, each changing its gradient by O(1)
    (xlstm-125m's twin: 2 of 393,216, 6e-3 apart; PERF.md §6). Instead
    (:func:`scan_twin`) the card's gradients through the kernels are held
    within TWIN_GRAD_RTOL of the card's through the plain loop, and each
    sLSTM scan's gradients on the card within TWIN_GRAD_RTOL of the CPU's
    on the same inputs; the whole model's gap and the count of c that
    cross the kink are reported."""
    import dataclasses
    import torch
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import LM
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.tree import leaves, tree_map
    cfg = dataclasses.replace(cfg, dtype="float32")
    shape = _train_shape(seq, batch, 1)
    tok = TokenSource(DataConfig(cfg.vocab_size, seq, batch)).batch_at(0)
    gen = torch.Generator(device).manual_seed(SEED + 1)
    params = LM(cfg).init_params(gen, device)
    host = tree_map(lambda p: p.detach().cpu(), params)
    out = {}
    for dev, p in ((device, params), (torch.device("cpu"), host)):
        lm = S.build_lm(cfg, make_smoke_mesh(dev))
        lg = S.make_loss_and_grads(lm, shape)
        t0 = time.perf_counter()
        with _scan_inputs() as scans:
            loss, g = lg(p, torch.from_numpy(tok["tokens"]).to(dev))
        _sync(dev)
        out[dev.type] = (float(loss), g, time.perf_counter() - t0, scans)
    (l_card, g_card, s_card, scans), (l_cpu, g_cpu, s_cpu, cpu_scans) = \
        out[device.type], out["cpu"]
    grad_err = max(_rel(a.cpu(), b)
                   for a, b in zip(leaves(g_card), leaves(g_cpu)))
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    held = TWIN_GRAD_RTOL if not scans else float("inf")
    if loss_err > TWIN_LOSS_RTOL or grad_err > held:
        raise AssertionError(f"twin: loss {l_card} vs {l_cpu} ({loss_err:.3g}"
                             f"), gradient {grad_err:.3g}")
    extra = {}
    if scans:
        lg = S.make_loss_and_grads(S.build_lm(cfg, make_smoke_mesh(device)),
                                   shape)
        extra = scan_twin(lg, params, torch.from_numpy(tok["tokens"]).to(
            device), g_card, scans, cpu_scans)
    g_host = tree_map(lambda g: g.cpu(), g_card)
    new = []
    for p, g in ((params, g_card), (host, g_host)):
        opt = adamw_init(p)
        p2, opt2, gn = adamw_update(p, g, opt, lr=TRAIN["lr"])
        new.append([x.cpu() for x in leaves((p2, opt2.mu, opt2.nu))])
    adamw_err = max(float((a - b).abs().max())
                    for a, b in zip(*new))
    if adamw_err > TWIN_ADAMW_TOL:
        raise AssertionError(f"twin: adamw_update on the card vs the CPU "
                             f"{adamw_err:.3g}")
    return {"loss": l_card, "loss_rel": loss_err, "grad_rel": grad_err,
            "adamw_abs": adamw_err, "card_s": s_card, "cpu_s": s_cpu,
            **extra}


class _scan_inputs:
    """Record the inputs of every sLSTM scan the model calls in the
    block (detached)."""

    def __enter__(self):
        from repro_torch.kernels import slstm as K
        from repro_torch.models import xlstm as XL
        self.calls = []

        def recorded(*ins):
            self.calls.append([t.detach() for t in ins])
            return K.slstm_scan(*ins)
        XL.slstm_scan = recorded
        return self.calls

    def __exit__(self, *exc):
        from repro_torch.kernels import slstm as K
        from repro_torch.models import xlstm as XL
        XL.slstm_scan = K.slstm_scan


def scan_twin(lg, params, tokens, g_card, scans, cpu_scans) -> dict:
    """The sLSTM half of the f32 twin (:func:`train_twin`): (a) the
    gradients of ``lg`` on the card with each scan run as the plain loop
    (autograd) against ``g_card``, through the kernels, each leaf within
    TWIN_GRAD_RTOL; (b) each recorded scan of the card's forward run again
    on the card and on the CPU from the same inputs, the gradients of a
    random weighting of y with respect to zx, ip, fp, op and r within
    TWIN_GRAD_RTOL; (c) how many c of the card's and the CPU's scans lie
    on either side of |c| = 1 (reported)."""
    import numpy as np
    import torch
    from repro_torch.kernels import slstm as K
    from repro_torch.models import xlstm as XL
    from repro_torch.tree import leaves
    XL.slstm_scan = lambda *ins: K.slstm_scan_plain(*ins)[:3]
    try:
        _, g_plain = lg(params, tokens)
    finally:
        XL.slstm_scan = K.slstm_scan
    vs_plain = max(_rel(a, b) for a, b in zip(leaves(g_card),
                                               leaves(g_plain)))
    rng = np.random.default_rng(SEED + 3)
    vs_cpu, flips = 0.0, 0
    for ins, cpu_ins in zip(scans, cpu_scans):
        w = torch.from_numpy(rng.standard_normal(ins[0].shape).astype(
            np.float32))
        grads = []
        for dev_ins in (ins, [t.cpu() for t in ins]):
            x = [t.clone().requires_grad_(i < 5)
                 for i, t in enumerate(dev_ins)]
            y = K.slstm_scan(*x)[0]
            grads.append(torch.autograd.grad(
                (y * w.to(y.device)).sum(), x[:5]))
        vs_cpu = max([vs_cpu] + [_rel(a.cpu(), b) for a, b in
                                 zip(*grads)])
        with torch.no_grad():
            c_card = K.slstm_scan_plain(*[t.cpu() for t in ins],
                                        save=True)[3]
            c_cpu = K.slstm_scan_plain(*cpu_ins, save=True)[3]
        flips += int(((c_card.abs() >= 1) != (c_cpu.abs() >= 1)).sum())
    if vs_plain > TWIN_GRAD_RTOL or vs_cpu > TWIN_GRAD_RTOL:
        raise AssertionError(f"twin: gradients through the kernels vs the "
                             f"plain loop on the card {vs_plain:.3g}, the "
                             f"scans' card vs CPU {vs_cpu:.3g}")
    return {"kernel_vs_plain_rel": vs_plain, "scan_card_vs_cpu_rel": vs_cpu,
            "kink_flips": flips}


def train_restart(cfg, device, seq: int, batch: int, accum: int,
                  ckpt_every: int, first: int, more: int,
                  root: Path = TRAIN_DIR):
    """(3) A ``Trainer`` with ``ckpt_every`` runs ``first`` steps into a
    checkpoint directory under ``root``; a second ``Trainer`` on a copy of
    it resumes at step ``first`` and draws the same next batch; both then
    run ``more`` steps, whose losses must agree within TRAIN_TOL. The
    directory goes after."""
    import shutil
    import numpy as np
    from repro_torch.launch.train import Trainer
    shape = _train_shape(seq, batch, accum)
    a, b = root / "restart_a", root / "restart_b"
    for d in (a, b):
        shutil.rmtree(d, ignore_errors=True)
    try:
        tr = Trainer(cfg, shape, ckpt_dir=str(a), ckpt_every=ckpt_every,
                     device=device)
        tr.run(first, log_every=first + more + 1)
        shutil.copytree(a, b)
        tr2 = Trainer(cfg, shape, ckpt_dir=str(b), ckpt_every=ckpt_every,
                      device=device)
        if tr2.step != first:
            raise AssertionError(f"restart: resumed at {tr2.step}, not "
                                 f"{first}")
        cursor = tr.pipeline.cursor()
        b1, b2 = next(tr.pipeline), next(tr2.pipeline)
        if not np.array_equal(b1["tokens"], b2["tokens"]):
            raise AssertionError("restart: the next batches differ")
        tr.pipeline.restore(cursor)
        tr2.pipeline.restore(cursor)
        tr.run(first + more, log_every=first + more + 1)
        tr2.run(first + more, log_every=first + more + 1)
        got = [r["loss"] for r in tr2.metrics_log]
        want = [r["loss"] for r in tr.metrics_log[first:]]
        err = max(abs(x - y) / abs(y) for x, y in zip(got, want))
        if len(got) != more or err > TRAIN_TOL:
            raise AssertionError(f"restart: losses {got} vs {want}")
        tr.pipeline.close()
        tr2.pipeline.close()
    finally:
        for d in (a, b):
            shutil.rmtree(d, ignore_errors=True)
    return {"resumed_at": first, "losses": got, "loss_rel": err}


def train_mesh_rank(rank: int, world: int, store: str, out_dir: str,
                    arch: str, mesh_shape, device: str, seq: int,
                    batch: int, accum: int, lr: float) -> None:
    """One rank of (4): the reduced ``arch`` in f32 activations on a
    (data, model) mesh of ``mesh_shape`` over gloo; the whole parameters
    from seed 0 on the rank's device, of which it keeps only its planned
    blocks; one train step on ``Pipeline`` seed 0's first batch. Writes
    ``rank<r>.json`` (its loss, gnorm, whether every local shape is its
    spec's block, the bytes it holds and the step's collective bytes by
    kind) and, on rank 0, the gathered new
    parameters and first moments; exits non-zero on any failure."""
    import dataclasses
    import datetime
    import os
    import traceback
    import numpy as np
    import torch
    import torch.distributed as dist
    status = {"rank": rank, "ok": False}
    try:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        torch.backends.cuda.matmul.allow_tf32 = False
        from repro_torch.configs import get_arch
        from repro_torch.data.pipeline import DataConfig, TokenSource
        from repro_torch.distributed import mesh as M, planner
        from repro_torch.launch import steps as S
        from repro_torch.models import LM
        from repro_torch.optim import adamw_init
        from repro_torch.tree import leaves
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=120))
        mesh = M.make_mesh(mesh_shape, ("data", "model"), backend="gloo",
                           device=device)
        cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
        gen = torch.Generator(mesh.device).manual_seed(SEED)
        whole = LM(cfg).init_params(gen, mesh.device)
        specs = planner.params_pspecs(whole, mesh)
        params = planner.place(whole, specs, mesh)
        want = [tuple(x[planner.block_of(x.shape, sp, mesh)].shape)
                for x, sp in zip(leaves(whole),
                                 leaves(specs, is_leaf=planner.is_spec))]
        whole_bytes = sum(x.numel() * 4 for x in leaves(whole))
        del whole
        fn, _ = S.make_train_step(S.build_lm(cfg, mesh),
                                  _train_shape(seq, batch, accum), mesh,
                                  peak_lr=lr, param_specs=specs)
        opt = adamw_init(params)
        tok = TokenSource(DataConfig(cfg.vocab_size, seq, batch)).batch_at(0)
        from repro_torch.distributed import collectives as C
        before = dict(C.TRAFFIC_BY_KIND), C.TRAFFIC["received"]
        new_p, new_opt, m = fn(params, opt, torch.from_numpy(
            tok["tokens"]).to(mesh.device))
        traffic = {k: C.TRAFFIC_BY_KIND[k] - before[0][k]
                   for k in C.COLLECTIVE_KINDS}
        traffic["received"] = C.TRAFFIC["received"] - before[1]
        local = [tuple(x.shape) for x in leaves(new_p)]
        held = sum(x.numel() * 4 for x in leaves((new_p, new_opt.mu,
                                                 new_opt.nu)))
        gathered = leaves(planner.gather(new_p, specs, mesh)) + leaves(
            planner.gather(new_opt.mu, specs, mesh))
        if rank == 0:
            np.savez(os.path.join(out_dir, "mesh.npz"),
                     *[x.cpu().numpy() for x in gathered])
        status.update(ok=True, loss=float(m["loss"]),
                      gnorm=float(m["gnorm"]), shapes_ok=local == want,
                      held_bytes=held, whole_bytes=3 * whole_bytes,
                      traffic=traffic)
    except Exception:
        status["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(status, fh)
    if dist.is_initialized():
        dist.destroy_process_group()
    if not status["ok"]:
        sys.exit(1)


def spawn_group(target, world: int, out_dir: Path, args, label: str,
                timeout: float):
    """Spawn ``world`` ranks of ``target(rank, world, store, out_dir,
    *args)`` (start method spawn: the card is already initialised here) on
    a FileStore in ``out_dir`` and wait for them within ``timeout``.
    Raises, naming the ranks, if any rank fails, hangs or returns nothing;
    returns their statuses (``rank<r>.json``)."""
    import torch.multiprocessing as mp
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.iterdir():
        old.unlink()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(
        r, world, str(out_dir / "store"), str(out_dir)) + tuple(args))
        for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if (any(p.exitcode not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.1)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
    statuses, bad = [], []
    for r, p in enumerate(procs):
        path = out_dir / f"rank{r}.json"
        st = (json.loads(path.read_text()) if path.exists() else
              {"rank": r, "ok": False,
               "error": f"no result (exit code {p.exitcode})"})
        statuses.append(st)
        if not st["ok"] or p.exitcode != 0:
            bad.append(st)
    if bad or hung:
        raise AssertionError(
            f"{label}: the {world}-rank group failed; ranks still running "
            f"at the end: {hung}; "
            + "; ".join(f"rank {st['rank']}: {st.get('error', '')[-2000:]}"
                        for st in bad))
    return statuses


def train_mesh(arch: str, device, shape=MESH_TRAIN["shape"],
               seq: int = MESH_TRAIN["seq"], batch: int = MESH_TRAIN["batch"],
               accum: int = MESH_TRAIN["accum"], lr: float = MESH_TRAIN["lr"],
               root: Path = TRAIN_DIR):
    """(4) One train step of the reduced ``arch`` (f32 activations) on a
    (data, model) mesh of ``shape`` in that many gloo ranks on ``device``
    (:func:`train_mesh_rank`), against the same step in this process on
    one piece: the loss, the gnorm and each gathered first moment (the
    reduced gradient, relative Frobenius) within TRAIN_TOL relative, the
    gathered new parameters within TRAIN_TOL absolute, every rank's local
    shapes its spec's blocks."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import LM
    from repro_torch.optim import adamw_init
    from repro_torch.tree import leaves
    world = int(np.prod(shape))
    out = root / f"mesh{world}"
    t0 = time.perf_counter()
    statuses = spawn_group(train_mesh_rank, world, out,
                           (arch, tuple(shape), str(device), seq, batch,
                            accum, lr), "train mesh", SPMD_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    mesh = make_smoke_mesh(device)
    gen = torch.Generator(device).manual_seed(SEED)
    params = LM(cfg).init_params(gen, device)
    fn, _ = S.make_train_step(S.build_lm(cfg, mesh),
                              _train_shape(seq, batch, accum), mesh,
                              peak_lr=lr)
    tok = TokenSource(DataConfig(cfg.vocab_size, seq, batch)).batch_at(0)
    new_p, new_opt, m = fn(params, adamw_init(params),
                           torch.from_numpy(tok["tokens"]).to(device))
    got = np.load(out / "mesh.npz")
    n = len(leaves(new_p))
    param_err = max(float(np.abs(got[f"arr_{i}"] - x.cpu().numpy()).max())
                    for i, x in enumerate(leaves(new_p)))
    mu_err = max(_rel(torch.from_numpy(got[f"arr_{n + i}"]),
                                x.cpu())
                 for i, x in enumerate(leaves(new_opt.mu)))
    loss, gnorm = float(m["loss"]), float(m["gnorm"])
    loss_err = max(abs(s["loss"] - loss) / abs(loss) for s in statuses)
    gnorm_err = max(abs(s["gnorm"] - gnorm) / abs(gnorm) for s in statuses)
    if not all(s["shapes_ok"] for s in statuses):
        raise AssertionError("train mesh: a rank's local shapes are not its "
                             "spec's blocks")
    if max(loss_err, gnorm_err, mu_err, param_err) > TRAIN_TOL:
        raise AssertionError(f"train mesh: loss {loss_err:.3g}, gnorm "
                             f"{gnorm_err:.3g}, moments {mu_err:.3g}, "
                             f"params {param_err:.3g} from the one-process "
                             f"step")
    for d in out.iterdir():
        d.unlink()
    out.rmdir()
    return {"world": world, "loss": loss, "loss_rel": loss_err,
            "gnorm_rel": gnorm_err, "mu_rel": mu_err, "param_abs": param_err,
            "held_fraction": max(s["held_bytes"] / s["whole_bytes"]
                                 for s in statuses), "ranks_s": ranks_s}


def _train_summary(tag: str, arch: str, cfg, train: dict, rec: dict):
    phase(tag, arch=arch, layers=cfg.n_layers, d_model=cfg.d_model,
          vocab=cfg.vocab_size, remat=cfg.remat, params=rec["params"],
          seq=train["seq"], batch=train["batch"], accum=train["accum"],
          steps=train["steps"], first_loss=f"{rec['losses'][0]:.6f}",
          last_loss=f"{rec['losses'][-1]:.6f}",
          first_step_s=f"{rec['first_step_s']:.3f}",
          step_s_median=f"{rec['step_s_median']:.3f}",
          tokens_per_s=f"{rec['tokens_per_s']:.1f}",
          max_mem_gb=f"{rec['max_mem'] / 2**30:.2f}",
          state_gb=f"{rec['state_bytes'] / 2**30:.2f}",
          init_s=f"{rec['init_s']:.2f}",
          dense_attention_calls=rec["attention_calls"],
          kernels_launched=",".join(f"{k}:{n}" for k, n in sorted(
              rec["launches"].items())) or 0,
          **({} if rec["first_batch_again"] is None else {
              "first_batch_loss_after": f"{rec['first_batch_again']:.6f}"}))


def _twin_line(tag: str, arch: str, twin: dict, tw: dict):
    scan = {} if "kink_flips" not in tw else {
        "kernel_vs_plain_rel": f"{tw['kernel_vs_plain_rel']:.3g}",
        "scan_card_vs_cpu_rel": f"{tw['scan_card_vs_cpu_rel']:.3g}",
        "kink_flips": tw["kink_flips"]}
    phase(tag, arch=arch, layers=twin["layers"], batch=twin["batch"],
          seq=twin["seq"], loss=f"{tw['loss']:.6f}",
          loss_rel=f"{tw['loss_rel']:.3g}", grad_rel=f"{tw['grad_rel']:.3g}",
          adamw_abs=f"{tw['adamw_abs']:.3g}", card_s=f"{tw['card_s']:.3f}",
          cpu_s=f"{tw['cpu_s']:.3f}", **scan)


def train_path(device, train=TRAIN, twin=TWIN, restart=RESTART,
               mesh=MESH_TRAIN, reduce=None, root: Path = TRAIN_DIR):
    """Path 4k: (1) the Trainer on internlm2-1.8b at full width and depth;
    (2) the f32 twin at full width and ``twin["layers"]`` layers, card
    against CPU; (3) a restart of the reduced config from its checkpoint;
    (4) one step of the reduced config on a (2, 2) mesh of gloo ranks
    against the one-process step; (5) xlstm-125m at full width and depth
    through the Trainer at (1)'s shape and XLSTM_TRAIN's steps and
    schedule (the sLSTM kernels, forward, remat replay and backward), and
    its f32 twin as (2). ``reduce`` (a config -> config
    map) shrinks (1), (2) and (5) for a rehearsal on the CPU; (3) and (4)
    write under ``root``. Prints the path's lines; returns its records."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    t_path = time.perf_counter()
    start = dict(_build.LAUNCHES)
    cfg = get_arch(TRAIN_ARCH)
    full = reduce(cfg) if reduce else cfg
    rec = train_full(full, device, **train)
    _train_summary("train-summary", TRAIN_ARCH, full, train, rec)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tw_cfg = dataclasses.replace(cfg, n_layers=twin["layers"])
    tw = train_twin(reduce(tw_cfg) if reduce else tw_cfg, device,
                    twin["seq"], twin["batch"])
    _twin_line("train-twin", TRAIN_ARCH, twin, tw)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rs = train_restart(cfg.reduced(), device, root=root, **restart)
    phase("train-restart", resumed_at=rs["resumed_at"],
          losses=",".join(f"{x:.6f}" for x in rs["losses"]),
          loss_rel=f"{rs['loss_rel']:.3g}", same_next_batch=True)
    ms = train_mesh(TRAIN_ARCH, device, root=root, **mesh)
    phase("train-mesh", ranks=ms["world"], mesh="x".join(
        map(str, mesh["shape"])), loss=f"{ms['loss']:.6f}",
          loss_rel=f"{ms['loss_rel']:.3g}", gnorm_rel=f"{ms['gnorm_rel']:.3g}",
          moments_rel=f"{ms['mu_rel']:.3g}",
          param_abs=f"{ms['param_abs']:.3g}",
          held_fraction=f"{ms['held_fraction']:.3f}",
          ranks_s=f"{ms['ranks_s']:.1f}")
    # (5) xlstm-125m: the sLSTM kernels under the Trainer; (1)-(4) launch
    # no kernel
    before = dict(_build.LAUNCHES)
    if before != start:
        raise AssertionError(f"kernels launched on the training path "
                             f"(1)-(4): {_launched_since(start)}")
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    xcfg = get_arch(XLSTM_ARCH)
    xfull = reduce(xcfg) if reduce else xcfg
    xtrain = dict(train, steps=XLSTM_TRAIN["steps"],
                  total_steps=XLSTM_TRAIN["total_steps"])
    xrec = train_full(xfull, device, tag="train-xlstm", same_batch=True,
                      **xtrain)
    _train_summary("train-xlstm-summary", XLSTM_ARCH, xfull, xtrain, xrec)
    gc.collect()
    xtw_cfg = dataclasses.replace(xcfg, n_layers=twin["layers"])
    xtw = train_twin(reduce(xtw_cfg) if reduce else xtw_cfg, device,
                     twin["seq"], twin["batch"])
    _twin_line("train-xlstm-twin", XLSTM_ARCH, twin, xtw)
    phase("train-path", seconds=f"{time.perf_counter() - t_path:.1f}")
    return {"full": rec, "twin": tw, "restart": rs, "mesh": ms,
            "xlstm": xrec, "xlstm_twin": xtw, "xlstm_train": xtrain,
            "launches": _launched_since(before)}


# ---------------------------------------------------------------------------
# Path 4l: the dry-run beside the card's own steps, and the six examples
# ---------------------------------------------------------------------------

BF16_PEAK_FLOPS = 989e12        # H100 SXM, dense bf16, tensor cores
DRYRUN_CLI_ARCH = "xlstm-125m"  # (b): its four shapes on pod256
DRYRUN_CLI_TIMEOUT_S = 300
EXAMPLES = ("quickstart", "spmv_distributed", "moe_sparse_dispatch",
            "long_context_block_sparse", "serve_batched", "train_e2e")
#: examples that must launch a Hopper kernel on the card
EXAMPLE_KERNELS = ("quickstart", "spmv_distributed", "serve_batched")
#: train_e2e's default is 300 steps; 100 keep its loss check
EXAMPLE_ARGS = {"train_e2e": ["--steps", "100"]}


def _peak_fields(prefix: str, rec: dict, measured: int) -> dict:
    """The predicted peak beside the measured one (GiB, their gap)."""
    m = rec["memory"]
    pred = (m["argument_bytes_per_dev"] + m["output_bytes_per_dev"]
            + m["temp_bytes_per_dev"] - m["alias_bytes_per_dev"])
    gap = f"{(pred - measured) / measured:+.3f}" if measured else "n/a"
    return {f"{prefix}predicted_peak_gib": f"{pred / 2**30:.3f}",
            f"{prefix}measured_peak_gib": f"{measured / 2**30:.3f}",
            f"{prefix}peak_gap": gap}


def _share(roofline: dict, step_s: float) -> float:
    """The model-FLOPs share: model FLOPs over the step time over the bf16
    peak."""
    return roofline["model_flops_per_dev"] / step_s / BF16_PEAK_FLOPS


def dryrun_train_cell(arch: str, cfg, train: dict, train_rec: dict,
                      tag: str = "dryrun-train", started=None) -> dict:
    """The dry-run's prediction of one of path 4k's train steps
    (``dryrun.run_card_cell`` on ``meta``, mesh (1, 1); with ``started``,
    the record of the process :func:`dryrun_card_start` began) beside what
    the card showed: the peak above the path's base, and the FLOPs
    ``FlopCounterMode`` counted over its last step, which must equal the
    prediction. One ``[<tag>]`` line; returns the record."""
    from repro_torch.launch import dryrun
    shape = dryrun.card_shape("train", train["seq"], train["batch"],
                              train["accum"])
    rec = (dryrun_card_finish(started) if started
           else dryrun.run_card_cell(arch, shape, cfg=cfg))
    if rec["status"] != "ok":
        raise AssertionError(f"dry-run {arch} {shape.name}: "
                             f"{rec['error']}\n{rec['traceback']}")
    rl = rec["roofline"]
    if rl["flops_per_dev"] != train_rec["step_flops"]:
        raise AssertionError(
            f"dry-run FLOPs {rl['flops_per_dev']} of the {arch} train step "
            f"differ from FlopCounterMode's {train_rec['step_flops']} on "
            f"the card")
    step_s = train_rec["step_s_median"]
    phase(tag, arch=arch, cell=shape.name, mesh="1x1",
          **_peak_fields("", rec, train_rec["max_mem"]
                         - train_rec["base_mem"]),
          predicted_flops=f"{rl['flops_per_dev']:.6e}",
          counted_flops=f"{train_rec['step_flops']:.6e}", flops_equal=True,
          model_flops=f"{rl['model_flops_per_dev']:.6e}",
          step_s=f"{step_s:.3f}",
          achieved_tflops=f"{rl['flops_per_dev'] / step_s / 1e12:.2f}",
          model_flops_share=f"{_share(rl, step_s):.4f}",
          bound_s=f"{rl['roofline_bound_s']:.3f}",
          dominant=rl["dominant"], count_s=rec["count_s"])
    return rec


def dryrun_cells(train_cfg, train: dict, train_rec: dict, prefill_cfg,
                 batch: int, seq: int, attn_rec: dict, xlstm=None,
                 cards=None) -> dict:
    """(a) The dry-run's predictions of path 4k's train step
    (:func:`dryrun_train_cell`), of its xlstm-125m step when ``xlstm`` =
    (config, train shape, record) is given, and of path 4e's flash prefill
    (``dryrun.run_card_cell`` on ``meta``, mesh (1, 1)), beside what the
    card showed in this run. Prints the achieved TFLOP/s and the
    model-FLOPs share (model FLOPs over the step time over 989 TFLOP/s)
    of each. ``cards`` {arch: :func:`dryrun_card_start`'s handle} gives the
    train cells counted in processes of their own."""
    from repro_torch.launch import dryrun
    cards = cards or {}
    out = {"train": dryrun_train_cell(TRAIN_ARCH, train_cfg, train,
                                      train_rec,
                                      started=cards.get(TRAIN_ARCH))}
    if xlstm is not None:
        out["xlstm"] = dryrun_train_cell(XLSTM_ARCH, *xlstm,
                                         started=cards.get(XLSTM_ARCH))
    shape = dryrun.card_shape("prefill", seq, batch)
    rec = dryrun.run_card_cell(ARCH, shape, variant="flash", cfg=prefill_cfg)
    if rec["status"] != "ok":
        raise AssertionError(f"dry-run {ARCH} {shape.name}: "
                             f"{rec['error']}\n{rec['traceback']}")
    rl = rec["roofline"]
    step_s = attn_rec["run_ms"] / 1e3
    phase("dryrun-prefill", arch=ARCH, cell=shape.name + "_flash",
          mesh="1x1", layers=prefill_cfg.n_layers,
          **_peak_fields("", rec, attn_rec["max_mem"] - attn_rec["base_mem"]),
          predicted_flops=f"{rl['flops_per_dev']:.6e}",
          model_flops=f"{rl['model_flops_per_dev']:.6e}",
          step_s=f"{step_s:.4f}",
          achieved_tflops=f"{rl['flops_per_dev'] / step_s / 1e12:.2f}",
          model_flops_share=f"{_share(rl, step_s):.4f}",
          bound_s=f"{rl['roofline_bound_s']:.4f}",
          dominant=rl["dominant"], count_s=rec["count_s"])
    out["prefill"] = rec
    return out


def _dryrun_start(argv):
    """``python -m repro_torch.launch.dryrun <argv>`` in a process of its
    own on this host; returns (process, start time)."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return proc, time.perf_counter()


def dryrun_cli_start(arch: str = DRYRUN_CLI_ARCH):
    """(b) Start ``python -m repro_torch.launch.dryrun --arch <arch>
    --shape all`` (pod256) in a process of its own on this host, to run
    beside the card's paths (it starts before path 4j);
    :func:`dryrun_cli_finish` waits for it in path 4l."""
    proc, t0 = _dryrun_start(["--arch", arch, "--shape", "all"])
    return proc, arch, t0


def dryrun_card_start(arch: str, train: dict):
    """(a)'s count of a train step of path 4k (``--mesh card`` at
    ``train``'s shape) in a process of its own, started with (b);
    :func:`dryrun_card_finish` reads its record in path 4l."""
    proc, t0 = _dryrun_start([
        "--arch", arch, "--mesh", "card", "--kind", "train", "--seq-len",
        str(train["seq"]), "--global-batch", str(train["batch"]),
        "--grad-accum", str(train["accum"])])
    return proc, arch, t0, train


def dryrun_card_finish(started, timeout: float = DRYRUN_CLI_TIMEOUT_S
                       ) -> dict:
    """Wait for a :func:`dryrun_card_start` process (killed past
    ``timeout`` seconds from its start) and return its record."""
    from repro_torch.launch import dryrun
    proc, arch, t0, train = started
    try:
        out, err = proc.communicate(
            timeout=max(timeout - (time.perf_counter() - t0), 1))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"dry-run card cell: {arch} not done in "
                             f"{timeout} s")
    name = dryrun.card_shape("train", train["seq"], train["batch"],
                             train["accum"]).name
    path = dryrun.OUT_DIR / f"{arch}_{name}_card.json"
    if proc.returncode or not path.exists():
        raise AssertionError(f"dry-run card cell {arch}: exit "
                             f"{proc.returncode}\n{out}\n{err[-4000:]}")
    return json.loads(path.read_text())


def stop_processes(*started) -> None:
    """Kill those of the background dry-run processes still running."""
    for st in started:
        if st and st[0].poll() is None:
            st[0].kill()
            st[0].communicate()


def dryrun_cli_finish(started, timeout: float = DRYRUN_CLI_TIMEOUT_S
                      ) -> dict:
    """Wait for (b) (killed past ``timeout`` seconds from its start): every
    cell must be ``ok``. One ``[dryrun-cli]`` line with its wall seconds
    and each cell's; returns its lines and wall seconds."""
    proc, arch, t0 = started
    try:
        out, err = proc.communicate(
            timeout=max(timeout - (time.perf_counter() - t0), 1))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"dry-run CLI: {arch} not done in {timeout} s")
    wall = time.perf_counter() - t0
    lines = [x for x in out.splitlines() if x.startswith("[")]
    if proc.returncode or len(lines) != 4 or not all(
            x.startswith("[ok]") for x in lines):
        raise AssertionError(f"dry-run CLI: exit {proc.returncode}\n{out}"
                             f"\n{err[-4000:]}")
    phase("dryrun-cli", arch=arch, mesh="pod256", cells=len(lines),
          wall_s=f"{wall:.1f}",
          cells_s=",".join(x.split("wall=")[1].split("s ")[0]
                           for x in lines),
          peak_gib=",".join(x.split("mem/dev=")[1].rstrip("GiB")
                            for x in lines))
    return {"lines": lines, "wall_s": wall}


def run_examples(device, names=EXAMPLES, extra=EXAMPLE_ARGS) -> dict:
    """(c) The six examples in this process on ``device``, each with its
    own asserts, the launch counts read around each; on the card
    ``EXAMPLE_KERNELS`` must each launch a Hopper kernel. One ``[example]``
    line each."""
    import importlib
    from repro_torch.kernels import _build
    out = {}
    for name in names:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        _build.reset_launches()
        t0 = time.perf_counter()
        figures = mod.main(["--device", str(device)] + extra.get(name, []))
        seconds = time.perf_counter() - t0
        launched = {k: n for k, n in _build.LAUNCHES.items() if n}
        if device.type == "cuda" and name in EXAMPLE_KERNELS and not launched:
            raise AssertionError(f"example {name} launched no Hopper kernel")
        phase("example", name=name, seconds=f"{seconds:.2f}",
              args=" ".join(extra.get(name, [])) or "-",
              launches=",".join(f"{k}:{n}" for k, n in sorted(
                  launched.items())) or "none")
        out[name] = {"figures": figures, "launches": launched,
                     "seconds": seconds}
    return out


def dryrun_path(device, train_cfg, train: dict, train_rec: dict,
                prefill_cfg, batch: int, seq: int, attn_rec: dict,
                cli=None, names=EXAMPLES, extra=EXAMPLE_ARGS,
                xlstm=None, cards=None) -> dict:
    """Path 4l: (a) :func:`dryrun_cells` (with ``xlstm``, path 4k's
    xlstm-125m step too), (c) :func:`run_examples`, then
    (b), the dry-run CLI, which the caller started beforehand
    (:func:`dryrun_cli_start`, ``cli``; None: no (b)) to run on the host
    beside path 4k's work on the card; ``[dryrun-path]`` gives the
    path's seconds."""
    t0 = time.perf_counter()
    try:
        cells = dryrun_cells(train_cfg, train, train_rec, prefill_cfg,
                             batch, seq, attn_rec, xlstm, cards)
        ex = run_examples(device, names, extra)
    except BaseException:
        stop_processes(cli, *(cards or {}).values())
        raise
    cli = dryrun_cli_finish(cli) if cli else None
    phase("dryrun-path", seconds=f"{time.perf_counter() - t0:.1f}")
    return {"cells": cells, "cli": cli, "examples": ex}


def path_data(args) -> dict:
    """The sparse paths' operands, all on the host (``[data]``,
    ``[data-add]``, ``[data-grid]``); ``main`` makes them in a thread
    beside the build and phase 3."""
    import numpy as np
    t0 = time.perf_counter()
    dims3 = (1 << args.log2_i, 1 << args.log2_jk, 1 << args.log2_jk)
    data = make_inputs(1 << args.log2_n, AVG_NNZ, SPMM_J, SEED, dims3)
    B, B3 = data["B"], data["B3"]
    phase("data", n=B.shape[0], nnz=B.nnz,
          longest_row=int(np.diff(B.levels[1].pos).max()),
          tensor=("x".join(map(str, B3.shape))), tensor_nnz=B3.nnz,
          fibres=B3.levels[1].crd.shape[0],
          longest_slice=int(np.diff(B3.levels[2].pos[B3.levels[1].pos])
                            .max()),
          seconds=f"{time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    data["add"] = add_operands(B.shape[0], SEED, B)
    data["dense"] = add_operands(1 << args.log2_dense, SEED)
    phase("data-add", stream=sum(t.nnz for t in data["add"]["scalar"]),
          blocks=sum(t.vals.shape[0] for t in data["add"]["blocked"]),
          dense_side=1 << args.log2_dense,
          dense_stream=sum(t.nnz for t in data["dense"]["scalar"]),
          dense_blocks=sum(t.vals.shape[0] for t in data["dense"]["blocked"]),
          longest_block_row=int(np.diff(
              data["add"]["blocked"][0].levels[1].pos).max()),
          seconds=f"{time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    data["grid"] = grid_operands(data, GENERIC_SIDE, SEED)
    phase("data-grid", bdcsr_blocks=data["grid"]["bdcsr"].vals.shape[0],
          generic_side=GENERIC_SIDE,
          seconds=f"{time.perf_counter() - t0:.1f}")
    return data


def sparse_paths(args, device, data):
    """Phases 4a-d and 5 for the four sparse paths over ``data``
    (:func:`path_data`): drive each with the launch counts of exactly its
    run, check the cells, then time the kernels at the main path's shapes.
    Returns the kernel records and the SpTTV rows record; the paths' data
    goes with the call."""
    import torch
    from repro_torch.kernels import _build

    # 4. the main path: each path with the launch counts of exactly its run
    cells, grid_cells = {}, {}
    launches = dict.fromkeys(_build.LAUNCHES, 0)
    for path, path_cells in PATH_CELLS.items():
        _build.reset_launches()
        t0 = time.perf_counter()
        # the grid cells' run() is timed over fewer calls: the nested
        # SpAdd3 union is assembled on the host and takes seconds
        recs, path_launches = run_slice(
            data, path_cells, PIECES, device,
            max(args.reps // (10 if path == "grid" else 4), 1))
        path_s = time.perf_counter() - t0
        for cell, rec in recs.items():
            k = rec["kernel"]
            out = rec["out"]
            grid = {} if k is None else {
                "fallbacks": json.dumps(k.fallbacks).replace(" ", ""),
                "axes": json.dumps({n: a.network_bytes() for n, a in
                                    k.comm.axes.items()}).replace(" ", "")}
            phase("main", cell=k.cell_id() if k else cell,
                  leaf=k.leaf_name if k else rec["call"][0],
                  stored=("-" if not hasattr(out, "vals")
                          else out.vals.shape[0]),
                  cold_lower_s=f"{rec['cold_s']:.3f}",
                  warm_lower_s=f"{rec['warm_s']:.4f}",
                  run_ms=f"{rec['run_ms']:.3f}", runs=rec["runs"],
                  launches_per_run=rec["per_run"],
                  launches=json.dumps(rec["launches"]).replace(" ", ""),
                  max_abs_err=f"{rec['max_abs_err']:.3g}",
                  bitwise_repeat=rec["bitwise"],
                  max_mem_gb=f"{rec['max_mem'] / 2**30:.2f}",
                  **(grid if path == "grid" else {}))
        missing = [k for k in PATH_KERNELS[path] if path_launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the {path} "
                                 f"path: {missing}")
        phase("launches", path=path, seconds=f"{path_s:.1f}",
              **path_launches)
        clocks(f"after the {path} path")
        if path == "grid":
            grid_cells = recs
            continue
        for k, v in path_launches.items():
            launches[k] += v
        cells.update(recs)

    # path 4g's operands and host products, written once for its ranks
    t0 = time.perf_counter()
    save_spmd_operands(data)
    phase("spmd-data", dir=SPMD_DIR.relative_to(ROOT),
          seconds=f"{time.perf_counter() - t0:.1f}")

    # 3b + 5. kernels at the main path's shapes, timed once every count
    # is read
    t0 = time.perf_counter()
    records, ttv, cell_ms = kernel_records(
        data, {c: r for c, r in cells.items()
               if not c.startswith("spadd3") and "_bcsr/" not in c},
        launches, args.reps)
    add_records, add_ms = add_kernel_records(data, cells, launches,
                                             args.reps)
    blocked_records, blocked_ms = blocked_kernel_records(
        data, {c: r for c, r in cells.items() if "_bcsr/" in c
               and not c.startswith("spadd3")}, launches, args.reps)
    records += add_records + blocked_records
    phase("sparse-kernels", seconds=f"{time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    records += grid_kernel_records(data, grid_cells, max(args.reps // 4, 3))
    phase("grid-kernels", seconds=f"{time.perf_counter() - t0:.1f}")
    clocks("after the sparse kernels' timing")
    cell_ms.update(add_ms)
    cell_ms.update(blocked_ms)
    for cell, rec in cells.items():
        phase("cell-kernel", cell=(rec["kernel"].cell_id()
                                   if rec["kernel"] else cell),
              kernel_ms=(f"{cell_ms[cell]:.4f}" if cell in cell_ms
                         else "-"))

    # 4h. the runtime and serving, over these operands, the byte ledger
    # over every kernel the paths lowered
    clocks("before the runtime path")
    runtime, serving = runtime_path(
        data, [rec["kernel"] for rec in (*cells.values(),
                                         *grid_cells.values())
               if rec["kernel"] is not None], device)
    clocks("after the runtime path")
    # 4i. the autoscheduler over the same operands
    autosched = autosched_path(data, device, args.reps)
    clocks("after the autoscheduler path")
    for r in records:
        r["runtime_launches"] = runtime.get(r["name"], 0)
        r["serving_launches"] = serving.get(r["name"], 0)
        r["autosched_launches"] = autosched.get(r["name"], 0)
    return records, ttv


# ---------------------------------------------------------------------------
# Path 4h: the runtime (recovery, the byte ledger, the trace) and sparse
# serving (SparseKernelServer, the band-decode and MoE-combine statements)
# ---------------------------------------------------------------------------

# (statement, strategy) of the recovery cells, on Machine(("x", 4))
RUNTIME_CELLS = (("spmv", "rows"), ("spmm", "nnz"), ("spmv_bcsr", "rows"))
RUNTIME_KERNELS = {"spmv": "spmv_csr_rows", "spmm": "spmm_coo_nnz",
                   "spmv_bcsr": "bcsr_spmv"}
SERVING_KERNELS = {"rows": "spmm_csr_rows", "nnz": "spmm_coo_nnz"}
RECOVERY_STEPS = 8
# device loss of piece 1 at step 3, B corrupted at step 5; on the nnz cell
# stragglers on piece 2 at steps 1 and 2, sleeping 0.25 s and 1 s: the
# watchdog flags a step above 4x the median step time, and once the first
# slow step is in the median the second must exceed twice the first
LOSS_STEP, CORRUPT_STEP = 3, 5
STRAGGLERS = ((1, 0.25), (2, 1.0))
SERVE_BURSTS = (1, 3, 8, 5, 8, 2, 8, 8, 7, 6, 8)    # 64 requests
SERVE_MAX_BATCH = 8
SERVE_HOST_CHECKED = 8     # requests also held against float64 on the host
BAND = (131072, 128, 8192)     # seq_len, q_block, window
MOE = (64, 8, 2 * 4096)        # olmoe-1b-7b's router: experts, top-k, tokens
RUNTIME_DIR = ROOT / "build" / "recovery"
TRACE_PATH = ROOT / "build" / "TRACE_smoke.json"


def int_operands(data, seed: int):
    """Path 4h's operands: the matrix path's B (CSR) and the blocked path's
    BCSR((4, 4)) B on their own patterns, with every value redrawn as an
    integer in [-3, 3], and integer dense operands c (n,) and C (n, J), all
    from ``seed``. Sums of such values are exact in f32, so a P = 4 -> 3
    shrink or an SpMV -> SpMM promotion, which reorder them, keep the
    bits."""
    import numpy as np
    import repro_torch.core as tc
    rng = np.random.default_rng(seed + 7)

    def ints(shape):
        return rng.integers(-3, 4, shape).astype(np.float32)

    B, Bb = data["B"], data["add"]["blocked"][0]
    return {"B": tc.Tensor("B", B.shape, B.format, B.levels,
                           ints(B.vals.shape)),
            "Bb": tc.Tensor("B", Bb.shape, Bb.format, Bb.levels,
                            ints(Bb.vals.shape)),
            "c": ints(B.shape[1]), "C": ints((B.shape[1], SPMM_J))}


def runtime_statement(ops, expr: str):
    import repro_torch.core as tc
    B = ops["Bb"] if expr == "spmv_bcsr" else ops["B"]
    n = B.shape[0]
    if expr == "spmm":
        return tc.parse_tin(
            "A(i,j) = B(i,k) * C(k,j)",
            A=tc.Tensor.zeros_dense("A", (n, SPMM_J)), B=B,
            C=tc.Tensor.from_dense("C", ops["C"]))
    return tc.parse_tin("a(i) = B(i,j) * c(j)",
                        a=tc.Tensor.zeros_dense("a", (n,)), B=B,
                        c=tc.Tensor.from_dense("c", ops["c"]))


def csr_products(T, X):
    """float64 host T @ X (n, J) and its scale for a CSR T: PyTorch's CPU
    CSR product in float64 over T's arrays, on the values and on their
    absolute values (independent of the port's kernels; multithreaded,
    where numpy's per-row sums of 32 columns take tens of seconds at the
    main path's size)."""
    import warnings
    import numpy as np
    import torch
    pos, crd = (torch.from_numpy(a.astype(np.int64))
                for a in (T.levels[1].pos, T.levels[1].crd))
    v = torch.from_numpy(T.vals.astype(np.float64))
    x = torch.from_numpy(np.asarray(X, np.float64))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # "sparse CSR is in beta"
        y, s = (torch.sparse_csr_tensor(pos, crd, w, T.shape,
                                        check_invariants=False) @ z
                for w, z in ((v, x), (v.abs(), x.abs())))
    return y.numpy(), s.numpy()


def int_products(ops, expr: str):
    """float64 host result and scale of a recovery cell's statement."""
    if expr == "spmv_bcsr":
        y, s = blocked_products(ops["Bb"], ops["c"][:, None])
    elif expr == "spmm":
        return csr_products(ops["B"], ops["C"])
    else:
        y, s = csr_products(ops["B"], ops["c"][:, None])
    return y[:, 0], s[:, 0]


def _dir_mb(path: Path) -> float:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file()) / 1e6


def recovery_cell(ops, expr: str, strat: str, device, ckpt_root: Path,
                  stragglers=STRAGGLERS):
    """One recovery cell: the elastic re-plan timed (a cold lower at P = 4,
    a cold re-lower at P = 3 with nothing cached, and ``relower(dead=1)``
    after an elastic lower), then ``run_with_recovery`` for
    ``RECOVERY_STEPS`` steps unfaulted and faulted (device loss, corruption,
    and on the nnz cell stragglers), each from cold caches. The faulted
    state must have the unfaulted one's bits and agree with the host; every
    step launches the cell's kernel once and nothing else. Prints one
    ``[recovery]`` line; returns the launches of both runs."""
    import shutil
    import torch
    import repro_torch.core as tc
    from repro_torch.core import lower as L
    from repro_torch.kernels import _build
    from repro_torch.runtime.checkpoint import SparseCheckpoint
    from repro_torch.runtime.elastic import run_with_recovery
    from repro_torch.runtime.fault import (FaultEvent, FaultInjector,
                                           StragglerMitigator)
    t_cell = time.perf_counter()
    name = f"{expr}/{strat}"
    stmt = runtime_statement(ops, expr)
    B = stmt.rhs.accesses()[0].tensor
    fp0 = B.fingerprint()
    M4, M3 = tc.Machine(("x", PIECES)), tc.Machine(("x", PIECES - 1))

    def sched(m):
        return None if strat == "rows" else L.default_nnz_schedule(stmt, m)

    base = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    L.clear_lowering_caches()
    t0 = time.perf_counter()
    k4 = L.lower(stmt, M4, schedule=sched(M4), elastic=True, device=device)
    cold4_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    k3 = L.relower(k4, M3, dead=1)
    relower_s = time.perf_counter() - t0
    reuse = k3.cache.shard_reuse
    L.clear_lowering_caches()
    t0 = time.perf_counter()
    L.relower(k4, M3, dead=1)
    cold3_s = time.perf_counter() - t0
    del k4, k3

    kernel = RUNTIME_KERNELS[expr]
    every = 4 if expr == "spmm" else 1
    steps = RECOVERY_STEPS
    runs = {}
    for faulted in (False, True):
        events, mit = [], None
        if faulted:
            events = [FaultEvent(step=LOSS_STEP, kind="device_loss", piece=1),
                      FaultEvent(step=CORRUPT_STEP, kind="corrupt",
                                 tensor="B")]
            if strat == "nnz":
                events += [FaultEvent(step=s, kind="straggler", piece=2,
                                      slowdown_s=sleep)
                           for s, sleep in stragglers]
                mit = StragglerMitigator(PIECES, report_budget=2)
        ckdir = ckpt_root / f"{expr}-{strat}-{'faulted' if faulted else 'ref'}"
        L.clear_lowering_caches()
        before = dict(_build.LAUNCHES)
        state, rep = run_with_recovery(
            stmt, M4, steps, ckpt_dir=str(ckdir), schedule=sched(M4),
            injector=FaultInjector(events) if faulted else None,
            mitigator=mit, checkpoint_every=every, device=device)
        _sync(device)
        launches = _launched_since(before)
        # one run() a step, the first run that sizes the state, and the
        # steps replayed from the restored checkpoint
        n_runs = 1 + steps + (LOSS_STEP - rep.restored_step if faulted
                              else 0)
        want = {kernel: n_runs} if device.type == "cuda" else {}
        if launches != want:
            raise AssertionError(f"recovery {name}: launches {launches}, "
                                 f"want one a step: {want}")
        runs[faulted] = (state, rep, launches)
        shutil.rmtree(ckdir, ignore_errors=True)
    (ref, ref_rep, ref_launches), (state, rep, launches) = runs[False], \
        runs[True]
    if not torch.equal(state, ref):
        raise AssertionError(f"recovery {name}: the faulted state differs "
                             "from the unfaulted run's")
    if (ref_rep.restarts, ref_rep.final_pieces) != (0, PIECES):
        raise AssertionError(f"recovery {name}: the unfaulted run "
                             f"restarted: {ref_rep}")
    if (rep.restarts != 1 or rep.final_pieces != PIECES - 1
            or rep.healed != ["B"]
            or (strat == "rows" and rep.shard_reuse < 0.5)
            or (strat == "nnz" and rep.replans < 1)):
        raise AssertionError(f"recovery {name}: report {rep}")
    split = rep.restore_s + rep.replan_s + rep.rejit_s
    if abs(split - rep.recovery_s) > 1e-9:
        raise AssertionError(f"recovery {name}: splits {split} != "
                             f"{rep.recovery_s}")
    if B.fingerprint() != fp0:
        raise AssertionError(f"recovery {name}: B was not healed")
    total = steps * (steps + 1) // 2        # state = sum_t (t+1) * B @ x
    y, s = int_products(ops, expr)
    err = check_rows(f"recovery {name}", state, total * y, total * s)
    # one checkpoint of the cell, timed on its own
    ck = SparseCheckpoint(str(ckpt_root / f"{expr}-{strat}-timed"), keep=1)
    tensors = {acc.tensor.name: acc.tensor for acc in stmt.accesses()}
    t0 = time.perf_counter()
    ck.save(0, tensors, {"state": state})
    write_s = time.perf_counter() - t0
    ckpt_mb = _dir_mb(ckpt_root / f"{expr}-{strat}-timed")
    shutil.rmtree(ckpt_root / f"{expr}-{strat}-timed", ignore_errors=True)
    # the cell's own peak, above what the earlier paths still hold
    peak = ((torch.cuda.max_memory_allocated(device) - base) / 2**30
            if device.type == "cuda" else 0.0)
    phase("recovery", cell=f"{name}/{PIECES}x1", steps=steps,
          cold_lower_s=f"{cold4_s:.3f}", cold_relower_p3_s=f"{cold3_s:.3f}",
          relower_dead1_s=f"{relower_s:.3f}", shard_reuse=f"{reuse:.3f}",
          faults=",".join(rep.faults), restarts=rep.restarts,
          replans=rep.replans, restored_step=rep.restored_step,
          final_pieces=rep.final_pieces,
          loss_shard_reuse=f"{rep.shard_reuse:.3f}",
          recovery_s=f"{rep.recovery_s:.4f}",
          restore_s=f"{rep.restore_s:.4f}", replan_s=f"{rep.replan_s:.4f}",
          rejit_s=f"{rep.rejit_s:.4f}", ckpt_every=every,
          ckpt_mb=f"{ckpt_mb:.1f}", ckpt_write_s=f"{write_s:.3f}",
          launches=json.dumps(launches).replace(" ", ""),
          bits_equal_unfaulted=True, max_abs_err=f"{err:.3g}",
          peak_gb=f"{peak:.2f}",
          seconds=f"{time.perf_counter() - t_cell:.1f}")
    _add_launches(launches, ref_launches)
    return launches


def serve_requests(n: int, count: int, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed + 13)
    return [rng.integers(-3, 4, n).astype(np.float32) for _ in range(count)]


def serve_schedule(ops, strat: str, reqs, want, device):
    """``SparseKernelServer`` over the integer B with SpMV requests under
    the rows or nnz strategy: ``max_batch`` 8, the default buckets, every
    bucket of the bursts warmed first. The requests arrive in
    ``SERVE_BURSTS`` and each burst is one ``step()``. Checks: no runner
    is built after the warm-up, each batch launches its SpMM kernel once,
    every output is the per-request loop's bit for bit and the first
    ``SERVE_HOST_CHECKED`` agree with the host. Prints one ``[serve]``
    line, with a step's mean host ms and its phases from ``run_many``'s
    spans (fill: stacking the requests on the host; rebind: the copy to
    the card; run: the launch and the output's assembly, whose wait falls
    in the step); returns the launches of the batches and of the
    loop."""
    import numpy as np
    import torch
    import repro_torch.core as tc
    from repro_torch.core import lower as L
    from repro_torch.core.cache import batch_bucket
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import SparseKernelServer
    from repro_torch.runtime import telemetry
    t_cell = time.perf_counter()
    B = ops["B"]
    n, m = B.shape
    stmt = tc.parse_tin("a(i) = B(i,j) * c(j)",
                        a=tc.Tensor.zeros_dense("a", (n,)), B=B,
                        c=tc.Tensor.zeros_dense("c", (m,)))
    L.clear_lowering_caches()
    t0 = time.perf_counter()
    srv = SparseKernelServer(
        stmt, tc.Machine(("x", PIECES)),
        None if strat == "rows" else L.default_nnz_schedule,
        max_batch=SERVE_MAX_BATCH, device=device)
    buckets = sorted({batch_bucket(b) for b in SERVE_BURSTS})
    for b in buckets:
        srv.kernel.warm(b)
    warm_s = time.perf_counter() - t0
    misses = L.RUNNER_CACHE_STATS["misses"]
    kernel = SERVING_KERNELS[strat]
    one = {kernel: 1} if device.type == "cuda" else {}
    before_all = dict(_build.LAUNCHES)
    rids, i, step_ms = [], 0, []
    # the batches' phases, from run_many's spans
    telemetry.TRACER.clear()
    telemetry.TRACER.enable()
    t0 = time.perf_counter()
    try:
        for burst in SERVE_BURSTS:
            for _ in range(burst):
                rids.append(srv.submit(reqs[i]))
                i += 1
            before = dict(_build.LAUNCHES)
            t_step = time.perf_counter()
            srv.step()
            step_ms.append((time.perf_counter() - t_step) * 1e3)
            got = _launched_since(before)
            if got != one:
                raise AssertionError(f"serve {strat}: a batch launched "
                                     f"{got}, want {one}")
        serve_s = time.perf_counter() - t0
    finally:
        telemetry.TRACER.disable()
    span_ms = {}
    for ev in telemetry.TRACER.spans():
        if ev["dur_us"] is not None and ev["name"].startswith("serve.batch."):
            span_ms.setdefault(ev["name"][12:], []).append(ev["dur_us"] / 1e3)
    telemetry.TRACER.clear()
    if L.RUNNER_CACHE_STATS["misses"] != misses:
        raise AssertionError(f"serve {strat}: runners built after the "
                             "warm-up")
    outs = [srv.result(r) for r in rids]
    loop = [srv.kernel.run_many([x])[0] for x in reqs]
    _sync(device)
    launches = _launched_since(before_all)
    if not all(torch.equal(a, b) for a, b in zip(outs, loop)):
        raise AssertionError(f"serve {strat}: run_many differs from the "
                             "per-request loop")
    k = SERVE_HOST_CHECKED
    err = check_rows(f"serve {strat}", torch.stack(outs[:k], 1), *want)
    sizes = np.array(SERVE_BURSTS)
    bucket = np.array([batch_bucket(b) for b in SERVE_BURSTS])
    e = srv.kernel._entries[SERVE_MAX_BATCH]
    kernel_ms = copy_ms = "-"
    if device.type == "cuda":
        name, args = leaf_call(e.kernel)
        fn = kernel_fns()[name][0]
        kernel_ms = f"{time_events(lambda: fn(*args), 10):.4f}"
        buf = np.zeros((m, SERVE_MAX_BATCH), np.float32)
        copy_ms = f"{time_host(lambda: torch.from_numpy(buf).to(device), device, 5):.3f}"
    st = srv.stats()
    phase("serve", schedule=f"spmv/{strat}/{PIECES}x1", leaf=e.kernel.leaf_name,
          requests=len(reqs), batches=len(SERVE_BURSTS),
          buckets=",".join(map(str, buckets)), warm_s=f"{warm_s:.3f}",
          requests_per_s=f"{len(reqs) / serve_s:.1f}",
          p50_ms=f"{st['p50_ms']:.3f}", p99_ms=f"{st['p99_ms']:.3f}",
          occupancy=f"{(sizes / bucket).mean():.3f}",
          padded_slot_waste=f"{((bucket - sizes) / bucket).mean():.3f}",
          h2d_mb_per_batch=f"{(bucket * m * 4).mean() / 1e6:.1f}",
          copy_ms_batch8=copy_ms, kernel_ms_batch8=kernel_ms,
          step_ms=f"{np.mean(step_ms):.3f}",
          **{f"{k}_ms": f"{np.mean(v):.3f}" for k, v in span_ms.items()},
          runner_misses_after_warm=0, bits_equal_loop=True,
          max_abs_err=f"{err:.3g}",
          launches=json.dumps(launches).replace(" ", ""),
          seconds=f"{time.perf_counter() - t_cell:.1f}")
    return launches


def band_and_moe(device):
    """The band-decode statement (``band_decode_kernel`` over
    ``BAND``) and the MoE combine (``combine_kernel`` over a seeded top-k
    dispatch at ``MOE``), each one batch of 8 requests, held against the
    host; each batch launches one SpMM kernel. Returns the launches."""
    import numpy as np
    import torch
    import repro_torch.core as tc
    from repro_torch.kernels import _build
    from repro_torch.models.moe import combine_kernel, dispatch_tensor
    from repro_torch.models.sparse_attention import (band_decode_kernel,
                                                     band_plan)
    rng = np.random.default_rng(SEED + 17)
    machine = tc.Machine(("x", PIECES))
    one = {"spmm_csr_rows": 1} if device.type == "cuda" else {}
    launches = {}

    def batch(label, bk, T, cols):
        before = dict(_build.LAUNCHES)
        ys = bk.run_many(cols)
        _sync(device)
        got = _launched_since(before)
        if got != one:
            raise AssertionError(f"{label}: launched {got}, want {one}")
        for kn, c in got.items():
            launches[kn] = launches.get(kn, 0) + c
        return check_rows(label, torch.stack(ys, 1),
                          *csr_products(T, np.stack(cols, 1)))

    S, qb, window = BAND
    t0 = time.perf_counter()
    bk = band_decode_kernel(S, qb, window, machine, batch=SERVE_MAX_BATCH,
                            device=device)
    lower_s = time.perf_counter() - t0
    mask = band_plan(S, qb, window)
    nq = mask.shape[0]
    err = batch("band", bk, mask,
                [rng.standard_normal(nq).astype(np.float32)
                 for _ in range(SERVE_MAX_BATCH)])
    phase("band", seq_len=S, q_block=qb, window=window, blocks=mask.nnz,
          leaf=next(iter(bk._entries.values())).kernel.leaf_name,
          lower_s=f"{lower_s:.3f}", max_abs_err=f"{err:.3g}")
    E, topk, N = MOE
    logits = rng.standard_normal((N, E))
    tope = np.argsort(-logits, axis=1)[:, :topk]
    top = np.take_along_axis(logits, tope, axis=1)
    topw = (np.exp(top) / np.exp(top).sum(1, keepdims=True)).astype(
        np.float32)
    disp = dispatch_tensor(tope, topw, E)
    t0 = time.perf_counter()
    ck = combine_kernel(disp, machine, batch=SERVE_MAX_BATCH, device=device)
    lower_s = time.perf_counter() - t0
    err = batch("moe", ck, disp,
                [rng.standard_normal(E).astype(np.float32)
                 for _ in range(SERVE_MAX_BATCH)])
    phase("moe", experts=E, top_k=topk, tokens=N, entries=disp.nnz,
          lower_s=f"{lower_s:.3f}", max_abs_err=f"{err:.3g}")
    return launches


def _add_launches(total, more):
    for k, n in more.items():
        total[k] = total.get(k, 0) + n


def runtime_path(data, kernels, device, stragglers=STRAGGLERS,
                 ckpt_root: Path = RUNTIME_DIR, trace_path: Path = TRACE_PATH):
    """Path 4h: (a) the three recovery cells over path 4h's integer
    operands; (b) ``verify_byte_ledger`` on ``kernels`` (the cells paths
    a-d and f lowered; host work only) and ``smoke_trace`` on ``device``,
    its trace validated; (c) ``SparseKernelServer`` under rows and nnz,
    then the band-decode and MoE-combine statements. Returns
    (runtime launches, serving launches): every kernel launch of (a)-(b)
    and of (c)."""
    import numpy as np
    import repro_torch.core as tc
    from repro_torch.core import lower as L
    from repro_torch.kernels import _build
    from repro_torch.runtime import telemetry
    t_path = time.perf_counter()
    t0 = time.perf_counter()
    ops = int_operands(data, SEED)
    phase("runtime-data", nnz=ops["B"].nnz, blocks=ops["Bb"].vals.shape[0],
          seconds=f"{time.perf_counter() - t0:.1f}")
    # (a) recovery
    runtime, serving = {}, {}
    ckpt_root.mkdir(parents=True, exist_ok=True)
    try:
        for expr, strat in RUNTIME_CELLS:
            _add_launches(runtime, recovery_cell(ops, expr, strat, device,
                                                 ckpt_root, stragglers))
    finally:
        import shutil
        shutil.rmtree(ckpt_root, ignore_errors=True)
    # (b) the byte ledger over the earlier paths' kernels, and the trace
    t0 = time.perf_counter()
    reports = [telemetry.verify_byte_ledger(k) for k in kernels]
    phase("ledger", cells=len(reports),
          checks=sum(len(r["checks"]) for r in reports),
          ok=all(r["ok"] for r in reports),
          seconds=f"{time.perf_counter() - t0:.2f}")
    before = dict(_build.LAUNCHES)
    counts = telemetry.smoke_trace(str(trace_path), device=device)
    _sync(device)
    _add_launches(runtime, _launched_since(before))
    phase("trace", path=trace_path, events=sum(counts.values()),
          **{k.replace(".", "_"): v for k, v in sorted(counts.items())})
    # (c) serving
    B = ops["B"]
    reqs = serve_requests(B.shape[1], sum(SERVE_BURSTS), SEED)
    want = csr_products(B, np.stack(reqs[:SERVE_HOST_CHECKED], 1))
    for strat in SERVING_KERNELS:
        _add_launches(serving, serve_schedule(ops, strat, reqs, want, device))
    del reqs
    _add_launches(serving, band_and_moe(device))
    L.clear_lowering_caches()
    if device.type == "cuda":
        missing = [k for k in RUNTIME_KERNELS.values() if not runtime.get(k)]
        missing += [k for k in SERVING_KERNELS.values() if not serving.get(k)]
        if missing:
            raise AssertionError(f"kernels never launched on the runtime "
                                 f"and serving path: {missing}")
    phase("launches", path="runtime", **runtime)
    phase("launches", path="serving", **serving)
    phase("runtime", seconds=f"{time.perf_counter() - t_path:.1f}")
    return runtime, serving


# ---------------------------------------------------------------------------
# Path 4i: the autoscheduler (schedule="auto") over the sparse paths'
# operands
# ---------------------------------------------------------------------------

# the statements the autoscheduler plans, on Machine(("x", 4)) with the
# default SearchConfig (the model's top 3 measured on the card)
AUTOSCHED_CELLS = ("spmv", "spmm", "spmv_bcsr", "spmttkrp")


def _search_spans(events):
    """(search s, {candidate: measure s}) of the ``plan_search`` spans in
    ``events`` (one search is required)."""
    searches = [e for e in events if e["name"] == "plan_search.search"]
    if len(searches) != 1:
        raise AssertionError(f"{len(searches)} plan_search.search spans in "
                             "one cold lower")
    return searches[0]["dur_us"] / 1e6, {
        e["args"]["candidate"]: e["dur_us"] / 1e6 for e in events
        if e["name"] == "plan_search.measure"}


def autosched_cell(stmt, expr: str, data, want, device, reps: int):
    """One cell of path 4i: the operand's structural stats timed alone; a
    cold ``lower(schedule="auto")`` traced (one tuned miss, one search),
    then a warm one (one tuned hit, no search, every cache warm); the
    winner's ``run()`` timed, each call launching exactly its kernel
    ``launches_per_run`` times, its result the bits of a hand lower of
    ``winner.build()`` and within the tolerance of the host product; then
    every enumerated point lowered by hand and its ``run()`` timed. One
    ``[auto]`` line."""
    import repro_torch.core as tc
    from repro_torch.core import lower as L
    from repro_torch.core import plan_search as PS
    from repro_torch.kernels import _build
    from repro_torch.runtime import telemetry
    machine = tc.Machine(("x", PIECES))
    L.clear_lowering_caches()
    t0 = time.perf_counter()
    stats = PS.structural_stats(stmt)
    stats_s = time.perf_counter() - t0
    tracer = telemetry.TRACER
    tracer.clear()
    tracer.enable()
    try:
        t0 = time.perf_counter()
        k = L.lower(stmt, machine, schedule="auto", device=device)
        cold_s = time.perf_counter() - t0
        cold_events = tracer.spans()
        tracer.clear()
        t0 = time.perf_counter()
        warm = L.lower(stmt, machine, schedule="auto", device=device)
        warm_s = time.perf_counter() - t0
        warm_events = tracer.spans()
    finally:
        tracer.disable()
        tracer.clear()
    w = k.tuned
    search_s, measure_s = _search_spans(cold_events)
    if w is None or k.cache.tuned_misses != 1 or k.cache.tuned_hits:
        raise AssertionError(f"{expr}: the cold auto lower is not one tuned "
                             f"miss: {k.cache.as_dict()}")
    if (warm.cache.tuned_hits != 1 or not warm.cache.warm
            or warm.tuned is not w
            or any(e["name"] == "plan_search.search" for e in warm_events)):
        raise AssertionError(f"{expr}: the warm auto lower searched again or "
                             f"missed a cache: {warm.cache.as_dict()}")
    points = {p.label: p for p in PS.enumerate_points(stmt, machine, stats)}
    measured = [c for c in w.candidates if c["measured_s"] is not None]
    if (sorted(points) != sorted(c["label"] for c in w.candidates)
            or len(measured) != min(PS.DEFAULT_CONFIG.refine_top_k,
                                    len(points))
            or sorted(measure_s) != sorted(c["label"] for c in measured)
            or any(p.tile != w.tile for p in points.values())
            or k.strategy.tile != w.tile):
        raise AssertionError(f"{expr}: candidates {w.candidates} are not the "
                             f"enumerated points {sorted(points)} with the "
                             f"top {PS.DEFAULT_CONFIG.refine_top_k} measured "
                             f"and the tile {w.tile} on each")
    # the winner's run(): its kernel alone, launches_per_run a call
    calls = []

    def run():
        calls.append(1)
        return k.run()

    before = dict(_build.LAUNCHES)
    run_ms = time_host(run, device, reps)
    res, again = run(), run()
    _sync(device)
    call, per = leaf_call(k), launches_per_run(k)
    own = ({call[0]: len(calls) * per}
           if call is not None and per and device.type == "cuda" else {})
    if _launched_since(before) != own:
        raise AssertionError(f"{expr}: launches {_launched_since(before)} "
                             f"of the winner's run()s are not {own}")
    sched, m = w.build(stmt, machine)
    hand = L.lower(stmt, m, schedule=sched, device=device)
    if hand.cell_id() != k.cell_id() or not _same_bits(hand.run(), res):
        raise AssertionError(f"{expr}: the winner {k.cell_id()} does not "
                             f"give the bits of a hand lower of {w.label}")
    err = check_cell(f"{expr}/auto", {
        "out": res, "bitwise": _same_bits(res, again), "kernel": k,
        "cold_cache": k.cache}, data, want)
    # every enumerated point as a hand cell
    hand_ms, hand_cold_s = {}, {}
    for label, p in points.items():
        sched, m = p.build(stmt, machine)
        t0 = time.perf_counter()
        kh = L.lower(stmt, m, schedule=sched, device=device)
        hand_cold_s[label] = round(time.perf_counter() - t0, 3)
        hand_ms[label] = round(time_host(kh.run, device, reps), 4)
    best = min(hand_ms, key=hand_ms.get)
    cands = [{"label": c["label"], "est_s": float(f"{c['est_cost_s']:.4g}"),
              "measured_s": (None if c["measured_s"] is None
                             else float(f"{c['measured_s']:.4g}"))}
             for c in w.candidates]
    phase("auto", cell=k.cell_id(), leaf=k.leaf_name,
          kernel=call[0] if call else "-", launches_per_run=per,
          tile="-" if w.tile is None else "x".join(map(str, w.tile)),
          stats_s=f"{stats_s:.3f}", cold_lower_s=f"{cold_s:.3f}",
          search_s=f"{search_s:.3f}", warm_lower_s=f"{warm_s:.4f}",
          measure_s=json.dumps({c: round(v, 3) for c, v in
                                measure_s.items()}).replace(" ", ""),
          candidates=json.dumps(cands).replace(" ", ""),
          model_order=",".join(c["label"] for c in w.candidates),
          measured_order=",".join(c["label"] for c in sorted(
              measured, key=lambda c: c["measured_s"])),
          winner=w.label, run_ms=f"{run_ms:.3f}", runs=len(calls),
          hand_ms=json.dumps(hand_ms).replace(" ", ""),
          hand_lower_s=json.dumps(hand_cold_s).replace(" ", ""),
          best_hand=best, ratio=f"{run_ms / hand_ms[best]:.3f}",
          max_abs_err=f"{err:.3g}", bits_of_hand_lower=True)


def autosched_path(data, device, reps: int):
    """Path 4i: ``lower(schedule="auto")`` over the matrix path's CSR B
    (SpMV, SpMM), path d's BCSR((4, 4)) B (SpMV) and path b's CSF 3-tensor
    (SpMTTKRP), from cold caches, with the launch counts set to 0 just
    before and read just after. Returns the path's launches."""
    import torch
    from repro_torch.core import lower as L
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    base = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    stmts = statements(data)
    want = reference_products(data, AUTOSCHED_CELLS)
    _build.reset_launches()
    for expr in AUTOSCHED_CELLS:
        autosched_cell(stmts[expr], expr, data, want, device,
                       max(reps // 2, 3))
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    L.clear_lowering_caches()
    if device.type == "cuda" and not launches:
        raise AssertionError("no kernel launched on the autoscheduler path")
    peak = (torch.cuda.max_memory_allocated(device) - base
            if device.type == "cuda" else 0)
    phase("launches", path="autosched", **launches)
    phase("autosched", seconds=f"{time.perf_counter() - t0:.1f}",
          max_mem_gb=f"{peak / 2**30:.2f}")
    return launches


# ---------------------------------------------------------------------------
# Path 4g: the distributed executor, ranks sharing the card over gloo
# ---------------------------------------------------------------------------

def _save_tensor(T, name: str, out_dir: Path):
    import numpy as np
    levels = []
    for l, ld in enumerate(T.levels):
        for key in ("pos", "crd"):
            if getattr(ld, key) is not None:
                np.save(out_dir / f"{name}.{l}.{key}.npy", getattr(ld, key))
        levels.append({"size": int(ld.size), "pos": ld.pos is not None,
                       "crd": ld.crd is not None})
    np.save(out_dir / f"{name}.vals.npy", T.vals)
    return {"shape": list(T.shape), "levels": levels}


def save_spmd_operands(data, out_dir: Path = SPMD_DIR) -> None:
    """Write path 4g's operands once, as .npy files the ranks open with
    ``mmap_mode="r"``: the matrix B (CSR), the BCSR((4, 4)) operand, the
    3-tensor (CSF), the dense operands, and the float64 host products of
    the path's expressions (with their scales), which rank 0 checks
    against."""
    import numpy as np
    out_dir.mkdir(parents=True, exist_ok=True)
    meta = {"B": _save_tensor(data["B"], "B", out_dir),
            "Bb": _save_tensor(data["add"]["blocked"][0], "Bb", out_dir),
            "B3": _save_tensor(data["B3"], "B3", out_dir)}
    for key in ("c", "C", "Cs", "Ds", "c3", "C3", "D3"):
        np.save(out_dir / f"{key}.npy", data[key])
    for expr, (want, scale) in reference_products(data, SPMD_EXPRS).items():
        np.save(out_dir / f"want.{expr}.npy", want)
        np.save(out_dir / f"scale.{expr}.npy", scale)
    (out_dir / "meta.json").write_text(json.dumps(meta))


def load_spmd_operands(out_dir: Path = SPMD_DIR):
    """The operands of :func:`save_spmd_operands`, memory-mapped, in the
    ``data`` layout ``statements`` and ``reference_products`` read."""
    import numpy as np
    import repro_torch.core as tc
    from repro_torch.core.tensor import LevelData
    meta = json.loads((out_dir / "meta.json").read_text())

    def mapped(name):
        return np.load(out_dir / f"{name}.npy", mmap_mode="r")

    def tensor(key, fmt):
        m = meta[key]
        levels = [LevelData(fmt.levels[l], lv["size"],
                            pos=mapped(f"{key}.{l}.pos") if lv["pos"]
                            else None,
                            crd=mapped(f"{key}.{l}.crd") if lv["crd"]
                            else None)
                  for l, lv in enumerate(m["levels"])]
        return tc.Tensor("B", m["shape"], fmt, levels, mapped(f"{key}.vals"))

    data = {"B": tensor("B", tc.CSR()), "B3": tensor("B3", tc.CSF()),
            "add": {"blocked": (tensor("Bb", tc.BCSR(ADD_BLOCK)),)}}
    for key in ("c", "C", "Cs", "Ds", "c3", "C3", "D3"):
        data[key] = mapped(key)
    data["host_products"] = {expr: (mapped(f"want.{expr}"),
                                    mapped(f"scale.{expr}"))
                             for expr in SPMD_EXPRS}
    return data


def _spmd_cell(stmts, cell, device):
    """(kernel, call) of an executor cell, lowered on ``device``."""
    from repro_torch.core import lower as L
    expr, strat, label = cell
    overlap = strat.startswith("overlap")
    machine, sched = cell_schedule(stmts[expr], "rows" if overlap else strat,
                                   label, PIECES)
    return L.lower(stmts[expr], machine, schedule=sched, device=device)


def spmd_rank(rank: int, world: int, store: str, out_dir: str, cells,
              reps: int, device: str, spmd_dir: str) -> None:
    """One rank of path 4g: lower each cell itself, call ``to_spmd(k,
    mesh)()`` 1 + ``reps`` times (the first call's result checked, all
    timed on the host clock, the launches and collective bytes counted
    over all of them), hold the result against ``k.run()`` bit for bit,
    time the rank's kernel alone on its pieces (CUDA events, one rank at
    a time), and give rank 0 every rank's numbers for the cell's
    ``[spmd]`` line; rank 0 also checks the result against the float64
    host product. Writes ``rank<r>.json``; exits non-zero on any
    failure."""
    import datetime
    import os
    import traceback
    import numpy as np
    import torch
    import torch.distributed as dist
    status = {"rank": rank, "ok": False}
    try:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        from repro_torch.core import lower as L
        from repro_torch.distributed import collectives as col
        from repro_torch.distributed import executor as E
        from repro_torch.distributed.mesh import make_mesh
        from repro_torch.kernels import _build
        device = torch.device(device)
        on_card = device.type == "cuda"
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=SPMD_TIMEOUT_S))
        data = load_spmd_operands(Path(spmd_dir))
        stmts = statements(data)
        meshes = {}
        for label in dict.fromkeys(c[2] for c in cells):
            dims = [int(x) for x in label.rstrip("r").split("x")]
            if dims[1:] == [1]:
                dims = dims[:1]
            meshes[label] = make_mesh(dims, "xyz"[:len(dims)],
                                      backend="gloo", device=device)
        totals = {}
        for cell in cells:
            t0 = time.perf_counter()
            k = _spmd_cell(stmts, cell, device)
            lower_s = time.perf_counter() - t0
            mesh = meshes[cell[2]]
            chunks = int(cell[1][7:]) if cell[1].startswith("overlap") else 0
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device) if on_card else 0
            f = E.to_spmd(k, mesh, overlap=bool(chunks),
                          overlap_chunks=chunks or 2)
            before = dict(_build.LAUNCHES)
            traffic = dict(col.TRAFFIC)
            times, gathers = [], []
            for i in range(reps + 1):
                _sync(device)
                t0 = time.perf_counter()
                g0 = col.TRAFFIC["seconds"]
                y = f()
                _sync(device)
                times.append((time.perf_counter() - t0) * 1e3)
                gathers.append((col.TRAFFIC["seconds"] - g0) * 1e3)
                if i == 0:
                    out = y
            calls = reps + 1
            launched = {n: c - before[n] for n, c in _build.LAUNCHES.items()
                        if c != before[n]}
            want = {f.kernel: f.launches * calls} if on_card else {}
            if launched != want:
                raise AssertionError(f"rank {rank} {cell_name(cell)}: "
                                     f"launches {launched}, want {want}")
            for n, c in launched.items():
                totals[n] = totals.get(n, 0) + c
            peak = (torch.cuda.max_memory_allocated(device) if on_card
                    else 0)
            ref = k.run()
            if not torch.is_tensor(ref):
                ref = torch.from_numpy(np.asarray(ref.vals)).to(out.device)
            if not torch.equal(out, ref):
                raise AssertionError(f"rank {rank} {cell_name(cell)}: the "
                                     "executor's result differs from "
                                     "k.run()'s bits")
            kernel_ms = None
            for r in range(world):     # one rank at a time on the card
                dist.barrier()
                if r == rank:
                    kernel_ms = (time_events(f.leaf, reps) if on_card
                                 else time_host(f.leaf, device, reps))
            err = None
            if rank == 0:
                err = check_rows(cell_name(cell), out,
                                 *data["host_products"][cell[0]])
            rec = {"call_ms": statistics.median(times),
                   "kernel_ms": kernel_ms, "lower_s": lower_s,
                   "collective_ms": statistics.median(gathers),
                   "sent": (col.TRAFFIC["sent"] - traffic["sent"]) / calls,
                   "received": (col.TRAFFIC["received"]
                                - traffic["received"]) / calls,
                   "staged": col.TRAFFIC["staged"] - traffic["staged"],
                   "spmd_mem": peak - base, "peak_mem": peak}
            recs = [None] * world
            dist.all_gather_object(recs, rec)
            if rank == 0:
                gb = 2 ** 30
                phase("spmd", cell=k.cell_id() + (f"+overlap{chunks}"
                                                  if chunks else ""),
                      leaf=k.leaf_name, ranks=world, backend=mesh.backend,
                      staged=("none" if not any(r["staged"] for r in recs)
                              else ",".join(col.staged_ops(mesh))),
                      bits_equal_run=True,
                      launches_per_call=json.dumps(
                          {f.kernel: f.launches} if on_card else {}
                      ).replace(" ", ""),
                      call_ms=f"{max(r['call_ms'] for r in recs):.3f}",
                      kernel_ms_min=f"{min(r['kernel_ms'] for r in recs):.4f}",
                      kernel_ms_max=f"{max(r['kernel_ms'] for r in recs):.4f}",
                      collective_ms=f"{max(r['collective_ms'] for r in recs):.3f}",
                      sent_bytes=int(sum(r["sent"] for r in recs)),
                      received_bytes=int(sum(r["received"] for r in recs)),
                      modelled_bytes=k.comm.total_network_bytes(),
                      lower_s=f"{max(r['lower_s'] for r in recs):.2f}",
                      spmd_mem_gb=f"{max(r['spmd_mem'] for r in recs) / gb:.2f}",
                      peak_mem_gb=f"{max(r['peak_mem'] for r in recs) / gb:.2f}",
                      max_abs_err=f"{err:.3g}")
            del k, f, y, out, ref
            L.clear_lowering_caches()
            E.clear_spmd_cache()
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
        status.update(ok=True, launches=totals)
    except Exception:
        status["error"] = traceback.format_exc()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(status))
    if dist.is_initialized():
        dist.destroy_process_group()
    if not status["ok"]:
        sys.exit(1)


def run_rank_group(world: int, cells, reps: int, device, spmd_dir: Path):
    """Spawn ``world`` ranks of :func:`spmd_rank` on a FileStore under
    ``spmd_dir`` (:func:`spawn_group`, within ``SPMD_TIMEOUT_S``); returns
    their statuses."""
    return spawn_group(spmd_rank, world, spmd_dir / f"ranks{world}",
                       (cells, reps, str(device), str(spmd_dir)), "path 4g",
                       SPMD_TIMEOUT_S)


def spmd_parent(device, reps: int, spmd_dir: Path) -> None:
    """Path 4g's single-process part on the card: ``profile_pieces`` over
    the six profiled leaves (per-piece kernel ms by CUDA events, skew) and
    ``run_overlapped`` on the rows and 2x2 SpMM at chunks 2 and 4, overlap
    on and off: bits equal to ``k.run()``, the kernel launched once per
    chunk, and the five ``executor.overlap.*`` values."""
    import torch
    from repro_torch.core import lower as L
    from repro_torch.distributed.executor import (profile_pieces,
                                                  run_overlapped)
    from repro_torch.kernels import _build
    from repro_torch.runtime import telemetry
    data = load_spmd_operands(spmd_dir)
    stmts = statements(data)
    on_card = device.type == "cuda"
    for cell in SPMD_PROFILED:
        L.clear_lowering_caches()
        k = _spmd_cell(stmts, cell, device)
        telemetry.METRICS.clear()
        prof = profile_pieces(k, iters=reps)
        phase("spmd-profile", cell=k.cell_id(), leaf=k.leaf_name,
              piece_ms=",".join(f"{s * 1e3:.4f}" for s in prof.seconds),
              skew=f"{prof.skew():.3f}",
              stragglers=json.dumps(prof.stragglers()).replace(" ", ""))
    for cell in SPMD_OVERLAPPED:
        L.clear_lowering_caches()
        k = _spmd_cell(stmts, cell, device)
        ref = k.run()
        kernel = {"spmm_rows": "spmm_csr_rows",
                  "spmm_grid_rows": "spmm_csr_rows"}[k.leaf_name]
        for chunks in (2, 4):
            for overlap in (True, False):
                telemetry.METRICS.clear()
                before = dict(_build.LAUNCHES)
                t0 = time.perf_counter()
                got = run_overlapped(k, chunks=chunks, overlap=overlap)
                _sync(device)
                ms = (time.perf_counter() - t0) * 1e3
                launched = {n: c - before[n] for n, c in
                            _build.LAUNCHES.items() if c != before[n]}
                if launched != ({kernel: chunks} if on_card else {}):
                    raise AssertionError(f"run_overlapped {k.cell_id()} "
                                         f"chunks {chunks}: launches "
                                         f"{launched}")
                if not torch.equal(got, ref):
                    raise AssertionError(f"run_overlapped {k.cell_id()} "
                                         f"chunks {chunks} overlap "
                                         f"{overlap}: bits differ from "
                                         "k.run()")
                snap = telemetry.METRICS.snapshot()
                cnt = snap["counters"]
                phase("spmd-overlap", cell=k.cell_id(), chunks=chunks,
                      overlap=overlap, bits_equal_run=True,
                      ms=f"{ms:.2f}",
                      comm_s=f"{cnt['executor.overlap.comm_seconds']:.5f}",
                      hidden_s=f"{cnt['executor.overlap.hidden_seconds']:.5f}",
                      bytes=int(cnt["executor.overlap.bytes"]),
                      hidden_bytes=int(cnt["executor.overlap.hidden_bytes"]),
                      efficiency=f"{snap['gauges']['executor.overlap.efficiency']:.3f}")
        del k, ref, got
    L.clear_lowering_caches()


def executor_path(args, device, spmd_dir: Path = SPMD_DIR):
    """Path 4g over the operands :func:`save_spmd_operands` wrote: the
    4-rank group (``Machine(("x", 4))`` and ``Machine(("x", 2), ("y",
    2))``), then the 8-rank group (2x2x2), each rank on ``device`` over
    gloo, then the parent's ``profile_pieces`` and ``run_overlapped``.
    Returns the kernels' launches in the ranks' counted calls."""
    t0 = time.perf_counter()
    # two timed calls a cell (a call moves up to 0.8 s over gloo)
    reps = max(args.reps // 20, 1)
    launches = dict.fromkeys(SPMD_KERNELS, 0)
    for world, cells in SPMD_CELLS.items():
        for st in run_rank_group(world, cells, reps, device, spmd_dir):
            for k, n in st["launches"].items():
                launches[k] += n
    missing = [k for k, n in launches.items() if n == 0]
    if device.type == "cuda" and missing:
        raise AssertionError(f"kernels never launched on the executor "
                             f"path: {missing}")
    phase("launches", path="executor",
          seconds=f"{time.perf_counter() - t0:.1f}", **launches)
    spmd_parent(device, reps, spmd_dir)
    phase("executor", seconds=f"{time.perf_counter() - t0:.1f}")
    return launches


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2-n", type=int, default=LOG2_N,
                    help=f"matrix side as a power of two (default {LOG2_N}; "
                    "a smaller side is a quick rehearsal)")
    ap.add_argument("--log2-i", type=int, default=LOG2_I,
                    help=f"the 3-tensor's first dimension (default {LOG2_I})")
    ap.add_argument("--log2-jk", type=int, default=LOG2_JK,
                    help="the 3-tensor's second and third dimensions "
                    f"(default {LOG2_JK})")
    ap.add_argument("--log2-dense", type=int, default=15,
                    help="side of the dense SpAdd3 sums (default 15: a "
                    "4 GiB output)")
    ap.add_argument("--reps", type=int, default=REPS,
                    help="timed kernel launches (run() a quarter)")
    ap.add_argument("--attn-layers", type=int, default=0,
                    help="layers of the attention path's llama3-8b (default "
                    "0: all 32; fewer is a quick rehearsal)")
    ap.add_argument("--attn-seq", type=int, default=PREFILL_SEQ,
                    help=f"prefill length (default {PREFILL_SEQ})")
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: the repro_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from repro_torch.kernels import _build

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    phase("device", name=repr(kind), count=count, torch=torch.__version__,
          cuda=torch.version.cuda)
    clocks("start")
    memory_rates(device)

    # the sparse paths' operands, made on the host beside the build and
    # phase 3 (numpy releases the GIL in its bulk work)
    from concurrent.futures import ThreadPoolExecutor
    data_pool = ThreadPoolExecutor(1)
    data_job = data_pool.submit(path_data, args)

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build(force=True)
    phase("build", seconds=f"{time.perf_counter() - t0:.1f}",
          sources=",".join(sorted(logs)))
    for src, log in sorted(logs.items()):
        for line in log.splitlines():
            if ("Compiling entry" in line or "Used" in line
                    or "spill" in line):
                print(f"  {src}: {line.strip()}")
    hmma = hmma_counts(_build.lib_path("flash_attention"))
    phase("sass", library="flash_attention", instruction="HMMA", **hmma)
    if not all(n > 0 for f, n in hmma.items() if f.startswith("mma")):
        raise AssertionError(f"a 16-bit flash kernel does not run on the "
                             f"tensor cores: HMMA counts {hmma}")
    usage = ptxas_usage(logs["flash_attention"])
    phase("flash-registers", **{f: "{}:{}:{}".format(*u)
                                for f, u in sorted(usage.items())})
    spilled = {f: u for f, u in usage.items()
               if f in NO_SPILL and (u[1] or u[2])}
    if spilled or set(NO_SPILL) - set(usage):
        raise AssertionError(f"flash_mma_wide_kernel and "
                             f"flash_f32_cluster_kernel must not spill: "
                             f"(registers, spill stores, spill loads) "
                             f"{spilled or usage}")
    split = ptxas_usage(logs["slstm"], slstm_split_name)
    phase("slstm-registers", **{f: "{}:{}:{}".format(*u)
                                for f, u in sorted(split.items())})
    if set(split) != set(SLSTM_SPLIT_KERNELS) or any(
            u[1] or u[2] for u in split.values()):
        raise AssertionError(f"the split sLSTM forward must build once a "
                             f"dtype and spill nothing: "
                             f"(registers, spill stores, spill loads) "
                             f"{split}")
    f32 = {f: n for f, n in hmma.items() if f.startswith("f32")}
    if not f32 or any(f32.values()):
        raise AssertionError(f"the f32 flash kernels must run on the CUDA "
                             f"cores alone: HMMA counts {f32}")
    phase("f32-plan", **{f"hd{hd}_rows": bm
                         for hd, bm in check_f32_plan().items()})
    phase("f32-cluster-plan", **{f"hd{hd}_resident_clusters": n for hd, n
                                 in check_f32_cluster_plan().items()})

    # 3a. kernels against plain at edge-case shapes
    from repro_torch.kernels import flash_attention as FA
    rng = np.random.default_rng(SEED)
    worst = {}
    t0 = time.perf_counter()
    FA.reset_routes()
    for label, name, kargs, abs_args in kernel_cases(rng, device):
        err = compare_kernel(label, name, kargs, abs_args)
        worst[name] = max(worst.get(name, 0.0), err)
    edge_flash = dict(FA.ROUTES)
    phase("kernels-edge", seconds=f"{time.perf_counter() - t0:.1f}",
          **{k: f"{v:.3g}" for k, v in worst.items()})
    # 3b. the sLSTM scan and its transpose against the plain loop; both
    # designs launched (the one-block kernels for the case past the limit)
    from repro_torch.kernels import slstm as K
    t0 = time.perf_counter()
    K.reset_routes()
    edge_by_width = {}
    for dt, errs in slstm_checks(rng, device,
                                 by_width=edge_by_width).items():
        phase("kernels-slstm", dtype=dt, cases=sum(
            c[3] == dt for c in SLSTM_CASES),
              **{k: f"{v:.3g}" for k, v in errs.items()})
    edge_scans = dict(K.ROUTES)
    for design in ("cluster", "block"):
        if not all(K.route_count(k, design, routes=edge_scans)
                   for k in ("slstm_fwd", "slstm_bwd")):
            raise AssertionError(f"phase 3 launched no {design} sLSTM "
                                 f"kernel: {edge_scans}")
    phase("kernels-slstm-path", seconds=f"{time.perf_counter() - t0:.1f}",
          **slstm_launch_fields(edge_scans))
    phase("slstm-split-plan", **check_split_plans())

    # 4a-d, f + 5. the sparse paths, their kernels timed after every count
    records, ttv = sparse_paths(args, device, data_job.result())
    data_pool.shutdown()
    from repro_torch.core import lower as L
    L.clear_lowering_caches()
    gc.collect()
    torch.cuda.empty_cache()

    # 4g. the distributed executor, ranks sharing the card over gloo
    spmd_launches = executor_path(args, device)
    for r in records:
        r["executor_launches"] = spmd_launches.get(r["name"], 0)
    gc.collect()
    torch.cuda.empty_cache()

    # 4e. the attention path, on a card freed of the sparse paths' data
    over = {"n_layers": args.attn_layers} if args.attn_layers else {}
    cfg = lm_config(**over)
    _build.reset_launches()
    FA.reset_routes()
    t0 = time.perf_counter()
    attn, attn_launches = run_attention(cfg, PREFILL_BATCH, args.attn_seq,
                                        device, 5)
    attn_flash = dict(FA.ROUTES)
    missing = [k for k in PATH_KERNELS["attention"]
               if attn_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the attention "
                             f"path: {missing}")
    phase("main", cell=f"{ARCH} prefill", layers=attn["layers"],
          d_model=cfg.d_model, heads=f"{cfg.n_heads}/{cfg.n_kv_heads}",
          batch=PREFILL_BATCH, seq=args.attn_seq,
          run_ms=f"{attn['run_ms']:.3f}", runs=attn["runs"],
          tokens_per_s=f"{attn['tokens_per_s']:.1f}",
          init_s=f"{attn['init_s']:.2f}",
          weights_gb=f"{attn['param_bytes'] / 2**30:.2f}",
          max_mem_gb=f"{attn['max_mem'] / 2**30:.2f}",
          bitwise_repeat=attn["bitwise"],
          rel_frobenius_vs_dense=f"{attn['rel_frobenius']:.4g}",
          f32_max_abs_err=f"{attn['f32_max_abs_err']:.3g}")
    phase("launches", path="attention",
          seconds=f"{time.perf_counter() - t0:.1f}", **attn_launches)
    clocks("after the attention path")

    # 4l's counts on the host, (b) the dry-run CLI and (a) 4k's two train
    # cells, run in processes of their own beside paths 4j and 4k
    cli = dryrun_cli_start()
    cards = {arch: dryrun_card_start(arch, shape) for arch, shape in
             ((TRAIN_ARCH, TRAIN), (XLSTM_ARCH, XLSTM_TRAIN))}
    atexit.register(stop_processes, cli, *cards.values())

    # 4j. LM decode, the Server loop and the ten architectures
    _build.reset_launches()
    FA.reset_routes()
    t0 = time.perf_counter()
    lm_launches, lm_scans = lm_path(device)
    lm_flash = dict(FA.ROUTES)
    missing = [k for k in ("flash_attention", "slstm_fwd")
               if not lm_launches.get(k)]
    if missing:
        raise AssertionError(f"kernels never launched on the LM path: "
                             f"{missing}")
    phase("lm-path", seconds=f"{time.perf_counter() - t0:.1f}",
          max_mem_gb=f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f}")
    phase("launches", path="lm", **lm_launches)
    for path, routes in (("attention", attn_flash), ("lm", lm_flash)):
        phase("flash-launches", path=path, **{
            f"{dt}_hd{w}": n for (dt, w), n in sorted(routes.items())})
    phase("slstm-launches", path="lm", **slstm_launch_fields(lm_scans))
    clocks("after the LM path")

    # 4k. the training stack, on a card freed of path 4j's models
    gc.collect()
    torch.cuda.empty_cache()
    _build.reset_launches()
    K.reset_routes()
    trained = train_path(device)
    train_scans = dict(K.ROUTES)
    # (1)-(4) launch nothing (train_path checks); (5) the sLSTM kernels
    launched = {k: n for k, n in _build.LAUNCHES.items() if n}
    if launched != trained["launches"] or not all(
            launched.get(k) for k in ("slstm_fwd", "slstm_bwd")):
        raise AssertionError(f"kernels launched on the training path: "
                             f"{launched}, want the sLSTM kernels of (5): "
                             f"{trained['launches']}")
    phase("launches", path="train", **_build.LAUNCHES)
    phase("slstm-launches", path="train",
          **slstm_launch_fields(train_scans))
    clocks("after the training path")

    # 4l. the dry-run beside paths 4k and 4e, its CLI, the six examples
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.configs import get_arch
    dryrun_path(device, get_arch(TRAIN_ARCH), TRAIN, trained["full"], cfg,
                PREFILL_BATCH, args.attn_seq, attn, cli=cli,
                xlstm=(get_arch(XLSTM_ARCH), trained["xlstm_train"],
                       trained["xlstm"]), cards=cards)
    clocks("after the dry-run path")
    top = sorted(attn["profile"].items(), key=lambda kv: -kv[1])[:8]
    phase("profile", name="prefill",
          total_ms=f"{sum(attn['profile'].values()):.2f}",
          **{k.replace(" ", "_"): f"{v:.2f}" for k, v in top})
    # the model's layer shapes in each dtype (bf16 is the path's record),
    # then hd 64 in f32 (path 4j's seamless-m4t-medium), hd 256 (the wide
    # 16-bit kernel's narrowest), hd 320 and 512, hd 640 (the f32 cluster
    # kernel, the 16-bit column-chunk kernel) and hd 2176 in f32 (the f32
    # cluster kernel's 256-column blocks), at the layer's heads and
    # length. Each
    # record's launches are those of its dtype and width (the main record's:
    # bf16 at every width) on paths 4e and 4j, every call counted
    # where the wrapper launches (the teacher-forced and checked forwards
    # too), and for the other records phase 3's beside them
    from repro_torch.kernels.flash_attention import padded_width

    def flash_count(routes, dt, width):
        return sum(n for (d, w), n in routes.items()
                   if (d == dt and w == width)
                   or (dt is None and d == "bfloat16"))
    short = {"bfloat16": "", "float32": " f32", "float16": " f16"}
    extra = []
    t0 = time.perf_counter()
    for hd, dts in ((None, ("bfloat16", "float32", "float16")),
                    (64, ("float32",)), (256, tuple(short)),
                    (320, tuple(short)), (512, tuple(short)),
                    (640, tuple(short)), (2176, ("float32",))):
        for dt in dts:
            width = padded_width(hd or cfg.resolved_head_dim)
            main_rec = hd is None and dt == "bfloat16"
            key = (None, None) if main_rec else (dt, width)
            lm_n = flash_count(lm_flash, *key)
            path_n = flash_count(attn_flash, *key) + lm_n
            # the other dtypes and widths over a quarter of the timed
            # launches
            rec = flash_record(
                cfg, PREFILL_BATCH, args.attn_seq, device, dt,
                path_n if main_rec else path_n + edge_flash.get(key, 0),
                args.reps if main_rec else max(args.reps // 4, 3),
                head_dim=hd)
            rec["lm_launches"] = lm_n
            if main_rec:
                records.append(rec)
            else:
                extra.append(dict(rec, name=f"flash_attention("
                                  f"hd{hd or cfg.resolved_head_dim}"
                                  f"{short[dt]})"))
    phase("flash-timing", seconds=f"{time.perf_counter() - t0:.1f}")
    clocks("after the flash timing")
    # the sLSTM kernels at path 4k's shape, a record a dtype; launches of
    # paths 4j and 4k and of phase 3 as the wrappers counted them by dtype
    t0 = time.perf_counter()
    slstm_recs = slstm_records(device, lm_scans, train_scans, edge_scans,
                               edge_by_width, args.reps)
    for r in slstm_recs:
        phase("slstm-timing", name=r["name"], shape=r["shape"],
              ms=f"{r['ms']:.4f}", cluster=r["cluster"],
              k_slices=r["k_slices"], threads=r["threads"],
              cluster_step_ns=("none" if r["cluster_step_ns"] is None
                               else f"{r['cluster_step_ns']:.1f}"),
              serial_floor_ms=f"{r['serial_floor_ms']:.4f}",
              step_us=f"{r['step_us']:.4f}", launches=r["launches"],
              lm_launches=r["lm_launches"],
              train_launches=r["train_launches"],
              edge_launches=r["edge_launches"],
              max_abs_plain=f"{r['max_abs_plain']:.4g}")
    records.extend(slstm_recs)
    phase("slstm-timing-path", seconds=f"{time.perf_counter() - t0:.1f}")
    for r in records:
        for key in ("executor_launches", "runtime_launches",
                    "serving_launches", "autosched_launches",
                    "lm_launches"):
            r.setdefault(key, 0)
    for r in records + [dict(ttv, name="spmv_csr_rows(spttv)")] + extra:
        phase("kernel", name=r["name"], max_abs_err=f"{r['max_abs_err']:.3g}",
              launches=r["launches"],
              runtime_launches=r.get("runtime_launches", 0),
              serving_launches=r.get("serving_launches", 0),
              autosched_launches=r.get("autosched_launches", 0),
              lm_launches=r.get("lm_launches", 0),
              ms=f"{r['ms']:.4f}", bound_ms=f"{r['bound_ms']:.4f}",
              plain_ms=f"{r['plain_ms']:.3f}",
              library_ms=("null" if r["library_ms"] is None
                          else f"{r['library_ms']:.4f}"))
    phase("total", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

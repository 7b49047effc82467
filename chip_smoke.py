#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                   # everything, as below
    python3 chip_smoke.py --kernels-only    # phases 1-2

Phases, in order; any failure exits non-zero:

1. Card and build: the card's name and power limit, then one ``nvcc``
   per source of ``src/repro_torch/kernels/csrc``, all started together
   (``-Xptxas -v`` output printed: registers, shared memory, spills).
2. Each kernel against its plain PyTorch version on the card, on random
   inputs.  Attention: qwen1.5-0.5b and granite-moe-3b-a800m heads at a
   384-token prefill, a chunk at an offset and (B,) decode, the demo's
   short prompts and 4-slot decode, qwen's in bf16 at phase 3f's 32-token
   chunks at offsets 384 and 416 into 512 and decode of 4 slots of 512,
   recurrentgemma-9b's (16 q heads, 1
   kv head of 256, window 2048) at a 2600-token prefill that crosses
   the window, the demo's prompts and (B,) decode of 4 slots of 3072,
   and the reference's ATTN_SWEEP, in bf16 (tensor cores) and f32 (CUDA
   cores, TF32 off); then bf16 at the bf16 kernel's key splits forced to
   1 and 2 and at ``plan``'s count, on granite's and qwen's chunks and
   recurrentgemma's decode and 2600-token prefill.
   SSD: mamba2-1.3b's heads (H 64, P 64, G 1, N 128) at S 5-10, 256,
   1000 (B 2) and 2600, with and without D and h0, and the reference's
   SSD_SWEEP.  RG-LRU: recurrentgemma-9b's width 4096 at S 5-10 and 2600
   (B 1, and B 2 and 3 with h0), with and without h0, and the
   reference's RGLRU_SWEEP; then B 3 S 2600 at chunk lengths 32, 64 and
   128 forced.  SSD and RG-LRU in f32 and bf16.  Router (routing and
   dispatch in one launch): T in {4, 5-10, 64, 384, 2600} at granite's E
   40, k 8, dropless; T 64 with a capacity that drops, 48 experts of
   which 40 are real, deepseek's E 64 k 6 with 60 real and drops; then
   the reference's (T, E) x k grid through ``router_topk``.  Indices
   exact (a swap of two probabilities within 1e-6 is a tie, reported);
   w, probs and the aux sums within tolerance; slots, slot tokens and
   loads exactly equal to the plain dispatch (both forms) of the
   kernel's own indices.  Fletcher-64: the CPU test's lengths, byte
   counts that are no multiple of 4, 155.6 M words (qwen1.5-0.5b's
   embedding), each with one bit flipped, and a mixed batch (4 KB, 1-3
   bytes, a view at offset 1, 4 MB, 11.5 MB, empty) in one launch where
   a flipped byte changes its own shard's checksum only; exactly equal.
   The attention backward (bf16 on the tensor cores: ``attn_bwd_dq_tc``,
   ``attn_bwd_dkdv_tc`` and, split, ``attn_bwd_dkdv_reduce``; f32 on the
   CUDA cores: ``attn_bwd_pre``, ``attn_bwd_dkdv``, ``attn_bwd_dq``; each
   row names its path and row splits) against ``attention_bwd_plain`` on
   the CPU tests' cases (GQA 1, 2, 3 and 16 at head dims 64, 128 and 256;
   causal, window, softcap, prefix, full) at 160 tokens in bf16 and f32,
   with the forward's row lse unsplit and (bf16) at 2 key splits against
   ``attention_fwd_plain``; every call made twice, bitwise equal.
   The router's backward (``router_bwd_kernel``) at granite's E 40, k 8
   and training's capacity factor 1.25, T 4, 64 and 1024, and with 8
   padded experts, against autograd through ``router_dispatch_plain`` and
   against ``router_bwd_plain``; the MoE combine and its backward with the
   router's (``csrc/moe_combine.cu``) at granite's E 40, k 8, d 1536,
   bf16 and f32: T 4 and 64 dropless, T 64 at C 13, training's T 1024
   at C 256, 48 experts of which 40 are real, and rows of 90 and 66
   values (no multiple of 16 bytes), against ``moe_combine_plain`` and
   ``moe_combine_bwd_plain`` (the largest error over the largest entry,
   1e-5 f32, 2e-2 bf16; the empty slots' rows zero; two runs bitwise
   equal); the SSD's backward (``csrc/ssd_bwd.cu``:
   ``ssd_bwd_state``, ``ssd_bwd_chunk``, ``ssd_bwd_reduce``, 3xTF32 on
   the tensor cores) at mamba2's heads, 8 x 128, 2 x 1024 (dh_final), S
   100 (h0, dh_final), 8 groups and N 90 (no multiple of 4), f32 and
   bf16, against autograd through ``ssd_plain``: each gradient's error
   over its largest entry, 1e-4 (f32) or 2e-2 + 2^-7 (bf16); two runs
   bitwise equal; h0's gradient (the walk's one more step) at S 100 and
   S 40 (one chunk: the walk alone) against autograd's; each row
   with its launch plan (launches a call, the head slice hs, each
   kernel's blocks, shared-memory bytes and blocks an SM).  The RG-LRU's
   backward (``csrc/rglru_bwd.cu``, one launch) at recurrentgemma-9b's
   width 4096: f32 8 x 128, 2 x 1024 (dh_final), S 100 (h0, dh_final), 4
   x 1 and saturated gates near a = 1, bf16 8 x 128, and an h0 that
   needs a gradient (2 x 256, through ``RGLRUFunction`` too), against
   ``rglru_bwd_plain`` on the forward kernels' kept states (each
   gradient's error over its largest entry, dh0 among them, 1e-4 f32 or
   2e-2 + 2^-7 bf16; dlambda's also against an f64 plain run, printed);
   two runs bitwise equal.  The attention backward at recurrentgemma-9b's
   heads, bf16, 8 x 128 and 1 x 4096 (the window binds), beside SDPA's
   backward alone (its forward run once outside the timed region) and
   the backend SDPA picked.
   The encoder-decoder's and the VLM's attention (``FRONTEND_CASES``), bf16
   and f32: seamless-m4t-large-v2's encoder (non-causal, 1 and 8 x 512),
   its cross attention (non-causal, 1 x 10 and 8 x 128 queries and 4
   decode slots against 512 frames), paligemma-3b's prefix-LM prefill
   (MQA 8/1 of 256, prefix 256: 1 x 266 and 8 x 384); their training
   backwards in bf16 (encoder 8 x 512, cross 8 x 128 against 512, the
   prefix-LM at 8 x 384).  The MQA training backwards (recurrentgemma's 8 x
   128, paligemma's 8 x 384) with the dK/dV rows forced into 1, 2 and 4
   splits.
   The spec shapes are timed (CUDA events, warmed up, L2 flushed) beside
   the least time the card could take.
3. The main paths, each driven with the kernels' launch counts set to 0
   just before it and read just after; every (kernel, entry point,
   shape) is recorded with the inputs of its last launch:
   a. qwen1.5-0.5b serving: the launcher's ``--demo`` (tcp ``Engine`` +
      ``ServingGateway``, six prompts through ``gen.submit`` /
      ``gen.result``), then sessions (chunked prefill of 64 tokens,
      ``session_cap=4``, ``max_len=1024``, two conversations of three
      ~384-token turns through ``gen.generate`` with a ``session_id``).
      Attention must launch on prefill, chunk and decode.
   f. (run next) Multi-turn sessions through the fabric, the reference's
      serve_session scenario at its full size: a ``RegistryService`` in
      this process and 3 replica subprocesses, each full-width
      qwen1.5-0.5b on this one card (the kernels built here first)
      behind a ``ServingGateway`` that registers with it (4 slots of 512,
      32-token chunks, 8 sessions).  A ``ServicePool`` sends 8
      conversations of 6 greedy turns (384-token first prompts, 2 new
      tokens, 4 fresh a turn): naive, then through ``SessionAffinity``,
      then affine again with replica 0 SIGKILLed before turn 2.  Every
      turn must complete, the surviving replicas must show prefix reuse,
      a session must be re-homed.  Each replica warms up as the
      reference's worker (one warm turn, one session resume), then sets
      attention's count to 0 and records its launches as phase 3a does;
      each surviving replica must have launched attention on chunk and
      decode and nowhere outside the Model entry points (the engine
      chunks every prompt, so this path has no monolithic prefill).
      Tokens/s, follow-up TTFT p50/p99 and whether the reference's >= 2x
      held are printed, not enforced.
   b. granite-moe-3b-a800m serving, the same demo and sessions at full
      width: attention, the MoE router and the MoE combine must launch on
      each.  Then one MoE layer at granite's width on a decode step's 4
      tokens and a chunk's 64: it must make no host sync
      (``torch.cuda``'s sync debug mode set to "error"), its routing, each
      assignment's slot and its dispatched buffer must equal bit for bit
      those of the eager-dispatch layer the port ran before (kept here as
      a yardstick), its y must lie within ``MOE_Y_TOL`` of the eager
      layer's largest entry (the combine sums in f32 and rounds once,
      where the eager layer rounded each product to bf16; the largest
      difference is printed), and ``torch.profiler`` counts both layers'
      launches around the router matmul and the expert products.
   c. The checkpoint service: full-width qwen1.5-0.5b weights saved from
      the card through ``CheckpointClient`` to a ``CheckpointServer``
      over tcp (checksums on the card, verified on the server's card),
      restored to the card bitwise-equal; a restore from a store with
      one flipped byte raises CHECKSUM_ERROR; one greedy request served
      with the restored weights gives the original tokens.  Fletcher-64
      must launch on save, verify and restore: one batch for the save's
      manifest and one for each restore, one for each group of shards
      the server verifies.
   g. (run next) Training: ``launch.train.main`` on full-width
      qwen1.5-0.5b at the launcher's defaults (8 x 128, 20 steps, AdamW, a
      checkpoint every 10, bf16 compute, remat "none") through its
      services: batches over RPC from a ``DataFeedServer``, a
      ``MembershipServer`` joined and left, async saves of the state on
      the card (params, m, v) to a ``CheckpointServer`` that verifies on
      the card.  The loss must be finite at every step and the mean of
      the last 5 below the first; attention's forward must launch 24
      times a step inside ``Model.loss_fn`` and its backward 24 times a
      step in the step's autograd, and nowhere else; Fletcher-64 one
      batch a save and the server's verify groups; the router, the SSD
      and the RG-LRU never.  Then one step at 4 x 1024 with remat
      "block" (the forward launches again in the backward: 48 a step),
      then the restart check: 6 steps straight against 3, a save, a
      restore into a fresh state (seed 42) and 3 more, the parameters
      equal to rtol 1e-5 / atol 1e-6.  Steps/s and tokens/s printed,
      not enforced.
   h. (run next) mamba2-1.3b training at full width and depth through
      ``launch.train.main`` (8 x 128, 10 steps, AdamW, remat "none", one
      save of params, m and v at the end, verified on the card): the SSD's
      forward and backward 48 times a step each, the loss finite and
      falling, Fletcher one batch for the save, the peak memory
      printed; then 3 steps twice from one seed, the parameters within
      1e-6 (bitwise printed).
   i. granite-moe-3b-a800m training at full width and depth through
      ``init_state`` / ``make_train_step``, batches over RPC from a
      ``DataFeedServer``, a ``MembershipClient`` joined and left, no
      save (8 x 128, 10 steps, capacity factor 1.25): attention's
      forward and backward, the router's forward and the MoE combine's
      forward and backward 32 times a step each, the router's own
      backward never (the combine's backward takes the logits'
      gradient), ``moe_lb`` and ``moe_z`` printed; then the repeat check.
   j. recurrentgemma-9b training at full width, cut to 11 of its 38
      layers (three periods of rglru, rglru, local and the two trailing
      RG-LRU layers; 38 layers with AdamW need 136.4 GB), through
      ``init_state`` / ``make_train_step``, batches over RPC from a
      ``DataFeedServer``, a ``MembershipClient`` joined and left, no
      save (8 x 128, 10 steps, AdamW, bf16 compute): the RG-LRU forward
      (its states kept) and backward 8 times a step each, attention's
      3 + 3; loss curve, step ms, tokens/s and peak memory printed; the
      loss finite and falling; then the repeat check at the same cut.
   k. paligemma-3b (18 layers, MQA 8/1 of 256, tied 257,216-token
      embedding) and l. seamless-m4t-large-v2 (24 encoder + 24 decoder
      layers) at full width and depth, after 3d and 3e.  Serving: 6
      requests of 5-10 prompt tokens, each with a seeded frontend
      (paligemma's 256 patches of 1152, seamless's 512 frames of 160),
      12 new tokens, all through ``gen.submit`` with ``frontend`` to a
      ``ServingGateway`` over tcp and ``gen.result``, into 4 slots;
      chunking and sessions asked for and turned off by the engine.
      Attention must launch on prefill (paligemma: the prefix-LM mask over
      the patches; seamless: the encoder, non-causal, and cross attention)
      and decode (seamless: cross attention against the cached K/V too).
      Training, 8 x 128 text tokens with their frontends, AdamW, bf16
      compute, remat "none", 10 steps: seamless through
      ``launch.train.main`` with one save of params, m and v at the end
      (verified on the card, Fletcher-64's batches), paligemma through
      ``make_train_step`` with batches over RPC; attention forward and
      backward once a layer and step (seamless: 24 encoder, 24 decoder,
      24 cross), the loss falling; then 3 steps twice, bitwise equal.
   m. (run last, the card's memory freed) Distribution: 4 rank
      subprocesses of this script (``--distrib-rank``, and
      ``--serve-rank`` for 3n after it) on the one card, a gloo world
      with CUDA tensors (the kernels built here first), each writing its
      results back, each sub-check's wall seconds printed.
      1: granite-moe-3b-a800m at full width cut to 2 of 32 layers
      through ``make_train_step(..., mesh=)`` on a
      (data 2, model 2) mesh: state stored as ``tree_shardings`` places
      it (each rank's bytes equal ``bytes_per_device``), bf16 compute,
      AdamW with phase 3i's schedule, 8 x 128 global, capacity factor
      1.25, 2 steps; the loss finite and the last below the first; on
      every rank the router (experts [0, 20) or [20, 40)), the combine's
      forward and backward and attention's forward and backward (12 of
      24 query heads, 4 of 8 key/value heads) once a layer and step;
      step ms, peak memory and the collectives' calls, bytes and share
      of the step by kind printed.  Then granite at 2 layers, f32, TF32
      off, 2 x 128, dropless, one step, gathered, against one process
      from the same seed (``TRAIN_PARITY_TOL``).  1b: qwen1.5-0.5b at
      full width cut to 8 of 24 layers, the same mesh: bf16 compute,
      AdamW, remat "block", 8 x 128 global, 2 steps; each rank's stored
      bytes ``bytes_per_device``'s, the loss falling, attention 8 + 8
      forward and 8 backward a step on every rank, each at 8 of 16
      query and 8 of 16 key/value heads (tensor parallel: the
      vocabulary-parallel loss, column- and row-parallel MLPs, each
      layer's leaves gathered over the data axis only as it runs);
      step ms, peak memory and the collectives by kind printed, the
      collectives a step (calls and bytes) equal to what
      ``tools/tp_bytes.py`` reckons for the same depth; then its 2-layer
      f32 step against one process (``TRAIN_PARITY_TOL``).
      1c: mamba2-1.3b at full width cut to 4 of 48 layers, the same
      mesh, bf16, AdamW, remat "block", 8 x 128 global, 2 steps: the SSD
      blocks in tensor parallel, SSD forward 4 + 4 and backward 4 a
      step on every rank, each at 32 of 64 heads (P 64, G 1, N 128);
      stored bytes, the falling loss, step ms, peak and collectives as
      1b; then its 2-layer f32 step against one process.  1d:
      recurrentgemma-9b at full width cut to 3 layers (rec, rec, local),
      the same mesh and schedule (2 steps), sequence-parallel as the
      reference's rule chooses it (``seq_parallel_for``: d_model 4096,
      dense, 128 divisible by 2): RG-LRU 2 + 2 forward and 2 backward a
      step at 2048 of 4096 channels, attention 1 + 1 and 1 at 8 of 16
      query heads (the key/value head whole), every layer's input 64 of
      the 128 positions, the collectives as 1b; then its 3-layer f32
      step against one process.  1e: Adafactor on the mesh, qwen1.5-0.5b
      at full width cut to 2 layers, bf16, remat "block", 8 x 128
      global, 2 steps: each rank's stored bytes ``bytes_per_device`` of
      the Adafactor state (the reference's plus the stated copies of the
      norm scales' columns), the loss falling, attention at 8 of 16
      heads forward and backward on every rank, the collectives a step
      (the two rounds of factor sums included) ``tools/tp_bytes.py
      --opt adafactor``'s; then a 2-layer f32 Adafactor step against one
      process.  1f: the dry run's ``param_gather=bfloat16``, qwen at 2
      layers, AdamW, the same mesh, 2 steps: every f32 block cast to
      bf16 before its gather, so its gather and its gradient's
      reduce-scatter (all-reduces in gloo's CUDA form) travel in bf16;
      the collectives a step ``tools/tp_bytes.py``'s for the variant,
      their bf16 bytes half of a layer's f32 gathers in 1b's reckoning;
      then the 2-layer f32 loss and gradients against one process's over
      the same bf16-cast parameters (``GRAD_TOL`` bf16).  1g: the dry
      run's ``flat_dp``, granite-moe-3b-a800m at full width cut to 2
      layers, AdamW, the batch over all 4 ranks, 2 steps, capacity
      factor 1.25: no tensor parallelism, every collective over all 4
      ranks, the router over all 40 experts and the combine forward and
      backward on every rank, attention at all 24 / 8 heads, the
      collectives ``tools/tp_bytes.py``'s; then a 2-layer f32 dropless
      step against one process.  Each rank's peak in 1e-1g is printed
      beside the dry run's trace of the same cell and variant (on the
      host, both collective forms).
      2: ``sp_decode_attention`` over
      (data 1, model 4) at qwen1.5-0.5b's heads, B 4, T 32768 (8192 keys
      a rank), bf16, softcap 0 and 30, against the whole-cache kernel and
      the plain version (``TOL``).  3: ``compressed_allreduce_tree`` over
      (data 4, model 1) of each rank's gradient tree of the 2-layer
      model, within 0.75 of the shared scale of the exact mean; the
      error-feedback toy converges.  4: ``pipeline_apply`` over a
      (stage,) mesh of 4, 6 of qwen's 24 blocks a stage, 8 microbatches
      of 1 x 128, against the 24 blocks in one process (``PIPE_TOL``),
      attention launching on every stage.  NCCL must refuse two ranks
      on the card.  Rank 0 then checks and times its recorded kernel
      inputs (phase 4) while the others wait.  5 (in this process,
      while the ranks start up): a one-rank NCCL mesh runs the 2-layer
      step, held to the step without
      a mesh (1e-6, bitwise printed), and ``GatherFromAxes`` /
      ``ReduceScatterToAxes`` over its one-rank data axis, which NCCL
      runs in the direct form (its all-gather and reduce-scatter calls,
      counted).  A ``distrib {json}`` line sums up.
   n. (after m) Serving on a mesh: the same 4 rank processes
      (``--serve-rank``) and gloo world, mesh (data 2, model 2),
      ``Model.prefill`` / ``decode_step`` with ``spmd=``: qwen1.5-0.5b
      at full width cut to 2 layers, bf16, 4 prompts of 512 (2 a rank)
      into a cache of 1024 (512 positions a rank), then 2 greedy decode
      steps; then granite-moe-3b-a800m at 2 layers (expert-parallel),
      mamba2-1.3b at 2 and recurrentgemma-9b at 3 (rec, rec, local) with
      the same prompts and cache and 1 step each
      (``SERVE_RUNS``; MoE prefill at capacity factor 2.0).  On every
      rank prefill launches attention (the rank's heads), the router and
      the combine (the rank's experts),
      the SSD (its heads) and the RG-LRU (its channels) once a layer,
      and each decode step the attention partial of
      ``sp_decode_attention`` once an attention layer; prefill ms,
      decode ms a token, all-reduces and their bytes a step and each
      rank's peak memory printed.  Parity: each arch at 2
      layers (recurrentgemma 3) in f32, TF32 off, against one process's
      unsharded prefill and one decode step (``SERVE_PARITY_TOL`` of the
      largest logit, greedy tokens equal).  Memory: each rank's peak of
      each run
      beside the dry run's ``peak_bytes`` of the same cells, traced in a
      subprocess of this script (``launch/dryrun.py``, a fake world of 4)
      in the direct form and with gathers in the all-reduce form gloo
      takes here, within ``SERVE_MEM_TOL`` of the direct form's.  Rank
      0 then checks and times its recorded kernel inputs (phase 4).  A
      ``serve {json}`` line sums up.
   d. mamba2-1.3b and e. recurrentgemma-9b serving at full width: the
      launcher's ``--demo``, then in place of sessions a long-prompt
      phase: four prompts of 600, 1100, 2000 and 2600 tokens at once
      through ``gen.generate`` into 4 slots of 3072, 8 new tokens each,
      chunking and sessions asked for and turned off by the engine (the
      models cannot chunk).  SSD (mamba2) and RG-LRU (recurrentgemma)
      must launch on prefill and nowhere else, decode must run, and
      attention must launch on prefill and decode (recurrentgemma).
   o. (after 3l) gemma3-12b served at full width and depth in its
      configured f32 weights (47.1 GB; 16 query and 8 key/value heads of
      256, a window of 1024 on five layers of six, qk-norm, a second
      RoPE base on the global layers, a tied 262144 x 3840 table): the
      launcher's ``--demo``, the card freed (two copies do not fit), then
      on one draw of the weights the sessions of 3a and one
      window-crossing request: a 1536-token prompt in chunks of 64 into
      a slot of 2048, 8 new tokens; the local layers' last chunk must
      run at an offset past the window (its keys below the window
      masked; phase 4 holds it against the plain version) and the global
      layers' chunks without one.  p. deepseek-moe-16b (the dense first
      layer of 10944, then 27 MoE layers: 64 routed experts at k 6 and
      two shared ones) and q. command-r-35b (64 query and 8 key/value
      heads of 128, the parallel block, a tied 256000 x 8192 table), each
      served in bf16 weights (32.8 and 60.6 GB; no launcher takes a
      dtype, so the engines are built here): the demo's six requests
      through ``gen.submit`` / ``gen.result`` into 4 slots of 128, then
      the sessions of 3a.  v. (after 3q) nemotron-4-340b the same way,
      in bf16 weights cut to 4 of its 96 layers (46.5 GB: 96 query and
      8 key/value heads of 192, run on the kernels' 256 tiles
      zero-padded, the squared-ReLU MLP of 73728, untied 256000 x 18432
      tables).  Each path: attention (and the router and the
      combine, deepseek) must launch on prefill, chunk and decode and
      nowhere else, at least two turns must resume a session, every
      token must lie in the vocabulary and nothing may be shed; the
      weights' bytes, the card's peak, the time to first token, each
      entry point's ms a call (the card synchronised around it), the
      split of one decode step and the launches by entry point are
      printed, with a ``breadth {json}`` line.
   r. (after 3v) qwen1.5-0.5b at full width, 8 x 128: 10 Adafactor steps
      through ``init_state`` / ``make_train_step``, batches over RPC,
      then 10 steps of ``launch.train.main`` with ``--microbatches 2``
      (AdamW, its save at the end); attention's forward and backward
      once a layer and microbatch, the loss falling, then each one's
      repeat check (3 steps twice, ``REPEAT_ATOL``).
   s-u. (after 3r) three more configurations trained at full width in
      f32 weights and bf16 compute, cut in depth to hold every layer
      kind (``TRAIN_BREADTH``), through ``train_over_rpc``: s.
      gemma3-12b's one period (5 local layers, 1 global) with AdamW at
      2 x 1536, so that the local layers' window of 1024 binds in the
      forward and the backward; t. deepseek-moe-16b's dense layer 0 and
      3 MoE layers with AdamW at 8 x 128 (the router at T 1024, E 64, k
      6, capacity factor 1.25; the combine's forward and backward beside
      the 2 shared experts); u. command-r-35b's 4 parallel blocks with
      Adafactor at 8 x 128.  Each prints its parameters', gradients' and
      optimizer state's reckoned bytes before they are made and the
      card's peak over the steps beside them; the loss must fall, every
      kernel of the layers launch on every step, and the repeat check
      pass at the same cut and shape.
4. The main paths' own shapes: each kernel against its plain version on
   the recorded inputs, timed and bounded as in phase 2 (an attention
   row names its ``path`` and ``n_split``); phase 3g's attention
   backward rows also time SDPA's backward (forward + backward less the
   forward) as the library yardstick; phases 3h, 3i and 3j add the
   SSD's, the router's, the MoE combine's and the RG-LRU's training
   forwards (the RG-LRU's with its kept states) and backwards; phase 3m
   adds rank 0's training rows (the router at 20 of 40 experts, and at
   all 40 under ``flat_dp``; attention at granite's, qwen's and
   recurrentgemma's local heads, and at all of granite's under
   ``flat_dp``; the SSD at 32 of mamba2's 64 heads and the RG-LRU at
   2048 of recurrentgemma's 4096 channels, forward and backward) and the
   attention partial of ``sp_decode_attention``; phases 3s-3u their
   training rows (attention at head_dim 256 with the window binding, the
   router and the combine at E 64, k 6), 3v nemotron's attention at
   head_dim 192, bounded at 192 so that the padding shows as lost time,
   with SDPA (and its backward alone) beside each attention row.  These
   rows, with the main
   paths' launch counts, make the kernels' JSON summary; phase 3f's
   surviving replicas each check their own recorded inputs before they
   exit and send the rows back.
5. Full-width parity, f32 compute, TF32 off: prefill and 8 (B,) decode
   steps through the kernels against the same through the plain
   versions: 2x128 for qwen1.5-0.5b and granite-moe-3b-a800m, 2x640 for
   mamba2-1.3b and recurrentgemma-9b (three of the reference's 256-token
   SSD chunks, so the state is carried).  Then the training loss and
   every gradient leaf at 2x128 in f32 through the kernels' forwards and
   backwards against autograd through the plain versions: qwen1.5-0.5b
   and granite-moe-3b-a800m at full depth; mamba2-1.3b's backward
   kernels at full depth under the plain forward, its whole path at 4
   layers, and its whole path at 48 printed (``ssm_train_parity``);
   recurrentgemma-9b at 5 layers (one period and the two trailing) and
   at phase 3j's 11.  paligemma-3b and seamless-m4t-large-v2 with seeded
   frontends: serving parity at 2 x 128 text tokens, training parity
   (full depth) at 2 x 128; cross attention's key-bias gradients, zero in
   exact arithmetic, held against the largest gradient entry.  Serving
   parity also for gemma3-12b at full depth with 2 x 1100 (its window
   binds in prefill), deepseek-moe-16b at 8 layers (the dense layer 0
   and 7 MoE layers), command-r-35b at 4 and nemotron-4-340b at 2, the
   last three in the bf16 weights they are served in
   (``BREADTH_PARITY``), each run's launches exact; and their training
   parity (``TRAIN_BREADTH_PARITY``): gemma3-12b at 6 layers and 1 x
   1100 (the window binding), deepseek-moe-16b at 2 (the dense layer 0
   and one MoE layer) and command-r-35b at 2.

Each phase's wall seconds are printed on a line of its own as it ends,
and all of them on a ``phase seconds {json}`` line before the summary.

The last three lines of stdout are the card's name and power limit, the
kernels' JSON summary and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import queue
import subprocess
import sys
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core.executor import Engine  # noqa: E402
from repro_torch.core.types import MercuryError, Ret  # noqa: E402
from repro_torch.kernels import SOURCES  # noqa: E402
from repro_torch.kernels import attention as fa  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.cost import (  # noqa: E402
    attn_bwd_bound, bound_ms, combine_bound, combine_bwd_bound,
    combine_kept, cross_entropy_bound, fletcher_bound, rglru_bound,
    rglru_bwd_bound, router_bound, router_bwd_bound, ssd_bound,
    ssd_bwd_bound, visible)
from repro_torch.kernels import cross_entropy as kce  # noqa: E402
from repro_torch.kernels import fletcher as fl  # noqa: E402
from repro_torch.kernels import moe_combine as kc  # noqa: E402
from repro_torch.kernels import moe_router as kr  # noqa: E402
from repro_torch.kernels import rglru as krg  # noqa: E402
from repro_torch.kernels import ssd as kssd  # noqa: E402
from repro_torch.configs.base import ATTN_KINDS, ParallelConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticSource  # noqa: E402
from repro_torch.distrib.sharding import local_block  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import attention as attn_layer  # noqa: E402
from repro_torch.models import moe as moe_layer  # noqa: E402
from repro_torch.models import rglru_block, ssd_block  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import common as model_common  # noqa: E402
from repro_torch.models.common import dtype_of  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.services import base as svc_base  # noqa: E402
from repro_torch.services import checkpoint as ckpt  # noqa: E402
from repro_torch.services import ServingGateway  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train import step as train_step  # noqa: E402

ARCH = "qwen1.5-0.5b"
MOE_ARCH = "granite-moe-3b-a800m"
SSM_ARCH = "mamba2-1.3b"
HYBRID_ARCH = "recurrentgemma-9b"
VLM_ARCH = "paligemma-3b"
ENCDEC_ARCH = "seamless-m4t-large-v2"
FRONTEND_ARCHS = (VLM_ARCH, ENCDEC_ARCH)
# attention's error, element by element: |got - want| <= TOL + ULP *
# |want|.  Both sides round the output to its dtype, so they may part by
# one unit in the last place, 2^-7 of the value in bf16: past |want| = 4
# (training's activations reach 4-8) that unit alone exceeds TOL
TOL = {torch.bfloat16: 2e-2,
       # looser than the CPU's 2e-5: the kernel sums in another order
       torch.float32: 1e-4}
ULP = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -23}
# Also per output row (one query, one head): its largest error over its
# largest |value|.  Rows over long keys average to small values (~0.05
# at T=1024), under which a wrong tile could hide in bf16's absolute
# limit; rounding the output to bf16 alone costs at most 2^-7 here.
ROW_TOL = 2e-2
PARITY_TOL = 2e-3   # full-width logits, f32, 24 / 32 / 48 / 38 layers
# router: w and probs as tests/test_kernels.py holds the Pallas kernel
# (the kernel's expf and sum order against torch's); indices exact, where
# two probabilities within TIE_GAP of each other may swap (a tie)
ROUTER_RTOL, ROUTER_ATOL, TIE_GAP = 1e-5, 1e-6, 1e-6
# tests/test_kernels.py's ATTN_SWEEP (tests/test_torch_isolation.py keeps
# the two equal): S, T, Hq, Hkv, D, causal, window, softcap, prefix, dtype
ATTN_SWEEP = [
    (64, 64, 4, 2, 16, True, 0, 0.0, None, "float32"),
    (128, 128, 4, 4, 32, True, 32, 0.0, None, "float32"),
    (96, 96, 8, 1, 64, True, 0, 30.0, None, "float32"),
    (80, 80, 4, 2, 16, True, 0, 0.0, 24, "float32"),
    (200, 200, 2, 2, 16, True, 0, 0.0, None, "float32"),
    (64, 64, 2, 2, 16, False, 0, 0.0, None, "float32"),
    (128, 128, 4, 2, 32, True, 0, 0.0, None, "bfloat16"),
]
# SSD and RG-LRU against their plain versions: tests/test_kernels.py's
# 2e-4 in f32 (sums in another order, the kernels' own chunks against the
# plain version's 256); in bf16 the outputs are rounded to bf16 on both
# sides (2^-8 relative)
SCAN_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# tests/test_kernels.py's SSD_SWEEP: B, S, H, P, G, N, chunk, use_D, use_h0
SSD_SWEEP = [
    (2, 64, 4, 8, 2, 16, 32, True, True),
    (1, 100, 2, 16, 1, 8, 32, False, False),
    (3, 33, 4, 4, 4, 4, 16, True, False),
]
# tests/test_kernels.py's RGLRU_SWEEP: B, S, W, block_t, block_w, use_h0
RGLRU_SWEEP = [(2, 64, 32, 16, 32, True), (1, 70, 40, 16, 32, False),
               (3, 128, 8, 64, 8, True)]
# the long-prompt phase of the recurrent models: prompt lengths, cache
LONG_PROMPTS = (600, 1100, 2000, 2600)
LONG_MAX_LEN = 3072
# tests/test_kernels.py's router grid: (T, E), k (k > E skipped there)
ROUTER_GRID = [((T, E), k) for (T, E) in [(32, 8), (100, 16), (256, 40)]
               for k in (1, 2, 6)]
QWEN_EMBED_WORDS = 151936 * 1024       # qwen1.5-0.5b's largest shard, f32
# the attention backward against its plain version: the largest error of
# dq, dk and dv over its largest |entry| (bf16: inputs and outputs rounded
# to bf16 on both sides; f32: sums in another order); the
# forward's row lse in absolute terms (logits summed in another order)
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LSE_TOL = 1e-3
# tests/test_torch_attention_bwd.py's CASES: Hq, Hkv, D, causal, window,
# softcap, prefix (GQA groups of 1, 2, 3 and 16 at head dims 64, 128 and
# 256)
BWD_SWEEP = [
    (4, 4, 64, True, 0, 0.0, None), (6, 2, 64, True, 7, 0.0, None),
    (16, 1, 64, True, 0, 30.0, None), (2, 2, 256, True, 5, 20.0, None),
    (3, 1, 256, True, 0, 0.0, None), (16, 1, 256, True, 9, 0.0, None),
    (6, 2, 64, True, 0, 0.0, 6), (4, 4, 64, False, 0, 0.0, None),
    (4, 2, 128, True, 0, 0.0, None),
]
# phase 3g: the launcher's defaults (8 x 128, 20 steps, a checkpoint every
# 10), then one step at 4 x 1024 with remat "block", then the restart
# check at the launcher's shape
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_CKPT_EVERY = 20, 8, 128, 10
LONG_TRAIN = dict(batch=4, seq=1024)
# f32 full width: each gradient leaf's largest error over its largest
# |entry|, and the loss's relative error, at tests/test_torch_train.py's
# per-leaf 1e-4 (there against the reference; here kernels against plain)
TRAIN_PARITY_TOL = 1e-4
# the router's and the SSD's backwards against their plain versions: each
# gradient's largest error over its largest |entry| (f32: sums in another
# order; bf16: inputs and outputs rounded to bf16 on both sides, 2e-2 and
# one unit in the last place, 2^-7, of the largest entry)
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2 + 2.0 ** -7}
# the MoE combine and its backward against their plain versions: the
# largest error over the largest |entry| (f32: the same products summed
# in another order; bf16: both sides sum in f32 and round once, so an
# entry parts only where its rounding lands the other way, by one unit in
# its last place, at most 2^-7 of the largest entry; held at bf16's 2e-2)
COMBINE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# ... and the share of the bf16 outputs' entries (y, d_out_buf) that
# differ at all.  The f32 sums part by a unit of f32 or two, so about one
# entry in 10^4 rounds the other way; a kernel that rounds each product to
# bf16 before the sum (within 2e-2 of the largest entry all the same)
# parts on most entries
COMBINE_DIFFER_SHARE = 1e-2
# phase 3b: the MoE layer's y against the eager-dispatch layer's, over the
# largest |entry|.  The eager layer rounds each of a token's 8 weighted
# rows to bf16 (w cast to bf16 too) before it sums them; the combine sums
# in f32 and rounds once.  Each rounding is at most 2^-9 of its value, so
# the two part by a few units of 2^-8 of the largest row: bf16's 2e-2,
# the combine kernel's own tolerance
MOE_Y_TOL = 2e-2
# phase 3h: mamba2-1.3b through the launcher, 10 steps of 8 x 128 and one
# save at the end; phase 3i: granite-moe-3b-a800m, 10 steps of 8 x 128
# through init_state / make_train_step, batches over RPC, no save; both:
# 3 steps twice from one seed, the parameters equal within REPEAT_ATOL
# (the restart check's 1e-6)
SSM_TRAIN_STEPS, MOE_TRAIN_STEPS, REPEAT_STEPS = 10, 10, 3
REPEAT_ATOL = 1e-6
# phases 3k (paligemma-3b) and 3l (seamless-m4t-large-v2) at full width
# and depth: 6 requests of 5-10 prompt tokens, each with a seeded
# frontend (256 patches of 1152, 512 frames of 160), 12 new tokens, into 4
# slots; then FRONTEND_TRAIN_STEPS steps of 8 x 128 text tokens with
# their frontends (AdamW, bf16 compute; seamless through the launcher and
# its save, paligemma through make_train_step) and the repeat check
FRONTEND_PROMPTS, FRONTEND_NEW, FRONTEND_TRAIN_STEPS = 6, 12, 10
# phase 3j: recurrentgemma-9b at full width, cut to three whole periods
# (rglru, rglru, local) and the two trailing RG-LRU layers, so that every
# layer kind and the partial period train.  Its 38 layers with AdamW need
# 136.4 GB of params, gradients, m and v; 11 need 51.5 GB, which leave
# room on one 80 GB card for AdamW's per-leaf temporaries on the tied
# 256000 x 4096 embedding (tools/train_profile.py takes the same cut).
# 10 steps of 8 x 128 through init_state / make_train_step, batches over
# RPC, no save; then the repeat check at the same cut
HYBRID_TRAIN_LAYERS, HYBRID_TRAIN_STEPS = 11, 10
# recurrentgemma's whole training path (forward and backward kernels) is
# held to TRAIN_PARITY_TOL at full width at this depth (one period and the
# two trailing layers) and at phase 3j's: its gradients do not drift with
# depth as mamba2's do
HYBRID_PARITY_LAYERS = 5
# mamba2's whole training path (forward and backward kernels) is held to
# TRAIN_PARITY_TOL at this depth (ssm_train_parity says why not at 48)
SSM_PARITY_LAYERS = 4
# phases 3o-3q and 3v: four more configurations served at full width
# (phase, arch, the dtype its weights are served in: None for the
# config's own; layers: None for all).  gemma3-12b's f32 weights (47.1
# GB) fit one card; deepseek-moe-16b (65.5 GB in f32) and command-r-35b
# (121.1 GB) are served in bf16 (32.8 and 60.6 GB); nemotron-4-340b in
# bf16, cut to 4 of its 96 layers (46.5 GB: its untied 256000 x 18432
# tables alone are 18.9 GB), attention at head_dim 192 on the kernels'
# 256 tiles
BREADTH = (("3o", "gemma3-12b", None, None),
           ("3p", "deepseek-moe-16b", "bfloat16", None),
           ("3q", "command-r-35b", "bfloat16", None),
           ("3v", "nemotron-4-340b", "bfloat16", 4))
# phase 3o's window-crossing request: a prompt longer than gemma3's
# 1024-token window, in chunks of 64, into a slot of 2048
WINDOW_PROMPT, WINDOW_MAX_LEN, WINDOW_NEW = 1536, 2048, 8
# phase 5's parity of those four: (arch, prompt length, layers (None:
# all), weights' dtype).  gemma3 at S 1100, so that its local layers'
# window binds in prefill; deepseek's dense layer 0 and 7 MoE layers;
# the bf16 configs in the dtype they are served in, at f32 compute
BREADTH_PARITY = (("gemma3-12b", 1100, None, None),
                  ("deepseek-moe-16b", 128, 8, "bfloat16"),
                  ("command-r-35b", 128, 4, "bfloat16"),
                  ("nemotron-4-340b", 128, 2, "bfloat16"))
# phase 3r: qwen1.5-0.5b at full width, 8 x 128, 10 steps with Adafactor
# through init_state / make_train_step, then 10 steps of the launcher
# with --microbatches 2; each then the repeat check
OPT_STEPS, OPT_MICROBATCHES = 10, 2
# phases 3s-3u: three more configurations trained at full width, cut in
# depth to a cut that holds every layer kind of the config (phase, arch,
# layers, optimizer, learning rate, batch, seq, steps), f32 weights, the
# config's bf16 compute, through train_over_rpc.  gemma3-12b's 6 layers
# are one period (5 local, 1 global: both RoPE bases) at 2 x 1536, so
# that the local layers' 1024-token window binds in the forward and the
# backward; deepseek-moe-16b's 4 are its dense layer 0 and 3 MoE layers
# (E 64, k 6, 2 shared experts; T 1024 at the training capacity factor
# 1.25); command-r-35b's 4 parallel blocks train with Adafactor (with
# AdamW 4 layers need 78.7 GB of params, gradients, m and v).  AdamW at
# the launcher's learning rate; Adafactor's step is about lr an element
# whatever the gradient's scale (no first moment), and at d_model 8192
# the launcher's 3e-4 overshoots (the loss 13.0 to 26.7 in 8 steps, 10.95
# at 1e-4; 8.35 at 1e-5).  Full depth waits for a mesh of cards
# (train_state_bytes reckons each row's state)
TRAIN_BREADTH = (("3s", "gemma3-12b", 6, "adamw", 3e-4, 2, 1536, 8),
                 ("3t", "deepseek-moe-16b", 4, "adamw", 3e-4, 8, 128, 8),
                 ("3u", "command-r-35b", 4, "adafactor", 1e-5, 8, 128, 8))
# phase 5's training parity of those three at full width, f32: (arch,
# layers, batch, seq).  gemma3 at S 1100, so that the local layers'
# window binds; deepseek's dense layer 0 and one MoE layer
TRAIN_BREADTH_PARITY = (("gemma3-12b", 6, 1, 1100),
                        ("deepseek-moe-16b", 2, 2, 128),
                        ("command-r-35b", 2, 2, 128))


def train_state_bytes(arch, n_layers=None, opt="adamw") -> dict:
    """The bytes a training state of ``arch`` cut to ``n_layers`` holds on
    the card, reckoned from the shapes ``Model.init(device="meta")``
    gives (nothing allocated): the parameters, their gradients (the
    parameters' shapes and dtype) and the optimizer's state (AdamW's m and
    v, Adafactor's rows, columns and v, as ``init_state`` makes them)."""
    cfg = configs.get(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    model = Model(cfg)
    params = model.init(device="meta")
    if opt == "adafactor":
        state = optim.adafactor_init(params,
                                     train_step.stack_groups(model, params))
    else:
        state = optim.adamw_init(params)
    size = (lambda tree: sum(t.numel() * t.element_size()
                             for t in optim.leaves(tree)))
    out = {"params": size(params), "grads": size(params),
           "opt": size(state)}
    out["total"] = sum(out.values())
    return out


class PhaseError(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseError(what)


def free_card() -> None:
    """Drop what the last phase left on the card (models are freed by
    their last reference going away)."""
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------
def device_ms(fn, flush, iters: int = 20, stream=None) -> float:
    """Mean device time of ``fn`` in ms: captured once in a CUDA graph
    (no host launch overhead in the window), replayed ``iters`` times,
    each replay timed by CUDA events with the L2 cache flushed first (by
    writing ``flush``, a buffer larger than the L2).  ``stream`` (default
    a new one) is where ``fn`` warms up and is captured: a backward must
    run on the stream its forward ran on."""
    side = torch.cuda.Stream() if stream is None else stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def timing_floor(flush) -> float:
    """``device_ms`` of a graph that holds one trivial launch (an
    in-place add on a one-element tensor): the least time this method
    gives any kernel, launch and events included."""
    one = torch.zeros(1, device="cuda")
    return device_ms(lambda: one.add_(1.0), flush)


def host_read_ms(fn, flush, iters: int = 5) -> float:
    """Mean time of ``fn`` in ms for a function that reads its result
    back to the host (no graph can hold that): CUDA events around one
    call each, L2 flushed first; the window includes the read-back."""
    fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def sdpa_ms(q, k, v, offsets, causal, window, prefix, flush):
    """``scaled_dot_product_attention`` on the same inputs and masks, as a
    yardstick only (the port never calls it)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if Hq != Hkv:
        kt = kt.repeat_interleave(Hq // Hkv, dim=1)
        vt = vt.repeat_interleave(Hq // Hkv, dim=1)
    mask = visible(S, T, offsets, causal, window, prefix, "cuda")[:, None]
    if bool(mask.all()):        # nothing masked: no mask (its fast paths)
        mask = None
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return device_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask), flush)


def offsets_of(q_offset, B: int):
    if isinstance(q_offset, torch.Tensor):
        off = q_offset.reshape(-1).tolist()
        return off * B if len(off) == 1 else off
    return [int(q_offset)] * B


# ---------------------------------------------------------------------------
# kernel against its plain version: attention
# ---------------------------------------------------------------------------
def check_kernel(name, q, k, v, kw, flush=None, n_split=None):
    """Attention kernel against plain on one set of inputs; with
    ``flush`` (an L2-sized buffer) also the times and the bound.  The row
    names the kernel's path (``tc``: bf16 on the tensor cores, ``simt``:
    f32 on the CUDA cores) and its key splits, ``plan``'s unless
    ``n_split`` forces them."""
    B, S, Hq, D = q.shape
    T = k.shape[1]
    path, planned = fa.plan(B, S, T, Hq, k.shape[2], D, q.dtype)

    def kernel():
        return fa._attention_cuda(q, k, v, n_split=n_split, **kw)
    got = kernel()
    torch.cuda.synchronize()
    want = fa.attention_plain(q, k, v, **kw).float()
    diff = (got.float() - want).abs()
    err = float(diff.max())
    out_max = float(want.abs().max())
    past_ulp = float((diff - ULP[q.dtype] * want.abs()).max())
    row_err = float((diff.amax(-1)
                     / want.abs().amax(-1).clamp_min(1e-3)).max())
    row = {"kernel": "flash_attention", "case": name,
           "shape": f"B{B} S{S} T{T} Hq{q.shape[2]} Hkv{k.shape[2]}",
           "dtype": str(q.dtype).replace("torch.", ""), "path": path,
           "n_split": planned if n_split is None else n_split,
           "max_abs_err": err, "past_ulp_err": past_ulp,
           "tol": TOL[q.dtype], "out_max": out_max,
           "row_rel_err": row_err, "row_tol": ROW_TOL,
           "ok": past_ulp <= TOL[q.dtype] and row_err <= ROW_TOL}
    if flush is not None:
        offsets = offsets_of(kw["q_offset"], B)
        masks = (kw.get("causal", True), kw.get("window", 0),
                 kw.get("prefix_len"))
        row["ms"] = device_ms(kernel, flush)
        row["plain_ms"] = device_ms(
            lambda: fa.attention_plain(q, k, v, **kw), flush)
        row["library_ms"] = sdpa_ms(q, k, v, offsets, *masks, flush)
        row["bound_ms"], row["bound_by"] = bound_ms(q, k, offsets, *masks)
    print("kernel-check", json.dumps(row))
    return row


def attention_case(name, B, S, T, Hq, Hkv, D, dtype, *, causal=True,
                   window=0, softcap=0.0, prefix=None, offsets=None,
                   flush=None, seed=0, n_split=None):
    """``check_kernel`` on seeded random inputs of one shape."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v = rnd(B, S, Hq, D), rnd(B, T, Hkv, D), rnd(B, T, Hkv, D)
    offsets = [0] * B if offsets is None else list(offsets)
    off = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off,
              prefix_len=prefix)
    return check_kernel(name, q, k, v, kw, flush, n_split)


def sdpa_args(q, k, v, kw):
    """(q, k, v as SDPA takes them, (B,H,S,D) with the kv heads repeated,
    the mask, is_causal): a causal mask without window or prefix goes as
    ``is_causal`` (the flash backend), any other as a boolean mask."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qt, kt, vt = (x.detach().transpose(1, 2).contiguous() for x in (q, k, v))
    if Hq != Hkv:
        kt = kt.repeat_interleave(Hq // Hkv, dim=1)
        vt = vt.repeat_interleave(Hq // Hkv, dim=1)
    causal = (kw["causal"] and not kw["window"] and kw["prefix_len"] is None
              and S == T)
    mask = None if causal else visible(
        S, T, [0] * B, kw["causal"], kw["window"], kw["prefix_len"],
        "cuda")[:, None]
    if mask is not None and bool(mask.all()):     # nothing masked
        mask = None
    return qt, kt, vt, mask, causal


def sdpa_backend(q, k, v, kw) -> str:
    """The name of the backend SDPA's dispatch picks for these inputs and
    mask (``torch._fused_sdp_choice``, the choice it makes before it
    runs); a name only, so a PyTorch without that call reads "unknown"."""
    qt, kt, vt, mask, causal = sdpa_args(q, k, v, kw)
    try:
        from torch.nn.attention import SDPBackend
        choice = int(torch._fused_sdp_choice(qt, kt, vt, mask, 0.0, causal))
    except (ImportError, AttributeError, TypeError) as e:
        return f"unknown ({type(e).__name__})"
    return next((name for name, b in SDPBackend.__members__.items()
                 if int(b) == choice), str(choice))


def sdpa_bwd_ms(q, k, v, do, kw, flush):
    """SDPA's backward alone on the same inputs and masks, as a yardstick
    only (the port never calls it): the forward runs once, outside the
    timed region, and ``device_ms`` times ``torch.autograd.grad`` of its
    output (the graph retained); masks as ``sdpa_args`` gives them.  Both
    run on one side stream, as autograd runs a backward op on its
    forward's stream."""
    qt, kt, vt, mask, causal = sdpa_args(q, k, v, kw)
    dot = do.detach().transpose(1, 2).contiguous()
    qt, kt, vt = (x.requires_grad_() for x in (qt, kt, vt))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal)
    return device_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), flush, stream=side)


def check_bwd(name, q, k, v, o, lse, do, kw, flush=None, n_split=None):
    """The backward kernels (one call: ``attn_bwd_dq_tc``,
    ``attn_bwd_dkdv_tc`` and, split, ``attn_bwd_dkdv_reduce`` in bf16;
    ``attn_bwd_pre``, ``attn_bwd_dkdv``, ``attn_bwd_dq`` in f32) against
    ``attention_bwd_plain`` on the same o and lse, and a second call
    against the first, bitwise; with ``flush`` also the times, the bound
    and SDPA's backward.  The row names the route (``bwd_plan``'s path)
    and its row splits, ``bwd_plan``'s unless ``n_split`` forces them."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    path, planned = fa.bwd_plan(B, S, T, Hq, Hkv, D, q.dtype)

    def kernel():
        return fa._attention_bwd_cuda(q, k, v, o, lse, do, n_split=n_split,
                                      **kw)
    got = kernel()
    again = kernel()
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    want = fa.attention_bwd_plain(q, k, v, o, lse, do, **kw)
    errs = [float((g.float() - w.float()).abs().max())
            for g, w in zip(got, want)]
    grad_max = [float(w.float().abs().max()) for w in want]
    differing = sum(int((g != w).sum()) for g, w in zip(got, want))
    # each gradient's largest error over its own largest |entry| (a
    # training step's are ~1e-5 at init: no absolute floor)
    scaled = max(e / m if m > 0 else (0.0 if e == 0 else math.inf)
                 for e, m in zip(errs, grad_max))
    row = {"kernel": "flash_attention_bwd", "case": name,
           "shape": f"B{B} S{S} T{T} Hq{Hq} Hkv{Hkv} D{D}",
           "dtype": str(q.dtype).replace("torch.", ""), "path": path,
           "n_split": planned if n_split is None else n_split,
           "max_abs_err": max(errs), "dq_dk_dv_err": errs,
           "dq_dk_dv_max": grad_max, "elements_differing": differing,
           "scaled_err": scaled, "tol": BWD_TOL[q.dtype],
           "bitwise_repeat": bitwise,
           "ok": scaled <= BWD_TOL[q.dtype] and bitwise}
    if flush is not None:
        row["ms"] = device_ms(kernel, flush)
        row["plain_ms"] = device_ms(
            lambda: fa.attention_bwd_plain(q, k, v, o, lse, do, **kw), flush)
        row["library_ms"] = sdpa_bwd_ms(q, k, v, do, kw, flush)
        row["library_backend"] = sdpa_backend(q, k, v, kw)
        row["bound_ms"], row["bound_by"] = attn_bwd_bound(q, k, kw)
    print("kernel-check", json.dumps(row))
    return row


def bwd_case(name, B, S, Hq, Hkv, D, causal, window, softcap, prefix,
             dtype, seed=0, flush=None, T=None, n_split=None):
    """The forward kernel's lse (unsplit, and at 2 key splits in bf16,
    where ``attn_combine`` writes it) against ``attention_fwd_plain``,
    then ``check_bwd`` on the unsplit forward's o and lse (timed with
    ``flush``; its row splits forced by ``n_split``).  ``T`` keys
    (default S: self-attention)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    T = S if T is None else T
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for shape in ((B, S, Hq, D), (B, T, Hkv, D),
                                 (B, T, Hkv, D), (B, S, Hq, D)))
    kw = dict(causal=causal, window=window, softcap=softcap,
              prefix_len=prefix)
    want_o, want_lse = fa.attention_fwd_plain(q, k, v, **kw)
    lse_err = {}
    for fwd_split in ((1, 2) if dtype == torch.bfloat16 else (1,)):
        o, lse = fa._attention_cuda(q, k, v, n_split=fwd_split,
                                    with_lse=True, **kw)
        torch.cuda.synchronize()
        lse_err[fwd_split] = float((lse - want_lse).abs().max())
        check(float((o.float() - want_o.float()).abs().max()) <= TOL[dtype],
              f"{name}: forward o at {fwd_split} splits disagrees")
        if fwd_split == 1:
            o1, lse1 = o, lse
    row = check_bwd(name, q, k, v, o1, lse1, do, kw, flush, n_split)
    row["lse_err"] = lse_err
    row["ok"] = row["ok"] and max(lse_err.values()) <= LSE_TOL
    print("kernel-check lse", name, json.dumps(lse_err))
    return row


HEADS = {ARCH: dict(Hq=16, Hkv=16, D=64),      # qwen1.5-0.5b
         MOE_ARCH: dict(Hq=24, Hkv=8, D=64)}   # granite-moe-3b-a800m
MAIN_CASES = {
    "prefill": dict(B=1, S=384, T=384),
    "chunk": dict(B=1, S=64, T=1024, offsets=[320]),
    "decode": dict(B=8, S=1, T=1024,
                   offsets=[0, 77, 191, 300, 451, 612, 850, 1023]),
    # the launcher demo's: prompts of 5-10 tokens prefilled whole (T = S,
    # one query row per block), decode over its 4 slots of 128
    "prefill-s5": dict(B=1, S=5, T=5),
    "prefill-s10": dict(B=1, S=10, T=10),
    "prefill-s16": dict(B=1, S=16, T=16),
    "decode-b4-t128": dict(B=4, S=1, T=128, offsets=[0, 41, 90, 127]),
    # the session phase's: 4 slots of 1024
    "decode-b4-t1024": dict(B=4, S=1, T=1024, offsets=[3, 400, 777, 1023]),
}


# phase 3f's (qwen1.5-0.5b, bf16): 32-token chunks at an offset into
# 512-long slots, and decode of 4 slots of 512
FABRIC_CASES = {
    "fabric-chunk-off384": dict(B=1, S=32, T=512, offsets=[384]),
    "fabric-chunk-off416": dict(B=1, S=32, T=512, offsets=[416]),
    "fabric-decode-b4-t512": dict(B=4, S=1, T=512,
                                  offsets=[384, 420, 466, 511]),
}


# recurrentgemma-9b's local attention layers: MQA, 16 q heads and one kv
# head of 256, window 2048; the long-prompt phase's 2600-token prefill
# crosses the window, the demo prefills 5-10 tokens, and the long phase
# decodes its 4 slots of 3072 at the ends of its prompts
RG_HEADS = dict(Hq=16, Hkv=1, D=256, window=2048)
RG_CASES = {
    "prefill-s2600": dict(B=1, S=2600, T=2600),
    "prefill-s5": dict(B=1, S=5, T=5),
    "prefill-s10": dict(B=1, S=10, T=10),
    "decode-b4-t3072": dict(B=4, S=1, T=3072,
                            offsets=[600, 1100, 2000, 2600]),
}


# the bf16 kernel's key splits forced to 1 and 2 beside plan's count, on
# the main paths' shapes where the grid is short of the card: granite's
# chunk (G 3: a 64-row tile ends part-way through a query's heads), qwen's
# chunk, recurrentgemma's decode of 4 slots of 3072 and its 2600-token
# prefill
SPLIT_CASES = {
    f"{MOE_ARCH}:chunk-off400": dict(HEADS[MOE_ARCH], B=1, S=64, T=1024,
                                     offsets=[400]),
    f"{ARCH}:chunk-off320": dict(HEADS[ARCH], B=1, S=64, T=1024,
                                 offsets=[320]),
    f"{HYBRID_ARCH}:decode-b4-t3072": dict(
        RG_HEADS, B=4, S=1, T=3072, offsets=[599, 1099, 1999, 2599]),
    f"{HYBRID_ARCH}:prefill-s2600": dict(RG_HEADS, B=1, S=2600, T=2600),
}


# the encoder-decoder's and the VLM's attention (phases 3k and 3l):
# seamless-m4t-large-v2's heads (16 of 64) in its encoder (non-causal
# self-attention over 512 frames, one request and training's 8) and its
# cross attention (non-causal, queries against the 512 frames' K/V:
# a short prompt, training's 8 x 128, decode of 4 slots); paligemma-3b's
# (MQA 8/1 of 256) prefix-LM prefill over 256 patches and the text (a
# 10-token prompt, training's 8 x 128)
SEAMLESS_HEADS = dict(Hq=16, Hkv=16, D=64)
PALI_HEADS = dict(Hq=8, Hkv=1, D=256)
FRONTEND_CASES = {
    f"{ENCDEC_ARCH}:encoder-b1": dict(SEAMLESS_HEADS, B=1, S=512, T=512,
                                      causal=False),
    f"{ENCDEC_ARCH}:encoder-b8": dict(SEAMLESS_HEADS, B=8, S=512, T=512,
                                      causal=False),
    f"{ENCDEC_ARCH}:cross-prefill-s10": dict(SEAMLESS_HEADS, B=1, S=10,
                                             T=512, causal=False),
    f"{ENCDEC_ARCH}:cross-b8-s128": dict(SEAMLESS_HEADS, B=8, S=128, T=512,
                                         causal=False),
    f"{ENCDEC_ARCH}:cross-decode-b4": dict(SEAMLESS_HEADS, B=4, S=1, T=512,
                                           causal=False),
    f"{VLM_ARCH}:prefix-prefill-s266": dict(PALI_HEADS, B=1, S=266, T=266,
                                            prefix=256),
    f"{VLM_ARCH}:prefix-b8-s384": dict(PALI_HEADS, B=8, S=384, T=384,
                                       prefix=256),
}
# their training backwards, bf16: (name, B, S, T, heads, causal, prefix)
FRONTEND_BWD_CASES = [
    (f"{ENCDEC_ARCH}-bwd-encoder-b8-s512", 8, 512, 512, SEAMLESS_HEADS,
     False, None),
    (f"{ENCDEC_ARCH}-bwd-cross-b8-s128-t512", 8, 128, 512, SEAMLESS_HEADS,
     False, None),
    (f"{VLM_ARCH}-bwd-prefix-b8-s384", 8, 384, 384, PALI_HEADS, True, 256),
]


def mask_tag(kw) -> str:
    """A row name's note of a mask other than plain causal: non-causal, a
    prefix or a window (gemma3's local and global layers share every
    shape, and are told apart by it)."""
    if not kw.get("causal", True):
        return " non-causal"
    if kw.get("prefix_len") is not None:
        return f" prefix {kw['prefix_len']}"
    if kw.get("window"):
        return f" window {kw['window']}"
    return ""


def assert_all_ok(rows):
    bad = [f"{r['kernel']}:{r['case']}/{r.get('dtype', '')}: "
           f"{r['max_abs_err']:.3g}" for r in rows if not r["ok"]]
    check(not bad, f"kernel disagrees with its plain version: {bad}")


# ---------------------------------------------------------------------------
# kernel against its plain version: the MoE router
# ---------------------------------------------------------------------------
def router_ties(idx, pidx, pprobs):
    """Positions where the kernel's expert differs from the plain
    version's: (token, position, kernel's expert, plain's expert, their
    two plain probabilities)."""
    out = []
    for t, j in (idx != pidx).nonzero().tolist():
        a, b = int(idx[t, j]), int(pidx[t, j])
        out.append((t, j, a, b, float(pprobs[t, a]), float(pprobs[t, b])))
    return out


def check_router(name, logits, k, n_real=None, capacity=None, e_start=0,
                 e_local=None, flush=None):
    """Routing kernel against plain on one (T, E) logits tensor, with
    ``n_real`` real experts (default E), capacity C (default T,
    dropless) and the expert range [e_start, e_start + e_local) (default
    all): indices exactly equal except ties (two probabilities
    within TIE_GAP), which are reported; w, probs, prob_sum and z_sum
    within rtol/atol (w only without ties); slots, slot tokens and loads
    exactly equal to the plain dispatch, both forms, of the kernel's own
    indices.  At n_real = E and C = T, ``router_topk`` must return the
    same (w, idx, probs): it launches the same kernel."""
    T, E = logits.shape
    n_real = E if n_real is None else n_real
    capacity = T if capacity is None else capacity
    e_local = E if e_local is None else e_local
    kw = dict(n_real=n_real, capacity=capacity)
    if e_local != E:
        kw.update(e_start=e_start, e_local=e_local)
    r = kr.router_dispatch(logits, k, **kw)
    torch.cuda.synchronize()
    p = kr.router_dispatch_plain(logits, k, **kw)
    swaps = router_ties(r.idx.cpu(), p.idx.cpu(), p.probs.cpu())
    ties = [s for s in swaps if abs(s[4] - s[5]) <= TIE_GAP]
    near = ("probs", "prob_sum", "z_sum") + (() if swaps else ("w",))
    err = max(float((getattr(r, n) - getattr(p, n)).abs().max())
              for n in near)
    close = all(bool(torch.allclose(getattr(r, n), getattr(p, n),
                                    rtol=ROUTER_RTOL, atol=ROUTER_ATOL))
                for n in near)
    exact = all(torch.equal(a, b) for form in ("sort", "cumsum")
                for a, b in zip((r.slot, r.src, r.load),
                                kr.dispatch_plain(r.idx, E, capacity, form,
                                                  e_start, e_local)))
    if n_real == E and capacity == T and e_local == E:
        exact = exact and all(torch.equal(a, b) for a, b in
                              zip(kr.router_topk(logits, k), r[:3]))
    shape = f"T{T} E{E} k{k} real{n_real} C{capacity}"
    if e_local != E:
        shape += f" experts[{e_start}:{e_start + e_local}]"
    row = {"kernel": "moe_router", "case": name, "shape": shape,
           "max_abs_err": err, "index_swaps": len(swaps), "ties": ties,
           "dropped": int((r.slot == e_local * capacity).sum()),
           "dispatch_exact": exact,
           "ok": close and exact and len(ties) == len(swaps)}
    if swaps and len(ties) != len(swaps):
        row["swaps"] = swaps
    if flush is not None:
        row["ms"] = device_ms(lambda: kr.router_dispatch(logits, k, **kw),
                              flush)
        row["plain_ms"] = device_ms(
            lambda: kr.router_dispatch_plain(logits, k, **kw), flush)
        # no one PyTorch call routes and dispatches; the top-k part alone
        # takes three (the earlier yardstick, kept beside it)
        row["library_ms"] = None

        def topk_library():
            pr = torch.softmax(logits, dim=-1)
            tw, ti = torch.topk(pr, k)
            return tw / tw.sum(-1, keepdim=True).clamp_min(1e-9), ti, pr
        row["topk_library_ms"] = device_ms(topk_library, flush)
        # logits read; probs, w, idx, slot, src, load, prob_sum and z_sum
        # written; per element a max, an exp, a sum, a divide and a
        # compare per round
        row["bound_ms"], row["bound_by"] = router_bound(T, E, k, e_local,
                                                        capacity)
    print("kernel-check", json.dumps(row))
    return row


def router_case(name, T, E, k, flush=None, seed=0, n_real=None,
                capacity=None):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return check_router(name, torch.randn((T, E), generator=gen,
                                          device="cuda"), k, n_real,
                        capacity, flush=flush)


# ---------------------------------------------------------------------------
# kernel against its plain version: SSD and RG-LRU
# ---------------------------------------------------------------------------
def _scan_row(kernel, name, shape, got, want, dtype):
    """A row for outputs ``got`` against ``want`` (pairs of tensors),
    each within SCAN_TOL of its dtype (atol and rtol)."""
    tol = SCAN_TOL[dtype]
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    ok = all(bool(torch.allclose(a.float(), b.float(), rtol=tol, atol=tol))
             for a, b in zip(got, want))
    return {"kernel": kernel, "case": name, "shape": shape,
            "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
            "tol": tol, "ok": ok}


def check_ssd(name, x, dt, A, B, C, D, h0, chunk, flush=None):
    """SSD kernels against plain (at the model's ``chunk``, the kernels
    at their own 64) on one set of inputs; with ``flush`` also the times
    and the bound.  No PyTorch call computes the SSD: library_ms null."""
    Bb, S, H, P = x.shape

    def kernel():
        return kssd.ssd(x, dt, A, B, C, D, h0, chunk=chunk)
    got = kernel()
    torch.cuda.synchronize()
    want = kssd.ssd_plain(x, dt, A, B, C, D, h0, chunk=chunk)
    row = _scan_row("ssd", name, f"B{Bb} S{S} H{H} P{P} G{B.shape[2]} "
                    f"N{B.shape[3]}" + (" D" if D is not None else "")
                    + (" h0" if h0 is not None else ""), got, want, x.dtype)
    row["chunk_len"] = kssd.CHUNK
    if flush is not None:
        row["ms"] = device_ms(kernel, flush)
        row["plain_ms"] = device_ms(lambda: kssd.ssd_plain(
            x, dt, A, B, C, D, h0, chunk=chunk), flush)
        row["library_ms"] = None
        row["bound_ms"], row["bound_by"] = ssd_bound(
            x, B, D is not None, h0 is not None)
    print("kernel-check", json.dumps(row))
    return row


def ssd_case(name, B, S, H, P, G, N, dtype, *, use_D=True, use_h0=False,
             chunk=256, flush=None, seed=0):
    """``check_ssd`` on seeded inputs drawn as tests/test_kernels.py
    draws them: dt softplus'ed, A = -exp(z/2), B and C 0.3 z, h0 0.1 z."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def z(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x, dt = z(B, S, H, P).to(dtype), torch.nn.functional.softplus(z(B, S, H))
    A = -torch.exp(z(H) * 0.5)
    Bm, Cm = (z(B, S, G, N) * 0.3).to(dtype), (z(B, S, G, N) * 0.3).to(dtype)
    D = z(H) if use_D else None
    h0 = z(B, H, P, N) * 0.1 if use_h0 else None
    return check_ssd(name, x, dt, A, Bm, Cm, D, h0, chunk, flush)


def grad_errors(got, want):
    """(largest error of any gradient over its own largest |entry|, the
    errors, the largest entries), None pairs skipped."""
    pairs = [(g, w) for g, w in zip(got, want) if w is not None]
    errs = [float((g.float() - w.float()).abs().max()) for g, w in pairs]
    tops = [float(w.float().abs().max()) for _, w in pairs]
    scaled = max(e / m if m > 0 else (0.0 if e == 0 else math.inf)
                 for e, m in zip(errs, tops))
    return scaled, errs, tops


def check_router_bwd(name, logits, probs, idx, w, dw, dprob_sum, dz_sum,
                     n_real, flush=None):
    """The router's backward kernel against ``router_bwd_plain`` on the
    same routing and upstream gradients; with ``flush`` also the times
    and the bound (no PyTorch call computes it: library_ms null)."""
    T, E = logits.shape
    k = idx.shape[1]
    args = (logits, probs, idx, w, dw, dprob_sum, dz_sum)

    def kernel():
        return kr._router_bwd_cuda(*args, n_real=n_real)
    got = kernel()
    torch.cuda.synchronize()
    want = kr.router_bwd_plain(*args, n_real=n_real)
    scaled, errs, tops = grad_errors([got], [want])
    row = {"kernel": "moe_router_bwd", "case": name,
           "shape": f"T{T} E{E} k{k} real{n_real}",
           "dtype": "float32", "max_abs_err": errs[0], "grad_max": tops[0],
           "scaled_err": scaled, "tol": GRAD_TOL[torch.float32],
           "ok": scaled <= GRAD_TOL[torch.float32]}
    again = kernel()
    row["ok"] = row["ok"] and bool(torch.equal(got, again))
    if flush is not None:
        row["ms"] = device_ms(kernel, flush)
        row["plain_ms"] = device_ms(
            lambda: kr.router_bwd_plain(*args, n_real=n_real), flush)
        row["library_ms"] = None
        row["bound_ms"], row["bound_by"] = router_bwd_bound(T, E, k)
    print("kernel-check", json.dumps(row))
    return row


def router_bwd_case(name, T, E, k, *, n_real=None, cf=1.25, flush=None,
                    seed=0):
    """The routing kernel's forward at capacity C = ceil(T k / n_real
    cf) (the training layer's), then its backward against autograd
    through ``router_dispatch_plain`` (the kernel and plain forwards must
    pick the same experts) and against ``router_bwd_plain``."""
    n_real = E if n_real is None else n_real
    C = max(int(math.ceil(T * k / n_real * cf)), 1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    logits, dw, dps = (torch.randn(shape, generator=gen, device="cuda")
                       for shape in ((T, E), (T, k), (E,)))
    dz = torch.randn((), generator=gen, device="cuda")
    r = kr.router_dispatch(logits, k, n_real=n_real, capacity=C)
    x = logits.clone().requires_grad_()
    p = kr.router_dispatch_plain(x, k, n_real=n_real, capacity=C)
    loss = (p.w * dw).sum() + (p.prob_sum * dps).sum() + p.z_sum * dz
    want, = torch.autograd.grad(loss, x)
    row = check_router_bwd(name, logits, r.probs, r.idx, r.w, dw, dps, dz,
                           n_real, flush)
    got = kr._router_bwd_cuda(logits, r.probs, r.idx, r.w, dw, dps, dz,
                              n_real=n_real)
    row["autograd_err"], _, _ = grad_errors([got], [want])
    row["dropped"] = int((r.slot == E * C).sum())
    row["same_picks"] = bool(torch.equal(r.idx, p.idx))
    row["ok"] = (row["ok"] and row["same_picks"]
                 and row["autograd_err"] <= GRAD_TOL[torch.float32])
    print("kernel-check router_bwd autograd", name, json.dumps(
        {k_: row[k_] for k_ in ("autograd_err", "dropped", "same_picks")}))
    return row


def check_ssd_bwd(name, x, dt, A, B, C, D, h0, dy, dh, states, decay,
                  flush=None, with_dh0=False):
    """The SSD's backward kernels against autograd through ``ssd_plain``
    on the same inputs and upstream gradients (dh_final None: zero),
    ``with_dh0`` h0's gradient too (h0 given); with ``flush`` also the
    times (plain: ``ssd_bwd_plain``) and the bound.  No PyTorch call
    computes it: library_ms null."""
    Bb, S, H, P = x.shape
    args = (x, dt, A, B, C, D, h0, dy, dh, states, decay)

    def kernel():
        return kssd._ssd_bwd_cuda(*args, with_dh0=with_dh0)
    got = kernel()
    torch.cuda.synchronize()
    leaves = [t.detach().clone().requires_grad_()
              for t in (x, dt, A, B, C)]
    Dg = None if D is None else D.detach().clone().requires_grad_()
    h0g = h0.detach().clone().requires_grad_() if with_dh0 else h0
    y, hf = kssd.ssd_plain(*leaves, Dg, h0g)
    loss = (y.float() * dy.float()).sum()
    if dh is not None:
        loss = loss + (hf * dh).sum()
    wrt = leaves + ([Dg] if Dg is not None else []) + (
        [h0g] if with_dh0 else [])
    want = list(torch.autograd.grad(loss, wrt))
    if Dg is None:
        want.insert(5, None)
    del y, hf, leaves, Dg, h0g, loss
    scaled, errs, tops = grad_errors(got, want)
    finite = all(bool(torch.isfinite(g).all()) for g in got
                 if g is not None)
    again = kernel()
    same = all(g is None or torch.equal(g, a) for g, a in zip(got, again))
    nc = -(-S // kssd.CHUNK)
    row = {"kernel": "ssd_bwd", "case": name,
           "shape": f"B{Bb} S{S} H{H} P{P} G{B.shape[2]} N{B.shape[3]}"
           + (" D" if D is not None else "")
           + (" h0" if h0 is not None else "")
           + (" dh" if dh is not None else ""),
           "dtype": str(x.dtype).replace("torch.", ""),
           "max_abs_err": max(errs),
           ("dx_ddt_dA_dB_dC_dD_dh0_err" if with_dh0
            else "dx_ddt_dA_dB_dC_dD_err"): errs,
           "grad_max": tops, "scaled_err": scaled, "tol": GRAD_TOL[x.dtype],
           "run_to_run_equal": same,
           "ok": finite and same and scaled <= GRAD_TOL[x.dtype]}
    plan = kssd.ssd_bwd_launch_plan(Bb, S, H, B.shape[2], B.shape[3],
                                    x.dtype)
    row["hs"] = plan["hs"]
    row["launch_plan"] = {"launches": plan["launches"], **{
        k: {"blocks_per_sm": v["blocks_per_sm"],
            "smem_bytes": v["smem_bytes"], "blocks": v["blocks"]}
        for k, v in plan["kernels"].items()}}
    del got, again, want
    if flush is not None:
        row["ms"] = device_ms(kernel, flush)
        row["plain_ms"] = device_ms(lambda: kssd.ssd_bwd_plain(
            x, dt, A, B, C, D, h0, dy, dh), flush)
        row["library_ms"] = None
        row["bound_ms"], row["bound_by"] = ssd_bwd_bound(
            x, B, D is not None, h0 is not None, dh is not None, nc)
    print("kernel-check", json.dumps(row))
    return row


def ssd_bwd_case(name, B, S, H, P, G, N, dtype, *, use_D=True,
                 use_h0=False, use_dh=False, flush=None, seed=0,
                 with_dh0=False):
    """``check_ssd_bwd`` on seeded inputs drawn as ``ssd_case`` draws
    them, dy and dh_final normal: the forward kernels keep their entering
    states and decays, the backward reads them."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def z(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x, dt = z(B, S, H, P).to(dtype), torch.nn.functional.softplus(z(B, S, H))
    A = -torch.exp(z(H) * 0.5)
    Bm, Cm = (z(B, S, G, N) * 0.3).to(dtype), (z(B, S, G, N) * 0.3).to(dtype)
    D = z(H) if use_D else None
    h0 = z(B, H, P, N) * 0.1 if use_h0 else None
    dy = z(B, S, H, P).to(dtype)
    dh = z(B, H, P, N) if use_dh else None
    _, _, states, decay = kssd._ssd_cuda(x, dt, A, Bm, Cm, D, h0, keep=True)
    return check_ssd_bwd(name, x, dt, A, Bm, Cm, D, h0, dy, dh, states,
                         decay, flush, with_dh0=with_dh0)


def check_rglru_bwd(name, x, rg, ig, ll, h0, dh, dh_final, states,
                    flush=None, h0_grad=False):
    """The RG-LRU's backward kernel against ``rglru_bwd_plain`` (f32
    arithmetic) on the same inputs, the forward's kept states and
    upstream gradients, dh0 among the gradients; dlambda's error against
    an f64 plain run too (its B·S terms summed in f32 in a fixed order);
    two runs bitwise equal.  ``h0_grad``: also every gradient, h0's
    among them, by autograd through ``rglru`` (``RGLRUFunction``: the
    forward and backward kernels) against the plain backward.  With
    ``flush`` also the times (plain: ``rglru_bwd_plain``) and the bound.
    No PyTorch call computes it: library_ms null."""
    Bb, S, W = x.shape
    args = (x, rg, ig, ll, h0, dh, dh_final)

    def kernel():
        return krg._rglru_bwd_cuda(*args, states)

    def plain():
        return krg.rglru_bwd_plain(*args)
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    f64 = krg.rglru_bwd_plain(*(None if t is None else t.double()
                                for t in args))
    scaled, errs, tops = grad_errors(got, want)
    dll_f64, _, _ = grad_errors(got[3:4], [f64[3]])
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    again = kernel()
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    row = {"kernel": "rglru_bwd", "case": name,
           "shape": f"B{Bb} S{S} W{W}" + (" h0" if h0 is not None else "")
           + (" dh" if dh_final is not None else ""),
           "dtype": str(x.dtype).replace("torch.", ""),
           "max_abs_err": max(errs), "dx_dr_di_dlambda_dh0_err": errs,
           "grad_max": tops, "scaled_err": scaled,
           "dlambda_scaled_err_vs_f64": dll_f64,
           "tol": GRAD_TOL[x.dtype], "run_to_run_equal": same,
           "ok": finite and same and scaled <= GRAD_TOL[x.dtype]}
    if h0_grad:
        leaves = [t.detach().clone().requires_grad_()
                  for t in (x, rg, ig, ll, h0)]
        h, hf = krg.rglru(*leaves)
        loss = (h.float() * dh.float()).sum()
        if dh_final is not None:
            loss = loss + (hf * dh_final).sum()
        auto = torch.autograd.grad(loss, leaves)
        row["autograd_err"], _, _ = grad_errors(auto, want)
        row["ok"] = row["ok"] and row["autograd_err"] <= GRAD_TOL[x.dtype]
        del leaves, h, hf, loss, auto
    del got, again, want, f64
    if flush is not None:
        row["ms"] = device_ms(kernel, flush)
        row["plain_ms"] = device_ms(plain, flush)
        row["library_ms"] = None
        row["bound_ms"], row["bound_by"] = rglru_bwd_bound(
            x, h0 is not None, dh_final is not None, -(-S // krg.CHUNK))
    print("kernel-check", json.dumps(row))
    return row


def rglru_bwd_case(name, B, S, W, *, use_h0=False, use_dh=False,
                   saturated=False, flush=None, seed=0,
                   dtype=torch.float32, h0_grad=False):
    """``check_rglru_bwd`` on seeded inputs drawn as ``rglru_case`` draws
    them (x, the gates and dh in ``dtype``), dh and dh_final normal; the
    forward kernels keep their entering states, the backward reads them.
    ``saturated``: Λ -4.3 and half the r_gate entries -40 (a rounds to 1,
    the clamp of 1 - a^2 binds), -12 or -10 (a^2/β in the hundreds)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def z(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x, rg, ig = z(B, S, W), z(B, S, W), z(B, S, W)
    ll = z(W)
    if saturated:
        ll = torch.full((W,), -4.3, device="cuda")
        pick = torch.randint(0, 3, (B, S, W), generator=gen, device="cuda")
        low = torch.tensor([-40.0, -12.0, -10.0], device="cuda")[pick]
        rg = torch.where(torch.rand((B, S, W), generator=gen,
                                    device="cuda") < 0.5, low, rg)
    h0 = z(B, W) * 0.2 if use_h0 else None
    dh = z(B, S, W).to(dtype)
    dh_final = z(B, W) if use_dh else None
    x, rg, ig = (t.to(dtype) for t in (x, rg, ig))
    _, _, states = krg._rglru_cuda(x, rg, ig, ll, h0, keep=True)
    return check_rglru_bwd(name, x, rg, ig, ll, h0, dh, dh_final, states,
                           flush, h0_grad=h0_grad)


def check_rglru(name, x, rg, ig, ll, h0, flush=None, chunk_len=None,
                keep=False):
    """RG-LRU kernels against plain on one set of inputs, at the kernels'
    chunk length or ``chunk_len`` forced; ``keep`` (training's forward)
    also holds the states kept for the backward against
    ``rglru_keep_plain``'s.  With ``flush`` also the times and the bound.
    No PyTorch call computes it: library_ms null."""
    Bb, S, W = x.shape

    def kernel():
        return krg._rglru_cuda(x, rg, ig, ll, h0, chunk_len=chunk_len,
                               keep=keep)

    def plain():
        return (krg.rglru_keep_plain(x, rg, ig, ll, h0) if keep
                else krg.rglru_plain(x, rg, ig, ll, h0))
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    if keep and want[2] is None:
        check(got[2] is None, f"{name}: states kept for one chunk")
        got, want = got[:2], want[:2]
    row = _scan_row("rglru", name, f"B{Bb} S{S} W{W}"
                    + (" h0" if h0 is not None else "")
                    + (" keep" if keep else ""), got, want, x.dtype)
    row["chunk_len"] = krg.CHUNK if chunk_len is None else chunk_len
    if flush is not None:
        row["ms"] = device_ms(kernel, flush)
        row["plain_ms"] = device_ms(plain, flush)
        row["library_ms"] = None
        row["bound_ms"], row["bound_by"] = rglru_bound(
            x, h0 is not None, -(-S // krg.CHUNK) if keep else 1)
    print("kernel-check", json.dumps(row))
    return row


def rglru_case(name, B, S, W, dtype, *, use_h0=False, flush=None, seed=0,
               chunk_len=None):
    """``check_rglru`` on seeded normal inputs, h0 scaled by 0.2, as
    tests/test_kernels.py draws them."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def z(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x, rg, ig = (z(B, S, W).to(dtype) for _ in range(3))
    h0 = z(B, W) * 0.2 if use_h0 else None
    return check_rglru(name, x, rg, ig, z(W), h0, flush, chunk_len)


# ---------------------------------------------------------------------------
# kernel against its plain version: Fletcher-64
# ---------------------------------------------------------------------------
def check_fletcher(name, xs, flush=None, flips=()):
    """Fletcher-64 kernel against plain on a batch of tensors, exactly;
    for each index in ``flips``, one bit flipped in the middle of that
    shard must change its checksum, to the plain version's of the
    flipped bytes, and no other shard's."""
    nbytes = sum(x.numel() * x.element_size() for x in xs)
    got = fl.fletcher64_many(xs)
    want = fl.fletcher64_many_plain(xs)
    ok = got == want
    for i in flips:
        raw = xs[i].detach().clone().reshape(-1).view(torch.uint8)
        raw[raw.numel() // 2] ^= 1 << 5
        again = fl.fletcher64_many(xs[:i] + [raw] + xs[i + 1:])
        ok = ok and again[i] != got[i] and \
            again[i] == fl.fletcher64_plain(raw) and \
            again[:i] + again[i + 1:] == got[:i] + got[i + 1:]
        del raw
    row = {"kernel": "fletcher64", "case": name,
           "shape": f"{len(xs)} shards, {nbytes} B",
           "max_abs_err": max(abs(a - b) for a, b in zip(got, want)),
           "checksums": [f"{c:016x}" for c in got[:4]], "ok": ok}
    if flush is not None:
        batch = fl.Batch(xs)        # its table copied before the capture
        row["ms"] = device_ms(batch.launch, flush)
        row["plain_ms"] = host_read_ms(lambda: fl.fletcher64_many_plain(xs),
                                       flush)
        row["library_ms"] = None
        row["bound_ms"], row["bound_by"] = fletcher_bound(xs)
        del batch
    print("kernel-check", json.dumps(row))
    return row


def fletcher_words(n, seed=0):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31, (n,), dtype=torch.int32,
                         generator=gen, device="cuda")

# ---------------------------------------------------------------------------
# kernel against its plain version: the MoE combine and its backward
# ---------------------------------------------------------------------------
def differ_share(got, want) -> float:
    """The share of the bf16 outputs' entries that differ at all (0.0 for
    f32, which COMBINE_TOL alone holds)."""
    pairs = [(g, w) for g, w in zip(got, want) if w.dtype == torch.bfloat16]
    n = sum(w.numel() for _, w in pairs)
    return sum(int((g != w).sum()) for g, w in pairs) / n if n else 0.0


def combine_library(out_buf, w, slot):
    """The one PyTorch call that computes the combine, where the call
    drops nothing: ``F.embedding_bag``'s weighted sum of each token's k
    rows (f32 sums on the card, w in the rows' dtype).  None where a
    choice is dropped: it has no empty slot to skip, and the zero row it
    would need is the copy of the whole buffer the kernel removed."""
    if combine_kept(slot, out_buf.shape[0]) < slot.numel():
        return None
    at, ws = slot.long(), w.to(out_buf.dtype)
    return lambda: F.embedding_bag(at, out_buf, per_sample_weights=ws,
                                   mode="sum")


def check_combine(name, out_buf, w, slot, flush=None):
    """The combine kernel against ``moe_combine_plain``: the largest error
    over the largest |entry| within COMBINE_TOL, in bf16 the share of
    entries that differ within COMBINE_DIFFER_SHARE, a second call
    bitwise equal; with ``flush`` the times and the bound, and where the
    call drops nothing ``F.embedding_bag``'s time (library_ms; null where
    it drops, ``library_note`` says why) and its error over the largest
    entry."""
    (n_slots, d), (T, k) = out_buf.shape, slot.shape

    def kernel():
        return kc._moe_combine_cuda(out_buf, w, slot)
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    want = kc.moe_combine_plain(out_buf, w, slot)
    scaled, errs, tops = grad_errors([got], [want])
    tol = COMBINE_TOL[out_buf.dtype]
    row = {"kernel": "moe_combine", "case": name,
           "shape": f"T{T} k{k} EC{n_slots} d{d}",
           "dtype": str(out_buf.dtype).replace("torch.", ""),
           "max_abs_err": errs[0], "y_max": tops[0], "scaled_err": scaled,
           "tol": tol, "differ_share": differ_share([got], [want]),
           "dropped": T * k - combine_kept(slot, n_slots),
           "bitwise_repeat": bool(torch.equal(got, again))}
    row["ok"] = (scaled <= tol and row["bitwise_repeat"]
                 and row["differ_share"] <= COMBINE_DIFFER_SHARE)
    if flush is not None:
        row["ms"] = device_ms(kernel, flush)
        row["plain_ms"] = device_ms(
            lambda: kc.moe_combine_plain(out_buf, w, slot), flush)
        library = combine_library(out_buf, w, slot)
        if library is None:
            row["library_ms"] = None
            row["library_note"] = ("drops: F.embedding_bag needs a zero "
                                   "row appended, a second call")
        else:
            row["library_ms"] = device_ms(library, flush)
            row["library_scaled_err"] = grad_errors([library()],
                                                    [want])[0]
        row["bound_ms"], row["bound_by"] = combine_bound(out_buf, slot)
    print("kernel-check", json.dumps(row))
    return row


def check_combine_bwd(name, dy, out_buf, logits, probs, idx, w, slot, src,
                      dprob_sum, dz_sum, n_real, flush=None):
    """The combine's backward kernel against ``moe_combine_bwd_plain``:
    d_out_buf's and dlogits' largest error over their largest |entry|
    within COMBINE_TOL (d_out_buf's dtype), in bf16 the share of
    d_out_buf's entries that differ within COMBINE_DIFFER_SHARE, a second
    call bitwise equal,
    the empty slots' rows zero; with ``flush`` the times and the bound
    (library_ms null)."""
    (n_slots, d), (T, k) = out_buf.shape, slot.shape
    E = logits.shape[1]
    args = (dy, out_buf, logits, probs, idx, w, slot, src, dprob_sum,
            dz_sum)

    def kernel():
        return kc._moe_combine_bwd_cuda(*args, n_real=n_real)
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    want = kc.moe_combine_bwd_plain(*args, n_real=n_real)
    scaled, errs, tops = grad_errors(got, want)
    tol = COMBINE_TOL[out_buf.dtype]
    row = {"kernel": "moe_combine_bwd", "case": name,
           "shape": f"T{T} k{k} EC{n_slots} d{d} E{E} real{n_real}",
           "dtype": str(out_buf.dtype).replace("torch.", ""),
           "max_abs_err": max(errs), "dout_dlogits_err": errs,
           "dout_dlogits_max": tops, "scaled_err": scaled, "tol": tol,
           "dropped": T * k - combine_kept(slot, n_slots),
           "empty_rows_zero": not bool(got[0][src == T].any()),
           "bitwise_repeat": all(torch.equal(a, b)
                                 for a, b in zip(got, again))}
    row["differ_share"] = differ_share(got, want)
    row["ok"] = (scaled <= tol and row["bitwise_repeat"]
                 and row["empty_rows_zero"]
                 and row["differ_share"] <= COMBINE_DIFFER_SHARE)
    if flush is not None:
        row["ms"] = device_ms(kernel, flush)
        row["plain_ms"] = device_ms(
            lambda: kc.moe_combine_bwd_plain(*args, n_real=n_real), flush)
        row["library_ms"] = None
        row["bound_ms"], row["bound_by"] = combine_bwd_bound(out_buf, slot, E)
    print("kernel-check", json.dumps(row))
    return row


def combine_case(name, T, E, k, d, dtype, *, n_real=None, cf=None,
                 flush=None, seed=0):
    """Phase 2's rows of the combine and its backward: routing by the
    kernel on seeded logits at capacity C = ceil(T k / n_real cf) (``cf``
    None: dropless, C = T), seeded expert outputs (E·C, d) and dy in
    ``dtype``."""
    n_real = E if n_real is None else n_real
    C = T if cf is None else max(int(math.ceil(T * k / n_real * cf)), 1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    logits = torch.randn((T, E), generator=gen, device="cuda")
    out_buf = torch.randn((E * C, d), generator=gen, device="cuda").to(dtype)
    dy = torch.randn((T, d), generator=gen, device="cuda").to(dtype)
    dps = torch.randn((E,), generator=gen, device="cuda")
    dz = torch.randn((), generator=gen, device="cuda")
    r = kr.router_dispatch(logits, k, n_real=n_real, capacity=C)
    return [check_combine(name, out_buf, r.w, r.slot, flush),
            check_combine_bwd(name, dy, out_buf, logits, r.probs, r.idx,
                              r.w, r.slot, r.src, dps, dz, n_real, flush)]


def combine_rows(flush):
    """Phase 2's combine rows at granite-moe-3b-a800m's E 40, k 8, d 1536,
    bf16 and f32: decode's 4 and a chunk's 64 tokens dropless, a 64-token
    chunk at C 13 (drops), training's 8 x 128 at C 256, 48 experts of
    which 40 are real; then rows of 90 and 66 values (no multiple of 16
    bytes: element loads).  The eager chain they replaced is timed
    beside them in an older checkout by ``tools/combine_ab.py``."""
    g = dict(E=40, k=8, d=1536)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = "" if dtype == torch.bfloat16 else "-f32"
        rows += combine_case(f"granite-T4-dropless{tag}", 4, dtype=dtype,
                             flush=flush, seed=1, **g)
        rows += combine_case(f"granite-T64-dropless{tag}", 64, dtype=dtype,
                             flush=flush, seed=2, **g)
        rows += combine_case(f"granite-T64-C13{tag}", 64, dtype=dtype,
                             cf=1.0, flush=flush, seed=3, **g)
        rows += combine_case(f"granite-T1024-C256{tag}", 1024, dtype=dtype,
                             cf=1.25, flush=flush, seed=4, **g)
        rows += combine_case(f"granite-T64-E48-real40{tag}", 64, E=48, k=8,
                             d=1536, n_real=40, cf=1.25, dtype=dtype,
                             flush=flush, seed=5)
        for d in (90, 66):
            rows += combine_case(f"d{d}-T64-C16{tag}", 64, E=40, k=8, d=d,
                                 cf=1.25, dtype=dtype, seed=6)
    check(any(r["dropped"] for r in rows), "moe_combine: no case dropped")
    return rows


# ---------------------------------------------------------------------------
# the LM head's cross entropy
# ---------------------------------------------------------------------------
# the outputs' largest error over their largest |entry|: lse, nll and lse²
# (f32 on both sides; the kernel's exps are ex2.approx's, the plain
# version's expf's) and the gradient (the logits' dtype; f32 as the sums)
CE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
CE_ROWS_TOL = 1e-5
QWEN_VOCAB, QWEN_CE_ROWS = 151936, 8 * 512    # the cell's chunk: B 8, c 512
RG_VOCAB, RG_CE_ROWS, RG_SOFTCAP = 256000, 8 * 128, 30.0


def ce_inputs(R, V, dtype, seed):
    """Seeded logits (R, V) in ``dtype`` (scale 4), targets (every 7th row
    ignored, -1; columns 0 and V - 1 among the rest) and the count of the
    targets, as the loss gives the kernel."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = (torch.randn((R, V), generator=gen, device="cuda") * 4).to(dtype)
    t = torch.randint(0, V, (R,), generator=gen, device="cuda")
    t[::7] = -1
    t[1], t[2] = 0, V - 1
    return x, t, (t != -1).sum().clamp_min(1)


def check_cross_entropy(name, x, t, n, *, softcap=0.0, z_coef=1e-4,
                        ignore_id=-1, grad=True, flush=None):
    """``cross_entropy`` on the card against ``cross_entropy_plain`` on
    logits ``x`` (R, V), targets ``t`` and token count ``n``: lse, nll and
    lse² within CE_ROWS_TOL of their largest entry, the gradient written
    over the logits, compared in their dtype, within CE_TOL and, in bf16,
    the share of entries that differ within COMBINE_DIFFER_SHARE; ignored
    rows' gradient zero; a second call bitwise equal; with ``flush`` the
    times (the kernel's in place over its own output) and the bound."""
    R, V = x.shape
    dtype = x.dtype
    kw = dict(softcap=softcap, z_coef=z_coef, ignore_id=ignore_id, grad=grad)

    def kernel(buf):
        return kce.cross_entropy(buf, t, n, **kw)
    before = kce.cross_entropy.launches
    got_x, again_x, want_x = x.clone(), x.clone(), x.clone()
    got, again = kernel(got_x), kernel(again_x)
    torch.cuda.synchronize()
    launches = kce.cross_entropy.launches - before
    want = kce.cross_entropy_plain(want_x, t, n, **kw)
    scaled, errs, tops = grad_errors(got, want)
    row = {"kernel": "cross_entropy", "case": name,
           "shape": f"R{R} V{V} softcap{softcap:g} "
                    f"{'grad' if grad else 'lse'}",
           "dtype": str(dtype).replace("torch.", ""),
           "rows_err": errs, "rows_max": tops, "rows_scaled_err": scaled,
           "rows_tol": CE_ROWS_TOL, "launches": launches,
           "bitwise_repeat": bool(torch.equal(got_x, again_x) and all(
               torch.equal(a, b) for a, b in zip(got, again)))}
    ok = scaled <= CE_ROWS_TOL and row["bitwise_repeat"] and launches == 2
    row["max_abs_err"] = max(errs)
    if grad:
        g_scaled, g_err, g_top = grad_errors([got_x], [want_x])
        row["max_abs_err"] = max(errs + g_err)
        row.update(grad_scaled_err=g_scaled, grad_max=g_top[0],
                   grad_tol=CE_TOL[dtype],
                   differ_share=differ_share([got_x], [want_x]),
                   ignored_zero=not bool(got_x[t == ignore_id].any()))
        ok = (ok and g_scaled <= CE_TOL[dtype] and row["ignored_zero"]
              and row["differ_share"] <= COMBINE_DIFFER_SHARE)
    else:
        ok = ok and torch.equal(got_x, x)
    row["ok"] = ok
    del got_x, again_x, want_x
    if flush is not None:
        buf = x.clone()
        row["ms"] = device_ms(lambda: kernel(buf), flush)
        row["plain_ms"] = device_ms(
            lambda: kce.cross_entropy_plain(buf, t, n, **kw), flush)
        row["library_ms"] = None
        row["bound_ms"], row["bound_by"] = cross_entropy_bound(
            R, V, dtype, grad, softcap > 0.0)
        del buf
    free_card()
    print("kernel-check", json.dumps(row))
    return row


def cross_entropy_rows(flush):
    """Phase 2's cross entropy rows: the benchmark cell's chunk (qwen1.5-
    0.5b, R 4096 x V 151,936, bf16) with and without the gradient,
    recurrentgemma-9b's training chunk at softcap 30 (R 1024 x V 256,000),
    timed; then rows of V 37, 1001 and 32,000 (no multiple of 8, or small)
    in bf16 and f32, and the cell's chunk in f32."""
    rows = []
    for grad in (True, False):
        tag = "" if grad else "-lse"
        rows.append(check_cross_entropy(
            f"{ARCH}-chunk{tag}", *ce_inputs(QWEN_CE_ROWS, QWEN_VOCAB,
                                             torch.bfloat16, seed=1),
            grad=grad, flush=flush))
        rows.append(check_cross_entropy(
            f"{HYBRID_ARCH}-chunk{tag}", *ce_inputs(RG_CE_ROWS, RG_VOCAB,
                                                    torch.bfloat16, seed=2),
            softcap=RG_SOFTCAP, grad=grad, flush=flush))
    for dtype in (torch.bfloat16, torch.float32):
        tag = "" if dtype == torch.bfloat16 else "-f32"
        for i, (R, V) in enumerate(((5, 37), (64, 1001), (300, 32000))):
            for cap in (0.0, RG_SOFTCAP):
                rows.append(check_cross_entropy(
                    f"V{V}-cap{cap:g}{tag}",
                    *ce_inputs(R, V, dtype, seed=10 + i), softcap=cap))
    rows.append(check_cross_entropy(
        f"{ARCH}-chunk-f32", *ce_inputs(QWEN_CE_ROWS, QWEN_VOCAB,
                                        torch.float32, seed=3)))
    return rows


def chain_ce_loss(cfg, table, h, targets, chunk, z_coef):
    """The head's loss as the port computed it before the kernel: each
    chunk's (B, c, V) f32 logits (``.float()`` of the bf16 product),
    ``logsumexp`` and a ``gather``, under ``checkpoint``.  The yardstick
    of ``loss_head_path``."""
    from torch.utils.checkpoint import checkpoint
    cdt = dtype_of(cfg.compute_dtype)

    def body(hc, tc):
        logits = (hc.to(cdt) @ table.T.to(cdt)).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, tc.clamp_min(0).long()[..., None])[..., 0]
        valid = tc != -1
        return (torch.where(valid, lse - tgt, 0.0).sum(),
                torch.where(valid, lse * lse, 0.0).sum())
    loss_sum = z_sum = 0.0
    for i in range(0, h.shape[1], chunk):
        nll, zl = checkpoint(body, h[:, i:i + chunk], targets[:, i:i + chunk],
                             use_reentrant=False)
        loss_sum, z_sum = loss_sum + nll, z_sum + zl
    n = (targets != -1).sum().clamp_min(1)
    return loss_sum / n + z_coef * (z_sum / n)


class HeadOps(TorchDispatchMode):
    """Every op's outputs under it, for phase 3w: the matrix products that
    read or write a V-wide operand, the f32 tensors with V-wide rows, and
    the names of the ops seen."""

    def __init__(self, V):
        super().__init__()
        self.V, self.products, self.f32_wide, self.ops = V, 0, [], set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.add(str(func))
        out = func(*args, **(kwargs or {}))
        outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,))
                if isinstance(o, torch.Tensor)]
        ins = [a for a in args if isinstance(a, torch.Tensor)]
        if func in (torch.ops.aten.mm.default, torch.ops.aten.mm.out,
                    torch.ops.aten.bmm.default, torch.ops.aten.matmul.default,
                    torch.ops.aten.addmm.default) and any(
                        self.V in t.shape for t in ins + outs):
            self.products += 1
        self.f32_wide += [(str(func), tuple(o.shape)) for o in outs
                          if o.dtype == torch.float32 and o.ndim >= 2
                          and o.shape[-1] == self.V and o.numel() > self.V]
        return out


CELL_TRAIN = dict(batch=8, seq=4096, steps=2)   # the benchmark cell's step


def cell_step_path() -> TrainRecorder:
    """Phase 3w, first: the benchmark cell's training step on the card,
    full-width qwen1.5-0.5b at B 8 x S 4096, AdamW, remat "none", through
    ``make_train_step``, ``CELL_TRAIN["steps"]`` steps under a
    ``TrainRecorder`` with the launch counts set to 0 first: every
    kernel's launches a step (``check_train_launches``: the cross entropy
    once a chunk of 512, 8), and under ``HeadOps`` the last step forms 3
    head products a chunk (24: logits, dh, dW; the checkpointed chain
    formed 4), no f32 tensor with V-wide rows, backward included.
    Returns the recorder with its cross entropy launches alone, for phase
    4: attention's rows at this shape would hold the plain version's
    (8, 16, 4096, 4096) f32 scores, and phase 3g checks it on the same
    path at 8 x 128 and 4 x 1024."""
    cfg = configs.get(ARCH)
    model = Model(cfg)
    B, S, steps = CELL_TRAIN["batch"], CELL_TRAIN["seq"], CELL_TRAIN["steps"]
    recorder = TrainRecorder()
    ops = HeadOps(cfg.vocab)
    ocfg = optim.OptConfig(warmup=5, decay_steps=TRAIN_STEPS)
    state = train_step.init_state(model, ocfg, 0, device="cuda")
    step = train_step.make_train_step(model, ocfg,
                                      ParallelConfig(remat="none"))
    source = SyntheticSource(cfg.vocab, S, B)
    recorder.install()
    for fn in TRAIN_COUNTED:
        fn.launches = 0
    try:
        losses = []
        for i in range(steps):
            batch = train_batch(source, i)
            with ops if i == steps - 1 else contextlib.nullcontext():
                state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
    finally:
        recorder.uninstall()
    tag = f"{ARCH} cell train {B}x{S}"
    print(f"{tag}: losses {losses}; head products in a step "
          f"{ops.products}, f32 V-wide tensors {ops.f32_wide[:4]}; "
          f"cross_entropy launches {kce.cross_entropy.launches} in "
          f"{steps} steps")
    check(all(map(math.isfinite, losses)), f"{tag}: losses {losses}")
    per_step = check_train_launches(tag, model, recorder, steps, "none")
    n_chunks = S // CE_CHUNK
    check(per_step[-1] == n_chunks, f"{tag}: {per_step[-1]} cross_entropy "
          f"launches a step, expected {n_chunks}")
    # the MLP's SiLU backward: the mode saw autograd's backward too
    check("aten.silu_backward.default" in ops.ops,
          f"{tag}: HeadOps saw no backward op")
    check(ops.products == 3 * n_chunks, f"{tag}: {ops.products} head "
          f"products a step, expected {3 * n_chunks}")
    check(not ops.f32_wide, f"{tag}: f32 V-wide tensors {ops.f32_wide[:4]}")
    del state, step, batch
    free_card()
    recorder.seen = {k: rec for k, rec in recorder.seen.items()
                     if k[0] == "cross_entropy"}
    return recorder


def loss_head_path() -> None:
    """Phase 3w, then: the benchmark cell's loss head on the card,
    qwen1.5-0.5b's tied 151,936 x 1024 table (f32) and B 8 x S 4096 bf16
    final states, chunks of 512, z-loss 1e-4, some targets ignored.
    Through ``chunked_ce_loss`` (``HeadLossFunction``) against
    ``chain_ce_loss`` by autograd: the loss within 1e-5, dh and d(table)
    within 2e-2 of their largest entry; then both timed, forward and
    backward (CUDA events, the mean of 5 after a warm-up), with the peak
    memory each adds.  Prints its row."""
    cfg = configs.get(ARCH)
    B, S, c, z = CELL_TRAIN["batch"], CELL_TRAIN["seq"], CE_CHUNK, 1e-4
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    table = (torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                         device="cuda") / math.sqrt(cfg.d_model))
    table.requires_grad_()
    h = torch.randn((B, S, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16).requires_grad_()
    targets = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                            device="cuda")
    targets[:, ::11] = -1

    def kernel_path():
        loss, met = model_common.chunked_ce_loss(
            cfg, {"embedding": table}, h, targets, chunk=c, z_coef=z)
        return (loss,) + torch.autograd.grad(loss, (h, table))

    def chain_path():
        loss = chain_ce_loss(cfg, table, h, targets, c, z)
        return (loss,) + torch.autograd.grad(loss, (h, table))

    got = kernel_path()
    want = chain_path()
    torch.cuda.synchronize()
    loss, chain = float(got[0].detach()), float(want[0].detach())
    loss_err = abs(loss - chain) / abs(chain)
    scaled, errs, tops = grad_errors(got[1:], want[1:])
    row = {"phase": "3w", "case": f"{ARCH} loss head B{B} S{S} c{c}",
           "loss": loss, "chain_loss": chain, "loss_rel_err": loss_err,
           "dh_dtable_err": errs, "dh_dtable_max": tops,
           "grad_scaled_err": scaled}
    del got, want
    ms = {}
    for tag, fn in (("kernel", kernel_path), ("chain", chain_path),
                    ("kernel2", kernel_path), ("chain2", chain_path)):
        fn()
        free_card()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            out = fn()
        end.record()
        end.synchronize()
        del out
        ms[tag] = start.elapsed_time(end) / 5
        row[f"{tag}_peak_add_gb"] = (torch.cuda.max_memory_allocated()
                                     - base) / 1e9
    row.update({f"{k}_ms": v for k, v in ms.items()})
    print("loss-head", json.dumps(row))
    check(loss_err <= 1e-5 and scaled <= 2e-2,
          f"3w: against the chain: loss {loss_err}, grads {scaled}")
    free_card()


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------
def backward_rows(flush):
    """Phase 2's rows of the router's, the SSD's and the RG-LRU's
    backwards, and of attention's at recurrentgemma-9b's heads."""
    rows = []
    mamba = dict(H=64, P=64, G=1, N=128)
    # the router's backward at granite's E 40, k 8 and training's
    # capacity factor 1.25 (drops): T 4, 64 and 1024 (8 x 128), and 48
    # experts of which 40 are real
    for T in (4, 64, 1024):
        rows.append(router_bwd_case(f"granite-T{T}-cf1.25", T, 40, 8,
                                    flush=flush, seed=T))
    rows.append(router_bwd_case("granite-T64-E48-real40", 64, 48, 8,
                                n_real=40, seed=5))
    check(any(r["dropped"] for r in rows[-4:]), "router_bwd: no case "
          "dropped")
    # the MoE combine and its backward (the router's backward on the MoE
    # layer's training path)
    rows += combine_rows(flush)
    # the SSD's backward at mamba2-1.3b's heads: training's 8 x 128, 2 x
    # 1024, one ragged chunk, and 8 groups; f32 and bf16
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(ssd_bwd_case(f"{SSM_ARCH}-b8-s128", B=8, S=128,
                                 dtype=dtype, flush=flush, **mamba))
        rows.append(ssd_bwd_case(f"{SSM_ARCH}-b2-s1024-dh", B=2, S=1024,
                                 dtype=dtype, use_dh=True, flush=flush,
                                 seed=1, **mamba))
        rows.append(ssd_bwd_case(f"{SSM_ARCH}-b1-s100-h0-dh", B=1, S=100,
                                 dtype=dtype, use_h0=True, use_dh=True,
                                 seed=2, **mamba))
        rows.append(ssd_bwd_case("g8-b2-s256", B=2, S=256, H=64, P=64, G=8,
                                 N=128, dtype=dtype, use_dh=True, seed=3))
        # N no multiple of 4: half 0's rows are not 16-byte aligned
        rows.append(ssd_bwd_case("n90-b1-s200-h0-dh", B=1, S=200, H=8, P=64,
                                 G=1, N=90, dtype=dtype, use_h0=True,
                                 use_dh=True, seed=4))
    # the RG-LRU's backward at recurrentgemma-9b's width, f32 (the
    # model's recurrence runs in f32): training's 8 x 128, 2 x 1024 with
    # dh_final, a ragged S 100 with h0 and dh_final, S 1 (one chunk),
    # saturated gates; then bf16 at 8 x 128 and an h0 that needs a
    # gradient
    W = 4096
    rows.append(rglru_bwd_case(f"{HYBRID_ARCH}-b8-s128", 8, 128, W,
                               flush=flush))
    rows.append(rglru_bwd_case(f"{HYBRID_ARCH}-b2-s1024-dh", 2, 1024, W,
                               use_dh=True, flush=flush, seed=1))
    rows.append(rglru_bwd_case(f"{HYBRID_ARCH}-b1-s100-h0-dh", 1, 100, W,
                               use_h0=True, use_dh=True, flush=flush,
                               seed=2))
    rows.append(rglru_bwd_case(f"{HYBRID_ARCH}-b4-s1", 4, 1, W, flush=flush,
                               seed=3))
    rows.append(rglru_bwd_case(f"{HYBRID_ARCH}-b2-s128-saturated-dh", 2,
                               128, W, use_dh=True, saturated=True,
                               flush=flush, seed=4))
    rows.append(rglru_bwd_case(f"{HYBRID_ARCH}-b8-s128-bf16", 8, 128, W,
                               dtype=torch.bfloat16, flush=flush, seed=5))
    rows.append(rglru_bwd_case(f"{HYBRID_ARCH}-b2-s256-h0grad-dh", 2, 256,
                               W, use_h0=True, use_dh=True, h0_grad=True,
                               flush=flush, seed=6))
    # the SSD's backward with h0's gradient: the walk's one more step,
    # through chunk 0 (S 40: one chunk, the walk alone)
    for S in (100, 40):
        rows.append(ssd_bwd_case(f"{SSM_ARCH}-b1-s{S}-h0grad-dh", B=1, S=S,
                                 dtype=torch.float32, use_h0=True,
                                 use_dh=True, with_dh0=True, seed=7,
                                 **mamba))
    # the attention backward at recurrentgemma-9b's heads (MQA 16/1 of
    # 256, window 2048), bf16: training's 8 x 128, and 1 x 4096, where
    # the window binds
    for B, S in ((8, 128), (1, 4096)):
        rows.append(bwd_case(f"{HYBRID_ARCH}-bwd-b{B}-s{S}", B, S,
                             RG_HEADS["Hq"], RG_HEADS["Hkv"], RG_HEADS["D"],
                             True, RG_HEADS["window"], 0.0, None,
                             torch.bfloat16, seed=B, flush=flush))
    # at the training shapes of phases 3k and 3l, bf16: seamless's encoder
    # and cross attention, paligemma's prefix-LM at MQA 8/1 of 256
    for i, (name, B, S, T, heads, causal, prefix) in enumerate(
            FRONTEND_BWD_CASES):
        rows.append(bwd_case(name, B, S, heads["Hq"], heads["Hkv"],
                             heads["D"], causal, 0, 0.0, prefix,
                             torch.bfloat16, seed=10 + i, flush=flush, T=T))
    # the MQA training shapes with the tensor-core dK/dV's rows forced
    # into 1, 2 and 4 splits (bwd_plan's count is timed above)
    for n_split in (1, 2, 4):
        rows.append(bwd_case(f"{HYBRID_ARCH}-bwd-b8-s128-split{n_split}", 8,
                             128, RG_HEADS["Hq"], RG_HEADS["Hkv"],
                             RG_HEADS["D"], True, RG_HEADS["window"], 0.0,
                             None, torch.bfloat16, seed=20,
                             n_split=n_split))
        rows.append(bwd_case(f"{VLM_ARCH}-bwd-prefix-b8-s384-split{n_split}",
                             8, 384, PALI_HEADS["Hq"], PALI_HEADS["Hkv"],
                             PALI_HEADS["D"], True, 0, 0.0, 256,
                             torch.bfloat16, seed=21, n_split=n_split))
    return rows


def head_dim_192_cases() -> list:
    """nemotron-4-340b's head dim 192, which the kernels have no tile for
    and run zero-padded to 256 (the dry run's nemotron cells lean on
    it): the forward, its lse and the backward against the plain
    versions, bf16 and f32, at its 6 / 2 reduced heads."""
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(attention_case("nemotron-hd192", B=2, S=256, T=256,
                                   Hq=6, Hkv=2, D=192, dtype=dtype))
        rows.append(bwd_case("nemotron-hd192-bwd", 2, 160, 6, 2, 192, True,
                             0, 0.0, None, dtype=dtype))
    return rows


# the sequence-parallel decode partial at phase 3n's shapes (qwen, a
# rank's 2 rows, every head against its 512 of 1024 keys): the query's
# offset in the rank's block before it (no key visible: lse -1e30, o 0),
# part-way into it, at its start and past its end
SP_PARTIAL = dict(B=2, T=512, Hq=16, Hkv=16, D=64)
SP_PARTIAL_OFFSETS = ([-1, -512], [-3, 200], [0, 511], [37, 600])


def sp_partial_cases() -> list:
    """``attention_fwd``'s o and lse, as ``sp_decode_attention``'s partial
    calls it (causal at the query's offset in the rank's block of keys),
    against ``attention_fwd_plain``: bf16 unsplit and at 4 key splits,
    f32; a row that sees no key must give lse -1e30 and o 0."""
    B, T, Hq, Hkv, D = (SP_PARTIAL[k] for k in ("B", "T", "Hq", "Hkv", "D"))
    rows = []
    for dtype, splits in ((torch.bfloat16, (1, 4)), (torch.float32, (1,))):
        for i, offsets in enumerate(SP_PARTIAL_OFFSETS):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(i)
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for shape in
                       ((B, 1, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D)))
            off = torch.tensor(offsets, dtype=torch.int32, device="cuda")
            kw = dict(causal=True, window=0, softcap=0.0, prefix_len=None,
                      q_offset=off)
            want_o, want_lse = fa.attention_fwd_plain(q, k, v, **kw)
            for n_split in splits:
                o, lse = fa._attention_cuda(q, k, v, n_split=n_split,
                                            with_lse=True, **kw)
                torch.cuda.synchronize()
                o_err = float((o.float() - want_o.float()).abs().max())
                lse_err = float((lse - want_lse).abs().max())
                blind = [j for j, t in enumerate(offsets) if t < 0]
                empty_ok = all(bool((lse[j] == fa.NEG_INF).all())
                               and not bool(o[j].any()) for j in blind)
                row = {"kernel": "flash_attention",
                       "case": f"sp-partial-off{offsets}",
                       "shape": f"B{B} S1 T{T} Hq{Hq} Hkv{Hkv}",
                       "dtype": str(dtype).replace("torch.", ""),
                       "n_split": n_split, "max_abs_err": o_err,
                       "lse_err": lse_err, "tol": TOL[dtype],
                       "lse_tol": LSE_TOL, "empty_rows": blind,
                       "empty_rows_ok": empty_ok,
                       "ok": (o_err <= TOL[dtype] and lse_err <= LSE_TOL
                              and empty_ok)}
                print("kernel-check", json.dumps(row))
                rows.append(row)
    return rows


def phase_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("f32 cases run with TF32 off (cuda.matmul and cudnn)")
    rows = []
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    print(f"timing floor: device_ms of a one-element add "
          f"{timing_floor(flush)} ms")
    for arch, heads in HEADS.items():
        for name, shape in MAIN_CASES.items():
            for dtype in (torch.bfloat16, torch.float32):
                rows.append(attention_case(f"{arch}:{name}", dtype=dtype,
                                           flush=flush, **heads, **shape))
    for name, shape in FABRIC_CASES.items():
        rows.append(attention_case(f"{ARCH}:{name}", dtype=torch.bfloat16,
                                   flush=flush, **HEADS[ARCH], **shape))
    for name, shape in RG_CASES.items():
        for dtype in (torch.bfloat16, torch.float32):
            rows.append(attention_case(f"{HYBRID_ARCH}:{name}", dtype=dtype,
                                       flush=flush, **RG_HEADS, **shape))
    for name, shape in SPLIT_CASES.items():
        for n_split in (1, 2, None):
            rows.append(attention_case(
                f"{name}-split{n_split or 'planned'}", dtype=torch.bfloat16,
                n_split=n_split, seed=3, **shape))
    for name, shape in FRONTEND_CASES.items():
        for dtype in (torch.bfloat16, torch.float32):
            rows.append(attention_case(name, dtype=dtype, flush=flush,
                                       **shape))
    rows += head_dim_192_cases()
    rows += sp_partial_cases()
    for i, case in enumerate(ATTN_SWEEP):
        S, T, Hq, Hkv, D, causal, window, softcap, prefix, _ = case
        Sc = min(24, S // 2)
        kw = dict(Hq=Hq, Hkv=Hkv, D=D, causal=causal, window=window,
                  softcap=softcap, prefix=prefix)
        for dtype in (torch.bfloat16, torch.float32):
            rows.append(attention_case(f"sweep{i}", B=2, S=S, T=T,
                                       dtype=dtype, **kw))
            rows.append(attention_case(
                f"sweep{i}-chunk", B=2, S=Sc, T=T, dtype=dtype,
                offsets=[(T - Sc) // 2] * 2, **kw))
            rows.append(attention_case(
                f"sweep{i}-decode", B=3, S=1, T=T, dtype=dtype,
                offsets=[0, T // 2, T - 1], **kw))

    # the attention backward (and the forward's row lse), the CPU tests'
    # cases at 160 tokens (ragged tiles), in bf16 and f32
    for i, case in enumerate(BWD_SWEEP):
        for dtype in (torch.bfloat16, torch.float32):
            rows.append(bwd_case(f"bwd-sweep{i}", 2, 160, *case,
                                 dtype=dtype, seed=i))

    # SSD at mamba2-1.3b's heads: the demo's prompts (one chunk, one
    # launch), one reference chunk, many chunks with a ragged tail at B 2,
    # and the long phase's longest prompt, timed; then the reference's
    # sweep
    mamba = dict(H=64, P=64, G=1, N=128)
    for dtype in (torch.float32, torch.bfloat16):
        for S in range(5, 11):
            rows.append(ssd_case(f"{SSM_ARCH}-s{S}", B=1, S=S, dtype=dtype,
                                 use_h0=S % 2 == 0, seed=S, **mamba))
        rows.append(ssd_case(f"{SSM_ARCH}-s256-h0", B=2, S=256, dtype=dtype,
                             use_h0=True, **mamba))
        rows.append(ssd_case(f"{SSM_ARCH}-b2-s1000-h0", B=2, S=1000,
                             dtype=dtype, use_h0=True, seed=2, **mamba))
        rows.append(ssd_case(f"{SSM_ARCH}-s2600-noD", B=1, S=2600,
                             dtype=dtype, use_D=False, seed=1, **mamba))
        rows.append(ssd_case(f"{SSM_ARCH}-s2600", B=1, S=2600, dtype=dtype,
                             flush=flush, **mamba))
        for i, (B, S, H, P, G, N, Q, use_D, use_h0) in enumerate(SSD_SWEEP):
            rows.append(ssd_case(f"ssd-sweep{i}", B=B, S=S, H=H, P=P, G=G,
                                 N=N, dtype=dtype, use_D=use_D,
                                 use_h0=use_h0, chunk=Q, seed=i))
    # RG-LRU at recurrentgemma-9b's width, the same way
    for dtype in (torch.float32, torch.bfloat16):
        for S in range(5, 11):
            rows.append(rglru_case(f"{HYBRID_ARCH}-s{S}", B=1, S=S, W=4096,
                                   dtype=dtype, use_h0=S % 2 == 0, seed=S))
        rows.append(rglru_case(f"{HYBRID_ARCH}-s2600-h0", B=2, S=2600,
                               W=4096, dtype=dtype, use_h0=True, seed=1))
        rows.append(rglru_case(f"{HYBRID_ARCH}-b3-s2600-h0", B=3, S=2600,
                               W=4096, dtype=dtype, use_h0=True, seed=3))
        rows.append(rglru_case(f"{HYBRID_ARCH}-s2600", B=1, S=2600, W=4096,
                               dtype=dtype, flush=flush))
        for i, (B, S, W, _, _, use_h0) in enumerate(RGLRU_SWEEP):
            rows.append(rglru_case(f"rglru-sweep{i}", B=B, S=S, W=W,
                                   dtype=dtype, use_h0=use_h0, seed=i))
    for L in (32, 64, 128):
        rows.append(rglru_case(f"{HYBRID_ARCH}-b3-s2600-h0-l{L}", B=3,
                               S=2600, W=4096, dtype=torch.float32,
                               use_h0=True, seed=3, chunk_len=L))

    # the router at granite's E 40, k 8, dropless (decode 4 slots, the
    # demo's short prompts, a 64-token chunk, a 384-token and a 2600-token
    # prefill); capacities that drop (granite's T·k/E is 12.8 at T 64) and
    # padded experts; then the grid through router_topk
    for T in (4, 64, 384, 2600):
        rows.append(router_case(f"granite-T{T}", T, 40, 8, flush=flush))
    for T in range(5, 11):
        rows.append(router_case(f"granite-T{T}", T, 40, 8, seed=T))
    rows.append(router_case("granite-T64-C6", 64, 40, 8, seed=2, capacity=6))
    rows.append(router_case("granite-T64-E48-real40-C13", 64, 48, 8, seed=3,
                            n_real=40, capacity=13))
    rows.append(router_case("deepseek-T300-E64-real60-C15", 300, 64, 6,
                            seed=4, n_real=60, capacity=15))
    check(any(r["dropped"] for r in rows[-3:]), "router: no case dropped")
    for (T, E), k in ROUTER_GRID:
        rows.append(router_case(f"grid-T{T}-E{E}-k{k}", T, E, k, seed=1))
    rows += backward_rows(flush)
    rows += cross_entropy_rows(flush)

    # Fletcher-64: the CPU test's lengths, odd byte counts (a view at an
    # odd offset too), and qwen1.5-0.5b's embedding shard
    rng = np.random.default_rng(0)
    for n in (0, 1, 2047, 2048, 2049, int(rng.integers(1, 50_000))):
        rows.append(check_fletcher(f"words-{n}", [fletcher_words(n, seed=n)],
                                   flips=(0,) if n else ()))
    raw = fletcher_words(1100, seed=9).view(torch.uint8)
    for nbytes in (1, 2, 3, 5, 6, 7, 1001, 4099):
        rows.append(check_fletcher(f"bytes-{nbytes}", [raw[:nbytes]],
                                   flips=(0,)))
        rows.append(check_fletcher(f"bytes-{nbytes}-offset1",
                                   [raw[1:nbytes + 1]], flips=(0,)))
    # a mixed batch in one launch: a 4 KB norm, 1-3 bytes, a view at
    # offset 1, qwen's 4 MB and 11.5 MB shards, an empty one
    mixed = [fletcher_words(1024, seed=11), raw[:1], raw[:2], raw[:3],
             raw[1:4100], fletcher_words(1 << 20, seed=12),
             fletcher_words(1024 * 2816, seed=13), raw[:0]]
    rows.append(check_fletcher("mixed-batch", mixed, flush=flush,
                               flips=(0, 2, 4, 6)))
    rows.append(check_fletcher("qwen-embedding",
                               [fletcher_words(QWEN_EMBED_WORDS, seed=3)],
                               flush=flush, flips=(0,)))
    del flush
    free_card()
    assert_all_ok(rows)
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main paths
# ---------------------------------------------------------------------------
class MainPathRecorder:
    """What a main path gives the kernels.  Wraps the Model entry points
    (to know which of prefill, chunk or decode is running, and to count
    their calls), the attention the layers call, the router the MoE
    layers call and the SSD and RG-LRU the recurrent blocks call; for
    each (kernel, entry point, shape) keeps the launches the kernel's
    wrapper counted (the wrapper alone counts) and a copy of the inputs
    of the last launch.  A model that cannot chunk its prefill has no
    chunk entry point.  ``timed`` also keeps each entry point's seconds
    on the card (synchronised on both sides of each call)."""

    ENTRIES = {"prefill": "prefill", "prefill_chunk": "chunk",
               "decode_step": "decode"}

    def __init__(self, chunkable: bool = True, timed: bool = False):
        self.entries = {e: k for e, k in self.ENTRIES.items()
                        if chunkable or k != "chunk"}
        self.kind = "outside an entry point"
        self.seen = {}
        self.calls = {kind: 0 for kind in self.ENTRIES.values()}
        self.seconds = {kind: 0.0 for kind in self.ENTRIES.values()}
        self.timed = timed
        self._orig = {}

    def install(self):
        for entry, kind in self.ENTRIES.items():
            orig = self._orig[entry] = getattr(Model, entry)

            def entered(*a, _orig=orig, _kind=kind, **kw):
                outer, self.kind = self.kind, _kind
                self.calls[_kind] += 1
                if self.timed:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                try:
                    return _orig(*a, **kw)
                finally:
                    if self.timed:
                        torch.cuda.synchronize()
                        self.seconds[_kind] += time.perf_counter() - t0
                    self.kind = outer
            setattr(Model, entry, entered)
        attn_layer.attention = self._attention
        moe_layer.router_dispatch = self._router
        moe_layer.moe_combine = self._combine
        ssd_block.ssd = self._ssd
        rglru_block.rglru = self._rglru

    def uninstall(self):
        for entry, orig in self._orig.items():
            setattr(Model, entry, orig)
        attn_layer.attention = fa.attention
        moe_layer.router_dispatch = kr.router_dispatch
        moe_layer.moe_combine = kc.moe_combine
        ssd_block.ssd = kssd.ssd
        rglru_block.rglru = krg.rglru

    def _record(self, key, launches, inputs):
        rec = self.seen.setdefault(key, {"launches": 0})
        rec["launches"] += launches
        rec["inputs"] = inputs

    @staticmethod
    def _copy(t):
        """A recorded input's copy (None stays None)."""
        return None if t is None else t.clone()

    def _attention(self, q, k, v, **kw):
        before = fa.attention.launches
        out = fa.attention(q, k, v, **kw)
        B, S, Hq, D = q.shape
        off = kw["q_offset"]
        off = self._copy(off) if torch.is_tensor(off) else off
        self._record(("flash_attention", self.kind, B, S, k.shape[1], Hq,
                      k.shape[2], D, q.dtype, mask_tag(kw)),
                     fa.attention.launches - before,
                     (self._copy(q), self._copy(k), self._copy(v),
                      dict(kw, q_offset=off)))
        return out

    def _router(self, logits, k, *, n_real, capacity, dispatch="sort",
                e_start=0, e_local=None):
        before = kr.router_dispatch.launches
        out = kr.router_dispatch(logits, k, n_real=n_real, capacity=capacity,
                                 dispatch=dispatch, e_start=e_start,
                                 e_local=e_local)
        self._record(("moe_router", self.kind) + tuple(logits.shape)
                     + (k, n_real, capacity),
                     kr.router_dispatch.launches - before,
                     (self._copy(logits), k, n_real, capacity))
        return out

    def _combine(self, out_buf, w, slot):
        before = kc.moe_combine.launches
        out = kc.moe_combine(out_buf, w, slot)
        self._record(("moe_combine", self.kind) + tuple(slot.shape)
                     + tuple(out_buf.shape) + (out_buf.dtype,),
                     kc.moe_combine.launches - before,
                     tuple(map(self._copy, (out_buf, w, slot))))
        return out

    def _ssd(self, x, dt, A, B, C, D=None, h0=None, *, chunk=256):
        before = kssd.ssd.launches
        out = kssd.ssd(x, dt, A, B, C, D, h0, chunk=chunk)
        self._record(("ssd", self.kind) + tuple(x.shape) + tuple(B.shape[2:])
                     + (x.dtype,), kssd.ssd.launches - before,
                     tuple(map(self._copy, (x, dt, A, B, C, D, h0)))
                     + (chunk,))
        return out

    def _rglru(self, x, r_gate, i_gate, log_lambda, h0=None):
        before = krg.rglru.launches
        out = krg.rglru(x, r_gate, i_gate, log_lambda, h0)
        self._record(("rglru", self.kind) + tuple(x.shape) + (x.dtype,),
                     krg.rglru.launches - before,
                     tuple(map(self._copy, (x, r_gate, i_gate, log_lambda,
                                            h0))))
        return out

    def by_kind(self, kernel):
        n = {kind: 0 for kind in self.entries.values()}
        for key, rec in self.seen.items():
            if key[0] == kernel:
                n[key[1]] = n.get(key[1], 0) + rec["launches"]
        return n


def check_demo(arch, cfg, outs, stats) -> list:
    """The demo's six results: each finished with 12 tokens inside the
    vocabulary, all six admitted and none shed.  Returns their time to
    first token (ms)."""
    check(len(outs) == 6, f"{arch} demo: expected 6 results")
    check(stats["admitted"] == 6 and stats["shed"] == 0,
          f"{arch} demo: admission {stats}")
    for o in outs:
        check(o["done"] and len(o["tokens"]) == 12,
              f"{arch} demo: unfinished request {o}")
        check(all(0 <= t < cfg.vocab for t in o["tokens"]),
              f"{arch} demo: token out of vocab {o['tokens']}")
    return [o["ttft_ms"] for o in outs]


def phase_demo(arch, cfg) -> list:
    """The launcher's ``--demo`` (it draws the config's own weights).
    Returns the requests' time to first token (ms)."""
    t0 = time.monotonic()
    outs, stats = serve_launcher.main(["--arch", arch, "--demo"])
    print(f"{arch} demo: {len(outs)} requests in "
          f"{time.monotonic() - t0:.2f}s (weight init included)")
    return check_demo(arch, cfg, outs, stats)


def phase_gateway_demo(arch, cfg, params) -> list:
    """The launcher's ``--demo`` on weights drawn by the caller (the
    launcher draws a config's own dtype; a model served in another one
    is built here): its six prompts of 5-10 tokens, 12 new tokens each
    at temperature 0.7, through ``gen.submit`` to a ``ServingGateway``
    over tcp and ``gen.result``, into 4 slots of 128.  Returns the
    requests' time to first token (ms)."""
    serve = ServeEngine(Model(cfg), params, max_len=128, n_slots=4,
                        device="cuda")
    rng = np.random.default_rng(0)
    server = Engine("tcp://127.0.0.1:0")
    gw = ServingGateway(server, serve)
    try:
        with Engine("tcp://127.0.0.1:0") as client:
            t0 = time.monotonic()
            rids = [client.call(server.uri, "gen.submit", {
                "tokens": rng.integers(1, cfg.vocab, size=5 + i).tolist(),
                "max_new": 12, "temperature": 0.7})["rid"]
                for i in range(6)]
            outs = [client.call(server.uri, "gen.result",
                                {"rid": rid, "wait": True, "timeout": 300.0},
                                timeout=305.0) for rid in rids]
            dt = time.monotonic() - t0
            stats = client.call(server.uri, "gen.stats", {})
    finally:
        gw.stop()
        server.shutdown()
    print(f"{arch} demo: {len(outs)} requests through gen.submit in "
          f"{dt:.2f}s ({cfg.param_dtype} weights made before)")
    return check_demo(arch, cfg, outs, stats)


def phase_sessions(arch, cfg, params=None) -> list:
    """Two conversations of three ~384-token turns through
    ``gen.generate`` with a ``session_id`` (chunks of 64, 4 slots of
    1024, ``session_cap=4``): at least two turns must resume a session,
    and nothing may be shed.  ``params``: the weights to serve (default
    drawn here, seed 1).  Returns the turns' time to first token (ms)."""
    model = Model(cfg)
    if params is None:
        params = model.init(1, device="cuda")
    serve = ServeEngine(model, params, max_len=1024, n_slots=4,
                        chunk_tokens=64, session_cap=4, device="cuda")
    rng = np.random.default_rng(1)
    server = Engine("tcp://127.0.0.1:0")
    gw = ServingGateway(server, serve)
    ttft = []
    try:
        with Engine("tcp://127.0.0.1:0") as client:
            prompts = {sid: rng.integers(1, cfg.vocab, size=384)
                       for sid in ("conv-a", "conv-b")}
            t0 = time.monotonic()
            n_tok = 0
            for turn in range(3):
                for sid in prompts:
                    out = client.call(server.uri, "gen.generate",
                                      {"tokens": prompts[sid].tolist(),
                                       "max_new": 8, "session_id": sid},
                                      timeout=300.0)
                    check(out["done"] and len(out["tokens"]) == 8
                          and all(0 <= t < cfg.vocab for t in out["tokens"]),
                          f"sessions: {sid} turn {turn}: {out}")
                    n_tok += len(out["tokens"])
                    ttft.append(out["ttft_ms"])
                    prompts[sid] = np.concatenate([
                        prompts[sid], out["tokens"],
                        rng.integers(1, cfg.vocab, size=16)])
            dt = time.monotonic() - t0
            stats = client.call(server.uri, "gen.stats", {})
    finally:
        gw.stop()
        server.shutdown()
    print(f"{arch} sessions: 6 turns, {n_tok} tokens in {dt:.2f}s; "
          f"prefix_hits {stats['prefix_hits']} misses "
          f"{stats['prefix_misses']} saved {stats['prefix_tokens_saved']}; "
          f"shed {stats['shed']}")
    check(stats["prefix_hits"] >= 2, f"sessions: prefix hits {stats}")
    check(stats["shed"] == 0, f"sessions: shed {stats}")
    return ttft


def phase_window(arch, cfg, params, recorder) -> list:
    """One request whose prompt crosses the local layers' window in
    chunked prefill: WINDOW_PROMPT tokens in chunks of 64 through
    ``gen.generate`` into a slot of WINDOW_MAX_LEN, WINDOW_NEW new
    tokens.  The last chunk of the local layers (recorded with its
    window) must run at an offset past the window, where keys fall out
    of it (phase 4 holds it against the plain version), and the global
    layers' chunks must read every key (no window).  Returns its time to
    first token (ms)."""
    serve = ServeEngine(Model(cfg), params, max_len=WINDOW_MAX_LEN,
                        n_slots=4, chunk_tokens=64, session_cap=4,
                        device="cuda")
    rng = np.random.default_rng(2)
    server = Engine("tcp://127.0.0.1:0")
    gw = ServingGateway(server, serve)
    try:
        with Engine("tcp://127.0.0.1:0") as client:
            t0 = time.monotonic()
            out = client.call(server.uri, "gen.generate", {
                "tokens": rng.integers(1, cfg.vocab,
                                       size=WINDOW_PROMPT).tolist(),
                "max_new": WINDOW_NEW, "session_id": "window",
                "timeout": 600.0}, timeout=605.0)
            dt = time.monotonic() - t0
            stats = client.call(server.uri, "gen.stats", {})
    finally:
        gw.stop()
        server.shutdown()
    check(out["done"] and len(out["tokens"]) == WINDOW_NEW
          and all(0 <= t < cfg.vocab for t in out["tokens"])
          and stats["shed"] == 0, f"{arch} window: {out} {stats}")
    chunks = {key[-1]: rec["inputs"][3] for key, rec in recorder.seen.items()
              if key[:2] == ("flash_attention", "chunk")
              and key[4] == WINDOW_MAX_LEN}
    local = chunks.get(f" window {cfg.window}")
    print(f"{arch} window: a {WINDOW_PROMPT}-token prompt in chunks of "
          f"{stats['chunk_tokens']} into {WINDOW_MAX_LEN}, "
          f"{len(out['tokens'])} new tokens in {dt:.2f}s; the chunks' masks "
          f"{sorted(chunks)}; the last local chunk at offset "
          f"{None if local is None else local['q_offset']} with window "
          f"{None if local is None else local['window']}")
    check(local is not None and local["q_offset"] >= cfg.window
          and set(chunks) == {"", f" window {cfg.window}"}
          and chunks[""]["window"] == 0,
          f"{arch} window: the local chunks did not pass the window, or "
          f"the global ones are missing: {sorted(chunks)}")
    return [out["ttft_ms"]]


def phase_long_prompts(arch, cfg):
    """In place of the session phase for a model that cannot chunk its
    prefill: four long prompts at once through ``gen.generate`` into 4
    slots of LONG_MAX_LEN.  Chunking and sessions are asked for; the
    engine must turn both off."""
    model = Model(cfg)
    params = model.init(1, device="cuda")
    serve = ServeEngine(model, params, max_len=LONG_MAX_LEN, n_slots=4,
                        chunk_tokens=64, session_cap=4, device="cuda")
    rng = np.random.default_rng(1)
    server = Engine("tcp://127.0.0.1:0")
    gw = ServingGateway(server, serve)
    try:
        with Engine("tcp://127.0.0.1:0") as client:
            t0 = time.monotonic()
            futs = [client.call_async(
                server.uri, "gen.generate",
                {"tokens": rng.integers(1, cfg.vocab, size=n).tolist(),
                 "max_new": 8, "session_id": f"long-{n}", "timeout": 600.0},
                timeout=600.0) for n in LONG_PROMPTS]
            outs = [f.result(timeout=605.0) for f in futs]
            dt = time.monotonic() - t0
            stats = client.call(server.uri, "gen.stats", {})
    finally:
        gw.stop()
        server.shutdown()
    print(f"{arch} long prompts: {len(outs)} requests of {LONG_PROMPTS} "
          f"tokens, {sum(len(o['tokens']) for o in outs)} new tokens in "
          f"{dt:.2f}s; chunk_tokens {stats['chunk_tokens']} "
          f"session_capacity {stats['session_capacity']}")
    for n, o in zip(LONG_PROMPTS, outs):
        check(o["done"] and len(o["tokens"]) == 8
              and all(0 <= t < cfg.vocab for t in o["tokens"]),
              f"long prompts: {n}-token request {o}")
    check(stats["chunk_tokens"] == 0 and stats["session_capacity"] == 0
          and stats["pinned_sessions"] == 0,
          f"long prompts: chunking or sessions on for {arch}: {stats}")


def frontend_of(cfg, rng) -> np.ndarray:
    """A seeded frontend (frontend_seq, frontend_dim) f32: a VLM's patch
    embeddings or an encoder-decoder's frames, as the reference's stub
    towers hand them over."""
    return (rng.standard_normal((cfg.frontend_seq, cfg.frontend_dim))
            * 0.1).astype(np.float32)


def phase_frontend_requests(arch, cfg):
    """Phases 3k and 3l's serving: FRONTEND_PROMPTS requests of 5-10
    prompt tokens, each with a seeded frontend, FRONTEND_NEW new tokens,
    submitted through ``gen.submit`` to a ``ServingGateway`` over tcp and
    read back through ``gen.result``, into 4 slots.  Chunking and sessions
    are asked for: the engine must prefill each whole and pin nothing."""
    model = Model(cfg)
    params = model.init(1, device="cuda")
    max_len = cfg.frontend_seq + 10 + FRONTEND_NEW
    serve = ServeEngine(model, params, max_len=-(-max_len // 64) * 64,
                        n_slots=4, chunk_tokens=64, session_cap=4,
                        device="cuda")
    rng = np.random.default_rng(1)
    server = Engine("tcp://127.0.0.1:0")
    gw = ServingGateway(server, serve)
    try:
        with Engine("tcp://127.0.0.1:0") as client:
            t0 = time.monotonic()
            rids = [client.call(server.uri, "gen.submit", {
                "tokens": rng.integers(1, cfg.vocab, size=5 + i % 6).tolist(),
                "max_new": FRONTEND_NEW, "frontend": frontend_of(cfg, rng),
                "session_id": f"fe-{i}"}, timeout=300.0)["rid"]
                for i in range(FRONTEND_PROMPTS)]
            outs = [client.call(server.uri, "gen.result",
                                {"rid": rid, "wait": True, "timeout": 600.0},
                                timeout=605.0) for rid in rids]
            dt = time.monotonic() - t0
            stats = client.call(server.uri, "gen.stats", {})
    finally:
        gw.stop()
        server.shutdown()
    print(f"{arch} frontend requests: {len(outs)} requests with "
          f"({cfg.frontend_seq}, {cfg.frontend_dim}) frontends over tcp, "
          f"{sum(len(o['tokens']) for o in outs)} new tokens in {dt:.2f}s "
          f"(weights made before); max_len {serve.max_len}, chunk_tokens "
          f"{stats['chunk_tokens']} pinned_sessions "
          f"{stats['pinned_sessions']}")
    for o in outs:
        check(o["done"] and len(o["tokens"]) == FRONTEND_NEW
              and all(0 <= t < cfg.vocab for t in o["tokens"]),
              f"{arch} frontend requests: {o}")
    check(stats["admitted"] == FRONTEND_PROMPTS and stats["chunk_tokens"] == 0
          and stats["pinned_sessions"] == 0,
          f"{arch} frontend requests: stats {stats}")


def path_kernels(model):
    """The kernels a model's serving path must launch, by name, and the
    entry points each must launch on: attention, the router and the MoE
    combine on every entry point the model has, the SSD and the RG-LRU on
    prefill alone (their decode steps are plain torch, as the
    reference's)."""
    kinds = set(model.kinds)
    kernels = {}
    if "attn" in model.stack_sizes:
        kernels["flash_attention"] = (fa.attention, None)
    if model.cfg.moe.num_experts:
        kernels["moe_router"] = (kr.router_dispatch, None)
        kernels["moe_combine"] = (kc.moe_combine, None)
    if "ssd" in kinds:
        kernels["ssd"] = (kssd.ssd, ("prefill",))
    if "rglru" in kinds:
        kernels["rglru"] = (krg.rglru, ("prefill",))
    return kernels


def serve_path(arch):
    """Phase 3a/3b/3d/3e/3k/3l: one model's demo and sessions (or long
    prompts, for a model that cannot chunk; or requests with frontends,
    for a model that takes one) with the kernels' counts zeroed just
    before and read just after; returns the recorder."""
    cfg = configs.get(arch)
    model = Model(cfg)
    kernels = path_kernels(model)
    recorder = MainPathRecorder(model.supports_chunked_prefill)
    recorder.install()
    for fn, _ in kernels.values():
        fn.launches = 0
    try:
        if cfg.frontend != "none":
            phase_frontend_requests(arch, cfg)
        else:
            phase_demo(arch, cfg)
            if model.supports_chunked_prefill:
                phase_sessions(arch, cfg)
            else:
                phase_long_prompts(arch, cfg)
    finally:
        recorder.uninstall()
    free_card()
    check_path_launches(arch, recorder, kernels)
    return recorder


def check_path_launches(arch, recorder, kernels) -> dict:
    """Prefill and decode ran, and each kernel of ``kernels``
    (``path_kernels``') launched on its entry points and nowhere else.
    Returns the launches by kernel and entry point."""
    counts = {name: fn.launches for name, (fn, _) in kernels.items()}
    print(f"{arch} main path: entry point calls {recorder.calls}")
    check(recorder.calls["decode"] > 0 and recorder.calls["prefill"] > 0,
          f"{arch}: prefill or decode did not run {recorder.calls}")
    for name, n in counts.items():
        by_kind = recorder.by_kind(name)
        print(f"{arch} main path: {name} {n} launches, by entry point "
              f"{by_kind}")
        check(sum(by_kind.values()) == n and set(by_kind)
              == set(recorder.entries.values()),
              f"{arch}: {name} launched outside the Model entry points "
              f"{by_kind}")
        where = kernels[name][1] or tuple(recorder.entries.values())
        check(all(by_kind[k] > 0 for k in where),
              f"{arch}: {name} was not launched on {where}: {by_kind}")
        check(all(v == 0 for k, v in by_kind.items() if k not in where),
              f"{arch}: {name} launched outside {where}: {by_kind}")
    return {name: recorder.by_kind(name) for name in counts}


def decode_split(model, params) -> dict:
    """One decode step of the sessions' 4 slots at position 512 of 1024
    (after two warm-up steps): its host wall-clock with the card
    synchronised on both sides (median of 3), and, by ``torch.profiler``
    over one more, the card's busy time in it (its kernels' time) and
    their launches.  Reads where a decode step's time goes: the weights'
    bytes on the card, or the host's pace of launching its kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cache = model.cache_specs(4, 1024, device="cuda")
    tok = torch.ones((4, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((4,), 512, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        for _ in range(2):
            model.decode_step(params, cache, tok, pos)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.decode_step(params, cache, tok, pos)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.decode_step(params, cache, tok, pos)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    wall = float(np.median(walls)) * 1e3
    return {"wall_ms": wall,
            "device_busy_ms": busy if kernels else None,
            "device_busy_share": busy / wall if kernels else None,
            "device_launches": sum(e.count for e in kernels)}


def breadth_path(arch, param_dtype=None, n_layers=None):
    """Phases 3o-3q and 3v: one more configuration served at full width
    (``n_layers`` cuts the depth) through the gateway over tcp, the
    kernels' counts zeroed just before and read just after.  A config
    served in its own dtype (``param_dtype`` None: gemma3-12b, f32) runs
    the launcher's ``--demo`` first, then the card is freed (two copies
    do not fit); one served in another (deepseek-moe-16b, command-r-35b
    and nemotron-4-340b in bf16) builds its engines here, as no launcher
    takes a dtype, and runs the demo's requests through ``gen.submit``.
    Then, on one draw of the weights, the session phase and, for a
    config with a window, the window-crossing request (``phase_window``).
    Prints the weights' bytes, the card's peak, the time to first token,
    the ms of a decode step and each kernel's launches by entry point.
    Returns the recorder."""
    cfg = configs.get(arch)
    if param_dtype is not None:
        cfg = cfg.replace(param_dtype=param_dtype)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    model = Model(cfg)
    kernels = path_kernels(model)
    recorder = MainPathRecorder(model.supports_chunked_prefill, timed=True)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    recorder.install()
    for fn, _ in kernels.values():
        fn.launches = 0
    ttft = {}
    try:
        if param_dtype is None:
            ttft["demo"] = phase_demo(arch, cfg)
            free_card()
        params = model.init(1, device="cuda")
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in optim.leaves(params))
        if param_dtype is not None:
            ttft["demo"] = phase_gateway_demo(arch, cfg, params)
        ttft["sessions"] = phase_sessions(arch, cfg, params)
        if "local" in model.kinds:
            ttft["window"] = phase_window(arch, cfg, params, recorder)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    finally:
        recorder.uninstall()
    # the path's launches are counted: the split's own are not the path's
    launches = check_path_launches(arch, recorder, kernels)
    split = decode_split(model, params)
    del params
    free_card()
    check(all(recorder.calls[k] > 0 for k in ("prefill", "chunk", "decode")),
          f"{arch}: an entry point did not run {recorder.calls}")
    ms = {kind: recorder.seconds[kind] * 1e3 / max(n, 1)
          for kind, n in recorder.calls.items()}
    out = {"arch": arch, "param_dtype": cfg.param_dtype,
           "compute_dtype": cfg.compute_dtype, "layers": cfg.n_layers,
           "head_dim": cfg.hd,
           "weight_bytes": weight_bytes, "peak_bytes": peak,
           "ttft_ms": {part: {"p50": _pct(v, 0.5), "max": max(v)}
                       for part, v in ttft.items()},
           "entry_calls": recorder.calls, "entry_ms_a_call": ms,
           "decode_split": split,
           "launches": launches, "card": torch.cuda.get_device_name(0)}
    print(f"{arch} serving: {cfg.param_dtype} weights {weight_bytes} bytes "
          f"({weight_bytes / 1e9:.2f} GB), card peak {peak} bytes "
          f"({peak / 2**30:.2f} GiB); time to first token (ms) "
          f"{out['ttft_ms']}; a decode step {ms['decode']:.2f} ms "
          f"(4 slots, {recorder.calls['decode']} steps), a 64-token chunk "
          f"{ms['chunk']:.2f} ms, a prefill {ms['prefill']:.2f} ms "
          f"(on the card, synchronised); a decode step alone (4 slots at "
          f"512 of 1024) {split['wall_ms']:.2f} ms of which the card is "
          f"busy {split['device_busy_ms']} ms in "
          f"{split['device_launches']} launches")
    print("breadth " + json.dumps(out))
    return recorder
# ---------------------------------------------------------------------------
# the reference's serve_session scenario (benchmarks/bench_core.py,
# bench_serve_session, its full-size values): 3 replicas, 8 conversations
# of 6 turns, a 384-token first prompt, 2 new tokens a turn (greedy), each
# turn appending its tokens and 4 fresh ones; 4 slots of 512, 32-token
# chunks, 8 pinned sessions a replica
FABRIC = dict(replicas=3, conversations=8, turns=6, prompt_len=384,
              max_new=2, fresh=4, max_len=512, n_slots=4, chunk=32,
              session_cap=8, kill_at=2)
FABRIC_SERVICE = "gen-sess"
FABRIC_SEED = 3             # one model: every replica holds the same weights
FABRIC_START_S = 600.0      # a replica's import, weight init and warm-up
FABRIC_CHECK_S = 300.0      # a replica's phase 4 check after serving


def fabric_replica(registry_uri: str) -> int:
    """One replica of phase 3f, in a process of its own: full-width
    qwen1.5-0.5b on the card behind a ``ServingGateway`` registered with
    ``registry_uri`` as FABRIC_SERVICE.  It warms up as the reference's
    worker (one warm turn, one session resume), then sets attention's
    count to 0 and installs a MainPathRecorder, prints "URI <uri>" and
    serves until its stdin closes.  Then it checks that attention
    launched nowhere outside the Model entry points, holds the kernel
    against plain on the inputs it recorded (phase 4) and prints
    "LAUNCHES <json>": the entry points' calls, attention's launches by
    entry point and those rows."""
    F = FABRIC
    model = Model(configs.get(ARCH))
    params = model.init(FABRIC_SEED, device="cuda")
    serve = ServeEngine(model, params, max_len=F["max_len"],
                        n_slots=F["n_slots"], chunk_tokens=F["chunk"],
                        session_cap=F["session_cap"], device="cuda")
    w = serve.generate([np.arange(8, dtype=np.int32)], max_new=2,
                       session_ids=["warm"])[0]
    p2 = np.concatenate([np.arange(8), np.asarray(w),
                         np.zeros(2)]).astype(np.int32)
    serve.generate([p2], max_new=2, session_ids=["warm"])
    recorder = MainPathRecorder(model.supports_chunked_prefill)
    recorder.install()
    fa.attention.launches = 0
    try:
        with Engine("tcp://127.0.0.1:0") as e:
            gw = ServingGateway(e, serve, registry=registry_uri,
                                service=FABRIC_SERVICE, report_interval=0.2,
                                shed_enabled=False)
            print("URI " + e.uri, flush=True)
            sys.stdin.read()
            gw.close()
    finally:
        recorder.uninstall()
    n = fa.attention.launches
    by_kind = recorder.by_kind("flash_attention")
    check(sum(by_kind.values()) == n,
          f"fabric replica: attention launched outside the Model entry "
          f"points ({n} launches, by entry point {by_kind})")
    del serve, params, model
    free_card()
    rows = phase_main_shapes(ARCH, recorder)
    print("LAUNCHES " + json.dumps({"calls": recorder.calls,
                                    "by_kind": by_kind, "rows": rows}),
          flush=True)
    return 0


class Replica:
    """A replica subprocess (this script with ``--fabric-replica``); its
    stdout read by a thread into a queue, so the parent can wait on it
    with a deadline."""

    def __init__(self, registry_uri: str):
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--fabric-replica", registry_uri],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.lines: "queue.Queue[Optional[str]]" = queue.Queue()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.put(line.rstrip("\n"))
        self.lines.put(None)                 # EOF

    def line(self, prefix: str, timeout: float) -> str:
        """The first line starting with ``prefix``; fails the phase at
        EOF or after ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                line = self.lines.get(
                    timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                raise PhaseError(f"fabric: no {prefix!r} line from replica "
                                 f"pid {self.proc.pid} in {timeout}s")
            if line is None:
                raise PhaseError(f"fabric: replica pid {self.proc.pid} "
                                 f"ended (rc {self.proc.wait()}) before "
                                 f"{prefix!r}")
            if line.startswith(prefix):
                return line[len(prefix):]
            print(f"fabric replica pid {self.proc.pid}: {line}")

    def stop(self) -> Optional[dict]:
        """Close stdin and read the launch counts a live replica prints
        as it exits; None for a replica that is already dead."""
        if self.proc.poll() is not None:
            return None
        self.proc.stdin.close()
        try:
            return json.loads(self.line("LAUNCHES ", FABRIC_CHECK_S))
        finally:
            self.proc.wait(timeout=60)

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=60)


def _pct(xs, q):
    s = sorted(xs)
    return s[min(int(len(s) * q), len(s) - 1)]


def fabric_turns(pool, replicas, affine: bool, tag: str, kill_at=None):
    """One pass of FABRIC's conversations (all of a turn at once, one
    thread each) through ``pool``, or with ``affine`` through a
    SessionAffinity over it with a session id a conversation.  With
    ``kill_at`` replica 0 is SIGKILLed before that turn.  Every turn must
    complete with max_new tokens."""
    from repro_torch.fabric import SessionAffinity
    F = FABRIC
    rng = np.random.default_rng(7)
    aff = SessionAffinity(pool) if affine else None
    hist = [rng.integers(1, 500, F["prompt_len"]).tolist()
            for _ in range(F["conversations"])]
    ttft_follow, done, new_tokens = [], 0, 0

    def one_turn(ci):
        sid = f"{tag}-conv{ci}"
        arg = {"tokens": hist[ci], "max_new": F["max_new"],
               "session_id": sid if affine else None}
        if affine:
            return aff.call_routed(sid, "gen.generate", arg, timeout=180.0)[0]
        return pool.call("gen.generate", arg, timeout=180.0)

    t0 = time.perf_counter()
    for t in range(F["turns"]):
        if kill_at is not None and t == kill_at:
            replicas[0].kill()                 # replica death mid-dialogue
        with ThreadPoolExecutor(F["conversations"]) as tp:
            futs = [tp.submit(one_turn, ci)
                    for ci in range(F["conversations"])]
            for ci, f in enumerate(futs):
                res = f.result(timeout=300)
                check(res["done"] and len(res["tokens"]) == F["max_new"],
                      f"fabric {tag}: turn {t} conversation {ci}: {res}")
                hist[ci] = (hist[ci] + list(res["tokens"])
                            + rng.integers(1, 500, F["fresh"]).tolist())
                new_tokens += len(res["tokens"])
                done += 1
                if t > 0:
                    ttft_follow.append(res["ttft_ms"])
    wall = time.perf_counter() - t0
    return {"turns_completed": done,
            "turns_expected": F["turns"] * F["conversations"],
            "tokens_per_s": new_tokens / wall, "wall_s": wall,
            "follow_ttft_p50_ms": _pct(ttft_follow, 0.5),
            "follow_ttft_p99_ms": _pct(ttft_follow, 0.99),
            "affinity": aff.stats() if aff else None}


def prefix_counters(pool) -> dict:
    """Each live replica's gen.stats prefix counters, by instance id."""
    out = {}
    for rep in pool.replicas():
        try:
            st = pool.call_on(rep.iid, "gen.stats", {}, timeout=10.0)
        except Exception:
            continue          # the killed replica, until its TTL runs out
        out[rep.iid] = {k: st[k] for k in ("prefix_hits", "prefix_misses",
                                           "prefix_tokens_saved")}
    return out


def phase_fabric(card: str) -> list:
    """Phase 3f: a registry in this process, FABRIC's replicas (each a
    full-width qwen1.5-0.5b on this one card, registered as
    FABRIC_SERVICE), and conversations through a ServicePool: naive, then
    session-affine, then affine with replica 0 SIGKILLed before turn
    ``kill_at``.  Returns the kernel rows the surviving replicas checked
    on their own inputs, with their launches."""
    from repro_torch.fabric import RegistryService, RetryPolicy, ServicePool
    F = FABRIC
    t_start = time.monotonic()
    reg_engine = Engine("tcp://127.0.0.1:0")
    registry = RegistryService(reg_engine, instance_ttl=3.0)
    replicas = []
    try:
        replicas = [Replica(reg_engine.uri) for _ in range(F["replicas"])]
        for i, r in enumerate(replicas):
            print(f"fabric replica {i}: pid {r.proc.pid} at "
                  f"{r.line('URI ', FABRIC_START_S)}")
        print(f"fabric: {F['replicas']} replicas up in "
              f"{time.monotonic() - t_start:.2f}s (weight init and warm-up "
              f"included); the {F['replicas']} replicas share one card")
        with Engine("tcp://127.0.0.1:0") as cli:
            # rr and fixed credits, as the reference's scenario: a turn
            # fans every conversation out at once, and gen.generate holds
            # its call open for a whole generation
            pool = ServicePool(cli, reg_engine.uri, FABRIC_SERVICE,
                               balancer="rr", credits_per_target=8,
                               adaptive_credits=False,
                               policy=RetryPolicy(attempts=4,
                                                  rpc_timeout=120.0))
            pool.call("gen.stats", {}, timeout=30.0)
            check(len(pool.replicas()) == F["replicas"],
                  f"fabric: {len(pool.replicas())} replicas registered")
            base = prefix_counters(pool)
            check(len(base) == F["replicas"], f"fabric: stats of {base}")
            out = {"naive": fabric_turns(pool, replicas, False, "naive"),
                   "affine": fabric_turns(pool, replicas, True, "affine")}
            mid = prefix_counters(pool)
            out["kill"] = fabric_turns(pool, replicas, True, "kill",
                                       kill_at=F["kill_at"])
            end = prefix_counters(pool)
            check(len(end) == F["replicas"] - 1,
                  f"fabric: stats after the kill of {end}")
        launches = [r.stop() for r in replicas[1:]]
    finally:
        for r in replicas:
            r.kill()
        registry.close()
        reg_engine.shutdown()

    def delta(a, b, key):
        return sum(b[i][key] - a.get(i, {}).get(key, 0) for i in b)
    for name in ("naive", "affine", "kill"):
        ph = out[name]
        print(f"fabric {name}: {ph['turns_completed']}/"
              f"{ph['turns_expected']} turns, {ph['tokens_per_s']} tokens/s "
              f"({ph['wall_s']} s), follow-up TTFT p50 "
              f"{ph['follow_ttft_p50_ms']} ms p99 "
              f"{ph['follow_ttft_p99_ms']} ms; affinity {ph['affinity']}")
        check(ph["turns_completed"] == ph["turns_expected"],
              f"fabric {name}: turns lost")
    affine_prefix = {k: delta(base, mid, k) for k in (
        "prefix_hits", "prefix_misses", "prefix_tokens_saved")}
    survivors = {k: delta(base, end, k) for k in (
        "prefix_hits", "prefix_misses", "prefix_tokens_saved")}
    kill_misses = delta(mid, end, "prefix_misses")
    speedup = out["affine"]["tokens_per_s"] / out["naive"]["tokens_per_s"]
    p99_lower = (out["affine"]["follow_ttft_p99_ms"]
                 < out["naive"]["follow_ttft_p99_ms"])
    print(f"fabric prefix counters (warm-ups excluded): naive + affine on "
          f"all replicas {affine_prefix}; surviving replicas after the "
          f"kill phase {survivors}; kill-phase misses {kill_misses}")
    print(f"fabric: affine / naive tokens/s {speedup} (the reference's >= 2x "
          f"{'met' if speedup >= 2 else 'missed'}); follow-up TTFT p99 "
          f"lower {'met' if p99_lower else 'missed'}; {card}; the "
          f"{F['replicas']} replicas share one card")
    check(survivors["prefix_hits"] > 0
          and survivors["prefix_tokens_saved"] > 0,
          f"fabric: no prefix reuse on the surviving replicas {survivors}")
    moves = out["kill"]["affinity"]["moves"]
    check(moves > 0 or kill_misses > F["conversations"],
          f"fabric: no session re-homed after the kill (moves {moves}, "
          f"misses {kill_misses})")
    check(all(ln is not None for ln in launches),
          "fabric: a surviving replica died")
    total = {"prefill": 0, "chunk": 0, "decode": 0}
    rows = []
    for i, ln in enumerate(launches, start=1):
        by_kind = ln["by_kind"]
        print(f"fabric replica {i}: entry point calls {ln['calls']}, "
              f"attention launches by entry point {by_kind} (counted from "
              f"the end of its warm-up)")
        check(by_kind["chunk"] > 0 and by_kind["decode"] > 0,
              f"fabric replica {i}: attention not launched on chunk and "
              f"decode {by_kind}")
        for k in total:
            total[k] += by_kind[k]
        for r in ln["rows"]:
            kind = r["case"].split(":", 1)[1]
            rows.append(dict(r, case=f"{ARCH}:fabric-r{i}-{kind}"))
    print("fabric " + json.dumps(dict(
        out, speedup_tokens_per_s=speedup, prefix_affine=affine_prefix,
        prefix_survivors=survivors, kill_misses=kill_misses,
        launches_survivors=total, card=card, replicas_share_one_card=True)))
    return rows


# ---------------------------------------------------------------------------
# phase 3b: one MoE layer call, its launches and host syncs
# ---------------------------------------------------------------------------
def eager_moe_local(cfg, params, x2d, *, e_pad, capacity_factor,
                    dropless=False, record=None):
    """The eager-dispatch MoE layer (``models/moe.py`` before routing and
    dispatch became one launch), kept here as a yardstick of launches,
    host syncs and outputs only: the aux sums and the sort dispatch in
    eager PyTorch around ``router_topk``, and boolean-mask indexing,
    which makes the host wait for the card.  ``record`` (a dict), when
    given, receives the routing (w, idx, probs), each assignment's slot
    (E·C where dropped, as ``Routing.slot``) and the dispatched buffer."""
    T, d = x2d.shape
    E_real, k = cfg.moe.num_experts, cfg.moe.top_k
    cdt = dtype_of(cfg.compute_dtype)
    dev = x2d.device
    logits = (x2d.to(cdt) @ params["router"].to(cdt)).float()
    if e_pad > E_real:
        pad_mask = torch.arange(e_pad, device=dev) >= E_real
        logits = torch.where(pad_mask[None], kr.NEG_INF, logits)
    w, idx, probs = kr.router_topk(logits, k)
    load_sum = F.one_hot(idx.long(), e_pad).float().sum(1).sum(0)
    prob_sum = probs.sum(0)
    z_sum = torch.square(torch.logsumexp(logits, dim=-1)).sum()
    C = T if dropless else max(
        int(math.ceil(T * k / max(E_real, 1) * capacity_factor)), 1)
    flat_e = idx.reshape(-1).long()
    flat_pos = torch.argsort(flat_e, stable=True)
    se = flat_e[flat_pos]
    seg_start = torch.searchsorted(se, torch.arange(e_pad, device=dev))
    pos_in_e = torch.arange(T * k, device=dev) - seg_start[se]
    keep = pos_in_e < C
    ke, kpos, kp = se[keep], pos_in_e[keep], flat_pos[keep]
    buf = torch.zeros((e_pad, C, d), dtype=x2d.dtype, device=dev)
    buf.index_put_((ke, kpos), x2d[kp // k])
    if record is not None:
        slot = torch.full((T * k,), e_pad * C, dtype=torch.int32, device=dev)
        slot[kp] = (ke * C + kpos).to(torch.int32)
        record.update(w=w, idx=idx, probs=probs, slot=slot.view(T, k),
                      buf=buf.clone())
    out_buf = moe_layer._expert_ffn(cfg, params, buf)
    del buf
    vals = torch.zeros((T * k, d), dtype=out_buf.dtype, device=dev)
    vals[kp] = out_buf[ke, kpos] * w.reshape(-1)[kp][:, None].to(vals.dtype)
    return vals.view(T, k, d).sum(1), (load_sum, prob_sum, z_sum, float(T))


def device_events(fn) -> list:
    """Names of the device activities (kernels, copies, fills) one call
    of ``fn`` puts on the card, by ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def host_syncs(fn) -> int:
    """How often one call of ``fn`` makes the host wait for the card, by
    ``torch.cuda``'s sync debug mode set to warn."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def call_ms(fns, iters: int = 20) -> list:
    """Host wall-clock of one call of each function, ending in a
    synchronise, in ms: means of ``iters`` calls, the functions in turns
    (a, b, b, a) to share the host's noise."""
    total = [0.0] * len(fns)
    order = list(range(len(fns)))
    for it in range(iters):
        for i in (order if it % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[i]()
            torch.cuda.synchronize()
            total[i] += time.perf_counter() - t0
    return [t / iters * 1e3 for t in total]


def layer_intermediates(layer):
    """y, the routing and the dispatched buffer of one call of ``layer``
    (a function of no arguments that calls ``moe_layer._moe_local``):
    the router's outputs and the experts' input, as the layer passes
    them."""
    seen = {}

    def router(*a, **kw):
        seen["routing"] = kr.router_dispatch(*a, **kw)
        return seen["routing"]

    def ffn(cfg, params, buf):
        seen["buf"] = buf.clone()
        return EXPERT_FFN(cfg, params, buf)
    moe_layer.router_dispatch, moe_layer._expert_ffn = router, ffn
    try:
        y, aux = layer()
    finally:
        moe_layer.router_dispatch = kr.router_dispatch
        moe_layer._expert_ffn = EXPERT_FFN
    return y, aux, seen["routing"], seen["buf"]


def moe_layer_check():
    """One MoE layer at granite's width (40 experts, top-8, d 1536, bf16
    compute, f32 weights), dropless as serving runs it, on a decode
    step's 4 tokens and a 64-token chunk: no host sync (sync debug mode
    "error"); its routing (w, idx, probs), each assignment's slot and the
    dispatched buffer equal to the eager-dispatch layer's bit for bit, y
    within MOE_Y_TOL of its largest entry (printed) and the aux sums
    within the router's tolerance; launches from the router matmul's
    output to y (the layer's device activities less the router matmul's
    and the expert products') beside the eager layer's."""
    cfg = configs.get(MOE_ARCH)
    cdt = dtype_of(cfg.compute_dtype)
    e_pad = moe_layer.padded_experts(cfg, 1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    params = moe_layer.moe_params(cfg, gen, e_pad=e_pad)
    kw = dict(e_pad=e_pad, capacity_factor=cfg.moe.capacity_factor,
              dropless=True)
    rows = []
    for name, T in (("decode", 4), ("chunk", 64)):
        x2d = torch.randn((T, cfg.d_model), generator=gen,
                          device="cuda").to(cdt)

        def layer():
            return moe_layer._moe_local(cfg, params, x2d, **kw)

        def eager():
            return eager_moe_local(cfg, params, x2d, **kw)
        y, aux, r, buf = layer_intermediates(layer)
        seen0 = {}
        y0, aux0 = eager_moe_local(cfg, params, x2d, record=seen0, **kw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            layer()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        zeros = x2d.new_zeros((e_pad, T, cfg.d_model))
        around = [device_events(lambda: (x2d.to(cdt) @ params["router"].to(
                      cdt)).float()),
                  device_events(lambda: moe_layer._expert_ffn(cfg, params,
                                                              zeros))]
        events, events0 = device_events(layer), device_events(eager)
        n_around = sum(map(len, around))
        ms0, ms = call_ms([eager, layer])
        y_err = float((y.float() - y0.float()).abs().max())
        y_max = float(y0.float().abs().max())
        row = {"case": f"{MOE_ARCH}:{name}", "T": T,
               "launches": len(events) - n_around,
               "eager_launches": len(events0) - n_around,
               "host_syncs": host_syncs(layer),
               "eager_host_syncs": host_syncs(eager),
               "router_matmul_and_expert_launches": [len(a) for a in around],
               "call_ms": ms, "eager_call_ms": ms0,
               "routing_equal_eager": all(
                   bool(torch.equal(getattr(r, n), seen0[n]))
                   for n in ("w", "idx", "probs", "slot")),
               "buf_equal_eager": bool(torch.equal(buf, seen0["buf"])),
               "y_err": y_err, "y_max": y_max, "y_tol": MOE_Y_TOL,
               "y_equal_eager": bool(torch.equal(y, y0)),
               "aux_ok": all(bool(torch.allclose(a, b, rtol=ROUTER_RTOL,
                                                 atol=ROUTER_ATOL))
                             for a, b in zip(aux[:3], aux0[:3]))}
        print("moe-layer", json.dumps(row))
        print(f"moe-layer {name}: largest |y - eager y| {y_err} against "
              f"the largest |eager y| {y_max} (tolerance {MOE_Y_TOL} of "
              f"it); bitwise equal: {row['y_equal_eager']}")
        print(f"moe-layer {name} device activities: {events}")
        print(f"moe-layer {name} the eager layer's: {events0}")
        check(row["routing_equal_eager"] and row["buf_equal_eager"]
              and y_err <= MOE_Y_TOL * y_max and row["aux_ok"],
              f"moe layer {name}: differs from the eager layer {row}")
        check(row["host_syncs"] == 0 and row["eager_host_syncs"] > 0,
              f"moe layer {name}: host syncs {row}")
        check(0 < row["launches"] < row["eager_launches"],
              f"moe layer {name}: launches {row}")
        rows.append(row)
    del params
    free_card()
    return rows


class CheckpointRecorder:
    """What the checkpoint path gives Fletcher-64, and where its host
    time goes.  Wraps the services' checksum (to count launches and keep
    the inputs of the last launch per (step, bytes)), the three places it
    runs — the client's save snapshot, the server's verification, the
    client's restore — and the copies and bulk pulls around them, adding
    each call's host seconds under (step, what)."""

    KINDS = ("save", "verify", "restore")

    def __init__(self):
        self.seen = {}
        self.seconds = {}
        self.batches = {}                   # checksum calls, by step
        self._local = threading.local()     # the server verifies on its
        self._patched = []                  # own handler thread

    def _kind(self):
        return getattr(self._local, "kind", "outside the service")

    def _within(self, kind, fn):
        def run(*a, **kw):
            outer, self._local.kind = self._kind(), kind
            try:
                return fn(*a, **kw)
            finally:
                self._local.kind = outer
        return run

    def _timed(self, what, fn, kind=None):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                key = f"{kind or self._kind()}: {what}"
                self.seconds[key] = (self.seconds.get(key, 0.0)
                                     + time.perf_counter() - t0)
        return run

    def _patch(self, owner, attr, new):
        """Set ``owner.attr``; an instance's method is shadowed, and
        ``uninstall`` removes the shadow again."""
        self._patched.append((owner, attr, vars(owner).get(attr)))
        setattr(owner, attr, new)

    def install(self, server_engine=None, client_engine=None):
        """Without engines (the trainer's, which it makes itself, and
        only saves) every engine's bulk pull is timed as the save's."""
        Client = ckpt.CheckpointClient
        self._patch(Client, "_snapshot", staticmethod(
            self._within("save", Client._snapshot)))
        self._patch(Client, "restore", self._within("restore",
                                                    Client.restore))
        self._patch(ckpt, "_verify_on", self._within("verify",
                                                     ckpt._verify_on))
        self._patch(svc_base, "fletcher64_many", self._fletcher_many)
        self._patch(ckpt, "host_copy",
                    self._timed("card to host", ckpt.host_copy))
        self._patch(ckpt, "host_to_tensor",
                    self._timed("host to card", ckpt.host_to_tensor))
        if server_engine is None:
            self._patch(Engine, "pull", self._timed("bulk pull", Engine.pull,
                                                    kind="save"))
            return
        # the server pulls a save on its handler thread, before verifying
        self._patch(server_engine, "pull", self._timed(
            "bulk pull", server_engine.pull, kind="save"))
        self._patch(client_engine, "pull", self._timed(
            "bulk pull", client_engine.pull))

    def uninstall(self):
        for owner, attr, orig in reversed(self._patched):
            if orig is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, orig)
        self._patched = []

    def _fletcher_many(self, xs):
        if not all(isinstance(x, torch.Tensor) for x in xs):
            # a data feeder's numpy batch (bulk mode): host checksums of
            # the feed, no part of the checkpoint path
            return fl.fletcher64_many(xs)
        before = fl.fletcher64.launches
        out = self._timed("checksums", fl.fletcher64_many)(xs)
        nbytes = sum(x.numel() * x.element_size() for x in xs)
        kind = self._kind()
        self.batches[kind] = self.batches.get(kind, 0) + 1
        rec = self.seen.setdefault(("fletcher64", kind, len(xs), nbytes),
                                   {"launches": 0})
        rec["launches"] += fl.fletcher64.launches - before
        rec["inputs"] = [x.detach().clone() for x in xs]
        return out

    def by_kind(self):
        n = {kind: 0 for kind in self.KINDS}
        for key, rec in self.seen.items():
            n[key[1]] = n.get(key[1], 0) + rec["launches"]
        return n


def greedy_tokens(model, params):
    serve = ServeEngine(model, params, max_len=64, n_slots=1,
                        device="cuda")
    prompt = np.random.default_rng(5).integers(1, model.cfg.vocab, 24)
    return serve.generate([prompt], max_new=8)[0]


def checkpoint_path():
    """Phase 3c: full-width qwen1.5-0.5b weights through the checkpoint
    service and back, Fletcher-64 counts zeroed just before and read
    just after; returns the recorder."""
    cfg = configs.get(ARCH)
    model = Model(cfg)
    params = model.init(3, device="cuda")
    named = svc_base.flatten_named(params)
    nbytes = sum(t.numel() * t.element_size() for t in named.values())
    server_e = Engine("tcp://127.0.0.1:0")
    client_e = Engine("tcp://127.0.0.1:0")
    recorder = CheckpointRecorder()
    recorder.install(server_e, client_e)
    fl.fletcher64.launches = 0
    try:
        server = ckpt.CheckpointServer(server_e)       # verifies on the card
        client = ckpt.CheckpointClient(client_e, server_e.uri)
        t0 = time.monotonic()
        out = client.save("qwen", 1, params)
        t_save = time.monotonic() - t0
        check(out["ok"] and out["stored"] == len(named), f"save: {out}")
        t0 = time.monotonic()
        restored, step = client.restore("qwen", params)
        torch.cuda.synchronize()
        t_restore = time.monotonic() - t0
        spans = dict(recorder.seconds)
        check(step == 1, f"restore: step {step}")
        # one byte flipped in the middle of the largest stored shard
        key = max(named, key=lambda k: named[k].numel())
        stored = server.store[("qwen", 1)]["named"][key].reshape(-1).view(
            np.uint8)
        stored[stored.size // 2] ^= 0x10
        try:
            client.restore("qwen", params)
            caught = None
        except MercuryError as e:
            caught = e
        check(caught is not None and caught.ret == Ret.CHECKSUM_ERROR,
              f"a flipped byte in {key} was not caught: {caught!r}")
        print(f"checkpoint: flipped byte in {key} -> {caught}")
    finally:
        recorder.uninstall()
        client_e.shutdown()
        server_e.shutdown()
    launches = fl.fletcher64.launches
    by_kind = recorder.by_kind()
    print(f"checkpoint: {len(named)} shards, {nbytes} bytes; save "
          f"{t_save:.2f}s, restore {t_restore:.2f}s (host wall-clock, tcp "
          f"on one host); fletcher64 {launches} launches (one a batch), by "
          f"step {by_kind}, checksum batches by step {recorder.batches} "
          f"(1 save, 2 restores: the second with a flipped byte; the "
          f"server verifies in groups of up to {ckpt.VERIFY_GROUP_BYTES} "
          f"bytes)")
    print("checkpoint: host seconds by step and part (save includes the "
          "server's pull and verify): "
          + json.dumps({k: round(v, 4) for k, v in sorted(spans.items())}))
    check(sum(by_kind.values()) == launches and set(by_kind)
          == set(CheckpointRecorder.KINDS),
          f"checkpoint: checksums outside save/verify/restore {by_kind}")
    check(all(v > 0 for v in by_kind.values()),
          f"checkpoint: fletcher64 not launched on every step {by_kind}")
    check(by_kind == recorder.batches and by_kind["save"] == 1
          and by_kind["restore"] == 2 and by_kind["verify"] < len(named),
          f"checkpoint: expected one launch a batch, one batch a save and "
          f"a restore and fewer than a shard's each to verify: launches "
          f"{by_kind}, batches {recorder.batches}")
    got = svc_base.flatten_named(restored)
    for k, t in named.items():
        check(got[k].device.type == "cuda" and got[k].dtype == t.dtype
              and torch.equal(got[k], t), f"restore: {k} differs")
    want_tok = greedy_tokens(model, params)
    got_tok = greedy_tokens(model, restored)
    print(f"checkpoint: greedy tokens original {want_tok} restored "
          f"{got_tok}")
    check(got_tok == want_tok, "restored weights serve other tokens")
    return recorder


# ---------------------------------------------------------------------------
# phase 3g: training
# ---------------------------------------------------------------------------
class TrainRecorder:
    """What the training path gives the kernels.  Wraps ``Model.loss_fn``
    (the forward, kind "forward") and the train step's ``loss_and_grads``
    (around it: autograd's backward, with the forward recomputed there
    under remat, kind "backward"), the attention, router, SSD and RG-LRU
    the layers call, the MoE combine's raw launches (its forward inside
    ``CombineFunction``) and the raw backward launches the autograd
    Functions reach, and the loss head's cross entropy launches; keeps the
    launches the wrappers counted per (kernel, kind, shape), the inputs of
    the last launch, each step's launches of every kernel (``KERNELS``
    order) and the cross entropy launches each step's loss should make
    (``ce_launches``)."""

    KERNELS = ("flash_attention", "flash_attention_bwd", "moe_router",
               "moe_router_bwd", "ssd", "ssd_bwd", "rglru", "rglru_bwd",
               "moe_combine", "moe_combine_bwd", "cross_entropy")

    def __init__(self):
        self.kind = "outside the train step"
        self.seen = {}
        self.per_step = []              # launches a step, KERNELS order
        self.ce_want = []               # ce_launches of each step's loss
        self._orig = {}

    @staticmethod
    def counts():
        return (fa.attention.launches, fa.attention_bwd.launches,
                kr.router_dispatch.launches, kr.router_bwd.launches,
                kssd.ssd.launches, kssd.ssd_bwd.launches,
                krg.rglru.launches, krg.rglru_bwd.launches,
                kc.moe_combine.launches, kc.moe_combine_bwd.launches,
                kce.cross_entropy.launches)

    def install(self):
        self._orig = {"loss_fn": Model.loss_fn,
                      "loss_and_grads": train_step.loss_and_grads}

        def within(kind, fn):
            def run(*a, **kw):
                outer, self.kind = self.kind, kind
                try:
                    return fn(*a, **kw)
                finally:
                    self.kind = outer
            return run

        step = within("backward", self._orig["loss_and_grads"])

        def counted_step(model, params, batch, **kw):
            self.ce_want.append(ce_launches(batch["targets"].shape[1],
                                            kw.get("spmd")))
            before = self.counts()
            out = step(model, params, batch, **kw)
            self.per_step.append(tuple(
                n - b for n, b in zip(self.counts(), before)))
            return out
        Model.loss_fn = within("forward", self._orig["loss_fn"])
        train_step.loss_and_grads = counted_step
        attn_layer.attention = self._attention
        fa._attention_bwd_cuda = self._bwd
        moe_layer.router_dispatch = self._router
        kr._router_bwd_cuda = self._router_bwd
        kc._moe_combine_cuda = self._combine
        kc._moe_combine_bwd_cuda = self._combine_bwd
        ssd_block.ssd = self._ssd
        kssd._ssd_bwd_cuda = self._ssd_bwd
        rglru_block.rglru = self._rglru
        krg._rglru_bwd_cuda = self._rglru_bwd
        kce._cross_entropy_cuda = self._cross_entropy

    def uninstall(self):
        Model.loss_fn = self._orig["loss_fn"]
        train_step.loss_and_grads = self._orig["loss_and_grads"]
        attn_layer.attention = fa.attention
        fa._attention_bwd_cuda = _ATTENTION_BWD_CUDA
        moe_layer.router_dispatch = kr.router_dispatch
        kr._router_bwd_cuda = _ROUTER_BWD_CUDA
        kc._moe_combine_cuda = _COMBINE_CUDA
        kc._moe_combine_bwd_cuda = _COMBINE_BWD_CUDA
        ssd_block.ssd = kssd.ssd
        kssd._ssd_bwd_cuda = _SSD_BWD_CUDA
        rglru_block.rglru = krg.rglru
        krg._rglru_bwd_cuda = _RGLRU_BWD_CUDA
        kce._cross_entropy_cuda = _CROSS_ENTROPY_CUDA

    def _record(self, key, launches, inputs):
        rec = self.seen.setdefault(key, {"launches": 0})
        rec["launches"] += launches
        rec["inputs"] = inputs

    def _attention(self, q, k, v, **kw):
        before = fa.attention.launches
        out = fa.attention(q, k, v, **kw)
        B, S, Hq, D = q.shape
        self._record(("flash_attention", self.kind, B, S, k.shape[1], Hq,
                      k.shape[2], D, q.dtype, mask_tag(kw)),
                     fa.attention.launches - before,
                     tuple(x.detach().clone() for x in (q, k, v)) + (kw,))
        return out

    def _rglru(self, x, r_gate, i_gate, log_lambda, h0=None):
        before = krg.rglru.launches
        out = krg.rglru(x, r_gate, i_gate, log_lambda, h0)
        clone = (lambda t: None if t is None else t.detach().clone())
        self._record(("rglru", self.kind) + tuple(x.shape) + (x.dtype,),
                     krg.rglru.launches - before,
                     tuple(map(clone, (x, r_gate, i_gate, log_lambda, h0))))
        return out

    def _rglru_bwd(self, x, r_gate, i_gate, log_lambda, h0, dh, dh_final,
                   states):
        before = krg.rglru_bwd.launches
        out = _RGLRU_BWD_CUDA(x, r_gate, i_gate, log_lambda, h0, dh,
                              dh_final, states)
        clone = (lambda t: None if t is None else t.detach().clone())
        self._record(("rglru_bwd", self.kind) + tuple(x.shape) + (x.dtype,),
                     krg.rglru_bwd.launches - before,
                     tuple(map(clone, (x, r_gate, i_gate, log_lambda, h0, dh,
                                       dh_final, states))))
        return out

    def _bwd(self, q, k, v, o, lse, do, **kw):
        before = fa.attention_bwd.launches
        out = _ATTENTION_BWD_CUDA(q, k, v, o, lse, do, **kw)
        B, S, Hq, D = q.shape
        self._record(("flash_attention_bwd", self.kind, B, S, k.shape[1], Hq,
                      k.shape[2], D, q.dtype, mask_tag(kw)),
                     fa.attention_bwd.launches - before,
                     tuple(x.detach().clone() for x in (q, k, v, o, lse, do))
                     + (kw,))
        return out

    def _router(self, logits, k, *, n_real, capacity, dispatch="sort",
                e_start=0, e_local=None):
        before = kr.router_dispatch.launches
        out = kr.router_dispatch(logits, k, n_real=n_real, capacity=capacity,
                                 dispatch=dispatch, e_start=e_start,
                                 e_local=e_local)
        self._record(("moe_router", self.kind) + tuple(logits.shape)
                     + (k, n_real, capacity, e_start, e_local),
                     kr.router_dispatch.launches - before,
                     (logits.detach().clone(), k, n_real, capacity, e_start,
                      e_local))
        return out

    def _router_bwd(self, logits, probs, idx, w, dw, dprob_sum, dz_sum, *,
                    n_real):
        before = kr.router_bwd.launches
        out = _ROUTER_BWD_CUDA(logits, probs, idx, w, dw, dprob_sum, dz_sum,
                               n_real=n_real)
        clone = (lambda t: None if t is None else t.detach().clone())
        self._record(("moe_router_bwd", self.kind) + tuple(logits.shape)
                     + (idx.shape[1], n_real),
                     kr.router_bwd.launches - before,
                     tuple(map(clone, (logits, probs, idx, w, dw, dprob_sum,
                                       dz_sum))) + (n_real,))
        return out

    def _combine(self, out_buf, w, slot):
        before = kc.moe_combine.launches
        out = _COMBINE_CUDA(out_buf, w, slot)
        self._record(("moe_combine", self.kind) + tuple(slot.shape)
                     + tuple(out_buf.shape) + (out_buf.dtype,),
                     kc.moe_combine.launches - before,
                     tuple(t.detach().clone() for t in (out_buf, w, slot)))
        return out

    def _combine_bwd(self, dy, out_buf, logits, probs, idx, w, slot, src,
                     dprob_sum, dz_sum, *, n_real):
        before = kc.moe_combine_bwd.launches
        out = _COMBINE_BWD_CUDA(dy, out_buf, logits, probs, idx, w, slot,
                                src, dprob_sum, dz_sum, n_real=n_real)
        clone = (lambda t: None if t is None else t.detach().clone())
        self._record(("moe_combine_bwd", self.kind) + tuple(slot.shape)
                     + tuple(out_buf.shape) + (logits.shape[1], n_real,
                                               out_buf.dtype),
                     kc.moe_combine_bwd.launches - before,
                     tuple(map(clone, (dy, out_buf, logits, probs, idx, w,
                                       slot, src, dprob_sum, dz_sum)))
                     + (n_real,))
        return out

    def _ssd(self, x, dt, A, B, C, D=None, h0=None, *, chunk=256):
        before = kssd.ssd.launches
        out = kssd.ssd(x, dt, A, B, C, D, h0, chunk=chunk)
        clone = (lambda t: None if t is None else t.detach().clone())
        self._record(("ssd", self.kind) + tuple(x.shape) + tuple(B.shape[2:])
                     + (x.dtype,), kssd.ssd.launches - before,
                     tuple(map(clone, (x, dt, A, B, C, D, h0))) + (chunk,))
        return out

    def _ssd_bwd(self, x, dt, A, B, C, D, h0, dy, dh, states, decay, **kw):
        before = kssd.ssd_bwd.launches
        out = _SSD_BWD_CUDA(x, dt, A, B, C, D, h0, dy, dh, states, decay,
                            **kw)
        clone = (lambda t: None if t is None else t.detach().clone())
        self._record(("ssd_bwd", self.kind) + tuple(x.shape)
                     + tuple(B.shape[2:]) + (x.dtype,),
                     kssd.ssd_bwd.launches - before,
                     tuple(map(clone, (x, dt, A, B, C, D, h0, dy, dh, states,
                                       decay))))
        return out

    def _cross_entropy(self, logits, targets, n_tok, **kw):
        # the logits before the kernel writes their gradient over them, on
        # the host: the largest input any recorder keeps (1.2 GB at the
        # benchmark cell's chunk), which the card's peak, the optimizer's
        # after the loss, should not hold
        inputs = (logits.detach().cpu(), targets.cpu(), n_tok.cpu(), kw)
        before = kce.cross_entropy.launches
        out = _CROSS_ENTROPY_CUDA(logits, targets, n_tok, **kw)
        self._record(("cross_entropy", self.kind) + tuple(logits.shape)
                     + (logits.dtype, kw["softcap"], kw["grad"]),
                     kce.cross_entropy.launches - before, inputs)
        return out

    def by_kind(self, kernel):
        n = {"forward": 0, "backward": 0}
        for key, rec in self.seen.items():
            if key[0] == kernel:
                n[key[1]] = n.get(key[1], 0) + rec["launches"]
        return n


EXPERT_FFN = moe_layer._expert_ffn
_ATTENTION_BWD_CUDA = fa._attention_bwd_cuda
_ROUTER_BWD_CUDA = kr._router_bwd_cuda
_COMBINE_CUDA = kc._moe_combine_cuda
_COMBINE_BWD_CUDA = kc._moe_combine_bwd_cuda
_SSD_BWD_CUDA = kssd._ssd_bwd_cuda
_SSD_CUDA = kssd._ssd_cuda
_RGLRU_BWD_CUDA = krg._rglru_bwd_cuda
_CROSS_ENTROPY_CUDA = kce._cross_entropy_cuda
TRAIN_COUNTED = (fa.attention, fa.attention_bwd, kr.router_dispatch,
                 kr.router_bwd, kssd.ssd, kssd.ssd_bwd, krg.rglru,
                 krg.rglru_bwd, kc.moe_combine, kc.moe_combine_bwd,
                 kce.cross_entropy)
CE_CHUNK = 512          # Model.loss_fn's ce_chunk


def ce_launches(seq, spmd=None) -> int:
    """The cross entropy launches of one loss over ``seq`` target
    positions: one a chunk of CE_CHUNK where the vocabulary is whole, none
    where ``spmd`` splits it (the vocabulary-parallel loss)."""
    if spmd is not None and spmd.split(("embed",)) is not None:
        return 0
    return -(-seq // min(CE_CHUNK, seq))


def layer_counts(model) -> dict:
    """Layers a model trains through each kernel: attention (self
    attention, and an encoder-decoder's encoder layers and decoder cross
    attention), MoE (router), SSD and RG-LRU."""
    cfg = model.cfg
    n_moe = (cfg.n_layers - model.prefix_count
             if cfg.moe.num_experts and cfg.d_ff > 0 else 0)
    cross = cfg.n_layers if model.is_encdec else 0
    return {"attn": sum(k in ATTN_KINDS for k in model.kinds)
            + cfg.n_enc_layers + cross,
            "moe": n_moe, "ssd": model.kinds.count("ssd"),
            "rglru": model.kinds.count("rglru")}


def check_train_launches(tag, model, recorder, n_steps, remat):
    """Every kernel of the model's layers launched on every step and
    nowhere outside the step: each forward once a layer and step in
    ``loss_fn`` (and again in the backward under remat "block"), each
    backward once a layer and step in the step's autograd; a kernel of
    no layer never.  A MoE layer's router gradient comes from the
    combine's backward, so ``moe_router_bwd`` never launches in
    training.  The loss head's cross entropy launches ``ce_launches`` a
    step, all in ``loss_fn`` (the head is no block: remat forms it once).
    Returns the launches a step (``TrainRecorder.KERNELS``)."""
    n = layer_counts(model)
    ce = set(recorder.ce_want)
    check(len(ce) == 1, f"{tag}: steps of differing losses {ce}")
    per_layer = {"flash_attention": n["attn"], "flash_attention_bwd":
                 n["attn"], "moe_router": n["moe"], "moe_router_bwd": 0,
                 "ssd": n["ssd"], "ssd_bwd": n["ssd"],
                 "rglru": n["rglru"], "rglru_bwd": n["rglru"],
                 "moe_combine": n["moe"], "moe_combine_bwd": n["moe"],
                 "cross_entropy": ce.pop()}
    again = remat == "block"

    def twice(k):
        return again and not k.endswith("_bwd") and k != "cross_entropy"
    want_step = tuple(per_layer[k] * (2 if twice(k) else 1)
                      for k in TrainRecorder.KERNELS)
    for kernel in TrainRecorder.KERNELS:
        got = recorder.by_kind(kernel)
        m = per_layer[kernel] * n_steps
        want = ({"forward": 0, "backward": m} if kernel.endswith("_bwd")
                else {"forward": m, "backward": m if twice(kernel) else 0})
        print(f"{tag}: {kernel} launches {got}")
        check(got == want, f"{tag}: {kernel} launches {got}, expected "
              f"{want}")
    print(f"{tag}: launches a step {dict(zip(TrainRecorder.KERNELS, want_step))}"
          f"; seen {sorted(set(recorder.per_step))}")
    check(len(recorder.per_step) == n_steps
          and set(recorder.per_step) == {want_step},
          f"{tag}: a step's launches {recorder.per_step}, expected "
          f"{want_step}")
    return want_step


def train_source(cfg, seq=None, batch=None, seed=0):
    """The launchers' SyntheticSource for ``cfg`` (with its frontend, if it
    takes one), TRAIN_SEQ x TRAIN_BATCH unless given."""
    frontend = ((cfg.frontend_seq, cfg.frontend_dim)
                if cfg.frontend != "none" else None)
    return SyntheticSource(cfg.vocab, seq or TRAIN_SEQ, batch or TRAIN_BATCH,
                           seed=seed, frontend=frontend)


def train_batch(source, step, cfg=None):
    """``source``'s batch at ``step`` on the card; a VLM's targets padded
    over its patches, as the launcher pads them."""
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in source.batch_at(step).items()}
    if cfg is not None and cfg.family == "vlm":
        batch["targets"] = train_launcher.vlm_targets(batch["targets"],
                                                      cfg.frontend_seq)
    return batch


def train_path():
    """Phase 3g: full-width qwen1.5-0.5b training through the launcher
    and its services, then one 4 x 1024 step with remat "block", then the
    restart check.  Returns the recorder of the two training runs
    (attention's forward and backward rows for phase 4) and the
    checkpoint recorder (Fletcher's)."""
    recorder, ckrec = TrainRecorder(), CheckpointRecorder()
    recorder.install()
    ckrec.install()
    for fn in TRAIN_COUNTED + (fl.fletcher64,):
        fn.launches = 0
    try:
        out = train_launcher.main(["--arch", ARCH])
        fletcher = fl.fletcher64.launches
    finally:
        ckrec.uninstall()
        recorder.uninstall()
    losses = out["losses"]
    # steps without a save, the first (warm-up) left out
    plain_steps = [t for i, t in enumerate(out["step_seconds"])
                   if i and (i + 1) % TRAIN_CKPT_EVERY]
    step_s = float(np.median(plain_steps))
    print(f"train: {len(losses)} steps of {TRAIN_BATCH}x{TRAIN_SEQ}, "
          f"losses {losses}; {out['seconds']:.3f} s, "
          f"{len(losses) / out['seconds']:.4f} steps/s, "
          f"{out['tokens'] / out['seconds']:.1f} tokens/s (host "
          f"wall-clock, checkpoints included; information only); a step "
          f"without a save: median {step_s * 1e3:.2f} ms "
          f"({TRAIN_BATCH * TRAIN_SEQ / step_s:.1f} tokens/s), first "
          f"{out['step_seconds'][0] * 1e3:.1f} ms; step seconds "
          f"{out['step_seconds']}")
    print("train: save host seconds by part (snapshot on the trainer; "
          "pull and verify on the server's handler thread): "
          + json.dumps({k: round(v, 4)
                        for k, v in sorted(ckrec.seconds.items())}))
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"train: non-finite loss {losses}")
    check(float(np.mean(losses[-5:])) < losses[0],
          f"train: the loss did not fall {losses}")
    cfg = configs.get(ARCH)
    model = Model(cfg)
    check_train_launches("train", model, recorder, TRAIN_STEPS, "none")
    saves = TRAIN_STEPS // TRAIN_CKPT_EVERY
    by_kind = ckrec.by_kind()
    print(f"train: fletcher64 {fletcher} launches, by step {by_kind}, "
          f"checksum batches {ckrec.batches}; checkpoints "
          f"{[c['step'] for c in out['checkpoints']]}")
    check(by_kind["save"] == saves and by_kind["verify"] >= saves
          and by_kind["restore"] == 0 and sum(by_kind.values()) == fletcher,
          f"train: expected a checksum batch a save ({saves}) and the "
          f"server's verify groups: {by_kind}")
    check([c["step"] for c in out["checkpoints"]]
          == [TRAIN_CKPT_EVERY * (i + 1) for i in range(saves)],
          f"train: checkpoints {out['checkpoints']}")
    free_card()

    # one step at 4 x 1024, remat "block"
    long_rec = TrainRecorder()
    long_rec.install()
    for fn in TRAIN_COUNTED:
        fn.launches = 0
    try:
        ocfg = optim.OptConfig(warmup=5, decay_steps=TRAIN_STEPS)
        state = train_step.init_state(model, ocfg, 0, device="cuda")
        step = train_step.make_train_step(model, ocfg,
                                          ParallelConfig(remat="block"))
        batch = train_batch(SyntheticSource(cfg.vocab, LONG_TRAIN["seq"],
                                            LONG_TRAIN["batch"]), 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        dt = time.monotonic() - t0
    finally:
        long_rec.uninstall()
    toks = LONG_TRAIN["batch"] * LONG_TRAIN["seq"]
    long_tag = f"train {LONG_TRAIN['batch']}x{LONG_TRAIN['seq']}"
    print(f"{long_tag} remat block: one step {dt:.3f} s ({toks / dt:.1f} "
          f"tokens/s, host wall-clock, first call), loss {loss}, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(math.isfinite(loss), f"{long_tag}: loss {loss}")
    check_train_launches(long_tag, model, long_rec, 1, "block")
    del state, batch
    free_card()
    restart_check(model)
    for key, rec in long_rec.seen.items():
        recorder.seen[key[:1] + ("remat-" + key[1],) + key[2:]] = rec
    return recorder, ckrec


def restart_check(model):
    """Train 6 steps straight == train 3, save, restore into a fresh state
    of seed 42, train 3 more (the reference's
    test_checkpoint_restart_determinism, at full width on the card)."""
    ocfg = optim.OptConfig(lr=1e-3, warmup=0, decay_steps=100)
    step = train_step.make_train_step(model, ocfg,
                                      ParallelConfig(remat="none"))
    source = SyntheticSource(model.cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=7)
    state = train_step.init_state(model, ocfg, 0, device="cuda")
    for i in range(6):
        state, _ = step(state, train_batch(source, i))
    direct = svc_base.flatten_named(state["params"])
    del state
    with Engine(None) as e:
        ckpt.CheckpointServer(e, device="cuda")
        client = ckpt.CheckpointClient(e, e.uri)
        state = train_step.init_state(model, ocfg, 0, device="cuda")
        for i in range(3):
            state, _ = step(state, train_batch(source, i))
        client.save("restart", 3, state)
        del state
        fresh = train_step.init_state(model, ocfg, 42, device="cuda")
        restored, at = client.restore("restart", fresh, device="cuda")
        del fresh
        check(at == 3 and int(restored["opt"]["count"]) == 3,
              f"restart: restored step {at}")
        for i in range(3, 6):
            restored, _ = step(restored, train_batch(source, i))
    got = svc_base.flatten_named(restored["params"])
    worst = 0.0
    for key, want in direct.items():
        diff = (got[key] - want).abs() - 1e-5 * want.abs()
        worst = max(worst, float(diff.max()))
    print(f"restart: 6 steps straight against 3 + save + restore (seed 42) "
          f"+ 3: max(|diff| - 1e-5 |want|) = {worst:.3g} (atol 1e-6)")
    check(worst <= 1e-6, "restart: parameters differ")
    del direct, got, restored
    free_card()


def repeat_check(arch, n_layers=None, opt="adamw", microbatches=1,
                 batch=None, seq=None):
    """REPEAT_STEPS steps of ``opt`` (AdamW or Adafactor) twice from one
    seed on the same batches (``batch`` x ``seq``, default TRAIN_BATCH x
    TRAIN_SEQ), each split into ``microbatches``: the parameters must
    agree within REPEAT_ATOL (no atomics on the path); prints whether
    they are bitwise equal.  The first run's parameters wait on the host
    while the second runs, and go back to the card a leaf at a time to
    be compared.  ``n_layers`` cuts the depth (printed)."""
    cfg = configs.get(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    model = Model(cfg)
    ocfg = optim.OptConfig(name=opt, lr=1e-3, warmup=0, decay_steps=100)
    step = train_step.make_train_step(
        model, ocfg, ParallelConfig(remat="none", microbatches=microbatches))
    source = train_source(cfg, seq, batch, seed=7)
    first, losses = None, []
    for _ in range(2):
        state = train_step.init_state(model, ocfg, 0, device="cuda")
        losses.append([])
        for i in range(REPEAT_STEPS):
            state, met = step(state, train_batch(source, i, cfg))
            losses[-1].append(float(met["loss"]))
        params = svc_base.flatten_named(state["params"])
        if first is None:
            first = {k: v.cpu() for k, v in params.items()}
        else:
            # each kept leaf back on the card, compared there
            worst, bitwise = 0.0, True
            for key, kept in first.items():
                got = params[key]
                want = kept.to(got.device)
                bitwise = bitwise and torch.equal(got, want)
                worst = max(worst, float((got - want).abs().max()))
                del want
        del state, params
        free_card()
    print(f"repeat {arch}" + (f" ({n_layers} of {configs.get(arch).n_layers}"
                               f" layers)" if n_layers else "")
          + (f", {opt}" if opt != "adamw" else "")
          + (f", {microbatches} microbatches" if microbatches > 1 else "")
          + (f", {batch or TRAIN_BATCH}x{seq or TRAIN_SEQ}" if batch or seq
             else "")
          + f": {REPEAT_STEPS} steps twice from seed 0: max |diff| "
          f"{worst:.3g} (atol {REPEAT_ATOL}); bitwise equal: {bitwise}; "
          f"losses {losses}")
    check(worst <= REPEAT_ATOL, f"repeat {arch}: parameters differ")
    return bitwise


def report_losses(tag, losses, step_seconds, tokens_a_step):
    """Print the loss curve and the steps' median host ms (the first and
    a saving last step left out) and tokens/s; the loss must be finite
    and the mean of the last 3 under the first."""
    steady = step_seconds[1:-1] or step_seconds
    step_s = float(np.median(steady))
    print(f"{tag}: losses {losses}; a step median {step_s * 1e3:.2f} ms "
          f"({tokens_a_step / step_s:.1f} tokens/s, host wall-clock), "
          f"first {step_seconds[0] * 1e3:.1f} ms; step seconds "
          f"{step_seconds}")
    check(all(map(math.isfinite, losses)), f"{tag}: non-finite loss "
          f"{losses}")
    check(float(np.mean(losses[-3:])) < losses[0],
          f"{tag}: the loss did not fall {losses}")


def ssm_train_path():
    """Phase 3h: full-width, full-depth mamba2-1.3b through the launcher
    (AdamW, 8 x 128, remat "none") and its services, with one save of the
    state at the end (verified on the card).  Returns the training and
    checkpoint recorders."""
    recorder, ckrec = TrainRecorder(), CheckpointRecorder()
    recorder.install()
    ckrec.install()
    for fn in TRAIN_COUNTED + (fl.fletcher64,):
        fn.launches = 0
    try:
        torch.cuda.reset_peak_memory_stats()
        out = train_launcher.main(["--arch", SSM_ARCH, "--steps",
                                   str(SSM_TRAIN_STEPS), "--ckpt-every",
                                   str(SSM_TRAIN_STEPS)])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        fletcher = fl.fletcher64.launches
    finally:
        ckrec.uninstall()
        recorder.uninstall()
    tag = f"train {SSM_ARCH}"
    report_losses(tag, out["losses"], out["step_seconds"],
                  TRAIN_BATCH * TRAIN_SEQ)
    print(f"{tag}: {out['seconds']:.3f} s for {SSM_TRAIN_STEPS} steps and "
          f"the save, peak memory {peak:.2f} GiB; save host seconds by "
          f"part "
          + json.dumps({k: round(v, 4)
                        for k, v in sorted(ckrec.seconds.items())}))
    model = Model(configs.get(SSM_ARCH))
    per_step = check_train_launches(tag, model, recorder, SSM_TRAIN_STEPS,
                                    "none")
    print(f"{tag}: SSD launches a step, forward {per_step[4]}, backward "
          f"{per_step[5]}")
    by_kind = ckrec.by_kind()
    print(f"{tag}: fletcher64 {fletcher} launches, by step {by_kind}, "
          f"checksum batches {ckrec.batches}; checkpoints "
          f"{[c['step'] for c in out['checkpoints']]}")
    check(by_kind["save"] == 1 and by_kind["verify"] >= 1
          and by_kind["restore"] == 0 and sum(by_kind.values()) == fletcher,
          f"{tag}: expected one checksum batch for the save and the "
          f"server's verify groups: {by_kind}")
    check([c["step"] for c in out["checkpoints"]] == [SSM_TRAIN_STEPS],
          f"{tag}: checkpoints {out['checkpoints']}")
    free_card()
    return recorder, ckrec


def train_over_rpc(model, n_steps, ocfg=None, batch=None, seq=None):
    """``n_steps`` of ``make_train_step`` from ``init_state`` (``ocfg``,
    default AdamW warming up over 5 steps; ``batch`` x ``seq``, default
    TRAIN_BATCH x TRAIN_SEQ; remat "none"), batches pulled over RPC from
    a ``DataFeedServer``, a
    ``MembershipClient`` joined and left as the launcher's, no save;
    under a ``TrainRecorder``, the launch counts set to 0 first.  Returns
    (recorder, each step's metrics as floats, step seconds, the parameter
    count, peak GiB)."""
    from repro_torch.services import (DataFeedClient, DataFeedServer,
                                      MembershipClient, MembershipServer)
    ocfg = ocfg or optim.OptConfig(warmup=5, decay_steps=n_steps)
    recorder = TrainRecorder()
    recorder.install()
    for fn in TRAIN_COUNTED:
        fn.launches = 0
    mets, step_seconds = [], []
    try:
        with Engine(None) as trainer, Engine(None) as feeder, \
                Engine(None) as coord:
            DataFeedServer(feeder, train_source(model.cfg, seq, batch))
            feed = DataFeedClient(trainer, [feeder.uri], depth=2)
            MembershipServer(coord)
            member = MembershipClient(trainer, coord.uri, "trainer-0")
            member.join({"role": "trainer"})
            try:
                state = train_step.init_state(model, ocfg, 0, device="cuda")
                n_params = sum(p.numel()
                               for p in optim.leaves(state["params"]))
                step = train_step.make_train_step(
                    model, ocfg, ParallelConfig(remat="none"))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for i in range(n_steps):
                    t0 = time.monotonic()
                    raw = feed.get(i)
                    batch = {k: torch.tensor(raw[k], device="cuda")
                             for k in train_launcher.BATCH_KEYS if k in raw}
                    if model.cfg.family == "vlm":
                        batch["targets"] = train_launcher.vlm_targets(
                            batch["targets"], model.cfg.frontend_seq)
                    state, met = step(state, batch)
                    mets.append({k: float(v) for k, v in met.items()})
                    step_seconds.append(time.monotonic() - t0)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                del state, batch, met
            finally:
                member.leave()
    finally:
        recorder.uninstall()
    return recorder, mets, step_seconds, n_params, peak


def moe_train_path():
    """Phase 3i: full-width, full-depth granite-moe-3b-a800m through
    ``train_over_rpc``.  Returns the training recorder."""
    model = Model(configs.get(MOE_ARCH))
    recorder, mets, step_seconds, _, peak = train_over_rpc(model,
                                                           MOE_TRAIN_STEPS)
    tag = f"train {MOE_ARCH}"
    report_losses(tag, [m["loss"] for m in mets], step_seconds,
                  TRAIN_BATCH * TRAIN_SEQ)
    aux = [(m["moe_lb"], m["moe_z"]) for m in mets]
    print(f"{tag}: (moe_lb, moe_z) by step {aux}; peak memory "
          f"{peak:.2f} GiB")
    check(all(math.isfinite(a) and math.isfinite(b) and a > 0 and b > 0
              for a, b in aux), f"{tag}: aux losses {aux}")
    per_step = check_train_launches(tag, model, recorder, MOE_TRAIN_STEPS,
                                    "none")
    print(f"{tag}: router launches a step, forward {per_step[2]}, backward "
          f"{per_step[3]}; combine forward {per_step[8]}, backward "
          f"{per_step[9]}; attention forward {per_step[0]}, backward "
          f"{per_step[1]}")
    free_card()
    return recorder


def hybrid_train_path():
    """Phase 3j: recurrentgemma-9b at full width, cut to
    HYBRID_TRAIN_LAYERS layers, through ``train_over_rpc`` in the
    config's bf16 compute.  Returns the training recorder."""
    full = configs.get(HYBRID_ARCH)
    model = Model(full.replace(n_layers=HYBRID_TRAIN_LAYERS))
    recorder, mets, step_seconds, n_params, peak = train_over_rpc(
        model, HYBRID_TRAIN_STEPS)
    tag = (f"train {HYBRID_ARCH} ({HYBRID_TRAIN_LAYERS} of {full.n_layers} "
           f"layers)")
    report_losses(tag, [m["loss"] for m in mets], step_seconds,
                  TRAIN_BATCH * TRAIN_SEQ)
    print(f"{tag}: {n_params} parameters, AdamW, "
          f"{model.cfg.compute_dtype} compute; peak memory {peak:.2f} GiB")
    per_step = check_train_launches(tag, model, recorder, HYBRID_TRAIN_STEPS,
                                    "none")
    print(f"{tag}: launches a step, RG-LRU forward {per_step[6]}, backward "
          f"{per_step[7]}; attention forward {per_step[0]}, backward "
          f"{per_step[1]}")
    free_card()
    return recorder


def train_breadth_path(row):
    """Phases 3s-3u: one row of TRAIN_BREADTH (phase, arch, layers,
    optimizer, learning rate, batch, seq, steps) at full width through
    ``train_over_rpc``, in the config's bf16 compute on f32 weights.
    Prints the reckoned bytes of the parameters, gradients and optimizer
    state before they are made and the card's peak over the steps beside
    them; the loss must fall, and every kernel of the model's layers
    launch on every step (``check_train_launches``); prints the kernels'
    shapes (attention's masks: the local layers' window at 2 x 1536; the
    router's (T, E), k and capacity).  Then the repeat check at the same
    cut and shape.  Returns the training recorder."""
    phase, arch, layers, opt, lr, batch, seq, steps = row
    full = configs.get(arch)
    model = Model(full.replace(n_layers=layers))
    tag = (f"train {arch} ({layers} of {full.n_layers} layers, {opt} at "
           f"lr {lr}, {batch}x{seq})")
    reckoned = train_state_bytes(arch, layers, opt)
    print(f"{tag}: reckoned bytes (parameters, gradients, optimizer "
          f"state) {json.dumps(reckoned)} ({reckoned['total'] / 1e9:.2f} "
          f"GB)", flush=True)
    ocfg = optim.OptConfig(name=opt, lr=lr, warmup=5, decay_steps=steps)
    recorder, mets, step_seconds, n_params, peak = train_over_rpc(
        model, steps, ocfg, batch=batch, seq=seq)
    report_losses(tag, [m["loss"] for m in mets], step_seconds, batch * seq)
    peak_bytes = int(peak * 2 ** 30)
    print(f"{tag}: {n_params} parameters, {model.cfg.param_dtype} weights, "
          f"{model.cfg.compute_dtype} compute; card peak over the steps "
          f"{peak_bytes} bytes ({peak_bytes / 1e9:.2f} GB) beside the "
          f"reckoned state {reckoned['total']} bytes "
          f"({reckoned['total'] / 1e9:.2f} GB): "
          f"{peak_bytes / reckoned['total']:.3f}x")
    if model.cfg.moe.num_experts:
        aux = [(m["moe_lb"], m["moe_z"]) for m in mets]
        print(f"{tag}: (moe_lb, moe_z) by step {aux}")
        check(all(math.isfinite(a) and math.isfinite(b) and a > 0 and b > 0
                  for a, b in aux), f"{tag}: aux losses {aux}")
    per_step = check_train_launches(tag, model, recorder, steps, "none")
    shapes = sorted({key[:1] + key[2:] for key in recorder.seen
                     if key[0] in ("flash_attention", "moe_router")},
                    key=lambda k: tuple(map(str, k)))
    print(f"{tag}: launches a step "
          f"{dict(zip(TrainRecorder.KERNELS, per_step))}; attention and "
          f"router shapes {[tuple(map(str, k)) for k in shapes]}")
    if "local" in model.kinds:
        # the local layers' forward and backward at a sequence longer
        # than their window
        windowed = {k[0] for k in recorder.seen
                    if k[-1] == mask_tag({"window": full.window})}
        check(seq > full.window and windowed == {"flash_attention",
                                                 "flash_attention_bwd"},
              f"{tag}: the window of {full.window} did not bind: "
              f"{windowed}")
    if model.cfg.moe.num_experts:
        routed = [k for k in recorder.seen if k[0] == "moe_router"]
        want = (batch * seq, full.moe.num_experts, full.moe.top_k)
        check(routed and all(k[2:5] == want for k in routed),
              f"{tag}: the router ran at {routed}, expected (T, E, k) "
              f"{want}")
    free_card()
    repeat_check(arch, n_layers=layers, opt=opt, batch=batch, seq=seq)
    return recorder


def optimizer_path():
    """Phase 3r: qwen1.5-0.5b at full width, 8 x 128: OPT_STEPS steps
    with Adafactor through ``train_over_rpc`` (``init_state`` /
    ``make_train_step``, batches over RPC), then OPT_STEPS steps of the
    launcher with ``--microbatches`` OPT_MICROBATCHES (AdamW, its save
    at the end), each under a ``TrainRecorder`` (attention's forward and
    backward once a layer and microbatch), its loss falling, and each
    followed by its repeat check.  Returns the two recorders."""
    model = Model(configs.get(ARCH))
    ocfg = optim.OptConfig(name="adafactor", warmup=5, decay_steps=OPT_STEPS)
    recorder, mets, step_seconds, _, peak = train_over_rpc(model, OPT_STEPS,
                                                           ocfg)
    tag = f"train {ARCH} adafactor"
    report_losses(tag, [m["loss"] for m in mets], step_seconds,
                  TRAIN_BATCH * TRAIN_SEQ)
    print(f"{tag}: peak memory {peak:.2f} GiB")
    check_train_launches(tag, model, recorder, OPT_STEPS, "none")
    free_card()
    repeat_check(ARCH, opt="adafactor")

    micro = TrainRecorder()
    micro.install()
    for fn in TRAIN_COUNTED:
        fn.launches = 0
    try:
        out = train_launcher.main(["--arch", ARCH, "--steps", str(OPT_STEPS),
                                   "--ckpt-every", str(OPT_STEPS),
                                   "--microbatches", str(OPT_MICROBATCHES)])
    finally:
        micro.uninstall()
    tag = f"train {ARCH} {OPT_MICROBATCHES} microbatches"
    report_losses(tag, out["losses"], out["step_seconds"],
                  TRAIN_BATCH * TRAIN_SEQ)
    check_train_launches(tag, model, micro, OPT_STEPS * OPT_MICROBATCHES,
                         "none")
    free_card()
    repeat_check(ARCH, microbatches=OPT_MICROBATCHES)
    return recorder, micro


def frontend_train_path(arch):
    """Phases 3k and 3l's training at full width and depth, 8 x 128 text
    tokens with their seeded frontends (paligemma's 256 patches join the
    sequence, its targets padded over them; seamless's 512 frames go
    through the encoder), AdamW, bf16 compute, remat "none",
    FRONTEND_TRAIN_STEPS steps: seamless through the launcher and its
    services with one save of params, m and v at the end (verified on the
    card: Fletcher-64 on this path), paligemma through
    ``train_over_rpc``.  The loss must fall; attention's forward and
    backward launch once a layer and step (seamless: encoder, decoder
    self and cross attention).  Then the repeat check, which must be
    bitwise.  Returns the recorders for phase 4."""
    cfg = configs.get(arch)
    model = Model(cfg)
    tag = f"train {arch}"
    recorders = []
    if arch == ENCDEC_ARCH:
        recorder, ckrec = TrainRecorder(), CheckpointRecorder()
        recorder.install()
        ckrec.install()
        for fn in TRAIN_COUNTED + (fl.fletcher64,):
            fn.launches = 0
        try:
            torch.cuda.reset_peak_memory_stats()
            out = train_launcher.main([
                "--arch", arch, "--steps", str(FRONTEND_TRAIN_STEPS),
                "--ckpt-every", str(FRONTEND_TRAIN_STEPS)])
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            fletcher = fl.fletcher64.launches
        finally:
            ckrec.uninstall()
            recorder.uninstall()
        losses, step_seconds = out["losses"], out["step_seconds"]
        by_kind = ckrec.by_kind()
        print(f"{tag}: {out['seconds']:.3f} s for {FRONTEND_TRAIN_STEPS} "
              f"steps and the save, peak memory {peak:.2f} GiB; save host "
              f"seconds by part "
              + json.dumps({k: round(v, 4)
                            for k, v in sorted(ckrec.seconds.items())})
              + f"; fletcher64 {fletcher} launches, by step {by_kind}, "
              f"checksum batches {ckrec.batches}")
        check(by_kind["save"] == 1 and by_kind["verify"] >= 1
              and by_kind["restore"] == 0
              and sum(by_kind.values()) == fletcher,
              f"{tag}: expected one checksum batch for the save and the "
              f"server's verify groups: {by_kind}")
        check([c["step"] for c in out["checkpoints"]]
              == [FRONTEND_TRAIN_STEPS], f"{tag}: checkpoints "
              f"{out['checkpoints']}")
        recorders.append(ckrec)
    else:
        recorder, mets, step_seconds, n_params, peak = train_over_rpc(
            model, FRONTEND_TRAIN_STEPS)
        losses = [m["loss"] for m in mets]
        print(f"{tag}: {n_params} parameters, AdamW, {cfg.compute_dtype} "
              f"compute; peak memory {peak:.2f} GiB")
    report_losses(tag, losses, step_seconds, TRAIN_BATCH * TRAIN_SEQ)
    per_step = check_train_launches(tag, model, recorder,
                                    FRONTEND_TRAIN_STEPS, "none")
    print(f"{tag}: attention launches a step, forward {per_step[0]}, "
          f"backward {per_step[1]}")
    free_card()
    check(repeat_check(arch), f"repeat {arch}: not bitwise equal")
    return [recorder] + recorders


# ---------------------------------------------------------------------------
# phase 4: the main paths' own shapes
# ---------------------------------------------------------------------------
def phase_main_shapes(arch, recorder):
    """Each kernel against plain, timed and bounded, on the inputs of the
    last launch of each (kernel, entry point, shape) of a main path."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    rows = []
    for key in sorted(recorder.seen, key=lambda k: tuple(map(str, k))):
        rec = recorder.seen[key]
        inputs = rec.pop("inputs")
        name = f"{arch}:{key[1]}"
        if key[0] in ("flash_attention", "flash_attention_bwd"):
            name += key[-1]             # the mask, past plain causal
        if key[0] == "flash_attention":
            q, k, v, kw = inputs
            # an int offset as a 0-d device tensor: the same function, and
            # no host-to-device copy when the call is timed in a graph
            kw = dict(kw, q_offset=torch.as_tensor(
                kw["q_offset"], device=q.device).clone())
            row = check_kernel(name, q, k, v, kw, flush)
        elif key[0] == "flash_attention_bwd":
            row = check_bwd(name, *inputs, flush=flush)
        elif key[0] == "moe_router":
            row = check_router(name, *inputs, flush=flush)
        elif key[0] == "moe_router_bwd":
            row = check_router_bwd(name, *inputs, flush=flush)
        elif key[0] == "moe_combine":
            row = check_combine(name, *inputs, flush=flush)
        elif key[0] == "moe_combine_bwd":
            row = check_combine_bwd(name, *inputs, flush=flush)
        elif key[0] == "ssd_bwd":
            row = check_ssd_bwd(name, *inputs, flush=flush)
        elif key[0] == "ssd":
            row = check_ssd(name, *inputs, flush=flush)
        elif key[0] == "rglru":
            # training's forward keeps its states for the backward
            row = check_rglru(name, *inputs, flush=flush,
                              keep=isinstance(recorder, TrainRecorder))
        elif key[0] == "rglru_bwd":
            row = check_rglru_bwd(name, *inputs, flush=flush)
        elif key[0] == "cross_entropy":
            *tensors, kw = inputs
            row = check_cross_entropy(name, *(v.cuda() for v in tensors),
                                      flush=flush, **kw)
        else:
            row = check_fletcher(name, inputs, flush=flush)
        row["launches"] = rec["launches"]
        rows.append(row)
        del inputs
    del flush
    free_card()
    assert_all_ok(rows)
    return rows


# ---------------------------------------------------------------------------
# phase 5: full-width parity, kernels vs plain
# ---------------------------------------------------------------------------
def phase_parity(arch, S, n_layers=None, param_dtype=None):
    """Prefill 2 x S then 8 (B,) decode steps in f32 with TF32 off,
    through the kernels and through their plain versions, on the same
    weights; the logits must agree within PARITY_TOL * (1 + |logit|).
    ``n_layers`` cuts the depth; ``param_dtype`` keeps the weights in
    another dtype than the config's (both runs read the same ones)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = configs.get(arch)
    cfg = full.replace(compute_dtype="float32",
                       n_layers=n_layers or full.n_layers,
                       param_dtype=param_dtype or full.param_dtype)
    model = Model(cfg)
    params = model.init(2, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    B, steps = 2, 8
    toks = torch.randint(1, cfg.vocab, (B, S + steps), generator=gen,
                         device="cuda")
    # a frontend's seeded patches or frames; a VLM's take positions
    # 0..F-1 before the text
    frontend, span = None, 0
    if cfg.frontend != "none":
        frontend = torch.randn((B, cfg.frontend_seq, cfg.frontend_dim),
                               generator=gen, device="cuda") * 0.1
        span = cfg.frontend_seq if cfg.family == "vlm" else 0
    routes = []             # per run: (idx, probs) of every router call

    def spy(router):
        def run(logits, k, **kw):
            r = router(logits, k, **kw)
            routes[-1].append((r.idx, r.probs))
            return r
        return run

    def run(plain: bool):
        routes.append([])
        moe_layer.router_dispatch = spy(kr.router_dispatch_plain if plain
                                        else kr.router_dispatch)
        if plain:
            attn_layer.attention = fa.attention_plain
            moe_layer.moe_combine = kc.moe_combine_plain
            ssd_block.ssd = kssd.ssd_plain
            rglru_block.rglru = krg.rglru_plain
        try:
            logits, cache = model.prefill(params, toks[:, :S],
                                          cache_len=span + S + steps,
                                          frontend=frontend)
            out = [logits]
            for i in range(steps):
                pos = torch.full((B,), span + S + i, dtype=torch.int32,
                                 device="cuda")
                logits, cache = model.decode_step(
                    params, cache, toks[:, S + i:S + i + 1], pos)
                out.append(logits)
        finally:
            moe_layer.router_dispatch = kr.router_dispatch
            moe_layer.moe_combine = kc.moe_combine
            attn_layer.attention = fa.attention
            ssd_block.ssd = kssd.ssd
            rglru_block.rglru = krg.rglru
        return torch.stack(out)

    n_moe = sum("moe" in p for p in params["layers"])
    sizes = model.stack_sizes
    kernels = (fa.attention, kr.router_dispatch, kssd.ssd, krg.rglru,
               kc.moe_combine)
    # attention, the router and the combine launch on prefill and every
    # decode step (an encoder-decoder's cross attention too, its encoder
    # on prefill), the SSD and the RG-LRU on prefill alone
    n_attn = sizes.get("attn", 0) + (cfg.n_layers if model.is_encdec else 0)
    want_launches = (n_attn * (1 + steps) + cfg.n_enc_layers,
                     n_moe * (1 + steps), sizes.get("ssd", 0),
                     sizes.get("rglru", 0), n_moe * (1 + steps))
    before = [fn.launches for fn in kernels]
    got = run(plain=False)
    launched = tuple(fn.launches - b for fn, b in zip(kernels, before))
    check(launched == want_launches,
          f"parity: kernel launches {launched}, expected {want_launches} "
          f"(attention, router, ssd, rglru, combine)")
    want = run(plain=True)
    check(bool(torch.isfinite(got).all()), "parity: non-finite logits")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    # routing decisions that differ between the runs: (call, token,
    # position, expert of the kernel run, of the plain run, their two
    # probabilities in the plain run)
    flips = []
    for call, ((ia, _), (ib, pb)) in enumerate(zip(*routes)):
        for t, j, a, b, pa, pb_ in router_ties(ia.cpu(), ib.cpu(),
                                               pb.cpu()):
            flips.append({"layer": call % max(n_moe, 1),
                          "call": call // max(n_moe, 1), "token": t,
                          "position": j, "experts": [a, b],
                          "probs": [pa, pb_], "gap": abs(pa - pb_)})
    print(f"parity {arch}: f32 full width, {cfg.n_layers} of "
          f"{full.n_layers} layers, {cfg.param_dtype} weights, TF32 off, "
          f"prefill {B}x{S}"
          + (f" with ({cfg.frontend_seq}, {cfg.frontend_dim}) frontends"
             if frontend is not None else "") + " + "
          f"{steps} decode steps: max |kernel - plain| = {err:.3g} (max "
          f"|logit| {scale:.3g}, tolerance {PARITY_TOL} * (1 + |logit|)); "
          f"kernel launches (attention, router, ssd, rglru, combine) "
          f"{launched}; "
          f"routing differences {len(flips)}"
          + (f": {json.dumps(flips[:20])}" if flips else ""))
    del params, model
    free_card()
    check(err <= PARITY_TOL * (1 + scale), f"parity {arch}: logits disagree")


def _plain_ssd_forward(x, dt, A, B, C, D, h0, keep=False):
    """The forward kernels' raw launch replaced by its plain version
    (``ssd_keep_plain``), so that ``SSDFunction`` runs the backward
    kernels alone."""
    out = kssd.ssd_keep_plain(x, dt, A, B, C, D, h0)
    return out if keep else out[:2]


def autograd_moe_local(cfg, params, x2d, *, e_pad, capacity_factor,
                       dropless=False):
    """The MoE layer as autograd differentiates it, phase_train_parity's
    plain side: the router's plain version on the logits themselves, so
    the router's gradient comes from autograd through its formulas and
    not from the row function that ``moe_combine_bwd`` and its plain
    version share; the layer's dispatch and experts; and the eager
    combine (a zero row appended, the T·k rows gathered, weighted and
    summed: ``models/moe.py`` before the combine kernel)."""
    T, d = x2d.shape
    E_real, k = cfg.moe.num_experts, cfg.moe.top_k
    cdt = dtype_of(cfg.compute_dtype)
    logits = (x2d.to(cdt) @ params["router"].to(cdt)).float()
    C = T if dropless else max(
        int(math.ceil(T * k / max(E_real, 1) * capacity_factor)), 1)
    r = moe_layer.router_dispatch(logits, k, n_real=E_real, capacity=C,
                                  dispatch=cfg.moe.dispatch)
    buf = moe_layer._Dispatch.apply(x2d, r.src, r.slot).view(e_pad, C, d)
    out_buf = moe_layer._expert_ffn(cfg, params, buf).view(e_pad * C, d)
    out_flat = torch.cat([out_buf, out_buf.new_zeros((1, d))])
    vals = out_flat.index_select(0, r.slot.view(-1)).view(T, k, d)
    y = (vals * r.w[..., None].to(vals.dtype)).sum(1)
    return y, (r.load, r.prob_sum, r.z_sum, float(T))


_MOE_LOCAL = moe_layer._moe_local


def phase_train_parity(arch, B: int = 2, S: int = 128, n_layers=None,
                       ssd_forward: str = "kernel", enforce: bool = True):
    """``arch``'s loss and every gradient leaf at B x S in f32 with TF32
    off, through the kernels (attention's, the router's, the SSD's and
    the RG-LRU's forwards and backwards, the loss head's cross entropy)
    against autograd through their plain versions (the cross entropy's
    plain version inside the same ``HeadLossFunction``), on the same
    weights and batch; the MoE layer's plain
    side is ``autograd_moe_local``, whose router gradient is autograd's.  ``n_layers`` cuts the depth
    (printed); ``ssd_forward="plain"`` runs the SSD's forward as its
    plain version inside ``SSDFunction`` (the backward kernels alone);
    ``enforce=False`` prints the errors without holding them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get(arch).replace(compute_dtype="float32")
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    model = Model(cfg)
    params = model.init(2, device="cuda")
    batch = train_batch(train_source(cfg, S, B, seed=2), 0, cfg)
    routes = []             # per run: the idx of every router call

    def spy(router):
        def run(logits, k, **kw):
            r = router(logits, k, **kw)
            routes[-1].append((r.idx.detach(), r.probs.detach()))
            return r
        return run

    def run(plain: bool):
        routes.append([])
        before = TrainRecorder.counts()
        moe_layer.router_dispatch = spy(kr.router_dispatch_plain if plain
                                        else kr.router_dispatch)
        if plain:
            attn_layer.attention = fa.attention_plain
            moe_layer._moe_local = autograd_moe_local
            ssd_block.ssd = kssd.ssd_plain
            rglru_block.rglru = krg.rglru_plain
            model_common.cross_entropy = kce.cross_entropy_plain
        elif ssd_forward == "plain":
            kssd._ssd_cuda = _plain_ssd_forward
        try:
            loss, metrics, grads = train_step.loss_and_grads(
                model, params, batch, remat="none")
        finally:
            attn_layer.attention = fa.attention
            moe_layer.router_dispatch = kr.router_dispatch
            moe_layer._moe_local = _MOE_LOCAL
            ssd_block.ssd = kssd.ssd
            kssd._ssd_cuda = _SSD_CUDA
            rglru_block.rglru = krg.rglru
            model_common.cross_entropy = kce.cross_entropy
        launched = tuple(n - b for n, b in zip(TrainRecorder.counts(),
                                               before))
        return float(loss), metrics, svc_base.flatten_named(grads), launched

    loss, metrics, grads, launched = run(plain=False)
    want_loss, want_metrics, want, plain_launched = run(plain=True)
    n = layer_counts(model)
    want_launched = (n["attn"], n["attn"], n["moe"], 0,
                     n["ssd"] if ssd_forward == "kernel" else 0, n["ssd"],
                     n["rglru"], n["rglru"], n["moe"], n["moe"],
                     ce_launches(batch["targets"].shape[1]))
    check(launched == want_launched
          and plain_launched == (0,) * len(TrainRecorder.KERNELS),
          f"train parity {arch}: launches {launched} / {plain_launched}, "
          f"expected {want_launched}")
    flips = sum(len(router_ties(ia.cpu(), ib.cpu(), pb.cpu()))
                for (ia, _), (ib, pb) in zip(*routes))
    loss_err = abs(loss - want_loss) / abs(want_loss)
    aux_err = {k: abs(float(metrics[k]) - float(want_metrics[k]))
               / max(abs(float(want_metrics[k])), 1e-30)
               for k in ("moe_lb", "moe_z") if float(want_metrics[k])}
    # cross attention's key bias has no gradient in exact arithmetic (no
    # RoPE: q . bk adds one logit to every key of a query, which the
    # softmax cancels): both sides hold rounding noise, held against the
    # largest gradient entry of the model
    zero = [key for key in want if key.endswith("['cross']['bk']")]
    top = max(float(w.abs().max()) for w in want.values())
    zero_err = max((max(float(grads[key].abs().max()),
                        float(want[key].abs().max())) / top
                    for key in zero), default=0.0)
    worst, where = 0.0, None
    for key, w in want.items():
        g = grads[key]
        check(bool(torch.isfinite(g).all()), f"train parity {arch}: {key} "
              f"not finite")
        if key in zero:
            continue
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        if err >= worst:
            worst, where = err, key
    print(f"train parity {arch}: f32 full width, {cfg.n_layers} layers"
          + (f" (cut from {configs.get(arch).n_layers})" if n_layers
             else "")
          + (", the SSD's forward plain" if ssd_forward == "plain" else "")
          + ("" if enforce else ", printed, not held")
          + f", TF32 off, {B}x{S}: loss {loss} / plain "
          f"{want_loss} (relative {loss_err:.3g}); aux relative "
          f"{json.dumps(aux_err)}; {len(want)} gradient leaves, worst "
          f"max|kernel - plain| / max|plain| = {worst:.3g} at {where} "
          f"(tolerance {TRAIN_PARITY_TOL})"
          + (f"; {len(zero)} cross key-bias leaves (zero in exact "
             f"arithmetic): largest |entry| / largest gradient entry "
             f"{zero_err:.3g}" if zero else "")
          + f"; launches (attention fwd, bwd, "
          f"router fwd, bwd, ssd fwd, bwd, rglru fwd, bwd, combine fwd, "
          f"bwd, cross entropy) {launched}; "
          f"routing differences {flips}")
    del params, grads, want
    free_card()
    check(not enforce or (
        loss_err <= TRAIN_PARITY_TOL and worst <= TRAIN_PARITY_TOL
        and zero_err <= TRAIN_PARITY_TOL
        and all(e <= TRAIN_PARITY_TOL for e in aux_err.values())),
          f"train parity {arch}: the kernels' loss or gradients disagree")


def ssm_train_parity():
    """mamba2-1.3b's training parity.  At full depth no f32 algorithm
    holds TRAIN_PARITY_TOL against another: ``ssd_plain`` at chunk 64
    and at chunk 256 part by 1.5e-4 to 3.5e-4 on the worst leaf of 48
    layers, and the forward kernels' 3xTF32 products by 2.1e-3
    (``tools/train_parity_depth.py``).  So the backward kernels are held
    at full depth under the plain forward, the whole path (forward and
    backward kernels) at SSM_PARITY_LAYERS layers, and the whole path at
    full depth is printed."""
    phase_train_parity(SSM_ARCH, ssd_forward="plain")
    phase_train_parity(SSM_ARCH, n_layers=SSM_PARITY_LAYERS)
    phase_train_parity(SSM_ARCH, enforce=False)


# ---------------------------------------------------------------------------
# phase 3m: distribution, four ranks on the one card over gloo
# ---------------------------------------------------------------------------
DISTRIB_RANKS = 4
DISTRIB_MESH = (2, 2)            # (data, model) of the sharded step
DISTRIB_LAYERS = 2               # granite-moe-3b-a800m cut from 32 (time)
DISTRIB_STEPS = 2
DISTRIB_PARITY = dict(layers=2, batch=2)
# the parity step's AdamW eps: at 1e-8 an entry whose gradient is below
# about 1e-8 steps by lr·g/(|g| + eps), which turns the last bits of two
# equal gradients summed in another order into differences up to lr
DISTRIB_PARITY_EPS = 1e-3
TP_ARCH = ARCH                   # qwen1.5-0.5b at full width
TP_LAYERS = 8                    # cut from 24 (time); at 6 the embedding's
                                 # draw (934 MB of peak against a 931 MB
                                 # tree) alone tops the init peak check
TP_HEADS = (8, 8)                # its local query / key-value heads on 2
TP_SSM_LAYERS = 4                # mamba2-1.3b cut from 48 (time)
TP_SSM_HEADS = (32, 64, 1, 128)  # its local SSD heads on 2 (H, P, G, N)
SP_ARCH = HYBRID_ARCH            # recurrentgemma-9b: wide, dense
SP_LAYERS = 3                    # one period: rec, rec, local (memory)
SP_LRU = 2048                    # its local RG-LRU channels on 2
SP_HEADS = (8, 1)                # its local query / key-value heads on 2
TP_REC_STEPS = 2                 # steps of sub-checks 1c and 1d
VARIANT_LAYERS = 2               # qwen and granite in sub-checks 1e-1g
FLAT_HEADS = (24, 8)             # all of granite's query / key-value heads
DISTRIB_LIMIT_S = 900.0          # the four ranks' whole run
DISTRIB_BARRIER_S = 600.0        # a rank's wait in one collective
SP_DECODE = dict(B=4, T=32768, Hq=16, Hkv=16, D=64, softcaps=(0.0, 30.0))
PIPE = dict(n_micro=8, mb=1, S=128)
PIPE_TOL = 2e-2                  # bf16: largest error over largest entry
COMPRESS_BOUND = 0.75            # of the shared scale, the reference's


class CollectiveClock:
    """Host time inside every collective of ``torch.distributed`` that
    the port calls (the card synchronised on both sides of each call, so
    the time is the collective's own, gloo's staging through the host
    included), by kind: calls, seconds and bytes.  A call's bytes are
    those of its larger buffer: the reduced tensor of an all-reduce, the
    gathered output of an all-gather, the input of a reduce-scatter."""

    # the port's collectives, under the names of newer and older torch
    KINDS = ("all_reduce", "all_gather_single", "all_gather_into_tensor",
             "reduce_scatter_single", "reduce_scatter_tensor")

    def __init__(self):
        self.by_kind = {}
        self.by_dtype = {}          # the bytes of the calls by dtype
        self._orig = {}

    def install(self):
        import torch.distributed as dist
        for kind in self.KINDS:
            if hasattr(dist, kind):
                self._orig[kind] = getattr(dist, kind)
                setattr(dist, kind, self._timed(kind, self._orig[kind]))

    def _timed(self, kind, fn):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            rec = self.by_kind.setdefault(kind, {"calls": 0, "seconds": 0.0,
                                                 "bytes": 0})
            rec["seconds"] += time.perf_counter() - t0
            rec["calls"] += 1
            bufs = [t for t in a[:2] if torch.is_tensor(t)]
            nbytes = max((t.numel() * t.element_size() for t in bufs),
                         default=0)
            rec["bytes"] += nbytes
            if bufs:
                dt = str(bufs[0].dtype).replace("torch.", "")
                self.by_dtype[dt] = self.by_dtype.get(dt, 0) + nbytes
            return out
        return timed

    def uninstall(self):
        import torch.distributed as dist
        for kind, fn in self._orig.items():
            setattr(dist, kind, fn)

    def total(self, key):
        return sum(rec[key] for rec in self.by_kind.values())

    def line(self, n_steps=1) -> str:
        return "; ".join(f"{kind} {rec['calls'] / n_steps:g} calls "
                         f"{rec['bytes'] / n_steps / 1e9:.4f} GB "
                         f"{rec['seconds'] / n_steps:.3f}s"
                         for kind, rec in sorted(self.by_kind.items()))


def distrib_model(n_layers, mesh, capacity_factor=None, **over):
    """granite-moe-3b-a800m at full width, ``n_layers`` deep, its experts
    padded to the mesh's model axis."""
    cfg = configs.get(MOE_ARCH).replace(n_layers=n_layers, **over)
    if capacity_factor is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return Model(cfg, e_pad=moe_layer.padded_experts(cfg,
                                                     mesh.shape["model"]))


def stored_bytes(state) -> int:
    """The bytes of the parameters and the optimizer's state (AdamW's m
    and v, Adafactor's factors, the count)."""
    return sum(t.numel() * t.element_size() for t in
               optim.leaves(state["params"]) + optim.leaves(state["opt"]))


def distrib_train(mesh, rank):
    """Sub-check 1: DISTRIB_STEPS sharded steps of granite-moe-3b-a800m at
    full width, DISTRIB_LAYERS deep, bf16 compute, AdamW, 8 x 128 global,
    capacity factor 1.25, remat "none".  Returns (results, recorder)."""
    # phase 3i's schedule (its first steps: warmup 5 of 10)
    return sharded_steps(f"distrib r{rank} {MOE_ARCH} ({DISTRIB_LAYERS} "
                         f"layers)", distrib_model(DISTRIB_LAYERS, mesh),
                         mesh, "none")


def distrib_tp_train(mesh, rank):
    """Sub-check 1b: DISTRIB_STEPS sharded steps of qwen1.5-0.5b at full
    width, TP_LAYERS deep, bf16 compute, AdamW, 8 x 128 global, remat
    "block": every layer computes in tensor parallel over the model
    axis, and attention runs at TP_HEADS local heads on every rank; the
    collectives a step as ``tools/tp_bytes.py`` reckons them.  Returns
    (results, recorder)."""
    model = Model(configs.get(TP_ARCH).replace(n_layers=TP_LAYERS))
    tag = f"distrib r{rank} {TP_ARCH} tensor parallel"
    out, recorder = sharded_steps(tag, model, mesh, "block")
    check_reckoned(tag, out, model, "block")
    heads = sorted({(key[5], key[6]) for key in recorder.seen
                    if key[0].startswith("flash_attention")})
    print(f"{tag}: attention at (query, key/value) heads {heads}",
          flush=True)
    check(heads == [TP_HEADS], f"{tag}: attention heads {heads}, "
          f"expected {[TP_HEADS]}")
    out["heads"] = heads
    return out, recorder


def distrib_ssm_train(mesh, rank):
    """Sub-check 1c: TP_REC_STEPS sharded steps of mamba2-1.3b at full
    width, TP_SSM_LAYERS deep, bf16 compute, AdamW, 8 x 128 global,
    remat "block": every SSD block computes in tensor parallel over the
    model axis, its kernels (forward and backward) on TP_SSM_HEADS on
    every rank.  Returns (results, recorder)."""
    model = Model(configs.get(SSM_ARCH).replace(n_layers=TP_SSM_LAYERS))
    tag = f"distrib r{rank} {SSM_ARCH} tensor parallel"
    out, recorder = sharded_steps(tag, model, mesh, "block",
                                  n_steps=TP_REC_STEPS)
    check_reckoned(tag, out, model, "block")
    heads = sorted({key[4:8] for key in recorder.seen
                    if key[0] in ("ssd", "ssd_bwd")})
    print(f"{tag}: SSD forward and backward at (heads, P, G, N) {heads}",
          flush=True)
    check(heads == [TP_SSM_HEADS], f"{tag}: SSD at {heads}, expected "
          f"{[TP_SSM_HEADS]}")
    out["ssd_heads"] = heads
    return out, recorder


def distrib_sp_train(mesh, rank):
    """Sub-check 1d: TP_REC_STEPS sharded steps of recurrentgemma-9b at
    full width, SP_LAYERS deep, bf16 compute, AdamW, 8 x 128 global,
    remat "block", sequence-parallel as the reference's rule chooses it
    (``seq_parallel_for``): the RG-LRU blocks on SP_LRU channels and
    attention on SP_HEADS on every rank, and each layer's input this
    rank's half of the positions.  Returns (results, recorder)."""
    from repro_torch.distrib.tensor_parallel import seq_parallel_for
    model = Model(configs.get(SP_ARCH).replace(n_layers=SP_LAYERS))
    tag = f"distrib r{rank} {SP_ARCH} sequence parallel"
    chosen = seq_parallel_for(model.cfg, mesh, TRAIN_BATCH, TRAIN_SEQ)
    print(f"{tag}: the rule chooses sequence parallelism: {chosen}",
          flush=True)
    check(chosen, f"{tag}: the rule does not choose sequence parallelism")
    # its 4.19 GB embedding, drawn whole (twice over while it is drawn),
    # outweighs the rest of the 3-layer tree: the init peak cannot stay
    # below the whole tree, though only one part is ever whole
    out, recorder = sharded_steps(tag, model, mesh, "block",
                                  n_steps=TP_REC_STEPS, seq_parallel=chosen,
                                  init_below_whole=False)
    check_reckoned(tag, out, model, "block", seq_parallel=chosen)
    lru = sorted({key[4] for key in recorder.seen
                  if key[0] in ("rglru", "rglru_bwd")})
    heads = sorted({(key[5], key[6]) for key in recorder.seen
                    if key[0].startswith("flash_attention")})
    want = TRAIN_SEQ // mesh.shape["model"]
    print(f"{tag}: RG-LRU at {lru} channels, attention at (query, "
          f"key/value) heads {heads}, layer inputs at "
          f"{out['stream_positions']} of {TRAIN_SEQ} positions", flush=True)
    check(lru == [SP_LRU] and heads == [SP_HEADS]
          and out["stream_positions"] == [want],
          f"{tag}: RG-LRU {lru}, attention {heads}, layer inputs "
          f"{out['stream_positions']}; expected [{SP_LRU}], {[SP_HEADS]}, "
          f"[{want}]")
    out.update(lru_channels=lru, heads=heads, seq_parallel=chosen)
    return out, recorder


def distrib_adafactor_train(mesh, rank):
    """Sub-check 1e: DISTRIB_STEPS sharded Adafactor steps of qwen1.5-0.5b
    at full width, VARIANT_LAYERS deep, bf16 compute, remat "block", 8 x
    128 global: each rank's stored bytes ``bytes_per_device`` of the
    Adafactor state (the reference's plus ``adafactor_column_copies``),
    attention at TP_HEADS on every rank, the collectives a step (with
    the factors' two rounds of sums) as ``tools/tp_bytes.py --opt
    adafactor`` reckons them.  Returns (results, recorder)."""
    model = Model(configs.get(TP_ARCH).replace(n_layers=VARIANT_LAYERS))
    tag = f"distrib r{rank} {TP_ARCH} adafactor"
    # at 2 layers the embedding's draw alone tops the whole tree (1b)
    out, recorder = sharded_steps(tag, model, mesh, "block",
                                  opt="adafactor", init_below_whole=False)
    check_reckoned(tag, out, model, "block", opt="adafactor")
    copies = train_step.adafactor_column_copies(model, mesh)
    print(f"{tag}: the reference's bytes_per_device "
          f"{out['bytes_per_device'] - copies} and {copies} bytes of the "
          f"norm scales' column copies", flush=True)
    heads = sorted({(key[5], key[6]) for key in recorder.seen
                    if key[0].startswith("flash_attention")})
    check(heads == [TP_HEADS], f"{tag}: attention heads {heads}, "
          f"expected {[TP_HEADS]}")
    out.update(heads=heads, column_copies=copies)
    return out, recorder


def distrib_pg_train(mesh, rank):
    """Sub-check 1f: DISTRIB_STEPS sharded AdamW steps of qwen1.5-0.5b at
    full width, VARIANT_LAYERS deep, under the dry run's
    ``param_gather=bfloat16``: each f32 block cast to bf16 before its
    gather, so the gathers and the gradients' reduce-scatters (gloo's
    CUDA form: all-reduces) travel in bf16.  The collectives a step as
    ``tools/tp_bytes.py`` reckons the variant; the bf16 bytes measured a
    step the reckoned parameters' collectives; a layer's of those half
    of a layer's in 1b's f32 reckoning.  Returns (results, recorder)."""
    model = Model(configs.get(TP_ARCH).replace(n_layers=VARIANT_LAYERS))
    tag = f"distrib r{rank} {TP_ARCH} param_gather"
    par = ParallelConfig(remat="block", param_gather_dtype="bfloat16")
    out, recorder = sharded_steps(tag, model, mesh, "block", par=par,
                                  init_below_whole=False)
    pg = check_reckoned(tag, out, model, "block",
                        variant="param_gather=bfloat16")
    base = tp_bytes_module().reckon(TP_ARCH, DISTRIB_MESH, TRAIN_BATCH,
                                    TRAIN_SEQ, "block", n_layers=TP_LAYERS)
    got16 = out["collective_bytes_by_dtype_a_step"].get("bfloat16", 0)
    want16 = pg["param_collectives"]["total"]
    layer16 = pg["param_collectives"]["layer"]
    layer32 = base["param_collectives"]["layer"]
    print(f"{tag}: bf16 bytes a step {got16}, the parameters' collectives "
          f"reckoned {want16}; a layer's {layer16} against 1b's f32 "
          f"{layer32}", flush=True)
    check(got16 == want16 and 2 * layer16 == layer32,
          f"{tag}: bf16 bytes {got16} (reckoned {want16}); a layer "
          f"{layer16} against {layer32}")
    heads = sorted({(key[5], key[6]) for key in recorder.seen
                    if key[0].startswith("flash_attention")})
    check(heads == [TP_HEADS], f"{tag}: attention heads {heads}")
    out.update(heads=heads, bf16_bytes_a_step=got16,
               layer_param_bytes=layer16, layer_param_bytes_f32=layer32)
    return out, recorder


def distrib_pg_parity(rank, grid):
    """Sub-check 1f's parity: qwen at VARIANT_LAYERS, f32 compute, TF32
    off, DISTRIB_PARITY batch x 128: the sharded gradients under
    ``param_gather=bfloat16`` (``make_sharded_grads``, the step's own),
    gathered, and the loss against one process's over the same
    bf16-cast parameters (each gradient the bf16 leaf's, widened as the
    cast's backward widens it), within
    ``GRAD_TOL`` bf16 of each leaf's largest entry.  Returns rank 0's
    (loss error, worst leaf error), else None."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = Model(configs.get(TP_ARCH).replace(
        n_layers=VARIANT_LAYERS, compute_dtype="float32"))
    ocfg = optim.OptConfig()
    par = ParallelConfig(remat="none", param_gather_dtype="bfloat16")
    batch = train_batch(train_source(model.cfg, TRAIN_SEQ,
                                     DISTRIB_PARITY["batch"], seed=2), 0)
    state = train_step.init_state(model, ocfg, 0, device="cuda", mesh=grid)
    grads_of = train_step.make_sharded_grads(model, par, grid)
    loss, _, grads = grads_of(state["params"], batch)
    loss = float(loss)
    del state
    free_card()
    whole = gathered_leaves(optim.leaves(grads),
                            train_step.leaves_of(grads_of.layout.specs),
                            grid, keep=rank == 0)
    del grads
    free_card()
    if rank:
        return None
    tag = (f"distrib r0 {TP_ARCH} param_gather parity ({VARIANT_LAYERS} "
           f"layers, f32)")
    params = optim.tree_map(
        lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t,
        train_step.init_state(model, ocfg, 0, device="cuda")["params"])
    want_loss, _, want = train_step.loss_and_grads(model, params, batch,
                                                   remat="none")
    want = [g.float() for g in optim.leaves(want)]
    errs = [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for g, w in zip(whole, want)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    loss_err = abs(loss - float(want_loss)) / abs(float(want_loss))
    tol = GRAD_TOL[torch.bfloat16]
    print(f"{tag}: loss {loss} against {float(want_loss)} (rel "
          f"{loss_err:.3g}); worst gradient leaf {max(errs):.3g} of its "
          f"largest entry (leaf {worst}, {tuple(want[worst].shape)}; "
          f"tolerance {tol:.4g}); leaves by error "
          f"{sorted(round(e, 5) for e in errs)[-5:]}", flush=True)
    check(loss_err <= tol and max(errs) <= tol,
          f"{tag}: loss {loss_err:.3g}, worst leaf {max(errs):.3g} > {tol}")
    del params, want, whole
    free_card()
    return loss_err, max(errs)


def distrib_flat_train(mesh, rank):
    """Sub-check 1g: DISTRIB_STEPS sharded AdamW steps of
    granite-moe-3b-a800m at full width, VARIANT_LAYERS deep, bf16, remat
    "block", capacity factor 1.25, under the dry run's ``flat_dp``: the
    batch over all 4 ranks, every collective over all 4, the router over
    all 40 experts (range [0, 40)) and the combine on every rank,
    attention at all FLAT_HEADS; the collectives a step as
    ``tools/tp_bytes.py`` reckons the variant.  Returns (results,
    recorder)."""
    from repro_torch.distrib.tensor_parallel import flat_dp_rules
    model = distrib_model(VARIANT_LAYERS, mesh)
    tag = f"distrib r{rank} {MOE_ARCH} flat_dp"
    out, recorder = sharded_steps(tag, model, mesh, "block",
                                  rules=flat_dp_rules(mesh))
    check_reckoned(tag, out, model, "block", variant="flat_dp")
    groups = out["collective_groups"]
    experts = sorted({(key[3], key[7], key[8]) for key in recorder.seen
                      if key[0] == "moe_router"})
    heads = sorted({(key[5], key[6]) for key in recorder.seen
                    if key[0].startswith("flash_attention")})
    e_pad = model.init(device="meta")["layers"][0]["moe"]["router"].shape[1]
    print(f"{tag}: collective groups (ranks, span) {groups}; the router at "
          f"(E, e_start, e_local) {experts}; attention at (query, "
          f"key/value) heads {heads}", flush=True)
    check(groups == [(DISTRIB_RANKS, DISTRIB_RANKS)]
          and experts == [(e_pad, 0, e_pad)] and heads == [FLAT_HEADS],
          f"{tag}: groups {groups}, router {experts}, attention {heads}")
    out.update(heads=heads, router=experts)
    return out, recorder


def tp_bytes_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "tp_bytes", ROOT / "tools" / "tp_bytes.py")
    tp_bytes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tp_bytes)
    return tp_bytes


def check_reckoned(tag, out, model, remat, seq_parallel=False, variant="",
                   opt="adamw"):
    """A step's collectives (``sharded_steps``' ``collectives_a_step``),
    calls and bytes by kind, equal to what ``tools/tp_bytes.py`` reckons
    from the code for the same model, mesh, batch, remat, optimizer and
    variant in the form the mesh's backend takes (gloo with CUDA
    tensors: every call an all-reduce).  Returns the reckoning."""
    reckoned = tp_bytes_module().reckon(
        model.cfg.name, DISTRIB_MESH, TRAIN_BATCH, TRAIN_SEQ, remat,
        seq_parallel=seq_parallel, n_layers=model.cfg.n_layers,
        variant=variant, opt=opt)
    want = reckoned["calls_a_step"]["all_reduce"]
    got = {kind: {k: rec[k] for k in ("calls", "bytes")}
           for kind, rec in out["collectives_a_step"].items()}
    print(f"{tag}: collectives a step {got}, tools/tp_bytes.py reckons "
          f"{want}", flush=True)
    check(got == want, f"{tag}: collectives a step {got}, reckoned {want}")
    return reckoned


def sharded_steps(tag, model, mesh, remat, n_steps=DISTRIB_STEPS,
                  seq_parallel=False, init_below_whole=True, opt="adamw",
                  par=None, rules=None):
    """``n_steps`` steps of ``make_train_step(..., mesh=, seq_parallel=,
    rules=)`` from seed 0 on 8 x 128 global batches, ``opt`` (AdamW or
    Adafactor, warmup 5 of 10), ``par`` (default ``remat`` alone), under
    a ``TrainRecorder`` and a ``CollectiveClock``: the stored bytes held
    to ``bytes_per_device``, the init peak (what the state's init
    allocates beyond what the card held before it) below the whole tree
    where ``init_below_whole``, the loss falling, every kernel of the
    layers launched on every step; the positions each layer's input
    holds and the groups of the first step's collectives are recorded.
    Returns (results, recorder)."""
    from repro_torch.distrib import collectives as coll
    from repro_torch.distrib.sharding import bytes_per_device
    ocfg = optim.OptConfig(name=opt, warmup=5, decay_steps=MOE_TRAIN_STEPS)
    par = par or ParallelConfig(remat=remat)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    state = train_step.init_state(model, ocfg, 0, device="cuda", mesh=mesh,
                                  rules=rules)
    init_peak = torch.cuda.max_memory_allocated() - before
    shapes, axes = train_step.init_state_axes(model, ocfg)
    want = bytes_per_device(shapes, axes, mesh, rules)
    got = stored_bytes(state)
    whole = sum(t.numel() * t.element_size()
                for t in optim.leaves(shapes["params"]))
    print(f"{tag}: stored {got} bytes, bytes_per_device {want}; init peak "
          f"{init_peak} bytes, the whole parameter tree {whole}", flush=True)
    check(got == want, f"{tag}: stored {got} bytes, bytes_per_device "
          f"{want}")
    # the blocks are kept one layer at a time: the whole tree is never
    # held on the card
    check(init_peak < whole or not init_below_whole,
          f"{tag}: init peak {init_peak} bytes holds the whole parameter "
          f"tree ({whole})")
    step = train_step.make_train_step(model, ocfg, par, mesh,
                                      seq_parallel=seq_parallel, rules=rules)
    source = train_source(model.cfg)
    recorder, clock = TrainRecorder(), CollectiveClock()
    positions, block = set(), Model._block

    def watched(self, p, x, *a, **kw):
        positions.add(x.shape[1])
        return block(self, p, x, *a, **kw)
    recorder.install()
    for fn in TRAIN_COUNTED:
        fn.launches = 0
    clock.install()
    Model._block = watched
    losses, step_s, groups = [], [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        for i in range(n_steps):
            batch = train_batch(source, i)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            with coll.record() as recs:
                state, met = step(state, batch)
            losses.append(float(met["loss"]))
            step_s.append(time.monotonic() - t0)
            groups = groups or sorted({(r["group"], r["span"])
                                       for r in recs})
    finally:
        Model._block = block
        clock.uninstall()
        recorder.uninstall()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{tag}: losses {losses}, step ms "
          f"{[round(s * 1e3, 2) for s in step_s]}, peak {peak:.2f} GiB, "
          f"collectives {clock.total('calls')} calls "
          f"{clock.total('seconds'):.3f}s {clock.total('bytes') / 1e9:.2f} "
          f"GB; a step: {clock.line(n_steps)}", flush=True)
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"{tag}: losses {losses}")
    per_step = check_train_launches(tag, model, recorder, n_steps, remat)
    del state, step
    free_card()
    return {"losses": losses, "step_ms": [s * 1e3 for s in step_s],
            "peak_gib": peak, "init_peak_gib": init_peak / 2 ** 30,
            "held_before_gib": before / 2 ** 30,
            "stored_bytes": got,
            "bytes_per_device": want, "launches_a_step": per_step,
            "stream_positions": sorted(positions),
            "collectives_a_step": {
                kind: {k: v / n_steps for k, v in rec.items()}
                for kind, rec in clock.by_kind.items()},
            "collective_bytes_by_dtype_a_step": {
                dt: b / n_steps for dt, b in clock.by_dtype.items()},
            "collective_groups": groups,
            "collective_s": clock.total("seconds"),
            "collective_bytes": clock.total("bytes"),
            "collective_share": clock.total("seconds") / sum(step_s)}, \
        recorder


def distrib_parity_step(mesh, arch=MOE_ARCH, n_layers=None,
                        seq_parallel=False, opt="adamw", rules=None,
                        batch_size=None):
    """The sharded step's state after one step of ``arch`` (granite, qwen,
    mamba2 or recurrentgemma) at ``n_layers`` (default DISTRIB_PARITY's)
    layers, f32, TF32 off, ``batch_size`` (default DISTRIB_PARITY's) x
    128, ``opt`` (AdamW or Adafactor) under ``rules``, and the model,
    optimizer and batch it ran (every rank the same).  granite's capacity
    factor is 16 (dropless): capacity is per token shard, so at 1.25 the
    shards drop other assignments than one process does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_layers = n_layers or DISTRIB_PARITY["layers"]
    if arch == MOE_ARCH:
        model = distrib_model(n_layers, mesh, capacity_factor=16.0,
                              compute_dtype="float32")
    else:
        model = Model(configs.get(arch).replace(
            n_layers=n_layers, compute_dtype="float32"))
    ocfg = optim.OptConfig(name=opt, warmup=1, decay_steps=1,
                           eps=DISTRIB_PARITY_EPS)
    batch = train_batch(train_source(
        model.cfg, TRAIN_SEQ, batch_size or DISTRIB_PARITY["batch"],
        seed=2), 0)
    par = ParallelConfig(remat="none")
    state = train_step.init_state(model, ocfg, 0, device="cuda", mesh=mesh,
                                  rules=rules)
    state, met = train_step.make_train_step(
        model, ocfg, par, mesh, seq_parallel=seq_parallel,
        rules=rules)(state, batch)
    return model, ocfg, par, batch, state, float(met["loss"])


def distrib_parity(rank, grid, tag, arch, n_layers=None,
                   seq_parallel=False, everywhere=False, opt="adamw",
                   rules=None, batch_size=None):
    """``distrib_parity_step`` of ``arch`` on every rank, then on rank 0
    its gathered parameters against one process (``TRAIN_PARITY_TOL``);
    the gathered parameters are kept on rank 0 only, unless
    ``everywhere``, and every rank frees the rest first.  Returns (rank
    0's parity, or None; the model, batch and gathered parameters)."""
    model, ocfg, par, batch, state, loss = distrib_parity_step(
        grid, arch, n_layers, seq_parallel, opt, rules, batch_size)
    free_card()
    whole = gathered_params(model, state, grid, keep=everywhere or rank == 0,
                            rules=rules)
    del state
    free_card()
    parity = None
    if rank == 0:
        parity = parity_against_one_process(
            f"distrib r0 {tag} parity ({n_layers or DISTRIB_PARITY['layers']}"
            f" layers, f32)", model, ocfg, par, batch, whole, loss,
            TRAIN_PARITY_TOL)
    return parity, (model, batch, whole)


def parity_against_one_process(tag, model, ocfg, par, batch, whole, loss,
                               tol):
    """The gathered parameters ``whole`` and ``loss`` of a sharded step
    against one step without a mesh from the same seed; returns (the
    loss's and the worst leaf's error over its largest entry, leaves
    bitwise equal)."""
    state = train_step.init_state(model, ocfg, 0, device="cuda")
    state, met = train_step.make_train_step(model, ocfg, par)(state, batch)
    want = optim.leaves(state["params"])
    errs = [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for g, w in zip(whole, want)]
    same = sum(bool(torch.equal(g, w)) for g, w in zip(whole, want))
    loss_err = abs(loss - float(met["loss"])) / abs(float(met["loss"]))
    print(f"{tag}: loss {loss} against {float(met['loss'])} (rel "
          f"{loss_err:.3g}); worst leaf {max(errs):.3g} of its largest "
          f"entry; {same} of {len(want)} leaves bitwise equal", flush=True)
    check(loss_err <= tol and max(errs) <= tol,
          f"{tag}: loss {loss_err:.3g}, worst leaf {max(errs):.3g} > {tol}")
    del state
    free_card()
    return loss_err, max(errs), same


def gathered_params(model, state, mesh, keep=True, rules=None):
    """Every parameter leaf put together from the ranks' blocks (placed
    under ``rules``), leaf by leaf (a collective each); a rank that does
    not ``keep`` them drops each at once (None in its place)."""
    from repro_torch.distrib.sharding import tree_specs
    specs = train_step.leaves_of(tree_specs(model.init(device="meta"),
                                            model.param_axes(), mesh, rules))
    return gathered_leaves(optim.leaves(state["params"]), specs, mesh, keep)


def gathered_leaves(blocks, specs, mesh, keep=True):
    """``gathered_params``' loop over any blocks and their specs."""
    from repro_torch.distrib.sharding import gather_block
    out = []
    for b, s in zip(blocks, specs):
        w = gather_block(b, s, mesh)
        out.append((w.clone() if w is b else w) if keep else None)
        del w
    return out


def distrib_sp_decode(rank):
    """Sub-check 2: ``sp_decode_attention`` over (data 1, model 4) at
    qwen1.5-0.5b's heads, B 4, T 32768 (8192 keys a rank), bf16, with and
    without softcap, against the kernel's decode over the whole cache
    and against the plain version.  Returns (results, phase 4 inputs)."""
    from repro_torch.distrib import collectives as coll
    from repro_torch.launch.mesh import Mesh
    sp = SP_DECODE
    mesh = Mesh((1, DISTRIB_RANKS), ("data", "model"), backend="gloo")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    B, T = sp["B"], sp["T"]
    q = rnd(B, 1, sp["Hq"], sp["D"])
    k, v = rnd(B, T, sp["Hkv"], sp["D"]), rnd(B, T, sp["Hkv"], sp["D"])
    n = T // DISTRIB_RANKS
    k_mine = k[:, rank * n:(rank + 1) * n].contiguous()
    v_mine = v[:, rank * n:(rank + 1) * n].contiguous()
    out, inputs = {}, []
    for softcap in sp["softcaps"]:
        before = fa.attention.launches
        got = coll.sp_decode_attention(q, k_mine, v_mine, mesh,
                                       softcap=softcap)
        torch.cuda.synchronize()
        launches = fa.attention.launches - before
        kw = dict(causal=True, softcap=softcap, q_offset=T - 1)
        whole = fa.attention(q, k, v, **kw).float()
        plain = fa.attention_plain(q, k, v, **kw).float()
        scale = float(plain.abs().max())
        e_kernel = float((got.float() - whole).abs().max()) / scale
        e_plain = float((got.float() - plain).abs().max()) / scale
        print(f"distrib r{rank} sp_decode softcap {softcap}: partial "
              f"launches {launches}; error over the largest entry "
              f"{e_kernel:.3g} against the whole-cache kernel, "
              f"{e_plain:.3g} against plain", flush=True)
        check(launches == 1 and e_kernel <= TOL[torch.bfloat16]
              and e_plain <= TOL[torch.bfloat16],
              f"sp_decode softcap {softcap}: launches {launches}, errors "
              f"{e_kernel:.3g} / {e_plain:.3g}")
        out[str(softcap)] = {"launches": launches, "err_kernel": e_kernel,
                             "err_plain": e_plain}
        inputs.append((f"sp_decode softcap{softcap:g}", launches,
                       dict(causal=False, softcap=softcap)))
    return out, (q, k_mine, v_mine, inputs)


def distrib_compress(rank, model, whole, batch):
    """Sub-check 3: over (data 4, model 1), each rank's gradient tree of
    the parity model at the gathered weights on its own batch row, the
    int8 compressed mean against the exact mean (within COMPRESS_BOUND
    of the shared scale, leaf by leaf); then the reference test's
    error-feedback regression toy, which must converge (< 0.05)."""
    from repro_torch.distrib import collectives as coll
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(1, backend="gloo")
    pos = iter(whole)
    params = optim.tree_map(lambda _: next(pos), model.init(device="meta"))
    rows = {k: x[rank:rank + 1] for k, x in batch.items()}
    _, _, grads = train_step.loss_and_grads(model, params, rows,
                                            remat="none")
    comp, _ = coll.compressed_allreduce_tree(grads, None, mesh, "data")
    worst = 0.0
    for g, c in zip(optim.leaves(grads), optim.leaves(comp)):
        exact = coll.all_reduce(g, mesh, "data") / DISTRIB_RANKS
        scale = coll.all_reduce(g.abs().max() / 127.0, mesh, "data", "max")
        worst = max(worst, float((c - exact).abs().max() / scale))
    X = torch.randn((4, 64, 8), generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda")
    wt = torch.randn(8, generator=torch.Generator(device="cuda").manual_seed(
        2), device="cuda")
    y = torch.einsum("dbi,i->db", X, wt)
    w, err = torch.zeros(8, device="cuda"), torch.zeros(8, device="cuda")
    for _ in range(60):
        g = X[rank].T @ (X[rank] @ w - y[rank]) / y[rank].numel()
        g, err = coll.compressed_psum(g + err, mesh, "data")
        w = w - 0.3 * g
    dist_toy = float(torch.linalg.norm(w - wt))
    print(f"distrib r{rank} compressed all-reduce: {len(optim.leaves(grads))}"
          f" leaves, worst |compressed - exact| {worst:.3g} of the scale; "
          f"error-feedback toy at {dist_toy:.3g}", flush=True)
    check(worst <= COMPRESS_BOUND and dist_toy < 0.05,
          f"compressed all-reduce: worst {worst:.3g}, toy {dist_toy:.3g}")
    return {"leaves": len(optim.leaves(grads)), "worst_over_scale": worst,
            "toy_distance": dist_toy}


def distrib_pipeline(rank):
    """Sub-check 4: ``pipeline_apply`` over a (stage,) mesh of 4, each stage
    6 of qwen1.5-0.5b's 24 decoder blocks at full width (bf16 compute),
    8 microbatches of 1 x 128 hidden states; rank 0 holds the result
    against the 24 blocks applied in one process."""
    from repro_torch.distrib.pipeline import pipeline_apply
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((DISTRIB_RANKS,), ("stage",), backend="gloo")
    model = Model(configs.get(ARCH))
    cfg = model.cfg
    params = model.init(FABRIC_SEED, device="cuda")
    per = cfg.n_layers // DISTRIB_RANKS
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    x = torch.randn((PIPE["n_micro"], PIPE["mb"], PIPE["S"], cfg.d_model),
                    generator=gen, device="cuda").to(dtype_of(
                        cfg.compute_dtype))

    def blocks(layers, h):
        for p in layers:
            h = model._block(p, h, lambda a, p=p: attn_layer.attn_train(
                cfg, p["attn"], a))
        return h
    with torch.no_grad():
        before = fa.attention.launches
        got = pipeline_apply(blocks, params["layers"][rank * per:
                                                      (rank + 1) * per],
                             x, mesh)
        torch.cuda.synchronize()
        launches = fa.attention.launches - before
        want_launches = (PIPE["n_micro"] + DISTRIB_RANKS - 1) * per
        err = same = None
        if rank == 0:
            want = torch.stack([blocks(params["layers"], x[i])
                                for i in range(PIPE["n_micro"])])
            err = float((got.float() - want.float()).abs().max()
                        / want.float().abs().max())
            same = bool(torch.equal(got, want))
    print(f"distrib r{rank} pipeline: {per} blocks a stage, attention "
          f"launches {launches} (want {want_launches})"
          + ("" if err is None else f"; error over the largest entry "
             f"{err:.3g} against one process, bitwise {same}"), flush=True)
    check(launches == want_launches and (err is None or err <= PIPE_TOL),
          f"pipeline: launches {launches}, error {err}")
    del params
    free_card()
    return {"launches": launches, "err": err, "bitwise": same}


def mesh_rank(rank: int, folder: str, parts) -> int:
    """One rank process of phases 3m and 3n (this script with
    ``--distrib-rank`` and / or ``--serve-rank``): joins the gloo world
    through a FileStore in ``folder`` once, then runs 3m's sub-checks
    (``distrib_rank``) and 3n's (``serve_rank``), as ``parts`` asks."""
    import torch.distributed as dist
    from datetime import timedelta
    from repro_torch.launch.mesh import Mesh
    with PhaseClock()(f"3m-3n r{rank} 0 join"):
        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method=f"file://{folder}/store", rank=rank,
            world_size=DISTRIB_RANKS,
            timeout=timedelta(seconds=DISTRIB_BARRIER_S))
        grid = Mesh(DISTRIB_MESH, ("data", "model"), backend="gloo")
    if "distrib" in parts:
        distrib_rank(rank, folder, grid)
        # nothing of 3m may count in 3n's peaks: its tensors, and the
        # cuBLAS workspace that each side stream of phase 4's timing kept
        # (one a stream, allocated through the caching allocator)
        free_card()
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
        print(f"serve r{rank}: {torch.cuda.memory_allocated()} bytes on "
              f"the card after 3m", flush=True)
    if "serve" in parts:
        mesh = grid if SERVE_MESH == DISTRIB_MESH else Mesh(
            SERVE_MESH, ("data", "model"), backend="gloo")
        serve_rank(rank, folder, mesh)
    dist.destroy_process_group()
    return 0


def write_result(folder: str, name: str, out: dict) -> None:
    """A rank's results as ``folder/<name>.json``, whole or not at all
    (written aside, then renamed): the parent reads it while the rank
    runs on."""
    tmp = Path(folder, f".{name}.json")
    tmp.write_text(json.dumps(out))
    tmp.rename(Path(folder, f"{name}.json"))


def distrib_rank(rank: int, folder: str, grid) -> None:
    """One rank of phase 3m on the (data, model) mesh ``grid``: runs
    sub-checks 1-1d and 2-4 and the NCCL refusal, and rank 0 then checks
    and times the kernels on its recorded inputs (phase 4) while the
    others wait; writes its results to ``folder/distrib<rank>.json``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    clock = PhaseClock()
    out = {"rank": rank}
    with clock(f"3m r{rank} 1 {MOE_ARCH}"):
        out["train"], recorder = distrib_train(grid, rank)
    with clock(f"3m r{rank} 1b {TP_ARCH}"):
        out["tp_train"], tp_recorder = distrib_tp_train(grid, rank)
        out["tp_parity"], _ = distrib_parity(rank, grid, TP_ARCH, TP_ARCH)
    with clock(f"3m r{rank} 1c {SSM_ARCH}"):
        out["ssm_train"], ssm_recorder = distrib_ssm_train(grid, rank)
        out["ssm_parity"], _ = distrib_parity(rank, grid, SSM_ARCH,
                                              SSM_ARCH)
    with clock(f"3m r{rank} 1d {SP_ARCH}"):
        out["sp_train"], sp_recorder = distrib_sp_train(grid, rank)
        out["sp_parity"], _ = distrib_parity(
            rank, grid, f"{SP_ARCH} sequence parallel", SP_ARCH, SP_LAYERS,
            seq_parallel=True)
    from repro_torch.distrib.tensor_parallel import flat_dp_rules
    with clock(f"3m r{rank} 1e {TP_ARCH} adafactor"):
        out["ada_train"], ada_recorder = distrib_adafactor_train(grid, rank)
        out["ada_parity"], _ = distrib_parity(
            rank, grid, f"{TP_ARCH} adafactor", TP_ARCH, VARIANT_LAYERS,
            opt="adafactor")
    with clock(f"3m r{rank} 1f {TP_ARCH} param_gather"):
        out["pg_train"], pg_recorder = distrib_pg_train(grid, rank)
        out["pg_parity"] = distrib_pg_parity(rank, grid)
    with clock(f"3m r{rank} 1g {MOE_ARCH} flat_dp"):
        out["flat_train"], flat_recorder = distrib_flat_train(grid, rank)
        out["flat_parity"], _ = distrib_parity(
            rank, grid, f"{MOE_ARCH} flat_dp", MOE_ARCH, VARIANT_LAYERS,
            rules=flat_dp_rules(grid), batch_size=DISTRIB_RANKS)
    with clock(f"3m r{rank} 1 parity, 2, 3"):
        # every rank's gradient tree at the gathered weights: sub-check 3
        out["parity"], (model, _, whole) = distrib_parity(
            rank, grid, MOE_ARCH, MOE_ARCH, everywhere=True)
        out["sp_decode"], sp_inputs = distrib_sp_decode(rank)
        out["compress"] = distrib_compress(rank, model, whole,
                                           train_batch(train_source(
                                               model.cfg, TRAIN_SEQ,
                                               DISTRIB_RANKS, seed=3), 0))
        del whole
    with clock(f"3m r{rank} 4 pipeline"):
        out["pipeline"] = distrib_pipeline(rank)
    try:
        make_local_mesh(2, backend="nccl")
        out["nccl_two_on_one"] = "accepted"
    except RuntimeError as e:
        out["nccl_two_on_one"] = f"refused: {e}"
    print(f"distrib r{rank} nccl, two ranks a card: "
          f"{out['nccl_two_on_one']}", flush=True)
    check(out["nccl_two_on_one"].startswith("refused"),
          "nccl accepted ranks that share a card")
    free_card()
    dist.barrier()
    rows = []
    if rank == 0:                  # alone on the card: the others wait
        t0 = time.monotonic()
        rows = phase_main_shapes(f"{MOE_ARCH} distrib", recorder)
        rows += phase_main_shapes(f"{TP_ARCH} distrib", tp_recorder)
        rows += phase_main_shapes(f"{SSM_ARCH} distrib", ssm_recorder)
        rows += phase_main_shapes(f"{SP_ARCH} distrib", sp_recorder)
        rows += phase_main_shapes(f"{TP_ARCH} adafactor distrib",
                                  ada_recorder)
        rows += phase_main_shapes(f"{TP_ARCH} param_gather distrib",
                                  pg_recorder)
        rows += phase_main_shapes(f"{MOE_ARCH} flat_dp distrib",
                                  flat_recorder)
        q, k_mine, v_mine, calls = sp_inputs
        flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        for name, launches, kw in calls:
            row = check_kernel(f"{ARCH}:{name}", q, k_mine, v_mine,
                               dict(kw, window=0, prefix_len=None,
                                    q_offset=torch.zeros(
                                        (), dtype=torch.int32,
                                        device="cuda")), flush)
            row["launches"] = launches
            rows.append(row)
        del flush
        assert_all_ok(rows)
        print(f"phase 3m r0 4 rows: {time.monotonic() - t0:.1f} s wall",
              flush=True)
    out["rows"] = rows
    dist.barrier()
    write_result(folder, f"distrib{rank}", out)


# sub-checks 1e-1g: (name, results key, arch, layers, optimizer, variant)
DISTRIB_VARIANTS = (
    ("adafactor", "ada", TP_ARCH, VARIANT_LAYERS, "adafactor", ""),
    ("param_gather", "pg", TP_ARCH, VARIANT_LAYERS, "adamw",
     "param_gather=bfloat16"),
    ("flat_dp", "flat", MOE_ARCH, VARIANT_LAYERS, "adamw", "flat_dp"))
TRAIN_DRY = """
import json, sys
from repro_torch import configs
from repro_torch.configs.base import ShapeSpec
from repro_torch.distrib import collectives as coll
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.train import optim
B, S = map(int, sys.argv[1:3])
dryrun.fake_world(4)
mesh = Mesh((2, 2), ("data", "model"), backend="fake")
out = {}
for form in ("direct", "all_reduce"):
    if form == "all_reduce":
        coll.collective_form = lambda mesh, x: "all_reduce"
    for name, arch, layers, opt, variant in json.loads(sys.argv[3]):
        cfg = configs.get(arch).replace(n_layers=layers)
        _, peak, _ = dryrun.trace_production(
            arch, ShapeSpec(name="train", kind="train", seq_len=S,
                            global_batch=B), mesh, cfg=cfg,
            overrides=dryrun.parse_variant(variant),
            opt=optim.OptConfig(name=opt))
        out.setdefault(name, {})[form] = peak
print("DRYPEAK " + json.dumps(out))
"""


def phase_distrib(ranks=None) -> list:
    """Phase 3m: DISTRIB_RANKS rank subprocesses of this script on the one
    card over gloo with CUDA tensors (the kernels built here first, the
    card's memory freed; ``ranks``, a ``RankProcs`` started with
    ``--distrib-rank``, or started here), the one-rank NCCL check here
    while they start up, and beside them (on the host) the dry run's
    trace of sub-checks 1e-1g's cells, each rank's peak printed against
    it.  Returns rank 0's phase 4 rows with its launches."""
    free_card()
    t0 = time.monotonic()
    dry = subprocess.Popen(
        [sys.executable, "-c", TRAIN_DRY, str(TRAIN_BATCH), str(TRAIN_SEQ),
         json.dumps([[name, arch, layers, opt, variant] for
                     name, _, arch, layers, opt, variant in
                     DISTRIB_VARIANTS])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "CUDA_VISIBLE_DEVICES": ""})
    try:
        with contextlib.ExitStack() as own:
            if ranks is None:
                ranks = own.enter_context(RankProcs(("--distrib-rank",),
                                                    ("distrib ",)))
            nccl = nccl_one_rank()
            results = ranks.results("distrib", DISTRIB_LIMIT_S)
        dry_out, dry_err = dry.communicate(timeout=DISTRIB_LIMIT_S)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait(timeout=60)
    check(dry.returncode == 0,
          f"distrib: the dry run failed:\n{dry_err[-3000:]}")
    dry_peaks = json.loads([x for x in dry_out.splitlines()
                            if x.startswith("DRYPEAK ")][-1][8:])
    wall = time.monotonic() - t0
    summary = {
        "wall_s": wall, "card": torch.cuda.get_device_name(0),
        "mesh": DISTRIB_MESH, "layers": DISTRIB_LAYERS,
        "losses": results[0]["train"]["losses"],
        "step_ms": {r["rank"]: r["train"]["step_ms"] for r in results},
        "peak_gib": {r["rank"]: r["train"]["peak_gib"] for r in results},
        "init_peak_gib": {r["rank"]: r["train"]["init_peak_gib"]
                          for r in results},
        "collective_share": {r["rank"]: r["train"]["collective_share"]
                             for r in results},
        "collective_gb_a_step": results[0]["train"]["collective_bytes"]
        / DISTRIB_STEPS / 1e9,
        "collectives_a_step": results[0]["train"]["collectives_a_step"],
        "stored_bytes": {r["rank"]: r["train"]["stored_bytes"]
                         for r in results},
        "parity": results[0]["parity"],
        "tp": {"arch": TP_ARCH, "layers": TP_LAYERS,
               "heads": results[0]["tp_train"]["heads"],
               **{key: {r["rank"]: r["tp_train"][key] for r in results}
                  for key in ("losses", "step_ms", "peak_gib",
                              "init_peak_gib", "stored_bytes",
                              "bytes_per_device", "collective_share")},
               "collective_gb_a_step":
               results[0]["tp_train"]["collective_bytes"]
               / DISTRIB_STEPS / 1e9,
               "collectives_a_step":
               results[0]["tp_train"]["collectives_a_step"],
               "parity": results[0]["tp_parity"]},
        **{name: {"arch": arch, "layers": layers,
                  **{key: {r["rank"]: r[train][key] for r in results}
                     for key in ("losses", "step_ms", "peak_gib",
                                 "init_peak_gib", "stored_bytes",
                                 "bytes_per_device", "collective_share",
                                 "stream_positions")},
                  "collective_gb_a_step":
                  results[0][train]["collective_bytes"] / TP_REC_STEPS
                  / 1e9,
                  "collectives_a_step":
                  results[0][train]["collectives_a_step"],
                  "parity": results[0][parity]}
           for name, arch, layers, train, parity in (
               ("tp_ssm", SSM_ARCH, TP_SSM_LAYERS, "ssm_train",
                "ssm_parity"),
               ("sp", SP_ARCH, SP_LAYERS, "sp_train", "sp_parity"))},
        **{name: {"arch": arch, "layers": layers, "opt": opt,
                  "variant": variant,
                  **{k: {r["rank"]: r[f"{key}_train"][k] for r in results}
                     for k in ("losses", "step_ms", "peak_gib",
                               "init_peak_gib", "stored_bytes",
                               "bytes_per_device", "collective_share")},
                  "collective_gb_a_step":
                  results[0][f"{key}_train"]["collective_bytes"]
                  / DISTRIB_STEPS / 1e9,
                  "collectives_a_step":
                  results[0][f"{key}_train"]["collectives_a_step"],
                  "collective_bytes_by_dtype_a_step":
                  results[0][f"{key}_train"][
                      "collective_bytes_by_dtype_a_step"],
                  "dry_peak_bytes": dry_peaks[name],
                  "parity": results[0][f"{key}_parity"]}
           for name, key, arch, layers, opt, variant in DISTRIB_VARIANTS},
        "sp_decode": results[0]["sp_decode"],
        "compress": {r["rank"]: r["compress"] for r in results},
        "pipeline": results[0]["pipeline"], "nccl_one_rank": nccl}
    for name, key, *_ in DISTRIB_VARIANTS:
        direct, form = (dry_peaks[name][f] for f in ("direct", "all_reduce"))
        # the step's own peak: what the rank held before the state's
        # init (earlier sub-checks' recorded kernel inputs) left out
        peaks = [(r["rank"], (r[f"{key}_train"]["peak_gib"]
                              - r[f"{key}_train"]["held_before_gib"])
                  * 2 ** 30) for r in results]
        print(f"distrib memory {name}: " + "; ".join(
            f"r{rank} card {got / 2**30:.3f} GiB, dry run "
            f"{direct / 2**30:.3f} ({got / direct - 1:+.1%}), all-reduce "
            f"form {form / 2**30:.3f} ({got / form - 1:+.1%})"
            for rank, got in peaks))
    print(f"distrib: phase 3m {wall:.1f}s wall, peak GiB by rank "
          f"{summary['peak_gib']}, {TP_ARCH} tensor parallel "
          f"{summary['tp']['peak_gib']}, {SSM_ARCH} "
          f"{summary['tp_ssm']['peak_gib']}, {SP_ARCH} "
          f"{summary['sp']['peak_gib']}")
    print("distrib " + json.dumps(summary))
    return results[0]["rows"]


# ---------------------------------------------------------------------------
# phase 3n: serving on a mesh, four ranks on the one card over gloo
# ---------------------------------------------------------------------------
SERVE_MESH = (2, 2)                 # (data, model)
SERVE_BATCH, SERVE_PROMPT, SERVE_CACHE = 4, 512, 1024
SERVE_STEPS = 2                     # qwen's greedy decode steps
SERVE_STEPS_CUT = 1                 # granite's, mamba2's, recurrentgemma's
# (arch, layers, decode steps), cut for the phase's time: a decode step
# gathers every layer's leaves over the data axis, a gloo call each
# through the host (on one H100 over gloo, at deeper cuts: qwen's 24
# layers 2.4-3.7 s a token, granite's 16 5.9-7.4, mamba2's 12 1.2-2.1,
# recurrentgemma's 3 4.3-6.8, most of it its 2.1 GB embedding's gather)
SERVE_RUNS = ((ARCH, 2, SERVE_STEPS), (MOE_ARCH, 2, SERVE_STEPS_CUT),
              (SSM_ARCH, 2, SERVE_STEPS_CUT), (HYBRID_ARCH, 3, SERVE_STEPS_CUT))
SERVE_CF = 2.0                      # MoE prefill's capacity factor, as the
                                    # dry run's (the reference's) cells
SERVE_PARITY = ((ARCH, 2), (MOE_ARCH, 2), (SSM_ARCH, 2), (HYBRID_ARCH, 3))
SERVE_PARITY_STEPS = 1
SERVE_PARITY_TOL = 1e-4             # of the largest logit, f32
SERVE_MEM_TOL = 0.10                # a rank's peak against the dry run's
SERVE_LIMIT_S = 600.0
SERVE_DRY = """
import json, sys
from repro_torch import configs
from repro_torch.configs.base import ShapeSpec
from repro_torch.distrib import collectives as coll
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
B, S, T = map(int, sys.argv[1:4])
dryrun.fake_world(4)
mesh = Mesh((2, 2), ("data", "model"), backend="fake")
out = {}
for form in ("direct", "all_reduce"):
    if form == "all_reduce":
        coll.collective_form = lambda mesh, x: "all_reduce"
    for arch, layers in json.loads(sys.argv[4]):
        cfg = configs.get(arch)
        cfg = cfg.replace(n_layers=layers or cfg.n_layers)
        for kind, seq, cache in (("prefill", S, T), ("decode", T, None)):
            _, peak, _ = dryrun.trace_production(
                arch, ShapeSpec(name="serve", kind=kind, seq_len=seq,
                                global_batch=B), mesh, cfg=cfg,
                cache_len=cache)
            out.setdefault(arch, {})[f"{kind}/{form}"] = peak
print("DRYPEAK " + json.dumps(out))
"""


def serve_model(arch, n_layers, mesh, **over):
    """``arch`` at full width, ``n_layers`` deep (None: all), a MoE
    config's experts padded to the model axis."""
    cfg = configs.get(arch)
    cfg = cfg.replace(n_layers=n_layers or cfg.n_layers, **over)
    if not cfg.moe.num_experts:
        return Model(cfg)
    return Model(cfg, e_pad=moe_layer.padded_experts(cfg,
                                                     mesh.shape["model"]))


def serve_layout(model, mesh):
    """The batch over the data axis, the experts over the model axis."""
    from repro_torch.distrib.tensor_parallel import TensorParallel
    moe = None
    if model.cfg.moe.num_experts:
        moe = moe_layer.MoESpmd(mesh=mesh, token_axes=("data",),
                                expert_axis="model")
    return TensorParallel(model, mesh, ("data",), "model", moe=moe)


def serve_blocks(model, tp, seed=0):
    """This rank's blocks of the seeded weights, drawn a part at a
    time."""
    return model.init(seed, device="cuda", keep=lambda path, part:
                      train_step._blocks(part, tp.spec_at(path), tp.mesh))


def serve_prompts(cfg, seed=5):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return torch.randint(1, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                         generator=gen, device="cuda")


def serve_greedy(model, params, toks, steps, **kw):
    """(prefill logits, decode logits (steps, B, V), greedy tokens)."""
    logits, cache = model.prefill(params, toks, cache_len=SERVE_CACHE,
                                  **kw.get("prefill", {}))
    nxt, outs, picked = logits.argmax(-1), [], []
    for i in range(steps):
        picked.append(nxt)
        out, cache = model.decode_step(params, cache, nxt[:, None],
                                       SERVE_PROMPT + i,
                                       **kw.get("decode", {}))
        outs.append(out)
        nxt = out.argmax(-1)
    return logits, torch.stack(outs), torch.stack(picked, 1)


def serve_counts() -> dict:
    return {"flash_attention": fa.attention.launches,
            "moe_router": kr.router_dispatch.launches,
            "moe_combine": kc.moe_combine.launches,
            "ssd": kssd.ssd.launches, "rglru": krg.rglru.launches}


class ServeRecorder(MainPathRecorder):
    """``MainPathRecorder`` that also records the attention partial of
    ``sp_decode_attention`` (the kernel's forward with lse), under the
    entry point ``"decode sp"``, and holds its copies on the host, so
    that the rank's peak on the card is its serving path's own;
    ``to_card`` moves them back for phase 4."""

    @staticmethod
    def _copy(t):
        return None if t is None else t.detach().to("cpu")

    def to_card(self):
        def card(x):
            if torch.is_tensor(x):
                return x.to("cuda")
            return {k: card(v) for k, v in x.items()} \
                if isinstance(x, dict) else x
        for rec in self.seen.values():
            rec["inputs"] = tuple(map(card, rec["inputs"]))

    def install(self):
        super().install()
        from repro_torch.distrib import collectives as dcoll
        dcoll.attention_fwd = self._partial

    def uninstall(self):
        super().uninstall()
        from repro_torch.distrib import collectives as dcoll
        dcoll.attention_fwd = fa.attention_fwd

    def _partial(self, q, k, v, **kw):
        before = fa.attention.launches
        out = fa.attention_fwd(q, k, v, **kw)
        B, S, Hq, D = q.shape
        off = kw.get("q_offset", 0)
        off = self._copy(off) if torch.is_tensor(off) else off
        kw = dict(kw, q_offset=off)
        self._record(("flash_attention", "decode sp", B, S, k.shape[1], Hq,
                      k.shape[2], D, q.dtype, mask_tag(kw)),
                     fa.attention.launches - before,
                     (self._copy(q), self._copy(k), self._copy(v), kw))
        return out


def serve_run(mesh, rank, arch, n_layers, steps, recorder=None):
    """One arch's sharded prefill and ``steps`` greedy decode steps in
    bf16: times, collectives, peaks and launches, each checked."""
    import torch.distributed as dist
    from repro_torch.distrib import collectives as dcoll
    model = serve_model(arch, n_layers, mesh)
    cfg = model.cfg
    tp = serve_layout(model, mesh)
    blocks = serve_blocks(model, tp)
    toks = local_block(serve_prompts(cfg), ("data",), mesh)
    n = {"flash_attention": sum(k in ATTN_KINDS for k in model.kinds),
         "ssd": sum(k == "ssd" for k in model.kinds),
         "rglru": sum(k == "rglru" for k in model.kinds)}
    n["moe_router"] = n["moe_combine"] = (
        cfg.n_layers - model.prefix_count if cfg.moe.num_experts else 0)
    if recorder is not None:
        recorder.install()
    try:
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        before = serve_counts()
        t0 = time.perf_counter()
        with dcoll.record() as pre_recs:
            logits, cache = model.prefill(blocks, toks,
                                          cache_len=SERVE_CACHE, spmd=tp,
                                          capacity_factor=SERVE_CF)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_peak = torch.cuda.max_memory_allocated()
        mid = serve_counts()
        torch.cuda.reset_peak_memory_stats()
        nxt = logits.argmax(-1)
        dist.barrier()
        t0 = time.perf_counter()
        with dcoll.record() as dec_recs:
            for i in range(steps):
                out, cache = model.decode_step(
                    blocks, cache, nxt[:, None], SERVE_PROMPT + i, spmd=tp,
                    cache_len=SERVE_CACHE)
                nxt = out.argmax(-1)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / steps
        decode_peak = torch.cuda.max_memory_allocated()
        after = serve_counts()
    finally:
        if recorder is not None:
            recorder.uninstall()
    prefill_n = {k: mid[k] - before[k] for k in n}
    decode_n = {k: after[k] - mid[k] for k in n}
    want_decode = dict(n, ssd=0, rglru=0)
    check(prefill_n == n, f"serve {arch}: prefill launches {prefill_n}, "
          f"want one a layer {n}")
    check(decode_n == {k: v * steps for k, v in want_decode.items()},
          f"serve {arch}: {steps} decode steps launched {decode_n}, want "
          f"{want_decode} a step")
    check(bool(torch.isfinite(logits).all() and torch.isfinite(out).all()),
          f"serve {arch}: logits not finite")
    reduces = [r for r in dec_recs if r["op"] == "all-reduce"]
    res = {"arch": arch, "layers": cfg.n_layers, "steps": steps,
           "prefill_ms": prefill_ms, "decode_ms_a_token": decode_ms,
           "prefill_peak": prefill_peak, "decode_peak": decode_peak,
           "prefill_collectives": len(pre_recs),
           "prefill_bytes": sum(r["result_bytes"] for r in pre_recs),
           "all_reduces_a_step": len(reduces) / steps,
           "all_reduce_bytes_a_step":
           sum(r["result_bytes"] for r in reduces) / steps,
           "collectives_a_step": len(dec_recs) / steps,
           "prefill_launches": prefill_n, "decode_launches": decode_n,
           "cache": {k: list(v.shape) for k, v in cache.items()}}
    print(f"serve r{rank} {arch} ({cfg.n_layers} layers): prefill "
          f"{prefill_ms:.1f} ms, decode {decode_ms:.1f} ms a token, "
          f"{res['all_reduces_a_step']:g} all-reduces of "
          f"{res['all_reduce_bytes_a_step'] / 1e9:.4f} GB a step "
          f"({res['collectives_a_step']:g} collectives), peak "
          f"{prefill_peak / 2**30:.2f} / {decode_peak / 2**30:.2f} GiB, "
          f"launches prefill {prefill_n} decode {decode_n}", flush=True)
    del blocks, cache, logits, out
    free_card()
    return res


def serve_parity(mesh, rank, arch, n_layers):
    """``arch`` at ``n_layers`` in f32, TF32 off: this rank's rows of the
    sharded prefill and decode against one process's unsharded ones."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = serve_model(arch, n_layers, mesh, compute_dtype="float32")
    tp = serve_layout(model, mesh)
    toks = serve_prompts(model.cfg, seed=6)
    whole = serve_greedy(model, model.init(0, device="cuda"), toks,
                         SERVE_PARITY_STEPS)
    free_card()
    got = serve_greedy(model, serve_blocks(model, tp),
                       local_block(toks, ("data",), mesh),
                       SERVE_PARITY_STEPS, prefill={"spmd": tp},
                       decode={"spmd": tp, "cache_len": SERVE_CACHE})
    b = SERVE_BATCH // mesh.shape["data"]
    i = mesh.coords["data"]
    want = (whole[0][i * b:(i + 1) * b], whole[1][:, i * b:(i + 1) * b],
            whole[2][i * b:(i + 1) * b])
    errs = [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got[:2], want[:2])]
    same = bool(torch.equal(got[2], want[2]))
    res = {"arch": arch, "layers": n_layers, "prefill_err": errs[0],
           "decode_err": errs[1], "tol": SERVE_PARITY_TOL,
           "tokens_equal": same}
    print(f"serve r{rank} {arch} parity ({n_layers} layers, f32): "
          f"prefill {errs[0]:.3g}, decode {errs[1]:.3g} of the largest "
          f"logit, greedy tokens equal {same}", flush=True)
    check(max(errs) <= SERVE_PARITY_TOL and same,
          f"serve parity {arch}: {res}")
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32
    del whole, got
    free_card()
    return res


def serve_rank(rank: int, folder: str, mesh) -> None:
    """One rank of phase 3n on ``mesh``: the serving runs, their parity
    and rank 0's phase 4 rows; writes its results to
    ``folder/serve<rank>.json``."""
    import torch.distributed as dist
    clock = PhaseClock()
    recorder = ServeRecorder(chunkable=False) if rank == 0 else None
    out = {"rank": rank, "runs": [], "parity": []}
    for arch, n_layers, steps in SERVE_RUNS:
        with clock(f"3n r{rank} {arch}"):
            out["runs"].append(serve_run(mesh, rank, arch, n_layers, steps,
                                         recorder))
    for arch, n_layers in SERVE_PARITY:
        with clock(f"3n r{rank} {arch} parity"):
            out["parity"].append(serve_parity(mesh, rank, arch, n_layers))
    dist.barrier()
    rows = []
    if rank == 0:                  # alone on the card: the others wait
        with clock("3n r0 4 rows"):
            recorder.to_card()
            rows = phase_main_shapes("serve", recorder)
    out["rows"] = rows
    dist.barrier()
    write_result(folder, f"serve{rank}", out)


class RankProcs:
    """``DISTRIB_RANKS`` subprocesses of this script, a rank each, started
    with ``flags`` (each given the rank) and a rendezvous folder; their
    lines that start with one of ``tags`` or with "phase " (and all of
    rank 0's) echoed.  ``results(name, limit_s)`` waits for every rank's
    ``<name><rank>.json``: a rank that fails or exits without it, or a
    wait past ``limit_s``, fails the phase.  As a context manager,
    leaving it waits for the ranks to exit (any left running are
    killed)."""

    def __init__(self, flags, tags):
        import tempfile
        self._dir = tempfile.TemporaryDirectory(prefix="ranks-")
        self.folder = self._dir.name
        self.tags = tuple(tags) + ("phase ",)
        self.t_spawn = time.monotonic()
        self.procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve())]
            + [a for f in flags for a in (f, str(r))]
            + ["--distrib-dir", self.folder],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(DISTRIB_RANKS)]
        self.tails = [[] for _ in self.procs]
        self.first = {}             # a rank's first line: its start-up
        self.readers = [threading.Thread(target=self._pump, args=(i,),
                                         daemon=True)
                        for i in range(len(self.procs))]
        for t in self.readers:
            t.start()

    def _pump(self, i):
        for line in self.procs[i].stdout:
            line = line.rstrip("\n")
            self.first.setdefault(i, time.monotonic() - self.t_spawn)
            self.tails[i] = (self.tails[i] + [line])[-40:]
            if i == 0 or line.startswith(self.tags) or "Error" in line:
                sys.stdout.write(line + "\n")
                sys.stdout.flush()

    def _check_alive(self, what):
        failed = [i for i, p in enumerate(self.procs)
                  if p.poll() is not None and p.returncode]
        check(not failed, f"{what}: rank {failed} failed (rc "
              f"{[self.procs[i].returncode for i in failed]}):\n"
              + "\n".join(self.tails[failed[0]] if failed else []))

    def results(self, name: str, limit_s: float) -> list:
        paths = [Path(self.folder, f"{name}{r}.json")
                 for r in range(DISTRIB_RANKS)]
        deadline = time.monotonic() + limit_s
        while not all(p.exists() for p in paths):
            self._check_alive(name)
            gone = [i for i, p in enumerate(self.procs)
                    if p.poll() is not None and not paths[i].exists()]
            check(not gone, f"{name}: rank {gone} exited without its "
                  f"results")
            check(time.monotonic() < deadline,
                  f"{name}: ranks still running after {limit_s}s")
            time.sleep(0.2)
        print(f"{name} ranks: first line after "
              f"{[round(self.first.get(i, -1.0), 1) for i in range(len(self.procs))]}"
              f" s, results after {time.monotonic() - self.t_spawn:.1f} s",
              flush=True)
        return [json.loads(p.read_text()) for p in paths]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        try:
            if exc[0] is None:
                deadline = time.monotonic() + 120.0
                while (any(p.poll() is None for p in self.procs)
                       and time.monotonic() < deadline):
                    self._check_alive("ranks")
                    time.sleep(0.2)
                self._check_alive("ranks")
                check(all(p.poll() is not None for p in self.procs),
                      "ranks: still running after their results")
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                p.wait(timeout=60)
            for t in self.readers:
                t.join(timeout=10)
            self._dir.cleanup()


def phase_serve(ranks=None) -> list:
    """Phase 3n: the serving ranks (``ranks``, a ``RankProcs`` started
    with ``--serve-rank``, or started here), and beside them (on the
    host) the dry run's trace of each run's same cells; each rank's
    peaks against it, within ``SERVE_MEM_TOL``.  Returns rank 0's phase
    4 rows."""
    free_card()
    t0 = time.monotonic()
    dry = subprocess.Popen(
        [sys.executable, "-c", SERVE_DRY, str(SERVE_BATCH),
         str(SERVE_PROMPT), str(SERVE_CACHE),
         json.dumps([[arch, layers] for arch, layers, _ in SERVE_RUNS])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "CUDA_VISIBLE_DEVICES": ""})
    try:
        with contextlib.ExitStack() as own:
            if ranks is None:
                ranks = own.enter_context(RankProcs(("--serve-rank",),
                                                    ("serve ",)))
            results = ranks.results("serve", SERVE_LIMIT_S)
        out, err = dry.communicate(timeout=SERVE_LIMIT_S)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait(timeout=60)
    check(dry.returncode == 0, f"serve: the dry run failed:\n{err[-3000:]}")
    peaks = json.loads([x for x in out.splitlines()
                        if x.startswith("DRYPEAK ")][-1][8:])
    wall = time.monotonic() - t0
    memory = {}
    for r in results:
        for run in r["runs"]:
            dry_run = peaks[run["arch"]]
            for kind in ("prefill", "decode"):
                got = run[f"{kind}_peak"]
                direct = dry_run[f"{kind}/direct"]
                form = dry_run[f"{kind}/all_reduce"]
                memory.setdefault(f"{run['arch']} {kind}", {})[r["rank"]] = {
                    "card": got, "dry_direct": direct,
                    "dry_all_reduce": form, "off_direct": got / direct - 1,
                    "off_all_reduce": got / form - 1,
                    "within": abs(got / direct - 1) <= SERVE_MEM_TOL}
    summary = {"wall_s": wall, "card": torch.cuda.get_device_name(0),
               "mesh": SERVE_MESH, "batch": SERVE_BATCH,
               "prompt": SERVE_PROMPT, "cache": SERVE_CACHE,
               "runs": {run["arch"]: {
                   key: {r["rank"]: r["runs"][i][key] for r in results}
                   for key in ("prefill_ms", "decode_ms_a_token",
                               "prefill_peak", "decode_peak")}
                   | {key: results[0]["runs"][i][key] for key in (
                       "layers", "steps", "all_reduces_a_step",
                       "all_reduce_bytes_a_step", "collectives_a_step",
                       "prefill_collectives", "prefill_bytes",
                       "prefill_launches", "decode_launches", "cache")}
                   for i, run in enumerate(results[0]["runs"])},
               "parity": {r["rank"]: r["parity"] for r in results},
               "memory": memory, "dry_peaks": peaks}
    for kind, ranks in memory.items():
        print(f"serve memory {kind}: " + "; ".join(
            f"r{rk} card {m['card'] / 2**30:.3f} GiB, dry run "
            f"{m['dry_direct'] / 2**30:.3f} ({m['off_direct']:+.1%}), "
            f"all-reduce form {m['dry_all_reduce'] / 2**30:.3f} "
            f"({m['off_all_reduce']:+.1%})" for rk, m in ranks.items()))
    print(f"serve: phase 3n {wall:.1f}s wall")
    print("serve " + json.dumps(summary))
    missed = {f"{key} r{rk}": f"{m['off_direct']:+.1%}"
              for key, ranks in memory.items() for rk, m in ranks.items()
              if not m["within"]}
    check(not missed, f"serve: a rank's peak is not within "
          f"{SERVE_MEM_TOL:.0%} of the dry run's: {missed}")
    return results[0]["rows"]


def nccl_one_rank() -> dict:
    """Sub-check 5, in this process: a one-rank NCCL world and mesh
    (data 1, model 1); the parity step through it against the step
    without a mesh, printed bitwise and held to 1e-6; then the gather
    rules in NCCL's form (``nccl_forms``)."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    with tempfile.TemporaryDirectory(prefix="nccl-") as folder:
        dist.init_process_group("nccl", init_method=f"file://{folder}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_local_mesh(1, backend="nccl")
            model, ocfg, par, batch, state, loss = distrib_parity_step(mesh)
            whole = gathered_params(model, state, mesh)
            del state
            loss_err, worst, same = parity_against_one_process(
                "distrib nccl one rank", model, ocfg, par, batch, whole,
                loss, 1e-6)
            forms = nccl_forms(mesh)
        finally:
            dist.destroy_process_group()
    free_card()
    return {"loss_err": loss_err, "worst_leaf_err": worst,
            "bitwise_leaves": same, "leaves": len(whole), "forms": forms}


def nccl_forms(mesh) -> dict:
    """``GatherFromAxes`` and ``ReduceScatterToAxes`` over the one-rank
    data axis of an NCCL mesh, forward and backward, on a CUDA leaf
    split on its last dim as ``wo`` is (a spec that names the axis: the
    resolver splits nothing over one rank, so the one-rank step itself
    gathers nothing).  NCCL takes the direct form: its all-gather and
    reduce-scatter calls, counted; over one rank the block and the
    gradient come back bitwise."""
    from repro_torch.distrib import collectives as coll
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    x = torch.randn((16, 64, 1024), generator=gen, device="cuda")
    gy = torch.randn((16, 64, 1024), generator=gen, device="cuda")
    spec, axes = (None, None, "data"), ("data",)
    clock = CollectiveClock()
    clock.install()
    try:
        xg = x.clone().requires_grad_()
        y = coll.GatherFromAxes.apply(xg, spec, mesh, axes)
        (y * gy).sum().backward()
        xs = x.clone().requires_grad_()
        w = coll.ReduceScatterToAxes.apply(xs, spec, mesh, axes)
        (w * gy).sum().backward()
        torch.cuda.synchronize()
    finally:
        clock.uninstall()
    form = coll.collective_form(mesh, x)
    exact = all(torch.equal(a, b) for a, b in
                ((y, x), (xg.grad, gy), (w, x), (xs.grad, gy)))
    calls = {k: rec["calls"] for k, rec in clock.by_kind.items()}
    print(f"distrib nccl one rank: form {form}; calls {calls}; gather and "
          f"reduce-scatter rules bitwise {exact}", flush=True)
    check(form == "direct" and exact and set(calls) == {
        coll._ALL_GATHER, coll._REDUCE_SCATTER},
          f"nccl forms: form {form}, calls {calls}, bitwise {exact}")
    return {"form": form, "calls": calls, "bitwise": exact}


# ---------------------------------------------------------------------------
# the summary
# ---------------------------------------------------------------------------
SOURCE = {"flash_attention": ("src/repro_torch/kernels/csrc/"
                              "flash_attention.cu",
                              "src/repro/kernels/flash_attention.py:96"),
          # no Pallas backward: the reference differentiates ops.attention
          # with XLA's autodiff
          "flash_attention_bwd": ("src/repro_torch/kernels/csrc/"
                                  "flash_attention_bwd.cu",
                                  "src/repro/kernels/ops.py:43"),
          "moe_router": ("src/repro_torch/kernels/csrc/moe_router.cu",
                         "src/repro/kernels/moe_router.py:43"),
          "fletcher64": ("src/repro_torch/kernels/csrc/fletcher64.cu",
                         "src/repro/kernels/fletcher.py:101"),
          "ssd": ("src/repro_torch/kernels/csrc/ssd.cu",
                  "src/repro/kernels/ssd.py:80"),
          # no Pallas backwards: the reference differentiates
          # ops.router_topk and ops.ssd with XLA's autodiff
          "moe_router_bwd": ("src/repro_torch/kernels/csrc/moe_router.cu",
                             "src/repro/kernels/ops.py:376"),
          # the reference's combine is XLA's gather and scatter-add; its
          # backward, with the router's, XLA's autodiff
          "moe_combine": ("src/repro_torch/kernels/csrc/moe_combine.cu",
                          "src/repro/models/moe.py:161"),
          "moe_combine_bwd": ("src/repro_torch/kernels/csrc/moe_combine.cu",
                              "src/repro/kernels/ops.py:376"),
          "ssd_bwd": ("src/repro_torch/kernels/csrc/ssd_bwd.cu",
                      "src/repro/kernels/ops.py:223"),
          "rglru": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                    "src/repro/kernels/rglru_scan.py:65"),
          # no Pallas backward: the reference differentiates ops.rglru
          # with XLA's autodiff
          "rglru_bwd": ("src/repro_torch/kernels/csrc/rglru_bwd.cu",
                        "src/repro/kernels/ops.py:326"),
          # no Pallas kernel: the reference's loss is jnp that XLA fuses
          "cross_entropy": ("src/repro_torch/kernels/csrc/cross_entropy.cu",
                            "src/repro/models/common.py:203")}


def summary_row(r):
    source, replaces = SOURCE[r["kernel"]]
    return {"name": f"{r['kernel']}:{r['case']} {r['shape']}",
            "route": "cuda", "source": source, "replaces": replaces,
            "launches": r["launches"],
            # the same number, also under the key earlier summaries used
            "max_abs_err": r["max_abs_err"], "max_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **{k: r[k] for k in ("path", "n_split", "chunk_len", "hs")
               if k in r}}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


class PhaseClock:
    """Each phase's wall seconds: ``with clock("3a"):`` prints the phase's
    seconds on a line of its own when it ends, and ``line()`` gives them
    all."""

    def __init__(self):
        self.seconds = {}

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.seconds[name] = time.monotonic() - t0
            print(f"phase {name}: {self.seconds[name]:.1f} s wall",
                  flush=True)

    def line(self) -> str:
        return "phase seconds " + json.dumps(
            {k: round(v, 1) for k, v in self.seconds.items()})


def train_phases(clock=None) -> list:
    """Phases 3h, 3i and 3j with their phase 4 rows (each recorder's
    inputs freed as they are checked), each followed by its repeat
    check, each timed by ``clock`` (a ``PhaseClock``)."""
    clock = clock or PhaseClock()
    with clock("3h"):
        ssm_rec, ssm_ckpt = ssm_train_path()
        rows = phase_main_shapes(f"{SSM_ARCH} train", ssm_rec)
        rows += phase_main_shapes(f"{SSM_ARCH} train", ssm_ckpt)
        del ssm_rec, ssm_ckpt
        repeat_check(SSM_ARCH)
    with clock("3i"):
        rows += phase_main_shapes(f"{MOE_ARCH} train", moe_train_path())
        repeat_check(MOE_ARCH)
    with clock("3j"):
        rows += phase_main_shapes(f"{HYBRID_ARCH} train",
                                  hybrid_train_path())
        repeat_check(HYBRID_ARCH, n_layers=HYBRID_TRAIN_LAYERS)
    return rows


def breadth_phases(clock=None) -> list:
    """Phases 3o, 3p and 3q (``BREADTH``) and 3r (``optimizer_path``),
    each with its phase 4 rows, each timed by ``clock``."""
    clock = clock or PhaseClock()
    rows = []
    for phase, arch, param_dtype, n_layers in BREADTH:
        with clock(phase):
            rows += phase_main_shapes(arch, breadth_path(arch, param_dtype,
                                                         n_layers))
    with clock("3r"):
        adafactor, micro = optimizer_path()
        rows += phase_main_shapes(f"{ARCH} adafactor train", adafactor)
        rows += phase_main_shapes(f"{ARCH} microbatch train", micro)
    return rows


def train_breadth_phases(clock=None) -> list:
    """Phases 3s, 3t and 3u (``TRAIN_BREADTH``), each with its phase 4
    rows, each timed by ``clock``."""
    clock = clock or PhaseClock()
    rows = []
    for row in TRAIN_BREADTH:
        with clock(row[0]):
            rows += phase_main_shapes(f"{row[1]} train",
                                      train_breadth_path(row))
    return rows


def parity_phases(clock=None) -> None:
    """Phase 5, timed by ``clock``: serving parity, then training
    parity."""
    clock = clock or PhaseClock()
    with clock("5 serving parity"):
        for arch, S in ((ARCH, 128), (MOE_ARCH, 128), (SSM_ARCH, 640),
                        (HYBRID_ARCH, 640), (VLM_ARCH, 128),
                        (ENCDEC_ARCH, 128)):
            phase_parity(arch, S)
        for arch, S, n_layers, param_dtype in BREADTH_PARITY:
            phase_parity(arch, S, n_layers, param_dtype)
    with clock("5 training parity"):
        for arch in (ARCH, MOE_ARCH) + FRONTEND_ARCHS:
            phase_train_parity(arch)
        ssm_train_parity()
        for n in (HYBRID_PARITY_LAYERS, HYBRID_TRAIN_LAYERS):
            phase_train_parity(HYBRID_ARCH, n_layers=n)
        for arch, n_layers, B, S in TRAIN_BREADTH_PARITY:
            phase_train_parity(arch, B, S, n_layers)


def frontend_phases(arch) -> list:
    """Phase 3k (paligemma-3b) or 3l (seamless-m4t-large-v2): serving,
    then training, each followed by its phase 4 rows."""
    rows = phase_main_shapes(arch, serve_path(arch))
    for recorder in frontend_train_path(arch):
        rows += phase_main_shapes(f"{arch} train", recorder)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-2 only: build, check and time the "
                         "kernels (no serving, no final ok line)")
    ap.add_argument("--fabric-replica", metavar="REGISTRY_URI",
                    help="run one replica of phase 3f, registered with "
                         "REGISTRY_URI (phase 3f starts these itself)")
    ap.add_argument("--distrib-rank", type=int, metavar="RANK",
                    help="run one rank of phase 3m (phase 3m starts "
                         "these itself; with --serve-rank, 3n after it)")
    ap.add_argument("--distrib-dir", metavar="DIR",
                    help="phase 3m's and 3n's rendezvous folder")
    ap.add_argument("--serve-rank", type=int, metavar="RANK",
                    help="run one rank of phase 3n (phase 3n starts "
                         "these itself)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    if args.fabric_replica:
        return fabric_replica(args.fabric_replica)
    if args.distrib_rank is not None or args.serve_rank is not None:
        parts = [part for part, r in (("distrib", args.distrib_rank),
                                      ("serve", args.serve_rank))
                 if r is not None]
        rank = (args.distrib_rank if args.distrib_rank is not None
                else args.serve_rank)
        return mesh_rank(rank, args.distrib_dir, parts)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    clock = PhaseClock()
    t_run = time.monotonic()
    with clock("1 build"):
        t0 = time.monotonic()
        kbuild.build_all(SOURCES)
        print(f"build: {time.monotonic() - t0:.1f}s for {len(SOURCES)} "
              f"sources in parallel")
        for name, log in kbuild.build_logs.items():
            print(f"--- nvcc {name}.cu ---\n{log.strip()}")

    with clock("2 kernels"):
        phase_kernels()
    if args.kernels_only:
        return 0

    with clock("3a"):
        rows = phase_main_shapes(ARCH, serve_path(ARCH))
    with clock("3f"):
        rows += phase_fabric(card)
    with clock("3b"):
        rows += phase_main_shapes(MOE_ARCH, serve_path(MOE_ARCH))
        moe_layer_check()
    with clock("3c"):
        recorder = checkpoint_path()
        free_card()
        rows += phase_main_shapes(ARCH, recorder)
    with clock("3g"):
        train_rec, train_ckpt = train_path()
        rows += phase_main_shapes(f"{ARCH} train", train_rec)
        rows += phase_main_shapes(f"{ARCH} train", train_ckpt)
        del train_rec, train_ckpt
    with clock("3w"):
        rows += phase_main_shapes(f"{ARCH} cell train", cell_step_path())
        loss_head_path()
    rows += train_phases(clock)
    for phase, arch in (("3d", SSM_ARCH), ("3e", HYBRID_ARCH)):
        with clock(phase):
            rows += phase_main_shapes(arch, serve_path(arch))
    for phase, arch in zip(("3k", "3l"), FRONTEND_ARCHS):
        with clock(phase):
            rows += frontend_phases(arch)
    rows += breadth_phases(clock)
    rows += train_breadth_phases(clock)
    parity_phases(clock)
    # one set of rank processes for 3m and then 3n: one start-up
    with RankProcs(("--distrib-rank", "--serve-rank"),
                   ("distrib ", "serve ")) as ranks:
        with clock("3m"):
            rows += phase_distrib(ranks)
        with clock("3n"):
            rows += phase_serve(ranks)

    lost = {}
    for r in rows:
        key = f"{r['kernel']}:{r['case']}"
        lost[key] = lost.get(key, 0.0) + r["launches"] * (r["ms"]
                                                          - r["bound_ms"])
    print("lost ms, launches x (ms - bound_ms) by kernel and path: "
          + json.dumps(dict(sorted(lost.items(), key=lambda kv: -kv[1]))))
    floor = timing_floor(torch.empty(256 << 20, dtype=torch.uint8,
                                     device="cuda"))
    print(clock.line())
    print(f"chip_smoke: {time.monotonic() - t_run:.1f} s wall from the "
          f"build to the summary")
    print(card)
    print(json.dumps({"kernels": [summary_row(r) for r in rows],
                      "timing_floor_ms": floor}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

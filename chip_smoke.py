"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, each printed on its own line (any failure fails the run):

1. the card's name and power limit, as nvidia-smi reports them;
2. build the port's CUDA kernels from the sources in this checkout
   (``src/repro_torch/kernels/*/csrc``), one nvcc per source, all
   started together, printing ptxas's registers and spills of each
   kernel it compiled; K2's tma instances at G 3 and 5 must have no
   stack frame (no spills), as ``cuobjdump`` reads the built library;
3. hold each kernel, through the wrapper the engine calls, against its
   plain PyTorch version on the card, at the serving path's shapes:
   f32 within 1e-4; bf16 within 6e-2 and, since both sides accumulate
   in float32 from the same inputs and round once, within one bf16 ulp
   (2^-7 relative).  K1 (paged attention) at T = 1 and 64; K2 (paged
   decode) in bf16 on its tma route at olmo-1b's widths and those of
   phase 23's models (llama3.2-1b, G 4, hd 64; phi4-mini-3.8b, 24
   heads over 8, G 3; gemma3-27b, 32 over 16, G 2; llama4-maverick, 40
   over 8, G 5), in float32 at olmo-1b's and smoke widths, contexts of
   96-1,087 and 1-2,048 tokens, with ``zero_empty`` off (a row without
   keys gets the uniform mean) and on (zeros), and against K1 at T = 1
   over base + 1 positions, two calls bit-equal; K3 (verify
   attention) at T = 5 and 64 on tables whose lanes share their prefix
   pages, also against K1 on the same inputs; the wgmma/TMA routes of
   K1 and K3 (bf16, hd 64 and 128, pages of 64) at the same bf16
   widths and T = 1, 5, 8, 16, 64, 100, with bases off the
   page grid, dead pages inside a run, an idle lane, rows that see no
   key and a hot prefix page mapped by all 8 lanes: within one ulp of
   the plain version, K3 within one ulp of K1, two calls bit-equal,
   and the float32, hd 16 and page-8 shapes on the present kernels; K4
   (SSD scan, f32 and
   bf16) and K5 (RG-LRU, float32 only) at T = 1 and 64 at full width
   and at smoke width, from a carried state, with inert lanes whose
   state must stay bit for bit, two calls bit-equal, and K4's wgmma
   route (bf16, P 64) at T = 3, 16, 64, 100 and 200 and at N = 64, the
   state within 1e-4; K5 bit-equal to its plain version on the route
   ``ops.lru_route`` picks, and its tma route at T = 3, 16, 64, 100 and
   200 and d = 2560 and 192, bit-equal, inert lanes bit for bit, two
   calls bit-equal; K6 (causal flash attention) on strided
   [B, S, H, hd] views, each of its forward kernels: the wgmma/TMA one
   (bf16, hd 64 and 128) at olmo-1b's and llama3.2-1b's widths, with a
   ragged S and bidirectional, the mma.sync one (bf16, hd 16) and the
   float32 one at smoke width, with a ragged S and bidirectional; its
   backward kernels against autograd through the plain version, each
   on the route ``ops.backward_route`` picks: the wgmma/TMA route (bf16,
   hd 64 and 128) at olmo-1b's and llama3.2-1b's widths, S up to 2048
   (at B 4, the training shape, too), a ragged S and bidirectional,
   within 6e-2, and against its walk with bf16 P and dS each row within
   2^-5 of its own scale, where two controls of the walk (a late tile
   pair dropped, delta left out) must lie beyond it; the mma.sync
   kernels at hd 16 and the float32 ones within 1e-4, and two backward
   calls on the same inputs bit-equal; K6 at hd 96 (bf16 on its wgmma
   route over tiles padded to two 64-column atoms, and on the mma.sync
   instance it replaced by explicit route; float32 on FMAs) causal at
   S = 640 (phi-3-vision's prefill), at a ragged S and bidirectional,
   bidirectional K6 at S = 1,500, hd 64 (whisper-tiny's encoder) on
   its wgmma route, K1 (T = 1 and 64) at phi-3-vision's width (hd 96,
   pages of 64) on its wgmma route and on the fma kernel it replaced,
   and K2 there on its tma route and on the fma kernel it replaced,
   each within one ulp of the plain version (f32 1e-4) and K2 of K1 at
   T = 1, two calls bit-equal; K3 asked for its wgmma route at hd 96
   raises before any launch; K4's step route (bf16, T = 1, P 64, N 128
   and 64) within one ulp of the plain version and of the fma kernel on
   the same inputs, the state within 1e-4, the inert lane bit for bit,
   two calls bit-equal;
4. check the port's engine on the card against the same engine on the
   CPU (where every kernel wrapper runs its plain version) on smoke
   configs: identical tokens and status rows, for olmo-1b's plain path
   and, with speculation, the hot-prefix workload of
   ``tests/test_speculative.py``, with pinned prefixes and preemption
   (``SchedConfig(pin_pages=8, page_budget=6)``: pool leaves and pin
   tables identical too), for recurrentgemma-2b and
   mamba2-370m with two size classes, and for whisper-tiny and
   phi-3-vision-4.2b with one and two; then training: three steps of
   ``launch/train.py::build_step`` on the smoke olmo-1b, mamba2-370m
   and recurrentgemma-2b in f32 from the same parameters and
   ``TokenStream`` batches on both devices (step 0's loss within 1e-4
   and its gradients within 1e-4 or twice a leaf's CPU one-ulp floor,
   later losses within 1e-3 relative), and each smoke trainer through
   ``FaultTolerantLoop`` with one injected failure: one restart, the
   uninterrupted run's losses;
5. the plain path: serve olmo-1b at full width (16 layers x 2048, 16
   heads, hd 128, vocab 50304, bf16, page size 64) with random weights
   from ``--seed`` through ``ServingEngine.run``: every request
   finishes, the pool drains leak-free, K1 ran 16 times on each step
   with a prompt lane (each on its wgmma route) and K2 16 times on
   each decode-only step (each on its tma route), no other kernel ran,
   and each step made exactly one device-to-host transfer;
6. time K1 (its wgmma route), the present kernel it replaced on the
   same inputs, its plain version, a PyTorch library call for the same
   attention and the bound, at the serving shapes;
7. the speculative path: the same engine settings with draft length 4
   serve hot-prefix traffic (4 system prompts of 512 tokens, user tails
   of 32-128 tokens, half of the requests repeating an earlier prompt
   exactly, 32 requests of 64 new tokens) with and without
   speculation: K3 ran 16 times per speculative step (its launches
   printed by lane width), K2 16 times per decode-only step and K1 16
   times per other step, K1 and K3 on their wgmma routes in bf16, one
   transfer per step, leak-free; in f32 both runs give identical
   tokens; in bf16 the count of identical streams is printed;
8. time K3 (its wgmma route, with the device time of its partials and
   merge kernels under the profiler) at T = 5 on hot-prefix tables and
   at T = 64, beside the present kernel, its bound, its plain version
   and SDPA;
9. the SSD path: serve mamba2-370m at full width (48 SSD layers, d_model
   1024, 32 heads of 64, state 128, bf16) with two size classes, the
   workload of phase 5, max_len 2048: every request finishes, K4 ran 48
   times per step (on its step route at T = 1, its wgmma route at T >=
   SCAN_WGMMA_MIN_S, its fma route between) and no other kernel ran,
   one transfer per step, no KV page and no state block in use after
   the drain;
10. the RG-LRU path: the same for recurrentgemma-2b (18 RG-LRU layers
   and 8 sliding-window layers of window 2048, d_model 2560, bf16) at
   max_len 4096, 16 prompts of 64-3,000 tokens, 4 of them past the
   window: K5 ran 18 times per step (on its tma route at T >=
   LRU_TMA_MIN_S, its seq route below);
11. time K4 and K5 at T = 1 and 64 beside their bounds and plain
   versions (K4's step route at T = 1 beside the fma kernel on the same
   inputs and a ``copy_`` of one state, the practical floor; its wgmma
   route at T = 2, 3, 4, 16 and 64 beside the fma kernel on the same
   inputs, with the bytes, the dual form's tensor-core operations and
   the sequential form's float32 operations as bounds; K5's tma route
   beside its seq kernel on the same inputs at T = 1, 2, 4, 8, 16 and
   64, which sets LRU_TMA_MIN_S), serve phase 5's workload on
   mamba2-370m in turns (every K4 launch on its fma kernel; then, in
   the order A B B A, the wgmma route from SCAN_WGMMA_MIN_S tokens on
   with T = 1 still on fma, and T = 1 on the step route too), so that
   each route's end-to-end share reads apart, and print both families'
   end-to-end rates;
12. the training path: olmo-1b at full depth and width (bf16
   parameters, float32 AdamW state), one micro-batch of 4 sequences of
   2048 tokens from ``TokenStream``, a warm-up step and 5 steps of
   ``build_step``: finite losses, K6's forward launched 32 times a step
   (16 global layers, each run forward and again in the backward pass's
   recomputation) and its backward 16 times, each on its wgmma route,
   and no other kernel, one
   device-to-host transfer a step (the loss); ms a step, tokens a
   second, peak memory, and the model-flops share of the card's bf16
   peak; then the steps again with the backward on its wgmma route and
   on the mma.sync kernels it replaced, in turns;
13. time K6's forward and backward kernels at the training shape, each
   beside its bound, its plain version and PyTorch's
   ``scaled_dot_product_attention`` (forward, and backward through
   ``torch.autograd.grad``), and the backward's wgmma route beside the
   mma.sync kernels it replaced, on the same inputs, in turns;
14. the serve entry point and preemption at full width (olmo-1b,
   bf16, dp 1, 8 slots, max_len 2048): (a) ``repro_torch.launch.serve
   .main`` with a 512-token hot prefix, 32 requests of 64 new tokens, a
   quarter interactive, 64 pin pages: every request finishes, a pin is
   created, K1 + K2 launches = 16 x steps, one transfer a step, 0 pages
   after the drain and ``flush_pins``, a never-dry margin >= 0; (b) the
   engine driven directly with 128 pin pages, 8 standard requests and
   after 40 steps 4 interactive ones that preempt: a preemption and a
   pin hit, every request finishes, one transfer a step, 0 pages after
   the flush; again in f32 with and without preemption, where every
   stream must be equal or differ first at a near-tie (top-2 logit gap
   within 1e-4 of the logit scale);
15. time K2 (its tma route, with splits of 1, 2, 4 and 8 pages, and
   its present fma kernel) and K1 at T = 1 on the same inputs beside
   K2's bound, its plain version and SDPA; serve phase 5's workload
   once each with decode-only steps through K1, through K2's tma route
   and through its fma kernel; print the kernels line (K1-K6; K4's and K5's routes, and K6's forward and
   backward, on rows of their own);
16. sampled serving and crash recovery at full width (olmo-1b, bf16
   unless said): (a) phase 5's workload with three requests in four
   sampled (temperature 0.8, top-k 50, seeds 1000 + rid), twice: the
   checks of phase 5, the two runs' streams bit for bit equal, ms/step
   and tok/s beside phase 5's greedy run, and the sampler's kernels
   and device time a step under the profiler; (b) in f32, phase 7's
   hot-prefix traffic with and without speculation and phase 14b's
   preempting traffic with and without preemption, sampled as in (a):
   every stream equal, or first different at a near-tie (top-2 gap of
   ``logits / T + g`` within 1e-4 of its scale); (c)
   ``repro_torch.launch.serve.main`` at dp 2 with pins, deadlines and
   an ``--inject-fault`` schedule of every kind (poison, straggler, a
   crash at post_sync, shard loss, a torn crash at dispatched, a step
   error): every fault fires, the journal drains, each reconcile is
   conserved and never-dry, no block in use on the surviving shard, one
   transfer a step but the step a torn crash cut, K1 + K2 = 16 x steps,
   and ``recoveries`` equals the injected step errors; (d) the engine
   in f32 with a crash at post_sync and a torn crash at dispatched
   through ``chaos.recover_engine``: every stream equal to the
   uninterrupted run's or first different at a near-tie (1e-4).  Phase
   4 also holds, on the card against the CPU, sampled requests with
   speculation and preemption, and the two crashes recovered through
   ``recover_engine`` (identical streams up to a near-tie of 1e-5,
   status rows, reconcile reports and pool leaves).
17. expert-paged MoE serving at mixtral-8x7b's full width (d_model
   4096, 32 heads, 8 KV heads, hd 128, d_ff 14,336, 8 experts top-2,
   window 4096, vocab 32,000; bf16, capacity factor 64), depth cut from
   32 to 8 layers (at 32 the experts alone are 90 GB), dp 1, 8 slots,
   max_len 2048, chunk 64, three size classes (two for the resident
   engine, whose experts take no class): 24 requests of phase 5's
   shape under a skewed footprint mix (80% on experts (0, 1), the rest
   on the cold pairs) and a uniform one (the four disjoint pairs round
   robin), each through the resident engine, the paged engine at half
   of full residency (96 of 192 expert pages) and the resident engine
   again on the paged run's batches: every request finishes, paged
   streams equal the resident streams on the same batches bit for bit
   (the count equal to the resident run on its own batches printed), 0
   in-step misses and 0 dropped tokens, one transfer a step, no kernel
   of K1-K6 (the expert products are matmuls, as in the reference), on
   the uniform mix evictions, expert deferrals and a resident peak
   within the budget, on the skewed mix at least 30% of peak expert HBM
   saved, every class conserved and empty after ``flush_experts``;
   ms/step and tok/s of each engine, the hit rate, loads, evictions and
   peak, one cold footprint's load (48 pages, 5.6 GB) in GB/s, and the
   device ms of the expert gather and of the MoE products in one
   profiled prefill and one decode step; at its end the pinned host
   expert stores, which PyTorch's caching host allocator keeps after
   the engines are freed, are returned (under 1 GiB may stay pinned),
   VmRSS printed before and after.  Phase 4 also holds the smoke
   mixtral-8x7b expert-paged at a budget of one footprint, card against
   CPU (tokens, status rows, stats, pool leaves and expert tables).

18. training and prefill of the recurrent decoders at full width:
   (a) mamba2-370m (48 SSD layers, d_model 1024, state 128, head dim
   64, vocab 50,280) and (b) recurrentgemma-2b (18 RG-LRU and 8 local
   layers of window 2,048, d_model 2,560, d_ff 7,680, vocab 256,000),
   each at full depth and width, bf16 parameters, float32 AdamW state,
   remat on, 4 sequences of 2,048 ``TokenStream`` tokens a step, a
   warm-up and 5 steps of ``build_step``: finite losses, no launch of
   K1-K6 (the SSD and RG-LRU layers train through their full-sequence
   forms in torch ops, as the reference's in jnp), one device-to-host
   transfer a step; ms a step, tokens a second, peak memory and the
   model-flops share of the card's bf16 peak; (c) with ``--profile``,
   where their steps' time goes; (d) the prefill path in f32:
   mamba2-370m 8 prompts of 512 tokens, recurrentgemma-2b 4 prompts of
   2,304 (past its window, so the ring load wraps): ``prefill``,
   ``load_prefill`` into an empty state of dp 1 and a slot a prompt, 16
   greedy ``decode_step``s (K4 or K5 once a layer a step, the prefill
   no kernel): logits within ``PREFILL_TOL`` of the one-shot
   ``forward_train`` of the same tokens (the one-ulp floor printed
   beside), greedy streams equal to the ``ServingEngine``'s (chunked
   prefill through K4 and K5) or first different at a near-tie, every
   class empty after the slots are freed.  recurrentgemma-2b's weights
   in phases 4 and 18 are rescaled to each layer's own fan-in
   (``rglru_fan_in`` says why).

19. encoder-decoder and VLM serving at full width: whisper-tiny (4
   encoder and 4 decoder layers of 384, 6 heads of 64, 1,500 frames,
   vocab 51,865) and phi-3-vision-4.2b (32 layers of 3,072, 32 heads of
   96, d_ff 8,192, 576 image positions, vocab 32,064), weights from
   ``--seed``, the frame and image patch embeddings drawn from it too:
   (a) whisper-tiny in bf16, 8 prompts of 32 tokens with their frames:
   ``prefill`` (K6 on its wgmma route, 4 bidirectional launches at S =
   1,500 and 4 causal), ``load_prefill`` (the cross K/V into
   ``enc_kv``) into a state of two size classes, 32 greedy
   ``decode_step``s (K2 on its tma route once a layer a step, the
   cross-attention in torch ops, as the reference's is jnp); (b)
   phi-3-vision in bf16, 4 prompts of 64 tokens after 576 image
   positions (640 positions, 10 pages of 64): K6 on its wgmma route at
   hd 96 once a layer, 16 decode steps with K2 on its tma route; (c)
   both again in f32, every logit within ``PREFILL_TOL`` of
   the one-shot ``forward_train`` with the same extra inputs (the
   one-ulp floor printed beside); (d) the engine at full width in bf16,
   dp 1, 8 slots, 16 requests of phase 5's shape: whisper-tiny with two
   size classes, each slot holding its 376 CLS_STATE blocks of encoder
   state (4 layers x ceil(1,500 / 16)), phi-3-vision with one (its
   ms/step printed beside 62.55, the run before K1's hd 96 wgmma
   route), K1 on its wgmma route and K2 on its tma route at hd 64 and
   96, the checks of phase 5 (one
   transfer a step, every class empty after the drain), and
   phi-3-vision's text-only prompts through the prefill path in f32
   against the engine as phase 18 (d) does; (e) the time of K6 at hd 96
   at phi-3-vision's prefill shape (wgmma, and the mma.sync instance it
   replaced on the same inputs), and of K1 (T = 64; wgmma, and the fma
   kernel it replaced) and K2 (tma, and the fma kernel it replaced) at
   its serving width, each beside its bound, its plain version and
   SDPA.

20. the DP allocation plane, one rank per DP shard
   (``repro_torch.launch.mesh``), two ranks spawned with their own
   process group: (a) phase 4's f32 olmo-1b smoke workload at dp 2 on
   two ranks sharing the card over gloo: tokens, status rows and each
   shard's page tables, seq_lens and pool leaves equal to the CPU
   single-process engine's; (b) olmo-1b at full width on phase 5's
   requests, dp 2 on the same ranks, 8 slots a shard: the ranks' host
   state equal at the end, each shard conserved, never dry and empty
   after the drain, one transfer and one collective a step, each rank's
   K1 and K2 once a layer a step of their width (wgmma and tma routes),
   the streams equal to the single-process dp 2 engine's on the card or
   first different where its top-2 logit gap is within 6e-2 of the logit
   scale; ms/step and tok/s of each rank (two ranks time-sharing one
   card: a plumbing figure, not a scaling one) beside the single-process
   engine's; (c) (b) again over nccl, one rank per card, where the run
   was given two cards or more (CUDA_VISIBLE_DEVICES, else the host's;
   otherwise it prints that nccl went unexercised); (d) olmo-1b in f32
   at full width cut to two layers, on the ranks of (a): every stream
   equal to the single-process dp 2 engine's token for token (K1 and K2
   on their fma kernels); (e) phase 16 (c)'s ``launch.serve`` argv and
   fault schedule with ``--mesh auto --dist-backend gloo`` on the ranks
   of (a), olmo-1b at full width in bf16: on each rank 16 (c)'s checks
   (every fault fired, the journal drained, every reconcile conserved
   and never-dry, 0 blocks of every class in use on the surviving
   shard, transfers + torn crashes = steps, K1 + K2 = 16 x steps,
   ``recoveries`` = injected errors), collectives = transfers, and the
   ranks' host state and injector logs equal; each rank's ms a step
   (the call's wall time over its steps, recoveries included); (f) (d)'s
   f32 model on the same ranks under a crash at ``post_sync``, a torn
   crash at ``dispatched`` and a step error: every stream equal to one
   process at dp 2 under the same faults, token for token, and each
   shard's reconcile reports equal to that process's.  (a), (d) and (f)
   are the plane's correctness gates; (b)'s bf16 near-tie allowance
   makes it a smoke check.

21. the dry run of phase 12's step and ``core/kv_cache.py`` on the
   card.

22. phi-3-vision-4.2b and whisper-tiny training at full width through
   ``build_step`` (bf16 parameters from ``--seed``, float32 AdamW, remat
   on): (e) first, phase 3's checks of K6's backward at hd 96 (bf16 on
   its wgmma route over tiles padded to two 64-column atoms, float32 on
   FMAs; causal and bidirectional, G 1 and 2, S 640 and 700, and bf16 at
   phi-3-vision's training shape B 4, H 32, S 2,048, causal),
   bidirectional at whisper-tiny's encoder shape (B 8, H 6, S 1,500, hd
   64) and causal at its decoder's (B 8, H 6, S 448); (a) phi-3-vision
   at its published widths, 32 layers, 4 x (576 image positions drawn on
   the card + 1,472 text tokens), a warm-up and 5 steps: finite losses,
   K6 forward 64 and backward 32 launches a step, all on the wgmma route
   at hd 96, no other kernel, one synchronizing call a step; ms a step,
   text tokens a second, peak memory, the model-flops share; (b)
   ``launch.train.main`` for phi-3-vision, text only, 3 steps of 2 x 512
   tokens, at the deepest depth whose two checkpoints (the trainer's
   whole state) fit the free disk, the run's disk-write budget and the
   host's available memory (both held there at once), each printed:
   finite losses, the backward on wgmma; (c) whisper-tiny, 4 encoder and
   4 decoder layers, 8 x 448 tokens beside 8 x 1,500 frames: the checks
   of (a), K6 forward 8 bidirectional and 8 causal launches a step, its
   backward 4 and 4; (d) phi-3-vision in float32 at full width cut to 2
   layers, 1 x (576 + 128) positions: the loss and every gradient leaf
   on the card within 1e-3 of its scale from the CPU's (K6's float32
   backward at hd 96); (f) K6's backward at phi-3-vision's training
   shape (B 4, H 32, S 2,048, hd 96, causal), at S 640 and at
   whisper-tiny's encoder shape, each beside its bound, its plain
   version and SDPA's backward.

23. four more architectures at their published widths through
   ``ServingEngine.run`` (bf16, random weights from ``--seed`` drawn on
   the card, dp 1, 8 slots, chunk 64, max_len 2048), each freed before
   the next is drawn: (a) llama3.2-1b (16 layers, G 4, hd 64) and (b)
   phi4-mini-3.8b (32 layers, 24 heads over 8: G 3, hd 128) on phase
   5's workload; (c) gemma3-27b (62 layers: 52 local of window 1,024
   over rings metered on CLS_STATE, in torch ops, and 10 global, G 2,
   hd 128; two size classes) on 16 prompts of 64-1,984 tokens, four of
   them 1,025 or longer, so that their rings wrap; (d) llama4-maverick
   cut from 48 to 2 layers (one global_moe of 128 experts top-1, one
   global; G 5, hd 128), resident, capacity factor 64, on phase 5's
   workload: phase 5's checks (every K1 launch on its wgmma route,
   every K2 launch on its tma route, once per attention layer per step
   of their width, no other kernel, one transfer a step, every class
   empty after the drain), gemma3-27b's slots holding their CLS_STATE
   grant; tok/s, ms/step, the peak of ``max_memory_allocated``, the
   parameters and the init time of each; (e) K2's tma route at G 3 and
   5 (phi4-mini's and llama4's widths) at phase 15's contexts, beside
   its fma kernel on the same inputs, its bound, its plain version and
   SDPA.

24. three more models train at their published widths through
   ``build_step`` as phase 12 trains olmo-1b (bf16 parameters from
   ``--seed``, float32 AdamW, remat on, 4 x 2,048 tokens, a warm-up and
   3 counted steps): (e) first, K6 at llama3.2-1b's attention (H 32
   over KH 8: G 4, hd 64) and phi4-mini-3.8b's (H 24 over 8: G 3, hd
   128), causal, B 1, S 2,048: its bf16 forward within one ulp of its
   plain version, its wgmma backward against autograd through it and
   its walk, both launched from new host threads bit-equal; then for
   each of (a) llama3.2-1b, (b) phi4-mini-3.8b and (c) mixtral-8x7b
   (window 4,096 over every layer: no kernel), one step at 1 layer,
   whose peak less its state (16 bytes a parameter) gives the
   overhead, the deepest depth whose state and overhead (grown with
   AdamW's temporaries of the largest leaf) stay within 0.9 of the card
   (printed with its reckoning; the depth is the only cut), and the
   counted run there: finite
   losses, K6 forward 2 and backward 1 launch a layer a step on the
   wgmma route, no other kernel (mixtral none at all), one
   synchronizing call a step, mixtral's capacity drops at its config's
   capacity factor 1.25; ms a step, tokens a second, the model-flops
   share, peak memory against the card; (d) llama3.2-1b and
   phi4-mini-3.8b in float32 at 2 layers, 1 x 120 tokens: the loss and
   every gradient leaf on the card within 1e-3 of its scale from the
   CPU's (K6's float32 kernels at G 4 and G 3); (f) K6's forward and
   backward at B 4, S 2,048 at both models' attention, and its forward
   at phi-3-vision's (H 32, hd 96), each beside its bound, its plain
   version and SDPA.

Every phase prints its seconds, the process's VmRSS and the card's
``memory_allocated``.  ``--profile`` serves the workloads of
phases 5, 9 and 10 again, and runs two more training steps in phases
12, 18 and 22, under ``torch.profiler``, and prints where a step's
time goes.  The last line is ``{"ok": true,
"device": {...}}``.  Without a CUDA device, or without the rest of the
repository beside it, the script exits with a non-zero code and prints
no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import os
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the cards the caller gave this run (None: every card of the host):
# main() runs on the first, and phase 20's ranks, which import this
# module again, take theirs from the list
CALLER_CARDS = os.environ.get("CUDA_VISIBLE_DEVICES")

from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS, PEAK_FLOPS_F32)

#: published H100 SXM peaks (NVIDIA data sheet, dense), one source with
#: the dry run's roofline
PEAK_OPS = {torch.bfloat16: PEAK_FLOPS, torch.float32: PEAK_FLOPS_F32}
TOL = {torch.float32: 1e-4, torch.bfloat16: 6e-2}
#: the kernels of the port's CUDA sources, by name prefix
PORT_KERNELS = ("k1_", "k2_", "k3_", "k4_", "fa_", "paged_", "verify_",
                "ssd_scan_", "ssd_step_", "rg_lru_")
#: bf16: kernel and plain version may differ by one ulp of the output
BF16_ULP_RTOL, BF16_ULP_ATOL = 2.0 ** -7, 1e-5


#: phase 21 (a): olmo-1b's train cell at phase 12's shape on the 1 x 1
#: smoke mesh, traced in a process of its own (its fake process group
#: stays there) with no card visible
DRYRUN_CELL = """
import json
import os
os.nice(19)              # the card's phases run beside it, ahead of it
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_smoke_mesh
shape = ShapeConfig("train_2k", {seq}, {batch}, "train")
print(json.dumps(dryrun.run_cell("olmo-1b", shape,
                                 mesh_cm=make_smoke_mesh())))
"""


def phase(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def kernel_name(mangled: str) -> str:
    """A kernel template's name with its integer arguments, as
    ``k2_split<128,3>``, from its mangled name (each identifier there is
    prefixed by its length); the mangled name if it is no such
    template."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(m.start(), m.end()):
            n, at = int(mangled[i:m.end()]), m.end()
            ident = mangled[at:at + n]
            args = re.match(r"I((?:Li\d+E)+)E", mangled[at + n:])
            if args and len(ident) == n and ident.isidentifier():
                vals = re.findall(r"Li(\d+)E", args.group(1))
                return f"{ident}<{','.join(vals)}>"
    return mangled


def ptxas_lines(log):
    """(kernel, line) for each of ptxas's register and spill lines in
    an nvcc log (``-Xptxas -v``), the kernel by :func:`kernel_name`."""
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            name = kernel_name(m.group(1))
        elif name and ("registers" in line or "spill" in line):
            yield name, re.sub(r"^ptxas info\s*:\s*", "", line.strip())


def zero_counts(counted):
    """Every kernel's launch count, and its counts by route and by mask,
    set to 0."""
    for fn in counted.values():
        fn.launches = 0
        for by in (getattr(fn, "routes", {}), getattr(fn, "masks", {})):
            for key in by:
                by[key] = 0


def cuda_ms(fn, iters: int = 40, warmup: int = 3, enqueue=False):
    """(device ms, host ms) of one call of ``fn``.  The device time is
    taken by CUDA events around ``iters`` back-to-back calls that the
    host enqueued while a sleep kernel held the card, so the host's
    cost per call (the Python wrapper, the launches) does not show in
    it; the host time is the wall time per call of the same loop run
    plainly, which is what a caller that waits for it pays.  With
    ``enqueue``, also the host's own time per call: the wall time of
    that enqueue, which the sleeping card does not hold up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # at most 2 GHz: the sleep outlasts the enqueue at any SM clock
    torch.cuda._sleep(int(2e9 * (2 * host_s + 1e-3)))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    out = (start.elapsed_time(end) / iters, 1e3 * host_s / iters)
    return out + (1e3 * enqueue_s / iters,) if enqueue else out


def attn_case(rng, B, T, H, KH, hd, psz, maxp, P, dtype, base=None,
              masked=(), dead=(), hot=0):
    """Paged-attention inputs on the card: ragged ``base`` lengths, a
    table of random pages covering base + T, the first ``hot`` of them
    the same pages in every lane (a shared prefix) and the rest
    distinct, optional all-masked rows (table all -1) and dead pages
    (-1 inside the run).  q and the pools are drawn on the card from a
    seed ``rng`` gives (the timing phases hold many layers of pools,
    which numpy would draw in seconds each)."""
    if base is None:
        hi = max((maxp - 1) * psz - T, hot * psz + 1)
        base = rng.randint(hot * psz, hi, B)
    base = np.asarray(base, np.int32)
    table = np.full((B, maxp), -1, np.int32)
    avail = list(rng.permutation(P))
    prefix = [avail.pop() for _ in range(hot)]
    for b in range(B):
        for i in range(min(-(-(int(base[b]) + T) // psz), maxp)):
            table[b, i] = prefix[i] if i < hot else avail.pop()
    for b in masked:
        table[b] = -1
    for b, i in dead:
        table[b, i] = -1
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(int(rng.randint(2 ** 31)))
    q, kp, vp = (torch.randn(sh, generator=g, device=dev) for sh in
                 ((B, T, H, hd), (P, psz, KH, hd), (P, psz, KH, hd)))
    return (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype),
            torch.from_numpy(table).to(dev), torch.from_numpy(base).to(dev))


def check_kernel(ops, plain, rng, cfg_full, cfg_smoke, b_local, maxp, P):
    """Phase 3: K1, through the dispatcher the engine calls, against its
    plain version; returns the worst error over the serving path's
    shapes (bf16)."""
    worst = 0.0
    full = dict(H=cfg_full.n_heads, KH=cfg_full.n_kv_heads, hd=cfg_full.hd,
                psz=cfg_full.page_size, maxp=maxp, P=P)
    smoke = dict(H=cfg_smoke.n_heads, KH=cfg_smoke.n_kv_heads,
                 hd=cfg_smoke.hd, psz=cfg_smoke.page_size, maxp=8, P=72)
    cases = [("full T=1 bf16", full, 1, torch.bfloat16),
             ("full T=64 bf16", full, 64, torch.bfloat16),
             ("full T=1 f32", full, 1, torch.float32),
             ("full T=64 f32", full, 64, torch.float32),
             ("smoke T=8 f32 (G=2)", smoke, 8, torch.float32),
             ("smoke T=1 f32 (G=2)", smoke, 1, torch.float32)]
    for name, shp, T, dt in cases:
        args = attn_case(rng, b_local, T, dtype=dt, masked=(1,),
                         dead=((2, 0),), **shp)
        before = ops.paged_attention_chunk.launches
        out = ops.paged_attention_chunk(*args)
        torch.cuda.synchronize()
        check(ops.paged_attention_chunk.launches == before + 1,
              f"{name}: the dispatcher launched the kernel once")
        ref = plain(*args)
        err = (out.float() - ref.float()).abs().max().item()
        check(bool(torch.isfinite(out.float()).all()), f"{name}: finite")
        check(bool((out[1] == 0).all()), f"{name}: all-masked row is zero")
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dt],
                                   rtol=TOL[dt],
                                   msg=lambda m, n=name: f"{n}: {m}")
        tol = f"tol {TOL[dt]:g}"
        if dt == torch.bfloat16:
            torch.testing.assert_close(
                out.float(), ref.float(), atol=BF16_ULP_ATOL,
                rtol=BF16_ULP_RTOL,
                msg=lambda m, n=name: f"{n}, one bf16 ulp: {m}")
            tol += f" and one ulp: rtol 2^-7, atol {BF16_ULP_ATOL:g}"
        phase(f"[3] K1 {name}: max_abs_err {err:.3e}, max|ref| "
              f"{ref.float().abs().max().item():.3e} ({tol})")
        if dt == torch.bfloat16:
            worst = max(worst, err)
    return worst


def check_k3(k3, ops, plain, rng, cfg_full, cfg_smoke, b_local, maxp, P):
    """Phase 3: K3, through the dispatcher the engine calls, against its
    plain version and against K1 on the same inputs, on tables whose
    lanes share a 512-token prefix (8 pages); lane 1 is idle.  Returns
    the worst bf16 error against the plain version."""
    worst = 0.0
    full = dict(H=cfg_full.n_heads, KH=cfg_full.n_kv_heads, hd=cfg_full.hd,
                psz=cfg_full.page_size, maxp=maxp, P=P, hot=8)
    smoke = dict(H=cfg_smoke.n_heads, KH=cfg_smoke.n_kv_heads,
                 hd=cfg_smoke.hd, psz=cfg_smoke.page_size, maxp=8, P=72,
                 hot=2)
    cases = [("full T=5 bf16", full, 5, torch.bfloat16),
             ("full T=64 bf16", full, 64, torch.bfloat16),
             ("full T=5 f32", full, 5, torch.float32),
             ("full T=64 f32", full, 64, torch.float32),
             ("smoke T=5 f32 (G=2)", smoke, 5, torch.float32)]
    for name, shp, T, dt in cases:
        args = attn_case(rng, b_local, T, dtype=dt, masked=(1,), **shp)
        before = k3.verify_attention.launches
        out = k3.verify_attention(*args)
        torch.cuda.synchronize()
        check(k3.verify_attention.launches == before + 1,
              f"K3 {name}: the dispatcher launched the kernel once")
        check(bool(torch.isfinite(out.float()).all()), f"K3 {name}: finite")
        check(bool((out[1] == 0).all()), f"K3 {name}: all-masked row is "
                                         f"zero")
        errs = []
        for what, ref in (("plain", plain(*args)),
                          ("K1", ops.paged_attention_chunk(*args))):
            ref = ref.float()
            errs.append((out.float() - ref).abs().max().item())
            torch.testing.assert_close(
                out.float(), ref, atol=TOL[dt], rtol=TOL[dt],
                msg=lambda m, n=name, w=what: f"K3 {n} vs {w}: {m}")
            if dt == torch.bfloat16:
                torch.testing.assert_close(
                    out.float(), ref, atol=BF16_ULP_ATOL,
                    rtol=BF16_ULP_RTOL,
                    msg=lambda m, n=name, w=what: f"K3 {n} vs {w}, one "
                                                  f"bf16 ulp: {m}")
        tol = f"tol {TOL[dt]:g}" + (
            f" and one ulp: rtol 2^-7, atol {BF16_ULP_ATOL:g}"
            if dt == torch.bfloat16 else "")
        shared = int((args[3][:, :shp["hot"]] >= 0).sum())
        phase(f"[3] K3 {name}: max_abs_err vs plain {errs[0]:.3e}, vs K1 "
              f"{errs[1]:.3e}, max|ref| {out.float().abs().max().item():.3e}"
              f" ({tol}); {shared} table entries on {shp['hot']} shared "
              f"prefix pages")
        if dt == torch.bfloat16:
            worst = max(worst, errs[0])
    return worst


def route_case(rng, T, H, KH, hd, B=10, psz=64, maxp=24, P=224, hot=4):
    """bf16 inputs of K1's and K3's wgmma routes: the lanes map the
    same ``hot`` prefix pages (8 lanes map the first: at T = 64 it holds
    8 x 64 rows, 8 row tiles of K3), then pages of their own; bases off
    the page grid; lane 1 idle (all rows masked); lane 2 without the
    second hot page and lane 3 without its first own page (dead pages
    inside a run); lane 6 at base 3 with its first page dead (rows that
    see no key)."""
    base = rng.randint(hot * psz + 1, (maxp - 2) * psz - T, B)
    base[base % psz == 0] += 1
    base[1], base[6] = 0, 3
    table = np.full((B, maxp), -1, np.int32)
    avail = list(rng.permutation(P))
    prefix = [avail.pop() for _ in range(hot)]
    for b in range(B):
        for i in range(-(-(int(base[b]) + T) // psz)):
            table[b, i] = prefix[i] if i < hot and b != 6 else avail.pop()
    table[1] = -1
    table[2, 1] = -1
    table[3, hot] = -1
    table[6, 0] = -1
    q, kp, vp = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                 for s in ((B, T, H, hd), (P, psz, KH, hd),
                           (P, psz, KH, hd)))
    return [q.to("cuda", torch.bfloat16), kp.to("cuda", torch.bfloat16),
            vp.to("cuda", torch.bfloat16), torch.from_numpy(table).cuda(),
            torch.from_numpy(base.astype(np.int32)).cuda()]


def check_wgmma_routes(k3, ops, plain, rng, cfgs, Ts=(1, 5, 8, 16, 64, 100)):
    """Phase 3: K1's and K3's wgmma/TMA kernels at the widths of
    ``cfgs`` (olmo-1b, G 1; llama3.2-1b, G 4, hd 64; phi4-mini-3.8b, G
    3, and llama4-maverick, G 5, where a query token's G rows straddle
    the 8-row halves a thread masks and a 64-row tile ends inside a
    token's group; gemma3-27b, G 2 over 16 KV heads) and T in ``Ts`` on
    :func:`route_case` inputs: each within one bf16 ulp of the plain
    version, K3 within one ulp of K1, rows without a key zero, two calls
    bit-equal; then float32, hd 16 and pages of 8 still take the present
    kernels.  Returns the worst error against the plain version of each
    kernel, and K1's of each config by name."""
    worst, by_cfg = {"K1": 0.0, "K3": 0.0}, {}
    for cfg in cfgs:
        H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        for T in Ts:
            name = f"{cfg.name} widths T={T} (H={H} KH={KH} hd={hd})"
            args = route_case(rng, T, H, KH, hd)
            check(int((args[3][:, 0] == args[3][0, 0]).sum()) == 8,
                  f"{name}: 8 lanes map the first hot page")
            r1 = ops.paged_attention_chunk.routes["wgmma"]
            r3 = k3.verify_attention.routes["wgmma"]
            o1 = ops.paged_attention_chunk(*args)
            o3 = k3.verify_attention(*args)
            torch.cuda.synchronize()
            check(ops.paged_attention_chunk.routes["wgmma"] == r1 + 1
                  and k3.verify_attention.routes["wgmma"] == r3 + 1,
                  f"{name}: K1 and K3 took their wgmma routes")
            ref = plain(*args).float()
            errs = []
            for what, out, other in (("K1", o1, ref), ("K3", o3, ref),
                                     ("K3 vs K1", o3, o1.float())):
                check(bool(torch.isfinite(out.float()).all())
                      and bool((out[1] == 0).all())
                      and bool((out[6, :61] == 0).all()),
                      f"{name} {what}: finite, rows without a key zero")
                torch.testing.assert_close(
                    out.float(), other, atol=BF16_ULP_ATOL,
                    rtol=BF16_ULP_RTOL,
                    msg=lambda m, n=name, w=what: f"{n} {w}, one bf16 "
                                                  f"ulp: {m}")
                errs.append((out.float() - other).abs().max().item())
            check(torch.equal(o1, ops.paged_attention_chunk(*args))
                  and torch.equal(o3, k3.verify_attention(*args)),
                  f"{name}: two calls bit-equal")
            worst["K1"] = max(worst["K1"], errs[0])
            worst["K3"] = max(worst["K3"], errs[1])
            by_cfg[cfg.name] = max(by_cfg.get(cfg.name, 0.0), errs[0])
            phase(f"[3] wgmma routes, {name}: K1 vs plain {errs[0]:.3e}, "
                  f"K3 vs plain {errs[1]:.3e}, K3 vs K1 {errs[2]:.3e} "
                  f"(one ulp: rtol 2^-7, atol {BF16_ULP_ATOL:g}); two calls "
                  f"bit-equal")
    for dt, T, H, KH, hd, psz in ((torch.float32, 5, 4, 2, 16, 8),
                                  (torch.float32, 64, 16, 16, 128, 64),
                                  (torch.bfloat16, 5, 4, 2, 16, 8)):
        args = attn_case(rng, 8, T, H, KH, hd, psz, 16, 160, dt, hot=2)
        f1 = ops.paged_attention_chunk.routes["fma"]
        f3 = k3.verify_attention.routes["fma"]
        for fn in (ops.paged_attention_chunk, k3.verify_attention):
            torch.testing.assert_close(fn(*args).float(),
                                       plain(*args).float(), atol=TOL[dt],
                                       rtol=TOL[dt])
        check(ops.paged_attention_chunk.routes["fma"] == f1 + 1
              and k3.verify_attention.routes["fma"] == f3 + 1,
              f"{dt} hd={hd} psz={psz}: the present kernels")
        phase(f"[3] {str(dt)[6:]} hd={hd} psz={psz} T={T}: K1 and K3 took "
              f"their present (fma) kernels, within {TOL[dt]:g} of plain")
    return worst, by_cfg


def check_k2(ops, plain2, rng, cfgs, smoke, b_local, maxp, P):
    """Phase 3: K2, through the dispatcher the engine calls, against its
    plain version with ``zero_empty`` off (lane 1 has no valid key and
    must get the uniform mean of what it gathers) and on (zeros), and
    against K1 at T = 1 with ``base + 1`` on the same inputs: bf16 at
    the widths of each of ``cfgs`` (olmo-1b, G 1; llama3.2-1b, G 4, hd
    64; phi4-mini-3.8b, G 3; gemma3-27b, G 2 over 16 KV heads;
    llama4-maverick, G 5) on the tma route, with contexts of 96-1,087
    tokens and of 1-2,048; float32 at the first's widths and at those of
    ``smoke`` on the fma kernel; two calls bit-equal.  Returns the worst
    bf16 error against the plain version, and that of each of ``cfgs``
    by name."""
    worst, by_cfg = 0.0, {}

    def shape(c, **kw):
        return dict(H=c.n_heads, KH=c.n_kv_heads, hd=c.hd, psz=c.page_size,
                    **kw)

    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    for c in cfgs:
        wide = rng.randint(0, 2048, b_local)   # contexts of 1-2,048 tokens
        wide[0], wide[4] = 0, 2047
        name = f"{c.name} widths bf16 (G={c.n_heads // c.n_kv_heads})"
        cases += [(c.name, name, shape(c, maxp=maxp, P=P),
                   rng.randint(96, 1088, b_local), bf),
                  (c.name, f"{name}, contexts 1-2048",
                   shape(c, maxp=maxp, P=P), wide, bf)]
    cases += [(None, f"{cfgs[0].name} widths f32",
               shape(cfgs[0], maxp=maxp, P=P),
               rng.randint(96, 1088, b_local), f32),
              (None, "smoke f32 (G=2)", shape(smoke, maxp=8, P=72), None,
               f32)]
    for cfg_name, name, shp, base, dt in cases:
        q, kp, vp, table, base = attn_case(rng, b_local, 1, dtype=dt,
                                           base=base, masked=(1,),
                                           dead=((2, 0),), **shp)
        q2, lens = q[:, 0].contiguous(), base + 1
        route = ops.decode_route(dt, shp["hd"], shp["psz"],
                                 shp["H"] // shp["KH"])
        check(route == "tma" or dt != torch.bfloat16 or shp["hd"] == 16,
              f"K2 {name}: bf16 at hd {shp['hd']} on the tma route")
        errs = []
        for zero_empty in (False, True):
            before = ops.paged_attention.launches
            on_route = ops.paged_attention.routes[route]
            out = ops.paged_attention(q2, kp, vp, table, lens,
                                      zero_empty=zero_empty)
            torch.cuda.synchronize()
            check(ops.paged_attention.launches == before + 1
                  and ops.paged_attention.routes[route] == on_route + 1,
                  f"K2 {name}: the dispatcher launched the kernel of the "
                  f"{route} route once")
            check(torch.equal(out, ops.paged_attention_cuda(
                q2, kp, vp, table, lens, zero_empty, route)),
                f"K2 {name}: two calls bit-equal")
            check(bool(torch.isfinite(out.float()).all()),
                  f"K2 {name}: finite")
            refs = [("plain", ops.paged_attention_ref(
                q2, kp, vp, table, lens, zero_empty=zero_empty))]
            if zero_empty:
                check(bool((out[1] == 0).all()),
                      f"K2 {name}: a row without keys is zero")
                refs.append(("K1 T=1", ops.paged_attention_chunk(
                    q, kp, vp, table, base)[:, 0]))
            else:
                check(bool((out[1] != 0).any()),
                      f"K2 {name}: a row without keys is the uniform mean")
            for what, ref in refs:
                ref = ref.float()
                errs.append((out.float() - ref).abs().max().item())
                torch.testing.assert_close(
                    out.float(), ref, atol=TOL[dt], rtol=TOL[dt],
                    msg=lambda m, n=name, w=what: f"K2 {n} vs {w}: {m}")
                if dt == torch.bfloat16:
                    torch.testing.assert_close(
                        out.float(), ref, atol=BF16_ULP_ATOL,
                        rtol=BF16_ULP_RTOL,
                        msg=lambda m, n=name, w=what: f"K2 {n} vs {w}, "
                                                      f"one bf16 ulp: {m}")
        tol = f"tol {TOL[dt]:g}" + (
            f" and one ulp: rtol 2^-7, atol {BF16_ULP_ATOL:g}"
            if dt == torch.bfloat16 else "")
        phase(f"[3] K2 {name} ({route} route): max_abs_err vs plain "
              f"{errs[0]:.3e} (zero_empty off, lane 1 the uniform mean), "
              f"{errs[1]:.3e} (on, lane 1 zeros), vs K1 at T=1 "
              f"{errs[2]:.3e}; max|ref| {out.float().abs().max().item():.3e}"
              f" ({tol}); contexts {int(lens.min())}-{int(lens.max())}; "
              f"two calls bit-equal")
        if cfg_name is not None:
            worst = max(worst, errs[0], errs[1])
            by_cfg[cfg_name] = max(by_cfg.get(cfg_name, 0.0), errs[0],
                                   errs[1])
    return worst, by_cfg


def scan_case(rng, kind, dims, dtype):
    """Inputs of K4 (``kind`` "ssd", dims (B, S, H, P, N)) or K5
    ("rglru", dims (B, S, d)) on the card, with the carried state h0 !=
    0; lane 1 is inert (dt = 0, or a = 1 and b = 0) from token 2 on and
    lane 2 throughout, as the serving path's ragged tails and idle slots
    are.  Returns (inputs without the state, h0)."""
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.randn(*shape).astype(np.float32)).cuda()
    if kind == "ssd":
        B, S, H, P, N = dims
        dt = torch.from_numpy(rng.rand(B, S, H).astype(np.float32) * 0.5
                              + 0.1).cuda()
        dt[1, 2:] = 0.0
        dt[2] = 0.0
        args = [(f(B, S, H, P) * 0.5).to(dtype), dt, -f(H).abs() * 0.5,
                (f(B, S, N) * 0.3).to(dtype), (f(B, S, N) * 0.3).to(dtype),
                f(H) * 0.1]
        return args, f(B, H, P, N)
    B, S, d = dims
    a = torch.from_numpy(rng.rand(B, S, d).astype(np.float32) * 0.9).cuda()
    b = f(B, S, d) * 0.5
    a[1, 2:], b[1, 2:] = 1.0, 0.0
    a[2], b[2] = 1.0, 0.0
    return [a, b], f(B, d)


def check_scan(name, fn, plain, kind, cases, rng, route_of=None,
               exact=False):
    """Phase 3: K4 or K5, through the dispatcher the engine calls, from a
    carried state and with inert lanes, against its plain version on
    the card; two calls on the same inputs bit-equal.  ``route_of(dims,
    dtype)``, for a kernel with routes, names the one each case must
    take; ``exact`` holds the output and the state bit-equal to the
    plain version's.  Returns the worst error of the output over the
    cases, by route when it has routes."""
    worst = {}
    for label, dims, dt in cases:
        args, h0 = scan_case(rng, kind, dims, dt)
        h = h0.clone()
        before = fn.launches
        route = route_of(dims, dt) if route_of else None
        on_route = fn.routes[route] if route else 0
        out, h_out = fn(*args, h)
        torch.cuda.synchronize()
        check(fn.launches == before + 1 and h_out is h,
              f"{name} {label}: the dispatcher launched the kernel once and "
              f"updated the state in place")
        if route:
            check(fn.routes[route] == on_route + 1,
                  f"{name} {label}: the {route} route")
        h2 = h0.clone()
        check(torch.equal(fn(*args, h2)[0], out) and torch.equal(h2, h),
              f"{name} {label}: two calls bit-equal")
        ref, h_ref = plain(*args, h0)
        check(bool(torch.isfinite(out.float()).all())
              and bool(torch.isfinite(h).all()), f"{name} {label}: finite")
        check(torch.equal(h[2], h0[2]),
              f"{name} {label}: an inert lane keeps its state bit for bit")
        torch.testing.assert_close(h, h_ref, atol=TOL[torch.float32],
                                   rtol=TOL[torch.float32],
                                   msg=lambda m, n=label: f"{name} {n} h: {m}")
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dt],
                                   rtol=TOL[dt],
                                   msg=lambda m, n=label: f"{name} {n}: {m}")
        tol = f"tol {TOL[dt]:g}"
        if dt == torch.bfloat16:
            torch.testing.assert_close(
                out.float(), ref.float(), atol=BF16_ULP_ATOL,
                rtol=BF16_ULP_RTOL,
                msg=lambda m, n=label: f"{name} {n}, one bf16 ulp: {m}")
            tol += f" and one ulp: rtol 2^-7, atol {BF16_ULP_ATOL:g}"
        if exact:
            check(torch.equal(out, ref) and torch.equal(h, h_ref),
                  f"{name} {label}: bit-equal to the plain version")
            tol += " and bit-equal"
        err = (out.float() - ref.float()).abs().max().item()
        herr = (h - h_ref).abs().max().item()
        via = f" ({route} route)" if route else ""
        phase(f"[3] {name} {label}{via}: max_abs_err {err:.3e} (state "
              f"{herr:.3e}), max|ref| {ref.float().abs().max().item():.3e} "
              f"({tol}); inert lane bit-equal; two calls bit-equal")
        worst[route] = max(worst.get(route, 0.0), err)
    return worst if route_of else worst[None]


def check_k4_step(k4, plain, rng, dims_list):
    """Phase 3: K4's step route (one token, bf16) through the dispatcher
    at each (B, 1, H, P, N) of ``dims_list``, from a carried state with
    an inert lane (dt = 0): y within one bf16 ulp of the plain version
    and of the fma kernel it replaced (by explicit route, on the same
    inputs), the state within 1e-4 of both, the inert lane's state bit
    for bit, two calls bit-equal.  Returns the worst error of y against
    the plain version, the step route's and the fma kernel's."""
    worst = fma_worst = 0.0
    for dims in dims_list:
        args, h0 = scan_case(rng, "ssd", dims, torch.bfloat16)
        B, _, H, P, N = dims
        name = f"K4 step B={B} H={H} P={P} N={N}"
        check(k4.scan_route(torch.bfloat16, 1, P, N) == "step",
              f"{name}: the dispatcher's route")
        y_ref, h_ref = plain(*args, h0)
        h_fma = h0.clone()
        y_fma = k4.ssd_scan_cuda(*args, h_fma, route="fma")
        h = h0.clone()
        before = (k4.ssd_scan.launches, k4.ssd_scan.routes["step"])
        y, _ = k4.ssd_scan(*args, h)
        check((k4.ssd_scan.launches, k4.ssd_scan.routes["step"])
              == (before[0] + 1, before[1] + 1),
              f"{name}: the dispatcher launched the step kernel once")
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y.float()).all())
              and bool(torch.isfinite(h).all()), f"{name}: finite")
        check(torch.equal(h[2], h0[2]),
              f"{name}: an inert lane keeps its state bit for bit")
        h2 = h0.clone()
        check(torch.equal(k4.ssd_scan_cuda(*args, h2, route="step"), y)
              and torch.equal(h2, h), f"{name}: two calls bit-equal")
        for what, y_o, h_o in (("plain", y_ref, h_ref),
                               ("fma", y_fma, h_fma)):
            torch.testing.assert_close(
                h, h_o, atol=TOL[torch.float32], rtol=TOL[torch.float32],
                msg=lambda m, w=what: f"{name} h vs {w}: {m}")
            torch.testing.assert_close(
                y.float(), y_o.float(), atol=BF16_ULP_ATOL,
                rtol=BF16_ULP_RTOL,
                msg=lambda m, w=what: f"{name} vs {w}, one bf16 ulp: {m}")
        err = (y.float() - y_ref.float()).abs().max().item()
        err_fma = (y_fma.float() - y_ref.float()).abs().max().item()
        worst, fma_worst = max(worst, err), max(fma_worst, err_fma)
        phase(f"[3] {name} T=1 bf16: max_abs_err vs plain {err:.3e}, vs "
              f"the fma kernel on the same inputs "
              f"{(y.float() - y_fma.float()).abs().max().item():.3e} (one "
              f"ulp: rtol 2^-7, atol {BF16_ULP_ATOL:g}); state vs plain "
              f"{(h - h_ref).abs().max().item():.3e} (tol "
              f"{TOL[torch.float32]:g}); inert lane bit-equal; two calls "
              f"bit-equal")
    return worst, fma_worst


def check_k5_tma(k5, plain, rng, cases, B=8):
    """Phase 3: K5's tma route at each (T, d) of ``cases``, whatever the
    dispatcher picks at that T: from a carried state with inert lanes,
    hs and the state bit-equal to the plain version, the inert lane's
    state bit for bit, two calls bit-equal."""
    for T, d in cases:
        (a, b), h0 = scan_case(rng, "rglru", (B, T, d), torch.float32)
        h, h2 = h0.clone(), h0.clone()
        out = k5.rg_lru_cuda(a, b, h, route="tma")
        again = k5.rg_lru_cuda(a, b, h2, route="tma")
        torch.cuda.synchronize()
        ref, h_ref = plain(a, b, h0)
        check(torch.equal(out, ref) and torch.equal(h, h_ref),
              f"K5 tma route T={T} d={d}: bit-equal to the plain version")
        check(torch.equal(h[2], h0[2]),
              f"K5 tma route T={T} d={d}: the inert lane keeps its state")
        check(torch.equal(again, out) and torch.equal(h2, h),
              f"K5 tma route T={T} d={d}: two calls bit-equal")
        phase(f"[3] K5 tma route T={T} B={B} d={d} f32: hs and the state "
              f"bit-equal to the plain version, max|ref| "
              f"{ref.abs().max().item():.3e}; the inert lane's state bit for "
              f"bit; two calls bit-equal")


def check_engine_vs_cpu(tengine, cfg_smoke, seed, name="smoke engine",
                        **kw):
    """Phase 4: the engine on the card against the engine on the CPU
    (plain versions) on a smoke config, f32; ``kw`` go to both
    engines."""
    from repro_torch.models.model import init_params
    from repro_torch.models.layers import tree_map

    params = init_params(cfg_smoke, seed=seed, device="cpu")
    rng = np.random.RandomState(seed)
    prompts = [list(rng.randint(1, cfg_smoke.vocab, rng.randint(3, 30)))
               for _ in range(9)]
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = tengine.ServingEngine(
            cfg_smoke, tree_map(lambda a: a.to(dev), params), dp=2,
            b_local=2, max_len=64, chunk_size=8, device=dev, **kw)
        reqs = [tengine.Request(i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run(max_steps=500)
        check(all(r.done for r in reqs) and eng.leak_free(),
              f"{name} on {dev} drained")
        runs[dev] = ([r.out_tokens for r in reqs],
                     [rec["status"] for rec in eng.flight.ring])
    check(runs["cuda"] == runs["cpu"], f"{name} on the card == on the CPU")
    phase(f"[4] {name} on the card == on the CPU: 9 requests, "
          f"{len(runs['cuda'][1])} steps, identical tokens and status rows")


def check_spec_engine_vs_cpu(tengine, k3, cfg_smoke, seed):
    """Phase 4: the speculative engine on the card against the same
    engine on the CPU, on the hot-prefix workload of
    tests/test_speculative.py (DP 2, 2 slots a shard, a 16-token prompt
    six times and three cold ones, draft length 4; the wall-clock gate
    off, so both engines draft alike)."""
    from repro_torch.models.model import init_params
    from repro_torch.models.layers import tree_map
    from repro_torch.serving.telemetry import FlightRecorder

    params = init_params(cfg_smoke, seed=seed, device="cpu")
    rng = np.random.RandomState(seed)
    hot = list(rng.randint(1, cfg_smoke.vocab, 16))
    prompts = [hot] * 6 + [list(rng.randint(1, cfg_smoke.vocab, 10))
                           for _ in range(3)]
    runs, engines = {}, {}
    for dev in ("cpu", "cuda"):
        eng = engines[dev] = tengine.ServingEngine(
            cfg_smoke, tree_map(lambda a: a.to(dev), params), dp=2,
            b_local=2, max_len=64, prefix_sharing=True, speculate=True,
            draft_len=4, spec_gate=False, device=dev,
            flight=FlightRecorder(capacity=4096))
        reqs = [tengine.Request(i, prompt=list(p), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        launches0 = k3.verify_attention.launches
        eng.run(max_steps=500)
        launches = k3.verify_attention.launches - launches0
        check(all(r.done for r in reqs) and eng.leak_free(),
              f"smoke spec engine on {dev} drained")
        runs[dev] = ([r.out_tokens for r in reqs],
                     [(rec["T"], rec["spec"], rec["status"])
                      for rec in eng.flight.ring])
    check(runs["cuda"] == runs["cpu"],
          "speculative engine on the card == on the CPU")
    eng = engines["cuda"]
    spec_steps = sum(rec["spec"] for rec in eng.flight.ring)
    accepted = eng.stats["spec_accepted"]
    check(accepted > 0 and spec_steps > 0, "drafts were accepted")
    check(launches == cfg_smoke.n_layers * spec_steps,
          "K3 launched once per layer per speculative step on the card")
    phase(f"[4] smoke speculative engine on the card == on the CPU: 9 "
          f"requests, {len(runs['cuda'][1])} steps ({spec_steps} "
          f"speculative), {accepted} drafts accepted, identical tokens "
          f"and status rows")


def check_pins_engine_vs_cpu(tengine, cfg_smoke, seed):
    """Phase 4: pinned prefixes and preemption on the card against the
    same engine on the CPU, smoke olmo-1b in f32 with
    ``SchedConfig(pin_pages=8, page_budget=6)``: a standard request on a
    2-page hot prefix, then an interactive one on the same prefix that
    finds no page headroom and preempts it (tests/test_sched.py:154);
    then two sharers of one hot prefix finishing in either order and a
    re-arrival served from the pin (tests/test_sched.py:225, with
    ``SchedConfig(pin_pages=8)`` as there).  Tokens, status rows, stats,
    pool leaves and pin tables must be identical."""
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import init_params
    from repro_torch.serving.sched import SchedConfig
    from repro_torch.serving.telemetry import FlightRecorder

    params = init_params(cfg_smoke, seed=seed, device="cpu")
    rng = np.random.RandomState(seed)
    hot = list(rng.randint(1, cfg_smoke.vocab, 16))
    scripts = [
        (dict(pin_pages=8, page_budget=6),
         [(0, hot + [11, 12, 13, 14], 8, "standard"), 3,
          (1, hot + [5, 6], 3, "interactive"), None]),
        (dict(pin_pages=8),
         [(0, hot + [90, 91], 6, "standard"), 2,
          (1, hot + [77, 78, 79], 3, "standard"), None,
          (2, hot + [50, 51], 3, "standard"), None])]
    for n, (sched, script) in enumerate(scripts):
        runs = {}
        for dev in ("cpu", "cuda"):
            eng = tengine.ServingEngine(
                cfg_smoke, tree_map(lambda a: a.to(dev), params), dp=1,
                b_local=2, max_len=64, chunk_size=16, prefix_sharing=True,
                sched=SchedConfig(**sched), device=dev,
                flight=FlightRecorder(capacity=4096))
            reqs = []
            for op in script:
                if isinstance(op, tuple):
                    rid, prompt, max_new, slo = op
                    reqs.append(tengine.Request(rid, prompt=list(prompt),
                                                max_new_tokens=max_new,
                                                slo=slo))
                    eng.submit(reqs[-1])
                elif op is None:
                    eng.run(max_steps=500)
                else:
                    for _ in range(op):
                        eng.step()
            check(all(r.done for r in reqs), f"pins {n} on {dev}: finished")
            stats = {k: v for k, v in eng.stats.items()
                     if k not in ("stragglers", "step_timeouts")}
            pool = [t.cpu() for hp in eng.state.pool.classes
                    for t in (hp.shared.free_ids, hp.shared.top,
                              hp.shared.refcount, hp.private_ids,
                              hp.private_top)]
            runs[dev] = dict(
                tokens=[r.out_tokens for r in reqs],
                status=[rec["status"] for rec in eng.flight.ring],
                stats=stats, sched=dict(eng.scheduler.stats), pool=pool,
                pins=eng.pin_tables.cpu(), flushed=eng.flush_pins(),
                empty=eng.page_occupancy() == 0.0 and eng.leak_free())
        a, b = runs["cpu"], runs["cuda"]
        check(all(a[k] == b[k] for k in ("tokens", "status", "stats",
                                         "sched", "flushed"))
              and all(torch.equal(x, y) for x, y in zip(a["pool"],
                                                        b["pool"]))
              and torch.equal(a["pins"], b["pins"]) and a["empty"]
              and b["empty"], f"pins {n}: the card == the CPU")
        st = b["stats"]
        check(st["pins_created"] > 0 and st["pin_hit_reqs"] > 0
              and (n or st["preemptions"] > 0),
              f"pins {n}: pins created and hit, preemption in the first")
        phase(f"[4] smoke pins and preemption ({n + 1}/2, {sched}) on the "
              f"card == on the CPU: {len(b['status'])} steps, preemptions "
              f"{st['preemptions']}, pins created {st['pins_created']}, "
              f"pin hits {st['pin_hit_reqs']} ({st['pin_hit_tokens']} "
              f"tokens); identical tokens, status rows, stats, pool "
              f"leaves and pin tables; 0 pages after flush_pins")


def sample_reqs(reqs, temp, top_k):
    """Sample three requests in four (temperature ``temp``, top-k
    ``top_k``, seed 1000 + rid); every fourth stays greedy."""
    for r in reqs:
        if r.rid % 4:
            r.temperature, r.top_k, r.seed = temp, top_k, 1000 + r.rid
    return reqs


def choice_gap(cfg, params, req, p, device):
    """(top-2 gap, scale) of the scores that chose output token ``p`` of
    ``req`` (its prompt and first ``p`` tokens as the context), from one
    forward pass: ``logits / T + g`` after top-k for a sampled request,
    the logits for a greedy one."""
    from repro_torch.models.layers import logits_apply
    from repro_torch.models.transformer import forward_train
    from repro_torch.serving.sampling import perturbed_scores

    context = list(req.prompt) + list(req.out_tokens[:p])
    with torch.no_grad():
        x = forward_train(cfg, params, torch.tensor([context], device=device),
                          remat=False)
        scores = logits_apply(cfg, params["embed"], x[:, -1])[0].float()
    if req.temperature > 0:
        def reg(v, dt):
            return torch.tensor(v, dtype=dt, device=device)
        scores = perturbed_scores(
            scores, reg(req.temperature, torch.float32),
            reg(req.top_k, torch.int32), reg(req.seed, torch.int32),
            reg(p, torch.int32))
    finite = scores[torch.isfinite(scores)]
    top = finite.topk(2).values
    return (top[0] - top[1]).item(), finite.abs().max().item()


def check_streams(tag, cfg, params, device, ref, got, tol):
    """Every stream of ``got`` equals the one of ``ref`` (same requests,
    in order) or differs first at a near-tie: the top-2 gap of the
    scores of ``ref``'s choice (:func:`choice_gap`, ``params`` on
    ``device``) within ``tol`` of their scale.  Returns (identical
    streams, near-ties)."""
    same = ties = 0
    for a, b in zip(ref, got):
        if a.out_tokens == b.out_tokens:
            same += 1
            continue
        p = next((j for j, (u, v) in enumerate(zip(a.out_tokens,
                                                   b.out_tokens)) if u != v),
                 min(len(a.out_tokens), len(b.out_tokens)))
        gap, scale = choice_gap(cfg, params, a, p, device)
        phase(f"{tag} stream {a.rid} (temperature {a.temperature}) differs "
              f"first at token {p}: top-2 gap {gap:.3e}, scale {scale:.3e}")
        check(p < min(len(a.out_tokens), len(b.out_tokens))
              and gap <= tol * scale,
              f"{tag} stream {a.rid}: a divergence that is not a near-tie")
        ties += 1
    return same, ties


def pool_state(eng):
    """The engine's pool leaves on the CPU, every class."""
    return [t.cpu() for hp in eng.state.pool.classes
            for t in (hp.shared.free_ids, hp.shared.top, hp.shared.refcount,
                      hp.private_ids, hp.private_top)]


def same_tensors(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def check_sampled_engine_vs_cpu(tengine, cfg_smoke, seed):
    """Phase 4: sampled requests (temperature 0.9, top-k 8, seeds 1000 +
    rid, a quarter greedy) through the smoke olmo-1b engine with
    speculation (draft length 4, the gate off) and preemption
    (``SchedConfig(page_budget=6)``), on the card against the CPU: two
    requests on a 16-token hot prefix, an interactive arrival that
    preempts, then three more on the prefix that draft from the
    finished streams.  Identical tokens, status rows, stats and pool
    leaves; a token may differ only at a near-tie of the CPU run (top-2
    gap of ``logits / T + g`` within 1e-5 of its scale), and then the
    rest is not compared."""
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import init_params
    from repro_torch.serving.sched import SchedConfig
    from repro_torch.serving.telemetry import FlightRecorder

    params = init_params(cfg_smoke, seed=seed, device="cpu")
    rng = np.random.RandomState(seed + 4)
    hot = list(rng.randint(1, cfg_smoke.vocab, 16))
    tails = [list(rng.randint(1, cfg_smoke.vocab, 4)) for _ in range(3)]
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = tengine.ServingEngine(
            cfg_smoke, tree_map(lambda a: a.to(dev), params), dp=1,
            b_local=2, max_len=64, chunk_size=8, prefix_sharing=True,
            speculate=True, draft_len=4, spec_gate=False,
            sched=SchedConfig(page_budget=6), device=dev,
            flight=FlightRecorder(capacity=4096))
        reqs = sample_reqs([tengine.Request(
            i, prompt=hot + tails[i % 3], max_new_tokens=6,
            slo="interactive" if i == 2 else "standard")
            for i in range(6)], 0.9, 8)
        eng.submit(reqs[0])
        eng.submit(reqs[1])
        for _ in range(3):
            eng.step()
        eng.submit(reqs[2])
        eng.run(max_steps=500)
        for r in reqs[3:]:
            eng.submit(r)
        eng.run(max_steps=500)
        check(all(r.done for r in reqs) and eng.leak_free(),
              f"sampled smoke engine on {dev} drained")
        runs[dev] = dict(
            reqs=reqs, status=[rec["status"] for rec in eng.flight.ring],
            stats={k: v for k, v in eng.stats.items()
                   if k not in ("stragglers", "step_timeouts")},
            pool=pool_state(eng))
    a, b = runs["cpu"], runs["cuda"]
    same, ties = check_streams("[4] sampled smoke engine", cfg_smoke, params,
                               "cpu", a["reqs"], b["reqs"], 1e-5)
    if not ties:
        check(a["status"] == b["status"] and a["stats"] == b["stats"]
              and same_tensors(a["pool"], b["pool"]),
              "sampled smoke engine: status rows, stats and pool leaves on "
              "the card == on the CPU")
    st = a["stats"]
    check(st["preemptions"] >= 1 and st["spec_lanes"] >= 1,
          f"sampled smoke engine: a preemption and a speculative lane "
          f"({st['preemptions']}, {st['spec_lanes']})")
    phase(f"[4] sampled smoke engine (speculation, preemption) on the card "
          f"== on the CPU: {len(b['status'])} steps, preemptions "
          f"{st['preemptions']}, speculative lanes {st['spec_lanes']}, "
          f"drafts accepted {st['spec_accepted']}; {same} of 6 streams "
          f"identical, near-ties {ties}; status rows, stats and pool leaves "
          f"identical{' (not compared after a near-tie)' if ties else ''}")


def check_crash_engine_vs_cpu(tengine, cfg_smoke, seed):
    """Phase 4: a host crash at ``post_sync`` and a torn crash (drained,
    never refilled) at ``dispatched``, each recovered through
    ``chaos.recover_engine``, on the card against the CPU: the smoke
    olmo-1b at dp 2 with pins, 9 requests, a quarter greedy.  Identical
    streams, status rows, reconcile reports, pool leaves after the
    recovery and after the drain."""
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import init_params
    from repro_torch.serving import chaos
    from repro_torch.serving.sched import SchedConfig
    from repro_torch.serving.telemetry import FlightRecorder

    params = init_params(cfg_smoke, seed=seed, device="cpu")
    rng = np.random.RandomState(seed + 5)
    hot = list(rng.randint(1, cfg_smoke.vocab, 16))
    prompts = [hot + list(rng.randint(1, cfg_smoke.vocab, rng.randint(2, 9)))
               if i % 2 else list(rng.randint(1, cfg_smoke.vocab,
                                              rng.randint(3, 30)))
               for i in range(9)]
    for fault in ("post_sync", "dispatched"):
        runs = {}
        for dev in ("cpu", "cuda"):
            dparams = tree_map(lambda a: a.to(dev), params)
            journal = chaos.ServingJournal()
            injector = chaos.ServingFailureInjector([chaos.Fault(
                step=5, phase=fault, kind="crash", torn=fault == "dispatched")])

            def build():
                return tengine.ServingEngine(
                    cfg_smoke, dparams, dp=2, b_local=2, max_len=64,
                    chunk_size=8, prefix_sharing=True,
                    sched=SchedConfig(pin_pages=8), journal=journal,
                    injector=injector, device=dev,
                    flight=FlightRecorder(capacity=4096))

            eng = build()
            reqs = sample_reqs([tengine.Request(i, prompt=p, max_new_tokens=6)
                                for i, p in enumerate(prompts)], 0.9, 8)
            for r in reqs:
                eng.submit(r)
            try:
                eng.run(max_steps=500)
                check(False, f"crash at {fault} on {dev}: fired")
            except chaos.HostCrash:
                pass
            eng2, report = chaos.recover_engine(build, eng, journal)
            recovered = pool_state(eng2)
            eng2.run(max_steps=500)
            eng2.flush_pins()
            check(journal.finished() == set(range(9))
                  and not journal.in_flight() and eng2.leak_free()
                  and report["conserved"] and report["never_dry"],
                  f"crash at {fault} on {dev}: recovered and drained")
            outs = journal.outputs()
            runs[dev] = dict(
                reqs=[dataclasses.replace(r, out_tokens=outs[r.rid])
                      for r in reqs],
                report={k: v for k, v in report.items() if k != "requests"},
                recovered=recovered, pool=pool_state(eng2),
                status=[rec["status"] for rec in eng2.flight.ring])
        a, b = runs["cpu"], runs["cuda"]
        same, ties = check_streams(f"[4] crash at {fault}", cfg_smoke, params,
                                   "cpu", a["reqs"], b["reqs"], 1e-5)
        check(a["report"] == b["report"]
              and same_tensors(a["recovered"], b["recovered"]),
              f"crash at {fault}: reconcile reports and recovered pool "
              f"leaves on the card == on the CPU")
        if not ties:
            check(a["status"] == b["status"]
                  and same_tensors(a["pool"], b["pool"]),
                  f"crash at {fault}: status rows and drained pool leaves "
                  f"on the card == on the CPU")
        rep = b["report"]
        phase(f"[4] smoke crash at {fault}{' (torn)' if fault == 'dispatched' else ''}"
              f", recovered through recover_engine, on the card == on the "
              f"CPU: reconcile reclaimed {rep['reclaimed']}, resurrected "
              f"{rep['resurrected']}, requeued {rep['requeued']}, pins "
              f"restored {rep['pins_restored']}, conserved "
              f"{rep['conserved']}, never_dry {rep['never_dry']}; "
              f"{len(b['status'])} steps; {same} of 9 streams identical, "
              f"near-ties {ties}; 0 pages after the drain")


def make_requests(tengine, cfg, seed, n=16, hi=1024, n_long=0, long_lo=0):
    """The smoke workload: ``n`` requests of 64-``hi`` random prompt
    tokens and 32-64 new tokens each, from ``seed``; every (n //
    n_long)-th prompt (``n_long`` of them) is at least ``long_lo``
    tokens long."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(64, hi + 1, n)
    if n_long:
        lens[::n // n_long] = rng.randint(long_lo, hi + 1, n_long)
    return [tengine.Request(i, prompt=list(rng.randint(1, cfg.vocab, m)),
                            max_new_tokens=int(rng.randint(32, 65)))
            for i, m in enumerate(lens)]


def serve_full_width(tag, tengine, counted, kernel, cfg, seed, b_local,
                     max_len, chunk, reqs, size_classes=1,
                     profile_reqs=None):
    """Phases 5, 9 and 10: one model at full width through
    ``ServingEngine.run``.  ``counted`` maps each kernel's name to its
    dispatcher; ``kernel`` names the one that every layer of its kind
    must launch once a step, and no other kernel may run.  For paged
    attention (``kernel`` K1) a step of width 1 (every lane decoding)
    runs K2 instead, once per layer.  In bf16, K1 and K2 take their
    wgmma and tma routes at hd 64, 96 and 128 and their fma kernels at
    any other hd; K4 its step route at T = 1, its wgmma route from
    SCAN_WGMMA_MIN_S tokens on and its fma kernel between.  Layers
    count by their base kind (a ``global_moe`` layer is ``global``).
    The peak of CLS_STATE blocks in use is the most slots held after a
    step times a slot's grant; after the step it watches, the blocks in
    use are read and must be the slots held times the grant.
    ``profile_reqs``, when given, are served again under the profiler.
    Returns the run's numbers, among them the peaks of
    ``max_memory_allocated`` in the weights' draw (``init_tree`` drawing
    a leaf in float32 beside the leaves drawn) and from then to the
    drain."""
    from repro_torch.configs.base import base_kind
    from repro_torch.core.classed_pool import CLS_STATE
    from repro_torch.kernels.rg_lru.ops import LRU_TMA_MIN_S
    from repro_torch.kernels.ssd_scan.ops import SCAN_WGMMA_MIN_S
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import init_params

    tag = f"{tag} {cfg.name}"
    phase(f"{tag}: before the weights, memory_allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(p.numel() for p in tree_leaves(params))
    phase(f"{tag} params: {n_params} ({cfg.dtype}), init {init_s:.1f} s, "
          f"memory_allocated {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB, the draw's peak {init_peak / 2**30:.2f} GiB")
    eng = tengine.ServingEngine(cfg, params, dp=1, b_local=b_local,
                                max_len=max_len, chunk_size=chunk,
                                size_classes=size_classes, device="cuda")
    bounded = bool(eng.state.rings or eng.state.rec
                   or eng.state.enc_kv is not None)
    check((eng.prefix_cache is None) == bounded
          and not (bounded and eng.speculate),
          f"{tag}: sharing and speculation off exactly for ring, recurrent "
          f"and encoder state")
    # warm-up: one short request loads the prefill (T = 64) and decode
    # (T = 1) kernels and picks the matmul algorithms; not counted
    eng.submit(tengine.Request(10**6, prompt=[1] * (chunk + 1),
                               max_new_tokens=3))
    eng.run(max_steps=100)
    kind = {"K1": "global", "K4": "ssd", "K5": "rglru"}[kernel]
    n_layers = sum(1 for k in cfg.layer_kinds if base_kind(k) == kind)
    phase(f"{tag}: {n_layers} {kind} layers, {size_classes} size "
          f"class(es): {eng.pages_local} KV pages a shard, "
          f"{eng.est_state_blocks(reqs[0])} state blocks a slot; "
          f"{sum(len(r.prompt) for r in reqs)} prompt tokens (longest "
          f"{max(len(r.prompt) for r in reqs)}), "
          f"{sum(r.max_new_tokens for r in reqs)} new tokens asked")
    # the main path's run: counts zeroed just before, read just after
    zero_counts(counted)
    steps0, transfers0 = eng.stats["steps"], eng.host_transfers
    tokens0, prompt0 = eng.stats["tokens_out"], eng.stats["prompt_tokens"]
    width1_0 = eng.stats["chunk_hist"].get(1, 0)
    hist0 = dict(eng.stats["chunk_hist"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    for _ in range(3):                      # prefill chunks
        eng.step()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "called a synchronizing" in str(w.message)]
    peak_slots = len(eng.active)
    if eng._state_blocks:
        held = eng.blocks_in_use(CLS_STATE)
        check(held == peak_slots * eng._state_blocks,
              f"{tag}: CLS_STATE blocks in use after step 4 ({held}) are "
              f"the slots held x a slot's grant ({peak_slots} x "
              f"{eng._state_blocks})")
    for _ in range(10_000):
        if eng.idle():
            break
        eng.step()
        peak_slots = max(peak_slots, len(eng.active))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    steps = eng.stats["steps"] - steps0
    transfers = eng.host_transfers - transfers0
    tokens = eng.stats["tokens_out"] - tokens0
    prompt = eng.stats["prompt_tokens"] - prompt0
    decode_steps = eng.stats["chunk_hist"].get(1, 0) - width1_0
    # the kernels each step must launch, once per layer of its kind
    want = {kernel: n_layers * steps}
    if kernel == "K1":
        want = {"K1": n_layers * (steps - decode_steps),
                "K2": n_layers * decode_steps}
    check(all(r.done for r in reqs), f"{tag}: every request finished")
    check(all(0 <= t < cfg.vocab for r in reqs for t in r.out_tokens),
          f"{tag}: tokens inside the vocabulary")
    check([len(r.out_tokens) for r in reqs]
          == [r.max_new_tokens for r in reqs], f"{tag}: every budget "
                                               f"generated")
    check(all(launches[k] == n > 0 for k, n in want.items())
          and sum(launches.values()) == sum(want.values()),
          f"{tag}: {' and '.join(want)} launched once per {kind} layer per "
          f"step of their width and no other kernel ran ({launches}, "
          f"{steps} steps, {decode_steps} of width 1)")
    check(transfers == steps, f"{tag}: one transfer per step ({transfers}, "
                              f"{steps})")
    k1_routes = dict(counted["K1"].routes)
    k2_routes, k4_routes = dict(counted["K2"].routes), dict(
        counted["K4"].routes)
    k5_routes = dict(counted["K5"].routes)
    # steps by width T
    hist = {w: n - hist0.get(w, 0) for w, n in eng.stats["chunk_hist"].items()}
    if kernel == "K1" and cfg.dtype == "bfloat16":
        r1 = "wgmma" if cfg.hd in (64, 96, 128) else "fma"
        r2 = "tma" if cfg.hd in (64, 96, 128) else "fma"
        check(k1_routes[r1] == launches["K1"],
              f"{tag}: every K1 launch took the {r1} route ({k1_routes})")
        check(k2_routes[r2] == launches["K2"],
              f"{tag}: every K2 launch took the {r2} route ({k2_routes})")
    if kernel == "K4" and cfg.dtype == "bfloat16":
        # T = 1 on the step route, T >= SCAN_WGMMA_MIN_S on the wgmma
        # route, the widths between on the fma kernel
        wide = sum(n for w, n in hist.items() if w >= SCAN_WGMMA_MIN_S)
        one = hist.get(1, 0)
        check(k4_routes["wgmma"] == n_layers * wide > 0
              and k4_routes["step"] == n_layers * one > 0
              and k4_routes["fma"] == launches["K4"] - n_layers * (wide + one),
              f"{tag}: every K4 launch at T = 1 took the step route, at T >= "
              f"SCAN_WGMMA_MIN_S the wgmma route, the others the fma route "
              f"({k4_routes}, steps by width {hist})")
    if kernel == "K5" and cfg.d_model % 4 == 0:
        # T >= LRU_TMA_MIN_S on the tma route
        wide = sum(n for w, n in hist.items() if w >= LRU_TMA_MIN_S)
        check(k5_routes["tma"] == n_layers * wide > 0
              and k5_routes["seq"] == launches["K5"] - n_layers * wide,
              f"{tag}: every K5 launch at T >= LRU_TMA_MIN_S took the tma "
              f"route, the others the seq route ({k5_routes}, steps by "
              f"width {hist})")
    in_use = [eng.blocks_in_use(c) for c in range(eng.n_classes)]
    check(not any(in_use) and eng.leak_free(),
          f"{tag}: no KV page and no state block in use after the drain")
    split = "; ".join(f"{k} launches {launches[k]} = {n_layers} x "
                      f"{n // n_layers} steps" for k, n in want.items())
    phase(f"{tag}: served {len(reqs)} requests: {steps} steps ("
          f"{decode_steps} decode-only), {tokens} tokens out, {prompt} "
          f"prompt tokens, wall {wall:.3f} s; {split} (by route: K1 "
          f"{k1_routes}, K2 {k2_routes}, K4 {k4_routes}, K5 {k5_routes}), "
          f"other kernels "
          f"{sum(launches.values()) - sum(want.values())}"
          f"; device->host transfers {transfers} (1 per step), "
          f"synchronizing calls in one step under sync-debug mode: "
          f"{len(syncs)} {syncs}; state blocks granted "
          f"{eng.stats['state_blocks_granted']}, peak in use "
          f"{peak_slots * eng._state_blocks} ({peak_slots} slots x "
          f"{eng._state_blocks}); blocks in use after the "
          f"drain, per class (KV first): {in_use}")
    phase(f"{tag}: end-to-end {tokens / wall:.1f} generated tok/s, "
          f"{(tokens + prompt) / wall:.1f} total tok/s, "
          f"{1e3 * wall / steps:.2f} ms/step")
    out = dict(launches=launches[kernel], steps=steps, tok_s=tokens / wall,
               ms_step=1e3 * wall / steps, n_layers=n_layers,
               k2=launches.get("K2", 0), decode_steps=decode_steps,
               k1_routes=k1_routes, k2_routes=k2_routes,
               k4_routes=k4_routes, k5_routes=k5_routes,
               state_peak=peak_slots * eng._state_blocks,
               peak_bytes=torch.cuda.max_memory_allocated(),
               init_peak_bytes=init_peak, n_params=n_params, init_s=init_s,
               tokens=[r.out_tokens for r in reqs])
    if profile_reqs is not None:
        profile_serve(eng, profile_reqs, f"{tag} [p]")
    del eng, params
    torch.cuda.empty_cache()
    return out


def time_scan(kind, fn_cuda, plain, bound_bytes, flops, dims, n_layers, rng,
              dtype, present=None, tensor_flops=None, with_plain=True):
    """Phase 11: K4 or K5 (``fn_cuda`` launches it on inputs and a state)
    and its plain version at one serving shape, beside the bound.  Each
    layer has its own state, so the timing cycles through ``n_layers``
    inputs and states and reads them cold, as a step does.  No single
    PyTorch call computes either recurrence: no library time.
    ``present``, when given, launches the kernel a route replaced, timed
    on the same inputs.  ``flops`` counts float32 operations (at the
    card's float32 peak), ``tensor_flops``, when given, the kernel's
    bf16 tensor-core ones instead (the bound then takes those)."""
    layers = []
    for _ in range(n_layers):
        args, h = scan_case(rng, kind, dims, dtype)
        layers.append((args, h))
    it = iter(range(10 ** 9))

    def timed(fn):
        def call():
            args, h = layers[next(it) % n_layers]
            fn(*args, h)
        return call

    ms, host_ms, enq = cuda_ms(timed(fn_cuda), iters=4 * n_layers,
                               enqueue=True)
    extra = {"enqueue_ms": enq}
    if present is not None:
        (extra["present_ms"], extra["present_host_ms"],
         extra["present_enqueue_ms"]) = cuda_ms(
            timed(present), iters=4 * n_layers, enqueue=True)
    plain_ms = (cuda_ms(timed(plain), iters=n_layers, warmup=1)[0]
                if with_plain else None)
    args, h = layers[0]
    nbytes = bound_bytes(args, h)
    nflops = flops(args)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    f32_ms = 1e3 * nflops / PEAK_OPS[torch.float32]
    ops_ms = f32_ms
    if tensor_flops is not None:
        extra["tensor_flops"] = tensor_flops(args)
        ops_ms = 1e3 * extra["tensor_flops"] / PEAK_OPS[torch.bfloat16]
    extra["bounds"] = {"bytes_ms": bytes_ms, "f32_ops_ms": f32_ms,
                       "ops_ms": ops_ms}
    return dict(T=dims[1], ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes, flops=nflops, **extra)


def hot_prefix_prompts(cfg, seed, n=32):
    """Phase 7's traffic: 4 system prompts of 512 tokens (8 pages), each
    request one of them plus a user tail of 32-128 tokens; every other
    request repeats an earlier prompt exactly."""
    rng = np.random.RandomState(seed + 7)
    systems = [list(rng.randint(1, cfg.vocab, 512)) for _ in range(4)]
    prompts = []
    for i in range(n):
        if i % 2:
            prompts.append(list(prompts[rng.randint(len(prompts))]))
        else:
            prompts.append(systems[(i // 2) % 4] + list(
                rng.randint(1, cfg.vocab, rng.randint(32, 129))))
    return prompts


def serve_trace(tengine, k3, ops, cfg, params, prompts, speculate, b_local,
                max_len, chunk, max_new=64, sampled=False):
    """Serve ``prompts`` on a fresh engine (after a warm-up that runs a
    prefill chunk, plain decode and, with speculation, a verify step),
    with the kernels' launch counts zeroed just before and read just
    after; ``sampled`` samples three requests in four as phase 16 does.
    Returns the run's numbers."""
    from repro_torch.serving.telemetry import FlightRecorder

    eng = tengine.ServingEngine(
        cfg, params, dp=1, b_local=b_local, max_len=max_len,
        chunk_size=chunk, prefix_sharing=True, speculate=speculate,
        draft_len=4, device="cuda", flight=FlightRecorder(capacity=100_000))
    warm = [1] * (chunk + 1)
    for rid in (10**6, 10**6 + 1):     # the second drafts from the first
        eng.submit(tengine.Request(rid, prompt=list(warm), max_new_tokens=8))
        eng.run(max_steps=100)
    reqs = [tengine.Request(i, prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    if sampled:
        sample_reqs(reqs, 0.8, 50)
    st0 = dict(eng.stats)
    transfers0, adm0 = eng.host_transfers, eng.admission_transfers
    n_rec0 = len(eng.flight.ring)
    # the main path's run: counts zeroed just before, read just after
    ops.paged_attention_chunk.launches = 0
    ops.paged_attention.launches = 0
    k3.verify_attention.launches = 0
    k3.verify_attention.widths.clear()
    for fn in (ops.paged_attention_chunk, k3.verify_attention):
        for route in fn.routes:
            fn.routes[route] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_launches = ops.paged_attention_chunk.launches
    k2_launches = ops.paged_attention.launches
    k3_launches = k3.verify_attention.launches
    k3_widths = dict(sorted(k3.verify_attention.widths.items()))
    routes = {"K1": dict(ops.paged_attention_chunk.routes),
              "K3": dict(k3.verify_attention.routes)}
    recs = list(eng.flight.ring)[n_rec0:]
    d = {k: eng.stats[k] - st0[k] for k in (
        "steps", "tokens_out", "prompt_tokens", "spec_drafted",
        "spec_accepted", "spec_pages_rolled_back", "spec_mixed_steps",
        "prefix_shared_tokens", "prefix_shared_reqs", "cow_copies")}
    d.update(
        wall=wall, k1=k1_launches, k2=k2_launches, k3=k3_launches,
        k3_widths=k3_widths, routes=routes,
        spec_steps=sum(rec["spec"] for rec in recs), records=len(recs),
        decode_steps=sum(rec["T"] == 1 and not rec["spec"] for rec in recs),
        transfers=eng.host_transfers - transfers0,
        admission_transfers=eng.admission_transfers - adm0,
        tokens=[r.out_tokens for r in reqs], done=all(r.done for r in reqs),
        pages_after=eng.pages_in_use(), leak_free=eng.leak_free(), reqs=reqs)
    del eng
    torch.cuda.empty_cache()
    return d


def serve_speculative(tengine, k3, ops, cfg, seed, b_local, max_len, chunk):
    """Phase 7: hot-prefix traffic at full width, speculative and plain,
    in bf16 (the model's type; K3's main-path run) and in f32 (where
    the two runs must give identical tokens)."""
    from repro_torch.models.model import init_params

    n_layers = cfg.n_layers
    prompts = hot_prefix_prompts(cfg, seed)
    phase(f"[7] hot-prefix trace: {len(prompts)} requests, "
          f"{sum(len(p) for p in prompts)} prompt tokens, 64 new tokens "
          f"each, draft length 4")
    runs = {}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        params = init_params(c, seed=seed, device="cuda")
        for spec in (True, False):
            r = serve_trace(tengine, k3, ops, c, params, prompts, spec,
                            b_local, max_len, chunk)
            runs[dtype, spec] = r
            name = f"{dtype} {'speculative' if spec else 'plain'}"
            check(r["done"], f"{name}: every request finished")
            check(r["records"] == r["steps"], f"{name}: flight records")
            check(all(0 <= t < cfg.vocab for s in r["tokens"] for t in s)
                  and all(len(s) == 64 for s in r["tokens"]),
                  f"{name}: 64 tokens inside the vocabulary per request")
            check(r["pages_after"] == 0 and r["leak_free"],
                  f"{name}: no page in use after the drain")
            check(r["transfers"] == r["steps"],
                  f"{name}: one transfer per step ({r['transfers']}, "
                  f"{r['steps']})")
            other = r["steps"] - r["spec_steps"] - r["decode_steps"]
            check(r["k3"] == n_layers * r["spec_steps"]
                  and r["k2"] == n_layers * r["decode_steps"] > 0
                  and r["k1"] == n_layers * other,
                  f"{name}: K3 {r['k3']} launches = {n_layers} x "
                  f"{r['spec_steps']} speculative steps, K2 {r['k2']} = "
                  f"{n_layers} x {r['decode_steps']} decode-only steps, K1 "
                  f"{r['k1']} = {n_layers} x the other steps")
            route = "wgmma" if dtype == "bfloat16" else "fma"
            check(r["routes"]["K1"][route] == r["k1"]
                  and r["routes"]["K3"][route] == r["k3"],
                  f"{name}: K1 and K3 took their {route} routes "
                  f"({r['routes']})")
            check(sum(r["k3_widths"].values()) == r["k3"],
                  f"{name}: K3 launches by lane width {r['k3_widths']}")
            check(r["prefix_shared_tokens"] > 0, f"{name}: prefixes shared")
            if spec:
                check(r["spec_accepted"] > 0 and r["spec_steps"] > 0,
                      f"{name}: drafts accepted")
            phase(f"[7] {name}: {r['steps']} steps ({r['spec_steps']} "
                  f"speculative, {r['spec_mixed_steps']} mixed), drafted "
                  f"{r['spec_drafted']}, accepted {r['spec_accepted']}, "
                  f"pages rolled back {r['spec_pages_rolled_back']}, "
                  f"prefix_shared_tokens {r['prefix_shared_tokens']} "
                  f"({r['prefix_shared_reqs']} requests), cow_copies "
                  f"{r['cow_copies']}; K3 launches {r['k3']} = {n_layers} x "
                  f"{r['spec_steps']} (by lane width {r['k3_widths']}), K2 "
                  f"launches {r['k2']} = {n_layers} x {r['decode_steps']}, "
                  f"K1 launches {r['k1']} (routes: {r['routes']}); "
                  f"host_transfers {r['transfers']} = steps, "
                  f"admission_transfers {r['admission_transfers']}; pages "
                  f"in use after the drain {r['pages_after']}")
            phase(f"[7] {name}: {r['tokens_out'] / r['wall']:.1f} generated "
                  f"tok/s, {1e3 * r['wall'] / r['steps']:.2f} ms/step, wall "
                  f"{r['wall']:.3f} s")
        del params
        torch.cuda.empty_cache()
    check(runs["float32", True]["tokens"] == runs["float32", False]["tokens"],
          "f32: speculative tokens == plain tokens")
    a, b = runs["bfloat16", True]["tokens"], runs["bfloat16", False]["tokens"]
    same16 = sum(x == y for x, y in zip(a, b))
    phase(f"[7] f32: speculative == plain on all {len(prompts)} streams; "
          f"bf16: {same16} of {len(prompts)} streams identical (near-ties "
          f"may flip between kernels and matmul widths)")
    return runs["bfloat16", True]


def serve_entry_point(counted, smi):
    """Phase 14 (a): ``repro_torch.launch.serve.main``, the entry point a
    user starts a server from, at full width (olmo-1b, bf16, dp 1, 8
    slots, max_len 2048, its own seed-0 weights and trace): 32 requests
    on a 512-token hot prefix, 64 new tokens each, a quarter of them
    interactive, 64 pin pages.  The launch counts are zeroed just
    before ``main`` and read just after.  Returns the run's numbers."""
    import contextlib
    import io
    import re

    from repro_torch.launch import serve

    argv = ["--arch", "olmo-1b", "--dp", "1", "--b-local", "8",
            "--max-len", "2048", "--hot-prefix", "512", "--requests", "32",
            "--max-new", "64", "--interactive-frac", "0.25",
            "--pin-pages", "64", "--device", "cuda"]
    phase(f"[14a] python -m repro_torch.launch.serve {' '.join(argv)}")
    zero_counts(counted)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        eng = serve.main(argv)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counted.items()}
    k2_routes = dict(counted["K2"].routes)
    for line in out.getvalue().splitlines():
        phase(f"[14a] | {line}")
    st = eng.stats
    steps, decode_steps = st["steps"], st["chunk_hist"].get(1, 0)
    n_layers = eng.cfg.n_layers
    tok_s = float(re.search(r"([\d.]+) tok/s\)", out.getvalue()).group(1))
    lat = eng.latency_quantiles()
    margin = eng.telemetry.never_dry_margin_min()
    check(len(eng._latencies) == 32 and not eng.active
          and eng.scheduler.backlog() == 0
          and st["tokens_out"] == 32 * 64, "[14a]: every request finished "
                                           "with 64 tokens")
    check(st["pins_created"] >= 1, "[14a]: at least one pin created")
    check(eng.host_transfers == steps, f"[14a]: one transfer per step "
                                       f"({eng.host_transfers}, {steps})")
    check(launches["K1"] == n_layers * (steps - decode_steps)
          and launches["K2"] == n_layers * decode_steps > 0
          and sum(launches.values()) == n_layers * steps,
          f"[14a]: K1 + K2 launches = {n_layers} x steps ({launches}, "
          f"{steps} steps, {decode_steps} decode-only)")
    check(k2_routes["tma"] == launches["K2"],
          f"[14a]: every K2 launch took the tma route ({k2_routes})")
    check(eng.page_occupancy() == 0.0 and eng.leak_free(),
          "[14a]: no page in use after the drain and flush_pins")
    check(margin is not None and margin >= 0, f"[14a]: never-dry margin "
                                              f"{margin} >= 0")
    phase(f"[14a] entry point on {smi}: {tok_s:.1f} generated tok/s, p50 "
          f"latency {1e3 * lat['p50_s']:.0f} ms, p50 time to first token "
          f"{1e3 * lat['first_token_p50_s']:.0f} ms; {steps} steps "
          f"({decode_steps} decode-only); K1 launches {launches['K1']}, K2 "
          f"launches {launches['K2']} (= {n_layers} x {steps}; K2 by route "
          f"{k2_routes}); transfers "
          f"{eng.host_transfers} = steps, admission_transfers "
          f"{eng.admission_transfers}; pins created {st['pins_created']}, "
          f"pin hits {st['pin_hit_reqs']}, preemptions "
          f"{st['preemptions']}, prefix_shared_reqs "
          f"{st['prefix_shared_reqs']}; never-dry margin {margin}")
    out = dict(k2=launches["K2"], k1=launches["K1"], steps=steps,
               tok_s=tok_s, **lat)
    del eng
    torch.cuda.empty_cache()
    return out


def route_ab(tag, tengine, cfg, seed, b_local, max_len, chunk, smi,
             routes, order, size_classes=1):
    """Phase 5's workload served once for each name of ``order`` on one
    warm engine, ``routes[name]()`` first choosing how a kernel of the
    step runs (``routes[None]()`` restores the default after); generated
    tok/s and ms/step of each run, the names in turns on one card."""
    from repro_torch.models.model import init_params

    params = init_params(cfg, seed=seed, device="cuda")
    eng = tengine.ServingEngine(cfg, params, dp=1, b_local=b_local,
                                max_len=max_len, chunk_size=chunk,
                                size_classes=size_classes, device="cuda")
    eng.submit(tengine.Request(10**6, prompt=[1] * (chunk + 1),
                               max_new_tokens=3))
    eng.run(max_steps=100)
    rates, tokens = {name: [] for name in order}, {}
    try:
        for name in order:
            routes[name]()
            reqs = make_requests(tengine, cfg, seed)
            steps0, out0 = eng.stats["steps"], eng.stats["tokens_out"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for r in reqs:
                eng.submit(r)
            eng.run(max_steps=10_000)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            steps = eng.stats["steps"] - steps0
            check(all(r.done for r in reqs), f"{tag} {name}: finished")
            rates[name].append(((eng.stats["tokens_out"] - out0) / wall,
                                1e3 * wall / steps))
            tokens[name] = [r.out_tokens for r in reqs]
    finally:
        routes[None]()
    for name, runs in rates.items():
        phase(f"{tag} {cfg.name}, phase 5's workload through {name}, on "
              f"{smi}: " + ", ".join(f"{r:.1f} generated tok/s ({ms:.2f} "
                                     f"ms/step)" for r, ms in runs))
    first = tokens[order[0]]
    for name in rates:
        same = sum(a == b for a, b in zip(first, tokens[name]))
        phase(f"{tag} {same} of {len(first)} streams identical between "
              f"{order[0]} and {name} (bf16: near-ties may flip)")
    del eng, params
    torch.cuda.empty_cache()
    return rates


def k4_turn(k4, scan_route, wgmma_from, step):
    """A :func:`route_ab` setter for K4 (the module ``k4``): its wgmma
    route from ``wgmma_from`` tokens on, and T = 1 on the step route if
    ``step``, else on the fma kernel; ``scan_route``, the module's own
    dispatcher, decides the rest."""
    def no_step(dtype, S, P, N):
        route = scan_route(dtype, S, P, N)
        return "fma" if route == "step" else route

    def set_():
        k4.SCAN_WGMMA_MIN_S = wgmma_from
        k4.scan_route = scan_route if step else no_step
    return set_


def decode_route_ab(tengine, ops, cfg, seed, b_local, max_len, chunk,
                    smi):
    """Phase 15: decode-only steps through K1 at T = 1 (the route before
    K2), through K2's tma route and through its fma kernel, in turns
    (:func:`route_ab`).  K1 at T = 1 over ``base`` is K2 over ``base +
    1`` with ``zero_empty``, so all compute the same function."""
    from repro_torch.models import transformer

    k2 = transformer.paged_attention

    def via_k1(q, kp, vp, table, seq_lens, zero_empty):
        return ops.paged_attention_chunk(q[:, None].contiguous(), kp, vp,
                                         table, seq_lens - 1)[:, 0]

    def via_fma(q, kp, vp, table, seq_lens, zero_empty):
        return ops.paged_attention_cuda(q, kp, vp, table, seq_lens,
                                        zero_empty, "fma")

    def use(fn):
        def set_():
            transformer.paged_attention = fn
        return set_

    return route_ab("[15]", tengine, cfg, seed, b_local, max_len, chunk, smi,
                    {"K1": use(via_k1), "K2 (tma)": use(k2),
                     "K2 (fma)": use(via_fma), None: use(k2)},
                    ("K1", "K2 (tma)", "K2 (fma)"))


def top2_gap(cfg, params, context):
    """(top-1 minus top-2 logit, largest |logit|) of the next token
    after ``context``, from one full forward pass on the card."""
    from repro_torch.models.layers import logits_apply
    from repro_torch.models.transformer import forward_train

    with torch.no_grad():
        x = forward_train(cfg, params, torch.tensor([context], device="cuda"),
                          remat=False)
        logits = logits_apply(cfg, params["embed"], x[:, -1])[0].float()
    top = logits.topk(2).values
    return (top[0] - top[1]).item(), logits.abs().max().item()


def serve_preempting(tengine, counted, cfg, seed, preemption=True,
                     sampled=False):
    """Phase 14 (b): the engine driven directly at full width with
    ``SchedConfig(pin_pages=128, pin_rows=16)`` (with the default 4 rows
    the 4 interactive prompts' own pins evict the victims' pins before
    readmission): 8 standard requests of 512-1,024
    prompt tokens and 128 new tokens fill the 8 slots; after 40 steps 4
    interactive requests of 64-256 prompt tokens and 32 new tokens
    arrive and preempt standard victims, whose whole pages ``preempt``
    pins and readmission shares back; ``sampled`` samples three requests
    in four as phase 16 does.  Returns the run's numbers; the engine's
    parameters stay in ``out["params"]`` for the caller."""
    from repro_torch.models.model import init_params
    from repro_torch.serving.sched import SchedConfig

    params = init_params(cfg, seed=seed, device="cuda")
    eng = tengine.ServingEngine(
        cfg, params, dp=1, b_local=8, max_len=2048, chunk_size=64,
        sched=SchedConfig(pin_pages=128, pin_rows=16,
                          preemption=preemption),
        device="cuda")
    rng = np.random.RandomState(seed + 14)
    std = [tengine.Request(i, prompt=list(rng.randint(
        1, cfg.vocab, rng.randint(512, 1025))), max_new_tokens=128)
        for i in range(8)]
    inter = [tengine.Request(8 + i, prompt=list(rng.randint(
        1, cfg.vocab, rng.randint(64, 257))), max_new_tokens=32,
        slo="interactive") for i in range(4)]
    if sampled:
        sample_reqs(std + inter, 0.8, 50)
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in std:
        eng.submit(r)
    for _ in range(40):
        eng.step()
    for r in inter:
        eng.submit(r)
    eng.run(max_steps=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    reqs = std + inter
    st = dict(eng.stats)
    out = dict(tokens=[r.out_tokens for r in reqs], done=all(
        r.done for r in reqs), steps=st["steps"], wall=wall,
        tokens_out=st["tokens_out"], preemptions=st["preemptions"],
        pins=st["pins_created"], pin_hits=st["pin_hit_reqs"],
        pin_hit_tokens=st["pin_hit_tokens"],
        victims=sum(r.preemptions > 0 for r in reqs),
        transfers=eng.host_transfers, launches=launches,
        flushed=eng.flush_pins(), prompts=[r.prompt for r in reqs],
        params=params, n_layers=cfg.n_layers, reqs=reqs)
    out["empty"] = eng.page_occupancy() == 0.0 and eng.leak_free()
    del eng
    torch.cuda.empty_cache()
    return out


def check_preempting(tengine, counted, cfg, seed, smi):
    """Phase 14 (b) in bf16 (the model's type), then in f32 with and
    without preemption: every f32 stream must be the same, or differ
    first where the top-2 logit gap is within 1e-4 of the logit scale
    (a near-tie that batch-dependent matmul widths may flip)."""
    runs = {}
    for name, dtype, pre in (("bf16", "bfloat16", True),
                             ("f32", "float32", True),
                             ("f32 no preemption", "float32", False)):
        c = dataclasses.replace(cfg, dtype=dtype)
        r = runs[name] = serve_preempting(tengine, counted, c, seed, pre)
        n = r["n_layers"]
        check(r["done"] and r["empty"], f"[14b] {name}: every request "
              f"finished; 0 pages after the drain and flush_pins")
        check(r["transfers"] == r["steps"], f"[14b] {name}: one transfer "
                                            f"per step")
        check(r["launches"]["K1"] + r["launches"]["K2"] == n * r["steps"]
              and sum(r["launches"].values()) == n * r["steps"],
              f"[14b] {name}: K1 + K2 = {n} x steps ({r['launches']})")
        if pre:
            check(r["preemptions"] >= 1 and r["pin_hits"] >= 1,
                  f"[14b] {name}: a preemption and a pin hit")
        else:
            check(r["preemptions"] == 0, f"[14b] {name}: no preemption")
        phase(f"[14b] {name} on {smi}: {r['steps']} steps, "
              f"{r['tokens_out'] / r['wall']:.1f} generated tok/s, "
              f"{1e3 * r['wall'] / r['steps']:.2f} ms/step; preemptions "
              f"{r['preemptions']} ({r['victims']} victims), pins created "
              f"{r['pins']}, pin hits {r['pin_hits']} "
              f"({r['pin_hit_tokens']} tokens), pins flushed "
              f"{r['flushed']}; K1 {r['launches']['K1']} + K2 "
              f"{r['launches']['K2']} launches = {n} x {r['steps']}; "
              f"transfers {r['transfers']} = steps")
        if name != "f32":
            del r["params"]
            torch.cuda.empty_cache()
    a, b = runs["f32"], runs["f32 no preemption"]
    c32 = dataclasses.replace(cfg, dtype="float32")
    same = 0
    for i, (x, y) in enumerate(zip(a["tokens"], b["tokens"])):
        if x == y:
            same += 1
            continue
        p = next(j for j, (u, v) in enumerate(zip(x, y)) if u != v)
        gap, scale = top2_gap(c32, a["params"], a["prompts"][i] + x[:p])
        phase(f"[14b] f32 stream {i} differs first at token {p}: top-2 "
              f"logit gap {gap:.3e}, logit scale {scale:.3e}")
        check(gap <= 1e-4 * scale, f"[14b] f32 stream {i}: a divergence "
                                   f"where the top-2 gap is not a near-tie")
    phase(f"[14b] f32: {same} of {len(a['tokens'])} streams of the "
          f"preempting run equal the run without preemption")
    del a["params"]
    torch.cuda.empty_cache()
    return runs["bf16"]


def launch_count(fn, n=10):
    """(device kernels a call, device ms a call) of ``fn`` over ``n``
    calls under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    # the first profiler session of a process has been seen to miss
    # kernels: a throwaway session first
    for _ in range(2):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.count for e in ev) / n,
            sum(e.self_device_time_total for e in ev) / 1e3 / n)


def sampler_cost(cfg, b_local, n_verify, smi):
    """Phase 16 (a): the device kernels and device time of one sampled
    step's sampler (``sample_tokens`` over [1, b_local, vocab] logits;
    ``sample_lane`` over ``n_verify`` positions on a speculative step)
    beside the greedy argmax the all-greedy step runs instead."""
    from repro_torch.serving.sampling import sample_lane, sample_tokens

    g = torch.Generator(device="cuda").manual_seed(16)
    logits = torch.randn(1, b_local, cfg.vocab, device="cuda", generator=g)
    lane = torch.randn(1, b_local, n_verify, cfg.vocab, device="cuda",
                       generator=g)
    temps = torch.full((1, b_local), 0.8, device="cuda")
    topks = torch.full((1, b_local), 50, dtype=torch.int32, device="cuda")
    seeds = 1000 + torch.arange(b_local, dtype=torch.int32,
                                device="cuda")[None]
    counts = torch.arange(b_local, dtype=torch.int32, device="cuda")[None]
    cnt = counts[..., None] + torch.arange(n_verify, dtype=torch.int32,
                                           device="cuda")
    out = {
        "greedy": launch_count(lambda: logits.argmax(-1).to(torch.int32)),
        "sample_tokens": launch_count(
            lambda: sample_tokens(logits, temps, topks, seeds, counts)),
        "sample_lane": launch_count(
            lambda: sample_lane(lane, temps, topks, seeds, cnt)),
    }
    for name, (k, ms) in out.items():
        phase(f"[16a] sampler on {smi}: {name} over "
              f"{'[1, %d, %d, %d]' % (b_local, n_verify, cfg.vocab) if name == 'sample_lane' else '[1, %d, %d]' % (b_local, cfg.vocab)}"
              f" logits: {k:.0f} device kernels a call, {ms:.4f} ms device "
              f"time a call")
    return out


def serve_sampled(tengine, counted, cfg, seed, b_local, max_len, chunk,
                  greedy_run, smi):
    """Phase 16 (a): phase 5's workload, three quarters sampled
    (temperature 0.8, top-k 50, seeds 1000 + rid), through
    ``serve_full_width`` twice: the checks of phase 5, and the two runs'
    streams bit for bit equal; ms/step and tok/s beside phase 5's greedy
    run; the sampler's launches a step."""
    runs, reqs = [], []
    for _ in range(2):
        reqs.append(sample_reqs(make_requests(tengine, cfg, seed), 0.8, 50))
        runs.append(serve_full_width("[16a]", tengine, counted, "K1", cfg,
                                     seed, b_local, max_len, chunk,
                                     reqs[-1]))
    check([r.out_tokens for r in reqs[0]] == [r.out_tokens for r in reqs[1]],
          "[16a]: a second run of the sampled workload gives the same "
          "streams bit for bit")
    greedy_same = sum(r.out_tokens == g for r, g in zip(
        reqs[0], greedy_run["tokens"]) if r.temperature == 0)
    cost = sampler_cost(cfg, b_local, 5, smi)
    r = runs[0]
    phase(f"[16a] {cfg.name} sampled on {smi}: {r['ms_step']:.2f} ms/step, "
          f"{r['tok_s']:.1f} generated tok/s (second run "
          f"{runs[1]['ms_step']:.2f} ms/step, {runs[1]['tok_s']:.1f} tok/s); "
          f"phase 5 greedy {greedy_run['ms_step']:.2f} ms/step, "
          f"{greedy_run['tok_s']:.1f} tok/s; the two sampled runs' "
          f"{len(reqs[0])} streams identical; {greedy_same} of "
          f"{sum(x.temperature == 0 for x in reqs[0])} greedy streams equal "
          f"to phase 5's; sampler "
          f"{cost['sample_tokens'][0]:.0f} kernels and "
          f"{cost['sample_tokens'][1]:.4f} ms a sampled step (greedy argmax "
          f"{cost['greedy'][0]:.0f} kernels, {cost['greedy'][1]:.4f} ms)")
    return dict(runs=runs, cost=cost)


def check_sampled_f32(tengine, k3, ops, counted, cfg, seed, b_local,
                      max_len, chunk, smi):
    """Phase 16 (b): in f32 at full width, phase 7's hot-prefix traffic
    with and without speculation and phase 14b's preempting traffic with
    and without preemption, both sampled as in (a): every stream equal,
    or first different at a near-tie (top-2 gap of ``logits / T + g``
    within 1e-4 of its scale)."""
    from repro_torch.models.model import init_params

    c32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(c32, seed=seed, device="cuda")
    prompts = hot_prefix_prompts(cfg, seed)
    traces = {spec: serve_trace(tengine, k3, ops, c32, params, prompts, spec,
                                b_local, max_len, chunk, sampled=True)
              for spec in (True, False)}
    a, b = traces[False], traces[True]
    check(a["done"] and b["done"] and a["leak_free"] and b["leak_free"]
          and b["spec_steps"] > 0,
          "[16b] sampled hot-prefix traffic finished, speculative steps ran")
    same, ties = check_streams("[16b] speculation", c32, params, "cuda",
                               a["reqs"], b["reqs"], 1e-4)
    phase(f"[16b] f32 sampled hot-prefix traffic on {smi}: speculative "
          f"{b['steps']} steps ({b['spec_steps']} speculative, drafted "
          f"{b['spec_drafted']}, accepted {b['spec_accepted']}), plain "
          f"{a['steps']} steps; {same} of {len(prompts)} streams equal, "
          f"near-ties {ties}")
    del params
    torch.cuda.empty_cache()
    pre = {p: serve_preempting(tengine, counted, c32, seed, p, sampled=True)
           for p in (True, False)}
    a, b = pre[False], pre[True]
    check(a["done"] and b["done"] and a["empty"] and b["empty"]
          and b["preemptions"] >= 1 and a["preemptions"] == 0,
          "[16b] sampled preempting traffic finished, with and without "
          "preemption")
    same2, ties2 = check_streams("[16b] preemption", c32, b["params"], "cuda",
                                 a["reqs"], b["reqs"], 1e-4)
    phase(f"[16b] f32 sampled preempting traffic on {smi}: preemptions "
          f"{b['preemptions']} ({b['victims']} victims), pin hits "
          f"{b['pin_hits']}; {same2} of {len(b['reqs'])} streams equal to "
          f"the run without preemption, near-ties {ties2}")
    del a["params"], b["params"]
    torch.cuda.empty_cache()
    return dict(spec_same=same, spec_ties=ties, pre_same=same2,
                pre_ties=ties2)


#: phase 16 (c)'s fault schedule and argv (20 (e) adds the ranks' flags)
CHAOS_FAULTS = ("poison@2:feed:5,straggler@4:pre_tick:0.05,"
                "crash@8:post_sync,shard_loss@14:post_admission:1,"
                "crash@20:dispatched:torn,error@26:post_sync")
CHAOS_ARGV = ["--arch", "olmo-1b", "--dp", "2", "--b-local", "4",
              "--max-len", "2048", "--hot-prefix", "512", "--requests", "24",
              "--max-new", "32", "--pin-pages", "64", "--deadline-s", "900",
              "--inject-fault", CHAOS_FAULTS, "--device", "cuda"]


def chaos_entry_run(counted, argv):
    """``repro_torch.launch.serve.main(argv)`` (one process, or a rank
    when ``argv`` asks for the mesh), the kernels' counts set to 0 just
    before it and read just after, every ``chaos.recover_engine``
    recorded.  Returns what phases 16 (c) and 20 (e) check: the lives'
    steps, transfers and collectives, the reconcile reports (of this
    rank's shard on a rank), the injector's log, the journal, the blocks
    in use on this process's first shard, launches, the host state and
    the call's wall time."""
    import contextlib
    import io

    from repro_torch.launch import serve
    from repro_torch.serving import chaos

    lives, reports = [], []
    recover = chaos.recover_engine

    def recording(build, crashed, journal):
        lives.append((crashed.stats["steps"], crashed.host_transfers,
                      crashed.collectives))
        eng, report = recover(build, crashed, journal)
        reports.append({k: v for k, v in report.items() if k != "requests"})
        return eng, report

    out = io.StringIO()
    zero_counts(counted)
    chaos.recover_engine = recording
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            eng = serve.main(argv)
    finally:
        chaos.recover_engine = recover
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    st, inj = eng.stats, eng._injector
    lives.append((st["steps"], eng.host_transfers, eng.collectives))
    last_crash = max(s for s, _, k in inj.log if k == "crash")
    return dict(
        lines=out.getvalue().splitlines(), log=list(inj.log),
        pending=inj.pending(),
        torn=sum(f.torn for f in inj.faults if f.kind == "crash"),
        errors_after=sum(s > last_crash for s, _, k in inj.log
                         if k == "error"),
        in_flight=len(eng._journal.in_flight()),
        finished=len(eng._journal.finished()), reports=reports,
        lost=sorted(eng.lost_shards),
        shard=0 if eng.mesh is None else eng.mesh.rank,
        live=[int(eng.state.pool.classes[c].shared.refcount[0].gt(0).sum())
              for c in range(eng.n_classes)],
        leak_free=eng.leak_free(), lives=lives,
        steps=sum(x[0] for x in lives), transfers=sum(x[1] for x in lives),
        collectives=sum(x[2] for x in lives), launches=launches,
        k1_routes=dict(counted["K1"].routes),
        k2_routes=dict(counted["K2"].routes),
        n_layers=eng.cfg.n_layers, recoveries=st["recoveries"],
        host=eng.host_state(), wall=wall)


def check_chaos_entry(tag, r):
    """Phase 16 (c)'s checks of one :func:`chaos_entry_run`: every
    fault fired, the journal drained, each reconcile conserved and
    never-dry, no block of any class in use on the surviving shard (when
    this process holds it), one transfer a step but the step a torn
    crash cut, K1 + K2 = layers x steps and no other kernel, telemetry
    ``recoveries`` equal to the injected step errors since the last
    crash (so a real failure recovered in place fails the run); K1 and
    K2 on their ``wgmma`` and ``tma`` routes (bf16 at full width)."""
    kinds = {k for _, _, k in r["log"]}
    check(not r["pending"] and kinds == {"poison", "straggler", "crash",
                                         "shard_loss", "error"}
          and len(r["reports"]) == 2,
          f"{tag}: every fault fired ({r['log']})")
    check(r["in_flight"] == 0, f"{tag}: the journal drained")
    check(all(x["conserved"] and x["never_dry"] for x in r["reports"]),
          f"{tag}: every reconcile conserved and never-dry")
    check(r["lost"] == [1] and r["leak_free"]
          and (r["shard"] == 1 or r["live"] == [0] * len(r["live"])),
          f"{tag}: no block in use on the surviving shard ({r['live']} on "
          f"shard {r['shard']})")
    check(r["transfers"] + r["torn"] == r["steps"],
          f"{tag}: one transfer a step but the step a torn crash cut "
          f"({r['transfers']} transfers, {r['steps']} steps)")
    n, got = r["n_layers"] * r["steps"], r["launches"]
    check(got["K1"] + got["K2"] == n and sum(got.values()) == n,
          f"{tag}: K1 + K2 = {r['n_layers']} x steps ({got}, "
          f"{r['steps']})")
    check(r["k1_routes"].get("wgmma", 0) == got["K1"]
          and r["k2_routes"].get("tma", 0) == got["K2"],
          f"{tag}: K1 on wgmma, K2 on tma ({r['k1_routes']}, "
          f"{r['k2_routes']})")
    check(r["errors_after"] >= 1 and r["recoveries"] == r["errors_after"],
          f"{tag}: telemetry recoveries {r['recoveries']} == injected step "
          f"errors since the last crash {r['errors_after']}")


def chaos_summary(r):
    return ("; ".join(f"reclaimed {x['reclaimed']}, resurrected "
                      f"{x['resurrected']}, requeued {x['requeued']}, pins "
                      f"restored {x['pins_restored']}" for x in r["reports"])
            + f"; recoveries {r['recoveries']}; finished {r['finished']}; "
              f"K1 {r['launches']['K1']} + K2 {r['launches']['K2']} "
              f"launches")


def serve_chaos_entry_point(counted, smi):
    """Phase 16 (c): ``repro_torch.launch.serve.main`` at full width in
    bf16, two shards of 4 slots, a 512-token hot prefix, 64 pin pages,
    deadlines, and a fault schedule that fires each kind: a poisoned
    request, a straggler, a crash at ``post_sync``, the loss of shard 1,
    a torn crash at ``dispatched`` and, after the last crash, a step
    error recovered in place; the checks of :func:`check_chaos_entry`."""
    phase(f"[16c] python -m repro_torch.launch.serve {' '.join(CHAOS_ARGV)}")
    r = chaos_entry_run(counted, CHAOS_ARGV)
    for line in r["lines"]:
        phase(f"[16c] | {line}")
    check_chaos_entry("[16c]", r)
    phase(f"[16c] entry point with faults on {smi}: {r['steps']} steps over "
          f"{len(r['lives'])} engine lives, transfers {r['transfers']}; "
          f"faults fired {r['log']}; reconciles: {chaos_summary(r)}; "
          f"blocks in use on shard 0 by class {r['live']}")
    torch.cuda.empty_cache()
    return dict(k1=r["launches"]["K1"], k2=r["launches"]["K2"],
                steps=r["steps"])


def check_crash_f32(tengine, cfg, seed, b_local, max_len, chunk, smi):
    """Phase 16 (d): the engine driven directly in f32 at full width, 8
    requests of 64-512 prompt tokens (a quarter greedy, the rest sampled
    as in (a)), uninterrupted and with a crash at ``post_sync`` and a
    torn crash at ``dispatched``, both recovered through
    ``chaos.recover_engine``: every stream equal to the uninterrupted
    run's or first different at a near-tie (1e-4), each reconcile
    conserved and never-dry, leak-free after the drain."""
    from repro_torch.models.model import init_params
    from repro_torch.serving import chaos

    c32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(c32, seed=seed, device="cuda")
    runs, reports = {}, []
    for faulty in (False, True):
        journal = chaos.ServingJournal()
        injector = chaos.ServingFailureInjector(
            [chaos.Fault(step=12, phase="post_sync", kind="crash"),
             chaos.Fault(step=30, phase="dispatched", kind="crash",
                         torn=True)] if faulty else [])

        def build():
            return tengine.ServingEngine(
                c32, params, dp=1, b_local=b_local, max_len=max_len,
                chunk_size=chunk, journal=journal, injector=injector,
                device="cuda")

        reqs = sample_reqs(make_requests(tengine, c32, seed + 16, n=8,
                                         hi=512), 0.8, 50)
        eng = build()
        for r in reqs:
            eng.submit(r)
        while True:
            try:
                eng.run(max_steps=10_000)
                break
            except chaos.HostCrash:
                eng, report = chaos.recover_engine(build, eng, journal)
                reports.append(report)
        outs = journal.outputs()
        check(journal.finished() == {r.rid for r in reqs}
              and not journal.in_flight() and eng.leak_free(),
              f"[16d] {'crashed' if faulty else 'uninterrupted'} run drained")
        runs[faulty] = [dataclasses.replace(r, out_tokens=outs[r.rid])
                        for r in reqs]
        del eng
    check(len(reports) == 2 and all(r["conserved"] and r["never_dry"]
                                    for r in reports),
          "[16d]: two recoveries, conserved and never-dry")
    same, ties = check_streams("[16d]", c32, params, "cuda", runs[False],
                               runs[True], 1e-4)
    phase(f"[16d] f32 crash at post_sync and torn crash at dispatched on "
          f"{smi}: reconciles " + "; ".join(
              f"reclaimed {r['reclaimed']}, resurrected {r['resurrected']}, "
              f"requeued {r['requeued']}, never_dry {r['never_dry']}"
              for r in reports)
          + f"; {same} of {len(runs[True])} streams equal to the "
            f"uninterrupted run, near-ties {ties}")
    del params
    torch.cuda.empty_cache()
    return dict(same=same, ties=ties)


def profiled(run, tag="[p]"):
    """``--profile``: call ``run()``, which returns its step count,
    under ``torch.profiler`` and print where a step's time goes."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, ops = [], []           # device kernels; host-side operators
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.key, e.count, e.self_device_time_total))
        else:
            ops.append((e.key, e.count, e.self_cpu_time_total))
    busy_us = sum(k[2] for k in kernels)
    launches = sum(k[1] for k in kernels)
    phase(f"{tag} profiled run: {steps} steps, wall {1e3 * wall:.1f} ms "
          f"({1e3 * wall / steps:.2f} ms/step), kernels "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / 1e6 / wall:.1f}% of "
          f"wall), {launches / steps:.0f} kernels/step")
    ranked = sorted(kernels, key=lambda r: -r[2])
    # the ten largest, and every kernel of the port's own sources
    for i, (key, count, t) in enumerate(ranked):
        if i < 10 or any(f"(anonymous namespace)::{k}" in key
                         for k in PORT_KERNELS):
            phase(f"{tag} device {t / 1e3 / steps:8.3f} ms/step {count:7d}x "
                  f"{key[:80]}")
    for key, count, t in sorted(ops, key=lambda r: -r[2])[:10]:
        phase(f"{tag} host   {t / 1e3 / steps:8.3f} ms/step {count:7d}x "
              f"{key[:80]}")


def profile_serve(eng, reqs, tag="[p]"):
    """``--profile``: serve ``reqs`` again on the warm engine under the
    profiler."""
    def run():
        steps0 = eng.stats["steps"]
        for r in reqs:
            eng.submit(r)
        eng.run(max_steps=10_000)
        return eng.stats["steps"] - steps0

    profiled(run, tag)


def device_split(fn, n):
    """Device ms a launch by kernel name, from ``torch.profiler`` over
    ``n`` calls of ``fn``.  Averaged over the launches the profiler saw:
    after an earlier profiler run in the same process (``--profile``)
    it has been seen to miss some of them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / e.count
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.count > 0}


def k2_launcher(ops, route, *options):
    """A ``kernel`` for :func:`time_kernel`: K2 on ``route`` (with
    ``options``, paged_attention_cuda's arguments after it) over K1's
    inputs at T = 1, q's one token and the lengths base + 1 made once,
    outside the timed call."""
    def make(q, kp, vp, table, base):
        q2, lens = q[:, 0].contiguous(), base + 1
        return lambda: ops.paged_attention_cuda(q2, kp, vp, table, lens,
                                                True, route, *options)
    return make


def time_kernel(kernel, bound_bytes, plain, rng, cfg, b_local, maxp, P, T,
                base, hot=0, present=None, split=False, variants=None):
    """Phases 6 and 8: a kernel, its plain version, SDPA over
    pre-gathered dense K/V with the same mask, and the bound, at one
    serving shape.  ``kernel(*inputs)`` returns a callable that
    launches the kernel once on those inputs (set-up the engine does
    once per step happens there, outside the timing); ``present``, when
    given, the same for the kernel that route replaced, timed on the
    same inputs.  Each of the model's layers has its own pages, so the
    timing cycles through that many K/V arrays and reads them cold from
    HBM, as a step does.  ``split``: also the device time of each
    kernel a call launches, under the profiler.  ``variants``: more
    makers like ``kernel``, by name, timed on the same inputs."""
    H, KH, hd, psz = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.page_size
    dt = cfg.tdtype
    layers = [attn_case(rng, b_local, T, H, KH, hd, psz, maxp, P, dt,
                        base=base, hot=hot) for _ in range(cfg.n_layers)]
    calls = [kernel(*layer) for layer in layers]
    it = iter(range(10 ** 9))

    def kern():
        calls[next(it) % len(calls)]()

    if present is not None:
        old = [present(*layer) for layer in layers]

        def kern_present():
            old[next(it) % len(old)]()

    def ref():
        plain(*layers[next(it) % len(layers)])

    # the library yardstick: SDPA on K/V gathered densely beforehand
    dense = []
    for q, kp, vp, table, bl in layers:
        L = maxp * psz
        safe = table.clamp(min=0).long()
        k = kp[safe].reshape(b_local, L, KH, hd).transpose(1, 2)
        v = vp[safe].reshape(b_local, L, KH, hd).transpose(1, 2)
        qpos = bl[:, None] + torch.arange(T, device="cuda")
        resident = (table >= 0).repeat_interleave(psz, dim=1)
        mask = ((torch.arange(L, device="cuda")[None, None] <= qpos[..., None])
                & resident[:, None])[:, None]
        dense.append((q.transpose(1, 2), k, v, mask))

    def lib():
        q, k, v, mask = dense[next(it) % len(dense)]
        torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=KH != H)

    ms, host_ms, enq = cuda_ms(kern, iters=4 * cfg.n_layers, enqueue=True)
    plain_ms, _ = cuda_ms(ref, iters=cfg.n_layers, warmup=1)
    library_ms, _ = cuda_ms(lib, iters=4 * cfg.n_layers)
    extra = {"enqueue_ms": enq}
    if present is not None:
        p_ms, p_host_ms, p_enq = cuda_ms(kern_present,
                                         iters=4 * cfg.n_layers, enqueue=True)
        extra.update(present_ms=p_ms, present_host_ms=p_host_ms,
                     present_enqueue_ms=p_enq)
    if split:
        extra["split"] = device_split(kern, 8 * cfg.n_layers)
    for name, maker in (variants or {}).items():
        made = [maker(*layer) for layer in layers]
        extra.setdefault("variants", {})[name] = cuda_ms(
            lambda: made[next(it) % len(made)](), iters=4 * cfg.n_layers)
    q, kp, vp, table, bl = layers[0]
    nbytes = bound_bytes(q, kp, table, bl)
    pairs = sum(int(b) + t + 1 for b in base for t in range(T))
    flops = 4 * hd * H * pairs
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * flops / PEAK_OPS[dt]
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    return dict(T=T, ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, flops=flops, **extra)


def k6_inputs(rng, B, H, KH, S, hd, dtype, grad=False):
    """K6's inputs on the card as the training step hands them over: q
    and k transposed views of [B, S, H, hd] tensors, v contiguous."""
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.randn(*shape).astype(np.float32)).to("cuda", dtype)
    q, k = f(B, S, H, hd).transpose(1, 2), f(B, S, KH, hd).transpose(1, 2)
    return [t.requires_grad_(grad) for t in (q, k, f(B, KH, S, hd))]


def check_k6_twin(k6, q, k, v, do, causal, got, name, tag="[3]"):
    """Phases 3 and 22 (e): the wgmma backward's gradients ``got``
    against its walk in float32 with P and dS rounded to bf16 where the
    kernels round them (``ref.flash_attention_bwd_tiled_ref``), each
    row held to its own scale (``ref.row_scaled_err``) within
    ``ref.BWD_ROW_TOL``; and
    two controls of the walk, the last query tile's pair with the key
    tile before it dropped and delta left out, above that limit, so a
    fault confined to late tiles would fail the check.  Returns the
    worst reading and the smaller control's."""
    from repro_torch.kernels.flash_attention.ref import (
        BWD_ROW_TOL, TILE, flash_attention_bwd_tiled_ref, row_scaled_err)

    q, k, v = (t.detach() for t in (q, k, v))
    o, lse = k6.flash_attention_cuda(q, k, v, causal)
    twin = flash_attention_bwd_tiled_ref(q, k, v, o, lse, do, causal)
    sound = [row_scaled_err(a, b) for a, b in zip(got, twin)]
    n = -(-q.shape[2] // TILE)
    pair = (n - 1, max(n - 2, 0))
    controls = {
        f"query tile {pair[0]} x key tile {pair[1]} dropped":
            flash_attention_bwd_tiled_ref(q, k, v, o, lse, do, causal,
                                          drop=pair),
        "delta left out": flash_attention_bwd_tiled_ref(
            q, k, v, torch.zeros_like(o), lse, do, causal)}
    ctrl = {c: max(row_scaled_err(a, b) for a, b in zip(grads, twin))
            for c, grads in controls.items()}
    check(max(sound) < BWD_ROW_TOL,
          f"K6 gradient {name}: each row within {BWD_ROW_TOL:g} of its "
          f"scale from the walk with bf16 P and dS ({sound})")
    check(min(ctrl.values()) > BWD_ROW_TOL,
          f"K6 gradient {name}: the walk's controls lie beyond "
          f"{BWD_ROW_TOL:g} ({ctrl})")
    phase(f"{tag} K6 gradient {name}, wgmma route vs its walk with bf16 P "
          f"and dS, row-scaled: dq {sound[0]:.3e}, dk {sound[1]:.3e}, dv "
          f"{sound[2]:.3e} (limit {BWD_ROW_TOL:g}); controls: "
          + ", ".join(f"{c} {e:.3e}" for c, e in ctrl.items()))
    del twin, controls
    torch.cuda.empty_cache()
    return max(sound), min(ctrl.values())


def check_k6_grad(k6, rng, name, dt, B, H, KH, S, hd, causal, tag="[3]"):
    """Phases 3 and 22 (e): K6's gradient through the autograd Function
    the model calls, its backward on the route ``ops.backward_route``
    picks (counted once, on that route), against autograd through the
    plain version at the dtype's ``TOL`` (bf16 at 6e-2: the kernels
    round P and dS to bf16 as the A operand of their products, and both
    read o rounded to bf16 in rowsum(dO * O)); the wgmma route also
    against its walk (:func:`check_k6_twin`); a second call bit-equal.
    Returns the largest error of dq, dk and dv, and for the wgmma route
    the walk's reading and its smaller control (else None)."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    q, k, v = k6_inputs(rng, B, H, KH, S, hd, dt, grad=True)
    do = torch.from_numpy(rng.randn(B, H, S, hd).astype(np.float32)).to(
        "cuda", dt)
    route = k6.backward_route(dt, hd)
    before = (k6.flash_attention.launches, k6.flash_attention_bwd.launches,
              k6.flash_attention_bwd.routes[route])
    got = torch.autograd.grad(k6.flash_attention(q, k, v, causal),
                              (q, k, v), do)
    torch.cuda.synchronize()
    check((k6.flash_attention.launches, k6.flash_attention_bwd.launches,
           k6.flash_attention_bwd.routes[route])
          == (before[0] + 1, before[1] + 1, before[2] + 1),
          f"K6 gradient {name}: one forward and one backward launch, "
          f"the backward on its {route} route")
    want = torch.autograd.grad(flash_attention_ref(q, k, v, causal),
                               (q, k, v), do)
    errs = []
    for what, a, b in zip(("dq", "dk", "dv"), got, want):
        check(a.dtype == dt, f"K6 gradient {name} {what}: dtype")
        torch.testing.assert_close(
            a.float(), b.float(), atol=TOL[dt], rtol=TOL[dt],
            msg=lambda m, n=name, w=what: f"K6 gradient {n} {w}: {m}")
        errs.append((a.float() - b.float()).abs().max().item())
    del want
    again = torch.autograd.grad(k6.flash_attention(q, k, v, causal),
                                (q, k, v), do)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K6 gradient {name}: two backward calls bit-equal")
    del again
    phase(f"{tag} K6 gradient {name} B={B} H={H} KH={KH} S={S} hd={hd} "
          f"{'causal' if causal else 'bidirectional'}, backward "
          f"kernels ({route} route): max_abs_err dq {errs[0]:.3e}, dk "
          f"{errs[1]:.3e}, dv {errs[2]:.3e} (tol {TOL[dt]:g}); a second "
          f"call bit-equal")
    twin = (check_k6_twin(k6, q, k, v, do, causal, got, name, tag)
            if route == "wgmma" else None)
    del got
    torch.cuda.empty_cache()
    return max(errs), twin


def check_k6_forward(k6, rng, name, dt, B, H, KH, S, hd, causal,
                     tag="[3]"):
    """Phases 3 and 24 (e): K6's forward, through the autograd Function
    the model calls, on the kernel ``ops.forward_route`` picks by dtype
    and hd, launched once, against its plain version at the dtype's
    ``TOL``, and bf16 within one ulp of it.  Returns the largest
    error."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    q, k, v = k6_inputs(rng, B, H, KH, S, hd, dt)
    route = k6.forward_route(dt, hd)
    before = k6.flash_attention.launches
    out = k6.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    check(k6.flash_attention.launches == before + 1,
          f"K6 {name}: the dispatcher launched the kernel once")
    check(bool(torch.isfinite(out.float()).all()), f"K6 {name}: finite")
    ref = flash_attention_ref(q, k, v, causal).float()
    torch.testing.assert_close(out.float(), ref, atol=TOL[dt], rtol=TOL[dt],
                               msg=lambda m, n=name: f"K6 {n}: {m}")
    tol = f"tol {TOL[dt]:g}"
    if dt == torch.bfloat16:
        torch.testing.assert_close(
            out.float(), ref, atol=BF16_ULP_ATOL, rtol=BF16_ULP_RTOL,
            msg=lambda m, n=name: f"K6 {n}, one bf16 ulp: {m}")
        tol += f" and one ulp: rtol 2^-7, atol {BF16_ULP_ATOL:g}"
    err = (out.float() - ref).abs().max().item()
    phase(f"{tag} K6 {name} B={B} H={H} KH={KH} S={S} hd={hd} "
          f"{'causal' if causal else 'bidirectional'}, {route} kernel: "
          f"max_abs_err {err:.3e}, max|ref| {ref.abs().max().item():.3e} "
          f"({tol})")
    return err


def check_k6(k6, rng):
    """Phase 3: K6, through the autograd Function the model calls,
    against its plain version, on each of its forward kernels
    (:func:`check_k6_forward`); then its backward kernels against
    autograd through the plain version, the wgmma route also against
    its walk (:func:`check_k6_twin`), and twice on the same inputs, each
    on the route ``ops.backward_route`` picks.  Returns the worst bf16
    forward error, the worst error of the backward's wgmma route, and
    its worst row-scaled reading against the walk with the smallest
    control's."""
    bf, f32 = torch.bfloat16, torch.float32
    worst, worst_bwd, row, ctrl = 0.0, 0.0, 0.0, float("inf")
    routes = dict(k6.flash_attention.routes)
    for case in (
            ("olmo-1b bf16", bf, 1, 16, 16, 2048, 128, True),
            ("llama3.2-1b bf16 (G=4)", bf, 1, 32, 8, 1024, 64, True),
            ("S=77 bf16 (ragged tile, G=2)", bf, 2, 4, 2, 77, 128, True),
            ("S=200 bf16 bidirectional", bf, 2, 4, 1, 200, 64, False),
            ("hd=16 bf16 bidirectional", bf, 2, 4, 1, 77, 16, False),
            ("smoke f32 (G=2)", f32, 2, 4, 2, 64, 16, True),
            ("S=200 f32 (ragged tile)", f32, 2, 4, 2, 200, 64, True),
            ("bidirectional f32", f32, 1, 4, 4, 300, 128, False)):
        err = check_k6_forward(k6, rng, *case)
        if case[1] == bf:
            worst = max(worst, err)
    ran = {r: n - routes[r] for r, n in k6.flash_attention.routes.items()}
    check(all(n > 0 for n in ran.values()),
          f"K6: every forward kernel launched ({ran})")
    # the backward kernels against the gradient of the plain version;
    # bf16 at hd 64 and 128 takes the wgmma route, hd 16 the mma.sync
    # kernels, float32 the FMA kernels (check_k6_grad)
    bwd_routes = dict(k6.flash_attention_bwd.routes)
    for case in (
            ("smoke f32", f32, 2, 4, 2, 64, 16, True),
            ("S=200 f32 bidirectional", f32, 2, 4, 2, 200, 64, False),
            ("S=1024 bf16", bf, 1, 16, 16, 1024, 128, True),
            ("olmo-1b S=2048 bf16", bf, 1, 16, 16, 2048, 128, True),
            ("olmo-1b B=4 S=2048 bf16 (the training shape)", bf, 4, 16, 16,
             2048, 128, True),
            ("llama3.2-1b S=1024 bf16 (G=4)", bf, 1, 32, 8, 1024, 64, True),
            ("S=77 bf16 (ragged tile, G=2)", bf, 2, 4, 2, 77, 128, True),
            ("S=200 bf16 bidirectional (G=4)", bf, 2, 4, 1, 200, 64, False),
            ("S=130 bf16 (a key tile past 128)", bf, 1, 2, 2, 130, 128,
             True),
            ("hd=16 bf16 bidirectional", bf, 2, 4, 1, 77, 16, False)):
        err, twin = check_k6_grad(k6, rng, *case)
        if twin is not None:
            worst_bwd = max(worst_bwd, err)
            row, ctrl = max(row, twin[0]), min(ctrl, twin[1])
    ran = {r: n - bwd_routes[r]
           for r, n in k6.flash_attention_bwd.routes.items()}
    check(all(n > 0 for n in ran.values()),
          f"K6: every backward route launched ({ran})")
    torch.cuda.empty_cache()
    return worst, worst_bwd, row, ctrl


def smoke_batches(cfg_smoke, seed):
    """The smoke trainer's ``TokenStream``: 4 sequences of 64 tokens."""
    from repro_torch.data.pipeline import DataConfig, TokenStream

    return TokenStream(DataConfig(vocab=cfg_smoke.vocab, seq_len=64,
                                  global_batch=4, seed=seed))


def rglru_fan_in(cfg, params):
    """In place, for a model with RG-LRU layers (recurrentgemma-2b):
    each normal-init leaf of the stacked ``groups`` rescaled from N(0,
    1) / sqrt(n_groups) to N(0, 1) / sqrt(its own layer's fan-in).
    ``init_params`` takes a leaf's first dimension as its fan-in, as the
    reference's ``init_tree`` does, and for a stacked leaf that is the
    stacking axis: recurrentgemma-2b's weights come out sqrt(2560 / 8)
    times too large, its RG-LRU gates saturate (a = 1, where ``1 -
    exp(2 log a)`` cancels) and the model is chaotic in float32 (a
    one-ulp change of every weight moves its full-width logits by the
    order of their scale on the card: ``tools/recurrent_probe.py``), so
    no float32 comparison can hold it.  Other models are returned as
    they are."""
    if "rglru" in cfg.pattern:
        own_fan_in(cfg, params, ("groups",))
    return params


def own_fan_in(cfg, params, stacks):
    """In place: each normal-init leaf of the stacked trees ``stacks``
    (``groups``, an encoder-decoder's ``encoder``) rescaled from N(0, 1)
    / sqrt(its stack's depth) to N(0, 1) / sqrt(its own layer's fan-in)
    (:func:`rglru_fan_in` says why).  Returns ``params``."""
    import math

    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.transformer import model_defs

    defs = model_defs(cfg)
    with torch.no_grad():
        for stack in stacks:
            for d, p in zip(tree_leaves(defs[stack]),
                            tree_leaves(params[stack])):
                if d.init == "normal":
                    p.mul_(math.sqrt(d.shape[0] / d.shape[1]))
    return params


def smoke_params(cfg_smoke, seed, device):
    """The smoke parameters, drawn on the CPU from ``seed``
    (:func:`rglru_fan_in`'s scale for RG-LRU models)."""
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import init_params

    return tree_map(lambda a: a.to(device), rglru_fan_in(
        cfg_smoke, init_params(cfg_smoke, seed=seed, device="cpu")))


def step0_grads(cfg_smoke, params, seed):
    """The gradients of the loss of the smoke trainer's first batch."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import loss_fn

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    device = leaves[0].device
    batch = {k: torch.from_numpy(a).to(device)
             for k, a in smoke_batches(cfg_smoke, seed).batch_at(0).items()}
    return torch.autograd.grad(loss_fn(cfg_smoke, params, batch), leaves)


def smoke_trainer(cfg_smoke, seed, device, n_steps, failure_at=None,
                  ckpt_dir=None):
    """The smoke trainer of ``launch/train.py`` on ``device`` from the
    same parameters and ``TokenStream`` batches: ``n_steps`` of
    ``build_step``, through ``FaultTolerantLoop`` when ``ckpt_dir`` is
    given.  Returns (losses by step, loop stats or None)."""
    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.launch.train import build_step
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault import FailureInjector, FaultTolerantLoop

    params = smoke_params(cfg_smoke, seed, device)
    stream = smoke_batches(cfg_smoke, seed)
    step_fn = build_step(cfg_smoke, adamw.AdamWConfig(warmup_steps=10,
                                                      decay_steps=n_steps))
    losses = {}

    def step(state, batch):
        i = int(state[1].step)
        state, metrics = step_fn(state, {
            k: torch.from_numpy(a).to(device) for k, a in batch.items()})
        losses[i] = float(metrics["loss"])
        return state

    state = (params, adamw.init(params), None)
    if ckpt_dir is None:
        for i in range(n_steps):
            state = step(state, stream.batch_at(i))
        return losses, None
    injector = (FailureInjector(fail_at={failure_at: RuntimeError(
        "injected")}) if failure_at is not None else None)
    loop = FaultTolerantLoop(step, stream.batch_at, Checkpointer(ckpt_dir),
                             save_every=2, injector=injector)
    loop.run(state, n_steps)
    return losses, loop.stats


def check_train_vs_cpu(cfg_smoke, seed):
    """Phase 4: training on the card against the CPU (every kernel
    wrapper there runs its plain version), f32.  Step 0's gradients:
    each leaf within 1e-4 of its scale, or within twice what a one-ulp
    change of every weight moves that leaf on the CPU itself, where
    float32's own noise on this batch is larger than 1e-4 (the
    embedding gradient sums many positions of the same frequent
    token)."""
    from repro_torch.models.layers import tree_map

    cpu_params = smoke_params(cfg_smoke, seed, "cpu")
    g_cpu = step0_grads(cfg_smoke, cpu_params, seed)
    g_card = step0_grads(cfg_smoke, smoke_params(cfg_smoke, seed, "cuda"),
                         seed)
    rng = np.random.RandomState(seed)
    nudged = tree_map(lambda a: torch.nextafter(a.detach(), torch.from_numpy(
        np.where(rng.rand(*a.shape) < 0.5, -np.inf, np.inf).astype(
            np.float32))), cpu_params)
    g_nudged = step0_grads(cfg_smoke, nudged, seed)
    worst, floor_max, loose = 0.0, 0.0, 0
    for a, b, c in zip(g_card, g_cpu, g_nudged):
        a, scale = a.cpu(), b.abs().max().item()
        floor = ((c - b).abs().max() / scale).item()
        tol = max(1e-4, 2 * floor)
        loose += tol > 1e-4
        torch.testing.assert_close(a, b, rtol=1e-4, atol=tol * scale,
                                   msg=lambda m: f"step 0 gradients: {m}")
        worst = max(worst, ((a - b).abs().max() / scale).item())
        floor_max = max(floor_max, floor)
    cpu, card = smoke_trainer(cfg_smoke, seed, "cpu", 3), smoke_trainer(
        cfg_smoke, seed, "cuda", 3)
    l_card, l_cpu = [card[0][i] for i in range(3)], [cpu[0][i]
                                                     for i in range(3)]
    check(all(np.isfinite(l_card)), "finite losses on the card")
    check(abs(l_card[0] - l_cpu[0]) <= 1e-4 * abs(l_cpu[0]),
          f"step 0 loss on the card == on the CPU ({l_card[0]}, "
          f"{l_cpu[0]})")
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-3,
                               err_msg="losses on the card vs the CPU")
    phase(f"[4] {cfg_smoke.name} training on the card == on the CPU: losses "
          f"{l_card} vs {l_cpu} (step 0 within 1e-4, later 1e-3 relative);"
          f" step 0 gradients within {worst:.2e} of each leaf's scale "
          f"(tol 1e-4; {loose} of {len(g_cpu)} leaves at twice their CPU "
          f"one-ulp noise floor, which reaches {floor_max:.2e})")


def check_train_loop(cfg_smoke, seed):
    """Phase 4: the smoke trainer through ``FaultTolerantLoop`` on the
    card, with a failure injected before step 3, against an
    uninterrupted run; the loop counts every exception as a restart, so
    the count is checked."""
    import shutil

    root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    try:
        clean = smoke_trainer(cfg_smoke, seed, "cuda", 5,
                              ckpt_dir=str(root / "clean"))
        failed = smoke_trainer(cfg_smoke, seed, "cuda", 5, failure_at=3,
                               ckpt_dir=str(root / "failed"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(clean[1].restarts == 0, f"uninterrupted run: no restart "
                                  f"({clean[1].restarts})")
    check(failed[1].restarts == 1 and failed[1].completed_steps == 5,
          f"one restart, five steps ({failed[1]})")
    check(sorted(failed[0]) == list(range(5)), "a loss for every step")
    diff = max(abs(failed[0][i] - clean[0][i]) for i in range(5))
    check(diff == 0.0, f"losses after the restart == the uninterrupted "
                       f"run's ({failed[0]} vs {clean[0]})")
    phase(f"[4] {cfg_smoke.name} trainer through FaultTolerantLoop on the "
          f"card, failure injected before step 3: {failed[1].restarts} "
          f"restart, restored from step 2, {failed[1].completed_steps} "
          f"steps; losses "
          f"{[failed[0][i] for i in range(5)]} == the uninterrupted run's")


def train_flops(cfg, batch, text):
    """Model flops of one training step of ``batch`` sequences of
    ``text`` tokens: 6 for each matmul parameter and each position it
    acts on (the input embedding is a lookup; the output head acts on
    the text positions alone, as ``model.py::loss_fn`` takes the loss;
    an encoder's layers and the decoder's cross-attention K and V on the
    encoder's frames; a mixture of experts' expert weights at top_k / E
    of their count, the products a token is routed through, its router
    whole; every other parameter on the decoder's positions, a VLM's
    image positions among them), and the attention products forward and
    backward, 12 B H hd a visible (query, key) pair: every attention
    layer of the decoder, causal, over the pairs inside its window
    (:func:`attention_pairs`), an encoder's bidirectional layers and the
    decoder's cross-attention over the frames.  Returns (flops, the
    decoder's positions a sequence)."""
    import math

    from repro_torch.configs.base import base_kind
    from repro_torch.models.transformer import model_defs

    encdec = cfg.arch_kind == "encdec"
    enc = cfg.enc_len if encdec else 0
    dec = text + (cfg.img_tokens if cfg.arch_kind == "vlm" else 0)
    routed = cfg.moe.top_k / cfg.moe.num_experts if cfg.moe else 1

    def walk(tree, path):
        for key, d in tree.items():
            if isinstance(d, dict):
                yield from walk(d, f"{path}/{key}")
            else:
                share = routed if "router" in tree and key != "router" else 1
                yield f"{path}/{key}", math.prod(d.shape) * share

    mm = 0
    for path, n in walk(model_defs(cfg), ""):
        on_frames = (path.startswith(("/encoder/", "/enc_final_norm/"))
                     or path.endswith(("/xattn/wk", "/xattn/wv")))
        mm += n * (0 if path == "/embed/tok" else
                   text if path == "/embed/lm_head" else
                   enc if on_frames else dec)
    pairs = sum(attention_pairs(dec, None if k == "global" else cfg.window)
                for k in map(base_kind, cfg.layer_kinds)
                if k in ("global", "local"))
    if encdec:
        pairs += cfg.enc_layers * enc * enc + cfg.n_layers * dec * enc
    attn = 12 * batch * cfg.n_heads * cfg.hd * pairs
    return int(6 * batch * mm) + attn, dec


def train_full_width(cfg, seed, counted, smi, batch=4, seq=2048, steps=5,
                     profile=False, tag="[12]", turns=True):
    """Phases 12, 22 (a), (c) and 24: ``cfg`` through ``build_step``
    (bf16 parameters from ``seed``, float32 AdamW mu, nu and master,
    remat on): a warm-up step, then ``steps`` steps with the kernels'
    launch counts zeroed just before and read just after.  A sequence
    is ``seq`` text tokens of the trainer's ``TokenStream``, after a
    VLM's image patch embeddings [img_tokens, d] or beside an
    encoder-decoder's frame embeddings [enc_len, d], both drawn on the
    card from ``seed`` (data loading is set-up).  K6 must launch twice
    an attention layer that ``attention_train`` runs on it a step
    (``attention.runs_flash``; the forward, and its recomputation under
    remat), causal in the decoder and bidirectional in an encoder, its
    backward once a layer, all on the route of the model's dtype and
    hd, and no other kernel (none at all where no layer runs K6: a
    windowed local layer attends in torch ops); one synchronizing call
    a step.  A mixture of experts meters its capacity drops in the
    counted steps (:func:`moe_drops`).  With ``turns`` (phase 12), the
    backward's bf16 routes in turns after the counted run; with
    ``profile``, two more steps under the profiler.  Returns the run's
    numbers."""
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.kernels.flash_attention import ops as k6
    from repro_torch.launch.train import build_step
    from repro_torch.models.attention import runs_flash
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import count_params, init_params
    from repro_torch.optim import adamw

    gc.collect()                    # earlier phases' engines and caches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda")
    state = (params, adamw.init(params), None)
    torch.cuda.synchronize()
    n_params = count_params(cfg)
    # the parameters and AdamW state the trainer holds (the step counter
    # a 4-byte int32 on the host), for phase 21's dry run
    opt = state[1]
    state_bytes = sum(t.numel() * t.element_size() for t in
                      tree_leaves(params) + [opt.step] + tree_leaves(opt.mu)
                      + tree_leaves(opt.nu) + tree_leaves(opt.master))
    tag = f"{tag} {cfg.name}"
    encdec = cfg.arch_kind == "encdec"
    rows = (cfg.enc_len if encdec else cfg.img_tokens
            if cfg.arch_kind == "vlm" else 0)
    name = "enc_embeds" if encdec else "img_embeds"
    inputs = (f", {name} [{batch}, {rows}, {cfg.d_model}] drawn on the card"
              if rows else "")
    phase(f"{tag} params: {n_params} ({cfg.dtype}; AdamW mu, nu and master "
          f"float32), init {time.perf_counter() - t0:.1f} s; batch {batch} "
          f"x {seq} tokens (one micro-batch){inputs}, {cfg.n_layers} "
          f"layers{f' + {cfg.enc_layers} encoder layers' if encdec else ''}")
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch, seed=0))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # data loading is set-up: every batch on the card before the steps
    batches = [{**{k: torch.from_numpy(a).cuda() for k, a in
                   stream.batch_at(i).items()},
                **({name: torch.randn(batch, rows, cfg.d_model,
                                      generator=gen, device="cuda")}
                   if rows else {})} for i in range(steps + 1)]
    step_fn = build_step(cfg, adamw.AdamWConfig(warmup_steps=10,
                                                decay_steps=steps + 1))
    state, m = step_fn(state, batches[0])           # warm-up, not counted
    losses = [float(m["loss"])]
    n_dec = sum(1 for k in cfg.layer_kinds if runs_flash(cfg, k))
    n_enc = cfg.enc_layers if encdec else 0
    route = k6.forward_route(cfg.tdtype, cfg.hd)
    masks = {"causal": n_dec, "bidirectional": n_enc}
    expected, n_bwd = 2 * (n_dec + n_enc), n_dec + n_enc
    kinds = {k: cfg.layer_kinds.count(k) for k in dict.fromkeys(
        cfg.layer_kinds)}
    window = f", window {cfg.window}" if cfg.window else ""
    enc = f", and {n_enc} encoder layers" if n_enc else ""
    phase(f"{tag}: K6 launches expected {expected} a step = "
          f"{n_dec + n_enc} layers on K6 ({n_dec} of the decoder's "
          f"{cfg.n_layers}: {kinds}{window}{enc}) x 2 (the forward, and its "
          f"recomputation in the backward pass: remat=True puts each "
          f"pattern group{' and encoder layer' if n_enc else ''} under "
          f"torch.utils.checkpoint), and {n_bwd} K6 backward launches, by "
          f"mask {masks} x (2, 1), all on the {route} route (bf16 at hd "
          f"{cfg.hd}){'; no kernel of K1-K6 at all' if not expected else ''}")
    # the main path's run: counts zeroed just before, read just after
    zero_counts(counted)
    syncs = []
    with moe_drops(cfg) as drops:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1, steps + 1):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    state, m = step_fn(state, batches[i])
                    losses.append(float(m["loss"]))  # the one read a step
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs.append([str(w.message).splitlines()[0] for w in caught
                          if "called a synchronizing" in str(w.message)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"{tag}: finite losses {losses}")
    k6_bwd = launches["K6 backward"]
    by = {what: (dict(counted[k].routes), dict(counted[k].masks))
          for what, k in (("forward", "K6"), ("backward", "K6 backward"))}
    check(launches["K6"] == expected * steps and k6_bwd == n_bwd * steps
          and sum(launches.values()) == launches["K6"] + k6_bwd,
          f"{tag}: K6 launched {expected} times a step, its backward "
          f"{n_bwd} times, and no other kernel ran ({launches}, {steps} "
          f"steps)")
    for what, (routes, got) in by.items():
        n = 2 * steps if what == "forward" else steps
        check(routes[route] == sum(routes.values())
              and got == {k: n * v for k, v in masks.items()},
              f"{tag}: every K6 {what} launch on the {route} route, "
              f"{n} x {masks} by mask ({routes}, {got})")
    check(all(len(s) == 1 for s in syncs),
          f"{tag}: one device-to-host transfer a step (the loss): {syncs}")
    ms = 1e3 * wall / steps
    tokens = batch * seq
    flops, positions = train_flops(cfg, batch, seq)
    if drops:
        n_moe = sum(1 for k in cfg.layer_kinds if k.endswith("_moe"))
        pairs = n_moe * batch * positions * cfg.moe.top_k * steps
        check(drops["dropped"] + drops["kept"] == pairs,
              f"{tag}: every (token, expert) assignment of the counted "
              f"steps metered once, kept or dropped ({drops}, {pairs})")
        drops = {"dropped": drops["dropped"], "assignments": pairs,
                 "capacity_factor": cfg.moe.capacity_factor}
        phase(f"{tag}: capacity drops in the {steps} counted steps at "
              f"capacity factor {cfg.moe.capacity_factor:g} (capacity "
              f"ceil(top_k S / E cf) a row per expert): {drops['dropped']} "
              f"of {pairs} (token, expert) assignments "
              f"({drops['dropped'] / pairs:.4%}), {n_moe} MoE layers")
    mfu = flops / (ms / 1e3) / PEAK_OPS[torch.bfloat16]
    phase(f"{tag}: losses {losses} (the first the warm-up step's); K6 "
          f"launches {launches['K6']} = {expected} x {steps} steps, K6 "
          f"backward {k6_bwd} = {n_bwd} x {steps} (forward by route and "
          f"mask {by['forward']}, backward {by['backward']}), other "
          f"kernels {sum(launches.values()) - launches['K6'] - k6_bwd}; "
          f"synchronizing calls a step under sync-debug mode: "
          f"{[len(s) for s in syncs]} {syncs[0]}")
    where = (f" ({positions} positions a sequence, {cfg.img_tokens} of them "
             f"image positions)" if positions != seq else
             f" (beside {cfg.enc_len} frames a sequence)" if encdec else "")
    phase(f"{tag} on {smi}: {ms:.1f} ms a step, {tokens / (ms / 1e3):.0f} "
          f"{'text ' if rows else ''}tokens/s{where}, peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated; "
          f"{held / 2**30:.2f} GiB held before the phase; the card "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} "
          f"GiB), model flops {flops:.4e} a step (6 N_matmul positions + "
          f"attention: train_flops), {100 * mfu:.1f}% of the card's 989 "
          f"TFLOP/s bf16 peak")
    turns_ms = []
    if turns:
        # the backward on each of its bf16 routes in turns (wgmma, mma,
        # mma, wgmma), ``steps`` steps a turn, after the counted run: the
        # step's share of the kernel's gain, read on one card
        backward_route = k6.backward_route
        try:
            for r in ("wgmma", "mma", "mma", "wgmma"):
                k6.backward_route = lambda dtype, hd, r=r: r
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(1, steps + 1):
                    state, m = step_fn(state, batches[i])
                    check(np.isfinite(float(m["loss"])),
                          f"{tag} ({r} backward): finite loss")
                turns_ms.append(1e3 * (time.perf_counter() - t0) / steps)
        finally:
            k6.backward_route = backward_route
        ab = {"wgmma": (turns_ms[0] + turns_ms[3]) / 2,
              "mma": (turns_ms[1] + turns_ms[2]) / 2}
        phase(f"{tag} on {smi}, the backward's routes in turns wgmma, mma, "
              f"mma, wgmma ({steps} steps each): "
              f"{', '.join(f'{t:.1f}' for t in turns_ms)} ms a step; wgmma "
              f"{ab['wgmma']:.1f}, mma {ab['mma']:.1f}, difference "
              f"{ab['mma'] - ab['wgmma']:.1f} ms a step")
    if profile:
        def run():
            nonlocal state
            for i in (1, 2):
                state, m = step_fn(state, batches[i])
                float(m["loss"])
            return 2

        profiled(run, f"{tag} [p]")
    del state, params, batches, opt
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches["K6"], bwd_launches=k6_bwd, steps=steps,
                ms=ms, mfu=mfu, turns_ms=turns_ms, flops=flops,
                tok_s=tokens / (ms / 1e3), peak=peak, held=held,
                losses=losses, state_bytes=state_bytes, batch=batch,
                seq=seq, positions=positions, n_layers=cfg.n_layers,
                by_route_and_mask=by, n_params=n_params, drops=drops,
                k6_layers=n_dec + n_enc)


@contextlib.contextmanager
def moe_drops(cfg):
    """Phase 24: while open, every ``moe_apply`` of a forward pass also
    meters its capacity drops (``metered=True``, the reference's meters:
    the same output) into counters on the card, read once at the end;
    remat's recomputation, which runs inside the backward pass, is not
    metered again.  Yields {} for a model without experts, else a dict
    that holds, after the block, the (token, expert) assignments of
    valid tokens dropped past an expert's capacity and those kept."""
    if cfg.moe is None:
        yield {}
        return
    from repro_torch.models import moe as moe_mod

    plain = moe_mod.moe_apply
    acc = torch.zeros(2, dtype=torch.int64, device="cuda")

    def metered(*args, **kw):
        if torch._C._current_graph_task_id() != -1:    # in the backward
            return plain(*args, **kw)
        out, dropped, routed = plain(*args, **kw, metered=True)
        acc[0] += dropped.sum()
        acc[1] += routed.sum()
        return out

    out = {}
    moe_mod.moe_apply = metered
    try:
        yield out
    finally:
        moe_mod.moe_apply = plain
    out.update(zip(("dropped", "kept"), acc.tolist()))


def attention_pairs(S, window):
    """(query, key) pairs a causal layer of window ``window`` (None:
    global) attends over in an S-token sequence."""
    W = min(window or S, S)
    return W * (W + 1) // 2 + (S - W) * W


def train_recurrent_full_width(tag, cfg, seed, counted, smi, batch=4,
                               seq=2048, steps=5, profile=False):
    """Phase 18 (a), (b): a recurrent decoder at full depth and width
    through ``build_step`` (bf16 parameters, float32 AdamW mu, nu and
    master, remat on): a warm-up step, then ``steps`` counted steps.
    Its SSD and RG-LRU layers train through their full-sequence forms
    in torch ops, as the reference trains them in jnp, and its local
    layers through the plain sliding-window form: no kernel of K1-K6
    may launch.  One device-to-host transfer a step (the loss).  With
    ``profile`` (phase 18 (c)), two more steps under the profiler.
    Weights from ``seed`` at :func:`rglru_fan_in`'s scale.  Returns the
    run's numbers."""
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.launch.train import build_step
    from repro_torch.models.model import count_params, init_params
    from repro_torch.optim import adamw

    gc.collect()                    # earlier phases' engines and caches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = rglru_fan_in(cfg, init_params(cfg, seed=seed, device="cuda"))
    state = (params, adamw.init(params), None)
    torch.cuda.synchronize()
    n_params = count_params(cfg)
    kinds = {k: cfg.layer_kinds.count(k) for k in sorted(set(
        cfg.layer_kinds))}
    tag = f"{tag} {cfg.name}"
    phase(f"{tag} params: {n_params} ({cfg.dtype}; AdamW mu, nu and master "
          f"float32), init {time.perf_counter() - t0:.1f} s; layers "
          f"{kinds} ({cfg.n_groups} groups of {cfg.pattern} under remat, "
          f"remainder {cfg.remainder}), d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}")
    step_fn = build_step(cfg, adamw.AdamWConfig(warmup_steps=10,
                                                decay_steps=steps + 1))
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch, seed=0))
    # data loading is set-up: every batch on the card before the steps
    batches = [{k: torch.from_numpy(a).cuda() for k, a in
                stream.batch_at(i).items()} for i in range(steps + 1)]
    state, m = step_fn(state, batches[0])           # warm-up, not counted
    losses = [float(m["loss"])]
    # the main path's run: counts zeroed just before, read just after
    zero_counts(counted)
    syncs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                state, m = step_fn(state, batches[i])
                losses.append(float(m["loss"]))     # the one read a step
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs.append([str(w.message).splitlines()[0] for w in caught
                      if "called a synchronizing" in str(w.message)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    peak = torch.cuda.max_memory_allocated() - held
    check(all(np.isfinite(losses)), f"{tag}: finite losses {losses}")
    check(sum(launches.values()) == 0,
          f"{tag}: no kernel of K1-K6 launched in training ({launches})")
    check(all(len(s) == 1 for s in syncs),
          f"{tag}: one device-to-host transfer a step (the loss): {syncs}")
    ms = 1e3 * wall / steps
    tokens = batch * seq
    # 6 N per token for the matmul parameters (the input embedding is a
    # lookup), and the local layers' attention products forward and
    # backward (12 B H hd flop a (query, key) pair); the SSD's and the
    # RG-LRU's own products, scans and gates are not counted
    n_mm = n_params - cfg.vocab * cfg.d_model
    n_attn = sum(1 for k in cfg.layer_kinds if k in ("local", "global"))
    attn = (12 * batch * cfg.n_heads * cfg.hd * n_attn
            * attention_pairs(seq, cfg.window))
    flops = 6 * n_mm * tokens + attn
    mfu = flops / (ms / 1e3) / PEAK_OPS[torch.bfloat16]
    phase(f"{tag}: losses {losses} (the first the warm-up step's); "
          f"kernel launches {launches}; synchronizing calls a step under "
          f"sync-debug mode: {[len(s) for s in syncs]} {syncs[0]}")
    phase(f"{tag} on {smi}: batch {batch} x {seq} tokens, {ms:.1f} ms a "
          f"step, {tokens / (ms / 1e3):.0f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated, less the "
          f"{held / 2**30:.2f} GiB held before the phase), model flops "
          f"{flops:.4e} a step (6 N_matmul tokens, N_matmul {n_mm}, + "
          f"{attn:.4e} of attention; the SSD and RG-LRU scans, gates and "
          f"in-chunk products not counted), {100 * mfu:.1f}% of the "
          f"card's 989 TFLOP/s bf16 peak")
    if profile:
        def run():
            nonlocal state
            for i in (1, 2):
                state, m = step_fn(state, batches[i])
                float(m["loss"])
            return 2

        profiled(run, f"[18c] {cfg.name}")
    del state, params, batches
    torch.cuda.empty_cache()
    return dict(batch=batch, seq=seq, steps=steps, ms=ms, mfu=mfu,
                tok_s=tokens / (ms / 1e3), peak=peak, losses=losses,
                flops=flops)


#: phase 18 (d): the largest |prefill + decode logit - one-shot logit|
#: allowed, relative to the one-shot logits' largest magnitude.  Both
#: sides are float32 sums of the same products in other orders (the
#: full-sequence scans, then a recurrence a token at a step, against
#: the full-sequence scans over all the tokens), so they differ by the
#: rounding the depth carries.  A one-ulp change of every weight moves
#: recurrentgemma's smoke logits by 5e-5 to 5e-4 of their scale
#: (tests/test_torch_recurrent.py::test_float32_noise_floor): the bound
#: is the smallest power of ten above twice that.  The card's own
#: one-ulp floor at full width is measured and printed beside it.
PREFILL_TOL = 1e-3


def prefill_full_width(tag, tengine, counted, cfg, seed, n_prompts,
                       prompt_len, smi, n_decode=16, chunk=64,
                       device="cuda", stacks=None):
    """Phase 18 (d), and 19 (d) for phi-3-vision's text-only prompts: the
    prefill path at full width in float32: ``prefill`` of ``n_prompts``
    random prompts of ``prompt_len`` tokens, ``load_prefill`` into an
    empty decode state of dp 1 and one slot a prompt, then ``n_decode``
    greedy ``decode_step``s.  Held against the one-shot
    ``forward_train`` logits of the same tokens (within ``PREFILL_TOL``
    of their scale) and against the ``ServingEngine``'s greedy streams
    of the same prompts (chunked prefill through K1, K4 and K5):
    identical, or first different at a near-tie (top-2 gap within 1e-4
    of the logit scale).  The decode steps launch the recurrent kernel
    (K4, K5) or K2 once a layer a step and no other kernel; the prefill
    K6 once a global layer.  Every class is empty after the slots are
    freed.  Weights from ``seed`` at :func:`rglru_fan_in`'s scale, or
    with the stacked trees ``stacks`` at each layer's own fan-in
    (:func:`own_fan_in`)."""
    import types

    from repro_torch.core import classed_pool
    from repro_torch.models.decode_init import (empty_decode_state,
                                                load_prefill)
    from repro_torch.models.layers import logits_apply, tree_leaves
    from repro_torch.models.model import decode_step, init_params, prefill
    from repro_torch.models.transformer import forward_train

    c32 = dataclasses.replace(cfg, dtype="float32")
    tag = f"{tag} {cfg.name}"
    params = init_params(c32, seed=seed, device=device)
    params = (rglru_fan_in(c32, params) if stacks is None
              else own_fan_in(c32, params, stacks))
    rng = np.random.RandomState(seed + 18)
    prompts = rng.randint(1, c32.vocab, (n_prompts, prompt_len))
    toks = torch.from_numpy(prompts.astype(np.int32)).to(device)
    psz = c32.page_size
    max_len = -(-(prompt_len + n_decode + 1) // 512) * 512
    kernel = {"ssd": "K4", "rglru": "K5", "global": "K2"}
    n_rec = {k: sum(1 for x in c32.layer_kinds if x == b)
             for b, k in kernel.items()}
    phase(f"{tag}: f32, {n_prompts} prompts of {prompt_len} tokens, "
          f"{n_decode} greedy decode steps, max_len {max_len}, window "
          f"{c32.window}, page size {psz}")

    zero_counts(counted)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(c32, params, {"tokens": toks})
    t_prefill = time.perf_counter()
    state = empty_decode_state(c32, 1, n_prompts, max_len, device=device)
    state = load_prefill(c32, state, caches, prompt_len)
    del caches
    out_logits = [logits]
    tok = logits.argmax(-1).to(torch.int32)
    stream = [tok]
    for _ in range(n_decode):
        lg, state = decode_step(c32, params, tok[None], state)
        out_logits.append(lg[0])
        tok = lg[0].argmax(-1).to(torch.int32)
        stream.append(tok)
    streams = torch.stack(stream, 1).tolist()         # [B, n_decode + 1]
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    want = {k: n * n_decode for k, n in n_rec.items() if n}
    if n_rec["K2"]:
        want["K6"] = n_rec["K2"]
    check(all(launches[k] == n for k, n in want.items())
          and sum(launches.values()) == sum(want.values()),
          f"{tag}: the decode steps launched {want} but K6, the prefill "
          f"K6 once a global layer ({launches})")
    check(all(0 <= t < c32.vocab for s in streams for t in s),
          f"{tag}: tokens inside the vocabulary")

    # against the one-shot forward of the prompts and the streams
    full = torch.cat([toks, torch.tensor(streams, dtype=torch.int32,
                                         device=device)[:, :n_decode]], 1)
    with torch.no_grad():
        x = forward_train(c32, params, full, remat=False)
        ref = logits_apply(c32, params["embed"], x[:, prompt_len - 1:])
    got = torch.stack(out_logits, 1)
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item() / scale
    check(np.isfinite(err) and err <= PREFILL_TOL,
          f"{tag}: prefill + decode logits within {PREFILL_TOL} of the "
          f"one-shot forward's scale ({err:.3e})")
    # the prefill path's pages and state released: every class empty
    state, _ = tengine._release_slots(
        state, torch.ones((1, n_prompts), dtype=torch.bool, device=device))
    live = [int(classed_pool.live_per_shard(state.pool, c).sum())
            for c in range(len(state.pool.classes))]
    check(not any(live), f"{tag}: every class empty after the prefill "
                         f"path's slots are freed ({live})")
    del state

    # against the engine's greedy streams of the same prompts
    eng = tengine.ServingEngine(c32, params, dp=1, b_local=n_prompts,
                                max_len=max_len, chunk_size=chunk,
                                size_classes=2, device=device)
    reqs = [tengine.Request(i, prompt=list(map(int, p)),
                            max_new_tokens=n_decode + 1)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=10_000)
    check(all(r.done for r in reqs), f"{tag}: every engine request done")
    in_use = [eng.blocks_in_use(c) for c in range(eng.n_classes)]
    check(not any(in_use) and eng.leak_free(),
          f"{tag}: every class of the engine empty after the drain "
          f"({in_use})")
    del eng
    mine = [types.SimpleNamespace(rid=i, out_tokens=s, temperature=0.0)
            for i, s in enumerate(streams)]
    same, ties = check_streams(tag, c32, params, device, reqs, mine, 1e-4)

    # the float32 noise floor: every weight one ulp up or down (the last
    # use of these weights)
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for p in tree_leaves(params):
            up = torch.rand(p.shape, generator=g, device=device) < 0.5
            p.copy_(torch.nextafter(p, torch.where(up, torch.inf,
                                                   -torch.inf)))
        x = forward_train(c32, params, full, remat=False)
        nudged = logits_apply(c32, params["embed"], x[:, prompt_len - 1:])
    floor = (nudged - ref).abs().max().item() / scale
    del x, nudged, ref, got, params
    if device == "cuda":
        torch.cuda.empty_cache()
    phase(f"{tag} on {smi}: prefill {1e3 * (t_prefill - t0):.1f} ms, "
          f"prefill + load + {n_decode} decode steps {1e3 * wall:.1f} ms; "
          f"kernel launches {launches}; logits against the one-shot "
          f"forward: max abs error {err:.3e} of their scale {scale:.3e} "
          f"(bound {PREFILL_TOL}; a one-ulp change of every weight moves "
          f"the one-shot logits by {floor:.3e} of it)")
    chunk_kernels = "/".join(k for k, n in n_rec.items() if n).replace(
        "K2", "K1")
    phase(f"{tag}: prefill path == ServingEngine (chunk {chunk}, "
          f"{chunk_kernels} prefill, two size classes): {same} of "
          f"{n_prompts} greedy "
          f"streams of {n_decode + 1} tokens identical, {ties} first "
          f"different at a near-tie (1e-4); every class empty after the "
          f"slots are freed, on both")
    return dict(err=err, floor=floor, same=same, ties=ties, wall=wall)


def time_k6(k6, rng, H, KH, hd, B=4, S=2048, causal=True, fwd=True,
            present="mma"):
    """Phases 13 and 22 (f): K6's backward kernels (and with ``fwd`` its
    forward) at one shape (bf16, q and k strided views as the training
    step passes them), each beside its bound, its plain version and the
    library call (SDPA, causal or not; its backward through
    ``torch.autograd.grad``).  Four sets of inputs cycle, so each call
    reads its inputs from HBM as a layer of the step does.  ``present``:
    the backward route the default one replaced, timed on the same
    inputs in turns (default, present, present, default)."""
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref)

    gen = torch.Generator(device="cuda").manual_seed(int(rng.randint(2**31)))
    f = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=gen, device="cuda").to(torch.bfloat16)
    sets = [(f(B, S, H, hd).transpose(1, 2), f(B, S, KH, hd).transpose(1, 2),
             f(B, KH, S, hd)) for _ in range(4)]
    it = iter(range(10 ** 9))
    sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention,
                             is_causal=causal, enable_gqa=KH != H)

    def kern():
        k6.flash_attention_cuda(*sets[next(it) % 4], causal)

    def ref():
        flash_attention_fwd_ref(*sets[next(it) % 4], causal)

    def lib():
        sdpa(*sets[next(it) % 4])

    saved = []
    for q, k, v in sets:
        o, lse = k6.flash_attention_cuda(q, k, v, causal)
        saved.append((q, k, v, o, lse, torch.randn_like(o)))

    def bwd():
        k6.flash_attention_bwd_cuda(*saved[next(it) % 4], causal)

    def bwd_present():
        # the kernels the default route replaced, same inputs
        k6.flash_attention_bwd_cuda(*saved[next(it) % 4], causal, present)

    def bwd_ref():
        flash_attention_bwd_ref(*saved[next(it) % 4], causal)

    # SDPA's backward alone: its graph kept, the gradient asked again
    graphs = []
    for q, k, v in sets[:2]:
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        o = sdpa(q, k, v)
        graphs.append((o, (q, k, v), torch.randn_like(o)))

    def bwd_lib():
        torch.autograd.grad(*graphs[next(it) % 2], retain_graph=True)

    out, q, k = {}, sets[0][0], sets[0][1]
    timed = [("bwd", bwd, bwd_ref, bwd_lib, k6.bound_bytes_bwd(q, k),
              k6.flops_bwd(q, causal))]
    if fwd:
        timed.insert(0, ("fwd", kern, ref, lib, k6.bound_bytes(q, k),
                         k6.flops(q, causal)))
    for name, fn, plain, library, nbytes, nflops in timed:
        if name == "bwd" and present is not None:
            # the backward's two routes in turns: default, present,
            # present, default
            turns = [cuda_ms(g, iters=16) for g in (fn, bwd_present,
                                                     bwd_present, fn)]
            ms, host_ms = (sum(x) / 2 for x in zip(turns[0], turns[3]))
            out["present"] = {
                "present_ms": (turns[1][0] + turns[2][0]) / 2,
                "present_host_ms": (turns[1][1] + turns[2][1]) / 2,
                "turns_ms": [t[0] for t in turns]}
        else:
            ms, host_ms = cuda_ms(fn, iters=32 if name == "fwd" else 16)
        plain_ms, _ = cuda_ms(plain, iters=4, warmup=1)
        library_ms, _ = cuda_ms(library, iters=32 if name == "fwd" else 16)
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * nflops / PEAK_OPS[torch.bfloat16]
        out[name] = dict(ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                         library_ms=library_ms,
                         bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms
                         else "operations", bytes=nbytes, flops=nflops)
    out["bwd"].update(out.pop("present", {}))
    del sets, saved, graphs
    torch.cuda.empty_cache()
    return dict(B=B, S=S, H=H, KH=KH, hd=hd, causal=causal,
                shape=f"B={B} H={H} KH={KH} S={S} hd={hd} "
                      f"{'causal' if causal else 'bidirectional'} bf16",
                **out)


def moe_cfg(cfg, **kw):
    """``cfg`` with capacity factor 64, the reference's serving value
    (no assignment drops), and ``kw`` replaced."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=64.0), **kw)


def check_moe_engine_vs_cpu(tengine, seed):
    """Phase 4: expert-paged serving on the card against the same engine
    on the CPU, smoke mixtral-8x7b in f32, dp 1, 2 slots, a budget of
    one footprint (12 pages), footprints (0, 1) and (2, 3) alternating:
    LRU eviction churn and deferral.  Tokens, status rows, stats, pool
    leaves and expert tables must be identical; 0 misses and 0 drops;
    leak-free after ``flush_experts``."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import init_params
    from repro_torch.models.transformer import (EXPERT_PPE,
                                                expert_layer_slots)
    from repro_torch.serving.telemetry import FlightRecorder

    cfg = moe_cfg(smoke_config(get_config("mixtral-8x7b")))
    budget = EXPERT_PPE * expert_layer_slots(cfg) * 2
    params = init_params(cfg, seed=seed, device="cpu")
    rng = np.random.RandomState(seed)
    prompts = [list(rng.randint(1, cfg.vocab, rng.randint(3, 20)))
               for _ in range(8)]
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = tengine.ServingEngine(
            cfg, tree_map(lambda a: a.to(dev), params), dp=1, b_local=2,
            max_len=64, chunk_size=8, prefix_sharing=False,
            expert_paging=True, expert_budget=budget, device=dev,
            flight=FlightRecorder(capacity=4096))
        reqs = [tengine.Request(i, prompt=p, max_new_tokens=5,
                                experts=(0, 1) if i % 2 == 0 else (2, 3))
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run(max_steps=500)
        check(all(r.done for r in reqs), f"mixtral smoke on {dev}: finished")
        runs[dev] = dict(
            tokens=[r.out_tokens for r in reqs],
            status=[rec["status"] for rec in eng.flight.ring],
            stats={k: v for k, v in eng.stats.items()
                   if k not in ("stragglers", "step_timeouts")},
            sched=dict(eng.scheduler.stats), pool=pool_state(eng),
            # a copy: flush_experts below changes the tables in place
            tables=[eng.state.expert_tables[p].to("cpu", copy=True)
                    for p in sorted(eng.state.expert_tables)],
            meters=[int(eng.telemetry.shard[k].sum()) for k in (
                "expert_miss_pages_c2", "moe_dropped_tokens")],
            flushed=eng.flush_experts(), empty=eng.leak_free())
        del eng
    a, b = runs["cpu"], runs["cuda"]
    differ = [k for k in ("tokens", "status", "stats", "sched", "flushed",
                          "meters") if a[k] != b[k]]
    differ += [k for k in ("pool", "tables")
               if not same_tensors(a[k], b[k])]
    check(not differ and a["empty"] and b["empty"]
          and b["meters"] == [0, 0],
          f"mixtral smoke expert paging: the card == the CPU (differ: "
          f"{differ}; drained empty {a['empty']}, {b['empty']}; misses "
          f"and drops {b['meters']})")
    st = b["stats"]
    check(st["expert_evictions"] > 0 and b["sched"]["defer_experts"] > 0,
          "mixtral smoke expert paging: evictions and deferrals")
    phase(f"[4] smoke mixtral-8x7b expert-paged (budget {budget} pages, "
          f"alternating footprints) on the card == on the CPU: "
          f"{len(b['status'])} steps, loads {st['expert_load_pages']} "
          f"pages, evictions {st['expert_evictions']}, deferrals "
          f"{b['sched']['defer_experts']}; identical tokens, status rows, "
          f"stats, pool leaves and expert tables; 0 misses, 0 drops, 0 "
          f"pages after flush_experts")


#: the two footprint mixes of phase 17 over mixtral's 8 experts: the
#: four disjoint pairs round robin, and 80% on pair (0, 1) with the rest
#: on the cold pairs (the reference bench's skewed and uniform mixes)
MOE_PAIRS = ((0, 1), (2, 3), (4, 5), (6, 7))


def moe_footprints(mix, n, seed):
    rng = np.random.RandomState(seed)
    if mix == "uniform":
        return [MOE_PAIRS[i % 4] for i in range(n)]
    return [MOE_PAIRS[0] if rng.random_sample() < 0.8
            else MOE_PAIRS[1 + rng.randint(3)] for _ in range(n)]


def moe_requests(tengine, cfg, seed, footprints):
    """Phase 5's workload over ``len(footprints)`` requests, each
    restricted to its footprint."""
    reqs = make_requests(tengine, cfg, seed, n=len(footprints))
    for r, fp in zip(reqs, footprints):
        r.experts = fp
    return reqs


def run_moe(tengine, counted, eng, reqs, schedule=None):
    """Serve ``reqs`` on ``eng`` to the end.  Without ``schedule`` every
    request is submitted at once and the admissions are recorded as
    [(steps before the admitting tick, rid)]; with it each request is
    submitted just before the tick that admitted it there, so the engine
    runs the recorded steps' exact batches.  Returns the run's numbers;
    no kernel of K1-K6 may launch."""
    admitted = []
    admit = eng.admit

    def record(req, match, shard):
        admitted.append((eng.stats["steps"], req.rid))
        return admit(req, match, shard)

    eng.admit = record
    by_rid = {r.rid: r for r in reqs}
    for fn in counted.values():
        fn.launches = 0
    steps0, transfers0 = eng.stats["steps"], eng.host_transfers
    tokens0 = eng.stats["tokens_out"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if schedule is None:
        for r in reqs:
            eng.submit(r)
    pending = list(schedule or [])
    while True:
        while pending and pending[0][0] == eng.stats["steps"] - steps0:
            eng.submit(by_rid[pending.pop(0)[1]])
        if eng.idle() and not pending:
            break
        check(eng.step(), "every step serves a request")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng.admit = admit
    steps = eng.stats["steps"] - steps0
    tokens = eng.stats["tokens_out"] - tokens0
    check(all(r.done for r in reqs), "every request finished")
    check(eng.host_transfers - transfers0 == steps,
          f"one transfer a step ({eng.host_transfers - transfers0}, "
          f"{steps})")
    check(sum(fn.launches for fn in counted.values()) == 0,
          "no kernel of K1-K6 on mixtral's path")
    return dict(tokens=[r.out_tokens for r in reqs], steps=steps,
                wall=wall, ms_step=1e3 * wall / steps,
                tok_s=tokens / wall,
                admitted=[(s - steps0, rid) for s, rid in admitted])


def profile_moe_steps(eng, tengine, cfg, fp):
    """Device ms of the expert gather and of the MoE products in one
    prefill step (8 lanes of 64 prompt tokens) and the decode step
    after it, on a warm paged engine: 8 requests of 128 prompt tokens
    restricted to ``fp`` are admitted (and ``fp`` loaded) in an
    unprofiled step, then the next two steps run under the profiler
    with the port's ``_gather_expert_pages`` and ``moe._experts`` inside
    ``record_function`` ranges, each call also between two CUDA events
    (the device time from the gather's or the products' first kernel
    to their last)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer

    rng = np.random.RandomState(17)
    reqs = [tengine.Request(10**6 + i, prompt=list(rng.randint(
        1, cfg.vocab, 128)), max_new_tokens=4, experts=fp) for i in range(8)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    originals = (transformer._gather_expert_pages, moe_mod._experts)
    events = {"expert_gather": [], "moe_products": []}

    def ranged(name, fn):
        def run(*a):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            with record_function(name):
                ev[0].record()
                y = fn(*a)
                ev[1].record()
            events[name].append(ev)
            return y
        return run

    out = {}
    transformer._gather_expert_pages = ranged("expert_gather", originals[0])
    moe_mod._experts = ranged("moe_products", originals[1])
    try:
        for name in ("prefill (T=64)", "decode (T=1)"):
            for v in events.values():
                v.clear()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                eng.step()
                torch.cuda.synchronize()
            ka = prof.key_averages()
            ev = {e.key: e for e in ka}
            # device kernels only: the ranges appear as device rows too
            kernels = sorted(
                (e for e in ka if e.device_type ==
                 torch.autograd.DeviceType.CUDA and e.key not in events),
                key=lambda e: -e.self_device_time_total)
            busy = sum(e.self_device_time_total for e in kernels)
            out[name] = {k: ev[k].device_time_total / 1e3 for k in events}
            out[name]["top"] = [(e.self_device_time_total / 1e3, e.count,
                                 e.key[:70]) for e in kernels[:6]]
            out[name]["launches"] = sum(e.count for e in kernels)
            out[name].update({f"{k} (events)": sum(
                a.elapsed_time(b) for a, b in v) for k, v in events.items()})
            out[name]["calls"] = len(events["expert_gather"])
            out[name]["all kernels"] = busy / 1e3
    finally:
        transformer._gather_expert_pages, moe_mod._experts = originals
    eng.run(max_steps=100)
    check(all(r.done for r in reqs), "profiled requests finished")
    return out


def serve_moe(tengine, counted, seed, smi, n_layers=8):
    """Phase 17: expert-paged MoE serving at mixtral-8x7b's full width
    (d_model 4096, 32 heads, 8 KV heads, hd 128, d_ff 14,336, 8 experts
    top-2, window 4096, vocab 32,000; bf16, random weights from
    ``seed``, capacity factor 64), depth cut from 32 to ``n_layers``
    layers: at 32 the experts alone are 90 GB, and the resident engine
    the identity check needs would not fit on the card.  dp 1, 8 slots,
    max_len 2048, chunk 64, two size classes resident and three paged
    (a third class implies expert paging); 24 requests of phase 5's
    shape under each footprint mix.  For each mix: the resident engine
    (all experts in HBM), then the paged engine at half of full
    residency, then the resident engine again submitting each request
    just before the step the paged engine admitted it on, so it runs the
    paged run's exact batches (bf16 products are bit-equal only at equal
    shapes, and the paged engine's expert deferrals change which
    requests share a step)."""
    from repro_torch.configs import get_config
    from repro_torch.core import classed_pool
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import init_params
    from repro_torch.models.transformer import (EXPERT_PPE,
                                                expert_layer_slots)

    cfg = moe_cfg(get_config("mixtral-8x7b"), n_layers=n_layers)
    b_local, max_len, chunk = 8, 2048, 64
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    E = cfg.moe.num_experts
    full = expert_layer_slots(cfg) * E * EXPERT_PPE
    budget = full // 2
    page_bytes = cfg.d_model * cfg.d_ff * 2
    phase(f"[17] {cfg.name} cut to {n_layers} layers: "
          f"{sum(p.numel() for p in tree_leaves(params))} parameters "
          f"({cfg.dtype}), init {time.perf_counter() - t0:.1f} s; an "
          f"expert page "
          f"{cfg.d_model * cfg.d_ff} elements ({page_bytes / 1e6:.1f} MB); "
          f"full residency {full} pages ({full * page_bytes / 1e9:.2f} GB), "
          f"budget {budget} pages + {3 * 2 * b_local} of lane stock "
          f"({(budget + 6 * b_local) * page_bytes / 1e9:.2f} GB in class 2)")

    def engine(paging):
        return tengine.ServingEngine(
            cfg, params, dp=1, b_local=b_local, max_len=max_len,
            chunk_size=chunk, size_classes=3 if paging else 2,
            expert_paging=paging, expert_budget=budget if paging else None,
            device="cuda")

    out = {}
    for mix in ("skewed", "uniform"):
        fps = moe_footprints(mix, 24, seed + 17)

        def reqs():
            return moe_requests(tengine, cfg, seed + 17, fps)

        eng = engine(False)
        check(eng.n_classes == 2 and not eng.expert_paging,
              "the resident engine: two classes, no expert plane")
        # warm-up: one short request per lane width (not counted)
        eng.submit(tengine.Request(-1, prompt=[1] * (chunk + 1),
                                   max_new_tokens=3, experts=MOE_PAIRS[0]))
        eng.run(max_steps=100)
        res = run_moe(tengine, counted, eng, reqs())
        del eng
        gc.collect()            # run_moe's admit hook: a cycle
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        eng = engine(True)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(eng.n_classes == 3 and eng.expert_budget == budget,
              "the paged engine: three classes at half residency")
        torch.cuda.reset_peak_memory_stats()
        paged = run_moe(tengine, counted, eng, reqs())
        st, sched = dict(eng.stats), dict(eng.scheduler.stats)
        meters = {k: int(eng.telemetry.shard[k].sum()) for k in (
            "expert_hit_pages_c2", "expert_miss_pages_c2",
            "expert_prefetch_pages_c2", "moe_dropped_tokens")}
        peak = st["expert_pages_resident_peak"]
        saved = 1 - peak / full
        hit = eng.telemetry.expert_hit_rate()
        check(meters["expert_miss_pages_c2"] == 0
              and meters["moe_dropped_tokens"] == 0,
              f"{mix}: 0 in-step misses and 0 dropped tokens ({meters})")
        check(peak <= budget, f"{mix}: resident peak {peak} <= {budget}")
        if mix == "uniform":
            check(st["expert_evictions"] > 0
                  and sched["defer_experts"] > 0,
                  f"uniform: evictions ({st['expert_evictions']}) and "
                  f"expert deferrals ({sched['defer_experts']})")
        else:
            check(saved >= 0.30, f"skewed: {saved:.1%} of peak expert HBM "
                                 f"saved against full residency (>= 30%)")
        prof = (profile_moe_steps(eng, tengine, cfg, MOE_PAIRS[0])
                if mix == "skewed" else None)
        # one cold footprint's load: 16 experts x 3 pages from the host
        load = None
        if mix == "uniform":
            eng.flush_experts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for pos, g in eng._elayer_slots:
                for e in MOE_PAIRS[1]:
                    eng._load_expert(0, pos, g, e)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            n = len(eng._elayer_slots) * 2 * EXPERT_PPE
            load = dict(pages=n, bytes=n * page_bytes, s=secs,
                        gbs=n * page_bytes / secs / 1e9)
        eng.flush_experts()
        conserved = all(
            int(classed_pool.free_per_shard(eng.state.pool, c)[0]
                + classed_pool.live_per_shard(eng.state.pool, c)[0])
            == classed_pool.pages_local(eng.state.pool, c)
            for c in range(eng.n_classes))
        check(eng.leak_free() and conserved
              and eng.expert_ledger.resident_count() == 0,
              f"{mix}: leak-free after drain and flush_experts, every "
              f"class conserved")
        mem = torch.cuda.max_memory_allocated()
        del eng
        gc.collect()
        torch.cuda.empty_cache()

        eng = engine(False)
        replay = run_moe(tengine, counted, eng, reqs(),
                         schedule=paged["admitted"])
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        check(replay["tokens"] == paged["tokens"],
              f"{mix}: paged streams == resident streams on the same "
              f"batches, bit for bit")
        same_free = sum(a == b for a, b in zip(res["tokens"],
                                               paged["tokens"]))
        phase(f"[17] {mix} mix on {smi}: resident {res['ms_step']:.2f} "
              f"ms/step, {res['tok_s']:.1f} generated tok/s ({res['steps']} "
              f"steps); paged {paged['ms_step']:.2f} ms/step, "
              f"{paged['tok_s']:.1f} tok/s ({paged['steps']} steps; engine "
              f"build with the host store {build_s:.1f} s); resident on "
              f"the paged run's batches {replay['ms_step']:.2f} ms/step, "
              f"{replay['tok_s']:.1f} tok/s")
        phase(f"[17] {mix}: paged == resident on the same batches on all "
              f"24 streams; {same_free} of 24 equal to the resident run "
              f"with its own batches; hit rate {hit:.4f}, loads "
              f"{st['expert_load_pages']} pages, evictions "
              f"{st['expert_evictions']}, resident peak {peak} of {full} "
              f"pages ({saved:.1%} saved), expert deferrals "
              f"{sched['defer_experts']}; meters {meters}; one transfer a "
              f"step; peak allocated {mem / 2**30:.1f} GiB; 0 pages in "
              f"every class after flush_experts")
        if prof is not None:
            for name, p in prof.items():
                phase(f"[17] profiled {name} step, paged, on {smi}: expert "
                      f"gather {p['expert_gather']:.3f} ms (CUDA events "
                      f"{p['expert_gather (events)']:.3f} ms), MoE products "
                      f"{p['moe_products']:.3f} ms (CUDA events "
                      f"{p['moe_products (events)']:.3f} ms) over "
                      f"{p['calls']} MoE layers; all kernels "
                      f"{p['all kernels']:.3f} ms (device), "
                      f"{p['launches']} launches")
                for ms, n, key in p["top"]:
                    phase(f"[17]   {ms:8.3f} ms {n:4d}x {key}")
        if load is not None:
            phase(f"[17] one cold footprint's load on {smi}: "
                  f"{load['pages']} pages, {load['bytes'] / 1e9:.2f} GB "
                  f"host (page-locked) to device in {load['s']:.3f} s, "
                  f"{load['gbs']:.1f} GB/s")
        out[mix] = dict(resident=res, paged=paged, replay=replay,
                        same_free=same_free, hit=hit, peak=peak,
                        saved=saved, stats=st, sched=sched, meters=meters,
                        prof=prof, load=load)
    del params
    out["host"] = release_pinned("[17]", smi)
    return out


def release_pinned(tag, smi):
    """Phase 17's end: the paged engines' host expert stores
    (``expert_pages.build_host_experts``, page-locked) outlive their
    tensors in PyTorch's caching host allocator, which keeps each freed
    pinned block (its size rounded up to a power of two: 22.55 GB to 32
    GiB at 8 layers) for reuse and never returns it by itself.  Collects
    the engines' reference cycles, then returns the cached blocks to
    the system (``torch._C._host_emptyCache``, as
    ``torch.cuda.graphs`` does).  Prints the process's VmRSS and the
    pinned bytes the allocator owns (held by live tensors and cached)
    before and after; fails if 1 GiB or more stays pinned, since that
    would be a store some reference still holds (the engines' other
    pinned tensors are a step's small staging copies).  Returns the
    readings."""
    gc.collect()
    torch.cuda.empty_cache()

    def read():
        return dict(rss=host_rss_bytes(), pinned=torch.cuda.host_memory_stats()
                    .get("allocated_bytes.current", 0))

    before = read()
    torch._C._host_emptyCache()
    after = read()
    check(after["pinned"] < 2**30,
          f"{tag} no expert store held after the phase: under 1 GiB of "
          f"pinned host memory left ({before}, {after})")
    phase(f"{tag} host memory on {smi}: VmRSS {before['rss'] / 1e9:.1f} GB "
          f"at the phase's end, the caching host allocator owning "
          f"{before['pinned'] / 2**30:.2f} GiB of pinned blocks with the "
          f"engines freed; after returning its cached blocks VmRSS "
          f"{after['rss'] / 1e9:.1f} GB, {after['pinned'] / 2**30:.2f} GiB "
          f"pinned")
    return dict(before=before, after=after)


# ------------------------------------------------------------ phase 19

def check_encdec_kernels(k6, ops, k3, plain, plain2, rng, b_local, maxp, P):
    """Phase 3, the kernels at phase 19's shapes: K6 at hd 96 (bf16 on
    its wgmma route over tiles padded to two 64-column atoms, and on the
    mma.sync instance it replaced, by explicit route, on the same
    inputs; float32 on FMAs) against the plain version, causal at S =
    640 (phi-3-vision's prefill: 576 image and 64 text positions), at a
    ragged S and bidirectional; bidirectional K6 at S = 1,500, hd 64
    (whisper-tiny's encoder) on its wgmma route; K1 at T = 1 and 64 at
    phi-3-vision's width (hd 96, G 1), bf16, pages of 64, on its wgmma
    route and on the fma kernel it replaced, and K2 there (contexts of
    97-1,088 tokens) on its tma route and on the fma kernel it replaced,
    against the plain version and K1 at T = 1, a row without keys zero;
    K3 asked for its wgmma route at hd 96 raises before any launch.
    bf16 within one ulp, f32 within 1e-4, two calls bit-equal.  Returns
    the worst bf16 errors at hd 96 of K6, K1 and K2 on their routes, and
    of the kernels their routes replaced ("K6 mma", "K1 fma", "K2
    fma")."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    bf, f32 = torch.bfloat16, torch.float32
    worst = {"K6": 0.0, "K1": 0.0, "K2": 0.0, "K6 mma": 0.0, "K1 fma": 0.0,
             "K2 fma": 0.0}

    def close(name, dt, out, ref):
        torch.testing.assert_close(out.float(), ref, atol=TOL[dt],
                                   rtol=TOL[dt],
                                   msg=lambda m: f"{name}: {m}")
        tol = f"tol {TOL[dt]:g}"
        if dt == bf:
            torch.testing.assert_close(
                out.float(), ref, atol=BF16_ULP_ATOL, rtol=BF16_ULP_RTOL,
                msg=lambda m: f"{name}, one bf16 ulp: {m}")
            tol += f" and one ulp: rtol 2^-7, atol {BF16_ULP_ATOL:g}"
        return (out.float() - ref).abs().max().item(), tol

    for name, dt, B, H, KH, S, hd, causal, route in (
            ("phi-3-vision prefill bf16", bf, 4, 32, 32, 640, 96, True,
             "wgmma"),
            ("hd=96 S=77 bf16 (ragged tile, G=2)", bf, 2, 4, 2, 77, 96, True,
             "wgmma"),
            ("hd=96 S=200 bf16 bidirectional (G=4)", bf, 2, 4, 1, 200, 96,
             False, "wgmma"),
            ("phi-3-vision prefill f32", f32, 4, 32, 32, 640, 96, True,
             "f32"),
            ("hd=96 S=77 f32 (ragged tile, G=2)", f32, 2, 4, 2, 77, 96, True,
             "f32"),
            ("hd=96 S=200 f32 bidirectional (G=4)", f32, 2, 4, 1, 200, 96,
             False, "f32"),
            ("whisper-tiny encoder bf16", bf, 8, 6, 6, 1500, 64, False,
             "wgmma")):
        q, k, v = k6_inputs(rng, B, H, KH, S, hd, dt)
        check(k6.forward_route(dt, hd) == route,
              f"K6 {name}: on the {route} route")
        before = (k6.flash_attention.launches,
                  k6.flash_attention.routes[route])
        out = k6.flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        check((k6.flash_attention.launches, k6.flash_attention.routes[route])
              == (before[0] + 1, before[1] + 1),
              f"K6 {name}: the dispatcher launched the {route} kernel once")
        check(torch.equal(out, k6.flash_attention_cuda(q, k, v, causal)[0]),
              f"K6 {name}: two calls bit-equal")
        check(bool(torch.isfinite(out.float()).all()), f"K6 {name}: finite")
        ref = flash_attention_ref(q, k, v, causal).float()
        err, tol = close(f"K6 {name}", dt, out, ref)
        phase(f"[3] K6 {name} B={B} H={H} KH={KH} S={S} hd={hd} "
              f"{'causal' if causal else 'bidirectional'}, {route} kernel: "
              f"max_abs_err {err:.3e}, max|ref| {ref.abs().max().item():.3e} "
              f"({tol}); two calls bit-equal")
        if dt == bf and hd == 96:
            worst["K6"] = max(worst["K6"], err)
            # the mma.sync instance the wgmma route replaced, same inputs
            old = k6.flash_attention_cuda(q, k, v, causal, route="mma")[0]
            torch.cuda.synchronize()
            check(torch.equal(old, k6.flash_attention_cuda(
                q, k, v, causal, route="mma")[0]),
                f"K6 {name}, mma: two calls bit-equal")
            e_old, _ = close(f"K6 {name}, mma", dt, old, ref)
            worst["K6 mma"] = max(worst["K6 mma"], e_old)
            phase(f"[3] K6 {name}, the mma.sync instance by explicit route "
                  f"on the same inputs: max_abs_err {e_old:.3e} ({tol}); "
                  f"two calls bit-equal")
            del old
        del q, k, v, out, ref
    phi = dict(H=32, KH=32, hd=96, psz=64, maxp=maxp, P=P)
    for T in (1, 64):
        args = attn_case(rng, b_local, T, dtype=bf, masked=(1,),
                         dead=((2, 0),), **phi)
        name = f"K1 phi-3-vision T={T} bf16"
        check(ops.chunk_route(bf, 96, 64, T, 1) == "wgmma",
              f"{name}: on the wgmma route")
        before = (ops.paged_attention_chunk.launches,
                  ops.paged_attention_chunk.routes["wgmma"])
        out = ops.paged_attention_chunk(*args)
        torch.cuda.synchronize()
        check((ops.paged_attention_chunk.launches,
               ops.paged_attention_chunk.routes["wgmma"])
              == (before[0] + 1, before[1] + 1),
              f"{name}: the dispatcher launched the wgmma kernel once")
        ref = plain(*args).float()
        errs = {}
        for route in ("wgmma", "fma"):
            got = out if route == "wgmma" else \
                ops.paged_attention_chunk_cuda(*args, route="fma")
            check(torch.equal(got, ops.paged_attention_chunk_cuda(
                *args, route=route)),
                f"{name}, {route}: two calls bit-equal")
            check(bool((got[1] == 0).all()),
                  f"{name}, {route}: all-masked row is zero")
            errs[route], tol = close(f"{name}, {route}", bf, got, ref)
        worst["K1"] = max(worst["K1"], errs["wgmma"])
        worst["K1 fma"] = max(worst["K1 fma"], errs["fma"])
        phase(f"[3] {name} B={b_local} H=32 hd=96 psz=64, wgmma kernel: "
              f"max_abs_err {errs['wgmma']:.3e}, max|ref| "
              f"{ref.abs().max().item():.3e} ({tol}); the fma kernel it "
              f"replaced on the same inputs {errs['fma']:.3e}; a dead "
              f"page skipped, two calls bit-equal on each")
    q, kp, vp, table, base = attn_case(
        rng, b_local, 1, dtype=bf, base=rng.randint(96, 1088, b_local),
        masked=(1,), dead=((2, 0),), **phi)
    q2, lens = q[:, 0].contiguous(), base + 1
    name = "K2 phi-3-vision bf16"
    check(ops.decode_route(bf, 96, 64, 1) == "tma", f"{name}: tma route")
    before = (ops.paged_attention.launches, ops.paged_attention.routes["tma"])
    out = ops.paged_attention(q2, kp, vp, table, lens, zero_empty=True)
    torch.cuda.synchronize()
    check((ops.paged_attention.launches, ops.paged_attention.routes["tma"])
          == (before[0] + 1, before[1] + 1),
          f"{name}: the dispatcher launched the tma kernel once")
    refs = (("plain", plain2(q2, kp, vp, table, lens,
                             zero_empty=True).float()),
            ("K1 T=1", ops.paged_attention_chunk(
                q, kp, vp, table, base)[:, 0].float()))
    errs = {}
    for route in ("tma", "fma"):
        # the fma kernel the tma route replaced, by explicit route, on the
        # same inputs
        got = out if route == "tma" else ops.paged_attention_cuda(
            q2, kp, vp, table, lens, True, "fma")
        torch.cuda.synchronize()
        check(torch.equal(got, ops.paged_attention_cuda(
            q2, kp, vp, table, lens, True, route)),
            f"{name}, {route}: two calls bit-equal")
        check(bool(torch.isfinite(got.float()).all()),
              f"{name}, {route}: finite")
        check(bool((got[1] == 0).all()),
              f"{name}, {route}: a row without keys is zero")
        for what, ref in refs:
            errs[route, what], tol = close(f"{name}, {route} vs {what}", bf,
                                           got, ref)
    worst["K2"] = errs["tma", "plain"]
    worst["K2 fma"] = errs["fma", "plain"]
    phase(f"[3] {name} B={b_local} H=32 hd=96 psz=64, tma kernel (tiles "
          f"padded to two 64-column atoms): max_abs_err vs plain "
          f"{errs['tma', 'plain']:.3e}, vs K1 at T=1 "
          f"{errs['tma', 'K1 T=1']:.3e}; the fma kernel it replaced on "
          f"the same inputs vs plain {errs['fma', 'plain']:.3e}, vs K1 "
          f"{errs['fma', 'K1 T=1']:.3e} ({tol}); contexts "
          f"{int(lens.min())}-{int(lens.max())}; a row without keys zero, "
          f"two calls bit-equal on each")
    # K3's wgmma route has no hd 96 instance: asked for it, the wrapper
    # raises before anything launches
    check(k3.verify_route(bf, 96, 64, 5, 1) == "fma",
          "K3 at phi-3-vision's width: on its fma route")
    counts = (k3.verify_attention.launches, dict(k3.verify_attention.routes))
    try:
        k3.verify_attention_cuda(q, kp, vp, table, base, route="wgmma")
    except ValueError as e:
        check("takes hd in" in str(e),
              f"K3 wgmma at hd 96 raised for its head dims ({e})")
    else:
        check(False, "K3 wgmma at hd 96 raised")
    check(counts == (k3.verify_attention.launches,
                     dict(k3.verify_attention.routes)),
          "K3 wgmma at hd 96: no launch counted")
    phase("[3] K3's wgmma route asked for at hd 96: raised before a launch, "
          "no launch counted; K3 at hd 96 on fma")
    torch.cuda.empty_cache()
    return worst


def time_k6_forward(k6, rng, B, H, KH, S, hd, causal=True, present=None):
    """K6's forward kernel at one shape (bf16, q and k strided views as
    the model passes them) beside its bound, its plain version and
    SDPA on the same inputs; four sets of inputs cycle, so each call
    reads its inputs from HBM.  ``present``: the route of the kernel
    the default route replaced, timed on the same inputs."""
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_fwd_ref

    sets = [k6_inputs(rng, B, H, KH, S, hd, torch.bfloat16)
            for _ in range(4)]
    it = iter(range(10 ** 9))

    def kern():
        k6.flash_attention_cuda(*sets[next(it) % 4], causal)

    def ref():
        flash_attention_fwd_ref(*sets[next(it) % 4], causal)

    def lib():
        torch.nn.functional.scaled_dot_product_attention(
            *sets[next(it) % 4], is_causal=causal, enable_gqa=KH != H)

    ms, host_ms = cuda_ms(kern, iters=32)
    plain_ms, _ = cuda_ms(ref, iters=4, warmup=1)
    library_ms, _ = cuda_ms(lib, iters=32)
    extra = {}
    if present is not None:
        extra["present_ms"], extra["present_host_ms"] = cuda_ms(
            lambda: k6.flash_attention_cuda(*sets[next(it) % 4], causal,
                                            route=present), iters=32)
    q, k, _ = sets[0]
    nbytes, nflops = k6.bound_bytes(q, k), k6.flops(q, causal)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * nflops / PEAK_OPS[torch.bfloat16]
    del sets
    torch.cuda.empty_cache()
    return dict(ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes, flops=nflops, route=k6.forward_route(
                    torch.bfloat16, hd),
                shape=f"B={B} H={H} KH={KH} S={S} hd={hd} "
                      f"{'causal' if causal else 'bidirectional'} bf16",
                **extra)


def extra_full_width(tag, tengine, counted, cfg, seed, n_prompts, text_len,
                     n_decode, smi, one_shot=False, stacks=(),
                     tol=PREFILL_TOL):
    """Phase 19 (a)-(c): the prefill path of an encoder-decoder or a VLM
    at full width in ``cfg``'s dtype.  ``prefill`` of ``n_prompts``
    random prompts of ``text_len`` tokens with the model's extra inputs
    drawn from ``seed`` (whisper-tiny: frame embeddings [B, enc_len, d]
    through the encoder; phi-3-vision: image patch embeddings [B,
    img_tokens, d] before the text), ``load_prefill`` into an empty
    state of dp 1, a slot a prompt, two size classes, then ``n_decode``
    greedy ``decode_step``s.  K6 runs once a global layer in the prefill
    (bidirectional in the encoder, causal in the decoder), K2 once a
    decoder layer a decode step, no other kernel.  With ``one_shot``
    (float32): every logit against the one-shot ``forward_train`` of the
    prompt and the stream with the same extra inputs, within
    ``tol`` (``PREFILL_TOL``) of their scale, the one-ulp floor printed
    beside.  Every class empty after the slots are freed.  ``stacks``
    names the stacked trees whose weights :func:`own_fan_in`
    rescales."""
    from repro_torch.core import classed_pool
    from repro_torch.kernels.flash_attention.ops import forward_route
    from repro_torch.kernels.paged_attention.ops import decode_route
    from repro_torch.models.decode_init import (empty_decode_state,
                                                load_prefill)
    from repro_torch.models.layers import logits_apply, tree_leaves
    from repro_torch.models.model import decode_step, init_params, prefill
    from repro_torch.models.transformer import (forward_train,
                                                state_blocks_per_slot)

    dev = "cuda"
    tag = f"{tag} {cfg.name}"
    t0 = time.perf_counter()
    params = own_fan_in(cfg, init_params(cfg, seed=seed, device=dev), stacks)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    t_init = time.perf_counter() - t0
    rng = np.random.RandomState(seed + 19)
    prompts = rng.randint(1, cfg.vocab, (n_prompts, text_len))
    toks = torch.from_numpy(prompts.astype(np.int32)).to(dev)
    encdec = cfg.arch_kind == "encdec"
    n_enc = cfg.enc_layers if encdec else 0
    img = 0 if encdec else cfg.img_tokens
    rows = cfg.enc_len if encdec else img
    extra = {"enc_embeds" if encdec else "img_embeds": torch.from_numpy(
        rng.randn(n_prompts, rows, cfg.d_model).astype(np.float32)).to(dev)}
    plen = img + text_len
    max_len = -(-(plen + n_decode + 1) // 512) * 512
    n_dec = cfg.n_layers
    inputs = (f"{cfg.enc_len} frames through {n_enc} bidirectional encoder "
              f"layers" if encdec else f"{img} image positions before the "
                                       f"text")
    scale_txt = (f", {' and '.join(stacks)} at each layer's own fan-in"
                 if stacks else "")
    phase(f"{tag}: {n_params} params ({cfg.dtype}{scale_txt}), init "
          f"{t_init:.1f} s; "
          f"{n_prompts} prompts of {text_len} tokens, {inputs}; "
          f"{n_decode} greedy decode steps, max_len {max_len}, "
          f"{state_blocks_per_slot(cfg, max_len)} CLS_STATE blocks a slot")

    zero_counts(counted)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(cfg, params, {"tokens": toks, **extra})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter()
    state = empty_decode_state(cfg, 1, n_prompts, max_len, size_classes=2,
                               device=dev)
    state = load_prefill(cfg, state, caches, plen)
    del caches
    torch.cuda.synchronize()
    t_load = time.perf_counter()
    out_logits = [logits]
    tok = logits.argmax(-1).to(torch.int32)
    stream = [tok]
    for _ in range(n_decode):
        lg, state = decode_step(cfg, params, tok[None], state)
        out_logits.append(lg[0])
        tok = lg[0].argmax(-1).to(torch.int32)
        stream.append(tok)
    streams = torch.stack(stream, 1)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {k: fn.launches for k, fn in counted.items()}
    k6_routes = dict(counted["K6"].routes)
    k6_masks = dict(counted["K6"].masks)
    k2_routes = dict(counted["K2"].routes)
    r6 = forward_route(cfg.tdtype, cfg.hd)
    r2 = decode_route(cfg.tdtype, cfg.hd, cfg.page_size,
                      cfg.n_heads // cfg.n_kv_heads)
    want = {"K6": n_enc + n_dec, "K2": n_dec * n_decode}
    check(all(launches[k] == want.get(k, 0) for k in launches),
          f"{tag}: the prefill launched K6 once a global layer, each decode "
          f"step K2 once a decoder layer, no other kernel ran ({launches}, "
          f"want {want})")
    check(k6_routes[r6] == want["K6"]
          and k6_masks == {"causal": n_dec, "bidirectional": n_enc},
          f"{tag}: K6 on its {r6} route, {n_enc} bidirectional and {n_dec} "
          f"causal launches ({k6_routes}, {k6_masks})")
    check(k2_routes[r2] == want["K2"],
          f"{tag}: K2 on its {r2} route ({k2_routes})")
    got = torch.stack(out_logits, 1).float()
    check(tuple(got.shape) == (n_prompts, n_decode + 1, cfg.vocab)
          and bool(torch.isfinite(got).all()),
          f"{tag}: finite logits of shape [B, steps, vocab]")
    tokens = streams.tolist()
    check(all(0 <= t < cfg.vocab for s in tokens for t in s),
          f"{tag}: tokens inside the vocabulary")
    if encdec:
        check(all(bool(t.abs().sum() > 0) for t in state.enc_kv)
              and tuple(state.enc_kv[0].shape) == (
                  n_dec, 1, n_prompts, cfg.enc_len, cfg.n_kv_heads, cfg.hd),
              f"{tag}: enc_kv loaded at [layers, DP, B_local, enc_len, KH, "
              f"hd]")
    err = floor = None
    if one_shot:
        full = torch.cat([toks, streams[:, :n_decode]], 1)
        with torch.no_grad():
            x = forward_train(cfg, params, full, extra, remat=False)
            ref = logits_apply(cfg, params["embed"],
                               x[:, plen - 1:]).float()
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item() / scale
    state, _ = tengine._release_slots(
        state, torch.ones((1, n_prompts), dtype=torch.bool, device=dev))
    live = [int(classed_pool.live_per_shard(state.pool, c).sum())
            for c in range(len(state.pool.classes))]
    check(not any(live), f"{tag}: every class empty after the prefill "
                         f"path's slots are freed ({live})")
    del state
    if one_shot:
        # the float32 noise floor: every weight one ulp up or down (the
        # last use of these weights)
        g = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            for p in tree_leaves(params):
                up = torch.rand(p.shape, generator=g, device=dev) < 0.5
                p.copy_(torch.nextafter(p, torch.where(up, torch.inf,
                                                       -torch.inf)))
            x = forward_train(cfg, params, full, extra, remat=False)
            nudged = logits_apply(cfg, params["embed"],
                                  x[:, plen - 1:]).float()
        floor = (nudged - ref).abs().max().item() / scale
        del x, nudged, ref
        phase(f"{tag}: logits against the one-shot forward: max abs error "
              f"{err:.3e} of their scale {scale:.3e}; a one-ulp change of "
              f"every weight moves the one-shot logits by {floor:.3e} of it")
        check(np.isfinite(err) and err <= tol,
              f"{tag}: prefill + decode logits within {tol} of the "
              f"one-shot forward's scale ({err:.3e})")
    del params, got, extra
    torch.cuda.empty_cache()
    ms_step = 1e3 * (t_end - t_load) / n_decode
    txt = ("" if err is None else
           f"; logits within {err:.3e} of the one-shot forward's scale "
           f"(bound {tol}; one-ulp floor {floor:.3e})")
    phase(f"{tag} on {smi}: prefill {1e3 * (t_prefill - t0):.1f} ms "
          f"({n_prompts * plen} positions), load_prefill "
          f"{1e3 * (t_load - t_prefill):.1f} ms, decode {ms_step:.2f} "
          f"ms/step ({n_prompts * n_decode / (t_end - t_load):.1f} "
          f"generated tok/s); K6 {k6_routes[r6]} launches on {r6} "
          f"({k6_masks}), K2 {k2_routes[r2]} on {r2}; every class empty "
          f"after the slots are freed{txt}")
    return dict(err=err, floor=floor, k6=launches["K6"], k6_route=r6,
                k2=launches["K2"], k2_route=r2, ms_step=ms_step,
                prefill_ms=1e3 * (t_prefill - t0))


def serve_encdec_vlm(tengine, k6, ops, plain, counted, seed, smi, b_local,
                     maxp, P, chunk=64):
    """Phase 19: encoder-decoder and VLM serving at full width,
    whisper-tiny and phi-3-vision-4.2b: (a) and (b) the prefill path in
    bf16, (c) in float32 against the one-shot forward, (d) the engine at
    full width in bf16 (whisper-tiny with two size classes, its slots
    holding the encoder's CLS_STATE grant) and phi-3-vision's text-only
    prompts through the prefill path against the engine in float32, (e)
    the times of K6 at hd 96 at phi-3-vision's prefill shape and of K1
    and K2 at its serving width, each beside the kernel its Hopper route
    replaced, on the same inputs.  Returns the numbers the kernels line
    reports."""
    from repro_torch.configs import get_config

    whisper, phi = get_config("whisper-tiny"), get_config("phi-3-vision-4.2b")
    f32 = {c.name: dataclasses.replace(c, dtype="float32")
           for c in (whisper, phi)}
    out = {"a": extra_full_width("[19a]", tengine, counted, whisper, seed, 8,
                                 32, 32, smi),
           "b": extra_full_width("[19b]", tengine, counted, phi, seed, 4, 64,
                                 16, smi)}
    check(out["b"]["k6_route"] == "wgmma" and out["b"]["k2_route"] == "tma",
          f"[19b] phi-3-vision: K6 on its wgmma route at hd 96, K2 on tma "
          f"({out['b']['k6_route']}, {out['b']['k2_route']})")
    out["c"] = {c.name: extra_full_width("[19c]", tengine, counted, c, seed,
                                         n, m, 16, smi, one_shot=True,
                                         stacks=stacks)
                for c, n, m, stacks in (
                    (f32["whisper-tiny"], 8, 32, ("groups", "encoder")),
                    (f32["phi-3-vision-4.2b"], 4, 64, ("groups",)))}
    out["d"] = {c.name: serve_full_width(
        "[19d]", tengine, counted, "K1", c, seed, b_local, 2048, chunk,
        make_requests(tengine, c, seed), size_classes=sc)
        for c, sc in ((whisper, 2), (phi, 1))}
    check(out["d"]["whisper-tiny"]["state_peak"] == b_local * 376,
          "[19d] whisper-tiny: the slots held 376 CLS_STATE blocks each at "
          "the peak")
    out["d_text"] = prefill_full_width("[19d]", tengine, counted, phi, seed,
                                       4, 512, smi, stacks=("groups",))
    for name, r in out["d"].items():
        # a printed figure, not a claim: the recorded run with K1 on its
        # fma kernel at hd 96 (PERF.md's kernel table)
        before = (", the recorded run with K1 on fma at hd 96: 62.55 "
                  "ms/step" if name == phi.name else "")
        phase(f"[19d] {name} engine on {smi}: {r['tok_s']:.1f} generated "
              f"tok/s, {r['ms_step']:.2f} ms/step{before}; K1 "
              f"{r['k1_routes']}, K2 {r['k2_routes']}, peak CLS_STATE "
              f"blocks in use {r['state_peak']}")
    # [19e] the hd 96 kernels' times at phi-3-vision's shapes
    rng = np.random.RandomState(seed + 190)
    t6 = time_k6_forward(k6, rng, 4, phi.n_heads, phi.n_kv_heads,
                         phi.img_tokens + 64, phi.hd, present="mma")
    phi8 = dataclasses.replace(phi, n_layers=8)
    base1 = rng.randint(64 + 32, 1024 + 64, b_local)
    base64 = rng.randint(0, 1024 - 64, b_local) // 64 * 64
    t1 = time_kernel(
        lambda *a: lambda: ops.paged_attention_chunk_cuda(*a, route="wgmma"),
        ops.bound_bytes, plain, rng, phi8, b_local, maxp, P, 64, base64,
        present=lambda *a: lambda: ops.paged_attention_chunk_cuda(
            *a, route="fma"))
    check(ops.decode_route(phi.tdtype, phi.hd, phi.page_size,
                           phi.n_heads // phi.n_kv_heads) == "tma",
          "[19e] K2 at phi-3-vision's width: on its tma route")
    t2 = time_kernel(
        k2_launcher(ops, "tma"),
        lambda q, kp, table, base: ops.decode_bound_bytes(
            q[:, 0], kp, table, base + 1),
        lambda q, kp, vp, table, base: ops.paged_attention_ref(
            q[:, 0], kp, vp, table, base + 1, zero_empty=True),
        rng, phi8, b_local, maxp, P, 1, base1,
        present=k2_launcher(ops, "fma"))
    for name, t, old in (
            ("K6 forward (wgmma, hd 96) " + t6["shape"], t6, "mma.sync"),
            (f"K1 (wgmma) T=64 B={b_local} H=32 hd=96 psz=64 bf16", t1,
             "fma"),
            (f"K2 (tma) T=1 B={b_local} H=32 hd=96 psz=64 bf16, "
             f"contexts {int(base1.min()) + 1}-{int(base1.max()) + 1}", t2,
             "fma")):
        present = (f", the {old} kernel it replaced on the same inputs "
                   f"{t['present_ms']:.4f} ms (host "
                   f"{t['present_host_ms']:.4f} ms a call)")
        phase(f"[19e] {name} on {smi}: kernel {t['ms']:.4f} ms (host "
              f"{t['host_ms']:.4f} ms a call){present}, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['flops']} flop, "
              f"{t['bytes']} B), plain {t['plain_ms']:.4f} ms, library "
              f"(SDPA) {t['library_ms']:.4f} ms")
    out["times"] = {"K6": t6, "K1": t1, "K2": t2}
    return out


# --------------------------------------------------- phase 20: DP ranks

def dp_smoke_run(tengine, cfg_smoke, seed, device, mesh=None):
    """Phase 20 (a): phase 4's f32 smoke workload through the olmo-1b
    smoke engine at dp 2 on ``device`` (one process, or a rank of
    ``mesh``).  Returns tokens, status rows and the integer state of the
    shards this process holds, on the CPU."""
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import init_params

    params = tree_map(lambda a: a.to(device),
                      init_params(cfg_smoke, seed=seed, device="cpu"))
    eng = tengine.ServingEngine(cfg_smoke, params, dp=2, b_local=2,
                                max_len=64, chunk_size=8, device=device,
                                mesh=mesh)
    rng = np.random.RandomState(seed)
    reqs = [tengine.Request(i, prompt=list(rng.randint(
        1, cfg_smoke.vocab, rng.randint(3, 30))), max_new_tokens=6)
        for i in range(9)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=500)
    return dict(tokens=[r.out_tokens for r in reqs],
                done=all(r.done for r in reqs), leak_free=eng.leak_free(),
                status=[rec["status"] for rec in eng.flight.ring],
                tables=eng.state.page_tables.cpu(),
                seq_lens=eng.state.seq_lens.cpu(), pool=pool_state(eng),
                steps=eng.stats["steps"], transfers=eng.host_transfers,
                collectives=eng.collectives)


def dp_full_run(tengine, counted, cfg, seed, b_local, max_len, chunk,
                mesh=None):
    """Phase 20 (b): olmo-1b at full width on phase 5's requests at dp 2,
    ``b_local`` slots a shard, in one process or as a rank of ``mesh``.
    The checks of phase 5 on the shards this process holds; returns the
    run's numbers and streams."""
    from repro_torch.core import classed_pool
    from repro_torch.core.classed_pool import CLS_KV
    from repro_torch.models.model import init_params

    params = init_params(cfg, seed=seed, device="cuda")
    eng = tengine.ServingEngine(cfg, params, dp=2, b_local=b_local,
                                max_len=max_len, chunk_size=chunk,
                                device="cuda" if mesh is None
                                else mesh.device, mesh=mesh)
    eng.submit(tengine.Request(10**6, prompt=[1] * (chunk + 1),
                               max_new_tokens=3))
    eng.run(max_steps=100)
    reqs = make_requests(tengine, cfg, seed)
    zero_counts(counted)
    steps0, transfers0 = eng.stats["steps"], eng.host_transfers
    colls0, tokens0 = eng.collectives, eng.stats["tokens_out"]
    width1_0 = eng.stats["chunk_hist"].get(1, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    steps = eng.stats["steps"] - steps0
    decode_steps = eng.stats["chunk_hist"].get(1, 0) - width1_0
    n_layers = sum(1 for k in cfg.layer_kinds if k == "global")
    in_use = eng.blocks_in_use()
    pool = eng.state.pool
    free = classed_pool.free_per_shard(pool, CLS_KV).cpu().tolist()
    live = classed_pool.live_per_shard(pool, CLS_KV).cpu().tolist()
    return dict(
        tokens=[r.out_tokens for r in reqs],
        prompts=[list(r.prompt) for r in reqs],
        done=all(r.done for r in reqs)
        and [len(r.out_tokens) for r in reqs]
        == [r.max_new_tokens for r in reqs],
        steps=steps, decode_steps=decode_steps, n_layers=n_layers,
        wall=wall, ms_step=1e3 * wall / steps,
        tok_s=(eng.stats["tokens_out"] - tokens0) / wall,
        launches=launches, k1_routes=dict(counted["K1"].routes),
        k2_routes=dict(counted["K2"].routes),
        transfers=eng.host_transfers - transfers0,
        collectives=eng.collectives - colls0,
        in_use=in_use, leak_free=eng.leak_free(),
        conserved=all(f + lv == eng.pages_local
                      for f, lv in zip(free, live)),
        margin=eng.telemetry.never_dry_margin_min(),
        host=eng.host_state(), pages_local=eng.pages_local)


def dp_f32_config(cfg):
    """Phase 20 (d): ``cfg`` in float32 at its full width, cut to two
    layers."""
    return dataclasses.replace(cfg, dtype="float32", n_layers=2)


#: phase 20 (f)'s fault schedule: a crash after the status gather, a torn
#: crash, and a step error after the last crash
F32_FAULTS = (("crash", 12, "post_sync", False),
              ("crash", 30, "dispatched", True),
              ("error", 45, "post_sync", False))


def dp_chaos_f32(tengine, counted, cfg, seed, b_local, max_len, chunk,
                 mesh=None):
    """Phase 20 (f): (d)'s float32 model and requests at dp 2 under
    ``F32_FAULTS``, in one process or as a rank of ``mesh``, each crash
    recovered through ``chaos.recover_engine``.  Returns the streams,
    the reconcile reports (of the rank's shard on a rank), launches,
    the lives' counts and the host state."""
    from repro_torch.models.model import init_params
    from repro_torch.serving import chaos

    params = init_params(cfg, seed=seed, device="cuda")
    journal = chaos.ServingJournal()
    injector = chaos.ServingFailureInjector(
        [chaos.Fault(step=n, phase=ph, kind=k, torn=torn)
         for k, n, ph, torn in F32_FAULTS])

    def build():
        return tengine.ServingEngine(
            cfg, params, dp=2, b_local=b_local, max_len=max_len,
            chunk_size=chunk, journal=journal, injector=injector,
            max_restarts=1, mesh=mesh,
            device="cuda" if mesh is None else mesh.device)

    reqs = make_requests(tengine, cfg, seed)
    zero_counts(counted)
    t0 = time.perf_counter()
    eng = build()
    for r in reqs:
        eng.submit(r)
    lives, reports = [], []
    while True:
        try:
            eng.run(max_steps=10_000)
            break
        except chaos.HostCrash:
            lives.append((eng.stats["steps"], eng.host_transfers,
                          eng.collectives))
            eng, report = chaos.recover_engine(build, eng, journal)
            reports.append({k: v for k, v in report.items()
                            if k != "requests"})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lives.append((eng.stats["steps"], eng.host_transfers, eng.collectives))
    outs = journal.outputs()
    return dict(
        tokens=[outs[r.rid] for r in reqs],
        drained=journal.finished() == {r.rid for r in reqs}
        and not journal.in_flight(),
        reports=reports, log=list(injector.log),
        recoveries=eng.stats["recoveries"], leak_free=eng.leak_free(),
        launches={k: fn.launches for k, fn in counted.items()},
        k1_routes=dict(counted["K1"].routes),
        k2_routes=dict(counted["K2"].routes),
        steps=sum(x[0] for x in lives), transfers=sum(x[1] for x in lives),
        collectives=sum(x[2] for x in lives), n_layers=cfg.n_layers,
        host=eng.host_state(), wall=wall)


def dp_rank(rank, world, backend, init, out, seed, smoke, b_local, max_len,
            chunk):
    """Phase 20: one rank of the DP plane, in a process of its own
    (spawned).  Joins the group through the file ``init``, runs (a),
    (d), (e) and (f) when ``smoke`` and (b), and saves the results to
    ``out/rank<rank>.pt``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels.flash_attention import ops as k6
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.rg_lru import ops as k5
    from repro_torch.kernels.ssd_scan import ops as k4
    from repro_torch.kernels.verify_attention import ops as k3
    from repro_torch.launch.mesh import make_dp_group
    from repro_torch.serving import engine as tengine

    group = make_dp_group(world, backend, "cuda",
                          init_method=f"file://{init}", timeout_s=600)
    counted = {"K1": ops.paged_attention_chunk, "K2": ops.paged_attention,
               "K3": k3.verify_attention, "K4": k4.ssd_scan,
               "K5": k5.rg_lru, "K6": k6.flash_attention,
               "K6 backward": k6.flash_attention_bwd}
    cfg = get_config("olmo-1b")
    bus = getattr(torch.cuda.get_device_properties(group.device),
                  "pci_bus_id", "?")
    res = {"device": f"{group.device}, bus {bus}"}
    if smoke:
        res["a"] = dp_smoke_run(tengine, smoke_config(cfg), seed,
                                group.device, group)
    res["b"] = dp_full_run(tengine, counted, cfg, seed, b_local, max_len,
                           chunk, group)
    if smoke:
        res["d"] = dp_full_run(tengine, counted, dp_f32_config(cfg), seed,
                               b_local, max_len, chunk, group)
        gc.collect()
        torch.cuda.empty_cache()
        res["e"] = chaos_entry_run(counted, CHAOS_ARGV + [
            "--mesh", "auto", "--dist-backend", backend])
        gc.collect()
        torch.cuda.empty_cache()
        res["f"] = dp_chaos_f32(tengine, counted, dp_f32_config(cfg), seed,
                                b_local, max_len, chunk, group)
    torch.save(res, Path(out) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def caller_cards():
    """The cards this run may use, in order: the caller's
    CUDA_VISIBLE_DEVICES entries, or, where it named none, every card of
    the host (nvidia-smi lists them all, and no mask hides one then)."""
    if CALLER_CARDS is not None:
        return [c.strip() for c in CALLER_CARDS.split(",") if c.strip()]
    n = len(subprocess.run(
        ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines())
    return [str(i) for i in range(n)]


def spawn_ranks(tag, backend, seed, smoke, b_local, max_len, chunk,
                visible, limit_s=300):
    """Phase 20: two ranks of :func:`dp_rank` started together (the
    ``spawn`` start method: this process holds a CUDA context), joined
    under ``limit_s``, killed and failed past it.  ``visible`` is their
    CUDA_VISIBLE_DEVICES, taken from the caller's cards
    (:func:`caller_cards`).  Returns their results in rank order."""
    import shutil
    import torch.multiprocessing as mp

    out = ROOT / "build" / f"dp_ranks_{backend}"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    env0 = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = visible
    try:
        procs = [ctx.Process(target=dp_rank, args=(
            r, 2, backend, str(out / "pg"), str(out), seed, smoke, b_local,
            max_len, chunk)) for r in range(2)]
        for p in procs:
            p.start()
    finally:
        if env0 is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = env0
    deadline = time.perf_counter() + limit_s
    for p in procs:
        p.join(max(deadline - time.perf_counter(), 1))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    check(codes == [0, 0], f"{tag} both ranks exited 0 within {limit_s} s "
                           f"({codes})")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def check_chaos_ranks(e, f, onef, smi):
    """Phase 20 (e) and (f) on the two gloo ranks.  (e): on each rank
    the checks of phase 16 (c) (:func:`check_chaos_entry`), one
    collective a transfer, and across the ranks equal host state and
    equal injector logs; rank 0 printed the run's lines, rank 1 none.
    (f): every stream equal to the single-process dp 2 run's under the
    same faults, token for token; rank d's reconcile reports equal that
    run's for shard d; one recovery in place, the journal drained,
    leak-free; one transfer and one collective a step but the step the
    torn crash cut; K1 + K2 = layers x steps on their fma kernels."""
    for d, r in enumerate(e):
        check_chaos_entry(f"[20e] rank {d}", r)
        check(r["collectives"] == r["transfers"],
              f"[20e] rank {d}: one collective a transfer "
              f"({r['collectives']}, {r['transfers']})")
    check(e[0]["host"] == e[1]["host"] and e[0]["log"] == e[1]["log"],
          "[20e] the ranks' host state and injector logs equal")
    check(e[0]["lines"] and not e[1]["lines"],
          "[20e] rank 0 printed the run's lines, rank 1 none")
    for line in e[0]["lines"]:
        phase(f"[20e] | {line}")
    for d, r in enumerate(e):
        phase(f"[20e] rank {d} of two gloo ranks sharing {smi}: "
              f"{r['steps']} steps over {len(r['lives'])} engine lives in "
              f"{r['wall']:.1f} s ({1e3 * r['wall'] / r['steps']:.2f} ms a "
              f"step, recoveries and rebuilds included), transfers "
              f"{r['transfers']}, collectives {r['collectives']}; faults "
              f"fired {r['log']}; reconciles of shard {d}: "
              f"{chaos_summary(r)}")

    def shard_of(report, d):
        return [{**c["shards"][d]} for c in report["classes"]]

    check(f[0]["host"] == f[1]["host"] and f[0]["log"] == f[1]["log"]
          == onef["log"], "[20f] the ranks' host state equal, every fault "
                          "fired as in one process")
    for d, r in enumerate(f):
        check(r["drained"] and r["leak_free"] and r["recoveries"] == 1
              and r["tokens"] == onef["tokens"],
              f"[20f] rank {d}: drained, leak-free, one recovery in place, "
              f"every stream == the single-process dp 2 run's under the "
              f"same faults, token for token")
        check(len(r["reports"]) == len(onef["reports"]) == 2 and all(
            shard_of(a, 0) == shard_of(b, d) and a["conserved"]
            and a["never_dry"] for a, b in zip(r["reports"],
                                               onef["reports"])),
              f"[20f] rank {d}: each reconcile report of shard {d} == the "
              f"single-process run's")
        torn = sum(1 for k, _, _, t in F32_FAULTS if k == "crash" and t)
        check(r["transfers"] + torn == r["steps"] == r["collectives"] + torn,
              f"[20f] rank {d}: one transfer and one collective a step but "
              f"the step the torn crash cut ({r['transfers']}, "
              f"{r['collectives']}, {r['steps']})")
        got = r["launches"]
        check(got["K1"] + got["K2"] == r["n_layers"] * r["steps"]
              and sum(got.values()) == r["n_layers"] * r["steps"]
              and r["k1_routes"].get("fma", 0) == got["K1"]
              and r["k2_routes"].get("fma", 0) == got["K2"],
              f"[20f] rank {d}: K1 + K2 = {r['n_layers']} x steps on their "
              f"fma kernels ({got}, {r['steps']})")
    phase(f"[20f] olmo-1b in f32 at full width, {f[0]['n_layers']} layers, "
          f"dp 2 on two gloo ranks sharing {smi} under {F32_FAULTS}: "
          f"{len(onef['tokens'])} streams == the single-process run's, "
          f"token for token; reconciles (rank 0; rank 1) "
          + "; ".join(f"reclaimed {a['reclaimed']} / {b['reclaimed']}"
                      for a, b in zip(f[0]["reports"], f[1]["reports"]))
          + f"; K1 {f[0]['launches']['K1']}, K2 {f[0]['launches']['K2']} a "
            f"rank over {f[0]['steps']} steps; {f[0]['wall']:.1f} s on rank "
            f"0, {onef['wall']:.1f} s in one process")


def serve_dp_ranks(tengine, counted, cfg, cfg_smoke, seed, b_local,
                   max_len, chunk, smi):
    """Phase 20: the DP allocation plane, one rank per DP shard.  (a)
    phase 4's f32 smoke workload at dp 2 on two ranks sharing the card
    over gloo equals the CPU single-process engine: tokens, status rows,
    each shard's integer state; (b) olmo-1b at full width on phase 5's
    requests, dp 2 on the same two ranks, ``b_local`` slots a shard: the
    ranks' host state equal, conservation per shard, leak-free, one
    transfer and one collective a step, each rank's K1/K2 launches once
    a layer a step of their width, the streams the single-process dp 2
    engine's on the card or first different at a near-tie; (c) (b) over
    nccl, one rank per card, where the run was given two cards; (d) the
    f32 model at full width and cut depth on the ranks of (a): every
    stream the single-process dp 2 engine's exactly; (e) phase 16 (c)'s
    ``launch.serve`` with every fault kind on the ranks of (a); (f) (d)
    under a crash, a torn crash and a step error, against one process
    under the same faults (:func:`check_chaos_ranks`).  Returns the
    numbers."""
    t0 = time.perf_counter()
    cpu = dp_smoke_run(tengine, cfg_smoke, seed, "cpu")
    one = dp_full_run(tengine, counted, cfg, seed, b_local, max_len, chunk)
    one_launches = dict(one["launches"])
    check(cpu["done"] and one["done"] and one["leak_free"],
          "[20] the single-process references finished and drained")
    from repro_torch.models.model import init_params
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"[20] single-process references: the CPU smoke engine and the "
          f"card's dp 2 engine at full width in "
          f"{time.perf_counter() - t0:.1f} s")
    cfg32 = dp_f32_config(cfg)
    one32 = dp_full_run(tengine, counted, cfg32, seed, b_local, max_len,
                        chunk)
    check(one32["done"] and one32["leak_free"],
          "[20d] the single-process f32 reference finished and drained")
    gc.collect()
    torch.cuda.empty_cache()
    t_f = time.perf_counter()
    onef = dp_chaos_f32(tengine, counted, cfg32, seed, b_local, max_len,
                        chunk)
    check(onef["drained"] and onef["leak_free"] and len(onef["log"]) == 3
          and len(onef["reports"]) == 2 and onef["recoveries"] == 1,
          f"[20f] the single-process f32 reference under faults fired "
          f"{onef['log']}, recovered and drained")
    phase(f"[20f] single-process f32 reference under faults in "
          f"{time.perf_counter() - t_f:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    cards = caller_cards()
    t1 = time.perf_counter()
    ranks = spawn_ranks("[20]", "gloo", seed, True, b_local, max_len, chunk,
                        visible=cards[0], limit_s=480)
    phase(f"[20] two gloo ranks on {smi} ({ranks[0]['device']}; "
          f"{ranks[1]['device']}; CUDA_VISIBLE_DEVICES {cards[0]}): "
          f"spawned, served (a), (b), (d), (e) and (f), exited in "
          f"{time.perf_counter() - t1:.1f} s")
    for d, r in enumerate(ranks):
        a = r["a"]
        check(a["done"] and a["leak_free"], f"[20a] rank {d} drained")
        check(a["tokens"] == cpu["tokens"] and a["status"] == cpu["status"],
              f"[20a] rank {d}: tokens and status rows == the CPU engine's")
        check(torch.equal(a["tables"], cpu["tables"][d:d + 1])
              and torch.equal(a["seq_lens"], cpu["seq_lens"][d:d + 1])
              and same_tensors(a["pool"], [t[d:d + 1] for t in cpu["pool"]]),
              f"[20a] rank {d}: shard {d}'s page tables, seq_lens and pool "
              f"leaves == the CPU engine's")
        check(a["transfers"] == a["collectives"] == a["steps"],
              f"[20a] rank {d}: one transfer and one collective a step")
    phase(f"[20a] f32 smoke at dp 2 on two gloo ranks sharing {smi}: "
          f"{len(cpu['tokens'])} requests, {cpu['steps']} steps, tokens, "
          f"status rows and each shard's integer state == the CPU "
          f"single-process engine's")

    def check_full(tag, runs):
        check(runs[0]["host"] == runs[1]["host"],
              f"{tag} the ranks' host state (slot map, queues, ledgers, "
              f"stats) equal at the end")
        for d, b in enumerate(runs):
            want = {"K1": b["n_layers"] * (b["steps"] - b["decode_steps"]),
                    "K2": b["n_layers"] * b["decode_steps"]}
            got = b["launches"]
            check(b["done"], f"{tag} rank {d}: every request finished, "
                             f"every budget generated")
            check(all(got[k] == n > 0 for k, n in want.items())
                  and sum(got.values()) == sum(want.values()),
                  f"{tag} rank {d}: K1 and K2 once a layer a step of their "
                  f"width, no other kernel ({got}, want {want})")
            check(b["k1_routes"]["wgmma"] == got["K1"]
                  and b["k2_routes"]["tma"] == got["K2"],
                  f"{tag} rank {d}: K1 on wgmma, K2 on tma")
            check(b["transfers"] == b["collectives"] == b["steps"],
                  f"{tag} rank {d}: one transfer and one collective a step "
                  f"({b['transfers']}, {b['collectives']}, {b['steps']})")
            check(b["in_use"] == 0 and b["leak_free"] and b["conserved"]
                  and b["margin"] is not None and b["margin"] >= 0,
                  f"{tag} rank {d}: shard conserved (free + live == "
                  f"{b['pages_local']}), never dry (margin {b['margin']}), "
                  f"leak-free after the drain")
        check(runs[0]["tokens"] == runs[1]["tokens"],
              f"{tag} both ranks hold every stream")
        return near_ties(tag, runs[0], one)

    params = None

    def near_ties(tag, got, ref):
        """Streams equal to the single-process run's, or first different
        where its top-2 logit gap is within 6e-2 of the logit scale."""
        nonlocal params
        same, ties = 0, []
        for i, (a, b) in enumerate(zip(got["tokens"], ref["tokens"])):
            if a == b:
                same += 1
                continue
            if params is None:
                params = init_params(cfg, seed=seed, device="cuda")
            p = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            gap, scale = top2_gap(cfg, params, ref["prompts"][i] + b[:p])
            check(gap <= 6e-2 * scale,
                  f"{tag} stream {i} differs at token {p} where the "
                  f"top-2 gap {gap:.4f} exceeds 6e-2 of the logit scale "
                  f"{scale:.2f}")
            ties.append((i, p, round(gap, 5)))
        phase(f"{tag} {same} of {len(ref['tokens'])} streams == the "
              f"single-process dp 2 engine's; near-ties (stream, token, "
              f"top-2 gap): {ties}")
        return same

    same_b = check_full("[20b]", [r["b"] for r in ranks])
    d32 = [r["d"] for r in ranks]
    check(d32[0]["host"] == d32[1]["host"],
          "[20d] the ranks' host state equal at the end")
    for d, b in enumerate(d32):
        check(b["done"] and b["tokens"] == one32["tokens"],
              f"[20d] rank {d}: every stream == the single-process dp 2 "
              f"engine's, token for token")
        check(b["transfers"] == b["collectives"] == b["steps"]
              and b["in_use"] == 0 and b["leak_free"] and b["conserved"],
              f"[20d] rank {d}: one transfer and one collective a step, "
              f"the shard conserved and empty after the drain")
        check(b["launches"]["K1"] == b["n_layers"] * (b["steps"]
                                                      - b["decode_steps"])
              and b["launches"]["K2"] == b["n_layers"] * b["decode_steps"]
              and b["k1_routes"].get("fma") == b["launches"]["K1"]
              and b["k2_routes"].get("fma") == b["launches"]["K2"],
              f"[20d] rank {d}: K1 and K2 on their fma kernels once a layer "
              f"a step of their width ({b['launches']})")
    phase(f"[20d] olmo-1b in f32 at full width, {cfg32.n_layers} layers, "
          f"dp 2 on two gloo ranks sharing {smi}: {len(one32['tokens'])} "
          f"streams over {d32[0]['steps']} steps == the single-process dp "
          f"2 engine's, token for token; K1 {d32[0]['launches']['K1']}, "
          f"K2 {d32[0]['launches']['K2']} a rank")
    check_chaos_ranks([r["e"] for r in ranks], [r["f"] for r in ranks],
                      onef, smi)
    for d, r in enumerate(ranks):
        b = r["b"]
        phase(f"[20b] olmo-1b at dp 2, rank {d} of two gloo ranks "
              f"time-sharing {smi} (a plumbing figure, not a scaling "
              f"one): {b['steps']} steps ({b['decode_steps']} decode-only), "
              f"{b['ms_step']:.2f} ms/step, {b['tok_s']:.1f} generated "
              f"tok/s; K1 launches {b['launches']['K1']}, K2 launches "
              f"{b['launches']['K2']}; transfers {b['transfers']}, "
              f"collectives {b['collectives']}")
    phase(f"[20b] single-process dp 2 engine on {smi}: {one['steps']} "
          f"steps, {one['ms_step']:.2f} ms/step, {one['tok_s']:.1f} "
          f"generated tok/s; K1 {one_launches['K1']}, K2 "
          f"{one_launches['K2']}")
    out = dict(a_steps=cpu["steps"], ranks=[r["b"] for r in ranks],
               one=one, same=same_b, nccl=None,
               faults=[r["e"]["launches"] for r in ranks],
               faults_f32=[r["f"]["launches"] for r in ranks])
    if len(cards) >= 2:
        t2 = time.perf_counter()
        nccl = spawn_ranks("[20c]", "nccl", seed, False, b_local, max_len,
                           chunk, visible=",".join(cards[:2]))
        out["nccl"] = [r["b"] for r in nccl]
        out["same_nccl"] = check_full("[20c]", out["nccl"])
        for d, b in enumerate(out["nccl"]):
            phase(f"[20c] olmo-1b at dp 2 over nccl, rank {d} on "
                  f"{nccl[d]['device']}: {b['ms_step']:.2f} ms/step, "
                  f"{b['tok_s']:.1f} generated tok/s; K1 "
                  f"{b['launches']['K1']}, K2 {b['launches']['K2']}")
        phase(f"[20c] nccl ranks in {time.perf_counter() - t2:.1f} s")
    else:
        phase(f"[20c] nccl unexercised: this run was given {len(cards)} "
              f"card (NCCL refuses two ranks on one card)")
    return out


def start_dryrun(batch=4, seq=2048):
    """Start phase 21 (a)'s dry run in a subprocess, after the build (so
    it never competes with nvcc) and at the lowest priority: host work
    only, it overlaps the card's phases; ``atexit`` stops it if the
    script ends first."""
    import atexit
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", DRYRUN_CELL.format(batch=batch, seq=seq)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def check_dryrun(proc, train, smi, timeout=600):
    """Phase 21 (a): the dry run's prediction of phase 12's step beside
    what phase 12 measured.  Gates: the predicted bytes of the
    parameters and AdamW state equal what the trainer held, exactly;
    the measured step is no faster than the predicted compute term."""
    out, err = proc.communicate(timeout=timeout)
    check(proc.returncode == 0,
          f"[21a] the dry run exited {proc.returncode}: {err[-2000:]}")
    r = json.loads(out.strip().splitlines()[-1])
    rf, mem = r["roofline"], r["memory"]
    held = sum(mem["argument_size_by_arg"][:2])
    check(held == train["state_bytes"],
          f"[21a] predicted parameter and AdamW bytes {held} == the "
          f"trainer's {train['state_bytes']}")
    t_comp, t_mem = 1e3 * rf["t_compute_s"], 1e3 * rf["t_memory_s"]
    check(train["ms"] >= t_comp,
          f"[21a] phase 12's step {train['ms']:.1f} ms >= the predicted "
          f"compute term {t_comp:.1f} ms")
    phase(f"[21a] dry run of {r['arch']} {r['shape']} (B {train['batch']} "
          f"x S {train['seq']}, rules {r['rules']}, mesh {r['mesh']}, "
          f"traced in {r['trace_s']} s on a host core): parameters and "
          f"AdamW state {held} B predicted == {train['state_bytes']} B held "
          f"by phase 12's trainer")
    phase(f"[21a] on {smi}: predicted hbm_per_device_gb "
          f"{r['hbm_per_device_gb']:.3f} GiB (arguments + peak temporaries "
          f"- donated) against max_memory_allocated "
          f"{train['peak'] / 2**30:.3f} GiB; t_compute {t_comp:.1f} ms, "
          f"t_memory {t_mem:.1f} ms ({rf['bottleneck']}-bound, graph flops "
          f"{r['graph_cost']['flops']:.4e}, bytes "
          f"{r['graph_cost']['bytes accessed']:.4e}) against the measured "
          f"step {train['ms']:.1f} ms")
    return dict(record=r, held=held, t_compute_ms=t_comp, t_memory_ms=t_mem)


def check_kv_cache(seed, smi, device="cuda"):
    """Phase 21 (b): ``core/kv_cache.py`` at olmo-1b's KV width (16 kv
    heads, hd 128, bf16, pages of 64) through a seeded sequence of
    every op on the card and on the CPU: integer state and pages
    bit-equal after each op; no block in use after the release."""
    from repro_torch.core import kv_cache as kv

    S, C, KH, hd, psz, pages, maxp = 8, 96, 16, 128, 64, 40, 8
    g = torch.Generator().manual_seed(seed)
    caches = {d: kv.create(pages, psz, KH, hd, S, maxp, torch.bfloat16, d)
              for d in ("cpu", device)}

    def same(oks):
        a, b = caches["cpu"], caches[device]
        for x, y in zip([*a.pool, *a[1:]], [*b.pool, *b[1:]]):
            check(torch.equal(x, y.cpu()), "[21b] card == CPU, bit for bit")
        check(torch.equal(oks["cpu"], oks[device].cpu()), "[21b] ok equal")

    def run(op, *args):
        oks = {}
        for d, c in caches.items():
            out = op(c, *[a.to(d) if torch.is_tensor(a) else a
                          for a in args])
            caches[d], oks[d] = ((out, torch.ones(1, dtype=torch.bool))
                                 if isinstance(out, kv.PagedKVCache)
                                 else out)
        same(oks)
        return oks["cpu"]

    def kvs(*shape):
        return (torch.randn(*shape, KH, hd, generator=g).to(torch.bfloat16),
                torch.randn(*shape, KH, hd, generator=g).to(torch.bfloat16))

    def lens(hi):
        return torch.randint(0, hi + 1, (S,), generator=g, dtype=torch.int32)

    run(kv.append_chunk, *kvs(S, C), lens(C))
    run(kv.append_chunk, *kvs(S, C), lens(C),
        torch.rand(S, generator=g) < 0.7)
    run(kv.append, *kvs(S), torch.rand(S, generator=g) < 0.8)
    run(kv.rollback, lens(40))
    empty = torch.zeros(S, dtype=torch.bool)
    empty[-2:] = True
    run(kv.release, empty)
    n_shared = [int(caches["cpu"].seq_lens[s]) - 5 for s in (0, 1)]
    shared = [bool(run(kv.share_prefix, S - 2 + s, s, max(n, 0)))
              for s, n in enumerate(n_shared)]
    denied = [run(kv.append_chunk, *kvs(S, C), torch.full(
        (S,), C, dtype=torch.int32)) for _ in range(3)]
    n_denied = sum(int((~ok).sum()) for ok in denied)
    run(kv.release, torch.ones(S, dtype=torch.bool))
    c = caches[device]
    check(int(c.pool.top) == pages and int((c.pool.refcount != 0).sum()) == 0,
          "[21b] every page back in the pool after the release")
    phase(f"[21b] kv_cache on {smi}: {S} sequences, {KH} kv heads, hd {hd}, "
          f"bf16, pages of {psz}, a pool of {pages}: append_chunk (C {C}), "
          f"append, rollback, release, share_prefix ({shared}), "
          f"{n_denied} chunk appends denied at a full pool or table, "
          f"release: integer state and pages bit-equal to the CPU after "
          f"every op; 0 blocks in use after the release")
    return dict(shared=shared, denied=n_denied)


# ------------------------------------------------------------ phase 22

#: phase 22 (a): phi-3-vision-4.2b's batch, 4 x (576 image positions +
#: 1,472 text tokens) = 4 x 2,048 positions a step; (c) whisper-tiny's,
#: 8 x 448 decoder tokens (Whisper's text context, arXiv:2212.04356)
#: beside 8 x 1,500 frames
PHI_TRAIN = {"batch": 4, "seq": 2048 - 576}
WHISPER_TRAIN = {"batch": 8, "seq": 448}
#: phase 22 (b): ``launch.train.main`` saves the trainer's whole state
#: at its first and last step and keeps both, 16 bytes a parameter
#: (weights, mu, nu and master as float32): 61.1 GB a save at
#: phi-3-vision's 32 layers.  Each save is held whole on the host, and
#: the loop saves in a thread, so the last save's host copy is made
#: while the first may still be writing: two on the host at once.  The
#: depth is the deepest whose two saves take at most these shares of
#: the free disk and of the host's available memory (the rest of the
#: latter for the written pages) (:func:`entry_depth`)
ENTRY_DISK_SHARE, ENTRY_HOST_SHARE = 0.9, 0.6
#: phase 22 (b): the most its two saves may write.  A run of this script
#: is held to 45 GiB of disk writes, deleted files included, whatever
#: ``df`` shows free; the builds and the other phases write a few GiB
#: of the rest
ENTRY_WRITE_BYTES = 32 * 2**30
#: phase 22 (d): the float32 card-against-CPU tolerance of the loss and
#: of each gradient leaf, relative to its scale: phi-3-vision's
#: gradient tolerance of the CPU tests (test_torch_encdec.py)
F32_TRAIN_TOL = 1e-3


def check_k6_hd96_backward(k6, rng):
    """Phase 22 (e): phase 3's checks of K6's backward (check_k6_grad) at
    phi-3-vision's hd 96, bf16 on the wgmma route (held to its walk
    under ``BWD_ROW_TOL`` and to the plain version at 6e-2) and float32
    on the FMA kernels (1e-4), causal and bidirectional, G 1 and 2, at
    phase 19 (e)'s S 640 (B 4) and at S 700 (a ragged last tile), and
    bf16 at the shape (a) trains at (B 4, H 32, S 2,048, causal), two
    calls bit-equal; and the bf16 backward at the shapes (c) trains at:
    whisper-tiny's encoder, bidirectional (B 8, H 6, S 1,500, hd 64),
    and its decoder, causal (B 8, H 6, S 448).  Returns the worst error
    of each route (whisper's apart) and the walk's reading and
    control."""
    bf, f32 = torch.bfloat16, torch.float32
    out = {"wgmma": 0.0, "f32": 0.0, "whisper": 0.0, "row": 0.0,
           "ctrl": float("inf")}
    cases = [(f"hd 96 {'bf16' if dt == bf else 'f32'} (G={32 // KH})", dt, B,
              32, KH, S, 96, causal)
             for S, B in ((640, 4), (700, 1)) for KH in (32, 16)
             for causal in (True, False) for dt in (bf, f32)]
    cases += [("phi-3-vision's training shape bf16", bf, 4, 32, 32, 2048,
               96, True),
              ("whisper-tiny's encoder bf16", bf, 8, 6, 6, 1500, 64, False),
              ("whisper-tiny's decoder bf16", bf, 8, 6, 6, 448, 64, True)]
    for case in cases:
        err, twin = check_k6_grad(k6, rng, *case, tag="[22e]")
        key = ("whisper" if case[6] == 64 else
               k6.backward_route(case[1], case[6]))
        out[key] = max(out[key], err)
        if twin is not None:
            out["row"], out["ctrl"] = (max(out["row"], twin[0]),
                                       min(out["ctrl"], twin[1]))
    return out


def host_available_bytes() -> int:
    """The host memory the kernel reports available (MemAvailable)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def host_rss_bytes() -> int:
    """This process's resident host memory (VmRSS)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


def entry_depth(full, where):
    """Phase 22 (b)'s depth: the deepest of ``full``'s layers whose two
    saves of the trainer's state (16 bytes a parameter each) take at
    most ``ENTRY_DISK_SHARE`` of the disk free at ``where``, at most
    ``ENTRY_WRITE_BYTES`` and at most ``ENTRY_HOST_SHARE`` of the host's
    available memory.  Returns (depth, bytes a save at that
    depth, free disk, available host memory); depth 0 where not even
    one layer fits."""
    import shutil

    from repro_torch.models.model import count_params

    free, avail = shutil.disk_usage(where).free, host_available_bytes()

    def save(n):
        return 16 * count_params(dataclasses.replace(full, n_layers=n))

    fits = [n for n in range(1, full.n_layers + 1)
            if 2 * save(n) <= min(ENTRY_DISK_SHARE * free, ENTRY_WRITE_BYTES,
                                  ENTRY_HOST_SHARE * avail)]
    n = max(fits, default=0)
    return n, save(n) if n else 0, free, avail


def train_entry_point(counted, smi):
    """Phase 22 (b): ``launch.train.main`` on the card for
    phi-3-vision-4.2b, text only, as the reference's ``main`` trains it
    (it feeds no image embeddings): 3 steps of 2 x 512 tokens, its
    checkpoints under the build directory, removed after, at the
    deepest depth those checkpoints fit (:func:`entry_depth`, from the
    free disk and available host memory measured here; all 32 layers
    where they fit).  Gates: a depth of at least one layer, finite
    losses, K6 on the wgmma route at hd 96 (2 launches a layer a step,
    its backward 1), no other kernel.  Returns the counts."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.launch import train as trainer
    from repro_torch.models.model import count_params

    full = get_config("phi-3-vision-4.2b")
    ckpt = ROOT / "build" / "chip_smoke_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    n_layers, per_save, free, avail = entry_depth(full, ckpt.parent)
    check(n_layers >= 1,
          f"[22b] two checkpoints of one layer fit {free / 1e9:.1f} GB of "
          f"free disk, the write budget and {avail / 1e9:.1f} GB of host "
          f"memory")
    cut = dataclasses.replace(full, n_layers=n_layers)
    steps = 3
    argv = ["--arch", full.name, "--steps", str(steps), "--batch", "2",
            "--seq", "512", "--ckpt-dir", str(ckpt)]
    phase(f"[22b] python -m repro_torch.launch.train {' '.join(argv)} at "
          f"{n_layers} of {full.n_layers} layers: main saves the trainer's "
          f"whole state at its first and last step and keeps both, 16 "
          f"bytes a parameter, both held whole on the host at once: "
          f"{16 * count_params(full) / 1e9:.1f} GB a save at "
          f"{full.n_layers} layers, {per_save / 1e9:.1f} GB at {n_layers}, "
          f"the deepest whose two saves take at most {ENTRY_DISK_SHARE:g} "
          f"of the {free / 1e9:.1f} GB of free disk (measured now) and at "
          f"most the run's write budget of {ENTRY_WRITE_BYTES / 1e9:.1f} "
          f"GB, and {ENTRY_HOST_SHARE:g} of the {avail / 1e9:.1f} GB of "
          f"available host memory (measured now; this process holds "
          f"{host_rss_bytes() / 1e9:.1f} GB)")
    get = trainer.get_config
    trainer.get_config = lambda arch: cut if arch == full.name else get(arch)
    zero_counts(counted)
    try:
        t0 = time.perf_counter()
        state, losses = trainer.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        trainer.get_config = get
        shutil.rmtree(ckpt, ignore_errors=True)
    launches = {k: fn.launches for k, fn in counted.items()}
    routes = {k: dict(counted[k].routes) for k in ("K6", "K6 backward")}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"[22b] finite losses, one a step ({losses})")
    check(launches["K6"] == 2 * n_layers * steps
          and launches["K6 backward"] == n_layers * steps
          and sum(launches.values()) == 3 * n_layers * steps
          and all(r["wgmma"] == sum(r.values()) for r in routes.values()),
          f"[22b] K6 {2 * n_layers} and its backward {n_layers} times a "
          f"step, all on the wgmma route, no other kernel ({launches}, "
          f"{routes})")
    phase(f"[22b] entry point on {smi}: {steps} steps in {wall:.1f} s "
          f"(checkpoints included), losses {losses}; K6 "
          f"{launches['K6']}, K6 backward {launches['K6 backward']} by "
          f"route {routes}")
    return {"launches": launches["K6"],
            "bwd_launches": launches["K6 backward"], "losses": losses,
            "n_layers": n_layers}


def check_train_f32(counted, seed, smi, arch="phi-3-vision-4.2b",
                    tag="[22d]", n_layers=2, text=128):
    """Phases 22 (d) and 24 (d): ``arch`` at full width cut to
    ``n_layers`` layers, float32, one sequence of ``text`` tokens (a
    VLM's 576 image positions before them: 704 positions for
    phi-3-vision; not a multiple of 64, so the last tiles are ragged):
    ``loss_fn`` and its gradients through autograd on the card (K6's
    float32 forward and backward kernels, at the model's hd and G)
    against the CPU (their plain versions), from the same parameters and
    batch.  The stacked ``groups`` at each layer's own fan-in, as phase
    19 (c) holds phi-3-vision in float32 (:func:`own_fan_in`).  Gate:
    the loss and every gradient leaf within ``F32_TRAIN_TOL`` of its
    scale; the CPU's own one-ulp floor (every weight moved one ulp)
    printed beside."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.model import init_params, loss_fn

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                              dtype="float32")
    vlm = cfg.arch_kind == "vlm"
    t0 = time.perf_counter()
    params = own_fan_in(cfg, init_params(cfg, seed=seed, device="cpu"),
                        ("groups",))
    rng = np.random.RandomState(seed + 22)
    batch = {"tokens": rng.randint(1, cfg.vocab, (1, text)),
             "labels": rng.randint(1, cfg.vocab, (1, text))}
    if vlm:
        batch["img_embeds"] = rng.randn(1, cfg.img_tokens, cfg.d_model)
    batch = {k: a.astype(np.float32 if k == "img_embeds" else np.int32)
             for k, a in batch.items()}

    def grads(p, device):
        leaves = tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        b = {k: torch.from_numpy(a).to(device) for k, a in batch.items()}
        loss = loss_fn(cfg, p, b)
        g = torch.autograd.grad(loss, leaves)
        return loss.detach().cpu(), [t.cpu() for t in g]

    cpu = grads(params, "cpu")
    t_cpu = time.perf_counter() - t0
    card_params = tree_map(lambda a: a.detach().to("cuda"), params)
    zero_counts(counted)
    card = grads(card_params, "cuda")
    launches = {k: fn.launches for k, fn in counted.items()}
    routes = {k: dict(counted[k].routes) for k in ("K6", "K6 backward")}
    del card_params
    torch.cuda.empty_cache()
    bits = np.random.default_rng(seed)

    def nudge(a):
        # one random bit a weight: float64 uniforms for phi4-mini's 1.4 B
        # weights take ten times as long
        up = np.unpackbits(bits.integers(0, 256, -(-a.numel() // 8),
                                         dtype=np.uint8), count=a.numel())
        return torch.nextafter(a.detach(), torch.where(
            torch.from_numpy(up.astype(bool)).reshape(a.shape), torch.inf,
            -torch.inf))

    floor = grads(tree_map(nudge, params), "cpu")
    del params

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    loss_err = rel(card[0], cpu[0])
    errs = [rel(a, b) for a, b in zip(card[1], cpu[1])]
    floors = [rel(a, b) for a, b in zip(floor[1], cpu[1])]
    check(launches["K6"] == 2 * n_layers
          and launches["K6 backward"] == n_layers
          and sum(launches.values()) == 3 * n_layers
          and all(r["f32"] == sum(r.values()) for r in routes.values()),
          f"{tag} K6 {2 * n_layers} and its backward {n_layers} times, on "
          f"the f32 route, no other kernel ({launches}, {routes})")
    check(loss_err <= F32_TRAIN_TOL and max(errs) <= F32_TRAIN_TOL,
          f"{tag} loss and every gradient leaf on the card within "
          f"{F32_TRAIN_TOL:g} of their scale from the CPU's (loss "
          f"{loss_err:.3e}, leaves {errs})")
    seq = f"({cfg.img_tokens} image + {text} text) positions" if vlm else (
        f"{text} tokens")
    phase(f"{tag} {cfg.name} at full width (H {cfg.n_heads}, KH "
          f"{cfg.n_kv_heads}, hd {cfg.hd}), {n_layers} layers, f32, 1 x "
          f"{seq}, on {smi} "
          f"against the CPU ({t_cpu:.1f} s there): loss {card[0].item():.6f}"
          f" vs {cpu[0].item():.6f} ({loss_err:.3e}), gradients within "
          f"{max(errs):.3e} of each leaf's scale (tol {F32_TRAIN_TOL:g}; "
          f"the CPU's one-ulp floor reaches {max(floors):.3e}, loss "
          f"{rel(floor[0], cpu[0]):.3e}); K6 {launches['K6']} and its "
          f"backward {launches['K6 backward']} on {routes}")
    return {"launches": launches["K6"],
            "bwd_launches": launches["K6 backward"], "err": max(errs),
            "loss_err": loss_err, "floor": max(floors)}


def train_vlm_encdec(k6, counted, seed, smi, profile=False):
    """Phase 22: phi-3-vision-4.2b and whisper-tiny train at full width
    through ``build_step``: (e) K6's backward at hd 96 and at whisper's
    encoder shape against its plain version and its walk, first; (a)
    phi-3-vision at its published widths, 32 layers, bf16, 4 x (576 +
    1,472) positions; (b) ``launch.train.main`` for phi-3-vision; (c)
    whisper-tiny, 4 + 4 layers, 8 x 448 tokens beside 8 x 1,500 frames;
    (d) phi-3-vision in float32 at 2 layers, card against CPU; (f) K6's
    backward times at phi-3-vision's training shape, at S 640 and at
    whisper's encoder shape, each beside its bound, its plain version and
    SDPA's backward.  With ``profile``, (a) and (c) run two more steps
    under the profiler.  Returns the numbers the kernels line reports."""
    from repro_torch.configs import get_config

    rng = np.random.RandomState(seed + 22)
    out = {"e": check_k6_hd96_backward(k6, rng)}
    phi, whisper = (get_config(a) for a in ("phi-3-vision-4.2b",
                                            "whisper-tiny"))
    out["a"] = train_full_width(phi, seed, counted, smi, tag="[22a]",
                                turns=False, profile=profile, **PHI_TRAIN)
    out["b"] = train_entry_point(counted, smi)
    out["c"] = train_full_width(whisper, seed, counted, smi, tag="[22c]",
                                turns=False, profile=profile,
                                **WHISPER_TRAIN)
    out["d"] = check_train_f32(counted, seed, smi)
    out["f"] = {
        "phi": time_k6(k6, rng, phi.n_heads, phi.n_kv_heads, phi.hd,
                       fwd=False, present=None),
        "phi_s640": time_k6(k6, rng, phi.n_heads, phi.n_kv_heads, phi.hd,
                            S=phi.img_tokens + 64, fwd=False, present=None),
        "whisper": time_k6(k6, rng, whisper.n_heads, whisper.n_kv_heads,
                           whisper.hd, B=WHISPER_TRAIN["batch"],
                           S=whisper.enc_len, causal=False, fwd=False,
                           present=None)}
    for t in out["f"].values():
        b = t["bwd"]
        phase(f"[22f] K6 backward (wgmma/TMA) {t['shape']} on {smi}: kernel "
              f"{b['ms']:.4f} ms (host {b['host_ms']:.4f} ms a call), bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {b['flops']} flop, "
              f"{b['bytes']} B), plain {b['plain_ms']:.4f} ms, library "
              f"(SDPA's backward through torch.autograd.grad) "
              f"{b['library_ms']:.4f} ms")
    for name, r in (("phi-3-vision-4.2b", out["a"]),
                    ("whisper-tiny", out["c"])):
        phase(f"[22] {name} training on {smi}: {r['ms']:.1f} ms a step, "
              f"{r['tok_s']:.0f} text tokens/s, {100 * r['mfu']:.1f}% model "
              f"flops, peak {r['peak'] / 2**30:.2f} GiB, {r['n_layers']} "
              f"layers")
    return out


# ------------------------------------- phase 23: four more architectures

#: llama4-maverick's depth in phase 23: one global_moe layer (128 experts)
#: and one global, 18.43B parameters (36.86 GB in bf16); at 4 layers 69.6
#: GB, too close to the card's 79.18 GiB to leave room for the dispatch
#: buffers, and its 48 layers are 800 GB
LLAMA4_LAYERS = 2


def phase23_configs():
    """(tag, config, size classes, ``make_requests`` options) of phase
    23's four models: llama3.2-1b, phi4-mini-3.8b, gemma3-27b (its 52
    window-1,024 rings on CLS_STATE; four prompts of 1,025-1,984 tokens
    that wrap them) and llama4-maverick cut to :data:`LLAMA4_LAYERS`
    layers, resident, capacity factor 64."""
    from repro_torch.configs import get_config

    llama4 = moe_cfg(get_config("llama4-maverick-400b-a17b"),
                     n_layers=LLAMA4_LAYERS)
    return (("a", get_config("llama3.2-1b"), 1, {}),
            ("b", get_config("phi4-mini-3.8b"), 1, {}),
            ("c", get_config("gemma3-27b"), 2,
             dict(hi=1984, n_long=4, long_lo=1025)),
            ("d", llama4, 1, {}))


def serve_four_archs(tengine, counted, seed, smi, b_local, max_len, chunk):
    """Phase 23: llama3.2-1b, phi4-mini-3.8b, gemma3-27b and
    llama4-maverick (cut to :data:`LLAMA4_LAYERS` layers) at their
    published widths through ``ServingEngine.run``, bf16, random weights
    from ``seed`` drawn on the card, dp 1: the checks of
    :func:`serve_full_width` (K1 on its wgmma route once per attention
    layer per step with a prompt lane, K2 on its tma route once per
    attention layer per decode-only step, at G 4, 3, 2 and 5; no other
    kernel; one transfer a step; every class empty after the drain).
    gemma3-27b's 52 local layers attend over their rings in torch ops,
    as the reference does, and launch nothing; its four long prompts
    wrap the 1,025-slot rings, and its slots hold their CLS_STATE grant
    at the peak.  Each model is freed before the next is drawn.
    Returns each model's run by name."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import count_params
    from repro_torch.models.transformer import state_blocks_per_slot

    full = get_config("llama4-maverick-400b-a17b")
    out = {}
    for x, cfg, classes, kw in phase23_configs():
        tag = f"[23{x}]"
        if cfg.moe is not None:
            four = dataclasses.replace(cfg, n_layers=2 * LLAMA4_LAYERS)
            card = torch.cuda.get_device_properties(0).total_memory
            E = cfg.moe.num_experts
            phase(f"{tag} {full.name} cut from {full.n_layers} to "
                  f"{cfg.n_layers} layers ({'/'.join(cfg.layer_kinds)}; "
                  f"{E} experts top-{cfg.moe.top_k}), served resident, "
                  f"capacity factor {cfg.moe.capacity_factor:g}: "
                  f"{count_params(cfg)} parameters, "
                  f"{2 * count_params(cfg) / 1e9:.2f} GB in bf16; at "
                  f"{four.n_layers} layers {2 * count_params(four) / 1e9:.1f}"
                  f" GB, too close to the card's {card / 2**30:.2f} GiB "
                  f"for the dispatch buffers; expert paging would gather "
                  f"all {E} x 3 pages of a layer "
                  f"({6 * E * cfg.d_model * cfg.d_ff / 1e9:.1f} GB) before "
                  f"each MoE layer")
        gc.collect()
        torch.cuda.empty_cache()
        reqs = make_requests(tengine, cfg, seed, **kw)
        r = serve_full_width(tag, tengine, counted, "K1", cfg, seed,
                             b_local, max_len, chunk, reqs,
                             size_classes=classes)
        check(r["n_layers"] == sum(1 for k in cfg.layer_kinds
                                   if k.startswith("global")) > 0
              and r["k1_routes"]["fma"] == r["k2_routes"]["fma"] == 0,
              f"{tag} {cfg.name}: every attention layer on K1's wgmma and "
              f"K2's tma route ({r['k1_routes']}, {r['k2_routes']})")
        if classes > 1:
            ring = cfg.window + 1
            wrapped = sum(len(q.prompt) > ring for q in reqs)
            grant = state_blocks_per_slot(cfg, max_len)
            check(cfg.n_layers == len(cfg.layer_kinds) == 62 and wrapped >= 4
                  and r["state_peak"] == b_local * grant,
                  f"{tag} {cfg.name}: 62 layers, at least four prompts past "
                  f"the {ring}-slot rings ({wrapped}), the slots held "
                  f"{grant} CLS_STATE blocks each at the peak "
                  f"({r['state_peak']})")
            phase(f"{tag} {cfg.name}: {cfg.n_layers} layers, "
                  f"{cfg.n_layers - r['n_layers']} of them local (window "
                  f"{cfg.window}, rings of {ring} slots, torch ops); "
                  f"{wrapped} prompts wrap their rings; peak CLS_STATE "
                  f"blocks in use {r['state_peak']} ({b_local} slots x "
                  f"{grant})")
        phase(f"{tag} {cfg.name} on {smi}: {r['tok_s']:.1f} generated "
              f"tok/s, {r['ms_step']:.2f} ms/step, peak "
              f"max_memory_allocated serving "
              f"{r['peak_bytes'] / 2**30:.2f} GiB (drawing the weights "
              f"{r['init_peak_bytes'] / 2**30:.2f} GiB), {r['n_params']} "
              f"parameters, init {r['init_s']:.1f} s")
        out[cfg.name] = r
    gc.collect()
    torch.cuda.empty_cache()
    return out


def time_k2_groups(ops, rng, b_local, maxp, P, base):
    """Phase 23 (e): K2's tma route at phi4-mini-3.8b's widths (G 3) and
    llama4-maverick's (G 5), hd 128, pages of 64, at ``base`` + 1
    contexts (phase 15's), beside its fma kernel on the same inputs, its
    bytes bound, its plain version and SDPA on dense K/V, over 8 layers
    of pools.  Returns the times by model."""
    from repro_torch.configs import get_config

    out = {}
    for name in ("phi4-mini-3.8b", "llama4-maverick-400b-a17b"):
        cfg = dataclasses.replace(get_config(name), n_layers=8)
        G = cfg.n_heads // cfg.n_kv_heads
        check(ops.decode_route(cfg.tdtype, cfg.hd, cfg.page_size, G)
              == "tma", f"[23e] K2 at {name}'s width (G {G}) on its tma "
                        f"route")
        t = time_kernel(
            k2_launcher(ops, "tma"),
            lambda q, kp, table, b: ops.decode_bound_bytes(
                q[:, 0], kp, table, b + 1),
            lambda q, kp, vp, table, b: ops.paged_attention_ref(
                q[:, 0], kp, vp, table, b + 1, zero_empty=True),
            rng, cfg, b_local, maxp, P, 1, base,
            present=k2_launcher(ops, "fma"))
        t["shape"] = (f"T=1 B={b_local} H={cfg.n_heads} KH={cfg.n_kv_heads} "
                      f"hd={cfg.hd} psz={cfg.page_size} bf16, contexts "
                      f"{int(base.min()) + 1}-{int(base.max()) + 1}")
        phase(f"[23e] K2 (tma, G {G}) {t['shape']}: kernel {t['ms']:.4f} "
              f"ms (host {t['host_ms']:.4f} ms a call), the fma kernel on "
              f"the same inputs {t['present_ms']:.4f} ms (host "
              f"{t['present_host_ms']:.4f} ms a call), bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} B, "
              f"{t['flops']} flop), plain {t['plain_ms']:.4f} ms, library "
              f"(SDPA, dense K/V) {t['library_ms']:.4f} ms")
        out[name] = t
    return out


# ------------------------------------------------------------ phase 24

#: phase 24: the models trained at full width.  gemma3-27b and
#: llama4-maverick do not train on one card at any depth that runs K6
#: (ROADMAP Queue A)
TRAIN24 = ("llama3.2-1b", "phi4-mini-3.8b", "mixtral-8x7b")
#: phase 24: the depth each model's memory over its state is measured
#: at, one step (:func:`train_depth`)
OVERHEAD_DEPTH = 1
#: phase 24: the counted steps of each model, cut from phase 12's 5 to
#: keep the whole script near 1,000 s
TRAIN24_STEPS = 3
#: phase 24: the share of the card's free memory a training step's state
#: and overhead may fill at the depth :func:`train_depth` picks.  The rest
#: is for the caching allocator's fragmentation: phi4-mini-3.8b at 31
#: layers ran out of memory with 5.94 GiB of the card reserved but not
#: allocated (0.075 of it)
TRAIN_CARD_SHARE = 0.9
#: float32 bytes a parameter of the leaf ``adamw.apply`` updates that it
#: holds at once: the scaled gradient, m / bc1 and v / bc2
ADAMW_TEMP_BYTES = 12
#: the training state, bytes a parameter: bf16 weights and gradients,
#: float32 AdamW mu, nu and master copy
STATE_BYTES = 16
#: phase 24 (d): the float32 sequence, not a multiple of 64 (ragged
#: last tiles)
F32_TEXT = 120


def train_depth(cfg, free, over, tag):
    """Phase 24: the deepest of ``cfg``'s layers whose training state
    (``STATE_BYTES`` a parameter, ``count_params`` of ``model_defs`` at
    that depth) plus its overhead stays within ``TRAIN_CARD_SHARE`` of
    ``free``, the card's memory less what the process holds.  The
    overhead is ``over``, measured on the card at ``OVERHEAD_DEPTH``
    layers as the peak less what was held and the state, grown by the
    part of it that grows with depth: ``adamw.apply`` updates one leaf
    at a time and holds ``ADAMW_TEMP_BYTES`` of float32 temporaries a
    parameter of it, and a stacked layer leaf, which holds every
    layer's copy, may become the largest leaf (:func:`largest_leaf`).
    Prints the reckoning at that depth and at the next.  Returns the
    depth, 0 where not one layer fits, and its (state, overhead) in
    bytes."""
    from repro_torch.models.model import count_params

    def at(n):
        return dataclasses.replace(cfg, n_layers=n)

    def temps(n):
        return ADAMW_TEMP_BYTES * largest_leaf(at(n))

    def need(n):
        return (STATE_BYTES * count_params(at(n)),
                over + temps(n) - temps(OVERHEAD_DEPTH))

    limit = TRAIN_CARD_SHARE * free
    n = max((n for n in range(1, cfg.n_layers + 1) if sum(need(n)) <= limit),
            default=0)
    gib = 2 ** 30
    rows = []
    for m in (n, n + 1):
        if 1 <= m <= cfg.n_layers:
            state, o = need(m)
            rows.append(f"{m} layers: state {state / gib:.2f} GiB + overhead "
                        f"{o / gib:.2f} GiB (AdamW's temporaries "
                        f"{temps(m) / gib:.2f}) = {(state + o) / gib:.2f} GiB"
                        f"{' > ' if state + o > limit else ' <= '}"
                        f"{limit / gib:.2f}")
    phase(f"{tag} {cfg.name} depth by reckoning: {n} of {cfg.n_layers} "
          f"layers; state {STATE_BYTES} B a parameter (bf16 weights and "
          f"gradients, float32 AdamW mu, nu and master), overhead measured "
          f"on the card at {OVERHEAD_DEPTH} layer as peak - held - state "
          f"{over / gib:.2f} GiB (AdamW's temporaries of the largest leaf "
          f"{temps(OVERHEAD_DEPTH) / gib:.2f}); the limit "
          f"{TRAIN_CARD_SHARE:g} of "
          f"{free / gib:.2f} GiB free = {limit / gib:.2f} GiB; "
          + "; ".join(rows))
    return n, need(n) if n else None


def largest_leaf(cfg):
    """The parameter count of ``cfg``'s largest leaf (``model_defs``): a
    stacked layer leaf holds every group's copy."""
    import math

    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.transformer import model_defs

    return max(math.prod(d.shape) for d in tree_leaves(model_defs(cfg)))


def check_fresh_thread(k6, rng, B, H, KH, S, hd, tag):
    """Phase 24 (e): K6's wgmma forward and backward, each launched
    first thing on a new host thread (one that has made no CUDA call,
    as the autograd engine's worker thread is before its first launch,
    and whose TMA maps need a current context:
    ``hopper_common.cuh::bind_device``), bit-equal to the same calls on
    this thread."""
    import threading

    q, k, v = k6_inputs(rng, B, H, KH, S, hd, torch.bfloat16)
    do = torch.randn_like(q)
    o, lse = k6.flash_attention_cuda(q, k, v)
    want = (o, *k6.flash_attention_bwd_cuda(q, k, v, o, lse, do))
    got = {}

    def run(name, fn):
        try:
            got[name] = fn()
            torch.cuda.synchronize()
        except Exception as e:      # reported on this thread
            got[name] = e

    for name, fn in (
            ("forward", lambda: (k6.flash_attention_cuda(q, k, v)[0],)),
            ("backward", lambda: k6.flash_attention_bwd_cuda(
                q, k, v, o, lse, do))):
        t = threading.Thread(target=run, args=(name, fn))
        t.start()
        t.join()
        check(not isinstance(got[name], Exception),
              f"{tag} K6 {name} launched from a new thread: {got[name]}")
    check(all(torch.equal(a, b) for a, b in zip(
        got["forward"] + got["backward"], want)),
        f"{tag} K6 forward and backward from new threads bit-equal")
    phase(f"{tag} K6 wgmma forward and backward B={B} H={H} KH={KH} S={S} "
          f"hd={hd}, each launched first thing on a new host thread: "
          f"bit-equal to this thread's")


def check_k6_groups(k6, rng, cfgs):
    """Phase 24 (e): K6 at each of ``cfgs``' attention (llama3.2-1b's H
    32 over KH 8, G 4, hd 64; phi4-mini-3.8b's H 24 over KH 8, G 3, hd
    128), causal, S 2,048, B 1 (so that the plain version's dense
    float32 scores fit): the bf16 forward against its plain version
    (:func:`check_k6_forward`) and the wgmma backward against autograd
    through it and against its walk (:func:`check_k6_grad`); then
    launched from new threads (:func:`check_fresh_thread`).  Returns
    {name: errors}."""
    out = {}
    for c in cfgs:
        G = c.n_heads // c.n_kv_heads
        shape = (torch.bfloat16, 1, c.n_heads, c.n_kv_heads, 2048, c.hd, True)
        name = f"{c.name} (G={G})"
        fwd = check_k6_forward(k6, rng, name, *shape, tag="[24e]")
        bwd, twin = check_k6_grad(k6, rng, name, *shape, tag="[24e]")
        out[c.name] = dict(fwd=fwd, bwd=bwd, row=twin[0], ctrl=twin[1])
    c = cfgs[0]
    check_fresh_thread(k6, rng, 1, c.n_heads, c.n_kv_heads, 2048, c.hd,
                       "[24e]")
    return out


def train_three_archs(k6, counted, seed, smi):
    """Phase 24: llama3.2-1b, phi4-mini-3.8b and mixtral-8x7b train at
    their published widths through ``build_step`` as phase 12 trains
    olmo-1b (:func:`train_full_width`: 4 x 2,048 tokens, a warm-up and
    ``TRAIN24_STEPS`` counted steps): (e) first, K6 at the first two's
    attention against its plain version and its walk
    (:func:`check_k6_groups`); then for (a), (b), (c) each model one
    step at ``OVERHEAD_DEPTH`` layers, whose peak less its state gives
    the overhead, the depth :func:`train_depth` reckons from it, and the
    counted run at that depth (mixtral at its config's capacity factor,
    1.25, its drops printed; its windowed local layers launch no
    kernel); (d) llama3.2-1b
    and phi4-mini-3.8b in float32 at 2 layers, card against CPU
    (:func:`check_train_f32`); (f) K6's forward and backward times at
    B 4, S 2,048 at both models' attention, and its forward at
    phi-3-vision's (hd 96, H 32) at the same S, each beside its bound,
    its plain version and SDPA.  Returns the numbers the kernels line
    reports."""
    from repro_torch.configs import get_config

    rng = np.random.RandomState(seed + 24)
    fulls = [get_config(a) for a in TRAIN24]
    out = {"e": check_k6_groups(k6, rng, fulls[:2])}
    card = torch.cuda.get_device_properties(0).total_memory
    for x, full in zip("abc", fulls):
        tag = f"[24{x}]"
        r = train_full_width(
            dataclasses.replace(full, n_layers=OVERHEAD_DEPTH), seed,
            counted, smi, steps=1, turns=False,
            tag=f"{tag} (overhead at {OVERHEAD_DEPTH} layer)")
        over = r["peak"] - r["held"] - STATE_BYTES * r["n_params"]
        n, need = train_depth(full, card - r["held"], over, tag)
        check(n >= 1, f"{tag} {full.name}: one layer fits the card")
        r = train_full_width(dataclasses.replace(full, n_layers=n), seed,
                             counted, smi, steps=TRAIN24_STEPS, tag=tag,
                             turns=False)
        check(r["peak"] < card, f"{tag} {full.name}: peak under the card")
        got = r["peak"] - r["held"] - STATE_BYTES * r["n_params"]
        phase(f"{tag} {full.name} at {n} of {full.n_layers} layers on "
              f"{smi}: overhead measured {got / 2**30:.2f} GiB against "
              f"{need[1] / 2**30:.2f} reckoned")
        out[x] = dict(r, name=full.name)
    out["d"] = {a: check_train_f32(counted, seed, smi, a, tag="[24d]",
                                   text=F32_TEXT) for a in TRAIN24[:2]}
    out["f"] = {c.name: time_k6(k6, rng, c.n_heads, c.n_kv_heads, c.hd,
                                present=None) for c in fulls[:2]}
    phi = get_config("phi-3-vision-4.2b")
    out["f"]["hd96"] = time_k6_forward(k6, rng, 4, phi.n_heads,
                                       phi.n_kv_heads, 2048, phi.hd)
    for name, t in out["f"].items():
        for what, x, lib in (("forward", t.get("fwd", t), "SDPA"),
                             ("backward", t.get("bwd"), "SDPA's backward")):
            if x is None:
                continue
            phase(f"[24f] K6 {what} (wgmma/TMA) {t['shape']} on {smi}: "
                  f"kernel {x['ms']:.4f} ms (host {x['host_ms']:.4f} ms a "
                  f"call), bound {x['bound_ms']:.4f} ms ({x['bound_by']}: "
                  f"{x['flops']} flop, {x['bytes']} B), plain "
                  f"{x['plain_ms']:.4f} ms, library ({lib}) "
                  f"{x['library_ms']:.4f} ms")
    for x in "abc":
        r = out[x]
        phase(f"[24] {r['name']} training on {smi}: {r['n_layers']} layers, "
              f"{r['ms']:.1f} ms a step, {r['tok_s']:.0f} tokens/s, "
              f"{100 * r['mfu']:.1f}% model flops, peak "
              f"{r['peak'] / 2**30:.2f} GiB of {card / 2**30:.2f}; K6 "
              f"{r['launches']}, its backward {r['bwd_launches']}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also serve the workload again under "
                         "torch.profiler and print where the time goes")
    args = ap.parse_args()
    # one card, set before CUDA starts
    os.environ["CUDA_VISIBLE_DEVICES"] = (CALLER_CARDS or "0").split(",")[0]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as k6
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import \
        paged_attention_chunk_ref as plain
    from repro_torch.kernels.paged_attention.ref import \
        paged_attention_ref as plain2
    from repro_torch.kernels.rg_lru import ops as k5
    from repro_torch.kernels.rg_lru.ref import rg_lru_ref
    from repro_torch.kernels.ssd_scan import ops as k4
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.kernels.verify_attention import ops as k3
    from repro_torch.kernels.verify_attention.schedule import (
        build_verify_schedule, build_verify_units)
    from repro_torch.serving import engine as tengine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(n, what):
        """A phase's seconds, on a line of its own, beside the process's
        host memory (VmRSS) and the card's ``memory_allocated``."""
        now = time.perf_counter()
        phase(f"[{n}] {what} in {now - t_lap[0]:.1f} s; VmRSS "
              f"{host_rss_bytes() / 1e9:.1f} GB, memory_allocated "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        t_lap[0] = now

    # [1] the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    check(torch.cuda.device_count() == 1, "one visible card")
    phase(f"[1] {smi}")
    phase(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{kind}, capability {torch.cuda.get_device_capability(0)}")
    lap(1, "the card")

    # [2] build the kernels from this checkout's sources, in parallel
    t0 = time.perf_counter()
    stems = ("paged_attention", "paged_attention_wgmma", "paged_decode",
             "paged_decode_tma", "verify_attention", "verify_attention_wgmma",
             "ssd_scan", "ssd_scan_wgmma", "ssd_step", "rg_lru", "rg_lru_tma",
             "flash_attention", "flash_attention_bwd",
             "flash_attention_bwd_wgmma")
    build.load_all(stems)
    for stem in stems:
        for name, line in ptxas_lines(build.logs.get(stem, "")):
            phase(f"[2] {stem} {name}: {line}")
    # K2's tma instances at G 3 and 5 (phi4-mini, llama4) do not spill:
    # read from the built library, so a reused build is held too
    usage = {kernel_name(k): v for k, v in
             build.resource_usage("paged_decode_tma").items()}
    for name in (f"k2_split<{hd},{g}>" for hd in (64, 96, 128)
                 for g in (3, 5)):
        got = usage.get(name)
        check(got is not None and got.get("STACK") == 0
              and got.get("LOCAL") == 0,
              f"[2] paged_decode_tma {name} built, no stack frame or local "
              f"memory (no spills): {got}")
        phase(f"[2] paged_decode_tma {name} (cuobjdump): {got['REG']} "
              f"registers, stack frame {got['STACK']} bytes, local "
              f"{got['LOCAL']} bytes")
    phase(f"[2] built {', '.join(stems)} in {time.perf_counter() - t0:.1f} "
          f"s into {build.BUILD_DIR}")
    lap(2, "the build")
    # [21] (a)'s dry run: host only, traced beside the card's phases
    dryrun_proc = start_dryrun()

    cfg = get_config("olmo-1b")
    cfg_smoke = smoke_config(cfg)
    b_local, max_len, chunk = 8, 2048, 64
    maxp = max_len // cfg.page_size
    from repro_torch.models.transformer import pool_class_specs
    P = pool_class_specs(cfg, b_local, max_len, chunk)[0].num_blocks + 1

    # [3] kernels vs plain versions
    rng = np.random.RandomState(args.seed)
    err = check_kernel(ops, plain, rng, cfg, cfg_smoke, b_local, maxp, P)
    # bf16 at olmo-1b's widths, then phase 23's: llama3.2-1b (G 4, hd 64),
    # phi4-mini-3.8b (G 3), gemma3-27b (G 2, 16 KV heads), llama4 (G 5)
    widths = (cfg, *(c for _, c, _, _ in phase23_configs()))
    # streams of their own
    err2, err2_g = check_k2(ops, plain2,
                            np.random.RandomState(args.seed + 23), widths,
                            cfg_smoke, b_local, maxp, P)
    err3 = check_k3(k3, ops, plain, rng, cfg, cfg_smoke, b_local, maxp, P)
    err_routes, err1_g = check_wgmma_routes(
        k3, ops, plain, np.random.RandomState(args.seed + 3), widths)
    err, err3 = (max(err, err_routes["K1"]), max(err3, err_routes["K3"]))
    mamba, mamba_smoke = (get_config("mamba2-370m"),
                          smoke_config(get_config("mamba2-370m")))
    rgemma, rgemma_smoke = (get_config("recurrentgemma-2b"),
                            smoke_config(get_config("recurrentgemma-2b")))

    def ssd_dims(c, T):
        di = c.ssd_expand * c.d_model
        return (b_local, T, di // c.ssd_head_dim, c.ssd_head_dim,
                c.ssd_state)

    bf, f32 = torch.bfloat16, torch.float32
    n64 = ssd_dims(mamba, 64)[:4] + (64,)
    err4 = check_scan("K4", k4.ssd_scan, ssd_scan_ref, "ssd", [
        ("full T=1 bf16", ssd_dims(mamba, 1), bf),
        ("full T=64 bf16", ssd_dims(mamba, 64), bf),
        ("full T=1 f32", ssd_dims(mamba, 1), f32),
        ("full T=64 f32", ssd_dims(mamba, 64), f32),
        ("smoke T=8 f32", ssd_dims(mamba_smoke, 8), f32),
        ("smoke T=1 f32", ssd_dims(mamba_smoke, 1), f32),
        ("full T=3 bf16", ssd_dims(mamba, 3), bf),
        ("full T=16 bf16", ssd_dims(mamba, 16), bf),
        ("full T=100 bf16 (a masked last chunk)", ssd_dims(mamba, 100), bf),
        ("full T=200 bf16 (four chunks)", ssd_dims(mamba, 200), bf),
        ("T=64 N=64 bf16", n64, bf)], rng,
        route_of=lambda d, dt: k4.scan_route(dt, d[1], d[3], d[4]))
    # the step route at every slice count, beside the fma kernel; a stream
    # of its own: the later phases draw the inputs they drew
    err_step, err_fma = check_k4_step(
        k4, ssd_scan_ref, np.random.RandomState(args.seed + 29),
        [ssd_dims(mamba, 1), ssd_dims(mamba, 1)[:4] + (64,)])
    err4["step"] = max(err4["step"], err_step)
    err4["fma"] = max(err4["fma"], err_fma)
    # K5's a and b are float32 in a bf16 model too
    err5 = check_scan("K5", k5.rg_lru, rg_lru_ref, "rglru", [
        ("full T=1 f32", (b_local, 1, rgemma.d_model), f32),
        ("full T=64 f32", (b_local, 64, rgemma.d_model), f32),
        ("smoke T=8 f32", (b_local, 8, rgemma_smoke.d_model), f32),
        ("S=200 d=192 f32", (b_local, 200, 192), f32)], rng,
        route_of=lambda d, dt: k5.lru_route(d[1], d[2]), exact=True)
    # a stream of its own: the later phases draw the inputs they drew
    check_k5_tma(k5, rg_lru_ref, np.random.RandomState(args.seed + 5),
                 [(T, d) for d in (rgemma.d_model, 192)
                  for T in (3, 16, 64, 100, 200)])
    err6, err6b, row6b, ctrl6b = check_k6(k6, rng)
    # a stream of its own: the later phases draw the inputs they drew
    err19 = check_encdec_kernels(k6, ops, k3, plain, plain2,
                                 np.random.RandomState(args.seed + 24),
                                 b_local, maxp, P)
    lap(3, "kernels against their plain versions")

    # [4] the engine on the card vs on the CPU, small input
    check_engine_vs_cpu(tengine, cfg_smoke, args.seed)
    check_spec_engine_vs_cpu(tengine, k3, cfg_smoke, args.seed)
    check_pins_engine_vs_cpu(tengine, cfg_smoke, args.seed)
    check_sampled_engine_vs_cpu(tengine, cfg_smoke, args.seed)
    check_crash_engine_vs_cpu(tengine, cfg_smoke, args.seed)
    for c in (rgemma_smoke, mamba_smoke):
        check_engine_vs_cpu(tengine, c, args.seed, name=f"{c.name} engine "
                            f"(two size classes)", size_classes=2)
    check_moe_engine_vs_cpu(tengine, args.seed)
    for arch in ("whisper-tiny", "phi-3-vision-4.2b"):
        for sc in (1, 2):
            check_engine_vs_cpu(tengine, smoke_config(get_config(arch)),
                                args.seed, name=f"{arch} smoke engine ({sc} "
                                f"size class{'es' if sc > 1 else ''})",
                                size_classes=sc)
    for c in (cfg_smoke, mamba_smoke, rgemma_smoke):
        check_train_vs_cpu(c, args.seed)
        check_train_loop(c, args.seed)
    lap(4, "the card against the CPU")

    # [5] the plain path at full width
    counted = {"K1": ops.paged_attention_chunk, "K2": ops.paged_attention,
               "K3": k3.verify_attention, "K4": k4.ssd_scan,
               "K5": k5.rg_lru, "K6": k6.flash_attention,
               "K6 backward": k6.flash_attention_bwd}
    run1 = serve_full_width(
        "[5]", tengine, counted, "K1", cfg, args.seed, b_local, max_len,
        chunk, make_requests(tengine, cfg, args.seed),
        profile_reqs=make_requests(tengine, cfg, args.seed + 1)
        if args.profile else None)
    lap(5, "the plain path at full width")

    # [6] K1 timings at the serving shapes: decode (T=1) at the contexts
    # the run reached, and a prefill chunk (T=64)
    def k1_call(*inputs):
        return lambda: ops.paged_attention_chunk_cuda(*inputs)

    def k1_present(*inputs):
        return lambda: ops.paged_attention_chunk_cuda(*inputs, route="fma")

    base1 = rng.randint(64 + 32, 1024 + 64, b_local)
    base64 = rng.randint(0, 1024 - 64, b_local) // 64 * 64
    t1 = time_kernel(k1_call, ops.bound_bytes, plain, rng, cfg, b_local,
                     maxp, P, 1, base1, present=k1_present)
    t64 = time_kernel(k1_call, ops.bound_bytes, plain, rng, cfg, b_local,
                      maxp, P, 64, base64, present=k1_present)
    for t in (t1, t64):
        phase(f"[6] K1 T={t['T']} B={b_local} H={cfg.n_heads} hd={cfg.hd} "
              f"psz={cfg.page_size} bf16 on {smi}: kernel (wgmma route) "
              f"{t['ms']:.4f} ms (host {t['host_ms']:.4f} ms a call), "
              f"present kernel (fma route) {t['present_ms']:.4f} ms (host "
              f"{t['present_host_ms']:.4f} ms a call), bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}: "
              f"{t['bytes']} B, {t['flops']} flop), plain "
              f"{t['plain_ms']:.4f} ms, library (SDPA, dense K/V) "
              f"{t['library_ms']:.4f} ms")
    phase(f"[6] end-to-end decode on {smi}: {run1['tok_s']:.1f} generated "
          f"tok/s")
    lap(6, "K1 timings")

    # [7] the speculative path at full width
    spec = serve_speculative(tengine, k3, ops, cfg, args.seed, b_local,
                             max_len, chunk)
    lap(7, "the speculative path")

    # [8] K3 timings: a verify step (T=5) of lanes past a shared
    # 512-token prompt, and a 64-token chunk after it
    work = torch.empty(k3.workspace_numel(b_local, 64, cfg.n_heads, cfg.hd,
                                          maxp), device="cuda")

    def k3_call(route):
        def make(q, kp, vp, table, base):
            T, G = q.shape[1], q.shape[2] // kp.shape[2]
            sched = build_verify_schedule(table, base, T, kp.shape[1])
            units = (build_verify_units(sched[0], T, G) if route == "wgmma"
                     else None)
            return lambda: k3.verify_attention_cuda(q, kp, vp, table, base,
                                                    sched, work, units, route)
        return make

    v5 = time_kernel(k3_call("wgmma"), k3.bound_bytes, plain, rng, cfg,
                     b_local, maxp, P, 5,
                     rng.randint(512 + 32, 512 + 192, b_local), hot=8,
                     present=k3_call("fma"), split=True)
    v64 = time_kernel(k3_call("wgmma"), k3.bound_bytes, plain, rng, cfg,
                      b_local, maxp, P, 64, rng.randint(512, 576, b_local),
                      hot=8, present=k3_call("fma"), split=True)
    for t in (v5, v64):
        partials, merge = (sum(v for k, v in t["split"].items() if name in k)
                           for name in ("k3_wgmma", "k3_merge"))
        check(partials > 0 and merge > 0, "K3: the profiler saw its partials "
                                          "and merge kernels")
        t["profiled_ms"] = {"partials": partials, "merge": merge}
        phase(f"[8] K3 T={t['T']} B={b_local} H={cfg.n_heads} hd={cfg.hd} "
              f"psz={cfg.page_size} bf16, 8 shared prefix pages, on {smi}: "
              f"kernel (wgmma route) {t['ms']:.4f} ms (host "
              f"{t['host_ms']:.4f} ms a call; under the profiler the "
              f"partials kernel {partials:.4f} ms and the merge "
              f"{merge:.4f} ms a call), present kernel (fma route) "
              f"{t['present_ms']:.4f} ms (host {t['present_host_ms']:.4f} ms "
              f"a call), bound {t['bound_ms']:.4f} ms ({t['bound_by']}: "
              f"{t['bytes']} B, distinct pages; {t['flops']} flop), plain "
              f"{t['plain_ms']:.4f} ms, library (SDPA, dense K/V) "
              f"{t['library_ms']:.4f} ms")
    lap(8, "K3 timings")

    # [9], [10] the recurrent paths at full width: mamba2-370m (K4) and
    # recurrentgemma-2b (K5, and ring attention in plain torch ops)
    def rgemma_requests(seed):
        return make_requests(tengine, rgemma, seed, hi=3000, n_long=4,
                             long_lo=rgemma.window + 1)

    run4 = serve_full_width(
        "[9]", tengine, counted, "K4", mamba, args.seed, b_local, 2048,
        chunk, make_requests(tengine, mamba, args.seed), size_classes=2,
        profile_reqs=make_requests(tengine, mamba, args.seed + 1)
        if args.profile else None)
    run5 = serve_full_width(
        "[10]", tengine, counted, "K5", rgemma, args.seed, b_local, 4096,
        chunk, rgemma_requests(args.seed), size_classes=2,
        profile_reqs=rgemma_requests(args.seed + 1) if args.profile
        else None)
    lap(10, "the recurrent paths at full width (phases 9 and 10)")

    # [11] K4 and K5 timings at the serving shapes: decode (T=1) and a
    # prefill chunk (T=64); bf16 activations as the model serves them
    def k4_bytes(a, h):
        return k4.bound_bytes(a[0], a[1], a[3], h)

    def k4_route(route):
        return lambda *a: k4.ssd_scan_cuda(*a, route=route)

    def k4_time(T, route, present=None, with_plain=True):
        return time_scan(
            "ssd", k4_route(route), ssd_scan_ref, k4_bytes,
            lambda a: k4.flops(a[0], a[3]), ssd_dims(mamba, T),
            mamba.n_layers, rng, bf, present=present,
            tensor_flops=(lambda a: k4.dual_flops(a[0], a[3]))
            if route == "wgmma" else None, with_plain=with_plain)

    check(k4.scan_route(bf, 1, mamba.ssd_head_dim, mamba.ssd_state) == "step"
          and k4.scan_route(bf, 64, mamba.ssd_head_dim,
                            mamba.ssd_state) == "wgmma",
          "K4: T = 1 on the step route, T = 64 on the wgmma route")
    # T = 1: the step route beside the fma kernel it replaced, on the
    # same inputs
    k4_times = [k4_time(1, "step", present=k4_route("fma")),
                k4_time(64, "wgmma", present=k4_route("fma"))]
    check(k4_times[0]["ms"] < k4_times[0]["present_ms"],
          "K4 at T = 1: the step route faster than the fma kernel on the "
          "same inputs")
    check(k4_times[1]["ms"] < k4_times[1]["present_ms"],
          "K4 at T = 64: the wgmma route faster than the fma kernel on the "
          "same inputs")
    # the practical floor of the step: one copy_ of a state's size (read
    # once, written once), cycling through as many states as layers
    states = [torch.empty(ssd_dims(mamba, 1)[0:1] + ssd_dims(mamba, 1)[2:],
                          device="cuda") for _ in range(2 * mamba.n_layers)]
    it_copy = iter(range(10 ** 9))

    def copy_state():
        i = 2 * (next(it_copy) % mamba.n_layers)
        states[i + 1].copy_(states[i])

    copy_ms = cuda_ms(copy_state, iters=4 * mamba.n_layers)[0]
    copy_bytes = 2 * states[0].numel() * 4
    del states
    # both routes at a few widths: where the wgmma route starts to pay
    k4_sweep = [k4_time(T, "wgmma", present=k4_route("fma"),
                        with_plain=False) for T in (2, 3, 4, 16)]
    def k5_route(route):
        return lambda *a: k5.rg_lru_cuda(*a, route=route)

    # K5's two routes on the same inputs at each T: the seq kernel (T = 1
    # on the serving path) and the tma route (T >= LRU_TMA_MIN_S); the
    # first and the last with the plain version
    k5_times = [time_scan("rglru", k5_route("tma"), rg_lru_ref,
                          lambda a, h: k5.bound_bytes(a[0], h),
                          lambda a: k5.flops(a[0]),
                          (b_local, T, rgemma.d_model), run5["n_layers"], rng,
                          f32, present=k5_route("seq"),
                          with_plain=T in (1, 64))
                for T in (1, 2, 4, 8, 16, 64)]
    check(k5_times[-1]["ms"] < k5_times[-1]["present_ms"],
          "K5 at T = 64: the tma route faster than the seq kernel on the "
          "same inputs")
    k4_shape = (f"B={b_local} H={ssd_dims(mamba, 1)[2]} "
                f"P={mamba.ssd_head_dim} N={mamba.ssd_state} bf16 x")
    t = k4_times[0]
    phase(f"[11] K4 T=1 {k4_shape} on {smi}: kernel (step route) "
          f"{t['ms']:.4f} ms (host "
          f"{t['host_ms']:.4f} ms a call, its enqueue {t['enqueue_ms']:.4f} "
          f"ms), present kernel (fma route) {t['present_ms']:.4f} ms (host "
          f"{t['present_host_ms']:.4f} ms a call, its enqueue "
          f"{t['present_enqueue_ms']:.4f} ms), bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}: {t['bytes']} B, {t['flops']} float32 flop), "
          f"plain {t['plain_ms']:.4f} ms, library: no single PyTorch call; "
          f"a copy_ of one state ({copy_bytes} B moved) {copy_ms:.4f} ms")
    t["copy_ms"] = copy_ms
    for t in k4_times[1:] + k4_sweep:
        b = t["bounds"]
        plain_txt = (f", plain {t['plain_ms']:.4f} ms"
                     if t["plain_ms"] is not None else "")
        phase(f"[11] K4 T={t['T']} {k4_shape} on {smi}: kernel (wgmma "
              f"route) {t['ms']:.4f} ms (host {t['host_ms']:.4f} ms a "
              f"call, its enqueue {t['enqueue_ms']:.4f} ms), present "
              f"kernel (fma route) {t['present_ms']:.4f} ms (host "
              f"{t['present_host_ms']:.4f} ms a call, its enqueue "
              f"{t['present_enqueue_ms']:.4f} ms); bounds: bytes "
              f"{b['bytes_ms']:.4f} ms ({t['bytes']} B), the dual form's "
              f"tensor-core operations {b['ops_ms']:.4f} ms "
              f"({t['tensor_flops']} flop), the sequential form's float32 "
              f"operations {b['f32_ops_ms']:.4f} ms ({t['flops']} flop): "
              f"{t['bound_by']} bind the wgmma route at "
              f"{t['bound_ms']:.4f} ms{plain_txt}; library: no single "
              f"PyTorch call")
    for t in k5_times:
        plain_txt = (f", plain {t['plain_ms']:.4f} ms"
                     if t["plain_ms"] is not None else "")
        takes = k5.lru_route(t["T"], rgemma.d_model)
        phase(f"[11] K5 T={t['T']} B={b_local} d={rgemma.d_model} f32 on "
              f"{smi}: tma route {t['ms']:.4f} ms (host {t['host_ms']:.4f} "
              f"ms a call, its enqueue {t['enqueue_ms']:.4f} ms), present "
              f"kernel (seq route) {t['present_ms']:.4f} ms (host "
              f"{t['present_host_ms']:.4f} ms a call) on the same inputs; "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} "
              f"B, {t['flops']} flop){plain_txt}, library: no single PyTorch "
              f"call; the dispatcher takes the {takes} route here "
              f"(LRU_TMA_MIN_S = {k5.LRU_TMA_MIN_S})")
    # end to end, in turns on one warm engine: every K4 launch through
    # the fma kernel; the wgmma route from SCAN_WGMMA_MIN_S tokens on,
    # T = 1 still on fma; and T = 1 on the step route too.  The first
    # two differ in the wgmma route alone, the last two in the step
    # route alone, served twice each in the order A B B A.
    scan_route, wgmma_from = k4.scan_route, k4.SCAN_WGMMA_MIN_S
    no_step_name = f"K4 (wgmma from T={wgmma_from})"
    step_name = f"K4 (step at T=1, wgmma from T={wgmma_from})"
    route_ab("[11]", tengine, mamba, args.seed, b_local, 2048, chunk, smi,
             {"K4 (fma)": k4_turn(k4, scan_route, 10 ** 9, False),
              no_step_name: k4_turn(k4, scan_route, wgmma_from, False),
              step_name: k4_turn(k4, scan_route, wgmma_from, True),
              None: k4_turn(k4, scan_route, wgmma_from, True)},
             ("K4 (fma)", no_step_name, step_name, step_name, no_step_name),
             size_classes=2)
    for name, r in (("mamba2-370m", run4), ("recurrentgemma-2b", run5)):
        phase(f"[11] end-to-end {name} on {smi}: {r['tok_s']:.1f} generated "
              f"tok/s, {r['ms_step']:.2f} ms/step")
    lap(11, "K4 and K5 timings and K4's routes in turns")

    # [12] the training path at full width, [13] K6 at its shape
    train = train_full_width(cfg, args.seed, counted, smi,
                             profile=args.profile)
    t6 = time_k6(k6, rng, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    for name, t, lib in (("forward (wgmma/TMA)", t6["fwd"], "SDPA, is_causal"),
                         ("backward (wgmma/TMA)", t6["bwd"],
                          "SDPA's backward through torch.autograd.grad")):
        phase(f"[13] K6 {name} B={t6['B']} H={cfg.n_heads} S={t6['S']} "
              f"hd={cfg.hd} causal bf16 on {smi}: kernel {t['ms']:.4f} ms "
              f"(host {t['host_ms']:.4f} ms a call), bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['flops']} flop, "
              f"{t['bytes']} B), plain {t['plain_ms']:.4f} ms, library "
              f"({lib}) {t['library_ms']:.4f} ms")
    t = t6["bwd"]
    phase(f"[13] K6 backward on the same inputs on {smi}: wgmma route "
          f"{t['ms']:.4f} ms, present kernel (mma.sync, "
          f"flash_attention_bwd.cu) {t['present_ms']:.4f} ms (host "
          f"{t['present_host_ms']:.4f} ms a call); in turns wgmma, mma, "
          f"mma, wgmma: {', '.join(f'{x:.4f}' for x in t['turns_ms'])} ms")
    lap(13, "training at full width and K6 timings (phases 12 and 13)")

    # [14] the serve entry point at full width, then preemption
    entry = serve_entry_point(counted, smi)
    preempting = check_preempting(tengine, counted, cfg, args.seed, smi)
    lap(14, "the serve entry point and preemption")

    # [15] K2 and K1 at T = 1 on the same inputs (decode at contexts of
    # 96-1,087 tokens), beside K2's bound, plain version and SDPA
    def k2_plain(q, kp, vp, table, base):
        return plain2(q[:, 0], kp, vp, table, base + 1, zero_empty=True)

    def k2_bytes(q, kp, table, base):
        return ops.decode_bound_bytes(q[:, 0], kp, table, base + 1)

    base15 = np.random.RandomState(args.seed + 15).randint(96, 1088, b_local)
    check(ops.decode_route(bf, cfg.hd, cfg.page_size,
                           cfg.n_heads // cfg.n_kv_heads) == "tma",
          "K2: olmo-1b's decode on the tma route")
    t2 = time_kernel(k2_launcher(ops, "tma"), k2_bytes, k2_plain,
                     np.random.RandomState(args.seed + 15), cfg, b_local,
                     maxp, P, 1, base15, present=k2_launcher(ops, "fma"),
                     variants={f"pages_per_split={n}":
                               k2_launcher(ops, "tma", n) for n in (1, 2, 8)})
    check(t2["ms"] < t2["present_ms"], "K2: the tma route faster than the "
                                       "fma kernel on the same inputs")
    t2k1 = time_kernel(k1_call, ops.bound_bytes, plain,
                       np.random.RandomState(args.seed + 15), cfg, b_local,
                       maxp, P, 1, base15)
    for name, t in (("K2 (tma route)", t2), ("K1 at T=1, same inputs "
                                             "(wgmma route)", t2k1)):
        phase(f"[15] {name} B={b_local} H={cfg.n_heads} hd={cfg.hd} "
              f"psz={cfg.page_size} bf16 on {smi}: kernel {t['ms']:.4f} ms "
              f"(host {t['host_ms']:.4f} ms a call, its enqueue "
              f"{t['enqueue_ms']:.4f} ms), bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} B, "
              f"{t['flops']} flop), plain {t['plain_ms']:.4f} ms, library "
              f"(SDPA, dense K/V) {t['library_ms']:.4f} ms")
    phase(f"[15] K2 on the same inputs on {smi}: present kernel (fma "
          f"route) {t2['present_ms']:.4f} ms (host "
          f"{t2['present_host_ms']:.4f} ms a call, its enqueue "
          f"{t2['present_enqueue_ms']:.4f} ms); tma route with "
          f"pages_per_split={ops.PAGES_PER_SPLIT} {t2['ms']:.4f} ms, "
          + ", ".join(f"{n} {ms:.4f} ms" for n, (ms, _) in
                      t2["variants"].items()))
    decode_route_ab(tengine, ops, cfg, args.seed, b_local, max_len, chunk,
                    smi)
    phase(f"[15] end-to-end on {smi}: entry point {entry['tok_s']:.1f} "
          f"generated tok/s; preempting run (bf16) "
          f"{preempting['tokens_out'] / preempting['wall']:.1f} tok/s")
    lap(15, "K2 timings and its routes in turns")

    # [16] sampled serving and crash recovery at full width
    sampled = serve_sampled(tengine, counted, cfg, args.seed, b_local,
                            max_len, chunk, run1, smi)
    check_sampled_f32(tengine, k3, ops, counted, cfg, args.seed, b_local,
                      max_len, chunk, smi)
    chaos16 = serve_chaos_entry_point(counted, smi)
    check_crash_f32(tengine, cfg, args.seed, b_local, max_len, chunk, smi)
    lap(16, "sampled serving and recovery")
    # [17] expert-paged MoE serving, mixtral-8x7b at full width
    serve_moe(tengine, counted, args.seed, smi)
    lap(17, "expert-paged MoE serving")
    # [18] training and prefill of the recurrent decoders at full width
    train18 = {c.name: train_recurrent_full_width(
        f"[18{x}]", c, args.seed, counted, smi, profile=args.profile)
        for x, c in (("a", mamba), ("b", rgemma))}
    prefill18 = {c.name: prefill_full_width(
        "[18d]", tengine, counted, c, args.seed, n, plen, smi)
        for c, n, plen in ((mamba, 8, 512), (rgemma, 4, 2304))}
    for name, r in train18.items():
        phase(f"[18] {name} training on {smi}: {r['ms']:.1f} ms a step, "
              f"{r['tok_s']:.0f} tokens/s, {100 * r['mfu']:.1f}% model "
              f"flops, peak {r['peak'] / 2**30:.2f} GiB; prefill path "
              f"logits within {prefill18[name]['err']:.3e} of the one-shot "
              f"forward, {prefill18[name]['same']} streams equal to the "
              f"engine's")
    lap(18, "recurrent training and prefill")
    # [19] encoder-decoder and VLM serving at full width
    r19 = serve_encdec_vlm(tengine, k6, ops, plain, counted, args.seed, smi,
                           b_local, maxp, P, chunk)
    lap(19, "encoder-decoder and VLM serving")
    # [20] the DP allocation plane: one rank per DP shard
    r20 = serve_dp_ranks(tengine, counted, cfg, cfg_smoke, args.seed,
                         b_local, max_len, chunk, smi)
    lap(20, "the DP allocation plane on ranks")
    # [21] the dry run of phase 12's step, and core/kv_cache.py
    check_dryrun(dryrun_proc, train, smi)
    check_kv_cache(args.seed, smi)
    lap(21, "the dry run against phase 12, kv_cache on the card")
    # [22] phi-3-vision and whisper-tiny training at full width
    r22 = train_vlm_encdec(k6, counted, args.seed, smi,
                           profile=args.profile)
    lap(22, "phi-3-vision and whisper-tiny training at full width")
    # [23] four more architectures at full width, and K2 at G 3 and 5
    r23 = serve_four_archs(tengine, counted, args.seed, smi, b_local,
                           max_len, chunk)
    t23 = time_k2_groups(ops, np.random.RandomState(args.seed + 230),
                         b_local, maxp, P, base15)
    lap(23, "llama3.2-1b, phi4-mini-3.8b, gemma3-27b and llama4-maverick "
            "serving at full width, K2 at G 3 and 5")
    # [24] three more models train at full width: K6 at G 4 and G 3
    r24 = train_three_archs(k6, counted, args.seed, smi)
    lap(24, "llama3.2-1b, phi4-mini-3.8b and mixtral-8x7b training at "
            "full width, K6 at G 4 and 3")
    s16 = sampled["runs"][0]
    sampled_launches = {
        "K1": s16["launches"], "K2": s16["k2"],
        "entry_point_with_faults": {"K1": chaos16["k1"],
                                    "K2": chaos16["k2"]}}

    def row(name, src, replaces, n, e, t, t_other, shape, present=None):
        """A kernel's entry; ``present``: the source of the kernel its
        wgmma route replaced, which still takes the other shapes, with
        that kernel's times on the same inputs."""
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        out = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": n, "max_abs_err": e,
               **{k: t[k] for k in keys}, "shape": shape,
               f"t{t_other['T']}": {k: t_other[k] for k in keys}}
        if present is not None:
            out["routes"] = {"wgmma": src, "fma": present}
            out["present_kernel"] = {
                "source": present, **{f"t{x['T']}": {
                    "ms": x["present_ms"], "host_ms": x["present_host_ms"],
                    "wgmma_host_ms": x["host_ms"]} for x in (t, t_other)}}
        for x in (t, t_other):
            if "profiled_ms" in x:
                out[f"t{x['T']}_profiled_ms"] = x["profiled_ms"]
        return out

    shape = (f"B={b_local} H={cfg.n_heads} hd={cfg.hd} psz={cfg.page_size} "
             f"bf16")
    pa_src = "src/repro_torch/kernels/paged_attention/csrc/"
    ssd_src = "src/repro_torch/kernels/ssd_scan/csrc/"
    lru_src = "src/repro_torch/kernels/rg_lru/csrc/"
    fa_src = "src/repro_torch/kernels/flash_attention/csrc/"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "host_ms")
    kernels = [
        {"name": "paged_attention", "route": "cuda",
         "source": pa_src + "paged_decode_tma.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:227",
         "launches": entry["k2"], "max_abs_err": err2,
         **{k: t2[k] for k in keys},
         "shape": f"T=1 {shape}, contexts 97-1088",
         "routes": {"tma": pa_src + "paged_decode_tma.cu",
                    "fma": pa_src + "paged_decode.cu"},
         "pages_per_split": ops.PAGES_PER_SPLIT,
         "present_kernel": {"source": pa_src + "paged_decode.cu",
                            "ms": t2["present_ms"],
                            "host_ms": t2["present_host_ms"]},
         "k1_same_inputs": {k: t2k1[k] for k in ("ms", "plain_ms",
                                                 "bound_ms", "library_ms")},
         "sampled_launches": sampled_launches["K2"]},
        row("paged_attention_chunk",
            "src/repro_torch/kernels/paged_attention/csrc/"
            "paged_attention_wgmma.cu",
            "src/repro/kernels/paged_attention/kernel.py:171",
            run1["launches"], err, t1, t64, f"T=1 {shape}",
            "src/repro_torch/kernels/paged_attention/csrc/"
            "paged_attention.cu"),
        row("verify_attention",
            "src/repro_torch/kernels/verify_attention/csrc/"
            "verify_attention_wgmma.cu",
            "src/repro/kernels/verify_attention/kernel.py:173", spec["k3"],
            err3, v5, v64, f"T=5 {shape}, 8 shared prefix pages",
            "src/repro_torch/kernels/verify_attention/csrc/"
            "verify_attention.cu"),
        *({"name": name, "route": "cuda", "source": ssd_src + src,
           "replaces": "src/repro/kernels/ssd_scan/kernel.py:93",
           "launches": run4["k4_routes"][route], "max_abs_err": err4[route],
           **{k: t[k] for k in keys}, "bounds": t["bounds"],
           "scan_route": route,
           "shape": f"T={t['T']} B={b_local} H={ssd_dims(mamba, 1)[2]} "
                    f"P={mamba.ssd_head_dim} N={mamba.ssd_state} bf16",
           **({"present_kernel": {"source": ssd_src + "ssd_scan.cu",
                                  "ms": t["present_ms"],
                                  "host_ms": t["present_host_ms"]}}
              if "present_ms" in t else {})}
          for name, src, route, t in (
              ("ssd_scan_wgmma", "ssd_scan_wgmma.cu", "wgmma", k4_times[1]),
              ("ssd_step", "ssd_step.cu", "step", k4_times[0]),
              ("ssd_scan", "ssd_scan.cu", "fma",
               {**{k: v for k, v in k4_times[0].items()
                   if not k.startswith("present")},
                "ms": k4_times[0]["present_ms"],
                "host_ms": k4_times[0]["present_host_ms"]}))),
        *({"name": name, "route": "cuda", "source": lru_src + src,
           "replaces": "src/repro/kernels/rg_lru/kernel.py:67",
           "launches": run5["k5_routes"][route], "max_abs_err": err5[route],
           **t, "bound_ms": t5["bound_ms"], "bound_by": t5["bound_by"],
           "library_ms": None, "lru_route": route,
           "shape": f"T={t5['T']} B={b_local} d={rgemma.d_model} f32",
           **extra}
          for name, src, route, t5, t, extra in (
              ("rg_lru_tma", "rg_lru_tma.cu", "tma", k5_times[-1],
               {k: k5_times[-1][k] for k in ("ms", "plain_ms", "host_ms")},
               {"present_kernel": {"source": lru_src + "rg_lru.cu",
                                   "ms": k5_times[-1]["present_ms"],
                                   "host_ms":
                                       k5_times[-1]["present_host_ms"]}}),
              ("rg_lru", "rg_lru.cu", "seq", k5_times[0],
               {"ms": k5_times[0]["present_ms"],
                "plain_ms": k5_times[0]["plain_ms"],
                "host_ms": k5_times[0]["present_host_ms"]}, {}))),
        *({"name": name, "route": "cuda", "source": fa_src + src,
           "replaces": replaces, "launches": n, "max_abs_err": e,
           **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "host_ms")},
           "shape": f"B={t6['B']} H={cfg.n_heads} S={t6['S']} hd={cfg.hd} "
                    f"causal bf16", **extra}
          for name, src, replaces, n, e, t, extra in (
              ("flash_attention", "flash_attention.cu",
               "src/repro/kernels/flash_attention/kernel.py:80",
               train["launches"], err6, t6["fwd"], {}),
              ("flash_attention_bwd", "flash_attention_bwd_wgmma.cu",
               "src/repro/models/attention.py:53",
               train["bwd_launches"], err6b, t6["bwd"],
               {"routes": {"wgmma": fa_src + "flash_attention_bwd_wgmma.cu",
                           "mma": fa_src + "flash_attention_bwd.cu",
                           "f32": fa_src + "flash_attention_bwd.cu"},
                "row_scaled_err": row6b, "control_row_scaled_err": ctrl6b,
                "present_kernel": {
                    "source": fa_src + "flash_attention_bwd.cu",
                    "ms": t6["bwd"]["present_ms"],
                    "host_ms": t6["bwd"]["present_host_ms"]}}))),
    ]
    kernels[1]["sampled_launches"] = sampled_launches["K1"]
    next(r for r in kernels if r["name"] == "ssd_step")["copy_ms"] = (
        k4_times[0]["copy_ms"])
    # phase 19: the instances at phi-3-vision's hd 96, and whisper-tiny's
    # launches on the routes olmo-1b takes
    phi19 = r19["d"]["phi-3-vision-4.2b"]
    times = ("ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    hd96 = {
        "paged_attention": dict(
            route="tma", source=pa_src + "paged_decode_tma.cu",
            launches=r19["b"]["k2"] + phi19["k2_routes"]["tma"],
            launches_by_route={
                r: phi19["k2_routes"][r] + (r19["b"]["k2"] if r == "tma"
                                            else 0)
                for r in phi19["k2_routes"]},
            max_abs_err=err19["K2"], shape=f"T=1 B={b_local} H=32 hd=96 "
                                           f"psz=64 bf16",
            present_kernel=dict(
                source=pa_src + "paged_decode.cu",
                ms=r19["times"]["K2"]["present_ms"],
                host_ms=r19["times"]["K2"]["present_host_ms"],
                max_abs_err=err19["K2 fma"])),
        "paged_attention_chunk": dict(
            route="wgmma", source=pa_src + "paged_attention_wgmma.cu",
            launches=phi19["k1_routes"]["wgmma"],
            launches_by_route=phi19["k1_routes"], max_abs_err=err19["K1"],
            shape=f"T=64 B={b_local} H=32 hd=96 psz=64 bf16",
            present_kernel=dict(
                source=pa_src + "paged_attention.cu",
                ms=r19["times"]["K1"]["present_ms"],
                host_ms=r19["times"]["K1"]["present_host_ms"],
                max_abs_err=err19["K1 fma"])),
        "flash_attention": dict(
            route="wgmma", source=fa_src + "flash_attention.cu",
            launches=r19["b"]["k6"],
            launches_by_route={r19["b"]["k6_route"]: r19["b"]["k6"]},
            max_abs_err=err19["K6"], shape=r19["times"]["K6"]["shape"],
            present_kernel=dict(
                source=fa_src + "flash_attention.cu", route="mma",
                ms=r19["times"]["K6"]["present_ms"],
                host_ms=r19["times"]["K6"]["present_host_ms"],
                max_abs_err=err19["K6 mma"]))}
    for row_ in kernels:
        if row_["name"] in hd96:
            key = {"paged_attention": "K2", "paged_attention_chunk": "K1",
                   "flash_attention": "K6"}[row_["name"]]
            row_["hd96"] = {**hd96[row_["name"]],
                            **{k: r19["times"][key][k] for k in times}}
    whisper19 = r19["d"]["whisper-tiny"]
    kernels[0]["whisper_tiny_launches"] = whisper19["k2_routes"]
    kernels[1]["whisper_tiny_launches"] = whisper19["k1_routes"]
    next(r for r in kernels if r["name"] == "flash_attention")[
        "whisper_tiny_launches"] = {r19["a"]["k6_route"]: r19["a"]["k6"]}
    # phase 22: the backward at hd 96 (phi-3-vision's training, the
    # entry point, the float32 check) and at whisper-tiny's shapes
    t22 = {k: {**{x: t["bwd"][x] for x in times}, "shape": t["shape"]}
           for k, t in r22["f"].items()}
    next(r for r in kernels if r["name"] == "flash_attention")[
        "training_launches"] = {
        name: {"launches": r["launches"], **dict(zip(
            ("by_route", "by_mask"), r["by_route_and_mask"]["forward"]))}
        for name, r in (("phi-3-vision-4.2b", r22["a"]),
                        ("whisper-tiny", r22["c"]))}
    bwd_row = next(r for r in kernels if r["name"] == "flash_attention_bwd")
    bwd_row["hd96"] = dict(
        route="wgmma", source=fa_src + "flash_attention_bwd_wgmma.cu",
        launches=r22["a"]["bwd_launches"],
        launches_entry_point=r22["b"]["bwd_launches"],
        entry_point_layers=r22["b"]["n_layers"],
        max_abs_err=r22["e"]["wgmma"], row_scaled_err=r22["e"]["row"],
        control_row_scaled_err=r22["e"]["ctrl"], **t22["phi"],
        s640=t22["phi_s640"],
        f32=dict(source=fa_src + "flash_attention_bwd.cu",
                 launches=r22["d"]["bwd_launches"],
                 max_abs_err=r22["e"]["f32"],
                 train_grad_rel_err=r22["d"]["err"]))
    bwd_row["whisper_tiny"] = dict(
        route="wgmma", launches=r22["c"]["bwd_launches"],
        launches_by_mask=r22["c"]["by_route_and_mask"]["backward"][1],
        max_abs_err=r22["e"]["whisper"], **t22["whisper"])
    dp_launches = {f"rank{d}": {k: b["launches"][k] for k in ("K1", "K2")}
                   for d, b in enumerate(r20["ranks"])}
    for row_, key in ((kernels[0], "K2"), (kernels[1], "K1")):
        row_["dp_ranks_launches"] = {
            "gloo_one_card": {r: n[key] for r, n in dp_launches.items()},
            "gloo_one_card_faults": {f"rank{d}": n[key] for d, n in
                                     enumerate(r20["faults"])},
            "gloo_one_card_faults_f32": {f"rank{d}": n[key] for d, n in
                                         enumerate(r20["faults_f32"])},
            "nccl": None if r20["nccl"] is None else {
                f"rank{d}": b["launches"][key]
                for d, b in enumerate(r20["nccl"])}}
    # phase 23: every model's K1 and K2 launches, and K2's G 3 and 5
    # instances at phi4-mini-3.8b's and llama4-maverick's widths
    kernels[0]["phase23_launches"] = {
        name: {"launches": r["k2"], "by_route": r["k2_routes"]}
        for name, r in r23.items()}
    kernels[1]["phase23_launches"] = {
        name: {"launches": r["launches"], "by_route": r["k1_routes"]}
        for name, r in r23.items()}
    for row_, errs in ((kernels[0], err2_g), (kernels[1], err1_g)):
        row_["phase23_max_abs_err"] = {name: errs[name] for name in r23}
    kernels[0]["odd_g"] = {
        name: dict(route="tma", source=pa_src + "paged_decode_tma.cu",
                   launches=r23[name]["k2_routes"]["tma"],
                   max_abs_err=err2_g[name], shape=t["shape"],
                   **{k: t[k] for k in times},
                   present_kernel=dict(source=pa_src + "paged_decode.cu",
                                       ms=t["present_ms"],
                                       host_ms=t["present_host_ms"]))
        for name, t in t23.items()}
    # phase 24: K6's launches in each model's counted steps, its checks
    # and times at G 4 (hd 64) and G 3 (hd 128), and its forward at hd 96
    # at phi-3-vision's training S
    fa_row = next(r for r in kernels if r["name"] == "flash_attention")
    for row_, key, what in ((fa_row, "launches", "forward"),
                            (bwd_row, "bwd_launches", "backward")):
        row_["phase24_launches"] = {
            r["name"]: {"launches": r[key], "n_layers": r["n_layers"],
                        "k6_layers": r["k6_layers"], **dict(zip(
                            ("by_route", "by_mask"),
                            r["by_route_and_mask"][what]))}
            for r in (r24[x] for x in "abc")}
        row_["groups"] = {
            name: {"route": "wgmma", "shape": t["shape"],
                   "max_abs_err": r24["e"][name]["fwd" if what == "forward"
                                                 else "bwd"],
                   **{k: t["fwd" if what == "forward" else "bwd"][k]
                      for k in times},
                   **({} if what == "forward" else {
                       "row_scaled_err": r24["e"][name]["row"],
                       "control_row_scaled_err": r24["e"][name]["ctrl"]})}
            for name, t in r24["f"].items() if name != "hd96"}
    fa_row["hd96"]["s2048"] = {k: r24["f"]["hd96"][k]
                               for k in times + ("shape",)}
    bwd_row["phase24_f32"] = {
        name: {"launches": d["bwd_launches"], "train_grad_rel_err": d["err"],
               "loss_rel_err": d["loss_err"]}
        for name, d in r24["d"].items()}
    phase(f"[24] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())

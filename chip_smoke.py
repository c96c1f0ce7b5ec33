#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

  1. device and build — the card's name and power limit, the torch/CUDA
     versions, and an nvcc build of every kernel from the checkout's
     sources (one nvcc per source, all at once, timed);
  2. kernels vs their plain versions at the main paths' shapes —
     `sample_topk` on qwen3-0.6b's padded lm_head (152064 x 1024 bf16,
     valid 151936) for rows in {1, 8}, k in {1, 40}, a tie-heavy case,
     a softcap case, the speculative verifier's 40 rows at k 40, on
     recurrentgemma-9b's 256000 x 4096 head for rows in {1, 8} and k in
     {1, 40}, on xlstm-125m's 50432 x 768 head (valid 50304) and
     seamless-m4t-medium's 256256 x 1024 head (valid 256206: its last
     64-row tile 14 valid rows and 50 pads) for rows in {1, 8} and k in
     {1, 40}, and on V 32768 at d 4096 (paper-lm's
     width, 8 rows k 40), d 12288 (8 rows
     k 1) and d 16384 (40 rows k 40) (the decode kernel: two calls bit
     for bit, the device time of its stream and merge kernels apart under
     `torch.profiler`), and
     k = 1 at rows 128, 512 and 4096, a tie-heavy case (ids exact) and a
     softcap-30 + `col_offset` shard at 4096 rows (the many-row kernel,
     each also through the decode kernel's plan given explicitly), each
     timed with CUDA events beside its bound, its plain version and the
     `torch.topk(h @ w.T, k)` yardstick, and the request modes' steps
     on the decode kernel: a beam step (8 rows, k 8, ``return_lse``)
     and a constrained step (8 rows, k 1, a half-zero ``allowed_mask``),
     each held to its plain version (values and lse, every id allowed),
     twice for bit identity, the lse and an all-ones mask shown to leave
     the top-k's bits alone, and timed beside its bound, its plain
     version and the library's ``h @ w.T`` with ``masked_fill`` /
     ``logsumexp`` and ``torch.topk``; then
     the fused-CE forward, dH and dW kernels at the training shape
     (8192 rows against the same head) — plain, softcap 30, label
     smoothing 0.1 with z-loss 1e-4, 10% ignored rows — at phase 8 (c)'s
     4096 rows, at 1000
     rows with a shard offset, at d = 4096 (512 rows, V 32768) and at
     recurrentgemma-9b's training shape (4096 rows, d 4096, V 256000)
     and xlstm-125m's (8192 rows, d 768, V 50432: the backward's last
     CTA of four wholly past d) and seamless-m4t-medium's (4096 rows, d
     1024, V 256256 with 256206 valid: dW's 50 pad rows must be zero,
     as every case's pad rows), each
     held to its plain version (f32 logits, TF32 off), the forward, dH
     and dW run twice for bit identity, and timed beside
     its bound, the plain version and the canonical two-stage loss in
     PyTorch (``h @ w.T`` in cuBLAS, ``F.cross_entropy`` on f32 logits;
     cuBLAS's ``h @ w.T`` alone is printed beside it as a reading of what
     the card's own GEMM reaches),
     with the peak memory of both losses' forward + backward, and the
     backward kernels' `cudaOccupancyMaxActiveClusters` at clusters of 4
     (d 1024) and 16 (d 4096); then the
     gradient filter at the training shape: (i) the forward's tile
     statistic (10% ignored rows, and a 1000-row `col_offset` shard) with
     lse, z* and sum z bit for bit the call without it and tmax held to
     the plain version, -inf in the same places; (ii) the random problem
     at eps 1e-5: nothing skipped, the filtered dH / dW bit for bit the
     exact kernels (the gating's cost timed beside them); (iii) a peaked
     problem (h = 24 W[y] + 24 W[y2] + noise, `PEAK_A` / `PEAK_B`)
     skipping > 50% of the 64 x 64 tiles: the filtered kernels held to
     the plain version given the
     same mask, and within 2^-8 of the largest exact entry of the exact
     kernels' grads; (iv) an all-ignored batch: every tile skipped, dH =
     dW = 0 exactly.  Each prints the mask entries that flip between the
     kernel's and the plain tmax, and is timed beside its bound (the live
     share of the exact operations), the exact kernel, the plain version
     and the canonical loss (which computes the exact gradient);
  3. the main path at full width — qwen3-0.6b (28 layers, bf16, seeded
     random weights) served by `Engine(batch_size=8, max_len=512)` and a
     `ContinuousScheduler`: 16 requests with seeded prompt lengths
     16..200, 32 new tokens each, greedy.  The launch counters are zeroed
     just before the run and must show one `sample_topk` launch per
     prefill and per decode step; the first request is re-scored by one
     cache-free forward through the plain sampler, and each served token
     must be within a bf16 tolerance of that forward's best logit.
  4. training at full width — qwen3-0.6b (28 layers, bf16, seeded random
     init), `SyntheticLM` (seq 1024, batch 8), AdamW with the training
     CLI's defaults, ``loss_impl='kernel'``, 6 steps of `train_loop`.
     Step 0's loss and lm_head gradient through the kernels are first
     held to the same step through the canonical loss; the counters are
     zeroed just before the loop and must show one launch of each
     fused-CE kernel a step and no `sample_topk`; every loss finite and
     the last below the first.  Prints step ms p50 (steps 1-5), tokens/s
     and peak memory, and from one more step under `torch.profiler` the
     fused-CE kernels' device ms against the step's device-busy ms.
  5. paged serving at full width — the same qwen3-0.6b params as phase 3
     served by `PagedEngine(batch_size=8, max_len=512, block_size=16)`
     (a pool at slab parity, 257 blocks) with the prefix cache on: 16
     requests, each a shared 128-token system prompt plus a seeded
     8..64-token suffix, 32 new tokens each, greedy.  The counters are
     zeroed just before the run and must show 28 `paged_attn` launches a
     decode step and one `sample_topk` launch per prefill and per decode
     step; 15 prefix hits of the 8 shared blocks; every served token
     within the bf16 tolerance of a cache-free forward's best logit.
     Prints tokens/s, decode-step and prefill ms (cold and hit), TTFT,
     the prefill tokens saved, the live pool bytes against the pool's,
     and the share of tokens equal to the slab `Engine`'s on the same
     requests (printed, not gated: bf16 near-ties may flip).

  6. speculative serving at full width — the same seeded qwen3-0.6b with
     4 MTP heads attached (`with_mtp`), k 4: (a) `PagedSelfSpecEngine`
     in rejection mode (temperature 0.7, top_k 40) on phase 5's traffic,
     gated on 2 `score_tokens` and 2 `sample_topk` launches a step and
     1 and 2 a prefill, 28 `paged_attn` launches a step at Tq 5, 15
     prefix hits, ids below the vocab and 1..5 tokens a slot-step; (b)
     a slab `SpecEngine` in rejection mode with a 1-layer full-width
     draft (`small_draft`, d 1024) on phase 3's traffic, gated on 2
     `score_tokens` and K + 1 `sample_topk` launches a step.  In (a) and
     (b) every scoring call is recorded and must pass the vocab, softcap
     and sampling temperature of its model, and its logps must equal the
     plain version's on the same hidden states; (c) a slab
     `SelfSpecEngine`, greedy, on phase 3's traffic: no `score_tokens`
     launch, and every token within the bf16 tolerance of a cache-free
     forward's best logit (random heads are rejected almost always, so
     the rollback runs nearly every step).  Each prints tokens/s,
     spec-step ms p50, acceptance, tokens per slot-step and TTFT p50;
  7. loglikelihood eval at full width — `PagedEngine` with the prefix
     cache on, the phase-6 params: 8 seeded 128-token prompts x 4
     continuations of 8 tokens through `submit_eval`, gated on one
     `score_tokens` launch a continuation, no `sample_topk`, 24 prefix
     hits (3 a prompt), and every logp within 1e-4 of `log_softmax` of
     a cache-free forward's f32 logits over the valid columns, a limit
     that must lie below the reading of the same softmax over all the
     padded head's columns.  Prints tokens scored a second and prefill
     ms p50, cold and hit.

  8. filtered training, MTP heads and gradient accumulation at full
     width — phase 4's model, data and optimizer: (a) ``grad_filter_eps``
     1e-5, 6 steps: at random init step 0 skips no tile with a valid
     column (only the padded head's pad-only tiles, whose terms are
     zero), its loss and bf16 lm_head gradient bit for bit the exact
     kernels'; the counters,
     zeroed just before the loop, show one tile-stat forward, one
     filtered dH and one filtered dW a step and no exact dH / dW; (b)
     ``grad_filter_eps`` 1e-3, 6 steps: every mask recorded (wrapping
     `core.filtering.tile_skip_mask`), each step's skipped fraction > 0,
     step 0's loss bit for bit the exact path's, its mask the one its
     tile statistic gives, and its bf16 lm_head gradient bit for bit the
     filtered dW kernel's on that mask, cast, whose f32 result is held to
     the plain version on the same mask; every loss finite and the last
     below the first;
     step ms p50 and tokens/s beside phase 4's; (c) two MTP heads (depth
     1), ``grad_accum`` 2, eps 0, 3 steps: (1 + 2) x 2 launches of each
     exact fused-CE kernel and of `sample_topk` (the ``acc_h*`` metrics)
     a step, step 0's loss within 1e-4 of the canonical loss's,
     ``ce_h*`` / ``acc_h*`` finite with acc in [0, 1]; the ``acc_h*``
     launches all on `sample_topk`'s many-row kernel and none on its
     decode kernel; step ms p50, tokens/s, peak memory and the many-row
     kernel's time at 4096 rows beside ``torch.topk(h @ w.T, 1)``.
  9. checkpoints, resume and preemption at full width — phase 4's model
     and data, the checkpoints under a temporary directory in the
     checkout's ``build/``: (e), run right after phase 4, its final AdamW
     state (~7.5 GB) saved synchronously, `save_async`'s blocking
     snapshot timed apart, and the restore onto the card bit for bit;
     (a) `repro_torch.launch.train` with ``--optimizer adafactor --steps
     4 --ckpt-dir D --ckpt-every 2``: checkpoints at steps 2 and 4, the
     counters (zeroed just before) showing one launch of each exact
     fused-CE kernel a step and nothing else, every loss finite; step ms
     p50 beside phase 4's, peak memory, and the optimizer state's bytes
     against AdamW's; (b) `resume_or_init` on D: step 4, every leaf bit
     for bit (a)'s final state; (c) the CLI resumed to ``--steps 6``:
     steps 4 and 5 on batches 0 and 1 (the reference restarts its data),
     its params no further from (a)'s state continued on the same
     batches by the resumed config's step than two such continuations
     from copies are from each other (the card's run-to-run difference);
     (d) `train_loop` with a stop requested after its first step: it
     saves step 1 and stops there.
 10. request modes at full width — phase 7's params, batch 8, 16 new
     tokens, seeded 64-token prompts: (a) two beam-4 groups on
     `PagedEngine` (block 16), (b) two best-of-4 groups at T 0.7, top_k
     40, on `Engine`, (c) 8 requests under the ``even`` grammar mask and
     one under a per-step `mask_fn` (alternating parity) on `Engine`,
     each run right after the launch counters are zeroed.  Gates: one
     `sample_topk` launch a prefill and a step (28 `paged_attn` a step on
     the paged engine); every top-k call recorded and held to the plain
     version (values, ids, lse), with its model's vocab and softcap, the
     lse for groups and the mask for constrained steps; every token of
     every hypothesis (its cumulative logp's step) within
     MODES_TOKEN_ATOL of a cache-free forward's log_softmax, its first
     token (the prefill's scan) within EVAL_ATOL of one over the prompt
     alone; paged forks that copy no block and take none; every
     constrained token allowed and within GREEDY_TOL of the best allowed
     logit of a cache-free forward; on the paged engine every decode
     write of a live slot read back from the pool bit for bit.  Then (a)
     once more with copy-on-write off, a planted fault that the read-back
     must catch.  Prints tokens/s, step ms p50, forks, prunes,
     copy-on-write copies, the two cache-free forwards' rounding floor
     and the fault's logp reading.
 11. quantized serving at full width — phase 6's params (phase 3's trunk
     and 4 MTP heads), an int8 KV cache or int8 pools with f32 scale
     pools, and a 1-byte lm_head with per-row scales made at engine
     init: (a) slab `Engine` (int8 head) on phase 3's traffic, (b)
     `PagedEngine` (int8 head) on phase 5's shared-prompt traffic, its
     prefix hits prefilling their suffix over a dequantized chain view,
     (c) `PagedSelfSpecEngine` on (b)'s configuration at Tq 5, greedy,
     (d) a short slab run at each fp8 head (e4m3fn, e5m2), (e) eval on
     (b)'s engine (4 prompts x 2 continuations) and (f) the eval loss
     `fused_cross_entropy(w_scale=)` over 4 x 512 tokens, each with its
     launch counters zeroed just before.  Gates: one `sample_topk`
     launch a prefill and a decode step (two a spec step), 28
     `paged_attn` a paged decode step, one `score_tokens` a continuation
     (every call held to its plain version), one fused-CE forward (its
     loss against the dequantized head's f32 logits); the int8 slab
     cache; head bytes within 0.49-0.51 of the bf16 head's; every
     decode write of a live slot read back bit for bit from the int8
     pools and the scale pools; live pool bytes a request at most
     QUANT_POOL_RATIO of phase 5's bf16 engine on the same traffic;
     every served token's logit within QUANT_TOKEN_TOL of the best one
     of a cache-free forward through the dequantized head
     (`dequantize_weight`), and every eval logp as near, while two
     planted faults (the engine served without ``w_scale``, and
     `paged_attn` given unit K scales) read above that limit.  Prints
     tokens/s, step ms p50, head bytes, block bytes and pool bytes a
     request.

 12. the rest of the transformer family at full width, seeded random
     weights, each model freed before the next: (a) qwen3-moe-235b-a22b
     (4 layers, 22.4 GB bf16) on `Engine(batch_size=8)`, 8 seeded
     64-token prompts, 16 new tokens, greedy, at capacity factor E / k
     (16: no assignment can drop); (b) the same at the published 1.25
     on the same traffic; (c) `PagedEngine` (block 16) on (a)'s model
     and phase 5's shared-prompt traffic; (d) qwen3-moe training, 1
     layer, AdamW, ``loss_impl='kernel'``, batch 4 x 512, 3 steps at
     1.25; (e) arctic-480b (1 layer: the dense FFN beside 128 experts)
     at capacity factor 64 = E / k; (f) internvl2-1b (24 layers) with
     seeded 256-position frontend embeddings on `Engine`.  Each run
     with its launch counters zeroed just before.  Gates: one
     `sample_topk` launch a prefill and a decode step (and 4
     `paged_attn` a step in (c), at 64 query over 4 KV heads, a group of
     16), every call held to its plain version at the call; no dropped
     assignment in (a), (c), (e), counted from the routes (and none in
     their cache-free forwards); every served token within FAMILY_TOL of
     the best logit of a cache-free forward over its request whose
     experts are pinned to the served run's (`RoutePin`: each router row
     within PIN_MATCH_RTOL of its served twin), the unpinned forward's
     reading and the rounding floor printed; (b) every top-k value
     finite, the dropped prefill assignments printed, and one
     full-width MoE layer routed on the card and on the CPU from the
     same bf16 input and f32 router logits: slot tables equal, gates
     within MOE_GATE_RTOL, outputs within MOE_LAYER_ATOL of the CPU's
     largest entry; (c) every decode write read back from the pool bit
     for bit, 15 prefix hits; (d) step 0's loss within 1e-4 of the
     canonical loss's, its lm_head gradient within phase 4's relative
     Frobenius limit, the aux loss > 0 and within 1e-5 of an f64
     recomputation from the router's probs, one launch of each fused-CE
     kernel a step, every loss finite; (f) the cache lengths 256 + the
     prompt's.  Prints tokens/s, decode-step ms p50, peak memory, the
     training step ms p50 and the optimizer state's bytes, and arctic's
     head top-k device time beside its byte bound.
 13. griffin (recurrentgemma-9b: RG-LRU and local attention, d 4096,
     vocab 256000) at full width, seeded random weights, last: (a) 38
     layers (19.25 GB bf16) on `Engine(batch_size=8)`, one 37-token
     prompt, five of 38-64 (bucket 64, pads masked), one of 2040 (bucket
     2048 = the window: the ring wraps in decode) and one of 2100 (an
     exact-length prefill that wraps the ring), 16 new tokens, greedy;
     (d) `PagedEngine` on the same model and traffic; (c) eval, 4
     prompts x 2 continuations; (b) its first 8 layers at full width:
     `SpecEngine` with draft = target (k 4) and `SelfSpecEngine` with 2
     random MTP heads (k 2) on prompts the ring wraps on during the
     spec steps, and a rollback check; (f) one recurrent block and one
     local-attention layer over 4096 tokens and a 2100-token ring
     prefill + 4 decode steps on the card and the CPU; (e) training, one
     super (3 layers), AdamW, ``loss_impl='kernel'``, 1 x 4096 tokens, 3
     steps.  Gates: one `sample_topk` launch a prefill and a step (two a
     prefill and K + 1 or 2 a spec step in (b)), every call held to its
     plain version; every served token within GRIFFIN_TOL of a
     cache-free forward's best logit (the floor printed); the 37-token
     prompt's first token equal bucketed and at its exact length, the
     first block's scan's carried h within GRIFFIN_H_ULPS ulps; (d)
     tokens bit for bit (a)'s, ``paged_stats() == {'enabled': False}``,
     no `paged_attn` launch; (c) one `score_tokens` launch a
     continuation, every logp within EVAL_ATOL of a cache-free forward
     over the same padded tokens; (b) draft = target: acceptance >= 0.9,
     tokens bit for bit the plain engine's; the rollback check: 8
     rejecting self-spec steps over a 2046-token prompt leave every
     state leaf bit for bit the plain engine's after the same tokens;
     (f) within GRIFFIN_BLOCK_ATOL / GRIFFIN_H_FRO, the ring's positions
     bit for bit; (e) step 0 against the canonical loss and its dH / dW
     launches against their plain versions, one launch of each fused-CE
     kernel a step.  Prints tokens/s, step ms p50, peak memory, spec-step
     ms and acceptance, the training step and the optimizer's bytes.
 14. xlstm (xlstm-125m: 6 sLSTM + mLSTM pairs, d 768, vocab 50304 on a
     50432-row head) at full width and full depth, seeded random
     weights, last: (a) `Engine(batch_size=8)`, six prompts of 5-60
     tokens (bucketed), one of 300 (bucket 512: two mLSTM chunks, the
     second partly pads) and one of 3000 (bucket 4096: four chunks only
     pads), 32 new tokens, greedy; the 3000-token prefill timed alone,
     and the slot state's bytes after it and after the 5-token prompt;
     (b) a 37-token prompt bucketed (64) and at its exact length, and
     the padded state on the card against the CPU port's padded run;
     (e) `PagedEngine` on (a)'s traffic; (d) eval, 4 prompts x 2
     continuations; (c) on (a)'s prompts but the 3000-token one:
     `SpecEngine` with draft = target (k 4), `SelfSpecEngine` with 2
     random MTP heads (k 2), and the rollback check over the 300-token
     prompt; (g) one sLSTM and one mLSTM block over 2048 tokens and one
     pair over a bucketed 300-token prefill + 4 decode steps on the
     card and the CPU; (f) training at 2 blocks and 4 x 1024 tokens
     (the run's time budget), AdamW, ``loss_impl='kernel'``, 3 steps,
     and one sLSTM block against one mLSTM block over that batch.  Gates:
     one `sample_topk` launch a prefill and a step (two a prefill and K + 1
     or 2 a spec step in (c)), every call held to its plain version;
     every served token within XLSTM_TOL of a cache-free forward's best
     logit (the floor printed); 14,432,352 f32 bytes a slot; (b) first
     tokens equal, states within XLSTM_PAD_FRO and XLSTM_CARD_CPU_FRO;
     (e) tokens bit for bit (a)'s, ``paged_stats() == {'enabled':
     False}``, no `paged_attn` launch (its counter read); (d) one
     `score_tokens` launch a continuation, every logp within EVAL_ATOL
     of a forward from a fresh serve state over the same padded tokens
     (the prefill's arithmetic; the cache-free reading printed); (c)
     draft = target: acceptance >= 0.9, tokens bit for bit the plain
     engine's; every state leaf bit for bit the plain engine's after 8
     rejecting self-spec steps; (g) within XLSTM_BLOCK_ATOL /
     XLSTM_STATE_FRO; (f) step 0 against the canonical loss, its dH /
     dW launches against their plain versions (the cluster of 4 whose
     last CTA lies wholly past d 768), every gradient finite, one
     launch of each fused-CE kernel a step.  Prints tokens/s, step ms
     p50, the 3000-token prefill's ms, peak memory, spec-step ms and
     acceptance, the training step, the AdamW state's bytes and the
     sLSTM block's share of a pair.
 15. enc-dec (seamless-m4t-medium: 12 encoder + 12 decoder layers, d
     1024, 16 heads of 64, vocab 256206 on a 256256-row head) at full
     width and full depth, seeded random weights, every request after
     its own seeded (1, 4096, 1024) bf16 encoder frames, last: (a)
     `Engine(batch_size=8, max_len=512)`, eight prompts of 5-60 tokens
     and one of 300, 16 new tokens, greedy; (b) `PagedEngine` (block
     16, prefix cache on) on (a)'s traffic plus eight requests of one
     128-token prompt under frames A, B, A, B, ...; (c) eval, 4 prompts
     x 2 continuations; (d) `SpecEngine` with draft = target (k 4) on
     (a)'s prompts but the 300-token one; (e) one encoder block over
     4096 frames and one decoder block with cross-attention over its
     output on a bucketed 300-token prefill + 4 decode steps, on the
     card and the CPU; (f) training, 24 layers, AdamW,
     ``loss_impl='kernel'``, 4 x 1024 decoder tokens over 4 x 1024
     frames, 3 steps.  Gates: one `sample_topk` launch a prefill and a
     step (two a prefill and K + 1 a spec step in (d)) and 12
     `paged_attn` launches a paged step, every call held to its plain
     version; every served token within ENCDEC_TOL of the best logit of
     a cache-free forward over its frames (the floor printed); 201,326,592
     B of bf16 cross K/V a slot; a request served alone as in the batch;
     (b) exactly 6 prefix hits, each on the first chain built under the
     same frames and none across them, ``paged_stats()['enabled']``;
     (c) one `score_tokens` launch a continuation, every logp within
     EVAL_ATOL of a cache-free forward over the same padded tokens and
     frames; (d) acceptance >= ENCDEC_ACCEPT, tokens (a)'s or within
     ENCDEC_TOL, every cross leaf bit for bit the prefills' after three
     rolled-back steps; (e) within ENCDEC_BLOCK_ATOL; (f) step 0 within
     TRAIN_LOSS_RTOL of the canonical loss, the lm_head gradient within
     TRAIN_HEAD_FRO, its dH / dW launches against their plain versions
     and dW's 50 pad rows zero, every gradient finite and each encoder
     layer's nonzero, one launch of each fused-CE kernel a step, the
     AdamW state 7,018,151,936 B.  Prints tokens/s, decode-step ms p50,
     one 4096-frame encode alone, the cross-attention's share of a
     decode step, peak memory, spec-step ms and acceptance, the
     training step and tokens/s.
 16. the shapes past d 4096, k 64 and 64 candidates, last: (a)
     mistral-large-123b (d 12288, V 32768) and (b) qwen1.5-32b (d 5120,
     V 152064) at their published widths cut to 1 layer, AdamW at lr
     3e-5, ``loss_impl='kernel'``,
     batch 4 x 1024, 3 steps: step 0 within TRAIN_LOSS_RTOL of the
     canonical loss and TRAIN_HEAD_FRO on the lm_head gradient, its dH
     and dW launches (the backward's column passes) against their plain
     versions, one launch of each fused-CE kernel a step; prints step ms
     p50, tokens/s and peak memory; (c) qwen3-0.6b on phase 3's traffic
     at temperature 0.8 and top_k 100, a beam-40 group (80 candidates a
     row) on `PagedEngine` and a best-of-4 group at top_k 100 on
     `Engine`, one `sample_topk` launch a prefill and a step, every call
     (the list kernel) held to its plain version on its hidden states;
     (d) ``python -m repro_torch.launch.serve --arch qwen3-0.6b
     --temperature 0.8 --top-k 100 --metrics-json P --trace-out Q`` in a
     subprocess: exit 0, the report's keys the reference's, the chrome
     trace's ``engine.decode_step`` spans.
 17. the autotuner and its cache (``[tune]`` lines), on a fresh cache
     file under ``build/`` (every earlier phase runs on an empty
     in-memory cache, the kernels' own plans): (a) cold sweeps that time
     every candidate of each ladder (`plan_tuner.measure_us`: CUDA events
     around back-to-back calls that fill ~1 ms, queued behind a device
     sleep) and hold each to its plain version -- the top-k on
     qwen3-0.6b's head at 8 rows, k 1, 40 and 100, k 1 at 16, 32, 64, 128
     and 256 rows (where the decode and many-row kernels cross),
     `score_tokens` at 32 rows and P 1, `paged_attn` at phase 5's decode
     shape on bf16 and int8 pools, the fused-CE forward at 8192 rows --
     each printing every candidate's time, the own plan's and the
     winner; (b) the serve CLI with ``--autotune`` twice (in-process, 16
     requests of 128 tokens, 32 new, batch 8): the first sweeps, the
     second finds every key and sweeps nothing, both serve the untuned
     run's tokens; (c) `PagedEngine` on phase 5's traffic and a greedy
     `SelfSpecEngine` with 4 MTP heads on phase 3's, ``autotune=True``
     against the same engines untuned: the same tokens, or each within
     `GREEDY_TOL` of a cache-free forward's best logit; (d) the train CLI
     with ``--autotune --tuning-cache`` (3 steps, batch 8 x 1024): step
     0's loss the untuned run's within f32 reduction order
     (`TUNE_LOSS_RTOL`).  The launches of (b) to (d), sweeps included,
     count toward the record.
 18. the static analysis (``[analyze]`` lines): (a) ``launch/analyze``'s
     36-entry matrix on the card (the reduced configs in bf16, at width
     64 where theirs is 48): rc 0, no suppression, each kernel's launch
     count equal to the kernel scopes the recorder entered, a launch on
     every transformer hot path, and the train steps' backward ops
     recorded inside their scopes (autograd runs them on its device
     thread); (b) qwen3-0.6b at full width: the slab decode step and an
     eval score on phase 3's engine, phase 5's paged decode step, phase
     6's verify (40 rows, 5 a slot), phase 11's quantized paged decode,
     phase 4's training step at 8 x 1024, each recorded and held to every
     rule (no finding but those of `ANALYZE_OPEN_FULL`, ROADMAP §C), and
     both fixtures flagged (the dense sampler at 8 rows, the canonical
     loss over 8192 rows); (c) the CUDA allocator's history over the
     two training steps (`analysis.trace.memory_dict`): the fused
     step's largest block below the bf16 logits' 2.49 GB, the canonical
     step's at or above it.  Its launches count toward the record.
 19. the paper's distributed fused loss (``[dist]`` lines) on a (data 2,
     model 2) world of 4 ranks sharing the one card over gloo (NCCL
     takes one rank a card): (a) the loss alone at qwen3-0.6b's head
     (8192 rows, V 152064, d 1024, bf16), '2d' and 'sp_gather', exact and
     filtered at eps 1.0, each rank's loss, dH rows and dW vocab slice
     held to one process's `kernel_loss` over the whole head
     (`DIST_LOSS_RTOL`, `DIST_GRAD_RTOL`, `DIST_GRAD_FRO`), each rank's
     forward, dH and dW launched once at its own ``col_offset`` (0 and
     76032), its collective bytes and calls by kind printed; (c) rank
     0's loss step recorded: no finding under any rule
     (logits-materialization and vocab-collectives among them) and
     `collective_stats` equal to the collectives' counters; (d)
     `compressed_psum_tree` and a (2, 2) -> (4, 1) `reshard` on the
     card's tensors bit for bit the same calls on CPU tensors; (b) the
     train CLI at full width, `DIST_LAYERS` layers, 3 AdamW steps at
     8 x 1024, one rank with ``--loss-impl kernel``, then ``--devices
     2,2`` with ``sharded`` and ``sharded_sp``, joining the same world (as
     under torchrun; (e) takes the CLI's own spawn): step 0's and the last
     step's loss within `DIST_STEP0_RTOL` / `DIST_LAST_RTOL` of the one
     rank's, every rank's grad norm at every step within
     `DIST_GNORM_RTOL` of the one rank's, the params after the steps
     (the lm_head on the rank's vocab rows, the body's leaves together)
     within `DIST_PARAM_RTOL` of the one rank's update and each body leaf
     within `DIST_PARAM_LEAF`, every rank's fused-CE
     kernels launched 3 times at its own ``col_offset``, its peak memory
     printed; (e) ``--devices 1,1``,
     which runs on nccl, one step; (f) expert parallelism and the
     d-sharded embedding: qwen3-moe-235b-a22b at full width, 1 layer,
     through the train CLI on a (1, 4) world against one process, both
     layouts, with `DIST_MOE_PARAM_RTOL` / `DIST_MOE_PARAM_LEAF` for the
     params.  (b) and (f) run the body as Megatron tensor parallelism:
     every leaf cut over model by its spec, attention by heads, the MLPs
     by ffn, the router by expert.  (g) (b) again with ``--optimizer
     adafactor`` under (b)'s gates, and every rank holding 1/M of each
     layer's wq, wk, wv, wo, wi, wg and mlp/wo and each slot at its
     spec's shape; (h) xlstm-125m at full width, 2 blocks, 3 AdamW steps
     at 4 x 256 in (f)'s (1, 4) world under 'sharded' against one
     process (its recurrent leaves gathered at use).  Every run prints
     each rank's held bytes of the body's leaves, its collective calls
     and bytes and its peak beside the card.  The launches of (b), (e),
     (f), (g) and (h) count toward the record.

Phase 2 also takes the new cases past the kernels' old limits: the
top-k's list kernel (k > 64) on the padded head at 8 rows and k 65, 100,
256 and 1024, at k 100 with a half-zero mask and the lse, on an int8
head and on the 256000 x 4096 head, and k = V + 3 on a 1000-row head;
the fused-CE forward, dH and dW at d 5120 (V 152064), 7168 (V 32000)
and 12288 (V 32768), 4096 rows, 101 pad rows, with the exact cases'
checks and yardsticks, then filtered under an all-False mask (bit for
bit the exact kernels) and on the peaked problem (against the plain
version given the mask, dW's pad rows zero); `score_tokens` at 8 rows
and P 65, 128 and 256 on the padded head and seamless-m4t-medium's.
Phase 2 also holds `paged_attn` to its plain version at the decode
shape of phase 5 (B 8, Tq 1, 16 query / 8 KV heads, head_dim 128, block
16, 32 blocks a row), with full chains, with Tq 4 and softcap 30, with
ghost rows, with a poisoned null block, at phase 6's Tq 5 and at phase
15 (b)'s decode shape (16 query / 16 KV heads, head_dim 64), two calls
bit for bit, each with its split plan and timed by its device time under
`torch.profiler` (`device_ms`; CUDA events over back-to-back calls of a
few-microsecond kernel read the host's launch rate, printed beside it)
against its bound, its plain version and
`F.scaled_dot_product_attention` over the gathered K/V; and `score_tokens` on the padded head at the spec shape
(rows 32, P 1, T 0.7), the self-spec prefill's 4 head rows at T 0.7,
the eval shape (rows 8), rows 32 with P 4,
softcap 30, duplicated, -1, past-valid and pad-row ids, 1000 rows of a
`col_offset` shard, paper-lm's width (d 4096, V 32768: 32 rows P 1 and
100 rows P 64), mistral-large's d 12288 (32 rows P 1), d 16384 (40
rows P 4), recurrentgemma-9b's head (V 256000, 32 rows P 1),
xlstm-125m's (V 50432, valid 50304, d 768, 32 rows P 1) and
seamless-m4t-medium's (V 256256, valid 256206, 32 rows P 1), each against
its plain version, twice for bit identity, with
-inf exactly where the JAX kernel puts it, and timed beside its bound,
its plain version and ``torch.log_softmax`` of the logits gathered at
the ids, and the device time of its stream and merge kernels apart.
Its quantized cases (``[quant]`` lines) hold each kernel's A6 option to
its plain version on the same 1-byte head or int8 pools: the decode
top-k on an int8 head (8 rows, k 1; k 40 with the lse) and under a
half-zero mask on an e4m3fn head (k 1), `score_tokens` on the int8 head
(32 rows, T 0.7), `paged_attn` on int8 pools at phase 5's decode shape
and at Tq 5, and the fused-CE forward at 8192 rows on the int8 head,
twice for bit identity, each timed beside its bound (from the 1-byte
bytes), its plain version and the library's calls on the dequantized
head.

Phases 14, 15, 17 and 18 run in turn in a child process (`BESIDE`)
beside phases 3-9, after phase 2's timed cases, and their lines print
after phase 9's; every phase prints its wall time on a ``[time]`` line.

The last lines are the `{"kernels": [...]}` record, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
Without a CUDA device, or outside a checkout of the repo, it exits 1 and
prints no result.
"""

import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

if os.path.isdir(os.path.join(SRC, "repro_torch")):
    # the card's peak rates have one source, the port's roofline
    sys.path.insert(0, SRC)
    from repro_torch.analysis.roofline import (  # noqa: E402
        HBM_BW as H100_BYTES_PER_S, PEAK_FLOPS as H100_BF16_FLOPS)
VAL_RTOL, VAL_ATOL = 1e-5, 1e-4   # f32 sums of 1024 bf16 products, any order
# fused CE against its plain version (same bf16 inputs, f32 logits):
# lse and z_target as the sample_topk values; z_sum sums ~152k logits in
# another order (|z_sum| ~ 400), so atol 5e-3.  dH and dW: the JAX
# kernels' own rtol 3e-4 / atol 1e-6, and a relative Frobenius error of
# at most 1e-4 (g is contracted as two bf16 halves, |g - hi - lo| <=
# 2^-17 |g|; the atol alone would pass anything at the training shape,
# where dW entries are ~1e-7).
CE_ZSUM_ATOL = 5e-3
CE_GRAD_RTOL, CE_GRAD_ATOL, CE_GRAD_FRO = 3e-4, 1e-6, 1e-4
# step 0 of the training run, kernels against the canonical loss on the
# same params and batch: the loss within rtol 1e-4, the bf16 lm_head
# gradient within a relative Frobenius error of 1e-2
TRAIN_LOSS_RTOL, TRAIN_HEAD_FRO = 1e-4, 1e-2
TRAIN_STEPS = 6
# the gradient filter: the peaked problem's h rows are PEAK_A W[y] +
# PEAK_B W[y2] + small noise, W's rows of norm ~1, so each row's mass
# splits between y and y2 (lse ~ PEAK_A + log 2) and a 64 x 64 tile
# holding neither has logits ~N(0, 1) and a bound 64 exp(tmax - lse) far
# below FILTER_EPS; the filtered gradient may then deviate from the
# exact one by at most 2^-8 of the largest exact entry (the JAX
# package's guarantee, tests/test_grad_filtering.py).  With PEAK_B well
# below PEAK_A, g = p - 1 at the target cancels to 1 - p ~ exp(PEAK_B -
# PEAK_A), so the ~1e-5 absolute difference of two f32 logit sums near
# 24 (kernel and plain version) reads as a relative gradient error of
# 1e-5 / (1 - p): 3.1e-4 at 24 / 20 on the H100, against the exact
# kernels' CE_GRAD_FRO, which holds where 1 - p is O(1)
PEAK_A, PEAK_B = 24.0, 24.0
FILTER_EPS = 1e-5
FILTER_DEV = 2.0 ** -8
MTP_STEPS = 3
# phase 8: the training run's shape, and the filter thresholds of (a) and
# (b): at random init the seeded head's logits are near flat (std ~0.08),
# so a 64-column tile's bound is ~64 exp(0.3 - 11.93) ~ 6e-4: 1e-5 skips
# nothing, 1e-3 nearly every tile without a target
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
FILTER_TRAIN_EPS = (1e-5, 1e-3)
# A served greedy token may trail the cache-free forward's best logit by
# at most this much: cached decode and the cache-free forward round to
# bf16 in different places.  The seeded init's top-2 logit gaps are a few
# 1e-3, so a near-tie may flip; a wrong cache or position instead costs
# the served token several 1e-2 (a random token against the best).
GREEDY_TOL = 2e-3
# paged_attn's bf16 output against its plain version (f32 arithmetic on
# the same bf16 inputs, then cast): |out| <= 1 (a softmax-weighted mean
# of unit-normal values), so one bf16 rounding is <= 2^-8 and the two
# may round a value on either side of a tie: atol and rtol 1e-2.
PAGED_ATOL, PAGED_RTOL = 1e-2, 1e-2
# eval logps against log_softmax of a cache-free forward's f32 logits over
# the valid columns.  At 136 tokens the cache-free forward attends in one
# 512-wide tile, as the served prefill (bucketed, cached, trie replays)
# does, so the hidden states agree and only the logit sums differ in
# order: the H100 reading was 9.5e-7 (PERF.md).  The limit has to sit
# below the error of the likeliest fault: counting the 128 zero pad
# columns of the padded head in lse moves every logp by about
# log(1 + 128/151936) = 8.4e-4 under the seeded head (logits of std
# ~0.08); phase 7 measures that reading too and fails if the limit would
# not catch it.  A wrong position or a stale cache moves a logp by ~0.1.
EVAL_ATOL = 1e-4
# a beam or best-of hypothesis's logp against a cache-free forward's
# log_softmax, token by token.  Its first token comes from the prefill's
# scan, the arithmetic phase 7 holds to EVAL_ATOL, and is held there
# against a forward over the prompt alone.  Its later tokens come from
# cached decode steps, whose GEMMs (one row a slot) and attention round
# bf16 activations in other places than the cache-free forward's:
# two cache-free forwards that differ only in their row count already
# disagree by up to 1.67e-3 on a token on the H100 (PERF.md; phase 10
# prints this floor).  So every served token's logp is held to
# MODES_TOKEN_ATOL of the forward's, above that floor.  Under the seeded
# head's near-flat logits no logp comparison tells the paged fault the
# modes could bring (siblings appending into a shared block) from
# rounding: planted, it read 2.9e-3 on the H100 (PERF.md).  Phase 10
# holds the paged engine to a check without rounding instead: every
# decode write of a live slot reads back from the pool bit for bit; it
# plants that fault (copy-on-write off) and fails unless the check
# catches it.
MODES_TOKEN_ATOL = 5e-3
SPEC_K = 4
# phase 11: a served token of a quantized engine (int8 KV, a 1-byte head)
# against a cache-free forward with the bf16 weights and the dequantized
# head; and the live pool bytes a request against the bf16 paged engine's
# on the same traffic, scales counted ((hd + 4) / (2 hd) = 0.516 at hd 128)
# On the H100 (PERF.md), served tokens trail by up to 1.9e-3
# (int8 K/V rounded in every layer; bf16 caches read up to ~1e-3 here),
# eval logps by up to 1.4e-3.  A K read with unit scales reads 0.12; a
# head served without its scales reads ~1e-4 on greedy tokens (the seeded
# head's row scales are nearly equal, so the argmax barely moves) but
# scales every logit by ~1/s in an eval logp, which the limit catches.
QUANT_TOKEN_TOL = 5e-3
QUANT_POOL_RATIO = 0.55
XLSTM_VALID = 50304               # xlstm-125m's vocab; its head pads to 50432
ENCDEC_VALID = 256206             # seamless-m4t-medium's; its head: 256256
# the models past d 4096, whose fused-CE backward runs in column passes
WIDE_IDS = ("qwen1.5-32b", "arctic-480b", "mistral-large-123b")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(log):
    """(kernel, line) for every register and spill line of an nvcc
    `-Xptxas -v` log, the kernel's name demangled where c++filt exists."""
    out, name = [], "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            out.append([name, line.strip()])
    try:
        names = subprocess.run(
            ["c++filt"], input="\n".join(n for n, _ in out),
            capture_output=True, text=True, check=True,
            timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = [n for n, _ in out]
    for pair, full in zip(out, names):
        pair[0] = (full.split("(anonymous namespace)::")[-1].split("(")[0]
                   if "(" in full else full)
    return [tuple(p) for p in out]


def cuda_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def topk_bound_ms(rows, d, v, k, extra_bytes=0):
    """Least time on an H100: read h and W once, write vals and ids once
    (plus `extra_bytes`: a mask read, an lse written); 2*rows*d*v bf16
    operations."""
    nbytes = rows * d * 2 + v * d * 2 + rows * k * 8 + extra_bytes
    flops = 2 * rows * d * v
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_topk(np, vals, ids, rv, ri, exact_ids):
    """Max |err| at finite positions; ids equal wherever the plain
    version's neighbouring values are more than VAL_ATOL apart (or
    everywhere, for exact arithmetic)."""
    vals, ids, rv, ri = (t.cpu().numpy() for t in (vals, ids, rv, ri))
    fin = np.isfinite(rv)
    if not np.array_equal(fin, np.isfinite(vals)):
        raise AssertionError("kernel and plain version disagree on -inf")
    np.testing.assert_allclose(vals[fin], rv[fin], rtol=VAL_RTOL,
                               atol=VAL_ATOL)
    sep = fin.copy()
    if not exact_ids:
        gap = np.abs(np.diff(rv, axis=1)) > VAL_ATOL
        sep[:, :-1] &= gap
        sep[:, 1:] &= gap
    np.testing.assert_array_equal(ids[sep], ri[sep])
    return float(np.max(np.abs(vals[fin] - rv[fin]))), int(sep.sum())


def check_topk_wide(np, vals, ids, rv, ri):
    """`check_topk` for long lists (k > 64), given the plain version's
    top k + 1 (`rv`, `ri`): -inf in the same places,
    values at VAL_RTOL / VAL_ATOL, ids equal wherever a value lies
    further from both neighbours, the (k + 1)-th included, than twice
    what the tolerance lets either move (at k 1024 of 152064 columns,
    gaps of ~1e-4 between values are common, and the k-th and (k + 1)-th
    may swap); returns (max |err|, ids checked)."""
    vals, ids, rv, ri = (t.cpu().numpy() for t in (vals, ids, rv, ri))
    k = vals.shape[1]
    fin_ext = np.isfinite(rv)
    tol = VAL_ATOL + VAL_RTOL * np.abs(np.where(fin_ext, rv, 0.0))
    gap = np.abs(np.diff(rv, axis=1)) > 2 * np.maximum(tol[:, 1:],
                                                       tol[:, :-1])
    rv, ri, fin = rv[:, :k], ri[:, :k], fin_ext[:, :k]
    if not np.array_equal(fin, np.isfinite(vals)):
        raise AssertionError("kernel and plain version disagree on -inf")
    np.testing.assert_allclose(vals[fin], rv[fin], rtol=VAL_RTOL,
                               atol=VAL_ATOL)
    sep = fin & gap
    sep[:, 1:] &= gap[:, :-1]
    np.testing.assert_array_equal(ids[sep], ri[sep])
    err = float(np.max(np.abs(vals[fin] - rv[fin]))) if fin.any() else 0.0
    return err, int(sep.sum())


def check_top1(np, vals, ids, rv2, ri2, exact_ids):
    """k = 1 against the plain version's top 2: values at VAL_RTOL /
    VAL_ATOL, -inf in the same rows, ids equal wherever the best two
    values are more than VAL_ATOL apart (or everywhere, for exact
    arithmetic); returns (max |err|, ids checked)."""
    vals, ids, rv2, ri2 = (t.cpu().numpy() for t in (vals, ids, rv2, ri2))
    rv = rv2[:, 0]
    fin = np.isfinite(rv)
    if not np.array_equal(fin, np.isfinite(vals[:, 0])):
        raise AssertionError("kernel and plain version disagree on -inf")
    np.testing.assert_allclose(vals[fin, 0], rv[fin], rtol=VAL_RTOL,
                               atol=VAL_ATOL)
    sep = fin.copy()
    if not exact_ids:
        sep &= (rv2[:, 0] - rv2[:, 1]) > VAL_ATOL
    np.testing.assert_array_equal(ids[sep, 0], ri2[sep, 0])
    return float(np.max(np.abs(vals[fin, 0] - rv[fin]))), int(sep.sum())


def device_ms(torch, call, parts, iters=20, attempts=5):
    """{label: device ms a call} of the launches of a wrapper call under
    `torch.profiler`, over `iters` calls: each CUDA kernel record goes
    to the first (label, name substring) of `parts` that its name holds.
    The window's runtime API records must show exactly one launch a part
    a call (`cudaLaunchKernel`), so a part launched twice fails.  The
    profiler drops kernel records while it keeps every launch record (on
    the H100: 19 of 20 `paged_attn` records and 49 of 50 W-stream
    records in every window of some calls, once about half, PERF.md),
    so a window short of records is retried, and if none of `attempts`
    is complete, each part is averaged over the most records a window
    kept, each the whole time of one launch, and the shortfall printed.
    CUDA events around a kernel of a few microseconds would read the
    host's launch rate.  Fails if a launch matches no part, or if a part
    has no record."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    best = None
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        us = {label: 0.0 for label, _ in parts}
        seen = {label: 0 for label, _ in parts}
        launches = 0
        for e in prof.events():
            if e.device_type != cuda:
                launches += "LaunchKernel" in e.name
                continue
            label = next((lb for lb, sub in parts if sub in e.name), None)
            if label is None:
                raise AssertionError(f"the call launched {e.name}, none of "
                                     f"{[sub for _, sub in parts]}")
            us[label] += e.time_range.elapsed_us()
            seen[label] += 1
        if launches > iters * len(parts):
            raise AssertionError(f"{iters} calls made {launches} kernel "
                                 f"launches, {len(parts)} a call expected "
                                 f"({parts})")
        if launches < iters * len(parts):
            continue
        if all(n == iters for n in seen.values()):
            return {label: t / iters / 1e3 for label, t in us.items()}
        if best is None or sum(seen.values()) > sum(best[1].values()):
            best = (us, seen)
    if best is None or not all(best[1].values()):
        raise AssertionError(f"no profiled window of {attempts} recorded "
                             f"every launch and a kernel of each of {parts}")
    us, seen = best
    print(f"[profiler] {iters} calls, every launch in the API records; "
          f"kernel records kept {seen} of {iters} a part in the best of "
          f"{attempts} windows: each part averaged over those", flush=True)
    return {label: us[label] / seen[label] / 1e3 for label in us}


def split_ms(torch, call, iters=20):
    """(stream kernel ms, merge kernel ms) of a wrapper call that launches
    a W-stream kernel and its merge (`device_ms`)."""
    ms = device_ms(torch, call, (("merge", "merge"),
                                 ("stream", "stream_kernel")), iters)
    return ms["stream"], ms["merge"]


def phase_topk(torch, np, arch, dev):
    from repro_torch.core.windows import topk_decode_plan, topk_stream_plan
    from repro_torch.kernels.sample_topk import (LAUNCHES, ROWS_LAUNCHES,
                                                 cuda_topk, topk_scores_ref)

    gen = torch.Generator(device=dev).manual_seed(1234)
    d, v, valid = arch.cfg.d_model, arch.padded_vocab, arch.vocab_size
    w = torch.randn((v, d), generator=gen, device=dev) / d ** 0.5
    w[valid:] = 0.0                                # the padded head rows
    w = w.bfloat16()
    w_ties = (torch.round(torch.randn((v, d), generator=gen, device=dev)
                          * 2) / 2).bfloat16()
    # paper-lm's width (d 4096), and d 12288 and 16384: a CTA's shared
    # memory does not grow with d
    wide = {dw: (torch.randn((32768, dw), generator=gen, device=dev)
                 / dw ** 0.5).bfloat16() for dw in (4096, 12288, 16384)}
    # recurrentgemma-9b's head, 256000 x 4096 (phase 13), the widest;
    # xlstm-125m's, 50432 x 768 with 50304 valid rows (phase 14), the
    # smallest (788 tiles of 64 rows)
    wide["v256000"] = (torch.randn((256000, 4096), generator=gen,
                                   device=dev) / 64).bfloat16()
    wide["v50432"] = torch.randn((50432, 768), generator=gen,
                                 device=dev) / 768 ** 0.5
    wide["v50432"][XLSTM_VALID:] = 0.0
    wide["v50432"] = wide["v50432"].bfloat16()
    # seamless-m4t-medium's, 256256 x 1024 with 256206 valid rows (phase
    # 15): its last 64-row tile holds 14 valid rows and 50 pads
    wide["v256256"] = encdec_head(torch, gen, dev)
    wide_valid = {"v50432": XLSTM_VALID, "v256256": ENCDEC_VALID}
    cases = []
    for rows in (1, 8):
        for k in (1, 40):
            cases.append((f"rows{rows}_k{k}", rows, k, None, False, 0, None))
            for head in ("v256000", "v50432", "v256256"):
                cases.append((f"{head}_rows{rows}_k{k}", rows, k, None,
                              False, 0, head))
    cases.append(("rows8_k40_ties", 8, 40, None, True, 0, None))
    cases.append(("rows8_k40_softcap30", 8, 40, 30.0, False, 0, None))
    # the speculative verifier's 8 x (4 + 1) rows at the sampler's k 40
    cases.append(("rows40_k40", 40, 40, None, False, 0, None))
    cases.append(("d4096_rows8_k40", 8, 40, None, False, 0, 4096))
    cases.append(("d12288_rows8_k1", 8, 1, None, False, 0, 12288))
    cases.append(("d16384_rows40_k40", 40, 40, None, False, 0, 16384))
    # the many-row top-1 path (the MTP accuracy's 4096 rows), each also
    # through the decode kernel's plan
    for rows in (128, 512, 4096):
        cases.append((f"rows{rows}_k1", rows, 1, None, False, 0, None))
    cases.append(("rows4096_k1_ties", 4096, 1, None, True, 0, None))
    cases.append(("rows4096_k1_softcap30_offset", 4096, 1, 30.0, False,
                  4096, None))
    results = {}
    for name, rows, k, cap, ties, off, dw in cases:
        if dw:
            wt = wide[dw]
            v_c, valid_c = wt.shape[0], wide_valid.get(dw, wt.shape[0])
        else:
            wt = w_ties if ties else w
            v_c, valid_c = v, valid
        d_c = wt.shape[1]
        h = torch.randn((rows, d_c), generator=gen, device=dev)
        if ties:
            h = torch.round(h * 2) / 2
        h = h.bfloat16()
        kw = dict(valid_vocab=valid_c + off, logit_softcap=cap,
                  col_offset=off)
        many = k == 1 and rows >= 128
        before = (LAUNCHES.count, ROWS_LAUNCHES.count)
        vals, ids = cuda_topk(h, wt, k, **kw)
        torch.cuda.synchronize()
        after = (LAUNCHES.count, ROWS_LAUNCHES.count)
        if after != (before[0] + (not many), before[1] + many):
            raise AssertionError(f"{name}: launches {before} -> {after}, "
                                 f"want the {'many-row' if many else 'decode'}"
                                 " kernel")
        slow = rows >= 512                       # the plain version sorts
        plain_iters = dict(iters=2, warmup=1) if slow else dict(iters=5)
        if many:
            rv, ri = topk_scores_ref(h, wt, 2, **kw)
            err, n_ids = check_top1(np, vals, ids, rv, ri, exact_ids=ties)
        else:
            rv, ri = topk_scores_ref(h, wt, k, **kw)
            err, n_ids = check_topk(np, vals, ids, rv, ri, exact_ids=ties)
            vals2, ids2 = cuda_topk(h, wt, k, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(vals, vals2) and torch.equal(ids, ids2)):
                raise AssertionError(f"sample_topk {name}: two calls differ")
        if not bool(((ids >= off) & (ids < valid_c + off)).all()):
            raise AssertionError(f"{name}: id outside [{off}, "
                                 f"{valid_c + off})")
        ms = cuda_ms(torch, lambda: cuda_topk(h, wt, k, **kw))
        plain_ms = cuda_ms(torch, lambda: topk_scores_ref(h, wt, k, **kw),
                           **plain_iters)
        wv = wt[:valid_c]
        library_ms = cuda_ms(torch, lambda: torch.topk(h @ wv.T, k))
        bound_ms, bound_by = topk_bound_ms(rows, d_c, v_c, k)
        results[name] = dict(rows=rows, k=k, d=d_c, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        extra = ""
        if many:
            # the same call through the decode kernel (its own plan, given
            # explicitly), held to the same plain version
            dplan = topk_decode_plan(rows, v_c, k)
            dv, di = cuda_topk(h, wt, k, plan=dplan, **kw)
            torch.cuda.synchronize()
            check_top1(np, dv, di, rv, ri, exact_ids=ties)
            dec_ms = cuda_ms(torch, lambda: cuda_topk(h, wt, k, plan=dplan,
                                                      **kw),
                             **(dict(iters=2, warmup=1) if slow else {}))
            results[name]["decode_ms"] = dec_ms
            extra = (f", decode kernel (its plan) {dec_ms:.4f} ms; "
                     "many-row kernel")
        else:
            part_ms, merge_ms = split_ms(
                torch, lambda: cuda_topk(h, wt, k, **kw))
            sp = topk_stream_plan(rows, v_c, k)
            results[name].update(partial_ms=part_ms, merge_ms=merge_ms)
            extra = (f"; plan R {sp.rows} x {sp.row_tiles} row tiles, "
                     f"{sp.slices} slices of {sp.per} tiles, {sp.stages} "
                     f"stages, {sp.smem_bytes} B; device: stream kernel "
                     f"{part_ms:.4f} ms + merge {merge_ms:.4f} ms; two "
                     "calls bit-identical; call")
        print(f"[kernel] sample_topk {name} (d {d_c}, V {v_c}): max_abs_err "
              f"{err:.3g} ({n_ids} ids checked exactly){extra} {ms:.4f} ms "
              f"vs bound {bound_ms:.4f} ms ({bound_by}), plain "
              f"{plain_ms:.4f} ms, torch.topk(h @ w.T) {library_ms:.4f} ms",
              flush=True)
        del rv, ri
    results.update(topk_mode_cases(torch, np, w, valid, gen, dev))
    results.update(topk_list_cases(torch, np, w, valid, wide["v256000"],
                                   gen, dev))
    return results


def topk_list_cases(torch, np, w, valid, w256k, gen, dev):
    """k past the decode kernel's 64 (the list kernel): 8 rows on the
    padded head at k 65, 100, 256 and 1024, and at k 100 with a half-zero
    mask and the lse, on an int8 head with `w_scale`, and on the 256000
    x 4096 head; k = V + 3 on a 1000-row head (a -inf tail, id 0).  Each
    against its plain version (`check_topk_wide`), twice bit for bit,
    timed beside its bound, the plain version and ``torch.topk(h @ w.T,
    k)`` (through the dequantized head for the int8 case)."""
    from repro_torch.core.windows import topk_big_lists
    from repro_torch.kernels.quant import quantize_weight
    from repro_torch.kernels.sample_topk import (LAUNCHES, cuda_topk,
                                                 topk_scores_ref)
    wq, ws = quantize_weight(w, "int8")
    wq, ws = wq.contiguous(), ws.contiguous()
    small = (torch.randn((1000, 1024), generator=gen, device=dev)
             / 32).bfloat16()
    mask = (torch.rand((8, w.shape[0]), generator=gen, device=dev)
            < 0.5).to(torch.int8)
    cases = [(f"list_rows8_k{k}", k, w, valid, {}) for k in (65, 100, 256,
                                                             1024)]
    cases += [
        ("list_rows8_k100_mask_lse", 100, w, valid,
         dict(allowed_mask=mask, return_lse=True)),
        ("list_int8_rows8_k100", 100, wq, valid, dict(w_scale=ws)),
        ("list_v256000_rows8_k100", 100, w256k, w256k.shape[0], {}),
        ("list_v1000_rows8_k1003", 1003, small, 1000, {}),
    ]
    results = {}
    for name, k, wt, valid_c, opt in cases:
        v_c, d_c = wt.shape
        h = torch.randn((8, d_c), generator=gen, device=dev).bfloat16()
        kw = dict(valid_vocab=valid_c, **opt)
        before = LAUNCHES.count
        got = cuda_topk(h, wt, k, **kw)
        again = cuda_topk(h, wt, k, **kw)
        torch.cuda.synchronize()
        if LAUNCHES.count != before + 2:
            raise AssertionError(f"{name}: {LAUNCHES.count - before} "
                                 "launches for two calls")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"sample_topk {name}: two calls differ")
        ref = topk_scores_ref(h, wt, k, **kw)
        ext = topk_scores_ref(h, wt, k + 1, **kw)
        err, n_ids = check_topk_wide(np, got[0], got[1], ext[0], ext[1])
        if "return_lse" in opt:
            torch.testing.assert_close(got[2], ref[2], rtol=VAL_RTOL,
                                       atol=VAL_ATOL)
            fin = torch.isfinite(got[0])
            ok = mask.bool().gather(1, got[1].long().clamp(0, v_c - 1))
            if not bool(ok[fin].all()):
                raise AssertionError(f"{name}: a disallowed id")
        if k > v_c and not (bool(torch.isneginf(got[0][:, v_c:]).all())
                            and not bool(got[1][:, v_c:].any())):
            raise AssertionError(f"{name}: the tail past V is not -inf, 0")
        ms = cuda_ms(torch, lambda: cuda_topk(h, wt, k, **kw))
        plain_ms = cuda_ms(torch, lambda: topk_scores_ref(h, wt, k, **kw),
                           iters=3, warmup=1)
        wl = (wt.float() * ws[:, None]).bfloat16() if "w_scale" in opt \
            else wt
        wl = wl[:valid_c]
        library_ms = cuda_ms(torch, lambda: torch.topk(h @ wl.T,
                                                       min(k, valid_c)))
        # a mask read (8 x V bytes) and the lse written; a 1-byte W of
        # V x d bytes and its V f32 scales in place of the bf16 W
        extra = (8 * v_c + 8 * 4 if "allowed_mask" in opt else 0) + (
            4 * v_c - v_c * d_c if "w_scale" in opt else 0)
        bound_ms, bound_by = topk_bound_ms(8, d_c, v_c, k,
                                           extra_bytes=extra)
        plan, kk, in_smem = topk_big_lists(8, v_c, k,
                                           1 if "w_scale" in opt else 2)
        results[name] = dict(rows=8, k=k, d=d_c, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        print(f"[kernel] sample_topk {name} (list kernel, d {d_c}, V {v_c}"
              f", k {k}): max_abs_err {err:.3g} ({n_ids} ids checked "
              f"exactly); plan 8 x {plan.row_tiles} row tiles, "
              f"{plan.slices} slices of {plan.per} tiles, lists of {kk} "
              f"keys in {'shared' if in_smem else 'global'} memory, "
              f"{plan.stages} stages; two calls bit-identical; call "
              f"{ms:.4f} ms vs bound {bound_ms:.4f} ms ({bound_by}), plain "
              f"{plain_ms:.4f} ms, torch.topk(h @ w.T) {library_ms:.4f} ms",
              flush=True)
    return results


def topk_mode_cases(torch, np, w, valid, gen, dev):
    """The request modes' decode steps on the padded head: a beam step (8
    rows, k 8, ``return_lse``) and a constrained step (8 rows, k 1, a
    half-zero mask), each against its plain version (values and lse at
    VAL_RTOL / VAL_ATOL, ids where the values are apart, -inf where the
    plain version has it, every id allowed), twice for bit identity, an
    all-ones mask for the bits of no mask, and timed beside its bound
    (the mask's bytes and the lse's included), its plain version and the
    library's ``h @ w.T``, ``masked_fill``, ``logsumexp`` and
    ``torch.topk`` timed together."""
    from repro_torch.kernels.sample_topk import (LAUNCHES, cuda_topk,
                                                 topk_scores_ref)
    v, d = w.shape
    wv = w[:valid]
    results = {}
    for name, k, masked, lse in (("beam_rows8_k8_lse", 8, False, True),
                                 ("constrained_rows8_k1_mask", 1, True,
                                  False)):
        rows = 8
        h = torch.randn((rows, d), generator=gen, device=dev).bfloat16()
        mask = None
        if masked:
            mask = (torch.rand((rows, v), generator=gen, device=dev)
                    < 0.5).to(torch.int8)
        kw = dict(valid_vocab=valid, allowed_mask=mask, return_lse=lse)
        before = LAUNCHES.count
        out = cuda_topk(h, w, k, **kw)
        torch.cuda.synchronize()
        if LAUNCHES.count != before + 1:
            raise AssertionError(f"{name}: {LAUNCHES.count - before} "
                                 "decode launches, want 1")
        ref = topk_scores_ref(h, w, k, **kw)
        err, n_ids = check_topk(np, out[0], out[1], ref[0], ref[1],
                                exact_ids=False)
        again = cuda_topk(h, w, k, **kw)
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f"sample_topk {name}: two calls differ")
        if lse:
            got_l, want_l = out[2].cpu().numpy(), ref[2].cpu().numpy()
            np.testing.assert_allclose(got_l, want_l, rtol=VAL_RTOL,
                                       atol=VAL_ATOL)
            err = max(err, float(np.abs(got_l - want_l).max()))
            plain_out = cuda_topk(h, w, k, valid_vocab=valid)
            if not (torch.equal(plain_out[0], out[0])
                    and torch.equal(plain_out[1], out[1])):
                raise AssertionError(f"{name}: return_lse changed the top-k")
        if masked:
            allowed = mask.bool()
            if not bool(allowed.gather(1, out[1].long()).all()):
                raise AssertionError(f"{name}: a disallowed id")
            ones = torch.ones_like(mask)
            a = cuda_topk(h, w, k, valid_vocab=valid, allowed_mask=ones)
            b = cuda_topk(h, w, k, valid_vocab=valid)
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                raise AssertionError(f"{name}: an all-ones mask changed "
                                     "the bits")
        ms = cuda_ms(torch, lambda: cuda_topk(h, w, k, **kw))
        plain_ms = cuda_ms(torch, lambda: topk_scores_ref(h, w, k, **kw),
                           iters=5)
        mv = None if mask is None else mask[:, :valid] == 0

        def library():
            z = h @ wv.T
            if mv is not None:
                z = z.masked_fill(mv, float("-inf"))
            if lse:
                torch.logsumexp(z.float(), dim=-1)
            return torch.topk(z, k)

        library_ms = cuda_ms(torch, library)
        bound_ms, bound_by = topk_bound_ms(
            rows, d, v, k, extra_bytes=(rows * v if masked else 0)
            + (rows * 4 if lse else 0))
        part_ms, merge_ms = split_ms(torch, lambda: cuda_topk(h, w, k, **kw))
        results[name] = dict(rows=rows, k=k, d=d, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             partial_ms=part_ms, merge_ms=merge_ms)
        print(f"[kernel] sample_topk {name} (d {d}, V {v}"
              f"{', half-zero mask' if masked else ''}"
              f"{', return_lse' if lse else ''}): max_abs_err {err:.3g} "
              f"({n_ids} ids checked exactly); device: stream kernel "
              f"{part_ms:.4f} ms + merge {merge_ms:.4f} ms; two calls "
              f"bit-identical; call {ms:.4f} ms vs bound {bound_ms:.4f} ms "
              f"({bound_by}), plain {plain_ms:.4f} ms, library (h @ w.T"
              f"{', masked_fill' if masked else ''}"
              f"{', logsumexp' if lse else ''}, torch.topk) "
              f"{library_ms:.4f} ms", flush=True)
    return results


def ce_bound_ms(kind, n, v, d):
    """Least time on an H100 for one fused-CE kernel at (n, v, d): the
    bf16 products (forward one 2nvd product, dH and dW two each:
    recompute and contraction) against the bytes (h, W and the row
    inputs read once, the outputs written once)."""
    products = 1 if kind == "fwd" else 2
    flops = products * 2 * n * v * d
    nbytes = n * d * 2 + v * d * 2 + n * 4
    if kind == "fwd":
        nbytes += 3 * n * 4
    else:
        nbytes += 3 * n * 4 + (n if kind == "dh" else v) * d * 4
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def library_loss(torch, h, w, y, cfg, valid):
    """The canonical two-stage loss in PyTorch: logits by cuBLAS, then
    F.cross_entropy on f32 logits (the yardstick, used nowhere in the
    port)."""
    import torch.nn.functional as F
    z = (h @ w.T).float()[:, :valid]
    if cfg.logit_softcap is not None:
        z = cfg.logit_softcap * torch.tanh(z / cfg.logit_softcap)
    loss = F.cross_entropy(z, y.long(), ignore_index=cfg.ignore_index,
                           label_smoothing=cfg.label_smoothing)
    if cfg.z_loss:
        keep = y != cfg.ignore_index
        lse = torch.logsumexp(z, dim=-1)
        loss = loss + cfg.z_loss * (lse * lse * keep).sum() / keep.sum()
    return loss


def peak_mib(torch, fn):
    """Peak device memory allocated while `fn` runs, above what was
    allocated before it (MiB)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def phase_fused_ce(torch, np, arch, dev):
    from repro_torch.core import LossConfig
    from repro_torch.core.streaming import row_scale
    from repro_torch.models.registry import get_arch
    from repro_torch.kernels.fused_ce import (bwd_max_clusters, dh_grads,
                                              dw_grads, fwd_stats,
                                              kernel_loss, ref_dh, ref_dw,
                                              ref_grads, ref_stats)

    # how many clusters of each backward kernel the card runs at once, at
    # d 1024 (C 4) and d 4096 (C 16): one CTA an SM
    occ = {(k, c): bwd_max_clusters(k, c) for k in ("dh", "dw")
           for c in (4, 16)}
    print("[kernel] fused_ce backward: cudaOccupancyMaxActiveClusters "
          + ", ".join(f"{k} C {c}: {m} ({m * c} CTAs)"
                      for (k, c), m in occ.items())
          + f" of {torch.cuda.get_device_properties(0).multi_processor_count}"
          " SMs", flush=True)

    d0, v0, valid0 = arch.cfg.d_model, arch.padded_vocab, arch.vocab_size
    n0 = 8 * 1024
    cases = [
        # name, n, v, d, valid, col_offset, cfg kwargs, ignored share
        ("main", n0, v0, d0, valid0, 0, {}, 0.0),
        ("rows4096", n0 // 2, v0, d0, valid0, 0, {}, 0.0),  # phase 8 (c)
        ("softcap30", n0, v0, d0, valid0, 0, {"logit_softcap": 30.0}, 0.0),
        ("smooth0.1_z1e-4", n0, v0, d0, valid0, 0,
         {"label_smoothing": 0.1, "z_loss": 1e-4}, 0.0),
        ("ignore10pct", n0, v0, d0, valid0, 0, {}, 0.1),
        ("ragged1000_offset", 1000, v0, d0, valid0 + 4096, 4096, {}, 0.0),
        ("d4096", 512, 32768, 4096, 32768, 0, {}, 0.0),
        # recurrentgemma-9b's training shape (phase 13 (e)): 4096 rows,
        # d 4096 (the backward's cluster limit), V 256000
        ("v256000_d4096", 4096, 256000, 4096, 256000, 0, {}, 0.0),
        # xlstm-125m's training rows (phase 14 (f)): d 768, whose dH / dW
        # cluster of 4 has a last CTA wholly past d, V 50432
        ("v50432_d768", n0, 50432, 768, XLSTM_VALID, 0, {}, 0.0),
        # seamless-m4t-medium's training rows (phase 15 (f)): V 256256
        # with 256206 valid, the last W tile 14 valid rows and 50 pads
        ("v256256_d1024", 4096, 256256, 1024, ENCDEC_VALID, 0, {}, 0.0),
    ]
    # past d 4096, the backward's column passes (phase 16's shapes, and
    # arctic-480b's head): 4096 rows, 101 pad rows past the valid vocab
    for arch_id in WIDE_IDS:
        wa = get_arch(arch_id)
        wv, wd = wa.padded_vocab, wa.cfg.d_model
        cases.append((f"v{wv}_d{wd}", 4096, wv, wd, wv - 101, 0, {}, 0.0))
    results = {}
    errs = {"fused_ce_fwd": 0.0, "fused_ce_dh": 0.0, "fused_ce_dw": 0.0}
    for name, n, v, d, valid, off, cfg_kw, ign in cases:
        gen = torch.Generator(device=dev).manual_seed(len(results) + 7)
        h = torch.randn((n, d), generator=gen, device=dev).bfloat16()
        w = torch.randn((v, d), generator=gen, device=dev) / d ** 0.5
        w[valid - off:] = 0.0                      # the padded head rows
        w = w.bfloat16()
        y = torch.randint(0, valid, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        if ign:
            drop = torch.rand((n,), generator=gen, device=dev) < ign
            y = torch.where(drop, -100, y).to(torch.int32)
        cfg = LossConfig(**cfg_kw)
        kw = dict(col_offset=off, total_valid=valid)

        stats = fwd_stats(h, w, y, cfg, **kw)
        # no atomics: a second call gives the same bits
        if not all(torch.equal(a, b) for a, b in zip(
                stats, fwd_stats(h, w, y, cfg, **kw))):
            raise AssertionError(f"fused_ce {name}: two forward calls "
                                 "differ")
        torch.cuda.synchronize()
        want = ref_stats(h, w, y, cfg, **kw)
        for got, ref, atol in zip(stats, want, (VAL_ATOL, VAL_ATOL,
                                                CE_ZSUM_ATOL)):
            torch.testing.assert_close(got, ref, rtol=VAL_RTOL, atol=atol)
        err_f = max(float((a - b).abs().max()) for a, b in zip(stats, want))
        lse = want[0]
        gamma = row_scale(torch.ones((), device=dev), y, cfg)
        p_coeff = gamma * (1.0 + 2.0 * cfg.z_loss * lse)
        gargs = (h, w, y, lse, gamma, p_coeff, cfg)
        dh, dw = dh_grads(*gargs, **kw), dw_grads(*gargs, **kw)
        # no atomics: a second call gives the same bits
        if not (torch.equal(dh, dh_grads(*gargs, **kw))
                and torch.equal(dw, dw_grads(*gargs, **kw))):
            raise AssertionError(f"fused_ce {name}: two backward calls "
                                 "differ")
        torch.cuda.synchronize()
        rdh, rdw = ref_grads(*gargs, **kw)
        fro, err = {}, {}
        for label, got, ref in (("dh", dh, rdh), ("dw", dw, rdw)):
            torch.testing.assert_close(got, ref, rtol=CE_GRAD_RTOL,
                                       atol=CE_GRAD_ATOL)
            fro[label] = float((got - ref).norm() / ref.norm())
            err[label] = float((got - ref).abs().max())
            if not fro[label] <= CE_GRAD_FRO:
                raise AssertionError(f"fused_ce {name} {label}: relative "
                                     f"Frobenius error {fro[label]:.3g}")
        del rdh, rdw
        if valid - off < v and bool(dw[valid - off:].any()):
            raise AssertionError(f"fused_ce {name}: dW's {v - valid + off} "
                                 "pad rows are not zero")
        err_dh, err_dw = err["dh"], err["dw"]
        errs["fused_ce_fwd"] = max(errs["fused_ce_fwd"], err_f)
        errs["fused_ce_dh"] = max(errs["fused_ce_dh"], err_dh)
        errs["fused_ce_dw"] = max(errs["fused_ce_dw"], err_dw)
        print(f"[kernel] fused_ce {name} (n {n}, V {v}, d {d}, valid "
              f"{valid}, offset {off}): max_abs_err fwd {err_f:.3g}, dH "
              f"{err_dh:.3g} (rel fro {fro['dh']:.3g}), dW {err_dw:.3g} "
              f"(rel fro {fro['dw']:.3g}); forward, dH and dW two calls "
              "bit-identical", flush=True)
        row = {}
        for kind, fn, plain in (
                ("fwd", lambda: fwd_stats(h, w, y, cfg, **kw),
                 lambda: ref_stats(h, w, y, cfg, **kw)),
                ("dh", lambda: dh_grads(*gargs, **kw),
                 lambda: ref_dh(*gargs, **kw)),
                ("dw", lambda: dw_grads(*gargs, **kw),
                 lambda: ref_dw(*gargs, **kw))):
            bound, by = ce_bound_ms(kind, n, v, d)
            row[kind] = dict(ms=cuda_ms(torch, fn, iters=5, warmup=1),
                             plain_ms=cuda_ms(torch, plain, iters=2,
                                              warmup=1),
                             bound_ms=bound, bound_by=by)
        lib = {}
        if off == 0:                  # the library call has no shard offset
            hl = h.clone().requires_grad_(True)
            wl = w.clone().requires_grad_(True)

            def lib_fwd():
                with torch.no_grad():
                    library_loss(torch, h, w, y, cfg, valid)

            def lib_grad(*wrt):
                return lambda: torch.autograd.grad(
                    library_loss(torch, hl, wl, y, cfg, valid), wrt)

            lib = dict(fwd=cuda_ms(torch, lib_fwd, iters=3, warmup=1),
                       # the card's own GEMM on the forward's product: a
                       # reading of what cuBLAS reaches, not a yardstick
                       gemm=cuda_ms(torch, lambda: h @ w.T, iters=3,
                                    warmup=1),
                       dh=cuda_ms(torch, lib_grad(hl), iters=3, warmup=1),
                       dw=cuda_ms(torch, lib_grad(wl), iters=3, warmup=1),
                       both=cuda_ms(torch, lib_grad(hl, wl), iters=3,
                                    warmup=1))
            hk = h.clone().requires_grad_(True)
            wk = w.clone().requires_grad_(True)
            kcfg = LossConfig(valid_vocab=valid, **cfg_kw)

            def kernel_both():
                torch.autograd.grad(kernel_loss(hk, wk, y, kcfg), (hk, wk))

            lib["mem_mib"] = peak_mib(torch, lib_grad(hl, wl))
            lib["kernel_mem_mib"] = peak_mib(torch, kernel_both)
            lib["kernel_both"] = cuda_ms(torch, kernel_both, iters=3,
                                         warmup=1)
        for kind in ("fwd", "dh", "dw"):
            row[kind]["library_ms"] = lib.get(kind)
            r = row[kind]
            lib_txt = (f"{r['library_ms']:.3f}" if r["library_ms"]
                       is not None else "n/a")
            gemm = (f", cuBLAS h @ w.T {lib['gemm']:.3f} ms"
                    if kind == "fwd" and lib else "")
            print(f"[kernel] fused_ce_{kind} {name}: {r['ms']:.3f} ms vs "
                  f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}), plain "
                  f"{r['plain_ms']:.3f} ms, canonical loss "
                  f"{'forward' if kind == 'fwd' else 'forward + d' + kind[1]}"
                  f" {lib_txt} ms{gemm}", flush=True)
        if lib:
            print(f"[kernel] fused_ce {name} forward + backward: kernels "
                  f"{lib['kernel_both']:.3f} ms, peak {lib['kernel_mem_mib']:.0f}"
                  f" MiB above the inputs; canonical loss {lib['both']:.3f} "
                  f"ms, peak {lib['mem_mib']:.0f} MiB above the inputs",
                  flush=True)
        results[name] = row
    return results, errs


def phase_ce_wide_filter(torch, np, dev, exact, n=4096):
    """Phase 2's filtered cases past d 4096, at the shapes of
    `WIDE_IDS` (4096 rows): under an all-False mask the filtered dH and
    dW bit for bit the exact kernels, and on the peaked problem (most
    tiles skipped) held to the plain version given the same mask, dW's
    pad rows zero; timed beside the exact kernels (`exact`: phase 2's
    rows) and the bound of the live share."""
    from repro_torch.core import LossConfig
    from repro_torch.core.filtering import skipped_fraction, tile_skip_mask
    from repro_torch.core.windows import ce_tile_grid
    from repro_torch.kernels.fused_ce import (dh_grads, dw_grads, fwd_stats,
                                              ref_dh, ref_dw, ref_stats)
    from repro_torch.models.registry import get_arch
    out, worst = {}, {"dh": 0.0, "dw": 0.0}
    for arch_id in WIDE_IDS:
        wa = get_arch(arch_id)
        v, d = wa.padded_vocab, wa.cfg.d_model
        valid = v - 101
        name = f"v{v}_d{d}"
        gen = torch.Generator(device=dev).manual_seed(d)
        w = torch.randn((v, d), generator=gen, device=dev)
        w = w / w.norm(dim=1, keepdim=True)
        w[valid:] = 0.0
        y = torch.randint(0, valid, (n,), generator=gen, device=dev)
        y2 = torch.randint(0, valid, (n,), generator=gen, device=dev)
        h = (PEAK_A * w[y] + PEAK_B * w[y2] + 0.1 * torch.randn(
            (n, d), generator=gen, device=dev) / d ** 0.5).bfloat16()
        w, y = w.bfloat16(), y.to(torch.int32)
        cfg = LossConfig(grad_filter_eps=FILTER_EPS, valid_vocab=valid)
        lse, _, _, tmax = fwd_stats(h, w, y, cfg, return_tile_stats=True)
        gamma = torch.full((n,), 1.0 / n, device=dev)
        gargs = (h, w, y, lse, gamma, gamma, cfg)
        none = torch.zeros(ce_tile_grid(n, v), dtype=torch.bool, device=dev)
        mask = tile_skip_mask(tmax, lse, y, cfg, block_rows=64, block_v=64)
        frac = float(skipped_fraction(mask))
        if not frac > 0.5:
            raise AssertionError(f"{name}: {frac:.3f} of the tiles skipped")
        row = {}
        for kind, grads, plain in (("dh", dh_grads, ref_dh),
                                   ("dw", dw_grads, ref_dw)):
            ex = grads(*gargs)
            if not torch.equal(grads(*gargs, skip_mask=none), ex):
                raise AssertionError(f"{name} {kind}: the filtered kernel "
                                     "under an all-False mask is not the "
                                     "exact one bit for bit")
            got = grads(*gargs, skip_mask=mask)
            if not torch.equal(got, grads(*gargs, skip_mask=mask)):
                raise AssertionError(f"{name} {kind}: two filtered calls "
                                     "differ")
            torch.cuda.synchronize()
            want = plain(*gargs, skip_mask=mask)
            torch.testing.assert_close(got, want, rtol=CE_GRAD_RTOL,
                                       atol=CE_GRAD_ATOL)
            if kind == "dw" and bool(got[valid:].any()):
                raise AssertionError(f"{name}: dW's pad rows are not zero")
            worst[kind] = max(worst[kind], float((got - want).abs().max()))
            del ex, want
            bound, by = filtered_bound_ms(kind, n, v, d, 1.0 - frac)
            row[kind] = dict(
                ms=cuda_ms(torch, lambda: grads(*gargs, skip_mask=mask),
                           iters=3, warmup=1),
                allfalse_ms=cuda_ms(torch, lambda: grads(
                    *gargs, skip_mask=none), iters=3, warmup=1),
                exact_ms=exact[name][kind]["ms"], bound_ms=bound,
                bound_by=by)
            r = row[kind]
            print(f"[filter] {kind} {name} (n {n}, peaked, {frac:.3f} of "
                  f"the tiles skipped): filtered {r['ms']:.3f} ms vs bound "
                  f"{bound:.3f} ms ({by}), all-False mask {r['allfalse_ms']:.3f}"
                  f" ms (bit for bit the exact kernel, {r['exact_ms']:.3f} "
                  f"ms); held to the plain version given the same mask "
                  f"(max |err| {worst[kind]:.3g})", flush=True)
        out[name] = row
        del h, w, y, y2, lse, tmax, mask, none
        torch.cuda.empty_cache()
    return out, worst


def filtered_bound_ms(kind, n, v, d, live):
    """Least time on an H100 for a filtered dH or dW: `live` (the share of
    unskipped tiles) of the exact kernel's products, against the bytes of
    the exact kernel plus the (n/64, v/64) mask; with no live tile only
    the mask and the (zero) output."""
    flops = live * 2 * 2 * n * v * d
    nbytes = ((n * d * 2 + v * d * 2 + 4 * n * 4 if live else 0)
              + (n if kind == "dh" else v) * d * 4
              + -(-n // 64) * -(-v // 64))
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_tmax(torch, got, want):
    """tmax within the forward's tolerance, -inf in the same places;
    returns the max |err| over the finite entries."""
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        raise AssertionError("tile statistic: -inf in other places")
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=VAL_RTOL,
                               atol=VAL_ATOL)
    return float((got[fin] - want[fin]).abs().max())


def phase_ce_filter(torch, np, arch, dev, lib_ms, n=8 * 1024):
    """Phase 2's gradient-filter cases at the training shape: (i) the
    tile statistic, (ii) the flat random problem at FILTER_EPS (nothing
    skipped: bit for bit the exact kernels), (iii) a peaked problem (most
    tiles skipped) and (iv) an all-ignored batch."""
    from repro_torch.core import LossConfig
    from repro_torch.core.filtering import skipped_fraction, tile_skip_mask
    from repro_torch.core.streaming import row_scale
    from repro_torch.kernels.fused_ce import (dh_grads, dw_grads, fwd_stats,
                                              ref_dh, ref_dw, ref_stats)

    d, v, valid = arch.cfg.d_model, arch.padded_vocab, arch.vocab_size
    out = {"errs": {}}

    def problem(seed, peaked=False, ign=0.0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        w = torch.randn((v, d), generator=gen, device=dev) / d ** 0.5
        w[valid:] = 0.0                             # the padded head rows
        y = torch.randint(0, valid, (n,), generator=gen, device=dev)
        if peaked:
            y2 = torch.randint(0, valid, (n,), generator=gen, device=dev)
            h = PEAK_A * w[y] + PEAK_B * w[y2] + 0.1 * torch.randn(
                (n, d), generator=gen, device=dev) / d ** 0.5
        else:
            h = torch.randn((n, d), generator=gen, device=dev)
        if ign:
            drop = torch.rand((n,), generator=gen, device=dev) < ign
            y = torch.where(drop, -100, y)
        return h.bfloat16(), w.bfloat16(), y.to(torch.int32)

    # (i) the tile statistic: 10% ignored rows, and a col_offset shard
    errs = []
    for name, rows, off, seed in (("ignore10pct", n, 0, 21),
                                  ("ragged1000_offset", min(n, 1000), 4096,
                                   22)):
        h, w, y = problem(seed, ign=0.1)
        h, y = h[:rows].contiguous(), y[:rows].contiguous()
        cfg = LossConfig(grad_filter_eps=FILTER_EPS)
        kw = dict(col_offset=off, total_valid=valid + off)
        got = fwd_stats(h, w, y, cfg, return_tile_stats=True, **kw)
        exact = fwd_stats(h, w, y, cfg, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got[:3], exact):
            if not torch.equal(a, b):
                raise AssertionError(f"tile statistic {name}: the row "
                                     "statistics moved")
        want = ref_stats(h, w, y, cfg, return_tile_stats=True, **kw)[3]
        errs.append(check_tmax(torch, got[3], want))
        mask_k = tile_skip_mask(got[3], got[0], y, cfg, block_rows=64,
                                block_v=64, col_offset=off)
        mask_p = tile_skip_mask(want, got[0], y, cfg, block_rows=64,
                                block_v=64, col_offset=off)
        flips = int((mask_k != mask_p).sum())
        row = dict(ms=cuda_ms(torch, lambda: fwd_stats(
            h, w, y, cfg, return_tile_stats=True, **kw), iters=5, warmup=1),
            exact_ms=cuda_ms(torch, lambda: fwd_stats(h, w, y, cfg, **kw),
                             iters=5, warmup=1),
            plain_ms=cuda_ms(torch, lambda: ref_stats(
                h, w, y, cfg, return_tile_stats=True, **kw), iters=2,
                warmup=1))
        bound, by = ce_bound_ms("fwd", rows, v, d)
        row.update(bound_ms=bound + got[3].numel() * 4 / H100_BYTES_PER_S
                   * 1e3, bound_by=by, library_ms=lib_ms.get("fwd")
                   if off == 0 else None)
        out[f"stats_{name}"] = row
        print(f"[filter] tile statistic {name} (n {rows}, grid "
              f"{tuple(got[3].shape)}): lse, z*, sum z bit-identical to the "
              f"call without it; tmax max_abs_err {errs[-1]:.3g}, -inf in "
              f"the same {int(torch.isneginf(want).sum())} places; "
              f"{flips} mask entries flip between the kernel's and the "
              f"plain tmax at eps {FILTER_EPS}; {row['ms']:.3f} ms vs "
              f"{row['exact_ms']:.3f} ms without it, bound "
              f"{row['bound_ms']:.3f} ms ({by}), plain "
              f"{row['plain_ms']:.3f} ms", flush=True)
        del got, exact, want
    out["errs"]["fused_ce_fwd_tile_stats"] = max(errs)

    def grads_case(name, h, w, y, cfg, expect):
        lse, _, _, tmax = fwd_stats(h, w, y, cfg, return_tile_stats=True)
        mask = tile_skip_mask(tmax, lse, y, cfg, block_rows=64, block_v=64)
        plain_tmax = ref_stats(h, w, y, cfg, return_tile_stats=True)[3]
        flips = int((mask != tile_skip_mask(
            plain_tmax, lse, y, cfg, block_rows=64, block_v=64)).sum())
        del plain_tmax
        frac = float(skipped_fraction(mask))
        gamma = row_scale(torch.ones((), device=dev), y, cfg)
        gargs = (h, w, y, lse, gamma, gamma, cfg)
        fdh = dh_grads(*gargs, skip_mask=mask)
        fdw = dw_grads(*gargs, skip_mask=mask)
        edh, edw = dh_grads(*gargs), dw_grads(*gargs)
        torch.cuda.synchronize()
        expect(frac, fdh, fdw, edh, edw)
        err, fro = {}, {}
        for label, got, plain in (("dh", fdh, ref_dh), ("dw", fdw, ref_dw)):
            ref = plain(*gargs, skip_mask=mask)
            torch.testing.assert_close(got, ref, rtol=CE_GRAD_RTOL,
                                       atol=CE_GRAD_ATOL)
            err[label] = float((got - ref).abs().max())
            norm = float(ref.norm())
            fro[label] = float((got - ref).norm()) / norm if norm else 0.0
            if not fro[label] <= CE_GRAD_FRO:
                raise AssertionError(f"filtered {label} {name}: relative "
                                     f"Frobenius error {fro[label]:.3g}")
            del ref
        scale = max(float(edh.abs().max()), float(edw.abs().max()))
        dev_ = max(float((fdh - edh).abs().max()),
                   float((fdw - edw).abs().max()))
        if not dev_ <= FILTER_DEV * scale:
            raise AssertionError(f"{name}: filtered grads deviate {dev_:.3g} "
                                 f"from the exact ones, above 2^-8 of "
                                 f"{scale:.3g}")
        row = {}
        for kind, fn, efn, plain in (
                ("dh", lambda: dh_grads(*gargs, skip_mask=mask),
                 lambda: dh_grads(*gargs),
                 lambda: ref_dh(*gargs, skip_mask=mask)),
                ("dw", lambda: dw_grads(*gargs, skip_mask=mask),
                 lambda: dw_grads(*gargs),
                 lambda: ref_dw(*gargs, skip_mask=mask))):
            bound, by = filtered_bound_ms(kind, n, v, d, 1.0 - frac)
            row[kind] = dict(ms=cuda_ms(torch, fn, iters=3, warmup=1),
                             exact_ms=cuda_ms(torch, efn, iters=3, warmup=1),
                             plain_ms=cuda_ms(torch, plain, iters=2,
                                              warmup=1),
                             bound_ms=bound, bound_by=by, skipped=frac,
                             max_abs_err=err[kind])
            r = row[kind]
            print(f"[filter] {name} {kind}: skipped {frac:.4f} of "
                  f"{mask.numel()} tiles ({flips} flip between the kernel's "
                  f"and the plain tmax); max_abs_err {err[kind]:.3g} (rel "
                  f"fro {fro[kind]:.3g}) vs the plain version on the same "
                  f"mask; deviation from the exact grads {dev_:.3g} (limit "
                  f"{FILTER_DEV * scale:.3g}); {r['ms']:.3f} ms vs bound "
                  f"{r['bound_ms']:.3f} ms ({by}), exact kernel "
                  f"{r['exact_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                  f"canonical loss forward + d{kind[1]} (exact gradient) "
                  f"{lib_ms.get(kind, float('nan')):.3f} ms", flush=True)
        return row

    # (ii) the flat random problem: nothing to skip at FILTER_EPS
    def flat_expect(frac, fdh, fdw, edh, edw):
        if frac != 0.0 or not (torch.equal(fdh, edh)
                               and torch.equal(fdw, edw)):
            raise AssertionError(f"flat problem: skipped {frac}, or the "
                                 "filtered grads differ from the exact")

    h, w, y = problem(7)
    out["flat"] = grads_case("flat", h, w, y,
                             LossConfig(grad_filter_eps=FILTER_EPS),
                             flat_expect)
    del h, w, y

    # (iii) the peaked problem: most tiles skipped
    def peaked_expect(frac, fdh, fdw, edh, edw):
        if not frac > 0.5:
            raise AssertionError(f"peaked problem skipped only {frac}")

    h, w, y = problem(8, peaked=True)
    print(f"[filter] peaked problem: h = {PEAK_A} W[y] + {PEAK_B} W[y2] + "
          f"0.1 N(0, 1/d), W rows N(0, 1/d) (norm ~1), eps {FILTER_EPS}",
          flush=True)
    out["peaked"] = grads_case("peaked", h, w, y,
                               LossConfig(grad_filter_eps=FILTER_EPS),
                               peaked_expect)
    out["errs"]["fused_ce_dh_filtered"] = max(
        out[c]["dh"]["max_abs_err"] for c in ("flat", "peaked"))
    out["errs"]["fused_ce_dw_filtered"] = max(
        out[c]["dw"]["max_abs_err"] for c in ("flat", "peaked"))
    del h, w, y

    # (iv) an all-ignored batch: every tile skipped, exact zeros
    h, w, y = problem(9, ign=1.0)
    cfg = LossConfig(grad_filter_eps=FILTER_EPS)
    lse, _, _, tmax = fwd_stats(h, w, y, cfg, return_tile_stats=True)
    mask = tile_skip_mask(tmax, lse, y, cfg, block_rows=64, block_v=64)
    zero = torch.zeros((n,), device=dev)
    fdh = dh_grads(h, w, y, lse, zero, zero, cfg, skip_mask=mask)
    fdw = dw_grads(h, w, y, lse, zero, zero, cfg, skip_mask=mask)
    torch.cuda.synchronize()
    if not bool(mask.all()) or bool(fdh.any()) or bool(fdw.any()):
        raise AssertionError("all-ignored batch: not every tile skipped, or "
                             "a non-zero gradient")
    ms = {k: cuda_ms(torch, fn, iters=3, warmup=1) for k, fn in (
        ("dh", lambda: dh_grads(h, w, y, lse, zero, zero, cfg,
                                skip_mask=mask)),
        ("dw", lambda: dw_grads(h, w, y, lse, zero, zero, cfg,
                                skip_mask=mask)))}
    print(f"[filter] all-ignored batch: skipped 1.0, dH = dW = 0 exactly; "
          f"dh {ms['dh']:.3f} ms, dw {ms['dw']:.3f} ms (bounds "
          f"{filtered_bound_ms('dh', n, v, d, 0.0)[0]:.3f} / "
          f"{filtered_bound_ms('dw', n, v, d, 0.0)[0]:.3f} ms, bytes)",
          flush=True)
    return out


def phase_train(torch, np, arch, card, dev):
    from repro_torch import obs
    from repro_torch.data import (DataConfig, DeviceLoader, SyntheticLM,
                                  to_device)
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_ce import (DH_LAUNCHES, DW_LAUNCHES,
                                              FWD_LAUNCHES)
    from repro_torch.kernels.sample_topk import LAUNCHES as TOPK_LAUNCHES
    from repro_torch.kernels.sample_topk import ROWS_LAUNCHES
    from repro_torch.train import (TrainConfig, build_loss_fn,
                                   build_train_step, train_loop)

    t0 = time.perf_counter()
    tc = TrainConfig(peak_lr=3e-3, warmup_steps=max(TRAIN_STEPS // 10, 1),
                     total_steps=TRAIN_STEPS, loss_impl="kernel",
                     loss_block_v=min(2048, arch.padded_vocab))
    init_fn, step_fn = build_train_step(arch, tc)
    state = init_fn(torch.Generator(device=dev).manual_seed(0), dev)
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size, seq_len=1024,
                                  global_batch=8, seed=0))
    print(f"[train] set-up {time.perf_counter() - t0:.1f}s: {arch.arch_id} "
          f"{arch.cfg.n_layers} layers d={arch.cfg.d_model} vocab "
          f"{arch.vocab_size} (head {arch.padded_vocab}) "
          f"{arch.cfg.param_dtype}, batch 8 x "
          f"seq 1024, AdamW lr {tc.peak_lr} warmup {tc.warmup_steps}",
          flush=True)

    # step 0 through the kernels against the canonical loss
    batch0 = to_device(data.batch(0), dev)
    head = state["params"]["lm_head"]
    step0 = {}
    for impl in ("kernel", "canonical"):
        loss_fn = build_loss_fn(arch, TrainConfig(
            loss_impl=impl, loss_block_v=tc.loss_block_v))
        loss, _ = loss_fn(state["params"], batch0)
        (g_head,) = torch.autograd.grad(loss, [head])
        step0[impl] = (float(loss.detach()), g_head)
    (lk, gk), (lc, gc) = step0["kernel"], step0["canonical"]
    loss_err = abs(lk - lc) / abs(lc)
    head_fro = float((gk.float() - gc.float()).norm() / gc.float().norm())
    del step0, gk, gc
    if not (loss_err <= TRAIN_LOSS_RTOL and head_fro <= TRAIN_HEAD_FRO):
        raise AssertionError(f"step 0: kernel loss {lk} vs canonical {lc} "
                             f"(rel {loss_err:.3g}), lm_head grad rel fro "
                             f"{head_fro:.3g}")
    print(f"[train] step 0, kernels vs canonical loss: loss {lk:.6f} vs "
          f"{lc:.6f} (rel {loss_err:.3g}, limit {TRAIN_LOSS_RTOL}), bf16 "
          f"lm_head grad rel fro {head_fro:.3g} (limit {TRAIN_HEAD_FRO})",
          flush=True)

    reg, tracer = obs.enable(trace=True)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_counters()
        t0 = time.perf_counter()
        state, history = train_loop(
            state=state, step_fn=step_fn, data=DeviceLoader(data, dev),
            num_steps=TRAIN_STEPS, log_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fused_ce_fwd": FWD_LAUNCHES.count,
                    "fused_ce_dh": DH_LAUNCHES.count,
                    "fused_ce_dw": DW_LAUNCHES.count}
        topk = TOPK_LAUNCHES.count + ROWS_LAUNCHES.count
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        obs.disable()
    losses = [m["loss"] for _, m in history]
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if any(c != TRAIN_STEPS for c in launches.values()) or topk:
        raise AssertionError(f"launches {launches}, sample_topk {topk}, "
                             f"over {TRAIN_STEPS} steps")
    steps = [s.duration for s in tracer.spans if s.name == "train.step"]
    p50 = float(np.median(steps[1:])) * 1e3
    print(f"[train] {TRAIN_STEPS} steps in {wall:.2f}s, loss "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; grad norm {history[0][1]['grad_norm']:.3f} -> "
          f"{history[-1][1]['grad_norm']:.3f}", flush=True)
    print(f"[train] launches {launches} = one of each a step, sample_topk "
          f"{topk}; step {p50:.1f} ms p50 over steps 1-{TRAIN_STEPS - 1} "
          f"(" + ", ".join(f"{x * 1e3:.1f}" for x in steps) + " ms), "
          f"{8 * 1024 / (p50 / 1e3):.0f} tokens/s, peak memory {peak:.2f} "
          f"GiB on {card}", flush=True)

    # one more step under the profiler: where the device time goes
    from torch.profiler import ProfilerActivity, profile
    batch = to_device(data.batch(TRAIN_STEPS), dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, by_name, kernels = 0.0, {}, 0
    for evt in prof.events():             # one stream: kernels never overlap
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        busy += us
        kernels += 1
        key = evt.name.replace("(anonymous namespace)::", "")
        key = key.removeprefix("void ").split("(")[0][:70]
        by_name[key] = by_name.get(key, 0.0) + us
    if not busy:
        raise AssertionError("the profiler saw no device time")
    fce_ms = sum(us for k, us in by_name.items() if "fce_" in k) / 1e3
    print(f"[train] profiled step: wall {wall_ms:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms in {kernels} kernels (idle share "
          f"{1 - busy / 1e3 / wall_ms:.3f}); fused-CE kernels {fce_ms:.1f} "
          f"ms ({100 * fce_ms / (busy / 1e3):.1f}% of busy): "
          + ", ".join(f"{k} {v / 1e3:.2f}" for k, v in sorted(
              by_name.items()) if "fce_" in k), flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print("[train] profiled step, top device kernels (ms): "
          + "; ".join(f"{k} {v / 1e3:.2f}" for k, v in top), flush=True)
    return launches, p50, state


def train_run(torch, np, build, tc, arch, dev, data, steps, prepare=None):
    """`steps` steps of `train_loop` from a seeded init (then
    ``prepare(params)``, in place, where given), the launch counters
    zeroed just before the loop; returns (state, history, counts, step ms
    of steps 1.., peak GiB)."""
    from repro_torch import obs
    from repro_torch.data import DeviceLoader
    from repro_torch.train import build_train_step, train_loop
    init_fn, step_fn = build_train_step(arch, tc)
    state = init_fn(torch.Generator(device=dev).manual_seed(0), dev)
    if prepare is not None:
        prepare(state["params"])
    reg, tracer = obs.enable(trace=True)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_counters()
        state, history = train_loop(
            state=state, step_fn=step_fn, data=DeviceLoader(data, dev),
            num_steps=steps, log_every=1)
        torch.cuda.synchronize()
        counts = {k: c.count for k, c in build.COUNTERS.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        obs.disable()
    spans = [sp.duration * 1e3 for sp in tracer.spans
             if sp.name == "train.step"]
    losses = [m["loss"] for _, m in history]
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}")
    return state, history, counts, spans[1:], peak


def head_grad(torch, build_loss_fn, arch, tc, params, batch):
    """(loss, bf16 lm_head gradient) of one loss evaluation."""
    loss_fn = build_loss_fn(arch, tc)
    loss, _ = loss_fn(params, batch)
    (g,) = torch.autograd.grad(loss, [params["lm_head"]])
    return float(loss.detach()), g


def phase_train_filtered(torch, np, arch, card, dev, phase4_p50):
    """Phase 8: filtered training, MTP heads and gradient accumulation at
    full width."""
    import dataclasses
    from repro_torch.configs import with_mtp
    from repro_torch.core import filtering
    from repro_torch.core.streaming import row_scale
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_ce import dw_grads, fwd_stats, ref_dw
    from repro_torch.kernels.sample_topk import cuda_topk
    from repro_torch.models.registry import forward_hidden
    from repro_torch.train import (TrainConfig, build_loss_fn,
                                   build_train_step)

    tok = TRAIN_BATCH * TRAIN_SEQ
    base = TrainConfig(peak_lr=3e-3, warmup_steps=max(TRAIN_STEPS // 10, 1),
                       total_steps=TRAIN_STEPS, loss_impl="kernel",
                       loss_block_v=min(2048, arch.padded_vocab))
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size,
                                  seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0))
    batch0 = to_device(data.batch(0), dev)
    masks = []
    real_mask = filtering.tile_skip_mask

    def recording(*a, **k):
        masks.append(real_mask(*a, **k))
        return masks[-1]

    filtering.tile_skip_mask = recording
    out = {"launches": {}}
    try:
        # (a) and (b): the filter at eps 1e-5 (only the pad-only vocab
        # tiles go) and 1e-3 (almost every target-free tile while the
        # logits are flat), step-0 checks first
        for tag, eps in zip("ab", FILTER_TRAIN_EPS):
            tc = dataclasses.replace(base, grad_filter_eps=eps)
            init_fn = build_train_step(arch, tc)[0]
            params = init_fn(torch.Generator(device=dev).manual_seed(0),
                             dev)["params"]
            lx, gx = head_grad(torch, build_loss_fn, arch,
                               dataclasses.replace(tc, grad_filter_eps=0.0),
                               params, batch0)
            masks.clear()
            lf, gf = head_grad(torch, build_loss_fn, arch, tc, params,
                               batch0)
            frac0 = float(filtering.skipped_fraction(masks[0]))
            if lf != lx:
                raise AssertionError(f"({tag}) step-0 loss {lf} through the "
                                     f"tile-stat forward vs {lx} exact")
            if tag == "a":
                # at random init only the head's pad tiles (no valid
                # column: tmax -inf, bound 0) may go, and they add zeros
                live_tiles = -(-arch.vocab_size // 64)
                if bool(masks[0][:, :live_tiles].any()):
                    raise AssertionError("(a) step 0 skipped a tile with "
                                         "valid columns")
                if not torch.equal(gf, gx):
                    raise AssertionError("(a) step-0 lm_head grad differs "
                                         "from the exact kernels'")
                print(f"[filter-train] (a) eps {eps}: step 0 skips "
                      f"{int(masks[0].sum())} of {masks[0].numel()} tiles "
                      f"({frac0:.3g}), all in the head's "
                      f"{masks[0].shape[1] - live_tiles} pad-only vocab "
                      f"tiles; loss {lf:.6f} and bf16 lm_head grad "
                      f"bit-identical to the exact kernels'", flush=True)
            else:
                # the lm_head grad in f32 through the filtered dW kernel
                # against the plain version on the kernel's own mask
                with torch.no_grad():
                    h, _, _ = forward_hidden(arch, params, batch0)
                    rows = h.reshape(-1, h.shape[-1])
                    y = batch0["targets"].reshape(-1)
                    cfg = arch.loss_config(block_v=tc.loss_block_v,
                                           grad_filter_eps=eps)
                    w = params["lm_head"]
                    lse, _, _, tmax = fwd_stats(rows, w, y, cfg,
                                                return_tile_stats=True)
                    mask = real_mask(tmax, lse, y, cfg, block_rows=64,
                                     block_v=64)
                    gamma = row_scale(torch.ones((), device=dev), y, cfg)
                    gargs = (rows, w, y, lse, gamma, gamma, cfg)
                    kdw = dw_grads(*gargs, skip_mask=mask)
                    pdw = ref_dw(*gargs, skip_mask=mask)
                torch.testing.assert_close(kdw, pdw, rtol=CE_GRAD_RTOL,
                                           atol=CE_GRAD_ATOL)
                fro = float((kdw - pdw).norm() / pdw.norm())
                if not fro <= CE_GRAD_FRO:
                    raise AssertionError(f"(b) step-0 lm_head grad rel fro "
                                         f"{fro:.3g}")
                # the step's own gradient: its mask is the one above and
                # its bf16 lm_head grad is that filtered dW, cast
                if not torch.equal(masks[0], mask):
                    raise AssertionError("(b) the step's skip mask differs "
                                         "from the one its own tile "
                                         "statistic gives")
                same = torch.equal(kdw.to(gf.dtype), gf)
                if not same:
                    raise AssertionError(
                        "(b) the step's bf16 lm_head grad is not the "
                        "filtered dW kernel's on the step's mask, cast; max "
                        f"diff {float((kdw - gf.float()).abs().max()):.3g}")
                print(f"[filter-train] (b) eps {eps}: step 0 skips "
                      f"{frac0:.4f} of {masks[0].numel()} tiles; loss "
                      f"{lf:.6f} bit-identical to the exact path's; f32 "
                      f"lm_head grad vs the plain filtered version on the "
                      f"kernel's mask: max_abs_err "
                      f"{float((kdw - pdw).abs().max()):.3g}, rel fro "
                      f"{fro:.3g}; the step's mask is that mask and its "
                      f"bf16 grad is that grad cast: {same}", flush=True)
                del h, rows, kdw, pdw
            del params, gx, gf
            torch.cuda.empty_cache()
            masks.clear()
            state, hist, counts, ms, peak = train_run(
                torch, np, build, tc, arch, dev, data, TRAIN_STEPS)
            losses = [m["loss"] for _, m in hist]
            if not losses[-1] < losses[0]:
                raise AssertionError(f"({tag}) loss did not fall: {losses}")
            want = {"fused_ce_fwd": TRAIN_STEPS,
                    "fused_ce_dh_filtered": TRAIN_STEPS,
                    "fused_ce_dw_filtered": TRAIN_STEPS,
                    "fused_ce_dh": 0, "fused_ce_dw": 0, "sample_topk": 0,
                    "sample_topk_rows": 0}
            got = {k: counts.get(k, 0) for k in want}
            if got != want or len(masks) != TRAIN_STEPS:
                raise AssertionError(f"({tag}) launches {got}, {len(masks)} "
                                     f"masks over {TRAIN_STEPS} steps")
            fracs = [float(filtering.skipped_fraction(m)) for m in masks]
            if tag == "b" and not min(fracs) > 0.0:
                raise AssertionError(f"(b) skipped fractions {fracs}")
            for k in ("fused_ce_fwd", "fused_ce_dh_filtered",
                      "fused_ce_dw_filtered"):
                out["launches"][k] = out["launches"].get(k, 0) + got[k]
            p50 = float(np.median(ms))
            print(f"[filter-train] ({tag}) eps {eps}, {TRAIN_STEPS} steps: "
                  f"loss " + " ".join(f"{x:.4f}" for x in losses)
                  + "; skipped " + " ".join(f"{f:.4f}" for f in fracs)
                  + f"; launches {got}; step {p50:.1f} ms p50 over steps "
                  f"1-{TRAIN_STEPS - 1} (" + ", ".join(f"{x:.1f}" for x in ms)
                  + f" ms), {tok / (p50 / 1e3):.0f} tokens/s against phase "
                  f"4's {phase4_p50:.1f} ms ({tok / (phase4_p50 / 1e3):.0f} "
                  f"tokens/s), peak {peak:.2f} GiB on {card}", flush=True)
            out[tag] = dict(p50=p50, fracs=fracs, peak=peak)
            del state
            torch.cuda.empty_cache()
    finally:
        filtering.tile_skip_mask = real_mask

    # (c) two MTP heads, two microbatches, the exact kernels
    march = with_mtp(arch, 2, head_depth=1, track_accuracy=True)
    tc = dataclasses.replace(base, total_steps=MTP_STEPS, grad_accum=2)
    init_fn = build_train_step(march, tc)[0]
    params = init_fn(torch.Generator(device=dev).manual_seed(0),
                     dev)["params"]
    step0 = {}
    with torch.no_grad():
        for impl in ("kernel", "canonical"):
            loss_fn = build_loss_fn(march, dataclasses.replace(
                tc, loss_impl=impl))
            step0[impl] = sum(float(loss_fn(params, {
                k: v.reshape((2, TRAIN_BATCH // 2) + tuple(v.shape[1:]))[i]
                for k, v in batch0.items()})[0]) for i in range(2)) / 2
    del params
    torch.cuda.empty_cache()
    rel = abs(step0["kernel"] - step0["canonical"]) / abs(step0["canonical"])
    state, hist, counts, ms, peak = train_run(
        torch, np, build, tc, march, dev, data, MTP_STEPS)
    h0 = hist[0][1]
    rel_step = abs(h0["loss"] - step0["canonical"]) / abs(step0["canonical"])
    if not (rel <= TRAIN_LOSS_RTOL and rel_step <= TRAIN_LOSS_RTOL):
        raise AssertionError(f"(c) step-0 loss {h0['loss']} (kernels, no "
                             f"grad {step0['kernel']}) vs canonical "
                             f"{step0['canonical']}")
    per = (1 + 2) * 2
    want = {"fused_ce_fwd": per * MTP_STEPS, "fused_ce_dh": per * MTP_STEPS,
            "fused_ce_dw": per * MTP_STEPS, "sample_topk": 0,
            "sample_topk_rows": per * MTP_STEPS,
            "fused_ce_dh_filtered": 0, "fused_ce_dw_filtered": 0}
    got = {k: counts.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"(c) launches {got}, want {want}")
    for _, m in hist:
        for key in [f"{p}_h{i}" for p in ("ce", "acc") for i in range(3)]:
            if not np.isfinite(m[key]):
                raise AssertionError(f"(c) {key} = {m[key]}")
        if not all(0.0 <= m[f"acc_h{i}"] <= 1.0 for i in range(3)):
            raise AssertionError(f"(c) accuracies {m}")
    p50 = float(np.median(ms))
    w = state["params"]["lm_head"]
    rows = torch.randn((tok // 2, arch.cfg.d_model), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(3)
                       ).to(w.dtype)
    topk_ms = cuda_ms(torch, lambda: cuda_topk(
        rows, w, 1, valid_vocab=arch.vocab_size), iters=5, warmup=1)
    wv = w[:arch.vocab_size]
    topk_lib_ms = cuda_ms(torch, lambda: torch.topk(rows @ wv.T, 1),
                          iters=5, warmup=1)
    print(f"[mtp-train] (c) 2 MTP heads (depth 1), grad_accum 2, eps 0, "
          f"{MTP_STEPS} steps: step-0 loss {h0['loss']:.6f} vs canonical "
          f"{step0['canonical']:.6f} (rel {rel_step:.3g}, limit "
          f"{TRAIN_LOSS_RTOL}); launches {got} = (1 + 2) x 2 a step; "
          + "; ".join(f"step {i}: " + " ".join(
              f"{k} {m[k]:.4f}" for k in sorted(m) if k[:3] in ("ce_",
                                                             "acc"))
              for i, m in hist), flush=True)
    print(f"[mtp-train] (c) step {p50:.1f} ms p50 over steps 1-"
          f"{MTP_STEPS - 1} (" + ", ".join(f"{x:.1f}" for x in ms)
          + f" ms), {tok / (p50 / 1e3):.0f} tokens/s, peak {peak:.2f} GiB; "
          f"sample_topk k=1 (many-row kernel) at {tok // 2} rows "
          f"{topk_ms:.3f} ms (bound "
          f"{topk_bound_ms(tok // 2, arch.cfg.d_model, arch.padded_vocab, 1)[0]:.3f}"
          f" ms), torch.topk(h @ w.T, 1) {topk_lib_ms:.3f} ms on {card}",
          flush=True)
    out["c"] = dict(p50=p50, peak=peak, topk_ms=topk_ms,
                    topk_lib_ms=topk_lib_ms, launches=got)
    del state
    torch.cuda.empty_cache()
    return out


def state_bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def opt_tensors(opt):
    """The optimizer state's tensors: AdamW's moments or Adafactor's
    slots."""
    if "slots" in opt:
        return [t for slot in opt["slots"] for t in slot.values()]
    return list(opt["mu"]) + list(opt["nu"])


def clone_state(state):
    """A deep copy of a train state, its params fresh autograd leaves."""
    def tree(x):
        if isinstance(x, dict):
            return {k: tree(v) for k, v in x.items()}
        if isinstance(x, list):
            return [tree(v) for v in x]
        return x.detach().clone().requires_grad_(x.requires_grad)

    opt = {k: tree(v) if k in ("slots", "mu", "nu") else v
           for k, v in state["opt"].items()}
    return {"params": tree(state["params"]), "opt": opt,
            "step": state["step"]}


def state_diff(a, b):
    """Largest |a - b| over the params of two train states (0.0: equal)."""
    from repro_torch.optim.tree import leaves
    return max(float((x.detach().float() - y.detach().float()).abs().max())
               for x, y in zip(leaves(a["params"]), leaves(b["params"])))


def check_same_state(torch, tag, got, want):
    """Every leaf bit for bit (dtype, device and values), counters equal."""
    from repro_torch.optim.tree import leaves
    pairs = list(zip(leaves(got["params"]), leaves(want["params"])))
    pairs += list(zip(opt_tensors(got["opt"]), opt_tensors(want["opt"])))
    if len(pairs) != len(leaves(want["params"])) + len(
            opt_tensors(want["opt"])):
        raise AssertionError(f"{tag}: the states differ in structure")
    for x, y in pairs:
        if (x.dtype, x.shape, x.device) != (y.dtype, y.shape, y.device) \
                or not torch.equal(x.detach(), y.detach()):
            raise AssertionError(f"{tag}: a leaf differs ({x.dtype} "
                                 f"{tuple(x.shape)} on {x.device})")
    if (got["step"], got["opt"]["count"]) != (want["step"],
                                              want["opt"]["count"]):
        raise AssertionError(f"{tag}: step / count {got['step']} / "
                             f"{got['opt']['count']} against "
                             f"{want['step']} / {want['opt']['count']}")
    return len(pairs)


def phase_ckpt_adamw(torch, np, arch, state, card, dev, workdir):
    """Phase 9 (e): phase 4's final AdamW state at full width saved
    synchronously, `save_async`'s blocking snapshot timed apart, and the
    restore onto the card bit for bit; returns the moments' bytes."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.optim.tree import leaves
    from repro_torch.train import TrainConfig, build_train_step

    opt_bytes = state_bytes(opt_tensors(state["opt"]))
    gb = (state_bytes(leaves(state["params"])) + opt_bytes) / 1e9
    ck = Checkpointer(os.path.join(workdir, "adamw"), keep_n=1)
    step = state["step"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save(step, state)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck.save_async(step + 1, state)
    snap_s = time.perf_counter() - t0
    ck.wait()
    async_s = time.perf_counter() - t0
    if ck.all_steps() != [step + 1]:
        raise AssertionError(f"(e) steps on disk {ck.all_steps()}")
    tc = TrainConfig(peak_lr=3e-3, warmup_steps=max(TRAIN_STEPS // 10, 1),
                     total_steps=TRAIN_STEPS, loss_impl="kernel",
                     loss_block_v=min(2048, arch.padded_vocab))
    example = build_train_step(arch, tc)[0](torch.Generator(), "meta")
    t0 = time.perf_counter()
    back, got_step = ck.restore(example, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    n = check_same_state(torch, "(e)", back, state)
    del back
    torch.cuda.empty_cache()
    print(f"[ckpt] (e) AdamW at full width, step {step}: {gb:.3f} GB "
          f"({opt_bytes / 1e9:.3f} GB of f32 moments); save {save_s:.2f} s "
          f"({gb / save_s:.2f} GB/s), save_async's blocking snapshot "
          f"{snap_s:.2f} s ({gb / snap_s:.2f} GB/s) and its write "
          f"{async_s - snap_s:.2f} s after it, restore onto the card "
          f"{restore_s:.2f} s ({gb / restore_s:.2f} GB/s); {n} leaves bit "
          f"for bit, step {got_step} on {card}", flush=True)
    return opt_bytes


def phase_checkpoint(torch, np, arch, card, dev, phase4_p50, adamw_opt_bytes,
                     workdir):
    """Phase 9 (a)-(d): Adafactor through the training CLI with
    checkpoints, the restore, the resume through the CLI and a
    preemption, at full width."""
    import types
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import DataConfig, DeviceLoader, SyntheticLM
    from repro_torch.data import to_device
    from repro_torch.distributed import PreemptionHandler
    from repro_torch.kernels import build
    from repro_torch.launch import train as train_cli
    from repro_torch.optim.tree import leaves
    from repro_torch.train import build_train_step, resume_or_init, train_loop

    d_a = os.path.join(workdir, "adafactor")
    flags = ["--arch", arch.arch_id, "--loss-impl", "kernel",
             "--global-batch", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ),
             "--lr", "3e-3", "--optimizer", "adafactor", "--ckpt-dir", d_a,
             "--ckpt-every", "2", "--log-every", "1"]

    def tc_for(steps):
        return train_cli.train_config(types.SimpleNamespace(
            optimizer="adafactor", lr=3e-3, steps=steps, loss_impl="kernel",
            grad_accum=1, grad_filter_eps=0.0), arch)

    def launches():           # every kernel launched since the reset
        return {k: c.count for k, c in build.COUNTERS.items() if c.count}

    def check_launches(tag, got, steps):
        want = {"fused_ce_fwd": steps, "fused_ce_dh": steps,
                "fused_ce_dw": steps}
        if got != want:
            raise AssertionError(f"{tag} launches {got}, want {want}")

    # (a) Adafactor through the CLI, checkpoints at steps 2 and 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_counters()
    t0 = time.perf_counter()
    state_a, hist = train_cli.main(flags + ["--steps", "4"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_launches("(a)", counts, 4)
    losses = [m["loss"] for _, m in hist]
    if [i for i, _ in hist] != [0, 1, 2, 3] or not np.all(
            np.isfinite(losses)):
        raise AssertionError(f"(a) history {hist}")
    steps_on_disk = Checkpointer(d_a).all_steps()
    if steps_on_disk != [2, 4]:
        raise AssertionError(f"(a) checkpoints at {steps_on_disk}")
    ms = [m["step_time_s"] * 1e3 for _, m in hist]
    p50 = float(np.median(ms[1:]))
    slot_bytes = state_bytes(opt_tensors(state_a["opt"]))
    print(f"[ckpt] (a) Adafactor through the CLI, 4 steps at batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, checkpoints every 2: loss "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; launches {counts} = one of each exact fused-CE kernel a step; "
          f"checkpoints {steps_on_disk}; {wall:.1f} s for the CLI; step "
          f"{p50:.1f} ms p50 over steps 1-3 (" + ", ".join(
              f"{x:.1f}" for x in ms) + f" ms) against phase 4's AdamW "
          f"{phase4_p50:.1f} ms; peak memory {peak:.2f} GiB; optimizer state "
          f"{slot_bytes / 1e6:.3f} MB of factored slots against AdamW's "
          f"{adamw_opt_bytes / 1e9:.3f} GB of f32 moments on {card}",
          flush=True)

    # (b) the restore: step 4, every leaf bit for bit
    init_fn = build_train_step(arch, tc_for(4))[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state_b = resume_or_init(Checkpointer(d_a), init_fn, gen, dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    n = check_same_state(torch, "(b)", state_b, state_a)
    del state_b
    print(f"[ckpt] (b) resume_or_init: step 4, {n} leaves (bf16 params, "
          f"f32 slots) bit for bit the CLI's final state, in {restore_s:.2f} "
          f"s on {card}", flush=True)

    # (c) resume through the CLI to step 6: steps 4 and 5 on batches 0, 1
    build.reset_counters()
    state_c, hist = train_cli.main(flags + ["--steps", "6"])
    torch.cuda.synchronize()
    counts = launches()
    check_launches("(c)", counts, 2)
    if [i for i, _ in hist] != [4, 5]:
        raise AssertionError(f"(c) history steps {[i for i, _ in hist]}")
    step6 = build_train_step(arch, tc_for(6))[1]
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size,
                                  seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0))
    copies = []
    for _ in range(2):        # (a)'s in-memory state, continued twice
        copy = clone_state(state_a)
        for b in range(2):
            copy, _ = step6(copy, to_device(data.batch(b), dev))
        copies.append(copy)
    torch.cuda.synchronize()
    run_diff = state_diff(copies[0], copies[1])
    resume_diff = state_diff(state_c, copies[0])
    if state_c["step"] != 6 or not resume_diff <= run_diff:
        raise AssertionError(f"(c) resumed params differ from the "
                             f"continuation by {resume_diff}, the card's "
                             f"run-to-run difference is {run_diff}")
    print(f"[ckpt] (c) CLI resume to 6: history steps 4, 5 on batches 0, 1 "
          f"(the reference's data restart), launches {counts}; resumed "
          f"params vs (a)'s state continued on the same batches: max |diff| "
          f"{resume_diff:.3g}; two continuations from copies: {run_diff:.3g} "
          f"on {card}", flush=True)
    del state_a, state_c, copies
    torch.cuda.empty_cache()

    # (d) a stop request after the first step: saved at 1, stopped there
    d_d = os.path.join(workdir, "preempt")
    ck = Checkpointer(d_d)
    ph = PreemptionHandler()
    init_fn, step4 = build_train_step(arch, tc_for(4))
    state_d = init_fn(gen, dev)
    state_d, hist = train_loop(
        state=state_d, step_fn=step4, data=DeviceLoader(data, dev),
        num_steps=4, checkpointer=ck, checkpoint_every=100, log_every=1,
        preemption=ph, metrics_hook=lambda i, m: ph.request_stop())
    if (state_d["step"], len(hist), ck.latest_step(), ck.all_steps()) != (
            1, 1, 1, [1]):
        raise AssertionError(f"(d) step {state_d['step']}, {len(hist)} "
                             f"logged, checkpoints {ck.all_steps()}")
    print(f"[ckpt] (d) stop requested after step 0: the loop saved step 1 "
          f"and stopped; latest_step() {ck.latest_step()} on {card}",
          flush=True)
    del state_d
    torch.cuda.empty_cache()


def serve_prompts(np, vocab):
    """Phase 3's traffic: 16 prompts of seeded lengths 16..200."""
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 201, 16)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lens]


def shared_prompts(np, vocab):
    """Phase 5's traffic: one 128-token system prompt plus a seeded
    8..64-token suffix, 16 prompts."""
    rng = np.random.default_rng(5)
    system = rng.integers(1, vocab, 128).astype(np.int32)
    return [np.concatenate([system, rng.integers(1, vocab, n).astype(
        np.int32)]) for n in rng.integers(8, 65, 16)]


def best_logit_deficit(torch, np, arch, params, prompts, outs, dev):
    """(worst, agree): how far each served token's logit trails the best
    one of a cache-free forward over its request (teacher-forced), and
    whether it is that best token."""
    from repro_torch.kernels.sample_topk import topk_scores_ref
    from repro_torch.models.registry import forward_hidden
    worst, agree = 0.0, []
    head = params["lm_head"]
    with torch.no_grad():
        for prompt, out in zip(prompts, outs):
            seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
            h, _, _ = forward_hidden(arch, params, {
                "tokens": torch.from_numpy(seq[None]).to(dev)})
            hp = h[0, len(prompt) - 1:]
            vals, ids = topk_scores_ref(hp, head, 1,
                                        valid_vocab=arch.vocab_size)
            served = torch.from_numpy(out.astype(np.int64)).to(dev)
            z = (hp.float() * head[served].float()).sum(-1)
            worst = max(worst, float((vals[:, 0] - z).max()))
            agree.append(ids[:, 0].cpu().numpy() == out)
    return worst, np.concatenate(agree)


def phase_serve(torch, np, arch, card, dev):
    from repro_torch import obs
    from repro_torch.kernels import build
    from repro_torch.kernels.sample_topk import LAUNCHES, topk_scores_ref
    from repro_torch.models.registry import forward_hidden, init_params
    from repro_torch.serve import ContinuousScheduler, Engine, ServeConfig

    t0 = time.perf_counter()
    params = init_params(arch, torch.Generator(device=dev).manual_seed(0),
                         dev)
    eng = Engine(arch, params, ServeConfig(batch_size=8, max_len=512),
                 device=dev)
    eng.generate([np.arange(1, 20), np.arange(5, 90)], 4)   # warm-up
    torch.cuda.synchronize()
    print(f"[serve] set-up {time.perf_counter() - t0:.1f}s: qwen3-0.6b "
          f"{arch.cfg.n_layers} layers d={arch.cfg.d_model} vocab "
          f"{arch.vocab_size} (head {arch.padded_vocab}) bf16, "
          f"batch 8, max_len 512", flush=True)

    prompts = serve_prompts(np, arch.vocab_size)
    reg, tracer = obs.enable(trace=True)
    try:
        eng = Engine(arch, params, ServeConfig(batch_size=8, max_len=512),
                     device=dev)
        sched = ContinuousScheduler(eng, max_new_tokens=32)
        build.reset_counters()
        t0 = time.perf_counter()
        rids = [sched.submit(p) for p in prompts]
        results = sched.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = LAUNCHES.count
    finally:
        obs.disable()

    outs = [results[r] for r in rids]
    if any(len(o) != 32 for o in outs):
        raise AssertionError("a request did not get its 32 tokens")
    if not all(((o >= 0) & (o < arch.vocab_size)).all() for o in outs):
        raise AssertionError("a generated id lies outside the vocab")
    prefills = len(sched.admit_order)
    expect = prefills + sched.decode_steps
    if launches != expect:
        raise AssertionError(f"sample_topk launched {launches} times, "
                             f"expected {prefills} prefills + "
                             f"{sched.decode_steps} decode steps")
    print(f"[serve] sample_topk launches {launches} = {prefills} prefills "
          f"+ {sched.decode_steps} decode steps", flush=True)

    # teacher-forced re-score of request 0: one cache-free forward; at
    # every position the served token's logit is held to the best one
    seq = np.concatenate([prompts[0], outs[0][:-1]])
    with torch.no_grad():
        h, _, _ = forward_hidden(arch, params, {"tokens": torch.from_numpy(
            seq[None].astype(np.int64)).to(dev)})
        hp = h[0, len(prompts[0]) - 1:]                    # (32, d)
        head = params["lm_head"]
        vals, ids = topk_scores_ref(hp, head, 2, valid_vocab=arch.vocab_size)
        served = torch.from_numpy(outs[0].astype(np.int64)).to(dev)
        z_served = (hp.float() * head[served].float()).sum(-1)
    deficit = (vals[:, 0] - z_served).cpu().numpy()
    vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
    agree = ids[:, 0] == outs[0]
    if deficit.max() > GREEDY_TOL:
        bad = np.flatnonzero(deficit > GREEDY_TOL).tolist()
        raise AssertionError(
            f"served tokens trail the cache-free forward's best logit by "
            f"more than {GREEDY_TOL} at positions {bad} (deficits "
            f"{deficit[bad].tolist()})")
    print(f"[serve] request 0 vs cache-free forward: {agree.mean():.3f} of "
          f"{len(agree)} greedy tokens equal; served logit trails the best "
          f"by at most {max(float(deficit.max()), 0.0):.3g} (limit "
          f"{GREEDY_TOL}); top-2 gap median "
          f"{float(np.median(vals[:, 0] - vals[:, 1])):.3g}", flush=True)

    steps = [s.duration for s in tracer.spans
             if s.name == "engine.decode_step"]
    prefill = [s.duration for s in tracer.spans
               if s.name == "engine.prefill"]
    st = sched.stats()
    total = sum(len(o) for o in outs)
    print(f"[serve] {len(rids)} requests, {total} tokens in {dt:.3f}s: "
          f"{total / dt:.1f} tok/s, decode step {np.mean(steps) * 1e3:.2f} "
          f"ms mean ({np.median(steps) * 1e3:.2f} p50), prefill "
          f"{np.median(prefill) * 1e3:.2f} ms p50, TTFT p50 "
          f"{st['ttft_s']['p50'] * 1e3:.1f} ms (queue incl.), occupancy "
          f"{st['occupancy']:.3f} on {card}", flush=True)
    return launches, params


def paged_bound_ms(q, kp, lens, capacity):
    """Least time on an H100: each row's live K and V entries (positions
    below its length) read once, q read and the output written once; the
    2 + 2 flops per key, head dim and query row are far below the bf16
    tensor-core line."""
    b, tq, nq, hd = q.shape
    nkv = kp.shape[2]
    tokens = int(lens.clamp(max=capacity).sum())
    nbytes = tokens * nkv * hd * 2 * 2 + 2 * q.numel() * 2
    flops = 4 * tokens * nq * tq * hd
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_paged_attn(torch, np, dev):
    import torch.nn.functional as F
    from repro_torch.core.windows import paged_plan
    from repro_torch.kernels.paged_attn import (gather_paged_kv,
                                                paged_attention,
                                                paged_attention_ref)

    b, bs, nb = 8, 16, 32
    cases = [("decode", 1, None, "seeded"), ("full512", 1, None, "full"),
             ("tq4_softcap30", 4, 30.0, "seeded"), ("ghost", 1, None, "zero"),
             ("null_poison", 1, None, "poison"),
             # the speculative verifier's 8 x (4 + 1) rows (phase 6)
             ("tq5", 5, None, "seeded"),
             # seamless-m4t-medium's decode (phase 15 (b)): 16 query over
             # 16 KV heads (group 1), head_dim 64
             ("encdec_hd64", 1, None, "seeded", (16, 16, 64)),
             # qwen3-moe-235b-a22b's decode (phase 12 (c)): 64 query over
             # 4 KV heads (group 16), head_dim 128
             ("group16", 1, None, "seeded", (64, 4, 128))]
    results = {}
    for i, (name, tq, cap, kind, *shape) in enumerate(cases):
        # qwen3-0.6b's heads: 16 query over 8 KV heads of 128
        nq, nkv, hd = shape[0] if shape else (16, 8, 128)
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        n_pool = b * nb + 1
        kp = torch.randn((n_pool, bs, nkv, hd), generator=gen,
                         device=dev).bfloat16()
        vp = torch.randn((n_pool, bs, nkv, hd), generator=gen,
                         device=dev).bfloat16()
        perm = torch.randperm(n_pool - 1, generator=gen, device=dev) + 1
        table = perm[:b * nb].reshape(b, nb).to(torch.int32).contiguous()
        lens = torch.randint(16, nb * bs + 1, (b,), generator=gen,
                             device=dev, dtype=torch.int32)
        if kind == "full":
            lens.fill_(nb * bs)
        elif kind == "zero":
            lens.zero_()
        elif kind == "poison":
            kp[0] = 1e9
            vp[0] = 1e9
            table[:, 4:] = 0                  # chains of 4 blocks, then null
            lens = torch.randint(tq, 4 * bs + 1, (b,), generator=gen,
                                 device=dev, dtype=torch.int32)
        q = torch.randn((b, tq, nq, hd), generator=gen,
                        device=dev).bfloat16()
        out = paged_attention(q, kp, vp, table, lens, softcap=cap)
        torch.cuda.synchronize()
        ref = paged_attention_ref(q, kp, vp, table, lens, softcap=cap)
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=PAGED_ATOL, rtol=PAGED_RTOL)
        if kind == "zero" and bool(out.abs().max() != 0):
            raise AssertionError("paged_attn: ghost rows are not zero")
        err = float((out.float() - ref.float()).abs().max())
        def call():
            return paged_attention(q, kp, vp, table, lens, softcap=cap)

        if not torch.equal(out, call()):
            raise AssertionError(f"paged_attn {name}: two calls differ")
        # the kernel's own time, and the event time over back-to-back
        # calls, which at a few microseconds a launch is the host's rate
        ms = device_ms(torch, call, (("kernel", "paged_attn"),))["kernel"]
        event_ms = cuda_ms(torch, call, iters=50)
        plain_ms = cuda_ms(torch, lambda: paged_attention_ref(
            q, kp, vp, table, lens, softcap=cap))
        # the yardstick: SDPA over the gathered chains, causal on absolute
        # positions through a boolean mask (timed only; GQA by the call)
        kg = gather_paged_kv(kp, table).transpose(1, 2)
        vg = gather_paged_kv(vp, table).transpose(1, 2)
        qpos = lens.long()[:, None] - tq + torch.arange(tq, device=dev)
        mask = (torch.arange(nb * bs, device=dev)[None, None, :]
                <= qpos[:, :, None])[:, None]
        qt = q.transpose(1, 2)
        library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask, enable_gqa=True), iters=50)
        bound_ms, bound_by = paged_bound_ms(q, kp, lens, nb * bs)
        sp = paged_plan(b, nkv, nb, bs, hd, nq // nkv * tq)
        results[name] = dict(max_abs_err=err, ms=ms, event_ms=event_ms,
                             plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        print(f"[kernel] paged_attn {name} (B {b}, Tq {tq}, nq {nq}, nkv "
              f"{nkv}, hd {hd}, bs {bs}, nb {nb}, lens "
              f"{lens.min().item()}..{lens.max().item()}, softcap {cap}; "
              f"plan {sp.splits} splits of {sp.pages} pages, {sp.keys}-key "
              f"tiles, {sp.smem_bytes} B): max_abs_err {err:.3g} (atol "
              f"{PAGED_ATOL}), two calls bit-identical; device {ms:.4f} ms "
              f"vs bound {bound_ms:.4f} ms ({bound_by}), events over "
              f"back-to-back calls {event_ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, sdpa over the gathered K/V {library_ms:.4f} ms",
              flush=True)
    return results


def phase_paged_serve(torch, np, arch, params, card, dev):
    from repro_torch import obs
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attn import LAUNCHES as PAGED_LAUNCHES
    from repro_torch.kernels.sample_topk import LAUNCHES as TOPK_LAUNCHES
    from repro_torch.serve import (ContinuousScheduler, Engine, PagedEngine,
                                   ServeConfig)

    n_layers = arch.cfg.n_layers
    sc = ServeConfig(batch_size=8, max_len=512, paged=True, block_size=16)
    t0 = time.perf_counter()
    eng = PagedEngine(arch, params, sc, device=dev)
    warm = np.arange(1, 40)
    eng.generate([warm, np.concatenate([warm, [7, 8, 9]])], 4)   # warm-up
    torch.cuda.synchronize()
    print(f"[paged] set-up {time.perf_counter() - t0:.1f}s: qwen3-0.6b "
          f"{n_layers} layers, PagedEngine batch 8, max_len 512, block 16, "
          f"{eng.paged_stats()['pool_blocks']} pool blocks", flush=True)

    prompts = shared_prompts(np, arch.vocab_size)
    reg, tracer = obs.enable(trace=True)
    try:
        eng = PagedEngine(arch, params, sc, device=dev)
        peak_blocks = [0]
        per_req = []                        # live pool bytes a request

        def on_token(rid, tok, done):       # pool blocks in use, at peak
            peak_blocks[0] = max(peak_blocks[0], eng.pool.used_blocks)
            per_req.append(eng.live_cache_bytes() / max(sched.active, 1))

        sched = ContinuousScheduler(eng, max_new_tokens=32,
                                    on_token=on_token)
        build.reset_counters()
        t0 = time.perf_counter()
        rids = [sched.submit(p) for p in prompts]
        results = sched.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {"paged_attn": PAGED_LAUNCHES.count,
                    "sample_topk": TOPK_LAUNCHES.count}
    finally:
        obs.disable()
    outs = [results[r] for r in rids]
    if any(len(o) != 32 for o in outs):
        raise AssertionError("a request did not get its 32 tokens")
    prefills, steps = len(sched.admit_order), sched.decode_steps
    if launches["paged_attn"] != steps * n_layers:
        raise AssertionError(f"paged_attn launched {launches['paged_attn']}"
                             f" times, expected {steps} decode steps x "
                             f"{n_layers} layers")
    if launches["sample_topk"] != prefills + steps:
        raise AssertionError(f"sample_topk launched "
                             f"{launches['sample_topk']} times, expected "
                             f"{prefills} prefills + {steps} decode steps")
    ps = eng.paged_stats()
    pre = ps["prefix"]
    if pre["hits"] != 15 or pre["hit_blocks"] != 15 * 8:
        raise AssertionError(f"prefix cache: {pre['hits']} hits of "
                             f"{pre['hit_blocks']} blocks, expected 15 of 8")
    print(f"[paged] launches {launches}: paged_attn = {steps} decode steps x "
          f"{n_layers} layers, sample_topk = {prefills} prefills + {steps} "
          f"decode steps; prefix hits {pre['hits']} of {pre['lookups']} "
          f"lookups, {pre['hit_blocks']} blocks", flush=True)

    # every served token against a cache-free forward of its request
    worst, agree = best_logit_deficit(torch, np, arch, params, prompts,
                                      outs, dev)
    if worst > GREEDY_TOL:
        raise AssertionError(f"paged: a served token trails the cache-free "
                             f"forward's best logit by {worst:.3g} > "
                             f"{GREEDY_TOL}")

    slab = Engine(arch, params, ServeConfig(batch_size=8, max_len=512),
                  device=dev)
    slab_sched = ContinuousScheduler(slab, max_new_tokens=32)
    slab_rids = [slab_sched.submit(p) for p in prompts]
    slab_res = slab_sched.run()
    same = np.mean([np.mean(results[r] == slab_res[q])
                    for r, q in zip(rids, slab_rids)])

    step_ms = [x.duration * 1e3 for x in tracer.spans
               if x.name == "engine.decode_step"]
    pf = [x for x in tracer.spans if x.name == "engine.prefill"]
    cold = [x.duration * 1e3 for x in pf if not x.args.get("ext")]
    hit = [x.duration * 1e3 for x in pf if x.args.get("ext")]
    ext_rid = {rid: bool(x.args.get("ext"))
               for rid, x in zip(sched.admit_order, pf)}
    ttft_cold = [sched.ttft[r] * 1e3 for r, e in ext_rid.items() if not e]
    ttft_hit = [sched.ttft[r] * 1e3 for r, e in ext_rid.items() if e]
    total = sum(len(o) for o in outs)
    pool_bytes = ps["block_bytes"] * ps["pool_blocks"]
    log = eng.prefill_token_log
    print(f"[paged] {len(rids)} requests, {total} tokens in {dt:.3f}s: "
          f"{total / dt:.1f} tok/s, decode step {np.median(step_ms):.2f} ms "
          f"p50 ({np.mean(step_ms):.2f} mean, {steps} steps); prefill p50 "
          f"cold {np.median(cold):.2f} ms ({len(cold)}), hit "
          f"{np.median(hit):.2f} ms ({len(hit)}); TTFT p50 (queue incl.) "
          f"cold {np.median(ttft_cold):.1f} ms, hit {np.median(ttft_hit):.1f}"
          f" ms, all {sched.stats()['ttft_s']['p50'] * 1e3:.1f} ms; prefill "
          f"tokens {ps['prefill_tokens']} (cold bucket {log[0]}, hits "
          f"{min(log[1:])}..{max(log[1:])}), {pre['hit_tokens']} prompt "
          f"tokens reused; pool in use at peak {peak_blocks[0]} of "
          f"{ps['pool_blocks']} blocks ({peak_blocks[0] * ps['block_bytes']}"
          f" B of {pool_bytes} B), at the end {ps['live_cache_bytes']} B "
          f"({ps['used_blocks']} blocks, {pre['resident_blocks']} held by "
          f"the trie) on {card}", flush=True)
    print(f"[paged] served tokens vs cache-free forward: {agree.mean():.3f} "
          f"of {agree.size} greedy tokens equal, served logit trails the "
          f"best by at most {max(worst, 0.0):.3g} (limit {GREEDY_TOL}); "
          f"{same:.3f} of tokens equal to the slab Engine's on the same "
          f"requests (not gated)", flush=True)
    return launches, float(np.mean(per_req))


def score_bound_ms(rows, d, v, p):
    """Least time on an H100: h, W and the ids read once, lse and the
    candidate logits written once; 2*rows*d*v bf16 operations."""
    nbytes = rows * d * 2 + v * d * 2 + rows * p * 4 * 2 + rows * 4
    flops = 2 * rows * d * v
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_score(torch, np, arch, dev):
    from repro_torch.core.windows import score_plan
    from repro_torch.kernels.score_tokens import (score_stats,
                                                  score_stats_ref,
                                                  score_tokens)

    gen = torch.Generator(device=dev).manual_seed(4321)
    d, v, valid = arch.cfg.d_model, arch.padded_vocab, arch.vocab_size
    w_head = torch.randn((v, d), generator=gen, device=dev) / d ** 0.5
    w_head[valid:] = 0.0                           # the padded head rows
    w_head = w_head.bfloat16()
    # paper-lm's width (d 4096, V 32768), mistral-large's d 12288 and d
    # 16384: a CTA's shared memory does not grow with d
    wide = {dw: (torch.randn((32768, dw), generator=gen, device=dev)
                 / dw ** 0.5).bfloat16() for dw in (4096, 12288, 16384)}
    # recurrentgemma-9b's head, 256000 x 4096 (phase 13 (c)), and
    # xlstm-125m's, 50432 x 768 with 50304 valid rows (phase 14 (d))
    wide["v256000"] = (torch.randn((256000, 4096), generator=gen,
                                   device=dev) / 64).bfloat16()
    wide["v50432"] = torch.randn((50432, 768), generator=gen,
                                 device=dev) / 768 ** 0.5
    wide["v50432"][XLSTM_VALID:] = 0.0
    wide["v50432"] = wide["v50432"].bfloat16()
    # seamless-m4t-medium's, 256256 x 1024, 256206 valid (phase 15 (c))
    wide["v256256"] = encdec_head(torch, gen, dev)
    wide_valid = {"v50432": XLSTM_VALID, "v256256": ENCDEC_VALID}
    cases = [
        # name, rows, P, softcap, temperature, col_offset, wide head
        ("spec_rows32_t0.7", 32, 1, None, 0.7, 0, None),
        ("self_prefill_rows4_t0.7", 4, 1, None, 0.7, 0, None),
        ("eval_rows8", 8, 1, None, None, 0, None),
        ("rows32_p4_softcap30", 32, 4, 30.0, None, 0, None),
        ("rows1000_offset", 1000, 1, None, None, 4096, None),
        ("d4096_rows32_p1", 32, 1, None, 0.7, 0, 4096),
        ("d4096_rows100_p64", 100, 64, None, None, 0, 4096),
        ("d12288_rows32_p1", 32, 1, None, 0.7, 0, 12288),
        ("d16384_rows40_p4", 40, 4, None, None, 0, 16384),
        ("v256000_rows32_p1", 32, 1, None, None, 0, "v256000"),
        ("v50432_rows32_p1", 32, 1, None, None, 0, "v50432"),
        ("v256256_rows32_p1", 32, 1, None, None, 0, "v256256"),
    ]
    # past 64 candidates a row: groups of 64 a CTA, W streamed again a
    # group (through L2 where the slice's neighbours brought it in)
    for p_big in (65, 128, 256):
        cases.append((f"rows8_p{p_big}", 8, p_big, None, 0.7, 0, None))
        cases.append((f"v256256_rows8_p{p_big}", 8, p_big, None, None, 0,
                      "v256256"))
    results = {}
    for name, rows, p, cap, temp, off, dw in cases:
        if dw:
            w = wide[dw]
            v, d = w.shape
            valid = wide_valid.get(dw, v)
        else:
            d, v, valid = arch.cfg.d_model, arch.padded_vocab, arch.vocab_size
            w = w_head
        h = torch.randn((rows, d), generator=gen, device=dev).bfloat16()
        tot_valid = valid + off                  # shard [off, off + v)
        ids = torch.randint(off, off + valid, (rows, p), generator=gen,
                            device=dev, dtype=torch.int32)
        if p > 1:
            # a duplicate, then -1, an id past valid, a pad row of the
            # head and one past the head, in turn
            ids[:, 1] = ids[:, 0]
            odd = torch.tensor([-1, valid, valid + 50, v + 3],
                               dtype=torch.int32, device=dev)
            ids[:, 3] = odd.repeat(rows // 4 + 1)[:rows]
        if off:
            ids[::7, 0] = torch.randint(0, off, (len(ids[::7]),),
                                        generator=gen, device=dev,
                                        dtype=torch.int32)
        kw = dict(valid_vocab=tot_valid, logit_softcap=cap,
                  temperature=temp, col_offset=off)
        lse, zc = score_stats(h, w, ids, **kw)
        lse2, zc2 = score_stats(h, w, ids, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(lse, lse2) and torch.equal(zc, zc2)):
            raise AssertionError(f"score_tokens {name}: two calls differ")
        rl, rz = score_stats_ref(h, w, ids, **kw)
        torch.testing.assert_close(lse, rl, rtol=VAL_RTOL, atol=VAL_ATOL)
        torch.testing.assert_close(zc, rz, rtol=VAL_RTOL, atol=VAL_ATOL)
        err = max(float((lse - rl).abs().max()), float((zc - rz).abs().max()))
        logp, _ = score_tokens(h, w, ids, **kw)
        want_inf = (ids < 0) | (ids >= tot_valid)   # the JAX ops rule
        if not torch.equal(torch.isneginf(logp), want_inf):
            raise AssertionError(f"score_tokens {name}: -inf misplaced")
        if off == 0 and bool((logp[~want_inf] > 1e-5).any()):
            raise AssertionError(f"score_tokens {name}: a logp above 0")
        ms = cuda_ms(torch, lambda: score_stats(h, w, ids, **kw), iters=50)
        part_ms, merge_ms = split_ms(
            torch, lambda: score_stats(h, w, ids, **kw), iters=50)
        plain_ms = cuda_ms(torch, lambda: score_stats_ref(h, w, ids, **kw),
                           iters=5)
        library_ms = None
        if off == 0:                  # the library call has no shard offset
            def library():
                z = (h @ w[:valid].T).float()
                if cap is not None:
                    z = cap * torch.tanh(z / cap)
                if temp is not None:
                    z = z / temp
                return torch.log_softmax(z, -1).gather(
                    1, ids.clamp(0, valid - 1).long())
            library_ms = cuda_ms(torch, library, iters=20)
        bound_ms, bound_by = score_bound_ms(rows, d, v, p)
        sp = score_plan(rows, v, p)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms,
                             bound_by=bound_by, partial_ms=part_ms,
                             merge_ms=merge_ms)
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        print(f"[kernel] score_tokens {name} (rows {rows}, P {p}, d {d}, V "
              f"{v}, valid {tot_valid}, offset {off}, softcap {cap}, T "
              f"{temp}): max_abs_err {err:.3g} (rtol {VAL_RTOL}, atol "
              f"{VAL_ATOL}), two calls bit-identical, -inf where JAX puts "
              f"it; plan R {sp.rows} x {sp.row_tiles} row tiles, "
              f"{sp.slices} slices of {sp.per} tiles, {sp.stages} stages, "
              f"{sp.smem_bytes} B; device: stream kernel {part_ms:.4f} ms + "
              f"merge {merge_ms:.4f} ms; call {ms:.4f} ms vs bound "
              f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
              f"log_softmax(h @ w.T).gather {lib} ms", flush=True)
    return results


def counted_run(torch, np, make_engine, submit, build, obs, max_new=32):
    """Build an engine under live tracing and drive a scheduler over it
    (`max_new` tokens a request), every launch counter zeroed just
    before and read just after; records each step's (tokens, counts).
    Returns (engine, sched, results, rids, seconds, launches, steps,
    tracer)."""
    from repro_torch.serve import ContinuousScheduler

    steps = []
    eng = None
    reg, tracer = obs.enable(trace=True)
    try:
        eng = make_engine()
        inner = eng.decode_step_multi

        def recording():
            toks, counts = inner()
            steps.append((toks.copy(), counts.copy()))
            return toks, counts

        eng.decode_step_multi = recording
        sched = ContinuousScheduler(eng, max_new_tokens=max_new)
        build.reset_counters()
        t0 = time.perf_counter()
        rids = submit(sched)
        results = sched.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: c.count for k, c in build.COUNTERS.items()}
    finally:
        obs.disable()
        # the wrapper holds the engine: drop it, or the engine (and the
        # params it holds) outlives its last reference until a gc pass
        if eng is not None:
            eng.__dict__.pop("decode_step_multi", None)
    return eng, sched, results, rids, dt, launches, steps, tracer


def spec_summary(np, tag, sched, results, rids, dt, tracer, card):
    outs = [results[r] for r in rids]
    total = sum(len(o) for o in outs)
    step_ms = [x.duration * 1e3 for x in tracer.spans if x.name == "spec.step"]
    st = sched.stats()
    print(f"[spec] {tag}: {len(rids)} requests, {total} tokens in {dt:.3f}s: "
          f"{total / dt:.1f} tok/s, spec step {np.median(step_ms):.2f} ms p50 "
          f"({np.mean(step_ms):.2f} mean, {len(step_ms)} steps), acceptance "
          f"{sched.acceptance_rate:.4f} ({sched.spec_accepted} of "
          f"{sched.spec_drafted} drafts), {sched.tokens_per_step:.3f} tokens "
          f"a slot-step, TTFT p50 {st['ttft_s']['p50'] * 1e3:.1f} ms (queue "
          f"incl.) on {card}", flush=True)


def check_spec_outputs(np, tag, arch, results, rids, steps):
    outs = [results[r] for r in rids]
    if any(len(o) != 32 for o in outs):
        raise AssertionError(f"{tag}: a request did not get its 32 tokens")
    if not all(((o >= 0) & (o < arch.vocab_size)).all() for o in outs):
        raise AssertionError(f"{tag}: an emitted id lies outside the vocab")
    counts = np.concatenate([c for _, c in steps])
    if counts.min() < 1 or counts.max() > SPEC_K + 1:
        raise AssertionError(f"{tag}: counts outside 1..{SPEC_K + 1}")


def spy_scores(spec_mod, calls):
    """Wrap the speculative engines' scorer `_score_lp` so that every call
    records its inputs, keywords and output; returns the real one."""
    real = spec_mod._score_lp

    def spy(h2, w, ids, **kw):
        out = real(h2, w, ids, **kw)
        calls.append((h2.clone(), w, ids.clone(), kw, out.clone()))
        return out

    spec_mod._score_lp = spy
    return real


def check_scores(torch, tag, calls, lm_heads, valid, cap, temp):
    """Every recorded scoring call passed the vocab, softcap and sampling
    temperature its model serves at, the served lm_heads took equal
    shares of the calls (draft and target in the sidecar step), and the
    logps equal the plain
    version's (f32 logits, TF32 off) plus the -inf rule within VAL_RTOL /
    VAL_ATOL.  Returns (calls, max |err|)."""
    from repro_torch.kernels.score_tokens import score_stats_ref

    per_head = [sum(w is x for _, w, _, _, _ in calls) for x in lm_heads]
    if not calls or per_head != [len(calls) // len(lm_heads)] * len(
            lm_heads) or sum(per_head) != len(calls):
        raise AssertionError(f"{tag}: {len(calls)} scoring calls, by "
                             f"lm_head {per_head}: each head should take "
                             "an equal share")
    err = 0.0
    for h2, w, ids, kw, got in calls:
        ws = kw.get("w_scale")
        if {k: v for k, v in kw.items() if k != "w_scale"} != dict(
                valid=valid, cap=cap, temp=temp) or ws is not None:
            raise AssertionError(f"{tag}: a scoring call passed {kw}, "
                                 f"expected valid {valid}, cap {cap}, T "
                                 f"{temp} and a bf16 head")
        lse, z = score_stats_ref(h2, w, ids, valid_vocab=valid,
                                 logit_softcap=cap, temperature=temp)
        ok = (ids >= 0) & (ids < valid)
        want = torch.where(ok, z - lse[:, None], float("-inf"))
        if not torch.equal(torch.isneginf(got), ~ok):
            raise AssertionError(f"{tag}: a step's -inf is misplaced")
        torch.testing.assert_close(got[ok], want[ok], rtol=VAL_RTOL,
                                   atol=VAL_ATOL)
        err = max(err, float((got[ok] - want[ok]).abs().max()))
    return len(calls), err


def phase_spec(torch, np, arch, card, dev):
    """Phase 6; returns (params with MTP heads, score_tokens launches,
    sample_topk decode-kernel launches, paged_attn launches)."""
    from repro_torch import obs
    from repro_torch.configs.base import with_mtp
    from repro_torch.kernels import build
    from repro_torch.models import attention
    from repro_torch.models.registry import init_params
    from repro_torch.serve import (PagedSelfSpecEngine, SelfSpecEngine,
                                   ServeConfig, SpecConfig, SpecEngine,
                                   small_draft)
    from repro_torch.serve import spec as spec_mod

    n_layers = arch.cfg.n_layers
    arch6 = with_mtp(arch, SPEC_K)
    # the same trunk as phases 3 and 5 (same seed, drawn first), plus heads
    params = init_params(arch6, torch.Generator(device=dev).manual_seed(0),
                         dev)
    spec = SpecConfig(k=SPEC_K)
    warm = [np.arange(1, 40), np.arange(1, 43)]
    score_launches = topk_launches = 0

    # (a) paged self-speculation, rejection mode, phase 5's traffic
    sc = ServeConfig(batch_size=8, max_len=512, temperature=0.7, top_k=40,
                     paged=True, block_size=16)
    t0 = time.perf_counter()
    PagedSelfSpecEngine(arch6, params, sc, spec, device=dev).generate(
        warm, 8)
    torch.cuda.synchronize()
    print(f"[spec] set-up {time.perf_counter() - t0:.1f}s: qwen3-0.6b "
          f"{n_layers} layers + {SPEC_K} MTP heads, k {SPEC_K}", flush=True)
    prompts = shared_prompts(np, arch.vocab_size)
    real_paged = attention.paged_attention
    tq_seen = {}

    def recording_paged(q, *a, **kw):      # the Tq of every paged call
        tq_seen[q.shape[1]] = tq_seen.get(q.shape[1], 0) + 1
        return real_paged(q, *a, **kw)

    attention.paged_attention = recording_paged
    calls = []
    real_score = spy_scores(spec_mod, calls)
    try:
        eng, sched, results, rids, dt, launches, steps, tracer = \
            counted_run(torch, np, lambda: PagedSelfSpecEngine(
                arch6, params, sc, spec, device=dev),
                lambda s: [s.submit(p) for p in prompts], build, obs)
    finally:
        attention.paged_attention = real_paged
        spec_mod._score_lp = real_score
    tag = "paged self-spec, T 0.7"
    check_spec_outputs(np, tag, arch, results, rids, steps)
    n_calls, err = check_scores(torch, tag, calls, [params["lm_head"]],
                                arch.vocab_size, arch.cfg.logit_softcap,
                                sc.temperature)
    del calls
    print(f"[spec] {tag}: all {n_calls} scoring calls (prefill heads, "
          f"verifier, redraft) at T {sc.temperature} equal the plain "
          f"version's logps within {err:.3g} (rtol {VAL_RTOL}, atol "
          f"{VAL_ATOL})", flush=True)
    n_steps, prefills = len(steps), len(sched.admit_order)
    want = {"score_tokens": 2 * n_steps + prefills,
            "sample_topk": 2 * n_steps + 2 * prefills,
            "paged_attn": n_layers * n_steps}
    got = {k: launches.get(k, 0) for k in want}
    if got != want or tq_seen != {SPEC_K + 1: n_layers * n_steps}:
        raise AssertionError(f"{tag}: launches {got}, expected {want}; "
                             f"paged calls by Tq {tq_seen}")
    pre = eng.paged_stats()["prefix"]
    if pre["hits"] != 15:
        raise AssertionError(f"{tag}: {pre['hits']} prefix hits, not 15")
    score_launches += got["score_tokens"]
    topk_launches += got["sample_topk"]
    spec_paged = got["paged_attn"]
    print(f"[spec] {tag}: launches {got} = score_tokens 2 a step x "
          f"{n_steps} + 1 a prefill x {prefills}, sample_topk 2 a step + 2 "
          f"a prefill, paged_attn {n_layers} a step, all at Tq "
          f"{SPEC_K + 1}; prefix hits {pre['hits']}", flush=True)
    spec_summary(np, tag, sched, results, rids, dt, tracer, card)

    # (b) slab SpecEngine, rejection mode, a 1-layer full-width draft
    cfg = arch.cfg
    draft_arch, draft_params = small_draft(
        arch, seed=7, device=dev, d_model=cfg.d_model,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, d_ff=cfg.d_ff)
    sc = ServeConfig(batch_size=8, max_len=512, temperature=0.7, top_k=40)
    SpecEngine(arch6, params, sc, draft_arch, draft_params, spec,
               device=dev).generate(warm, 8)
    prompts = serve_prompts(np, arch.vocab_size)
    calls = []
    real_score = spy_scores(spec_mod, calls)
    try:
        eng, sched, results, rids, dt, launches, steps, tracer = \
            counted_run(torch, np, lambda: SpecEngine(
                arch6, params, sc, draft_arch, draft_params, spec,
                device=dev), lambda s: [s.submit(p) for p in prompts],
                build, obs)
    finally:
        spec_mod._score_lp = real_score
    tag = f"sidecar draft (1 layer, d {cfg.d_model}), T 0.7"
    check_spec_outputs(np, tag, arch, results, rids, steps)
    n_calls, err = check_scores(
        torch, tag, calls, [params["lm_head"], draft_params["lm_head"]],
        arch.vocab_size, arch.cfg.logit_softcap, sc.temperature)
    del calls
    print(f"[spec] {tag}: all {n_calls} scoring calls (draft and target) "
          f"at T {sc.temperature} equal the plain version's logps within "
          f"{err:.3g} (rtol {VAL_RTOL}, atol {VAL_ATOL})", flush=True)
    n_steps, prefills = len(steps), len(sched.admit_order)
    want = {"score_tokens": 2 * n_steps,
            "sample_topk": (SPEC_K + 1) * n_steps + 2 * prefills}
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, expected {want}")
    score_launches += got["score_tokens"]
    topk_launches += got["sample_topk"]
    print(f"[spec] {tag}: launches {got} = score_tokens 2 a step x "
          f"{n_steps}, sample_topk {SPEC_K + 1} a step + 2 a prefill x "
          f"{prefills}", flush=True)
    spec_summary(np, tag, sched, results, rids, dt, tracer, card)
    del eng, draft_params

    # (c) slab SelfSpecEngine, greedy: exact against a cache-free forward
    sc = ServeConfig(batch_size=8, max_len=512)
    SelfSpecEngine(arch6, params, sc, spec, device=dev).generate(warm, 8)
    eng, sched, results, rids, dt, launches, steps, tracer = counted_run(
        torch, np, lambda: SelfSpecEngine(arch6, params, sc, spec,
                                          device=dev),
        lambda s: [s.submit(p) for p in prompts], build, obs)
    tag = "slab self-spec, greedy"
    check_spec_outputs(np, tag, arch, results, rids, steps)
    n_steps, prefills = len(steps), len(sched.admit_order)
    got = {k: launches.get(k, 0) for k in ("score_tokens", "sample_topk")}
    if got != {"score_tokens": 0, "sample_topk": 2 * n_steps + 2 * prefills}:
        raise AssertionError(f"{tag}: launches {got} over {n_steps} steps "
                             f"and {prefills} prefills")
    topk_launches += got["sample_topk"]
    worst, agree = best_logit_deficit(torch, np, arch6, params, prompts,
                                      [results[r] for r in rids], dev)
    if worst > GREEDY_TOL:
        raise AssertionError(f"{tag}: a served token trails the cache-free "
                             f"forward's best logit by {worst:.3g} > "
                             f"{GREEDY_TOL}")
    print(f"[spec] {tag}: launches {got} (no scoring pass); "
          f"{agree.mean():.3f} of {agree.size} tokens equal the cache-free "
          f"forward's argmax, served logit trails the best by at most "
          f"{max(worst, 0.0):.3g} (limit {GREEDY_TOL})", flush=True)
    spec_summary(np, tag, sched, results, rids, dt, tracer, card)
    return params, score_launches, topk_launches, spec_paged


def phase_eval(torch, np, arch, params, card, dev):
    """Phase 7; returns the score_tokens launches."""
    from repro_torch import obs
    from repro_torch.kernels import build
    from repro_torch.models.registry import forward_hidden
    from repro_torch.serve import ContinuousScheduler, PagedEngine, ServeConfig

    sc = ServeConfig(batch_size=8, max_len=512, paged=True, block_size=16)
    warm = PagedEngine(arch, params, sc, device=dev)
    warm.score_in_slot(0, np.arange(1, 40), np.arange(3, 11))
    torch.cuda.synchronize()
    rng = np.random.default_rng(7)
    vocab = arch.vocab_size
    prompts = [rng.integers(1, vocab, 128).astype(np.int32) for _ in range(8)]
    conts = [[rng.integers(1, vocab, 8).astype(np.int32) for _ in range(4)]
             for _ in prompts]
    reg, tracer = obs.enable(trace=True)
    try:
        eng = PagedEngine(arch, params, sc, device=dev)
        sched = ContinuousScheduler(eng)
        build.reset_counters()
        t0 = time.perf_counter()
        rids = [sched.submit_eval(p, c) for p, c in zip(prompts, conts)]
        results = sched.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: c.count for k, c in build.COUNTERS.items()}
    finally:
        obs.disable()
    n_cont = sum(len(c) for c in conts)
    got = {k: launches.get(k, 0) for k in ("score_tokens", "sample_topk")}
    if got != {"score_tokens": n_cont, "sample_topk": 0}:
        raise AssertionError(f"eval: launches {got}, expected one "
                             f"score_tokens a continuation ({n_cont}) and "
                             "no sample_topk")
    pre = eng.paged_stats()["prefix"]
    if pre["hits"] != 3 * len(prompts):
        raise AssertionError(f"eval: {pre['hits']} prefix hits, expected "
                             f"{3 * len(prompts)}")
    # every logp against log_softmax of a cache-free forward's f32 logits
    # over the valid columns; beside it, the reading of a pad leak (the
    # same softmax over all the padded head's columns)
    head = params["lm_head"].float()
    worst = leak = 0.0
    with torch.no_grad():
        for prompt, cs, rid in zip(prompts, conts, rids):
            for cont, got_lp in zip(cs, results[rid]):
                seq = np.concatenate([prompt, cont]).astype(np.int64)
                h, _, _ = forward_hidden(arch, params, {
                    "tokens": torch.from_numpy(seq[None]).to(dev)})
                hp = h[0, len(prompt) - 1:-1].float()            # (8, d)
                z = hp @ head.T
                cid = torch.from_numpy(cont.astype(np.int64)).to(dev)
                want = torch.log_softmax(z[:, :vocab], -1).gather(
                    1, cid[:, None])[:, 0]
                padded = torch.log_softmax(z, -1).gather(
                    1, cid[:, None])[:, 0]
                if not np.all(np.isfinite(got_lp)):
                    raise AssertionError("eval: a logp is not finite")
                worst = max(worst, float(np.abs(
                    got_lp - want.cpu().numpy()).max()))
                leak = max(leak, float((padded - want).abs().max()))
    if worst > EVAL_ATOL:
        raise AssertionError(f"eval: a logp is {worst:.3g} from the "
                             f"cache-free forward's (limit {EVAL_ATOL})")
    if leak <= EVAL_ATOL:
        raise AssertionError(f"eval: counting the pad columns moves a logp "
                             f"by only {leak:.3g}; the limit {EVAL_ATOL} "
                             "would not catch that fault")
    pf = [x for x in tracer.spans if x.name == "engine.prefill"]
    cold = [x.duration * 1e3 for x in pf if not x.args.get("ext")]
    hit = [x.duration * 1e3 for x in pf if x.args.get("ext")]
    scored = sched.eval_tokens_scored
    print(f"[eval] launches {got} = one score_tokens a continuation; prefix "
          f"hits {pre['hits']} ({pre['hit_tokens']} tokens reused); every "
          f"logp within {worst:.3g} of the cache-free forward's (limit "
          f"{EVAL_ATOL}; the pad columns counted in lse would read "
          f"{leak:.3g})", flush=True)
    print(f"[eval] {len(prompts)} prompts x 4 continuations, {scored} tokens "
          f"scored in {dt:.3f}s: {scored / dt:.1f} tokens scored/s; prefill "
          f"p50 cold {np.median(cold):.2f} ms ({len(cold)}), hit "
          f"{np.median(hit):.2f} ms ({len(hit)}) on {card}", flush=True)
    return got["score_tokens"]


def spy_topk(calls):
    """Record every call of the package's `cuda_topk` (the engines import
    it at call time): (h, w, k, options, outputs).  Returns the undo."""
    import repro_torch.kernels.sample_topk as pkg
    real = pkg.cuda_topk

    def spy(h, w, k, **kw):
        out = real(h, w, k, **kw)
        # a copy: an engine may write into what it got (the self-spec
        # engine's pending drafts are the sampler's output, reset in place)
        calls.append((h, w, k, kw, tuple(t.clone() for t in out)))
        return out

    pkg.cuda_topk = spy
    return lambda: setattr(pkg, "cuda_topk", real)


def check_topk_calls(torch, np, tag, calls, arch, masked, lse):
    """Every recorded call against the plain version on the same inputs
    (values and lse at VAL_RTOL / VAL_ATOL, ids where the values are
    apart, every id allowed), each with its model's vocab and softcap
    and the options its mode asks for; returns the largest error."""
    from repro_torch.kernels.sample_topk import topk_scores_ref
    worst = 0.0
    for h, w, k, kw, out in calls:
        if (kw.get("allowed_mask") is not None) != masked or \
                bool(kw.get("return_lse")) != lse:
            raise AssertionError(f"{tag}: a top-k call with mask "
                                 f"{kw.get('allowed_mask') is not None} and "
                                 f"lse {bool(kw.get('return_lse'))}")
        if (kw.get("valid_vocab"), kw.get("logit_softcap")) != (
                arch.vocab_size, arch.cfg.logit_softcap):
            raise AssertionError(f"{tag}: a top-k call with vocab "
                                 f"{kw.get('valid_vocab')} and softcap "
                                 f"{kw.get('logit_softcap')}")
        ref = topk_scores_ref(h, w, k, **kw)
        err, _ = check_topk(np, out[0], out[1], ref[0], ref[1],
                            exact_ids=False)
        if lse:
            got_l, want_l = out[2].cpu().numpy(), ref[2].cpu().numpy()
            np.testing.assert_allclose(got_l, want_l, rtol=VAL_RTOL,
                                       atol=VAL_ATOL)
            err = max(err, float(np.abs(got_l - want_l).max()))
        if masked:
            m = kw["allowed_mask"].bool()
            fin = torch.isfinite(out[0])
            ok = m.gather(1, out[1].long().clamp(0, m.shape[1] - 1))
            if not bool(ok[fin].all()):
                raise AssertionError(f"{tag}: the kernel returned a "
                                     "disallowed id")
        worst = max(worst, err)
    return worst


def spy_groups(cums):
    """Record, after every group admit and step, each live beam's and
    finished hypothesis's cumulative logp under its token prefix:
    ``cums[rid][tuple(tokens)] = logp``.  Returns the undo."""
    from repro_torch.serve import modes
    undo = []
    for cls in (modes.BeamGroup, modes.BestOfGroup):
        for name in ("admit", "step"):
            real = getattr(cls, name)

            def wrapped(self, *a, _real=real, **kw):
                out = _real(self, *a, **kw)
                rec = cums.setdefault(self.rid, {(): 0.0})
                for toks, cum in zip(self.toks, self.cum):
                    rec[tuple(toks)] = cum
                for hy in self.finished:
                    rec[tuple(hy.tokens)] = hy.logp
                return out

            setattr(cls, name, wrapped)
            undo.append((cls, name, real))
    return lambda: [setattr(c, n, r) for c, n, r in undo]


def spy_paged_writes(engines, bad, seen=None):
    """Read every decode-step write of a live slot back from the paged
    pool right after its scatter (`attention._paged_update`), bit for
    bit: live slots own disjoint blocks, so a write that two slots made
    to one address (a shared block appended to) reads back the other's.
    ``engines[-1]`` is the engine running; ``bad[0]`` counts the
    scatters that did not read back, and `seen` (a dict, if given) the
    scatters checked by pool dtype (an int8 cache's value pools and its
    f32 scale pools).  Returns the undo."""
    import torch
    from repro_torch.models import attention
    real = attention._paged_update

    def spy(pool, table, new_vals, cur_len):
        out = real(pool, table, new_vals, cur_len)
        live = [s for s, c in enumerate(engines[-1]._chains) if c]
        if new_vals.shape[1] == 1 and live:
            rows = torch.tensor(live, dtype=torch.long,
                                device=table.device)
            pos = cur_len.long()[rows]
            bs = out.shape[1]
            blk = table.long()[rows, pos // bs]
            got = out[blk, pos % bs]
            if not bool((got == new_vals[rows, 0].to(out.dtype)).all()):
                bad[0] += 1
            if seen is not None:
                key = str(out.dtype).replace("torch.", "")
                seen[key] = seen.get(key, 0) + 1
        return out

    attention._paged_update = spy
    return lambda: setattr(attention, "_paged_update", real)


def hyp_logp_err(torch, np, arch, params, prompt, hyps, cums, first, dev):
    """A group's hypotheses against cache-free forwards, each token's
    served logp (the step of its cumulative logp, `cums` from
    `spy_groups`) against the forward's f32 logits' log_softmax over the
    valid columns.  Returns (the largest such error, the largest error
    of a first token's logp as the prefill's scan `first` = (vals, ids,
    lse) of its one row gives it against a forward over the prompt alone
    (the prefill's own shapes, whose GEMMs round as its do), the rounding
    floor: the largest difference of a token's logp between the forward
    and one over 64 more rows (causal, so the same positions, only the
    GEMMs' rounding differs))."""
    from repro_torch.models.registry import forward_hidden
    head = params["lm_head"].float()
    vals, ids, lse = (t[0].cpu().numpy() for t in first)

    def logps(seq, lo, toks):
        h, _, _ = forward_hidden(arch, params, {"tokens": torch.from_numpy(
            seq[None].astype(np.int64)).to(dev)})
        z = h[0, lo:lo + len(toks)].float() @ head.T
        return torch.log_softmax(z[:, :arch.vocab_size], -1).gather(
            1, torch.from_numpy(toks[:, None]).to(dev))[:, 0].cpu().numpy()

    worst = worst_first = floor = 0.0
    n0 = len(prompt) - 1
    with torch.no_grad():
        h, _, _ = forward_hidden(arch, params, {"tokens": torch.from_numpy(
            prompt[None].astype(np.int64)).to(dev)})
        lp0 = torch.log_softmax((h[0, -1].float() @ head.T)[
            :arch.vocab_size], -1).cpu().numpy()
        for hy in hyps:
            toks = np.asarray(hy.tokens, np.int64)
            seq = np.concatenate([prompt, toks[:-1]]).astype(np.int64)
            lp = logps(seq, n0, toks)
            more = logps(np.concatenate([seq, prompt]), n0, toks)
            if not np.isfinite(hy.logp):
                raise AssertionError("a hypothesis logp is not finite")
            cum = [cums[tuple(toks[:t].tolist())]
                   for t in range(len(toks) + 1)]
            served = np.diff(np.asarray(cum, np.float64))
            worst = max(worst, float(np.abs(served - lp).max()))
            floor = max(floor, float(np.abs(more - lp).max()))
            j = np.flatnonzero(ids == toks[0])
            if j.size != 1:
                raise AssertionError(f"first token {toks[0]} is not one of "
                                     "its prefill's candidates")
            worst_first = max(worst_first, abs(
                float(vals[j[0]] - lse) - float(lp0[toks[0]])))
    return worst, worst_first, floor


def allowed_deficit(torch, np, arch, params, prompt, out, allowed, dev):
    """How far each served token's logit trails the best ALLOWED one of a
    cache-free forward over its request; `allowed(t)` is the (V,) bool
    set of position t."""
    from repro_torch.models.registry import forward_hidden
    head = params["lm_head"].float()
    seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
    with torch.no_grad():
        h, _, _ = forward_hidden(arch, params, {
            "tokens": torch.from_numpy(seq[None]).to(dev)})
        z = (h[0, len(prompt) - 1:].float() @ head.T)[:, :arch.vocab_size]
    worst = 0.0
    for t, tok in enumerate(out):
        a = torch.from_numpy(allowed(t)).to(dev)
        if not bool(a[int(tok)]):
            raise AssertionError(f"constrained: token {tok} at {t} is not "
                                 "allowed")
        best = float(z[t].masked_fill(~a, float("-inf")).max())
        worst = max(worst, best - float(z[t, int(tok)]))
    return worst


def mode_prompts(np, vocab, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, 64).astype(np.int32) for _ in range(n)]


def phase_modes(torch, np, arch, params, card, dev):
    """Phase 10; returns the sample_topk and paged_attn launches of its
    three main-path runs (not the planted fault's)."""
    from repro_torch import obs
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attn import LAUNCHES as PAGED_LAUNCHES
    from repro_torch.kernels.sample_topk import LAUNCHES as TOPK_LAUNCHES
    from repro_torch.serve import (ContinuousScheduler, Engine, PagedEngine,
                                   ServeConfig, kvpool, parse_mask_spec)

    n_layers, vocab = arch.cfg.n_layers, arch.vocab_size
    slab_sc = ServeConfig(batch_size=8, max_len=512)
    paged_sc = ServeConfig(batch_size=8, max_len=512, paged=True,
                           block_size=16)
    even = parse_mask_spec("even", vocab).astype(bool)
    odd = ~even
    t0 = time.perf_counter()
    for cls, sc in ((PagedEngine, paged_sc), (Engine, slab_sc)):
        warm = ContinuousScheduler(cls(arch, params, sc, device=dev),
                                   max_new_tokens=3)
        warm.submit_beam(np.arange(1, 40), n_beams=4)
        warm.submit_best_of(np.arange(5, 50), n=4, temperature=0.7)
        warm.run()
        warm = ContinuousScheduler(cls(arch, params, sc, device=dev),
                                   max_new_tokens=3)
        warm.submit(np.arange(1, 40), token_mask=even)
        warm.run()
    torch.cuda.synchronize()
    print(f"[modes] set-up {time.perf_counter() - t0:.1f}s: qwen3-0.6b "
          f"{n_layers} layers bf16, Engine and PagedEngine batch 8, "
          f"max_len 512 (block 16)", flush=True)

    def run(tag, make_engine, submit):
        calls, cums = [], {}
        undo = spy_topk(calls)
        undo_groups = spy_groups(cums)
        reg, tracer = obs.enable(trace=True)
        try:
            eng = make_engine()           # binds the tracer just enabled
            sched = ContinuousScheduler(eng, max_new_tokens=16)
            build.reset_counters()
            t0 = time.perf_counter()
            rids = submit(sched)
            results = sched.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {"sample_topk": TOPK_LAUNCHES.count,
                        "paged_attn": PAGED_LAUNCHES.count}
        finally:
            obs.disable()
            undo()
            undo_groups()
        steps = [x.duration * 1e3 for x in tracer.spans
                 if x.name == "engine.decode_step"]
        prefills = len(sched.admit_order)
        if launches["sample_topk"] != prefills + sched.decode_steps:
            raise AssertionError(
                f"{tag}: sample_topk launched {launches['sample_topk']} "
                f"times, expected {prefills} prefills + "
                f"{sched.decode_steps} steps (one launch a step)")
        want_paged = sched.decode_steps * n_layers if eng.sc.paged else 0
        if launches["paged_attn"] != want_paged:
            raise AssertionError(f"{tag}: paged_attn launched "
                                 f"{launches['paged_attn']} times, expected "
                                 f"{want_paged}")
        if len(calls) != launches["sample_topk"]:
            raise AssertionError(f"{tag}: {len(calls)} top-k calls for "
                                 f"{launches['sample_topk']} launches")
        return sched, rids, results, calls, launches, dt, steps, cums

    def hyp_errs(tag, prompts, rids, sched, calls, cums):
        """(worst token, worst first token, rounding floor) of every
        group's hypotheses (`hyp_logp_err`); the prefill scans are the
        one-row calls, in admission order."""
        firsts = [c[4] for c in calls if c[0].shape[0] == 1]
        if len(firsts) != len(rids):
            raise AssertionError(f"{tag}: {len(firsts)} prefill scans for "
                                 f"{len(rids)} groups")
        errs = [hyp_logp_err(torch, np, arch, params, p, sched.hypotheses[r],
                             cums[r], first, dev)
                for p, r, first in zip(prompts, rids, firsts)]
        return tuple(max(e[i] for e in errs) for i in range(3))

    def check_hyps(tag, prompts, rids, sched, calls, cums):
        """Every token of every hypothesis within MODES_TOKEN_ATOL of the
        cache-free forward's logp, each first token within EVAL_ATOL."""
        tok_err, first_err, floor = hyp_errs(tag, prompts, rids, sched,
                                             calls, cums)
        if tok_err > MODES_TOKEN_ATOL or first_err > EVAL_ATOL:
            raise AssertionError(
                f"{tag}: a token's logp is {tok_err:.3g} from the "
                f"cache-free forward's (limit {MODES_TOKEN_ATOL}), a first "
                f"token's {first_err:.3g} (limit {EVAL_ATOL})")
        return tok_err, first_err, floor

    # (a) two beam-4 groups on the paged engine: every fork a refcount
    # bump that moves no cache bytes
    copies, fork_copies, fork_blocks = [0], [0], [0]
    real_copy = kvpool.copy_block

    def count_copy(tree, dst, src):
        copies[0] += 1
        return real_copy(tree, dst, src)

    engines, unread = [], [0]

    def paged_engine():
        eng = PagedEngine(arch, params, paged_sc, device=dev)
        engines.append(eng)
        real_fork = eng.fork_slot

        def fork(dst, src):
            c, b = copies[0], eng.pool.used_blocks
            real_fork(dst, src)
            fork_copies[0] += copies[0] - c
            fork_blocks[0] += eng.pool.used_blocks - b

        eng.fork_slot = fork
        return eng

    kvpool.copy_block = count_copy
    prompts = mode_prompts(np, vocab, 2, seed=10)
    try:
        sched, rids, res, calls, launches, dt, steps, cums = run(
            "beam", paged_engine, lambda s: [s.submit_beam(p, n_beams=4)
                                             for p in prompts])
    finally:
        kvpool.copy_block = real_copy
    topk_err = check_topk_calls(torch, np, "beam", calls, arch, False, True)
    if sched.group_forks < 1 or fork_copies[0] or fork_blocks[0]:
        raise AssertionError(f"beam: {sched.group_forks} forks moved "
                             f"{fork_copies[0]} blocks and took "
                             f"{fork_blocks[0]} new ones; want forks that "
                             "move and take none")
    for r in rids:
        hyps = sched.hypotheses[r]
        if len(hyps) != 4 or [h.logp for h in hyps] != sorted(
                (h.logp for h in hyps), reverse=True):
            raise AssertionError(f"beam: request {r} has {len(hyps)} "
                                 "hypotheses, or out of order")
    tok_err, first_err, floor = check_hyps("beam", prompts, rids, sched,
                                           calls, cums)
    total = dict(launches)
    print(f"[modes] (a) beam 4 x 2 groups, PagedEngine: launches {launches}"
          f" = one sample_topk (k 8, return_lse) a step + 2 prefills, "
          f"paged_attn {n_layers} a step; {len(calls)} calls within "
          f"{topk_err:.3g} "
          f"of the plain version; every token's logp within {tok_err:.3g} "
          f"of the cache-free forward's (limit {MODES_TOKEN_ATOL}; two "
          f"cache-free forwards differ by up to {floor:.3g}), "
          f"first tokens within {first_err:.3g} (limit {EVAL_ATOL}); forks "
          f"{sched.group_forks} (0 blocks moved, 0 taken), pruned "
          f"{sched.group_pruned}, copy-on-write copies at append "
          f"{copies[0]}; {sched.tokens_emitted} beam tokens in {dt:.3f}s: "
          f"{sched.tokens_emitted / dt:.1f} tok/s, step "
          f"{np.median(steps):.2f} ms p50 ({len(steps)} steps) on {card}",
          flush=True)

    # (a) again, untimed, with every decode write of a live slot read back
    # from the pool (the same hypotheses, bit for bit); then once more with
    # the fault the paged forks could bring planted: copy-on-write off, so
    # siblings forked inside a block append into it together, which the
    # read-back must catch
    def cow_off_engine():
        eng = paged_engine()
        eng._make_writable = lambda slot, n_tokens: None
        return eng

    def read_back(tag, make_engine):
        unread[0] = 0
        undo_writes = spy_paged_writes(engines, unread)
        try:
            out = run(tag, make_engine, lambda s: [
                s.submit_beam(p, n_beams=4) for p in prompts])
        finally:
            undo_writes()
        return unread[0], out

    bad, again = read_back("beam, read back", paged_engine)
    if bad or [again[0].hypotheses[r] for r in again[1]] != [
            sched.hypotheses[r] for r in rids]:
        raise AssertionError(f"beam: {bad} decode scatters of live slots "
                             "did not read back from the pool, or the "
                             "hypotheses changed")
    caught, (fsched, frids, _, fcalls, _, _, _, fcums) = read_back(
        "beam, copy-on-write off", cow_off_engine)
    if not caught:
        raise AssertionError("modes: with copy-on-write off every decode "
                             "write read back; the check would not catch "
                             "that fault")
    fault, _, _ = hyp_errs("beam, copy-on-write off", prompts, frids,
                           fsched, fcalls, fcums)
    print(f"[modes] (a) read back: every decode write of a live slot "
          f"({again[0].decode_steps} steps x {2 * n_layers} scatters), and "
          f"the same hypotheses; with copy-on-write off (a planted fault) "
          f"{caught} scatters did not read back, and the worst token's "
          f"logp read {fault:.3g} from the cache-free forward's "
          f"(MODES_TOKEN_ATOL {MODES_TOKEN_ATOL})", flush=True)

    # (b) two best-of-4 groups at T 0.7 on the slab engine
    def slab_engine():
        return Engine(arch, params, slab_sc, device=dev)

    prompts = mode_prompts(np, vocab, 2, seed=11)
    sched, rids, res, calls, launches, dt, steps, cums = run(
        "best-of", slab_engine, lambda s: [
            s.submit_best_of(p, n=4, temperature=0.7, seed=i)
            for i, p in enumerate(prompts)])
    topk_err = check_topk_calls(torch, np, "best-of", calls, arch, False,
                                True)
    if any(c[2] != 40 for c in calls):
        raise AssertionError("best-of: a step scored other than top_k 40")
    for r in rids:
        hyps = sched.hypotheses[r]
        if len(hyps) != 4 or any(len(h.tokens) != 16 for h in hyps):
            raise AssertionError(f"best-of: request {r}: {len(hyps)} "
                                 "hypotheses, or one cut short")
    tok_err, first_err, floor = check_hyps("best-of", prompts, rids, sched,
                                           calls, cums)
    total["sample_topk"] += launches["sample_topk"]
    print(f"[modes] (b) best-of 4 x 2 groups at T 0.7, top_k 40, Engine: "
          f"launches {launches} = one sample_topk (k 40, return_lse) a step "
          f"+ 2 prefills; {len(calls)} calls within {topk_err:.3g} of the "
          f"plain version; every token's logp within {tok_err:.3g} of the "
          f"cache-free forward's (limit {MODES_TOKEN_ATOL}; two cache-free "
          f"forwards differ by up to {floor:.3g}), first tokens "
          f"within {first_err:.3g} (limit {EVAL_ATOL}); forks "
          f"{sched.group_forks}; {sched.tokens_emitted} tokens in "
          f"{dt:.3f}s: {sched.tokens_emitted / dt:.1f} tok/s, step "
          f"{np.median(steps):.2f} ms p50 ({len(steps)} steps) on {card}",
          flush=True)

    # (c) 8 requests under the even mask and one under a per-step mask_fn
    # (alternating parity) on the slab engine
    prompts = mode_prompts(np, vocab, 9, seed=12)

    def parity(toks):
        return even if len(toks) % 2 == 0 else odd

    sched, rids, res, calls, launches, dt, steps, _ = run(
        "constrained", slab_engine, lambda s: [
            s.submit(p, token_mask=even) for p in prompts[:8]] + [
            s.submit(prompts[8], mask_fn=parity)])
    topk_err = check_topk_calls(torch, np, "constrained", calls, arch, True,
                                False)
    deficit = 0.0
    for i, (p, r) in enumerate(zip(prompts, rids)):
        out = res[r]
        if len(out) != 16:
            raise AssertionError(f"constrained: request {r} got {len(out)} "
                                 "tokens")
        allowed = ((lambda t: even) if i < 8
                   else (lambda t: parity(range(t))))
        deficit = max(deficit, allowed_deficit(torch, np, arch, params, p,
                                               out, allowed, dev))
    if deficit > GREEDY_TOL:
        raise AssertionError(f"constrained: a token trails the best allowed "
                             f"logit by {deficit:.3g} (limit {GREEDY_TOL})")
    total["sample_topk"] += launches["sample_topk"]
    n_tok = sum(len(res[r]) for r in rids)
    print(f"[modes] (c) constrained, Engine: 8 requests under the even "
          f"mask + 1 under a per-step mask_fn: launches {launches} = one "
          f"sample_topk (k 1, allowed_mask) a step + 9 prefills; "
          f"{len(calls)} calls within {topk_err:.3g} of the plain version; "
          f"every token allowed and within {max(deficit, 0.0):.3g} of the "
          f"best allowed logit of a cache-free forward (limit {GREEDY_TOL})"
          f"; {n_tok} tokens in {dt:.3f}s: {n_tok / dt:.1f} tok/s, step "
          f"{np.median(steps):.2f} ms p50 ({len(steps)} steps) on {card}",
          flush=True)
    return total


# ---------------------------------------------------------------------------
# quantized serving (A6): phase 2's quantized cases and phase 11
# ---------------------------------------------------------------------------


def bound_of(nbytes, flops):
    """(ms, 'bytes' | 'operations'): the larger of the bytes over the
    H100's memory rate and the bf16 operations over its peak."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def dequantized(wq, ws):
    """The library's bf16 head from a 1-byte one and its scales."""
    return (wq.float() * ws[:, None]).bfloat16()


def quant_topk_cases(torch, np, heads, valid, gen, dev):
    """The decode top-k on 1-byte heads with `w_scale`: 8 rows of the
    int8 head at k 1 (the greedy step) and at k 40 with the lse (the
    sampler's k), and k 1 under a half-zero mask on the e4m3fn head."""
    from repro_torch.kernels.sample_topk import (LAUNCHES, cuda_topk,
                                                 topk_scores_ref)
    results = {}
    for name, qd, k, masked, lse in (
            ("int8_rows8_k1", "int8", 1, False, False),
            ("int8_rows8_k40_lse", "int8", 40, False, True),
            ("e4m3_rows8_k1_mask", "float8_e4m3fn", 1, True, False)):
        wq, ws = heads[qd]
        v, d = wq.shape
        rows = 8
        h = torch.randn((rows, d), generator=gen, device=dev).bfloat16()
        mask = None
        if masked:
            mask = (torch.rand((rows, v), generator=gen, device=dev)
                    < 0.5).to(torch.int8)
        kw = dict(valid_vocab=valid, w_scale=ws, allowed_mask=mask,
                  return_lse=lse)
        before = LAUNCHES.count
        out = cuda_topk(h, wq, k, **kw)
        torch.cuda.synchronize()
        if LAUNCHES.count != before + 1:
            raise AssertionError(f"{name}: {LAUNCHES.count - before} "
                                 "decode launches, want 1")
        ref = topk_scores_ref(h, wq, k, **kw)
        err, n_ids = check_topk(np, out[0], out[1], ref[0], ref[1],
                                exact_ids=False)
        again = cuda_topk(h, wq, k, **kw)
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f"sample_topk {name}: two calls differ")
        if lse:
            got_l, want_l = out[2].cpu().numpy(), ref[2].cpu().numpy()
            np.testing.assert_allclose(got_l, want_l, rtol=VAL_RTOL,
                                       atol=VAL_ATOL)
            err = max(err, float(np.abs(got_l - want_l).max()))
        if masked and not bool(mask.bool().gather(
                1, out[1].long()).all()):
            raise AssertionError(f"{name}: a disallowed id")
        ms = cuda_ms(torch, lambda: cuda_topk(h, wq, k, **kw))
        plain_ms = cuda_ms(torch, lambda: topk_scores_ref(h, wq, k, **kw),
                           iters=5)
        mv = None if mask is None else mask[:, :valid] == 0

        def library():
            z = h @ dequantized(wq, ws)[:valid].T
            if mv is not None:
                z = z.masked_fill(mv, float("-inf"))
            if lse:
                torch.logsumexp(z.float(), dim=-1)
            return torch.topk(z, k)

        library_ms = cuda_ms(torch, library)
        # h, the 1-byte W and its scales read once, vals and ids (and the
        # mask, the lse) once
        bound_ms, bound_by = bound_of(
            rows * d * 2 + v * d + v * 4 + rows * k * 8
            + (rows * v if masked else 0) + (rows * 4 if lse else 0),
            2 * rows * d * v)
        part_ms, merge_ms = split_ms(torch, lambda: cuda_topk(h, wq, k, **kw))
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms,
                             bound_by=bound_by, partial_ms=part_ms,
                             merge_ms=merge_ms)
        print(f"[quant] sample_topk {name} ({qd} head + w_scale, d {d}, V "
              f"{v}{', half-zero mask' if masked else ''}"
              f"{', return_lse' if lse else ''}): max_abs_err {err:.3g} "
              f"({n_ids} ids checked exactly); device: stream kernel "
              f"{part_ms:.4f} ms + merge {merge_ms:.4f} ms; two calls "
              f"bit-identical; call {ms:.4f} ms vs bound {bound_ms:.4f} ms "
              f"({bound_by}), plain {plain_ms:.4f} ms, library (dequantized "
              f"head, h @ w.T{', masked_fill' if masked else ''}"
              f"{', logsumexp' if lse else ''}, torch.topk) "
              f"{library_ms:.4f} ms", flush=True)
    return results


def phase_quant_kernels(torch, np, arch, dev):
    """Phase 2's quantized cases, each against its plain version on the
    same 1-byte head or int8 pools: the decode top-k (`quant_topk_cases`),
    `score_tokens` at the verifier's 32 rows on the int8 head (T 0.7),
    `paged_attn` on int8 pools at phase 5's decode shape and at Tq 5, and
    the fused-CE forward at 8192 rows on the int8 head."""
    import torch.nn.functional as F
    from repro_torch.core import LossConfig
    from repro_torch.kernels.fused_ce import fwd_stats, ref_stats
    from repro_torch.kernels.paged_attn import (gather_paged_kv,
                                                paged_attention,
                                                paged_attention_ref)
    from repro_torch.kernels.quant import quantize_weight
    from repro_torch.kernels.score_tokens import score_stats, score_stats_ref
    from repro_torch.models.attention import quantize_kv

    gen = torch.Generator(device=dev).manual_seed(2468)
    d, v, valid = arch.cfg.d_model, arch.padded_vocab, arch.vocab_size
    w = torch.randn((v, d), generator=gen, device=dev) / d ** 0.5
    w[valid:] = 0.0                                # the padded head rows
    w = w.bfloat16()
    heads = {q: quantize_weight(w, q) for q in ("int8", "float8_e4m3fn")}
    del w
    results = quant_topk_cases(torch, np, heads, valid, gen, dev)
    wq, ws = heads["int8"]

    # score_tokens: the speculative verifier's rows on the int8 head
    rows, p, temp = 32, 1, 0.7
    h = torch.randn((rows, d), generator=gen, device=dev).bfloat16()
    ids = torch.randint(0, valid, (rows, p), generator=gen, device=dev,
                        dtype=torch.int32)
    kw = dict(valid_vocab=valid, temperature=temp, w_scale=ws)
    lse, zc = score_stats(h, wq, ids, **kw)
    lse2, zc2 = score_stats(h, wq, ids, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(lse, lse2) and torch.equal(zc, zc2)):
        raise AssertionError("score_tokens int8: two calls differ")
    rl, rz = score_stats_ref(h, wq, ids, **kw)
    torch.testing.assert_close(lse, rl, rtol=VAL_RTOL, atol=VAL_ATOL)
    torch.testing.assert_close(zc, rz, rtol=VAL_RTOL, atol=VAL_ATOL)
    err = max(float((lse - rl).abs().max()), float((zc - rz).abs().max()))
    ms = cuda_ms(torch, lambda: score_stats(h, wq, ids, **kw), iters=50)
    part_ms, merge_ms = split_ms(
        torch, lambda: score_stats(h, wq, ids, **kw), iters=50)
    plain_ms = cuda_ms(torch, lambda: score_stats_ref(h, wq, ids, **kw),
                       iters=5)

    def library():
        z = (h @ dequantized(wq, ws)[:valid].T).float() / temp
        return torch.log_softmax(z, -1).gather(1, ids.long())

    library_ms = cuda_ms(torch, library)
    bound_ms, bound_by = bound_of(
        rows * d * 2 + v * d + v * 4 + rows * p * 8 + rows * 4,
        2 * rows * d * v)
    results["score_int8_rows32_t0.7"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_by=bound_by, partial_ms=part_ms,
        merge_ms=merge_ms)
    print(f"[quant] score_tokens int8_rows32_t0.7 (int8 head + w_scale, "
          f"rows {rows}, P {p}, T {temp}): max_abs_err {err:.3g}, two calls "
          f"bit-identical; device: stream kernel {part_ms:.4f} ms + merge "
          f"{merge_ms:.4f} ms; call {ms:.4f} ms vs bound {bound_ms:.4f} ms "
          f"({bound_by}), plain {plain_ms:.4f} ms, library (dequantized "
          f"head, log_softmax(h @ w.T).gather) {library_ms:.4f} ms",
          flush=True)

    # paged_attn on int8 pools: phase 5's decode shape and Tq 5
    b, nq, nkv, hd, bs, nb = 8, 16, 8, 128, 16, 32
    for name, tq in (("int8_decode", 1), ("int8_tq5", 5)):
        n_pool = b * nb + 1
        kq, ks = quantize_kv(torch.randn((n_pool, bs, nkv, hd),
                                         generator=gen, device=dev))
        vq, vs = quantize_kv(torch.randn((n_pool, bs, nkv, hd),
                                         generator=gen, device=dev))
        perm = torch.randperm(n_pool - 1, generator=gen, device=dev) + 1
        table = perm[:b * nb].reshape(b, nb).to(torch.int32).contiguous()
        lens = torch.randint(16, nb * bs + 1, (b,), generator=gen,
                             device=dev, dtype=torch.int32)
        q = torch.randn((b, tq, nq, hd), generator=gen,
                        device=dev).bfloat16()
        pk = dict(kp_scale=ks, vp_scale=vs)

        def call():
            return paged_attention(q, kq, vq, table, lens, **pk)

        out = call()
        torch.cuda.synchronize()
        ref = paged_attention_ref(q, kq, vq, table, lens, **pk)
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=PAGED_ATOL, rtol=PAGED_RTOL)
        if not torch.equal(out, call()):
            raise AssertionError(f"paged_attn {name}: two calls differ")
        err = float((out.float() - ref.float()).abs().max())
        ms = device_ms(torch, call, (("kernel", "paged_attn"),))["kernel"]
        event_ms = cuda_ms(torch, call, iters=50)
        plain_ms = cuda_ms(torch, lambda: paged_attention_ref(
            q, kq, vq, table, lens, **pk))
        qpos = lens.long()[:, None] - tq + torch.arange(tq, device=dev)
        mask = (torch.arange(nb * bs, device=dev)[None, None, :]
                <= qpos[:, :, None])[:, None]
        qt = q.transpose(1, 2)

        def library():
            kg = (gather_paged_kv(kq, table).float()
                  * gather_paged_kv(ks, table)).bfloat16().transpose(1, 2)
            vg = (gather_paged_kv(vq, table).float()
                  * gather_paged_kv(vs, table)).bfloat16().transpose(1, 2)
            return F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask,
                                                  enable_gqa=True)

        library_ms = cuda_ms(torch, library, iters=50)
        tokens = int(lens.clamp(max=nb * bs).sum())
        bound_ms, bound_by = bound_of(
            tokens * nkv * (hd + 4) * 2 + 2 * q.numel() * 2,
            4 * tokens * nq * tq * hd)
        results[f"paged_{name}"] = dict(
            max_abs_err=err, ms=ms, event_ms=event_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        print(f"[quant] paged_attn {name} (int8 pools + f32 scale pools, B "
              f"{b}, Tq {tq}, nq {nq}, nkv {nkv}, hd {hd}, bs {bs}, nb {nb}, "
              f"lens {lens.min().item()}..{lens.max().item()}): max_abs_err "
              f"{err:.3g} (atol {PAGED_ATOL}), two calls bit-identical; "
              f"device {ms:.4f} ms vs bound {bound_ms:.4f} ms ({bound_by}), "
              f"events over back-to-back calls {event_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library (dequantized gather, sdpa) "
              f"{library_ms:.4f} ms", flush=True)

    # the fused-CE forward (the quantized eval loss) at 8192 rows
    n = 8192
    h = torch.randn((n, d), generator=gen, device=dev).bfloat16()
    y = torch.randint(0, valid, (n,), generator=gen, device=dev)
    y[::10] = -100
    cfg = LossConfig()

    def call():
        return fwd_stats(h, wq, y, cfg, w_scale=ws)

    got = call()
    again = call()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
        raise AssertionError("fused_ce forward int8: two calls differ")
    want = ref_stats(h, wq, y, cfg, w_scale=ws)
    torch.testing.assert_close(got[0], want[0], rtol=VAL_RTOL, atol=VAL_ATOL)
    torch.testing.assert_close(got[1], want[1], rtol=VAL_RTOL, atol=VAL_ATOL)
    torch.testing.assert_close(got[2], want[2], rtol=VAL_RTOL,
                               atol=CE_ZSUM_ATOL)
    err = max(float((got[i] - want[i]).abs().max()) for i in range(2))
    del want
    ms = cuda_ms(torch, call, iters=5, warmup=1)
    plain_ms = cuda_ms(torch, lambda: ref_stats(h, wq, y, cfg, w_scale=ws),
                       iters=2, warmup=1)
    library_ms = cuda_ms(torch, lambda: library_loss(
        torch, h, dequantized(wq, ws), y, cfg, valid), iters=5, warmup=1)
    bound_ms, bound_by = bound_of(n * d * 2 + v * d + v * 4 + 4 * n * 4,
                                  2 * n * d * v)
    results["fwd_int8_rows8192"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_by=bound_by)
    print(f"[quant] fused_ce forward int8_rows8192 (int8 head + w_scale, "
          f"V {v}, d {d}): lse / z_target max_abs_err {err:.3g}, two calls "
          f"bit-identical; {ms:.4f} ms vs bound {bound_ms:.4f} ms "
          f"({bound_by}), plain {plain_ms:.3f} ms, library (dequantized "
          f"head, canonical loss) {library_ms:.4f} ms", flush=True)
    return results


def quant_deficit(torch, np, arch, params, head, prompts, outs, dev):
    """`best_logit_deficit` under the served quantized head, dequantized
    (`dequantize_weight`, f32): the cache-free forward's hidden states
    against the head the engine streamed."""
    return best_logit_deficit(torch, np, arch, dict(params, lm_head=head),
                              prompts, outs, dev)


def quant_served(torch, np, make_engine, prompts, build, obs, max_new=32,
                 on_token=None):
    """Drive a scheduler over a fresh engine under live tracing, every
    launch counter zeroed just before and read just after.  Returns
    (engine, sched, outs, seconds, launches, step ms)."""
    from repro_torch.serve import ContinuousScheduler
    reg, tracer = obs.enable(trace=True)
    try:
        eng = make_engine()
        sched = ContinuousScheduler(
            eng, max_new_tokens=max_new,
            on_token=None if on_token is None else
            (lambda rid, tok, done: on_token(eng, sched)))
        build.reset_counters()
        t0 = time.perf_counter()
        rids = [sched.submit(p) for p in prompts]
        results = sched.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: c.count for k, c in build.COUNTERS.items() if c.count}
    finally:
        obs.disable()
    step_ms = [x.duration * 1e3 for x in tracer.spans
               if x.name in ("engine.decode_step", "spec.step")]
    outs = [results[r] for r in rids]
    if any(len(o) != max_new for o in outs):
        raise AssertionError(f"a request did not get its {max_new} tokens")
    return eng, sched, outs, dt, launches, step_ms


def phase_quant_serve(torch, np, arch, params, card, dev, bf16_bytes_per_req):
    """Phase 11: quantized serving at full width (int8 KV caches and
    pools, 1-byte heads made at engine init from the seeded bf16 params,
    which carry phase 6's MTP heads).  Returns {kernel: launches} of its
    runs."""
    from repro_torch import obs
    from repro_torch.configs.base import with_mtp
    from repro_torch.core import fused_cross_entropy
    from repro_torch.kernels import build
    from repro_torch.kernels.quant import dequantize_weight
    from repro_torch.models import attention
    from repro_torch.models.registry import forward_hidden
    from repro_torch.serve import (ContinuousScheduler, Engine, PagedEngine,
                                   PagedSelfSpecEngine, ServeConfig,
                                   SpecConfig)
    import repro_torch.kernels.score_tokens as score_pkg

    n_layers, vocab = arch.cfg.n_layers, arch.vocab_size
    qsc = dict(quantize_cache=True, head_dtype="int8")
    total = {}

    def add(launches):
        for k, c in launches.items():
            total[k] = total.get(k, 0) + c

    def deq_of(eng):
        return dequantize_weight(eng.params["lm_head"],
                                 eng.params["lm_head_scale"])

    warm = [np.arange(1, 40), np.arange(1, 43)]
    t0 = time.perf_counter()
    sc_a = ServeConfig(batch_size=8, max_len=512, **qsc)
    Engine(arch, params, sc_a, device=dev).generate(warm, 4)
    torch.cuda.synchronize()
    print(f"[quant] set-up {time.perf_counter() - t0:.1f}s: qwen3-0.6b "
          f"{n_layers} layers, int8 KV cache and int8 lm_head made at "
          "engine init", flush=True)

    # (a) slab Engine, phase 3's traffic
    prompts = serve_prompts(np, vocab)
    eng, sched, outs, dt, launches, step_ms = quant_served(
        torch, np, lambda: Engine(arch, params, sc_a, device=dev), prompts,
        build, obs)
    prefills, steps = len(sched.admit_order), sched.decode_steps
    if launches != {"sample_topk": prefills + steps}:
        raise AssertionError(f"quant (a): launches {launches}, expected "
                             f"sample_topk {prefills} prefills + {steps} "
                             "steps and nothing else")
    add(launches)
    if eng.caches["k"].dtype != torch.int8 or "k_scale" not in eng.caches:
        raise AssertionError("quant (a): the slab cache is not int8")
    head_q, head_bf16 = eng.head_bytes(), params["lm_head"].numel() * 2
    if not 0.49 <= head_q / head_bf16 <= 0.51:
        raise AssertionError(f"quant (a): head bytes {head_q} against the "
                             f"bf16 head's {head_bf16}")
    deq = deq_of(eng)
    worst_a, agree_a = quant_deficit(torch, np, arch, params, deq, prompts,
                                     outs, dev)
    # the engine serving the 1-byte head without w_scale, on greedy
    # tokens (printed; the eval run (e) is where this fault is gated)
    fault = Engine(arch, params, sc_a, device=dev)
    fault.params = {k: t for k, t in fault.params.items()
                    if k != "lm_head_scale"}
    f_outs = fault.generate(prompts[:4], 8)
    fault_ws_tokens, _ = quant_deficit(torch, np, arch, params, deq,
                                       prompts[:4], list(f_outs), dev)
    del fault
    ntok = sum(len(o) for o in outs)
    print(f"[quant] (a) slab Engine, int8 KV + int8 head: launches "
          f"{launches} = {prefills} prefills + {steps} decode steps; head "
          f"{head_q} B streamed a scan against {head_bf16} B bf16 (ratio "
          f"{head_q / head_bf16:.4f}); {len(prompts)} requests, {ntok} "
          f"tokens in {dt:.3f}s: {ntok / dt:.1f} tok/s, decode step "
          f"{np.median(step_ms):.2f} ms p50; served logit trails the "
          f"cache-free forward's best (dequantized head) by at most "
          f"{max(worst_a, 0.0):.3g} ({agree_a.mean():.3f} of tokens equal "
          f"its argmax); w_scale dropped, on greedy tokens: "
          f"{fault_ws_tokens:.3g} (not gated) on {card}", flush=True)

    # (b) PagedEngine, int8 pools, phase 5's shared-prompt traffic, every
    # decode write read back from the value and scale pools
    sc_b = ServeConfig(batch_size=8, max_len=512, paged=True, block_size=16,
                       **qsc)
    PagedEngine(arch, params, sc_b, device=dev).generate(
        [warm[0], np.concatenate([warm[0], [7, 8, 9]])], 4)
    prompts_b = shared_prompts(np, vocab)
    per_req, bad, seen, engines = [], [0], {}, []

    def on_token(e, s):
        per_req.append(e.live_cache_bytes() / max(s.active, 1))

    def make_b():
        engines.append(PagedEngine(arch, params, sc_b, device=dev))
        return engines[-1]

    undo = spy_paged_writes(engines, bad, seen)
    try:
        eng, sched, outs_b, dt, launches, step_ms = quant_served(
            torch, np, make_b, prompts_b, build, obs, on_token=on_token)
    finally:
        undo()
    prefills, steps = len(sched.admit_order), sched.decode_steps
    want = {"sample_topk": prefills + steps, "paged_attn": steps * n_layers}
    if launches != want:
        raise AssertionError(f"quant (b): launches {launches}, expected "
                             f"{want}")
    add(launches)
    ps = eng.paged_stats()
    if ps["prefix"]["hits"] != 15:
        raise AssertionError(f"quant (b): {ps['prefix']['hits']} prefix "
                             "hits, not 15")
    n_scatter = steps * n_layers * 2
    if bad[0] or seen != {"int8": n_scatter, "float32": n_scatter}:
        raise AssertionError(f"quant (b): {bad[0]} decode writes did not "
                             f"read back; scatters checked {seen}, "
                             f"expected {n_scatter} int8 and as many f32")
    ratio = float(np.mean(per_req)) / bf16_bytes_per_req
    if ratio > QUANT_POOL_RATIO:
        raise AssertionError(f"quant (b): live pool bytes a request "
                             f"{np.mean(per_req):.0f} are {ratio:.4f} of the "
                             f"bf16 engine's (limit {QUANT_POOL_RATIO})")
    worst_b, agree_b = quant_deficit(torch, np, arch, params, deq_of(eng),
                                     prompts_b, outs_b, dev)
    # planted fault 2: the paged kernel reads K with unit scales
    real_paged = attention.paged_attention

    def unit_k_scales(q, kp, vp, table, lens, *, kp_scale=None,
                      vp_scale=None, softcap=None):
        return real_paged(q, kp, vp, table, lens,
                          kp_scale=torch.ones_like(kp_scale),
                          vp_scale=vp_scale, softcap=softcap)

    attention.paged_attention = unit_k_scales
    try:
        f_outs = PagedEngine(arch, params, sc_b, device=dev).generate(
            prompts_b[:4], 8)
    finally:
        attention.paged_attention = real_paged
    fault_ks, _ = quant_deficit(torch, np, arch, params, deq_of(eng),
                                prompts_b[:4], list(f_outs), dev)
    ntok = sum(len(o) for o in outs_b)
    print(f"[quant] (b) PagedEngine, int8 pools + int8 head: launches "
          f"{launches} = {n_layers} paged_attn a decode step x {steps}; "
          f"prefix hits {ps['prefix']['hits']}; every decode write of a "
          f"live slot read back bit for bit ({seen['int8']} int8 and "
          f"{seen['float32']} scale-pool scatters); block {ps['block_bytes']}"
          f" B; live pool bytes a request {np.mean(per_req):.0f} against the"
          f" bf16 engine's {bf16_bytes_per_req:.0f} (ratio {ratio:.4f}, "
          f"limit {QUANT_POOL_RATIO}); {ntok} tokens in {dt:.3f}s: "
          f"{ntok / dt:.1f} tok/s, decode step {np.median(step_ms):.2f} ms "
          f"p50; served logit trails the best by at most "
          f"{max(worst_b, 0.0):.3g} ({agree_b.mean():.3f} equal); planted "
          f"fault, kp_scale ignored: {fault_ks:.3g}", flush=True)

    # (c) PagedSelfSpecEngine on (b)'s configuration, greedy, Tq 5
    arch6 = with_mtp(arch, SPEC_K)
    spec = SpecConfig(k=SPEC_K)
    PagedSelfSpecEngine(arch6, params, sc_b, spec, device=dev).generate(
        warm, 8)
    eng, sched, outs_c, dt, launches, step_ms = quant_served(
        torch, np, lambda: PagedSelfSpecEngine(arch6, params, sc_b, spec,
                                               device=dev),
        prompts_b, build, obs)
    prefills, steps = len(sched.admit_order), sched.decode_steps
    want = {"sample_topk": 2 * prefills + 2 * steps,
            "paged_attn": steps * n_layers}
    if launches != want:
        raise AssertionError(f"quant (c): launches {launches}, expected "
                             f"{want}")
    add(launches)
    worst_c, agree_c = quant_deficit(torch, np, arch6, params, deq_of(eng),
                                     prompts_b, outs_c, dev)
    ntok = sum(len(o) for o in outs_c)
    print(f"[quant] (c) PagedSelfSpecEngine, int8 pools + int8 head, k "
          f"{SPEC_K}: launches {launches} (paged_attn at Tq {SPEC_K + 1}); "
          f"{ntok} tokens in {dt:.3f}s: {ntok / dt:.1f} tok/s, spec step "
          f"{np.median(step_ms):.2f} ms p50, {sched.tokens_per_step:.3f} "
          f"tokens a slot-step; served logit trails the best by at most "
          f"{max(worst_c, 0.0):.3g} ({agree_c.mean():.3f} equal)",
          flush=True)

    # (d) the fp8 heads, a short slab run each
    worst_d = {}
    for qd in ("float8_e4m3fn", "float8_e5m2"):
        sc_d = ServeConfig(batch_size=8, max_len=512, head_dtype=qd)
        eng, sched, outs_d, dt, launches, step_ms = quant_served(
            torch, np, lambda: Engine(arch, params, sc_d, device=dev),
            prompts[:8], build, obs, max_new=8)
        if launches != {"sample_topk": len(sched.admit_order)
                        + sched.decode_steps}:
            raise AssertionError(f"quant (d) {qd}: launches {launches}")
        add(launches)
        worst_d[qd], _ = quant_deficit(torch, np, arch, params, deq_of(eng),
                                       prompts[:8], outs_d, dev)
    print(f"[quant] (d) fp8 heads, 8 requests x 8 tokens each: served "
          f"logit trails the best (its dequantized head) by at most "
          + ", ".join(f"{max(x, 0.0):.3g} ({qd})"
                      for qd, x in worst_d.items()), flush=True)

    # (e) loglikelihood eval on (b)'s engine: every score_tokens call held
    # to its plain version, every logp to a cache-free forward's
    from repro_torch.kernels.score_tokens import score_stats_ref
    rng = np.random.default_rng(11)
    e_prompts = [rng.integers(1, vocab, 128).astype(np.int32)
                 for _ in range(4)]
    conts = [[rng.integers(1, vocab, 8).astype(np.int32) for _ in range(2)]
             for _ in e_prompts]
    calls, real_score = [], score_pkg.score_tokens

    def spy(hs, w, ids, **kw):
        out = real_score(hs, w, ids, **kw)
        calls.append((hs, w, ids, kw, out[0]))
        return out

    reg, tracer = obs.enable(trace=True)
    score_pkg.score_tokens = spy
    try:
        eng = PagedEngine(arch, params, sc_b, device=dev)
        sched = ContinuousScheduler(eng)
        build.reset_counters()
        rids = [sched.submit_eval(p, c) for p, c in zip(e_prompts, conts)]
        results = sched.run()
        torch.cuda.synchronize()
        launches = {k: c.count for k, c in build.COUNTERS.items() if c.count}
    finally:
        score_pkg.score_tokens = real_score
        obs.disable()
    n_cont = sum(len(c) for c in conts)
    if launches != {"score_tokens": n_cont} or len(calls) != n_cont:
        raise AssertionError(f"quant (e): launches {launches}, expected "
                             f"one score_tokens a continuation ({n_cont})")
    add(launches)
    err_e = 0.0
    for hs, w, ids, kw, got in calls:
        if kw.get("w_scale") is not eng.params["lm_head_scale"]:
            raise AssertionError("quant (e): a scoring call without the "
                                 "head's w_scale")
        lse, z = score_stats_ref(hs, w, ids, **kw)
        ok = (ids >= 0) & (ids < vocab)
        want_lp = torch.where(ok, z[:, 0] - lse, float("-inf"))
        torch.testing.assert_close(got[ok], want_lp[ok], rtol=VAL_RTOL,
                                   atol=VAL_ATOL)
        err_e = max(err_e, float((got[ok] - want_lp[ok]).abs().max()))
    deq = deq_of(eng)

    def eval_err(results_of):
        worst_lp = 0.0
        with torch.no_grad():
            for prompt, cs, lps in zip(e_prompts, conts, results_of):
                for cont, got_lp in zip(cs, lps):
                    seq = np.concatenate([prompt, cont]).astype(np.int64)
                    h, _, _ = forward_hidden(arch, params, {
                        "tokens": torch.from_numpy(seq[None]).to(dev)})
                    z = h[0, len(prompt) - 1:-1].float() @ deq.T
                    cid = torch.from_numpy(cont.astype(np.int64)).to(dev)
                    want_lp = torch.log_softmax(z[:, :vocab], -1).gather(
                        1, cid[:, None])[:, 0]
                    worst_lp = max(worst_lp, float(np.abs(
                        got_lp - want_lp.cpu().numpy()).max()))
        return worst_lp

    worst_e = eval_err([results[r] for r in rids])
    # planted fault 1: the engine serves the 1-byte head without w_scale
    fault = PagedEngine(arch, params, sc_b, device=dev)
    fault.params = {k: t for k, t in fault.params.items()
                    if k != "lm_head_scale"}
    f_sched = ContinuousScheduler(fault)
    f_rids = [f_sched.submit_eval(p, c) for p, c in zip(e_prompts, conts)]
    f_res = f_sched.run()
    fault_ws = eval_err([f_res[r] for r in f_rids])
    del fault
    print(f"[quant] (e) eval on (b)'s engine: launches {launches}; every "
          f"score_tokens call (w_scale) within {err_e:.3g} of its plain "
          f"version; logps within {worst_e:.3g} of a cache-free forward's "
          f"under the dequantized head; planted fault, w_scale dropped: "
          f"{fault_ws:.3g}", flush=True)

    # (f) the quantized eval loss: fused_cross_entropy(w_scale=) over 4 x
    # 512 teacher-forced tokens, against the loss of the dequantized head
    import torch.nn.functional as F
    from repro_torch.core import LossConfig
    toks = torch.from_numpy(np.stack([rng.integers(1, vocab, 513)
                                      for _ in range(4)])).to(dev)
    with torch.no_grad():
        h, _, _ = forward_hidden(arch, params, {"tokens": toks[:, :-1]})
        h = h.reshape(-1, arch.cfg.d_model)
        y = toks[:, 1:].reshape(-1)
        wq, ws = eng.params["lm_head"], eng.params["lm_head_scale"]
        build.reset_counters()
        loss = fused_cross_entropy(h, wq, y, impl="kernel", w_scale=ws,
                                   cfg=LossConfig(valid_vocab=vocab))
        torch.cuda.synchronize()
        launches = {k: c.count for k, c in build.COUNTERS.items() if c.count}
        want_loss = F.cross_entropy((h.float() @ deq.T)[:, :vocab], y)
    if launches != {"fused_ce_fwd": 1}:
        raise AssertionError(f"quant (f): launches {launches}")
    add(launches)
    torch.testing.assert_close(loss, want_loss, rtol=VAL_RTOL, atol=VAL_ATOL)
    print(f"[quant] (f) eval loss on the int8 head (2048 tokens): "
          f"{float(loss):.6f} against {float(want_loss):.6f} from the "
          f"dequantized head's f32 logits; launches {launches}", flush=True)

    worst = max(worst_a, worst_b, worst_c, *worst_d.values(), worst_e)
    print(f"[quant] served tokens and logps against cache-free forwards of "
          f"the dequantized head: worst {worst:.3g} (limit "
          f"{QUANT_TOKEN_TOL}); planted faults read w_scale dropped "
          f"{fault_ws:.3g}, kp_scale ignored {fault_ks:.3g}", flush=True)
    if worst > QUANT_TOKEN_TOL:
        raise AssertionError(f"quant: a served token or logp is {worst:.3g} "
                             f"from the cache-free forward's (limit "
                             f"{QUANT_TOKEN_TOL})")
    for name, reading in (("w_scale dropped", fault_ws),
                          ("kp_scale ignored", fault_ks)):
        if reading <= QUANT_TOKEN_TOL:
            raise AssertionError(f"quant: the planted fault '{name}' reads "
                                 f"{reading:.3g}; the limit "
                                 f"{QUANT_TOKEN_TOL} would not catch it")
    return total


# ---------------------------------------------------------------------------
# the rest of the transformer family (A8 part 1): phase 12
# ---------------------------------------------------------------------------

MOE_ID = "qwen3-moe-235b-a22b"
MOE_SERVE_LAYERS = 4              # 22.4 GB of bf16 params at full width
FAMILY_NEW = 16                   # new tokens a request
# (a), (c), (e), (f): a served greedy token's logit against the best one
# of a cache-free forward over its request.  The reference's expert init
# (fan-in E: std 1/sqrt(E) = 0.088 against 0.016 for a fan-in of d,
# ROADMAP §C) makes an MoE layer's output dominate the residual it adds
# to, so the trunk follows its router: a near-tie between the k-th and
# the next expert flips under a 2^-8 rounding of the hidden state, and
# the token then reads as if drawn at random.  On the H100 a cache-free forward on its own experts trails
# the served tokens by up to 0.47, and two cache-free forwards 64 rows
# apart disagree by as much (PERF.md).  So the MoE forwards route
# as the served run did (`RoutePin`) and the limit sits above the
# rounding left: two pinned forwards 64 rows apart moved a best or served
# logit by up to 7.5e-3 (qwen3-moe) and 7.2e-3 (arctic) on the H100;
# 2e-2 lies above both and far below a wrong cache or position, which
# serves a random token (~0.4-0.7 below the best under these heads'
# logits, std ~0.16).  internvl2 is dense: phase 3's GREEDY_TOL and its
# reasons (its two forwards moved a logit by 1.3e-4).
FAMILY_TOL = {"moe": 2e-2, "arctic": 2e-2, "vlm": GREEDY_TOL}
# (b): one full-width MoE layer on the card against the CPU on the same
# bf16 input and f32 router logits.  The slot tables are integers from
# the same sort and cumsum, so they must be equal; the gates are a
# softmax whose exp may differ by an ulp between the CPU's and the
# card's libm, then renormalized: within 4 f32 ulps (rtol 5e-7).  The
# output: the expert products round bf16 intermediates (up, gate, act)
# after f32 sums in another order, each 2^-8 relative at worst, so
# within 2^-6 of the output's largest entry (4 bf16 ulps there).
MOE_GATE_RTOL = 5e-7
MOE_LAYER_ATOL = 2.0 ** -6
# `RoutePin`: a cache-free router row and its served twin are one row
# rounded in two places (bf16 hidden states, 2^-8 relative); rows of
# other tokens lie O(1) of the norm apart
PIN_MATCH_RTOL = 5e-2


def with_cfg(arch, **kw):
    """`arch` with its config's fields replaced."""
    import dataclasses
    return dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg, **kw))


def spy_routes(records):
    """Record every `moe.route` call as (router logits, (slot, gate, aux),
    cap, cfg).  Returns the undo."""
    from repro_torch.models import moe
    real = moe.route

    def spy(logits, cfg, cap, mesh=None):
        out = real(logits, cfg, cap, mesh=mesh)
        records.append((logits.detach(), out, cap, cfg))
        return out

    moe.route = spy
    return lambda: setattr(moe, "route", real)


def route_drops(records):
    """(dropped assignments of groups of more than one token, of
    one-token groups) over the recorded routes."""
    many = one = 0
    for logits, (slot, _, _), cap, cfg in records:
        n = int((slot == cfg.num_experts * cap).sum())
        if logits.shape[1] > 1:
            many += n
        else:
            one += n
    return many, one


def spy_paged_calls(errs, keep=None):
    """Hold every `paged_attention` call of the model to its plain version
    on the same inputs, at the call (the pools change after it): appends
    (max |err|, query rows a KV head) to `errs`; `keep` (a dict, if
    given) takes the arguments of the call over the most cached tokens.
    Returns the undo."""
    import torch
    from repro_torch.kernels.paged_attn import paged_attention_ref
    from repro_torch.models import attention
    real = attention.paged_attention

    def spy(q, kp, vp, table, lens, **kw):
        out = real(q, kp, vp, table, lens, **kw)
        ref = paged_attention_ref(q, kp, vp, table, lens, **kw)
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=PAGED_ATOL, rtol=PAGED_RTOL)
        errs.append((float((out.float() - ref.float()).abs().max()),
                     q.shape[1] * q.shape[2] // kp.shape[2]))
        tokens = int(lens.sum())
        if keep is not None and tokens > keep.get("tokens", -1):
            keep.update(tokens=tokens, kw=kw, args=(
                q.clone(), kp, vp, table.clone(), lens.clone()))
        return out

    attention.paged_attention = spy
    return lambda: setattr(attention, "paged_attention", real)


def family_prompts(np, vocab, n, length, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, length).astype(np.int32)
            for _ in range(n)]


class RoutePin:
    """Pins the experts of cache-free forwards to the served run's: each
    `moe.route` call's router-logit rows are replaced by the nearest row
    the served run routed at the same layer (`records` from `spy_routes`:
    the same token in the same context, rounded in other places), so a
    router near-tie cannot pick another expert in the two roundings.
    The first `n` rows of a call are pinned (the floor forward's extra
    rows keep their own logits).  Reads: `worst`, the largest distance of
    a pinned row to its match relative to the row's norm; `flips`, the
    pinned rows whose own top-k set differed from the match's."""

    def __init__(self, torch, records, n_layers):
        self.torch = torch
        self.ref = [torch.cat([r[0].reshape(-1, r[0].shape[-1])
                               for r in records[layer::n_layers]])
                    for layer in range(n_layers)]
        self.n_layers = n_layers
        self.calls = self.flips = self.rows = 0
        self.worst = 0.0
        self.n = None

    def __enter__(self):
        from repro_torch.models import moe
        torch = self.torch
        real = self.real = moe.route

        def route(logits, cfg, cap, mesh=None):
            ref = self.ref[self.calls % self.n_layers]
            self.calls += 1
            flat = logits.reshape(-1, logits.shape[-1]).clone()
            rows = flat[:self.n]
            dist, j = torch.cdist(
                rows, ref,
                compute_mode="donot_use_mm_for_euclid_dist").min(1)
            self.worst = max(self.worst, float(
                (dist / rows.norm(dim=1)).max()))
            own = torch.topk(rows, cfg.top_k).indices.sort(-1).values
            pin = torch.topk(ref[j], cfg.top_k).indices.sort(-1).values
            self.flips += int((own != pin).any(-1).sum())
            self.rows += rows.shape[0]
            flat[:self.n] = ref[j]
            return real(flat.reshape(logits.shape), cfg, cap, mesh=mesh)

        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self.real


def family_deficits(torch, np, arch, params, prompts, outs, dev, fe=None,
                    pin=None):
    """(worst, agree, floor): how far each served token's logit trails the
    best one of a cache-free forward over its request (teacher-forced,
    after the frontend embeddings `fe`; with `pin`, a `RoutePin`, on the
    served run's experts), whether it is that best token, and the
    rounding floor: the largest change of the best or the served token's
    logit when the forward runs over 64 more rows (causal: the same
    positions, only the GEMMs round otherwise)."""
    import contextlib
    from repro_torch.models.registry import forward_hidden
    head = params["lm_head"][:arch.vocab_size].float()
    worst = floor = 0.0
    agree = []
    with torch.no_grad(), pin or contextlib.nullcontext():
        for prompt, out in zip(prompts, outs):
            seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
            served = torch.from_numpy(out.astype(np.int64)).to(dev)
            got = []
            for s in (seq, np.concatenate([seq, prompt[:64]])):
                if pin is not None:
                    pin.n = len(seq)
                batch = {"tokens": torch.from_numpy(s[None]).to(dev)}
                if fe is not None:
                    batch["frontend_embeds"] = fe
                h, _, _ = forward_hidden(arch, params, batch)
                lo = h.shape[1] - len(s) + len(prompt) - 1
                z = h[0, lo:lo + len(out)].float() @ head.T
                best, ids = z.max(-1)
                got.append((best, z.gather(1, served[:, None])[:, 0], ids))
            (best, zs, ids), (best2, zs2, _) = got
            worst = max(worst, float((best - zs).max()))
            floor = max(floor, float((best - best2).abs().max()),
                        float((zs - zs2).abs().max()))
            agree.append(ids.cpu().numpy() == out)
    return worst, np.concatenate(agree), floor


def family_run(torch, np, arch, make_engine, prompts, fe=None,
               engines=None, max_new=FAMILY_NEW):
    """Serve `prompts` (`max_new` tokens each, after the frontend
    embeddings `fe`) through `counted_run` on a `make_engine()`
    (appended to `engines`); returns (outs, sched, launches by kernel,
    seconds, decode step ms, peak GiB).  Every request must get its
    tokens, inside the valid vocab."""
    from repro_torch import obs
    from repro_torch.kernels import build
    engines = [] if engines is None else engines

    def make():
        engines.append(make_engine())
        return engines[-1]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, sched, results, rids, dt, launches, _, tracer = counted_run(
        torch, np, make, lambda sched: [
            sched.submit(p, frontend_embeds=fe) for p in prompts],
        build, obs, max_new=max_new)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    outs = [np.asarray(results[r]) for r in rids]
    if any(len(o) != max_new for o in outs):
        raise AssertionError(f"{arch.arch_id}: a request did not get its "
                             f"{max_new} tokens")
    if not all(((o >= 0) & (o < arch.vocab_size)).all() for o in outs):
        raise AssertionError(f"{arch.arch_id}: a served id lies outside "
                             "the valid vocab")
    steps = [sp.duration * 1e3 for sp in tracer.spans
             if sp.name == "engine.decode_step"]
    counts = {k: c for k, c in launches.items() if c}
    return outs, sched, counts, dt, steps, peak


def check_serve_launches(tag, sched, counts, n_layers=0):
    """One `sample_topk` launch a prefill and a decode step, and nothing
    else but `n_layers` `paged_attn` launches a step on a paged engine."""
    prefills, steps = len(sched.admit_order), sched.decode_steps
    want = {"sample_topk": prefills + steps}
    if n_layers:
        want["paged_attn"] = steps * n_layers
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts}, expected {want} "
                             f"({prefills} prefills, {steps} steps)")
    return prefills, steps


def family_serve_line(np, tag, outs, dt, steps, peak, card):
    total = sum(len(o) for o in outs)
    return (f"[family] {tag}: {len(outs)} requests, {total} tokens in "
            f"{dt:.3f}s: {total / dt:.1f} tok/s, decode step "
            f"{np.median(steps):.2f} ms p50 ({len(steps)} steps), peak "
            f"memory {peak:.2f} GiB on {card}")


def moe_layer_card_vs_cpu(torch, np, arch, moe_params, dev):
    """One full-width MoE layer routed on the card and on the CPU from the
    same bf16 input and f32 router logits (a 64-token group, the
    published capacity factor): the slot tables equal, the gates within
    MOE_GATE_RTOL (bits printed), the outputs within MOE_LAYER_ATOL of
    the CPU's largest entry.  Returns a dict of the readings."""
    from repro_torch.models import moe
    mcfg = arch.cfg.moe_config()
    gen = torch.Generator(device=dev).manual_seed(23)
    x = torch.randn((1, 64, mcfg.d_model), generator=gen,
                    device=dev).to(moe_params["wi"].dtype)
    cap = moe.capacity(mcfg, 64)
    logits = torch.einsum("gsd,de->gse", x.float(), moe_params["router"])
    slot, gate, aux = moe.route(logits, mcfg, cap)
    cslot, cgate, caux = moe.route(logits.cpu(), mcfg, cap)
    if not torch.equal(slot.cpu(), cslot):
        raise AssertionError("MoE layer: the card's slot table differs from "
                             "the CPU's on the same logits")
    gate_same = int((gate.cpu() == cgate).sum())
    torch.testing.assert_close(gate.cpu(), cgate, rtol=MOE_GATE_RTOL,
                               atol=0)
    e = mcfg.num_experts
    out = moe._dispatch_ffn_combine(moe_params, x, slot, gate, mcfg, cap, e,
                                    0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cpu_p = {k: v.cpu() for k, v in moe_params.items()}
    cout = moe._dispatch_ffn_combine(cpu_p, x.cpu(), cslot, cgate, mcfg, cap,
                                     e, 0)
    cpu_s = time.perf_counter() - t0
    err = float((out.cpu().float() - cout.float()).abs().max())
    limit = MOE_LAYER_ATOL * float(cout.float().abs().max())
    fro = float((out.cpu().float() - cout.float()).norm()
                / cout.float().norm())
    if not err <= limit:
        raise AssertionError(f"MoE layer: card vs CPU max |err| {err:.3g} > "
                             f"{limit:.3g}")
    return {"cap": cap, "dropped": int((cslot == e * cap).sum()),
            "gate_bits_equal": gate_same, "gates": gate.numel(),
            "max_err": err, "limit": limit, "rel_fro": fro,
            "aux": float(aux), "cpu_aux": float(caux), "cpu_s": cpu_s}


def pinned_check(torch, np, arch, params, prompts, outs, routes, dev):
    """The served tokens of an MoE run against cache-free forwards pinned
    to the served run's experts (`RoutePin` over `routes`): the gated
    readings."""
    pin = RoutePin(torch, routes, arch.cfg.n_layers)
    worst, agree, floor = family_deficits(torch, np, arch, params, prompts,
                                          outs, dev, pin=pin)
    return dict(worst=worst, agree=float(agree.mean()), n=int(agree.size),
                floor=floor, match=pin.worst, flips=pin.flips,
                rows=pin.rows)


def moe_token_check(torch, np, arch, params, prompts, outs, routes, dev):
    """`pinned_check`, and the same forwards on their own experts
    (readings: near-ties flip experts between the two roundings), which
    must drop no assignment."""
    fwd_routes = []
    undo = spy_routes(fwd_routes)
    try:
        free = family_deficits(torch, np, arch, params, prompts, outs, dev)
    finally:
        undo()
    if route_drops(fwd_routes) != (0, 0):
        raise AssertionError(f"{arch.arch_id}: the cache-free forwards "
                             f"dropped assignments {route_drops(fwd_routes)}")
    return dict(pinned_check(torch, np, arch, params, prompts, outs, routes,
                             dev),
                free_worst=free[0], free_agree=float(free[1].mean()),
                free_floor=free[2])


def planted_len_fault(torch, np, tag, arch, params, make_engine, prompts,
                      limit, dev):
    """Serve `prompts` again, untimed, with every prefill's cache length
    committed one short: each decode step then overwrites the prompt's
    last entry and runs one position early.  The token check (the pinned
    forwards' row match and deficit) must fail; returns its readings,
    with the decode writes that did not read back from a paged pool (the
    write itself is where the table says, so that check cannot see it)."""
    from repro_torch.models.registry import shift_cache_lens
    routes, engines, bad = [], [], [0]

    def make():
        eng = make_engine()
        commit = eng._commit_slot
        eng._commit_slot = lambda slot, caches, ctx: commit(
            slot, shift_cache_lens(caches, 1), ctx)
        return eng

    undo = [spy_routes(routes), spy_paged_writes(engines, bad)]
    try:
        outs = family_run(torch, np, arch, make, prompts,
                          engines=engines)[0]
    finally:
        for u in undo:
            u()
        for eng in engines:
            eng.__dict__.pop("_commit_slot", None)
    r = pinned_check(torch, np, arch, params, prompts, outs, routes, dev)
    if r["match"] <= PIN_MATCH_RTOL and r["worst"] <= limit:
        raise AssertionError(
            f"{tag}: a planted cache fault (lengths one short) passes the "
            f"token check: rows matched within {r['match']:.3g}, tokens "
            f"trail by at most {r['worst']:.3g}")
    print(f"[family] {tag} planted fault, every prefill's cache length "
          f"committed one short (untimed): router rows matched within "
          f"{r['match']:.3g} of their norm (limit {PIN_MATCH_RTOL}), "
          f"served tokens trail by up to {r['worst']:.3g} (limit {limit}), "
          f"{r['agree']:.3f} of {r['n']} equal: caught; {bad[0]} decode "
          f"writes did not read back", flush=True)
    return dict(r, unread=bad[0])


def token_line(r, limit):
    return (f"served tokens vs a cache-free forward on the served run's "
            f"experts: {r['agree']:.3f} of {r['n']} equal, trailing its best "
            f"logit by at most {r['worst']:.3g} (limit {limit}; rounding "
            f"floor, two forwards 64 rows apart: {r['floor']:.3g}); every "
            f"router row matched within {r['match']:.3g} of its norm (limit "
            f"{PIN_MATCH_RTOL}), {r['flips']} of {r['rows']} rows' own top-k "
            f"differed; on its own experts: {r['free_agree']:.3f} equal, "
            f"at most {r['free_worst']:.3g} (floor {r['free_floor']:.3g})")


def check_tokens(tag, r, limit):
    if not r.get("match", 0.0) <= PIN_MATCH_RTOL:
        raise AssertionError(f"{tag}: a cache-free router row lies "
                             f"{r['match']:.3g} of its norm from every "
                             "served one")
    if not r["worst"] <= limit:
        raise AssertionError(f"{tag}: a served token trails the cache-free "
                             f"forward's best logit by {r['worst']:.3g} > "
                             f"{limit}")


def phase_family_moe_serve(torch, np, card, dev):
    """Phase 12 (a)-(c): qwen3-moe-235b-a22b at full width, 4 layers."""
    from repro_torch.kernels.paged_attn import paged_attention
    from repro_torch.models.registry import get_arch, init_params
    from repro_torch.optim.tree import leaves
    from repro_torch.serve import Engine, PagedEngine, ServeConfig
    base = get_arch(MOE_ID)
    cfg = base.cfg
    # (a): capacity factor E / k, so cap >= S in every group: no drops
    arch = with_cfg(base, n_layers=MOE_SERVE_LAYERS,
                    capacity_factor=cfg.num_experts / cfg.top_k)
    t0 = time.perf_counter()
    params = init_params(arch, torch.Generator(device=dev).manual_seed(12),
                         dev)
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for t in leaves(params)) / 1e9
    sc = ServeConfig(batch_size=8, max_len=128)
    prompts = family_prompts(np, arch.vocab_size, 8, 64, seed=12)
    Engine(arch, params, sc, device=dev).generate([prompts[0][:20]], 2)
    print(f"[family] (a) set-up {time.perf_counter() - t0:.1f}s: {MOE_ID} "
          f"{arch.cfg.n_layers} layers d={cfg.d_model} {cfg.num_experts} "
          f"experts top-{cfg.top_k} (d_ff {cfg.d_ff_expert}), vocab "
          f"{arch.vocab_size} (head {arch.padded_vocab}), {gb:.2f} GB of "
          f"bf16 params, capacity factor {arch.cfg.capacity_factor}, "
          f"Engine batch 8, max_len 128", flush=True)
    launches = {"sample_topk": 0, "paged_attn": 0}
    readings = {}

    def served(tag, arch_x, make_engine, traffic, n_layers=0, bad=None):
        routes, calls, paged, engines, keep = [], [], [], [], {}
        undo = [spy_routes(routes), spy_topk(calls)]
        if n_layers:
            undo.append(spy_paged_calls(paged, keep))
            undo.append(spy_paged_writes(engines, bad))
        try:
            outs, sched, counts, dt, steps, peak = family_run(
                torch, np, arch_x, make_engine, traffic, engines=engines)
        finally:
            for u in undo:
                u()
        check_serve_launches(tag, sched, counts, n_layers)
        for key in launches:
            launches[key] += counts.get(key, 0)
        topk_err = check_topk_calls(torch, np, tag, calls, arch_x, False,
                                    False)
        if not all(bool(torch.isfinite(out[0]).all())
                   for *_, out in calls):
            raise AssertionError(f"{tag}: a top-k value is not finite")
        return dict(outs=outs, sched=sched, dt=dt, steps=steps, peak=peak,
                    routes=routes, drops=route_drops(routes),
                    topk_err=topk_err, paged=paged, eng=engines[0],
                    keep=keep)

    # (a) the slab Engine: no drops; tokens against cache-free forwards
    a = served("(a)", arch, lambda: Engine(arch, params, sc, device=dev),
               prompts)
    if a["drops"] != (0, 0):
        raise AssertionError(f"(a): {a['drops']} dropped assignments at "
                             f"capacity factor {arch.cfg.capacity_factor}")
    readings["a"] = moe_token_check(torch, np, arch, params, prompts,
                                    a["outs"], a["routes"], dev)
    print(f"[family] (a) sample_topk launches {len(a['sched'].admit_order)} "
          f"prefills + {a['sched'].decode_steps} steps, each held to the "
          f"plain version (max |err| {a['topk_err']:.3g}); dropped "
          f"assignments 0; " + token_line(readings["a"], FAMILY_TOL["moe"]),
          flush=True)
    print(family_serve_line(np, "(a)", a["outs"], a["dt"], a["steps"],
                            a["peak"], card), flush=True)
    readings["a_fault"] = planted_len_fault(
        torch, np, "(a)", arch, params,
        lambda: Engine(arch, params, sc, device=dev), prompts,
        FAMILY_TOL["moe"], dev)

    # (b) the published capacity factor on the same traffic
    arch_b = with_cfg(arch, capacity_factor=cfg.capacity_factor)
    b = served("(b)", arch_b, lambda: Engine(arch_b, params, sc, device=dev),
               prompts)
    same = np.mean([np.mean(x == y) for x, y in zip(a["outs"], b["outs"])])
    layer = moe_layer_card_vs_cpu(torch, np, arch_b,
                                  params["blocks"][0]["moe"], dev)
    readings["b"] = dict(drops=b["drops"], layer=layer)
    print(f"[family] (b) capacity factor {arch_b.cfg.capacity_factor}: "
          f"launches as (a), every top-k value finite and held to the plain "
          f"version (max |err| {b['topk_err']:.3g}); dropped assignments "
          f"{b['drops'][0]} of {len(b['sched'].admit_order)} prefills x "
          f"{MOE_SERVE_LAYERS} layers x 64 tokens x {cfg.top_k} = "
          f"{len(b['sched'].admit_order) * MOE_SERVE_LAYERS * 64 * cfg.top_k}"
          f", {b['drops'][1]} in decode steps; {same:.3f} of tokens equal "
          f"to (a)'s (not gated)", flush=True)
    print(f"[family] (b) one MoE layer, card vs CPU on the same logits "
          f"(64 tokens, cap {layer['cap']}, {layer['dropped']} dropped): "
          f"slot tables equal, gates {layer['gate_bits_equal']} of "
          f"{layer['gates']} bit for bit, all within rtol {MOE_GATE_RTOL}; "
          f"output max |err| {layer['max_err']:.3g} (limit "
          f"{layer['limit']:.3g}), rel fro {layer['rel_fro']:.3g}, aux "
          f"{layer['aux']:.6g} vs {layer['cpu_aux']:.6g}; CPU layer "
          f"{layer['cpu_s']:.1f}s", flush=True)
    print(family_serve_line(np, "(b)", b["outs"], b["dt"], b["steps"],
                            b["peak"], card), flush=True)

    # (c) the paged engine on phase 5's shared-prompt traffic
    psc = ServeConfig(batch_size=8, max_len=512, paged=True, block_size=16)
    traffic = shared_prompts(np, arch.vocab_size)
    PagedEngine(arch, params, psc, device=dev).generate(
        [traffic[0][:20]], 2)
    bad = [0]
    c = served("(c)", arch, lambda: PagedEngine(arch, params, psc,
                                                device=dev),
               traffic, n_layers=MOE_SERVE_LAYERS, bad=bad)
    if bad[0]:
        raise AssertionError(f"(c): {bad[0]} paged decode writes did not "
                             "read back")
    groups = {g for _, g in c["paged"]}
    if groups != {cfg.num_heads // cfg.num_kv_heads}:
        raise AssertionError(f"(c): paged_attn query rows a KV head "
                             f"{groups}")
    pre = c["eng"].paged_stats()["prefix"]
    if pre["hits"] != len(traffic) - 1:
        raise AssertionError(f"(c): {pre['hits']} prefix hits, expected "
                             f"{len(traffic) - 1}")
    readings["c"] = moe_token_check(torch, np, arch, params, traffic,
                                    c["outs"], c["routes"], dev)
    print(f"[family] (c) PagedEngine block 16: paged_attn launches "
          f"{c['sched'].decode_steps} steps x {MOE_SERVE_LAYERS} layers, "
          f"each at {cfg.num_heads}/{cfg.num_kv_heads} heads (group "
          f"{cfg.num_heads // cfg.num_kv_heads}) held to the plain version "
          f"(max |err| {max(e for e, _ in c['paged']):.3g}); sample_topk "
          f"{len(c['sched'].admit_order)} prefills + "
          f"{c['sched'].decode_steps} steps (max |err| "
          f"{c['topk_err']:.3g}); every decode write read back; prefix hits "
          f"{pre['hits']} ({pre['hit_tokens']} tokens); "
          + token_line(readings["c"], FAMILY_TOL["moe"]), flush=True)
    print(family_serve_line(np, "(c)", c["outs"], c["dt"], c["steps"],
                            c["peak"], card), flush=True)
    # one group-16 call, the one over the most cached tokens, timed alone
    q, kp, vp, table, lens = c["keep"]["args"]
    ms = device_ms(torch, lambda: paged_attention(
        q, kp, vp, table, lens, **c["keep"]["kw"]),
        (("kernel", "paged_attn"),))["kernel"]
    bound, by = paged_bound_ms(q, kp, lens, table.shape[1] * kp.shape[1])
    readings["c_ms"] = dict(ms=ms, bound=bound, by=by)
    print(f"[family] (c) paged_attn at group "
          f"{q.shape[2] // kp.shape[2]} (B {q.shape[0]}, Tq "
          f"{q.shape[1]}, {q.shape[2]}/{kp.shape[2]} heads, hd "
          f"{q.shape[3]}, {int(lens.sum())} cached tokens): device "
          f"{ms:.4f} ms vs bound {bound:.4f} ms ({by}) on {card}",
          flush=True)
    readings["c_fault"] = planted_len_fault(
        torch, np, "(c)", arch, params,
        lambda: PagedEngine(arch, params, psc, device=dev), traffic,
        FAMILY_TOL["moe"], dev)
    for key in ("a", "c"):
        check_tokens(f"({key})", readings[key], FAMILY_TOL["moe"])
    return launches, readings


def spy_ce_grads(records):
    """Record every dH and dW launch of the fused-CE backward as (name,
    args, kwargs, f32 output).  Returns the undo."""
    from repro_torch.kernels.fused_ce import kernel
    real = {"dh": kernel.dh_grads, "dw": kernel.dw_grads}

    def wrap(which):
        def spy(*args, **kw):
            out = real[which](*args, **kw)
            records.append((f"fused_ce_{which}", args, kw, out))
            return out
        return spy

    kernel.dh_grads, kernel.dw_grads = wrap("dh"), wrap("dw")

    def undo():
        kernel.dh_grads, kernel.dw_grads = real["dh"], real["dw"]
    return undo


def check_ce_grads(torch, tag, records):
    """Hold each recorded dH / dW launch to its plain version on its own
    inputs with phase 2's limits; one of each is required.  Returns
    [(name, n, V, d, max |err|, rel fro)]."""
    from repro_torch.kernels.fused_ce import ref_dh, ref_dw
    names = sorted(r[0] for r in records)
    if names != ["fused_ce_dh", "fused_ce_dw"]:
        raise AssertionError(f"{tag}: backward launches {names}, expected "
                             "one dH and one dW")
    out = []
    for name, args, kw, got in records:
        plain = ref_dh if name == "fused_ce_dh" else ref_dw
        with torch.no_grad():
            want = plain(*args, **kw)
        torch.testing.assert_close(got, want, rtol=CE_GRAD_RTOL,
                                   atol=CE_GRAD_ATOL)
        fro = float((got - want).norm() / want.norm())
        if not fro <= CE_GRAD_FRO:
            raise AssertionError(f"{tag} {name}: relative Frobenius error "
                                 f"{fro:.3g} > {CE_GRAD_FRO}")
        h, w = args[0], args[1]
        out.append((name, h.shape[0], w.shape[0], h.shape[1],
                    float((got - want).abs().max()), fro))
        del want
    return out


def phase_family_moe_train(torch, np, card, dev):
    """Phase 12 (d): qwen3-moe-235b-a22b at full width, 1 layer, AdamW,
    the kernel loss, batch 4 x 512, 3 steps, the published capacity
    factor."""
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import build
    from repro_torch.models.registry import get_arch, init_params
    from repro_torch.train import TrainConfig, build_loss_fn
    arch = with_cfg(get_arch(MOE_ID), n_layers=1)
    cfg = arch.cfg
    steps = 3
    tc = TrainConfig(peak_lr=3e-3, warmup_steps=1, total_steps=steps,
                     loss_impl="kernel", loss_block_v=2048)
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size, seq_len=512,
                                  global_batch=4, seed=0))
    # the params `train_run` starts from (the same seed), without the
    # optimizer state: step 0 needs only the lm_head's gradient
    t0 = time.perf_counter()
    params = init_params(arch, torch.Generator(device=dev).manual_seed(0),
                         dev)
    head = params["lm_head"].requires_grad_(True)
    torch.cuda.synchronize()
    print(f"[family] (d) set-up {time.perf_counter() - t0:.1f}s: {MOE_ID} "
          f"1 layer, capacity factor {cfg.capacity_factor}, AdamW, "
          f"loss_impl kernel, batch 4 x 512", flush=True)

    # step 0: kernels against the canonical loss; aux from the router;
    # the step's dH and dW launches against their plain versions
    batch0 = to_device(data.batch(0), dev)
    step0 = {}
    routes, grads = [], []
    undo = [spy_routes(routes), spy_ce_grads(grads)]
    try:
        for impl in ("kernel", "canonical"):
            loss_fn = build_loss_fn(arch, TrainConfig(
                loss_impl=impl, loss_block_v=tc.loss_block_v))
            loss, metrics = loss_fn(params, batch0)
            (g_head,) = torch.autograd.grad(loss, [head])
            step0[impl] = (float(loss.detach()), g_head,
                           float(metrics["aux"]))
    finally:
        for u in undo:
            u()
    grad_errs = check_ce_grads(torch, "(d) step 0", grads)
    del grads
    (lk, gk, aux), (lc, gc, _) = step0["kernel"], step0["canonical"]
    loss_err = abs(lk - lc) / abs(lc)
    head_fro = float((gk.float() - gc.float()).norm() / gc.float().norm())
    del step0, gk, gc, params, head
    torch.cuda.empty_cache()
    # the load-balance loss again, from the first route's router logits
    logits, _, _, mcfg = routes[0]
    probs = torch.softmax(logits.double(), -1)
    e, k = mcfg.num_experts, mcfg.top_k
    picks = torch.topk(probs, k, dim=-1).indices.reshape(-1)
    frac_tokens = torch.bincount(picks, minlength=e).double() / picks.numel()
    frac_probs = probs.reshape(-1, e).mean(0)
    # Switch's f_e * P_e summed, f_e over all k assignments, times E / k
    aux_ref = float(mcfg.aux_weight * e / k
                    * (frac_tokens * frac_probs).sum())
    aux_err = abs(aux - aux_ref) / aux_ref
    drops = route_drops(routes[:1])[0]
    if not (loss_err <= TRAIN_LOSS_RTOL and head_fro <= TRAIN_HEAD_FRO):
        raise AssertionError(f"(d) step 0: kernel loss {lk} vs canonical "
                             f"{lc} (rel {loss_err:.3g}), lm_head grad rel "
                             f"fro {head_fro:.3g}")
    if not (aux > 0 and aux_err <= 1e-5):
        raise AssertionError(f"(d) aux {aux} vs {aux_ref} from the router's "
                             f"probs (rel {aux_err:.3g})")
    print(f"[family] (d) step 0, kernels vs canonical loss: {lk:.6f} vs "
          f"{lc:.6f} (rel {loss_err:.3g}, limit {TRAIN_LOSS_RTOL}), bf16 "
          f"lm_head grad rel fro {head_fro:.3g} (limit {TRAIN_HEAD_FRO}); "
          f"aux {aux:.6g} vs {aux_ref:.6g} recomputed in f64 from the "
          f"router's probs (rel {aux_err:.3g}, limit 1e-5); "
          f"{drops} of {picks.numel()} assignments dropped", flush=True)
    print("[family] (d) step 0's backward at its own shape, each launch "
          "against its plain version on the same inputs: " + "; ".join(
              f"{name} (n {n}, V {v}, d {d}) max |err| {err:.3g} (rtol "
              f"{CE_GRAD_RTOL}, atol {CE_GRAD_ATOL}), rel fro {fro:.3g} "
              f"(limit {CE_GRAD_FRO})"
              for name, n, v, d, err, fro in grad_errs), flush=True)

    state, history, counts, spans, peak = train_run(
        torch, np, build, tc, arch, dev, data, steps)
    want = {"fused_ce_fwd": steps, "fused_ce_dh": steps,
            "fused_ce_dw": steps}
    counts = {k_: c for k_, c in counts.items() if c}
    if counts != want:
        raise AssertionError(f"(d) launches {counts}, expected {want}")
    auxes = [m["aux"] for _, m in history]
    if not all(a > 0 for a in auxes):
        raise AssertionError(f"(d) aux {auxes}")
    opt_gb = state_bytes(opt_tensors(state["opt"])) / 1e9
    p50 = float(np.median(spans))
    print(f"[family] (d) {steps} steps, loss "
          + " ".join(f"{m['loss']:.4f}" for _, m in history)
          + " (aux " + " ".join(f"{a:.5f}" for a in auxes) + "); launches "
          f"{counts} = one of each a step; step {p50:.1f} ms p50 over steps "
          f"1-{steps - 1}, {4 * 512 / (p50 / 1e3):.0f} tokens/s, peak "
          f"memory {peak:.2f} GiB, optimizer state {opt_gb:.2f} GB on "
          f"{card}", flush=True)
    return counts


def phase_family_arctic(torch, np, card, dev):
    """Phase 12 (e): arctic-480b at full width, 1 layer, capacity factor
    E / k: the dense-FFN residual beside the experts."""
    from repro_torch.kernels.sample_topk import cuda_topk
    from repro_torch.models.registry import get_arch, init_params
    from repro_torch.serve import Engine, ServeConfig
    base = get_arch("arctic-480b")
    cfg = base.cfg
    arch = with_cfg(base, n_layers=1,
                    capacity_factor=cfg.num_experts / cfg.top_k)
    t0 = time.perf_counter()
    params = init_params(arch, torch.Generator(device=dev).manual_seed(14),
                         dev)
    sc = ServeConfig(batch_size=8, max_len=128)
    prompts = family_prompts(np, arch.vocab_size, 8, 64, seed=14)
    Engine(arch, params, sc, device=dev).generate([prompts[0][:20]], 2)
    torch.cuda.synchronize()
    print(f"[family] (e) set-up {time.perf_counter() - t0:.1f}s: arctic-480b "
          f"1 layer d={cfg.d_model} dense d_ff {cfg.d_ff} beside "
          f"{cfg.num_experts} experts top-{cfg.top_k}, capacity factor "
          f"{arch.cfg.capacity_factor}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    routes, calls = [], []
    undo = [spy_routes(routes), spy_topk(calls)]
    try:
        outs, sched, counts, dt, steps, peak = family_run(
            torch, np, arch, lambda: Engine(arch, params, sc, device=dev),
            prompts)
    finally:
        for u in undo:
            u()
    check_serve_launches("(e)", sched, counts)
    topk_err = check_topk_calls(torch, np, "(e)", calls, arch, False, False)
    if route_drops(routes) != (0, 0):
        raise AssertionError(f"(e): dropped assignments {route_drops(routes)}")
    r = moe_token_check(torch, np, arch, params, prompts, outs, routes, dev)
    head = params["lm_head"]
    h = torch.randn((8, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(15), device=dev).bfloat16()
    stream, merge = split_ms(torch, lambda: cuda_topk(
        h, head, 1, valid_vocab=arch.vocab_size))
    event = cuda_ms(torch, lambda: cuda_topk(h, head, 1,
                                             valid_vocab=arch.vocab_size))
    bound, by = topk_bound_ms(8, cfg.d_model, head.shape[0], 1)
    print(f"[family] (e) sample_topk launches {len(sched.admit_order)} "
          f"prefills + {sched.decode_steps} steps (max |err| {topk_err:.3g});"
          f" dropped assignments 0; " + token_line(r, FAMILY_TOL["arctic"]),
          flush=True)
    print(f"[family] (e) the head's top-k (8 rows, k 1, {head.shape[0]} x "
          f"{cfg.d_model} bf16): {stream:.4f} ms stream + {merge:.4f} ms "
          f"merge device time ({event:.4f} ms a call by CUDA events), bound "
          f"{bound:.4f} ms ({by})", flush=True)
    print(family_serve_line(np, "(e)", outs, dt, steps, peak, card),
          flush=True)
    check_tokens("(e)", r, FAMILY_TOL["arctic"])
    return counts, dict(r, stream=stream, merge=merge, event=event,
                        bound=bound)


def phase_family_vlm(torch, np, card, dev):
    """Phase 12 (f): internvl2-1b at full width (24 layers) with seeded
    256-position frontend embeddings on the slab Engine."""
    from repro_torch.models.registry import get_arch, init_params
    from repro_torch.serve import Engine, ServeConfig
    arch = get_arch("internvl2-1b")
    cfg = arch.cfg
    f = cfg.frontend_len
    t0 = time.perf_counter()
    params = init_params(arch, torch.Generator(device=dev).manual_seed(16),
                         dev)
    fe = (torch.randn((1, f, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(17), device=dev) * 0.02).bfloat16()
    sc = ServeConfig(batch_size=8, max_len=512)
    prompts = family_prompts(np, arch.vocab_size, 8, 64, seed=16)
    eng = Engine(arch, params, sc, device=dev)
    for slot, p in enumerate(prompts[:3]):     # the frontend span cached
        eng.prefill_into_slot(slot, p, frontend_embeds=fe)
    lens = eng.caches["len"][:, :3].cpu().numpy()
    if not (lens == f + 64).all():
        raise AssertionError(f"(f): cache lengths {lens[0]}, expected "
                             f"{f} + 64")
    torch.cuda.synchronize()
    print(f"[family] (f) set-up {time.perf_counter() - t0:.1f}s: "
          f"internvl2-1b {cfg.n_layers} layers d={cfg.d_model} vocab "
          f"{arch.vocab_size} (head {arch.padded_vocab}), {f} frontend "
          f"positions; cache lengths after three prefills {lens[0].tolist()}"
          f" = {f} + 64 in every layer", flush=True)
    calls = []
    undo = spy_topk(calls)
    try:
        outs, sched, counts, dt, steps, peak = family_run(
            torch, np, arch, lambda: Engine(arch, params, sc, device=dev),
            prompts, fe=fe)
    finally:
        undo()
    check_serve_launches("(f)", sched, counts)
    topk_err = check_topk_calls(torch, np, "(f)", calls, arch, False, False)
    worst, agree, floor = family_deficits(torch, np, arch, params, prompts,
                                          outs, dev, fe=fe)
    r = dict(worst=worst, agree=float(agree.mean()), floor=floor)
    print(f"[family] (f) sample_topk launches {len(sched.admit_order)} "
          f"prefills + {sched.decode_steps} steps (max |err| {topk_err:.3g});"
          f" served tokens {agree.mean():.3f} of {agree.size} equal to a "
          f"cache-free forward's over the same embeddings, trailing its "
          f"best logit by at most {worst:.3g} (limit {FAMILY_TOL['vlm']}; "
          f"rounding floor, two forwards 64 rows apart: {floor:.3g})",
          flush=True)
    print(family_serve_line(np, "(f)", outs, dt, steps, peak, card),
          flush=True)
    check_tokens("(f)", r, FAMILY_TOL["vlm"])
    return counts, r


def phase_family(torch, np, card, dev):
    """Phase 12: each model freed before the next.  Returns the launches
    of the phase by kernel."""
    launches = {}

    def add(counts):
        for key, n in counts.items():
            launches[key] = launches.get(key, 0) + n
        gc.collect()
        torch.cuda.empty_cache()

    counts, _ = phase_family_moe_serve(torch, np, card, dev)
    add(counts)
    add(phase_family_moe_train(torch, np, card, dev))
    add(phase_family_arctic(torch, np, card, dev)[0])
    add(phase_family_vlm(torch, np, card, dev)[0])
    return launches


# ---------------------------------------------------------------------------
# phase 13: griffin (recurrentgemma-9b) at full width
# ---------------------------------------------------------------------------

GRIFFIN_ID = "recurrentgemma-9b"
GRIFFIN_SPEC_LAYERS = 8           # 2 supers + rem0, rem1 at full width
GRIFFIN_TRAIN_LAYERS = 3          # one super: rec, rec, attn
GRIFFIN_SPEC_STEPS = 8            # (b)'s rollback check, rejecting steps
# (a)-(c): a served greedy token's logit against the best one of a
# cache-free forward over its request.  Cached decode steps the RG-LRU
# one combine at a time and reads the ring, where the cache-free forward
# scans the sequence in a tree and attends blockwise: their f32 state
# rounds to bf16 activations in other places through 38 layers.  Two
# cache-free forwards that differ only in their row count give the floor
# of that (printed).  The seeded head's logits have std ~0.13 (fan-in
# V: std 1/sqrt(256000) times sqrt(4096)); a stale ring entry or a wrong
# position gives another context, whose served token trails the best
# one by ~0.3-0.5 (a random token against the best of 256000).
GRIFFIN_TOL = 2e-2
# (a): a bucketed prefill's carried RG-LRU state against an exact-length
# prefill's, the scan alone on the same conv output: the pad steps are
# exact identities, but they change where the last real step sits in the
# scan's combine tree, so the two differ by 1-2 f32 ulps on the CPU
# (finding of the port's CPU tests); 4 ulps of the row's largest |h|
GRIFFIN_H_ULPS = 4
# (f): one full-width block on the card against the CPU from the same
# bf16 input and weights.  The block's GEMMs round bf16 outputs after f32
# sums in another order (2^-8 relative each), so the outputs within 2^-6
# of the CPU's largest entry, as phase 12's MoE layer; the RG-LRU state
# (f32, from bf16 gate inputs) within a relative Frobenius error of
# 1e-2; the ring's positions bit for bit (integers).
GRIFFIN_BLOCK_ATOL = 2.0 ** -6
GRIFFIN_H_FRO = 1e-2


def griffin_prompts(np, vocab):
    """(a)'s traffic: one 37-token prompt and five of 38-64 (bucket 64,
    pads masked), one of 2040 (bucket 2048 = the window: the ring wraps
    during decode) and one of 2100 (past the bucket cap: an exact-length
    prefill that wraps the ring in the prefill itself)."""
    rng = np.random.default_rng(13)
    lens = [37] + list(rng.integers(38, 65, 5)) + [2040, 2100]
    return [rng.integers(1, vocab, int(n)).astype(np.int32) for n in lens]


def griffin_sub_params(params, n_layers):
    """The first `n_layers` temporal blocks of a griffin tree as the tree
    of an `n_layers`-deep config (shared tensors): whole supers of three,
    then the blocks left over as ``rem<i>``."""
    blocks = [sup[f"b{i}"] for sup in params.get("supers", [])
              for i in range(3)]
    blocks += [params[k] for k in sorted(params) if k.startswith("rem")]
    n_super, n_rem = divmod(n_layers, 3)
    out = {k: params[k] for k in ("embed", "ln_f", "lm_head")}
    out["supers"] = [{f"b{i}": blocks[3 * j + i] for i in range(3)}
                     for j in range(n_super)]
    for i in range(n_rem):
        out[f"rem{i}"] = blocks[3 * n_super + i]
    return out


def griffin_scan_ulps(torch, arch, params, prompt, dev):
    """(a): the first recurrent block's scan over a 37-token prompt
    padded to its bucket (pad steps masked) against the same scan over
    the 37 steps alone, on the card: the carried h in ulps of the row's
    largest |h|, and whether the outputs at the real steps are equal."""
    from repro_torch.models import griffin, layers as L
    cfg = arch.cfg
    p = params["supers"][0]["b0"]["temporal"]
    t = len(prompt)
    tb = 64
    tok = torch.zeros((1, tb), dtype=torch.long, device=dev)
    tok[0, :t] = torch.as_tensor(prompt, device=dev).long()
    with torch.no_grad():
        x = L.embed_lookup(params["embed"]["table"], tok).to(
            getattr(torch, cfg.compute_dtype))
        xin = L.rmsnorm(p["ln"], x, cfg.norm_eps)
        uc, _ = L.causal_conv(p["conv"], xin @ p["w_rnn"])
        valid = (torch.arange(tb, device=dev) < t)[None]
        h0 = torch.zeros((1, cfg.resolved_d_rnn), device=dev)
        yp, hp = griffin.rglru(p["rglru"], uc, h0=h0, valid=valid)
        ye, he = griffin.rglru(p["rglru"], uc[:, :t], h0=h0)
    ulp = torch.finfo(torch.float32).eps * he.abs().amax(-1, keepdim=True)
    return (float(((hp - he).abs() / ulp).max()),
            bool(torch.equal(yp[:, :t], ye)))


def phase_griffin_serve(torch, np, card, dev):
    """Phase 13 (a), (c), (d): recurrentgemma-9b at full depth (38
    layers); returns (launches, params) for (b)."""
    from repro_torch.kernels.sample_topk import cuda_topk
    from repro_torch.models.registry import (forward_hidden, get_arch,
                                             init_params, init_serve_caches)
    from repro_torch.models.griffin import _layout as griffin_layout
    from repro_torch.optim.tree import leaves
    from repro_torch.serve import Engine, PagedEngine, ServeConfig
    arch = get_arch(GRIFFIN_ID)
    cfg = arch.cfg
    t0 = time.perf_counter()
    params = init_params(arch, torch.Generator(device=dev).manual_seed(13),
                         dev)
    gb = sum(t.numel() * t.element_size() for t in leaves(params)) / 1e9
    sc = ServeConfig(batch_size=8, max_len=4096)
    prompts = griffin_prompts(np, arch.vocab_size)
    Engine(arch, params, sc, device=dev).generate([prompts[0][:20]], 2)
    torch.cuda.synchronize()
    n_super, rem = griffin_layout(cfg)
    print(f"[griffin] (a) set-up {time.perf_counter() - t0:.1f}s: "
          f"{GRIFFIN_ID} {cfg.n_layers} layers ({n_super} supers of rec, "
          f"rec, attn + {len(rem)} rec) d={cfg.d_model} d_ff {cfg.d_ff}, {cfg.num_heads} heads "
          f"over {cfg.num_kv_heads} KV head (hd {cfg.head_dim}), window "
          f"{cfg.window}, vocab {arch.vocab_size}, {gb:.2f} GB of bf16 "
          f"params; Engine batch 8; prompts of "
          f"{[len(p) for p in prompts]} tokens", flush=True)
    launches = {"sample_topk": 0, "score_tokens": 0, "paged_attn": 0}

    def served(tag, make_engine):
        calls = []
        undo = spy_topk(calls)
        try:
            outs, sched, counts, dt, steps, peak = family_run(
                torch, np, arch, make_engine, prompts)
        finally:
            undo()
        check_serve_launches(tag, sched, counts)
        for key in launches:
            launches[key] += counts.get(key, 0)
        err = check_topk_calls(torch, np, tag, calls, arch, False, False)
        return outs, sched, dt, steps, peak, err

    # (a) the slab Engine
    outs, sched, dt, steps, peak, err = served(
        "(a)", lambda: Engine(arch, params, sc, device=dev))
    worst, agree, floor = family_deficits(torch, np, arch, params, prompts,
                                          outs, dev)
    print(f"[griffin] (a) sample_topk launches {len(sched.admit_order)} "
          f"prefills + {sched.decode_steps} steps = one a prefill and a "
          f"step, each held to the plain version (max |err| {err:.3g}); "
          f"served tokens {agree.mean():.3f} of {agree.size} equal to a "
          f"cache-free forward's (windowed blockwise attention, the scan "
          f"over the whole sequence), trailing its best logit by at most "
          f"{worst:.3g} (limit {GRIFFIN_TOL}; rounding floor, two "
          f"cache-free forwards 64 rows apart: {floor:.3g})", flush=True)
    print(family_serve_line(np, "(a)", outs, dt, steps, peak,
                            card).replace("[family]", "[griffin]"),
          flush=True)
    if not worst <= GRIFFIN_TOL:
        raise AssertionError(f"(a): a served token trails the cache-free "
                             f"forward's best logit by {worst:.3g} > "
                             f"{GRIFFIN_TOL}")
    # the 37-token prompt bucketed (64) and at its exact length
    p37 = prompts[0]
    eng = Engine(arch, params, ServeConfig(batch_size=1, max_len=4096),
                 device=dev)
    tok_b = eng.prefill_into_slot(0, p37)
    with torch.no_grad():
        st = init_serve_caches(arch, 1, 4096, device=dev)
        h, _, st = forward_hidden(
            arch, params, {"tokens": torch.as_tensor(
                p37[None], device=dev).long()}, caches=st, true_len=len(p37))
        _, tok_e = cuda_topk(h[:, -1].contiguous(), params["lm_head"], 1,
                             valid_vocab=arch.vocab_size)
    tok_e = int(tok_e[0, 0])
    h_b = [s["b0"]["h"] for s in eng.caches["supers"]]
    h_e = [s["b0"]["h"] for s in st["supers"]]
    stack_rel = max(float(((a - b).abs().max() / b.abs().max()))
                    for a, b in zip(h_b, h_e))
    ulps, same_y = griffin_scan_ulps(torch, arch, params, p37, dev)
    print(f"[griffin] (a) 37-token prompt, bucketed (64) vs exact-length "
          f"prefill: first token {tok_b} vs {tok_e}; the first block's scan "
          f"on the same conv output: carried h {ulps:.2f} f32 ulps of the "
          f"row's largest apart (limit {GRIFFIN_H_ULPS}), outputs at the 37 "
          f"real steps {'bit for bit equal' if same_y else 'DIFFERENT'}; "
          f"through the whole stack (other GEMM shapes, not gated) the "
          f"supers' first-block h differ by up to {stack_rel:.3g} of their "
          f"largest entry", flush=True)
    if tok_b != tok_e or not same_y or not ulps <= GRIFFIN_H_ULPS:
        raise AssertionError(f"(a): bucketed vs exact prefill: tokens "
                             f"{tok_b} / {tok_e}, scan outputs equal "
                             f"{same_y}, h {ulps:.3g} ulps")
    del eng, st, h

    # (d) PagedEngine: nothing pageable, the slab engine bit for bit
    psc = ServeConfig(batch_size=8, max_len=4096, paged=True, block_size=16)
    peng = []

    def make_paged():
        peng.append(PagedEngine(arch, params, psc, device=dev))
        return peng[-1]

    d_outs, d_sched, d_dt, d_steps, d_peak, d_err = served("(d)",
                                                           make_paged)
    same = all(np.array_equal(x, y) for x, y in zip(outs, d_outs))
    stats = peng[0].paged_stats()
    print(f"[griffin] (d) PagedEngine block 16: paged_stats {stats}; "
          f"launches: sample_topk {len(d_sched.admit_order)} prefills + "
          f"{d_sched.decode_steps} steps (max |err| {d_err:.3g}), paged_attn "
          f"0; tokens {'bit for bit' if same else 'NOT'} equal to (a)'s",
          flush=True)
    if not same or stats != {"enabled": False}:
        raise AssertionError(f"(d): tokens equal {same}, stats {stats}")
    del peng

    # (c) eval: score_tokens at V 256000
    c = recurrent_eval(torch, np, arch, params, card, dev, "(c)")
    launches["score_tokens"] += c
    return launches, arch, params


def recurrent_eval(torch, np, arch, params, card, dev, tag,
                   fresh_state=False):
    """Phase 13 (c) and 14 (d): 4 prompts of 64 tokens x 2 continuations
    of 8 through `submit_eval` on the slab Engine (72 tokens: bucket
    128).  Every logp against log_softmax of the f32 logits of a forward
    over the same bucket-padded tokens (causal: its rows at the real
    positions are the prefill's arithmetic) within EVAL_ATOL: a
    cache-free forward, or with `fresh_state` one from a fresh serve
    state (xlstm: its f32 state makes the served conv sum its taps in
    f32, where the cache-free forward rounds them in bf16, so only a
    forward from that state is the prefill's arithmetic; the cache-free
    reading is printed).  The reading against a cache-free forward over
    the 72 tokens alone, whose GEMMs and softmax reduce over other
    lengths, printed too."""
    from repro_torch import obs
    from repro_torch.kernels import build
    from repro_torch.models.registry import forward_hidden, init_serve_caches
    from repro_torch.serve import ContinuousScheduler, Engine, ServeConfig
    vocab = arch.vocab_size
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, vocab, 64).astype(np.int32) for _ in range(4)]
    conts = [[rng.integers(1, vocab, 8).astype(np.int32) for _ in range(2)]
             for _ in prompts]
    sc = ServeConfig(batch_size=8, max_len=4096)
    Engine(arch, params, sc, device=dev).score_in_slot(
        0, prompts[0][:20], conts[0][0])
    reg, tracer = obs.enable(trace=True)
    try:
        eng = Engine(arch, params, sc, device=dev)
        sched = ContinuousScheduler(eng)
        build.reset_counters()
        t0 = time.perf_counter()
        rids = [sched.submit_eval(p, c) for p, c in zip(prompts, conts)]
        results = sched.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: c.count for k, c in build.COUNTERS.items() if c.count}
    finally:
        obs.disable()
    n_cont = sum(len(c) for c in conts)
    if launches != {"score_tokens": n_cont}:
        raise AssertionError(f"{tag}: launches {launches}, expected one "
                             f"score_tokens a continuation ({n_cont})")
    head = params["lm_head"][:vocab].float()
    worst = 0.0
    other = {"cache-free, padded": 0.0, "the 72 tokens alone": 0.0}
    with torch.no_grad():
        for prompt, cs, rid in zip(prompts, conts, rids):
            for cont, got_lp in zip(cs, results[rid]):
                seq = np.concatenate([prompt, cont]).astype(np.int64)
                padded = np.zeros((128,), np.int64)
                padded[:len(seq)] = seq
                cid = torch.from_numpy(cont.astype(np.int64)).to(dev)
                refs = [(padded, fresh_state), (seq, False)]
                if fresh_state:
                    refs.insert(1, (padded, False))
                reads = []
                for s, fresh in refs:
                    caches = (init_serve_caches(arch, 1, 4096, device=dev)
                              if fresh else None)
                    h, _, _ = forward_hidden(
                        arch, params,
                        {"tokens": torch.from_numpy(s[None]).to(dev)},
                        caches=caches,
                        true_len=len(seq) if fresh else None)
                    z = h[0, len(prompt) - 1:len(seq) - 1].float() @ head.T
                    reads.append(torch.log_softmax(z, -1).gather(
                        1, cid[:, None])[:, 0].cpu().numpy())
                if not np.all(np.isfinite(got_lp)):
                    raise AssertionError(f"{tag}: a logp is not finite")
                worst = max(worst, float(np.abs(got_lp - reads[0]).max()))
                other["the 72 tokens alone"] = max(
                    other["the 72 tokens alone"],
                    float(np.abs(got_lp - reads[-1]).max()))
                if fresh_state:
                    other["cache-free, padded"] = max(
                        other["cache-free, padded"],
                        float(np.abs(got_lp - reads[1]).max()))
    ref = ("a forward from a fresh serve state" if fresh_state
           else "a cache-free forward")
    others = "; ".join(f"{v:.3g} from a cache-free forward over "
                       + ("the same padded tokens (bf16 conv taps)"
                          if k.startswith("cache") else k)
                       for k, v in other.items()
                       if fresh_state or not k.startswith("cache"))
    print(f"[{arch.family}] {tag} eval: launches {launches} = one "
          f"score_tokens a continuation (V {params['lm_head'].shape[0]}, d "
          f"{arch.cfg.d_model}), no sample_topk; every logp within "
          f"{worst:.3g} of log_softmax of {ref} over the same padded tokens "
          f"(limit {EVAL_ATOL}); {others} (not gated); "
          f"{sched.eval_tokens_scored} tokens scored in {dt:.3f}s on {card}",
          flush=True)
    if not worst <= EVAL_ATOL:
        raise AssertionError(f"{tag}: a logp is {worst:.3g} from {ref}'s "
                             f"(limit {EVAL_ATOL})")
    return launches["score_tokens"]


def scan_rollback_check(torch, np, arch, params, prompt, dev,
                        steps=GRIFFIN_SPEC_STEPS):
    """A recurrent family's 'scan' rollback (phase 13 (b), phase 14 (c)):
    one prompt through `SelfSpecEngine` (random MTP heads: rejections
    every step), `steps` steps, against a plain `Engine` decoding the
    same tokens at batch 1: the emitted tokens equal, and the whole state
    (griffin's rings, RG-LRU h, conv tails, lens; xlstm's conv tails and
    cells) bit for bit equal after the same consumed tokens, which an
    aliased snapshot would break.  Returns (emitted, rejected drafts)."""
    from repro_torch.optim.tree import leaves_with_paths
    from repro_torch.serve import Engine, SelfSpecEngine, ServeConfig, \
        SpecConfig
    sc = ServeConfig(batch_size=1, max_len=4096)
    spec = SelfSpecEngine(arch, params, sc, SpecConfig(k=2), device=dev)
    toks = [spec.prefill_into_slot(0, prompt)]
    rejected = 0
    for _ in range(steps):
        out, counts = spec.decode_step_multi()
        toks += out[0, :counts[0]].tolist()
        rejected += 2 - (int(counts[0]) - 1)
    plain = Engine(arch, params, sc, device=dev)
    ref = [plain.prefill_into_slot(0, prompt)]
    for _ in range(len(toks) - 1):
        ref.append(int(plain.decode_step()[0]))
    if toks != ref:
        raise AssertionError(f"rollback: spec tokens {toks} vs plain "
                             f"{ref}")
    # the spec engine consumed prompt + toks[:-1]; so has the plain one
    # after len(toks) - 1 decode steps
    bad = [p for (p, a), (_, b) in zip(leaves_with_paths(spec.caches),
                                       leaves_with_paths(plain.caches))
           if not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"rollback: state differs from the plain "
                             f"engine's at {bad[:4]}")
    return len(toks), rejected


def family_spec_run(torch, np, arch, tag, make, prompts, per_prefill,
                    per_step, max_new=FAMILY_NEW, fes=None):
    """Serve `prompts` (each after its encoder frames `fes[i]`, where
    given) through the speculative engine `make()` under `counted_run`:
    `per_prefill` `sample_topk` launches a prefill and `per_step` a spec
    step and nothing else, every call held to its plain version.
    Returns (outs, sched, sample_topk launches, summary)."""
    from repro_torch import obs
    from repro_torch.kernels import build
    calls = []
    undo = spy_topk(calls)
    fes = fes or [None] * len(prompts)
    try:
        _, sched, results, rids, dt, counts, _, tracer = counted_run(
            torch, np, make, lambda s: [
                s.submit(p, frontend_embeds=f) for p, f in zip(prompts,
                                                                fes)],
            build, obs, max_new=max_new)
    finally:
        undo()
    outs = [np.asarray(results[r]) for r in rids]
    counts = {key: c for key, c in counts.items() if c}
    want = {"sample_topk": per_prefill * len(sched.admit_order)
            + per_step * sched.decode_steps}
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts}, expected {want}")
    err = check_topk_calls(torch, np, tag, calls, arch, False, False)
    step_ms = [x.duration * 1e3 for x in tracer.spans
               if x.name == "spec.step"]
    total = sum(len(o) for o in outs)
    line = (f"{len(prompts)} requests of {[len(p) for p in prompts]} "
            f"tokens, {total} tokens in {dt:.3f}s: {total / dt:.1f} tok/s, "
            f"spec step {np.median(step_ms):.2f} ms p50 ({len(step_ms)} "
            f"steps), acceptance {sched.acceptance_rate:.4f} "
            f"({sched.spec_accepted} of {sched.spec_drafted}), "
            f"{sched.tokens_per_step:.3f} tokens a slot-step; sample_topk "
            f"{counts['sample_topk']} launches = {per_prefill} a prefill + "
            f"{per_step} a step, each held to the plain version (max |err| "
            f"{err:.3g})")
    return outs, sched, counts["sample_topk"], line


def phase_griffin_spec(torch, np, arch_full, params_full, card, dev):
    """Phase 13 (b): 8 layers at full width, the 'scan' rollback."""
    from repro_torch.configs.base import with_mtp
    from repro_torch.models.mtp import init_heads
    from repro_torch.serve import (Engine, SelfSpecEngine, ServeConfig,
                                   SpecConfig, SpecEngine)
    arch = with_cfg(arch_full, n_layers=GRIFFIN_SPEC_LAYERS)
    params = griffin_sub_params(params_full, GRIFFIN_SPEC_LAYERS)
    sc = ServeConfig(batch_size=8, max_len=4096)
    rng = np.random.default_rng(19)
    # four prompts the ring wraps on during the spec steps (2040 + 16 new
    # tokens pass the window of 2048), four short ones
    lens = [2040, 2036, 2044, 2030, 40, 51, 63, 29]
    prompts = [rng.integers(1, arch.vocab_size, n).astype(np.int32)
               for n in lens]
    launches = {"sample_topk": 0}
    # the plain engine's tokens, the reference of the sidecar run
    plain, p_sched, *_ = family_run(torch, np, arch,
                                    lambda: Engine(arch, params, sc,
                                                   device=dev), prompts)
    k = SPEC_K

    def spec_run(tag, make, per_prefill, per_step):
        outs, sched, n, line = family_spec_run(
            torch, np, arch, tag, make, prompts, per_prefill, per_step)
        launches["sample_topk"] += n
        return outs, sched, line

    # the sidecar engine, draft = target
    outs, sched, line = spec_run(
        "(b) SpecEngine", lambda: SpecEngine(arch, params, sc, arch, params,
                                             SpecConfig(k=k), device=dev),
        2, k + 1)
    same = all(np.array_equal(x, y) for x, y in zip(outs, plain))
    print(f"[griffin] (b) SpecEngine k {k}, draft = target ({arch.cfg.n_layers}"
          f" layers): {line}; tokens {'bit for bit' if same else 'NOT'} "
          f"the plain engine's on {card}", flush=True)
    if not same or sched.acceptance_rate < 0.9:
        raise AssertionError(f"(b) SpecEngine: tokens equal {same}, "
                             f"acceptance {sched.acceptance_rate}")
    # self-speculation with 2 random MTP heads: rejections every step
    arch_m = with_mtp(arch, 2)
    params_m = dict(params, mtp=init_heads(
        torch.Generator(device=dev).manual_seed(20), arch.cfg.d_model,
        arch_m.mtp, dtype=getattr(torch, arch.cfg.param_dtype),
        device=dev))
    outs, sched, line = spec_run(
        "(b) SelfSpecEngine", lambda: SelfSpecEngine(
            arch_m, params_m, sc, SpecConfig(k=2), device=dev), 2, 2)
    worst, agree, floor = family_deficits(torch, np, arch, params, prompts,
                                          outs, dev)
    print(f"[griffin] (b) SelfSpecEngine 2 MTP heads, k 2: {line}; served "
          f"tokens {agree.mean():.3f} of {agree.size} equal to a cache-free "
          f"forward's, trailing its best logit by at most {worst:.3g} "
          f"(limit {GRIFFIN_TOL}; floor {floor:.3g}) on {card}", flush=True)
    if not worst <= GRIFFIN_TOL:
        raise AssertionError(f"(b) SelfSpecEngine: a served token trails "
                             f"by {worst:.3g} > {GRIFFIN_TOL}")
    n_tok, rejected = scan_rollback_check(
        torch, np, arch_m, params_m,
        rng.integers(1, arch.vocab_size, 2046).astype(np.int32), dev)
    print(f"[griffin] (b) rollback: one 2046-token prompt, "
          f"{GRIFFIN_SPEC_STEPS} self-spec steps ({rejected} drafts "
          f"rejected, the ring wrapped in the first): {n_tok} tokens equal "
          f"to the plain engine's, and every state leaf (rings, h, conv, "
          f"lens) bit for bit the plain engine's after the same tokens",
          flush=True)
    return launches


def griffin_blocks_card_vs_cpu(torch, np, arch, dev, t=4096, t_ring=2100,
                               steps=4):
    """Phase 13 (f): at full width, from the same seeded bf16 input and
    weights, on the card and on the CPU: one recurrent block over `t`
    tokens (through the scan, its carried state returned), one
    local-attention layer over `t` tokens (windowed blockwise attention),
    and a `t_ring`-token ring prefill followed by `steps` decode steps.
    Returns the readings; raises past the limits."""
    from repro_torch.models import attention as A
    from repro_torch.models import griffin
    cfg = arch.cfg
    acfg = cfg.attn_config()
    gen = torch.Generator(device=dev).manual_seed(21)
    rec = griffin.init_recurrent_block(cfg, gen, torch.bfloat16, dev)
    att = A.init_attention(acfg, gen, torch.bfloat16, dev)
    x = (torch.randn((1, t, cfg.d_model), generator=gen, device=dev)
         ).bfloat16()
    cpu = torch.device("cpu")

    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        return tree.to(d)

    def run(d):
        p_rec, p_att, xd = to(rec, d), to(att, d), x.to(d)
        out = {}
        with torch.no_grad():
            st = griffin.init_states(cfg, 1, torch.bfloat16, d)["supers"][0]
            y, s = griffin.apply_recurrent_block(p_rec, xd, cfg,
                                                 state=st["b0"])
            out["rec"], out["h"] = y, s["h"]
            out["attn"], _ = A.attention_layer(p_att, xd, acfg)
            ring = st["b2"]
            ys = []
            y, ring = A.attention_layer(p_att, xd[:, :t_ring], acfg,
                                        cache=ring)
            ys.append(y)
            for i in range(steps):
                y, ring = A.attention_layer(
                    p_att, xd[:, t_ring + i:t_ring + i + 1], acfg,
                    cache=ring)
                ys.append(y)
            out["ring_out"] = torch.cat(ys, dim=1)
            out["ring_k"], out["ring_pos"] = ring["k"], ring["pos"]
        return {k: v.to(cpu) for k, v in out.items()}

    t0 = time.perf_counter()
    card_out = run(dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu_out = run(cpu)
    t_cpu = time.perf_counter() - t1
    r = {"card_s": t1 - t0, "cpu_s": t_cpu}
    for key in ("rec", "attn", "ring_out", "ring_k"):
        got, want = card_out[key].float(), cpu_out[key].float()
        r[key] = float((got - want).abs().max() / want.abs().max())
        if not r[key] <= GRIFFIN_BLOCK_ATOL:
            raise AssertionError(f"(f) {key}: card vs CPU max |err| "
                                 f"{r[key]:.3g} of the largest entry > "
                                 f"{GRIFFIN_BLOCK_ATOL:.3g}")
    got, want = card_out["h"], cpu_out["h"]
    r["h_fro"] = float((got - want).norm() / want.norm())
    if not r["h_fro"] <= GRIFFIN_H_FRO:
        raise AssertionError(f"(f) h: card vs CPU rel fro {r['h_fro']:.3g}")
    r["pos_equal"] = bool(torch.equal(card_out["ring_pos"],
                                      cpu_out["ring_pos"]))
    want_pos = sorted(range(t_ring + steps - cfg.window, t_ring + steps))
    if not r["pos_equal"] or sorted(
            card_out["ring_pos"][0].tolist()) != want_pos:
        raise AssertionError("(f) the ring's positions differ")
    return r


def phase_griffin_train(torch, np, card, dev):
    """Phase 13 (e): recurrentgemma-9b at full width, one super (rec,
    rec, attn), AdamW, the kernel loss, batch 1 x 4096 (the window of
    2048 bites), 3 steps."""
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import build
    from repro_torch.models.registry import get_arch, init_params
    from repro_torch.train import TrainConfig, build_loss_fn
    arch = with_cfg(get_arch(GRIFFIN_ID), n_layers=GRIFFIN_TRAIN_LAYERS)
    steps = 3
    tc = TrainConfig(peak_lr=3e-3, warmup_steps=1, total_steps=steps,
                     loss_impl="kernel", loss_block_v=2048)
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size, seq_len=4096,
                                  global_batch=1, seed=0))
    t0 = time.perf_counter()
    params = init_params(arch, torch.Generator(device=dev).manual_seed(0),
                         dev)
    head = params["lm_head"].requires_grad_(True)
    torch.cuda.synchronize()
    print(f"[griffin] (e) set-up {time.perf_counter() - t0:.1f}s: "
          f"{GRIFFIN_ID} {GRIFFIN_TRAIN_LAYERS} layers (rec, rec, attn) at "
          f"full width, AdamW, loss_impl kernel, batch 1 x 4096", flush=True)
    batch0 = to_device(data.batch(0), dev)
    step0, grads = {}, []
    undo = spy_ce_grads(grads)
    try:
        for impl in ("kernel", "canonical"):
            loss_fn = build_loss_fn(arch, TrainConfig(
                loss_impl=impl, loss_block_v=tc.loss_block_v))
            loss, _ = loss_fn(params, batch0)
            (g_head,) = torch.autograd.grad(loss, [head])
            step0[impl] = (float(loss.detach()), g_head)
    finally:
        undo()
    grad_errs = check_ce_grads(torch, "(e) step 0", grads)
    del grads
    (lk, gk), (lc, gc) = step0["kernel"], step0["canonical"]
    loss_err = abs(lk - lc) / abs(lc)
    head_fro = float((gk.float() - gc.float()).norm() / gc.float().norm())
    del step0, gk, gc, params, head
    torch.cuda.empty_cache()
    if not (loss_err <= TRAIN_LOSS_RTOL and head_fro <= TRAIN_HEAD_FRO):
        raise AssertionError(f"(e) step 0: kernel loss {lk} vs canonical "
                             f"{lc} (rel {loss_err:.3g}), lm_head grad rel "
                             f"fro {head_fro:.3g}")
    print(f"[griffin] (e) step 0, kernels vs canonical loss: {lk:.6f} vs "
          f"{lc:.6f} (rel {loss_err:.3g}, limit {TRAIN_LOSS_RTOL}), bf16 "
          f"lm_head grad rel fro {head_fro:.3g} (limit {TRAIN_HEAD_FRO}); "
          "the backward at its own shape, each launch against its plain "
          "version on the same inputs: " + "; ".join(
              f"{name} (n {n}, V {v}, d {d}) max |err| {err:.3g}, rel fro "
              f"{fro:.3g} (limit {CE_GRAD_FRO})"
              for name, n, v, d, err, fro in grad_errs), flush=True)
    state, history, counts, spans, peak = train_run(
        torch, np, build, tc, arch, dev, data, steps)
    want = {"fused_ce_fwd": steps, "fused_ce_dh": steps,
            "fused_ce_dw": steps}
    counts = {k_: c for k_, c in counts.items() if c}
    if counts != want:
        raise AssertionError(f"(e) launches {counts}, expected {want}")
    opt_gb = state_bytes(opt_tensors(state["opt"])) / 1e9
    p50 = float(np.median(spans))
    print(f"[griffin] (e) {steps} steps, loss "
          + " ".join(f"{m['loss']:.4f}" for _, m in history)
          + f"; launches {counts} = one of each a step; step {p50:.1f} ms "
          f"p50 over steps 1-{steps - 1}, {4096 / (p50 / 1e3):.0f} tokens/s, "
          f"peak memory {peak:.2f} GiB, optimizer state {opt_gb:.2f} GB on "
          f"{card}", flush=True)
    del state
    return counts


def phase_griffin(torch, np, card, dev):
    """Phase 13, last: (a), (d), (c) on the full-depth model, (b) on its
    first 8 layers, then (f) and (e).  Returns the launches by kernel."""
    launches = {}

    def add(counts):
        for key, n in counts.items():
            launches[key] = launches.get(key, 0) + n

    counts, arch, params = phase_griffin_serve(torch, np, card, dev)
    add(counts)
    add(phase_griffin_spec(torch, np, arch, params, card, dev))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    r = griffin_blocks_card_vs_cpu(torch, np, arch, dev)
    print(f"[griffin] (f) one full-width block, card vs CPU from the same "
          f"bf16 input and weights: recurrent block over 4096 tokens max "
          f"|err| {r['rec']:.3g} of the largest entry, its h rel fro "
          f"{r['h_fro']:.3g} (limit {GRIFFIN_H_FRO}); local attention over "
          f"4096 tokens {r['attn']:.3g}; 2100-token ring prefill + 4 decode "
          f"steps {r['ring_out']:.3g}, ring K {r['ring_k']:.3g} (limit "
          f"{GRIFFIN_BLOCK_ATOL:.3g} each), ring positions bit for bit "
          f"(the last 2048); card {r['card_s']:.1f}s, CPU {r['cpu_s']:.1f}s",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    add(phase_griffin_train(torch, np, card, dev))
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 14: xlstm (xlstm-125m) at full width and full depth
# ---------------------------------------------------------------------------

XLSTM_ID = "xlstm-125m"
XLSTM_NEW = 32                    # (a)'s new tokens a request
XLSTM_SLOT_BYTES = 14432352       # 6 pairs of f32 state, whatever the context
XLSTM_TRAIN_LAYERS = 2            # (f): one pair, as the sLSTM's host loop
                                  # costs each pair ~3 s a training step
# The reference's fan-in quirk (`dense_init` takes shape[0]) draws the
# sLSTM recurrent matrices ri / rf / rz / ro (nh, hd, hd) = (4, 192, 192)
# at std 1/sqrt(nh) = 1/2 where their contraction runs over hd: the
# recurrent gate inputs then reach ~7x |h|, and the cell is chaotic.  Two
# roundings of one sequence part for good over a long one ((g) prints it
# on the card against the CPU at 16 and at 2048 tokens), so no comparison
# of two arithmetic paths over a long sequence means anything at that
# init; and its backward grows without bound: the gradient of a block's
# last output by its first input gains orders of magnitude over 1024
# tokens ((f) prints it), and over 2048 it overflows f32, so every
# gradient before the last sLSTM is inf or NaN.  So (a)-(g) draw those
# four matrices at std 1/sqrt(hd) (the reference's draw rescaled by
# sqrt(nh / hd), `contract_slstm`): the same code on random weights whose
# recurrence forgets a rounding and a gradient.
# (a)-(c): a served greedy token's logit against the best one of a
# cache-free forward over its request.  By design the two round apart:
# the served state is f32 (the reference's), so a served conv sums its
# taps in f32 and rounds once where the cache-free forward rounds tap by
# tap in bf16, decode steps the mLSTM where the cache-free forward runs
# it chunkwise, and both round bf16 activations through 12 blocks; two
# cache-free forwards that differ only in their row count give the floor
# of the GEMMs' share (printed).  The seeded head's logits have std
# ~0.12 (fan-in V: std 1/sqrt(50304) times sqrt(768)); a stale state or
# a wrong slot gives another context, whose served token trails the best
# one by ~0.3-0.5 (a random token against the best of 50304).
XLSTM_TOL = 2e-2
# (b): a 37-token prompt bucketed (64, pads masked) against its exact
# length: the carried states need not be equal (the chunks cut
# elsewhere, and every GEMM of the two prefills runs at another row
# count), but on the H100 they read 6.7e-8 apart (relative Frobenius, a
# leaf), while a pad step let into the state adds a whole token's input
# to C: each leaf within 1e-3.  The card's padded state against the CPU
# port's padded state from the same weights: the same arithmetic, its
# bf16 GEMMs summed in another order through 12 blocks (1.4e-2 read on
# the H100), within 2e-2 a leaf
XLSTM_PAD_FRO = 1e-3
XLSTM_CARD_CPU_FRO = 2e-2
# (g): one full-width block on the card against the CPU from the same
# bf16 input and weights: the outputs within 2^-6 of the CPU's largest
# entry (bf16 GEMM outputs after f32 sums in another order, as phase 13
# (f)); the f32 state within a relative Frobenius error of 2e-2 a leaf
XLSTM_BLOCK_ATOL = 2.0 ** -6
XLSTM_STATE_FRO = 2e-2


def contract_slstm(torch, arch, tree):
    """Rescale the sLSTM recurrent matrices of `tree` (a params tree with
    ``pairs``, or one sLSTM block's params) in place from the reference's
    std 1/sqrt(nh) to 1/sqrt(hd) (the comment above XLSTM_TOL)."""
    import math
    cfg = arch.cfg
    f = math.sqrt(cfg.num_heads / (cfg.d_model // cfg.num_heads))
    blocks = ([pair["slstm"] for pair in tree["pairs"]] if "pairs" in tree
              else [tree])
    with torch.no_grad():
        for blk in blocks:
            for name in ("ri", "rf", "rz", "ro"):
                blk[name].mul_(f)
    return tree


def xlstm_prompts(np, vocab):
    """(a)'s traffic: six prompts of 5-60 tokens (buckets 8-64, pads
    masked), one of 300 (bucket 512: two mLSTM chunks of 256, the second
    partly pads) and one of 3000 (bucket 4096: 16 chunks, four of them
    only pads)."""
    rng = np.random.default_rng(14)
    lens = [5] + list(rng.integers(6, 61, 5)) + [300, 3000]
    return [rng.integers(1, vocab, int(n)).astype(np.int32) for n in lens]


def tree_to(tree, dev):
    """A nested dict / list tree of tensors moved to `dev`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, dev) for v in tree]
    return tree.to(dev)


def state_fro(torch, got, want):
    """Largest relative Frobenius error over the leaves of two state trees,
    their -inf entries required in the same places (and left out)."""
    from repro_torch.optim.tree import leaves_with_paths
    worst = 0.0
    want = dict(leaves_with_paths(want))
    for path, g in leaves_with_paths(got):
        g, w = g.float().cpu(), want[path].float().cpu()
        fin = torch.isfinite(w)
        if not torch.equal(fin, torch.isfinite(g)):
            raise AssertionError(f"state leaf {path}: -inf in other places")
        den = float(w[fin].norm())
        num = float((g[fin] - w[fin]).norm())
        worst = max(worst, num / den if den else num)
    return worst


def slot_bytes(torch, caches, slot):
    from repro_torch.models.registry import take_slot_caches
    from repro_torch.optim.tree import leaves
    st = leaves(take_slot_caches(caches, slot))
    if {t.dtype for t in st} != {torch.float32}:
        raise AssertionError(f"slot {slot}: state dtypes "
                             f"{ {t.dtype for t in st} }, want f32 only")
    return state_bytes(st)


def phase_xlstm_serve(torch, np, card, dev):
    """Phase 14 (a), (b), (e), (d): xlstm-125m at full depth (12 blocks);
    returns (launches, arch, params, prompts) for (c)."""
    from repro_torch.kernels.sample_topk import cuda_topk
    from repro_torch.models.registry import (forward_hidden, get_arch,
                                             init_params, init_serve_caches)
    from repro_torch.optim.tree import leaves
    from repro_torch.serve import Engine, PagedEngine, ServeConfig
    arch = get_arch(XLSTM_ID)
    cfg = arch.cfg
    t0 = time.perf_counter()
    params = contract_slstm(torch, arch, init_params(
        arch, torch.Generator(device=dev).manual_seed(14), dev))
    gb = sum(t.numel() * t.element_size() for t in leaves(params)) / 1e9
    sc = ServeConfig(batch_size=8, max_len=4096)
    prompts = xlstm_prompts(np, arch.vocab_size)
    Engine(arch, params, sc, device=dev).generate([prompts[0]], 2)
    torch.cuda.synchronize()
    print(f"[xlstm] (a) set-up {time.perf_counter() - t0:.1f}s: {XLSTM_ID} "
          f"{cfg.n_layers} blocks ({cfg.n_layers // 2} sLSTM + mLSTM pairs) "
          f"d={cfg.d_model}, {cfg.num_heads} heads (mLSTM head dim "
          f"{cfg.head_dim_m}), chunk {cfg.chunk}, vocab {arch.vocab_size} "
          f"(head {params['lm_head'].shape[0]} rows), {gb:.3f} GB of bf16 "
          f"params, the sLSTM recurrent matrices at std 1/sqrt(hd) "
          f"(contract_slstm); Engine batch 8; prompts of "
          f"{[len(p) for p in prompts]} tokens, {XLSTM_NEW} new", flush=True)
    launches = {"sample_topk": 0, "score_tokens": 0}

    def served(tag, make_engine):
        calls = []
        undo = spy_topk(calls)
        try:
            outs, sched, counts, dt, steps, peak = family_run(
                torch, np, arch, make_engine, prompts, max_new=XLSTM_NEW)
        finally:
            undo()
        check_serve_launches(tag, sched, counts)
        launches["sample_topk"] += counts["sample_topk"]
        err = check_topk_calls(torch, np, tag, calls, arch, False, False)
        del calls
        return outs, sched, dt, steps, peak, err

    # (a) the slab Engine
    outs, sched, dt, steps, peak, err = served(
        "(a)", lambda: Engine(arch, params, sc, device=dev))
    worst, agree, floor = family_deficits(torch, np, arch, params, prompts,
                                          outs, dev)
    print(f"[xlstm] (a) sample_topk launches {len(sched.admit_order)} "
          f"prefills + {sched.decode_steps} steps = one a prefill and a "
          f"step, each held to the plain version (max |err| {err:.3g}); "
          f"served tokens {agree.mean():.3f} of {agree.size} equal to a "
          f"cache-free forward's (chunkwise mLSTM over the whole sequence, "
          f"bf16 conv taps), trailing its best logit by at most "
          f"{worst:.3g} (limit {XLSTM_TOL}; rounding floor, two cache-free "
          f"forwards 64 rows apart: {floor:.3g})", flush=True)
    print(family_serve_line(np, "(a)", outs, dt, steps, peak,
                            card).replace("[family]", "[xlstm]"), flush=True)
    if not worst <= XLSTM_TOL:
        raise AssertionError(f"(a): a served token trails the cache-free "
                             f"forward's best logit by {worst:.3g} > "
                             f"{XLSTM_TOL}")
    # the state's bytes a slot after the 3000-token prompt and the 5-token
    # one, and the 3000-token prefill's time
    eng = Engine(arch, params, ServeConfig(batch_size=2, max_len=4096),
                 device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.prefill_into_slot(0, prompts[-1])
    torch.cuda.synchronize()
    long_ms = (time.perf_counter() - t0) * 1e3
    eng.prefill_into_slot(1, prompts[0])
    sizes = [slot_bytes(torch, eng.caches, s) for s in (0, 1)]
    print(f"[xlstm] (a) {len(prompts[-1])}-token prefill (bucket 4096, 16 "
          f"mLSTM chunks, 3000 sLSTM steps a block) {long_ms:.1f} ms; slot "
          f"state {sizes[0]} B after it and {sizes[1]} B after the "
          f"{len(prompts[0])}-token prompt, f32 (limit {XLSTM_SLOT_BYTES})",
          flush=True)
    if sizes != [XLSTM_SLOT_BYTES] * 2:
        raise AssertionError(f"(a) slot bytes {sizes}")
    del eng

    # (b) the 37-token prompt bucketed (64) and at its exact length, and
    # the padded state on the card against the CPU port's
    p37 = np.random.default_rng(37).integers(
        1, arch.vocab_size, 37).astype(np.int32)
    eng = Engine(arch, params, ServeConfig(batch_size=1, max_len=4096),
                 device=dev)
    tok_b = eng.prefill_into_slot(0, p37)
    with torch.no_grad():
        st = init_serve_caches(arch, 1, 4096, device=dev)
        h, _, st_e = forward_hidden(
            arch, params, {"tokens": torch.as_tensor(
                p37[None], device=dev).long()}, caches=st, true_len=37)
        _, tok_e = cuda_topk(h[:, -1].contiguous(), params["lm_head"], 1,
                             valid_vocab=arch.vocab_size)
        tok_e = int(tok_e[0, 0])
        pad_fro = state_fro(torch, eng.caches, st_e)
        cpu = torch.device("cpu")
        padded = np.zeros((1, 64), np.int64)
        padded[0, :37] = p37
        t1 = time.perf_counter()
        _, _, st_cpu = forward_hidden(
            arch, tree_to(params, cpu), {"tokens": torch.from_numpy(
                padded)}, caches=init_serve_caches(arch, 1, 4096),
            true_len=37)
        t_cpu = time.perf_counter() - t1
        cc_fro = state_fro(torch, eng.caches, st_cpu)
    print(f"[xlstm] (b) 37-token prompt, bucketed (64) vs exact-length "
          f"prefill: first token {tok_b} vs {tok_e}; carried states differ "
          f"by a relative Frobenius error of up to {pad_fro:.3g} a leaf "
          f"(limit {XLSTM_PAD_FRO}; equal arithmetic is not promised: the "
          f"chunks cut elsewhere and the GEMMs run at other row counts); "
          f"the card's "
          f"padded state against the CPU port's padded run ({t_cpu:.1f}s): "
          f"{cc_fro:.3g} (limit {XLSTM_CARD_CPU_FRO})", flush=True)
    if tok_b != tok_e or not pad_fro <= XLSTM_PAD_FRO \
            or not cc_fro <= XLSTM_CARD_CPU_FRO:
        raise AssertionError(f"(b): tokens {tok_b} / {tok_e}, bucketed vs "
                             f"exact {pad_fro:.3g}, card vs CPU "
                             f"{cc_fro:.3g}")
    del eng, st, st_e, st_cpu, h

    # (e) PagedEngine: nothing pageable, the slab engine bit for bit
    from repro_torch.kernels.paged_attn import LAUNCHES as PAGED_LAUNCHES
    psc = ServeConfig(batch_size=8, max_len=4096, paged=True, block_size=16)
    peng = []

    def make_paged():
        peng.append(PagedEngine(arch, params, psc, device=dev))
        return peng[-1]

    paged_before = PAGED_LAUNCHES.count
    e_outs, e_sched, _, _, _, e_err = served("(e)", make_paged)
    paged_n = PAGED_LAUNCHES.count - paged_before
    same = all(np.array_equal(x, y) for x, y in zip(outs, e_outs))
    stats = peng[0].paged_stats()
    print(f"[xlstm] (e) PagedEngine block 16: paged_stats {stats}; "
          f"launches: sample_topk {len(e_sched.admit_order)} prefills + "
          f"{e_sched.decode_steps} steps (max |err| {e_err:.3g}), paged_attn "
          f"{paged_n}; tokens {'bit for bit' if same else 'NOT'} equal to "
          f"(a)'s", flush=True)
    if not same or stats != {"enabled": False} or paged_n:
        raise AssertionError(f"(e): tokens equal {same}, stats {stats}, "
                             f"paged_attn launches {paged_n}")
    del peng

    # (d) eval: score_tokens at V 50432
    launches["score_tokens"] += recurrent_eval(torch, np, arch, params, card,
                                               dev, "(d)", fresh_state=True)
    return launches, arch, params, prompts, outs


def phase_xlstm_spec(torch, np, arch, params, prompts, card, dev):
    """Phase 14 (c): the 'scan' rollback at full depth, on (a)'s prompts
    but its 3000-token one."""
    from repro_torch.configs.base import with_mtp
    from repro_torch.models.mtp import init_heads
    from repro_torch.serve import (Engine, SelfSpecEngine, ServeConfig,
                                   SpecConfig, SpecEngine)
    sc = ServeConfig(batch_size=8, max_len=4096)
    prompts = prompts[:-1]
    plain, *_ = family_run(torch, np, arch,
                           lambda: Engine(arch, params, sc, device=dev),
                           prompts)
    k = SPEC_K
    outs, sched, n_spec, line = family_spec_run(
        torch, np, arch, "(c) SpecEngine",
        lambda: SpecEngine(arch, params, sc, arch, params, SpecConfig(k=k),
                           device=dev), prompts, 2, k + 1)
    same = all(np.array_equal(x, y) for x, y in zip(outs, plain))
    print(f"[xlstm] (c) SpecEngine k {k}, draft = target: {line}; tokens "
          f"{'bit for bit' if same else 'NOT'} the plain engine's on {card}",
          flush=True)
    if not same or sched.acceptance_rate < 0.9:
        raise AssertionError(f"(c) SpecEngine: tokens equal {same}, "
                             f"acceptance {sched.acceptance_rate}")
    arch_m = with_mtp(arch, 2)
    params_m = dict(params, mtp=init_heads(
        torch.Generator(device=dev).manual_seed(20), arch.cfg.d_model,
        arch_m.mtp, dtype=getattr(torch, arch.cfg.param_dtype), device=dev))
    outs, sched, n_self, line = family_spec_run(
        torch, np, arch_m, "(c) SelfSpecEngine",
        lambda: SelfSpecEngine(arch_m, params_m, sc, SpecConfig(k=2),
                               device=dev), prompts, 2, 2)
    worst, agree, floor = family_deficits(torch, np, arch, params, prompts,
                                          outs, dev)
    print(f"[xlstm] (c) SelfSpecEngine 2 MTP heads, k 2: {line}; served "
          f"tokens {agree.mean():.3f} of {agree.size} equal to a cache-free "
          f"forward's, trailing its best logit by at most {worst:.3g} "
          f"(limit {XLSTM_TOL}; floor {floor:.3g}) on {card}", flush=True)
    if not worst <= XLSTM_TOL:
        raise AssertionError(f"(c) SelfSpecEngine: a served token trails "
                             f"by {worst:.3g} > {XLSTM_TOL}")
    n_tok, rejected = scan_rollback_check(torch, np, arch_m, params_m,
                                          prompts[-1], dev, steps=8)
    print(f"[xlstm] (c) rollback: the {len(prompts[-1])}-token prompt, 8 "
          f"self-spec steps ({rejected} drafts rejected): {n_tok} tokens "
          f"equal to the plain engine's, and every state leaf (conv tails, "
          f"sLSTM h / c / n / m, mLSTM C / n / m) bit for bit the plain "
          f"engine's after the same tokens", flush=True)
    if not rejected:
        raise AssertionError("(c) rollback: no draft was rejected")
    return {"sample_topk": n_spec + n_self}


def xlstm_blocks_card_vs_cpu(torch, np, arch, dev, t=2048, t_pre=300,
                             bucket=512, steps=4):
    """Phase 14 (g): at full width, from the same seeded bf16 input and
    weights (the sLSTM's recurrent matrices at std 1/sqrt(hd),
    `contract_slstm`), on the card and on the CPU: one sLSTM block and
    one mLSTM block over `t` tokens, cache-free, and one pair (sLSTM,
    mLSTM) over a bucketed `t_pre`-token prefill (`bucket` steps, the
    pads masked: the mLSTM's second chunk is mostly pads) from the f32
    serve state, followed by `steps` decode steps (the step-by-step
    mLSTM).  Also read, not gated: the sLSTM block at the reference's
    init (std 1/2), card against CPU, at its first 16 tokens and over
    all `t` (the chaos of the comment above XLSTM_TOL).  Returns the
    readings; raises past the limits."""
    from repro_torch.models import xlstm
    cfg = arch.cfg
    gen = torch.Generator(device=dev).manual_seed(22)
    s_ref = xlstm.init_slstm_block(cfg, gen, torch.bfloat16, dev)
    s_p = contract_slstm(torch, arch, dict(s_ref, **{
        n: s_ref[n].clone() for n in ("ri", "rf", "rz", "ro")}))
    m_p = xlstm.init_mlstm_block(cfg, gen, torch.bfloat16, dev)
    x = torch.randn((1, t, cfg.d_model), generator=gen, device=dev
                    ).bfloat16()
    cpu = torch.device("cpu")

    def run(d):
        sp, mp, xd = tree_to(s_p, d), tree_to(m_p, d), x.to(d)
        out = {}
        with torch.no_grad():
            out["slstm_ref_init"], _ = xlstm.apply_slstm_block(
                tree_to(s_ref, d), xd, cfg)
            out["slstm"], _ = xlstm.apply_slstm_block(sp, xd, cfg)
            out["mlstm"], _ = xlstm.apply_mlstm_block(mp, xd, cfg)
            st = xlstm.init_states(cfg, 1, device=d)[0]
            y, s_st = xlstm.apply_slstm_block(sp, xd[:, :bucket], cfg,
                                              st["slstm"], true_len=t_pre)
            y, m_st = xlstm.apply_mlstm_block(mp, y, cfg, st["mlstm"],
                                              true_len=t_pre)
            ys = [y[:, :t_pre]]
            for i in range(steps):
                xi = xd[:, t_pre + i:t_pre + i + 1]
                y, s_st = xlstm.apply_slstm_block(sp, xi, cfg, s_st)
                y, m_st = xlstm.apply_mlstm_block(mp, y, cfg, m_st)
                ys.append(y)
            out["pair_out"] = torch.cat(ys, dim=1)
            out["state"] = {"slstm": s_st, "mlstm": m_st}
        return tree_to(out, cpu)

    t0 = time.perf_counter()
    card_out = run(dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu_out = run(cpu)
    r = {"card_s": t1 - t0, "cpu_s": time.perf_counter() - t1}
    for key in ("slstm", "mlstm", "pair_out"):
        got, want = card_out[key].float(), cpu_out[key].float()
        r[key] = float((got - want).abs().max() / want.abs().max())
        if not r[key] <= XLSTM_BLOCK_ATOL:
            raise AssertionError(f"(g) {key}: card vs CPU max |err| "
                                 f"{r[key]:.3g} of the largest entry > "
                                 f"{XLSTM_BLOCK_ATOL:.3g}")
    got, want = card_out["slstm_ref_init"].float(), \
        cpu_out["slstm_ref_init"].float()
    r["ref_init_16"] = float((got - want)[:, :16].abs().max()
                             / want[:, :16].abs().max())
    r["ref_init_all"] = float((got - want).abs().max() / want.abs().max())
    r["state_fro"] = state_fro(torch, card_out["state"], cpu_out["state"])
    if not r["state_fro"] <= XLSTM_STATE_FRO:
        raise AssertionError(f"(g) state: card vs CPU rel fro "
                             f"{r['state_fro']:.3g} > {XLSTM_STATE_FRO}")
    return r


def slstm_grad_growth(torch, arch, dev, t=1024):
    """|d y_t / d x_0|, the largest entry, of one full-width sLSTM block
    (bf16 weights, f32 input) over `t` tokens at the reference's init and
    under `contract_slstm`, at t 32 and at `t`; not gated."""
    from repro_torch.models import xlstm
    cfg = arch.cfg
    gen = torch.Generator(device=dev).manual_seed(23)
    ref = xlstm.init_slstm_block(cfg, gen, torch.float32, dev)
    x = torch.randn((1, t, cfg.d_model), generator=gen, device=dev)
    out = {}
    for name, p in (("reference", ref), ("contracted", contract_slstm(
            torch, arch, dict(ref, **{n: ref[n].clone() for n in (
                "ri", "rf", "rz", "ro")})))):
        for n in (32, t):
            xi = x[:, :n].clone().requires_grad_(True)
            y, _ = xlstm.apply_slstm_block(p, xi, cfg)
            (g,) = torch.autograd.grad(y[:, -1].sum(), [xi])
            out[(name, n)] = float(g[0, 0].abs().max())
    return out


def phase_xlstm_train(torch, np, card, dev):
    """Phase 14 (f): xlstm-125m at full width, XLSTM_TRAIN_LAYERS blocks,
    AdamW, the kernel loss, batch 4 x 1024 (4 mLSTM chunks), 3 steps, the
    sLSTM recurrent matrices at std 1/sqrt(hd) (`contract_slstm`; the
    reference's init explodes, `slstm_grad_growth`, printed first); and one
    sLSTM block against one mLSTM block over that batch, CUDA events."""
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import build
    from repro_torch.models import xlstm
    from repro_torch.models.registry import get_arch, init_params
    from repro_torch.optim.tree import leaves
    from repro_torch.train import TrainConfig, build_loss_fn
    arch = with_cfg(get_arch(XLSTM_ID), n_layers=XLSTM_TRAIN_LAYERS)
    steps, b, t = 3, 4, 1024
    tc = TrainConfig(peak_lr=3e-3, warmup_steps=1, total_steps=steps,
                     loss_impl="kernel", loss_block_v=2048)
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size, seq_len=t,
                                  global_batch=b, seed=0))
    grow = slstm_grad_growth(torch, arch, dev)
    print(f"[xlstm] (f) one sLSTM block's |d y_t / d x_0| (largest entry) "
          f"at t 32 / 1024: the reference's init {grow[('reference', 32)]:.3g}"
          f" / {grow[('reference', 1024)]:.3g}, contracted "
          f"{grow[('contracted', 32)]:.3g} / {grow[('contracted', 1024)]:.3g}"
          f" (not gated; f32 overflows at 3.4e38)", flush=True)
    t0 = time.perf_counter()
    params = contract_slstm(torch, arch, init_params(
        arch, torch.Generator(device=dev).manual_seed(0), dev))
    ps = [p.requires_grad_(True) for p in leaves(params)]
    head = params["lm_head"]
    torch.cuda.synchronize()
    print(f"[xlstm] (f) set-up {time.perf_counter() - t0:.1f}s: {XLSTM_ID} "
          f"{arch.cfg.n_layers} blocks at full width (contract_slstm), "
          f"AdamW, loss_impl kernel, batch {b} x {t}", flush=True)
    batch0 = to_device(data.batch(0), dev)
    hi = next(i for i, p in enumerate(ps) if p is head)
    grads = []
    undo = spy_ce_grads(grads)
    try:
        loss_fn = build_loss_fn(arch, TrainConfig(
            loss_impl="kernel", loss_block_v=tc.loss_block_v))
        loss, _ = loss_fn(params, batch0)
        all_g = torch.autograd.grad(loss, ps)
        lk, gk = float(loss.detach()), all_g[hi]
        nan = [i for i, g in enumerate(all_g)
               if not bool(torch.isfinite(g).all())]
        del all_g
        loss_fn = build_loss_fn(arch, TrainConfig(
            loss_impl="canonical", loss_block_v=tc.loss_block_v))
        loss, _ = loss_fn(params, batch0)
        (gc_,) = torch.autograd.grad(loss, [head])
        lc = float(loss.detach())
    finally:
        undo()
    if nan:
        raise AssertionError(f"(f) step 0: gradients of leaves {nan} not "
                             "finite")
    grad_errs = check_ce_grads(torch, "(f) step 0", grads)
    del grads
    loss_err = abs(lk - lc) / abs(lc)
    head_fro = float((gk.float() - gc_.float()).norm() / gc_.float().norm())
    del gk, gc_, loss
    if not (loss_err <= TRAIN_LOSS_RTOL and head_fro <= TRAIN_HEAD_FRO):
        raise AssertionError(f"(f) step 0: kernel loss {lk} vs canonical "
                             f"{lc} (rel {loss_err:.3g}), lm_head grad rel "
                             f"fro {head_fro:.3g}")
    print(f"[xlstm] (f) step 0, kernels vs canonical loss: {lk:.6f} vs "
          f"{lc:.6f} (rel {loss_err:.3g}, limit {TRAIN_LOSS_RTOL}), bf16 "
          f"lm_head grad rel fro {head_fro:.3g} (limit {TRAIN_HEAD_FRO}); "
          f"every gradient finite; the backward at its own shape, each "
          "launch against its plain version on the same inputs: "
          + "; ".join(f"{name} (n {n}, V {v}, d {d}) max |err| {err:.3g}, "
                      f"rel fro {fro:.3g} (limit {CE_GRAD_FRO})"
                      for name, n, v, d, err, fro in grad_errs), flush=True)
    # one block of each kind over the training batch, forward only
    cfg = arch.cfg
    p0 = params["pairs"][0]
    with torch.no_grad():
        x = torch.randn((b, t, cfg.d_model), device=dev).to(
            getattr(torch, cfg.compute_dtype))
        s_ms = cuda_ms(torch, lambda: xlstm.apply_slstm_block(
            p0["slstm"], x, cfg), iters=3, warmup=1)
        m_ms = cuda_ms(torch, lambda: xlstm.apply_mlstm_block(
            p0["mlstm"], x, cfg), iters=3, warmup=1)
    del params, ps, head, x, p0
    torch.cuda.empty_cache()
    print(f"[xlstm] (f) one block over {b} x {t} tokens, forward, CUDA "
          f"events: sLSTM {s_ms:.1f} ms ({t} sequential steps), mLSTM "
          f"{m_ms:.1f} ms ({t // cfg.chunk} chunks): the sLSTM's share of a "
          f"pair {s_ms / (s_ms + m_ms):.3f} on {card}", flush=True)
    state, history, counts, spans, peak = train_run(
        torch, np, build, tc, arch, dev, data, steps,
        prepare=lambda p: contract_slstm(torch, arch, p))
    want = {"fused_ce_fwd": steps, "fused_ce_dh": steps,
            "fused_ce_dw": steps}
    counts = {k_: c for k_, c in counts.items() if c}
    if counts != want:
        raise AssertionError(f"(f) launches {counts}, expected {want}")
    if not all(np.isfinite(m["grad_norm"]) for _, m in history):
        raise AssertionError(f"(f) grad norms "
                             f"{[m['grad_norm'] for _, m in history]}")
    opt_gb = state_bytes(opt_tensors(state["opt"])) / 1e9
    p50 = float(np.median(spans))
    print(f"[xlstm] (f) {steps} steps, loss "
          + " ".join(f"{m['loss']:.4f}" for _, m in history)
          + ", grad norm " + " ".join(f"{m['grad_norm']:.4f}"
                                      for _, m in history)
          + f"; launches {counts} = one of each a step; step {p50:.1f} ms "
          f"p50 over steps 1-{steps - 1}, {b * t / (p50 / 1e3):.0f} "
          f"tokens/s, peak memory {peak:.2f} GiB, AdamW state {opt_gb:.3f} "
          f"GB on {card}", flush=True)
    del state
    return counts


def phase_xlstm(torch, np, card, dev):
    """Phase 14, last: (a), (b), (e), (d) and (c) on the full-depth model,
    then (g) and (f).  Returns the launches by kernel."""
    launches = {}

    def add(counts):
        for key, n in counts.items():
            launches[key] = launches.get(key, 0) + n

    counts, arch, params, prompts, _ = phase_xlstm_serve(torch, np, card,
                                                         dev)
    add(counts)
    add(phase_xlstm_spec(torch, np, arch, params, prompts, card, dev))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    r = xlstm_blocks_card_vs_cpu(torch, np, arch, dev)
    print(f"[xlstm] (g) one full-width block, card vs CPU from the same "
          f"bf16 input and weights: sLSTM over 2048 tokens max |err| "
          f"{r['slstm']:.3g} of the largest entry, mLSTM {r['mlstm']:.3g}; "
          f"a pair over a bucketed 300-token prefill (512) + 4 decode steps "
          f"{r['pair_out']:.3g} (limit {XLSTM_BLOCK_ATOL:.3g} each), its "
          f"state rel fro {r['state_fro']:.3g} a leaf (limit "
          f"{XLSTM_STATE_FRO}); card {r['card_s']:.1f}s, CPU "
          f"{r['cpu_s']:.1f}s; not gated, the sLSTM block at the "
          f"reference's init (recurrent std 1/2): {r['ref_init_16']:.3g} "
          f"over its first 16 tokens, {r['ref_init_all']:.3g} over 2048 "
          f"(chaotic: two roundings part for good)", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    add(phase_xlstm_train(torch, np, card, dev))
    gc.collect()
    torch.cuda.empty_cache()
    return launches


ENCDEC_ID = "seamless-m4t-medium"
ENCDEC_NEW = 16                   # new tokens a request
ENCDEC_SLOT_CROSS = 201326592     # 12 layers x K, V x 4096 x 16 x 64 x 2 B
ENCDEC_ADAMW_BYTES = 7018151936   # 877,268,992 params x 8 B
# (a), (b), (d): a served greedy token's logit against the best one of a
# cache-free forward over its frames and its whole sequence.  The two
# round apart: the served decoder attends over a bf16 cache (prefill
# attention within the bucket, then one-token decode), the cache-free
# one runs the blockwise recurrence over the whole sequence, and both
# round bf16 activations through 24 blocks; two cache-free forwards
# that differ only in their row count give the floor of the GEMMs'
# share (printed).  The seeded head's logits have std ~0.06 (fan-in V:
# std 1/sqrt(256206) times sqrt(1024)) and top-2 gaps of ~1e-3: a wrong
# slot, other frames or a stale cross K/V give another context, whose
# served token trails the best one by ~0.15-0.25 (a random token
# against the best of 256206), ten times the limit
ENCDEC_TOL = 2e-2
# (e): one full-width block on the card against the CPU from the same
# bf16 input and weights: outputs and the self cache's K within 2^-6 of
# the CPU's largest entry (bf16 GEMM outputs after f32 sums in another
# order, as phases 13 (f) and 14 (g))
ENCDEC_BLOCK_ATOL = 2.0 ** -6
# (d): draft = target drafts with one-token decode steps and verifies
# with one K + 1-token forward: the two round apart, so a near-tie may
# flip a draft (the target's choice is then emitted): acceptance at
# least 0.9
ENCDEC_ACCEPT = 0.9


def encdec_head(torch, gen, dev):
    """seamless-m4t-medium's padded head: 256256 x 1024 bf16 at std
    1/sqrt(d), the 50 rows past its vocab of 256206 zero."""
    w = torch.randn((256256, 1024), generator=gen, device=dev) / 32
    w[ENCDEC_VALID:] = 0.0
    return w.bfloat16()


def encdec_frames(torch, seed, dev, t, d):
    """One request's encoder frames (1, t, d) bf16 at std 1, seeded."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((1, t, d), generator=gen, device=dev).bfloat16()


def encdec_prompts(np, vocab):
    """(a)'s traffic: eight prompts of 5-60 tokens (buckets 8-64) and one
    of 300 (bucket 512)."""
    rng = np.random.default_rng(15)
    lens = [5] + list(rng.integers(6, 61, 7)) + [300]
    return [rng.integers(1, vocab, int(n)).astype(np.int32) for n in lens]


def encdec_served(torch, np, tag, arch, make_engine, prompts, fes,
                  n_layers=0, engines=None, max_new=ENCDEC_NEW):
    """Serve `prompts`, each after its own frames `fes[i]`, through
    `counted_run` on a `make_engine()` (appended to `engines`): one
    `sample_topk` launch a prefill and a step (and `n_layers`
    `paged_attn` a step on a paged engine), each call held to its plain
    version.  Returns (outs, sched, launches, seconds, decode step ms,
    peak GiB, max |err|)."""
    from repro_torch import obs
    from repro_torch.kernels import build
    engines = [] if engines is None else engines

    def make():
        engines.append(make_engine())
        return engines[-1]

    calls = []
    undo = spy_topk(calls)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, sched, results, rids, dt, launches, _, tracer = counted_run(
            torch, np, make, lambda s: [
                s.submit(p, frontend_embeds=f) for p, f in zip(prompts,
                                                                fes)],
            build, obs, max_new=max_new)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        undo()
    counts = {k: c for k, c in launches.items() if c}
    check_serve_launches(tag, sched, counts, n_layers)
    err = check_topk_calls(torch, np, tag, calls, arch, False, False)
    del calls
    outs = [np.asarray(results[r]) for r in rids]
    if any(len(o) != max_new for o in outs):
        raise AssertionError(f"{tag}: a request did not get its {max_new} "
                             "tokens")
    if not all(((o >= 0) & (o < arch.vocab_size)).all() for o in outs):
        raise AssertionError(f"{tag}: a served id lies outside the vocab")
    steps = [sp.duration * 1e3 for sp in tracer.spans
             if sp.name == "engine.decode_step"]
    return outs, sched, counts, dt, steps, peak, err


def encdec_deficits(torch, np, arch, params, prompts, outs, fes, dev):
    """(worst, agree, floor) of `family_deficits` for enc-dec: each
    request's cache-free forward runs the encoder over its own frames."""
    from repro_torch.models.registry import forward_hidden
    head = params["lm_head"][:arch.vocab_size].float()
    worst = floor = 0.0
    agree = []
    with torch.no_grad():
        for prompt, out, fe in zip(prompts, outs, fes):
            seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
            served = torch.from_numpy(out.astype(np.int64)).to(dev)
            got = []
            for s in (seq, np.concatenate([seq, prompt[:64]])):
                h, _, _ = forward_hidden(arch, params, {
                    "tokens": torch.from_numpy(s[None]).to(dev),
                    "frontend_embeds": fe})
                z = h[0, len(prompt) - 1:len(seq)].float() @ head.T
                best, ids = z.max(-1)
                got.append((best, z.gather(1, served[:, None])[:, 0], ids))
            (best, zs, ids), (best2, zs2, _) = got
            worst = max(worst, float((best - zs).max()))
            floor = max(floor, float((best - best2).abs().max()),
                        float((zs - zs2).abs().max()))
            agree.append(ids.cpu().numpy() == out)
    del head
    return worst, np.concatenate(agree), floor


def encdec_line(np, tag, outs, dt, steps, peak, card):
    return family_serve_line(np, tag, outs, dt, steps, peak, card).replace(
        "[family]", "[encdec]")


def check_deficit(tag, worst, limit=ENCDEC_TOL):
    if not worst <= limit:
        raise AssertionError(f"{tag}: a served token trails the cache-free "
                             f"forward's best logit by {worst:.3g} > {limit}")


def phase_encdec_serve(torch, np, card, dev):
    """Phase 15 (a), (b), (c): seamless-m4t-medium at full width and depth
    (12 + 12 layers); returns (launches, arch, params, prompts, fes, outs)
    for (d)."""
    from repro_torch.models import encdec
    from repro_torch.models.registry import get_arch, init_params
    from repro_torch.optim.tree import leaves
    from repro_torch.serve import Engine, PagedEngine, ServeConfig
    arch = get_arch(ENCDEC_ID)
    cfg = arch.cfg
    t0 = time.perf_counter()
    params = init_params(arch, torch.Generator(device=dev).manual_seed(15),
                         dev)
    gb = sum(t.numel() * t.element_size() for t in leaves(params)) / 1e9
    prompts = encdec_prompts(np, arch.vocab_size)
    sc = ServeConfig(batch_size=8, max_len=512)
    fes = [encdec_frames(torch, 150 + i, dev, sc.enc_len, cfg.d_model)
           for i in range(len(prompts))]
    Engine(arch, params, sc, device=dev).generate(
        [prompts[0]], 2, frontend_embeds=fes[0])
    torch.cuda.synchronize()
    print(f"[encdec] (a) set-up {time.perf_counter() - t0:.1f}s: "
          f"{ENCDEC_ID} {cfg.n_enc_layers} encoder + {cfg.n_dec_layers} "
          f"decoder layers, d={cfg.d_model}, {cfg.num_heads} / "
          f"{cfg.num_kv_heads} heads of {cfg.resolved_head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {arch.vocab_size} (head "
          f"{params['lm_head'].shape[0]} rows), {gb:.3f} GB of bf16 "
          f"params; Engine batch 8, max_len 512, enc_len {sc.enc_len}; "
          f"prompts of {[len(p) for p in prompts]} tokens, each after its "
          f"own seeded (1, {sc.enc_len}, {cfg.d_model}) bf16 frames, "
          f"{ENCDEC_NEW} new", flush=True)
    launches = {"sample_topk": 0, "paged_attn": 0, "score_tokens": 0}

    # (a) the slab Engine
    engines = []
    outs, sched, counts, dt, steps, peak, err = encdec_served(
        torch, np, "(a)", arch, lambda: Engine(arch, params, sc, device=dev),
        prompts, fes, engines=engines)
    launches["sample_topk"] += counts["sample_topk"]
    cross = [t for layer in engines[0].caches["cross"]
             for t in layer.values()]
    slot_cross = sum(t[0].numel() * t.element_size() for t in cross)
    cross_dt = {str(t.dtype) for t in cross}
    worst, agree, floor = encdec_deficits(torch, np, arch, params, prompts,
                                          outs, fes, dev)
    solo = Engine(arch, params, sc, device=dev).generate(
        [prompts[3]], ENCDEC_NEW, frontend_embeds=fes[3])[0]
    p50 = float(np.median(steps))
    with torch.no_grad():
        enc_ms = cuda_ms(torch, lambda: encdec.encode(params, fes[0], cfg),
                         iters=3, warmup=1)
        x = torch.randn((8, 1, cfg.d_model), device=dev).bfloat16()
        kvs = engines[0].caches["cross"]
        cross_ms = cuda_ms(torch, lambda: [
            encdec.cross_attention(p["cross_attn"], x, kv, cfg)
            for p, kv in zip(params["dec"], kvs)], iters=10, warmup=2)
    del engines, cross, kvs
    print(f"[encdec] (a) sample_topk launches {len(sched.admit_order)} "
          f"prefills + {sched.decode_steps} steps = one a prefill and a "
          f"step, each held to the plain version (max |err| {err:.3g}); "
          f"served tokens {agree.mean():.3f} of {agree.size} equal to a "
          f"cache-free forward's over the same frames, trailing its best "
          f"logit by at most {worst:.3g} (limit {ENCDEC_TOL}; rounding "
          f"floor, two cache-free forwards 64 rows apart: {floor:.3g}); "
          f"cross K/V {slot_cross} B a slot in {sorted(cross_dt)} (limit "
          f"{ENCDEC_SLOT_CROSS}); request 3 alone "
          f"{'equal to' if np.array_equal(solo, outs[3]) else 'NOT'} its "
          f"tokens in the batch", flush=True)
    print(encdec_line(np, "(a)", outs, dt, steps, peak, card), flush=True)
    print(f"[encdec] (a) one {sc.enc_len}-frame encode alone "
          f"({cfg.n_enc_layers} layers, non-causal blockwise attention in "
          f"plain PyTorch) {enc_ms:.2f} ms; the {cfg.n_dec_layers} layers' "
          f"cross-attention at batch 8, Tq 1 over "
          f"{sc.enc_len} keys (blockwise, {sc.enc_len // cfg.chunk_k} KV "
          f"chunks) {cross_ms:.2f} ms: {cross_ms / p50:.3f} of a "
          f"{p50:.2f} ms decode step p50 on {card}", flush=True)
    check_deficit("(a)", worst)
    if slot_cross != ENCDEC_SLOT_CROSS or cross_dt != {"torch.bfloat16"} \
            or not np.array_equal(solo, outs[3]):
        raise AssertionError(f"(a): cross {slot_cross} B in {cross_dt}, "
                             f"alone {solo} vs batched {outs[3]}")

    # (b) the paged engine with the prefix cache, on (a)'s traffic and
    # eight requests of one 128-token prompt under frames A, B, A, B, ...
    shared = np.random.default_rng(151).integers(
        1, arch.vocab_size, 128).astype(np.int32)
    fe_ab = [encdec_frames(torch, 160 + i, dev, sc.enc_len, cfg.d_model)
             for i in range(2)]
    b_prompts = prompts + [shared] * 8
    b_fes = fes + fe_ab * 4
    psc = ServeConfig(batch_size=8, max_len=512, paged=True, block_size=16)
    matches, peng, paged = [], [], []

    def make_paged():
        eng = PagedEngine(arch, params, psc, device=dev)
        real = eng.prefix.match

        def match(target, scope=None):
            chain = real(target, scope=scope)
            matches.append((scope, tuple(chain)))
            return chain

        eng.prefix.match = match
        return eng

    undo = spy_paged_calls(paged)
    try:
        b_outs, b_sched, counts, dt, steps, peak, err = encdec_served(
            torch, np, "(b)", arch, make_paged, b_prompts, b_fes,
            n_layers=cfg.n_dec_layers, engines=peng)
    finally:
        undo()
    launches["sample_topk"] += counts["sample_topk"]
    launches["paged_attn"] += counts["paged_attn"]
    stats = peng[0].paged_stats()
    hits = stats["prefix"]["hits"]
    by_scope = {}
    for scope, chain in matches:
        by_scope.setdefault(scope, []).append(chain)
    shared_chains = [c for c in by_scope.values() if len(c) == 4]
    # the first request of a scope misses, the later three adopt its 7
    # full blocks (a match leaves the last prompt token to the suffix);
    # (a)'s requests, each under frames of its own, miss
    full = (len(shared) - 1) // psc.block_size
    ok_scopes = (len(matches) == len(b_prompts) and len(shared_chains) == 2
                 and all(c[0] == () and len(c[1]) == full
                         and len(set(c[1:])) == 1 for c in shared_chains)
                 and not set(shared_chains[0][1]) & set(shared_chains[1][1])
                 and all(m == () for c in by_scope.values() if len(c) != 4
                         for m in c))
    slab_ab = Engine(arch, params, sc, device=dev)
    ref_ab = [slab_ab.generate([shared], ENCDEC_NEW, frontend_embeds=f)[0]
              for f in fe_ab]
    del slab_ab
    same_ab = [np.array_equal(o, ref_ab[i % 2])
               for i, o in enumerate(b_outs[len(prompts):])]
    b_worst, b_agree, b_floor = encdec_deficits(
        torch, np, arch, params, b_prompts, b_outs, b_fes, dev)
    same_a = np.mean([np.mean(x == y) for x, y in zip(b_outs, outs)])
    print(f"[encdec] (b) PagedEngine block 16, prefix cache on: launches "
          f"sample_topk {len(b_sched.admit_order)} prefills + "
          f"{b_sched.decode_steps} steps (max |err| {err:.3g}), paged_attn "
          f"{counts['paged_attn']} = {cfg.n_dec_layers} a step (head_dim "
          f"{cfg.resolved_head_dim}, {cfg.num_heads} / {cfg.num_kv_heads} "
          f"heads), each held to the plain version (max |err| "
          f"{max(e for e, _ in paged):.3g}); prefix hits {hits} (want 6), "
          f"each later A / B request on its scope's first chain of "
          f"{len(shared_chains[0][1]) if shared_chains else 0} blocks and "
          f"none across the frames: {ok_scopes}; shared-prompt tokens equal "
          f"to the slab engine's under the same frames: {sum(same_ab)} of "
          f"{len(same_ab)}; every token within {b_worst:.3g} of the "
          f"cache-free best (limit {ENCDEC_TOL}, floor {b_floor:.3g}); "
          f"(a)'s requests {same_a:.3f} of their tokens equal to (a)'s; "
          f"paged_stats enabled {stats['enabled']}, {stats['block_bytes']} "
          f"B a block", flush=True)
    print(encdec_line(np, "(b)", b_outs, dt, steps, peak, card), flush=True)
    check_deficit("(b)", b_worst)
    if hits != 6 or not ok_scopes or not stats["enabled"]:
        raise AssertionError(f"(b): hits {hits}, scopes {ok_scopes}, "
                             f"stats {stats}")
    del peng, b_outs

    # (c) eval: score_tokens at V 256256
    launches["score_tokens"] += encdec_eval(torch, np, arch, params, card,
                                            dev)
    return launches, arch, params, prompts, fes, outs


def encdec_eval(torch, np, arch, params, card, dev):
    """Phase 15 (c): 4 prompts of 64 tokens, each after its own frames, x
    2 continuations of 8 through `submit_eval` on the slab Engine (72
    tokens: bucket 128); one `score_tokens` launch a continuation; every
    logp within EVAL_ATOL of log_softmax of the f32 logits of a
    cache-free forward over the same bucket-padded tokens and frames
    (causal: its rows at the real positions are the prefill's)."""
    from repro_torch import obs
    from repro_torch.kernels import build
    from repro_torch.models.registry import forward_hidden
    from repro_torch.serve import ContinuousScheduler, Engine, ServeConfig
    vocab = arch.vocab_size
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, vocab, 64).astype(np.int32) for _ in range(4)]
    conts = [[rng.integers(1, vocab, 8).astype(np.int32) for _ in range(2)]
             for _ in prompts]
    sc = ServeConfig(batch_size=8, max_len=512)
    fes = [encdec_frames(torch, 170 + i, dev, sc.enc_len, arch.cfg.d_model)
           for i in range(len(prompts))]
    reg, tracer = obs.enable(trace=True)
    try:
        eng = Engine(arch, params, sc, device=dev)
        sched = ContinuousScheduler(eng)
        build.reset_counters()
        t0 = time.perf_counter()
        rids = [sched.submit_eval(p, c, frontend_embeds=f)
                for p, c, f in zip(prompts, conts, fes)]
        results = sched.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: c.count for k, c in build.COUNTERS.items() if c.count}
    finally:
        obs.disable()
    n_cont = sum(len(c) for c in conts)
    if launches != {"score_tokens": n_cont}:
        raise AssertionError(f"(c): launches {launches}, expected one "
                             f"score_tokens a continuation ({n_cont})")
    head = params["lm_head"][:vocab].float()
    worst = 0.0
    with torch.no_grad():
        for prompt, cs, rid, fe in zip(prompts, conts, rids, fes):
            for cont, got_lp in zip(cs, results[rid]):
                seq = np.concatenate([prompt, cont]).astype(np.int64)
                padded = np.zeros((128,), np.int64)
                padded[:len(seq)] = seq
                cid = torch.from_numpy(cont.astype(np.int64)).to(dev)
                h, _, _ = forward_hidden(arch, params, {
                    "tokens": torch.from_numpy(padded[None]).to(dev),
                    "frontend_embeds": fe})
                z = h[0, len(prompt) - 1:len(seq) - 1].float() @ head.T
                want = torch.log_softmax(z, -1).gather(
                    1, cid[:, None])[:, 0].cpu().numpy()
                if not np.all(np.isfinite(got_lp)):
                    raise AssertionError("(c): a logp is not finite")
                worst = max(worst, float(np.abs(got_lp - want).max()))
    del head
    print(f"[encdec] (c) eval: launches {launches} = one score_tokens a "
          f"continuation (V {params['lm_head'].shape[0]}, valid {vocab}, d "
          f"{arch.cfg.d_model}), no sample_topk; every logp within "
          f"{worst:.3g} of log_softmax of a cache-free forward over the same "
          f"padded tokens and frames (limit {EVAL_ATOL}); "
          f"{sched.eval_tokens_scored} tokens scored in {dt:.3f}s on {card}",
          flush=True)
    if not worst <= EVAL_ATOL:
        raise AssertionError(f"(c): a logp is {worst:.3g} from the "
                             f"cache-free forward's (limit {EVAL_ATOL})")
    return launches["score_tokens"]


def phase_encdec_spec(torch, np, arch, params, prompts, fes, outs, card,
                      dev):
    """Phase 15 (d): `SpecEngine` with draft = target, k 4, on (a)'s
    prompts but the 300-token one: two `sample_topk` launches a prefill
    (target and draft) and k + 1 a step, each held to its plain version;
    acceptance at least ENCDEC_ACCEPT; each request's tokens equal to
    (a)'s, or every token within ENCDEC_TOL of the cache-free best; and
    the `'len'` rollback leaves every cross leaf bit for bit as the
    prefills wrote it."""
    from repro_torch.optim.tree import leaves
    from repro_torch.serve import ServeConfig, SpecConfig, SpecEngine
    sc = ServeConfig(batch_size=8, max_len=512)
    k = SPEC_K

    def make():
        return SpecEngine(arch, params, sc, arch, params, SpecConfig(k=k),
                          device=dev)

    n = len(prompts) - 1
    d_outs, sched, topk_n, line = family_spec_run(
        torch, np, arch, "(d)", make, prompts[:n], 2, k + 1,
        max_new=ENCDEC_NEW, fes=fes[:n])
    same = [np.array_equal(x, y) for x, y in zip(d_outs, outs[:n])]
    diff = [i for i, s in enumerate(same) if not s]
    worst = 0.0
    if diff:
        worst, _, _ = encdec_deficits(
            torch, np, arch, params, [prompts[i] for i in diff],
            [d_outs[i] for i in diff], [fes[i] for i in diff], dev)
    # the rollback: two slots prefilled, three spec steps, the cross K/V
    # of both models bit for bit the prefills'
    eng = make()
    for slot in range(2):
        eng.prefill_into_slot(slot, prompts[slot], fes[slot])
    trees = (eng.caches["cross"], eng.draft.caches["cross"])
    before = [t[:2].clone() for tree in trees for t in leaves(tree)]
    for _ in range(3):
        eng.decode_step_multi()
    kept = all(torch.equal(a, t[:2]) for a, t in zip(
        before, [t for tree in (eng.caches["cross"],
                                eng.draft.caches["cross"])
                 for t in leaves(tree)]))
    del eng, before, trees
    print(f"[encdec] (d) SpecEngine draft = target, k {k}: {line}; tokens "
          f"equal to (a)'s for {sum(same)} of {n} requests (the others "
          f"within {worst:.3g} of the cache-free best, limit "
          f"{ENCDEC_TOL}); after 3 rolled-back steps every cross leaf of "
          f"target and draft {'bit for bit' if kept else 'NOT'} the "
          f"prefills' on {card}", flush=True)
    if sched.acceptance_rate < ENCDEC_ACCEPT or not kept:
        raise AssertionError(f"(d): acceptance {sched.acceptance_rate}, "
                             f"cross kept {kept}")
    check_deficit("(d)", worst)
    return {"sample_topk": topk_n}


def encdec_blocks_card_vs_cpu(torch, np, arch, dev, t=4096, t_pre=300,
                              bucket=512, steps=4):
    """Phase 15 (e): at full width, from the same seeded bf16 frames,
    inputs and weights (the MLP biases drawn at std 0.5, so their place
    and dtype show), on the card and on the CPU: one encoder block over
    `t` frames (non-causal blockwise attention with RoPE), then one
    decoder block with cross-attention over that block's output (Tq !=
    Tk, no mask) on a bucketed `t_pre`-token prefill (`bucket` rows) into
    a bf16 slab cache, followed by `steps` one-token decode steps.
    Returns the readings; raises past ENCDEC_BLOCK_ATOL."""
    from repro_torch.models import encdec, transformer
    cfg = arch.cfg
    gen = torch.Generator(device=dev).manual_seed(25)
    ep = encdec.init_enc_block(cfg, gen, torch.bfloat16, dev)
    dp = encdec.init_dec_block(cfg, gen, torch.bfloat16, dev)
    for p in (ep, dp):
        for name in ("bi", "bo"):
            b = p["mlp"][name]
            p["mlp"][name] = (torch.randn(b.shape, generator=gen, device=dev)
                              * 0.5).bfloat16()
    frames = torch.randn((1, t, cfg.d_model), generator=gen,
                         device=dev).bfloat16()
    x = torch.randn((1, bucket + steps, cfg.d_model), generator=gen,
                    device=dev).bfloat16()
    cpu = torch.device("cpu")

    def run(d):
        e, dd = tree_to(ep, d), tree_to(dp, d)
        out = {}
        with torch.no_grad():
            out["enc"] = encdec.apply_enc_block(e, frames.to(d), cfg)
            kv = encdec.cross_kv(dd["cross_attn"], out["enc"])
            cache = {k_: v[0] for k_, v in transformer.stacked_caches(
                cfg.attn_config(), 1, 1, bucket, torch.bfloat16, d).items()}
            xd = x.to(d)
            y, cache = encdec.apply_dec_block(dd, xd[:, :bucket], kv, cfg,
                                              cache=cache)
            cache = dict(cache, len=cache["len"] - (bucket - t_pre))
            ys = [y[:, :t_pre]]
            for i in range(steps):
                y, cache = encdec.apply_dec_block(
                    dd, xd[:, bucket + i:bucket + i + 1], kv, cfg,
                    cache=cache)
                ys.append(y)
            out["dec"] = torch.cat(ys, dim=1)
            out["k"] = cache["k"][:, :t_pre + steps]
        return tree_to(out, cpu)

    t0 = time.perf_counter()
    card_out = run(dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu_out = run(cpu)
    r = {"card_s": t1 - t0, "cpu_s": time.perf_counter() - t1}
    for key in ("enc", "dec", "k"):
        got, want = card_out[key].float(), cpu_out[key].float()
        r[key] = float((got - want).abs().max() / want.abs().max())
        if not r[key] <= ENCDEC_BLOCK_ATOL:
            raise AssertionError(f"(e) {key}: card vs CPU max |err| "
                                 f"{r[key]:.3g} of the largest entry > "
                                 f"{ENCDEC_BLOCK_ATOL:.3g}")
    return r


class EncDecBatches:
    """Seeded enc-dec training batches: tokens and targets (b, t) int32
    over the vocab, and encoder frames (b, t_enc, d) f32 at std 1 (cast
    to bf16 by the encoder); ``batch(i)`` is the i-th, iteration runs
    through them in order."""

    def __init__(self, np, vocab, b, t, t_enc, d):
        self.np, self.shape = np, (vocab, b, t, t_enc, d)

    def batch(self, i):
        vocab, b, t, t_enc, d = self.shape
        rng = self.np.random.default_rng(1000 + i)
        return {"tokens": rng.integers(0, vocab, (b, t)).astype("int32"),
                "targets": rng.integers(0, vocab, (b, t)).astype("int32"),
                "frontend_embeds": rng.standard_normal(
                    (b, t_enc, d), dtype="float32")}

    def __iter__(self):
        i = 0
        while True:
            yield self.batch(i)
            i += 1


def phase_encdec_train(torch, np, card, dev):
    """Phase 15 (f): seamless-m4t-medium at full width and depth, AdamW,
    the kernel loss, batch 4 x 1024 decoder tokens over 4 x 1024 frames
    (4096 rows of the 256256-row head: the canonical logits would be 4.2
    GB in f32), 3 steps."""
    from repro_torch.data import to_device
    from repro_torch.kernels import build
    from repro_torch.models.registry import get_arch, init_params
    from repro_torch.optim.tree import leaves_with_paths
    from repro_torch.train import TrainConfig, build_loss_fn
    arch = get_arch(ENCDEC_ID)
    cfg = arch.cfg
    steps, b, t = 3, 4, 1024
    tc = TrainConfig(peak_lr=3e-3, warmup_steps=1, total_steps=steps,
                     loss_impl="kernel", loss_block_v=2048)
    data = EncDecBatches(np, arch.vocab_size, b, t, t, cfg.d_model)
    t0 = time.perf_counter()
    params = init_params(arch, torch.Generator(device=dev).manual_seed(0),
                         dev)
    named = list(leaves_with_paths(params))
    ps = [p.requires_grad_(True) for _, p in named]
    head = params["lm_head"]
    torch.cuda.synchronize()
    print(f"[encdec] (f) set-up {time.perf_counter() - t0:.1f}s: "
          f"{ENCDEC_ID} {cfg.n_enc_layers} + {cfg.n_dec_layers} layers at "
          f"full width, AdamW, loss_impl kernel, batch {b} x {t} decoder "
          f"tokens over {b} x {t} frames", flush=True)
    batch0 = to_device(data.batch(0), dev)
    hi = next(i for i, p in enumerate(ps) if p is head)
    grads = []
    undo = spy_ce_grads(grads)
    try:
        loss_fn = build_loss_fn(arch, TrainConfig(
            loss_impl="kernel", loss_block_v=tc.loss_block_v))
        loss, _ = loss_fn(params, batch0)
        all_g = torch.autograd.grad(loss, ps)
        lk, gk = float(loss.detach()), all_g[hi]
        bad = [path for (path, _), g in zip(named, all_g)
               if not bool(torch.isfinite(g).all())]
        enc_zero = [i for i in range(cfg.n_enc_layers) if not any(
            bool(g.ne(0).any()) for (path, _), g in zip(named, all_g)
            if path[:2] == ("enc", i))]
        del all_g
        loss_fn = build_loss_fn(arch, TrainConfig(
            loss_impl="canonical", loss_block_v=tc.loss_block_v))
        loss, _ = loss_fn(params, batch0)
        (gc_,) = torch.autograd.grad(loss, [head])
        lc = float(loss.detach())
    finally:
        undo()
    if bad or enc_zero:
        raise AssertionError(f"(f) step 0: gradients not finite at "
                             f"{bad[:4]}, encoder layers {enc_zero} all zero")
    dw = [r[3] for r in grads if r[0] == "fused_ce_dw"]
    pads_zero = len(dw) == 1 and not bool(dw[0][arch.vocab_size:].any())
    grad_errs = check_ce_grads(torch, "(f) step 0", grads)
    del grads, dw
    loss_err = abs(lk - lc) / abs(lc)
    head_fro = float((gk.float() - gc_.float()).norm() / gc_.float().norm())
    del gk, gc_, loss, params, ps, head, named, batch0
    torch.cuda.empty_cache()
    print(f"[encdec] (f) step 0, kernels vs canonical loss: {lk:.6f} vs "
          f"{lc:.6f} (rel {loss_err:.3g}, limit {TRAIN_LOSS_RTOL}), bf16 "
          f"lm_head grad rel fro {head_fro:.3g} (limit {TRAIN_HEAD_FRO}); "
          f"every gradient finite, each encoder layer's nonzero; dW's "
          f"{arch.padded_vocab - arch.vocab_size} pad rows zero: "
          f"{pads_zero}; the backward "
          "at its own shape, each launch against its plain version on the "
          "same inputs: "
          + "; ".join(f"{name} (n {n}, V {v}, d {d}) max |err| {err:.3g}, "
                      f"rel fro {fro:.3g} (limit {CE_GRAD_FRO})"
                      for name, n, v, d, err, fro in grad_errs), flush=True)
    if not (loss_err <= TRAIN_LOSS_RTOL and head_fro <= TRAIN_HEAD_FRO
            and pads_zero):
        raise AssertionError(f"(f) step 0: kernel loss {lk} vs canonical "
                             f"{lc} (rel {loss_err:.3g}), lm_head grad rel "
                             f"fro {head_fro:.3g}, pad rows zero "
                             f"{pads_zero}")
    state, history, counts, spans, peak = train_run(
        torch, np, build, tc, arch, dev, data, steps)
    want = {"fused_ce_fwd": steps, "fused_ce_dh": steps,
            "fused_ce_dw": steps}
    counts = {k_: c for k_, c in counts.items() if c}
    if counts != want:
        raise AssertionError(f"(f) launches {counts}, expected {want}")
    if not all(np.isfinite(m["grad_norm"]) for _, m in history):
        raise AssertionError(f"(f) grad norms "
                             f"{[m['grad_norm'] for _, m in history]}")
    opt_bytes = state_bytes(opt_tensors(state["opt"]))
    p50 = float(np.median(spans))
    print(f"[encdec] (f) {steps} steps, loss "
          + " ".join(f"{m['loss']:.4f}" for _, m in history)
          + ", grad norm " + " ".join(f"{m['grad_norm']:.4f}"
                                      for _, m in history)
          + f"; launches {counts} = one of each a step; step {p50:.1f} ms "
          f"p50 over steps 1-{steps - 1}, {b * t / (p50 / 1e3):.0f} decoder "
          f"tokens/s, peak memory {peak:.2f} GiB, AdamW state {opt_bytes} B "
          f"(limit {ENCDEC_ADAMW_BYTES}) on {card}", flush=True)
    if opt_bytes != ENCDEC_ADAMW_BYTES:
        raise AssertionError(f"(f) AdamW state {opt_bytes} B")
    del state
    return counts


def phase_encdec(torch, np, card, dev):
    """Phase 15, last: (a), (b), (c) and (d) on the full-depth model, then
    (e) and (f).  Returns the launches by kernel."""
    launches = {}

    def add(counts):
        for key, n in counts.items():
            launches[key] = launches.get(key, 0) + n

    counts, arch, params, prompts, fes, outs = phase_encdec_serve(
        torch, np, card, dev)
    add(counts)
    add(phase_encdec_spec(torch, np, arch, params, prompts, fes, outs, card,
                          dev))
    del params, fes
    gc.collect()
    torch.cuda.empty_cache()
    r = encdec_blocks_card_vs_cpu(torch, np, arch, dev)
    print(f"[encdec] (e) one full-width block, card vs CPU from the same "
          f"bf16 frames, input and weights: the encoder block over 4096 "
          f"frames max |err| {r['enc']:.3g} of the largest entry; the "
          f"decoder block with cross-attention over its output, a bucketed "
          f"300-token prefill (512) + 4 decode steps {r['dec']:.3g}, its "
          f"self cache's K {r['k']:.3g} (limit {ENCDEC_BLOCK_ATOL:.3g} "
          f"each); card {r['card_s']:.1f}s, CPU {r['cpu_s']:.1f}s",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    add(phase_encdec_train(torch, np, card, dev))
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_wide_train(torch, np, arch_id, tag, card, dev):
    """Phase 16 (a) / (b): `arch_id` at its published widths cut to 1
    layer, AdamW, the kernel loss, batch 4 x 1024, 3 steps: step 0 held
    to the canonical loss, its dH and dW launches (the column passes past
    d 4096) to their plain versions.  Returns the launches."""
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import build
    from repro_torch.models.registry import get_arch, init_params
    from repro_torch.optim.tree import leaves
    from repro_torch.train import TrainConfig, build_loss_fn
    arch = with_cfg(get_arch(arch_id), n_layers=1)
    steps, b, t = 3, 4, 1024
    # lr 3e-5: at 3e-4 AdamW overshoots the one-layer 12288-wide model at
    # random init by its third step (loss 10.54 -> 20.10 on the H100, the
    # canonical loss alike: 20.10), at 3e-3 too (21.48)
    tc = TrainConfig(peak_lr=3e-5, warmup_steps=1, total_steps=steps,
                     loss_impl="kernel", loss_block_v=2048)
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size, seq_len=t,
                                  global_batch=b, seed=0))
    t0 = time.perf_counter()
    params = init_params(arch, torch.Generator(device=dev).manual_seed(0),
                         dev)
    head = params["lm_head"].requires_grad_(True)
    torch.cuda.synchronize()
    print(f"[wide] ({tag}) set-up {time.perf_counter() - t0:.1f}s: {arch_id}"
          f" d {arch.cfg.d_model}, 1 layer of {get_arch(arch_id).cfg.n_layers}"
          f", vocab {arch.vocab_size} (head {arch.padded_vocab}), AdamW, "
          f"loss_impl kernel, batch {b} x {t}", flush=True)
    batch0 = to_device(data.batch(0), dev)
    step0, grads = {}, []
    undo = spy_ce_grads(grads)
    try:
        for impl in ("kernel", "canonical"):
            loss_fn = build_loss_fn(arch, TrainConfig(
                loss_impl=impl, loss_block_v=tc.loss_block_v))
            loss, _ = loss_fn(params, batch0)
            (g_head,) = torch.autograd.grad(loss, [head])
            step0[impl] = (float(loss.detach()), g_head)
    finally:
        undo()
    grad_errs = check_ce_grads(torch, f"({tag}) step 0", grads)
    del grads
    (lk, gk), (lc, gc) = step0["kernel"], step0["canonical"]
    loss_err = abs(lk - lc) / abs(lc)
    head_fro = float((gk.float() - gc.float()).norm() / gc.float().norm())
    del step0, gk, gc, params, head
    torch.cuda.empty_cache()
    if not (loss_err <= TRAIN_LOSS_RTOL and head_fro <= TRAIN_HEAD_FRO):
        raise AssertionError(f"({tag}) step 0: kernel loss {lk} vs "
                             f"canonical {lc} (rel {loss_err:.3g}), lm_head "
                             f"grad rel fro {head_fro:.3g}")
    print(f"[wide] ({tag}) step 0, kernels vs canonical loss: {lk:.6f} vs "
          f"{lc:.6f} (rel {loss_err:.3g}, limit {TRAIN_LOSS_RTOL}), bf16 "
          f"lm_head grad rel fro {head_fro:.3g} (limit {TRAIN_HEAD_FRO}); "
          "its backward at its own shape against the plain versions: "
          + "; ".join(f"{name} (n {n}, V {v}, d {d}) max |err| {err:.3g}, "
                      f"rel fro {fro:.3g} (limit {CE_GRAD_FRO})"
                      for name, n, v, d, err, fro in grad_errs), flush=True)
    state, history, counts, spans, peak = train_run(
        torch, np, build, tc, arch, dev, data, steps)
    want = {"fused_ce_fwd": steps, "fused_ce_dh": steps,
            "fused_ce_dw": steps}
    counts = {k: c for k, c in counts.items() if c}
    if counts != want:
        raise AssertionError(f"({tag}) launches {counts}, expected {want}")
    n_params = sum(x.numel() for x in leaves(state["params"]))
    opt_gb = state_bytes(opt_tensors(state["opt"])) / 1e9
    p50 = float(np.median(spans))
    print(f"[wide] ({tag}) {steps} steps, loss "
          + " ".join(f"{m['loss']:.4f}" for _, m in history)
          + f"; launches {counts} = one of each a step; {n_params / 1e9:.3f}"
          f" G params, optimizer state {opt_gb:.2f} GB; step {p50:.1f} ms "
          f"p50 over steps 1-{steps - 1}, {b * t / (p50 / 1e3):.0f} "
          f"tokens/s, peak memory {peak:.2f} GiB on {card}", flush=True)
    del state
    return counts


def wide_topk_calls(torch, np, tag, calls, arch, k, lse):
    """Each recorded top-k call at `k` on `arch`'s head held to the plain
    version on the same hidden states (`check_topk_wide`, the lse at
    VAL_RTOL / VAL_ATOL); returns the largest error."""
    from repro_torch.kernels.sample_topk import topk_scores_ref
    worst = 0.0
    for h, w, kc, kw, out in calls:
        if kc != k or bool(kw.get("return_lse")) != lse or \
                kw.get("valid_vocab") != arch.vocab_size:
            raise AssertionError(f"{tag}: a top-k call at k {kc}, lse "
                                 f"{kw.get('return_lse')}, vocab "
                                 f"{kw.get('valid_vocab')}")
        ref = topk_scores_ref(h, w, kc, **kw)
        ext = topk_scores_ref(h, w, kc + 1, **kw)
        err, _ = check_topk_wide(np, out[0], out[1], ext[0], ext[1])
        if lse:
            torch.testing.assert_close(out[2], ref[2], rtol=VAL_RTOL,
                                       atol=VAL_ATOL)
            err = max(err, float((out[2] - ref[2]).abs().max()))
        worst = max(worst, err)
    return worst


def phase_wide_serve(torch, np, card, dev):
    """Phase 16 (c): qwen3-0.6b at top_k 100 (temperature 0.8) on phase
    3's traffic, a beam-40 group (80 candidates a row) on `PagedEngine`
    and a best-of-4 group at top_k 100 on `Engine`: every step's top-k
    (the list kernel) held to the plain version on its hidden states.
    Returns the sample_topk launches."""
    from repro_torch import obs
    from repro_torch.kernels import build
    from repro_torch.kernels.sample_topk import LAUNCHES
    from repro_torch.models.registry import get_arch, init_params
    from repro_torch.serve import (ContinuousScheduler, Engine, PagedEngine,
                                   ServeConfig)
    arch = get_arch("qwen3-0.6b")
    t0 = time.perf_counter()
    params = init_params(arch, torch.Generator(device=dev).manual_seed(0),
                         dev)
    torch.cuda.synchronize()
    print(f"[wide] (c) set-up {time.perf_counter() - t0:.1f}s: qwen3-0.6b "
          f"{arch.cfg.n_layers} layers bf16", flush=True)
    prompts = serve_prompts(np, arch.vocab_size)
    runs = (
        ("sampled top_k 100", 100, False, lambda: Engine(
            arch, params, ServeConfig(batch_size=8, max_len=512,
                                      temperature=0.8, top_k=100),
            device=dev), lambda s: [s.submit(p) for p in prompts], 32),
        ("beam 40 paged", 80, True, lambda: PagedEngine(
            arch, params, ServeConfig(batch_size=40, max_len=512,
                                      paged=True, block_size=16),
            device=dev), lambda s: [s.submit_beam(prompts[0], n_beams=40)],
         8),
        ("best-of 4 top_k 100", 100, True, lambda: Engine(
            arch, params, ServeConfig(batch_size=8, max_len=512, top_k=100),
            device=dev), lambda s: [s.submit_best_of(
                prompts[1], n=4, temperature=0.8, seed=3)], 16),
    )
    total = 0
    for tag, k, lse, make, submit, max_new in runs:
        calls = []
        undo = spy_topk(calls)
        reg, tracer = obs.enable(trace=True)
        try:
            eng = make()
            sched = ContinuousScheduler(eng, max_new_tokens=max_new)
            build.reset_counters()
            t0 = time.perf_counter()
            rids = submit(sched)
            results = sched.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = LAUNCHES.count
        finally:
            obs.disable()
            undo()
        steps = [x.duration * 1e3 for x in tracer.spans
                 if x.name == "engine.decode_step"]
        prefills = len(sched.admit_order)
        if launches != prefills + sched.decode_steps or \
                len(calls) != launches:
            raise AssertionError(f"(c) {tag}: {launches} sample_topk "
                                 f"launches, {len(calls)} calls, for "
                                 f"{prefills} prefills + "
                                 f"{sched.decode_steps} steps")
        if k == 100 and not lse:
            # the sampler takes k = 100 at prefill and decode alike
            ks = {c[2] for c in calls}
            if ks != {100}:
                raise AssertionError(f"(c) {tag}: top-k calls at k {ks}")
        worst = wide_topk_calls(torch, np, f"(c) {tag}", calls, arch, k, lse)
        toks = [np.asarray(results[r]) for r in rids]
        if not all(((o >= 0) & (o < arch.vocab_size)).all() for o in toks):
            raise AssertionError(f"(c) {tag}: an id outside the vocab")
        extra = ""
        if sched.hypotheses:
            hyp = sched.hypotheses[rids[0]]
            lps = [x.logp for x in hyp]
            want_n = 40 if "beam" in tag else 4
            if len(hyp) != want_n or lps != sorted(lps, reverse=True) or \
                    not np.all(np.isfinite(lps)):
                raise AssertionError(f"(c) {tag}: hypotheses {len(hyp)}, "
                                     f"logps {lps[:5]}...")
            extra = (f", {len(hyp)} hypotheses (best logp {lps[0]:.3f}), "
                     f"forks {sched.group_forks}")
        total += launches
        print(f"[wide] (c) {tag}: {len(rids)} request(s), "
              f"{sum(len(o) for o in toks)} tokens in {dt:.2f}s; "
              f"sample_topk launches {launches} = {prefills} prefills + "
              f"{sched.decode_steps} steps, every one at k {k} held to the "
              f"plain version on its hidden states (max |err| {worst:.3g})"
              f"{extra}; decode step {np.median(steps):.2f} ms p50 on {card}",
              flush=True)
        del eng, sched, calls
    del params
    return total


def phase_wide_cli(torch, np, card):
    """Phase 16 (d): the serve CLI at top_k 100 with the metrics report
    and a chrome trace, in a subprocess on the card."""
    workdir = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"),
                               prefix="wide_cli_")
    metrics = os.path.join(workdir, "metrics.json")
    trace = os.path.join(workdir, "trace.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "qwen3-0.6b", "--temperature", "0.8", "--top-k", "100",
           "--metrics-json", metrics, "--trace-out", trace]
    env = dict(os.environ, PYTHONPATH=SRC)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        dt = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"(d) the serve CLI exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        with open(metrics, encoding="utf-8") as f:
            report = json.load(f)
        with open(trace, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    finally:
        subprocess.run(["rm", "-rf", workdir], check=False)
    keys = {"schema", "enabled", "metrics", "mode", "arch"}
    if set(report) != keys or not report["enabled"] or \
            report["arch"] != "qwen3-0.6b":
        raise AssertionError(f"(d) metrics report keys {sorted(report)}")
    decodes = report["metrics"]["engine.decode_steps_total"]["value"]
    spans = [e for e in events if e["name"] == "engine.decode_step"]
    if not spans or decodes < 1:
        raise AssertionError(f"(d) {len(spans)} engine.decode_step spans, "
                             f"{decodes} decode steps counted")
    last = proc.stdout.strip().splitlines()
    print(f"[wide] (d) `{' '.join(cmd[2:])}` exited 0 in {dt:.1f}s: the "
          f"metrics report has the reference's keys {sorted(keys)} "
          f"({len(report['metrics'])} instruments, {decodes} decode steps), "
          f"the chrome trace {len(events)} spans, {len(spans)} of them "
          f"engine.decode_step; its summary: "
          f"{[ln for ln in last if 'served' in ln][:1]} on {card}",
          flush=True)


def phase_wide(torch, np, card, dev):
    """Phase 16: training past d 4096 (mistral-large-123b, qwen1.5-32b),
    serving past k 64, and the serve CLI's obs flags.  Returns the
    launches by kernel."""
    launches = {}
    for tag, arch_id in (("a", "mistral-large-123b"), ("b", "qwen1.5-32b")):
        for key, n in phase_wide_train(torch, np, arch_id, tag, card,
                                       dev).items():
            launches[key] = launches.get(key, 0) + n
        gc.collect()
        torch.cuda.empty_cache()
    launches["sample_topk"] = phase_wide_serve(torch, np, card, dev)
    gc.collect()
    torch.cuda.empty_cache()
    phase_wide_cli(torch, np, card)
    return launches


# phase 17: the tuned fused-CE forward's step-0 loss against the own
# plan's: a vocab split changes only the order of the slices' f32 merge
# (an lse of ~12 moves by a few f32 ulps); a wrong split (a slice skipped
# or read twice) moves it by ~1e-2 or more
TUNE_LOSS_RTOL = 1e-5
TUNE_K1_ROWS = (16, 32, 64, 128, 256)     # (a): where the top-1 kernels cross
TUNE_NEW = 16                             # (c): new tokens a request


def tune_sweep(tag, op, shape, dtype, own, cands, measure, check, cache,
               card, wdtype=None):
    """Phase 17 (a): one cold sweep through the tuner's own loop
    (`autotune_cached` over `run_plan_trials`, every candidate timed, the
    winner memoized in `cache`); each candidate is then held to the
    plain version by ``check(plan) -> max |err|``.  Prints every
    candidate's time, the own plan's and the winner's; returns {"own_ms",
    "best", "best_ms", "trials": [(plan, ms, err)]}."""
    from repro_torch.kernels import plan_tuner as PT
    got = {}

    def run():
        got["res"] = PT.run_plan_trials(measure, cands, own, trial_budget=0,
                                        tag=tag + " ")
        return got["res"]

    n, v, d = shape
    best = PT.autotune_cached(op, run, n, v, d, dtype, own, device="cuda",
                              cache=cache, trial_budget=len(cands) + 1,
                              wdtype=wdtype)
    res = got.get("res")
    if res is None:
        raise AssertionError(f"(a) {tag}: the cold cache already held it")
    if best != res.best or not res.best_us <= res.heuristic_us < 1e30:
        raise AssertionError(f"(a) {tag}: winner {best} at {res.best_us} us"
                             f", own {res.heuristic_us} us")
    trials = [(plan, us / 1e3, check(plan)) for plan, us in res.trials]
    print(f"[tune] (a) {tag}: own {own.shape} {res.heuristic_us / 1e3:.4f} "
          f"ms, winner {best.shape} {res.best_us / 1e3:.4f} ms (own / "
          f"winner {res.heuristic_us / res.best_us:.3f}) of {len(trials)} "
          f"plans on {card}; " + ", ".join(
              f"{p.shape} {ms:.4f} ms err {e:.2g}" for p, ms, e in trials),
          flush=True)
    return {"own_ms": res.heuristic_us / 1e3, "best": best,
            "best_ms": res.best_us / 1e3, "trials": trials}


def phase_tune_kernels(torch, np, arch, card, dev, cache):
    """Phase 17 (a): the tuner's cold sweeps at the slice's shapes, each
    candidate held to its plain version.  Returns the sweeps by tag."""
    from repro_torch.core.windows import choose_ce_plan
    from repro_torch.kernels import plan_tuner as PT
    from repro_torch.kernels.fused_ce import autotune as CEA
    from repro_torch.kernels.fused_ce import fwd_stats, ref_stats
    from repro_torch.kernels.paged_attn import autotune as PAA
    from repro_torch.kernels.paged_attn import (paged_attention,
                                                paged_attention_ref)
    from repro_torch.kernels.sample_topk import autotune as TKA
    from repro_torch.kernels.sample_topk import (default_plan, topk_scores,
                                                 topk_scores_ref)
    from repro_torch.kernels.score_tokens import autotune as SCA
    from repro_torch.kernels.score_tokens import kernel as SK
    from repro_torch.kernels.score_tokens import (score_stats,
                                                  score_stats_ref)
    from repro_torch.models.attention import quantize_kv

    v, d, valid = arch.padded_vocab, arch.cfg.d_model, arch.vocab_size
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(17)
    h_all = torch.randn((max(TUNE_K1_ROWS), d), generator=gen,
                        device=dev).to(bf16)
    w = (torch.randn((v, d), generator=gen, device=dev) / d ** 0.5).to(bf16)
    out = {}

    def topk_sweep(rows, k):
        h = h_all[:rows].contiguous()
        ext = topk_scores_ref(h, w, k + 1, valid_vocab=valid)

        def check(plan):
            vals, ids = topk_scores(h, w, k, plan=plan, valid_vocab=valid)
            return check_topk_wide(np, vals, ids, *ext)[0]

        return tune_sweep(
            f"topk{k} {rows} rows", f"topk{k}", (rows, v, d), bf16,
            default_plan(rows, v, k), TKA.candidate_plans(rows, v, k),
            lambda plan: TKA.measure_topk_plan(h, w, k, plan), check, cache,
            card)

    for k in (1, 40, 100):
        out[f"topk{k}_rows8"] = topk_sweep(8, k)
    cross = []
    for rows in TUNE_K1_ROWS:
        r = out[f"topk1_rows{rows}"] = topk_sweep(rows, 1)
        many = [ms for p, ms, _ in r["trials"] if p.block_rows == 128]
        dec = min((ms, p.shape) for p, ms, _ in r["trials"]
                  if p.block_rows != 128)
        cross.append((rows, dec, many[0]))
    for rows, dec, many in [(8, min((ms, p.shape) for p, ms, _ in
                                    out["topk1_rows8"]["trials"]
                                    if p.block_rows != 128),
                             [ms for p, ms, _ in out["topk1_rows8"]["trials"]
                              if p.block_rows == 128][0])] + cross:
        print(f"[tune] (a) k 1 at {rows} rows: the decode kernel's best "
              f"{dec[1]} {dec[0]:.4f} ms, the many-row kernel "
              f"{many:.4f} ms: {'many-row' if many < dec[0] else 'decode'}"
              f" wins ({dec[0] / many:.3f})", flush=True)
    out["k1_cross"] = cross

    h = h_all[:32].contiguous()
    ids = torch.randint(0, valid, (32, 1), generator=gen, device=dev,
                        dtype=torch.int32)
    rl, rz = score_stats_ref(h, w, ids, valid_vocab=valid, temperature=0.7)

    def check_score(plan):
        lse, zc = score_stats(h, w, ids, plan=plan, valid_vocab=valid,
                              temperature=0.7)
        torch.testing.assert_close(lse, rl, rtol=VAL_RTOL, atol=VAL_ATOL)
        torch.testing.assert_close(zc, rz, rtol=VAL_RTOL, atol=VAL_ATOL)
        return float(max((lse - rl).abs().max(), (zc - rz).abs().max()))

    out["score1_rows32"] = tune_sweep(
        "score1 32 rows", "score1", (32, v, d), bf16, SK.own_plan(32, v, 1),
        SCA.candidate_plans(32, v, 1),
        lambda plan: SCA.measure_score_plan(h, w, ids, plan), check_score,
        cache, card)

    b, nq, nkv, hd, bs, nb = 8, 16, 8, 128, 16, 32     # phase 5's decode
    q = torch.randn((b, 1, nq, hd), generator=gen, device=dev).to(bf16)
    table = (1 + torch.randperm(b * nb, generator=gen, device=dev)).reshape(
        b, nb).to(torch.int32)
    lens = torch.randint(nb * bs // 2, nb * bs + 1, (b,), generator=gen,
                         device=dev, dtype=torch.int32)
    for quant in (False, True):
        kp = torch.randn((b * nb + 1, bs, nkv, hd), generator=gen,
                         device=dev)
        vp = torch.randn((b * nb + 1, bs, nkv, hd), generator=gen,
                         device=dev)
        kw = {}
        if quant:
            kp, kw["kp_scale"] = quantize_kv(kp)
            vp, kw["vp_scale"] = quantize_kv(vp)
        else:
            kp, vp = kp.to(bf16), vp.to(bf16)
        ref = paged_attention_ref(q, kp, vp, table, lens, **kw).float()

        def call(plan, kp=kp, vp=vp, kw=kw):
            return paged_attention(
                q, kp, vp, table, lens, tile_keys=plan.block_rows,
                pages_per_step=PAA.plan_pages_per_step(plan, bs, nb), **kw)

        def check_paged(plan, ref=ref, call=call):
            got = call(plan).float()
            torch.testing.assert_close(got, ref, atol=PAGED_ATOL,
                                       rtol=PAGED_RTOL)
            return float((got - ref).abs().max())

        tag = "pattn16" + (" int8" if quant else "")
        out[tag] = tune_sweep(
            f"{tag} B {b} 32 pages", "pattn16", (b, nb * bs, nkv * hd), bf16,
            PAA.own_plan(b, 1, nq, nkv, hd, nb, bs, quant),
            PAA.candidate_plans(b, 1, nq, nkv, hd, nb, bs, quant),
            lambda plan, call=call: PT.measure_us(lambda: call(plan), 2, dev),
            check_paged, cache, card, wdtype="int8" if quant else None)
        del kp, vp

    n = TRAIN_BATCH * TRAIN_SEQ
    hc = torch.randn((n, d), generator=gen, device=dev).to(bf16)
    y = torch.randint(0, valid, (n,), generator=gen, device=dev)
    cfg = arch.loss_config()
    want = ref_stats(hc, w, y, cfg)

    def check_ce(plan):
        lse, zt, zs = fwd_stats(hc, w, y, cfg, plan=CEA.as_ce_plan(plan, v))
        torch.testing.assert_close(lse, want[0], rtol=VAL_RTOL,
                                   atol=VAL_ATOL)
        torch.testing.assert_close(zt, want[1], rtol=VAL_RTOL,
                                   atol=VAL_ATOL)
        torch.testing.assert_close(zs, want[2], rtol=0, atol=CE_ZSUM_ATOL)
        return float((lse - want[0]).abs().max())

    out["ce_rows8192"] = tune_sweep(
        f"ce {n} rows", "ce", (n, v, d), bf16,
        CEA.as_block_plan(choose_ce_plan(n, v, d), v),
        CEA.candidate_plans(n, v),
        lambda plan: CEA.measure_plan(hc, w, y, cfg, CEA.as_ce_plan(plan, v)),
        check_ce, cache, card)
    del want, hc, w, h_all
    return out


def tune_serve_cli(torch, np, build, obs, argv):
    """Phase 17 (b): one in-process run of the serve CLI under a fresh
    registry, the launch counters zeroed just before: (tokens, sweeps,
    launches, seconds)."""
    from repro_torch.launch import serve as serve_cli
    build.reset_counters()
    t0 = time.perf_counter()
    with obs.capture(trace=False) as (reg, _):
        out = serve_cli.main(argv)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    m = reg.metrics().get("tune.sweeps_total")
    launches = {k: c.count for k, c in build.COUNTERS.items() if c.count}
    return np.asarray(out), (0 if m is None else int(m.value)), launches, dt


def tune_tokens(torch, np, tag, arch, params, prompts, got, want, dev):
    """The tuned run's tokens against the untuned run's: equal, or every
    request that differs within GREEDY_TOL of a cache-free forward's best
    logit (bf16 near-ties under another reduction order)."""
    diff = [i for i, (g, w) in enumerate(zip(got, want))
            if not np.array_equal(g, w)]
    if not diff:
        return f"all {len(got)} requests token for token the untuned run's"
    worst, _ = best_logit_deficit(torch, np, arch, params,
                                  [prompts[i] for i in diff],
                                  [got[i] for i in diff], dev)
    if worst > GREEDY_TOL:
        raise AssertionError(f"{tag}: requests {diff} differ from the "
                             f"untuned run and trail a cache-free forward's "
                             f"best logit by {worst:.3g} > {GREEDY_TOL}")
    return (f"{len(got) - len(diff)} of {len(got)} requests token for token "
            f"the untuned run's, the other {len(diff)} within {worst:.3g} "
            f"of a cache-free forward's best logit (limit {GREEDY_TOL})")


def phase_tune(torch, np, card, dev):
    """Phase 17: the autotuner and its cache at full width.  Returns the
    launches of (b) to (d) by kernel, sweeps included."""
    from repro_torch import obs
    from repro_torch.configs import with_mtp
    from repro_torch.kernels import build
    from repro_torch.launch import train as train_cli
    from repro_torch.models.registry import get_arch, init_params
    from repro_torch.serve import (PagedEngine, SelfSpecEngine, ServeConfig,
                                   SpecConfig)
    from repro_torch.tuning import TuningCache, get_cache
    from repro_torch.tuning.cache import RESOLVED

    arch = get_arch("qwen3-0.6b")
    launches = {}

    def add(counts):
        for key, n in counts.items():
            launches[key] = launches.get(key, 0) + n

    workdir = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"),
                               prefix="tune_smoke_")
    path = os.path.join(workdir, "blockplans.json")
    saved = os.environ.get("REPRO_TUNING_CACHE")

    def use(cache_path):
        """The default cache from here on: `path`, or an empty in-memory
        one ("") for the untuned runs, whose launches then take the
        kernels' own plans; no earlier resolution survives."""
        os.environ["REPRO_TUNING_CACHE"] = cache_path
        RESOLVED.clear()

    use(path)
    try:
        t0 = time.perf_counter()
        sweeps = phase_tune_kernels(torch, np, arch, card, dev,
                                    get_cache(path))
        keys = sorted(json.load(open(path, encoding="utf-8"))["entries"])
        print(f"[tune] (a) {len(keys)} keys in the cache after the sweeps "
              f"({time.perf_counter() - t0:.1f}s): {keys}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the serve CLI, untuned, then tuned twice on the same cache
        argv = ["--arch", "qwen3-0.6b", "--batch", "8", "--requests", "16",
                "--prompt-len", "128", "--max-new", "32", "--max-len", "512"]
        use("")
        plain, _, _, dt0 = tune_serve_cli(torch, np, build, obs, argv)
        use(path)
        cold, cold_sweeps, counts, dt1 = tune_serve_cli(
            torch, np, build, obs, argv + ["--autotune"])
        add(counts)
        use(path)
        warm, warm_sweeps, counts, dt2 = tune_serve_cli(
            torch, np, build, obs, argv + ["--autotune"])
        add(counts)
        if cold_sweeps < 1 or warm_sweeps != 0:
            raise AssertionError(f"(b) sweeps cold {cold_sweeps}, warm "
                                 f"{warm_sweeps}: want >= 1 and 0")
        if not (np.array_equal(cold, plain) and np.array_equal(warm, plain)):
            raise AssertionError("(b) the autotuned CLI served other greedy "
                                 "tokens than the untuned one")
        print(f"[tune] (b) the serve CLI `{' '.join(argv)} --autotune`: "
              f"cold {cold_sweeps} sweeps in {dt1:.1f}s, warm {warm_sweeps} "
              f"in {dt2:.1f}s (untuned {dt0:.1f}s); all {cold.size} greedy "
              f"tokens of both equal to the untuned run's on {card}",
              flush=True)

        # (c) paged and greedy self-speculative engines, tuned vs not
        params = init_params(arch, torch.Generator(device=dev).manual_seed(
            0), dev)
        prompts = shared_prompts(np, arch.vocab_size)
        rows = {}
        for tune in (False, True):
            use(path if tune else "")
            sc = ServeConfig(batch_size=8, max_len=512, paged=True,
                             block_size=16, autotune=tune)
            eng, sched, results, rids, dt, counts, _, tracer = counted_run(
                torch, np, lambda sc=sc: PagedEngine(arch, params, sc,
                                                     device=dev),
                lambda s: [s.submit(p) for p in prompts], build, obs,
                max_new=TUNE_NEW)
            steps = sched.decode_steps
            topk = counts.get("sample_topk", 0) + counts.get(
                "sample_topk_rows", 0)
            if (topk != len(sched.admit_order) + steps
                    or counts.get("paged_attn") != steps
                    * arch.cfg.n_layers):
                raise AssertionError(f"(c) paged launches {counts}, "
                                     f"{steps} steps")
            rows[tune] = ([np.asarray(results[r]) for r in rids], dt,
                          sum(s.name == "tune.sweep" for s in tracer.spans))
            if tune:
                add(counts)
            del eng, sched
        verdict = tune_tokens(torch, np, "(c) paged", arch, params, prompts,
                              rows[True][0], rows[False][0], dev)
        print(f"[tune] (c) PagedEngine autotune=True on phase 5's traffic "
              f"({TUNE_NEW} new tokens): {rows[True][2]} sweeps at "
              f"construction (the sweeps of (a) and (b) in the cache), "
              f"{rows[True][1]:.2f}s against {rows[False][1]:.2f}s untuned;"
              f" {verdict} on {card}", flush=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        march = with_mtp(arch, SPEC_K)
        mparams = init_params(march, torch.Generator(
            device=dev).manual_seed(0), dev)
        prompts = serve_prompts(np, arch.vocab_size)
        for tune in (False, True):
            use(path if tune else "")
            sc = ServeConfig(batch_size=8, max_len=512, autotune=tune)
            eng, sched, results, rids, dt, counts, _, tracer = counted_run(
                torch, np, lambda sc=sc: SelfSpecEngine(
                    march, mparams, sc, SpecConfig(k=SPEC_K), device=dev),
                lambda s: [s.submit(p) for p in prompts], build, obs,
                max_new=TUNE_NEW)
            if counts.get("score_tokens"):
                raise AssertionError(f"(c) greedy self-spec scored: {counts}")
            rows[tune] = ([np.asarray(results[r]) for r in rids], dt,
                          sum(s.name == "tune.sweep" for s in tracer.spans))
            if tune:
                add(counts)
            del eng, sched
        verdict = tune_tokens(torch, np, "(c) self-spec", march, mparams,
                              prompts, rows[True][0], rows[False][0], dev)
        print(f"[tune] (c) SelfSpecEngine (4 MTP heads, k {SPEC_K}, greedy)"
              f" autotune=True on phase 3's traffic: {rows[True][2]} sweeps "
              f"(the verify rows {8 * (SPEC_K + 1)} and the redraft rows "
              f"{8 * SPEC_K}), {rows[True][1]:.2f}s against "
              f"{rows[False][1]:.2f}s untuned; {verdict} on {card}",
              flush=True)
        del mparams
        gc.collect()
        torch.cuda.empty_cache()

        # (d) the train CLI: step 0 untuned, then 3 steps tuned
        flags = ["--arch", "qwen3-0.6b", "--loss-impl", "kernel",
                 "--global-batch", str(TRAIN_BATCH), "--seq-len",
                 str(TRAIN_SEQ), "--log-every", "1"]
        use("")
        state, plain_hist = train_cli.main(flags + ["--steps", "1"])
        del state
        gc.collect()
        torch.cuda.empty_cache()
        use(path)
        train_cache = os.path.join(workdir, "train_plans.json")
        build.reset_counters()
        with obs.capture(trace=False) as (reg, _):
            state, hist = train_cli.main(flags + [
                "--steps", "3", "--autotune", "--tuning-cache",
                train_cache])
            torch.cuda.synchronize()
        counts = {k: c.count for k, c in build.COUNTERS.items() if c.count}
        add(counts)
        del state
        m = reg.metrics().get("tune.sweeps_total")
        entries = TuningCache(train_cache)
        key = f"{TRAIN_BATCH * TRAIN_SEQ}x{arch.padded_vocab}x" \
            f"{arch.cfg.d_model}:bfloat16:cuda"
        l0, t0_loss = plain_hist[0][1]["loss"], hist[0][1]["loss"]
        if (m is None or m.value != 1 or entries.get(key) is None
                or len(entries) != 1):
            raise AssertionError(f"(d) sweeps {m and m.value}, cache "
                                 f"{train_cache} without {key}")
        if not abs(t0_loss - l0) <= TUNE_LOSS_RTOL * abs(l0):
            raise AssertionError(f"(d) step 0 loss {t0_loss} tuned, {l0} "
                                 f"untuned (rtol {TUNE_LOSS_RTOL})")
        if counts.get("fused_ce_dh") != 3 or counts.get("fused_ce_dw") != 3:
            raise AssertionError(f"(d) launches {counts}")
        plan = entries.get(key)
        print(f"[tune] (d) the train CLI `--autotune --tuning-cache` (3 "
              f"steps, {TRAIN_BATCH} x {TRAIN_SEQ}): 1 sweep, key {key} -> "
              f"{plan.shape} ({-(-arch.padded_vocab // plan.block_v)} "
              f"vocab slices); step 0 loss {t0_loss:.6f} against "
              f"{l0:.6f} untuned (|diff| {abs(t0_loss - l0):.3g}, limit "
              f"rtol {TUNE_LOSS_RTOL}); losses "
              f"{[round(mm['loss'], 4) for _, mm in hist]}; launches "
              f"{counts} on {card}", flush=True)
    finally:
        RESOLVED.clear()
        if saved is None:
            os.environ.pop("REPRO_TUNING_CACHE", None)
        else:
            os.environ["REPRO_TUNING_CACHE"] = saved
        subprocess.run(["rm", "-rf", workdir], check=False)
    print(f"[tune] {len(sweeps) - 1} cold sweeps in (a); the cache under "
          f"build/ removed", flush=True)
    return launches


# phase 18: the full-width entries' findings left open (ROADMAP.md §C
# "Open", with their text): an entry listed here must report exactly
# these rules, every other entry none
ANALYZE_OPEN_FULL = {}
# the bf16 (rows, V) logits of the training step, 8192 x 152064 x 2 bytes:
# the fused step's largest block must stay below it, the canonical one's
# reach it
TRAIN_LOGITS_BYTES = TRAIN_BATCH * TRAIN_SEQ * 152064 * 2


def analyze_rows_check(report):
    """Phase 18 (a)'s checks over the reduced matrix's report: each
    kernel's launches equal the scopes it entered; the transformer's hot
    paths launch; the train steps' backward ops are recorded in their
    scopes (autograd runs them on its device thread)."""
    bad = []
    for r in report["entries"]:
        for k in set(r["scopes"]) | set(r["launches"]):
            if r["scopes"].get(k, 0) != r["launches"].get(k, 0):
                bad.append(f"{r['entry']}: {k} scopes "
                           f"{r['scopes'].get(k, 0)} != launches "
                           f"{r['launches'].get(k, 0)}")
        hot = r["expect"] == "clean" and r["entry"] != "kernels/ast"
        if hot and r["entry"].startswith("transformer/") and not sum(
                r["launches"].values()):
            bad.append(f"{r['entry']}: no kernel launched")
        if r["entry"].endswith(("/train_exact", "/train_filtered")):
            for k in r["launches"]:
                if "_dh" in k or "_dw" in k:
                    if not r["kernel_ops"].get(k):
                        bad.append(f"{r['entry']}: no op recorded in the "
                                   f"{k} scope (backward not recorded)")
    return bad


def phase_analyze(torch, np, card, dev):
    """Phase 18: the static analysis on the card.  (a) the reduced
    matrix (`launch/analyze.py`, 36 entries) with every launch scoped;
    (b) qwen3-0.6b at full width on phases 3, 5, 6, 7 and 11's serving
    shapes and phase 4's training step, every rule, no finding but the
    listed open ones, and both fixtures flagged; (c) the allocator's
    largest block in the fused and the canonical training steps."""
    from repro_torch import obs
    from repro_torch.analysis.lint import RuleContext, run_rules
    from repro_torch.analysis.trace import memory_dict
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import build
    from repro_torch.kernels.score_tokens import score_tokens
    from repro_torch.launch import analyze as A
    from repro_torch.models.registry import (get_arch, init_params,
                                             init_serve_caches)
    from repro_torch.serve import Engine, PagedEngine, ServeConfig
    from repro_torch.train import TrainConfig, build_train_step

    t0 = time.perf_counter()
    build.reset_counters()
    with obs.capture(trace=False):
        report = A.analyze(device=dev, progress=lambda *a: None)
    total = {k: c.count for k, c in build.COUNTERS.items() if c.count}
    t = report["totals"]
    bad = analyze_rows_check(report)
    for r in report["entries"]:
        if not r["ok"]:
            bad.append(f"{r['entry']} ({r['expect']}): "
                       + "; ".join(f"{f['rule']}: {f['message']} at "
                                   f"{f['where']}" for f in r["findings"]))
    # ROADMAP §C 2, repaired: the xlstm decode step donates its state
    xl = [r for r in report["entries"] if r["entry"] == "xlstm/decode_slab"]
    if not xl or xl[0]["findings"]:
        bad.append(f"xlstm/decode_slab not clean: {xl}")
    if t["violations"] or t["suppressed"] or t["entries"] != 36 or bad:
        raise AssertionError("phase 18 (a): " + "\n".join(bad))
    n_open = sum(len(r["open"]) for r in report["entries"])
    print(f"[analyze] (a) {t['entries']} entries x {t['rules']} rules on "
          f"the card in {time.perf_counter() - t0:.1f}s: {t['findings']} "
          f"finding(s) ({n_open} open, ROADMAP §C; the rest the two "
          f"fixtures'), 0 suppressed; every launch scoped: "
          f"{sum(total.values())} launches {dict(sorted(total.items()))}",
          flush=True)

    # (b) full width
    t1 = time.perf_counter()
    arch = get_arch("qwen3-0.6b")
    vocabs = (arch.vocab_size, arch.padded_vocab)
    params = init_params(arch, torch.Generator(device=dev).manual_seed(0),
                         dev)
    rows = []
    mark = [time.perf_counter()]

    def check(entry, rec, batch, seq=None, donate=None, expect="clean"):
        graph, fn_graph, launches = rec
        ctx = RuleContext(entry=entry, graph=graph, fn_graph=fn_graph,
                          batch=batch, vocabs=vocabs, seq=seq,
                          expect_donation=donate)
        findings, _ = run_rules(ctx)
        for k in set(graph.scopes) | set(launches):
            if graph.scopes.get(k, 0) != launches.get(k, 0):
                raise AssertionError(f"phase 18 (b) {entry}: {k} scopes "
                                     f"{graph.scopes.get(k, 0)} != "
                                     f"launches {launches.get(k, 0)}")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        rules = sorted({f.rule for f in findings})
        for f in findings[:12]:
            print(f"[analyze] (b) {entry} {f.rule}: {f.message} at "
                  f"{f.where}")
        ok = (bool(findings) if expect == "flagged" else
              rules == sorted(ANALYZE_OPEN_FULL.get(entry, ())))
        rows.append((entry, expect, len(findings), rules, len(graph),
                     launches, ok))
        now = time.perf_counter()
        print(f"[analyze] (b) {entry}: {expect}, {len(findings)} "
              f"finding(s) {rules}, {len(graph)} ops, launches "
              f"{dict(sorted(launches.items()))}, {now - mark[0]:.1f}s "
              f"(set-up, recorded run, rules){'' if ok else '  VIOLATION'}",
              flush=True)
        mark[0] = now

    def prefilled(eng, prompts):
        for slot, p in enumerate(prompts):
            eng.prefill_into_slot(slot, p)
        return eng

    sc = ServeConfig(batch_size=8, max_len=512)
    eng = prefilled(Engine(arch, params, sc, device=dev),
                    serve_prompts(np, arch.vocab_size)[:8])
    check("transformer/decode_slab", A.run_entry(eng.decode_step), 8,
          donate=1)
    eng.reset_slot(0)
    prompt = serve_prompts(np, arch.vocab_size)[8][:128]
    cont = np.arange(1, 9, dtype=np.int32)
    check("transformer/eval_score",
          A.run_entry(eng.score_in_slot, 0, prompt, cont), 1, seq=8)
    del eng
    psc = ServeConfig(batch_size=8, max_len=512, paged=True, block_size=16)
    peng = prefilled(PagedEngine(arch, params, psc, device=dev),
                     shared_prompts(np, arch.vocab_size)[:8])
    check("transformer/decode_paged", A.run_entry(peng.decode_step), 8,
          donate=1)
    del peng
    rows_v = 8 * (SPEC_K + 1)
    g = torch.Generator(device=dev).manual_seed(6)
    hs = torch.randn((rows_v, arch.cfg.d_model), generator=g, device=dev,
                     dtype=torch.bfloat16)
    ids = torch.randint(0, arch.vocab_size, (rows_v,), generator=g,
                        device=dev, dtype=torch.int32)
    check("transformer/spec_verify", A.run_entry(
        lambda: score_tokens(hs, params["lm_head"], ids,
                             valid_vocab=arch.vocab_size)), 8,
          seq=SPEC_K + 1)
    qsc = ServeConfig(batch_size=8, max_len=512, paged=True, block_size=16,
                      quantize_cache=True, head_dtype="int8")
    qeng = prefilled(PagedEngine(arch, params, qsc, device=dev),
                     shared_prompts(np, arch.vocab_size)[:8])
    check("transformer/decode_quant", A.run_entry(qeng.decode_step), 8,
          donate=1)
    del qeng
    caches = init_serve_caches(arch, 8, 512, device=dev)
    cur = torch.zeros((8, 1), dtype=torch.int64, device=dev)
    with torch.no_grad():
        check("transformer/fixture_dense_sampler", A.run_entry(
            A.dense_decode(arch), params, caches, cur), 8,
            expect="flagged")
    del caches, params
    gc.collect()
    torch.cuda.empty_cache()

    # phase 4's training step, fused and canonical (c: the allocator)
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size,
                                  seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0))
    batch = to_device(data.batch(0), dev)
    mem = {}
    state = None
    for entry, impl, expect in (
            ("transformer/train_exact", "kernel", "clean"),
            ("transformer/fixture_canonical_loss", "canonical",
             "flagged")):
        tc = TrainConfig(peak_lr=3e-3, warmup_steps=1,
                         total_steps=TRAIN_STEPS, loss_impl=impl,
                         loss_block_v=min(2048, arch.padded_vocab))
        init_fn, step_fn = build_train_step(arch, tc)
        if state is None:
            state = init_fn(torch.Generator(device=dev).manual_seed(0),
                            dev)
        rec, mem[impl] = memory_dict(A.run_entry, step_fn, state, batch,
                                     device=dev)
        check(entry, rec, TRAIN_BATCH, seq=TRAIN_SEQ, donate=1,
              expect=expect)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    viol = [r[0] for r in rows if not r[6]]
    if viol:
        raise AssertionError(f"phase 18 (b): violations {viol} (open "
                             f"findings allowed: {ANALYZE_OPEN_FULL})")
    print(f"[analyze] (b) qwen3-0.6b full width: {len(rows)} entries in "
          f"{time.perf_counter() - t1:.1f}s, hot paths clean but for "
          f"{sum(len(v) for v in ANALYZE_OPEN_FULL.values())} open "
          f"rule(s), fixtures flagged", flush=True)

    fused, canon = mem["kernel"], mem["canonical"]
    print(f"[analyze] (c) training step 8 x 1024 on {card}: largest block "
          f"fused {fused['largest_alloc_bytes'] / 2**20:.1f} MiB "
          f"(peak +{fused['peak_bytes'] / 2**30:.3f} GiB, "
          f"{fused['allocs']} allocations), canonical "
          f"{canon['largest_alloc_bytes'] / 2**20:.1f} MiB (peak "
          f"+{canon['peak_bytes'] / 2**30:.3f} GiB); bf16 logits "
          f"{TRAIN_LOGITS_BYTES / 2**20:.1f} MiB", flush=True)
    if not fused["largest_alloc_bytes"] < TRAIN_LOGITS_BYTES:
        raise AssertionError("phase 18 (c): the fused step allocated a "
                             "block of the logits' size")
    if not canon["largest_alloc_bytes"] >= TRAIN_LOGITS_BYTES:
        raise AssertionError("phase 18 (c): the canonical step's largest "
                             "block is below the logits' bytes: the "
                             "allocator reading misses them")
    print(f"[analyze] phase 18 in {time.perf_counter() - t0:.1f}s",
          flush=True)
    return total


# phase 19: the paper's distributed fused loss on a (data 2, model 2)
# world of 4 ranks that share the one card over gloo.  (a) compares each
# rank's loss, dH rows and dW vocab slice with one process's kernel loss
# over the whole head on the same inputs: the loss is f32 and moves only
# by the order of the lse combine (rtol 1e-5); dH and dW are bf16, each
# one rounding of an f32 sum taken in another order (two partial panels
# summed across ranks against one kernel over the whole vocab or every
# row), so an entry may land one bf16 step away: 2^-7 relative (one ulp
# at the bottom of a binade).  An entry whose sum cancels to near zero
# has no relative bound (the f32 orders differ by ~1e-7 of the terms'
# magnitude, not the result's), so each entry may also be off by 2^-12
# of its block's largest entry; and a relative Frobenius error of 1e-3.
DIST_MESH = (2, 2)
DIST_VOCAB, DIST_VALID, DIST_D = 152064, 151936, 1024
DIST_EPS = 1.0          # far above every target-free 64 x 64 tile's bound
DIST_LOSS_RTOL = 1e-5
DIST_GRAD_RTOL, DIST_GRAD_ATOL_MAX, DIST_GRAD_FRO = 2.0 ** -7, 2.0 ** -12, 1e-3
# (b) the train CLI on the mesh against one rank on the same seed and
# batches, at DIST_LAYERS layers (the readings below are the 28 layers'
# where not said; at 4 layers the H100 read the last loss within 1.7e-6,
# grad norms within 5.2e-4, the body together 1.6e-2, a leaf 0.15 at
# most, the loss moving 1.8e-2 at the last step).  Step 0 has lr 0 (one
# warmup step), so the loss moves only at the last step, by 3.7e-4 of
# itself at 28 layers: the gates that see the gradient
# sync are the grad norm of every step (summed grads and the global norm
# over one vocab-sharded head; a rank that summed nothing over data
# reads its half batch's norm, 0.2-0.5 off in a mutation check on the
# CPU) and the params after the steps, their distance from the one
# rank's taken relative to the one rank's own update (1 where a rank's
# update did nothing, above 1 for unsynced leaves in that check): the
# body's leaves together and the lm_head's rows within DIST_PARAM_RTOL,
# each body leaf within DIST_PARAM_LEAF.  Step 0's loss differs only by
# the body's bf16 GEMMs at half the rows and the lse combine (the H100
# read 0); the bf16 grads summed across data ranks in another order move
# the last loss by a few bf16 roundings (read 1.4e-5, against 3.7e-4 for
# one update) and the grad norms by 2e-5 before the first update, 1.2e-3
# after it; a norm scale near 1, where one bf16 step (2^-8) is as large
# as the update, reads up to 0.17 where the two updates round apart
# (PERF.md has the readings)
DIST_STEP0_RTOL, DIST_LAST_RTOL = 1e-4, 1e-4
DIST_GNORM_RTOL, DIST_PARAM_RTOL, DIST_PARAM_LEAF = 1e-2, 0.05, 0.5
DIST_GATES = {"step0": DIST_STEP0_RTOL, "last": DIST_LAST_RTOL,
              "gnorm": DIST_GNORM_RTOL, "gnorm_updated": DIST_GNORM_RTOL,
              "param": DIST_PARAM_RTOL, "leaf": DIST_PARAM_LEAF}
DIST_STEPS = 3
DIST_LAYERS = 4         # (b), (e) and (g): 4 of qwen3-0.6b's 28 layers,
                        # as gloo's host copies of the grads set a step's
                        # time
# (b) and (g) run the body as Megatron tensor parallelism over model
# (attention by heads and KV heads, the MLP by ffn, one all-reduce of the
# (4096, 1024) bf16 rows a region and direction under 'sharded', an
# all-gather and a reduce-scatter under 'sharded_sp'); (g) trains with
# Adafactor (the train CLI's --optimizer adafactor: its factored moments
# summed over model where a cut dim is averaged) under (b)'s gates, and
# checks that each rank holds 1/M of DIST_TP_LEAVES and their slots'
# specs' shapes


def _grad_errs(torch, got, want):
    """(max abs error, relative Frobenius error, whether every entry is
    within DIST_GRAD_RTOL of its reference or DIST_GRAD_ATOL_MAX of the
    block's largest entry) of a bf16 gradient block."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    fro = float(diff.norm() / w.norm().clamp_min(1e-30))
    atol = DIST_GRAD_ATOL_MAX * float(w.abs().max())
    ok = bool((diff <= DIST_GRAD_RTOL * w.abs() + atol).all())
    return float(diff.max()), fro, ok


class MeshShape:
    """The shape of a mesh, without a world: what `sharding.rules` and
    `TrainLayout` read to lay out a tree."""

    def __init__(self, shape, axis_names=("data", "model")):
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = tuple(axis_names)


def _update_norms(torch, arch, params, init, world):
    """{leaf: [|p - init|]} (Frobenius, f32) of one process's update from
    the seeded init (`init`, {path: tensor}, emptied leaf by leaf); for a
    leaf that the `TrainLayout` of a (data, model) = `world` mesh cuts,
    one norm a model block."""
    from repro_torch.models.registry import init_params
    from repro_torch.optim.tree import leaves_with_paths
    from repro_torch.train import TrainLayout
    lay = TrainLayout(arch, MeshShape(world),
                      init_params(arch, torch.Generator(), "meta"))
    out = {}
    with torch.no_grad():
        for path, p in leaves_with_paths(params):
            d = p.detach().float() - init.pop(path).float()
            out["/".join(map(str, path))] = (
                [float(b.norm()) for b in d.chunk(
                    world[1], list(lay.specs[path]).index("model"))]
                if path in lay.specs else [float(d.norm())])
            del d
    return out


def _param_errs(torch, params, ref, upd, model):
    """{leaf: (|p - ref|, |ref - init|, share)} (Frobenius, f32) of this
    rank's params after the steps against one process's (`ref`, by leaf
    name) and that process's update (`upd`, from `_update_norms`), and
    the share of entries off by more than the update's rms; a leaf the
    layout cuts (the lm_head's vocab rows, the embedding table's columns,
    an MoE layer's experts) on this rank's block, `model` its model
    index."""
    from repro_torch.optim.tree import leaves_with_paths
    out = {}
    with torch.no_grad():
        for path, p in leaves_with_paths(params):
            name = "/".join(map(str, path))
            r, u = ref[name], upd[name]
            if tuple(r.shape) != tuple(p.shape):          # a cut leaf
                dim = [a != b for a, b in zip(r.shape, p.shape)].index(True)
                r = r.narrow(dim, model * p.shape[dim], p.shape[dim])
                u = u[model:]
            diff = (p.detach().float() - r.to(p.device).float()).abs()
            rms = u[0] / diff.numel() ** 0.5
            out[name] = (float(diff.norm()), u[0],
                         float((diff > rms).float().mean()))
            del r, diff
    return out


def _param_ratios(errs):
    """(the lm_head rows', the body's together, {body leaf: its own})
    |p - one rank's| / one rank's update, from `_param_errs`."""
    def ratio(err, upd):
        return err / upd if upd else (0.0 if err == 0 else float("inf"))
    body = {k: e for k, e in errs.items() if k != "lm_head"}
    whole = ratio(sum(e[0] ** 2 for e in body.values()) ** 0.5,
                  sum(e[1] ** 2 for e in body.values()) ** 0.5)
    return (ratio(*errs["lm_head"][:2]), whole,
            {k: ratio(*e[:2]) for k, e in body.items()})


def _held(torch, arch, world, params, opt):
    """What this rank holds after a mesh run: every leaf's shape by name,
    every Adafactor slot's by '<stacked path>/<slot>', and the bytes of
    the body's leaves (every param but the lm_head and the embedding
    table; and their whole size) and of the optimizer state
    (`launch.train.held_bytes` on the run's layout)."""
    from repro_torch.launch.train import held_bytes
    from repro_torch.models.registry import init_params
    from repro_torch.optim import AdafactorConfig
    from repro_torch.optim.tree import leaves_with_paths
    from repro_torch.train import TrainLayout
    lay = TrainLayout(arch, MeshShape(world), init_params(
        arch, torch.Generator(), "meta"),
        AdafactorConfig() if "slots" in opt else None)
    out = {"params": {"/".join(map(str, p)): tuple(t.shape)
                      for p, t in leaves_with_paths(params)},
           "bytes": held_bytes({"params": params, "opt": opt}, lay)}
    if "slots" in opt:
        out["slots"] = {"/".join(map(str, path)) + "/" + name: tuple(t.shape)
                        for (path, _, _), slots in zip(opt["groups"],
                                                       opt["slots"])
                        for name, t in slots.items()}
    return out


def _whole_layout(torch, arch, world, adafactor: bool):
    """({leaf: whole shape}, {leaf: its spec over model}, {slot: whole
    shape}, {slot: its stacked spec}) of `arch` on a (data, model) =
    `world` mesh, from the meta init (`TrainLayout`)."""
    from repro_torch.models.registry import init_params
    from repro_torch.optim import AdafactorConfig
    from repro_torch.optim.adafactor import init as ada_init
    from repro_torch.optim.tree import leaves_with_paths
    from repro_torch.train import TrainLayout
    meta = init_params(arch, torch.Generator(), "meta")
    cfg = AdafactorConfig() if adafactor else None
    lay = TrainLayout(arch, MeshShape(world), meta, cfg)
    shapes = {"/".join(map(str, p)): tuple(t.shape)
              for p, t in leaves_with_paths(meta)}
    specs = {"/".join(map(str, p)): s for p, s in lay.specs.items()}
    slots, slot_specs = {}, {}
    if adafactor:
        st = ada_init(meta, cfg)
        for (path, _, _), sl in zip(st["groups"], st["slots"]):
            for name, t in sl.items():
                key = "/".join(map(str, path)) + "/" + name
                slots[key] = tuple(t.shape)
                slot_specs[key] = lay.slot_specs[path][name]
    return shapes, specs, slots, slot_specs


def _cut_shape(shape, spec, m):
    return tuple(n // m if i < len(spec) and spec[i] == "model" else n
                 for i, n in enumerate(shape))


def _held_line(h) -> str:
    b = h["bytes"]
    return (f"holds {b['body'] / 2**30:.3f} GiB of the body's leaves "
            f"(whole {b['body_whole'] / 2**30:.3f}), optimizer state "
            f"{b['opt'] / 2**30:.3f} GiB")


def _mesh_run(torch, train_cli, argv, ref, upd, model_index, world, dev,
              params=None):
    """One train-CLI run in this rank's world (it joins it; `params`, whole,
    in place of its seeded init): history, seconds, peak, launches,
    collectives, what the rank holds (`_held`) and its params against
    one process's (`_param_errs`)."""
    import gc as gc_

    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import build
    C.STATS.reset()
    build.reset_counters()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, history = train_cli.main(argv, params)
    dt = time.perf_counter() - t0
    arch = train_cli.arch_of(train_cli.parse_args(argv))
    out = {"history": history, "s": dt,
           "peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
           "launches": {k: (c.count, dict(c.by_offset))
                        for k, c in build.COUNTERS.items() if c.count},
           "collectives": C.STATS.to_dict(),
           "held": _held(torch, arch, world, state["params"], state["opt"]),
           "param_errs": _param_errs(torch, state["params"], ref, upd,
                                     model_index)}
    del state
    gc_.collect()
    torch.cuda.empty_cache()
    return out


def dist_rank(rank, train_argv, ref_path, upd, ada_path, ada_upd):
    """Phase 19 (a) to (d) and (g) on one rank of the 4-rank world on the
    card; `ref_path` holds the one rank's params after (b)'s steps,
    `upd` its update (`_update_norms`), `ada_path` and `ada_upd` the
    same of (g)'s Adafactor steps."""
    import gc as gc_

    import numpy as np
    import torch
    from repro_torch.analysis.lint import RuleContext, run_rules
    from repro_torch.analysis.lint.ir import record
    from repro_torch.analysis.trace import collective_stats
    from repro_torch.core.sharded import make_sharded_loss
    from repro_torch.core.types import LossConfig
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import compressed_psum_tree, reshard
    from repro_torch.distributed.elastic import shard_tree
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_ce.ops import kernel_loss
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as train_cli
    torch.backends.cuda.matmul.allow_tf32 = False
    n, v, valid, d = TRAIN_BATCH * TRAIN_SEQ, DIST_VOCAB, DIST_VALID, DIST_D
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = M.make_local_mesh(*DIST_MESH, device=dev)
    g = torch.Generator(device=dev).manual_seed(19)
    h = torch.randn((n, d), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((v, d), generator=g, device=dev) * 0.02).to(
        torch.bfloat16)
    y = torch.randint(0, valid, (n,), generator=g, device=dev,
                      dtype=torch.int32)
    y[::10] = -100
    vl = v // mesh.shape["model"]
    off = mesh.axis_index("model") * vl
    out = {"rank": rank, "coords": mesh.coords, "backend": mesh.backend,
           "cases": {}}
    for name, layout, eps in (("2d", "2d", 0.0),
                              ("sp_gather", "sp_gather", 0.0),
                              ("2d_filtered", "2d", DIST_EPS),
                              ("sp_filtered", "sp_gather", DIST_EPS)):
        cfg = LossConfig(valid_vocab=valid, grad_filter_eps=eps)
        hr = h.clone().requires_grad_(True)
        wr = w.clone().requires_grad_(True)
        ref = kernel_loss(hr, wr, y, cfg)          # the whole head here
        ref.backward()
        axes = ("data", "model") if layout == "sp_gather" else ("data",)
        per = n // mesh.axis_size(axes)
        r0 = mesh.axis_index(axes) * per
        hl = h[r0:r0 + per].clone().requires_grad_(True)
        wl = w[off:off + vl].clone().requires_grad_(True)
        f = make_sharded_loss(mesh, cfg, rows_axes=("data",), layout=layout,
                              impl="kernel")
        torch.cuda.synchronize(dev)
        C.STATS.reset()
        build.reset_counters()
        t0 = time.perf_counter()
        loss = f(hl, wl, y[r0:r0 + per])
        loss.backward()
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        dh = _grad_errs(torch, hl.grad, hr.grad[r0:r0 + per])
        dw = _grad_errs(torch, wl.grad, wr.grad[off:off + vl])
        out["cases"][name] = {
            "loss": float(loss), "ref": float(ref), "dh": dh, "dw": dw,
            "ms": dt * 1e3, "rows": per, "offset": off,
            "skipped_dw_rows": int((wl.grad == 0).all(dim=1).sum()),
            "launches": {k: dict(c.by_offset)
                         for k, c in build.COUNTERS.items() if c.count},
            "collectives": C.STATS.to_dict()}
        del hr, wr, ref, hl, wl, loss

    # (c) one rank's loss step recorded (every rank joins its collectives)
    cfg = LossConfig(valid_vocab=valid)
    f = make_sharded_loss(mesh, cfg, rows_axes=("data",), layout="2d",
                          impl="kernel")
    per = n // mesh.shape["data"]
    r0 = mesh.axis_index("data") * per
    hl = h[r0:r0 + per].clone().requires_grad_(True)
    wl = w[off:off + vl].clone().requires_grad_(True)

    def step():
        loss = f(hl, wl, y[r0:r0 + per])
        loss.backward()
        return loss

    C.STATS.reset()
    if rank == 0:
        _, graph, fn_graph = record(step)
        torch.cuda.synchronize(dev)
        ctx = RuleContext(entry="sharded 2d loss step", graph=graph,
                          fn_graph=fn_graph, batch=per,
                          vocabs=(valid, v, vl))
        findings, _ = run_rules(ctx)
        out["recorded"] = {
            "stats": collective_stats(graph).to_dict(),
            "counted": C.STATS.to_dict(),
            "findings": [f"{x.rule}: {x.message}" for x in findings]}
    else:
        step()
    del hl, wl, h, w

    # (d) the compressed sum and a (2, 2) -> (4, 1) reshard on the card,
    # against the same calls on CPU tensors through the same world
    mesh41 = M.make_local_mesh(4, 1, device=dev)
    rng = np.random.default_rng(rank)
    grads = {"w": torch.from_numpy(rng.standard_normal(
        (4, 4096)).astype(np.float32))}
    res = {"w": torch.from_numpy((rng.standard_normal(
        (4, 4096)) * 1e-3).astype(np.float32))}
    whole = {"w": torch.from_numpy(np.random.default_rng(7).standard_normal(
        (64, 1024)).astype(np.float32))}
    a, b = {"w": ("data", "model")}, {"w": ("data",)}
    got, want = [], []
    for target, sink in ((dev, got), (torch.device("cpu"), want)):
        mean, new_res = compressed_psum_tree(
            {k: t.to(target) for k, t in grads.items()},
            {k: t.to(target) for k, t in res.items()}, mesh, "data")
        moved = reshard(shard_tree({"w": whole["w"].to(target)}, a, mesh),
                        a, mesh, b, mesh41)
        sink += [mean["w"].cpu(), new_res["w"].cpu(), moved["w"].cpu()]
    direct = shard_tree(whole, b, mesh41)["w"]
    out["card_vs_cpu"] = all(torch.equal(x, y) for x, y in zip(got, want)) \
        and torch.equal(got[2], direct)

    # (b) the train CLI in this world: it joins it, as under torchrun
    del grads, res, whole, got, want, mean, new_res, moved, direct
    gc_.collect()
    torch.cuda.empty_cache()
    # and (g): the same with --optimizer adafactor
    for key, path, u, extra in (("train", ref_path, upd, []),
                                ("ada", ada_path, ada_upd,
                                 ["--optimizer", "adafactor"])):
        ref = torch.load(path, mmap=True, weights_only=True)
        out[key] = {impl: _mesh_run(
            torch, train_cli, train_argv + extra + [
                "--devices", "2,2", "--loss-impl", impl], ref, u,
            mesh.axis_index("model"), DIST_MESH, dev)
            for impl in ("sharded", "sharded_sp")}
        del ref
    return out


def dist_check_loss(ranks, card):
    """Phase 19 (a) and (c)'s gates and lines over the ranks' reports."""
    bad = []
    for r in ranks:
        for name, c in r["cases"].items():
            tag = f"rank {r['rank']} {r['coords']} {name}"
            rel = abs(c["loss"] - c["ref"]) / abs(c["ref"])
            if rel > DIST_LOSS_RTOL:
                bad.append(f"{tag}: loss {c['loss']} vs {c['ref']}")
            for k in ("dh", "dw"):
                mx, fro, ok = c[k]
                if not ok or fro > DIST_GRAD_FRO:
                    bad.append(f"{tag}: {k} max {mx:.3e} fro {fro:.3e}")
            sfx = "_filtered" if "filtered" in name else ""
            off = c["offset"]
            for k in ("fused_ce_fwd", "fused_ce_dh" + sfx,
                      "fused_ce_dw" + sfx):
                if c["launches"].get(k) != {off: 1}:
                    bad.append(f"{tag}: {k} launches {c['launches']}")
            st = c["collectives"]
            print(f"[dist] (a) {tag}: loss {c['loss']:.6f} (one process "
                  f"{c['ref']:.6f}, rel {rel:.2e}); dH max {c['dh'][0]:.2e} "
                  f"fro {c['dh'][1]:.2e}, dW max {c['dw'][0]:.2e} fro "
                  f"{c['dw'][1]:.2e}; {c['rows']} TP-rows x {DIST_VOCAB // 2} "
                  f"at col_offset {off}, launches {c['launches']}; "
                  f"{c['skipped_dw_rows']} dW rows all zero; fwd+bwd "
                  f"{c['ms']:.1f} ms; collectives bytes "
                  f"{st['bytes_by_kind']} calls {st['count_by_kind']} on "
                  f"{card}", flush=True)
    rec = ranks[0]["recorded"]
    if rec["findings"]:
        bad.append(f"(c) findings: {rec['findings']}")
    if rec["stats"]["bytes_by_kind"] != rec["counted"]["bytes_by_kind"] or \
            rec["stats"]["count_by_kind"] != rec["counted"]["count_by_kind"]:
        bad.append(f"(c) collective_stats {rec['stats']} != counters "
                   f"{rec['counted']}")
    print(f"[dist] (c) rank 0's recorded 2d loss step: no finding under "
          f"every rule; collective_stats {rec['stats']['bytes_by_kind']} "
          f"{rec['stats']['count_by_kind']} = the counters", flush=True)
    if not all(r["card_vs_cpu"] for r in ranks):
        bad.append("(d) compressed_psum_tree / reshard on the card differ "
                   "from the CPU tensors' results")
    print("[dist] (d) compressed_psum_tree over data and a (2, 2) -> (4, 1) "
          "reshard: the card's tensors give the CPU tensors' results bit "
          "for bit on every rank", flush=True)
    if bad:
        raise AssertionError("phase 19: " + "\n".join(bad))


def _one_process(torch, train_cli, argv, world, dev, tmpdir, tag,
                 init=None):
    """One process of the train CLI on `argv`, the reference of a mesh
    run: (history, peak bytes, each leaf's update from the seeded init,
    `_update_norms` on the (data, model) = `world` layout, the path of
    its params after the steps, saved in host memory by leaf name under
    `tmpdir` so that the card holds nothing of it while the ranks
    train).  `init(arch, dev)`, if given, makes the whole params in
    place of the CLI's seeded init."""
    from repro_torch.models.registry import init_params
    from repro_torch.optim.tree import leaves_with_paths
    args = train_cli.parse_args(argv)
    arch = train_cli.arch_of(args)
    torch.cuda.reset_peak_memory_stats(dev)
    state, history = train_cli.main(
        argv, None if init is None else init(arch, dev))
    peak = torch.cuda.max_memory_allocated(dev)
    params = state["params"]
    del state                         # the optimizer state goes
    gc.collect()
    torch.cuda.empty_cache()
    if init is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        first = init_params(arch, gen, dev)
    else:
        first = init(arch, dev)
    upd = _update_norms(torch, arch, params, dict(leaves_with_paths(first)),
                        world)
    del first
    path = os.path.join(tmpdir, f"{tag}.pt")
    torch.save({"/".join(map(str, p)): x.detach().cpu()
                for p, x in leaves_with_paths(params)}, path)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return history, peak, upd, path


def _check_mesh_runs(tag, ranks, key, single, card, launches, bad,
                     world=DIST_MESH, vocab=DIST_VOCAB, gates=None):
    """Gates (`gates`, by default (b)'s: `DIST_GATES`) on the ranks' runs
    `key` ({layout: `_mesh_run`}) against one process's history
    `single`: step 0's and the last step's loss, every step's grad norm
    (those after the first update by ``gnorm_updated``), the params
    after the steps, each rank's fused-CE kernels once a step at its own
    ``col_offset``; their launches added to `launches`, each run's line
    printed."""
    g = dict(DIST_GATES, **(gates or {}))
    want = [m["loss"] for _, m in single]
    want_gn = [m["grad_norm"] for _, m in single]
    # the steps that run on the init: up to the first with an lr
    fresh = 1 + [m["lr"] > 0 for _, m in single].index(True)
    for impl in ("sharded", "sharded_sp"):
        if impl not in ranks[0][key]:
            continue
        hist = ranks[0][key][impl]["history"]
        got = [m["loss"] for _, m in hist]
        rel = [abs(x - y) / abs(y) for x, y in zip(got, want)]
        if len(got) != len(want) or rel[0] > g["step0"] or \
                rel[-1] > g["last"]:
            bad.append(f"{tag} {impl}: losses {got} vs one process {want}")
        for r in ranks:
            tr = r[key][impl]
            off = r["coords"]["model"] * (vocab // world[1])
            for k in ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw"):
                n, by = tr["launches"].get(k, (0, {}))
                if by != {off: len(want)}:
                    bad.append(f"{tag} {impl} rank {r['rank']}: {k} {by}")
                launches[k] = launches.get(k, 0) + n
            if [m["loss"] for _, m in tr["history"]] != got:
                bad.append(f"{tag} {impl} rank {r['rank']}: another loss")
            gn = [m["grad_norm"] for _, m in tr["history"]]
            gn_rel = [abs(x - y) / y for x, y in zip(gn, want_gn)]
            if len(gn) != len(want) or any(
                    x > (g["gnorm"] if i < fresh else g["gnorm_updated"])
                    for i, x in enumerate(gn_rel)):
                bad.append(f"{tag} {impl} rank {r['rank']}: grad norms {gn} "
                           f"vs one process {want_gn}")
            head, whole, body = _param_ratios(tr["param_errs"])
            worst = max(body, key=body.get)
            if max(head, whole) > g["param"] or body[worst] > g["leaf"]:
                bad.append(f"{tag} {impl} rank {r['rank']}: params off the "
                           f"one process's update: lm_head {head}, body "
                           f"{whole}, leaf {worst} {body[worst]}")
            st = tr["collectives"]
            print(f"[dist] {tag} {impl} rank {r['rank']} {r['coords']}: "
                  f"grad norms rel to one process "
                  f"{[f'{x:.2e}' for x in gn_rel]}; params after "
                  f"{len(want)} steps, |p - one process's| / its update: "
                  f"lm_head rows {head:.3e}, {len(body)} body leaves "
                  f"{whole:.3e}, each at most {body[worst]:.3e} ({worst}, "
                  f"{tr['param_errs'][worst][2]:.3%} of its entries off by "
                  f"more than its update's rms); {_held_line(tr['held'])}; "
                  f"peak {tr['peak_bytes'] / 2**30:.2f} GiB; launches "
                  f"{tr['launches']}; collectives a run "
                  f"{st['bytes_by_kind']} calls {st['count_by_kind']}; "
                  f"{tr['s']:.1f}s on {card}", flush=True)
        print(f"[dist] {tag} --devices {world[0]},{world[1]} --loss-impl "
              f"{impl}: losses {[round(x, 6) for x in got]}, rel to one "
              f"process {[f'{x:.2e}' for x in rel]}", flush=True)


# phase 19 (g): each rank of the (2, 2) world holds exactly 1/M of these
# leaves of every layer (Megatron's column- and row-parallel weights);
# of their Adafactor slots, a slot that keeps the cut dim holds 1/M and
# one that removed it is whole
DIST_TP_LEAVES = ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/wi",
                  "mlp/wg", "mlp/wo")


def _check_tp_holds(torch, arch, ranks, key, bad):
    """(g): every rank holds 1/M of each `DIST_TP_LEAVES` leaf of every
    layer, each slot of theirs at its spec's shape (1/M where it keeps
    the cut dim, whole where it removed it), and every other leaf and
    slot at its spec's shape too."""
    shapes, specs, slots, slot_specs = _whole_layout(torch, arch, DIST_MESH,
                                                     True)
    m = DIST_MESH[1]
    want = {k: _cut_shape(v, specs.get(k, ()), m) for k, v in shapes.items()}
    want_slots = {k: _cut_shape(v, slot_specs[k], m)
                  for k, v in slots.items()}
    for r in ranks:
        for impl, tr in r[key].items():
            held = tr["held"]
            tag = f"(g) {impl} rank {r['rank']}"
            for name, shape in want.items():
                if name.split("/", 2)[-1] in DIST_TP_LEAVES and \
                        math.prod(shape) * m != math.prod(shapes[name]):
                    bad.append(f"{tag}: {name} not cut over model")
            if held["params"] != want:
                bad.append(f"{tag}: holds {held['params']}, its specs say "
                           f"{want}")
            if held["slots"] != want_slots:
                bad.append(f"{tag}: slots {held['slots']}, their specs say "
                           f"{want_slots}")
    tp = [k for k in want_slots if k.split("/", 1)[-1].rsplit("/", 1)[0]
          in DIST_TP_LEAVES]
    cut = sum(want_slots[k] != slots[k] for k in tp)
    print(f"[dist] (g) every rank holds 1/{m} of {', '.join(DIST_TP_LEAVES)} "
          f"in each of {arch.cfg.n_layers} layers, and {cut} of their "
          f"{len(tp)} Adafactor slots cut (the others removed the cut dim "
          f"and are whole); every leaf and slot at its spec's shape",
          flush=True)


def phase_dist(torch, np, card, dev):
    """Phase 19: the distributed fused loss and the train CLI's
    ``--devices`` on the one card (see the module docstring).  Returns
    the fused-CE launches of (b), (e) and (g), the ranks' main paths."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as train_cli
    t0 = time.perf_counter()
    argv = ["--arch", "qwen3-0.6b", "--n-layers", str(DIST_LAYERS),
            "--steps", str(DIST_STEPS), "--global-batch", str(TRAIN_BATCH),
            "--seq-len", str(TRAIN_SEQ), "--log-every", "1"]
    ada = ["--optimizer", "adafactor"]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                      prefix="dist_ref_")
    try:
        refs = {}
        for tag, extra in (("(b)", []), ("(g)", ada)):
            t1 = time.perf_counter()
            refs[tag] = _one_process(torch, train_cli, argv + extra + [
                "--loss-impl", "kernel"], DIST_MESH, dev, tmp.name,
                tag.strip("()"))
            single, peak1 = refs[tag][:2]
            print(f"[dist] {tag} one rank, --loss-impl kernel"
                  f"{' ' + ' '.join(extra) if extra else ''}: losses "
                  f"{[round(m['loss'], 6) for _, m in single]}, grad norms "
                  f"{[round(m['grad_norm'], 6) for _, m in single]} in "
                  f"{time.perf_counter() - t1:.1f}s, peak "
                  f"{peak1 / 2**30:.2f} GiB", flush=True)
        t1 = time.perf_counter()
        ranks = M.spawn_world(dist_rank, 4, (
            argv, refs["(b)"][3], refs["(b)"][2], refs["(g)"][3],
            refs["(g)"][2]), device="cuda", join_s=900)
    finally:
        tmp.cleanup()
    print(f"[dist] world {DIST_MESH} of {len(ranks)} ranks, backend "
          f"{ranks[0]['backend']}: (a)-(d), (b) and (g) in "
          f"{time.perf_counter() - t1:.1f}s", flush=True)
    dist_check_loss(ranks, card)
    launches, bad = {}, []
    _check_mesh_runs("(b)", ranks, "train", refs["(b)"][0], card, launches,
                     bad)
    _check_mesh_runs("(g)", ranks, "ada", refs["(g)"][0], card, launches,
                     bad)
    _check_tp_holds(torch, train_cli.arch_of(train_cli.parse_args(argv)),
                    ranks, "ada", bad)
    want = [m["loss"] for _, m in refs["(b)"][0]]

    t1 = time.perf_counter()
    reports, hist = train_cli.main(
        ["--arch", "qwen3-0.6b", "--n-layers", str(DIST_LAYERS), "--steps",
         "1", "--global-batch", str(TRAIN_BATCH), "--seq-len",
         str(TRAIN_SEQ), "--devices", "1,1", "--loss-impl", "sharded"])
    rel = abs(hist[0][1]["loss"] - want[0]) / abs(want[0])
    if reports[0]["backend"] != "nccl" or rel > DIST_STEP0_RTOL:
        bad.append(f"(e) backend {reports[0]['backend']}, loss "
                   f"{hist[0][1]['loss']} vs {want[0]}")
    for k in ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw"):
        launches[k] = launches.get(k, 0) + reports[0]["launches"].get(
            k, (0, {}))[0]
    print(f"[dist] (e) --devices 1,1 on {reports[0]['backend']} (spawned by "
          f"the CLI): step 0 loss {hist[0][1]['loss']:.6f} (rel {rel:.2e}) "
          f"in {time.perf_counter() - t1:.1f}s", flush=True)
    if bad:
        raise AssertionError("phase 19: " + "\n".join(bad))
    print(f"[dist] phase 19 in {time.perf_counter() - t0:.1f}s", flush=True)
    return launches


# phase 19 (f): expert parallelism and the d-sharded embedding.
# qwen3-moe-235b-a22b at its published widths, cut to 1 layer (phase 12
# (d)'s cut, seed, batches and TrainConfig: the train CLI's defaults at
# 3 steps, 4 x 512), on a (data 1, model 4) world of 4 ranks sharing the
# card over gloo: a rank holds 32 of the 128 experts and their router
# columns, 16 of the 64 q heads and 1 of the 4 KV heads, 1024 of the
# 4096 embedding columns and 38016 lm_head rows, ~0.95 G params and
# ~11.4 GB of state (bf16 params and grads, f32 AdamW moments), so the 4
# ranks fit where one (2, 2) rank's would not (the (2, 2) data-axis
# sums are held on the CPU, tests/test_torch_expert_parallel.py).  Each
# layout is held to one process's 3 steps on the same seed and batches
# with phase 19 (b)'s gates: every rank's loss, ce and aux within
# DIST_MOE_RTOL (phase (b)'s DIST_STEP0_RTOL) at the steps that run on
# the init (steps 0 and 1: step 0's lr is 0), where the two runs differ
# only by the bf16 rounding of the 4 ranks' partial sums of the MoE
# output and of its dx; every step's grad norm within DIST_GNORM_RTOL;
# and the params after the steps, relative to the one process's update,
# within DIST_MOE_PARAM_RTOL together (the lm_head rows apart) and
# DIST_MOE_PARAM_LEAF each, every expert and embedding block against its
# own block of the one process's update.  The last step runs on params
# that two updates from differently rounded grads left apart (the gate
# above), and a router near-tie then routes a token elsewhere: its
# loss and ce within DIST_MOE_UPDATED_RTOL, its aux (a sum over the
# experts of token shares times mean probabilities, which every flipped
# assignment moves) within DIST_MOE_UPDATED_AUX.  The H100 read, at
# steps 0 and 1, losses within 1.9e-6 and aux within 1.4e-7; grad norms
# within 4.8e-4; at step 2 losses within 9.2e-5 and aux within 2.4e-3;
# the params 2.7e-2 to 3.8e-2 of the update together (phase (b)'s
# dense body reads 1.3e-2), a leaf 0.105 at most (an embedding block,
# its error in 0.03% of its entries, each off by more than the update's
# rms: the batch's 2048 tokens touch at most 1.3% of its rows, and
# every activation gradient passes through the 4 ranks' bf16 partial
# sums of the MoE dx; each line prints the worst leaf's share).  A
# rank whose dx was not summed over model reads grad norms ~0.45 off,
# the params 0.67 together and leaves above 1, in a mutation check of
# this phase at reduced width on the CPU, in f32: DIST_MOE_PARAM_RTOL
# and DIST_MOE_PARAM_LEAF sit ~4x above the sound readings and below
# those.  An aux taken over one rank's rows
# reads ~0.9 off at step 0 in the same check.
DIST_MOE_ARGV = ["--arch", MOE_ID, "--n-layers", "1", "--steps", "3",
                 "--global-batch", "4", "--seq-len", "512", "--lr", "3e-3",
                 "--log-every", "1"]
DIST_MOE_WORLD = (1, 4)
# phase 19 (h): xlstm-125m at its published widths, cut to 2 blocks (one
# sLSTM and one mLSTM), 3 AdamW steps at 4 x 256 (one mLSTM chunk) in
# (f)'s (1, 4) world under 'sharded': the rules cut its recurrent leaves
# by their rank fallback (the last dim over model), and the body gathers
# them at use, every rank running the whole recurrences; the sLSTM's
# MLP runs tensor-parallel.  Against one process, both from phase 14
# (f)'s contracted sLSTM init (`xl_init`): with the reference's, one
# process's own grad norms read 3.0e7, 5.7e8 and 1.1e6 on the H100
# (the JAX package's 1.6e8 at step 0 on the CPU).  Its gates
# (`DIST_XL_GATES`): (b)'s on the steps that run on the init (steps 0
# and 1: their losses read within 5.3e-07, their grad norms 4.4e-04 on
# the H100; PERF.md has the readings); after the first update the MLP
# region's rounding (its f32 sum of the ranks' partials puts ~0.4% of
# entries a bf16 ulp from one GEMM's) has passed through the update's
# near-sign steps and two recurrences over 256 tokens: the last loss
# read 1.61e-04, step 2's grad norm 8.65e-02, the params 0.10-0.19 of
# the update together and 0.30 a leaf at most.  Two witnesses on the
# H100 (`tools/dist_xl_witness.py`, PERF.md): in f32 the same run reads
# 9.2e-08, 4.7e-03, 9.6e-03 and 2.0e-02, so the spread is bf16
# rounding; with each rank taking its neighbour's gradient block of the
# cells' gathered leaves (norm-preserving: steps 0-1 read as the sound
# run) it reads 9.6e-03, 6.1e-02, 1.37 and 1.63.  The last loss, params
# and leaf gates sit between the two readings (6.2x / 9.6x, 2.7x /
# 2.7x, 2.5x / 2.2x from each); the step-2 grad norm does not see that
# fault (below the sound reading), and its gate stays 3x above the sound
# reading, below a rank that sums nothing over model (caught at step 0).
DIST_XL_GATES = {"last": 1e-3, "gnorm_updated": 0.25, "param": 0.5,
                 "leaf": 0.75}
DIST_XL_ARGV = ["--arch", "xlstm-125m", "--n-layers", "2", "--steps", "3",
                "--global-batch", "4", "--seq-len", "256", "--log-every",
                "1"]
DIST_MOE_RTOL = DIST_STEP0_RTOL
DIST_MOE_UPDATED_RTOL, DIST_MOE_UPDATED_AUX = 1e-3, 1e-2
DIST_MOE_PARAM_RTOL, DIST_MOE_PARAM_LEAF = 0.15, 0.5


def xl_init(arch, dev):
    """(h)'s whole params: the seeded init (seed 0) with phase 14 (f)'s
    contracted sLSTM recurrent matrices."""
    import torch
    from repro_torch.models.registry import init_params
    return contract_slstm(torch, arch, init_params(
        arch, torch.Generator(device=dev).manual_seed(0), dev))


def dist_moe_rank(rank, ref_path, upd, xl_path, xl_upd):
    """Phase 19 (f) and (h) on one rank of the (1, 4) world: the train
    CLI under 'sharded' and 'sharded_sp' (qwen3-moe), then 'sharded'
    (xlstm), each rank's params after the steps held to one process's
    (saved at `ref_path` / `xl_path`; their updates `upd` / `xl_upd`,
    from `_update_norms`)."""
    import torch
    from repro_torch.launch import train as train_cli
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    m = rank % DIST_MOE_WORLD[1]
    out = {"rank": rank, "coords": {"data": rank // DIST_MOE_WORLD[1],
                                    "model": m}}
    devices = ",".join(map(str, DIST_MOE_WORLD))
    xl_arch = train_cli.arch_of(train_cli.parse_args(DIST_XL_ARGV))
    for key, argv, path, u, impls, init in (
            ("train", DIST_MOE_ARGV, ref_path, upd,
             ("sharded", "sharded_sp"), None),
            ("xlstm", DIST_XL_ARGV, xl_path, xl_upd, ("sharded",),
             xl_init)):
        ref = torch.load(path, mmap=True, weights_only=True)
        out[key] = {impl: _mesh_run(
            torch, train_cli, argv + ["--devices", devices, "--loss-impl",
                                      impl], ref, u, m, DIST_MOE_WORLD, dev,
            None if init is None else init(xl_arch, dev))
            for impl in impls}
        del ref
    return out


def phase_dist_moe(torch, np, card, dev):
    """Phase 19 (f) and (h): expert parallelism and the d-sharded
    embedding at full width (see DIST_MOE_ARGV), then xlstm's leaves
    gathered at use (DIST_XL_ARGV), in one (1, 4) world.  Returns the
    fused-CE launches of the ranks' runs."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as train_cli
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                      prefix="dist_moe_ref_")
    try:
        single, peak1, upd, ref_path = _one_process(
            torch, train_cli, DIST_MOE_ARGV + ["--loss-impl", "kernel"],
            DIST_MOE_WORLD, dev, tmp.name, "f")
        t1 = time.perf_counter()
        xl_single, xl_peak, xl_upd, xl_path = _one_process(
            torch, train_cli, DIST_XL_ARGV + ["--loss-impl", "kernel"],
            DIST_MOE_WORLD, dev, tmp.name, "h", init=xl_init)
        xl_s = time.perf_counter() - t1
    except BaseException:
        tmp.cleanup()
        raise
    arch = train_cli.arch_of(train_cli.parse_args(DIST_MOE_ARGV))
    cfg, m = arch.cfg, DIST_MOE_WORLD[1]
    v_rank = arch.padded_vocab // m
    want = {k: [h[k] for _, h in single]
            for k in ("loss", "ce", "aux", "grad_norm")}
    # the steps that run on the init: up to the first with an lr
    fresh = 1 + [h["lr"] > 0 for _, h in single].index(True)
    print(f"[dist] (f) one process, {arch.arch_id} at d {cfg.d_model}, "
          f"{cfg.n_layers} layer(s), {cfg.num_experts} experts top-"
          f"{cfg.top_k}, --loss-impl kernel: losses "
          f"{[round(x, 6) for x in want['loss']]}, aux "
          f"{[round(x, 7) for x in want['aux']]}, grad norms "
          f"{[round(x, 6) for x in want['grad_norm']]}, peak "
          f"{peak1 / 2**30:.2f} GiB, {time.perf_counter() - t0 - xl_s:.1f}s",
          flush=True)
    xl_arch = train_cli.arch_of(train_cli.parse_args(DIST_XL_ARGV))
    print(f"[dist] (h) one process, {xl_arch.arch_id} at d "
          f"{xl_arch.cfg.d_model}, {xl_arch.cfg.n_layers} blocks "
          f"(contract_slstm), --loss-impl kernel: losses "
          f"{[round(h['loss'], 6) for _, h in xl_single]}, grad norms "
          f"{[round(h['grad_norm'], 6) for _, h in xl_single]}, peak "
          f"{xl_peak / 2**30:.2f} GiB, {xl_s:.1f}s", flush=True)
    t1 = time.perf_counter()
    # the ranks' allocators grow their segments in place: four processes
    # share the card, and a cached block one of them cannot use is
    # memory the others lack
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = M.spawn_world(dist_moe_rank, m * DIST_MOE_WORLD[0],
                              (ref_path, upd, xl_path, xl_upd),
                              device="cuda", join_s=900)
    finally:
        tmp.cleanup()
        if conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    print(f"[dist] (f), (h) world {DIST_MOE_WORLD} of {len(ranks)} ranks: "
          f"(f)'s layouts and (h) in {time.perf_counter() - t1:.1f}s",
          flush=True)
    shapes, specs, _, _ = _whole_layout(torch, arch, DIST_MOE_WORLD, False)
    want_held = {k: _cut_shape(v, specs.get(k, ()), m)
                 for k, v in shapes.items()}
    launches, bad = {}, []
    for impl in ("sharded", "sharded_sp"):
        for r in ranks:
            tr = r["train"][impl]
            tag = f"(f) {impl} rank {r['rank']}"
            got = {k: [h[k] for _, h in tr["history"]] for k in want}
            rel = {k: [abs(x - y) / abs(y) for x, y in zip(got[k], want[k])]
                   for k in want}
            if any(len(v) != len(want["loss"]) for v in got.values()):
                bad.append(f"{tag}: {len(got['loss'])} steps logged")
            for k in ("loss", "ce", "aux"):
                late = (DIST_MOE_UPDATED_AUX if k == "aux"
                        else DIST_MOE_UPDATED_RTOL)
                if any(x > (DIST_MOE_RTOL if i < fresh else late)
                       for i, x in enumerate(rel[k])):
                    bad.append(f"{tag}: {k} {got[k]} vs one process "
                               f"{want[k]}")
            if max(rel["grad_norm"]) > DIST_GNORM_RTOL:
                bad.append(f"{tag}: grad norms {got['grad_norm']} vs one "
                           f"process {want['grad_norm']}")
            head, whole, body = _param_ratios(tr["param_errs"])
            worst = max(body, key=body.get)
            far = tr["param_errs"][worst][2]
            if max(head, whole) > DIST_MOE_PARAM_RTOL or \
                    body[worst] > DIST_MOE_PARAM_LEAF:
                bad.append(f"{tag}: params off the one process's update: "
                           f"lm_head {head}, body {whole}, leaf {worst} "
                           f"{body[worst]}")
            held = tr["held"]["params"]
            if held != want_held:
                bad.append(f"{tag}: holds {held}, its specs say "
                           f"{want_held}")
            off = (r["rank"] % m) * v_rank
            for k in ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw"):
                n, by = tr["launches"].get(k, (0, {}))
                if by != {off: len(want["loss"])}:
                    bad.append(f"{tag}: {k} launches {by}")
                launches[k] = launches.get(k, 0) + n
            st = tr["collectives"]
            print(f"[dist] {tag}: holds {held['blocks/0/moe/wi'][0]} "
                  f"experts and router columns, "
                  f"{held['blocks/0/attn/wq'][1]} q and "
                  f"{held['blocks/0/attn/wk'][1]} KV heads, "
                  f"{held['embed/table'][1]} embedding columns, "
                  f"{held['lm_head'][0]} lm_head rows; "
                  f"{_held_line(tr['held'])}; loss rel "
                  f"{[f'{x:.2e}' for x in rel['loss']]}, ce "
                  f"{[f'{x:.2e}' for x in rel['ce']]}, aux "
                  f"{[f'{x:.2e}' for x in rel['aux']]}, grad norms "
                  f"{[f'{x:.2e}' for x in rel['grad_norm']]} (limits "
                  f"{DIST_MOE_RTOL} at steps 0-{fresh - 1}, then "
                  f"{DIST_MOE_UPDATED_RTOL} and aux {DIST_MOE_UPDATED_AUX}; "
                  f"grad norms {DIST_GNORM_RTOL}); params after "
                  f"{len(want['loss'])} steps, |p - one process's| / its "
                  f"update: lm_head rows {head:.3e}, {len(body)} other "
                  f"leaves {whole:.3e}, each at most {body[worst]:.3e} "
                  f"({worst}, {far:.3%} of its entries off by more than "
                  f"its update's rms; limits {DIST_MOE_PARAM_RTOL} and "
                  f"{DIST_MOE_PARAM_LEAF}); peak "
                  f"{tr['peak_bytes'] / 2**30:.2f} GiB; "
                  f"launches {tr['launches']}; collectives a run "
                  f"{st['bytes_by_kind']} calls {st['count_by_kind']}; "
                  f"{tr['s']:.1f}s on {card}", flush=True)
        losses = [h["loss"] for _, h in ranks[0]["train"][impl]["history"]]
        peaks = sum(r["train"][impl]["peak_bytes"] for r in ranks)
        print(f"[dist] (f) --devices 1,4 --loss-impl {impl}: losses "
              f"{[round(x, 6) for x in losses]} against one process's "
              f"{[round(x, 6) for x in want['loss']]}; the 4 ranks' peaks "
              f"sum to {peaks / 2**30:.2f} GiB", flush=True)
    # (h): xlstm's recurrent leaves gathered at use, its sLSTM MLPs
    # tensor-parallel, against one process with (b)'s gates
    _check_mesh_runs("(h)", ranks, "xlstm", xl_single, card, launches, bad,
                     world=DIST_MOE_WORLD, vocab=xl_arch.padded_vocab,
                     gates=DIST_XL_GATES)
    shapes, specs, _, _ = _whole_layout(torch, xl_arch, DIST_MOE_WORLD,
                                        False)
    want_xl = {k: _cut_shape(v, specs.get(k, ()), m)
               for k, v in shapes.items()}
    for r in ranks:
        if r["xlstm"]["sharded"]["held"]["params"] != want_xl:
            bad.append(f"(h) rank {r['rank']}: holds "
                       f"{r['xlstm']['sharded']['held']['params']}, its "
                       f"specs say {want_xl}")
    if bad:
        raise AssertionError("phase 19 (f), (h): " + "\n".join(bad))
    print(f"[dist] phase 19 (f) and (h) in {time.perf_counter() - t0:.1f}s",
          flush=True)
    return launches


# Phases 14, 15, 17 and 18 are host-bound (the sLSTM's loop a token,
# enc-dec's f32 attention, CLI runs, recording op graphs) and hold under
# 35 GiB of the card, so they run in turn in a child process beside
# phases 3-9 (under 25 GiB) and the script stays inside its time limit;
# their lines print after phase 9's, and their times, like those of
# phases 3-9 and phase 17's tuning trials, are taken beside the other
# process.
BESIDE = ("phase_xlstm", "phase_encdec", "phase_tune", "phase_analyze")
BESIDE_JOIN_S = 900


def beside_main(names, card, log_path, out_path):
    """The child: run the phases `names` in turn, its output into
    `log_path`, then {phase: its launches} as JSON into `out_path`."""
    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    launches = {}
    for name in names:
        t0 = time.perf_counter()
        launches[name] = globals()[name](torch, np, card, dev)
        print(f"[time] {name} (beside): {time.perf_counter() - t0:.1f}s",
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    with open(out_path, "w") as f:
        json.dump(launches, f)


def start_beside(names, card):
    """Start `beside_main` on `names` in a spawned child; returns the
    handle that `join_beside` takes."""
    import multiprocessing
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                      prefix="beside_")
    log, out = os.path.join(tmp.name, "log"), os.path.join(tmp.name, "out")
    proc = multiprocessing.get_context("spawn").Process(
        target=beside_main, args=(names, card, log, out), daemon=True)
    proc.start()
    return names, proc, tmp, log, out, time.perf_counter()


def join_beside(handle):
    """Wait for the child (at most BESIDE_JOIN_S), print its output and
    return {phase: its launches}; raises if it failed or overran."""
    names, proc, tmp, log, out, t0 = handle
    try:
        proc.join(max(1.0, BESIDE_JOIN_S - (time.perf_counter() - t0)))
        overran = proc.is_alive()
        if overran:
            proc.kill()
            proc.join()
        with open(log) as f:
            sys.stdout.write(f.read())
        sys.stdout.flush()
        if proc.exitcode != 0 or not os.path.exists(out):
            raise AssertionError(
                f"the phases beside, {names}, "
                + (f"ran past {BESIDE_JOIN_S} s" if overran else
                   f"failed: exit code {proc.exitcode}"))
        with open(out) as f:
            return json.load(f)
    finally:
        if proc.is_alive():
            proc.kill()
        tmp.cleanup()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run it from a checkout of the repo (src/ is "
              "missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import numpy as np
    from repro_torch.kernels import build
    from repro_torch.models.registry import get_arch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # phases 1-16 run on the kernels' own plans: an empty in-memory tuning
    # cache, whatever the user's holds (phase 17 tunes into its own file)
    os.environ["REPRO_TUNING_CACHE"] = ""
    card = card_line()
    print(f"[device] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"[build] {len(build.SOURCES)} kernel(s) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for name, log in logs.items():
        for fn, line in ptxas_lines(log):
            print(f"[build] {name}: {fn}: {line}")

    arch = get_arch("qwen3-0.6b")
    dev = torch.device("cuda")
    clock = [t0, t0]

    def mark(what):         # each phase's wall time, for the script's budget
        now = time.perf_counter()
        print(f"[time] {what}: {now - clock[1]:.1f}s ({now - clock[0]:.1f}s "
              "since the build began)", flush=True)
        clock[1] = now

    mark("build")
    kernels = phase_topk(torch, np, arch, dev)
    mark("top-k cases")
    ce, ce_errs = phase_fused_ce(torch, np, arch, dev)
    mark("fused-CE cases")
    filt = phase_ce_filter(torch, np, arch, dev, {
        k: ce["main"][k]["library_ms"] for k in ("fwd", "dh", "dw")})
    mark("filter cases")
    _, wide_errs = phase_ce_wide_filter(torch, np, dev, ce)
    filt["errs"].update({f"fused_ce_{k}_filtered": max(
        filt["errs"].get(f"fused_ce_{k}_filtered", 0.0), e)
        for k, e in wide_errs.items()})
    mark("wide filter cases")
    paged = phase_paged_attn(torch, np, dev)
    mark("paged_attn cases")
    score = phase_score(torch, np, arch, dev)
    mark("score_tokens cases")
    quant = phase_quant_kernels(torch, np, arch, dev)
    mark("quantized cases")
    beside = start_beside(BESIDE, card)         # phases 14, 15, 17, 18
    launches, params = phase_serve(torch, np, arch, card, dev)
    mark("phase 3")
    paged_launches, bf16_bytes_per_req = phase_paged_serve(
        torch, np, arch, params, card, dev)
    mark("phase 5")
    del params
    params, score_launches, spec_topk, spec_paged = phase_spec(
        torch, np, arch, card, dev)
    mark("phase 6")
    score_launches += phase_eval(torch, np, arch, params, card, dev)
    mark("phase 7")
    modes = phase_modes(torch, np, arch, params, card, dev)
    mark("phase 10")
    quant_launches = phase_quant_serve(torch, np, arch, params, card, dev,
                                       bf16_bytes_per_req)
    mark("phase 11")
    del params
    train_launches, train_p50, state = phase_train(torch, np, arch, card,
                                                   dev)
    mark("phase 4")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                     prefix="ckpt_smoke_") as workdir:
        adamw_opt_bytes = phase_ckpt_adamw(torch, np, arch, state, card,
                                           dev, workdir)
        del state
        torch.cuda.empty_cache()
        ftrain = phase_train_filtered(torch, np, arch, card, dev, train_p50)
        phase_checkpoint(torch, np, arch, card, dev, train_p50,
                         adamw_opt_bytes, workdir)
    mark("phases 9 and 8")
    beside = join_beside(beside)
    mark("phases 14, 15, 17 and 18 (their rest after phase 9)")
    torch.cuda.empty_cache()
    family = phase_family(torch, np, card, dev)
    mark("phase 12")
    gc.collect()
    torch.cuda.empty_cache()
    recurrent = phase_griffin(torch, np, card, dev)
    mark("phase 13")
    for name in ("phase_xlstm", "phase_encdec"):
        for key, n in beside[name].items():
            recurrent[key] = recurrent.get(key, 0) + n  # and phases 14, 15
    gc.collect()
    torch.cuda.empty_cache()
    for key, n in phase_wide(torch, np, card, dev).items():
        recurrent[key] = recurrent.get(key, 0) + n      # and phase 16
    mark("phase 16")
    gc.collect()
    torch.cuda.empty_cache()
    tuned = beside["phase_tune"]                        # phase 17
    analyzed = beside["phase_analyze"]                  # phase 18
    dist = phase_dist(torch, np, card, dev)             # phase 19
    mark("phase 19")
    gc.collect()
    torch.cuda.empty_cache()
    for key, n in phase_dist_moe(torch, np, card, dev).items():
        dist[key] = dist.get(key, 0) + n               # (f) and (h)
    mark("phase 19 (f) and (h)")

    main_case = kernels["rows8_k1"]          # the greedy decode step
    record = {"kernels": [{
        "name": "sample_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/sample_topk/csrc/sample_topk.cu",
        "replaces": "src/repro/kernels/sample_topk/kernel.py:53",
        "launches": (launches + spec_topk + modes["sample_topk"]  # 3, 6, 10
                     + family["sample_topk"]                      # 12
                     + recurrent.get("sample_topk", 0)),        # 13, 14, 15
        "max_abs_err": max(c["max_abs_err"] for c in kernels.values()
                           if "decode_ms" not in c),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}]}
    many = kernels["rows4096_k1"]            # the MTP accuracy's rows
    record["kernels"].append({
        "name": "sample_topk_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/sample_topk/csrc/sample_topk.cu",
        "replaces": "src/repro/kernels/sample_topk/kernel.py:53",
        "launches": ftrain["c"]["launches"]["sample_topk_rows"],
        "max_abs_err": max(c["max_abs_err"] for n, c in kernels.items()
                           if "decode_ms" in c),
        "ms": many["ms"], "plain_ms": many["plain_ms"],
        "bound_ms": many["bound_ms"], "bound_by": many["bound_by"],
        "library_ms": many["library_ms"]})
    ce_source = "src/repro_torch/kernels/fused_ce/csrc/fused_ce.cu"
    for kind, line in (("fwd", 80), ("dh", 259), ("dw", 283)):
        name = f"fused_ce_{kind}"
        row = ce["main"][kind]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": ce_source,
            "replaces": f"src/repro/kernels/fused_ce/kernel.py:{line}",
            "launches": (train_launches[name] + family[name]    # 4, 12
                         + recurrent.get(name, 0)),            # 13, 14, 15
            "max_abs_err": ce_errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    row = filt["stats_ignore10pct"]         # the training shape
    record["kernels"].append({
        "name": "fused_ce_fwd_tile_stats", "route": "cuda",
        "source": ce_source,
        "replaces": "src/repro/kernels/fused_ce/kernel.py:80",
        "launches": ftrain["launches"]["fused_ce_fwd"],
        "max_abs_err": filt["errs"]["fused_ce_fwd_tile_stats"],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"]})
    for kind, line in (("dh", 308), ("dw", 336)):
        name = f"fused_ce_{kind}_filtered"
        row = filt["peaked"][kind]            # most tiles skipped
        record["kernels"].append({
            "name": name, "route": "cuda", "source": ce_source,
            "replaces": f"src/repro/kernels/fused_ce/kernel.py:{line}",
            "launches": ftrain["launches"][name],
            "max_abs_err": filt["errs"][name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None})
    row = paged["decode"]                   # the paged serving decode shape
    record["kernels"].append({
        "name": "paged_attn", "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attn/csrc/paged_attn.cu",
        "replaces": "src/repro/kernels/paged_attn/kernel.py:59",
        "launches": (paged_launches["paged_attn"] + spec_paged  # 5, 6,
                     + modes["paged_attn"] + family["paged_attn"]   # 10, 12
                     + recurrent.get("paged_attn", 0)),                 # 15
        "max_abs_err": max(c["max_abs_err"] for c in paged.values()),
        # device time under torch.profiler; event_ms reads the launch rate
        "ms": row["ms"], "event_ms": row["event_ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"]})
    row = score["spec_rows32_t0.7"]         # the speculative verifier's rows
    record["kernels"].append({
        "name": "score_tokens", "route": "cuda",
        "source": "src/repro_torch/kernels/score_tokens/csrc/score_tokens.cu",
        "replaces": "src/repro/kernels/score_tokens/kernel.py:54",
        "launches": score_launches + recurrent.get("score_tokens", 0),
        "max_abs_err": max(c["max_abs_err"] for c in score.values()),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"]})
    # the quantized-serving options (phase 11's launches, phase 2's cases)
    topk_q = {n: c for n, c in quant.items() if n.startswith(
        ("int8_rows", "e4m3_rows"))}
    for name, kernel, source, line, row, errs in (
            ("sample_topk_w_scale", "sample_topk",
             "sample_topk/csrc/sample_topk.cu", "sample_topk/kernel.py:53",
             quant["int8_rows8_k1"], topk_q.values()),
            ("score_tokens_w_scale", "score_tokens",
             "score_tokens/csrc/score_tokens.cu",
             "score_tokens/kernel.py:54", quant["score_int8_rows32_t0.7"],
             [quant["score_int8_rows32_t0.7"]]),
            ("paged_attn_int8", "paged_attn",
             "paged_attn/csrc/paged_attn.cu", "paged_attn/kernel.py:59",
             quant["paged_int8_decode"],
             [quant["paged_int8_decode"], quant["paged_int8_tq5"]]),
            ("fused_ce_fwd_w_scale", "fused_ce_fwd",
             "fused_ce/csrc/fused_ce.cu", "fused_ce/kernel.py:80",
             quant["fwd_int8_rows8192"], [quant["fwd_int8_rows8192"]])):
        entry = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{source}",
            "replaces": f"src/repro/kernels/{line}",
            "launches": quant_launches.get(kernel, 0),
            "max_abs_err": max(c["max_abs_err"] for c in errs),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]}
        if "event_ms" in row:
            entry["event_ms"] = row["event_ms"]
        record["kernels"].append(entry)
    for entry in record["kernels"]:    # phases 17, 18 and 19, by counter
        entry["launches"] += (tuned.get(entry["name"], 0)
                              + analyzed.get(entry["name"], 0))
        entry["launches"] += dist.get(entry["name"], 0)
    missing = [k["name"] for k in record["kernels"] if not k["launches"]]
    if missing:
        raise AssertionError(f"kernels the main paths never launched: "
                             f"{missing}")
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

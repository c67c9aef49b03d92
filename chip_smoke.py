#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout
    python3 chip_smoke.py --sc-compare <parent checkout>
                                   # the SC kernels' timing, parent and
                                   # this checkout in turns (P C C P)
    python3 chip_smoke.py --cascade-compare <parent checkout>
                                   # load (c)'s cascade tick profile and
                                   # row write, parent and this checkout
                                   # in turns (P C C P)
    python3 chip_smoke.py --stride-compare <parent checkout>
                                   # the paged sweeps' outputs bit for bit
                                   # the parent's, and their timing (P C C
                                   # P)
    python3 chip_smoke.py --table3-full
                                   # phase 9 on the reference's full
                                   # Table 3 protocol alone
    python3 chip_smoke.py --moe    # phase 11 alone
    python3 chip_smoke.py --hymba  # phase 12 alone
    python3 chip_smoke.py --whisper
                                   # phase 13 alone
    python3 chip_smoke.py --obs    # phase 14 alone
    python3 chip_smoke.py --vlm    # phase 15 alone
    python3 chip_smoke.py --rwkv   # phase 16 alone
    python3 chip_smoke.py --decoders
                                   # phase 17 alone
    python3 chip_smoke.py --shard  # phase 18 alone
    python3 chip_smoke.py --model-axis
                                   # phase 20 alone
    python3 chip_smoke.py --train  # phase 19 alone
    python3 chip_smoke.py --train-mesh
                                   # phase 21 alone

Phases, each printing one JSON line:

  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
     TF32 switched off for matmul and cuDNN;
  2. the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``
     (one ``nvcc`` per source, all started together; the script waits
     for the attention libraries, runs phase 3's attention checks and
     phases 5–8 while ``sc_dot`` compiles, then waits for the SC ones and
     runs the rest of phase 3 and phase 4), and the count of
     tensor-core (HMMA), cp.async (LDGSTS) and ldmatrix (LDSM) instructions
     in the attention libraries (``cuobjdump -sass``; the run fails
     without HMMA and LDGSTS in ``flash_attention`` and LDGSTS in
     ``paged_decode_attention`` and ``cascade_prefix_attention``); the SC
     kernels' POPC, LDGSTS and BMMA (b1 tensor-core) counts and every SC
     function's ``ptxas`` stack frame (the run fails unless all are 0
     bytes, or without POPC, LDGSTS and BMMA in ``sc_dot``);
  3. each kernel held against its plain PyTorch version on the same CUDA
     tensors — the SC kernels and ``scatter_kv_rows`` bit for bit (the SC
     kernels over every precision, LFSR codes, levels outside [0, N],
     unaligned levels, K from 1 to 1,024 and past it (1,025, 1,536,
     2,048, 2,560, 4,096: subtrees of 1,024 leaves and their fold, every
     s0 mode and both adders at Wd 1 and 8), O from 1 to 200, Wd 1 to 8,
     paired leaves at N <= 16, both routes at N = 256 and the two weight
     banks as one operand), then timed at the frame path's shapes (bits 4 and 8, O = 64
     and 16, K = 25 and 32; ms, back-to-back ms, the host's issue µs, the
     bound, against the b1 tensor cores' rate measured on its own line, and
     the popcount bound and the first port's bound beside it) and at the
     SC LM frontend's on a 1,000-token stablelm-3b prompt at bits 4
     (``sc_frontend_timing`` line: ``sng_pack`` of the levels and of both
     banks, ``sc_dot_posneg`` at K = 2,560 and 2 x 2,560 outputs, each
     beside its plain version and its bound), the
     attention kernels (``paged_decode_attention`` and the cascade's
     ``paged_decode_attention_with_state``, ``cascade_prefix_attention``
     and ``merge_attn_states``) within 2e-5 (float32) / 2e-2 (bfloat16),
     the cascade's empty state exactly; the cascade kernels also at load
     (c)'s shapes (a 1,024-position chain, eight lanes, 8-block suffixes,
     a NaN trash block), each at three forced plans of
     ``cascade_split_plan`` (one split, as planned, one block per split),
     with the NaN trash block bitwise and every row that attends nothing
     exactly the empty state; ``flash_attention`` within 2e-5 / 2e-2 on the TPU
     kernel's five cases (also against its oracle), the fold's chunks (16
     and 7 queries at offsets 0, 512 and 1,072), the one-shot prefill at
     1,000 and a window of 8 with GQA 4:1, a repeated call bitwise; the
     split designs with forced plans in both dtypes (``flash_attention``:
     fold chunks at offsets 0, 512 and 1,072 in one split and one tile per
     split, a causal prompt and a window of 8 with GQA 4:1 split per tile,
     so some splits hold no key of some rows; ``paged_decode_attention``:
     lens 0, 1, a partial block, nb*bs and a lane longer than one split,
     in 12, 3 and 1 splits, windows None, 3 and 17, splice off and on, a
     lens-0 lane exactly 0, the NaN trash block and a repeated call
     bitwise) — and timed at the main paths' shapes beside it
     (``flash_attention`` at a fold chunk and at the one-shot prefill,
     beside SDPA), each timing with its launch's splits and CTAs and the
     kernel's ``ptxas`` registers and spills; the cascade passes also at
     one split and at more splits, with the host's time to issue a call
     at each plan and the device time of the pass and its combine, and the
     fused merge's cost (the suffix pass with and without the prefix
     states, in turns); ``scatter_kv_rows`` from stacked rows, from one
     tensor per layer, and after stacking them (the parent's tick write);
  4. the frame path: ``MicroBatchGateway`` serving the full-width LeNet-5
     (conv1 32@5x5, conv2 64@5x5, dense 512) SC frame path at bits 4 and 8
     over a seeded sensor trace, with the kernels' launch counts read around
     each run, one batch's payload held byte for byte against the plain path
     on the card and on the CPU, and its logits within 1e-4; the gateway's
     captured steps (``serve/capture.py``: 2 per bucket after ``warmup``,
     unchanged by the trace); the captured bucket-32 stages against their
     eager calls on the same frames (payload and logits bit for bit, the
     same launches); each bucket's stages timed on the host, captured
     against eager in turns (``HOST_RUNS`` runs a side); the SC launches
     of one captured bucket-32 sensor stage and a ``torch.profiler``
     window over ten of them, captured and eager (device busy ms, idle
     share, device ms by kernel, device operations, the host's kernel
     launches and graph launches per stage: one graph when captured);
  5. the prompt path: ``make_gateway`` serving stablelm-3b at its published
     width and depth (bf16, random weights from a seeded generator) over
     paged KV slots with one-shot prefill (``chunked=False``), on (a) the
     seeded fleet's prompts and (b) four 1,000-token requests with a radix
     prefix hit and a copy-on-write, with the launch counts of the paged
     kernels and of ``flash_attention`` (every prefill) read around each
     load; the decode
     tick timed at 8 lanes x 1k context (one captured flat tick over the
     three loads, one graph launch per tick); then the kernel tick held against
     the plain tick on the same card and weights: float32 at full width and
     depth 4 (tokens equal, logits within 2e-4) and bf16 at full depth
     (max |logit difference| within ``BF16_LOGIT_BOUND``);
  6. the cascade tick: ``make_gateway(..., backend="cascade")`` serving
     load (c), eight requests that share a 1,024-token prompt, each with its
     own 64-token tail and 32 new tokens, with one group of eight lanes on
     every tick, the prefix pass and the suffix pass (the merge fused into
     its epilogue, counted as fused merges) launched 32 times per tick,
     the standalone merge never, and no stack of the layers' rows before
     the row write (``aten::stack`` in the profiled ticks, here and on the
     flat tick);
     one captured cascade tick per metadata bucket the load visits;
     the same load through the flat ``"cuda"`` gateway, in turns with the
     cascade one, for the tick times and the tokens: equal at float32 and
     depth 4 with logits within 2e-4, and in bf16 at full depth equal up to
     each stream's first difference, which must be a near tie (the flat
     tick's margin for its token over the cascade's within the two ticks'
     logit difference on the same history, itself within
     ``NEAR_TIE_BOUND``); then the cascade tick held against the plain
     flat tick on eight prompts sharing a 512-token prefix, at float32
     depth 4 and bf16 full depth as in phase 5;
  7. the chunked prefill fold: ``ServeSpec(paged=True)`` (the reference's
     default ``chunked=True``) serving load (b) through ``backend="cuda"``
     and load (c) through ``backend="cascade"`` (seven of its eight
     prompts resume the fold at block 64), each beside the one-shot
     gateway on the same load: ``flash_attention`` launched once per layer
     per chunk the adapter counts, the decode kernels on the ticks; load
     (b)'s r1 (a 512-token hit) bitwise equal, first-token logits and K/V
     blocks, to the same prompt admitted cold into a fresh gateway; tokens
     equal to one-shot with logits within 2e-4 at float32 depth 4, and in
     bf16 at full depth up to each stream's first difference, a near tie;
     the host-clock prefill time per prompt (cold fold, resumed fold,
     one-shot) and a 1,000-token one-shot prefill with attention through
     the kernel and through its plain version;
  8. the captured ticks (``capture`` line): the flat tick at 8 lanes x 1k
     and load (c)'s cascade tick (held mid load on phase 6's own cascade
     gateway, the arena and lane state put back, on the
     ``cascade_main_path`` line), each right after its capture, replayed
     against the step's ``fn`` called eagerly on the same static inputs
     from the same arena (logits and the whole arena bit for bit, launch
     counts equal), one captured step each, and the host ms per tick
     captured against eager in turns (``HOST_RUNS`` runs a side) with a
     profile (the eager step's only where a line reports it; device busy,
     idle share, kernel and graph launches
     per tick: one graph and at most ``MAX_CAPTURED_TICK_LAUNCHES``
     kernels when captured);
  9. the retraining pipeline (``table3`` line): the reference's fast Table
     3 protocol (``benchmarks/table3_accuracy.py``) through
     ``core/hybrid.py`` at full-width LeNet-5 (conv1 32@5x5, conv2 64@5x5,
     dense 512, dropout 0.5) on the port's synthetic digits: 3,000 / 800
     images, 250 float pretraining steps at batch 64, then for bits 2, 4
     and 8 the binary design, new SC (``ramp_lowdisc``, TFF tree) and, at
     bits <= 4, old SC (``lfsr_pair``, MUX tree), each caching 2,500
     training and every test image's features, retraining the tail 150
     steps at batch 128 and evaluated from its cache: misclassification
     beside the paper's, the float baseline, the three relative claims,
     ms per pretraining step, per retraining step and per cached batch, the
     SC launches of each design (2 ``sng_pack`` per batch, 1 ``sc_dot`` per
     TFF batch), and ``torch.profiler`` windows over 10 retraining steps
     and 10 caching batches of each SC design.  It fails unless every SC
     design's features on 256 images equal the plain versions' on the same
     CUDA tensors and on 32 the CPU's, the float accuracy is above 0.8,
     every design's accuracy after retraining is at least its accuracy
     before less 0.02, and new SC errs more at 2 bits than at 4;
 10. the dense path (``dense_main_path`` line) at stablelm-3b's full
     width: ``make_gateway(cfg, params)`` with the default ``ServeSpec()``
     (dense KV slots, 4 lanes of 128 positions) serving six prompts of 1
     to 112 tokens, so two slots are cleared and reused (``flash_attention``
     32 times per prefill, one captured tick); the captured dense tick
     against its ``fn`` called eagerly from the same cache (logits, the
     whole cache and the lengths bit for bit) and timed captured against
     eager in turns, one graph launch per tick; the same load through the
     paged ``"cuda"``, ``"plain"`` and ``"gather"`` gateways: dense against
     ``"cuda"``, gather against ``"plain"`` and against ``"cuda"``, tokens
     equal with logits within 2e-4 at float32 depth 4 and, in bf16 at full
     depth, up to each stream's first difference, a near tie; then
     ``first_layer_mode="sc"`` at bits 4: the SC frontend's output for a
     100-token prompt (``sng_pack`` twice and ``sc_dot`` at K = 2,560)
     bit for bit the plain versions' on the same CUDA tensors, and the
     load served through the dense gateway, the one-shot paged gateway and
     the chunked fold (the frontend on every prompt or chunk, its launches
     counted; dense against paged in bf16 under the near-tie rule);
 11. the moe family (``moe_main_path`` line): deepseek-moe-16b at its
     published width cut to ``MOE_DEPTH`` = 10 of its 28 layers (dense
     layer 0 and 9 MoE layers; d_model 2,048, 16 heads of 128, 64 routed
     experts of 1,408 top-6 and 2 shared, dense layer 0 of 10,944,
     vocabulary 102,400; bf16, random weights drawn on the
     card after phases 5-10's stablelm-3b weights are freed; prefill
     routed dropless): the attention kernels at 16 heads of 128 against
     their plain versions in both dtypes and timed beside their bounds
     (``moe_shapes_timing`` line), then phase 10's four gateways (float32
     at depth 4 strict, the gather tick bit for bit the plain tick, and
     the least top-6/top-7 router gap of the streams; bf16 at the phase's
     depth under the near-tie rule, which a first difference meets on the
     logits or, past ``NEAR_TIE_BOUND`` there, on the router's logits at
     the first routing difference of the two gateways' eager replays,
     ``trace_routing``), phase 6's load (c) through the cascade
     tick, phase 7's load (b) chunked with its resumed fold bit for bit
     the cold fold, and phase 8's captured ticks bit for bit their
     eager steps, one graph launch per tick, with the same helpers;
 12. the hybrid family (``hymba_main_path`` line): hymba-1.5b at its
     published width cut to ``HYMBA_DEPTH`` = 6 of its 32 layers (layer
     0 global, 1-5 sliding; d_model 1,600, 25 heads over 5 KV heads of
     64, d_ff 5,504, SSM d_inner 3,200 and state 16, a window of 1,024,
     vocabulary 32,001;
     bf16, random weights drawn on the card after phase 11's are freed):
     the attention kernels at 25 x 64 over 5 KV heads with windows 1,024
     and none against their plain versions in both dtypes and timed
     beside their bounds and ``F.scaled_dot_product_attention``
     (``hymba_shapes_timing`` line), then phase 10's four gateways
     (float32 at depth 4, layer 0 global and 1-3 sliding), phase 6's load
     (c) admitted through the fold (the one-shot prefill refuses 1,088
     tokens, as the reference's does), phase 7's load (b) chunked with its
     resumed fold bit for bit the cold fold (also after the snapshotted
     slot ticked on), the boundary states' bytes, a one-shot 1,000-token
     admission refused and one-shot against chunked admission at 512 and
     1,024 tokens, and phase 8's captured ticks (8 lanes of 1,200-token
     contexts, and load (c)'s cascade tick) bit for bit their eager
     steps, one graph launch per tick;
 13. the encdec family (``whisper_main_path`` line): whisper-medium at its
     published width and depth (24 encoder and 24 decoder layers, d_model
     1,024, 16 heads of 64, d_ff 4,096 with GELU, biases, LayerNorm,
     sinusoidal positions, vocabulary 51,865; bf16, random weights drawn
     on the card after phase 12's are freed, a seeded (1, 1,500, 1,024)
     frame embedding as every admission's ``extras``): the attention
     kernels at 16 x 64 (MHA) in both dtypes, ``flash_attention`` also
     non-causal at the encoder's 1,500 frames over themselves and at the
     cross-attention's 1,000 and 16 queries over them (as planned,
     unsplit and one tile per split), each timed beside its bound and
     ``F.scaled_dot_product_attention`` (``whisper_shapes_timing`` line);
     then phase 10's four gateways, phase 6's load (c) through the cascade
     tick and phase 7's load (b) chunked, its resumed fold bit for bit the
     cold fold in logits, blocks and cross K/V, with the strict float32
     comparisons at full depth (whisper-medium fits whole in float32), and
     phase 8's captured ticks (8 lanes of 1,024-token contexts and load
     (c)'s cascade tick) bit for bit their eager steps, one graph launch
     per tick.  ``python3 chip_smoke.py --whisper`` runs it alone;
 14. observability (``obs_main_path`` line; run right after phase 10, on
     its stablelm-3b weights): the full LeNet-5 frame path at bits 4 over
     the seeded trace, measured service, untraced and then with tracer,
     metrics, SLO monitor, flight recorder and incident capture attached
     (predictions and ledger equal to the untraced run's, the virtual
     times aside, no obs call untraced, one ``request`` span per served
     frame, span energies re-folding to the ledger bit for bit, a valid
     Chrome trace and OpenMetrics exposition, every critical path exact,
     the captured steps unchanged); stablelm-3b at full width and depth
     (bf16) through the chunked gateway, load (b) on ``"cuda"`` and load
     (c) on ``"cascade"``, each folded cold by a bare gateway and by one
     built the same way with every attachment (``ServeSpec(flight=True,
     incident_dir=...)``), then again resumed on the traced one: tokens
     and pool counters bit for bit the bare run's, ``prefill_chunk`` spans
     = chunks folded, ``prefix_resume`` instants = resumed admissions,
     ``tick`` spans = steps, the bare run's captures and none more in the
     traced runs, the cost model per stage at the
     H100's ridge (``H100_RIDGE``), two validated incident bundles (load
     (c)'s SLO monitor going critical, and ``capture_incident``); then the
     host ms per captured tick, per cold fold chunk (the traced fold's
     synchronize) and per bucket-32 frame batch, traced against untraced
     in turns, with obs callbacks per tick and per batch.
     ``python3 chip_smoke.py --obs`` runs it alone;
 15. the vlm family (``vlm_main_path`` line): llama-3.2-vision-90b at its
     published width cut to 20 layers (16 self and 4 gated cross layers,
     ``cross_every`` 5 kept; d_model 8,192, 64 heads over 8 KV heads of
     128, d_ff 28,672, vocabulary 128,256; bf16, 39.6 GB of random weights
     drawn on the card after phase 13's are freed, every ``gate_attn`` at
     0.5 so that the cross path shows, a seeded (1, 1,024, 8,192) vision
     embedding as every admission's ``extras``): ``flash_attention`` at 64
     x 128 over 8 KV heads, causal at a 1,000-token prompt and non-causal
     at 1,000 and 16 queries over the 1,024 vision keys (as planned,
     unsplit and one tile per split), the paged kernels at those heads,
     each against its plain version and timed beside its bound and SDPA
     (``vlm_shapes_timing`` line); the vision cross K/V (no kernel); phase
     10's dense gateway against the paged ``"plain"`` and ``"gather"``
     gateways (the reference refuses the kernels' ticks for the family:
     ``"cuda"`` must be refused, the automatic tick is ``"plain"``); phase
     5's load (b) one-shot (its radix hit and copy-on-write), the
     prefill's attention through the kernel against its plain version on
     the same card and weights; the captured flat tick at 8 lanes of
     1,024-token contexts bit for bit its eager step, one graph launch per
     tick; ``flash_attention`` L + G = 24 times per one-shot prompt, no
     kernel on a tick; then, the bf16 weights freed, float32 at depth 5
     (one whole group, 26.1 GB): dense, plain and gather gateways tokens
     equal with logits within 2e-4 (gather bit for bit plain) and load (b)
     through the kernel against the plain prefill, tokens equal and logits
     within 2e-4.  ``python3 chip_smoke.py --vlm`` runs it alone;
 16. the rwkv family (``rwkv_main_path`` line): rwkv6-7b at its published
     width and depth (32 layers, d_model 4,096, 64 wkv heads of 64, d_ff
     14,336, vocabulary 65,536, ``rwkv_chunk`` 64; bf16, 15.05 GB of
     random weights drawn on the card after phase 15's are freed) through
     its state-slot path: ``make_gateway(..., ServeSpec(n_slots=8,
     paged=True))`` builds a ``StateSlotAdapter`` (O(1) state, nothing to
     page) and serves phase 10's prompts of 7, 64, 33 and 1 tokens and four
     1,024-token prompts, 32 new tokens each, against each request served
     alone by the same slots and against eager B = 1 decoding (in bf16
     equal up to each stream's first difference, a near tie; reported
     beside it: the first step of one tick where B = 1 and the 8 lanes
     part);
     phase 10's 100-token prompt refused (its chunks of 64 do not
     divide it), the state untouched; the captured tick at 8 active lanes
     bit for bit its eager step (logits and the wkv and shift states), one
     graph launch per tick, timed captured against eager in turns beside a
     byte model; a 1,024-token one-shot prefill's host ms; the SC frontend
     at bits 4 on the 64- and 1,024-token prompts, bit for bit its plain
     versions, ``sng_pack`` twice and ``sc_dot`` once per prompt and never
     on a tick, the SC kernels timed at the 1,024-token shape beside their
     bounds; then, the bf16 weights freed, float32 at depth 4: the 8-slot
     batcher's tokens equal to dedicated decoding with logits within 2e-4,
     and ``wkv6_chunked`` over layer 0's 128 steps within 2e-4 of 128
     ``wkv6_step``s.  No attention kernel launches on the path.
     ``python3 chip_smoke.py --rwkv`` runs it alone.
 17. the last decoder configs and the int8 KV layout
     (``decoders_main_path`` line, launches under the paths ``decoders``
     and ``int8``): starcoder2-15b whole (40 layers, 48 heads over 4 KV
     heads of 128, GQA 12:1; bf16, ~31.9 GB drawn on the card after phase
     16's weights are freed): the attention kernels at its heads, phase
     10's gateways (dense, paged ``"cuda"`` / ``"plain"`` / ``"gather"``;
     float32 at depth 4), load (c) admitted through the fold with the
     cascade tick against the flat tick (at ``SC2_CASCADE_DEPTH`` = 10 of
     the 40 layers), the captured 8 x 1k ticks beside
     a byte model; on the same weights the int8 layout (``kv_quant``): the
     kernel ticks refused, the dense and paged ``"plain"`` gateways
     against the gather oracle bit for bit and against the bf16 gateway
     (the first tick within 5 % of its max |logit|, the same argmax), the
     in-place int8 tick bit for bit its gather oracle over every arena
     block, the captured int8 ticks bit for bit their eager steps, the
     arena's bytes per position; then deepseek-67b at 24 of 95 layers and
     llama3-405b at 5 of 126 (its kernels at 128 x 128 over 8 KV heads)
     through the dense, ``"cuda"`` and ``"plain"`` gateways, bf16 near
     ties and float32 at depth 2 equal.  ``python3 chip_smoke.py
     --decoders`` runs it alone.
 18. sharded and disaggregated serving (``shard_main_path`` line, run
     right after phase 14 on its stablelm-3b weights, which every slice
     shares): four slices on the one card (``ServeSpec(mesh=...)``), each
     with its own dense-equivalent arena; (a) a one-slice gateway bit for
     bit the unsharded ``make_gateway(paged=True)`` on load (b), tokens
     and every logit row; (b) four slices against one on load (b)
     (chunked) and load (c) (one-shot), bf16 under the near-tie rule and
     float32 at depth 4 tokens equal, with the routing counters
     (affinity, affinity_spill, load, migrations); (c) a lane migrated
     between two slices mid-decode through the host, its logits bit for
     bit a stay-put adapter's, with the bytes moved and the round trip's
     ms per MB; (d) ``RolePlan.split(1, 3)`` traced against the
     colocated run: tokens (near ties), handoffs and their bytes, the
     ledger's ``migration_nj``, the span energies re-folding to
     ``fleet_energy_nj`` exactly, the protected chain on the decode
     slices, the critical paths by role; (e) ``obs.attribute`` over the
     sharded run's ``sliceN.`` stages at the H100's ridge; (f) phases
     11-13 and 15-16 print the cost model's decode-tick bytes beside their
     own byte model (``tick_bytes_analytic``).  The ``kernels`` line's
     ``shard`` launches are the sharded runs' alone (the migration's two
     slices included), and each sharded run must launch every kernel of
     the path itself; the unsharded baselines' launches are printed apart
     (``baseline_launches``).  ``python3 chip_smoke.py --shard`` runs it
     alone.
 19. training (``bwd_kernel_checks`` and ``train_main_path`` lines, run
     last): (a) the ``flash_attention_bwd`` kernel against its plain
     version at stablelm-3b's 32 x 80 (B 8, S 256, causal), GQA 8:1 and
     12:1 x 128 (1,024 tokens), hymba-1.5b's 25 over 5 heads of 64 with a
     window of 1,024 (2,048 tokens) and whisper-medium's 16 x 64
     non-causal cross (256 over 1,500), float32 within 2e-5 and bf16
     within 1e-2 of each gradient's max, two calls bit for bit, timed
     beside its bound, its plain version and SDPA's forward and backward;
     (b) stablelm-3b whole (bf16, float32 AdamW master, ``remat="full"``)
     trained 20 steps of 8 x 256 tokens: losses finite and falling, the
     attention gradients non-zero, ms per step, tokens/s, the model-FLOP
     share, idle share, peak memory, the flash launches per step; (c) the
     same with the SC frontend (bits 4), 10 steps, its launches and its
     output bit for bit the plain versions'; (d) float32 at depth 4, one
     step through the kernels against the plain versions; (e) a restart
     at depth 2 through ``ckpt/manager.py``, losses and state bit for bit,
     the checkpoint's bytes and seconds.  ``python3 chip_smoke.py
     --train`` runs it alone.
 20. sharded serving's model axis (``model_axis_main_path`` line, run
     right after phase 18 on its weights and its one-device runs of loads
     (b) and (c)): slices of 2 and 4 devices, each ``cuda:0`` (the arena
     split over a slice's devices, ``engine.arena_specs``).  (a)
     stablelm-3b whole in bf16: model 2 on load (b) (the fold and the
     ``"cuda"`` tick, every shard's attention its own launches) and load
     (c) (the cascade tick), model 4 on load (c), each against the
     one-device gateway under the near-tie rule; float32 at depth 4 both
     widths on both loads against the one-device gateway of the same
     spec: tokens equal, logits within ``MA_F32_TOL`` = 1e-5 and every
     kernel's launches those of ``expected_launches`` (layers x shards a
     tick or chunk, one row write a shard); (b) the split-KV fallback,
     hymba-1.5b cut to ``MA_HYMBA_DEPTH`` = 4 layers at model 2 (5 KV
     heads: each shard 8 rows of every 16-position block) on load (c)
     through the ``"cuda"`` and cascade ticks and at model 4 through the
     ``"cuda"`` tick (kernel 5 at the block stride per shard, then the
     merge of two states or of four), the same float32 gates, and kernel
     5 at its shape against its plain version (two and four shards, the
     merges against the plain read of the whole arena), timed beside the
     unsplit sweep and its bound; (c) a lane migrated mid-decode 1 -> 2 -> 1
     devices against its stay-put run (float32, depth 4), the receipts'
     bytes; (d) a prefill slice of two devices and two decode slices of
     one on load (b) (bf16), the handoffs and the prefill shards' flash
     launches; (e) per width 1, 2, 4 the captured 8 x 1k tick bit for bit
     its eager step, its host ms captured and eager, device busy ms and
     launches per tick.  ``python3 chip_smoke.py --model-axis`` runs it
     alone.
 21. the training meshes (``train_mesh_main_path`` line, run after phase
     19), every mesh device ``cuda:0``: (a) ``gpipe_apply`` at 4 stages
     over 6 and 2 microbatches against the sequential composition
     (float32, 1e-5); (b) ``tests/test_dist.py``'s config in float32 on
     the (2, 2, 2) ``("pod", "data", "model")`` mesh for 10 steps, losses
     finite and falling, each step against the one-device step from the
     same state (loss 1e-5 relative, parameters ``rtol=2e-3,
     atol=2e-5``), the flash launches layers x model x data-parallel
     coordinates x microbatches x (2 + 1) a step, the flash kernels
     against their plain versions at a model shard's float32 shape; (c)
     stablelm-3b whole in bf16 on ``"2x2 data,model"`` (ZeRO-1 state, 16
     + 16 heads a layer, B 8, S 256): losses finite, step 0 within 1e-3 of the
     one-device forward, ms a step, idle share, copy kernels' ms, peak
     memory, launches; (d) a checkpoint saved on 2x2 at depth 2 restored
     onto 1x1 and ``"1x4 data,model"`` bit for bit, the next step bit for
     bit a step from the same state placed there directly; (e) the flash
     forward and backward at the head-shard shape (4 x 256, 16 x 80)
     checked against and timed beside their plain versions, bounds and
     SDPA, and the GQA 16:1 fold chunk's forward checked, its plain time
     and bound.  ``python3 chip_smoke.py --train-mesh``
     runs it alone.

Phases 3–8 and 10–21 print their ``phase_s`` and a ``seconds`` breakdown
(phases 3 and 4 on the ``kernels_seconds`` and ``frame_path_seconds``
lines).

Every served step on the card runs captured: the eager calls above reach
``CapturedStep.fn`` explicitly, for the comparison.

Then the whole script's seconds (``script_s`` line), a ``{"kernels":
[...]}`` line (each kernel's launches on the path that brought it, and on
every path in ``launches_by_path``) and, last,
``{"ok": true, "device": ...}``.
Exits non-zero, and prints no result, without a CUDA device, without the
repository beside it, or when any phase fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
# results per clock per SM on sm_90 (CUDA C++ Programming Guide, arithmetic
# instruction throughput): 32-bit integer compare/add, and population count
INT32_PER_CLK_SM = 64
POPC_PER_CLK_SM = 16
# fp32 outside the tensor cores (NVIDIA H100 SXM data sheet): the paged
# attention's score and value products are float32 FMAs
F32_FLOPS = 67e12
# dense bf16 on the tensor cores (NVIDIA H100 SXM data sheet): the least
# time for prompt attention's bf16 products
BF16_FLOPS = 989e12
SOURCES = ("sng_pack", "sc_dot", "paged_attn", "cascade_attn", "flash_attn",
           "flash_attn_bwd")
KERNELS = ("sng_pack", "sc_dot", "paged_decode_attention", "scatter_kv_rows",
           "paged_decode_attention_with_state", "cascade_prefix_attention",
           "merge_attn_states", "flash_attention", "flash_attention_bwd")
CASCADE = ("paged_decode_attention_with_state", "cascade_prefix_attention",
           "merge_attn_states")
# the cascade tick's merge runs in the suffix pass's epilogue: the calls of
# paged_decode_attention_with_state that merged (its wrapper's
# ``fused_merges``), counted beside the wrappers' launches
FUSED_MERGE = "merge_attn_states (fused)"
TRACE_SECONDS = 1.0             # ~330 frames from the default 64-sensor fleet
# The bf16 kernel tick differs from the plain tick only in rounding: the
# plain path casts the softmax probabilities to bf16 before the value
# product, the kernel keeps them in float32 (as the TPU kernel does), and
# the difference then travels through 32 bf16 layers.  Stated before the
# first run on the card (PERF.md): the max |logit difference| over 8 lanes
# x 8 forced ticks stays under this.
BF16_LOGIT_BOUND = 1.0
# load (c) in bf16: where the cascade and flat greedy streams first differ,
# the two ticks' max |logit difference| on that history must stay under
# this (measured 0.058 and 0.055 on an H100, PERF.md) for the difference to
# count as a near tie
NEAR_TIE_BOUND = 0.2
# the kernel that each path brought, and so the path whose launches the
# kernels line reports as its own
HOME_PATH = {"sng_pack": "frame", "sc_dot": "frame",
             "paged_decode_attention": "prompt", "scatter_kv_rows": "prompt",
             **dict.fromkeys(CASCADE, "cascade"), "flash_attention": "chunked",
             "flash_attention_bwd": "train"}
# the prompt path: stablelm-3b, 8 lanes of 1,536 tokens, 16-token blocks
LM_SLOTS, LM_MAX_LEN, LM_BLOCK = 8, 1536, 16
# load (c): a shared 1,024-token prompt (64 full blocks), a 64-token tail per
# request, 32 new tokens each
SHARED_PROMPT, OWN_TAIL, NEW_TOKENS_C = 1024, 64, 32


# the timing's plans of the cascade's two passes: two of
# ``paged_attn.CASCADE_FORCED_PLANS`` and twice the CTAs, in runs down to
# one 64-position ring chunk (16 splits of the prefix pass at load (c), 2
# of the suffix)
TIMING_PLANS = ("planned", "one split", "more splits")
MORE_SPLITS = {"MIN_CTAS": 4 * 132, "MIN_SPLIT_POSITIONS": 64}


# the encdec family's frame embeddings and the vlm family's patch
# embeddings, by config name: the ``extras`` callable their adapters take
# (phase 13 registers whisper-medium's, phase 15 llama-3.2-vision-90b's)
FRAMES: dict = {}


class Stopwatch:
    """Host seconds of a phase's parts, each ending in a synchronize:
    ``lap(name)`` charges the time since the previous lap (or the start)
    to ``name``; ``fields()`` gives the ``seconds`` breakdown and the
    ``phase_s`` every phase line carries."""

    def __init__(self):
        self.t0 = self.mark = time.perf_counter()
        self.seconds: dict[str, float] = {}

    def lap(self, name: str) -> None:
        import torch
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.mark
        self.mark = now

    def fields(self) -> dict:
        return {"seconds": dict(self.seconds),
                "phase_s": time.perf_counter() - self.t0}


def extras_of(cfg):
    """The ``extras`` callable of ``cfg``'s adapters: the embeddings of
    :data:`FRAMES` for the encdec and vlm families, None for the
    others."""
    return FRAMES.get(cfg.name) if cfg.family in ("encdec", "vlm") \
        else None


def prefill_kw(cfg) -> dict:
    """The keywords ``engine.prefill`` takes for ``cfg``: the frame
    embeddings for the encdec family, the patch embeddings for the vlm
    family."""
    extras = extras_of(cfg)
    return {} if extras is None else dict(extras())


def flash_launches(cfg, prefills: int, admissions: int) -> int:
    """``flash_attention``'s launches over ``prefills`` one-shot prompts or
    fold chunks of ``admissions`` admissions: one per layer and prompt or
    chunk, plus one per cross layer (the cross-attention: every decoder
    layer of the encdec family, which also runs its encoder once per
    admission, one per encoder layer; one layer in ``cross_every`` of the
    vlm family)."""
    n = (cfg.n_layers + cfg.n_cross) * prefills
    return n + cfg.enc_layers * admissions if cfg.family == "encdec" else n


def strict_cfg(cfg):
    """The float32 config of the strict comparisons: depth 4, the whole
    depth for the encdec family (whisper-medium fits in float32 whole),
    one group of ``cross_every`` layers for the vlm family."""
    import dataclasses
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, param_dtype="float32")
    depth = cfg.cross_every if cfg.family == "vlm" else 4
    return dataclasses.replace(cfg, n_layers=depth, param_dtype="float32")


@contextlib.contextmanager
def cascade_plan(name: str):
    """Put the plan ``name`` of ``paged_attn.CASCADE_FORCED_PLANS``, or
    "more splits", in force through the planner's module constants."""
    from repro_torch.kernels import paged_attn as paged_k
    consts = MORE_SPLITS if name == "more splits" else \
        paged_k.CASCADE_FORCED_PLANS[name]
    with contextlib.ExitStack() as stack:
        for const, value in consts.items():
            stack.enter_context(mock.patch.object(paged_k, const, value))
        yield


def reset_counts() -> None:
    """Every launch counter of the wrappers, the fused merges included, to
    0 (``repro_torch.kernels.COUNTERS``, the list the captured steps add
    their launches to on every replay)."""
    from repro_torch import kernels
    kernels.reset_counts()


def read_counts() -> dict:
    """Every launch counter of ``repro_torch.kernels.COUNTERS`` by name;
    the fused merges under ``FUSED_MERGE``."""
    from repro_torch import kernels
    return kernels.read_counts()


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# the longest sleep queued ahead of timed calls: ``sleep_cycles`` is this
# many seconds of the SM clock
SLEEP_S = 0.05


def issue_sleep(fn, inner: int, sleep_cycles: int) -> int:
    """Cycles of the sleep kernel to queue ahead of ``inner`` calls of
    ``fn`` so that the device waits for the host's whole issue of them:
    three times their issue as one call (a warm-up, timed on the host)
    takes, at least 2 ms, at most ``sleep_cycles``."""
    t0 = time.perf_counter()
    fn()
    issue = time.perf_counter() - t0
    per_s = sleep_cycles / SLEEP_S
    return int(min(sleep_cycles, per_s * max(2e-3, 3 * inner * issue)))


def time_ms(fn, reps: int, inner: int, sleep_cycles: int,
            b2b: bool = True) -> tuple[float, float | None]:
    """(device, back-to-back) ms per call, each the median over ``reps`` of
    the CUDA-event time of ``inner`` calls, after two warm-up calls.

    Device: the calls are queued behind a sleep kernel longer than it takes
    the host to issue them (:func:`issue_sleep`), so the events time the
    kernels alone.
    Back-to-back: nothing is queued ahead, so a call shorter than the host's
    launch overhead is timed at the host's launch rate, which is what the
    frame path pays between synchronizations; without ``b2b`` it is not
    timed (None)."""
    import torch
    fn()
    sleep_cycles = issue_sleep(fn, inner, sleep_cycles)
    out = []
    for sleep in (sleep_cycles, 0) if b2b else (sleep_cycles,):
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if sleep:
                torch.cuda._sleep(sleep)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / inner)
        out.append(statistics.median(times))
    return out[0], out[1] if b2b else None


def host_ms(fn, reps: int = 10) -> float:
    """Median host-clock time of ``fn`` ending in a device synchronize."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def issue_us(fn, plans: dict, sleep_cycles: int, reps: int = 11,
             inner: int = 20) -> dict:
    """Median host time in microseconds to issue one call of ``fn`` (its
    Python, allocations and launches) under each of ``plans`` (a function
    returning the context that puts the plan in force), the calls queued
    behind a sleep kernel (:func:`issue_sleep`) so that the device never
    holds the host back;
    the plans take turns in every repetition, so a drift of the host's
    speed reaches them all alike."""
    import torch
    times = {key: [] for key in plans}
    sleeps = {}
    for key, plan in plans.items():
        with plan():
            fn()
            sleeps[key] = issue_sleep(fn, inner, sleep_cycles)
    for _ in range(reps):
        for key, plan in plans.items():
            with plan():
                torch.cuda._sleep(sleeps[key])
                t0 = time.perf_counter()
                for _ in range(inner):
                    fn()
                times[key].append((time.perf_counter() - t0) / inner * 1e6)
            torch.cuda.synchronize()
    return {key: statistics.median(t) for key, t in times.items()}


def kernel_us(prof, n: int) -> dict[str, float]:
    """Device microseconds per step by kernel in the ``torch.profiler``
    trace ``prof`` of ``n`` steps: the device's own events (kernels,
    copies); a host operator's device time repeats its kernels', so only
    these are summed."""
    from torch.autograd import DeviceType
    out: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and \
                not getattr(ev, "is_user_annotation", False):
            out[ev.name] = out.get(ev.name, 0) + ev.device_time_total / n
    return out


def top_ms(dev_us: dict[str, float], n: int) -> dict[str, float]:
    """The ``n`` largest of ``kernel_us``'s times in ms, names cut to 80
    characters; kernels whose names share those 80 (the templated
    elementwise and ``_foreach`` kernels) are summed, not overwritten."""
    out: dict[str, float] = {}
    for k, v in dev_us.items():
        out[k[:80]] = out.get(k[:80], 0.0) + v / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:n])


def device_us(fn, n: int = 20) -> dict[str, float]:
    """Device microseconds per call of ``fn`` by kernel (``torch.profiler``
    over ``n`` calls after one), names cut to 60 characters."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {name[:60]: us for name, us in kernel_us(prof, n).items()}


def sass_counts(source: str, opcodes: tuple[str, ...]) -> dict[str, int]:
    """How many SASS instructions of each opcode the built library of
    ``csrc/<source>.cu`` holds (``cuobjdump -sass``, beside ``nvcc``)."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(tool), "-sass", str(build.library_path(source))], check=True,
        capture_output=True, text=True, timeout=120).stdout
    return {op: len(re.findall(rf"\*/\s+(?:@!?U?P\w+\s+)?{op}[.\s]", sass))
            for op in opcodes}


def ptxas_of(source: str, *needles: str) -> list[str]:
    """The ``-Xptxas -v`` lines (registers, spills) of the entry functions
    of ``csrc/<source>.cu`` whose mangled name holds every needle, each
    after that name from its first needle on (its template arguments)."""
    from repro_torch.kernels import build
    log = build.library_path(source).with_suffix(".log").read_text()
    out, entry = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif entry and all(n in entry for n in needles) and (
                "registers" in ln or "spill" in ln):
            out.append(f"{entry[entry.find(needles[0]):][:48]}: "
                       f"{ln.strip()}")
    return out


def paged_split_checks(q, ka, va, tables, ln, nk, tol, live, err
                       ) -> list[dict]:
    """``paged_decode_attention`` at the split plan in force against its
    plain version, windows None, 3 and 17, splice off and on; a lens == 0
    lane exactly 0; the NaN trash block and a repeated call bitwise (the
    trash block is left at 1e9 / -1e9)."""
    import torch
    from repro_torch.kernels import paged_attn as paged_k
    from repro_torch.kernels import ref
    splits = paged_k.paged_split_plan(tables.shape[1], ka.shape[1])[0]
    dtype, checks = str(ka.dtype), []
    for window in (None, 3, 17):
        for splice in (False, True):
            new_kv = nk if splice else None
            got = paged_k.paged_decode_attention(
                q, ka, va, tables, ln, window=window, new_kv=new_kv)
            want = ref.paged_decode_attention(q, ka, va, tables, ln, window,
                                              new_kv)
            torch.cuda.synchronize()
            e = float((got[live].float() - want[live].float()).abs().max())
            err["paged_decode_attention"] = max(
                err["paged_decode_attention"], e)
            checks.append({
                "kernel": "paged_decode_attention", "case": "forced split",
                "splits": splits, "dtype": dtype, "window": window,
                "splice": splice, "max_abs_err": e,
                "ok": torch.allclose(got[live].float(), want[live].float(),
                                     rtol=tol, atol=tol)
                and bool((got[~live] == 0).all())})
    base = paged_k.paged_decode_attention(q, ka, va, tables, ln, new_kv=nk)
    again = paged_k.paged_decode_attention(q, ka, va, tables, ln, new_kv=nk)
    ka[0], va[0] = float("nan"), float("nan")
    nan = paged_k.paged_decode_attention(q, ka, va, tables, ln, new_kv=nk)
    ka[0], va[0] = 1e9, -1e9
    checks.append({"kernel": "paged_decode_attention", "case": "forced split",
                   "splits": splits, "dtype": dtype,
                   "nan_trash_bitwise": True, "repeated_bitwise": True,
                   "ok": torch.equal(base, nan) and torch.equal(base, again)})
    return checks


def paged_kernel_checks(dev, gen, sleep: int) -> tuple[dict, dict]:
    """Phase 3 for the paged KV kernels.  Returns (max_abs_err, timing) per
    kernel; raises SystemExit when a kernel disagrees with its plain
    version."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attn as paged_k
    from repro_torch.kernels import ref

    def arr(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def case(B, nb, bs, Hq, Hkv, D, dtype, lens):
        """Each lane owns distinct blocks; table entries past its chain
        and the trash block 0 hold garbage that ``lens`` must mask."""
        num_blocks = B * nb + 1
        ka, va = arr((num_blocks, bs, Hkv, D), dtype), \
            arr((num_blocks, bs, Hkv, D), dtype)
        ka[0], va[0] = 1e9, -1e9
        perm = torch.randperm(num_blocks - 1, generator=gen,
                              device=dev).to(torch.int32) + 1
        tables = torch.zeros((B, nb), dtype=torch.int32, device=dev)
        for b, n in enumerate(lens):
            used = -(-n // bs)
            tables[b, :used] = perm[b * nb:b * nb + used]
        return (arr((B, Hq, D), dtype), ka, va, tables,
                torch.tensor(lens, dtype=torch.int32, device=dev),
                (arr((B, Hkv, D), dtype), arr((B, Hkv, D), dtype)))

    err = {"paged_decode_attention": 0.0, "scatter_kv_rows": 0.0}
    checks = []
    shapes = [("MHA", 3, 4, 16, 8, 8, 80), ("GQA 4:1", 3, 3, 16, 16, 4, 64),
              ("MQA", 3, 5, 8, 8, 1, 16), ("decode", 8, 96, 16, 32, 32, 80)]
    for label, B, nb, bs, Hq, Hkv, D in shapes:
        # lens of 1, a partial block and exactly nb*bs, in turn
        lens = [(1, bs + bs // 2, nb * bs)[b % 3] for b in range(B)]
        for dtype in (torch.float32, torch.bfloat16):
            q, ka, va, tables, ln, nk = case(B, nb, bs, Hq, Hkv, D, dtype,
                                             lens)
            tol = 2e-5 if dtype == torch.float32 else 2e-2
            for window in (None, 3, 17):
                for splice in (False, True):
                    new_kv = nk if splice else None
                    got = paged_k.paged_decode_attention(
                        q, ka, va, tables, ln, window=window, new_kv=new_kv)
                    want = ref.paged_decode_attention(q, ka, va, tables, ln,
                                                      window, new_kv)
                    torch.cuda.synchronize()
                    e = float((got.float() - want.float()).abs().max())
                    err["paged_decode_attention"] = max(
                        err["paged_decode_attention"], e)
                    checks.append({
                        "kernel": "paged_decode_attention", "case": label,
                        "dtype": str(dtype), "window": window,
                        "splice": splice, "max_abs_err": e,
                        "ok": torch.allclose(got.float(), want.float(),
                                             rtol=tol, atol=tol)})
            # NaN in the trash block: the kernel never reads it
            base = paged_k.paged_decode_attention(q, ka, va, tables, ln,
                                                  new_kv=nk)
            ka[0], va[0] = float("nan"), float("nan")
            nan = paged_k.paged_decode_attention(q, ka, va, tables, ln,
                                                 new_kv=nk)
            checks.append({"kernel": "paged_decode_attention", "case": label,
                           "dtype": str(dtype), "nan_trash_bitwise": True,
                           "ok": torch.equal(base, nan)})
    # the row write, stacked rows (the reference's form) and one tensor per
    # layer (the tick's), each against the plain version and the two forms
    # against each other, bit for bit: 4 layers at stablelm-3b's rows, 130
    # layers (two launches of at most 128 layers' pointers) at narrow ones
    for (L, H, D), dtype in itertools.product(((4, 32, 80), (130, 2, 16)),
                                              (torch.float32,
                                               torch.bfloat16)):
        nbk, bs, S = 40, 16, 8
        base = arr((L, nbk, 1, bs, H, D), dtype), \
            arr((L, nbk, 1, bs, H, D), dtype)
        kr, vr = arr((L, S, H, D), dtype), arr((L, S, H, D), dtype)
        layers = ([r.clone() for r in kr], [r.clone() for r in vr])
        w = (torch.randperm(nbk - 1, generator=gen, device=dev)[:S] + 1
             ).to(torch.int32)
        w[5:] = 0                                 # trash lanes, colliding
        o = torch.randint(0, bs, (S,), generator=gen, device=dev,
                          dtype=torch.int32)
        o[5:] = 3
        rk, rv = ref.scatter_kv_rows(base[0].clone(), base[1].clone(), kr,
                                     vr, w, o)
        out = {}
        for form, rows in (("stacked", (kr, vr)), ("layers", layers)):
            ka, va = base[0].clone(), base[1].clone()
            paged_k.scatter_kv_rows(ka, va, *rows, w, o)
            out[form] = (ka, va)
        torch.cuda.synchronize()
        for form, (ka, va) in out.items():
            ok = torch.equal(ka[:, 1:], rk[:, 1:]) and \
                torch.equal(va[:, 1:], rv[:, 1:])
            e = max(float((ka[:, 1:].float() - rk[:, 1:].float()).abs()
                          .max()),
                    float((va[:, 1:].float() - rv[:, 1:].float()).abs()
                          .max()))
            err["scatter_kv_rows"] = max(err["scatter_kv_rows"], e)
            checks.append({"kernel": "scatter_kv_rows", "dtype": str(dtype),
                           "layers": L, "rows": form,
                           "bitwise_non_trash": ok, "ok": ok})
        # (the trash block 0 takes the colliding lanes in either order)
        same = all(torch.equal(a[:, 1:], b[:, 1:])
                   for a, b in zip(out["stacked"], out["layers"]))
        checks.append({"kernel": "scatter_kv_rows", "dtype": str(dtype),
                       "layers": L, "layers_bitwise_stacked": same,
                       "ok": same})
        del base, out, kr, vr, layers
    # forced splits of the chain (the planner's run length patched): lens
    # 0, 1, a partial block, exactly nb*bs and a lane longer than one split,
    # GQA 4:1 at d_head 80, split one block per CTA, four and all twelve
    # (one split); windows None, 3 and 17, splice off and on; a lens == 0
    # lane returns 0 exactly; the NaN trash block and a repeated call
    # bitwise
    B, nb, bs, Hq, Hkv, D = 5, 12, 16, 8, 2, 80
    lens = [0, 1, bs + bs // 2, nb * bs, 150]
    for dtype in (torch.float32, torch.bfloat16):
        q, ka, va, tables, ln, nk = case(B, nb, bs, Hq, Hkv, D, dtype, lens)
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        live = ln > 0
        for bps in (1, 4, nb):
            with mock.patch.object(paged_k, "SPLIT_POSITIONS", bps * bs):
                checks += paged_split_checks(q, ka, va, tables, ln, nk, tol,
                                             live, err)
    bad = [c for c in checks if not c["ok"]]

    # timing at the prompt path's decode shape: 8 lanes x 1,032 positions,
    # bs 16, 96 table entries, 32 KV heads of 80, bf16, one layer's arena
    B, nb, bs, H, D, n_pos = 8, 96, 16, 32, 80, 1032
    num_blocks = LM_SLOTS * (LM_MAX_LEN // LM_BLOCK) + 1
    bf = torch.bfloat16
    q, ka, va = arr((B, H, D), bf), arr((num_blocks, bs, H, D), bf), \
        arr((num_blocks, bs, H, D), bf)
    k1, v1 = arr((B, H, D), bf), arr((B, H, D), bf)
    used = -(-n_pos // bs)
    perm = torch.randperm(num_blocks - 1, generator=gen, device=dev) + 1
    tables = torch.zeros((B, nb), dtype=torch.int32, device=dev)
    tables[:, :used] = perm[:B * used].reshape(B, used).to(torch.int32)
    lens = torch.full((B,), n_pos, dtype=torch.int32, device=dev)
    def attn():
        return paged_k.paged_decode_attention(q, ka, va, tables, lens,
                                              new_kv=(k1, v1))
    attn_ms, attn_b2b = time_ms(attn, 5, 20, sleep)
    # the run length of a split: the kernel's time and the host's time to
    # issue one call (plan, scratch, launches) at 8, 16 and 32 blocks a
    # split and at one split (no scratch, no combine launch)
    plans = {p: functools.partial(mock.patch.object, paged_k,
                                  "SPLIT_POSITIONS", p)
             for p in (8 * bs, 16 * bs, 32 * bs, nb * bs)}
    host = issue_us(attn, plans, sleep)
    sweep = []
    for positions, plan in plans.items():
        with plan():
            sweep.append({"positions_per_split": positions,
                          "splits": paged_k.paged_split_plan(nb, bs)[0],
                          "ms": time_ms(attn, 5, 20, sleep, b2b=False)[0],
                          "host_issue_us": host[positions]})
    attn_plain = time_ms(lambda: ref.paged_decode_attention(
        q, ka, va, tables, lens, None, (k1, v1)), 3, 3, sleep, b2b=False)[0]
    # the library yardstick attends over the already-gathered dense view
    # (the gather itself is not timed)
    kd = ka[tables.long()].reshape(B, nb * bs, H, D)[:, :n_pos]
    vd = va[tables.long()].reshape(B, nb * bs, H, D)[:, :n_pos]
    kd, vd = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
    attn_lib = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kd, vd), 5, 20, sleep, b2b=False)[0]
    row = H * D * 2                                   # bytes per K or V row
    attn_bytes = (2 * B * n_pos * row                 # live K and V rows
                  + 2 * B * H * D * 2                 # q in, out
                  + B * nb * 4 + B * 4)               # tables, lens
    attn_ops = 4 * B * H * n_pos * D                  # QK and PV FMAs x 2
    del kd, vd
    L, S = 32, B
    kaL = torch.empty((L, num_blocks, 1, bs, H, D), dtype=bf, device=dev)
    vaL = torch.empty_like(kaL)
    kr, vr = arr((L, S, H, D), bf), arr((L, S, H, D), bf)
    # the tick's own rows: one tensor per layer, as the layers made them
    k_layers = [arr((S, H, D), bf) for _ in range(L)]
    v_layers = [arr((S, H, D), bf) for _ in range(L)]
    w = tables[:, 64].contiguous()
    o = torch.full((S,), n_pos % bs, dtype=torch.int32, device=dev)
    sc_ms, sc_b2b = time_ms(lambda: paged_k.scatter_kv_rows(
        kaL, vaL, kr, vr, w, o), 5, 20, sleep)
    sc_layers = time_ms(lambda: paged_k.scatter_kv_rows(
        kaL, vaL, k_layers, v_layers, w, o), 5, 20, sleep)
    # the parent's write of the tick: both stacks, then the stacked form
    sc_stacked_write = time_ms(lambda: paged_k.scatter_kv_rows(
        kaL, vaL, torch.stack(k_layers), torch.stack(v_layers), w, o), 5,
        20, sleep)
    # the host's time to issue each write: the kernel from the layers'
    # rows, and both stacks with the kernel from stacked rows
    sc_issue = issue_us(lambda: paged_k.scatter_kv_rows(
        kaL, vaL, k_layers, v_layers, w, o),
        {"layers": contextlib.nullcontext}, sleep)["layers"]
    sc_stack_issue = issue_us(lambda: paged_k.scatter_kv_rows(
        kaL, vaL, torch.stack(k_layers), torch.stack(v_layers), w, o),
        {"stacked": contextlib.nullcontext}, sleep)["stacked"]
    sc_plain = time_ms(lambda: ref.scatter_kv_rows(kaL, vaL, kr, vr, w, o),
                       3, 5, sleep, b2b=False)[0]
    idx = (torch.arange(L, device=dev)[:, None], w.long()[None, :],
           torch.zeros((1, 1), dtype=torch.long, device=dev),
           o.long()[None, :])
    sc_lib = time_ms(lambda: (kaL.index_put_(idx, kr),
                              vaL.index_put_(idx, vr)), 5, 20, sleep,
                     b2b=False)[0]
    sc_bytes = 2 * 2 * L * S * row + 2 * S * 4        # rows in + out, ids
    del kaL, vaL, k_layers, v_layers
    torch.cuda.empty_cache()
    splits, bps = paged_k.paged_split_plan(nb, bs)
    timing = {
        "paged_decode_attention": {
            "shape": f"q ({B}, {H}, {D}) bf16, {n_pos} positions per lane, "
                     f"bs {bs}, tables ({B}, {nb}), splice on",
            "splits": splits, "blocks_per_split": bps,
            "ctas": H * B * splits, "combine_ctas": B * H if splits > 1
            else 0, "split_sweep": sweep,
            "ptxas": ptxas_of("paged_attn", "paged_attn_kernel",
                              "nv_bfloat16")
            + ptxas_of("paged_attn", "combine_states_kernel", "nv_bfloat16"),
            "ms": attn_ms, "back_to_back_ms": attn_b2b, "plain_ms": attn_plain,
            "library_ms": attn_lib,
            "library": "F.scaled_dot_product_attention on the gathered "
                       "dense view (gather not timed)",
            "bytes_ms": attn_bytes / PEAK_BYTES_PER_S * 1e3,
            "ops_ms": attn_ops / F32_FLOPS * 1e3},
        "scatter_kv_rows": {
            "shape": f"arenas ({L}, {num_blocks}, 1, {bs}, {H}, {D}) bf16, "
                     f"rows {L} x ({S}, {H}, {D}), one tensor per layer",
            "ms": sc_layers[0], "back_to_back_ms": sc_layers[1],
            "stacked_rows_ms": sc_ms, "stacked_rows_back_to_back_ms": sc_b2b,
            "stack_and_scatter_ms": sc_stacked_write[0],
            "stack_and_scatter_back_to_back_ms": sc_stacked_write[1],
            "host_issue_us": sc_issue,
            "stack_and_scatter_host_issue_us": sc_stack_issue,
            "plain_ms": sc_plain,
            "library_ms": sc_lib,
            "library": "index_put_ on the K and V arenas",
            "bytes_ms": sc_bytes / PEAK_BYTES_PER_S * 1e3, "ops_ms": 0.0}}
    for t in timing.values():
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] else \
            "operations"
    emit({"phase": "paged_kernel_checks", "checks": len(checks),
          "failed": bad, "max_abs_err": err, "timing": timing})
    if bad:
        raise SystemExit(f"paged kernel disagrees with its plain version: "
                         f"{bad}")
    return err, timing


def cascade_kernel_checks(dev, gen, sleep: int) -> tuple[dict, dict]:
    """Phase 3 for the cascade kernels.  Returns (max_abs_err, timing) per
    kernel; raises SystemExit when a kernel disagrees with its plain
    version."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attn as paged_k
    from repro_torch.kernels import ref
    from repro_torch.nn import attention

    def arr(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    i32 = dict(dtype=torch.int32, device=dev)
    # "cascade_vs_flat" is the whole cascade against flat attention, kept
    # apart from the kernels' own errors
    err = {name: 0.0 for name in CASCADE + ("cascade_vs_flat",)}
    checks = []

    def check(name, got, want, tol, **case):
        e = max(float((g - w).abs().max()) for g, w in zip(got, want))
        err[name] = max(err[name], e)
        checks.append({"kernel": name, **case, "max_abs_err": e,
                       "ok": all(torch.allclose(g, w, rtol=tol, atol=tol)
                                 for g, w in zip(got, want))})

    def fused(prefix, meta, suffix, win, q0, nk, tol, **case):
        """The suffix pass with the merge fused in, on the prefix states
        ``prefix`` (group layout): bit for bit the three-launch composition
        (the state, the placed group states, the standalone merge, the
        cast), and within ``tol`` of its plain version; one wrapper call
        and one fused merge.  Returns the fused output."""
        wrap = paged_k.paged_decode_attention_with_state
        counts = (wrap.launches, wrap.fused_merges)
        got = wrap(*suffix, window=win, q0=q0, new_kv=nk,
                   prefix=prefix + (meta["lane_slot"],))
        ok_counts = (wrap.launches, wrap.fused_merges) == \
            (counts[0] + 1, counts[1] + 1)
        state = wrap(*suffix, window=win, q0=q0, new_kv=nk)
        B = suffix[0].shape[0]
        comp = paged_k.merge_attn_states(
            *attention.place_group_states(meta, *prefix, B), *state
        ).to(got.dtype)
        plain = ref.paged_decode_attention_merged(
            *suffix, win, q0, nk, prefix + (meta["lane_slot"],))
        torch.cuda.synchronize()
        bitwise = torch.equal(got, comp)
        checks.append({"kernel": "merge_attn_states", "fused": True, **case,
                       "bitwise_composition": bitwise,
                       "ok": bitwise and ok_counts
                       and not bool(torch.isnan(got).any())})
        check("merge_attn_states", (got.float(),), (plain.float(),), tol,
              fused=True, vs="plain", **case)
        return got


    # tests/test_cascade.py's fixture at 16-token blocks and full-width
    # heads: lanes 0-2 share a 3-block prefix (lane 1 ends 3 positions past
    # it, so window 8 clips into the prefix; window 2 empties every prefix
    # state), lane 3 is ungrouped, lane 4 ends exactly at the prefix (an
    # empty suffix), group slots 5-7 are padding, and the trash block holds
    # NaN
    bs, q0 = 16, 48
    meta = {"group_tables": torch.tensor([[1, 2, 3, 0]], **i32),
            "group_len": torch.tensor([q0], **i32),
            "group_lanes": torch.tensor([[0, 1, 2, 4, 0, 0, 0, 0]], **i32),
            "group_mask": torch.tensor([[1, 1, 1, 1, 0, 0, 0, 0]],
                                       device=dev) != 0,
            "lane_q0": torch.tensor([q0, q0, q0, 0, q0], **i32),
            "suffix_tables": torch.tensor(
                [[10, 11, 0, 0], [12, 0, 0, 0], [13, 14, 15, 0],
                 [4, 5, 6, 7], [16, 0, 0, 0]], **i32)}
    flat_tables = torch.tensor([[1, 2, 3, 10, 11, 0], [1, 2, 3, 12, 0, 0],
                                [1, 2, 3, 13, 14, 15], [4, 5, 6, 7, 0, 0]],
                               **i32)
    cl = torch.tensor([q0 + 22, q0 + 3, q0 + 40, 50, q0], **i32)
    meta = attention.with_lane_meta(meta, cl)
    lanes = meta["group_lanes"].long()
    for label, Hq, Hkv in (("MHA", 32, 32), ("GQA 4:1", 32, 8)):
        for dtype in (torch.float32, torch.bfloat16):
            tol = 2e-5 if dtype == torch.float32 else 2e-2
            q = arr((5, Hq, 80), dtype)
            ka, va = arr((25, bs, Hkv, 80), dtype), arr((25, bs, Hkv, 80),
                                                        dtype)
            nk = (arr((5, Hkv, 80), dtype), arr((5, Hkv, 80), dtype))
            for window, plan in itertools.product(
                    (0, 8, 2), paged_k.CASCADE_FORCED_PLANS):
                with cascade_plan(plan):
                    case = {"case": label, "dtype": str(dtype),
                            "window": window, "plan": plan, "splits": [
                                paged_k.cascade_split_plan(1, Hkv, 4, bs)[0],
                                paged_k.cascade_split_plan(5, Hkv, 4, bs)[0]]}
                    states = {}
                    for trash in (1e9, float("nan")):
                        ka[0], va[0] = trash, -trash
                        pre = (q[lanes].contiguous(), ka, va,
                               meta["group_tables"], meta["group_len"],
                               cl[lanes].contiguous())
                        suf = (q, ka, va, meta["suffix_tables"], cl)
                        got_p = paged_k.cascade_prefix_attention(*pre,
                                                                 window=window)
                        got_s = paged_k.paged_decode_attention_with_state(
                            *suf, window=window, q0=meta["lane_q0"], new_kv=nk)
                        states[trash != trash] = got_p + got_s
                    want_p = ref.cascade_prefix_attention(*pre, window)
                    want_s = ref.paged_decode_attention_with_state(
                        *suf, window, meta["lane_q0"], nk)
                    torch.cuda.synchronize()
                    check("cascade_prefix_attention", got_p, want_p, tol,
                          **case)
                    check("paged_decode_attention_with_state", got_s, want_s,
                          tol, **case)
                    checks.append({
                        "kernel": "cascade", **case, "nan_trash_bitwise": True,
                        "ok": all(torch.equal(a, b) for a, b in
                                  zip(states[False], states[True]))})
                    # lane 4's suffix is empty: the empty state, exactly
                    acc, m, l = got_s
                    checks.append({
                        "kernel": "paged_decode_attention_with_state", **case,
                        "empty_state_exact": True,
                        "ok": bool((acc[4] == 0).all() and (l[4] == 0).all()
                                   and (m[4] == ref.NEG_INF).all())
                        and all(torch.equal(g[4], w[4])
                                for g, w in zip(got_s, want_s))})
                    # the merge against its plain version on the states the
                    # cascade hands it, and the whole cascade against flat
                    # attention over lanes 0-3 (the plain flat version gets a
                    # clean trash block, since it multiplies those rows by 0)
                    states = attention.place_group_states(meta, *got_p, 5) + \
                        got_s
                    check("merge_attn_states",
                          (paged_k.merge_attn_states(*states),),
                          (ref.merge_attn_states(*states),), 2e-5, **case)
                    # the merge fused into the suffix pass: padded slots,
                    # lane 3 in no group, lane 4's empty suffix, window 2's
                    # empty prefixes; then lane 3 at length 0, both sides
                    # empty, exactly 0
                    fused(got_p, meta, suf, window, meta["lane_q0"], nk, tol,
                          **case)
                    cl0 = cl.clone()
                    cl0[3] = 0
                    out0 = fused(got_p, meta, (q, ka, va,
                                               meta["suffix_tables"], cl0),
                                 window, meta["lane_q0"], nk, tol,
                                 lane_3="both sides empty", **case)
                    checks.append({"kernel": "merge_attn_states",
                                   "fused": True, **case,
                                   "both_sides_empty_exactly_0": True,
                                   "ok": bool((out0[3] == 0).all())})
                    out = attention.attend_decode_cascade(
                        q[:, None], ka, va, meta, cl, window=window, new_kv=nk)
                    ka[0], va[0] = 0, 0
                    flat = ref.paged_decode_attention(
                        q[:4], ka, va, flat_tables, cl[:4], window,
                        (nk[0][:4], nk[1][:4]))
                    check("cascade_vs_flat", (out[:4, 0].float(),),
                          (flat.float(),), tol, **case)
    # the merge against its plain version, and an empty side exactly
    B, Hq, D = 8, 32, 80

    def state():
        return (arr((B, Hq, D), torch.float32), arr((B, Hq), torch.float32),
                torch.rand((B, Hq), generator=gen, device=dev) + 0.5)
    a, b = state(), state()
    e = (torch.zeros_like(a[0]), torch.full_like(a[1], ref.NEG_INF),
         torch.zeros_like(a[2]))
    check("merge_attn_states", (paged_k.merge_attn_states(*a, *b),),
          (ref.merge_attn_states(*a, *b),), 2e-5, case="two states")
    for label, args in (("empty first", e + b), ("empty second", a + e),
                        ("both empty", e + e)):
        got = paged_k.merge_attn_states(*args)
        checks.append({"kernel": "merge_attn_states", "case": label,
                       "exact": True,
                       "ok": torch.equal(got, ref.merge_attn_states(*args))
                       and not bool(torch.isnan(got).any())})

    # load (c)'s shapes with the trash block NaN: one group of 8 lanes over
    # a 64-block chain (eight 128-position chunks of the prefix kernel, so
    # the rescale between chunks runs), suffixes of 1 to 128 positions in
    # 8-entry trash-padded tables (the last lane reads all eight blocks),
    # windows 0, 700 (clipping inside the chain) and 2
    H, Lc, npre, nsuf = 32, LM_SLOTS, SHARED_PROMPT // LM_BLOCK, 8
    num_blocks = LM_SLOTS * (LM_MAX_LEN // LM_BLOCK) + 1
    perm = (torch.randperm(num_blocks - 1, generator=gen, device=dev) + 1
            ).to(torch.int32)
    suf = torch.tensor([1, 16, 17, 40, 64, 96, 127, 128], **i32)
    lens = SHARED_PROMPT + suf
    st = perm[npre:npre + Lc * nsuf].reshape(Lc, nsuf).clone()
    st[torch.arange(nsuf, device=dev)[None] * LM_BLOCK >= suf[:, None]] = 0
    gt = perm[:npre][None].contiguous()
    big = attention.with_lane_meta(
        {"group_tables": gt, "group_len": torch.tensor([SHARED_PROMPT], **i32),
         "group_lanes": torch.arange(Lc, **i32)[None],
         "group_mask": torch.ones((1, Lc), dtype=torch.bool, device=dev),
         "lane_q0": torch.full((Lc,), SHARED_PROMPT, **i32),
         "suffix_tables": st}, lens)
    flat_tables = torch.cat([gt.expand(Lc, -1), st], 1)
    for dtype in (torch.float32, torch.bfloat16):
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        q = arr((Lc, H, D), dtype)
        ka = arr((num_blocks, LM_BLOCK, H, D), dtype)
        va = arr((num_blocks, LM_BLOCK, H, D), dtype)
        nk = (arr((Lc, H, D), dtype), arr((Lc, H, D), dtype))
        for window, plan in itertools.product((0, 700, 2),
                                              paged_k.CASCADE_FORCED_PLANS):
            with cascade_plan(plan):
                case = {"case": "load (c) shapes", "dtype": str(dtype),
                        "window": window, "plan": plan, "splits": [
                            paged_k.cascade_split_plan(1, H, npre,
                                                       LM_BLOCK)[0],
                            paged_k.cascade_split_plan(Lc, H, nsuf,
                                                       LM_BLOCK)[0]]}
                pre = (q[big["group_lanes"]], ka, va, gt, big["group_len"],
                       big["lane_lens"])
                sfx = (q, ka, va, st, lens)
                got = {}
                for trash in (1e9, float("nan")):
                    ka[0], va[0] = trash, -trash
                    got[trash != trash] = (
                        paged_k.cascade_prefix_attention(*pre, window=window),
                        paged_k.paged_decode_attention_with_state(
                            *sfx, window=window, q0=big["lane_q0"],
                            new_kv=nk))
                got_p, got_s = got[True]
                want_p = ref.cascade_prefix_attention(*pre, window)
                want_s = ref.paged_decode_attention_with_state(
                    *sfx, window, big["lane_q0"], nk)
                check("cascade_prefix_attention", got_p, want_p, tol, **case)
                check("paged_decode_attention_with_state", got_s, want_s,
                      tol, **case)
                checks.append({
                    "kernel": "cascade", **case, "nan_trash_bitwise": True,
                    "ok": all(torch.equal(a, b) for a, b in
                              zip(sum(got[False], ()), got_p + got_s))})
                # the rows that attend no position: exactly the empty state
                empty = [w[1] == ref.NEG_INF for w in (want_p, want_s)]
                checks.append({
                    "kernel": "cascade", **case, "empty_state_exact": True,
                    "empty_rows": [int(e.sum()) for e in empty],
                    "ok": all(torch.equal(g[e], w[e])
                              for got_x, want_x, e in zip(
                                  (got_p, got_s), (want_p, want_s), empty)
                              for g, w in zip(got_x, want_x))})
                states = attention.place_group_states(big, *got_p, Lc) + got_s
                check("merge_attn_states",
                      (paged_k.merge_attn_states(*states),),
                      (ref.merge_attn_states(*states),), 2e-5, **case)
                fused(got_p, big, sfx, window, big["lane_q0"], nk, tol,
                      **case)
                out = attention.attend_decode_cascade(
                    q[:, None], ka, va, big, lens, window=window, new_kv=nk)
                ka[0], va[0] = 0, 0
                flat = ref.paged_decode_attention(q, ka, va, flat_tables, lens,
                                                  window, nk)
                check("cascade_vs_flat", (out[:, 0].float(),), (flat.float(),),
                      tol, **case)
        del q, ka, va, nk
    # groups whose queries overflow one CTA's shared memory, swept in tiles
    # of queries: 64 stablelm-3b lanes (MHA, D = 80), and 16 lanes at GQA
    # 8:1 and D = 128 (deepseek-67b's attention), each over a 128-position
    # chain ending 5 short of its last block, at its plan, windows 0 and
    # 100 (lanes ending up to 63 positions past the chain)
    # The fused suffix pass on the same groups: each lane's suffix from q0
    # = the chain's length, up to 63 positions in 4-entry tables of its
    # own blocks, at every forced plan
    for label, Lg, Hqg, Hkg, Dg in (("64 lanes, MHA D=80", 64, 32, 32, 80),
                                  ("16 lanes, GQA 8:1 D=128", 16, 64, 8,
                                   128)):
        gt = torch.arange(1, 9, **i32)[None]
        glen = torch.tensor([8 * LM_BLOCK - 5], **i32)
        ll = glen + torch.randint(0, 64, (1, Lg), generator=gen, device=dev,
                                  dtype=torch.int32)
        grp = attention.with_lane_meta(
            {"group_lanes": torch.arange(Lg, **i32)[None],
             "group_mask": torch.ones((1, Lg), dtype=torch.bool, device=dev)},
            ll[0])
        st = torch.arange(9, 9 + 4 * Lg, **i32).reshape(Lg, 4)
        q0g = glen.expand(Lg).contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            tol = 2e-5 if dtype == torch.float32 else 2e-2
            qg = arr((1, Lg, Hqg, Dg), dtype)
            ka, va = arr((9 + 4 * Lg, LM_BLOCK, Hkg, Dg), dtype), \
                arr((9 + 4 * Lg, LM_BLOCK, Hkg, Dg), dtype)
            nkg = (arr((Lg, Hkg, Dg), dtype), arr((Lg, Hkg, Dg), dtype))
            for window in (0, 100):
                pre = (qg, ka, va, gt, glen, ll)
                got_p = paged_k.cascade_prefix_attention(*pre, window=window)
                check("cascade_prefix_attention", got_p,
                      ref.cascade_prefix_attention(*pre, window), tol,
                      case=label, dtype=str(dtype), window=window,
                      smem_bytes=paged_k._cascade_lib()
                      .cascade_prefix_smem_bytes(Lg, Hqg // Hkg, Dg,
                                                 paged_k.DTYPES[dtype]))
                for plan in paged_k.CASCADE_FORCED_PLANS:
                    with cascade_plan(plan):
                        fused(got_p, grp, (qg[0], ka, va, st, ll[0]),
                              window, q0g, nkg, tol, case=label,
                              dtype=str(dtype), window=window, plan=plan,
                              splits=paged_k.cascade_split_plan(
                                  Lg, Hkg, 4, LM_BLOCK)[0])
    torch.cuda.empty_cache()
    bad = [c for c in checks if not c["ok"]]

    # timing at load (c)'s last tick, bf16: one group of Lc = 8 lanes over a
    # 64-block chain (1,024 positions), each lane 1,120 long, so its suffix
    # is 96 positions in an 8-entry suffix table from q0 = 1,024
    H, D, Lc, n_pre, n_len = 32, 80, 8, SHARED_PROMPT, 1120
    n_suf = n_len - n_pre
    num_blocks = LM_SLOTS * (LM_MAX_LEN // LM_BLOCK) + 1
    bf = torch.bfloat16
    ka, va = arr((num_blocks, LM_BLOCK, H, D), bf), \
        arr((num_blocks, LM_BLOCK, H, D), bf)
    perm = (torch.randperm(num_blocks - 1, generator=gen, device=dev) + 1
            ).to(torch.int32)
    npre, nsuf = n_pre // LM_BLOCK, 8
    gt = perm[:npre][None].contiguous()
    st = perm[npre:npre + Lc * nsuf].reshape(Lc, nsuf).contiguous()
    glen = torch.tensor([n_pre], **i32)
    lens = torch.full((Lc,), n_len, **i32)
    q0s = torch.full((Lc,), n_pre, **i32)
    q = arr((Lc, H, D), bf)
    qg = q[None].contiguous()
    ll = lens[None].contiguous()
    nk = (arr((Lc, H, D), bf), arr((Lc, H, D), bf))
    row = H * D * 2                                   # bytes per K or V row
    timing = {}
    # each pass at its plan, at one split and at more splits: the kernel's
    # time and the host's time to issue one call (plan, scratch, launches),
    # the plans in turns; at its plan, the device time by kernel (the pass
    # and its combine)
    plans = {key: functools.partial(cascade_plan, key)
             for key in TIMING_PLANS}

    def prefix():
        return paged_k.cascade_prefix_attention(qg, ka, va, gt, glen, ll)

    def suffix():
        return paged_k.paged_decode_attention_with_state(
            q, ka, va, st, lens, q0=q0s, new_kv=nk)

    def at_plans(fn, rows, nb, ctas) -> dict:
        host = issue_us(fn, plans, sleep)
        out = {}
        for key, plan in plans.items():
            with plan():
                splits, bps = paged_k.cascade_split_plan(rows, H, nb,
                                                         LM_BLOCK)
                out[key] = {"splits": splits, "blocks_per_split": bps,
                            "ctas": ctas * splits,
                            "combine_ctas": Lc * H if splits > 1 else 0,
                            "ms": time_ms(fn, 5, 20, sleep, b2b=False)[0],
                            "host_issue_us": host[key]}
        return {**{k: v for k, v in out["planned"].items() if k != "ms"},
                "plans": out, "device_us_by_kernel": device_us(fn)}
    pre_ms = time_ms(prefix, 5, 20, sleep)
    kd = ka[gt.long()].reshape(1, -1, H, D)[:, :n_pre].transpose(1, 2)
    vd = va[gt.long()].reshape(1, -1, H, D)[:, :n_pre].transpose(1, 2)
    kd, vd = kd.contiguous(), vd.contiguous()
    timing["cascade_prefix_attention"] = {
        "shape": f"qg (1, {Lc}, {H}, {D}) bf16, {n_pre}-position chain, "
                 f"group_tables (1, {npre}), lane_lens {n_len}",
        **at_plans(prefix, 1, npre, H),
        "ptxas": ptxas_of("cascade_attn", "cascade_prefix_kernel")
        + ptxas_of("cascade_attn", "combine_states_kernelIf"),
        "sass": sass_counts("cascade_attn", ("LDGSTS", "HMMA")),
        "ms": pre_ms[0], "back_to_back_ms": pre_ms[1],
        "plain_ms": time_ms(lambda: ref.cascade_prefix_attention(
            qg, ka, va, gt, glen, ll), 3, 3, sleep, b2b=False)[0],
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(0, 1)[None], kd, vd), 5, 20, sleep, b2b=False)[0],
        "library": "F.scaled_dot_product_attention of the 8 queries on the "
                   "gathered chain (normalized output only; gather not "
                   "timed)",
        "bytes_ms": (2 * n_pre * row + Lc * H * D * 2 + Lc * H * (D + 2) * 4
                     + 4 * (npre + 1 + Lc)) / PEAK_BYTES_PER_S * 1e3,
        "ops_ms": 4 * Lc * H * n_pre * D / F32_FLOPS * 1e3}
    suf_ms = time_ms(suffix, 5, 20, sleep)
    ks = ka[st.long()].reshape(Lc, -1, H, D)[:, :n_suf].transpose(1, 2)
    vs = va[st.long()].reshape(Lc, -1, H, D)[:, :n_suf].transpose(1, 2)
    ks, vs = ks.contiguous(), vs.contiguous()
    timing["paged_decode_attention_with_state"] = {
        "shape": f"q ({Lc}, {H}, {D}) bf16, {n_suf} suffix positions per "
                 f"lane from q0 {n_pre}, tables ({Lc}, {nsuf}), splice on",
        **at_plans(suffix, Lc, nsuf, H * Lc),
        "ptxas": ptxas_of("paged_attn", "paged_attn_kernel", "nv_bfloat16")
        + ptxas_of("paged_attn", "combine_states_kernelIf"),
        "ms": suf_ms[0], "back_to_back_ms": suf_ms[1],
        "plain_ms": time_ms(lambda: ref.paged_decode_attention_with_state(
            q, ka, va, st, lens, None, q0s, nk), 3, 3, sleep, b2b=False)[0],
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], ks, vs), 5, 20, sleep, b2b=False)[0],
        "library": "F.scaled_dot_product_attention on the gathered suffix "
                   "(normalized output only; gather not timed)",
        "bytes_ms": (2 * Lc * n_suf * row + Lc * H * D * 2
                     + Lc * H * (D + 2) * 4 + 4 * (Lc * nsuf + 2 * Lc))
        / PEAK_BYTES_PER_S * 1e3,
        "ops_ms": 4 * Lc * H * n_suf * D / F32_FLOPS * 1e3}
    # kernel 5 where its plan splits: agent lanes with 1,024-token own tails
    # after the shared prompt (tables (8, 64), 1,024 suffix positions each)
    nlong = 64
    stl = perm[npre:npre + Lc * nlong].reshape(Lc, nlong).contiguous()
    lens_l = torch.full((Lc,), n_pre + nlong * LM_BLOCK, **i32)

    def long_suffix():
        return paged_k.paged_decode_attention_with_state(
            q, ka, va, stl, lens_l, q0=q0s, new_kv=nk)
    timing["paged_decode_attention_with_state"]["long_suffix"] = {
        "shape": f"q ({Lc}, {H}, {D}) bf16, {nlong * LM_BLOCK} suffix "
                 f"positions per lane from q0 {n_pre}, tables ({Lc}, "
                 f"{nlong}), splice on",
        **at_plans(long_suffix, Lc, nlong, H * Lc),
        "bytes_ms": (2 * Lc * nlong * LM_BLOCK * row + Lc * H * D * 2
                     + Lc * H * (D + 2) * 4 + 4 * (Lc * nlong + 2 * Lc))
        / PEAK_BYTES_PER_S * 1e3}
    # kernel 6 at a group too large for one CTA's shared memory: 64 lanes
    # over the same chain, swept in tiles of queries
    qg64 = arr((1, 64, H, D), bf)
    ll64 = torch.full((1, 64), n_len, **i32)
    big_ms = time_ms(lambda: paged_k.cascade_prefix_attention(
        qg64, ka, va, gt, glen, ll64), 5, 20, sleep)
    timing["cascade_prefix_attention"]["large_group"] = {
        "shape": f"qg (1, 64, {H}, {D}) bf16, {n_pre}-position chain",
        "splits": paged_k.cascade_split_plan(1, H, npre, LM_BLOCK)[0],
        "smem_bytes": paged_k._cascade_lib().cascade_prefix_smem_bytes(
            64, 1, D, paged_k.DTYPES[bf]),
        "ms": big_ms[0],
        "bytes_ms": (2 * n_pre * row + 64 * H * D * 2
                     + 64 * H * (D + 2) * 4 + 4 * (npre + 1 + 64))
        / PEAK_BYTES_PER_S * 1e3,
        "ops_ms": 4 * 64 * H * n_pre * D / F32_FLOPS * 1e3}
    a, b = state(), state()
    mg_ms = time_ms(lambda: paged_k.merge_attn_states(*a, *b), 5, 20, sleep)
    # the merge as the tick runs it: in the suffix pass's epilogue, on the
    # prefix pass's states of the 8 lanes; its cost is what the fused call
    # takes beyond the state alone, the two timed in turns
    pstates = prefix() + (torch.arange(Lc, **i32),)

    def suffix_merged():
        return paged_k.paged_decode_attention_with_state(
            q, ka, va, st, lens, q0=q0s, new_kv=nk, prefix=pstates)
    state_ms, merged_ms = [], []
    for _ in range(3):
        state_ms.append(time_ms(suffix, 5, 20, sleep, b2b=False)[0])
        merged_ms.append(time_ms(suffix_merged, 5, 20, sleep, b2b=False)[0])
    fused_ms = {"ms": statistics.median(merged_ms)
                - statistics.median(state_ms),
                "with_prefix_ms": statistics.median(merged_ms),
                "state_ms": statistics.median(state_ms),
                "ms_runs": {"with_prefix": merged_ms, "state": state_ms},
                "host_issue_us": issue_us(
                    suffix_merged, {"planned": contextlib.nullcontext},
                    sleep)["planned"],
                "device_us_by_kernel": device_us(suffix_merged)}
    timing["merge_attn_states"] = {
        "shape": f"2 x (acc ({B}, {Hq}, {D}), m, l ({B}, {Hq})) float32; "
                 f"fused: the suffix pass at load (c)'s last tick with the "
                 f"prefix states of its {Lc} lanes",
        "ms": fused_ms["ms"], "fused": fused_ms,
        "fused_into": "paged_decode_attention_with_state",
        "standalone_ms": mg_ms[0], "back_to_back_ms": mg_ms[1],
        "plain_ms": time_ms(lambda: ref.merge_attn_states(*a, *b), 3, 5,
                            sleep, b2b=False)[0],
        "library_ms": None,
        "bytes_ms": 4 * (3 * B * Hq * D + 4 * B * Hq) / PEAK_BYTES_PER_S
        * 1e3,
        "ops_ms": 8 * B * Hq * D / F32_FLOPS * 1e3}
    del ka, va, kd, vd, ks, vs, pstates
    torch.cuda.empty_cache()
    for t in timing.values():
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] else \
            "operations"
    emit({"phase": "cascade_kernel_checks", "checks": len(checks),
          "failed": bad, "max_abs_err": err, "timing": timing})
    if bad:
        raise SystemExit(f"cascade kernel disagrees with its plain version: "
                         f"{bad}")
    return err, timing


def flash_kernel_checks(dev, gen, sleep: int) -> tuple[dict, dict]:
    """Phase 3 for ``flash_attention``: the kernel against its plain
    version (and the TPU kernel's oracle on its own cases) within 2e-5
    float32 / 2e-2 bfloat16, a repeated call bitwise, and the timing at the
    fold chunk and the one-shot prefill.  Returns (max_abs_err, timing);
    raises SystemExit when the kernel disagrees."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as flash_k
    from repro_torch.kernels import ref

    def arr(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    err = 0.0
    checks = []

    def check(got, want, dtype, **case):
        nonlocal err
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        e = float((got.float() - want.float()).abs().max())
        err = max(err, e)
        checks.append({**case, "dtype": str(dtype), "max_abs_err": e,
                       "ok": torch.allclose(got.float(), want.float(),
                                            rtol=tol, atol=tol)})

    # the TPU kernel's cases (tests/test_flash_kernel.py), (BH, S, D)
    for BH, S, D, causal, dtype in (
            (4, 256, 64, True, torch.float32),
            (2, 256, 128, False, torch.float32),
            (8, 512, 64, True, torch.bfloat16),
            (1, 128, 64, True, torch.float32),
            (3, 384, 128, True, torch.bfloat16)):
        q, k, v = (arr((BH, S, D), dtype) for _ in range(3))
        got = flash_k.flash_attention(q, k, v, causal=causal)
        case = {"case": f"pallas ({BH}, {S}, {D})", "causal": causal}
        check(got, ref.flash_attention_chunked(
            q[:, :, None], k[:, :, None], v[:, :, None], causal)[:, :, 0],
            dtype, **case)
        check(got, ref.flash_attention(q, k, v, causal), dtype,
              vs="oracle", **case)
    # the fold's chunks (16 and a partial 7 at offsets 0, 512 and 1,072),
    # one-shot prefill at 1,000, and a window of 8 with GQA 4:1, at
    # stablelm-3b's 32 heads of 80 (8:2 heads for the GQA case)
    shapes = [(sq, off, 32, 32, 0) for sq in (16, 7) for off in (0, 512, 1072)]
    shapes += [(1000, 0, 32, 32, 0), (40, 24, 8, 2, 8), (16, 1072, 8, 2, 8)]
    for Sq, off, Hq, Hkv, window in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            q = arr((1, Sq, Hq, 80), dtype)
            k, v = arr((1, off + Sq, Hkv, 80), dtype), \
                arr((1, off + Sq, Hkv, 80), dtype)
            got = flash_k.flash_attention(q, k, v, window=window,
                                          q_offset=off)
            again = flash_k.flash_attention(q, k, v, window=window,
                                            q_offset=off)
            check(got, ref.flash_attention_chunked(q, k, v, True, window,
                                                   off), dtype,
                  case=f"Sq {Sq}, Sk {off + Sq}, q_offset {off}, "
                       f"heads {Hq}:{Hkv}, window {window}")
            checks.append({"case": f"Sq {Sq}, q_offset {off} repeated",
                           "dtype": str(dtype), "bitwise": True,
                           "ok": torch.equal(got, again)})
    # forced splits of the key band (the planner's MIN_CTAS patched: 0
    # keeps the band whole, 1 << 30 splits it one tile per CTA): fold
    # chunks at offsets 0, 512 and 1,072 in one split and in one tile per
    # split; a causal 200-query prompt split per tile (its last splits hold
    # no key of the early rows); a window of 8 with GQA 4:1 split per tile
    # (rows whose window lies wholly in the other split)
    forced = [(16, off, 32, 32, 0, n) for off in (0, 512, 1072)
              for n in (0, 1 << 30)]
    forced += [(200, 0, 8, 8, 0, 1 << 30), (64, 256, 8, 2, 8, 1 << 30)]
    for (Sq, off, Hq, Hkv, window, min_ctas), dtype in (
            (f, dt) for f in forced for dt in (torch.float32, torch.bfloat16)):
        with mock.patch.object(flash_k, "MIN_CTAS", min_ctas):
            splits = flash_k.flash_split_plan(1, Sq, off + Sq, Hq, off,
                                              window)[0]
            q = arr((1, Sq, Hq, 80), dtype)
            k, v = arr((1, off + Sq, Hkv, 80), dtype), \
                arr((1, off + Sq, Hkv, 80), dtype)
            got = flash_k.flash_attention(q, k, v, window=window,
                                          q_offset=off)
            again = flash_k.flash_attention(q, k, v, window=window,
                                            q_offset=off)
            case = (f"forced split: Sq {Sq}, q_offset {off}, heads "
                    f"{Hq}:{Hkv}, window {window}, splits {splits}")
            check(got, ref.flash_attention_chunked(q, k, v, True, window,
                                                   off), dtype, case=case)
            checks.append({"case": case + " repeated", "dtype": str(dtype),
                           "bitwise": True, "ok": torch.equal(got, again)})
    torch.cuda.synchronize()
    bad = [c for c in checks if not c["ok"]]

    # timing, bf16, 32 heads of 80: a fold chunk (16 queries at 1,072
    # into 1,088 keys) and the one-shot prefill of a 1,000-token prompt
    H, D, bf = 32, 80, torch.bfloat16
    timing = {}
    for label, Sq, off in (("fold_chunk", 16, 1072), ("oneshot", 1000, 0)):
        Sk = off + Sq
        q, k, v = arr((1, Sq, H, D), bf), arr((1, Sk, H, D), bf), \
            arr((1, Sk, H, D), bf)
        def flash():
            return flash_k.flash_attention(q, k, v, q_offset=off)
        ms, b2b = time_ms(flash, 5, 20, sleep)
        splits = flash_k.flash_split_plan(1, Sq, Sk, H, off, None)[0]
        # a split plan beside the band kept whole (no scratch, no combine
        # launch): the kernel's time and the host's time to issue one call
        whole_band = functools.partial(mock.patch.object, flash_k,
                                       "MIN_CTAS", 0)
        host = issue_us(flash, {"plan": contextlib.nullcontext,
                                "whole": whole_band}, sleep)
        whole = None
        if splits > 1:
            with whole_band():
                whole = {"splits": 1,
                         "ms": time_ms(flash, 5, 20, sleep, b2b=False)[0],
                         "host_issue_us": host["whole"]}
        plain = time_ms(lambda: ref.flash_attention_chunked(
            q, k, v, True, None, off), 3, 3, sleep, b2b=False)[0]
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if off == 0:
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), 5, 20, sleep, b2b=False)[0]
            how = "is_causal=True"
        else:
            mask = (torch.arange(Sk, device=dev)[None, :]
                    <= off + torch.arange(Sq, device=dev)[:, None])
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask), 5, 20, sleep, b2b=False)[0]
            how = "an explicit boolean mask"
        # each input read once, the output written once; the operations of
        # the causal band this call needs (2 per multiply-add, QK and PV)
        pairs = sum(min(Sk, off + i + 1) for i in range(Sq))
        n_bytes = 2 * (2 * Sq * H * D + 2 * Sk * H * D)
        ops = 4 * H * D * pairs
        tile = flash_k.tile_q(Sq)
        timing[label] = {
            "shape": f"q (1, {Sq}, {H}, {D}) bf16 at q_offset {off}, k and "
                     f"v (1, {Sk}, {H}, {D}), causal",
            "splits": splits, "ctas": -(-Sq // tile) * H * splits,
            "warps_per_cta": tile // 16,
            "combine_ctas": Sq * H if splits > 1 else 0,
            "host_issue_us": host["plan"], "unsplit": whole,
            "ptxas": ptxas_of("flash_attn", "flash_mma_kernel",
                              f"ILi{-(-D // 16)}ELi{tile // 16}E")
            + (ptxas_of("flash_attn", "combine_states_kernel", "nv_bfloat16")
               if splits > 1 else []),
            "ms": ms, "back_to_back_ms": b2b, "plain_ms": plain,
            "library_ms": lib,
            "library": f"F.scaled_dot_product_attention with {how} on "
                       "(B, H, S, D) copies (the transpose not timed)",
            "bytes_ms": n_bytes / PEAK_BYTES_PER_S * 1e3,
            "ops_ms": ops / BF16_FLOPS * 1e3}
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    for t in timing.values():
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] else \
            "operations"
    emit({"phase": "flash_kernel_checks", "checks": len(checks),
          "failed": bad, "max_abs_err": err, "timing": timing})
    if bad:
        raise SystemExit(f"flash_attention disagrees with its plain "
                         f"version: {bad}")
    return {"flash_attention": err}, timing


class TickProbe:
    """Wraps an adapter's ``decode``: host time of each tick (it ends in the
    tokens' copy to the host, so the device work is inside) and whether
    every tick's logits were finite."""

    def __init__(self, adapter):
        self.adapter, self.inner = adapter, adapter.decode
        self.times: list[float] = []
        self.finite = True
        adapter.decode = self

    def __call__(self, tokens, active):
        import torch
        t0 = time.perf_counter()
        out = self.inner(tokens, active)
        self.times.append((time.perf_counter() - t0) * 1e3)
        self.finite &= bool(torch.isfinite(self.adapter.last_logits).all())
        return out


# the host's launch calls a profile counts: kernels one by one (through
# either CUDA entry point), and whole captured graphs
KERNEL_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernelEx")
GRAPH_LAUNCHES = ("cudaGraphLaunch",)


def host_launches(host_events, n: int, per: str) -> dict:
    """Kernel launches and graph launches the host issued per ``per`` over
    ``n`` of them, from a profile's ``key_averages()``."""
    def count(keys):
        return sum(e.count for e in host_events if e.key in keys) / n
    return {f"host_launches_per_{per}": count(KERNEL_LAUNCHES),
            f"graph_launches_per_{per}": count(GRAPH_LAUNCHES)}


def profile_ticks(batcher, n: int, tick_ms: float) -> dict:
    """Device time of ``n`` batcher steps (decode ticks, nothing to admit)
    from ``torch.profiler``: busy ms per tick, the idle share of a tick of
    ``tick_ms`` (timed without the profiler), the kernels that take the
    most device time, and on the host the kernel launches and graph
    launches per tick and the operations with the most self time.  Busy
    time is None when the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            batcher.step()
        torch.cuda.synchronize()
    dev_us = kernel_us(prof, n)
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    host_out = {
        **host_launches(host, n, "tick"),
        # stacks on the tick: the layers' K/V rows stacked before the row
        # write, where the engine does that
        "stack_ops_per_tick": sum(e.count for e in host
                                  if e.key == "aten::stack") / n,
        "top_host_self_ms_per_tick": {
            e.key[:60]: e.self_cpu_time_total / 1e3 / n for e in host[:6]}}
    if not dev_us:
        return {"device_busy_ms_per_tick": None, "device_idle_share": None,
                "top_device_ms_per_tick": None, **host_out}
    busy = sum(dev_us.values()) / 1e3

    def ms_of(*needles: str) -> float:
        return sum(us for name, us in dev_us.items()
                   if any(x in name for x in needles)) / 1e3
    # the paged sweep (kernels 3 and 5 share paged_attn_kernel, kernel 5
    # with kernel 7's merge in its epilogue) and the bf16 combines of their
    # splits; the cascade's prefix pass; the float32 combines (kernel 5's
    # and 6's split states); kernel 7's standalone merge
    # (the trace's names demangled or not)
    paged = ms_of("paged_attn_kernel", "combine_states_kernel<__nv_bfloat16",
                  "combine_states_kernelI13__nv_bfloat16")
    prefix = ms_of("cascade_prefix_kernel")
    combine_f32 = ms_of("combine_states_kernel<float",
                        "combine_states_kernelIf")
    merge = ms_of("merge_states_kernel")
    return {"device_busy_ms_per_tick": busy,
            "device_idle_share": max(0.0, 1.0 - busy / tick_ms),
            "paged_attn_ms_per_tick": paged,
            "paged_attn_share_of_busy": paged / busy if busy else None,
            "cascade_prefix_ms_per_tick": prefix,
            "cascade_prefix_share_of_busy": prefix / busy if busy else None,
            "combine_f32_ms_per_tick": combine_f32,
            "merge_ms_per_tick": merge,
            "top_device_ms_per_tick": top_ms(dev_us, 8),
            **host_out}


class CascadeProbe(TickProbe):
    """A :class:`TickProbe` that also records each tick's grouping: the
    adapter's ``cascade_stats()`` before the tick, its ``last_groups``
    after, ``tick_bytes_proxy()`` at the first tick and, under cascade,
    the metadata bucket (the shapes of the group metadata the tick's
    active lanes form, None without a group; all outside the timed
    call)."""

    def __init__(self, adapter):
        super().__init__(adapter)
        self.stats: list[dict] = []
        self.groups: list[int] = []
        self.buckets: list = []
        self.proxy = None

    def __call__(self, tokens, active):
        ad = self.adapter
        if self.proxy is None:
            self.proxy = ad.tick_bytes_proxy()
        self.stats.append(ad.cascade_stats())
        if ad.backend == "cascade":
            groups = ad._cascade_plan(
                [s for s in range(ad.n_slots)
                 if active[s] and not ad.at_capacity(s)])
            self.buckets.append(tuple(
                v.shape for v in ad._cascade_meta(groups).values())
                if groups else None)
        out = super().__call__(tokens, active)
        self.groups.append(self.adapter.last_groups)
        return out


def forced_ticks(cfg, params, prompts, forced, backends: tuple,
                 chunked: bool = False) -> dict:
    """Admit ``prompts`` into paged slots (one-shot, or through the fold
    with ``chunked``) once, give each of ``backends`` its own adapter
    holding that admission (the arena, the lane state and the host's
    paging state copied before any tick: admission does not depend on the
    tick's backend), and run one tick per row of ``forced`` tokens on
    each.  Returns per backend (first tokens, per-tick tokens, per-tick
    logits, per-tick host ms, per-tick cascade groups)."""
    import copy

    import numpy as np
    import torch

    from repro_torch.serve.gateway.slots import make_adapter

    def adapter(backend):
        return make_adapter(cfg, params, n_slots=len(prompts),
                            max_len=LM_MAX_LEN, extras=extras_of(cfg),
                            paged=True, block_size=LM_BLOCK, chunked=chunked,
                            backend=backend)
    first_ad = adapter(backends[0])
    first = [first_ad.insert(s, p, max_new=len(forced) + 1)
             for s, p in enumerate(prompts)]
    ads = {backends[0]: first_ad}
    for backend in backends[1:]:
        ad = adapter(backend)
        for key, a in first_ad.arena.items():
            ad.arena[key].copy_(a)
        for key, a in first_ad.state.items():
            ad.state[key].copy_(a)
        for name in ("tables", "lens", "slot_bids", "cow_blk", "cow_spare",
                     "partial_reg", "_stats", "pool", "_boundary_states"):
            setattr(ad, name, copy.deepcopy(getattr(first_ad, name)))
        ad.pool.on_unindex = \
            lambda bid, key, ad=ad: ad._boundary_states.pop(key, None)
        ads[backend] = ad
    out = {}
    for backend, ad in ads.items():
        probe = TickProbe(ad)
        active = np.ones(len(prompts), bool)
        toks, logits, groups = [], [], []
        for row in forced:
            toks.append(ad.decode(row, active))
            logits.append(ad.last_logits.clone())
            groups.append(ad.last_groups)
        out[backend] = (first, np.stack(toks), torch.stack(logits),
                        probe.times, groups)
    del ads, first_ad, ad
    torch.cuda.empty_cache()
    return out


def load_b_prompts(vocab: int):
    """Load (b): four 1,000-token prompts; r1 shares r0's first 512 tokens
    (a 32-block radix hit), r2 repeats r0 whole (62 full blocks + the
    partial block), r3 shares nothing.  Returns (prompts, the generator
    after them)."""
    import numpy as np
    rng = np.random.default_rng(11)
    a = rng.integers(0, vocab, 1000).astype(np.int32)
    prompts = [a, np.concatenate([a[:512], rng.integers(0, vocab, 488)]),
               a.copy(), rng.integers(0, vocab, 1000)]
    return [p.astype(np.int32) for p in prompts], rng


def load_c_prompts(vocab: int):
    """Load (c): eight prompts sharing a 1,024-token prompt, each with its
    own 64-token tail.  Returns (prompts, the generator after them)."""
    import numpy as np
    rng = np.random.default_rng(13)
    shared = rng.integers(0, vocab, SHARED_PROMPT)
    return [np.concatenate([shared, rng.integers(0, vocab, OWN_TAIL)]
                           ).astype(np.int32) for _ in range(LM_SLOTS)], rng


def aligned_prompts(vocab: int):
    """The hybrid family's one-shot comparison load: prompts of 512 and
    1,024 tokens, the lengths its one-shot prefill admits (multiples of
    hymba's ``ssm_chunk`` of 512); r1 extends r0 (a 32-block radix hit for
    the fold), r3 is r2's first 512 tokens (a hit capped one block short,
    so the fold computes the last token)."""
    import numpy as np
    rng = np.random.default_rng(23)
    a, b = rng.integers(0, vocab, 1024), rng.integers(0, vocab, 1024)
    return [p.astype(np.int32) for p in (a[:512], a, b, b[:512])]


def load_spec(backend: str, chunked: bool, new_tokens: int):
    """The ``ServeSpec`` of :func:`serve_load`'s gateways."""
    from repro_torch.serve.spec import ServeSpec
    return ServeSpec(n_slots=LM_SLOTS, max_len=LM_MAX_LEN, paged=True,
                     block_size=LM_BLOCK, chunked=chunked, backend=backend,
                     max_new_tokens=new_tokens)


def serve_load(dev, cfg, params, prompts, *, backend: str,
               chunked: bool, new_tokens: int, profile: bool = False,
               keep_blocks: bool = False, after_first=None) -> dict:
    """One load through ``make_gateway`` (8 lanes of 1,536 tokens): the
    first step admits every prompt and ticks once, four timed ticks follow,
    then (with ``profile``) three under the profiler, left out of the tick
    times, then the rest.  Keeps every tick's logits and, per request, its
    slot and its admission: host ms (ending in a synchronize), prefill
    tokens skipped, first-token logits and, with ``keep_blocks``, a copy of
    its prompt's K/V blocks taken right after the insert.  Counts every
    kernel's launches and the fold's chunks from the first step on;
    ``after_first(adapter, batcher)``, where given, runs right after the
    first step, its launches left out of the counts."""
    import torch

    from repro_torch.serve.gateway.slots import Request
    from repro_torch.serve.spec import ServeSpec, make_gateway

    gw = make_gateway(cfg, params, load_spec(backend, chunked, new_tokens),
                      extras=extras_of(cfg), device=dev)
    ad, batcher = gw.batcher.adapter, gw.batcher
    probe = CascadeProbe(ad)
    logits = []
    inner = probe.inner

    def keep(tokens, active):
        out = inner(tokens, active)
        logits.append(ad.last_logits.clone())
        return out
    probe.inner = keep
    admitted = {}
    insert = ad.insert

    def timed_insert(slot, prompt, max_new=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok = insert(slot, prompt, max_new)
        torch.cuda.synchronize()
        rec = {"ms": (time.perf_counter() - t0) * 1e3,
               "skipped": ad.slot_stats(slot)["prefill_tokens_skipped"],
               "hits": ad.slot_stats(slot)["prefix_hit_blocks"],
               "logits": ad.last_prefill_logits[0].clone()}
        if keep_blocks:
            bids = torch.tensor(ad.slot_bids[slot][:-(-len(prompt)
                                                     // LM_BLOCK)],
                                device=dev)
            rec["blocks"] = {key: a[:, bids].clone()
                             for key, a in ad.arena.items()}
            # the encdec family's cross K/V, per lane
            rec["cross"] = {key: a[:, slot].clone()
                            for key, a in ad.state.items()
                            if key in ("xk", "xv")}
        admitted[slot] = rec
        return tok
    ad.insert = timed_insert
    for i, p in enumerate(prompts):
        batcher.submit(Request(uid=i, prompt=p, max_new_tokens=new_tokens))
    reset_counts()
    chunks0 = ad.prefill_chunks_total
    t0 = time.perf_counter()
    batcher.step()
    slot = {r.uid: s for s, r in enumerate(batcher.active) if r}
    if after_first is not None:
        counts = read_counts()
        after_first(ad, batcher)
        reset_counts()
        from repro_torch import kernels
        kernels.add_counts(counts)
    for _ in range(4):
        batcher.step()
    device = profile_ticks(batcher, 3, statistics.median(
        probe.times[1:5])) if profile else None
    done = batcher.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    timed = probe.times[1:5] + probe.times[8 if profile else 5:]
    out = {"backend": backend, "chunked": chunked, "run_s": run_s,
           "ticks": len(probe.times), "tick_ms": timed, "profile": device,
           "launches": read_counts(),
           "chunks": ad.prefill_chunks_total - chunks0,
           "logits_finite": probe.finite, "logits": logits, "slot": slot,
           "prefill": {uid: admitted[s] for uid, s in slot.items()},
           "tokens": {r.uid: list(map(int, r.generated)) for r in done},
           "groups": probe.groups, "stats": probe.stats,
           "proxy": probe.proxy,
           "buckets": len({b for b in probe.buckets if b is not None}),
           "captures": {name: fn._cache_size()
                        for name, fn in ad.jit_fns().items()},
           "pool": ad.pool_stats()}
    del gw, ad, batcher, probe
    torch.cuda.empty_cache()
    return out


def first_differences(a: dict, b: dict) -> list[dict]:
    """Per request whose greedy streams in runs ``a`` and ``b`` differ: the
    first differing token k and, on the logits that chose it (the prefill's
    for k = 0, else tick k - 1's: the same history on both sides), ``b``'s
    margin for its own token over ``a``'s next to the two runs' max |logit
    difference|.  A near tie has margin <= difference <= NEAR_TIE_BOUND."""
    out = []
    for uid, ta in a["tokens"].items():
        tb = b["tokens"][uid]
        k = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y),
                 None)
        if k is None:
            continue
        if k == 0:
            la, lb = a["prefill"][uid]["logits"], b["prefill"][uid]["logits"]
        else:
            la = a["logits"][k - 1][a["slot"][uid]]
            lb = b["logits"][k - 1][b["slot"][uid]]
        la, lb = la.float(), lb.float()
        d = float((la - lb).abs().max())
        margin = float(lb.max() - lb[ta[k]])
        out.append({"uid": uid, "token": k, "b_token": tb[k],
                    "margin": margin, "max_abs_dlogit": d,
                    "near_tie": margin <= d <= NEAR_TIE_BOUND})
    return out


def lm_main_path(dev, attn_ms: float) -> tuple:
    """Phase 5: the prompt path at stablelm-3b's full width and depth.
    Returns (the paged kernels' launches, cfg, params); raises SystemExit
    on a failed check."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve.gateway.sensors import FleetConfig, SensorFleet
    from repro_torch.serve.gateway.slots import Request
    from repro_torch.serve.spec import ServeSpec, make_gateway

    # the kernels this path launches: the two paged kernels on the ticks,
    # flash_attention in every one-shot prefill
    paged = ("paged_decode_attention", "scatter_kv_rows", "flash_attention")
    sw = Stopwatch()
    cfg = configs.config("stablelm-3b")
    t0 = time.perf_counter()
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = 0
    stack = [params]
    while stack:
        for v in stack.pop().values():
            if isinstance(v, dict):
                stack.append(v)
            else:
                n_params += v.numel()
    gw = make_gateway(cfg, params, ServeSpec(
        n_slots=LM_SLOTS, max_len=LM_MAX_LEN, paged=True,
        block_size=LM_BLOCK, chunked=False), device=dev)
    ad, batcher = gw.batcher.adapter, gw.batcher
    arena_bytes = sum(a.numel() * a.element_size()
                      for a in ad.arena.values())
    fleet = SensorFleet(FleetConfig(prompt_fraction=0.125))
    trace = fleet.events(TRACE_SECONDS)
    n_prompts = sum(a.kind == "prompt" for a in trace)
    gw.warmup(fleet.cfg.prompt_lens)
    probe = TickProbe(ad)
    failures = []
    sw.lap("init")

    def count(run):
        reset_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        counts = {name: read_counts()[name] for name in paged}
        if not all(counts.values()):
            failures.append(f"a kernel of the path never launched: {counts}")
        return out, s, counts

    # (a) the seeded fleet's prompts through the gateway
    tel, run_s, counts_a = count(lambda: gw.run(trace))
    rep = tel.report(TRACE_SECONDS, kind="prompt")
    ticks_a = len(probe.times)
    if len(tel.records) + len(tel.dropped) != n_prompts or \
            not probe.finite or any(r.tokens_out != gw.max_new_tokens
                                    for r in tel.records):
        failures.append("load (a): the ledger does not account for the "
                        "trace, or a tick's logits were not finite")
    load_a = {"prompts": n_prompts, "served": len(tel.records),
              "dropped": len(tel.dropped), "ticks": ticks_a,
              "run_s": run_s, "launches": counts_a,
              "j_per_request": rep.get("j_per_inference"),
              "p50_latency_ms": rep.get("p50_latency_ms"),
              "p99_latency_ms": rep.get("p99_latency_ms"),
              "tick_ms_median": statistics.median(probe.times),
              "logits_finite": probe.finite}
    sw.lap("load_a")

    # (b) four 1,000-token requests: r1 shares r0's first 512 tokens (a
    # 32-block radix hit); r2 repeats r0 whole (62 full blocks + the shared
    # partial block, so r0 and r2 each copy it on their first write)
    prompts, rng = load_b_prompts(cfg.vocab)
    reqs = [Request(uid=1000 + i, prompt=p, max_new_tokens=32)
            for i, p in enumerate(prompts)]
    cow0 = ad.pool.cow_copies
    probe.times.clear()
    for r in reqs:
        batcher.submit(r)
    done, run_b, counts_b = count(batcher.run)
    done = {r.uid: r for r in done}
    hits = [done[r.uid].prefix_hit_blocks for r in reqs]
    cow = ad.pool.cow_copies - cow0
    same = done[1000].generated == done[1002].generated
    if hits[1] != 32 or hits[2] != 63 or cow != 2 or not same or \
            not probe.finite or any(len(done[r.uid].generated) != 32
                                    for r in reqs):
        failures.append(f"load (b): hits {hits}, cow copies {cow}, r0 == r2 "
                        f"{same}, finite {probe.finite}")
    load_b = {"requests": len(reqs), "prefix_hit_blocks": hits,
              "cow_copies": cow, "r0_equals_r2": same,
              "ticks": len(probe.times), "run_s": run_b,
              "launches": counts_b, "logits_finite": probe.finite}
    sw.lap("load_b")

    # the decode tick at 8 lanes x 1,024..1,031 positions: the first step
    # admits all 8 (prefill) and ticks once, then 4 timed ticks, then 3
    # under the profiler for the device's busy time (the profiler's own
    # host overhead stays out of the timed ticks)
    probe.times.clear()
    for i in range(LM_SLOTS):
        batcher.submit(Request(uid=2000 + i, prompt=rng.integers(
            0, cfg.vocab, 1024).astype(np.int32), max_new_tokens=9))
    for _ in range(5):
        batcher.step()
    tick_ms = statistics.median(probe.times[1:])
    device = profile_ticks(batcher, 3, tick_ms)
    batcher.run()
    # every tick of the three loads replayed one captured flat tick
    captures = {name: fn._cache_size() for name, fn in ad.jit_fns().items()}
    if captures != {"decode": 1} or device["graph_launches_per_tick"] != 1:
        failures.append(f"captured steps {captures}, graph launches per "
                        f"tick {device['graph_launches_per_tick']}")
    launches = {n: counts_a[n] + counts_b[n] for n in paged}
    del gw, ad, batcher, probe
    torch.cuda.empty_cache()
    sw.lap("tick_8x1k")

    # the kernel tick against the plain tick, same card, same weights
    lens = [1000, 517, 16, 1, 33, 250, 800, 1024]
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    forced = rng.integers(0, cfg.vocab, (8, len(lens))).astype(np.int32)
    cfg4 = dataclasses.replace(cfg, n_layers=4, param_dtype="float32")
    params4 = lm.init(cfg4, torch.Generator(device=dev).manual_seed(1))
    runs4 = forced_ticks(cfg4, params4, prompts, forced, ("cuda", "plain"))
    f_k, t_k, l_k, _, _ = runs4["cuda"]
    f_p, t_p, l_p, _, _ = runs4["plain"]
    f32_err = float((l_k - l_p).abs().max())
    f32_ok = f_k == f_p and np.array_equal(t_k, t_p) and \
        torch.allclose(l_k, l_p, rtol=2e-4, atol=2e-4)
    del params4
    torch.cuda.empty_cache()
    sw.lap("forced_f32")
    runs = forced_ticks(cfg, params, prompts, forced, ("cuda", "plain"))
    b_k, bt_k, bl_k, ms_k, _ = runs["cuda"]
    b_p, bt_p, bl_p, ms_p, _ = runs["plain"]
    bf16_err = float((bl_k - bl_p).abs().max())
    bf16_finite = bool(torch.isfinite(bl_k).all())
    sw.lap("forced_bf16")
    if not f32_ok:
        failures.append(f"float32 depth 4: kernel tick vs plain tick "
                        f"max |dlogit| {f32_err}, tokens equal "
                        f"{np.array_equal(t_k, t_p)}")
    if not bf16_err <= BF16_LOGIT_BOUND or not bf16_finite:
        failures.append(f"bf16 full depth: max |dlogit| {bf16_err} > "
                        f"{BF16_LOGIT_BOUND}")
    emit({"phase": "lm_main_path", "model": cfg.name,
          "params": n_params, "init_s": init_s,
          "arena_blocks": LM_SLOTS * (LM_MAX_LEN // LM_BLOCK) + 1,
          "arena_bytes": arena_bytes, "load_a_fleet": load_a,
          "load_b_shared_prefix": load_b,
          "decode_tick_ms_8x1k": tick_ms, "profile_8x1k": device,
          "captures": captures,
          "weight_stream_bound_ms": 2 * n_params / PEAK_BYTES_PER_S * 1e3,
          "attention_share_8x1k": cfg.n_layers * attn_ms / tick_ms,
          "plain_tick_ms_8x1k_bf16": statistics.median(ms_p[1:]),
          "kernel_tick_ms_8x1k_bf16": statistics.median(ms_k[1:]),
          "f32_depth4_max_abs_dlogit": f32_err,
          "f32_depth4_tokens_equal": bool(np.array_equal(t_k, t_p)),
          "bf16_max_abs_dlogit": bf16_err,
          "bf16_logit_bound": BF16_LOGIT_BOUND,
          "bf16_token_agreement": float((bt_k == bt_p).mean()),
          "failures": failures, **sw.fields()})
    if failures:
        raise SystemExit(f"prompt path: {failures}")
    return launches, cfg, params


def cascade_main_path(dev, cfg, params, chunked: bool = False,
                      turns: bool = True, host_runs: int | None = None,
                      eager_profile: bool = True) -> dict:
    """Phase 6: the cascade tick at the config's full width and depth
    (stablelm-3b in phase 6), its prompts admitted one-shot or, with
    ``chunked``, through the fold (the hybrid family, whose one-shot
    prefill refuses load (c)'s 1,088 tokens as the reference's does);
    without ``turns`` load (c) is served once per gateway, not twice in
    turns (the second pair only times the tick again and repeats its
    tokens).  The cascade gateway's tick right after its first is held
    against its eager step and timed (:func:`captured_tick_check`,
    ``host_runs`` and ``eager_profile``; phase 8's cascade tick).
    Returns the launches of load (c); raises SystemExit on a failed
    check."""
    import numpy as np
    import torch

    from repro_torch.models import lm

    prompts, rng = load_c_prompts(cfg.vocab)
    failures = []
    sw = Stopwatch()

    def serve(cfg, params, backend: str, profile: bool,
              after_first=None) -> dict:
        return serve_load(dev, cfg, params, prompts,
                          backend=backend, chunked=chunked,
                          new_tokens=NEW_TOKENS_C, profile=profile,
                          after_first=after_first)

    captured = {}

    def capture_check(ad, batcher):
        captured.update(captured_tick_check(
            ad, batcher, "cascade_load_c", host_runs, eager_profile,
            failures))
    # bf16, full depth, the main path; runs in turns (cascade, flat, flat,
    # cascade) because the host clock drifts within a call
    runs = [serve(cfg, params, "cascade", True, capture_check),
            serve(cfg, params, "cuda", True)]
    sw.lap("load_c_bf16")
    if turns:
        runs += [serve(cfg, params, "cuda", False),
                 serve(cfg, params, "cascade", False)]
    casc, flat = runs[0], runs[1]
    ticks = casc["ticks"]
    grouped = sum(g > 0 for g in casc["groups"])
    st = casc["stats"][0]
    if ticks != NEW_TOKENS_C - 1 or any(g != 1 for g in casc["groups"]) or \
            any(s["grouped_lanes"] != LM_SLOTS or s["prefix_rows_flat"] !=
                LM_SLOTS * s["prefix_rows"] for s in casc["stats"]) or \
            st["prefix_rows"] != SHARED_PROMPT:
        failures.append(f"load (c): {ticks} ticks, groups {casc['groups']}, "
                        f"first stats {st}")
    proxy = casc["proxy"]
    if not proxy["cascade"] < proxy["inplace"] < proxy["gather"]:
        failures.append(f"load (c): tick_bytes_proxy order {proxy}")
    # per grouped tick and layer: the prefix pass and the suffix pass with
    # the merge fused in; the standalone merge never
    want = {name: 0 for name in casc["launches"]}
    want.update({name: cfg.n_layers * grouped
                 for name in ("paged_decode_attention_with_state",
                              "cascade_prefix_attention", FUSED_MERGE)})
    want["paged_decode_attention"] = cfg.n_layers * (ticks - grouped)
    want["scatter_kv_rows"] = ticks
    # one launch per layer for each one-shot prefill or fold chunk
    prefills = casc["chunks"] if chunked else LM_SLOTS
    want["flash_attention"] = flash_launches(cfg, prefills, LM_SLOTS)
    if casc["launches"] != want:
        failures.append(f"load (c) cascade launches {casc['launches']}, "
                        f"expected {want}")
    want_flat = {name: 0 for name in flat["launches"]}
    want_flat.update(paged_decode_attention=cfg.n_layers * flat["ticks"],
                     scatter_kv_rows=flat["ticks"],
                     flash_attention=flash_launches(
                         cfg, flat["chunks"] if chunked else LM_SLOTS,
                         LM_SLOTS))
    if flat["launches"] != want_flat:
        failures.append(f"load (c) flat launches {flat['launches']}")
    # one captured flat tick, one captured cascade tick per metadata
    # bucket the load visited
    for r in runs:
        want_cap = {"decode": 1} if r["backend"] == "cuda" else \
            {"decode": 0, "decode_cascade": r["buckets"]}
        if r["captures"] != want_cap:
            failures.append(f"load (c) {r['backend']}: captured steps "
                            f"{r['captures']}, expected {want_cap}")
    # the tick writes the layers' rows where they lie: no stack
    stacks = [r["profile"]["stack_ops_per_tick"] for r in runs[:2]]
    if any(stacks):
        failures.append(f"load (c): {stacks} torch.stack per tick "
                        "(cascade, flat) before the row write")
    if turns and (runs[3]["tokens"] != casc["tokens"] or
                  runs[2]["tokens"] != flat["tokens"]):
        failures.append("load (c): a second run of the same gateway "
                        "generated other tokens")
    if not all(r["logits_finite"] for r in runs) or \
            sorted(len(t) for t in casc["tokens"].values()) != \
            [NEW_TOKENS_C] * LM_SLOTS:
        failures.append("load (c): a tick was not finite, or a request "
                        "was not served")
    # bf16 rounds every layer's attention output, so float32 summation
    # order alone can flip a near tie between the two greedy streams:
    # where they differ, the flat tick must rate the cascade's token within
    # the two ticks' logit difference on the same history
    diffs = first_differences(casc, flat)
    trace_routing(cfg, params, diffs,
                  (load_spec("cascade", chunked, NEW_TOKENS_C),
                   load_spec("cuda", chunked, NEW_TOKENS_C)), casc, prompts,
                  whole_load=True)
    if not all(d["near_tie"] for d in diffs):
        failures.append(f"load (c) bf16: a difference from the flat "
                        f"gateway that is not a near tie: {diffs}")
    agree = sum(a == b for uid, t in casc["tokens"].items()
                for a, b in zip(t, flat["tokens"][uid]))
    sw.lap("load_c_bf16_checks")
    # float32 at depth 4 (encdec: whole), where the reference's contract is
    # exact tokens
    cfg4 = strict_cfg(cfg)
    params4 = lm.init(cfg4, torch.Generator(device=dev).manual_seed(1))
    casc4 = serve(cfg4, params4, "cascade", False)
    flat4 = serve(cfg4, params4, "cuda", False)
    if casc4["tokens"] != flat4["tokens"] or \
            any(g != 1 for g in casc4["groups"]):
        failures.append("load (c) float32 depth 4: the cascade gateway's "
                        "tokens differ from the flat gateway's")
    f32_c = max(float((a - b).abs().max())
                for a, b in zip(casc4["logits"], flat4["logits"]))
    if not f32_c <= 2e-4:
        failures.append(f"load (c) float32 depth 4: max |dlogit| {f32_c} "
                        f"against the flat gateway > 2e-4")
    del params4
    for r in (casc4, flat4):
        del r["logits"], r["prefill"]
    for r in runs:
        del r["logits"]
        r["prefill_ms"] = statistics.median(
            x["ms"] for x in r.pop("prefill").values())
    torch.cuda.empty_cache()
    sw.lap("load_c_f32")

    # the cascade tick against the plain flat tick, same card and weights:
    # eight prompts share a 512-token prefix, with tails of 0 to 511 tokens
    base = rng.integers(0, cfg.vocab, 512)
    fprompts = [np.concatenate([base, rng.integers(0, cfg.vocab, n)]
                               ).astype(np.int32)
                for n in (0, 1, 15, 16, 47, 130, 300, 511)]
    forced = rng.integers(0, cfg.vocab, (8, len(fprompts))).astype(np.int32)
    params4 = lm.init(cfg4, torch.Generator(device=dev).manual_seed(1))
    pair4 = forced_ticks(cfg4, params4, fprompts, forced,
                         ("cascade", "plain"), chunked)
    f_c, t_c, l_c, _, g4 = pair4["cascade"]
    f_p, t_p, l_p, _, _ = pair4["plain"]
    f32_err = float((l_c - l_p).abs().max())
    f32_ok = f_c == f_p and np.array_equal(t_c, t_p) and \
        torch.allclose(l_c, l_p, rtol=2e-4, atol=2e-4) and \
        all(g == 1 for g in g4)
    del params4
    torch.cuda.empty_cache()
    sw.lap("forced_f32")
    pair = forced_ticks(cfg, params, fprompts, forced, ("cascade", "plain"),
                        chunked)
    b_c, bt_c, bl_c, ms_c, gb = pair["cascade"]
    b_p, bt_p, bl_p, ms_p, _ = pair["plain"]
    bf16_err = float((bl_c - bl_p).abs().max())
    sw.lap("forced_bf16")
    if not f32_ok:
        failures.append(f"float32 depth 4: cascade tick vs plain tick max "
                        f"|dlogit| {f32_err}, tokens equal "
                        f"{np.array_equal(t_c, t_p)}, groups {g4}")
    if not bf16_err <= BF16_LOGIT_BOUND or \
            not bool(torch.isfinite(bl_c).all()) or any(g != 1 for g in gb):
        failures.append(f"bf16 full depth: cascade tick max |dlogit| "
                        f"{bf16_err} > {BF16_LOGIT_BOUND}, groups {gb}")
    emit({"phase": "cascade_main_path", "model": cfg.name,
          "admission": "chunked fold" if chunked else "one-shot",
          "load_c": {
              "requests": LM_SLOTS, "prompt_tokens": SHARED_PROMPT + OWN_TAIL,
              "shared_tokens": SHARED_PROMPT, "new_tokens": NEW_TOKENS_C,
              "ticks": ticks, "grouped_ticks": grouped,
              "cascade_stats_first_tick": st, "tick_bytes_proxy": proxy,
              "bf16_tokens_equal_flat": casc["tokens"] == flat["tokens"],
              "bf16_token_agreement": agree / (LM_SLOTS * NEW_TOKENS_C),
              "bf16_first_differences": diffs,
              "bf16_near_tie_max_abs_dlogit": max(
                  (d["max_abs_dlogit"] for d in diffs), default=None),
              "f32_depth4_tokens_equal_flat":
                  casc4["tokens"] == flat4["tokens"],
              "f32_depth4_max_abs_dlogit": f32_c,
              "runs": [{"backend": r["backend"], "run_s": r["run_s"],
                        "captures": r["captures"],
                        "buckets_visited": r["buckets"],
                        "tick_ms_median": statistics.median(r["tick_ms"]),
                        "prefill_ms_median": r["prefill_ms"],
                        "profile": r["profile"]} for r in runs],
              "tick_ms_median": {
                  b: statistics.median(sum((r["tick_ms"] for r in runs
                                            if r["backend"] == b), []))
                  for b in ("cascade", "cuda")},
              "launches": {"cascade": casc["launches"],
                           "flat": flat["launches"]}},
          "forced": {
              "f32_depth4_max_abs_dlogit": f32_err,
              "f32_depth4_tokens_equal": bool(np.array_equal(t_c, t_p)),
              "bf16_max_abs_dlogit": bf16_err,
              "bf16_logit_bound": BF16_LOGIT_BOUND,
              "bf16_token_agreement": float((bt_c == bt_p).mean()),
              "cascade_tick_ms_bf16": statistics.median(ms_c[1:]),
              "plain_tick_ms_bf16": statistics.median(ms_p[1:])},
          "captured_cascade_tick": captured,
          "failures": failures, **sw.fields()})
    if failures:
        raise SystemExit(f"cascade path: {failures}")
    return casc["launches"]


def chunked_main_path(dev, cfg, params, loads: str = "bc") -> dict:
    """Phase 7: the chunked prefill fold (``ServeSpec(paged=True)``, the
    reference's default ``chunked=True``) at the config's full width and
    depth: load (b) through ``backend="cuda"`` and load (c) through
    ``backend="cascade"`` (those of ``loads``), each beside the one-shot
    gateway on the same load; load (b)'s resumed admission held bitwise
    against a cold one in a fresh gateway; float32 at depth 4 against
    one-shot; the prefill host time per prompt.  The hybrid family's
    one-shot prefill admits only prompts of 512 or a multiple of 1,024
    tokens here (hymba's ``ssm_chunk``, as the reference asserts): its
    one-shot gateway must refuse a 1,000-token prompt, and chunked and
    one-shot admission are compared on :func:`aligned_prompts` instead;
    a resumed admission is also held bitwise after the slot whose fold
    left the boundary states has ticked on.  Returns the chunked runs' launches ("launches"), the
    one-shot prefill ms of a 1,000-token prompt (1,024 for the hybrid
    family) and the cold fold's ms per chunk; raises SystemExit on a
    failed check."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.models import lm
    from repro_torch.nn import attention
    from repro_torch.serve import engine
    from repro_torch.serve.spec import ServeSpec, make_gateway

    failures = []
    sw = Stopwatch()
    pb, _ = load_b_prompts(cfg.vocab)
    # each load: its prompts, backend, the fold's chunks (from the
    # adapter's own count) and the prefill tokens each request skips
    spec = {"b": (pb, "cuda", 63 + 31 + 1 + 63, [0, 512, 992, 0]),
            "c": (load_c_prompts(cfg.vocab)[0], "cascade", 68 + 7 * 4,
                  [0] + [SHARED_PROMPT] * 7)}
    spec = {key: spec[key] for key in loads}
    L = cfg.n_layers
    hybrid = cfg.family == "hybrid"
    aligned = aligned_prompts(cfg.vocab)

    def serve(cfg, params, prompts, backend, chunked, **kw):
        return serve_load(dev, cfg, params, prompts,
                          backend=backend, chunked=chunked,
                          new_tokens=32, **kw)

    # bf16 at full depth: each load chunked, then one-shot (the hybrid
    # family: both on the aligned prompts as well)
    ch, os_, cmp_ = {}, {}, {}
    for key, (prompts, backend, _, _) in spec.items():
        ch[key] = serve(cfg, params, prompts, backend, True,
                        keep_blocks=key == "b")
        cmp_[key] = serve(cfg, params, aligned, backend, True) \
            if hybrid else ch[key]
        os_[key] = serve(cfg, params, aligned if hybrid else prompts,
                         backend, False)
        sw.lap(f"load_{key}_bf16")
    refused = None
    if hybrid:
        # the reference's one-shot prefill asserts S % min(ssm_chunk, S)
        # == 0; the port's raises
        gw = make_gateway(cfg, params, load_spec("cuda", False, 32),
                          extras=extras_of(cfg), device=dev)
        try:
            gw.batcher.adapter.insert(0, pb[0], max_new=32)
        except ValueError as e:
            refused = str(e)
        if refused is None:
            failures.append("one-shot admission of a 1,000-token prompt "
                            "was not refused")
        del gw
        torch.cuda.empty_cache()

    def skipped(run):
        return [run["prefill"][uid]["skipped"] for uid in sorted(run["slot"])]

    grouped = None
    for key, (prompts, backend, want_chunks, want_skip) in spec.items():
        run = ch[key]
        if run["chunks"] != want_chunks or skipped(run) != want_skip:
            failures.append(f"load ({key}) chunked: {run['chunks']} chunks, "
                            f"skipped {skipped(run)}")
        n = run["launches"]
        if n["flash_attention"] != flash_launches(cfg, run["chunks"],
                                                  len(prompts)):
            failures.append(f"load ({key}) chunked: flash_attention launched "
                            f"{n['flash_attention']} times for "
                            f"{run['chunks']} chunks x {L} layers")
        n_os = len(os_[key]["slot"])
        if os_[key]["launches"]["flash_attention"] != \
                flash_launches(cfg, n_os, n_os):
            failures.append(f"load ({key}) one-shot: flash_attention "
                            f"launches "
                            f"{os_[key]['launches']['flash_attention']}")
        if backend == "cuda" and (
                not (n["paged_decode_attention"] and n["scatter_kv_rows"])
                or any(n[name] for name in CASCADE + (FUSED_MERGE,))):
            failures.append(f"load ({key}) chunked launches {n}")
        if backend == "cascade":
            grouped = sum(g > 0 for g in run["groups"])
            if grouped == 0 or any(n[name] != L * grouped for name in (
                    "paged_decode_attention_with_state",
                    "cascade_prefix_attention", FUSED_MERGE)) or \
                    n["merge_attn_states"] or \
                    n["scatter_kv_rows"] != run["ticks"]:
                failures.append(f"load ({key}) chunked launches {n}, "
                                f"grouped {grouped}")
        for r in (run, os_[key]):
            if not r["logits_finite"] or \
                    sorted(len(t) for t in r["tokens"].values()) != \
                    [32] * len(r["tokens"]):
                failures.append("a tick was not finite, or a request was "
                                "not served")
    # bf16: equal up to each stream's first difference, a near tie (for
    # the moe family, in the logits or traced to the router)
    diffs = {key: first_differences(cmp_[key], os_[key]) for key in spec}
    for key, (prompts, backend, _, _) in spec.items():
        trace_routing(cfg, params, diffs[key],
                      (load_spec(backend, True, 32),
                       load_spec(backend, False, 32)), cmp_[key],
                      aligned if hybrid else prompts,
                      whole_load=backend == "cascade")
    if not all(d["near_tie"] for ds in diffs.values() for d in ds):
        failures.append(f"bf16 chunked vs one-shot: a difference that is "
                        f"not a near tie: {diffs}")
    sw.lap("refusal_and_traces")

    # load (b)'s r1 (a 512-token hit, resumed at block 32) against the same
    # prompt admitted cold into a fresh gateway: bitwise
    warm = ch["b"]["prefill"][1]
    gw_cold = make_gateway(cfg, params, ServeSpec(
        n_slots=LM_SLOTS, max_len=LM_MAX_LEN, paged=True,
        block_size=LM_BLOCK), extras=extras_of(cfg), device=dev)
    ad = gw_cold.batcher.adapter
    ad.insert(0, pb[1], max_new=32)
    bids = torch.tensor(ad.slot_bids[0][:-(-len(pb[1]) // LM_BLOCK)],
                        device=dev)
    cold_logits = ad.last_prefill_logits[0]
    resume_bitwise = {
        "warm_skipped": warm["skipped"],
        "cold_skipped": ad.slot_stats(0)["prefill_tokens_skipped"],
        "logits": torch.equal(cold_logits, warm["logits"]),
        "blocks": all(torch.equal(a[:, bids], warm["blocks"][key])
                      for key, a in ad.arena.items()),
        # the encdec family's cross K/V (its encoder run again on the hit)
        "cross_kv": all(torch.equal(ad.state[key][:, 0], a)
                        for key, a in warm["cross"].items())}
    if hybrid:
        # the same prompt again, resumed from the boundary states its own
        # cold fold left, after its slot has ticked eight times (the
        # slot's state and last block written in place each tick): the
        # cold admission's logits, blocks and state bit for bit
        blocks = {key: a[:, bids].clone() for key, a in ad.arena.items()}
        state = {key: a[:, 0].clone() for key, a in ad.state.items()}
        tok = int(cold_logits.argmax())
        lane = np.zeros(LM_SLOTS, bool)
        lane[0] = True
        for _ in range(8):
            tok = int(ad.decode(np.full(LM_SLOTS, tok, np.int32), lane)[0])
        ad.insert(1, pb[1], max_new=32)
        wb = torch.tensor(ad.slot_bids[1][:len(bids)], device=dev)
        resume_bitwise["after_ticks"] = {
            "skipped": ad.slot_stats(1)["prefill_tokens_skipped"],
            "logits": torch.equal(cold_logits, ad.last_prefill_logits[0]),
            "blocks": all(torch.equal(blocks[key], a[:, wb])
                          for key, a in ad.arena.items()),
            "state": all(torch.equal(state[key], a[:, 1])
                         for key, a in ad.state.items()),
            "boundary_state_bytes": ad.pool_stats()["boundary_state_bytes"]}
        del blocks, state
    if not (resume_bitwise["logits"] and resume_bitwise["blocks"]
            and resume_bitwise["cross_kv"]) or \
            resume_bitwise["warm_skipped"] != 512 or \
            resume_bitwise["cold_skipped"] != 0 or (hybrid and not all(
                resume_bitwise["after_ticks"][k]
                for k in ("logits", "blocks", "state"))) or (
            hybrid and resume_bitwise["after_ticks"]["skipped"] != 992):
        failures.append(f"resumed vs cold admission: {resume_bitwise}")
    del gw_cold, ad, cold_logits, warm
    for run in ch.values():
        for rec in run["prefill"].values():
            rec.pop("blocks", None)
            rec.pop("cross", None)
    torch.cuda.empty_cache()
    sw.lap("resume_bitwise")

    # one-shot prefill of a 1,000-token prompt (hybrid: 1,024) with
    # attention through the kernel, and through its plain version (the
    # loops it replaced)
    one = aligned[2] if hybrid else pb[3]
    tokens = torch.from_numpy(one[None]).to(dev)
    prefill_kernel_ms = host_ms(lambda: engine.prefill(
        cfg, params, tokens, **prefill_kw(cfg)), reps=3)

    def plain(q, k, v, **kw):
        return ref.flash_attention_chunked(
            q, k, v, kw["causal"], kw["window"], kw["q_offset"],
            kw["q_chunk"], kw["kv_chunk"])
    with mock.patch.object(attention, "flash_kernels",
                           SimpleNamespace(flash_attention=plain)):
        prefill_plain_ms = host_ms(lambda: engine.prefill(
            cfg, params, tokens, **prefill_kw(cfg)), reps=3)
    torch.cuda.empty_cache()
    sw.lap("prefill_ms")

    # float32 at depth 4 (encdec: whole): tokens equal and logits within
    # 2e-4
    cfg4 = strict_cfg(cfg)
    params4 = lm.init(cfg4, torch.Generator(device=dev).manual_seed(1))
    f32 = {}
    for key, (prompts, backend, _, _) in spec.items():
        prompts = aligned if hybrid else prompts
        c4 = serve(cfg4, params4, prompts, backend, True)
        o4 = serve(cfg4, params4, prompts, backend, False)
        err = max([float((a - b).abs().max())
                   for a, b in zip(c4["logits"], o4["logits"])]
                  + [float((c4["prefill"][u]["logits"]
                            - o4["prefill"][u]["logits"]).abs().max())
                     for u in c4["slot"]])
        f32[key] = {"tokens_equal": c4["tokens"] == o4["tokens"],
                    "max_abs_dlogit": err, "chunks": c4["chunks"]}
        if not f32[key]["tokens_equal"] or not err <= 2e-4:
            failures.append(f"float32 depth 4, load ({key}): chunked vs "
                            f"one-shot {f32[key]}")
    del params4
    torch.cuda.empty_cache()
    sw.lap("f32")

    def prefill_ms(runs, pick):
        return [r["prefill"][u]["ms"] for r in runs for u in sorted(r["slot"])
                if pick(r["prefill"][u]["skipped"])]
    # a model, not a measurement: the bytes a cold fold of a 1,000-token
    # prompt writes re-concatenating the prefix (k and v in every layer)
    # and stacking the layers again, chunk after chunk
    row = cfg.n_kv_heads * cfg.d_head * params["embed"].element_size()
    fold_copy_bytes = sum(2 * 2 * L * min(q + LM_BLOCK, 1000) * row
                          for q in range(0, 1000, LM_BLOCK))
    cold_lens = [len(p) for key, (ps, _, _, _) in spec.items()
                 for u, p in enumerate(ps)
                 if ch[key]["prefill"][u]["skipped"] == 0]
    times = {"cold_fold": prefill_ms(ch.values(), lambda k: k == 0),
             "resumed_fold": prefill_ms(ch.values(), lambda k: k > 0),
             "oneshot": prefill_ms(os_.values(), lambda k: True)}
    launches = {name: sum(r["launches"][name] for r in ch.values())
                for name in ch["b"]["launches"]}
    emit({"phase": "chunked_main_path", "model": cfg.name,
          "spec": {"n_slots": LM_SLOTS, "max_len": LM_MAX_LEN,
                   "block_size": LM_BLOCK, "chunked": True},
          **({"oneshot_compared_on": [len(p) for p in aligned],
              "oneshot_1000_refused": refused} if hybrid else {}),
          **{f"load_{key}": {"chunks": ch[key]["chunks"],
                             "skipped": skipped(ch[key]),
                             "launches": ch[key]["launches"],
                             "ticks": ch[key]["ticks"],
                             "boundary_state_bytes":
                                 ch[key]["pool"]["boundary_state_bytes"],
                             "prefill_tokens_skipped":
                                 ch[key]["pool"]["prefill_tokens_skipped"],
                             **({"grouped_ticks": grouped} if key == "c"
                                else {})} for key in spec},
          "resume_bitwise": resume_bitwise,
          "bf16_first_differences": diffs,
          "bf16_token_agreement": {
              key: sum(x == y for u, t in cmp_[key]["tokens"].items()
                       for x, y in zip(t, os_[key]["tokens"][u]))
              / sum(len(t) for t in cmp_[key]["tokens"].values())
              for key in spec},
          "f32_depth4": f32,
          "prefill_ms": times,
          "prefill_ms_median": {k: statistics.median(v)
                                for k, v in times.items()},
          "fold_copy_bytes_written_cold_1000": fold_copy_bytes,
          "oneshot_prefill_1000_ms": {"kernel": prefill_kernel_ms,
                                      "plain_loops": prefill_plain_ms},
          "oneshot_prefill_tokens": len(one),
          "tick_ms_median": {
              f"{key}_{'chunked' if r['chunked'] else 'oneshot'}":
                  statistics.median(r["tick_ms"])
              for key in spec for r in (ch[key], os_[key])},
          "failures": failures, **sw.fields()})
    if failures:
        raise SystemExit(f"chunked path ({cfg.name}): {failures}")
    return {"launches": launches,
            "oneshot_prefill_1000_ms": prefill_kernel_ms,
            "oneshot_prefill_tokens": len(one),
            "boundary_state_bytes": {
                key: ch[key]["pool"]["boundary_state_bytes"] for key in spec},
            "resume_bitwise": resume_bitwise,
            "cold_fold_ms_per_chunk": sum(times["cold_fold"]) / sum(
                -(-n // LM_BLOCK) for n in cold_lens)}


# -- the captured ticks (phase 8) ---------------------------------------------

# a captured tick issues its graph, the logits' copy and argmax, and the
# tokens' copy to the host: at most this many kernel launches one by one
MAX_CAPTURED_TICK_LAUNCHES = 8


def tick_replay_check(ad, tokens, active, state=None) -> dict:
    """The adapter's next tick at its current state through its captured
    step and through the step's ``fn`` eagerly on the same static inputs,
    each from the same ``state`` (the paged arena, or the dense cache
    with its lengths; restored after, so the state does not advance):
    logits and the whole state bit for bit, launch counts equal, and the
    rows (lengths) the tick wrote."""
    import torch
    state = ad.arena if state is None else state
    step, inputs, _ = ad._tick_inputs(tokens, active)
    start = {k: a.clone() for k, a in state.items()}
    out = {}
    for side in ("replay", "eager"):
        for key, a in state.items():
            a.copy_(start[key])
        reset_counts()
        logits = step(*inputs).clone() if side == "replay" else \
            step.fn(*step.load(*inputs))
        torch.cuda.synchronize()
        out[side] = (logits, {k: a.clone() for k, a in state.items()},
                     read_counts())
    (lr, ar, cr), (le, ae, ce) = out["replay"], out["eager"]
    rows = {k: int((ar[k] != start[k]).flatten(-2).any(-1).sum())
            if ar[k].dim() > 2 else int((ar[k] != start[k]).sum())
            for k in ar}
    for key, a in state.items():
        a.copy_(start[key])
    out = {"logits_bitwise": bool(torch.equal(lr, le)),
           "logits_finite": bool(torch.isfinite(lr).all()),
           "arena_bitwise": all(torch.equal(ar[k], ae[k]) for k in ar),
           "rows_written": rows, "launches_equal": cr == ce,
           "launches": {k: v for k, v in cr.items() if v}}
    del start, ar, ae
    torch.cuda.empty_cache()
    return out


def tick_timing(ad, tokens, active, after=None, runs: int | None = None,
                eager_profile: bool = True) -> dict:
    """Host ms of the adapter's next tick at its current state (its host
    side, the step, the logits' copy and the tokens on the host; the state
    does not advance: a paged tick rewrites its rows, and ``after``, where
    given, puts back what the tick advanced), captured and eager in turns
    (:func:`turns`, ``runs`` a side, default ``HOST_RUNS``), and
    :func:`profile_ticks` over three ticks of the captured step and, with
    ``eager_profile``, of the eager one (seconds of profiler work at a
    large model's thousands of launches a tick)."""
    from types import SimpleNamespace

    def tick(eager: bool):
        step, inputs, _ = ad._tick_inputs(tokens, active)
        logits = step.fn(*step.load(*inputs)) if eager else step(*inputs)
        if after is not None:
            after()
        return logits.clone().argmax(-1).cpu()
    sides = {"captured": lambda: tick(False), "eager": lambda: tick(True)}
    ms = turns(sides, runs or HOST_RUNS)
    return {"host_ms": ms, "profile": {
        name: profile_ticks(SimpleNamespace(step=fn), 3, ms[name]["median"])
        for name, fn in sides.items()
        if eager_profile or name == "captured"}}


def captured_tick_check(ad, batcher, name: str, runs: int | None,
                        eager_profile: bool, failures: list) -> dict:
    """The paged adapter's next tick right after its first (its capture),
    mid load: replayed against the eager step bit for bit (the arena, and
    the hybrid family's per-lane state), launch counts, captured steps, and
    host ms per tick captured against eager in turns with a profile
    (:func:`tick_timing`, ``runs`` a side); appends to ``failures``.
    The arena and the lane state are put back afterwards (the timed ticks
    advance the hybrid family's recurrent state), so the load can go on.
    Returns the check's fields."""
    import numpy as np
    tokens = batcher.last_token.copy()
    active = np.asarray([r is not None for r in batcher.active])
    state = {**ad.arena, **ad.state}
    check = tick_replay_check(ad, tokens, active, state=state)
    start = {key: a.clone() for key, a in state.items()}
    timing = tick_timing(ad, tokens, active, runs=runs,
                         eager_profile=eager_profile)
    for key, a in state.items():
        a.copy_(start[key])
    del start
    captures = {n: fn._cache_size() for n, fn in ad.jit_fns().items()}
    want = {"decode": 1} if ad.backend != "cascade" else \
        {"decode": 0, "decode_cascade": 1}
    prof = timing["profile"]["captured"]
    # every arena key and recurrent state written, the encdec and vlm
    # families' cross K/V read only
    written = all(v == 0 if key in ("xk", "xv") else v
                  for key, v in check["rows_written"].items())
    if not (check["logits_bitwise"] and check["arena_bitwise"]
            and check["launches_equal"] and check["logits_finite"]
            and written):
        failures.append(f"{name}: the replayed tick differs from the "
                        f"eager step: {check}")
    if captures != want:
        failures.append(f"{name}: captured steps {captures}, expected "
                        f"{want}")
    if prof["graph_launches_per_tick"] != 1 or \
            prof["host_launches_per_tick"] > MAX_CAPTURED_TICK_LAUNCHES:
        failures.append(f"{name}: a captured tick issued "
                        f"{prof['graph_launches_per_tick']} graphs and "
                        f"{prof['host_launches_per_tick']} kernels")
    return {"backend": ad.backend, "groups": ad.last_groups,
            "captures": captures, "replay": check, **timing}


def capture_main_path(dev, cfg, params, runs: int | None = None, *,
                      flat_len: int = 1024, chunked: bool = False,
                      eager_profile: bool = True) -> dict:
    """Phase 8: the captured flat tick at the config's full width and depth,
    8 lanes x ``flat_len`` positions (``backend="cuda"``; for the vlm family
    ``"plain"``, its only in-place tick), prompts admitted one-shot or
    through the fold (``chunked``; the lanes then share all but their last
    block), right after the first tick (its capture)
    (:func:`captured_tick_check`: replay against the eager step bit for
    bit, the arena and the hybrid family's per-lane state, launch counts,
    captured steps, and host ms per tick captured against eager in turns,
    with a profile, ``runs`` a side; the eager step profiled with
    ``eager_profile``).  Load (c)'s cascade tick is held the same way on
    :func:`cascade_main_path`'s own cascade gateway, so load (c) is not
    admitted again here.  Raises SystemExit on a failed check."""
    import numpy as np
    import torch

    from repro_torch.serve.gateway.slots import Request
    from repro_torch.serve.spec import ServeSpec, make_gateway

    rng = np.random.default_rng(17)
    flat = "flat_8x1k" if flat_len == 1024 else f"flat_8x{flat_len}"
    # through the fold the lanes share all but their last block, so that
    # seven admissions resume (the flat tick reads every lane's whole chain
    # all the same)
    own = LM_BLOCK if chunked else flat_len
    common = rng.integers(0, cfg.vocab, flat_len - own)
    vlm = cfg.family == "vlm"
    loads = {flat: ("plain" if vlm else "cuda", [np.concatenate(
        [common, rng.integers(0, cfg.vocab, own)]).astype(np.int32)
        for _ in range(LM_SLOTS)])}
    out, failures = {}, []
    sw = Stopwatch()
    for name, (backend, prompts) in loads.items():
        gw = make_gateway(cfg, params, ServeSpec(
            n_slots=LM_SLOTS, max_len=LM_MAX_LEN, paged=True,
            block_size=LM_BLOCK, chunked=chunked, backend=backend,
            max_new_tokens=NEW_TOKENS_C), extras=extras_of(cfg), device=dev)
        ad, batcher = gw.batcher.adapter, gw.batcher
        for i, p in enumerate(prompts):
            batcher.submit(Request(uid=i, prompt=p,
                                   max_new_tokens=NEW_TOKENS_C))
        batcher.step()          # admits all eight; the first tick captures
        sw.lap(f"{name}_admit")
        out[name] = captured_tick_check(ad, batcher, name, runs,
                                        eager_profile, failures)
        sw.lap(f"{name}_check")
        del gw, ad, batcher
        torch.cuda.empty_cache()
    emit({"phase": "capture", "model": cfg.name,
          "admission": "chunked fold" if chunked else "one-shot", **out,
          "failures": failures, **sw.fields()})
    if failures:
        raise SystemExit(f"captured ticks: {failures}")
    return out


# -- the dense path, the gather oracle, the SC frontend (phase 10) -------------

# the default ServeSpec()'s load: 4 slots of 128 positions and 16 new tokens,
# so prompts of up to 112 tokens; six requests, so two slots are cleared and
# reused
DENSE_PROMPT_LENS = (100, 7, 64, 33, 112, 1)


def dense_prompts(vocab: int):
    import numpy as np
    rng = np.random.default_rng(19)
    return [rng.integers(0, vocab, n).astype(np.int32)
            for n in DENSE_PROMPT_LENS]


def serve_spec_load(dev, cfg, params, prompts, spec) -> dict:
    """``prompts`` (all arriving at t = 0) through ``make_gateway(cfg,
    params, spec)`` and its ``run``: per request (uid = index) the
    generated tokens, the first token's logits and the logits of every tick
    it decoded in (float32 copies); host ms per tick (ending in the tokens'
    copy to the host); every kernel's launches over the run; the captured
    steps; the ledger's records."""
    import torch

    from repro_torch.serve.gateway.sensors import Arrival
    from repro_torch.serve.spec import make_gateway

    gw = make_gateway(cfg, params, spec, extras=extras_of(cfg), device=dev)
    ad, batcher = gw.batcher.adapter, gw.batcher
    prefill, rows, tokens, times = [], {}, {}, []
    finite = [True]
    insert, decode, step = ad.insert, ad.decode, batcher.step

    def keep_insert(slot, prompt, max_new=None):
        tok = insert(slot, prompt, max_new)
        prefill.append(ad.last_prefill_logits[0].float().clone())
        return tok

    def keep_decode(toks, active):
        lanes = {r.uid: s for s, r in enumerate(batcher.active)
                 if r is not None}
        t0 = time.perf_counter()
        out = decode(toks, active)
        times.append((time.perf_counter() - t0) * 1e3)
        logits = ad.last_logits.float()
        finite[0] &= bool(torch.isfinite(logits).all())
        for uid, s in lanes.items():
            rows.setdefault(uid, []).append(logits[s].clone())
        return out

    def keep_step():
        fin = step()
        for r in fin:
            tokens[r.uid] = list(map(int, r.generated))
        return fin
    ad.insert, ad.decode, batcher.step = keep_insert, keep_decode, keep_step
    arrivals = [Arrival(uid=i, t=0.0, endpoint=0, kind="prompt", payload=p)
                for i, p in enumerate(prompts)]
    reset_counts()
    t0 = time.perf_counter()
    tel = gw.run(arrivals)
    torch.cuda.synchronize()
    out = {"adapter": type(ad).__name__,
           "backend": getattr(ad, "backend", None),
           "run_s": time.perf_counter() - t0, "tokens": tokens,
           # admission is first in, first out: the k-th insert is uid k
           "prefill": dict(enumerate(prefill)), "rows": rows,
           "tick_ms": times, "finite": finite[0],
           "launches": read_counts(), "served": len(tel.records),
           "dropped": len(tel.dropped),
           "captures": {n: f._cache_size() for n, f in ad.jit_fns().items()}}
    del gw, ad, batcher
    torch.cuda.empty_cache()
    return out


def stream_differences(a: dict, b: dict) -> dict:
    """Two :func:`serve_spec_load` runs of one load: whether every request's
    tokens are equal, the max |logit difference| over every logit row that
    both runs computed on the same history (the first token's and each
    tick's, up to each request's first differing token), and per request
    whose streams differ, the first differing token k with ``b``'s margin
    for its own token over ``a``'s next to the two rows' |difference|: a
    near tie has margin <= difference <= NEAR_TIE_BOUND."""
    worst, diffs = 0.0, []
    for uid, ta in a["tokens"].items():
        tb = b["tokens"][uid]
        k = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y),
                 None)
        pairs = [(a["prefill"][uid], b["prefill"][uid])] + list(
            zip(a["rows"].get(uid, []), b["rows"].get(uid, [])))
        same = pairs if k is None else pairs[:k + 1]
        for la, lb in same:
            worst = max(worst, float((la - lb).abs().max()))
        if k is None:
            continue
        la, lb = pairs[k]
        d = float((la - lb).abs().max())
        margin = float(lb.max() - lb[ta[k]])
        diffs.append({"uid": uid, "token": k, "b_token": tb[k],
                      "margin": margin, "max_abs_dlogit": d,
                      "near_tie": margin <= d <= NEAR_TIE_BOUND})
    return {"tokens_equal": a["tokens"] == b["tokens"],
            "max_abs_dlogit": worst, "first_differences": diffs}


# -- routing near ties (the moe family in bf16) --------------------------------

class RouterTrace:
    """The router's float32 logits for every (request, MoE layer, position)
    an adapter computes while observed (``with trace:`` patches
    ``nn.moe.router``), filed by the step that computed them: an admission
    (:meth:`prefill`: the fold's chunks or the one-shot prompt, from the
    skipped prefix on) or a tick (:meth:`tick`: one row per lane)."""

    def __init__(self, n_moe: int):
        self.n_moe, self.rows, self.events = n_moe, {}, []

    def __enter__(self):
        from repro_torch.nn import moe
        inner = moe.router

        def observed(x, w, m):
            self.events.append((x.float() @ w.float()).cpu())
            return inner(x, w, m)
        self._patch = mock.patch.object(moe, "router", observed)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()

    def prefill(self, uid: int, q0: int) -> None:
        pos, chunk = q0, 0
        for i, ev in enumerate(self.events):
            rows = ev.reshape(-1, ev.shape[-1])
            if i % self.n_moe == 0:             # the fold's next chunk
                pos, chunk = pos + chunk, rows.shape[0]
            for j in range(rows.shape[0]):
                self.rows[(uid, i % self.n_moe, pos + j)] = rows[j]
        self.events.clear()

    def tick(self, lanes: dict) -> None:
        """``lanes``: slot -> (uid, the position its token takes)."""
        for layer, ev in enumerate(self.events):
            for slot, (uid, pos) in lanes.items():
                self.rows[(uid, layer, pos)] = ev[slot, 0]
        self.events.clear()


def replay_routing(cfg, params, spec, admit, streams, n_ticks: int):
    """Replays admissions ``admit`` [(uid, slot, prompt)] in order through a
    fresh ``make_gateway(cfg, params, spec)`` adapter, then ``n_ticks``
    ticks that feed each lane the tokens of ``streams[uid]``, every step
    eager (bit for bit the captured step, as phases 8 and 10 check) with
    the router observed.  A lane's arithmetic does not read the other
    lanes' rows (the cascade's grouping does read their prompts, so load
    replays admit the whole load).  Returns (the :class:`RouterTrace`
    rows, per uid the logits of its prefill and of each tick)."""
    import numpy as np
    import torch

    from repro_torch.serve.spec import make_gateway

    gw = make_gateway(cfg, params, spec, extras=extras_of(cfg),
                      device=params["embed"].device)
    ad = gw.batcher.adapter
    for name, step in ad.jit_fns().items():
        setattr(ad, f"_{name}",
                lambda *inputs, step=step: step.fn(*step.load(*inputs)))
    trace, logits = RouterTrace(cfg.n_layers - 1), {}
    with trace, torch.no_grad():
        for uid, slot, prompt in admit:
            ad.insert(slot, prompt, max_new=n_ticks + 1)
            stats = ad.slot_stats(slot) if hasattr(ad, "slot_stats") else {}
            trace.prefill(uid, stats.get("prefill_tokens_skipped", 0))
            logits[uid] = [ad.last_prefill_logits[0].float().cpu()]
        for t in range(n_ticks):
            tokens = np.zeros(ad.n_slots, np.int32)
            active = np.zeros(ad.n_slots, bool)
            lanes = {}
            for uid, slot, prompt in admit:
                tokens[slot], active[slot] = streams[uid][t], True
                lanes[slot] = (uid, len(prompt) + t)
            ad.decode(tokens, active)
            trace.tick(lanes)
            for uid, slot, _ in admit:
                logits[uid].append(ad.last_logits[slot].float().cpu())
    del gw, ad
    torch.cuda.empty_cache()
    return trace.rows, logits


def routing_near_tie(cfg, uid: int, k: int, ta, tb, a: tuple, b: tuple
                     ) -> dict:
    """Replays ``a`` and ``b`` (:func:`replay_routing`'s results) of one
    request whose streams first differ at token ``k``: whether each replay
    reproduces its run's token k, and the first (position, layer) of the
    shared history at which the two route the token to other experts, with
    ``b``'s margin for its experts over ``a``'s in router logits beside the
    two rows' max |difference|.  The difference is a routing near tie when
    both replays reproduce it and margin <= difference <= NEAR_TIE_BOUND,
    the near-tie rule on the router's logits."""
    import torch

    (rows_a, logits_a), (rows_b, logits_b) = a, b
    reproduced = int(logits_a[uid][k].argmax()) == ta[k] and \
        int(logits_b[uid][k].argmax()) == tb[k]
    out = {"reproduced": reproduced, "layer": None, "near_tie": False}
    keys = sorted((key for key in rows_a if key[0] == uid and key in rows_b),
                  key=lambda key: (key[2], key[1]))
    for key in keys:
        la, lb = rows_a[key], rows_b[key]
        ea, eb = (set(torch.sort(r, descending=True, stable=True)
                      .indices[:cfg.top_k].tolist()) for r in (la, lb))
        if ea == eb:
            continue
        d = float((la - lb).abs().max())
        margin = max(float(lb[e] - lb[f]) for e in eb - ea for f in ea - eb)
        # layer 0 is the dense one: the MoE blocks are layers 1 on
        out.update(layer=key[1] + 1, position=key[2], margin=margin,
                   max_abs_drouter_logit=d,
                   near_tie=reproduced and margin <= d <= NEAR_TIE_BOUND)
        break
    return out


def trace_routing(cfg, params, diffs: list, specs: tuple, a_run: dict,
                  prompts, whole_load: bool) -> None:
    """For the moe family, each first difference in ``diffs`` (of runs
    ``a_run`` and b, made with ``specs`` (a's, b's)) that is not a near tie
    in the logits is traced to the router (:func:`routing_near_tie`) and
    counts as a near tie when it is one there; ``diffs`` is updated in
    place (each traced entry gains "routing").  ``whole_load`` replays
    every request in its run's slot (the cascade groups lanes), else the
    traced requests alone, a slot each."""
    bad = [d for d in diffs if not d["near_tie"]]
    if cfg.family != "moe" or not bad:
        return
    tokens = a_run["tokens"]
    if whole_load:
        groups = [[(u, a_run["slot"][u], prompts[u]) for u in sorted(tokens)]]
    else:
        n = specs[0].n_slots
        uids = [d["uid"] for d in bad]
        groups = [[(u, j, prompts[u]) for j, u in enumerate(uids[i:i + n])]
                  for i in range(0, len(uids), n)]
    for admit in groups:
        here = [d for d in bad if d["uid"] in {u for u, _, _ in admit}]
        n_ticks = max(d["token"] for d in here)
        a, b = (replay_routing(cfg, params, spec, admit, tokens, n_ticks)
                for spec in specs)
        for d in here:
            # the token a's stream has where b's differs: b's stream is
            # a's up to k, then b's token
            tb = tokens[d["uid"]][:d["token"]] + [d["b_token"]]
            d["routing"] = routing_near_tie(cfg, d["uid"], d["token"],
                                            tokens[d["uid"]], tb, a, b)
            d["near_tie"] = d["routing"]["near_tie"]


def dense_pairs(cfg) -> dict:
    """The gateway pairs phase 10 compares, name -> (paged backend a,
    paged backend b or None for the dense gateway): dense against the
    kernel tick, and the gather oracle against the plain and the kernel
    tick; for the vlm family, whose tick is the plain one only, dense and
    gather against the plain tick."""
    if cfg.family == "vlm":
        return {"dense_vs_plain": ("plain", None),
                "gather_vs_plain": ("plain", "gather")}
    return {"dense_vs_cuda": ("cuda", None),
            "gather_vs_plain": ("plain", "gather"),
            "gather_vs_cuda": ("cuda", "gather")}


def paged_spec(backend):
    """Phase 10's one-shot paged gateways on the default geometry."""
    from repro_torch.serve.spec import ServeSpec
    return ServeSpec(paged=True, chunked=False, backend=backend)


def pair_backends(pairs: dict) -> list[str]:
    """The paged backends :func:`dense_pairs`' pairs use, in the order
    "cuda", "plain", "gather"."""
    return [b for b in ("cuda", "plain", "gather")
            if any(b in ab for ab in pairs.values())]


def strict_dense_paths(dev, cfg4, params4, prompts
                       ) -> tuple[dict, list, dict]:
    """Phase 10's comparisons on a float32 model (``strict_cfg``): the
    default gateway and the paged ones of :func:`dense_pairs` on
    ``prompts``, tokens equal with logits within 2e-4, the gather tick bit
    for bit the plain tick.  Returns (per pair the differences, the
    failures, the default gateway's tokens)."""
    from repro_torch.serve.spec import ServeSpec

    pairs = dense_pairs(cfg4)
    dense4 = serve_spec_load(dev, cfg4, params4, prompts, ServeSpec())
    runs4 = {b: serve_spec_load(dev, cfg4, params4, prompts, paged_spec(b))
             for b in pair_backends(pairs)}
    f32 = {name: stream_differences(runs4[a], runs4[b] if b else dense4)
           for name, (a, b) in pairs.items()}
    failures = []
    for name, d in f32.items():
        if not (d["tokens_equal"] and d["max_abs_dlogit"] <= 2e-4):
            failures.append(f"float32 depth {cfg4.n_layers} {name}: tokens "
                            f"equal {d['tokens_equal']}, max |dlogit| "
                            f"{d['max_abs_dlogit']}")
    # the gather oracle runs the in-place plain tick's arithmetic on a
    # gathered copy: bit for bit
    if f32["gather_vs_plain"]["max_abs_dlogit"] != 0:
        failures.append(f"float32 depth {cfg4.n_layers}: the gather tick is "
                        f"not bit for bit the plain tick: "
                        f"{f32['gather_vs_plain']}")
    return f32, failures, dense4["tokens"]


def dense_main_path(dev, cfg, params, *, sc: bool = True,
                    runs: int | None = None, strict: bool = True,
                    keep: dict | None = None,
                    eager_profile: bool = True) -> dict:
    """Phase 10: the dense KV path (the default ``ServeSpec()`` gateway),
    the gather-tick oracle and (``sc``) the SC LM frontend at the config's
    full width; for the moe family also the router gaps of the default
    gateway's streams (:func:`router_gaps`), in bf16 at full depth and in
    float32 at depth 4 (``strict``; :func:`strict_dense_paths`, which the
    vlm phase runs on its own float32 model once the bf16 one is freed).
    Returns the kernels' launches on the default
    gateway's load ("dense") and on the SC gateways' ("sc", None without
    ``sc``); ``runs``: the tick timing's runs a side, ``eager_profile``
    whether it profiles the eager step too (:func:`tick_timing`);
    ``keep``, where given, receives the default gateway's bf16 run under
    "dense" (:func:`serve_spec_load`).  Raises SystemExit on a failed
    check."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import sc_dot as sc_dot_k
    from repro_torch.kernels import sng_pack as sng_pack_k
    from repro_torch.models import lm
    from repro_torch.serve.gateway.slots import Request
    from repro_torch.serve.spec import ServeSpec, make_gateway

    failures = []
    sw = Stopwatch()
    prompts = dense_prompts(cfg.vocab)
    n_req = len(prompts)
    default = ServeSpec()
    new = default.max_new_tokens
    pairs = dense_pairs(cfg)

    def served_all(run) -> bool:
        return run["served"] == n_req and run["finite"] and \
            sorted(map(len, run["tokens"].values())) == [new] * n_req

    # (1) the default gateway (dense slots), bf16 at full depth
    dense = serve_spec_load(dev, cfg, params, prompts, default)
    if keep is not None:
        keep["dense"] = dense
    want = {name: 0 for name in dense["launches"]}
    want["flash_attention"] = flash_launches(cfg, n_req, n_req)
    if dense["adapter"] != "KVSlotAdapter" or not served_all(dense) or \
            dense["launches"] != want or dense["captures"] != {"decode": 1}:
        failures.append(f"default gateway: adapter {dense['adapter']}, "
                        f"served {dense['served']}, finite "
                        f"{dense['finite']}, launches {dense['launches']}, "
                        f"captures {dense['captures']}")
    sw.lap("default_gateway")

    # (2) the captured dense tick against its eager step, four lanes mid
    # stream: logits and the whole cache bit for bit, then host ms per
    # tick in turns (the lengths put back after every tick)
    gw = make_gateway(cfg, params, default, extras=extras_of(cfg),
                      device=dev)
    ad, batcher = gw.batcher.adapter, gw.batcher
    for i, p in enumerate(prompts[:default.n_slots]):
        batcher.submit(Request(uid=i, prompt=p, max_new_tokens=new))
    batcher.step()              # admits four; the first tick captures
    toks = batcher.last_token.copy()
    active = np.asarray([r is not None for r in batcher.active])
    replay = tick_replay_check(ad, toks, active, state=ad.cache)
    len0 = ad.cache["len"].clone()
    timing = tick_timing(ad, toks, active,
                         after=lambda: ad.cache["len"].copy_(len0), runs=runs,
                         eager_profile=eager_profile)
    prof = timing["profile"]["captured"]
    if not (replay["logits_bitwise"] and replay["arena_bitwise"]
            and replay["launches_equal"] and replay["logits_finite"]
            and replay["rows_written"]["len"] == default.n_slots):
        failures.append(f"dense tick: the replay differs from the eager "
                        f"step: {replay}")
    if prof["graph_launches_per_tick"] != 1:
        failures.append(f"dense tick: {prof['graph_launches_per_tick']} "
                        "graph launches per tick")
    del gw, ad, batcher
    torch.cuda.empty_cache()
    sw.lap("dense_tick")

    # (3) the paged gateways on the same load, bf16 full depth: the flat
    # kernel tick (not for the vlm family), the in-place plain tick and
    # the gather oracle
    runs = {b: serve_spec_load(dev, cfg, params, prompts, paged_spec(b))
            for b in pair_backends(pairs)}
    gaps = {"bf16": router_gaps(cfg, params, prompts, dense["tokens"])} \
        if cfg.moe else {}
    bf16 = {name: stream_differences(runs[a], runs[b] if b else dense)
            for name, (a, b) in pairs.items()}
    for name, (a, b) in pairs.items():
        trace_routing(cfg, params, bf16[name]["first_differences"],
                      (paged_spec(a), paged_spec(b) if b else default),
                      runs[a], prompts, whole_load=False)
    for name, r in runs.items():
        if not served_all(r) or r["captures"] != {"decode": 1}:
            failures.append(f"paged {name}: served {r['served']}, finite "
                            f"{r['finite']}, captures {r['captures']}")
    for name, d in bf16.items():
        if not all(x["near_tie"] for x in d["first_differences"]):
            failures.append(f"bf16 {name}: a difference that is not a near "
                            f"tie: {d['first_differences']}")
    sw.lap("paged_bf16")

    # (4) float32 at depth 4 (encdec: whole): tokens equal, logits within
    # 2e-4
    f32 = None
    if strict:
        cfg4 = strict_cfg(cfg)
        params4 = lm.init(cfg4, torch.Generator(device=dev).manual_seed(1))
        f32, bad, tokens4 = strict_dense_paths(dev, cfg4, params4, prompts)
        failures += bad
        if cfg.moe:
            gaps["f32_depth4"] = router_gaps(cfg4, params4, prompts,
                                             tokens4)
        del params4
        torch.cuda.empty_cache()
        sw.lap("f32")

    dense_launches = {"flash_attention":
                      dense["launches"]["flash_attention"]}

    def summary(r):
        return {"adapter": r["adapter"], "backend": r["backend"],
                "run_s": r["run_s"], "served": r["served"],
                "ticks": len(r["tick_ms"]),
                "tick_ms_median": statistics.median(r["tick_ms"]),
                "captures": r["captures"],
                "launches": {k: v for k, v in r["launches"].items() if v}}
    line = {"phase": "dense_main_path", "model": cfg.name,
            "spec": {"n_slots": default.n_slots, "max_len": default.max_len,
                     "max_new_tokens": new},
            "prompt_lens": list(DENSE_PROMPT_LENS),
            "default_gateway": summary(dense),
            "dense_tick": {"replay": replay, **timing},
            "paged_runs": {b: summary(r) for b, r in runs.items()},
            "bf16": bf16, **({"f32_depth4": f32} if strict else {}),
            "router_gap_k_to_k_plus_1": gaps}
    if not sc:
        emit({**line, "launches": {"dense": dense_launches},
              "failures": failures, **sw.fields()})
        if failures:
            raise SystemExit(f"dense path ({cfg.name}): {failures}")
        return dense_launches, None

    # (5) the SC frontend at bits 4 on the full-width weights: one prompt's
    # output bit for bit the plain versions' on the same CUDA tensors
    # (sng_pack and sc_dot at K = 2,560, two banks of 2,560), then the
    # load through the dense gateway and the paged ones (one-shot, and the
    # chunked fold: the frontend runs on every chunk)
    cfg_sc = dataclasses.replace(cfg, first_layer_mode="sc", sc_bits=4)
    gen = torch.Generator(device=dev).manual_seed(2)
    params_sc = dict(params, sc_frontend=lm.init(
        dataclasses.replace(cfg_sc, n_layers=1), gen)["sc_frontend"])
    x = lm.token_rows(params, torch.from_numpy(prompts[0][None]).to(dev))
    reset_counts()
    got = lm.sc_frontend(cfg_sc, params_sc["sc_frontend"], x)
    torch.cuda.synchronize()
    call_launches = {n: read_counts()[n] for n in ("sng_pack", "sc_dot")}

    def plain_sc_dot(x, w, s0_mode="alt", adder="tff", *, length=None):
        return ref.sc_dot(x, w, s0_mode, adder)
    with mock.patch.object(sng_pack_k, "sng_pack", ref.sng_pack), \
            mock.patch.object(sc_dot_k, "sc_dot", plain_sc_dot):
        plain = lm.sc_frontend(cfg_sc, params_sc["sc_frontend"], x)
    torch.cuda.synchronize()
    frontend_bitwise = bool(torch.equal(got, plain))
    gamma = params_sc["sc_frontend"]["gamma"].float()
    ternary = set(torch.unique(torch.round(got.float() / gamma, decimals=2))
                  .tolist()) <= {-1.0, 0.0, 1.0}
    if not frontend_bitwise or not ternary or \
            call_launches != {"sng_pack": 2, "sc_dot": 1}:
        failures.append(f"SC frontend: bitwise vs plain {frontend_bitwise}, "
                        f"ternary {ternary}, launches {call_launches}")
    sc_runs = {"dense": serve_spec_load(dev, cfg_sc, params_sc, prompts,
                                        default),
               "paged_oneshot": serve_spec_load(dev, cfg_sc, params_sc,
                                                prompts,
                                                paged_spec("cuda")),
               "paged_chunked": serve_spec_load(
                   dev, cfg_sc, params_sc, prompts,
                   ServeSpec(paged=True, backend="cuda"))}
    chunks = sum(-(-len(p) // ServeSpec().block_size) for p in prompts)
    for name, r in sc_runs.items():
        calls = chunks if name == "paged_chunked" else n_req
        if not served_all(r) or r["launches"]["sc_dot"] != calls or \
                r["launches"]["sng_pack"] != 2 * calls:
            failures.append(f"sc {name}: served {r['served']}, finite "
                            f"{r['finite']}, launches {r['launches']}, "
                            f"expected {calls} frontend calls")
    sc_vs = stream_differences(sc_runs["paged_oneshot"], sc_runs["dense"])
    if not all(x["near_tie"] for x in sc_vs["first_differences"]):
        failures.append(f"sc bf16 dense vs paged: a difference that is not "
                        f"a near tie: {sc_vs['first_differences']}")
    sc_launches = {n: sum(r["launches"][n] for r in sc_runs.values())
                   for n in ("sng_pack", "sc_dot", "flash_attention")}
    emit({**line,
          "sc": {"bits": 4, "frontend_bitwise_vs_plain": frontend_bitwise,
                 "frontend_ternary": ternary,
                 "frontend_launches_per_call": call_launches,
                 "prompt_tokens": int(prompts[0].size),
                 "fold_chunks": chunks,
                 "runs": {n: summary(r) for n, r in sc_runs.items()},
                 "dense_vs_paged_bf16": sc_vs},
          "launches": {"dense": dense_launches, "sc": sc_launches},
          "failures": failures, **(sw.lap("sc") or sw.fields())})
    if failures:
        raise SystemExit(f"dense path: {failures}")
    return dense_launches, sc_launches


# -- the moe family: deepseek-moe-16b (phase 11) -----------------------------

MOE_ARCH = "deepseek-moe-16b"
# deepseek-moe-16b's attention: 16 heads of 128 (MHA), 28 layers
MOE_H, MOE_D = 16, 128
# phase 11's captured-against-eager tick timings take this many runs a side
# (an eager tick takes 90-160 ms on an H100 at this width, PERF.md), so
# that the phase stays near two minutes
MOE_HOST_RUNS = 3
# phase 11's depth: the dense layer 0 and 9 MoE layers of the 28, at full
# width (cut to give the script's time to phase 19; the float32
# comparisons run at depth 4 whatever this is)
MOE_DEPTH = 10


def attn_shape_checks(dev, gen, sleep: int, n_layers: int, *, tag: str,
                      hq: int, hkv: int, d: int, n_pos: int = 1024,
                      fold_offset: int = 512, one_len: int = 1000,
                      windows: tuple = (None,),
                      cut_len: int | None = None,
                      noncausal: tuple = ()) -> dict:
    """The attention kernels at a config's head geometry (``hq`` query
    heads over ``hkv`` KV heads of ``d``), each against its plain version
    in float32 and bf16 (within 2e-5 / 2e-2; the row write bit for bit) at
    every window of ``windows`` (None: no window): ``paged_decode_attention``
    at 8 lanes of ``n_pos + 1`` to ``n_pos + 8`` positions (the new row
    spliced in) in the tick's (8, 96) tables, split as planned and in one
    split; ``scatter_kv_rows`` at ``n_layers`` layers from one tensor per
    layer; ``flash_attention`` at a fold chunk (16 queries at
    ``fold_offset``) and a ``one_len``-token one-shot prompt (and, with
    ``cut_len``, a ``cut_len``-token prompt whose window cuts: a check,
    not timed), and non-causal at each (label, queries, keys) of
    ``noncausal`` (as planned, unsplit and one 64-key tile per split: the
    checks force the plans), a repeated call bitwise; the cascade's prefix
    pass and its
    suffix pass with the merge fused, load (c)'s eight lanes sharing a
    1,024-position chain with 65-position suffixes.  Then each timed in
    bf16 at the first window beside its plain version, its bound (bytes /
    3.35 TB/s, or operations / the peak of their type, for the positions
    this window leaves) and ``F.scaled_dot_product_attention`` on the same
    masked problem (``index_put_`` for the row write).  Prints the
    ``<tag>_kernel_checks`` and ``<tag>_shapes_timing`` lines and returns
    the timing rows; raises SystemExit on a failed check."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as flash_k
    from repro_torch.kernels import paged_attn as paged_k
    from repro_torch.kernels import ref
    from repro_torch.nn import attention

    H, D, bs, B = hq, d, LM_BLOCK, LM_SLOTS
    nb = LM_MAX_LEN // bs
    i32 = dict(dtype=torch.int32, device=dev)

    def arr(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def band(lo, hi, n) -> torch.Tensor:
        """(rows, n) bool: key j valid for row r when lo[r] <= j < hi[r]."""
        j = torch.arange(n, device=dev)
        return (j[None] >= lo[:, None]) & (j[None] < hi[:, None])

    def case(dtype, window):
        """Every kernel's inputs at these shapes and window, and per
        kernel (kernel, plain, library, bytes, operations)."""
        win = window or ref.NO_WINDOW
        num_blocks = B * nb + 1
        perm = torch.randperm(num_blocks - 1, generator=gen,
                              device=dev) + 1
        used = -(-(n_pos + B) // bs)
        tables = torch.zeros((B, nb), **i32)
        tables[:, :used] = perm[:B * used].reshape(B, used).to(torch.int32)
        lens = torch.arange(n_pos + 1, n_pos + B + 1, **i32)
        q = arr((B, H, D), dtype)
        ka, va = (arr((num_blocks, bs, hkv, D), dtype) for _ in range(2))
        nk = (arr((B, hkv, D), dtype), arr((B, hkv, D), dtype))
        rows = ([arr((B, hkv, D), dtype) for _ in range(n_layers)],
                [arr((B, hkv, D), dtype) for _ in range(n_layers)])
        el = ka.element_size()
        row = hkv * D * el                      # bytes of one K or V row
        # the row write into an arena of its own, one block per lane
        wb, offs = torch.arange(1, B + 1, **i32), lens % bs
        # load (c)'s group: the chain is the first 64 blocks of lane 0's
        # table, each lane's suffix its own 5 blocks (64 tail positions and
        # the new token's)
        npre = SHARED_PROMPT // bs
        gt = tables[:1, :npre].contiguous()
        st = perm[B * used:B * used + B * 5].reshape(B, 5).to(torch.int32)
        glen = torch.tensor([SHARED_PROMPT], **i32)
        cl = SHARED_PROMPT + OWN_TAIL + 1 + torch.arange(B, **i32) % 2
        meta = attention.with_lane_meta(
            {"group_lanes": torch.arange(B, **i32)[None],
             "group_mask": torch.ones((1, B), dtype=torch.bool,
                                      device=dev)}, cl)
        q0 = glen.expand(B).contiguous()
        Sk = fold_offset + 16
        fold = (arr((1, 16, H, D), dtype), arr((1, Sk, hkv, D), dtype),
                arr((1, Sk, hkv, D), dtype))
        one = (arr((1, one_len, H, D), dtype),
               arr((1, one_len, hkv, D), dtype),
               arr((1, one_len, hkv, D), dtype))
        L = n_layers
        ka_l = torch.zeros((L, B + 1, 1, bs, hkv, D), dtype=dtype,
                           device=dev)
        va_l = torch.zeros_like(ka_l)
        # the positions each pass reads at this window: this run's work
        lo = torch.clamp(lens - win, min=0)
        live = int((lens - lo).sum())
        pre_lo = torch.clamp(cl - win, min=0)
        pre_rows = int((SHARED_PROMPT - pre_lo).clamp(min=0).sum())
        pre_keys = SHARED_PROMPT - min(int(pre_lo.min()), SHARED_PROMPT)
        suf_lo = torch.maximum(q0, cl - win)
        suf = int((cl - suf_lo).sum())
        # the fold chunk's K/V rows inside some query's window
        fold_rows = Sk - max(0, fold_offset - win + 1)

        def pairs(Sq, off):
            return sum(min(off + i + 1, win) for i in range(Sq))

        def prompt_mask(Sq, Skk, off):
            r = off + torch.arange(Sq, device=dev)[:, None] - \
                torch.arange(Skk, device=dev)[None, :]
            return (r >= 0) & (r < win)

        def sdpa(qq, kk, vv, mask):
            return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask,
                                                  enable_gqa=True)
        # the library's problems on gathered views (the gather not timed)
        n_max = n_pos + B
        kd, vd = (a[tables.long()].reshape(B, nb * bs, hkv, D)[:, :n_max]
                  .transpose(1, 2).contiguous() for a in (ka, va))
        pmask = band(lo, lens, n_max)[:, None, None]
        kc, vc = (a[gt.long()].reshape(1, -1, hkv, D).transpose(1, 2)
                  .contiguous() for a in (ka, va))
        cmask = band(pre_lo, torch.full_like(cl, SHARED_PROMPT),
                     SHARED_PROMPT)[None, None]
        ks, vs = (a[st.long()].reshape(B, -1, hkv, D).transpose(1, 2)
                  .contiguous() for a in (ka, va))
        smask = band(suf_lo - q0, cl - q0, ks.shape[2])[:, None, None]
        idx = (torch.arange(L, device=dev)[:, None], wb.long()[None, :],
               torch.zeros((1, 1), dtype=torch.long, device=dev),
               offs.long()[None, :])
        kr, vr = torch.stack(rows[0]), torch.stack(rows[1])
        fm, om = prompt_mask(16, Sk, fold_offset), \
            prompt_mask(one_len, one_len, 0)
        ft = tuple(t.transpose(1, 2).contiguous() for t in fold)
        ot = tuple(t.transpose(1, 2).contiguous() for t in one)
        calls = {
            "paged_decode_attention": (
                lambda: paged_k.paged_decode_attention(
                    q, ka, va, tables, lens, window=window, new_kv=nk),
                lambda: ref.paged_decode_attention(q, ka, va, tables, lens,
                                                   window, nk),
                lambda: sdpa(q[:, :, None], kd, vd, pmask),
                2 * live * row + 2 * q.numel() * el + tables.numel() * 4,
                4 * H * live * D),
            "scatter_kv_rows": (
                lambda: paged_k.scatter_kv_rows(ka_l, va_l, *rows, wb, offs)
                or (ka_l, va_l),
                lambda: ref.scatter_kv_rows(ka_l.clone(), va_l.clone(),
                                            kr, vr, wb, offs),
                lambda: (ka_l.index_put_(idx, kr), va_l.index_put_(idx, vr)),
                2 * 2 * L * B * row + 2 * B * 4, 0),
            "flash_attention fold chunk": (
                lambda: flash_k.flash_attention(*fold, window=window,
                                                q_offset=fold_offset),
                lambda: ref.flash_attention_chunked(*fold, True, window,
                                                    fold_offset),
                lambda: sdpa(*ft, fm),
                2 * fold[0].numel() * el + 2 * fold_rows * row,
                4 * H * D * pairs(16, fold_offset)),
            "flash_attention one-shot": (
                lambda: flash_k.flash_attention(*one, window=window),
                lambda: ref.flash_attention_chunked(*one, True, window, 0),
                lambda: sdpa(*ot, om),
                (2 * one[0].numel() + 2 * one[1].numel()) * el,
                4 * H * D * pairs(one_len, 0)),
            "cascade_prefix_attention": (
                lambda: paged_k.cascade_prefix_attention(
                    q[None], ka, va, gt, glen, cl[None], window=window),
                lambda: ref.cascade_prefix_attention(
                    q[None], ka, va, gt, glen, cl[None], window),
                lambda: sdpa(q.transpose(0, 1)[None], kc, vc, cmask),
                2 * pre_keys * row + q.numel() * el + B * H * (D + 2) * 4,
                4 * H * pre_rows * D),
            "paged_decode_attention_with_state (merge fused)": (
                lambda: paged_k.paged_decode_attention_with_state(
                    q, ka, va, st, cl, window=window, q0=q0, new_kv=nk,
                    prefix=prefix[dtype, window] + (meta["lane_slot"],)),
                lambda: ref.paged_decode_attention_merged(
                    q, ka, va, st, cl, window, q0, nk,
                    prefix[dtype, window] + (meta["lane_slot"],)),
                lambda: sdpa(q[:, :, None], ks, vs, smask),
                2 * suf * row + 2 * q.numel() * el + B * H * (D + 2) * 4,
                4 * H * suf * D)}
        for label, Sq, Skk in noncausal:
            nc = (arr((1, Sq, H, D), dtype), arr((1, Skk, hkv, D), dtype),
                  arr((1, Skk, hkv, D), dtype))
            nct = tuple(t.transpose(1, 2).contiguous() for t in nc)
            calls[f"flash_attention non-causal {label}"] = (
                lambda nc=nc: flash_k.flash_attention(*nc, causal=False),
                lambda nc=nc: ref.flash_attention_chunked(*nc, False),
                lambda nct=nct: sdpa(*nct, None),
                (2 * nc[0].numel() + 2 * nc[1].numel()) * el,
                4 * H * D * Sq * Skk)
        if cut_len:
            cut = tuple(arr((1, cut_len, h, D), dtype) for h in (H, hkv, hkv))
            calls["flash_attention window cut"] = (
                lambda: flash_k.flash_attention(*cut, window=window),
                lambda: ref.flash_attention_chunked(*cut, True, window, 0),
                None, 0, 0)
        return calls

    checks, err, prefix, timing = [], {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for window in windows:
            calls = case(dtype, window)
            prefix[dtype, window] = calls["cascade_prefix_attention"][0]()
            tol = 2e-5 if dtype == torch.float32 else 2e-2
            for name, (kernel, plain, *_) in calls.items():
                plans = {"": contextlib.nullcontext}
                if name == "paged_decode_attention":
                    plans = {" (split)": contextlib.nullcontext,
                             " (one split)": functools.partial(
                                 mock.patch.object, paged_k,
                                 "SPLIT_POSITIONS", nb * bs)}
                if "non-causal" in name:
                    plans = {" (planned)": contextlib.nullcontext,
                             " (unsplit)": functools.partial(
                                 mock.patch.object, flash_k, "MIN_CTAS", 0),
                             " (one tile per split)": functools.partial(
                                 mock.patch.object, flash_k, "MIN_CTAS",
                                 1 << 30)}
                for label, plan in plans.items():
                    with plan():
                        got, want = kernel(), plain()
                        again = kernel()
                    got = got if isinstance(got, tuple) else (got,)
                    want = want if isinstance(want, tuple) else (want,)
                    again = again if isinstance(again, tuple) else (again,)
                    bitwise = name == "scatter_kv_rows"
                    if bitwise:         # the trash block 0 takes collisions
                        got, want = (g[:, 1:] for g in got), \
                            (w[:, 1:] for w in want)
                    e = max(float((g.float() - w.float()).abs().max())
                            for g, w in zip(got, want))
                    ok = e == 0 if bitwise else all(
                        torch.allclose(g.float(), w.float(), rtol=tol,
                                       atol=tol)
                        for g, w in zip(got, want))
                    ok &= bitwise or all(torch.equal(g, a)
                                         for g, a in zip(got, again))
                    checks.append({"kernel": name + label,
                                   "dtype": str(dtype), "window": window,
                                   "max_abs_err": e, "ok": bool(ok)})
                    key = name.split(" ")[0]
                    err[key] = max(err.get(key, 0.0), e)
            if dtype == torch.bfloat16 and window == windows[0]:
                for name, (kernel, plain, lib, n_bytes,
                           ops) in calls.items():
                    if lib is None:
                        continue
                    ms, b2b = time_ms(kernel, 5, 20, sleep)
                    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
                    ops_ms = ops / BF16_FLOPS * 1e3     # bf16 operands
                    timing[name] = {
                        "ms": ms, "back_to_back_ms": b2b,
                        "plain_ms": time_ms(plain, 3, 3, sleep, b2b=False)[0],
                        "library_ms": time_ms(lib, 5, 20, sleep, b2b=False)[0],
                        "bound_ms": max(bytes_ms, ops_ms),
                        "bound_by": "bytes" if bytes_ms >= ops_ms
                        else "operations", "bytes_ms": bytes_ms,
                        "ops_ms": ops_ms}
                timing["paged_decode_attention"]["splits"] = \
                    paged_k.paged_split_plan(nb, bs)[0]
            del calls
            torch.cuda.empty_cache()
    bad = [c for c in checks if not c["ok"]]
    heads = f"{H} x {D}" + (" (MHA)" if H == hkv else
                            f" over {hkv} KV heads")
    emit({"phase": f"{tag}_kernel_checks", "heads": heads,
          "windows": list(windows), "checks": len(checks), "failed": bad,
          "max_abs_err": err, "cases": checks})
    emit({f"{tag}_shapes_timing": timing,
          "shapes": f"bf16, window {windows[0]}; paged: q ({B}, {H}, {D}) "
                    f"over {hkv} KV heads, {n_pos + 1}...{n_pos + B} "
                    f"positions, tables ({B}, {nb}), splice on; scatter: "
                    f"{n_layers} layers x ({B}, {hkv}, {D}) rows; flash: 16 "
                    f"queries at {fold_offset}, {one_len}-token prompt; "
                    f"cascade: {B} lanes on a {SHARED_PROMPT}-position "
                    f"chain, {OWN_TAIL + 1}-position suffixes; "
                    + "".join(f"flash non-causal {lb}: {Sq} queries over "
                              f"{Skk} keys; " for lb, Sq, Skk in noncausal)
                    + "library: "
                    "F.scaled_dot_product_attention (enable_gqa, boolean "
                    "window mask) on gathered views (the gather not "
                    "timed), index_put_ for the row write"})
    if bad:
        raise SystemExit(f"a kernel disagrees with its plain version at "
                         f"{heads}: {bad}")
    return timing


def router_gaps(cfg, params, prompts, tokens) -> dict:
    """The least gap between the top_k-th and the next router probability
    over every token and MoE layer of the served streams (each prompt and
    its generated tokens, less the last, through one eager prefill with
    the router observed, :class:`RouterTrace`): a first difference between
    two streams can then be traced to a routing near tie."""
    import numpy as np
    import torch

    from repro_torch.serve import engine

    with RouterTrace(cfg.n_layers - 1) as trace, torch.no_grad():
        for uid, prompt in enumerate(prompts):
            seq = np.concatenate([prompt, tokens[uid][:-1]]).astype(np.int32)
            engine.prefill(cfg, params, torch.from_numpy(seq[None]).to(
                params["embed"].device))
            trace.prefill(uid, 0)
    top = torch.stack(list(trace.rows.values())).softmax(-1).topk(
        cfg.top_k + 1, dim=-1).values
    gap = top[:, -2] - top[:, -1]
    return {"min": float(gap.min()),
            "below_1e-4": int((gap < 1e-4).sum()),
            "below_1e-3": int((gap < 1e-3).sum()),
            "token_layers": int(gap.numel())}


def moe_main_path(dev, sleep: int) -> dict:
    """Phase 11: the moe family at deepseek-moe-16b's published width cut
    to ``MOE_DEPTH`` layers (dense layer 0 and MOE_DEPTH - 1 MoE layers of
    the 28; d_model 2,048, 16 heads of 128, 64 routed experts of 1,408
    top-6 and 2 shared, dense layer 0 of 10,944, vocabulary 102,400;
    bf16, random weights drawn on the card, routed dropless in prefill as
    the reference serves it) through every serving path, with the earlier
    phases' helpers: the attention kernels at 16 heads of 128
    (:func:`attn_shape_checks`); the default ``ServeSpec()`` dense gateway
    and the paged ``"cuda"``, ``"plain"`` and ``"gather"`` gateways, float32
    at depth 4 (dense layer 0 and 3 MoE layers at full width) and bf16 at
    the phase's depth (:func:`dense_main_path`, with :func:`router_gaps`); load
    (c) through the cascade tick against the flat tick, served once per
    gateway (:func:`cascade_main_path`); load (b) chunked, the resumed fold
    bit for bit the cold one (:func:`chunked_main_path`); the captured
    ticks against their eager steps (:func:`capture_main_path`; the tick
    timings at ``MOE_HOST_RUNS`` runs a side, the captured step
    profiled).  In bf16 a first difference between
    two gateways' streams may also be a near tie of the router's logits
    (:func:`trace_routing`).  Returns the kernels' launches over the path;
    raises SystemExit on a failed check."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(configs.config(MOE_ARCH), n_layers=MOE_DEPTH,
                              moe_dropless_prefill=True)
    t0 = time.perf_counter()
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sizes = param_sizes(params)
    n_params = sum(sizes.values())
    routed = sum(n for k, n in sizes.items()
                 if k.startswith("blocks.moe.w_"))
    gen = torch.Generator(device=dev).manual_seed(11)
    seconds, launches = {}, {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    timing = timed("kernel_checks", attn_shape_checks, dev, gen, sleep,
                   cfg.n_layers, tag="moe", hq=MOE_H, hkv=MOE_H, d=MOE_D)
    dense, _ = timed("dense_path", dense_main_path, dev, cfg, params,
                     sc=False, runs=MOE_HOST_RUNS, eager_profile=False)
    add(dense)
    add(timed("cascade_path", cascade_main_path, dev, cfg, params,
              turns=False,
              host_runs=MOE_HOST_RUNS, eager_profile=False))
    chunked = timed("chunked_path", chunked_main_path, dev, cfg, params,
                    loads="b")
    add(chunked["launches"])
    capture = timed("capture", capture_main_path, dev, cfg, params,
                    runs=MOE_HOST_RUNS, eager_profile=False)
    flat = capture["flat_8x1k"]
    # a model of the tick's bytes, not a measurement: every bf16 weight but
    # the embedding read once (the routed experts all, as the reference's
    # einsum reads them), lm_head's float32 copy written and read, and the
    # K and V rows of 8 lanes x 1,024 positions
    kv_bytes = 2 * cfg.n_layers * MOE_H * MOE_D * 2 * LM_SLOTS * 1024
    tick_bytes = 2 * (n_params - sizes["embed"]) + \
        8 * sizes["lm_head"] + kv_bytes
    emit({"phase": "moe_main_path", "model": cfg.name,
          "config": {k: getattr(cfg, k) for k in (
              "n_layers", "d_model", "n_heads", "n_kv_heads", "d_head",
              "n_experts", "top_k", "n_shared", "d_expert",
              "first_dense_ff", "vocab", "moe_dropless_prefill",
              "param_dtype")},
          "params": n_params, "routed_expert_params": routed,
          "init_s": init_s,
          "tick_8x1k_host_ms": {s: flat["host_ms"][s]["median"]
                                for s in ("captured", "eager")},
          "tick_8x1k_device_busy_ms":
              flat["profile"]["captured"]["device_busy_ms_per_tick"],
          "tick_8x1k_top_device_ms":
              flat["profile"]["captured"]["top_device_ms_per_tick"],
          "tick_bytes_model": tick_bytes,
          "tick_bytes_bound_ms": tick_bytes / PEAK_BYTES_PER_S * 1e3,
          "tick_bytes_analytic": analytic_tick(cfg, tick_bytes, 1024),
          "oneshot_prefill_1000_ms": chunked["oneshot_prefill_1000_ms"],
          "cold_fold_ms_per_chunk": chunked["cold_fold_ms_per_chunk"],
          "launches": launches, "kernel_ms": {
              k: v["ms"] for k, v in timing.items()},
          "seconds": seconds,
          "phase_s": time.perf_counter() - t_phase})
    del params
    torch.cuda.empty_cache()
    return launches


# -- the hybrid family: hymba-1.5b (phase 12) ----------------------------

HYMBA_ARCH = "hymba-1.5b"
# hymba-1.5b's attention: 25 query heads over 5 KV heads of 64 (GQA 5:1),
# a window of 1,024 on 30 of its 32 layers (layers 0 and 16 global)
HYMBA_HQ, HYMBA_HKV, HYMBA_D, HYMBA_WINDOW = 25, 5, 64, 1024
# the captured flat tick's contexts: past the window, so that the sliding
# layers' reads are cut by it
HYMBA_CONTEXT = 1200
# phase 12's captured-against-eager tick timings take this many runs a side
HYMBA_HOST_RUNS = 3
# phase 12's depth: layer 0 global and 5 sliding layers of the 32, at full
# width (cut to give the script's time to phases 19 and 20)
HYMBA_DEPTH = 6


def hymba_main_path(dev, sleep: int) -> dict:
    """Phase 12: the hybrid family at hymba-1.5b's published width cut to
    ``HYMBA_DEPTH`` layers of the 32 (layer 0 global, the rest sliding;
    d_model 1,600, 25 heads over 5 KV heads of 64, d_ff 5,504, SSM d_inner
    3,200 and state 16, a window of 1,024, vocabulary 32,001; bf16, random
    weights drawn on the
    card) through every serving path, with the earlier phases' helpers: the
    attention kernels at 25 x 64 over 5 KV heads, windows 1,024 and none
    (:func:`attn_shape_checks`); the default ``ServeSpec()`` dense gateway
    and the paged ``"cuda"``, ``"plain"`` and ``"gather"`` gateways, float32
    at depth 4 (layer 0 global, 1-3 sliding) and bf16 at the phase's depth
    (:func:`dense_main_path`); load (c) through the cascade tick against
    the flat tick, admitted through the fold (the one-shot prefill refuses
    1,088 tokens, as the reference's does; :func:`cascade_main_path`); load
    (b) chunked, the resumed fold bit for bit the cold one, also after the
    snapshotted slot ticked on, and one-shot against chunked admission at
    512 and 1,024 tokens (:func:`chunked_main_path`), each fold chunk
    costing ~0.15 s of host time at this width, so load (c) is served once
    per gateway (no timing turns) and the flat capture load's lanes share
    all but their last block; the captured flat
    tick at 8 lanes of 1,200-token contexts and load (c)'s cascade tick
    against their eager steps (:func:`capture_main_path`, ``HYMBA_HOST_RUNS``
    runs a side).  Returns the kernels' launches over the path; raises
    SystemExit on a failed check."""
    import torch

    from repro_torch import configs
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(configs.config(HYMBA_ARCH),
                              n_layers=HYMBA_DEPTH)
    t0 = time.perf_counter()
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sizes = param_sizes(params)
    n_params = sum(sizes.values())
    gen = torch.Generator(device=dev).manual_seed(12)
    seconds, launches = {}, {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    timing = timed("kernel_checks", attn_shape_checks, dev, gen, sleep,
                   cfg.n_layers, tag="hymba", hq=HYMBA_HQ, hkv=HYMBA_HKV,
                   d=HYMBA_D, n_pos=HYMBA_CONTEXT, fold_offset=1072,
                   one_len=1024, windows=(HYMBA_WINDOW, None), cut_len=2048)
    dense, _ = timed("dense_path", dense_main_path, dev, cfg, params,
                     sc=False, runs=HYMBA_HOST_RUNS, eager_profile=False)
    add(dense)
    add(timed("cascade_path", cascade_main_path, dev, cfg, params,
              chunked=True, turns=False,
              host_runs=HYMBA_HOST_RUNS, eager_profile=False))
    chunked = timed("chunked_path", chunked_main_path, dev, cfg, params,
                    loads="b")
    add(chunked["launches"])
    capture = timed("capture", capture_main_path, dev, cfg, params,
                    runs=HYMBA_HOST_RUNS, flat_len=HYMBA_CONTEXT,
                    chunked=True, eager_profile=False)
    flat = capture[f"flat_8x{HYMBA_CONTEXT}"]
    # a model of the tick's bytes, not a measurement: every bf16 weight but
    # the embedding read once, lm_head's float32 copy written and read, the
    # K and V rows each layer reads (8 lanes, 1,200 positions on the global
    # layers, the window's 1,024 on the sliding ones) and every layer's
    # conv taps and SSM state read and written
    ctx = HYMBA_CONTEXT + 1
    rows = sum(min(ctx, lm.layer_window(cfg, i) or ctx)
               for i in range(cfg.n_layers))
    kv_bytes = 2 * LM_SLOTS * rows * HYMBA_HKV * HYMBA_D * 2
    state_bytes = 2 * cfg.n_layers * LM_SLOTS * (
        cfg.inner * cfg.ssm_state * 4 + (cfg.conv_k - 1) * cfg.inner * 2)
    weight_bytes = 2 * (n_params - sizes["embed"])
    tick_bytes = weight_bytes + 8 * sizes["lm_head"] + kv_bytes + state_bytes
    prof = flat["profile"]["captured"]
    emit({"phase": "hymba_main_path", "model": cfg.name,
          "config": {k: getattr(cfg, k) for k in (
              "n_layers", "d_model", "n_heads", "n_kv_heads", "d_head",
              "d_ff", "d_inner", "ssm_state", "conv_k", "window",
              "global_every", "ssm_chunk", "vocab", "param_dtype")},
          "params": n_params, "init_s": init_s,
          f"tick_8x{HYMBA_CONTEXT}_host_ms": {
              s: flat["host_ms"][s]["median"] for s in ("captured", "eager")},
          f"tick_8x{HYMBA_CONTEXT}_device_busy_ms":
              prof["device_busy_ms_per_tick"],
          f"tick_8x{HYMBA_CONTEXT}_idle_share": prof["device_idle_share"],
          f"tick_8x{HYMBA_CONTEXT}_top_device_ms":
              prof["top_device_ms_per_tick"],
          "tick_bytes_model": {"weights": weight_bytes,
                               "lm_head_f32": 8 * sizes["lm_head"],
                               "kv": kv_bytes, "ssm_state": state_bytes,
                               "total": tick_bytes},
          "tick_bytes_bound_ms": tick_bytes / PEAK_BYTES_PER_S * 1e3,
          "tick_bytes_analytic": analytic_tick(cfg, tick_bytes, ctx),
          "oneshot_prefill_ms": chunked["oneshot_prefill_1000_ms"],
          "oneshot_prefill_tokens": chunked["oneshot_prefill_tokens"],
          "cold_fold_ms_per_chunk": chunked["cold_fold_ms_per_chunk"],
          "boundary_state_bytes": chunked["boundary_state_bytes"],
          "resume_bitwise": chunked["resume_bitwise"],
          "launches": launches, "kernel_ms": {
              k: v["ms"] for k, v in timing.items()},
          "seconds": seconds,
          "phase_s": time.perf_counter() - t_phase})
    del params
    torch.cuda.empty_cache()
    return launches


# -- the encdec family: whisper-medium (phase 13) -------------------------------

WHISPER_ARCH = "whisper-medium"
# whisper-medium's attention: 16 heads of 64 (MHA), 1,500 encoder frames
WHISPER_H, WHISPER_D, WHISPER_FRAMES = 16, 64, 1500
# phase 13's captured-against-eager tick timings take this many runs a side
WHISPER_HOST_RUNS = 3


def whisper_main_path(dev, sleep: int) -> dict:
    """Phase 13: the encdec family at whisper-medium's published width and
    depth (24 encoder and 24 decoder layers, d_model 1,024, 16 heads of 64,
    d_ff 4,096 with GELU and biases, LayerNorm, sinusoidal positions,
    vocabulary 51,865; bf16, random weights drawn on the card), a seeded
    (1, 1,500, 1,024) frame embedding as every admission's ``extras``,
    through every serving path with the earlier phases' helpers: the
    attention kernels at 16 x 64, ``flash_attention`` also non-causal at
    the encoder's and the cross-attention's shapes
    (:func:`attn_shape_checks`); the default ``ServeSpec()`` dense gateway
    and the paged ``"cuda"``, ``"plain"`` and ``"gather"`` gateways
    (:func:`dense_main_path`); load (c) through the cascade tick against
    the flat tick (:func:`cascade_main_path`); load (b) chunked, the
    resumed fold bit for bit the cold fold in logits, blocks and cross K/V
    (:func:`chunked_main_path`); the captured flat tick at 8 lanes of
    1,024-token contexts and load (c)'s cascade tick against their eager
    steps (:func:`capture_main_path`, ``WHISPER_HOST_RUNS`` runs a side).
    The strict float32 comparisons run at full depth
    (:func:`strict_cfg`).  Returns the kernels' launches over the path;
    raises SystemExit on a failed check."""
    import torch

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve import engine

    t_phase = time.perf_counter()
    cfg = configs.config(WHISPER_ARCH)
    t0 = time.perf_counter()
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sizes = param_sizes(params)
    n_params = sum(sizes.values())
    enc = torch.randn((1, cfg.enc_len, cfg.d_model), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(13))
    FRAMES[cfg.name] = lambda: {"enc_embed": enc}
    gen = torch.Generator(device=dev).manual_seed(14)
    seconds, launches = {}, {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    timing = timed("kernel_checks", attn_shape_checks, dev, gen, sleep,
                   cfg.n_layers, tag="whisper", hq=WHISPER_H,
                   hkv=WHISPER_H, d=WHISPER_D, n_pos=1024,
                   fold_offset=1072, one_len=1000,
                   noncausal=(("encoder", WHISPER_FRAMES, WHISPER_FRAMES),
                              ("cross prompt", 1000, WHISPER_FRAMES),
                              ("cross fold chunk", 16, WHISPER_FRAMES)))
    # the encoder alone, once per admission: its launches and host ms
    reset_counts()
    xk, xv = engine.encode_cross(cfg, params, enc)
    torch.cuda.synchronize()
    enc_launches = {k: v for k, v in read_counts().items() if v}
    encode_ms = host_ms(lambda: engine.encode_cross(cfg, params, enc),
                        reps=5)
    if enc_launches != {"flash_attention": cfg.enc_layers} or \
            tuple(xk.shape) != (cfg.n_layers, 1, cfg.enc_len,
                                cfg.n_kv_heads, cfg.d_head) or \
            not bool(torch.isfinite(xk).all() and torch.isfinite(xv).all()):
        raise SystemExit(f"encode_cross: launches {enc_launches}, xk "
                         f"{tuple(xk.shape)}")
    del xk, xv
    dense, _ = timed("dense_path", dense_main_path, dev, cfg, params,
                     sc=False, runs=WHISPER_HOST_RUNS, eager_profile=False)
    add(dense)
    add(timed("cascade_path", cascade_main_path, dev, cfg, params,
              turns=False,
              host_runs=WHISPER_HOST_RUNS, eager_profile=False))
    chunked = timed("chunked_path", chunked_main_path, dev, cfg, params,
                    loads="b")
    add(chunked["launches"])
    capture = timed("capture", capture_main_path, dev, cfg, params,
                    runs=WHISPER_HOST_RUNS, eager_profile=False)
    flat = capture["flat_8x1k"]
    # a model of the tick's bytes, not a measurement: the decoder's bf16
    # weights and lm_head read once (not the encoder's, nor the
    # embedding's), lm_head's float32 copy written and read, every
    # decoder layer's self K/V rows of 8 lanes of 1,025 positions and the
    # lanes' cross K/V over 1,500 frames
    dec_weights = 2 * sum(v for k, v in sizes.items()
                          if k.startswith("dec_blocks."))
    head = 2 * sizes["lm_head"]
    row = cfg.n_kv_heads * cfg.d_head * 2
    kv_bytes = 2 * cfg.n_layers * LM_SLOTS * 1025 * row
    cross_bytes = 2 * cfg.n_layers * LM_SLOTS * cfg.enc_len * row
    tick_bytes = dec_weights + head + 8 * sizes["lm_head"] + kv_bytes + \
        cross_bytes
    prof = flat["profile"]["captured"]
    emit({"phase": "whisper_main_path", "model": cfg.name,
          "config": {k: getattr(cfg, k) for k in (
              "n_layers", "enc_layers", "enc_len", "d_model", "n_heads",
              "n_kv_heads", "d_head", "d_ff", "mlp_type", "use_bias",
              "norm_type", "pos_embedding", "vocab", "param_dtype")},
          "params": n_params, "init_s": init_s, "f32_layers":
              strict_cfg(cfg).n_layers,
          "encoder": {"launches_per_admission": enc_launches,
                      "host_ms": encode_ms,
                      "cross_kv_bytes_per_slot": cross_bytes // LM_SLOTS},
          "tick_8x1k_host_ms": {
              s: flat["host_ms"][s]["median"] for s in ("captured", "eager")},
          "tick_8x1k_device_busy_ms": prof["device_busy_ms_per_tick"],
          "tick_8x1k_idle_share": prof["device_idle_share"],
          "tick_8x1k_top_device_ms": prof["top_device_ms_per_tick"],
          "tick_bytes_model": {"decoder_weights": dec_weights,
                               "lm_head": head,
                               "lm_head_f32": 8 * sizes["lm_head"],
                               "self_kv": kv_bytes, "cross_kv": cross_bytes,
                               "total": tick_bytes},
          "tick_bytes_bound_ms": tick_bytes / PEAK_BYTES_PER_S * 1e3,
          "tick_bytes_analytic": analytic_tick(cfg, tick_bytes, 1025),
          "oneshot_prefill_ms": chunked["oneshot_prefill_1000_ms"],
          "oneshot_prefill_tokens": chunked["oneshot_prefill_tokens"],
          "cold_fold_ms_per_chunk": chunked["cold_fold_ms_per_chunk"],
          "resume_bitwise": chunked["resume_bitwise"],
          "launches": launches, "kernel_ms": {
              k: v["ms"] for k, v in timing.items()},
          "seconds": seconds,
          "phase_s": time.perf_counter() - t_phase})
    FRAMES.pop(cfg.name)
    del params, enc
    torch.cuda.empty_cache()
    return launches


# -- the vlm family: llama-3.2-vision-90b (phase 15) --------------------------

VLM_ARCH = "llama-3.2-vision-90b"
# 20 of the published 100 layers (16 self and 4 gated cross layers,
# cross_every 5 kept): 39.6 GB of bf16 weights, where the published depth's
# 181 GB fits no one card
VLM_DEPTH = 20
# every cross layer's tanh gate: the reference initializes it to 0, where
# the cross path adds nothing a comparison could see
VLM_GATE = 0.5
# llama-3.2-vision-90b's attention: 64 heads over 8 KV heads of 128
VLM_H, VLM_HKV, VLM_D = 64, 8, 128
# phase 15's captured-against-eager tick timings take this many runs a side
VLM_HOST_RUNS = 3


def vlm_main_path(dev, sleep: int) -> dict:
    """Phase 15: the vlm family at llama-3.2-vision-90b's published width
    and ``VLM_DEPTH`` layers (d_model 8,192, 64 heads over 8 KV heads of
    128, d_ff 28,672, vocabulary 128,256, a gated cross layer every 5th;
    bf16, random weights drawn on the card, every gate at ``VLM_GATE``), a
    seeded (1, 1,024, 8,192) vision embedding as every admission's
    ``extras``, through the paths the reference serves it on: the
    attention kernels at its heads, ``flash_attention`` also non-causal
    over the 1,024 vision keys (:func:`attn_shape_checks`); the vision
    cross K/V; the kernels' ticks refused and the automatic tick
    ``"plain"``; the default ``ServeSpec()`` dense gateway against the
    paged ``"plain"`` and ``"gather"`` gateways (:func:`dense_main_path`);
    load (b) one-shot, its radix hit and copy-on-write, with the prefill's
    attention through the kernel and through its plain version; the
    captured flat tick at 8 lanes of 1,024-token contexts against its
    eager step (:func:`capture_main_path`, ``VLM_HOST_RUNS`` runs a side);
    the one-shot prefill's host ms; then, the bf16 weights freed, float32
    at depth 5 (:func:`strict_cfg`, one whole group): phase 10's strict
    comparisons (:func:`strict_dense_paths`) and load (b) through the
    kernel against the plain prefill.  Returns the kernels' launches over
    the path; raises SystemExit on a failed check."""
    import dataclasses
    from types import SimpleNamespace

    import torch

    from repro_torch import configs
    from repro_torch.kernels import ref
    from repro_torch.models import lm
    from repro_torch.nn import attention
    from repro_torch.serve import engine
    from repro_torch.serve.spec import make_gateway

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(configs.config(VLM_ARCH), n_layers=VLM_DEPTH)
    seconds, launches, failures = {}, {}, []

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    def draw(cfg, seed):
        params = lm.init(cfg, torch.Generator(device=dev).manual_seed(seed))
        params["cross_blocks"]["gate_attn"].fill_(VLM_GATE)
        return params
    params = timed("init", draw, cfg, 0)
    sizes = param_sizes(params)
    vis = torch.randn((1, cfg.n_vision_tokens, cfg.d_model), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(15))
    FRAMES[cfg.name] = lambda: {"vision_embed": vis}
    gen = torch.Generator(device=dev).manual_seed(16)
    T = cfg.n_vision_tokens
    timing = timed("kernel_checks", attn_shape_checks, dev, gen, sleep,
                   cfg.n_layers, tag="vlm", hq=VLM_H, hkv=VLM_HKV,
                   d=VLM_D, n_pos=1024, fold_offset=512, one_len=1000,
                   noncausal=(("cross prompt", 1000, T),
                              ("cross 16 queries", 16, T)))

    # the vision cross K/V, once per admission: plain products, no kernel
    reset_counts()
    xk, xv = engine.vision_cross(cfg, params, vis)
    torch.cuda.synchronize()
    cross_launches = {k: v for k, v in read_counts().items() if v}
    cross_ms = host_ms(lambda: engine.vision_cross(cfg, params, vis),
                       reps=5)
    if cross_launches or tuple(xk.shape) != (
            cfg.n_cross, 1, T, cfg.n_kv_heads, cfg.d_head) or \
            not bool(torch.isfinite(xk).all() and torch.isfinite(xv).all()):
        failures.append(f"vision_cross: launches {cross_launches}, xk "
                        f"{tuple(xk.shape)}")
    del xk, xv

    # the kernels' ticks refused, as the reference refuses them; the
    # automatic choice the plain tick, and admission one-shot
    refused = {}
    for backend in ("cuda", "cascade"):
        try:
            make_gateway(cfg, params, load_spec(backend, False, 8),
                         extras=extras_of(cfg), device=dev)
            refused[backend] = None
        except ValueError as e:
            refused[backend] = str(e)
    gw = make_gateway(cfg, params, load_spec(None, True, 8),
                      extras=extras_of(cfg), device=dev)
    auto = {"backend": gw.batcher.adapter.backend,
            "chunked": gw.batcher.adapter.chunked}
    del gw
    torch.cuda.empty_cache()
    if not all(r and "vlm" in r for r in refused.values()) or \
            auto != {"backend": "plain", "chunked": False}:
        failures.append(f"refusals {refused}, automatic {auto}")

    # phase 10's gateways: dense slots against the paged plain and gather
    # ticks (the float32 comparisons come after the bf16 weights are freed)
    dense, _ = timed("dense_path", dense_main_path, dev, cfg, params,
                     sc=False, runs=VLM_HOST_RUNS, strict=False,
                     eager_profile=False)
    add(dense)

    # load (b) one-shot: r1 a 32-block radix hit, r2 all of r0 (its
    # partial block shared, so r0 and r2 each copy it on their first
    # write); the prefill's attention through the kernel, then through its
    # plain version on the same card and weights
    pb, _ = load_b_prompts(cfg.vocab)

    def plain_flash(q, k, v, **kw):
        return ref.flash_attention_chunked(
            q, k, v, kw["causal"], kw["window"], kw["q_offset"],
            kw["q_chunk"], kw["kv_chunk"])

    def plain_prefill():
        return mock.patch.object(attention, "flash_kernels",
                                 SimpleNamespace(flash_attention=plain_flash))

    def load_b(cfg, params):
        kern = serve_load(dev, cfg, params, pb, backend="plain",
                          chunked=False, new_tokens=32)
        with plain_prefill():
            plain = serve_load(dev, cfg, params, pb, backend="plain",
                               chunked=False, new_tokens=32)
        return kern, plain

    def check_load_b(tag, cfg, kern, plain):
        hits = [kern["prefill"][u]["hits"] for u in range(len(pb))]
        n = kern["launches"]
        others = {k: v for k, v in n.items()
                  if v and k != "flash_attention"}
        out = {"prefix_hit_blocks": hits,
               "cow_copies": kern["pool"]["cow_copies"],
               "r0_equals_r2": kern["tokens"][0] == kern["tokens"][2],
               "ticks": kern["ticks"], "launches": n,
               "plain_prefill_launches": {
                   k: v for k, v in plain["launches"].items() if v},
               "tick_ms_median": statistics.median(kern["tick_ms"])}
        served = all(len(t) == 32 for r in (kern, plain)
                     for t in r["tokens"].values()) and \
            kern["logits_finite"] and plain["logits_finite"]
        if hits != [0, 32, 63, 0] or out["cow_copies"] != 2 or \
                not out["r0_equals_r2"] or others or not served or \
                n["flash_attention"] != flash_launches(cfg, 4, 4) or \
                plain["launches"]["flash_attention"] or \
                kern["captures"] != {"decode": 1}:
            failures.append(f"{tag} load (b): {out}, served {served}, "
                            f"captures {kern['captures']}")
        return out
    b_k, b_p = timed("load_b", load_b, cfg, params)
    add(b_k["launches"])
    load_b_bf16 = check_load_b("bf16", cfg, b_k, b_p)
    # bf16: equal up to each stream's first difference, a near tie
    diffs = first_differences(b_p, b_k)
    if not all(d["near_tie"] for d in diffs):
        failures.append(f"bf16 load (b), kernel vs plain prefill: a "
                        f"difference that is not a near tie: {diffs}")
    agreement = sum(x == y for u, t in b_p["tokens"].items()
                    for x, y in zip(t, b_k["tokens"][u])) / \
        sum(len(t) for t in b_p["tokens"].values())
    del b_k, b_p
    torch.cuda.empty_cache()

    # the captured plain tick at 8 lanes of 1,024-token contexts
    capture = timed("capture", capture_main_path, dev, cfg, params,
                    runs=VLM_HOST_RUNS, eager_profile=False)
    flat = capture["flat_8x1k"]

    # a 1,000-token one-shot prefill: its launches, and its host ms with
    # the attention through the kernel and through its plain version
    tokens = torch.from_numpy(pb[3][None]).to(dev)
    reset_counts()
    engine.prefill(cfg, params, tokens, **prefill_kw(cfg))
    torch.cuda.synchronize()
    per_prompt = {k: v for k, v in read_counts().items() if v}
    if per_prompt != {"flash_attention": cfg.n_layers + cfg.n_cross}:
        failures.append(f"one-shot prefill launches {per_prompt}")
    prefill_ms = {"kernel": host_ms(lambda: engine.prefill(
        cfg, params, tokens, **prefill_kw(cfg)), reps=3)}
    with plain_prefill():
        prefill_ms["plain"] = host_ms(lambda: engine.prefill(
            cfg, params, tokens, **prefill_kw(cfg)), reps=3)

    # a model of the tick's bytes, not a measurement: every layer's bf16
    # weights and lm_head read once (not the embedding's rows), lm_head's
    # float32 copy written and read, every layer's K/V rows of 8 lanes of
    # 1,025 positions and the lanes' vision K/V in every cross layer
    weights = 2 * sum(v for k, v in sizes.items()
                      if k.startswith(("blocks.", "cross_blocks.")))
    head = 2 * sizes["lm_head"]
    row = cfg.n_kv_heads * cfg.d_head * 2
    kv_bytes = 2 * cfg.n_layers * LM_SLOTS * 1025 * row
    cross_bytes = 2 * cfg.n_cross * LM_SLOTS * T * row
    tick_bytes = weights + head + 8 * sizes["lm_head"] + kv_bytes + \
        cross_bytes
    n_params = sum(sizes.values())
    del params
    torch.cuda.empty_cache()

    # float32 at depth 5, one whole group: phase 10's strict comparisons,
    # and load (b) through the kernel against the plain prefill
    cfg5 = strict_cfg(cfg)
    params5 = timed("init_f32", draw, cfg5, 1)
    f32, bad, _ = timed("f32_dense_paths", strict_dense_paths, dev, cfg5,
                        params5, dense_prompts(cfg.vocab))
    failures += bad
    k5, p5 = timed("f32_load_b", load_b, cfg5, params5)
    load_b_f32 = check_load_b("float32", cfg5, k5, p5)
    err = max([float((a - b).abs().max())
               for a, b in zip(k5["logits"], p5["logits"])]
              + [float((k5["prefill"][u]["logits"]
                        - p5["prefill"][u]["logits"]).abs().max())
                 for u in k5["slot"]])
    f32["load_b_kernel_vs_plain_prefill"] = {
        "tokens_equal": k5["tokens"] == p5["tokens"],
        "max_abs_dlogit": err}
    if k5["tokens"] != p5["tokens"] or not err <= 2e-4:
        failures.append(f"float32 depth {cfg5.n_layers} load (b): kernel "
                        f"vs plain prefill "
                        f"{f32['load_b_kernel_vs_plain_prefill']}")
    del params5, k5, p5
    FRAMES.pop(cfg.name)
    del vis
    torch.cuda.empty_cache()

    prof = flat["profile"]["captured"]
    emit({"phase": "vlm_main_path", "model": cfg.name,
          "config": {k: getattr(cfg, k) for k in (
              "n_layers", "cross_every", "n_vision_tokens", "d_model",
              "n_heads", "n_kv_heads", "d_head", "d_ff", "vocab",
              "param_dtype")},
          "published_n_layers": configs.config(VLM_ARCH).n_layers,
          "gate_attn": VLM_GATE, "params": n_params,
          "f32_layers": cfg5.n_layers,
          "vision_cross": {"launches": cross_launches, "host_ms": cross_ms,
                           "bytes_per_slot": cross_bytes // LM_SLOTS},
          "refused": refused, "automatic": auto,
          "load_b_oneshot": load_b_bf16,
          "load_b_f32": load_b_f32,
          "bf16_kernel_vs_plain_prefill": {"first_differences": diffs,
                                           "token_agreement": agreement},
          "f32_depth5": f32,
          "oneshot_prefill_1000_ms": prefill_ms,
          "flash_launches_per_prompt": per_prompt,
          "tick_8x1k_host_ms": {
              s: flat["host_ms"][s]["median"] for s in ("captured", "eager")},
          "tick_8x1k_device_busy_ms": prof["device_busy_ms_per_tick"],
          "tick_8x1k_idle_share": prof["device_idle_share"],
          "tick_8x1k_graph_launches": prof["graph_launches_per_tick"],
          "tick_8x1k_top_device_ms": prof["top_device_ms_per_tick"],
          "tick_bytes_model": {"layer_weights": weights, "lm_head": head,
                               "lm_head_f32": 8 * sizes["lm_head"],
                               "self_kv": kv_bytes,
                               "vision_kv": cross_bytes,
                               "total": tick_bytes},
          "tick_bytes_bound_ms": tick_bytes / PEAK_BYTES_PER_S * 1e3,
          "tick_bytes_analytic": analytic_tick(cfg, tick_bytes, 1025),
          "launches": launches, "kernel_ms": {
              k: v["ms"] for k, v in timing.items()},
          "seconds": seconds, "failures": failures,
          "phase_s": time.perf_counter() - t_phase})
    if failures:
        raise SystemExit(f"vlm path: {failures}")
    return launches


# -- the rwkv family: rwkv6-7b (phase 16) ------------------------------------

RWKV_ARCH = "rwkv6-7b"
RWKV_NEW_TOKENS = 32
# phase 10's prompts that the one-shot prefill admits (at most rwkv_chunk =
# 64 tokens, or a multiple of it: 7, 64, 33 and 1), then four 1,024-token
# prompts; phase 10's 100-token prompt is refused
RWKV_LONG, RWKV_REFUSED = 1024, 100
# the SC frontend's prompts: 64 and 1,024 tokens
RWKV_SC_LENS = (64, 1024)


def rwkv_prompts(vocab: int):
    """Phase 16's load: phase 10's prompts of 7, 64, 33 and 1 tokens, then
    four seeded 1,024-token prompts.  Returns (the load, phase 10's
    100-token prompt)."""
    import numpy as np
    dense = dense_prompts(vocab)
    rng = np.random.default_rng(27)
    load = [p for p in dense if len(p) in (7, 64, 33, 1)] + \
        [rng.integers(0, vocab, RWKV_LONG).astype(np.int32)
         for _ in range(4)]
    refused = next(p for p in dense if len(p) == RWKV_REFUSED)
    return load, refused


def rwkv_serve(batcher, prompts, new_tokens: int) -> dict:
    """``prompts`` through ``batcher`` (state slots, one slot per prompt,
    so the first step admits them all and every request ticks in every
    tick): per request (uid = index) its slot, its tokens and its first
    token's logits (the prefill's), every tick's logits (float32 copies),
    the host ms of each tick and of each admission (ending in a
    synchronize), the kernels' launches from the first step on and the
    captured keys.  The adapter's ``insert`` and ``decode`` are wrapped for
    the run only."""
    import torch

    from repro_torch.serve.gateway.slots import Request
    ad = batcher.adapter
    probe = TickProbe(ad)
    logits, first = [], {}
    inner = probe.inner

    def keep(tokens, active):
        out = inner(tokens, active)
        logits.append(ad.last_logits.clone())
        return out
    probe.inner = keep

    def timed_insert(slot, prompt, max_new=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok = type(ad).insert(ad, slot, prompt, max_new)
        torch.cuda.synchronize()
        first[slot] = {"ms": (time.perf_counter() - t0) * 1e3,
                       "logits": ad.last_prefill_logits[0].clone()}
        return tok
    ad.insert = timed_insert
    for i, p in enumerate(prompts):
        batcher.submit(Request(uid=i, prompt=p, max_new_tokens=new_tokens))
    reset_counts()
    t0 = time.perf_counter()
    try:
        batcher.step()
        slot = {r.uid: s for s, r in enumerate(batcher.active) if r}
        done = batcher.run()
        torch.cuda.synchronize()
    finally:
        del ad.insert, ad.decode
    return {"run_s": time.perf_counter() - t0, "tick_ms": probe.times,
            "logits_finite": probe.finite, "logits": logits, "slot": slot,
            "launches": read_counts(),
            "prefill": {uid: first[s] for uid, s in slot.items()},
            "tokens": {r.uid: list(map(int, r.generated)) for r in done},
            "captures": {name: fn._cache_size()
                         for name, fn in ad.jit_fns().items()}}


def _streams(per: list) -> dict:
    """Per-request (tokens, first-token logits, tick logits) as the record
    of :func:`rwkv_serve` (slot = uid), so :func:`first_differences`
    compares two such records."""
    import torch
    n, ticks = len(per), len(per[0][2])
    return {"tokens": {u: t for u, (t, _, _) in enumerate(per)},
            "prefill": {u: {"logits": f} for u, (_, f, _) in enumerate(per)},
            "logits": [torch.stack([per[u][2][k] for u in range(n)])
                       for k in range(ticks)],
            "slot": {u: u for u in range(n)}}


def dedicated_decode(dev, cfg, params, prompts, new_tokens: int) -> dict:
    """Each prompt decoded alone, the reference tests' oracle: prefill at
    B = 1, then ``new_tokens - 1`` eager B = 1 ticks
    (``engine.decode_step``), greedy (:func:`_streams`)."""
    import torch

    from repro_torch.serve import engine
    per = []
    for p in prompts:
        cache, lg = engine.prefill(cfg, params,
                                   torch.from_numpy(p[None]).to(dev))
        toks, first, ticks = [int(lg[0].argmax())], lg[0].clone(), []
        for _ in range(new_tokens - 1):
            cache, lg = engine.decode_step(
                cfg, params, cache, torch.tensor([[toks[-1]]], device=dev))
            ticks.append(lg[0].clone())
            toks.append(int(lg[0].argmax()))
        per.append((toks, first, ticks))
    return _streams(per)


def alone_decode(ad, prompts, new_tokens: int) -> dict:
    """Each prompt served alone by the state slots ``ad``: prefill at B = 1
    into slot uid, then ``new_tokens - 1`` captured ticks of the adapter's
    width with that lane the only active one, greedy; every slot cleared
    after (:func:`_streams`)."""
    import numpy as np
    per = []
    for uid, p in enumerate(prompts):
        toks = [ad.insert(uid, p)]
        first, ticks = ad.last_prefill_logits[0].clone(), []
        active = np.arange(ad.n_slots) == uid
        for _ in range(new_tokens - 1):
            feed = np.zeros(ad.n_slots, np.int32)
            feed[uid] = toks[-1]
            toks.append(int(ad.decode(feed, active)[uid]))
            ticks.append(ad.last_logits[uid].clone())
        ad.clear(uid)
        per.append((toks, first, ticks))
    return _streams(per)


def served_vs_dedicated(served: dict, alone: dict) -> dict:
    """Tokens equal per request, and the max |logit difference| over every
    request's prefill and ticks (the served lane's row against the
    dedicated run's, up to each stream's first difference)."""
    err = 0.0
    for uid, s in served["slot"].items():
        ta, tb = served["tokens"][uid], alone["tokens"][uid]
        k = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y),
                 len(ta))
        pairs = [(served["prefill"][uid]["logits"],
                  alone["prefill"][uid]["logits"])]
        pairs += [(served["logits"][i][s], alone["logits"][i][uid])
                  for i in range(min(k, len(alone["logits"])))]
        err = max([err] + [float((a - b).abs().max()) for a, b in pairs])
    return {"tokens_equal": served["tokens"] == alone["tokens"],
            "max_abs_dlogit": err}


# the rwkv block's matrix products, in the order it makes them
RWKV_PROJS = ("wr", "wk", "wv", "wg", "w_lora_a", "wo", "cm_k", "cm_r",
              "cm_v")


def rwkv_first_parting(cfg, params, state: dict, feed) -> list:
    """One eager tick from ``state`` (the slots' ``len`` and states), the
    lanes together against each lane alone at B = 1: every norm, matrix
    product (``RWKV_PROJS``), ``wkv6_step`` (its decay input and its
    output) and the logits recorded in order on both sides.  Per lane the
    first recorded step whose output differs, where every input still
    agrees: its layer, its name and its max |difference| (None where the
    lane's tick is bit for bit the batch's)."""
    import torch

    from repro_torch.models import lm
    from repro_torch.nn import norms, ssm
    from repro_torch.serve import engine

    def record(feed_, state_):
        rec, n_proj = [], [0]

        def wrap(mod, name):
            fn = getattr(mod, name)

            def inner(*a, **kw):
                layer = n_proj[0] // len(RWKV_PROJS)
                if name == "wkv6_step":
                    rec.append((layer, "wkv6_step decay", a[3].clone()))
                out = fn(*a, **kw)
                tag = name
                if name == "_proj":
                    tag = RWKV_PROJS[n_proj[0] % len(RWKV_PROJS)]
                    n_proj[0] += 1
                rec.append((layer, tag, (out[0] if isinstance(out, tuple)
                                         else out).clone()))
                return out
            return mock.patch.object(mod, name, inner)
        with wrap(lm, "_proj"), wrap(lm, "_norm_apply"), \
                wrap(norms, "rmsnorm"), wrap(ssm, "wkv6_step"), \
                wrap(lm, "logits"):
            engine.decode_step(cfg, params, {k: a.clone() for k, a in
                                             state_.items()}, feed_)
        return rec
    batch = record(feed, state)
    out = []
    for s in range(feed.shape[0]):
        alone = record(feed[s:s + 1], {
            k: a[s:s + 1] if a.dim() == 1 else a[:, s:s + 1]
            for k, a in state.items()})
        first = next(({"layer": layer, "step": tag, "max_abs_diff": float(
            (one[0].float() - many[s].float()).abs().max())}
            for (layer, tag, one), (_, _, many) in zip(alone, batch)
            if not torch.equal(one[0], many[s])), None)
        out.append(first)
        del alone
    del batch
    return out


def rwkv_main_path(dev, sleep: int) -> dict:
    """Phase 16: the rwkv family at rwkv6-7b's published width and depth
    (32 layers, d_model 4,096, 64 wkv heads of 64, d_ff 14,336,
    vocabulary 65,536, ``rwkv_chunk`` 64; bf16, random weights drawn on
    the card) through its state-slot serving path:
    ``make_gateway(..., ServeSpec(n_slots=8, paged=True))`` builds a
    ``StateSlotAdapter`` and serves :func:`rwkv_prompts`, 32 new tokens
    each, against each request served alone by the same slots (bf16: up
    to each stream's first difference, a near tie) and against eager B = 1
    decoding (the same rule; reported beside it, one tick's B = 1 against
    8-lane logits and :func:`rwkv_first_parting`); a 100-token prompt
    refused with the state untouched; the captured tick at 8 active lanes bit for bit its eager
    step (logits and the three states), one graph launch per tick, timed
    captured against eager in turns beside its byte model; a 1,024-token
    one-shot prefill's host ms; the SC frontend at bits 4 on the 64- and
    1,024-token prompts (its output bit for bit the plain versions',
    ``sng_pack`` twice and ``sc_dot`` once per prompt and never on a tick,
    the kernels timed at the 1,024-token shape beside their bounds); then,
    the bf16 weights freed, float32 at depth 4 (:func:`strict_cfg`): the
    8-slot batcher's tokens equal to dedicated decoding with logits within
    2e-4, and ``wkv6_chunked`` over layer 0's 128-step r, k, v and w
    within 2e-4 of 128 ``wkv6_step``s.  No attention kernel runs.
    Returns the kernels' launches over the served runs; raises SystemExit
    on a failed check."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.core import sng
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sc_dot as sc_dot_k
    from repro_torch.kernels import sng_pack as sng_pack_k
    from repro_torch.models import lm
    from repro_torch.nn import ssm
    from repro_torch.serve import engine
    from repro_torch.serve.gateway.slots import StateSlotAdapter
    from repro_torch.serve.scheduler import RwkvContinuousBatcher
    from repro_torch.serve.spec import ServeSpec, make_gateway

    t_phase = time.perf_counter()
    cfg = configs.config(RWKV_ARCH)
    seconds, launches, failures = {}, {}, []

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    def draw(cfg, seed):
        return lm.init(cfg, torch.Generator(device=dev).manual_seed(seed))
    params = timed("init", draw, cfg, 0)
    sizes = param_sizes(params)
    prompts, p100 = rwkv_prompts(cfg.vocab)

    # the bf16 gateway: state slots whatever paged says
    spec = ServeSpec(n_slots=LM_SLOTS, paged=True,
                     max_new_tokens=RWKV_NEW_TOKENS)
    gw = make_gateway(cfg, params, spec, device=dev)
    ad = gw.batcher.adapter
    served = timed("serve_bf16", rwkv_serve, gw.batcher, prompts,
                   RWKV_NEW_TOKENS)
    add(served["launches"])
    ran = {k: v for k, v in served["launches"].items() if v}
    if type(ad) is not StateSlotAdapter or ad.max_len is not None or ran \
            or not served["logits_finite"] or \
            served["captures"] != {"decode": 1} or \
            sorted(map(len, served["tokens"].values())) != \
            [RWKV_NEW_TOKENS] * len(prompts):
        failures.append(f"bf16 gateway: adapter {type(ad).__name__}, "
                        f"launches {ran}, finite "
                        f"{served['logits_finite']}, captures "
                        f"{served['captures']}")

    # a prompt the one-shot chunks do not divide: refused, state untouched
    before = {k: a.clone() for k, a in ad.state.items()}
    try:
        ad.insert(0, p100)
        refused = None
    except ValueError as e:
        refused = str(e)
    untouched = all(torch.equal(ad.state[k], before[k]) for k in before)
    del before
    if not refused or not untouched:
        failures.append(f"100-token prompt: refused {refused}, state "
                        f"untouched {untouched}")

    # the captured tick at 8 active lanes: every prompt admitted again
    for s, p in enumerate(prompts):
        ad.insert(s, p)
    tokens = torch.stack([served["logits"][0][s].argmax()
                          for s in range(LM_SLOTS)]).cpu().numpy()
    active = torch.ones(LM_SLOTS, dtype=torch.bool).numpy()
    # one eager tick from these states, the 8 lanes together against each
    # lane alone at B = 1: how far the logits part, and the first step
    # where they do
    feed = torch.from_numpy(tokens[:, None]).to(dev)
    _, lg8 = engine.decode_step(cfg, params, {k: a.clone() for k, a in
                                              ad.state.items()}, feed)

    def lane(s):
        return {k: (a[s:s + 1] if a.dim() == 1 else a[:, s:s + 1]).clone()
                for k, a in ad.state.items()}
    one_tick = [float((engine.decode_step(cfg, params, lane(s),
                                          feed[s:s + 1])[1][0] - lg8[s]
                       ).abs().max()) for s in range(LM_SLOTS)]
    del lg8
    first_parting = rwkv_first_parting(cfg, params, ad.state, feed)
    replay = timed("tick_replay", tick_replay_check, ad, tokens, active,
                   state=ad.state)
    tick = timed("tick_timing", tick_timing, ad, tokens, active)
    prof = tick["profile"]["captured"]
    if not (replay["logits_bitwise"] and replay["arena_bitwise"] and
            replay["logits_finite"] and replay["launches_equal"]) or \
            replay["launches"] or prof["graph_launches_per_tick"] != 1:
        failures.append(f"captured tick: {replay}, graph launches "
                        f"{prof['graph_launches_per_tick']}")

    # a 1,024-token one-shot prefill on the host clock
    long = torch.from_numpy(prompts[-1][None]).to(dev)
    reset_counts()
    engine.prefill(cfg, params, long)
    torch.cuda.synchronize()
    prefill_launches = {k: v for k, v in read_counts().items() if v}
    prefill_ms = host_ms(lambda: engine.prefill(cfg, params, long), reps=3)
    if prefill_launches:
        failures.append(f"one-shot prefill launches {prefill_launches}")

    # bf16 at full depth: the gateway's streams against each request
    # served alone by the same 8-lane state slots and against eager B = 1
    # decoding, each equal up to each stream's first difference, a near
    # tie
    def compare(alone):
        diffs = first_differences(alone, served)
        agree = sum(x == y for u, t in alone["tokens"].items()
                    for x, y in zip(t, served["tokens"][u])) / \
            sum(len(t) for t in alone["tokens"].values())
        return {"first_differences": diffs, "token_agreement": agree,
                "streams_equal_whole": sum(alone["tokens"][u] ==
                                           served["tokens"][u]
                                           for u in alone["tokens"])}
    alone = timed("alone_bf16", alone_decode, ad, prompts, RWKV_NEW_TOKENS)
    bf16 = {"alone": compare(alone), "b1_eager": compare(timed(
        "dedicated_bf16", dedicated_decode, dev, cfg, params, prompts,
        RWKV_NEW_TOKENS))}
    bf16["alone"]["logits_bitwise"] = all(
        torch.equal(a, served["logits"][k][served["slot"][u]])
        for k, row in enumerate(alone["logits"])
        for u, a in enumerate(row)) and all(
        torch.equal(alone["prefill"][u]["logits"],
                    served["prefill"][u]["logits"]) for u in alone["slot"])
    for name, got in bf16.items():
        if not all(d["near_tie"] for d in got["first_differences"]):
            failures.append(f"bf16 gateway vs {name}: a difference that "
                            f"is not a near tie: {got}")
    del alone
    tick_ms = statistics.median(served["tick_ms"][1:])
    admission_ms = [served["prefill"][u]["ms"] for u in range(len(prompts))]
    del served, gw, ad
    torch.cuda.empty_cache()

    # the SC frontend at bits 4: bit for bit its plain versions on the
    # 64- and 1,024-token prompts, then both served through a gateway
    cfg_sc = dataclasses.replace(cfg, first_layer_mode="sc", sc_bits=4)
    gen = torch.Generator(device=dev).manual_seed(2)
    params_sc = dict(params, sc_frontend=lm.init(
        dataclasses.replace(cfg_sc, n_layers=1), gen)["sc_frontend"])
    sc_prompts = [next(p for p in prompts if len(p) == n)
                  for n in RWKV_SC_LENS]

    def plain_sc_dot(x, w, s0_mode="alt", adder="tff", *, length=None):
        return ref.sc_dot(x, w, s0_mode, adder)
    frontend = {}
    for p in sc_prompts:
        x = lm.token_rows(params, torch.from_numpy(p[None]).to(dev))
        reset_counts()
        got = lm.sc_frontend(cfg_sc, params_sc["sc_frontend"], x)
        torch.cuda.synchronize()
        calls = {n: read_counts()[n] for n in ("sng_pack", "sc_dot")}
        t0 = time.perf_counter()
        with mock.patch.object(sng_pack_k, "sng_pack", ref.sng_pack), \
                mock.patch.object(sc_dot_k, "sc_dot", plain_sc_dot):
            plain = lm.sc_frontend(cfg_sc, params_sc["sc_frontend"], x)
        torch.cuda.synchronize()
        frontend[len(p)] = {
            "bitwise_vs_plain": bool(torch.equal(got, plain)),
            "launches_per_call": calls,
            "plain_frontend_ms": (time.perf_counter() - t0) * 1e3}
        del got, plain
    if not all(f["bitwise_vs_plain"] and f["launches_per_call"] ==
               {"sng_pack": 2, "sc_dot": 1} for f in frontend.values()):
        failures.append(f"SC frontend: {frontend}")
    sc_new = 8
    gw_sc = make_gateway(cfg_sc, params_sc, spec.replace(
        max_new_tokens=sc_new), device=dev)
    sc_run = timed("serve_sc", rwkv_serve, gw_sc.batcher, sc_prompts, sc_new)
    del gw_sc
    add(sc_run["launches"])
    sc_launches = {k: v for k, v in sc_run["launches"].items() if v}
    n_sc = len(sc_prompts)
    if sc_launches != {"sng_pack": 2 * n_sc, "sc_dot": n_sc} or \
            len(sc_run["tick_ms"]) != sc_new - 1 or \
            not sc_run["logits_finite"]:
        failures.append(f"SC gateway: launches {sc_launches} over "
                        f"{len(sc_run['tick_ms'])} ticks, expected "
                        f"{2 * n_sc} sng_pack and {n_sc} sc_dot")
    # the SC kernels at the 1,024-token prompt's shapes
    props = torch.cuda.get_device_properties(dev)
    clk_sm = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6 * \
        props.multi_processor_count
    peak = b1_mma_peak(dev, sleep)
    N, d, M = 16, cfg.d_model, RWKV_LONG
    codes_a, codes_b = sng.codes_tensors("ramp_lowdisc", 4, dev)
    sc_timing_rows = []
    for name, shape, codes in (("levels", (M, d), codes_a),
                               ("banks", (d, 2 * d), codes_b)):
        lv = torch.randint(0, N + 1, shape, generator=gen, dtype=torch.int32,
                           device=dev)
        ms, _ = time_ms(functools.partial(sng_pack_k.sng_pack, lv, codes, N),
                        3, 5, sleep, b2b=False)
        sc_timing_rows.append({"kernel": "sng_pack", "operand": name,
                               "shape": list(shape), "ms": ms,
                               **sc_bounds("sng_pack", shape[0], shape[1], 0,
                                           N, clk_sm, None)})
    xs = stream_words(gen, (M, d, 1), N)
    ws = stream_words(gen, (d, 2 * d, 1), N)
    ms, _ = time_ms(functools.partial(ops.sc_dot_posneg, xs, ws, length=N),
                    3, 2, sleep, b2b=False)
    sc_timing_rows.append({"kernel": "sc_dot", "route": "posneg",
                           "shape": f"x ({M}, {d}, 1), w ({d}, {2 * d}, 1)",
                           "ms": ms, **sc_bounds("sc_dot", M, d, 2 * d, N,
                                                 clk_sm, peak["mma_per_s"])})
    del xs, ws, lv, params_sc

    # a model of the tick's bytes, not a measurement: the blocks' bf16
    # weights and lm_head read once (not the embedding's rows), the lanes'
    # float32 wkv state read and written; beside it lm_head's float32 copy,
    # written and read each tick by the logits' widening
    weights = 2 * sum(v for k, v in sizes.items() if k.startswith("blocks."))
    head = 2 * sizes["lm_head"]
    wkv = 2 * 4 * cfg.n_layers * LM_SLOTS * cfg.n_heads * cfg.d_head ** 2
    shifts = 2 * 2 * 2 * cfg.n_layers * LM_SLOTS * cfg.d_model
    tick_bytes = weights + head + wkv
    n_params = sum(sizes.values())
    del params
    torch.cuda.empty_cache()

    # float32 at depth 4: the 8-slot batcher against dedicated decoding,
    # and the chunked wkv against its recurrent steps on layer 0's inputs
    cfg4 = strict_cfg(cfg)
    params4 = timed("init_f32", draw, cfg4, 1)
    b4 = RwkvContinuousBatcher(cfg4, params4, n_slots=LM_SLOTS)
    run4 = timed("serve_f32", rwkv_serve, b4, prompts, RWKV_NEW_TOKENS)
    add(run4["launches"])
    alone4 = timed("dedicated_f32", dedicated_decode, dev, cfg4, params4,
                   prompts, RWKV_NEW_TOKENS)
    f32 = served_vs_dedicated(run4, alone4)
    if not f32["tokens_equal"] or not f32["max_abs_dlogit"] <= 2e-4:
        failures.append(f"float32 depth 4 batcher vs dedicated: {f32}")
    del b4, run4, alone4
    seen = []
    wkv6 = ssm.wkv6_chunked

    def keep_first(*args, **kw):
        if not seen:
            seen.append((args, kw))
        return wkv6(*args, **kw)
    steps = 128
    with mock.patch.object(ssm, "wkv6_chunked", keep_first):
        engine.prefill(cfg4, params4, torch.from_numpy(
            prompts[-1][None, :steps]).to(dev))
    (r, k, v, w, u), _ = seen[0]
    out_c, st_c = wkv6(r, k, v, w, u, chunk=cfg4.rwkv_chunk)
    st = torch.zeros_like(st_c)
    outs = []
    for i in range(steps):
        o, st = ssm.wkv6_step(r[:, i], k[:, i], v[:, i], w[:, i], u, st)
        outs.append(o)
    out_s = torch.stack(outs, 1)
    wkv_check = {"steps": steps, "chunk": cfg4.rwkv_chunk,
                 "shape": list(r.shape),
                 "out_max_abs_err": float((out_c - out_s).abs().max()),
                 "state_max_abs_err": float((st_c - st).abs().max()),
                 "out_close_2e-4": bool(torch.allclose(out_c, out_s,
                                                       rtol=2e-4, atol=2e-4)),
                 "state_close_2e-4": bool(torch.allclose(st_c, st, rtol=2e-4,
                                                         atol=2e-4))}
    if not (wkv_check["out_close_2e-4"] and wkv_check["state_close_2e-4"]):
        failures.append(f"wkv6_chunked vs steps: {wkv_check}")
    del params4, seen, r, k, v, w, u, out_c, st_c, st, outs, out_s
    torch.cuda.empty_cache()

    attention = [k for k in KERNELS if k not in ("sng_pack", "sc_dot")]
    if any(launches.get(k, 0) for k in attention + [FUSED_MERGE]):
        failures.append(f"an attention kernel launched: {launches}")
    emit({"phase": "rwkv_main_path", "model": cfg.name,
          "config": {k: getattr(cfg, k) for k in (
              "n_layers", "d_model", "n_heads", "d_head", "d_ff", "vocab",
              "rwkv_chunk", "param_dtype")},
          "params": n_params, "f32_layers": cfg4.n_layers,
          "adapter": "StateSlotAdapter", "prompt_lens": list(map(
              len, prompts)), "new_tokens": RWKV_NEW_TOKENS,
          "refused_100": refused, "state_untouched": untouched,
          "admission_ms": admission_ms, "gateway_tick_ms_median": tick_ms,
          "tick_replay": replay,
          "tick_8_host_ms": {s: tick["host_ms"][s]["median"]
                             for s in ("captured", "eager")},
          "tick_8_host_ms_runs": {s: tick["host_ms"][s]["runs"]
                                  for s in ("captured", "eager")},
          "tick_8_device_busy_ms": prof["device_busy_ms_per_tick"],
          "tick_8_idle_share": prof["device_idle_share"],
          "tick_8_graph_launches": prof["graph_launches_per_tick"],
          "tick_8_eager_host_launches":
              tick["profile"]["eager"]["host_launches_per_tick"],
          "tick_8_top_device_ms": prof["top_device_ms_per_tick"],
          "tick_bytes_model": {"layer_weights": weights, "lm_head": head,
                               "wkv_state_rw": wkv, "total": tick_bytes,
                               "shift_rows_rw": shifts,
                               "lm_head_f32_widening": 8 * sizes["lm_head"]},
          "tick_bytes_bound_ms": tick_bytes / PEAK_BYTES_PER_S * 1e3,
          "tick_bytes_analytic": analytic_tick(cfg, tick_bytes, None),
          "tick_bytes_with_widening_bound_ms":
              (tick_bytes + 8 * sizes["lm_head"]) / PEAK_BYTES_PER_S * 1e3,
          "oneshot_prefill_1024_ms": prefill_ms,
          "bf16_vs_dedicated": bf16,
          "one_tick_b1_vs_8_lanes_max_abs_dlogit": one_tick,
          "b1_vs_8_lanes_first_parting": first_parting,
          "f32_depth4_vs_dedicated": f32,
          "wkv6_chunked_vs_steps": wkv_check,
          "sc": {"bits": 4, "frontend": frontend,
                 "served_launches": sc_launches,
                 "ticks": len(sc_run["tick_ms"]),
                 "b1_mma_per_s": peak["mma_per_s"],
                 "timing_1024": sc_timing_rows},
          "launches": launches, "seconds": seconds, "failures": failures,
          "phase_s": time.perf_counter() - t_phase})
    if failures:
        raise SystemExit(f"rwkv path: {failures}")
    return launches


# -- the last decoder configs and the int8 KV layout (phase 17) -------------

SC2_ARCH = "starcoder2-15b"
# starcoder2-15b's attention: 48 query heads over 4 KV heads of 128 (GQA
# 12:1), 40 layers
SC2_HQ, SC2_HKV, SC2_D = 48, 4, 128
# deepseek-67b and llama3-405b at full width, cut in depth to fit the card
# with room for their paths: 24 of 95 layers (~36.6 GB in bf16) and 5 of
# 126 (~40.3 GB, and 8.4 GB more while ``lm.logits`` widens lm_head)
DS67_ARCH, DS67_DEPTH = "deepseek-67b", 24
L405_ARCH, L405_DEPTH = "llama3-405b", 5
# llama3-405b's attention: 128 query heads over 8 KV heads of 128 (16:1)
L405_HQ, L405_HKV, L405_D = 128, 8, 128
# the float32 depth of the cut models' strict comparisons
CUT_F32_DEPTH = 2
# phase 17's captured-against-eager tick timings take this many runs a side
DECODER_HOST_RUNS = 2
# starcoder2-15b's cascade path (load (c), cascade against flat) at this
# depth of its 40 layers (cut to give the script's time to phase 20)
SC2_CASCADE_DEPTH = 10
# the reference's own bound for the int8 cache (tests/test_kvquant.py):
# the first tick's max |dlogit| against the bf16 cache's, over its max
# |logit|, and the same argmax
INT8_LOGIT_SHARE = 0.05


def free_card() -> None:
    """Give the card back what a freed model held: the gateways' captured
    steps close over the weights, and the adapters they hang on sit in
    reference cycles (their wrapped ``insert`` / ``decode``), which only a
    collection breaks; then the allocator's cache."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def param_sizes(params) -> dict:
    """Elements of every leaf of a parameter tree, by dotted path."""
    sizes, stack = {}, [("", params)]
    while stack:
        path, p = stack.pop()
        for k, v in p.items():
            if isinstance(v, dict):
                stack.append((f"{path}{k}.", v))
            else:
                sizes[path + k] = v.numel()
    return sizes


def int8_main_path(dev, cfg, params, bf16_dense: dict) -> dict:
    """Phase 17's int8 KV layout on ``cfg``'s bf16 weights (``kv_quant``):
    the explicit kernel and cascade ticks refused and the automatic tick
    ``"plain"`` with one-shot admission; phase 10's six prompts through the
    default ``ServeSpec()`` gateway (dense int8 slots), the paged
    ``"plain"`` gateway and the gather oracle (tokens and logits bit for
    bit the plain gateway's; the dense gateway's first differences near
    ties), each request's first tick within ``INT8_LOGIT_SHARE`` of the
    bf16 default gateway's (``bf16_dense``) with the same argmax; then 8
    lanes of 1,024-token prompts through the in-place plain adapter and
    the gather adapter, 8 forced ticks, logits and every chain block of
    k, v, k_scale and v_scale bit for bit; the captured int8 tick (paged
    and dense) bit for bit its eager step; the arena's bytes per position
    against the bf16 layout's.  Returns the line's fields (launches under
    "launches"); raises SystemExit on a failed check."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.serve.gateway.slots import Request, make_adapter
    from repro_torch.serve.spec import ServeSpec, make_gateway

    sw = Stopwatch()
    failures = []
    qcfg = dataclasses.replace(cfg, kv_quant=True)
    prompts = dense_prompts(cfg.vocab)
    n_req = len(prompts)

    refused = {}
    for backend in ("cuda", "cascade"):
        try:
            make_gateway(qcfg, params, load_spec(backend, False, 8),
                         device=dev)
            refused[backend] = None
        except ValueError as e:
            refused[backend] = str(e)
    gw = make_gateway(qcfg, params, load_spec(None, True, 8), device=dev)
    auto = {"backend": gw.batcher.adapter.backend,
            "chunked": gw.batcher.adapter.chunked}
    del gw
    torch.cuda.empty_cache()
    if not all(r and "kv_quant" in r for r in refused.values()) or \
            auto != {"backend": "plain", "chunked": False}:
        failures.append(f"refusals {refused}, automatic {auto}")
    sw.lap("refusals")

    runs = {"dense": serve_spec_load(dev, qcfg, params, prompts,
                                     ServeSpec()),
            "plain": serve_spec_load(dev, qcfg, params, prompts,
                                     paged_spec("plain")),
            "gather": serve_spec_load(dev, qcfg, params, prompts,
                                      paged_spec("gather"))}
    want = {name: 0 for name in runs["dense"]["launches"]}
    want["flash_attention"] = flash_launches(qcfg, n_req, n_req)
    for name, r in runs.items():
        if r["served"] != n_req or not r["finite"] or \
                r["launches"] != want or r["captures"] != {"decode": 1}:
            failures.append(f"int8 {name}: served {r['served']}, finite "
                            f"{r['finite']}, launches {r['launches']}, "
                            f"captures {r['captures']}")
    gather = stream_differences(runs["plain"], runs["gather"])
    dense = stream_differences(runs["plain"], runs["dense"])
    if not gather["tokens_equal"] or gather["max_abs_dlogit"] != 0:
        failures.append(f"int8 gather vs plain: {gather}")
    if not all(d["near_tie"] for d in dense["first_differences"]):
        failures.append(f"int8 dense vs plain: a difference that is not a "
                        f"near tie: {dense['first_differences']}")
    # the first tick reads the prompt's K/V through the int8 cache, after a
    # prefill computed in bf16 either way (the same first token)
    share, argmax = [], []
    for uid in range(n_req):
        a, b = runs["dense"]["rows"][uid][0], bf16_dense["rows"][uid][0]
        share.append(float((a - b).abs().max() / b.abs().max()))
        argmax.append(int(a.argmax()) == int(b.argmax()))
    if not max(share) <= INT8_LOGIT_SHARE or not all(argmax):
        failures.append(f"int8 vs bf16 first tick: |dlogit| / max|logit| "
                        f"{share}, argmax equal {argmax}")
    int8_launches = {k: sum(r["launches"][k] for r in runs.values())
                     for k in want}
    sw.lap("gateways")

    # 8 lanes of 1,024 tokens, the in-place plain tick against the gather
    # oracle on the same forced tokens; then the captured tick replayed
    rng = np.random.default_rng(23)
    lanes = [rng.integers(0, cfg.vocab, 1024).astype(np.int32)
             for _ in range(LM_SLOTS)]
    forced = rng.integers(0, cfg.vocab, (8, LM_SLOTS)).astype(np.int32)
    ads = {b: make_adapter(qcfg, params, n_slots=LM_SLOTS,
                           max_len=LM_MAX_LEN, paged=True,
                           block_size=LM_BLOCK, backend=b)
           for b in ("plain", "gather")}
    first = {b: [ad.insert(s, p, 9) for s, p in enumerate(lanes)]
             for b, ad in ads.items()}
    active = np.ones(LM_SLOTS, bool)
    logits_equal, tokens_equal = True, first["plain"] == first["gather"]
    for row in forced:
        out = {b: ad.decode(row, active) for b, ad in ads.items()}
        tokens_equal &= bool(np.array_equal(out["plain"], out["gather"]))
        logits_equal &= bool(torch.equal(ads["plain"].last_logits,
                                         ads["gather"].last_logits))
    inp, gat = ads["plain"], ads["gather"]
    blocks = inp.slot_bids == gat.slot_bids and all(
        torch.equal(inp.arena_block(key, b), gat.arena_block(key, b))
        for s in range(LM_SLOTS) for b in inp.slot_bids[s]
        for key in inp.seq_keys)
    keys = sorted(inp.seq_keys)
    bf16_ad = make_adapter(cfg, params, n_slots=1, max_len=LM_BLOCK,
                           paged=True, block_size=LM_BLOCK, backend="plain")
    token_bytes = {"bf16": bf16_ad._token_bytes, "int8": inp._token_bytes}
    del bf16_ad
    if not (tokens_equal and logits_equal and blocks) or \
            keys != ["k", "k_scale", "v", "v_scale"] or \
            inp.arena["k"].dtype != torch.int8:
        failures.append(f"int8 in-place vs gather: tokens {tokens_equal}, "
                        f"logits {logits_equal}, blocks {blocks}, keys "
                        f"{keys}")
    tokens = np.asarray(out["plain"], np.int32)
    replay = tick_replay_check(inp, tokens, active)
    tick = tick_timing(inp, tokens, active, runs=DECODER_HOST_RUNS,
                       eager_profile=False)
    del ads, inp, gat
    torch.cuda.empty_cache()
    sw.lap("inplace_vs_gather")

    # the dense int8 tick, four lanes mid stream
    gw = make_gateway(qcfg, params, ServeSpec(), device=dev)
    ad, batcher = gw.batcher.adapter, gw.batcher
    for i, p in enumerate(prompts[:ad.n_slots]):
        batcher.submit(Request(uid=i, prompt=p, max_new_tokens=16))
    batcher.step()
    dense_replay = tick_replay_check(
        ad, batcher.last_token.copy(),
        np.asarray([r is not None for r in batcher.active]), state=ad.cache)
    del gw, ad, batcher
    torch.cuda.empty_cache()
    for name, r in (("paged", replay), ("dense", dense_replay)):
        if not (r["logits_bitwise"] and r["arena_bitwise"]
                and r["launches_equal"] and r["logits_finite"]):
            failures.append(f"int8 {name} tick: the replay differs from the "
                            f"eager step: {r}")
    sw.lap("dense_replay")
    out = {"refused": refused, "automatic": auto,
           "gateways": {n: {"served": r["served"], "run_s": r["run_s"],
                            "tick_ms_median": statistics.median(r["tick_ms"]),
                            "launches": {k: v for k, v in
                                         r["launches"].items() if v}}
                        for n, r in runs.items()},
           "gather_vs_plain": {k: gather[k] for k in ("tokens_equal",
                                                      "max_abs_dlogit")},
           "dense_vs_plain": dense,
           "first_tick_vs_bf16": {"max_abs_dlogit_share": share,
                                  "bound": INT8_LOGIT_SHARE,
                                  "argmax_equal": argmax},
           "inplace_vs_gather_8x1k": {"tokens_equal": tokens_equal,
                                      "logits_bitwise": logits_equal,
                                      "blocks_bitwise": blocks,
                                      "arena_keys": keys},
           "arena_bytes_per_position": {
               **token_bytes, "ratio": token_bytes["int8"]
               / token_bytes["bf16"], "predicted_ratio": 0.52},
           "replay_paged": replay, "replay_dense": dense_replay,
           "tick_8x1k_plain_host_ms": {
               s: tick["host_ms"][s]["median"] for s in ("captured",
                                                         "eager")},
           "tick_8x1k_plain_device_busy_ms":
               tick["profile"]["captured"]["device_busy_ms_per_tick"],
           "launches": int8_launches, "failures": failures, **sw.fields()}
    emit({"phase": "int8_main_path", "model": qcfg.name, **out})
    if failures:
        raise SystemExit(f"int8 path: {failures}")
    return out


def cut_decoder_path(dev, arch: str, depth: int, sleep: int,
                     heads: tuple | None = None) -> dict:
    """One decoder config of phase 17 at its published width, cut to
    ``depth`` layers (bf16, random weights drawn on the card): with
    ``heads`` (query heads, KV heads, head width) the attention kernels at
    that geometry (:func:`attn_shape_checks`); phase 10's six prompts
    through the default ``ServeSpec()`` gateway and the paged ``"cuda"``
    tick against the paged ``"plain"`` tick (first differences near
    ties); then, the bf16 weights freed, the same three gateways in
    float32 at ``CUT_F32_DEPTH`` layers: tokens equal, logits within 2e-4.
    Returns the line's fields; raises SystemExit on a failed check."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve.spec import ServeSpec

    sw = Stopwatch()
    failures = []
    full = configs.config(arch)
    cfg = dataclasses.replace(full, n_layers=depth)
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    sizes = param_sizes(params)
    sw.lap("init")
    timing = {}
    if heads:
        hq, hkv, d = heads
        timing = attn_shape_checks(
            dev, torch.Generator(device=dev).manual_seed(27), sleep,
            cfg.n_layers, tag=arch.split("-")[0], hq=hq, hkv=hkv, d=d)
        sw.lap("kernel_checks")
    prompts = dense_prompts(cfg.vocab)
    n_req = len(prompts)

    def three(cfg, params):
        return {"dense": serve_spec_load(dev, cfg, params, prompts,
                                         ServeSpec()),
                **{b: serve_spec_load(dev, cfg, params, prompts,
                                      paged_spec(b))
                   for b in ("cuda", "plain")}}
    runs = three(cfg, params)
    bf16 = {"cuda_vs_plain": stream_differences(runs["cuda"], runs["plain"]),
            "dense_vs_plain": stream_differences(runs["dense"],
                                                 runs["plain"])}
    for name, r in runs.items():
        if r["served"] != n_req or not r["finite"] or \
                r["captures"] != {"decode": 1}:
            failures.append(f"bf16 {name}: served {r['served']}, finite "
                            f"{r['finite']}, captures {r['captures']}")
    ticks = len(runs["cuda"]["tick_ms"])
    n = runs["cuda"]["launches"]
    if n["flash_attention"] != flash_launches(cfg, n_req, n_req) or \
            n["paged_decode_attention"] != cfg.n_layers * ticks or \
            n["scatter_kv_rows"] != ticks or \
            runs["plain"]["launches"]["paged_decode_attention"]:
        failures.append(f"bf16 launches: cuda {n}, plain "
                        f"{runs['plain']['launches']}")
    for name, dd in bf16.items():
        if not all(x["near_tie"] for x in dd["first_differences"]):
            failures.append(f"bf16 {name}: a difference that is not a near "
                            f"tie: {dd['first_differences']}")
    launches = {k: v for k, v in n.items() if v}
    del params
    for r in runs.values():
        r.pop("rows")
    free_card()
    sw.lap("bf16")
    cfg2 = dataclasses.replace(full, n_layers=CUT_F32_DEPTH,
                               param_dtype="float32")
    params2 = lm.init(cfg2, torch.Generator(device=dev).manual_seed(1))
    runs2 = three(cfg2, params2)
    f32 = {"cuda_vs_plain": stream_differences(runs2["cuda"],
                                               runs2["plain"]),
           "dense_vs_plain": stream_differences(runs2["dense"],
                                                runs2["plain"])}
    for name, dd in f32.items():
        if not (dd["tokens_equal"] and dd["max_abs_dlogit"] <= 2e-4):
            failures.append(f"float32 depth {CUT_F32_DEPTH} {name}: tokens "
                            f"equal {dd['tokens_equal']}, max |dlogit| "
                            f"{dd['max_abs_dlogit']}")
    del params2, runs2
    free_card()
    sw.lap("f32")
    out = {"model": full.name, "n_layers": depth,
           "published_n_layers": full.n_layers, "f32_layers": CUT_F32_DEPTH,
           "params": sum(sizes.values()),
           "bytes_bf16": 2 * sum(sizes.values()),
           "heads": f"{full.n_heads} over {full.n_kv_heads} of "
                    f"{full.d_head}",
           "tick_ms_median": {n: statistics.median(r["tick_ms"])
                              for n, r in runs.items()},
           "bf16": bf16, "f32": f32, "launches": launches,
           "kernel_ms": {k: v["ms"] for k, v in timing.items()},
           "failures": failures, **sw.fields()}
    if failures:
        emit({"phase": "cut_decoder_path", **out})
        raise SystemExit(f"{arch} path: {failures}")
    return out


def decoders_main_path(dev, sleep: int) -> dict:
    """Phase 17: the reference's last three decoder configs and the int8 KV
    layout.  starcoder2-15b whole (40 layers, d_model 6,144, 48 heads over
    4 KV heads of 128, GELU MLP of 24,576 with biases, LayerNorm, RoPE at
    base 1e5, vocabulary 49,152; bf16, random weights drawn on the card,
    ~31.9 GB): the attention kernels at 48 x 128 over 4 KV heads
    (:func:`attn_shape_checks`); the default ``ServeSpec()`` gateway and
    the paged ``"cuda"``, ``"plain"`` and ``"gather"`` gateways, float32 at
    depth 4 and bf16 at full depth (:func:`dense_main_path`); load (c)
    admitted through the fold, the cascade tick against the flat tick
    (:func:`cascade_main_path`); the captured 8 x 1k flat tick and load
    (c)'s cascade tick against their eager steps
    (:func:`capture_main_path`) beside a byte model of the flat tick; the
    int8 layout on the same weights (:func:`int8_main_path`).  Then, each
    model freed before the next, deepseek-67b at ``DS67_DEPTH`` layers and
    llama3-405b at ``L405_DEPTH`` (the kernels at 128 x 128 over 8 KV heads
    first) through :func:`cut_decoder_path`.  Returns the launches of the
    bf16 paths ("decoders") and of the int8 ones ("int8"); raises
    SystemExit on a failed check."""
    import torch

    from repro_torch import configs
    from repro_torch.models import lm

    sw = Stopwatch()
    cfg = configs.config(SC2_ARCH)
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    sizes = param_sizes(params)
    n_params = sum(sizes.values())
    sw.lap("init")
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    timing = attn_shape_checks(
        dev, torch.Generator(device=dev).manual_seed(17), sleep,
        cfg.n_layers, tag="starcoder2", hq=SC2_HQ, hkv=SC2_HKV, d=SC2_D)
    sw.lap("kernel_checks")
    keep = {}
    dense, _ = dense_main_path(dev, cfg, params, sc=False,
                               runs=DECODER_HOST_RUNS, keep=keep,
                               eager_profile=False)
    add(dense)
    sw.lap("dense_path")
    add(cascade_main_path(dev, dataclasses.replace(
        cfg, n_layers=SC2_CASCADE_DEPTH), params, chunked=True, turns=False,
        host_runs=DECODER_HOST_RUNS, eager_profile=False))
    sw.lap("cascade_path")
    capture = capture_main_path(dev, cfg, params, runs=DECODER_HOST_RUNS,
                                eager_profile=False)
    flat = capture["flat_8x1k"]
    sw.lap("capture")
    int8 = int8_main_path(dev, cfg, params, keep.pop("dense"))
    sw.lap("int8")
    del params
    free_card()
    cut = {DS67_ARCH: cut_decoder_path(dev, DS67_ARCH, DS67_DEPTH, sleep)}
    add(cut[DS67_ARCH]["launches"])
    sw.lap(DS67_ARCH)
    cut[L405_ARCH] = cut_decoder_path(dev, L405_ARCH, L405_DEPTH, sleep,
                                      (L405_HQ, L405_HKV, L405_D))
    add(cut[L405_ARCH]["launches"])
    sw.lap(L405_ARCH)
    # a model of the 8 x 1k flat tick's bytes, not a measurement: every
    # layer's bf16 weights and lm_head read once (not the embedding's rows),
    # lm_head's float32 copy written and read, and the K and V rows of 8
    # lanes x 1,025 positions in every layer
    weights = 2 * (n_params - sizes["embed"] - sizes["lm_head"])
    kv_bytes = 2 * cfg.n_layers * LM_SLOTS * 1025 * SC2_HKV * SC2_D * 2
    tick_bytes = weights + 2 * sizes["lm_head"] + 8 * sizes["lm_head"] + \
        kv_bytes
    prof = flat["profile"]["captured"]
    emit({"phase": "decoders_main_path", "model": cfg.name,
          "config": {k: getattr(cfg, k) for k in (
              "n_layers", "d_model", "n_heads", "n_kv_heads", "d_head",
              "d_ff", "mlp_type", "use_bias", "norm_type", "rope_theta",
              "vocab", "param_dtype")},
          "params": n_params, "bytes_bf16": 2 * n_params,
          "tick_8x1k_host_ms": {s: flat["host_ms"][s]["median"]
                                for s in ("captured", "eager")},
          "tick_8x1k_device_busy_ms": prof["device_busy_ms_per_tick"],
          "tick_8x1k_idle_share": prof["device_idle_share"],
          "tick_8x1k_top_device_ms": prof["top_device_ms_per_tick"],
          "tick_bytes_model": {"layer_weights": weights,
                               "lm_head": 2 * sizes["lm_head"],
                               "lm_head_f32": 8 * sizes["lm_head"],
                               "kv": kv_bytes, "total": tick_bytes},
          "tick_bytes_bound_ms": tick_bytes / PEAK_BYTES_PER_S * 1e3,
          "int8": {k: int8[k] for k in ("arena_bytes_per_position",
                                        "first_tick_vs_bf16",
                                        "tick_8x1k_plain_host_ms")},
          "cut": cut,
          "launches": {"decoders": launches, "int8": int8["launches"]},
          "kernel_ms": {k: v["ms"] for k, v in timing.items()},
          **sw.fields()})
    return {"decoders": launches, "int8": int8["launches"]}


# -- the SC kernels (phase 3) -------------------------------------------------

# bucket 32 of the full LeNet-5 conv1: windows of 5 x 5 = 25 leaves
SC_M, SC_K = 32 * 784, 25
# the timing's shapes: bits, O (the full LeNet-5's 2 x 32 and the gateway's
# default FrontendSpec's 2 x 8), K (as the layer has it, and a power of two)
SC_TIMING = [(bits, O, K) for bits in (4, 8) for O in (64, 16)
             for K in (SC_K, 32)]
# trees past one of 1,024 leaves: a subtree and a leaf more, 1.5 and 2
# subtrees, stablelm-3b's d_model, four subtrees
SC_BIG_K = (1025, 1536, 2048, 2560, 4096)
# the SC LM frontend on a stablelm-3b prompt: d_model leaves, a prompt of
# 1,000 tokens (load (b)'s length)
FRONTEND_D, FRONTEND_M = 2560, 1000


# -- observability on the frame path and the prompt path (phase 14) -----

# the H100 SXM's ridge point for the cost model's verdicts: dense bf16
# tensor peak over HBM3 bandwidth (NVIDIA data sheet), in FLOPs per byte
H100_RIDGE = BF16_FLOPS / PEAK_BYTES_PER_S
OBS_HOST_RUNS = 2           # turns a side, traced against untraced
OBS_TURN_TICKS = 8          # ticks per turn
OBS_FOLDS = 1               # cold 1,000-token folds a side, per turn
OBS_ATTACHMENTS = ("tracer", "metrics", "slo", "flight", "incident")


def obs_frame_attachments(obs, out_dir: str | None = None) -> dict:
    """The frame path's observability, wired as a user wires it: tracer,
    metrics, SLO monitor, flight recorder and (with ``out_dir``) incident
    capture."""
    tr = obs.Tracer()
    m = obs.MetricsRegistry(interval_s=0.01)
    mon = obs.SLOMonitor(obs.SLOPolicy.default(
        period_s=TRACE_SECONDS, queue_wait_s=0.05), tracer=tr, metrics=m)
    fl = obs.FlightRecorder()
    att = {"tracer": tr, "metrics": m, "slo": mon, "flight": fl}
    if out_dir is not None:
        att["incident"] = obs.IncidentCapture(out_dir, flight=fl, slo=mon,
                                              metrics=m)
    return att


def obs_checks(obs, tr, tel, metrics, slo) -> dict:
    """What every traced run must show: one ``request`` span per
    completion, properly nested spans, the span energies re-folding to the
    ledger bit for bit, a valid Chrome trace and OpenMetrics exposition,
    and every critical path re-folding exactly."""
    tr.assert_nested()
    tr.assert_energy_conserved(tel)
    chrome = obs.chrome_trace(tr, metrics)
    text = obs.openmetrics_text(metrics, slo)
    cps = obs.analyze_critical_paths(tr.events)
    agg = obs.aggregate_critical_paths(cps)
    out = {"request_spans": len(tr.request_spans()),
           "records": len(tel.records),
           "events": len(tr.events),
           "chrome_trace_errors": obs.validate_chrome_trace(chrome),
           "chrome_trace_bytes": len(json.dumps(chrome)),
           "openmetrics_errors": obs.validate_openmetrics(text),
           "openmetrics_bytes": len(text),
           "critical_paths": len(cps),
           "critical_paths_exact": all(obs.critpath.verify(cp)
                                       for cp in cps),
           "critical_path_ranking": agg.get("ranking"),
           "slo_state": slo.state,
           "slo_transitions": len(slo.transitions)}
    bad = [k for k in ("chrome_trace_errors", "openmetrics_errors") if out[k]]
    if bad or out["request_spans"] != out["records"] or \
            out["critical_paths"] != out["records"] or \
            not out["critical_paths_exact"]:
        raise SystemExit(f"phase 14: a traced run fails its checks: {out}")
    return out


def ledger(tel) -> dict:
    """A run's ledger by request: every field of each record but the
    virtual times, which a measured service clock moves, and the dropped
    uids."""
    skip = ("t_done", "t_dequeue", "t_admit")
    return {"records": {r.uid: {k: v for k, v in dataclasses.asdict(
                r).items() if k not in skip} for r in tel.records},
            "dropped": sorted(d[0] for d in tel.dropped)}


def obs_frame_path(dev) -> dict:
    """Phase 14, the frame path: the full LeNet-5 at bits 4 over the seeded
    trace, measured service, untraced and then with tracer, metrics, SLO,
    flight and incident attached: predictions and ledger bit for bit the
    untraced run's (the virtual times aside, which the measured service
    moves), the traced run's checks (:func:`obs_checks`), the captured
    steps unchanged; then bucket-32 batches timed on the host, traced
    against untraced in turns, with obs callbacks per batch."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.serve import obs
    from repro_torch.serve.gateway import frontend as fe
    from repro_torch.serve.gateway.gateway import (GatewayConfig,
                                                   MicroBatchGateway)
    from repro_torch.serve.gateway.sensors import (Arrival, FleetConfig,
                                                   SensorFleet)

    trace = SensorFleet(FleetConfig(seed=7)).events(TRACE_SECONDS)
    spec = fe.FrontendSpec(mode="sc", bits=4, lenet=configs.config("lenet5"))
    gw = MicroBatchGateway(GatewayConfig(), spec, seed=0, device=dev)
    gw.warmup()
    captured = gw.compile_counts()
    c0 = obs.callback_count()
    bare = gw.run(trace)
    zero = obs.callback_count() == c0
    with tempfile.TemporaryDirectory() as out:
        att = obs_frame_attachments(obs, out)
        reset_counts()
        tel = gw.run(trace, **att)
        torch.cuda.synchronize()
        launches = read_counts()
        checks = obs_checks(obs, att["tracer"], tel, att["metrics"],
                            att["slo"])
        bundles = len(att["incident"].captures)
    same = ledger(tel) == ledger(bare)
    if not (same and zero) or gw.compile_counts() != captured or \
            not launches["sng_pack"] or not launches["sc_dot"]:
        raise SystemExit(f"phase 14: the traced frame path differs from "
                         f"the untraced one (ledger equal {same}, zero "
                         f"callbacks untraced {zero}, captures "
                         f"{gw.compile_counts()} vs {captured}, launches "
                         f"{launches})")

    # bucket-32 batches: groups of 32 frames arriving together
    frames = [a.payload for a in trace[:32]]
    bursts = [Arrival(t=0.05 * g, uid=32 * g + j, endpoint=j, kind="frame",
                      payload=frames[j])
              for g in range(16) for j in range(32)]
    host: dict[str, list] = {"untraced": [], "traced": []}
    calls = []
    for _ in range(OBS_HOST_RUNS):
        for side in host:
            att = obs_frame_attachments(obs) if side == "traced" else {}
            c0 = obs.callback_count()
            t0 = time.perf_counter()
            gw.run(bursts, **att)
            torch.cuda.synchronize()
            host[side].append((time.perf_counter() - t0) * 1e3 / 16)
            if side == "traced":
                calls.append((obs.callback_count() - c0) / 16)
    return {"frames": len(trace), "served": len(tel.records),
            "dropped": len(tel.dropped), "ledger_equal_untraced": same,
            "untraced_callbacks_zero": zero, "captures": captured,
            "launches": launches, "bundles": bundles, **checks,
            "bucket32_batch_host_ms": {
                side: {"median": statistics.median(v), "runs": v}
                for side, v in host.items()},
            "bucket32_obs_callbacks_per_batch": calls[0]}


def obs_prompt_spec(backend: str, new_tokens: int, obs, out_dir: str,
                    tight: bool):
    """The chunked paged gateway's ``ServeSpec`` for phase 14's loads with
    every attachment: tracer, metrics, an SLO monitor (``tight``: a TTFT
    target of 1 us that every completion misses, so the monitor goes
    critical and the capture pipeline writes a bundle), the default flight
    recorder and incident bundles in ``out_dir``."""
    tr = obs.Tracer()
    m = obs.MetricsRegistry(interval_s=0.05)
    if tight:
        pol = obs.SLOPolicy(
            objectives=(obs.SLObjective("ttft", target=1e-6, budget=0.5),),
            windows=(obs.BurnWindow(1e3, 1e3, 1.5, "critical"),
                     obs.BurnWindow(1e3, 1e3, 1.0, "warn")))
    else:
        pol = obs.SLOPolicy.default(period_s=600.0, ttft_s=2.0, tpot_s=0.2)
    return load_spec(backend, True, new_tokens).replace(
        tracer=tr, metrics=m, slo=obs.SLOMonitor(pol, tracer=tr, metrics=m),
        flight=True, incident_dir=out_dir)


def obs_tick_turns(gw, obs, prompts, new_tokens: int) -> dict:
    """Host ms per captured tick, traced against untraced in turns: the
    prompts (indexed already, so each admission resumes) decode
    ``new_tokens`` tokens; after the admitting step, ``OBS_TURN_TICKS``
    ticks a turn with the tracer wired into the batcher and adapter, then
    as many without, ``OBS_HOST_RUNS`` turns a side, each tick ending in a
    synchronize (the traced tick's own, the untraced tick's read of its
    tokens)."""
    import torch

    from repro_torch.serve.gateway.slots import Request

    batcher, ad = gw.batcher, gw.batcher.adapter
    for i, p in enumerate(prompts):
        batcher.submit(Request(uid=1000 + i, prompt=p,
                               max_new_tokens=new_tokens))
    batcher.step()
    host: dict[str, list] = {"untraced": [], "traced": []}
    calls = []
    for _ in range(OBS_HOST_RUNS):
        for side in host:
            tr = obs.Tracer() if side == "traced" else None
            batcher.tracer = ad.tracer = tr
            c0 = obs.callback_count()
            for _ in range(OBS_TURN_TICKS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                batcher.step()
                torch.cuda.synchronize()
                host[side].append((time.perf_counter() - t0) * 1e3)
            if tr is not None:
                calls.append((obs.callback_count() - c0) / OBS_TURN_TICKS)
                if len(tr.spans("tick")) != OBS_TURN_TICKS:
                    raise SystemExit("phase 14: a traced tick left no span")
    batcher.tracer = ad.tracer = None
    if batcher.last_active != len(prompts):
        raise SystemExit("phase 14: a lane retired during the tick turns")
    batcher.run()
    return {"lanes": len(prompts),
            "host_ms": {side: {"median": statistics.median(v), "runs": v}
                        for side, v in host.items()},
            "obs_callbacks_per_tick": statistics.median(calls)}


def obs_fold_turns(gw, obs, vocab: int) -> dict:
    """The traced fold's synchronize per chunk: cold 1,000-token prompts
    (fresh random tokens, 63 chunks each) admitted into slot 0 with and
    without a tracer, in turns; host ms per chunk, each admission ending
    in a synchronize, and in the traced folds the host ms spent waiting
    in the chunks' synchronizes (the adapter's ``synchronize`` timed)."""
    import numpy as np
    import torch

    from repro_torch.serve.kvcache import paged

    ad = gw.batcher.adapter
    rng = np.random.default_rng(29)
    per_chunk: dict[str, list] = {"untraced": [], "traced": []}
    waits: list[float] = []
    sync = paged.synchronize

    def timed_sync(device):
        t0 = time.perf_counter()
        sync(device)
        waits.append((time.perf_counter() - t0) * 1e3)
    for _ in range(OBS_HOST_RUNS):
        for side in per_chunk:
            ad.tracer = obs.Tracer() if side == "traced" else None
            for _ in range(OBS_FOLDS):
                prompt = rng.integers(0, vocab, 1000).astype(np.int32)
                chunks = ad.prefill_chunks_total
                torch.cuda.synchronize()
                with mock.patch.object(paged, "synchronize", timed_sync):
                    t0 = time.perf_counter()
                    ad.insert(0, prompt, max_new=8)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                chunks = ad.prefill_chunks_total - chunks
                per_chunk[side].append(dt * 1e3 / chunks)
                ad.clear(0)
    ad.tracer = None
    med = {side: statistics.median(v) for side, v in per_chunk.items()}
    if len(waits) != chunks * OBS_HOST_RUNS * OBS_FOLDS:
        raise SystemExit(f"phase 14: {len(waits)} chunk synchronizes in "
                         "the traced folds")
    return {"chunks_per_fold": chunks,
            "host_ms_per_chunk": {side: {"median": med[side], "runs": v}
                                  for side, v in per_chunk.items()},
            "traced_minus_untraced_ms_per_chunk":
                med["traced"] - med["untraced"],
            "sync_wait_ms_per_chunk": {
                "median": statistics.median(waits),
                "mean": statistics.fmean(waits), "max": max(waits)}}


def obs_serve(gw, arrivals) -> dict:
    """One run of ``arrivals`` through ``gw``, counting its steps, the
    fold's chunks and the kernels' launches, and keeping each request's
    tokens (by its place in ``arrivals``)."""
    import torch

    batcher, ad = gw.batcher, gw.batcher.adapter
    place = {a.uid: i for i, a in enumerate(arrivals)}
    streams: dict[int, list] = {}
    steps = [0]
    step = batcher.step

    def counted():
        steps[0] += 1
        tokens = step()
        for r in tokens:
            streams[place[r.uid]] = list(map(int, r.generated))
        return tokens
    batcher.step = counted
    chunks = ad.prefill_chunks_total
    reset_counts()
    try:
        tel = gw.run(arrivals)
        torch.cuda.synchronize()
    finally:
        batcher.step = step
    return {"tel": tel, "streams": streams, "steps": steps[0],
            "chunks": ad.prefill_chunks_total - chunks,
            "launches": read_counts()}


def obs_spans(tr, run: dict, before: dict | None = None) -> tuple:
    """A traced run's spans (those recorded since ``before``) and the
    adapter's counters they must equal: ``prefill_chunk`` spans = chunks
    folded, ``prefix_resume`` instants = resumed admissions, ``tick``
    spans = steps."""
    spans = {"prefill_chunk": len(tr.spans("prefill_chunk")),
             "prefix_resume": sum(e["name"] == "prefix_resume"
                                  for e in tr.events),
             "tick": len(tr.spans("tick"))}
    for k, v in (before or {}).items():
        spans[k] -= v
    counters = {"prefill_chunk": run["chunks"],
                "prefix_resume": sum(r.prefill_tokens_skipped > 0
                                     for r in run["tel"].records),
                "tick": run["steps"]}
    return spans, counters


def obs_prompt_load(dev, cfg, params, load: str) -> dict:
    """Phase 14, one load through the chunked gateway with every
    attachment: load (b) through ``"cuda"``, load (c) through
    ``"cascade"``, all prompts arriving at once.  Two gateways built the
    same way fold the load cold: one bare (no obs call), then one with
    every attachment.  The traced run's tokens and pool counters bit for
    bit the bare run's; its spans against the adapter's counters
    (:func:`obs_spans`); its captured steps those of the bare run; the
    cost model at the H100's ridge; then the load again on the traced
    gateway, its prompts now indexed, so each admission resumes: the same
    tokens, spans against counters, and no capture (``RecompileDetector``
    from the cold traced run's end).  The incident bundles (load (c): one
    from its SLO monitor going critical) and one from ``capture_incident``,
    each reloaded through the validator; then the host ms per captured
    tick and (load (b)) per fold chunk, traced against untraced."""
    import gc
    import tempfile

    import torch

    from repro_torch.serve import obs
    from repro_torch.serve.gateway.sensors import Arrival
    from repro_torch.serve.spec import make_gateway

    backend, new_tokens = {"b": ("cuda", 16), "c": ("cascade", 32)}[load]
    prompts = load_b_prompts(cfg.vocab)[0] if load == "b" else \
        load_c_prompts(cfg.vocab)[0]

    def arrivals(uid0: int) -> list:
        return [Arrival(t=0.0, uid=uid0 + i, endpoint=i, kind="prompt",
                        payload=p) for i, p in enumerate(prompts)]
    pool_keys = ("prefill_tokens_total", "prefill_tokens_skipped")

    bare_gw = make_gateway(cfg, params, load_spec(backend, True, new_tokens),
                           device=dev)
    c0 = obs.callback_count()
    bare = obs_serve(bare_gw, arrivals(0))
    zero = obs.callback_count() == c0
    bare_pool = {k: bare["tel"].pool[k] for k in pool_keys}
    captured = {k: f._cache_size() for k, f in bare_gw.jit_fns().items()}
    del bare_gw
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out:
        gw = make_gateway(cfg, params, obs_prompt_spec(
            backend, new_tokens, obs, out, tight=load == "c"), device=dev)
        tr = gw.tracer
        cold = obs_serve(gw, arrivals(0))
        tel = cold["tel"]
        same = cold["streams"] == bare["streams"] and \
            len(bare["streams"]) == len(prompts)
        pool = {k: tel.pool[k] for k in pool_keys}
        checks = obs_checks(obs, tr, tel, gw.metrics, gw.slo)
        spans, counters = obs_spans(tr, cold)
        captured_traced = {k: f._cache_size()
                           for k, f in gw.jit_fns().items()}
        cost = obs.attribute(gw.cost_args(), tr, ridge=H100_RIDGE,
                             telemetry=tel)

        # the load again, resumed: fresh uids on the same tracer
        det = obs.RecompileDetector()
        det.track("gateway", gw.jit_fns())
        det.snapshot()
        before = obs_spans(tr, cold)[0]
        resumed = obs_serve(gw, arrivals(len(prompts)))
        r_spans, r_counters = obs_spans(tr, resumed, before)
        r_same = resumed["streams"] == bare["streams"]
        recompiles = det.steady_state_recompiles()

        explicit = gw.capture_incident("obs_probe", extra={"load": load})
        bundles = []
        for cap in gw.incident.captures:
            b = obs.load_incident_bundle(cap["path"])
            bundles.append({"reason": cap["reason"], "t": cap["t"],
                            "bytes": Path(cap["path"]).stat().st_size,
                            "flight_spans": len(b["flight"]["spans"]),
                            "slo_state": (b["slo"] or {}).get("state")})
        ticks = obs_tick_turns(gw, obs, prompts, 4 + 2 * OBS_HOST_RUNS
                               * OBS_TURN_TICKS)
        folds = obs_fold_turns(gw, obs, cfg.vocab) if load == "b" else None
    launches = cold["launches"]
    auto = [b for b in bundles if b["reason"] == "slo_critical"]
    out = {"load": load, "backend": backend, "requests": len(prompts),
           "tokens_equal_untraced": same, "untraced_callbacks_zero": zero,
           "pool_equal_untraced": pool == bare_pool,
           "spans": spans, "counters": counters,
           "resumed": {"tokens_equal_untraced": r_same, "spans": r_spans,
                       "counters": r_counters,
                       "steady_state_recompiles": recompiles},
           "captures": captured, "captures_traced": captured_traced,
           "launches": launches, **checks,
           "cost_model": {"ridge_flops_per_byte": H100_RIDGE, "stages": {
               name: {k: e.get(k) for k in (
                   "source", "flops", "bytes", "intensity", "verdict",
                   "calls", "measured_s", "achieved_bytes_per_s",
                   "achieved_flops_per_s")}
               for name, e in cost["stages"].items()},
               "energy_conserved": cost["energy"]["conserved"]},
           "bundles": bundles, "explicit_bundle": Path(explicit).name,
           "pool": pool, "tick_turns": ticks, "fold_turns": folds}
    fails = []
    if not (same and zero and pool == bare_pool):
        fails.append(f"against the untraced run: no obs call {zero}, "
                     f"pool {pool} vs {bare_pool}, streams "
                     f"{len(cold['streams'])} vs {len(bare['streams'])}, "
                     f"differing {[i for i in bare['streams'] if cold['streams'].get(i) != bare['streams'][i]]}")
    if spans != counters or spans["prefill_chunk"] <= len(prompts):
        fails.append(f"cold: spans {spans} vs counters {counters}")
    if not r_same or r_spans != r_counters or \
            r_counters["prefix_resume"] != len(prompts):
        fails.append(f"resumed: tokens equal {r_same}, spans {r_spans} "
                     f"vs counters {r_counters}")
    if recompiles or captured_traced != captured:
        fails.append(f"the traced runs captured: {captured_traced} vs "
                     f"{captured}, {recompiles}")
    if not cost["energy"]["conserved"] or \
            cost["stages"]["decode"]["verdict"] != "memory-bound":
        fails.append(f"cost model: {out['cost_model']}")
    if len(bundles) < 1 + (load == "c") or (load == "c" and not auto):
        fails.append(f"incident bundles: {bundles}")
    if not launches.get("flash_attention") or not any(
            launches.get(k) for k in ("paged_decode_attention",
                                      "paged_decode_attention_with_state")):
        fails.append(f"launches: {launches}")
    if fails:
        raise SystemExit(f"phase 14, load ({load}): {fails}")
    del gw
    gc.collect()
    torch.cuda.empty_cache()
    return out


def obs_main_path(dev, cfg, params) -> dict:
    """Phase 14: observability on the frame path and the prompt path
    (``obs_main_path`` line).  Returns the phase's kernel launches."""
    sw = Stopwatch()
    reset_counts()
    frame = obs_frame_path(dev)
    sw.lap("frame")
    launches = dict(frame["launches"])
    loads = {}
    for load in ("b", "c"):
        loads[load] = obs_prompt_load(dev, cfg, params, load)
        for k, v in loads[load]["launches"].items():
            launches[k] = launches.get(k, 0) + v
        sw.lap(f"load_{load}")
    emit({"phase": "obs_main_path", "gpu": nvidia_smi("name,power.limit"),
          "frame": frame, "prompt": loads,
          "overhead": {
              "tick_host_ms": {
                  load: {side: r["tick_turns"]["host_ms"][side]["median"]
                         for side in ("untraced", "traced")}
                  for load, r in loads.items()},
              "obs_callbacks_per_tick": {
                  load: r["tick_turns"]["obs_callbacks_per_tick"]
                  for load, r in loads.items()},
              "fold_ms_per_chunk": {
                  side: loads["b"]["fold_turns"]["host_ms_per_chunk"][side][
                      "median"] for side in ("untraced", "traced")},
              "sync_wait_ms_per_chunk": loads["b"]["fold_turns"][
                  "sync_wait_ms_per_chunk"],
              "bucket32_batch_host_ms": {
                  side: frame["bucket32_batch_host_ms"][side]["median"]
                  for side in ("untraced", "traced")},
              "bucket32_obs_callbacks_per_batch":
                  frame["bucket32_obs_callbacks_per_batch"]},
          **sw.fields()})
    return launches


# -- sharded and disaggregated serving (phase 18) ---------------------------

SHARD_SLICES = 4
SHARD_NEW_TOKENS = 16
SHARD_MIGRATE_BLOCKS = 80   # a migration check adapter's blocks (1.3 GB)
SHARD_PATH = ("paged_decode_attention", "scatter_kv_rows", "flash_attention")


def shard_spec(mesh=None, roles=None, chunked: bool = True, tracer=None,
               backend: str | None = None):
    """The ``ServeSpec`` of phases 18 and 20's gateways: phase 5's 8 lanes
    of 1,536 tokens in 16-token blocks, each slice (``mesh``) with its own
    arena of the dense-equivalent ``num_blocks``; ``backend`` None: the
    device's flat tick."""
    from repro_torch.serve.spec import ServeSpec
    return ServeSpec(n_slots=LM_SLOTS, max_len=LM_MAX_LEN, paged=True,
                     block_size=LM_BLOCK, chunked=chunked, mesh=mesh,
                     roles=roles, tracer=tracer, backend=backend,
                     max_new_tokens=SHARD_NEW_TOKENS)


def shard_load(dev, cfg, params, prompts, spec, stagger: bool = False
               ) -> dict:
    """``prompts`` (arriving at t = 0; with ``stagger`` the first at 0 and
    the others at 1 µs, so they route after its admission indexed its
    chain: affinity, a spill and load routing on load (b)) through
    ``make_gateway(cfg, params, spec)``, one-slice or sharded: per request
    (uid = index) the
    tokens, the first token's logits and the logits of every tick it
    decoded in, on whichever slice (float32 copies); every kernel's
    launches over the run; the ledger; the routing, migration and handoff
    counters; each slice's protected chain keys; with a tracer, the cost
    model at the H100's ridge, the energy re-fold and the critical paths
    by role."""
    import torch

    from repro_torch.serve import obs
    from repro_torch.serve.gateway.sensors import Arrival
    from repro_torch.serve.spec import make_gateway

    gw = make_gateway(cfg, params, spec, device=dev)
    parts = [(sl.adapter, sl.batcher) for sl in gw.slices] \
        if hasattr(gw, "slices") else [(gw.batcher.adapter, gw.batcher)]
    prefill, rows, tokens = {}, {}, {}
    finite = [True]

    def wire(ad, b):
        insert, decode, step, admissible = ad.insert, ad.decode, b.step, \
            b._admissible
        cur = [None]

        def keep_admissible(req):
            cur[0] = req.uid                # the insert that follows
            return admissible(req)

        def keep_insert(slot, prompt, max_new=None):
            tok = insert(slot, prompt, max_new)
            prefill[cur[0]] = ad.last_prefill_logits[0].float().clone()
            return tok

        def keep_decode(toks, active):
            lanes = {r.uid: s for s, r in enumerate(b.active)
                     if r is not None}
            out = decode(toks, active)
            logits = ad.last_logits.float()
            finite[0] &= bool(torch.isfinite(logits).all())
            for uid, s in lanes.items():
                rows.setdefault(uid, []).append(logits[s].clone())
            return out

        def keep_step(*args, **kw):
            fin = step(*args, **kw)
            for r in fin:
                tokens[r.uid] = list(map(int, r.generated))
            return fin
        ad.insert, ad.decode = keep_insert, keep_decode
        b.step, b._admissible = keep_step, keep_admissible
    for ad, b in parts:
        wire(ad, b)
    arrivals = [Arrival(uid=i, t=1e-6 if stagger and i else 0.0,
                        endpoint=0, kind="prompt", payload=p)
                for i, p in enumerate(prompts)]
    reset_counts()
    t0 = time.perf_counter()
    tel = gw.run(arrivals)
    torch.cuda.synchronize()
    out = {"run_s": time.perf_counter() - t0, "tokens": tokens,
           "prefill": prefill, "rows": rows, "finite": finite[0],
           "launches": read_counts(), "served": len(tel.records),
           "dropped": len(tel.dropped),
           "fleet_energy_nj": tel.fleet_energy_nj,
           "records": {r.uid: (r.energy_nj, r.migration_bytes, r.migrations)
                       for r in tel.records}}
    if hasattr(gw, "slices"):
        out.update(routing=dict(gw.routing), migrations=gw.migrations,
                   migration_bytes=gw.migration_bytes,
                   handoffs=gw.handoffs, handoff_bytes=gw.handoff_bytes,
                   protected=[len(sl.adapter.pool.protected)
                              for sl in gw.slices],
                   captures={n: f._cache_size()
                             for n, f in gw.jit_fns().items()})
    tr = spec.tracer
    if tr is not None:
        cost = obs.attribute(gw.cost_args(), tr, ridge=H100_RIDGE,
                             telemetry=tel)
        cps = obs.analyze_critical_paths(tr.events)
        agg = obs.aggregate_critical_paths(cps, roles=spec.roles is not None)
        out.update(cost=cost, critical_paths=len(cps),
                   by_role={k: v["share"]
                            for k, v in agg.get("by_role", {}).items()})
    del gw, parts
    torch.cuda.empty_cache()
    return out


def add_launches(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def shard_streams(a: dict, b: dict, mode: str) -> dict:
    """:func:`stream_differences` of two runs with its verdict under
    ``mode``: ``"bitwise"`` (tokens and logits equal), ``"tokens"``
    (tokens equal: float32) or ``"near_tie"`` (bf16: every first
    difference a near tie)."""
    d = stream_differences(a, b)
    ties = all(x["near_tie"] for x in d["first_differences"])
    d["ok"] = {"bitwise": d["tokens_equal"] and d["max_abs_dlogit"] == 0.0,
               "tokens": d["tokens_equal"], "near_tie": ties}[mode]
    return d


def shard_migration(dev, cfg, params, prompt) -> dict:
    """Check (c): a lane one-shot prefilled on slice A of two (one card),
    four forced ticks, migrated to slice B through the host, four more;
    A's and B's logits bit for bit a stay-put adapter's on the same forced
    tokens, with the bytes the receipt charges and the round trip's ms.
    The stay-put run goes first and whole, so that the launches counted
    are A's and B's alone."""
    import numpy as np
    import torch

    from repro_torch.serve.gateway.slots import make_adapter
    from repro_torch.serve.shard import build_slices, migrate_slot

    kw = dict(n_slots=LM_SLOTS, max_len=LM_MAX_LEN, block_size=LM_BLOCK,
              num_blocks=SHARD_MIGRATE_BLOCKS, chunked=False)
    rng = np.random.default_rng(19)
    forced = rng.integers(0, cfg.vocab, (8, LM_SLOTS)).astype(np.int32)
    lane = np.zeros(LM_SLOTS, bool)
    lane[0] = True
    oracle = make_adapter(cfg, params, paged=True, **kw)
    first = oracle.insert(0, prompt, SHARD_NEW_TOKENS)
    stay = []
    for t in range(8):
        tok = oracle.decode(forced[t], lane)[0]
        stay.append((tok, oracle.last_logits[0].clone()))
    del oracle
    torch.cuda.empty_cache()
    A, B = (sl.adapter for sl in build_slices(cfg, params, [[dev], [dev]],
                                              **kw))

    def same(ad, t):
        tok = ad.decode(forced[t], lane)[0]
        return bool(tok == stay[t][0]) and \
            bool(torch.equal(ad.last_logits[0], stay[t][1]))
    reset_counts()
    pre = A.insert(0, prompt, SHARD_NEW_TOKENS) == first
    pre &= all([same(A, t) for t in range(4)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    receipt = migrate_slot(A, 0, B, 0, prompt)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    post = [same(B, t) for t in range(4, 8)]
    out = {"pre_move_bitwise": bool(pre), "post_move_bitwise": post,
           "receipt": dataclasses.asdict(receipt), "migrate_ms": ms,
           "ms_per_mb": ms / (receipt.bytes_moved / 1e6),
           "source_released": not A.slot_bids[0],
           "launches": read_counts()}
    del A, B, stay
    torch.cuda.empty_cache()
    return out


def shard_main_path(dev, sleep: int, cfg=None, params=None,
                    keep: dict | None = None) -> dict:
    """Phase 18: sharded and disaggregated serving at stablelm-3b's full
    width and depth (bf16; phase 5's weights, shared by every slice, or
    drawn the same way when run alone), ``SHARD_SLICES`` slices on the one
    card, each with its own arena (``shard_main_path`` line).  Returns the
    sharded runs' kernel launches (not the unsharded baselines'); raises
    SystemExit on a failed check.  ``keep``, where given, receives the
    one-device runs of loads (b) and (c) (``flat_b``, ``flat_c``), phase
    20's baselines."""
    import torch

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve import obs
    from repro_torch.serve.shard import RolePlan

    sw = Stopwatch()
    t_phase = time.perf_counter()
    if cfg is None:
        cfg = configs.config("stablelm-3b")
        params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
        sw.lap("init")
    mesh = [[dev]] * SHARD_SLICES
    load_b, _ = load_b_prompts(cfg.vocab)
    load_c, _ = load_c_prompts(cfg.vocab)
    launches: dict = {}
    failures: list[str] = []

    # (a) one slice against the unsharded gateway, bit for bit
    flat = shard_load(dev, cfg, params, load_b, shard_spec(), stagger=True)
    single = shard_load(dev, cfg, params, load_b, shard_spec(mesh=[[dev]]),
                        stagger=True)
    a = shard_streams(flat, single, "bitwise")
    if not a["ok"]:
        failures.append(f"(a) one slice is not bit for bit the unsharded "
                        f"gateway: {a}")
    sw.lap("a_single_slice")

    # (b) four slices: bf16 under the near-tie rule (load (b) chunked and
    # staggered, traced for (e); load (c) one-shot), float32 at depth 4
    # equal
    four = shard_load(dev, cfg, params, load_b,
                      shard_spec(mesh=mesh, tracer=obs.Tracer()),
                      stagger=True)
    b_bf16 = {"b": shard_streams(flat, four, "near_tie")}
    flat_c = shard_load(dev, cfg, params, load_c, shard_spec(chunked=False))
    four_c = shard_load(dev, cfg, params, load_c,
                        shard_spec(mesh=mesh, chunked=False))
    b_bf16["c"] = shard_streams(flat_c, four_c, "near_tie")
    sw.lap("b_four_slices_bf16")
    cfg4 = strict_cfg(cfg)
    params4 = lm.init(cfg4, torch.Generator(device=dev).manual_seed(1))
    b_f32, f32_runs = {}, {}
    for name, prompts, chunked in (("b", load_b, True),
                                   ("c", load_c, False)):
        one = shard_load(dev, cfg4, params4, prompts,
                         shard_spec(chunked=chunked), stagger=chunked)
        many = shard_load(dev, cfg4, params4, prompts,
                          shard_spec(mesh=mesh, chunked=chunked),
                          stagger=chunked)
        b_f32[name] = shard_streams(one, many, "tokens")
        f32_runs.update({f"flat_f32_{name}": one, f"four_f32_{name}": many})
    del params4
    torch.cuda.empty_cache()
    for name, d in {**{f"bf16 {k}": v for k, v in b_bf16.items()},
                    **{f"float32 {k}": v for k, v in b_f32.items()}}.items():
        if not d["ok"]:
            failures.append(f"(b) four slices vs one, {name}: {d}")
    sw.lap("b_four_slices_f32")

    # (c) a forced migration mid-decode, bit for bit its stay-put run
    mig = shard_migration(dev, cfg, params, load_b[0])
    if not (mig["pre_move_bitwise"] and all(mig["post_move_bitwise"]) and
            mig["source_released"] and mig["receipt"]["bytes_moved"] > 0):
        failures.append(f"(c) the migrated lane parted from its stay-put "
                        f"run: {mig}")
    sw.lap("c_migration")

    # (d) one prefill slice and three decode slices, traced
    disagg = shard_load(dev, cfg, params, load_b,
                        shard_spec(mesh=mesh, roles=RolePlan.split(1, 3),
                                   tracer=obs.Tracer()), stagger=True)
    d = shard_streams(four, disagg, "near_tie")
    energy = disagg["cost"]["energy"]
    d_ok = d["ok"] and disagg["handoffs"] == len(load_b) and \
        disagg["handoff_bytes"] > 0 and \
        energy["stages_nj"].get("migration_nj", 0.0) > 0 and \
        energy["conserved"] is True and \
        energy["total_nj"] == disagg["fleet_energy_nj"] and \
        any(disagg["protected"][1:]) and not disagg["protected"][0] and \
        {"prefill", "decode"} <= set(disagg["by_role"])
    if not d_ok:
        failures.append(f"(d) disaggregated: tokens {d}, handoffs "
                        f"{disagg['handoffs']} ({disagg['handoff_bytes']} "
                        f"B), energy {energy}, protected "
                        f"{disagg['protected']}, roles {disagg['by_role']}")
    sw.lap("d_disaggregated")

    # (e) the cost model over the sharded run's sliceN. stages
    stages = four["cost"]["stages"]
    decode = {k: v for k, v in stages.items() if k.endswith(".decode")}
    e_ok = len(decode) == SHARD_SLICES and all(
        v["source"] == "analytic" and v["verdict"] != "unknown"
        for v in decode.values()) and \
        sum(v["calls"] for v in decode.values()) > 0 and \
        all(k.startswith(("slice", "prefill", "decode"))
            for k in stages)
    if not e_ok:
        failures.append(f"(e) the cost model's slice stages: {stages}")
    roles_stages = sorted(disagg["cost"]["stages"])

    # the kernels line's shard launches are the sharded runs' alone (the
    # migration's A and B slices included); every one of those runs must
    # launch each kernel of the path itself, so that a sharded run that
    # took a plain route fails though its unsharded baseline did not
    sharded = {"single_b": single, "four_b": four, "four_c": four_c,
               "disagg_b": disagg, "four_f32_b": f32_runs["four_f32_b"],
               "four_f32_c": f32_runs["four_f32_c"], "migration": mig}
    baselines = {"flat_b": flat, "flat_c": flat_c,
                 "flat_f32_b": f32_runs["flat_f32_b"],
                 "flat_f32_c": f32_runs["flat_f32_c"]}
    baseline_launches: dict = {}
    for r in sharded.values():
        add_launches(launches, r["launches"])
    for r in baselines.values():
        add_launches(baseline_launches, r["launches"])
    runs = [r for name, r in {**sharded, **baselines}.items()
            if name != "migration"]
    if not all(r["finite"] and not r["dropped"] for r in runs):
        failures.append("a run dropped a request or a logit was not finite")
    for name, r in sharded.items():
        missing = [k for k in SHARD_PATH if not r["launches"].get(k, 0)]
        if missing:
            failures.append(f"the sharded run {name} never launched "
                            f"{missing}: {r['launches']}")
    emit({"phase": "shard_main_path", "gpu": nvidia_smi("name,power.limit"),
          "slices": SHARD_SLICES, "new_tokens": SHARD_NEW_TOKENS,
          "a_single_slice": {k: a[k] for k in ("tokens_equal",
                                               "max_abs_dlogit")},
          "b_four_slices": {
              "bf16": {k: {"tokens_equal": v["tokens_equal"],
                           "max_abs_dlogit": v["max_abs_dlogit"],
                           "first_differences": v["first_differences"]}
                       for k, v in b_bf16.items()},
              "float32_depth4": {k: {"tokens_equal": v["tokens_equal"],
                                     "max_abs_dlogit": v["max_abs_dlogit"]}
                                 for k, v in b_f32.items()},
              "routing": {"b": {**four["routing"],
                                "migrations": four["migrations"]},
                          "c": {**four_c["routing"],
                                "migrations": four_c["migrations"]}}},
          "c_migration": {k: v for k, v in mig.items() if k != "launches"},
          "d_disaggregated": {
              "tokens_vs_colocated": {k: d[k] for k in (
                  "tokens_equal", "max_abs_dlogit", "first_differences")},
              "handoffs": disagg["handoffs"],
              "handoff_bytes": disagg["handoff_bytes"],
              "migration_nj": energy["stages_nj"].get("migration_nj"),
              "stage_energy_total_nj": energy["total_nj"],
              "fleet_energy_nj": disagg["fleet_energy_nj"],
              "protected_keys_by_slice": disagg["protected"],
              "critical_path_share_by_role": disagg["by_role"],
              "captures": disagg["captures"]},
          "e_cost_model": {
              "ridge_flops_per_byte": H100_RIDGE,
              "stages": {k: {f: v.get(f) for f in (
                  "source", "verdict", "flops", "bytes", "intensity",
                  "calls", "achieved_bytes_per_s")}
                  for k, v in stages.items()},
              "role_stages": roles_stages},
          "run_s": {name: r["run_s"] for name, r in (
              ("flat_b", flat), ("single_b", single), ("four_b", four),
              ("flat_c", flat_c), ("four_c", four_c),
              ("disagg_b", disagg))},
          "launches": launches,
          "launches_by_run": {name: {k: r["launches"].get(k, 0)
                                     for k in SHARD_PATH}
                              for name, r in sharded.items()},
          "baseline_launches": {k: baseline_launches.get(k, 0)
                                for k in SHARD_PATH},
          "failures": failures, **sw.fields()})
    if failures:
        raise SystemExit(f"phase 18: {failures}")
    if keep is not None:
        keep.update(flat_b=flat, flat_c=flat_c)
    return launches


# -- sharded serving's model axis (phase 20) ----------------------------------

MA_WIDTHS = (2, 4)          # devices a slice, every one cuda:0 on one H100
MA_HYMBA_DEPTH = 4          # hymba-1.5b's layers 0-3 (0 global, 1-3 windowed)
MA_F32_TOL = 1e-5           # the reference's model-axis logits bound
MA_TIMING_RUNS = 2          # turns a side of the per-width tick timing
# the kernels a model-axis run launches, its gates' keys
MA_KEYS = ("paged_decode_attention", "scatter_kv_rows",
           "paged_decode_attention_with_state", "cascade_prefix_attention",
           "merge_attn_states", FUSED_MERGE, "flash_attention")
# the cascade tick's kernels (load (c): every tick grouped)
MA_CASCADE_PATH = ("cascade_prefix_attention",
                   "paged_decode_attention_with_state", FUSED_MERGE,
                   "scatter_kv_rows", "flash_attention")
# kernel 5 at the split-KV fallback's shape: hymba-1.5b's 25 heads over 5 KV
# heads of 64, 8 lanes of 1,100-1,200 positions in 16-position blocks, each
# of two shards holding 8 rows of every block
MA_STRIDE = dict(B=8, Hq=25, Hkv=5, D=64, bs=16, shards=2, lo=1100, hi=1200)


def expected_launches(one: dict, m: int, fallback: bool) -> dict:
    """The kernels' launches of a model-``m`` slice on the run whose
    one-device launches are ``one`` (the same ticks and chunks: float32
    runs, tokens equal).  A head split launches every kernel once per
    shard where the one-device slice launched it once.  Under the split-KV
    fallback each of the tick's sweeps (the flat kernel's, and the
    cascade's suffix passes) becomes ``m`` sweeps of kernel 5 at the block
    stride and one merge of their states (``merge_attn_states``, over
    more than two ``merge_attn_states_n``, counted as its launches), no
    prefix pass or fused merge runs, the row write launches once per
    shard, and prompt attention as before (on the prefix gathered back in
    position order)."""
    if not fallback:
        return {k: m * one.get(k, 0) for k in MA_KEYS}
    sweeps = one.get("paged_decode_attention", 0) + \
        one.get("paged_decode_attention_with_state", 0)
    return {"paged_decode_attention": 0,
            "scatter_kv_rows": m * one.get("scatter_kv_rows", 0),
            "paged_decode_attention_with_state": m * sweeps,
            "cascade_prefix_attention": 0,
            "merge_attn_states": sweeps, FUSED_MERGE: 0,
            "flash_attention": one.get("flash_attention", 0)}


def ma_compare(name: str, one: dict, many: dict, m: int, strict: bool,
               fallback: bool, failures: list, path: tuple = ()) -> dict:
    """A model-``m`` run against a one-device run: with ``strict``
    (float32, the same spec) tokens equal, logits within ``MA_F32_TOL``
    and the launches :func:`expected_launches` exactly; in bf16 every
    first difference a near tie and every kernel of ``path`` launched.
    Appends to ``failures``; returns the run's row."""
    d = shard_streams(one, many, "tokens" if strict else "near_tie")
    want = expected_launches(one["launches"], m, fallback)
    got = {k: many["launches"].get(k, 0) for k in MA_KEYS}
    row = {"tokens_equal": d["tokens_equal"],
           "max_abs_dlogit": d["max_abs_dlogit"],
           "first_differences": d["first_differences"], "launches": got,
           "launches_expected": want, "run_s": many["run_s"]}
    ok = d["ok"] and many["finite"] and not many["dropped"]
    if strict:
        ok &= d["max_abs_dlogit"] <= MA_F32_TOL and got == want
    else:
        ok &= all(got[k] for k in path)
    if not ok:
        failures.append(f"{name}: {row}")
    return row


def arena_state(ad) -> dict:
    """A paged adapter's arena and lane state as one dict of tensors (a
    sharded slice's arena key by key and shard)."""
    arena = {f"{key}.{d}": a for d, sh in enumerate(ad.shards)
             for key, a in sh.arrays.items()}
    return {**arena, **ad.state}


def ma_tick_timing(dev, cfg, params, m: int, failures: list) -> dict:
    """The 8 x 1k flat ``"cuda"`` tick of a slice of ``m`` devices (1: the
    one-device gateway): eight 1,024-token prompts admitted one-shot, the
    first tick captured, the next replayed against the eager step bit for
    bit (every shard's arena), then host ms per tick captured and eager in
    turns, with a profile of the captured tick (device busy ms, launches)."""
    import numpy as np
    import torch

    from repro_torch.serve.gateway.slots import Request
    from repro_torch.serve.spec import ServeSpec, make_gateway

    rng = np.random.default_rng(17)
    spec = ServeSpec(n_slots=LM_SLOTS, max_len=LM_MAX_LEN, paged=True,
                     block_size=LM_BLOCK, chunked=False, backend="cuda",
                     max_new_tokens=NEW_TOKENS_C,
                     mesh=None if m == 1 else [[dev] * m])
    gw = make_gateway(cfg, params, spec, device=dev)
    part = gw.slices[0] if m > 1 else gw
    ad, batcher = part.adapter if m > 1 else gw.batcher.adapter, \
        part.batcher
    for i in range(LM_SLOTS):
        batcher.submit(Request(uid=i, prompt=rng.integers(
            0, cfg.vocab, 1024).astype(np.int32),
            max_new_tokens=NEW_TOKENS_C))
    batcher.step()                  # admits all eight; the tick captures
    tokens = batcher.last_token.copy()
    active = np.asarray([r is not None for r in batcher.active])
    state = arena_state(ad)
    check = tick_replay_check(ad, tokens, active, state=state)
    start = {key: a.clone() for key, a in state.items()}
    timing = tick_timing(ad, tokens, active, runs=MA_TIMING_RUNS,
                         eager_profile=False)
    for key, a in state.items():
        a.copy_(start[key])
    prof = timing["profile"]["captured"]
    if not (check["logits_bitwise"] and check["arena_bitwise"]
            and check["launches_equal"] and check["logits_finite"]) or \
            prof["graph_launches_per_tick"] != 1:
        failures.append(f"(e) width {m}: the captured tick {check}, "
                        f"{prof['graph_launches_per_tick']} graphs a tick")
    out = {"host_ms": timing["host_ms"],
           "device_busy_ms_per_tick": prof["device_busy_ms_per_tick"],
           "device_idle_share": prof["device_idle_share"],
           "paged_attn_ms_per_tick": prof["paged_attn_ms_per_tick"],
           "launches_per_tick": check["launches"],
           "host_launches_per_tick": prof["host_launches_per_tick"],
           "graph_launches_per_tick": prof["graph_launches_per_tick"]}
    del gw, part, ad, batcher, state, start
    torch.cuda.empty_cache()
    return out


def stride_kernel_checks(dev, gen, sleep: int) -> dict:
    """Kernel 5 at the split-KV fallback's shape (``MA_STRIDE``): each
    shard's sweep at ``block_stride`` = the block size and ``q0`` its first
    in-block position, against its plain version (both dtypes, window
    1,024 and none, the new row spliced in: float32 within 2e-5, bf16
    within 2e-2), the shards' merged states against the plain read of the
    whole arena, and four shards' merged by ``merge_attn_states_n`` (against
    its plain version within 2e-5 and the whole arena's read); then its
    time (bf16, no window) beside the same kernel on
    the unsplit arena at ``block_stride`` = bs, the plain version and the
    bound (each shard's rows read once)."""
    import torch

    from repro_torch.kernels import paged_attn as paged_k
    from repro_torch.kernels import ref

    s = MA_STRIDE
    B, Hq, Hkv, D, bs, m = (s[k] for k in ("B", "Hq", "Hkv", "D", "bs",
                                            "shards"))
    rows = bs // m
    nb = -(-s["hi"] // bs)
    num_blocks = B * nb + 1
    i32 = dict(dtype=torch.int32, device=dev)
    tables = (torch.randperm(num_blocks - 1, generator=gen, device=dev)
              [:B * nb] + 1).reshape(B, nb).to(torch.int32)
    lens = torch.randint(s["lo"], s["hi"] + 1, (B,), generator=gen, **i32)
    checks, err = [], 0.0
    timing = {}
    for dt in (torch.float32, torch.bfloat16):
        tol = 2e-5 if dt == torch.float32 else 2e-2
        ka, va = (torch.randn((num_blocks, bs, Hkv, D), generator=gen,
                              device=dev).to(dt) for _ in range(2))
        ka[0], va[0] = float("nan"), float("nan")   # the trash block
        q = torch.randn((B, Hq, D), generator=gen, device=dev).to(dt)
        nk = tuple(torch.randn((B, Hkv, D), generator=gen, device=dev)
                   .to(dt) for _ in range(2))
        parts = [(ka[:, d * rows:(d + 1) * rows].contiguous(),
                  va[:, d * rows:(d + 1) * rows].contiguous())
                 for d in range(m)]
        for win in (None, 1024):
            states = []
            for d, (kd, vd) in enumerate(parts):
                q0 = torch.full((B,), d * rows, **i32)
                got = paged_k.paged_decode_attention_with_state(
                    q, kd, vd, tables, lens, window=win, q0=q0, new_kv=nk,
                    block_stride=bs)
                want = ref.paged_decode_attention_with_state(
                    q, kd, vd, tables, lens, win, q0, nk, bs)
                e = max(float((g - w).abs().max()) for g, w in
                        zip((got[0], got[2]), (want[0], want[2])))
                err = max(err, e)
                checks.append({"dtype": str(dt), "window": win, "shard": d,
                               "max_abs_err": e, "ok": all(
                                   torch.allclose(g, w, rtol=tol, atol=tol)
                                   for g, w in zip(got, want))})
                states.append(got)
            whole = ref.paged_decode_attention(q, ka, va, tables, lens, win,
                                               nk)
            # the two shards' merge, and four shards' (4 rows of each
            # block) through the merge over S states against its plain
            # version
            quarters = []
            for d in range(4):
                q0 = torch.full((B,), d * bs // 4, **i32)
                quarters.append(paged_k.paged_decode_attention_with_state(
                    q, ka[:, d * bs // 4:(d + 1) * bs // 4].contiguous(),
                    va[:, d * bs // 4:(d + 1) * bs // 4].contiguous(),
                    tables, lens, window=win, q0=q0, new_kv=nk,
                    block_stride=bs))
            stacked = [torch.stack(ts) for ts in zip(*quarters)]
            merged4 = paged_k.merge_attn_states_n(*stacked)
            e = float((merged4 - ref.merge_attn_states_n(*stacked))
                      .abs().max())
            err = max(err, e)
            checks.append({"dtype": str(dt), "window": win,
                           "merge_n_vs_plain": e,
                           "ok": torch.allclose(
                               merged4, ref.merge_attn_states_n(*stacked),
                               rtol=2e-5, atol=2e-5)})
            for shards_n, merged in (
                    (m, paged_k.merge_attn_states(*states[0], *states[1])),
                    (4, merged4)):
                e = float((merged.to(dt).float() - whole.float()).abs()
                          .max())
                checks.append({"dtype": str(dt), "window": win,
                               "shards": shards_n, "merged_vs_whole": e,
                               "ok": torch.allclose(
                                   merged.to(dt).float(), whole.float(),
                                   rtol=tol, atol=tol)})
        if dt != torch.bfloat16:
            continue
        kd, vd = parts[0]
        q0 = torch.zeros((B,), **i32)

        def strided():
            return paged_k.paged_decode_attention_with_state(
                q, kd, vd, tables, lens, q0=q0, new_kv=nk, block_stride=bs)

        def contiguous():
            return paged_k.paged_decode_attention_with_state(
                q, ka, va, tables, lens, new_kv=nk)
        ms = time_ms(strided, 5, 20, sleep)
        live = int(lens.sum())
        shard_bytes = 2 * (live // m) * Hkv * D * 2 + B * Hq * D * 2 + \
            B * Hq * (D + 2) * 4 + 4 * (B * nb + 2 * B)
        timing = {
            "shape": f"q ({B}, {Hq}, {D}) bf16, {m} shards of {rows} rows "
                     f"of each {bs}-position block, tables ({B}, {nb}), "
                     f"lens {s['lo']}-{s['hi']}, splice on",
            "splits": paged_k.cascade_split_plan(B, Hkv, nb, rows)[0],
            "ms": ms[0], "back_to_back_ms": ms[1],
            "block_stride_bs_ms": time_ms(contiguous, 5, 20, sleep,
                                          b2b=False)[0],
            "plain_ms": time_ms(lambda: ref.paged_decode_attention_with_state(
                q, kd, vd, tables, lens, None, q0, nk, bs), 3, 3, sleep,
                b2b=False)[0],
            "bytes_ms": shard_bytes / PEAK_BYTES_PER_S * 1e3,
            "ops_ms": 4 * B * Hq * (live // B // m) * D / F32_FLOPS * 1e3}
        timing["bound_ms"] = max(timing["bytes_ms"], timing["ops_ms"])
        timing["bound_by"] = "bytes" if timing["bytes_ms"] >= \
            timing["ops_ms"] else "operations"
    bad = [c for c in checks if not c["ok"]]
    return {"checks": len(checks), "failed": bad, "max_abs_err": err,
            "timing": timing}


def model_axis_main_path(dev, sleep: int, cfg=None, params=None,
                         base: dict | None = None) -> dict:
    """Phase 20: sharded serving's model axis (slices of 2 and 4 devices,
    each ``cuda:0`` on one H100), ``model_axis_main_path`` line.  (a)
    stablelm-3b whole in bf16 (phase 5's weights, or drawn the same way
    when run alone; ``base`` holds phase 18's one-device runs of loads (b)
    and (c), else they run here): a model-2 slice serves load (b) through
    the fold and the ``"cuda"`` tick and load (c) through the cascade
    tick, a model-4 slice load (c), each against the one-device gateway
    under the near-tie rule; at depth 4 in float32 both widths serve both
    loads against the one-device gateway of the same spec, tokens equal,
    logits within 1e-5 and every kernel's launches those of
    :func:`expected_launches`.  (b) The split-KV fallback: hymba-1.5b cut
    to 4 layers (layer 0 global, window 1,024 on 1-3) at model 2 (5 KV
    heads: each shard 8 rows of every 16-position block) on load (c)
    through the ``"cuda"`` and cascade ticks, the same float32 gates; and
    kernel 5 at its shape (:func:`stride_kernel_checks`); at model 4
    through the ``"cuda"`` tick (four shards of 4 rows, the merge over
    four states).  (c) A lane
    migrated mid-decode from a one-device slice to a two-device one and on
    to another one-device slice, float32 at depth 4, against its stay-put
    run.  (d) One prefill slice of two devices and two decode slices of
    one on load (b) (bf16), against the one-device gateway.  (e) Per width
    1, 2, 4: the captured 8 x 1k tick (:func:`ma_tick_timing`).  Returns
    the model-axis runs' launches; raises SystemExit on a failed check."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.launch.mesh import make_disagg_meshes
    from repro_torch.models import lm
    from repro_torch.serve.gateway.slots import make_adapter
    from repro_torch.serve.shard import RolePlan, build_slices, migrate_slot

    sw = Stopwatch()
    if cfg is None:
        cfg = configs.config("stablelm-3b")
        params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
        sw.lap("init")
    load_b, _ = load_b_prompts(cfg.vocab)
    load_c, _ = load_c_prompts(cfg.vocab)
    failures: list[str] = []
    launches: dict = {}
    runs: dict = {}

    def sharded(name, run):
        runs[name] = run
        add_launches(launches, run["launches"])
        return run

    # (a) stablelm-3b whole, bf16; then float32 at depth 4
    base = base or {}
    flat_b = base.get("flat_b") or shard_load(
        dev, cfg, params, load_b, shard_spec(), stagger=True)
    flat_c = base.get("flat_c") or shard_load(
        dev, cfg, params, load_c, shard_spec(chunked=False))
    sw.lap("a_baselines")
    a = {}
    for m, load, prompts, one, kw in (
            (2, "b", load_b, flat_b, dict(stagger=True)),
            (2, "c", load_c, flat_c, {}),
            (4, "c", load_c, flat_c, {})):
        spec = shard_spec(mesh=[[dev] * m], chunked=load == "b",
                          backend="cuda" if load == "b" else "cascade")
        run = sharded(f"bf16_m{m}_{load}",
                      shard_load(dev, cfg, params, prompts, spec, **kw))
        a[f"bf16_m{m}_{load}"] = ma_compare(
            f"(a) bf16 model {m} load ({load})", one, run, m, False, False,
            failures, SHARD_PATH if load == "b" else MA_CASCADE_PATH)
    sw.lap("a_bf16")
    cfg4 = strict_cfg(cfg)
    params4 = lm.init(cfg4, torch.Generator(device=dev).manual_seed(1))
    for load, prompts, backend in (("b", load_b, "cuda"),
                                   ("c", load_c, "cascade")):
        chunked = load == "b"
        one = shard_load(dev, cfg4, params4, prompts, shard_spec(
            chunked=chunked, backend=backend), stagger=chunked)
        for m in MA_WIDTHS:
            run = sharded(f"f32_m{m}_{load}", shard_load(
                dev, cfg4, params4, prompts, shard_spec(
                    mesh=[[dev] * m], chunked=chunked, backend=backend),
                stagger=chunked))
            a[f"f32_m{m}_{load}"] = ma_compare(
                f"(a) float32 model {m} load ({load})", one, run, m, True,
                False, failures)
    sw.lap("a_f32")

    # (c) a migration 1 -> 2 -> 1 devices mid-decode, float32 at depth 4
    kw = dict(n_slots=LM_SLOTS, max_len=LM_MAX_LEN, block_size=LM_BLOCK,
              num_blocks=SHARD_MIGRATE_BLOCKS, chunked=False)
    rng = np.random.default_rng(29)
    forced = rng.integers(0, cfg4.vocab, (8, LM_SLOTS)).astype(np.int32)
    lane = np.zeros(LM_SLOTS, bool)
    lane[0] = True
    stay = make_adapter(cfg4, params4, paged=True, **kw)
    stay.insert(0, load_b[0], SHARD_NEW_TOKENS)
    want = []
    for t in range(8):
        want.append((stay.decode(forced[t], lane)[0],
                     stay.last_logits[0].clone()))
    del stay
    A, B, C = (sl.adapter for sl in build_slices(
        cfg4, params4, [[dev], [dev, dev], [dev]], **kw))
    reset_counts()
    A.insert(0, load_b[0], SHARD_NEW_TOKENS)
    got, receipts = [], []
    for t, ad in enumerate([A] * 4 + [B] * 2 + [C] * 2):
        if t in (4, 6):
            src = A if t == 4 else B
            receipts.append(dataclasses.asdict(
                migrate_slot(src, 0, ad, 0, load_b[0])))
        got.append((ad.decode(forced[t], lane)[0],
                    ad.last_logits[0].clone()))
    torch.cuda.synchronize()
    mig_launches = read_counts()
    runs["migration"] = {"launches": mig_launches}
    add_launches(launches, mig_launches)
    dl = max(float((x[1] - y[1]).abs().max()) for x, y in zip(got, want))
    block_bytes = A._token_bytes * LM_BLOCK
    c = {"tokens_equal": [int(x[0]) for x in got] ==
         [int(y[0]) for y in want], "max_abs_dlogit": dl,
         "receipts": receipts, "two_device_slice_heads":
             [sh.heads for sh in B.shards],
         "sources_released": not A.slot_bids[0] and not B.slot_bids[0]}
    n0 = len(load_b[0])
    if not (c["tokens_equal"] and dl <= MA_F32_TOL and
            c["sources_released"] and [r["bytes_moved"] for r in receipts]
            == [-(-(n0 + 4) // LM_BLOCK) * block_bytes + 4,
                -(-(n0 + 6) // LM_BLOCK) * block_bytes + 4]):
        failures.append(f"(c) migration across widths: {c}")
    del A, B, C, params4
    torch.cuda.empty_cache()
    sw.lap("c_migration")

    # (d) a prefill slice of two devices, two decode slices of one
    pre, dec = make_disagg_meshes(1, 2, prefill_model=2, device=dev)
    disagg = sharded("disagg_b", shard_load(
        dev, cfg, params, load_b,
        shard_spec(mesh=pre + dec, roles=RolePlan.split(1, 2)),
        stagger=True))
    d = ma_compare("(d) disaggregated", flat_b, disagg, 1, False, False,
                   failures, SHARD_PATH)
    d.update(handoffs=disagg["handoffs"],
             handoff_bytes=disagg["handoff_bytes"],
             flash_vs_one_device=[disagg["launches"]["flash_attention"],
                                  flat_b["launches"]["flash_attention"]])
    if disagg["handoffs"] != len(load_b) or \
            disagg["launches"]["flash_attention"] != \
            2 * flat_b["launches"]["flash_attention"]:
        failures.append(f"(d) handoffs {disagg['handoffs']}, flash "
                        f"launches {d['flash_vs_one_device']} (one per "
                        "prefill shard and layer expected)")
    sw.lap("d_disaggregated")

    # (e) the captured 8 x 1k tick per width
    e = {f"width_{m}": ma_tick_timing(dev, cfg, params, m, failures)
         for m in (1,) + MA_WIDTHS}
    sw.lap("e_tick_timing")

    # (b) the split-KV fallback: hymba-1.5b, 4 layers, model 2, float32
    gen = torch.Generator(device=dev).manual_seed(23)
    stride = stride_kernel_checks(dev, gen, sleep)
    if stride["failed"]:
        failures.append(f"(b) kernel 5 at the block stride: "
                        f"{stride['failed']}")
    cfgh = dataclasses.replace(configs.config(HYMBA_ARCH),
                               n_layers=MA_HYMBA_DEPTH,
                               param_dtype="float32")
    paramsh = lm.init(cfgh, torch.Generator(device=dev).manual_seed(2))
    load_ch, _ = load_c_prompts(cfgh.vocab)
    b, ones = {}, {}
    for backend, m in (("cuda", 2), ("cascade", 2), ("cuda", 4)):
        spec = dict(chunked=True, backend=backend)
        if backend not in ones:
            ones[backend] = shard_load(dev, cfgh, paramsh, load_ch,
                                       shard_spec(**spec))
        name = f"fallback_m{m}_{backend}"
        run = sharded(name, shard_load(
            dev, cfgh, paramsh, load_ch,
            shard_spec(mesh=[[dev] * m], **spec)))
        b[name] = ma_compare(f"(b) {name}", ones[backend], run, m, True,
                             True, failures)
    del paramsh
    torch.cuda.empty_cache()
    sw.lap("b_fallback")

    emit({"phase": "model_axis_main_path",
          "gpu": nvidia_smi("name,power.limit"), "widths": MA_WIDTHS,
          "a_stablelm": a, "b_fallback": {
              "model": f"{HYMBA_ARCH} at {MA_HYMBA_DEPTH} layers, model 2",
              "runs": b, "kernel5_stride": stride},
          "c_migration": c, "d_disaggregated": d, "e_tick_by_width": e,
          "launches": launches,
          "launches_by_run": {name: {k: r["launches"].get(k, 0)
                                     for k in MA_KEYS}
                              for name, r in runs.items()},
          "failures": failures, **sw.fields()})
    if failures:
        raise SystemExit(f"phase 20: {failures}")
    return launches


def model_axis_main(dev, sleep: int) -> dict:
    """``--model-axis``: phase 20 alone."""
    return model_axis_main_path(dev, sleep)


def analytic_tick(cfg, model_bytes: int, context: int | None) -> dict:
    """Check (f): the cost model's decode tick (``serve/obs/costmodel.py``,
    its counts from the shapes) for the tick a phase's byte model
    describes, ``LM_SLOTS`` lanes at ``context`` positions each (None: the
    rwkv family's state slots), beside that model and their gap."""
    from repro_torch.serve.obs import costmodel
    contexts = [] if context is None else [context] * LM_SLOTS
    fn, args = costmodel.lm_stage(cfg, costmodel.tick_work(cfg, LM_SLOTS,
                                                            contexts))
    cost = fn(*args)
    return {"flops": cost["flops"], "bytes": cost["bytes"],
            "model_bytes": model_bytes,
            "gap": cost["bytes"] / model_bytes - 1.0}


def obs_main() -> int:
    """``--obs``: the card's line, every kernel's build and phase 14 alone,
    on stablelm-3b's random weights (seeded, as phase 5 draws them)."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(nvidia_smi("name,power.limit"), flush=True)
    t0 = time.perf_counter()
    build.build_all(SOURCES)
    emit({"build_s": time.perf_counter() - t0})
    dev = torch.device("cuda")
    cfg = configs.config("stablelm-3b")
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    emit({"launches_by_path": {"obs": obs_main_path(dev, cfg, params)}})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def stack_frames(source: str) -> dict[str, int]:
    """Bytes of stack frame ``ptxas`` reports for each function of
    ``csrc/<source>.cu``, by mangled name."""
    from repro_torch.kernels import build
    log = build.library_path(source).with_suffix(".log").read_text()
    out, fn = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            fn = ln.split("Function properties for")[1].strip()
        elif fn and "bytes stack frame" in ln:
            out[fn] = int(ln.split("bytes stack frame")[0].split()[-1])
            fn = None
    return out


def b1_mma_peak(dev, sleep_cycles: int) -> dict:
    """The card's b1 AND-POPC rate: ``csrc/sc_dot.cu``'s probe, 8 independent
    m16n8k256 products per warp and round, no loads, 4 CTAs of 256 threads
    per SM, CUDA events around 5 launches (median of 5)."""
    import ctypes
    import torch
    from repro_torch.kernels import build
    fn = build.load("sc_dot").sc_dot_b1_peak_launch
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ctas, threads, iters = 4 * sms, 256, 4096
    out = torch.empty(ctas * threads, dtype=torch.int32, device=dev)

    def launch():
        err = fn(out.data_ptr(), ctas, threads, iters,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"b1 peak probe failed: CUDA error {err}")
    ms, _ = time_ms(launch, 5, 5, sleep_cycles, b2b=False)
    mmas = ctas * threads // 32 * iters * 8
    per_s = mmas / (ms * 1e-3)
    # an m16n8k256 product: 16 x 8 x 256 ANDs and as many adds
    return {"mma_per_s": per_s, "ms": ms, "mmas": mmas,
            "and_popc_tops": per_s * 2 * 16 * 8 * 256 / 1e12}


def stream_words(gen, shape, N: int):
    """Random packed streams of ``N`` bits: words with the bits at and
    above N zero."""
    import torch
    w = torch.randint(-2**31, 2**31, shape, generator=gen, dtype=torch.int64,
                      device=gen.device)
    if N < 32:
        w &= (1 << N) - 1
    return w.to(torch.int32)


def sc_bounds(kernel: str, M: int, K: int, O: int, N: int, clk_sm: float,
              mma_per_s: float | None) -> dict:
    """The least time of the function at these shapes on this card (the
    larger of bytes / 3.35 TB/s and operations / peak), and the first
    port's bound beside it.  sng_pack: one table of (N + 1) x N compares,
    then 4 bytes in and N / 8 bytes out per level (the first port counted
    M x K x N compares).  sc_dot: each (window, output) needs a count per
    pair of leaves at N <= 16 (the TFF tree's first level takes only the
    pair's sum; zero leaves need none) and a count per leaf and 256 bits
    above.  Where the b1 tensor cores' measured rate ``mma_per_s`` is
    given, the fastest unit that makes these counts is one m16n8k256
    AND-POPC: 16 x 8 counts of up to 256 bits each (a pair of 16-bit
    streams fits one k256 row).  Without it the counts are ``__popc`` at
    16 per clock per SM (``popc_bound_ms``).  The first port counted M x Kp x O x Wd popcounts."""
    import math
    Wd = max(1, N // 32)
    if kernel == "sng_pack":
        n = M * K
        bytes_ms = (4 * n + 4 * N + 4 * n * Wd) / PEAK_BYTES_PER_S * 1e3
        ops_ms = (N + 1) * N / (INT32_PER_CLK_SM * clk_sm) * 1e3
        old = max(bytes_ms, n * N / (INT32_PER_CLK_SM * clk_sm) * 1e3)
        extra = {}
    else:
        bytes_ms = 4 * (M * K * Wd + K * O * Wd + M * O) \
            / PEAK_BYTES_PER_S * 1e3
        counts = M * O * (math.ceil(K / 2) if N <= 16 else K)
        popc_ms = M * O * (math.ceil(K / 2) if N <= 16 else K * Wd) \
            / (POPC_PER_CLK_SM * clk_sm) * 1e3
        ops_ms = popc_ms
        if mma_per_s:
            per_k = math.ceil(K / 2) if N <= 16 else K * math.ceil(N / 256)
            ops_ms = math.ceil(M / 16) * math.ceil(O / 8) * per_k \
                / mma_per_s * 1e3
        kp = 1 << max(1, (K - 1).bit_length())
        old = max(bytes_ms, M * kp * O * Wd / (POPC_PER_CLK_SM * clk_sm) * 1e3)
        extra = {"counts": counts, "popc_bound_ms": max(bytes_ms, popc_ms)}
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "first_bound_ms": old,
            **extra}


def sc_timing(dev, sleep: int, clk_sm: float) -> dict:
    """``sng_pack`` and ``sc_dot`` at the main path's shapes (``SC_TIMING``)
    for the checkout whose ``repro_torch`` is imported (this one, or a
    parent's under ``--sc-timing``): ms (the kernel alone), back-to-back ms,
    the host's issue µs per call and the bounds.  The redesigned ``sc_dot``
    is timed on both routes at N = 256; the parent's takes K = 25 through
    ``ops.sc_dot``, which pads K to 32 first.  Both are also timed through
    ``ops.sc_dot_posneg`` with two banks of O / 2, as the SC layer calls it
    (the redesign takes them as one operand; the parent pads X and both
    banks and concatenates the banks).  The popcount route at N = 256 is
    forced by patching ``MMA_MAX_LEAVES`` to 0."""
    import inspect
    import torch
    from repro_torch.core import sng
    from repro_torch.kernels import ops
    from repro_torch.kernels import sc_dot as sc_dot_k
    from repro_torch.kernels import sng_pack as sng_pack_k
    gen = torch.Generator(device=dev).manual_seed(1)
    redesigned = "length" in inspect.signature(sc_dot_k.sc_dot).parameters
    peak = b1_mma_peak(dev, sleep) if redesigned else None
    if peak:
        emit({"b1_mma_peak": peak})
    once = {"call": contextlib.nullcontext}
    rows = []
    for bits in (4, 8):
        N = 1 << bits
        Wd = max(1, N // 32)
        codes = sng.codes_tensors("ramp_lowdisc", bits, dev)[0]
        lv = torch.randint(0, N + 1, (SC_M, SC_K), generator=gen,
                           dtype=torch.int32, device=dev)
        fn = functools.partial(sng_pack_k.sng_pack, lv, codes, N)
        ms, b2b = time_ms(fn, 5, 20, sleep)
        rows.append({"kernel": "sng_pack", "bits": bits,
                     "shape": f"levels ({SC_M}, {SC_K}), N={N}", "ms": ms,
                     "back_to_back_ms": b2b,
                     "issue_us": issue_us(fn, once, sleep)["call"],
                     **sc_bounds("sng_pack", SC_M, SC_K, 0, N, clk_sm,
                                 None)})
        for b, O, K in SC_TIMING:
            if b != bits:
                continue
            x = stream_words(gen, (SC_M, K, Wd), N)
            w = stream_words(gen, (K, O, Wd), N)
            if redesigned:
                calls = {route: functools.partial(
                    sc_dot_k.sc_dot, x, w, "alt", "tff", length=N)
                    for route in (("mma", "popc") if Wd == 8 else ("popc",))}
                calls["posneg"] = functools.partial(
                    ops.sc_dot_posneg, x, w, length=N)
            else:
                wp = w[:, :O // 2].contiguous()
                wn = w[:, O // 2:].contiguous()
                calls = {("kernel" if K & (K - 1) == 0 else "ops"):
                         functools.partial(ops.sc_dot, x, w),
                         "posneg": functools.partial(ops.sc_dot_posneg, x,
                                                     wp, wn)}
            for route, fn in calls.items():
                patch = mock.patch.object(sc_dot_k, "MMA_MAX_LEAVES", 0) \
                    if redesigned and route == "popc" \
                    else contextlib.nullcontext()
                with patch:
                    ms, b2b = time_ms(fn, 5, 20, sleep)
                    issue = issue_us(fn, once, sleep)["call"]
                rows.append({
                    "kernel": "sc_dot", "bits": bits, "O": O, "K": K,
                    "route": route, "shape": f"x ({SC_M}, {K}, {Wd}), "
                    f"w ({K}, {O}, {Wd})", "ms": ms, "back_to_back_ms": b2b,
                    "issue_us": issue,
                    **sc_bounds("sc_dot", SC_M, K, O, N, clk_sm,
                                peak and peak["mma_per_s"])})
    return {"redesigned": redesigned, "rows": rows,
            "b1_mma_per_s": peak and peak["mma_per_s"]}


def sc_kernel_checks(dev, gen) -> tuple[dict, list]:
    """``sng_pack`` and ``sc_dot`` held bit for bit against their plain
    versions on the card: every precision N = 4..256 and lengths 5, 100;
    the ramp, LFSR and two-LFSR codes; levels outside [0, N] (-1, N + 1,
    the int32 extremes); levels off 16-byte alignment (the level-by-level
    kernel); ``sc_dot`` at K = 1, 2, 3, 25, 32, 33, 64, 1,000, 1,024, O =
    1, 16, 33, 37, 64, 200, Wd = 1 .. 8, M not a multiple of any tile, every
    s0 mode and both adders, packed streams of N = 4, 8, 16 bits (leaves
    paired per popcount), both routes at N = 256 (the popcounts forced by
    patching ``MMA_MAX_LEAVES`` to 0), and the two weight banks of
    ``ops.sc_dot_posneg``; then past one tree of 1,024 leaves
    (``SC_BIG_K``: subtrees and their fold), every s0 mode and both adders
    at Wd 1 (packed 16-bit streams and full words) and Wd 8, alone and as
    two banks in one operand."""
    import torch
    from repro_torch.core import sng
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sc_dot as sc_dot_k
    from repro_torch.kernels import sng_pack as sng_pack_k
    err = {"sng_pack": 0, "sc_dot": 0}
    checks = []
    for N in (4, 8, 16, 32, 64, 128, 256, 5, 100):
        bits = max(2, (N - 1).bit_length())
        for scheme in ("ramp_lowdisc", "lfsr_shared", "lfsr_pair"):
            for codes in sng.codes_tensors(scheme, bits, dev):
                codes = codes[:N].contiguous()
                lv = torch.randint(-3, N + 4, (3001, 25), generator=gen,
                                   dtype=torch.int32, device=dev)
                lv.view(-1)[:4] = torch.tensor(
                    [-1, N + 1, -2**31, 2**31 - 1], dtype=torch.int32)
                for levels in (lv, lv.view(-1)[1:]):
                    got = sng_pack_k.sng_pack(levels, codes, N)
                    want = ref.sng_pack(levels, codes, N)
                    torch.cuda.synchronize()
                    ok = torch.equal(got, want)
                    err["sng_pack"] = max(err["sng_pack"], int(
                        (got.long() - want.long()).abs().max()))
                    checks.append({"kernel": "sng_pack", "N": N,
                                   "scheme": scheme, "n": levels.numel(),
                                   "bitwise": ok})
    modes = ("zero", "one", "alt", "ideal")
    cases = [(1000, K, 37, Wd, mode, None, 0)
             for K in (2, 32, 64) for Wd in (1, 8) for mode in modes]
    cases += [(517, K, 37, Wd, mode, None, 0) for K in (1, 3, 25, 1000)
              for Wd in (1, 2, 3, 8) for mode in modes]
    cases += [(300, K, 16, 1, mode, N, 0) for N in (4, 8, 16)
              for K in (1, 3, 25, 33, 1000) for mode in modes]
    cases += [(1001, 25, O, Wd, "alt", N, 0) for O in (1, 16, 33, 64, 200)
              for Wd, N in ((1, 16), (5, 160), (8, 256))]
    cases += [(129, 1024, 40, 8, "alt", None, 0), (77, 25, 40, 4, "one", 128, 0),
              (SC_M, 32, 64, 1, "alt", None, 0),
              (SC_M, 32, 64, 8, "alt", None, 0)]
    # the main path's calls: two banks of O / 2, K = 25, packed streams
    cases += [(SC_M, SC_K, O, Wd, "alt", N, O // 2) for O in (64, 16)
              for Wd, N in ((1, 16), (8, 256))]
    for M, K, O, Wd, mode, N, split in cases:
        x = stream_words(gen, (M, K, Wd), N or 32)
        w = stream_words(gen, (K, O, Wd), N or 32)
        s0, adder = ("alt", "ideal") if mode == "ideal" else (mode, "tff")
        want = ref.sc_dot(x, w, s0, adder)
        for mma in ((True, False) if Wd == 8 else (True,)):
            patch = contextlib.nullcontext() if mma else \
                mock.patch.object(sc_dot_k, "MMA_MAX_LEAVES", 0)
            with patch:
                if split:
                    got = torch.cat(ops.sc_dot_posneg(
                        x, w, s0_mode=s0, adder=adder, length=N), dim=1)
                else:
                    got = sc_dot_k.sc_dot(x, w, s0, adder, length=N)
            torch.cuda.synchronize()
            ok = torch.equal(got, want)
            err["sc_dot"] = max(err["sc_dot"], int((got - want).abs().max()))
            checks.append({"kernel": "sc_dot", "M": M, "K": K, "O": O,
                           "Wd": Wd, "mode": mode, "length": N,
                           "banks": 2 if split else 1,
                           "route": "mma" if mma and Wd == 8 else "popc",
                           "bitwise": ok})
    # K past 1,024 leaves: the subtrees' pass and the fold (popcounts)
    for K in SC_BIG_K:
        for Wd, N in ((1, 16), (1, None), (8, 256)):
            for mode in modes:
                for split in (0, 12):
                    x = stream_words(gen, (67, K, Wd), N or 32)
                    w = stream_words(gen, (K, 24, Wd), N or 32)
                    s0, adder = ("alt", "ideal") if mode == "ideal" else \
                        (mode, "tff")
                    want = ref.sc_dot(x, w, s0, adder)
                    got = torch.cat(ops.sc_dot_posneg(
                        x, w, s0_mode=s0, adder=adder, length=N), dim=1) \
                        if split else sc_dot_k.sc_dot(x, w, s0, adder,
                                                      length=N)
                    torch.cuda.synchronize()
                    ok = torch.equal(got, want)
                    err["sc_dot"] = max(err["sc_dot"],
                                        int((got - want).abs().max()))
                    checks.append({"kernel": "sc_dot", "M": 67, "K": K,
                                   "O": 24, "Wd": Wd, "mode": mode,
                                   "length": N, "banks": 2 if split else 1,
                                   "route": "popc", "subtrees":
                                   sc_dot_k.subtrees(K), "bitwise": ok})
    return err, checks


def sc_frontend_timing(dev, sleep: int, clk_sm: float,
                       mma_per_s: float) -> list[dict]:
    """The SC kernels at the shapes of the SC LM frontend on a stablelm-3b
    prompt of ``FRONTEND_M`` tokens at bits 4: ``sng_pack`` of the
    prompt's levels (M, 2,560) and of both weight banks (2,560, 2 x 2,560),
    and ``sc_dot_posneg`` at K = 2,560 with the banks as one operand (three
    subtrees of leaves and their fold); ms, back-to-back ms, the host's
    issue µs, the plain versions' ms on the same tensors and the bounds
    (no single PyTorch call computes either function: ``library_ms``
    null)."""
    import torch
    from repro_torch.core import sng
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sng_pack as sng_pack_k
    gen = torch.Generator(device=dev).manual_seed(5)
    N, d, M = 16, FRONTEND_D, FRONTEND_M
    codes_a, codes_b = sng.codes_tensors("ramp_lowdisc", 4, dev)
    once = {"call": contextlib.nullcontext}
    rows = []
    for name, shape, codes in (("levels", (M, d), codes_a),
                               ("banks", (d, 2 * d), codes_b)):
        lv = torch.randint(0, N + 1, shape, generator=gen, dtype=torch.int32,
                           device=dev)
        fn = functools.partial(sng_pack_k.sng_pack, lv, codes, N)
        ms, b2b = time_ms(fn, 5, 10, sleep)
        plain = time_ms(lambda: ref.sng_pack(lv, codes, N), 3, 2, sleep,
                        b2b=False)[0]
        rows.append({"kernel": "sng_pack", "bits": 4, "operand": name,
                     "shape": f"levels {shape}, N={N}", "ms": ms,
                     "back_to_back_ms": b2b,
                     "issue_us": issue_us(fn, once, sleep)["call"],
                     "plain_ms": plain, "library_ms": None,
                     **sc_bounds("sng_pack", shape[0], shape[1], 0, N,
                                 clk_sm, None)})
    x = stream_words(gen, (M, d, 1), N)
    w = stream_words(gen, (d, 2 * d, 1), N)
    fn = functools.partial(ops.sc_dot_posneg, x, w, length=N)
    ms, b2b = time_ms(fn, 5, 5, sleep)
    plain = time_ms(lambda: ref.sc_dot(x, w, "alt", "tff"), 3, 1, sleep,
                    b2b=False)[0]
    rows.append({"kernel": "sc_dot", "bits": 4, "K": d, "O": 2 * d,
                 "route": "posneg", "shape": f"x ({M}, {d}, 1), "
                 f"w ({d}, {2 * d}, 1)", "ms": ms, "back_to_back_ms": b2b,
                 "issue_us": issue_us(fn, once, sleep)["call"],
                 "plain_ms": plain, "library_ms": None,
                 **sc_bounds("sc_dot", M, d, 2 * d, N, clk_sm, mma_per_s)})
    return rows


# runs a side of a captured-against-eager host-clock comparison, each the
# median of HOST_REPS calls; the sides take turns, each run starting with
# the other side than the run before, since the host clock drifts within a
# call (PERF.md); 3 runs since phase 17 joined (9 before phase 13, then
# 5), so that the script stays under 900 s
HOST_RUNS, HOST_REPS = 3, 5


def turns(sides: dict, runs: int = HOST_RUNS, reps: int = HOST_REPS
          ) -> dict:
    """Host ms of each of ``sides`` (name -> a call ending in a
    synchronize) over ``runs`` runs a side in turns: each run's median of
    ``reps`` calls, then the median, least and most of the runs."""
    times = {name: [] for name in sides}
    order = list(sides)
    for r in range(runs):
        for name in (order if r % 2 == 0 else order[::-1]):
            times[name].append(host_ms(sides[name], reps=reps))
    return {name: {"median": statistics.median(t), "min": min(t),
                   "max": max(t), "runs": t} for name, t in times.items()}


def frame_replay_check(gw, frames) -> dict:
    """The bucket of ``frames`` (a numpy batch) through ``gw``'s captured
    stages and through their ``fn`` eagerly on the same static inputs:
    payload and logits bit for bit, launch counts equal.  Returns the
    checks and the replayed payload (``payload``)."""
    import torch
    bs = frames.shape[0]
    sensor, gate = gw._sensor_fns[bs], gw._gateway_fns[bs]
    reset_counts()
    payload = sensor(frames).clone()
    logits = gate(payload).clone()
    torch.cuda.synchronize()
    replayed = read_counts()
    reset_counts()
    payload_e = sensor.fn(*sensor.load(frames))
    logits_e = gate.fn(*gate.load(payload_e))
    torch.cuda.synchronize()
    eager = read_counts()
    return {"bucket": bs,
            "payload_bitwise": bool(torch.equal(payload, payload_e)),
            "logits_bitwise": bool(torch.equal(logits, logits_e)),
            "launches_equal": replayed == eager,
            "launches": {k: v for k, v in replayed.items() if v},
            "payload": payload}


def frame_stage_turns(gw, frames) -> dict:
    """Host ms of each stage of the bucket of ``frames`` (a numpy batch),
    captured and eager in turns (:func:`turns`); the gateway stage from the
    sensor stage's payload on the card."""
    bs = frames.shape[0]
    sensor, gate = gw._sensor_fns[bs], gw._gateway_fns[bs]
    payload = sensor(frames).clone()
    return {
        "sensor": turns({"captured": lambda: sensor(frames),
                         "eager": lambda: sensor.fn(*sensor.load(frames))}),
        "gateway": turns({"captured": lambda: gate(payload),
                          "eager": lambda: gate.fn(*gate.load(payload))})}


def profile_stages(stage, n: int) -> dict:
    """``torch.profiler`` over ``n`` calls of ``stage`` (a frame-path stage,
    or phase 9's retraining step or caching batch; each call is timed
    ending in a synchronize): device busy ms per stage, the idle share of
    the stage's host time (timed without the profiler), device ms by
    kernel, the device operations (kernels, copies) per stage and the
    host's kernel and graph launches per stage."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    stage_ms = host_ms(stage, reps=n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            stage()
        torch.cuda.synchronize()
    dev_us = kernel_us(prof, n)
    ops = sum(1 for ev in prof.events()
              if ev.device_type == DeviceType.CUDA and
              not getattr(ev, "is_user_annotation", False)) / n
    busy = sum(dev_us.values()) / 1e3
    return {"stage_ms": stage_ms,
            **host_launches(prof.key_averages(), n, "stage"),
            "device_busy_ms_per_stage": busy if dev_us else None,
            "device_idle_share": max(0.0, 1 - busy / stage_ms)
            if dev_us else None,
            "device_ops_per_stage": ops,
            "device_ms_by_kernel": top_ms(dev_us, 10)}


# -- the retraining pipeline, Table 3 (phase 9) --------------------------------

# the paper's Table 3 misclassification (%), bits -> (binary, old SC, this
# work), as benchmarks/table3_accuracy.py quotes it
PAPER_MISCLASS = {
    8: (0.89, 2.22, 0.94), 7: (0.86, 3.91, 0.99), 6: (0.89, 1.30, 1.04),
    5: (0.74, 1.55, 1.12), 4: (0.79, 1.63, 1.04), 3: (0.79, 2.71, 2.20),
    2: (1.30, 4.89, 43.82),
}
# the reference's Table 3 protocols (benchmarks/table3_accuracy.py): images,
# float pretraining steps at batch 64, retraining steps at batch 128 on the
# first n_retrain training images' features, the precisions; old SC at
# bits <= 4 in the fast mode
TABLE3_FAST = dict(n_train=3000, n_test=800, steps=250, retrain_steps=150,
                   n_retrain=2500, bits=(2, 4, 8), old_sc_max_bits=4)
TABLE3_FULL = dict(n_train=8000, n_test=2000, steps=600, retrain_steps=400,
                   n_retrain=6000, bits=tuple(range(2, 9)), old_sc_max_bits=8)
CACHE_BATCH = 64                # cache_first_layer's batch
# the features checked bit for bit against the plain versions on the card
# and, for 32 of them, against the CPU
FEATURE_CHECK_IMAGES, CPU_CHECK_IMAGES = 256, 32
# a design whose error before retraining is above RETRAIN_LARGE_ERR must
# end at least RETRAIN_MIN_DROP lower (fractions of the test set)
RETRAIN_LARGE_ERR, RETRAIN_MIN_DROP = 0.05, 0.03


def table3_designs(bits: int, old_sc_max_bits: int) -> dict:
    """The reference's three designs at ``bits``: binary (k-bit weights),
    new SC (ramp + low-discrepancy SNGs, TFF tree) and old SC (LFSR-pair
    SNGs, MUX tree, the stream route)."""
    from repro_torch.core import hybrid
    from repro_torch.core.sc_layer import SCConfig
    out = {"binary": hybrid.HybridConfig(mode="binary", bits=bits),
           "new_sc": hybrid.HybridConfig(mode="sc", sc=SCConfig(
               bits=bits, adder="tff"))}
    if bits <= old_sc_max_bits:
        out["old_sc"] = hybrid.HybridConfig(mode="sc", sc=SCConfig(
            bits=bits, scheme="lfsr_pair", adder="mux"), sc_impl="streams")
    return out


def retrain_main_path(dev, protocol: dict, cfg=None) -> dict:
    """Phase 9: the reference's Table 3 protocol through the port's
    ``core/hybrid.py`` at full-width LeNet-5: float pretraining, then for
    each precision and design the first layer's features cached (2,500
    training and every test image in the fast protocol), the tail retrained
    and the design evaluated from its cache.  The SC launches are read
    around the whole run (the path's own), per design as deltas.  Then,
    outside the counted run: every SC design's features on 256 images bit
    for bit against the plain versions on the same CUDA tensors, and on 32
    against the CPU; the reference test's thresholds; profiles.  Prints
    the ``table3`` line and returns the path's launch counts."""
    import numpy as np
    import torch
    from repro_torch.core import hybrid
    from repro_torch.data import mnist_synth
    from repro_torch.kernels import ref
    from repro_torch.kernels import sc_dot as sc_dot_k
    from repro_torch.kernels import sng_pack as sng_pack_k
    from repro_torch import configs
    from repro_torch.models import lenet
    from repro_torch.train import optim
    sc_kernels = ("sng_pack", "sc_dot")
    p = protocol
    cfg = cfg or configs.config("lenet5")
    t_phase = time.perf_counter()
    xtr, ytr, xte, yte = mnist_synth.dataset(p["n_train"], p["n_test"])
    data_s = time.perf_counter() - t_phase
    n_cache = p["n_retrain"], p["n_test"]
    batches = sum(-(-n // CACHE_BATCH) for n in n_cache)

    # -- the main path, counted ------------------------------------------
    reset_counts()
    params = lenet.init(0, cfg, device=dev)
    opt_cfg = optim.AdamWConfig(lr=1e-3)
    opt = optim.init(params, opt_cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.as_tensor(xtr).to(dev)
    labels = torch.as_tensor(ytr).to(dev)
    idx = torch.as_tensor(mnist_synth.batch_indices(len(xtr), 64, 0,
                                                    p["steps"]), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(p["steps"]):
        params, opt, loss = hybrid.float_train_step(
            params, opt, images[idx[step]].to(torch.float32) / 255.0,
            labels[idx[step]], gen, cfg, opt_cfg)
    torch.cuda.synchronize()
    pretrain_ms = (time.perf_counter() - t0) * 1e3 / p["steps"]
    float_acc = hybrid.evaluate(params, xte, yte, cfg,
                                hybrid.HybridConfig(mode="float"))
    rows, feats = {}, {}
    for bits in p["bits"]:
        for name, h in table3_designs(bits, p["old_sc_max_bits"]).items():
            key = f"{name}_{bits}"
            before_counts = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ftr = hybrid.cache_first_layer(params, xtr[:p["n_retrain"]], h)
            fte = hybrid.cache_first_layer(params, xte, h)
            torch.cuda.synchronize()
            cache_ms = (time.perf_counter() - t0) * 1e3 / batches
            launches = {k: read_counts()[k] - before_counts[k]
                        for k in sc_kernels}
            before = hybrid.evaluate_cached(params, fte, yte, cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            retrained = hybrid.retrain_tail(
                params, ftr, ytr[:p["n_retrain"]], cfg,
                steps=p["retrain_steps"], batch=128)
            torch.cuda.synchronize()
            retrain_ms = (time.perf_counter() - t0) * 1e3 / \
                p["retrain_steps"]
            after = hybrid.evaluate_cached(retrained, fte, yte, cfg)
            rows[key] = {"bits": bits, "design": name,
                         "misclass_pct": 100 * (1 - after),
                         "misclass_before_retrain_pct": 100 * (1 - before),
                         "acc": after, "acc_before": before,
                         "ms_per_cached_batch": cache_ms,
                         "ms_per_retrain_step": retrain_ms,
                         "launches": launches}
            if h.mode == "sc":
                feats[key] = (h, fte)
    torch.cuda.synchronize()
    counts = {k: read_counts()[k] for k in sc_kernels}
    path_s = time.perf_counter() - t_phase

    # -- launches: 2 sng_pack (X, both banks) per SC batch, 1 sc_dot per
    # TFF batch, none for the binary design
    bad_launches = {}
    for key, row in rows.items():
        sc = row["design"] != "binary"
        want = {"sng_pack": 2 * batches if sc else 0,
                "sc_dot": batches if row["design"] == "new_sc" else 0}
        if row["launches"] != want:
            bad_launches[key] = (row["launches"], want)

    # -- features: the kernel route against the plain versions on the same
    # CUDA tensors, and against the CPU's plain path
    def plain_sc_dot(x, w, s0_mode="alt", adder="tff", *, length=None):
        return ref.sc_dot(x, w, s0_mode, adder)
    cpu_params = {k: {n: t.cpu() for n, t in v.items()}
                  for k, v in params.items()}
    feature_checks = {}
    for key, (h, fte) in feats.items():
        sub = xte[:FEATURE_CHECK_IMAGES]
        with mock.patch.object(sng_pack_k, "sng_pack", ref.sng_pack), \
                mock.patch.object(sc_dot_k, "sc_dot", plain_sc_dot):
            plain = hybrid.cache_first_layer(params, sub, h)
        cpu = hybrid.cache_first_layer(cpu_params, sub[:CPU_CHECK_IMAGES], h)
        feature_checks[key] = {
            "plain_on_card_bitwise": bool(torch.equal(
                fte[:FEATURE_CHECK_IMAGES], plain)),
            "cpu_bitwise": bool(torch.equal(
                fte[:CPU_CHECK_IMAGES].cpu(), cpu))}

    # -- the reference test's thresholds, at full width
    # and, so that a retraining that changes nothing fails: every design
    # above RETRAIN_LARGE_ERR before retraining ends RETRAIN_MIN_DROP lower
    err = {k: 1 - r["acc"] for k, r in rows.items()}
    thresholds = {
        "float_acc_gt_0.8": float_acc > 0.8,
        "after_ge_before_minus_0.02": all(
            r["acc"] >= r["acc_before"] - 0.02 for r in rows.values()),
        "retraining_lowers_large_errors": all(
            r["acc"] - r["acc_before"] >= RETRAIN_MIN_DROP for r in
            rows.values() if 1 - r["acc_before"] > RETRAIN_LARGE_ERR),
        "new_sc_err2_gt_err4": err.get("new_sc_2", 0) > err.get("new_sc_4", 1)}

    # -- profiles: 10 retraining steps (new SC at 4 bits, or the first SC
    # design), 10 caching batches of each SC design
    prof_key = "new_sc_4" if "new_sc_4" in feats else next(iter(feats))
    ftr4 = hybrid.cache_first_layer(params, xtr[:p["n_retrain"]],
                                    feats[prof_key][0])
    feats_tr = ftr4.to(torch.float32)
    y_dev = torch.as_tensor(ytr[:p["n_retrain"]]).to(dev)
    ridx = torch.as_tensor(mnist_synth.batch_indices(
        ftr4.shape[0], 128, 0, 32), device=dev)
    sub = {k: params[k] for k in hybrid.TRAINABLE}
    state = {"params": params, "opt": optim.init(sub, opt_cfg), "i": 0}
    rgen = torch.Generator(device=dev).manual_seed(0)

    def retrain_step():
        i = state["i"] % ridx.shape[0]
        state["params"], state["opt"], _ = hybrid.tail_train_step(
            state["params"], state["opt"], feats_tr[ridx[i]], y_dev[ridx[i]],
            rgen, cfg, opt_cfg)
        state["i"] += 1
    profiles = {"retrain_step": profile_stages(retrain_step, 10)}
    batch_dev = torch.as_tensor(xte[:CACHE_BATCH]).to(dev)
    for key, (h, _) in feats.items():
        profiles[f"cache_batch_{key}"] = profile_stages(
            lambda h=h: hybrid.cache_first_layer(params, batch_dev, h), 10)

    by_bits = {}
    for bits in p["bits"]:
        pb, po, pn = PAPER_MISCLASS[bits]
        by_bits[bits] = {
            **{d: rows[f"{d}_{bits}"]["misclass_pct"] for d in
               ("binary", "new_sc", "old_sc") if f"{d}_{bits}" in rows},
            "paper": {"binary": pb, "old_sc": po, "new_sc": pn}}
    b4 = by_bits.get(4, {})
    claims = {
        "gap_4bit_hybrid_minus_binary_pp":
            b4["new_sc"] - b4["binary"] if "binary" in b4 else None,
        "gap_4bit_paper_pp": 0.25,
        "old_minus_new_4bit_pp":
            b4["old_sc"] - b4["new_sc"] if "old_sc" in b4 else None,
        "old_minus_new_4bit_paper_pp": 0.59,
        "err_2bit_pct": by_bits.get(2, {}).get("new_sc"),
        "err_4bit_pct": b4.get("new_sc"),
        "paper_err_2bit_vs_4bit_pct": [43.82, 1.04]}
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "table3", "protocol": {k: list(v) if isinstance(v, tuple)
                                          else v for k, v in p.items()},
          "lenet": {"conv1": cfg.conv1_filters, "conv2": cfg.conv2_filters,
                    "dense": cfg.dense, "dropout": cfg.dropout},
          "float_misclass_pct": 100 * (1 - float_acc),
          "misclass_pct_by_bits": by_bits, "claims": claims,
          "ms_per_pretrain_step": pretrain_ms,
          "ms_per_retrain_step": {k: r["ms_per_retrain_step"]
                                  for k, r in rows.items()},
          "ms_per_cached_batch": {k: r["ms_per_cached_batch"]
                                  for k, r in rows.items()},
          "cached_batches_per_design": batches,
          "misclass_before_retrain_pct": {
              k: r["misclass_before_retrain_pct"] for k, r in rows.items()},
          "launches": counts,
          "launches_by_design": {k: r["launches"] for k, r in rows.items()},
          "feature_checks": feature_checks, "thresholds": thresholds,
          "profiles": profiles, "data_s": data_s, "path_s": path_s,
          "phase_s": phase_s})
    if bad_launches:
        raise SystemExit(f"table3: SC launches per design off: {bad_launches}")
    if not all(c for f in feature_checks.values() for c in f.values()):
        raise SystemExit(f"table3: features differ from the plain path: "
                         f"{feature_checks}")
    if not all(thresholds.values()):
        raise SystemExit(f"table3: a threshold fails: {thresholds}")
    if not all(counts.values()):
        raise SystemExit(f"table3: an SC kernel never launched: {counts}")
    return counts


def table3_full_main() -> int:
    """``--table3-full``: the card's line and phase 9 on the reference's
    full Table 3 protocol (bits 2-8, 8,000 / 2,000 images, 600 / 400
    steps, old SC at every precision)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(nvidia_smi("name,power.limit"), flush=True)
    retrain_main_path(torch.device("cuda"), TABLE3_FULL)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def family_main(path: str, run,
                sources=("paged_attn", "cascade_attn", "flash_attn")) -> int:
    """``--moe`` / ``--hymba`` / ``--whisper`` / ``--vlm`` / ``--rwkv`` /
    ``--decoders`` / ``--shard``: the card's line, the build of ``sources`` (the
    attention kernels; the SC kernels for ``--rwkv``) and one phase alone
    (``run(dev, sleep)``, its launches printed under ``path``, or by path
    where ``path`` is None)."""
    import torch
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(nvidia_smi("name,power.limit"), flush=True)
    t0 = time.perf_counter()
    build.build_all(sources)
    emit({"build_s": time.perf_counter() - t0})
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    launches = run(torch.device("cuda"), int(0.05 * clock_mhz * 1e6))
    # a phase that serves several paths returns their launches by path
    emit({"launches_by_path": launches if path is None else
          {path: launches}})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def sc_timing_main(root: Path) -> int:
    """``--sc-timing <checkout>``: phase 3's SC timing for the checkout at
    ``root`` (its kernels built from its own sources), one JSON line."""
    import torch
    from repro_torch.kernels import build
    build.build_all(("sng_pack", "sc_dot"))
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.device("cuda")
    sc = sc_timing(dev, int(0.05 * clock_mhz * 1e6), clock_mhz * 1e6 * sms)
    emit({"sc_timing": str(root), "gpu": nvidia_smi("name,power.limit"),
          "frame_stage_bucket32": frame_stage_profiles(dev), **sc})
    return 0


def frame_stage_profiles(dev) -> dict:
    """The bucket-32 sensor stage of the full LeNet-5 SC frame path at bits
    4 and 8 (random weights from seed 0, random frames): host ms and
    :func:`profile_stages`."""
    import torch
    from repro_torch import configs
    from repro_torch.models import lenet
    from repro_torch.serve.gateway import frontend as fe
    cfg = configs.config("lenet5")
    params = lenet.init(0, cfg, device=dev)
    gen = torch.Generator().manual_seed(2)
    frames = torch.randint(0, 256, (32, 28, 28, 1), generator=gen,
                           dtype=torch.uint8).to(dev)
    out = {}
    for bits in (4, 8):
        spec = fe.FrontendSpec(mode="sc", bits=bits, lenet=cfg)
        out[f"bits{bits}"] = profile_stages(
            lambda: fe.sensor_stage(params, frames, spec), 10)
    return out


def sc_compare(parent: Path) -> int:
    """``--sc-compare <parent checkout>``: the SC timing of the parent and of
    this checkout in turns (parent, change, change, parent), each in its own
    process, then each row's ms side by side."""
    runs = []
    for label, root in (("parent", parent), ("change", ROOT),
                        ("change", ROOT), ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--sc-timing",
             str(root)], capture_output=True, text=True, timeout=900)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode:
            print(proc.stdout[-4000:])
            return proc.returncode
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": label, **out}), flush=True)
        runs.append((label, out))
    table = {}
    for label, out in runs:
        for row in out["rows"]:
            key = " ".join(str(row.get(k, "")) for k in
                           ("kernel", "bits", "O", "K", "route"))
            table.setdefault(key, []).append(
                (label, row["ms"], row["issue_us"]))
        for bits, prof in out["frame_stage_bucket32"].items():
            table.setdefault(f"sensor_stage {bits}", []).append(
                (label, prof["stage_ms"], prof["device_busy_ms_per_stage"],
                 prof["device_ops_per_stage"]))
    emit({"sc_compare": table})
    return 0


def cascade_timing_main(root: Path) -> int:
    """``--cascade-timing <checkout>``: load (c) through the cascade gateway
    of the checkout at ``root`` (its kernels built from its own sources),
    stablelm-3b at full width and depth with seed-0 random weights, with
    :func:`profile_ticks` over three of its ticks; then the tick's row
    write alone, as that checkout's engine writes it (the layers' rows
    stacked first, or passed per layer).  One JSON line."""
    import inspect

    import torch

    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attn as paged_k
    from repro_torch.models import lm
    from repro_torch.serve import engine
    build.build_all(("paged_attn", "cascade_attn", "flash_attn"))
    dev = torch.device("cuda")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sleep = int(0.05 * clock_mhz * 1e6)
    cfg = configs.config("stablelm-3b")
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    run = serve_load(dev, cfg, params,
                     load_c_prompts(cfg.vocab)[0], backend="cascade",
                     chunked=False, new_tokens=NEW_TOKENS_C, profile=True)
    del params
    torch.cuda.empty_cache()
    # the write at load (c)'s width: 32 layers' rows of 8 lanes
    L, S, H, D = cfg.n_layers, LM_SLOTS, cfg.n_kv_heads, cfg.d_head
    num_blocks = LM_SLOTS * (LM_MAX_LEN // LM_BLOCK) + 1
    gen = torch.Generator(device=dev).manual_seed(3)
    ka = torch.empty((L, num_blocks, 1, LM_BLOCK, H, D), dtype=cfg.dtype,
                     device=dev)
    va = torch.empty_like(ka)
    rows = [[torch.randn((S, H, D), generator=gen, device=dev).to(cfg.dtype)
             for _ in range(L)] for _ in range(2)]
    w = torch.randperm(num_blocks - 1, generator=gen, device=dev)[:S] + 1
    w = w.to(torch.int32)
    o = torch.full((S,), 5, dtype=torch.int32, device=dev)
    stacked = "torch.stack(k_rows)" in inspect.getsource(
        engine.decode_step_paged)

    def write():
        if stacked:
            return paged_k.scatter_kv_rows(ka, va, torch.stack(rows[0]),
                                           torch.stack(rows[1]), w, o)
        return paged_k.scatter_kv_rows(ka, va, *rows, w, o)
    write_ms = time_ms(write, 5, 20, sleep)
    emit({"cascade_timing": str(root), "gpu": nvidia_smi("name,power.limit"),
          "tick_ms_median": statistics.median(run["tick_ms"]),
          "ticks": run["ticks"], "launches": run["launches"],
          "profile": run["profile"],
          "tick_write": {"rows": "stacked" if stacked else "per layer",
                         "ms": write_ms[0], "back_to_back_ms": write_ms[1]}})
    return 0


def cascade_compare(parent: Path) -> int:
    """``--cascade-compare <parent checkout>``: :func:`cascade_timing_main`
    for the parent and for this checkout in turns (parent, change, change,
    parent), each in its own process, then the cascade tick's device busy
    ms, host launches and stacks per tick, host ms and the row write side
    by side."""
    runs = []
    for label, root in (("parent", parent), ("change", ROOT),
                        ("change", ROOT), ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--cascade-timing", str(root)], capture_output=True, text=True,
            timeout=900)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode:
            print(proc.stdout[-4000:])
            return proc.returncode
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": label, **out}), flush=True)
        runs.append((label, out))
    keys = ("device_busy_ms_per_tick", "device_idle_share",
            "host_launches_per_tick", "stack_ops_per_tick")
    table = {key: [(label, out["profile"][key]) for label, out in runs]
             for key in keys}
    table["tick_ms_median"] = [(label, out["tick_ms_median"])
                               for label, out in runs]
    table["tick_write_ms"] = [(label, out["tick_write"]["rows"],
                               out["tick_write"]["ms"]) for label, out in runs]

    def side(key, label):
        return statistics.median(out["profile"][key] for lab, out in runs
                                 if lab == label)
    emit({"cascade_compare": table,
          "host_launches_per_tick_drop":
              side("host_launches_per_tick", "parent")
              - side("host_launches_per_tick", "change"),
          "device_busy_ms_per_tick_drop":
              side("device_busy_ms_per_tick", "parent")
              - side("device_busy_ms_per_tick", "change")})
    return 0


def stride_outputs_main(root: Path, out: Path) -> int:
    """``--stride-outputs <checkout> <file>``: the paged sweeps of the
    checkout at ``root`` (kernel 3, and kernel 5 with its state, its fused
    merge and a nonzero ``q0``; contiguous blocks, which every checkout
    takes) on seeded inputs at every forced plan, both dtypes, windows
    none / 8 / 1,024 and the new row spliced in, saved to ``out``; then
    kernel 5's time at load (c)'s suffix shape (8 lanes of 25 x 64 heads
    at hymba-1.5b's width, 1,200 positions, and stablelm-3b's 32 x 80 at
    1,088) and kernel 3's at the 8 x 1k tick.  One JSON line."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attn as paged_k
    build.build_all(("paged_attn",))
    dev = torch.device("cuda")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sleep = int(SLEEP_S * clock_mhz * 1e6)
    gen = torch.Generator(device=dev).manual_seed(5)
    i32 = dict(dtype=torch.int32, device=dev)
    outputs, timing = [], {}
    for (B, Hq, Hkv, D, nb, lo, hi) in ((8, 32, 32, 80, 96, 1000, 1500),
                                        (8, 25, 5, 64, 80, 1100, 1250),
                                        (3, 8, 2, 128, 40, 1, 600)):
        num_blocks = B * nb + 1
        tables = (torch.randperm(num_blocks - 1, generator=gen, device=dev)
                  + 1).reshape(B, nb).to(torch.int32)
        lens = torch.randint(lo, hi + 1, (B,), generator=gen, **i32)
        q0 = torch.randint(0, lo, (B,), generator=gen, **i32) // 16 * 16
        for dt in (torch.float32, torch.bfloat16):
            ka, va = (torch.randn((num_blocks, 16, Hkv, D), generator=gen,
                                  device=dev).to(dt) for _ in range(2))
            q = torch.randn((B, Hq, D), generator=gen, device=dev).to(dt)
            nk = tuple(torch.randn((B, Hkv, D), generator=gen, device=dev)
                       .to(dt) for _ in range(2))
            pre = tuple(torch.randn(s, generator=gen, device=dev)
                        for s in ((1, B, Hq, D), (1, B, Hq), (1, B, Hq)))
            pre = (pre[0], pre[1], pre[2].abs() + 1,
                   torch.arange(B, **i32))
            for name, plan in paged_k.CASCADE_FORCED_PLANS.items():
                with mock.patch.multiple(paged_k, **plan) if plan else \
                        contextlib.nullcontext():
                    for win in (None, 8, 1024):
                        for splice in (None, nk):
                            outputs.append(paged_k.paged_decode_attention(
                                q, ka, va, tables, lens, window=win,
                                new_kv=splice))
                            outputs.extend(
                                paged_k.paged_decode_attention_with_state(
                                    q, ka, va, tables, lens, window=win,
                                    q0=q0, new_kv=splice))
                            outputs.append(
                                paged_k.paged_decode_attention_with_state(
                                    q, ka, va, tables, lens, window=win,
                                    q0=q0, new_kv=splice, prefix=pre))
            if dt == torch.bfloat16 and Hkv < 32:
                timing[f"kernel5 {Hq} over {Hkv} x {D}"] = time_ms(
                    lambda: paged_k.paged_decode_attention_with_state(
                        q, ka, va, tables, lens, new_kv=nk), 5, 20, sleep,
                    b2b=False)[0]
            if dt == torch.bfloat16 and Hkv == 32:
                timing["kernel5 32 x 80"] = time_ms(
                    lambda: paged_k.paged_decode_attention_with_state(
                        q, ka, va, tables, lens, new_kv=nk), 5, 20, sleep,
                    b2b=False)[0]
                timing["kernel3 32 x 80"] = time_ms(
                    lambda: paged_k.paged_decode_attention(
                        q, ka, va, tables, lens, new_kv=nk), 5, 20, sleep,
                    b2b=False)[0]
    torch.cuda.synchronize()
    torch.save([t.cpu() for t in outputs], out)
    emit({"stride_outputs": str(root), "gpu": nvidia_smi("name,power.limit"),
          "outputs": len(outputs), "ms": timing,
          "ptxas": ptxas_of("paged_attn", "paged_attn_kernel")})
    return 0


def stride_compare(parent: Path) -> int:
    """``--stride-compare <parent checkout>``: :func:`stride_outputs_main`
    for the parent and for this checkout in turns (parent, change, change,
    parent), each in its own process: every output of the change bit for
    bit the parent's (the block stride at its default, bs, changes
    nothing), and the kernels' ms side by side."""
    import tempfile

    import torch
    runs, saved = [], {}
    tmp = tempfile.TemporaryDirectory()
    for i, (label, root) in enumerate((("parent", parent), ("change", ROOT),
                                       ("change", ROOT),
                                       ("parent", parent))):
        path = Path(tmp.name) / f"stride_outputs_{i}.pt"
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--stride-outputs", str(root), str(path)],
            capture_output=True, text=True, timeout=900)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode:
            print(proc.stdout[-4000:])
            return proc.returncode
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": label, **out}), flush=True)
        runs.append((label, out))
        saved.setdefault(label, torch.load(path))
    tmp.cleanup()
    a, b = saved["parent"], saved["change"]
    same = len(a) == len(b) and all(torch.equal(x, y)
                                    for x, y in zip(a, b))
    emit({"stride_compare": {"outputs": len(a), "bitwise_parent": same,
                             "ms": [(label, out["ms"])
                                    for label, out in runs],
                             "ptxas": {label: out["ptxas"]
                                       for label, out in runs}}})
    return 0 if same else 1


# -- training (phase 19) -----------------------------------------------------

TRAIN_ARCH = "stablelm-3b"
TRAIN_BATCH, TRAIN_SEQ = 8, 256
TRAIN_STEPS, TRAIN_SC_STEPS = 20, 10
# (d): the float32 step, kernels against plain versions, at full width and
# this depth; (e): the restart at full width and this depth, in bf16
TRAIN_STRICT_DEPTH, TRAIN_RESTART_DEPTH = 4, 2
TRAIN_RESTART_STEPS = 6
# (a): the backward kernel at each family's attention shape: (B, Sq, Sk,
# Hq, Hkv, D, causal, window); the first is the main path's own
BWD_SHAPES = {
    "stablelm-3b (train step)": (8, 256, 256, 32, 32, 80, True, None),
    "gqa 8:1 x 128": (1, 1024, 1024, 64, 8, 128, True, None),
    "gqa 12:1 x 128": (1, 1024, 1024, 48, 4, 128, True, None),
    "hymba-1.5b window 1,024": (1, 2048, 2048, 25, 5, 64, True, 1024),
    "whisper-medium cross 256 over 1,500": (1, 256, 1500, 16, 16, 64, False,
                                            None),
}
# (a)'s bound on each gradient's max |error| against the plain version, as a
# share of its max |value|
BWD_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# the kernels of csrc/flash_attn_bwd.cu, as the profiler names them
BWD_KERNEL_NAMES = ("delta_kernel", "dkdv_mma_kernel", "dq_mma_kernel",
                    "dkdv_f32_kernel", "dq_f32_kernel", "sum_splits_kernel")


def bwd_pairs(Sq: int, Sk: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs of one head that the mask keeps (queries at
    offset 0)."""
    win = window or 1 << 30
    return sum(min(i + 1, Sk, win) if causal else Sk for i in range(Sq))


def bwd_kernel_checks(dev, sleep: int) -> tuple[dict, dict]:
    """Phase 19 (a): ``flash_attention_bwd`` against its plain version
    (``ref.flash_attention_bwd_chunked``) on the same CUDA tensors at each
    of ``BWD_SHAPES``, float32 within 2e-5 and bf16 within 1e-2 of each
    gradient's max |value|, two calls bit for bit, the forward's lse (from
    the kernel) within 2e-5 of the plain forward's; then in bf16 the
    kernel's ms beside its bound (each input read once and each output
    written once over 3.35 TB/s, against the backward's five products, 10
    x D operations per kept (query, key) pair and head, over the bf16
    peak), its device µs by kernel (``torch.profiler``), the plain
    version's ms and, as the library time, one forward
    and backward of ``F.scaled_dot_product_attention`` on the same problem
    (no PyTorch call computes the backward alone).  Each shape's row also
    gives the head split plan (``bwd_head_split_plan``), each device
    launch's CTAs and the launches a call; the line gives the ``ptxas``
    registers and spills of every backward kernel, and the phase fails if
    a bf16 tile kernel spills at D = 64, 80 or 128.  Prints the
    ``bwd_kernel_checks`` line and returns ({"flash_attention_bwd": max abs
    error}, the timing rows); raises SystemExit on a failed check."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as flash_k
    from repro_torch.kernels import ref

    sw = Stopwatch()
    checks, timing, err = [], {}, 0.0
    for label, (B, Sq, Sk, Hq, Hkv, D, causal, window) in BWD_SHAPES.items():
        splits, run = flash_k.bwd_head_split_plan(B, Sk, Hkv, Hq // Hkv)
        plan = {"splits": splits, "heads_per_split": run,
                "ctas": bwd_ctas(B, Sq, Sk, Hq, Hkv, D, splits),
                "launches_per_call": 3 + (splits > 1)}
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(Sq * Hq + D)
            q, dout = (torch.randn((B, Sq, Hq, D), generator=gen,
                                   device=dev).to(dtype) for _ in range(2))
            k, v = (torch.randn((B, Sk, Hkv, D), generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            kw = dict(causal=causal, window=window)
            out, lse = flash_k.flash_attention(q, k, v, return_lse=True, **kw)
            _, plain_lse = ref.flash_attention_chunked(
                q, k, v, causal, window, return_lse=True)
            got = flash_k.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
            again = flash_k.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
            want = ref.flash_attention_bwd_chunked(q, k, v, out, dout, lse,
                                                   causal, window)
            name = str(dtype).split(".")[1]
            shares, abs_err = [], 0.0
            for g, w in zip(got, want):
                e = float((g.float() - w.float()).abs().max())
                abs_err = max(abs_err, e)
                shares.append(e / float(w.float().abs().max()))
            lse_err = float((lse - plain_lse).abs().max())
            check = {"shape": label, "dtype": name,
                     "err_share_dq_dk_dv": shares, "lse_err": lse_err,
                     "bitwise_repeat": all(torch.equal(a, b)
                                           for a, b in zip(got, again))}
            check["ok"] = (max(shares) <= BWD_TOL[name] and lse_err <= 2e-5
                           and check["bitwise_repeat"])
            checks.append(check)
            err = max(err, abs_err)
            if dtype != torch.bfloat16:
                continue
            ms = time_ms(lambda: flash_k.flash_attention_bwd(
                q, k, v, out, dout, lse, **kw), 3, 5, sleep, b2b=False)[0]
            by_kernel = device_us(lambda: flash_k.flash_attention_bwd(
                q, k, v, out, dout, lse, **kw), 10)
            plain = time_ms(lambda: ref.flash_attention_bwd_chunked(
                q, k, v, out, dout, lse, causal, window), 2, 1, sleep,
                b2b=False)[0]
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            gt = dout.transpose(1, 2).contiguous()
            sdpa = {"enable_gqa": Hq != Hkv}
            if window:
                pos = torch.arange(Sq, device=dev)
                rel = pos[:, None] - torch.arange(Sk, device=dev)[None, :]
                sdpa["attn_mask"] = (rel >= 0) & (rel < window)
            else:
                sdpa["is_causal"] = causal

            def library():
                o = F.scaled_dot_product_attention(qt, kt, vt, **sdpa)
                return torch.autograd.grad(o, (qt, kt, vt), gt)
            lib = time_ms(library, 3, 5, sleep, b2b=False)[0]
            pairs = B * bwd_pairs(Sq, Sk, causal, window)
            n_bytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
            ops = 10 * Hq * D * pairs
            row = {"shape": f"q (B={B}, {Sq}, {Hq}, {D}) bf16, k and v "
                            f"({B}, {Sk}, {Hkv}, {D}), "
                            + ("causal" if causal else "non-causal")
                            + (f", window {window}" if window else ""),
                   "ms": ms, "plain_ms": plain, "library_ms": lib,
                   "library": "F.scaled_dot_product_attention forward and "
                              "backward on (B, H, S, D) copies"
                              + (" with a boolean window mask"
                                 if window else ""),
                   "bytes_ms": n_bytes / PEAK_BYTES_PER_S * 1e3,
                   "ops_ms": ops / BF16_FLOPS * 1e3,
                   "device_us_by_kernel": by_kernel, **plan}
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            row["bound_by"] = "bytes" if row["bytes_ms"] >= row["ops_ms"] \
                else "operations"
            timing[label] = row
            del qt, kt, vt, gt
        del q, k, v, dout, out, lse, got, again, want
        torch.cuda.empty_cache()
        sw.lap(label)
    bad = [c for c in checks if not c["ok"]]
    spills = bwd_mma_spills()
    emit({"phase": "bwd_kernel_checks", "checks": len(checks), "failed": bad,
          "max_abs_err": err, "results": checks, "timing": timing,
          "ptxas": {name: ptxas_of("flash_attn_bwd", name)
                    for name in BWD_KERNEL_NAMES},
          "mma_spill_store_bytes": spills, **sw.fields()})
    if bad:
        raise SystemExit(f"flash_attention_bwd disagrees with its plain "
                         f"version: {bad}")
    if any(v != 0 for v in spills.values()):
        raise SystemExit(f"a bf16 backward tile kernel spills: {spills}")
    return {"flash_attention_bwd": err}, timing


def bwd_ctas(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int,
             splits: int) -> dict:
    """CTAs of each device launch of one ``flash_attention_bwd`` call
    (``csrc/flash_attn_bwd.cu``'s grids): delta, one warp a row; dK/dV,
    one per (key tile, KV head, batch row, split); dQ, one per (query tile,
    head, batch row); the split sum, 256 threads of four elements over dk
    and dv."""
    from repro_torch.kernels.flash_attn import TILE_K as tile
    out = {"delta": -(-B * Sq * Hq // 8),
           "dkdv": -(-Sk // tile) * Hkv * B * splits,
           "dq": -(-Sq // tile) * Hq * B}
    if splits > 1:
        out["sum_splits"] = 2 * -(-B * Sk * Hkv * D // 4 // 256)
    return out


def bwd_mma_spills() -> dict:
    """Spill-store bytes of the bf16 backward tile kernels at D = 64, 80
    and 128 (``KS`` = 4, 5, 8), from their ``ptxas`` lines; None where no
    line was found."""
    out = {}
    for name in ("dkdv_mma", "dq_mma"):
        for ks in (4, 5, 8):
            found = [int(n) for ln in ptxas_of("flash_attn_bwd", name,
                                                 f"ILi{ks}E")
                     for n in re.findall(r"(\d+) bytes spill stores", ln)]
            out[f"{name}<{ks}>"] = max(found) if found else None
    return out


def train_batches(cfg, n: int, start: int = 0) -> list:
    """Steps ``start`` to ``start + n - 1`` of the token pipeline at the
    phase's batch and sequence, seed 0, as host arrays."""
    from repro_torch.data.tokens import TokenPipeline
    pipe = TokenPipeline(0, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab,
                         start_step=start)
    return [pipe.next() for _ in range(n)]


def on_device(dev, batch: dict) -> dict:
    """A host batch's arrays as tensors on ``dev``."""
    import torch
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def train_run(dev, cfg, params, opt, batches, tcfg) -> dict:
    """``make_train_step``'s steps over ``batches``, each timed on the host
    to its synchronize: the losses, ms per step, and the flash kernels'
    launches over the run (counted from 0)."""
    import torch

    from repro_torch.train.step import make_train_step
    step = make_train_step(cfg, tcfg)
    losses, ms = [], []
    reset_counts()
    for b in batches:
        batch = on_device(dev, b)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    return {"losses": losses, "ms": ms, "launches": read_counts()}


def step_profile(dev, cfg, params, opt, batches, tcfg) -> dict:
    """``torch.profiler`` over steps on ``batches``: device busy ms per step,
    the kernels that take the most device time, and the device ms of
    ``flash_attention_bwd``'s kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.step import make_train_step
    step = make_train_step(cfg, tcfg)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches:
            step(params, opt, on_device(dev, b))
        torch.cuda.synchronize()
    dev_us = kernel_us(prof, len(batches))
    return {"device_busy_ms_per_step": sum(dev_us.values()) / 1e3
            if dev_us else None,
            "top_device_ms_per_step": top_ms(dev_us, 8),
            "flash_bwd_device_ms_per_step": top_ms(
                {k: v for k, v in dev_us.items() if any(
                    n in k for n in BWD_KERNEL_NAMES)}, 8)}


def plain_flash():
    """``flash_attention`` and ``flash_attention_bwd`` patched to their
    plain versions on every device (for (d)'s step through the plain
    versions)."""
    from repro_torch.kernels import flash_attn as flash_k
    from repro_torch.kernels import ref

    def fwd(q, k, v, *, causal=True, window=None, q_offset=0, q_chunk=512,
            kv_chunk=1024, return_lse=False):
        return ref.flash_attention_chunked(q, k, v, causal, window, q_offset,
                                           q_chunk, kv_chunk, return_lse)

    def bwd(q, k, v, out, dout, lse, *, causal=True, window=None,
            q_offset=0, q_chunk=512, kv_chunk=1024):
        return ref.flash_attention_bwd_chunked(q, k, v, out, dout, lse,
                                               causal, window, q_offset,
                                               q_chunk, kv_chunk)
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(flash_k, "flash_attention", fwd))
    stack.enter_context(mock.patch.object(flash_k, "flash_attention_bwd",
                                          bwd))
    return stack


def tree_close(a, b, rtol: float, atol: float) -> tuple[bool, float]:
    """Whether every leaf of ``a`` is within ``atol + rtol |b|`` of ``b``'s,
    and the largest |a - b|."""
    from repro_torch.train import optim
    ok, worst = True, 0.0
    for x, y in zip(optim.leaves(a), optim.leaves(b)):
        d = (x.float() - y.float()).abs()
        worst = max(worst, float(d.max()))
        ok &= bool((d <= atol + rtol * y.float().abs()).all())
    return ok, worst


def train_main_path(dev, sleep: int) -> dict:
    """Phase 19: single-card training of stablelm-3b (``lm.forward``,
    ``train/step.py``, ``train/optim.py``'s in-place AdamW,
    ``ckpt/manager.py``), after (a) ``bwd_kernel_checks``:

    (b) the whole model (32 x 2,560, 2.795 B parameters, bf16 with a
        float32 AdamW master, ``remat="full"``) for ``TRAIN_STEPS`` steps
        of B = 8, S = 256 from ``TokenPipeline``: every loss finite, the
        mean of the last five below step 0's, every layer's attention
        ``wq`` and ``wk`` gradients non-zero on the first batch, ms per
        step, tokens per second, 6 N tokens over the step time as a share
        of the bf16 peak, the device's idle share over two profiled steps,
        the peak of ``torch.cuda.max_memory_allocated``, and the flash
        kernels' launches (per step: 64 forward, 32 of them the remat's
        recomputes, and 32 backward);
    (c) the same with ``first_layer_mode="sc"`` (bits 4) for
        ``TRAIN_SC_STEPS`` steps: 2 ``sng_pack`` and 1 ``sc_dot`` per
        step, the SC frontend's output on the first batch bit for bit its
        plain versions';
    (d) float32 at full width and ``TRAIN_STRICT_DEPTH`` layers: the loss,
        every gradient and one AdamW step through the kernels against the
        same through the plain versions on the card, within the CPU
        tests' bounds (loss 1e-5 relative, gradients 1e-4 of each leaf's
        max |g|, parameters rtol 2e-3, atol 2e-5);
    (e) a restart at full width and ``TRAIN_RESTART_DEPTH`` layers (bf16):
        ``TRAIN_RESTART_STEPS`` steps straight against half of them, a
        ``save_sync``, every tensor of the run dropped, a restore into a
        fresh model drawn from another seed with a fresh step function and
        pipeline, and the other half: losses and the final parameters and
        optimizer state bit for bit; the checkpoint's bytes and the save
        and restore seconds.
    Returns the flash and SC kernels' launches over (b) and (c); raises
    SystemExit on a failed check."""
    import tempfile

    import torch

    from repro_torch import configs
    from repro_torch.ckpt import manager as ckpt
    from repro_torch.kernels import ref
    from repro_torch.kernels import sc_dot as sc_dot_k
    from repro_torch.kernels import sng_pack as sng_pack_k
    from repro_torch.models import lm
    from repro_torch.train import optim
    from repro_torch.train.step import TrainConfig, value_and_grad

    sw = Stopwatch()
    failures = []
    cfg = configs.config(TRAIN_ARCH)
    tcfg = TrainConfig()
    n_params = lm.count_params(cfg)
    batches = train_batches(cfg, TRAIN_STEPS + 2)
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ

    # (b) the whole model
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = optim.init(params, tcfg.adamw)
    torch.cuda.synchronize()
    sw.lap("init")
    _, _, grads = value_and_grad(cfg, params, on_device(dev, batches[0]))
    attn_grad_max = {
        name: grads["blocks"]["attn"][name].float().abs().amax(dim=(1, 2))
        .tolist() for name in ("wq", "wk")}
    del grads
    if not all(m > 0 for g in attn_grad_max.values() for m in g):
        failures.append(f"(b) a layer's wq / wk gradient is zero: "
                        f"{attn_grad_max}")
    sw.lap("attn_grads")
    torch.cuda.reset_peak_memory_stats()
    run = train_run(dev, cfg, params, opt, batches[:TRAIN_STEPS], tcfg)
    peak = torch.cuda.max_memory_allocated()
    sw.lap("steps")
    losses = run["losses"]
    steady = statistics.median(run["ms"][2:])
    prof = step_profile(dev, cfg, params, opt, batches[TRAIN_STEPS:], tcfg)
    sw.lap("profile")
    # a forward launch per layer, and one more where the layer is
    # recomputed for its backward
    fwd = 1 if cfg.remat == "none" else 2
    want = {"flash_attention": fwd * cfg.n_layers * TRAIN_STEPS,
            "flash_attention_bwd": cfg.n_layers * TRAIN_STEPS,
            "sng_pack": 0, "sc_dot": 0}
    got = {k: run["launches"][k] for k in want}
    finite = all(math.isfinite(x) for x in losses)
    falling = statistics.mean(losses[-5:]) < losses[0]
    if not (finite and falling) or got != want:
        failures.append(f"(b) losses finite {finite}, falling {falling}, "
                        f"launches {got} against {want}")
    busy = prof["device_busy_ms_per_step"]
    whole = {"config": {k: getattr(cfg, k) for k in (
                 "n_layers", "d_model", "n_heads", "d_head", "d_ff",
                 "vocab", "param_dtype", "remat", "loss_chunk")},
             "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
             "steps": TRAIN_STEPS, "losses": losses,
             "ms_per_step": run["ms"], "ms_per_step_median_after_2": steady,
             "tokens_per_s": tokens_per_step / steady * 1e3,
             "model_flops_share_of_bf16_peak":
                 6 * n_params * tokens_per_step / (steady / 1e3)
                 / BF16_FLOPS,
             "device_busy_ms_per_step": busy,
             "device_idle_share": max(0.0, 1 - busy / steady)
             if busy else None,
             "top_device_ms_per_step": prof["top_device_ms_per_step"],
             "flash_bwd_device_ms_per_step":
                 prof["flash_bwd_device_ms_per_step"],
             "peak_memory_allocated_bytes": peak,
             "launches": got, "attn_grad_max_by_layer": attn_grad_max}
    launches = dict(got)

    # (c) the SC frontend, trained
    cfg_sc = dataclasses.replace(cfg, first_layer_mode="sc", sc_bits=4)
    del opt
    free_card()
    gen = torch.Generator(device=dev).manual_seed(2)
    params = dict(params, sc_frontend=lm.init(
        dataclasses.replace(cfg_sc, n_layers=1), gen)["sc_frontend"])
    opt = optim.init(params, tcfg.adamw)
    x = lm.token_rows(params, on_device(dev, batches[0])["tokens"])
    reset_counts()
    got_sc = lm.sc_frontend(cfg_sc, params["sc_frontend"], x)
    torch.cuda.synchronize()
    call = {n: read_counts()[n] for n in ("sng_pack", "sc_dot")}

    def plain_sc_dot(x, w, s0_mode="alt", adder="tff", *, length=None):
        return ref.sc_dot(x, w, s0_mode, adder)
    with mock.patch.object(sng_pack_k, "sng_pack", ref.sng_pack), \
            mock.patch.object(sc_dot_k, "sc_dot", plain_sc_dot):
        plain_sc = lm.sc_frontend(cfg_sc, params["sc_frontend"], x)
    sc_bitwise = bool(torch.equal(got_sc, plain_sc))
    del x, got_sc, plain_sc
    sw.lap("sc_check")
    sc_run = train_run(dev, cfg_sc, params, opt,
                       batches[:TRAIN_SC_STEPS], tcfg)
    sw.lap("sc_steps")
    want_sc = {"sng_pack": 2 * TRAIN_SC_STEPS, "sc_dot": TRAIN_SC_STEPS,
               "flash_attention": fwd * cfg.n_layers * TRAIN_SC_STEPS,
               "flash_attention_bwd": cfg.n_layers * TRAIN_SC_STEPS}
    got_sc_launches = {k: sc_run["launches"][k] for k in want_sc}
    if not sc_bitwise or call != {"sng_pack": 2, "sc_dot": 1} or \
            got_sc_launches != want_sc or \
            not all(math.isfinite(x) for x in sc_run["losses"]):
        failures.append(f"(c) SC frontend bitwise {sc_bitwise}, one call "
                        f"{call}, launches {got_sc_launches} against "
                        f"{want_sc}, losses {sc_run['losses']}")
    for k, n in got_sc_launches.items():
        launches[k] += n
    sc = {"bits": 4, "steps": TRAIN_SC_STEPS, "losses": sc_run["losses"],
          "ms_per_step_median_after_2": statistics.median(sc_run["ms"][2:]),
          "frontend_bitwise_plain": sc_bitwise,
          "launches": got_sc_launches}
    del params, opt
    free_card()

    # (d) float32 at full width and depth 4: kernels against plain versions
    cfg4 = dataclasses.replace(cfg, n_layers=TRAIN_STRICT_DEPTH,
                               param_dtype="float32")
    params = lm.init(cfg4, torch.Generator(device=dev).manual_seed(4))
    batch = on_device(dev, batches[0])
    reset_counts()
    loss_k, _, grads_k = value_and_grad(cfg4, params, batch)
    strict_launches = {k: read_counts()[k] for k in
                       ("flash_attention", "flash_attention_bwd")}
    with plain_flash():
        loss_p, _, grads_p = value_and_grad(cfg4, params, batch)
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    grad_share = max(
        float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        for a, b in zip(optim.leaves(grads_k), optim.leaves(grads_p)))
    stepped = []
    for grads in (grads_k, grads_p):
        p = optim.unflatten(params, [t.clone() for t in
                                     optim.leaves(params)])
        optim.apply_(p, grads, optim.init(p, tcfg.adamw), tcfg.adamw)
        stepped.append(p)
    params_ok, params_err = tree_close(*stepped, 2e-3, 2e-5)
    if loss_rel > 1e-5 or grad_share > 1e-4 or not params_ok or \
            strict_launches != {"flash_attention": fwd * TRAIN_STRICT_DEPTH,
                                "flash_attention_bwd": TRAIN_STRICT_DEPTH}:
        failures.append(f"(d) loss {loss_rel}, gradients {grad_share}, "
                        f"params {params_err}, launches {strict_launches}")
    strict = {"depth": TRAIN_STRICT_DEPTH, "loss_rel_diff": loss_rel,
              "grad_err_share_of_max": grad_share,
              "params_max_abs_diff": params_err, "launches": strict_launches}
    del params, grads_k, grads_p, stepped, p, grads
    free_card()
    sw.lap("strict_f32")

    # (e) a restart at depth 2
    cfg2 = dataclasses.replace(cfg, n_layers=TRAIN_RESTART_DEPTH)
    half = TRAIN_RESTART_STEPS // 2
    feed = batches[:TRAIN_RESTART_STEPS]

    def fresh(seed):
        p = lm.init(cfg2, torch.Generator(device=dev).manual_seed(seed))
        return p, optim.init(p, tcfg.adamw)
    straight_p, straight_o = fresh(0)
    straight = train_run(dev, cfg2, straight_p, straight_o, feed, tcfg)
    p, o = fresh(0)
    first = train_run(dev, cfg2, p, o, feed[:half], tcfg)
    with tempfile.TemporaryDirectory() as d:
        mgr = ckpt.CheckpointManager(d, keep=1)
        t0 = time.perf_counter()
        mgr.save_sync(half, (p, o), extra={"arch": cfg2.name})
        save_s = time.perf_counter() - t0
        step_dir = Path(d) / f"step_{half:010d}"
        ckpt_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
        del p, o
        free_card()
        target = fresh(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (p, o), manifest = mgr.restore_latest(target)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del target
    resumed = train_run(dev, cfg2, p, o, feed[manifest["step"]:], tcfg)
    losses_equal = first["losses"] + resumed["losses"] == straight["losses"]
    state_equal = all(torch.equal(a, b) for a, b in zip(
        optim.leaves({"p": p, "o": o}),
        optim.leaves({"p": straight_p, "o": straight_o})))
    if not (losses_equal and state_equal):
        failures.append(f"(e) restart: losses equal {losses_equal}, state "
                        f"equal {state_equal}: {straight['losses']} against "
                        f"{first['losses'] + resumed['losses']}")
    restart = {"depth": TRAIN_RESTART_DEPTH, "steps": TRAIN_RESTART_STEPS,
               "restored_at": manifest["step"],
               "losses_bitwise": losses_equal, "state_bitwise": state_equal,
               "checkpoint_bytes": ckpt_bytes, "save_s": save_s,
               "restore_s": restore_s}
    del p, o, straight_p, straight_o
    free_card()
    sw.lap("restart")
    emit({"phase": "train_main_path", "model": cfg.name, "whole": whole,
          "sc": sc, "strict_f32": strict, "restart": restart,
          "launches": launches, "failures": failures, **sw.fields()})
    if failures:
        raise SystemExit(f"train path: {failures}")
    return launches


def train_main(dev, sleep: int) -> dict:
    """``--train``: phase 19 alone, (a) then (b)-(e)."""
    bwd_kernel_checks(dev, sleep)
    return train_main_path(dev, sleep)



# ==========================================================================
# Phase 21: the training meshes.
# ==========================================================================

# (b): tests/test_dist.py's config (float32 here) on its (2, 2, 2) mesh
TM_DIST = dict(name="t", family="decoder", n_layers=2, d_model=64,
               n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
               remat="full", param_dtype="float32")
TM_DIST_MESH = "2x2x2"
TM_DIST_STEPS = 10
# (c), (d): stablelm-3b at full width over a 2x2 ("data", "model") mesh
TM_FULL_MESH = "2x2 data,model"
TM_FULL_STEPS = 4               # timed steps, then two profiled
TM_RESTART_DEPTH = 2
TM_RESTART_MESHES = ("1x1", "1x4 data,model")
# (a): GPipe over 4 stages, 6 microbatches and fewer microbatches than
# stages
TM_GPIPE = ((4, 6), (4, 2))
# (e): the head-shard shapes of (c) (B, S, heads, D: 32 heads split 16 +
# 16, 4 of the 8 rows a data-parallel coordinate) and row 8's GQA 16:1
# fold chunk (16 queries at offset 512, 128 over 8 KV heads of 128)
TM_SHARD_SHAPE = (4, 256, 16, 80)
TM_FOLD_16_1 = (16, 512, 128, 8, 128)


def tm_coords(ms: dict, rows: int) -> int:
    """The data-parallel coordinates that take a microbatch of ``rows``
    rows (``batch_spec_axis``'s)."""
    from repro_torch.dist import sharding as shd
    axis = shd.batch_spec_axis(ms, rows)
    return 1 if axis is None else math.prod(
        ms[a] for a in ((axis,) if isinstance(axis, str) else axis))


def tm_expected(cfg, mesh, batch: int, mb: int, steps: int) -> dict:
    """The flash kernels' launches of ``steps`` sharded steps: per layer,
    model shard, data-parallel coordinate that takes rows and microbatch,
    one forward (two under ``remat="full"``: the layer is recomputed for
    its backward) and one backward."""
    from repro_torch.dist import sharding as shd
    ms = shd.mesh_shape_dict(mesh)
    n = cfg.n_layers * ms.get("model", 1) * tm_coords(ms, batch // mb) * \
        mb * steps
    return {"flash_attention": (1 if cfg.remat == "none" else 2) * n,
            "flash_attention_bwd": n}


def gpipe_checks(dev) -> list:
    """(a): ``gpipe_apply`` over a ``"stage"`` mesh on the card against
    the sequential composition of its stages, float32 within 1e-5."""
    import torch

    from repro_torch.dist.pipeline import gpipe_apply
    from repro_torch.launch.mesh import make_mesh
    gen = torch.Generator(device=dev).manual_seed(21)
    out = []
    for n_stages, n_micro in TM_GPIPE:
        mesh = make_mesh((n_stages,), ("stage",), dev)
        p = {"w": torch.randn((n_stages, 8, 8), generator=gen,
                              device=dev) * 0.5,
             "b": torch.randn((n_stages, 8), generator=gen, device=dev) * 0.1}
        xs = torch.randn((n_micro, 2, 8), generator=gen, device=dev)
        got = gpipe_apply(lambda q, x: torch.tanh(x @ q["w"] + q["b"]), p,
                          xs, mesh)
        want = xs
        for s in range(n_stages):
            want = torch.tanh(want @ p["w"][s] + p["b"][s])
        err = float((got - want).abs().max())
        out.append({"stages": n_stages, "microbatches": n_micro,
                    "max_abs_err": err,
                    "ok": bool(torch.allclose(got, want, rtol=1e-5,
                                              atol=1e-5))})
    return out


def flash_pair_check(q, k, v, dout=None, **kw) -> dict:
    """The flash kernels against their plain versions on the same inputs
    (``kw``: causal, window, q_offset): the forward's out within phase 3's
    tolerance (2e-5 float32, 2e-2 bf16, relative and absolute) and its lse
    within 2e-5; with ``dout`` the backward's dq, dk and dv each within
    ``BWD_TOL`` of its max |value|.  Returns the check (``ok``,
    ``max_abs_err`` over every output)."""
    import torch

    from repro_torch.kernels import flash_attn as flash_k
    from repro_torch.kernels import ref
    name = str(q.dtype).split(".")[1]
    tol = 2e-5 if q.dtype == torch.float32 else 2e-2
    out, lse = flash_k.flash_attention(q, k, v, return_lse=True, **kw)
    p_out, p_lse = ref.flash_attention_chunked(
        q, k, v, kw.get("causal", True), kw.get("window"),
        kw.get("q_offset", 0), return_lse=True)
    err = float((out.float() - p_out.float()).abs().max())
    lse_err = float((lse - p_lse).abs().max())
    check = {"dtype": name, "out_err": err, "lse_err": lse_err,
             "ok": bool(torch.allclose(out.float(), p_out.float(), rtol=tol,
                                       atol=tol)) and lse_err <= 2e-5}
    if dout is not None:
        got = flash_k.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
        want = ref.flash_attention_bwd_chunked(
            q, k, v, out, dout, lse, kw.get("causal", True), kw.get("window"),
            kw.get("q_offset", 0))
        shares = []
        for g, w in zip(got, want):
            e = float((g.float() - w.float()).abs().max())
            err = max(err, e)
            shares.append(e / float(w.float().abs().max()))
        check["err_share_dq_dk_dv"] = shares
        check["ok"] &= max(shares) <= BWD_TOL[name]
    check["max_abs_err"] = max(err, lse_err)
    return check


def head_shard_timing(dev, sleep: int) -> dict:
    """(e): the flash kernels at (c)'s head-shard shape, bf16, causal:
    forward and backward held to their plain versions (``flash_pair_check``,
    its ``max_abs_err`` in each row), then each timed beside its plain
    version, its bound (each input read once and each output written once
    over 3.35 TB/s, against the causal band's products over the bf16 peak)
    and SDPA (the forward; forward and backward for the backward); then
    row 8's GQA 16:1 fold chunk, its forward checked and timed the same
    way."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as flash_k
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(22)
    bf = torch.bfloat16
    B, S, H, D = TM_SHARD_SHAPE

    def arr(shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    def row(ms, plain, lib, n_bytes, ops, shape, library):
        r = {"shape": shape, "ms": ms, "plain_ms": plain, "library_ms": lib,
             "library": library, "bytes_ms": n_bytes / PEAK_BYTES_PER_S * 1e3,
             "ops_ms": ops / BF16_FLOPS * 1e3}
        r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"])
        r["bound_by"] = "bytes" if r["bytes_ms"] >= r["ops_ms"] else \
            "operations"
        return r
    q, k, v = arr((B, S, H, D)), arr((B, S, H, D)), arr((B, S, H, D))
    out, lse = flash_k.flash_attention(q, k, v, return_lse=True)
    dout = arr((B, S, H, D))
    check = flash_pair_check(q, k, v, dout)
    pairs = B * bwd_pairs(S, S, True, None)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    gt = dout.transpose(1, 2).contiguous()

    def library_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        return torch.autograd.grad(o, (qt, kt, vt), gt)
    shape = (f"q, k and v ({B}, {S}, {H}, {D}) bf16, causal (a model "
             "shard's heads of a data-parallel coordinate's rows)")
    timing = {
        "flash_attention": row(
            time_ms(lambda: flash_k.flash_attention(q, k, v), 5, 20, sleep,
                    b2b=False)[0],
            time_ms(lambda: ref.flash_attention_chunked(q, k, v, True), 3, 3,
                    sleep, b2b=False)[0],
            time_ms(lambda: F.scaled_dot_product_attention(
                qt.detach(), kt.detach(), vt.detach(), is_causal=True), 5,
                20, sleep, b2b=False)[0],
            2 * 4 * q.numel(), 4 * H * D * pairs, shape,
            "F.scaled_dot_product_attention with is_causal=True on (B, H, "
            "S, D) copies"),
        "flash_attention_bwd": row(
            time_ms(lambda: flash_k.flash_attention_bwd(
                q, k, v, out, dout, lse), 3, 5, sleep, b2b=False)[0],
            time_ms(lambda: ref.flash_attention_bwd_chunked(
                q, k, v, out, dout, lse, True, None), 2, 1, sleep,
                b2b=False)[0],
            time_ms(library_bwd, 3, 5, sleep, b2b=False)[0],
            2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel(),
            10 * H * D * pairs, shape,
            "F.scaled_dot_product_attention forward and backward on (B, H, "
            "S, D) copies")}
    for name in ("flash_attention", "flash_attention_bwd"):
        timing[name]["check"] = check
        timing[name]["max_abs_err"] = check["max_abs_err"]
    del q, k, v, out, lse, dout, qt, kt, vt, gt
    Sq, off, Hq, Hkv, Dh = TM_FOLD_16_1
    Sk = off + Sq
    q, k, v = arr((1, Sq, Hq, Dh)), arr((1, Sk, Hkv, Dh)), \
        arr((1, Sk, Hkv, Dh))
    fold_pairs = sum(off + i + 1 for i in range(Sq))
    fold_check = flash_pair_check(q, k, v, q_offset=off)
    timing["flash_attention_fold_chunk_gqa_16_1"] = row(
        time_ms(lambda: flash_k.flash_attention(q, k, v, q_offset=off), 5,
                20, sleep, b2b=False)[0],
        time_ms(lambda: ref.flash_attention_chunked(q, k, v, True, None,
                                                    off), 3, 3, sleep,
                b2b=False)[0],
        None, 2 * (2 * q.numel() + 2 * k.numel()), 4 * Hq * Dh * fold_pairs,
        f"q (1, {Sq}, {Hq}, {Dh}) bf16 at q_offset {off}, k and v (1, {Sk},"
        f" {Hkv}, {Dh}), causal", "not timed here (PERF.md row 8)")
    timing["flash_attention_fold_chunk_gqa_16_1"].update(
        check=fold_check, max_abs_err=fold_check["max_abs_err"])
    del q, k, v
    torch.cuda.empty_cache()
    return timing


def params_close(a, b, rtol: float = 2e-3, atol: float = 2e-5
                 ) -> tuple[bool, float, int]:
    """Whether every parameter of ``a`` is within ``atol + rtol |b|`` of
    ``b``'s (the one-device step's result).  Returns (ok, the largest
    |a - b|, the elements past the tolerance)."""
    from repro_torch.train import optim
    worst, far = 0.0, 0
    for x, y in zip(optim.leaves(a), optim.leaves(b)):
        d = (x.float() - y.float()).abs()
        worst = max(worst, float(d.max()))
        far += int((d > atol + rtol * y.float().abs()).sum())
    return far == 0, worst, far


def tm_state_equal(a, b) -> bool:
    """Whether two (params, opt) trees hold the same leaves bit for bit."""
    import torch

    from repro_torch.ckpt import manager as ckpt
    return all(x.dtype == y.dtype and bool(torch.equal(x, y))
               for (_, x), (_, y) in zip(ckpt._flatten(a), ckpt._flatten(b)))


def train_mesh_main_path(dev, sleep: int) -> dict:
    """Phase 21: the training meshes on the one card, every mesh device
    ``cuda:0`` (``launch/train.py``'s ``parse_mesh``, ``lm.param_specs``,
    ``dist/sharding.py``'s ``shard`` / ``gather``, ZeRO-1's
    ``optim.init``, ``make_train_step(cfg, tcfg, mesh)``,
    ``dist/pipeline.py``, ``ckpt/manager.py``'s elastic restore):

    (a) ``gpipe_apply`` at 4 stages and 6 microbatches and at 2 (fewer
        than the stages) against the sequential composition, float32
        within 1e-5;
    (b) ``tests/test_dist.py``'s config in float32 on the (2, 2, 2)
        ``("pod", "data", "model")`` mesh, ``TM_DIST_STEPS`` steps of
        ``batch_at(0, i, 8, 32)``, microbatches 2, lr 1e-2: every loss
        finite and the mean of the last three below the first three's (the
        reference's gate); each step against the one-device step from the
        sharded run's gathered state (loss within 1e-5 relative, every
        parameter within ``rtol=2e-3, atol=2e-5``); the flash launches
        those of ``tm_expected``; the flash kernels held to their plain
        versions at a model shard's float32 shape (``flash_pair_check``);
    (c) stablelm-3b whole in bf16 on ``TM_FULL_MESH`` (32 heads split 16 +
        16, B 8, S 256, ``remat="full"``) for ``TM_FULL_STEPS`` steps:
        every loss finite, step 0's within 1e-3 of the one-device forward
        on the same batch and parameters, ms a step, the device's busy ms
        and its copy kernels' ms over two profiled steps (the idle share
        against the unprofiled steps' median), the peak of
        ``max_memory_allocated``, the launches of ``tm_expected``;
    (d) an elastic restart at full width and ``TM_RESTART_DEPTH`` layers:
        a step on the 2x2 mesh, ``save_sync``, then restored onto each of
        ``TM_RESTART_MESHES``: every leaf bit for bit the saved one, and
        the next step bit for bit a step from the same state placed on
        that mesh directly;
    (e) ``head_shard_timing``.
    Returns the flash kernels' launches over (b) and (c); raises
    SystemExit on a failed check."""
    import tempfile

    import torch

    from repro_torch import configs
    from repro_torch.ckpt import manager as ckpt
    from repro_torch.data.tokens import batch_at
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.train import parse_mesh
    from repro_torch.models import lm
    from repro_torch.train import optim
    from repro_torch.train.step import TrainConfig, make_train_step

    sw = Stopwatch()
    failures = []
    flash = ("flash_attention", "flash_attention_bwd")

    def sharded(cfg, mesh, seed):
        ms = shd.mesh_shape_dict(mesh)
        return shd.shard(lm.init(cfg, torch.Generator(device=dev).manual_seed(
            seed)), shd.named(mesh, lm.param_specs(cfg, ms)))

    # (a) GPipe
    gpipe = gpipe_checks(dev)
    if not all(g["ok"] for g in gpipe):
        failures.append(f"(a) gpipe_apply: {gpipe}")
    sw.lap("gpipe")

    # (b) the reference test's config on (2, 2, 2)
    cfg = lm.LMConfig(**TM_DIST)
    tcfg = TrainConfig(microbatches=2, adamw=optim.AdamWConfig(
        lr=1e-2, weight_decay=0.1, grad_clip=1.0, master_dtype=torch.float32))
    mesh = parse_mesh(TM_DIST_MESH, dev)
    params = sharded(cfg, mesh, 0)
    opt = optim.init(params, tcfg.adamw)
    step, one = make_train_step(cfg, tcfg, mesh), make_train_step(cfg, tcfg)
    got = dict.fromkeys(flash, 0)
    losses, loss_rel, params_err, close, far = [], 0.0, 0.0, True, 0
    for i in range(TM_DIST_STEPS):
        batch = on_device(dev, batch_at(0, i, 8, 32, cfg.vocab))
        p1, o1, m1 = one(shd.gather(params, dev), shd.gather(opt, dev),
                         batch)
        reset_counts()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        for k in flash:
            got[k] += counts[k]
        losses.append(float(m["loss"]))
        loss_rel = max(loss_rel, abs(losses[-1] - float(m1["loss"]))
                       / abs(float(m1["loss"])))
        ok, err, n = params_close(shd.gather(params, dev), p1)
        close &= ok
        params_err = max(params_err, err)
        far += n
    want = tm_expected(cfg, mesh, 8, 2, TM_DIST_STEPS)
    finite = all(math.isfinite(x) for x in losses)
    falling = statistics.mean(losses[-3:]) < statistics.mean(losses[:3])
    # the flash kernels at the shape a model shard of one coordinate gives
    # them: its rows of a microbatch, its query heads over its KV heads
    ms = shd.mesh_shape_dict(mesh)
    m_size, rows = ms["model"], 8 // 2 // tm_coords(ms, 8 // 2)
    gen = torch.Generator(device=dev).manual_seed(23)
    hq, hkv = cfg.n_heads // m_size, cfg.n_kv_heads // m_size
    q, dout = (torch.randn((rows, 32, hq, cfg.d_head), generator=gen,
                           device=dev) for _ in range(2))
    k, v = (torch.randn((rows, 32, hkv, cfg.d_head), generator=gen,
                        device=dev) for _ in range(2))
    shard_check = {"shape": f"q ({rows}, 32, {hq}, {cfg.d_head}), k and v "
                   f"({rows}, 32, {hkv}, {cfg.d_head}) float32, causal",
                   **flash_pair_check(q, k, v, dout)}
    del q, k, v, dout
    if not (finite and falling and close and shard_check["ok"]) or \
            loss_rel > 1e-5 or got != want:
        failures.append(f"(b) losses finite {finite}, falling {falling}, "
                        f"loss {loss_rel}, params {params_err} ({far} "
                        f"far), launches {got} against {want}, kernels "
                        f"{shard_check}")
    dist = {"config": TM_DIST, "mesh": shd.mesh_shape_dict(mesh),
            "steps": TM_DIST_STEPS, "microbatches": 2, "losses": losses,
            "loss_rel_diff_max": loss_rel, "params_max_abs_diff": params_err,
            "params_far_elements": far,
            "head_shard_check": shard_check,
            "tp_layers": step.tp_layers, "launches": got,
            "launches_expected": want}
    launches = dict(got)
    del params, opt, p1, o1
    sw.lap("dist_config")

    # (c) stablelm-3b whole on the 2x2 mesh
    cfg = configs.config(TRAIN_ARCH)
    tcfg = TrainConfig()
    mesh = parse_mesh(TM_FULL_MESH, dev)
    ms = shd.mesh_shape_dict(mesh)
    batches = train_batches(cfg, TM_FULL_STEPS + 2)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    whole = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        one_loss = float(lm.forward(cfg, whole, on_device(dev,
                                                           batches[0]))[0])
    params = shd.shard(whole, shd.named(mesh, lm.param_specs(cfg, ms)))
    del whole
    opt = optim.init(params, tcfg.adamw)
    step = make_train_step(cfg, tcfg, mesh)
    torch.cuda.synchronize()
    sw.lap("full_init")
    losses, ms_step = [], []
    reset_counts()
    for b in batches[:TM_FULL_STEPS]:
        batch = on_device(dev, b)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        ms_step.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    counts = read_counts()
    got = {k: counts[k] for k in flash}
    peak = torch.cuda.max_memory_allocated()
    sw.lap("full_steps")
    from torch.profiler import ProfilerActivity, profile
    # the device's own events only: host tracing slows these host-bound
    # steps by more than half, so the idle share is taken against the
    # unprofiled steps' median
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[TM_FULL_STEPS:]:
            step(params, opt, on_device(dev, b))
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / 2
    dev_us = kernel_us(prof, 2)
    busy = sum(dev_us.values()) / 1e3 if dev_us else None
    copies = sum(v for k, v in dev_us.items()
                 if "copy" in k.lower() or "memcpy" in k.lower()) / 1e3
    sw.lap("full_profile")
    steady = statistics.median(ms_step[1:])
    want = tm_expected(cfg, mesh, TRAIN_BATCH, 1, TM_FULL_STEPS)
    finite = all(math.isfinite(x) for x in losses)
    rel0 = abs(losses[0] - one_loss) / abs(one_loss)
    if not finite or rel0 > 1e-3 or got != want:
        failures.append(f"(c) losses {losses} finite {finite}, step 0 "
                        f"against one device {rel0}, launches {got} "
                        f"against {want}")
    full = {"model": cfg.name, "mesh": ms, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "steps": TM_FULL_STEPS, "losses": losses,
            "one_device_loss_step0": one_loss, "step0_rel_diff": rel0,
            "ms_per_step": ms_step, "ms_per_step_median_after_1": steady,
            "profiled_ms_per_step": prof_ms,
            "device_busy_ms_per_step": busy,
            "device_idle_share": max(0.0, 1 - busy / steady)
            if busy else None,
            "copy_kernels_ms_per_step": copies,
            "top_device_ms_per_step": top_ms(dev_us, 10),
            "peak_memory_allocated_bytes": peak,
            "tp_layers": step.tp_layers, "launches": got,
            "launches_expected": want}
    for k in flash:
        launches[k] += got[k]
    del params, opt, prof
    free_card()

    # (d) the elastic restart
    cfg2 = dataclasses.replace(cfg, n_layers=TM_RESTART_DEPTH)
    mesh = parse_mesh(TM_FULL_MESH, dev)
    p = sharded(cfg2, mesh, 0)
    o = optim.init(p, tcfg.adamw)
    make_train_step(cfg2, tcfg, mesh)(p, o, on_device(dev, batches[0]))
    nxt = on_device(dev, batches[1])
    restart = {"depth": TM_RESTART_DEPTH, "saved_on": TM_FULL_MESH}
    with tempfile.TemporaryDirectory() as d:
        mgr = ckpt.CheckpointManager(d, keep=1)
        t0 = time.perf_counter()
        mgr.save_sync(1, (p, o))
        restart["save_s"] = time.perf_counter() - t0
        saved = shd.gather((p, o), dev)
        del p, o
        for spec in TM_RESTART_MESHES:
            m2 = parse_mesh(spec, dev)
            tp = sharded(cfg2, m2, 1)
            to = optim.init(tp, tcfg.adamw)
            shardings = (shd.shardings_of(tp), shd.shardings_of(to))
            t0 = time.perf_counter()
            (rp, ro), manifest = mgr.restore_latest((tp, to), shardings)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            del tp, to
            leaves_equal = tm_state_equal(shd.gather((rp, ro), dev), saved)
            direct = shd.shard(saved, shardings)
            s2 = make_train_step(cfg2, tcfg, m2)
            reset_counts()
            _, _, ma = s2(rp, ro, nxt)
            torch.cuda.synchronize()
            counts = read_counts()
            _, _, mb_ = s2(*direct, nxt)
            next_equal = bool(torch.equal(ma["loss"], mb_["loss"])) and \
                tm_state_equal(shd.gather((rp, ro), dev),
                               shd.gather(direct, dev))
            want = tm_expected(cfg2, m2, TRAIN_BATCH, 1, 1)
            got_r = {k: counts[k] for k in flash}
            restart[spec] = {"restored_step": manifest["step"],
                             "leaves_bitwise": leaves_equal,
                             "next_step_bitwise": next_equal,
                             "restore_s": restore_s, "launches": got_r,
                             "launches_expected": want}
            if not (leaves_equal and next_equal) or got_r != want:
                failures.append(f"(d) restore onto {spec}: {restart[spec]}")
            del rp, ro, direct
        del saved
    free_card()
    sw.lap("restart")

    # (e) the kernels at the head-shard shape
    timing = head_shard_timing(dev, sleep)
    sw.lap("head_shard_timing")
    emit({"phase": "train_mesh_main_path", "gpipe": gpipe, "dist": dist,
          "full": full, "restart": restart, "head_shard_timing": timing,
          "launches": launches, "failures": failures, **sw.fields()})
    if failures:
        raise SystemExit(f"train mesh path: {failures}")
    return launches


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--sc-compare"]:
        return sc_compare(Path(args[1]).resolve())
    if args[:1] == ["--cascade-compare"]:
        return cascade_compare(Path(args[1]).resolve())
    if args[:1] == ["--stride-compare"]:
        return stride_compare(Path(args[1]).resolve())
    if args[:1] in (["--sc-timing"], ["--cascade-timing"],
                    ["--stride-outputs"]):
        sys.path.insert(0, str(Path(args[1]).resolve() / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    if args[:1] == ["--sc-timing"]:
        return sc_timing_main(Path(args[1]).resolve())
    if args[:1] == ["--cascade-timing"]:
        return cascade_timing_main(Path(args[1]).resolve())
    if args[:1] == ["--stride-outputs"]:
        return stride_outputs_main(Path(args[1]).resolve(), Path(args[2]))
    if args[:1] == ["--table3-full"]:
        return table3_full_main()
    if args[:1] == ["--moe"]:
        return family_main("moe", moe_main_path)
    if args[:1] == ["--hymba"]:
        return family_main("hybrid", hymba_main_path)
    if args[:1] == ["--whisper"]:
        return family_main("encdec", whisper_main_path)
    if args[:1] == ["--obs"]:
        return obs_main()
    if args[:1] == ["--vlm"]:
        return family_main("vlm", vlm_main_path)
    if args[:1] == ["--rwkv"]:
        return family_main("rwkv", rwkv_main_path, ("sng_pack", "sc_dot"))
    if args[:1] == ["--decoders"]:
        return family_main(None, decoders_main_path)
    if args[:1] == ["--shard"]:
        return family_main("shard", shard_main_path)
    if args[:1] == ["--model-axis"]:
        return family_main("model_axis", model_axis_main)
    if args[:1] == ["--train"]:
        return family_main("train", train_main,
                           ("flash_attn", "flash_attn_bwd", "sng_pack",
                            "sc_dot"))
    if args[:1] == ["--train-mesh"]:
        return family_main("train_mesh", train_mesh_main_path,
                           ("flash_attn", "flash_attn_bwd"))

    from repro_torch.core import sng
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import sc_dot as sc_dot_k
    from repro_torch.kernels import sng_pack as sng_pack_k
    from repro_torch import configs
    from repro_torch.serve.gateway import frontend as fe
    from repro_torch.serve.gateway.gateway import (GatewayConfig,
                                                   MicroBatchGateway)
    from repro_torch.serve.gateway.sensors import FleetConfig, SensorFleet

    dev = torch.device("cuda")
    sc_kernels = ("sng_pack", "sc_dot")

    # -- 1. the card ---------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    emit({"gpu": smi, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "sms": props.multi_processor_count,
          "max_sm_clock_mhz": clock_mhz, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    clk_sm = clock_mhz * 1e6 * props.multi_processor_count

    # -- 2. build: every source's nvcc started together; the attention
    # libraries are waited for first, and the SC ones (sc_dot takes about a
    # minute) after phase 3's attention checks and phases 5-8, which need
    # none
    t0 = time.perf_counter()
    build.start(SOURCES)
    attn_sources = ("paged_attn", "cascade_attn", "flash_attn",
                    "flash_attn_bwd")
    logs = build.build_all(attn_sources)
    attn_build_s = time.perf_counter() - t0
    # the redesigned attention kernels' instructions: tensor-core products
    # (HMMA), asynchronous copies (LDGSTS, cp.async) and ldmatrix (LDSM)
    sass = {name: sass_counts(name, ("HMMA", "LDGSTS", "LDSM"))
            for name in ("flash_attn", "flash_attn_bwd", "paged_attn",
                         "cascade_attn")}
    emit({"sass": sass})
    if not (sass["flash_attn"]["HMMA"] and sass["flash_attn"]["LDGSTS"]
            and all(sass["flash_attn_bwd"].values())
            and sass["paged_attn"]["LDGSTS"]
            and sass["cascade_attn"]["LDGSTS"]):
        raise SystemExit(f"the attention kernels lack tensor-core or "
                         f"asynchronous-copy instructions: {sass}")

    # -- 3. each kernel against its plain version: the attention kernels --
    sw = Stopwatch()
    sleep = int(SLEEP_S * clock_mhz * 1e6)  # 50 ms of the SM clock
    gen_attn = torch.Generator(device=dev).manual_seed(3)
    paged_err, paged_timing = paged_kernel_checks(dev, gen_attn, sleep)
    sw.lap("paged")
    cascade_err, cascade_timing = cascade_kernel_checks(dev, gen_attn, sleep)
    sw.lap("cascade")
    flash_err, flash_timing = flash_kernel_checks(dev, gen_attn, sleep)
    sw.lap("flash")
    attn_seconds = sw.fields()

    # -- 5. the prompt path (while the SC libraries build) -----------------
    paths = {}
    paths["prompt"], lm_cfg, lm_params = lm_main_path(
        dev, paged_timing["paged_decode_attention"]["ms"])

    # -- 6. the cascade tick ---------------------------------------------------
    paths["cascade"] = cascade_main_path(dev, lm_cfg, lm_params,
                                         eager_profile=False)

    # -- 7. the chunked prefill fold ----------------------------------------
    paths["chunked"] = chunked_main_path(dev, lm_cfg, lm_params)["launches"]

    # -- 8. the captured ticks against their eager steps ------------------
    capture_main_path(dev, lm_cfg, lm_params)

    # -- 2, continued: the SC libraries, built meanwhile --------------------
    t1 = time.perf_counter()
    logs.update(build.build_all(("sng_pack", "sc_dot")))
    build_s = time.perf_counter() - t0
    emit({"build_s": build_s, "attention_build_s": attn_build_s,
          "sc_build_wait_s": time.perf_counter() - t1, "ptxas": {
              name: [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln]
              for name, log in logs.items()}})
    # the SC kernels: popcounts, cp.async, b1 tensor-core products (BMMA),
    # and every function's stack frame, which must be 0 bytes: the TFF tree
    # and the stream table live in registers and shared memory
    sc_sass = {"sc_dot": sass_counts("sc_dot", ("POPC", "LDGSTS", "BMMA")),
               "sng_pack": sass_counts("sng_pack", ("VOTE", "POPC"))}
    frames = {name: stack_frames(name) for name in ("sc_dot", "sng_pack")}
    framed = {fn: b for f in frames.values() for fn, b in f.items() if b}
    emit({"sc_sass": sc_sass,
          "stack_frames": {name: {"functions": len(f),
                                  "bytes": sorted(set(f.values()))}
                           for name, f in frames.items()},
          "ptxas": {name: ptxas_of(name, "_kernel") for name in frames}})
    if not (sc_sass["sc_dot"]["POPC"] and sc_sass["sc_dot"]["LDGSTS"] and
            sc_sass["sc_dot"]["BMMA"]):
        raise SystemExit(f"sc_dot lacks its instructions: {sc_sass}")
    if not all(frames.values()) or framed:
        raise SystemExit(f"an SC kernel keeps a stack frame: {framed}")

    # -- 3, continued: the SC kernels against their plain versions --------
    sw = Stopwatch()
    gen = torch.Generator(device=dev).manual_seed(0)
    err, checks = sc_kernel_checks(dev, gen)
    bad = [c for c in checks if not c["bitwise"]]
    sw.lap("sc_checks")
    sc = sc_timing(dev, sleep, clk_sm)
    # the plain versions at the main path's shapes (K = 25, two banks of 32)
    plain = {}
    for bits in (4, 8):
        N = 1 << bits
        Wd = max(1, N // 32)
        lv = torch.randint(0, N + 1, (SC_M, SC_K), generator=gen,
                           dtype=torch.int32, device=dev)
        codes = sng.codes_tensors("ramp_lowdisc", bits, dev)[0]
        x = stream_words(gen, (SC_M, SC_K, Wd), N)
        w = stream_words(gen, (SC_K, 64, Wd), N)
        plain[("sng_pack", bits)] = time_ms(
            lambda: ref.sng_pack(lv, codes, N), 3, 2, sleep, b2b=False)[0]
        plain[("sc_dot", bits)] = time_ms(
            lambda: ref.sc_dot(x, w, "alt", "tff"), 3, 1, sleep, b2b=False)[0]
    # the path's own rows: bits 4, the full LeNet-5's O = 64, K = 25, the
    # kernel as the SC layer calls it (two banks)
    timing = {(row["kernel"], row["bits"]):
              dict(row, plain_ms=plain[(row["kernel"], row["bits"])])
              for row in sc["rows"] if row["kernel"] == "sng_pack" or (
                  row["O"] == 64 and row["K"] == SC_K and
                  row["route"] == "posneg")}
    emit({"phase": "kernel_checks", "checks": len(checks), "failed": bad,
          "max_abs_err": err, "b1_mma_per_s": sc["b1_mma_per_s"],
          "timing": sc["rows"],
          "plain_ms": {f"{k}_bits{b}": v for (k, b), v in plain.items()}})
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    sw.lap("sc_timing")
    emit({"sc_frontend_timing": sc_frontend_timing(dev, sleep, clk_sm,
                                                   sc["b1_mma_per_s"])})
    sw.lap("sc_frontend_timing")
    for e in (paged_err, cascade_err, flash_err):
        err.update(e)
    sc_seconds = sw.fields()
    emit({"phase": "kernels_seconds",
          "seconds": {**attn_seconds["seconds"], **sc_seconds["seconds"]},
          "phase_s": attn_seconds["phase_s"] + sc_seconds["phase_s"]})

    # -- 4. the frame path --------------------------------------------------
    sw = Stopwatch()
    trace = SensorFleet(FleetConfig(seed=7)).events(TRACE_SECONDS)
    paths["frame"] = {name: 0 for name in sc_kernels}
    for bits in (4, 8):
        spec = fe.FrontendSpec(mode="sc", bits=bits,
                               lenet=configs.config("lenet5"))
        gw = MicroBatchGateway(GatewayConfig(), spec, seed=0, device="cuda")
        gw.warmup()
        captured = gw.compile_counts()
        reset_counts()
        t0 = time.perf_counter()
        tel = gw.run(trace)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = {name: read_counts()[name] for name in sc_kernels}
        for name in sc_kernels:
            paths["frame"][name] += counts[name]
        if not all(counts.values()):
            raise SystemExit(f"bits={bits}: a kernel of the main path never "
                             f"launched: {counts}")
        # two captured steps per bucket after warmup, none added by traffic
        captures = {"after_warmup": captured,
                    "after_trace": gw.compile_counts()}
        if any(v != 2 for v in captured.values()) or \
                captures["after_trace"] != captured:
            raise SystemExit(f"bits={bits}: capture counts {captures}, "
                             "expected 2 per bucket, unchanged by the trace")
        # every frame is served or dropped, each charged the same frame +
        # link energy and payload bytes as the reference charges
        per_frame = fe.frame_energy_nj(spec) + \
            fe.link_energy_nj(fe.link_bytes_per_frame(spec))
        if len(tel.records) + len(tel.dropped) != len(trace) or any(
                r.energy_nj != per_frame or
                r.link_bytes != fe.link_bytes_per_frame(spec) or
                not 0 <= r.output < spec.lenet.classes for r in tel.records):
            raise SystemExit(f"bits={bits}: telemetry does not account for "
                             "the trace")

        # one batch: kernel path vs plain path on the card vs the CPU
        frames = torch.from_numpy(np.stack([a.payload for a in trace[:32]]))
        x = frames.to(dev)
        payload = fe.sensor_stage(gw.params, x, spec)
        logits = fe.gateway_stage(gw.params, payload, spec)
        def plain_sc_dot(x, w, s0_mode="alt", adder="tff", *, length=None):
            return ref.sc_dot(x, w, s0_mode, adder)
        with mock.patch.object(sng_pack_k, "sng_pack", ref.sng_pack), \
                mock.patch.object(sc_dot_k, "sc_dot", plain_sc_dot):
            plain_payload = fe.sensor_stage(gw.params, x, spec)
        cpu_params = {k: {n: t.cpu() for n, t in v.items()}
                      for k, v in gw.params.items()}
        cpu_payload = fe.sensor_stage(cpu_params, frames[:8], spec)
        cpu_logits = fe.gateway_stage(cpu_params, cpu_payload, spec)
        torch.cuda.synchronize()
        same_plain = torch.equal(payload, plain_payload)
        same_cpu = torch.equal(payload[:8].cpu(), cpu_payload)
        logit_err = float((logits[:8].cpu() - cpu_logits).abs().max())
        close = torch.allclose(logits[:8].cpu(), cpu_logits, atol=1e-4,
                               rtol=1e-4)
        finite = bool(torch.isfinite(logits).all()) and \
            tuple(logits.shape) == (32, spec.lenet.classes)

        # the captured bucket-32 stages against their eager calls on the
        # same frames: payload byte for byte, logits bit for bit, the same
        # launches
        replay = frame_replay_check(gw, frames.numpy())
        replay["payload_equal_eager_stage"] = bool(torch.equal(
            replay.pop("payload"), payload))
        # host ms per stage and bucket, captured (a replay) and eager (the
        # step's fn on the same static inputs), in turns
        stage_ms = {bs: frame_stage_turns(gw, frames[:bs].numpy())
                    for bs in gw.cfg.bucket_sizes}
        # the device under bucket-32 sensor stages, captured and eager, and
        # the SC launches of one captured stage
        f32 = frames[:32].numpy()
        sensor = gw._sensor_fns[32]
        reset_counts()
        sensor(f32)
        torch.cuda.synchronize()
        stage_launches = {name: read_counts()[name] for name in sc_kernels}
        profile = profile_stages(lambda: sensor(f32), 10)
        profile_eager = profile_stages(
            lambda: sensor.fn(*sensor.load(f32)), 10)
        rep = tel.report(TRACE_SECONDS)
        emit({"phase": "main_path", "bits": bits, "frames": len(trace),
              "served": len(tel.records), "dropped": len(tel.dropped),
              "run_s": run_s, "launches": counts,
              "payload_equal_plain_on_card": same_plain,
              "payload_equal_cpu": same_cpu,
              "logits_max_abs_err_vs_cpu": logit_err,
              "logits_close_1e-4": close, "logits_finite_shape": finite,
              "j_per_frame": rep.get("j_per_inference"),
              "link_bytes_per_frame": rep.get("link_bytes_per_req"),
              "p50_latency_ms": rep.get("p50_latency_ms"),
              "p99_latency_ms": rep.get("p99_latency_ms"),
              "captures": captures, "replay_bucket32": replay,
              "stage_ms_by_bucket": stage_ms,
              "sc_launches_per_stage": stage_launches,
              "profile_bucket32": profile,
              "profile_bucket32_eager": profile_eager})
        if not (same_plain and same_cpu and close and finite):
            raise SystemExit(f"bits={bits}: the served output disagrees with "
                             "the plain path")
        if not all(replay[k] for k in ("payload_bitwise", "logits_bitwise",
                                       "launches_equal",
                                       "payload_equal_eager_stage")):
            raise SystemExit(f"bits={bits}: a replayed stage differs from "
                             f"its eager call: {replay}")
        if profile["graph_launches_per_stage"] != 1:
            raise SystemExit(f"bits={bits}: a captured stage issued "
                             f"{profile['graph_launches_per_stage']} graph "
                             "launches")
        sw.lap(f"bits{bits}")
    emit({"phase": "frame_path_seconds", **sw.fields()})

    # -- 9. the retraining pipeline (Table 3) ---------------------------------
    paths["retrain"] = retrain_main_path(dev, TABLE3_FAST)

    # -- 10. the dense path, the gather oracle and the SC frontend ---------
    paths["dense"], paths["sc"] = dense_main_path(dev, lm_cfg, lm_params,
                                                  eager_profile=False)

    # -- 14. observability on the frame path and the prompt path ---------
    # (run here, while stablelm-3b's weights are on the card)
    paths["obs"] = obs_main_path(dev, lm_cfg, lm_params)

    # -- 18. sharded and disaggregated serving --------------------------------
    # (run here, on stablelm-3b's weights, shared by every slice)
    base: dict = {}
    paths["shard"] = shard_main_path(dev, sleep, lm_cfg, lm_params, base)

    # -- 20. sharded serving's model axis (slices of 2 and 4 devices) -------
    paths["model_axis"] = model_axis_main_path(dev, sleep, lm_cfg,
                                               lm_params, base)
    del base

    # -- 11. the moe family: deepseek-moe-16b ------------------------------
    del lm_params
    torch.cuda.empty_cache()
    paths["moe"] = moe_main_path(dev, sleep)

    # -- 12. the hybrid family: hymba-1.5b -----------------------------------
    paths["hybrid"] = hymba_main_path(dev, sleep)

    # -- 13. the encdec family: whisper-medium -------------------------------
    paths["encdec"] = whisper_main_path(dev, sleep)

    # -- 15. the vlm family: llama-3.2-vision-90b at 20 layers ---------------
    paths["vlm"] = vlm_main_path(dev, sleep)

    # -- 16. the rwkv family: rwkv6-7b ----------------------------------------
    paths["rwkv"] = rwkv_main_path(dev, sleep)

    # -- 17. starcoder2-15b, deepseek-67b, llama3-405b and the int8 layout ----
    paths.update(decoders_main_path(dev, sleep))

    # -- 19. training: the backward kernel, then stablelm-3b trained -------
    free_card()
    bwd_err, bwd_timing = bwd_kernel_checks(dev, sleep)
    err.update(bwd_err)
    paths["train"] = train_main_path(dev, sleep)

    # -- 21. the training meshes: ZeRO-1, the model axis, GPipe, elastic
    # restore, every mesh device the one card
    free_card()
    paths["train_mesh"] = train_mesh_main_path(dev, sleep)

    # -- the result ---------------------------------------------------------
    sources = {"sng_pack": ("src/repro_torch/kernels/csrc/sng_pack.cu",
                            "src/repro/kernels/sng_pack.py:33"),
               "sc_dot": ("src/repro_torch/kernels/csrc/sc_dot.cu",
                          "src/repro/kernels/sc_dot.py:80"),
               "paged_decode_attention": (
                   "src/repro_torch/kernels/csrc/paged_attn.cu",
                   "src/repro/kernels/paged_attn.py:179"),
               "scatter_kv_rows": (
                   "src/repro_torch/kernels/csrc/paged_attn.cu",
                   "src/repro/kernels/paged_attn.py:135"),
               "paged_decode_attention_with_state": (
                   "src/repro_torch/kernels/csrc/paged_attn.cu",
                   "src/repro/kernels/paged_attn.py:298"),
               "cascade_prefix_attention": (
                   "src/repro_torch/kernels/csrc/cascade_attn.cu",
                   "src/repro/kernels/paged_attn.py:419"),
               "merge_attn_states": (
                   "src/repro_torch/kernels/csrc/cascade_attn.cu",
                   "src/repro/kernels/paged_attn.py:486"),
               "flash_attention": (
                   "src/repro_torch/kernels/csrc/flash_attn.cu",
                   "src/repro/kernels/flash_attn.py:74"),
               # no Pallas kernel: the reference's XLA backward of its
               # flash attention (_flash_bwd; _sliding_bwd at :295)
               "flash_attention_bwd": (
                   "src/repro_torch/kernels/csrc/flash_attn_bwd.cu",
                   "src/repro/nn/attention.py:161")}
    results = {name: dict(timing[(name, 4)], library_ms=None)
               for name in sc_kernels}
    results.update(paged_timing)
    results.update(cascade_timing)
    # the chunked path's own shape: a fold chunk
    results["flash_attention"] = flash_timing["fold_chunk"]
    # the train path's own shape: stablelm-3b's train step
    results["flash_attention_bwd"] = bwd_timing[next(iter(BWD_SHAPES))]

    def row(name: str) -> dict:
        # kernel 7 runs on the path fused into kernel 5's epilogue: its
        # launches are the fused merges, its ms their marginal cost
        count = FUSED_MERGE if name == "merge_attn_states" else name
        out = {"name": name, "route": "cuda", "source": sources[name][0],
               "replaces": sources[name][1],
               "launches": paths[HOME_PATH[name]][count],
               "launches_by_path": {p: c.get(count, 0)
                                    for p, c in paths.items()},
               "max_abs_err": err[name], "ms": results[name]["ms"],
               "plain_ms": results[name]["plain_ms"],
               "bound_ms": results[name]["bound_ms"],
               "bound_by": results[name]["bound_by"],
               "library_ms": results[name]["library_ms"],
               "shape": results[name]["shape"]}
        if count != name:
            out.update(fused_into=results[name]["fused_into"],
                       standalone_ms=results[name]["standalone_ms"],
                       standalone_launches_by_path={
                           p: c.get(name, 0) for p, c in paths.items()})
        return out
    emit({"script_s": time.perf_counter() - T_START})
    emit({"kernels": [row(name) for name in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root; one CUDA card, nvcc

Sixteen paths: the compiled VGG-16 executor (phases 3-5, and split over
two shards in phase 15), serving smollm-135m (phases 3, 6 and 7; streaming,
paged and faulted in phases 16-17) at 3 of its 30 layers and serving
xlstm-350m (phases 3, 8 and 9) at 2 of its 24, both at their full published
widths, the paper's Tab. IV evaluation and design-space sweep (phases
10-12), VGG-16 compiled around faults and from a searched mapping (phases
13-14), serving dbrx-132b at full width with its depth cut to 2 layers
(phases 18-19), serving zamba2-1.2b at full width with its depth cut to 6
layers, contiguous and paged (phases 20-21), and the model's own prefill
and decode of llama-3.2-vision-90b at full width cut to 2 of its 20 groups
(phases 22-23) and of musicgen-large at 6 of its 48 layers (phases 24-25),
which no engine serves, and training smollm-135m at 5 of its 30 layers
(phase 26), xlstm-350m at 2 of its 24 (phase 27), zamba2-1.2b at 6 of its
38 (phase 28), dbrx-132b at full width with its depth cut to 1 layer (phase
29), llama-3.2-vision-90b at full width with its depth cut to 1 of its
20 groups (phase 30) and musicgen-large at 3 of its 48 layers (phase 31),
and the COM ring and data/pod-parallel training over torch.distributed
(phase 32: ranks on the one card in a gloo group, and a one-rank NCCL
group). Every cut depth (SERVE_CUT, TRAIN_CUT, XLSTM_CUT, HYBRID_CUT,
HYBRID_SERVE_CUT, AUDIO_CUT, AUDIO_TRAIN_CUT, MOE_LAYERS, MOE_TRAIN_LAYERS,
VLM_LAYERS and VLM_TRAIN_CUT) is in its phase lines' "reduced"; it keeps the script's phases near two
thirds of its time limit.
Phases, each printing JSON lines:

1. card      — the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build     — the four CUDA kernels built from src/repro_torch/csrc/*.cu for
               sm_90a, one nvcc each, started together: seconds taken and the
               ptxas -v report;
3. kernels   — each kernel against its plain PyTorch version at every shape the
               main paths give it (the 16 VGG-16 products of a B=8 forward for
               com_matmul, the 13 VGG-16 per-image convolutions for conv2d_com,
               smollm's batch-1 prefill attention at S = 128, 517, 1024, 2048 and
               at every prompt length the serve phase prefills, dbrx-132b's
               (48 heads, 8 KV heads, hd 128) at S = 128 and 512 and
               zamba2-1.2b's (32 heads, 32 KV heads, hd 64) at S = 1024,
               llama-3.2-vision-90b's 8-row cross attention (64 heads, 8 KV
               heads, hd 128, non-causal, Skv = 1,601 image tokens) at
               Sq = 1 (a decode step) and 512 (a prefill) and its self
               attention at S = 512, musicgen-large's 8-row prefill (32
               heads, 32 KV heads, hd 64) at S = 512, in
               bfloat16 and float32, for flash_attention; xlstm-350m's batch-1 prefill recurrence
               (1, S, 4, 1024) with 4 heads of 256 at S = 128, 517, 1024 and at
               every prompt length the xlstm serve phase prefills, for
               slstm_fused) plus the epilogue, stride-2, 5x5, bf16,
               non-causal, head_dim-128, head_dim-32 (the reduced configs'),
               B = 2 and S = 1 cases, slstm_fused at hd 32 (a cluster of
               one) and at hd 512 (the stream path), and an inf and a
               near-overflow operand through com_matmul on its streaming and
               tensor-core paths (com_matmul_ref's infinities, NaNs and finite
               values): errors, kernel, plain and library times (CUDA events),
               and the bound; each line also gives the launch plan it ran
               (the kernels' plan functions); com_matmul, conv2d_com and
               flash_attention lines give bound_3xtf32_ms (three TF32 passes at
               495 TFLOP/s against the bytes at 3.35 TB/s, float32); flash and
               slstm lines give graph_ms, the device time alone (calls replayed
               from a CUDA graph: no host time between launches; for flash also
               SDPA's), and slstm lines the time a step; a second flash call,
               and one where a plan splits K, must return the same bits;
               flash_attention_bwd (the backward kernels) against
               flash_attention_bwd_ref on the same (q, k, v, out, lse, dout)
               at the train phase's (8, 2048, 9, 3, 64), at S = 517 (B = 2),
               hd 32 and 128 and one non-causal case, float32 (rtol 1e-3,
               atol 1e-4 of max|plain|, tests/test_layers.py:121) and
               bfloat16 (2e-2 of max|plain|; each element's error over one
               rounding reported), and both kernels at the train-hybrid
               and train-audio phases' (8, 2048, 32, 32, 64), the train-moe phase's
               (8, 2048, 48, 8, 128) and the train-vlm phase's self
               (8, 2048, 64, 8, 128; bfloat16) and cross shapes (Sq 2,048
               against Skv 1,601 = 25 x 64 + 1 keys, non-causal; the
               forward writing lse) and the backward at a small ragged
               Sq 300 against Skv 77: a second call's bits, the
               forward's out bitwise with and without lse, lse against the
               plain lse; ms,
               graph_ms, the bound (5 products of 2 hd flop a kept pair),
               plain and SDPA's backward (library_ms, host included, and
               library_graph_ms, its backward alone replayed from a CUDA
               graph), the plan's path (bfloat16 "wgmma", float32
               "mma_sync_3xtf32") and MMA passes a pair, and each backward
               kernel's registers and spills (ptxas); the backward checks
               run under a time limit of their own (BWD_CHECK_S), so that a
               kernel stuck on an mbarrier fails the run loudly;
4. e2e       — compile_program(vgg16_imagenet()), random_weights(seed=0), 8 images
               from numpy.random.default_rng(1): the executor's "cuda" backend
               held against its float64 "reference" backend on the card, events
               against event_totals, com_matmul launches per forward, images/s
               and peak memory; then the direct-convolution path (ops.conv2d per
               image and layer, ops.com_matmul for the FC layers) held against
               the same reference;
5. profile   — a torch.profiler window over one forward: device busy time, idle
               share and the kernels by time; fails if a cuBLAS, cuDNN or
               CUTLASS kernel ran in it (every product is the port's own);
6. serve     — smollm-135m (d_model 576, 9 heads, 3 KV heads, vocab 49152,
               tied) with its 30 layers cut to 3 (SERVE_CUT, the line's
               "reduced"), bf16, weights drawn from seed 0: 16 greedy
               requests with prompt lengths from numpy.random.default_rng(2)
               uniform in 128-1024, 64 new tokens each, 8 slots, max_seq 2048,
               through Engine.generate: wall time, tokens/s, median TTFT and
               decode step, peak memory, flash_attention launches (3 per
               prefill); the tokens against Engine.generate_sequential; the
               last-token logits of every request's prefill against the same
               model with the plain attention, in float32 and in bfloat16;
7. profile-serve — a torch.profiler window over one prefill and one decode step;
               fails if a library attention kernel (flash_fwd, fmha,
               efficient_attention, cuDNN) runs in the prefill;
8. serve-xlstm — xlstm-350m (d_model 1024, 4 heads of 256, vocab 50304,
               untied) with its 24 layers (12 [mLSTM, sLSTM] pairs) cut to 2
               (XLSTM_CUT, the line's "reduced"), bf16, weights drawn
               from seed 0, the same 16-request wave as phase 6: the same
               numbers, slstm_fused launches (1 per prefill, each a cluster of
               8 CTAs per head), the tokens
               against generate_sequential; then, on four of the prompts (the
               shortest, the longest, two between: the plain recurrence is a
               loop of ~20 launches a step), the last-token prefill logits
               against the same model with the plain recurrence
               (CallConfig.kernel_backend="ref") in float32, every sLSTM layer
               of those prefills against the plain recurrence on its own
               inputs in float32 and bfloat16, and the bfloat16 logits beside
               the plain version's own rounding noise (reported, not gated:
               see logits_xlstm);
9. profile-serve — the same two windows for xlstm-350m;
10. tab4     — repro_torch.launch.table_iv.run() for the com and minimal_buffer
               dataflows: the com rows within the reference's bands of the
               paper's Tab. IV (CE within 25 %, off-chip under 10 % of the
               power, CE improvement in 1.3-2.6x; tests/test_simulator.py:93-108),
               the rival's under 10 % off-chip and below COM's CE; then
               DominoModel(vgg16-imagenet).functional_forward on the card with
               phase 4's weights and images: its logits bit for bit phase 4's,
               its events the program's, 16 com_matmul launches;
11. comgrid  — COMGridSim in float64 on the card at full VGG-16 width, on the
               first 14x14x512 -> 512 conv (2 x 2 blocks) and on FC0 (25088 ->
               4096, 98 x 16 blocks, 0.82 GB of float64 weights), phase 4's
               weights: within rtol = atol = 1e-10 of reference_conv /
               reference_fc (tests/test_simulator.py:39), events equal to
               conv_events / fc_events; sim and oracle ms;
12. sweep    — smoke_1e6_grid() (1,002,240 scenarios): the cold batch build
               (216 compiles), then the NumPy oracle (full and in chunks of
               65536) and the torch backend on the card (full and chunked, each
               twice), every column within 1e-6 of the oracle
               (tests/test_sweep_backends.py:26), batch-build and backend
               seconds and scenarios/s apart; the oracle against the scalar
               path (DominoModel.evaluate) at 1e-9 on 1,000 sampled scenarios;
13. faults   — compile_program(vgg16_imagenet(), faults=FaultSet.empty()) is
               the pristine program, and its executor gives phase 4's logits
               bit for bit; then FaultSet.sample(0.002, seed=0, n_chips=9 + 6
               spares, cell_rate=0.002) with a dropped block on conv0 and on
               fc0: the degraded placement (validate_fault_allocs), its chips
               and off-chip J per image against the pristine program's, the
               host seconds of the compile and of the weight-fault realization,
               then both executor backends on the one faulted weight list
               (phase 4's weights and images): logits within 2e-5 · max|ref|,
               equal fault_info, events equal to event_totals, 16 com_matmul
               launches, images/s, argmax agreement with the clean logits;
14. search   — search_mapping(vgg16, budget=96, seed=0) with evolve and anneal
               (host seconds, hop-energy ratio to greedy, never above 1), then
               compile_program(mapping="searched") (budget 256); the greedy and
               searched candidates' Tab. IV columns through
               PopulationEvaluator.columns on the card within 1e-6 of NumPy;
               the searched program and a custom-blocked one (the widest
               layer's block_c halved: more tiles) through both backends: the
               same checks as phase 13, "cuda" logits bit for bit phase 4's
               (the im2col path does not read the block partition), reference
               logits within rtol 1e-9, atol 1e-12 of phase 4's
               (tests/test_search.py:290-292);
15. e2e-shard — phase 4's program, weights and images through
               ProgramExecutor(shard="auto") (one card: n_shards 1, logits bit
               for bit phase 4's), then shard=[cuda:0, cuda:0] (n_shards 2, two
               shards of 4 images, 32 com_matmul launches): logits within
               2e-5 · max|ref| of the float64 reference and bit for bit phase
               4's unless a layer's com_matmul plan (split-K) changes at the
               shard's rows; the layers whose plans change, images/s;
16. serve-traffic — phase 6's smollm-135m (SERVE_CUT), bf16, weights from seed 0,
               through simulate(check=True) on Engine(batch=8, max_seq=544,
               page_size=16, pool_pages=96) (35 % of the 272 pages a contiguous
               pool needs) with the profile chip-burst-24 (24 greedy requests in
               bursts of 8, prompts of 128/256/512 and budgets of 8/16/32
               tokens weighted 1:2:1, admission deadline 40 ticks):
               matches_sequential, the virtual-clock payload equal to the JAX
               package's numbers (TRAFFIC_CLOCK), flash_attention launches (one
               a layer a prefill), wall time, tokens/s, decode step, page gather and
               scatter times, peak memory;
17. serve-faults — chip-burst-24-patient (no deadline) through Engine.serve on
               that engine, fault-free and with TransientFaults(slot_rate=0.05,
               page_rate=0.002, seed=0) under RestartPolicy(max_restarts=10000,
               backoff_s=1, backoff_mult=1): counters and makespans equal to the
               JAX package's (FAULTS_CLOCK), a flash launch a layer a prefill
               and a re-prefill; in bf16 the tokens of every request whose slot never
               failed, and of each retried request up to its first retry, equal
               the fault-free run's (a re-prefill's KV rows round otherwise
               than the decode steps' on the card), how many retried requests
               stay identical reported; in float32 (3xTF32 flash) the first
               burst of 8 requests token-identical with and without faults;
               a poisoned token halts with the reference's RuntimeError;
18. serve-moe — dbrx-132b at its published widths (d_model 6144, 48 heads, 8
               KV heads, d_ff 10752, 16 experts top-4, vocab 100352, rope
               theta 5e5) with its 40 layers cut to 2 (the line's "reduced";
               ~29 GiB of float32 weights), bf16, weights from seed 0,
               capacity_factor 4.5 (the engine guard's drop-free value for
               8 slots): 8 greedy requests, prompts uniform in 128-512 from
               numpy.random.default_rng(2), 32 new tokens each, 8 slots,
               max_seq 1024, through Engine.generate: phase 6's numbers,
               2 flash_attention launches a prefill, the tokens against
               generate_sequential, no expert choice dropped (served run and
               oracle); every prefill's last-token logits with the kernel
               against the plain attention: float32 within 2e-5 of
               max|plain|, bfloat16 within 2e-2 with the expert choices
               pinned to the plain run's, and unpinned reported beside the
               (layer, token) pairs whose experts differ;
19. profile-serve — the same two windows for dbrx-132b (its first prompt);
20. serve-hybrid — zamba2-1.2b at full width (Mamba2 blocks of 64 SSD heads
               of 64, state 64, chunk 256, in groups of 6 each followed by
               the shared attention + MLP block, then tail blocks; d_model
               2048, vocab 32000) with its 38 layers cut to 6 (1 of its 6
               groups, no tail block: HYBRID_SERVE_CUT, the lines'
               "reduced"), bf16, weights from
               seed 0, on phase 6's wave:
               phase 6's numbers, 1 flash_attention launch a prefill, the
               tokens against generate_sequential; every prefill's float32
               last-token logits with the kernel within 1e-4 of max|plain|
               (the state-space families' tolerance, tests/test_layers.py:95:
               the attention's float32 rounding carries through the blocks,
               and both paths stand as far from a float64 attention, which
               the line reports), every flash_attention call of those
               prefills within one rounding of the plain attention on its
               own inputs in both dtypes, the bfloat16 logits reported beside
               the plain path's own distance to the float64 attention; then
               the first burst of chip-burst-24-patient (8 requests) through
               simulate(check=True) on Engine(batch=8, max_seq=544,
               page_size=16, pool_pages=96), the KV rows paged and the Mamba2
               states dense per slot: matches_sequential, the virtual clock
               equal to the JAX package's (FAULTS_CLOCK), 1 flash launch a
               prefill, decode step, gather and scatter times;
21. profile-serve — the same two windows for zamba2-1.2b;
22. model-vlm — llama-3.2-vision-90b at its published widths (d_model 8192,
               64 heads, 8 KV heads, d_ff 28672, vocab 128256, rope theta 5e5,
               1,601 image tokens) with its 100 layers cut to 10, 2 of its 20
               groups of 4 self layers and 1 cross layer (the line's
               "reduced"; 39.7 GiB of float32 weights), bf16, weights from
               seed 0, image embeddings from synth_image_embeds with seed 1:
               8 rows of a 512-token prompt (numpy.random.default_rng(2)) and
               one image each, one prefill and 32 greedy decode steps in
               lockstep (a shared position) through Model.prefill /
               decode_step: prefill ms, TTFT, decode-step ms, decode tokens/s,
               peak memory, flash_attention launches (10 a prefill, 2 a decode
               step: the cross layers at Sq = 1); the same run with the plain
               attention and how many greedy tokens agree; the prefill's
               last-token logits of the kernel path against the plain
               attention, float32 on 2 rows within 2e-5 of max|plain|, every
               flash call of those prefills within one rounding of plain on
               its own inputs (both dtypes), bfloat16 on every row within
               2e-2 unless the plain attention itself stands further from a
               float64 attention (then reported, and the line says which case
               held); prefill(t[:512]) + decode_step(t[512]) against
               forward(t) in float32 within rtol = atol = 2e-2
               (tests/test_models.py:86-98), the distance reported;
23. profile-serve — the 8-row prefill's and decode step's windows for it;
24. model-audio — musicgen-large (d_model 2048, 32 heads, d_ff 8192,
               layernorm, gelu, 4 codebooks of 2048) with its 48 layers cut to
               6 (AUDIO_CUT, the line's "reduced"), bf16, weights
               from seed 0: 8 rows of 512 frames x 4 codebooks
               (numpy.random.default_rng(3)), one prefill and 64 greedy decode
               steps, each feeding back every codebook's argmax as the
               (B, 1, K) token: phase 22's numbers and gates, 6
               flash_attention launches a prefill and none a step;
25. profile-serve — the same two windows for it;
26. train    — smollm-135m at 5 of its 30 layers (TRAIN_CUT, the line's
               "reduced"; phase 6's widths), bfloat16 compute on float32
               master weights, CallConfig(remat="block"), weights from seed 0,
               OptConfig(lr=3e-3, schedule="wsd", warm-up 2, 20 steps) as
               repro_torch.launch.train builds it, batches of 8 x 2048 tokens
               from SyntheticTokens(seed=0): 2 warm-up steps, 10 timed ones
               (median ms/step, steps/s, tokens/s, peak memory, flash_attention
               launches a step: 20 forward under remat, 10 backward), one
               profiled step (idle share, largest device items; no library
               attention kernel), then the rest: the 20th step's loss below the
               first's; then at 2 x 2048, 3 steps through the kernels against
               the same steps with the plain attention forward and backward
               (kernel_backend="ref"): float32 loss within 2e-5 and grad norm
               within 1e-4 relative, bfloat16 both within 2e-2; and a bfloat16
               run saved after step 5 (repro_torch.checkpoint, the reference's
               layout, under build/), restored into a fresh model and state
               and taken 3 steps further: losses and parameters bitwise the
               uninterrupted run's;
27. train-xlstm — xlstm-350m at 2 of its 24 layers (phase 8's model,
               XLSTM_CUT), the same recipe and
               numbers as phase 26, slstm_fused 2 launches a step (1 pair,
               again under remat) and slstm_fused_bwd 1, a profiled step, the
               20th loss below the first; the held checks at 2 x 256 tokens
               (the plain recurrence is ~20 launches a step forward, ~40
               backward): every sLSTM forward and backward call of the
               kernel steps held against its plain version on its own inputs
               (slstm_held, slstm_bwd_held), the steps' losses and grad norms
               against the plain path's at XLSTM_HELD_TOL (float32 step 1 at
               TRAIN_TOL; the rest at limits set from readings of correct
               paths, since the model's gradient amplifies rounding: two
               orders of the same sums part by up to 0.69 in bfloat16 grad
               norm at step 1, and by more after one Adam step); the resume
               at 2 x 2048 bitwise;
28. train-hybrid — zamba2-1.2b at 6 of its 38 layers (1 of its 6 groups,
               no tail block: HYBRID_CUT), phase 26's recipe at lr 3e-4
               (HYBRID_OPT) and numbers: flash_attention 2 launches a step (the shared
               block's use, again under remat) and flash_attention_bwd 1,
               every Mamba2 block and every use of the shared block its own
               checkpoint, the SSD chunk loop under autograd, a profiled step
               with no library attention kernel, the 20th loss below the
               first; the held checks at 2 x 2048: every flash forward and
               backward call of the kernel steps held against its plain
               version on its own inputs (flash_train_held, flash_bwd_held),
               the same steps with a float64 attention and both paths'
               distances from them reported, the steps' losses and grad norms
               against the plain path's at TRAIN_TOL, each step of the
               kernel and float64 paths from the plain path's parameters
               before it (forced: compounded, the steps' updates amplify
               rounding past any fixed limit); the resume bitwise;
29. train-moe — dbrx-132b at its published widths with its 40 layers cut to
               1 (MOE_TRAIN_LAYERS, the line's "reduced"; 4,492 M
               parameters), its published capacity_factor 1.25 (the
               dispatch drops overflowed choices, reported each step),
               phase 26's recipe with bf16 moments and lr 3e-4 (MOE_OPT):
               2 flash_attention and 1 flash_attention_bwd launches a step,
               each step's aux and dropped choices, a profiled step with no
               library attention kernel, the 20th loss below the first;
               the held checks at 2 x 2048 at TRAIN_HELD_TOL with every
               flash call held on its own inputs, the bfloat16 kernel
               steps with the expert choices pinned to the plain steps'
               (each layer's recompute under remat takes its forward's
               pin; the unpinned kernel steps and the tokens whose experts
               differ reported); build/ checked for room, then the resume
               at full width bitwise (a ~36 GB checkpoint: the bf16
               moments' round trip);
30. train-vlm — llama-3.2-vision-90b at its published widths (d_model 8192,
               64 heads, 8 KV heads, d_ff 28672, vocab 128256, 1,601 image
               tokens) with its 100 layers cut to 5 (VLM_TRAIN_CUT, the
               line's "reduced": one of its 20 groups, 4 self layers and the
               cross layer; 6,380 M parameters), phase 26's recipe on bf16
               masters and bf16 moments at lr 3e-4 (VLM_OPT), each step's
               image embeddings drawn as the launcher draws them
               (image_embeds_at): 10 flash_attention launches a step (8 at
               the self shape, 2 at the cross shape, Sq 2,048 against 1,601
               keys, non-causal) and 5 flash_attention_bwd, a profiled step
               with no library attention kernel, the 20th loss below the
               first; the held checks at 2 x VLM_CHECK_SEQ at TRAIN_HELD_TOL,
               every flash call held on its own inputs, the same steps with
               a float64 attention reported beside; the resume at full
               width bitwise (a ~38 GB checkpoint of bf16 masters and
               moments);
31. train-audio — musicgen-large at its published widths (d_model 2048, 32
               heads, 32 KV heads, d_ff 8192, layernorm, gelu, 4 codebooks
               of 2048, untied (4, 2048, 2048) embed and unembed tables)
               with its 48 layers cut to 3 (AUDIO_TRAIN_CUT, the line's
               "reduced"; the line's "params"), phase 26's
               recipe on f32 masters and f32 moments, batches of 8 x 2048
               frames x 4 codebooks from SyntheticTokens(num_codebooks=4):
               6 flash_attention and 3 flash_attention_bwd launches a
               step at (8, 2048, 32, 32, 64), the train-hybrid shape, a
               profiled step with no library attention kernel and the
               host's synchronizing calls counted, the 20th loss below the
               first; the held checks at 2 x AUDIO_CHECK_SEQ frames at
               TRAIN_HELD_TOL with every flash call held on its own inputs,
               the float32 backward calls against the float64 gradient
               within F32_BWD_VS_PLAIN times the plain float32 backward's
               own distance from it (flash_bwd_f64_held; their distance
               from the plain backward reported); the resume bitwise;
32. collectives — 4 ranks spawned on cuda:0 in a gloo group (NCCL refuses
               two ranks on one GPU; each hop copies its CUDA tensor through
               pinned host memory): the COM ring (reduce-scatter,
               all-gather, make_com_matmul with no epilogue, silu, and bias
               + residual, the bidirectional ring, matmul_strategy psum /
               com / com_bidir) at qwen1.5-32b's MLP down projection (2,048
               tokens, K 27,392, N 5,120) in float32 and bfloat16, each
               against one dense product on the card (TOL), the all-gather
               bitwise, the bytes each rank sent equal to wire_bytes, ms a
               call; smollm-135m at TRAIN_CUT on a (pod=2, data=2) mesh, 2
               of the train phase's 8 x 2048 rows a rank, step 1 through
               grad_transform against the one-process step (float32: the
               whole batch at TRAIN_TOL; bfloat16: the same rows in 4
               microbatches at TRAIN_TOL, the whole batch's distance
               reported), and with compress_pod every gradient leaf within
               its rows' int8 bound and the residual under 2 % of max|g|;
               model-parallel training on DTensor over a (data=2, model=2)
               mesh of the same ranks (MP_MESH: parameters placed by
               param_rules, FSDP over "data" and tensor parallel over
               "model", activations by make_shard_fn, the logits split over
               the vocabulary): (c) smollm-135m at TRAIN_CUT, the train
               phase's whole first batch (4 rows a data group, heads
               replicated over "model": 9 and 3 do not divide 2), one float32
               step at TRAIN_TOL of the parent's one-process step on the same
               8 rows and every parameter within 1e-5 + 1e-3 of how far it
               moved of the one-process step's (Adam eps MP_EPS in both),
               one bfloat16 step at TRAIN_TOL of the one-process step in 2
               microbatches of the same rows; then one block of each family
               on the same mesh (FAMILY_CHECKS, each yardstick drawn by the
               parent once the ranks are through (c) and handed to them
               through a queue, each rank's shards against its chunks of
               it): (d) one qwen1.5-32b decoder block at full width
               (d_model 5,120, 40 heads of 128, d_ff 27,392, qkv bias: 525.6
               M parameters), 2 x 2048 tokens (a row a data group, 20 heads
               a model rank), forward and backward in float32 and bfloat16
               (output 2e-5 / 2e-2 of its largest magnitude, every gradient
               rtol 1e-3 and atol 1e-4 of max / 2e-2 of max); (e) one
               dbrx-132b moe block at full width (3,259 M parameters, 16
               experts top-4, capacity factor 1.25), 2 x 2048 tokens in 2
               dispatch groups, at ep_split 2 in float32 (unpinned, its
               routing the one-process block's token for token) and
               bfloat16, and at ep_split 1 in bfloat16 (each rank's experts
               cast, then gathered over "data"), bfloat16 with the experts
               pinned to the one-process block's choices (the pairs apart
               unpinned reported), its backward for the output's cotangent
               and 0.01 on the load-balance loss (the router's gradient
               takes both), its aux at TOL and its dropped choices equal to
               the one-process block's; (f) one llama-3.2-vision-90b cross
               layer at full width (855.7 M parameters), 2,048 text tokens
               against 1,601 image tokens, float32 and bfloat16; each as
               (d), one flash forward and backward at each rank's own
               heads; (g) musicgen-large at AUDIO_TRAIN_CUT, a float32 and
               a bfloat16 step as (c)'s on train-audio's first batch, the
               codebook tables split to 1,024 rows a model rank, every
               gradient against the one-process step's (bfloat16: in 2
               microbatches); every flash call of (c)-(g) held
               against its plain version, the calls' local shapes and
               launches checked, the collectives' bytes counted
               (CommCounter), the ranks' seconds by check; then a one-rank NCCL group runs the n = 1
               paths; and (in phase 12) the "torch-sharded" sweep on
               [cuda:0, cuda:0] bitwise the torch backend's;
33. the seconds of each phase, the kernels line (each kernel's launches on
               every path), the card line, the result line.

Any failed check exits non-zero before the result line is printed. Finding no
card is a failure. Tolerances: float32 results within 2e-5 of the reference's
largest magnitude, bfloat16 within 2e-2 (tests/test_kernels.py:18-19 and
tests/test_executor.py:87 of the JAX package); flash_attention's bfloat16
output also element by element within one bfloat16 rounding (2^-7 of the
element) plus the float32 tolerance, since it and its plain version each round
one f32 result once. slstm_fused and the xlstm prefill logits in float32: 2e-4
of the largest magnitude, the reference's own tolerance for the recurrence
(tests/test_kernels.py:142), in place of 2e-5; slstm_fused's bfloat16 h also
element by element within one rounding plus 2e-4 of the largest magnitude,
and its final state (float32) within 2e-4, both at the kernel checks' inputs
and at every sLSTM layer of the compared xlstm prefills.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import gc
import json
import math
import os
import queue
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.distributed.tensor import DTensor, distribute_tensor  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import com as com_lib  # noqa: E402
from repro_torch.core.com import (  # noqa: E402
    com_all_gather, com_matmul_local_bidir, com_reduce_scatter, make_com_matmul)
from repro_torch.core.energy import COUNTERPARTS, PAPER_DOMINO  # noqa: E402
from repro_torch.core.executor import _maxpool, random_weights  # noqa: E402
from repro_torch.core.mapping import ConvSpec, vgg16_imagenet  # noqa: E402
from repro_torch.core.program import compile_program  # noqa: E402
from repro_torch.core.simulator import (  # noqa: E402
    COMGridSim, DominoModel, Events, conv_events, fc_events, reference_conv, reference_fc)
from repro_torch.faults import (  # noqa: E402
    BlockFault, FaultSet, TransientFaults, apply_weight_faults, degraded_chips, usable_tiles,
    validate_fault_allocs)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.com_matmul import com_matmul  # noqa: E402
from repro_torch.kernels.com_matmul import plan as com_matmul_plan  # noqa: E402
from repro_torch.kernels.conv2d_com import conv2d_com  # noqa: E402
from repro_torch.kernels.conv2d_com import plan as conv2d_plan  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_bwd  # noqa: E402
from repro_torch.kernels.flash_attention import plan as flash_plan  # noqa: E402
from repro_torch.kernels.flash_attention import plan_bwd as flash_plan_bwd  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    com_matmul_ref, conv2d_com_ref, flash_attention_bwd_ref, flash_attention_ref, slstm_bwd_ref,
    slstm_dr, slstm_ref)
from repro_torch.kernels.slstm import active_clusters as slstm_active_clusters  # noqa: E402
from repro_torch.kernels.slstm import plan as slstm_plan  # noqa: E402
from repro_torch.kernels.slstm import bwd_step_floor as slstm_bwd_step_floor  # noqa: E402
from repro_torch.kernels.slstm import plan_bwd as slstm_plan_bwd  # noqa: E402
from repro_torch.kernels.slstm import slstm_fused, slstm_fused_bwd  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.frontend import synth_image_embeds  # noqa: E402
from repro_torch.models.transformer import Block, CallConfig, block_axes, build_model  # noqa: E402
from repro_torch.launch import table_iv  # noqa: E402
from repro_torch.launch.mesh import make_data_mesh, make_debug_mesh, make_mesh  # noqa: E402
from repro_torch.launch.sweep import check_against_scalar, smoke_1e6_grid  # noqa: E402
from repro_torch.parallel.collectives import (  # noqa: E402
    axis_mean, grad_transform, matmul_strategy, wire_bytes)
from repro_torch.parallel.shard_sweep import make_sharded_backend  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    CommCounter, act_rules, batch_shardings, device_collectives, make_shard_fn, place_params)
from repro_torch.search import PopulationEvaluator, greedy_candidate, search_mapping  # noqa: E402
from repro_torch.runtime.fault_tolerance import RestartPolicy  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticTokens  # noqa: E402
from repro_torch.launch.train import image_embeds_at  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    load_state_tree, make_train_state, make_train_step, state_tree)
from repro_torch.search.cost import timed  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdmissionQueue, Engine, Request, TrafficProfile, generate_arrivals, simulate)
from repro_torch.sweep import COLUMNS, build_batch, resolve_network, run_sweep  # noqa: E402

# published H100 SXM peaks (dense): f32 outside the tensor cores, bf16 tensor
# cores, TF32 tensor cores (the 3xTF32 float32 products take three passes), HBM3
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# kernel names of NVIDIA's libraries (cuBLAS, cuDNN, CUTLASS device-level
# GEMMs): none may run in the VGG-16 forward, whose products are the port's own
LIBRARY_KERNEL = re.compile(
    r"cublas|cudnn|cutlass|gemm|gemv|xmma|winograd|implicit_convolve|sm\d\d_|ampere_|hopper_",
    re.IGNORECASE)
# kernel names of PyTorch's fused attention (flash, memory-efficient, cuDNN):
# none may run in the smollm prefill, whose attention is the port's own
LIBRARY_ATTENTION = re.compile(r"flash_fwd|fmha|efficient_attention|mem_eff|cudnn|pytorch_flash",
                               re.IGNORECASE)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
BF16_ULP = 2.0 ** -7  # a bfloat16 value's spacing, relative to the value, at most
BATCH = 8
# the serve phases: smollm-135m and xlstm-350m, 16 requests, 8 slots
SERVE_ARCH, N_REQUESTS, MAX_NEW, SLOTS, MAX_SEQ = "smollm-135m", 16, 64, 8, 2048
XLSTM_ARCH = "xlstm-350m"
SLSTM_TOL = 2e-4  # float32 tolerance of the recurrence (tests/test_kernels.py:142)
SSM_TOL = 1e-4  # float32 tolerance of the state-space families' models (tests/test_layers.py:95)
SWEEP_RTOL = 1e-6  # the float64 sweep backend against NumPy (tests/test_sweep_backends.py:26)
FAULT_SPARES = 6  # spare chips past the pristine placement (benchmarks/faults_bench.py's default)
# the streaming phases: smollm-135m through Engine.serve on a paged cache of 96
# 16-row pages (35 % of the 272 a contiguous pool of 8 x 544 rows needs), on a
# burst profile; the patient profile has no deadline
TRAFFIC = dict(
    name="chip-burst-24", num_requests=24, arrival="burst", burst_size=8, num_users=8,
    requests_per_user_tick=0.05, prompt_lens={"choices": [128, 256, 512], "weights": [1, 2, 1]},
    output_lens={"choices": [8, 16, 32], "weights": [1, 2, 1]}, temperature=0.0, deadline=40,
    seed=0)
PATIENT_TRAFFIC = dict(TRAFFIC, name="chip-burst-24-patient", deadline=None)
PAGED_POOL = dict(batch=SLOTS, page_size=16, pool_pages=96)
CHIP_FAULTS = dict(slot_rate=0.05, page_rate=0.002, seed=0)
PATIENT = dict(max_restarts=10_000, backoff_s=1.0, backoff_mult=1.0)  # tests/test_serve_faults.py:56
# the moe and hybrid serve phases: dbrx-132b at full width with its depth cut
# to MOE_LAYERS (f32 weights: ~13.0 GB a layer and 4.9 GB of embed and
# unembed), 8 requests of 128-512 prompt tokens; zamba2-1.2b (HYBRID_SERVE_CUT)
# on the serve phase's wave, then its first burst through a paged pool
MOE_ARCH, MOE_LAYERS, MOE_REQUESTS, MOE_PROMPTS, MOE_NEW, MOE_MAX_SEQ = (
    "dbrx-132b", 2, 8, (128, 512), 32, 1024)
HYBRID_ARCH = "zamba2-1.2b"
# the vlm and audio phases: llama-3.2-vision-90b at full width with its 100
# layers cut to VLM_LAYERS (2 of its 20 groups of 5: 8 self and 2 cross
# layers; f32 weights ~42.6 GB), musicgen-large (AUDIO_CUT); ROWS rows in
# lockstep: one prefill, then greedy decode steps at a shared position. The
# float32 checks run on CHECK_ROWS of them
VLM_ARCH, VLM_LAYERS, VLM_PROMPT, VLM_NEW = "llama-3.2-vision-90b", 10, 512, 32
AUDIO_ARCH, AUDIO_FRAMES, AUDIO_NEW = "musicgen-large", 512, 64
ROWS, CHECK_ROWS = 8, 2
DECODE_RTOL = 2e-2  # prefill + decode against forward (tests/test_models.py:86-98, rtol = atol)
# the train phase: smollm-135m (TRAIN_CUT), batches of TRAIN_BATCH x TRAIN_SEQ tokens
# (SmolLM's training context), TRAIN_WARMUP untimed steps, then TRAIN_TIMED
# timed ones, TRAIN_STEPS in all; the held checks at CHECK_BATCH rows
TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_TIMED, TRAIN_STEPS = 8, 2048, 2, 10, 20
CHECK_BATCH, CHECK_STEPS, RESUME_AT, RESUME_MORE = 2, 3, 5, 3
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4  # the reference's gradient tolerance (tests/test_layers.py:121)
# float32 train steps through the kernels against the plain attention: loss
# and grad norm, relative; bfloat16 both within 2e-2
TRAIN_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# the held steps' (loss, grad norm) limits, step by step: TRAIN_TOL at every step
TRAIN_HELD_TOL = {dt: (tol,) * CHECK_STEPS for dt, tol in TRAIN_TOL.items()}
# xlstm-350m's, set from readings of correct paths (scripts/slstm_grad_probe.py,
# part 3, and the train-xlstm phase; PERF.md): the largest relative distance
# from the plain path of the plain path with the units of each head in three
# other orders, of the kernel path and of the kernel in those orders, times
# at least 1.5. Step 1 in float32 is TRAIN_TOL, which sits between those
# readings (<= 1.9e-5 in grad norm) and the lower-precision controls (R in
# bf16: 2.4e-2; the saved state in bf16: 1.6e-4). Elsewhere no limit
# separates them: the controls land inside the correct paths' spread, and
# after one Adam step (lr 3e-3) the runs part by up to 0.83 (float32) and
# 18.2 (bfloat16) in grad norm. Those limits only catch a gross fault; every
# sLSTM call of the kernel steps is held on its own inputs besides.
XLSTM_HELD_TOL = {torch.float32: ((2e-5, 1e-4), (1.5e-3, 0.5), (3e-2, 1.25)),
                  torch.bfloat16: ((2e-2, 1.1), (2.5e-2, 2.0), (5e-2, 30.0))}
XLSTM_CHECK_SEQ = 256  # train-xlstm's held checks: 2 x 256 tokens (the plain recurrence is slow)
# the train-hybrid phase: zamba2-1.2b at HYBRID_CUT on HYBRID_OPT, the
# launcher's recipe at lr 3e-4 (OptConfig's default, as MOE_OPT's and
# VLM_OPT's), its held steps forced (TrainCell.forced) at TRAIN_HELD_TOL. At
# the launcher's lr 3e-3 the cut model's grad norm climbs from ~10 to
# 10^3-10^4 within 8 steps at every depth from 6 to 14 layers, and the
# 20-step run turns NaN on the kernel path at 6 layers and on the plain
# path at 14, while the forced steps of the two paths stand within 1.41e-6
# of each other in grad norm at every depth (scripts/hybrid_depth_probe.py,
# PERF.md §4): such a run tells a recipe's chaos, not the kernels'. Held
# steps that compound their own updates part by up to 0.74 at step 3 there
# (the plain path 2.2 from a float64 attention's at 6 layers, the kernel
# path 0.76 at 12)
HYBRID_OPT = dict(lr=3e-4)
# the train-moe phase: dbrx-132b at its published widths with its 40 layers
# cut to MOE_TRAIN_LAYERS (4,492 M parameters: 3,259 M in the layer, 1,233 M
# in embed and unembed), its published capacity_factor 1.25 (training drops
# the overflowed choices, as the reference's does), on MOE_OPT: bf16
# moments (f32 masters and gradients and bf16 moments: ~50.2 GiB of state)
# and lr 3e-4, OptConfig's default. f32 moments (36 GB more) do not fit
# beside f32 weights and gradients; the repo's int8 moments (its recipe past
# 50 B parameters, src/repro/launch/dryrun.py:45) diverge within a few
# steps, in the reference as in the port (tests/test_torch_moe_train.py;
# at full width NaN from step 4, scripts/train_moe_probe.py); at the
# launcher's lr 3e-3 the first Adam steps throw the loss from 12.6 to 53
# and the 20th step's (26.1) stays above the first (the probe)
MOE_TRAIN_LAYERS = 1
MOE_OPT = dict(lr=3e-4, moment_dtype="bf16")
# the train-vlm phase: llama-3.2-vision-90b at its published widths with its
# 100 layers cut to VLM_TRAIN_CUT, one of its 20 groups (4 self layers, then
# the cross layer over 1,601 image tokens; 6,380 M parameters, 2,101 M of
# them in the untied embed and unembed), on VLM_OPT: bf16 masters (the
# reference's recipe past 50 B parameters, src/repro/launch/dryrun.py:45-51,
# cast as its :150-157 casts) and bf16 moments (its int8 moments diverge,
# ROADMAP Queue 3, item 27), lr 3e-4 as MOE_OPT's. f32 masters and
# gradients and bf16 moments would take ~76.5 GB, past the card; bf16
# masters, gradients and moments take ~51 GB. The held checks at 2 x
# VLM_CHECK_SEQ tokens (the cross layer keeps all 1,601 image keys)
VLM_TRAIN_CUT = dict(num_layers=5)
VLM_OPT = dict(lr=3e-4, moment_dtype="bf16", param_dtype="bf16")
VLM_CHECK_SEQ = 256
# earlier paths at a cut depth, widths whole, so that the script ends near
# half its 1,200 s limit (with every path at the depths it had before the
# train-moe phase it ran 1,095 s of phases on one machine and past 1,200 s on
# another; host-paced phases move by up to 70 % between machines). Each cut
# is in its phase lines' "reduced", and no gate changes with it:
# smollm-135m serves at 3 of its 30 layers (serve, serve-traffic,
# serve-faults) and trains at 5; xlstm-350m serves and trains at 1 of its
# 12 [mLSTM, sLSTM] pairs; zamba2-1.2b trains and serves at 1 of its 6
# groups of 6 Mamba2 blocks, followed by the shared block (6 of 38 layers;
# the shared block's second use in serving is held on the card at the
# reduced size, tests/test_torch_gpu.py); dbrx-132b serves at 2 of its 40 layers
# (MOE_LAYERS); musicgen-large prefills and decodes at 6 of its 48 and
# trains at 3 (AUDIO_CUT, AUDIO_TRAIN_CUT). The train-vlm phase bought
# its time with its held checks at 2 x 256 tokens, then by cutting smollm's
# serving from 10 layers to 5 and its training from 30 to 10, xlstm's from
# 8 to 4, dbrx's serving from 4 to 2 and zamba2's from 14 to 8, then in the
# resume's I/O (a checkpoint on the host's tmpfs does not fit beside the
# host tree of a ~36-38 GB state: PERF.md). zamba2's training stayed at 14
# then: at 8 its compounded float32 held steps parted past that time's
# limits and its 20th loss stayed above its first (PERF.md). The train-audio phase bought its time with
# its own cuts (AUDIO_CHECK_SEQ, its resume at 6 layers), then with model-audio's
# depth, 12 to 6, and xlstm-350m's, 4 to 2 (serve-xlstm and train-xlstm).
# The collectives phase bought its time with train-audio's depth, 48 to 6,
# and serve-hybrid's, 8 to 6; its model-parallel checks bought theirs with
# smollm's serving depth, 5 to 3 (serve, serve-traffic, serve-faults), and
# train-audio's, 6 to 3 (PERF.md §4). The audio, vlm and moe families'
# model-parallel checks ((e)-(g), ~30 s) bought theirs with zamba2's
# training, 14 to 6 layers (one group of 6 Mamba2 blocks and the shared
# block, at HYBRID_OPT's lr: at the launcher's lr 3e-3 its 20-step run
# turned NaN at 6 layers, PERF.md §4), and smollm-135m's, 10 to 5 (train,
# and (b) and (c) of collectives)
SERVE_CUT = dict(num_layers=3)
TRAIN_CUT = dict(num_layers=5)
XLSTM_CUT = dict(num_layers=2)
HYBRID_CUT = dict(num_layers=6)
HYBRID_SERVE_CUT = dict(num_layers=6)
AUDIO_CUT = dict(num_layers=6)
AUDIO_TRAIN_CUT = dict(num_layers=3)
# the train-audio phase: musicgen-large at AUDIO_TRAIN_CUT on the launcher's
# recipe, 8 x 2048 frames x 4 codebooks a step; its held checks at 2 x
# AUDIO_CHECK_SEQ frames (model-audio's prompt length); its resume a
# checkpoint at the same depth (the whole model's would be 29.4 GB)
AUDIO_CHECK_SEQ = AUDIO_FRAMES
BWD_CHECK_S = 300  # the backward checks' own time limit (they take well under a minute)
# the collectives phase: COLLECTIVE_RANKS processes on cuda:0 in a gloo group
# (NCCL refuses a second rank on one GPU); the COM ring at qwen1.5-32b's MLP
# down projection (K = d_ff = 27,392, N = d_model = 5,120) over COM_TOKENS
# tokens, each strategy timed over COM_TIMED calls; COLLECTIVES_S is the
# ranks' own time limit, so that a stuck rank fails the phase loudly
COM_ARCH, COM_TOKENS, COM_TIMED, COLLECTIVE_RANKS, COLLECTIVES_S = "qwen1.5-32b", 2048, 2, 4, 600
# its model-parallel checks (tensor parallelism and FSDP on DTensor) on a
# (data=2, model=2) mesh of the same ranks: (c) smollm-135m at TRAIN_CUT on
# the train phase's first batch, 4 rows a data group. Adam's eps is MP_EPS in
# the model-parallel step and its yardstick: at the default 1e-8 an update
# amplifies float32 rounding in gradient elements near 1e-8 by about 1e4,
# and the updated parameters compare rounding (ROADMAP Queue 3, item 23)
MP_MESH, MP_EPS = dict(data=2, model=2), 1e-6
# then one block of each of these on the same mesh, FAMILY_ROWS x 2048
# tokens (a row a data group), in this order: (d) one qwen1.5-32b decoder
# block at full width (525.6 M parameters), its 40 heads split 20 to a model
# rank, float32 and bfloat16; (e) one dbrx-132b moe decoder block at full
# width (3,259 M parameters), MP_MESH["data"] dispatch groups (one a data
# group), at ep_split 2 in float32 (32 expert slices of d_ff 5,376, 8
# resident a rank: the tokens move, no weight is gathered) and in bfloat16,
# and at ep_split 1 in bfloat16 on float32 parameters (each rank gathers its
# 8 experts over "data" after casting them: in float32 the ranks and the
# parent's yardstick would need ~77 GB); bfloat16 with the experts pinned to
# the one-process block's choices (Routing), float32 unpinned; its backward
# taken for the output's cotangent and AUX_WEIGHT on the load-balance loss,
# as the loss weighs it; (f) one llama-3.2-vision-90b cross layer at full
# width (856 M parameters) against 1,601 image tokens, float32 and bfloat16;
# and (g) musicgen-large at AUDIO_TRAIN_CUT, one float32 and one bfloat16
# step on train-audio's first batch (8 x 2048 frames x 4 codebooks), as (c)
# steps smollm. The parent draws each one-process yardstick in turn and
# hands it to the ranks through a queue (CUDA IPC), keeping one on the card
# at a time
FAMILY_CHECKS = {"qwen_block_float32": ("dense", 0, torch.float32, False),
                 "qwen_block_bfloat16": ("dense", 0, torch.bfloat16, False),
                 "dbrx_ep2_float32": ("moe", 2, torch.float32, False),
                 "dbrx_ep2_bfloat16": ("moe", 2, torch.bfloat16, True),
                 "dbrx_ep1_bfloat16": ("moe", 1, torch.bfloat16, True),
                 "vlm_cross_float32": ("vlm", 0, torch.float32, False),
                 "vlm_cross_bfloat16": ("vlm", 0, torch.bfloat16, False),
                 "musicgen": ("audio", 0, None, False)}
FAMILY_ROWS = 2  # (d)-(f): a row a data group
AUX_WEIGHT = 0.01  # the load-balance loss's weight in the loss (models/transformer.py, loss)
FIRST_BURST = dict(PATIENT_TRAFFIC, name="chip-burst-8-patient", num_requests=8)
# the virtual clock is a function of the profile, the pool and the fault draws
# (eos_id=None): the JAX package's numbers on these profiles, which the CPU
# tests hold the port to (tests/test_torch_traffic.py, test_torch_serve_faults.py)
TRAFFIC_CLOCK = dict(n_accepted=21, n_rejected=3, n_deadline_rejected=3, generated_tokens=352,
                     decode_steps=91, makespan_ticks=91.0, latency_p50_ticks=31.0,
                     ttft_p50_ticks=15.0, pages_peak_max=34)
FAULTS_CLOCK = {(24, False): dict(n_accepted=24, decode_steps=98, makespan_ticks=98.0),
                (24, True): dict(n_accepted=24, decode_steps=111, makespan_ticks=150.0,
                                 faults_injected=39, retries=39, reprefills=39),
                (8, False): dict(n_accepted=8, makespan_ticks=46.0),
                (8, True): dict(n_accepted=8, decode_steps=47, makespan_ticks=58.0,
                                faults_injected=11, retries=11, reprefills=11)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean time of one call, by CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 10, stream=None) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph and
    replayed, timed by CUDA events, so that no host time sits between the
    launches (``cuda_ms`` of a call shorter than its host path times the
    host). ``stream``: where the call's work must run to be captured (an
    autograd backward runs on its forward's stream)."""
    with torch.cuda.stream(stream or torch.cuda.current_stream()):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def bound(n_bytes: float, n_ops: float, dtype) -> tuple:
    """Least time on the card (ms) and what sets it: each input read once and
    each output written once at the memory rate, or the operations at the
    peak rate for the type."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound_3xtf32(n_bytes: float, n_ops: float, dtype):
    """The float32 bound of the kernels' own route: three TF32 passes of the
    operations at the TF32 tensor-core peak, against the bytes at the memory
    rate (ms); None for bfloat16, whose bound_ms is already the tensor cores'."""
    if dtype != torch.float32:
        return None
    return max(n_bytes / PEAK_BYTES, 3 * n_ops / PEAK_TF32) * 1e3


@contextlib.contextmanager
def time_limit(seconds: float, what: str):
    """Fail loudly if the block runs longer than ``seconds``: a kernel stuck
    on an mbarrier phase never returns, and the caller's clock would run out
    first. A timer thread reports the failure and ends the process, whose
    exit tears the CUDA context and the stuck kernel down."""
    def expire():
        print(f"chip_smoke: FAILED: {what} did not finish within {seconds} s", file=sys.stderr,
              flush=True)
        os._exit(1)

    timer = threading.Timer(seconds, expire)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


def same_bits(fn, got, name, shape) -> bool:
    """A second call of ``fn`` returns ``got`` bit for bit (split-K and
    split-KV combine their slices in a fixed order, with no atomics)."""
    again = fn()
    torch.cuda.synchronize()
    if not torch.equal(again, got):
        fail(f"{name} {shape}: two calls differ (a split launch must be deterministic)")
    return True


def compare(name, shape, dtype, got, want, kernel_ms, plain_ms, library_ms, t_parts, by,
            one_rounding=False, f32_tol=TOL[torch.float32], extra=None):
    """Check ``got`` against ``want`` within ``f32_tol`` (float32) or
    TOL[bfloat16] of max|want|. With ``one_rounding`` (a kernel whose plain
    version computes in f32 and rounds once to bfloat16, as the kernel does)
    each bfloat16 element is also held within one rounding of its own value:
    |got - want| <= 2^-7 |want| plus ``f32_tol`` of max|want|, a limit a
    dropped or doubled term of a sum cannot hide in. ``extra`` is added to
    the line."""
    tol = f32_tol if dtype == torch.float32 else TOL[dtype]
    diff = (got.double() - want.double()).abs()
    err = diff.max().item()
    scale = want.double().abs().max().item()
    line = {
        "kernel": name, "shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": err, "max_rel_err": err / max(scale, 1e-30), "tol": tol,
        "err_over_limit": err / max(tol * scale, 1e-30),
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_parts), "bound_by": by, **(extra or {}),
    }
    per_element = one_rounding and dtype == torch.bfloat16
    if per_element:
        limit = BF16_ULP * want.double().abs() + f32_tol * scale
        line["max_err_over_one_rounding"] = (diff / limit).max().item()
    emit(line)
    if not torch.isfinite(got).all().item():
        fail(f"{name} {shape}: non-finite output")
    if scale == 0.0 or err > tol * scale:
        fail(f"{name} {shape} {dtype}: max_abs_err {err} > {tol} * {scale}")
    if per_element and line["max_err_over_one_rounding"] > 1.0:
        fail(f"{name} {shape} {dtype}: an element is {line['max_err_over_one_rounding']} times "
             f"one bfloat16 rounding of the plain version's away from it")
    return line


def randn(shape, gen, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype).contiguous()


def check_com_matmul(gen, M, K, N, dtype=torch.float32, activation="relu",
                     with_bias=False, with_residual=False):
    x, w = randn((M, K), gen, dtype), randn((K, N), gen, dtype, (2.0 / K) ** 0.5)
    bias = randn((N,), gen, dtype) if with_bias else None
    res = randn((M, N), gen, dtype) if with_residual else None
    kw = dict(bias=bias, activation=activation, residual=res)
    got = com_matmul(x, w, **kw)
    torch.cuda.synchronize()
    want = com_matmul_ref(x, w, **kw)
    es = x.element_size()
    n_bytes = es * (M * K + K * N + M * N + (N if with_bias else 0)
                    + (M * N if with_residual else 0))
    n_ops = 2.0 * M * N * K
    t_parts, by = bound(n_bytes, n_ops, dtype)
    name = "com_matmul" + "".join(
        f"+{p}" for p, on in (("bias", with_bias), (activation, activation),
                              ("residual", with_residual)) if on)
    p = com_matmul_plan(M, N, K, dtype)
    extra = {"plan": dataclasses.asdict(p),
             "bound_3xtf32_ms": bound_3xtf32(n_bytes, n_ops, dtype)}
    if p.splits > 1:
        extra["split_k_same_bits"] = same_bits(lambda: com_matmul(x, w, **kw), got, name,
                                               (M, K, N))
    return compare(
        name, (M, K, N), dtype, got, want,
        cuda_ms(lambda: com_matmul(x, w, **kw)), cuda_ms(lambda: com_matmul_ref(x, w, **kw)),
        cuda_ms(lambda: torch.matmul(x, w)), t_parts, by, extra=extra)


def check_com_matmul_inf(gen, M, dtype):
    """An inf in x and a -inf in w, each meeting an exact 1.0 (whose 3xTF32
    small half is 0), and a near-overflow 3.4028e38: com_matmul must give
    com_matmul_ref's infinities, NaNs and finite values (f32 tolerance of the
    finite part), on the streaming (M <= 32) or tensor-core path."""
    K, N = 96, 40
    x = randn((M, K), gen)
    w = randn((K, N), gen, scale=1e-3)
    w[7, 3] = 1.0
    x[5, 7], x[6, 9], w[11, 20] = float("inf"), 3.4028e38, float("-inf")
    x, w = x.to(dtype), w.to(dtype)
    got = com_matmul(x, w)
    torch.cuda.synchronize()
    want = com_matmul_ref(x, w)
    fin = want.isfinite()
    same = (torch.equal(got.isnan(), want.isnan()) and torch.equal(got.isinf(), want.isinf())
            and torch.equal(got[got.isinf()], want[want.isinf()]))
    err = (got[fin].double() - want[fin].double()).abs().max().item()
    scale = want[fin].double().abs().max().item()
    line = {"kernel": "com_matmul(inf operand)", "shape": [M, K, N],
            "dtype": str(dtype).replace("torch.", ""), "path": com_matmul_plan(M, N, K, dtype).path,
            "non_finite": int((~fin).sum().item()), "same_non_finite_as_plain": same,
            "finite_max_rel_err": err / scale, "tol": TOL[dtype]}
    emit(line)
    if not same or err > TOL[dtype] * scale:
        fail(f"com_matmul with an inf operand, M = {M} {dtype}: {line}")


def check_conv2d(gen, H, W, C, M, K=3, stride=1, padding=1, dtype=torch.float32):
    x = randn((H, W, C), gen, dtype)
    w = randn((K, K, C, M), gen, dtype, (2.0 / (K * K * C)) ** 0.5)
    kw = dict(stride=stride, padding=padding, activation="relu")
    got = conv2d_com(x, w, **kw)
    torch.cuda.synchronize()
    want = conv2d_com_ref(x, w, **kw)
    Ho, Wo = want.shape[0], want.shape[1]
    xn, wn = x.permute(2, 0, 1)[None].contiguous(), w.permute(3, 2, 0, 1).contiguous()
    n_bytes = x.element_size() * (H * W * C + K * K * C * M + Ho * Wo * M)
    n_ops = 2.0 * Ho * Wo * M * K * K * C
    t_parts, by = bound(n_bytes, n_ops, dtype)
    shape = (H, W, C, M, K, stride, padding)
    p = conv2d_plan(H, W, C, K, M, stride, padding, dtype)
    extra = {"plan": dataclasses.asdict(p),
             "bound_3xtf32_ms": bound_3xtf32(n_bytes, n_ops, dtype)}
    if p.splits > 1:
        extra["split_k_same_bits"] = same_bits(lambda: conv2d_com(x, w, **kw), got,
                                               "conv2d_com", shape)
    return compare(
        "conv2d_com", shape, dtype, got, want,
        cuda_ms(lambda: conv2d_com(x, w, **kw)), cuda_ms(lambda: conv2d_com_ref(x, w, **kw)),
        cuda_ms(lambda: F.conv2d(xn, wn, stride=stride, padding=padding)), t_parts, by,
        extra=extra)


def sdpa(q, k, v, causal):
    """The library yardstick: PyTorch's fused attention on the same inputs
    (never called by the port)."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    try:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
    except TypeError:  # a torch without enable_gqa: repeat the KV heads
        g = q.shape[2] // k.shape[2]
        out = F.scaled_dot_product_attention(qt, kt.repeat_interleave(g, 1),
                                             vt.repeat_interleave(g, 1), is_causal=causal)
    return out.transpose(1, 2)


def check_flash(gen, S, dtype=torch.bfloat16, causal=True, H=9, KVH=3, hd=64, B=1, Skv=None,
                return_lse=False):
    """flash_attention at (B, Sq = S, Skv (default S), H, KVH, hd) against
    its plain version and SDPA, and a second call's bits; the causal mask is
    top-left. With ``return_lse`` (a train forward) every call also writes
    lse, held within 1e-5 of max|plain lse| + 1e-5, and out has the bits of
    a call without it."""
    Skv = S if Skv is None else Skv
    q = randn((B, S, H, hd), gen, dtype)
    k, v = randn((B, Skv, KVH, hd), gen, dtype), randn((B, Skv, KVH, hd), gen, dtype)

    def call():
        out = flash_attention(q, k, v, causal=causal, return_lse=return_lse)
        return out[0] if return_lse else out

    got = call()
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, causal=causal)
    n_bytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel()) + (
        4 * B * H * S if return_lse else 0)
    # (q, k) pairs the mask keeps
    pairs = sum(min(i + 1, Skv) for i in range(S)) if causal else S * Skv
    n_ops = 4.0 * hd * H * B * pairs
    t_parts, by = bound(n_bytes, n_ops, dtype)
    p = flash_plan(B, S, Skv, H, KVH, hd, dtype, causal)
    shape = (B, S, H, KVH, hd) if Skv == S else (B, S, Skv, H, KVH, hd)
    extra = {"plan": dataclasses.asdict(p), "bound_3xtf32_ms": bound_3xtf32(n_bytes, n_ops, dtype),
             "graph_ms": graph_ms(call), "library_graph_ms": graph_ms(lambda: sdpa(q, k, v, causal)),
             "same_bits": same_bits(call, got, "flash_attention", shape)}
    if return_lse:
        _, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        _, want_lse = flash_attention_ref(q, k, v, causal=causal, return_lse=True)
        lse_err = (lse.double() - want_lse.double()).abs().max().item()
        if not torch.equal(got, flash_attention(q, k, v, causal=causal)):
            fail(f"flash_attention {shape} {dtype}: out changes when lse is written")
        if lse_err > 1e-5 * want_lse.abs().max().item() + 1e-5:
            fail(f"flash_attention {shape} {dtype}: lse off by {lse_err}")
        extra.update(return_lse=True, lse_max_abs_err=lse_err, out_bits_same_with_lse=True)
    return compare(
        "flash_attention" + ("" if causal else "(non-causal)"), shape, dtype,
        got, want, cuda_ms(call), cuda_ms(lambda: flash_attention_ref(q, k, v, causal=causal)),
        cuda_ms(lambda: sdpa(q, k, v, causal)), t_parts, by, one_rounding=True, extra=extra)


def sdpa_bwd(q, k, v, dout, causal, stream=None):
    """The library yardstick of the backward: one backward pass of SDPA at
    the same shape (its forward run once, outside the timing, on ``stream``,
    where autograd then runs the backward)."""
    with torch.cuda.stream(stream or torch.cuda.current_stream()):
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            out = sdpa(qs, ks, vs, causal)
    return lambda: torch.autograd.grad(out, (qs, ks, vs), dout, retain_graph=True)


def sdpa_bwd_graph_ms(q, k, v, dout, causal) -> float:
    """SDPA's backward alone, replayed from a CUDA graph: device time, like
    the kernels' graph_ms. Its forward runs on a side stream so that the
    backward lands where the graph captures it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    return graph_ms(sdpa_bwd(q, k, v, dout, causal, side), stream=side)


def check_flash_bwd(gen, S, dtype=torch.bfloat16, causal=True, H=9, KVH=3, hd=64, B=1,
                    Skv=None):
    """flash_attention_bwd at (B, Sq = S, Skv (default S), H, KVH, hd)
    against flash_attention_bwd_ref on the same (q, k, v, out, lse, dout):
    float32 within rtol 1e-3 and atol 1e-4 max|plain| element by element
    (tests/test_layers.py:121), bfloat16 within 2e-2 max|plain| (the ratio
    of each element's error to one bfloat16 rounding of it reported, not
    gated); a second call's bits; the forward's out equal with and without
    lse, and lse against the plain lse."""
    Skv = S if Skv is None else Skv
    shape = (B, S, H, KVH, hd) if Skv == S else (B, S, Skv, H, KVH, hd)
    q = randn((B, S, H, hd), gen, dtype)
    k, v = randn((B, Skv, KVH, hd), gen, dtype), randn((B, Skv, KVH, hd), gen, dtype)
    dout = randn((B, S, H, hd), gen, dtype)
    plain_out = flash_attention(q, k, v, causal=causal)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    if not torch.equal(out, plain_out):
        fail(f"flash_attention {shape} {dtype}: out changes when lse is written")
    _, want_lse = flash_attention_ref(q, k, v, causal=causal, return_lse=True)
    lse_err = (lse.double() - want_lse.double()).abs().max().item()
    if lse_err > 1e-5 * want_lse.abs().max().item() + 1e-5:
        fail(f"flash_attention {shape} {dtype}: lse off by {lse_err}")

    def run():
        return flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)

    got = run()
    torch.cuda.synchronize()
    want = flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)
    again = run()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"flash_attention_bwd {shape} {dtype}: two calls differ")
    errs, over, rounding = [], [], []
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if not torch.isfinite(g).all().item():
            fail(f"flash_attention_bwd {shape} {dtype}: non-finite {name}")
        wd = w.double()
        diff = (g.double() - wd).abs()
        scale = wd.abs().max().item()
        errs.append(diff.max().item())
        if dtype == torch.float32:
            over.append((diff / (GRAD_RTOL * wd.abs() + GRAD_ATOL * scale)).max().item())
        else:
            over.append(diff.max().item() / (TOL[dtype] * scale))
            rounding.append((diff / (BF16_ULP * wd.abs() + 2e-5 * scale)).max().item())
    pairs = sum(min(i + 1, Skv) for i in range(S)) if causal else S * Skv
    plan = flash_plan_bwd(B, S, Skv, H, KVH, hd, dtype, causal)
    es = q.element_size()
    # q, k, v, out, dout read and dq, dk, dv written once; lse read once
    n_bytes = es * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
    n_ops = 10.0 * hd * H * B * pairs  # s, dp, dv, dk, dq: 5 products of 2 hd flop a pair
    t_parts, by = bound(n_bytes, n_ops, dtype)
    lib = sdpa_bwd(q, k, v, dout, causal)
    line = {
        "kernel": "flash_attention_bwd" + ("" if causal else "(non-causal)"), "shape": list(shape),
        "dtype": str(dtype).replace("torch.", ""), "max_abs_err": max(errs),
        "max_abs_err_dq_dk_dv": errs, "err_over_limit": over,
        "tol": "rtol 1e-3, atol 1e-4 max" if dtype == torch.float32 else TOL[dtype],
        "lse_max_abs_err": lse_err, "out_bits_same_with_lse": True, "same_bits": True,
        "kernel_ms": cuda_ms(run), "graph_ms": graph_ms(run),
        "plain_ms": cuda_ms(lambda: flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                            causal=causal), reps=3, warmup=1),
        "library_ms": cuda_ms(lib), "library_graph_ms": sdpa_bwd_graph_ms(q, k, v, dout, causal),
        "bound_ms": max(t_parts), "bound_by": by,
        "bound_3xtf32_ms": bound_3xtf32(n_bytes, n_ops, dtype),
        "forward_graph_ms": graph_ms(lambda: flash_attention(q, k, v, causal=causal,
                                                             return_lse=True)),
        "path": plan.path, "mma_passes_per_pair": plan.mma_passes_per_pair,
        "plan": dataclasses.asdict(plan)}
    if rounding:
        line["max_err_over_one_rounding"] = max(rounding)
    emit(line)
    if max(over) > 1.0:
        fail(f"flash_attention_bwd {shape} {dtype}: errors {over} times the limit")
    return line


def check_slstm(gen, S, dtype=torch.bfloat16, B=1, H=4, hd=256):
    """slstm_fused against slstm_ref on gate pre-activations of unit scale
    and the reference's R ~ N(0, 1/hd): h and the final (c, n, h, m). The
    plain version is a loop of about 20 launches a step: timed once, on the
    call that gives the comparison."""
    D = H * hd
    gx = randn((B, S, 4, D), gen, dtype)
    rg = randn((4, H, hd, hd), gen, torch.float32, hd ** -0.5)
    p = slstm_plan(B, S, H, hd, dtype)
    def run():
        return slstm_fused(gx, rg, H)

    got, state = run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    want, want_state = slstm_ref(gx, rg, H)
    end.record()
    torch.cuda.synchronize()
    state_err = {}
    for k, g, w in zip("cnhm", state, want_state):
        scale = w.double().abs().max().item()
        state_err[k] = (g.double() - w.double()).abs().max().item() / max(scale, 1e-30)
    es = gx.element_size()
    # gx read once, h and the final state written once, R read once
    n_bytes = es * (B * S * 4 * D + B * S * D) + 4 * (rg.numel() + 4 * B * H * hd)
    t_parts, by = bound(n_bytes, 2.0 * 4 * hd * hd * H * S * B, torch.float32)
    kernel_ms = cuda_ms(lambda: run()[0])
    line = compare(
        "slstm_fused", (B, S, 4, D), dtype, got, want, kernel_ms, start.elapsed_time(end), None, t_parts, by,
        one_rounding=True, f32_tol=SLSTM_TOL,
        extra={"heads": H, "state_max_rel_err": state_err, "plan": dataclasses.asdict(p),
               "steps": S, "step_us": kernel_ms * 1e3 / S,
               "graph_ms": graph_ms(lambda: run()[0], reps=3)})
    if not all(torch.isfinite(t).all().item() for t in state) or max(state_err.values()) > SLSTM_TOL:
        fail(f"slstm_fused {(B, S, 4, D)} {dtype}: final state off by {state_err} of max|plain| "
             f"(limit {SLSTM_TOL})")
    return line


def check_slstm_bwd(gen, S, dtype=torch.bfloat16, B=TRAIN_BATCH, H=4, hd=256, one_wave=False):
    """slstm_fused_bwd at (B, S, H, hd) against slstm_bwd_ref on the same
    saved state and dh: dgx in float32 within rtol 1e-3, atol 1e-4 of
    max|plain| element by element (tests/test_layers.py:121), bfloat16
    within 2e-2 of max|plain|; dR (float32) at the float32 limit; a second
    call's bits. Also the forward's h bitwise with and without save, its
    saved state within SLSTM_TOL of the plain forward's, and the cost of
    saving. Inputs of unit scale, R ~ N(0, 1/hd), as check_slstm. The
    plan's step floor (its exchange alone, S steps) times the sequential
    part of the bound; with ``one_wave`` the check fails unless the card
    holds every cluster of the backward at once."""
    D = H * hd
    gx = randn((B, S, 4, D), gen, dtype)
    rg = randn((4, H, hd, hd), gen, torch.float32, hd ** -0.5)
    dh = randn((B, S, D), gen, dtype)
    shape = (B, S, H, hd)
    plain_h, _ = slstm_fused(gx, rg, H)
    h, _, saved = slstm_fused(gx, rg, H, save=True)
    torch.cuda.synchronize()
    if not torch.equal(h, plain_h):
        fail(f"slstm_fused {shape} {dtype}: h changes when the state is saved")
    _, _, want_saved = slstm_ref(gx, rg, H, save=True)
    saved_err = {}
    for row, name in enumerate(("i", "f", "z", "o", "c", "n", "m")):
        w = want_saved[:, :, row].double()
        saved_err[name] = ((saved[:, :, row].double() - w).abs().max()
                           / w.abs().max().clamp(min=1e-30)).item()
    del want_saved
    if max(saved_err.values()) > SLSTM_TOL:
        fail(f"slstm_fused {shape} {dtype}: saved state off by {saved_err} of max|plain|")

    def run():
        return slstm_fused_bwd(rg, saved, dh, H)

    got = run()
    again = run()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"slstm_fused_bwd {shape} {dtype}: two calls differ")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = slstm_bwd_ref(rg, saved, dh, H)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    errs, over = [], []
    for name, g, w, dt in zip(("dgx", "dR"), got, want, (dtype, torch.float32)):
        if not torch.isfinite(g).all().item():
            fail(f"slstm_fused_bwd {shape} {dtype}: non-finite {name}")
        wd = w.double()
        diff = (g.double() - wd).abs()
        scale = wd.abs().max().item()
        errs.append(diff.max().item())
        if dt == torch.float32:
            over.append((diff / (GRAD_RTOL * wd.abs() + GRAD_ATOL * scale)).max().item())
        else:
            over.append(diff.max().item() / (TOL[dt] * scale))
    p, pb = slstm_plan(B, S, H, hd, dtype), slstm_plan_bwd(B, S, H, hd, dtype)
    fwd_clusters = slstm_active_clusters(p, dtype)
    bwd_clusters = slstm_active_clusters(pb, dtype)
    xbuf = torch.empty(pb.xbuf_floats, device=dh.device)
    floor_ms = graph_ms(lambda: slstm_bwd_step_floor(pb, S, xbuf), reps=3)
    es = gx.element_size()
    # saved, dh and R read once, dgx and dR written once
    n_bytes = 4 * saved.numel() + es * (dh.numel() + 4 * B * S * D) + 2 * 4 * rg.numel()
    # the recurrence's R^T dg and the dR product: 8 hd^2 flop each a step and (row, head)
    n_ops = 2 * 8.0 * hd * hd * H * S * B
    t_parts, by = bound(n_bytes, n_ops, torch.float32)
    dg32 = got[0].float()
    kernel_ms = cuda_ms(run, reps=3, warmup=1)
    line = {
        "kernel": "slstm_fused_bwd", "shape": list(shape),
        "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": errs[0], "max_abs_err_dgx_dR": errs, "err_over_limit": over,
        "tol": "rtol 1e-3, atol 1e-4 max" if dtype == torch.float32 else
        {"dgx": TOL[dtype], "dR": "rtol 1e-3, atol 1e-4 max"},
        "same_bits": True, "h_bits_same_with_save": True, "saved_max_rel_err": saved_err,
        "kernel_ms": kernel_ms, "graph_ms": graph_ms(run, reps=3),
        "dr_ms": cuda_ms(lambda: slstm_dr(saved, dg32, H), reps=3, warmup=1),
        "plain_ms": plain_ms, "library_ms": None,
        "library_note": "none: no single PyTorch call computes this recurrence's gradient",
        "bound_ms": max(t_parts), "bound_by": by,
        "bound_3xtf32_ms": bound_3xtf32(n_bytes, n_ops, torch.float32),
        "step_floor_us": floor_ms * 1e3 / S, "floor_bound_ms": floor_ms,
        "bound_note": f"operations bound {max(t_parts):.3f} ms; the S sequential steps at the "
                      f"measured step floor (the exchange alone) {floor_ms:.3f} ms",
        "steps": S, "step_us": kernel_ms * 1e3 / S,
        "forward_graph_ms": graph_ms(lambda: slstm_fused(gx, rg, H)[0], reps=3),
        "forward_save_graph_ms": graph_ms(lambda: slstm_fused(gx, rg, H, save=True)[0], reps=3),
        "saved_bytes": 4 * saved.numel(),
        "active_clusters": {"forward": fwd_clusters, "backward": bwd_clusters},
        "clusters": {"forward": p.grid[1] * p.grid[2], "backward": pb.clusters},
        "waves": {"forward": math.ceil(p.grid[1] * p.grid[2] / fwd_clusters),
                  "backward": math.ceil(pb.clusters / bwd_clusters)},
        "rows_per_cluster": pb.rows, "cluster": pb.cluster, "product": pb.product,
        "plan": dataclasses.asdict(pb), "forward_plan": dataclasses.asdict(p)}
    emit(line)
    if one_wave and line["waves"]["backward"] != 1:
        fail(f"slstm_fused_bwd {shape} {dtype}: {pb.clusters} clusters in "
             f"{line['waves']['backward']} waves ({bwd_clusters} resident), not one")
    if max(over) > 1.0:
        fail(f"slstm_fused_bwd {shape} {dtype}: errors {over} times the limit")
    return line


def summary(lines, repeat: int = 1) -> dict:
    """A kernel's numbers over one run of its path: times summed over the
    path's shapes (``repeat`` runs of each), errors the worst; with the
    3xTF32 bound where every line has one, and the time a step of a
    recurrence."""
    parts = [0.0, 0.0]
    for ln in lines:
        # bound_ms of a line is max(bytes, ops): recover which one it was
        parts[ln["bound_by"] == "operations"] += ln["bound_ms"]
    extra = {}
    if all(ln.get("bound_3xtf32_ms") is not None for ln in lines):
        extra["bound_3xtf32_ms"] = repeat * sum(ln["bound_3xtf32_ms"] for ln in lines)
    for key in ("graph_ms", "library_graph_ms"):  # device time alone (CUDA graph replay)
        if all(key in ln for ln in lines):
            extra[key] = repeat * sum(ln[key] for ln in lines)
    if all("steps" in ln for ln in lines):  # a recurrence: its mean time a step
        extra["step_us"] = 1e3 * sum(ln["kernel_ms"] for ln in lines) / sum(
            ln["steps"] for ln in lines)
    return {
        "max_abs_err": max(ln["max_abs_err"] for ln in lines),
        "ms": repeat * sum(ln["kernel_ms"] for ln in lines),
        "plain_ms": repeat * sum(ln["plain_ms"] for ln in lines),
        "bound_ms": repeat * sum(ln["bound_ms"] for ln in lines),
        "bound_by": "bytes" if parts[0] >= parts[1] else "operations",
        "library_ms": None if any(ln["library_ms"] is None for ln in lines)
        else repeat * sum(ln["library_ms"] for ln in lines),
        **extra,
    }


def brief(line: dict) -> dict:
    """A kernels-phase line's shape, error and times beside SDPA's and the bound."""
    return {k: line[k] for k in ("shape", "max_abs_err", "kernel_ms", "graph_ms", "plain_ms",
                                 "library_ms", "library_graph_ms", "bound_ms", "bound_by")}


def vlm_step(self_lines: dict, cross_lines: dict, per_layer: int) -> list:
    """A train-vlm step's bfloat16 lines: ``per_layer`` calls of each of the
    group's 4 self layers (VLM_TRAIN_CUT: one group) and of its cross layer."""
    cfg = cut(VLM_ARCH, VLM_TRAIN_CUT)
    groups = cfg.num_layers // cfg.cross_attn_every
    return per_layer * groups * ((cfg.cross_attn_every - 1) * [self_lines[torch.bfloat16]]
                                 + [cross_lines[torch.bfloat16]])


def ptxas_summary(log: str) -> dict:
    """``ptxas -v`` per kernel instantiation: registers, shared memory and
    spills, keyed by a short name such as ``com_matmul_kernel<float,128,...>``."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = entry.group(1)
            # Itanium mangling: the kernel's name is preceded by its length
            end = mangled.find("_kernelI")
            end = (end if end >= 0 else mangled.find("_kernelE")) + len("_kernel")
            base = next((mangled[end - n:end] for n in range(1, end)
                         if mangled[:end - n].endswith(str(n))), mangled)
            # a type argument (bfloat16 or float) where the template has one
            dtype = (["bfloat16"] if "bfloat16" in mangled
                     else ["float"] if "_kernelIf" in mangled else [])
            args = re.findall(r"Li(\d+)E", mangled)
            name = f"{base}<{','.join(dtype + args)}>"
            out[name] = []
        elif name and ("Used" in line or "spill" in line):
            out[name].append(line.replace("ptxas info    :", "").strip())
    return {k: "; ".join(v) for k, v in out.items()}


def direct_forward(program, weights, images):
    """The direct-convolution path through the port's public kernel entry
    points: ops.conv2d per image and conv layer (ReLU fused), max-pool,
    flatten, ops.com_matmul for the FC layers."""
    feats = []
    for img in images:
        x = img
        for lp, w in zip(program.layer_programs, weights):
            l = lp.layer
            if not isinstance(l, ConvSpec):
                break
            x = ops.conv2d(x, w.view(l.k, l.k, l.c_in, l.c_out), stride=l.stride,
                           padding=l.padding, activation="relu")
            if l.pool_k > 0:
                x = _maxpool(x[None], l.pool_k, l.pool_stride)[0]
        feats.append(x.reshape(-1))
    x = torch.stack(feats)
    for lp, w in zip(program.layer_programs, weights):
        if not isinstance(lp.layer, ConvSpec):
            x = ops.com_matmul(x, w, activation="relu")
    return x


def profile_window(fn, what: str, forbid=None) -> dict:
    """Device busy time, span, idle share and the kernels by time over one
    call of ``fn`` under torch.profiler (``fn`` is run once before, to warm up).
    With ``forbid`` (a pattern), fails if a device kernel's name matches it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        fail(f"the profiler saw no device activity in {what}")
    busy, cur_s, cur_e = 0.0, None, None
    by_name = {}
    for s, e, name in spans:
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (e - s) / 1e3
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10])
    line = {"device_busy_ms": busy / 1e3, "device_span_ms": span / 1e3,
            "idle_share": 1.0 - busy / span, "host_wall_ms": wall * 1e3,
            "device_kernels": len(spans), "ms_by_kernel": top,
            "host_syncs": host_syncs(prof)}
    if forbid is not None:
        found = sorted({name for _, _, name in spans if forbid.search(name)})
        line["library_kernels"] = found
        if found:
            fail(f"{what} ran library kernels: {found}")
    return line


# the CUDA runtime calls in a trace that make the host wait for the device
# (PyTorch follows a copy from pageable host memory with a stream synchronize)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
COPY_KINDS = ("HtoD", "DtoH", "DtoD")


def host_syncs(prof) -> dict:
    """How many of each SYNC_CALLS call the trace holds, and its device
    copies by direction (a cudaMemcpyAsync device to device does not wait)."""
    counts = dict.fromkeys(SYNC_CALLS, 0)
    copies = dict.fromkeys(COPY_KINDS, 0)
    for e in prof.events():
        if e.name in counts:
            counts[e.name] += 1
        elif e.device_type == torch.autograd.DeviceType.CUDA and e.name.startswith("Memcpy "):
            kind = e.name.split()[1]
            if kind in copies:
                copies[kind] += 1
    return {**counts, "copies": copies}


def serve_wave(vocab: int, n: int = N_REQUESTS, prompts=(128, 1024), max_new: int = MAX_NEW):
    """A serve phase's greedy requests (by default the 16 of phases 6 and 8):
    prompt lengths uniform in ``prompts`` and prompt tokens, both from
    numpy.random.default_rng(2)."""
    rng = np.random.default_rng(2)
    lengths = rng.integers(prompts[0], prompts[1] + 1, size=n)
    return [Request(prompt=rng.integers(1, vocab, size=int(k)).astype(np.int32),
                    max_new_tokens=max_new) for k in lengths]


def prefill_logits(model, prompt, dtype, **changes):
    """The last-token logits of one batch-1 prefill of ``prompt`` with the
    model's CallConfig in ``dtype`` and ``changes``."""
    return lockstep_logits(model, prompt[None, :], {}, dtype, **changes)


def cut(arch: str, changes: dict):
    """``arch``'s config with ``changes`` (a cut depth)."""
    return dataclasses.replace(get_config(arch), **changes)


def reduced_of(cfg) -> dict:
    """A cut config's "reduced": each scalar field that differs from the
    published config's, as [published, run]."""
    full = get_config(cfg.name)
    return {f.name: [getattr(full, f.name), getattr(cfg, f.name)]
            for f in dataclasses.fields(cfg)
            if isinstance(getattr(cfg, f.name), (int, float, str))
            and getattr(cfg, f.name) != getattr(full, f.name)}


def rel_err(got, want) -> float:
    """max|got - want| / max|want|, after a finiteness check of ``got``."""
    scale = want.double().abs().max().item()
    if not torch.isfinite(got).all().item() or scale == 0.0:
        fail("non-finite prefill logits, or plain ones all zero")
    return (got.double() - want.double()).abs().max().item() / max(scale, 1e-30)


def attention_f64(q, k, v, *, causal=True, backend=None, block_kv=None):
    """Causal (top-left) GQA softmax attention computed in float64, cast back
    to ``q.dtype``: the yardstick both attention paths are measured against
    where their float32 rounding is the question."""
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    qd = q.double().reshape(B, Sq, KVH, H // KVH, hd) / math.sqrt(hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qd, k.double())
    if causal:
        keep = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    out = torch.einsum("bkgqs,bskh->bqkgh", torch.softmax(s, dim=-1), v.double())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def logits_kernel_vs_plain(f32_tol: float):
    """The serve phase's logits check: the last-token logits of every
    request's prefill with the kernel (CallConfig.kernel_backend None: the
    card's tensors launch it) against the plain version ("ref"), in float32,
    where the two differ by f32 rounding alone (limit ``f32_tol``), and in
    the served bfloat16 (limit TOL[bf16])."""
    def check(model, reqs) -> dict:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            tol = f32_tol if dtype == torch.float32 else TOL[dtype]
            name = str(dtype).replace("torch.", "")
            errs[name] = [rel_err(prefill_logits(model, r.prompt, dtype),
                                  prefill_logits(model, r.prompt, dtype, kernel_backend="ref"))
                          for r in reqs]
            for r, e in zip(reqs, errs[name]):
                if e > tol:
                    fail(f"{name} prefill logits with the kernel, prompt of {len(r.prompt)}: "
                         f"{e} of max|plain| > {tol}")
        return {"prefill_logits_max_rel_err": errs,
                "prefill_logits_tol": {"float32": f32_tol, "bfloat16": TOL[torch.bfloat16]},
                "prefill_logits_headroom": {k: (f32_tol if k == "float32" else
                                                TOL[torch.bfloat16]) / max(max(v), 1e-30)
                                            for k, v in errs.items()}}
    return check


def slstm_held(kernel_path, worst: dict):
    """``ops.slstm`` that also holds each kernel-path call against slstm_ref
    on the same inputs (real model activations): h element by element within
    one bfloat16 rounding plus SLSTM_TOL of max|plain| (float32: SLSTM_TOL of
    max|plain|), the final state within SLSTM_TOL; the worst ratio of error
    to limit goes to ``worst[dtype]``."""
    def run(gx, rg, num_heads, *, backend=None):
        h, state = kernel_path(gx, rg, num_heads, backend=backend)
        if backend is None:
            with torch.no_grad():
                want, want_state = slstm_ref(gx, rg, num_heads)
            diff, scale = (h.double() - want.double()).abs(), want.double().abs().max()
            limit = SLSTM_TOL * scale + (BF16_ULP * want.double().abs()
                                         if gx.dtype == torch.bfloat16 else 0.0)
            ratios = [(diff / limit).max().item()] + [
                ((g.double() - w.double()).abs().max() / (SLSTM_TOL * w.double().abs().max()))
                .item() for g, w in zip(state, want_state)]
            name = str(gx.dtype).replace("torch.", "")
            worst[name] = max([worst.get(name, 0.0)] + ratios)
        return h, state
    return run


def slstm_bwd_held(kernel_bwd, worst: dict):
    """``slstm_fused_bwd`` that also holds each call against slstm_bwd_ref on
    the same saved state and dh (real model activations and gradients):
    dgx and dR within rtol 1e-3, atol 1e-4 of max|plain| in float32
    (tests/test_layers.py:121), dgx within 2e-2 of max|plain| in bfloat16;
    the worst ratio of error to limit goes to ``worst[dtype]``."""
    def run(rg, saved, dh, num_heads):
        got = kernel_bwd(rg, saved, dh, num_heads)
        want = slstm_bwd_ref(rg, saved, dh, num_heads)
        name = str(dh.dtype).replace("torch.", "")
        worst[name] = max([worst.get(name, 0.0)] + grad_over_limit(got, want))
        return got
    return run


def flash_train_held(kernel_fwd, worst: dict):
    """The attention Function's forward kernel (``ops._flash_attention``,
    writing lse) that also holds each call against the plain attention on
    the same inputs (the model's own activations under training): out as
    flash_held holds it, lse within 1e-5 of max|plain lse| + 1e-5 (as
    check_flash_bwd); the worst ratio of error to limit goes to
    ``worst[dtype]``."""
    def run(q, k, v, *, causal=True, block_kv=None, return_lse=False):
        got = kernel_fwd(q, k, v, causal=causal, block_kv=block_kv, return_lse=return_lse)
        out, lse = got if return_lse else (got, None)
        with torch.no_grad():
            want, want_lse = flash_attention_ref(q, k, v, causal=causal, return_lse=True)
        want = want.double()
        limit = TOL[q.dtype] * want.abs().max() + (
            BF16_ULP * want.abs() if q.dtype == torch.bfloat16 else 0.0)
        ratios = [((out.double() - want).abs() / limit).max().item()]
        if lse is not None:
            ratios.append((lse - want_lse).abs().max().item()
                          / (1e-5 * want_lse.abs().max().item() + 1e-5))
        name = str(q.dtype).replace("torch.", "")
        worst[name] = max([worst.get(name, 0.0)] + ratios)
        return got
    return run


def attention_bwd_f64(q, k, v, dout, *, causal=True) -> tuple:
    """dq, dk, dv of attention_f64 on ``q, k, v`` taken to float64, by
    autograd: the exact gradient the float32 backwards round."""
    q, k, v = (t.detach().double().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        out = attention_f64(q, k, v, causal=causal)
    return torch.autograd.grad(out, (q, k, v), dout.double())


# the float32 attention backward held against the float64 gradient
# (flash_bwd_f64_held): each of dq, dk and dv may stand, over the held limit,
# F32_BWD_VS_PLAIN times as far from the float64 gradient as the plain float32
# backward does on the same inputs, and no further than the limit where the
# plain stands within 1 / F32_BWD_VS_PLAIN of it. Set from readings
# (scripts/train_audio_probe.py --part held; PERF.md): over musicgen-large's
# 144 float32 held calls the kernel needs 2.30 (its third step's call 45, dq
# 1.75 of the limit from float64 where the plain stands at 0.76), times 1.5
F32_BWD_VS_PLAIN = 3.5
# the key of a held-calls worst dict that reports a float32 call's distance
# from the plain backward where the call is held against float64 (ungated)
FROM_PLAIN = "float32 from plain (reported)"


def grad_over_limit(got, want) -> list:
    """For each gradient of ``got`` and ``want``, the largest error of ``got``
    over the held limit: rtol 1e-3, atol 1e-4 of max|want| in float32
    (tests/test_layers.py:121), 2e-2 of max|want| in bfloat16."""
    out = []
    for g, w in zip(got, want):
        wd = w.double()
        diff, scale = (g.double() - wd).abs(), wd.abs().max()
        if g.dtype == torch.float32:
            out.append((diff / (GRAD_RTOL * wd.abs() + GRAD_ATOL * scale)).max().item())
        else:
            out.append((diff.max() / (TOL[g.dtype] * scale)).item())
    return out


def flash_bwd_f64_ratio(got, plain, exact) -> float:
    """A float32 attention backward ``got`` (dq, dk, dv) held against the
    float64 gradient ``exact``, with the plain float32 backward ``plain`` on
    the same inputs as the measure of float32's own rounding there: the
    largest, over dq, dk and dv, of got's distance from ``exact`` over the
    held limit divided by max(1, F32_BWD_VS_PLAIN times plain's). Passes at
    1 or less."""
    return max(a / max(1.0, F32_BWD_VS_PLAIN * b)
               for a, b in zip(grad_over_limit(got, exact), grad_over_limit(plain, exact)))


def flash_bwd_held(kernel_bwd, worst: dict, *, f64: bool = False):
    """``ops._flash_attention_bwd`` that also holds each call against
    flash_attention_bwd_ref on the same (q, k, v, out, lse, dout) (real model
    activations and gradients), dq, dk and dv within grad_over_limit's
    limits, as check_flash_bwd; the worst ratio of error to limit goes to
    ``worst[dtype]``. With ``f64`` every float32 call is held against
    attention_bwd_f64 on its inputs instead (flash_bwd_f64_ratio), and its
    distance from the plain backward goes to ``worst[FROM_PLAIN]``."""
    def run(q, k, v, out, lse, dout, *, causal=True, block_kv=None):
        got = kernel_bwd(q, k, v, out, lse, dout, causal=causal, block_kv=block_kv)
        want = flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)
        name = str(q.dtype).replace("torch.", "")
        ratios = grad_over_limit(got, want)
        if f64 and q.dtype == torch.float32:
            worst[FROM_PLAIN] = max([worst.get(FROM_PLAIN, 0.0)] + ratios)
            ratios = [flash_bwd_f64_ratio(got, want, attention_bwd_f64(q, k, v, dout,
                                                                       causal=causal))]
        worst[name] = max([worst.get(name, 0.0)] + ratios)
        return got
    return run


def flash_bwd_f64_held(kernel_bwd, worst: dict):
    """flash_bwd_held with every float32 call held against the float64
    gradient: where a softmax peaks (lse to ~40) ``dp - delta`` cancels and
    the plain float32 backward itself stands several times the limit from
    it (PERF.md)."""
    return flash_bwd_held(kernel_bwd, worst, f64=True)


def slstm_reordered(gx, rg, num_heads, *, backend=None):
    """slstm_ref on the hidden units of each head in reverse order, the
    result put back: the same arithmetic with every recurrent sum taken in
    another order (the plain version's own rounding noise)."""
    hd = gx.shape[-1] // num_heads
    flip = lambda t: t.reshape(*t.shape[:-1], num_heads, hd).flip(-1).reshape(t.shape)  # noqa: E731
    h, state = slstm_ref(flip(gx).contiguous(), rg.flip(-1).flip(-2).contiguous(), num_heads)
    return flip(h), tuple(t.flip(-1) for t in state)


def logits_xlstm(model, reqs) -> dict:
    """xlstm-350m's logits check, on four prompts (the shortest, the longest
    and two between: the plain recurrence is a loop of ~20 launches a step).
    Float32: kernel path against the plain recurrence within SLSTM_TOL,
    decisive. Every sLSTM layer of those kernel-path prefills, in both
    dtypes, is held against the plain recurrence on its own inputs
    (slstm_held). Bfloat16 logits are reported beside the plain version's
    own noise, the plain path against slstm_reordered: 24 layers of bf16
    rounding make any two orders of the f32 sums disagree by several percent
    of max|logit|, so no bf16 logits limit separates a fault from that."""
    order = sorted(range(len(reqs)), key=lambda i: len(reqs[i].prompt))
    picks = [reqs[order[i]] for i in (0, len(order) // 3, 2 * len(order) // 3, len(order) - 1)]
    kernel_path, worst = ops.slstm, {}
    errs, noise = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        errs[name], noise[name] = [], []
        for r in picks:
            ops.slstm = slstm_held(kernel_path, worst)
            got = prefill_logits(model, r.prompt, dtype)
            ops.slstm = kernel_path
            plain = prefill_logits(model, r.prompt, dtype, kernel_backend="ref")
            ops.slstm = slstm_reordered
            reordered = prefill_logits(model, r.prompt, dtype, kernel_backend="ref")
            ops.slstm = kernel_path
            errs[name].append(rel_err(got, plain))
            noise[name].append(rel_err(reordered, plain))
    if max(errs["float32"]) > SLSTM_TOL:
        fail(f"float32 prefill logits with the kernel: {errs['float32']} of max|plain| "
             f"> {SLSTM_TOL}")
    line = {"prefill_logits_prompts": [len(r.prompt) for r in picks],
            "prefill_logits_max_rel_err": errs, "plain_reordered_logits_max_rel_err": noise,
            "prefill_logits_tol": {"float32": SLSTM_TOL, "bfloat16": "reported, not gated"},
            "prefill_logits_headroom": {"float32": SLSTM_TOL / max(max(errs["float32"]), 1e-30)},
            "slstm_layers_worst_err_over_limit": worst}
    if max(worst.values()) > 1.0:
        fail(f"an sLSTM layer of a served prefill is off its plain version: {worst} x the limit")
    return line


class HostTimers:
    """Each (object, method name) wrapped by a host timer that ends in a
    synchronize (the engine reads each result on the host anyway), until
    :meth:`close`; ``ms(name)`` lists the calls' times."""

    def __init__(self, *targets):
        self.targets = targets
        self.marks = {name: [] for _, name in targets}
        for obj, name in targets:
            def run(*args, _fn=getattr(obj, name), _name=name, **kwargs):
                t = time.perf_counter()
                out = _fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.marks[_name].append((t, time.perf_counter()))
                return out
            setattr(obj, name, run)

    def close(self) -> None:
        for obj, name in self.targets:
            delattr(obj, name)  # back to the class's method

    def ms(self, name, before: float = float("inf")) -> list:
        return [(e - s) * 1e3 for s, e in self.marks[name] if e <= before]


def serve(model, cfg, kernel, per_prefill: int, logits_check, phase: str, reqs=None,
          max_seq: int = MAX_SEQ) -> tuple:
    """Serve ``reqs`` (default: the wave) through Engine.generate with 8
    slots and ``max_seq`` rows a slot, and check it: ``per_prefill``
    launches of ``kernel`` a prefill, greedy tokens equal to
    generate_sequential's, and ``logits_check(model, reqs)``, whose fields
    join the phase's line. Returns the line, the kernel's launches in the
    run and the engine."""
    eng = Engine(model, batch=SLOTS, max_seq=max_seq)
    eng.generate([Request(prompt=np.arange(1, 200, dtype=np.int32), max_new_tokens=4)
                  for _ in range(2)])  # warm-up: the pool, the libraries' first calls
    reqs = serve_wave(cfg.vocab_size) if reqs is None else reqs
    timers = HostTimers((model, "prefill"), (model, "decode_step"))
    marks = timers.marks
    torch.cuda.reset_peak_memory_stats()
    kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(reqs, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launches
    peak = torch.cuda.max_memory_allocated()
    timers.close()
    stats = eng.last_stats
    n_prompt = sum(len(r.prompt) for r in reqs)
    prefill_s = sum(e - s for s, e in marks["prefill"])
    ttft = [e - t0 for _, e in marks["prefill"]]  # every request arrives at t0
    steps = [(e - s) * 1e3 for s, e in marks["decode_step"]]

    oracle = [Request(prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens) for r in reqs]
    eng.generate_sequential(oracle, seed=0)
    identical = [r.out_tokens for r in reqs] == [r.out_tokens for r in oracle]

    logits = logits_check(model, reqs)
    failures = logits.pop("_failures", [])

    gen_tokens = stats["generated_tokens"]
    line = {"phase": phase, "arch": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
            "vocab": cfg.vocab_size, "dtype": str(model.cc.compute_dtype).replace("torch.", ""),
            "reduced": reduced_of(cfg), "requests": len(reqs), "slots": SLOTS, "max_seq": max_seq,
            "prompt_tokens": n_prompt, "generated_tokens": gen_tokens, "wall_s": wall,
            "generated_tokens_s": gen_tokens / wall, "prefill_tokens_s": n_prompt / prefill_s,
            "prefill_s": prefill_s, "median_ttft_ms": statistics.median(ttft) * 1e3,
            "median_decode_step_ms": statistics.median(steps), "decode_steps": len(steps),
            "occupancy": stats["occupancy"], "prefills": stats["prefills"],
            "peak_mem_gib": peak / 2**30, f"{kernel.__name__}_launches": launches,
            "greedy_identical_to_sequential": identical, **logits}
    emit(line)
    if launches != per_prefill * stats["prefills"]:
        fail(f"serving launched {kernel.__name__} {launches} times for {stats['prefills']} "
             f"prefills, expected {per_prefill} each")
    if stats["prefills"] != len(reqs) or gen_tokens != sum(r.max_new_tokens for r in reqs) \
            or not all(r.done and len(r.out_tokens) == r.max_new_tokens
            and all(0 <= t < cfg.vocab_size for t in r.out_tokens) for r in reqs):
        fail(f"the wave did not come back whole: {stats}")
    if not identical:
        fail("Engine.generate's greedy tokens differ from generate_sequential's")
    if failures:
        fail("; ".join(failures))
    return line, launches, eng


def profile_serve(model, eng, cfg, forbid=None, prompt=None) -> None:
    """Where a prefill's (``prompt``, by default the wave's first) and an
    8-slot decode step's (at row 1000 of ``eng``'s pool) device time goes;
    with ``forbid``, fails if a kernel of that name pattern runs in the
    prefill."""
    prompt = (serve_wave(cfg.vocab_size)[0].prompt if prompt is None else prompt)[None, :]
    one = model.init_cache(1, eng.max_seq)
    emit({"phase": "profile-serve", "arch": cfg.name, "what": "prefill",
          "prompt_len": prompt.shape[1],
          **profile_window(lambda: model.prefill(prompt, one), "a prefill", forbid=forbid)})
    tok = torch.ones((SLOTS, 1), dtype=torch.long, device="cuda")
    pos = torch.full((SLOTS,), 1000, dtype=torch.long, device="cuda")
    emit({"phase": "profile-serve", "arch": cfg.name, "what": "decode_step", "slots": SLOTS,
          "pos": 1000, **profile_window(lambda: model.decode_step(tok, eng.slots.cache, pos),
                                        "a decode step")})


def close_within(got, want, rtol: float, atol: float) -> tuple:
    """Largest |got - want| and largest |got - want| / (atol + rtol |want|):
    the second is at most 1 where every element is within the tolerance
    (torch.testing.assert_close's rule)."""
    diff = (got - want).abs()
    return diff.max().item(), (diff / (atol + rtol * want.abs())).max().item()


def tab4_phase(weights, images, e2e_logits) -> None:
    """The Tab. IV evaluation through the port's own entry points, and the
    VGG-16 forward through DominoModel.functional_forward on the card."""
    rows = {df: table_iv.run(df) for df in ("com", "minimal_buffer")}
    for df, rs in rows.items():
        imps = [r["ce_improvement"] for r in rs]
        emit({"phase": "tab4", "dataflow": df,
              "ce_improvement": [min(imps), max(imps)],
              "rows": [{k: r[k] for k in ("counterpart", "model", "ours_ce", "paper_ce",
                                          "ours_thr", "paper_thr", "ours_onchip_w",
                                          "ours_offchip_w", "ours_power_w",
                                          "ce_improvement")} for r in rs]})
        for r in rs:
            vals = [v for v in r.values() if isinstance(v, float)]
            if not all(np.isfinite(vals)):
                fail(f"tab4 {df} {r['counterpart']}: a non-finite column")
            # off-chip power stays a small fraction (paper: 0.1%-3%)
            if not r["ours_offchip_w"] < 0.1 * r["ours_power_w"]:
                fail(f"tab4 {df} {r['counterpart']}: off-chip {r['ours_offchip_w']} W is "
                     f"not under 10 % of {r['ours_power_w']} W")
    # the paper's dataflow against its Tab. IV Domino column: CE within 25 %
    # of each published value, the headline CE improvement in 1.3-2.6x
    # (the reference's bands, tests/test_simulator.py:93-108)
    for r in rows["com"]:
        p = PAPER_DOMINO[r["counterpart"]]
        if COUNTERPARTS[r["counterpart"]].model != r["model"] or r["paper_ce"] != p["ce"]:
            fail(f"tab4 row {r['counterpart']} is not the paper's column")
        if abs(r["ours_ce"] - p["ce"]) > 0.25 * p["ce"]:
            fail(f"tab4 com {r['counterpart']}: CE {r['ours_ce']} not within 25 % of {p['ce']}")
    imps = [r["ce_improvement"] for r in rows["com"]]
    if not (min(imps) > 1.3 and max(imps) < 2.6):
        fail(f"tab4 com: CE improvement {min(imps)}-{max(imps)}x outside 1.3-2.6x")
    # the buffer-centric rival on the same silicon scores below COM
    for r, c in zip(rows["minimal_buffer"], rows["com"]):
        if not r["ours_ce"] < c["ours_ce"]:
            fail(f"tab4 minimal_buffer {r['counterpart']}: CE {r['ours_ce']} is not below "
                 f"COM's {c['ours_ce']}")

    model = DominoModel(resolve_network("vgg16-imagenet"))
    com_matmul.launches = conv2d_com.launches = 0
    t0 = time.perf_counter()
    res = model.functional_forward(images, weights)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"com_matmul": com_matmul.launches, "conv2d_com": conv2d_com.launches}
    bitwise = bool(torch.equal(res.outputs, e2e_logits))
    events_match = dict(res.events) == dict(model.program.event_totals)
    emit({"phase": "tab4-forward", "workload": model.workload.name, "batch": BATCH,
          "device": str(res.outputs.device), "wall_ms": wall * 1e3, "launches": launches,
          "logits_bitwise_equal_e2e": bitwise, "events_match": events_match})
    if res.outputs.device.type != "cuda" or not bitwise:
        fail("DominoModel.functional_forward's logits are not the e2e executor's bit for bit")
    if not events_match:
        fail(f"functional_forward events {res.events} != {dict(model.program.event_totals)}")
    if launches != {"com_matmul": len(model.layers), "conv2d_com": 0}:
        fail(f"functional_forward launched {launches}, expected {len(model.layers)} com_matmul")


def comgrid_phase(program, weights) -> None:
    """COMGridSim in float64 on the card at full VGG-16 width, against the
    float64 oracles at rtol = atol = 1e-10 (tests/test_simulator.py:39)."""
    rng = np.random.default_rng(4)
    conv = next(lp.layer for lp in program.layer_programs
                if isinstance(lp.layer, ConvSpec) and lp.layer.c_in == 512 and lp.layer.h_in == 14)
    fc = next(lp.layer for lp in program.layer_programs if not isinstance(lp.layer, ConvSpec))
    cases = [(conv, rng.normal(size=(conv.h_in, conv.w_in, conv.c_in)), reference_conv,
              conv_events),
             (fc, np.maximum(rng.normal(size=(fc.c_in,)), 0.0), reference_fc, fc_events)]
    for layer, x, oracle, closed_form in cases:
        lp = program.layer_program(layer.name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim = COMGridSim.from_program(program, layer.name, weights[layer.name])
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        xd = torch.as_tensor(x, device="cuda")
        sim.run(xd)  # warm-up
        sim.ev = Events()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sim.run(xd)
        torch.cuda.synchronize()
        sim_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = (oracle(xd, sim.w, layer) if isinstance(layer, ConvSpec) else oracle(xd, sim.w))
        torch.cuda.synchronize()
        oracle_s = time.perf_counter() - t0
        err, over = close_within(got, want, 1e-10, 1e-10)
        events_match = sim.ev == closed_form(layer)
        emit({"phase": "comgrid", "layer": layer.name, "shape": list(sim.w.shape),
              "c_blocks": lp.c_blocks, "m_blocks": lp.m_blocks, "device": str(got.device),
              "dtype": str(got.dtype).replace("torch.", ""),
              "weights_gb": sim.w.numel() * 8 / 1e9, "upload_s": upload_s,
              "sim_ms": sim_s * 1e3, "oracle_ms": oracle_s * 1e3, "max_abs_err": err,
              "max_err_over_tol": over, "rtol": 1e-10, "atol": 1e-10,
              "events_match": events_match})
        if got.device.type != "cuda" or got.dtype != torch.float64:
            fail(f"COMGridSim ran on {got.device} in {got.dtype}, not float64 on the card")
        if not torch.isfinite(got).all().item() or over > 1.0:
            fail(f"COMGridSim {layer.name}: {err} off the oracle ({over} x the tolerance)")
        if not events_match:
            fail(f"COMGridSim {layer.name}: events {sim.ev} != {closed_form(layer)}")
        del sim, got, want
    torch.cuda.empty_cache()


def sweep_phase() -> None:
    """smoke_1e6_grid through the torch backend on the card, full grid and in
    chunks of 65536, against the NumPy oracle on every column at the
    reference's 1e-6; the "torch-sharded" backend on make_data_mesh([cuda:0,
    cuda:0]) bitwise the unsharded torch backend, chunked and as one flat
    chunk; and the NumPy oracle against the scalar path at 1e-9 on 1,000
    sampled scenarios."""
    grid = smoke_1e6_grid()
    n = grid.n_scenarios
    t0 = time.perf_counter()
    build_batch(grid)  # the cold build: 4 networks x 54 architectures compiled
    build_cold_s = time.perf_counter() - t0
    oracle = run_sweep(grid, backend="numpy")
    runs = [("numpy", None, oracle), ("numpy", 65536, run_sweep(grid, backend="numpy",
                                                               chunk_size=65536))]
    for chunk in (None, 65536):
        for _ in range(2):  # the second run is warm
            runs.append(("torch", chunk, run_sweep(grid, chunk_size=chunk)))
    worst = 0.0
    for backend, chunk, r in runs:
        errs = {c: float(np.max(np.abs(r.columns[c] - oracle.columns[c])
                                / np.maximum(np.abs(oracle.columns[c]), 1e-300)))
                for c in COLUMNS}
        backend_s = r.engine_wall_s - r.build_wall_s
        emit({"phase": "sweep", "backend": backend, "chunk_size": chunk, "n_scenarios": n,
              "rows": int(r.columns["ce_tops_w"].shape[0]),
              "engine_wall_s": r.engine_wall_s, "build_wall_s": r.build_wall_s,
              "backend_s": backend_s, "scenarios_per_s": n / max(backend_s, 1e-12),
              "scenarios_per_s_with_build": n / max(r.engine_wall_s, 1e-12),
              "peak_chunk_bytes": r.peak_chunk_bytes,
              "max_rel_err_vs_numpy": max(errs.values()), "rtol": SWEEP_RTOL})
        if any(r.columns[c].shape != (n,) for c in COLUMNS):
            fail(f"sweep {backend} chunk={chunk}: a column does not hold {n} scenarios")
        if max(errs.values()) > SWEEP_RTOL:
            fail(f"sweep {backend} chunk={chunk}: {errs} over {SWEEP_RTOL}")
        if backend == "numpy" and max(errs.values()) != 0.0:
            fail(f"sweep numpy chunk={chunk}: not chunking-invariant ({errs})")
        worst = max(worst, max(errs.values()))
    # the "torch-sharded" backend over a data mesh of two shards of the card,
    # against the unsharded torch backend on the same flat evaluation: the
    # chunked run above, and one flat chunk of the whole grid
    sharded = make_sharded_backend(make_data_mesh([torch.device("cuda", 0)] * 2))
    chunked = [r for backend, chunk, r in runs if backend == "torch" and chunk == 65536][-1]
    for chunk, want in ((65536, chunked), (None, run_sweep(grid, chunk_size=n))):
        r = run_sweep(grid, backend=sharded, chunk_size=chunk)
        same = all(np.array_equal(r.columns[c], want.columns[c]) for c in COLUMNS)
        emit({"phase": "sweep-sharded", "n_shards": 2, "devices": "[cuda:0, cuda:0]",
              "chunk_size": chunk, "n_scenarios": n, "engine_wall_s": r.engine_wall_s,
              "backend_s": r.engine_wall_s - r.build_wall_s, "bitwise_equal_torch": same})
        if not same:
            fail(f"sweep-sharded chunk={chunk}: not bitwise the unsharded torch backend")
    sample = np.random.default_rng(0).choice(n, size=1000, replace=False)
    t0 = time.perf_counter()
    scalar_err = check_against_scalar(oracle, 1e-9, sample)
    emit({"phase": "sweep-scalar", "sampled": len(sample), "max_rel_err": scalar_err,
          "rtol": 1e-9, "seconds": time.perf_counter() - t0})
    emit({"phase": "sweep-summary", "n_scenarios": n, "build_cold_s": build_cold_s,
          "torch_max_rel_err_vs_numpy": worst, "rtol": SWEEP_RTOL,
          "device": torch.cuda.get_device_name(0)})


def forward_checks(what: str, program, weights, images, **kw) -> tuple:
    """One program's VGG-16 B=8 forward on the card through both executor
    backends: the "cuda" run (counts set to 0 just before it, read just
    after) against the float64 "reference" run within 2e-5 · max|ref|, both
    runs' events against the program's event_totals, 16 com_matmul launches
    and no conv2d_com, equal fault_info. Returns the two executors, the
    "cuda" and "reference" results, the seconds each executor took to build
    (the host's fault realization and the weights' upload) and the line."""
    t0 = time.perf_counter()
    ex = program.executor(weights, **kw)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_ex = program.executor(weights, backend="reference", **kw)
    ref_build_s = time.perf_counter() - t0
    ex.run(images)  # warm-up
    com_matmul.launches = conv2d_com.launches = 0
    res = ex.run(images)
    launches = {"com_matmul": com_matmul.launches, "conv2d_com": conv2d_com.launches}
    walls = [ex.run(images).wall_s for _ in range(5)]
    want = ref_ex.run(images)
    out = res.outputs.double()
    err = (out - want.outputs).abs().max().item()
    scale = want.outputs.abs().max().item()
    events_match = res.events == dict(program.event_totals) == want.events
    n_layers = len(program.layer_programs)
    line = {"what": what, "batch": BATCH, "mapping": program.mapping, "n_tiles": program.n_tiles,
            "n_chips": program.n_chips, "images_s": BATCH / statistics.median(walls),
            "wall_ms": [w * 1e3 for w in walls], "executor_build_s": build_s,
            "reference_build_s": ref_build_s, "fault_info": ex.fault_info,
            "logits_max_abs_err": err, "logits_max_rel_err": err / max(scale, 1e-30),
            "tol": TOL[torch.float32], "events_match": events_match, "launches": launches}
    if tuple(out.shape) != (BATCH, program.workload.layers[-1].c_out) or \
            not torch.isfinite(out).all().item():
        fail(f"{what}: logits of shape {tuple(out.shape)} are not finite")
    if scale == 0.0 or err > TOL[torch.float32] * scale:
        fail(f"{what}: logits max_abs_err {err} > {TOL[torch.float32]} * {scale}")
    if not events_match:
        fail(f"{what}: events {res.events} / {want.events} != {dict(program.event_totals)}")
    if launches != {"com_matmul": n_layers, "conv2d_com": 0}:
        fail(f"{what}: the forward launched {launches}, expected {n_layers} com_matmul")
    if ex.fault_info != ref_ex.fault_info:
        fail(f"{what}: fault_info {ex.fault_info} != {ref_ex.fault_info}")
    return ex, ref_ex, res, want, line


def faults_phase(program, weights, images, e2e_logits) -> tuple:
    """VGG-16 compiled and run around a fault set: the empty set is the
    pristine program and gives phase 4's logits bit for bit; a sampled set
    (rate 0.002 on the pristine chips plus faults_bench.py's 6 spares, cell
    rate 0.002, seed 0) with a dropped block on conv0 and on fc0 compiles
    onto a degraded placement and runs through both backends on one faulted
    weight list. Returns the faulted run's com_matmul launches and its
    line."""
    wl = program.workload
    # the sweep's 216 compiles may have evicted phase 4's cache line: compare
    # with the pristine program as the cache holds it now
    pristine = compile_program(wl)
    if compile_program(wl, faults=FaultSet.empty()) is not pristine:
        fail("faults: compile_program(faults=FaultSet.empty()) is not the pristine program")
    empty = pristine.executor(weights, faults=FaultSet.empty())
    empty_bits = bool(torch.equal(empty.run(images).outputs, e2e_logits))
    emit({"phase": "faults", "what": "empty", "same_program": True,
          "fault_info": empty.fault_info, "logits_bitwise_e2e": empty_bits})
    if not empty_bits or empty.fault_info is not None:
        fail("faults: the empty fault set did not give phase 4's logits bit for bit")
    del empty

    fc0 = next(i for i, l in enumerate(wl.layers) if not isinstance(l, ConvSpec))
    fs = FaultSet.sample(0.002, seed=0, n_chips=program.n_chips + FAULT_SPARES,
                         cell_rate=0.002)
    lp = program.layer_programs[fc0]
    fs = dataclasses.replace(fs, dead_blocks=(
        BlockFault(0, 4, 0, 0), BlockFault(fc0, 0, lp.c_blocks // 2, lp.m_blocks // 2)))
    t0 = time.perf_counter()
    pf = compile_program(wl, faults=fs)
    compile_s = time.perf_counter() - t0
    validate_fault_allocs(pf.allocs, pf.arch, fs)
    t0 = time.perf_counter()
    _, info = apply_weight_faults(wl.layers, weights, fs, pf.arch)
    realize_s = time.perf_counter() - t0
    ex, _, res, _, line = forward_checks("faulted", pf, weights, images)
    if info != ex.fault_info or info["n_blocks"] != 2 or info["n_cells"] == 0:
        fail(f"faults: fault_info {ex.fault_info} != the realization's {info}")
    agree = (res.outputs.argmax(-1) == e2e_logits.argmax(-1)).float().mean().item()
    emit({"phase": "faults", **line, "dead_tiles": len(fs.dead_tiles),
          "dead_links": len(fs.dead_links), "dead_chips": len(fs.dead_chips),
          "fleet": fs.n_chips, "pristine_chips": program.n_chips,
          "degraded_chips": degraded_chips(pf.allocs),
          "usable_tiles": [usable_tiles(fs, c) for c in range(fs.n_chips)],
          "crossing_layers": [a.layer.name for a in pf.allocs if a.crosses_chip],
          "pristine_crossing_layers": [a.layer.name for a in program.allocs if a.crosses_chip],
          "offchip_j_img": DominoModel(pf).offchip_energy_img_j(),
          "pristine_offchip_j_img": DominoModel(program).offchip_energy_img_j(),
          "compile_s": compile_s, "realize_s": realize_s,
          "argmax_agreement_with_clean": agree})
    return line["launches"]["com_matmul"], line


def search_phase(program, weights, images, e2e_logits, ref_logits) -> tuple:
    """VGG-16's mapping search on the host (search_bench.py's CI recipe:
    budget 96, seed 0, both engines; then compile_program(mapping=
    "searched"), budget 256), the two candidates' Tab. IV columns through
    the torch sweep backend on the card against NumPy, and the searched
    and a custom-blocked program (fc0's block_c halved) through both
    executor backends. Returns the searched run's com_matmul launches and
    the lines."""
    wl = program.workload
    lines = []
    for engine in ("evolve", "anneal"):
        t0 = time.perf_counter()
        r = search_mapping(wl, budget=96, engine=engine, seed=0)
        lines.append({"phase": "search", "engine": engine, "budget": 96, "seed": 0,
                      "host_s": time.perf_counter() - t0, "evaluations": r.evaluations,
                      "energy_ratio": r.energy_ratio, "improved": r.improved})
        emit(lines[-1])
        if r.cost.hop_energy_pj > r.greedy_cost.hop_energy_pj:
            fail(f"search {engine}: searched hop energy {r.cost.hop_energy_pj} > greedy's")
    t0 = time.perf_counter()
    ps = compile_program(wl, mapping="searched")
    searched_s = time.perf_counter() - t0
    r = search_mapping(wl)
    if ps.candidate != r.candidate or r.cost.hop_energy_pj > r.greedy_cost.hop_energy_pj:
        fail("search: the searched program is not search_mapping's candidate, or costs more")
    greedy = greedy_candidate(wl.layers, program.arch)
    cols = PopulationEvaluator(wl.layers).columns([greedy, ps.candidate])
    oracle = PopulationEvaluator(wl.layers, backend="numpy").columns([greedy, ps.candidate])
    col_ms = 1e3 * min(timed(PopulationEvaluator(wl.layers).columns,
                             [greedy, ps.candidate])[1] for _ in range(3))
    col_err = max(float(np.max(np.abs(cols[c] - oracle[c]) / np.maximum(np.abs(oracle[c]),
                                                                          1e-300)))
                  for c in oracle)
    ex, _, res, want, line = forward_checks("searched", ps, weights, images)
    bits = bool(torch.equal(res.outputs, e2e_logits))
    ref_ok = bool(torch.allclose(want.outputs, ref_logits, rtol=1e-9, atol=1e-12))
    lines.append({"phase": "search", **line, "budget": 256, "compile_searched_s": searched_s,
                  "energy_ratio": r.energy_ratio, "keeps_greedy_blocking":
                  (ps.candidate.block_c, ps.candidate.block_m) == (greedy.block_c,
                                                                   greedy.block_m),
                  "columns_ms_card": col_ms, "columns_max_rel_err_vs_numpy": col_err,
                  "rtol": SWEEP_RTOL, "logits_bitwise_e2e": bits,
                  "reference_logits_within_1e-9_of_e2e_reference": ref_ok})
    emit(lines[-1])
    if col_err > SWEEP_RTOL:
        fail(f"search: PopulationEvaluator.columns on the card {col_err} off NumPy")
    if not bits:
        fail("search: the searched program's cuda logits are not phase 4's bit for bit")
    if not ref_ok:
        fail("search: the searched program's reference logits are not within rtol 1e-9 of "
             "phase 4's")
    launches = line["launches"]["com_matmul"]
    del ex

    i = max(range(len(wl.layers)), key=lambda j: wl.layers[j].c_in)
    bc = list(greedy.block_c)
    bc[i] = max(1, bc[i] // 2)
    custom = dataclasses.replace(greedy, block_c=tuple(bc))
    pc = compile_program(wl, mapping=custom)
    ex, _, res, want, line = forward_checks("custom-blocking", pc, weights, images)
    bits = bool(torch.equal(res.outputs, e2e_logits))
    ref_ok = bool(torch.allclose(want.outputs, ref_logits, rtol=1e-9, atol=1e-12))
    lines.append({"phase": "search", **line, "layer": wl.layers[i].name,
                  "block_c": bc[i], "greedy_n_tiles": program.n_tiles,
                  "logits_bitwise_e2e": bits,
                  "reference_logits_within_1e-9_of_e2e_reference": ref_ok})
    emit(lines[-1])
    if pc.n_tiles <= program.n_tiles:
        fail(f"search: the custom blocking has {pc.n_tiles} tiles, greedy {program.n_tiles}")
    if not bits or not ref_ok:
        fail(f"search: custom-blocked logits: cuda bitwise {bits}, reference within 1e-9 {ref_ok}")
    return launches, lines


def rounding_plan(M: int, K: int, N: int) -> tuple:
    """The fields of com_matmul's float32 plan that set its rounding: the
    path, the k-tile, and how K is split (the order of the f32 sums)."""
    p = com_matmul_plan(M, N, K, torch.float32)
    return p.path, p.bk, p.splits, p.kchunk


def shard_phase(program, weights, images, e2e_logits, ref_logits) -> tuple:
    """Phase 4's program, weights and images through ProgramExecutor(shard=):
    "auto" on this one-card machine falls back (n_shards 1, logits bitwise
    phase 4's); [cuda:0, cuda:0] drives the split path (n_shards 2, two
    shards of B/2, 2 x 16 com_matmul launches), held against the float64
    reference within 2e-5 · max, bitwise phase 4's where no layer's plan
    changes at the shard's rows. Returns the split run's launches and line."""
    auto = program.executor(weights, shard="auto")
    got = auto.run(images)
    if auto.n_shards != 1 or got.n_shards != 1 or not torch.equal(got.outputs, e2e_logits):
        fail(f"e2e-shard: shard='auto' on one card gave n_shards {auto.n_shards} or other logits")
    del auto
    dev = torch.device("cuda", 0)
    ex = program.executor(weights, shard=[dev, dev])
    ex.run(images)  # warm-up
    com_matmul.launches = conv2d_com.launches = 0
    res = ex.run(images)
    launches = {"com_matmul": com_matmul.launches, "conv2d_com": conv2d_com.launches}
    walls = [ex.run(images).wall_s for _ in range(7)]
    changed = []
    for l in program.workload.layers:
        dims = ((l.h_out * l.w_out, l.k * l.k * l.c_in, l.c_out) if isinstance(l, ConvSpec)
                else (1, l.c_in, l.c_out))
        whole, half = (rounding_plan(b * dims[0], dims[1], dims[2]) for b in (BATCH, BATCH // 2))
        if whole != half:
            changed.append({"layer": l.name, "whole": list(whole), "shard": list(half)})
    out = res.outputs.double()
    err = (out - ref_logits).abs().max().item()
    scale = ref_logits.abs().max().item()
    bits = bool(torch.equal(res.outputs, e2e_logits))
    line = {"phase": "e2e-shard", "batch": BATCH, "n_shards": res.n_shards,
            "shards": [str(dev)] * 2, "auto_n_shards": 1, "auto_logits_bitwise_e2e": True,
            "images_s": BATCH / statistics.median(walls), "wall_ms": [w * 1e3 for w in walls],
            "launches": launches, "plans_changed": changed,
            "logits_max_rel_err_vs_reference": err / max(scale, 1e-30), "tol": TOL[torch.float32],
            "logits_bitwise_e2e": bits,
            "max_abs_diff_from_e2e": (res.outputs - e2e_logits).abs().max().item()}
    emit(line)
    n_layers = len(program.layer_programs)
    if ex.n_shards != 2 or res.n_shards != 2:
        fail(f"e2e-shard: n_shards {ex.n_shards} / {res.n_shards}, expected 2")
    if launches != {"com_matmul": 2 * n_layers, "conv2d_com": 0}:
        fail(f"e2e-shard: the split forward launched {launches}, expected {2 * n_layers} com_matmul")
    if tuple(out.shape) != tuple(ref_logits.shape) or not torch.isfinite(out).all().item():
        fail(f"e2e-shard: logits of shape {tuple(out.shape)} are not finite")
    if scale == 0.0 or err > TOL[torch.float32] * scale:
        fail(f"e2e-shard: logits max_abs_err {err} > {TOL[torch.float32]} * {scale}")
    if not changed and not bits:
        fail("e2e-shard: no layer's plan changed, yet the logits differ from phase 4's")
    return launches["com_matmul"], line


def check_clock(what: str, got: dict, want: dict) -> None:
    off = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    if off:
        fail(f"{what}: the virtual clock is not the JAX package's: {off} (got, want)")


def serve_traffic_phase(model, cfg) -> tuple:
    """chip-burst-24 through simulate(check=True) on a paged engine: the
    payload, matches_sequential, the virtual clock equal to TRAFFIC_CLOCK,
    one flash_attention launch a layer and a prefill of the served run (the oracle
    replay's own prefills follow it), and the host times of the decode
    step and of the page gather and scatter. Returns the served run's
    flash launches, the engine and the line."""
    profile = TrafficProfile.from_dict(TRAFFIC)
    eng = Engine(model, max_seq=profile.max_rows, **PAGED_POOL)
    eng.generate([Request(prompt=np.arange(1, 200, dtype=np.int32), max_new_tokens=4)
                  for _ in range(2)])  # warm-up: the pool, the libraries' first calls
    timers = HostTimers((model, "prefill"), (model, "decode_step"),
                        (eng.slots, "gather_dense"), (eng.slots, "scatter_dense"))
    served = {}
    oracle = eng.generate_sequential

    def replay(*args, **kwargs):  # the served run ends where the oracle starts
        served.update(launches=flash_attention.launches, t=time.perf_counter(),
                      peak=torch.cuda.max_memory_allocated())
        return oracle(*args, **kwargs)

    eng.generate_sequential = replay
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    torch.cuda.synchronize()
    payload = simulate(eng, profile, check=True)
    oracle_launches = flash_attention.launches - served["launches"]
    timers.close()
    del eng.generate_sequential
    steps = timers.ms("decode_step", served["t"])
    line = {"phase": "serve-traffic", "arch": cfg.name, "layers": cfg.num_layers,
            "reduced": reduced_of(cfg), "d_model": cfg.d_model, "dtype": "bfloat16", **payload,
            "max_seq": eng.max_seq, "slots": eng.batch,
            "contiguous_pages": eng.batch * eng.slots.pages_per_slot,
            "median_decode_step_ms": statistics.median(steps), "decode_step_calls": len(steps),
            "median_gather_ms": statistics.median(timers.ms("gather_dense", served["t"])),
            "median_scatter_ms": statistics.median(timers.ms("scatter_dense", served["t"])),
            "prefill_s": sum(timers.ms("prefill", served["t"])) / 1e3,
            "peak_mem_gib": served["peak"] / 2**30,
            "flash_attention_launches": served["launches"],
            "oracle_flash_attention_launches": oracle_launches}
    emit(line)
    if not payload["matches_sequential"]:
        fail("serve-traffic: the served tokens differ from generate_sequential's")
    check_clock("serve-traffic", payload, TRAFFIC_CLOCK)
    if (served["launches"] != cfg.num_layers * payload["prefills"]
            or oracle_launches != cfg.num_layers * payload["n_accepted"]):
        fail(f"serve-traffic: flash_attention launched {served['launches']} (+{oracle_launches} "
             f"in the oracle) for {payload['prefills']} prefills, expected "
             f"{cfg.num_layers} each")
    if eng.slots.allocator.n_held != 0:
        fail("serve-traffic: pages still held after the run")
    return served["launches"], eng, line


class LoggedPolicy(RestartPolicy):
    """RestartPolicy that keeps every fault identity it is asked about
    (``arrival_index * 1_000_000 + produced``, the engine's numbering)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.log = []

    def on_fault(self, step: int) -> str:
        self.log.append(step)
        return super().on_fault(step)


def serve_pair(eng, vocab, profile_dict) -> tuple:
    """A profile through Engine.serve, fault-free and then with CHIP_FAULTS
    under the patient budget: the two runs' requests in arrival order,
    their stats, flash launches, wall seconds, and each retried request's
    first retry point (tokens produced when its slot first failed)."""
    profile = TrafficProfile.from_dict(profile_dict)
    runs = []
    for faulted in (False, True):
        arrivals = generate_arrivals(profile, vocab)
        policy = LoggedPolicy(**PATIENT)
        kw = dict(faults=TransientFaults(**CHIP_FAULTS), restart_policy=policy) if faulted else {}
        flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.serve(AdmissionQueue(arrivals, max_seq=eng.max_seq), seed=0, do_sample=False, **kw)
        torch.cuda.synchronize()
        runs.append(([a.request for a in arrivals], dict(eng.last_stats),
                     flash_attention.launches, time.perf_counter() - t0, policy.log))
    first = {}
    for attempt in runs[1][4]:
        index, produced = divmod(attempt, 1_000_000)
        first[index] = min(first.get(index, produced), produced)
    return runs[0], runs[1], first


def check_pair(what, cfg, clean, faulty, first, n) -> dict:
    """The counters and makespans of a fault-free and a faulted run against
    FAULTS_CLOCK, flash launches (one a layer per prefill and per re-prefill), and
    token identity: every request whose slot never failed, and every
    retried request up to its first retry. Returns the line's numbers."""
    (creqs, cstats, claunch, cwall, _), (freqs, fstats, flaunch, fwall, _) = clean, faulty
    check_clock(f"{what} fault-free", cstats, FAULTS_CLOCK[(n, False)])
    check_clock(f"{what} faulted", fstats, FAULTS_CLOCK[(n, True)])
    if fstats["makespan_ticks"] <= cstats["makespan_ticks"]:
        fail(f"{what}: the faulted makespan is not larger than the fault-free one")
    if (claunch != cfg.num_layers * cstats["prefills"]
            or flaunch != cfg.num_layers * (fstats["prefills"] + fstats["reprefills"])):
        fail(f"{what}: flash_attention launched {claunch} / {flaunch}, expected {cfg.num_layers} "
             "per prefill and re-prefill")
    for c, f in zip(creqs, freqs):
        if not (c.done and f.done and len(c.out_tokens) == len(f.out_tokens) == c.max_new_tokens):
            fail(f"{what}: a request did not come back whole")
    unfailed = [i for i in range(n) if i not in first]
    same_unfailed = all(creqs[i].out_tokens == freqs[i].out_tokens for i in unfailed)
    same_prefix = all(creqs[i].out_tokens[:p] == freqs[i].out_tokens[:p] for i, p in first.items())
    same_after = sum(creqs[i].out_tokens == freqs[i].out_tokens for i in first)
    return {"fault_free": {k: cstats[k] for k in ("decode_steps", "makespan_ticks", "prefills",
                                                  "generated_tokens")},
            "faulted": {k: fstats[k] for k in ("decode_steps", "makespan_ticks", "prefills",
                                               "faults_injected", "retries", "reprefills",
                                               "generated_tokens")},
            "wall_s": [cwall, fwall], "flash_attention_launches": [claunch, flaunch],
            "requests_never_failed": len(unfailed), "requests_retried": len(first),
            "never_failed_identical": same_unfailed, "retried_identical_to_first_retry": same_prefix,
            "retried_identical_after_retry": same_after}


def serve_faults_phase(model, cfg, eng) -> tuple:
    """chip-burst-24-patient through Engine.serve on the paged engine of
    serve-traffic, fault-free and with CHIP_FAULTS: counters and makespans
    equal FAULTS_CLOCK, and the bfloat16 identities (check_pair); then the
    same on the first burst (8 requests) in float32, where every request
    must come back token-identical; then a poisoned token must halt the
    loop with the reference's RuntimeError. Returns the bf16 runs' flash
    launches and the lines."""
    clean, faulty, first = serve_pair(eng, cfg.vocab_size, PATIENT_TRAFFIC)
    bf16 = {"phase": "serve-faults", "dtype": "bfloat16", "layers": cfg.num_layers,
            "reduced": reduced_of(cfg), "profile": PATIENT_TRAFFIC["name"],
            "faults": CHIP_FAULTS, "restart_policy": PATIENT,
            **check_pair("serve-faults bf16", cfg, clean, faulty, first, 24)}
    emit(bf16)
    if not bf16["never_failed_identical"] or not bf16["retried_identical_to_first_retry"]:
        fail("serve-faults bf16: a request's tokens differ from the fault-free run's where they "
             "must not (never failed, or before its first retry)")
    cc = model.cc
    model.cc = dataclasses.replace(cc, compute_dtype=torch.float32, cache_dtype=torch.float32)
    eng32 = Engine(model, max_seq=eng.max_seq, **PAGED_POOL)
    burst = dict(PATIENT_TRAFFIC, name="chip-burst-8-patient", num_requests=8)
    clean, faulty, first = serve_pair(eng32, cfg.vocab_size, burst)
    model.cc = cc
    del eng32
    f32 = {"phase": "serve-faults", "dtype": "float32", "layers": cfg.num_layers,
           "reduced": reduced_of(cfg), "profile": burst["name"],
           **check_pair("serve-faults f32", cfg, clean, faulty, first, 8)}
    f32["all_identical"] = [r.out_tokens for r in clean[0]] == [r.out_tokens for r in faulty[0]]
    emit(f32)
    if not f32["all_identical"]:
        fail("serve-faults f32: the faulted run's tokens differ from the fault-free run's")
    poisoned = Engine(model, max_seq=eng.max_seq, **PAGED_POOL)
    want = ("serve loop halted after repeated faults at request 0, token 2 "
            f"(restart budget {PATIENT['max_restarts']})")
    try:
        poisoned.serve(AdmissionQueue(generate_arrivals(TrafficProfile.from_dict(burst),
                                                        cfg.vocab_size), max_seq=poisoned.max_seq),
                       seed=0, do_sample=False, faults=TransientFaults(poison=((0, 2),)),
                       restart_policy=RestartPolicy(**PATIENT))
        got = None
    except RuntimeError as e:
        got = str(e)
    emit({"phase": "serve-faults", "what": "poison", "poison": [[0, 2]], "error": got})
    if got != want:
        fail(f"serve-faults: a poisoned token gave {got!r}, expected RuntimeError({want!r})")
    return bf16["flash_attention_launches"], [bf16, f32]


def pinned_dispatch(x, logits, top_k: int, capacity: int, num_experts: int, experts):
    """repro_torch.models.moe._dispatch_group with its choice of experts
    given (``experts``, (T, k)) in place of the sort of the gates: the
    same gates, ranks, slots and scatter. Only this script's routing pin
    uses it."""
    T, D = x.shape
    gates_full = torch.softmax(logits.float(), dim=-1)
    gates = gates_full.gather(1, experts)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    flat_e = experts.reshape(-1)
    ranks = (F.one_hot(flat_e, num_experts).cumsum(dim=0) - 1).gather(1, flat_e[:, None])[:, 0]
    slot = torch.where(ranks < capacity, flat_e * capacity + ranks,
                       torch.full_like(flat_e, num_experts * capacity))
    tok = torch.arange(T, device=x.device).repeat_interleave(top_k)
    buf = x.new_zeros((num_experts * capacity + 1, D)).index_add_(0, slot, x[tok])
    return buf, slot.reshape(T, top_k), gates.to(x.dtype), gates_full


def in_backward() -> bool:
    """Whether autograd's engine is running a backward on this thread: a
    checkpointed layer's recompute runs there."""
    return torch._C._current_graph_task_id() != -1


class Routing:
    """While open, keeps the experts every moe dispatch of a forward
    chooses, one (T, k) tensor a call (the top k of the gates, a choice the
    capacity then drops included), and how many choices it dropped; with
    ``pin`` (another run's ``choices``) every call takes the pinned experts
    instead (pinned_dispatch, which drops by the same ranks). A call inside
    a backward is a checkpointed layer's recompute: it repeats the latest
    forward call with grad whose recompute has not come yet (the backward
    walks the layers in reverse) and takes that call's pin; what it chose is
    kept apart (``recomputed``, beside the forward call's index) for
    :meth:`recompute_same`. A pinned forward call also counts the (token,
    choice) pairs its own gates would have chosen apart from the pin
    (``apart``)."""

    def __init__(self, pin=None):
        self.pin = pin
        self.choices, self.drops, self.recomputed, self.pending = [], [], [], []
        self.apart = []

    def __enter__(self):
        self.orig = moe_lib._dispatch_group

        def run(x, logits, top_k, capacity, num_experts):
            recompute = in_backward()
            i = self.pending.pop() if recompute else len(self.choices)
            if self.pin is None:
                out = self.orig(x, logits, top_k, capacity, num_experts)
                experts = torch.sort(out[3], dim=-1, descending=True, stable=True)[1][:, :top_k]
            else:
                experts = self.pin[i]
                out = pinned_dispatch(x, logits, top_k, capacity, num_experts, experts)
                own = torch.sort(out[3], dim=-1, descending=True, stable=True)[1][:, :top_k]
                if not recompute:
                    self.apart.append(int((own.sort(dim=-1).values
                                           != experts.sort(dim=-1).values).sum()))
            if recompute:
                self.recomputed.append((i, experts))
            else:
                self.choices.append(experts)
                self.drops.append((out[1] == num_experts * capacity).sum())
                if torch.is_grad_enabled():
                    self.pending.append(i)
            return out
        moe_lib._dispatch_group = run
        return self

    def __exit__(self, *exc):
        moe_lib._dispatch_group = self.orig

    def dropped(self, calls=slice(None)) -> int:
        """The choices the forward dispatches dropped while open, or those of
        the forward calls ``calls`` (a slice)."""
        return int(sum(int(d) for d in self.drops[calls]))

    def recompute_same(self) -> bool:
        """Every recompute chose what its forward call chose."""
        return all(torch.equal(c, self.choices[i]) for i, c in self.recomputed)


def routing_differences(a: list, b: list) -> dict:
    """Between two runs' choices: the (layer, token) pairs whose sets of
    experts differ, and whether the last token's do in some layer."""
    diff = [(x.sort(dim=-1).values != y.sort(dim=-1).values).any(dim=-1) for x, y in zip(a, b)]
    return {"tokens": int(sum(d.sum().item() for d in diff)),
            "last_token": bool(any(d[-1].item() for d in diff))}


def logits_moe(model, reqs) -> dict:
    """The moe serve phase's logits check, every request's prefill: the
    kernel path against the plain attention. Float32: within 2e-5 · max,
    decisive. Bfloat16: with the expert choices pinned to the plain run's
    (the two paths then differ by the attention's rounding alone), within
    2e-2 · max; unpinned, reported beside the (layer, token) pairs whose
    experts differ: a bf16 router meets near-ties, and one expert swapped at
    the last token moves the logits by several percent."""
    errs, pinned, routing = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        errs[name], pinned[name], routing[name] = [], [], []
        for r in reqs:
            with Routing() as plain_route:
                plain = prefill_logits(model, r.prompt, dtype, kernel_backend="ref")
            with Routing() as kernel_route:
                got = prefill_logits(model, r.prompt, dtype)
            with Routing(pin=plain_route.choices):
                got_pinned = prefill_logits(model, r.prompt, dtype)
            errs[name].append(rel_err(got, plain))
            pinned[name].append(rel_err(got_pinned, plain))
            routing[name].append(routing_differences(kernel_route.choices, plain_route.choices))
    failures = [f"{name} prefill logits with the kernel, prompt of {len(r.prompt)}: "
                f"{e} of max|plain| > {tol}"
                for name, lst, tol in (("float32", errs["float32"], TOL[torch.float32]),
                                       ("bfloat16, routing pinned", pinned["bfloat16"],
                                        TOL[torch.bfloat16]))
                for r, e in zip(reqs, lst) if e > tol]
    return {"_failures": failures, "prefill_logits_max_rel_err": errs,
            "prefill_logits_pinned_max_rel_err": pinned,
            "prefill_routing_differences": routing,
            "prefill_logits_tol": {"float32": TOL[torch.float32],
                                   "bfloat16": f"{TOL[torch.bfloat16]} with the routing pinned"},
            "prefill_logits_headroom": {
                "float32": TOL[torch.float32] / max(max(errs["float32"]), 1e-30),
                "bfloat16_pinned": TOL[torch.bfloat16] / max(max(pinned["bfloat16"]), 1e-30)}}


def flash_held(kernel_path, worst: dict):
    """``ops.flash_attention`` that also holds each kernel-path call against
    the plain attention on the same inputs (the model's own activations):
    every element within one rounding of the dtype (2^-7 of the element for
    bfloat16, none for float32) plus TOL[dtype] of max|plain|; the worst
    ratio of error to limit goes to ``worst[dtype]``."""
    def run(q, k, v, *, causal=True, backend=None, block_kv=None):
        out = kernel_path(q, k, v, causal=causal, backend=backend)
        if backend is None:
            want = flash_attention_ref(q, k, v, causal=causal).double()
            limit = TOL[q.dtype] * want.abs().max() + (
                BF16_ULP * want.abs() if q.dtype == torch.bfloat16 else 0.0)
            name = str(q.dtype).replace("torch.", "")
            worst[name] = max(worst.get(name, 0.0),
                              ((out.double() - want).abs() / limit).max().item())
        return out
    return run


def logits_hybrid(model, reqs) -> dict:
    """zamba2's logits check, every request's prefill, the kernel path
    against the plain attention: float32 within SSM_TOL of max|plain|;
    every flash_attention call of those kernel-path prefills, in both
    dtypes, within one rounding of the plain attention on its own inputs
    (flash_held); the float32 logits of both paths against the same model
    with a float64 attention (attention_f64), and the bfloat16 logits
    beside the plain path's own distance to that float64 attention,
    reported. Returns the fields, failures under ``_failures``."""
    kernel_path, worst, failures = ops.flash_attention, {}, []
    errs, exact_err = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        errs[name], exact_err[name] = [], {"kernel": [], "plain": []}
        for r in reqs:
            ops.flash_attention = flash_held(kernel_path, worst)
            got = prefill_logits(model, r.prompt, dtype)
            ops.flash_attention = attention_f64
            exact = prefill_logits(model, r.prompt, dtype)
            ops.flash_attention = kernel_path
            plain = prefill_logits(model, r.prompt, dtype, kernel_backend="ref")
            errs[name].append(rel_err(got, plain))
            exact_err[name]["kernel"].append(rel_err(got, exact))
            exact_err[name]["plain"].append(rel_err(plain, exact))
    for r, e in zip(reqs, errs["float32"]):
        if e > SSM_TOL:
            failures.append(f"float32 prefill logits with the kernel, prompt of "
                            f"{len(r.prompt)}: {e} of max|plain| > {SSM_TOL}")
    if max(worst.values()) > 1.0:
        failures.append(f"a flash_attention call of a served prefill is off the plain "
                        f"attention on its inputs: {worst} x the limit")
    return {"prefill_logits_max_rel_err": errs, "prefill_logits_vs_f64_attention": exact_err,
            "prefill_logits_tol": {"float32": SSM_TOL, "bfloat16": "reported, not gated"},
            "prefill_logits_headroom": {"float32": SSM_TOL / max(max(errs["float32"]), 1e-30)},
            "flash_calls_worst_err_over_limit": worst, "_failures": failures}


def moe_config():
    """dbrx-132b at its published widths, depth cut to MOE_LAYERS, with the
    engine guard's own drop-free capacity factor for the 8-slot pool:
    (8 + 1) · E / (8 · k) = 4.5 (a batch-1 prefill of T tokens gets a
    capacity of int(1.125 T) >= T, drop-free too)."""
    cfg = get_config(MOE_ARCH)
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    cf = (SLOTS + 1) * E / (SLOTS * k)
    return dataclasses.replace(cfg, num_layers=MOE_LAYERS,
                               moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def with_fields(check, fields: dict, route=None):
    """``check`` (a serve phase's logits check) whose line also carries
    ``fields`` and, with ``route`` (an open Routing, closed here), the
    choices the moe dispatch dropped in the served run and its oracle
    (gated: none)."""
    def run(model, reqs) -> dict:
        out = dict(fields)
        if route is not None:
            route.__exit__()
            out.update(dispatch_choices=sum(c.numel() for c in route.choices),
                       dropped_choices=route.dropped())
        out.update(check(model, reqs))
        if out.get("dropped_choices"):
            out["_failures"] = out.get("_failures", []) + [
                f"the moe dispatch dropped {out['dropped_choices']} of "
                f"{out['dispatch_choices']} choices at a drop-free capacity factor"]
        return out
    return run


def serve_moe_phase() -> tuple:
    """dbrx-132b (full width, MOE_LAYERS layers, bf16, seed 0) serving 8
    requests through Engine.generate: serve()'s numbers and gates (4
    flash_attention launches a prefill, greedy identity, prefill logits of
    the kernel path against the plain attention: logits_moe), no dropped
    choice; then its profile windows.
    Returns the flash launches of the served run and the line."""
    cfg = moe_config()
    full = get_config(MOE_ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg, CallConfig(), device="cuda", seed=0)
    torch.cuda.synchronize()
    fields = {"reduced": {"num_layers": [full.num_layers, cfg.num_layers]},
              "d_ff": cfg.d_ff, "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
              "capacity_factor": cfg.moe.capacity_factor, "rope_theta": cfg.rope_theta,
              "weights_gib": sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30,
              "init_s": time.perf_counter() - t0}
    reqs = serve_wave(cfg.vocab_size, MOE_REQUESTS, MOE_PROMPTS, MOE_NEW)
    line, launches, eng = serve(model, cfg, flash_attention, cfg.num_layers,
                                with_fields(logits_moe, fields, Routing().__enter__()),
                                "serve-moe", reqs=reqs, max_seq=MOE_MAX_SEQ)
    profile_serve(model, eng, cfg, prompt=reqs[0].prompt)
    return launches, line


def serve_hybrid_phase() -> tuple:
    """zamba2-1.2b at full width cut to HYBRID_SERVE_CUT (6 of 38 layers: a
    group of 6 Mamba2 blocks followed by the shared attention block, no
    tail block; bf16, seed 0) on the serve phase's wave:
    serve()'s numbers and gates with 1 flash_attention launch a prefill
    (the float32 prefill logits within SSM_TOL of the plain attention's,
    the state-space families' tolerance, reported against a float64
    attention); its profile windows; then the first burst of
    chip-burst-24-patient through simulate(check=True) on a paged pool
    (KV rows paged, the Mamba2 states dense per slot): matches_sequential,
    the virtual clock equal to the JAX package's (FAULTS_CLOCK), 1 launch
    a prefill. Returns the two runs' flash launches and the lines."""
    cfg = cut(HYBRID_ARCH, HYBRID_SERVE_CUT)
    per_prefill = cfg.num_layers // cfg.hybrid_attn_every
    model = build_model(cfg, CallConfig(), device="cuda", seed=0)
    reduced = reduced_of(cfg)
    fields = {"reduced": reduced, "groups": per_prefill, "mamba_blocks": cfg.num_layers,
              "ssd_heads": cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim,
              "ssd_head_dim": cfg.ssm.head_dim, "ssd_state": cfg.ssm.state_dim,
              "ssd_chunk": cfg.ssm.chunk}
    line, launches, eng = serve(model, cfg, flash_attention, per_prefill,
                                with_fields(logits_hybrid, fields),
                                "serve-hybrid")
    profile_serve(model, eng, cfg)
    del eng
    torch.cuda.empty_cache()

    profile = TrafficProfile.from_dict(FIRST_BURST)
    peng = Engine(model, max_seq=profile.max_rows, **PAGED_POOL)
    timers = HostTimers((model, "decode_step"), (peng.slots, "gather_dense"),
                        (peng.slots, "scatter_dense"))
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payload = simulate(peng, profile, check=True)  # the served run, then the oracle's replay
    wall = time.perf_counter() - t0
    timers.close()
    paged = {"phase": "serve-hybrid-paged", "arch": cfg.name, "layers": cfg.num_layers,
             "reduced": reduced, "dtype": "bfloat16", "profile": profile.name, **payload,
             "max_seq": peng.max_seq, "slots": peng.batch, "pool_pages": peng.slots.pool_pages,
             "contiguous_pages": peng.batch * peng.slots.pages_per_slot,
             "wall_s_with_oracle": wall,
             "median_decode_step_ms": statistics.median(timers.ms("decode_step")),
             "median_gather_ms": statistics.median(timers.ms("gather_dense")),
             "median_scatter_ms": statistics.median(timers.ms("scatter_dense")),
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
             "flash_attention_launches": flash_attention.launches}
    emit(paged)
    if not payload["matches_sequential"]:
        fail("serve-hybrid-paged: the served tokens differ from generate_sequential's")
    check_clock("serve-hybrid-paged", payload, FAULTS_CLOCK[(8, False)])
    if flash_attention.launches != per_prefill * (payload["prefills"] + payload["n_accepted"]):
        fail(f"serve-hybrid-paged: flash_attention launched {flash_attention.launches} for "
             f"{payload['prefills']} prefills and {payload['n_accepted']} in the oracle, "
             f"expected {per_prefill} each")
    if peng.slots.allocator.n_held != 0:
        fail("serve-hybrid-paged: pages still held after the run")
    return launches, paged["flash_attention_launches"], [line, paged]


class configured:
    """``with configured(model, **changes)``: the model's CallConfig with
    ``changes`` inside the block, restored after it."""

    def __init__(self, model, **changes):
        self.model, self.changes = model, changes

    def __enter__(self):
        self.cc = self.model.cc
        self.model.cc = dataclasses.replace(self.cc, **self.changes)
        return self.model

    def __exit__(self, *exc):
        self.model.cc = self.cc


def greedy(logits):
    """The next tokens from last-position logits: (B, 1, V) -> (B, 1), and
    for audio (B, 1, K, V) -> (B, 1, K), every codebook's argmax."""
    return logits.argmax(dim=-1)


def lockstep(model, tokens, new: int, kw: dict) -> dict:
    """``tokens`` (B, S), or (B, S, K) for audio, prefilled at once, then
    ``new`` greedy decode steps at a shared position, each feeding back the
    argmax. Host-clock times ending in a synchronize (TTFT: until the first
    tokens are on the host), flash_attention launches of the prefill and of
    the decode steps, peak memory, the prefill's logits and the
    ``new + 1`` generated tokens on the host."""
    B, S = tokens.shape[:2]
    cache = model.init_cache(B, S + new)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    logits, cache = model.prefill(tokens, cache, **kw)
    tok = greedy(logits)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out = [tok.cpu()]
    ttft = time.perf_counter() - t0
    prefill_launches = flash_attention.launches
    steps = []
    for i in range(new):
        t = time.perf_counter()
        step_logits, cache = model.decode_step(tok, cache, S + i)
        tok = greedy(step_logits)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t) * 1e3)
        out.append(tok.cpu())
    if not (torch.isfinite(logits).all() and torch.isfinite(step_logits).all()):
        fail(f"{model.cfg.name}: non-finite logits in the lockstep run")
    return {"prefill_ms": prefill_s * 1e3, "ttft_ms": ttft * 1e3, "steps_ms": steps,
            "prefill_launches": prefill_launches,
            "decode_launches": flash_attention.launches - prefill_launches,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "logits": logits, "tokens": torch.cat(out, dim=1)}


def lockstep_logits(model, tokens, kw: dict, dtype, attention=None, **changes):
    """The prefill's last-token logits of ``tokens`` with the model's
    CallConfig in ``dtype`` (cache too) and ``changes``; with ``attention``,
    that function in place of ops.flash_attention."""
    kernel_path = ops.flash_attention
    if attention is not None:
        ops.flash_attention = attention
    try:
        with configured(model, compute_dtype=dtype, cache_dtype=dtype, **changes):
            return model.prefill(tokens, model.init_cache(tokens.shape[0], tokens.shape[1]),
                                 **kw)[0]
    finally:
        ops.flash_attention = kernel_path


def row_errs(got, want) -> list:
    """rel_err of each row."""
    return [rel_err(g, w) for g, w in zip(got, want)]


def model_checks(model, tokens, kw: dict, run: dict, plain: dict) -> dict:
    """The logits checks of a lockstep phase. Prefill last-token logits of
    the kernel path against the plain attention (kernel_backend="ref"):
    float32 on CHECK_ROWS rows within 2e-5 of max|plain| (and both paths
    reported against a float64 attention), every flash_attention call of
    the kernel-path prefills in both dtypes within one rounding of the plain
    attention on its own inputs (flash_held); bfloat16 on every row (the
    timed runs' logits) within 2e-2, unless the plain attention itself
    stands further than 2e-2 from a float64 attention, which is then
    reported as the case that holds. Then prefill(t[:S]) + decode_step(t[S])
    against forward(t) in float32 on CHECK_ROWS rows, rtol = atol =
    DECODE_RTOL. Returns the fields, failures under ``_failures``."""
    kernel_path, worst, failures = ops.flash_attention, {}, []
    f32, bf16 = torch.float32, torch.bfloat16
    rows = tokens[:CHECK_ROWS]
    rkw = {k: v[:CHECK_ROWS] for k, v in kw.items()}
    got = lockstep_logits(model, rows, rkw, f32, flash_held(kernel_path, worst))
    plain32 = lockstep_logits(model, rows, rkw, f32, kernel_backend="ref")
    exact32 = lockstep_logits(model, rows, rkw, f32, attention_f64)
    errs32 = row_errs(got, plain32)
    lockstep_logits(model, tokens, kw, bf16, flash_held(kernel_path, worst))
    exact16 = lockstep_logits(model, tokens, kw, bf16, attention_f64)
    errs16 = row_errs(run["logits"], plain["logits"])
    plain16_vs_f64 = row_errs(plain["logits"], exact16)
    if max(errs32) > TOL[f32]:
        failures.append(f"float32 prefill logits with the kernel: {max(errs32)} of max|plain| > "
                        f"{TOL[f32]}")
    if max(worst.values()) > 1.0:
        failures.append(f"a flash_attention call of a prefill is off the plain attention on "
                        f"its inputs: {worst} x the limit")
    if max(errs16) <= TOL[bf16]:
        case = "gated: within 2e-2 of max|plain|"
    elif max(plain16_vs_f64) > TOL[bf16]:
        case = (f"reported: the plain attention stands {max(plain16_vs_f64)} from a float64 "
                f"attention, further than {TOL[bf16]}")
    else:
        case = "failed"
        failures.append(f"bfloat16 prefill logits with the kernel: {max(errs16)} of max|plain| "
                        f"> {TOL[bf16]}, the plain attention within it of a float64 one")

    # decode against forward, float32, the kernel path: t = the prompt and
    # the kernel path's first generated token
    S = tokens.shape[1]
    t = torch.cat([rows, run["tokens"][:CHECK_ROWS, :1].to(rows.device)], dim=1)
    with configured(model, compute_dtype=f32, cache_dtype=f32):
        full, _ = model.forward(t, **rkw)
        lg, cache = model.prefill(t[:, :S], model.init_cache(CHECK_ROWS, S + 1), **rkw)
        step, _ = model.decode_step(t[:, S:S + 1], cache, S)
    decode = {"prefill": rel_err(lg[:, 0], full[:, S - 1]),
              "decode_step": rel_err(step[:, 0], full[:, S])}
    ratio = max(close_within(lg[:, 0], full[:, S - 1], DECODE_RTOL, DECODE_RTOL)[1],
                close_within(step[:, 0], full[:, S], DECODE_RTOL, DECODE_RTOL)[1])
    if ratio > 1.0:
        failures.append(f"prefill + decode_step off forward by {ratio} x rtol = atol = "
                        f"{DECODE_RTOL}")
    return {"prefill_logits_max_rel_err": {"float32": errs32, "bfloat16": errs16},
            "prefill_logits_vs_f64_attention": {
                "float32": {"kernel": row_errs(got, exact32), "plain": row_errs(plain32, exact32)},
                "bfloat16": {"plain": plain16_vs_f64}},
            "prefill_logits_tol": {"float32": TOL[f32], "bfloat16": TOL[bf16]},
            "bfloat16_case": case,
            "flash_calls_worst_err_over_limit": worst,
            "decode_vs_forward_rel_err": decode, "decode_vs_forward_over_tol": ratio,
            "decode_vs_forward_tol": {"rtol": DECODE_RTOL, "atol": DECODE_RTOL},
            "_failures": failures}


def profile_lockstep(model, cfg, tokens, kw: dict) -> None:
    """Where a lockstep prefill's and decode step's device time goes (all
    ROWS rows; the step at position S); fails if a library attention kernel
    runs in the prefill."""
    B, S = tokens.shape[:2]
    cache = model.init_cache(B, S + 1)
    emit({"phase": "profile-serve", "arch": cfg.name, "what": "prefill", "rows": B,
          "prompt_len": S, **profile_window(lambda: model.prefill(tokens, cache, **kw),
                                            "a prefill", forbid=LIBRARY_ATTENTION)})
    tok = greedy(model.prefill(tokens, cache, **kw)[0])
    emit({"phase": "profile-serve", "arch": cfg.name, "what": "decode_step", "rows": B,
          "pos": S, **profile_window(lambda: model.decode_step(tok, cache, S),
                                     "a decode step")})


def model_phase(phase: str, model, cfg, tokens, kw: dict, new: int, per_prefill: int,
                per_step: int, fields: dict) -> tuple:
    """A lockstep run of ``model`` (bf16) through its prefill and ``new``
    greedy decode steps, warmed up once: prefill ms, TTFT, decode-step ms,
    decode tokens/s, peak memory, flash_attention launches (``per_prefill``
    a prefill, ``per_step`` a decode step); the same run with the plain
    attention and how many of its greedy tokens the kernel path's equal;
    then model_checks. Returns the line and the kernel path's launches."""
    B, S = tokens.shape[:2]
    warm = model.init_cache(B, S + 2)
    logits, warm = model.prefill(tokens, warm, **kw)
    for i in range(2):
        logits, warm = model.decode_step(greedy(logits), warm, S + i)
    del warm, logits
    run = lockstep(model, tokens, new, kw)
    with configured(model, kernel_backend="ref"):
        plain = lockstep(model, tokens, new, kw)
    equal = run["tokens"] == plain["tokens"]
    diverged = (~equal).reshape(B, new + 1, -1).any(dim=-1)
    first_diff = [int(d.nonzero()[0]) if d.any() else None for d in diverged]
    checks = model_checks(model, tokens, kw, run, plain)
    failures = checks.pop("_failures")
    steps = run["steps_ms"]
    launches = run["prefill_launches"] + run["decode_launches"]
    line = {"phase": phase, "arch": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
            "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": "bfloat16", "rows": B,
            "prompt_len": S, "decode_steps": new, **fields,
            "prefill_ms": run["prefill_ms"], "ttft_ms": run["ttft_ms"],
            "prefill_tokens_s": B * S / run["prefill_ms"] * 1e3,
            "median_decode_step_ms": statistics.median(steps), "decode_steps_ms": steps,
            "decode_tokens_s": B * new / sum(steps) * 1e3,
            "peak_mem_gib": run["peak_mem_gib"],
            "flash_attention_launches": {"prefill": run["prefill_launches"],
                                         "decode": run["decode_launches"]},
            "greedy_tokens_equal_to_plain": [int(equal.sum()), equal.numel()],
            "first_token_differing_from_plain": first_diff,
            "plain_prefill_ms": plain["prefill_ms"],
            "plain_median_decode_step_ms": statistics.median(plain["steps_ms"]), **checks}
    emit(line)
    if run["prefill_launches"] != per_prefill or run["decode_launches"] != per_step * new:
        fail(f"{phase}: flash_attention launched {run['prefill_launches']} times in the "
             f"prefill and {run['decode_launches']} in {new} decode steps, expected "
             f"{per_prefill} and {per_step} each")
    if plain["prefill_launches"] + plain["decode_launches"] != 0:
        fail(f"{phase}: the plain path launched flash_attention")
    tok = run["tokens"]
    if tok.shape[:2] != (B, new + 1) or tok.min() < 0 or tok.max() >= cfg.vocab_size:
        fail(f"{phase}: generated tokens of shape {tuple(tok.shape)} outside [0, "
             f"{cfg.vocab_size})")
    if failures:
        fail(f"{phase}: " + "; ".join(failures))
    return line, launches


def model_vlm_phase() -> tuple:
    """llama-3.2-vision-90b at full width, VLM_LAYERS layers (bf16, weights
    from seed 0, image embeds from synth_image_embeds with seed 1): ROWS
    rows of a VLM_PROMPT-token prompt (default_rng(2)) and one image each,
    one prefill and VLM_NEW lockstep decode steps (model_phase: 10
    flash_attention launches a prefill, 8 self and 2 cross, and 2 a decode
    step, the cross layers at Sq = 1); its profile windows. Returns the
    kernel path's flash launches and the line."""
    full = get_config(VLM_ARCH)
    cfg = dataclasses.replace(full, num_layers=VLM_LAYERS)
    groups = cfg.num_layers // cfg.cross_attn_every
    t0 = time.perf_counter()
    model = build_model(cfg, CallConfig(), device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    image = synth_image_embeds(torch.Generator(device="cuda").manual_seed(1), cfg, ROWS)
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        1, cfg.vocab_size, size=(ROWS, VLM_PROMPT)), device="cuda")
    kw = {"image_embeds": image}
    fields = {"reduced": {"num_layers": [full.num_layers, cfg.num_layers],
                          "groups": [full.num_layers // cfg.cross_attn_every, groups]},
              "cross_attn_every": cfg.cross_attn_every, "image_tokens": cfg.num_image_tokens,
              "rope_theta": cfg.rope_theta,
              "weights_gib": sum(p.numel() * p.element_size()
                                 for p in model.parameters()) / 2**30, "init_s": init_s}
    line, launches = model_phase("model-vlm", model, cfg, tokens, kw, VLM_NEW, cfg.num_layers,
                                 groups, fields)
    profile_lockstep(model, cfg, tokens, kw)
    return launches, line


def model_audio_phase() -> tuple:
    """musicgen-large at AUDIO_CUT (bf16, weights from seed 0): ROWS rows of
    AUDIO_FRAMES frames x 4 codebooks (default_rng(3)), one prefill and
    AUDIO_NEW lockstep decode steps, each feeding back every codebook's
    argmax as the (B, 1, K) token (model_phase: one flash_attention launch a
    layer and a prefill, none a decode step); its profile windows. Returns the kernel
    path's flash launches and the line."""
    cfg = cut(AUDIO_ARCH, AUDIO_CUT)
    t0 = time.perf_counter()
    model = build_model(cfg, CallConfig(), device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(ROWS, AUDIO_FRAMES, cfg.num_codebooks)), device="cuda")
    fields = {"reduced": reduced_of(cfg), "codebooks": cfg.num_codebooks, "norm": cfg.norm,
              "activation": cfg.activation,
              "weights_gib": sum(p.numel() * p.element_size()
                                 for p in model.parameters()) / 2**30, "init_s": init_s}
    line, launches = model_phase("model-audio", model, cfg, tokens, {}, AUDIO_NEW,
                                 cfg.num_layers, 0, fields)
    profile_lockstep(model, cfg, tokens, {})
    return launches, line


def train_batches(batch: int, n: int, start: int = 0, arch: str = SERVE_ARCH,
                  seq: int = TRAIN_SEQ) -> list:
    """``n`` batches of ``batch`` rows of ``seq`` tokens (audio: ``seq``
    frames x its codebooks, as the launcher builds them) from
    SyntheticTokens(seed=0) at ``arch``'s vocabulary, from step ``start``
    (host numpy, made before any timing); for a vlm arch each with its
    step's image embeddings as the launcher draws them (image_embeds_at,
    seed 0, on the card), kept on the host in pinned memory, so that each
    step copies its (batch, 1601, 8192) bf16 embeddings to the card as a
    data loader would."""
    cfg = get_config(arch)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                      global_batch=batch, seed=0,
                                      num_codebooks=cfg.num_codebooks))
    batches = [data.batch_at(start + i) for i in range(n)]
    if cfg.family == "vlm":
        for i, b in enumerate(batches):
            b["image_embeds"] = image_embeds_at(cfg, batch, 0, start + i, "cuda").cpu().pin_memory()
    return batches


def train_opt(cell) -> OptConfig:
    """The optimizer as the launcher builds it, OptConfig(lr=3e-3,
    schedule="wsd"), warm-up a tenth of TRAIN_STEPS, with ``cell.opt``'s
    changes (train-moe's lr among them)."""
    return OptConfig(**{"lr": 3e-3, "schedule": "wsd", "warmup_steps": max(TRAIN_STEPS // 10, 1),
                        "total_steps": TRAIN_STEPS, **cell.opt})


def train_config(cell, config=None):
    """``cell.arch``'s config with ``cell.config``'s changes (or ``config``'s)."""
    return dataclasses.replace(get_config(cell.arch),
                               **(cell.config if config is None else config))


def train_setup(cell, dtype=torch.bfloat16, kernel_backend=None, config=None):
    """The model of train_config (``config``'s changes in place of
    ``cell.config``'s: the resume's depth), weights from seed 0, its
    masters in train_opt's param_dtype (float32, or bfloat16 where
    ``cell.opt`` says so), compute in ``dtype``, remat "block", the
    kernels or (``kernel_backend="ref"``) their plain versions; and its
    train state and step under train_opt."""
    model = build_model(train_config(cell, config),
                        CallConfig(compute_dtype=dtype, remat="block",
                                   kernel_backend=kernel_backend), device="cuda", seed=0)
    ocfg = train_opt(cell)
    return model, make_train_state(model, None, ocfg), make_train_step(model, ocfg)


def launches_of(kernels) -> tuple:
    return tuple(k.launches for k in kernels)


def step_metrics(m) -> tuple:
    return float(m["loss"]), float(m["grad_norm"]), float(m["aux"])


def train_steps(state, step, batches, kernels=(flash_attention, flash_attention_bwd),
                before=None) -> tuple:
    """Run ``step`` over ``batches`` (``before(i)`` ahead of step i, where
    given); returns the state, each step's (loss, grad norm, aux) and the
    launches of ``kernels`` (forward, backward) in them."""
    launched = launches_of(kernels)
    mets = []
    for i, b in enumerate(batches):
        if before is not None:
            before(i)
        state, m = step(state, b)
        mets.append(step_metrics(m))
    torch.cuda.synchronize()
    return state, mets, tuple(a - b for a, b in zip(launches_of(kernels), launched))


def state_bytes(state) -> int:
    """The bytes of a train state's parameters and moments on the card."""
    tensors = list(state["params"].parameters())
    for which in ("m", "v"):
        for mom in state["opt"][which].values():
            tensors += list(mom.values()) if isinstance(mom, dict) else [mom]
    return sum(t.numel() * t.element_size() for t in tensors)


@dataclasses.dataclass(frozen=True)
class TrainCell:
    """A train phase: ``arch`` with ``config``'s changes (a cut depth), its
    forward and backward kernels and their launches a step under remat
    "block" (``per_step``), the held checks' sequence length and their
    (loss, grad norm) limits step by step."""
    phase: str
    arch: str
    kernels: tuple
    per_step: tuple
    check_seq: int = TRAIN_SEQ
    forbid: object = None
    held_tol: dict = dataclasses.field(default_factory=lambda: TRAIN_HELD_TOL)
    # also hold each kernel call of the kernel steps against its plain version
    # on its own inputs: (ops attribute, wrapper) for the forward and the backward
    held_calls: tuple = ()
    # also run the held steps with a float64 attention (attention_f64), the
    # yardstick both attention paths are measured against
    f64_attention: bool = False
    # the plain steps lead: each held step of the other paths starts from the
    # plain path's parameters before that step, so that every step compares
    # one forward and backward on the same parameters, not the updates that
    # the steps before it compounded
    forced: bool = False
    # changes to the arch's config and to the launcher's OptConfig
    config: dict = dataclasses.field(default_factory=dict)
    opt: dict = dataclasses.field(default_factory=dict)
    # the resume check's config changes, where they differ from ``config``
    resume_config: dict = None
    # moe: the bfloat16 held steps of every other path take the plain
    # steps' expert choices (Routing), the unpinned kernel steps reported
    pin_routing: bool = False


def step_rel_errs(got, want) -> tuple:
    """Step by step, |got - want| / |want| of the loss and of the grad norm."""
    return tuple([abs(x[k] - y[k]) / abs(y[k]) for x, y in zip(got, want)] for k in (0, 1))


def held_run(cell: TrainCell, dtype, path: str, checks, worst: dict, pin=None,
             starts=None) -> tuple:
    """CHECK_STEPS held steps of one path: "kernel" (with ``cell.held_calls``
    holding each kernel call), "plain" (kernel_backend="ref") or
    "f64_attention"; with ``pin`` the moe dispatches take those experts;
    with ``starts`` (a list, ``cell.forced``) the plain path appends its
    parameters before each step to it and the other paths start each step
    from them. Returns the steps' metrics, the kernels' launches and the
    Routing."""
    originals = {attr: getattr(ops, attr) for attr, _ in cell.held_calls}
    attention = ops.flash_attention
    if path == "kernel":
        for attr, wrap in cell.held_calls:
            setattr(ops, attr, wrap(originals[attr], worst[attr]))
    elif path == "f64_attention":
        ops.flash_attention = attention_f64
    try:
        model, state, step = train_setup(cell, dtype, "ref" if path == "plain" else None)
        params, before = list(model.parameters()), None
        if starts is not None and path == "plain":
            def before(i):
                starts.append([p.detach().clone() for p in params])
        elif starts is not None:
            def before(i):
                with torch.no_grad():
                    for p, v in zip(params, starts[i]):
                        p.copy_(v)
        with Routing(pin) as route:
            _, mets, launches = train_steps(state, step, checks, cell.kernels, before)
    finally:
        for attr, fn in originals.items():
            setattr(ops, attr, fn)
        ops.flash_attention = attention
    del model, state, step, params, before
    torch.cuda.empty_cache()
    return mets, launches, route


def train_held_checks(cell: TrainCell) -> dict:
    """The train path held on the card: CHECK_STEPS steps of CHECK_BATCH x
    ``cell.check_seq`` through the kernels against the same steps with the
    plain versions forward and backward (kernel_backend="ref"), float32
    and bfloat16: each step's loss and grad norm within ``cell.held_tol``
    (with ``cell.forced`` each step of the other paths from the plain
    steps' parameters before it);
    with ``cell.held_calls`` also every kernel call of the kernel steps,
    forward and backward, against its plain version on its own inputs
    (slstm_held and slstm_bwd_held, flash_train_held and flash_bwd_held);
    with ``cell.f64_attention`` the same steps with a float64 attention,
    both paths' distances from them reported; with ``cell.pin_routing`` the
    bfloat16 steps of the kernel and float64 paths with the plain steps'
    expert choices, the unpinned kernel steps and the (layer, token) pairs
    whose experts differ reported, and every recomputed dispatch (remat)
    choosing what its forward chose. Then resume_check."""
    out, failures, t_held = {}, [], time.perf_counter()
    checks = train_batches(CHECK_BATCH, CHECK_STEPS, arch=cell.arch, seq=cell.check_seq)
    worst = {attr: {} for attr, _ in cell.held_calls}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        pinned = cell.pin_routing and dtype == torch.bfloat16
        starts = [] if cell.forced else None
        runs = {"plain": held_run(cell, dtype, "plain", checks, worst, starts=starts)}
        pin = runs["plain"][2].choices if pinned else None
        runs["kernel"] = held_run(cell, dtype, "kernel", checks, worst, pin, starts)
        if cell.f64_attention:
            runs["f64_attention"] = held_run(cell, dtype, "f64_attention", checks, worst, pin,
                                             starts)
        if pinned:
            runs["kernel_unpinned"] = held_run(cell, dtype, "kernel", checks, worst,
                                               starts=starts)
        del starts
        (kern, kl, _), (plain, pl, _) = runs["kernel"], runs["plain"]
        loss_rel, gn_rel = step_rel_errs(kern, plain)
        tol = cell.held_tol[dtype]
        out[name] = {"seq": cell.check_seq, "forced": cell.forced, "kernel": kern, "plain": plain,
                     "loss_rel_err": loss_rel, "grad_norm_rel_err": gn_rel, "tol": tol,
                     "launches_kernel": kl, "launches_plain": pl}
        if cell.f64_attention:
            exact = runs["f64_attention"][0]
            out[name]["f64_attention"] = exact
            out[name]["vs_f64_attention"] = {
                p: dict(zip(("loss_rel_err", "grad_norm_rel_err"), step_rel_errs(runs[p][0], exact)))
                for p in ("kernel", "plain")}
        if cell.pin_routing:
            free = runs["kernel_unpinned" if pinned else "kernel"]
            out[name].update(
                routing_pinned=pinned,
                dropped_choices={p: r[2].dropped() for p, r in runs.items()},
                routing_differences=routing_differences(free[2].choices, runs["plain"][2].choices))
            if pinned:
                out[name]["unpinned"] = {
                    "kernel": free[0], **dict(zip(("loss_rel_err", "grad_norm_rel_err"),
                                                  step_rel_errs(free[0], plain)))}
                if free[1] != kl:
                    failures.append(f"{name}: launches {free[1]} unpinned, {kl} pinned")
            same = {p: r[2].recompute_same() for p, r in runs.items()}
            if not all(same.values()):
                failures.append(f"{name}: a recomputed moe dispatch chose other experts than "
                                f"its forward {same}")
        if any(a > lt or g > gt for a, g, (lt, gt) in zip(loss_rel, gn_rel, tol)):
            failures.append(f"{name} kernel vs plain steps: loss {loss_rel}, grad norm {gn_rel} "
                            f"(limits {tol})")
        if any(pl) or kl != tuple(CHECK_STEPS * n for n in cell.per_step):
            failures.append(f"{name}: launches {kl} through the kernels, {pl} plain")
    if cell.held_calls:
        out["held_calls_worst_err_over_limit"] = worst
        if not all(worst.values()):
            failures.append(f"the held calls never ran: the train steps missed the kernels {worst}")
        elif max(r for w in worst.values() for k, r in w.items() if k != FROM_PLAIN) > 1.0:
            failures.append(f"a kernel call of the kernel train steps is off its plain version: "
                            f"{worst} x the limit")
    out["held_s"] = time.perf_counter() - t_held
    out["resume"] = resume_check(cell, failures)
    out["_failures"] = failures
    return out


def resume_check(cell: TrainCell, failures: list) -> dict:
    """At CHECK_BATCH x TRAIN_SEQ (the config of ``cell.resume_config`` where
    given), a bfloat16 run saved after RESUME_AT steps (build/ must have
    room for the state: checked first), taken to RESUME_AT + RESUME_MORE
    steps, its parameters then kept on the host (two full states need not
    fit the card); a fresh model and state restored from the checkpoint and
    taken RESUME_MORE steps: losses and parameters bitwise the uninterrupted
    run's. Appends to ``failures``."""
    t0 = time.perf_counter()
    config = cell.config if cell.resume_config is None else cell.resume_config
    batches = train_batches(CHECK_BATCH, RESUME_AT + RESUME_MORE, arch=cell.arch)
    ckpt_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.parent.mkdir(parents=True, exist_ok=True)
    model, state, step = train_setup(cell, config=config)
    need, free = state_bytes(state), shutil.disk_usage(ckpt_dir.parent).free
    out = {"layers": model.cfg.num_layers, "state_bytes": need, "disk_free_bytes": free}
    if free < 1.1 * need:
        failures.append(f"resume: the checkpoint needs {need} bytes, build/ has {free} free")
        return out
    losses, t_save, t_tree = [], 0.0, 0.0
    for i, b in enumerate(batches):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        if i + 1 == RESUME_AT:
            ts = time.perf_counter()
            tree = state_tree(state)
            t_tree = time.perf_counter() - ts
            ckpt_lib.save(str(ckpt_dir), RESUME_AT, tree)
            del tree
            t_save = time.perf_counter() - ts
    final = [p.detach().cpu() for p in model.parameters()]
    del model, state, step
    torch.cuda.empty_cache()
    ckpt_bytes = sum(f.stat().st_size for f in ckpt_dir.rglob("*") if f.is_file())
    fresh_model, fresh, fstep = train_setup(cell, config=config)
    ts = time.perf_counter()
    tree, manifest = ckpt_lib.restore(str(ckpt_dir), state_tree(fresh, template=True))
    t_read = time.perf_counter() - ts
    load_state_tree(fresh, tree)
    del tree
    t_restore = time.perf_counter() - ts
    resumed = []
    for b in batches[RESUME_AT:]:
        fresh, m = fstep(fresh, b)
        resumed.append(float(m["loss"]))
    same_params = all(torch.equal(a, b.to(a.device))
                      for a, b in zip(fresh_model.parameters(), final))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del fresh_model, fresh, fstep, final
    torch.cuda.empty_cache()
    out.update(saved_at=manifest["step"], losses=losses, resumed_losses=resumed,
               losses_bitwise=resumed == losses[RESUME_AT:], params_bitwise=same_params,
               checkpoint_bytes=ckpt_bytes, save_s=t_save, restore_s=t_restore,
               save_tree_s=t_tree, restore_read_s=t_read,
               leaves=len(manifest["keys"]), resume_s=time.perf_counter() - t0)
    if resumed != losses[RESUME_AT:] or not same_params:
        failures.append(f"resume: losses {resumed} against {losses[RESUME_AT:]}, parameters "
                        f"bitwise {same_params}")
    return out


def reduced_fields(cell: TrainCell) -> dict:
    """The line's ``reduced``: each config change as [published, run], the
    resume check's apart."""
    full = get_config(cell.arch)
    red = {k: [getattr(full, k), v] for k, v in cell.config.items()}
    if cell.resume_config is not None:
        red["resume"] = {k: [getattr(full, k), v] for k, v in cell.resume_config.items()}
    return red


def train_phase(cell: TrainCell) -> tuple:
    """``cell.arch`` (``cell.config``'s changes), bf16 compute, f32 masters
    (bf16 under ``cell.opt``'s param_dtype), remat "block", trained on
    batches of TRAIN_BATCH x TRAIN_SEQ tokens (vlm: with each step's image
    embeddings; audio: TRAIN_SEQ frames of its codebooks' tokens):
    TRAIN_WARMUP steps, then TRAIN_TIMED timed ones (steps/s, tokens/s,
    median ms/step, peak memory, the kernels' forward and backward launches
    a step, ``cell.per_step``), a profiled step (idle share, largest device
    items, the host's synchronizing calls), then the rest to TRAIN_STEPS: the last
    step's loss below the first's, every loss and grad norm finite; the
    parameter count, each step's aux and, for moe, the choices its
    dispatches dropped; then train_held_checks."""
    cfg = train_config(cell)
    ocfg = train_opt(cell)
    batches = train_batches(TRAIN_BATCH, TRAIN_STEPS, arch=cell.arch)
    with torch.enable_grad():
        with Routing() as route:
            model, state, step = train_setup(cell)
            n_params = sum(p.numel() for p in model.parameters())
            weights_gib = sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30
            state_gib = state_bytes(state) / 2**30
            masters = str(next(model.parameters()).dtype).replace("torch.", "")
            state, first, _ = train_steps(state, step, batches[:TRAIN_WARMUP], cell.kernels)
            torch.cuda.reset_peak_memory_stats()
            walls, mets = [], list(first)
            for k in cell.kernels:
                k.launches = 0
            for b in batches[TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_TIMED]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, b)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                mets.append(step_metrics(m))
            launches = launches_of(cell.kernels)
            peak = torch.cuda.max_memory_allocated()
            at = TRAIN_WARMUP + TRAIN_TIMED
            it = iter(batches[at:at + 2])

            def one_step():
                nonlocal state
                state, m = step(state, next(it))
                mets.append(step_metrics(m))

            prof = profile_window(one_step, "a train step", forbid=cell.forbid)
            state, rest, _ = train_steps(state, step, batches[at + 2:], cell.kernels)
            mets += rest
            del model, state, step, batches, it
            torch.cuda.empty_cache()
        held = train_held_checks(cell)
    failures = held.pop("_failures")
    ms = statistics.median(walls) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    names = [k.__name__ for k in cell.kernels]
    line = {"phase": cell.phase, "arch": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
            "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "compute": "bfloat16",
            "masters": masters, "remat": "block", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "tokens_per_step": tokens, "reduced": reduced_fields(cell),
            "optimizer": dataclasses.asdict(ocfg), "params": n_params, "weights_gib": weights_gib,
            "state_gib": state_gib,
            "median_ms_per_step": ms, "steps_s": 1e3 / ms, "tokens_s": tokens / ms * 1e3,
            "ms_per_step": [w * 1e3 for w in walls], "peak_mem_gib": peak / 2**30,
            "launches_per_step": {n: c / TRAIN_TIMED for n, c in zip(names, launches)},
            "losses": [m[0] for m in mets], "grad_norms": [m[1] for m in mets],
            "aux": [m[2] for m in mets], "profile": prof, "held": held}
    if cfg.num_codebooks:
        line.update(codebooks=cfg.num_codebooks, norm=cfg.norm, activation=cfg.activation,
                    codebook_tokens_per_step=TRAIN_BATCH * TRAIN_SEQ * cfg.num_codebooks)
    if cfg.family == "vlm":
        line.update(groups=cfg.num_layers // cfg.cross_attn_every,
                    self_layers_per_group=cfg.cross_attn_every - 1,
                    image_tokens=cfg.num_image_tokens,
                    image_embeds="image_embeds_at(seed 0) each step, bf16, pinned host memory")
    if cfg.family == "moe":
        calls = len(route.choices) // max(len(mets), 1)  # dispatches a step (layers x groups)
        E = cfg.moe.num_experts
        line.update(experts=E, top_k=cfg.moe.top_k, capacity_factor=cfg.moe.capacity_factor,
                    dispatch_choices_per_step=sum(c.numel() for c in route.choices[:calls]),
                    dropped_choices=[route.dropped(slice(i * calls, (i + 1) * calls))
                                     for i in range(len(mets))],
                    recompute_same=route.recompute_same())
        if not line["recompute_same"]:
            failures.append("a recomputed moe dispatch chose other experts than its forward")
    emit(line)
    if launches != tuple(TRAIN_TIMED * n for n in cell.per_step):
        failures.append(f"launches {dict(zip(names, launches))} in {TRAIN_TIMED} steps, "
                        f"expected {dict(zip(names, cell.per_step))} a step")
    if len(mets) != TRAIN_STEPS or not all(math.isfinite(l) and math.isfinite(g)
                                           for l, g, _ in mets):
        failures.append(f"{len(mets)} steps, non-finite loss or grad norm: {mets}")
    elif not mets[-1][0] < mets[0][0]:
        failures.append(f"the loss after {TRAIN_STEPS} steps, {mets[-1][0]}, is not below the "
                        f"first step's {mets[0][0]}")
    if failures:
        fail(f"{cell.phase}: " + "; ".join(failures))
    return line, launches


def train_cells() -> tuple:
    """The six train phases: smollm-135m at TRAIN_CUT through the attention
    kernels (5 layers: 10 forward launches a step under remat, 5 backward),
    xlstm-350m at XLSTM_CUT through the sLSTM kernels (1 pair: 2 and 1; the
    held checks at XLSTM_CHECK_SEQ, where the plain recurrence is ~20
    launches a step forward and ~40 backward),
    zamba2-1.2b at HYBRID_CUT on HYBRID_OPT through the attention kernels
    (the shared block after its one group of 6 Mamba2 blocks: 2 and 1; the
    held steps forced), dbrx-132b at
    MOE_TRAIN_LAYERS through the attention kernels (2 and 1 a layer) on
    MOE_OPT, its bfloat16 held steps with the routing pinned, and
    llama-3.2-vision-90b at VLM_TRAIN_CUT through the attention kernels at
    its self and cross shapes (2 and 1 a layer: 10 and 5) on VLM_OPT, the
    held checks at VLM_CHECK_SEQ beside a float64 attention, and
    musicgen-large at AUDIO_TRAIN_CUT through the attention kernels (3
    layers: 6 and 3), the held checks at AUDIO_CHECK_SEQ with the float32 backward calls
    held against the float64 gradient (flash_bwd_f64_held)."""
    L = cut(SERVE_ARCH, TRAIN_CUT).num_layers
    P = cut(XLSTM_ARCH, XLSTM_CUT).num_layers // 2
    hcfg = cut(HYBRID_ARCH, HYBRID_CUT)
    NG = hcfg.num_layers // hcfg.hybrid_attn_every
    VL = cut(VLM_ARCH, VLM_TRAIN_CUT).num_layers
    AL = cut(AUDIO_ARCH, AUDIO_TRAIN_CUT).num_layers
    attention = (flash_attention, flash_attention_bwd)
    flash_calls = (("_flash_attention", flash_train_held), ("_flash_attention_bwd", flash_bwd_held))
    flash_calls_f64 = (flash_calls[0], ("_flash_attention_bwd", flash_bwd_f64_held))
    return (TrainCell("train", SERVE_ARCH, attention, (2 * L, L), forbid=LIBRARY_ATTENTION,
                      config=TRAIN_CUT),
            TrainCell("train-xlstm", XLSTM_ARCH, (slstm_fused, slstm_fused_bwd), (2 * P, P),
                      check_seq=XLSTM_CHECK_SEQ, held_tol=XLSTM_HELD_TOL,
                      held_calls=(("slstm", slstm_held), ("_slstm_fused_bwd", slstm_bwd_held)),
                      config=XLSTM_CUT),
            TrainCell("train-hybrid", HYBRID_ARCH, attention, (2 * NG, NG),
                      forbid=LIBRARY_ATTENTION, held_calls=flash_calls, f64_attention=True,
                      forced=True, config=HYBRID_CUT, opt=HYBRID_OPT),
            TrainCell("train-moe", MOE_ARCH, attention, (2 * MOE_TRAIN_LAYERS, MOE_TRAIN_LAYERS),
                      forbid=LIBRARY_ATTENTION, held_calls=flash_calls,
                      config=dict(num_layers=MOE_TRAIN_LAYERS), opt=MOE_OPT, pin_routing=True),
            TrainCell("train-vlm", VLM_ARCH, attention, (2 * VL, VL), check_seq=VLM_CHECK_SEQ,
                      forbid=LIBRARY_ATTENTION, held_calls=flash_calls, f64_attention=True,
                      config=VLM_TRAIN_CUT, opt=VLM_OPT),
            TrainCell("train-audio", AUDIO_ARCH, attention, (2 * AL, AL),
                      check_seq=AUDIO_CHECK_SEQ, forbid=LIBRARY_ATTENTION,
                      held_calls=flash_calls_f64, config=AUDIO_TRAIN_CUT))


# ---------------------------------------------------------------------------
# 32. collectives: the COM ring and data/pod-parallel training over
# torch.distributed (ranks on cuda:0 in a gloo group; a one-rank NCCL group)
# ---------------------------------------------------------------------------


def spread_err(got, want) -> float:
    """max|got - want| / max|want| in float64 (inf where ``got`` is not finite)."""
    if not torch.isfinite(got).all().item():
        return math.inf
    return ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()


def com_checks(mesh, dtype) -> dict:
    """The COM collectives over ``mesh``'s "model" axis at qwen1.5-32b's MLP
    down projection (COM_TOKENS x d_ff @ d_ff x d_model), inputs drawn from
    seed 0 on the card (the same on every rank): each against one dense
    float32 product of the same inputs on the card (max|err| / max|dense|,
    for TOL[dtype]), the all-gather bitwise against every rank's own draw,
    and per strategy the counted sends, bytes and all-reduces of one call
    beside ``wire_bytes`` and the ms a call over COM_TIMED calls."""
    cfg = get_config(COM_ARCH)
    M, K, N = COM_TOKENS, cfg.d_ff, cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, w = randn((M, K), gen, dtype), randn((K, N), gen, dtype, K ** -0.5)
    bias, residual = randn((N,), gen, dtype), randn((M, N), gen, dtype)
    group = mesh.get_group("model")
    n, me = dist.get_world_size(group), dist.get_rank(group)
    c, k = N // n, K // n
    cols = slice(me * c, (me + 1) * c)
    x_l, w_l = x[:, me * k:(me + 1) * k], w[me * k:(me + 1) * k]
    dense = x.float() @ w.float()
    part = dense[:, cols]
    errs = {"reduce_scatter": spread_err(
        com_reduce_scatter((x_l @ w_l).reshape(M, n, c).transpose(0, 1), group), part)}
    own = [randn((M, c), torch.Generator(device="cuda").manual_seed(100 + p), dtype)
           for p in range(n)]
    gathered = com_all_gather(own[me], group)
    all_gather_bitwise = all(torch.equal(gathered[p], own[p]) for p in range(n))
    com_mm = make_com_matmul(mesh, "model")
    errs["com_matmul"] = spread_err(com_mm(x, w).to_local(), part)
    errs["com_matmul_silu"] = spread_err(com_mm(x, w, epilogue="silu").to_local(), F.silu(part))
    errs["com_matmul_bias_residual"] = spread_err(
        com_mm(x, w, bias=bias, residual=residual).to_local(),
        part + bias[cols].float() + residual[:, cols].float())
    errs["com_matmul_local_bidir"] = spread_err(com_matmul_local_bidir(x_l, w_l, group), part)
    strategies = {}
    out_bytes = M * N * x.element_size()
    for s in ("psum", "com", "com_bidir"):
        mm = matmul_strategy(mesh, s)
        com_lib.counters.reset()
        y = mm(x, w).to_local()
        counted = com_lib.counters.as_dict()
        errs[f"strategy_{s}"] = spread_err(y, dense if s == "psum" else part)
        dist.barrier(group=group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(COM_TIMED):
            mm(x, w)
        torch.cuda.synchronize()
        strategies[s] = {**counted, "out_bytes": out_bytes, "wire_bytes": wire_bytes(s, out_bytes, n),
                         "ms_per_call": (time.perf_counter() - t0) / COM_TIMED * 1e3}
    del x, w, bias, residual, dense
    torch.cuda.empty_cache()
    return {"errs": errs, "tol": TOL[dtype], "all_gather_bitwise": all_gather_bitwise,
            "strategies": strategies}


def _rows(t):
    """A gradient leaf as grad_compress quantizes it: rows of its first axis."""
    return t.reshape(-1) if t.ndim <= 1 else t.reshape(t.shape[0], -1)


def dp_step(mesh, cell, dtype, batch, *, compress=False, uncompressed=None) -> tuple:
    """Step 1 of ``cell`` (weights from seed 0, compute in ``dtype``) on this
    rank's ``batch`` through grad_transform(mesh, compress_pod=compress):
    loss (this rank's), grad norm (of the reduced gradients), ms, the
    kernels' launches and what the transform sent; with ``compress`` also
    each leaf held against ``uncompressed`` (the grads of the same step
    without compression): the worst |compressed - uncompressed| over its
    row's int8 bound (the pods' largest max|row| / 254, plus float32
    rounding) and the worst error-feedback residual over max|g|. Returns
    (that dict, the reduced grads)."""
    model, state, _ = train_setup(cell, dtype)
    transform, seen = grad_transform(mesh, compress_pod=compress), {}

    def capture(grads, carry):
        seen["raw"] = grads
        seen["out"] = transform(grads, carry)
        return seen["out"]

    step = make_train_step(model, train_opt(cell), grad_transform=capture)
    for kern in cell.kernels:
        kern.launches = 0
    com_lib.counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    line = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "ms": (time.perf_counter() - t0) * 1e3, "launches": list(launches_of(cell.kernels)),
            "sent": com_lib.counters.as_dict()}
    grads = seen["out"][0]
    if compress:
        data_mean = axis_mean(seen["raw"], mesh, "data")
        pod = mesh.get_group("pod")
        bound_ratio, err_ratio = 0.0, 0.0
        for name, g in grads.items():
            dm = _rows(data_mean[name].float())
            amax = com_all_gather(dm.abs().amax(dim=-1, keepdim=True), pod).amax(dim=0)
            diff = _rows((g.float() - uncompressed[name].float()).abs())
            bound_ratio = max(bound_ratio, (diff / torch.clamp_min(
                amax * (1 / 254 + 2 ** -20), 1e-30)).max().item())
            err_ratio = max(err_ratio, (state["grad_carry"][name].abs().max() /
                                        torch.clamp_min(dm.abs().max(), 1e-30)).item())
        line.update(int8_bound_ratio=bound_ratio, error_feedback_ratio=err_ratio)
    del model, state, step, seen
    torch.cuda.empty_cache()
    return line, grads


def mp_opt(cell) -> OptConfig:
    """train_opt(cell) at Adam eps MP_EPS."""
    return dataclasses.replace(train_opt(cell), eps=MP_EPS)


@contextlib.contextmanager
def held_flash(worst: dict, shapes: list):
    """Every flash forward and backward kernel call held against its plain
    version on its own inputs (flash_train_held, flash_bwd_held; the worst
    ratios to worst["fwd"] and worst["bwd"]), each forward call's local (q,
    k) shapes appended to ``shapes``."""
    originals = ops._flash_attention, ops._flash_attention_bwd
    fwd = flash_train_held(originals[0], worst.setdefault("fwd", {}))

    def recorded(q, k, v, **kw):
        shapes.append([list(q.shape), list(k.shape)])
        return fwd(q, k, v, **kw)

    ops._flash_attention = recorded
    ops._flash_attention_bwd = flash_bwd_held(originals[1], worst.setdefault("bwd", {}))
    try:
        yield
    finally:
        ops._flash_attention, ops._flash_attention_bwd = originals


def shape_counts(shapes: list) -> list:
    """[q shape, k shape, calls] for each distinct pair of shapes."""
    out = {}
    for q, k in shapes:
        out[(tuple(q), tuple(k))] = out.get((tuple(q), tuple(k)), 0) + 1
    return [[list(q), list(k), n] for (q, k), n in out.items()]


def chunk_of(whole, d) -> torch.Tensor:
    """This rank's chunk of ``whole``, laid out as the DTensor ``d``."""
    return distribute_tensor(whole, d.device_mesh, d.placements, src_data_rank=None).to_local()


def mp_step(mesh, cell, batch, dtype, yard=None) -> dict:
    """(c) and (g): step 1 of ``cell`` (weights from seed 0, compute in
    ``dtype``, remat "block", mp_opt) on ``mesh`` over the whole ``batch``
    placed by batch_shardings (each data group its rows): the parameters
    placed by param_rules (FSDP over "data", tensor parallel over "model";
    musicgen's codebook tables split over the vocabulary), the activations
    by make_shard_fn, every flash call held. Returns the loss, grad norm, ms
    (the held checks' plain versions included), launches, the flash calls'
    local shapes, the held ratios, the collectives' bytes and the embedding
    table's local shape; with ``yard`` (the one-process step's) against it:
    every gradient as the step redistributed it (``yard["grads"]``,
    grad_ratio; embed.table's apart, ROADMAP Queue 3, item 31) and every
    parameter after the update (``yard["params"]``, over 1e-5 + 1e-3 x how
    far it moved), where the yardstick holds them."""
    cc = CallConfig(compute_dtype=dtype, remat="block",
                    shard_fn=make_shard_fn(mesh, act_rules(mesh)))
    model = place_params(build_model(train_config(cell), cc, device="cuda", seed=0), mesh)
    state = make_train_state(model, None, mp_opt(cell))
    seen = {}
    step = make_train_step(model, mp_opt(cell),
                           grad_transform=lambda g, c: (seen.setdefault("g", g), c))
    worst, shapes, counter = {}, [], CommCounter()
    for kern in cell.kernels:
        kern.launches = 0
    with held_flash(worst, shapes), counter:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
    line = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "ms_held": (time.perf_counter() - t0) * 1e3, "launches": list(launches_of(cell.kernels)),
            "flash_shapes": shape_counts(shapes), "held": worst, "comms": counter.counts,
            "table_local_shape": list(model.embed["table"].to_local().shape)}
    if yard is not None and "grads" in yard:
        ratios = {n: grad_ratio(g.to_local(), chunk_of(yard["grads"][n], g), yard["scales"][n],
                                dtype) for n, g in seen["g"].items()}
        leaf = max(ratios, key=ratios.get)
        line.update(one_process=[yard["loss"], yard["grad_norm"]], grad_ratio=ratios[leaf],
                    grad_worst_leaf=leaf, embed_table_grad_ratio=ratios["embed.table"])
    if yard is not None and "params" in yard:
        ratios = {n: ((p.to_local() - chunk_of(yard["params"][n], p)).abs().max().item()
                      / (1e-5 + 1e-3 * yard["moved"][n])) for n, p in model.named_parameters()}
        leaf = max(ratios, key=ratios.get)
        line.update(param_ratio=ratios[leaf], param_worst_leaf=leaf)
    del model, state, step, seen
    torch.cuda.empty_cache()
    return line


def grad_ratio(got, want, scale: float, dtype) -> float:
    """``got`` (a gradient's shard) against ``want`` (its chunk of the
    one-process gradient), over the held limit: with float32 compute rtol
    1e-3, atol 1e-4 of ``scale`` (the whole gradient's largest magnitude);
    with bfloat16 compute 2e-2 of ``scale``. In float32, over slices of the
    first axis of at most 2**26 elements: a dbrx expert leaf's shard is 265
    M elements, whose float64 copies would not fit beside four ranks'
    blocks. ``want`` may be bfloat16 (each slice converted on its own)."""
    per = max(1, got[0].numel()) if got.ndim else 1
    step = max(1, (1 << 26) // per)
    worst = 0.0
    for i in range(0, got.shape[0] if got.ndim else 1, step):
        g, w = (t[i:i + step].float() if t.ndim else t.float() for t in (got, want))
        diff = (g - w).abs()
        if dtype == torch.float32:
            r = (diff / (GRAD_RTOL * w.abs() + GRAD_ATOL * scale)).max().item()
        else:
            r = diff.max().item() / (TOL[dtype] * scale)
        worst = max(worst, r)
    return worst


def family_config(kind: str, ep_split: int = 1):
    """The published config of a (d)-(f) check: qwen1.5-32b, dbrx-132b at
    ``ep_split``, or llama-3.2-vision-90b."""
    if kind == "dense":
        return get_config(COM_ARCH)
    if kind == "vlm":
        return get_config(VLM_ARCH)
    cfg = get_config(MOE_ARCH)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep_split=ep_split))


def family_block(kind: str, cfg):
    """One decoder block of ``cfg`` at full width, weights from seed 0 on the
    card: qwen's dense block, dbrx's moe layer or the vlm's cross layer; and
    its logical axes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    if kind == "vlm":
        return Block(cfg, gen, cross=True), block_axes(cfg, cross=True)
    moe = kind == "moe"
    return Block(cfg, gen, is_moe_layer=moe), block_axes(cfg, is_moe_layer=moe)


def family_inputs(cfg, dtype) -> tuple:
    """The block's input x and its output's cotangent dy, each (FAMILY_ROWS,
    TRAIN_SEQ, d_model) in ``dtype``, drawn on the card from seeds 1 and 2;
    the positions; and (vlm) the image context (FAMILY_ROWS, 1,601, d_model)
    from seed 3."""
    shape = (FAMILY_ROWS, TRAIN_SEQ, cfg.d_model)
    x, dy = (randn(shape, torch.Generator(device="cuda").manual_seed(s), dtype) for s in (1, 2))
    pos = torch.arange(TRAIN_SEQ, device="cuda")[None, :].expand(FAMILY_ROWS, TRAIN_SEQ)
    ctx = (randn((FAMILY_ROWS, cfg.num_image_tokens, cfg.d_model),
                 torch.Generator(device="cuda").manual_seed(3), dtype)
           if cfg.family == "vlm" else None)
    return x, dy, pos.contiguous(), ctx


def family_grads(blk, kind: str, cfg, x, dy, pos, ctx, cc, params) -> tuple:
    """The block's output, its load-balance loss (moe; else None) and the
    gradients of ``params`` for the cotangent ``dy`` on the output and
    AUX_WEIGHT on the load-balance loss (the router's gradient takes both,
    as in training)."""
    if kind == "vlm":
        out, aux = blk.forward_cross_train(x, ctx, cfg, cc), None
    else:
        out, aux = blk.forward_train(x, pos, cfg, cc)
    if isinstance(out, DTensor):
        dy = dy.redistribute(out.device_mesh, out.placements)
    outs, cots = ([out], [dy]) if aux is None else ([out, AUX_WEIGHT * aux], [dy, None])
    return out, aux, torch.autograd.grad(outs, params, cots)


def family_yardstick(name: str) -> dict:
    """The parent's one-process yardstick of a (d)-(g) check. (d)-(f): the
    block's output, aux, every parameter's gradient (family_grads; bfloat16
    compute keeps them in bfloat16: each is the cast of a bfloat16
    product), its expert choices and drops; (g): mp_audio_yardstick."""
    kind, ep, dtype, _ = FAMILY_CHECKS[name]
    if kind == "audio":
        return mp_audio_yardstick()
    cfg = family_config(kind, ep)
    blk, _ = family_block(kind, cfg)
    blk.requires_grad_(True)
    x, dy, pos, ctx = family_inputs(cfg, dtype)
    cc = CallConfig(compute_dtype=dtype, remat="none", dp_size=MP_MESH["data"])
    routing = Routing() if kind == "moe" else contextlib.nullcontext()
    with torch.enable_grad(), routing:
        out, aux, grads = family_grads(blk, kind, cfg, x, dy, pos, ctx, cc,
                                       list(blk.parameters()))
    keep = torch.float32 if dtype == torch.float32 else torch.bfloat16
    names = [n for n, _ in blk.named_parameters()]
    yard = {"out": out.detach(), "aux": None if aux is None else float(aux),
            "grads": {n: g.to(keep) for n, g in zip(names, grads)},
            "scales": {n: g.abs().max().item() for n, g in zip(names, grads)},
            "params": sum(p.numel() for p in blk.parameters())}
    if kind == "moe":
        yard.update(choices=routing.choices, drops=routing.dropped())
    del blk, grads, x, dy, ctx, out
    torch.cuda.empty_cache()
    return yard


def mp_family(mesh, name: str, yard: dict) -> dict:
    """A (d)-(f) check on ``mesh``: the block placed by param_rules over its
    axes (built one rank at a time, so that only one whole block stands on
    the card at once), family_inputs placed by batch_shardings, the forward
    and family_grads' backward with make_shard_fn, every flash call held;
    its output against ``yard``'s (2e-5 / 2e-2 of the largest magnitude),
    every gradient on its parameter's placements against its chunk of
    ``yard``'s (grad_ratio; the router's reported apart), aux, the dropped
    choices (this rank's groups), and the routing: bfloat16 pinned to
    ``yard``'s choices of this rank's groups (the pairs its own gates chose
    apart reported), float32 unpinned (its choices against ``yard``'s).
    Returns ms (held), launches, shapes, ratios and bytes."""
    kind, ep, dtype, pin = FAMILY_CHECKS[name]
    cfg = family_config(kind, ep)
    rank, world = dist.get_rank(), dist.get_world_size()
    for r in range(world):
        if r == rank:
            blk, axes = family_block(kind, cfg)
            place_params(blk, mesh, axes=axes).requires_grad_(True)
            torch.cuda.empty_cache()
        dist.barrier()
    x, dy, pos, ctx = family_inputs(cfg, dtype)
    rules = act_rules(mesh)
    x, dy, pos = (batch_shardings(rules, t).place(t) for t in (x, dy, pos))
    if ctx is not None:
        ctx = batch_shardings(rules, ctx).place(ctx)
    cc = CallConfig(compute_dtype=dtype, remat="none", dp_size=MP_MESH["data"],
                    shard_fn=make_shard_fn(mesh, rules))
    params = list(blk.named_parameters())
    group = mesh.get_local_rank("data")
    routing = (Routing(pin=[yard["choices"][group]] if pin else None) if kind == "moe"
               else contextlib.nullcontext())
    worst, shapes, counter = {}, [], CommCounter()
    for kern in (flash_attention, flash_attention_bwd):
        kern.launches = 0
    with held_flash(worst, shapes), counter, device_collectives(mesh), torch.enable_grad(), \
            routing:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, aux, grads = family_grads(blk, kind, cfg, x, dy, pos, ctx, cc,
                                       [p for _, p in params])
        grads = [g.redistribute(p.device_mesh, p.placements) for g, (_, p) in zip(grads, params)]
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    want = yard["out"]
    out_ratio = ((out.to_local().double() - chunk_of(want, out).double()).abs().max().item()
                 / (TOL[dtype] * want.double().abs().max().item()))
    ratios = {n: grad_ratio(g.to_local(), chunk_of(yard["grads"][n], p), yard["scales"][n], dtype)
              for (n, p), g in zip(params, grads)}
    leaf = max(ratios, key=ratios.get)
    line = {"ms_held": ms, "launches": list(launches_of((flash_attention, flash_attention_bwd))),
            "flash_shapes": shape_counts(shapes), "held": worst, "out_ratio": out_ratio,
            "grad_ratio": ratios[leaf], "grad_worst_leaf": leaf, "comms": counter.counts,
            "local_param_bytes": sum(p.to_local().numel() * p.to_local().element_size()
                                     for _, p in params),
            "params": yard["params"]}
    if kind == "moe":
        line.update(aux=float(aux.detach().full_tensor()), aux_one_process=yard["aux"],
                    router_grad_ratio=ratios["moe.router"],
                    drops=routing.dropped(), drops_one_process=yard["drops"],
                    pinned=pin, group=group)
        if pin:
            line["pairs_apart_unpinned"] = sum(routing.apart)
        else:
            line["routing_vs_one_process"] = routing_differences(routing.choices,
                                                                 [yard["choices"][group]])
    del blk, params, grads, out, x, dy, ctx
    torch.cuda.empty_cache()
    return line


def family_audio_cell():
    """train-audio's cell (musicgen-large at AUDIO_TRAIN_CUT)."""
    return next(c for c in train_cells() if c.arch == AUDIO_ARCH)


def mp_audio_yardstick() -> dict:
    """(g)'s yardstick: step 1 of musicgen-large at AUDIO_TRAIN_CUT (weights
    from seed 0, mp_opt) on train-audio's first batch in one process, float32
    on the whole batch and bfloat16 in MP_MESH["data"] microbatches of the
    same rows: each step's loss, grad norm and every gradient (the step's
    own, captured before the update)."""
    cell = family_audio_cell()
    batch = train_batches(TRAIN_BATCH, 1, arch=AUDIO_ARCH)[0]
    yard = {}
    with torch.enable_grad():
        for dtype, accum in ((torch.float32, 1), (torch.bfloat16, MP_MESH["data"])):
            model = build_model(train_config(cell), CallConfig(compute_dtype=dtype, remat="block"),
                                device="cuda", seed=0)
            state = make_train_state(model, None, mp_opt(cell))
            seen = {}
            step = make_train_step(model, mp_opt(cell), accum_steps=accum,
                                   grad_transform=lambda g, c: (seen.setdefault("g", g), c))
            state, m = step(state, batch)
            yard[str(dtype)] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                                "grads": {n: g.detach() for n, g in seen["g"].items()},
                                "scales": {n: g.abs().max().item() for n, g in seen["g"].items()}}
            del model, state, step, seen
            torch.cuda.empty_cache()
    return yard


def collectives_rank(rank: int, world: int, workdir: str, spawned: float, shared: dict,
                     yards: list, done) -> None:
    """One rank of the collectives phase, spawned: cuda:0, a gloo group of
    ``world`` through a file store in ``workdir``; (a) com_checks on a
    ("model",) mesh of ``world`` in float32 and bfloat16, (b) the
    smollm-135m train step (TRAIN_CUT) on a (pod=2, data=2) mesh, this
    rank's TRAIN_BATCH / world rows of the train phase's first batch:
    float32 and bfloat16 uncompressed, float32 with the compressed pod
    mean; on a MP_MESH mesh, (c) mp_step on the whole batch in float32
    (its parameters against ``shared["smollm"]``, the one-process step's)
    and bfloat16, putting its rank on ``done``, so that the parent draws
    the first yardstick; then each FAMILY_CHECKS check, (d)-(f) mp_family
    and (g) mp_step for musicgen, against the yardstick the parent puts on
    ``yards[rank]`` (a queue), putting its rank on ``done`` after each, so
    that the parent frees that one and draws the next.
    ``shared``'s and the yardsticks' tensors live on the card in the parent
    (CUDA IPC, nothing is copied). Writes its line to
    ``workdir``/rank<r>.json, with its seconds from ``spawned`` (the
    parent's wall clock at the spawn) to its start."""
    t0 = time.time()
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=COLLECTIVES_S))
    line = {"rank": rank, "seconds": {"spawn_and_import": t0 - spawned}}
    with torch.no_grad():
        mesh = make_mesh((world,), ("model",))
        line["ring"] = {str(dt).replace("torch.", ""): com_checks(mesh, dt)
                        for dt in (torch.float32, torch.bfloat16)}
    line["seconds"]["ring"] = time.time() - t0
    mesh = make_debug_mesh(data=world // 2, model=1, pod=2)
    per = TRAIN_BATCH // world
    batch = {k: v[rank * per:(rank + 1) * per] for k, v in train_batches(TRAIN_BATCH, 1)[0].items()}
    cell = train_cells()[0]
    with torch.enable_grad():
        line["float32"], grads = dp_step(mesh, cell, torch.float32, batch)
        line["bfloat16"], _ = dp_step(mesh, cell, torch.bfloat16, batch)
        line["float32_compressed"], _ = dp_step(mesh, cell, torch.float32, batch, compress=True,
                                                uncompressed=grads)
    line["pod"], line["data"] = mesh.get_local_rank("pod"), mesh.get_local_rank("data")
    line["seconds"]["train"] = time.time() - t0 - line["seconds"]["ring"]
    t1 = time.time()
    mesh = make_debug_mesh(**MP_MESH)
    whole = train_batches(TRAIN_BATCH, 1)[0]
    mpl = {}
    with torch.enable_grad():
        mpl["smollm_float32"] = mp_step(mesh, cell, whole, torch.float32, shared["smollm"])
        mpl["smollm_bfloat16"] = mp_step(mesh, cell, whole, torch.bfloat16)
    line["seconds"]["model_parallel_smollm"] = time.time() - t1
    torch.cuda.empty_cache()
    done.put(rank)
    audio = family_audio_cell()
    audio_batch = train_batches(TRAIN_BATCH, 1, arch=AUDIO_ARCH)[0]
    for name, (kind, _, _, _) in FAMILY_CHECKS.items():
        yard = yards[rank].get()
        t1 = time.time()
        with torch.enable_grad():
            if kind == "audio":
                for dt in (torch.float32, torch.bfloat16):
                    mpl[f"{name}_{dt}".replace("torch.", "")] = mp_step(mesh, audio, audio_batch,
                                                                        dt, yard[str(dt)])
            else:
                mpl[name] = mp_family(mesh, name, yard)
        line["seconds"][f"model_parallel_{name}"] = time.time() - t1
        del yard
        torch.cuda.empty_cache()
        done.put(rank)
    line["model_parallel"] = mpl
    line["mp_coords"] = {"data": mesh.get_local_rank("data"), "model": mesh.get_local_rank("model")}
    Path(workdir, f"rank{rank}.json").write_text(json.dumps(line))
    dist.destroy_process_group()


def ring_failures(what: str, ring: dict) -> list:
    """The gates of com_checks' lines: every error within its tolerance,
    the all-gather bitwise, the ring strategies' counted bytes equal to
    wire_bytes with no all-reduce, psum one all-reduce and no send."""
    out = []
    for dt, r in ring.items():
        out += [f"{what} {dt} {k}: {e} over {r['tol']}" for k, e in r["errs"].items()
                if not e <= r["tol"]]
        if not r["all_gather_bitwise"]:
            out.append(f"{what} {dt}: the all-gather is not bitwise every rank's own")
        for s, c in r["strategies"].items():
            if s == "psum":
                ok = c["sends"] == 0 and c["all_reduces"] == 1
            else:
                ok = c["bytes_sent"] == c["wire_bytes"] and c["all_reduces"] == 0
            if not ok:
                out.append(f"{what} {dt} {s}: sent {c}")
    return out


def held_failures(line: dict, what: str) -> list:
    """A rank's flash calls past their held limits (its ``held`` ratios over 1)."""
    bad = {f"{d}/{k}": v for d, w in line["held"].items() for k, v in w.items() if not v <= 1.0}
    return [f"{what}: flash calls past their held limits {bad}"] if bad else []


def local_shapes(cfg, rows: int, keys: int = TRAIN_SEQ) -> tuple:
    """A rank's flash (q, k) shapes for ``rows`` rows of ``cfg`` on MP_MESH:
    the heads split over "model" where both counts divide it (else whole),
    and whether they split."""
    m = MP_MESH["model"]
    split = cfg.num_heads % m == 0 and cfg.num_kv_heads % m == 0
    H, KVH = (cfg.num_heads // m, cfg.num_kv_heads // m) if split else (cfg.num_heads,
                                                                       cfg.num_kv_heads)
    return [[rows, TRAIN_SEQ, H, cfg.head_dim], [rows, keys, KVH, cfg.head_dim]], split


def mp_step_report(what: str, steps: list, want, dt: str, cell, fails: list) -> dict:
    """(c)'s and (g)'s gates over the ranks' mp_step lines ``steps`` in
    compute ``dt``: each rank's loss and grad norm at TRAIN_TOL of ``want``
    (the one-process step's: float32 on the whole batch, bfloat16 in
    MP_MESH["data"] microbatches of the same rows), every gradient and
    every parameter within its limit where compared, every flash call held,
    ``cell.per_step`` launches at each rank's local shapes."""
    cfg = train_config(cell)
    shapes, split = local_shapes(cfg, TRAIN_BATCH // MP_MESH["data"])
    ltol, gtol = TRAIN_TOL[getattr(torch, dt)]
    lerr = max(abs(s["loss"] - want[0]) / abs(want[0]) for s in steps)
    gerr = max(abs(s["grad_norm"] - want[1]) / want[1] for s in steps)
    entry = {"arch": cfg.name, "reduced": reduced_of(cfg), "rows": TRAIN_BATCH, "seq": TRAIN_SEQ,
             "loss_by_rank": [s["loss"] for s in steps],
             "grad_norm_by_rank": [s["grad_norm"] for s in steps], "one_process": list(want),
             "one_process_microbatches": 1 if dt == "float32" else MP_MESH["data"],
             "loss_rel_err": lerr, "grad_norm_rel_err": gerr, "tol": [ltol, gtol],
             "table_local_shape": steps[0]["table_local_shape"],
             "ms_held_by_rank": [s["ms_held"] for s in steps],
             "launches_by_rank": [s["launches"] for s in steps],
             "flash_shapes": steps[0]["flash_shapes"], "heads_split": split,
             "comms_by_rank": [s["comms"] for s in steps], "held": [s["held"] for s in steps]}
    for k in ("grad", "param"):
        if f"{k}_ratio" in steps[0]:
            entry[f"{k}_ratio"] = max(s[f"{k}_ratio"] for s in steps)
            entry[f"{k}_worst_leaf"] = [s[f"{k}_worst_leaf"] for s in steps]
    if "embed_table_grad_ratio" in steps[0]:
        entry["embed_table_grad_ratio"] = max(s["embed_table_grad_ratio"] for s in steps)
    ratios = {k: entry[k] for k in ("grad_ratio", "param_ratio") if k in entry}
    if not (lerr <= ltol and gerr <= gtol and all(r <= 1.0 for r in ratios.values())):
        fails.append(f"{what}: loss {lerr} / grad norm {gerr} from the one-process step (limits "
                     f"{ltol} / {gtol}); {ratios} of their limits")
    L = list(cell.per_step)
    for s in steps:
        fails.extend(held_failures(s, what))
        if s["launches"] != L or s["flash_shapes"] != [shapes + [L[0]]]:
            fails.append(f"{what}: launches {s['launches']}, shapes {s['flash_shapes']}; "
                         f"expected {L} at {shapes}")
    return entry


def mp_report(ranks: list, ref: dict, cell) -> tuple:
    """The ranks' model-parallel lines and their gates: (c) smollm's float32
    step (its parameters against the one-process step's besides) and
    bfloat16 step against ``ref``'s one-process steps (mp_step_report);
    (d)-(g) family_report. Returns (the line, the failures)."""
    fails, out = [], {"mesh": MP_MESH, "transport": "host-staged gloo, one card",
                      "ms": "wall ms of the rank's step, the held checks' plain versions "
                            "included (host-staged gloo, one card)"}
    for dt, yardstick in (("float32", "float32"), ("bfloat16", "bfloat16_split_mp")):
        out[f"smollm_{dt}"] = mp_step_report(
            f"mp smollm {dt}", [r["model_parallel"][f"smollm_{dt}"] for r in ranks],
            ref[yardstick], dt, cell, fails)
    family, family_fails = family_report(ranks)
    return dict(out, **family), fails + family_fails


def family_report(ranks: list) -> tuple:
    """The (d)-(g) lines and their gates: (d)-(f) the output and every
    gradient within their limits, every flash call held, one forward and
    one backward launch at each rank's local shapes; (e)'s aux at TOL of
    the one-process block's, its dropped choices (the ranks' groups summed)
    equal to the one-process block's, and in float32 (unpinned) its routing
    the one-process block's, token for token; (g) mp_step_report against
    the one-process step (embed.table's gradient reported apart, ROADMAP
    Queue 3, item 31)."""
    fails, out = [], {}
    rows = FAMILY_ROWS // MP_MESH["data"]
    for name, (kind, ep, dtype, pin) in FAMILY_CHECKS.items():
        if kind == "audio":
            cell = family_audio_cell()
            for dt in ("float32", "bfloat16"):
                steps = [r["model_parallel"][f"{name}_{dt}"] for r in ranks]
                out[f"{name}_{dt}"] = mp_step_report(f"mp {name} {dt}", steps,
                                                     steps[0]["one_process"], dt, cell, fails)
            continue
        cfg = family_config(kind, ep)
        shapes, split = local_shapes(cfg, rows, cfg.num_image_tokens if kind == "vlm"
                                     else TRAIN_SEQ)
        lines = [r["model_parallel"][name] for r in ranks]
        entry = {"arch": cfg.name, "params": lines[0]["params"], "rows": FAMILY_ROWS,
                 "seq": TRAIN_SEQ, "compute": str(dtype).replace("torch.", ""),
                 "out_ratio": max(ln["out_ratio"] for ln in lines),
                 "grad_ratio": max(ln["grad_ratio"] for ln in lines),
                 "grad_worst_leaf": [ln["grad_worst_leaf"] for ln in lines],
                 "ms_held_by_rank": [ln["ms_held"] for ln in lines],
                 "launches_by_rank": [ln["launches"] for ln in lines],
                 "flash_shapes": lines[0]["flash_shapes"], "heads_split": split,
                 "local_param_bytes": lines[0]["local_param_bytes"],
                 "comms_by_rank": [ln["comms"] for ln in lines],
                 "held": [ln["held"] for ln in lines]}
        if not (entry["out_ratio"] <= 1.0 and entry["grad_ratio"] <= 1.0):
            fails.append(f"mp {name}: output {entry['out_ratio']}, gradients "
                         f"{entry['grad_ratio']} of their limits")
        if kind == "moe":
            firsts = [ln for ln, r in zip(lines, ranks) if r["mp_coords"]["model"] == 0]
            want = lines[0]["aux_one_process"]
            entry.update(ep_split=ep, dp_groups=MP_MESH["data"], pinned=pin,
                         aux_by_rank=[ln["aux"] for ln in lines], aux_one_process=want,
                         aux_rel_err=max(abs(ln["aux"] - want) / abs(want) for ln in lines),
                         aux_tol=TOL[dtype],
                         router_grad_ratio=max(ln["router_grad_ratio"] for ln in lines),
                         drops=sum(ln["drops"] for ln in firsts),
                         drops_one_process=lines[0]["drops_one_process"])
            if not entry["aux_rel_err"] <= TOL[dtype]:
                fails.append(f"mp {name}: aux {entry['aux_by_rank']} against the one-process "
                             f"block's {want}, past {TOL[dtype]}")
            if entry["drops"] != entry["drops_one_process"]:
                fails.append(f"mp {name}: {entry['drops']} choices dropped, the one-process "
                             f"block {entry['drops_one_process']}")
            if pin:
                entry["pairs_apart_unpinned"] = sum(ln["pairs_apart_unpinned"] for ln in firsts)
            else:
                entry["routing_vs_one_process"] = [ln["routing_vs_one_process"] for ln in firsts]
                apart = sum(d["tokens"] for d in entry["routing_vs_one_process"])
                if apart:
                    fails.append(f"mp {name}: {apart} tokens routed apart from the one-process "
                                 f"block")
        for ln in lines:
            fails.extend(held_failures(ln, f"mp {name}"))
            if ln["launches"] != [1, 1] or ln["flash_shapes"] != [shapes + [1]]:
                fails.append(f"mp {name}: launches {ln['launches']}, shapes "
                             f"{ln['flash_shapes']}; expected [1, 1] at {shapes}")
        out[name] = entry
    return out, fails


def collectives_phase(cell) -> tuple:
    """The collectives phase: the parent's one-process steps of
    ``cell`` (smollm-135m at TRAIN_CUT) on the train phase's first 8 x
    2048 batch, float32 and bfloat16, as the yardstick; then
    COLLECTIVE_RANKS ranks spawned on cuda:0 in a gloo group (NCCL refuses
    a second rank on a GPU, so the hops go through pinned host memory:
    "host-staged gloo, one card"), each running collectives_rank, under
    COLLECTIVES_S; then a one-rank NCCL group in this process running the
    n == 1 paths (the products, psum's NCCL all-reduce of a CUDA tensor,
    the train step through grad_transform on the whole batch). Gates: the
    errors within TOL, the counted bytes equal to wire_bytes, each step's
    loss (the ranks' mean) and grad norm within TRAIN_TOL of the
    one-process step's (bf16: of the one-process step in COLLECTIVE_RANKS
    microbatches of the ranks' rows, since a bf16 gradient depends on how
    the batch is split; the whole batch's reported beside it), the
    compressed step within its int8 bound and its
    residual under 2 % of max|g|, the kernels' launches a step; and the
    model-parallel checks (c)-(g) (mp_report, family_report), each (d)-(g)
    yardstick drawn here in turn while the ranks wait (family_yardstick),
    one on the card at a time. Returns the line and the flash launches
    (forward, backward) of the ranks' steps."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # the earlier phases' cache, before four ranks share the card
    batch = train_batches(TRAIN_BATCH, 1)[0]
    ref = {}
    with torch.enable_grad():
        # the whole batch at once, and (bf16) in COLLECTIVE_RANKS and in
        # MP_MESH["data"] microbatches of the ranks' rows: a bf16 gradient
        # depends on the batch's split. The float32 step at mp_opt's eps
        # (its loss and grad norm are the same at any eps) keeps its
        # parameters: the model-parallel step's yardstick
        for key, dtype, accum in (("float32", torch.float32, 1), ("bfloat16", torch.bfloat16, 1),
                                  ("bfloat16_split", torch.bfloat16, COLLECTIVE_RANKS),
                                  ("bfloat16_split_mp", torch.bfloat16, MP_MESH["data"])):
            model, state, _ = train_setup(cell, dtype)
            before = {n: p.detach().clone() for n, p in model.named_parameters()}
            ocfg = mp_opt(cell) if key == "float32" else train_opt(cell)
            state, m = make_train_step(model, ocfg, accum_steps=accum)(state, batch)
            ref[key] = step_metrics(m)[:2]
            if key == "float32":
                smollm_yard = {"params": {n: p.detach() for n, p in model.named_parameters()},
                               "moved": {n: (p.detach() - before[n]).abs().max().item()
                                         for n, p in model.named_parameters()}}
            del model, state, m, before
            torch.cuda.empty_cache()
        shared = {"smollm": smollm_yard}
    t_ref = time.perf_counter() - t0
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        spawning = mp.get_context("spawn")
        yards = [spawning.SimpleQueue() for _ in range(COLLECTIVE_RANKS)]
        done = spawning.Queue()
        ctx = mp.start_processes(collectives_rank, args=(COLLECTIVE_RANKS, tmp, time.time(), shared,
                                                         yards, done),
                                 nprocs=COLLECTIVE_RANKS, join=False, start_method="spawn")
        deadline = time.monotonic() + COLLECTIVES_S
        t_yards = {}

        def ranks_done(what):
            """Wait for every rank's word on ``done``; a rank that fails
            raises its traceback here (join), past COLLECTIVES_S fails."""
            for _ in range(COLLECTIVE_RANKS):
                while True:
                    try:
                        done.get(timeout=1.0)
                        break
                    except queue.Empty:
                        try:
                            if any(p.exitcode not in (None, 0) for p in ctx.processes):
                                ctx.join(timeout=1.0)
                            if time.monotonic() > deadline:
                                fail(f"collectives: the ranks ran past {COLLECTIVES_S} s at {what}")
                        except BaseException:
                            for p in ctx.processes:
                                p.kill()
                            raise

        # each (d)-(g) yardstick in turn once the ranks are through (a)-(c),
        # freed once every rank has checked against it
        ranks_done("(a)-(c)")
        for name in FAMILY_CHECKS:
            t2 = time.perf_counter()
            yard = family_yardstick(name)
            t_yards[name] = time.perf_counter() - t2
            for q in yards:
                q.put(yard)
            ranks_done(name)
            del yard
            torch.cuda.empty_cache()
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                fail(f"collectives: the ranks did not finish within {COLLECTIVES_S} s")
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(COLLECTIVE_RANKS)]
        t_ranks = time.perf_counter() - t1
        del shared
        torch.cuda.empty_cache()

        # (c) a one-rank NCCL group: the n == 1 paths, NCCL's init and its
        # all-reduce of CUDA tensors
        t2 = time.perf_counter()
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_store", world_size=1,
                                rank=0, timeout=datetime.timedelta(seconds=COLLECTIVES_S))
        mesh = make_debug_mesh(data=1, model=1, pod=1)
        nccl_ring = {"float32": com_checks(mesh, torch.float32)}
        with torch.enable_grad():
            nccl_step, _ = dp_step(mesh, cell, torch.float32, batch)
        dist.destroy_process_group()
        t_nccl = time.perf_counter() - t2
    for r in ranks:
        failures += ring_failures(f"rank {r['rank']}", r["ring"])
    failures += ring_failures("nccl", nccl_ring)
    L = cell.per_step
    train = {}
    for key, dt, yardstick in (("float32", "float32", "float32"),
                               ("bfloat16", "bfloat16", "bfloat16_split"),
                               ("float32_compressed", "float32", "float32")):
        steps = [r[key] for r in ranks]
        loss = sum(s["loss"] for s in steps) / len(steps)
        norms = [s["grad_norm"] for s in steps]
        ltol, gtol = TRAIN_TOL[getattr(torch, dt)]
        want = ref[yardstick]
        lerr, gerr = abs(loss - want[0]) / abs(want[0]), abs(norms[0] - want[1]) / want[1]
        train[key] = {"loss": loss, "grad_norm": norms[0], "one_process": want,
                      "one_process_microbatches": COLLECTIVE_RANKS if yardstick.endswith("split")
                      else 1, "loss_rel_err": lerr, "grad_norm_rel_err": gerr, "tol": [ltol, gtol],
                      "ms_by_rank": [s["ms"] for s in steps],
                      "launches_by_rank": [s["launches"] for s in steps],
                      "sent_by_rank": [s["sent"] for s in steps]}
        if len(set(norms)) != 1:
            failures.append(f"{key}: the ranks' grad norms differ: {norms}")
        if key != "float32_compressed" and not (lerr <= ltol and gerr <= gtol):
            failures.append(f"{key}: loss {lerr} / grad norm {gerr} from the one-process step, "
                            f"over {ltol} / {gtol}")
        if any(s["launches"] != list(L) for s in steps):
            failures.append(f"{key}: launches {[s['launches'] for s in steps]}, expected {L}")
    whole = ref["bfloat16"]
    train["bfloat16"]["whole_batch_one_process"] = {
        "loss_grad_norm": whole, "rel_errs": [abs(train["bfloat16"]["loss"] - whole[0]) / whole[0],
                                              abs(train["bfloat16"]["grad_norm"] - whole[1]) / whole[1]],
        "split_vs_whole_rel_errs": [abs(ref["bfloat16_split"][i] - whole[i]) / whole[i]
                                    for i in (0, 1)]}
    comp = [r["float32_compressed"] for r in ranks]
    train["float32_compressed"].update(
        int8_bound_ratio=max(s["int8_bound_ratio"] for s in comp),
        error_feedback_ratio=max(s["error_feedback_ratio"] for s in comp))
    if not train["float32_compressed"]["int8_bound_ratio"] <= 1.0:
        failures.append(f"compressed: a leaf past its rows' int8 bound "
                        f"({train['float32_compressed']['int8_bound_ratio']})")
    if not train["float32_compressed"]["error_feedback_ratio"] < 0.02:
        failures.append(f"compressed: the residual is "
                        f"{train['float32_compressed']['error_feedback_ratio']} of max|g|")
    ltol, gtol = TRAIN_TOL[torch.float32]
    nccl_errs = (abs(nccl_step["loss"] - ref["float32"][0]) / abs(ref["float32"][0]),
                 abs(nccl_step["grad_norm"] - ref["float32"][1]) / ref["float32"][1])
    if not (nccl_errs[0] <= ltol and nccl_errs[1] <= gtol):
        failures.append(f"nccl: the step stands {nccl_errs} from the one-process step")
    cfg = get_config(COM_ARCH)
    strategies = {}  # rank 0's counts (every rank sends as much), the slowest rank's ms
    for dt, ring in ranks[0]["ring"].items():
        strategies[dt] = {}
        for s, counted in ring["strategies"].items():
            ms = [r["ring"][dt]["strategies"][s]["ms_per_call"] for r in ranks]
            strategies[dt][s] = dict(counted, ms_per_call=max(ms), ms_by_rank=ms)
    model_parallel, mp_failures = mp_report(ranks, ref, cell)
    failures += mp_failures
    flash = tuple(sum(r[k]["launches"][i] for r in ranks
                      for k in ("float32", "bfloat16", "float32_compressed")) +
                  sum(r["model_parallel"][k]["launches"][i] for r in ranks
                      for k in r["model_parallel"]) for i in (0, 1))
    line = {"phase": "collectives", "ranks": COLLECTIVE_RANKS,
            "transport": "host-staged gloo, one card",
            "transport_detail": "each hop's CUDA tensor copied through pinned host memory "
                                "(gloo cannot send device memory); gloo all-reduces the CUDA "
                                "tensor itself",
            "nccl_across_ranks": "not measured: one card, and NCCL refuses two ranks on one GPU",
            "ring_shape": {"arch": cfg.name, "tokens": COM_TOKENS, "K": cfg.d_ff, "N": cfg.d_model,
                           "mesh": {"model": COLLECTIVE_RANKS}},
            "ring_errs": {dt: {k: max(r["ring"][dt]["errs"][k] for r in ranks)
                               for k in ranks[0]["ring"][dt]["errs"]} for dt in ranks[0]["ring"]},
            "all_gather_bitwise": all(r["ring"][dt]["all_gather_bitwise"] for r in ranks
                                      for dt in r["ring"]),
            "strategies": strategies,
            "train": {"arch": cut(SERVE_ARCH, TRAIN_CUT).name, "reduced": reduced_of(
                cut(SERVE_ARCH, TRAIN_CUT)), "mesh": {"pod": 2, "data": COLLECTIVE_RANKS // 2},
                "rows_per_rank": TRAIN_BATCH // COLLECTIVE_RANKS, "seq": TRAIN_SEQ,
                "ranks_pod_data": [[r["pod"], r["data"]] for r in ranks], **train},
            "nccl_one_rank": {"ring_errs": nccl_ring["float32"]["errs"],
                              "strategies": nccl_ring["float32"]["strategies"],
                              "train_float32": {**nccl_step, "rel_errs": list(nccl_errs),
                                                "bitwise": [nccl_step["loss"], nccl_step[
                                                    "grad_norm"]] == list(ref["float32"])}},
            "model_parallel": model_parallel,
            "flash_launches": list(flash),
            "rank_seconds": [r["seconds"] for r in ranks],
            "seconds": {"one_process_steps": t_ref, "ranks": t_ranks, "nccl": t_nccl,
                        "family_yardsticks": t_yards, "total": time.perf_counter() - t0}}
    emit(line)
    if failures:
        fail("collectives: " + "; ".join(failures))
    return line, flash


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    torch.cuda.set_device(0)

    seconds, t_phase = {}, time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        seconds[name] = now - t_phase
        t_phase = now

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # 2. the build: one nvcc per source, all started together
    t0 = time.perf_counter()
    names = _build.all_kernels()
    _build.build(names, force=True)  # from the sources, even if a build is cached
    ptxas = {k: v for n in names for k, v in ptxas_summary(_build.ptxas_log[n]).items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "kernels": list(names),
          "flags": list(_build.NVCC_FLAGS), "ptxas": ptxas})
    phase_done("card+build")

    # 3. each kernel against its plain version at the main path's shapes
    program = compile_program(vgg16_imagenet())
    layers = program.workload.layers
    gen = torch.Generator(device="cuda").manual_seed(0)
    gemm_lines = []
    for l in layers:
        if isinstance(l, ConvSpec):
            m, k, n = BATCH * l.h_out * l.w_out, l.k * l.k * l.c_in, l.c_out
        else:
            m, k, n = BATCH, l.c_in, l.c_out
        gemm_lines.append(check_com_matmul(gen, m, k, n))
    for dtype in (torch.float32, torch.bfloat16):
        check_com_matmul(gen, 3001, 1000, 1000, dtype, "gelu", True, True)
    check_com_matmul(gen, 3001, 1000, 1000, torch.float32, "silu", True, True)
    for M in (8, 200):  # the streaming and the tensor-core path
        for dtype in (torch.float32, torch.bfloat16):
            check_com_matmul_inf(gen, M, dtype)
    for l in layers:  # a shard's products (phase e2e-shard: B/2 images a shard)
        if isinstance(l, ConvSpec):
            check_com_matmul(gen, BATCH // 2 * l.h_out * l.w_out, l.k * l.k * l.c_in, l.c_out)
        else:
            check_com_matmul(gen, BATCH // 2, l.c_in, l.c_out)
    conv_lines = [check_conv2d(gen, l.h_in, l.w_in, l.c_in, l.c_out, l.k, l.stride, l.padding)
                  for l in layers if isinstance(l, ConvSpec)]
    check_conv2d(gen, 112, 112, 64, 128, 3, 2, 1)
    check_conv2d(gen, 112, 112, 64, 128, 5, 2, 2)
    check_conv2d(gen, 56, 56, 256, 256, 3, 1, 1, torch.bfloat16)
    for S in (128, 517, 1024, 2048):  # smollm's batch-1 prefill attention
        for dtype in (torch.bfloat16, torch.float32):
            check_flash(gen, S, dtype)
    check_flash(gen, 517, causal=False)
    check_flash(gen, 1024, H=9, KVH=3, hd=128)
    for dtype in (torch.bfloat16, torch.float32):  # the reduced configs' hd 32, split
        check_flash(gen, 1100, dtype, H=2, KVH=2, hd=32)
    check_flash(gen, 517, H=4, KVH=2, hd=32, B=2)
    serve_cfg = get_config(SERVE_ARCH)
    flash_lines = [check_flash(gen, len(r.prompt), hd=serve_cfg.head_dim, H=serve_cfg.num_heads,
                               KVH=serve_cfg.num_kv_heads)
                   for r in serve_wave(serve_cfg.vocab_size)]
    for S in (256, 512, 542):  # the traffic phases' prompts, and their longest re-prefill
        check_flash(gen, S, hd=serve_cfg.head_dim, H=serve_cfg.num_heads,
                    KVH=serve_cfg.num_kv_heads)
    for arch, lengths in ((MOE_ARCH, MOE_PROMPTS), (HYBRID_ARCH, (1024,))):
        c = get_config(arch)  # dbrx's prefill attention at its prompts' ends; zamba2's
        for S in lengths:
            for dtype in (torch.bfloat16, torch.float32):
                check_flash(gen, S, dtype, H=c.num_heads, KVH=c.num_kv_heads, hd=c.head_dim)
    # zamba2's shared block in the train-hybrid phase: 8 x 2048, 32 heads, G = 1;
    # musicgen's train-audio layers have the same shape (checked once)
    hcfg = get_config(HYBRID_ARCH)
    acfg = get_config(AUDIO_ARCH)
    if (acfg.num_heads, acfg.num_kv_heads, acfg.head_dim) != (
            hcfg.num_heads, hcfg.num_kv_heads, hcfg.head_dim):
        fail("musicgen-large's attention shape is not zamba2-1.2b's: check it apart")
    hshape = dict(H=hcfg.num_heads, KVH=hcfg.num_kv_heads, hd=hcfg.head_dim, B=TRAIN_BATCH)
    hybrid_lines = {dtype: check_flash(gen, TRAIN_SEQ, dtype, **hshape)
                    for dtype in (torch.bfloat16, torch.float32)}
    # dbrx's in the train-moe phase: 8 x 2048, 48 heads, 8 KV heads, hd 128
    mcfg = get_config(MOE_ARCH)
    mshape = dict(H=mcfg.num_heads, KVH=mcfg.num_kv_heads, hd=mcfg.head_dim, B=TRAIN_BATCH)
    moe_lines = {dtype: check_flash(gen, TRAIN_SEQ, dtype, **mshape)
                 for dtype in (torch.bfloat16, torch.float32)}
    vcfg = get_config(VLM_ARCH)
    vshape = dict(H=vcfg.num_heads, KVH=vcfg.num_kv_heads, hd=vcfg.head_dim, B=ROWS)
    for dtype in (torch.bfloat16, torch.float32):
        # the vlm's cross layers in a decode step (Sq = 1) and a prefill, its
        # self layers' prefill; musicgen's prefill attention
        check_flash(gen, 1, dtype, causal=False, Skv=vcfg.num_image_tokens, **vshape)
        check_flash(gen, VLM_PROMPT, dtype, causal=False, Skv=vcfg.num_image_tokens, **vshape)
        check_flash(gen, VLM_PROMPT, dtype, **vshape)
        check_flash(gen, AUDIO_FRAMES, dtype, H=acfg.num_heads, KVH=acfg.num_kv_heads,
                    hd=acfg.head_dim, B=ROWS)
    # llama-3.2-vision-90b's in the train-vlm phase, 8 x 2048, writing lse as
    # a train forward does: its self layers (causal; bf16, the train path's
    # dtype: dbrx's shape above holds f32 at hd 128) and its cross layer
    # (non-causal against 1,601 image tokens), bf16 and f32
    vtshape = dict(H=vcfg.num_heads, KVH=vcfg.num_kv_heads, hd=vcfg.head_dim, B=TRAIN_BATCH)
    vlm_self_lines = {torch.bfloat16: check_flash(gen, TRAIN_SEQ, return_lse=True, **vtshape)}
    vlm_cross_lines = {dtype: check_flash(gen, TRAIN_SEQ, dtype, causal=False, return_lse=True,
                                          Skv=vcfg.num_image_tokens, **vtshape)
                       for dtype in (torch.bfloat16, torch.float32)}
    torch.cuda.empty_cache()
    # the attention backward: the train phases' shapes (smollm and zamba2, 8 x
    # 2048), ragged S, hd 32 and 128, non-causal; vlm's self and cross shapes
    # (Sq 2,048 against Skv 1,601 = 25 x 64 + 1 keys) and a small ragged
    # Sq 300 against Skv 77
    bwd_lines, hybrid_bwd_lines, moe_bwd_lines = {}, {}, {}
    vlm_self_bwd_lines, vlm_cross_bwd_lines = {}, {}
    with time_limit(BWD_CHECK_S, "the flash_attention_bwd checks"):
        for dtype in (torch.bfloat16, torch.float32):
            bwd_lines[dtype] = check_flash_bwd(gen, TRAIN_SEQ, dtype, B=TRAIN_BATCH)
            hybrid_bwd_lines[dtype] = check_flash_bwd(gen, TRAIN_SEQ, dtype, **hshape)
            moe_bwd_lines[dtype] = check_flash_bwd(gen, TRAIN_SEQ, dtype, **mshape)
            torch.cuda.empty_cache()
            if dtype == torch.bfloat16:  # f32 at hd 128, G = 8: dbrx's shape above
                vlm_self_bwd_lines[dtype] = check_flash_bwd(gen, TRAIN_SEQ, dtype, **vtshape)
                torch.cuda.empty_cache()
            vlm_cross_bwd_lines[dtype] = check_flash_bwd(gen, TRAIN_SEQ, dtype, causal=False,
                                                         Skv=vcfg.num_image_tokens, **vtshape)
            torch.cuda.empty_cache()
            check_flash_bwd(gen, 300, dtype, causal=False, H=8, KVH=2, hd=128, B=2, Skv=77)
            check_flash_bwd(gen, 517, dtype, B=2)
            check_flash_bwd(gen, 300, dtype, H=4, KVH=2, hd=32)
            check_flash_bwd(gen, 1024, dtype, hd=128)
            check_flash_bwd(gen, 517, dtype, causal=False)
    torch.cuda.empty_cache()
    xcfg = get_config(XLSTM_ARCH)
    xlstm_shape = dict(H=xcfg.num_heads, hd=xcfg.head_dim)
    for S in (128, 517, 1024):  # xlstm-350m's batch-1 prefill recurrence
        for dtype in (torch.bfloat16, torch.float32):
            check_slstm(gen, S, dtype, **xlstm_shape)
    check_slstm(gen, 77, torch.float32, B=2, **xlstm_shape)
    check_slstm(gen, 1, torch.bfloat16, **xlstm_shape)
    check_slstm(gen, 130, torch.float32, B=2, H=4, hd=32)  # the reduced configs' cluster of 1
    check_slstm(gen, 200, H=1, hd=512)  # the stream path
    slstm_lines = [check_slstm(gen, len(r.prompt), **xlstm_shape)
                   for r in serve_wave(xcfg.vocab_size)]
    # the recurrence's backward: the train-xlstm phase's shape (8 x 2048),
    # ragged S at B = 2, the reduced configs' hd 32 (a cluster of one)
    slstm_bwd_lines = {}
    with time_limit(BWD_CHECK_S, "the slstm_fused_bwd checks"):
        for dtype in (torch.bfloat16, torch.float32):
            slstm_bwd_lines[dtype] = check_slstm_bwd(gen, TRAIN_SEQ, dtype, one_wave=True,
                                                     **xlstm_shape)
            check_slstm_bwd(gen, 517, dtype, B=2, **xlstm_shape)
            check_slstm_bwd(gen, 300, dtype, B=2, H=4, hd=32)
    torch.cuda.empty_cache()
    phase_done("kernels")

    # 4. end to end: the executor's kernel path against its float64 reference
    weights = random_weights(program, seed=0)
    images = np.random.default_rng(1).normal(size=(BATCH, 224, 224, 3))
    ex = program.executor(weights)
    ref = program.executor(weights, backend="reference").run(images)
    ex.run(images)  # warm-up
    com_matmul.launches = conv2d_com.launches = 0
    res = ex.run(images)
    launches = {"com_matmul": com_matmul.launches, "conv2d_com": conv2d_com.launches}
    torch.cuda.reset_peak_memory_stats()
    walls = [ex.run(images).wall_s for _ in range(7)]
    peak = torch.cuda.max_memory_allocated()
    out, want = res.outputs.double(), ref.outputs
    err = (out - want).abs().max().item()
    scale = want.abs().max().item()
    events_match = res.events == dict(program.event_totals) == ref.events
    wall = statistics.median(walls)
    emit({"phase": "e2e", "workload": program.workload.name, "batch": BATCH,
          "images_s": BATCH / wall, "median_wall_ms": wall * 1e3,
          "wall_ms": [w * 1e3 for w in walls], "peak_mem_gib": peak / 2**30,
          "logits_shape": list(out.shape), "logits_max_abs_err": err,
          "logits_max_rel_err": err / max(scale, 1e-30), "tol": TOL[torch.float32],
          "events_match": events_match, "launches": launches})
    if tuple(out.shape) != (BATCH, layers[-1].c_out) or not torch.isfinite(out).all().item():
        fail(f"logits of shape {tuple(out.shape)} are not finite ({BATCH}, {layers[-1].c_out})")
    if scale == 0.0 or err > TOL[torch.float32] * scale:
        fail(f"logits max_abs_err {err} > {TOL[torch.float32]} * {scale}")
    if not events_match:
        fail(f"events {res.events} != event_totals {dict(program.event_totals)}")
    if launches != {"com_matmul": len(layers), "conv2d_com": 0}:
        fail(f"the forward launched {launches}, expected {len(layers)} com_matmul")

    imgs = torch.as_tensor(images, dtype=torch.float32, device="cuda")
    direct_forward(program, ex.weights, imgs[:1])  # warm-up
    com_matmul.launches = conv2d_com.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct = direct_forward(program, ex.weights, imgs)
    torch.cuda.synchronize()
    direct_wall = time.perf_counter() - t0
    direct_launches = {"com_matmul": com_matmul.launches, "conv2d_com": conv2d_com.launches}
    n_conv = sum(isinstance(l, ConvSpec) for l in layers)
    derr = (direct.double() - want).abs().max().item()
    emit({"phase": "e2e-direct-conv", "batch": BATCH, "images_s": BATCH / direct_wall,
          "wall_ms": direct_wall * 1e3, "logits_max_abs_err": derr,
          "logits_max_rel_err": derr / max(scale, 1e-30), "launches": direct_launches})
    if derr > TOL[torch.float32] * scale:
        fail(f"direct-conv logits max_abs_err {derr} > {TOL[torch.float32]} * {scale}")
    if direct_launches != {"com_matmul": len(layers) - n_conv, "conv2d_com": BATCH * n_conv}:
        fail(f"the direct-conv path launched {direct_launches}")
    phase_done("e2e")

    # 5. where the forward's device time goes
    emit({"phase": "profile", "workload": program.workload.name, "batch": BATCH,
          **profile_window(lambda: ex.run(images), "the forward", forbid=LIBRARY_KERNEL)})
    del ex, imgs
    phase_done("profile")

    # 6. serving smollm-135m at full width (SERVE_CUT) through the flash kernel
    scfg = cut(SERVE_ARCH, SERVE_CUT)
    model = build_model(scfg, CallConfig(), device="cuda", seed=0)
    _, flash_launches, eng = serve(model, scfg, flash_attention, scfg.num_layers,
                                   logits_kernel_vs_plain(TOL[torch.float32]),
                                   "serve")
    phase_done("serve")

    # 7. where a prefill's and a decode step's device time goes
    profile_serve(model, eng, scfg, forbid=LIBRARY_ATTENTION)
    del model, eng
    torch.cuda.empty_cache()
    phase_done("profile-serve")

    # 8. serving xlstm-350m at full width (XLSTM_CUT) through the sLSTM kernel
    xscfg = cut(XLSTM_ARCH, XLSTM_CUT)
    xmodel = build_model(xscfg, CallConfig(), device="cuda", seed=0)
    _, slstm_launches, xeng = serve(xmodel, xscfg, slstm_fused, xscfg.num_layers // 2,
                                    logits_xlstm, "serve-xlstm")
    phase_done("serve-xlstm")

    # 9. the same for xlstm-350m
    profile_serve(xmodel, xeng, xscfg)
    phase_done("profile-serve-xlstm")

    del xmodel, xeng
    torch.cuda.empty_cache()

    # 10. the Tab. IV evaluation, and the VGG-16 forward through DominoModel
    tab4_phase(weights, images, res.outputs)
    phase_done("tab4")

    # 11. COMGridSim in float64 on the card at full width
    comgrid_phase(program, weights)
    phase_done("comgrid")

    # 12. the design-space sweep's float64 columns on the card
    sweep_phase()
    phase_done("sweep")

    # 13. VGG-16 compiled and run around a fault set
    faults_launches, _ = faults_phase(program, weights, images, res.outputs)
    phase_done("faults")

    # 14. the mapping search, and the searched and custom-blocked programs
    search_launches, _ = search_phase(program, weights, images, res.outputs, ref.outputs)
    phase_done("search")

    # 15. the executor's batch split over devices (shard=)
    shard_launches, _ = shard_phase(program, weights, images, res.outputs, ref.outputs)
    phase_done("e2e-shard")

    # 16. streaming serving: smollm-135m through Engine.serve on a paged cache
    model = build_model(scfg, CallConfig(), device="cuda", seed=0)
    traffic_launches, paged_eng, _ = serve_traffic_phase(model, scfg)
    phase_done("serve-traffic")

    # 17. transient faults with retry-and-re-prefill, bfloat16 and float32
    fault_launches, _ = serve_faults_phase(model, scfg, paged_eng)
    del model, paged_eng
    torch.cuda.empty_cache()
    phase_done("serve-faults")

    # 18-19. serving dbrx-132b at full width (2 layers) and its profile windows
    moe_launches, _ = serve_moe_phase()
    torch.cuda.empty_cache()
    phase_done("serve-moe")

    # 20-21. serving zamba2-1.2b (6 layers), contiguous and paged, and its profile windows
    hybrid_launches, hybrid_paged_launches, _ = serve_hybrid_phase()
    torch.cuda.empty_cache()
    phase_done("serve-hybrid")

    # 22-23. llama-3.2-vision-90b at full width (10 layers): prefill and decode in lockstep
    vlm_launches, _ = model_vlm_phase()
    torch.cuda.empty_cache()
    phase_done("model-vlm")

    # 24-25. musicgen-large (12 layers): prefill and decode in lockstep
    audio_launches, _ = model_audio_phase()
    torch.cuda.empty_cache()
    phase_done("model-audio")

    # 26. training smollm-135m (5 layers) through the attention kernels, forward and backward
    smollm_cell, xlstm_cell, hybrid_cell, moe_cell, vlm_cell, audio_cell = train_cells()
    _, train_launches = train_phase(smollm_cell)
    torch.cuda.empty_cache()
    phase_done("train")

    # 27. training xlstm-350m (8 layers) through the sLSTM kernels, forward and backward
    _, xtrain_launches = train_phase(xlstm_cell)
    torch.cuda.empty_cache()
    phase_done("train-xlstm")

    # 28. training zamba2-1.2b (10 layers) through the attention kernels, the SSD under autograd
    _, htrain_launches = train_phase(hybrid_cell)
    torch.cuda.empty_cache()
    phase_done("train-hybrid")

    # 29. training dbrx-132b at full width (1 layer) with bf16 moments
    _, mtrain_launches = train_phase(moe_cell)
    torch.cuda.empty_cache()
    phase_done("train-moe")

    # 30. training llama-3.2-vision-90b at full width (1 group) on bf16 masters and moments
    _, vtrain_launches = train_phase(vlm_cell)
    torch.cuda.empty_cache()
    phase_done("train-vlm")

    # 31. training musicgen-large (3 layers) through the attention kernels
    _, atrain_launches = train_phase(audio_cell)
    torch.cuda.empty_cache()
    phase_done("train-audio")

    # 32. the COM ring and data/pod-parallel training over torch.distributed
    _, collective_launches = collectives_phase(smollm_cell)
    torch.cuda.empty_cache()
    phase_done("collectives")

    # 33. the phases' seconds, the kernels line, the card, the result
    emit({"phase": "seconds", **seconds, "total": sum(seconds.values())})
    emit({"kernels": [
        {"name": "com_matmul", "route": "cuda", "source": "src/repro_torch/csrc/com_matmul.cu",
         "replaces": "src/repro/kernels/com_matmul.py:69",
         "launches": launches["com_matmul"],
         "launches_by_path": {"e2e": launches["com_matmul"],
                              "e2e-direct-conv": direct_launches["com_matmul"],
                              "faults": faults_launches, "search": search_launches,
                              "e2e-shard": shard_launches}, **summary(gemm_lines)},
        {"name": "conv2d_com", "route": "cuda", "source": "src/repro_torch/csrc/conv2d_com.cu",
         "replaces": "src/repro/kernels/conv2d_com.py:61",
         "launches": direct_launches["conv2d_com"],
         "launches_by_path": {"e2e-direct-conv": direct_launches["conv2d_com"]},
         **summary(conv_lines, BATCH)},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:64",
         "launches": flash_launches,
         "launches_by_path": {"serve": flash_launches, "serve-traffic": traffic_launches,
                              "serve-faults": fault_launches, "serve-moe": moe_launches,
                              "serve-hybrid": hybrid_launches,
                              "serve-hybrid-paged": hybrid_paged_launches,
                              "model-vlm": vlm_launches, "model-audio": audio_launches,
                              "train": train_launches[0], "train-hybrid": htrain_launches[0],
                              "train-moe": mtrain_launches[0], "train-vlm": vtrain_launches[0],
                              "train-audio": atrain_launches[0],
                              "collectives": collective_launches[0]},
         # a train-hybrid and a train-audio step's forward launches at zamba2's
         # and musicgen's (8, 2048, 32, 32, 64),
         # a train-moe step's at dbrx's (8, 2048, 48, 8, 128), a train-vlm
         # step's at llama-3.2-vision's self (8, 2048, 64, 8, 128) and cross
         # (Skv 1,601, non-causal) shapes, with lse: 2 of each layer under remat
         "train_hybrid_step": summary([hybrid_lines[torch.bfloat16]], hybrid_cell.per_step[0]),
         "train_audio_step": summary([hybrid_lines[torch.bfloat16]], audio_cell.per_step[0]),
         "train_moe_step": summary([moe_lines[torch.bfloat16]], moe_cell.per_step[0]),
         "train_vlm_step": summary(vlm_step(vlm_self_lines, vlm_cross_lines, 2)),
         "train_vlm_shapes": {
             "self": {"bfloat16": brief(vlm_self_lines[torch.bfloat16])},
             "cross": {str(dt).replace("torch.", ""): brief(ln)
                       for dt, ln in vlm_cross_lines.items()}},
         **summary(flash_lines, scfg.num_layers)},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/models/attention.py:159",
         "launches": train_launches[1],
         "launches_by_path": {"train": train_launches[1], "train-hybrid": htrain_launches[1],
                              "train-moe": mtrain_launches[1], "train-vlm": vtrain_launches[1],
                              "train-audio": atrain_launches[1],
                              "collectives": collective_launches[1]},
         "train_hybrid_step": summary([hybrid_bwd_lines[torch.bfloat16]],
                                      hybrid_cell.per_step[1]),
         "train_audio_step": summary([hybrid_bwd_lines[torch.bfloat16]], audio_cell.per_step[1]),
         "train_moe_step": summary([moe_bwd_lines[torch.bfloat16]], moe_cell.per_step[1]),
         "train_vlm_step": summary(vlm_step(vlm_self_bwd_lines, vlm_cross_bwd_lines, 1)),
         "train_vlm_shapes": {
             "self": {"bfloat16": brief(vlm_self_bwd_lines[torch.bfloat16])},
             "cross": {str(dt).replace("torch.", ""): brief(ln)
                       for dt, ln in vlm_cross_bwd_lines.items()}},
         "path": bwd_lines[torch.bfloat16]["path"],
         "mma_passes_per_pair": bwd_lines[torch.bfloat16]["mma_passes_per_pair"],
         "ptxas": {k: v for k, v in ptxas.items() if "wgmma" in k and "<64" in k},
         **summary([bwd_lines[torch.bfloat16]], smollm_cell.per_step[1])},
        {"name": "slstm_fused", "route": "cuda", "source": "src/repro_torch/csrc/slstm.cu",
         "replaces": "src/repro/kernels/slstm.py:70",
         "launches": slstm_launches, "launches_by_path": {"serve-xlstm": slstm_launches,
                                                          "train-xlstm": xtrain_launches[0]},
         **summary(slstm_lines, xscfg.num_layers // 2)},
        {"name": "slstm_fused_bwd", "route": "cuda", "source": "src/repro_torch/csrc/slstm.cu",
         "replaces": "src/repro/models/xlstm.py:240",
         "replaces_note": "no Pallas kernel: jax.grad of the lax.scan over _slstm_cell",
         "launches": xtrain_launches[1], "launches_by_path": {"train-xlstm": xtrain_launches[1]},
         "active_clusters": slstm_bwd_lines[torch.bfloat16]["active_clusters"],
         "waves": slstm_bwd_lines[torch.bfloat16]["waves"],
         **{k: slstm_bwd_lines[torch.bfloat16][k] for k in (
             "rows_per_cluster", "cluster", "product", "step_floor_us", "floor_bound_ms")},
         "ptxas": {k: v for k, v in ptxas.items() if "slstm_bwd" in k},
         **summary([slstm_bwd_lines[torch.bfloat16]], xlstm_cell.per_step[1])},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

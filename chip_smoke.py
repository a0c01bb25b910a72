#!/usr/bin/env python3
"""Drive the PyTorch port (automodel_tpu_torch) on one NVIDIA H100 and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. the card's name and power limit (nvidia-smi);
2. build of every CUDA source in automodel_tpu_torch/csrc (nvcc, plain C + ctypes,
   one nvcc per source, all started together), with each kernel's registers and
   spills from -Xptxas -v;
2b. the twice-launch phase: each backward kernel launched twice on the same inputs, and
   the outputs that differ bitwise (flash_dq and flash_dkv at flash cases a and f, with
   GPT-OSS's window, at Phi-3's head_dim 96 and window, with Gemma-2-27B's soft-cap at
   its heads (G2), and at Gemma-2-9B's head_dim 256 with and without its cap (G9, G9c),
   ring_bwd, ring_dq and ring_dkv
   at ring case a's diagonal step, lce_bwd at lce case a, gmm dX and tgmm at gmm case a, and the backward of the expert
   biases' gathers at main path 11's shape); fails if flash_dq, flash_dkv, ring_dq,
   ring_dkv or a bias gather differs;
3. flash_fwd and the backward (flash_dq + flash_dkv) against their plain version (f32
   from the same bf16 inputs) in fifty cases: (a) the Llama-3.2-1B training
   shape, (b) packed segments with right padding, (c) non-causal, (d) a 16k sequence, (e) the shape and segments of
   main path 3 (rows of 4096 packed by pack_dataset from 1000-token documents); at
   head_dim 128: (f) the Qwen3-30B-A3B training shape, (g) case e's rows and segments;
   at the tiles' edges: (h) S=1000 at head_dim 64 and 128, (i) H=KH=8, head_dim 128,
   non-causal, segment boundaries inside tiles, (j) a grid smaller than the card (B=1,
   H=4, KH=1, S=4096, head_dim 128); with GPT-OSS's sliding window and sinks (the sinks'
   gradient from lse and delta held too): (k) window 128, (l) window 100 at head_dim
   128, (m) sinks, (n) window 128 and sinks at head_dim 128, (o) window 100, sinks and
   segment boundaries inside tiles at head_dim 64 and 128, (p) window 1 with sinks at
   S=1000, (q) a window longer than S, (r) a window without the causal mask; at Phi-3's
   head_dim 96 (the 128-wide kernels): (s) Phi-3-mini's heads, (t) GQA with segment
   boundaries inside tiles, (u) window 100, (v) Phi-3's window 2047, (w) sinks, window and
   segments, (x) S=1000, (y) non-causal packed rows of 4096; with the logit soft-cap
   (Gemma-2's c = 50 at its scale 144^-0.5, and c = 2 at scale 1, where tanh saturates):
   (ca) D=64 causal, (cb) Gemma-2-27B's heads with a window, (cc) D=96 packed, (cd) the
   saturating cap at D=64 windowed and packed, (ce) at D=128 non-causal with segment
   boundaries inside tiles, (cf) at D=96, (cg) sinks, a window and the cap at D=128, (ch)
   the same at the saturating cap, (ci) Gemma-2-27B's heads with q scaled by 16, where
   its cap c = 50 bites; at head_dim 256 (Gemma-2-9B's and Gemma-3's own tiles): (da)
   Gemma-2-9B's heads at its scale 256^-0.5, (db) with its cap, (dc) Gemma-3-4B's heads
   with its window 1024, (dd) S=1000, (de) non-causal, segment boundaries inside tiles,
   the saturating cap, (df) sinks, window 100 and those segments, (dg) main path 3's packed
   rows with a window and the cap, (dh) da's heads with q scaled by 16 and the cap; for
   the lineage slice, at the heads of main paths 30-32: (ea) shape (a) at Granite's
   softmax scale 1/64 without a cap, q scaled by 4, (eb) Command R7B's window 4096 over
   rows of 8192 at its 32 heads over 8, D=128; causal at D=128 over 4 x 2048: (ec)
   GLM-4-9B's 32 heads over 2, (ed) OLMo-2-7B's 32 over 32, (ee) SmolLM3-3B's 16 over 4,
   (ef) Mixtral's 32 over 8 (the plain version over groups of KV heads where its scores
   would pass 4 GiB); for the encoder slice: (ga) / (gb) non-causal over right-padded
   rows of 64 (one q tile, the padding inside it) and 256 at 32 heads over 8, D=64 (the
   biencoder's towers), (gc) GPT-2's causal MHA, 12 heads over 12, S=1024; for the MoE
   families and hybrids: (ha) the Step-3.5 geometry's sliding layers (STEP35_FLASH,
   unverified against the published config), 96 heads over 8 at D=128,
   window 512, over packed rows of 4096, (hb) Qwen3-Next's full layers, 16 heads over 2
   at D=256 over 4 x 2048;
4. flash kernel times (flash_fwd, flash_dq, flash_dkv) at shapes (a) and (f) beside the
   bound, the plain version and SDPA, and the whole backward as the wrapper runs it
   (delta, flash_dq, flash_dkv) beside SDPA's backward (one phase alone:
   ``chip_smoke._timings(torch, fa, 4, 2048, 32, 4, 128)``); then at GPT-OSS's shape
   (B=1, S=8192, H=64, KH=8, D=64) causal, with window 128, and with window 128 and
   sinks, the bound over the allowed pairs, SDPA with the window as a boolean mask
   beside the window-only rows; fails unless the windowed forward and backward each
   take under a quarter of the causal time (``chip_smoke._window_timings(torch, fa)``);
   then at Phi-3-mini's shape (P: B=4, S=2048, H=KH=32, D=96) causal and with its window
   2047, beside SDPA (the window as a boolean mask); then at Gemma-2-27B's heads (G2:
   B=2, S=2048, H=32, KH=16, D=128, causal, scale 144^-0.5) without and with its cap c =
   50, beside SDPA, and the capped rows beside FlexAttention with the tanh cap as its
   score_mod (compiled once, forward and backward; its output held against flash_fwd's)
   and SDPA without a cap; then at head_dim 256: Gemma-2-9B's heads (G9: B=2, S=2048,
   H=16, KH=8, causal, scale 256^-0.5) without and with its cap (G9c, beside
   FlexAttention), and Gemma-3-4B's (G4w: H=8, KH=4, window 1024, SDPA with the window as
   a boolean mask); then Command R7B's sliding layers (C: B=1, S=8192, H=32, KH=8, D=128,
   window 4096, SDPA with the window as a boolean mask); then main path 35's towers, (Bq)
   32 queries of 64 and (Bp) 64 passages of 256 at 32 heads over 8, D=64, non-causal over
   right-padded rows (the bound over the pairs the segment ids allow, SDPA with the
   padding as a boolean mask), and (GPT) main path 37's causal MHA (B=16, S=1024, H=KH=12,
   D=64); then head_dim 80 (with and without
   the cap) must raise
   NotImplementedError on the card and launch nothing, and so must the ring kernels at
   (D, Dv) = (96, 64) and (192, 192);
5. Llama-3.2-1B width at 2 layers: one forward and backward with attention "flash"
   against attention "xla" on the same weights;
6. lce_fwd / lce_bwd (fused linear CE) against their plain version in twelve cases:
   (a) N=8192, E=2048, V=128,256 with 10% ignored labels, exact; (b) the same with h
   scaled up under filter_eps=1e-7; (c) ragged N=8190 with V=50,257; (d) E=4096;
   (e) shape (b) with a tied unembedding (the (V, E) embedding read in place);
   (f) E=1000, not a multiple of the 128 tile; (g) E=1003, tied, rows not 16-byte
   aligned; (h) E=8, V=16, tied, every dimension inside one tile; (i) E=1000,
   V=50,264, a multiple of 8 but not of the 256-column tile, so lce_fwd's wgmma route
   must mask the columns past V that TMA fills with zeros; (j) GPT-OSS-20B's E=2880
   (no multiple of the 128-wide tile) and V=201,088; (k) Command R7B's tied unembedding
   (E=4096, V=256,000), (l) GLM-4-9B's (E=4096, V=151,552), both exact; each case line
   names the
   routes of lce_fwd and lce_bwd (wgmma where E and V are multiples of 8, else
   mma_sync: c, f, g) and fails if others were launched;
   then their times at shape (a) beside the bound, the plain version and the
   yardstick torch.logsumexp((h @ w).float(), -1), both kernels' times at main path 7's
   shape (N=32768, E=4096) beside their bounds (lce_fwd's also beside its plain
   version and yardstick, where the card holds their logits), at case j's shape, at
   Command R7B's (R: N=8192, E=4096, V=256,000, tied), and the peak memory
   that one forward and backward of linear_cross_entropy adds;
7. gmm / tgmm (grouped expert GEMM: forward, dX, dW) against their plain version in
   eleven cases: (a) the slice's gate_up (N=65,536 routed rows, D=2048, F=1536, E=128,
   group sizes from a softmax top-8 router), (b) its down projection (D=768, F=2048),
   (c) empty head / middle / tail experts with N, D and F off the tiles, (d) one expert
   owning every row with rows not 16-byte aligned, (e) D=16, F=24, N=30, every
   dimension inside one tile, (f) c's experts and 300 rows past the groups, whose out
   and dX must be exactly 0, (g) tgmm's ragged K steps: experts of 1, 63, 64, 65, 127,
   0 and 200 rows (starts off the 64-row steps) and 37 rows past the groups at D=256,
   F=512; (h, i) GPT-OSS-20B's gate_up (D=2880, F=5760) and down (2880, 2880), 32
   experts top-4 over 16,384 tokens; (m, n) Mixtral-8x7B's gate_up (D=4096, F=28,672)
   and down (14,336, 4096), 8 experts top-2 over 8192 tokens (about 2048 rows an expert);
   (o, p) GLM-4.5-Air's gate_up (D=4096, F=2816) and down (1408, 4096), 128 experts top-8
   over 4096 tokens; (q, r) Qwen3-Next-80B-A3B's (2048, 1024) and (512, 2048), 512
   experts top-10 over 8192 tokens (160 rows an expert);
   each case line names the routes of gmm and tgmm (wgmma where the row lengths are
   multiples of 8, else mma_sync: c, d) and fails if others were launched; then gmm
   (forward and dX) and tgmm times at (a), (b), (h), (i), (m), (n) and (o)-(r) beside the
   bound, the plain version (timed once at (o)-(r)) and torch._grouped_mm;
8. Qwen3-30B-A3B width at 1 layer: the kernels against the plain versions on the same
   weights, with routing held fixed;
8b. ring_fwd / ring_bwd (ring-attention chunk kernels), and the deterministic route
   (ring_dq + ring_dkv), against their plain version, one full folded ring
   forward and backward each, in six cases: (a) the slice's shape (cp 8
   folded, B 1, S_local 4096, H 32, KH 8, D 128, causal), (b) packed segments with
   positions restarting per document, (c) the round-robin layout, (d) a sliding window,
   (e) D 64, KH 2, non-causal, (f) S_local 1000 at cp 3; their times at (a)'s diagonal
   ring step beside the bound and the plain version, at ring steps 1 and cp - 1 (7 of 8
   shards' chunks wholly allowed, then wholly skipped) beside their bounds, and ring_dq's
   and ring_dkv's at the diagonal step and step 1; the tiles the kernels count as
   skipped, partial and full, held against tile_classes in every case and at each timed
   step; and the whole ring against flash_fwd / flash_dq / flash_dkv / the flash
   backward and SDPA on the unsharded S 32768 (shape L), with flash's bounds there;
   then MLA's (D, Dv) = (192, 128) (_mla_ring_phase: cases ma-me, Moonlight's heads,
   packed segments, a window, non-causal GQA at DeepSeek-V3's YaRN-corrected scale, a
   ragged length; ring_fwd, ring_dq and ring_dkv, the backward's only route there) and
   its times at DeepSeek-V3's (V) and Moonlight's (M) attention, diagonal step and step
   1, beside the bound and, at M, the plain version (_mla_ring_timings);
8c. Llama-3-8B width at 2 layers, seq 8192, cp 4 folded: context_parallel ring (the ring
   kernels) against allgather (the flash kernels) on the same weights;
9. main path 1: the benchmark recipe on examples/benchmark/llama3_2_1b.yaml
   (16 layers, full width, masked_ce), launch counts checked against the counters;
10. main path 2: the benchmark recipe on examples/benchmark/llama3_2_1b_seq4096.yaml
   (16 layers, full width, untied head, linear_ce, seq 4096);
11. main path 3: train_ft on the same config with no loss.name (the default picks
   linear_ce) and packing of 1000-token documents into rows of 4096;
12. main path 4: the benchmark recipe on main path 1's config (tied embedding) with
   loss.name linear_ce, so the kernels read the (V, E) embedding in place; its
   first-step loss is held against main path 1's (same weights and batch);
13. main path 5: the benchmark recipe on examples/benchmark/qwen3_moe_a3b_proxy.yaml
   with the published Qwen3-30B-A3B widths at 4 layers (QWEN3_30B_A3B, qwen3_args) and
   the pallas experts backend;
14. main path 6: train_ft on the same at 2 layers, default loss, packing 500-token
   documents into rows of 2048 (token mask from segment ids, the aux-loss term,
   moe_load/* rows);
15. main path 7: the benchmark recipe on
   examples/llm_finetune/llama3_8b_long_context_cp.yaml (cp 8 folded onto the card,
   ring attention, seq 32768, remat dots, adamw, f32 params, linear_ce) with its dataset
   section replaced by the mock dataset (cp_config) and the published Meta-Llama-3-8B
   widths at 4 layers, one microbatch a step (LLAMA3_8B, llama3_8b_args);
16. main path 8: train_ft on the same at 2 layers, default loss, 4096-token documents
   packed into rows of 32768;
17. main path 9: BASELINE config #1 (examples/llm_finetune/llama3_2_1b_hellaswag.yaml)
   through train_ft with its model section pointing at a local HF directory that the
   port's safetensors writer fills with a random-init Llama-3.2-1B (published config,
   BASELINE_LAYERS of 16 layers; write_pretrained), its data sections at HellaSwag-shaped JSONL rows
   read through ByteTokenizer (baseline_config), the prefetch pipeline on, validation
   and a checkpoint with the consolidated HF export every 2 steps, 4 steps
   (baseline_args). Run A runs fresh; its step_4 is removed and run B resumes from
   step 2 in the same directory. Checks: B's step-3 and step-4 losses equal A's
   bitwise, validation.jsonl rows at steps 2 and 4, A's step_4/hf
   reloaded through from_pretrained equals A's final parameters bitwise, and the launch
   counts with validation's forward-only launches; it prints the bytes and seconds of
   each save, the restore seconds, the step times and the peak memory (with what is
   allocated after setup and after the run);
17b. in a child process with CUBLAS_WORKSPACE_CONFIG=:4096:8 and
   torch.use_deterministic_algorithms(True) (``_deterministic_child``): main path 9
   again, where run B's step-4 loss must equal run A's bitwise; and main path 10, main
   path 8's config run twice, its ring backward through ring_dq + ring_dkv, every loss
   of the two runs bitwise equal;
18. main path 11: the benchmark recipe on examples/benchmark/gpt_oss_20b_proxy.yaml with
   the published openai/gpt-oss-20b widths at 4 of 24 layers (GPT_OSS_20B, gpt_oss_args:
   2 sliding-window layers, 2 full, sinks, biases, YaRN, 32 experts top-4, pallas
   experts, linear CE, adamw_lowmem, mb 8 x seq 2048);
19. main path 12: train_ft on the same at 2 layers, default loss, 500-token documents
   packed into rows of 2048 (segment ids through the windowed, sink-carrying kernels).
20. main path 13: the benchmark recipe on examples/benchmark/phi3_proxy.yaml with the
   published microsoft/Phi-3-mini-4k-instruct widths at all 32 layers (PHI3_MINI,
   phi3_args: head_dim 96, window 2047 on every layer, masked CE);
21. main path 14: train_ft on examples/llm_finetune/phi3_mini_sft.yaml from a local HF
   directory of a random-init Phi-3-mini at 2 layers in HF's fused layout
   (write_pretrained, phi3_sft_args): packed 1000-token documents, 4 steps of 2
   microbatches, a checkpoint with the consolidated HF export every 2 steps; step_4/hf
   must hold the fused tensors and reload bitwise equal to the final parameters;
22. main path 15: the benchmark recipe on examples/benchmark/deepseek_v3_proxy.yaml as it
   stands (12 layers, MLA with the low-rank q route, 64 experts top-6, the fake gate;
   MLA's attention on the plain path: no flash launch); main path 16: train_ft on
   examples/llm_finetune/deepseek_v3_ep.yaml from a local HF directory of a random-init
   Moonlight-16B-A3B at MOONLIGHT_LAYERS layers (moonlight_sft_args: bf16, one process,
   real routing with the gate-bias update, packed documents, one save at step 4):
   each step's correction-bias move must be sign(mean - load) x 0.001 of its summed
   loads, and step_4/hf must hold DeepSeek's names and reload bitwise; main path 17:
   Moonlight's widths at 2 layers under ring attention, cp 4 folded, seq 16,384
   (moonlight_ring_args): ring_fwd, ring_dq and ring_dkv at (192, 128), no ring_bwd.
   Main path 18: the benchmark recipe on examples/benchmark/gemma3_proxy.yaml as it
   stands (12 layers, 10 sliding at window 1024, head_dim 128, vocab 262,144, linear CE)
   with ``--backend.attention flash`` (gemma3_proxy_args: the file names no attention
   backend); main path 19: Gemma-2-27B's published widths over it at 4 of 46 layers
   (GEMMA2_27B, gemma2_args: the caps 50 and 30, window 4096 on alternate layers, vocab
   256,000, every flash launch capped); main path 20: train_ft on
   examples/llm_finetune/gemma2_9b_sft.yaml with its dataset swapped for mock data
   (gemma2_sft_config) from a local HF directory at Gemma-2-27B's widths, 2 layers
   (gemma2_sft_args: bf16, one save at step 4, hf/ reloaded bitwise). Main path 21:
   Gemma-2-9B's published widths over the Gemma-3 proxy at 8 of 42 layers (GEMMA2_9B,
   gemma2_args: head_dim 256, caps, window 4096 on alternate layers; every flash launch
   capped and at d256); main path 22: Gemma-3-4B's published text widths over it at all 34
   layers (GEMMA3_4B_TEXT: head_dim 256, 29 sliding layers at window 1024, linear RoPE
   scaling 8 on the full ones, vocab 262,208; no cap); main path 23: train_ft on
   examples/llm_finetune/gemma3_4b_sft.yaml (its mock data as it stands, attention
   through the flash kernels: the file names no backend) from a local HF
   directory of a random-init Gemma-3-4B in the published Gemma3ForConditionalGeneration
   layout at 6 layers (GEMMA3_4B, gemma2_sft_args: bf16, 2 microbatches, one save at step
   4, hf/ reloaded bitwise). Paths 9, 14, 16, 20 and 23-30 run through one
   helper (_pretrained_run, _check_pretrained_run);
   the PEFT and QAT paths 24-29 (_peft_paths); then the Llama lineage and Mixtral: main
   path 30, train_ft on examples/llm_finetune/cohere2_r7b_sft.yaml (mock data) from a
   local HF directory of a random-init Command R7B (COMMAND_R7B) at 4 of 32 layers (3
   sliding RoPE layers at window 4096, 1 full NoPE layer; command_r7b_sft_args: bf16, rows
   of 8192, 2 microbatches, 4 steps, one save, hf/ reloaded bitwise); main path 31, the
   benchmark recipe on examples/benchmark/mixtral_proxy.yaml with Mixtral-8x7B's widths
   (mixtral_args: 3 of 32 layers, 8 experts top-2, mb 4 x 2048, its MFU also as JAX counts
   it); main path 32 (_lineage_paths), the benchmark recipe, 1 warmup + 3 timed steps, on
   llama3_2_1b.yaml with the model section of Granite-3.3-2B (40 layers), OLMo-2-1124-7B
   (2), SmolLM3-3B (4, one NoPE layer) and GLM-4-9B-0414 (2) (lineage_config; linear CE at
   a vocabulary of 65,536 or more), and on examples/benchmark/starcoder2_proxy.yaml as it
   stands (the structural alias) with adafactor_nomom for its optimizer, which neither
   package has. Then the classifier and encoder recipes and GPT-2 (_encoder_paths), each
   file's hub data swapped for local rows of random words read through ByteTokenizer
   (local_data_config): main path 33, train_seq_cls on
   examples/llm_finetune/seq_cls.yaml from a local HF directory of a random-init
   Llama-3.2-1B at 4 of 16 layers without a score head (the fresh head must be JAX's
   default_rng(0) one bitwise), flash, 2 labels, 4 steps of 4 microbatches of 8 x 512,
   one save whose hf/ (score.weight, no lm_head) reloads bitwise; main path 34,
   train_seq_cls on examples/llm_finetune/qwen2_5_seq_cls_lora.yaml at Qwen2.5-7B's
   widths, 4 of 28 layers, 3 labels, LoRA on wq / wv: four trainable factors, the head
   bitwise at its init after 3 steps; main path 35, train_biencoder on
   examples/biencoder/llama3_2_1b_last_token_pool.yaml (its own 16-layer tower, flash,
   32 queries of 64 with 64 passages of 256, 4 steps, validation at 2 and 4), every
   flash launch non-causal, its first loss within TOL_BIENCODER_LOSS of the xla path's
   and the same first step with flash's mask made causal or blind to the padding beyond it;
   main path 36, mine_hard_negatives on examples/biencoder/mine_hard_negatives.yaml over
   MINE_ROWS rows (1-4 negatives a row, none the positive, each under the margin cut,
   read back by RetrievalDataset); main path 37, train_ft on
   examples/llm_pretrain/nanogpt.yaml (GPT-2-124M, 12 layers, flash, mb 16 x 1024) over
   nanoGPT shards from the seed, run A fresh with saves at 2 and 4, run B resumed from
   step 2 bitwise, step_4/hf reloaded bitwise, nanoGPT's MFU printed beside the
   recipe's absent one. Then the MoE families and the hybrids (_family_paths over
   FAMILY_PATHS, each at a published config written down here): main path 38, the
   benchmark recipe on examples/benchmark/glm4_moe_proxy.yaml at GLM-4.5-Air's widths
   (its dense layer and 2 MoE layers, flash, linear CE), each step's move of the
   correction bias held to the gate-bias update's rule; main path 39, train_ft on
   examples/llm_finetune/minimax_m2_sft.yaml from a local HF directory of a random-init
   MiniMax-M2 at 2 of 62 layers (ep 16 -> 1, flash, adafactor_nomom, packed rows of
   4096, 2 steps of 2 microbatches, one save, hf/ reloaded bitwise, its MFU also as JAX
   counts it); main path 40, the same on examples/llm_finetune/step3p5_moe.yaml at
   the first 4 layers of STEP35_FLASH, a Step-3.5 geometry unverified against the
   published config (full, sliding, sliding, sliding MoE; 64 heads over 8 on the full
   layer, 96 over 8 at window 512 on the sliding ones; no clamp on the card); main path 41, the
   benchmark recipe on examples/benchmark/qwen3_next_proxy.yaml at Qwen3-Next-80B-A3B's
   widths, one period (3 gated DeltaNet layers, no attention kernel, and 1 gated full
   layer at D=256; then one more step in the recipe's profile window, whose device time
   by scope gives the DeltaNet's share of the step), then the DeltaNet mixer's time at its
   shape, op by op (_delta_net_timings).
   Every main path also checks that each of its gmm, tgmm, lce_fwd and lce_bwd launches
   took the wgmma route (``launches by route`` on its line), and, through one helper
   (_check_path_launches), that its windowed flash launches are those of its sliding
   layers and its soft-capped ones those of its capped layers (each printed apart), that
   every flash launch is at its model's head dim, and every ring launch at its model's
   (D, Dv);
23. one JSON line of per-kernel numbers (every kernel launched on some main path), the
   card line, then the result line.

To run one phase alone on the card, import the script: e.g.
``python3 -c "import chip_smoke, torch; chip_smoke._gmm_phase(torch, {})"``, or the
main path 5 configuration through the recipe:
``python3 -m automodel_tpu_torch.recipes.llm.benchmark -c
examples/benchmark/qwen3_moe_a3b_proxy.yaml $(python3 -c "import chip_smoke;
print(' '.join(chip_smoke.qwen3_args()))")``.

``python3 chip_smoke.py --kernel-times [ROOT]`` builds the package of the checkout at
ROOT (default: this one) and times only its flash_fwd, flash_dq and flash_dkv at flash
shapes a, f, L and GPT-OSS's, its gmm (forward and dX) and tgmm at a and b,
its lce_fwd and lce_bwd at N=8192 / E=2048 and at main path 7's shape, and its ring_fwd
and ring_bwd at ring case (a)'s diagonal step and step 1, on the inputs of the timing
rows, so that two checkouts' kernels can be compared on one card in one call.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_YAML = os.path.join(HERE, "examples", "benchmark", "llama3_2_1b.yaml")
SEQ4096_YAML = os.path.join(HERE, "examples", "benchmark", "llama3_2_1b_seq4096.yaml")
MOE_YAML = os.path.join(HERE, "examples", "benchmark", "qwen3_moe_a3b_proxy.yaml")
# The published widths of Qwen/Qwen3-30B-A3B (its config.json on the Hugging Face Hub)
# laid over the proxy config, at 4 of its 48 layers; every layer is MoE, so
# intermediate_size is unused. The experts run the pallas backend, as
# examples/llm_finetune/qwen3_moe_fastpath.yaml sets it.
QWEN3_30B_A3B = {
    "hidden_size": 2048, "intermediate_size": 6144, "moe_intermediate_size": 768,
    "num_attention_heads": 32, "num_key_value_heads": 4, "head_dim": 128,
    "num_experts": 128, "num_experts_per_tok": 8, "norm_topk_prob": True,
    "vocab_size": 151936, "tie_word_embeddings": False, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-6, "router_aux_loss_coef": 0.001, "max_position_embeddings": 40960,
    "num_hidden_layers": 4,
}
MOE_LAYERS_TRAIN_FT = 2  # depth of main path 6
CP_YAML = os.path.join(HERE, "examples", "llm_finetune", "llama3_8b_long_context_cp.yaml")
# The published widths of meta-llama/Meta-Llama-3-8B (its config.json on the Hugging Face
# Hub) laid over the long-context CP config, at 4 of its 32 layers; random weights from
# the seed (no weights in the repository).
LLAMA3_8B = {
    "vocab_size": 128256, "hidden_size": 4096, "intermediate_size": 14336,
    "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 128,
    "tie_word_embeddings": False, "rope_theta": 500000.0, "rms_norm_eps": 1e-5,
    "max_position_embeddings": 8192, "num_hidden_layers": 4,
}
CP_LAYERS_TRAIN_FT = 2  # depth of main path 8
BASELINE_YAML = os.path.join(HERE, "examples", "llm_finetune", "llama3_2_1b_hellaswag.yaml")
# The published config.json of meta-llama/Llama-3.2-1B (Hugging Face Hub) at 2 of its 16
# layers: main path 9 writes random weights from the seed in this shape to a local HF
# directory, which the config loads as pretrained (no weights in the repository). At 16
# layers a save (f32 parameters, both Adam moments, the HF export) would be ~15 GB; 4
# layers (8.1 GB) ran until the script's other paths needed the time (its six saves and
# two restores, with the deterministic repeat, are the script's largest cost).
LLAMA32_1B = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": 128256,
    "hidden_size": 2048, "intermediate_size": 8192, "num_hidden_layers": 2,
    "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 64,
    "hidden_act": "silu", "max_position_embeddings": 131072, "rope_theta": 500000.0,
    "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                     "original_max_position_embeddings": 8192, "rope_type": "llama3"},
    "rms_norm_eps": 1e-5, "tie_word_embeddings": True, "initializer_range": 0.02,
    "bos_token_id": 128000, "eos_token_id": 128001, "torch_dtype": "bfloat16",
}
BASELINE_LAYERS = 1  # depth of main path 9 (2 until the encoder slice's paths: its six saves)
BASELINE_STEPS = 4  # max_steps of main path 9: checkpoints and validation at 2 and 4
BASELINE_VAL_BATCHES = 2  # validation_max_batches of main path 9
BASELINE_MODEL = dict(LLAMA32_1B, num_hidden_layers=BASELINE_LAYERS)
GPT_OSS_YAML = os.path.join(HERE, "examples", "benchmark", "gpt_oss_20b_proxy.yaml")
# The published config.json of openai/gpt-oss-20b (Hugging Face Hub) laid over the proxy
# config, at 4 of its 24 layers (2 sliding, 2 full, alternating from sliding, as its
# layer_types run); random weights from the seed (no weights in the repository).
GPT_OSS_20B = {
    "vocab_size": 201088, "hidden_size": 2880, "intermediate_size": 2880,
    "num_attention_heads": 64, "num_key_value_heads": 8, "head_dim": 64,
    "num_local_experts": 32, "num_experts_per_tok": 4, "sliding_window": 128,
    "layer_types": ["sliding_attention", "full_attention"] * 2,
    "rope_theta": 150000.0,
    "rope_scaling": {"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0, "beta_slow": 1.0,
                     "truncate": False, "original_max_position_embeddings": 4096},
    "max_position_embeddings": 131072, "swiglu_limit": 7.0, "attention_bias": True,
    "tie_word_embeddings": False, "rms_norm_eps": 1e-5, "router_aux_loss_coef": 0.9,
    "initializer_range": 0.02, "num_hidden_layers": 4,
}
GPT_OSS_LAYERS_TRAIN_FT = 2  # depth of main path 12
PHI3_YAML = os.path.join(HERE, "examples", "benchmark", "phi3_proxy.yaml")
PHI3_SFT_YAML = os.path.join(HERE, "examples", "llm_finetune", "phi3_mini_sft.yaml")
# The published config.json of microsoft/Phi-3-mini-4k-instruct (Hugging Face Hub): 32
# heads of 96 over width 3072 (the flash kernels' head_dim 96), a sliding window of 2047
# on every layer, no rope_scaling. Main path 13 lays its widths over the proxy config at
# all 32 layers; main path 14 writes it at PHI3_LAYERS_TRAIN_FT layers as a local HF
# directory of random weights from the seed (no weights in the repository).
PHI3_MINI = {
    "architectures": ["Phi3ForCausalLM"], "model_type": "phi3", "vocab_size": 32064,
    "hidden_size": 3072, "intermediate_size": 8192, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 32, "hidden_act": "silu",
    "max_position_embeddings": 4096, "original_max_position_embeddings": 4096,
    "sliding_window": 2047, "rope_theta": 10000.0, "rope_scaling": None,
    "rms_norm_eps": 1e-5, "tie_word_embeddings": False, "initializer_range": 0.02,
    "bos_token_id": 1, "eos_token_id": 32000, "pad_token_id": 32000, "torch_dtype": "bfloat16",
}
PHI3_LAYERS_TRAIN_FT = 2  # depth of main path 14
PHI3_STEPS = 4  # max_steps of main path 14: a consolidated save at steps 2 and 4
DSV3_PROXY_YAML = os.path.join(HERE, "examples", "benchmark", "deepseek_v3_proxy.yaml")
DSV3_EP_YAML = os.path.join(HERE, "examples", "llm_finetune", "deepseek_v3_ep.yaml")
# The published config.json of moonshotai/Moonlight-16B-A3B (Hugging Face Hub): a
# DeepseekV3ForCausalLM with MLA (q_lora_rank null: the direct q projection; qk 128 + 64
# rope, v 128: the ring kernels' (192, 128)), 64 experts top-6 under sigmoid noaux-tc
# routing with the correction bias, 2 shared experts and a dense first layer. Main path
# 16 writes it at MOONLIGHT_LAYERS layers as a local HF directory of random weights from
# the seed (no weights in the repository); main path 17 lays its widths over the
# DeepSeek-V3 proxy config at MOONLIGHT_RING_LAYERS layers.
MOONLIGHT_16B_A3B = {
    "architectures": ["DeepseekV3ForCausalLM"], "model_type": "deepseek_v3",
    "vocab_size": 163840, "hidden_size": 2048, "intermediate_size": 11264,
    "moe_intermediate_size": 1408, "num_hidden_layers": 27, "num_attention_heads": 16,
    "num_key_value_heads": 16, "q_lora_rank": None, "kv_lora_rank": 512,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
    "n_routed_experts": 64, "num_experts_per_tok": 6, "n_shared_experts": 2, "n_group": 1,
    "topk_group": 1, "scoring_func": "sigmoid", "topk_method": "noaux_tc",
    "routed_scaling_factor": 2.446, "norm_topk_prob": True, "first_k_dense_replace": 1,
    "moe_layer_freq": 1, "aux_loss_alpha": 0.001, "seq_aux": True, "hidden_act": "silu",
    "rope_theta": 50000.0, "rope_scaling": None, "rms_norm_eps": 1e-5,
    "max_position_embeddings": 8192, "tie_word_embeddings": False, "attention_bias": False,
    "initializer_range": 0.02, "bos_token_id": 163584, "eos_token_id": 163585,
    "torch_dtype": "bfloat16",
}
# depth of main path 16: the dense layer and 1 MoE layer (the script's time: a slow host
# neared its 1200 s limit at 4; 3 until the encoder slice's paths)
MOONLIGHT_LAYERS = 2
MOONLIGHT_STEPS = 4  # max_steps of main path 16: one consolidated save, at step 4
MOONLIGHT_RING_LAYERS = 2  # depth of main path 17: the dense layer and 1 MoE layer
MOONLIGHT_RING_SEQ, MOONLIGHT_RING_CP = 16384, 4  # main path 17: 4096 tokens a cp shard
GEMMA3_PROXY_YAML = os.path.join(HERE, "examples", "benchmark", "gemma3_proxy.yaml")
GEMMA2_SFT_YAML = os.path.join(HERE, "examples", "llm_finetune", "gemma2_9b_sft.yaml")
# The published config.json of google/gemma-2-27b (Hugging Face Hub): width 4608, 32 heads
# of 128 over 16 kv heads (head_dim 128: the flash kernels' existing tiles), the query
# scale 144^-0.5 (query_pre_attn_scalar, not head_dim), the tanh caps 50 on the attention
# logits and 30 on the final logits, a window of 4096 on alternate layers from the first,
# a tied 256,000-row embedding. Main path 19 lays its widths over the Gemma-3 proxy config
# at GEMMA2_LAYERS layers; main path 20 writes it at GEMMA2_LAYERS_TRAIN_FT layers as a
# local HF directory of random weights from the seed (no weights in the repository).
GEMMA2_27B = {
    "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2", "vocab_size": 256000,
    "hidden_size": 4608, "intermediate_size": 36864, "num_hidden_layers": 46,
    "num_attention_heads": 32, "num_key_value_heads": 16, "head_dim": 128,
    "query_pre_attn_scalar": 144, "attn_logit_softcapping": 50.0,
    "final_logit_softcapping": 30.0, "sliding_window": 4096, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-6, "max_position_embeddings": 8192, "hidden_act": "gelu_pytorch_tanh",
    "hidden_activation": "gelu_pytorch_tanh", "attention_bias": False,
    "tie_word_embeddings": True, "initializer_range": 0.02, "bos_token_id": 2,
    "eos_token_id": 1, "pad_token_id": 0, "torch_dtype": "float32",
}
GEMMA2_LAYERS = 4  # depth of main path 19: 2 sliding, 2 full
GEMMA2_LAYERS_TRAIN_FT = 2  # depth of main path 20: 1 sliding, 1 full
GEMMA2_STEPS = 4  # max_steps of main path 20: one consolidated save, at step 4
GEMMA3_SFT_YAML = os.path.join(HERE, "examples", "llm_finetune", "gemma3_4b_sft.yaml")
# The published config.json of google/gemma-2-9b: width 3584, MLP 14,336, 16 heads of 256
# over 8 kv heads (the flash kernels' 256-wide tiles), the query scale 256^-0.5, the caps
# 50 and 30, a window of 4096 on alternate layers, a tied 256,000-row embedding. Main path
# 21 lays its widths over the Gemma-3 proxy config at GEMMA2_9B_LAYERS layers.
GEMMA2_9B = {
    "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2", "vocab_size": 256000,
    "hidden_size": 3584, "intermediate_size": 14336, "num_hidden_layers": 42,
    "num_attention_heads": 16, "num_key_value_heads": 8, "head_dim": 256,
    "query_pre_attn_scalar": 256, "attn_logit_softcapping": 50.0,
    "final_logit_softcapping": 30.0, "sliding_window": 4096, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-6, "max_position_embeddings": 8192, "hidden_act": "gelu_pytorch_tanh",
    "hidden_activation": "gelu_pytorch_tanh", "attention_bias": False,
    "tie_word_embeddings": True, "initializer_range": 0.02, "bos_token_id": 2,
    "eos_token_id": 1, "pad_token_id": 0, "torch_dtype": "float32",
}
GEMMA2_9B_LAYERS = 8  # depth of main path 21: 4 sliding, 4 full
# The published config.json of google/gemma-3-4b-it, a Gemma3ForConditionalGeneration
# wrapper. Its text_config names width 2560, MLP 10,240, 34 layers, a window of 1024 and
# linear RoPE scaling 8 (on the full layers); the rest of it is Gemma3TextConfig's defaults,
# written out here: vocab 262,208, 8 heads of 256 over 4, query scale 256^-0.5, RoPE bases
# 1e6 (full layers) and 10,000 (sliding), 5 sliding layers to 1 full, a tied embedding, no
# soft-cap. The vision tower's config is kept as published (the text model runs alone: the
# adapter drops the vision tensors, which the directory of main path 23 does not hold).
GEMMA3_4B_TEXT = {
    "architectures": ["Gemma3ForCausalLM"], "model_type": "gemma3_text", "vocab_size": 262208,
    "hidden_size": 2560, "intermediate_size": 10240, "num_hidden_layers": 34,
    "num_attention_heads": 8, "num_key_value_heads": 4, "head_dim": 256,
    "query_pre_attn_scalar": 256, "sliding_window": 1024,
    "rope_scaling": {"rope_type": "linear", "factor": 8.0}, "rope_theta": 1000000.0,
    "rope_local_base_freq": 10000.0, "rms_norm_eps": 1e-6, "max_position_embeddings": 131072,
    "hidden_activation": "gelu_pytorch_tanh", "tie_word_embeddings": True,
    "initializer_range": 0.02,
}
GEMMA3_4B = {
    "architectures": ["Gemma3ForConditionalGeneration"], "model_type": "gemma3",
    "text_config": {k: v for k, v in GEMMA3_4B_TEXT.items() if k != "architectures"},
    "vision_config": {"model_type": "siglip_vision_model", "hidden_size": 1152,
                      "intermediate_size": 4304, "num_hidden_layers": 27,
                      "num_attention_heads": 16, "patch_size": 14, "image_size": 896,
                      "vision_use_head": False},
    "mm_tokens_per_image": 256, "boi_token_index": 255999, "eoi_token_index": 256000,
    "image_token_index": 262144, "eos_token_id": [1, 106], "initializer_range": 0.02,
    "torch_dtype": "bfloat16",
}
GEMMA3_4B_LAYERS_TRAIN_FT = 6  # depth of main path 23: 5 sliding, 1 full
GEMMA3_4B_STEPS = 4  # max_steps of main path 23: one consolidated save, at step 4
LORA_YAML = os.path.join(HERE, "examples", "llm_finetune", "llama3_2_1b_lora.yaml")
QLORA_YAML = os.path.join(HERE, "examples", "llm_finetune", "llama3_2_1b_qlora.yaml")
DORA_YAML = os.path.join(HERE, "examples", "llm_finetune", "llama3_2_1b_dora.yaml")
LORA_DROPOUT_YAML = os.path.join(HERE, "examples", "llm_finetune",
                                 "llama3_2_1b_lora_dropout.yaml")
QWEN25_LORA_YAML = os.path.join(HERE, "examples", "llm_finetune", "qwen2_5_7b_lora.yaml")
QWEN3_MOE_LORA_YAML = os.path.join(HERE, "examples", "llm_finetune",
                                   "qwen3_moe_lora_dropout.yaml")
GEMMA3_QAT_YAML = os.path.join(HERE, "examples", "llm_finetune", "gemma3_4b_qat.yaml")
# The published config.json of Qwen/Qwen2.5-7B (Hugging Face Hub), all 28 layers;
# attention_bias is written out (HF's Qwen2 always has q / k / v biases; both packages'
# config readers take the key), sliding_window dropped (use_sliding_window is false)
QWEN25_7B = {
    "architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2", "vocab_size": 152064,
    "hidden_size": 3584, "intermediate_size": 18944, "num_hidden_layers": 28,
    "num_attention_heads": 28, "num_key_value_heads": 4, "hidden_act": "silu",
    "max_position_embeddings": 131072, "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
    "tie_word_embeddings": False, "use_sliding_window": False, "attention_bias": True,
    "initializer_range": 0.02, "torch_dtype": "bfloat16",
}
# depth of main paths 24 and 26: 4 of Llama-3.2-1B's 16 (the script's time: a slow host
# neared its 1200 s limit at 16; 8 until the encoder slice's paths)
LORA_LAYERS = 4
LORA_STEPS = 4  # max_steps of main path 24: a save at steps 2 and 4
PEFT_STEPS = 3  # max_steps of main paths 25-28
QAT_STEPS = 4  # max_steps of main path 29
SEQ_CLS_YAML = os.path.join(HERE, "examples", "llm_finetune", "seq_cls.yaml")
QWEN25_SEQ_CLS_YAML = os.path.join(HERE, "examples", "llm_finetune",
                                   "qwen2_5_seq_cls_lora.yaml")
BIENCODER_YAML = os.path.join(HERE, "examples", "biencoder", "llama3_2_1b_last_token_pool.yaml")
MINE_YAML = os.path.join(HERE, "examples", "biencoder", "mine_hard_negatives.yaml")
NANOGPT_YAML = os.path.join(HERE, "examples", "llm_pretrain", "nanogpt.yaml")
SEQ_CLS_LAYERS = 4  # depth of main paths 33 (Llama-3.2-1B's 16) and 34 (Qwen2.5-7B's 28)
SEQ_CLS_STEPS = 4  # max_steps of main path 33: one save, at step 4
QWEN25_SEQ_CLS_STEPS = 3  # max_steps of main path 34
BIENCODER_STEPS = 4  # max_steps of main path 35: validation at steps 2 and 4
BIENCODER_VAL_BATCHES = 1  # validation_max_batches of main path 35
MINE_ROWS = 512  # query / positive pairs of main path 36
GPT2_STEPS = 4  # max_steps of main path 37: saves at steps 2 and 4
COHERE2_SFT_YAML = os.path.join(HERE, "examples", "llm_finetune", "cohere2_r7b_sft.yaml")
MIXTRAL_YAML = os.path.join(HERE, "examples", "benchmark", "mixtral_proxy.yaml")
STARCODER2_YAML = os.path.join(HERE, "examples", "benchmark", "starcoder2_proxy.yaml")
# The published widths of CohereLabs/c4ai-command-r7b-12-2024 (Cohere2, its original
# config.json format: an integer sliding_window_pattern, no layer_types); main path 30
# writes it at COMMAND_R7B_LAYERS layers as a local HF directory of random weights
COMMAND_R7B = {
    "architectures": ["Cohere2ForCausalLM"], "model_type": "cohere2", "vocab_size": 256000,
    "hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 128,
    "rope_theta": 50000.0, "layer_norm_eps": 1e-5, "logit_scale": 0.25,
    "sliding_window": 4096, "sliding_window_pattern": 4, "tie_word_embeddings": True,
    "use_qk_norm": False, "attention_bias": False, "hidden_act": "silu",
    "initializer_range": 0.02, "torch_dtype": "bfloat16",
}
COMMAND_R7B_LAYERS = 4  # depth of main path 30: 3 sliding RoPE layers, then 1 full NoPE one
COMMAND_R7B_STEPS = 4  # max_steps of main path 30: one consolidated save, at step 4
COMMAND_R7B_SEQ = 8192  # main path 30's rows: the window of 4096 bites on the sliding layers
# The published widths of mistralai/Mixtral-8x7B-v0.1; main path 31 lays them over the
# Mixtral proxy config at MIXTRAL_LAYERS layers
MIXTRAL_8X7B = {
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 8,
    "num_local_experts": 8, "num_experts_per_tok": 2, "rope_theta": 1000000.0,
    "router_aux_loss_coef": 0.02, "max_position_embeddings": 32768, "rms_norm_eps": 1e-5,
    "tie_word_embeddings": False, "initializer_range": 0.02,
}
# depth of main path 31: 3 of 32 layers; at 4 its peak passes the card's 80 GB (bf16
# parameters, gradients and adamw_lowmem's two moments alone take 48 GB of 6.1 B)
MIXTRAL_LAYERS = 3
# main path 32: the published widths of four lineage members, each at the depth beside
# it, over examples/benchmark/llama3_2_1b.yaml with its model section replaced
GRANITE_33_2B = {
    "architectures": ["GraniteForCausalLM"], "vocab_size": 49159, "hidden_size": 2048,
    "intermediate_size": 8192, "num_hidden_layers": 40, "num_attention_heads": 32,
    "num_key_value_heads": 8, "tie_word_embeddings": True, "embedding_multiplier": 12.0,
    "residual_multiplier": 0.22, "attention_multiplier": 0.015625, "logits_scaling": 8.0,
    "rms_norm_eps": 1e-5, "initializer_range": 0.02,
}
OLMO2_7B = {
    "architectures": ["Olmo2ForCausalLM"], "vocab_size": 100352, "hidden_size": 4096,
    "intermediate_size": 11008, "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 32, "tie_word_embeddings": False, "rms_norm_eps": 1e-6,
    "initializer_range": 0.02,
}
SMOLLM3_3B = {
    "architectures": ["SmolLM3ForCausalLM"], "vocab_size": 128256, "hidden_size": 2048,
    "intermediate_size": 11008, "num_hidden_layers": 36, "num_attention_heads": 16,
    "num_key_value_heads": 4, "tie_word_embeddings": True, "no_rope_layer_interval": 4,
    "rms_norm_eps": 1e-6, "initializer_range": 0.02,
}
GLM4_9B = {
    "architectures": ["Glm4ForCausalLM"], "vocab_size": 151552, "hidden_size": 4096,
    "intermediate_size": 13696, "num_hidden_layers": 40, "num_attention_heads": 32,
    "num_key_value_heads": 2, "head_dim": 128, "partial_rotary_factor": 0.5,
    "attention_bias": True, "tie_word_embeddings": False, "rms_norm_eps": 1e-5,
    "initializer_range": 0.02,
}
LINEAGE_SWEEP = (("Granite-3.3-2B", GRANITE_33_2B, 40), ("OLMo-2-1124-7B", OLMO2_7B, 2),
                 ("SmolLM3-3B", SMOLLM3_3B, 4), ("GLM-4-9B-0414", GLM4_9B, 2))
SWEEP_WARMUP, SWEEP_TIMED = 1, 3  # benchmark steps of each member of main path 32
# Main paths 38-41 (the MoE families and the hybrids): the published config.json files
# on the Hugging Face Hub, written down here (the repository holds no weights and the
# script needs no network), each laid over a repo YAML at a depth cut for the card's
# memory and the script's time, with random weights from the seed.
# zai-org/GLM-4.5-Air: GQA 96 / 8 at head_dim 128 with q/k/v biases and half-width
# rotary, no q/k norm; sigmoid routing over 128 experts top-8 with the correction bias,
# one shared expert, a dense first layer
GLM45_AIR = {
    "architectures": ["Glm4MoeForCausalLM"], "model_type": "glm4_moe", "vocab_size": 151552,
    "hidden_size": 4096, "intermediate_size": 10944, "moe_intermediate_size": 1408,
    "num_hidden_layers": 46, "num_attention_heads": 96, "num_key_value_heads": 8,
    "head_dim": 128, "partial_rotary_factor": 0.5, "attention_bias": True,
    "use_qk_norm": False, "n_routed_experts": 128, "num_experts_per_tok": 8,
    "n_shared_experts": 1, "n_group": 1, "topk_group": 1, "routed_scaling_factor": 1.0,
    "norm_topk_prob": True, "first_k_dense_replace": 1, "rope_theta": 1000000.0,
    "rope_scaling": None, "rms_norm_eps": 1e-5, "max_position_embeddings": 131072,
    "tie_word_embeddings": False, "initializer_range": 0.02, "hidden_act": "silu",
}
# depth of main path 38: the dense first layer and 2 MoE layers (6.1 B parameters:
# bf16 weights, gradients and adamw_lowmem's two bf16 moments take ~46 GiB)
GLM45_AIR_LAYERS = 3
# MiniMaxAI/MiniMax-M2: GQA 48 / 8 at head_dim 128; every layer MoE, 256 experts top-8,
# sigmoid scores with the correction bias, no shared expert. Its rotary_dim 64 is half
# the head, but HF's rope init (and JAX's reading) takes partial_rotary_factor, absent
# here: the whole head rotates; its q/k norms ("per_layer": over the whole projection)
# are read by JAX as per-head ones (PERF.md, reference caveats)
MINIMAX_M2 = {
    "architectures": ["MiniMaxM2ForCausalLM"], "model_type": "minimax_m2",
    "vocab_size": 200064, "hidden_size": 3072, "intermediate_size": 1536,
    "num_hidden_layers": 62, "num_attention_heads": 48, "num_key_value_heads": 8,
    "head_dim": 128, "rotary_dim": 64, "rope_theta": 5000000.0, "num_local_experts": 256,
    "num_experts_per_tok": 8, "scoring_func": "sigmoid", "use_routing_bias": True,
    "router_aux_loss_coef": 0.001, "use_qk_norm": True, "qk_norm_type": "per_layer",
    "shared_intermediate_size": 0, "rms_norm_eps": 1e-6, "max_position_embeddings": 196608,
    "tie_word_embeddings": False, "initializer_range": 0.02, "hidden_act": "silu",
}
# A Step-3.5 geometry after stepfun-ai/Step-3.5-Flash, UNVERIFIED against its published
# config.json (written down without the file: the repository holds none and the script
# needs no network): 45 layers, one full-attention layer (64 heads over 8) then three
# sliding ones (window 512, 96 heads over 8), head_dim 128, the head-wise gate; full
# layers rope half the head at theta 5e6, sliding ones all of it at 1e4; dense layers
# 0-2, then 288 experts top-8 (sigmoid, router bias) beside a shared expert. The layer
# pattern, the per-layer thetas and factors and the router settings are reconstructed,
# and the dict names no swiglu_limits / swiglu_limits_shared: its dense MLPs and shared
# experts run unclamped on the card (the clamped SwiGLU is held to JAX's on the CPU,
# tests/test_torch_step3p5.py). Check it against the published file once the repository
# has one.
STEP35_FLASH_LAYERS_ALL = 45
STEP35_FLASH = {
    "architectures": ["Step3p5ForCausalLM"], "model_type": "step3p5", "vocab_size": 128896,
    "hidden_size": 4096, "intermediate_size": 11264, "num_hidden_layers": 45,
    "num_attention_heads": 64, "num_attention_groups": 8, "head_dim": 128,
    "layer_types": ["full_attention" if i % 4 == 0 else "sliding_attention"
                    for i in range(STEP35_FLASH_LAYERS_ALL)],
    "sliding_window": 512,
    "attention_other_setting": {"attention_type": "sliding_attention",
                                "num_attention_heads": 96, "num_attention_groups": 8,
                                "head_dim": 128, "true_head_dim": 128},
    "use_head_wise_attn_gate": True,
    "rope_theta": [5000000.0 if i % 4 == 0 else 10000.0
                   for i in range(STEP35_FLASH_LAYERS_ALL)],
    "partial_rotary_factors": [0.5 if i % 4 == 0 else 1.0
                               for i in range(STEP35_FLASH_LAYERS_ALL)],
    "moe_layers_enum": ",".join(str(i) for i in range(3, STEP35_FLASH_LAYERS_ALL)),
    "moe_num_experts": 288, "moe_top_k": 8, "moe_intermediate_size": 1280,
    "share_expert_dim": 1280, "moe_router_activation": "sigmoid",
    "moe_router_scaling_factor": 3.0, "use_moe_router_bias": True,
    "max_position_embeddings": 262144, "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
    "initializer_range": 0.02,
}
# Qwen/Qwen3-Next-80B-A3B-Instruct: 48 layers in periods of three gated DeltaNet layers
# (16 key heads of 128, 32 value heads of 128) and one gated full-attention layer (16
# heads over 2 at head_dim 256, a quarter rotary); 512 experts top-10 of 512 wide and a
# gated shared expert in every layer
QWEN3_NEXT_80B = {
    "architectures": ["Qwen3NextForCausalLM"], "model_type": "qwen3_next",
    "vocab_size": 151936, "hidden_size": 2048, "intermediate_size": 5120,
    "num_hidden_layers": 48, "full_attention_interval": 4, "num_attention_heads": 16,
    "num_key_value_heads": 2, "head_dim": 256, "partial_rotary_factor": 0.25,
    "rope_theta": 10000000.0, "linear_num_value_heads": 32, "linear_num_key_heads": 16,
    "linear_key_head_dim": 128, "linear_value_head_dim": 128, "linear_conv_kernel_dim": 4,
    "num_experts": 512, "num_experts_per_tok": 10, "moe_intermediate_size": 512,
    "shared_expert_intermediate_size": 512, "decoder_sparse_step": 1, "mlp_only_layers": [],
    "norm_topk_prob": True, "router_aux_loss_coef": 0.001, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 262144, "tie_word_embeddings": False,
    "initializer_range": 0.02, "hidden_act": "silu",
}
QWEN3_NEXT_LAYERS = 4  # depth of main path 41: one period, 3 DeltaNet layers and 1 full


class ByteTokenizer:
    """A byte-level stand-in for the model's tokenizer (no tokenizer files in the
    repository): BOS, then one id per UTF-8 byte (byte + 3); 0 pads, 2 ends."""

    pad_token_id, bos_token_id, eos_token_id = 0, 1, 2

    def encode(self, text: str) -> list[int]:
        return [self.bos_token_id] + [b + 3 for b in text.encode()]


_WORDS = ("the man a woman then is are and of to in on with into her his they "
          "puts takes walks starts shows continues across around ball water bike "
          "camera kitchen rope slowly quickly again while holding using").split()


def write_hellaswag_jsonl(path: str, rows: int, seed: int) -> str:
    """HellaSwag-shaped rows ``{ctx, endings, label}`` of random words from ``seed``:
    contexts of 20-80 words and four endings of 5-25, as the dataset's rows run."""
    import numpy as np

    rng = np.random.RandomState(seed)

    def words(lo, hi):
        return " ".join(rng.choice(_WORDS, rng.randint(lo, hi)))

    with open(path, "w") as f:
        for _ in range(rows):
            f.write(json.dumps({"ctx": words(20, 80), "endings": [words(5, 25) for _ in range(4)],
                                "label": int(rng.randint(4))}) + "\n")
    return path


def _words(rng, lo, hi) -> str:
    return " ".join(rng.choice(_WORDS, rng.randint(lo, hi)))


def write_seq_cls_jsonl(path: str, rows: int, labels: int, seed: int) -> str:
    """Classification rows ``{text, label}`` of random words from ``seed``: texts of 20-80
    words (about 100-500 bytes, within the files' rows of 512), labels in [0, labels)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(rows):
            f.write(json.dumps({"text": _words(rng, 20, 80),
                                "label": int(rng.randint(labels))}) + "\n")
    return path


def write_retrieval_rows(path: str, rows: int, seed: int, negatives: int = 0) -> str:
    """Retrieval rows ``{query, pos_doc[, neg_doc]}`` of random words from ``seed``: a
    query of 3-10 words, its positive passage that query and 20-50 words more (the
    lexical overlap a real positive has), and with ``negatives`` the positives of the
    next rows as its hard negatives."""
    import numpy as np

    rng = np.random.RandomState(seed)
    queries = [_words(rng, 3, 10) for _ in range(rows)]
    docs = [f"{q} {_words(rng, 20, 50)}" for q in queries]
    with open(path, "w") as f:
        for i, (q, d) in enumerate(zip(queries, docs)):
            row = {"query": q, "pos_doc": d}
            if negatives:
                row["neg_doc"] = [docs[(i + j) % rows] for j in range(1, negatives + 1)]
            f.write(json.dumps(row) + "\n")
    return path


def write_nanogpt_shards(out_dir: str, tokens: int, vocab: int, seed: int) -> str:
    """Two nanoGPT .bin shards (write_shard: magic 278895051, uint16) of ``tokens`` ids
    uniform in [0, vocab) from ``seed``; returns their file pattern."""
    import numpy as np

    from automodel_tpu_torch.data.llm.nanogpt_dataset import write_shard

    ids = np.random.RandomState(seed).randint(0, vocab, tokens)
    for i, part in enumerate(np.array_split(ids, 2)):
        write_shard(os.path.join(out_dir, f"fineweb_train_{i:06d}.bin"), part)
    return os.path.join(out_dir, "fineweb_train_*.bin")


def local_data_config(out_dir: str, yaml_path: str, sections: dict) -> str:
    """A file of examples/ with the top-level ``sections`` given in place of its own (its
    hub dataset and model sections: no network here), a ByteTokenizer, and every other
    setting the file's; written to ``out_dir``."""
    import yaml

    with open(yaml_path) as f:
        cfg = yaml.safe_load(f)
    cfg.update(sections, tokenizer={"_target_": "chip_smoke.ByteTokenizer"})
    path = os.path.join(out_dir, "local_" + os.path.basename(yaml_path))
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def write_pretrained(out_dir: str, config: dict = LLAMA32_1B, seed: int = 0,
                     device: str = "cuda", prefix: str = "") -> str:
    """A local HF directory (config.json and model.safetensors, bf16 as published) of a
    random-init model of ``config`` (its architecture's class: Llama-3.2-1B at LLAMA32_1B's
    depth, or Phi-3-mini in HF's fused layout), written by the port's own writer;
    ``prefix`` goes before every tensor's name (``language_model.``: the text model's
    tensors as a Gemma3ForConditionalGeneration checkpoint names them)."""
    import torch

    from automodel_tpu_torch.checkpoint.safetensors_io import save_safetensors
    from automodel_tpu_torch.models.auto import AutoModelForCausalLM

    model = AutoModelForCausalLM.from_config(
        config, device=device, dtype=torch.bfloat16,
        generator=torch.Generator(device=device).manual_seed(seed))
    tensors = model.state_dict_adapter().to_hf_lazy(model.param_dict())
    save_safetensors({prefix + k: v for k, v in tensors.items()}, out_dir)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return out_dir


def baseline_config(out_dir: str, hf_dir: str, train_jsonl: str, val_jsonl: str) -> str:
    """BASELINE config #1 (examples/llm_finetune/llama3_2_1b_hellaswag.yaml) with its model
    section pointing at ``hf_dir`` and its data sections at local HellaSwag JSONL rows with
    :class:`ByteTokenizer`; every other setting is the file's. Written to ``out_dir``."""
    import yaml

    with open(BASELINE_YAML) as f:
        cfg = yaml.safe_load(f)
    hellaswag = "automodel_tpu_torch.data.llm.hellaswag.HellaSwagDataset"
    cfg["model"] = {"pretrained_model_name_or_path": hf_dir}
    cfg["dataset"] = {"_target_": hellaswag, "path_or_dataset_id": train_jsonl, "split": "train"}
    cfg["validation_dataset"] = {"_target_": hellaswag, "path_or_dataset_id": val_jsonl,
                                 "split": "validation"}
    cfg["tokenizer"] = {"_target_": "chip_smoke.ByteTokenizer"}
    path = os.path.join(out_dir, "llama3_2_1b_hellaswag_local.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def baseline_args(ckpt_dir: str) -> list[str]:
    """CLI overrides of main path 9: prefetch on, a checkpoint and a validation pass every
    2 steps over 2 batches, BASELINE_STEPS steps, the checkpoints under ``ckpt_dir``."""
    return ["--dataloader.prefetch.enabled", "true",
            "--step_scheduler.ckpt_every_steps", "2", "--step_scheduler.val_every_steps", "2",
            "--validation_max_batches", str(BASELINE_VAL_BATCHES),
            "--step_scheduler.max_steps", str(BASELINE_STEPS),
            "--checkpoint.checkpoint_dir", ckpt_dir]


def llama3_8b_args(layers: int = LLAMA3_8B["num_hidden_layers"]) -> list[str]:
    """CLI overrides that turn the CP config (with its dataset section replaced by
    :func:`cp_config`) into the slice configuration: the published widths, random
    weights, one microbatch a step, no periodic checkpoint."""
    args = []
    for key, value in dict(LLAMA3_8B, num_hidden_layers=layers).items():
        args += [f"--model.config.{key}", str(value).lower() if isinstance(value, bool)
                 else str(value)]
    return args + ["--model.pretrained_model_name_or_path", "null",
                   "--step_scheduler.grad_acc_steps", "1",
                   "--step_scheduler.ckpt_every_steps", "0"]


def cp_config(out_dir: str) -> str:
    """The CP config with its HellaSwag dataset section (no files in the repository, no
    network) replaced by the mock dataset at seq 32768, written to ``out_dir``. CLI
    overrides cannot drop the section's keys, hence a derived file."""
    import yaml

    with open(CP_YAML) as f:
        cfg = yaml.safe_load(f)
    cfg["dataset"] = {"_target_": "automodel_tpu_torch.data.llm.mock.MockSFTDataset",
                      "vocab_size": LLAMA3_8B["vocab_size"], "seq_len": cfg["seq_len"],
                      "num_samples": 64, "seed": 0}
    path = os.path.join(out_dir, "llama3_8b_long_context_cp_mock.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def at_depth(model: dict, layers: int) -> dict:
    """``model`` (an HF config dict) at its first ``layers`` layers: its per-layer lists
    (``layer_types``, Step-3.5's RoPE thetas and factors) cut to them, and a string
    ``moe_layers_enum`` to the MoE layers among them."""
    out = dict(model, num_hidden_layers=layers)
    for key, value in model.items():
        if isinstance(value, list) and len(value) == model["num_hidden_layers"]:
            out[key] = value[:layers]
    if isinstance(model.get("moe_layers_enum"), str):
        out["moe_layers_enum"] = ",".join(
            x for x in model["moe_layers_enum"].split(",") if int(x) < layers)
    return out


def model_config_args(model: dict) -> list[str]:
    """``--model.config.KEY VALUE`` overrides that lay ``model`` over a YAML's ``config:``
    block (lists, dicts and null as JSON, booleans in lower case)."""
    args = []
    for key, value in model.items():
        args += [f"--model.config.{key}",
                 json.dumps(value) if value is None or isinstance(value, (list, dict))
                 else str(value).lower() if isinstance(value, bool) else str(value)]
    return args


def gpt_oss_args(layers: int = GPT_OSS_20B["num_hidden_layers"]) -> list[str]:
    """CLI overrides that turn the GPT-OSS proxy config into the slice configuration: the
    published widths at ``layers`` layers (layer_types cut to them), the pallas experts."""
    return [*model_config_args(at_depth(GPT_OSS_20B, layers)),
            "--dataset.vocab_size", str(GPT_OSS_20B["vocab_size"]),
            "--backend.experts_backend", "pallas"]


def phi3_args(layers: int = PHI3_MINI["num_hidden_layers"]) -> list[str]:
    """CLI overrides that lay the published Phi-3-mini widths over the proxy config (which
    names Phi3ForCausalLM and has no rope_scaling), at ``layers`` layers."""
    args = []
    for key in ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
                "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
                "original_max_position_embeddings", "sliding_window", "rope_theta",
                "rms_norm_eps", "tie_word_embeddings", "initializer_range"):
        value = layers if key == "num_hidden_layers" else PHI3_MINI[key]
        args += [f"--model.config.{key}", str(value).lower() if isinstance(value, bool)
                 else str(value)]
    return args + ["--dataset.vocab_size", str(PHI3_MINI["vocab_size"])]


def phi3_sft_args(hf_dir: str, ckpt_dir: str) -> list[str]:
    """Main path 14's overrides of examples/llm_finetune/phi3_mini_sft.yaml: the model from
    the local directory ``hf_dir``, the mock data at Phi-3's vocabulary (the file's 128,256
    runs past it), 64 of its 65,536 samples (packing reads them all), 1000-token documents
    packed into its rows of 4096 (segment ids into the kernels), 2 microbatches a step,
    PHI3_STEPS steps, a checkpoint (with the consolidated HF export) every 2 steps under
    ``ckpt_dir``."""
    return ["--model.pretrained_model_name_or_path", hf_dir,
            "--dataset.vocab_size", str(PHI3_MINI["vocab_size"]), "--dataset.seq_len", "1000",
            "--dataset.num_samples", "64",
            "--packed_sequence.packed_sequence_size", "4096",
            "--backend.attention_segments", "true",
            "--step_scheduler.grad_acc_steps", "2", "--step_scheduler.max_steps", str(PHI3_STEPS),
            "--step_scheduler.ckpt_every_steps", "2", "--checkpoint.checkpoint_dir", ckpt_dir]


def moonlight_sft_args(hf_dir: str, ckpt_dir: str) -> list[str]:
    """Main path 16's overrides of examples/llm_finetune/deepseek_v3_ep.yaml: the model from
    the local directory ``hf_dir`` in bf16 (the file's f32 default would hold adamw's
    full-size f32 state and temporaries for 2.5 B parameters, and a save would be ~39
    GB), one process (``ep`` 64 -> 1, the ``dense`` dispatcher: ``a2a`` needs expert
    parallelism), the mock data at Moonlight's vocabulary, 128 of its 65,536 samples
    (packing reads them all), 500-token documents packed into its rows of 4096,
    MOONLIGHT_STEPS steps of 2 microbatches (16 in the file), one checkpoint (with the
    consolidated HF export) at the last step under ``ckpt_dir``: a save of ~20 GB takes
    36-61 s, which the script's time limit cannot spare twice."""
    return ["--model.pretrained_model_name_or_path", hf_dir, "--model.params_dtype", "bfloat16",
            "--distributed.ep", "1", "--backend.dispatcher", "dense",
            "--dataset.vocab_size", str(MOONLIGHT_16B_A3B["vocab_size"]),
            "--dataset.seq_len", "500", "--dataset.num_samples", "128",
            "--packed_sequence.packed_sequence_size", "4096",
            "--backend.attention_segments", "true",
            "--step_scheduler.grad_acc_steps", "2",
            "--step_scheduler.max_steps", str(MOONLIGHT_STEPS),
            "--step_scheduler.ckpt_every_steps", str(MOONLIGHT_STEPS),
            "--checkpoint.checkpoint_dir", ckpt_dir]


def moonlight_ring_args(layers: int = MOONLIGHT_RING_LAYERS) -> list[str]:
    """Main path 17's overrides of the DeepSeek-V3 proxy config: Moonlight's published
    widths at ``layers`` layers, ring attention over cp MOONLIGHT_RING_CP folded onto the
    card, one row of MOONLIGHT_RING_SEQ tokens a step."""
    args = []
    for key, value in dict(MOONLIGHT_16B_A3B, num_hidden_layers=layers).items():
        if key in ("architectures", "model_type", "torch_dtype", "rope_scaling"):
            continue
        args += [f"--model.config.{key}", "null" if value is None
                 else str(value).lower() if isinstance(value, bool) else str(value)]
    return args + ["--dataset.vocab_size", str(MOONLIGHT_16B_A3B["vocab_size"]),
                   "--backend.context_parallel", "ring",
                   "--distributed.cp", str(MOONLIGHT_RING_CP),
                   "--seq_len", str(MOONLIGHT_RING_SEQ),
                   "--dataset.seq_len", str(MOONLIGHT_RING_SEQ), "--micro_batch_size", "1"]


def gemma3_proxy_args() -> list[str]:
    """Main path 18's override of the Gemma-3 proxy config, and 23's of gemma3_4b_sft.yaml:
    attention through the flash kernels (neither file names a backend.attention, whose
    default is the plain path)."""
    return ["--backend.attention", "flash"]


# the keys of a Gemma config that gemma2_args lays over the proxy's, where the config has them
_GEMMA_KEYS = ("vocab_size", "hidden_size", "intermediate_size", "num_attention_heads",
               "num_key_value_heads", "head_dim", "query_pre_attn_scalar",
               "attn_logit_softcapping", "final_logit_softcapping", "sliding_window",
               "rope_theta", "rope_local_base_freq", "rope_scaling", "rms_norm_eps",
               "max_position_embeddings", "tie_word_embeddings", "initializer_range")


def gemma2_args(layers: int = GEMMA2_LAYERS, model: dict = GEMMA2_27B) -> list[str]:
    """The overrides of the Gemma-3 proxy config that run a published Gemma config (main
    path 19: Gemma-2-27B; 21: Gemma-2-9B; 22: Gemma-3-4B's text config): its widths, caps,
    window and RoPE at ``layers`` layers under its architecture, with no
    sliding_window_pattern (the proxy's 6 is Gemma-3's default; Gemma-2's layers
    alternate), the mock data at its vocabulary (the proxy's 262,144 differs), and
    attention through the flash kernels."""
    args = []
    for key in _GEMMA_KEYS:
        if key not in model:
            continue
        value = model[key]
        args += [f"--model.config.{key}",
                 str(value).lower() if isinstance(value, bool)
                 else json.dumps(value) if isinstance(value, dict) else str(value)]
    return args + ["--model.config.architectures", json.dumps(model["architectures"]),
                   "--model.config.num_hidden_layers", str(layers),
                   "--model.config.sliding_window_pattern", "null",
                   "--dataset.vocab_size", str(model["vocab_size"]),
                   *gemma3_proxy_args()]


def mock_data_config(out_dir: str, yaml_path: str, vocab: int,
                     model: dict | None = None) -> str:
    """A fine-tune file of examples/llm_finetune with its HellaSwag dataset section (a
    hub dataset or a ``_target_`` name neither package has, and no network) replaced by the
    mock dataset at ``vocab`` and the file's seq_len, and its model section by ``model``
    when given (a model built from ``config``, in place of a hub id); every other setting
    is the file's. Written to ``out_dir``."""
    import yaml

    with open(yaml_path) as f:
        cfg = yaml.safe_load(f)
    cfg["dataset"] = {"_target_": "automodel_tpu_torch.data.llm.mock.MockSFTDataset",
                      "vocab_size": vocab, "seq_len": cfg["seq_len"], "num_samples": 64,
                      "seed": 0}
    if model is not None:
        cfg["model"] = model
    path = os.path.join(out_dir, "mock_" + os.path.basename(yaml_path))
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def gemma2_sft_config(out_dir: str) -> str:
    """examples/llm_finetune/gemma2_9b_sft.yaml with its HellaSwag dataset section (a
    ``_target_`` name neither package has, and no network) replaced by the mock dataset at
    Gemma-2's vocabulary and the file's seq_len, written to ``out_dir``."""
    return mock_data_config(out_dir, GEMMA2_SFT_YAML, GEMMA2_27B["vocab_size"])


def gemma2_sft_args(hf_dir: str, ckpt_dir: str, steps: int = GEMMA2_STEPS) -> list[str]:
    """The overrides of a Gemma SFT file (main path 20: :func:`gemma2_sft_config`'s; 23:
    examples/llm_finetune/gemma3_4b_sft.yaml, its mock data as it stands): the model from
    the local directory ``hf_dir`` (for the hub id) in bf16, 2 microbatches a step (8 in
    the files), ``steps`` steps, a checkpoint (with the consolidated HF export) every 2
    steps under ``ckpt_dir``."""
    return ["--model.pretrained_model_name_or_path", hf_dir, "--model.params_dtype", "bfloat16",
            "--step_scheduler.grad_acc_steps", "2", "--step_scheduler.max_steps", str(steps),
            "--step_scheduler.ckpt_every_steps", "2", "--checkpoint.checkpoint_dir", ckpt_dir]


def command_r7b_sft_args(hf_dir: str, ckpt_dir: str) -> list[str]:
    """Main path 30's overrides of examples/llm_finetune/cohere2_r7b_sft.yaml (its dataset
    swapped by :func:`mock_data_config`): the model from the local directory ``hf_dir`` in
    bf16, rows of COMMAND_R7B_SEQ tokens (the file's 4096 would fit inside the window),
    2 microbatches a step (8 in the file), COMMAND_R7B_STEPS steps, one checkpoint (with
    the consolidated HF export) at the last step under ``ckpt_dir``."""
    return ["--model.pretrained_model_name_or_path", hf_dir, "--model.params_dtype", "bfloat16",
            "--seq_len", str(COMMAND_R7B_SEQ), "--dataset.seq_len", str(COMMAND_R7B_SEQ),
            "--step_scheduler.grad_acc_steps", "2",
            "--step_scheduler.max_steps", str(COMMAND_R7B_STEPS),
            "--step_scheduler.ckpt_every_steps", str(COMMAND_R7B_STEPS),
            "--checkpoint.checkpoint_dir", ckpt_dir]


def mixtral_args(layers: int = MIXTRAL_LAYERS) -> list[str]:
    """Main path 31's overrides of the Mixtral proxy config: Mixtral-8x7B's published
    widths at ``layers`` layers; every other setting is the file's (mb 4 x 2048,
    adamw_lowmem, mlp_dots, flash)."""
    return [*model_config_args(at_depth(MIXTRAL_8X7B, layers)),
            "--dataset.vocab_size", str(MIXTRAL_8X7B["vocab_size"])]


def lineage_config(out_dir: str, model: dict, layers: int) -> str:
    """examples/benchmark/llama3_2_1b.yaml with its model section replaced by ``model`` at
    ``layers`` layers (bf16 parameters, as the file's) and the mock data at the model's
    vocabulary: one member of main path 32, written to ``out_dir``."""
    return mock_data_config(out_dir, BENCH_YAML, model["vocab_size"], {
        "params_dtype": "bfloat16", "config": dict(model, num_hidden_layers=layers)})


def qwen3_args(layers: int = QWEN3_30B_A3B["num_hidden_layers"]) -> list[str]:
    """CLI overrides that turn the proxy config into the slice configuration."""
    return [*model_config_args(at_depth(QWEN3_30B_A3B, layers)),
            "--dataset.vocab_size", str(QWEN3_30B_A3B["vocab_size"]),
            "--backend.experts_backend", "pallas"]


WARMUP, TIMED = 2, 5  # benchmark steps of the main-path runs (CLI overrides)
TRAIN_FT_STEPS = 3  # train_ft steps of main path 3
PEAK_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# kernel vs plain version, bf16 kernel against f32 plain from the same bf16 inputs:
# O is stored in bf16 (half an ulp near |O| ~ 1-4 is up to 8e-3); lse stays f32;
# the backward rounds P and dS to bf16 for its tensor-core products
TOL_O, TOL_LSE, TOL_GRAD = 2e-2, 1e-3, 1e-2
# flash vs xla through 2 bf16 layers at full width: both paths round activations and
# gradients to bf16, so they differ by a few bf16 ulps
TOL_MODEL_LOSS, TOL_MODEL_GRAD = 1e-2, 2e-2
# Qwen3-MoE, 1 layer at the slice widths: the kernels (flash, gmm/tgmm) against the plain
# versions (xla attention, the grouped GEMM's reference) with routing held fixed; bf16
# activations and gradients as in the Llama check above
TOL_MOE_LOSS, TOL_MOE_GRAD = 1e-2, 2e-2
# main path 4 (linear_ce, tied) against main path 1 (masked_ce) at the first step, the
# same weights and batch: linear CE takes f32 logits of the bf16 h and w where masked
# CE upcasts bf16-rounded logits; the mean over 8192 tokens differs by ~1e-4
TOL_TIED_LOSS = 1e-3
# main path 35's first loss, flash against xla (the same weights and batch): 16 bf16
# non-causal layers, embeddings normalised and their products over temperature 0.02,
# which scales a bf16 rounding of a score by 50
TOL_BIENCODER_LOSS = 2e-2
# linear CE kernels vs plain version (f32 from the same bf16 inputs). z: the kernel
# accumulates the same bf16 products in f32 in another order (|z| up to ~150 in case
# b, where 1e-5 relative is 1.5e-3). dH, dW: the kernel rounds dlogits to bf16
# before its two products (as the TPU kernel does) and stores dH, dW in bf16, each
# ~2e-3 relative. Against the exact gradient with the filter on: the skipped blocks
# hold softmax mass below filter_eps per element, at most V * 1e-7 = 1.3e-2 a row.
TOL_Z, TOL_LCE_GRAD, TOL_FILTER_EXACT = 2e-3, 1e-2, 2e-2
LCE_PEAK_LIMIT_GB = 2.1  # less than one bf16 (N, V) logits tensor at N=8192 (2.1 GB)
# grouped GEMM kernels vs plain version (f32 from the same bf16 inputs), relative L2 of
# out, dX and dW: the kernels round their f32 sums to bf16 once (~2e-3 relative)
TOL_GMM = 1e-2


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _kernel_name(mangled: str) -> str:
    """``kernel<args>`` from a mangled kernel name (template arguments that are ints,
    bools or classes); the mangled name where it does not parse."""
    name = mangled.replace("12_GLOBAL__N_1", "")  # the anonymous namespace
    for m in re.finditer(r"(\d+)(?=[A-Za-z_])", name):
        start = m.end()
        ident = name[start:start + int(m.group(1))]
        if not ident.endswith("kernel"):
            continue
        rest, args = name[start + len(ident):], []
        if rest.startswith("I"):
            i = 1
            while i < len(rest) and rest[i] != "E":
                lit = re.match(r"L[ib](\d+)E", rest[i:])
                # a class: its length-prefixed name, nested (N ... E) in a namespace
                # that may be a substitution (S_)
                cls = re.match(r"(N(?:S[0-9A-Z]*_)?)?(\d+)", rest[i:])
                if lit:
                    args.append(lit.group(1))
                    i += lit.end()
                elif cls:
                    j = i + cls.end()
                    args.append(rest[j:j + int(cls.group(2))])
                    i = j + int(cls.group(2)) + (1 if cls.group(1) else 0)
                else:
                    break
        return ident + (f"<{','.join(args)}>" if args else "")
    return mangled


def _ptxas_report(log: str) -> list[str]:
    """``kernel<template args>: registers, spills`` from nvcc's -Xptxas -v output, and
    any note that ptxas serialised a kernel's wgmma instructions (C7514)."""
    out, name = [], None
    for line in log.splitlines():
        if "C7514" in line:  # ptxas serialised a kernel's wgmmas
            out.append(line.strip())
            continue
        entry = re.search(r"entry function '(\S+)'", line)
        if entry:
            name = _kernel_name(entry.group(1))
        elif name and ("registers" in line or "spill" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def _rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def _inputs(torch, b, s, h, kh, d=64, seed=0, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, n, d, device=device, generator=g).to(torch.bfloat16)
                   for n in (h, kh, kh, h))
    return q, k, v, do


def _allowed_pairs(s, window=None):
    """Allowed (q, k) pairs of one causal (batch, head): row i sees min(i + 1, window)."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _segment_pairs(seg, causal) -> int:
    """Allowed (q, k) pairs of one head over a (B, S) tensor of segment ids: pairs within
    one segment (a right-padded row's pads attend to each other, segment 0 == 0), those
    with k at or before q when ``causal``; counted from this run's ids."""
    total = 0
    for row in seg.tolist():
        runs, start = [], 0
        for i in range(1, len(row) + 1):
            if i == len(row) or row[i] != row[start]:
                runs.append(i - start)
                start = i
        total += sum(n * (n + 1) // 2 if causal else n * n for n in runs)
    return total


def _flash_work(q, k, v, window=None, pairs=None):
    """FLOP and byte counts of one causal flash forward and backward, read from the
    timed tensors' own shapes: {"flash_fwd": (flops, bytes), "flash_dq": (...), ...}.
    The bytes count each input read once and each output written once; the FLOPs only
    the allowed pairs (with a sliding ``window``, those inside it; ``pairs``: the
    allowed pairs of one head over the batch, where segment ids or no causal mask set
    them, :func:`_segment_pairs`). Products a (q, k) pair: forward 2 (S, PV), flash_dq 3
    (S, dP, dQ), flash_dkv 4 (S, dP, dV, dK), and the backward as the wrapper runs it
    ("flash_backward": both, from q, k, v, O, dO and lse to dq, dk and dv) 7."""
    b, s, h, d = q.shape
    pairs = h * (b * _allowed_pairs(s, window) if pairs is None else pairs)
    qkv_bytes = 2 * (q.numel() + k.numel() + v.numel())
    lse_bytes = 4 * b * h * s
    return {"flash_fwd": (4 * d * pairs, qkv_bytes + 2 * q.numel() + lse_bytes),  # + O, lse
            # q, k, v, dO, lse, delta read; dq written
            "flash_dq": (6 * d * pairs, qkv_bytes + 2 * 2 * q.numel() + 2 * lse_bytes),
            # q, k, v, dO, lse, delta read; dk, dv written
            "flash_dkv": (8 * d * pairs, qkv_bytes + 2 * q.numel() + 2 * lse_bytes
                          + 2 * (k.numel() + v.numel())),
            # q, k, v, O, dO, lse read; dq, dk, dv written
            "flash_backward": (14 * d * pairs,
                               2 * qkv_bytes + 2 * 2 * q.numel() + lse_bytes)}


@contextlib.contextmanager
def _deterministic(torch, on=True):
    """``torch.use_deterministic_algorithms(on)`` inside the block, restored after. Only
    the kernels' calls run under it here: this process has no CUBLAS_WORKSPACE_CONFIG,
    so a cuBLAS product under the flag would raise."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(on)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def _kernel_case(torch, fa, name, b, s, h, kh, causal, seg=None, d=64, window=None,
                 sinks=False, softcap=None, scale=None, q_scale=1):
    """flash_fwd and the backward (flash_dq, flash_dkv) through flash_attention_cuda
    against the plain version, with a sliding ``window``, per-head ``sinks`` (f32
    logits ~ N(0, 2^2), the sinks' gradient from lse and delta held against the plain
    version's autograd), the logit soft-cap ``softcap``, the softmax ``scale`` (None:
    d^-0.5) and q ~ N(0, ``q_scale``^2) (a power of 2: exact in bf16); returns the
    largest errors (O, dq, dk / dv)."""
    q, k, v, do = _inputs(torch, b, s, h, kh, d)
    q = q * q_scale
    g = torch.Generator(device="cuda").manual_seed(s + h)
    sink = torch.randn(h, device="cuda", generator=g) * 2.0 if sinks else None
    qk, kk, vk = (x.clone().requires_grad_() for x in (q, k, v))
    sk = [] if sink is None else [sink.clone().requires_grad_()]
    opts = dict(causal=causal, segment_ids_q=seg, sliding_window=window,
                logit_soft_cap=softcap, softmax_scale=scale)
    o, lse = fa.flash_attention_cuda(qk, kk, vk, sinks=sk[0] if sk else None, **opts)
    grads = torch.autograd.grad(o, (qk, kk, vk, *sk), do)
    torch.cuda.synchronize()
    o = o.detach()
    o_ref, lse_ref, grads_ref = _reference_by_kv_groups(torch, fa, q, k, v, do, sink, opts)
    err_o = (o.float() - o_ref).abs().max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    rel = [_rel_l2(a, r) for a, r in zip(grads, grads_ref)]
    err = [(a.float() - r).abs().max().item() for a, r in zip(grads, grads_ref)]
    print(f"case {name}: B={b} S={s} H={h} KH={kh} D={d} causal={causal} "
          f"segments={seg is not None} window={window} sinks={sinks}"
          + (f" softcap={softcap}" if softcap is not None else "")
          + (f" scale={scale}" if scale is not None else "")
          + (f" q_scale={q_scale}" if q_scale != 1 else "") + ": "
          f"O max abs {err_o:.3e} (tol {TOL_O}), lse max abs {err_lse:.3e} (tol {TOL_LSE}), "
          f"grad rel L2 dq (flash_dq) {rel[0]:.3e}, dk {rel[1]:.3e} dv {rel[2]:.3e} "
          f"(flash_dkv)" + (f", dsinks {rel[3]:.3e} (lse, delta)" if sinks else "")
          + f" (tol {TOL_GRAD})", flush=True)
    if not (err_o <= TOL_O and err_lse <= TOL_LSE and max(rel) <= TOL_GRAD):
        raise AssertionError(f"case {name}: kernels disagree with the plain version")
    del o_ref, lse_ref, grads_ref
    torch.cuda.empty_cache()
    return err_o, err[0], max(err[1:3])


def _reference_by_kv_groups(torch, fa, q, k, v, do, sink, opts, max_bytes=1 << 32):
    """The plain version's O, lse and gradients (dq, dk, dv[, dsinks]) from the same bf16
    inputs in f32, over consecutive groups of KV heads, each with its own query heads
    (query head i reads KV head i // (H / KH)), so that a group's f32 (B, heads, Sq, Skv)
    scores stay within ``max_bytes``; the groups' outputs and gradients depend on their
    own heads alone, and are joined along the heads. One group where the whole fits."""
    b, s, h, _ = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    n = max(1, min(kh, max_bytes // (b * g * s * skv * 4)))
    outs, lses, grads = [], [], []
    for j in range(0, kh, n):
        heads, kv = slice(j * g, min(j + n, kh) * g), slice(j, min(j + n, kh))
        qr, kr, vr = (x[:, :, sl].float().requires_grad_() for x, sl in
                      ((q, heads), (k, kv), (v, kv)))
        sr = [] if sink is None else [sink[heads].clone().requires_grad_()]
        o, lse = fa.flash_attention_reference(qr, kr, vr, sinks=sr[0] if sr else None, **opts)
        grads.append(torch.autograd.grad(o, (qr, kr, vr, *sr), do[:, :, heads].float()))
        outs.append(o.detach())
        lses.append(lse.detach().reshape(b, -1, s))
        del o, lse, qr, kr, vr, sr
    joined = [torch.cat(x, dim=0 if i == 3 else 2) for i, x in enumerate(zip(*grads))]
    return torch.cat(outs, dim=2), torch.cat(lses, dim=1).reshape(b * h, s), joined


def _packed_segments(torch):
    """(2, 4096) segment ids as main path 3 packs them: 1000-token documents (the mock
    samples after the next-token shift), four a row, then 96 pad tokens (segment 0)."""
    from automodel_tpu_torch.data.llm.mock import MockSFTDataset
    from automodel_tpu_torch.data.llm.packed import pack_dataset, packed_collate

    packs = pack_dataset(MockSFTDataset(128256, 1000, num_samples=8, seed=0), 4096,
                         max_packs=2)
    seg = packed_collate([packs[0], packs[1]])["segment_ids"]
    return torch.from_numpy(seg).to(device="cuda", dtype=torch.int32)


def _inner_segments(torch):
    """(2, 2048) segment ids whose boundaries fall inside 64- and 128-row tiles, with a
    one-token segment and a padded tail (segment 0)."""
    seg = torch.zeros(2, 2048, dtype=torch.int32)
    for row, cuts in enumerate(((0, 37, 100, 101, 333, 1000, 1777, 2000),
                                (0, 65, 191, 700, 1203, 1300, 2048))):
        for i, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
            seg[row, a:b] = i + 1
    return seg.cuda()


def _right_padded(torch, b, s, seed=0):
    """(b, s) int32 segment ids of a right-padded batch, as retrieval_collate and
    seq_cls_collate lay one out: 1 on each row's tokens, 0 on its padding; the first row
    full, the second one token long, the others of random lengths from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(1, s + 1, (b,), generator=g)
    lengths[0], lengths[min(1, b - 1)] = s, 1 if b > 1 else s
    seg = (torch.arange(s)[None, :] < lengths[:, None]).to(torch.int32)
    return seg.cuda()


def _flash_phase(torch, fa, errs):
    """flash_fwd and flash_dq / flash_dkv cases a-y against the plain version (see the
    module docstring); the largest errors go into ``errs``."""
    names = ("flash_fwd", "flash_dq", "flash_dkv")
    errs.update(dict.fromkeys(names, 0.0))

    def note(e):
        for name, x in zip(names, e):
            errs[name] = max(errs[name], x)

    note(_kernel_case(torch, fa, "a", 4, 2048, 32, 8, causal=True))
    seg = torch.zeros(2, 2048, dtype=torch.int32, device="cuda")
    seg[0, :1000], seg[0, 1000:1900] = 1, 2
    seg[1, :700], seg[1, 700:2000] = 1, 2
    note(_kernel_case(torch, fa, "b", 2, 2048, 32, 8, causal=True, seg=seg))
    note(_kernel_case(torch, fa, "c", 2, 2048, 32, 8, causal=False))
    note(_kernel_case(torch, fa, "d", 1, 16384, 4, 2, causal=True))
    note(_kernel_case(torch, fa, "e", 2, 4096, 32, 8, causal=True, seg=_packed_segments(torch)))
    # head_dim 128: the Qwen3-MoE slice's shape, and main path 6's packed rows of 2048
    note(_kernel_case(torch, fa, "f", 4, 2048, 32, 4, causal=True, d=128))
    note(_kernel_case(torch, fa, "g", 2, 4096, 32, 4, causal=True, seg=_packed_segments(torch),
                      d=128))
    # the edges of the tiles: a length that is no multiple of 64 or 128, segment
    # boundaries inside a tile without the causal mask, and a grid smaller than the card
    note(_kernel_case(torch, fa, "h", 2, 1000, 32, 8, causal=True))
    note(_kernel_case(torch, fa, "h", 2, 1000, 32, 8, causal=True, d=128))
    note(_kernel_case(torch, fa, "i", 2, 2048, 8, 8, causal=False, seg=_inner_segments(torch),
                      d=128))
    note(_kernel_case(torch, fa, "j", 1, 4096, 4, 1, causal=True, d=128))
    # sliding windows and sinks (GPT-OSS: window 128, sinks, GQA 64 / 8 heads at D=64):
    # k-l windows of 128 and 100 (no multiple of a tile), m sinks alone, n sinks and a
    # window at D=128, o window, sinks and segments whose boundaries fall inside tiles
    # (the window crosses them), p a window of 1 on a ragged length, q a window longer
    # than S, r a window without the causal mask
    note(_kernel_case(torch, fa, "k", 2, 2048, 16, 2, causal=True, window=128))
    note(_kernel_case(torch, fa, "l", 2, 2048, 16, 2, causal=True, window=100, d=128))
    note(_kernel_case(torch, fa, "m", 2, 2048, 16, 2, causal=True, sinks=True))
    note(_kernel_case(torch, fa, "n", 2, 2048, 16, 4, causal=True, window=128, sinks=True,
                      d=128))
    inner = _inner_segments(torch)
    note(_kernel_case(torch, fa, "o", 2, 2048, 16, 2, causal=True, seg=inner, window=100,
                      sinks=True))
    note(_kernel_case(torch, fa, "o", 2, 2048, 16, 2, causal=True, seg=inner, window=100,
                      sinks=True, d=128))
    note(_kernel_case(torch, fa, "p", 2, 1000, 8, 2, causal=True, window=1, sinks=True))
    note(_kernel_case(torch, fa, "q", 2, 2048, 8, 2, causal=True, window=4096, d=128))
    note(_kernel_case(torch, fa, "r", 2, 2048, 8, 2, causal=False, window=300))
    # head_dim 96 (Phi-3; the 128-wide kernels, their columns past 96 read as zeros): s
    # Phi-3-mini's heads, causal, t GQA with segment boundaries inside tiles, u window
    # 100, v Phi-3's window 2047 at S=2048, w sinks, window 100 and segments, x S=1000 (no
    # multiple of a tile), y non-causal with main path 3's packed segments
    note(_kernel_case(torch, fa, "s", 2, 2048, 32, 32, causal=True, d=96))
    note(_kernel_case(torch, fa, "t", 2, 2048, 8, 2, causal=True, seg=inner, d=96))
    note(_kernel_case(torch, fa, "u", 2, 2048, 8, 2, causal=True, window=100, d=96))
    note(_kernel_case(torch, fa, "v", 2, 2048, 32, 32, causal=True, window=2047, d=96))
    note(_kernel_case(torch, fa, "w", 2, 2048, 8, 2, causal=True, seg=inner, window=100,
                      sinks=True, d=96))
    note(_kernel_case(torch, fa, "x", 2, 1000, 8, 2, causal=True, d=96))
    note(_kernel_case(torch, fa, "y", 2, 4096, 8, 2, causal=False, seg=_packed_segments(torch),
                      d=96))
    # the logit soft-cap (Gemma-2's c = 50 at its scale 144^-0.5, and c = 2 at scale 1,
    # where the scores ~ N(0, D) put most of tanh's arguments past its knee): ca D=64
    # causal, cb Gemma-2-27B's heads with its window, cc D=96 packed, cd-cf the saturating
    # cap at D=64 windowed and packed, D=128 with segment boundaries inside tiles and
    # non-causal, D=96 causal, cg sinks with the cap and a window, ch the same at the
    # saturating cap (the sinks ~ N(0, 2^2) beside logits within +-2), ci cb's heads with
    # q ~ N(0, 16^2): tanh's arguments ~ N(0, 0.3^2) at c = 50, so the cap moves the
    # logits by up to several units
    gemma = GEMMA2_27B["query_pre_attn_scalar"]**-0.5
    note(_kernel_case(torch, fa, "ca", 2, 2048, 16, 2, causal=True, softcap=50.0))
    note(_kernel_case(torch, fa, "cb", 2, 2048, 32, 16, causal=True, d=128, window=1024,
                      softcap=50.0, scale=gemma))
    note(_kernel_case(torch, fa, "cc", 2, 4096, 8, 2, causal=True, seg=_packed_segments(torch),
                      d=96, softcap=50.0))
    note(_kernel_case(torch, fa, "cd", 2, 4096, 8, 2, causal=True, seg=_packed_segments(torch),
                      window=300, softcap=2.0, scale=1.0))
    note(_kernel_case(torch, fa, "ce", 2, 2048, 8, 2, causal=False, seg=inner, d=128,
                      softcap=2.0, scale=1.0))
    note(_kernel_case(torch, fa, "cf", 2, 2048, 8, 2, causal=True, d=96, softcap=2.0, scale=1.0))
    note(_kernel_case(torch, fa, "cg", 2, 2048, 16, 4, causal=True, d=128, window=128,
                      sinks=True, softcap=50.0, scale=gemma))
    note(_kernel_case(torch, fa, "ch", 2, 2048, 16, 4, causal=True, d=128, window=128,
                      sinks=True, softcap=2.0, scale=1.0))
    note(_kernel_case(torch, fa, "ci", 2, 2048, 32, 16, causal=True, d=128, window=1024,
                      softcap=50.0, scale=gemma, q_scale=16))
    # head_dim 256 (Gemma-2-9B, Gemma-3; tiles of their own): da Gemma-2-9B's heads at its
    # scale 256^-0.5, db with its cap c = 50, dc Gemma-3-4B's heads with its window 1024, dd
    # S=1000, de non-causal with segment boundaries inside tiles at the saturating cap, df
    # sinks, window 100 and those segments (GQA 16 / 4), dg main path 3's packed rows of
    # 4096 with a window, de's cap, dh da's heads with q ~ N(0, 16^2) and the cap, which bites
    d256 = 256**-0.5
    note(_kernel_case(torch, fa, "da", 2, 2048, 16, 8, causal=True, d=256, scale=d256))
    note(_kernel_case(torch, fa, "db", 2, 2048, 16, 8, causal=True, d=256, softcap=50.0,
                      scale=d256))
    note(_kernel_case(torch, fa, "dc", 2, 2048, 8, 4, causal=True, d=256, window=1024,
                      scale=d256))
    note(_kernel_case(torch, fa, "dd", 2, 1000, 8, 2, causal=True, d=256))
    note(_kernel_case(torch, fa, "de", 2, 2048, 8, 8, causal=False, seg=inner, d=256,
                      softcap=2.0, scale=1.0))
    note(_kernel_case(torch, fa, "df", 2, 2048, 16, 4, causal=True, seg=inner, d=256,
                      window=100, sinks=True))
    note(_kernel_case(torch, fa, "dg", 2, 4096, 8, 4, causal=True, seg=_packed_segments(torch),
                      d=256, window=1024, softcap=2.0, scale=1.0))
    note(_kernel_case(torch, fa, "dh", 2, 2048, 16, 8, causal=True, d=256, softcap=50.0,
                      scale=d256, q_scale=16))
    # the lineage slice, each at its main path's heads: ea (a)'s shape at Granite's softmax
    # scale 1/64 (not D^-0.5) without a cap, q ~ N(0, 4^2) so that the scale shapes the
    # softmax; eb Command R7B's window 4096 over rows of 8192 (main path 30's sliding
    # layers); ec GLM-4-9B's 32 heads over 2 (16 query heads a KV head); ed OLMo-2-7B's
    # causal MHA; ee SmolLM3-3B's 16 over 4 (the StarCoder2 proxy's too); ef Mixtral's 32
    # over 8, each causal at D=128 over main path 31-32's micro-batch of 4 x 2048
    note(_kernel_case(torch, fa, "ea", 4, 2048, 32, 8, causal=True,
                      scale=GRANITE_33_2B["attention_multiplier"], q_scale=4))
    note(_kernel_case(torch, fa, "eb", 1, COMMAND_R7B_SEQ, COMMAND_R7B["num_attention_heads"],
                      COMMAND_R7B["num_key_value_heads"], causal=True, d=128,
                      window=COMMAND_R7B["sliding_window"]))
    for name, model in (("ec", GLM4_9B), ("ed", OLMO2_7B), ("ee", SMOLLM3_3B),
                        ("ef", MIXTRAL_8X7B)):
        note(_kernel_case(torch, fa, name, 4, 2048, model["num_attention_heads"],
                          model["num_key_value_heads"], causal=True, d=128))
    # the classifier and encoder slice: ga / gb the biencoder's towers (main paths 35-36),
    # non-causal over right-padded rows of 64 (one q tile, padding inside it) and 256 at
    # Llama-3.2-1B's 32 heads over 8; gc GPT-2's causal MHA, 12 heads over 12, rows of
    # 1024 (main path 37)
    for name, b, length in (("ga", 8, 64), ("gb", 4, 256)):
        note(_kernel_case(torch, fa, name, b, length, 32, 8, causal=False,
                          seg=_right_padded(torch, b, length)))
    note(_kernel_case(torch, fa, "gc", 2, 1024, 12, 12, causal=True))
    # the MoE-family and hybrid slice: ha STEP35_FLASH's sliding layers (96 heads over 8
    # at D=128, window 512) over main path 40's packed rows of 4096; hb Qwen3-Next's gated
    # full attention (16 heads over 2 at D=256) over main path 41's micro-batch of 4 x 2048
    note(_kernel_case(torch, fa, "ha", 2, 4096, 96, 8, causal=True, d=128, window=512,
                      seg=_packed_segments(torch)))
    note(_kernel_case(torch, fa, "hb", 4, 2048, 16, 2, causal=True, d=256))


def _refused_on_the_card(torch, fa):
    """What the flash kernels do not take raises NotImplementedError on the card and
    launches nothing in its place: head_dim 80, with and without Gemma-2's soft-cap."""
    before = dict(fa.LAUNCHES)
    for d, kw in ((80, {}), (80, {"logit_soft_cap": 50.0})):
        q = torch.zeros(1, 128, 2, d, dtype=torch.bfloat16, device="cuda")
        try:
            fa.flash_attention(q, q, q, **kw)
        except NotImplementedError as exc:
            print(f"refused on the card: head_dim {d} {kw or ''}: {exc}", flush=True)
        else:
            raise AssertionError(f"flash_attention at head_dim {d} {kw} did not raise")
    if fa.LAUNCHES != before:
        raise AssertionError("a refused flash call launched a kernel")


def _time_ms(torch, fn, warmup=2, reps=10, batch=1) -> float:
    """Median of ``reps`` CUDA-event timings of one call, after ``warmup`` calls; with
    ``batch`` > 1 each timing spans that many calls back to back and is divided by it,
    so the host's launch work of a short kernel overlaps the previous call's device time
    instead of adding to it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return sorted(times)[len(times) // 2]


def _library_sdpa(torch, q, k, v, causal, mask=None, scale=None):
    """The yardstick: PyTorch's own attention call, timed here and used nowhere in the port.
    ``mask``: a boolean (Sq, Skv) or (B, 1, Sq, Skv) mask in place of the causal flag (the
    sliding window's and a padded batch's yardstick), with k and v repeated to q's heads beforehand by the caller (a masked call
    takes no GQA in its memory-efficient kernel); ``scale``: the softmax scale (None:
    head_dim^-0.5)."""
    import torch.nn.functional as F

    if mask is not None:
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), attn_mask=mask,
                                              scale=scale).transpose(1, 2)
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), is_causal=causal,
                                          enable_gqa=True, scale=scale).transpose(1, 2)


def _library_flex(torch, s, cap, scale, window=None):
    """The capped yardstick: FlexAttention, one PyTorch call computing c tanh(s scale / c)
    (its ``score_mod``) before a causal (and with ``window``, sliding) block mask, wrapped
    once in ``torch.compile``; a function of (q, k, v) laid out as (B, S, heads, D), with
    k and v at their own heads. Timed here and used nowhere in the port."""
    import torch._inductor.config as inductor_config
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    inductor_config.compile_threads = 1  # no pool of compile workers left behind

    def softcap(score, b, h, i, j):
        return cap * torch.tanh(score / cap)

    def causal(b, h, i, j):
        return (i >= j) if window is None else (i >= j) & (i - j < window)

    mask = create_block_mask(causal, None, None, s, s, device="cuda")
    flex = torch.compile(flex_attention)
    return lambda q, k, v: flex(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                score_mod=softcap, block_mask=mask, scale=scale,
                                enable_gqa=True).transpose(1, 2)


def _flash_timing_inputs(torch, b, s, h, kh, d, device="cuda"):
    """The tensors a flash timing row times, (q, k, v, dO) at head dim ``d``, and the
    work they hold (:func:`_flash_work`)."""
    q, k, v, do = _inputs(torch, b, s, h, kh, d, seed=1, device=device)
    return (q, k, v, do), _flash_work(q, k, v)


def _timings(torch, fa, b=4, s=2048, h=32, kh=8, d=64, window=None, softcap=None, scale=None,
             causal=True, seg=None):
    """ms of each kernel at shape (a), or at the shape (and sliding ``window``, logit
    ``softcap`` and softmax ``scale``: d^-0.5 by default) given, with bound, plain version
    and SDPA (with a window: SDPA over the window as a boolean mask; with a cap:
    FlexAttention with the cap, :func:`_library_flex`, its output held against
    flash_fwd's, and SDPA without the cap kept apart as sdpa_uncapped_ms), and of the
    whole backward as the wrapper runs it ("flash_backward": delta, flash_dq and
    flash_dkv) beside SDPA's (or FlexAttention's) backward. The work behind the bound is
    read from the timed tensors (and the pairs the window allows): the products only, as
    without the cap (its tanh runs on other units than the tensor cores). ``causal``
    False and ``seg`` (int32 (B, S) segment ids, a right-padded batch's: 0 on the pads)
    time the masks of an encoder's batch; the bound then counts the pairs the ids allow
    (:func:`_segment_pairs`) and SDPA takes the same mask as a boolean one."""
    (q, k, v, do), _ = _flash_timing_inputs(torch, b, s, h, kh, d)
    pairs = None if seg is None and causal else _segment_pairs(
        torch.ones(b, s) if seg is None else seg, causal)
    work = _flash_work(q, k, v, window, pairs)
    scale = q.shape[-1]**-0.5 if scale is None else scale
    cap = softcap or 0.0
    plain_kw = dict(sliding_window=window, logit_soft_cap=softcap, softmax_scale=scale,
                    segment_ids_q=seg)
    out = {}

    o, lse = fa.flash_fwd(q, k, v, seg, seg, scale, causal, window, None, cap)
    delta = fa._delta(o, do)
    fwd_ms = _time_ms(torch, lambda: fa.flash_fwd(q, k, v, seg, seg, scale, causal, window, None,
                                                  cap))
    dq_ms = _time_ms(torch, lambda: fa.flash_dq(q, k, v, seg, seg, do, lse, delta, scale, causal,
                                                window, cap))
    dkv_ms = _time_ms(torch, lambda: fa.flash_dkv(q, k, v, seg, seg, do, lse, delta, scale,
                                                  causal, window, cap))
    bwd_ms = _time_ms(torch, lambda: fa.flash_backward(q, k, v, seg, seg, o, lse, do, scale,
                                                       causal, window, cap))
    delta_ms = _time_ms(torch, lambda: fa._delta(o, do))
    plain_dq = _time_ms(torch, lambda: fa.flash_dq_reference(q, k, v, do, lse, delta,
                                                             causal=causal, **plain_kw),
                        warmup=1, reps=2)
    plain_dkv = _time_ms(torch, lambda: fa.flash_dkv_reference(q, k, v, do, lse, delta,
                                                               causal=causal, **plain_kw),
                         warmup=1, reps=2)
    plain_fwd = _time_ms(torch, lambda: fa.flash_attention_reference(q, k, v, causal=causal,
                                                                     **plain_kw),
                         warmup=1, reps=3)
    qp, kp, vp = (x.clone().requires_grad_() for x in (q, k, v))
    o_plain, _ = fa.flash_attention_reference(qp, kp, vp, causal=causal, **plain_kw)
    plain_bwd = _time_ms(torch, lambda: torch.autograd.grad(o_plain, (qp, kp, vp), do,
                                                            retain_graph=True),
                         warmup=1, reps=3)
    del o_plain
    flex = {}
    if softcap:  # FlexAttention computes the capped function: the yardstick
        flex_fn = _library_flex(torch, s, softcap, scale, window)
        flex["diff"] = (flex_fn(q, k, v).float() - o.float()).abs().max().item()
        if not flex["diff"] <= TOL_O:
            raise AssertionError(f"FlexAttention with the cap disagrees with flash_fwd: "
                                 f"{flex['diff']:.3e}")
        flex["fwd"] = _time_ms(torch, lambda: flex_fn(q, k, v))
        ql, kl, vl = (x.clone().requires_grad_() for x in (q, k, v))
        o_lib = flex_fn(ql, kl, vl)
        flex["bwd"] = _time_ms(torch, lambda: torch.autograd.grad(o_lib, (ql, kl, vl), do,
                                                                  retain_graph=True))
        del o_lib, ql, kl, vl, flex_fn
    mask = None
    if window is not None or seg is not None:  # SDPA's masked kernels take no GQA: k, v
        idx = torch.arange(s, device="cuda")  # at q's heads
        mask = (idx[:, None] >= idx[None, :]) if causal else torch.ones(
            s, s, dtype=torch.bool, device="cuda")
        if window is not None:
            mask = mask & (idx[:, None] - idx[None, :] < window)
        if seg is not None:  # (B, 1, S, S): each row's own segments
            mask = mask & (seg[:, None, :, None] == seg[:, None, None, :])
        k, v = k.repeat_interleave(h // kh, 2), v.repeat_interleave(h // kh, 2)
    lib_fwd = _time_ms(torch, lambda: _library_sdpa(torch, q, k, v, causal, mask, scale))
    ql, kl, vl = (x.clone().requires_grad_() for x in (q, k, v))
    o_lib = _library_sdpa(torch, ql, kl, vl, causal, mask, scale)
    lib_bwd = _time_ms(torch, lambda: torch.autograd.grad(o_lib, (ql, kl, vl), do,
                                                          retain_graph=True))
    del o_lib, delta, mask
    torch.cuda.empty_cache()
    shown = f"B={b} S={s} H={h} KH={kh} D={q.shape[-1]} " + (
        "causal" if causal else "non-causal") + (
        f", right-padded ({pairs} allowed pairs a head)" if seg is not None else "") + (
        f", window {window}" if window is not None else "") + (
        f", softcap {softcap}, scale {scale:.6g}" if softcap else "")
    for name, ms, plain, lib in (("flash_fwd", fwd_ms, plain_fwd, lib_fwd),
                                 ("flash_dq", dq_ms, plain_dq, None),
                                 ("flash_dkv", dkv_ms, plain_dkv, None),
                                 ("flash_backward", bwd_ms, plain_bwd, lib_bwd)):
        flops, nbytes = work[name]
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "shape": {"B": b, "S": s, "H": h, "KH": kh, "D": q.shape[-1],
                               **({} if causal else {"causal": False}),
                               **({"allowed_pairs": pairs} if seg is not None else {}),
                               **({"window": window} if window is not None else {}),
                               **({"softcap": softcap, "scale": scale} if softcap else {})}}
        if name == "flash_backward":
            out[name]["delta_ms"] = delta_ms
        if lib is None:  # SDPA's backward gives dq, dk and dv together: a comparison only
            out[name]["library"] = "no single PyTorch call computes this part of the backward"
            out[name]["sdpa_bwd_ms"] = lib_bwd
        if softcap:  # FlexAttention with the cap; SDPA without it (not the same function)
            out[name]["sdpa_uncapped_ms"] = lib_fwd if name == "flash_fwd" else lib_bwd
            out[name]["library_max_abs_diff"] = flex["diff"]
            if lib is None:  # a part of the backward: FlexAttention's whole one beside it
                del out[name]["sdpa_bwd_ms"]
                out[name]["flex_bwd_ms"] = flex["bwd"]
            else:
                out[name]["library"] = "FlexAttention, tanh score_mod, compiled"
                out[name]["library_ms"] = flex["fwd" if name == "flash_fwd" else "bwd"]
        label = ("the backward (delta, flash_dq, flash_dkv)" if name == "flash_backward"
                 else name)
        print(f"time {label} at {shown}: {ms:.3f} ms, bound {out[name]['bound_ms']:.3f} ms "
              f"({out[name]['bound_by']}: {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), "
              f"plain {plain:.3f} ms, "
              + ((f"FlexAttention with the cap {flex['fwd']:.3f} ms" if name == "flash_fwd"
                  else f"FlexAttention's backward {flex['bwd']:.3f} ms")
                 + f" (O max abs diff to flash_fwd {flex['diff']:.3e}), "
                 "SDPA without the cap (not the same function) " if softcap else "")
              + (f"SDPA {lib_fwd:.3f} ms" if name == "flash_fwd" else
                 f"SDPA backward {lib_bwd:.3f} ms")
              + (f", of it delta {delta_ms:.3f} ms" if name == "flash_backward" else ""),
              flush=True)
    return out


BATCH_AT_GPT_OSS = 10


def _window_timings(torch, fa, b=1, s=8192, h=64, kh=8, d=64, window=128):
    """flash_fwd, flash_dq, flash_dkv and the whole backward at GPT-OSS's attention
    shape (B=1, S=8192, H=64, KH=8, D=64): causal, causal with the window, and causal
    with the window and sinks. The bound counts the allowed pairs only. Yardsticks: SDPA
    (causal; the window as a boolean mask); none for sinks (null). The plain version's
    (B, H, S, S) f32 scores take 17 GB a tensor at this shape: where the card cannot
    hold them the row keeps null and the reason. Kernels and yardsticks are timed
    ``BATCH_AT_GPT_OSS`` calls back to back a timing (a windowed call is short enough for
    the host's launch work to show otherwise). Fails unless the windowed forward and the
    windowed backward each take under a quarter of the causal ones' time (the window
    allows ~1/32 of the causal pairs)."""
    (q, k, v, do), _ = _flash_timing_inputs(torch, b, s, h, kh, d)
    g = torch.Generator(device="cuda").manual_seed(5)
    sinks = torch.randn(h, device="cuda", generator=g) * 2.0
    scale = d**-0.5
    rep = h // kh
    kx, vx = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
    idx = torch.arange(s, device="cuda")
    band = (idx[:, None] >= idx[None, :]) & (idx[:, None] - idx[None, :] < window)
    out = {}
    for case, win, snk in (("causal", None, None), ("window", window, None),
                           ("window_sinks", window, sinks)):
        work = _flash_work(q, k, v, win)
        o, lse = fa.flash_fwd(q, k, v, None, None, scale, True, win, snk)
        delta = fa._delta(o, do)
        n = BATCH_AT_GPT_OSS
        times = {
            "flash_fwd": _time_ms(torch, lambda: fa.flash_fwd(q, k, v, None, None, scale, True,
                                                              win, snk), batch=n),
            "flash_dq": _time_ms(torch, lambda: fa.flash_dq(q, k, v, None, None, do, lse, delta,
                                                            scale, True, win), batch=n),
            "flash_dkv": _time_ms(torch, lambda: fa.flash_dkv(q, k, v, None, None, do, lse,
                                                              delta, scale, True, win), batch=n),
            "flash_backward": _time_ms(torch, lambda: (fa.flash_backward(
                q, k, v, None, None, o, lse, do, scale, True, win),
                None if snk is None else fa.sink_grad(snk, lse, delta)), batch=n)}
        lib = {"flash_fwd": None, "flash_backward": None}
        if snk is None:
            ql, kl, vl = (x.clone().requires_grad_() for x in ((q, k, v) if win is None
                                                               else (q, kx, vx)))
            call = ((lambda: _library_sdpa(torch, ql, kl, vl, True)) if win is None else
                    (lambda: _library_sdpa(torch, ql, kl, vl, True, mask=band)))
            lib["flash_fwd"] = _time_ms(torch, call, batch=n)
            o_lib = call()
            lib["flash_backward"] = _time_ms(torch, lambda: torch.autograd.grad(
                o_lib, (ql, kl, vl), do, retain_graph=True), batch=n)
            del o_lib, ql, kl, vl
        plain, note = None, None
        try:
            plain = _time_ms(torch, lambda: fa.flash_attention_reference(
                q, k, v, causal=True, sliding_window=win, sinks=snk), warmup=1, reps=2)
        except torch.cuda.OutOfMemoryError as exc:
            note = f"not timed: {str(exc).splitlines()[0][:160]}"
        torch.cuda.empty_cache()
        shown = f"B={b} S={s} H={h} KH={kh} D={d} causal, window {win}, sinks {snk is not None}"
        for name, ms in times.items():
            flops, nbytes = work[name]
            t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            row = {"ms": ms, "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "plain_ms": plain if name == "flash_fwd" else None,
                   "library_ms": lib.get(name),
                   "shape": {"B": b, "S": s, "H": h, "KH": kh, "D": d, "window": win,
                             "sinks": snk is not None}, "calls_a_timing": n}
            if name == "flash_fwd" and note:
                row["plain_note"] = note
            if snk is not None:
                row["library"] = "no single PyTorch call computes attention with sinks"
            elif name not in lib:
                row["library"] = "no single PyTorch call computes this part of the backward"
            out.setdefault(name, {})[case] = row
            print(f"time {name} at {shown}: {ms:.3f} ms, bound {row['bound_ms']:.3f} ms "
                  f"({row['bound_by']}: {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), "
                  f"plain {row['plain_ms']}, library {row['library_ms']}", flush=True)
        del o, lse, delta
        torch.cuda.empty_cache()
    for name in ("flash_fwd", "flash_backward"):
        share = out[name]["window"]["ms"] / out[name]["causal"]["ms"]
        print(f"{name} at GPT-OSS's shape: window 128 takes {share:.4f} of the causal time "
              f"(allowed pairs {_allowed_pairs(s, window) / _allowed_pairs(s):.4f})", flush=True)
        if share >= 0.25:
            raise AssertionError(f"{name}: the windowed run takes {share:.3f} of the causal "
                                 "one's time: tiles behind the window are not skipped")
    del q, k, v, do, kx, vx, band
    torch.cuda.empty_cache()
    return out


def _ring_layout(torch, b, cp, s_loc, h, kh, d, seed, seg=None, positions=None,
                 device="cuda", dv=None):
    """Row-form inputs of one folded ring from global (B, S, H, D) bf16 tensors: q
    (B*cp*H, S_loc, D), k (B*cp*KH, S_loc, D), v (B*cp*KH, S_loc, Dv), dO (B*cp*H, S_loc,
    Dv) (Dv: ``dv``, default D), positions / segments (B*cp, S_loc)."""
    g = torch.Generator(device=device).manual_seed(seed)
    s = cp * s_loc
    dv = d if dv is None else dv
    q, k, v, do = (torch.randn(b, s, n, w, device=device, generator=g).to(torch.bfloat16)
                   for n, w in ((h, d), (kh, d), (kh, dv), (h, dv)))
    if positions is None:
        positions = torch.arange(s, device=device, dtype=torch.int32).expand(b, s)

    def rows(x):
        w = x.shape[-1]
        x = x.reshape(b * cp, s_loc, x.shape[2], w)
        return x.transpose(1, 2).reshape(-1, s_loc, w).contiguous()

    def ids(x):
        return None if x is None else x.reshape(b * cp, s_loc).to(torch.int32).contiguous()

    return [rows(x) for x in (q, k, v, do)] + [ids(positions), ids(seg)]


def _plain_chunk_fwd(q, k, v, pq, pkv, sq, skv, acc, m, l, **kw):
    from automodel_tpu_torch.ops import ring_chunk as rc

    for dst, src in zip((acc, m, l), rc.chunk_attention_fwd_reference(
            q, k, v, pq, pkv, sq, skv, acc, m, l, **kw)):
        dst.copy_(src)


def _plain_chunk_bwd(q, k, v, pq, pkv, sq, skv, do, lse, delta, dq, dk, dv, **kw):
    from automodel_tpu_torch.ops import ring_chunk as rc

    for dst, src in zip((dq, dk, dv), rc.chunk_attention_bwd_reference(
            q, k, v, pq, pkv, sq, skv, do, lse, delta, **kw)):
        dst.add_(src)


def _counted_tiles(torch, label, launch, cls, heads):
    """One more launch, given a tile-count buffer: the (q tile, kv tile) pairs the kernel
    skipped, left partial and ran full must equal tile_classes' ``cls`` times ``heads``
    (the kernel counts over every head its grid holds)."""
    from automodel_tpu_torch.ops import ring_chunk as rc

    expected = [int((cls == c).sum()) * heads for c in (rc.SKIP, rc.PARTIAL, rc.FULL)]
    counts = torch.zeros(3, dtype=torch.int32, device="cuda")
    launch(tile_counts=counts)
    tiles = dict(zip(("skip", "partial", "full"), counts.tolist()))
    print(f"tiles of {label}: {tiles} counted by the kernel, "
          f"{dict(zip(tiles, expected))} expected by tile_classes", flush=True)
    if list(tiles.values()) != expected:
        raise AssertionError(f"{label}: the kernel's tile classes disagree with tile_classes")
    return tiles


def _ring_case_tiles(torch, name, q, k, v, do, pos, sid, kw):
    """The tiles ring_fwd, ring_bwd (at Dv == D) and ring_dkv count at the case's diagonal
    ring step (each shard's q against its own kv), on scratch carries and accumulators,
    held against tile_classes; the backward's q tiles are ``bwd_block_q(D, Dv)`` rows."""
    from automodel_tpu_torch.ops import ring_chunk as rc

    f32 = dict(dtype=torch.float32, device="cuda")
    rows = q.shape[:2]
    bq = rc.bwd_block_q(q.shape[-1], v.shape[-1])
    cls = {b: rc.tile_classes(pos, pos, sid, sid, kw["causal"], kw["window"], b, 128)
           for b in (128, bq)}
    _counted_tiles(torch, f"ring_fwd in ring case {name}", lambda **c: rc.ring_fwd(
        q, k, v, pos, pos, sid, sid, torch.zeros((*rows, v.shape[-1]), **f32),
        torch.full(rows, -1e30, **f32), torch.zeros(rows, **f32), **kw, **c), cls[128],
        kw["n_heads"])
    if q.shape[-1] == v.shape[-1]:
        _counted_tiles(torch, f"ring_bwd in ring case {name}", lambda **c: rc.ring_bwd(
            q, k, v, pos, pos, sid, sid, do, torch.zeros(rows, **f32), torch.zeros(rows, **f32),
            torch.zeros(q.shape, **f32), torch.zeros(k.shape, **f32),
            torch.zeros(v.shape, **f32), **kw, **c), cls[bq], kw["n_heads"] // kw["groups"])
    _counted_tiles(torch, f"ring_dkv in ring case {name}", lambda **c: rc.ring_dkv(
        q, k, v, pos, pos, sid, sid, do, torch.zeros(rows, **f32), torch.zeros(rows, **f32),
        torch.zeros(k.shape, **f32), torch.zeros(v.shape, **f32), **kw, **c), cls[bq],
        kw["n_heads"] // kw["groups"])


def _ring_case(torch, name, cp, b, s_loc, h, kh, d=128, causal=True, window=None, seg=None,
               positions=None, dv=None, scale=None):
    """One full folded ring forward and backward through ring_fwd / ring_bwd against the
    same ring through their plain version (f32 from the same bf16 inputs), and the tiles
    the kernels count at the diagonal step against tile_classes. ``dv``: v's width (MLA's
    128 beside D=192; the backward's default route is then ring_dq + ring_dkv too);
    ``scale``: the softmax scale (default D^-0.5)."""
    from automodel_tpu_torch.parallel import ring_attention as ra

    dv = d if dv is None else dv
    q, k, v, do, pos, sid = _ring_layout(torch, b, cp, s_loc, h, kh, d, seed=cp + s_loc + d,
                                         seg=seg, positions=positions, dv=dv)
    rot = ra.FoldedRotation(cp)
    kw = dict(scale=d**-0.5 if scale is None else scale, causal=causal, window=window,
              groups=h // kh, n_heads=h)
    out, lse = ra.ring_flash_forward(q, k, v, pos, pos, sid, sid, rot, kw)
    grads = ra.ring_flash_backward(q, k, v, pos, pos, sid, sid, out, lse, do, rot, kw)
    with _deterministic(torch):  # ring_dq + ring_dkv
        grads_det = ra.ring_flash_backward(q, k, v, pos, pos, sid, sid, out, lse, do, rot, kw)
    torch.cuda.synchronize()
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    out_ref, lse_ref = ra.ring_flash_forward(qf, kf, vf, pos, pos, sid, sid, rot, kw,
                                             chunk_fwd=_plain_chunk_fwd)
    grads_ref = ra.ring_flash_backward(qf, kf, vf, pos, pos, sid, sid, out_ref, lse_ref, dof, rot,
                                       kw, chunk_bwd=_plain_chunk_bwd)
    err_o = (out.float() - out_ref).abs().max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    rel = [_rel_l2(a, r) for a, r in zip(grads, grads_ref)]
    rel_det = [_rel_l2(a, r) for a, r in zip(grads_det, grads_ref)]
    err_grad = max((a.float() - r).abs().max().item() for a, r in zip(grads, grads_ref))
    err_det = [(a.float() - r).abs().max().item() for a, r in zip(grads_det, grads_ref)]
    print(f"ring case {name}: cp={cp} folded, B={b} S_local={s_loc} H={h} KH={kh} D={d} "
          f"Dv={dv} scale={kw['scale']:.6f} "
          f"causal={causal} window={window} segments={seg is not None} "
          f"positions={'given' if positions is not None else 'arange'}: "
          f"O max abs {err_o:.3e} (tol {TOL_O}), lse max abs {err_lse:.3e} (tol {TOL_LSE}), "
          f"grad rel L2 dq {rel[0]:.3e} dk {rel[1]:.3e} dv {rel[2]:.3e}; deterministic route "
          f"(ring_dq, ring_dkv) dq {rel_det[0]:.3e} dk {rel_det[1]:.3e} dv "
          f"{rel_det[2]:.3e} (tol {TOL_GRAD})", flush=True)
    if not (err_o <= TOL_O and err_lse <= TOL_LSE and max(rel + rel_det) <= TOL_GRAD):
        raise AssertionError(f"ring case {name}: kernels disagree with the plain version")
    _ring_case_tiles(torch, name, q, k, v, do, pos, sid, kw)
    del q, k, v, do, out, lse, grads, grads_det, qf, kf, vf, dof, out_ref, lse_ref, grads_ref
    torch.cuda.empty_cache()
    return err_o, err_grad, err_det[0], max(err_det[1:])


def _packed_ring_segments(torch, b, s, seed=0):
    """(B, S) segment ids and positions as pack_dataset lays them out: documents of
    500-3000 tokens, positions restarting at 0 in each, a tail of padding (segment 0,
    position 0)."""
    rng = __import__("random").Random(seed)
    seg = torch.zeros(b, s, dtype=torch.int32)
    pos = torch.zeros(b, s, dtype=torch.int32)
    for row in range(b):
        start, doc = 0, 1
        while True:
            n = rng.randint(500, 3000)
            if start + n > s - 100:
                break
            seg[row, start:start + n] = doc
            pos[row, start:start + n] = torch.arange(n, dtype=torch.int32)
            start, doc = start + n, doc + 1
    return seg.cuda(), pos.cuda()


def _ring_phase(torch, errs):
    """Ring kernel cases a-f against the plain version: (a) the slice's shape (cp 8
    folded, B 1, S_local 4096, H 32, KH 8, D 128, causal); (b) packed segments with
    positions restarting per document; (c) the round-robin layout of
    test_interleaved_positions_load_balance; (d) a sliding window; (e) D 64, KH 2,
    non-causal; (f) a ragged local length (S_local 1000, cp 3)."""
    names = ("ring_fwd", "ring_bwd", "ring_dq", "ring_dkv")
    errs.update(dict.fromkeys(names, 0.0))

    def note(e):
        for name, x in zip(names, e):
            errs[name] = max(errs[name], x)

    note(_ring_case(torch, "a", 8, 1, 4096, 32, 8))
    seg, pos = _packed_ring_segments(torch, 2, 4 * 2048)
    note(_ring_case(torch, "b", 4, 2, 2048, 32, 8, seg=seg, positions=pos))
    s = 4 * 2048
    order = torch.arange(s, dtype=torch.int32).reshape(4, -1).t().reshape(-1)
    note(_ring_case(torch, "c", 4, 1, 2048, 32, 8, positions=order.cuda()[None]))
    note(_ring_case(torch, "d", 4, 1, 2048, 32, 8, window=1024))
    note(_ring_case(torch, "e", 4, 1, 2048, 16, 2, d=64, causal=False))
    note(_ring_case(torch, "f", 3, 1, 1000, 32, 8))


# ring case (a), the attention of main path 7: cp 8 folded, B 1, S_local 4096, H 32, KH 8,
# D 128, causal, contiguous shards
RING_A = dict(cp=8, b=1, s_loc=4096, h=32, kh=8, d=128)


def _ring_step_inputs(torch, step, cp, b, s_loc, h, kh, d, device="cuda", dv=None):
    """The tensors of one ring_fwd / ring_bwd launch at ring step ``step`` of a causal ring
    over contiguous shards (seed 5): q / dO of every shard and the kv bundle rotated
    ``step`` times by FoldedRotation, so shard r holds the k, v and positions of shard
    (r - step) mod cp; with the launch's allowed (q, k) pairs over every head and the
    shards that have any. ``dv``: v's and dO's width (default D)."""
    from automodel_tpu_torch.ops import ring_chunk as rc
    from automodel_tpu_torch.parallel import ring_attention as ra

    q, k, v, do, pos, _ = _ring_layout(torch, b, cp, s_loc, h, kh, d, seed=5, device=device,
                                       dv=dv)
    bundle = (k.view(b * cp, kh, s_loc, d), v.view(b * cp, kh, s_loc, v.shape[-1]), pos)
    rot = ra.FoldedRotation(cp)
    for _ in range(step):
        bundle = rot(bundle)
    per_shard = rc.allowed_mask(pos, bundle[2], None, None, True, None).flatten(1).sum(1)
    return {"q": q, "k": bundle[0].flatten(0, 1).contiguous(),
            "v": bundle[1].flatten(0, 1).contiguous(), "do": do, "pos_q": pos,
            "pos_kv": bundle[2].contiguous(), "pairs": int(per_shard.sum()) * h,
            "live": int((per_shard > 0).sum())}


def _ring_work(x, h, kh, d, dv=None):
    """FLOP and bytes of one ring_fwd / ring_bwd launch on :func:`_ring_step_inputs`'s
    tensors: the allowed pairs' products (Q K^T and dQ / dK at D, P V / dP / dV at Dv:
    2 D or 2 Dv operations a pair each), and each input read once and each output
    written once on the shards with any allowed pair (the carry and the f32
    accumulators are read and written)."""
    dv = d if dv is None else dv
    s_loc, pairs = x["q"].shape[1], x["pairs"]
    qkv = 2 * s_loc * (d * (h + kh) + dv * kh)
    ids = 4 * 2 * s_loc
    carry = 2 * 4 * (h * s_loc * dv + 2 * h * s_loc)
    dk_dv = 2 * 4 * s_loc * kh * (d + dv)
    do = 2 * h * s_loc * dv
    rows = 4 * 2 * h * s_loc  # lse, delta
    dq = 2 * 4 * s_loc * d * h
    return {"ring_fwd": (2 * (d + dv) * pairs, x["live"] * (qkv + ids + carry)),
            "ring_bwd": (2 * (3 * d + 2 * dv) * pairs,
                         x["live"] * (qkv + ids + do + rows + dq + dk_dv)),
            # the deterministic route: dq alone (S, dP, dQ), dk / dv alone (S, dP, dV, dK)
            "ring_dq": (2 * (2 * d + dv) * pairs, x["live"] * (qkv + ids + do + rows + dq)),
            "ring_dkv": (4 * (d + dv) * pairs, x["live"] * (qkv + ids + do + rows + dk_dv))}


def _ring_launches(torch, steps):
    """Per ring step of ``steps`` at RING_A: its inputs and one call each of ring_fwd and
    ring_bwd through the wrappers as every checkout since the kernels were ported has
    them (keywords given to a call go on to the wrapper), on the carry of a fresh ring and the lse / delta of one whole ring forward;
    and that state (``kw``, ``out``, ``lse``, ``delta``, ``acc``, ``m``, ``l``)."""
    from automodel_tpu_torch.ops import ring_chunk as rc
    from automodel_tpu_torch.parallel import ring_attention as ra

    a = RING_A
    kw = dict(scale=a["d"]**-0.5, causal=True, window=None, groups=a["h"] // a["kh"],
              n_heads=a["h"])
    base = _ring_step_inputs(torch, 0, **a)
    q, do, pos = base["q"], base["do"], base["pos_q"]
    out, lse = ra.ring_flash_forward(q, base["k"], base["v"], pos, pos, None, None,
                                     ra.FoldedRotation(a["cp"]), kw)
    delta = (out.float() * do.float()).sum(-1)
    f32 = dict(dtype=torch.float32, device="cuda")
    acc, m, l = (torch.zeros(q.shape, **f32), torch.full(q.shape[:2], -1e30, **f32),
                 torch.zeros(q.shape[:2], **f32))
    dq = torch.zeros(q.shape, **f32)
    dk, dv = (torch.zeros(base["k"].shape, **f32) for _ in range(2))
    calls = {}
    for step in steps:
        x = base if step == 0 else _ring_step_inputs(torch, step, **a)
        k, v, pkv = x["k"], x["v"], x["pos_kv"]
        calls[step] = (x, (lambda k=k, v=v, pkv=pkv, **more: rc.ring_fwd(
                           q, k, v, pos, pkv, None, None, acc, m, l, **kw, **more)),
                       (lambda k=k, v=v, pkv=pkv, **more: rc.ring_bwd(
                           q, k, v, pos, pkv, None, None, do, lse, delta, dq, dk, dv, **kw,
                           **more)))
        if hasattr(rc, "ring_dkv"):  # the deterministic route's two launches
            calls[step] += ((lambda k=k, v=v, pkv=pkv: rc.ring_dq(
                                q, k, v, pos, pkv, None, None, do, lse, delta, dq, **kw)),
                            (lambda k=k, v=v, pkv=pkv, **more: rc.ring_dkv(
                                q, k, v, pos, pkv, None, None, do, lse, delta, dk, dv, **kw,
                                **more)))
    return calls, dict(kw=kw, out=out, lse=lse, delta=delta, acc=acc, m=m, l=l)


def _ring_timings(torch):
    """ms of ring_fwd / ring_bwd a launch at case (a)'s diagonal ring step beside the
    bound and the plain version, and at ring step 1 (every shard's chunk wholly allowed
    or wholly skipped: 7 of 8 allowed) and step cp - 1 (7 of 8 wholly skipped), each
    beside its own bound; a bound counts the allowed (q, k) pairs of its step. At each step
    one more launch of each kernel counts the tiles it skipped, left partial and ran full
    (``tile_counts``), and those counts must equal what tile_classes expects. Then, as a
    comparison, the whole ring (cp launches and the rotations) against the port's
    flash_fwd, flash_dq, flash_dkv, the whole flash backward and SDPA on the unsharded
    sequence."""
    from automodel_tpu_torch.ops import flash_attention as fa, ring_chunk as rc
    from automodel_tpu_torch.parallel import ring_attention as ra

    a = RING_A
    cp, b, s_loc, h, kh, d = (a[n] for n in ("cp", "b", "s_loc", "h", "kh", "d"))
    calls, st = _ring_launches(torch, (0, 1, cp - 1))
    out = {"ring_fwd": {}, "ring_bwd": {}, "ring_dq": {}, "ring_dkv": {}}
    for step, (x, fwd, bwd, dq_fn, dkv_fn) in calls.items():
        work = _ring_work(x, h, kh, d)
        if step < cp - 1:  # ring_dq at the diagonal step and step 1
            ms = _time_ms(torch, dq_fn, warmup=2, reps=10)
            flops, nbytes = work["ring_dq"]
            t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            row = {"ms": ms, "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
            print(f"time ring_dq at ring step {step} of cp={cp} folded B={b} S_local={s_loc} "
                  f"H={h} KH={kh} D={d} causal: {ms:.3f} ms a launch, bound "
                  f"{row['bound_ms']:.3f} ms ({row['bound_by']}: {flops / 1e12:.3f} TFLOP; "
                  f"{nbytes / 1e6:.1f} MB)", flush=True)
            if step == 0:
                out["ring_dq"].update(row)
            else:
                out["ring_dq"].setdefault("steps", {})[str(step)] = row
        timed = [("ring_fwd", fwd, 128, h), ("ring_bwd", bwd, 64, kh)]
        if step < cp - 1:  # ring_dkv at the diagonal step and step 1
            timed.append(("ring_dkv", dkv_fn, 64, kh))
        for name, fn, block_q, heads in timed:
            cls = rc.tile_classes(x["pos_q"], x["pos_kv"], None, None, True, None, block_q, 128)
            tiles = _counted_tiles(torch, f"{name} at ring step {step}", fn, cls, heads)
            ms = _time_ms(torch, fn, warmup=2, reps=10)
            flops, nbytes = work[name]
            t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            row = {"ms": ms, "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes", "tiles": tiles}
            print(f"time {name} at ring step {step} of cp={cp} folded B={b} S_local={s_loc} "
                  f"H={h} KH={kh} D={d} causal: {ms:.3f} ms a launch, bound "
                  f"{row['bound_ms']:.3f} ms ({row['bound_by']}: {flops / 1e12:.3f} TFLOP over "
                  f"the step's allowed pairs; {nbytes / 1e6:.1f} MB), {x['live']} of {b * cp} "
                  f"shards with allowed pairs (allowed_mask)", flush=True)
            if step == 0:
                out[name].update(row)
            else:
                out[name].setdefault("steps", {})[str(step)] = row
    for name in ("ring_fwd", "ring_bwd"):
        steps = out[name]["steps"]
        out[name]["skip_ratio"] = steps[str(cp - 1)]["ms"] / steps["1"]["ms"]
        print(f"{name}: a launch at ring step {cp - 1} takes {out[name]['skip_ratio']:.3f}x "
              f"the time of one at step 1", flush=True)

    x, kw = calls[0][0], st["kw"]
    q, k, v, do, pos = x["q"], x["k"], x["v"], x["do"], x["pos_q"]
    del calls, x
    torch.cuda.empty_cache()
    out["ring_fwd"]["plain_ms"] = _time_ms(torch, lambda: rc.chunk_attention_fwd_reference(
        q, k, v, pos, pos, None, None, st["acc"], st["m"], st["l"], **kw), warmup=1, reps=2)
    out["ring_bwd"]["plain_ms"] = _time_ms(torch, lambda: rc.chunk_attention_bwd_reference(
        q, k, v, pos, pos, None, None, do, st["lse"], st["delta"], **kw), warmup=1, reps=2)
    out["ring_dq"]["plain_ms"] = _time_ms(torch, lambda: rc.chunk_attention_dq_reference(
        q, k, v, pos, pos, None, None, do, st["lse"], st["delta"], **kw), warmup=1, reps=2)
    out["ring_dkv"]["plain_ms"] = _time_ms(torch, lambda: rc.chunk_attention_dkv_reference(
        q, k, v, pos, pos, None, None, do, st["lse"], st["delta"], **kw), warmup=1, reps=2)
    rot = ra.FoldedRotation(cp)
    ring_fwd_all = _time_ms(torch, lambda: ra.ring_flash_forward(q, k, v, pos, pos, None, None,
                                                                 rot, kw), warmup=1, reps=2)
    ring_bwd_all = _time_ms(torch, lambda: ra.ring_flash_backward(
        q, k, v, pos, pos, None, None, st["out"], st["lse"], do, rot, kw), warmup=1, reps=2)
    del st, q, k, v, do
    torch.cuda.empty_cache()
    for name in out:
        out[name].update({"library_ms": None,
                          "library": "no single PyTorch call computes a carried ring step"})
        print(f"time {name} at the diagonal ring step: plain {out[name]['plain_ms']:.3f} ms",
              flush=True)

    # comparison: the whole ring against one attention call over the unsharded sequence
    s = cp * s_loc
    qg, kg, vg, dog = _inputs(torch, b, s, h, kh, d)
    scale = d**-0.5
    o, lse_g = fa.flash_fwd(qg, kg, vg, None, None, scale, True)
    flash_fwd_ms = _time_ms(torch, lambda: fa.flash_fwd(qg, kg, vg, None, None, scale, True),
                            warmup=1, reps=2)
    flash_backward_ms = _time_ms(torch, lambda: fa.flash_backward(qg, kg, vg, None, None, o, lse_g,
                                                             dog, scale, True), warmup=1, reps=2)
    delta_g = fa._delta(o, dog)
    flash_dq_ms = _time_ms(torch, lambda: fa.flash_dq(qg, kg, vg, None, None, dog, lse_g, delta_g,
                                                      scale, True), warmup=1, reps=2)
    flash_dkv_ms = _time_ms(torch, lambda: fa.flash_dkv(qg, kg, vg, None, None, dog, lse_g,
                                                        delta_g, scale, True), warmup=1, reps=2)
    del o, lse_g, delta_g
    sdpa_fwd_ms = _time_ms(torch, lambda: _library_sdpa(torch, qg, kg, vg, True), warmup=1,
                           reps=3)
    ql, kl, vl = (x.clone().requires_grad_() for x in (qg, kg, vg))
    o_lib = _library_sdpa(torch, ql, kl, vl, True)
    sdpa_bwd_ms = _time_ms(torch, lambda: torch.autograd.grad(o_lib, (ql, kl, vl), dog,
                                                              retain_graph=True),
                           warmup=1, reps=2)
    flash_bound = {}  # flash's bound at (L), from the timed tensors
    for name, (flops, nbytes) in _flash_work(qg, kg, vg).items():
        flash_bound[name] = max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3
    del o_lib, ql, kl, vl, qg, kg, vg, dog
    torch.cuda.empty_cache()
    comparison = {"S": s, "ring_fwd_whole_ms": ring_fwd_all, "ring_bwd_whole_ms": ring_bwd_all,
                  "flash_fwd_ms": flash_fwd_ms, "flash_backward_ms": flash_backward_ms,
                  "flash_dq_ms": flash_dq_ms, "flash_dkv_ms": flash_dkv_ms,
                  "flash_fwd_bound_ms": flash_bound["flash_fwd"],
                  "flash_backward_bound_ms": flash_bound["flash_backward"],
                  "flash_dq_bound_ms": flash_bound["flash_dq"],
                  "flash_dkv_bound_ms": flash_bound["flash_dkv"],
                  "sdpa_fwd_ms": sdpa_fwd_ms, "sdpa_bwd_ms": sdpa_bwd_ms}
    print(f"comparison at S={s} (B={b} H={h} KH={kh} D={d} causal): the whole folded ring "
          f"(cp={cp} launches and rotations) forward {ring_fwd_all:.3f} ms, backward "
          f"{ring_bwd_all:.3f} ms; flash_fwd {flash_fwd_ms:.3f} ms (bound "
          f"{flash_bound['flash_fwd']:.3f} ms), flash_dq {flash_dq_ms:.3f} ms (bound "
          f"{flash_bound['flash_dq']:.3f} ms), flash_dkv {flash_dkv_ms:.3f} ms (bound "
          f"{flash_bound['flash_dkv']:.3f} ms), the flash backward (delta, flash_dq, "
          f"flash_dkv) {flash_backward_ms:.3f} ms (bound {flash_bound['flash_backward']:.3f} ms) "
          f"on the unsharded sequence; SDPA forward "
          f"{sdpa_fwd_ms:.3f} ms, backward {sdpa_bwd_ms:.3f} ms", flush=True)
    out["ring_fwd"]["comparison_unsharded"] = comparison
    return out


# MLA's (D, Dv) = (192, 128) on the ring: DeepSeek-V3's attention (V, H = KH = 128) and
# Moonlight-16B-A3B's (M, H = KH = 16), a cp shard of 4096 (cp 4 folded, B 1), causal
MLA_RING = {"V": dict(cp=4, b=1, s_loc=4096, h=128, kh=128, d=192, dv=128),
            "M": dict(cp=4, b=1, s_loc=4096, h=16, kh=16, d=192, dv=128)}
# DeepSeek-V3's softmax scale: 192^-0.5 times YaRN's mscale^2 (factor 40, mscale 1,
# original context 4096 under 163,840 positions), as DeepseekV3Config.softmax_scale
DSV3_SCALE = 192**-0.5 * (0.1 * math.log(40.0) + 1.0) ** 2


def _mla_ring_phase(torch, errs):
    """ring_fwd, ring_dq and ring_dkv at MLA's (D, Dv) = (192, 128) against the plain
    version, one full folded ring each (its diagonal step, wholly allowed steps and
    wholly skipped future steps), with the tiles counted at the diagonal step: (ma)
    Moonlight's heads (H = KH = 16) at S_local 4096, cp 4, causal; (mb) packed segments
    with positions restarting per document (boundaries inside tiles), B 2; (mc) a window
    of 1024; (md) non-causal, GQA (H 8, KH 2) at DeepSeek-V3's scale (YaRN's mscale^2);
    (me) a ragged local length (S_local 1000, cp 3)."""
    def note(e):  # the backward's default route is ring_dq + ring_dkv at Dv != D
        for name, x in zip(("ring_fwd", "ring_dq", "ring_dkv"), (e[0], e[2], e[3])):
            errs[name] = max(errs.get(name, 0.0), x)

    mla = dict(d=192, dv=128)
    note(_ring_case(torch, "ma", 4, 1, 4096, 16, 16, **mla))
    seg, pos = _packed_ring_segments(torch, 2, 4 * 2048, seed=1)
    note(_ring_case(torch, "mb", 4, 2, 2048, 16, 16, seg=seg, positions=pos, **mla))
    note(_ring_case(torch, "mc", 4, 1, 2048, 16, 16, window=1024, **mla))
    note(_ring_case(torch, "md", 4, 1, 2048, 8, 2, causal=False, scale=DSV3_SCALE, **mla))
    note(_ring_case(torch, "me", 3, 1, 1000, 16, 16, **mla))


def _mla_ring_calls(torch, a, steps=(0, 1)):
    """At (192, 128) shape ``a`` (MLA_RING): per ring step of ``steps`` its inputs and one
    call each of ring_fwd, ring_dq and ring_dkv through the wrappers (keywords given to a
    call go on to the wrapper), on the carry of a fresh ring and the lse / delta of one
    whole ring forward; and that state (``kw``, ``q``, ``do``, ``pos``, ``lse``,
    ``delta``, ``acc``, ``m``, ``l``)."""
    from automodel_tpu_torch.ops import ring_chunk as rc
    from automodel_tpu_torch.parallel import ring_attention as ra

    f32 = dict(dtype=torch.float32, device="cuda")
    cp, h, kh, d, dv = (a[n] for n in ("cp", "h", "kh", "d", "dv"))
    kw = dict(scale=d**-0.5, causal=True, window=None, groups=h // kh, n_heads=h)
    base = _ring_step_inputs(torch, 0, **a)
    q, do, pos = base["q"], base["do"], base["pos_q"]
    o, lse = ra.ring_flash_forward(q, base["k"], base["v"], pos, pos, None, None,
                                   ra.FoldedRotation(cp), kw)
    delta = (o.float() * do.float()).sum(-1)
    del o
    acc, m, l = (torch.zeros((*q.shape[:2], dv), **f32), torch.full(q.shape[:2], -1e30, **f32),
                 torch.zeros(q.shape[:2], **f32))
    dq = torch.zeros(q.shape, **f32)
    dk, dvv = torch.zeros(base["k"].shape, **f32), torch.zeros(base["v"].shape, **f32)
    calls = {}
    for step in steps:
        x = base if step == 0 else _ring_step_inputs(torch, step, **a)
        k, v, pkv = x["k"], x["v"], x["pos_kv"]
        calls[step] = (x, {
            "ring_fwd": lambda k=k, v=v, pkv=pkv, **c: rc.ring_fwd(
                q, k, v, pos, pkv, None, None, acc, m, l, **kw, **c),
            "ring_dq": lambda k=k, v=v, pkv=pkv: rc.ring_dq(
                q, k, v, pos, pkv, None, None, do, lse, delta, dq, **kw),
            "ring_dkv": lambda k=k, v=v, pkv=pkv, **c: rc.ring_dkv(
                q, k, v, pos, pkv, None, None, do, lse, delta, dk, dvv, **kw, **c)})
    return calls, dict(kw=kw, q=q, do=do, pos=pos, lse=lse, delta=delta, acc=acc, m=m, l=l)


def _mla_ring_timings(torch):
    """ms of ring_fwd, ring_dq and ring_dkv a launch at (192, 128) at shapes V and M
    (MLA_RING): the diagonal ring step and step 1 (every shard's chunk wholly allowed or
    wholly in its future), each beside its bound over the step's allowed pairs
    (_ring_work at D and Dv) and, at M's diagonal step, the plain version; the tiles
    ring_fwd and ring_dkv count at each step held against tile_classes. No single
    PyTorch call computes a carried ring step, so there is no library time."""
    from automodel_tpu_torch.ops import ring_chunk as rc

    out = {}
    for shape, a in MLA_RING.items():
        cp, h, kh, d, dv = (a[n] for n in ("cp", "h", "kh", "d", "dv"))
        calls, st = _mla_ring_calls(torch, a)
        rows = out.setdefault(shape, {"ring_fwd": {}, "ring_dq": {}, "ring_dkv": {}})
        for step, (x, fns) in calls.items():
            pos, pkv = st["pos"], x["pos_kv"]
            work = _ring_work(x, h, kh, d, dv)
            for name, fn in fns.items():
                row = {}
                if name != "ring_dq":  # ring_dq counts no tiles
                    block_q = 128 if name == "ring_fwd" else rc.bwd_block_q(d, dv)
                    cls = rc.tile_classes(pos, pkv, None, None, True, None, block_q, 128)
                    row["tiles"] = _counted_tiles(torch, f"{name} at ({shape}) step {step}", fn,
                                                  cls, h if name == "ring_fwd" else kh)
                ms = _time_ms(torch, fn, warmup=2, reps=10)
                flops, nbytes = work[name]
                t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
                row.update({"ms": ms, "bound_ms": max(t_ops, t_bytes),
                            "bound_by": "operations" if t_ops >= t_bytes else "bytes"})
                print(f"time {name} at ({shape}) ring step {step} of cp={cp} folded B=1 "
                      f"S_local={a['s_loc']} H={h} KH={kh} D={d} Dv={dv} causal: {ms:.3f} ms a "
                      f"launch, bound {row['bound_ms']:.3f} ms ({row['bound_by']}: "
                      f"{flops / 1e12:.3f} TFLOP over the step's allowed pairs; "
                      f"{nbytes / 1e6:.1f} MB), share {row['bound_ms'] / ms:.3f}", flush=True)
                rows[name]["diagonal" if step == 0 else "step_1"] = row
        if shape == "M":
            q, do, pos, lse, delta, kw = (st[n] for n in ("q", "do", "pos", "lse", "delta", "kw"))
            k, v = calls[0][0]["k"], calls[0][0]["v"]
            for name, ref in (("ring_fwd", lambda: rc.chunk_attention_fwd_reference(
                                  q, k, v, pos, pos, None, None, st["acc"], st["m"], st["l"],
                                  **kw)),
                              ("ring_dq", lambda: rc.chunk_attention_dq_reference(
                                  q, k, v, pos, pos, None, None, do, lse, delta, **kw)),
                              ("ring_dkv", lambda: rc.chunk_attention_dkv_reference(
                                  q, k, v, pos, pos, None, None, do, lse, delta, **kw))):
                rows[name]["diagonal"]["plain_ms"] = _time_ms(torch, ref, warmup=1, reps=2)
                print(f"time {name} at (M) diagonal step: plain "
                      f"{rows[name]['diagonal']['plain_ms']:.3f} ms", flush=True)
            del q, do, pos, lse, delta, k, v
        del calls, st
        torch.cuda.empty_cache()
    return out


def _ring_refused_on_the_card(torch):
    """(D, Dv) pairs the ring kernels are not instantiated at, (96, 64) and (192, 192),
    raise NotImplementedError on the card through both chunk functions and launch
    nothing: no fallback to the plain version."""
    from automodel_tpu_torch.ops import ring_chunk as rc

    f32 = dict(dtype=torch.float32, device="cuda")
    for d, dv in ((96, 64), (192, 192)):
        q, k, v, do, pos, _ = _ring_layout(torch, 1, 1, 256, 4, 4, d, seed=3, dv=dv)
        kw = dict(scale=d**-0.5, causal=True, window=None, groups=1, n_heads=4)
        rows = q.shape[:2]
        before = dict(rc.LAUNCHES)
        for what, call in (
                ("forward", lambda: rc.chunk_attention_fwd(
                    q, k, v, pos, pos, None, None, torch.zeros((*rows, dv), **f32),
                    torch.full(rows, -1e30, **f32), torch.zeros(rows, **f32), **kw)),
                ("backward", lambda: rc.chunk_attention_bwd(
                    q, k, v, pos, pos, None, None, do, torch.zeros(rows, **f32),
                    torch.zeros(rows, **f32), torch.zeros(q.shape, **f32),
                    torch.zeros(k.shape, **f32), torch.zeros(v.shape, **f32), **kw))):
            try:
                call()
            except NotImplementedError as e:
                print(f"ring (D, Dv) = ({d}, {dv}) {what} on the card: NotImplementedError "
                      f"({e})", flush=True)
            else:
                raise AssertionError(f"ring (D, Dv) = ({d}, {dv}) {what} ran on the card")
        if rc.LAUNCHES != before:
            raise AssertionError(f"ring (D, Dv) = ({d}, {dv}): a refused call launched")


def _ring_model_check(torch):
    """Ring attention (the ring kernels) against context_parallel allgather (the flash
    kernels) on the same weights: Llama-3-8B width, 2 layers, seq 8192, cp 4 folded, bf16."""
    from automodel_tpu_torch.data.collate import sft_collate
    from automodel_tpu_torch.data.llm.mock import MockSFTDataset
    from automodel_tpu_torch.models.common.backend import BackendConfig
    from automodel_tpu_torch.models.llama.model import LlamaForCausalLM
    from automodel_tpu_torch.ops.losses import masked_cross_entropy
    from automodel_tpu_torch.parallel.mesh import MeshContext

    hf = dict(LLAMA3_8B, num_hidden_layers=2)
    ds = MockSFTDataset(hf["vocab_size"], 8192, num_samples=1, seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in sft_collate([ds[0]], 8192).items()}
    mesh = MeshContext(cp=4)
    results = {}
    for mode in ("ring", "allgather"):
        backend = BackendConfig(attention="flash", context_parallel=mode, remat_policy="dots",
                                dtype="bfloat16")
        model = LlamaForCausalLM.from_config(
            hf, backend, device="cuda", dtype=torch.bfloat16,
            generator=torch.Generator(device="cuda").manual_seed(0))
        params = model.param_dict()
        _reset_counts()
        logits = model(batch["input_ids"], positions=batch["positions"],
                       segment_ids=batch["segment_ids"], mesh=mesh)
        loss = masked_cross_entropy(logits, batch["labels"])
        grads = torch.autograd.grad(loss, list(params.values()))
        counts = _read_counts()
        results[mode] = (loss.item(), torch.cat([g.float().flatten() for g in grads]), counts)
        del model, params, logits, grads
        torch.cuda.empty_cache()
    d_loss = abs(results["ring"][0] - results["allgather"][0])
    rel = _rel_l2(results["ring"][1], results["allgather"][1])
    routes = (results["ring"][2]["ring_fwd"] > 0 and results["ring"][2]["flash_fwd"] == 0
              and results["allgather"][2]["flash_fwd"] > 0
              and results["allgather"][2]["ring_fwd"] == 0)
    print(f"ring model check (2 layers, Llama-3-8B width, seq 8192, cp 4 folded, bf16): loss "
          f"ring {results['ring'][0]:.6f} allgather {results['allgather'][0]:.6f} |diff| "
          f"{d_loss:.3e} (tol {TOL_MODEL_LOSS}), grad rel L2 {rel:.3e} (tol {TOL_MODEL_GRAD}); "
          f"launches ring {results['ring'][2]} allgather {results['allgather'][2]}", flush=True)
    if not (d_loss <= TOL_MODEL_LOSS and rel <= TOL_MODEL_GRAD and routes):
        raise AssertionError("ring attention disagrees with allgather through the model")


# the process-group ring (``--cp-processes N``, one process per card): Llama-3-8B heads
# over a 32768-token sequence at cp 4
PG_S_LOCAL, PG_H, PG_KH, PG_D = 8192, 32, 8, 128
# process-group ring against the fold: the same kernels on the same shards in the same
# step order; only dq's atomicAdd order differs between runs
TOL_PG_OUT, TOL_PG_GRAD = 1e-6, 1e-4


def _pg_inputs(torch, cp):
    """Global bf16 q, k, v, dO drawn on the CPU from one seed, so every process holds the
    same numbers."""
    g = torch.Generator().manual_seed(17)
    return [torch.randn(1, cp * PG_S_LOCAL, n, PG_D, generator=g).to(torch.bfloat16)
            for n in (PG_H, PG_KH, PG_KH, PG_H)]


def _pg_ring_step(torch, ring, q, k, v, do):
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    out = ring(qq, kk, vv)
    return out.detach(), torch.autograd.grad(out, (qq, kk, vv), do)


def _pg_ring_rank(out_dir: str) -> None:
    """One rank of the process-group ring: its shard on card RANK, kv bundles passed with
    batch_isend_irecv over NCCL; writes its output, gradients and time to out_dir."""
    import torch
    import torch.distributed as dist

    from automodel_tpu_torch.parallel.init import initialize_distributed
    from automodel_tpu_torch.parallel.ring_attention import (ProcessGroupRotation,
                                                             ring_attention_local)

    info = initialize_distributed(device="cuda", timeout_s=120)
    rank, cp = info.rank, info.world_size
    sl = slice(rank * PG_S_LOCAL, (rank + 1) * PG_S_LOCAL)
    q, k, v, do = (x[:, sl].cuda() for x in _pg_inputs(torch, cp))
    pos = torch.arange(sl.start, sl.stop, dtype=torch.int32, device="cuda")[None]
    rot = ProcessGroupRotation()

    def ring(a, b, c):
        return ring_attention_local(a, b, c, pos, pos, rotation=rot)

    out, grads = _pg_ring_step(torch, ring, q, k, v, do)
    times = []
    for _ in range(3):
        dist.barrier()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _pg_ring_step(torch, ring, q, k, v, do)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    torch.save({"out": out.cpu(), "grads": [g.cpu() for g in grads],
                "ms": sorted(times)[1]}, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _pg_ring_phase(torch, nproc: int) -> dict:
    """The process-group ring over ``nproc`` cards (one process each, NCCL) against the
    fold of the same ring on card 0: outputs and gradients, and the forward + backward
    time of each."""
    import socket

    from automodel_tpu_torch.parallel.mesh import MeshContext
    from automodel_tpu_torch.parallel.ring_attention import make_ring_attention

    if torch.cuda.device_count() < nproc:
        raise RuntimeError(f"--cp-processes {nproc} needs {nproc} cards, found "
                           f"{torch.cuda.device_count()}")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as out_dir:
        code = (f"import sys; sys.path.insert(0, {HERE!r}); import chip_smoke; "
                f"chip_smoke._pg_ring_rank({out_dir!r})")
        procs, logs = [], []
        for rank in range(nproc):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(nproc),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            procs.append(subprocess.Popen([sys.executable, "-c", code], env=env,
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0].decode(errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode != 0 for p in procs):
            raise AssertionError("process-group ring failed:\n" + "\n".join(logs))
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(nproc)]

    q, k, v, do = (x.cuda() for x in _pg_inputs(torch, nproc))
    pos = torch.arange(q.shape[1], dtype=torch.int32, device="cuda")[None]
    fold = make_ring_attention(MeshContext(cp=nproc))

    def ring(a, b, c):
        return fold(a, b, c, pos)

    out, grads = _pg_ring_step(torch, ring, q, k, v, do)
    fold_ms = _time_ms(torch, lambda: _pg_ring_step(torch, ring, q, k, v, do), warmup=1, reps=2)
    err_out, rel = 0.0, 0.0
    for r, got in enumerate(ranks):
        sl = slice(r * PG_S_LOCAL, (r + 1) * PG_S_LOCAL)
        err_out = max(err_out, (got["out"].cuda().float() - out[:, sl].float()).abs().max().item())
        rel = max(rel, *(_rel_l2(g.cuda(), w[:, sl]) for g, w in zip(got["grads"], grads)))
    pg_ms = max(got["ms"] for got in ranks)
    print(f"process-group ring: {nproc} processes on {nproc} cards (NCCL batch_isend_irecv), "
          f"B=1 S={nproc * PG_S_LOCAL} (S_local {PG_S_LOCAL}) H={PG_H} KH={PG_KH} D={PG_D} "
          f"causal, against the fold of the same ring on one card: O max abs {err_out:.3e} "
          f"(tol {TOL_PG_OUT}), grad rel L2 {rel:.3e} (tol {TOL_PG_GRAD}); forward + backward "
          f"{pg_ms:.3f} ms (slowest rank) against {fold_ms:.3f} ms folded on one card",
          flush=True)
    if not (err_out <= TOL_PG_OUT and rel <= TOL_PG_GRAD):
        raise AssertionError("the process-group ring disagrees with the fold")
    return {"processes": nproc, "S": nproc * PG_S_LOCAL, "max_abs_err_out": err_out,
            "grad_rel_l2": rel, "pg_ms": pg_ms, "fold_ms": fold_ms}


def _router_group_sizes(torch, tokens, d, e, k, seed=0):
    """(E,) int32 rows per expert from a softmax top-k router on random weights: the
    router's (T, D) x (D, E) product at init scale, as the MoE layer routes."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(tokens, d, device="cuda", generator=g).to(torch.bfloat16)
    wg = (torch.randn(e, d, device="cuda", generator=g) * 0.02).to(torch.bfloat16)
    idx = torch.topk(torch.softmax(x.float() @ wg.float().t(), -1), k, -1).indices.reshape(-1)
    return torch.zeros(e, dtype=torch.int32, device="cuda").scatter_add_(
        0, idx, torch.ones_like(idx, dtype=torch.int32))


def _gmm_inputs(torch, sizes, d, f, seed, extra=0):
    """x, w, dout with N = sum(sizes) + ``extra`` rows (rows past the groups)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = int(sizes.sum()) + extra
    x = torch.randn(n, d, device="cuda", generator=g).to(torch.bfloat16)
    w = (torch.randn(sizes.numel(), d, f, device="cuda", generator=g) / d**0.5).to(torch.bfloat16)
    dout = torch.randn(n, f, device="cuda", generator=g).to(torch.bfloat16)
    return x, w, dout


def _gmm_case(torch, name, sizes, d, f, extra=0):
    """gmm (forward, dX) and tgmm (dW) against the plain version in f32 from the same
    bf16 inputs; dW of an empty expert must be exactly zero, and so must out and dX on
    the ``extra`` rows past the groups; each gmm launch must take the route the wrapper
    names for its shapes."""
    from automodel_tpu_torch.ops import grouped_gemm as gg

    x, w, dout = _gmm_inputs(torch, sizes, d, f, seed=d + f, extra=extra)
    routes = {"forward": gg.gmm_route(x, w), "dX": gg.gmm_route(dout, w, transpose_w=True),
              "dW": gg.tgmm_route(x, dout)}
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = dict(gg.ROUTE_LAUNCHES)
    out = gg.grouped_matmul(xk, wk, sizes)
    dx, dw = torch.autograd.grad(out, (xk, wk), dout)
    torch.cuda.synchronize()
    taken = {k: gg.ROUTE_LAUNCHES[k] - before[k] for k in before}
    want = {k: sum(f"{'tgmm' if part == 'dW' else 'gmm'}/{r}" == k for part, r in routes.items())
            for k in before}
    xr, wr = x.float().requires_grad_(), w.float().requires_grad_()
    ref = gg.grouped_matmul_reference(xr, wr, sizes)
    rdx, rdw = torch.autograd.grad(ref, (xr, wr), dout.float())
    rel = [_rel_l2(a, r) for a, r in ((out, ref), (dx, rdx), (dw, rdw))]
    empty = sizes == 0
    n_empty = int(empty.sum())
    empty_ok = n_empty == 0 or bool((dw[empty] == 0).all())
    past = x.shape[0] - extra
    tail_ok = bool((out[past:] == 0).all() and (dx[past:] == 0).all())
    print(f"gmm case {name}: N={x.shape[0]} D={d} F={f} E={sizes.numel()} ({n_empty} empty, "
          f"largest {int(sizes.max())} rows, {extra} rows past the groups): rel L2 out "
          f"{rel[0]:.3e} dX {rel[1]:.3e} dW {rel[2]:.3e} (tol {TOL_GMM}), dW of empty experts "
          f"exactly 0: {empty_ok}, out and dX past the groups exactly 0: {tail_ok}; routes "
          f"gmm forward {routes['forward']}, gmm dX {routes['dX']}, tgmm {routes['dW']} "
          f"(launched {taken})", flush=True)
    if not (max(rel) <= TOL_GMM and empty_ok and tail_ok):
        raise AssertionError(f"gmm case {name}: kernels disagree with the plain version")
    if taken != want:
        raise AssertionError(f"gmm case {name}: routes launched {taken}, named {want}")
    err_gmm = max((out.float() - ref).abs().max().item(), (dx.float() - rdx).abs().max().item())
    err_tgmm = (dw.float() - rdw).abs().max().item()
    del x, w, dout, xk, wk, out, dx, dw, xr, wr, ref, rdx, rdw
    torch.cuda.empty_cache()
    return err_gmm, err_tgmm


def _library_grouped_mm(torch, x, w, dout, ends):
    """The yardsticks: ``torch._grouped_mm`` for the forward, dX (w transposed in place)
    and dW where this torch has it, timed here and used nowhere in the port; else one
    cuBLAS ``torch.matmul`` of the same FLOPs. Returns (name, forward fn, dX fn, dW fn)."""
    if hasattr(torch, "_grouped_mm"):
        fwd = (lambda: torch._grouped_mm(x, w, offs=ends))
        dx = (lambda: torch._grouped_mm(dout, w.transpose(-2, -1), offs=ends))
        dw = (lambda: torch._grouped_mm(x.t(), dout, offs=ends))
        try:
            fwd(), dx(), dw()
            torch.cuda.synchronize()
            return f"torch._grouped_mm (torch {torch.__version__})", fwd, dx, dw
        except RuntimeError as exc:
            print(f"  torch._grouped_mm refused these operands: {str(exc).splitlines()[0]}")
    w0 = w[0].contiguous()
    return ("torch.matmul stand-in of the same FLOPs", lambda: torch.matmul(x, w0),
            lambda: torch.matmul(dout, w0.t()), lambda: torch.matmul(x.t(), dout))


def _gmm_work(n, d, f, e, live):
    """FLOPs and bytes of gmm's forward, its dX and tgmm at N routed rows, D, F, E
    experts of which ``live`` have rows (only their weights are read); each input read
    once, each output written once, plus the (E,) int32 group offsets."""
    flops = 2 * n * d * f
    return {"forward": (flops, 2 * (n * d + live * d * f + n * f) + 4 * e),
            "dX": (flops, 2 * (n * f + live * d * f + n * d) + 4 * e),
            "tgmm": (flops, 2 * (n * d + n * f + e * d * f) + 4 * e)}


# where each grouped GEMM timing goes in the kernels line: case a's forward and tgmm
# are the rows themselves (None), the rest keyed sub-rows; h and i are GPT-OSS-20B's
# gate_up and down (D = 2880, not a multiple of the 128-wide tile)
_GMM_ROW_KEYS = {("forward", "a"): None, ("forward", "b"): "at_case_b", ("dX", "a"): "dx",
                 ("dX", "b"): "dx_at_case_b", ("tgmm", "a"): None, ("tgmm", "b"): "at_case_b",
                 ("forward", "h"): "at_gpt_oss_gate_up", ("dX", "h"): "dx_at_gpt_oss_gate_up",
                 ("tgmm", "h"): "at_gpt_oss_gate_up", ("forward", "i"): "at_gpt_oss_down",
                 ("dX", "i"): "dx_at_gpt_oss_down", ("tgmm", "i"): "at_gpt_oss_down"}
_GMM_ROW_KEYS |= {(part, case): f"{'dx_' if part == 'dX' else ''}at_{model}_{proj}"
                  for case, model, proj in (("m", "mixtral", "gate_up"), ("n", "mixtral", "down"),
                                            ("o", "glm45_air", "gate_up"),
                                            ("p", "glm45_air", "down"),
                                            ("q", "qwen3_next", "gate_up"),
                                            ("r", "qwen3_next", "down"))
                  for part in ("forward", "dX", "tgmm")}
GMM_SHAPES = (("a", 2048, 1536), ("b", 768, 2048))  # the Qwen3-30B-A3B slice's
GPT_OSS_GMM_SHAPES = (("h", 2880, 5760), ("i", 2880, 2880))
# Mixtral-8x7B's gate_up (D = 4096, F = 2 x 14336) and down (14336, 4096): main path 31's
MIXTRAL_GMM_SHAPES = (("m", 4096, 28672), ("n", 14336, 4096))
# GLM-4.5-Air's gate_up (D = 4096, F = 2 x 1408) and down (1408, 4096), main path 38's;
# Qwen3-Next-80B-A3B's (2048, 2 x 512) and (512, 2048), main path 41's
GLM45_GMM_SHAPES = (("o", 4096, 2816), ("p", 1408, 4096))
QWEN3_NEXT_GMM_SHAPES = (("q", 2048, 1024), ("r", 512, 2048))


def _gmm_timings(torch, sizes, shapes=GMM_SHAPES, plain_reps=(1, 3)):
    """ms of gmm (forward and dX) and tgmm (dW) at the slice's gate_up (a) and down (b)
    shapes, or the ``shapes`` given, with bound, plain version (``plain_reps``: its warmup
    calls and timed reps) and yardstick."""
    from automodel_tpu_torch.ops import grouped_gemm as gg

    out = {"gmm": {}, "tgmm": {}}
    e = sizes.numel()
    live = int((sizes > 0).sum())
    ends = gg._ends(sizes)
    for case, d, f in shapes:
        x, w, dout = _gmm_inputs(torch, sizes, d, f, seed=11)
        n = x.shape[0]
        work = _gmm_work(n, d, f, e, live)
        name, lib_fwd, lib_dx, lib_dw = _library_grouped_mm(torch, x, w, dout, ends)
        xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
        ref = gg.grouped_matmul_reference(xp, wp, sizes)
        times = {
            "forward": (_time_ms(torch, lambda: gg.gmm(x, w, ends)),
                        _time_ms(torch, lambda: gg.grouped_matmul_reference(x, w, sizes),
                                 *plain_reps),
                        _time_ms(torch, lib_fwd), gg.gmm_route(x, w)),
            "dX": (_time_ms(torch, lambda: gg.gmm(dout, w, ends, transpose_w=True)),
                   _time_ms(torch, lambda: torch.autograd.grad(ref, xp, dout, retain_graph=True),
                            *plain_reps),
                   _time_ms(torch, lib_dx), gg.gmm_route(dout, w, transpose_w=True)),
            "tgmm": (_time_ms(torch, lambda: gg.tgmm(x, dout, ends, e)),
                     _time_ms(torch, lambda: torch.autograd.grad(ref, wp, dout,
                                                                 retain_graph=True),
                              *plain_reps),
                     _time_ms(torch, lib_dw), gg.tgmm_route(x, dout))}
        for part, (ms, plain, lib, route) in times.items():
            flops, nbytes = work[part]
            t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            row = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library": name,
                   "route": route}
            kname = "tgmm" if part == "tgmm" else "gmm"
            key = _GMM_ROW_KEYS[part, case]
            if key is None:
                out[kname].update(row)
            else:
                out[kname][key] = row
            label = kname if part == kname else f"{kname} {part}"
            print(f"time {label} case {case} at N={n} D={d} F={f} E={e} ({route}): "
                  f"{ms:.3f} ms, bound {row['bound_ms']:.3f} ms ({row['bound_by']}: "
                  f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), plain {plain:.3f} ms, "
                  f"yardstick {lib:.3f} ms ({name})", flush=True)
        del x, w, dout, xp, wp, ref
        torch.cuda.empty_cache()
    return out


def _gmm_phase(torch, errs):
    """Grouped GEMM cases a-i and timings. a / b: the slice's gate_up and down shapes
    with group sizes from a softmax top-8 router over 8192 tokens and 128 experts; c:
    empty head / mid / tail experts, N not a tile multiple, D = 1000 and F = 1003; d:
    one expert owning every row, D = 1003 (rows of x and the K of dW not 16-byte
    aligned); e: D = 16, F = 24, N = 30 with an empty expert, on the wgmma route with
    every dimension inside one tile (TMA boxes past the tensor's edges); f: c's group
    sizes with 300 rows past the groups at D = 256, F = 512, on the wgmma route (its
    tail tiles zero those rows); g: tgmm's wgmma route with every kind of last K step
    (experts of 1, 63, 64, 65, 127 and 200 rows, one empty, 37 rows past the groups
    whose x must not enter the last expert's dW); h / i: GPT-OSS-20B's gate_up (D = 2880,
    F = 5760) and down (2880, 2880), 32 experts top-4 over 16,384 tokens (main path 11's
    microbatch), K and N no multiple of the 128-wide tile; m / n: Mixtral-8x7B's gate_up
    (D = 4096, F = 28,672) and down (14,336, 4096), 8 experts top-2 over 8192 tokens (main
    path 31's microbatch: about 2048 rows an expert); o / p: GLM-4.5-Air's gate_up (4096,
    2816) and down (1408, 4096), 128 experts top-8 over main path 38's 4096 tokens (256
    rows an expert); q / r: Qwen3-Next-80B-A3B's (2048, 1024) and (512, 2048), 512 experts
    top-10 over main path 41's 8192 tokens (160 rows an expert, most 128-row tiles part
    empty); timed at a / b, h / i, m / n, o / p and q / r."""
    sizes = _router_group_sizes(torch, 8192, 2048, 128, 8)
    gpt_oss = _router_group_sizes(torch, 16384, 2880, 32, 4)
    mixtral = _router_group_sizes(torch, 8192, 4096, 8, 2)
    glm = _router_group_sizes(torch, 4096, 4096, 128, 8)
    qwen3_next = _router_group_sizes(torch, 8192, 2048, 512, 10)
    ragged = torch.tensor([0, 0, 300, 0, 77, 5, 0, 1, 134, 0, 0], dtype=torch.int32,
                          device="cuda")
    owner = torch.tensor([0, 1000, 0, 0], dtype=torch.int32, device="cuda")
    small = torch.tensor([5, 0, 11, 14], dtype=torch.int32, device="cuda")
    tails = torch.tensor([1, 63, 64, 65, 127, 0, 200], dtype=torch.int32, device="cuda")
    errs.update({"gmm": 0.0, "tgmm": 0.0})
    for case in (("a", sizes, 2048, 1536), ("b", sizes, 768, 2048),
                 ("c", ragged, 1000, 1003), ("d", owner, 1003, 1000), ("e", small, 16, 24),
                 ("f", ragged, 256, 512, 300), ("g", tails, 256, 512, 37),
                 ("h", gpt_oss, 2880, 5760), ("i", gpt_oss, 2880, 2880),
                 ("m", mixtral, 4096, 28672), ("n", mixtral, 14336, 4096),
                 *((c, glm, d, f) for c, d, f in GLM45_GMM_SHAPES),
                 *((c, qwen3_next, d, f) for c, d, f in QWEN3_NEXT_GMM_SHAPES)):
        err_gmm, err_tgmm = _gmm_case(torch, *case)
        errs["gmm"] = max(errs["gmm"], err_gmm)
        errs["tgmm"] = max(errs["tgmm"], err_tgmm)
    out = _gmm_timings(torch, sizes)
    for more in (_gmm_timings(torch, gpt_oss, GPT_OSS_GMM_SHAPES),
                 _gmm_timings(torch, mixtral, MIXTRAL_GMM_SHAPES),
                 # the plain versions once each at the new shapes (up to 1.5 s a call)
                 _gmm_timings(torch, glm, GLM45_GMM_SHAPES, plain_reps=(0, 1)),
                 _gmm_timings(torch, qwen3_next, QWEN3_NEXT_GMM_SHAPES,
                              plain_reps=(0, 1))):
        for name, rows in more.items():
            out[name].update(rows)
    return out


def _twice(torch, label, fn, names):
    """Run ``fn`` (a launch on fixed inputs that returns fresh output tensors) twice and
    report which outputs differ bitwise: {output name: max |diff| or 0.0}."""
    first = [x.clone() for x in fn()]
    second = fn()
    torch.cuda.synchronize()
    out = {n: (a.float() - b.float()).abs().max().item() for n, a, b in zip(names, first, second)}
    differ = [n for n, a, b in zip(names, first, second) if not torch.equal(a, b)]
    print(f"twice {label}: " + ", ".join(
        f"{n} differs (max |diff| {out[n]:.3e})" if n in differ else f"{n} bitwise equal"
        for n in names), flush=True)
    return {n: (out[n] if n in differ else 0.0) for n in names}


# the kernels of the deterministic route, and the expert-bias gathers' backward on main
# paths 11 and 12: two launches on the same inputs must agree bitwise
DETERMINISTIC_KERNELS = ("flash_dq", "flash_dkv", "ring_dq", "ring_dkv", "gate_up_bias gather",
                         "down_bias gather")


def _bias_gather_grad(torch, bias, idx, g):
    """The gradient of ``bias[idx]`` (the expert biases' gather in
    ``moe/experts.py::sorted_ragged_ffn``) for the upstream gradient ``g``."""
    b = bias.detach().requires_grad_()
    return torch.autograd.grad(b[idx], b, g)


def _twice_phase(torch):
    """Each backward kernel launched twice on the same inputs, and the outputs that differ
    bitwise: flash_dq and flash_dkv at flash cases (a) and (f), with GPT-OSS's window
    (w: B=1, S=4096, H=16, KH=2, D=64, window 128) and at Phi-3's shape and window (P: B=4,
    S=2048, H=KH=32, D=96, window 2047) and, capped, at Gemma-2-27B's heads (G2: B=2,
    S=2048, H=32, KH=16, D=128, c = 50, scale 144^-0.5), at Gemma-2-9B's heads without and
    with the cap (G9 / G9c: B=2, S=2048, H=16, KH=8, D=256, scale 256^-0.5), ring_bwd and
    the deterministic route (ring_dq, ring_dkv) at ring case (a)'s diagonal step, lce_bwd
    at lce case (a), gmm dX and tgmm at gmm case (a), and the backward of the expert
    biases' gathers at main path 11's shapes (65,536 rows sorted over 32 experts). Fails
    if one of DETERMINISTIC_KERNELS differs; the others are reported."""
    from automodel_tpu_torch.ops import flash_attention as fa, grouped_gemm as gg
    from automodel_tpu_torch.ops import linear_ce as lce, ring_chunk as rc

    found = {}
    gemma2 = (GEMMA2_27B["attn_logit_softcapping"], GEMMA2_27B["query_pre_attn_scalar"]**-0.5)
    gemma9 = (GEMMA2_9B["attn_logit_softcapping"], GEMMA2_9B["query_pre_attn_scalar"]**-0.5)
    for case, shape, win, (cap, scale) in (
            ("a", (4, 2048, 32, 8, 64), None, (0.0, 64**-0.5)),
            ("f", (4, 2048, 32, 4, 128), None, (0.0, 128**-0.5)),
            ("w", (1, 4096, 16, 2, 64), 128, (0.0, 64**-0.5)),
            ("P", (4, 2048, 32, 32, 96), 2047, (0.0, 96**-0.5)),
            ("G2", (2, 2048, 32, 16, 128), None, gemma2),
            ("G9", (2, 2048, 16, 8, 256), None, (0.0, gemma9[1])),
            ("G9c", (2, 2048, 16, 8, 256), None, gemma9)):
        q, k, v, do = _inputs(torch, *shape, seed=3)
        o, lse = fa.flash_fwd(q, k, v, None, None, scale, True, win, None, cap)
        delta = fa._delta(o, do)
        found[f"flash_dq ({case})"] = _twice(
            torch, f"flash_dq at flash case ({case})",
            lambda: (fa.flash_dq(q, k, v, None, None, do, lse, delta, scale, True, win, cap),),
            ("dq",))
        found[f"flash_dkv ({case})"] = _twice(
            torch, f"flash_dkv at flash case ({case})",
            lambda: fa.flash_dkv(q, k, v, None, None, do, lse, delta, scale, True, win, cap),
            ("dk", "dv"))
        del q, k, v, do, o, lse, delta

    calls, st = _ring_launches(torch, (0,))
    x = calls[0][0]
    q, k, v, do, pos, kw = x["q"], x["k"], x["v"], x["do"], x["pos_q"], st["kw"]
    f32 = dict(dtype=torch.float32, device="cuda")

    def grads():
        return (torch.zeros(q.shape, **f32), torch.zeros(k.shape, **f32),
                torch.zeros(v.shape, **f32))

    found["ring_bwd (a)"] = _twice(torch, "ring_bwd at ring case (a)'s diagonal step", lambda: rc.ring_bwd(
        q, k, v, pos, pos, None, None, do, st["lse"], st["delta"], *grads(), **kw),
        ("dq", "dk", "dv"))
    found["ring_dq (a)"] = _twice(torch, "ring_dq at ring case (a)'s diagonal step", lambda: (rc.ring_dq(
        q, k, v, pos, pos, None, None, do, st["lse"], st["delta"], grads()[0], **kw),), ("dq",))
    found["ring_dkv (a)"] = _twice(
        torch, "ring_dkv at ring case (a)'s diagonal step",
        lambda: rc.ring_dkv(q, k, v, pos, pos, None, None, do, st["lse"], st["delta"],
                            *grads()[1:], **kw), ("dk", "dv"))
    del calls, st, x, q, k, v, do, pos

    # the deterministic route at MLA's (192, 128): Moonlight's heads, the diagonal step
    from automodel_tpu_torch.parallel import ring_attention as ra

    a = MLA_RING["M"]
    x = _ring_step_inputs(torch, 0, **a)
    q, k, v, do, pos = x["q"], x["k"], x["v"], x["do"], x["pos_q"]
    kw = dict(scale=a["d"]**-0.5, causal=True, window=None, groups=1, n_heads=a["h"])
    o, lse = ra.ring_flash_forward(q, k, v, pos, pos, None, None, ra.FoldedRotation(a["cp"]), kw)
    delta = (o.float() * do.float()).sum(-1)
    found["ring_dq (M)"] = _twice(torch, "ring_dq at (192, 128), (M)'s diagonal step", lambda: (
        rc.ring_dq(q, k, v, pos, pos, None, None, do, lse, delta,
                   torch.zeros(q.shape, **f32), **kw),), ("dq",))
    found["ring_dkv (M)"] = _twice(
        torch, "ring_dkv at (192, 128), (M)'s diagonal step",
        lambda: rc.ring_dkv(q, k, v, pos, pos, None, None, do, lse, delta,
                            torch.zeros(k.shape, **f32), torch.zeros(v.shape, **f32), **kw),
        ("dk", "dv"))
    del x, q, k, v, do, pos, o, lse, delta

    h, w, _ = _lce_inputs(torch, 8192, 2048, 128256, seed=7)
    z, _ = lce.lce_fwd(h, w)
    dz = torch.ones(h.shape[0], device="cuda")
    found["lce_bwd (a)"] = _twice(torch, "lce_bwd at lce case (a)",
                                  lambda: lce.lce_bwd(h, w, z, dz, None), ("dh", "dw"))
    del h, w, z, dz

    sizes = _router_group_sizes(torch, 8192, 2048, 128, 8)
    ends = gg._ends(sizes)
    x, w, dout = _gmm_inputs(torch, sizes, 2048, 1536, seed=11)
    found["gmm dX (a)"] = _twice(torch, "gmm dX at gmm case (a)", lambda: (
        gg.gmm(dout, w, ends, transpose_w=True),), ("dx",))
    found["tgmm (a)"] = _twice(torch, "tgmm at gmm case (a)",
                               lambda: (gg.tgmm(x, dout, ends, sizes.numel()),), ("dw",))
    del x, w, dout

    sizes = _router_group_sizes(torch, 16384, 2880, 32, 4)
    idx = torch.repeat_interleave(torch.arange(32, device="cuda"), sizes.long())
    g = torch.Generator(device="cuda").manual_seed(13)
    for name, cols in (("gate_up_bias", 5760), ("down_bias", 2880)):
        bias = torch.randn(32, cols, device="cuda", generator=g).to(torch.bfloat16)
        up = torch.randn(idx.numel(), cols, device="cuda", generator=g).to(torch.bfloat16)
        found[f"{name} gather (gpt-oss)"] = _twice(
            torch, f"the backward of {name}[sorted expert ids] at main path 11's shape",
            lambda: _bias_gather_grad(torch, bias, idx, up), (f"d{name}",))
        del bias, up
    torch.cuda.empty_cache()

    differ = {k: [n for n, d in v.items() if d] for k, v in found.items()}
    differ = {k: v for k, v in differ.items() if v}
    print(f"twice-launch phase: outputs that differ bitwise between two launches: {differ}",
          flush=True)
    bad = [k for k in differ if k.rsplit(" (", 1)[0] in DETERMINISTIC_KERNELS]
    if bad:
        raise AssertionError(f"deterministic-route kernels differ between launches: {bad}")
    return {"differ": differ, "max_abs_diff": found}


def _model_check(torch):
    """flash vs xla on the same weights: Llama-3.2-1B width, 2 layers, bf16."""
    from automodel_tpu_torch.config.loader import load_config
    from automodel_tpu_torch.data.collate import sft_collate
    from automodel_tpu_torch.data.llm.mock import MockSFTDataset
    from automodel_tpu_torch.models.common.backend import BackendConfig
    from automodel_tpu_torch.models.llama.model import LlamaForCausalLM
    from automodel_tpu_torch.ops.losses import masked_cross_entropy

    hf = dict(load_config(BENCH_YAML).model.config.to_dict(), num_hidden_layers=2)
    ds = MockSFTDataset(hf["vocab_size"], 2048, num_samples=4, seed=0)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in sft_collate([ds[i] for i in range(4)], 2048).items()}
    results = {}
    for attention in ("flash", "xla"):
        backend = BackendConfig(attention=attention, attention_segments=False,
                                remat_policy="mlp_attn_dots", dtype="bfloat16")
        model = LlamaForCausalLM.from_config(
            hf, backend, device="cuda", dtype=torch.bfloat16,
            generator=torch.Generator(device="cuda").manual_seed(0))
        params = model.param_dict()
        logits = model(batch["input_ids"], positions=batch["positions"],
                       segment_ids=batch["segment_ids"])
        loss = masked_cross_entropy(logits, batch["labels"])
        grads = torch.autograd.grad(loss, list(params.values()))
        results[attention] = (loss.item(), torch.cat([g.float().flatten() for g in grads]))
        del model, params, logits, grads
        torch.cuda.empty_cache()
    d_loss = abs(results["flash"][0] - results["xla"][0])
    rel = _rel_l2(results["flash"][1], results["xla"][1])
    print(f"model check (2 layers, Llama-3.2-1B width, bf16): loss flash "
          f"{results['flash'][0]:.6f} xla {results['xla'][0]:.6f} |diff| {d_loss:.3e} "
          f"(tol {TOL_MODEL_LOSS}), grad rel L2 {rel:.3e} (tol {TOL_MODEL_GRAD})", flush=True)
    if not (d_loss <= TOL_MODEL_LOSS and rel <= TOL_MODEL_GRAD):
        raise AssertionError("flash and xla attention disagree through the model")


def _counters():
    from automodel_tpu_torch.ops import flash_attention as fa, grouped_gemm as gg, linear_ce as lce
    from automodel_tpu_torch.ops import ring_chunk as rc

    return fa.LAUNCHES, lce.LAUNCHES, gg.LAUNCHES, rc.LAUNCHES


def _reset_counts():
    from automodel_tpu_torch.ops import flash_attention as fa, ring_chunk as rc

    for counter in (*_counters(), *_route_counters(), fa.WINDOWED_LAUNCHES,
                    fa.HEAD_DIM_LAUNCHES, fa.SOFTCAP_LAUNCHES, fa.NONCAUSAL_LAUNCHES,
                    rc.DIM_LAUNCHES):
        for key in counter:
            counter[key] = 0


def _read_ring_dims() -> dict:
    """The ring launches by (D, Dv) ("ring_fwd/d192v128", ...), those of no launch left out."""
    from automodel_tpu_torch.ops import ring_chunk as rc

    return {k: v for k, v in rc.DIM_LAUNCHES.items() if v}


def _read_windowed() -> dict:
    """The flash launches that carried a sliding window ("flash_fwd/windowed", ...)."""
    from automodel_tpu_torch.ops import flash_attention as fa

    return {f"{k}/windowed": v for k, v in fa.WINDOWED_LAUNCHES.items()}


def _read_softcap() -> dict:
    """The flash launches that carried a logit soft-cap ("flash_fwd/softcap", ...)."""
    from automodel_tpu_torch.ops import flash_attention as fa

    return {f"{k}/softcap": v for k, v in fa.SOFTCAP_LAUNCHES.items()}


def _read_noncausal() -> dict:
    """The flash launches without the causal mask ("flash_fwd/noncausal", ...)."""
    from automodel_tpu_torch.ops import flash_attention as fa

    return {f"{k}/noncausal": v for k, v in fa.NONCAUSAL_LAUNCHES.items()}


def _read_head_dims() -> dict:
    """The flash launches by head dim ("flash_fwd/d96", ...), those of no launch left out."""
    from automodel_tpu_torch.ops import flash_attention as fa

    return {k: v for k, v in fa.HEAD_DIM_LAUNCHES.items() if v}


def _check_head_dim(name, launches, head_dim):
    """Every flash launch of a path is at its model's head dim: main paths 13 and 14 run
    Phi-3-mini's 96 through the 128-wide kernels."""
    want = {f"{k}/d{head_dim}": launches[k] for k in ("flash_fwd", "flash_dq", "flash_dkv")
            if launches[k]}
    got = {k: v for k, v in launches.items() if k.startswith("flash_") and "/d" in k}
    print(f"{name}: flash launches by head dim {got} (head_dim {head_dim})", flush=True)
    if got != want:
        raise AssertionError(f"{name}: flash launches by head dim {got} != {want}")


def _check_ring_dims(name, launches, model):
    """Every ring launch of a path is at its model's (D, Dv): (192, 128) for DeepSeek's
    MLA at DeepSeek's widths, (head_dim, head_dim) otherwise."""
    if _is_mla(model):
        d = int(model["qk_nope_head_dim"]) + int(model["qk_rope_head_dim"])
        dv = int(model["v_head_dim"])
    else:
        d = dv = _port_config(model).head_dim
    want = {f"{k}/d{d}v{dv}": launches[k] for k in ("ring_fwd", "ring_bwd", "ring_dq",
                                                     "ring_dkv") if launches[k]}
    got = {k: v for k, v in launches.items() if k.startswith("ring_") and "/d" in k}
    print(f"{name}: ring launches by (D, Dv) {got}", flush=True)
    if got != want:
        raise AssertionError(f"{name}: ring launches by (D, Dv) {got} != {want}")


def _read_counts() -> dict:
    return {k: v for counter in _counters() for k, v in counter.items()}


def _route_counters():
    from automodel_tpu_torch.ops import grouped_gemm as gg, linear_ce as lce

    return gg.ROUTE_LAUNCHES, lce.ROUTE_LAUNCHES


ROUTED = ("gmm", "tgmm", "lce_fwd", "lce_bwd")  # the kernels with a wgmma and an mma_sync route


def _read_routes() -> dict:
    """Launches of the routed kernels by route ("gmm/wgmma", "lce_fwd/mma_sync", ...)."""
    return {k: v for counter in _route_counters() for k, v in counter.items()}


def _check_routes(name, launches, dh_only=False) -> dict:
    """Every launch of gmm, tgmm, lce_fwd and lce_bwd on a main path must have taken
    the wgmma route, and every lce_bwd launch computed dH alone when ``dh_only`` (a
    frozen unembedding: PEFT) and none did otherwise; returns the launches with the
    route counts and the windowed flash launches added."""
    routes = _read_routes()
    print(f"{name}: launches by route {routes}", flush=True)
    for kernel in ROUTED:
        if routes[f"{kernel}/wgmma"] != launches.get(kernel, 0):
            raise AssertionError(f"{name}: {launches.get(kernel, 0)} {kernel} launches, "
                                 f"{routes[f'{kernel}/wgmma']} of them on the wgmma route")
    want_dh = launches.get("lce_bwd", 0) if dh_only else 0
    if routes["lce_bwd/dh_only"] != want_dh:
        raise AssertionError(f"{name}: {routes['lce_bwd/dh_only']} lce_bwd launches with dH "
                             f"alone, not {want_dh}")
    return {**launches, **routes, **_read_windowed(), **_read_softcap(), **_read_noncausal(),
            **_read_head_dims(), **_read_ring_dims()}


def _port_config(model: dict):
    """The port's config of an HF config dict, read by its architecture's class (so the
    layers' kinds are the ones the model runs: GPT-OSS's layer_types, Gemma's patterns)."""
    from automodel_tpu_torch.models.auto import AutoModelForCausalLM

    model = model.to_dict() if hasattr(model, "to_dict") else dict(model)
    return AutoModelForCausalLM.model_class(model).config_class.from_hf(model)


def _capped_layers(model) -> int:
    """How many layers carry the attention logit soft-cap (Gemma-2's: every layer)."""
    config = _port_config(model)
    return config.num_hidden_layers if getattr(config, "attn_logit_softcapping", None) else 0


def _is_moe(cfg) -> bool:
    model = cfg.model.config
    return bool(model.get("num_experts") or model.get("num_local_experts")
                or model.get("n_routed_experts") or model.get("moe_num_experts"))


def _is_mla(model) -> bool:
    """A DeepSeek-family config (MLA: keys 192 wide, values 128 at DeepSeek's widths)."""
    return bool(model.get("kv_lora_rank"))


def _kernel_layers(model) -> tuple[int, int]:
    """(the layers whose attention launches flash or the ring, the MoE layers) of an HF
    config, read by its architecture's class: Qwen3-Next's gated DeltaNet layers launch
    no attention kernel, Step-3.5's MoE layers are its ``moe_layers_enum``, an MoE
    decoder's those after its dense prefix."""
    config = _port_config(model)
    layers = config.num_hidden_layers
    attn = len(config.full_layer_indices) if hasattr(config, "linear_layer_indices") else layers
    moe = getattr(config, "num_moe_layers", 0) if getattr(config, "moe", None) else 0
    return attn, moe


def _check_windowed(name, launches, sliding, micro, steps):
    """The windowed share of a path's flash launches: with n = sliding layers x
    microbatches x steps, flash_fwd 2n (forward and replay), flash_dq and flash_dkv n;
    printed apart from the unwindowed ones, which the full layers launch."""
    n = sliding * micro * steps
    want = {"flash_fwd/windowed": 2 * n, "flash_dq/windowed": n, "flash_dkv/windowed": n}
    got = {k: launches[k] for k in want}
    plain = {k: launches[k] - launches[f"{k}/windowed"] for k in ("flash_fwd", "flash_dq",
                                                                   "flash_dkv")}
    print(f"{name}: windowed flash launches {got} (expected {want}; {sliding} sliding "
          f"layers), unwindowed {plain}", flush=True)
    if got != want:
        raise AssertionError(f"{name}: windowed flash launches {got} != expected {want}")


def _check_softcap(name, launches, capped, micro, steps):
    """The capped share of a path's flash launches, as _check_windowed counts the windowed
    one: n = capped layers x microbatches x steps, flash_fwd 2n, flash_dq and flash_dkv n."""
    n = capped * micro * steps
    want = {"flash_fwd/softcap": 2 * n, "flash_dq/softcap": n, "flash_dkv/softcap": n}
    got = {k: launches[k] for k in want}
    print(f"{name}: soft-capped flash launches {got} (expected {want}; {capped} capped "
          "layers)", flush=True)
    if got != want:
        raise AssertionError(f"{name}: soft-capped flash launches {got} != expected {want}")


def _check_noncausal(name, launches, causal):
    """A causal model's flash launches are all causal; a bidirectional encoder's (the
    biencoder's tower) all non-causal."""
    want = {f"{k}/noncausal": 0 if causal else launches[k]
            for k in ("flash_fwd", "flash_dq", "flash_dkv")}
    got = {k: launches.get(k, 0) for k in want}
    print(f"{name}: non-causal flash launches {got} (expected {want})", flush=True)
    if got != want:
        raise AssertionError(f"{name}: non-causal flash launches {got} != expected {want}")


def _check_path_launches(name, launches, model, micro, steps):
    """The launch checks every main path shares, in one order, from its model's HF config
    (read by its architecture's class): the windowed flash launches those of its sliding
    layers, the soft-capped ones those of its capped layers, the non-causal ones all or
    none as the model is bidirectional or not, every flash launch at its head dim, every
    ring launch at its (D, Dv); ``micro`` microbatches a step, ``steps`` steps."""
    config = _port_config(model)
    _check_windowed(name, launches, sum(getattr(config, "sliding_flags", ())), micro, steps)
    _check_softcap(name, launches, _capped_layers(model), micro, steps)
    _check_noncausal(name, launches, getattr(config, "causal", True))
    _check_head_dim(name, launches, config.head_dim)
    _check_ring_dims(name, launches, model)


def _release():
    """Free what earlier phases left behind: a recipe's reference cycles keep its model
    and optimizer state alive until the collector runs, and the benchmark's peak memory
    counts everything alive in the process."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _expected(layers, micro, steps, linear_ce, moe=False, ring_cp=1, val_batches=0,
              deterministic=False, dense_prefix=0, mla=False, peft=False, towers=1,
              attn_layers=None):
    """Launches of each kernel in a run, n = layers x microbatches x steps.

    flash_fwd 2n (the forward, and once more when each layer's checkpoint replays it: no
    remat policy saves the kernel's lse, as in JAX), flash_dq and flash_dkv n each;
    lce_fwd and lce_bwd
    once a microbatch with linear_ce; an MoE layer's two expert GEMMs (gate_up, down)
    each launch gmm three times (the forward, the replay, dX) and tgmm once (dW): gmm 6n,
    tgmm 2n. With ring attention over cp > 1 (``ring_cp``) the ring kernels take flash's
    place, once per ring step: ring_fwd 2n x cp, ring_bwd n x cp. Validation runs forward
    only, with no layer checkpoint: ``val_batches`` (over all passes) add flash_fwd once a
    layer and lce_fwd once each. ``deterministic`` (the flag set): ring_dq and ring_dkv
    n x cp each in ring_bwd's place. ``dense_prefix``: the first layers of an MoE model
    that are dense (no grouped GEMM). ``mla``: DeepSeek's attention, whose values are
    narrower than its keys: no flash launch (the plain path, as JAX's dispatch), and on
    the ring ring_dq + ring_dkv in ring_bwd's place. ``peft``: a LoRA run, whose experts
    are frozen (no tgmm; gmm's dX still runs, for the earlier layers' adapters) and whose
    lce_bwd launches compute dH alone (checked by _check_routes). ``towers``: the
    forwards a microbatch (and a validation batch) runs through the layers, the
    biencoder's 2 (queries, then passages). ``attn_layers``: the layers whose attention
    launches a kernel, if not all (Qwen3-Next's full-attention layers; its DeltaNet
    layers launch none)."""
    attn = layers if attn_layers is None else attn_layers
    n = attn * micro * steps * towers
    n_moe = (layers - dense_prefix) * micro * steps if moe else 0
    lce_n = micro * steps if linear_ce else 0
    ring = ring_cp > 1
    flash = not (ring or mla)
    ring_bwd = n * ring_cp if ring else 0
    split = deterministic or mla
    return {"flash_fwd": 2 * n + attn * val_batches * towers if flash else 0,
            "flash_dq": n if flash else 0, "flash_dkv": n if flash else 0,
            "lce_fwd": lce_n + (val_batches if linear_ce else 0), "lce_bwd": lce_n,
            "gmm": 6 * n_moe, "tgmm": 0 if peft else 2 * n_moe,
            "ring_fwd": 2 * n * ring_cp if ring else 0,
            "ring_bwd": 0 if split else ring_bwd,
            "ring_dkv": ring_bwd if split else 0,
            "ring_dq": ring_bwd if split else 0}


def _ring_cp(cfg) -> int:
    """The cp of a config whose attention runs the ring, else 1."""
    if cfg.get("backend.context_parallel", "allgather") != "ring":
        return 1
    return int(cfg.get("distributed.cp", 1) or 1)


def random_init_loss(vocab: int, hidden: int, std: float, self_logit: float = 0.0) -> float:
    """The cross entropy of random labels under random weights: the logits of the normed
    hidden state through W ~ N(0, std^2) have variance hidden * std^2, so the loss is
    about ln(vocab) + hidden * std^2 / 2 (0.41 over ln(vocab) at hidden 2048, 0.82 at
    4096). ``self_logit``: one logit more, the input token's own (:func:`tied_self_logit`),
    summed into the logsumexp."""
    base = math.log(vocab) + hidden * std**2 / 2
    if not self_logit:
        return base
    return max(base, self_logit) + math.log1p(math.exp(-abs(base - self_logit)))


def tied_self_logit(model) -> float:
    """The input token's own logit in a random-init Gemma: its embedding is scaled by
    sqrt(d) and tied to the unembedding, so the final hidden state keeps the token's
    embedding row E, of squared norm d std^2, beside the 2L sublayer outputs that the
    sandwich norms add to the residual at unit rms each: after the final norm the logit
    is sqrt(d) d std^2 / sqrt(d std^2 + 2L) (39.9 at Gemma-2-27B's widths at 4 layers,
    where it outweighs the vocabulary's; 2.7 at the Gemma-3 proxy's). 0 for other
    families (no scale: the sublayers outweigh the embedding) and an untied head."""
    from automodel_tpu_torch.models.gemma.model import GemmaConfig

    config = _port_config(model)
    if not isinstance(config, GemmaConfig) or not config.tie_word_embeddings:
        return 0.0
    d, square = config.hidden_size, config.hidden_size * config.initializer_range**2
    return math.sqrt(d) * square / math.sqrt(square + 2 * config.num_hidden_layers)


def _shown(yaml: str) -> str:
    """A config's path for the log: relative to the checkout, or the derived file's name."""
    rel = os.path.relpath(yaml, HERE)
    return os.path.basename(yaml) if rel.startswith("..") else rel


def _jax_count_mfu(model, seq_len, mfu):
    """The MFU of a run as JAX's ``utils/flops.py`` counts it: its formula reads no
    ``num_local_experts``, so a Mixtral or GPT-OSS layer's MLP counts as one dense MLP of
    ``intermediate_size`` where the port counts the top-k experts; the same figure for
    every other model."""
    from automodel_tpu_torch.utils.flops import flops_per_token

    model = model.to_dict() if hasattr(model, "to_dict") else dict(model)
    jax_model = {k: v for k, v in model.items() if k != "num_local_experts"}
    if mfu is None:
        return None
    return mfu * flops_per_token(jax_model, seq_len) / flops_per_token(model, seq_len)


def _logit_std(model) -> float:
    """The init std of the logits' weights as the loss sees them: the initializer range
    over ``logits_scaling`` (Granite's 8; Cohere's logit_scale 0.25 is 1 / 4), which the
    unembedding is divided by."""
    std = float(model.get("initializer_range", 0.02))
    return std / getattr(_port_config(model), "logits_scaling", 1.0)


def _bench_path(name, yaml, linear_ce, overrides=(), warmup=WARMUP, timed=TIMED,
                on_setup=None, on_profile=None):
    """The benchmark recipe at full width, through its recipe class as its entry point
    runs it, ``warmup`` + ``timed`` steps; ``on_setup(recipe)``: a hook run after the
    recipe's setup; ``on_profile(summary)``: with it, the last timed step runs in the
    recipe's profile window and the hook gets the window's ``summary.json``."""
    from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
    from automodel_tpu_torch.recipes.llm import benchmark

    _release()
    cfg = parse_args_and_load_config(["-c", yaml, *overrides])
    layers = int(cfg.model.config.num_hidden_layers)
    micro = int(cfg.get("step_scheduler.grad_acc_steps", 1))
    with tempfile.TemporaryDirectory() as out_dir:
        argv = ["-c", yaml, *overrides, "--benchmark.warmup_steps", str(warmup),
                "--benchmark.timed_steps", str(timed), "--output_dir", out_dir]
        if on_profile is not None:
            argv += ["--benchmark.profile_start", str(timed - 1),
                     "--benchmark.profile_dir", os.path.join(out_dir, "profile")]
        _reset_counts()
        recipe = benchmark.BenchmarkingRecipeForNextTokenPrediction(
            parse_args_and_load_config(argv))
        recipe.setup()
        if on_setup is not None:
            on_setup(recipe)
        result = recipe.run_benchmark()
        del recipe
        launches = _read_counts()
        if on_profile is not None:
            with open(os.path.join(out_dir, "profile", "summary.json")) as f:
                on_profile(json.load(f))
    vocab = int(cfg.model.config.vocab_size)
    attn_layers, moe_layers = _kernel_layers(cfg.model.config)
    want = _expected(layers, micro, warmup + timed, linear_ce, moe=moe_layers > 0,
                     ring_cp=_ring_cp(cfg), dense_prefix=layers - moe_layers,
                     mla=_is_mla(cfg.model.config), attn_layers=attn_layers)
    arch = (cfg.model.config.get("architectures") or ["LlamaForCausalLM"])[0]
    print(f"{name}: benchmark recipe on {_shown(yaml)} ({arch}, "
          f"{layers} layers, {micro} microbatch, mb {cfg.micro_batch_size}, seq "
          f"{cfg.seq_len}, loss {cfg.get('loss.name')}, tied "
          f"{cfg.model.config.get('tie_word_embeddings')}), {warmup} warmup + {timed} timed "
          f"steps: {result['tokens_per_sec']:.1f} tokens/s, step "
          f"{result['step_time_s'] * 1e3:.1f} ms, MFU {result['mfu']} (as JAX counts it: "
          f"{_jax_count_mfu(cfg.model.config, int(cfg.seq_len), result['mfu'])}), peak memory "
          f"{result['peak_memory_gib']} GiB, losses {result['losses']}, launches {launches} "
          f"(expected {want})", flush=True)
    hidden = int(cfg.model.config.hidden_size)
    std = _logit_std(cfg.model.config)
    # an MoE model's loss carries coef x its layers' aux losses, each ~1 (f_i P_i summed
    # over E experts is 1 when the routing is balanced, as at init)
    aux = float(cfg.model.config.get("router_aux_loss_coef", 0.0)) * moe_layers
    want_loss = random_init_loss(vocab, hidden, std, tied_self_logit(cfg.model.config)) + aux
    if not all(math.isfinite(x) for x in result["losses"]):
        raise AssertionError(f"non-finite loss on {name}")
    if abs(result["loss"] - want_loss) > 0.5:
        raise AssertionError(f"{name}: loss {result['loss']} is not within 0.5 of "
                             f"ln({vocab}) + {hidden} * {std}^2 / 2 (with the tied self "
                             f"logit {tied_self_logit(cfg.model.config):.3f}) + {aux:g} (aux) "
                             f"= {want_loss:.3f}")
    if launches != want:
        raise AssertionError(f"{name}: kernel launches {launches} != expected {want}")
    routed = _check_routes(name, launches)
    _check_path_launches(name, routed, cfg.model.config, micro, warmup + timed)
    return routed, result["losses"]


def _train_ft_path(name, yaml, overrides, deterministic=False):
    """train_ft through its entry point with the default loss (the vocab rule picks
    linear_ce), packed rows, TRAIN_FT_STEPS steps; an MoE model must log moe_load/*
    rows. The peak device memory is the run's, model and optimizer included. Returns the
    launches (with routes) and the logged losses; ``deterministic``: the process runs
    with the deterministic-algorithms flag set, and the launches expected are its route's."""
    import torch

    from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
    from automodel_tpu_torch.recipes.llm import train_ft

    _release()
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = parse_args_and_load_config([
            "-c", yaml, *overrides, "--step_scheduler.max_steps", str(TRAIN_FT_STEPS),
            "--checkpoint.enabled", "false", "--output_dir", out_dir])
        if cfg.get("loss") is not None:
            cfg.loss._data.pop("name", None)  # the default rule picks the loss
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        recipe = train_ft.main(cfg=cfg)
        launches = _read_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        with open(os.path.join(out_dir, "training.jsonl")) as f:
            rows = [r for r in map(json.loads, f) if "loss" in r]
    layers = int(cfg.model.config.num_hidden_layers)
    micro = int(cfg.get("step_scheduler.grad_acc_steps", 1))
    moe = _is_moe(cfg)
    attn_layers, moe_layers = _kernel_layers(cfg.model.config)
    want = _expected(layers, micro, TRAIN_FT_STEPS, True, moe, ring_cp=_ring_cp(cfg),
                     deterministic=deterministic, dense_prefix=layers - moe_layers,
                     mla=_is_mla(cfg.model.config), attn_layers=attn_layers)
    losses = [r["loss"] for r in rows]
    moe_rows = [sorted(k for k in r if k.startswith("moe_load/")) for r in rows]
    print(f"{name}: train_ft on {_shown(yaml)} ({layers} layers), default loss "
          f"{recipe.loss_name}, packed rows of {recipe.seq_len}, {len(rows)} training.jsonl "
          f"rows: losses {losses}, step times {[r['step_time_s'] for r in rows]} s, "
          f"peak memory {peak_gib} GiB, moe_load rows {len(moe_rows[0]) if moe_rows else 0} keys, launches {launches} "
          f"(expected {want})", flush=True)
    if recipe.loss_name != "linear_ce" or len(rows) != TRAIN_FT_STEPS:
        raise AssertionError(f"{name}: wrong loss or missing training.jsonl rows")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss")
    if moe and not all(moe_rows):
        raise AssertionError(f"{name}: training.jsonl rows without moe_load/* metrics")
    if launches != want:
        raise AssertionError(f"{name}: kernel launches {launches} != expected {want}")
    routed = _check_routes(name, launches)
    _check_path_launches(name, routed, cfg.model.config, micro, TRAIN_FT_STEPS)
    return routed, losses


def _recorded_train_ft(cfg, on_setup=None, recipe_cls=None):
    """Run train_ft (or ``recipe_cls``, one of its subclasses: train_seq_cls,
    train_biencoder) through its recipe class, recording each step's loss unrounded (the
    training.jsonl rows round to 6 digits). Returns (recipe, {step: loss}, rows of
    training.jsonl, rows of validation.jsonl)."""
    from automodel_tpu_torch.recipes.llm import train_ft

    recipe = (recipe_cls or train_ft.TrainFinetuneRecipeForNextTokenPrediction)(cfg)
    recipe.setup()
    if on_setup is not None:
        on_setup(recipe)
    first = recipe.step_scheduler.step + 1
    losses = []
    recipe.recorded_kinds = []  # which step function ran each step: QAT's switch

    def recorder(step_fn, kind):
        def recorded(opt_state, stack):
            opt_state, m = step_fn(opt_state, stack)
            losses.append(float(m["loss"]))
            recipe.recorded_kinds.append(kind)
            return opt_state, m
        return recorded

    recipe._train_step = recorder(recipe._train_step, "train")
    if recipe._pre_qat_step is not None:
        recipe._pre_qat_step = recorder(recipe._pre_qat_step, "before_qat")
    recipe.run_train_validation_loop()
    rows = {}
    for name in ("training", "validation"):
        with open(os.path.join(recipe.output_dir, f"{name}.jsonl")) as f:
            rows[name] = [r for r in map(json.loads, f) if "run_header" not in r]
    return recipe, {first + i: x for i, x in enumerate(losses)}, rows["training"], \
        rows["validation"]


def _pretrained_run(name, cfg_args, ckpt, reload_dtype=None, on_setup=None, recipe_cls=None,
                    reload=None) -> dict:
    """One train_ft run of the config ``cfg_args`` gives, through _recorded_train_ft with
    the counts reset first: what main paths 9, 14, 16, 20 and 23 share. Returns a dict:
    losses ({step: loss}), rows and val (the jsonl rows), launches, routed (the launches
    with their routes, window, cap and head-dim counts; _check_routes passed), saves
    [(step, seconds, bytes)], peak / setup / end GiB (allocated at the peak, after setup,
    after the run), the recipe's loss_name and moe; with ``reload_dtype``, also the newest
    save's hf/ (hf_dir, its tensors' hf_names and hf_bytes) and hf_differ, the parameters
    whose reload through from_pretrained in that dtype is not bitwise the final one
    (``reload(path, dtype, device)``: the model class's loader, by default
    AutoModelForCausalLM's). ``recipe_cls``: the recipe, train_ft's by default."""
    import torch

    from automodel_tpu_torch.checkpoint.safetensors_io import load_safetensors
    from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
    from automodel_tpu_torch.models.auto import AutoModelForCausalLM

    cuda = torch.cuda.is_available()  # the CPU tests run it too, at small widths

    def gib(stat):
        return stat() / 2**30 if cuda else 0.0

    cfg = parse_args_and_load_config(cfg_args)
    _reset_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup = {}

    def after_setup(recipe):
        setup["gib"] = gib(torch.cuda.memory_allocated)
        if on_setup is not None:
            on_setup(recipe)

    recipe, losses, rows, val = _recorded_train_ft(cfg, after_setup, recipe_cls)
    launches = _read_counts()
    out = dict(losses=losses, rows=rows, val=val, launches=launches,
               routed=_check_routes(name, launches, dh_only=recipe.peft is not None),
               saves=[(x["step"], x["seconds"], x["bytes"]) for x in rows
                      if x.get("event") == "checkpoint_save"],
               peak_gib=gib(torch.cuda.max_memory_allocated), setup_gib=setup["gib"],
               end_gib=gib(torch.cuda.memory_allocated), loss_name=recipe.loss_name,
               moe=recipe.moe, kinds=recipe.recorded_kinds, seq_len=recipe.seq_len)
    final = recipe.params
    if recipe.peft is not None:  # the adapter, and the model hf/ holds: the merged one
        from automodel_tpu_torch.peft.lora import merge_lora_params

        out["adapter"] = {k: v.detach().clone() for k, v in recipe.train_params.items()}
        if reload_dtype is not None:
            with torch.no_grad():
                final = merge_lora_params(recipe.params, recipe.train_params, recipe.peft)
    if reload_dtype is not None:
        step_hf = os.path.join(ckpt, f"step_{max(x[0] for x in out['saves'])}", "hf")
        load = reload or (lambda path, dtype, device: AutoModelForCausalLM.from_pretrained(
            path, dtype=dtype, device=device))
        reloaded = load(step_hf, reload_dtype, recipe.device).param_dict()
        out.update(hf_dir=step_hf, hf_names=sorted(load_safetensors(step_hf)),
                   hf_bytes=sum(os.path.getsize(os.path.join(step_hf, f))
                                for f in os.listdir(step_hf)),
                   hf_differ=sorted(k for k, v in final.items()
                                    if not torch.equal(v, reloaded[k])))
        del reloaded
    del final
    del recipe
    _release()
    return out


def _check_pretrained_run(name, run, steps, want, *, model, micro, saves=None,
                          first_loss=None):
    """The checks main paths 9, 14, 16, 20 and 23-30 share: the steps taken, finite
    losses, the first within 0.5 of ``first_loss``, checkpoints at ``saves``, hf/ reloaded
    bitwise (when reloaded), the launches ``want``, and :func:`_check_path_launches` of the
    run's ``model`` (its HF config) at ``micro`` microbatches a step."""
    if sorted(run["losses"]) != list(steps):
        raise AssertionError(f"{name}: stepped {sorted(run['losses'])}, not {list(steps)}")
    if not all(math.isfinite(x) for x in run["losses"].values()):
        raise AssertionError(f"{name}: non-finite loss")
    first = run["losses"][min(steps)]
    if first_loss is not None and abs(first - first_loss) > 0.5:
        raise AssertionError(f"{name}: first loss {first} is not within 0.5 of {first_loss:.3f}")
    if saves is not None and [x[0] for x in run["saves"]] != saves:
        raise AssertionError(f"{name}: checkpoints saved at {run['saves']}, not steps {saves}")
    if run.get("hf_differ"):
        raise AssertionError(f"{name}: hf/ reloaded differs from the final parameters in "
                             f"{run['hf_differ']}")
    if run["launches"] != want:
        raise AssertionError(f"{name}: kernel launches {run['launches']} != expected {want}")
    _check_path_launches(name, run["routed"], model, micro, len(steps))


def _shown_run(run) -> str:
    """A run's losses, step times, MFU, saves and memory, for its log line."""
    return (f"losses {run['losses']}, step times "
            f"{[x['step_time_s'] for x in run['rows'] if 'loss' in x]} s, MFU "
            f"{[x.get('mfu') for x in run['rows'] if 'loss' in x]}, saves {run['saves']} (step, "
            f"s, bytes), peak memory {run['peak_gib']:.2f} GiB (allocated after setup "
            f"{run['setup_gib']:.2f} GiB, after the run {run['end_gib']:.2f} GiB)")


def _baseline_path(name):
    """BASELINE config #1 through train_ft (main path 9): a local pretrained directory,
    HellaSwag rows through the tokenizer, the prefetch pipeline, validation and a
    checkpoint (with the consolidated HF export) every 2 steps. Run A runs 4 steps fresh;
    then its step_4 is removed and run B resumes in the same checkpoint directory from
    step 2. Run B's step-3 and step-4 losses must equal run A's bitwise, with or without
    the deterministic-algorithms flag. Returns the launches of both runs."""
    import shutil

    import torch

    _release()
    with tempfile.TemporaryDirectory() as tmp:
        hf_dir = write_pretrained(os.path.join(tmp, "llama3_2_1b"), BASELINE_MODEL)
        yaml = baseline_config(
            tmp, hf_dir, write_hellaswag_jsonl(os.path.join(tmp, "train.jsonl"), 512, seed=0),
            write_hellaswag_jsonl(os.path.join(tmp, "val.jsonl"), 64, seed=1))
        ckpt = os.path.join(tmp, "ckpts")
        runs = {}
        for run in ("A", "B"):
            if run == "B":  # the walk-back must find step 2
                shutil.rmtree(os.path.join(ckpt, f"step_{BASELINE_STEPS}"))
            runs[run] = _pretrained_run(
                f"{name} run {run}", ["-c", yaml, *baseline_args(ckpt), "--output_dir",
                                      os.path.join(tmp, f"run_{run}")], ckpt,
                reload_dtype=torch.float32 if run == "A" else None)
    layers = BASELINE_LAYERS
    micro = 4  # the config's grad_acc_steps
    a, b = runs["A"], runs["B"]
    for run, r in runs.items():
        restores = [x for x in r["rows"] if x.get("event") == "checkpoint_restore"]
        print(f"{name} run {run}: train_ft on {_shown(BASELINE_YAML)} (model and data sections "
              f"swapped; {layers} layers, prefetch), {_shown_run(r)}, validation "
              f"{[(x['step'], x['val_loss']) for x in r['val']]}, restores "
              f"{[(x['step'], x['seconds']) for x in restores]} (step, s), launches "
              f"{r['launches']}", flush=True)
    print(f"{name}: step_{BASELINE_STEPS}/hf {a['hf_bytes']} bytes, reloaded through "
          f"from_pretrained: {'bitwise equal' if not a['hf_differ'] else a['hf_differ']}; run B "
          f"from step {min(b['losses'])}: step-3 loss |diff| "
          f"{abs(b['losses'].get(3, math.nan) - a['losses'][3]):.3e} (bitwise "
          f"{b['losses'].get(3) == a['losses'][3]}), step-4 |diff| "
          f"{abs(b['losses'].get(4, math.nan) - a['losses'][4]):.3e} (bitwise "
          f"{b['losses'].get(4) == a['losses'][4]}; must be bitwise)", flush=True)
    _check_pretrained_run(f"{name} run A", a, range(1, BASELINE_STEPS + 1),
                          _expected(layers, micro, BASELINE_STEPS, True,
                                    val_batches=2 * BASELINE_VAL_BATCHES),
                          saves=[2, BASELINE_STEPS], model=BASELINE_MODEL, micro=micro)
    _check_pretrained_run(f"{name} run B (B must resume from step 2)", b, range(3, 5),
                          _expected(layers, micro, 2, True, val_batches=BASELINE_VAL_BATCHES),
                          model=BASELINE_MODEL, micro=micro)
    for step in (3, 4):
        if b["losses"][step] != a["losses"][step]:
            raise AssertionError(f"{name}: the resumed step-{step} loss differs from the "
                                 "uninterrupted")
    val_steps = [x["step"] for x in a["val"] if x.get("val_loss") is not None
                 and math.isfinite(x["val_loss"])]
    if val_steps != [2, 4]:
        raise AssertionError(f"{name}: finite validation.jsonl rows at steps {val_steps}")
    return {k: a["routed"][k] + b["routed"][k] for k in a["routed"]}


def _phi3_train_ft_path(name):
    """examples/llm_finetune/phi3_mini_sft.yaml through train_ft (main path 14): its model a
    local HF directory of a random-init Phi-3-mini at PHI3_LAYERS_TRAIN_FT layers in HF's
    fused layout (qkv_proj, gate_up_proj), written by write_pretrained; packed 1000-token
    documents, PHI3_STEPS steps of 2 microbatches, a checkpoint with the consolidated HF
    export every 2 steps (phi3_sft_args). Checks: finite losses, the first within 0.5 of
    the random-init loss, the launches (every flash launch windowed and at head_dim 96),
    step_N/hf holding the fused names only, and its reload through from_pretrained
    bitwise equal to the final parameters."""
    import torch

    _release()
    layers, micro = PHI3_LAYERS_TRAIN_FT, 2
    with tempfile.TemporaryDirectory() as tmp:
        hf_dir = write_pretrained(os.path.join(tmp, "phi3_mini"),
                                  dict(PHI3_MINI, num_hidden_layers=layers))
        ckpt = os.path.join(tmp, "ckpts")
        run = _pretrained_run(name, ["-c", PHI3_SFT_YAML, *phi3_sft_args(hf_dir, ckpt),
                                     "--output_dir", os.path.join(tmp, "run")], ckpt,
                              reload_dtype=torch.float32)
    want = _expected(layers, micro, PHI3_STEPS, False)
    fused = [n for n in run["hf_names"] if n.endswith(("qkv_proj.weight", "gate_up_proj.weight"))]
    split = [n for n in run["hf_names"] if n.endswith((
        ".q_proj.weight", ".k_proj.weight", ".v_proj.weight", ".gate_proj.weight",
        ".up_proj.weight"))]
    print(f"{name}: train_ft on {_shown(PHI3_SFT_YAML)} ({layers} layers from a local HF "
          f"directory, loss {run['loss_name']}, packed rows of 4096), {_shown_run(run)}, "
          f"step_{PHI3_STEPS}/hf fused tensors {len(fused)}, split ones {len(split)}, "
          f"reloaded through from_pretrained: "
          f"{'bitwise equal' if not run['hf_differ'] else run['hf_differ']}, launches "
          f"{run['launches']} (expected {want})", flush=True)
    _check_pretrained_run(name, run, range(1, PHI3_STEPS + 1), want, saves=[2, PHI3_STEPS],
                          first_loss=random_init_loss(PHI3_MINI["vocab_size"],
                                                      PHI3_MINI["hidden_size"],
                                                      PHI3_MINI["initializer_range"]),
                          model=dict(PHI3_MINI, num_hidden_layers=layers), micro=micro)
    if len(fused) != 2 * layers or split:
        raise AssertionError(f"{name}: step_{PHI3_STEPS}/hf holds fused {fused}, split {split}")
    return run["routed"]


def _moonlight_train_ft_path(name):
    """examples/llm_finetune/deepseek_v3_ep.yaml through train_ft (main path 16): its model a
    local HF directory of a random-init Moonlight-16B-A3B at MOONLIGHT_LAYERS layers in
    DeepSeek's HF names, written by write_pretrained; real routing (sigmoid noaux-tc, no
    fake gate) with the gate-bias update at its factor 0.001; packed 500-token documents,
    MOONLIGHT_STEPS steps of 2 microbatches, one checkpoint with the consolidated HF export
    at the last step (moonlight_sft_args). Checks: finite losses, the first within 0.5 of
    the random-init loss; after each step every element of each MoE layer's correction
    bias moved by sign(mean - load) * 0.001 of that step's expert load summed over its
    microbatches, within 1e-6 (weight decay, which JAX's mask applies to the stacked
    bias, moves it by lr * wd * bias, far below that), and not all zero after step 1;
    the launches (no flash: MLA's values are narrower than its keys); step_N/hf holding
    DeepSeek's names, the correction bias among them, and its reload through
    from_pretrained bitwise equal to the final parameters."""
    import torch

    from automodel_tpu_torch.checkpoint.safetensors_io import load_safetensors

    _release()
    layers, micro, factor = MOONLIGHT_LAYERS, 2, 0.001
    model = dict(MOONLIGHT_16B_A3B, num_hidden_layers=layers)
    trace = []  # (bias before, bias after, summed expert load) a step
    with tempfile.TemporaryDirectory() as tmp:
        hf_dir = write_pretrained(os.path.join(tmp, "moonlight"), model)
        ckpt = os.path.join(tmp, "ckpts")
        run = _pretrained_run(name, ["-c", DSV3_EP_YAML, *moonlight_sft_args(hf_dir, ckpt),
                                     "--output_dir", os.path.join(tmp, "run")], ckpt,
                              reload_dtype=torch.bfloat16, on_setup=_bias_tracer(trace))
        hf_bias = [n for n in run["hf_names"] if n.endswith("mlp.gate.e_score_correction_bias")]
        hf_tensors = load_safetensors(run["hf_dir"])
        bias_dtypes = sorted({str(hf_tensors[n].dtype) for n in hf_bias})
        del hf_tensors
    moved = _bias_moves(trace, factor)
    first_bias = trace[0][1] if trace else None
    factor_used = run["moe"].gate_bias_update_factor
    want = _expected(layers, micro, MOONLIGHT_STEPS, True, moe=True,
                     dense_prefix=model["first_k_dense_replace"], mla=True)
    print(f"{name}: train_ft on {_shown(DSV3_EP_YAML)} ({layers} layers of Moonlight-16B-A3B "
          f"from a local HF directory, bf16, loss {run['loss_name']}, gate-bias factor "
          f"{factor_used}, packed rows of 4096), {_shown_run(run)}; correction bias: max "
          f"|moved - sign(mean - load) x {factor}| per step {moved} (tol 1e-6), nonzero after "
          f"step 1: {int((first_bias != 0).sum()) if first_bias is not None else 0} of "
          f"{first_bias.numel() if first_bias is not None else 0}; step_{MOONLIGHT_STEPS}/hf "
          f"{len(run['hf_names'])} tensors, {len(hf_bias)} correction biases ({bias_dtypes}), "
          f"reloaded through from_pretrained: "
          f"{'bitwise equal' if not run['hf_differ'] else run['hf_differ']}, launches "
          f"{run['launches']} (expected {want})", flush=True)
    _check_pretrained_run(name, run, range(1, MOONLIGHT_STEPS + 1), want,
                          saves=[MOONLIGHT_STEPS],
                          first_loss=random_init_loss(model["vocab_size"], model["hidden_size"],
                                                      model["initializer_range"]),
                          model=model, micro=micro)
    if factor_used != factor or len(moved) != MOONLIGHT_STEPS or max(moved) > 1e-6:
        raise AssertionError(f"{name}: the correction bias did not move as its loads say: {moved}")
    if not bool((first_bias != 0).any()):
        raise AssertionError(f"{name}: the correction bias is all zero after step 1")
    if len(hf_bias) != layers - model["first_k_dense_replace"] or bias_dtypes != ["torch.float32"]:
        raise AssertionError(f"{name}: step_{MOONLIGHT_STEPS}/hf correction biases {hf_bias} "
                             f"{bias_dtypes}")
    if not any(n.endswith("self_attn.kv_a_proj_with_mqa.weight") for n in run["hf_names"]):
        raise AssertionError(f"{name}: step_{MOONLIGHT_STEPS}/hf lacks DeepSeek's MLA names")
    return run["routed"]


def _gemma_train_ft_path(name, model, layers, steps, yaml, cfg_args, prefix="", saves=None):
    """One Gemma model through train_ft from a local HF directory of a random-init model
    (``model`` at ``layers`` layers, written by write_pretrained with the tensor-name
    ``prefix``), the config ``cfg_args(tmp_dir, hf_dir, ckpt_dir)`` gives (gemma2_sft_args
    among it: 2 microbatches a step, a save every 2 steps), ``steps`` steps: main paths 20
    and 23. The vocab rule picks linear CE (no final cap, as JAX's train_ft). Checks:
    finite losses, the first within 0.5 of the random-init loss (with the tied self
    logit); the launches, the windowed ones those of the sliding layers and the capped
    ones those of the capped layers, every flash launch at the model's head dim; step_N/hf
    holding Gemma's sandwich-norm names and reloading bitwise."""
    import torch

    _release()
    micro = 2  # gemma2_sft_args' grad_acc_steps
    if "text_config" in model:  # a multimodal wrapper: its text model's depth
        hf_model = dict(model, text_config=dict(model["text_config"], num_hidden_layers=layers))
    else:
        hf_model = dict(model, num_hidden_layers=layers)
    text = _port_config(hf_model)
    with tempfile.TemporaryDirectory() as tmp:
        hf_dir = write_pretrained(os.path.join(tmp, "gemma"), hf_model, prefix=prefix)
        ckpt = os.path.join(tmp, "ckpts")
        run = _pretrained_run(name, [*cfg_args(tmp, hf_dir, ckpt),
                                     "--output_dir", os.path.join(tmp, "run")], ckpt,
                              reload_dtype=torch.bfloat16)
    want = _expected(layers, micro, steps, True)
    norms = [n for n in run["hf_names"] if n.endswith((
        "pre_feedforward_layernorm.weight", "post_feedforward_layernorm.weight"))]
    print(f"{name}: train_ft on {_shown(yaml)} ({layers} layers of "
          f"{text.vocab_size}-vocab, {text.hidden_size}-wide Gemma ({hf_model['architectures'][0]}"
          f"{', tensors named ' + prefix + '*' if prefix else ''}) from a local HF directory, "
          f"bf16, loss {run['loss_name']}), {_shown_run(run)}, step_{steps}/hf "
          f"{len(run['hf_names'])} tensors ({len(norms)} feed-forward sandwich norms), "
          f"reloaded through from_pretrained: "
          f"{'bitwise equal' if not run['hf_differ'] else run['hf_differ']}, launches "
          f"{run['launches']} (expected {want})", flush=True)
    _check_pretrained_run(name, run, range(1, steps + 1), want, saves=saves or [2, steps],
                          first_loss=random_init_loss(text.vocab_size, text.hidden_size,
                                                      text.initializer_range,
                                                      tied_self_logit(hf_model)),
                          model=hf_model, micro=micro)
    if run["loss_name"] != "linear_ce" or len(norms) != 2 * layers:
        raise AssertionError(f"{name}: loss {run['loss_name']}, sandwich norms {norms}")
    return run["routed"]


def _gemma2_train_ft_path(name):
    """examples/llm_finetune/gemma2_9b_sft.yaml through train_ft (main path 20), its
    dataset section swapped for mock data (gemma2_sft_config) and its model a local HF
    directory of a random-init model at Gemma-2-27B's widths, GEMMA2_LAYERS_TRAIN_FT
    layers (one sliding, one full; gemma2_sft_args: bf16, 2 microbatches of one row of
    4096, GEMMA2_STEPS steps, one checkpoint with the consolidated HF export, at the last
    step: an ~18.5 GB save takes 36-51 s, which the script's time limit cannot spare
    twice); every flash launch soft-capped. The checks are _gemma_train_ft_path's."""
    return _gemma_train_ft_path(
        name, GEMMA2_27B, GEMMA2_LAYERS_TRAIN_FT, GEMMA2_STEPS, GEMMA2_SFT_YAML,
        lambda tmp, hf_dir, ckpt: ["-c", gemma2_sft_config(tmp), *gemma2_sft_args(hf_dir, ckpt),
                                   "--step_scheduler.ckpt_every_steps", str(GEMMA2_STEPS)],
        saves=[GEMMA2_STEPS])


def _gemma3_train_ft_path(name):
    """examples/llm_finetune/gemma3_4b_sft.yaml through train_ft (main path 23), its mock
    data as it stands, attention through the flash kernels (the file names no
    backend.attention, whose default is the plain path), its model a local HF directory of a random-init Gemma-3-4B in the
    published checkpoint's layout (GEMMA3_4B: the Gemma3ForConditionalGeneration config
    with its vision_config, the text model's tensors under ``language_model.``) at
    GEMMA3_4B_LAYERS_TRAIN_FT layers (5 sliding, 1 full; gemma2_sft_args: bf16, 2
    microbatches of one row of 4096, GEMMA3_4B_STEPS steps, one save, at the last step: a
    9.9 GB save takes 21-25 s, which the script's time limit cannot spare twice since
    paths 30-32); every flash launch at head_dim 256, none capped. The checks are
    _gemma_train_ft_path's."""
    return _gemma_train_ft_path(
        name, GEMMA3_4B, GEMMA3_4B_LAYERS_TRAIN_FT, GEMMA3_4B_STEPS, GEMMA3_SFT_YAML,
        lambda tmp, hf_dir, ckpt: ["-c", GEMMA3_SFT_YAML, *gemma3_proxy_args(),
                                   *gemma2_sft_args(hf_dir, ckpt, GEMMA3_4B_STEPS),
                                   "--step_scheduler.ckpt_every_steps", str(GEMMA3_4B_STEPS)],
        prefix="language_model.", saves=[GEMMA3_4B_STEPS])


def peft_args(out_dir: str, steps: int, micro: int = 2, hf_dir: str | None = None,
              ckpt: str | None = None, dtype: str | None = "bfloat16") -> list[str]:
    """The overrides of a PEFT path: the model from the local directory ``hf_dir`` (for
    the hub id), parameters in ``dtype`` (None: the file's, float32), ``micro``
    microbatches a step, ``steps`` steps, and a save every 2 steps under ``ckpt`` (with the
    file's consolidated export) or none."""
    args = ["--step_scheduler.grad_acc_steps", str(micro), "--step_scheduler.max_steps",
            str(steps), "--output_dir", out_dir]
    if hf_dir is not None:
        args += ["--model.pretrained_model_name_or_path", hf_dir]
    if dtype is not None:
        args += ["--model.params_dtype", dtype]
    if ckpt is None:
        return args + ["--checkpoint.enabled", "false"]
    return args + ["--step_scheduler.ckpt_every_steps", "2", "--checkpoint.checkpoint_dir", ckpt]


def _shown_peft_run(run, tokens) -> str:
    """A PEFT run's log line: _shown_run's, with tokens/s and the first loss."""
    steps = [x for x in run["rows"] if "loss" in x]
    return (f"{_shown_run(run)}, tokens/s {[x.get('tps') for x in steps]} ({tokens} tokens a "
            f"step), first loss {run['losses'][min(run['losses'])]:.4f}, launches "
            f"{run['launches']}, dH-only lce_bwd {run['routed']['lce_bwd/dh_only']}")


def _lora_llama_paths(name24, name26):
    """Main paths 24 and 26 from one local HF directory of a random-init Llama-3.2-1B at
    LORA_LAYERS of its 16 layers (bf16, as published).

    24: examples/llm_finetune/llama3_2_1b_lora.yaml through train_ft (rank 8 on wq and wv,
    flash, the vocab rule's linear CE; mock data in place of the hub's HellaSwag; bf16
    parameters, grad_acc_steps 4 -> 2, LORA_STEPS steps, a save every 2 with the
    consolidated export). Run A fresh; run B resumes from step 2 after step 4 is removed,
    and must end on run A's step-4 adapter bitwise. Checks: every lce_bwd launch dH alone;
    the DCP state the adapter alone; step_4/hf (the merged model) reloaded bitwise against
    merge_lora_params of the live tensors; hf_adapter/ rank-8 factors of q_proj and
    v_proj of every layer.
    26: llama3_2_1b_qlora.yaml (nf4, rank 16) with --backend.attention flash (the file
    names none), 3 steps, no saves; the matched wq / wv stay quantized on the card."""
    import shutil

    import torch

    from automodel_tpu_torch.checkpoint.safetensors_io import load_safetensors
    from automodel_tpu_torch.quantization.qlora import is_quantized_leaf, tree_nbytes

    _release()
    model = dict(LLAMA32_1B, num_hidden_layers=LORA_LAYERS)
    micro, layers, vocab = 2, LORA_LAYERS, model["vocab_size"]
    tokens = micro * 2 * 2048
    first_loss = random_init_loss(vocab, model["hidden_size"], model["initializer_range"])
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        hf_dir = write_pretrained(os.path.join(tmp, "llama3_2_1b"), model)
        written = time.perf_counter() - t0
        yaml = mock_data_config(tmp, LORA_YAML, vocab)
        ckpt = os.path.join(tmp, "ckpts")
        runs = {}
        for run in ("A", "B"):
            if run == "B":  # the walk-back must find step 2
                shutil.rmtree(os.path.join(ckpt, f"step_{LORA_STEPS}"))
            t0 = time.perf_counter()
            runs[run] = _pretrained_run(
                f"{name24} run {run}", ["-c", yaml, *peft_args(
                    os.path.join(tmp, f"run_{run}"), LORA_STEPS, micro, hf_dir, ckpt)], ckpt,
                reload_dtype=torch.bfloat16 if run == "A" else None)
            runs[run]["seconds"] = time.perf_counter() - t0
        a, b = runs["A"], runs["B"]
        step2 = os.path.join(ckpt, "step_2")
        with open(os.path.join(step2, "signature.json")) as f:
            dcp_names = [k for k in json.load(f) if not k.startswith("__")]
        adapter = load_safetensors(os.path.join(step2, "hf_adapter",
                                                "adapter_model.safetensors"))
        shapes = {k: tuple(adapter[k].shape) for k in adapter}
        with open(os.path.join(step2, "client.json")) as f:
            client = json.load(f)
        for run, r in runs.items():
            restores = [(x["step"], x["seconds"]) for x in r["rows"]
                        if x.get("event") == "checkpoint_restore"]
            print(f"{name24} run {run}: train_ft on {_shown(LORA_YAML)} (mock data; "
                  f"{layers} layers of Llama-3.2-1B, bf16, LoRA rank 8 on wq / wv), "
                  f"{_shown_peft_run(r, tokens)}, restores {restores} (step, s), "
                  f"{r['seconds']:.1f} s", flush=True)
        differ = [k for k in a["adapter"] if not torch.equal(a["adapter"][k], b["adapter"][k])]
        layer0 = [shapes.get(_ADAPTER_KEY.format(0, proj, f))
                  for proj, f in (("q", "A"), ("q", "B"), ("v", "B"))]
        print(f"{name24}: HF directory written in {written:.1f} s; step_{LORA_STEPS}/hf "
              f"{a['hf_bytes']} bytes reloaded against merge_lora_params of the live tensors: "
              f"{'bitwise equal' if not a['hf_differ'] else a['hf_differ']}; DCP state "
              f"{len(dcp_names)} tensors, {sorted({n.rsplit('.', 1)[-1] for n in dcp_names})}; "
              f"hf_adapter {len(shapes)} tensors (layer 0's q_proj A / B, v_proj B "
              f"{layer0}); client state "
              f"{sorted(client)}; run B's step-{LORA_STEPS} adapter bitwise run A's: "
              f"{not differ} ({len(a['adapter'])} tensors)", flush=True)
        _check_pretrained_run(f"{name24} run A", a, range(1, LORA_STEPS + 1),
                              _expected(layers, micro, LORA_STEPS, True, peft=True),
                              model=model, micro=micro, saves=[2, LORA_STEPS],
                              first_loss=first_loss)
        _check_pretrained_run(f"{name24} run B (B must resume from step 2)", b,
                              range(3, LORA_STEPS + 1), _expected(layers, micro, 2, True,
                                                                  peft=True),
                              model=model, micro=micro, saves=[4])
        want_shapes = {}
        for i in range(layers):
            for proj, width in (("q", 2048), ("v", 512)):
                want_shapes[_ADAPTER_KEY.format(i, proj, "A")] = (8, 2048)
                want_shapes[_ADAPTER_KEY.format(i, proj, "B")] = (width, 8)
        if differ or shapes != want_shapes or sorted({n.rsplit(".", 1)[-1] for n in dcp_names}) \
                != ["lora_a", "lora_b"] or "peft_config" not in client or "rng" not in client:
            raise AssertionError(f"{name24}: resume differs in {differ}, or hf_adapter / DCP / "
                                 "client state are not the adapter's")
        out[name24] = {k: a["routed"][k] + b["routed"][k] for k in a["routed"]}

        facts = {}

        def quantized(recipe):
            params = recipe.params
            facts["quantized"] = sorted(k for k, v in params.items() if is_quantized_leaf(v)
                                        and v.q.device.type == "cuda")
            facts["after"] = tree_nbytes(params)
            facts["before"] = facts["after"] + sum(
                math.prod(v.shape) * 2 - v.nbytes for v in params.values()
                if is_quantized_leaf(v))

        t0 = time.perf_counter()
        run = _pretrained_run(name26, [
            "-c", mock_data_config(tmp, QLORA_YAML, vocab), "--backend.attention", "flash",
            *peft_args(os.path.join(tmp, "run_qlora"), PEFT_STEPS, micro, hf_dir)], None,
            on_setup=quantized)
        print(f"{name26}: train_ft on {_shown(QLORA_YAML)} (mock data, flash; {layers} layers, "
              f"bf16 base, nf4 on {facts['quantized']}), base {facts['before']} -> "
              f"{facts['after']} bytes (tree_nbytes), {_shown_peft_run(run, tokens)}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        _check_pretrained_run(name26, run, range(1, PEFT_STEPS + 1),
                              _expected(layers, micro, PEFT_STEPS, True, peft=True),
                              model=model, micro=micro, first_loss=first_loss)
        if facts["quantized"] != ["layers.wq", "layers.wv"]:
            raise AssertionError(f"{name26}: quantized on the card: {facts['quantized']}")
        out[name26] = run["routed"]
    return out


# the HF PEFT name of layer i's q_proj / v_proj factor A / B
_ADAPTER_KEY = "base_model.model.model.layers.{0}.self_attn.{1}_proj.lora_{2}.weight"


def _nf4_host(w):
    """The JAX package's nf4 quantization (numpy, on the host), for the check that the
    port's on the card gives the same codes and scales."""
    import numpy as np

    from automodel_tpu_torch.quantization.qlora import NF4_CODEBOOK

    flat = np.asarray(w, np.float32).reshape(-1)
    flat = np.concatenate([flat, np.zeros((-len(flat)) % 64, np.float32)])
    blocks = flat.reshape(-1, 64)
    scale = np.maximum(np.abs(blocks).max(axis=1, keepdims=True), 1e-12)
    codes = np.abs((blocks / scale)[..., None] - NF4_CODEBOOK).argmin(-1).astype(np.uint8)
    return (codes[:, 0::2] << 4) | codes[:, 1::2], scale[:, 0]


def _nf4_phase(torch):
    """nf4 codes and scales of a bf16 weight quantized on the card (Llama-3.2-1B's wv
    shape at 2 layers) against the JAX package's host algorithm, bitwise."""
    import numpy as np

    from automodel_tpu_torch.quantization.qlora import quantize_leaf

    g = torch.Generator(device="cuda").manual_seed(5)
    w = (torch.randn(2, 2048, 8, 64, device="cuda", generator=g) * 0.02).to(torch.bfloat16)
    leaf = quantize_leaf(w, "nf4", 1)
    codes, scale = _nf4_host(w.float().cpu().numpy())
    same = (np.array_equal(leaf.q.cpu().numpy(), codes)
            and np.array_equal(leaf.scale.cpu().numpy(), scale))
    print(f"nf4 on the card vs the host algorithm ({tuple(w.shape)} bf16): codes and scales "
          f"bitwise equal: {same}", flush=True)
    if not same:
        raise AssertionError("nf4 codes on the card differ from the host algorithm's")


def _qwen25_lora_path(name):
    """examples/llm_finetune/qwen2_5_7b_lora.yaml through train_ft at Qwen2.5-7B's
    published widths, all 28 layers (QWEN25_7B, built from model.config and random init
    on the card: no HF directory), bf16 parameters, mock data, mb 2 x 2048, the file's
    grad_acc_steps 4, PEFT_STEPS steps, no saves. Prints step time, tokens/s, MFU and peak
    memory for BASELINE.md's Qwen2.5 7B LoRA row (1x H100, seq 4096 there)."""
    _release()
    micro = 4
    with tempfile.TemporaryDirectory() as tmp:
        yaml = mock_data_config(tmp, QWEN25_LORA_YAML, QWEN25_7B["vocab_size"],
                           model={"config": QWEN25_7B})
        t0 = time.perf_counter()
        run = _pretrained_run(name, ["-c", yaml, *peft_args(os.path.join(tmp, "run"),
                                                            PEFT_STEPS, micro)], None)
    layers = QWEN25_7B["num_hidden_layers"]
    print(f"{name}: train_ft on {_shown(QWEN25_LORA_YAML)} (mock data; Qwen2.5-7B's widths, "
          f"all {layers} layers, bf16, LoRA rank 8 on wq / wv), "
          f"{_shown_peft_run(run, micro * 2 * 2048)}, {time.perf_counter() - t0:.1f} s",
          flush=True)
    _check_pretrained_run(name, run, range(1, PEFT_STEPS + 1),
                          _expected(layers, micro, PEFT_STEPS, True, peft=True),
                          model=QWEN25_7B, micro=micro,
                          first_loss=random_init_loss(QWEN25_7B["vocab_size"],
                                                      QWEN25_7B["hidden_size"], 0.02))
    return run["routed"]


def _dora_dropout_path(name):
    """Main path 27: llama3_2_1b_dora.yaml and llama3_2_1b_lora_dropout.yaml through
    train_ft, each at 2 of Llama-3.2-1B's 16 layers from a 2-layer local HF directory, the
    files' float32 parameters, mock data, 2 microbatches, PEFT_STEPS steps. DoRA's
    magnitudes must move; the dropout run saves at step 2 and at its last step (no
    consolidated export), and its client state must hold the lora_dropout stream."""
    import torch

    _release()
    micro, layers = 2, LLAMA32_1B["num_hidden_layers"]
    first_loss = random_init_loss(LLAMA32_1B["vocab_size"], LLAMA32_1B["hidden_size"], 0.02)
    routed = {}
    with tempfile.TemporaryDirectory() as tmp:
        hf_dir = write_pretrained(os.path.join(tmp, "llama"), LLAMA32_1B)
        start = {}

        def magnitudes(recipe):
            start.update({k: v.detach().clone() for k, v in recipe.train_params.items()
                          if k.endswith("magnitude")})

        t0 = time.perf_counter()
        dora = _pretrained_run(f"{name} (DoRA)", [
            "-c", mock_data_config(tmp, DORA_YAML, LLAMA32_1B["vocab_size"]),
            *peft_args(os.path.join(tmp, "dora"), PEFT_STEPS, micro, hf_dir, dtype=None)],
            None, on_setup=magnitudes)
        moved = {k: (dora["adapter"][k] - v).abs().max().item() for k, v in start.items()}
        print(f"{name} (DoRA): train_ft on {_shown(DORA_YAML)} (mock data; {layers} layers, "
              f"f32), {_shown_peft_run(dora, micro * 2 * 2048)}, magnitudes moved by at most "
              f"{moved}, {time.perf_counter() - t0:.1f} s", flush=True)
        ckpt = os.path.join(tmp, "ckpts")
        t0 = time.perf_counter()
        drop = _pretrained_run(f"{name} (dropout)", [
            "-c", mock_data_config(tmp, LORA_DROPOUT_YAML, LLAMA32_1B["vocab_size"]),
            *peft_args(os.path.join(tmp, "dropout"), PEFT_STEPS, micro, hf_dir, ckpt,
                       dtype=None), "--checkpoint.save_consolidated", "false"], ckpt)
        with open(os.path.join(ckpt, f"step_{PEFT_STEPS}", "client.json")) as f:
            streams = json.load(f)["rng"]["streams"]
        print(f"{name} (dropout): train_ft on {_shown(LORA_DROPOUT_YAML)} (mock data; "
              f"{layers} layers, f32, dropout 0.1), {_shown_peft_run(drop, micro * 2 * 2048)}, "
              f"random streams in client.json {sorted(streams)}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    want = _expected(layers, micro, PEFT_STEPS, True, peft=True)
    _check_pretrained_run(f"{name} (DoRA)", dora, range(1, PEFT_STEPS + 1), want,
                          model=LLAMA32_1B, micro=micro, first_loss=first_loss)
    _check_pretrained_run(f"{name} (dropout)", drop, range(1, PEFT_STEPS + 1), want,
                          model=LLAMA32_1B, micro=micro, saves=[2, PEFT_STEPS],
                          first_loss=first_loss)
    if len(moved) != 2 or not all(x > 0 for x in moved.values()):
        raise AssertionError(f"{name}: DoRA's magnitudes did not move: {moved}")
    if "lora_dropout" not in streams:
        raise AssertionError(f"{name}: no lora_dropout stream in the client state: {streams}")
    for run in (dora, drop):
        for k, v in run["routed"].items():
            routed[k] = routed.get(k, 0) + v
    return routed


def _qwen3_moe_lora_path(name):
    """examples/llm_finetune/qwen3_moe_lora_dropout.yaml through train_ft at
    Qwen3-30B-A3B's widths (QWEN3_30B_A3B, from model.config), 2 of 48 layers, ep 4 -> 1,
    the pallas experts, mock data, mb 1 x 4096, grad_acc_steps 8 -> 2, PEFT_STEPS steps,
    no saves. The experts are frozen: gmm runs forward and dX, tgmm never; the model has no
    gate-bias update to turn off."""
    _release()
    micro, layers = 2, MOE_LAYERS_TRAIN_FT
    model = {"config": dict(QWEN3_30B_A3B, architectures=["Qwen3MoeForCausalLM"],
                            num_hidden_layers=layers, decoder_sparse_step=1, mlp_only_layers=[])}
    with tempfile.TemporaryDirectory() as tmp:
        yaml = mock_data_config(tmp, QWEN3_MOE_LORA_YAML, QWEN3_30B_A3B["vocab_size"], model)
        t0 = time.perf_counter()
        run = _pretrained_run(name, ["-c", yaml, "--distributed.ep", "1",
                                     "--backend.experts_backend", "pallas",
                                     *peft_args(os.path.join(tmp, "run"), PEFT_STEPS, micro,
                                                dtype=None)], None)
    print(f"{name}: train_ft on {_shown(QWEN3_MOE_LORA_YAML)} (mock data; Qwen3-30B-A3B's "
          f"widths, {layers} layers, ep 1, LoRA rank 8 on wq / wv, dropout 0.05), "
          f"{_shown_peft_run(run, micro * 4096)}, {time.perf_counter() - t0:.1f} s", flush=True)
    aux = QWEN3_30B_A3B["router_aux_loss_coef"] * layers
    _check_pretrained_run(name, run, range(1, PEFT_STEPS + 1),
                          _expected(layers, micro, PEFT_STEPS, True, moe=True, peft=True),
                          model=model["config"], micro=micro,
                          first_loss=random_init_loss(QWEN3_30B_A3B["vocab_size"],
                                                      QWEN3_30B_A3B["hidden_size"], 0.02) + aux)
    return run["routed"]


def _gemma3_qat_path(name):
    """examples/llm_finetune/gemma3_4b_qat.yaml through train_ft from a local HF directory
    of a random-init Gemma-3-4B in the published layout at GEMMA3_4B_LAYERS_TRAIN_FT layers
    (path 23's), the file's float32 parameters, mock data, mb 2 x 2048, 2 microbatches,
    fake_quant_after_n_steps 100 -> 2, QAT_STEPS steps, no saves. Step 1 runs the step
    function without fake quantization, steps 2-4 with int8 fake quantization (JAX's rule:
    a step s >= n, counted from 1, is quantized); the fake-quantized weights lie on the
    int8 grid, and the stored weights do not."""
    import torch

    from automodel_tpu_torch.quantization.qat import fake_quant

    _release()
    micro, layers = 2, GEMMA3_4B_LAYERS_TRAIN_FT
    hf_model = dict(GEMMA3_4B, text_config=dict(GEMMA3_4B["text_config"],
                                                num_hidden_layers=layers))
    text = _port_config(hf_model)
    held = {}
    with tempfile.TemporaryDirectory() as tmp:
        hf_dir = write_pretrained(os.path.join(tmp, "gemma"), hf_model, prefix="language_model.")
        t0 = time.perf_counter()
        run = _pretrained_run(name, [
            "-c", mock_data_config(tmp, GEMMA3_QAT_YAML, text.vocab_size),
            "--qat.fake_quant_after_n_steps", "2",
            *peft_args(os.path.join(tmp, "run"), QAT_STEPS, micro, hf_dir, dtype=None)], None,
            on_setup=lambda recipe: held.update(recipe=recipe))
    recipe = held.pop("recipe")
    with torch.no_grad():
        w = recipe.params["layers.wq"].float()
        q = fake_quant(w, 8, 32)

        def off_grid(x):  # distance from the int8 grid of x's groups of 32, in grid steps
            g = x.reshape(-1, 32)
            scale = g.abs().amax(-1, keepdim=True).clamp_min(1e-12) / 127
            return ((g / scale) - (g / scale).round()).abs().max().item()

        off = {"fake-quantized": off_grid(q), "stored": off_grid(w)}
    del recipe, w, q
    _release()
    print(f"{name}: train_ft on {_shown(GEMMA3_QAT_YAML)} (mock data, {layers} layers, f32, "
          f"int8 fake quant from step 2), step functions {run['kinds']}, "
          f"{_shown_peft_run(run, micro * 2 * 2048)}, layers.wq off the int8 grid by {off} "
          f"grid steps, {time.perf_counter() - t0:.1f} s", flush=True)
    want = _expected(layers, micro, QAT_STEPS, True)
    _check_pretrained_run(name, run, range(1, QAT_STEPS + 1), want,
                          first_loss=random_init_loss(text.vocab_size, text.hidden_size,
                                                      text.initializer_range,
                                                      tied_self_logit(hf_model)),
                          model=hf_model, micro=micro)
    if run["kinds"] != ["before_qat"] + ["train"] * (QAT_STEPS - 1):
        raise AssertionError(f"{name}: step functions {run['kinds']}")
    if off["fake-quantized"] > 1e-3 or off["stored"] < 0.1:
        raise AssertionError(f"{name}: off the int8 grid by {off}")
    return run["routed"]


def _peft_paths() -> dict:
    """Main paths 24-29, each with its seconds."""
    by_path = {}
    for names, fn in ((("main path 24", "main path 26"), _lora_llama_paths),
                      (("main path 25",), _qwen25_lora_path),
                      (("main path 27",), _dora_dropout_path),
                      (("main path 28",), _qwen3_moe_lora_path),
                      (("main path 29",), _gemma3_qat_path)):
        t0 = time.perf_counter()
        got = fn(*names)
        by_path.update(got if len(names) > 1 else {names[0]: got})
        print(f"{' and '.join(names)}: {time.perf_counter() - t0:.1f} s", flush=True)
    return by_path


def _command_r7b_train_ft_path(name):
    """examples/llm_finetune/cohere2_r7b_sft.yaml through train_ft (main path 30), its
    HellaSwag section swapped for mock data (mock_data_config) and its model a local HF
    directory of a random-init Command R7B (COMMAND_R7B) at COMMAND_R7B_LAYERS layers:
    three sliding RoPE layers at window 4096 and one full NoPE layer, the parallel block,
    the mean-centred LayerNorm, interleaved RoPE, the tied unembedding divided by the
    logit scale's inverse in the linear CE (command_r7b_sft_args: bf16, rows of 8192, 2
    microbatches, 4 steps, one save). Checks: finite losses, the first within 0.5 of the
    random-init loss at the scaled logits, the launches (the windowed ones those of the
    three sliding layers, all at head_dim 128), step_4/hf holding Cohere's names (one norm
    a layer, no lm_head) and reloading bitwise."""
    import torch

    _release()
    layers, micro, steps = COMMAND_R7B_LAYERS, 2, COMMAND_R7B_STEPS
    model = dict(COMMAND_R7B, num_hidden_layers=layers)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        hf_dir = write_pretrained(os.path.join(tmp, "command_r7b"), model)
        ckpt = os.path.join(tmp, "ckpts")
        run = _pretrained_run(name, [
            "-c", mock_data_config(tmp, COHERE2_SFT_YAML, model["vocab_size"]),
            *command_r7b_sft_args(hf_dir, ckpt), "--output_dir", os.path.join(tmp, "run")],
            ckpt, reload_dtype=torch.bfloat16)
    want = _expected(layers, micro, steps, True)
    config = _port_config(model)
    norms = [n for n in run["hf_names"] if "layernorm" in n]
    print(f"{name}: train_ft on {_shown(COHERE2_SFT_YAML)} ({layers} layers of Command R7B "
          f"from a local HF directory, bf16, rows of {COMMAND_R7B_SEQ}, loss "
          f"{run['loss_name']}, sliding layers {config.sliding_flags}, NoPE layers "
          f"{config.nope_flags}, unembedding / {config.logits_scaling}), {_shown_run(run)}, "
          f"step_{steps}/hf {len(run['hf_names'])} tensors ({len(norms)} layer norms), "
          f"reloaded through from_pretrained: "
          f"{'bitwise equal' if not run['hf_differ'] else run['hf_differ']}, launches "
          f"{run['launches']} (expected {want}), {time.perf_counter() - t0:.1f} s", flush=True)
    _check_pretrained_run(name, run, range(1, steps + 1), want, saves=[steps],
                          first_loss=random_init_loss(model["vocab_size"], model["hidden_size"],
                                                      _logit_std(model)),
                          model=model, micro=micro)
    if (run["loss_name"] != "linear_ce" or len(norms) != layers
            or "lm_head.weight" in run["hf_names"]):
        raise AssertionError(f"{name}: loss {run['loss_name']}, norms {norms}, names "
                             f"{run['hf_names'][:4]}")
    return run["routed"]


def _lineage_paths() -> dict:
    """Main path 32: the benchmark recipe on each member of LINEAGE_SWEEP (lineage_config:
    llama3_2_1b.yaml with the member's published widths; linear CE where the vocabulary is
    65,536 or more, as train_ft would pick it) and on examples/benchmark/starcoder2_proxy.yaml
    as it stands (the structural alias), whose optimizer adafactor_momentum_free exists in
    neither package: adafactor_nomom in its place. SWEEP_WARMUP + SWEEP_TIMED steps each;
    the launch counts and the loss band are _bench_path's."""
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, model, layers in LINEAGE_SWEEP:
            linear_ce = model["vocab_size"] >= 65536
            by_path[f"main path 32 ({label})"], _ = _bench_path(
                f"main path 32 ({label})", lineage_config(tmp, model, layers), linear_ce,
                ["--loss.name", "linear_ce"] if linear_ce else [], SWEEP_WARMUP, SWEEP_TIMED)
    by_path["main path 32 (StarCoder2 proxy)"], _ = _bench_path(
        "main path 32 (StarCoder2 proxy)", STARCODER2_YAML, False,
        ["--optimizer.optimizer", "adafactor_nomom"], SWEEP_WARMUP, SWEEP_TIMED)
    return by_path


GLM4_MOE_YAML = os.path.join(HERE, "examples", "benchmark", "glm4_moe_proxy.yaml")
QWEN3_NEXT_YAML = os.path.join(HERE, "examples", "benchmark", "qwen3_next_proxy.yaml")
MINIMAX_SFT_YAML = os.path.join(HERE, "examples", "llm_finetune", "minimax_m2_sft.yaml")
STEP_SFT_YAML = os.path.join(HERE, "examples", "llm_finetune", "step3p5_moe.yaml")
# depth of main path 39: 2 of 62 layers (8.6 B parameters, 7.2 B of them its experts).
# The path writes its weights three times (the local HF directory, the step's model and
# hf/: 17 GB each, a save of 34.3 GB in 88 s on the H100's machine)
MINIMAX_M2_LAYERS = 2
# depth of main path 40: the full layer 0, the sliding layers 1-2 (dense) and the sliding
# MoE layer 3, moe_layers_enum cut to "3" (6.4 B parameters, 4.5 B of them the experts)
STEP35_FLASH_LAYERS = 4
FAMILY_STEPS = 2  # train_ft steps of main paths 39-40 (2 microbatches each), one save
# main paths 38-41: (path, model, recipe, YAML, published config, depth)
FAMILY_PATHS = (
    ("main path 38", "GLM-4.5-Air", "benchmark", GLM4_MOE_YAML, GLM45_AIR, GLM45_AIR_LAYERS),
    ("main path 39", "MiniMax-M2", "train_ft", MINIMAX_SFT_YAML, MINIMAX_M2, MINIMAX_M2_LAYERS),
    ("main path 40", "Step-3.5 geometry, unverified", "train_ft", STEP_SFT_YAML, STEP35_FLASH,
     STEP35_FLASH_LAYERS),
    ("main path 41", "Qwen3-Next-80B-A3B", "benchmark", QWEN3_NEXT_YAML, QWEN3_NEXT_80B,
     QWEN3_NEXT_LAYERS),
)


def family_sft_args(model: dict, hf_dir: str, ckpt_dir: str) -> list[str]:
    """Main paths 39-40's overrides of minimax_m2_sft.yaml / step3p5_moe.yaml: the model
    from the local directory ``hf_dir`` in bf16, one process (``ep`` 16 -> 1, the ``dense``
    dispatcher), flash attention (the files name none), adafactor_nomom (its factored
    state adds next to nothing to the save: the files' adamw would add twice the model's
    bytes, 20-26 GB here, beyond the card machine's disk once the weights are written
    too), the mock data at the model's vocabulary, 500-token documents packed into the
    files' rows of 4096, FAMILY_STEPS steps of 2 microbatches (8 in the files), one save
    (with the consolidated HF export) at the last step under ``ckpt_dir``."""
    return ["--model.pretrained_model_name_or_path", hf_dir, "--model.params_dtype", "bfloat16",
            "--distributed.ep", "1", "--backend.dispatcher", "dense",
            "--backend.attention", "flash", "--optimizer.optimizer", "adafactor_nomom",
            "--dataset.vocab_size", str(model["vocab_size"]),
            "--dataset.seq_len", "500", "--dataset.num_samples", "64",
            "--packed_sequence.packed_sequence_size", "4096",
            "--backend.attention_segments", "true",
            "--step_scheduler.grad_acc_steps", "2",
            "--step_scheduler.max_steps", str(FAMILY_STEPS),
            "--step_scheduler.ckpt_every_steps", str(FAMILY_STEPS),
            "--checkpoint.checkpoint_dir", ckpt_dir]


def _bias_tracer(trace: list, name: str = "moe_layers.moe.gate.score_correction_bias"):
    """An ``on_setup`` hook that appends, each train step, (the correction bias before,
    after, the step's expert load summed over its microbatches) to ``trace``."""
    def on_setup(recipe):
        bias, step_fn = recipe.params[name], recipe._train_step

        def traced(opt_state, stack):
            before = bias.detach().clone()
            opt_state, m = step_fn(opt_state, stack)
            trace.append((before, bias.detach().clone(), m["expert_load"].detach().clone()))
            return opt_state, m

        recipe._train_step = traced

    return on_setup


def _bias_moves(trace: list, factor: float) -> list[float]:
    """Each traced step's largest |moved - sign(mean load - load) x factor| (the gate-bias
    update's rule, JAX's; weight decay moves the bias by far less)."""
    import torch

    return [(after - before - torch.sign(load.float().mean(-1, keepdim=True) - load.float())
             * factor).abs().max().item() for before, after, load in trace]


def _family_path(path, label, recipe, yaml, model, layers, extra=()):
    """One of main paths 38-41 at ``model``'s widths (a published config) at ``layers``
    layers: ``recipe`` "benchmark" (the YAML's config block overlaid, WARMUP + TIMED
    steps through _bench_path) or "train_ft" (a local HF directory of random weights,
    family_sft_args, through _pretrained_run: FAMILY_STEPS steps, one save, hf/ reloaded
    bitwise). Both with flash; ``extra``: more CLI overrides (the CPU tests'). Checks:
    finite losses, the first within 0.5 of the random-init loss plus the router term (aux
    coefficient x MoE layers), the exact launches (flash only on the layers whose
    attention launches it: none of Qwen3-Next's DeltaNet layers), and, where the config
    updates the gate bias (GLM-4-MoE), each step's move of the correction bias within
    1e-6 of sign(mean load - load) x its factor. Prints the MFU both as the port and as
    JAX counts the FLOPs (JAX reads no num_local_experts: MiniMax-M2's MLPs as dense).
    Returns the routed launches."""
    import torch

    name = f"{path} ({label})"
    model = at_depth(model, layers)
    config = _port_config(model)
    attn_layers, moe_layers = _kernel_layers(model)
    vocab, hidden = model["vocab_size"], model["hidden_size"]
    want_first = (random_init_loss(vocab, hidden, model["initializer_range"])
                  + float(model.get("router_aux_loss_coef", 0.0)) * moe_layers)
    factor = config.moe.gate_bias_update_factor
    trace = []
    tracer = _bias_tracer(trace) if factor > 0 else None
    if recipe == "benchmark":
        args = [*model_config_args(model), "--dataset.vocab_size", str(vocab),
                "--backend.attention", "flash", *extra]
        routed, losses = _bench_path(name, yaml, True, args, on_setup=tracer)
        if hasattr(config, "linear_layer_indices"):  # a hybrid: its scopes' shares
            _bench_path(f"{name}, profiled", yaml, True, args, warmup=1, timed=1,
                        on_profile=_scope_shares(name))
        first = losses[0]
        if abs(first - want_first) > 0.5:
            raise AssertionError(f"{name}: first loss {first} is not within 0.5 of "
                                 f"{want_first:.3f}")
    else:
        _release()
        micro = 2
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            hf_dir = write_pretrained(os.path.join(tmp, "hf"), model, device=_device(extra))
            written = time.perf_counter() - t0
            ckpt = os.path.join(tmp, "ckpts")

            def on_setup(recipe):
                # the weights are on the card: the directory's disk goes to the save
                shutil.rmtree(hf_dir)
                if tracer is not None:
                    tracer(recipe)

            run = _pretrained_run(name, ["-c", yaml, *family_sft_args(model, hf_dir, ckpt),
                                         "--output_dir", os.path.join(tmp, "run"), *extra],
                                  ckpt, reload_dtype=torch.bfloat16, on_setup=on_setup)
        want = _expected(layers, micro, FAMILY_STEPS, True, moe=True,
                         dense_prefix=layers - moe_layers, attn_layers=attn_layers)
        mfus = [x.get("mfu") for x in run["rows"] if "loss" in x]
        print(f"{name}: train_ft on {_shown(yaml)} ({layers} layers, {moe_layers} MoE, bf16, "
              f"loss {run['loss_name']}, packed rows of {run['seq_len']}; the local HF "
              f"directory written in {written:.1f} s), {_shown_run(run)}; MFU as JAX counts "
              f"it {[_jax_count_mfu(model, run['seq_len'], m) for m in mfus]}; hf/ "
              f"{len(run['hf_names'])} tensors, {run['hf_bytes']} bytes, reloaded through "
              f"from_pretrained: {'bitwise equal' if not run['hf_differ'] else run['hf_differ']}"
              f", launches {run['launches']} (expected {want})", flush=True)
        _check_pretrained_run(name, run, range(1, FAMILY_STEPS + 1), want, model=model,
                              micro=micro, saves=[FAMILY_STEPS], first_loss=want_first)
        routed = run["routed"]
    if factor > 0:
        moved = _bias_moves(trace, factor)
        print(f"{name}: correction bias, max |moved - sign(mean - load) x {factor}| per step "
              f"{moved} (tol 1e-6)", flush=True)
        if not moved or max(moved) > 1e-6 or not bool((trace[0][1] != 0).any()):
            raise AssertionError(f"{name}: the correction bias did not move as its loads "
                                 f"say: {moved}")
    return routed


def _scope_shares(name):
    """An ``on_profile`` hook for a hybrid's profiled benchmark run (one warmup step, one
    timed step in the recipe's profile window, apart from the path's timed steps, whose
    step time the window's own cost would inflate): prints the device time of each named
    scope (the model's ``delta_net``, ``gated_attention``, ``moe``: forward, replay and
    backward; the train step's ``optimizer``; ``utils/tracing.py``) with its share of the
    device's busy time, and the rest (the embedding, the norms, linear CE, the gradient
    norm). On the card it fails if a
    scope saw no device time, or if the scopes and the linear-CE kernels (outside every
    scope) add up to more than the busy time (a node counted twice); the CPU records no
    device time."""
    def on_profile(summary):
        busy_ms, window_ms = summary["device_busy_s"] * 1e3, summary["window_s"] * 1e3
        scopes = summary["device_ms_by_scope"]
        lce_ms = summary["device_ms_by_class"].get("linear_ce_kernels", 0.0)
        rest = busy_ms - sum(scopes.values())
        shares = {k: {"device_ms": v, "of_busy": v / busy_ms if busy_ms else None}
                  for k, v in {**scopes, "rest": rest}.items()}
        print(f"{name}: profiled step: device busy {busy_ms:.1f} ms of a {window_ms:.1f} ms "
              f"window (idle share {summary['idle_share']}; the profiler's own host time "
              f"inside), linear-CE kernels {lce_ms:.1f} ms, by scope {json.dumps(shares)}",
              flush=True)
        if not busy_ms:
            return
        missing = [k for k in ("delta_net", "gated_attention", "moe", "optimizer")
                   if not scopes.get(k)]
        if missing:
            raise AssertionError(f"{name}: the profile window saw no device time under "
                                 f"{missing}")
        if rest < lce_ms:
            raise AssertionError(f"{name}: the scopes' device time {scopes} leaves "
                                 f"{rest:.1f} ms of the busy {busy_ms:.1f} ms, less than the "
                                 f"linear-CE kernels' {lce_ms:.1f} ms outside them")
    return on_profile


def _delta_net_timings(torch, b=4, s=2048, model=QWEN3_NEXT_80B) -> dict:
    """ms of one gated DeltaNet token mixer (``models/qwen3_next``: projections, the
    masked conv, the chunked delta rule, the gated norm; plain PyTorch, no kernel of the
    port's) at ``model``'s widths over main path 41's micro-batch (b x s) in bf16: its
    forward, forward and backward, and the chunked rule alone (forward, and forward and
    backward): the breakdown of the ``delta_net`` scope's time in main path 41's profile
    window (_scope_shares)."""
    from automodel_tpu_torch.models.qwen3_next.model import (Qwen3NextConfig,
                                                              gated_delta_attention)
    from automodel_tpu_torch.ops.gated_delta import chunk_gated_delta_rule

    cfg = Qwen3NextConfig.from_hf(at_depth(model, 4))
    g = torch.Generator(device="cuda").manual_seed(41)
    lp = {n: (torch.randn(shape, device="cuda", generator=g) * 0.02).to(torch.bfloat16)
          for n, shape in cfg.linear_shapes().items()}
    lp["a_log"] = torch.log(torch.rand(lp["a_log"].shape, device="cuda", generator=g) * 16
                            + 1e-4)
    lp["dt_bias"] = torch.ones_like(lp["dt_bias"])
    lp["norm"] = torch.ones_like(lp["norm"])
    x = torch.randn(b, s, cfg.hidden_size, device="cuda", generator=g).to(torch.bfloat16)
    seg = torch.ones(b, s, dtype=torch.int32, device="cuda")
    xg = x.clone().requires_grad_()
    leaves = [lp[n].requires_grad_() for n in ("wqkvz", "wba", "conv_w", "dt_bias", "norm", "wo")]
    dout = torch.randn_like(x)

    def fwd_bwd():
        out = gated_delta_attention(cfg, lp, xg, seg)
        torch.autograd.grad(out, [xg, *leaves], dout)

    hv, dk, dv = cfg.linear_num_value_heads, cfg.linear_key_head_dim, cfg.linear_value_head_dim
    q, k = (torch.randn(b, s, hv, dk, device="cuda", generator=g).to(torch.bfloat16)
            .requires_grad_() for _ in range(2))
    v = torch.randn(b, s, hv, dv, device="cuda", generator=g).to(torch.bfloat16).requires_grad_()
    gl = -torch.rand(b, s, hv, device="cuda", generator=g)
    beta = torch.rand(b, s, hv, device="cuda", generator=g)

    def rule():
        return chunk_gated_delta_rule(q, k, v, gl, beta, chunk_size=64)[0]

    with torch.no_grad():
        fwd = _time_ms(torch, lambda: gated_delta_attention(cfg, lp, x, seg), reps=5)
        rule_fwd = _time_ms(torch, rule, reps=5)
    both = _time_ms(torch, fwd_bwd, reps=5)
    rule_both = _time_ms(torch, lambda: torch.autograd.grad(rule(), (q, k, v),
                                                            torch.ones_like(v)), reps=5)
    out = {"forward_ms": fwd, "forward_backward_ms": both, "rule_forward_ms": rule_fwd,
           "rule_forward_backward_ms": rule_both}
    print(f"time gated DeltaNet mixer at B={b} S={s} D={cfg.hidden_size} "
          f"Hk={cfg.linear_num_key_heads} Hv={hv} dk={dk} dv={dv} (plain PyTorch): "
          f"{json.dumps(out)}", flush=True)
    del lp, x, xg, leaves, dout, q, k, v, gl, beta
    torch.cuda.empty_cache()
    return out


def _family_paths(rows=FAMILY_PATHS, extra=()) -> dict:
    """Main paths 38-41 (the rows of FAMILY_PATHS), each with its seconds."""
    by_path = {}
    for row in rows:
        t0 = time.perf_counter()
        by_path[row[0]] = _family_path(*row, extra=extra)
        print(f"{row[0]}: {time.perf_counter() - t0:.1f} s", flush=True)
    return by_path


def classifier_init_loss(labels: int, hidden: int, std: float) -> float:
    """The cross entropy over ``labels`` classes of a fresh head: each logit is the pooled
    hidden state (unit rms after the final norm) through a column ~ N(0, std^2), so the
    logits ~ N(0, hidden std^2) and the loss is E[logsumexp(z) - z_0] (0.87 for 2 labels
    at Llama-3.2-1B's hidden 2048 and std 0.02, where ln 2 is 0.69), by 200,000 draws from
    a fixed seed."""
    import numpy as np

    z = np.random.default_rng(0).normal(0.0, math.sqrt(hidden) * std, (200_000, labels))
    top = z.max(-1)
    return float((top + np.log(np.exp(z - top[:, None]).sum(-1)) - z[:, 0]).mean())


def _device(extra) -> str:
    """The device a main path's ``extra`` CLI overrides name (the CPU tests' ``--device
    cpu``), else the card."""
    extra = list(extra)
    return extra[extra.index("--device") + 1] if "--device" in extra else "cuda"


def _seq_cls_path(name, model=None, extra=()):
    """examples/llm_finetune/seq_cls.yaml through train_seq_cls (main path 33): its model a
    local HF directory of a random-init Llama-3.2-1B at SEQ_CLS_LAYERS of 16 layers,
    written without a score head (so the fresh-head branch of from_pretrained runs: JAX's
    default_rng(0) at std 0.02, checked bitwise at setup), its GLUE section swapped for
    local rows of random words with 2 labels, --backend.attention flash (the file names
    none), the file's mb 8 x 512 and 4 microbatches, SEQ_CLS_STEPS steps, one save; the
    step's hf/ (with score.weight, no lm_head) reloads bitwise. ``model`` / ``extra``: other
    widths and more CLI overrides (the CPU tests')."""
    import numpy as np
    import torch

    from automodel_tpu_torch.models.seq_cls import AutoModelForSequenceClassification
    from automodel_tpu_torch.recipes.llm.train_seq_cls import TrainSeqClsRecipe

    _release()
    model = model or dict(LLAMA32_1B, num_hidden_layers=SEQ_CLS_LAYERS)
    layers, micro, steps = model["num_hidden_layers"], 4, SEQ_CLS_STEPS
    fresh = np.random.default_rng(0).normal(0, model["initializer_range"],
                                            (model["hidden_size"], 2)).astype(np.float32)
    seen = {}

    def head(recipe):
        seen["fresh"] = torch.equal(recipe.params["score"].cpu(), torch.from_numpy(fresh))

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        hf_dir = write_pretrained(os.path.join(tmp, "llama3_2_1b"), model,
                                  device=_device(extra))
        yaml = local_data_config(tmp, SEQ_CLS_YAML, {
            "model": {"pretrained_model_name_or_path": hf_dir, "num_labels": 2},
            "dataset": {"_target_": "automodel_tpu.data.llm.seq_cls.SeqClsDataset",
                        "path_or_dataset_id": write_seq_cls_jsonl(
                            os.path.join(tmp, "sst2.jsonl"), 256, 2, seed=0)}})
        ckpt = os.path.join(tmp, "ckpts")
        run = _pretrained_run(name, [
            "-c", yaml, "--backend.attention", "flash", "--step_scheduler.max_steps", str(steps),
            "--step_scheduler.ckpt_every_steps", str(steps), "--checkpoint.checkpoint_dir",
            ckpt, "--output_dir", os.path.join(tmp, "run"), *extra], ckpt,
            reload_dtype=torch.float32, on_setup=head, recipe_cls=TrainSeqClsRecipe,
            reload=lambda path, dtype, device: AutoModelForSequenceClassification.from_pretrained(
                path, 2, dtype=dtype, device=device))
    want = _expected(layers, micro, steps, False)
    init = classifier_init_loss(2, model["hidden_size"], model["initializer_range"])
    first = run["losses"][1]
    print(f"{name}: train_seq_cls on {_shown(SEQ_CLS_YAML)} ({layers} layers of Llama-3.2-1B "
          f"from a local HF directory without a score head, f32 as JAX's recipe, flash, 2 "
          f"labels), fresh head bitwise JAX's default_rng(0): {seen['fresh']}, "
          f"{_shown_run(run)}, first loss {first:.4f} (fresh-head expectation {init:.4f}, "
          f"ln 2 = {math.log(2):.4f}), step_{steps}/hf {len(run['hf_names'])} tensors "
          f"(score.weight {'score.weight' in run['hf_names']}, lm_head "
          f"{'lm_head.weight' in run['hf_names']}), reloaded through from_pretrained: "
          f"{'bitwise equal' if not run['hf_differ'] else run['hf_differ']}, launches "
          f"{run['launches']} (expected {want}), {time.perf_counter() - t0:.1f} s", flush=True)
    _check_pretrained_run(name, run, range(1, steps + 1), want, saves=[steps], first_loss=init,
                          model=model, micro=micro)
    if not seen["fresh"] or "score.weight" not in run["hf_names"] \
            or "lm_head.weight" in run["hf_names"]:
        raise AssertionError(f"{name}: fresh head {seen['fresh']}, hf/ names "
                             f"{run['hf_names'][:4]}")
    return run["routed"]


def _qwen25_seq_cls_path(name, model=None, extra=()):
    """examples/llm_finetune/qwen2_5_seq_cls_lora.yaml through train_seq_cls (main path 34)
    at Qwen2.5-7B's published widths (QWEN25_7B, built from model.config and random init
    on the card), SEQ_CLS_LAYERS of 28 layers, 3 labels (its MNLI section swapped for
    local rows), LoRA rank 8 on wq / wv and flash as the file sets them, mb 8 x 512 and 2
    microbatches, QWEN25_SEQ_CLS_STEPS steps, no save: the trainable tensors are the
    adapter's four factors and the head stays bitwise at its init, as in JAX."""
    import torch

    from automodel_tpu_torch.recipes.llm.train_seq_cls import TrainSeqClsRecipe

    _release()
    model = model or dict(QWEN25_7B, num_hidden_layers=SEQ_CLS_LAYERS)
    layers, micro, steps = model["num_hidden_layers"], 2, QWEN25_SEQ_CLS_STEPS
    seen = {}

    def head(recipe):
        seen.update(score=recipe.params["score"], init=recipe.params["score"].detach().clone(),
                    trainable=sorted(recipe.train_params))

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        yaml = local_data_config(tmp, QWEN25_SEQ_CLS_YAML, {
            "model": {"config": model, "num_labels": 3},
            "dataset": {"_target_": "automodel_tpu.data.llm.seq_cls.SeqClsDataset",
                        "path_or_dataset_id": write_seq_cls_jsonl(
                            os.path.join(tmp, "mnli.jsonl"), 128, 3, seed=1)}})
        run = _pretrained_run(name, [
            "-c", yaml, "--step_scheduler.max_steps", str(steps), "--checkpoint.enabled",
            "false", "--output_dir", os.path.join(tmp, "run"), *extra], None, on_setup=head,
            recipe_cls=TrainSeqClsRecipe)
    frozen = torch.equal(seen.pop("score"), seen.pop("init"))
    want = _expected(layers, micro, steps, False)
    init = classifier_init_loss(3, model["hidden_size"], model["initializer_range"])
    print(f"{name}: train_seq_cls on {_shown(QWEN25_SEQ_CLS_YAML)} (local rows; Qwen2.5-7B's "
          f"widths, {layers} layers, f32, 3 labels, LoRA rank 8 on wq / wv), trainable "
          f"{seen['trainable']}, head bitwise at its init after {steps} steps: {frozen}, "
          f"{_shown_run(run)}, first loss {run['losses'][1]:.4f} (fresh-head expectation "
          f"{init:.4f}, ln 3 = {math.log(3):.4f}), launches {run['launches']} (expected "
          f"{want}), {time.perf_counter() - t0:.1f} s", flush=True)
    _check_pretrained_run(name, run, range(1, steps + 1), want, first_loss=init, model=model,
                          micro=micro)
    if not frozen or len(seen["trainable"]) != 4 or not all(
            ".lora_" in n for n in seen["trainable"]):
        raise AssertionError(f"{name}: head frozen {frozen}, trainable {seen['trainable']}")
    return run["routed"]


def _biencoder_args(out_dir: str, attention: str, steps: int) -> list[str]:
    """Main path 35's overrides: the attention path, ``steps`` steps, validation every 2
    over BIENCODER_VAL_BATCHES batch, no checkpoint."""
    return ["--backend.attention", attention, "--step_scheduler.max_steps", str(steps),
            "--step_scheduler.val_every_steps", "2", "--validation_max_batches",
            str(BIENCODER_VAL_BATCHES), "--checkpoint.enabled", "false", "--output_dir", out_dir]


def _causal_tower(recipe):
    """Main path 35's control: the tower's flash launches causal."""
    recipe.model.config.causal = True


def _unmasked_tower(recipe):
    """Main path 35's control: the tower's layers get no segment ids, so flash attends
    over the right padding; the pooling still reads the real tokens."""
    from automodel_tpu_torch.models.llama_bidirectional import pool_hidden

    model, forward = recipe.model, recipe.model.forward

    def unmasked(input_ids, positions=None, segment_ids=None, **kw):
        hidden = forward(input_ids, positions=positions, pooled=False, **kw)
        return pool_hidden(hidden, segment_ids != 0, model.config.pooling)

    model.forward = unmasked


def _biencoder_path(name, model=None, extra=()):
    """examples/biencoder/llama3_2_1b_last_token_pool.yaml through train_biencoder (main
    path 35): its own model section (Llama-3.2-1B's widths, all 16 layers, non-causal,
    last-token pooling; random init on the card), its data sections swapped for local
    query / passage rows with 1 hard negative each, --backend.attention flash (the file
    names none), the file's mb of 32 queries of 64 tokens with 64 passages of 256,
    BIENCODER_STEPS steps, validation at steps 2 and 4 (acc@1, recall@10, MRR), no save.
    Every flash launch is non-causal, two tower forwards a microbatch and a validation
    batch. Its first loss is held within TOL_BIENCODER_LOSS of the first step of the same
    config on backend.attention xla (the same weights from the seed, the same batch), and
    two controls, that first step on flash launched causal and on flash without the
    segment ids, must miss it by more."""
    from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
    from automodel_tpu_torch.recipes.biencoder.train_biencoder import TrainBiencoderRecipe

    _release()
    steps = BIENCODER_STEPS
    target = "automodel_tpu.data.llm.retrieval.RetrievalDataset"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        yaml = local_data_config(tmp, BIENCODER_YAML, {
            **({"model": {"config": model}} if model else {}),
            "dataset": {"_target_": target, "num_hard_negatives": 1, "path_or_dataset_id":
                        write_retrieval_rows(os.path.join(tmp, "train.jsonl"), 256, 0, 1)},
            "validation_dataset": {"_target_": target, "num_hard_negatives": 1,
                                   "path_or_dataset_id": write_retrieval_rows(
                                       os.path.join(tmp, "val.jsonl"), 64, 1, 1)}})
        run = _pretrained_run(name, ["-c", yaml, *_biencoder_args(
            os.path.join(tmp, "flash"), "flash", steps), *extra], None,
            recipe_cls=TrainBiencoderRecipe)
        _release()
        recipe, xla_losses, _, _ = _recorded_train_ft(parse_args_and_load_config([
            "-c", yaml, *_biencoder_args(os.path.join(tmp, "xla"), "xla", 1), *extra]),
            recipe_cls=TrainBiencoderRecipe)
        model, xla_first = recipe.hf_config, xla_losses[1]
        del recipe
        # controls: the same first step on flash with a wrong mask must miss xla's first
        # loss by more than the tolerance, or the check could not catch such a kernel
        controls = {}
        for label, wrong in (("causal", _causal_tower), ("unmasked", _unmasked_tower)):
            _release()
            recipe, losses, _, _ = _recorded_train_ft(parse_args_and_load_config([
                "-c", yaml, *_biencoder_args(os.path.join(tmp, label), "flash", 1), *extra]),
                on_setup=wrong, recipe_cls=TrainBiencoderRecipe)
            controls[label] = abs(losses[1] - xla_first)
            del recipe
    _release()
    layers = model["num_hidden_layers"]
    want = _expected(layers, 1, steps, False, val_batches=2 * BIENCODER_VAL_BATCHES, towers=2)
    d_first = abs(run["losses"][1] - xla_first)
    val = [(x["step"], x["val_loss"], x["val_acc1"], x["val_recall_at_10"], x["val_mrr"])
           for x in run["val"]]
    tokens = 32 * 64 + 64 * 256
    print(f"{name}: train_biencoder on {_shown(BIENCODER_YAML)} (local rows; Llama-3.2-1B's "
          f"widths, all {layers} layers, non-causal, last-token pooling, f32, flash), "
          f"{_shown_run(run)}, tokens/s {[x.get('tps') for x in run['rows'] if 'loss' in x]} "
          f"({tokens} tokens a step), validation (step, loss, acc@1, recall@10, MRR) {val}, "
          f"first loss {run['losses'][1]:.6f} against xla's {xla_first:.6f}: |diff| "
          f"{d_first:.3e} (tol {TOL_BIENCODER_LOSS}; with flash causal "
          f"{controls['causal']:.3e}, blind to the padding {controls['unmasked']:.3e}), "
          f"launches {run['launches']} (expected {want}), {time.perf_counter() - t0:.1f} s",
          flush=True)
    _check_pretrained_run(name, run, range(1, steps + 1), want, model=model, micro=1)
    if d_first > TOL_BIENCODER_LOSS:
        raise AssertionError(f"{name}: the flash tower's first loss is not xla's")
    if min(controls.values()) <= TOL_BIENCODER_LOSS:
        raise AssertionError(f"{name}: a wrong flash mask passes the check: {controls}")
    if [v[0] for v in val] != [2, 4] or not all(math.isfinite(x) for v in val for x in v[1:]):
        raise AssertionError(f"{name}: validation rows {val}")
    return run["routed"]


def _mining_path(name, model=None, extra=()):
    """examples/biencoder/mine_hard_negatives.yaml through mine_hard_negatives' main (main
    path 36): its own model section (4 layers, 512 wide, mean pooling; random init on the
    card), margin 0.95 perc, 4 negatives, the E5 prefixes; its data and mine sections
    swapped for MINE_ROWS local query / positive rows, --backend.attention flash (the
    file names none). Every row gets 1-4 negatives, none its positive, each scoring at or
    under the margin cut (the scores re-encoded by a second tower from the same seed);
    RetrievalDataset reads the output back. Forward only: flash_fwd once a layer an
    encoded batch of 32 (the corpus, then the queries), all non-causal."""
    import numpy as np
    import yaml as yaml_lib

    from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
    from automodel_tpu_torch.data.llm.retrieval import RetrievalDataset
    from automodel_tpu_torch.recipes.biencoder import mine_hard_negatives
    from automodel_tpu_torch.recipes.biencoder.train_biencoder import TrainBiencoderRecipe

    _release()
    t0 = time.perf_counter()
    with open(MINE_YAML) as f:
        mine = yaml_lib.safe_load(f)["mine"]
    with tempfile.TemporaryDirectory() as tmp:
        pairs = write_retrieval_rows(os.path.join(tmp, "qa_pairs.jsonl"), MINE_ROWS, 2)
        mine.update(input=pairs, output=os.path.join(tmp, "mined.jsonl"))
        yaml = local_data_config(tmp, MINE_YAML, {"mine": mine, "dataset": {
            "_target_": "automodel_tpu.data.llm.retrieval.RetrievalDataset",
            "path_or_dataset_id": pairs, "num_hard_negatives": 0},
            **({"model": {"config": model}} if model else {})})
        cfg = parse_args_and_load_config(["-c", yaml, "--backend.attention", "flash",
                                          "--checkpoint.enabled", "false", "--output_dir",
                                          os.path.join(tmp, "run"), *extra])
        _reset_counts()
        mined = mine_hard_negatives.main(cfg)
        launches = _read_counts()
        routed = _check_routes(name, launches)
        back = RetrievalDataset(mine["output"], num_hard_negatives=mine["num_negatives"])
        tower = TrainBiencoderRecipe(cfg)
        tower.setup()
        corpus = sorted({r["pos_doc"] for r in mined})
        docs = tower.encode([mine["passage_prefix"] + d for d in corpus])
        queries = tower.encode([mine["query_prefix"] + r["query"] for r in mined])
        model = tower.hf_config
        del tower
    _release()
    scores = queries @ docs.T
    row = {d: i for i, d in enumerate(corpus)}
    over, counts = [], []
    for i, r in enumerate(mined):
        pos = scores[i, row[r["pos_doc"]]]
        if mine["margin_type"] == "abs":
            cut = pos - mine["margin"]
        else:
            cut = mine["margin"] * pos if pos > 0 else pos
        counts.append(len(r["neg_doc"]))
        over += [(i, n) for n in r["neg_doc"] if n == r["pos_doc"] or scores[i, row[n]] > cut]
    batches = 2 * -(-MINE_ROWS // 32)
    want = _expected(model["num_hidden_layers"], 0, 0, False, val_batches=batches)
    print(f"{name}: mine_hard_negatives on {_shown(MINE_YAML)} ({MINE_ROWS} local rows, 4 "
          f"layers of 512, flash, margin {mine['margin']} {mine['margin_type']}), negatives a "
          f"row {dict(zip(*(a.tolist() for a in np.unique(counts, return_counts=True))))} "
          f"(count: rows), over the "
          f"cut or the positive {len(over)}, read back {len(back)} rows, launches {launches} "
          f"(expected {want}), {time.perf_counter() - t0:.1f} s", flush=True)
    if launches != want:
        raise AssertionError(f"{name}: kernel launches {launches} != expected {want}")
    _check_path_launches(name, routed, model, 0, 0)
    if over or not 1 <= min(counts) <= max(counts) <= mine["num_negatives"] \
            or back.rows != mined or len(mined) != MINE_ROWS:
        raise AssertionError(f"{name}: negatives {counts[:8]}..., over the cut {over[:4]}")
    return routed


def gpt2_mfu(model: dict, seq_len: int, tokens_per_s: float) -> float:
    """MFU of a GPT-2 step as nanoGPT's estimate_mfu counts it: 6N + 12 L H Q T FLOPs a
    token (N the parameters without the position table, the tied wte counted once; Q
    the head dim, T the sequence), over the card's dense bf16 peak."""
    d, layers, vocab = model["n_embd"], model["n_layer"], model["vocab_size"]
    n = vocab * d + layers * (12 * d * d + 13 * d) + 2 * d
    flops = 6 * n + 12 * layers * model["n_head"] * (d // model["n_head"]) * seq_len
    return tokens_per_s * flops / PEAK_FLOPS


def _gpt2_path(name, model=None, extra=()):
    """examples/llm_pretrain/nanogpt.yaml through train_ft (main path 37): GPT-2-124M as
    the file gives it (all 12 layers, 768 wide, vocab 50,304, random init on the card),
    nanoGPT shards written from the seed in place of its fineweb ones,
    --backend.attention flash (the file names none), the file's mb 16 x 1024, masked CE
    (vocab < 65,536), GPT2_STEPS steps with saves at 2 and 4. Run A fresh, run B resumed
    from step 2 after step 4 is removed: its step-3 and step-4 losses bitwise run A's;
    step_4/hf reloads bitwise. The recipe's rows carry no MFU (GPT-2's config is outside
    the FLOPs formula, as in JAX): the script prints nanoGPT's count beside them."""
    import shutil

    import torch
    import yaml as yaml_lib

    _release()
    with open(NANOGPT_YAML) as f:
        cfg = yaml_lib.safe_load(f)
    model = model or cfg["model"]["config"]
    steps, micro, layers = GPT2_STEPS, 1, model["n_layer"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # GPT-2's tokenizer has 50,257 ids; the file's vocabulary is padded to 50,304
        pattern = write_nanogpt_shards(tmp, (steps * 16 + 14) * 1024 + 2,
                                       min(model["vocab_size"], 50257), seed=0)
        yaml = local_data_config(tmp, NANOGPT_YAML, {
            "dataset": dict(cfg["dataset"], file_pattern=pattern), "model": {"config": model}})
        ckpt = os.path.join(tmp, "ckpts")
        runs = {}
        for run in ("A", "B"):
            if run == "B":  # the walk-back must find step 2
                shutil.rmtree(os.path.join(ckpt, f"step_{steps}"))
            runs[run] = _pretrained_run(f"{name} run {run}", [
                "-c", yaml, "--backend.attention", "flash", "--step_scheduler.max_steps",
                str(steps), "--step_scheduler.ckpt_every_steps", "2",
                "--checkpoint.checkpoint_dir", ckpt, "--output_dir",
                os.path.join(tmp, f"run_{run}"), *extra], ckpt,
                reload_dtype=torch.float32 if run == "A" else None)
    a, b = runs["A"], runs["B"]
    for run, r in runs.items():
        steps_rows = [x for x in r["rows"] if "loss" in x]
        print(f"{name} run {run}: train_ft on {_shown(NANOGPT_YAML)} (local shards; GPT-2-124M, "
              f"{layers} layers, f32, flash, masked CE {r['loss_name'] == 'masked_ce'}), "
              f"{_shown_run(r)}, tokens/s {[x['tps'] for x in steps_rows]}, MFU by nanoGPT's "
              f"count {[round(gpt2_mfu(model, r['seq_len'], x['tps']), 4) for x in steps_rows]} "
              f"(the recipe's: {[x.get('mfu') for x in steps_rows]}), launches "
              f"{r['launches']}", flush=True)
    print(f"{name}: step_{steps}/hf {a['hf_bytes']} bytes reloaded through from_pretrained: "
          f"{'bitwise equal' if not a['hf_differ'] else a['hf_differ']}; run B from step "
          f"{min(b['losses'])}: steps 3-4 bitwise run A's: "
          f"{all(b['losses'].get(i) == a['losses'][i] for i in (3, 4))}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    first = random_init_loss(model["vocab_size"], model["n_embd"], 0.02)
    _check_pretrained_run(f"{name} run A", a, range(1, steps + 1),
                          _expected(layers, micro, steps, False), model=model, micro=micro,
                          saves=[2, steps], first_loss=first)
    _check_pretrained_run(f"{name} run B (B must resume from step 2)", b, range(3, steps + 1),
                          _expected(layers, micro, 2, False), model=model, micro=micro,
                          saves=[steps])
    if any(b["losses"][i] != a["losses"][i] for i in (3, 4)) or a["loss_name"] != "masked_ce" \
            or any("mfu" in x for x in a["rows"] + b["rows"]):
        raise AssertionError(f"{name}: the resumed losses differ, or the loss or the MFU rows "
                             "are not GPT-2's")
    return {k: a["routed"][k] + b["routed"][k] for k in a["routed"]}


def _encoder_paths() -> dict:
    """Main paths 33-37, each with its seconds."""
    by_path = {}
    for path, fn in (("main path 33", _seq_cls_path), ("main path 34", _qwen25_seq_cls_path),
                     ("main path 35", _biencoder_path), ("main path 36", _mining_path),
                     ("main path 37", _gpt2_path)):
        t0 = time.perf_counter()
        by_path[path] = fn(path)
        print(f"{path}: {time.perf_counter() - t0:.1f} s", flush=True)
    return by_path


def _cp_train_ft_args(layers=CP_LAYERS_TRAIN_FT) -> list[str]:
    """Main path 8's overrides of the CP config: packed rows of 32768 from 4096-token
    documents."""
    return [*llama3_8b_args(layers), "--packed_sequence.packed_sequence_size", "32768",
            "--dataset.seq_len", "4096"]


def _deterministic_child() -> int:
    """The deterministic main paths, in a process that set CUBLAS_WORKSPACE_CONFIG before
    CUDA started and sets torch.use_deterministic_algorithms(True) first: main path 9
    (run B's step-3 and step-4 losses must equal run A's bitwise) and main path 10 (main
    path 8's config, the ring backward through ring_dq + ring_dkv, run twice: every loss
    of the second run must equal the first's bitwise). Prints the launches of each path
    as the last line."""
    import torch

    torch.use_deterministic_algorithms(True)
    by_path = {"main path 9 (deterministic)": _baseline_path("main path 9 (deterministic)")}
    with tempfile.TemporaryDirectory() as cfg_dir:
        cp_yaml = cp_config(cfg_dir)
        runs = [_train_ft_path(f"main path 10 run {run}", cp_yaml, _cp_train_ft_args(),
                               deterministic=True) for run in ("A", "B")]
    (launches_a, losses_a), (launches_b, losses_b) = runs
    print(f"main path 10: train_ft on main path 8's config with the flag set, twice: losses "
          f"{losses_a} and {losses_b}, bitwise equal {losses_a == losses_b}", flush=True)
    if losses_a != losses_b:
        raise AssertionError("main path 10: two runs under the flag gave different losses")
    by_path["main path 10"] = {k: launches_a[k] + launches_b[k] for k in launches_a}
    print(json.dumps(by_path))
    return 0


def _deterministic_paths() -> dict:
    """Run :func:`_deterministic_child` in a child process with
    CUBLAS_WORKSPACE_CONFIG=:4096:8 (cuBLAS raises under the flag without it, and it is
    read when CUDA starts); its output is shown, and its launches by path returned."""
    _release()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run([sys.executable, "-c",
                           "import sys, chip_smoke; sys.exit(chip_smoke._deterministic_child())"],
                          cwd=HERE, env=env, stdout=subprocess.PIPE, text=True, timeout=600)
    lines = proc.stdout.rstrip().splitlines()
    print("\n".join(lines[:-1] if proc.returncode == 0 else lines), flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"the deterministic main paths failed (exit {proc.returncode})")
    return json.loads(lines[-1])


def _moe_model_check(torch):
    """Qwen3-MoE at the slice widths, 1 layer, bf16: the kernels (flash attention, gmm and
    tgmm) against the plain versions (xla attention, the grouped GEMM's reference,
    swapped in by this script) on the same weights and batch. Routing is held fixed
    (fake_balanced_gate): a bf16 near-tie could otherwise send a token to another expert
    when attention differs in the last bit."""
    from automodel_tpu_torch.data.collate import sft_collate
    from automodel_tpu_torch.data.llm.mock import MockSFTDataset
    from automodel_tpu_torch.models.common.backend import BackendConfig
    from automodel_tpu_torch.models.qwen3_moe.model import Qwen3MoeForCausalLM
    from automodel_tpu_torch.moe import experts
    from automodel_tpu_torch.ops import grouped_gemm as gg
    from automodel_tpu_torch.ops.losses import masked_cross_entropy

    hf = dict(QWEN3_30B_A3B, num_hidden_layers=1, architectures=["Qwen3MoeForCausalLM"])
    ds = MockSFTDataset(hf["vocab_size"], 2048, num_samples=2, seed=0)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in sft_collate([ds[i] for i in range(2)], 2048).items()}
    results = {}
    for kernels in (True, False):
        backend = BackendConfig(attention="flash" if kernels else "xla", remat_policy="mlp_dots",
                                dtype="bfloat16", experts_backend="pallas",
                                fake_balanced_gate=True)
        model = Qwen3MoeForCausalLM.from_config(
            hf, backend, device="cuda", dtype=torch.bfloat16,
            generator=torch.Generator(device="cuda").manual_seed(0))
        params = [p for n, p in model.param_dict().items() if not n.endswith("gate.weight")]
        experts.grouped_matmul = gg.grouped_matmul if kernels else gg.grouped_matmul_reference
        try:
            logits, _ = model(batch["input_ids"], positions=batch["positions"],
                              segment_ids=batch["segment_ids"])
            loss = masked_cross_entropy(logits, batch["labels"])
            grads = torch.autograd.grad(loss, params)
        finally:
            experts.grouped_matmul = gg.grouped_matmul
        results[kernels] = (loss.item(), torch.cat([g.float().flatten() for g in grads]))
        del model, params, logits, grads
        torch.cuda.empty_cache()
    d_loss = abs(results[True][0] - results[False][0])
    rel = _rel_l2(results[True][1], results[False][1])
    print(f"MoE model check (1 layer, Qwen3-30B-A3B width, bf16, fixed routing): loss kernels "
          f"{results[True][0]:.6f} plain {results[False][0]:.6f} |diff| {d_loss:.3e} (tol "
          f"{TOL_MOE_LOSS}), grad rel L2 {rel:.3e} (tol {TOL_MOE_GRAD})", flush=True)
    if not (d_loss <= TOL_MOE_LOSS and rel <= TOL_MOE_GRAD):
        raise AssertionError("the MoE model's kernels disagree with the plain versions")


def _lce_inputs(torch, n, e, v, seed, h_scale=1.0, tied=False):
    """h ~ N(0, h_scale^2) (normed hidden states), w ~ N(0, 0.02^2) (the init), 10%
    ignored labels; bf16 on the card. ``tied``: w is a row-major (V, E) embedding (the
    caller passes w.t() as the unembedding)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = (torch.randn(n, e, device="cuda", generator=g) * h_scale).to(torch.bfloat16)
    shape = (v, e) if tied else (e, v)
    w = (torch.randn(*shape, device="cuda", generator=g) * 0.02).to(torch.bfloat16)
    labels = torch.randint(0, v, (n,), device="cuda", generator=g)
    labels[torch.rand(n, device="cuda", generator=g) < 0.1] = -100
    return h, w, labels


def _lce_case(torch, name, n, e, v, filter_eps=None, h_scale=1.0, tied=False):
    """Kernel z, dH, dW against the plain version from the same bf16 inputs. The
    upstream gradient is the loss's: 1 for a valid label, 0 for an ignored one.
    ``tied``: the unembedding is the transpose of a row-major (V, E) embedding, and
    dW is the embedding's gradient."""
    from automodel_tpu_torch.ops import linear_ce as lce
    from automodel_tpu_torch.ops import losses

    h, w, labels = _lce_inputs(torch, n, e, v, seed=n + e + v, h_scale=h_scale, tied=tied)
    unembed = (lambda x: x.t()) if tied else (lambda x: x)
    dz = (labels != -100).float()
    route = lce.lce_bwd_route(h, *lce.kernel_operand(unembed(w)))
    fwd_route = lce.lce_fwd_route(h, *lce.kernel_operand(unembed(w)))
    hk, wk = h.clone().requires_grad_(), w.clone().requires_grad_()
    before = dict(lce.ROUTE_LAUNCHES)
    z, _ = losses.fused_linear_ce_tokens(hk, unembed(wk), labels, filter_eps=filter_eps)
    grads = torch.autograd.grad(z, (hk, wk), dz)
    torch.cuda.synchronize()
    taken = {k: lce.ROUTE_LAUNCHES[k] - before[k] for k in before}
    out = {}
    refs = [("plain", filter_eps)] + ([("exact", None)] if filter_eps is not None else [])
    for ref_name, eps in refs:
        hr, wr = h.float().requires_grad_(), w.float().requires_grad_()
        z_ref = lce.fused_logsumexp_reference(hr, unembed(wr), eps)
        g_ref = torch.autograd.grad(z_ref, (hr, wr), dz)
        out[ref_name] = ((z - z_ref).abs().max().item(),
                         [_rel_l2(a, r) for a, r in zip(grads, g_ref)],
                         max((a.float() - r).abs().max().item() for a, r in zip(grads, g_ref)))
        del hr, wr, z_ref, g_ref
        torch.cuda.empty_cache()
    err_z, rel, err_grad = out["plain"]
    line = (f"lce case {name}: N={n} E={e} V={v} tied={tied} h_scale={h_scale} "
            f"filter_eps={filter_eps}, lce_fwd route {fwd_route}, lce_bwd route {route} "
            f"(launched {taken}): "
            f"z max abs {err_z:.3e} (tol {TOL_Z}), grad rel L2 dH {rel[0]:.3e} dW {rel[1]:.3e} "
            f"(tol {TOL_LCE_GRAD})")
    ok = err_z <= TOL_Z and max(rel) <= TOL_LCE_GRAD
    if taken != {k: int(k in (f"lce_fwd/{fwd_route}", f"lce_bwd/{route}")) for k in taken}:
        print(line, flush=True)
        raise AssertionError(f"lce case {name}: launched {taken}, named lce_fwd {fwd_route}, "
                             f"lce_bwd {route}")
    if filter_eps is not None:
        z_k, bmax = lce.lce_fwd(h, w, tied)  # the backward's own decision, from the forward
        sig = lce.block_significance(bmax, z_k, lce.TILE_N, math.log(filter_eps))
        skipped = 1.0 - sig.float().mean().item()
        ex = out["exact"][1]
        line += (f"; blocks skipped {skipped:.4f}; vs exact gradient rel L2 dH {ex[0]:.3e} "
                 f"dW {ex[1]:.3e} (bound {TOL_FILTER_EXACT})")
        ok = ok and skipped > 0 and max(ex) <= TOL_FILTER_EXACT
    print(line, flush=True)
    if not ok:
        raise AssertionError(f"lce case {name}: kernels disagree with the plain version")
    del h, w, hk, wk, z, grads
    torch.cuda.empty_cache()
    return err_z, err_grad


def _lce_dh_case(torch, name, n, e, v, filter_eps=None, h_scale=1.0, tied=False):
    """lce_bwd with dH alone (the unembedding frozen, as under LoRA: a null dw, no dW
    product) against the plain version's dH from the same bf16 inputs (rel. L2 within
    TOL_LCE_GRAD), and bitwise against the dH of the full call on the same inputs (the
    same products in the same order). Fails unless the frozen call went through
    lce_bwd/dh_only on the route lce_bwd_route names and the full one did not. Returns
    the max abs error of dH against the plain version."""
    from automodel_tpu_torch.ops import linear_ce as lce
    from automodel_tpu_torch.ops import losses

    h, w, labels = _lce_inputs(torch, n, e, v, seed=n + e + v + 1, h_scale=h_scale, tied=tied)
    unembed = (lambda x: x.t()) if tied else (lambda x: x)
    dz = (labels != -100).float()
    route = lce.lce_bwd_route(h, *lce.kernel_operand(unembed(w)))
    grads, taken = {}, {}
    for kind, w_grad in (("dh_only", False), ("full", True)):
        hk, wk = h.clone().requires_grad_(), w.clone().requires_grad_(w_grad)
        before = dict(lce.ROUTE_LAUNCHES)
        z, _ = losses.fused_linear_ce_tokens(hk, unembed(wk), labels, filter_eps=filter_eps)
        out = torch.autograd.grad(z, (hk, wk) if w_grad else (hk,), dz)
        torch.cuda.synchronize()
        taken[kind] = {k: lce.ROUTE_LAUNCHES[k] - before[k] for k in before
                       if k.startswith("lce_bwd")}
        grads[kind] = out[0]
        del hk, wk, z, out
    hr = h.float().requires_grad_()
    z_ref = lce.fused_logsumexp_reference(hr, unembed(w.float()), filter_eps)
    (dh_ref,) = torch.autograd.grad(z_ref, (hr,), dz)
    dh = grads["dh_only"]
    rel, err = _rel_l2(dh, dh_ref), (dh.float() - dh_ref).abs().max().item()
    bitwise = torch.equal(dh, grads["full"])
    want = {"dh_only": {f"lce_bwd/{route}": 1, "lce_bwd/dh_only": 1},
            "full": {f"lce_bwd/{route}": 1}}
    want = {kind: {k: want[kind].get(k, 0) for k in taken[kind]} for kind in want}
    print(f"lce dH-only case {name}: N={n} E={e} V={v} tied={tied} h_scale={h_scale} "
          f"filter_eps={filter_eps}, route {route} (launched {taken}): dH rel L2 vs plain "
          f"{rel:.3e} (tol {TOL_LCE_GRAD}), max abs {err:.3e}; bitwise equal to the full "
          f"call's dH: {bitwise}", flush=True)
    if taken != want:
        raise AssertionError(f"lce dH-only case {name}: launched {taken}, not {want}")
    if rel > TOL_LCE_GRAD or not bitwise:
        raise AssertionError(f"lce dH-only case {name}: dH disagrees (rel L2 {rel:.3e}, "
                             f"bitwise {bitwise})")
    del h, w, hr, z_ref, dh_ref, grads
    torch.cuda.empty_cache()
    return err


# dH-only cases: the wgmma route untied and tied (the filter on, as on the main paths),
# and the mma.sync route (V = 50,257; E = 1003 tied)
LCE_DH_CASES = (("dh-a", 8192, 2048, 128256), ("dh-b", 8192, 2048, 128256, 1e-7, 32.0, True),
                ("dh-c", 8190, 2048, 50257, 1e-7), ("dh-d", 256, 1003, 3001, None, 1.0, True))


def _library_dh(torch, h, w, dz):
    """The dH-only yardstick: autograd's gradient in h alone of the same logsumexp (the
    (N, V) logits formed and their gradient), timed here and used nowhere in the port."""
    hl = h.detach().requires_grad_()
    return torch.autograd.grad(_library_lse(torch, hl, w), (hl,), dz)


def _lce_dh_work(n, e, v):
    """FLOPs and bytes of lce_bwd with dH alone at (N, E, V): 4NEV (the recompute and the
    dH product); h and w read, z and dz read, dH written."""
    return 4 * n * e * v, 2 * (n * e + e * v) + 2 * n * e + 4 * n * 2


def _lce_dh_row(torch, lce, h, w, z, dz, plain=True):
    """The timing row of lce_bwd with dH alone on (h, w), with its plain version (the
    reference's gradient in h alone) and yardstick, each None with the reason where the
    card cannot hold its f32 logits."""
    n, e = h.shape
    v = w.shape[1]
    flops, nbytes = _lce_dh_work(n, e, v)
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    row = {"ms": _time_ms(torch, lambda: lce.lce_bwd(h, w, z, dz, None, need_dw=False),
                          warmup=1, reps=3 if n > 8192 else 20),
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "plain_ms": None, "library_ms": None, "route": lce.lce_bwd_route(h, w),
           "library": "torch.autograd.grad(torch.logsumexp((h @ w).float(), -1), h)"}

    def plain_dh():
        hp = h.detach().requires_grad_()
        return torch.autograd.grad(lce.fused_logsumexp_reference(hp, w), (hp,), dz)

    for key, fn, run in (("plain_ms", plain_dh, plain),
                         ("library_ms", lambda: _library_dh(torch, h, w, dz), True)):
        if not run:
            continue
        try:
            row[key] = _time_ms(torch, fn, warmup=1, reps=2 if n > 8192 else 5)
        except torch.cuda.OutOfMemoryError as exc:  # the row keeps None and the reason
            row[f"{key}_note"] = f"not timed: {str(exc).splitlines()[0][:160]}"
        torch.cuda.empty_cache()
    print(f"time lce_bwd/dh_only at N={n} E={e} V={v} ({row['route']}): {row['ms']:.3f} ms, "
          f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}: {flops / 1e12:.2f} TFLOP, "
          f"{nbytes / 1e6:.1f} MB), plain {row['plain_ms']} ms, yardstick "
          f"{row['library_ms']} ms", flush=True)
    return row


def _library_lse(torch, h, w):
    """The yardstick: one PyTorch call chain for the same z, timed here and used
    nowhere in the port (it forms the (N, V) logits)."""
    return torch.logsumexp((h @ w).float(), -1)


def _lce_timings(torch, n=8192, e=2048, v=128256, large=True, tied=False):
    """ms of each linear-CE kernel at shape (a), or (N, E, V) as given, with bound, plain
    version and yardstick; ``large``: also at main path 7's shape; ``tied``: the
    unembedding the transpose of a row-major (V, E) embedding, as a tied model hands it."""
    from automodel_tpu_torch.ops import linear_ce as lce

    h, w, _ = _lce_inputs(torch, n, e, v, seed=7, tied=tied)
    if tied:
        w = w.t()
    dz = torch.ones(n, device="cuda")
    fwd_flops = 2 * n * e * v
    bwd_flops, bwd_bytes = _lce_work(n, e, v)
    fwd_bytes = _lce_fwd_bytes(n, e, v)
    z, _ = lce.lce_fwd(h, w)
    fwd_ms = _time_ms(torch, lambda: lce.lce_fwd(h, w))
    bwd_ms = _time_ms(torch, lambda: lce.lce_bwd(h, w, z, dz, None))
    plain_fwd = _time_ms(torch, lambda: lce.fused_logsumexp_reference(h, w), warmup=1, reps=3)
    hp, wp = h.clone().requires_grad_(), w.clone().requires_grad_()
    z_plain = lce.fused_logsumexp_reference(hp, wp)
    plain_bwd = _time_ms(torch, lambda: torch.autograd.grad(z_plain, (hp, wp), dz,
                                                            retain_graph=True), warmup=1, reps=3)
    del z_plain
    torch.cuda.empty_cache()
    lib_fwd = _time_ms(torch, lambda: _library_lse(torch, h, w), warmup=1, reps=3)
    hl, wl = h.clone().requires_grad_(), w.clone().requires_grad_()
    z_lib = _library_lse(torch, hl, wl)
    lib_bwd = _time_ms(torch, lambda: torch.autograd.grad(z_lib, (hl, wl), dz, retain_graph=True),
                       warmup=1, reps=3)
    del z_lib
    torch.cuda.empty_cache()
    out = {}
    for name, ms, flops, nbytes, plain, lib in (
            ("lce_fwd", fwd_ms, fwd_flops, fwd_bytes, plain_fwd, lib_fwd),
            ("lce_bwd", bwd_ms, bwd_flops, bwd_bytes, plain_bwd, lib_bwd)):
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        print(f"time {name} at N={n} E={e} V={v}{' tied' if tied else ''}: {ms:.3f} ms, bound "
              f"{out[name]['bound_ms']:.3f} ms ({out[name]['bound_by']}: {flops / 1e12:.2f} "
              f"TFLOP, {nbytes / 1e6:.1f} MB), plain {plain:.3f} ms, yardstick {lib:.3f} ms",
              flush=True)
    out["lce_fwd"]["route"] = lce.lce_fwd_route(h, w)
    out["lce_bwd"]["route"] = lce.lce_bwd_route(h, w)
    out["lce_bwd/dh_only"] = _lce_dh_row(torch, lce, h, w, z, dz)
    del h, w, z, dz
    torch.cuda.empty_cache()
    if large:
        (out["lce_fwd"]["at_path7_shape"], out["lce_bwd"]["at_path7_shape"],
         out["lce_bwd/dh_only"]["at_path7_shape"]) = _lce_timing_large(torch)
    return out


def _lce_work(n, e, v):
    """FLOPs and bytes of lce_bwd at (N, E, V): 6NEV (the recompute and two products);
    h and w read, z and dz read, dH and dW written."""
    return 6 * n * e * v, 2 * 2 * (n * e + e * v) + 4 * n * 2


def _lce_fwd_bytes(n, e, v):
    """Bytes of lce_fwd at (N, E, V): h and w read, z (N,) and bmax (ceil(V/128), N)
    written, all once."""
    return 2 * (n * e + e * v) + 4 * n + 4 * -(-v // 128) * n


def _lce_timing_large(torch):
    """Rows of lce_fwd and lce_bwd at main path 7's shape (N = 32768 tokens, E = 4096,
    V = 128,256) beside their bounds. lce_fwd also beside its plain version and
    yardstick, each of which forms the f32 (N, V) logits (16.8 GB) and logsumexp's
    two temporaries of that size: where the card cannot hold them, the row says so.
    lce_bwd has neither: with autograd's gradient of the logits they need ~70 GB."""
    from automodel_tpu_torch.ops import linear_ce as lce

    n, e, v = 32768, LLAMA3_8B["hidden_size"], LLAMA3_8B["vocab_size"]
    h, w, _ = _lce_inputs(torch, n, e, v, seed=9)
    dz = torch.ones(n, device="cuda")
    z, _ = lce.lce_fwd(h, w)
    chunk = lce.lce_chunk(n, v)
    times = {"lce_fwd": (_time_ms(torch, lambda: lce.lce_fwd(h, w), warmup=1, reps=3),
                         2 * n * e * v, _lce_fwd_bytes(n, e, v), lce.lce_fwd_route(h, w)),
             "lce_bwd": (_time_ms(torch, lambda: lce.lce_bwd(h, w, z, dz, None), warmup=1,
                                  reps=5), *_lce_work(n, e, v), lce.lce_bwd_route(h, w))}
    del z, dz
    torch.cuda.empty_cache()
    rows = {}
    for name, (ms, flops, nbytes, route) in times.items():
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        rows[name] = {"ms": ms, "bound_ms": max(t_ops, t_bytes),
                      "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                      "plain_ms": None, "library_ms": None, "route": route,
                      "shape": {"N": n, "E": e, "V": v},
                      "library": "not timed: with autograd the f32 logits need ~70 GB"}
        if name == "lce_bwd":
            rows[name]["chunk"] = chunk
        print(f"time {name} at N={n} E={e} V={v} ({route}"
              + (f", vocab chunks of {chunk}" if name == "lce_bwd" else "")
              + f"): {ms:.3f} ms, bound {rows[name]['bound_ms']:.3f} ms "
              f"({rows[name]['bound_by']}: {flops / 1e12:.2f} TFLOP, {nbytes / 1e6:.1f} MB)",
              flush=True)
    fwd = rows["lce_fwd"]
    for key, fn in (("library_ms", lambda: _library_lse(torch, h, w)),
                    ("plain_ms", lambda: lce.fused_logsumexp_reference(h, w))):
        try:
            fwd[key] = _time_ms(torch, fn, warmup=1, reps=2)
        except torch.cuda.OutOfMemoryError as exc:  # the row keeps None and the reason
            fwd[f"{key}_note"] = f"not timed: {str(exc).splitlines()[0][:160]}"
        torch.cuda.empty_cache()
    fwd["library"] = "torch.logsumexp((h @ w).float(), -1)"
    print(f"time lce_fwd at N={n} E={e} V={v}: plain {fwd['plain_ms']} ms, yardstick "
          f"{fwd['library_ms']} ms", flush=True)
    z, _ = lce.lce_fwd(h, w)
    dz = torch.ones(n, device="cuda")
    # dH alone: the plain version's f32 logits and their gradient would not fit beside it
    dh = _lce_dh_row(torch, lce, h, w, z, dz, plain=False)
    dh["plain_ms_note"] = "not timed: the f32 logits and their gradient need ~50 GB"
    dh["shape"] = {"N": n, "E": e, "V": v}
    del h, w, z, dz
    torch.cuda.empty_cache()
    return rows["lce_fwd"], rows["lce_bwd"], dh


def _kernel_times(torch):
    """ms of flash_fwd, flash_dq and flash_dkv (causal, no cap) at flash shapes (a), (f),
    (L), GPT-OSS's (G) and with its window (Gw), Phi-3's (P) and with its window (Pw),
    and Gemma-2-27B's heads at its scale (G2), of gmm (forward and dX) and tgmm at the
    slice's shapes (a) and (b), of lce_fwd and lce_bwd at N=8192, E=2048, V=128,256 and at
    main path 7's shape, of ring_fwd and ring_bwd at ring case (a)'s diagonal step and
    step 1, and of ring_fwd, ring_dq and ring_dkv at (192, 128) shape (M)'s, on the inputs
    their timing rows use, called only through the wrapper calls that the package has had
    since the ring took (192, 128) (``flash_fwd(q, k, v, seg_q, seg_kv, scale, causal[,
    window])``, ``flash_dq`` / ``flash_dkv(..., do, lse, delta, scale, causal[, window])``,
    ``gmm(x,
    w, ends, transpose_w)``, ``tgmm(x, dout, ends, e)``, ``lce_fwd(h, w)``, ``lce_bwd(h,
    w, z, dz, None)``, ``ring_fwd(q, k, v, pos_q, pos_kv, seg_q, seg_kv, acc, m, l,
    **kw)``, ``ring_bwd(...)``, ``ring_dq(...)``, ``ring_dkv(...)``), so that
    ``--kernel-times ROOT`` can time an older checkout's kernels beside this one's. The
    flash kernels are timed by ``_time_ms``'s defaults and again at 3 warmups and 20 reps
    (rows ending "3/20"), so that a change of the timing method can be told apart from
    one of the code."""
    from automodel_tpu_torch.ops import flash_attention as fa
    from automodel_tpu_torch.ops import grouped_gemm as gg
    from automodel_tpu_torch.ops import linear_ce as lce

    out = {}
    gemma2 = GEMMA2_27B["query_pre_attn_scalar"]**-0.5
    window = PHI3_MINI["sliding_window"]
    for case, shape, win, scale in (
            ("a", (4, 2048, 32, 8, 64), (), None), ("f", (4, 2048, 32, 4, 128), (), None),
            ("L", (1, 32768, 32, 8, 128), (), None), ("G", (1, 8192, 64, 8, 64), (), None),
            ("Gw", (1, 8192, 64, 8, 64), (128,), None), ("P", (4, 2048, 32, 32, 96), (), None),
            ("Pw", (4, 2048, 32, 32, 96), (window,), None),
            ("G2", (2, 2048, 32, 16, 128), (), gemma2)):
        q, k, v, do = _inputs(torch, *shape, seed=1)
        scale = q.shape[-1]**-0.5 if scale is None else scale
        o, lse = fa.flash_fwd(q, k, v, None, None, scale, True, *win)
        delta = fa._delta(o, do)
        calls = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, None, None, scale, True, *win),
                 "flash_dq": lambda: fa.flash_dq(q, k, v, None, None, do, lse, delta, scale,
                                                 True, *win),
                 "flash_dkv": lambda: fa.flash_dkv(q, k, v, None, None, do, lse, delta,
                                                   scale, True, *win)}
        for name, call in calls.items():
            out[f"{name} ({case})"] = _time_ms(torch, call)
            out[f"{name} ({case}) 3/20"] = _time_ms(torch, call, warmup=3, reps=20)
        del q, k, v, do, o, lse, delta, calls
        torch.cuda.empty_cache()
    sizes = _router_group_sizes(torch, 8192, 2048, 128, 8)
    ends = gg._ends(sizes)
    for case, d, f in (("a", 2048, 1536), ("b", 768, 2048)):
        x, w, dout = _gmm_inputs(torch, sizes, d, f, seed=11)
        out[f"gmm forward {case}"] = _time_ms(torch, lambda: gg.gmm(x, w, ends))
        out[f"gmm dX {case}"] = _time_ms(torch, lambda: gg.gmm(dout, w, ends, transpose_w=True))
        out[f"tgmm {case}"] = _time_ms(torch, lambda: gg.tgmm(x, dout, ends, sizes.numel()))
        del x, w, dout
    for shape, n, e, seed, reps in (("N=8192 E=2048", 8192, 2048, 7, 20),
                                    ("N=32768 E=4096", 32768, LLAMA3_8B["hidden_size"], 9, 5)):
        h, w, _ = _lce_inputs(torch, n, e, LLAMA3_8B["vocab_size"], seed=seed)
        dz = torch.ones(n, device="cuda")
        z, _ = lce.lce_fwd(h, w)
        out[f"lce_fwd {shape}"] = _time_ms(torch, lambda: lce.lce_fwd(h, w), warmup=1, reps=reps)
        out[f"lce_bwd {shape}"] = _time_ms(torch, lambda: lce.lce_bwd(h, w, z, dz, None),
                                           warmup=1, reps=reps)
        del h, w, z, dz
        torch.cuda.empty_cache()
    calls, state = _ring_launches(torch, (0, 1))
    for step, (_, fwd, bwd, *_) in calls.items():
        label = "diagonal step" if step == 0 else f"step {step}"
        out[f"ring_fwd (a) {label}"] = _time_ms(torch, fwd, warmup=2, reps=10)
        out[f"ring_bwd (a) {label}"] = _time_ms(torch, bwd, warmup=2, reps=10)
    del calls, state
    calls, state = _mla_ring_calls(torch, MLA_RING["M"])
    for step, (_, fns) in calls.items():
        for name, fn in fns.items():
            label = "diagonal step" if step == 0 else f"step {step}"
            out[f"{name} (M) {label}"] = _time_ms(torch, fn, warmup=2, reps=10)
    del calls, state
    torch.cuda.empty_cache()
    for name, ms in out.items():
        print(f"kernel time {name}: {ms:.3f} ms", flush=True)
    return out


def _lce_memory(torch):
    """Peak device memory one forward and backward of linear_cross_entropy adds over
    its inputs (h, w, labels) and outputs (their gradients), at shape (a)."""
    from automodel_tpu_torch.ops import losses

    h, w, labels = _lce_inputs(torch, 8192, 2048, 128256, seed=3)
    h.requires_grad_()
    w.requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss = losses.linear_cross_entropy(h, w, labels, impl="pallas")
    loss.backward()
    torch.cuda.synchronize()
    grads = h.grad.numel() * 2 + w.grad.numel() * 2
    extra = (torch.cuda.max_memory_allocated() - base - grads) / 1e9
    print(f"lce memory: one forward + backward of linear_cross_entropy at N=8192 E=2048 "
          f"V=128256 adds {extra:.3f} GB of peak over inputs and outputs "
          f"(limit {LCE_PEAK_LIMIT_GB} GB; loss {loss.item():.4f})", flush=True)
    if extra >= LCE_PEAK_LIMIT_GB:
        raise AssertionError("linear_cross_entropy formed a tensor as large as the logits")
    del h, w, labels, loss
    torch.cuda.empty_cache()
    return extra


def main(argv: list[str]) -> int:
    # every phase and main path runs in this one process: segments that grow in place keep
    # one path's freed memory usable by the next (with fixed segments, main path 11 once
    # failed to allocate 7.9 GiB beside 32.7 GiB reserved but split); read by the caching
    # allocator at its first allocation, and inherited by the deterministic paths' child
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if argv and not ((argv[0] == "--cp-processes" and len(argv) == 2)
                     or (argv[0] == "--kernel-times" and len(argv) <= 2)):
        print("usage: chip_smoke.py [--cp-processes N | --kernel-times [ROOT]]",
              file=sys.stderr)
        return 2
    root = os.path.abspath(argv[1]) if argv[:1] == ["--kernel-times"] and argv[1:] else HERE
    if not os.path.isdir(os.path.join(root, "automodel_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(f"card: {_card_line()}", flush=True)
    start = time.perf_counter()

    def mark(phases):  # the script's clock after each group of phases (its 1200 s limit)
        print(f"elapsed: {phases} done at {time.perf_counter() - start:.1f} s", flush=True)

    from automodel_tpu_torch.kernels import build
    from automodel_tpu_torch.ops import flash_attention as fa

    # the plain versions and the yardsticks are f32 / bf16 products in full precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    seconds = build.build_all()
    print(f"build: {seconds:.1f} s", flush=True)
    for source, log in build.BUILD_LOGS.items():
        for line in _ptxas_report(log):
            print(f"  {source}: {line}")
    if argv:  # one option, one phase, and nothing else
        # --cp-processes N: the process-group ring across N cards; --kernel-times [ROOT]:
        # the grouped GEMM, linear-CE and ring kernels of the package in ROOT (default:
        # this checkout)
        print(json.dumps({"process_group_ring": _pg_ring_phase(torch, int(argv[1]))}
                         if argv[0] == "--cp-processes"
                         else {"kernel_times": _kernel_times(torch), "package": root}))
        print(f"card: {_card_line()}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0

    errs = {}
    twice = _twice_phase(torch)
    _flash_phase(torch, fa, errs)
    mark("build, twice-launch and flash cases")
    timings = _timings(torch, fa)
    for name, row in _timings(torch, fa, 4, 2048, 32, 4, 128).items():
        timings[name]["at_d128"] = row
    mark("flash timings (a), (d128)")
    gpt_oss = _window_timings(torch, fa)
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        timings[name]["at_gpt_oss"] = gpt_oss[name]
    timings["flash_dq"]["at_gpt_oss"]["whole_backward"] = gpt_oss["flash_backward"]
    for key, window in (("at_phi3", None), ("at_phi3_window", PHI3_MINI["sliding_window"])):
        for name, row in _timings(torch, fa, 4, 2048, 32, 32, 96, window).items():
            timings[name][key] = row
    # (G2) main path 19's attention, Gemma-2-27B's heads at its query scale, without and
    # with its cap
    for key, cap in (("at_gemma2", None),
                     ("at_gemma2_softcap", GEMMA2_27B["attn_logit_softcapping"])):
        for name, row in _timings(torch, fa, 2, 2048, 32, 16, 128, softcap=cap,
                                  scale=GEMMA2_27B["query_pre_attn_scalar"]**-0.5).items():
            timings[name][key] = row
    # head_dim 256: (G9) / (G9c) main path 21's attention, Gemma-2-9B's heads without and
    # with its cap; (G4w) main path 22's sliding layers, Gemma-3-4B's heads and window 1024
    for key, shape, kw in (
            ("at_gemma2_9b", (2, 2048, 16, 8), {}),
            ("at_gemma2_9b_softcap", (2, 2048, 16, 8),
             {"softcap": GEMMA2_9B["attn_logit_softcapping"]}),
            ("at_gemma3_4b_window", (2, 2048, 8, 4),
             {"window": GEMMA3_4B_TEXT["sliding_window"]})):
        for name, row in _timings(torch, fa, *shape, 256, scale=256**-0.5, **kw).items():
            timings[name][key] = row
    # (C) main path 30's sliding layers: Command R7B's heads, window 4096 over rows of 8192
    for name, row in _timings(torch, fa, 1, COMMAND_R7B_SEQ, 32, 8, 128,
                              window=COMMAND_R7B["sliding_window"]).items():
        timings[name]["at_command_r7b_window"] = row
    # (Bq) / (Bp) main path 35's towers, non-causal over right-padded rows at Llama-3.2-1B's
    # 32 heads over 8: 32 queries of 64, 64 passages of 256; (GPT) main path 37's causal
    # MHA, 12 heads over 12, 16 rows of 1024
    for key, shape, kw in (
            ("at_biencoder_queries", (32, 64), {"causal": False,
                                                "seg": _right_padded(torch, 32, 64, 1)}),
            ("at_biencoder_passages", (64, 256), {"causal": False,
                                                  "seg": _right_padded(torch, 64, 256, 2)}),
            ("at_gpt2", (16, 1024), {"h": 12, "kh": 12})):
        heads = {"h": kw.pop("h", 32), "kh": kw.pop("kh", 8)}
        for name, row in _timings(torch, fa, *shape, **heads, d=64, **kw).items():
            timings[name][key] = row
    mark("flash timings")
    _refused_on_the_card(torch, fa)
    _ring_refused_on_the_card(torch)
    _model_check(torch)

    errs.update({"lce_fwd": 0.0, "lce_bwd": 0.0})
    for case in (("a", 8192, 2048, 128256), ("b", 8192, 2048, 128256, 1e-7, 32.0),
                 ("c", 8190, 2048, 50257), ("d", 4096, 4096, 128256),
                 ("e", 8192, 2048, 128256, 1e-7, 32.0, True), ("f", 1024, 1000, 50257),
                 ("g", 256, 1003, 3001, None, 1.0, True), ("h", 256, 8, 16, None, 1.0, True),
                 ("i", 1024, 1000, 50264), ("j", 8192, 2880, 201088),
                 ("k", 8192, 4096, 256000, None, 1.0, True), ("l", 8192, 4096, 151552)):
        err_z, err_grad = _lce_case(torch, *case)
        errs["lce_fwd"] = max(errs["lce_fwd"], err_z)
        errs["lce_bwd"] = max(errs["lce_bwd"], err_grad)
    errs["lce_bwd/dh_only"] = max(_lce_dh_case(torch, *case) for case in LCE_DH_CASES)
    timings.update(_lce_timings(torch))
    for name, row in _lce_timings(torch, 8192, 2880, 201088, large=False).items():
        timings[name]["at_gpt_oss"] = row
    # (R) main path 30's: Command R7B's tied unembedding over a microbatch of 8192 tokens
    for name, row in _lce_timings(torch, 8192, 4096, 256000, large=False, tied=True).items():
        timings[name]["at_command_r7b"] = row
    _lce_memory(torch)
    mark("linear-CE phase")
    timings.update(_gmm_phase(torch, errs))
    _moe_model_check(torch)
    mark("grouped GEMM phase")
    _ring_phase(torch, errs)
    _mla_ring_phase(torch, errs)
    timings.update(_ring_timings(torch))
    for shape, rows in _mla_ring_timings(torch).items():
        for name, row in rows.items():
            timings[name].setdefault("at_d192_dv128", {})[shape] = row
    _ring_model_check(torch)
    mark("linear-CE, grouped GEMM and ring phases")

    by_path, losses = {}, {}
    by_path["main path 1"], losses[1] = _bench_path("main path 1", BENCH_YAML, linear_ce=False)
    mark("path 1")
    by_path["main path 2"], _ = _bench_path("main path 2", SEQ4096_YAML, linear_ce=True)
    mark("path 2")
    by_path["main path 3"], _ = _train_ft_path(
        "main path 3", SEQ4096_YAML, ["--packed_sequence.packed_sequence_size", "4096",
                                      "--dataset.seq_len", "1000",
                                      "--backend.attention_segments", "true"])
    mark("path 3")
    by_path["main path 4"], losses[4] = _bench_path("main path 4", BENCH_YAML, linear_ce=True,
                                                    overrides=("--loss.name", "linear_ce"))
    d_first = abs(losses[4][0] - losses[1][0])
    print(f"main path 4 vs 1 (linear_ce, tied, vs masked_ce): first-step loss |diff| "
          f"{d_first:.3e} (tol {TOL_TIED_LOSS})", flush=True)
    if d_first > TOL_TIED_LOSS:
        raise AssertionError("main path 4: tied linear_ce disagrees with masked_ce")
    by_path["main path 5"], _ = _bench_path("main path 5", MOE_YAML, linear_ce=True,
                                            overrides=qwen3_args())
    mark("path 5")
    by_path["main path 6"], _ = _train_ft_path(
        "main path 6", MOE_YAML, [*qwen3_args(MOE_LAYERS_TRAIN_FT),
                                  "--packed_sequence.packed_sequence_size", "2048",
                                  "--dataset.seq_len", "500"])
    mark("path 6")
    with tempfile.TemporaryDirectory() as cfg_dir:
        cp_yaml = cp_config(cfg_dir)
        by_path["main path 7"], _ = _bench_path("main path 7", cp_yaml, linear_ce=True,
                                                overrides=llama3_8b_args())
        by_path["main path 8"], _ = _train_ft_path("main path 8", cp_yaml, _cp_train_ft_args())
    mark("paths 1-8")
    by_path["main path 9"] = _baseline_path("main path 9")
    mark("path 9")
    by_path.update(_deterministic_paths())
    mark("paths 9-10 under the deterministic flag")
    by_path["main path 11"], _ = _bench_path("main path 11", GPT_OSS_YAML, linear_ce=True,
                                             overrides=gpt_oss_args())
    mark("path 11")
    by_path["main path 12"], _ = _train_ft_path(
        "main path 12", GPT_OSS_YAML, [*gpt_oss_args(GPT_OSS_LAYERS_TRAIN_FT),
                                       "--packed_sequence.packed_sequence_size", "2048",
                                       "--dataset.seq_len", "500",
                                       "--backend.attention_segments", "true"])
    mark("path 12")
    by_path["main path 13"], _ = _bench_path("main path 13", PHI3_YAML, linear_ce=False,
                                             overrides=phi3_args())
    mark("path 13")
    by_path["main path 14"] = _phi3_train_ft_path("main path 14")
    mark("path 14")
    by_path["main path 15"], _ = _bench_path("main path 15", DSV3_PROXY_YAML, linear_ce=True)
    mark("paths 11-15")
    by_path["main path 16"] = _moonlight_train_ft_path("main path 16")
    mark("path 16")
    by_path["main path 17"], _ = _bench_path("main path 17", DSV3_PROXY_YAML, linear_ce=True,
                                             overrides=moonlight_ring_args())
    by_path["main path 18"], _ = _bench_path("main path 18", GEMMA3_PROXY_YAML, linear_ce=True,
                                             overrides=gemma3_proxy_args())
    by_path["main path 19"], _ = _bench_path("main path 19", GEMMA3_PROXY_YAML, linear_ce=True,
                                             overrides=gemma2_args())
    mark("paths 17-19")
    by_path["main path 20"] = _gemma2_train_ft_path("main path 20")
    mark("path 20")
    by_path["main path 21"], _ = _bench_path("main path 21", GEMMA3_PROXY_YAML, linear_ce=True,
                                             overrides=gemma2_args(GEMMA2_9B_LAYERS, GEMMA2_9B))
    by_path["main path 22"], _ = _bench_path(
        "main path 22", GEMMA3_PROXY_YAML, linear_ce=True,
        overrides=gemma2_args(GEMMA3_4B_TEXT["num_hidden_layers"], GEMMA3_4B_TEXT))
    mark("paths 21-22")
    by_path["main path 23"] = _gemma3_train_ft_path("main path 23")
    mark("path 23")
    _nf4_phase(torch)
    by_path.update(_peft_paths())
    mark("paths 24-29")
    by_path["main path 30"] = _command_r7b_train_ft_path("main path 30")
    mark("path 30")
    by_path["main path 31"], _ = _bench_path("main path 31", MIXTRAL_YAML, linear_ce=False,
                                             overrides=mixtral_args())
    mark("path 31")
    by_path.update(_lineage_paths())
    mark("path 32")
    by_path.update(_encoder_paths())
    mark("paths 33-37")
    by_path.update(_family_paths())
    _delta_net_timings(torch)
    mark("paths 38-41")

    flash = "automodel_tpu/ops/pallas/flash_attention.py"
    lce_src = "automodel_tpu/ops/pallas/linear_ce.py"
    gmm_src = "automodel_tpu/ops/pallas/grouped_gemm.py"
    ring_src = "automodel_tpu/ops/pallas/ring_chunk.py"
    replaces = {"flash_fwd": (f"{flash}:84", []),
                "flash_dq": (f"{flash}:151", [f"{flash}:192"]),
                "flash_dkv": (f"{flash}:258", [f"{flash}:192"]),
                "lce_fwd": (f"{lce_src}:105", []),
                "lce_bwd": (f"{lce_src}:137", [f"{lce_src}:163"]),
                "lce_bwd/dh_only": (f"{lce_src}:137", []),
                "gmm": (f"{gmm_src}:126", []),
                "tgmm": (f"{gmm_src}:151", []),
                "ring_fwd": (f"{ring_src}:110", []),
                "ring_bwd": (f"{ring_src}:204", []),
                "ring_dq": (f"{ring_src}:204", []),
                "ring_dkv": (f"{ring_src}:204", [])}
    sources = {"flash_fwd": "flash_attention.cu",
               "flash_dq": "flash_attention.cu", "flash_dkv": "flash_attention.cu",
               "lce_fwd": "linear_ce.cu", "lce_bwd": "linear_ce.cu",
               "lce_bwd/dh_only": "linear_ce.cu",
               "gmm": "grouped_gemm.cu", "tgmm": "grouped_gemm.cu",
               "ring_fwd": "ring_chunk.cu", "ring_bwd": "ring_chunk.cu",
               "ring_dq": "ring_chunk.cu", "ring_dkv": "ring_chunk.cu"}
    # lce_bwd's launches with dH alone (a frozen unembedding) have their own row; the
    # lce_bwd row counts the full ones
    for counts in by_path.values():
        counts["lce_bwd/full"] = counts["lce_bwd"] - counts["lce_bwd/dh_only"]
    counted = {"lce_bwd": "lce_bwd/full"}
    kernels = []
    for name in replaces:
        timing = dict(timings[name])
        # the contract's route is the language (every kernel here is CUDA C++); a timed
        # GEMM-core kernel's wgmma / mma_sync route stays beside it as kernel_route
        kernel_route = timing.pop("route", None)
        row = {"name": name, **timing, "route": "cuda",
               "source": f"automodel_tpu_torch/csrc/{sources[name]}",
               "replaces": replaces[name][0],
               "launches": sum(counts[counted.get(name, name)] for counts in by_path.values()),
               "max_abs_err": errs[name],
               "launches_by_path": {p: counts[counted.get(name, name)]
                                    for p, counts in by_path.items()}}
        if kernel_route is not None:
            row["kernel_route"] = kernel_route
        if replaces[name][1]:
            row["replaces_by_function"] = replaces[name][1]
        if name in ROUTED:  # main-path launches by route (lce_bwd: full and dH alone)
            row["launches_by_route"] = {
                r: sum(counts[f"{name}/{r}"] for counts in by_path.values())
                for r in ("wgmma", "mma_sync")}
        if name in ("ring_dq", "ring_dkv"):  # a part of _chunk_bwd_kernel
            row["replaces_part"] = "dq" if name == "ring_dq" else "dk, dv"
        if name.startswith("ring_"):  # the launches by (D, Dv)
            row["launches_by_dims"] = {
                dims: sum(counts.get(f"{name}/{dims}", 0) for counts in by_path.values())
                for dims in ("d64v64", "d128v128", "d192v128")}
        if name.startswith("flash_"):  # the launches with a window, a cap, by head dim
            row["launches_windowed"] = {p: counts.get(f"{name}/windowed", 0)
                                        for p, counts in by_path.items()}
            row["launches_softcap"] = {p: counts.get(f"{name}/softcap", 0)
                                       for p, counts in by_path.items()}
            row["launches_noncausal"] = {p: counts[f"{name}/noncausal"]
                                         for p, counts in by_path.items()
                                         if counts.get(f"{name}/noncausal")}
            row["launches_by_head_dim"] = {
                f"d{d}": sum(counts.get(f"{name}/d{d}", 0) for counts in by_path.values())
                for d in fa._HEAD_DIMS}
        kernels.append(row)
    idle = [row["name"] for row in kernels if row["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels no main path launched: {idle}")
    print(f"twice-launch phase: {json.dumps(twice['differ'])}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {_card_line()}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

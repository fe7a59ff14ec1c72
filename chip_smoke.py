#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase catches and continues):

1. print the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions;
2. build every CUDA kernel from ``src/repro_torch/csrc`` with ``nvcc``
   for ``sm_90a``, one compiler per source, all started together;
3. hold each of the 10 kernels against its plain PyTorch version on the
   card and time both with CUDA events (median of 25 runs) beside the
   kernel's bound (bytes at the H100's 3.35 TB/s or operations at its
   peak for their type): the 7 training kernels at the shapes
   paper-lm-100m's two training paths give them (bit-exact; the pass-1
   moments within 8 ulp), plus a block of rows with NaN, +-inf, zeros
   and ties through every pass-1 kernel at k_b 1, 10, 41, 102 and 1024,
   ``ef_block_stats`` through its only path,
   ``ops.fused_ef_compress(telemetry=False)``, with the launch counts set
   to 0 just before and read just after; ``block_stats`` also checked
   and timed at the largest CSGD leaf at k_b 10, 41 and 102 (gamma 1%,
   4%, 10%) beside ``torch.topk`` (timed only), host launch included and
   on the device alone; both EF pass-1 kernels checked (tau bit-exact,
   moments within 8 ulp) and timed the same two ways at the trainer's
   rows at k_b 10, 41 and 102; the codec kernels ``pack_words`` and
   ``unpack_words`` bit-exact at the trainer's 16-bit index streams at
   gamma 1%, 4% and 10% and its 8-bit value stream at 1%, each timed
   host launch included, on the device alone (and with L2 evicted) and
   by the host's time a call, beside the narrowing casts that compute
   the same function (timed only), and bit-exact at 4 bits, ragged
   rows, an input base one word or field off 16 bytes and lengths no
   multiple of 4 words; the ragged variants ``pack_words_ragged`` and
   ``unpack_words_ragged`` bit-exact at every section of the perleaf
   trainer's rows at k_b_t 41, 72 and 102 (and counts that differ per
   row), timed at its largest, the embedding row's 16-bit index section
   (626,688 words), at k_b_t 41; ptxas spills in ``ef_topk.cu`` and
   ``wire_pack.cu`` are fatal; the 3 serving
   kernels at the shapes serving gives them (flash attention's bf16
   tensor-core route at qwen1.5-4b's prefill, (4, 20, 2048, 128) causal,
   and at 20 edge cases that cross every tile edge, through strided
   (B, S, H, D) views, within 1 bf16 ulp of the plain value plus 1e-5,
   with its ptxas line (registers, shared memory, spills: none allowed);
   its f32 CUDA-core route at small cases with a window, without
   causality, with Sq < Sk and at D 32, atol 3e-5, and timed at the qwen
   shape on an earlier line; RMSNorm at (8192, 2560),
   (4, 2560), (8192, 1024), (4, 1024) and (4096, 2048) bf16 within 1 bf16 ulp and (4096, 2048) f32
   within 1e-5, its ptxas spills none; WKV at (4, 1024, 32, 64) and at
   S = 1 within 2e-5, timed at both, its ptxas spills none),
   beside the library calls ``F.scaled_dot_product_attention`` and
   ``F.rms_norm`` (timed only; the port never calls them); and flash
   attention without causality at the encoder-decoder's shapes (phase
   4o lists them);
4. run the DCSGD-ASSS trainer (``repro_torch.launch.train``) on
   paper-lm-100m at full width — 12 layers, d_model 768, vocab 16384,
   seq 256, global batch 8, ``--compress-method block_topk`` — for 4
   steps, with every launch count set to 0 just before and read just
   after, then 2 steps at ``--value-bits 8`` and 2 at ``--gamma 0.1``
   (k_b 102, the paper's 10%) the same way;
4b. profile one warm trainer step at gamma 0.01 and one at gamma 0.1:
   device time by kernel group, the device's idle share and the host
   time of each train_step span;
4c. run single-node CSGD-ASSS (``repro_torch.core.csgd.csgd_asss``,
   ``block_topk``, gamma 0.01) on the same model and batches for 4
   steps the same way: 11 ``block_stats`` and 11 ``threshold_split``
   launches per step, none of the other kernels, finite losses, the EF
   identity sent + residual == acc on the largest leaf, exact wire bytes;
   then profile one more step as in 4b;
4d. serve at full width through ``repro_torch.launch.serve --full``,
   random weights from seed 0, batch 4, 16 tokens each (a prefill and
   15 decode steps), with the counts set to 0 just before each run and
   read just after: qwen1.5-4b at ctx 2048 (40 flash-attention launches,
   all through the bf16 tensor-core kernel, and 81 x 16 = 1296 RMSNorm
   launches, no other kernel), then rwkv6-1.6b at
   ctx 1024 (24 x 16 = 384 WKV and 49 x 16 = 784 RMSNorm launches);
   then granite-moe-1b-a400m at ctx 2048 (24 layers, 16 heads over 8 kv
   heads of 64, 32 experts top-8: 24 flash-attention and 49 x 16 = 784
   RMSNorm launches, no other kernel);
   finite logits; prefill seconds, decode ms per step, tokens per second
   and peak memory; then one profiled prefill and one profiled decode
   step of each, with device time under each kernel's own name and the
   idle share (fatal if a path's kernels are missing from its trace);
4e. the adaptive trainer at full width: ``--max-gamma 0.1 --gamma 0.04
   --gamma-schedule linear --gamma-ramp-steps 2 --value-bits 8``, so
   gamma_t runs 0.04, 0.07, 0.1, for 3 steps on ``--transport perleaf``
   (per step 9 ``ef_stats_telemetry``, 9 ``ef_apply`` and 18 launches of
   each ragged codec kernel, no other kernel) and 3 on ``bucketed`` (no
   ragged launch), each step's effective bytes 13,302,448 / 23,301,808 /
   32,978,608 and its static bytes 32,978,608; from one saved state, grads
   and batch one exchange through each transport, parameters and EF
   memory bit-identical; 2 steps of ``--gamma-schedule ef-coupled`` at
   32-bit values on perleaf, finite losses; one profiled perleaf step at
   gamma_t 0.04, as in 4b;
4f. the trainer's other optimizer kinds at full width, gamma 0.01,
   with the counts set to 0 just before each run and read just after:
   ``--opt nonadaptive --eta 0.1`` for 2 steps (phase 4's launches a
   step, 6,528,000 B a step, alpha 0.1, no Armijo trial), ``--opt sls``
   for 2 (no kernel launch, the dense 440,478,720 B a step, at least one
   trial a step), ``--opt sgd`` and ``--opt dense`` for 1 each (no
   launch, 440,478,720 B), ``--microbatches 2`` for 2 (phase 4's
   launches, finite losses); step times and peak memory; then ``--opt
   sgd --eta inf --max-consecutive-skips 2``, which must raise
   ``DivergenceError`` at step 1 with no good step before it; one
   profiled ``nonadaptive`` step and one at 2 microbatches, as in 4b;
4g. the trainer's runtime beyond one step at full width, gamma 0.01,
   the counts set to 0 just before each run and read just after:
   ``--local-steps 2 --microbatches 2`` for 2 rounds, as ``csgd_asss``
   and as ``nonadaptive`` (1 launch of each of the four training kernels
   a round, 6,528,000 B a round, at least one Armijo trial a round,
   finite losses; round times and peak memory); ``--ef-dtype bfloat16``
   for 2 steps (phase 4's launches; every EF memory leaf bf16 on the
   card, 220,239,360 B); checkpoints: 2 steps with ``--ckpt-dir``
   (under ``_smoke_ckpt/`` beside this script, deleted afterwards)
   ``--ckpt-every 1``, step 2 restored onto the card bit-identical to
   the parameters and EF memory the run ended with, the save and
   restore seconds and the bytes on disk, then ``--steps 4 --resume``,
   which must log steps 2 and 3; one profiled local-steps round, as in
   4b, with one ``train_step.local_step`` span a local step;
4h. ACGD and the compressed downlink at full width, gamma 0.01 unless
   said, the counts set to 0 just before each run and read just after:
   ``--opt acgd --eta 0.1 --momentum 0.9`` for 2 steps (1 launch of each
   of the four training kernels a step and no other, 6,528,000 B a step,
   alpha 0.1, no Armijo trial, every velocity leaf f32 on the card,
   440,478,720 B); ``--downlink compressed`` (``csgd_asss``) for 2
   (phase 4's launches, so the downlink launches none; 6,528,000 B up
   and down a step, static and effective; cum_effective_wire_bytes
   26,112,000 after 2 steps; the server memory 110,100,480 f32 words on
   the card); ``--opt acgd --downlink compressed --transport perleaf
   --max-gamma 0.1 --gamma 0.04 --downlink-gamma 0.04 --value-bits 8``
   for 2 (9 EF pairs and 18 launches of each ragged codec kernel a step,
   effective bytes 13,302,448 and static 32,978,608 each way);
   ``roundtrip_rows`` bit-identical to ``decode_rows(encode_rows)``
   through the CUDA codec at every compressed leaf's rows at 32 and 8
   bits and ragged at count 41 of 102; one profiled warm step of ``acgd
   --downlink compressed``, as in 4b, with the ``train_step.downlink``
   span, then the server round alone under the profiler (its sort and
   its other passes, no kernel of the port); single-node ACGD
   (``repro_torch.core.acgd.acgd``, ``block_topk``, eta 0.1, mu 0.9) on
   the model and batches of 4c for 3 steps, checked as 4c checks
   CSGD-ASSS, and one profiled step;
4i. the overlap transport at full width, gamma 0.01 unless said, the
   counts set to 0 just before each run and read just after (the
   ragged codec kernels must stay at 0 in every run):
   ``--transport overlap --overlap-delay 0 --overlap-chunks 4`` for 3
   steps at 32- and at 8-bit values against ``bucketed``, bit for bit
   (parameters, EF memory, wire and effective bytes, gamma_t) with
   bucketed's launches; at delay 1 (4 chunks) step 1 a zero update with
   bucketed step 1's EF memory and step 2 bucketed step 1's parameters,
   bit for bit, ``staleness`` 0 then 1, effective bytes the zero
   payload's then bucketed step 1's, launches bucketed's; ``--local-steps
   2 --microbatches 2`` and a 10% budget (``--max-gamma 0.1 --gamma
   0.04``) for 2 rounds each at delay 1, the adaptive run against
   bucketed's launches and its step-2 effective bytes against bucketed
   step 1's, and after each one exchange from its final state with
   decode(own payload) + m' == m + eta*g bit for bit on the embedding
   leaf; a delay-1 checkpoint after 2 steps restored on the card and
   resumed to 4, bit for bit with 4 straight steps; warm step times and
   peaks (above what earlier runs hold); one profiled delay-1 step,
   as in 4b, with its ``train_step.overlap_start`` span;
4j. the gossip transport at full width on one worker (ring(1): no edge,
   so no P2P operation), gamma 0.01, the counts set to 0 just before
   each run and read just after (the ragged codec kernels must stay at
   0): ``--transport gossip`` for 3 steps at 32- and at 8-bit values
   against ``bucketed`` from the same seed: EF memory bit for bit,
   parameters equal (``torch.equal``), wire and effective bytes and
   gamma_t equal, bucketed's launches, the GossipState at v 0 and lr 1
   after every step; a checkpoint after 2 steps resumed to 4, bit for
   bit with 4 straight steps; warm step times and peaks; one profiled
   warm gossip step beside a bucketed one, as in 4b: the gossip
   exchange span shows no collective and no NCCL kernel while
   bucketed's shows its all-gather and all-reduce (the metrics'
   all-reduce lies outside the span);
4k. the hostile wire (DESIGN.md §16) at full width on one worker, gamma
   0.01 unless said, the counts set to 0 just before each run and read
   just after: 3 steps each of bucketed at 32 and 8 bits and perleaf at
   a 10% budget (``--max-gamma 0.1 --gamma 0.04 --value-bits 8``) with
   the decode verdicts (the default) against ``guards_disabled()``, bit
   for bit with the same launches, and the exchange alone and a whole
   ``train_step`` from one state timed both ways in turns; a synthetic
   3-row gathered decode through ``_consume_decoded_leaf`` on the card,
   its guarded mean the true division by 3 and its unguarded one the
   product with f32(1/3), bit for bit; ``--fault-nonfinite 1.0 --fault-start-step 1
   --fault-steps 1``: step 0 the clean run's, step 1 quarantines every
   compressed row and keeps every compressed leaf's EF memory, finite
   parameters, no skip; ``--fault-bitflip 1.0 --fault-count 1.0`` on
   that perleaf run, guarded and with ``--no-quarantine``: no device
   assert, the clean run's launches, each corrupted row and its decode
   through the ragged CUDA codec equal to the CPU port's bit for bit, a
   row whose count reads -1 decoded to zeros; the faulty wrapper around
   overlap (delay 1) and gossip outside its burst, bit for bit with
   them; a checkpoint at step 2 of a 3-step burst, resumed to 4, bit for
   bit with 4 straight steps;
4m. the MoE family: flash attention's bf16 route against its plain
   version at granite's prefill shape (4, 16, 2048, 64), its 8 kv heads
   broadcast 2:1 by the model's ``_expand_kv``, and at qwen3-moe's (4,
   32, 2048, 128), 4 kv heads 8:1, within 1 bf16 ulp of the plain value
   plus 1e-5, timed beside both and ``F.scaled_dot_product_attention``;
   a second granite serve run whose logits equal phase 4d's bit for bit
   (the deterministic combine); qwen3-moe-30b-a3b at full width with 12
   of its 48 layers (128 experts top-8) through ``serve.load`` and
   ``serve.generate``, batch 4, ctx 2048, 16 tokens: 12 flash-attention
   and 25 x 16 = 400 RMSNorm launches, no other kernel, finite logits;
   the trainer on granite at full width and depth (seq 256, global
   batch 8, ``block_topk``, gamma 0.01) for 3 steps: one
   ``ef_stats_telemetry`` and one ``ef_apply`` a step and the
   ``pack_words`` / ``unpack_words`` launches the bucket plan gives, no
   other kernel, finite losses, the plan's wire bytes every step, bf16
   parameters (the router f32) and f32 EF memory after it, peak memory;
   ``moe_block`` at the granite smoke size on the card against the CPU
   in f32 (routes exact, y within 1e-5 of max|y|) and bf16 (routes
   exact, y within 1e-2 of max|y|); 2 trainer steps of the granite
   smoke on the card and on the CPU: equal bytes, losses within rel
   1e-5;
4n. the hybrid family: flash attention's bf16 route at zamba2-7b's head
   dim 112 (tiles zero-filled to 128 columns by TMA) against its plain
   version at the prefill shape (4, 32, 2048, 112) causal and at 24 edge
   cases (Sq < Sk, a window, off every tile edge) through strided (B, S,
   H, D) views, within 1 bf16 ulp of the plain value plus 1e-5, its
   ptxas line without spills, timed beside the plain version and
   ``F.scaled_dot_product_attention``; the f32 route at D 112 in small
   cases, atol 3e-5; RMSNorm in bf16 at (8192, 3584), (4, 3584), (8192,
   7168) and (4, 7168) (the last two the wide body), within 1 bf16 ulp,
   timed beside ``F.rms_norm``; zamba2-7b at full width and depth (81
   Mamba2 layers, the shared block 13 times; 6.75 B parameters) through
   ``serve.load`` and ``serve.generate``, batch 4, ctx 2048, 16 tokens:
   exactly 13 flash-attention and 16 x 189 = 3,024 RMSNorm launches and
   no other kernel, finite logits, prefill seconds, decode ms a step and
   peak memory, one profiled warm prefill and decode step, and the SSD
   scan alone at the prefill's shape; the trainer on zamba2-7b at full
   width and 13 of its layers through ``train.run(..., n_layers=13)``
   (seq 256, global batch 8, ``block_topk``, gamma 0.01) for 3 steps:
   one ``ef_stats_telemetry`` and one ``ef_apply`` a step and the bucket
   plan's ``pack_words`` / ``unpack_words``, no other kernel, finite
   losses, the plan's bytes every step, bf16 parameters with ``A_log``,
   ``D_skip`` and ``dt_bias`` f32, f32 EF memory, peak memory;
   ``mamba2_block`` and ``ssd_chunked`` at the zamba2 smoke size and
   ``ssm_chunk`` 16 on the card against the CPU, f32 within 1e-5 and bf16
   within 1e-2 of max;
4o. the encoder-decoder family (its kernel checks run in phase 3):
   flash attention without causality at
   seamless-m4t-large-v2's shapes, D 64, bf16 through strided views
   against its plain version (1 bf16 ulp beyond 1e-5): the encoder (4,
   16, 32, 64), the cross attention at prefill, 2048 queries against 32
   frames (Sq > Sk: a negative query offset), and at decode, one query
   against 32, each timed beside the plain version,
   ``F.scaled_dot_product_attention`` and its bound; 10 bf16 and 5 f32
   edge cases with Sq >= Sk, with and without a window of 64; both D 64
   instances' ptxas lines without spills; seamless-m4t-large-v2 at full
   width and depth (12 encoder and 12 decoder layers, 1.28 B parameters)
   through ``serve.load`` and ``serve.generate``, batch 4, ctx 2048, 32
   source frames, 16 tokens: exactly 12 + 2 x 12 + 12 x 15 = 216
   flash-attention and 62 + 37 x 15 = 617 RMSNorm launches and no other
   kernel, finite logits, prefill seconds, decode ms a step and peak
   memory, one profiled warm prefill and decode step (the decode step's
   cross attention through the flash kernel); the trainer at full width
   and depth (seq 256, global batch 8, ``block_topk``, gamma 0.01) for 3
   steps: one ``ef_stats_telemetry`` and one ``ef_apply`` a step and the
   bucket plan's ``pack_words`` / ``unpack_words`` (every leaf one row:
   JAX's stacked_mask marks none), no other kernel, finite losses, the
   plan's bytes every step, bf16 parameters and f32 EF memory, peak
   memory; the seamless smoke served on the card and on the CPU (equal
   tokens, logits within 1e-4 of max, 12 flash launches through the f32
   route) and trained 2 steps on both (equal bytes, losses rel 1e-5);
4p. the vlm family: flash attention's bf16 route at
   llama-3.2-vision-11b's three shapes, (4, 32, Sq, Sk, 128) with the 8
   kv heads broadcast by the model: the causal self attention at prefill
   (2048 x 2048), the cross attention at prefill (2048 queries against
   4096 patches, more keys than queries without causality) and at
   decode (1 x 4096), each against its plain version (1 bf16 ulp beyond
   1e-5) and timed beside it, ``F.scaled_dot_product_attention`` and its
   bound, and RMSNorm at d 4096 at (8192, 4096) and (4, 4096) bf16 the
   same way beside ``F.rms_norm``; llama-3.2-vision-11b at full width
   and depth (40 dense layers in 8 groups, each followed by a gated
   cross-attention block; 11.52 B parameters) through ``serve.load`` and
   ``serve.generate``, batch 4, ctx 2048, 4096 patches, 16 tokens, its
   gates (0 at init) set to [0.5, 1) from seed 11: exactly 40 + 8 + 8 x
   15 = 168 flash-attention and 97 x 16 = 1552 RMSNorm launches and no
   other kernel, finite logits, a second image moving the prefill's
   logits by more than the same image does run to run and than 1 bf16
   ulp of max, and not at all with the gates at 0, prefill seconds, decode ms a step
   and peak memory, one profiled warm prefill and decode step and the
   decode step's broadcast of the cross K/V (``_expand_kv``) timed
   alone; the trainer at full width on one group (``train.run(...,
   n_layers=5)``, the gates live; seq 256, global batch 8, 4096 patches
   a row, ``block_topk``, gamma 0.01) for 3 steps: one
   ``ef_stats_telemetry`` and one ``ef_apply`` a step and the bucket
   plan's ``pack_words`` / ``unpack_words``, no other kernel, finite
   losses, the plan's bytes every step, bf16 parameters with f32 gates,
   f32 EF memory, peak memory; the vlm smoke, gates live, served on the
   card and on the CPU (equal tokens, logits within 1e-4 of max, 12
   flash launches through the f32 route) and trained 2 steps on both
   (equal bytes, losses rel 1e-5);
4q. the int8 KV cache and rematerialisation: qwen1.5-4b at full width
   and depth through ``serve.load``'s model and weights, batch 4, ctx
   2048, 16 tokens, served with the bf16 cache and with the model
   rebuilt with ``kv_cache_dtype="int8"``, in turns bf16, int8, int8,
   bf16, the counts set to 0 just before each run and read just after:
   phase 4d's 40 flash-attention and 1296 RMSNorm launches each run and
   no other kernel, finite logits, the prefill's cache 3,381,657,600 B
   of bf16 against 1,690,828,800 B of int8 codes and 52,838,400 B of f32
   scales, the int8 run's peak at least 1 GiB lower, prefill seconds
   and decode ms a step of each, and the int8 logits' gap from the bf16
   ones (of max) and how many greedy tokens agree; the memory one
   gradient pass of granite (batch 8 x 256) adds above its weights with
   and without ``remat``, lower with it; the granite trainer of phase 4m
   for 3 steps from one seed with ``remat=True`` (its config) and
   ``remat=False``: the same launches, the losses, parameters and EF
   memory bit for bit (else held to the card's run-to-run difference of
   a second plain run), both step peaks (set after the backward, by the
   optimizer's f32 copies) and warm step times;
4r. the model axis for serving (``launch/mesh.py``, ``sharding.py``):
   each run on two ranks that share the card (two processes, a gloo
   group over CUDA tensors: NCCL takes no two ranks on one card; the
   backend chosen by ``mesh.backend_for`` before the group forms and
   printed) against the one-process run of the same model and weights
   in this process: qwen1.5-4b at full width and depth on ``--mesh
   1x2`` (batch 4, ctx 2048, 16 tokens), on ``--mesh 2x1 --params-2d``
   (4 tokens: each step gathers every layer's weights through the host)
   and granite-moe-1b-a400m on ``--mesh 1x2`` with
   ``moe_expert_parallel=True``, in bf16; then both 1x2 runs in f32 (8
   tokens).  Each rank draws the whole tree from seed 0, keeps its
   ``serve.shard`` slice and serves its rows; it fails unless each
   rank's resident weights are exactly its shard's bytes
   (3,951,232,000, 3,951,539,200, 1,387,890,688; f32 7,902,464,000 and
   2,772,635,648) and each rank's flash-attention and RMSNorm launches
   a prefill and a decode step (the counts set to 0 just before each,
   read just after) equal the one-process run's (40 / 0 and 81 / 81 for
   qwen, 24 / 0 and 49 / 49 for granite); for the f32 runs (against the
   whole batch) and the 2x1 run (against each data half served alone,
   the ranks' product shapes) also unless the logits of a run fed the
   reference's tokens step by step lie within TP_LOGIT_BOUND of its
   max|logits| and at least 7 in 8 of the free-running greedy tokens
   equal its; qwen's bf16 1x2 run the same within TP_BF16_BOUND (its
   ranks round a bf16 partial before each row-parallel sum).  Each
   bf16 1x2 run also measures its noise floor: the one-process run
   again with the embedding's every element moved by one bf16 ulp (its
   bit pattern plus one), step-fed and free-running against the
   unmoved run; granite's bf16 run, whose routing one ulp flips at
   full depth, fails unless its step-fed gap is within TP_FLOOR_FACTOR
   times that witness's, its tokens recorded beside the witness's; it
   prints the backend, each rank's prefill s, decode ms a step and
   peak memory after the slice, beside the card's name and power
   limit;
5. run the 2-layer smoke variants on the card and on the CPU (the plain
   versions, which the CPU tests hold against the JAX package), through
   the trainer for 2 steps (``--opt csgd_asss``, ``nonadaptive``,
   ``sls`` and ``acgd``, ``--local-steps 2 --microbatches 2``,
   ``--ef-dtype bfloat16``, ``--downlink compressed``, ``--transport
   overlap`` at delay 1 and 0, ``--transport gossip``,
   ``--fault-bitflip 0.1`` with equal quarantined rows, ``--n-clients 4
   --clients-per-round 3``, and on
   ``--transport perleaf --max-gamma 0.1``), through
   CSGD-ASSS for 3 and through serving
   (qwen1.5-4b, rwkv6-1.6b, granite-moe-1b-a400m and zamba2-7b, ctx 96,
   4 tokens), and compare: equal
   greedy tokens and logits within 1e-4 of max|logits| for serving; and
   the zamba2 smoke (5 layers) through the trainer for 2 steps, equal
   bytes and losses within rel 1e-5; the int8 smoke of qwen1.5-4b,
   granite-moe-1b-a400m, zamba2-7b, seamless-m4t-large-v2 and
   llama-3.2-vision-11b (gates live), ctx 96: the prefill's logits
   within 1e-4 of max, its codes within 1 step and scales within 1e-5
   of max, then each decode step on both devices from the CPU's cache,
   equal tokens and logits within 1e-4 of max (free-running gaps
   recorded);
6. print the kernels as one JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

It exits non-zero without that last line when there is no CUDA device or
when the repository's ``src/repro_torch`` is not beside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
try:
    # the H100 SXM data sheet's rates, one source for the port
    from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_OPS_PER_S
    from repro_torch.launch.mesh import PEAK_FLOPS_F32 as F32_OPS_PER_S
except ImportError:      # not in a checkout: main() says so and exits 1
    HBM_BYTES_PER_S = F32_OPS_PER_S = BF16_OPS_PER_S = None
MAIN_STEPS, VB8_STEPS, G10_STEPS, CSGD_STEPS = 4, 2, 2, 4
MAIN_ARGS = ["--arch", "paper-lm-100m", "--compress-method", "block_topk",
             "--seq-len", "256", "--global-batch", "8", "--log-every", "1"]
REPLACES = {
    "ef_stats_telemetry": "src/repro/kernels/ef_topk.py:206",
    "ef_apply": "src/repro/kernels/ef_topk.py:107",
    "ef_block_stats": "src/repro/kernels/ef_topk.py:188",
    "block_stats": "src/repro/kernels/ef_topk.py:146",
    "threshold_split": "src/repro/kernels/ef_topk.py:243",
    "pack_words": "src/repro/kernels/wire_pack.py:109",
    "unpack_words": "src/repro/kernels/wire_pack.py:154",
    # the ragged bodies' pallas_call, inside pack_words / unpack_words
    "pack_words_ragged": "src/repro/kernels/wire_pack.py:143",
    "unpack_words_ragged": "src/repro/kernels/wire_pack.py:183",
    "flash_attention": "src/repro/kernels/flash_attention.py:83",
    "rmsnorm": "src/repro/kernels/rmsnorm.py:30",
    "wkv_forward": "src/repro/kernels/rwkv_wkv.py:58",
}
SOURCES = {
    "ef_stats_telemetry": "src/repro_torch/csrc/ef_topk.cu",
    "ef_apply": "src/repro_torch/csrc/ef_topk.cu",
    "ef_block_stats": "src/repro_torch/csrc/ef_topk.cu",
    "block_stats": "src/repro_torch/csrc/ef_topk.cu",
    "threshold_split": "src/repro_torch/csrc/ef_topk.cu",
    "pack_words": "src/repro_torch/csrc/wire_pack.cu",
    "unpack_words": "src/repro_torch/csrc/wire_pack.cu",
    "pack_words_ragged": "src/repro_torch/csrc/wire_pack.cu",
    "unpack_words_ragged": "src/repro_torch/csrc/wire_pack.cu",
    # the bf16 route, the one serving takes and the kernels line times;
    # f32 inputs take src/repro_torch/csrc/flash_attention.cu
    "flash_attention": "src/repro_torch/csrc/flash_attention_sm90.cu",
    "rmsnorm": "src/repro_torch/csrc/rmsnorm.cu",
    "wkv_forward": "src/repro_torch/csrc/rwkv_wkv.cu",
}
#: serving at full width: (arch, ctx, launches of one run of 16 tokens,
#: the ``__global__`` names its prefill's trace must show)
SERVE_RUNS = (("qwen1.5-4b", 2048, dict(flash_attention=40,
                                        rmsnorm=81 * 16),
               ("flash_attention_sm90_kernel", "rmsnorm_kernel")),
              ("rwkv6-1.6b", 1024, dict(wkv_forward=24 * 16,
                                        rmsnorm=49 * 16),
               ("wkv_forward_kernel", "rmsnorm_kernel")),
              ("granite-moe-1b-a400m", 2048, dict(flash_attention=24,
                                                  rmsnorm=49 * 16),
               ("flash_attention_sm90_kernel", "rmsnorm_kernel")))
SERVE_BATCH, SERVE_GEN = 4, 16
#: phase 4e: a 10% budget, gamma_t ramping 0.04 -> 0.07 -> 0.1
ADAPTIVE_ARGS = ["--max-gamma", "0.1", "--gamma", "0.04",
                 "--gamma-ramp-steps", "2"]
ADAPTIVE_STEPS, EF_COUPLED_STEPS = 3, 2
#: one worker's exchange bytes a step at 8-bit values: static, and
#: effective at gamma_t 0.04, 0.07 and 0.1 (k_b_t 41, 72, 102 of 102)
ADAPTIVE_STATIC = 32_978_608
ADAPTIVE_EFFECTIVE = [13_302_448, 23_301_808, 32_978_608]
#: phase 4f: one worker's bytes a step at gamma 0.01 with 32-bit values
#: (the compressing kinds) and of the dense exchange, 4 B a parameter
COMPRESSED_BYTES, DENSE_BYTES = 6_528_000, 440_478_720
#: phase 4g: local-steps rounds, bf16 EF steps, and the EF memory of
#: paper-lm-100m in each dtype
LOCAL_ROUNDS, BF16_STEPS = 2, 2
EF_BYTES = {"float32": 440_478_720, "bfloat16": 220_239_360}
#: phase 4h: trainer steps of each acgd / downlink run, single-node ACGD
#: steps, and the server EF memory of paper-lm-100m (its compressed
#: leaves' entries, f32)
ACGD_STEPS, ACGD_SINGLE_STEPS, SERVER_WORDS = 2, 3, 110_100_480
#: phase 4i: steps of each delay-0 run, ring chunks, and the steps of the
#: local-steps and adaptive runs
OVERLAP_STEPS, OVERLAP_CHUNKS, OVERLAP_LOCAL = 3, 4, 2
#: phase 4j: steps of each gossip run beside bucketed
GOSSIP_STEPS = 3
#: phase 4k: steps of each guarded / unguarded run, and the reps of the
#: exchange timed alone each way
FAULT_STEPS, FAULT_REPS = 3, 10
#: phase 4l: the cohort's flags (4 clients, 3 a round, a 10% budget with
#: each client's own linear ramp 0.04 -> 0.1, non-IID clients), the
#: rounds of each run at 32 and at 8 bits, and the clients
COHORT_ARGS = ["--n-clients", "4", "--clients-per-round", "3",
               "--max-gamma", "0.1", "--gamma", "0.04", "--gamma-schedule",
               "linear", "--gamma-ramp-steps", "2", "--dirichlet-alpha",
               "0.5"]
COHORT_ROUNDS, COHORT_CLIENTS = 3, 4
#: phase 4m: the MoE family's trainer run (granite at full width and
#: depth, as phase 4 runs paper-lm-100m) and qwen3-moe's served depth
MOE_ARCH, MOE_STEPS = "granite-moe-1b-a400m", 3
MOE_ARGS = ["--arch", MOE_ARCH, "--compress-method", "block_topk",
            "--seq-len", "256", "--global-batch", "8", "--log-every", "1"]
QWEN3_MOE, QWEN3_MOE_LAYERS, QWEN3_MOE_CTX = "qwen3-moe-30b-a3b", 12, 2048
#: phase 4n: the hybrid family, zamba2-7b served at full depth at ctx
#: 2048 and trained at full width on 13 of its 81 layers
ZAMBA, ZAMBA_CTX, ZAMBA_LAYERS, ZAMBA_STEPS = "zamba2-7b", 2048, 13, 3
ZAMBA_ARGS = ["--arch", ZAMBA] + MOE_ARGS[2:]
#: phase 4o: the encoder-decoder family, seamless-m4t-large-v2 served and
#: trained at full width and depth (12 + 12 layers), ctx 2048
SEAMLESS, SEAMLESS_CTX, SEAMLESS_STEPS = "seamless-m4t-large-v2", 2048, 3
SEAMLESS_ARGS = ["--arch", SEAMLESS] + MOE_ARGS[2:]
#: phase 4p: the vlm family, llama-3.2-vision-11b served at full width
#: and depth at ctx 2048 and trained at full width on one group (5 of its
#: 40 dense layers and 1 of its 8 cross blocks); the seed of its gates
VLM, VLM_CTX, VLM_LAYERS, VLM_STEPS = "llama-3.2-vision-11b", 2048, 5, 3
VLM_ARGS = ["--arch", VLM] + MOE_ARGS[2:]
VLM_GATE_SEED = 11
#: phase 4q: the int8 KV cache at phase 4d's qwen1.5-4b shape (its
#: flash-attention and RMSNorm launches), and rematerialisation on and
#: off in the granite trainer of phase 4m; phase 5's int8 smokes
INT8_ARCH, INT8_CTX, INT8_LAUNCHES = SERVE_RUNS[0][:3]
REMAT_STEPS = 3
INT8_SMOKE = (INT8_ARCH, MOE_ARCH, ZAMBA, SEAMLESS, VLM)
#: phase 4r: (label, arch, mesh (data, model), --params-2d,
#: moe_expert_parallel, tokens, parameter dtype, each rank's resident
#: weight bytes, the launches of a prefill and of a decode step by kernel,
#: how its logits and tokens are gated: against the one-process run of
#: the whole batch or of each data half alone (the ranks' product
#: shapes) within a bound of max|logits|, with 7 in 8 tokens equal; or
#: "floor": within TP_FLOOR_FACTOR of the one-process run's own gap when
#: its embedding moves one bf16 ulp (one ulp flips an MoE's routing)
QWEN_COUNTS = dict(flash_attention=(40, 0), rmsnorm=(81, 81))
GRANITE_COUNTS = dict(flash_attention=(24, 0), rmsnorm=(49, 49))
#: a gated run's step-fed logits' largest gap from its reference, of the
#: reference's max|logits| (PERF.md's predictions for phase 4r): f32 and
#: the data axis alone, and qwen's bf16 model axis
TP_LOGIT_BOUND = 1e-3
TP_BF16_BOUND = 2e-2
TP_FLOOR_FACTOR = 2.0
TP_RUNS = (
    ("qwen 1x2", INT8_ARCH, (1, 2), False, False, SERVE_GEN, "bfloat16",
     3_951_232_000, QWEN_COUNTS, ("whole", TP_BF16_BOUND)),
    ("qwen 2x1 params-2d", INT8_ARCH, (2, 1), True, False, 4, "bfloat16",
     3_951_539_200, QWEN_COUNTS, ("halves", TP_LOGIT_BOUND)),
    ("granite 1x2 ep", MOE_ARCH, (1, 2), False, True, SERVE_GEN, "bfloat16",
     1_387_890_688, GRANITE_COUNTS, ("floor", None)),
    ("qwen 1x2 f32", INT8_ARCH, (1, 2), False, False, 8, "float32",
     7_902_464_000, QWEN_COUNTS, ("whole", TP_LOGIT_BOUND)),
    ("granite 1x2 ep f32", MOE_ARCH, (1, 2), False, True, 8, "float32",
     2_772_635_648, GRANITE_COUNTS, ("whole", TP_LOGIT_BOUND)))
TP_CTX = 2048
#: seconds a phase-4r rank may take (the 2x1 run gathers through the host)
TP_TIMEOUT = 600


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


def device_ms(fn, reps: int = 20, evict: bool = False) -> float:
    """Device time of one call, from the profiler's kernel times over
    ``reps`` calls: without the host's time before each launch, which
    ``time_ms`` keeps (and a host-bound decode pays).  With ``evict`` a
    256 MB write before each call leaves none of its inputs in the 50 MB
    L2; the write's own kernels are not counted.  Fails when the
    profiler records no device time at all: late in a whole run of this
    script it has recorded none of the port's own launches of a timed
    call (phase 4n therefore times with CUDA events alone)."""
    def profile(calls) -> dict:
        """Device microseconds by the profiler's key over ``reps`` calls."""
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                calls()
            torch.cuda.synchronize()
        return {e.key: getattr(e, "self_device_time_total", 0)
                for e in prof.key_averages()}

    flush, skip = (lambda: None), set()
    if evict:
        scratch = torch.empty(2**26, dtype=torch.int32, device="cuda")
        flush = scratch.bitwise_not_
        skip = {k for k, us in profile(flush).items() if us > 0}
    fn()
    torch.cuda.synchronize()
    total = sum(us for k, us in profile(lambda: (flush(), fn())).items()
                if k not in skip)
    if total <= 0:
        fail("the profiler recorded no device time for a timed call")
    return total / reps / 1e3


def host_ms(fn, reps: int = 1000) -> float:
    """The host's time a call, from ``time.perf_counter`` over ``reps``
    back-to-back calls without a synchronize: the wrapper's checks,
    allocation and launch (the device's time where the device is the
    slower and the launch queue fills)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def max_ulp(a, b) -> int:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


#: the ``__global__`` names of the port's kernels, one per kernel
PORTED = ("ef_stats_telemetry_kernel", "ef_block_stats_kernel",
          "block_stats_kernel", "ef_apply_kernel", "threshold_split_kernel",
          "pack_words_kernel", "unpack_words_kernel",
          "flash_attention_kernel", "flash_attention_sm90_kernel",
          "rmsnorm_kernel", "rmsnorm_stream_kernel", "wkv_forward_kernel")


def kernel_group(name: str) -> str:
    """A port kernel's own name, else a coarse group of library kernels.
    A port kernel's name must stand as a whole identifier in the
    profiler's key (``(anonymous namespace)::block_stats_kernel(...)``,
    or ``void (anonymous namespace)::rmsnorm_kernel<float, float>(...)``
    for a template), so ``block_stats_kernel`` never matches
    ``ef_block_stats_kernel``."""
    for kernel in PORTED:
        if re.search(rf"\b{kernel}\b", name):
            return kernel
    low = name.lower()
    if any(s in low for s in ("gemm", "cutlass", "sm90_xmma", "cublas",
                              "nvjet")):
        return "matmul"
    if "sort" in low or "radix" in low:
        return "sort"
    if "nccl" in low:
        return "nccl"
    return "other"


def profile_step(dev, cfg, comp, label="trainer", transport="bucketed",
                 kind="csgd_asss", microbatches=1, local_steps=1) -> None:
    """One warm full-width train step under torch.profiler: device time
    by kernel group and the device's idle share of the step (a
    local-steps round: one ``train_step.local_step`` span a local
    step)."""
    from repro_torch.comm.exchange import init_process_group
    from repro_torch.configs.base import OptimizerConfig, RunConfig, \
        ShapeConfig
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch.train_step import init_train_state, train_step
    from repro_torch.models import lm
    run = RunConfig(model=cfg, shape=ShapeConfig(256, 8),
                    microbatches=microbatches,
                    optimizer=OptimizerConfig(kind=kind, compressor=comp,
                                              transport=transport,
                                              local_steps=local_steps))
    created = init_process_group(dev)
    try:
        params = lm.init_params(cfg, seed=0, device=dev)
        state = init_train_state(params, run)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=256,
                             global_batch=8)
        for step in range(2):
            batch = {k: v.to(dev) for k, v in pipe.batch(step).items()}
            params, state, _ = train_step(params, state, batch, run)
        batch = {k: v.to(dev) for k, v in pipe.batch(2).items()}
        prof, wall_ms = profiled(
            dev, lambda: train_step(params, state, batch, run))
    finally:
        if created:
            torch.distributed.destroy_process_group()
    spans = report_profile(label, prof, wall_ms,
                           ("ef_stats_telemetry_kernel", "ef_apply_kernel",
                            "pack_words_kernel", "unpack_words_kernel"))
    # no armijo span where the kind does not search; a local-steps round
    # has local_step spans in place of grad and armijo; the overlap
    # transport at delay 1 adds its overlap_start span
    want = 3 if local_steps > 1 or kind not in ("csgd_asss", "sls") else 4
    want += transport == "overlap"
    if len(spans) != want or min(spans.values()) <= 0:
        fail(f"the profiler saw {label} train_step spans {spans}, want "
             f"{want} timed")
    if local_steps > 1:
        n = sum(ev.count for ev in prof.key_averages()
                if ev.key == "train_step.local_step"
                and ev.device_type == torch.autograd.DeviceType.CPU)
        print(f"  {n} train_step.local_step spans", flush=True)
        if n != local_steps:
            fail(f"the profiler saw {n} local_step spans in the {label} "
                 f"round, want {local_steps}")


def profiled(dev, fn):
    """(profiler, wall ms) of one call of ``fn`` under torch.profiler."""
    torch.cuda.synchronize(dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def report_profile(label, prof, wall_ms, kernels_of_path) -> dict:
    """Print device time by kernel group, the device's idle share of the
    step and the host time of each ``train_step.*`` span; fail unless
    each of the path's kernels shows under its own name; return the
    spans."""
    groups, kernels, spans = {}, [], {}
    for ev in prof.key_averages():
        if ev.key.startswith("train_step."):
            # the CPU range; on CUDA the profiler adds a device-side copy
            # of each range under the same name
            if ev.device_type == torch.autograd.DeviceType.CPU:
                spans[ev.key] = ev.cpu_time_total / 1e3
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us <= 0 or getattr(ev, "device_type", None) == \
                torch.autograd.DeviceType.CPU:
            continue
        groups[kernel_group(ev.key)] = groups.get(kernel_group(ev.key),
                                                  0.0) + us / 1e3
        kernels.append((us / 1e3, ev.count, ev.key))
    busy = sum(groups.values())
    if busy <= 0:
        fail(f"the profiler saw no device time in the {label} step")
    missing = [k for k in kernels_of_path if k not in groups]
    if missing:
        fail(f"the profiler saw no {missing} in the {label} step")
    print(f"profile [{label}]: one step {wall_ms:.2f} ms wall (profiler "
          f"on), device busy {busy:.2f} ms, idle share "
          f"{1 - busy / wall_ms:.3f}, {sum(n for _, n, _ in kernels)} "
          "device kernels and copies")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {name}: {ms:.3f} ms ({ms / busy:.3f} of device time)")
    # host time in each phase of train_step: launches plus any wait for
    # the device (the Armijo trials and the metrics read values back)
    for name, ms in spans.items():
        print(f"  host {name}: {ms:.3f} ms ({ms / wall_ms:.3f} of wall)")
    for ms, n, key in sorted(kernels, reverse=True)[:12]:
        print(f"    {ms:8.3f} ms x{n:<4d} {key[:90]}")
    return spans


def step_wire_bytes(shapes, stacked, comp) -> float:
    """The bytes one step must put on the wire: the packed payload words
    plus the f32 dense leaves."""
    from repro_torch.comm.bucket import build_bucket_plan
    plan = build_bucket_plan(shapes, stacked, comp)
    return float(plan.total_words * 4 + sum(
        ln.L * ln.d * 4 for ln in plan.leaves if ln.dense))


def special_rows(dev):
    """Block rows that decide the selection's edge cases: one NaN,
    several NaNs, +inf twice, -inf, all zeros, rounded ties, all equal."""
    x = np.random.default_rng(21).standard_normal((8, 1024)).astype(
        np.float32)
    x[1, 5] = np.nan
    x[2, [3, 700, 900]] = np.nan
    x[3, [10, 600]] = np.inf
    x[4, 11] = -np.inf
    x[5] = 0.0
    x[6] = np.round(x[6] * 2.0)
    x[7] = -1.5
    return torch.from_numpy(x).to(dev)


def same(a, b) -> bool:
    """Bit-for-bit equal values, NaN where the other has NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def check_dense_selection(dev, gen, leaf_rows, k_b, paper_ks,
                          report) -> None:
    """block_stats and threshold_split (the single-node compress_dense
    path) against their plain versions: at the largest flat leaf, at a
    padded 9-row leaf through the public ops, and on the edge-case rows
    (with ef_block_stats and ef_stats_telemetry too); block_stats timed
    at the largest leaf at each of the paper's k_b beside torch.topk, and
    summed over one step's leaves."""
    from repro_torch.kernels import ef_topk, ops, ref
    entries = ptxas_entries("ef_topk", [
        "ef_stats_telemetry_kernel", "ef_block_stats_kernel",
        "block_stats_kernel", "ef_apply_kernel", "threshold_split_kernel"])
    if len(entries) != 5 or any(spill for _, _, spill in entries):
        fail(f"csrc/ef_topk.cu: ptxas reported spills, or not 5 kernels: "
             f"{entries}")
    print("ptxas ef_topk: no spills; registers "
          + ", ".join(f"{e} {r}" for e, r, _ in entries), flush=True)
    big = max(leaf_rows)
    x = torch.randn((big, 1024), generator=gen, device=dev) * 1e-2
    tau = ef_topk.block_stats(x, k_b)
    rtau = ref.block_abs_topk_threshold(x, k_b)
    sent, res = ef_topk.threshold_split(x, tau)
    rsent, rres = ref.threshold_split(x, tau)
    torch.cuda.synchronize()
    if not same(tau, rtau):
        fail(f"block_stats differs from the plain version in "
             f"{int((tau != rtau).sum())} of {big} rows")
    if not (torch.equal(sent, rsent) and torch.equal(res, rres)):
        fail("threshold_split differs from the plain version")
    if not torch.equal(sent + res, x):
        fail("threshold_split breaks sent + residual == x")

    leaf = torch.randn(8 * 1024 + 508, generator=gen, device=dev)
    t9 = ops.block_topk_threshold(leaf, k_b).reshape(-1, 1)
    x9 = torch.nn.functional.pad(leaf, (0, 516)).reshape(9, 1024)
    s9, r9 = ops.threshold_split_blocks(leaf, t9)
    rs9, rr9 = ref.threshold_split(x9, t9)
    if not same(t9, ref.block_abs_topk_threshold(x9, k_b)) \
            or not torch.equal(s9, rs9.reshape(-1)[:leaf.numel()]) \
            or not torch.equal(r9, rr9.reshape(-1)[:leaf.numel()]):
        fail("the padded 9-row leaf differs from the plain versions")

    sp = special_rows(dev)
    zeros = torch.zeros_like(sp)
    eta = torch.tensor([0.5], device=dev)
    edge_ks = sorted({1, *paper_ks, 1024})
    for kb in edge_ks:
        pairs = {
            "block_stats": (ef_topk.block_stats(sp, kb),
                            ref.block_abs_topk_threshold(sp, kb)),
            "ef_block_stats": (ef_topk.ef_block_stats(zeros, sp, eta, kb),
                               ref.ef_block_stats(zeros, sp, eta, kb)),
            "ef_stats_telemetry": (
                ef_topk.ef_stats_telemetry(zeros, sp, eta, kb)[0],
                ref.ef_block_stats_telemetry(zeros, sp, eta, kb)[0])}
        for name, (got, want) in pairs.items():
            if not same(got, want) or not torch.isnan(got[1:3]).all():
                fail(f"{name} at k_b={kb} differs from the plain version "
                     f"on the NaN/inf/tie rows: {got.ravel().tolist()} vs "
                     f"{want.ravel().tolist()}")
        ts, tr = ef_topk.threshold_split(sp, pairs["block_stats"][0])
        rs, rr = ref.threshold_split(sp, pairs["block_stats"][0])
        if not (same(ts, rs) and same(tr, rr)):
            fail(f"threshold_split at k_b={kb} differs on the NaN/inf rows")
    _, mom = ef_topk.ef_stats_telemetry(zeros, sp, eta, k_b)
    _, rmom = ref.ef_block_stats_telemetry(zeros, sp, eta, k_b)
    fin = torch.isfinite(rmom).all(1)
    if not same(mom[~fin], rmom[~fin]) or max_ulp(
            mom[fin].cpu().numpy(), rmom[fin].cpu().numpy()) > 8:
        fail("ef_stats_telemetry moments differ on the NaN/inf rows")
    print(f"edge-case rows (NaN, +-inf, zeros, ties) at k_b {edge_ks}: "
          f"tau {ef_topk.block_stats(sp, k_b).ravel().tolist()}", flush=True)

    # the paper's 1%, 4% and 10% at the largest leaf: each k_b checked,
    # then timed beside torch.topk at the same k_b (timed only)
    for kb in paper_ks:
        t = ef_topk.block_stats(x, kb)
        if not same(t, ref.block_abs_topk_threshold(x, kb)):
            fail(f"block_stats at k_b={kb} differs from the plain version "
                 f"at the largest leaf")

        def topk(kb=kb):
            return torch.topk(x.abs(), kb, dim=1).values[:, -1:]
        print(f"block_stats ({big}, 1024) k_b={kb}: "
              f"{time_ms(lambda: ef_topk.block_stats(x, kb)):.4f} ms, device "
              f"only {device_ms(lambda: ef_topk.block_stats(x, kb)):.4f} ms; "
              f"torch.topk {time_ms(topk):.4f} ms, device only "
              f"{device_ms(topk):.4f} ms", flush=True)

    per_step = {"block_stats": 0.0, "block_stats device": 0.0,
                "threshold_split": 0.0}
    for r in sorted(set(leaf_rows)):
        xr, tr_ = x[:r], tau[:r]
        n = leaf_rows.count(r)
        per_step["block_stats"] += n * time_ms(
            lambda: ef_topk.block_stats(xr, k_b))
        per_step["block_stats device"] += n * device_ms(
            lambda: ef_topk.block_stats(xr, k_b))
        per_step["threshold_split"] += n * time_ms(
            lambda: ef_topk.threshold_split(xr, tr_))
    print(f"one CSGD step's {len(leaf_rows)} leaves ({sum(leaf_rows)} block "
          f"rows): block_stats {per_step['block_stats']:.4f} ms (device only "
          f"{per_step['block_stats device']:.4f} ms), "
          f"threshold_split {per_step['threshold_split']:.4f} ms summed "
          f"(bounds {sum(leaf_rows) * 1028 * 4 / HBM_BYTES_PER_S * 1e3:.4f}"
          f" and {sum(leaf_rows) * 1024 * 12 / HBM_BYTES_PER_S * 1e3:.4f} "
          "ms)", flush=True)
    report["block_stats"] = dict(
        max_abs_err=float((tau - rtau).abs().max()),
        ms=time_ms(lambda: ef_topk.block_stats(x, k_b)),
        plain_ms=time_ms(lambda: ref.block_abs_topk_threshold(x, k_b)),
        library_ms=time_ms(
            lambda: torch.topk(x.abs(), k_b, dim=1).values[:, -1:]),
        # the function's work, whatever the kernel: each |x| once
        bytes=big * 1024 * 4 + big * 4, ops=big * 1024,
        note=f"largest leaf, {big} block rows")
    report["threshold_split"] = dict(
        max_abs_err=max(float((sent - rsent).abs().max()),
                        float((res - rres).abs().max())),
        ms=time_ms(lambda: ef_topk.threshold_split(x, tau)),
        plain_ms=time_ms(lambda: ref.threshold_split(x, tau)),
        bytes=big * 1024 * 12 + big * 4, ops=big * 1024 * 3,
        note=f"largest leaf, {big} block rows")


#: bits -> the signed and unsigned integer types of a field's width
NARROW = {16: (torch.int16, torch.uint16), 8: (torch.int8, torch.uint8)}


def cast_pack(fields: torch.Tensor, bits: int) -> torch.Tensor:
    """pack_words at 16 or 8 bits as one PyTorch call, a yardstick timed
    beside the kernel and used nowhere in the port: the narrowing cast
    keeps each field's low bits, and a little-endian view puts field f at
    bits [f*bits, (f+1)*bits) of a word."""
    return fields.to(NARROW[bits][0]).view(torch.int32)


def cast_unpack(words: torch.Tensor, bits: int) -> torch.Tensor:
    """unpack_words at 16 or 8 bits as one PyTorch call (a yardstick)."""
    return words.view(NARROW[bits][1]).to(torch.int32)


def check_wire(dev, gen, shapes, stacked, report) -> None:
    """pack_words and unpack_words (``csrc/wire_pack.cu``) against their
    plain versions, bit-exact: at the trainer's 16-bit index streams at
    gamma 1%, 4% and 10% and its 8-bit value stream at 1%, in the (rows,
    512)-word layout ``ops.pack_fields_stream`` gives them, then at 4
    bits, ragged, with the input's base one word or one field off and at
    lengths that are no multiple of 4 words.  Each stream timed by the
    three clocks (the device time also with L2 evicted) beside the
    narrowing cast that computes the same function, itself checked
    against the plain version.  ptxas spills in wire_pack.cu are fatal."""
    from repro_torch.comm.bucket import build_bucket_plan
    from repro_torch.core.compression import Compressor
    from repro_torch.kernels import ref, wire_pack
    entries = ptxas_entries("wire_pack", ["pack_words_kernel",
                                          "unpack_words_kernel"])
    if len(entries) != 18 or any(spill for _, _, spill in entries):
        fail(f"csrc/wire_pack.cu: ptxas reported spills, or not 18 "
             f"kernels: {entries}")
    print("ptxas wire_pack: no spills; registers "
          + ", ".join(f"{e} {r}" for e, r, _ in entries), flush=True)

    def lanes(gamma, value_bits):
        plan = build_bucket_plan(shapes, stacked, Compressor(
            gamma=gamma, method="block_topk", value_bits=value_bits))
        return [ln for ln in plan.leaves if not ln.dense]
    streams = {f"index gamma {gm}": (sum(
        ln.L * ln.spec.index_words for ln in lanes(gm, 32)), 16)
        for gm in (0.01, 0.04, 0.1)}
    streams["value gamma 0.01 (8-bit)"] = (sum(
        ln.L * ln.spec.value_words for ln in lanes(0.01, 8)), 8)

    def randint(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                             device=dev, dtype=torch.int32)

    for label, (W, bits) in streams.items():
        F = 32 // bits
        R, C = wire_pack.stream_shape(W)
        fields = randint(R, C * F)
        words = wire_pack.pack_words(fields, bits)
        back = wire_pack.unpack_words(words, bits)
        rwords = ref.pack_fields(fields, bits)
        rback = ref.unpack_fields(words, bits)
        if not torch.equal(words, rwords):
            fail(f"pack_words differs from the plain version at the "
                 f"{label} stream, {W} words")
        if not torch.equal(back, rback):
            fail(f"unpack_words differs from the plain version at the "
                 f"{label} stream, {W} words")
        if not (torch.equal(cast_pack(fields, bits), rwords)
                and torch.equal(cast_unpack(words, bits), rback)):
            fail(f"the narrowing casts differ from the plain versions at "
                 f"the {label} stream")
        bound = W * 4 * (1 + F) / HBM_BYTES_PER_S * 1e3
        for name, kernel, plain, cast, x, err in (
                ("pack_words", wire_pack.pack_words, ref.pack_fields,
                 cast_pack, fields,
                 (words.long() - rwords.long()).abs().max()),
                ("unpack_words", wire_pack.unpack_words, ref.unpack_fields,
                 cast_unpack, words,
                 (back.long() - rback.long()).abs().max())):
            t = {who: (time_ms(fn), device_ms(fn), device_ms(fn, evict=True),
                       host_ms(fn))
                 for who, fn in (("kernel", lambda: kernel(x, bits)),
                                 ("cast", lambda: cast(x, bits)))}
            clocks = ("{:.4f} ms, device {:.4f} (L2 evicted {:.4f}), host "
                      "{:.4f}")
            print(f"wire {label}, {R * C} words of {bits}-bit fields "
                  f"({W * 4 * (1 + F)} B, bound {bound:.4f} ms): {name} "
                  + clocks.format(*t["kernel"]) + f"; {cast.__name__} "
                  + clocks.format(*t["cast"]), flush=True)
            if label == "index gamma 0.01":
                report[name] = dict(
                    max_abs_err=float(err), ms=t["kernel"][0],
                    plain_ms=time_ms(lambda: plain(x, bits)),
                    library_ms=t["cast"][0],
                    bytes=W * 4 * (1 + F), ops=W * F * 3,
                    note=f"16-bit index stream {W} words; device "
                         f"{t['kernel'][1]:.4f} ms, cast {t['cast'][1]:.4f}")
        del fields, words, back, rwords, rback

    # the edges: 4 bits, ragged rows, an input base one word (or, for
    # pack, one field) off 16 bytes, lengths no multiple of 4 words
    cases = [(bits, rows, cols, period, 0) for bits in (4, 8, 16)
             for rows, cols, period in ((97, 40, 0), (97, 40, 11),
                                        (9, 40, 29))]
    cases += [(bits, 5, 203, 0, off) for bits in (4, 8, 16)
              for off in (0, 1)] + [(16, 1, 3, 0, 0), (8, 3, 1, 0, 1)]
    for bits, rows, cols, period, off in cases:
        F = 32 // bits
        cnt = torch.randint(0, period + 1, (rows,), generator=gen,
                            device=dev, dtype=torch.int32) \
            if period else None
        views = {"pack_words": randint(F + rows * cols * F)[
                     off * F:][:rows * cols * F].view(rows, cols * F),
                 "pack_words (one field off)": randint(1 + rows * cols * F)[
                     off:][:rows * cols * F].view(rows, cols * F),
                 "unpack_words": randint(1 + rows * cols)[off:][
                     :rows * cols].view(rows, cols)}
        for name, x in views.items():
            if name.startswith("pack"):
                got = wire_pack.pack_words(x, bits, cnt, period)
                want = ref.pack_fields(x, bits, cnt, period)
            else:
                got = wire_pack.unpack_words(x, bits, cnt, period)
                want = ref.unpack_fields(x, bits, cnt, period)
            if not torch.equal(got, want):
                fail(f"{name} differs from the plain version at bits={bits}"
                     f" ({rows}, {cols}) words, period {period}, base "
                     f"offset {off}")
    print(f"wire edges: bit-exact at {len(cases)} cases (4/8/16 bits, "
          "ragged at period 11 and 29, input base one word or field off, "
          "lengths 1015, 3 and 3 words)", flush=True)


def check_ragged_wire(dev, gen, shapes, stacked, report) -> None:
    """The ragged variants of the codec kernels against their plain
    versions, bit-exact, at every field section of the perleaf trainer's
    rows (16-bit index, 8-bit value) at k_b_t 41, 72 and 102 and at
    counts that differ per row; then timed at the largest section, the
    (16384, 768) embedding row's 16-bit index section at k_b_t 41."""
    from repro_torch.comm.bucket import build_bucket_plan
    from repro_torch.core.compression import Compressor
    from repro_torch.kernels import ref, wire_pack
    comp = Compressor(gamma=0.04, method="block_topk", max_gamma=0.1,
                      value_bits=8)
    lanes = [ln for ln in build_bucket_plan(shapes, stacked, comp).leaves
             if not ln.dense]
    cases = 0
    for ln in lanes:
        spec = ln.spec
        for bits, words in ((spec.index_bits, spec.index_words),
                            (spec.value_bits, spec.value_words)):
            F = 32 // bits
            fields = torch.randint(-2**31, 2**31 - 1, (ln.L, words * F),
                                   generator=gen, device=dev,
                                   dtype=torch.int32)
            for c in (41, 72, 102, None):
                cnt = (torch.full((ln.L,), c, dtype=torch.int32, device=dev)
                       if c is not None else torch.randint(
                           0, spec.k_b + 1, (ln.L,), generator=gen,
                           device=dev, dtype=torch.int32))
                w = wire_pack.pack_words_ragged(fields, bits, cnt, spec.k_b)
                back = wire_pack.unpack_words_ragged(w, bits, cnt, spec.k_b)
                if not (torch.equal(w, ref.pack_fields(fields, bits, cnt,
                                                       spec.k_b))
                        and torch.equal(back, ref.unpack_fields(
                            w, bits, cnt, spec.k_b))):
                    fail(f"the ragged codec differs from the plain version "
                         f"at a ({ln.L}, {words})-word {bits}-bit section, "
                         f"count {c}")
                cases += 1
    print(f"ragged wire: bit-exact at {cases} cases ({len(lanes)} leaves, "
          "index and value sections, k_b_t 41 / 72 / 102 and random)",
          flush=True)

    big = max(lanes, key=lambda ln: ln.spec.index_words)
    spec, W = big.spec, big.spec.index_words
    F = 32 // spec.index_bits
    fields = torch.randint(-2**31, 2**31 - 1, (big.L, W * F), generator=gen,
                           device=dev, dtype=torch.int32)
    cnt = torch.full((big.L,), 41, dtype=torch.int32, device=dev)
    words = wire_pack.pack_words_ragged(fields, spec.index_bits, cnt,
                                        spec.k_b)
    rwords = ref.pack_fields(fields, spec.index_bits, cnt, spec.k_b)
    back = wire_pack.unpack_words_ragged(words, spec.index_bits, cnt,
                                         spec.k_b)
    rback = ref.unpack_fields(words, spec.index_bits, cnt, spec.k_b)
    # the function's work at this count: the valid fields and the words
    # that hold one (each read once), the other side written whole
    valid = (torch.arange(W * F, device=dev) % spec.k_b < 41)
    n_valid = int(valid.sum()) * big.L
    live_words = int(valid.view(W, F).any(-1).sum()) * big.L
    for name, kernel, plain, x, got, want, nbytes in (
            ("pack_words_ragged", wire_pack.pack_words_ragged,
             ref.pack_fields, fields, words, rwords,
             n_valid * 4 + W * big.L * 4 + big.L * 4),
            ("unpack_words_ragged", wire_pack.unpack_words_ragged,
             ref.unpack_fields, words, back, rback,
             live_words * 4 + W * F * big.L * 4 + big.L * 4)):
        def call(kernel=kernel, x=x):
            return kernel(x, spec.index_bits, cnt, spec.k_b)
        report[name] = dict(
            max_abs_err=float((got.long() - want.long()).abs().max()),
            ms=time_ms(call),
            plain_ms=time_ms(lambda plain=plain, x=x: plain(
                x, spec.index_bits, cnt, spec.k_b)),
            library_ms=None, bytes=nbytes, ops=W * F * big.L * 3,
            note=f"embedding row's 16-bit index section, {W} words, "
                 f"k_b_t 41 of {spec.k_b}; device {device_ms(call):.4f} ms")
        print(f"{name} ({big.L}, {W}) words, 16-bit, k_b_t 41: "
              f"{report[name]['ms']:.4f} ms, device only "
              f"{device_ms(call):.4f} ms (L2 evicted "
              f"{device_ms(call, evict=True):.4f}), host "
              f"{host_ms(call):.4f} ms; plain {report[name]['plain_ms']:.4f}"
              " ms", flush=True)


def adaptive_trainer(dev, shapes, stacked) -> dict:
    """Phase 4e: the adaptive trainer at full width through
    ``launch.train``, on each transport; returns the perleaf run's launch
    counts."""
    from repro_torch.comm.bucket import build_bucket_plan
    from repro_torch.core.compression import Compressor
    from repro_torch.core.dcsgd import plan_wire_bytes
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    plans = {bits: build_bucket_plan(shapes, stacked, Compressor(
        gamma=0.04, method="block_topk", max_gamma=0.1, value_bits=bits))
        for bits in (8, 32)}
    n = len(plans[8].compressed_ids)
    runs = {}
    for label, transport, bits, schedule, steps, per_step in (
            ("perleaf", "perleaf", 8, "linear", ADAPTIVE_STEPS,
             dict(ef_stats_telemetry=n, ef_apply=n, pack_words_ragged=2 * n,
                  unpack_words_ragged=2 * n)),
            ("bucketed", "bucketed", 8, "linear", ADAPTIVE_STEPS,
             dict(ef_stats_telemetry=1, ef_apply=1, pack_words=2,
                  unpack_words=2)),
            ("perleaf ef-coupled", "perleaf", 32, "ef-coupled",
             EF_COUPLED_STEPS,
             dict(ef_stats_telemetry=n, ef_apply=n, pack_words_ragged=n,
                  unpack_words_ragged=n))):
        comp = Compressor(gamma=0.04, method="block_topk", max_gamma=0.1,
                          value_bits=bits)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        log = train.main(MAIN_ARGS + ADAPTIVE_ARGS + [
            "--transport", transport, "--value-bits", str(bits),
            "--gamma-schedule", schedule, "--steps", str(steps)])
        counts = ops.launch_counts()
        runs[label] = counts
        peak = torch.cuda.max_memory_allocated(dev)
        gammas = [x["gamma"] for x in log]
        eff = [x["effective_wire_bytes"] for x in log]
        print(f"adaptive [{label}]: launches {counts}; step_s "
              f"{[round(x['step_s'], 4) for x in log]}; gamma_t {gammas}; "
              f"wire bytes {[x['wire_bytes'] for x in log]}, effective "
              f"{eff}; losses {[x['loss'] for x in log]}; n_evals "
              f"{[x['n_evals'] for x in log]}; peak memory "
              f"{peak / 2**30:.2f} GiB", flush=True)
        for name, c in counts.items():
            if c != per_step.get(name, 0) * steps:
                fail(f"[adaptive {label}] {name} launched {c} times in "
                     f"{steps} steps, want {per_step.get(name, 0) * steps}")
        if not all(np.isfinite(x["loss"]) for x in log) \
                or any(x["steps_skipped"] for x in log):
            fail(f"[adaptive {label}] non-finite loss or skipped steps: "
                 f"{[x['loss'] for x in log]}")
        # the exchange's bytes from shapes at each step's gamma_t
        want = [plan_wire_bytes(plans[bits], comp, np.float32(gm))
                for gm in gammas]
        if [(x["wire_bytes"], x["effective_wire_bytes"]) for x in log] \
                != [(float(w), float(e)) for w, e in want]:
            fail(f"[adaptive {label}] bytes {eff} differ from the "
                 f"exchange's accounting {want}")
        if bits == 8 and (eff != ADAPTIVE_EFFECTIVE or any(
                x["wire_bytes"] != ADAPTIVE_STATIC for x in log)):
            fail(f"[adaptive {label}] effective bytes {eff}, want "
                 f"{ADAPTIVE_EFFECTIVE}; static "
                 f"{[x['wire_bytes'] for x in log]}, want {ADAPTIVE_STATIC}")
    return runs["perleaf"]


def transports_agree(dev, cfg) -> None:
    """Phase 4e: from one saved state (a warm EF memory), one batch and
    its grads, one exchange and update through each transport on the
    card at gamma_t 0.07: parameters and EF memory bit-identical.  The
    grads are computed once: the embedding's backward sums with atomics,
    so two backward passes may differ in the last bit."""
    from repro_torch.comm.exchange import init_process_group
    from repro_torch.configs.base import OptimizerConfig, RunConfig, \
        ShapeConfig
    from repro_torch.core.compression import Compressor
    from repro_torch.core.dcsgd import worker_compress_aggregate
    from repro_torch.core.gamma import GammaControllerConfig
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch.train_step import init_train_state, train_step
    from repro_torch.models import lm
    from repro_torch.utils import tree_leaves, tree_map, value_and_grad
    comp = Compressor(gamma=0.04, method="block_topk", max_gamma=0.1,
                      value_bits=8)
    run = RunConfig(model=cfg, shape=ShapeConfig(256, 8),
                    optimizer=OptimizerConfig(
                        compressor=comp, gamma_controller=
                        GammaControllerConfig(schedule="linear",
                                              ramp_steps=2)))
    created = init_process_group(dev)
    try:
        params = lm.init_params(cfg, seed=0, device=dev)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=256,
                             global_batch=8)
        batch = {k: v.to(dev) for k, v in pipe.batch(0).items()}
        params, state, _ = train_step(params, init_train_state(params, run),
                                      batch, run)
        batch = {k: v.to(dev) for k, v in pipe.batch(1).items()}
        _, grads = value_and_grad(lambda p: lm.loss_fn(p, batch, cfg),
                                  params)
        gamma_t = np.float32(0.07)
        eta = run.optimizer.armijo.scale_for(gamma_t) * state.alpha_prev
        out = {}
        for tp in ("perleaf", "bucketed"):
            upd, mem, wire, eff, _ = worker_compress_aggregate(
                grads, state.memory, eta, comp,
                stacked_mask=lm.stacked_mask(params), gamma_t=gamma_t,
                transport=tp)
            out[tp] = (tree_leaves(tree_map(lambda p, u: p - u, params,
                                            upd)), tree_leaves(mem),
                       wire, eff)
        torch.cuda.synchronize(dev)
    finally:
        if created:
            torch.distributed.destroy_process_group()
    a, b = out["perleaf"], out["bucketed"]
    diff = [i for i, (x, y) in enumerate(zip(a[0] + a[1], b[0] + b[1]))
            if not torch.equal(x, y)]
    if diff or a[2:] != b[2:]:
        fail(f"perleaf and bucketed differ on the card: leaves {diff}, "
             f"bytes {a[2:]} vs {b[2:]}")
    print(f"transports on the card: perleaf == bucketed bit for bit over "
          f"{len(a[0])} parameter and {len(a[1])} EF memory leaves at "
          f"gamma_t 0.07 (effective bytes {float(a[3])})", flush=True)


def kinds_trainer(dev, shapes) -> None:
    """Phase 4f: the trainer's other optimizer kinds and microbatches at
    full width through ``launch.train``, the launch counts set to 0
    just before each run and read just after; then a run made
    non-finite that must raise ``DivergenceError``."""
    from repro_torch.core.health import DivergenceError
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    if 4 * sum(int(np.prod(sh)) for sh in shapes) != DENSE_BYTES:
        fail(f"paper-lm-100m holds {sum(int(np.prod(sh)) for sh in shapes)}"
             f" parameters, not {DENSE_BYTES // 4}")
    one_codec = dict(ef_stats_telemetry=1, ef_apply=1, pack_words=1,
                     unpack_words=1)
    base = MAIN_ARGS + ["--gamma", "0.01"]
    for label, extra, steps, per_step, nbytes in (
            ("nonadaptive", ["--opt", "nonadaptive", "--eta", "0.1"], 2,
             one_codec, COMPRESSED_BYTES),
            ("sls", ["--opt", "sls"], 2, {}, DENSE_BYTES),
            ("sgd", ["--opt", "sgd"], 1, {}, DENSE_BYTES),
            ("dense", ["--opt", "dense"], 1, {}, DENSE_BYTES),
            ("csgd_asss microbatches 2", ["--microbatches", "2"], 2,
             one_codec, COMPRESSED_BYTES)):
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        log = train.main(base + extra + ["--steps", str(steps)])
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"kinds [{label}]: launches {counts}; step_s "
              f"{[round(x['step_s'], 4) for x in log]}; wire bytes "
              f"{[x['wire_bytes'] for x in log]}, effective "
              f"{[x['effective_wire_bytes'] for x in log]}; losses "
              f"{[x['loss'] for x in log]}; alpha "
              f"{[x['alpha'] for x in log]}; n_evals "
              f"{[x['n_evals'] for x in log]}; peak memory "
              f"{peak / 2**30:.2f} GiB", flush=True)
        for name, c in counts.items():
            if c != per_step.get(name, 0) * steps:
                fail(f"[kinds {label}] {name} launched {c} times in "
                     f"{steps} steps, want {per_step.get(name, 0) * steps}")
        if len(log) != steps or not all(np.isfinite(x["loss"])
                                        for x in log) \
                or any(x["steps_skipped"] for x in log):
            fail(f"[kinds {label}] non-finite loss or skipped steps: "
                 f"{[x['loss'] for x in log]}")
        if any((x["wire_bytes"], x["effective_wire_bytes"])
               != (nbytes, nbytes) for x in log):
            fail(f"[kinds {label}] bytes {[x['wire_bytes'] for x in log]}, "
                 f"want {nbytes} a step")
        searched = label in ("sls", "csgd_asss microbatches 2")
        if not all(x["n_evals"] >= 1 if searched else
                   (x["n_evals"] == 0 and x["alpha"] == float(np.float32(
                       0.1))) for x in log):
            fail(f"[kinds {label}] alpha {[x['alpha'] for x in log]}, "
                 f"n_evals {[x['n_evals'] for x in log]}")
    ops.reset_launch_counts()
    try:
        log = train.main(base + ["--opt", "sgd", "--eta", "inf",
                                 "--max-consecutive-skips", "2",
                                 "--steps", "5"])
    except DivergenceError as e:
        if (e.step, e.last_good_step, e.consecutive) != (1, -1, 2) \
                or any(ops.launch_counts().values()):
            fail(f"DivergenceError at step {e.step}, last good step "
                 f"{e.last_good_step}, {e.consecutive} skips, launches "
                 f"{ops.launch_counts()}; want step 1, -1, 2 and none")
        print(f"kinds [sgd --eta inf --max-consecutive-skips 2]: raised "
              f"DivergenceError: {e}", flush=True)
    else:
        fail(f"--eta inf ran {len(log)} steps without DivergenceError")


def runtime_trainer(dev, root: Path) -> None:
    """Phase 4g: the trainer's runtime beyond one step at full width
    through ``launch.train``, the launch counts set to 0 just before
    each run and read just after: local-steps rounds (``csgd_asss`` and
    ``nonadaptive``), bf16 EF memory, and checkpoints saved, resumed and
    restored on the card."""
    import shutil

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.train_step import init_train_state
    from repro_torch.models import lm
    from repro_torch.utils import tree_leaves
    one_codec = dict(ef_stats_telemetry=1, ef_apply=1, pack_words=1,
                     unpack_words=1)
    base = MAIN_ARGS + ["--gamma", "0.01"]

    def checked_run(label, extra, steps):
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        log, params, state = train.run(base + extra + ["--steps",
                                                       str(steps)])
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"runtime [{label}]: launches {counts}; step_s "
              f"{[round(x['step_s'], 4) for x in log]}; wire bytes "
              f"{[x['wire_bytes'] for x in log]}; losses "
              f"{[x['loss'] for x in log]}; alpha "
              f"{[x['alpha'] for x in log]}; n_evals "
              f"{[x['n_evals'] for x in log]}; peak memory "
              f"{peak / 2**30:.2f} GiB", flush=True)
        for name, c in counts.items():
            if c != one_codec.get(name, 0) * steps:
                fail(f"[runtime {label}] {name} launched {c} times in "
                     f"{steps} rounds, want {one_codec.get(name, 0) * steps}")
        if len(log) != steps or not all(np.isfinite(x["loss"])
                                        for x in log) \
                or any(x["steps_skipped"] for x in log):
            fail(f"[runtime {label}] non-finite loss or skipped rounds: "
                 f"{[x['loss'] for x in log]}")
        if any((x["wire_bytes"], x["effective_wire_bytes"])
               != (COMPRESSED_BYTES, COMPRESSED_BYTES) for x in log):
            fail(f"[runtime {label}] bytes {[x['wire_bytes'] for x in log]}"
                 f", want {COMPRESSED_BYTES} a round")
        if not all(x["n_evals"] >= 1 for x in log):
            fail(f"[runtime {label}] n_evals {[x['n_evals'] for x in log]}:"
                 " every local step runs the Armijo search")
        return log, params, state

    local = ["--local-steps", "2", "--microbatches", "2"]
    checked_run("local steps 2", local, LOCAL_ROUNDS)
    checked_run("local steps 2, nonadaptive",
                local + ["--opt", "nonadaptive", "--eta", "0.1"],
                LOCAL_ROUNDS)
    _, _, state = checked_run("ef-dtype bfloat16",
                              ["--ef-dtype", "bfloat16"], BF16_STEPS)
    mem = tree_leaves(state.memory)
    mem_bytes = sum(m.numel() * m.element_size() for m in mem)
    if not all(m.dtype == torch.bfloat16 and m.is_cuda for m in mem) \
            or mem_bytes != EF_BYTES["bfloat16"]:
        fail(f"[runtime ef-dtype bfloat16] EF memory "
             f"{sorted({str(m.dtype) for m in mem})}, {mem_bytes} B; want "
             f"bf16 leaves on the card, {EF_BYTES['bfloat16']} B")
    del state, mem

    # checkpoints: 2 steps saved after each, then --resume to 4
    tmp = root / "_smoke_ckpt"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        d = str(tmp / "run")
        _, params, state = train.run(base + ["--steps", "2", "--ckpt-dir",
                                             d, "--ckpt-every", "1"])
        rank_dir = train.rank_dir(d, 0)
        step_dir = Path(rank_dir) / "step_0000000002"
        if ckpt.all_steps(rank_dir) != [1, 2] or state.step != 2:
            fail(f"checkpoints {ckpt.all_steps(rank_dir)} after 2 steps, "
                 "want [1, 2]")
        on_disk = sum(f.stat().st_size for f in step_dir.iterdir())
        cfg = get_config("paper-lm-100m")
        skel = lm.init_params(cfg, seed=1, device=dev)
        skeleton = {"params": skel, "state": init_train_state(
            skel, RunConfig(model=cfg, shape=ShapeConfig(256, 8)))}
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        tree, meta = ckpt.restore(rank_dir, skeleton, step=2)
        torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t0
        del skeleton, skel
        saved = tree_leaves(params) + tree_leaves(state.memory)
        back = tree_leaves(tree["params"]) + tree_leaves(
            tree["state"].memory)
        if meta != {"step": 2, "world_size": 1} or len(saved) != len(
                back) or not all(b.is_cuda and torch.equal(a, b)
                                 for a, b in zip(saved, back)) \
                or tree["state"].alpha_prev != state.alpha_prev:
            fail(f"the checkpoint of step 2 ({meta}) does not restore on "
                 "the card bit-identical to the tensors saved")
        del tree, back, saved
        t0 = time.perf_counter()
        ckpt.save(str(tmp / "timed"), 2, {"params": params, "state": state})
        save_s = time.perf_counter() - t0
        del params, state
        shutil.rmtree(tmp / "timed")
        print(f"runtime [checkpoint]: step 2 restored on the card "
              f"bit-identical (params and EF memory); save {save_s:.3f} s, "
              f"restore {restore_s:.3f} s; {on_disk} B on disk (EF memory "
              f"float32, {2 * EF_BYTES['float32']} B of tensors)",
              flush=True)
        log, _, state = train.run(base + ["--steps", "4", "--ckpt-dir", d,
                                          "--resume"])
        print(f"runtime [resume]: logged steps {[x['step'] for x in log]}, "
              f"losses {[x['loss'] for x in log]}, step_s "
              f"{[round(x['step_s'], 4) for x in log]}", flush=True)
        if [x["step"] for x in log] != [2, 3] or state.step != 4 \
                or not all(np.isfinite(x["loss"]) for x in log):
            fail(f"--resume logged steps {[x['step'] for x in log]} and "
                 f"ended at step {state.step}: want a resume at step 2, "
                 "steps [2, 3], finite losses")
        del state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def acgd_downlink_trainer(dev) -> None:
    """Phase 4h: ``--opt acgd`` and ``--downlink compressed`` at full
    width through ``launch.train``, the launch counts set to 0 just
    before each run and read just after."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.utils import tree_leaves
    one_codec = dict(ef_stats_telemetry=1, ef_apply=1, pack_words=1,
                     unpack_words=1)
    ragged = dict(ef_stats_telemetry=9, ef_apply=9, pack_words_ragged=18,
                  unpack_words_ragged=18)
    base = MAIN_ARGS + ["--steps", str(ACGD_STEPS)]
    for label, extra, per_step, up, down in (
            ("acgd", ["--opt", "acgd", "--eta", "0.1", "--momentum", "0.9",
                      "--gamma", "0.01"], one_codec,
             (COMPRESSED_BYTES, COMPRESSED_BYTES), None),
            ("downlink compressed", ["--downlink", "compressed", "--gamma",
                                     "0.01"], one_codec,
             (COMPRESSED_BYTES, COMPRESSED_BYTES),
             (COMPRESSED_BYTES, COMPRESSED_BYTES)),
            ("acgd downlink perleaf", ["--opt", "acgd", "--downlink",
                                       "compressed", "--transport",
                                       "perleaf", "--max-gamma", "0.1",
                                       "--gamma", "0.04", "--downlink-gamma",
                                       "0.04", "--value-bits", "8"], ragged,
             (ADAPTIVE_STATIC, ADAPTIVE_EFFECTIVE[0]),
             (ADAPTIVE_STATIC, ADAPTIVE_EFFECTIVE[0]))):
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        log, _, state = train.run(base + extra)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        pairs = {d: [(x.get(f"{p}wire_bytes"),
                      x.get(f"{p}effective_wire_bytes")) for x in log]
                 for d, p in (("up", ""), ("down", "downlink_"))}
        print(f"acgd/downlink [{label}]: launches {counts}; step_s "
              f"{[round(x['step_s'], 4) for x in log]}; losses "
              f"{[x['loss'] for x in log]}; alpha "
              f"{[x['alpha'] for x in log]}; n_evals "
              f"{[x['n_evals'] for x in log]}; (static, effective) bytes "
              f"up {pairs['up']}, down {pairs['down']}; cum_effective "
              f"{[x['cum_effective_wire_bytes'] for x in log]}; peak "
              f"memory {peak / 2**30:.2f} GiB", flush=True)
        for name, c in counts.items():
            if c != per_step.get(name, 0) * ACGD_STEPS:
                fail(f"[{label}] {name} launched {c} times in {ACGD_STEPS} "
                     f"steps, want {per_step.get(name, 0) * ACGD_STEPS}")
        if len(log) != ACGD_STEPS or not all(np.isfinite(x["loss"])
                                             for x in log) \
                or any(x["steps_skipped"] for x in log):
            fail(f"[{label}] non-finite loss or skipped steps: "
                 f"{[x['loss'] for x in log]}")
        if any((x["wire_bytes"], x["effective_wire_bytes"]) != up
               for x in log):
            fail(f"[{label}] uplink bytes, want {up} a step")
        if down is None:
            if any("downlink_wire_bytes" in x for x in log) \
                    or state.downlink is not None:
                fail(f"[{label}] a downlink without --downlink compressed")
        else:
            if any((x["downlink_wire_bytes"],
                    x["downlink_effective_wire_bytes"]) != down
                   for x in log):
                fail(f"[{label}] downlink bytes, want {down} a step")
            want_cum = ACGD_STEPS * (up[1] + down[1])
            if log[-1]["cum_effective_wire_bytes"] != want_cum:
                fail(f"[{label}] cum_effective_wire_bytes "
                     f"{log[-1]['cum_effective_wire_bytes']}, want "
                     f"{want_cum}")
            mem = state.downlink.memory
            if mem.dtype != torch.float32 or not mem.is_cuda \
                    or mem.numel() != SERVER_WORDS:
                fail(f"[{label}] server memory {mem.dtype} {mem.device} "
                     f"{mem.numel()} words, want f32 on the card, "
                     f"{SERVER_WORDS}")
            print(f"  server memory: {mem.numel()} f32 words "
                  f"({mem.numel() * 4} B) on {mem.device}", flush=True)
        if "acgd" in label:
            if not all(x["n_evals"] == 0 and x["alpha"] == float(
                    np.float32(0.1)) for x in log):
                fail(f"[{label}] alpha {[x['alpha'] for x in log]}, n_evals "
                     f"{[x['n_evals'] for x in log]}: want 0.1 and 0")
            vel = tree_leaves(state.velocity)
            nbytes = sum(v.numel() * v.element_size() for v in vel)
            if not all(v.dtype == torch.float32 and v.is_cuda for v in vel) \
                    or nbytes != DENSE_BYTES:
                fail(f"[{label}] velocity {nbytes} B, want f32 leaves on "
                     f"the card, {DENSE_BYTES} B")
            print(f"  velocity: {len(vel)} f32 leaves, {nbytes} B on the "
                  "card", flush=True)
        del state


def check_roundtrip(dev, gen, shapes, stacked) -> None:
    """Phase 4h: ``roundtrip_rows`` against ``decode_rows(encode_rows)``
    through the CUDA codec, bit for bit, at the downlink's rows of every
    compressed leaf of paper-lm-100m: 32-bit and 8-bit values at gamma
    0.01, and ragged 8-bit rows at count 41 of 102."""
    from repro_torch.comm import wire
    from repro_torch.comm.downlink import downlink_plan
    from repro_torch.core.compression import Compressor
    from repro_torch.core.leafmath import compress_leaf, leaf_count
    for label, comp, gamma_t in (
            ("32-bit", Compressor(gamma=0.01, method="block_topk"), None),
            ("8-bit", Compressor(gamma=0.01, method="block_topk",
                                 value_bits=8), None),
            ("ragged 8-bit", Compressor(gamma=0.04, method="block_topk",
                                        max_gamma=0.1, value_bits=8),
             np.float32(0.04))):
        rows = 0
        for ln in downlink_plan(shapes, stacked, comp).leaves:
            if ln.dense:
                continue
            x = torch.randn((ln.L, ln.d), generator=gen, device=dev) * 1e-3
            vals, idx, _ = compress_leaf(x, comp, ln.stacked)
            count = leaf_count(comp, ln.spec, gamma_t, ln.d)
            counts = None if count is None else wire.row_counts(
                count, ln.L, dev)
            rv, ri = wire.roundtrip_rows(vals, idx, ln.spec, counts=counts)
            wv, wi = wire.decode_rows(wire.encode_rows(
                vals, idx, ln.spec, counts=counts), ln.spec)
            torch.cuda.synchronize(dev)
            if not (torch.equal(rv.view(torch.int32), wv.view(torch.int32))
                    and torch.equal(ri, wi)):
                fail(f"roundtrip_rows differs from the CUDA codec's round "
                     f"trip at {label}, leaf {ln.index} ({ln.L}, {ln.d})")
            rows += ln.L
        print(f"roundtrip_rows [{label}]: bit-identical to decode_rows("
              f"encode_rows) through the CUDA codec over {rows} rows"
              + (f" at count {comp.block_k_t(gamma_t)} of "
                 f"{comp.block_k()}" if gamma_t is not None else ""),
              flush=True)


def profile_downlink(dev, cfg) -> None:
    """Phase 4h: one warm full-width step of ``acgd --downlink
    compressed`` at gamma 0.01 under torch.profiler, as in 4b (the host
    time of the ``train_step.downlink`` span among the spans); then the
    server round alone (``apply_downlink`` on that step's mean updates'
    shapes, from one batch's gradients) under the profiler: its sort,
    the downlink's ``block_extract_sparse``, and its other passes."""
    from repro_torch.comm.downlink import apply_downlink
    from repro_torch.comm.exchange import init_process_group
    from repro_torch.configs.base import OptimizerConfig, RunConfig, \
        ShapeConfig
    from repro_torch.core.compression import Compressor
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch.train_step import init_train_state, train_step
    from repro_torch.models import lm
    from repro_torch.utils import tree_flatten, value_and_grad
    comp = Compressor(gamma=0.01, method="block_topk")
    run = RunConfig(model=cfg, shape=ShapeConfig(256, 8),
                    optimizer=OptimizerConfig(kind="acgd", compressor=comp,
                                              downlink="compressed"))
    created = init_process_group(dev)
    try:
        params = lm.init_params(cfg, seed=0, device=dev)
        state = init_train_state(params, run)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=256,
                             global_batch=8)
        for step in range(2):
            batch = {k: v.to(dev) for k, v in pipe.batch(step).items()}
            params, state, _ = train_step(params, state, batch, run)
        batch = {k: v.to(dev) for k, v in pipe.batch(2).items()}
        prof, wall_ms = profiled(
            dev, lambda: train_step(params, state, batch, run))
        spans = report_profile(
            "acgd downlink", prof, wall_ms,
            ("ef_stats_telemetry_kernel", "ef_apply_kernel",
             "pack_words_kernel", "unpack_words_kernel"))
        if len(spans) != 4 or "train_step.downlink" not in spans \
                or min(spans.values()) <= 0:
            fail(f"the profiler saw acgd downlink spans {spans}, want "
                 "grad, exchange, downlink and metrics, each timed")
        _, grads = value_and_grad(lambda p: lm.loss_fn(p, batch, cfg),
                                  params)
        flat = [g.float() * 1e-2 for g in tree_flatten(grads)[0]]
        flat_s = tree_flatten(lm.stacked_mask(params))[0]
        del grads
        server = state.downlink
        server_prof, server_ms = profiled(
            dev, lambda: apply_downlink(flat, flat_s, comp, server))
    finally:
        if created:
            torch.distributed.destroy_process_group()
    groups = {}
    for ev in server_prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0)
        if us > 0 and ev.device_type != torch.autograd.DeviceType.CPU:
            g = kernel_group(ev.key)
            groups[g] = groups.get(g, 0.0) + us / 1e3
    ported = [g for g in groups if g.endswith("_kernel")]
    if ported or "sort" not in groups:
        fail(f"the server round alone ran {sorted(groups)}: want a sort "
             "and no kernel of the port")
    busy = sum(groups.values())
    print(f"profile [server round alone]: {server_ms:.2f} ms wall "
          f"(profiler on), device busy {busy:.3f} ms: sort (the "
          f"downlink's block_extract_sparse) {groups['sort']:.3f} ms, "
          f"other passes {busy - groups['sort']:.3f} ms "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(groups.items())),
          flush=True)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Two tensors bit for bit: dtype, shape and every byte."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def trees_equal(a, b) -> bool:
    from repro_torch.utils import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(bits_equal(x, y)
                                      for x, y in zip(la, lb))


def overlap_trainer(dev, root: Path) -> None:
    """Phase 4i: ``--transport overlap`` at full width through
    ``launch.train``, the launch counts set to 0 just before each run and
    read just after: delay 0 against bucketed bit for bit (32- and 8-bit
    values), the delay-1 warm-up and stale aggregate against bucketed
    bit for bit, local steps and an adaptive budget at delay 1 with the
    EF identity on the embedding leaf, and a delay-1 checkpoint resumed
    on the card bit for bit."""
    import shutil

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.comm.bucket import decode_buckets
    from repro_torch.comm.exchange import init_process_group
    from repro_torch.comm.overlap import OverlapConfig, OverlapCtx, \
        init_overlap_state
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, RunConfig, \
        ShapeConfig
    from repro_torch.core.compression import Compressor
    from repro_torch.core.dcsgd import _tree_plan, worker_compress_aggregate
    from repro_torch.core.leafmath import scatter_layers
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ef_acc
    from repro_torch.launch import train
    from repro_torch.launch.train_step import init_train_state
    from repro_torch.models import lm
    from repro_torch.utils import tree_flatten, tree_leaves, \
        value_and_grad
    cfg = get_config("paper-lm-100m")
    base = MAIN_ARGS + ["--gamma", "0.01"]
    ov = ["--transport", "overlap", "--overlap-chunks", str(OVERLAP_CHUNKS)]

    def checked_run(label, extra, steps, want=None):
        """``steps`` steps of ``base + extra``; fails on a non-finite
        loss, a skipped step, a ragged launch or launches other than
        ``want`` (a dict of counts) when given."""
        torch.cuda.reset_peak_memory_stats(dev)
        # what earlier runs still hold counts in the peak: report both
        live = torch.cuda.memory_allocated(dev)
        ops.reset_launch_counts()
        log, params, state = train.run(base + extra + ["--steps",
                                                       str(steps)])
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) - live
        print(f"overlap [{label}]: launches {counts}; step_s "
              f"{[round(x['step_s'], 4) for x in log]}; (static, "
              f"effective) bytes "
              f"{[(x['wire_bytes'], x['effective_wire_bytes']) for x in log]}"
              f"; staleness {[x.get('staleness') for x in log]}; losses "
              f"{[x['loss'] for x in log]}; gamma "
              f"{[x['gamma'] for x in log]}; peak memory "
              f"{peak / 2**30:.2f} GiB above the {live / 2**30:.2f} GiB "
              "live before the run", flush=True)
        if len(log) != steps or not all(np.isfinite(x["loss"])
                                        for x in log) \
                or any(x["steps_skipped"] for x in log):
            fail(f"[overlap {label}] non-finite loss or skipped steps: "
                 f"{[x['loss'] for x in log]}")
        if counts.get("pack_words_ragged") or counts.get(
                "unpack_words_ragged"):
            fail(f"[overlap {label}] ragged codec launches {counts}")
        if want is not None and counts != want:
            fail(f"[overlap {label}] launches {counts}, want {want}")
        return log, params, state, counts, peak

    def same_run(label, a, b, keys=("wire_bytes", "effective_wire_bytes",
                                    "gamma")):
        """Runs ``a`` and ``b`` (log, params, state): parameters, EF
        memory and the logged ``keys`` bit for bit."""
        if not trees_equal(a[1], b[1]) or not trees_equal(a[2].memory,
                                                          b[2].memory):
            fail(f"[overlap {label}] parameters or EF memory differ")
        for k in keys:
            if [x[k] for x in a[0]] != [x[k] for x in b[0]]:
                fail(f"[overlap {label}] {k} {[x[k] for x in a[0]]} != "
                     f"{[x[k] for x in b[0]]}")

    # ---- delay 0: bucketed over the ring, bit for bit --------------------
    times = {}
    for bits in ("32", "8"):
        extra = ["--value-bits", bits]
        buck = checked_run(f"bucketed {bits}-bit", extra, OVERLAP_STEPS)
        d0 = checked_run(f"delay 0 {bits}-bit",
                         extra + ov + ["--overlap-delay", "0"],
                         OVERLAP_STEPS, want=buck[3])
        same_run(f"delay 0 {bits}-bit", buck[:3], d0[:3])
        if any(x["staleness"] != 0.0 for x in d0[0]):
            fail("[overlap delay 0] staleness must read 0")
        times[f"bucketed {bits}-bit"] = [x["step_s"] for x in buck[0][1:]]
        times[f"delay 0 {bits}-bit"] = [x["step_s"] for x in d0[0][1:]]
        print(f"overlap [delay 0 {bits}-bit]: parameters, EF memory, wire "
              f"and effective bytes and gamma_t bit-identical to bucketed "
              f"after {OVERLAP_STEPS} steps; peak {d0[4] / 2**30:.2f} GiB "
              f"vs {buck[4] / 2**30:.2f}", flush=True)
        del buck, d0

    # ---- delay 1: the warm-up and the stale aggregate --------------------
    b1 = checked_run("bucketed 1 step", [], 1)
    o1 = checked_run("delay 1, 1 step", ov, 1, want=b1[3])
    init = lm.init_params(cfg, seed=0, device=dev)
    if not trees_equal(o1[1], init):
        fail("[overlap delay 1] step 1 moved the parameters: the warm-up "
             "applies the zero payload")
    if not trees_equal(o1[2].memory, b1[2].memory):
        fail("[overlap delay 1] step 1's EF memory differs from bucketed's")
    zero_eff = float(init_overlap_state(
        [p.shape for p in tree_leaves(init)],
        tree_flatten(lm.stacked_mask(init))[0],
        Compressor(gamma=0.01, method="block_topk")).eff_wire)
    del init, o1
    o2 = checked_run("delay 1, 2 steps", ov, 2,
                     want={k: 2 * v for k, v in b1[3].items()})
    if not trees_equal(o2[1], b1[1]):
        fail("[overlap delay 1] the parameters after step 2 differ from "
             "bucketed's after step 1: step 2 applies step 1's payload")
    if [x["staleness"] for x in o2[0]] != [0.0, 1.0] or \
            [x["effective_wire_bytes"] for x in o2[0]] != [
                zero_eff, b1[0][0]["effective_wire_bytes"]]:
        fail(f"[overlap delay 1] staleness "
             f"{[x['staleness'] for x in o2[0]]} (want 0, 1), effective "
             f"bytes {[x['effective_wire_bytes'] for x in o2[0]]} (want "
             f"{zero_eff} then bucketed step 1's)")
    print(f"overlap [delay 1]: step 1 a zero update with bucketed's EF "
          f"memory, step 2 bucketed step 1's parameters, bit-identical; "
          f"staleness 0, 1; effective bytes {zero_eff} (the zero payload) "
          f"then {b1[0][0]['effective_wire_bytes']}; carried payload "
          f"{o2[2].overlap.payload.numel()} int32 words and "
          f"{o2[2].overlap.dense.numel()} dense f32 on "
          f"{o2[2].overlap.payload.device}", flush=True)
    del b1, o2

    def ef_identity(label, run_cfg, state, eta):
        """One exchange on the card from ``state`` (its EF memory, carried
        payload and gamma_t) on a fresh gradient: on the embedding leaf,
        decode(own current payload) + m' == m + eta*g bit for bit."""
        params = lm.init_params(cfg, seed=3, device=dev)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=256,
                             global_batch=8)
        batch = {k: v.to(dev) for k, v in pipe.batch(7).items()}
        _, grads = value_and_grad(lambda p: lm.loss_fn(p, batch, cfg),
                                  params)
        opt = run_cfg.optimizer
        smask = lm.stacked_mask(params)
        created = init_process_group(dev)
        try:
            out = worker_compress_aggregate(
                grads, state.memory, eta, opt.compressor,
                stacked_mask=smask, gamma_t=state.gamma,
                transport="overlap",
                transport_ctx=OverlapCtx(opt.overlap, state.overlap))
        finally:
            if created:
                torch.distributed.destroy_process_group()
        flat_g, flat_s = tree_flatten(grads)[0], tree_flatten(smask)[0]
        plan = _tree_plan(flat_g, flat_s, opt.compressor)
        lane = max((ln for ln in plan.leaves if not ln.dense),
                   key=lambda ln: ln.L * ln.d)
        vals, idx = decode_buckets(plan, out[5].payload[None])[lane.index]
        own = scatter_layers(vals[0], idx[0], lane.L, lane.d)
        m = tree_flatten(state.memory)[0][lane.index].reshape(lane.L,
                                                              lane.d)
        m2 = tree_flatten(out[1])[0][lane.index].reshape(lane.L, lane.d)
        acc = ef_acc(m, flat_g[lane.index].reshape(lane.L, lane.d),
                     torch.tensor([eta], device=dev))
        if not bits_equal(own + m2, acc):
            fail(f"[overlap {label}] the EF identity decode(own) + m' == "
                 f"m + eta*g breaks on leaf {lane.index} ({lane.L}, "
                 f"{lane.d}) in {int((own + m2 != acc).sum())} entries")
        print(f"overlap [{label}]: EF identity decode(own) + m' == m + "
              f"eta*g bit for bit on leaf {lane.index} ({lane.L}, "
              f"{lane.d}), eta {eta}", flush=True)

    # ---- local steps and an adaptive budget at delay 1 -------------------
    def overlap_cfg(comp, **kw):
        return RunConfig(model=cfg, shape=ShapeConfig(256, 8),
                         microbatches=kw.get("local_steps", 1),
                         optimizer=OptimizerConfig(
                             compressor=comp, transport="overlap",
                             overlap=OverlapConfig(n_chunks=OVERLAP_CHUNKS),
                             **kw))

    comp01 = Compressor(gamma=0.01, method="block_topk")
    local = ["--local-steps", "2", "--microbatches", "2"]
    one_codec = dict.fromkeys(ops.launch_counts(), 0)
    one_codec.update(ef_stats_telemetry=OVERLAP_LOCAL, ef_apply=OVERLAP_LOCAL,
                     pack_words=OVERLAP_LOCAL, unpack_words=OVERLAP_LOCAL)
    lo = checked_run("delay 1, local steps 2", ov + local, OVERLAP_LOCAL,
                     want=one_codec)
    ef_identity("delay 1, local steps 2",
                overlap_cfg(comp01, local_steps=2), lo[2], 1.0)
    del lo
    adaptive = ["--max-gamma", "0.1", "--gamma", "0.04"]
    ab = checked_run("bucketed, adaptive 10%", adaptive, OVERLAP_LOCAL)
    ao = checked_run("delay 1, adaptive 10%", ov + adaptive, OVERLAP_LOCAL,
                     want=ab[3])
    if ao[0][1]["effective_wire_bytes"] != ab[0][0]["effective_wire_bytes"]:
        fail("[overlap adaptive] step 2 must report the carried step-1 "
             "effective bytes")
    ef_identity("delay 1, adaptive 10%", overlap_cfg(Compressor(
        gamma=0.04, max_gamma=0.1, method="block_topk")), ao[2], 0.05)
    del ab, ao

    # ---- a delay-1 checkpoint, restored on the card and resumed ----------
    tmp = root / "_smoke_ckpt"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        d = str(tmp / "overlap")
        straight = checked_run("delay 1, 4 steps", ov, 4)
        times["delay 1"] = [x["step_s"] for x in straight[0][1:]]
        _, _, saved = train.run(base + ov + ["--steps", "2", "--ckpt-dir",
                                             d, "--ckpt-every", "2"])
        skel = lm.init_params(cfg, seed=1, device=dev)
        tree, _ = ckpt.restore(train.rank_dir(d, 0), {
            "params": skel,
            "state": init_train_state(skel, overlap_cfg(comp01))},
            step=2)
        back = tree["state"].overlap
        if not (bits_equal(back.payload, saved.overlap.payload)
                and bits_equal(back.dense, saved.overlap.dense)
                and back.payload.device == saved.overlap.payload.device
                and back.eff_wire == saved.overlap.eff_wire
                and back.seeded == saved.overlap.seeded == 1.0):
            fail("[overlap checkpoint] the carried state of step 2 does not "
                 "restore on the card bit-identical")
        del tree, back, skel, saved
        log, params, state = train.run(base + ov + [
            "--steps", "4", "--ckpt-dir", d, "--resume"])
        if [x["step"] for x in log] != [2, 3] or not trees_equal(
                params, straight[1]) or not trees_equal(
                    state.memory, straight[2].memory) or not (
                bits_equal(state.overlap.payload,
                           straight[2].overlap.payload)
                and bits_equal(state.overlap.dense,
                               straight[2].overlap.dense)):
            fail("[overlap checkpoint] a resume from step 2 to 4 differs "
                 "from 4 uninterrupted steps")
        print(f"overlap [checkpoint]: step 2 restored on the card with its "
              f"carried payload; resumed to 4 bit-identical to 4 "
              f"uninterrupted steps (parameters, EF memory, carried "
              f"payload); staleness {[x['staleness'] for x in log]}",
              flush=True)
        del straight, params, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for label, t in times.items():
        print(f"overlap warm step_s [{label}]: {t}", flush=True)


def gossip_trainer(dev, root: Path) -> None:
    """Phase 4j: ``--transport gossip`` at full width through
    ``launch.train`` on one worker (ring(1): no edge), the launch counts
    set to 0 just before each run and read just after: against bucketed
    from the same seed at 32 and 8 bits (EF memory bit for bit,
    parameters equal, bytes and gamma_t equal, bucketed's launches, v 0
    and lr 1 after every step), and a checkpoint after 2 steps resumed
    to 4, bit for bit with 4 straight steps."""
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.launch import train
    base = MAIN_ARGS + ["--gamma", "0.01"]
    gossip = ["--transport", "gossip", "--topology", "ring"]

    def checked_run(label, extra, steps, want=None, first=0):
        """Steps ``first`` ... ``steps`` - 1 of ``base + extra``, (v, lr)
        read after each; fails on a non-finite loss, a skipped step, a
        ragged launch or launches other than ``want`` when given."""
        torch.cuda.reset_peak_memory_stats(dev)
        live = torch.cuda.memory_allocated(dev)
        seen = []
        real = train.train_step

        def recording(*a, **k):
            out = real(*a, **k)
            if out[1].gossip is not None:
                seen.append((float(out[1].gossip.v),
                             float(out[1].gossip.lr)))
            return out
        train.train_step = recording
        try:
            ops.reset_launch_counts()
            log, params, state = train.run(base + extra + ["--steps",
                                                           str(steps)])
            counts = ops.launch_counts()
        finally:
            train.train_step = real
        peak = torch.cuda.max_memory_allocated(dev) - live
        print(f"gossip [{label}]: launches {counts}; step_s "
              f"{[round(x['step_s'], 4) for x in log]}; (static, "
              f"effective) bytes "
              f"{[(x['wire_bytes'], x['effective_wire_bytes']) for x in log]}"
              f"; losses {[x['loss'] for x in log]}; gamma "
              f"{[x['gamma'] for x in log]}; (v, lr) {seen}; peak memory "
              f"{peak / 2**30:.2f} GiB above the {live / 2**30:.2f} GiB "
              "live before the run", flush=True)
        if len(log) != steps - first or not all(np.isfinite(x["loss"])
                                        for x in log) \
                or any(x["steps_skipped"] for x in log):
            fail(f"[gossip {label}] non-finite loss or skipped steps: "
                 f"{[x['loss'] for x in log]}")
        if counts.get("pack_words_ragged") or counts.get(
                "unpack_words_ragged"):
            fail(f"[gossip {label}] ragged codec launches {counts}")
        if want is not None and counts != want:
            fail(f"[gossip {label}] launches {counts}, want {want}")
        if "--transport" in extra and seen != [(0.0, 1.0)] * len(log):
            fail(f"[gossip {label}] (v, lr) after each step {seen}, want "
                 "(0, 1): one worker has no neighbour")
        return log, params, state, counts, peak

    def trees_value_equal(a, b) -> bool:
        from repro_torch.utils import tree_leaves
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(torch.equal(x, y)
                                          for x, y in zip(la, lb))

    times = {}
    for bits in ("32", "8"):
        extra = ["--value-bits", bits]
        buck = checked_run(f"bucketed {bits}-bit", extra, GOSSIP_STEPS)
        gos = checked_run(f"gossip {bits}-bit", extra + gossip,
                          GOSSIP_STEPS, want=buck[3])
        if not trees_equal(gos[2].memory, buck[2].memory):
            fail(f"[gossip {bits}-bit] EF memory differs from bucketed's")
        if not trees_value_equal(gos[1], buck[1]):
            fail(f"[gossip {bits}-bit] parameters differ from bucketed's")
        for k in ("wire_bytes", "effective_wire_bytes", "gamma"):
            if [x[k] for x in gos[0]] != [x[k] for x in buck[0]]:
                fail(f"[gossip {bits}-bit] {k} {[x[k] for x in gos[0]]} "
                     f"!= bucketed's {[x[k] for x in buck[0]]}")
        if gos[2].gossip.v.device != dev:
            fail("[gossip] the GossipState is not on the card")
        times[f"bucketed {bits}-bit"] = [x["step_s"] for x in buck[0][1:]]
        times[f"gossip {bits}-bit"] = [x["step_s"] for x in gos[0][1:]]
        print(f"gossip [{bits}-bit]: EF memory bit-identical, parameters "
              f"equal, wire and effective bytes and gamma_t equal to "
              f"bucketed after {GOSSIP_STEPS} steps with bucketed's "
              f"launches {buck[3]}; peak {gos[4] / 2**30:.2f} GiB vs "
              f"{buck[4] / 2**30:.2f}", flush=True)
        del buck, gos

    # ---- a checkpoint after 2 steps, resumed to 4 -----------------------
    tmp = root / "_smoke_ckpt"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        d = str(tmp / "gossip")
        straight = checked_run("gossip 4 steps", gossip, 4)
        times["gossip 4 steps"] = [x["step_s"] for x in straight[0][1:]]
        checked_run("gossip 2 steps, saved", gossip + [
            "--ckpt-dir", d, "--ckpt-every", "2"], 2)
        log, params, state, _, _ = checked_run(
            "gossip resumed to 4", gossip + ["--ckpt-dir", d, "--resume"], 4,
            first=2)
        if [x["step"] for x in log] != [2, 3] or not trees_equal(
                params, straight[1]) or not trees_equal(
                    state.memory, straight[2].memory) or not (
                bits_equal(state.gossip.v, straight[2].gossip.v)
                and bits_equal(state.gossip.lr, straight[2].gossip.lr)):
            fail("[gossip checkpoint] a resume from step 2 to 4 differs "
                 "from 4 uninterrupted steps")
        print("gossip [checkpoint]: resumed from step 2 to 4 bit-identical "
              "to 4 uninterrupted steps (parameters, EF memory, v, lr)",
              flush=True)
        del straight, params, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for label, t in times.items():
        print(f"gossip warm step_s [{label}]: {t}", flush=True)


def fault_trainer(dev, root: Path) -> dict:
    """Phase 4k: the hostile-wire layer at full width through
    ``launch.train`` on one worker, the launch counts set to 0 just
    before each run and read just after: the decode verdicts (on by
    default) against ``guards_disabled()`` bit for bit with the same
    launches on bucketed at 32 and 8 bits and on perleaf at a 10% budget,
    and the exchange alone timed each way; a NaN round that quarantines
    every compressed row and keeps the EF memory; bitflip and count
    faults on ragged perleaf through the CUDA codec, guarded and not,
    each corrupted row and its decode equal to the CPU port's; the
    wrapper around overlap (delay 1) and gossip outside its burst equal
    to them bit for bit; a checkpoint inside a burst, resumed.  Returns
    the phase's times and ratios, which ``main`` prints again near the
    end of the output."""
    import shutil

    from repro_torch.comm import faults, wire
    from repro_torch.comm.bucket import build_bucket_plan
    from repro_torch.comm.exchange import init_process_group
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, RunConfig, \
        ShapeConfig
    from repro_torch.core.compression import Compressor
    from repro_torch.core.dcsgd import worker_compress_aggregate
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.train_step import init_train_state, train_step
    from repro_torch.models import lm
    from repro_torch.utils import tree_flatten, value_and_grad
    cfg = get_config("paper-lm-100m")
    base = MAIN_ARGS + ["--gamma", "0.01"]
    perleaf = ["--transport", "perleaf", "--value-bits", "8"] + ADAPTIVE_ARGS

    def checked_run(label, extra, steps, want=None, skips=0):
        """``steps`` steps of ``base + extra``; fails on launches other
        than ``want`` when given, or ``skips`` (None: any) skipped
        steps."""
        torch.cuda.reset_peak_memory_stats(dev)
        live = torch.cuda.memory_allocated(dev)
        ops.reset_launch_counts()
        log, params, state = train.run(base + extra + ["--steps",
                                                       str(steps)])
        torch.cuda.synchronize(dev)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) - live
        print(f"faults [{label}]: launches {counts}; step_s "
              f"{[round(x['step_s'], 4) for x in log]}; losses "
              f"{[x['loss'] for x in log]}; rows_quarantined "
              f"{[x['rows_quarantined'] for x in log]}; skipped "
              f"{[x['steps_skipped'] for x in log]}; peak memory "
              f"{peak / 2**30:.2f} GiB above the {live / 2**30:.2f} GiB "
              "live before the run", flush=True)
        if len(log) != steps or (skips is not None
                                 and log[-1]["steps_skipped"] != skips):
            fail(f"[faults {label}] {log[-1]['steps_skipped']} skipped "
                 f"steps, want {skips}")
        if want is not None and counts != want:
            fail(f"[faults {label}] launches {counts}, want {want}")
        return log, params, state, counts

    def same(label, a, b, keys=("wire_bytes", "effective_wire_bytes",
                                "gamma", "loss")):
        if not trees_equal(a[1], b[1]) or not trees_equal(a[2].memory,
                                                          b[2].memory):
            fail(f"[faults {label}] parameters or EF memory differ")
        for k in keys:
            if [x[k] for x in a[0]] != [x[k] for x in b[0]]:
                fail(f"[faults {label}] {k} {[x[k] for x in a[0]]} != "
                     f"{[x[k] for x in b[0]]}")

    # ---- (a) the verdicts on a clean wire: guarded == unguarded ---------
    times = {}
    for label, extra in (("bucketed 32-bit", []),
                         ("bucketed 8-bit", ["--value-bits", "8"]),
                         ("perleaf 10% budget", perleaf)):
        g = checked_run(f"{label}, guarded", extra, FAULT_STEPS)
        with faults.guards_disabled():
            u = checked_run(f"{label}, unguarded", extra, FAULT_STEPS,
                            want=g[3])
        same(f"{label} guarded vs unguarded", g, u)
        if any(x["rows_quarantined"] for x in g[0]):
            fail(f"[faults {label}] a clean wire quarantined rows")
        times[label] = ([x["step_s"] for x in g[0][1:]],
                        [x["step_s"] for x in u[0][1:]])
        print(f"faults [{label}]: guarded == unguarded bit for bit after "
              f"{FAULT_STEPS} steps (parameters, EF memory, bytes, gamma_t, "
              f"losses) with the same launches {g[3]}", flush=True)
        del g, u

    # the exchange alone, guarded and unguarded in turns, from one state
    run = RunConfig(model=cfg, shape=ShapeConfig(256, 8),
                    optimizer=OptimizerConfig(compressor=Compressor(
                        gamma=0.01, method="block_topk")))
    created = init_process_group(dev)
    try:
        params = lm.init_params(cfg, seed=0, device=dev)
        state = init_train_state(params, run)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=256,
                             global_batch=8)
        batch = {k: v.to(dev) for k, v in pipe.batch(0).items()}
        params, state, _ = train_step(params, state, batch, run)
        batch = {k: v.to(dev) for k, v in pipe.batch(1).items()}
        _, grads = value_and_grad(lambda p: lm.loss_fn(p, batch, cfg),
                                  params)
        smask = lm.stacked_mask(params)
        comp = run.optimizer.compressor

        def exchange():
            return worker_compress_aggregate(grads, state.memory, 0.0345,
                                             comp, stacked_mask=smask)

        def unguarded():
            with faults.guards_disabled():
                return exchange()
        def step():
            return train_step(params, state, batch, run)

        def step_unguarded():
            with faults.guards_disabled():
                return step()
        ex = {k: [] for k in ("guarded", "unguarded", "step guarded",
                              "step unguarded")}
        for _ in range(2):
            exchange(), unguarded(), step(), step_unguarded()
        for _ in range(FAULT_REPS):
            for name, fn in (("guarded", exchange),
                             ("unguarded", unguarded),
                             ("step unguarded", step_unguarded),
                             ("step guarded", step)):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize(dev)
                ex[name].append((time.perf_counter() - t0) * 1e3)
        dev_ms = {name: device_ms(fn) for name, fn in
                  (("guarded", exchange), ("unguarded", unguarded))}
    finally:
        if created:
            torch.distributed.destroy_process_group()
    del params, state, grads, batch
    med = {k: statistics.median(v) for k, v in ex.items()}
    ex = {k: [round(x, 3) for x in v] for k, v in ex.items()}
    for label, (gt, ut) in times.items():
        print(f"faults warm step_s [{label}]: guarded {gt}, unguarded {ut}; "
              f"ratio of means {statistics.mean(gt) / statistics.mean(ut):.4f}",
              flush=True)
    print(f"faults [exchange alone, bucketed 32-bit, {FAULT_REPS} in turns]: "
          f"guarded median {med['guarded']:.3f} ms, unguarded "
          f"{med['unguarded']:.3f} ms, ratio "
          f"{med['guarded'] / med['unguarded']:.4f}; device only "
          f"{dev_ms['guarded']:.3f} vs {dev_ms['unguarded']:.3f} ms, ratio "
          f"{dev_ms['guarded'] / dev_ms['unguarded']:.4f}; each run (ms) "
          f"{ex['guarded']} / {ex['unguarded']}", flush=True)
    print(f"faults [train_step, bucketed 32-bit, {FAULT_REPS} in turns from "
          f"one state]: guarded median {med['step guarded']:.3f} ms, "
          f"unguarded {med['step unguarded']:.3f} ms, ratio "
          f"{med['step guarded'] / med['step unguarded']:.4f}; each run "
          f"(ms) {ex['step guarded']} / {ex['step unguarded']}", flush=True)
    summary = {
        "exchange_ms": [round(med["guarded"], 3),
                        round(med["unguarded"], 3)],
        "exchange_ratio": round(med["guarded"] / med["unguarded"], 4),
        "exchange_device_ms": [round(dev_ms["guarded"], 3),
                               round(dev_ms["unguarded"], 3)],
        "step_ms": [round(med["step guarded"], 3),
                    round(med["step unguarded"], 3)],
        "step_ratio": round(med["step guarded"] / med["step unguarded"], 4),
        "warm_step_ratio_of_means": {
            label: round(statistics.mean(gt) / statistics.mean(ut), 4)
            for label, (gt, ut) in times.items()}}

    # ---- the means at W = 3 on the card: a synthetic gathered decode ----
    # guarded, a true division by the valid-row count; unguarded, the
    # product with f32(1/3) jitted XLA computes for the static W.  Each
    # row's indices are its own, so the sums are exact and only the
    # division rounds.
    from repro_torch.core.dcsgd import _consume_decoded_leaf
    L, d, k = 4, 3 * 4096, 4096
    gen = torch.Generator().manual_seed(3)
    vals = torch.randn((3, L, k), generator=gen)
    idx = (torch.arange(k)[None, None, :] * 3
           + torch.arange(3)[:, None, None]).expand(3, L, k).to(torch.int32)
    acc = torch.randn((L, d), generator=gen)
    total = torch.zeros((L, d))
    total.view(L, k, 3).copy_(vals.permute(1, 2, 0))
    want = {True: total / torch.full((L, 1), 3.0),
            False: total * float(np.float32(1.0) / np.float32(3.0))}
    for guarded in (True, False):
        out = _consume_decoded_leaf(
            acc.to(dev), acc.to(dev), acc.to(dev), vals.to(dev),
            idx.to(dev), L, d, 3, 0, False, None, None, acc.to(dev),
            verdict=torch.ones((3, L), dtype=torch.bool, device=dev)
            if guarded else None)
        if not bits_equal(out[0].cpu(), want[guarded]):
            fail(f"[faults W=3 mean, guarded={guarded}] the card's mean is "
                 "not the CPU's "
                 + ("true division" if guarded else "reciprocal product"))
    parted = int((want[True] != want[False]).sum())
    if not parted:
        fail("[faults W=3 mean] the division and the product never part")
    print(f"faults [W = 3 mean on the card]: guarded == the true division "
          f"by 3, unguarded == the product with f32(1/3), bit for bit; the "
          f"two part in {parted} of {L * d} entries", flush=True)
    summary["w3_mean_parted"] = [parted, L * d]

    # ---- (b) a NaN round: every compressed row quarantined --------------
    burst = ["--fault-nonfinite", "1.0", "--fault-start-step", "1",
             "--fault-steps", "1"]
    clean = checked_run("clean, 1 step", [], 1)
    nan = checked_run("nonfinite at step 1", burst, 2, want={
        k: 2 * v for k, v in clean[3].items()})
    leaves = tree_flatten(nan[1])[0]
    plan = build_bucket_plan([p.shape for p in leaves],
                             tree_flatten(lm.stacked_mask(nan[1]))[0],
                             Compressor(gamma=0.01, method="block_topk"))
    rows = sum(ln.L for ln in plan.leaves if not ln.dense)
    before = tree_flatten(clean[2].memory)[0]
    after = tree_flatten(nan[2].memory)[0]
    if nan[0][0] != {**clean[0][0], "step_s": nan[0][0]["step_s"]}:
        fail(f"[faults nonfinite] step 0 {nan[0][0]} differs from the "
             f"clean run's {clean[0][0]}")
    if [x["rows_quarantined"] for x in nan[0]] != [0.0, float(rows)]:
        fail(f"[faults nonfinite] rows_quarantined "
             f"{[x['rows_quarantined'] for x in nan[0]]}, want 0 then "
             f"{rows}")
    frozen = [ln.index for ln in plan.leaves if not ln.dense
              and not bits_equal(after[ln.index], before[ln.index])]
    if frozen or not all(bool(torch.isfinite(p).all()) for p in leaves):
        fail(f"[faults nonfinite] EF memory of compressed leaves {frozen} "
             "moved, or a parameter is not finite")
    print(f"faults [nonfinite at step 1]: step 0 the clean run's; step 1 "
          f"quarantined {rows} rows (all compressed), kept the EF memory "
          f"of {len(plan.compressed_ids)} compressed leaves bit for bit, "
          f"0 skips, finite parameters", flush=True)
    del clean, nan, leaves, before, after

    # ---- (c) bitflip and count faults through the ragged CUDA codec ------
    recs = []
    real_corrupt, real_decode = faults.maybe_corrupt, wire.decode_rows

    def rec_corrupt(rows_in, spec, lane, rpw):
        out = real_corrupt(rows_in, spec, lane, rpw)
        st = faults._ACTIVE[-1]
        recs.append(dict(rows=rows_in.clone(), out=out.clone(), spec=spec,
                         lane=lane, rpw=rpw, cfg=st.cfg, step=st.step))
        return out

    def rec_decode(payload, spec):
        vals, idx = real_decode(payload, spec)
        if recs and recs[-1]["spec"] == spec and "vals" not in recs[-1]:
            recs[-1].update(vals=vals.clone(), idx=idx.clone())
        return vals, idx
    hostile = ["--fault-bitflip", "1.0", "--fault-count", "1.0",
               "--fault-seed", "11"]
    ok = checked_run("perleaf clean", perleaf, 2)
    for label, extra, skips in (("guarded", [], 0),
                                ("--no-quarantine", ["--no-quarantine"],
                                 None)):
        recs.clear()
        faults.maybe_corrupt, wire.decode_rows = rec_corrupt, rec_decode
        try:
            got = checked_run(f"perleaf bitflip+count, {label}",
                              perleaf + hostile + extra, 2, want=ok[3],
                              skips=skips)
        finally:
            faults.maybe_corrupt, wire.decode_rows = real_corrupt, \
                real_decode
        n_bad = n_rows = 0
        for r in recs:
            with faults.active_faults(r["cfg"], r["step"]):
                cpu_out = faults.maybe_corrupt(r["rows"].cpu(), r["spec"],
                                               r["lane"], r["rpw"])
            cv, ci = wire.decode_rows(cpu_out, r["spec"])
            gv, gi = r["vals"].cpu(), r["idx"].cpu()
            same_v = (gv.view(torch.int32) == cv.view(torch.int32)) | (
                torch.isnan(gv) & torch.isnan(cv))
            if not (torch.equal(r["out"].cpu(), cpu_out) and bool(
                    same_v.all()) and torch.equal(gi, ci)):
                fail(f"[faults {label}] lane {r['lane']} step {r['step']}: "
                     "the card's corrupted rows or their decode differ "
                     "from the CPU port's")
            counts = cpu_out[:, 0]
            bad = (counts < 0) | (counts > r["spec"].full_count)
            n_bad += int(bad.sum())
            n_rows += counts.numel()
            # a count read as -1 masks every field: the row decodes to 0
            if bool((gv[counts < 0] != 0).any()):
                fail(f"[faults {label}] a row whose count reads -1 decoded "
                     "a live value in the CUDA ragged unpack")
        if not recs or not n_bad:
            fail(f"[faults {label}] no corrupted count reached the decode")
        q = [x["rows_quarantined"] for x in got[0]]
        if (label == "guarded") != bool(q[-1]):
            fail(f"[faults {label}] rows_quarantined {q}")
        print(f"faults [perleaf bitflip+count, {label}]: {len(recs)} leaf "
              f"decodes, {n_bad} of {n_rows} rows with a corrupted count "
              f"(-1: every field masked, or 2*full+7: every field "
              f"unmasked), each corrupted row and its decode (values, "
              f"indices) equal to the CPU port's, no device assert; "
              f"rows_quarantined {q}, skipped "
              f"{[x['steps_skipped'] for x in got[0]]}", flush=True)
        del got
    recs.clear()
    del ok

    # ---- (d) the wrapper outside its burst: the inner transport ---------
    quiet = ["--fault-bitflip", "1.0", "--fault-nonfinite", "1.0",
             "--fault-start-step", "100"]
    for label, extra in (("overlap delay 1", ["--transport", "overlap"]),
                         ("gossip", ["--transport", "gossip"])):
        a = checked_run(label, extra, 2)
        b = checked_run(f"faulty({label}), outside the burst",
                        extra + quiet, 2, want=a[3])
        same(f"faulty({label})", a, b)
        carried = (a[2].overlap, b[2].overlap) if a[2].overlap is not None \
            else (a[2].gossip, b[2].gossip)
        if not all(bits_equal(x, y) for x, y in zip(
                tree_flatten(vars(carried[0]))[0],
                tree_flatten(vars(carried[1]))[0])
                if isinstance(x, torch.Tensor)):
            fail(f"[faults {label}] the carried state differs")
        print(f"faults [faulty({label}) outside the burst]: bit for bit "
              f"its inner transport (parameters, EF memory, carried "
              f"state, bytes, losses), launches {a[3]}", flush=True)
        del a, b

    # ---- (e) a checkpoint inside a burst, resumed -----------------------
    mid = ["--value-bits", "8", "--fault-bitflip", "0.5",
           "--fault-nonfinite", "0.2", "--fault-start-step", "1",
           "--fault-steps", "3"]
    tmp = root / "_smoke_ckpt"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        d = str(tmp / "faults")
        straight = checked_run("burst, 4 steps", mid, 4)
        checked_run("burst, 2 steps, saved", mid + [
            "--ckpt-dir", d, "--ckpt-every", "2"], 2)
        log, params, state = train.run(base + mid + [
            "--steps", "4", "--ckpt-dir", d, "--resume"])
        keys = ("loss", "rows_quarantined", "steps_skipped")
        if [x["step"] for x in log] != [2, 3] or not trees_equal(
                params, straight[1]) or not trees_equal(
                    state.memory, straight[2].memory) or [
                [x[k] for k in keys] for x in log] != [
                [x[k] for k in keys] for x in straight[0][2:]] \
                or state.health != straight[2].health:
            fail("[faults checkpoint] a resume inside the burst differs "
                 "from 4 uninterrupted steps")
        print(f"faults [checkpoint]: resumed at step 2 of a 3-step burst, "
              f"bit for bit with 4 straight steps (parameters, EF memory, "
              f"losses, rows_quarantined "
              f"{[x['rows_quarantined'] for x in straight[0]]}, health)",
              flush=True)
        del straight, params, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return summary


def cohort_launches(plan, value_bits: int, clients: int) -> dict:
    """Each kernel's launches in one cohort round: one EF launch pair and
    one encode a client (a pack launch per bucket field section below 32
    bits), one decode of every gathered row (an unpack launch per
    section)."""
    sections = sum((b.index_bits < 32) + (value_bits < 32)
                   for b in plan.buckets)
    return dict(ef_stats_telemetry=clients, ef_apply=clients,
                pack_words=clients * sections, unpack_words=sections)


def cohort_trainer(dev, root: Path) -> dict:
    """Phase 4l: the federated cohort at full width through
    ``launch.train --n-clients 4`` on one worker, the launch counts set to
    0 just before each run and read just after: 3 rounds at 32 and at 8
    bits with each round's exact launches of the four training kernels;
    the cohort exchange from one state through the kernels and through
    their plain versions on the card (``dispatch`` sent to ``ref``), the
    gathered payload, the updates and every client's EF memory bit for
    bit, the non-participant's memory unchanged; ``support`` == ``mean``
    at a full budget with 32-bit values; a NaN round on client 1's rows,
    quarantined, its memory frozen; a cohort checkpoint resumed bit for
    bit.  Returns the runs' step times, launches and bytes."""
    import shutil

    from repro_torch.comm.bucket import build_bucket_plan
    from repro_torch.comm.exchange import init_process_group
    from repro_torch.configs import get_config
    from repro_torch.core.compression import Compressor
    from repro_torch.fed import clients as fed_clients
    from repro_torch.fed.sampling import participation_mask
    from repro_torch.kernels import dispatch, ops
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.utils import tree_flatten, tree_map, value_and_grad
    cfg = get_config("paper-lm-100m")
    base = MAIN_ARGS + COHORT_ARGS
    params0 = lm.init_params(cfg, seed=0, device=dev)
    leaves = tree_flatten(params0)[0]
    shapes = [tuple(p.shape) for p in leaves]
    stacked = tree_flatten(lm.stacked_mask(params0))[0]
    smask = lm.stacked_mask(params0)
    plans = {bits: build_bucket_plan(shapes, stacked, Compressor(
        gamma=0.04, max_gamma=0.1, method="block_topk", value_bits=bits))
        for bits in (32, 8)}
    plan = plans[32]
    n_rows = sum(ln.L for ln in plan.leaves if not ln.dense)

    def checked_run(label, extra, steps, want=None, first=0, bits=32):
        """Rounds ``first`` ... ``steps`` - 1 of ``base + extra`` (at
        ``bits``-bit values), each round's state recorded; fails on a
        non-finite loss, a skipped round, participants other than 3,
        bytes other than 3 clients', or launches other than ``want``
        (per round) when given."""
        # 3 participants' bytes, priced in f32 as JAX prices them
        want_wire = float(np.float32(3.0) * np.float32(
            fed_clients.per_client_wire_bytes(plans[bits])))
        torch.cuda.reset_peak_memory_stats(dev)
        live = torch.cuda.memory_allocated(dev)
        states = []
        real = train.train_step

        def recording(*a, **k):
            out = real(*a, **k)
            states.append(out[1])
            return out
        train.train_step = recording
        try:
            ops.reset_launch_counts()
            log, params, state = train.run(base + extra + ["--steps",
                                                           str(steps)])
            torch.cuda.synchronize(dev)
            counts = ops.launch_counts()
        finally:
            train.train_step = real
        peak = torch.cuda.max_memory_allocated(dev) - live
        byte_pairs = [(x["wire_bytes"], x["effective_wire_bytes"])
                      for x in log]
        print(f"cohort [{label}]: launches {counts}; step_s "
              f"{[round(x['step_s'], 4) for x in log]}; participants "
              f"{[x['participants'] for x in log]}; (static, effective) "
              f"bytes {byte_pairs}; losses {[x['loss'] for x in log]}; "
              f"gamma {[x['gamma'] for x in log]}; alpha "
              f"{[x['alpha'] for x in log]}; rows_quarantined "
              f"{[x['rows_quarantined'] for x in log]}; peak memory "
              f"{peak / 2**30:.2f} GiB above the {live / 2**30:.2f} GiB "
              "live before the run", flush=True)
        n = steps - first
        if len(log) != n or not all(np.isfinite(x["loss"]) for x in log) \
                or any(x["steps_skipped"] for x in log) \
                or any(x["participants"] != 3.0 for x in log):
            fail(f"[cohort {label}] non-finite loss, a skipped round or "
                 f"participants other than 3: {log}")
        if any(x["wire_bytes"] != want_wire
               or not 0 < x["effective_wire_bytes"] <= x["wire_bytes"]
               for x in log):
            fail(f"[cohort {label}] bytes {log}: want {want_wire} B "
                 "static, effective in (0, static]")
        if want is not None:
            full = {k: 0 for k in counts}
            full.update({k: v * n for k, v in want.items()})
            if counts != full:
                fail(f"[cohort {label}] launches {counts}, want {full}")
        return log, params, state, counts, peak, states

    summary = {}
    for bits in (32, 8):
        want = cohort_launches(plans[bits], bits, COHORT_CLIENTS)
        log, params, state, counts, peak, _ = checked_run(
            f"{bits}-bit", ["--value-bits", str(bits)], COHORT_ROUNDS,
            want=want, bits=bits)
        if tree_flatten(state.fed.memory)[0][0].device != dev:
            fail("[cohort] the clients' EF memory is not on the card")
        summary[f"{bits}-bit"] = dict(
            step_s=[x["step_s"] for x in log], launches_a_round=want,
            wire=[x["wire_bytes"] for x in log],
            effective=[x["effective_wire_bytes"] for x in log],
            peak_gib=peak / 2**30)
        del log, params, state

    # ---- the exchange through the kernels and through the plain route --
    created = init_process_group(dev)
    try:
        mask = participation_mask(COHORT_CLIENTS, 0, mode="fixed",
                                  clients_per_round=3)
        idle = int(np.flatnonzero(mask == 0)[0])
        tokens = torch.randint(0, cfg.vocab_size, (COHORT_CLIENTS, 2, 256),
                               generator=torch.Generator().manual_seed(3)
                               ).to(dev)
        grads = None
        for c in range(COHORT_CLIENTS):
            _, g = value_and_grad(lambda p: lm.loss_fn(
                p, {"tokens": tokens[c]}, cfg), params0)
            if grads is None:
                grads = tree_map(lambda x: torch.empty(
                    (COHORT_CLIENTS,) + tuple(x.shape), device=dev), g)
            tree_map(lambda b, x: b[c].copy_(x), grads, g)
            del g
        gen = torch.Generator(device=dev).manual_seed(5)
        memory = tree_map(lambda x: 1e-3 * torch.randn(
            x.shape, generator=gen, device=dev), grads)
        eta = np.array([0.03, 0.05, 0.02, 0.04], np.float32)
        gamma = np.array([0.04, 0.07, 0.1, 0.055], np.float32)
        real_decode = fed_clients.decode_guarded
        real_resolve = dispatch.resolve

        def exchange(bits, plain):
            """One cohort exchange: (gathered payload, updates, memory,
            wire, eff, quarantined) and the launches it made."""
            got = []

            def capture(plan_, pay):
                got.append(pay.clone())
                return real_decode(plan_, pay)
            fed_clients.decode_guarded = capture
            if plain:
                dispatch.resolve = lambda x: "ref"
            try:
                ops.reset_launch_counts()
                out = fed_clients.cohort_compress_aggregate(
                    grads, memory, eta, Compressor(
                        gamma=0.04, max_gamma=0.1, method="block_topk",
                        value_bits=bits), None, mask, gamma,
                    stacked_mask=smask, return_quarantined=True)
                torch.cuda.synchronize(dev)
                return (got[0],) + out, ops.launch_counts()
            finally:
                fed_clients.decode_guarded = real_decode
                dispatch.resolve = real_resolve

        for bits in (32, 8):
            (pay, upd, mem, wire, eff, quar), counts = exchange(bits, False)
            (ppay, pupd, pmem, pwire, peff, pquar), pcounts = exchange(
                bits, True)
            want = {k: 0 for k in counts}
            want.update(cohort_launches(plans[bits], bits, COHORT_CLIENTS))
            if counts != want or any(pcounts.values()):
                fail(f"[cohort exchange {bits}-bit] launches {counts} "
                     f"(want {want}), plain route {pcounts} (want none)")
            if not (bits_equal(pay, ppay) and trees_equal(upd, pupd)
                    and trees_equal(mem, pmem) and wire == pwire
                    and bits_equal(eff, peff) and bits_equal(quar, pquar)):
                fail(f"[cohort exchange {bits}-bit] the kernel route "
                     "differs from the plain route on the card")
            if not all(bits_equal(a[idle], b[idle]) for a, b in zip(
                    tree_flatten(mem)[0], tree_flatten(memory)[0])):
                fail(f"[cohort exchange {bits}-bit] the non-participant's "
                     "EF memory moved")
            print(f"cohort [exchange {bits}-bit]: kernels == plain route "
                  f"on the card bit for bit (payload {tuple(pay.shape)} "
                  f"words, updates, all {COHORT_CLIENTS} clients' EF "
                  f"memory; wire {float(wire)} B, effective {float(eff)} "
                  f"B); client {idle} sits out, its memory unchanged; "
                  f"launches {counts}", flush=True)
            del pay, upd, mem, ppay, pupd, pmem

        # support == mean where every participant sends every coordinate
        full = Compressor(gamma=1.0, method="block_topk")
        rnd = tree_map(lambda x: torch.randn(x.shape, generator=gen,
                                             device=dev), grads)
        zero = tree_map(torch.zeros_like, grads)
        outs = [fed_clients.cohort_compress_aggregate(
            rnd, zero, eta, full, None, mask, stacked_mask=smask,
            aggregation=agg) for agg in ("support", "mean")]
        if not (trees_equal(outs[0][0], outs[1][0])
                and trees_equal(outs[0][1], outs[1][1])):
            fail("[cohort] support != mean at a full budget with 32-bit "
                 "values")
        print("cohort [full budget, 32-bit]: support == mean bit for bit "
              "(updates and every client's EF memory)", flush=True)
        del grads, memory, rnd, zero, outs
    finally:
        if created:
            torch.distributed.destroy_process_group()
    del params0, leaves

    # ---- a NaN round on client 1's rows ---------------------------------
    nan = ["--fault-nonfinite", "1.0", "--fault-worker", "1",
           "--fault-start-step", "1", "--fault-steps", "1"]
    log, _, _, _, _, states = checked_run("NaN round on client 1", nan,
                                          COHORT_ROUNDS)
    if participation_mask(COHORT_CLIENTS, 1, mode="fixed",
                          clients_per_round=3)[1] != 1.0:
        fail("[cohort NaN] client 1 sits out round 1: nothing to freeze")
    quar = [x["rows_quarantined"] for x in log]
    if quar != [0.0, float(n_rows), float(n_rows)]:
        fail(f"[cohort NaN] rows_quarantined {quar}, want [0, {n_rows}, "
             f"{n_rows}]")
    before, after = states[0].fed.memory, states[1].fed.memory
    comp_leaves = [i for i, ln in enumerate(plan.leaves) if not ln.dense]
    fb, fa = tree_flatten(before)[0], tree_flatten(after)[0]
    if not all(bits_equal(fb[i][1], fa[i][1]) for i in comp_leaves):
        fail("[cohort NaN] client 1's EF memory moved in the round its "
             "rows were quarantined")
    if all(bits_equal(fb[i][0], fa[i][0]) for i in comp_leaves):
        fail("[cohort NaN] client 0's EF memory did not move")
    print(f"cohort [NaN round on client 1]: {n_rows} rows quarantined in "
          f"round 1, client 1's EF memory frozen bit for bit, client 0's "
          f"moved, no skip", flush=True)
    del states

    # ---- a cohort checkpoint, resumed -----------------------------------
    tmp = root / "_smoke_ckpt"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        d = str(tmp / "cohort")
        straight = checked_run("4 rounds", [], 4)
        checked_run("2 rounds, saved", ["--ckpt-dir", d, "--ckpt-every",
                                        "2"], 2)
        log, params, state, _, _, _ = checked_run(
            "resumed to 4", ["--ckpt-dir", d, "--resume"], 4, first=2)
        s = straight[2].fed
        if [x["step"] for x in log] != [2, 3] or not trees_equal(
                params, straight[1]) or not trees_equal(
                    state.fed.memory, s.memory) or not all(
                bits_equal(getattr(state.fed, f), getattr(s, f))
                for f in ("gamma", "rounds", "alpha")):
            fail("[cohort checkpoint] a resume from round 2 to 4 differs "
                 "from 4 uninterrupted rounds")
        print("cohort [checkpoint]: resumed from round 2 to 4 bit for bit "
              "with 4 straight rounds (parameters, every client's EF "
              "memory, gamma, rounds, alpha)", flush=True)
        summary["4 rounds"] = dict(step_s=[x["step_s"]
                                           for x in straight[0]])
        del straight, params, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return summary


def profile_cohort(dev, cfg) -> None:
    """Phase 4l: one warm full-width cohort round under torch.profiler,
    as in 4b, beside a bucketed step at the same batch, compressor and
    first gamma_t: device busy time, idle share, the kernels under their
    own names and the peak memory above what was live before each."""
    from repro_torch.comm.exchange import init_process_group
    from repro_torch.configs.base import FederatedConfig, OptimizerConfig, \
        RunConfig, ShapeConfig
    from repro_torch.core.compression import Compressor
    from repro_torch.core.gamma import GammaControllerConfig
    from repro_torch.launch.train import batch_source
    from repro_torch.launch.train_step import init_train_state, train_step
    from repro_torch.models import lm
    comp = Compressor(gamma=0.04, max_gamma=0.1, method="block_topk")
    ctrl = GammaControllerConfig(schedule="linear", ramp_steps=2)
    for label, fed in (("bucketed", FederatedConfig()),
                       ("cohort of 4, 3 a round", FederatedConfig(
                           n_clients=4, clients_per_round=3,
                           dirichlet_alpha=0.5))):
        run = RunConfig(model=cfg, shape=ShapeConfig(256, 8),
                        optimizer=OptimizerConfig(
                            compressor=comp, gamma_controller=ctrl,
                            federated=fed))
        torch.cuda.reset_peak_memory_stats(dev)
        live = torch.cuda.memory_allocated(dev)
        created = init_process_group(dev)
        try:
            params = lm.init_params(cfg, seed=0, device=dev)
            state = init_train_state(params, run)
            make = batch_source(run, 1, 0, dev)
            for step in range(2):
                params, state, _ = train_step(params, state, make(step),
                                              run)
            batch = make(2)
            prof, wall_ms = profiled(
                dev, lambda: train_step(params, state, batch, run))
        finally:
            if created:
                torch.distributed.destroy_process_group()
        peak = torch.cuda.max_memory_allocated(dev) - live
        spans = report_profile(f"trainer {label}", prof, wall_ms,
                               ("ef_stats_telemetry_kernel",
                                "ef_apply_kernel", "pack_words_kernel",
                                "unpack_words_kernel"))
        if len(spans) != 4 or min(spans.values()) <= 0:
            fail(f"the profiler saw {label} train_step spans {spans}, "
                 "want 4 timed")
        print(f"  peak memory {peak / 2**30:.2f} GiB above the "
              f"{live / 2**30:.2f} GiB live before the run", flush=True)
        del params, state, prof


def exchange_collectives(prof) -> list[str]:
    """Names of the collective calls and NCCL kernels that the profile
    shows inside the ``train_step.exchange`` span."""
    cpu = torch.autograd.DeviceType.CPU
    evs = list(prof.events())
    spans = [e for e in evs if e.name == "train_step.exchange"
             and e.device_type == cpu]
    if len(spans) != 1:
        fail(f"the profile has {len(spans)} train_step.exchange spans")
    lo, hi = spans[0].time_range.start, spans[0].time_range.end
    names = []
    for e in evs:
        if e.device_type != cpu or not (lo <= e.time_range.start
                                        and e.time_range.end <= hi):
            continue
        low = e.name.lower()
        if "nccl" in low or "c10d" in low or "all_reduce" in low \
                or "allreduce" in low or "all_gather" in low \
                or "allgather" in low:
            names.append(e.name)
        names += [k.name for k in getattr(e, "kernels", ())
                  if "nccl" in k.name.lower()]
    return names


def profile_gossip(dev, cfg, comp) -> None:
    """Phase 4j: one warm full-width gossip step under torch.profiler, as
    in 4b, beside a bucketed one: the exchange span of gossip shows no
    collective and no NCCL kernel, bucketed's shows its all-gather and
    all-reduce (the check's control); the peak device memory above what
    was live before the run."""
    from repro_torch.comm.exchange import init_process_group
    from repro_torch.configs.base import OptimizerConfig, RunConfig, \
        ShapeConfig
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch.train_step import init_train_state, train_step
    from repro_torch.models import lm
    for transport in ("bucketed", "gossip"):
        run = RunConfig(model=cfg, shape=ShapeConfig(256, 8),
                        optimizer=OptimizerConfig(compressor=comp,
                                                  transport=transport))
        torch.cuda.reset_peak_memory_stats(dev)
        live = torch.cuda.memory_allocated(dev)
        created = init_process_group(dev)
        try:
            params = lm.init_params(cfg, seed=0, device=dev)
            state = init_train_state(params, run)
            pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=256,
                                 global_batch=8)
            for step in range(2):
                batch = {k: v.to(dev) for k, v in pipe.batch(step).items()}
                params, state, _ = train_step(params, state, batch, run)
            batch = {k: v.to(dev) for k, v in pipe.batch(2).items()}
            prof, wall_ms = profiled(
                dev, lambda: train_step(params, state, batch, run))
        finally:
            if created:
                torch.distributed.destroy_process_group()
        peak = torch.cuda.max_memory_allocated(dev) - live
        label = f"trainer {transport}, one worker"
        spans = report_profile(label, prof, wall_ms,
                               ("ef_stats_telemetry_kernel",
                                "ef_apply_kernel", "pack_words_kernel",
                                "unpack_words_kernel"))
        if len(spans) != 4 or min(spans.values()) <= 0:
            fail(f"the profiler saw {label} train_step spans {spans}, "
                 "want 4 timed")
        coll = exchange_collectives(prof)
        print(f"  exchange span collectives: {sorted(set(coll))}; peak "
              f"memory {peak / 2**30:.2f} GiB above the "
              f"{live / 2**30:.2f} GiB live before the run", flush=True)
        if transport == "gossip" and coll:
            fail(f"[gossip profile] the exchange span shows collectives "
                 f"{sorted(set(coll))}")
        if transport == "bucketed" and not coll:
            fail("[gossip profile] the control failed: bucketed's "
                 "exchange span shows no collective")
        del params, state, prof


def run_single(dev, cfg, comp, steps, label, make_opt) -> dict:
    """Phases 4c and 4h: a single-node optimizer (``make_opt(compressor)``
    -> CSGD-ASSS or ACGD) on the full-width model through the library
    entry point; returns the launch counts of the run."""
    from repro_torch.core.compression import Compressor, tree_wire_bytes
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.utils import tree_leaves
    seen = {}

    class Recording(Compressor):
        """Keeps the (acc, sent, residual) of the largest leaf, so the EF
        identity is checked on what the optimizer really passed."""

        def compress_dense(self, x, gamma_t=None):
            sent, resid = super().compress_dense(x, gamma_t)
            if x.numel() >= seen.get("n", 0):
                seen.update(n=x.numel(), x=x, sent=sent, resid=resid)
            return sent, resid

    params = lm.init_params(cfg, seed=0, device=dev)
    n_leaves = sum(p.numel() >= comp.min_compress_size
                   for p in tree_leaves(params))
    want_bytes = float(tree_wire_bytes(params, comp))
    opt = make_opt(Recording(gamma=comp.gamma, method=comp.method))
    state = opt.init(params)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=256,
                         global_batch=8)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    log = []
    for step in range(steps):
        batch = {k: v.to(dev) for k, v in pipe.batch(step).items()}
        t0 = time.perf_counter()
        params, state, aux = opt.step(
            lambda p, b=batch: lm.loss_fn(p, b, cfg), params, state)
        loss = float(aux.loss)
        torch.cuda.synchronize(dev)
        log.append(dict(step_s=time.perf_counter() - t0, loss=loss,
                        alpha=float(getattr(aux, "alpha", aux.eta)),
                        n_evals=getattr(aux, "n_evals", 0),
                        wire_bytes=float(aux.wire_bytes)))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"{label}: launches {counts}; step_s "
          f"{[round(x['step_s'], 4) for x in log]}; losses "
          f"{[x['loss'] for x in log]}; alpha {[x['alpha'] for x in log]}; "
          f"n_evals {[x['n_evals'] for x in log]}; wire bytes "
          f"{log[0]['wire_bytes']} (want {want_bytes}); peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    for name, n in counts.items():
        want = n_leaves * steps if name in ("block_stats",
                                            "threshold_split") else 0
        if n != want:
            fail(f"[{label}] {name} launched {n} times in {steps} steps "
                 f"over {n_leaves} compressed leaves, want {want}")
    if not all(np.isfinite(x["loss"]) for x in log):
        fail(f"[{label}] non-finite loss: {[x['loss'] for x in log]}")
    if any(x["wire_bytes"] != want_bytes for x in log):
        fail(f"[{label}] wire bytes {[x['wire_bytes'] for x in log]} != "
             f"accounted {want_bytes}")
    if not torch.equal(seen["sent"] + seen["resid"], seen["x"]):
        fail(f"[{label}] sent + residual != acc on the largest leaf")
    print(f"{label}: EF identity exact on a {seen['n']}-element leaf; "
          f"{int((seen['sent'] != 0).sum())} entries sent", flush=True)
    seen.clear()
    batch = {k: v.to(dev) for k, v in pipe.batch(steps).items()}
    report_profile(label, *profiled(dev, lambda: opt.step(
        lambda p: lm.loss_fn(p, batch, cfg), params, state)),
        ("block_stats_kernel", "threshold_split_kernel"))
    return counts


def csgd_smoke(dev, steps: int = 3) -> None:
    """Phase 5b: CSGD-ASSS on the 2-layer variant, the card against the
    CPU's plain versions from the same weights and batches."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.compression import Compressor
    from repro_torch.core.csgd import CSGDConfig, csgd_asss
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.models import lm
    cfg = get_smoke_config("paper-lm-100m")
    runs = []
    for d in (dev, torch.device("cpu")):
        params = lm.init_params(cfg, seed=0, device=d)
        opt = csgd_asss(CSGDConfig(compressor=Compressor(
            gamma=0.01, method="block_topk")))
        state = opt.init(params)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=33,
                             global_batch=4)
        out = []
        for step in range(steps):
            batch = {k: v.to(d) for k, v in pipe.batch(step).items()}
            params, state, aux = opt.step(
                lambda p, b=batch: lm.loss_fn(p, b, cfg), params, state)
            out.append((float(aux.loss), float(aux.alpha), aux.n_evals))
        runs.append(out)
    for (lc, ac, nc), (lh, ah, nh) in zip(*runs):
        if abs(lc - lh) > 1e-4 * abs(lh) or ac != ah or nc != nh:
            fail(f"csgd smoke on the card {runs[0]} disagrees with the "
                 f"CPU {runs[1]}")
    print(f"csgd smoke card vs cpu: (loss, alpha, n_evals) {runs[0]} vs "
          f"{runs[1]}", flush=True)


def ptxas_entries(name: str, kernels) -> list[tuple[str, int, int]]:
    """(entry, registers, spill bytes) of each of the named kernels that
    ``nvcc -Xptxas -v`` reported when it built ``csrc/<name>.cu``; entry
    is the kernel's name and its template integers, e.g.
    ``rmsnorm_kernel 10``."""
    from repro_torch.kernels import _build
    out, entry, spill = [], None, 0
    for line in _build.build_log(name).splitlines():
        m = re.search(rf"Compiling entry function '\w*?({'|'.join(kernels)})"
                      r"(\w*)'", line)
        if m:
            entry = " ".join([m.group(1)] + re.findall(r"Li(\d+)E",
                                                        m.group(2)))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out.append((entry, int(m.group(1)), spill))
            entry, spill = None, 0
    return out


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 steps between two bf16 tensors of one
    sign pattern (their int16 bit patterns are monotone per sign)."""
    return int((a.view(torch.int16).int() - b.view(torch.int16).int())
               .abs().max())


def bf16_ulp_err(got: torch.Tensor, want: torch.Tensor, atol: float) -> float:
    """Largest |got - want| in bf16 ulps of |want|, once ``atol`` is taken
    off (the two sum in f32 in different orders, so a value near zero may
    differ by that much before rounding)."""
    w = want.float()
    ulp = torch.ldexp(torch.ones_like(w),
                      torch.frexp(w.abs().clamp(min=atol)).exponent - 8)
    return float(((got.float() - w).abs() - atol).clamp(min=0).div(ulp)
                 .max())


def flash_edge_cases(bshd, cases) -> list[float]:
    """Flash attention's bf16 route at each (B, H, Sq, Sk, D) of
    ``cases``, causal or not, with and without a window of 64, through
    the strided (B, H, S, D) views ``bshd`` draws: each case's error in
    bf16 ulps of the plain value beyond 1e-5; fails above 1."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    errs = []
    for (b, h, sq, sk, d) in cases:
        qs, ks, vs = bshd(b, h, sq, d), bshd(b, h, sk, d), bshd(b, h, sk, d)
        for causal in (True, False):
            for window in (None, 64):
                e = bf16_ulp_err(
                    flash_attention(qs, ks, vs, causal=causal,
                                    window=window),
                    ref.mha_reference(qs, ks, vs, causal=causal,
                                      window=window), 1e-5)
                errs.append(e)
                if not e <= 1:
                    fail(f"flash_attention bf16 {(b, h, sq, sk, d)} causal="
                         f"{causal} window={window} is {e} bf16 ulp (beyond"
                         " 1e-5) from the plain version (limit 1)")
    return errs


def flash_f32_cases(randn, cases) -> list[float]:
    """Flash attention's f32 route at each ((B, H, Sq, Sk, D), causal,
    window) of ``cases``: each case's largest error; fails above 3e-5."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    errs = []
    for (b, h, sq, sk, d), causal, window in cases:
        qs = randn(b, h, sq, d, scale=0.5)
        ks, vs = randn(b, h, sk, d, scale=0.5), randn(b, h, sk, d)
        e = float((flash_attention(qs, ks, vs, causal=causal, window=window)
                   - ref.mha_reference(qs, ks, vs, causal=causal,
                                       window=window)).abs().max())
        errs.append(e)
        if not e <= 3e-5:
            fail(f"flash_attention f32 {(b, h, sq, sk, d)} causal={causal} "
                 f"window={window} is {e} from the plain version (3e-5)")
    return errs


def check_serving_kernels(dev, report) -> None:
    """Phase 3 for the serving kernels: each against its plain version on
    the card at the shapes serving gives it, timed beside its bound and,
    where one exists, the library call computing the same function."""
    import torch.nn.functional as F_
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.rwkv_wkv import wkv_forward
    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    # flash attention, bf16 (the tensor-core route): qwen1.5-4b prefill
    # and the edge cases, through the transposed (B, S, H, D) views the
    # model hands over
    flash = ptxas_entries("flash_attention_sm90",
                          ["flash_attention_sm90_kernel"])
    norm = ptxas_entries("rmsnorm", ["rmsnorm_stream_kernel",
                                     "rmsnorm_kernel"])
    for name, entries in (("flash_attention_sm90", flash), ("rmsnorm", norm)):
        if not entries or any(spill for _, _, spill in entries):
            fail(f"csrc/{name}.cu: ptxas reported spills, or no kernel: "
                 f"{entries}")
    smem = _build.load("flash_attention_sm90").flash_attention_sm90_smem_bytes
    for entry, regs, _ in flash:
        print(f"ptxas {entry}: {regs} registers, "
              f"{smem(int(entry.split()[-1]))} bytes of dynamic shared "
              "memory, no spills", flush=True)
    print(f"ptxas rmsnorm: {len(norm)} kernels, no spills, "
          f"{min(r for _, r, _ in norm)}-{max(r for _, r, _ in norm)} "
          f"registers; {[r for e, r, _ in norm if e == 'rmsnorm_kernel 10']}"
          " at 10 chunks a lane (D 2560)", flush=True)

    def bshd(b, h, s, d):
        return randn(b, s, h, d, dtype=torch.bfloat16).transpose(1, 2)

    edge_ulps = flash_edge_cases(bshd, (
        (1, 2, 1, 70, 64), (2, 3, 100, 100, 64), (1, 2, 37, 150, 128),
        (2, 2, 300, 300, 32), (1, 4, 77, 333, 128)))
    B, H, S, D = 4, 20, 2048, 128
    q, k, v = bshd(B, H, S, D), bshd(B, H, S, D), bshd(B, H, S, D)
    got = flash_attention(q, k, v, causal=True)
    want = ref.mha_reference(q, k, v, causal=True)
    err = float((got.float() - want.float()).abs().max())
    ulps = bf16_ulp_err(got, want, 1e-5)
    if not ulps <= 1:
        fail(f"flash_attention (4, 20, 2048, 128) bf16 is {ulps} bf16 ulp "
             "(beyond 1e-5) from the plain version (limit 1)")
    print(f"flash_attention bf16: {len(edge_ulps)} edge cases within "
          f"{max(edge_ulps):.3f} bf16 ulp, (4, 20, 2048, 128) causal "
          f"{ulps:.3f}", flush=True)
    small_errs = flash_f32_cases(randn, (
        ((2, 3, 300, 300, 128), True, 64), ((2, 3, 300, 300, 64), False, None),
        ((1, 4, 77, 333, 128), True, None), ((2, 2, 150, 150, 32), True, None),
        ((2, 2, 1, 150, 64), False, 64)))
    pairs = B * H * S * (S + 1) // 2
    qf, kf, vf = q.float(), k.float(), v.float()
    f32_ms = time_ms(lambda: flash_attention(qf, kf, vf, causal=True), reps=5)
    print(f"flash_attention f32 route (CUDA cores) at (4, 20, 2048, 128) "
          f"causal: {f32_ms:.4f} ms (bound "
          f"{4 * D * pairs / F32_OPS_PER_S * 1e3:.4f} ms at 67 TFLOP/s)",
          flush=True)
    del qf, kf, vf
    report["flash_attention"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: flash_attention(q, k, v, causal=True)),
        plain_ms=time_ms(lambda: ref.mha_reference(q, k, v, causal=True)),
        library_ms=time_ms(lambda: F_.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        bytes=4 * B * H * S * D * 2, ops=4 * D * pairs,
        ops_per_s=BF16_OPS_PER_S,
        note=f"(4, 20, 2048, 128) bf16 causal, {ulps:.3f} bf16 ulp; f32 "
             f"cases max err {max(small_errs):.2e}")
    r = report["flash_attention"]
    dev_ms = device_ms(lambda: flash_attention(q, k, v, causal=True))
    dev_lib = device_ms(lambda: F_.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    print(f"flash_attention bf16 {r['ms']:.4f} ms is "
          f"{r['ms'] / r['library_ms']:.2f}x F.scaled_dot_product_attention's"
          f" {r['library_ms']:.4f} ms; device only (profiler) {dev_ms:.4f} "
          f"and {dev_lib:.4f} ms", flush=True)
    del q, k, v, got, want

    # RMSNorm: qwen1.5-4b prefill and decode rows, rwkv6-1.6b prefill
    # rows, granite-moe-1b-a400m prefill and decode rows (d 1024)
    errs = {}
    for rows, d, dt in ((8192, 2560, torch.bfloat16),
                        (4, 2560, torch.bfloat16),
                        (8192, 1024, torch.bfloat16),
                        (4, 1024, torch.bfloat16),
                        (4096, 2048, torch.bfloat16),
                        (4096, 2048, torch.float32)):
        x, w = randn(rows, d, dtype=dt), randn(d, dtype=dt)
        got, want = rmsnorm(x, w, 1e-5), ref.rmsnorm_reference(x, w, 1e-5)
        if dt == torch.bfloat16:
            ulps = bf16_ulps(got, want)
            if ulps > 1:
                fail(f"rmsnorm ({rows}, {d}) bf16 is {ulps} bf16 ulp from "
                     "the plain version (limit 1)")
            errs[(rows, d, "bf16")] = float((got.float()
                                             - want.float()).abs().max())
        else:
            e = float((got - want).abs().max())
            if not e <= 1e-5:
                fail(f"rmsnorm ({rows}, {d}) f32 is {e} from the plain "
                     "version (atol 1e-5)")
    x, w = randn(8192, 2560, dtype=torch.bfloat16), \
        randn(2560, dtype=torch.bfloat16)
    print(f"rmsnorm (8192, 2560) bf16 device only (profiler): "
          f"{device_ms(lambda: rmsnorm(x, w, 1e-5)):.4f} ms, F.rms_norm "
          f"{device_ms(lambda: F_.rms_norm(x, (2560,), w, 1e-5)):.4f} ms",
          flush=True)
    report["rmsnorm"] = dict(
        max_abs_err=errs[(8192, 2560, "bf16")],
        ms=time_ms(lambda: rmsnorm(x, w, 1e-5)),
        plain_ms=time_ms(lambda: ref.rmsnorm_reference(x, w, 1e-5)),
        library_ms=time_ms(lambda: F_.rms_norm(x, (2560,), w, 1e-5)),
        bytes=2 * 8192 * 2560 * 2 + 2560 * 2, ops=8192 * 2560 * 4,
        note="(8192, 2560) bf16, qwen1.5-4b prefill; within 1 bf16 ulp "
             "at every shape")
    del x, w

    # WKV: rwkv6-1.6b prefill and one decode step
    wkv = ptxas_entries("rwkv_wkv", ["wkv_forward_kernel"])
    if not wkv or any(spill for _, _, spill in wkv):
        fail(f"csrc/rwkv_wkv.cu: ptxas reported spills, or no kernel: {wkv}")
    smem = _build.load("rwkv_wkv").wkv_forward_smem_bytes
    for entry, regs, _ in wkv:
        print(f"ptxas {entry}: {regs} registers, "
              f"{smem(int(entry.split()[-1]))} bytes of dynamic shared "
              "memory, no spills", flush=True)
    B, S, H, K = 4, 1024, 32, 64

    def wkv_inputs(s):
        return (randn(B, s, H, K, scale=0.3), randn(B, s, H, K, scale=0.3),
                randn(B, s, H, K), torch.sigmoid(randn(B, s, H, K)),
                randn(H, K, scale=0.1), randn(B, H, K, K, scale=0.1))
    wkv_ms, wkv_err = {}, {}
    for s_len in (1, S):
        args = wkv_inputs(s_len)
        y, sT = wkv_forward(*args)
        ry, rsT = ref.wkv_reference(*args)
        e = max(float((y - ry).abs().max()), float((sT - rsT).abs().max()))
        if not e <= 2e-5:
            fail(f"wkv_forward at S={s_len} is {e} from the plain version "
                 "(atol 2e-5)")
        wkv_ms[s_len], wkv_err[s_len] = time_ms(
            lambda: wkv_forward(*args)), e
    print(f"wkv_forward (4, S, 32, 64) f32: S = 1 (a decode step) "
          f"{wkv_ms[1]:.4f} ms (max err {wkv_err[1]:.2e}), S = 1024 "
          f"{wkv_ms[S]:.4f} ms (max err {wkv_err[S]:.2e}), device only "
          f"(profiler) {device_ms(lambda: wkv_forward(*args)):.4f} ms",
          flush=True)
    report["wkv_forward"] = dict(
        max_abs_err=e, ms=wkv_ms[S],
        plain_ms=time_ms(lambda: ref.wkv_reference(*args)),
        library_ms=None,
        bytes=(5 * B * S * H * K + 2 * B * H * K * K + H * K) * 4,
        # per (b, t, h): r.S and w*S + k^T v, 5 per state element; the
        # u term, (sum_k r u k) v, 3K + 2V
        ops=B * S * H * (5 * K * K + 5 * K),
        note="(4, 1024, 32, 64) f32, rwkv6-1.6b prefill; also S = 1")


def profile_serving(dev, arch, ctx, kernels_of_path) -> None:
    """One profiled prefill and one profiled decode step at full width."""
    from repro_torch.launch import serve
    model, params, batch = serve.load(arch, False, SERVE_BATCH, ctx, dev)
    with torch.inference_mode():
        model.prefill(params, batch, capacity=ctx + SERVE_GEN)    # warm
        holder = {}
        prof, wall = profiled(dev, lambda: holder.update(out=model.prefill(
            params, batch, capacity=ctx + SERVE_GEN)))
        report_profile(f"{arch} prefill", prof, wall, kernels_of_path)
        logits, cache = holder.pop("out")
        tok = logits[:, -1:, :model.cfg.vocab_size].argmax(-1)
        model.decode_step(params, tok, cache, ctx)    # warm
        prof, wall = profiled(dev, lambda: model.decode_step(
            params, tok, cache, ctx + 1))
        report_profile(f"{arch} decode", prof, wall,
                       [k for k in kernels_of_path
                        if not k.startswith("flash_attention")])
    del model, params, batch, logits, cache
    torch.cuda.empty_cache()


def run_serving(dev) -> tuple[dict, dict]:
    """Phase 4d: the serving paths at full width through the launcher;
    returns each path's launch counts and logits."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    counts_of, logits_of = {}, {}
    for arch, ctx, want, traced in SERVE_RUNS:
        ops.reset_launch_counts()
        res = serve.main(["--arch", arch, "--full", "--batch",
                          str(SERVE_BATCH), "--ctx", str(ctx), "--gen",
                          str(SERVE_GEN)])
        counts = ops.launch_counts()
        counts_of[arch] = counts
        print(f"serve [{arch}]: launches {counts}; prefill "
              f"{res['prefill_s']:.4f} s, decode "
              f"{res['decode_ms_per_step']:.3f} ms/step "
              f"({res['decode_tokens_per_s']:.1f} tokens/s), peak memory "
              f"{res['peak_memory_bytes'] / 2**30:.2f} GiB", flush=True)
        for name, n in counts.items():
            if n != want.get(name, 0):
                fail(f"[serve {arch}] {name} launched {n} times, want "
                     f"{want.get(name, 0)}")
        if tuple(res["tokens"].shape) != (SERVE_BATCH, SERVE_GEN) \
                or not torch.isfinite(res["logits"]).all():
            fail(f"[serve {arch}] tokens {tuple(res['tokens'].shape)} or "
                 "non-finite logits")
        logits_of[arch] = res["logits"]
        del res
        torch.cuda.empty_cache()
        profile_serving(dev, arch, ctx, traced)
    return counts_of, logits_of


def serve_smoke(dev) -> None:
    """Phase 5c: the smoke serve configs on the card (kernels) and on the
    CPU (plain versions): equal tokens, logits within 1e-4 of max."""
    from repro_torch.launch import serve
    for arch in [a for a, _, _, _ in SERVE_RUNS] + [ZAMBA]:
        args = ["--arch", arch, "--smoke", "--batch", "2", "--ctx", "96",
                "--gen", "4"]
        card, cpu = serve.main(args), serve.main(args + ["--device", "cpu"])
        err = float((card["logits"] - cpu["logits"]).abs().max())
        tol = 1e-4 * float(cpu["logits"].abs().max())
        if not torch.equal(card["tokens"], cpu["tokens"]) or not err <= tol:
            fail(f"serve smoke {arch} on the card (tokens "
                 f"{card['tokens'].tolist()}) disagrees with the CPU "
                 f"({cpu['tokens'].tolist()}): logits {err} > {tol}")
        print(f"serve smoke {arch} card vs cpu: tokens "
              f"{card['tokens'].tolist()} equal, logits max diff {err:.3e} "
              f"(limit {tol:.3e})", flush=True)


def check_gqa_flash(dev) -> None:
    """Phase 4m: flash attention's bf16 route against its plain version at
    the MoE models' prefill shapes, the kv heads broadcast by the model's
    own ``_expand_kv`` (granite 2:1 at D 64, qwen3-moe 8:1 at D 128),
    timed beside the plain version and the library call."""
    import torch.nn.functional as F_
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.attention import _expand_kv
    gen = torch.Generator(device=dev).manual_seed(11)
    B, S = SERVE_BATCH, 2048
    for arch, H, Hkv, D in ((MOE_ARCH, 16, 8, 64), (QWEN3_MOE, 32, 4, 128)):
        q, k, v = (torch.randn((B, S, h, D), generator=gen, device=dev)
                   .to(torch.bfloat16) for h in (H, Hkv, Hkv))
        q = q.transpose(1, 2)
        k, v = (_expand_kv(t, H).transpose(1, 2) for t in (k, v))
        got = flash_attention(q, k, v, causal=True)
        want = ref.mha_reference(q, k, v, causal=True)
        e = bf16_ulp_err(got, want, 1e-5)
        if not e <= 1:
            fail(f"flash_attention bf16 at {arch}'s ({B}, {H}, {S}, {D}) "
                 f"with kv heads {Hkv} -> {H} is {e} bf16 ulp (beyond 1e-5)"
                 " from the plain version (limit 1)")
        del want
        ms = time_ms(lambda: flash_attention(q, k, v, causal=True))
        plain = time_ms(lambda: ref.mha_reference(q, k, v, causal=True),
                        reps=5, warmup=1)
        lib = time_ms(lambda: F_.scaled_dot_product_attention(
            q, k, v, is_causal=True))
        # causal: half of the S x S scores, 2 products of D each
        ops_ms = 2 * B * H * S * S * D / BF16_OPS_PER_S * 1e3
        byte_ms = 4 * B * H * S * D * 2 / HBM_BYTES_PER_S * 1e3
        print(f"flash_attention GQA [{arch}] ({B}, {H}, {S}, {D}) bf16, "
              f"{Hkv} kv heads: {e:.3f} bf16 ulp; {ms:.4f} ms (plain "
              f"{plain:.4f} ms, library {lib:.4f} ms, bound "
              f"{max(ops_ms, byte_ms):.4f} ms by "
              f"{'operations' if ops_ms >= byte_ms else 'bytes'})",
              flush=True)
        del q, k, v, got
    torch.cuda.empty_cache()


def moe_serving(dev, granite_logits: torch.Tensor) -> None:
    """Phase 4m serving: granite again, bit for bit with phase 4d's run;
    qwen3-moe at full width and 12 of its 48 layers through the serving
    launcher's load and generate, counts set to 0 just before."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    res = serve.main(["--arch", MOE_ARCH, "--full", "--batch",
                      str(SERVE_BATCH), "--ctx", "2048", "--gen",
                      str(SERVE_GEN)])
    if not bits_equal(res["logits"], granite_logits):
        diff = float((res["logits"] - granite_logits).abs().max())
        fail(f"[serve {MOE_ARCH}] a second run's logits differ from the "
             f"first's (max {diff}): the MoE combine is not deterministic")
    print(f"serve [{MOE_ARCH}] second run: logits bit-identical to the "
          "first", flush=True)
    del res
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model, params, batch = serve.load(QWEN3_MOE, False, SERVE_BATCH,
                                      QWEN3_MOE_CTX, dev,
                                      n_layers=QWEN3_MOE_LAYERS)
    n_params = sum(p.numel() for p in tree_leaves(params))
    ops.reset_launch_counts()
    res = serve.generate(model, params, batch, SERVE_GEN)
    counts = ops.launch_counts()
    want = dict(flash_attention=QWEN3_MOE_LAYERS,
                rmsnorm=(2 * QWEN3_MOE_LAYERS + 1) * SERVE_GEN)
    print(f"serve [{QWEN3_MOE}, {QWEN3_MOE_LAYERS} of 48 layers, "
          f"{n_params} parameters]: launches {counts}; prefill "
          f"{res['prefill_s']:.4f} s, decode "
          f"{res['decode_ms_per_step']:.3f} ms/step "
          f"({res['decode_tokens_per_s']:.1f} tokens/s), peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
          flush=True)
    for name, n in counts.items():
        if n != want.get(name, 0):
            fail(f"[serve {QWEN3_MOE}] {name} launched {n} times, want "
                 f"{want.get(name, 0)}")
    if tuple(res["tokens"].shape) != (SERVE_BATCH, SERVE_GEN) \
            or not torch.isfinite(res["logits"]).all():
        fail(f"[serve {QWEN3_MOE}] tokens {tuple(res['tokens'].shape)} or "
             "non-finite logits")
    del model, params, batch, res
    torch.cuda.empty_cache()


def tree_leaves(tree) -> list:
    from repro_torch.utils import tree_flatten
    return tree_flatten(tree)[0]


def moe_trainer(dev) -> dict:
    """Phase 4m: DCSGD-ASSS on granite at full width and depth; the
    launches of pack_words / unpack_words from the bucket plan, worked
    out before the run (a stream pack or unpack launches below 32
    bits)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.comm.bucket import build_bucket_plan
    from repro_torch.configs import get_config
    from repro_torch.core.compression import Compressor
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.utils import tree_flatten
    comp = Compressor(gamma=0.01, method="block_topk")
    with FakeTensorMode():
        fake = lm.init_params(get_config(MOE_ARCH))
        shapes = [tuple(x.shape) for x in tree_leaves(fake)]
        stacked = tree_flatten(lm.stacked_mask(fake))[0]
    plan = build_bucket_plan(shapes, stacked, comp)
    codec = sum((b.index_bits < 32) + (comp.value_bits < 32)
                for b in plan.buckets)
    per_step = dict(ef_stats_telemetry=1, ef_apply=1, pack_words=codec,
                    unpack_words=codec)
    # the metric is an f32 sum: 81,180,540 B reads 81,180,544
    want_bytes = float(np.float32(step_wire_bytes(shapes, stacked, comp)))
    print(f"trainer [{MOE_ARCH}] plan: {len(plan.leaves)} leaves, buckets "
          f"{[(b.index_bits, len(b.leaf_ids)) for b in plan.buckets]}, "
          f"{plan.total_words} payload words, {want_bytes} B a step; "
          f"launches a step {per_step}", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    log, params, state = train.run(MOE_ARGS + ["--steps", str(MOE_STEPS)])
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"trainer [{MOE_ARCH}]: launches {counts}; loss "
          f"{[x['loss'] for x in log]}; alpha {[x['alpha'] for x in log]};"
          f" n_evals {[x['n_evals'] for x in log]}; step_s "
          f"{[round(x['step_s'], 4) for x in log]}; wire bytes "
          f"{[x['wire_bytes'] for x in log]}; peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    for name, n in counts.items():
        if n != per_step.get(name, 0) * MOE_STEPS:
            fail(f"[{MOE_ARCH} trainer] {name} launched {n} times in "
                 f"{MOE_STEPS} steps, want "
                 f"{per_step.get(name, 0) * MOE_STEPS}")
    if not all(np.isfinite(x["loss"]) for x in log):
        fail(f"[{MOE_ARCH} trainer] non-finite loss")
    if any(x["wire_bytes"] != want_bytes for x in log) \
            or any(x["steps_skipped"] for x in log):
        fail(f"[{MOE_ARCH} trainer] wire bytes "
             f"{[x['wire_bytes'] for x in log]} != {want_bytes}, or a "
             "step was skipped")
    dtypes = {str(p.dtype) for p in tree_leaves(params)}
    router = params["blocks"]["moe"]["router"]["w"]
    memory = {m.dtype for m in tree_leaves(state.memory)}
    if dtypes != {"torch.bfloat16", "torch.float32"} \
            or router.dtype != torch.float32 or memory != {torch.float32}:
        fail(f"[{MOE_ARCH} trainer] parameter dtypes {dtypes}, router "
             f"{router.dtype}: want bf16 with an f32 router and f32 EF "
             "memory")
    del params, state
    torch.cuda.empty_cache()
    return dict(steps_s=[x["step_s"] for x in log],
                loss=[x["loss"] for x in log], peak_bytes=peak,
                wire_bytes=want_bytes)


def moe_card_vs_cpu(dev) -> None:
    """Phase 4m: ``moe_block`` at the granite smoke size on the card
    against the CPU in f32 and bf16 (routes exact), and 2 trainer steps
    of the granite smoke on both (bytes equal, losses rel 1e-5)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    cfg = get_smoke_config(MOE_ARCH)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 96, cfg.d_model), generator=gen)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        p = moe.init_moe(torch.Generator().manual_seed(1), cfg, dtype)
        xd = x.to(dtype)
        want = moe.route(p, xd.reshape(-1, cfg.d_model), cfg)
        wy, waux = moe.moe_block(p, xd, cfg)
        pd = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                  if isinstance(v, dict) else v.to(dev))
              for k, v in p.items()}
        got = moe.route(pd, xd.to(dev).reshape(-1, cfg.d_model), cfg)
        gy, gaux = moe.moe_block(pd, xd.to(dev), cfg)
        top = torch.sort(want.probs, -1, descending=True).values
        gap = float((top[:, cfg.experts_per_token - 1]
                     - top[:, cfg.experts_per_token]).min())
        for f in ("eids", "se", "st", "pos", "keep"):
            if not torch.equal(getattr(got, f).cpu(), getattr(want, f)):
                fail(f"moe_block {dtype} on the card routes {f} unlike the "
                     f"CPU (least top-k probability gap {gap})")
        err = float((gy.float().cpu() - wy.float()).abs().max())
        lim = tol * float(wy.float().abs().max())
        if not err <= lim or not abs(float(gaux) - float(waux)) <= \
                1e-6 * abs(float(waux)):
            fail(f"moe_block {dtype} on the card: y {err} > {lim} or aux "
                 f"{float(gaux)} vs {float(waux)}")
        print(f"moe_block {dtype} granite smoke card vs cpu: routes equal "
              f"(least top-k gap {gap:.3e}), y max diff {err:.3e} (limit "
              f"{lim:.3e}), aux {float(gaux)} vs {float(waux)}", flush=True)
    smoke_trainer_card_vs_cpu(MOE_ARCH)


def smoke_trainer_card_vs_cpu(arch: str) -> None:
    """2 trainer steps of ``arch``'s smoke variant on the card and on the
    CPU: equal bytes, losses within rel 1e-5."""
    from repro_torch.launch import train
    small = ["--arch", arch, "--smoke", "--steps", "2", "--seq-len", "33",
             "--global-batch", "4", "--compress-method", "block_topk",
             "--log-every", "1"]
    on_card = train.main(small)
    on_cpu = train.main(small + ["--device", "cpu"])
    for a, b in zip(on_card, on_cpu):
        if abs(a["loss"] - b["loss"]) > 1e-5 * abs(b["loss"]) or \
                a["wire_bytes"] != b["wire_bytes"]:
            fail(f"{arch} smoke trainer on the card {a} disagrees with the "
                 f"CPU {b}")
    print(f"{arch} smoke trainer card vs cpu: losses "
          f"{[x['loss'] for x in on_card]} vs {[x['loss'] for x in on_cpu]}"
          f", bytes {[x['wire_bytes'] for x in on_card]}", flush=True)


def check_hybrid_kernels(dev) -> dict:
    """Phase 4n: flash attention at zamba2-7b's head dim 112 (bf16 route
    at the prefill shape and at edge cases through strided views, its
    ptxas line; f32 route at small cases) and RMSNorm at d_model 3584
    and d_in 7168 (the wide body), each against its plain version and
    timed beside it and the library call."""
    import torch.nn.functional as F_
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    entry = [e for e in ptxas_entries("flash_attention_sm90",
                                      ["flash_attention_sm90_kernel"])
             if e[0].endswith(" 112")]
    if len(entry) != 1 or entry[0][2]:
        fail(f"csrc/flash_attention_sm90.cu: the D 112 instance is missing "
             f"or spills: {entry}")
    smem = _build.load("flash_attention_sm90").flash_attention_sm90_smem_bytes
    print(f"ptxas {entry[0][0]}: {entry[0][1]} registers, {smem(112)} bytes "
          "of dynamic shared memory, no spills", flush=True)
    gen = torch.Generator(device=dev).manual_seed(13)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def bshd(b, h, s, d):
        return randn(b, s, h, d, dtype=torch.bfloat16).transpose(1, 2)

    D = 112
    edge = flash_edge_cases(bshd, [
        (b, h, sq, sk, D) for b, h, sq, sk in (
            (1, 2, 1, 70), (2, 3, 100, 100), (1, 2, 37, 150),
            (2, 2, 300, 300), (1, 4, 77, 333), (1, 2, 129, 129))])
    B, H, S = SERVE_BATCH, 32, ZAMBA_CTX
    q, k, v = bshd(B, H, S, D), bshd(B, H, S, D), bshd(B, H, S, D)
    got = flash_attention(q, k, v, causal=True)
    want = ref.mha_reference(q, k, v, causal=True)
    ulps = bf16_ulp_err(got, want, 1e-5)
    err = float((got.float() - want.float()).abs().max())
    if not ulps <= 1:
        fail(f"flash_attention ({B}, {H}, {S}, {D}) bf16 is {ulps} bf16 ulp "
             "(beyond 1e-5) from the plain version (limit 1)")
    del got, want
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True))
    plain = time_ms(lambda: ref.mha_reference(q, k, v, causal=True),
                    reps=5, warmup=1)
    lib = time_ms(lambda: F_.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    pairs = B * H * S * (S + 1) // 2
    ops_ms = 4 * D * pairs / BF16_OPS_PER_S * 1e3
    byte_ms = 4 * B * H * S * D * 2 / HBM_BYTES_PER_S * 1e3
    flash = dict(ulps=ulps, max_abs_err=err, ms=ms, plain_ms=plain,
                 library_ms=lib, bound_ms=max(ops_ms, byte_ms),
                 bound_by="operations" if ops_ms >= byte_ms else "bytes")
    print(f"flash_attention bf16 D 112: {len(edge)} edge cases within "
          f"{max(edge):.3f} bf16 ulp; ({B}, {H}, {S}, {D}) causal "
          f"{ulps:.3f} ulp (max err {err:.3e}), {ms:.4f} ms, plain "
          f"{plain:.4f} ms, library {lib:.4f} ms, bound "
          f"{flash['bound_ms']:.4f} ms by {flash['bound_by']}", flush=True)
    del q, k, v
    small = flash_f32_cases(randn, (
        ((2, 3, 300, 300, D), True, 64), ((2, 3, 300, 300, D), False, None),
        ((1, 4, 77, 333, D), True, None), ((2, 2, 1, 150, D), False, 64)))
    print(f"flash_attention f32 D 112: {len(small)} cases within "
          f"{max(small):.2e} (atol 3e-5)", flush=True)

    norms = {}
    for rows, d in ((8192, 3584), (4, 3584), (8192, 7168), (4, 7168)):
        x, w = randn(rows, d, dtype=torch.bfloat16), \
            randn(d, dtype=torch.bfloat16)
        u = bf16_ulps(rmsnorm(x, w, 1e-5), ref.rmsnorm_reference(x, w, 1e-5))
        if u > 1:
            fail(f"rmsnorm ({rows}, {d}) bf16 is {u} bf16 ulp from the plain "
                 "version (limit 1)")
        r = dict(ulps=u, ms=time_ms(lambda: rmsnorm(x, w, 1e-5)),
                 plain_ms=time_ms(lambda: ref.rmsnorm_reference(x, w, 1e-5)),
                 library_ms=time_ms(lambda: F_.rms_norm(x, (d,), w, 1e-5)),
                 bound_ms=(2 * rows * d * 2 + d * 2) / HBM_BYTES_PER_S * 1e3)
        norms[f"{rows}x{d}"] = r
        print(f"rmsnorm ({rows}, {d}) bf16: {u} ulp; {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, F.rms_norm "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              "bytes", flush=True)
    return dict(flash_d112=flash, rmsnorm=norms)


def hybrid_serving(dev) -> dict:
    """Phase 4n: zamba2-7b at full width and depth (81 Mamba2 layers and
    13 invocations of the shared block) through the serving launcher's
    load and generate, counts set to 0 just before; then one profiled
    warm prefill and decode step, and the SSD scan alone at the
    prefill's shape."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import ssm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model, params, batch = serve.load(ZAMBA, False, SERVE_BATCH, ZAMBA_CTX,
                                      dev)
    cfg = model.cfg
    leaves = tree_leaves(params)
    n_params = sum(p.numel() for p in leaves)
    n_bytes = sum(p.numel() * p.element_size() for p in leaves)
    init_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    res = serve.generate(model, params, batch, SERVE_GEN)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    groups, tail = divmod(cfg.n_layers, cfg.shared_attn_every)
    per_forward = 2 * cfg.n_layers + 2 * groups + 1
    want = dict(flash_attention=groups, rmsnorm=per_forward * SERVE_GEN)
    print(f"serve [{ZAMBA}, {cfg.n_layers} layers: {groups} groups of "
          f"{cfg.shared_attn_every} and {tail} tail, {n_params} parameters, "
          f"{n_bytes} B]: launches {counts}; prefill {res['prefill_s']:.4f} "
          f"s, decode {res['decode_ms_per_step']:.3f} ms/step "
          f"({res['decode_tokens_per_s']:.1f} tokens/s); peak memory "
          f"{peak / 2**30:.2f} GiB serving, {init_peak / 2**30:.2f} GiB at "
          "init", flush=True)
    for name, n in counts.items():
        if n != want.get(name, 0):
            fail(f"[serve {ZAMBA}] {name} launched {n} times, want "
                 f"{want.get(name, 0)}")
    if tuple(res["tokens"].shape) != (SERVE_BATCH, SERVE_GEN) \
            or not torch.isfinite(res["logits"]).all():
        fail(f"[serve {ZAMBA}] tokens {tuple(res['tokens'].shape)} or "
             "non-finite logits")
    out = dict(params=n_params, param_bytes=n_bytes,
               prefill_s=res["prefill_s"],
               decode_ms_per_step=res["decode_ms_per_step"],
               peak_bytes=peak, init_peak_bytes=init_peak)
    del res
    traced = ("flash_attention_sm90_kernel", "rmsnorm_kernel",
              "rmsnorm_stream_kernel")
    with torch.inference_mode():
        holder = {}
        prof, wall = profiled(dev, lambda: holder.update(out=model.prefill(
            params, batch, capacity=ZAMBA_CTX + SERVE_GEN)))
        report_profile(f"{ZAMBA} prefill", prof, wall, traced)
        logits, cache = holder.pop("out")
        tok = logits[:, -1:, :cfg.vocab_size].argmax(-1)
        model.decode_step(params, tok, cache, ZAMBA_CTX)      # warm
        prof, wall = profiled(dev, lambda: model.decode_step(
            params, tok, cache, ZAMBA_CTX + 1))
        report_profile(f"{ZAMBA} decode", prof, wall, traced[1:])
        del logits, cache, holder
        # the SSD scan alone at the prefill's shape: its share of prefill
        d_in, nh, n, hd = ssm._dims(cfg)
        gen = torch.Generator(device=dev).manual_seed(17)
        x = torch.randn((SERVE_BATCH, ZAMBA_CTX, nh, hd), generator=gen,
                        device=dev).to(torch.bfloat16)
        dt = torch.rand((SERVE_BATCH, ZAMBA_CTX, nh), generator=gen,
                        device=dev) * 0.1
        A = -torch.linspace(1.0, 16.0, nh, device=dev)
        bm, cm = (torch.randn((SERVE_BATCH, ZAMBA_CTX, n), generator=gen,
                              device=dev).to(torch.bfloat16)
                  for _ in range(2))
        ssd = time_ms(lambda: ssm.ssd_chunked(x, dt, A, bm, cm,
                                              cfg.ssm_chunk), reps=5)
        del x, dt, bm, cm
    out["ssd_ms_per_layer"] = ssd
    print(f"ssd_chunked at ({SERVE_BATCH}, {ZAMBA_CTX}, {nh}, {hd}), state "
          f"{n}, chunk {cfg.ssm_chunk}: {ssd:.4f} ms a layer, "
          f"{ssd * cfg.n_layers:.2f} ms for {cfg.n_layers} layers "
          f"({ssd * cfg.n_layers / 1e3 / out['prefill_s']:.3f} of the "
          "prefill's seconds)", flush=True)
    del model, params, batch
    torch.cuda.empty_cache()
    return out


def hybrid_trainer(dev) -> dict:
    """Phase 4n: DCSGD-ASSS on zamba2-7b at full width and 13 of its 81
    layers (2 groups of 6 and 1 tail layer); the launches of pack_words /
    unpack_words from the bucket plan, worked out before the run."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.comm.bucket import build_bucket_plan
    from repro_torch.configs import get_config
    from repro_torch.core.compression import Compressor
    from repro_torch.core.leafmath import plan_wire_bytes
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.utils import tree_flatten, tree_map_with_path
    comp = Compressor(gamma=0.01, method="block_topk")
    cfg = dataclasses.replace(get_config(ZAMBA), n_layers=ZAMBA_LAYERS)
    with FakeTensorMode():
        fake = lm.init_params(cfg)
        shapes = [tuple(x.shape) for x in tree_leaves(fake)]
        stacked = tree_flatten(lm.stacked_mask(fake))[0]
    plan = build_bucket_plan(shapes, stacked, comp)
    codec = sum((b.index_bits < 32) + (comp.value_bits < 32)
                for b in plan.buckets)
    per_step = dict(ef_stats_telemetry=1, ef_apply=1, pack_words=codec,
                    unpack_words=codec)
    # the metric is JAX's f32 sum over the leaves in tree order: it reads
    # 84,897,664 where the exact count is 84,897,672
    exact = step_wire_bytes(shapes, stacked, comp)
    want_bytes = float(plan_wire_bytes(plan, comp)[0])
    n_params = sum(int(np.prod(s)) for s in shapes)
    print(f"trainer [{ZAMBA}, {ZAMBA_LAYERS} layers, {n_params} parameters]"
          f" plan: {len(plan.leaves)} leaves, rows "
          f"{sorted({ln.L for ln in plan.leaves})}, buckets "
          f"{[(b.index_bits, len(b.leaf_ids)) for b in plan.buckets]}, "
          f"{plan.total_words} payload words, {exact} B a step (the f32 "
          f"metric {want_bytes}); launches a step {per_step}", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    log, params, state = train.run(
        ZAMBA_ARGS + ["--steps", str(ZAMBA_STEPS)], n_layers=ZAMBA_LAYERS)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"trainer [{ZAMBA}]: launches {counts}; loss "
          f"{[x['loss'] for x in log]}; alpha {[x['alpha'] for x in log]};"
          f" n_evals {[x['n_evals'] for x in log]}; step_s "
          f"{[round(x['step_s'], 4) for x in log]}; wire bytes "
          f"{[x['wire_bytes'] for x in log]}; peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    for name, n in counts.items():
        if n != per_step.get(name, 0) * ZAMBA_STEPS:
            fail(f"[{ZAMBA} trainer] {name} launched {n} times in "
                 f"{ZAMBA_STEPS} steps, want "
                 f"{per_step.get(name, 0) * ZAMBA_STEPS}")
    if not all(np.isfinite(x["loss"]) for x in log):
        fail(f"[{ZAMBA} trainer] non-finite loss")
    if any(x["wire_bytes"] != want_bytes for x in log) \
            or any(x["steps_skipped"] for x in log):
        fail(f"[{ZAMBA} trainer] wire bytes {[x['wire_bytes'] for x in log]}"
             f" != {want_bytes}, or a step was skipped")
    f32_leaves = ("A_log", "D_skip", "dt_bias")
    wrong = [p for p, ok in tree_leaves(tree_map_with_path(
        lambda path, x: (path, x.dtype == (torch.float32 if path[-1] in
                                           f32_leaves else torch.bfloat16)),
        params)) if not ok]
    memory = {m.dtype for m in tree_leaves(state.memory)}
    if wrong or memory != {torch.float32}:
        fail(f"[{ZAMBA} trainer] leaves of the wrong dtype {wrong} (want "
             f"bf16, {f32_leaves} f32) or EF memory {memory} (want f32)")
    del params, state
    torch.cuda.empty_cache()
    return dict(layers=ZAMBA_LAYERS, params=n_params,
                steps_s=[x["step_s"] for x in log],
                loss=[x["loss"] for x in log], peak_bytes=peak,
                wire_bytes=want_bytes)


def hybrid_card_vs_cpu(dev) -> None:
    """Phase 4n: ``mamba2_block`` and ``ssd_chunked`` at the zamba2 smoke
    size with ``ssm_chunk`` 16 (6 chunks of 96 positions) on the card
    against the CPU: f32 within 1e-5 of max|y|, bf16 within 1e-2."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import ssm
    from repro_torch.utils import tree_map
    gen = torch.Generator().manual_seed(0)
    L = 96
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        name = str(dtype).removeprefix("torch.")
        cfg = dataclasses.replace(get_smoke_config(ZAMBA), ssm_chunk=16,
                                  param_dtype=name, compute_dtype=name,
                                  use_pallas=True)
        p = ssm.init_mamba2(torch.Generator().manual_seed(1), cfg, dtype)
        p["conv_b"] = 0.1 * torch.randn(p["conv_b"].shape, generator=gen) \
            .to(dtype)
        p["dt_bias"] = 0.1 * torch.randn(p["dt_bias"].shape, generator=gen)
        x = torch.randn((2, L, cfg.d_model), generator=gen).to(dtype)
        want, wst = ssm.mamba2_block(p, x, cfg, return_state=True)
        got, gst = ssm.mamba2_block(tree_map(lambda t: t.to(dev), p),
                                    x.to(dev), cfg, return_state=True)
        errs = []
        for g, w in ((got, want), (gst.conv, wst.conv), (gst.ssm, wst.ssm)):
            e = float((g.float().cpu() - w.float()).abs().max())
            lim = tol * float(w.float().abs().max())
            errs.append(e)
            if not e <= lim:
                fail(f"mamba2_block {name} on the card is {e} from the CPU "
                     f"(limit {lim})")
        d_in, nh, n, hd = ssm._dims(cfg)
        xs = torch.randn((2, L, nh, hd), generator=gen).to(dtype)
        dt = torch.rand((2, L, nh), generator=gen) * 0.5
        A = -torch.linspace(1.0, 16.0, nh)
        bm, cm = (torch.randn((2, L, n), generator=gen).to(dtype)
                  for _ in range(2))
        wy, ws = ssm.ssd_chunked(xs, dt, A, bm, cm, cfg.ssm_chunk)
        gy, gs = ssm.ssd_chunked(*(t.to(dev) for t in (xs, dt, A, bm, cm)),
                                 cfg.ssm_chunk)
        for g, w in ((gy, wy), (gs, ws)):
            e = float((g.cpu() - w).abs().max())
            lim = tol * float(w.abs().max())
            errs.append(e)
            if not e <= lim:
                fail(f"ssd_chunked {name} on the card is {e} from the CPU "
                     f"(limit {lim})")
        print(f"mamba2_block / ssd_chunked {name} zamba2 smoke, chunk 16, "
              f"card vs cpu: max diffs {[f'{e:.3e}' for e in errs]} "
              f"(y, conv, state; ssd y, state; limit {tol} of each max)",
              flush=True)


def check_encdec_flash(dev) -> dict:
    """Phase 3 for phase 4o's path: flash attention without causality
    at seamless-m4t's shapes, D 64, through the strided (B, S, H, D)
    views the model hands over: the encoder's self attention (4, 16, 32,
    64), the cross attention at prefill (4, 16) x 2048 queries against
    32 frames (Sq > Sk, a negative query offset) and at decode (one
    query against the 32 frames), each on the bf16 route against its
    plain version (1 bf16 ulp beyond 1e-5), timed beside the plain
    version, ``F.scaled_dot_product_attention`` and its bound; edge
    cases with Sq > Sk, with and without a window of 64; the f32 route
    at small Sq > Sk cases (atol 3e-5); both D 64 instances' ptxas lines
    without spills."""
    import torch.nn.functional as F_
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import SRC_FRAMES
    for name, kernel in (("flash_attention_sm90",
                          "flash_attention_sm90_kernel"),
                         ("flash_attention", "flash_attention_kernel")):
        entry = [e for e in ptxas_entries(name, [kernel])
                 if e[0].endswith(" 64")]
        if len(entry) != 1 or entry[0][2]:
            fail(f"csrc/{name}.cu: the D 64 instance is missing or spills: "
                 f"{entry}")
        print(f"ptxas {entry[0][0]} ({name}.cu): {entry[0][1]} registers, "
              "no spills", flush=True)
    gen = torch.Generator(device=dev).manual_seed(19)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def bshd(b, h, s, d):
        return randn(b, s, h, d, dtype=torch.bfloat16).transpose(1, 2)

    edge = []
    for b, h, sq, sk, d in ((2, 3, 300, 70, 64), (1, 2, 129, 1, 64),
                            (2, 2, 200, 65, 128), (1, 4, 77, 64, 64),
                            (2, 3, 1, 32, 64)):
        q, k, v = bshd(b, h, sq, d), bshd(b, h, sk, d), bshd(b, h, sk, d)
        for window in (None, 64):
            e = bf16_ulp_err(
                flash_attention(q, k, v, causal=False, window=window),
                ref.mha_reference(q, k, v, causal=False, window=window),
                1e-5)
            edge.append(e)
            if not e <= 1:
                fail(f"flash_attention bf16 {(b, h, sq, sk, d)} non-causal "
                     f"window={window} is {e} bf16 ulp (beyond 1e-5) from "
                     "the plain version (limit 1)")
    small = flash_f32_cases(randn, (
        ((2, 3, 300, 70, 64), False, None), ((2, 3, 300, 70, 64), False, 64),
        ((1, 2, 129, 1, 64), False, None), ((2, 2, 200, 65, 128), False, 64),
        ((2, 2, 2048, 32, 64), False, None)))
    print(f"flash_attention non-causal Sq >= Sk: bf16 {len(edge)} cases "
          f"within {max(edge):.3f} bf16 ulp, f32 {len(small)} cases within "
          f"{max(small):.2e} (atol 3e-5)", flush=True)
    B, H, D, F = SERVE_BATCH, 16, 64, SRC_FRAMES
    out = {}
    for label, sq, sk in (("encoder", F, F), ("cross prefill", SEAMLESS_CTX,
                                              F), ("cross decode", 1, F)):
        q, k, v = bshd(B, H, sq, D), bshd(B, H, sk, D), bshd(B, H, sk, D)
        got = flash_attention(q, k, v, causal=False)
        want = ref.mha_reference(q, k, v, causal=False)
        ulps = bf16_ulp_err(got, want, 1e-5)
        err = float((got.float() - want.float()).abs().max())
        if not ulps <= 1:
            fail(f"flash_attention {label} ({B}, {H}, {sq}, {sk}, {D}) bf16 "
                 f"is {ulps} bf16 ulp (beyond 1e-5) from the plain version "
                 "(limit 1)")
        del got, want
        ms = time_ms(lambda: flash_attention(q, k, v, causal=False))
        plain = time_ms(lambda: ref.mha_reference(q, k, v, causal=False))
        lib = time_ms(lambda: F_.scaled_dot_product_attention(q, k, v))
        # no causality: every query-key pair, 2 products of D each
        ops_ms = 4 * B * H * sq * sk * D / BF16_OPS_PER_S * 1e3
        byte_ms = B * H * (2 * sq + 2 * sk) * D * 2 / HBM_BYTES_PER_S * 1e3
        out[label] = dict(shape=[B, H, sq, sk, D], ulps=ulps,
                          max_abs_err=err, ms=ms, plain_ms=plain,
                          library_ms=lib, bound_ms=max(ops_ms, byte_ms),
                          bound_by="operations" if ops_ms >= byte_ms
                          else "bytes")
        print(f"flash_attention {label} ({B}, {H}, {sq}, {sk}, {D}) bf16 "
              f"non-causal: {ulps:.3f} ulp (max err {err:.3e}); {ms:.4f} ms,"
              f" plain {plain:.4f} ms, library {lib:.4f} ms, bound "
              f"{out[label]['bound_ms']:.5f} ms by {out[label]['bound_by']}",
              flush=True)
        del q, k, v
    torch.cuda.empty_cache()
    return out


def encdec_launches(cfg, gen: int) -> dict:
    """The kernel launches of an encoder-decoder's prefill and ``gen -
    1`` decode steps on the card.  Flash: at prefill each encoder
    layer's self attention and each decoder layer's self and cross
    attention; a decode step each decoder layer's cross attention (its
    self attention against the cache is plain einsums).  RMSNorm: 2 an
    encoder layer, ``enc_norm``, 3 a decoder layer and the final norm at
    prefill; 3 a decoder layer and the final norm a step."""
    E, L, steps = cfg.n_enc_layers, cfg.n_dec_layers, gen - 1
    return dict(flash_attention=E + 2 * L + L * steps,
                rmsnorm=2 * E + 1 + 3 * L + 1 + (3 * L + 1) * steps)


def encdec_serving(dev) -> dict:
    """Phase 4o: seamless-m4t-large-v2 at full width and depth (12
    encoder and 12 decoder layers) through the serving launcher's load and
    generate, batch 4, ctx 2048, 32 source frames, 16 tokens, the counts
    set to 0 just before: the encoder's, the decoder's and the cross
    attention's flash launches at prefill and the cross attention's at
    every decode step, exactly as worked out from the config; then one
    profiled warm prefill and decode step."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model, params, batch = serve.load(SEAMLESS, False, SERVE_BATCH,
                                      SEAMLESS_CTX, dev)
    cfg = model.cfg
    leaves = tree_leaves(params)
    n_params = sum(p.numel() for p in leaves)
    n_bytes = sum(p.numel() * p.element_size() for p in leaves)
    init_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    E, L = cfg.n_enc_layers, cfg.n_dec_layers
    want = encdec_launches(cfg, SERVE_GEN)
    ops.reset_launch_counts()
    res = serve.generate(model, params, batch, SERVE_GEN)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"serve [{SEAMLESS}, {E} + {L} layers, {n_params} parameters, "
          f"{n_bytes} B]: launches {counts} (want {want}); prefill "
          f"{res['prefill_s']:.4f} s, decode {res['decode_ms_per_step']:.3f}"
          f" ms/step ({res['decode_tokens_per_s']:.1f} tokens/s); peak "
          f"memory {peak / 2**30:.2f} GiB serving, {init_peak / 2**30:.2f} "
          "GiB at init", flush=True)
    for name, n in counts.items():
        if n != want.get(name, 0):
            fail(f"[serve {SEAMLESS}] {name} launched {n} times, want "
                 f"{want.get(name, 0)}")
    if tuple(res["tokens"].shape) != (SERVE_BATCH, SERVE_GEN) \
            or not torch.isfinite(res["logits"]).all():
        fail(f"[serve {SEAMLESS}] tokens {tuple(res['tokens'].shape)} or "
             "non-finite logits")
    out = dict(params=n_params, param_bytes=n_bytes, launches=counts,
               prefill_s=res["prefill_s"],
               decode_ms_per_step=res["decode_ms_per_step"],
               peak_bytes=peak, init_peak_bytes=init_peak)
    del res
    traced = ("flash_attention_sm90_kernel", "rmsnorm_kernel")
    with torch.inference_mode():
        model.prefill(params, batch, capacity=SEAMLESS_CTX + SERVE_GEN)
        holder = {}
        prof, wall = profiled(dev, lambda: holder.update(out=model.prefill(
            params, batch, capacity=SEAMLESS_CTX + SERVE_GEN)))
        report_profile(f"{SEAMLESS} prefill", prof, wall, traced)
        logits, cache = holder.pop("out")
        tok = logits[:, -1:, :cfg.vocab_size].argmax(-1)
        model.decode_step(params, tok, cache, SEAMLESS_CTX)      # warm
        prof, wall = profiled(dev, lambda: model.decode_step(
            params, tok, cache, SEAMLESS_CTX + 1))
        report_profile(f"{SEAMLESS} decode", prof, wall, traced)
        del logits, cache, holder
    del model, params, batch
    torch.cuda.empty_cache()
    return out


def encdec_trainer(dev) -> dict:
    """Phase 4o: DCSGD-ASSS on seamless-m4t-large-v2 at full width and
    depth (seq 256, global batch 8, each batch's 256 source frames from
    ``batch_with_aux``); the launches of pack_words / unpack_words from
    the bucket plan, worked out before the run."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.comm.bucket import build_bucket_plan
    from repro_torch.configs import get_config
    from repro_torch.core.compression import Compressor
    from repro_torch.core.leafmath import plan_wire_bytes
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.utils import tree_flatten
    comp = Compressor(gamma=0.01, method="block_topk")
    model = build_model(get_config(SEAMLESS))
    with FakeTensorMode():
        fake = model.init(0)
        shapes = [tuple(x.shape) for x in tree_leaves(fake)]
        stacked = tree_flatten(model.stacked_mask(fake))[0]
    plan = build_bucket_plan(shapes, stacked, comp)
    codec = sum((b.index_bits < 32) + (comp.value_bits < 32)
                for b in plan.buckets)
    per_step = dict(ef_stats_telemetry=1, ef_apply=1, pack_words=codec,
                    unpack_words=codec)
    # the metric is JAX's f32 sum over the leaves in tree order
    exact = step_wire_bytes(shapes, stacked, comp)
    want_bytes = float(plan_wire_bytes(plan, comp)[0])
    n_params = sum(int(np.prod(s)) for s in shapes)
    print(f"trainer [{SEAMLESS}, {n_params} parameters] plan: "
          f"{len(plan.leaves)} leaves, rows "
          f"{sorted({ln.L for ln in plan.leaves})} (no leaf stacked), "
          f"buckets {[(b.index_bits, len(b.leaf_ids)) for b in plan.buckets]}"
          f", {plan.total_words} payload words, {exact} B a step (the f32 "
          f"metric {want_bytes}); launches a step {per_step}", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    log, params, state = train.run(SEAMLESS_ARGS
                                   + ["--steps", str(SEAMLESS_STEPS)])
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"trainer [{SEAMLESS}]: launches {counts}; loss "
          f"{[x['loss'] for x in log]}; alpha {[x['alpha'] for x in log]};"
          f" n_evals {[x['n_evals'] for x in log]}; step_s "
          f"{[round(x['step_s'], 4) for x in log]}; wire bytes "
          f"{[x['wire_bytes'] for x in log]}; peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    for name, n in counts.items():
        if n != per_step.get(name, 0) * SEAMLESS_STEPS:
            fail(f"[{SEAMLESS} trainer] {name} launched {n} times in "
                 f"{SEAMLESS_STEPS} steps, want "
                 f"{per_step.get(name, 0) * SEAMLESS_STEPS}")
    if not all(np.isfinite(x["loss"]) for x in log):
        fail(f"[{SEAMLESS} trainer] non-finite loss")
    if any(x["wire_bytes"] != want_bytes for x in log) \
            or any(x["steps_skipped"] for x in log):
        fail(f"[{SEAMLESS} trainer] wire bytes "
             f"{[x['wire_bytes'] for x in log]} != {want_bytes}, or a step "
             "was skipped")
    dtypes = {p.dtype for p in tree_leaves(params)}
    memory = {m.dtype for m in tree_leaves(state.memory)}
    if dtypes != {torch.bfloat16} or memory != {torch.float32}:
        fail(f"[{SEAMLESS} trainer] parameter dtypes {dtypes}, EF memory "
             f"{memory}: want bf16 and f32")
    del params, state
    torch.cuda.empty_cache()
    return dict(params=n_params, steps_s=[x["step_s"] for x in log],
                loss=[x["loss"] for x in log], peak_bytes=peak,
                wire_bytes=want_bytes, exact_wire_bytes=exact)


def encdec_card_vs_cpu() -> None:
    """Phase 4o: the seamless smoke (f32: the CUDA-core flash route, the
    cross attention at 96 queries against 32 frames) served on the card
    and on the CPU (equal tokens, logits within 1e-4 of max), and 2
    trainer steps of it on both (equal bytes, losses within rel 1e-5)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = ["--arch", SEAMLESS, "--smoke", "--batch", "2", "--ctx", "96",
            "--gen", "4"]
    ops.reset_launch_counts()
    card = serve.main(args)
    launched = ops.launch_counts()
    cpu = serve.main(args + ["--device", "cpu"])
    err = float((card["logits"] - cpu["logits"]).abs().max())
    tol = 1e-4 * float(cpu["logits"].abs().max())
    want = encdec_launches(get_smoke_config(SEAMLESS), 4)
    if not torch.equal(card["tokens"], cpu["tokens"]) or not err <= tol \
            or any(launched[k] != n for k, n in want.items()):
        fail(f"serve smoke {SEAMLESS} on the card (tokens "
             f"{card['tokens'].tolist()}, launches {launched}) disagrees "
             f"with the CPU ({cpu['tokens'].tolist()}): logits {err} > "
             f"{tol}")
    print(f"serve smoke {SEAMLESS} card vs cpu: tokens "
          f"{card['tokens'].tolist()} equal, logits max diff {err:.3e} "
          f"(limit {tol:.3e}); launches {launched}", flush=True)
    smoke_trainer_card_vs_cpu(SEAMLESS)


def live_gates(params, seed: int = VLM_GATE_SEED) -> None:
    """Set a vlm's cross-block gates, in place, to values in [0.5, 1)
    drawn on the CPU from ``seed``.  They start at 0, as JAX's do, and
    ``tanh(0) = 0`` leaves a fresh model's stream untouched by its
    image."""
    gen = torch.Generator().manual_seed(seed)
    for k in ("gate_attn", "gate_mlp"):
        g = params["cross"][k]
        g.copy_(torch.rand(g.shape, generator=gen) * 0.5 + 0.5)


@contextlib.contextmanager
def trainer_live_gates():
    """The trainer's model (``launch.train``'s ``build_model``) with a
    vlm's init followed by :func:`live_gates`; other families as they
    are."""
    from repro_torch.launch import train
    build = train.build_model

    def with_gates(cfg):
        model = build(cfg)
        if cfg.family != "vlm":
            return model

        def init(seed=0, **kw):
            params = model.init(seed, **kw)
            live_gates(params)
            return params
        return dataclasses.replace(model, init=init)
    train.build_model = with_gates
    try:
        yield
    finally:
        train.build_model = build


def vlm_launches(cfg, gen: int) -> dict:
    """The kernel launches of a vlm's prefill and ``gen - 1`` decode
    steps on the card.  Flash: at prefill each dense layer's causal self
    attention and each cross block's attention into the patches; a
    decode step each cross block's (the self attention against the cache
    is plain einsums).  RMSNorm: 2 a dense layer, 2 a cross block and
    the final norm, at prefill and at every step."""
    groups = cfg.n_layers // cfg.cross_attn_every
    return dict(flash_attention=cfg.n_layers + groups + groups * (gen - 1),
                rmsnorm=(2 * cfg.n_layers + 2 * groups + 1) * gen)


def check_vlm_kernels(dev) -> dict:
    """Phase 4p: flash attention's bf16 route at llama-3.2-vision-11b's
    three shapes, (4, 32, Sq, Sk, 128) through the strided views the
    model hands over, the 8 kv heads broadcast by the model's own
    ``_expand_kv``: the causal self attention at prefill (2048 x 2048),
    the cross attention at prefill (2048 queries against 4096 patches:
    more keys than queries, no causality) and at decode (1 x 4096), each
    against its plain version (1 bf16 ulp beyond 1e-5) and timed beside
    it, ``F.scaled_dot_product_attention`` and its bound; RMSNorm at d
    4096, the register body's upper edge, at the prefill's (8192, 4096)
    and a decode step's (4, 4096) bf16 rows the same way beside
    ``F.rms_norm``."""
    import torch.nn.functional as F_
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.models.attention import _expand_kv
    gen = torch.Generator(device=dev).manual_seed(23)
    B, H, Hkv, D = SERVE_BATCH, 32, 8, 128
    out = {}
    for label, sq, sk, causal in (("self prefill", VLM_CTX, VLM_CTX, True),
                                  ("cross prefill", VLM_CTX, 4096, False),
                                  ("cross decode", 1, 4096, False)):
        q, k, v = (torch.randn((B, s, h, D), generator=gen, device=dev)
                   .to(torch.bfloat16) for s, h in ((sq, H), (sk, Hkv),
                                                     (sk, Hkv)))
        q = q.transpose(1, 2)
        k, v = (_expand_kv(t, H).transpose(1, 2) for t in (k, v))
        got = flash_attention(q, k, v, causal=causal)
        want = ref.mha_reference(q, k, v, causal=causal)
        ulps = bf16_ulp_err(got, want, 1e-5)
        err = float((got.float() - want.float()).abs().max())
        if not ulps <= 1:
            fail(f"flash_attention {label} ({B}, {H}, {sq}, {sk}, {D}) bf16 "
                 f"causal={causal} is {ulps} bf16 ulp (beyond 1e-5) from "
                 "the plain version (limit 1)")
        del got, want
        ms = time_ms(lambda: flash_attention(q, k, v, causal=causal))
        plain = time_ms(lambda: ref.mha_reference(q, k, v, causal=causal),
                        reps=5, warmup=1)
        lib = time_ms(lambda: F_.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
        # 2 products of D a query-key pair; causal: half of them
        ops_ms = (2 if causal else 4) * B * H * sq * sk * D \
            / BF16_OPS_PER_S * 1e3
        byte_ms = B * H * (2 * sq + 2 * sk) * D * 2 / HBM_BYTES_PER_S * 1e3
        out[label] = dict(shape=[B, H, sq, sk, D], causal=causal, ulps=ulps,
                          max_abs_err=err, ms=ms, plain_ms=plain,
                          library_ms=lib, bound_ms=max(ops_ms, byte_ms),
                          bound_by="operations" if ops_ms >= byte_ms
                          else "bytes")
        print(f"flash_attention vlm {label} ({B}, {H}, {sq}, {sk}, {D}) "
              f"bf16 causal={causal}: {ulps:.3f} ulp (max err {err:.3e}); "
              f"{ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms, "
              f"bound {out[label]['bound_ms']:.5f} ms by "
              f"{out[label]['bound_by']}", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    d = 4096
    for rows in (SERVE_BATCH * VLM_CTX, SERVE_BATCH):
        x = torch.randn((rows, d), generator=gen, device=dev).to(
            torch.bfloat16)
        w = torch.randn((d,), generator=gen, device=dev).to(torch.bfloat16)
        got, want = rmsnorm(x, w, 1e-5), ref.rmsnorm_reference(x, w, 1e-5)
        ulps = bf16_ulps(got, want)
        if ulps > 1:
            fail(f"rmsnorm ({rows}, {d}) bf16 is {ulps} bf16 ulp from the "
                 "plain version (limit 1)")
        byte_ms = (2 * rows * d * 2 + d * 2) / HBM_BYTES_PER_S * 1e3
        ops_ms = rows * d * 4 / F32_OPS_PER_S * 1e3
        r = dict(shape=[rows, d], ulps=ulps,
                 max_abs_err=float((got.float() - want.float()).abs().max()),
                 ms=time_ms(lambda: rmsnorm(x, w, 1e-5)),
                 plain_ms=time_ms(lambda: ref.rmsnorm_reference(x, w, 1e-5)),
                 library_ms=time_ms(lambda: F_.rms_norm(x, (d,), w, 1e-5)),
                 bound_ms=max(byte_ms, ops_ms),
                 bound_by="bytes" if byte_ms >= ops_ms else "operations")
        out[f"rmsnorm {rows}"] = r
        print(f"rmsnorm vlm ({rows}, {d}) bf16: {ulps} ulp; {r['ms']:.4f} "
              f"ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms by "
              f"{r['bound_by']}", flush=True)
        del x, w, got, want
    return out


def vlm_serving(dev) -> dict:
    """Phase 4p: llama-3.2-vision-11b at full width and depth (40 dense
    layers in 8 groups, each followed by a gated cross-attention block
    into 4096 image patches) through the serving launcher's load and
    generate, batch 4, ctx 2048, 16 tokens, the gates set live and the
    counts set to 0 just before: exactly the launches worked out from
    the config; a second image moves the logits with the gates live and
    not with them at 0; then one profiled warm
    prefill and decode step, and the decode step's GQA broadcast of the
    cross K/V (``_expand_kv``, 4096 patches from 8 to 32 heads) timed
    alone."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.attention import _expand_kv
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model, params, batch = serve.load(VLM, False, SERVE_BATCH, VLM_CTX, dev)
    live_gates(params)
    cfg = model.cfg
    groups = cfg.n_layers // cfg.cross_attn_every
    leaves = tree_leaves(params)
    n_params = sum(p.numel() for p in leaves)
    n_bytes = sum(p.numel() * p.element_size() for p in leaves)
    init_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    want = vlm_launches(cfg, SERVE_GEN)
    ops.reset_launch_counts()
    res = serve.generate(model, params, batch, SERVE_GEN)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"serve [{VLM}, {cfg.n_layers} layers in {groups} groups, "
          f"{cfg.n_patches} patches, {n_params} parameters, {n_bytes} B]: "
          f"launches {counts} (want {want}); prefill "
          f"{res['prefill_s']:.4f} s, decode {res['decode_ms_per_step']:.3f}"
          f" ms/step ({res['decode_tokens_per_s']:.1f} tokens/s); peak "
          f"memory {peak / 2**30:.2f} GiB serving, {init_peak / 2**30:.2f} "
          "GiB at init", flush=True)
    for name, n in counts.items():
        if n != want.get(name, 0):
            fail(f"[serve {VLM}] {name} launched {n} times, want "
                 f"{want.get(name, 0)}")
    if tuple(res["tokens"].shape) != (SERVE_BATCH, SERVE_GEN) \
            or not torch.isfinite(res["logits"]).all():
        fail(f"[serve {VLM}] tokens {tuple(res['tokens'].shape)} or "
             "non-finite logits")
    # the image reaches the logits through the gated cross blocks alone:
    # with the gates at 0 a second image moves them no more than the same
    # image does run to run; with the gates live it moves them by more
    # than that and than one bf16 ulp of max
    V = cfg.vocab_size
    first = res["logits"][0]
    ulp = 2.0 ** (float(torch.floor(torch.log2(first.abs().max()))) - 7)
    other = {**batch, "image_embed": torch.randn(
        batch["image_embed"].shape,
        generator=torch.Generator().manual_seed(8)).to(dev)}

    def last(b):
        with torch.inference_mode():
            return model.prefill(params, b)[0][:, -1, :V].float().cpu()
    same = float((last(batch) - first).abs().max())
    moved = last(other)
    diff = float((moved - first).abs().max())
    gates = {k: params["cross"][k].clone() for k in ("gate_attn",
                                                     "gate_mlp")}
    for g in gates:
        params["cross"][g].zero_()
    shut = last(batch)
    shut_moved = float((last(other) - shut).abs().max())
    dropped = float((shut - first).abs().max())
    for g, v in gates.items():
        params["cross"][g].copy_(v)
    print(f"serve [{VLM}] image: the same image again moves the prefill's "
          f"logits by {same:.6f}; a second image by {diff:.4f} "
          f"({diff / ulp:.1f} bf16 ulps of max); with the gates at 0 the "
          f"second image moves them by {shut_moved:.6f}, and the logits "
          f"move by {dropped:.4f} from the live gates'", flush=True)
    if not (diff > max(same, ulp) and shut_moved <= same
            and dropped > max(same, ulp)) \
            or not torch.isfinite(moved).all():
        fail(f"[serve {VLM}] the image does not reach the logits through "
             f"the cross blocks alone: a second image moves them by "
             f"{diff} (gates live) and {shut_moved} (gates at 0), the same "
             f"image by {same}, the gates' drop by {dropped} (1 bf16 ulp "
             f"of max {ulp})")
    out = dict(params=n_params, param_bytes=n_bytes, launches=counts,
               prefill_s=res["prefill_s"],
               decode_ms_per_step=res["decode_ms_per_step"],
               peak_bytes=peak, init_peak_bytes=init_peak,
               image_moves_logits=diff, same_image=same,
               gates_shut_image_moves=shut_moved, gates_dropped=dropped)
    del res, other, moved, shut
    traced = ("flash_attention_sm90_kernel", "rmsnorm_kernel")
    with torch.inference_mode():
        holder = {}
        prof, wall = profiled(dev, lambda: holder.update(out=model.prefill(
            params, batch, capacity=VLM_CTX + SERVE_GEN)))
        report_profile(f"{VLM} prefill", prof, wall, traced)
        logits, cache = holder.pop("out")
        tok = logits[:, -1:, :V].argmax(-1)
        model.decode_step(params, tok, cache, VLM_CTX)      # warm
        prof, wall = profiled(dev, lambda: model.decode_step(
            params, tok, cache, VLM_CTX + 1))
        report_profile(f"{VLM} decode", prof, wall, traced)
        ck = cache.cross_kv.k[0]
        expand = time_ms(lambda: _expand_kv(ck, cfg.n_heads))
        del logits, cache, holder, ck
    out["expand_kv_ms"] = expand
    print(f"_expand_kv of one cross block's K at decode ({SERVE_BATCH}, "
          f"{cfg.n_patches}, {cfg.n_kv_heads} -> {cfg.n_heads}, {cfg.hd}) "
          f"bf16: {expand:.4f} ms; K and V of {groups} blocks "
          f"{2 * groups * expand:.3f} ms a decode step", flush=True)
    del model, params, batch
    torch.cuda.empty_cache()
    return out


def vlm_trainer(dev) -> dict:
    """Phase 4p: DCSGD-ASSS on llama-3.2-vision-11b at full width on one
    group (``train.run(..., n_layers=5)``: 5 dense layers and 1 cross
    block, the gates live; seq 256, global batch 8, each batch's 4096
    patches from ``batch_with_aux``); the launches of pack_words /
    unpack_words from the bucket plan, worked out before the run."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.comm.bucket import build_bucket_plan
    from repro_torch.configs import get_config
    from repro_torch.core.compression import Compressor
    from repro_torch.core.leafmath import plan_wire_bytes
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.utils import tree_flatten, tree_map_with_path
    comp = Compressor(gamma=0.01, method="block_topk")
    cfg = train.cut_depth(get_config(VLM), VLM_LAYERS)
    with FakeTensorMode():
        fake = lm.init_params(cfg)
        shapes = [tuple(x.shape) for x in tree_leaves(fake)]
        stacked = tree_flatten(lm.stacked_mask(fake))[0]
    plan = build_bucket_plan(shapes, stacked, comp)
    codec = sum((b.index_bits < 32) + (comp.value_bits < 32)
                for b in plan.buckets)
    per_step = dict(ef_stats_telemetry=1, ef_apply=1, pack_words=codec,
                    unpack_words=codec)
    # the metric is JAX's f32 sum over the leaves in tree order
    exact = step_wire_bytes(shapes, stacked, comp)
    want_bytes = float(plan_wire_bytes(plan, comp)[0])
    n_params = sum(int(np.prod(s)) for s in shapes)
    print(f"trainer [{VLM}, {VLM_LAYERS} layers, {n_params} parameters] "
          f"plan: {len(plan.leaves)} leaves, rows "
          f"{sorted({ln.L for ln in plan.leaves})}, buckets "
          f"{[(b.index_bits, len(b.leaf_ids)) for b in plan.buckets]}, "
          f"{plan.total_words} payload words, {exact} B a step (the f32 "
          f"metric {want_bytes}); launches a step {per_step}", flush=True)
    # near this peak the allocator's fixed-size segments strand ~22 GiB
    # reserved but free, and the third step runs out of memory; segments
    # that grow in place strand none.  The setting holds for this run
    # alone.
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    try:
        with trainer_live_gates():
            log, params, state = train.run(
                VLM_ARGS + ["--steps", str(VLM_STEPS)], n_layers=VLM_LAYERS)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        reserved = torch.cuda.max_memory_reserved(dev)
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings(
            "expandable_segments:False")
    gates = {k: params["cross"][k].tolist() for k in ("gate_attn",
                                                      "gate_mlp")}
    print(f"trainer [{VLM}]: launches {counts}; loss "
          f"{[x['loss'] for x in log]}; alpha {[x['alpha'] for x in log]};"
          f" n_evals {[x['n_evals'] for x in log]}; step_s "
          f"{[round(x['step_s'], 4) for x in log]}; wire bytes "
          f"{[x['wire_bytes'] for x in log]}; gates after {VLM_STEPS} "
          f"steps {gates}; peak memory {peak / 2**30:.2f} GiB allocated, "
          f"{reserved / 2**30:.2f} GiB reserved (expandable segments)",
          flush=True)
    for name, n in counts.items():
        if n != per_step.get(name, 0) * VLM_STEPS:
            fail(f"[{VLM} trainer] {name} launched {n} times in "
                 f"{VLM_STEPS} steps, want "
                 f"{per_step.get(name, 0) * VLM_STEPS}")
    if not all(np.isfinite(x["loss"]) for x in log):
        fail(f"[{VLM} trainer] non-finite loss")
    if any(x["wire_bytes"] != want_bytes for x in log) \
            or any(x["steps_skipped"] for x in log):
        fail(f"[{VLM} trainer] wire bytes {[x['wire_bytes'] for x in log]} "
             f"!= {want_bytes}, or a step was skipped")
    wrong = [p for p, ok in tree_leaves(tree_map_with_path(
        lambda path, x: (path, x.dtype == (
            torch.float32 if path[-1].startswith("gate_")
            else torch.bfloat16)), params)) if not ok]
    memory = {m.dtype for m in tree_leaves(state.memory)}
    if wrong or memory != {torch.float32}:
        fail(f"[{VLM} trainer] leaves of the wrong dtype {wrong} (want "
             f"bf16, the gates f32) or EF memory {memory} (want f32)")
    del params, state
    torch.cuda.empty_cache()
    return dict(layers=VLM_LAYERS, params=n_params,
                steps_s=[x["step_s"] for x in log],
                loss=[x["loss"] for x in log], peak_bytes=peak,
                reserved_bytes=reserved, wire_bytes=want_bytes,
                exact_wire_bytes=exact)


def vlm_card_vs_cpu() -> None:
    """Phase 4p: the vlm smoke (f32: the CUDA-core flash route, the cross
    attention at 96 queries against 16 patches), its gates live, served
    through ``serve.load`` and ``serve.generate`` on the card and on the
    CPU (equal tokens, logits within 1e-4 of max, the launches worked
    out from the config), and 2 trainer steps of it on both (equal
    bytes, losses within rel 1e-5)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    runs = {}
    for dev in ("cuda", "cpu"):
        model, params, batch = serve.load(VLM, True, 2, 96, dev)
        live_gates(params)
        ops.reset_launch_counts()
        runs[dev] = serve.generate(model, params, batch, 4)
        runs[dev]["launches"] = ops.launch_counts()
    card, cpu = runs["cuda"], runs["cpu"]
    err = float((card["logits"] - cpu["logits"]).abs().max())
    tol = 1e-4 * float(cpu["logits"].abs().max())
    want = vlm_launches(model.cfg, 4)
    if not torch.equal(card["tokens"], cpu["tokens"]) or not err <= tol \
            or any(card["launches"][k] != want.get(k, 0)
                   for k in card["launches"]):
        fail(f"serve smoke {VLM} on the card (tokens "
             f"{card['tokens'].tolist()}, launches {card['launches']}, want "
             f"{want}) disagrees with the CPU ({cpu['tokens'].tolist()}): "
             f"logits {err} > {tol}")
    print(f"serve smoke {VLM} card vs cpu: tokens "
          f"{card['tokens'].tolist()} equal, logits max diff {err:.3e} "
          f"(limit {tol:.3e}); launches {card['launches']}", flush=True)
    with trainer_live_gates():
        smoke_trainer_card_vs_cpu(VLM)


def cache_bytes(cache) -> dict:
    """Bytes of a decode cache's tensors, by dtype."""
    out: dict = {}

    def walk(t):
        if isinstance(t, torch.Tensor):
            key = str(t.dtype).replace("torch.", "")
            out[key] = out.get(key, 0) + t.numel() * t.element_size()
        elif isinstance(t, tuple):
            for x in t:
                walk(x)
    walk(cache)
    return out


def int8_serving(dev) -> dict:
    """Phase 4q: qwen1.5-4b at full width and depth through
    ``serve.load``'s model and weights (batch 4, ctx 2048, 16 tokens),
    served by that model (the bf16 cache) and by the model rebuilt with
    ``kv_cache_dtype="int8"``, in turns bf16, int8, int8, bf16, the
    counts set to 0 just before each run and read just after: exactly
    phase 4d's flash-attention and RMSNorm launches each run (the
    quantize and dequantize passes are plain PyTorch, as in JAX), finite
    logits, the cache's bytes from the prefill's tensors, the peak of
    each run (the weights included) and the int8 one at least 1 GiB
    lower, prefill seconds and decode ms a step, and how far the int8
    run's logits and greedy tokens are from the bf16 run's."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    model, params, batch = serve.load(INT8_ARCH, False, SERVE_BATCH,
                                      INT8_CTX, dev)
    cfg, cap = model.cfg, INT8_CTX + SERVE_GEN
    models = {"bf16": model, "int8": build_model(dataclasses.replace(
        cfg, kv_cache_dtype="int8"))}
    n = cfg.n_layers * 2 * SERVE_BATCH * cap * cfg.n_kv_heads
    want_bytes = {"bf16": {"bfloat16": n * cfg.hd * 2},
                  "int8": {"int8": n * cfg.hd, "float32": n * 4}}
    runs = {k: [] for k in models}
    for label in ("bf16", "int8", "int8", "bf16"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        res = serve.generate(models[label], params, batch, SERVE_GEN)
        counts = ops.launch_counts()
        res["peak"] = torch.cuda.max_memory_allocated(dev)
        runs[label].append(res)
        print(f"serve [{INT8_ARCH} {label} cache]: launches {counts}; "
              f"prefill {res['prefill_s']:.4f} s, decode "
              f"{res['decode_ms_per_step']:.3f} ms/step, peak memory "
              f"{res['peak'] / 2**30:.3f} GiB", flush=True)
        for name, k in counts.items():
            if k != INT8_LAUNCHES.get(name, 0):
                fail(f"[serve {INT8_ARCH} {label}] {name} launched {k} "
                     f"times, want {INT8_LAUNCHES.get(name, 0)}")
        if not torch.isfinite(res["logits"]).all():
            fail(f"[serve {INT8_ARCH} {label}] non-finite logits")
    got_bytes = {}
    for label, m in models.items():
        with torch.inference_mode():
            _, cache = m.prefill(params, batch, capacity=cap)
        got_bytes[label] = cache_bytes(cache)
        del cache
        if got_bytes[label] != want_bytes[label]:
            fail(f"[serve {INT8_ARCH} {label}] cache bytes "
                 f"{got_bytes[label]}, want {want_bytes[label]}")
    peak = {k: max(r["peak"] for r in v) for k, v in runs.items()}
    if not peak["bf16"] - peak["int8"] >= 2**30:
        fail(f"[serve {INT8_ARCH}] the int8 cache's peak {peak['int8']} B "
             f"is not 1 GiB below the bf16 cache's {peak['bf16']} B")
    # the logits' gap over the steps whose inputs agree: a request's
    # steps up to its first differing greedy token (the later ones are
    # fed other tokens)
    b16, i8 = runs["bf16"][0], runs["int8"][0]
    agree = int((i8["tokens"] == b16["tokens"]).sum())
    first = [int((i8["tokens"][r] != b16["tokens"][r]).nonzero()[0])
             if (i8["tokens"][r] != b16["tokens"][r]).any() else None
             for r in range(SERVE_BATCH)]
    diff = (i8["logits"] - b16["logits"]).abs().amax(-1)     # (gen, B)
    same_inputs = torch.ones_like(diff, dtype=torch.bool)
    for r, f in enumerate(first):
        if f is not None:
            same_inputs[f + 1:, r] = False
    gap = float(diff[same_inputs].max() / b16["logits"].abs().max())
    summary = dict(
        cache_bytes=got_bytes, peak_bytes=peak,
        prefill_s={k: [r["prefill_s"] for r in v] for k, v in runs.items()},
        decode_ms={k: [r["decode_ms_per_step"] for r in v]
                   for k, v in runs.items()},
        logit_gap_of_max=gap, tokens_agree=agree,
        tokens=SERVE_BATCH * SERVE_GEN, first_differing_step=first)
    print(f"serve [{INT8_ARCH}] int8 against bf16 cache: bytes "
          f"{got_bytes}; peaks {peak}; logits {gap:.4e} of max over the "
          f"steps fed the same tokens; greedy "
          f"tokens agree {agree} of {SERVE_BATCH * SERVE_GEN} (first "
          f"differing step per request {first})", flush=True)
    del model, models, params, batch, runs
    torch.cuda.empty_cache()
    return summary


def max_diff(a, b) -> float:
    """The largest |a - b| over two trees of tensors (or lists of
    floats), in f64."""
    from repro_torch.utils import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return max((float((torch.as_tensor(x).double()
                       - torch.as_tensor(y).double()).abs().max())
                for x, y in zip(la, lb)), default=0.0)


def remat_trainer(dev) -> dict:
    """Phase 4q: DCSGD-ASSS on granite at full width and depth (phase
    4m's run) for 3 steps with ``remat=True`` (its config: each layer
    rematerialised in the backward pass) and with ``remat=False``, from
    one seed, the counts set to 0 just before each run and read just
    after: the same kernel launches both ways, the losses, parameters and
    EF memory bit for bit (if they differ, a second ``remat=False`` run
    measures the card's run-to-run difference, and the remat run must be
    as close to one of the plain runs as they are to each other); the
    memory a gradient pass adds above the weights lower with remat; both
    step peaks and warm step times."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.utils import value_and_grad

    def one(remat):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        log, params, state = train.run(
            MOE_ARGS + ["--steps", str(REMAT_STEPS)], remat=remat)
        out = dict(counts=ops.launch_counts(), log=log,
                   peak=torch.cuda.max_memory_allocated(dev),
                   loss=[x["loss"] for x in log],
                   params=[p.cpu() for p in tree_leaves(params)],
                   memory=[m.cpu() for m in tree_leaves(state.memory)])
        print(f"trainer [{MOE_ARCH} remat={remat}]: launches "
              f"{out['counts']}; loss {out['loss']}; step_s "
              f"{[round(x['step_s'], 4) for x in log]}; peak memory "
              f"{out['peak'] / 2**30:.3f} GiB", flush=True)
        return out
    def grad_pass(remat):
        """The device memory one gradient pass adds above the weights
        (activations kept for the backward, recomputed ones, the
        gradients), on a batch of the trainer's shape."""
        cfg = dataclasses.replace(get_config(MOE_ARCH), remat=remat)
        model = build_model(cfg)
        params = model.init(0, device=dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        tokens = torch.randint(0, cfg.vocab_size, (8, 257), device=dev,
                               generator=gen)
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        grads = value_and_grad(lambda p: model.loss(p, {"tokens": tokens}),
                               params)[1]
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
        del model, params, grads
        torch.cuda.empty_cache()
        return peak
    grad_peak = {"remat": grad_pass(True), "plain": grad_pass(False)}
    print(f"gradient pass [{MOE_ARCH}, batch 8 x 256]: above the weights "
          f"{grad_peak['remat'] / 2**30:.3f} GiB with remat, "
          f"{grad_peak['plain'] / 2**30:.3f} GiB without", flush=True)
    if not grad_peak["remat"] < grad_peak["plain"]:
        fail(f"[{MOE_ARCH} remat] a gradient pass takes {grad_peak} B: "
             "rematerialisation saves nothing")
    on, off = one(True), one(False)
    if on["counts"] != off["counts"] or \
            on["counts"].get("ef_stats_telemetry") != REMAT_STEPS:
        fail(f"[{MOE_ARCH} remat] launches {on['counts']} with remat, "
             f"{off['counts']} without")
    if not all(np.isfinite(on["loss"])):
        fail(f"[{MOE_ARCH} remat] non-finite loss {on['loss']}")
    equal = on["loss"] == off["loss"] and trees_equal(
        on["params"], off["params"]) and trees_equal(on["memory"],
                                                     off["memory"])
    diffs = {}
    if not equal:
        off2 = one(False)
        for k in ("loss", "params", "memory"):
            diffs[k] = dict(
                remat=min(max_diff(on[k], off[k]), max_diff(on[k], off2[k])),
                run_to_run=max_diff(off2[k], off[k]))
        print(f"trainer [{MOE_ARCH}] remat differs from the plain run; "
              f"max |diff| {diffs}", flush=True)
        if any(d["remat"] > d["run_to_run"] for d in diffs.values()):
            fail(f"[{MOE_ARCH} remat] the remat run is further from the "
                 f"plain runs than they are from each other: {diffs}")
    # the step's peak comes after the backward (the exchange's and the
    # search's f32 copies of 1.385 B parameters), where no activation is
    # live either way: it is recorded, and the gradient pass above holds
    # what rematerialisation saves
    summary = dict(bit_equal=equal, diffs=diffs, grad_pass_bytes=grad_peak,
                   peak_bytes=dict(remat=on["peak"], plain=off["peak"]),
                   step_s=dict(remat=[x["step_s"] for x in on["log"]],
                               plain=[x["step_s"] for x in off["log"]]))
    print(f"trainer [{MOE_ARCH}] remat against plain: bit for bit "
          f"{equal}; step peaks {on['peak']} / {off['peak']} B "
          f"({(on['peak'] - off['peak']) / 2**20:+.3f} MiB with remat); "
          f"warm steps {summary['step_s']}", flush=True)
    del on, off
    torch.cuda.empty_cache()
    return summary


def cache_to(t, device):
    """A copy of a decode cache (named tuples of tensors) on ``device``."""
    if isinstance(t, torch.Tensor):
        return t.to(device, copy=True)
    if isinstance(t, tuple) and t:
        return type(t)(*(cache_to(x, device) for x in t))
    return t


def int8_smoke_card_vs_cpu(dev) -> dict:
    """Phase 5: the int8 smoke of each family with a self-attention cache
    (the vlm's gates live) through ``serve.load``'s model and weights,
    rebuilt with ``kv_cache_dtype="int8"``, on the card and on the CPU,
    ctx 96, 4 tokens.  Held as the CPU tests hold the port against JAX:
    the prefill's logits within 1e-4 of max, its int8 codes within 1 step
    and scales within 1e-5 of max, then each decode step on both devices
    from the CPU's cache, equal greedy tokens and logits within 1e-4 of
    max.  ``serve.generate`` free running on both is recorded beside it
    (a K/V value an ulp apart can round to the next code and move every
    later step)."""
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    cpu, ctx, gen, out = torch.device("cpu"), 96, 4, {}
    for arch in INT8_SMOKE:
        runs = {}
        for d in (dev, cpu):
            model, params, batch = serve.load(arch, True, 2, ctx, d)
            if "cross" in params:
                live_gates(params)
            runs[d.type] = (build_model(dataclasses.replace(
                model.cfg, kv_cache_dtype="int8")), params, batch)
        (gm, gp, gb), (cm, cp, cb) = runs["cuda"], runs["cpu"]
        errs, worst = [], 0.0
        with torch.inference_mode():
            glog, gcache = gm.prefill(gp, gb, capacity=ctx + gen)
            clog, ccache = cm.prefill(cp, cb, capacity=ctx + gen)
            code_step = max(int((g.cpu().int() - c.int()).abs().max())
                            for g, c in zip(gcache.kv[:2], ccache.kv[:2]))
            scale_err = max(float((g.cpu() - c).abs().max()
                                  / c.abs().max())
                            for g, c in zip(gcache.kv[2:], ccache.kv[2:]))
            for i in range(gen):
                err = float((glog.cpu() - clog).abs().max()
                            / clog.abs().max())
                errs.append(err)
                if not err <= 1e-4:
                    fail(f"int8 smoke {arch} step {i}: logits {err} of "
                         "max from the CPU's (limit 1e-4)")
                tok = clog[:, -1:].argmax(-1)
                if not torch.equal(glog[:, -1:].argmax(-1).cpu(), tok):
                    fail(f"int8 smoke {arch} step {i}: greedy tokens differ")
                if i == gen - 1:
                    break
                glog, _ = gm.decode_step(gp, tok.to(dev),
                                         cache_to(ccache, dev), ctx + i)
                clog, ccache = cm.decode_step(cp, tok, ccache, ctx + i)
            free = {k: serve.generate(m, p, b, gen)
                    for k, (m, p, b) in runs.items()}
            worst = float((free["cuda"]["logits"] - free["cpu"]["logits"])
                          .abs().max() / free["cpu"]["logits"].abs().max())
        if code_step > 1 or not scale_err <= 1e-5:
            fail(f"int8 smoke {arch} prefill cache: codes {code_step} steps"
                 f" apart, scales {scale_err} of max (limits 1, 1e-5)")
        out[arch] = dict(step_errs=errs, code_step=code_step,
                         scale_err=scale_err, free_running_err=worst,
                         free_running_tokens_equal=torch.equal(
                             free["cuda"]["tokens"], free["cpu"]["tokens"]))
        print(f"int8 smoke {arch} card vs cpu: logits {errs} of max "
              f"(limit 1e-4), tokens equal, prefill codes {code_step} step"
              f" apart, scales {scale_err:.3e} of max; free running: "
              f"logits {worst:.3e} of max, tokens equal "
              f"{out[arch]['free_running_tokens_equal']}", flush=True)
    return out


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def tp_pass(model, params, batch, gen: int, mesh=None, feed=None) -> dict:
    """A prefill and ``gen - 1`` decode steps under ``mesh``: each step
    takes ``feed``'s column (step-fed) where given, else the greedy
    token.  Returns the launch counts of the prefill and of the first
    decode step (each set to 0 just before), the logits (gen, B, vocab)
    and tokens (B, gen) on the host, prefill s and decode ms a step."""
    from repro_torch.kernels import ops
    B, ctx = batch["tokens"].shape
    vocab = model.cfg.vocab_size
    with torch.inference_mode():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, capacity=ctx + gen,
                                      mesh=mesh)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        counts = [ops.launch_counts()]
        toks = [logits[:, -1:, :vocab].argmax(-1)]
        outs = [logits[:, -1, :vocab]]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            tok = toks[-1] if feed is None else feed[:, i:i + 1].to(
                toks[-1].device)
            ops.reset_launch_counts()
            logits, cache = model.decode_step(params, tok, cache, ctx + i,
                                              mesh=mesh)
            if i == 0:
                counts.append(ops.launch_counts())
            toks.append(logits[:, -1:, :vocab].argmax(-1))
            outs.append(logits[:, -1, :vocab])
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) / max(gen - 1, 1) * 1e3
    return dict(counts=counts, logits=torch.stack(outs).float().cpu(),
                tokens=torch.cat(toks, dim=1).cpu(), prefill_s=prefill_s,
                decode_ms=decode_ms)


def tp_model(run, dev):
    """(model, weights, prompt) of a phase-4r run: ``serve.load``'s, in
    the run's parameter dtype (an f32 run draws the same values from
    seed 0 on the card, unrounded)."""
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    _, arch, _, _, ep, _, dtype = run[:7]
    model, params, batch = serve.load(arch, False, SERVE_BATCH, TP_CTX, dev)
    model = build_model(dataclasses.replace(
        model.cfg, moe_expert_parallel=ep, param_dtype=dtype,
        compute_dtype=dtype))
    if params["embed"]["w"].dtype != getattr(torch, dtype):
        del params
        params = model.init(0, device=dev, draw_device=dev)
    return model, params, batch


def tp_reference(model, params, batch, gen: int, halves: int) -> dict:
    """The one-process run of ``model`` on the whole batch, or on each of
    ``halves`` row blocks alone (tokens and logits joined back)."""
    if halves == 1:
        return tp_pass(model, params, batch, gen)
    n = SERVE_BATCH // halves
    parts = [tp_pass(model, params, {k: v[i * n:(i + 1) * n]
                                     for k, v in batch.items()}, gen)
             for i in range(halves)]
    return dict(parts[0], logits=torch.cat([p["logits"] for p in parts], 1),
                tokens=torch.cat([p["tokens"] for p in parts], 0),
                prefill_s=[p["prefill_s"] for p in parts],
                decode_ms=[p["decode_ms"] for p in parts])


def noise_floor(model, params, batch, gen: int, ref: dict) -> dict:
    """The one-process bf16 run's own sensitivity: the run again with
    every element of the embedding moved by one bf16 ulp (its bit
    pattern plus one), step-fed by ``ref``'s tokens (its logits' largest
    gap from ``ref``'s, of their max) and free-running (its greedy
    tokens equal to ``ref``'s)."""
    w = params["embed"]["w"]
    moved = dict(params, embed=dict(params["embed"], w=(
        w.view(torch.int16) + 1).view(w.dtype)))
    fed = tp_pass(model, moved, batch, gen, feed=ref["tokens"])
    free = tp_pass(model, moved, batch, gen)
    scale = float(ref["logits"].abs().max())
    return dict(logit_gap=float((fed["logits"] - ref["logits"]).abs().max())
                / scale,
                tokens_agree=int((free["tokens"] == ref["tokens"]).sum()),
                tokens=ref["tokens"].numel())


def tp_rank(rank: int, world: int, port: int, run, ref_tokens,
            out_dir: str) -> None:
    """One rank of a phase-4r run (a spawned process): its mesh, the
    whole tree from seed 0 cut to its slice, a free-running and a
    step-fed pass; its results saved to ``out_dir``."""
    import os
    import torch.distributed as dist
    from repro_torch import sharding
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import serve
    label, arch, shape, two_d, ep, gen = run[:6]
    os.environ["LOCAL_RANK"] = str(rank)
    dev = mesh_mod.resolve_device("cuda")
    backend = mesh_mod.backend_for(dev, world)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = mesh_mod.make_mesh(shape, mesh_mod.AXES_2D)
        model, params, batch = tp_model(run, dev)
        params, batch = serve.shard(model, params, batch, mesh, two_d)
        torch.cuda.empty_cache()
        out = dict(backend=backend, coords=mesh.coords, dp=mesh.dp_index,
                   weight_bytes=sharding.tensor_bytes(params),
                   resident=torch.cuda.memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)
        n = SERVE_BATCH // mesh.data_size
        out["free"] = tp_pass(model, params, batch, gen, mesh)
        out["fed"] = tp_pass(model, params, batch, gen, mesh,
                             feed=ref_tokens[mesh.dp_index * n:
                                             (mesh.dp_index + 1) * n])
        out["peak"] = torch.cuda.max_memory_allocated(dev)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def tp_serving(dev, smi: str) -> dict:
    """Phase 4r: each of TP_RUNS on two ranks sharing the card against
    the one-process run of the same model and weights."""
    import multiprocessing as mp
    import socket
    import tempfile
    from repro_torch.launch import mesh as mesh_mod
    summary = {}
    for run in TP_RUNS:
        label, _, shape, _, _, gen, dtype, want_bytes, want, gated = run
        gate, bound = gated
        model, params, batch = tp_model(run, dev)
        ref = tp_reference(model, params, batch, gen,
                           shape[0] if gate == "halves" else 1)
        floor = noise_floor(model, params, batch, gen, ref) \
            if dtype == "bfloat16" and gate != "halves" else None
        if gate == "floor":
            bound = TP_FLOOR_FACTOR * floor["logit_gap"]
        if floor is not None:
            print(f"4r [{label}]: noise floor, the one-process run with its "
                  f"embedding moved one bf16 ulp: step-fed logits "
                  f"{floor['logit_gap']:.4e} of max, greedy tokens agree "
                  f"{floor['tokens_agree']} of {floor['tokens']}",
                  flush=True)
        del model, params, batch
        torch.cuda.empty_cache()
        want_counts = [nonzero({k: v[i] for k, v in want.items()})
                       for i in (0, 1)]
        for got, w in zip(ref["counts"], want_counts):
            if nonzero(got) != w:
                fail(f"[4r {label}] the one-process run launched {got}, "
                     f"want {w}")
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            port = sk.getsockname()[1]
        print(f"4r [{label}]: mesh {shape} (data, model) on "
              f"{torch.cuda.device_count()} card(s), backend "
              f"{mesh_mod.backend_for(dev, 2)}; {smi}", flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            ctx = mp.get_context("spawn")
            procs = [ctx.Process(target=tp_rank, args=(
                r, 2, port, run, ref["tokens"], tmp)) for r in range(2)]
            for p in procs:
                p.start()
            t0 = time.perf_counter()
            for p in procs:
                p.join(timeout=max(1.0, TP_TIMEOUT
                                   - (time.perf_counter() - t0)))
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.kill()
                p.join()
            if alive or any(p.exitcode != 0 for p in procs):
                fail(f"[4r {label}] ranks exited {[p.exitcode for p in procs]}"
                     f" ({len(alive)} killed after {TP_TIMEOUT} s)")
            ranks = [torch.load(Path(tmp) / f"rank{r}.pt") for r in range(2)]
        scale = float(ref["logits"].abs().max())
        agree = total = 0
        rows = {}
        for r, res in enumerate(ranks):
            n = SERVE_BATCH // shape[0]
            sl = slice(res["dp"] * n, (res["dp"] + 1) * n)
            if res["weight_bytes"] != want_bytes:
                fail(f"[4r {label}] rank {r} holds {res['weight_bytes']} B of"
                     f" weights, want {want_bytes}")
            for kind in ("free", "fed"):
                for got, w in zip(res[kind]["counts"], ref["counts"]):
                    if got != w:
                        fail(f"[4r {label}] rank {r} ({kind}) launched {got},"
                             f" the one-process run {w}")
            fed = res["fed"]["logits"]
            if not torch.isfinite(fed).all() or \
                    not torch.isfinite(res["free"]["logits"]).all():
                fail(f"[4r {label}] rank {r}: non-finite logits")
            gap = float((fed - ref["logits"][:, sl]).abs().max()) / scale
            if not gap <= bound:
                fail(f"[4r {label}] rank {r}: step-fed logits {gap:.4e} of "
                     f"max from the one-process run's (bound {bound:.4e}, "
                     f"{gate})")
            if res["coords"][1] == 0:
                same_tok = res["free"]["tokens"] == ref["tokens"][sl]
                agree, total = agree + int(same_tok.sum()), \
                    total + same_tok.numel()
            rows[r] = dict(coords=res["coords"], backend=res["backend"],
                           weight_bytes=res["weight_bytes"],
                           resident_bytes=res["resident"],
                           peak_gib=res["peak"] / 2**30, logit_gap=gap,
                           prefill_s=[res[k]["prefill_s"]
                                      for k in ("free", "fed")],
                           decode_ms=[res[k]["decode_ms"]
                                      for k in ("free", "fed")])
            print(f"4r [{label}] rank {r} {res['coords']} ({res['backend']}):"
                  f" weights {res['weight_bytes']} B, resident "
                  f"{res['resident'] / 2**30:.3f} GiB, peak after the slice "
                  f"{res['peak'] / 2**30:.3f} GiB; prefill "
                  f"{rows[r]['prefill_s']} s, decode {rows[r]['decode_ms']} "
                  f"ms/step (free, fed); launches "
                  f"{[nonzero(c) for c in res['free']['counts']]}; "
                  f"step-fed logits {gap:.4e} of max", flush=True)
        if total != SERVE_BATCH * gen or (gate != "floor"
                                          and 8 * agree < 7 * total):
            fail(f"[4r {label}] {agree} of {total} greedy tokens equal the "
                 f"one-process run's (want 7 in 8 of {SERVE_BATCH * gen})")
        summary[label] = dict(ranks=rows, tokens_agree=agree, tokens=total,
                              gate=gate, logit_bound=bound,
                              noise_floor=floor,
                              one_process=dict(prefill_s=ref["prefill_s"],
                                               decode_ms=ref["decode_ms"]))
        how = (f"logits gated at {bound:.4e} of max against the one-process"
               f" run of " + ("the whole batch" if gate == "whole"
                              else "each data half") + ", tokens at 7 in 8"
               if gate != "floor" else f"logits gated at {bound:.4e} of "
               f"max, {TP_FLOOR_FACTOR} times the noise floor's; tokens "
               f"recorded beside the noise floor's")
        print(f"4r [{label}]: greedy tokens agree {agree} of {total} "
              f"({how}); the one-process run: prefill {ref['prefill_s']} s,"
              f" decode {ref['decode_ms']} ms/step", flush=True)
    return summary


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script runs only on "
             "a machine with an NVIDIA GPU")
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    from repro_torch.comm.bucket import build_bucket_plan
    from repro_torch.configs import get_config
    from repro_torch.core.acgd import AcgdConfig, acgd
    from repro_torch.core.armijo import ArmijoConfig
    from repro_torch.core.compression import Compressor
    from repro_torch.core.csgd import CSGDConfig, csgd_asss
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import ef_topk, wire_pack
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.utils import tree_flatten

    # ---- 1. the card ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()),
          flush=True)
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # ---- 3. kernels against their plain versions at main-path shapes ----
    cfg = get_config("paper-lm-100m")
    comp = Compressor(gamma=0.01, method="block_topk")
    params = lm.init_params(cfg, seed=0, device=dev)
    leaves, _ = tree_flatten(params)
    stacked = tree_flatten(lm.stacked_mask(params))[0]
    shapes = [tuple(p.shape) for p in leaves]
    del params, leaves
    plan = build_bucket_plan(shapes, stacked, comp)
    rows = sum(ln.L * -(-ln.d // comp.block) for ln in plan.leaves
               if not ln.dense)
    k_b = comp.block_k()
    # k_b at the paper's gamma of 1%, 4% and 10%: 10, 41 and 102
    paper_ks = [Compressor(gamma=gm, method="block_topk").block_k()
                for gm in (0.01, 0.04, 0.1)]
    gen = torch.Generator(device=dev).manual_seed(1)
    m = torch.randn((rows, 1024), generator=gen, device=dev) * 1e-3
    g = torch.randn((rows, 1024), generator=gen, device=dev) * 1e-2
    eta = torch.tensor([0.0345], device=dev)
    report = {}

    tau, mom = ef_topk.ef_stats_telemetry(m, g, eta, k_b)
    rtau, rmom = ref.ef_block_stats_telemetry(m, g, eta, k_b)
    torch.cuda.synchronize()
    if not torch.equal(tau, rtau):
        fail(f"ef_stats_telemetry tau differs from the plain version in "
             f"{int((tau != rtau).sum())} of {rows} rows")
    ulp = max_ulp(mom.cpu().numpy(), rmom.cpu().numpy())
    if ulp > 8:
        fail(f"ef_stats_telemetry moments are {ulp} ulp from the plain "
             "version (limit 8)")
    report["ef_stats_telemetry"] = dict(
        max_abs_err=float((mom - rmom).abs().max()),
        ms=time_ms(lambda: ef_topk.ef_stats_telemetry(m, g, eta, k_b)),
        plain_ms=time_ms(lambda: ref.ef_block_stats_telemetry(m, g, eta,
                                                              k_b)),
        bytes=rows * 1024 * 8 + rows * 12,
        # the function's work per element: the fma forming acc, |acc| and
        # the two squares (done in f64 here, counted as f32)
        ops=rows * 1024 * 6,
        note=f"moments max {ulp} ulp")

    sent, mnew = ef_topk.ef_apply(m, g, eta, tau)
    rsent, rmnew = ref.ef_block_update(m, g, eta, rtau)
    torch.cuda.synchronize()
    if not (torch.equal(sent, rsent) and torch.equal(mnew, rmnew)):
        fail("ef_apply differs from the plain version")
    if not torch.equal(sent + mnew, ref.ef_acc(m, g, eta)):
        fail("ef_apply breaks the EF identity sent + m' == fma(eta, g, m)")
    kept = float((sent != 0).sum()) / rows
    report["ef_apply"] = dict(
        max_abs_err=max(float((sent - rsent).abs().max()),
                        float((mnew - rmnew).abs().max())),
        ms=time_ms(lambda: ef_topk.ef_apply(m, g, eta, tau)),
        plain_ms=time_ms(lambda: ref.ef_block_update(m, g, eta, tau)),
        bytes=rows * 1024 * 16 + rows * 4, ops=rows * 1024 * 5,
        note=f"{kept:.2f} kept per block row (k_b={k_b})")

    # ef_block_stats through its only path, the per-leaf fused op without
    # moments, at the same rows; the counts of that call are its launches
    ops.reset_launch_counts()
    sent, mnew, btau = ops.fused_ef_compress(m, g, eta, comp.gamma,
                                             telemetry=False)
    ef_block_counts = ops.launch_counts()
    rbtau = ref.ef_block_stats(m, g, eta, k_b)
    torch.cuda.synchronize()
    want = dict.fromkeys(ef_block_counts, 0)
    want.update(ef_block_stats=1, ef_apply=1)
    if ef_block_counts != want:
        fail(f"fused_ef_compress(telemetry=False) launched "
             f"{ef_block_counts}, want {want}")
    if not same(btau, rbtau) or not same(btau, rtau):
        fail("ef_block_stats differs from the plain version")
    if not torch.equal(sent, rsent) or not torch.equal(mnew, rmnew):
        fail("fused_ef_compress(telemetry=False) differs from the plain "
             "versions")
    report["ef_block_stats"] = dict(
        max_abs_err=float((btau - rbtau).abs().max()),
        ms=time_ms(lambda: ef_topk.ef_block_stats(m, g, eta, k_b)),
        plain_ms=time_ms(lambda: ref.ef_block_stats(m, g, eta, k_b)),
        bytes=rows * 1024 * 8 + rows * 4, ops=rows * 1024 * 3,
        note="through ops.fused_ef_compress(telemetry=False)")
    # both EF pass-1 kernels at the paper's 1%, 4% and 10%: checked, then
    # timed with the host's launch and on the device alone
    for kb in paper_ks:
        t1, mom1 = ef_topk.ef_stats_telemetry(m, g, eta, kb)
        t2 = ef_topk.ef_block_stats(m, g, eta, kb)
        rt, rm = ref.ef_block_stats_telemetry(m, g, eta, kb)
        ulp = max_ulp(mom1.cpu().numpy(), rm.cpu().numpy())
        if not (same(t1, rt) and same(t2, rt)) or ulp > 8:
            fail(f"EF pass 1 at k_b={kb} differs from the plain version: "
                 f"tau in {int((t1 != rt).sum())} and {int((t2 != rt).sum())}"
                 f" of {rows} rows, moments {ulp} ulp (limit 8)")
        del t1, mom1, t2, rt, rm
        print(f"EF pass 1 ({rows}, 1024) k_b={kb}: bit-exact, moments "
              f"{ulp} ulp; ef_stats_telemetry "
              f"{time_ms(lambda: ef_topk.ef_stats_telemetry(m, g, eta, kb)):.4f}"
              f" ms, device only "
              f"{device_ms(lambda: ef_topk.ef_stats_telemetry(m, g, eta, kb)):.4f}"
              f" ms; ef_block_stats "
              f"{time_ms(lambda: ef_topk.ef_block_stats(m, g, eta, kb)):.4f} "
              f"ms, device only "
              f"{device_ms(lambda: ef_topk.ef_block_stats(m, g, eta, kb)):.4f}"
              " ms", flush=True)
    del m, g, sent, mnew, rsent, rmnew, tau, rtau, mom, rmom, btau, rbtau

    check_wire(dev, gen, shapes, stacked, report)
    check_ragged_wire(dev, gen, shapes, stacked, report)

    csgd_rows = [-(-int(np.prod(sh)) // comp.block) for sh in shapes
                 if int(np.prod(sh)) >= comp.min_compress_size]
    check_dense_selection(dev, gen, csgd_rows, k_b, paper_ks, report)
    check_serving_kernels(dev, report)
    # flash without causality at seamless-m4t's shapes (reported in 4o)
    encdec_flash = check_encdec_flash(dev)
    for name, r in report.items():
        byte_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = r["ops"] / r.get("ops_per_s", F32_OPS_PER_S) * 1e3
        r["bound_ms"] = max(byte_ms, ops_ms)
        r["bound_by"] = "bytes" if byte_ms >= ops_ms else "operations"
        lib = (f", library {r['library_ms']:.4f} ms"
               if r.get("library_ms") is not None else "")
        print(f"kernel {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} "
              f"ms{lib}, bound {r['bound_ms']:.4f} ms by {r['bound_by']}: "
              f"{r['bytes']} B, {r['ops']} ops; {r['note']})", flush=True)

    # ---- 4. the trainer at full width through the kernels ---------------
    runs = {}
    one_codec = dict(ef_stats_telemetry=1, ef_apply=1, pack_words=1,
                     unpack_words=1)
    for label, gamma, bits, steps, per_step in (
            ("main", 0.01, 32, MAIN_STEPS, one_codec),
            ("value-bits 8", 0.01, 8, VB8_STEPS,
             dict(ef_stats_telemetry=1, ef_apply=1, pack_words=2,
                  unpack_words=2)),
            ("gamma 0.1", 0.1, 32, G10_STEPS, one_codec)):
        want_bytes = step_wire_bytes(shapes, stacked, Compressor(
            gamma=gamma, method="block_topk", value_bits=bits))
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        log = train.main(MAIN_ARGS + ["--gamma", str(gamma), "--value-bits",
                                      str(bits), "--steps", str(steps)])
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        runs[label] = counts
        print(f"trainer [{label}]: launches {counts}; step_s "
              f"{[round(x['step_s'], 4) for x in log]}; wire bytes "
              f"{[x['wire_bytes'] for x in log]} (want {want_bytes}); "
              f"n_evals {[x['n_evals'] for x in log]}; peak memory "
              f"{peak / 2**30:.2f} GiB", flush=True)
        for name, n in counts.items():
            if n != per_step.get(name, 0) * steps:
                fail(f"[{label}] {name} launched {n} times in {steps} "
                     f"steps, want {per_step.get(name, 0) * steps}")
        if not all(np.isfinite(x["loss"]) for x in log):
            fail(f"[{label}] non-finite loss: {[x['loss'] for x in log]}")
        if any(x["wire_bytes"] != want_bytes for x in log):
            fail(f"[{label}] wire bytes {[x['wire_bytes'] for x in log]} "
                 f"!= accounted {want_bytes}")
        if any(x["steps_skipped"] for x in log):
            fail(f"[{label}] steps were skipped by the finite check")

    # ---- 4b. where one step's device time goes ---------------------------
    profile_step(dev, cfg, comp)
    profile_step(dev, cfg, Compressor(gamma=0.1, method="block_topk"),
                 "trainer gamma 0.1")

    # ---- 4c. single-node CSGD-ASSS at full width through its kernels -----
    csgd_counts = run_single(dev, cfg, comp, CSGD_STEPS, "csgd",
                             lambda c: csgd_asss(CSGDConfig(
                                 armijo=ArmijoConfig(), compressor=c)))

    # ---- 4d. serving at full width through its kernels -------------------
    serve_counts, serve_logits = run_serving(dev)

    # ---- 4e. the adaptive trainer: the ragged codec on a trainer path ---
    adaptive_counts = adaptive_trainer(dev, shapes, stacked)
    transports_agree(dev, cfg)
    profile_step(dev, cfg, Compressor(gamma=0.04, method="block_topk",
                                      max_gamma=0.1, value_bits=8),
                 "adaptive perleaf, gamma_t 0.04", transport="perleaf")

    # ---- 4f. the other optimizer kinds, microbatches, the breaker -------
    kinds_trainer(dev, shapes)
    profile_step(dev, cfg, comp, "trainer nonadaptive", kind="nonadaptive")
    profile_step(dev, cfg, comp, "trainer microbatches 2", microbatches=2)

    # ---- 4g. local steps, bf16 EF memory, checkpoints --------------------
    runtime_trainer(dev, root)
    profile_step(dev, cfg, comp, "trainer local steps 2", microbatches=2,
                 local_steps=2)

    # ---- 4h. ACGD and the compressed downlink ---------------------------
    acgd_downlink_trainer(dev)
    check_roundtrip(dev, gen, shapes, stacked)
    profile_downlink(dev, cfg)
    run_single(dev, cfg, comp, ACGD_SINGLE_STEPS, "acgd single-node",
               lambda c: acgd(AcgdConfig(compressor=c, eta=0.1,
                                         momentum=0.9)))

    # ---- 4i. the overlap transport: chunked ring, delay-1 double buffer --
    overlap_trainer(dev, root)
    profile_step(dev, cfg, comp, "trainer overlap delay 1",
                 transport="overlap")

    # ---- 4j. the gossip transport at one worker -------------------------
    gossip_trainer(dev, root)
    profile_gossip(dev, cfg, comp)

    # ---- 4k. the hostile wire: verdicts, quarantine, fault injection ----
    fault_summary = fault_trainer(dev, root)

    # ---- 4l. the federated cohort: 4 clients, 3 a round ------------------
    cohort_summary = cohort_trainer(dev, root)
    profile_cohort(dev, cfg)

    # ---- 4m. the MoE family: GQA flash, serving, the trainer ------------
    check_gqa_flash(dev)
    moe_serving(dev, serve_logits[MOE_ARCH])
    moe_summary = moe_trainer(dev)
    moe_card_vs_cpu(dev)

    # ---- 4n. the hybrid family: flash at D 112, zamba2-7b ---------------
    hybrid_summary = check_hybrid_kernels(dev)
    hybrid_summary["serve"] = hybrid_serving(dev)
    hybrid_summary["trainer"] = hybrid_trainer(dev)
    hybrid_card_vs_cpu(dev)

    # ---- 4o. the encoder-decoder family: non-causal flash, seamless ------
    encdec_summary = dict(flash=encdec_flash)
    encdec_summary["serve"] = encdec_serving(dev)
    encdec_summary["trainer"] = encdec_trainer(dev)
    encdec_card_vs_cpu()

    # ---- 4p. the vlm family: gated cross attention, llama-3.2-vision ----
    # its trainer peaks near the card's size: what the earlier phases
    # still hold
    torch.cuda.empty_cache()
    print(f"device memory before phase 4p: "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB allocated, "
          f"{torch.cuda.memory_reserved(dev) / 2**30:.3f} GiB reserved",
          flush=True)
    vlm_summary = dict(kernels=check_vlm_kernels(dev))
    vlm_summary["serve"] = vlm_serving(dev)
    vlm_summary["trainer"] = vlm_trainer(dev)
    vlm_card_vs_cpu()

    # ---- 4q. the int8 KV cache and rematerialisation ---------------------
    int8_summary = dict(serve=int8_serving(dev))
    int8_summary["remat"] = remat_trainer(dev)

    # ---- 4r. the model axis for serving: two ranks on the card ----------
    torch.cuda.empty_cache()
    tp_summary = tp_serving(dev, smi)

    # ---- 5. small input: the card against the CPU's plain path ----------
    small = ["--smoke", "--steps", "2", "--seq-len", "33", "--global-batch",
             "4", "--compress-method", "block_topk", "--log-every", "1"]
    for label, extra in (
            ("csgd_asss", []), ("nonadaptive", ["--opt", "nonadaptive"]),
            ("sls", ["--opt", "sls"]),
            ("local steps 2", ["--local-steps", "2", "--microbatches", "2"]),
            ("ef-dtype bfloat16", ["--ef-dtype", "bfloat16"]),
            ("acgd", ["--opt", "acgd"]),
            ("downlink compressed", ["--downlink", "compressed"]),
            ("overlap delay 1", ["--transport", "overlap",
                                 "--overlap-chunks", "3"]),
            ("overlap delay 0", ["--transport", "overlap",
                                 "--overlap-delay", "0"]),
            ("gossip", ["--transport", "gossip"]),
            ("fault bitflip 0.1", ["--fault-bitflip", "0.1"]),
            ("cohort", ["--n-clients", "4", "--clients-per-round", "3"])):
        on_card = train.main(small + extra)
        on_cpu = train.main(small + extra + ["--device", "cpu"])
        for a, b in zip(on_card, on_cpu):
            if abs(a["loss"] - b["loss"]) > 1e-4 * abs(b["loss"]) or any(
                    a.get(k) != b.get(k) for k in (
                        "wire_bytes", "downlink_effective_wire_bytes",
                        "cum_effective_wire_bytes", "staleness",
                        "rows_quarantined", "steps_skipped")):
                fail(f"{label} smoke run on the card {a} disagrees with "
                     f"the CPU {b}")
        print(f"{label} smoke card vs cpu: losses "
              f"{[x['loss'] for x in on_card]} vs "
              f"{[x['loss'] for x in on_cpu]}; rows_quarantined "
              f"{[x['rows_quarantined'] for x in on_card]}", flush=True)
    adaptive = small + ["--transport", "perleaf", "--max-gamma", "0.1",
                        "--gamma-schedule", "linear", "--gamma-ramp-steps",
                        "1"]
    on_card = train.main(adaptive)
    on_cpu = train.main(adaptive + ["--device", "cpu"])
    for a, b in zip(on_card, on_cpu):
        if abs(a["loss"] - b["loss"]) > 1e-4 * abs(b["loss"]) or any(
                a[k] != b[k] for k in ("gamma", "wire_bytes",
                                       "effective_wire_bytes")):
            fail(f"adaptive perleaf smoke on the card {a} disagrees with "
                 f"the CPU {b}")
    print(f"adaptive perleaf smoke card vs cpu: losses "
          f"{[x['loss'] for x in on_card]} vs {[x['loss'] for x in on_cpu]},"
          f" effective bytes {[x['effective_wire_bytes'] for x in on_card]}",
          flush=True)
    smoke_trainer_card_vs_cpu(ZAMBA)
    csgd_smoke(dev)
    serve_smoke(dev)
    int8_summary["smoke"] = int8_smoke_card_vs_cpu(dev)

    # ---- 6. results -----------------------------------------------------
    # launches: each kernel's count on the path that runs it — the
    # trainer, single-node CSGD, fused_ef_compress(telemetry=False), the
    # qwen1.5-4b serve run (flash attention, RMSNorm), the rwkv6-1.6b one
    # (WKV) or the adaptive perleaf trainer (the ragged codec)
    launches = dict(runs["main"])
    launches.update(block_stats=csgd_counts["block_stats"],
                    threshold_split=csgd_counts["threshold_split"],
                    ef_block_stats=ef_block_counts["ef_block_stats"],
                    flash_attention=serve_counts["qwen1.5-4b"][
                        "flash_attention"],
                    rmsnorm=serve_counts["qwen1.5-4b"]["rmsnorm"],
                    wkv_forward=serve_counts["rwkv6-1.6b"]["wkv_forward"],
                    pack_words_ragged=adaptive_counts["pack_words_ragged"],
                    unpack_words_ragged=adaptive_counts[
                        "unpack_words_ragged"])
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"],
                    library_ms=r.get("library_ms"))
               for name, r in report.items()]
    # phase 4k's times again, where the end of the output keeps them
    print("faults summary (guarded, unguarded): "
          + json.dumps(fault_summary), flush=True)
    print("cohort summary: " + json.dumps(cohort_summary), flush=True)
    print("moe summary: " + json.dumps(moe_summary), flush=True)
    print("hybrid summary: " + json.dumps(hybrid_summary), flush=True)
    print("encdec summary: " + json.dumps(encdec_summary), flush=True)
    print("vlm summary: " + json.dumps(vlm_summary), flush=True)
    print("int8 and remat summary: " + json.dumps(int8_summary), flush=True)
    print("model axis summary: " + json.dumps(tp_summary), flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --probe-cpu-reference   # phase 10's cpu ranks
                                                  # under other settings

Phases (each prints its lines; any failure exits non-zero, and there is no
CPU path — without a CUDA device the script fails):

1. device: name, count, the host's CPU count, model and ISA flags, ATen
   CPU capability and torch threads, and ``nvidia-smi`` name + power
   limit;
2. build: compile every kernel library from the sources in the checkout
   with ``nvcc`` (one process each, all started together, with two
   scratch builds of fused_collectives.cu for a measurement; phase 4,
   which needs none of fused_collectives.cu's three, runs while they
   finish, and phase 3 starts once all are built) and print
   each kernel's ``-Xptxas -v`` registers, spills and shared memory, with
   a summary of the Hopper kernels: the fused collectives' wgmma_kernel
   (rows 7-9), the flash kernels and the paged tile (fp and quantized
   pools), split and combine kernels (registers, spills, dynamic shared
   memory; a spill there fails
   the script);
3. kernels: paged attention against its plain PyTorch version on the card
   at the serving path's shapes and at tile and lane cases (chunks that
   are no multiple of 64 or start mid-page, two sequences in one 64-lane
   window, blocks 8-64, windows, 1 and 16 decode lanes, and phase 6g's
   OPT-6.7B (32 heads of 128) and GPT-2 XL (25 heads of 64) shapes with
   decode lanes and a prefill chunk), with stated
   tolerances (TF32 is off for both cuBLAS and cuDNN), each run twice for
   bitwise-equal outputs and failing unless tile items and lane items ran
   exactly where the work list has them; then, at a decode and a prefill
   shape, timed with CUDA events (L2 flushed before every call) beside
   the per-(token, kv-head) kernel they replaced, the plain version and
   the bound; the same over int8 and int4 pools (with the tile cases in
   bf16 and fp16 q on ``paged_tile_quant_kernel``; the prefill timed also
   with every lane on lane items, beside the replaced quantized-pool
   kernel); blockwise quantize and dequantize
   bitwise against their plain versions (fp32/bf16/fp16, bits 8/4,
   blocks 128/256, row counts that are not multiples of 32, path A's
   weight shapes), timed at [4096, 11008] bf16;
   fused collectives: dequant_matmul, matmul_pallas and matmul_quantize
   against their plain versions on the mma.sync / FMA kernels (fp32/bf16
   shapes the Hopper predicates refuse, int8/int4, trans_a, m = 1, a row
   length the block does not divide, integer-valued cases bitwise), then
   rows 7 and 8 on the Hopper kernel (TMA + wgmma: bf16/fp16, int8/int4
   at blocks 256/64/96, ragged m, n and k, integer-valued cases bitwise,
   each twice and into a column slice, every launch counted on
   ``.wgmma_launches``) and row 9 on it (bf16/fp16, trans_a both ways,
   int8/int4, blocks 256/128/64/32, ragged rows, n and k, integer-valued
   cases bitwise, each thrice, two refused cases on the mma.sync kernel);
   each row timed at the ZeRO-3 path's shapes beside one PyTorch call
   (on the Hopper kernel, with TFLOP/s; row 9 also beside PR 4's mma.sync
   kernel, in turns) and compared there too (rows 7 and 8 also into a
   column slice of the ring's gathered output, as the fused backend
   writes them; row 9 twice bitwise); row 7's converter share from two
   scratch builds;
   flash: the forward, dq and dk/dv kernels through
   ``flash_attention_op`` against their plain versions (22 cases: the
   1b shape in bf16 at the training shape's micro-batch 4 and in
   fp16/fp32, d 128 (8d (c)'s Llama-2-7B shape, GQA groups 1, 4 and 8,
   sq > skv) and d 256, non-causal, sq < skv, sq > skv, odd lengths,
   windows, phase 6h's encoder shapes: non-causal at 257, 77 and 512,
   causal at 77), the training shape and 8d (c)'s twice for
   bitwise-equal results; each case logs which kernels took it and fails
   unless the Hopper forward ran exactly where
   ``flash_forward_wgmma_path`` accepts it and the Hopper dq and dk/dv
   kernels (TMA + wgmma) exactly where ``flash_wgmma_path`` does; then
   each kernel timed at the training shape and at 8d (c)'s (d 128)
   beside its bound, its plain version, ``scaled_dot_product_attention``
   as a yardstick and the mma.sync kernel it replaced, in turns;
4. engine: a 2-layer Llama-2-7B-width engine (d_model 4096) in fp32, the
   same weights on cuda and on cpu, one ``put`` of 3 mixed-length prompts;
   logits must agree within 1e-3; then path B (int8 and int4 KV pools, in
   fp32 and bf16; a cpu engine fed the cuda engine's K/V isolates the
   quantizer's level flips) and path A (``init_inference`` with int8 and
   int4 weights) at the same width, cuda against cpu: quantized weights
   and dequantized weights bitwise equal, logits within stated
   tolerances, greedy tokens identical in fp32;
5. serving: Llama-2-7B at full width and depth (bf16, seeded random
   weights) behind ``ServingEngine`` (FCFS) over ``RaggedInferenceEngine``,
   8 requests to completion; kernel launch counts are reset just before
   and read just after (the puts with prefill runs must have taken tile
   items, the rest lane items);
5b. paged mixed put: layer 0's paged-attention call of a serving put that
   holds decode lanes and a prefill chunk, compared and timed as the
   phase 3 shapes are;
6. profile: the same requests again under ``torch.profiler``: device time
   by kernel and the device's idle share; then the same 8 requests over an
   int8 and an int4 KV pool at the bf16 pool's byte budget (path B; their
   prefill puts on tile items too), the int8 run profiled too;
6b. speculative serving and the KV hand-off on the same model: 8
   requests of draftable prompts (random segments repeated in place)
   through ``ServingEngine`` with ``serving.speculative`` on, then off,
   launches counted from 0 for each (every put and verify put on one
   paged launch a layer); streams identical, or a near-tie within the
   verify error; ``put_spec`` driven directly over the bf16 pool and an
   int8 pool (oracle drafts accepted, random drafts rejected and trimmed,
   verify rows against put of the same contexts), layer 0's verify paged
   call compared with the plain version twice and timed beside its bound;
   ``export_kv`` -> ``import_kv`` and ``export_prefix`` ->
   ``import_prefix`` between two engines over bf16 and int8 pools
   (identical tokens, bitwise pages, equal checksums, only the suffix
   scheduled); sampled ``generate`` (temperature 0.8, top-k 50, top-p
   0.9), seeded and chunk-invariant;
6c-6e run Llama-2-7B's width at 8 of its 32 layers (``SHALLOW_LAYERS``,
   time; each phase makes its own single-engine references);
6c. replicas: two ``ServingEngine`` replicas over 512-page engines on
   the same Llama-2-7B, phase 5's 8 requests: (a) with the JSON-lines
   request sink, tracing and a fault injector on (valid records, TTFT p50
   from the records within 5 % of the host clock's, trace trees and the
   Chrome trace without problems), then off / on interleaved for the
   cost; (f) every put's batch build and block tables on the native host
   library (``csrc/ragged_host.cpp``), timed against numpy; (b) kill ->
   ``migrate_out`` -> ``adopt``, bf16 and int8 pairs, streams equal an
   uninterrupted run up to near-ties, export / import ms and bytes; (c)
   kill -> ``evacuate`` -> resubmit; (e) the preemption latch, an
   injected tick fault, the stuck-tick watchdog; (d) ``hot_swap``: a
   corrupt and a failing load keep version 0, a seed-1 load serves a
   fresh seed-1 engine's streams bitwise after 2 warm-up ticks; (g) the
   phase's paged launches (from 0), tile and lane items;
6d. fleet: ``ServingFleet`` over Llama-2-7B replicas (one shared model,
   a fresh 512-page engine per replica): (a) 3 replicas, prefix-affinity
   routing, driver and monitor threads, 16 requests from 4 shared
   512-token prefixes (routed counts, each prefix on one replica,
   prefix-cache hit tokens, TTFT p50 / max, tokens/s, streams equal a
   single-engine run up to near-ties, no leak); (c) the same traffic
   again and ``kill_replica`` mid-decode: orphans fail over, all finish;
   (b) 1 prefill + 3 decode replicas: phase 5's 8 requests hand off
   through ``export_kv`` / ``import_kv`` (ms and bytes per hand-off);
   (d) int8 pools: ``scale_to(4)``, ``scale_to(2)`` under load (the
   drained replicas serve out), one ``autoscale_once`` against
   ``compute_serving_replicas``; (e) a hedge against a replica the
   fault injector slows 8x (the shadow wins, the loser's span is
   suppressed, one record per client request); (g) the phase's paged
   launches (from 0), tile and lane items, peak memory;
6e. region: a ``Region`` of Llama-2-7B cells on the same model (a fresh
   512-page engine per replica): (a) 2 cells x 2 prefix-affinity
   replicas with the monitor and driver threads, 6d (a)'s 16 requests
   (each prefix on one cell and replica, prefix-cache hit tokens, TTFT
   p50 / max, tokens/s, streams equal a single-engine run up to
   near-ties, no leak); (b) the same traffic again and ``kill_cell`` on
   the busiest cell mid-decode: its orphans finish on the other cell;
   (c) 2 cells x (1 prefill + 1 decode), cell-0's decode replica dead,
   the cells severed while hand-offs are in flight (``CellUnreachable``,
   hand-offs decoded on cell-0's prefill replica, cell-1 serving its own
   while unreachable), then a heal and a rebalance of the requests
   queued meanwhile; (d) ``start_rollout(2, load_fn)`` to a second
   Llama-2-7B's weights under traffic, to DONE (no stream mixes
   versions, v2 streams equal a single-engine run on v2 up to
   near-ties), then a rollout with an injected canary SLO regression
   that rolls back; (e) the phase's paged launches (from 0), tile and
   lane items, peak memory;
6f. tensor-parallel serving: 2 rank processes on the one card over gloo,
   each building the seed-0 Llama-2-7B at 8 of its 32 layers (time; one
   rank at a time) and cutting it to its shard (16 of 32 heads, half of
   d_ff and of the vocab, half of every page's KV heads); rank 0 is the
   controller, rank 1 replays its step records (``serve_worker``). (a)
   ``ServingEngine`` over a 512-page bf16 TP engine, phase 5's 8
   requests: streams equal one card's at that depth (512-page replicas
   made first) up to near-ties, each rank's paged launches one a layer a put
   (tile items for the prefills), layer 0's put held against the plain
   version at the rank's shape and timed, no leak, TTFT, tokens/s, the
   share of a put in the model group's host-staged collectives, peak
   memory a rank; (b) the same over an int8 pool, 4 requests; (c) v1
   ``init_inference(tensor_parallel=2, kernel_backend="pallas")``, 4 x
   128 tokens, 32 new: tokens equal a tp-1 run up to near-ties, one
   fused ``decode_mlp_all_reduce`` and one row-8 launch a layer for each
   decode step on each rank; (d) row 8 at that decode shape, [4, 5504]
   x [5504, 4096] bf16, timed beside its bound and ``torch.mm``;
6g. families: (a) OPT-6.7B and (b) GPT-2 XL (25 heads of head_dim 64)
   at full width and depth, seeded random bf16 weights with every bias
   and norm term drawn, each behind ``ServingEngine`` over
   ``RaggedInferenceEngine`` as phase 5 serves Llama-2-7B (8 requests, 32
   new tokens, a pool of phase 5's bytes, launches counted from 0, tile
   items in the prefill puts, one put's logits finite at the model's
   vocabulary), then layer 0's paged call of a mixed put against the
   plain version and timed as in 5b; (c) ``init_inference`` of the same
   OPT-6.7B, bf16 then int8 weights (group 256): path A's 4 x 128-token
   prompts, 32 new tokens, quantize / dequantize launches counted over
   the flag set's leaves (biases, norm biases, ``pos_embed``, the tied
   ``tok_embed``), payloads, scales and dequantized weights bitwise the
   plain versions';
6h. encoders: (e) first: 2-layer BERT-large- and CLIP-L/14-width models
   in fp32, the same weights on cuda and cpu (MLM logits plain and padded
   with segments, text / image embeddings, the similarity within 1e-3),
   then the BERT model in bf16 on the card against the cpu fp32 hidden
   states, which sets (b)'s tolerance; (a) BERT-large (seeded bf16 weights,
   every bias and norm term drawn) through ``init_inference``: 10 timed
   forwards of 32 x 512 ids (sequences/s, ms, peak memory), flash
   launches counted from 0 (24 a forward, all on the Hopper forward,
   non-causal), one profiled forward (idle share, device time by kernel),
   row 2 at layer 0's call against the plain version, twice bitwise,
   timed beside its bound, the plain version and SDPA; (b) 8 rows of
   64-512 real tokens padded to 512 with two segments through
   ``model.apply(..., attn_mask=...)`` (the plain masked path): hidden
   states at the real positions and the pooled ``[CLS]`` match each row
   run alone unpadded on the kernel path; (c) int8 weights at group 256:
   389 quantize launches at build and 389 dequantize launches a forward
   (16 leaves a layer, ``tok_embed`` twice, ``pos_embed``, ``type_embed``,
   ``mlm_dense_w``), payloads, scales and dequantized weights bitwise the
   plain versions', ``param_bytes``, sequences/s, MLM-logit cosine and
   argmax agreement against bf16; (d) CLIP ViT-L/14 at 224 (the public
   widths, seeded bf16 weights): ``similarity`` over 64 texts x 64 images
   with its flash launches counted from 0 (12 causal at 77 + 24
   non-causal at 257), images/s and texts/s, peak memory, row 2 at the
   text and vision towers' layer-0 calls as in (a);
6i. MoE: DeepSpeed-MoE's 350M+MoE-128 (24 layers, d 1024, 128 experts
   top-2 a layer, 25.9e9 parameters, seeded bf16 weights): (a) behind
   ``ServingEngine`` over ``RaggedInferenceEngine`` (2048 16-token pages,
   ``max_context`` 2048) as phase 5 serves Llama-2-7B, paged launches
   counted from 0 (one a layer a put, tile items in the prefill puts),
   TTFT, tokens/s, peak memory, then a 512-lane prefill put, a decode put
   and one profiled decode put (idle share, launches); (b) layer 0's
   expert FFN of those two puts: the grouped-GEMM route against the
   per-group loop on the same rows and routing, experts hit, both timed
   beside the bound; (c) ``init_inference`` bf16 then int8 weights (group
   256): path A's prompts, quantize / dequantize launches against the
   leaf set's count (expert banks and ``wg`` included), ``param_bytes``,
   tokens/s, logits cosine and expert agreement against bf16; (d) a
   2-layer full-width model (32 experts) in fp32, cuda against cpu:
   logits within 1e-3, expert flips reported with their gate-logit gaps;
6j. diffusion: Stable Diffusion 1.5 at full width (UNet 320/640/1280/1280,
   2 layers a block, 8 heads, cross-attention 768, 859,520,964
   parameters; VAE 128/256/512/512; the CLIP ViT-L/14 text tower; seeded
   bf16 weights with every bias and norm term drawn, fp32 latents, so the
   UNet computes in fp32 with TF32 off): (a) the models, parameter counts
   and peak memory; (b) 2 seeded prompts and 2 empty rows through the
   text tower's final-LN states, row 2's launches counted from 0 (12, all
   on the Hopper forward), held against the plain attention on the card;
   (c) 50 DDIM steps at guidance 7.5 on 64 x 64 latents and the VAE
   decode to 2 x 512 x 512 images: ms a step (CUDA events), s an image,
   operations a step from the flop counter and TFLOP/s against the fp32
   peak, the same seed twice bitwise; one UNet call with TF32 on (then
   set back); the VAE encode of a 512 x 512 image; (d) full widths in fp32
   on 16 x 16 latents, cuda against cpu: a UNet call, the VAE encode and
   decode, a 3-step pipeline; (e) one denoise step profiled (convolution,
   GEMM, attention softmax, GroupNorm / elementwise, idle share,
   launches); (f) a module wrapped by ``from_module`` trains 3 steps
   through ``initialize``, cuda against cpu;
6a. inference: ``init_inference(Llama("7b"))`` with int8 weights at group
   256 (path A), then bf16 and int4 weights: 4 prompts of 128 tokens, 32
   new tokens greedy; weight bytes, memory, prefill and decode times,
   dequantize launches per forward, and one profiled int8 and bf16 decode
   step;
7. trainer: a 2-layer Llama-1b-width model in fp32, the same weights on
   cuda and cpu, one ``train_batch`` each through ``initialize``: loss,
   grad norm and updated weights must agree;
8. training: ``Llama("1b")`` at full width and depth (bf16 compute, fp32
   masters, AdamW, full remat, GAS 2 of 4 x 2048 tokens), 2 warm-up and 4
   timed ``train_batch`` steps with the flash launch counts reset just
   before and read just after (every forward, dq and dk/dv launch must be
   on the Hopper kernels); step time (the four timed steps' mean),
   tokens/s, MFU, peak memory;
9. train profile: one more step under ``torch.profiler``;
8e. the trainer's rest on phase 8's engine: (a) one step from one saved
   state under each remat policy (``full``, ``selective``,
   ``selective_flash``, ``dots_with_no_batch_dims``, ``nothing``): loss
   and grad norm bitwise ``full``'s, rows 2-4's launches 88 / 44 / 44
   where the forward is replayed and 44 / 44 / 44 where it is saved, all
   on the Hopper kernels, peak memory, step time, tokens/s; (b) two steps
   through ``forward`` / ``backward`` / ``step`` against two
   ``train_batch`` steps, losses and masters bitwise; (c)
   ``train_steps`` over 4 batches against 4 ``train_batch`` calls,
   bitwise, tokens/s both ways, and its per-step fallback with a step
   hook; (d) sgd, lamb, lion and adagrad at full width and 4 of 22
   layers, 2 steps each, and LAMB at 2 layers fp32 cuda against cpu as
   phase 7; (e) step telemetry and the CSV monitor on: every StepStats
   record valid, the monitor's rows, the counted MFU beside the
   analytic, the step time with telemetry on and off; (f) QAT of the
   layers plus sparse pruning at 2 layers fp32, cuda against cpu, and
   ``redundancy_clean``; (g) ``warmup_async`` on a fresh engine, joined
   by its first step;
8c. tensor-parallel training (after 8b, the families): TP 2 through
   ``initialize(config={"mesh": {"model": 2}})``, two gloo rank
   processes on the one card (and two on the host for (b)): (a)
   TinyLlama-1.1B (``llama_config("1b")``) at full width and 11 of 22
   layers (``TP_TRAIN_LAYERS``, since PR 24; time), bf16
   on fp32 masters, full remat, AdamW lr 1e-4, clipping 1.0, GAS 2 of 1 x
   2048 tokens, 1 warm-up and 3 timed steps with the flash counts and the
   comms ledger set to 0 between them: step time, tokens/s, MFU, the
   collectives a step and their share of it, peak memory a rank; every
   forward, dq and dk/dv launch on the Hopper kernels (22 x 2 x 2, 44, 44
   a step a rank), a finite falling loss, no skipped step, the replicated
   leaves bitwise equal on both ranks; (b) its widths at 2 layers in fp32,
   3 steps: TP 2 on the card against TP 1 on the card (losses 1e-5, grad
   norms 1e-4, the masters gathered to full width within 1e-6 but for
   Adam's near-eps elements) and against TP 2 on the host; (c)
   350M+MoE-128's widths at 2 layers and 32 experts (vocab padded to
   50432), fp32, the capacity route top-2 without noise: TP 2 against TP
   1 as (b), and each rank's expert choices equal;
8d. ZeRO stages 1-3 over ``data`` (after 8c): ``initialize(config=
   {"mesh": {"data": 2}, "zero_optimization": {"stage": s}})``, two gloo
   rank processes on the one card (and two on the host for (d)), bf16
   on fp32 masters, full remat, AdamW lr 1e-4, clipping 1.0, 1 warm-up
   and 2 timed steps a run with the flash counts, the comms ledger and a
   collective meter set to 0 between them: (a) GPT-2 small at full
   depth, stages 0, 1 and 2, 16 x 1024, GAS 2; (b) OPT-1.3B's widths at
   3 of 24 layers, stages 0 and 2, 8 x 512; (c) Llama-2-7B's widths at 1
   of 32 layers, stage 3 on the per-layer gather, 2 x 2048: step time,
   tokens/s, MFU, peak memory a rank (falling with the stage in (a) and
   (b)), masters', moments' and gradient accumulator's bytes a rank, the
   collectives a step (comms ledger) and their share of it, flash
   launches a rank (all on the Hopper kernels, (c)'s d 128 too), a
   finite falling loss, no skipped step, the masters bitwise equal on
   both ranks at stages 1-2; (d) Llama-1b's
   widths and OPT's flag set (at OPT-125m's) at 1 layer in fp32, one
   step of 2 x 128: stages 1-3 (OPT: 3) and stage 2 with qgZ on the card,
   each against the card's stage 0 (losses 1e-5, grad norms 1e-4, the
   masters within 1e-6 but for Adam's near-eps elements; qgZ not) and
   against the same stage on two host ranks (qgZ's loss 1e-4, its masters
   within 1e-5 but for at most 1 in 200, each within 2 lr; the host
   ranks run beside phase 10, and their lines follow it), the
   quantizer's launches under qgZ;
10. ZeRO-3 parity: ``SequentialBlockModel((64, 256, 512, 64))`` in fp32,
   ZeRO stage 3 over 2 ranks, one pair of rank processes on cuda (both on
   the one card, over gloo) and one on cpu, from the same seed-made
   weights and batch: 3 steps compressed (w8/g4) and dense, on the fused
   and the reference comm backend (the cpu ranks pinned to ATen
   capability avx2, MKL_CBWR=COMPATIBLE and 2 threads by
   ``utils/cpu_pin.py``, and failing if they run under anything else);
   losses and weights within stated
   tolerances, per step the int4 gradient levels apart and the weights
   moved, fused vs reference, the facade counters, and two planted
   gradient-payload faults that the limits must reject;
11. ZeRO-3 training: ``SequentialBlockModel((4096, 11008, 4096, 11008,
   4096))`` (Llama-2-7B's MLP widths, 180.4 M params) through
   ``initialize`` -> ``train_batch``, world 2 on the one card over gloo
   (NCCL refuses two ranks on one device), bf16 compute on a bf16 batch
   of 4096 x 4096, compressed and dense, fused and reference: 2 warm-up
   and 4 timed steps per configuration with the dequant_matmul /
   matmul_pallas / matmul_quantize counts set to 0 between them and read
   per rank (every row 7-9 launch on the Hopper kernel); step time,
   peak memory, and one profiled step of the compressed fused run.
12. checkpoints, under a temporary directory (removed after; a disk with
   too little room fails): (a) TinyLlama-1.1B's widths at 4 of 22
   layers, bf16 on fp32 masters, AdamW, 2 x 2048 GAS 2 from a bound
   loader, a save every 2 steps: 4 steps (A), then a fresh
   ``initialize`` with ``auto_resume`` on the step-2 tag (the load
   bitwise A's step-2 state) runs steps 3-4, its flash launches counted
   from 0 (all on the Hopper kernels): losses, masters, moments, scaler,
   step, random stream and loader position equal A's (were they not, A's
   steps again without saves, A', would give the step's own spread to
   hold them within); a torn save (chaos ``before_commit``) and a
   flipped byte in the newest tag each send auto-resume back to the
   previous valid tag, loaded bitwise; save / load / CRC seconds and
   GB/s; (c) that engine's ``get_fp32_state_dict``, ``save_16bit_model``
   read back, and ``hot_swap_checkpoint`` (weights only); (b) Llama-2-7B's
   widths at 2 layers exported by ``export_hf_llama`` as sharded
   safetensors (an index and at least 2 shards), read back by
   ``from_pretrained``, phase 5's 8 requests
   (16 new tokens each) served from it with the paged counters from 0,
   streams and the first put's logits bitwise an in-memory engine's, and
   ``init_inference(config={"checkpoint": ...})`` likewise.
13. ZeRO offload (bf16 on fp32 masters, AdamW lr 1e-4, clipping 1.0,
   full remat, 2 x 2048 a step): (a) Llama-2-7B's widths at 4 of 32
   layers, ``offload_optimizer: cpu`` then resident from the same
   seed-made weights and batches, 1 warm-up and 2 timed steps each:
   losses, masters and moments bitwise, step time and peak memory of
   each, the offloaded run's H2D / D2H bytes and seconds on its side
   streams, its peak below the resident one's by at least the moments'
   bytes less the stream window's; (b) the same widths at 24 of 32
   layers with the moments in pinned host memory: the resident need
   reckoned from the engine's buffers (masters, compute copy, gradient
   accumulator, moments) above the card's memory, the host's memory
   before and after, 1 warm-up and 1 timed step, a finite loss, step
   time, peak memory, copies; (c) TinyLlama-1.1B's widths at 2 of 22
   layers, stage 3 with masters and moments on disk under a temporary
   directory: 2 steps bitwise the resident stage-3 run's, swap-in /
   swap-out seconds and GB/s and bytes on disk, and a tag saved with the
   state parked that a fresh engine loads and resumes bitwise. Every
   flash launch of the timed steps on the Hopper kernels.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import hashlib
import itertools
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import fused_collectives as fc
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import paged_attention as pa
from deepspeed_tpu_torch.ops import quant as qk
from deepspeed_tpu_torch.ops.quantizer import quantize_kv

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12,
                  torch.float32: 67e12}   # dense, no sparsity
LIBRARIES = ("paged_attention", "flash_attention", "quant",
             "fused_collectives")
# scratch builds of fused_collectives.cu for one measurement: row 7 with
# its converter's stores off, and with the converter idle
SCRATCH_BUILDS = [("fused_collectives", {"DST_FC_CONVERTER": 1}),
                  ("fused_collectives", {"DST_FC_CONVERTER": 0})]
PAGED_REPLACES = "deepspeed_tpu/ops/pallas/paged_attention.py:159"
# the same Pallas kernel with kv_bits 8/4: its quantized-pool read
PAGED_QUANT_REPLACES = "deepspeed_tpu/ops/pallas/paged_attention.py:91"
# counter of each paged-attention variant, by the engine's kv_quant
PAGED_COUNTER = {"none": "launches", "int8": "int8_launches",
                 "int4": "int4_launches"}
# ... and of the calls that ran tile items / lane items
PAGED_PATH_COUNTERS = (*PAGED_COUNTER.values(), "tile_launches",
                       "split_launches")
PAGED_PATH = ("tile items (prefill runs, bf16/fp16 at hd 64/128): "
              "paged_tile_kernel, TMA page loads + wgmma m64n64k16, 64 lanes "
              "a block; lane items (decode and the rest): paged_split_kernel, "
              "split-K over pages, bulk-copy ring, fp32 SIMT, "
              "paged_combine_kernel")
# ... and over int8 / int4 pools
PAGED_QUANT_PATH = ("tile items (prefill runs, bf16/fp16 q at hd 64/128): "
                    "paged_tile_quant_kernel, TMA payload and scale rows, "
                    "converter warps to exact 16-bit K / V tiles, wgmma "
                    "m64n64k16 with the scales outside the products and P "
                    "as two bf16 parts; lane items (decode and the rest): "
                    "paged_split_kernel + paged_combine_kernel, fp32 SIMT")
QUANT_SOURCE = "deepspeed_tpu_torch/csrc/quant.cu"
QUANT_KERNELS = {
    # name: (wrapper whose .launches counts it, replaced pallas_call,
    #        fp32 operations per element)
    "quantize_blockwise": (qk.quantize_blockwise,
                           "deepspeed_tpu/ops/pallas/quant.py:72", 6),
    "dequantize_blockwise": (qk.dequantize_blockwise,
                             "deepspeed_tpu/ops/pallas/quant.py:103", 1),
}
# Llama-2-7B weight shapes path A quantizes and dequantizes
PATH_A_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (32000, 4096)]
FP_POOL_BYTES = 2048 * 8_388_608   # phase 5's bf16 pool: 2048 pages of 16
PAGED_SOURCE = "deepspeed_tpu_torch/csrc/paged_attention.cu"
FLASH_SOURCE = "deepspeed_tpu_torch/csrc/flash_attention.cu"
FLASH_KERNELS = {
    # name: (wrapper whose .launches counts it, replaced pallas_call,
    #        operations per visible (q-head, key) pair per channel)
    "flash_forward": (fa.flash_forward,
                      "deepspeed_tpu/ops/pallas/flash_attention.py:200", 4),
    "flash_backward_dq": (fa.flash_backward_dq,
                          "deepspeed_tpu/ops/pallas/flash_attention.py:354", 6),
    "flash_backward_dkv": (fa.flash_backward_dkv,
                           "deepspeed_tpu/ops/pallas/flash_attention.py:386",
                           8),
}
FUSED_SOURCE = "deepspeed_tpu_torch/csrc/fused_collectives.cu"
FUSED_KERNELS = {
    # name: (wrapper whose .launches counts it, replaced pallas_call)
    "dequant_matmul": (fc.dequant_matmul,
                       "deepspeed_tpu/ops/pallas/fused_collectives.py:122"),
    "matmul_pallas": (fc.matmul_pallas,
                      "deepspeed_tpu/ops/pallas/fused_collectives.py:156"),
    "matmul_quantize": (fc.matmul_quantize,
                        "deepspeed_tpu/ops/pallas/fused_collectives.py:239"),
}
FUSED_SHAPES = {
    "dequant_matmul": "h [2048, 4096] bf16 x int8 [4096, 5504] block 256",
    "matmul_pallas": "h [2048, 4096] bf16 x [4096, 5504] bf16",
    "matmul_quantize": "h^T [4096, 2048] x g [2048, 11008] bf16 -> int4 "
                       "block 256",
}
FUSED_LIBRARY = {   # the PyTorch call timed beside each kernel
    "dequant_matmul": "torch.mm(h, w, out_dtype=torch.float32) of the bf16 "
                      "weight before quantization: the product only, a "
                      "yardstick",
    "matmul_pallas": "torch.mm(h, w, out_dtype=torch.float32): the same "
                     "product, fp32 output",
    "matmul_quantize": "torch.matmul(h.t(), g): the product only, bf16 "
                       "output, a yardstick",
}
# the kernel each row takes at the path's shapes
FUSED_PATH = {"dequant_matmul": "wgmma: TMA ring + converter warps + "
                                "wgmma m64n256k16, 128 x 256 tiles",
              "matmul_pallas": "wgmma: TMA ring + wgmma m64n256k16, "
                               "128 x 256 tiles",
              "matmul_quantize": "wgmma: TMA ring (a^T M-major) + wgmma "
                                 "m64n256k16, 128 x 256 tiles, quantize "
                                 "and pack in registers"}
# the Hopper kernel's cases: (m, k, n) with ragged m, n 320 / 1376 and k
# not a multiple of the 64-deep stage (520, 528) beside the path's 4096;
# (bits, block) of the weight, None dense, each block where it divides k*n
WGMMA_SHAPES = [(1, 520, 320), (77, 4096, 1376), (333, 520, 1376),
                (77, 528, 320)]
WGMMA_WEIGHTS = [(None, None), (8, 256), (4, 256), (8, 64), (4, 64),
                 (8, 96), (4, 96)]
# row 9's cases on it: (rows, k, n, block) with ragged rows, n that is no
# multiple of the 256-wide tile (320, 1376, 384) and k 520 / 528 beside
# 2048; under trans_a the rows are a's row length, which TMA needs in whole
# 16-byte strides (72 / 328 there). Blocks 256 / 128 / 64, and 32 where n
# (1376) takes no larger one
WGMMA_QUANT_SHAPES = [(77, 520, 320, 64), (333, 528, 1376, 32),
                      (77, 2048, 384, 128), (333, 2048, 1280, 256)]
# ... and two it refuses (rows 77 under trans_a; block 96): the mma.sync
# kernel, one pass and two
WGMMA_QUANT_REFUSED = [(77, 520, 320, 64, True), (77, 520, 384, 96, False)]
# random operands: fp32 accumulation in another order (over 512 terms in
# the small cases, 4096 at the path's shape)
FUSED_REL = 1e-5
# matmul_quantize at the path's shape: a level lands one apart where the
# fp32 product sits within its summation error of a rounding boundary
# (an H100 run read 102 of 45088768); a wrong tile moves whole blocks
FUSED_LEVELS_APART = 1e-4
# fused vs reference engine losses at full width: the losses are bf16, and
# H100 runs read them equal; one bf16 ulp allows one rounding apart
ZERO3_LOSS_ULPS = 1
GRAD_REL_TOL = 1e-2                # bf16/fp16 grads: max err / max |plain|
FP32_TOL = 2e-5                    # abs, TF32 off
HALF_TOL = (4e-3, 1e-2)            # bf16/fp16: abs + rel * |plain|
L2_FLUSH_BYTES = 512 << 20         # well above the H100's 50 MB L2


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, flush: torch.Tensor, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``iters`` calls, each between its
    own pair of CUDA events and each after writing ``flush`` (larger than
    L2), so every call reads its inputs from HBM. The flush keeps the
    device busy while the host enqueues the call."""
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def check_half_or_fp32(got, ref) -> tuple:
    """(ok, max_abs_err, tolerance text) of the kernel's output against
    the plain version's, by the dtype's tolerance."""
    err = (got.float() - ref.float()).abs()
    if got.dtype == torch.float32:
        ok, tol = bool(err.max() <= FP32_TOL), f"{FP32_TOL} abs"
    else:
        a, r = HALF_TOL
        ok = bool((err <= a + r * ref.float().abs()).all())
        tol = f"{a} abs + {r} rel"
    ok = ok and bool(torch.isfinite(got).all())
    return ok, err.max().item(), tol


# ---------------------------------------------------------------- phase 1
def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs only on the GPU")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "nvidia-smi gave nothing"
    log(f"device: {name} count={count} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    # the host's CPU decides the cpu ranks' fp32 rounding (phase 10); the
    # ranks pin it (cpu_pin: ATen capability, MKL path, thread counts)
    from deepspeed_tpu_torch.utils import cpu_pin

    log(f"host: {os.cpu_count()} CPUs, {cpu_pin.cpu_report()}, ATen CPU "
        f"capability {torch.backends.cpu.get_cpu_capability()} here, "
        f"{torch.get_num_threads()} torch threads; cpu ranks pinned to "
        f"{cpu_pin.PINNED_CAPABILITY}, MKL_CBWR=COMPATIBLE, "
        f"{cpu_pin.PINNED_THREADS} threads")
    log(card)
    return {"name": name, "count": count, "card": card}


# ---------------------------------------------------------------- phase 2
def _timed_load(build) -> float:
    t0 = time.perf_counter()
    op_builder.load(*build)
    return time.perf_counter() - t0


def phase_build() -> dict:
    """Start every kernel library's build at once (one nvcc each, in
    parallel), with the two scratch builds of row 7's converter
    (SCRATCH_BUILDS), and wait for all but fused_collectives.cu's: its
    three builds take the longest, and phase 4, which needs none of them,
    runs beside them. :func:`phase_build_report` waits for the rest."""
    builds = [(name, None) for name in LIBRARIES] + SCRATCH_BUILDS
    keys = [" ".join([name] + [f"-D{k}={v}" for k, v in
                               sorted((defines or {}).items())])
            for name, defines in builds]
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(len(builds))
    futures = {k: pool.submit(_timed_load, b) for k, b in zip(keys, builds)}
    early = [k for k in keys if not k.startswith("fused_collectives")]
    for k in early:
        futures[k].result()
    log(f"build: {early} built in {time.perf_counter() - t0:.2f} s wall; "
        f"fused_collectives.cu's builds go on beside phase 4")
    return {"pool": pool, "futures": futures, "t0": t0}


def phase_build_report(pending: dict) -> None:
    """Wait for the builds :func:`phase_build` started. Each library's own
    seconds are printed beside the wall time (phase 4 ran within it):
    their sum is what a one-after-another loop would take. The ptxas
    report is printed for the libraries the port runs, and the Hopper
    kernel's dynamic shared memory, which ptxas does not report."""
    secs = {k: f.result() for k, f in pending["futures"].items()}
    pending["pool"].shutdown()
    log(f"build: {time.perf_counter() - pending['t0']:.2f} s wall for "
        f"{list(secs)} in parallel, phase 4 beside fused_collectives.cu's; "
        f"each library's own seconds "
        + ", ".join(f"{n} {s:.2f}" for n, s in secs.items())
        + f" (sum {sum(secs.values()):.2f})")
    for name in LIBRARIES:
        for line in op_builder.build_logs[name].splitlines():
            if any(w in line for w in ("ptxas", "registers", "smem",
                                       "spill")):
                log(f"build[{name}]: {line.strip()}")
    lib = fc._library()
    for kernel, used in _ptxas_report("fused_collectives",
                                      ("wgmma_kernel",)).items():
        mode = re.search(r"MODE (\d)", kernel)
        bits = {"1": 8, "2": 4}.get(mode.group(1) if mode else "0", 0)
        log(f"build[fused_collectives]: Hopper {kernel}: {used}; dynamic "
            f"shared memory {lib.dst_fc_wgmma_smem(bits)} B")
    lib = fa._library()
    for kernel, used in _ptxas_report("flash_attention", ("wgmma",)).items():
        d64 = "Li64" in kernel
        which = (2 if d64 else 3) if "forward" in kernel else \
            (1 if d64 else 5) if "dkv" in kernel else (0 if d64 else 4)
        log(f"build[flash_attention]: Hopper {kernel}: {used}; dynamic "
            f"shared memory {lib.dst_flash_wgmma_smem(which)} B")
        # the d 128 backward trades registers between its warpgroups
        # (setmaxnreg): the counts add up only from 168 at entry, and a
        # consumer would wait for registers forever from fewer
        if "backward" in kernel and not d64 and \
                "Used 168 registers" not in used:
            raise SystemExit(f"flash_attention: {kernel} does not start at "
                             f"168 registers a thread: {used}")
    lib = pa._library()
    for kernel, used in _ptxas_report(
            "paged_attention", ("paged_tile", "paged_split",
                                "paged_combine")).items():
        # paged_tile_kernel<T, D>, paged_tile_quant_kernel<T, D, BITS>
        m = re.search(r"Li(64|128)E?(?:Li([48]))?>", kernel)
        smem = "" if "tile" not in kernel else (
            f"; dynamic shared memory "
            f"{lib.dst_paged_tile_smem(int(m.group(1)), int(m.group(2) or 0))}"
            f" B")
        log(f"build[paged_attention]: {kernel}: {used}{smem}")
def _ptxas_report(library: str, markers: tuple) -> dict:
    """{kernel entry (mangled, abridged): ptxas's "Used ..." line and any
    spill line} for the entries of ``library`` (a build log's key) whose
    name holds one of ``markers``. Raises if ptxas reports spills there."""
    report, entry = {}, None
    for line in op_builder.build_logs[library].splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
            entry = entry if any(m in entry for m in markers) else None
        elif entry and ("Used" in line or "spill" in line):
            m = re.search(
                r"_cu_[0-9a-f]{8}\d+([A-Za-z]\w*?_kernel)I\d+(\w+?)EE", entry)
            name = f"{m.group(1)}<{m.group(2)}>" if m else entry[:60]
            # fused_collectives.cu's wgmma_kernel<T, MODE, TRANS_A, QBITS>
            m = re.search(r"wgmma_kernelI\d+(__nv_bfloat16|__half)Li(\d)E"
                          r"Lb([01])ELi(\d)E", entry)
            if m:
                name = (f"wgmma_kernel<{m.group(1)}, MODE {m.group(2)}, "
                        f"TRANS_A {m.group(3)}, QBITS {m.group(4)}>")
            report[name] = (report.get(name, "") + " " + line.split(":", 1)
                            [-1].strip()).strip()
    spills = [n for n, r in report.items()
              if re.search(r"[1-9]\d* bytes spill", r)]
    if spills:
        raise SystemExit(f"{library}: ptxas spills in {spills}")
    return report


# ---------------------------------------------------------------- phase 3
def _paged_inputs(gen, contexts, hq, hkv, hd, block, dtype, *,
                  prefill_of=None, max_pages=None, extra_pages=8,
                  decode=True, dev="cuda"):
    """One decode token per context (at position ctx-1) unless ``decode``
    is False, plus, for each (seq index, n) of ``prefill_of`` (one pair or
    a list), a prefill chunk of n tokens ending at that sequence's last
    position. Per-sequence tables with seq_slots; pages drawn as a random
    permutation of the pool."""
    pages_per = [-(-c // block) for c in contexts]
    max_pages = max_pages or max(pages_per)
    n_pages = sum(pages_per) + extra_pages
    perm = torch.randperm(n_pages, generator=gen, device="cpu")
    tables = torch.zeros((len(contexts), max_pages), dtype=torch.int32)
    at = 0
    for i, n in enumerate(pages_per):
        tables[i, :n] = perm[at:at + n].to(torch.int32)
        at += n
    slots = list(range(len(contexts))) if decode else []
    pos = [c - 1 for c in contexts] if decode else []
    chunks = [prefill_of] if isinstance(prefill_of, tuple) else \
        (prefill_of or [])
    for s, n in chunks:
        slots += [s] * n
        pos += list(range(contexts[s] - n, contexts[s]))
    T = len(slots)
    q = torch.randn((T, hq, hd), generator=gen, device="cpu").to(dtype)
    kp = torch.randn((n_pages, hkv, block, hd), generator=gen,
                     device="cpu").to(dtype)
    vp = torch.randn((n_pages, hkv, block, hd), generator=gen,
                     device="cpu").to(dtype)
    return (q.to(dev), kp.to(dev), vp.to(dev), tables.to(dev),
            torch.tensor(pos, dtype=torch.int32, device=dev),
            torch.tensor(slots, dtype=torch.int32, device=dev))


def _bound(q, kp, tables, positions, seq_slots, live_pages, window,
           kv_bits: int = 0):
    """(bound_ms, bound_by, bytes, ops, fp32_bound_ms) for one call on
    these inputs: bytes = the distinct K/V pages the walk needs (with
    ``kv_bits``, their payload and one fp32 scale per head-vector), q,
    out, tables, positions and slots, each once; ops = 4 per (query head,
    visible key, channel), at q's type's peak: a quantized pool's payload
    is exact in bf16 and fp16, so its products can run on exact 16-bit
    operands too.
    fp32_bound_ms counts the ops at the fp32 peak instead (the bound of
    quantized pools' fp32 lane items, beside which older figures stand)."""
    T, hq, hd = q.shape
    _, hkv, block, _ = kp.shape
    tab = tables.cpu().numpy()
    pos = positions.cpu().numpy()
    rows = seq_slots.cpu().numpy()
    live = min(live_pages, tab.shape[1])
    pages = set()
    keys = 0
    for p, r in zip(pos, rows):
        lo = max(p - window + 1, 0) // block if window > 0 else 0
        hi = min(p // block + 1, live)
        pages.update(int(x) for x in tab[r, lo:hi])
        keys += (p + 1) if window <= 0 else min(p + 1, window)
    elem = q.element_size()
    row_bytes = hd * kv_bits // 8 + 4 if kv_bits else hd * elem
    nbytes = (2 * len(pages) * hkv * block * row_bytes + 2 * q.numel() * elem
              + 4 * (tables.numel() + positions.numel() + seq_slots.numel()))
    ops = 4.0 * keys * hq * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[q.dtype] * 1e3
    t_fp32 = max(t_bytes, ops / PEAK_OPS_PER_S[torch.float32] * 1e3)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops, t_fp32)


PAGED_SHAPES = {
    # 16 sequences decoding at 1024 context: one token each
    "decode_16x1024": dict(contexts=[1024] * 16, prefill_of=None,
                           decode=True, live=64),
    # one 512-token prefill chunk of a 512-token prompt
    "prefill_512": dict(contexts=[512], prefill_of=(0, 512), decode=False,
                        live=32),
}


def _paged_path(q, kp, tab, slots, live) -> tuple:
    """(tile items?, lane items?) in the work list the wrapper runs for
    this call (ops/paged_attention.py ``paged_work_arrays``)."""
    t, i, _ = pa.paged_work_arrays(
        slots.cpu().numpy(), q.shape[0], pa._walk_bound(live, tab.shape[1]),
        kp.shape[1], pa._takes_tiles(True, q.dtype, kp, None))
    return len(t) > 0, len(i) > 0


def _lane_work(slots, T, walk, kp) -> "pa.PagedWork":
    """The work list of a call with every lane on lane items
    (``paged_work_arrays(..., tiles=False)``): the path quantized pools
    ran before they took tile items."""
    t, i, l = pa.paged_work_arrays(slots.cpu().numpy(), T, walk,
                                   kp.shape[1], False)
    flat = np.concatenate([t.ravel(), i.ravel(), l.ravel()]).astype(np.int32)
    return pa.PagedWork(torch.from_numpy(flat).to(kp.device), 0, len(i),
                        len(l), T, walk, kp.shape[1])


def _paged_counts() -> tuple:
    return (pa.paged_attention.tile_launches,
            pa.paged_attention.split_launches)


def _paged_twice(name, q, kp, vp, tab, pos, slots, live, window, work=None,
                 **quant):
    """The wrapper twice on one input (with ``work``, that work list)
    against the plain version: stated tolerance, bitwise-equal runs, and
    tile / lane items launched exactly where the work list has them.
    Returns the max abs error."""
    want = _paged_path(q, kp, tab, slots, live) if work is None \
        else (work.n_tiles > 0, work.n_items > 0)
    before = _paged_counts()
    kw = dict(seq_slots=slots, live_pages=live, window=window, **quant)
    got = pa.paged_attention(q, kp, vp, tab, pos, work=work, **kw)
    again = pa.paged_attention(q, kp, vp, tab, pos, work=work, **kw)
    torch.cuda.synchronize()
    moved = tuple(a - b for a, b in zip(_paged_counts(), before))
    ref = pa.paged_attention_reference(q, kp, vp, tab, pos, **kw)
    ok, err, tol = check_half_or_fp32(got, ref)
    same = torch.equal(got, again)
    path_ok = moved == (2 * want[0], 2 * want[1])
    log(f"kernels: paged_attention {name} T={q.shape[0]} max_abs_err="
        f"{err:.3e} tol={tol}; twice bitwise equal {same}; tile / lane "
        f"launches {moved} (work list: tiles {want[0]}, lane items "
        f"{want[1]}) {'ok' if ok and same and path_ok else 'FAIL'}")
    if not (ok and same and path_ok):
        raise SystemExit(f"paged_attention failed on {name}")
    return err


def _old_paged(q, kp, vp, tab, pos, slots, live, k_scale=None, v_scale=None,
               kv_bits=8):
    """A call of the per-(token, kv-head) kernel that the work list's
    kernels replaced (`dst_paged_attention`, `dst_paged_attention_quant`
    for quantized pools) on the same inputs."""
    lib = pa._library()
    out = torch.empty_like(q)
    T, hq, hd = q.shape
    n_pages, hkv, block, _ = kp.shape
    geometry = (T, hq, hkv, hd, n_pages, block, tab.shape[1],
                pa._walk_bound(live, tab.shape[1]), 0, 1.0 / math.sqrt(hd),
                pa._DTYPE_CODE[q.dtype])
    stream = torch.cuda.current_stream().cuda_stream
    if k_scale is None:
        err = lib.dst_paged_attention(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tab.data_ptr(),
            slots.data_ptr(), pos.data_ptr(), out.data_ptr(), *geometry,
            stream)
    else:
        err = lib.dst_paged_attention_quant(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), tab.data_ptr(), slots.data_ptr(),
            pos.data_ptr(), out.data_ptr(), *geometry, kv_bits, stream)
    pa._raise_on(lib, err)
    return out


def _time_paged(label, q, kp, vp, tab, pos, slots, live, flush, work=None,
                **quant):
    """The new paths (``work``, or a work list planned once, as an engine
    put does), the replaced kernel and the plain version on one input, in
    turns (plain, old, new, new, old, plain), beside the bound. A
    quantized pool's call with tile items also times it with every lane
    on lane items (:func:`_lane_work`), in the same turns ("lane_ms").
    Returns the timing."""
    T = q.shape[0]
    walk = pa._walk_bound(live, tab.shape[1])
    if work is None:
        work = pa.plan_paged_work(slots.cpu().numpy(), T, walk, kp,
                                  dtype=q.dtype)
    tiles, items = work.n_tiles > 0, work.n_items > 0
    kw = dict(seq_slots=slots, live_pages=live, **quant)
    quantized = quant.get("k_scale") is not None
    lanes = _lane_work(slots, T, walk, kp) if quantized and tiles else None

    def kern(w=work):
        return pa.paged_attention(q, kp, vp, tab, pos, work=w, **kw)

    def old():
        return _old_paged(q, kp, vp, tab, pos, slots, live, **quant)

    def plain():
        return pa.paged_attention_reference(q, kp, vp, tab, pos, **kw)

    ref = plain()
    runs = [("kernel", kern), ("old kernel", old)]
    if lanes is not None:
        runs.append(("lane-item path", lambda: kern(lanes)))
    for what, fn in runs:
        ok, err, tol = check_half_or_fp32(fn(), ref)
        if not ok:
            raise SystemExit(f"paged_attention {label}: the {what} disagrees "
                             f"with the plain version ({err:.3e}, {tol})")
    p1, o1 = cuda_ms(plain, 3, flush), cuda_ms(old, 20, flush)
    l1 = None if lanes is None else cuda_ms(lambda: kern(lanes), 20, flush)
    k1, k2 = cuda_ms(kern, 20, flush), cuda_ms(kern, 20, flush)
    l2 = None if lanes is None else cuda_ms(lambda: kern(lanes), 20, flush)
    o2, p2 = cuda_ms(old, 20, flush), cuda_ms(plain, 3, flush)
    bits = quant["kv_bits"] if quantized else 0
    bound_ms, bound_by, nbytes, ops, fp32_ms = _bound(
        q, kp, tab, pos, slots, live, 0, kv_bits=bits)
    path = " + ".join(n for n, on in (("tile items", tiles),
                                      ("lane items", items)) if on)
    lane_note = "" if lanes is None else \
        f", every lane on lane items {l1:.4f}/{l2:.4f} ms"
    fp32_note = f", {fp32_ms:.4f} ms at the fp32 peak" if bits else ""
    log(f"kernels: paged_attention {label} T={T} ({path}) kernel "
        f"{k1:.4f}/{k2:.4f} ms{lane_note}, the replaced kernel "
        f"{o1:.4f}/{o2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}, {nbytes} B, {ops:.3e} ops"
        f"{fp32_note}); {nbytes / min(k1, k2) / 1e6:.1f} GB/s, "
        f"{ops / min(k1, k2) / 1e9:.2f} TFLOP/s")
    out = {"T": T, "ms": min(k1, k2), "old_ms": min(o1, o2),
           "plain_ms": min(p1, p2), "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": nbytes, "ops": ops, "path": path}
    if bits:
        out["bound_fp32_peak_ms"] = fp32_ms
    if lanes is not None:
        out["lane_ms"] = min(l1, l2)
    return out


def phase_kernels() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("kernels: TF32 off (torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False)")
    gen = torch.Generator().manual_seed(0)
    ctxs = [1, 17, 1000, 4096]
    cases = [
        # name, contexts, hq, hkv, hd, block, dtype, window, max_pages,
        # live, prefill chunks (seq, n); bf16/fp16 at hd 64/128 with
        # block >= 8 put runs of >= 16 lanes on tile items, every other
        # lane takes lane items
        ("7b-bf16", ctxs, 32, 32, 128, 16, torch.bfloat16, 0, 512, 256,
         (2, 16)),
        ("7b-fp16", ctxs, 32, 32, 128, 16, torch.float16, 0, 512, 256,
         (2, 16)),
        ("7b-fp32", ctxs, 32, 32, 128, 16, torch.float32, 0, 512, 256,
         (2, 16)),
        ("1b-gqa-window-fp32", ctxs, 32, 4, 64, 16, torch.float32, 256, 512,
         256, (2, 16)),
        ("1b-gqa-window-bf16", ctxs, 32, 4, 64, 16, torch.bfloat16, 256, 512,
         256, (2, 16)),
        ("hd256-block64-fp32", [1, 70, 700], 8, 2, 256, 64, torch.float32, 0,
         16, 16, (2, 16)),
        ("hd64-block1-bf16", [1, 5, 40], 8, 8, 64, 1, torch.bfloat16, 7, 64,
         64, (2, 16)),
        # tile cases: a chunk that is no multiple of 64, one that starts
        # mid-page, two sequences' chunks inside one 64-lane window, block
        # 32 and 8, a window across a tile
        ("chunk70-block32-bf16", [200], 32, 32, 128, 32, torch.bfloat16, 0,
         64, 8, (0, 70)),
        ("chunk-mid-page-fp16", [137], 32, 4, 64, 16, torch.float16, 0, 64,
         16, (0, 100)),
        ("two-sequences-one-window-bf16", [90, 120], 32, 32, 128, 16,
         torch.bfloat16, 0, 64, 8, [(0, 40), (1, 40)]),
        ("block8-window-bf16", [250], 8, 2, 64, 8, torch.bfloat16, 40, 64,
         32, (0, 100)),
        # lane cases: 1-lane decode at 17, 16 lanes at 4096
        ("decode1x17-bf16", [17], 32, 32, 128, 16, torch.bfloat16, 0, 256,
         2, None),
        ("decode16x4096-gqa-bf16", [4096] * 16, 32, 4, 64, 16,
         torch.bfloat16, 0, 256, 256, None),
        # 6g's serving shapes: OPT-6.7B (32 heads of 128, 2048 context)
        # and GPT-2 XL (25 heads of 64, 1024 context), decode lanes and a
        # prefill chunk on tile items
        ("opt-6.7b-bf16", [1, 17, 1000, 2048], 32, 32, 128, 16,
         torch.bfloat16, 0, 128, 128, (2, 48)),
        ("gpt2-xl-hd64-h25-bf16", [1, 17, 700, 1024], 25, 25, 64, 16,
         torch.bfloat16, 0, 64, 64, (2, 48)),
    ]
    worst = 0.0
    for (name, contexts, hq, hkv, hd, block, dtype, window, mp, live,
         chunks) in cases:
        q, kp, vp, tab, pos, slots = _paged_inputs(
            gen, contexts, hq, hkv, hd, block, dtype, prefill_of=chunks,
            max_pages=mp, decode=len(contexts) > 2 or chunks is None)
        worst = max(worst, _paged_twice(name, q, kp, vp, tab, pos, slots,
                                        live, window))

    timings = {}
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for label, spec in PAGED_SHAPES.items():
        q, kp, vp, tab, pos, slots = _paged_inputs(
            gen, spec["contexts"], 32, 32, 128, 16, torch.bfloat16,
            prefill_of=spec["prefill_of"], decode=spec["decode"],
            max_pages=256, extra_pages=0)
        worst = max(worst, _paged_twice(label, q, kp, vp, tab, pos, slots,
                                        spec["live"], 0))
        timings[label] = _time_paged(label, q, kp, vp, tab, pos, slots,
                                     spec["live"], flush)
    del flush
    return {"max_abs_err": worst, "timings": timings}


def _quantized_pools(kp, vp, bits):
    """(k payload, v payload, quant kwargs) of fp pools, by quantize_kv."""
    kq, ks = quantize_kv(kp, bits)
    vq, vs = quantize_kv(vp, bits)
    return kq, vq, dict(k_scale=ks, v_scale=vs, kv_bits=bits)


def phase_paged_quant(flush: torch.Tensor) -> dict:
    """Quantized pools (int8, int4) against the plain version: the 7b
    shapes in bf16 and fp32 q, a window, GQA with hd 64, each beside a
    16-lane prefill chunk; then phase 3's tile cases (a 70-lane chunk at
    block 32, a chunk from mid-page, two sequences in one 64-lane window,
    block 8 with a window, GQA at hd 64) in bf16 and fp16 q; each twice
    for bitwise-equal runs, tile / lane launches where the work list has
    them (bf16 / fp16 prefill runs on `paged_tile_quant_kernel`); then
    decode_16x1024 and prefill_512 timed beside the prefill with every
    lane on lane items, the replaced quantized-pool kernel and their
    bound (payload + scale bytes). Returns {bits: {max_abs_err,
    timings}}."""
    gen = torch.Generator().manual_seed(4)
    ctxs = [1, 17, 1000, 4096]
    cases = [
        # name, contexts, hq, hkv, hd, block, dtype, window, max_pages,
        # live, prefill chunks (seq, n), decode lanes
        ("7b-bf16", ctxs, 32, 32, 128, 16, torch.bfloat16, 0, 512, 256,
         (2, 16), True),
        ("7b-fp32", ctxs, 32, 32, 128, 16, torch.float32, 0, 512, 256,
         (2, 16), True),
        ("7b-window256-bf16", ctxs, 32, 32, 128, 16, torch.bfloat16, 256,
         512, 256, (2, 16), True),
        ("gqa-hd64-window-fp32", ctxs, 32, 4, 64, 16, torch.float32, 100,
         512, 256, (2, 16), True),
    ]
    for dtype in (torch.bfloat16, torch.float16):
        name = str(dtype)[6:]
        cases += [
            (f"chunk70-block32-{name}", [200], 32, 32, 128, 32, dtype, 0,
             64, 8, (0, 70), False),
            (f"chunk-mid-page-gqa-hd64-{name}", [137], 32, 4, 64, 16, dtype,
             0, 64, 16, (0, 100), False),
            (f"two-sequences-one-window-{name}", [90, 120], 32, 32, 128, 16,
             dtype, 0, 64, 8, [(0, 40), (1, 40)], False),
            (f"block8-window-{name}", [250], 8, 2, 64, 8, dtype, 40, 64, 32,
             (0, 100), False),
            (f"gqa-hd64-window-{name}", ctxs, 32, 4, 64, 16, dtype, 256, 512,
             256, (2, 16), True),
        ]
    out = {}
    for bits in (8, 4):
        worst = 0.0
        for (name, contexts, hq, hkv, hd, block, dtype, window, mp, live,
             chunks, decode) in cases:
            q, kp, vp, tab, pos, slots = _paged_inputs(
                gen, contexts, hq, hkv, hd, block, dtype,
                prefill_of=chunks, max_pages=mp, decode=decode)
            kq, vq, quant = _quantized_pools(kp, vp, bits)
            worst = max(worst, _paged_twice(f"int{bits} {name}", q, kq, vq,
                                            tab, pos, slots, live, window,
                                            **quant))
        timings = {}
        for label, spec in PAGED_SHAPES.items():
            q, kp, vp, tab, pos, slots = _paged_inputs(
                gen, spec["contexts"], 32, 32, 128, 16, torch.bfloat16,
                prefill_of=spec["prefill_of"], decode=spec["decode"],
                max_pages=256, extra_pages=0)
            kq, vq, quant = _quantized_pools(kp, vp, bits)
            del kp, vp
            worst = max(worst, _paged_twice(f"int{bits} {label}", q, kq, vq,
                                            tab, pos, slots, spec["live"], 0,
                                            **quant))
            timings[label] = _time_paged(f"int{bits} {label}", q, kq, vq,
                                         tab, pos, slots, spec["live"],
                                         flush, **quant)
        out[bits] = {"max_abs_err": worst, "timings": timings}
    return out


def phase_quant_kernels(flush: torch.Tensor) -> dict:
    """Rows 5 and 6: quantize and dequantize against their plain versions,
    bitwise (payload, scales and dequantized values), over fp32, bf16 and
    fp16 inputs, bits 8 and 4 (int4 also packed, as the v1 engine stores
    it), blocks 128 and 256, row counts that are not multiples of 32, and
    path A's weight shapes in bf16; then both timed at [4096, 11008] bf16,
    int8, block 256 beside their bound. Returns {name: timing}."""
    gen = torch.Generator(device="cuda").manual_seed(3)

    def make(shape, dtype):
        x = torch.randn(shape, generator=gen, device="cuda")
        x *= torch.rand((shape[0], 1), generator=gen, device="cuda") * 10
        x[0] = 0.0                            # an all-zero block: scale 1
        return x.to(dtype)

    cases = [((333, 512), dtype, bits, block, pack)
             for dtype in (torch.float32, torch.bfloat16, torch.float16)
             for bits, pack in ((8, False), (4, False), (4, True))
             for block in (128, 256)]
    cases += [(shape, torch.bfloat16, bits, 256, bits == 4)
              for shape in PATH_A_SHAPES for bits in (8, 4)]
    worst = 0.0
    for shape, dtype, bits, block, pack in cases:
        x = make(shape, dtype)
        q, s = qk.quantize_blockwise(x, bits=bits, block=block, pack=pack)
        got = qk.dequantize_blockwise(q, s, block=block, dtype=dtype,
                                      packed=pack)
        torch.cuda.synchronize()
        rq, rs = qk.quantize_blockwise_reference(x, bits, block, pack)
        ref = qk.dequantize_blockwise_reference(rq, rs, block, dtype, pack)
        same = (torch.equal(q, rq), torch.equal(s, rs), torch.equal(got, ref))
        worst = max(worst, (got.float() - ref.float()).abs().max().item())
        rows = x.numel() // block
        log(f"quant: {tuple(shape)} {str(dtype)[6:]} bits {bits} block "
            f"{block}{' packed' if pack else ''} ({rows} rows, rows % 32 = "
            f"{rows % 32}): payload, scale, dequantized bitwise equal "
            f"{same} {'ok' if all(same) else 'FAIL'}")
        if not all(same):
            raise SystemExit(f"quantize/dequantize kernels differ from their "
                             f"plain versions on {shape} {dtype} bits {bits}")
        del x, q, s, got, rq, rs, ref
    x = make((4096, 11008), torch.bfloat16)
    q, s = qk.quantize_blockwise(x, bits=8, block=256)
    fns = {
        "quantize_blockwise": (
            lambda: qk.quantize_blockwise(x, bits=8, block=256),
            lambda: qk.quantize_blockwise_reference(x, 8, 256)),
        "dequantize_blockwise": (
            lambda: qk.dequantize_blockwise(q, s, block=256,
                                            dtype=torch.bfloat16),
            lambda: qk.dequantize_blockwise_reference(q, s, 256,
                                                      torch.bfloat16)),
    }
    # each input read once, each output written once: the same bytes both
    # ways (bf16 values, int8 payload, fp32 scales)
    nbytes = x.numel() * 2 + q.numel() + s.numel() * 4
    res = {}
    for name, (kern, plain) in fns.items():
        p1 = cuda_ms(plain, 3, flush)
        k1 = cuda_ms(kern, 20, flush)
        k2 = cuda_ms(kern, 20, flush)
        p2 = cuda_ms(plain, 3, flush)
        ops = float(QUANT_KERNELS[name][2]) * x.numel()
        t_ops = ops / PEAK_OPS_PER_S[torch.float32] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        res[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "max_abs_err": worst,
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops > t_bytes else "bytes",
                     "bytes": nbytes, "ops": ops}
        log(f"quant: {name} [4096, 11008] bf16 int8 block 256: kernel "
            f"{k1:.4f}/{k2:.4f} ms plain {p1:.4f}/{p2:.4f} ms bound "
            f"{res[name]['bound_ms']:.4f} ms ({res[name]['bound_by']}, "
            f"{nbytes} B, {ops:.3e} ops); {nbytes / min(k1, k2) / 1e6:.1f} "
            f"GB/s")
    return res


# ---------------------------------------------------------------- phase 4
def _beside(card_fn, cpu_fn) -> tuple:
    """(card_fn(), cpu_fn(), cpu_fn's seconds): the CPU reference runs on
    a thread beside the card's half (phase 4's cut for the time limit)."""
    def timed():
        t0 = time.perf_counter()
        return cpu_fn(), time.perf_counter() - t0

    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(timed)
        card = card_fn()
        torch.cuda.synchronize()
        cpu, cpu_s = fut.result()
    return card, cpu, cpu_s


def phase_engine_parity() -> None:
    """Phase 4: the engine and path B on one pair of seed-1 models (a
    2-layer Llama-2-7B-width model takes ~9 s to build on the host; the
    ragged engines do not write their weights), then path A."""
    from deepspeed_tpu_torch.models.llama import Llama

    cpu_model = Llama("7b", device="cpu", dtype=torch.float32, seed=1,
                      n_layers=2)
    gpu_model = Llama("7b", device="cuda", dtype=torch.float32, seed=1,
                      n_layers=2)
    gpu_model.load_state_dict(cpu_model.state_dict())
    phase_engine(cpu_model, gpu_model)
    phase_ragged_quant_parity(cpu_model, gpu_model)
    del cpu_model, gpu_model
    gc.collect()
    torch.cuda.empty_cache()
    phase_inference_parity()


def phase_engine(cpu_model, gpu_model) -> None:
    """2-layer Llama-2-7B-width engine, fp32, the same weights on cuda and
    cpu: one put of 3 mixed-length prompts; logits agree within 1e-3."""
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)

    t0 = time.perf_counter()
    cfg = dict(token_budget=512, max_seqs=4, kv_block_size=16,
               n_kv_blocks=64, max_context=4096, dtype=torch.float32)
    rng = np.random.default_rng(4)
    prompts = {1: rng.integers(1, 32000, 5).tolist(),
               2: rng.integers(1, 32000, 77).tolist(),
               3: rng.integers(1, 32000, 300).tolist()}
    engs = {dev: RaggedInferenceEngine(model, RaggedConfig(**cfg), device=dev)
            for dev, model in (("cuda", gpu_model), ("cpu", cpu_model))}
    got, ref, _ = _beside(
        *(lambda e=engs[dev]: e.put(list(prompts), list(prompts.values()))
          for dev in ("cuda", "cpu")))
    err = float(np.abs(got - ref).max())
    ok = got.shape == (3, 32000) and np.isfinite(got).all() and err <= 1e-3
    log(f"engine: 2-layer d_model=4096 fp32 put of 3 prompts "
        f"(5/77/300 tokens): logits {got.shape} cuda vs cpu max_abs_err="
        f"{err:.3e} tol=1e-3 {'ok' if ok else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not ok:
        raise SystemExit("engine logits on cuda disagree with cpu")
    del engs
    torch.cuda.empty_cache()


def _max_err(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max())


def _close(got: np.ndarray, ref: np.ndarray, rel: float) -> tuple:
    """(ok, max abs err): finite, and max |got - ref| <= rel * max |ref|."""
    err = _max_err(got, ref)
    ok = bool(np.isfinite(got).all()) and err <= rel * float(np.abs(ref).max())
    return ok, err


# last-token logits of a 2-layer engine on cuda vs cpu in bf16 (two
# layers of bf16 rounding): max err / max |ref|
ENGINE_REL = 2e-2
# Path B, cuda vs cpu, max abs err of the put's logits (readings and
# controls in PERF.md section 6). fp32, each device quantizing its own K/V:
# K/V that differ in their last bits round to neighbouring int8/int4
# levels now and then (read 3.5e-3 and 7.3e-4; quantizing at all moves
# the logits by 5.9e-2 and 1.2). QUANT_FED_ABS: the cpu engine quantizes
# the cuda engine's K/V, so both pools hold the same bytes and only the
# rest of the forward's rounding is left (read 9.8e-6 in fp32, 3.1e-2 in
# bf16, where an unquantized pool reads 3.5e-2 and int8 moves 7.8e-2).
QUANT_ENGINE_ABS = 1e-2
QUANT_FED_ABS = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@contextlib.contextmanager
def _kv_tap(record=None, replay=None):
    """Patch the ragged engine's ``quantize_kv``: with ``record`` (a list)
    it keeps a cpu copy of every K/V it quantizes; with ``replay`` (an
    iterator over such a list) it quantizes the next recorded K/V in place
    of its own, so a second engine's pools take the first one's bytes."""
    from deepspeed_tpu_torch.inference import ragged

    real = ragged.quantize_kv

    def tapped(x, bits):
        if record is not None:
            record.append(x.cpu())
        if replay is not None:
            y = next(replay)
            if y.shape != x.shape or y.dtype != x.dtype:
                raise SystemExit(f"K/V replay out of step: {y.shape} "
                                 f"{y.dtype} for {x.shape} {x.dtype}")
            x = y.to(x.device)
        return real(x, bits)

    ragged.quantize_kv = tapped
    try:
        yield
    finally:
        ragged.quantize_kv = real


def _pool_levels(a, b, bits: int) -> tuple:
    """(share of payload entries that differ, max level difference) of
    two engines' layer-0 K and V payloads (all pages)."""
    from deepspeed_tpu_torch.ops.quantizer import unpack_kv_int4

    diff, n, worst = 0, 0, 0
    for leaf in (0, 1):
        x, y = a.kv_pool[leaf][0].cpu(), b.kv_pool[leaf][0].cpu()
        if bits == 4:
            x, y = unpack_kv_int4(x), unpack_kv_int4(y)
        d = (x.to(torch.int32) - y.to(torch.int32)).abs()
        diff, n = diff + int((d > 0).sum()), n + d.numel()
        worst = max(worst, int(d.max()))
    return diff / n, worst


def _same_pools(a, b) -> bool:
    return all(torch.equal(x.cpu(), y.cpu())
               for la, lb in zip(a.kv_pool, b.kv_pool)
               for x, y in zip(la, lb))


def _bf16_generate(engines: dict, prompts: dict) -> None:
    """generate (a prefill put, then one decode_steps chunk of 15 steps)
    on the 2-layer engines over bf16 pools, whose prefill runs take tile
    items: on cuda the put must run tile and lane items and the decode
    steps lane items alone, one launch a layer each; both streams hold 16
    in-vocabulary tokens a prompt, and their agreement is printed (bf16
    rounds differently on the two devices, so it is not required). No
    leaked blocks."""
    from deepspeed_tpu_torch.inference.ragged import assert_block_balance

    uids = list(prompts)
    for e in engines.values():
        e.flush(uids)
    before = _paged_counts()
    streams = {dev: e.generate(prompts, max_new_tokens=16)
               for dev, e in engines.items()}
    moved = tuple(a - b for a, b in zip(_paged_counts(), before))
    want = (2, 2 * (1 + 15))        # 2 layers x (1 put; the put + 15 steps)
    same = sum(a == b for u in uids
               for a, b in zip(streams["cuda"][u], streams["cpu"][u]))
    ok = (moved == want and all(
        len(t) == 16 and all(0 <= x < 32000 for x in t)
        for st in streams.values() for t in st.values()))
    for e in engines.values():
        assert_block_balance(e, expect_free=64)
    log(f"parity B: 2-layer d_model 4096 bfloat16 kv_quant=none: generate "
        f"16 tokens x 3 on cuda: tile / split launches {moved} (want "
        f"{want}); tokens equal to cpu's {same} of {16 * len(uids)}; "
        f"blocks balanced, 64 free {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("path B: generate over a bf16 pool failed")


def phase_ragged_quant_parity(cpu_model, gpu_model) -> None:
    """Path B at Llama-2-7B's width, 2 layers, the same weights on cuda
    and cpu, one put of 3 prompts (5, 40 and 77 tokens) over int8 and int4
    KV pools, in fp32 then bf16. Three cpu engines per case: one computes
    and quantizes its own K/V ("own"); one quantizes the cuda engine's K/V
    ("fed"), so its pools must equal the cuda engine's bitwise and its
    logits differ only by the rest of the forward's rounding; and, once
    per dtype, one over a bf16/fp32 pool ("none"), the control: how far
    quantizing K/V alone moves the logits, which must exceed each
    tolerance below. Both dtypes: fed within QUANT_FED_ABS, and the layer-0 payloads of
    cuda and own differ by at most one level where they differ (layer 0's
    inputs are the same embeddings on both devices, so that is the K/V
    projection's rounding alone). fp32: own within QUANT_ENGINE_ABS and 16
    greedy tokens per prompt identical on cuda and cpu. bf16: own is
    printed beside the control. Zero leaked blocks everywhere."""
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine,
                                                      assert_block_balance)

    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    prompts = {1: rng.integers(1, 32000, 5).tolist(),
               2: rng.integers(1, 32000, 40).tolist(),
               3: rng.integers(1, 32000, 77).tolist()}
    uids, toks = list(prompts), list(prompts.values())
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]

        def engine(model, dev, kvq):
            return RaggedInferenceEngine(model, RaggedConfig(
                token_budget=512, max_seqs=4, kv_block_size=16,
                n_kv_blocks=64, max_context=4096, dtype=dtype,
                kv_quant=kvq), device=dev)

        t1 = time.perf_counter()
        plain = {dev: engine(m, dev, "none")
                 for dev, m in (("cuda", gpu_model), ("cpu", cpu_model))}
        none = dict(zip(("cuda", "cpu"), _beside(
            *(lambda e=plain[dev]: e.put(uids, toks)
              for dev in ("cuda", "cpu")))))
        err_none = _max_err(none["cuda"], none["cpu"])
        log(f"parity B: 2-layer d_model 4096 {dname} kv_quant=none: put "
            f"logits cuda vs cpu max_abs_err={err_none:.3e}, max|ref| "
            f"{np.abs(none['cpu']).max():.3e} "
            f"({time.perf_counter() - t1:.1f} s)")
        if dtype == torch.bfloat16:
            _bf16_generate(plain, prompts)
        del plain
        for kvq in ("int8", "int4"):
            t1 = time.perf_counter()
            bits = int(kvq[3:])
            counter = PAGED_COUNTER[kvq]
            gpu, own, fed = (engine(gpu_model, "cuda", kvq),
                             engine(cpu_model, "cpu", kvq),
                             engine(cpu_model, "cpu", kvq))
            recorded = []
            before = getattr(pa.paged_attention, counter)
            with _kv_tap(record=recorded):
                lg = gpu.put(uids, toks)
            launched = getattr(pa.paged_attention, counter) - before
            lo = own.put(uids, toks)
            with _kv_tap(replay=iter(recorded)):
                lf = fed.put(uids, toks)
            same_fed = _same_pools(gpu, fed)
            share, levels = _pool_levels(gpu, own, bits)
            err_own, err_fed = _max_err(lg, lo), _max_err(lg, lf)
            control = _max_err(none["cpu"], lo)
            top = float(np.abs(lo).max())
            fed_tol = QUANT_FED_ABS[dtype]
            # the control must fail the tolerance that the fed run passes
            ok = (same_fed and launched == 2 and err_fed <= fed_tol
                  < control and levels <= 1 and np.isfinite(lg).all())
            line = (f"parity B: 2-layer d_model 4096 {dname} kv_quant={kvq}: "
                    f"put logits cuda vs cpu own max_abs_err={err_own:.3e}, "
                    f"fed {err_fed:.3e} (tol {fed_tol:.3e}); control cpu "
                    f"none vs {kvq} {control:.3e}, max|ref| {top:.3e}; "
                    f"layer-0 payload entries differing cuda vs own "
                    f"{share:.3e}, by <= {levels} level(s); fed pools bitwise "
                    f"equal {same_fed}; {launched} {counter}")
            if dtype == torch.float32:
                ok &= err_own <= QUANT_ENGINE_ABS < control
                for e in (gpu, own):
                    e.flush(uids)
                streams = _beside(*(lambda e=e: e.generate(
                    prompts, max_new_tokens=16) for e in (gpu, own)))[:2]
                same = streams[0] == streams[1]
                ok &= same
                line += (f"; own tol {QUANT_ENGINE_ABS:.0e}; 16 greedy "
                         f"tokens x 3 identical: {same}")
            for e in (gpu, own, fed):
                e.flush([u for u in uids if u in e.seqs])
                assert_block_balance(e, expect_free=64)
            log(f"{line}; blocks balanced, 64 free "
                f"({time.perf_counter() - t1:.1f} s) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"path B on cuda disagrees with cpu ({dname} "
                                 f"{kvq})")
            del gpu, own, fed, recorded
    gc.collect()
    torch.cuda.empty_cache()
    log(f"parity B: done in {time.perf_counter() - t0:.1f} s")


def phase_inference_parity() -> None:
    """Path A at Llama-2-7B's width, 2 layers, the same weights on cuda
    and cpu, int8 and int4 at group 256. bf16: quantized payloads and
    scales, and every dequantized weight, bitwise equal; last-token logits
    within 2e-2 of the largest. fp32, int8: 16 greedy tokens identical (in
    bf16, random weights give argmax near-ties that summation order can
    flip). int4 is not generated again: its dequantized weights are bitwise
    equal on both devices, and from there on the engine runs the same code
    as for int8, while the cpu side's int4 unpack would take about 100 s."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.engine import _is_wq
    from deepspeed_tpu_torch.models.llama import Llama

    t0 = time.perf_counter()
    cpu_model = Llama("7b", device="cpu", dtype=torch.float32, seed=3,
                      n_layers=2)
    gpu_model = Llama("7b", device="cuda", dtype=torch.float32, n_layers=2)
    params = dict(cpu_model.named_parameters())      # one set of weights
    ids = np.random.default_rng(6).integers(1, 32000, (2, 16))
    for bits in (8, 4):
        quant = {"enabled": True, "bits": bits, "group_size": 256}
        conf = {"dtype": "bfloat16", "quant": quant}
        t1 = time.perf_counter()
        before = qk.quantize_blockwise.launches
        g, c, t_cpu = _beside(
            lambda: deepspeed_tpu_torch.init_inference((gpu_model, params),
                                                       conf),
            lambda: deepspeed_tpu_torch.init_inference(
                (cpu_model, params), conf, device="cpu"))
        n_quant = qk.quantize_blockwise.launches - before
        same_q = all(torch.equal(t.cpu(), c.params[n][k] if _is_wq(
            c.params[n]) else c.params[n])
            for n, leaf in g.params.items()
            for k, t in (leaf.items() if _is_wq(leaf) else [(None, leaf)]))
        same_w = all(torch.equal(g._leaf(n).cpu(), c._leaf(n))
                     for n in c.params)
        lg, lc, t2 = _beside(lambda: g.forward(ids)[:, -1].cpu().numpy(),
                             lambda: c.forward(ids)[:, -1].numpy())
        t_cpu += t2
        ok, err = _close(lg, lc, ENGINE_REL)
        ok &= same_q and same_w and n_quant == 20
        log(f"parity A: 2-layer d_model 4096 bf16 int{bits} group 256: "
            f"{n_quant} quantize launches (2 x 9 layer leaves + embedding + "
            f"head), payloads and scales bitwise equal {same_q}, dequantized "
            f"weights bitwise equal {same_w}, last-token logits max_abs_err "
            f"{err:.3e} (2e-2 max|ref|; {time.perf_counter() - t1:.1f} s, "
            f"cpu {t_cpu:.1f} s) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"path A int{bits} bf16 on cuda disagrees with "
                             f"cpu")
        del g, c
        if bits == 4:
            continue
        t1 = time.perf_counter()
        engs = {dev: deepspeed_tpu_torch.init_inference(
            (m, params), {"dtype": "float32", "temperature": 0.0,
                          "quant": quant}, device=dev)
            for dev, m in (("cuda", gpu_model), ("cpu", cpu_model))}
        before = qk.dequantize_blockwise.launches
        card, cpu, t_cpu = _beside(
            *(lambda e=engs[dev]: e.generate(ids, max_new_tokens=16)
              for dev in ("cuda", "cpu")))
        toks = {"cuda": card, "cpu": cpu}
        n_deq = qk.dequantize_blockwise.launches - before
        same = np.array_equal(toks["cuda"], toks["cpu"])
        ok = same and n_deq == 16 * 20 and toks["cuda"].shape == (2, 32)
        log(f"parity A: 2-layer fp32 int{bits}: 16 greedy tokens x 2 "
            f"identical on cuda and cpu: {same}; {n_deq} dequantize launches "
            f"(16 forwards x 20); {time.perf_counter() - t1:.1f} s, cpu "
            f"generate {t_cpu:.1f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"path A int{bits} fp32 greedy tokens differ "
                             f"between cuda and cpu")
        del engs
    del cpu_model, gpu_model, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"parity A: done in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------- phase 5
def phase_serving(card: str, model=None, kv_quant: str = "none",
                  name: str = "Llama-2-7B", max_context: int = 4096,
                  max_prompt: int = 1536, pages: Optional[int] = None,
                  tag: Optional[str] = None) -> tuple:
    """Llama-2-7B (or ``model``, called ``name``), full width and depth,
    bf16, seeded random weights, behind ServingEngine (FCFS): 8 requests
    of 64-``max_prompt`` prompt tokens drawn from the model's vocabulary,
    32 new tokens each, over a bf16 pool of phase 5's bytes (2048 pages of
    Llama-2-7B; ``pages`` pages where given) or, with ``kv_quant``, an
    int8/int4 pool of the same bytes (path B). ``model`` reuses an earlier
    phase's weights; ``tag`` prefixes the log lines. Returns (the
    paged-attention launches of the run, the engine, the prompts) for the
    profile phase."""
    import deepspeed_tpu_torch.inference.ragged as ragged_mod
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine,
                                                      kv_blocks_for_bytes)
    from deepspeed_tpu_torch.models.llama import Llama
    from deepspeed_tpu_torch.serving.request import RequestState
    from deepspeed_tpu_torch.serving.server import ServingEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if model is None:
        model = Llama("7b", dtype=torch.bfloat16, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    n_layers = model.config.n_layers
    vocab = model.config.vocab_size
    shape = dict(token_budget=512, max_seqs=16, kv_block_size=16,
                 max_context=max_context, dtype=torch.bfloat16,
                 kv_quant=kv_quant)
    if pages is None:
        pages = kv_blocks_for_bytes(FP_POOL_BYTES, model.config,
                                    RaggedConfig(**shape))
    cfg = RaggedConfig(n_kv_blocks=pages, **shape)
    eng = RaggedInferenceEngine(model, cfg)
    torch.cuda.synchronize()
    pool_bytes = sum(t.numel() * t.element_size()
                     for leaves in eng.kv_pool for t in leaves)
    counter = PAGED_COUNTER[kv_quant]
    if tag is None:
        tag = "serving" if kv_quant == "none" else f"serving {kv_quant}"
        if name != "Llama-2-7B":
            tag = f"families: serving {name}"
    log(f"{tag}: {name} {n_params} params bf16, kv_quant={kv_quant} "
        f"pool {cfg.n_kv_blocks}x{cfg.kv_block_size} pages, {pool_bytes} B "
        f"(budget {FP_POOL_BYTES} B), built in "
        f"{time.perf_counter() - t0:.1f} s")
    # puts, puts that ran tile items / lane items (from the counters'
    # moves, which must be 0 or one a layer), and puts whose move was not
    puts = [0, 0, 0, 0]
    real_put = eng.put

    def counted_put(uids, toks):
        before = _paged_counts()
        logits = real_put(uids, toks)
        moved = [a - b for a, b in zip(_paged_counts(), before)]
        puts[0] += 1
        puts[1] += moved[0] > 0
        puts[2] += moved[1] > 0
        puts[3] += any(n not in (0, n_layers) for n in moved)
        return logits

    eng.put = counted_put
    # layer 0's call of the first put that runs a prefill chunk on tile
    # items and decode lanes on lane items, kept (not copied) for phase 5b
    mixed = {}
    real_paged = ragged_mod.paged_attention

    def recording(q, kp, vp, tables, positions, **kw):
        work = kw.get("work")
        if not mixed and kv_quant == "none" and work is not None \
                and work.n_tiles and work.n_lanes > work.n_pad:
            mixed.update(q=q, kp=kp, vp=vp, tab=tables, pos=positions,
                         slots=kw["seq_slots"], live=kw["live_pages"],
                         work=work)
        return real_paged(q, kp, vp, tables, positions, **kw)

    ragged_mod.paged_attention = recording
    rng = np.random.default_rng(0)
    lengths = rng.integers(64, max_prompt + 1, 8)
    prompts = [rng.integers(1, vocab, int(n)).tolist() for n in lengths]
    srv = ServingEngine(eng, {"policy": "fcfs", "kv_quant": kv_quant})
    try:
        # warm-up request (cuBLAS handles, allocator), outside the count
        srv.submit(prompts[0][:16], max_new_tokens=2).result(timeout=600)
        torch.cuda.synchronize()
        for name in PAGED_PATH_COUNTERS:
            setattr(pa.paged_attention, name, 0)
        puts[:] = [0, 0, 0, 0]
        t1 = time.perf_counter()
        reqs = [srv.submit(p, max_new_tokens=32) for p in prompts]
        for r in reqs:
            r.wait(timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = {n: getattr(pa.paged_attention, n)
                  for n in PAGED_PATH_COUNTERS}
        launches, (n_puts, tile_puts, item_puts, odd_puts) = \
            counts[counter], puts
    finally:
        srv.close(timeout=60)
        ragged_mod.paged_attention = real_paged
    leaks = srv.block_leaks()
    states = [r.state for r in reqs]
    ntok = [len(r.tokens) for r in reqs]
    ttft = sorted(r.ttft_s for r in reqs if r.ttft_s is not None)
    log(f"{tag}: prompt lengths {lengths.tolist()}, states "
        f"{[s.value for s in states]}, tokens {ntok}")
    ok = (all(s is RequestState.FINISHED for s in states)
          and ntok == [32] * 8 and leaks == [] and len(ttft) == 8
          and all(0 <= t < vocab for r in reqs for t in r.tokens)
          and launches == n_layers * n_puts and launches > 0
          and sum(counts[n] for n in PAGED_COUNTER.values()) == launches
          and counts["tile_launches"] == n_layers * tile_puts
          and counts["split_launches"] == n_layers * item_puts
          and odd_puts == 0 and tile_puts > 0)
    log(f"{tag}: {n_puts} engine puts ({tile_puts} with prefill tile items, "
        f"{item_puts} with lane items), paged_attention launches {counts} "
        f"({n_layers} layers x puts = {n_layers * n_puts}, all {counter}; "
        f"tile / split launches = layers x those puts), block leaks {leaks}")
    log(f"{tag} [{card}]: wall {wall:.3f} s for 8 requests, TTFT p50 "
        f"{ttft[len(ttft) // 2]:.3f} s max {ttft[-1]:.3f} s, "
        f"{sum(ntok) / wall:.1f} generated tokens/s")
    logits = eng.put([10_000], [prompts[1][:40]])
    eng.flush([10_000])
    ok = ok and logits.shape == (1, vocab) and np.isfinite(logits).all()
    log(f"{tag}: one put's logits {tuple(logits.shape)}, finite "
        f"{bool(np.isfinite(logits).all())}")
    log(f"{tag}: torch.cuda.max_memory_allocated() = "
        f"{torch.cuda.max_memory_allocated()} B")
    if not ok:
        raise SystemExit(f"{tag} phase failed")
    paths = {"launches": launches, "tile_launches": counts["tile_launches"],
             "split_launches": counts["split_launches"], "mixed": mixed,
             "streams": [list(r.tokens) for r in reqs]}
    return paths, eng, prompts


# --------------------------------------------------------------- phase 5b
def phase_paged_mixed(mixed: dict, card: str,
                      label: str = "mixed_put") -> dict:
    """Layer 0's paged-attention call of a mixed put recorded in phase 5
    (decode lanes + a prefill chunk over the serving pool): compared with
    the plain version twice, then timed beside the replaced kernel, the
    plain version and its bound."""
    if not mixed:
        raise SystemExit("serving recorded no put with both tile and lane "
                         "items")
    m = mixed
    args = (m["q"], m["kp"], m["vp"], m["tab"], m["pos"], m["slots"],
            m["live"])
    _paged_twice(label, *args, 0, work=m["work"])
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    t = _time_paged(f"{label} [{card}]", *args, flush, work=m["work"])
    plan = m["work"].plan.cpu().numpy()
    t["work"] = {"T": m["work"].T, "tiles": plan[:2 * m["work"].n_tiles]
                 .reshape(-1, 2).tolist(), "lane_items": m["work"].n_items,
                 "lanes": m["work"].n_lanes, "padding": m["work"].n_pad}
    log(f"kernels: paged_attention {label} work list {t['work']}")
    return t


# ---------------------------------------------------------------- phase 6
def phase_profile(eng, prompts, card: str, tag: str = "profile") -> None:
    """The same 8 requests again under torch.profiler (CPU + CUDA
    activities): device time by kernel, and the device's idle share of the
    wall time. Profiling slows the host, so this run's wall time is not the
    serving phase's."""
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.serving.server import ServingEngine

    srv = ServingEngine(eng, {"policy": "fcfs"})
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            reqs = [srv.submit(p, max_new_tokens=32) for p in prompts]
            for r in reqs:
                r.wait(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        srv.close(timeout=60)
    d = _device_groups(prof, {"paged_attention": ("paged_",),
                              "gemm": ("nvjet", "gemm", "xmma", "cutlass")},
                       wall)
    if d["busy_us"] <= 0:
        log(f"{tag} [{card}]: torch.profiler recorded no device time: "
            f"kernel breakdown not measured")
        return
    _log_device_groups(tag, card, "profiled run", wall, d, 8)


# --------------------------------------------------------------- phase 6b
# speculative serving of phase 5's shape (ServingConfig keys)
SPEC_SERVING = {"policy": "fcfs", "speculative": True, "spec_lookahead": 4,
                "spec_ngram": 3}
# verify rows against put of the same contexts, bf16 over 32 layers: the
# verify put computes a chain's rows in another batch than put's one-token
# steps (other cuBLAS shapes, other split-K spans), so they round
# differently: max |verify - put| / max |put|
SPEC_REL = 5e-2
SPEC_SHAPE = dict(token_budget=512, max_seqs=16, kv_block_size=16,
                  max_context=4096, dtype=torch.bfloat16)


def _draftable_prompts(rng, n: int) -> list:
    """``n`` prompts of 64-1536 tokens, each made of seeded random
    segments of 8-48 tokens, each segment repeated 2-4 times in place (so
    a prompt-lookup draft finds earlier occurrences)."""
    out = []
    for length in rng.integers(64, 1537, n):
        p = []
        while len(p) < length:
            seg = rng.integers(1, 32000, int(rng.integers(8, 49))).tolist()
            p += seg * int(rng.integers(2, 5))
        out.append(p[:int(length)])
    return out


def _resolve(eng, uids, toks) -> dict:
    """put() until every uid's prompt is prefilled: uid -> fp32 logits of
    its last token."""
    rows = {}
    logits = eng.put(list(uids), [list(t) for t in toks])
    while True:
        pending = []
        for u, row in zip(uids, logits):
            if np.isnan(row).any():
                pending.append(u)
            elif u not in rows:
                rows[u] = row
        if not pending:
            return rows
        uids = pending
        logits = eng.put(pending, [[] for _ in pending])


def _serve_counted(eng, prompts, cfg: dict, n_layers: int) -> dict:
    """The requests through ServingEngine(cfg), counting the engine's puts
    and put_specs (each must move the tile / split counters by 0 or one a
    layer) with every paged counter set to 0 just before and read just
    after. Returns the requests, wall time and counts."""
    from deepspeed_tpu_torch.serving.server import ServingEngine

    steps = {"put": 0, "put_spec": 0, "tile": 0, "split": 0, "odd": 0}
    real = {name: getattr(eng, name) for name in ("put", "put_spec")}

    def counted(name):
        def call(*args):
            before = _paged_counts()
            out = real[name](*args)
            moved = [a - b for a, b in zip(_paged_counts(), before)]
            steps[name] += 1
            steps["tile"] += moved[0] > 0
            steps["split"] += moved[1] > 0
            steps["odd"] += any(n not in (0, n_layers) for n in moved)
            return out
        return call

    for name in real:
        setattr(eng, name, counted(name))
    srv = ServingEngine(eng, cfg)
    try:
        srv.submit(prompts[0][:16], max_new_tokens=2).result(timeout=600)
        torch.cuda.synchronize()
        for name in PAGED_PATH_COUNTERS:
            setattr(pa.paged_attention, name, 0)
        for k in steps:
            steps[k] = 0
        t0 = time.perf_counter()
        reqs = [srv.submit(p, max_new_tokens=32) for p in prompts]
        for r in reqs:
            r.wait(timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: getattr(pa.paged_attention, n)
                  for n in PAGED_PATH_COUNTERS}
    finally:
        srv.close(timeout=60)
        for name in real:
            delattr(eng, name)
    return {"reqs": reqs, "wall": wall, "counts": counts, "steps": steps,
            "leaks": srv.block_leaks()}


def _verify_round(eng, n_layers: int, rng, prompts, tag: str,
                  record: bool) -> dict:
    """One put_spec at full width, driven directly: 3 sequences with
    oracle drafts (4 tokens each: the greedy continuation that twins of
    them, prefilled alike, decode by plain puts), 2 with random drafts, 1
    plain decode and a fresh 200-token prompt (a prefill chunk). The
    verify rows of the oracle chains are held against the twins' put
    logits of the same contexts (SPEC_REL); oracle chains must be accepted
    whole and random ones rejected, up to near-ties (a rejection where
    the twin's top two logits lie within twice the measured error); the
    rejected tails are trimmed as the server trims them, and the block
    balance holds. With ``record``, layer 0's paged call of the verify put
    is kept for timing."""
    import deepspeed_tpu_torch.inference.ragged as ragged_mod
    from deepspeed_tpu_torch.inference.ragged import block_balance_report

    oracle, twins, rand, plain = [1, 2, 3], [11, 12, 13], [4, 5], [6]
    fresh = 7
    ctx = {u: prompts[i][:400] for i, u in enumerate(oracle + rand + plain)}
    ctx.update({t: ctx[u] for t, u in zip(twins, oracle)})
    first = _resolve(eng, list(ctx), list(ctx.values()))
    # the twins decode 5 tokens by plain puts: their logits are put's
    # logits of the oracle chains' contexts
    chain = {t: [int(np.argmax(first[t]))] for t in twins}
    put_rows = {t: [] for t in twins}
    for _ in range(5):
        out = eng.put(twins, [[chain[t][-1]] for t in twins])
        for t, row in zip(twins, out):
            put_rows[t].append(row)
            chain[t].append(int(np.argmax(row)))
    feed = [[chain[t][0]] for t in twins] \
        + [[int(np.argmax(first[u]))] for u in rand + plain] \
        + [rng.integers(1, 32000, 200).tolist()]
    drafts = [chain[t][1:5] for t in twins] \
        + [rng.integers(1, 32000, 4).tolist() for _ in rand] + [[], []]
    uids = oracle + rand + plain + [fresh]
    seen0 = {u: eng.seqs[u].seen for u in oracle + rand}
    kept = {}
    real_paged = ragged_mod.paged_attention

    def recording(q, kp, vp, tables, positions, **kw):
        if record and not kept:
            kept.update(q=q, kp=kp, vp=vp, tab=tables, pos=positions,
                        slots=kw["seq_slots"], live=kw["live_pages"],
                        work=kw["work"], quant={
                            k: kw[k] for k in ("k_scale", "v_scale",
                                               "kv_bits")
                            if kw.get("k_scale") is not None})
        return real_paged(q, kp, vp, tables, positions, **kw)

    ragged_mod.paged_attention = recording
    before = _paged_counts()
    try:
        out, verified = eng.put_spec(uids, feed, drafts)
        torch.cuda.synchronize()
    finally:
        ragged_mod.paged_attention = real_paged
    moved = tuple(a - b for a, b in zip(_paged_counts(), before))
    want_moved = (n_layers, n_layers)
    err, scale, near, accepted = 0.0, 0.0, [], {}
    for u, t in zip(oracle, twins):
        got_chain, rows = verified[u]
        ref = np.stack(put_rows[t][:5])
        err = max(err, _max_err(rows, ref))
        scale = max(scale, float(np.abs(ref).max()))
    for u in oracle + rand:
        got_chain, rows = verified[u]
        a = np.argmax(rows, axis=-1)
        matched = 0
        while matched < len(got_chain) - 1 and \
                int(a[matched]) == got_chain[matched + 1]:
            matched += 1
        accepted[u] = matched
        if u in oracle and matched < 4:
            t = twins[oracle.index(u)]
            row = put_rows[t][matched]
            gap = float(row.max() - row[int(a[matched])])
            near.append((u, matched, gap))
        eng.trim(u, seen0[u] + matched + 1)
    trimmed = all(eng.seqs[u].seen == len(eng.seqs[u].tokens)
                  == seen0[u] + accepted[u] + 1 for u in oracle + rand)
    ok_rows = err <= SPEC_REL * scale and np.isfinite(out).all()
    ok_near = all(gap <= 2 * err for _, _, gap in near)
    eng.flush(list(eng.seqs))
    balance = block_balance_report(eng)
    ok = (ok_rows and ok_near and trimmed and moved == want_moved
          and set(verified) == set(oracle + rand)
          and all(accepted[u] == 0 for u in rand)
          and not np.isnan(out).any() and not balance["problems"]
          and balance["free"] == eng.allocator.n_blocks)
    log(f"{tag}: put_spec of 3 oracle chains, 2 random chains, 1 decode and "
        f"a 200-token prefill chunk: verify rows vs put of the same contexts "
        f"max abs err {err:.4e} (max |put| {scale:.3e}, tol SPEC_REL "
        f"{SPEC_REL} x max |put|); accepted {accepted} (oracle 4 each, "
        f"random 0); near-ties {near}; rejected tails trimmed {trimmed}, "
        f"blocks balanced; tile / split launches {moved} (want "
        f"{want_moved}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{tag}: verify put failed")
    return {"err": err, "scale": scale, "kept": kept}


def _verify_call(kept: dict, card: str, tag: str) -> dict:
    """Layer 0's paged call of the verify put: against the plain version
    twice (tile / lane counters as the work list plans), then timed beside
    its bound, the plain version and the replaced kernel."""
    k = kept
    args = (k["q"], k["kp"], k["vp"], k["tab"], k["pos"], k["slots"],
            k["live"])
    _paged_twice(f"{tag}_verify_put", *args, 0, work=k["work"], **k["quant"])
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    t = _time_paged(f"{tag}_verify_put [{card}]", *args, flush,
                    work=k["work"], **k["quant"])
    w = k["work"]
    t["work"] = {"T": w.T, "tiles": w.plan.cpu().numpy()[:2 * w.n_tiles]
                 .reshape(-1, 2).tolist(), "lane_items": w.n_items,
                 "lanes": w.n_lanes, "padding": w.n_pad}
    log(f"kernels: paged_attention {tag}_verify_put work list {t['work']}")
    return t


def _near_tie(eng, req_prompt, stream, j) -> float:
    """Top-two logit gap of a put of ``prompt + stream[:j]``: how close
    the plain run's position j was to a tie."""
    row = _resolve(eng, [900_000], [req_prompt + stream[:j]])[900_000]
    eng.flush([900_000])
    top2 = np.sort(row)[-2:]
    return float(top2[1] - top2[0])


def _handoff(model, kv_quant: str, rng, card: str) -> dict:
    """Engines A and B over ``model``, 512 pages each, prefix cache on: A
    prefills 4 prompts, exports each (``export_kv``), B imports them; both
    then decode 32 greedy tokens, which must be identical, B's imported
    pages (and scales) bitwise A's. Then ``export_prefix`` from A ->
    ``import_prefix`` into B -> B's own export: equal checksums; a put on
    B of a prompt sharing the prefix schedules only its suffix, its logits
    within SPEC_REL of A's same put."""
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine,
                                                      block_balance_report)

    cfg = RaggedConfig(n_kv_blocks=512, enable_prefix_cache=True,
                       kv_quant=kv_quant, **SPEC_SHAPE)
    a, b = RaggedInferenceEngine(model, cfg), RaggedInferenceEngine(model, cfg)
    prompts = [rng.integers(1, 32000, int(n)).tolist()
               for n in rng.integers(100, 700, 4)]
    uids = [1, 2, 3, 4]
    first = _resolve(a, uids, prompts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exports = [a.export_kv(u) for u in uids]
    t_exp = time.perf_counter() - t0
    t0 = time.perf_counter()
    for u, e in zip(uids, exports):
        b.import_kv(u, e)
    torch.cuda.synchronize()
    t_imp = time.perf_counter() - t0
    nbytes = sum(e.nbytes for e in exports)
    same_pages = all(
        torch.equal(la[a.seqs[u].blocks], lb[b.seqs[u].blocks])
        for u in uids for ga, gb in zip(a.kv_pool, b.kv_pool)
        for la, lb in zip(ga, gb))
    feed = {u: int(np.argmax(first[u])) for u in uids}
    ta, tb = a.decode_steps(feed, 32), b.decode_steps(feed, 32)
    same_tokens = ta == tb
    a.flush(uids)
    b.flush(uids)
    # prefix adoption: A's cache holds the prompts' full blocks now
    prefix = prompts[0][:min(256, len(prompts[0]) // 16 * 16)]
    t0 = time.perf_counter()
    ex = a.export_prefix(prefix)
    t_pexp = time.perf_counter() - t0
    b.prefix_cache.drop_all(b.allocator)
    t0 = time.perf_counter()
    landed = b.import_prefix(ex)
    torch.cuda.synchronize()
    t_pimp = time.perf_counter() - t0
    back = b.export_prefix(prefix)
    same_sum = back.checksum == ex.checksum and back.verify() and ex.verify()
    probe = prefix + rng.integers(1, 32000, 40).tolist()
    sched = []
    real_validate = b._validate_sched

    def spy(s):
        sched.append(sum(take for _, take in s))
        return real_validate(s)

    b._validate_sched = spy
    try:
        got = b.put([50], [probe])
    finally:
        del b._validate_sched
    ref = a.put([50], [probe])
    ok_logits, lerr = _close(got, ref, SPEC_REL)
    for e in (a, b):
        e.flush([50])
    leaks = block_balance_report(a)["problems"] \
        + block_balance_report(b)["problems"]
    ok = (not leaks and same_tokens and same_pages and landed and same_sum
          and sched == [40] and ok_logits
          and all(len(t) == 32 for t in ta.values()))
    log(f"hand-off {kv_quant} [{card}]: 4 prompts of "
        f"{[len(p) for p in prompts]} tokens: export_kv {t_exp * 1e3:.2f} "
        f"ms, import_kv {t_imp * 1e3:.2f} ms for {nbytes} B "
        f"({sum(e.n_pages for e in exports)} pages); imported pages bitwise "
        f"{same_pages}; 32 greedy tokens identical {same_tokens}; prefix "
        f"export {t_pexp * 1e3:.2f} ms / import {t_pimp * 1e3:.2f} ms, "
        f"{ex.wire_bytes} B on the wire ({ex.logical_bytes} B unquantized), "
        f"checksums equal after the round trip {same_sum}; a put of the "
        f"{len(prefix)}-token prefix + 40 tokens on B scheduled {sched} tokens, logits vs A's "
        f"max abs err {lerr:.3e} (tol SPEC_REL x max |A|); block leaks "
        f"{leaks} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"hand-off over a {kv_quant} pool failed")
    del a, b
    gc.collect()
    torch.cuda.empty_cache()
    return {"export_ms": t_exp * 1e3, "import_ms": t_imp * 1e3,
            "bytes": nbytes}


def _sampled(model, rng, card: str) -> None:
    """``generate`` at temperature 0.8, top-k 50, top-p 0.9: finite,
    in-vocabulary streams, the same seed twice the same streams, and
    decode chunks of 1 and 8 the same streams."""
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)

    prompts = {u: rng.integers(1, 32000, int(n)).tolist()
               for u, n in enumerate(rng.integers(20, 300, 4))}
    cfg = RaggedConfig(n_kv_blocks=256, temperature=0.8, top_k=50,
                       top_p=0.9, **SPEC_SHAPE)

    def run(seed, chunk):
        eng = RaggedInferenceEngine(model, cfg, seed=seed)
        t0 = time.perf_counter()
        out = eng.generate({u: list(p) for u, p in prompts.items()},
                           max_new_tokens=32, decode_chunk=chunk)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (a, wa), (b, wb), (c, wc) = run(7, 8), run(7, 8), run(7, 1)
    ok = (a == b == c and all(len(t) == 32 and all(0 <= x < 32000 for x in t)
                              for t in a.values()))
    greedy_like = sum(len(set(t)) for t in a.values())
    log(f"sampled [{card}]: generate 4 x 32 tokens at temperature 0.8, "
        f"top-k 50, top-p 0.9, seed 7: same seed twice identical "
        f"{a == b}, decode chunks 8 and 1 identical {a == c}, "
        f"{greedy_like} distinct tokens in 128; {wa:.3f} / {wb:.3f} s "
        f"(chunk 8), {wc:.3f} s (chunk 1) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("sampled decoding failed")


def phase_speculative(model, card: str) -> dict:
    """Speculative serving and the KV hand-off on Llama-2-7B (phase 5's
    model and shape): (a) 8 requests of draftable prompts through
    ServingEngine with ``speculative`` on, then off; streams identical up
    to near-ties; (b) put_spec driven directly over the bf16 pool and an
    int8 pool, layer 0's verify paged call compared and timed; (c)
    ``export_kv`` / ``import_kv`` and prefix adoption between two engines,
    bf16 and int8; (d) sampled ``generate``, seeded and chunk-invariant.
    Returns the verify launches and timings for the kernels line."""
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine,
                                                      kv_blocks_for_bytes)
    from deepspeed_tpu_torch.serving.request import RequestState

    t_phase = time.perf_counter()
    n_layers = model.config.n_layers
    rng = np.random.default_rng(9)
    prompts = _draftable_prompts(rng, 8)
    cfg = RaggedConfig(n_kv_blocks=kv_blocks_for_bytes(
        FP_POOL_BYTES, model.config, RaggedConfig(**SPEC_SHAPE)),
        **SPEC_SHAPE)
    eng = RaggedInferenceEngine(model, cfg)
    spec = _serve_counted(eng, prompts, SPEC_SERVING, n_layers)
    plain = _serve_counted(eng, prompts, {**SPEC_SERVING,
                                          "speculative": False}, n_layers)
    stats = dict(eng.spec_stats)
    rounds = {}
    for name, run in (("speculative", spec), ("plain", plain)):
        reqs, st = run["reqs"], run["steps"]
        ttft = sorted(r.ttft_s for r in reqs)
        ntok = [len(r.tokens) for r in reqs]
        c = run["counts"]
        ok = (all(r.state is RequestState.FINISHED for r in reqs)
              and ntok == [32] * 8 and run["leaks"] == []
              and c["launches"] == n_layers * (st["put"] + st["put_spec"])
              and c["launches"] > 0
              and c["tile_launches"] == n_layers * st["tile"]
              and c["split_launches"] == n_layers * st["split"]
              and st["odd"] == 0 and st["tile"] > 0)
        rounds[name] = ok
        log(f"speculative serving [{card}] {name}: {st['put']} puts + "
            f"{st['put_spec']} verify puts, paged_attention launches {c} "
            f"({n_layers} layers x steps; tile / split launches = layers x "
            f"the steps that ran them), block leaks {run['leaks']}; wall "
            f"{run['wall']:.3f} s, TTFT p50 {ttft[len(ttft) // 2]:.3f} s max "
            f"{ttft[-1]:.3f} s, {sum(ntok) / run['wall']:.1f} generated "
            f"tokens/s {'ok' if ok else 'FAIL'}")
    sreqs, preqs = spec["reqs"], plain["reqs"]
    log(f"speculative serving: prompt lengths {[len(p) for p in prompts]}; "
        f"engine spec_stats {stats} (proposed / accepted draft tokens, "
        f"verify rounds); per request proposed "
        f"{[r.spec_proposed for r in sreqs]} accepted "
        f"{[r.spec_accepted for r in sreqs]}; plain stream 0: "
        f"{preqs[0].tokens}")
    verify = _verify_round(eng, n_layers, rng, prompts, "verify bf16",
                           record=True)
    t_bf16 = _verify_call(verify["kept"], card, "bf16")
    verify["kept"].clear()
    # streams: identical, or a near-tie within the verify error measured
    same, ties = 0, []
    for p, rs, rp in zip(prompts, sreqs, preqs):
        if rs.tokens == rp.tokens:
            same += 1
            continue
        j = next(i for i, (x, y) in enumerate(zip(rs.tokens, rp.tokens))
                 if x != y)
        ties.append((rs.uid, j, _near_tie(eng, p, rp.tokens, j)))
    ok_streams = all(gap <= 2 * verify["err"] for _, _, gap in ties)
    ok = (all(rounds.values()) and stats["proposed"] > 0 and ok_streams
          and spec["steps"]["put_spec"] > 0)
    log(f"speculative serving: streams identical to the plain run {same} of "
        f"8; differing (request, first position, plain run's top-two gap) "
        f"{ties} against 2 x the verify error {2 * verify['err']:.4e}; "
        f"verify puts {spec['steps']['put_spec']} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("speculative serving failed")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # (b) over an int8 pool, counted from 0
    eng = RaggedInferenceEngine(model, RaggedConfig(
        n_kv_blocks=512, kv_quant="int8", **SPEC_SHAPE))
    for name in PAGED_PATH_COUNTERS:
        setattr(pa.paged_attention, name, 0)
    verify_q = _verify_round(eng, n_layers, rng, prompts, "verify int8",
                             record=True)
    int8_launches = pa.paged_attention.int8_launches
    t_int8 = _verify_call(verify_q["kept"], card, "int8")
    verify_q["kept"].clear()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # (c) the hand-off, (d) sampling
    handoff = {q: _handoff(model, q, rng, card) for q in ("none", "int8")}
    _sampled(model, rng, card)
    log(f"speculative: phase 6b took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": spec["counts"]["launches"],
            "tile_launches": spec["counts"]["tile_launches"],
            "split_launches": spec["counts"]["split_launches"],
            "int8_launches": int8_launches, "bf16": t_bf16, "int8": t_int8,
            "handoff": handoff, "spec_stats": stats,
            "prompts": prompts, "streams": [list(r.tokens) for r in sreqs],
            "err": {"none": verify["err"], "int8": verify_q["err"]}}


# --------------------------------------------------------------- phase 6c
REPLICA_PAGES = 512
REPLICA_SHAPE = dict(token_budget=512, max_seqs=16, kv_block_size=16,
                     max_context=4096, dtype=torch.bfloat16)
REPLICA_SERVING = {"policy": "fcfs", "stuck_tick_timeout_s": 0}


class _PutCounter:
    """Wraps engines' ``put``: counts puts and the puts that ran tile /
    lane items (the paged counters must move by 0 or one a layer)."""

    def __init__(self, n_layers: int):
        self.n_layers = n_layers
        self.steps = {"put": 0, "tile": 0, "split": 0, "odd": 0}

    def wrap(self, eng):
        real = eng.put

        def put(uids, toks):
            before = _paged_counts()
            out = real(uids, toks)
            moved = [a - b for a, b in zip(_paged_counts(), before)]
            self.steps["put"] += 1
            self.steps["tile"] += moved[0] > 0
            self.steps["split"] += moved[1] > 0
            self.steps["odd"] += any(n not in (0, self.n_layers)
                                     for n in moved)
            return out

        eng.put = put
        return eng


def _drive(servers, done, limit: int = 4000) -> None:
    """Manual driver ticks over ``servers`` until ``done()``."""
    for _ in range(limit):
        if done():
            return
        for s in servers:
            s.step()
    raise SystemExit(f"replicas made no progress in {limit} ticks")


def _streams_ok(eng, prompts, got, ref, err: float, n: int = 32) -> tuple:
    """Streams of ``n`` tokens equal to ``ref``, or differing first at a
    near-tie of the reference run: a top-two logit gap within twice the
    measured verify error (phase 6b's rule). Returns (ok, identical,
    [(request, first position, gap)])."""
    same, ties = 0, []
    for i, (p, g, r) in enumerate(zip(prompts, got, ref)):
        if g == r:
            same += 1
            continue
        j = _first_diff(g, r)
        ties.append((i, j, _near_tie(eng, p, r, j)))
    ok = (all(len(g) == n for g in got)
          and all(gap <= 2 * err for _, _, gap in ties))
    return ok, same, ties


def _replica_telemetry(tmp: str) -> tuple:
    """Install request records (JSON lines under ``tmp``), tracing and a
    fault injector with nothing armed; returns (telemetry, tracer,
    injector)."""
    from deepspeed_tpu_torch.config import TelemetryConfig
    from deepspeed_tpu_torch.resilience import chaos
    from deepspeed_tpu_torch.telemetry import (MetricsRegistry, Telemetry,
                                               get_tracer, set_telemetry)

    t = set_telemetry(Telemetry(TelemetryConfig(
        enabled=True, output_dir=tmp, jsonl_path="",
        requests_jsonl_path=os.path.join(tmp, "requests.jsonl"),
        stall_detection=False, tracing=True), registry=MetricsRegistry()))
    return t, get_tracer(), chaos.install_fault_injector(
        chaos.FaultInjector())


def _replica_telemetry_off() -> None:
    from deepspeed_tpu_torch.resilience import chaos
    from deepspeed_tpu_torch.telemetry import set_telemetry, set_tracer

    set_telemetry(None)
    set_tracer(None)
    chaos.install_fault_injector(None)


def _serve_threaded(eng, prompts, replica_id: str) -> dict:
    """The requests through a ServingEngine with its driver and watchdog
    threads: streams, wall time, and each request's TTFT read on the host
    clock here (submit to the first on_token call)."""
    from deepspeed_tpu_torch.serving.server import ServingEngine

    srv = ServingEngine(eng, {"policy": "fcfs", "stuck_tick_timeout_s": 30},
                        replica_id=replica_id)
    first, sub = {}, {}
    try:
        t0 = time.perf_counter()
        reqs = []
        for i, p in enumerate(prompts):
            sub[i] = time.perf_counter()
            reqs.append(srv.submit(
                p, max_new_tokens=32,
                on_token=lambda tok, i=i: first.setdefault(
                    i, time.perf_counter())))
        for r in reqs:
            r.wait(timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        srv.close(timeout=60)
    return {"reqs": reqs, "wall": wall, "leaks": srv.block_leaks(),
            "ttft_host": sorted(first[i] - sub[i] for i in first)}


def _telemetry_run(eng, prompts, card: str) -> dict:
    """6c (a): the 8 requests with telemetry, tracing and a fault
    injector on, every record and trace tree checked; then off / on /
    off / on on the same engine for the cost."""
    import tempfile

    from deepspeed_tpu_torch.telemetry import (trace_tree_problems,
                                               validate_chrome_trace,
                                               validate_request_record)

    with tempfile.TemporaryDirectory() as tmp:
        tel, tracer, _ = _replica_telemetry(tmp)
        try:
            run = _serve_threaded(eng, prompts, "a")
            with open(os.path.join(tmp, "requests.jsonl")) as f:
                records = [json.loads(line) for line in f]
            counters = {k: v for k, v in tel.registry.snapshot().items()
                        if k.startswith("serving/a/")}
            trees = [trace_tree_problems(tracer.spans_for_trace(r["trace_id"]))
                     for r in records]
            chrome = validate_chrome_trace(tracer.export_chrome_trace(
                os.path.join(tmp, "trace.json")))
        finally:
            _replica_telemetry_off()
        runs = {"on": [run["wall"]], "off": []}
        for mode in ("off", "on", "off", "on"):
            if mode == "on":
                _replica_telemetry(tmp)
            try:
                runs[mode].append(_serve_threaded(eng, prompts, "a")["wall"])
            finally:
                _replica_telemetry_off()
    reqs = run["reqs"]
    rec_ttft = sorted(r["ttft_s"] for r in records)
    p50_rec = rec_ttft[len(rec_ttft) // 2]
    p50_host = run["ttft_host"][len(run["ttft_host"]) // 2]
    ntok = sum(len(r.tokens) for r in reqs)
    ok = (len(records) == 8 and all(not validate_request_record(r)
                                    for r in records)
          and {r["state"] for r in records} == {"finished"}
          and len(run["ttft_host"]) == 8
          and abs(p50_rec - p50_host) <= 0.05 * p50_host
          and all(not t for t in trees) and not chrome
          and all(len(r.tokens) == 32 for r in reqs) and not run["leaks"]
          and counters.get("serving/a/completed") == 8)
    on, off = runs["on"], runs["off"]
    log(f"replicas (a) [{card}]: telemetry + tracing + fault injector on: "
        f"{len(records)} valid request records, TTFT p50 {p50_rec:.4f} s "
        f"(records) vs {p50_host:.4f} s (host clock at the first on_token), "
        f"{len(trees)} trace trees without problems, Chrome trace "
        f"problems {chrome}; wall on {[round(w, 4) for w in on]} s "
        f"({[round(ntok / w, 1) for w in on]} tokens/s), off "
        f"{[round(w, 4) for w in off]} s "
        f"({[round(ntok / w, 1) for w in off]} tokens/s), in the order on, "
        f"off, on, off, on; counters {counters} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("replica telemetry failed")
    return {"streams": [list(r.tokens) for r in reqs], "wall_on": on,
            "wall_off": off, "ttft_p50": p50_rec}


def _host_batch_timing(calls: list, card: str) -> dict:
    """6c (f): ``build_batch`` + ``fill_tables`` of each recorded put,
    native against numpy, in turns (µs per put, the host's CPU)."""
    from deepspeed_tpu_torch.ops import ragged_host as rh

    def per_put(native):
        t0 = time.perf_counter()
        for bb, ft in calls:
            rh.build_batch(*bb, native=native)
            rh.fill_tables(*ft, native=native)
        return (time.perf_counter() - t0) / len(calls) * 1e6

    nat, ref = [], []
    n0 = (rh.build_batch.native_launches, rh.fill_tables.native_launches)
    for _ in range(5):
        nat.append(per_put(True))
        ref.append(per_put(False))
    # the timing's own native calls are not the path's
    rh.build_batch.native_launches, rh.fill_tables.native_launches = n0
    out = {"native_us": min(nat), "numpy_us": min(ref), "puts": len(calls)}
    log(f"replicas (f) [{card}]: host batch build + block tables per put "
        f"over the {len(calls)} puts of (a)'s five runs: native {out['native_us']:.1f} "
        f"µs, numpy {out['numpy_us']:.1f} µs (best of 5 passes each, in "
        f"turns; host CPU: {os.cpu_count()} CPUs)")
    return out


def _migration(model, prompts, ref, kv_quant: str, err: float, card: str,
               counter) -> dict:
    """6c (b): replica a serves the 8 requests, is killed mid-decode and
    ``migrate_out`` ships its decodes to replica b (``adopt``), the rest
    re-queued there; every request must finish with 32 tokens equal to
    ``ref`` up to near-ties, and neither replica may leak a block."""
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)
    from deepspeed_tpu_torch.serving.server import ServingEngine

    cfg = RaggedConfig(n_kv_blocks=REPLICA_PAGES, kv_quant=kv_quant,
                       **REPLICA_SHAPE)
    ea = counter.wrap(RaggedInferenceEngine(model, cfg))
    eb = counter.wrap(RaggedInferenceEngine(model, cfg))
    scfg = {**REPLICA_SERVING, "kv_quant": kv_quant}
    a = ServingEngine(ea, scfg, start=False, replica_id="a")
    b = ServingEngine(eb, scfg, start=False, replica_id="b")
    times = {"export": [], "import": [], "bytes": []}
    real_exp, real_imp = ea.export_kv, eb.import_kv

    def export_kv(uid):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e = real_exp(uid)
        torch.cuda.synchronize()
        times["export"].append((time.perf_counter() - t0) * 1e3)
        times["bytes"].append(e.nbytes)
        return e

    def import_kv(uid, e):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_imp(uid, e)
        torch.cuda.synchronize()
        times["import"].append((time.perf_counter() - t0) * 1e3)

    ea.export_kv, eb.import_kv = export_kv, import_kv
    reqs = [a.submit(p, max_new_tokens=32) for p in prompts]
    _drive([a], lambda: sum(len(r.tokens) >= 4 for r in reqs) >= 4)
    at_kill = [len(r.tokens) for r in reqs]
    a.kill()
    queued, exports = a.migrate_out()
    for req, exp in exports:
        if not b.adopt(req, exp):
            raise SystemExit("replica b refused an adoption")
    for req in queued:
        if b.submit_request(req, requeue=True) is not req:
            raise SystemExit("replica b refused a re-queued request")
    _drive([b], lambda: all(r.is_terminal for r in reqs))
    got = [list(r.tokens) for r in reqs]
    ok_s, same, ties = _streams_ok(eb, prompts, got, ref, err)
    leaks = a.block_leaks() + b.block_leaks()
    ok = (ok_s and not leaks and len(exports) > 0
          and len(times["import"]) == len(exports)
          and all(r.state.value == "finished" for r in reqs))
    n = max(1, len(exports))
    log(f"replicas (b) {kv_quant} [{card}]: killed a mid-decode at tokens "
        f"{at_kill}; migrate_out shipped {len(exports)} decodes (export_kv "
        f"{sum(times['export']) / n:.3f} ms, import_kv "
        f"{sum(times['import']) / n:.3f} ms, {sum(times['bytes']) // n} B "
        f"per migrated request) and re-queued {len(queued)}; streams equal "
        f"the uninterrupted run {same} of 8, differing (request, first "
        f"position, top-two gap) {ties} against 2 x {err:.4e}; block "
        f"leaks {leaks} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"replica migration over a {kv_quant} pool failed")
    return {"export_ms": sum(times["export"]) / n,
            "import_ms": sum(times["import"]) / n,
            "bytes": sum(times["bytes"]) // n, "migrated": len(exports)}


def _evacuation(model, prompts, ref, err: float, card: str, counter):
    """6c (c): replica a (4 slots) holding queued, prefilling and decoding
    requests is killed and evacuated; everything resubmitted to replica b
    must finish equal to ``ref`` up to near-ties, with no leak. Then (e)'s
    latch on a fresh 4-slot replica: live work drains, the queue is
    rejected."""
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)
    from deepspeed_tpu_torch.resilience.preemption import PreemptionGuard
    from deepspeed_tpu_torch.serving.request import RequestState
    from deepspeed_tpu_torch.serving.server import ServingEngine

    small = RaggedConfig(n_kv_blocks=REPLICA_PAGES,
                         **{**REPLICA_SHAPE, "max_seqs": 4})
    ea = counter.wrap(RaggedInferenceEngine(model, small))
    eb = counter.wrap(RaggedInferenceEngine(model, RaggedConfig(
        n_kv_blocks=REPLICA_PAGES, **REPLICA_SHAPE)))
    a = ServingEngine(ea, REPLICA_SERVING, start=False, replica_id="a")
    b = ServingEngine(eb, REPLICA_SERVING, start=False, replica_id="b")
    reqs = [a.submit(p, max_new_tokens=32) for p in prompts]
    _drive([a], lambda: {r.state for r in reqs} >= {
        RequestState.QUEUED, RequestState.PREFILL, RequestState.DECODE})
    held = sorted({r.state.value for r in reqs})
    a.kill()
    orphans = a.evacuate()
    for r in orphans:
        if b.submit_request(r, requeue=True) is not r:
            raise SystemExit("replica b refused an evacuated request")
    _drive([b], lambda: all(r.is_terminal for r in reqs))
    ok_s, same, ties = _streams_ok(eb, prompts, [r.tokens for r in reqs],
                                   ref, err)
    leaks = a.block_leaks() + b.block_leaks()
    ok = ok_s and not leaks and len(orphans) == 8
    log(f"replicas (c) [{card}]: killed a holding {held}, evacuated "
        f"{len(orphans)} to b; streams equal the uninterrupted run {same} "
        f"of 8, differing {ties}; block leaks {leaks} "
        f"{'ok' if ok else 'FAIL'}")
    # (e) the latch
    guard = PreemptionGuard()
    c = ServingEngine(ea, REPLICA_SERVING, start=False, replica_id="c",
                      preemption_guard=guard)
    lreqs = [c.submit(p, max_new_tokens=32) for p in prompts]
    c.step()
    guard.request_stop()
    _drive([c], lambda: all(r.is_terminal for r in lreqs))
    states = [r.state.value for r in lreqs]
    late = c.submit(prompts[0], max_new_tokens=4)
    ok_latch = (states.count("finished") == 4
                and states.count("rejected") == 4
                and late.state is RequestState.REJECTED
                and not c.block_leaks())
    log(f"replicas (e) latch [{card}]: preemption latched after one tick: "
        f"states {states}, a later submit {late.state.value} "
        f"({late.error}) {'ok' if ok_latch else 'FAIL'}")
    if not (ok and ok_latch):
        raise SystemExit("replica evacuation / latch failed")


def _faults(model, prompts, ref, err: float, card: str, counter) -> None:
    """6c (e): an injected tick fault is retried and the streams stay
    those of ``ref`` (up to near-ties); a put delayed 0.4 s under a
    0.05 s stuck-tick timeout moves ``serving/e/stuck_ticks``."""
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)
    from deepspeed_tpu_torch.resilience import chaos
    from deepspeed_tpu_torch.serving.server import ServingEngine
    from deepspeed_tpu_torch.telemetry import get_telemetry

    eng = counter.wrap(RaggedInferenceEngine(model, RaggedConfig(
        n_kv_blocks=REPLICA_PAGES, **REPLICA_SHAPE)))
    chaos.install_fault_injector(chaos.FaultInjector(serving_tick_fail_at=3))
    try:
        srv = ServingEngine(eng, REPLICA_SERVING, start=False,
                            replica_id="e")
        reqs = [srv.submit(p, max_new_tokens=32) for p in prompts]
        _drive([srv], lambda: all(r.is_terminal for r in reqs))
    finally:
        inj = chaos.get_fault_injector()
        chaos.install_fault_injector(None)
    ok_s, same, ties = _streams_ok(eng, prompts, [r.tokens for r in reqs],
                                   ref, err)
    retried = [r.retries for r in reqs]
    reg = get_telemetry().registry
    ok = (ok_s and inj.injected.get("serving_tick_fail") == 1
          and max(retried) == 1 and not srv.block_leaks()
          and reg.counter("serving/e/tick_faults").value >= 1)
    log(f"replicas (e) tick fault [{card}]: injected at tick 3, retries "
        f"{retried}; streams equal the uninterrupted run {same} of 8, "
        f"differing {ties} {'ok' if ok else 'FAIL'}")
    stuck0 = reg.counter("serving/e/stuck_ticks").value
    real, delayed = eng.put, []

    def slow_put(uids, toks):
        if not delayed:
            delayed.append(1)
            time.sleep(0.4)
        return real(uids, toks)

    eng.put = slow_put
    srv = ServingEngine(eng, {"policy": "fcfs", "stuck_tick_timeout_s": 0.05},
                        replica_id="e")
    try:
        r = srv.submit(prompts[5], max_new_tokens=4)
        r.wait(timeout=120)
    finally:
        srv.close(timeout=60)
        eng.put = real
    stuck = reg.counter("serving/e/stuck_ticks").value - stuck0
    ok_w = stuck >= 1 and len(r.tokens) == 4 and srv.watchdog_unhealthy
    log(f"replicas (e) watchdog [{card}]: one put delayed 0.4 s under "
        f"stuck_tick_timeout_s 0.05: serving/e/stuck_ticks +{stuck:.0f}, "
        f"watchdog_unhealthy {srv.watchdog_unhealthy}, the request "
        f"finished with {len(r.tokens)} tokens {'ok' if ok_w else 'FAIL'}")
    if not (ok and ok_w):
        raise SystemExit("replica fault handling failed")


def _hot_swap(model, prompts, card: str, counter) -> None:
    """6c (d): serve, stop admission, then hot_swap(1, load_fn) three
    ways: an injected corrupt load and a raising load_fn each leave
    version 0 serving the same streams bitwise; a load_fn that copies a
    seed-1 Llama-2-7B into the model in place (``torch.no_grad``) serves,
    after the 2 warm-up ticks, streams bitwise those of a fresh engine on
    the seed-1 weights with the same requests."""
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)
    from deepspeed_tpu_torch.models.llama import Llama
    from deepspeed_tpu_torch.resilience import chaos
    from deepspeed_tpu_torch.serving.server import ServingEngine

    def fresh():
        return counter.wrap(RaggedInferenceEngine(model, RaggedConfig(
            n_kv_blocks=REPLICA_PAGES, **REPLICA_SHAPE)))

    srv = ServingEngine(fresh(), REPLICA_SERVING, start=False,
                        replica_id="d")

    def serve(s):
        reqs = [s.submit(p, max_new_tokens=32) for p in prompts]
        _drive([s], lambda: all(r.is_terminal for r in reqs))
        return [list(r.tokens) for r in reqs]

    def load_seed1():
        new = Llama("7b", dtype=torch.bfloat16, seed=1,
                    n_layers=model.config.n_layers)
        with torch.no_grad():
            for (_, p), (_, q) in zip(model.named_parameters(),
                                      new.named_parameters()):
                p.copy_(q)
        del new
        torch.cuda.synchronize()

    def broken():
        raise OSError("checkpoint shard missing")

    s0 = serve(srv)
    outcomes = []
    inj = chaos.install_fault_injector(chaos.FaultInjector())
    try:
        inj.arm_corrupt_swap(1)
        for fn in (load_seed1, broken):
            srv.stop_admission()
            ok = srv.hot_swap(1, fn)
            outcomes.append((ok, srv.model_version, serve(srv) == s0))
    finally:
        chaos.install_fault_injector(None)
    srv.stop_admission()
    t0 = time.perf_counter()
    swapped = srv.hot_swap(1, load_seed1)
    t_swap = time.perf_counter() - t0
    warm = [srv.warmup_remaining]
    while srv.warmup_remaining:
        srv.step()
        warm.append(srv.warmup_remaining)
    s1 = serve(srv)
    ref1 = serve(ServingEngine(fresh(), REPLICA_SERVING, start=False,
                               replica_id="d1"))
    ok = (outcomes == [(False, 0, True), (False, 0, True)] and swapped
          and srv.model_version == 1 and warm == [2, 1, 0]
          and s1 == ref1 and s1 != s0 and all(len(t) == 32 for t in s1)
          and not srv.block_leaks())
    log(f"replicas (d) hot swap [{card}]: injected corrupt load and a "
        f"raising load_fn -> (swapped, version, streams bitwise the old "
        f"ones) {outcomes}; seed-1 load_fn swapped {swapped} in "
        f"{t_swap:.2f} s, warm-up ticks left {warm}, version "
        f"{srv.model_version}; streams bitwise a fresh engine on the seed-1 "
        f"weights {s1 == ref1}, different from version 0's {s1 != s0} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("replica hot swap failed")


def phase_replicas(model, card: str, err: dict) -> dict:
    """Two Llama-2-7B replicas on the card (phase 5's requests; ``model``
    at the width of phase 5's, its depth the caller's),
    each a ``ServingEngine`` over its own 512-page engine: (a) telemetry,
    tracing and a fault injector on, then off / on interleaved; (f) the
    native host library on every put of (a), timed against numpy; (b)
    kill -> migrate_out -> adopt, bf16 and int8 pairs; (c) kill ->
    evacuate -> resubmit, and the preemption latch; (e) an injected tick
    fault and the stuck-tick watchdog; (d) hot swap. (g): the paged
    launches of the phase (counters set to 0 at its start and read at its
    end), every put on one launch a layer, split into tile and lane
    items. ``err``: phase 6b's verify errors (the near-tie rule)."""
    import deepspeed_tpu_torch.inference.ragged as ragged_mod
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)
    from deepspeed_tpu_torch.ops import ragged_host as rh
    from deepspeed_tpu_torch.serving.server import ServingEngine

    t_phase = time.perf_counter()
    n_layers = model.config.n_layers
    rng = np.random.default_rng(0)           # phase 5's requests
    lengths = rng.integers(64, 1537, 8)
    prompts = [rng.integers(1, 32000, int(n)).tolist() for n in lengths]
    counter = _PutCounter(n_layers)
    eng = RaggedInferenceEngine(model, RaggedConfig(
        n_kv_blocks=REPLICA_PAGES, **REPLICA_SHAPE))
    _resolve(eng, [77], [prompts[0][:16]])   # warm-up, outside the count
    eng.flush([77])
    torch.cuda.synchronize()
    for name in PAGED_PATH_COUNTERS:
        setattr(pa.paged_attention, name, 0)
    rh.build_batch.native_launches = rh.fill_tables.native_launches = 0
    counter.wrap(eng)
    # (a) + (f): the host batch code's arguments of every put of (a)'s
    # runs, and its native launches
    calls, real_bb, real_ft = [], ragged_mod.build_batch, \
        ragged_mod.fill_tables

    def bb(*args, **kw):
        calls.append([args, None])
        return real_bb(*args, **kw)

    def ft(*args, **kw):
        blocks, slots, max_seqs, max_pages = args
        calls[-1][1] = ([list(b) for b in blocks], list(slots), max_seqs,
                        max_pages)
        return real_ft(*args, **kw)

    ragged_mod.build_batch, ragged_mod.fill_tables = bb, ft
    try:
        puts0 = counter.steps["put"]
        tel = _telemetry_run(eng, prompts, card)
    finally:
        ragged_mod.build_batch, ragged_mod.fill_tables = real_bb, real_ft
    puts_a = counter.steps["put"] - puts0
    native = (rh.build_batch.native_launches, rh.fill_tables.native_launches)
    ok_native = native == (puts_a, puts_a) and puts_a > 0
    log(f"replicas (f): {puts_a} puts in (a), native build_batch / "
        f"fill_tables launches {native} {'ok' if ok_native else 'FAIL'}")
    if not ok_native:
        raise SystemExit("the native host library missed puts")
    host = _host_batch_timing(calls, card)
    ref = tel["streams"]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    mig = {"none": _migration(model, prompts, ref, "none", err["none"],
                              card, counter)}
    # the int8 pair against an uninterrupted int8 replica
    eq = counter.wrap(RaggedInferenceEngine(model, RaggedConfig(
        n_kv_blocks=REPLICA_PAGES, kv_quant="int8", **REPLICA_SHAPE)))
    s = ServingEngine(eq, {**REPLICA_SERVING, "kv_quant": "int8"},
                      start=False, replica_id="q")
    qreqs = [s.submit(p, max_new_tokens=32) for p in prompts]
    _drive([s], lambda: all(r.is_terminal for r in qreqs))
    del eq, s
    mig["int8"] = _migration(model, prompts, [r.tokens for r in qreqs],
                             "int8", err["int8"], card, counter)
    gc.collect()
    torch.cuda.empty_cache()
    _evacuation(model, prompts, ref, err["none"], card, counter)
    _faults(model, prompts, ref, err["none"], card, counter)
    gc.collect()
    torch.cuda.empty_cache()
    _hot_swap(model, prompts, card, counter)     # the model ends on seed 1
    counts = {n: getattr(pa.paged_attention, n) for n in PAGED_PATH_COUNTERS}
    st = counter.steps
    ok = (counts["launches"] + counts["int8_launches"]
          == n_layers * st["put"] and counts["launches"] > 0
          and counts["int8_launches"] > 0 and counts["int4_launches"] == 0
          and counts["tile_launches"] == n_layers * st["tile"]
          and counts["split_launches"] == n_layers * st["split"]
          and st["odd"] == 0 and st["tile"] > 0)
    log(f"replicas (g) [{card}]: {st['put']} puts over the phase's "
        f"replicas, paged_attention launches {counts} ({n_layers} layers x "
        f"puts = {n_layers * st['put']}; {st['tile']} puts ran tile items, "
        f"{st['split']} lane items; every launch on the Hopper kernels) "
        f"{'ok' if ok else 'FAIL'}")
    log(f"replicas: phase 6c took {time.perf_counter() - t_phase:.1f} s")
    if not ok:
        raise SystemExit("replica phase launches do not add up")
    return {"launches": counts["launches"],
            "int8_launches": counts["int8_launches"],
            "tile_launches": counts["tile_launches"],
            "split_launches": counts["split_launches"],
            "telemetry": tel, "host": host, "migration": mig}


# --------------------------------------------------------------- phase 6d
FLEET_PREFIX = 512            # tokens of each shared prefix of (a)
FLEET_SERVING = {"policy": "fcfs", "stuck_tick_timeout_s": 30}


class _FleetCounter(_PutCounter):
    """:class:`_PutCounter` for engines driven from several replica
    driver threads: one lock serializes their puts, so each put's move of
    the paged counters is its own. Also counts prefix-cache hit tokens
    (``prefix_cache.match``) and times ``export_kv`` / ``import_kv``
    (synchronized, ms) with the bytes of each export."""

    def __init__(self, n_layers: int):
        super().__init__(n_layers)
        self.lock = threading.Lock()
        self.hit_tokens = 0
        self.handoff = {"export": [], "import": [], "bytes": []}

    def wrap(self, eng):
        super().wrap(eng)
        put, lock = eng.put, self.lock

        def locked_put(uids, toks):
            with lock:
                return put(uids, toks)

        eng.put = locked_put
        if eng.prefix_cache is not None:
            match = eng.prefix_cache.match

            def counted_match(prompt):     # called inside a locked put
                shared, blocks = match(prompt)
                self.hit_tokens += shared
                return shared, blocks

            eng.prefix_cache.match = counted_match
        exp, imp, times = eng.export_kv, eng.import_kv, self.handoff

        def export_kv(uid):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e = exp(uid)
            torch.cuda.synchronize()
            times["export"].append((time.perf_counter() - t0) * 1e3)
            times["bytes"].append(e.nbytes)
            return e

        def import_kv(uid, e):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            imp(uid, e)
            torch.cuda.synchronize()
            times["import"].append((time.perf_counter() - t0) * 1e3)

        eng.export_kv, eng.import_kv = export_kv, import_kv
        return eng


def _serve_once(eng, prompts, n: int = 32) -> list:
    """Greedy streams of ``prompts`` from one manually driven replica over
    ``eng``: the uninterrupted single-engine reference."""
    from deepspeed_tpu_torch.serving.server import ServingEngine

    srv = ServingEngine(eng, REPLICA_SERVING, start=False, replica_id="ref")
    reqs = [srv.submit(p, max_new_tokens=n) for p in prompts]
    _drive([srv], lambda: all(r.is_terminal for r in reqs))
    if srv.block_leaks():
        raise SystemExit(f"reference replica leaked: {srv.block_leaks()}")
    return [list(r.tokens) for r in reqs]


def _wait(cond, what: str, timeout: float = 300.0) -> None:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise SystemExit(f"fleet: {what} within {timeout:.0f} s")
        time.sleep(0.002)


def _affinity_prompts() -> list:
    """6d (a)'s and 6e (a)'s 16 prompts: 4 seeded ``FLEET_PREFIX``-token
    prefixes x 4 seeded suffixes of 1-15 tokens (under one 16-token
    block, so each prompt's routing key is its prefix), prefix i % 4."""
    rng = np.random.default_rng(11)
    prefixes = [rng.integers(1, 32000, FLEET_PREFIX).tolist()
                for _ in range(4)]
    suffixes = [rng.integers(1, 32000, int(n)).tolist()
                for n in rng.integers(1, 16, 4)]
    return [prefixes[i % 4] + suffixes[i // 4] for i in range(16)]


def _fleet_unified(model, counter, ref_eng, err: float, card: str) -> dict:
    """6d (a) + (c): a 3-replica prefix-affinity fleet with its driver and
    monitor threads. (a) 4 seeded 512-token prefixes x 4 seeded suffixes
    of 1-15 tokens (under one 16-token block, so each prompt's routing key
    is its prefix), one request of each prefix first, then the other
    twelve; (c) the sixteen again, and the replica holding the most is
    killed once one of its requests has decoded 2 tokens."""
    import tempfile

    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)
    from deepspeed_tpu_torch.serving import ServingFleet

    prompts = _affinity_prompts()
    ref = _serve_once(ref_eng, prompts)
    ref_eng.prefix_cache.drop_all(ref_eng.allocator)
    cfg = RaggedConfig(n_kv_blocks=REPLICA_PAGES, enable_prefix_cache=True,
                       **REPLICA_SHAPE)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tel, _, _ = _replica_telemetry(tmp)
        fleet = ServingFleet(
            lambda: counter.wrap(RaggedInferenceEngine(model, cfg)),
            {"replicas": 3, "router": "prefix_affinity"}, FLEET_SERVING)
        try:
            hits0 = counter.hit_tokens
            t0 = time.perf_counter()
            reqs = [fleet.submit(p, max_new_tokens=32) for p in prompts[:4]]
            placed = [fleet._requests[r.uid][1] for r in reqs]
            _wait(lambda: all(r.is_terminal for r in reqs), "(a) warm-up")
            t1 = time.perf_counter()
            reqs += [fleet.submit(p, max_new_tokens=32) for p in prompts[4:]]
            placed += [fleet._requests[r.uid][1] for r in reqs[4:]]
            _wait(lambda: all(r.is_terminal for r in reqs), "(a) served")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            wall, cold, warm = t2 - t0, t1 - t0, t2 - t1
            # read before the near-tie puts below, which match too
            hits = counter.hit_tokens - hits0
            reg = tel.registry.snapshot()
            got = [list(r.tokens) for r in reqs]
            ok_s, same, ties = _streams_ok(ref_eng, prompts, got, ref, err)
            ttft = sorted(r.t_first_token - r.t_submit for r in reqs)
            groups = [{placed[i] for i in range(16) if i % 4 == g}
                      for g in range(4)]
            routed = {n: placed.count(n) for n in sorted(set(placed))}
            ntok = sum(len(g) for g in got)
            leaks_a = fleet.block_leaks()
            ok = (ok_s and not leaks_a and all(len(g) == 1 for g in groups)
                  and reg.get("serving/fleet/routed") == 16
                  and reg.get("serving/fleet/affinity_hits") == 16
                  and hits >= 12 * FLEET_PREFIX
                  and all(r.state.value == "finished" for r in reqs))
            log(f"fleet (a) [{card}]: 3 replicas, prefix_affinity, 16 "
                f"requests (4 prefixes x 4 suffixes): routed per replica "
                f"{routed}, replicas per prefix {[sorted(g) for g in groups]}"
                f", affinity hits {reg.get('serving/fleet/affinity_hits')}, "
                f"prefix-cache hit tokens {hits} (expect 12 x "
                f"{FLEET_PREFIX}), TTFT p50 {ttft[8]:.4f} s max "
                f"{ttft[-1]:.4f} s, {ntok} tokens in {wall:.3f} s = "
                f"{ntok / wall:.1f} tokens/s (the 4 cold requests "
                f"{cold:.3f} s, then the 12 warm {warm:.3f} s = "
                f"{384 / warm:.1f} tokens/s); streams equal the "
                f"single-engine run {same} of 16, differing (request, first "
                f"position, top-two gap) {ties} against 2 x {err:.4e}; "
                f"block leaks {leaks_a} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("fleet (a) failed")
            out["a"] = {"routed": routed, "hit_tokens": hits,
                        "ttft_p50": ttft[8], "ttft_max": ttft[-1],
                        "tokens_per_s": ntok / wall, "wall": wall,
                        "cold_s": cold, "warm_s": warm}
            # (c): the same traffic again; kill the busiest replica once
            # one of its requests is 2 tokens into its decode
            t0 = time.perf_counter()
            reqs = [fleet.submit(p, max_new_tokens=32) for p in prompts]
            where = {r.uid: fleet._requests[r.uid][1] for r in reqs}
            victim = max(sorted(set(where.values())),
                         key=list(where.values()).count)
            mine = [r for r in reqs if where[r.uid] == victim]
            _wait(lambda: any(len(r.tokens) >= 2 for r in mine),
                  "(c) a decode on the victim")
            at_kill = [len(r.tokens) for r in mine]
            if not fleet.kill_replica(victim, reason="phase 6d (c)"):
                raise SystemExit(f"fleet (c): {victim} could not be killed")
            _wait(lambda: all(r.is_terminal for r in reqs), "(c) served")
            wall_c = time.perf_counter() - t0
            reg = tel.registry.snapshot()
            got = [list(r.tokens) for r in reqs]
            ok_s, same, ties = _streams_ok(ref_eng, prompts, got, ref, err)
            fleet.drain(timeout=60)
            leaks = fleet.block_leaks()
            failovers = reg.get("serving/fleet/failovers", 0)
            ok = (ok_s and not leaks and failovers >= 1
                  and all(r.state.value == "finished" for r in reqs)
                  and len(fleet.healthy_replicas) == 2)
            log(f"fleet (c) [{card}]: killed {victim} holding {len(mine)} "
                f"requests at tokens {at_kill}; {failovers} failed over, "
                f"all 16 finished in {wall_c:.3f} s; streams equal the "
                f"single-engine run {same} of 16, differing {ties}; "
                f"healthy replicas {[r.name for r in fleet.healthy_replicas]}"
                f"; block leaks (dead replica included) {leaks} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("fleet (c) failed")
            out["c"] = {"victim": victim, "orphans": failovers,
                        "wall": wall_c}
        finally:
            fleet.close(timeout=60)
            _replica_telemetry_off()
    return out


def _fleet_disaggregated(model, counter, ref_eng, prompts, ref, err: float,
                         card: str) -> dict:
    """6d (b): 1 prefill + 3 decode replicas, driven by ``step()``: phase
    5's 8 requests each prefill on the prefill replica and move to a
    decode replica through ``export_kv`` / ``import_kv``."""
    import tempfile

    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)
    from deepspeed_tpu_torch.serving import ServingFleet

    cfg = RaggedConfig(n_kv_blocks=REPLICA_PAGES, enable_prefix_cache=True,
                       **REPLICA_SHAPE)
    times = counter.handoff
    for v in times.values():
        v.clear()
    with tempfile.TemporaryDirectory() as tmp:
        tel, _, _ = _replica_telemetry(tmp)
        fleet = ServingFleet(
            lambda: counter.wrap(RaggedInferenceEngine(model, cfg)),
            {"disaggregated": True, "prefill_replicas": 1, "replicas": 3},
            REPLICA_SERVING, start=False)
        try:
            t0 = time.perf_counter()
            reqs = [fleet.submit(p, max_new_tokens=32) for p in prompts]
            for _ in range(4000):
                if all(r.is_terminal for r in reqs):
                    break
                fleet.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            reg = tel.registry.snapshot()
            got = [list(r.tokens) for r in reqs]
            ok_s, same, ties = _streams_ok(ref_eng, prompts, got, ref, err)
            fleet.drain(timeout=60)
            leaks = fleet.block_leaks()
            n = len(times["export"])
            ok = (ok_s and not leaks and n == 8 == len(times["import"])
                  and reg.get("serving/fleet/handoffs") == 8
                  and all(r.state.value == "finished" for r in reqs))
            mb = [b / 2 ** 20 for b in times["bytes"]]
            log(f"fleet (b) [{card}]: 1 prefill + 3 decode replicas, 8 "
                f"requests: {reg.get('serving/fleet/handoffs')} hand-offs; "
                f"export_kv ms {[round(x, 3) for x in times['export']]}, "
                f"import_kv ms {[round(x, 3) for x in times['import']]}, MB "
                f"{[round(x, 2) for x in mb]} (per hand-off: export "
                f"{sum(times['export']) / max(n, 1):.3f} ms, import "
                f"{sum(times['import']) / max(n, 1):.3f} ms, "
                f"{sum(mb) / max(n, 1):.2f} MB); {sum(map(len, got))} tokens "
                f"in {wall:.3f} s; streams equal the single-engine run "
                f"{same} of 8, differing {ties} against 2 x {err:.4e}; "
                f"block leaks {leaks} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("fleet (b) failed")
        finally:
            fleet.close(timeout=60)
            _replica_telemetry_off()
    return {"handoffs": n, "export_ms": sum(times["export"]) / n,
            "import_ms": sum(times["import"]) / n,
            "bytes": sum(times["bytes"]) // n, "wall": wall}


def _fleet_scaling(model, counter, prompts, card: str) -> dict:
    """6d (d) over int8 pools, driven by ``step()``: ``scale_to(4)``, the
    8 requests, ``scale_to(2)`` while they are served (the two drained
    replicas serve out their backlog before they are reaped); then 12
    queued requests and one ``autoscale_once``, which must size the pool
    as ``compute_serving_replicas`` does for the same signals."""
    from deepspeed_tpu_torch.elasticity import compute_serving_replicas
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)
    from deepspeed_tpu_torch.serving import ServingFleet

    cfg = RaggedConfig(n_kv_blocks=REPLICA_PAGES, kv_quant="int8",
                       **REPLICA_SHAPE)
    fleet = ServingFleet(
        lambda: counter.wrap(RaggedInferenceEngine(model, cfg)),
        {"replicas": 2, "max_replicas": 4, "autoscale": True,
         "autoscale_interval_s": 1e9, "scale_up_queue_per_replica": 4.0},
        {**REPLICA_SERVING, "kv_quant": "int8"}, start=False)
    try:
        fleet.scale_to(4)
        up = len(fleet.healthy_replicas)
        reqs = [fleet.submit(p, max_new_tokens=32) for p in prompts]
        where = {fleet._requests[r.uid][1] for r in reqs}
        for _ in range(3):
            fleet.step()
        fleet.scale_to(2)
        draining = [(r.name, r.load) for r in fleet.replicas
                    if r.state == "draining"]
        for _ in range(4000):
            if all(r.is_terminal for r in reqs):
                break
            fleet.step()
        fleet.scale_to(2)                    # reaps the drained replicas
        states = sorted(r.state for r in fleet.replicas)
        burst = [fleet.submit(p[:64], max_new_tokens=8)
                 for p in prompts + prompts[:4]]
        healthy = fleet.healthy_replicas
        depth = sum(r.serving.queue_depth for r in healthy)
        want = compute_serving_replicas(
            len(healthy), queue_depth=depth,
            kv_occupancy=max(r.engine.kv_demand() for r in healthy),
            in_sla_ratio=fleet.in_sla_ratio(), config=fleet._elastic_config())
        target = fleet.autoscale_once()
        after = len(fleet.healthy_replicas)
        for _ in range(4000):
            if all(r.is_terminal for r in burst):
                break
            fleet.step()
        fleet.drain(timeout=60)
        leaks = fleet.block_leaks()
        ok = (up == 4 and len(where) == 4 and len(draining) == 2
              and all(load > 0 for _, load in draining)
              and states == ["dead", "dead", "healthy", "healthy"]
              and all(r.state.value == "finished" and len(r.tokens) == 32
                      for r in reqs)
              and depth == 12 and target == want == 3 and after == 3
              and all(r.state.value == "finished" for r in burst)
              and not leaks)
        log(f"fleet (d) int8 pools [{card}]: scale_to(4) -> {up} healthy, "
            f"8 requests over {len(where)} replicas, scale_to(2) drained "
            f"{draining} (name, load) which served out their backlog: "
            f"states {states}; then {depth} queued requests: autoscale_once "
            f"-> {target} (compute_serving_replicas {want}), {after} "
            f"healthy; all finished; block leaks {leaks} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("fleet (d) failed")
    finally:
        fleet.close(timeout=60)
    return {"scaled_up": up, "drained": len(draining), "target": target}


def _fleet_hedge(model, counter, ref_eng, prompts, ref, err: float,
                 card: str) -> dict:
    """6d (e): two replicas with hedging on, under a ``SimClock`` and
    ``step()``; replica-0 degraded 8x by the fault injector (7 of 8 busy
    ticks stall). Its request misses half its TTFT deadline, a shadow goes
    to replica-1 and wins; the primary is cancelled with its KV
    discarded unpublished and its span suppressed."""
    import tempfile

    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)
    from deepspeed_tpu_torch.resilience.clock import SimClock
    from deepspeed_tpu_torch.serving import ServingFleet

    cfg = RaggedConfig(n_kv_blocks=REPLICA_PAGES, enable_prefix_cache=True,
                       **REPLICA_SHAPE)
    sim = SimClock(start=100.0)
    with tempfile.TemporaryDirectory() as tmp:
        tel, _, inj = _replica_telemetry(tmp)
        fleet = ServingFleet(
            lambda: counter.wrap(RaggedInferenceEngine(model, cfg)),
            {"replicas": 2, "hedge": True, "hedge_ttft_fraction": 0.5},
            REPLICA_SERVING, start=False, clock=sim)
        try:
            inj.degrade_replica("replica-0", 8)
            delivered = []
            reqs = [fleet.submit(p, max_new_tokens=32, ttft_deadline_s=0.04,
                                 client_request_id=f"h{i}",
                                 on_token=delivered.append if i == 0
                                 else None)
                    for i, p in enumerate(prompts[:2])]
            placed = [fleet._requests[r.uid][1] for r in reqs]
            for _ in range(4000):
                if all(r.is_terminal for r in reqs) and not fleet._hedges:
                    break
                fleet.step()
                sim.advance(0.01)
            snap = fleet.gray_snapshot()
            reg = tel.registry.snapshot()
            fleet.drain(timeout=60)
            leaks = fleet.block_leaks()
        finally:
            fleet.close(timeout=60)
            tel.close()
            _replica_telemetry_off()
        with open(os.path.join(tmp, "requests.jsonl")) as f:
            records = [json.loads(line) for line in f]
    pairs = snap["hedges"]
    won = [p for p in pairs if p["winner_uid"] == p["shadow_uid"]]
    crids = sorted(r["client_request_id"] for r in records)
    suppressed = reg.get("serving/replica-0/hedge_suppressed_spans", 0)
    ok_s, same, ties = _streams_ok(ref_eng, prompts[:1], [delivered],
                                   ref[:1], err)
    ok = (placed == ["replica-0", "replica-1"] and len(won) >= 1
          and reg.get("serving/fleet/hedges", 0) >= 1
          and crids == ["h0", "h1"] and suppressed >= 1 and ok_s
          and not leaks)
    log(f"fleet (e) [{card}]: hedge on, replica-0 degraded 8x, requests "
        f"placed {placed}: {snap['hedged_total']} hedge(s) dispatched, "
        f"shadow won {len(won)}, hedge_suppressed_spans on replica-0 "
        f"{suppressed}, request records {crids} (one per client request), "
        f"the client's stream of request h0 equals the single-engine run: "
        f"{bool(same)} (differing {ties}); block leaks {leaks} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("fleet (e) failed")
    return {"hedges": snap["hedged_total"], "suppressed": suppressed}


def phase_fleet(model, card: str, err: dict) -> dict:
    """6d: ``ServingFleet`` over Llama-2-7B replicas (``model`` shared by
    every replica: the factory's fresh engine, same weights), each replica
    a 512-page engine: (a) + (c) a threaded prefix-affinity fleet and a
    failover, (b) disaggregated prefill -> decode hand-offs, (d) scaling
    and one autoscale decision over int8 pools, (e) a hedge. The paged
    counters are set to 0 at the phase's start and read at its end (its
    fleets' and its reference runs' puts, every one on one launch a layer,
    split into tile and lane items). ``err``: phase 6b's verify errors."""
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    n_layers = model.config.n_layers
    counter = _FleetCounter(n_layers)
    rng = np.random.default_rng(0)           # phase 5's requests
    lengths = rng.integers(64, 1537, 8)
    prompts = [rng.integers(1, 32000, int(n)).tolist() for n in lengths]
    for name in PAGED_PATH_COUNTERS:
        setattr(pa.paged_attention, name, 0)
    ref_eng = counter.wrap(RaggedInferenceEngine(model, RaggedConfig(
        n_kv_blocks=REPLICA_PAGES, enable_prefix_cache=True,
        **REPLICA_SHAPE)))
    ref = _serve_once(ref_eng, prompts)
    ref_eng.prefix_cache.drop_all(ref_eng.allocator)
    out = {"unified": _fleet_unified(model, counter, ref_eng, err["none"],
                                     card)}
    gc.collect()
    out["disaggregated"] = _fleet_disaggregated(
        model, counter, ref_eng, prompts, ref, err["none"], card)
    gc.collect()
    torch.cuda.empty_cache()
    out["scaling"] = _fleet_scaling(model, counter, prompts, card)
    gc.collect()
    torch.cuda.empty_cache()
    out["hedge"] = _fleet_hedge(model, counter, ref_eng, prompts, ref,
                                err["none"], card)
    del ref_eng
    counts = {n: getattr(pa.paged_attention, n) for n in PAGED_PATH_COUNTERS}
    st = counter.steps
    ok = (counts["launches"] + counts["int8_launches"]
          == n_layers * st["put"] and counts["launches"] > 0
          and counts["int8_launches"] > 0 and counts["int4_launches"] == 0
          and counts["tile_launches"] == n_layers * st["tile"]
          and counts["split_launches"] == n_layers * st["split"]
          and st["odd"] == 0 and st["tile"] > 0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"fleet (g) [{card}]: {st['put']} puts over the phase's fleets and "
        f"reference runs, paged_attention launches {counts} ({n_layers} "
        f"layers x puts = {n_layers * st['put']}; {st['tile']} puts ran "
        f"tile items, {st['split']} lane items; every launch on the Hopper "
        f"kernels); peak memory {peak:.2f} GiB {'ok' if ok else 'FAIL'}")
    took = time.perf_counter() - t_phase
    log(f"fleet: phase 6d took {took:.1f} s")
    if not ok:
        raise SystemExit("fleet phase launches do not add up")
    out.update({"launches": counts["launches"],
                "int8_launches": counts["int8_launches"],
                "tile_launches": counts["tile_launches"],
                "split_launches": counts["split_launches"],
                "peak_gib": peak, "seconds": took})
    return out



# --------------------------------------------------------------- phase 6e
SHALLOW_LAYERS = 8            # 6c-6e: Llama-2-7B's 32 layers cut (time)
REGION_FLEET = {"replicas": 2, "router": "prefix_affinity"}
REGION_DISAGG = {"disaggregated": True, "prefill_replicas": 1,
                 "replicas": 1, "respawn": False}
# (d): a canary slice of half the tenants, a short observe window for the
# rollout that promotes and a long one for the one that must roll back
REGION_ROLLOUT = {"canary_fraction": 0.5, "canary_observe_ticks": 20,
                  "slo_regression_threshold": 0.2, "min_canary_samples": 4,
                  "warmup_ticks": 1, "swap_retry_limit": 2,
                  "max_flip_attempts": 4}
ROLLOUT_DT = 0.01             # virtual seconds a region step in (d)
ROLLOUT_DEADLINE = 0.25       # (d)'s regression run: 25 region steps
ROLLOUT_TOKENS = 16
ROLLOUT_WAVES = 40
# region steps without arrivals after each wave of (d): the controller
# counts a flipped replica only at a poll that finds it accepting with no
# load, and a request arriving between the end of its warm-up and that
# poll lands on it first (ROADMAP Queue C, C5)
ROLLOUT_GAP = 2


def _region_place(region, req) -> tuple:
    """(cell, replica) a request was routed to, read right after submit."""
    cell = region._requests.get(req.uid, (None, None))[1]
    fleet = region._cells[cell].fleet if cell is not None else None
    rep = (fleet._requests.get(req.uid, (None, None))[1]
           if fleet is not None else None)
    return cell, rep


def _region_unified(factory, counter, ref_eng, err: float, card: str) -> dict:
    """6e (a) + (b): 2 cells of 2 prefix-affinity replicas behind a
    ``Region`` with its monitor and every replica's driver thread. (a)
    6d (a)'s 16 requests, one of each prefix first, then the other
    twelve; (b) the sixteen again, and the cell holding the most is
    killed once one of its requests has decoded 2 tokens."""
    import tempfile

    from deepspeed_tpu_torch.serving import Region

    prompts = _affinity_prompts()
    ref = _serve_once(ref_eng, prompts)
    ref_eng.prefix_cache.drop_all(ref_eng.allocator)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tel, _, _ = _replica_telemetry(tmp)
        region = Region(factory, {"cells": 2}, REGION_FLEET, FLEET_SERVING,
                        start=True)
        try:
            hits0 = counter.hit_tokens
            t0 = time.perf_counter()
            reqs = [region.submit(p, max_new_tokens=32) for p in prompts[:4]]
            placed = [_region_place(region, r) for r in reqs]
            _wait(lambda: all(r.is_terminal for r in reqs),
                  "region (a) warm-up")
            t1 = time.perf_counter()
            reqs += [region.submit(p, max_new_tokens=32)
                     for p in prompts[4:]]
            placed += [_region_place(region, r) for r in reqs[4:]]
            _wait(lambda: all(r.is_terminal for r in reqs),
                  "region (a) served")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            wall, cold, warm = t2 - t0, t1 - t0, t2 - t1
            hits = counter.hit_tokens - hits0
            reg = tel.registry.snapshot()
            got = [list(r.tokens) for r in reqs]
            ok_s, same, ties = _streams_ok(ref_eng, prompts, got, ref, err)
            ttft = sorted(r.t_first_token - r.t_submit for r in reqs)
            groups = [sorted({placed[i] for i in range(16) if i % 4 == g})
                      for g in range(4)]
            ntok = sum(len(g) for g in got)
            leaks = region.block_leaks()
            ok = (ok_s and not leaks and all(len(g) == 1 for g in groups)
                  and reg.get("serving/region/routed") == 16
                  and hits >= 12 * FLEET_PREFIX
                  and all(r.state.value == "finished" for r in reqs))
            log(f"region (a) [{card}]: 2 cells x 2 replicas, "
                f"prefix_affinity, 16 requests (4 prefixes x 4 suffixes): "
                f"(cell, replica) per prefix {groups}, routed "
                f"{reg.get('serving/region/routed')}, prefix-cache hit "
                f"tokens {hits} (expect 12 x {FLEET_PREFIX}), TTFT p50 "
                f"{ttft[8]:.4f} s max {ttft[-1]:.4f} s, {ntok} tokens in "
                f"{wall:.3f} s = {ntok / wall:.1f} tokens/s (the 4 cold "
                f"requests {cold:.3f} s, then the 12 warm {warm:.3f} s = "
                f"{384 / warm:.1f} tokens/s); streams equal the "
                f"single-engine run {same} of 16, differing (request, first "
                f"position, top-two gap) {ties} against 2 x {err:.4e}; "
                f"block leaks {leaks} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("region (a) failed")
            out["a"] = {"placed": groups, "hit_tokens": hits,
                        "ttft_p50": ttft[8], "ttft_max": ttft[-1],
                        "tokens_per_s": ntok / wall, "wall": wall,
                        "cold_s": cold, "warm_s": warm}
            t0 = time.perf_counter()
            reqs = [region.submit(p, max_new_tokens=32) for p in prompts]
            where = {r.uid: _region_place(region, r)[0] for r in reqs}
            victim = max(sorted(set(where.values())),
                         key=list(where.values()).count)
            mine = [r for r in reqs if where[r.uid] == victim]
            _wait(lambda: any(len(r.tokens) >= 2 for r in mine),
                  "(b) a decode on the victim cell")
            at_kill = [len(r.tokens) for r in mine]
            if not region.kill_cell(victim, reason="phase 6e (b)"):
                raise SystemExit(f"region (b): {victim} could not be killed")
            _wait(lambda: all(r.is_terminal for r in reqs), "(b) served")
            wall_b = time.perf_counter() - t0
            reg = tel.registry.snapshot()
            got = [list(r.tokens) for r in reqs]
            ok_s, same, ties = _streams_ok(ref_eng, prompts, got, ref, err)
            region.drain(timeout=60)
            leaks = region.block_leaks()
            orphans = reg.get("serving/region/cell_failovers", 0)
            cells = {c.name: c.state for c in region.cells}
            ok = (ok_s and not leaks and orphans >= 1
                  and all(r.state.value == "finished" for r in reqs)
                  and list(cells.values()).count("dead") == 1)
            log(f"region (b) [{card}]: killed {victim} holding {len(mine)} "
                f"requests at tokens {at_kill}; {orphans} orphans re-placed "
                f"on the other cell, all 16 finished in {wall_b:.3f} s; "
                f"streams equal the single-engine run {same} of 16, "
                f"differing {ties}; cells {cells}; block leaks (the dead "
                f"cell's included) {leaks} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("region (b) failed")
            out["b"] = {"victim": victim, "orphans": orphans,
                        "wall": wall_b}
        finally:
            region.close(timeout=60)
            _replica_telemetry_off()
    return out


def _region_partition(factory, counter, ref_eng, prompts, ref, err: float,
                      card: str) -> dict:
    """6e (c): 2 cells of 1 prefill + 1 decode replica, driven by
    ``step()``. Cell-0 loses its decode replica, phase 5's 8 requests are
    submitted, and after the first step the region and cell-0 are severed
    from cell-1 while hand-offs are in flight: cell-0's hand-offs escalate
    across cells, meet ``CellUnreachable`` and are decoded by cell-0's
    prefill replica; cell-1, unreachable, serves out its own. 6 short
    requests submitted during the partition all queue on cell-0; the heal
    and the poll after it rebalance the queue onto cell-1."""
    import tempfile

    from deepspeed_tpu_torch.serving import CellUnreachable, Region
    from deepspeed_tpu_torch.serving.cell import check_reachable

    burst = [p[:48] for p in prompts[:6]]
    ref_burst = _serve_once(ref_eng, burst)
    times = counter.handoff
    for v in times.values():
        v.clear()

    def drive(reqs):
        for _ in range(4000):
            if all(r.is_terminal for r in reqs):
                return
            region.step()
        raise SystemExit("region (c) made no progress")

    with tempfile.TemporaryDirectory() as tmp:
        tel, _, inj = _replica_telemetry(tmp)
        region = Region(factory, {"cells": 2, "rebalance_threshold": 1.0},
                        REGION_DISAGG, REPLICA_SERVING, start=False)
        try:
            cell0 = region._cells["cell-0"]
            decode = [r.name for r in cell0.fleet.replicas
                      if r.role == "decode"]
            cell0.fleet.kill_replica(decode[0], reason="phase 6e (c)")
            t0 = time.perf_counter()
            reqs = [region.submit(p, max_new_tokens=32) for p in prompts]
            placed = [_region_place(region, r)[0] for r in reqs]
            region.step()
            inj.sever({"cell-0", region.name}, {"cell-1"})
            try:
                check_reachable("cell-0", "cell-1", op="kv_adoption")
                typed = None
            except CellUnreachable as e:
                typed = f"{type(e).__name__}: {e}"
            drive(reqs)
            served = [r.state.value for r in reqs]
            late = [region.submit(p, max_new_tokens=32) for p in burst]
            before = [_region_place(region, r)[0] for r in late]
            inj.heal_partitions()
            region.poll()
            after = [_region_place(region, r)[0] for r in late]
            drive(late)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            reg = tel.registry.snapshot()
            ok_a, same_a, ties_a = _streams_ok(
                ref_eng, prompts, [list(r.tokens) for r in reqs], ref, err)
            ok_b, same_b, ties_b = _streams_ok(
                ref_eng, burst, [list(r.tokens) for r in late], ref_burst,
                err)
            region.drain(timeout=60)
            leaks = region.block_leaks()
        finally:
            region.close(timeout=60)
            _replica_telemetry_off()
    handoffs = sum(v for k, v in reg.items()
                   if k.endswith("/fleet/handoffs"))
    blocked = reg.get("serving/region/partition_blocked_handoffs", 0)
    degrades = reg.get("serving/region/handoff_degrades", 0)
    adopted = reg.get("serving/region/handoff_escalations", 0)
    moved = reg.get("serving/region/rebalanced", 0)
    n = len(times["export"])
    mb = [b / 2 ** 20 for b in times["bytes"]]
    ok = (ok_a and ok_b and not leaks and typed is not None
          and "cell-0" in placed and "cell-1" in placed
          and served == ["finished"] * 8 and blocked >= 1 and degrades >= 1
          and set(before) == {"cell-0"} and "cell-1" in after and moved >= 1
          and all(r.state.value == "finished" for r in late))
    log(f"region (c) [{card}]: 2 cells x (1 prefill + 1 decode), cell-0's "
        f"decode replica dead, phase 5's 8 requests on cells {placed}; "
        f"severed {{cell-0, region}} | {{cell-1}} after the first step: "
        f"check_reachable -> {typed}; {adopted} cross-cell adoption(s) "
        f"before the sever, {blocked} blocked by the partition, {degrades} "
        f"decoded by cell-0's prefill replica; all 8 finished while "
        f"partitioned {served == ['finished'] * 8}; 6 requests submitted "
        f"during the partition on {before}, after the heal and a poll on "
        f"{after} ({moved} rebalanced); {handoffs} hand-offs, export_kv ms "
        f"{[round(x, 3) for x in times['export']]}, import_kv ms "
        f"{[round(x, 3) for x in times['import']]}, MB "
        f"{[round(x, 2) for x in mb]} (per hand-off: export "
        f"{sum(times['export']) / max(n, 1):.3f} ms, import "
        f"{sum(times['import']) / max(len(times['import']), 1):.3f} ms, "
        f"{sum(mb) / max(n, 1):.2f} MB); 14 requests in {wall:.3f} s; "
        f"streams equal the single-engine run {same_a} of 8 and {same_b} "
        f"of 6, differing {ties_a + ties_b}; block leaks {leaks} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("region (c) failed")
    return {"handoffs": handoffs, "blocked": blocked, "degrades": degrades,
            "adopted": adopted, "rebalanced": moved,
            "export_ms": sum(times["export"]) / max(n, 1),
            "import_ms": sum(times["import"]) / max(len(times["import"]), 1),
            "bytes": sum(times["bytes"]) // max(n, 1), "wall": wall}


def _region_rollout(model, counter, cfg, ref_eng, err: float,
                    card: str) -> dict:
    """6e (d): 2 cells of 2 replicas on version 1 (``model``), driven by
    ``step()`` under a ``SimClock``, waves of 8 requests (8 seeded prompts,
    8 tenants), each served out and followed by ``ROLLOUT_GAP`` quiet
    steps. ``start_rollout(2, load_fn)`` to a second
    Llama-2-7B (seed 2) runs to DONE; then, on a fresh region, a rollout
    to it with the injected canary SLO regression (``degrade_model_version``,
    deadlines of 25 steps) must roll back. The ``load_fn`` points the
    engine of the one replica being flipped (admission stopped, no load,
    not on the target version) at the target version's model."""
    import tempfile

    from deepspeed_tpu_torch.inference.ragged import RaggedInferenceEngine
    from deepspeed_tpu_torch.models.llama import Llama
    from deepspeed_tpu_torch.resilience.clock import SimClock
    from deepspeed_tpu_torch.serving import TERMINAL_PHASES, Region

    v2 = Llama("7b", dtype=torch.bfloat16, seed=2,
               n_layers=model.config.n_layers)
    models = {1: model, 2: v2}
    rng = np.random.default_rng(12)
    pool = [rng.integers(1, 32000, int(n)).tolist()
            for n in rng.integers(24, 65, 8)]
    ref_eng2 = counter.wrap(RaggedInferenceEngine(v2, cfg))
    refs = {1: _serve_once(ref_eng, pool, ROLLOUT_TOKENS),
            2: _serve_once(ref_eng2, pool, ROLLOUT_TOKENS)}
    engs = {1: ref_eng, 2: ref_eng2}
    factory = (lambda: counter.wrap(RaggedInferenceEngine(model, cfg)))

    def run(regress: bool) -> dict:
        sim = SimClock(start=100.0)
        rollout = dict(REGION_ROLLOUT,
                       canary_observe_ticks=120 if regress else 20)
        flips = []
        with tempfile.TemporaryDirectory() as tmp:
            tel, _, inj = _replica_telemetry(tmp)
            region = Region(factory, {"cells": 2},
                            {"replicas": 2, "router": "least_loaded",
                             "respawn": False},
                            {**REPLICA_SERVING, "model_version": 1,
                             "rollout": rollout},
                            start=False, clock=sim)

            def load_fn():
                ro = region.rollout
                target = (ro.stable_version if ro.phase == "rolling_back"
                          else ro.target_version)
                flipping = [r for c in region.live_cells
                            for r in c.fleet.replicas
                            if r.state == "healthy" and not r.accepting
                            and r.load == 0 and r.version != target]
                if len(flipping) != 1:
                    raise SystemExit(f"region (d): {len(flipping)} replicas "
                                     f"being flipped, expected one")
                rep = flipping[0]
                rep.engine.model = models[target]
                flips.append((rep.name, rep.version, target))

            reqs, steps = [], 0
            try:
                t0 = time.perf_counter()
                for wave in range(ROLLOUT_WAVES):
                    batch = [region.submit(
                        p, max_new_tokens=ROLLOUT_TOKENS, tenant=f"t{i}",
                        deadline_s=ROLLOUT_DEADLINE if regress else None)
                        for i, p in enumerate(pool)]
                    reqs += batch
                    if wave == 0:
                        started = region.start_rollout(2, load_fn=load_fn)
                        if regress:
                            inj.degrade_model_version(2)
                    gap = ROLLOUT_GAP
                    while gap:
                        region.step()
                        sim.advance(ROLLOUT_DT)
                        steps += 1
                        gap -= all(r.is_terminal for r in batch)
                    if region.rollout.phase in TERMINAL_PHASES:
                        break
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                reg = tel.registry.snapshot()
                phase = region.rollout.phase
                log_kinds = [row["kind"] for row in region.version_log]
                reps = [(r.name, r.version, models[r.version] is r.engine.model)
                        for c in region.live_cells for r in c.fleet.replicas
                        if r.state != "dead"]
                region.drain(timeout=60)
                leaks = region.block_leaks()
            finally:
                region.close(timeout=60)
                _replica_telemetry_off()
        mixed = sum(len(set(r.served_versions)) != 1 for r in reqs)
        by_version = {}
        for v in (1, 2):
            mine = [(pool.index(r.prompt), list(r.tokens)) for r in reqs
                    if r.served_versions == [v]]
            by_version[v] = (len(mine), _streams_ok(
                engs[v], [pool[i] for i, _ in mine], [g for _, g in mine],
                [refs[v][i] for i, _ in mine], err, ROLLOUT_TOKENS))
        if phase not in TERMINAL_PHASES:
            raise SystemExit(f"region (d): rollout still {phase} after "
                             f"{ROLLOUT_WAVES} waves")
        return {"started": started, "phase": phase, "log": log_kinds,
                "reps": reps, "flips": flips, "mixed": mixed,
                "by_version": by_version, "steps": steps, "wall": wall,
                "requests": len(reqs), "leaks": leaks,
                "finished": sum(r.state.value == "finished" for r in reqs),
                "regressions": reg.get("serving/rollout/canary_regressions",
                                       0),
                "degraded": sum(v for key, v in reg.items()
                                if key.endswith("/degraded_ticks"))}

    def report(tag, r, want_phase, want_version, want_log):
        n1, (ok1, same1, ties1) = r["by_version"][1]
        n2, (ok2, same2, ties2) = r["by_version"][2]
        ok = (r["started"] and r["phase"] == want_phase and r["mixed"] == 0
              and ok1 and ok2 and n2 > 0 and not r["leaks"]
              and r["finished"] == r["requests"]
              and all(v == want_version and same for _, v, same in r["reps"])
              and want_log(r["log"]))
        log(f"region (d) {tag} [{card}]: {r['requests']} requests over "
            f"{r['steps']} region steps ({r['wall']:.3f} s): phase "
            f"{r['phase']}, version_log {r['log']}, flips (replica, from, "
            f"to) {r['flips']}, replicas (name, version, engine on that "
            f"version's model) {r['reps']}; canary regressions "
            f"{r['regressions']}, degraded ticks {r['degraded']}; streams "
            f"mixing versions {r['mixed']}; served on v1 {n1} (equal to "
            f"the v1 single-engine run {same1}, differing {ties1}), on v2 "
            f"{n2} (equal to the v2 single-engine run {same2}, differing "
            f"{ties2}); block leaks {r['leaks']} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"region (d) {tag} failed")

    done = run(regress=False)
    report("rollout", done, "done", 2,
           lambda kinds: kinds == ["start", "canary_live", "promote",
                                   "done"])
    gc.collect()
    back = run(regress=True)
    report("canary regression", back, "rolled_back", 1,
           lambda kinds: kinds[0] == "start" and "rollback" in kinds
           and kinds[-1] == "rolled_back" and "done" not in kinds)
    del ref_eng2, v2, models, engs
    return {"done_steps": done["steps"], "done_wall": done["wall"],
            "done_flips": len(done["flips"]),
            "rollback_steps": back["steps"], "rollback_wall": back["wall"],
            "rollback_flips": len(back["flips"])}


def phase_region(model, card: str, err: dict) -> dict:
    """6e: a ``Region`` of Llama-2-7B cells (``model`` shared by every
    replica, each a fresh 512-page engine): (a) + (b) two-tier routing
    with threads and a whole-cell outage, (c) a partition of a
    disaggregated region, its heal and rebalance, (d) a rollout to a
    second model's weights and one that rolls back. The paged counters
    are set to 0 at the phase's start and read at its end (every put of
    its regions and reference runs on one launch a layer, split into tile
    and lane items). ``err``: phase 6b's verify errors."""
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    n_layers = model.config.n_layers
    counter = _FleetCounter(n_layers)
    rng = np.random.default_rng(0)           # phase 5's requests
    lengths = rng.integers(64, 1537, 8)
    prompts = [rng.integers(1, 32000, int(n)).tolist() for n in lengths]
    for name in PAGED_PATH_COUNTERS:
        setattr(pa.paged_attention, name, 0)
    cfg = RaggedConfig(n_kv_blocks=REPLICA_PAGES, enable_prefix_cache=True,
                       **REPLICA_SHAPE)
    factory = (lambda: counter.wrap(RaggedInferenceEngine(model, cfg)))
    ref_eng = counter.wrap(RaggedInferenceEngine(model, cfg))
    out = {"unified": _region_unified(factory, counter, ref_eng,
                                      err["none"], card)}
    gc.collect()
    torch.cuda.empty_cache()
    ref = _serve_once(ref_eng, prompts)
    ref_eng.prefix_cache.drop_all(ref_eng.allocator)
    out["partition"] = _region_partition(factory, counter, ref_eng, prompts,
                                         ref, err["none"], card)
    gc.collect()
    torch.cuda.empty_cache()
    del ref_eng
    # (d) without the prefix cache: a hot swap keeps the engine's cached
    # pages, which hold the old version's KV (ROADMAP Queue C)
    plain = RaggedConfig(n_kv_blocks=REPLICA_PAGES, **REPLICA_SHAPE)
    out["rollout"] = _region_rollout(
        model, counter, plain,
        counter.wrap(RaggedInferenceEngine(model, plain)), err["none"], card)
    gc.collect()
    torch.cuda.empty_cache()
    counts = {n: getattr(pa.paged_attention, n) for n in PAGED_PATH_COUNTERS}
    st = counter.steps
    ok = (counts["launches"] == n_layers * st["put"] and counts["launches"] > 0
          and counts["int8_launches"] == 0 and counts["int4_launches"] == 0
          and counts["tile_launches"] == n_layers * st["tile"]
          and counts["split_launches"] == n_layers * st["split"]
          and st["odd"] == 0 and st["tile"] > 0 and st["split"] > 0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"region (e) [{card}]: {st['put']} puts over the phase's regions and "
        f"reference runs, paged_attention launches {counts} ({n_layers} "
        f"layers x puts = {n_layers * st['put']}; {st['tile']} puts ran "
        f"tile items, {st['split']} lane items; every launch on the Hopper "
        f"kernels); peak memory {peak:.2f} GiB {'ok' if ok else 'FAIL'}")
    took = time.perf_counter() - t_phase
    log(f"region: phase 6e took {took:.1f} s")
    if not ok:
        raise SystemExit("region phase launches do not add up")
    out.update({"launches": counts["launches"],
                "tile_launches": counts["tile_launches"],
                "split_launches": counts["split_launches"],
                "peak_gib": peak, "seconds": took})
    return out


# --------------------------------------------------------------- phase 6f
TP_WORLD = 2
TP_LAYERS = 8                       # (a)-(d), (g), (h): Llama-2-7B's 32 cut
TP_DECODE_SHAPE = (4, 5504, 4096)   # v1 TP decode: x [4, d_ff / 2] . w_down
TP_OPT_DECODE_SHAPE = (4, 8192, 4096)   # (f): OPT-6.7B's
TP_DEQUANT_SHAPE = (4096, 8192)     # (f): an OPT-6.7B w_up shard, int8
TP_OPT_SHAPE = dict(REPLICA_SHAPE, max_context=2048)    # OPT's max_seq_len
TP_MOE_LAYERS = 4                   # (i): 350M+MoE-128's 24 layers cut
# (i): fp32, then bf16 (the dtype 6i serves in; a rank's w_down partials
# stay fp32 through the group's sum in both)
TP_MOE_DTYPES = (torch.float32, torch.bfloat16)
# (i): GPT-2's 50257 ids padded as Megatron-DeepSpeed pads them for a model
# axis of 2 (to a multiple of 128 x 2): an odd vocab does not shard
TP_MOE_VOCAB = 50432
TP_MOE_SHAPE = dict(REPLICA_SHAPE, max_context=2048)
TP_MOE_REQUESTS = 4
TP_HANDOFF_TOKENS = 300             # (h): the handed-off prompt
TP_PREFIX_TOKENS = 72               # (h): the prefix tier's prompt
TP_PREDICTED_S = 90.0               # stated in PERF.md before the run


class _CollMeter:
    """One rank's meter of the host-staged collectives: ``comm.all_reduce``
    / ``all_gather`` / ``all_to_all`` / ``reduce_scatter``, each timed
    after a synchronize (two ranks share the one card, so a collective's
    time includes waiting for the other rank's kernels); :meth:`close`
    puts them back."""

    NAMES = ("all_reduce", "all_gather", "all_to_all", "reduce_scatter")

    def __init__(self):
        from deepspeed_tpu_torch.comm import comm as comm_mod

        self._mod = comm_mod
        self._real = {n: getattr(comm_mod, n) for n in self.NAMES}
        self.reset()
        for name, real in self._real.items():
            def timed(*a, _real=real, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _real(*a, **k)
                self.coll_s += time.perf_counter() - t0
                self.n_coll += 1
                return out

            setattr(comm_mod, name, timed)

    def reset(self) -> None:
        self.coll_s, self.n_coll = 0.0, 0

    def close(self) -> None:
        for name, real in self._real.items():
            setattr(self._mod, name, real)


class _TPMeter(_CollMeter):
    """One rank's meter of a tensor-parallel engine: wraps its ``_core``
    (one call a put or a decode step) to count the calls, those whose
    paged tile / split counters moved (by 0 or one a layer, else odd) and
    their time, and times the model group's collectives inside them
    (:class:`_CollMeter`)."""

    def __init__(self, n_layers: int):
        self.n_layers = n_layers
        super().__init__()

    def reset(self) -> None:
        super().reset()
        self.calls = self.tile = self.split = self.odd = 0
        self.core_s = 0.0

    def wrap(self, eng):
        real = eng._core

        def core(*a, **k):
            before = _paged_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = real(*a, **k)
            torch.cuda.synchronize()
            self.core_s += time.perf_counter() - t0
            moved = [n - b for n, b in zip(_paged_counts(), before)]
            self.calls += 1
            self.tile += moved[0] > 0
            self.split += moved[1] > 0
            self.odd += any(n not in (0, self.n_layers) for n in moved)
            return x

        eng._core = core
        return eng

    def summary(self) -> dict:
        return {"calls": self.calls, "tile": self.tile, "split": self.split,
                "odd": self.odd, "core_s": self.core_s,
                "coll_s": self.coll_s, "n_coll": self.n_coll,
                "counts": {n: getattr(pa.paged_attention, n)
                           for n in PAGED_PATH_COUNTERS}}


def _record_paged(kept: dict):
    """Keep (not copy) the inputs of layer 0's paged call of the first put
    of this rank that runs a prefill on tile items and decode lanes on
    lane items (bf16 and quantized pools alike), for a check at the rank's
    shape after the run. Returns the hook's undo."""
    import deepspeed_tpu_torch.inference.ragged as ragged_mod

    real = ragged_mod.paged_attention

    def recording(q, kp, vp, tables, positions, **kw):
        work = kw.get("work")
        if not kept and work is not None and work.n_lanes > work.n_pad \
                and work.n_tiles and work.n_items:
            kept.update(q=q, kp=kp, vp=vp, tab=tables, pos=positions,
                        slots=kw["seq_slots"], live=kw["live_pages"],
                        work=work, quant={k: kw[k] for k in
                                          ("k_scale", "v_scale", "kv_bits")
                                          if kw.get(k) is not None})
        return real(q, kp, vp, tables, positions, **kw)

    ragged_mod.paged_attention = recording

    def undo():
        ragged_mod.paged_attention = real

    return undo


def _tp_serve(eng, prompts, meter, tag: str, warm: bool,
              serving: Optional[dict] = None, timed: bool = True) -> dict:
    """ServingEngine (``serving``, default ``REPLICA_SERVING``) on the
    controller over the TP engine (the workers in ``serve_worker``): a
    warm-up request, then the paged counters, the meter and the peak
    memory set to 0 on every rank, then ``prompts`` x 32 new tokens, the
    controller's verify puts (``put_spec``) counted. Each rank then holds
    layer 0's recorded paged call against the plain version at its own
    shape; with ``timed`` the controller times it. Returns this rank's
    numbers."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.serving.server import ServingEngine

    serving = serving or REPLICA_SERVING
    if warm:
        if eng.is_controller:
            srv = ServingEngine(eng, REPLICA_SERVING)
            srv.submit(prompts[0][:16], max_new_tokens=2).result(timeout=600)
            srv.close(timeout=60)
        else:
            eng.serve_worker()
    torch.cuda.synchronize()
    comm.barrier()
    for name in PAGED_PATH_COUNTERS:
        setattr(pa.paged_attention, name, 0)
    meter.reset()
    torch.cuda.reset_peak_memory_stats()
    kept: dict = {}
    undo = _record_paged(kept)
    comm.barrier()
    out: dict = {}
    try:
        if eng.is_controller:
            verify, real_spec = [0], eng.put_spec

            def put_spec(*a):
                verify[0] += 1
                return real_spec(*a)

            eng.put_spec = put_spec
            srv = ServingEngine(eng, serving)
            t1 = time.perf_counter()
            reqs = [srv.submit(p, max_new_tokens=32) for p in prompts]
            for r in reqs:
                r.wait(timeout=900)
            torch.cuda.synchronize()
            out["wall"] = time.perf_counter() - t1
            out.update(meter.summary())
            srv.close(timeout=60)
            del eng.put_spec
            out.update(streams=[list(r.tokens) for r in reqs],
                       states=[r.state.value for r in reqs],
                       ttft=sorted(r.ttft_s for r in reqs
                                   if r.ttft_s is not None),
                       leaks=srv.block_leaks(), verify_puts=verify[0],
                       errors=[r.error for r in reqs if r.error])
        else:
            out["replayed"] = eng.serve_worker()
            out.update(meter.summary())
    finally:
        undo()
    out["peak"] = torch.cuda.max_memory_allocated()
    rank = eng.topo.rank("model")
    if not kept:
        raise SystemExit(f"tp {tag} rank {rank}: no put ran the recorded "
                         f"mix of work items")
    k = kept
    args = (k["q"], k["kp"], k["vp"], k["tab"], k["pos"], k["slots"],
            k["live"])
    out["max_abs_err"] = _paged_twice(
        f"tp_{tag}_put_rank{rank} hq={k['q'].shape[1]} "
        f"hkv={k['kp'].shape[1]}", *args, 0, work=k["work"], **k["quant"])
    if eng.is_controller and timed:
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                            device="cuda")
        out["timing"] = _time_paged(f"tp_{tag}_put rank 0", *args, flush,
                                    work=k["work"], **k["quant"])
        del flush
    kept.clear()
    return out


def _one_at_a_time(rank: int, world: int, build):
    """``build()`` on each rank in turn (the others wait at a barrier), so
    that one full-width model at a time is on the card. Returns this
    rank's result."""
    from deepspeed_tpu_torch.comm import comm

    got = None
    for r in range(world):
        if r == rank:
            got = build()
            gc.collect()
            torch.cuda.empty_cache()
        comm.barrier()
    return got


def _same_export(a, b) -> bool:
    """Two ``KVExport`` s with the same tokens and bitwise the same pages
    and scales."""
    pairs = [(a.k_pages, b.k_pages), (a.v_pages, b.v_pages),
             (a.k_scales, b.k_scales), (a.v_scales, b.v_scales)]
    return (a.tokens == b.tokens and a.seen == b.seen
            and all((x is None and y is None) or (
                x is not None and y is not None and torch.equal(x, y))
                for x, y in pairs))


def _tp_handoff(model, topo, path: str) -> dict:
    """6f (h) on a rank. The controller imports the single-card engine's
    export (``to_tp.pt``), re-exports it (bitwise the import) and decodes
    the rest; then prefills the same prompt, exports it (``from_tp.pt``,
    for the single-card engine). Then a prefix-cached TP engine with a
    cold tier: ``export_prefix``, the cache dropped (each evicted entry
    spilled through a ``gather_pages`` record), ``import_prefix`` (its
    re-export bitwise), dropped again, and the prompt served again, its
    prefix re-admitted from the cold tier. Workers replay."""
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine,
                                                      block_balance_report)
    from deepspeed_tpu_torch.serving.kvtier import ColdTier

    out: dict = {}
    cfg = dict(n_kv_blocks=REPLICA_PAGES, **REPLICA_SHAPE)
    eng = RaggedInferenceEngine(model, RaggedConfig(**cfg), topology=topo)
    if not eng.is_controller:
        out["replayed"] = eng.serve_worker()
    else:
        got = torch.load(os.path.join(path, "to_tp.pt"), weights_only=False)
        x1, first, prompt = got["export"], got["first"], got["prompt"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.import_kv(7, x1)
        torch.cuda.synchronize()
        out["import_s"] = time.perf_counter() - t0
        out["to_tp_bitwise"] = _same_export(x1, eng.export_kv(7))
        out["to_tp"] = [first] + eng.decode_steps({7: first}, 31)[7]
        eng.flush([7])
        first2 = int(np.argmax(_resolve(eng, [8], [prompt])[8]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x2 = eng.export_kv(8)
        out["export_s"] = time.perf_counter() - t0
        out["export_bytes"] = x2.nbytes
        eng.flush([8])
        torch.save({"export": x2, "first": first2},
                   os.path.join(path, "from_tp.pt"))
        out["leaks"] = block_balance_report(eng)["problems"]
        eng.stop_workers()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng = RaggedInferenceEngine(model, RaggedConfig(
        enable_prefix_cache=True, **cfg), topology=topo)
    if not eng.is_controller:
        out["prefix_replayed"] = eng.serve_worker()
        return out
    eng.enable_kv_tier(member="tp", cold_tier=ColdTier(REPLICA_PAGES))
    prompt = prompt[:TP_PREFIX_TOKENS]
    first = eng.generate({1: prompt}, max_new_tokens=32)[1]
    t0 = time.perf_counter()
    pe = eng.export_prefix(prompt)
    export_s = time.perf_counter() - t0
    eng.prefix_cache.drop_all(eng.allocator)
    spills = eng.kvtier_cold_spills
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adopted = eng.import_prefix(pe)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    again = eng.export_prefix(prompt)
    bitwise = all(torch.equal(x, y) for x, y in zip(
        pe.pages + (pe.scales or ()), again.pages + (again.scales or ())))
    eng.prefix_cache.drop_all(eng.allocator)
    second = eng.generate({2: prompt}, max_new_tokens=32)[2]
    out["prefix"] = {"first": first, "second": second, "pages": pe.n_pages,
                     "bytes": pe.wire_bytes, "export_s": export_s,
                     "import_s": import_s, "spills": spills,
                     "adopted": adopted, "bitwise": bitwise,
                     "checksum": pe.verify(),
                     "readmits": eng.kvtier_cold_readmits,
                     "leaks": block_balance_report(eng)["problems"]}
    eng.stop_workers()
    return out


def _moe_greedy(model, eng, prompts, n: int = 32) -> dict:
    """Greedy streams of ``prompts`` driven by puts (the prompts until
    prefilled, then one token a put), with each generated position's
    top-two logit gap, every expert-bank call's top-k experts and fp32
    gate logits on the put's real lanes (the padding lanes after them
    carry no token) and each put's lanes as ``(uid, first position,
    tokens)`` runs. On the TP controller the workers replay each put."""
    sink: list = []
    undo = _moe_choices(model, sink)
    puts, real, lanes = [0], eng.put, []
    real_tel = eng._record_step_telemetry

    def put(uids, toks):
        puts[0] += 1
        return real(uids, toks)

    def tel(sched):
        # after the put: each sequence's seen already counts its take
        lanes.append([(seq.uid, seq.seen - take, take)
                      for seq, take in sched])
        return real_tel(sched)

    eng._record_step_telemetry = tel

    uids = list(range(40_000, 40_000 + len(prompts)))
    streams = {u: [] for u in uids}
    gaps = {u: [] for u in uids}
    eng.put = put
    try:
        rows = _resolve(eng, uids, prompts)
        for step in range(n):
            for u in uids:
                top2 = np.sort(rows[u])[-2:]
                gaps[u].append(float(top2[1] - top2[0]))
                streams[u].append(int(np.argmax(rows[u])))
            if step < n - 1:
                logits = eng.put(uids, [[streams[u][-1]] for u in uids])
                rows = dict(zip(uids, logits))
        eng.flush(uids)
    finally:
        del eng.put, eng._record_step_telemetry
        undo()
    n_layers = model.config.n_layers
    real_lanes = [sum(take for *_, take in put) for put in lanes]
    return {"streams": [streams[u] for u in uids],
            "gaps": [gaps[u] for u in uids],
            "choices": [topi.numpy()[:real_lanes[k // n_layers]]
                        for k, (topi, _) in enumerate(sink)],
            "logits": [g.numpy()[:real_lanes[k // n_layers]]
                       for k, (_, g) in enumerate(sink)],
            "lanes": lanes, "puts": puts[0]}


def _tp_moe(rank, world, topo, prompts, dtype) -> dict:
    """6f (i) on a rank: 350M+MoE-128 at full width, depth cut to
    ``TP_MOE_LAYERS``, in ``dtype``, every norm vector drawn
    (``_draw_vectors``; the preset has no biases), built one rank at a
    time; rank 0 first serves the full model alone (the TP-1 reference:
    streams, gaps, experts), then every rank cuts it (``d_ff / 2`` of
    every expert) and the TP engine serves the same puts twice. Counts this
    rank's grouped GEMMs by route (``_grouped_mm``, and the loop that
    keeps a narrower dtype's ``w_down`` partials fp32) and digests its
    expert choices."""
    from deepspeed_tpu_torch.checkpoint.jax_params import shard_params
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)
    from deepspeed_tpu_torch.models.moe import GPTMoE
    from deepspeed_tpu_torch.parallel import moe as moe_mod

    cfg = RaggedConfig(n_kv_blocks=REPLICA_PAGES,
                       **dict(TP_MOE_SHAPE, dtype=dtype))
    out: dict = {}

    def build():
        full = _draw_vectors(GPTMoE(*MOE_PRESET, n_layers=TP_MOE_LAYERS,
                                    vocab_size=TP_MOE_VOCAB, dtype=dtype,
                                    seed=0), 0)
        if rank == 0:
            ref = RaggedInferenceEngine(full, cfg)
            out["ref"] = _moe_greedy(full, ref, prompts)
            del ref
        return shard_params(full, topo)

    model = _one_at_a_time(rank, world, build)
    grouped, wide, real = [0], [0], moe_mod.grouped_mm

    def counted(a, b, sizes, route=None, out_dtype=None):
        if a.shape[0] > 0:
            grouped[0] += (route or moe_mod.grouped_route(
                a, b, out_dtype)) == "grouped"
            wide[0] += out_dtype not in (None, a.dtype)
        return real(a, b, sizes, route, out_dtype)

    moe_mod.grouped_mm = counted
    # every rank's top-k experts of every call (padding lanes too): the
    # ranks must route alike
    routes: list = []
    undo = _moe_choices(model, routes)
    try:
        eng = RaggedInferenceEngine(model, cfg, topology=topo)
        if eng.is_controller:
            out["tp"] = _moe_greedy(model, eng, prompts)
            # the same puts again: the TP run repeats bitwise
            out["again"] = _moe_greedy(model, eng, prompts)
            eng.stop_workers()
        else:
            out["replayed"] = eng.serve_worker()
    finally:
        moe_mod.grouped_mm = real
        undo()
    out["routes"] = (len(routes), hashlib.sha256(b"".join(
        topi.numpy().tobytes() for topi, _ in routes)).hexdigest())
    out["grouped"], out["wide"] = grouped[0], wide[0]
    out["puts"] = out["tp"]["puts"] + out["again"]["puts"] if rank == 0 \
        else out["replayed"]["core"]
    return out


def _digest(t: torch.Tensor) -> tuple:
    """An exact fingerprint of a 2-byte tensor's bits, on its device: the
    sum of its 16-bit words and their sum weighted by position, in int64,
    so two processes compare a shard without moving it."""
    w = t.contiguous().view(torch.int16).reshape(-1)
    total = weighted = 0
    step = 1 << 26
    for i in range(0, w.numel(), step):
        c = w[i:i + step].to(torch.int64)
        pos = torch.arange(i, i + c.numel(), device=c.device) % 65521 + 1
        total += int(c.sum())
        weighted += int((c * pos).sum())
    return total, weighted


def _tp_opt(rank, world, topo, meter, args) -> dict:
    """6f (e) and (f) on a rank. OPT-6.7B built twice a rank and cut, one
    rank at a time (every bias and norm drawn, as 6g). ``init_inference(
    tensor_parallel=2, kernel_backend="pallas", quant=FAMILY_V1_QUANT)``
    on the first cut, on both ranks together: each shard quantized (row
    5) in its full leaf's blocks (a straddled one would be gathered over
    the model group first); the second cut serves the ragged engine.
    (e) 6g's requests through ``ServingEngine`` over a 512-page bf16 TP
    engine
    (``_tp_serve``); (f) the v1 engine's 32-token generate of 4 x 128
    prompts, row 6 and row 8 launches counted, and a digest of every
    dequantized shard."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint.jax_params import shard_params
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)
    from deepspeed_tpu_torch.telemetry.registry import (MetricsRegistry,
                                                        get_registry,
                                                        set_registry)

    cut, shard = _one_at_a_time(rank, world, lambda: tuple(
        shard_params(_family_model("opt", "6.7b"), topo) for _ in range(2)))
    qk.quantize_blockwise.launches = 0
    comm.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v1 = deepspeed_tpu_torch.init_inference(
        cut, {"tensor_parallel": world, "kernel_backend": "pallas",
              "dtype": "bfloat16", "temperature": 0.0,
              "quant": FAMILY_V1_QUANT})
    torch.cuda.synchronize()
    built = {"quantize": qk.quantize_blockwise.launches,
             "v1_built_s": time.perf_counter() - t0}
    del cut
    gc.collect()
    torch.cuda.empty_cache()
    eng = meter.wrap(RaggedInferenceEngine(shard, RaggedConfig(
        n_kv_blocks=REPLICA_PAGES, **TP_OPT_SHAPE), topology=topo))
    out = {"opt": _tp_serve(eng, args["prompts"], meter, "opt", warm=True)}
    del eng, shard
    gc.collect()
    torch.cuda.empty_cache()
    ids = args["ids"]
    v1.generate(ids, max_new_tokens=2)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_registry(MetricsRegistry())
    fc.matmul_pallas.launches = fc.matmul_pallas.wgmma_launches = 0
    d0 = qk.dequantize_blockwise.launches
    meter.reset()
    t1 = time.perf_counter()
    tokens = v1.generate(ids, max_new_tokens=32)
    torch.cuda.synchronize()
    out["opt_v1"] = {
        **built, "ids": tokens, "wall": time.perf_counter() - t1,
        "dequantize": qk.dequantize_blockwise.launches - d0,
        "fused": get_registry().counter(
            "comm/facade/fused/decode_mlp_all_reduce").value,
        "launches": fc.matmul_pallas.launches,
        "wgmma_launches": fc.matmul_pallas.wgmma_launches,
        "coll_s": meter.coll_s, "n_coll": meter.n_coll,
        "bound": v1.model._comm_backend is not None,
        "leaves": len(v1._wq_shapes),
        "blocks": sorted(set(v1._wq_blocks.values())),
        "param_bytes": v1.param_bytes(),
        "peak": torch.cuda.max_memory_allocated(),
        "digests": {n: _digest(v1._leaf(n)) for n in sorted(v1._wq_shapes)}}
    return out


def _job_tp(rank, world, device, prompts, ids, new, more):
    """A rank of phase 6f: the seed-0 Llama-2-7B at ``TP_LAYERS`` of its 32
    layers, built at full width (one rank at a time) and cut to this
    rank's shard, then (a) TP serving over
    a bf16 pool, (b) over an int8 pool, (g) speculative serving of 6b's
    requests over a bf16 pool, (h) the hand-off and the prefix tier, (c)
    v1 ``init_inference`` with ``tensor_parallel`` and the fused backend
    (plain SPMD); then OPT-6.7B (e, f, :func:`_tp_opt`) and 350M+MoE-128
    (i, :func:`_tp_moe`)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint.jax_params import shard_params
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)
    from deepspeed_tpu_torch.models.llama import Llama
    from deepspeed_tpu_torch.parallel.mesh import Topology
    from deepspeed_tpu_torch.telemetry.registry import (MetricsRegistry,
                                                        get_registry,
                                                        set_registry)

    t0 = time.perf_counter()
    topo = Topology.build({"model": world})
    model = _one_at_a_time(rank, world, lambda: shard_params(
        Llama("7b", dtype=torch.bfloat16, seed=0, n_layers=TP_LAYERS),
        topo))
    out = {"built_s": time.perf_counter() - t0,
           "weight_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters())}
    meter = _TPMeter(model.config.n_layers)
    spec_serving = {**REPLICA_SERVING, **SPEC_SERVING}
    for tag, kvq, reqs, serving in (
            ("bf16", "none", prompts, None),
            ("int8", "int8", prompts[:4], None),
            ("spec", "none", more["spec_prompts"], spec_serving)):
        t1 = time.perf_counter()
        eng = meter.wrap(RaggedInferenceEngine(
            model, RaggedConfig(n_kv_blocks=REPLICA_PAGES, kv_quant=kvq,
                                **REPLICA_SHAPE), topology=topo))
        out[tag] = _tp_serve(eng, reqs, meter, tag, warm=tag == "bf16",
                             serving=serving, timed=tag != "spec")
        out[tag]["seconds"] = time.perf_counter() - t1
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["handoff"] = _tp_handoff(model, topo, more["handoff"])
    out["handoff"]["seconds"] = time.perf_counter() - t1
    gc.collect()
    torch.cuda.empty_cache()
    eng = deepspeed_tpu_torch.init_inference(
        model, {"tensor_parallel": world, "kernel_backend": "pallas",
                "dtype": "bfloat16", "temperature": 0.0})
    eng.generate(ids, max_new_tokens=2)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_registry(MetricsRegistry())
    fc.matmul_pallas.launches = fc.matmul_pallas.wgmma_launches = 0
    meter.reset()
    t1 = time.perf_counter()
    tokens = eng.generate(ids, max_new_tokens=new)
    torch.cuda.synchronize()
    out["v1"] = {"ids": tokens, "wall": time.perf_counter() - t1,
                 "fused": get_registry().counter(
                     "comm/facade/fused/decode_mlp_all_reduce").value,
                 "launches": fc.matmul_pallas.launches,
                 "wgmma_launches": fc.matmul_pallas.wgmma_launches,
                 "coll_s": meter.coll_s, "n_coll": meter.n_coll,
                 "bound": model._comm_backend is not None,
                 "peak": torch.cuda.max_memory_allocated()}
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    # OPT-6.7B keeps its depth: a put moves the counters by its layers
    from deepspeed_tpu_torch.models.gpt2 import opt_config

    out.update(_tp_opt(rank, world, topo,
                       _TPMeter(opt_config("6.7b").n_layers), more["opt"]))
    out["opt_seconds"] = time.perf_counter() - t1
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    for dtype in TP_MOE_DTYPES:
        key = "moe_" + str(dtype)[6:]
        out[key] = _tp_moe(rank, world, topo, more["moe"], dtype)
        out[key]["seconds"] = time.perf_counter() - t1
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
    return out


def _tp_decode_matmul(card: str, shape: tuple, tag: str) -> dict:
    """Row 8 (``matmul_pallas``) at a v1 TP decode MLP's shape, x [m, k]
    . w_down's shard [k, n] in bf16 (6f (d): Llama-2-7B's, (f):
    OPT-6.7B's), against the plain version, then timed (L2 flushed)
    beside its bound and ``torch.mm(x, w, out_dtype=torch.float32)``."""
    m, k, n = shape
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(k, n, generator=gen, device="cuda")
         / math.sqrt(k)).to(torch.bfloat16)
    hopper = fc.wgmma_path(x.dtype, m, n, k, (x.data_ptr(), w.data_ptr()))
    w0 = fc.matmul_pallas.wgmma_launches
    got = fc.matmul_pallas(x, w)
    again = fc.matmul_pallas(x, w)
    torch.cuda.synchronize()
    on_hopper = fc.matmul_pallas.wgmma_launches - w0
    ref = fc.matmul_reference(x, w)
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    ok = err <= FUSED_REL * scale and torch.equal(got, again) \
        and on_hopper == (2 if hopper else 0)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    p1 = cuda_ms(lambda: fc.matmul_reference(x, w), 20, flush)
    l1 = cuda_ms(lambda: torch.mm(x, w, out_dtype=torch.float32), 50, flush)
    k1 = cuda_ms(lambda: fc.matmul_pallas(x, w), 50, flush)
    k2 = cuda_ms(lambda: fc.matmul_pallas(x, w), 50, flush)
    l2 = cuda_ms(lambda: torch.mm(x, w, out_dtype=torch.float32), 50, flush)
    p2 = cuda_ms(lambda: fc.matmul_reference(x, w), 20, flush)
    del flush
    nbytes = (m * k + k * n) * 2 + m * n * 4
    ops = 2 * m * k * n
    bound_ms = max(nbytes / HBM_BYTES_PER_S,
                   ops / PEAK_OPS_PER_S[torch.bfloat16]) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= \
        ops / PEAK_OPS_PER_S[torch.bfloat16] else "operations"
    log(f"tp ({tag}) [{card}]: matmul_pallas [{m}, {k}] x [{k}, {n}] bf16 on "
        f"{'the Hopper (wgmma) kernel' if hopper else 'the mma.sync kernel (wgmma_path refuses it)'}"
        f": max_abs_err {err:.3e} (max |plain| {scale:.3e}, rel tol "
        f"{FUSED_REL}), twice bitwise {torch.equal(got, again)}; kernel "
        f"{k1:.4f}/{k2:.4f} ms, torch.mm out_dtype=fp32 {l1:.4f}/{l2:.4f} "
        f"ms, plain {p1:.4f}/{p2:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}, {nbytes} B, {ops:.3e} ops), "
        f"{nbytes / min(k1, k2) / 1e6:.1f} GB/s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"row 8 at the TP decode shape {shape} failed")
    return {"shape": f"{m}x{k}x{n}_bf16", "ms": min(k1, k2),
            "plain_ms": min(p1, p2), "library_ms": min(l1, l2),
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "hopper": bool(hopper)}


def _tp_dequant_timing(card: str) -> dict:
    """Row 6 at an OPT-6.7B ``w_up`` shard, [4096, 8192] int8 at block 256
    (what 6f (f) dequantizes for a layer on a rank): bitwise against the
    plain version, timed beside its bound (bf16 out, int8 and fp32 scales
    in, at 3.35 TB/s)."""
    rows, cols = TP_DEQUANT_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(19)
    x = torch.randn(rows, cols, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, s = qk.quantize_blockwise(x, bits=8, block=256)
    got = qk.dequantize_blockwise(q, s, block=256, dtype=torch.bfloat16)
    same = bool(torch.equal(got, qk.dequantize_blockwise_reference(
        q, s, 256, torch.bfloat16)))
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def kern():
        return qk.dequantize_blockwise(q, s, block=256, dtype=torch.bfloat16)

    def plain():
        return qk.dequantize_blockwise_reference(q, s, 256, torch.bfloat16)

    p1, k1, k2, p2 = (cuda_ms(plain, 3, flush), cuda_ms(kern, 20, flush),
                      cuda_ms(kern, 20, flush), cuda_ms(plain, 3, flush))
    del flush
    nbytes = x.numel() * 2 + q.numel() + s.numel() * 4
    ops = float(QUANT_KERNELS["dequantize_blockwise"][2]) * x.numel()
    t_ops = ops / PEAK_OPS_PER_S[torch.float32] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    out = {"shape": f"{rows}x{cols}_int8_block256", "ms": min(k1, k2),
           "plain_ms": min(p1, p2), "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops > t_bytes else "bytes",
           "max_abs_err": 0.0}
    log(f"tp (f) [{card}]: dequantize_blockwise [{rows}, {cols}] int8 block "
        f"256 -> bf16: bitwise the plain version {same}; kernel "
        f"{k1:.4f}/{k2:.4f} ms plain {p1:.4f}/{p2:.4f} ms bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']}, {nbytes} B); "
        f"{nbytes / min(k1, k2) / 1e6:.1f} GB/s {'ok' if same else 'FAIL'}")
    if not same:
        raise SystemExit("row 6 at the OPT shard shape disagrees")
    return out


def _tp_straddle(model, card: str) -> bool:
    """6f (f): Llama-2-7B's ``lm_head`` [4096, 32000] quantized at full
    width (row 5, block 256), each TP 2 rank's slice cut as the v1 engine
    cuts it (16000 columns a row: 62.5 blocks, re-blocked at 128) and
    dequantized (row 6 at block 128), bitwise the slice of the full
    leaf's dequantize at block 256."""
    from deepspeed_tpu_torch.inference.engine import local_blocks

    w = model.lm_head.contiguous()
    q, s = qk.quantize_blockwise(w, bits=8, block=256)
    full = qk.dequantize_blockwise(q, s, block=256, dtype=torch.bfloat16)
    spec, cols = model.leaf_spec("lm_head"), w.shape[1] // TP_WORLD
    same, blocks = True, []
    for r in range(TP_WORLD):
        pq, ps, g = local_blocks(q, s, tuple(w.shape), spec, TP_WORLD, r,
                                 256, 8)
        got = qk.dequantize_blockwise(pq, ps, block=g, dtype=torch.bfloat16)
        same &= bool(torch.equal(got, full[:, r * cols:(r + 1) * cols]))
        blocks.append(g)
    log(f"tp (f) [{card}]: Llama-2-7B lm_head [4096, 32000] int8 at block "
        f"256, cut for {TP_WORLD} ranks ({cols} columns a row: "
        f"{cols / 256} blocks) and re-blocked at {blocks}: each rank's "
        f"dequantized slice bitwise the one-card leaf's {same} "
        f"{'ok' if same else 'FAIL'}")
    del q, s, full
    return same


def _handoff_to_tp(model, path: str, prompt) -> dict:
    """6f (h), the single-card side before the ranks start: the
    uninterrupted 32-token stream of ``prompt`` and an export of it
    prefilled, saved for the TP controller (``to_tp.pt``)."""
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)

    eng = RaggedInferenceEngine(model, RaggedConfig(
        n_kv_blocks=REPLICA_PAGES, **REPLICA_SHAPE))
    ref = eng.generate({1: prompt}, max_new_tokens=32)[1]
    first = int(np.argmax(_resolve(eng, [2], [prompt])[2]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = eng.export_kv(2)
    export_s = time.perf_counter() - t0
    eng.flush([2])
    torch.save({"export": x, "first": first, "prompt": prompt},
               os.path.join(path, "to_tp.pt"))
    return {"ref": ref, "export_s": export_s, "bytes": x.nbytes}


def _handoff_from_tp(eng, path: str) -> dict:
    """6f (h), the single-card side after the ranks: import the TP
    controller's export (``from_tp.pt``), re-export it (bitwise the
    import) and decode the rest."""
    got = torch.load(os.path.join(path, "from_tp.pt"), weights_only=False)
    x, first = got["export"], got["first"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.import_kv(9, x)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    bitwise = _same_export(x, eng.export_kv(9))
    stream = [first] + eng.decode_steps({9: first}, 31)[9]
    eng.flush([9])
    return {"stream": stream, "bitwise": bitwise, "import_s": import_s}


def _first_diff(got, ref) -> Optional[int]:
    """The first position where two streams differ (the shorter one's
    length where one is a prefix of the other); None where equal."""
    return next((k for k, (x, y) in enumerate(zip(got, ref)) if x != y),
                None if len(got) == len(ref) else min(len(got), len(ref)))


def _tp_counts_ok(res, tag: str, counter: str, n_layers: int, card: str,
                  letter: str) -> bool:
    """Every rank's paged launches of a TP serving run: one a layer a put,
    tile / split launches a layer for each put that ran them, some puts on
    tile items (bf16 and int8 pools alike), the same puts on every rank;
    logged. Returns whether all held."""
    ctrl = res[0][tag]
    good = True
    for r, rr in enumerate(res):
        x = rr[tag]
        cn = x["counts"]
        rank_ok = (cn[counter] == n_layers * x["calls"] and x["calls"] > 0
                   and cn["tile_launches"] == n_layers * x["tile"]
                   and cn["split_launches"] == n_layers * x["split"]
                   and x["odd"] == 0 and x["calls"] == ctrl["calls"]
                   and x["tile"] > 0)
        good = good and rank_ok
        log(f"tp ({letter}) {tag} rank {r} [{card}]: "
            f"{x['calls']} puts, paged_attention launches {cn} "
            f"({n_layers} x puts = {n_layers * x['calls']}; {x['tile']} "
            f"puts on tile items, {x['split']} on lane items, {x['odd']} "
            f"odd), layer 0's recorded put at this rank's shape "
            f"max_abs_err {x['max_abs_err']:.3e}; peak while serving "
            f"{x['peak']} B {'ok' if rank_ok else 'FAIL'}"
            + (f"; replayed {x['replayed']}" if r else ""))
    return good


def _tp_summary(c, n: int, tag: str, letter: str, card: str, same, ties,
                err: float, good: bool) -> float:
    """Log a TP serving run's controller numbers; returns the model
    group's collectives' share of the puts' time."""
    ttft = c["ttft"]
    ntok = sum(len(s) for s in c["streams"])
    share = c["coll_s"] / c["core_s"] if c["core_s"] else float("nan")
    log(f"tp ({letter}) {tag} [{card}]: "
        f"{n} requests, wall {c['wall']:.3f} s, "
        f"{ntok / c['wall']:.1f} generated tokens/s, TTFT p50 "
        f"{ttft[len(ttft) // 2]:.3f} s max {ttft[-1]:.3f} s; model "
        f"group collectives {c['n_coll']} in {c['calls']} puts "
        f"({c['n_coll'] / max(c['calls'], 1):.1f} a put), "
        f"{c['coll_s']:.3f} s of the puts' {c['core_s']:.3f} s "
        f"(share {share:.3f}); verify puts {c['verify_puts']}; streams "
        f"identical to the single-card run {same} of {n}, differing "
        f"(request, first position, top-two gap) {ties} against 2 x "
        f"{err:.4e}; leaks {c['leaks']} {'ok' if good else 'FAIL'}")
    return share


def _tp_references(model, prompts, spec_prompts) -> dict:
    """6f's one-card references at its depth (``TP_LAYERS``), as 6c-6e
    make theirs: the greedy 32-token streams of phase 5's requests over a
    512-page bf16 pool and of the first 4 over an int8 one, and of 6b's
    draftable requests, each through one manually driven replica."""
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)

    out = {}
    for tag, kvq in (("bf16", "none"), ("int8", "int8")):
        eng = RaggedInferenceEngine(model, RaggedConfig(
            n_kv_blocks=REPLICA_PAGES, kv_quant=kvq, **REPLICA_SHAPE))
        out[tag] = _serve_once(eng, prompts if tag == "bf16"
                               else prompts[:4])
        if tag == "bf16":
            out["spec"] = _serve_once(eng, spec_prompts)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_tp(card: str, err: dict, prompts, spec: dict, opt: dict) -> dict:
    """6f, tensor-parallel serving: 2 rank processes on the one card over
    gloo (one job, :func:`_job_tp`). On the seed-0 Llama-2-7B at
    ``TP_LAYERS`` of its 32 layers (time), cut in shards (16 of 32 heads,
    half of d_ff and of the vocab, half of every page's KV heads), held to
    one-card references at that depth (:func:`_tp_references`): (a)
    ServingEngine on the controller over a 512-page bf16
    TP engine, phase 5's 8 requests; (b) an int8 pool, 4 of them; (g)
    speculative serving of 6b's 8 requests; (h) the hand-off both ways
    between the TP controller and a single-card engine (through files)
    and the prefix tier; (c) v1 ``init_inference(tensor_parallel=2,
    kernel_backend="pallas")``, 4 x 128-token prompts, 32 new; (d) row 8
    at the TP decode shape. On OPT-6.7B (``opt``: 6g's model, requests,
    streams and int8 engine): (e) 6g's requests over a 512-page bf16 TP
    engine; (f) v1 int8 at TP 2, its tokens and dequantized shards held
    to 6g (c)'s, rows 6 and 8 at OPT's shard shapes, Llama-2-7B's
    straddling ``lm_head`` cut and dequantized. (i) 350M+MoE-128 cut to
    ``TP_MOE_LAYERS`` layers, fp32, at TP 2 against its TP-1 run. Streams are
    held to the single-card runs up to near-ties within 2 x phase 6b's
    verify error; every rank's paged launches to one a layer for each of
    its puts. ``prompts``: phase 5's requests; ``spec``: 6b's draftable
    prompts. Returns the numbers for the kernels line."""
    import tempfile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)
    from deepspeed_tpu_torch.models.llama import Llama

    t_phase = time.perf_counter()
    log(f"tp: phase 6f (a)-(i) predicted {TP_PREDICTED_S:.0f} s")
    # the ranks build the same seed-0 weights at this depth; the
    # references and the near-tie gaps come from these
    model = Llama("7b", dtype=torch.bfloat16, seed=0, n_layers=TP_LAYERS)
    n_layers = model.config.n_layers
    t_ref = time.perf_counter()
    ref = _tp_references(model, prompts, spec["prompts"])
    log(f"tp: one-card references at {n_layers} of 32 layers in "
        f"{time.perf_counter() - t_ref:.1f} s")
    ids = np.random.default_rng(8).integers(1, 32000, (4, 128))
    v1 = deepspeed_tpu_torch.init_inference(
        model, {"dtype": "bfloat16", "temperature": 0.0})
    ref_v1 = v1.generate(ids, max_new_tokens=32)
    del v1
    decode = _tp_decode_matmul(card, TP_DECODE_SHAPE, "d")
    decode_opt = _tp_decode_matmul(card, TP_OPT_DECODE_SHAPE, "f")
    dequant = _tp_dequant_timing(card)
    straddle = _tp_straddle(model, card)
    tmp = tempfile.mkdtemp(prefix="dst_tp_")
    hand_prompt = prompts[1][:TP_HANDOFF_TOKENS]
    to_tp = _handoff_to_tp(model, tmp, hand_prompt)
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(18)
    moe_prompts = [rng.integers(1, 50257, int(n)).tolist()
                   for n in rng.integers(64, 513, TP_MOE_REQUESTS)]
    more = {"spec_prompts": spec["prompts"], "handoff": tmp,
            "opt": {"prompts": opt["prompts"], "ids": opt["ids"]},
            "moe": moe_prompts}
    try:
        res = _join_ranks(*_start_ranks(TP_WORLD, "cuda", "tp",
                                        (prompts, ids, 32, more)),
                          timeout=1000)
        ref_eng = RaggedInferenceEngine(model, RaggedConfig(
            n_kv_blocks=REPLICA_PAGES, **REPLICA_SHAPE))
        from_tp = _handoff_from_tp(ref_eng, tmp)
    finally:
        for name in ("to_tp.pt", "from_tp.pt"):
            with contextlib.suppress(FileNotFoundError):
                os.remove(os.path.join(tmp, name))
        os.rmdir(tmp)
    ctrl = res[0]
    ok = straddle
    for tag, kvq, letter in (("bf16", "none", "a"), ("int8", "int8", "b")):
        reqs = prompts if tag == "bf16" else prompts[:4]
        c = ctrl[tag]
        # a near-tie is measured on an engine with the reference's pool
        gap_eng = ref_eng if kvq == "none" else RaggedInferenceEngine(
            model, RaggedConfig(n_kv_blocks=REPLICA_PAGES, kv_quant=kvq,
                                **REPLICA_SHAPE))
        ok_s, same, ties = _streams_ok(gap_eng, reqs, c["streams"],
                                       ref[tag][:len(reqs)], err[kvq])
        del gap_eng
        good = (ok_s and c["states"] == ["finished"] * len(reqs)
                and c["leaks"] == [] and not c["errors"]
                and c["verify_puts"] == 0)
        good = _tp_counts_ok(res, tag, PAGED_COUNTER[kvq], n_layers, card,
                             letter) and good
        ctrl[tag]["share"] = _tp_summary(c, len(reqs), tag, letter, card,
                                         same, ties, err[kvq], good)
        ok = ok and good
    # (g) speculative serving of 6b's requests: streams as one card's
    c = ctrl["spec"]
    ok_s, same, ties = _streams_ok(ref_eng, spec["prompts"], c["streams"],
                                   ref["spec"], err["none"])
    good = (ok_s and c["states"] == ["finished"] * len(spec["prompts"])
            and c["leaks"] == [] and not c["errors"]
            and c["verify_puts"] > 0)
    good = _tp_counts_ok(res, "spec", "launches", n_layers, card,
                         "g") and good
    _tp_summary(c, len(spec["prompts"]), "spec", "g", card, same, ties,
                err["none"], good)
    ok = ok and good
    # (h) the hand-off both ways and the prefix tier
    h = ctrl["handoff"]
    p = h["prefix"]
    ok_s, same, ties = _streams_ok(
        ref_eng, [hand_prompt] * 2 + [hand_prompt[:TP_PREFIX_TOKENS]],
        [h["to_tp"], from_tp["stream"], p["second"]],
        [to_tp["ref"], to_tp["ref"], p["first"]], err["none"])
    good = (ok_s and h["to_tp_bitwise"] and from_tp["bitwise"]
            and h["leaks"] == [] and p["leaks"] == [] and p["adopted"]
            and p["bitwise"] and p["checksum"] and p["spills"] > 0
            and p["readmits"] == 1
            and res[1]["handoff"]["replayed"].get("write_pages") == 1
            and res[1]["handoff"]["replayed"].get("gather_pages") == 2)
    log(f"tp (h) hand-off [{card}]: a {len(hand_prompt)}-token prompt; "
        f"single card -> TP 2: export {to_tp['export_s'] * 1e3:.2f} ms, "
        f"{to_tp['bytes']} B, import on the TP controller "
        f"{h['import_s'] * 1e3:.2f} ms, its re-export bitwise "
        f"{h['to_tp_bitwise']}; TP 2 -> single card: export "
        f"{h['export_s'] * 1e3:.2f} ms, {h['export_bytes']} B, import "
        f"{from_tp['import_s'] * 1e3:.2f} ms, re-export bitwise "
        f"{from_tp['bitwise']}; prefix tier: export_prefix "
        f"{p['pages']} pages, {p['bytes']} B in {p['export_s'] * 1e3:.2f} "
        f"ms, import_prefix {p['import_s'] * 1e3:.2f} ms, re-export "
        f"bitwise {p['bitwise']}, cold spills {p['spills']}, cold "
        f"re-admissions {p['readmits']}; worker replayed "
        f"{res[1]['handoff']['replayed']} and "
        f"{res[1]['handoff']['prefix_replayed']}; streams (to TP, from TP, "
        f"re-admitted) identical to the uninterrupted runs {same} of 3, "
        f"differing {ties} {'ok' if good else 'FAIL'}")
    ok = ok and good
    # (c) v1: tokens of every rank equal, and equal to the tp-1 run up to
    # near-ties; one fused decode_mlp_all_reduce and one row-8 launch a
    # layer for each decode step on each rank
    steps = 31
    got = [rr["v1"]["ids"] for rr in res]
    ref_rows = [ref_v1[i, 128:].tolist() for i in range(4)]
    ok_s, same, ties = _streams_ok(
        ref_eng, [ids[i].tolist() for i in range(4)],
        [got[0][i, 128:].tolist() for i in range(4)], ref_rows, err["none"])
    good = ok_s and all(np.array_equal(g, got[0]) for g in got)
    for r, rr in enumerate(res):
        x = rr["v1"]
        rank_ok = (x["bound"] and x["fused"] == n_layers * steps
                   and x["launches"] == n_layers * steps)
        good = good and rank_ok
        log(f"tp (c) v1 rank {r} [{card}]: 4 x 128-token prompts, 32 new "
            f"tokens in {x['wall']:.4f} s = {4 * 32 / x['wall']:.1f} tokens/s;"
            f" decode_mlp_all_reduce fused {x['fused']} and matmul_pallas "
            f"launches {x['launches']} ({n_layers} layers x {steps} decode "
            f"steps = {n_layers * steps}), on the Hopper (wgmma) kernel "
            f"{x['wgmma_launches']}, the rest on mma.sync; model group "
            f"collectives {x['n_coll']} in {x['coll_s']:.3f} s; peak "
            f"{x['peak']} B {'ok' if rank_ok else 'FAIL'}")
    log(f"tp (c) v1: tokens identical to the tp-1 run {same} of 4, "
        f"differing {ties}; ranks agree "
        f"{all(np.array_equal(g, got[0]) for g in got)} "
        f"{'ok' if good else 'FAIL'}")
    ok = ok and good
    del ref_eng
    gc.collect()
    torch.cuda.empty_cache()
    ok = _tp_opt_checks(res, opt, card, err) and ok
    ok = _tp_moe_checks(res, card, err, moe_prompts) and ok
    took = time.perf_counter() - t_phase
    log(f"tp: weights a rank {ctrl['weight_bytes']} B, built (both ranks, "
        f"one at a time) in {ctrl['built_s']:.1f} s; (g) "
        f"{ctrl['spec']['seconds']:.1f} s, (h) "
        f"{ctrl['handoff']['seconds']:.1f} s, (e)+(f) "
        f"{ctrl['opt_seconds']:.1f} s, (i) "
        + " + ".join(f"{ctrl['moe_' + str(d)[6:]]['seconds']:.1f}"
                     for d in TP_MOE_DTYPES) + " s "
        f"on the controller; phase 6f took {took:.1f} s (predicted "
        f"{TP_PREDICTED_S:.0f} s)")
    if not ok:
        raise SystemExit("tensor-parallel serving phase failed")
    ov = ctrl["opt_v1"]
    return {"launches": ctrl["bf16"]["counts"]["launches"],
            "tile_launches": ctrl["bf16"]["counts"]["tile_launches"],
            "split_launches": ctrl["bf16"]["counts"]["split_launches"],
            "int8_launches": ctrl["int8"]["counts"]["int8_launches"],
            "spec_launches": ctrl["spec"]["counts"]["launches"],
            "spec_verify_puts": ctrl["spec"]["verify_puts"],
            "opt_launches": ctrl["opt"]["counts"]["launches"],
            "opt_tile_launches": ctrl["opt"]["counts"]["tile_launches"],
            "opt_split_launches": ctrl["opt"]["counts"]["split_launches"],
            "bf16": ctrl["bf16"]["timing"], "int8": ctrl["int8"]["timing"],
            "opt": ctrl["opt"]["timing"],
            "v1_launches": ctrl["v1"]["launches"],
            "v1_wgmma_launches": ctrl["v1"]["wgmma_launches"],
            "opt_v1_launches": ov["launches"],
            "opt_v1_wgmma_launches": ov["wgmma_launches"],
            "opt_quantize": ov["quantize"], "opt_dequantize": ov["dequantize"],
            "decode": decode, "decode_opt": decode_opt, "dequant": dequant,
            "seconds": took}


def _v1_gap(eng, prompt, stream, j) -> float:
    """Top-two logit gap of the v1 engine's last position on ``prompt +
    stream[:j]``: how close the reference run's position j was to a
    tie."""
    x = np.asarray(list(prompt) + list(stream[:j]))[None]
    row = eng.forward(x)[0, -1].float().cpu().numpy()
    top2 = np.sort(row)[-2:]
    return float(top2[1] - top2[0])


def _tp_opt_checks(res, opt: dict, card: str, err: dict) -> bool:
    """6f (e) and (f) on the parent: OPT-6.7B's TP streams against 6g's,
    each rank's launches, and every dequantized shard's digest against
    the slice of 6g (c)'s TP-1 int8 engine's leaf."""
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)
    from deepspeed_tpu_torch.parallel.mesh import shard_slices

    model, ctrl = opt["model"], res[0]
    n_layers = model.config.n_layers
    ref_eng = RaggedInferenceEngine(model, RaggedConfig(
        n_kv_blocks=REPLICA_PAGES, **TP_OPT_SHAPE))
    c = ctrl["opt"]
    n = len(opt["prompts"])
    ok_s, same, ties = _streams_ok(ref_eng, opt["prompts"], c["streams"],
                                   opt["streams"], err["none"])
    good = (ok_s and c["states"] == ["finished"] * n and c["leaks"] == []
            and not c["errors"])
    good = _tp_counts_ok(res, "opt", "launches", n_layers, card,
                         "e") and good
    _tp_summary(c, n, "OPT-6.7B", "e", card, same, ties, err["none"], good)
    del ref_eng
    gc.collect()
    torch.cuda.empty_cache()
    # (f): tokens against the TP-1 int8 run, up to near-ties of its logits
    one, ids, want = opt["engine"], opt["ids"], opt["tokens"]
    got = [rr["opt_v1"]["ids"] for rr in res]
    agree = all(np.array_equal(g, got[0]) for g in got)
    same, ties = 0, []
    for i in range(len(ids)):
        g, w = got[0][i, 128:].tolist(), want[i, 128:].tolist()
        j = _first_diff(g, w)
        if j is None:
            same += 1
        else:
            ties.append((i, j, _v1_gap(one, ids[i], w, j)))
    names = sorted(one._wq_shapes)
    per_fwd = len(names) + ("tok_embed" in names)
    steps = 31
    good_f = agree and all(gap <= 2 * err["none"] for _, _, gap in ties)
    mismatched = []
    for r, rr in enumerate(res):
        x = rr["opt_v1"]
        for name in names:
            full = one._leaf(name)
            mine = full[shard_slices(full.shape, model.leaf_spec(name),
                                     TP_WORLD, r)]
            if _digest(mine) != tuple(x["digests"][name]):
                mismatched.append((r, name))
        rank_ok = (x["bound"] and x["quantize"] == len(names)
                   and x["leaves"] == len(names)
                   and x["dequantize"] == 32 * per_fwd
                   and x["fused"] == n_layers * steps
                   and x["launches"] == n_layers * steps
                   and not any(m[0] == r for m in mismatched))
        good_f = good_f and rank_ok
        log(f"tp (f) v1 OPT-6.7B int8 rank {r} [{card}]: built (cut, then "
            f"each shard quantized in its full leaf's blocks) in "
            f"{x['v1_built_s']:.1f} s, quantize launches "
            f"{x['quantize']} ({len(names)} leaves), blocks {x['blocks']}, "
            f"param_bytes {x['param_bytes']}; 32 new tokens in "
            f"{x['wall']:.4f} s = {4 * 32 / x['wall']:.1f} tokens/s; "
            f"dequantize launches {x['dequantize']} ({per_fwd} a forward x "
            f"32 = {32 * per_fwd}); decode_mlp_all_reduce fused "
            f"{x['fused']}, matmul_pallas launches {x['launches']} "
            f"({n_layers} x {steps}), {x['wgmma_launches']} on the Hopper "
            f"kernel; dequantized shards bitwise the TP-1 leaves' slices "
            f"{not any(m[0] == r for m in mismatched)}; peak {x['peak']} B "
            f"{'ok' if rank_ok else 'FAIL'}")
    log(f"tp (f) v1 OPT-6.7B int8: tokens identical to 6g (c)'s TP-1 int8 "
        f"run {same} of {len(ids)}, differing (row, first position, TP-1 "
        f"top-two gap) {ties} against 2 x {err['none']:.4e}; ranks agree "
        f"{agree}; mismatched shards {mismatched[:4]} "
        f"{'ok' if good_f else 'FAIL'}")
    return good and good_f


def _routing_flips(ref: dict, tp: dict, prompts, n_layers: int) -> dict:
    """Two ``_moe_greedy`` runs of one model on the same puts (``ref`` the
    TP-1 run): the expert-bank lanes whose stream still has the same
    history in both (its prompt and the generated tokens before the
    stream's first difference) are compared. A routing flip is such a
    lane whose top-k sets differ. A flip at (position p, layer l) changes
    its stream's states from layer l + 1 on, at p and, through
    attention, after it: a lane is clean when no flip of its stream lies
    at a position <= its own in a lower layer, and a flip on a clean lane
    is primary (the states it read differ from the TP-1 run's by
    rounding alone). Returns each stream's first difference, the primary
    flips ``(request, position, layer, the TP-1 gap between the k-th and
    the next gate logit)``, by layer the largest gate-logit difference on
    clean lanes and the share of compared lanes whose top-k sets agree,
    and the number of lanes compared."""
    uids = sorted({u for put in ref["lanes"] for u, *_ in put})
    n = len(ref["streams"][0])
    first = [_first_diff(g, w) for g, w in zip(tp["streams"],
                                               ref["streams"])]
    limit = {u: len(p) + (n if j is None else j)
             for u, p, j in zip(uids, prompts, first)}
    k = tp["choices"][0].shape[-1]
    lanes = []                   # (request, position, layer, same, gap, diff)
    for c, (a, b, la, lb) in enumerate(zip(tp["choices"], ref["choices"],
                                           tp["logits"], ref["logits"])):
        put, layer = divmod(c, n_layers)
        i = 0
        for u, start, take in ref["lanes"][put]:
            for pos in range(start, start + take):
                if pos < limit[u]:
                    top = np.sort(lb[i])[::-1]
                    lanes.append((uids.index(u), pos, layer,
                                  set(a[i].tolist()) == set(b[i].tolist()),
                                  float(top[k - 1] - top[k]),
                                  float(np.abs(la[i] - lb[i]).max())))
                i += 1
    flips = [x for x in lanes if not x[3]]

    def clean(r, pos, layer):
        return not any(f[0] == r and f[1] <= pos and f[2] < layer
                       for f in flips)

    err = [0.0] * n_layers
    agree = [[] for _ in range(n_layers)]
    for r, pos, layer, same, _, diff in lanes:
        agree[layer].append(same)
        if clean(r, pos, layer):
            err[layer] = max(err[layer], diff)
    return {"first": first,
            "primary": [(r, pos, layer, gap) for r, pos, layer, _, gap, _
                        in flips if clean(r, pos, layer)],
            "flips": len(flips), "err": err,
            "agree": [sum(v) / max(len(v), 1) for v in agree],
            "compared": len(lanes)}


def _tp_moe_checks(res, card: str, err: dict, prompts) -> bool:
    """6f (i) on the parent, for each of ``TP_MOE_DTYPES``: each rank's
    grouped GEMMs (two a layer a put, GELU experts; ``w_down``'s on the
    fp32-output loop in bf16) and expert choices (bitwise rank 0's); the
    TP run repeated bitwise; and the TP streams against rank 0's TP-1
    run. A stream is identical, or parts at a near-tie of the TP-1
    logits (a top-two gap within twice 6b's verify error), or after one
    of its own primary routing flips (:func:`_routing_flips`). Every
    primary flip must lie within what the TP rounding moves the gate
    logits: its TP-1 gap at most twice the largest gate-logit difference
    on clean lanes of its layer, and that difference itself within the
    logits' near-tie."""
    tie = 2 * err["none"]
    good = True
    for dtype in TP_MOE_DTYPES:
        name = str(dtype)[6:]
        key = "moe_" + name
        m = res[0][key]
        ref, tp, again = m["ref"], m["tp"], m["again"]
        rf = _routing_flips(ref, tp, prompts, TP_MOE_LAYERS)
        flipped = {r for r, *_ in rf["primary"]}
        parted, ok_streams = [], True
        for i, j in enumerate(rf["first"]):
            if j is None:
                continue
            gap = ref["gaps"][i][j]
            why = "tie" if gap <= tie else "flip" if i in flipped else None
            parted.append((i, j, gap, why))
            ok_streams = ok_streams and why is not None
        repeat = (again["streams"] == tp["streams"]
                  and all(np.array_equal(a, b) for a, b in
                          zip(again["choices"], tp["choices"])))
        ok = (all(len(s) == 32 for s in tp["streams"]) and ok_streams
              and all(gap <= 2 * rf["err"][layer]
                      for _, _, layer, gap in rf["primary"])
              and max(rf["err"]) <= tie
              and tp["puts"] == ref["puts"] == again["puts"]
              and tp["lanes"] == ref["lanes"] and repeat)
        calls = TP_MOE_LAYERS * m["puts"]
        wide = 0 if dtype == torch.float32 else calls
        for r, rr in enumerate(res):
            x = rr[key]
            rank_ok = (x["puts"] == m["puts"]
                       and x["grouped"] == 2 * calls - wide
                       and x["wide"] == wide
                       and x["routes"] == m["routes"])
            ok = ok and rank_ok
            log(f"tp (i) MoE {name} rank {r} [{card}]: {x['puts']} puts "
                f"(the TP run twice), _grouped_mm calls {x['grouped']} and "
                f"fp32-output loop calls {x['wide']} (2 a layer a put = "
                f"{2 * calls}, w_down's {wide} on the loop); expert choices "
                f"of its {x['routes'][0]} bank calls bitwise rank 0's "
                f"{x['routes'] == m['routes']} {'ok' if rank_ok else 'FAIL'}")
        log(f"tp (i) 350M+MoE-128 at {TP_MOE_LAYERS} layers, {name}, TP 2 "
            f"[{card}]: {len(tp['streams'])} requests, streams identical to "
            f"the TP-1 run {len(tp['streams']) - len(parted)} of "
            f"{len(tp['streams'])}, parted (request, first position, TP-1 "
            f"top-two gap, cause) {parted}; the TP run repeated bitwise "
            f"{repeat}; {rf['compared']} bank lanes with the same history "
            f"compared, top-k agreeing by layer "
            + " ".join(f"{x:.4f}" for x in rf["agree"])
            + f", {rf['flips']} routing flips, primary (request, position, "
            f"layer, TP-1 gate gap) {rf['primary']}; gate-logit difference "
            f"on clean lanes by layer "
            + " ".join(f"{x:.3e}" for x in rf["err"])
            + f" (a primary flip's gap within 2 x its layer's); near-tie "
            f"{tie:.4e}; took {m['seconds']:.1f} s on the "
            f"controller {'ok' if ok else 'FAIL'}")
        good = good and ok
    return good


# --------------------------------------------------------------- phase 6a
# --------------------------------------------------------------- phase 6g
FAMILY_SERVING = {   # name -> (preset, size, max_context, longest prompt)
    "OPT-6.7B": ("opt", "6.7b", 2048, 1536),
    "GPT-2 XL": ("gpt2", "xl", 1024, 960),
}
FAMILY_V1_QUANT = {"enabled": True, "bits": 8, "group_size": 256}
FAMILY_KEYS = (("opt", "OPT-6.7B"), ("gpt2xl", "GPT-2 XL"))  # kernels line


def _family_model(preset: str, size: str, seed: int = 0):
    """A family preset at full width and depth, bf16, random weights from
    ``seed``; then every bias and norm bias drawn N(0, 0.02^2) and every
    norm weight 1 + N(0, 0.02^2) from a generator seeded with ``seed`` on
    the card, so that a bias or norm term the path dropped would move its
    logits (the init's zeros and ones would hide it)."""
    from deepspeed_tpu_torch.models import gpt2

    return _draw_vectors({"opt": gpt2.OPT, "gpt2": gpt2.GPT2}[preset](
        size, dtype=torch.bfloat16, seed=seed), seed)


def _draw_vectors(model, seed: int):
    """``model`` with every 1-D leaf (biases, norm biases, and the norm
    weights, ``*norm_w`` and the diffusion models' ``*.scale``, as 1 + the
    draw) drawn N(0, 0.02^2) from a generator seeded with ``seed`` on the
    model's device."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                noise = torch.randn(p.shape, generator=gen, device=dev,
                                    dtype=torch.float32) * 0.02
                p.copy_(noise + (1.0 if name.endswith(("norm_w", ".scale"))
                                 else 0.0))
    return model


def _family_v1(model, card: str) -> dict:
    """6g (c): ``init_inference`` of OPT-6.7B, bf16 then int8 weights at
    group 256, path A's 4 x 128-token prompts, 32 new tokens greedy. The
    int8 engine is built from ``(model, params)``, so the bf16 weights
    stay beside it: every quantized leaf's payload and scales are bitwise
    the plain quantize's of the bf16 leaf, and its dequantized weight
    bitwise the plain dequantize's. The quantize and dequantize counts are
    set to 0 just before the int8 engine is built and read after its
    32-token generate; every layer leaf of the flag set (biases, norm
    weights and biases: 16 a layer), ``pos_embed`` and the tied
    ``tok_embed`` are quantized, and a forward dequantizes each once, the
    tied ``tok_embed`` twice (embedding and head)."""
    import deepspeed_tpu_torch

    c = model.config
    ids = np.random.default_rng(8).integers(1, c.vocab_size, (4, 128))
    params = dict(model.named_parameters())
    logits, out = {}, {}
    for mode in ("bf16", "int8"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = {"dtype": "bfloat16", "temperature": 0.0}
        if mode == "int8":
            cfg["quant"] = FAMILY_V1_QUANT
            for wrapper, *_ in QUANT_KERNELS.values():
                wrapper.launches = 0
        t0 = time.perf_counter()
        eng = deepspeed_tpu_torch.init_inference((model, params), cfg)
        torch.cuda.synchronize()
        built_s = time.perf_counter() - t0
        n_quant = qk.quantize_blockwise.launches
        eng.generate(ids, max_new_tokens=2)                  # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng.generate(ids, max_new_tokens=1)                  # prefill + 1
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
        d0 = qk.dequantize_blockwise.launches
        t1 = time.perf_counter()
        toks = eng.generate(ids, max_new_tokens=32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        n_deq = qk.dequantize_blockwise.launches - d0
        if mode == "int8":
            out["launches"] = {n: w.launches
                               for n, (w, *_) in QUANT_KERNELS.items()}
        logits[mode] = eng.forward(ids[:1])[0, -1].float().cpu().numpy()
        names = set(eng._wq_shapes)
        per_fwd = len(names) + (c.tie_embeddings and "tok_embed" in names)
        layer_q = {n.split(".")[2] for n in names if n.startswith("layers.")}
        want_layer = {"attn_norm_w", "attn_norm_b", "wq", "wk", "wv", "bq",
                      "bk", "bv", "wo", "bo", "mlp_norm_w", "mlp_norm_b",
                      "w_up", "b_up", "w_down", "b_down"}
        ok = (toks.shape == (4, 160)
              and ((toks >= 0) & (toks < c.vocab_size)).all()
              and np.isfinite(logits[mode]).all())
        if mode == "int8":
            ok = ok and (layer_q == want_layer
                         and {"pos_embed", "tok_embed"} <= names
                         and len(names) == 16 * c.n_layers + 2
                         and n_quant == len(names)
                         and n_deq == 32 * per_fwd)
            same_q = same_w = True
            for n in sorted(names):
                leaf = eng.params[n]
                rq, rs = qk.quantize_blockwise_reference(
                    params[n].contiguous(), 8, 256)
                same_q &= bool(torch.equal(leaf["__wq__"], rq)
                               and torch.equal(leaf["s"], rs))
                same_w &= bool(torch.equal(
                    eng._leaf(n), qk.dequantize_blockwise_reference(
                        rq, rs, 256, torch.bfloat16)))
            ok = ok and same_q and same_w
            log(f"families: v1 OPT-6.7B int8: {n_quant} quantize launches "
                f"({len(names)} leaves: 16 a layer x {c.n_layers} + "
                f"pos_embed + tok_embed), {n_deq} dequantize launches in "
                f"the 32-token generate ({per_fwd} a forward); payloads "
                f"and scales bitwise the plain quantize's {same_q}, "
                f"dequantized weights bitwise the plain dequantize's "
                f"{same_w}; param_bytes {eng.param_bytes()}")
        log(f"families: v1 OPT-6.7B {mode} [{card}]: built in "
            f"{built_s:.1f} s; 4 x 128-token prompts: prefill (+1 token) "
            f"{prefill_s * 1e3:.2f} ms; 32 new tokens in {wall:.4f} s = "
            f"{4 * 32 / wall:.1f} tokens/s, decode "
            f"{(wall - prefill_s) / 31 * 1e3:.3f} ms per step; "
            f"max_memory_allocated {torch.cuda.max_memory_allocated()} B "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"families: v1 OPT-6.7B {mode} failed")
        out[f"{mode}_tokens_per_s"] = 4 * 32 / wall
        if mode == "int8":
            # 6f (f) holds the TP engine's tokens and shards to these
            out["keep"] = {"engine": eng, "tokens": toks, "ids": ids}
        del eng
    a, b = logits["int8"], logits["bf16"]
    cos = float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
    log(f"families: v1 OPT-6.7B last-token logits int8 vs bf16 weights: "
        f"cosine {cos:.5f}, same argmax {a.argmax() == b.argmax()}")
    if cos < 0.95:
        raise SystemExit("families: int8 weights moved OPT-6.7B's logits "
                         "too far from the bf16 weights' (cosine < 0.95)")
    return out


def phase_families(card: str) -> dict:
    """6g: the decoder families beyond Llama at full width and depth. (a)
    OPT-6.7B and (b) GPT-2 XL (25 heads of head_dim 64) each through
    ``ServingEngine`` over ``RaggedInferenceEngine`` as phase 5 serves
    Llama-2-7B (8 requests, 32 new tokens, the paged launch counts set to
    0 just before and read after, tile items in the prefill puts), then
    layer 0's paged call of a mixed put against the plain version and
    timed (phase 5b); (c) ``init_inference`` of the same OPT-6.7B, bf16
    and int8 (:func:`_family_v1`). GPT-2 XL is freed; OPT-6.7B, its
    requests and streams and the int8 engine and tokens stay for 6f (e)
    and (f), under ``out["opt"]``."""
    t0 = time.perf_counter()
    out = {}
    for name, (preset, size, ctx, longest) in FAMILY_SERVING.items():
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        model = _family_model(preset, size)
        paths, eng, prompts = phase_serving(card, model, name=name,
                                            max_context=ctx,
                                            max_prompt=longest)
        mixed = phase_paged_mixed(paths.pop("mixed"), card,
                                  f"{name} mixed_put")
        streams = paths.pop("streams")
        del eng
        out[name] = {**paths, "mixed_put": mixed}
        log(f"families: {name} served in {time.perf_counter() - t1:.1f} s")
        if name == "OPT-6.7B":
            gc.collect()
            torch.cuda.empty_cache()
            out["v1"] = _family_v1(model, card)
            out["opt"] = {"model": model, "prompts": prompts,
                          "streams": streams, **out["v1"].pop("keep")}
        del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"families: phase 6g in {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------------------------------- phase 6h
ENCODER_BATCH = (32, 512)          # (a): BERT-large MLM forwards, rows x tokens
ENCODER_TIMED = 10                 # (a): timed forwards after 2 warm-ups
ENCODER_PADDED = 8                 # (b): rows of 64-512 real tokens
ENCODER_QUANT = {"enabled": True, "bits": 8, "group_size": 256}
ENCODER_QUANT_TIMED = 5            # (c): timed int8 forwards after 1 warm-up
CLIP_BATCH = 64                    # (d): texts and images a similarity
CLIP_TIMED = 5                     # (d): timed encode_text / encode_image
ENCODER_CPU_ABS = 1e-3             # (e): fp32 cuda vs cpu, as phase 4
# (d): the public openai/clip-vit-large-patch14 widths
CLIP_L14 = dict(text=dict(d_model=768, n_layers=12, n_heads=12, d_ff=3072),
                vision=dict(d_model=1024, n_layers=24, n_heads=16, d_ff=4096),
                proj_dim=768, image_size=224, patch_size=14)


@contextlib.contextmanager
def _first_flash_call(kept: dict):
    """Record the first ``flash_attention`` call the model core makes
    inside the block, of each ``causal`` value: ``kept[causal]`` holds its
    q, k, v (copies) and keywords (layer 0's call of a tower)."""
    from deepspeed_tpu_torch.models import transformer as tr

    real = tr.flash_attention

    def recording(q, k, v, **kw):
        if kw["causal"] not in kept:
            kept[kw["causal"]] = dict(q=q.clone(), k=k.clone(), v=v.clone(),
                                      **kw)
        return real(q, k, v, **kw)

    tr.flash_attention = recording
    try:
        yield kept
    finally:
        tr.flash_attention = real


def _flash_zero() -> None:
    fa.flash_forward.launches = fa.flash_forward.wgmma_launches = 0


def _encoder_row2(kept: dict, flush, card: str, tag: str) -> dict:
    """Row 2 at one encoder call (``kept`` from :func:`_first_flash_call`):
    against the plain version (out within HALF_TOL, lse within 1e-4 abs +
    1e-5 rel), twice bitwise, both launches on the Hopper forward; then
    timed with L2 flushed, in turns with the plain version, beside SDPA on
    the same inputs and the bound (4 d operations per visible pair at 989
    TFLOP/s; q, k, v read and out, lse written at 3.35 TB/s)."""
    import torch.nn.functional as F

    q, k, v = kept["q"], kept["k"], kept["v"]
    causal, scale = kept["causal"], kept.get("scale")
    b, s, hq, d = q.shape
    before = fa.flash_forward.wgmma_launches
    out, lse = fa.flash_forward(q, k, v, causal=causal, scale=scale)
    again, lse2 = fa.flash_forward(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    hopper = fa.flash_forward.wgmma_launches - before == 2
    ref, ref_lse = fa.flash_attention_forward_reference(
        q, k, v, causal=causal, scale=scale)
    ok, err, tol = check_half_or_fp32(out, ref)
    ok &= bool(((lse - ref_lse).abs() <= 1e-4 + 1e-5 * ref_lse.abs()).all())
    same = torch.equal(out, again) and torch.equal(lse, lse2)

    def kern():
        return fa.flash_forward(q, k, v, causal=causal, scale=scale)

    def plain():
        return fa.flash_attention_forward_reference(q, k, v, causal=causal,
                                                    scale=scale)

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              scale=scale)

    p1 = cuda_ms(plain, 3, flush)
    k1, k2 = cuda_ms(kern, 20, flush), cuda_ms(kern, 20, flush)
    p2 = cuda_ms(plain, 3, flush)
    lib_ms = cuda_ms(lib, 20, flush)
    pairs = _visible_pairs(b, s, s, hq, causal, 0)
    ops = 4.0 * d * pairs
    nbytes = 4 * q.numel() * q.element_size() + lse.numel() * 4
    t_ops = ops / PEAK_OPS_PER_S[q.dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    res = {"shape": f"b{b} s{s} h{hq} d{d} {str(q.dtype)[6:]} "
                    f"{'causal' if causal else 'non-causal'}",
           "ms": min(k1, k2), "plain_ms": min(p1, p2),
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": lib_ms, "max_abs_err": err}
    log(f"encoders: {tag} row 2 at layer 0's call, {res['shape']}: max abs "
        f"err {err:.3e} vs plain ({tol}; lse 1e-4 abs + 1e-5 rel), twice "
        f"bitwise {same}, Hopper forward {hopper}; kernel {k1:.4f}/"
        f"{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, sdpa {lib_ms:.4f} ms, "
        f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}: {ops:.3e} ops, "
        f"{nbytes} B), {ops / res['ms'] / 1e9:.1f} TFLOP/s [{card}] "
        f"{'ok' if ok and same and hopper else 'FAIL'}")
    if not (ok and same and hopper):
        raise SystemExit(f"encoders: row 2 at {tag}'s shape failed")
    return res


def _hidden_err(got, ref, lens) -> float:
    """Max |got - ref| over each row's real positions."""
    return max(float((got[i, :n].float() - ref[i, :n].float()).abs().max())
               for i, n in enumerate(lens))


def _padded_batch(vocab: int, rows: int, seed: int):
    """``rows`` rows of 64-512 real tokens (row 0 a full 512) padded to
    512: ids (0 at the pads), two segments (the second half of each row's
    real tokens type 1) and the mask, as numpy, and the lengths."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 513, rows)
    lens[0] = 512
    pos = np.arange(512)[None, :]
    mask = (pos < lens[:, None]).astype(np.int64)
    ids = rng.integers(1000, vocab, (rows, 512)) * mask
    types = (pos >= lens[:, None] // 2).astype(np.int64) * mask
    return ids, types, mask, [int(n) for n in lens]


def _bert_hidden(model, dev, ids, types, mask, lens):
    """(the padded batch's hidden states through the masked path, each row
    alone and unpadded through the flash path, zero-padded to 512)."""
    t = {n: torch.from_numpy(a).to(dev) for n, a in
         (("ids", ids), ("types", types), ("mask", mask))}
    padded = model.apply(t["ids"], return_hidden=True,
                         token_type_ids=t["types"], attn_mask=t["mask"])
    alone = torch.zeros_like(padded)
    for i, n in enumerate(lens):
        alone[i, :n] = model.apply(t["ids"][i:i + 1, :n], return_hidden=True,
                                   token_type_ids=t["types"][i:i + 1, :n])[0]
    return padded, alone


@torch.inference_mode()
def _encoder_cpu_parity(card: str) -> float:
    """6h (e): 2-layer BERT-large-width and CLIP-L/14-width models in fp32,
    the same weights on cuda and cpu: MLM logits (plain and padded with
    segments), text and image embeddings and the similarity within
    ENCODER_CPU_ABS. Then the BERT model's weights in bf16 on the card
    against the cpu fp32 hidden states, through the masked padded path and
    the unpadded flash path: returns that error, which sets (b)'s
    tolerance."""
    from deepspeed_tpu_torch.models.bert import Bert
    from deepspeed_tpu_torch.models.clip import (CLIP, CLIPConfig,
                                                 clip_text_config,
                                                 clip_vision_config)

    t0 = time.perf_counter()
    cpu = _draw_vectors(Bert("large", device="cpu", n_layers=2, seed=3), 3)
    gpu = Bert("large", device="cuda", n_layers=2, seed=3)
    gpu.load_state_dict(cpu.state_dict())
    ids, types, mask, lens = _padded_batch(cpu.config.vocab_size, 2, 12)
    finite, errs = True, {}
    for tag, kw in (("plain", {}), ("padded", {"types": types,
                                              "mask": mask})):
        outs = {}
        for dev, m in (("cuda", gpu), ("cpu", cpu)):
            args = {"token_type_ids": torch.from_numpy(kw["types"]).to(dev),
                    "attn_mask": torch.from_numpy(kw["mask"]).to(dev)} \
                if kw else {}
            outs[dev] = m.apply(torch.from_numpy(ids).to(dev), **args) \
                .float().cpu().numpy()
        errs[tag] = _max_err(outs["cuda"], outs["cpu"])
        finite &= bool(np.isfinite(outs["cuda"]).all())
    ref_h = cpu.apply(torch.from_numpy(ids), return_hidden=True,
                      token_type_ids=torch.from_numpy(types),
                      attn_mask=torch.from_numpy(mask))
    gpu.to(torch.bfloat16)
    padded, alone = _bert_hidden(gpu, "cuda", ids, types, mask, lens)
    bf16_err = max(_hidden_err(padded.cpu(), ref_h, lens),
                   _hidden_err(alone.cpu(), ref_h, lens))
    del cpu, gpu
    c = CLIP_L14
    cfg = CLIPConfig(clip_text_config(**{**c["text"], "n_layers": 2}),
                     clip_vision_config(**{**c["vision"], "n_layers": 2}),
                     proj_dim=c["proj_dim"], image_size=c["image_size"],
                     patch_size=c["patch_size"])
    ccpu = _draw_vectors(CLIP(cfg, device="cpu", seed=4), 4)
    cgpu = CLIP(cfg, device="cuda", seed=4)
    cgpu.load_state_dict(ccpu.state_dict())
    toks, pixels = _clip_inputs(2, 13)
    outs = {}
    for dev, m in (("cuda", cgpu), ("cpu", ccpu)):
        tt, pp = torch.from_numpy(toks).to(dev), torch.from_numpy(pixels) \
            .to(dev)
        outs[dev] = [x.float().cpu().numpy() for x in (
            m.encode_text(tt), m.encode_image(pp), m.similarity(tt, pp)[0])]
    for tag, g, r in zip(("text", "image", "similarity"), outs["cuda"],
                         outs["cpu"]):
        errs[tag] = _max_err(g, r)
        finite &= bool(np.isfinite(g).all())
    ok = finite and max(errs.values()) <= ENCODER_CPU_ABS
    log(f"encoders: (e) 2-layer BERT-large and CLIP-L/14-width fp32, cuda vs "
        f"cpu max abs err: " + ", ".join(f"{k} {e:.3e}" for k, e in
                                         errs.items())
        + f" (tol {ENCODER_CPU_ABS}); the BERT weights in bf16 on the card "
        f"vs cpu fp32 hidden states (masked padded and unpadded flash "
        f"paths, real positions of rows of {lens} tokens): {bf16_err:.4f} "
        f"[{card}] ({time.perf_counter() - t0:.1f} s) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("encoders: cuda disagrees with cpu")
    del ccpu, cgpu
    return bf16_err


def _clip_inputs(n: int, seed: int):
    """``n`` texts of 77 ids (a random length of 5-77 ending in the EOS
    49407, the highest id: argmax pooling; zeros after it) and ``n``
    images [3, 224, 224] of N(0, 1) pixels, as numpy."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(5, 78, n)
    toks = rng.integers(1, 49406, (n, 77)) * (np.arange(77)[None, :]
                                              < lens[:, None] - 1)
    toks[np.arange(n), lens - 1] = 49407
    return toks, rng.standard_normal((n, 3, 224, 224)).astype(np.float32)


@torch.inference_mode()
def _bert_large(card: str, flush, tol: float) -> dict:
    """6h (a)-(c) on BERT-large (seeded bf16 weights, every bias and norm
    term drawn)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.bert import Bert
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    model = _draw_vectors(Bert("large", dtype=torch.bfloat16, seed=0), 0)
    c = model.config
    b, s = ENCODER_BATCH
    ids = np.random.default_rng(10).integers(0, c.vocab_size, (b, s))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = deepspeed_tpu_torch.init_inference(model, {"dtype": "bfloat16"})
    for _ in range(2):
        eng.forward(ids)
    torch.cuda.synchronize()
    # (a) the main path: the counts from 0 just before, read just after
    _flash_zero()
    kept: dict = {}
    with _first_flash_call(kept):
        t1 = time.perf_counter()
        for _ in range(ENCODER_TIMED):
            logits = eng.forward(ids)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    launches = (fa.flash_forward.launches, fa.flash_forward.wgmma_launches)
    peak = torch.cuda.max_memory_allocated()
    ok = (launches == (c.n_layers * ENCODER_TIMED,) * 2
          and logits.shape == (b, s, c.vocab_size)
          and bool(torch.isfinite(logits).all()) and list(kept) == [False])
    per = wall / ENCODER_TIMED
    log(f"encoders: (a) BERT-large ({c.param_count()} params, "
        f"{c.n_layers} x d {c.d_model}, {c.n_heads} heads of {c.head_dim}, "
        f"post-LN, non-causal) init_inference bf16 [{card}]: "
        f"{ENCODER_TIMED} forwards of {b} x {s} tokens in {wall:.4f} s = "
        f"{per * 1e3:.2f} ms a forward, {b / per:.1f} sequences/s, "
        f"{b * s / per:.0f} tokens/s; flash launches {launches[0]} "
        f"(Hopper forward {launches[1]}; {c.n_layers} a forward); "
        f"max_memory_allocated {peak} B; MLM logits {tuple(logits.shape)} "
        f"finite {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("encoders: BERT-large forward failed")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        eng.forward(ids)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t1
    d = _device_groups(prof, {"flash": ("flash",),
                              "gemm": ("nvjet", "gemm", "xmma", "cutlass")},
                       pwall)
    if d["busy_us"] > 0:
        _log_device_groups("encoders: (a)", card, "one profiled forward",
                           pwall, d, 8)
    else:
        log("encoders: torch.profiler recorded no device time: breakdown "
            "not measured")
    out = {"seq_per_s": b / per, "ms": per * 1e3, "peak": peak,
           "launches": launches[0], "wgmma_launches": launches[1],
           "row2": _encoder_row2(kept[False], flush, card, "BERT-large")}
    del kept
    # (b) the padded batch: the plain masked path against each row alone
    ids8, types, mask, lens = _padded_batch(c.vocab_size, ENCODER_PADDED, 11)
    before = fa.flash_forward.wgmma_launches
    padded, alone = _bert_hidden(model, "cuda", ids8, types, mask, lens)
    moved = fa.flash_forward.wgmma_launches - before
    nomask = model.apply(torch.from_numpy(ids8).cuda(), return_hidden=True,
                         token_type_ids=torch.from_numpy(types).cuda())
    pooled = model.pooled(padded)
    cls_alone = model.pooled(alone)
    err = _hidden_err(padded, alone, lens)
    perr = float((pooled.float() - cls_alone.float()).abs().max())
    control = _hidden_err(nomask, alone, lens)
    limit = tol * c.n_layers / 2
    ok = (err <= limit and perr <= limit and moved == c.n_layers * len(lens)
          and bool(torch.isfinite(padded).all())
          and bool(torch.isfinite(pooled).all()))
    log(f"encoders: (b) {len(lens)} rows of {lens} real tokens padded to 512, "
        f"two segments, through model.apply(..., attn_mask=...) (the plain "
        f"masked path): hidden states at the real positions vs each row "
        f"alone unpadded on the kernel path max abs err {err:.4f}, pooled "
        f"[CLS] {perr:.4f} (tol {limit:.4f} = {c.n_layers} / 2 layers x "
        f"(e)'s 2-layer bf16 vs cpu fp32 error {tol:.4f}); the padded rows "
        f"without the mask {control:.4f} (control); the rows alone took "
        f"{moved} Hopper forward launches, the masked batch none "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("encoders: the padded batch disagrees with its "
                         "rows run alone")
    del padded, alone, nomask
    out["padded_err"], out["padded_tol"] = err, limit
    # (c) int8 weights, group 256, beside the bf16 engine's weights
    ref_logits = logits
    del logits
    params = dict(model.named_parameters())
    for wrapper, *_ in QUANT_KERNELS.values():
        wrapper.launches = 0
    t1 = time.perf_counter()
    eng8 = deepspeed_tpu_torch.init_inference(
        (model, params), {"dtype": "bfloat16", "quant": ENCODER_QUANT})
    torch.cuda.synchronize()
    built = time.perf_counter() - t1
    n_quant = qk.quantize_blockwise.launches
    eng8.forward(ids)
    torch.cuda.synchronize()
    d0 = qk.dequantize_blockwise.launches
    t1 = time.perf_counter()
    for _ in range(ENCODER_QUANT_TIMED):
        lg8 = eng8.forward(ids)
    torch.cuda.synchronize()
    wall8 = time.perf_counter() - t1
    per_fwd = (qk.dequantize_blockwise.launches - d0) / ENCODER_QUANT_TIMED
    int8_launches = {n: w.launches for n, (w, *_) in QUANT_KERNELS.items()}
    names = set(eng8._wq_shapes)
    # every layer leaf, tok_embed (read twice: embedding and tied head),
    # pos_embed, type_embed, mlm_dense_w; pooler_w is quantized, unread
    want = 16 * c.n_layers + 5
    same_q = same_w = True
    for n in sorted(names):
        leaf = eng8.params[n]
        rq, rs = qk.quantize_blockwise_reference(params[n].contiguous(), 8,
                                                 256)
        same_q &= bool(torch.equal(leaf["__wq__"], rq)
                       and torch.equal(leaf["s"], rs))
        same_w &= bool(torch.equal(eng8._leaf(n), qk.
                                   dequantize_blockwise_reference(
                                       rq, rs, 256, torch.bfloat16)))
    a, r = lg8.double().reshape(-1), ref_logits.double().reshape(-1)
    cos = float(a @ r / a.norm() / r.norm())
    agree = float((lg8.argmax(-1) == ref_logits.argmax(-1)).float().mean())
    ok = (len(names) == want and n_quant == want and per_fwd == want
          and {"type_embed", "mlm_dense_w", "pooler_w", "pos_embed",
               "tok_embed"} <= names and same_q and same_w and cos >= 0.95
          and bool(torch.isfinite(lg8).all()))
    per8 = wall8 / ENCODER_QUANT_TIMED
    log(f"encoders: (c) BERT-large int8 (group 256) [{card}]: built in "
        f"{built:.2f} s, {n_quant} quantize launches ({len(names)} leaves: "
        f"16 a layer x {c.n_layers} + tok_embed, pos_embed, type_embed, "
        f"mlm_dense_w, pooler_w), {per_fwd:g} dequantize launches a forward "
        f"(the tied tok_embed twice, pooler_w unread); payloads and scales "
        f"bitwise the plain quantize's {same_q}, dequantized weights "
        f"bitwise the plain dequantize's {same_w}; param_bytes "
        f"{eng8.param_bytes()} (bf16 {eng.param_bytes()}); "
        f"{per8 * 1e3:.2f} ms a forward = {b / per8:.1f} sequences/s "
        f"({per / per8:.2f}x bf16's rate); MLM logits vs bf16 weights cosine "
        f"{cos:.5f}, argmax agreement {agree:.4f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("encoders: BERT-large int8 failed")
    out.update(int8_seq_per_s=b / per8, quant_launches=n_quant,
               dequant_per_forward=per_fwd, int8_launches=int8_launches)
    del eng8, lg8, ref_logits, eng, params, model
    log(f"encoders: BERT-large (a)-(c) in {time.perf_counter() - t0:.1f} s")
    return out


@torch.inference_mode()
def _clip_l14(card: str, flush) -> dict:
    """6h (d): CLIP ViT-L/14 at 224, seeded bf16 weights with every bias
    and norm term drawn, ``similarity`` over 64 texts x 64 images."""
    from deepspeed_tpu_torch.models.clip import (CLIP, CLIPConfig,
                                                 clip_text_config,
                                                 clip_vision_config)

    t0 = time.perf_counter()
    c = CLIP_L14
    cfg = CLIPConfig(clip_text_config(**c["text"]),
                     clip_vision_config(**c["vision"]),
                     proj_dim=c["proj_dim"], image_size=c["image_size"],
                     patch_size=c["patch_size"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = _draw_vectors(CLIP(cfg, dtype=torch.bfloat16, seed=0), 0)
    n_params = sum(p.numel() for p in model.parameters())
    toks, pixels = _clip_inputs(CLIP_BATCH, 14)
    tt, pp = torch.from_numpy(toks).cuda(), torch.from_numpy(pixels).cuda()
    model.similarity(tt, pp)
    torch.cuda.synchronize()
    # the main path: the counts from 0 just before, read just after
    _flash_zero()
    kept: dict = {}
    with _first_flash_call(kept):
        lpt, lpi = model.similarity(tt, pp)
    torch.cuda.synchronize()
    launches = (fa.flash_forward.launches, fa.flash_forward.wgmma_launches)
    per_sim = cfg.text.n_layers + cfg.vision.n_layers
    text, vision = kept[True], kept[False]
    times = {}
    for name, fn in (("texts", lambda: model.encode_text(tt)),
                     ("images", lambda: model.encode_image(pp))):
        t1 = time.perf_counter()
        for _ in range(CLIP_TIMED):
            fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t1) / CLIP_TIMED
    peak = torch.cuda.max_memory_allocated()
    ok = (launches == (per_sim,) * 2
          and lpt.shape == (CLIP_BATCH, CLIP_BATCH)
          and torch.equal(lpt, lpi.T) and bool(torch.isfinite(lpt).all())
          and tuple(vision["q"].shape[1:3]) == (257, 16)
          and tuple(text["q"].shape[1:3]) == (77, 12))
    log(f"encoders: (d) CLIP ViT-L/14 at 224 ({n_params} params; text "
        f"{cfg.text.n_layers} x d {cfg.text.d_model} causal at 77 tokens, "
        f"vision {cfg.vision.n_layers} x d {cfg.vision.d_model} non-causal "
        f"at 257) [{card}]: encode_image {times['images'] * 1e3:.2f} ms = "
        f"{CLIP_BATCH / times['images']:.1f} images/s, encode_text "
        f"{times['texts'] * 1e3:.2f} ms = {CLIP_BATCH / times['texts']:.1f} "
        f"texts/s ({CLIP_BATCH} a call); flash launches {launches[0]} "
        f"(Hopper forward {launches[1]}; {cfg.text.n_layers} + "
        f"{cfg.vision.n_layers} a similarity); logits per text "
        f"{tuple(lpt.shape)} finite, the transpose of logits per image; "
        f"max_memory_allocated {peak} B {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("encoders: CLIP ViT-L/14 failed")
    out = {"images_per_s": CLIP_BATCH / times["images"],
           "texts_per_s": CLIP_BATCH / times["texts"], "peak": peak,
           "launches": launches[0], "wgmma_launches": launches[1],
           "row2_vision": _encoder_row2(vision, flush, card, "CLIP vision"),
           "row2_text": _encoder_row2(text, flush, card, "CLIP text")}
    del model, kept, text, vision
    log(f"encoders: CLIP (d) in {time.perf_counter() - t0:.1f} s")
    return out


def phase_encoders(card: str) -> dict:
    """6h: the encoder families at full width. (e) first, since its bf16
    error sets (b)'s tolerance: 2-layer BERT-large and CLIP-L/14-width
    models cuda vs cpu in fp32; (a) BERT-large through ``init_inference``
    (bf16), 10 forwards of 32 x 512, its flash launches counted from 0,
    one profiled forward, row 2 at layer 0's call; (b) a padded batch
    through the masked path against its rows alone; (c) int8 weights;
    (d) CLIP ViT-L/14 ``similarity`` over 64 x 64, row 2 at the vision
    and text towers' calls."""
    t0 = time.perf_counter()
    tol = _encoder_cpu_parity(card)
    gc.collect()
    torch.cuda.empty_cache()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    out = {"bert": _bert_large(card, flush, tol)}
    gc.collect()
    torch.cuda.empty_cache()
    out["clip"] = _clip_l14(card, flush)
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"encoders: phase 6h in {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------- phase 6i
MOE_PRESET = ("350m", 128)        # DeepSpeed-MoE's 350M+MoE-128
MOE_PAGES = 2048                  # (a): 16-token bf16 pages, 3.22 GB
MOE_CONTEXT = 2048                # the preset's max_seq_len
MOE_QUANT = {"enabled": True, "bits": 8, "group_size": 256}
MOE_PARITY = {"n_layers": 2}      # (d): full width, 32 experts, fp32
MOE_PARITY_EXPERTS = 32
MOE_CPU_ABS = 1e-3                # (d): fp32 cuda vs cpu, as phase 4
MOE_FFN_TIMED = 10                # (b): timed calls of each route


def _moe_choices(model, sink: list):
    """Make ``model``'s expert bank append each call's top-k expert ids
    ``[tokens, k]`` and fp32 gate logits (host copies) to ``sink``,
    routed as ``MoELayer.apply``'s eval route routes them; returns the
    undo."""
    layer = model.moe
    real, prev = layer.apply, layer.__dict__.get("apply")

    def recording(params, x, generator=None, training=True, **tp):
        logits = (x.float() @ params["wg"].float()).reshape(-1, params[
            "wg"].shape[1])
        topi = torch.topk(torch.softmax(logits, dim=-1),
                          layer.gate.top_k, dim=-1).indices
        sink.append((topi.cpu(), logits.cpu()))
        return real(params, x, generator, training, **tp)

    layer.apply = recording

    def undo():
        # back to the wrapper this one wrapped, if any
        if prev is None:
            layer.__dict__.pop("apply", None)
        else:
            layer.apply = prev

    return undo


def _same_experts(a: list, b: list) -> tuple:
    """(share of (layer, token) whose top-k expert sets agree, each
    layer's share)."""
    per = []
    for (ta, _), (tb, _) in zip(a, b):
        sa, sb = ta.sort(-1).values, tb.sort(-1).values
        per.append(float((sa == sb).all(-1).float().mean()))
    return sum(per) / max(len(per), 1), per


def _moe_ffn(model, h: torch.Tensor, tag: str, flush, card: str) -> dict:
    """6i (b): layer 0's expert FFN on one put's input ``h`` ``[1, T, d]``
    (padding lanes included, as the engine runs them), routed once as the
    eval route routes; the grouped route against the per-group loop on
    the same rows and routing, each timed beside the bound: the larger of
    the bytes of the experts hit plus the rows in and out at 3.35 TB/s
    and 2 x pairs x d x f x 2 operations at 989 TFLOP/s."""
    from deepspeed_tpu_torch.parallel import moe

    c = model.config
    blk = model.layers[0]
    params = {k: blk[k] for k in model.moe.shapes()}
    x = h.reshape(-1, c.d_model)
    with torch.inference_mode():
        probs = torch.softmax(x.float() @ params["wg"].float(), dim=-1)
        topw, topi = torch.topk(probs, c.top_k, dim=-1)
        topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

        def run(route):
            return moe.no_drop_moe(x, topw, topi, params, c.activation, route)

        grouped, loop = run("grouped"), run("loop")
        again = run("grouped")
        torch.cuda.synchronize()
        ok, err, tol = check_half_or_fp32(grouped, loop)
        ok = ok and bool(torch.equal(grouped, again))
        t = {r: cuda_ms(lambda: run(r), MOE_FFN_TIMED, flush)
             for r in ("grouped", "loop")}
    hit = int(torch.unique(topi).numel())
    pairs, d, f = topi.numel(), c.d_model, c.d_ff
    wbytes = hit * 2 * d * f * x.element_size()
    nbytes = wbytes + 2 * x.numel() * x.element_size()
    ops = 2 * pairs * d * f * 2
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / 989e12) * 1e3
    out = {"T": x.shape[0], "pairs": pairs, "experts_hit": hit,
           "grouped_ms": t["grouped"], "loop_ms": t["loop"],
           "bound_ms": bound_ms,
           "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
           >= ops / 989e12 else "operations",
           "bytes": nbytes, "max_abs_err": err}
    log(f"moe (b) layer-0 FFN of a {tag} put [{card}]: T {x.shape[0]} rows "
        f"({pairs} pairs), {hit} of {c.n_experts} experts hit; grouped "
        f"route {t['grouped']:.4f} ms, per-group loop {t['loop']:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({out['bound_by']}: {nbytes} B, {ops} "
        f"operations); grouped vs loop max_abs_err {err:.3e} (tol {tol}), "
        f"grouped twice bitwise {torch.equal(grouped, again)} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"moe (b): the grouped route disagrees with the "
                         f"loop at the {tag} put")
    return out


def _moe_puts(model, eng, card: str) -> dict:
    """6i (b) and the profiled decode put: 16 sequences of 32 tokens in
    one 512-lane prefill put, then decode puts of one token each; layer
    0's FFN input of the prefill put and of a decode put is kept for
    (b), and one decode put runs under ``torch.profiler`` (idle share,
    launches, device time by group)."""
    from torch.profiler import ProfilerActivity, profile

    c = model.config
    rng = np.random.default_rng(16)
    uids = list(range(30_000, 30_016))
    prompts = [rng.integers(1, c.vocab_size, 32).tolist() for _ in uids]
    kept = {}
    real = model._mlp

    def recording(h, lp, *a, **kw):
        if "want" in kept and lp is model.layers[0]:
            kept[kept.pop("want")] = h.detach().clone()
        return real(h, lp, *a, **kw)

    model._mlp = recording
    try:
        kept["want"] = "prefill"
        logits = eng.put(uids, prompts)
        if np.isnan(logits).any():
            raise SystemExit("moe: the 16 prompts did not fit one put")
        nxt = [[int(t)] for t in np.argmax(logits, -1)]
        kept["want"] = "decode"
        logits = eng.put(uids, nxt)
    finally:
        del model._mlp
    nxt = [[int(t)] for t in np.argmax(logits, -1)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.put(uids, nxt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.flush(uids)
    d = _device_groups(
        prof, {"paged_attention": ("paged_",),
               "grouped_mm": ("group",),
               "gemm": ("nvjet", "gemm", "xmma", "cutlass", "cublas")}, wall)
    if d["busy_us"] <= 0:
        log(f"moe (a) profile [{card}]: torch.profiler recorded no device "
            f"time: breakdown not measured")
    else:
        _log_device_groups("moe (a) profile", card,
                           "a 16-lane decode put", wall, d, 6)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    out = {tag: _moe_ffn(model, kept[tag], tag, flush, card)
           for tag in ("decode", "prefill")}
    del flush
    out["profile"] = {"wall_ms": wall * 1e3, "launches": d["launches"],
                      "busy_ms": d["busy_us"] / 1e3}
    return out


def _moe_quantized_leaves(model, block: int) -> tuple:
    """(leaves the JAX rule quantizes, dequantizes a forward): every
    floating leaf of two or more dimensions on the JAX stacked shape
    whose stacked size divides by ``block``; a forward reads each once,
    the tied ``tok_embed`` twice (embedding and head)."""
    n = model.config.n_layers
    names = []
    for name, p in model.named_parameters():
        stacked = name.startswith("layers.")
        if p.dim() + stacked >= 2 and (
                (n if stacked else 1) * p.numel()) % block == 0:
            names.append(name)
    per_fwd = len(names) + (model.config.tie_embeddings
                            and "tok_embed" in names)
    return names, per_fwd


def _moe_v1(model, card: str) -> dict:
    """6i (c): ``init_inference`` of the same model, bf16 then int8
    weights at group 256, phase 6a's 4 x 128-token prompts, 32 new tokens
    greedy. The bf16 engine casts nothing (the weights are bf16 already);
    the int8 engine is built from the model itself, so it empties the
    model's leaves as it quantizes them. The quantize count is set to 0
    just before the int8 build, the dequantize count read around its
    32-token generate, both against the leaf set's count. Layer 0's
    leaves and ``tok_embed`` are copied to the host before the int8
    build: their payloads and scales must be bitwise the plain quantize's
    of the bf16 leaves, their dequantized weights bitwise the plain
    dequantize's. The last position's logits and every layer's expert
    choices of a forward over the 4 prompts are compared between the two
    and reported: a bank's quantization noise moves gate logits enough to
    flip near-tied experts, and a flip changes a token's whole FFN
    output, so no cosine bound is set."""
    import deepspeed_tpu_torch

    c = model.config
    ids = np.random.default_rng(8).integers(1, c.vocab_size, (4, 128))
    names, per_fwd = _moe_quantized_leaves(model, MOE_QUANT["group_size"])
    out, logits, choices = {}, {}, {}
    for mode in ("bf16", "int8"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = {"dtype": "bfloat16", "temperature": 0.0}
        if mode == "int8":
            cfg["quant"] = MOE_QUANT
            kept = {n: p.detach().cpu() for n, p in model.named_parameters()
                    if n.startswith("layers.0.") or n == "tok_embed"}
            for wrapper, *_ in QUANT_KERNELS.values():
                wrapper.launches = 0
        t0 = time.perf_counter()
        q0 = qk.quantize_blockwise.launches
        eng = deepspeed_tpu_torch.init_inference(model, cfg)
        torch.cuda.synchronize()
        built_s = time.perf_counter() - t0
        n_quant = qk.quantize_blockwise.launches - q0
        eng.generate(ids, max_new_tokens=2)                  # warm-up
        torch.cuda.synchronize()
        d0 = qk.dequantize_blockwise.launches
        t1 = time.perf_counter()
        toks = eng.generate(ids, max_new_tokens=32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        n_deq = qk.dequantize_blockwise.launches - d0
        if mode == "int8":
            out["launches"] = {n: w.launches
                               for n, (w, *_) in QUANT_KERNELS.items()}
        sink = []
        undo = _moe_choices(model, sink)
        try:
            full = eng.forward(ids)
        finally:
            undo()
        logits[mode] = full[:, -1].float().cpu().numpy()
        choices[mode] = sink
        del full
        ok = (toks.shape == (4, 160)
              and ((toks >= 0) & (toks < c.vocab_size)).all()
              and np.isfinite(logits[mode]).all()
              and len(sink) == c.n_layers)
        if mode == "int8":
            ok = ok and (sorted(eng._wq_shapes) == sorted(names)
                         and n_quant == len(names)
                         and n_deq == 32 * per_fwd)
            block = MOE_QUANT["group_size"]
            same_q = same_w = True
            for n, host in kept.items():
                rq, rs = qk.quantize_blockwise_reference(
                    host.to("cuda").contiguous(), 8, block)
                same_q &= bool(torch.equal(eng.params[n]["__wq__"], rq)
                               and torch.equal(eng.params[n]["s"], rs))
                same_w &= bool(torch.equal(
                    eng._leaf(n), qk.dequantize_blockwise_reference(
                        rq, rs, block, torch.bfloat16)
                    .reshape(host.shape)))
                del rq, rs
            ok = ok and same_q and same_w
            log(f"moe (c) v1 int8: layer 0's {len(kept) - 1} leaves and "
                f"tok_embed: payloads and scales bitwise the plain "
                f"quantize's {same_q}, dequantized weights bitwise the "
                f"plain dequantize's {same_w}")
            del kept
            log(f"moe (c) v1 int8: {n_quant} quantize launches at the build "
                f"({len(names)} leaves by the JAX rule on the stacked "
                f"shapes: {len(names) - 2} layer leaves, expert banks and "
                f"wg included, + pos_embed + tok_embed), {n_deq} dequantize "
                f"launches in the 32-token generate ({per_fwd} a forward, "
                f"the tied table twice; worked out {32 * per_fwd}); "
                f"param_bytes {eng.param_bytes()}")
        else:
            ok = ok and n_quant == 0 and n_deq == 0
            out["bf16_param_bytes"] = eng.param_bytes()
        log(f"moe (c) v1 {mode} [{card}]: built in {built_s:.1f} s; 4 x "
            f"128-token prompts, 32 new tokens in {wall:.4f} s = "
            f"{4 * 32 / wall:.1f} tokens/s; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()} B {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"moe (c): v1 {mode} failed")
        out[f"{mode}_tokens_per_s"] = 4 * 32 / wall
        out[f"{mode}_param_bytes"] = eng.param_bytes()
        del eng
    a, b = logits["int8"], logits["bf16"]
    cos = float((a * b).sum() / np.linalg.norm(a) / np.linalg.norm(b))
    same, per_layer = _same_experts(choices["int8"], choices["bf16"])
    out.update(cosine=cos, same_experts=same, same_by_layer=per_layer)
    log(f"moe (c) int8 vs bf16 weights: last-position logits cosine "
        f"{cos:.5f}, same argmax {(a.argmax(-1) == b.argmax(-1)).mean():.2f}; "
        f"same top-{c.top_k} experts at {same:.4f} of the {c.n_layers} "
        f"layers x {ids.size} tokens; by layer "
        + " ".join(f"{x:.3f}" for x in per_layer)
        + " (a flip changes a token's FFN output, and the layers after "
          "it see another input)")
    return out


def _moe_cpu_parity(card: str) -> dict:
    """6i (d): a 2-layer model at full width (d 1024, f 4096, 32 experts,
    top-2) in fp32, the same weights on cuda (the grouped route) and cpu
    (the loop): logits within 1e-3; expert choices identical, or each
    flip's gate-logit gap reported."""
    import copy

    from deepspeed_tpu_torch.models.moe import MoETransformer, gpt_moe_config

    cfg = gpt_moe_config(MOE_PRESET[0], MOE_PARITY_EXPERTS, **MOE_PARITY)
    cpu = MoETransformer(cfg, device="cpu", seed=5)
    dev = copy.deepcopy(cpu).to("cuda")
    ids = np.random.default_rng(17).integers(1, cfg.vocab_size, (2, 64))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    got = {}
    try:
        for name, m in (("cuda", dev), ("cpu", cpu)):
            sink = []
            undo = _moe_choices(m, sink)
            try:
                with torch.inference_mode():
                    got[name] = (m.apply(torch.from_numpy(ids).to(m.device))
                                 .cpu(), sink)
            finally:
                undo()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (lg, cg), (lc, cc) = got["cuda"], got["cpu"]
    err = float((lg - lc).abs().max())
    flips = []
    for li, ((ti, _), (tc, logit)) in enumerate(zip(cg, cc)):
        bad = (ti.sort(-1).values != tc.sort(-1).values).any(-1)
        for tok in bad.nonzero().flatten().tolist():
            top = logit[tok].topk(cfg.top_k + 1).values
            flips.append((li, tok, float(top[-2] - top[-1])))
    ok = err <= MOE_CPU_ABS and bool(torch.isfinite(lg).all())
    log(f"moe (d) 2-layer d {cfg.d_model} f {cfg.d_ff} x "
        f"{cfg.n_experts} experts top-{cfg.top_k} fp32, cuda (grouped) vs "
        f"cpu (loop) [{card}]: logits max_abs_err {err:.3e} (tol "
        f"{MOE_CPU_ABS}); expert flips {len(flips)} of "
        f"{cfg.n_layers * ids.size} (layer, token)"
        + "".join(f"; layer {li} token {t}: gate-logit gap {g:.3e}"
                  for li, t, g in flips) + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("moe (d): cuda and cpu disagree")
    return {"max_abs_err": err, "flips": len(flips)}


def phase_moe(card: str) -> dict:
    """6i: DeepSpeed-MoE's 350M+MoE-128 (24 layers, d 1024, 16 heads of
    64, d_ff 4096, 128 experts top-2, GELU, LayerNorm, learned positions,
    tied head; 25.9e9 parameters, seeded bf16 weights) on one card. (a)
    behind ``ServingEngine`` over ``RaggedInferenceEngine`` as phase 5
    serves Llama-2-7B (8 requests, 32 new tokens, 2048 16-token pages,
    ``max_context`` 2048, paged launches counted from 0: one a layer a
    put, tile items in the prefill puts), then a 512-lane prefill put, a
    decode put and one profiled decode put; (b) layer 0's expert FFN of
    those two puts, the grouped route against the loop, timed; (c)
    ``init_inference`` bf16 and int8; (d) a 2-layer full-width model in
    fp32, cuda against cpu."""
    from deepspeed_tpu_torch.models.moe import GPTMoE

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    model = GPTMoE(*MOE_PRESET, dtype=torch.bfloat16, seed=0)
    c = model.config
    n_params = sum(p.numel() for p in model.parameters())
    log(f"moe: GPT-MoE {MOE_PRESET[0]} x {MOE_PRESET[1]} experts "
        f"top-{c.top_k}: {n_params} parameters (param_count "
        f"{c.param_count()}, active a token {c.active_param_count()}), "
        f"made in {time.perf_counter() - t0:.1f} s")
    if n_params != c.param_count():
        raise SystemExit("moe: the model's leaves do not add up to "
                         "param_count")
    paths, eng, _ = phase_serving(card, model, name="GPT-MoE 350M+MoE-128",
                                  max_context=MOE_CONTEXT, pages=MOE_PAGES,
                                  tag="moe (a) serving")
    del paths["mixed"], paths["streams"]
    out = {**paths, **_moe_puts(model, eng, card)}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    out["v1"] = _moe_v1(model, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out["cpu"] = _moe_cpu_parity(card)
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"moe: phase 6i in {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------- phase 6j
SD_PROMPTS = 2                     # (b): seeded prompts (+ as many empty)
SD_LATENT = 64                     # (c): 64 x 64 latents, 512 x 512 images
SD_GUIDANCE = 7.5
SD_PARITY_LATENT = 16              # (d): cuda vs cpu, 128 x 128 images
SD_PARITY_STEPS = 3
SD_CPU_REL = 1e-4                  # (d): max abs err / max |cpu|, fp32
# (b): kernel vs plain attention through 12 bf16 layers: the norm of the
# difference over the norm of the plain states, and the largest element
# (8 bf16 ulps at the final LN's |x| ~ 4)
SD_TEXT_TOL = (2e-2, 0.25)
SD_PREDICTED_S = 45.0              # stated before the first chip run
SD_PROFILE_GROUPS = {
    "convolution": ("conv", "fprop", "winograd", "implicit", "cudnn"),
    "gemm": ("gemm", "nvjet", "cutlass", "cublas", "xmma"),
    "attention softmax": ("softmax",),
    "groupnorm / elementwise": ("elementwise", "reduce", "vectorized",
                                "norm", "cat", "copy", "fill", "index",
                                "pad", "upsample")}


def _sd_ids(seed: int) -> np.ndarray:
    """[2 * SD_PROMPTS, 77] ids: SD_PROMPTS unconditional rows (the empty
    prompt: BOS 49406, EOS 49407, zeros), then SD_PROMPTS prompts of a
    random 5-77 ids, BOS first and EOS last."""
    rng = np.random.default_rng(seed)
    toks = np.zeros((2 * SD_PROMPTS, 77), np.int64)
    toks[:, 0] = 49406
    toks[:SD_PROMPTS, 1] = 49407
    for i, n in enumerate(rng.integers(5, 78, SD_PROMPTS)):
        toks[SD_PROMPTS + i, 1:n - 1] = rng.integers(1, 49406, n - 2)
        toks[SD_PROMPTS + i, n - 1] = 49407
    return toks


def _sd_models(card: str) -> tuple:
    """6j (a): SD 1.5's UNet and VAE and the CLIP ViT-L/14 text tower's
    model, seeded bf16 weights with every bias and norm term drawn."""
    from deepspeed_tpu_torch.models.clip import (CLIP, CLIPConfig,
                                                 clip_text_config,
                                                 clip_vision_config)
    from deepspeed_tpu_torch.models.diffusion import (AutoencoderKL,
                                                      UNet2DCondition,
                                                      UNetConfig, VAEConfig)

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    unet = _draw_vectors(UNet2DCondition(UNetConfig(), dtype=torch.bfloat16,
                                         seed=0), 0)
    vae = _draw_vectors(AutoencoderKL(VAEConfig(), dtype=torch.bfloat16,
                                      seed=1), 1)
    c = CLIP_L14
    clip = _draw_vectors(CLIP(CLIPConfig(
        clip_text_config(**c["text"]), clip_vision_config(**c["vision"]),
        proj_dim=c["proj_dim"], image_size=c["image_size"],
        patch_size=c["patch_size"]), dtype=torch.bfloat16, seed=2), 2)
    torch.cuda.synchronize()
    counts = {"unet": sum(p.numel() for p in unet.parameters()),
              "vae": sum(p.numel() for p in vae.parameters()),
              "text": sum(p.numel() for p in clip.text.parameters())}
    peak = torch.cuda.max_memory_allocated()
    ok = counts["unet"] == unet.config.param_count() == 859_520_964
    log(f"diffusion: (a) SD 1.5 UNet {counts['unet']} params (param_count "
        f"{unet.config.param_count()}), VAE {counts['vae']}, CLIP ViT-L/14 "
        f"text tower {counts['text']}, seeded bf16, made in "
        f"{time.perf_counter() - t0:.1f} s; max_memory_allocated {peak} B "
        f"[{card}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("diffusion: the UNet does not count SD 1.5's "
                         "859,520,964 parameters")
    return unet, vae, clip, counts


def _sd_text(clip, card: str) -> tuple:
    """6j (b): the prompts' final-LN text states, row 2's launches counted
    from 0 around the encode, held against the same encode with the plain
    attention on the card."""
    ids = torch.from_numpy(_sd_ids(17)).cuda()
    with torch.inference_mode():
        clip.text_states(ids)
        torch.cuda.synchronize()
        # the main path: the counts from 0 just before, read just after
        _flash_zero()
        states = clip.text_states(ids)
        torch.cuda.synchronize()
        launches = (fa.flash_forward.launches,
                    fa.flash_forward.wgmma_launches)
        cfg = clip.text.config
        clip.text.config = dataclasses.replace(cfg, use_flash=False)
        try:
            plain = clip.text_states(ids)
        finally:
            clip.text.config = cfg
    diff = (states.float() - plain.float())
    rel = float(diff.norm() / plain.float().norm())
    err = float(diff.abs().max())
    n = cfg.n_layers
    ok = (launches == (n, n) and tuple(states.shape) == (
        2 * SD_PROMPTS, 77, cfg.d_model) and states.dtype == torch.bfloat16
        and bool(torch.isfinite(states).all()) and rel <= SD_TEXT_TOL[0]
        and err <= SD_TEXT_TOL[1])
    log(f"diffusion: (b) text states {tuple(states.shape)} "
        f"{str(states.dtype)[6:]} of {SD_PROMPTS} prompts + {SD_PROMPTS} "
        f"empty: flash launches {launches[0]} (Hopper forward "
        f"{launches[1]}; {n} expected, causal at 77), vs the plain "
        f"attention: |diff| / |plain| {rel:.3e} (tol {SD_TEXT_TOL[0]}), "
        f"max abs err {err:.4f} (tol {SD_TEXT_TOL[1]}) [{card}] "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("diffusion: the text encode failed")
    return states, launches


def _unet_flops(unet, lat2, t, ctx) -> tuple:
    """(operations, {aten op: operations}) of one UNet call on these
    inputs, counted by ``torch.utils.flop_counter`` from the convolutions
    and matmuls it dispatches (2 a multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        unet.apply(lat2, t, ctx)
    by_op = {str(k): float(v)
             for k, v in counter.get_flop_counts()["Global"].items()}
    return float(counter.get_total_flops()), by_op


def _sd_generate(pipe, ctx: tuple, card: str) -> dict:
    """6j (c): 50 DDIM steps at guidance 7.5 on 64 x 64 latents, then the
    decode to 512 x 512, every step between CUDA events; the same seed
    again through ``pipe(...)`` must give the same image bitwise."""
    uncond, cond = ctx
    ts, alpha_t, alpha_prev = pipe.schedule.arrays("cuda")
    both = torch.cat([uncond, cond], dim=0)
    gen = torch.Generator(device="cuda")
    n = len(pipe.schedule.timesteps)
    with torch.inference_mode():
        lat = torch.randn(pipe.latent_shape(SD_PROMPTS, SD_LATENT,
                                            SD_LATENT), device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(99))
        lat2 = torch.cat([lat, lat])
        flops, by_op = _unet_flops(pipe.unet, lat2, ts[0], both)
        pipe.step(lat, ts[0], alpha_t[0], alpha_prev[0], both)   # warm
        pipe.vae.decode(lat)
        torch.cuda.synchronize()
        gen.manual_seed(7)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 2)]
        t0 = time.perf_counter()
        lat = torch.randn(pipe.latent_shape(SD_PROMPTS, SD_LATENT,
                                            SD_LATENT), generator=gen,
                          device="cuda", dtype=torch.float32)
        events[0].record()
        for i in range(n):
            lat = pipe.step(lat, ts[i], alpha_t[i], alpha_prev[i], both)
            events[i + 1].record()
        img = pipe.vae.decode(lat)
        events[-1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = [events[i].elapsed_time(events[i + 1]) for i in range(n)]
        decode_ms = events[n].elapsed_time(events[-1])
        gen.manual_seed(7)
        again = pipe(cond, uncond, gen, SD_LATENT, SD_LATENT)
        torch.cuda.synchronize()
    step_ms = sum(steps) / n
    out = {"step_ms": step_ms, "step_ms_min": min(steps),
           "step_ms_max": max(steps), "decode_ms": decode_ms,
           "wall_s": wall, "s_per_image": wall / SD_PROMPTS,
           "flops_step": flops, "tflops": flops / step_ms / 1e9,
           "shape": tuple(img.shape)}
    up = 2 ** (len(pipe.vae.config.block_out_channels) - 1)   # 8 in SD
    ok = (tuple(img.shape) == (SD_PROMPTS, up * SD_LATENT, up * SD_LATENT, 3)
          and bool(torch.isfinite(img).all())
          and bool(torch.isfinite(lat).all()) and torch.equal(img, again))
    log(f"diffusion: (c) {n} DDIM steps at guidance {pipe.guidance_scale}, "
        f"{SD_PROMPTS} images {SD_LATENT} x {SD_LATENT} latents -> "
        f"{tuple(img.shape)} [{card}]: {step_ms:.2f} ms a step (CUDA "
        f"events; min {min(steps):.2f}, max {max(steps):.2f}), decode "
        f"{decode_ms:.2f} ms, {wall:.3f} s wall = "
        f"{out['s_per_image']:.3f} s an image; {flops:.4e} operations a "
        f"step (flop counter: "
        + ", ".join(f"{k} {v:.4e}" for k, v in sorted(by_op.items()))
        + f") = {out['tflops']:.2f} TFLOP/s, "
        f"{out['tflops'] * 1e12 / PEAK_OPS_PER_S[torch.float32]:.1%} of "
        f"the fp32 "
        f"peak (67 TFLOP/s, TF32 off); finite, the same seed twice bitwise "
        f"{torch.equal(img, again)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("diffusion: generation failed")
    return out, img


def _sd_timings(pipe, ctx: tuple, img, card: str, flush) -> dict:
    """6j (c): one UNet call with TF32 on (then set back), and the VAE
    encode of a 512 x 512 image, timed with CUDA events."""
    uncond, cond = ctx
    both = torch.cat([uncond, cond], dim=0)
    ts, _, _ = pipe.schedule.arrays("cuda")
    lat2 = torch.randn((2 * SD_PROMPTS, SD_LATENT, SD_LATENT, 4),
                       device="cuda", generator=torch.Generator(
                           device="cuda").manual_seed(5))
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    with torch.inference_mode():
        def unet():
            return pipe.unet.apply(lat2, ts[0], both)
        fp32_ms = cuda_ms(unet, 3, flush, warmup=1)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32_ms = cuda_ms(unet, 3, flush, warmup=1)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags
        encode_ms = cuda_ms(lambda: pipe.vae.encode(img[:1]), 3, flush,
                            warmup=1)
    back = flags == (False, False) == (
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32)
    log(f"diffusion: (c) one UNet call at batch {2 * SD_PROMPTS}: "
        f"{fp32_ms:.2f} ms fp32 (TF32 off), {tf32_ms:.2f} ms with "
        f"allow_tf32 on for cuBLAS and cuDNN (off before and set back: "
        f"{back}); VAE encode of one {tuple(img.shape[1:])} image "
        f"{encode_ms:.2f} "
        f"ms [{card}] {'ok' if back else 'FAIL'}")
    if not back:
        raise SystemExit("diffusion: TF32 was on before the timing")
    return {"unet_fp32_ms": fp32_ms, "unet_tf32_ms": tf32_ms,
            "vae_encode_ms": encode_ms}


def _sd_cpu_parity(unet, vae, ctx: tuple, card: str) -> dict:
    """6j (d): SD's full widths in fp32 on a 16 x 16 latent (128 x 128
    image), the card's weights on the cpu: one UNet call, the VAE encode
    and decode, and a 3-step pipeline from the same latents, each within
    SD_CPU_REL of the cpu's largest magnitude. The card's run again with
    TF32 on is the control: the check must catch it (one output or more
    outside the tolerance), or it could not tell a reduced-precision
    convolution or GEMM from fp32."""
    import copy

    from deepspeed_tpu_torch.inference.diffusion import (
        DDIMSchedule, StableDiffusionPipeline)

    t0 = time.perf_counter()
    # copies of the card's models (a seeded init of the UNet on the host
    # would draw 860M numbers there first)
    cpu = {key: copy.deepcopy(m).to("cpu", torch.float32)
           for key, m in (("unet", unet), ("vae", vae))}
    uncond, cond = (c[:1].float() for c in ctx)
    rng = np.random.default_rng(21)
    hw = SD_PARITY_LATENT
    up = 2 ** (len(vae.config.block_out_channels) - 1)    # 8 in SD
    lat = torch.from_numpy(rng.standard_normal((1, hw, hw, 4))
                           .astype(np.float32))
    image = torch.from_numpy(rng.uniform(-1, 1, (1, up * hw, up * hw, 3))
                             .astype(np.float32))
    t = torch.tensor([981, 1])
    sched = DDIMSchedule(num_inference_steps=SD_PARITY_STEPS)
    def run(dev: str) -> dict:
        u = unet if dev == "cuda" else cpu["unet"]
        v = vae if dev == "cuda" else cpu["vae"]
        pipe = StableDiffusionPipeline(u, v, sched, SD_GUIDANCE)
        with torch.inference_mode():
            ctx2 = torch.cat([uncond, cond]).to(dev)
            res = {"unet": u.apply(torch.cat([lat, lat]).to(dev), t.to(dev),
                                   ctx2),
                   "vae encode": v.encode(image.to(dev))[0],
                   "vae decode": v.decode(lat.to(dev)),
                   "3-step": pipe.denoise(lat.to(dev), cond.to(dev),
                                          uncond.to(dev))}
        return {k: x.float().cpu() for k, x in res.items()}

    ref, got = run("cpu"), run("cuda")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = run("cuda")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    del cpu
    scale = {k: float(r.abs().max()) for k, r in ref.items()}
    errs = {k: float((got[k] - r).abs().max()) for k, r in ref.items()}
    ctrl = {k: float((tf32[k] - r).abs().max()) for k, r in ref.items()}
    ok = all(bool(torch.isfinite(got[k]).all())
             and errs[k] <= SD_CPU_REL * scale[k] for k in ref)
    caught = any(ctrl[k] > SD_CPU_REL * scale[k] for k in ref)
    log(f"diffusion: (d) full widths in fp32 at {hw} x {hw} latents, cuda "
        f"vs cpu max abs err / max |cpu|: "
        + ", ".join(f"{k} {errs[k] / scale[k]:.3e} ({errs[k]:.3e} of "
                    f"{scale[k]:.3e})" for k in ref)
        + f" (tol {SD_CPU_REL}) {'ok' if ok else 'FAIL'}; control, the "
        f"card's with TF32 on: "
        + ", ".join(f"{k} {ctrl[k] / scale[k]:.3e}" for k in ref)
        + f" ({'caught' if caught else 'NOT caught: FAIL'}) [{card}] "
        f"({time.perf_counter() - t0:.1f} s)")
    if not ok:
        raise SystemExit("diffusion: cuda disagrees with cpu")
    if not caught:
        raise SystemExit("diffusion: the cuda-vs-cpu tolerance lets TF32 "
                         "through")
    return {k: (errs[k], scale[k], ctrl[k]) for k in ref}


def _sd_profile(pipe, ctx: tuple, card: str) -> dict:
    """6j (e): one denoise step under torch.profiler: device time by
    group, launches, and the device's idle share of the step's wall
    time (``_device_groups``)."""
    from torch.profiler import ProfilerActivity, profile

    uncond, cond = ctx
    both = torch.cat([uncond, cond], dim=0)
    ts, alpha_t, alpha_prev = pipe.schedule.arrays("cuda")
    lat = torch.randn((SD_PROMPTS, SD_LATENT, SD_LATENT, 4), device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(3))
    with torch.inference_mode():
        pipe.step(lat, ts[0], alpha_t[0], alpha_prev[0], both)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipe.step(lat, ts[0], alpha_t[0], alpha_prev[0], both)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    d = _device_groups(prof, SD_PROFILE_GROUPS, wall)
    if d["busy_us"] <= 0:
        log(f"diffusion: (e) torch.profiler recorded no device time "
            f"[{card}]: breakdown not measured")
        return {}
    # did cuDNN keep the channels_last layout (an NHWC-contiguous output)?
    from deepspeed_tpu_torch.models.diffusion import conv2d
    with torch.inference_mode():
        nhwc = conv2d(torch.cat([lat, lat]),
                      pipe.unet["conv_in"]).is_contiguous()
    _log_device_groups("diffusion: (e)", card, "one denoise step profiled",
                       wall, d, 10)
    log(f"diffusion: (e) conv outputs NHWC-contiguous {nhwc}")
    return {"wall_ms": wall * 1e3, "busy_ms": d["busy_us"] / 1e3,
            "launches": d["launches"], "idle_share": d["idle_share"],
            "groups_ms": {g: us / 1e3 for g, us in d["groups"].items()}}


class _BatchMLP(torch.nn.Module):
    """A foreign module for 6j (f): ``batch["x"]`` through Linear 256-512,
    GELU, Linear 512-16."""

    def __init__(self):
        super().__init__()
        self.net = torch.nn.Sequential(torch.nn.Linear(256, 512),
                                       torch.nn.GELU(),
                                       torch.nn.Linear(512, 16))

    def forward(self, batch):
        return self.net(batch["x"])


def _sd_from_module(card: str) -> list:
    """6j (f): a seeded two-layer MLP wrapped by ``from_module`` trains 3
    AdamW steps on one batch through ``initialize``, on the card and on
    the cpu in fp32 (TF32 off): the loss falls, cuda within 1e-5 of
    cpu."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.api import from_module

    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    cfg = {"train_batch_size": 64,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}

    def run(dev):
        torch.manual_seed(0)
        net = _BatchMLP().to(dev)
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=from_module(net, lambda out, b: torch.mean(
                torch.square(out - b["y"]))), config=cfg, device=dev)
        batch = {"x": x.to(dev), "y": y.to(dev)}
        return [float(eng.train_batch(batch)["loss"]) for _ in range(3)]

    card_run, cpu_run = run("cuda"), run("cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_run, cpu_run))
    ok = card_run[2] < card_run[0] and rel <= 1e-5
    log(f"diffusion: (f) from_module MLP 256-512-16, mean squared error, 3 "
        f"AdamW steps: cuda losses {card_run}, cpu {cpu_run}, max rel diff "
        f"{rel:.2e} (tol 1e-5) [{card}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("diffusion: from_module training failed")
    return card_run


def phase_diffusion(card: str) -> dict:
    """6j: Stable Diffusion 1.5 at full width on one card (UNet
    320/640/1280/1280, 2 layers a block, 8 heads, cross-attention 768;
    VAE 128/256/512/512; the CLIP ViT-L/14 text tower), seeded bf16
    weights, fp32 latents (the UNet computes in fp32, TF32 off): (a) the
    models and their parameter counts; (b) 2 prompts and 2 empty rows
    through the text tower, row 2's launches counted from 0; (c) 50 DDIM
    steps at guidance 7.5 on 64 x 64 latents and the decode to 512 x 512,
    timed, twice bitwise; a UNet call with TF32 on; the VAE encode; (d)
    cuda against cpu at full width on 16 x 16 latents; (e) one profiled
    denoise step; (f) ``from_module`` training."""
    from deepspeed_tpu_torch.inference.diffusion import (
        DDIMSchedule, StableDiffusionPipeline)

    t0 = time.perf_counter()
    log(f"diffusion: phase 6j predicted {SD_PREDICTED_S:.0f} s")
    unet, vae, clip, counts = _sd_models(card)
    states, launches = _sd_text(clip, card)
    del clip
    gc.collect()
    torch.cuda.empty_cache()
    ctx = (states[:SD_PROMPTS], states[SD_PROMPTS:])
    pipe = StableDiffusionPipeline(unet, vae, DDIMSchedule(), SD_GUIDANCE)
    torch.cuda.reset_peak_memory_stats()
    gen, img = _sd_generate(pipe, ctx, card)
    peak = torch.cuda.max_memory_allocated()
    log(f"diffusion: (c) max_memory_allocated over the generation {peak} B "
        f"[{card}]")
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    timings = _sd_timings(pipe, ctx, img, card, flush)
    del flush
    prof = _sd_profile(pipe, ctx, card)
    parity = _sd_cpu_parity(unet, vae, ctx, card)
    del pipe, unet, vae, img
    gc.collect()
    torch.cuda.empty_cache()
    losses = _sd_from_module(card)
    out = {"launches": launches[0], "wgmma_launches": launches[1],
           "params": counts, "peak": peak, **gen, **timings,
           "profile": prof, "cpu_parity": parity, "from_module": losses,
           "seconds": time.perf_counter() - t0}
    log(f"diffusion: phase 6j in {out['seconds']:.1f} s (predicted "
        f"{SD_PREDICTED_S:.0f} s)")
    return out


def _covered_us(spans: list) -> float:
    """The time (start us, end us, ...) spans in start order cover,
    overlaps counted once."""
    total, start, end = 0.0, None, None
    for s, e, *_ in spans:
        if end is None or s > end:
            total += 0.0 if end is None else end - start
            start, end = s, e
        else:
            end = max(end, e)
    return total + (0.0 if end is None else end - start)


def _device_groups(prof, groups, wall_s: float) -> dict:
    """A profile's device work, its CUDA kernels and memcpys, as distinct
    (start us, end us, name) spans: ``prof.events()`` can hold a span
    twice and spans can overlap, so summing durations (what
    ``key_averages``' ``self_device_time_total`` does) can exceed the
    wall. Returns ``busy_us``, the time the spans cover; ``idle_share``,
    1 - busy / ``wall_s``; ``launches``, the distinct spans; ``groups``,
    {group: us its spans cover}, a span in the first group whose keys its
    lower-cased name contains (``groups`` a dict of key tuples) or in
    ``groups(lower-cased name)`` (a callable), else "other"; ``by_name``,
    [(name, us summed over its spans, spans)], most time first; and
    ``events_us``, every event's duration summed as ``key_averages``
    sums it, printed beside ``busy_us`` only. A ``record_function``
    range (``gloo:recv``, ``gloo:send``) is mirrored onto the device
    timeline as a user annotation spanning the host's wait; it is not
    device work and is left out, as is any other name that also names a
    host op."""
    host, events = set(), []
    for e in prof.events():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            host.add(e.name)
        elif not getattr(e, "is_user_annotation", False):
            events.append(e)
    events = [e for e in events
              if e.name not in host and not e.name.startswith("gloo:")]
    spans = sorted({(e.time_range.start, e.time_range.end, e.name)
                    for e in events})
    if callable(groups):
        names, of = [], groups
    else:
        names = list(groups)

        def of(low: str) -> str:
            return next((g for g, keys in groups.items()
                         if any(k in low for k in keys)), "other")
    of_group: dict = {g: [] for g in names + ["other"]}
    by_name: dict = {}
    for sp in spans:
        of_group.setdefault(of(sp[2].lower()), []).append(sp)
        t, n = by_name.get(sp[2], (0.0, 0))
        by_name[sp[2]] = (t + sp[1] - sp[0], n + 1)
    busy = _covered_us(spans)
    return {"busy_us": busy,
            "idle_share": max(0.0, 1 - busy / 1e6 / wall_s),
            "launches": len(spans),
            "groups": {g: _covered_us(sp) for g, sp in of_group.items()},
            "by_name": sorted(((k, t, n) for k, (t, n) in by_name.items()),
                              key=lambda x: -x[1]),
            "events_us": sum(e.time_range.end - e.time_range.start
                             for e in events)}


def _log_device_groups(tag: str, card: str, what: str, wall_s: float,
                       d: dict, top: int) -> None:
    """One line of ``d`` (``_device_groups``) for ``what``, then its
    ``top`` kernels by time."""
    busy = d["busy_us"]
    log(f"{tag} [{card}]: {what}: wall {wall_s * 1e3:.3f} ms, "
        f"{d['launches']} kernel launches (distinct spans), device busy "
        f"{busy / 1e3:.3f} ms covered (events summed "
        f"{d['events_us'] / 1e3:.3f} ms), idle share "
        f"{d['idle_share']:.3f}; device time covered "
        + ", ".join(f"{g} {us / 1e3:.3f} ms ({us / busy:.1%})"
                    for g, us in d["groups"].items()))
    for name, us, n in d["by_name"][:top]:
        log(f"{tag}: {us / 1e3:9.3f} ms x{n:<6d} {name[:110]}")


def phase_inference(card: str) -> dict:
    """Path A: ``init_inference(Llama("7b"))`` at full width and depth
    (seeded random bf16 weights) with int8 weights at group 256, then bf16
    and int4 weights: 4 prompts of 128 tokens, 32 new tokens greedy. For
    int8 the quantize and dequantize counts are reset just before the
    engine is built and read after its last generate. Prints weight bytes,
    memory, prefill and decode times, tokens/s and dequantize launches per
    forward; profiles one int8 and one bf16 decode step. Returns the int8
    launches."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import Llama

    ids = np.random.default_rng(8).integers(1, 32000, (4, 128))
    logits, launches = {}, {}
    for mode in ("int8", "bf16", "int4"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if mode == "int8":
            for wrapper, *_ in QUANT_KERNELS.values():
                wrapper.launches = 0
        t0 = time.perf_counter()
        q0 = qk.quantize_blockwise.launches
        model = Llama("7b", dtype=torch.bfloat16, seed=0)
        bf16_bytes = sum(p.numel() * 2 for p in model.parameters())
        # every leaf but final_norm_w: 9 per layer, embedding and head
        n_wq = 9 * model.config.n_layers + 2
        cfg = {"dtype": "bfloat16", "temperature": 0.0}
        if mode != "bf16":
            cfg["quant"] = {"enabled": True, "bits": int(mode[3:]),
                            "group_size": 256}
        eng = deepspeed_tpu_torch.init_inference(model, cfg)
        torch.cuda.synchronize()
        built_s = time.perf_counter() - t0
        peak_build = torch.cuda.max_memory_allocated()
        held = torch.cuda.memory_allocated()
        n_quant = qk.quantize_blockwise.launches - q0
        torch.cuda.reset_peak_memory_stats()           # generate's own peak
        eng.generate(ids, max_new_tokens=2)            # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng.generate(ids, max_new_tokens=1)            # prefill + 1 token
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
        d0 = qk.dequantize_blockwise.launches
        t1 = time.perf_counter()
        out = eng.generate(ids, max_new_tokens=32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        per_fwd = (qk.dequantize_blockwise.launches - d0) / 32
        logits[mode] = eng.forward(ids[:1])[0, -1].cpu().numpy()
        if mode == "int8":
            launches = {n: w.launches for n, (w, *_) in QUANT_KERNELS.items()}
        decode_ms = (wall - prefill_s) / 31 * 1e3
        pb = eng.param_bytes()
        ok = (out.shape == (4, 160) and ((out >= 0) & (out < 32000)).all()
              and np.isfinite(logits[mode]).all()
              and per_fwd == (0 if mode == "bf16" else n_wq)
              and n_quant == (0 if mode == "bf16" else n_wq))
        log(f"inference {mode}: param_bytes {pb} ({pb / bf16_bytes:.4f} of "
            f"bf16 {bf16_bytes}), built in {built_s:.1f} s with {n_quant} "
            f"quantize launches; max_memory_allocated after build "
            f"{peak_build} B, allocated {held} B")
        log(f"inference {mode} [{card}]: 4 x 128-token prompts: prefill (+1 "
            f"token) {prefill_s * 1e3:.2f} ms; 32 new tokens in {wall:.4f} s "
            f"= {4 * 32 / wall:.1f} tokens/s, decode {decode_ms:.3f} ms per "
            f"step; {per_fwd:.0f} dequantize launches per forward; "
            f"max_memory_allocated during generate "
            f"{torch.cuda.max_memory_allocated()} B {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"path A {mode} failed")
        if mode != "int4":
            _profile_decode_step(eng, ids, card, mode)
        del eng, model
    for mode in ("int8", "int4"):
        a, b = logits[mode], logits["bf16"]
        cos = float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
        log(f"inference: last-token logits {mode} vs bf16 weights: cosine "
            f"{cos:.5f}, max_abs_err {np.abs(a - b).max():.3e} (max |bf16| "
            f"{np.abs(b).max():.3e}), same argmax {a.argmax() == b.argmax()}")
        if mode == "int8" and cos < 0.95:
            raise SystemExit("int8 weights moved the logits too far from "
                             "the bf16 weights' (cosine < 0.95)")
    if min(launches.values()) <= 0:
        raise SystemExit(f"path A launched no quantize/dequantize: "
                         f"{launches}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _profile_decode_step(eng, ids, card: str, mode: str) -> None:
    """One decode step under torch.profiler: device time by group and the
    device's idle share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        caches = eng._alloc_cache(ids.shape[0], ids.shape[1] + 1)
        tokens = torch.from_numpy(ids).cuda()
        logits, caches = eng._prefill(tokens, caches)
        nxt = logits.argmax(-1)
        eng._step_logits(nxt, caches, ids.shape[1])   # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng._step_logits(nxt, caches, ids.shape[1])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    d = _device_groups(
        prof, {"dequantize": ("dequantize",),
               "gemm": ("nvjet", "gemm", "xmma", "cutlass", "cublas")}, wall)
    if d["busy_us"] <= 0:
        log(f"inference profile {mode} [{card}]: torch.profiler recorded no "
            f"device time: breakdown not measured")
        return
    _log_device_groups(f"inference profile {mode}", card, "decode step",
                       wall, d, 6)


# ------------------------------------------------------- phase 3 (flash)
FLASH_CASES = [
    # label, b, sq, skv, hq, hkv, d, causal, window, dtype; bf16/fp16 at
    # d 64/128 run the tensor-core kernels, fp32 and d 256 the scalar ones;
    # 1b-bf16 is the training path's shape (TRAIN_SHAPE)
    ("1b-bf16", 4, 2048, 2048, 32, 4, 64, True, 0, torch.bfloat16),
    ("1b-fp16", 2, 2048, 2048, 32, 4, 64, True, 0, torch.float16),
    ("1b-fp32", 2, 2048, 2048, 32, 4, 64, True, 0, torch.float32),
    ("d128-mha-bf16", 1, 1024, 1024, 16, 16, 128, True, 0, torch.bfloat16),
    ("d128-gqa-fp16", 1, 1024, 1024, 16, 4, 128, True, 0, torch.float16),
    # 8d (c)'s shape (ZERO3_FLASH_SHAPE: Llama-2-7B's 32 heads of 128, a
    # rank's micro-batch), GQA group 8 and sq > skv at d 128
    ("llama7b-zero3-bf16", 1, 2048, 2048, 32, 32, 128, True, 0,
     torch.bfloat16),
    ("d128-gqa8-bf16", 1, 1024, 1024, 32, 4, 128, True, 0, torch.bfloat16),
    ("d128-sq517-skv333-bf16", 1, 517, 333, 8, 2, 128, True, 0,
     torch.bfloat16),
    ("d256-gqa-bf16", 1, 512, 512, 8, 2, 256, True, 0, torch.bfloat16),
    ("d256-gqa-fp32", 1, 512, 512, 8, 2, 256, True, 0, torch.float32),
    ("non-causal-bf16", 2, 512, 512, 8, 2, 64, False, 0, torch.bfloat16),
    ("sq256-skv1024-bf16", 1, 256, 1024, 8, 2, 64, True, 0, torch.bfloat16),
    ("sq256-skv1024-fp32", 1, 256, 1024, 8, 2, 64, True, 0, torch.float32),
    ("sq1024-skv256-bf16", 1, 1024, 256, 8, 2, 64, True, 0, torch.bfloat16),
    ("sq1024-skv256-fp32", 1, 1024, 256, 8, 2, 64, True, 0, torch.float32),
    ("odd-1000-bf16", 1, 1000, 1000, 8, 2, 64, True, 0, torch.bfloat16),
    ("sq333-skv517-window100-fp16", 1, 333, 517, 8, 2, 128, True, 100,
     torch.float16),
    ("window256-bf16", 1, 2048, 2048, 8, 2, 64, True, 256, torch.bfloat16),
    # phase 6h's encoder shapes: CLIP ViT-L/14's vision tower (257 = 1 +
    # 16^2, a ragged last key tile non-causal) and text tower (77), and
    # BERT-large at 512
    ("clip-vision-257-nc-bf16", 2, 257, 257, 16, 16, 64, False, 0,
     torch.bfloat16),
    ("nc-77-bf16", 2, 77, 77, 12, 12, 64, False, 0, torch.bfloat16),
    ("bert-large-512-nc-bf16", 2, 512, 512, 16, 16, 64, False, 0,
     torch.bfloat16),
    ("clip-text-77-causal-bf16", 2, 77, 77, 12, 12, 64, True, 0,
     torch.bfloat16),
]
TRAIN_SHAPE = dict(b=4, s=2048, hq=32, hkv=4, d=64)   # Llama("1b"), GAS 2
# 8d (c): Llama-2-7B's heads at a rank's micro-batch of 1 x 2048
ZERO3_FLASH_SHAPE = dict(b=1, s=2048, hq=32, hkv=32, d=128)
# cases run twice for bitwise-equal results: the training shape, and the
# d 128 backward at 8d (c)'s
FLASH_REPEAT = ("1b-bf16", "llama7b-zero3-bf16")
# the kernel each flash row takes at the training shape
FLASH_PATH = {"flash_forward": "wgmma: TMA ring of K/V tiles, 128 q rows "
                               "a block, m64n64k16",
              "flash_backward_dq": "wgmma: TMA ring of K/V tiles, 128 q rows "
                                   "a block, m64n64k16",
              "flash_backward_dkv": "wgmma: TMA ring of Q/dO tiles, 128 keys "
                                    "a block, m64n64k16"}


def _visible_pairs(b, sq, skv, hq, causal, window) -> int:
    """(query head, key) pairs the mask lets through, over the batch."""
    if not causal:
        return b * hq * sq * skv
    q_pos = np.arange(sq) + (skv - sq)
    hi = np.clip(q_pos + 1, 0, skv)
    lo = np.clip(q_pos - window + 1, 0, None) if window > 0 else 0
    return b * hq * int(np.clip(hi - lo, 0, None).sum())


def _flash_bounds(q, k, causal: bool) -> dict:
    """{kernel: (operations, bytes, bound ms, "operations" | "bytes")} of
    rows 2-4 on q [b, s, hq, d], k/v [b, s, hkv, d]: 4d, 6d, 8d
    operations a visible pair over the bf16 peak, or each input read
    once and each output written once over HBM's rate."""
    b, s, hq, d = q.shape
    pairs = _visible_pairs(b, s, s, hq, causal, 0)
    e = q.element_size()
    qb, kvb, rowb = q.numel() * e, k.numel() * e, b * hq * s * 4
    nbytes = {"flash_forward": 2 * qb + 2 * kvb + rowb,
              "flash_backward_dq": 3 * qb + 2 * kvb + 2 * rowb,
              "flash_backward_dkv": 2 * qb + 4 * kvb + 2 * rowb}
    out = {}
    for name, (_, _, per_pair) in FLASH_KERNELS.items():
        ops = float(per_pair) * d * pairs
        t_ops = ops / PEAK_OPS_PER_S[torch.bfloat16] * 1e3
        t_bytes = nbytes[name] / HBM_BYTES_PER_S * 1e3
        out[name] = (ops, nbytes[name], max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def _flash_inputs(gen, b, sq, skv, hq, hkv, d, dtype):
    """q, k, v, dO: seeded normal values in ``dtype`` on the card."""
    def mk(*shape):
        return torch.randn(shape, generator=gen).to(dtype).cuda()
    return mk(b, sq, hq, d), mk(b, skv, hkv, d), mk(b, skv, hkv, d), \
        mk(b, sq, hq, d)


def _flash_kernels(q, k, v, do, causal, window):
    """(out, lse, dq, dk, dv) through flash_attention_op: the forward
    kernel, then the dq and dk/dv kernels backward from ``do``."""
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    out, lse = fa.flash_attention_op(q, k, v, causal, None, window)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
    return out.detach(), lse, dq, dk, dv


def _flash_plain(q, k, v, do, causal, window):
    out, lse = fa.flash_attention_forward_reference(q, k, v, causal=causal,
                                                    window=window)
    dq, dk, dv = fa.flash_attention_backward_reference(
        q, k, v, out, lse, do, causal=causal, window=window)
    return out, lse, dq, dk, dv


def _flash_errors(got, ref, dtype) -> tuple:
    """(ok, {name: (max_abs_err, max |plain|)}, tolerance text). out:
    2e-5 abs (fp32) or 4e-3 abs + 1e-2 rel per element (bf16/fp16); lse
    (fp32 in every dtype): 1e-4 abs + 1e-5 rel; gradients: 1e-4 abs +
    1e-4 rel per element (fp32) or max error <= 1e-2 max |plain|."""
    ok, errs = True, {}
    for name, g, r in zip(("out", "lse", "dq", "dk", "dv"), got, ref):
        g, r = g.float(), r.float()
        err = (g - r).abs()
        errs[name] = (err.max().item(), r.abs().max().item())
        if name == "out" and dtype == torch.float32:
            ok &= errs[name][0] <= FP32_TOL
        elif name == "out":
            ok &= bool((err <= HALF_TOL[0] + HALF_TOL[1] * r.abs()).all())
        elif name == "lse":
            ok &= bool((err <= 1e-4 + 1e-5 * r.abs()).all())
        elif dtype == torch.float32:
            ok &= bool((err <= 1e-4 + 1e-4 * r.abs()).all())
        else:
            ok &= errs[name][0] <= GRAD_REL_TOL * errs[name][1]
        ok &= bool(torch.isfinite(g).all())
    tol = ("out 2e-5 abs, lse 1e-4 abs + 1e-5 rel, grads 1e-4 abs + 1e-4 rel"
           if dtype == torch.float32 else
           f"out {HALF_TOL[0]} abs + {HALF_TOL[1]} rel, lse 1e-4 abs + 1e-5 "
           f"rel, grads max err <= {GRAD_REL_TOL} max |plain|")
    return ok, errs, tol


def _flash_counts() -> list:
    """[forward launches, forward Hopper launches, dq, dq Hopper, dk/dv,
    dk/dv Hopper]."""
    return [fa.flash_forward.launches, fa.flash_forward.wgmma_launches,
            fa.flash_backward_dq.launches, fa.flash_backward_dq.wgmma_launches,
            fa.flash_backward_dkv.launches,
            fa.flash_backward_dkv.wgmma_launches]


def _flash_old_path(dtype, d) -> str:
    return "mma.sync" if dtype != torch.float32 and d <= 128 else "scalar"


def phase_flash_kernels() -> dict:
    """The three flash kernels (through flash_attention_op, backward
    from a fixed random dO) against their plain versions, the
    FLASH_REPEAT cases run twice for bitwise-equal gradients. Returns the
    worst max abs error of each kernel's outputs."""
    gen = torch.Generator().manual_seed(1)
    worst = {"flash_forward": 0.0, "flash_backward_dq": 0.0,
             "flash_backward_dkv": 0.0}
    for label, b, sq, skv, hq, hkv, d, causal, window, dtype in FLASH_CASES:
        q, k, v, do = _flash_inputs(gen, b, sq, skv, hq, hkv, d, dtype)
        hopper = fa.flash_wgmma_path(dtype, d, hq, hkv, tuple(
            t.data_ptr() for t in (q, k, v, do)))
        fwd_hopper = fa.flash_forward_wgmma_path(
            dtype, d, hq, hkv, tuple(t.data_ptr() for t in (q, k, v)),
            1.0 / math.sqrt(d))
        before = _flash_counts()
        got = _flash_kernels(q, k, v, do, causal, window)
        torch.cuda.synchronize()
        moved = [a - b_ for a, b_ in zip(_flash_counts(), before)]
        ref = _flash_plain(q, k, v, do, causal, window)
        ok, errs, tol = _flash_errors(got, ref, dtype)
        if sq > skv:     # rows before the first key see nothing: 0, 1e30
            ok &= bool((got[0][:, :sq - skv] == 0).all()
                       and (got[1][:, :, :sq - skv] == 1e30).all())
        # one forward, dq and dk/dv launch each, on the Hopper kernels
        # exactly when flash_forward_wgmma_path / flash_wgmma_path accept
        # the case
        path_ok = moved == [1, int(fwd_hopper), 1, int(hopper), 1,
                            int(hopper)]
        fpath = "Hopper TMA + wgmma" if fwd_hopper else \
            _flash_old_path(dtype, d)
        path = "Hopper TMA + wgmma" if hopper else _flash_old_path(dtype, d)
        log(f"flash: {label} " + " ".join(
            f"{n} {e:.2e}/{m:.2e}" for n, (e, m) in errs.items())
            + f" (max abs err / max |plain|; {tol}); forward on the {fpath} "
            f"kernel, backward on the {path} kernels (forward, forward "
            f"wgmma, dq, dq wgmma, dk/dv, dk/dv wgmma launches {moved}) "
            f"{'ok' if ok and path_ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"flash kernels disagree with their plain "
                             f"versions on {label}")
        if not path_ok:
            raise SystemExit(f"flash kernels of {label} did not take the "
                             f"paths flash_forward_wgmma_path and "
                             f"flash_wgmma_path name: {moved}")
        worst["flash_forward"] = max(worst["flash_forward"], errs["out"][0])
        worst["flash_backward_dq"] = max(worst["flash_backward_dq"],
                                         errs["dq"][0])
        worst["flash_backward_dkv"] = max(worst["flash_backward_dkv"],
                                          errs["dk"][0], errs["dv"][0])
        if label in FLASH_REPEAT:
            again = _flash_kernels(q, k, v, do, causal, window)
            same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
            log(f"flash: {label} run twice: out, lse, dq, dk, dv bitwise "
                f"equal: {same}")
            if not same:
                raise SystemExit("flash kernels are not bitwise repeatable")
        del got, ref, q, k, v, do
        torch.cuda.empty_cache()
    return worst


def phase_flash_timing(flush: torch.Tensor) -> dict:
    """Forward, dq and dk/dv at the training shape (TRAIN_SHAPE: b 4, s
    2048, hq 32, hkv 4, d 64) and at 8d (c)'s (ZERO3_FLASH_SHAPE: b 1, s
    2048, hq = hkv = 32, d 128), bf16, causal (:func:`_flash_timing_at`).
    Returns the training shape's readings, each kernel's with its reading
    at d 128 under "d128"."""
    res = _flash_timing_at(TRAIN_SHAPE, flush)
    d128 = _flash_timing_at(ZERO3_FLASH_SHAPE, flush)
    for name, r in res.items():
        r["d128"] = d128[name]
    return res


def _flash_timing_at(t: dict, flush: torch.Tensor) -> dict:
    """Forward, dq and dk/dv at shape ``t`` (bf16, causal), each timed
    with CUDA events after an L2 flush, in turns with the mma.sync kernel
    of the same function (the yardstick the Hopper kernel replaced),
    beside its bound, its plain version (one plain backward computes dq,
    dk and dv together) and scaled_dot_product_attention as the library
    yardstick (its backward = fwd+bwd - fwd; where hq = hkv also cuDNN's
    backward as the one aten call, :func:`_sdpa_backward`; never on the
    port's path)."""
    import torch.nn.functional as F

    b, s, hq, hkv, d = t["b"], t["s"], t["hq"], t["hkv"], t["d"]
    shape = f"b{b} s{s} hq{hq} hkv{hkv} d{d} bf16 causal"
    gen = torch.Generator().manual_seed(2)
    q, k, v, do = _flash_inputs(gen, b, s, s, hq, hkv, d, torch.bfloat16)
    out, lse = fa.flash_forward(q, k, v, causal=True)
    delta = fa._delta(out, do)
    kernels = {
        "flash_forward": lambda: fa.flash_forward(q, k, v, causal=True),
        "flash_backward_dq": lambda: fa.flash_backward_dq(
            q, k, v, do, lse, delta, causal=True),
        "flash_backward_dkv": lambda: fa.flash_backward_dkv(
            q, k, v, do, lse, delta, causal=True),
    }
    plain_fwd = lambda: fa.flash_attention_forward_reference(  # noqa: E731
        q, k, v, causal=True)
    plain_bwd = lambda: fa._backward_from_delta(  # noqa: E731
        q, k, v, lse, delta, do, True, None, 0)
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))

    def lib_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    def lib_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                           enable_gqa=True)
        return torch.autograd.grad(o, (qg, kg, vg), dot)

    # the mma.sync kernels that the Hopper ones replaced at this shape, on
    # the same inputs, called through the library
    lib = fa._library()
    args = fa._backward_args(q, k, v, do, lse, delta, True, None, 0)
    ptrs = tuple(x.data_ptr() for x in (q, k, v, do, lse, delta))
    dq_o, dk_o, dv_o = (torch.empty_like(x) for x in (q, k, v))

    def mma_dq():
        fa._raise_on(lib, lib.dst_flash_backward_dq(
            *ptrs, dq_o.data_ptr(), *args), "flash_backward_dq (mma.sync)")

    def mma_dkv():
        fa._raise_on(lib, lib.dst_flash_backward_dkv(
            *ptrs, dk_o.data_ptr(), dv_o.data_ptr(), *args),
            "flash_backward_dkv (mma.sync)")

    fwd_out, fwd_lse = torch.empty_like(q), torch.empty_like(lse)

    def mma_fwd():
        fa._raise_on(lib, lib.dst_flash_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), fwd_out.data_ptr(),
            fwd_lse.data_ptr(), *args), "flash_forward (mma.sync)")

    mma = {"flash_forward": mma_fwd, "flash_backward_dq": mma_dq,
           "flash_backward_dkv": mma_dkv}
    # plain, kernel, kernel, plain (and the replaced mma.sync kernels
    # around the Hopper ones): compare within one call, in turns
    before = _flash_counts()
    p_f1, p_b1 = cuda_ms(plain_fwd, 3, flush), cuda_ms(plain_bwd, 3, flush)
    mms = {n: [cuda_ms(fn, 10, flush)] for n, fn in mma.items()}
    kms = {n: [cuda_ms(fn, 10, flush), cuda_ms(fn, 10, flush)]
           for n, fn in kernels.items()}
    for n, fn in mma.items():
        mms[n].append(cuda_ms(fn, 10, flush))
    p_f2, p_b2 = cuda_ms(plain_fwd, 3, flush), cuda_ms(plain_bwd, 3, flush)
    moved = [a - b_ for a, b_ in zip(_flash_counts(), before)]
    if moved != [24] * 6:
        raise SystemExit(f"flash timing at {shape}: the timed calls were "
                         f"not all on the Hopper kernels: {moved}")
    lib_f = cuda_ms(lib_fwd, 10, flush)
    lib_b = cuda_ms(lib_fwd_bwd, 10, flush) - lib_f
    cudnn_b = cuda_ms(_sdpa_backward("CUDNN_ATTENTION", qt, kt, vt, dot,
                                     True), 10, flush) if hq == hkv else None

    res = {}
    for name, (ops, nbytes, bound, by) in _flash_bounds(q, k, True).items():
        fwd = name == "flash_forward"
        res[name] = {
            "ms": min(kms[name]),
            "plain_ms": min(p_f1, p_f2) if fwd else min(p_b1, p_b2),
            "bound_ms": bound, "bound_by": by,
            "library_ms": lib_f if fwd else lib_b,
            "ops": ops, "bytes": nbytes,
            "path": FLASH_PATH[name]}
        r = res[name]
        r["mma_ms"] = min(mms[name])
        r["tflops"] = ops / r["ms"] / 1e9
        if cudnn_b is not None and not fwd:
            r["cudnn_backward_ms"] = cudnn_b
        log(f"flash: {name} {shape}: kernel "
            f"{kms[name][0]:.4f}/{kms[name][1]:.4f} ms"
            + f" ({r['path']}; the mma.sync kernel "
            f"{mms[name][0]:.4f}/{mms[name][1]:.4f} ms, "
            f"{r['mma_ms'] / r['ms']:.2f}x the Hopper kernel's time)"
            + f", plain {(p_f1, p_f2) if fwd else (p_b1, p_b2)} ms"
            f"{'' if fwd else ' (the whole plain backward)'}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {r['ops']:.3e} ops, "
            f"{r['bytes']} B), sdpa {r['library_ms']:.4f} ms"
            f"{'' if fwd else ' (its whole backward)'}; "
            f"{r['tflops']:.1f} TFLOP/s")
    bwd = res["flash_backward_dq"]["ms"] + res["flash_backward_dkv"]["ms"]
    old = res["flash_backward_dq"]["mma_ms"] + \
        res["flash_backward_dkv"]["mma_ms"]
    log(f"flash: {shape}: backward dq + dk/dv {bwd:.4f} ms (the mma.sync "
        f"kernels {old:.4f} ms, {old / bwd:.2f}x), {bwd / lib_b:.2f}x SDPA's "
        f"whole backward ({lib_b:.4f} ms)"
        + ("" if cudnn_b is None else
           f", {bwd / cudnn_b:.2f}x cuDNN's backward as one aten call "
           f"({cudnn_b:.4f} ms)"))
    return res


# ---------------------------------------------------------------- phase 7
def phase_trainer_parity() -> None:
    """A 2-layer Llama("1b") in fp32, the same weights on cuda and cpu, seq
    256, micro-batch 2, GAS 2, one train_batch each
    (:func:`_trainer_parity`)."""
    toks = torch.from_numpy(
        np.random.default_rng(5).integers(0, 32000, (4, 256)))
    _trainer_parity("2-layer Llama-1b fp32, 4x256 tokens, GAS 2",
                    _parity_model(), {"input_ids": toks}, gas=2)


_PARITY_BASE: list = []


def _parity_model():
    """A copy of the 2-layer Llama("1b") in fp32 on the cpu, seed 2, that
    phases 7 and 8e hold cuda against: built once (~4 s on the host), each
    check trains its own copy."""
    import copy

    from deepspeed_tpu_torch.models.llama import Llama

    if not _PARITY_BASE:
        _PARITY_BASE.append(Llama("1b", device="cpu", seed=2, n_layers=2))
    return copy.deepcopy(_PARITY_BASE[0])


def _trainer_parity(label: str, cpu_model, batch: dict, gas: int,
                    optimizer: Optional[dict] = None) -> dict:
    """One ``train_batch`` of the same fp32 weights (``cpu_model`` and a
    copy of it on the card) on cuda and cpu, AdamW lr 1e-4 (or
    ``optimizer``'s block), clipping 1.0: loss within 1e-5 rel, grad norm
    within 1e-4 rel, and the updated weights within 1e-6 abs except where
    a gradient element lies within 100x of Adam's eps (1e-8): there the
    first step is lr * g / (|g| + eps) and carries g's summation noise,
    bounded by 2 lr (LAMB's step near its eps likewise)."""
    import copy

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime.optimizers import Transform

    t0 = time.perf_counter()
    optimizer = optimizer or {"type": "adamw",
                              "params": {"lr": 1e-4, "weight_decay": 0.1}}
    lr = optimizer["params"]["lr"]
    rows = next(iter(batch.values())).shape[0]
    cfg = {"train_batch_size": rows, "gradient_accumulation_steps": gas,
           "gradient_clipping": 1.0, "steps_per_print": 1000,
           "optimizer": optimizer}
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    out, small = {}, {}
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                 device=dev)
        if dev == "cpu":
            inner = eng.optimizer

            def update(grads, state, params, inner=inner):
                small.update({n: g.abs() < 1e-6 for n, g in grads.items()})
                return inner.update(grads, state, params)

            eng.optimizer = Transform(inner.init, update)
        m = eng.train_batch(batch)
        out[dev] = (float(m["loss"]), float(m["grad_norm"]), eng.params)
    torch.cuda.synchronize()
    (gl, gn, gp), (cl, cn, cp) = out["cuda"], out["cpu"]
    worst, worst_near_eps, n_out, n_all = 0.0, 0.0, 0, 0
    for name, w in cp.items():
        d = (gp[name].cpu() - w).abs()
        beyond = d > 1e-6
        n_out += int(beyond.sum())
        n_all += d.numel()
        worst = max(worst, d[~small[name]].max().item()
                    if (~small[name]).any() else 0.0)
        if beyond.any():
            worst_near_eps = max(worst_near_eps, d[beyond].max().item())
            if not bool(small[name][beyond].all()):
                raise SystemExit(f"trainer: {label}: {name} moved "
                                 f"differently on cuda and cpu where its "
                                 f"gradient is not near Adam's eps")
    ok = (abs(gl - cl) <= 1e-5 * abs(cl) and abs(gn - cn) <= 1e-4 * abs(cn)
          and worst <= 1e-6 and worst_near_eps <= 2 * lr
          and np.isfinite(gl) and np.isfinite(gn))
    log(f"trainer: {label}: loss cuda {gl:.7f} cpu {cl:.7f} (1e-5 rel), "
        f"grad_norm cuda {gn:.6f} cpu {cn:.6f} (1e-4 rel); updated weights "
        f"max |cuda - cpu| {worst:.2e} where |g| >= 1e-6 (tol 1e-6), "
        f"{n_out} of {n_all} elements beyond 1e-6, all with |g| < 1e-6, "
        f"max {worst_near_eps!r} (<= 2 lr) {'ok' if ok else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not ok:
        raise SystemExit(f"trainer on cuda disagrees with cpu: {label}")
    del cpu_model, gpu_model, out, eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss_rel": abs(gl - cl) / abs(cl),
            "grad_norm_rel": abs(gn - cn) / abs(cn), "weights": worst,
            "near_eps": n_out}


# ---------------------------------------------------------------- phase 8
def phase_training(card: str):
    """Llama("1b") at full width and depth (22 layers, 1.1e9 parameters,
    seeded random fp32 master weights), bf16 compute, full remat, GAS 2 of
    4 x 2048 tokens, AdamW, clipping: 2 warm-up steps, then 4 timed steps
    with the flash launch counts reset just before and read just after;
    every forward, dq and dk/dv launch must be on the Hopper kernels."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import Llama

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Llama("1b", seed=0)
    c = model.config
    n_params = sum(p.numel() for p in model.parameters())
    cfg = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
           "gradient_clipping": 1.0, "steps_per_print": 1000,
           "bf16": {"enabled": True},
           "optimizer": {"type": "adamw",
                         "params": {"lr": 1e-4, "weight_decay": 0.1}}}
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, c.vocab_size, (8, 2048))).cuda()
    batch = {"input_ids": toks}
    torch.cuda.synchronize()
    log(f"training: Llama-1b {n_params} params ({c.n_layers} layers, "
        f"d_model {c.d_model}, {c.n_heads}/{c.n_kv_heads} heads), bf16 "
        f"compute, fp32 masters + AdamW, remat {c.remat_policy}, GAS "
        f"{engine.gradient_accumulation_steps} x {toks.shape[0] // 2} x "
        f"{toks.shape[1]} tokens; built in {time.perf_counter() - t0:.1f} s")
    losses, norms, skipped, times = [], [], [], []

    def step():
        t1 = time.perf_counter()
        m = engine.train_batch(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        skipped.append(bool(m["skipped"]))

    for _ in range(2):
        step()
    _flash_reset()
    for _ in range(4):
        step()
    launches, hopper = _flash_read()
    per_step = {"flash_forward": c.n_layers * 2 * 2,     # fwd + replay, GAS
                "flash_backward_dq": c.n_layers * 2,
                "flash_backward_dkv": c.n_layers * 2}
    step_s = sum(times[2:]) / 4                          # all four timed
    tok_s = toks.shape[0] * (toks.shape[1] - 1) / step_s
    mfu = tok_s * c.flops_per_token(toks.shape[1]) / PEAK_OPS_PER_S[
        torch.bfloat16]
    peak = torch.cuda.max_memory_allocated()
    ok = (all(np.isfinite(losses)) and all(np.isfinite(norms))
          and not any(skipped) and losses[-1] < losses[0]
          and all(launches[n] == 4 * per_step[n] for n in launches)
          and all(hopper[n] == launches[n] for n in hopper))
    log(f"training: losses {[round(x, 5) for x in losses]}, grad norms "
        f"{[round(x, 4) for x in norms]}, skipped {skipped}")
    log(f"training: flash launches in 4 timed steps {launches} (per step "
        f"{per_step}: {c.n_layers} layers x forward + remat replay x GAS 2); "
        f"on the Hopper kernels {hopper} (all of them: "
        f"{all(hopper[n] == launches[n] for n in hopper)})")
    log(f"training [{card}]: step times {[round(x, 4) for x in times]} s; "
        f"timed step (mean of four) {step_s:.4f} s, "
        f"{tok_s:.1f} tokens/s, MFU {mfu:.4f} (flops_per_token(2048) = "
        f"{c.flops_per_token(toks.shape[1]):.4e}, peak 989 TFLOP/s bf16)")
    log(f"training [{card}]: torch.cuda.max_memory_allocated() = {peak} B")
    if not ok:
        raise SystemExit("training phase failed")
    return engine, batch, launches, hopper


# ---------------------------------------------------------------- phase 9
def phase_training_profile(engine, batch, card: str,
                           label: str = "train") -> None:
    """One more training step under torch.profiler: device time by group
    and the device's idle share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_batch(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    d = _device_groups(
        prof, {"flash_forward": ("flash_forward",),
               "flash_dq": ("flash_backward_dq",),
               "flash_dkv": ("flash_backward_dkv",),
               "gemm": ("nvjet", "gemm", "xmma", "cutlass", "cublas")}, wall)
    if d["busy_us"] <= 0:
        log(f"{label} profile [{card}]: torch.profiler recorded no device "
            f"time: breakdown not measured")
        return
    _log_device_groups(f"{label} profile", card, "profiled step", wall, d, 8)


# --------------------------------------------------------------- phase 8e
REMAT_POLICIES = ("full", "selective", "selective_flash",
                  "dots_with_no_batch_dims", "nothing")
REMAT_REPLAYED = ("full", "selective", "dots_with_no_batch_dims")
REST_OPT_LAYERS = 4            # (d): TinyLlama-1.1B's 22 layers cut (time)
REST_OPTIMIZERS = {"sgd": {"lr": 1e-2, "momentum": 0.9,
                           "weight_decay": 0.01},
                   "lamb": {"lr": 1e-3, "weight_decay": 0.01},
                   "lion": {"lr": 1e-4, "weight_decay": 0.1},
                   "adagrad": {"lr": 1e-3, "weight_decay": 0.01}}
REST_PARITY_ROWS = (2, 128)    # (d), (f): rows x tokens, cuda vs cpu fp32
REST_SEQ = 2048                # (d), (g): tokens a row, as phase 8
REST_COMPRESSION = {"compression_training": {
    "weight_quantization": {
        "shared_parameters": {"enabled": True, "schedule_offset": 0},
        "different_groups": {"wq": {"params": {"target_bits": 8},
                                    "modules": ["layers"]}}},
    "sparse_pruning": {
        "shared_parameters": {"enabled": True, "schedule_offset": 0},
        "different_groups": {"sp": {"params": {"dense_ratio": 0.5},
                                    "modules": ["w_up", "w_down"]}}}}}
REST_PREDICTED_S = 60.0        # stated in PERF.md before the first run


def _rest_state(engine) -> dict:
    """A copy on the card of what a step changes: the masters, the
    optimizer's trees and scalars, the random stream and the counters."""
    with torch.no_grad():
        return {"params": {n: p.clone() for n, p in engine.params.items()},
                "trees": {k: {n: t.clone() for n, t in v.items()}
                          for k, v in engine._opt_trees().items()},
                "opt": engine.opt_state, "rng": engine.rng.get_state(),
                "steps": (engine.global_steps, engine.micro_steps,
                          engine.skipped_steps)}


@torch.no_grad()
def _rest_restore(engine, state: dict) -> None:
    for n, p in engine.params.items():
        p.copy_(state["params"][n])
    trees = engine._opt_trees()
    for k, v in state["trees"].items():
        for n, t in v.items():
            trees[k][n].copy_(t)
    engine.opt_state = state["opt"]._replace(**trees)
    engine.rng.set_state(state["rng"])
    engine.global_steps, engine.micro_steps, engine.skipped_steps = \
        state["steps"]
    engine.tput.step_count = engine.global_steps


def _masters(engine) -> dict:
    with torch.no_grad():
        return {n: p.clone() for n, p in engine.params.items()}


def _same(a: dict, b: dict) -> bool:
    return all(torch.equal(a[n], b[n]) for n in a)


def _rest_policies(engine, batch, state, card: str) -> tuple:
    """(a): one step from ``state`` under each remat policy (the model's
    ``remat_policy``): loss and grad norm bitwise ``full``'s, rows 2-4's
    launches as the policy saves or replays the forward, all on the
    Hopper kernels; peak memory, step time, tokens/s. Each policy's timed
    step follows an untimed one from the same state: the first step
    after a change of footprint waits on the allocator's new blocks."""
    c = engine.model.config
    rows, seq = batch["input_ids"].shape
    gas = engine.gradient_accumulation_steps
    ok, launches, wgmma, ref = True, {}, {}, None
    for policy in REMAT_POLICIES:
        c.remat_policy = policy
        _rest_restore(engine, state)
        engine.train_batch(batch)
        _rest_restore(engine, state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _flash_reset()
        t0 = time.perf_counter()
        m = engine.train_batch(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n, h = _flash_read()
        fwd = (2 if policy in REMAT_REPLAYED else 1) * c.n_layers * gas
        want = {"flash_forward": fwd, "flash_backward_dq": c.n_layers * gas,
                "flash_backward_dkv": c.n_layers * gas}
        if ref is None:
            ref = (m["loss"], m["grad_norm"])
        same = torch.equal(m["loss"], ref[0]) and torch.equal(
            m["grad_norm"], ref[1])
        good = same and n == want and h == n and not m["skipped"]
        ok = ok and good
        launches[policy], wgmma[policy] = n, h
        log(f"trainer rest (a) [{card}]: remat {policy}: loss "
            f"{m['loss'].item()!r} grad norm {m['grad_norm'].item()!r} "
            f"(bitwise full's: {same}); flash launches {n} (expected "
            f"{want}), on the Hopper kernels {h}; step {dt:.4f} s, "
            f"{rows * (seq - 1) / dt:.1f} tokens/s, peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
            f"{'ok' if good else 'FAIL'}")
    c.remat_policy = "full"
    return ok, launches, wgmma


def _rest_compat(engine, batches, state, card: str) -> bool:
    """(b): two steps through ``forward`` / ``backward`` / ``step``
    against two ``train_batch`` steps from ``state``: the mean of each
    step's micro-batch losses and the masters bitwise."""
    gas = engine.gradient_accumulation_steps
    _rest_restore(engine, state)
    ref = [engine.train_batch(b)["loss"] for b in batches]
    ref_masters = _masters(engine)
    _rest_restore(engine, state)
    got, evals = [], []
    for b in batches:
        n = b["input_ids"].shape[0] // gas
        mbs = [{k: v[i * n:(i + 1) * n] for k, v in b.items()}
               for i in range(gas)]
        evals.append(engine.forward(mbs[0]))
        losses = []
        for mb in mbs:
            losses.append(engine.backward(mb))
            engine.step()
        got.append(sum(losses[1:], losses[0]) * (1.0 / gas))
    torch.cuda.synchronize()
    same_loss = all(torch.equal(a, r) for a, r in zip(got, ref))
    same = _same(ref_masters, engine.params)
    ok = (same_loss and same and engine.global_steps == state["steps"][0]
          + len(batches) and all(bool(torch.isfinite(e)) for e in evals))
    del ref_masters
    log(f"trainer rest (b) [{card}]: 2 steps through forward / backward / "
        f"step against 2 train_batch steps: losses {[x.item() for x in got]}"
        f" bitwise {same_loss}, masters bitwise {same}; forward (an "
        f"evaluation) {[round(e.item(), 5) for e in evals]} "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def _rest_steps(engine, batches, state, card: str) -> bool:
    """(c): ``train_steps`` over 4 batches against 4 ``train_batch``
    calls from ``state``: losses, grad norms and masters bitwise,
    tokens/s both ways; then the per-step fallback with a step hook."""
    rows, seq = batches[0]["input_ids"].shape
    _rest_restore(engine, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per = [engine.train_batch(b) for b in batches]
    torch.cuda.synchronize()
    t_per = time.perf_counter() - t0
    ref_masters = _masters(engine)
    _rest_restore(engine, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.train_steps(batches)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    k = len(batches)
    same = (torch.equal(out["losses"], torch.stack([m["loss"] for m in per]))
            and torch.equal(out["grad_norms"],
                            torch.stack([m["grad_norm"] for m in per]))
            and _same(ref_masters, engine.params))
    del ref_masters
    calls = []
    engine.register_step_hook(lambda _e, step: calls.append(step))
    before = engine.global_steps
    fell = engine.train_steps(batches[:2])
    engine._step_hooks.clear()
    fallback = (calls == [before, before + 1] and len(fell["losses"]) == 2
                and "per-step hooks registered"
                in engine._steps_fallback_logged)
    ok = same and fallback
    log(f"trainer rest (c) [{card}]: train_steps({k}) against {k} "
        f"train_batch calls: losses, grad norms and masters bitwise {same};"
        f" {k * rows * (seq - 1) / t_per:.1f} tokens/s per step, "
        f"{k * rows * (seq - 1) / t_k:.1f} tokens/s as one train_steps "
        f"({t_per:.4f} s vs {t_k:.4f} s); with a step hook it ran "
        f"{len(calls)} per-step calls (fallback logged: {fallback}) "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def _rest_cfg(rows: int, gas: int, optimizer: dict, **extra) -> dict:
    return {"train_batch_size": rows, "gradient_accumulation_steps": gas,
            "gradient_clipping": 1.0, "steps_per_print": 1000,
            "bf16": {"enabled": True}, "optimizer": optimizer, **extra}


def _rest_optimizers(card: str) -> tuple:
    """(d): sgd, lamb, lion and adagrad at full width and 4 of 22
    layers, 2 steps each from the same seeded weights: finite, not
    skipped (LAMB at 2 layers in fp32, cuda against cpu, is
    :func:`_rest_parity`). Returns (ok, the 4-layer model for (g))."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import Llama

    model = Llama("1b", seed=0, n_layers=REST_OPT_LAYERS)
    init = _masters_of(model)
    batch = {"input_ids": torch.from_numpy(np.random.default_rng(8).integers(
        0, TRAIN_SPAN, (8, REST_SEQ))).cuda()}
    ok = True
    for name, params in REST_OPTIMIZERS.items():
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(init[n])
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=model, config=_rest_cfg(8, 2, {"type": name,
                                                 "params": params}))
        t0 = time.perf_counter()
        ms = [engine.train_batch(batch) for _ in range(2)]
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 2
        losses = [m["loss"].item() for m in ms]
        norms = [m["grad_norm"].item() for m in ms]
        good = (all(np.isfinite(losses + norms))
                and not any(m["skipped"] for m in ms))
        ok = ok and good
        log(f"trainer rest (d) [{card}]: {name} {params} at {REST_OPT_LAYERS}"
            f" layers: losses {losses}, grad norms {norms}, "
            f"{dt:.4f} s a step {'ok' if good else 'FAIL'}")
        del engine, ms
        gc.collect()
        torch.cuda.empty_cache()
    return ok, model


def _rest_parity() -> None:
    """(d)'s 2-layer fp32 cuda-against-cpu check, phase 7's, on LAMB (the
    rule whose update reads whole-leaf norms). The other rules' cuda
    against cpu are ``tests/test_torch_optimizers.py``'s ``gpu`` case; a
    CPU reference of this model takes ~7 s of the host a rule."""
    rows, seq = REST_PARITY_ROWS
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, 32000, (rows, seq)))
    _trainer_parity(f"2-layer Llama-1b fp32 lamb, {rows}x{seq} tokens",
                    _parity_model(), {"input_ids": toks}, gas=1,
                    optimizer={"type": "lamb",
                               "params": REST_OPTIMIZERS["lamb"]})


def _masters_of(model) -> dict:
    with torch.no_grad():
        return {n: p.clone() for n, p in model.named_parameters()}


def _rest_telemetry(engine, batch, card: str, tmp: str) -> bool:
    """(e): an engine over the same model with telemetry and the CSV
    monitor on: every record valid, the monitor's rows written, the
    record's MFU beside the analytic MFU, the step time with telemetry on
    against the plain engine's."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.telemetry import validate_step_record

    c = engine.model.config
    rows, seq = batch["input_ids"].shape
    logger_on = comm.get_comms_logger().enabled
    times = {}
    for label, eng in (("off", engine), ("on", None)):
        if eng is None:
            eng, *_ = deepspeed_tpu_torch.initialize(
                model=engine.model, config=_rest_cfg(
                    rows, engine.gradient_accumulation_steps,
                    {"type": "adamw", "params": {"lr": 1e-4,
                                                 "weight_decay": 0.1}},
                    telemetry={"enabled": True,
                               "output_dir": os.path.join(tmp, "tel")},
                    csv_monitor={"enabled": True, "output_path": tmp,
                                 "job_name": "8e"}))
            eng.train_batch(batch)        # counts the step's operations
        else:
            eng.train_batch(batch)        # after (d): the allocator's blocks
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            eng.train_batch(batch)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        times[label] = sum(ts) / len(ts)
    eng.close()
    comm.configure_comms_logger(logger_on)
    with open(os.path.join(tmp, "tel", "steps.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    with open(os.path.join(tmp, "8e", "Train_loss.csv")) as f:
        csv_rows = f.read().splitlines()
    bad = [validate_step_record(r) for r in recs if validate_step_record(r)]
    analytic = rows * (seq - 1) * c.flops_per_token(seq)
    rec = recs[-1]
    mfu_analytic = analytic / rec["wall_time_s"] / PEAK_OPS_PER_S[
        torch.bfloat16]
    ok = (len(recs) == 4 and not bad and len(csv_rows) == 5
          and rec["mfu"] > 0 and rec["memory"].get("hbm_peak_gb", 0) > 0)
    log(f"trainer rest (e) [{card}]: telemetry + CSV monitor: {len(recs)} "
        f"step records, all valid ({bad or 'no violations'}), "
        f"Train_loss.csv {len(csv_rows) - 1} rows; last record: wall "
        f"{rec['wall_time_s']:.4f} s, {rec['tokens_per_s']:.1f} tokens/s, "
        f"MFU {rec['mfu']:.4f} from the counted {eng._step_flops:.4e} "
        f"operations a step beside the analytic {mfu_analytic:.4f} "
        f"(flops_per_token: {analytic:.4e}; the count is "
        f"{eng._step_flops / analytic:.4f}x it: the remat replay's forward "
        f"and the attention as run), peak {rec['memory']['hbm_peak_gb']} "
        f"GB; step time telemetry on {times['on']:.4f} s, off "
        f"{times['off']:.4f} s ({times['on'] / times['off'] - 1:+.2%}) "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def _rest_compression(card: str) -> bool:
    """(f): QAT on the layers' matrices (the embedding and the head, 60 % of
    the weights, stay fp32: their fake quantization on the host's CPU was
    the phase's longest part) plus sparse pruning of the MLP (dense
    0.5), 3 fp32 steps of a 2-layer Llama-1b on cuda and on cpu from the
    same weights: the same masks, the first step's loss within 1e-5 and
    the next two within 1e-4 (from step 2 the weights differ by rounding,
    and QAT can put a weight a quantization level apart on the two
    devices, as phase 10's compressed runs; Adam's near-eps elements move
    by up to 2 lr), and ``redundancy_clean`` baking the same zeros."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.compression import (init_compression,
                                                 redundancy_clean)
    from deepspeed_tpu_torch.models.llama import Llama

    t0 = time.perf_counter()
    rows, seq = REST_PARITY_ROWS
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, 32000, (rows, seq)))
    cpu_model = _parity_model()
    cfg = {"train_batch_size": rows, "steps_per_print": 1000,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-4}}}
    out = {}
    for dev in ("cuda", "cpu"):
        model = _copy_model(cpu_model, dev)
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                    device=dev)
        comp = init_compression(engine, REST_COMPRESSION)
        losses = [engine.train_batch({"input_ids": toks})["loss"].item()
                  for _ in range(3)]
        clean = redundancy_clean(engine, REST_COMPRESSION, compressor=comp)
        zeros = {n: (t == 0).cpu() for n, t in clean.items()
                 if "w_up" in n or "w_down" in n}
        out[dev] = (losses, comp.masks, zeros)
        del engine, model, clean
    (gl, gm, gz), (cl, cm, cz) = out["cuda"], out["cpu"]
    same_masks = set(gm) == set(cm) and all(np.array_equal(gm[k], cm[k])
                                            for k in gm)
    rels = [abs(a - b) / abs(b) for a, b in zip(gl, cl)]
    density = float(np.mean([m.mean() for m in gm.values()]))
    # the stack's threshold keeps half of its elements (and its ties):
    # each layer's leaf keeps about half (JAX's test: > 0.4 zeros)
    baked = all(torch.equal(gz[n], cz[n]) for n in cz) and all(
        float(z.float().mean()) > 0.4 for z in gz.values())
    ok = (same_masks and rels[0] <= 1e-5 and max(rels[1:]) <= 1e-4
          and baked and all(np.isfinite(gl)))
    log(f"trainer rest (f) [{card}]: compression (QAT int8 on the layers, "
        f"sparse MLP masks dense 0.5) on a 2-layer Llama-1b fp32, "
        f"{rows}x{seq} tokens: losses cuda {gl} cpu {cl} (rel "
        f"{[f'{r:.2e}' for r in rels]}, tol 1e-5 at step 1, 1e-4 after); "
        f"masks equal {same_masks} ({len(gm)} stacked "
        f"leaves, density {density:.3f}); redundancy_clean's zeros equal "
        f"and > 0.4 a leaf: {baked} ({time.perf_counter() - t0:.1f} s) "
        f"{'ok' if ok else 'FAIL'}")
    del cpu_model
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def _copy_model(model, device: str):
    """``model`` itself on the cpu, a copy of it on the card."""
    import copy

    return copy.deepcopy(model).to(device) if device != "cpu" else model


def _rest_warmup(model, card: str) -> bool:
    """(g): ``warmup_async`` on a fresh engine over (d)'s 4-layer model
    returns True, and the first step joins it."""
    import deepspeed_tpu_torch

    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=_rest_cfg(8, 2, {"type": "adamw",
                                             "params": {"lr": 1e-4}}))
    batch = {"input_ids": torch.from_numpy(np.random.default_rng(11)
                                           .integers(0, TRAIN_SPAN,
                                                     (8, REST_SEQ))).cuda()}
    t0 = time.perf_counter()
    thread = engine.warmup_async(batch)
    started = time.perf_counter() - t0
    _flash_reset()
    m = engine.train_batch(batch)
    torch.cuda.synchronize()
    n, h = _flash_read()
    ok = (engine.warmed_up is True and not thread.is_alive()
          and engine._warmup_thread is None and bool(torch.isfinite(
              m["loss"])) and h == n and n["flash_forward"] > 0)
    log(f"trainer rest (g) [{card}]: warmup_async returned in "
        f"{started * 1e3:.2f} ms, its result {engine.warmed_up} (the "
        f"libraries {engine._step_libraries()} loaded), joined by the first"
        f" step (thread alive: {thread.is_alive()}); that step's flash "
        f"launches {n}, on the Hopper kernels {h} {'ok' if ok else 'FAIL'}")
    del engine
    return ok


def phase_trainer_rest(engine, batch, card: str) -> dict:
    """8e: the trainer's rest on phase 8's TinyLlama-1.1B engine (22
    layers, bf16 on fp32 masters, 4 x 2048 at GAS 2): (a) every remat
    policy, (b) the micro-step API, (c) ``train_steps``, from one saved
    state; (d) the other optimizers at 4 layers and LAMB at 2 layers
    fp32 cuda against cpu; (e) step telemetry and the CSV monitor; (f)
    compression cuda against cpu; (g) ``warmup_async``."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    batches = [batch] + [{"input_ids": torch.from_numpy(rng.integers(
        0, engine.model.config.vocab_size, tuple(batch["input_ids"].shape)))
        .cuda()} for _ in range(3)]
    marks = {}

    def mark(part: str) -> None:
        marks[part] = time.perf_counter() - t0 - sum(marks.values())

    state = _rest_state(engine)
    ok, launches, wgmma = _rest_policies(engine, batch, state, card)
    mark("a")
    ok &= _rest_compat(engine, batches[:2], state, card)
    mark("b")
    ok &= _rest_steps(engine, batches, state, card)
    mark("c")
    _rest_restore(engine, state)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    good, model4 = _rest_optimizers(card)
    ok &= good
    mark("d")
    _rest_parity()
    mark("d: cuda vs cpu")
    tmp = tempfile.mkdtemp(prefix="dst_8e_")
    try:
        ok &= _rest_telemetry(engine, batch, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    mark("e")
    ok &= _rest_compression(card)
    mark("f")
    ok &= _rest_warmup(model4, card)
    del model4
    gc.collect()
    torch.cuda.empty_cache()
    mark("g")
    seconds = time.perf_counter() - t0
    log(f"trainer rest: phase 8e in {seconds:.1f} s (predicted "
        f"{REST_PREDICTED_S:g} s): "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in marks.items()))
    if not ok:
        raise SystemExit("phase 8e: the trainer's rest failed")
    return {"launches": launches, "wgmma_launches": wgmma,
            "seconds": seconds}


# --------------------------------------------------------------- phase 8b
TRAIN_LR = 1e-4
TRAIN_WARM, TRAIN_TIMED = 2, 3
TRAIN_SPAN = 1024              # ids drawn from 1024 of the vocab: a unigram
#                                that five steps can start to learn
TRAIN_SHAPES = {               # rows x tokens a step, GAS
    "gpt2": (16, 1024, 2), "opt": (8, 512, 1), "bert": (32, 512, 2),
    "clip": (64, 77, 1), "moe": (4, 1024, 1)}
TRAIN_DATASETS = {"gpt2": 64, "opt": 40}   # (a), (b): sequences loaded
TRAIN_MOE = dict(n_experts=128, n_layers=2)    # (e): depth cut from 24
TRAIN_CUT_LAYERS = 12          # (b), (c): OPT-1.3B's and BERT-large's 24
#                                layers cut for the time limit
TRAIN_PARITY_MOE = dict(n_experts=32, n_layers=1)   # (f): 6i (d)'s at 1
#                                                     layer (2 until PR 24)
TRAIN_PARITY_ROWS = (4, 128)   # (f): rows x tokens of each family's batch
# row 2-4 at each family's micro-batch: label, b, s, heads, causal
TRAIN_FLASH_SHAPES = [("gpt2", 8, 1024, 12, True), ("opt", 8, 512, 32, True),
                      ("bert", 16, 512, 16, False),
                      ("clip_vision", 64, 257, 16, False),
                      ("clip_text", 64, 77, 12, True),
                      ("moe", 4, 1024, 16, True)]


def _train_cfg(rows: int, gas: int, seed: int = 0, **extra) -> dict:
    return {"train_batch_size": rows, "gradient_accumulation_steps": gas,
            "gradient_clipping": 1.0, "steps_per_print": 1000,
            "bf16": {"enabled": True}, "seed": seed,
            "optimizer": {"type": "adamw",
                          "params": {"lr": TRAIN_LR, "weight_decay": 0.1}},
            **extra}


def _flash_reset() -> None:
    for wrapper, *_ in FLASH_KERNELS.values():
        wrapper.launches = 0
        wrapper.wgmma_launches = 0


def _flash_read() -> tuple:
    return ({n: w.launches for n, (w, *_) in FLASH_KERNELS.items()},
            {n: w.wgmma_launches for n, (w, *_) in FLASH_KERNELS.items()})


def _flash_per_step(towers, gas: int) -> dict:
    """Flash launches a step, from the code: each layer of each tower
    calls ``flash_attention`` once a micro-batch (every config here takes
    it: ``use_flash``, no ALiBi, no padding mask, no varying windows),
    and once more in the backward pass when ``remat`` replays it; the
    backward runs dq and dk/dv once a layer."""
    fwd = bwd = 0
    for c in towers:
        if not c.use_flash or c.position == "alibi" or (
                c.attn_windows and len(set(c.attn_windows)) > 1):
            raise SystemExit(f"phase 8b: a tower that leaves the flash "
                             f"path: {c}")
        fwd += c.n_layers * (2 if c.remat else 1)
        bwd += c.n_layers
    return {"flash_forward": fwd * gas, "flash_backward_dq": bwd * gas,
            "flash_backward_dkv": bwd * gas}


def _train_timed(label: str, engine, batches, towers, gas: int,
                 work: float, unit: str, flops: float, card: str,
                 on_step=None) -> dict:
    """TRAIN_WARM warm-up steps, then TRAIN_TIMED timed ones with the
    flash counters reset just before and read just after. ``work`` is
    the tokens (or samples) a step, ``flops`` the model's operations a
    step. Correct: finite losses and norms, no skipped step, the last
    loss below the first, and every flash launch of the timed steps on
    the Hopper kernels in the count :func:`_flash_per_step` gives. Then
    one more step on the last batch under the profiler."""
    losses, norms, skipped, times = [], [], [], []
    for i in range(TRAIN_WARM + TRAIN_TIMED):
        if i == TRAIN_WARM:
            _flash_reset()
        batch = next(batches)
        t1 = time.perf_counter()
        m = engine.train_batch(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        skipped.append(bool(m["skipped"]))
        if on_step is not None:
            on_step(i)
    launches, hopper = _flash_read()
    per_step = _flash_per_step(towers, gas)
    want = {n: TRAIN_TIMED * k for n, k in per_step.items()}
    step_s = sum(times[TRAIN_WARM:]) / TRAIN_TIMED
    rate = work / step_s
    mfu = flops / step_s / PEAK_OPS_PER_S[torch.bfloat16]
    peak = torch.cuda.max_memory_allocated()
    ok = (all(np.isfinite(losses)) and all(np.isfinite(norms))
          and not any(skipped) and losses[-1] < losses[0]
          and launches == want and hopper == launches)
    log(f"train {label}: losses {[round(x, 5) for x in losses]}, grad "
        f"norms {[round(x, 4) for x in norms]}, skipped {skipped}")
    log(f"train {label}: flash launches in {TRAIN_TIMED} timed steps "
        f"{launches} (expected {want}: {per_step} a step), on the Hopper "
        f"kernels {hopper}")
    log(f"train {label} [{card}]: step times {[round(x, 4) for x in times]}"
        f" s; timed step {step_s:.4f} s, {rate:.1f} {unit}/s, MFU "
        f"{mfu:.4f} ({flops:.4e} operations a step, peak 989 TFLOP/s "
        f"bf16); torch.cuda.max_memory_allocated() = {peak} B "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"phase 8b: training {label} failed")
    phase_training_profile(engine, batch, card, f"train {label}")
    return {"step_s": step_s, "rate": rate, "unit": unit, "mfu": mfu,
            "peak": peak, "losses": losses, "launches": launches,
            "wgmma_launches": hopper}


def _decoder_flops(c, rows: int, seq: int) -> float:
    return rows * (seq - 1) * c.flops_per_token(seq)


def _train_loader_family(key: str, model, label: str, card: str,
                         check_batches: bool) -> dict:
    """(a) / (b): a decoder fed through ``initialize(training_data=...)``
    from a seeded numpy dataset, prefetch depth 2 (the producer uploads
    on its own stream). With ``check_batches``, each batch is copied on
    the step's stream as the step starts and again after it, and both
    copies are held bitwise against the same loader run with prefetch
    depth 0: the batches' order and contents. The step here syncs and
    its uploads are small, so the two stream faults cannot show in it;
    :func:`_loader_faults` plants them where they do."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime.dataloader import (DataLoader,
                                                        RepeatingLoader)

    rows, seq, gas = TRAIN_SHAPES[key]
    c = model.config
    data = {"input_ids": np.random.default_rng(21).integers(
        0, TRAIN_SPAN, (TRAIN_DATASETS[key], seq)).astype(np.int32)}
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=model, config=_train_cfg(rows, gas, seed=1,
                                       dataloader={"prefetch_depth": 2}),
        training_data=data)
    seen, real = [], engine.train_batch

    def fed(batch):
        start = {k: v.clone() for k, v in batch.items()}
        m = real(batch)
        seen.append((start, {k: v.clone() for k, v in batch.items()}))
        return m

    if check_batches:
        engine.train_batch = fed
    waits = []
    res = _train_timed(
        label, engine, iter(RepeatingLoader(loader)), [c], gas,
        rows * (seq - 1), "tokens", _decoder_flops(c, rows, seq), card,
        on_step=lambda i: waits.append(loader.data_wait_s))
    side = loader._upload_stream is not None and \
        loader._upload_stream.cuda_stream != \
        torch.cuda.current_stream().cuda_stream
    active = loader._active_prefetch and loader._active_prefetch()
    if active is not None:
        active.close()
    res["data_wait_s"] = waits[-1] - waits[TRAIN_WARM - 1]
    ok = side and res["data_wait_s"] >= 0
    if check_batches:
        ref = iter(RepeatingLoader(DataLoader(data, rows, "cuda", seed=1,
                                              prefetch_depth=0)))
        # the profiled step after the timed ones is not compared
        seen = seen[:TRAIN_WARM + TRAIN_TIMED]
        same = [all(torch.equal(s[k], r[k]) and torch.equal(e[k], r[k])
                    for k in r) for (s, e), r in zip(seen, ref)]
        ok &= len(same) == TRAIN_WARM + TRAIN_TIMED and all(same)
        res["batches_bitwise"] = same
    log(f"train {label}: loader {TRAIN_DATASETS[key]} sequences, prefetch "
        f"depth 2, upload on its own stream: {side}; data_wait_s over the "
        f"timed steps {res['data_wait_s']:.6f} s (all steps "
        f"{waits[-1]:.6f} s)"
        + (f"; batches at step start and end bitwise those of prefetch "
           f"depth 0: {res['batches_bitwise']}" if check_batches else "")
        + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"phase 8b: {label}: the loader's batches differ")
    del engine, loader, seen
    return res


LOADER_PLANT = (6, 4 << 20)     # batches x int32 elements: 16 MiB each
LOADER_SLEEP_CYCLES = 10 ** 8   # a sleep kernel of ~50 ms


def _loader_reads(loader_cls, data: np.ndarray, late: bool) -> int:
    """Batches of ``data`` read wrong by a consumer of ``loader_cls``
    (batch 1, prefetch depth 1) that copies each batch on its stream and
    drops it, with no host sync. A sleep kernel before each read holds
    back either the loader's upload stream (``late`` False: the read
    runs while the upload waits, and is right only if the consumer's
    stream waits for the upload) or the consumer's stream (``late``
    True: the read runs after the batch was freed on the host and the
    next uploads were made, and is right only if ``record_stream`` kept
    its memory from them)."""
    loader = loader_cls(data, 1, "cuda", shuffle=False, prefetch_depth=1)
    # the loader makes its stream lazily; made here, it can be held back
    loader._upload_stream = torch.cuda.Stream()
    slow = torch.cuda.current_stream() if late else loader._upload_stream

    def hold():
        with torch.cuda.stream(slow):
            torch.cuda._sleep(LOADER_SLEEP_CYCLES)

    hold()
    reads = []
    for batch in loader:
        reads.append(batch.clone())
        del batch
        hold()
    torch.cuda.synchronize()
    return sum(not np.array_equal(r[0].cpu().numpy(), data[i])
               for i, r in enumerate(reads))


def _loader_faults() -> dict:
    """(a'): the loader's two stream faults planted, each in a copy of
    the loader that leaves out one step of ``_receive``, and shown to
    corrupt batches that the loader as it is reads right: the consumer's
    stream not waiting for the upload, and no ``record_stream``."""
    from deepspeed_tpu_torch.runtime.dataloader import DataLoader

    class NoWait(DataLoader):
        def _receive(self, batch, done):
            batch.record_stream(torch.cuda.current_stream(self.device))
            return batch

    class NoRecord(DataLoader):
        def _receive(self, batch, done):
            torch.cuda.current_stream(self.device).wait_event(done)
            return batch

    n, width = LOADER_PLANT
    data = np.random.default_rng(31).integers(
        0, 2 ** 31 - 1, (n, width), dtype=np.int32)
    out = {"loader_upload_held": _loader_reads(DataLoader, data, False),
           "loader_read_held": _loader_reads(DataLoader, data, True),
           "no_wait": _loader_reads(NoWait, data, False),
           "no_record_stream": _loader_reads(NoRecord, data, True)}
    ok = (out["loader_upload_held"] == out["loader_read_held"] == 0
          and out["no_wait"] > 0 and out["no_record_stream"] > 0)
    log(f"train loader faults: batches read wrong of {n} ({width * 4} B "
        f"each, prefetch depth 1, no host sync): the loader with its "
        f"upload held back {out['loader_upload_held']}, with the read held "
        f"back {out['loader_read_held']}; planted, no wait on the upload "
        f"{out['no_wait']}, no record_stream {out['no_record_stream']} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 8b: the loader's stream check")
    return out


def _mlm_batch(rng, rows: int, seq: int, device) -> dict:
    """BERT MLM: ids from TRAIN_SPAN, 15 % of positions replaced by
    [MASK] (103) with their ids as labels and in ``loss_mask``, two
    segments split at a random point of each row, no padding."""
    toks = rng.integers(1000, 1000 + TRAIN_SPAN, (rows, seq))
    pick = rng.random((rows, seq)) < 0.15
    split = rng.integers(seq // 4, 3 * seq // 4, rows)
    batch = {"input_ids": np.where(pick, 103, toks),
             "labels": toks, "loss_mask": pick.astype(np.float32),
             "token_type_ids": (np.arange(seq)[None, :] >= split[:, None])
             .astype(np.int64)}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _train_clip(card: str) -> dict:
    """(d): CLIP ViT-L/14 InfoNCE over 64 pairs (text 77 causal, vision
    257 non-causal), the projections and ``logit_scale`` checked for
    nonzero gradients at every step."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.clip import (CLIP, CLIPConfig,
                                                 clip_text_config,
                                                 clip_vision_config)
    from deepspeed_tpu_torch.runtime.optimizers import Transform

    c = CLIP_L14
    cfg = CLIPConfig(clip_text_config(**c["text"]),
                     clip_vision_config(**c["vision"]),
                     proj_dim=c["proj_dim"], image_size=c["image_size"],
                     patch_size=c["patch_size"])
    model = _draw_vectors(CLIP(cfg, seed=0), 0)
    n = TRAIN_SHAPES["clip"][0]
    toks, pixels = _clip_inputs(n, 15)
    batch = {"input_ids": torch.from_numpy(toks).cuda(),
             "pixel_values": torch.from_numpy(pixels).cuda()}
    engine, *_ = deepspeed_tpu_torch.initialize(model=model,
                                                config=_train_cfg(n, 1))
    heads = ("text_proj", "vision_proj", "logit_scale")
    got = []
    inner = engine.optimizer

    def update(grads, state, params):
        got.append(torch.stack([grads[h].abs().max() for h in heads]))
        return inner.update(grads, state, params)

    engine.optimizer = Transform(inner.init, update)
    npatch = model.vision.patch_w.numel()
    per_pair = (cfg.text.flops_per_token(77) * 77
                + cfg.vision.flops_per_token(257) * 257
                + 6 * (npatch * 256 + model.text_proj.numel()
                       + model.vision_proj.numel()))
    res = _train_timed("CLIP ViT-L/14", engine, itertools.repeat(batch),
                       [cfg.text, cfg.vision], 1, n, "samples",
                       n * per_pair, card)
    g = torch.stack(got).cpu()
    ok = bool((g > 0).all())
    log(f"train CLIP ViT-L/14: max |g| of {heads} by step "
        f"{[[f'{x:.3e}' for x in row] for row in g.tolist()]} (the last "
        f"step profiled; all "
        f"nonzero: {ok}); remat on both towers' {cfg.text.n_layers} + "
        f"{cfg.vision.n_layers} layers (JAX's _encode checkpoints its "
        f"blocks whenever remat is set, training or not)")
    if not ok:
        raise SystemExit("phase 8b: CLIP's heads got no gradient")
    res["head_grads"] = g.tolist()
    del engine, model
    return res


def _train_moe(card: str) -> dict:
    """(e): GPT-MoE at 350M+MoE-128's widths and 128 experts, depth cut
    to 2 layers, the capacity route with top-2 and the weighted aux loss
    in the loss; each layer's gate is recorded (on the device) to report
    the experts that received tokens, the (token, choice) pairs dropped
    and the aux loss by step."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.moe import GPTMoE
    from deepspeed_tpu_torch.parallel import moe as pmoe

    model = _draw_vectors(GPTMoE("350m", seed=0, **TRAIN_MOE), 0)
    c = model.config
    rows, seq, gas = TRAIN_SHAPES["moe"]
    ids = torch.from_numpy(np.random.default_rng(23).integers(
        0, TRAIN_SPAN, (rows, seq))).cuda()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=_train_cfg(rows, gas))
    calls = []
    real = pmoe.top_k_gating

    def recording(logits, cfg, cap, generator=None, training=True):
        combine, dispatch, aux = real(logits, cfg, cap, generator, training)
        calls.append(torch.cat([(dispatch.sum(dim=(0, 1, 3)) > 0).float(),
                                dispatch.sum().float()[None],
                                aux.mean()[None]]))
        return combine, dispatch, aux

    pmoe.top_k_gating = recording
    try:
        res = _train_timed(
            f"GPT-MoE 350M+MoE-{c.n_experts} at {c.n_layers} layers",
            engine, itertools.repeat({"input_ids": ids}), [c], gas, rows * (
                seq - 1), "tokens", _decoder_flops(c, rows, seq), card)
    finally:
        pmoe.top_k_gating = real
    # the warm-up, timed and profiled steps; a micro-batch runs each
    # layer's gate twice: the forward, then the remat replay (the same
    # choices, the layers in reverse)
    steps = TRAIN_WARM + TRAIN_TIMED + 1
    if len(calls) != steps * gas * 2 * c.n_layers:
        raise SystemExit(f"phase 8b: MoE gate calls {len(calls)}")
    rec = torch.stack(calls).cpu().reshape(steps, gas, 2 * c.n_layers, -1)
    fwd = rec[:, :, : c.n_layers]
    hit = fwd[..., : c.n_experts].sum(-1).int().tolist()
    pairs = rows // gas * seq * c.top_k      # (token, choice) a micro-batch
    dropped = (pairs - fwd[..., c.n_experts]).int().tolist()
    aux = fwd[..., -1].tolist()
    log(f"train GPT-MoE: by step (the last one profiled) and "
        f"micro-batch, each layer's experts "
        f"that received tokens (of {c.n_experts}) {hit}, (token, choice) "
        f"pairs dropped (of {pairs}, capacity factor {c.capacity_factor}) "
        f"{dropped}, aux loss "
        f"{[[[round(x, 5) for x in m] for m in a] for a in aux]} (weight "
        f"{c.aux_loss_weight}); {c.param_count()} parameters, "
        f"active_param_count {c.active_param_count()}")
    res.update(experts_hit=hit, dropped=dropped, aux=aux,
               params=c.param_count())
    del engine, model
    return res


def _sdpa_backward(backend: str, qt, kt, vt, dot, causal: bool):
    """A closure that makes the one aten call that autograd makes for the
    backward of SDPA's ``backend`` (cuDNN's or FlashAttention-2's), on
    that backend's own forward's saved out and lse; [b, h, s, d]
    inputs, dO laid out as the saved out."""
    aten = torch.ops.aten
    if backend == "CUDNN_ATTENTION":
        o, lse, cq, ck, mq, mk, seed, off = \
            aten._scaled_dot_product_cudnn_attention(
                qt, kt, vt, None, True, 0.0, causal)[:8]
        do_ = torch.empty_like(o).copy_(dot)
        return lambda: aten._scaled_dot_product_cudnn_attention_backward(
            do_, qt, kt, vt, o, lse, seed, off, None, cq, ck, mq, mk, 0.0,
            causal)
    o, lse, cq, ck, mq, mk, seed, off = \
        aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0,
                                                 causal)[:8]
    do_ = torch.empty_like(o).copy_(dot)
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        do_, qt, kt, vt, o, lse, cq, ck, mq, mk, 0.0, causal, seed, off)


def _flash_train_shapes(flush, shapes=None, phase: str = "8b") -> dict:
    """Rows 2-4 at each family's training micro-batch (``shapes``: label,
    b, s, heads, causal and optionally the head dim, default
    TRAIN_FLASH_SHAPES at hd 64; bf16): held against their plain versions
    once, then forward, dq and dk/dv each timed beside its bound, the
    plain version and SDPA: its forward, and its whole backward alone
    (:func:`_sdpa_backward`, so no autograd host time is in the reading)
    for the backend SDPA's dispatch picks, cuDNN's and
    FlashAttention-2's both timed and their gradients held to the plain
    version's too. Every launch on the Hopper kernels where
    ``flash_forward_wgmma_path`` / ``flash_wgmma_path`` take the shape,
    the rest on the mma.sync kernels."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    backends = {int(x): x.name for x in (
        SDPBackend.MATH, SDPBackend.FLASH_ATTENTION,
        SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION)}

    gen = torch.Generator().manual_seed(8)
    out = {}
    for label, b, s, h, causal, *hd in shapes or TRAIN_FLASH_SHAPES:
        d = hd[0] if hd else 64
        q, k, v, do = _flash_inputs(gen, b, s, s, h, h, d, torch.bfloat16)
        before = _flash_counts()
        got = _flash_kernels(q, k, v, do, causal, 0)
        ref = _flash_plain(q, k, v, do, causal, 0)
        ok, errs, tol = _flash_errors(got, ref, torch.bfloat16)
        lse, delta = got[1], fa._delta(got[0], do)
        kernels = {
            "flash_forward": lambda: fa.flash_forward(q, k, v,
                                                      causal=causal),
            "flash_backward_dq": lambda: fa.flash_backward_dq(
                q, k, v, do, lse, delta, causal=causal),
            "flash_backward_dkv": lambda: fa.flash_backward_dkv(
                q, k, v, do, lse, delta, causal=causal)}
        kms = {n: cuda_ms(fn, 10, flush) for n, fn in kernels.items()}
        moved = [a - b_ for a, b_ in zip(_flash_counts(), before)]
        # one checked call and 12 timed calls (2 warm-ups) of each kernel
        hopper_fwd = fa.flash_forward_wgmma_path(
            q.dtype, d, h, h, (q.data_ptr(), k.data_ptr(), v.data_ptr()),
            1.0 / math.sqrt(d))
        hopper_bwd = fa._hopper(q, k, v, do)
        path_ok = moved == [13, 13 * hopper_fwd] + [13, 13 * hopper_bwd] * 2
        p_f = cuda_ms(lambda: fa.flash_attention_forward_reference(
            q, k, v, causal=causal), 3, flush, warmup=1)
        p_b = cuda_ms(lambda: fa._backward_from_delta(
            q, k, v, lse, delta, do, causal, None, 0), 3, flush, warmup=1)
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, do))
        lib_f = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), 10, flush)
        choice = backends.get(int(torch._fused_sdp_choice(
            qt, kt, vt, is_causal=causal)), "other")
        lib_bwds = {n: _sdpa_backward(n, qt, kt, vt, dot, causal)
                    for n in ("CUDNN_ATTENTION", "FLASH_ATTENTION")}
        lib_errs = {n: [((g.transpose(1, 2).float() - r.float()).abs().max()
                         .item(), r.float().abs().max().item())
                        for g, r in zip(fn(), ref[2:])]
                    for n, fn in lib_bwds.items()}
        lib_ok = all(e_ <= GRAD_REL_TOL * m for errs_ in lib_errs.values()
                     for e_, m in errs_)
        lib_bs = {n: cuda_ms(fn, 10, flush) for n, fn in lib_bwds.items()}
        # SDPA's backward is its default backend's (the forward's); a
        # backend not timed here is named, and FlashAttention-2's stands
        lib_name = choice if choice in lib_bs else "FLASH_ATTENTION"
        lib_b = lib_bs[lib_name]
        row = {}
        for name, (ops, _, bound, by) in _flash_bounds(q, k, causal).items():
            fwd = name == "flash_forward"
            row[name] = {"ms": kms[name], "bound_ms": bound,
                         "bound_by": by, "plain_ms": p_f if fwd else p_b,
                         "library_ms": lib_f if fwd else lib_b,
                         "sdpa_backends_ms": None if fwd else lib_bs,
                         "sdpa_backend": choice if fwd else lib_name,
                         "max_abs_err": errs["out"][0] if fwd else
                         errs["dq"][0] if name == "flash_backward_dq" else
                         max(errs["dk"][0], errs["dv"][0]),
                         "tflops": ops / kms[name] / 1e9}
        out[label] = row
        log(f"flash train shape {label}: b {b} s {s} h {h} d {d} bf16 "
            f"{'causal' if causal else 'non-causal'}: " + "; ".join(
                f"{n} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} "
                f"{r['bound_by']}, plain {r['plain_ms']:.3f}, sdpa "
                f"{r['library_ms']:.4f}"
                f"{'' if n == 'flash_forward' else ' whole backward'}, "
                f"{r['tflops']:.1f} TFLOP/s)" for n, r in row.items())
            + f"; errors " + " ".join(f"{n} {e_:.2e}/{m:.2e}"
                                      for n, (e_, m) in errs.items())
            + f" ({tol}); launches {moved}; SDPA's default backend here "
            f"{choice}; its backends' backward alone: " + "; ".join(
                f"{n} {lib_bs[n]:.4f} ms, dq/dk/dv errors " + " ".join(
                    f"{e_:.2e}/{m:.2e}" for e_, m in lib_errs[n])
                for n in lib_bwds)
            + f" {'ok' if ok and path_ok and lib_ok else 'FAIL'}")
        if not (ok and path_ok and lib_ok):
            raise SystemExit(f"phase {phase}: flash kernels at {label}")
        del q, k, v, do, got, ref, qt, kt, vt, dot, lib_bwds
        torch.cuda.empty_cache()
    return out


def _parity_families() -> dict:
    """(f): one fp32 train_batch of each family at full width and 2
    layers (MoE at 32 experts), cuda against cpu (:func:`_trainer_parity`)."""
    from deepspeed_tpu_torch.models import GPT2, OPT, Bert, GPTMoE
    from deepspeed_tpu_torch.models.clip import (CLIP, CLIPConfig,
                                                 clip_text_config,
                                                 clip_vision_config)

    rows, seq = TRAIN_PARITY_ROWS
    rng = np.random.default_rng(29)
    out = {}
    for key, make, gas in (
            ("gpt2", lambda: GPT2("small", device="cpu", seed=3, n_layers=2),
             2),
            ("opt", lambda: OPT("1.3b", device="cpu", seed=3, n_layers=2), 2),
            ("bert", lambda: Bert("large", device="cpu", seed=3, n_layers=2),
             2),
            ("moe", lambda: GPTMoE("350m", device="cpu", seed=3,
                                   **TRAIN_PARITY_MOE), 2)):
        model = _draw_vectors(make(), 3)
        c = model.config
        batch = _mlm_batch(rng, rows, seq, "cpu") if key == "bert" else {
            "input_ids": torch.from_numpy(rng.integers(0, c.vocab_size,
                                                       (rows, seq)))}
        out[key] = _trainer_parity(
            f"(f) {key} 2 layers d {c.d_model} fp32, {rows}x{seq} tokens, "
            f"GAS {gas}", model, batch, gas)
    c = CLIP_L14
    cfg = CLIPConfig(clip_text_config(**{**c["text"], "n_layers": 2}),
                     clip_vision_config(**{**c["vision"], "n_layers": 2}),
                     proj_dim=c["proj_dim"], image_size=c["image_size"],
                     patch_size=c["patch_size"])
    toks, pixels = _clip_inputs(rows, 16)
    out["clip"] = _trainer_parity(
        f"(f) CLIP ViT-L/14 widths 2 + 2 layers fp32, {rows} pairs",
        _draw_vectors(CLIP(cfg, device="cpu", seed=3), 3),
        {"input_ids": torch.from_numpy(toks),
         "pixel_values": torch.from_numpy(pixels)}, 1)
    return out


def phase_train_families(card: str) -> dict:
    """8b: the model families trained on the card through ``initialize``
    and ``TrainEngine``: fp32 masters from seeded random weights (every
    bias and norm term drawn), bf16 compute, AdamW (lr 1e-4, weight
    decay 0.1), clipping 1.0, 2 warm-up then 3 timed steps. (a) GPT-2
    small, 16 x 1024, GAS 2, and (b) OPT-1.3B at ``TRAIN_CUT_LAYERS``
    of 24 layers, 8 x 512, through the loader; (c) BERT-large MLM at
    ``TRAIN_CUT_LAYERS`` of 24 layers, 32 x 512, GAS 2; (d) CLIP
    ViT-L/14, 64
    pairs; (e) GPT-MoE 350M+MoE-128 at 2 layers, 4 x 1024; rows 2-4 at
    each family's shapes; (f) each family fp32 cuda vs cpu."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import GPT2, OPT, Bert

    t0 = time.perf_counter()
    out = {}

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    fresh()
    out["gpt2"] = _train_loader_family(
        "gpt2", _draw_vectors(GPT2("small", seed=0), 0), "GPT-2 small",
        card, check_batches=True)
    out["loader_faults"] = _loader_faults()
    fresh()
    out["opt"] = _train_loader_family(
        "opt", _draw_vectors(OPT("1.3b", seed=0,
                                 n_layers=TRAIN_CUT_LAYERS), 0),
        f"OPT-1.3B, {TRAIN_CUT_LAYERS} of 24 layers", card,
        check_batches=False)
    fresh()
    model = _draw_vectors(Bert("large", seed=0,
                               n_layers=TRAIN_CUT_LAYERS), 0)
    c = model.config
    rows, seq, gas = TRAIN_SHAPES["bert"]
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=_train_cfg(rows, gas))
    batch = _mlm_batch(np.random.default_rng(22), rows, seq, "cuda")
    out["bert"] = _train_timed(
        f"BERT-large MLM, {TRAIN_CUT_LAYERS} of 24 layers", engine,
        itertools.repeat(batch), [c], gas,
        rows * seq, "tokens", rows * seq * c.flops_per_token(seq), card)
    del engine, model, batch
    fresh()
    out["clip"] = _train_clip(card)
    fresh()
    out["moe"] = _train_moe(card)
    fresh()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    out["flash"] = _flash_train_shapes(flush)
    del flush
    fresh()
    out["parity"] = _parity_families()
    out["seconds"] = time.perf_counter() - t0
    log(f"train families: phase 8b in {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------- phase 8c
TP_TRAIN_WORLD = 2
TP_TRAIN_LAYERS = 11           # (a): TinyLlama-1.1B's 22 cut (PR 24; time)
TP_TRAIN_SHAPE = (2, 2048, 2)  # (a): rows x tokens a step, GAS (phase 8's
#                                4 x 2048 micro-batch cut to 1 x 2048: time)
TP_TRAIN_TIMED = 3             # (a): after 1 warm-up step
TP_TRAIN_ROWS = (2, 256)       # (b), (c): rows x tokens a step, GAS 2
TP_TRAIN_STEPS = 3             # (b), (c)
TP_TRAIN_LR = 1e-4
TP_TRAIN_PREDICTED_S = 55.0    # stated in PERF.md before the first run


def _tp_train_cfg(rows: int, gas: int, tp: int, bf16: bool) -> dict:
    cfg = {"train_batch_size": rows, "gradient_accumulation_steps": gas,
           "gradient_clipping": 1.0, "steps_per_print": 1000,
           "optimizer": {"type": "adamw",
                         "params": {"lr": TP_TRAIN_LR,
                                    "weight_decay": 0.1}}}
    if tp > 1:
        cfg["mesh"] = {"model": tp}
    if bf16:
        cfg["bf16"] = {"enabled": True}
    return cfg


def _tp_parity_model(kind: str, device: str):
    """(b) / (c)'s full-width 2-layer model from a seed, norm vectors
    drawn: Llama-1b's widths made on the host (the cpu ranks and the
    card get the same weights), or 350M+MoE-128's at 32 experts made on
    ``device``, with the vocab padded 50257 -> 50432 (an odd vocab cannot
    shard; 6f (i)'s pad)."""
    from deepspeed_tpu_torch.models.llama import Llama
    from deepspeed_tpu_torch.models.moe import GPTMoE

    if kind == "llama":
        return _draw_vectors(Llama("1b", device="cpu", seed=2, n_layers=2),
                             2).to(device)
    return _draw_vectors(GPTMoE("350m", 32, device=device, seed=3,
                                n_layers=2, vocab_size=TP_MOE_VOCAB), 3)


def _min_abs_g(engine) -> dict:
    """Wrap ``engine``'s optimizer to keep each element's smallest |g|
    over the steps; returns the dict it fills."""
    from deepspeed_tpu_torch.runtime.optimizers import Transform

    lo = {}
    inner = engine.optimizer

    def update(grads, state, params):
        for n, g in grads.items():
            a = g.abs()
            lo[n] = torch.minimum(lo[n], a) if n in lo else a.clone()
        return inner.update(grads, state, params)

    engine.optimizer = Transform(inner.init, update)
    return lo


def _tp_steps(engine, batch) -> list:
    steps = []
    for _ in range(TP_TRAIN_STEPS):
        m = engine.train_batch(batch)
        steps.append((float(m["loss"]), float(m["grad_norm"]),
                      bool(m["skipped"])))
    return steps


def _tp_parity(rank, world, device, kind: str, ids: np.ndarray,
               keep_ref: bool) -> tuple:
    """(b) / (c) on one rank: the 2-layer fp32 model through
    ``initialize`` at TP ``world`` (``initialize`` cuts it), 3 steps; for
    MoE each gate call's dispatch fingerprinted. Returns (the steps and
    fingerprints, the masters gathered to full width, with ``keep_ref``
    a copy of the model as it started)."""
    import copy

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.parallel import moe as pmoe

    model = _tp_parity_model(kind, device)
    ref = copy.deepcopy(model) if keep_ref else None
    batch = {"input_ids": torch.from_numpy(ids).to(device)}
    routes = []
    real = pmoe.top_k_gating

    def recording(logits, cfg, cap, generator=None, training=True):
        out = real(logits, cfg, cap, generator, training)
        routes.append(_digest(out[1].to(torch.int16)))
        return out

    pmoe.top_k_gating = recording
    try:
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=model, device=device,
            config=_tp_train_cfg(TP_TRAIN_ROWS[0], 2, world, False))
        steps = _tp_steps(engine, batch)
    finally:
        pmoe.top_k_gating = real
    out = {"steps": steps, "routes": routes,
           "sharded": len(engine.tp_sharded), "leaves": len(engine.params)}
    return out, engine.full_params(), ref, batch


def _tp_against_tp1(device, ref, full: dict, batch) -> dict:
    """The same weights (``ref``) trained at TP 1 on the card, 3 steps,
    and the TP run's gathered masters ``full`` held against its masters:
    within 1e-6 except where a TP-1 gradient element fell below 1e-6 at
    some step (Adam's near-eps elements), those within 2 lr a step."""
    from deepspeed_tpu_torch.config import Config
    from deepspeed_tpu_torch.parallel.mesh import Topology
    from deepspeed_tpu_torch.runtime.engine import TrainEngine

    cfg = Config.from_dict(_tp_train_cfg(TP_TRAIN_ROWS[0], 2, 1, False))
    one = TrainEngine(params=dict(ref.named_parameters()), config=cfg,
                      model=ref, device=device, topology=Topology({}, {}))
    lo = _min_abs_g(one)
    out = {"tp1": _tp_steps(one, batch)}
    worst = near = 0.0
    n_out = n_all = 0
    for n, w in one.params.items():
        d = (full[n] - w).abs()
        small = lo[n] < 1e-6
        beyond = d > 1e-6
        n_all += d.numel()
        if (~small).any():
            worst = max(worst, d[~small].max().item())
        if beyond.any():
            if not bool(small[beyond].all()):
                raise SystemExit(f"phase 8c: {n} moved differently at TP 2 "
                                 f"and TP 1 where its gradient is not near "
                                 f"Adam's eps")
            n_out += int(beyond.sum())
            near = max(near, d[beyond].max().item())
    out["weights"] = {"worst": worst, "near_eps": n_out, "near_max": near,
                      "elements": n_all,
                      "ok": near <= 2 * TP_TRAIN_LR * TP_TRAIN_STEPS}
    return out


def _tp_train_full(rank, world, ids: np.ndarray) -> dict:
    """(a) on one rank: ``Llama("1b")`` at full width and ``TP_TRAIN_LAYERS``
    of its 22 layers built on
    the card from seed 0, cut by ``initialize`` to this rank's half (hq
    16, hkv 2 of d 64), bf16 compute on fp32 masters, full remat, AdamW,
    clipping 1.0, GAS 2 of 1 x 2048 tokens: 1 warm-up step, then the
    flash counts and the comms ledger set to 0 and 3 timed steps, each
    collective timed after a synchronize (:class:`_TPMeter`; the other
    rank's kernels on the shared card are part of the wait)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models.llama import Llama

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Llama("1b", seed=0, n_layers=TP_TRAIN_LAYERS)
    rows, seq, gas = TP_TRAIN_SHAPE
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=_tp_train_cfg(rows, gas, world, True))
    built = time.perf_counter() - t0
    batch = {"input_ids": torch.from_numpy(ids).cuda()}
    comm.configure_comms_logger(True)
    ledger = comm.get_comms_logger()
    losses, norms, skipped, times = [], [], [], []

    def step():
        t1 = time.perf_counter()
        m = engine.train_batch(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        skipped.append(bool(m["skipped"]))

    step()
    _flash_reset()
    ledger.reset()
    meter = _TPMeter(model.config.n_layers)
    for _ in range(TP_TRAIN_TIMED):
        step()
    launches, hopper = _flash_read()
    comm.configure_comms_logger(False)
    replicated = {n: _digest(p) for n, p in engine.params.items()
                  if n not in engine.tp_sharded}
    return {"losses": losses, "norms": norms, "skipped": skipped,
            "times": times, "built_s": built,
            "coll_s": meter.coll_s, "coll_calls": meter.n_coll,
            "ledger": ledger.snapshot_totals(), "launches": launches,
            "wgmma_launches": hopper, "replicated": replicated,
            "peak": torch.cuda.max_memory_allocated(),
            "sharded": len(engine.tp_sharded),
            "params_local": sum(p.numel() for p in engine.params.values()),
            "params": model.config.param_count()}


def _job_tp_train(rank, world, device, ids: dict) -> dict:
    """A rank of phase 8c: on cpu ranks (b) only; on the card (b) and
    (c) at TP 2, then the two TP-1 references side by side (rank 0 (b)'s,
    rank 1 (c)'s), then (a), so that the cpu ranks' host work is over
    before (a) is timed."""
    if device == "cpu":
        return {"parity": _tp_parity(rank, world, device, "llama",
                                     ids["parity"], False)[0]}
    out, held = {}, []
    for i, (key, kind) in enumerate((("parity", "llama"), ("moe", "moe"))):
        res, full, ref, batch = _tp_parity(rank, world, device, kind,
                                           ids[key], rank == i)
        out[key] = res
        if ref is not None:
            held.append((key, ref, full, batch))
        del full, ref
        gc.collect()
    while held:
        key, *run = held.pop()
        out[key].update(_tp_against_tp1(device, *run))
        del run
    gc.collect()
    torch.cuda.empty_cache()
    out["a"] = _tp_train_full(rank, world, ids["a"])
    return out


def _tp_steps_ok(got, ref) -> tuple:
    """(worst loss rel, worst grad-norm rel, within 1e-5 / 1e-4 and no
    step skipped)."""
    lr = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got, ref))
    nr = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(got, ref))
    ok = lr <= 1e-5 and nr <= 1e-4 and not any(a[2] or b[2]
                                               for a, b in zip(got, ref))
    return lr, nr, ok


def phase_tp_training(card: str) -> dict:
    """8c: tensor-parallel training at TP 2, two gloo rank processes on
    the one card (and, for (b), two on the host; :func:`_job_tp_train`):
    (a) TinyLlama-1.1B
    (``llama_config("1b")``) at full width and ``TP_TRAIN_LAYERS`` of its
    22 layers, bf16 on fp32
    masters, GAS 2 of 1 x 2048: step time, tokens/s, MFU, the
    collectives a step and their share of it, peak memory a rank, flash
    launches a rank (all on the Hopper kernels), a finite falling loss,
    no skipped step, the replicated leaves bitwise equal on both ranks;
    (b) its widths at 2 layers in fp32: TP 2 on the card against TP 1 on
    the card and TP 2 on the host, 3 steps; (c) 350M+MoE-128's widths at 2
    layers and 32 experts, fp32, the capacity route (top-2, no noise):
    TP 2 against TP 1 on the card, each rank's expert choices equal."""
    from deepspeed_tpu_torch.models.llama import llama_config

    t0 = time.perf_counter()
    rng = np.random.default_rng(37)
    rows, seq, _ = TP_TRAIN_SHAPE
    prow, pseq = TP_TRAIN_ROWS
    ids = {"a": rng.integers(0, 32000, (rows, seq)),
           "parity": rng.integers(0, 32000, (prow, pseq)),
           "moe": rng.integers(0, 50257, (prow, pseq))}
    cuda = _start_ranks(TP_TRAIN_WORLD, "cuda", "tp_train", (ids,))
    cpu = _start_ranks(TP_TRAIN_WORLD, "cpu", "tp_train", (ids,))
    res_cpu = _join_ranks(*cpu, timeout=600)
    res = _join_ranks(*cuda, timeout=600)
    ok = True
    # (b), (c): TP 2 against TP 1 on the card, (b) against TP 2 on the host
    for key, label in (("parity", "(b) Llama-1b widths, 2 layers"),
                       ("moe", "(c) 350M+MoE-128 widths, 2 layers, 32 "
                               "experts")):
        r0 = res[0][key]
        same = all(r[key]["steps"] == r0["steps"] for r in res)
        held = next(r[key] for r in res if "tp1" in r[key])
        lr, nr, good = _tp_steps_ok(r0["steps"], held["tp1"])
        w = held["weights"]
        good = good and same and w["ok"] and w["worst"] <= 1e-6
        line = (f"tp train {label} fp32 [{card}]: TP 2 losses "
                f"{[round(s[0], 6) for s in r0['steps']]}, grad norms "
                f"{[round(s[1], 5) for s in r0['steps']]}; against TP 1 on "
                f"the card: loss rel {lr:.2e} (1e-5), grad norm rel "
                f"{nr:.2e} (1e-4); gathered weights max |TP 2 - TP 1| "
                f"{w['worst']:.2e} (1e-6) where |g| >= 1e-6, {w['near_eps']} "
                f"of {w['elements']} elements beyond, all near Adam's eps, "
                f"max {w['near_max']:.2e} (<= {2 * TP_TRAIN_LR * TP_TRAIN_STEPS:g}); "
                f"{r0['sharded']} of {r0['leaves']} leaves cut")
        if key == "parity":
            lc, nc, gc_ = _tp_steps_ok(r0["steps"], res_cpu[0][key]["steps"])
            good = good and gc_
            line += (f"; against TP 2 on the host: loss rel {lc:.2e}, grad "
                     f"norm rel {nc:.2e}")
        else:
            routes = [r[key]["routes"] for r in res]
            agree = all(x == routes[0] for x in routes) and routes[0]
            good = good and bool(agree)
            line += (f"; expert choices of {len(routes[0])} gate calls "
                     f"equal on both ranks: {bool(agree)}")
        ok = ok and good
        log(line + f" {'ok' if good else 'FAIL'}")
    # (a)
    a = [r["a"] for r in res]
    c = llama_config("1b", n_layers=TP_TRAIN_LAYERS)
    rows, seq, gas = TP_TRAIN_SHAPE
    tokens = rows * (seq - 1)
    c_flops = tokens * c.flops_per_token(seq)
    step_s = max(sum(x["times"][1:]) / TP_TRAIN_TIMED for x in a)
    tok_s = tokens / step_s
    mfu = c_flops / step_s / PEAK_OPS_PER_S[torch.bfloat16]
    per_step = {"flash_forward": c.n_layers * 2 * gas,   # + the replay
                "flash_backward_dq": c.n_layers * gas,
                "flash_backward_dkv": c.n_layers * gas}
    want = {n: TP_TRAIN_TIMED * k for n, k in per_step.items()}
    for r, x in enumerate(a):
        good = (all(np.isfinite(x["losses"])) and all(np.isfinite(x["norms"]))
                and not any(x["skipped"]) and x["losses"][-1] < x["losses"][0]
                and x["launches"] == want and x["wgmma_launches"] == want)
        ok = ok and good
        timed = sum(x["times"][1:])
        share = x["coll_s"] / timed
        led = {op: (int(v["count"] / TP_TRAIN_TIMED),
                    int(v["bytes"] / TP_TRAIN_TIMED))
               for op, v in x["ledger"].items()}
        log(f"tp train (a) rank {r}: losses "
            f"{[round(v, 5) for v in x['losses']]}, grad norms "
            f"{[round(v, 4) for v in x['norms']]}, skipped {x['skipped']}; "
            f"flash launches in {TP_TRAIN_TIMED} timed steps "
            f"{x['launches']} (expected {want}), on the Hopper kernels "
            f"{x['wgmma_launches']} {'ok' if good else 'FAIL'}")
        log(f"tp train (a) rank {r} [{card}]: step times "
            f"{[round(v, 4) for v in x['times']]} s; collectives a step "
            f"{x['coll_calls'] / TP_TRAIN_TIMED:g} ({led}: count, bytes), "
            f"{x['coll_s'] / TP_TRAIN_TIMED:.4f} s of the step, share "
            f"{share:.3f}; torch.cuda.max_memory_allocated() = {x['peak']} "
            f"B; {x['params_local']} of {x['params']} parameters on this "
            f"rank ({x['sharded']} leaves cut); built in "
            f"{x['built_s']:.1f} s")
    same = a[0]["replicated"] == a[1]["replicated"]
    ok = ok and same
    log(f"tp train (a): {len(a[0]['replicated'])} replicated leaves "
        f"bitwise equal on both ranks after the steps: {same}")
    seconds = time.perf_counter() - t0
    log(f"tp train (a) [{card}]: TinyLlama-1.1B at TP 2 ({c.n_layers} "
        f"layers, d {c.d_model}, {c.n_heads} / {c.n_kv_heads} heads, "
        f"d_ff {c.d_ff}, vocab {c.vocab_size}), GAS {gas} x {rows // gas} x "
        f"{seq}: timed step {step_s:.4f} s (the slower rank's mean), "
        f"{tok_s:.1f} tokens/s, MFU {mfu:.4f} ({c_flops:.4e} operations a "
        f"step, peak 989 TFLOP/s bf16)")
    log(f"tp train: phase 8c in {seconds:.1f} s (predicted "
        f"{TP_TRAIN_PREDICTED_S:g} s)")
    if not ok:
        raise SystemExit("phase 8c: tensor-parallel training failed")
    return {"launches": a[0]["launches"],
            "wgmma_launches": a[0]["wgmma_launches"], "step_s": step_s,
            "tok_s": tok_s, "mfu": mfu, "seconds": seconds}


# --------------------------------------------------------------- phase 8d
ZERO_WORLD = 2
ZERO_WARM, ZERO_TIMED = 1, 2
ZERO_LR = 1e-4
ZERO_RUNS = {      # (model, stages, rows x tokens a step, GAS, label)
    "a": ("gpt2", (0, 1, 2), 16, 1024, 2, "GPT-2 small, 12 of 12 layers"),
    "b": ("opt", (0, 2), 8, 512, 1, "OPT-1.3B widths, 3 of 24 layers"),
    "c": ("llama7b", (3,), 2, 2048, 1, "Llama-2-7B widths, 1 of 32 layers")}
ZERO_OPT_LAYERS = 3             # (b): the step's gloo bytes (time)
ZERO_LLAMA_LAYERS = 1           # (c): 2 until PR 24 (time)
ZERO_PARITY_ROWS = (2, 128)     # (d): rows x tokens of its one step
ZERO_PARITY_LAYERS = 1          # (d): the host ranks' work (time)
# (d): (model, stage, qgZ) on the card, each held to the card's stage 0
# of its model (the masters after the step; qgZ not), and every run but
# stage 0 on the two host ranks too; OPT's flag set at OPT-125m's widths.
# The host ranks are held at tolerances, so they run unpinned on
# ``ZERO_HOST_THREADS`` threads each
ZERO_PARITY_CARD = (("llama", 0, False), ("llama", 1, False),
                    ("llama", 2, False), ("llama", 3, False),
                    ("llama", 2, True), ("opt125m", 0, False),
                    ("opt125m", 3, False))
ZERO_PARITY_HOST = tuple(run for run in ZERO_PARITY_CARD if run[1])
ZERO_HOST_THREADS = 3
ZERO_PREDICTED_S = 125.0        # stated in PERF.md before the run
_ZERO_HOST_MODELS: dict = {}    # (d)'s drawn host models, copied a run


def _zero_cfg(rows: int, gas: int, stage: int, bf16: bool,
              qgz: bool = False) -> dict:
    cfg = {"train_batch_size": rows, "gradient_accumulation_steps": gas,
           "gradient_clipping": 1.0, "steps_per_print": 1000,
           "mesh": {"data": ZERO_WORLD},
           "optimizer": {"type": "adamw",
                         "params": {"lr": ZERO_LR, "weight_decay": 0.1}},
           "zero_optimization": {"stage": stage,
                                 "zero_quantized_gradients": qgz}}
    if bf16:
        cfg["bf16"] = {"enabled": True}
    return cfg


def _zero_model(kind: str, device: str = "cuda"):
    """8d's models from a seed, every bias and norm term drawn: (a)-(c) at
    full width built on the card ((c)'s then moved to the host), (d)'s
    1-layer fp32 ones drawn on the host once a process and copied to
    ``device`` a run (the cpu ranks and the card get the same
    weights)."""
    import copy

    from deepspeed_tpu_torch.models import GPT2, OPT
    from deepspeed_tpu_torch.models.llama import Llama

    if kind == "gpt2":
        return _draw_vectors(GPT2("small", seed=0), 0)
    if kind == "opt":
        return _draw_vectors(OPT("1.3b", seed=0,
                                 n_layers=ZERO_OPT_LAYERS), 0)
    if kind == "llama7b":
        # stage 3: the engine copies the rank's shards to the card, so the
        # whole model waits on the host
        return _draw_vectors(Llama("7b", seed=0,
                                   n_layers=ZERO_LLAMA_LAYERS), 0).cpu()
    if kind not in _ZERO_HOST_MODELS:
        make = Llama("1b", device="cpu", seed=2,
                     n_layers=ZERO_PARITY_LAYERS) \
            if kind == "llama" else OPT("125m", device="cpu", seed=2,
                                        n_layers=ZERO_PARITY_LAYERS)
        _ZERO_HOST_MODELS[kind] = _draw_vectors(make, 2)
    return copy.deepcopy(_ZERO_HOST_MODELS[kind]).to(device)


def _zero_timed(rank, world, key: str, stage: int, ids: np.ndarray) -> dict:
    """One of (a)-(c) on one rank: the model through ``initialize`` at
    ZeRO ``stage`` over the two ranks, bf16 on fp32 masters, full remat,
    AdamW; ``ZERO_WARM`` warm-up and ``ZERO_TIMED`` timed steps with the
    flash counts, the comms ledger and the collective meter set to 0
    between them; peak memory over the steps, the moments' and the
    gradient accumulator's bytes, the masters' digests."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import comm

    kind, _, rows, seq, gas, _ = ZERO_RUNS[key]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=_zero_model(kind), config=_zero_cfg(rows, gas, stage, True),
        device="cuda")
    built = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    acc = []
    real_update = engine._update

    def update(grads, scale):
        acc.append(sum(g.numel() * g.element_size() for g in grads.values()))
        return real_update(grads, scale)

    engine._update = update
    batch = {"input_ids": torch.from_numpy(ids).cuda()}
    comm.configure_comms_logger(True)
    ledger = comm.get_comms_logger()
    meter = _CollMeter()
    losses, norms, skipped, times = [], [], [], []
    try:
        for i in range(ZERO_WARM + ZERO_TIMED):
            if i == ZERO_WARM:
                _flash_reset()
                ledger.reset()
                meter.reset()
            t1 = time.perf_counter()
            m = engine.train_batch(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            skipped.append(bool(m["skipped"]))
    finally:
        meter.close()
        comm.configure_comms_logger(False)
    launches, hopper = _flash_read()
    mu, nu = engine.opt_state.mu, engine.opt_state.nu
    whole = [n for n, p in engine.params.items()
             if tuple(p.shape) == engine.full_shapes[n]]
    out = {"losses": losses, "norms": norms, "skipped": skipped,
           "times": times, "built_s": built, "launches": launches,
           "wgmma_launches": hopper, "coll_s": meter.coll_s,
           "coll_calls": meter.n_coll, "ledger": ledger.snapshot_totals(),
           "peak": torch.cuda.max_memory_allocated(),
           "moment_bytes": sum(t.numel() * t.element_size()
                               for t in (*mu.values(), *nu.values())),
           "grad_bytes": acc[-1],
           "master_bytes": sum(p.numel() * p.element_size()
                               for p in engine.params.values()),
           "whole_masters": len(whole), "leaves": len(engine.params),
           "digest": [_digest(engine.params[n]) for n in sorted(whole)]
           if stage in (1, 2) else None,
           "route": engine._route}
    del engine, batch, mu, nu
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _zero_parity(rank, world, device: str, kind: str, stage: int, qgz: bool,
                 ids: np.ndarray, keep: bool) -> dict:
    """One (d) run on one rank: the 1-layer fp32 model through
    ``initialize`` at ``stage`` over the two ranks, one step; the masters
    gathered whole, kept with ``keep`` (rank 0), with, on the card, the
    quantizer's launches and at stage 0 each element's |g| as the
    optimizer saw it."""
    import deepspeed_tpu_torch

    rows, _ = ZERO_PARITY_ROWS
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=_zero_model(kind, device), device=device,
        config=_zero_cfg(rows, 1, stage, False, qgz))
    lo = _min_abs_g(engine)
    batch = {"input_ids": torch.from_numpy(ids).to(device)}
    if device == "cuda":
        for w, *_ in QUANT_KERNELS.values():
            w.launches = 0
    m = engine.train_batch(batch)
    out = {"step": (float(m["loss"]), float(m["grad_norm"]),
                    bool(m["skipped"])), "route": engine._route}
    if device == "cuda":
        out["quant_launches"] = {n: w.launches
                                 for n, (w, *_) in QUANT_KERNELS.items()}
    full = engine.full_params()             # every rank of the group
    if keep:
        out["full"] = full
        if stage == 0 and device == "cuda":  # whole at stage 0
            out["lo"] = lo
    del full
    del engine
    gc.collect()
    return out


def _zero_weights(full: dict, ref: dict, lo: dict) -> dict:
    """The masters ``full`` against ``ref`` after the step: the largest
    difference where the card's stage 0 saw |g| >= 1e-6 (``lo``), and
    the elements beyond 1e-6 (all near Adam's eps, each within 2 lr)."""
    worst = near = 0.0
    n_out = n_all = 0
    ok = True
    for n, w in ref.items():
        d = (full[n] - w).abs()
        small = lo[n] < 1e-6
        beyond = d > 1e-6
        n_all += d.numel()
        if (~small).any():
            worst = max(worst, d[~small].max().item())
        if beyond.any():
            ok &= bool(small[beyond].all())
            n_out += int(beyond.sum())
            near = max(near, d[beyond].max().item())
    ok &= near <= 2 * ZERO_LR and worst <= 1e-6
    return {"worst": worst, "near_eps": n_out, "near_max": near,
            "elements": n_all, "ok": ok}


def _zero_facade(full: dict, ref: dict) -> dict:
    """qgZ's masters ``full`` against ``ref`` after the step, by the
    compressed facade's rule: within 1e-5 but for at most 1 in 200
    elements, each within 2 lr (a gradient a quantization level apart
    can flip Adam's first update)."""
    worst, n_out, n_all = 0.0, 0, 0
    for n, w in ref.items():
        d = (full[n] - w).abs()
        n_all += d.numel()
        n_out += int((d > 1e-5).sum())
        worst = max(worst, d.max().item())
    return {"worst": worst, "beyond": n_out, "elements": n_all,
            "ok": n_out <= n_all // 200 and worst <= 2 * ZERO_LR + 1e-5}


def _zero_host_file(tmp: str, key: tuple, what: str = "host") -> str:
    kind, stage, qgz = key
    return os.path.join(tmp, f"{what}_{kind}_{stage}_{int(qgz)}.pt")


def _job_zero(rank, world, device, ids: dict, tmp: str) -> dict:
    """A rank of phase 8d: on cpu ranks (d)'s host runs, rank 0 writing
    each run's masters under ``tmp``; on the card (d)'s runs, each held
    against the card's stage 0 of its model, rank 0 writing each run's
    masters (and the stage-0 run's |g|) under ``tmp`` for the host
    comparison (:func:`_zero_host_finish`), then (a)-(c) timed."""
    runs = ZERO_PARITY_HOST if device == "cpu" else ZERO_PARITY_CARD
    out, ref = {"d": {}}, {}
    for key in runs:
        res = _zero_parity(rank, world, device, *key, ids["d"], rank == 0)
        full, lo = res.pop("full", None), res.pop("lo", None)
        if full is not None and device == "cpu":
            torch.save(full, _zero_host_file(tmp, key))
        elif full is not None and key[1] == 0:
            ref[key[0]] = (full, lo)
            torch.save({n: t.cpu() for n, t in lo.items()},
                       _zero_host_file(tmp, key, "card_lo"))
        elif full is not None:
            if not key[2]:
                res["weights"] = _zero_weights(full, *ref[key[0]])
            if key in ZERO_PARITY_HOST:
                torch.save({n: t.cpu() for n, t in full.items()},
                           _zero_host_file(tmp, key, "card"))
        out["d"][key] = res
        del full, lo
    if device == "cpu":
        return out
    ref.clear()
    gc.collect()
    torch.cuda.empty_cache()
    for key, (_, stages, *_) in ZERO_RUNS.items():
        out[key] = {s: _zero_timed(rank, world, key, s, ids[key])
                    for s in stages}
    return out


def _zero_steps_ok(got, ref, loss_rtol: float = 1e-5) -> tuple:
    """(worst loss rel, worst grad-norm rel, within ``loss_rtol`` / 1e-4
    and no step skipped)."""
    lr = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got, ref))
    nr = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(got, ref))
    ok = lr <= loss_rtol and nr <= 1e-4 and not any(
        a[2] or b[2] for a, b in zip(got, ref))
    return lr, nr, ok


def _zero_parity_checks(res, res_cpu, card: str) -> bool:
    """(d)'s lines: each card run against the card's stage 0 of its model
    (but qgZ) and against the host ranks' run of the same stage."""
    ok = True
    for key in ZERO_PARITY_HOST:
        kind, stage, qgz = key
        r0 = res[0]["d"][key]
        step = r0["step"]
        same = all(r["d"][key]["step"] == step for r in res)
        s0 = res[0]["d"][(kind, 0, False)]["step"]
        l0, n0, good0 = _zero_steps_ok([step], [s0])
        host = res_cpu[0]["d"][key]["step"]
        lh, nh, goodh = _zero_steps_ok([step], [host], 1e-4 if qgz else 1e-5)
        hw = r0["host_weights"]
        good = (same and goodh and hw["ok"]
                and (stage < 3 or r0["route"] == "gather"))
        line = (f"zero train (d) {kind} {ZERO_PARITY_LAYERS} layer fp32 "
                f"stage {stage}"
                f"{' qgZ' if qgz else ''} [{card}]: loss {step[0]:.6f}, "
                f"grad norm {step[1]:.5f}; against stage 0 on the card: "
                f"loss rel {l0:.2e}, grad norm rel {n0:.2e} "
                + ("(quantized: not held to stage 0)" if qgz else
                   "(1e-5 / 1e-4)")
                + f"; against the host ranks: loss rel {lh:.2e} "
                f"({1e-4 if qgz else 1e-5:g}), grad norm rel {nh:.2e} (1e-4)")
        if qgz:
            q = r0["quant_launches"]
            good = good and all(v > 0 for v in q.values())
            line += (f", masters max |card - host| {hw['worst']:.2e}, "
                     f"{hw['beyond']} of {hw['elements']} elements beyond "
                     f"1e-5 (at most 1 in 200, each within 2 lr); "
                     f"quantizer launches on the card {q}")
        else:
            w = r0["weights"]
            good = good and good0 and w["ok"]
            for name, x in ((f"stage {stage} - stage 0", w),
                            ("card - host", hw)):
                line += (f"; masters max |{name}| {x['worst']:.2e} (1e-6) "
                         f"where |g| >= 1e-6, {x['near_eps']} of "
                         f"{x['elements']} elements beyond, all near "
                         f"Adam's eps, max {x['near_max']:.2e}")
        ok = ok and good
        log(line + f" {'ok' if good else 'FAIL'}")
    return ok


def _zero_model_config(kind: str):
    from deepspeed_tpu_torch.models.gpt2 import gpt2_config, opt_config
    from deepspeed_tpu_torch.models.llama import llama_config

    if kind == "gpt2":
        return gpt2_config("small")
    if kind == "opt":
        return opt_config("1.3b", n_layers=ZERO_OPT_LAYERS)
    return llama_config("7b", n_layers=ZERO_LLAMA_LAYERS)


def _zero_timed_checks(res, card: str) -> tuple:
    """(a)-(c)'s lines; returns (ok, the flash launches of rank 0 by run,
    their Hopper share, each run's step time)."""
    ok, launches, wgmma, step = True, {}, {}, {}
    for key, (kind, stages, rows, seq, gas, label) in ZERO_RUNS.items():
        c = _zero_model_config(kind)
        per_step = _flash_per_step([c], gas)
        # every launch on the Hopper kernels, (c)'s at d 128 too
        want = {n: ZERO_TIMED * k for n, k in per_step.items()}
        tokens = rows * (seq - 1)
        flops = _decoder_flops(c, rows, seq)
        peaks = {}
        for s in stages:
            runs = [r[key][s] for r in res]
            step_s = max(sum(x["times"][ZERO_WARM:]) / ZERO_TIMED
                         for x in runs)
            mfu = flops / step_s / PEAK_OPS_PER_S[torch.bfloat16]
            step[f"{key}{s}"] = step_s
            launches[f"{key}_stage{s}"] = runs[0]["launches"]
            wgmma[f"{key}_stage{s}"] = runs[0]["wgmma_launches"]
            same = all(x["losses"] == runs[0]["losses"]
                       and x["norms"] == runs[0]["norms"] for x in runs)
            equal = s not in (1, 2) or all(
                x["digest"] == runs[0]["digest"] for x in runs)
            peaks[s] = max(x["peak"] for x in runs)
            for r, x in enumerate(runs):
                good = (all(np.isfinite(x["losses"]))
                        and all(np.isfinite(x["norms"]))
                        and not any(x["skipped"])
                        and x["losses"][-1] < x["losses"][0]
                        and x["launches"] == want
                        and x["wgmma_launches"] == want
                        and same and equal
                        and (s < 3 or x["route"] == "gather"))
                ok = ok and good
                timed = sum(x["times"][ZERO_WARM:])
                led = {op: (int(v["count"] / ZERO_TIMED),
                            int(v["bytes"] / ZERO_TIMED))
                       for op, v in x["ledger"].items()}
                log(f"zero train ({key}) {label} stage {s} rank {r} "
                    f"[{card}]: losses {[round(v, 5) for v in x['losses']]}"
                    f", grad norms {[round(v, 4) for v in x['norms']]}, "
                    f"skipped {x['skipped']}; step times "
                    f"{[round(v, 4) for v in x['times']]} s; peak "
                    f"torch.cuda.max_memory_allocated() = {x['peak']} B; "
                    f"masters {x['master_bytes']} B ({x['whole_masters']} "
                    f"of {x['leaves']} leaves whole), moments "
                    f"{x['moment_bytes']} B, gradient accumulator "
                    f"{x['grad_bytes']} B; collectives a step "
                    f"{x['coll_calls'] / ZERO_TIMED:g} ({led}: count, "
                    f"bytes), {x['coll_s'] / ZERO_TIMED:.4f} s of the "
                    f"step, share {x['coll_s'] / timed:.3f}; flash "
                    f"launches in {ZERO_TIMED} timed steps {x['launches']} "
                    f"(expected {want}), on the Hopper wgmma kernels "
                    f"{x['wgmma_launches']} (expected all of them); "
                    f"masters bitwise equal "
                    f"on both ranks: {equal}; built in {x['built_s']:.1f} "
                    f"s {'ok' if good else 'FAIL'}")
            log(f"zero train ({key}) {label} stage {s} [{card}]: "
                f"{c.param_count()} parameters, GAS {gas} x {rows // gas} x "
                f"{seq}: timed step {step_s:.4f} s (the slower rank's "
                f"mean), {tokens / step_s:.1f} tokens/s, MFU {mfu:.4f} "
                f"({flops:.4e} operations a step, peak 989 TFLOP/s bf16)")
        order = [peaks[s] for s in stages]
        falls = all(a > b for a, b in zip(order, order[1:]))
        ok = ok and falls
        log(f"zero train ({key}): peak memory a rank by stage "
            f"{dict(zip(stages, order))} B, falling: {falls}")
    return ok, launches, wgmma, step


def phase_zero_training(card: str) -> dict:
    """8d: ZeRO stages 1-3 over the ``data`` axis, two gloo rank
    processes on the one card (and two on the host for (d);
    :func:`_job_zero`), through ``initialize`` -> ``train_batch``: (a)
    GPT-2 small at full depth, stages 0, 1 and 2, 16 x 1024, GAS 2; (b)
    OPT-1.3B's widths at 3 of 24 layers, stages 0 and 2, 8 x 512; (c)
    Llama-2-7B's widths at 1 of 32 layers, stage 3 (the per-layer
    gather), 2 x 2048: bf16 on fp32 masters, full remat, AdamW, 1 warm-up
    and 2 timed steps each: step time, tokens/s, MFU, peak memory a rank
    (falling with the stage), moment and gradient-accumulator bytes, the
    collectives a step from the comms ledger and their share of the step,
    flash launches (every one on the Hopper kernels, (c)'s at d 128
    too), a finite falling loss, no skipped step, the masters bitwise
    equal on both ranks at stages 1-2; (d) Llama-1b's
    widths and OPT's flag set (OPT-125m's widths) at 1 layer in fp32, one
    step of 2 x 128: stages 1, 2, 3 (OPT: 3) and 2 with qgZ on the card,
    each against the card's stage 0 (losses 1e-5, grad norms 1e-4, the
    masters within 1e-6 but for Adam's near-eps elements; qgZ not) and
    against the same stage on the host ranks (the same tolerances, qgZ's
    loss 1e-4 and its masters by the compressed facade's rule), the
    quantizer's launches under qgZ. The host ranks run after the phase,
    beside phase 10 (:func:`_zero_host_start` / :func:`_zero_host_finish`):
    the card's (a)-(c) no longer wait for them."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    rng = np.random.default_rng(41)
    ids = {key: rng.integers(0, TRAIN_SPAN, (rows, seq))
           for key, (_, _, rows, seq, _, _) in ZERO_RUNS.items()}
    ids["d"] = rng.integers(0, 32000, ZERO_PARITY_ROWS)
    tmp = tempfile.mkdtemp(prefix="dst_zero_")
    try:
        res = _join_ranks(*_start_ranks(ZERO_WORLD, "cuda", "zero",
                                        (ids, tmp)), timeout=900)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    ok, launches, wgmma, step = _zero_timed_checks(res, card)
    # rows 2-4 at (c)'s micro-batch on a rank (d 128)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    c = _zero_model_config("llama7b")
    rows, seq = ZERO_RUNS["c"][2:4]
    flash = _flash_train_shapes(
        flush, [("zero3_llama7b", rows // ZERO_WORLD, seq, c.n_heads, True,
                 c.head_dim)], "8d")["zero3_llama7b"]
    del flush
    seconds = time.perf_counter() - t0
    log(f"zero train: phase 8d in {seconds:.1f} s (predicted "
        f"{ZERO_PREDICTED_S:g} s; (d)'s host runs follow, behind phase 10)")
    if not ok:
        shutil.rmtree(tmp, ignore_errors=True)
        raise SystemExit("phase 8d: ZeRO training failed")
    return {"launches": launches, "wgmma_launches": wgmma,
            "quant_launches": res[0]["d"][("llama", 2, True)][
                "quant_launches"],
            "flash": flash, "step_s": step, "seconds": seconds,
            "host": {"ids": ids, "tmp": tmp, "res": res}}


def _zero_host_start(zero: dict) -> dict:
    """8d (d)'s host ranks, started beside phase 10 (which reads no
    time; its pinned cpu ranks share the host's cores with them)."""
    h = zero["host"]
    h["t0"] = time.perf_counter()
    h["ranks"] = _start_ranks(ZERO_WORLD, "cpu", "zero",
                              (h["ids"], h["tmp"]), pin=False,
                              threads=ZERO_HOST_THREADS)
    return h


def _zero_host_finish(h: dict, card: str) -> None:
    """8d (d)'s host comparison once its ranks are done: each card run's
    masters against the host's run of the same stage, and the lines
    :func:`_zero_parity_checks` prints."""
    import shutil

    try:
        res_cpu = _join_ranks(*h["ranks"], timeout=900)
        host_s = time.perf_counter() - h["t0"]
        res, tmp = h["res"], h["tmp"]
        for key in ZERO_PARITY_HOST:
            load = functools.partial(torch.load, map_location="cuda")
            full = load(_zero_host_file(tmp, key, "card"))
            host = load(_zero_host_file(tmp, key))
            res[0]["d"][key]["host_weights"] = (
                _zero_facade(full, host) if key[2] else _zero_weights(
                    full, host, load(_zero_host_file(
                        tmp, (key[0], 0, False), "card_lo"))))
            del full, host
    finally:
        shutil.rmtree(h["tmp"], ignore_errors=True)
    log(f"zero train (d): the host ranks' {len(ZERO_PARITY_HOST)} runs "
        f"done in {host_s:.1f} s beside phase 10 ({ZERO_HOST_THREADS} "
        f"threads a rank)")
    ok = _zero_parity_checks(res, res_cpu, card)
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("phase 8d (d): ZeRO against the host ranks failed")


# ------------------------------------------------------ phase 3 (fused)
def _exact_payload(gen, k, b, bits, block):
    """A payload whose dequantized weight is integer levels times powers
    of two (scales 2^e), so every product with integer h is exact."""
    qmax = 2 ** (bits - 1) - 1
    q = torch.randint(-qmax - 1, qmax + 1, (k * b,), generator=gen,
                      device="cuda").to(torch.int8)
    e = torch.randint(-2, 2, (k * b // block,), generator=gen,
                      device="cuda").float()
    return (fc.pack_int4(q) if bits == 4 else q), torch.pow(2.0, e)


def _rand_payload(gen, k, b, bits, block):
    w = torch.randn((k, b), generator=gen, device="cuda")
    q, s = qk.quantize_blockwise_reference(w, bits, block)
    return (fc.pack_int4(q) if bits == 4 else q.reshape(-1)), s


def _fused_case(name, got, ref, exact) -> float:
    """Max abs error; bitwise equality in the exact (integer-valued) cases,
    else within FUSED_REL of the plain version's largest magnitude."""
    err = (got.float() - ref.float()).abs().max().item()
    if exact:
        ok = torch.equal(got, ref)
        tol = "bitwise"
    else:
        ok = err <= FUSED_REL * ref.float().abs().max().item()
        tol = f"{FUSED_REL} x max|plain|"
    ok = ok and bool(torch.isfinite(got.float()).all())
    log(f"fused: {name}: max abs err {err:.3e} ({tol}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"fused kernel disagrees with its plain version: "
                         f"{name}")
    return err


def _quantize_case(name, a, b, bits, block, trans_a, exact) -> float:
    """matmul_quantize against its plain version: on integer operands
    payload and scales bitwise; else scales within 1e-5 relative and the
    payload levels equal where the scales are, entries one level away
    counted (never more than one)."""
    p, s = fc.matmul_quantize(a, b, bits=bits, block=block, trans_a=trans_a)
    rp, rs = fc.matmul_quantize_reference(a, b, bits=bits, block=block,
                                          trans_a=trans_a)
    torch.cuda.synchronize()
    lv = (fc.unpack_int4(p) if bits == 4 else p).int()
    rlv = (fc.unpack_int4(rp) if bits == 4 else rp).int()
    moved = int((lv != rlv).sum())
    same = torch.repeat_interleave(s == rs, block)
    if exact:
        ok = torch.equal(p, rp) and torch.equal(s, rs)
        what = "payload and scales bitwise"
    else:
        ok = (bool(((s - rs).abs() <= 1e-5 * rs.abs()).all())
              and int((lv - rlv).abs().max()) <= 1
              and moved <= max(1, lv.numel() // 1000))
        what = (f"scales within 1e-5 rel, {moved} of {lv.numel()} levels "
                f"one apart ({int((lv[same] != rlv[same]).sum())} where the "
                f"scales are equal: summation order)")
    log(f"fused: {name}: {what} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"matmul_quantize disagrees with its plain "
                         f"version: {name}")
    return float((s - rs).abs().max())


def _path_quantize_case(name, got, ref, bits, block) -> float:
    """matmul_quantize against its plain version at the path's shape:
    scales within 1e-5 relative, no level more than one apart, and at most
    FUSED_LEVELS_APART of the levels one apart. Returns the scales' max
    abs difference."""
    (p, s), (rp, rs) = got, ref
    lv = (fc.unpack_int4(p) if bits == 4 else p).int()
    rlv = (fc.unpack_int4(rp) if bits == 4 else rp).int()
    apart = int((lv != rlv).sum())
    gap = int((lv - rlv).abs().max())
    limit = int(FUSED_LEVELS_APART * lv.numel())
    scale_rel = ((s - rs).abs() / rs.abs()).max().item()
    same = torch.repeat_interleave(s == rs, block)
    ok = scale_rel <= 1e-5 and gap <= 1 and apart <= limit
    log(f"fused: {name}: scales max rel {scale_rel:.2e} (<= 1e-5), {apart} "
        f"of {lv.numel()} levels one apart (<= {limit}; "
        f"{int((lv[same] != rlv[same]).sum())} where the scales are equal: "
        f"summation order), max gap {gap} (<= 1) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"matmul_quantize disagrees with its plain version: "
                         f"{name}")
    return float((s - rs).abs().max())


def _old_path(wrapper, before: int, name: str) -> None:
    """The case took the mma.sync / FMA kernels: the wrapper's Hopper count
    did not move."""
    if wrapper.wgmma_launches != before:
        raise SystemExit(f"{name}: took the Hopper kernel, expected the "
                         f"mma.sync / FMA kernels")


def _wgmma_cases(gen) -> dict:
    """Rows 7 and 8 on the Hopper kernel (TMA + wgmma) against their plain
    versions: bf16 and fp16, dense and int8/int4 weights at blocks 256, 64
    and 96, m 1 / 77 / 333, n 320 / 1376, k 520 / 528 (not multiples of the
    64-deep stage) and 4096; random operands within FUSED_REL, integer-
    valued ones bitwise; each case run twice (bitwise equal) and once into
    the column slice [:, n:] of a NaN-filled [m, 2n] output (bitwise the
    contiguous result, the other columns untouched), all three launches
    counted on the wrapper's ``.wgmma_launches``. Returns the largest
    random-case error per row."""
    errs = {"dequant_matmul": 0.0, "matmul_pallas": 0.0}
    cases = 0
    for dtype in (torch.bfloat16, torch.float16):
        dn = str(dtype)[6:]
        for m, k, n in WGMMA_SHAPES:
            for bits, block in WGMMA_WEIGHTS:
                if bits is not None and (k * n) % block:
                    continue
                for exact in (False, True):
                    if exact:
                        h = torch.randint(-3, 4, (m, k), generator=gen,
                                          device="cuda").to(dtype)
                    else:
                        h = torch.randn((m, k), generator=gen,
                                        device="cuda").to(dtype)
                    if bits is None:
                        name = "matmul_pallas"
                        w = (torch.randint(-3, 4, (k, n), generator=gen,
                                           device="cuda") if exact else
                             torch.randn((k, n), generator=gen,
                                         device="cuda")).to(dtype)
                        kern = lambda out=None: fc.matmul_pallas(h, w,
                                                                 out=out)
                        ref = fc.matmul_reference(h, w)
                        what = f"{dn} dense"
                    else:
                        name = "dequant_matmul"
                        pl, sc = (_exact_payload if exact else _rand_payload)(
                            gen, k, n, bits, block)
                        kw = dict(bits=bits, block=block, b=n, w_dtype=dtype)
                        kern = lambda out=None: fc.dequant_matmul(
                            h, pl, sc, out=out, **kw)
                        ref = fc.dequant_matmul_reference(h, pl, sc, **kw)
                        what = f"{dn} int{bits} block {block}"
                    wrapper = FUSED_KERNELS[name][0]
                    before = wrapper.wgmma_launches
                    got, again = kern(), kern()
                    wide = torch.full((m, 2 * n), float("nan"),
                                      device="cuda")
                    tile = kern(out=wide[:, n:])
                    torch.cuda.synchronize()
                    moved = wrapper.wgmma_launches - before
                    err = _fused_case(
                        f"{name} [wgmma] {what} m {m} k {k} n {n}"
                        f"{' integer-valued' if exact else ''}", got, ref,
                        exact)
                    if not exact:
                        errs[name] = max(errs[name], err)
                    good = (moved == 3 and torch.equal(again, got)
                            and tile.data_ptr() == wide[:, n:].data_ptr()
                            and torch.equal(tile, got)
                            and bool(torch.isnan(wide[:, :n]).all()))
                    if not good:
                        raise SystemExit(
                            f"{name} [wgmma] {what} m {m} k {k} n {n}: "
                            f"{moved} of 3 launches on the Hopper kernel, "
                            f"reruns / column slice bitwise: "
                            f"{torch.equal(again, got)} / "
                            f"{torch.equal(tile, got)}")
                    cases += 1
    log(f"fused: the Hopper kernel: {cases} cases, each twice bitwise equal "
        f"and into a column slice bitwise the contiguous result, every "
        f"launch counted on .wgmma_launches ok")
    return errs


def _wgmma_quantize_cases(gen) -> float:
    """Row 9 on the Hopper kernel against its plain version: bf16 and
    fp16, trans_a both ways, int8 and int4, WGMMA_QUANT_SHAPES; integer-
    valued operands bitwise, random ones within :func:`_quantize_case`'s
    levels rule; each case run twice more, bitwise equal, all three
    launches counted on ``.wgmma_launches``. Then WGMMA_QUANT_REFUSED on
    the mma.sync kernel. Returns the largest scale error."""
    err, cases = 0.0, 0
    for dtype in (torch.bfloat16, torch.float16):
        dn = str(dtype)[6:]
        for trans_a in (True, False):
            for bits in (8, 4):
                for rows, k, n, block in WGMMA_QUANT_SHAPES:
                    rows -= rows % 8 if trans_a else 0
                    sh_a = (k, rows) if trans_a else (rows, k)
                    for exact in (True, False):
                        mk = ((lambda sh: torch.randint(
                            -3, 4, sh, generator=gen, device="cuda"))
                            if exact else (lambda sh: torch.randn(
                                sh, generator=gen, device="cuda")))
                        a, b = mk(sh_a).to(dtype), mk((k, n)).to(dtype)
                        what = (f"matmul_quantize [wgmma] {dn} int{bits} "
                                f"block {block} rows {rows} k {k} n {n} "
                                f"trans_a {trans_a}"
                                f"{' integer-valued' if exact else ''}")
                        before = fc.matmul_quantize.wgmma_launches
                        e = _quantize_case(what, a, b, bits, block, trans_a,
                                           exact)
                        if not exact:
                            err = max(err, e)
                        kw = dict(bits=bits, block=block, trans_a=trans_a)
                        y1 = fc.matmul_quantize(a, b, **kw)
                        y2 = fc.matmul_quantize(a, b, **kw)
                        torch.cuda.synchronize()
                        moved = fc.matmul_quantize.wgmma_launches - before
                        if not (moved == 3 and torch.equal(y1[0], y2[0])
                                and torch.equal(y1[1], y2[1])):
                            raise SystemExit(
                                f"{what}: {moved} of 3 launches on the "
                                f"Hopper kernel, reruns bitwise: "
                                f"{torch.equal(y1[0], y2[0])}")
                        cases += 1
    for rows, k, n, block, trans_a in WGMMA_QUANT_REFUSED:
        sh_a = (k, rows) if trans_a else (rows, k)
        a = torch.randn(sh_a, generator=gen, device="cuda").to(torch.bfloat16)
        b = torch.randn((k, n), generator=gen,
                        device="cuda").to(torch.bfloat16)
        before = fc.matmul_quantize.wgmma_launches
        err = max(err, _quantize_case(
            f"matmul_quantize bf16 int4 block {block} rows {rows} k {k} n "
            f"{n} trans_a {trans_a} (refused by wgmma_quantize_path)", a, b,
            4, block, trans_a, False))
        _old_path(fc.matmul_quantize, before, "matmul_quantize")
    log(f"fused: row 9 on the Hopper kernel: {cases} cases, each twice more "
        f"bitwise equal, every launch counted on .wgmma_launches; "
        f"{len(WGMMA_QUANT_REFUSED)} refused cases on the mma.sync kernel "
        f"ok")
    return err


def _converter_share(h, pl, sc, n, flush) -> dict:
    """Row 7's time at the path's shape on the kernel and on two scratch
    builds (DST_FC_CONVERTER in the source): the converter's stores off,
    and the converter idle (what the TMA + wgmma pipeline alone takes).
    Timed in turns: kernel, stores off, idle, idle, stores off, kernel."""
    m, k = h.shape
    y = torch.empty((m, n), dtype=torch.float32, device="cuda")
    libs = {"kernel": fc._library(),
            "stores off": fc._library({"DST_FC_CONVERTER": 1}),
            "idle": fc._library({"DST_FC_CONVERTER": 0})}

    def call(lib):
        def f():
            err = lib.dst_fc_dequant_matmul_wgmma(
                h.data_ptr(), pl.data_ptr(), sc.data_ptr(), y.data_ptr(), m,
                n, k, n, 8, 256, 2, torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"converter variant launch failed: {err}")
        return f

    order = ["kernel", "stores off", "idle", "idle", "stores off", "kernel"]
    times = {key: [] for key in libs}
    for key in order:
        times[key].append(cuda_ms(call(libs[key]), 10, flush))
    res = {key: min(v) for key, v in times.items()}
    log(f"fused: dequant_matmul converter share at the path's shape (int8, "
        f"block 256): kernel {res['kernel']:.4f} ms, converter stores off "
        f"{res['stores off']:.4f} ms, converter idle {res['idle']:.4f} ms "
        f"(runs: " + ", ".join(f"{key} " + "/".join(f"{t:.4f}" for t in v)
                               for key, v in times.items())
        + f"); the converter adds "
        f"{res['kernel'] - res['idle']:.4f} ms to the pipeline's "
        f"{res['idle']:.4f}")
    return res


def phase_fused_kernels(flush: torch.Tensor) -> dict:
    """Rows 7-9 against their plain versions on the card. The mma.sync /
    FMA kernels: fp32 and bf16 shapes the Hopper kernel does not take,
    bits 8 and 4, trans_a both ways, m = 1, a row length the block does not
    divide, and integer-valued cases that must be bitwise equal. The Hopper
    kernel of rows 7 and 8: :func:`_wgmma_cases`; of row 9:
    :func:`_wgmma_quantize_cases`. Then each row timed at the ZeRO-3
    path's shapes beside its bound, its plain version and one PyTorch call
    (cuBLAS, TF32 off): for rows 7 and 8 ``torch.mm`` of the bf16 operands
    with an fp32 output, as the kernels write (for row 7 the product only:
    a yardstick); for row 9 ``torch.matmul`` of the product, bf16 output
    (a yardstick), and PR 4's mma.sync kernel, in turns with the Hopper
    kernel. Every timed launch there must take the Hopper kernel; row 7's
    converter share is timed on scratch builds."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    errs = {n: 0.0 for n in FUSED_KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype)[6:]
        # shapes the Hopper kernel does not take: n % 8 != 0 (dense), a
        # payload row of 1368 bytes (no multiple of 16 / 32: int8 / int4)
        k, nd, nq = 512, 1372, 1368
        for m in (1, 333):
            a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            w = torch.randn((k, nd), generator=gen, device="cuda").to(dtype)
            before = fc.matmul_pallas.wgmma_launches
            errs["matmul_pallas"] = max(errs["matmul_pallas"], _fused_case(
                f"matmul_pallas {dn} m {m} k {k} n {nd}",
                fc.matmul_pallas(a, w), fc.matmul_reference(a, w), False))
            _old_path(fc.matmul_pallas, before, "matmul_pallas")
            for bits in (8, 4):
                pl, sc = _rand_payload(gen, k, nq, bits, 256)
                before = fc.dequant_matmul.wgmma_launches
                errs["dequant_matmul"] = max(
                    errs["dequant_matmul"], _fused_case(
                        f"dequant_matmul {dn} int{bits} m {m} k {k} b {nq}",
                        fc.dequant_matmul(a, pl, sc, bits=bits, block=256,
                                          b=nq, w_dtype=dtype),
                        fc.dequant_matmul_reference(a, pl, sc, bits=bits,
                                                    block=256, b=nq,
                                                    w_dtype=dtype), False))
                _old_path(fc.dequant_matmul, before, "dequant_matmul")
        # exact: integer h, integer levels with power-of-two scales
        h = torch.randint(-3, 4, (77, 256), generator=gen,
                          device="cuda").to(dtype)
        before = fc.dequant_matmul.wgmma_launches
        for bits in (8, 4):
            pl, sc = _exact_payload(gen, 256, 328, bits, 256)
            _fused_case(f"dequant_matmul {dn} int{bits} integer-valued",
                        fc.dequant_matmul(h, pl, sc, bits=bits, block=256,
                                          b=328, w_dtype=dtype),
                        fc.dequant_matmul_reference(h, pl, sc, bits=bits,
                                                    block=256, b=328,
                                                    w_dtype=dtype), True)
        _old_path(fc.dequant_matmul, before, "dequant_matmul")
        wi = torch.randint(-3, 4, (256, 324), generator=gen,
                           device="cuda").to(dtype)
        before = fc.matmul_pallas.wgmma_launches
        _fused_case(f"matmul_pallas {dn} integer-valued",
                    fc.matmul_pallas(h, wi), fc.matmul_reference(h, wi), True)
        _old_path(fc.matmul_pallas, before, "matmul_pallas")
        # shapes the Hopper kernel refuses (k 388 and, under trans_a, 202
        # rows: no whole 16-byte strides; n 320: no whole 256-blocks, the
        # second pass)
        for bits in (8, 4):
            for rows, kc, n, trans_a in ((1, 388, 512, False),
                                         (202, 384, 768, True),
                                         (64, 96, 320, False),
                                         (64, 96, 320, True)):
                sh_a = (kc, rows) if trans_a else (rows, kc)
                for exact in (True, False):
                    if exact:
                        a = torch.randint(-3, 4, sh_a, generator=gen,
                                          device="cuda").to(dtype)
                        b = torch.randint(-3, 4, (kc, n), generator=gen,
                                          device="cuda").to(dtype)
                    else:
                        a = torch.randn(sh_a, generator=gen,
                                        device="cuda").to(dtype)
                        b = torch.randn((kc, n), generator=gen,
                                        device="cuda").to(dtype)
                    before = fc.matmul_quantize.wgmma_launches
                    e = _quantize_case(
                        f"matmul_quantize {dn} int{bits} rows {rows} k {kc} "
                        f"n {n} trans_a {trans_a}"
                        f"{' integer-valued' if exact else ''}",
                        a, b, bits, 256, trans_a, exact)
                    _old_path(fc.matmul_quantize, before, "matmul_quantize")
                    errs["matmul_quantize"] = max(errs["matmul_quantize"], e)
    for _ in range(2):   # the same inputs twice: bitwise the same
        y1 = fc.matmul_quantize(a, b, bits=4, block=256, trans_a=True)
        y2 = fc.matmul_quantize(a, b, bits=4, block=256, trans_a=True)
        if not (torch.equal(y1[0], y2[0]) and torch.equal(y1[1], y2[1])):
            raise SystemExit("matmul_quantize: two runs differ")
    for name, e in _wgmma_cases(gen).items():
        errs[name] = max(errs[name], e)
    errs["matmul_quantize"] = max(errs["matmul_quantize"],
                                  _wgmma_quantize_cases(gen))

    # timing at the ZeRO-3 path's shapes: block 0's fused forward tile
    # (h [2048, 4096] x its [4096, 5504] shard) and its weight gradient
    # (h^T [4096, 2048] x g [2048, 11008] -> int4)
    m, k, bsh, n = 2048, 4096, 5504, 11008
    h = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((k, bsh), generator=gen, device="cuda") * 0.05) \
        .to(torch.bfloat16)
    pl, sc = qk.quantize_blockwise(w.reshape(-1).float(), bits=8, block=256)
    g = torch.randn((m, n), generator=gen, device="cuda").to(torch.bfloat16)
    fns = {
        "dequant_matmul": (
            lambda out=None: fc.dequant_matmul(h, pl, sc, bits=8, block=256,
                                               b=bsh, w_dtype=torch.bfloat16,
                                               out=out),
            lambda: fc.dequant_matmul_reference(h, pl, sc, bits=8, block=256,
                                                b=bsh,
                                                w_dtype=torch.bfloat16),
            lambda: torch.mm(h, w, out_dtype=torch.float32),
            2.0 * m * k * bsh,
            h.numel() * 2 + pl.numel() + sc.numel() * 4 + m * bsh * 4),
        "matmul_pallas": (
            lambda out=None: fc.matmul_pallas(h, w, out=out),
            lambda: fc.matmul_reference(h, w),
            lambda: torch.mm(h, w, out_dtype=torch.float32),
            2.0 * m * k * bsh, h.numel() * 2 + w.numel() * 2 + m * bsh * 4),
        "matmul_quantize": (
            lambda: fc.matmul_quantize(h, g, bits=4, block=256, trans_a=True),
            lambda: fc.matmul_quantize_reference(h, g, bits=4, block=256,
                                                 trans_a=True),
            lambda: torch.matmul(h.t(), g),
            2.0 * m * k * n,
            h.numel() * 2 + g.numel() * 2 + k * n // 2 + k * n // 256 * 4),
    }
    # the kernel row 9 had before (PR 4's mma.sync tile loop with the
    # quantize epilogue), called through its own entry at the same shape
    mq_out = (torch.empty(k * n // 2, dtype=torch.uint8, device="cuda"),
              torch.empty(k * n // 256, dtype=torch.float32, device="cuda"))

    def mma_quantize():
        err = fc._library().dst_fc_matmul_quantize(
            h.data_ptr(), g.data_ptr(), mq_out[0].data_ptr(),
            mq_out[1].data_ptr(), 0, k, n, m, 1, 4, 256, 2,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"mma.sync matmul_quantize launch failed: {err}")
    # the ring's gathered output at world 2: [m, 2 * bsh] fp32, each tile a
    # column slice (row stride 2 * bsh), NaN where no tile was written
    gathered = torch.empty((m, 2 * bsh), dtype=torch.float32, device="cuda")
    res = {}
    for name, (kern, plain, lib, ops, nbytes) in fns.items():
        wrapper = FUSED_KERNELS[name][0]
        hopper = wrapper.wgmma_launches
        old = mma_quantize if name == "matmul_quantize" else None
        p1 = cuda_ms(plain, 3, flush)
        k1 = cuda_ms(kern, 10, flush)
        o1, o2 = (cuda_ms(old, 10, flush), cuda_ms(old, 10, flush)) if old \
            else (None, None)
        k2 = cuda_ms(kern, 10, flush)
        p2 = cuda_ms(plain, 3, flush)
        lib_ms = cuda_ms(lib, 10, flush)
        path = FUSED_PATH[name]
        if wrapper.wgmma_launches - hopper != 24:
            raise SystemExit(f"{name} at the path's shape: "
                             f"{wrapper.wgmma_launches - hopper} of 24 timed "
                             f"launches on the Hopper kernel")
        t_ops = ops / PEAK_OPS_PER_S[torch.bfloat16] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        res[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "library_ms": lib_ms, "max_abs_err": errs[name],
                     "ops": ops, "bytes": nbytes, "path": path}
        r = res[name]
        if name == "matmul_quantize":
            r["mma_sync_ms"] = min(o1, o2)
            got, again = kern(), kern()
            r["max_abs_err"] = max(r["max_abs_err"], _path_quantize_case(
                f"matmul_quantize at the path's shape {FUSED_SHAPES[name]}",
                got, plain(), 4, 256))
            mma_quantize()
            torch.cuda.synchronize()
            good = all(torch.equal(x, y) for x, y in zip(got, again))
            apart = int((fc.unpack_int4(mq_out[0])
                         != fc.unpack_int4(got[0])).sum())
            log(f"fused: matmul_quantize at the path's shape: two runs "
                f"bitwise equal {'ok' if good else 'FAIL'}; levels apart "
                f"from PR 4's mma.sync kernel's: {apart}")
            if not good:
                raise SystemExit("matmul_quantize: two runs differ at the "
                                 "path's shape")
            del got, again
        else:
            got = kern()
            ref = plain()
            r["max_abs_err"] = max(r["max_abs_err"], _fused_case(
                f"{name} at the path's shape {FUSED_SHAPES[name]}", got, ref,
                False))
            gathered.fill_(float("nan"))
            tile = kern(out=gathered[:, bsh:])
            torch.cuda.synchronize()
            good = (tile.data_ptr() == gathered[:, bsh:].data_ptr()
                    and torch.equal(tile, got)
                    and bool(torch.isnan(gathered[:, :bsh]).all()))
            log(f"fused: {name} into the column slice [:, {bsh}:] of the "
                f"gathered fp32 [{m}, {2 * bsh}] output (row stride "
                f"{2 * bsh}): bitwise the contiguous result, the other "
                f"columns untouched {'ok' if good else 'FAIL'}")
            if not good:
                raise SystemExit(f"{name}: the column-slice output differs")
            del got, ref, tile
        log(f"fused: {name} {FUSED_SHAPES[name]} [{path}]: kernel "
            f"{k1:.4f}/{k2:.4f} ms ({ops / r['ms'] / 1e9:.1f} TFLOP/s), "
            + (f"PR 4's mma.sync kernel {o1:.4f}/{o2:.4f} ms, " if old else "")
            + f"plain {p1:.4f}/{p2:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {ops:.3e} ops, {nbytes} B), library "
            f"{lib_ms:.4f} ms ({ops / lib_ms / 1e9:.1f} TFLOP/s; "
            f"{FUSED_LIBRARY[name]})")
    res["dequant_matmul"]["converter"] = _converter_share(h, pl, sc, bsh,
                                                          flush)
    return res


# ----------------------------------------- phases 10-11: ZeRO-3, 2 ranks
def _rank_entry(rank: int, world: int, port: int, device: str, job: str,
                args: tuple, out, pin: bool = True, threads: int = 2) -> None:
    """One rank process: join the gloo group, run ``job``, send back its
    result (or the traceback). A cpu rank computes the reference of
    phase 10: with ``pin`` (the default) its parent started it under
    ``cpu_pin.pinned_env`` (capability, MKL path, threads) and it fails
    unless it runs under exactly those; each rank reports what it ran
    under. ``pin=False`` (the probe) only sets ``threads``."""
    import traceback

    try:
        from deepspeed_tpu_torch.comm import comm
        from deepspeed_tpu_torch.utils import cpu_pin

        if device == "cpu" and pin:
            cpu_pin.pin_threads()
            ran = cpu_pin.check_pinned()
        else:
            torch.set_num_threads(threads)
            ran = {"capability": torch.backends.cpu.get_cpu_capability(),
                   "mkl_cbwr": os.environ.get("MKL_CBWR"),
                   "threads": torch.get_num_threads()}
        if rank == 0:
            print(f"[chip_smoke] {device} ranks run under {ran}", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        comm.init_distributed("gloo", init_method=f"tcp://127.0.0.1:{port}",
                              world_size=world, rank=rank, timeout_s=600)
        out.put((rank, "ok", RANK_JOBS[job](rank, world, device, *args)))
        comm.barrier()
        comm.destroy()
    except BaseException:  # noqa: BLE001 — reported to the parent
        out.put((rank, "error", traceback.format_exc()))


def _start_ranks(world: int, device: str, job: str, args: tuple,
                 env: Optional[dict] = None, pin: bool = True,
                 threads: int = 2):
    """Spawn ``world`` rank processes. Cpu ranks start under
    ``cpu_pin.pinned_env`` (set here, in the parent: ATen reads its
    capability when the child imports torch) unless ``pin`` is False;
    ``env`` adds variables for the children (the probe's capability)."""
    import socket
    import torch.multiprocessing as mp
    from deepspeed_tpu_torch.utils import cpu_pin

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(r, world, port, device, job, args, q, pin,
                               threads))
             for r in range(world)]
    pinned = (cpu_pin.pinned_env({}) if device == "cpu" and pin else {})
    extra = {**pinned, **(env or {})}
    old = {k: os.environ.get(k) for k in extra}
    os.environ.update(extra)
    try:
        for p in procs:
            p.start()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return procs, q


def _join_ranks(procs, q, timeout: float) -> list:
    """Every rank's result within ``timeout`` seconds; a failed or silent
    rank kills them all and fails the script. Every join has a timeout."""
    import queue as queue_mod

    deadline = time.monotonic() + timeout
    got = {}
    try:
        while len(got) < len(procs):
            left = deadline - time.monotonic()
            if left <= 0:
                raise SystemExit(f"ranks {sorted(set(range(len(procs))) - set(got))} "
                                 f"did not finish in {timeout} s")
            try:
                rank, status, value = q.get(timeout=min(left, 5))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in got]
                if dead:
                    raise SystemExit(f"ranks {dead} exited without a result")
                continue
            if status != "ok":
                raise SystemExit(f"rank {rank} failed:\n{value}")
            got[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 10))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
    return [got[r] for r in range(len(procs))]


def _zero3_config(enabled: bool, backend: str, dtype: str, rows: int,
                  lr: float) -> dict:
    cfg = {"train_batch_size": rows, "steps_per_print": 1000,
           "optimizer": {"type": "adamw", "params": {"lr": lr}},
           "zero_optimization": {"stage": 3,
                                 "stage3_param_persistence_threshold": 0},
           "comm_compression": {"enabled": enabled, "weight_bits": 8,
                                "grad_bits": 4, "overlap": "staged",
                                "kernel_backend": backend}}
    if dtype == "bf16":
        cfg["bf16"] = {"enabled": True}
    return cfg


def _zero3_batch(dims, rows: int, dtype, device: str) -> dict:
    gen = torch.Generator().manual_seed(7)
    return {"x": torch.randn((rows, dims[0]), generator=gen).to(device, dtype),
            "y": torch.randn((rows, dims[-1]), generator=gen).to(device,
                                                                  dtype)}


def _planted_fault(fault, payload):
    """A wrong quantized gradient payload (int4, packed), for the controls
    that the parity limits must fail: ``"pair_order"`` swaps the two
    nibbles of every byte (element 2i in the high nibble); ``"one_level"``
    moves every 64th level one up (one down at the top level, 7)."""
    from deepspeed_tpu_torch.ops.quantizer import pack_int4, unpack_int4

    if fault == "pair_order":
        return ((payload >> 4) | (payload << 4)).to(torch.uint8)
    q = unpack_int4(payload).clone()
    pick = q[::64]
    q[::64] = torch.where(pick >= 7, pick - 1, pick + 1)
    return pack_int4(q)


def _job_parity(rank, world, device, dims, runs, steps):
    """Small-width ZeRO-3 runs from the seed-made weights: per run, the
    losses, grad norms, the facade counters, and on rank 0 the full
    weights after each step and, per step, the int4 gradient levels this
    rank put on the wire in each quantized reduction's two hops: its
    contribution (first hop) and its re-quantized reduced chunk (second
    hop). A run with a fault plants it in the first hop's payloads (a
    control)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import compressed as cc
    from deepspeed_tpu_torch.ops.quantizer import unpack_int4
    from deepspeed_tpu_torch.parallel.zero import SequentialBlockModel
    from deepspeed_tpu_torch.telemetry.registry import (MetricsRegistry,
                                                        set_registry)

    batch = _zero3_batch(dims, 32, torch.float32, device)
    exchange, quantize = cc.quantized_chunk_exchange, cc._quantize
    out = {}
    for name, enabled, backend, fault in runs:
        sent = []

        def tapped(payload, s, **kw):
            if fault is not None:
                payload = _planted_fault(fault, payload)
            if kw["qspec"].bits != 4:
                return exchange(payload, s, **kw)
            hops = sent[-1]
            hops[0].append(unpack_int4(payload).cpu().numpy())

            def requantized(flat, spec, stats):
                p2, s2 = quantize(flat, spec, stats)
                hops[1].append(unpack_int4(p2).cpu().numpy())
                return p2, s2

            cc._quantize = requantized
            try:
                return exchange(payload, s, **kw)
            finally:
                cc._quantize = quantize

        reg = set_registry(MetricsRegistry())
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=SequentialBlockModel(dims, seed=0, device="cpu"),
            config=_zero3_config(enabled, backend, "fp32", 32, 1e-2),
            device=device)
        losses, norms, params = [], [], []
        cc.quantized_chunk_exchange = tapped
        try:
            for _ in range(steps):
                sent.append(([], []))
                m = engine.train_batch(batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                full = engine.full_params()
                params.append({n: p.cpu().numpy() for n, p in full.items()})
        finally:
            cc.quantized_chunk_exchange = exchange
        out[name] = {"losses": losses, "norms": norms,
                     "fused": reg.counter("comm/facade/fused").value,
                     "fallbacks": reg.counter("comm/facade/fallbacks").value,
                     "params": params if rank == 0 else None,
                     "levels": sent if rank == 0 else None}
    return out


def _job_train(rank, world, device, dims, runs, rows, warm, timed):
    """Full-width ZeRO-3 training: per run, ``warm`` steps, the kernel
    counts set to 0, ``timed`` steps, the counts read; the compressed fused
    run then profiles one more step."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.parallel.zero import SequentialBlockModel

    model = SequentialBlockModel(dims, seed=0, device="cpu")
    batch = _zero3_batch(dims, rows, torch.bfloat16, device)
    counted = {**{n: w for n, (w, *_) in FUSED_KERNELS.items()},
               "quantize_blockwise": qk.quantize_blockwise,
               "dequantize_blockwise": qk.dequantize_blockwise}
    out = {}
    for name, enabled, backend in runs:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=model, config=_zero3_config(enabled, backend, "bf16", rows,
                                              1e-3), device=device)
        built = time.perf_counter() - t0
        losses, times = [], []
        for i in range(warm + timed):
            if i == warm:
                for w in counted.values():
                    w.launches = 0
                    if hasattr(w, "wgmma_launches"):
                        w.wgmma_launches = 0
            t1 = time.perf_counter()
            m = engine.train_batch(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            losses.append(float(m["loss"]))
        launches = {n: w.launches for n, w in counted.items()}
        wgmma = {n: w.wgmma_launches for n, w in counted.items()
                 if hasattr(w, "wgmma_launches")}
        res = {"losses": losses, "times": times, "launches": launches,
               "wgmma_launches": wgmma,
               "built_s": built,
               "peak": torch.cuda.max_memory_allocated(),
               "transport": torch.distributed.get_backend()}
        if name == "compressed_fused":
            res["profile"] = _profile_zero3_step(engine, batch)
        out[name] = res
        del engine
    return out


def _profile_zero3_step(engine, batch) -> dict:
    """One train_batch under torch.profiler: device time by kernel group
    and the device's idle share of the step's wall time (this rank)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_batch(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def group(n: str) -> str:
        # mma_kernel<T, Tile<BM, BN, ..>, TRANS_A, MODE, QUANT, VEC>: the
        # quantize epilogue's QUANT is true; MODE 0 is the dense twin; the
        # Hopper kernel is wgmma_kernel<T, MODE, TRANS_A, QBITS>, QBITS > 0
        # for row 9
        mma = re.search(r"mma_kernel<[^,]+, [^>]+>, (\w+), (\d), (\w+)", n)
        hop = re.search(r"wgmma_kernel<[^,]+, (\d), \w+, (\d)>", n)
        return ("matmul_quantize" if hop and hop.group(2) != "0"
                else "matmul_pallas" if hop and hop.group(1) == "0"
                else "dequant_matmul" if hop
                else "matmul_quantize" if mma and mma.group(3) == "true"
                else "matmul_pallas" if mma and mma.group(2) == "0"
                else "dequant_matmul" if mma
                else "dequantize" if "dequantize_kernel" in n
                else "quantize" if "quantize_kernel" in n
                else "memcpy" if "memcpy" in n
                else "gemm" if any(x in n for x in ("nvjet", "gemm", "xmma",
                                                     "cutlass", "cublas"))
                else "other")

    d = _device_groups(prof, group, wall)
    return {"wall_s": wall, "busy_s": d["busy_us"] / 1e6,
            "idle_share": d["idle_share"], "launches": d["launches"],
            "events_s": d["events_us"] / 1e6,
            "groups_ms": {g: us / 1e3 for g, us in d["groups"].items()},
            "top": [(name[:100], us / 1e3, n)
                    for name, us, n in d["by_name"][:8]]}


RANK_JOBS = {"parity": _job_parity, "train": _job_train, "tp": _job_tp,
             "tp_train": _job_tp_train, "zero": _job_zero}
PARITY_DIMS = (64, 256, 512, 64)
ZERO3_DIMS = (4096, 11008, 4096, 11008, 4096)   # Llama-2-7B MLP widths


def _parity_steps(g, c) -> list:
    """Per step, cuda against cpu (rank 0): (weights beyond 1e-5, then per
    hop (int4 gradient levels apart, levels sent), and the largest level
    gap)."""
    out = []
    for i, (gp, cp) in enumerate(zip(g["params"], c["params"])):
        moved = sum(int((np.abs(gp[n] - v) > 1e-5).sum())
                    for n, v in cp.items())
        hops, gap = [], 0
        for gh, ch in zip(g["levels"][i], c["levels"][i]):
            apart = total = 0
            for gl, cl in zip(gh, ch):
                d = np.abs(gl.astype(np.int32) - cl.astype(np.int32))
                apart += int((d > 0).sum())
                total += d.size
                gap = max(gap, int(d.max()))
            hops.append((apart, total))
        out.append((moved, hops, gap))
    return out


def _parity_verdict(g, c, enabled) -> tuple:
    """(within the limits, losses max rel, weights beyond 1e-5 after the
    last step, their limit, the largest weight gap) of a cuda run against
    the cpu run. Limits: dense losses 1e-5 rel, weights 1e-5 abs except at
    most 1 in 10^4 (gradients at Adam's eps scale, where summation order
    decides the update); compressed losses 2e-4 rel, at most 1 in 200
    weights beyond 1e-5 after the first step (only that step's own level
    flips) and 1 in 100 after the last, all within 2 lr a step."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(g["losses"],
                                                        c["losses"]))
    steps = _parity_steps(g, c)
    n_all = sum(v.size for v in c["params"][-1].values())
    worst = max(float(np.abs(g["params"][-1][n] - v).max())
                for n, v in c["params"][-1].items())
    limit = n_all // (100 if enabled else 10_000)
    good = (loss_rel <= (2e-4 if enabled else 1e-5)
            and steps[-1][0] <= limit
            and (not enabled or steps[0][0] <= n_all // 200)
            and worst <= len(steps) * 2 * 1e-2)
    return good, loss_rel, steps, limit, worst, n_all


def phase_zero3_parity() -> None:
    """World 2, one set of rank processes on cuda (both on the one card,
    over gloo) and one on cpu, from the same seed-made weights and batch:
    3 steps of SequentialBlockModel(PARITY_DIMS) in fp32, compressed
    (w8/g4) and dense, each on the fused and the reference backend, within
    :func:`_parity_verdict`'s limits. Compressed, an int4 gradient level
    that lands one apart on the two devices moves its weight by up to 2
    lr, and the moved weights change the next step's gradients, so the
    moved set grows step by step: the phase prints, per step, the levels
    apart and the weights moved. Two controls on cuda plant a fault in the
    fused run's gradient payloads (:func:`_planted_fault`); each must fail
    the compressed limits."""
    t0 = time.perf_counter()
    runs = [(f"{c}_{b}", c == "compressed", b, None)
            for c in ("compressed", "dense") for b in ("pallas", "xla")]
    controls = [(f"control_{f}", True, "pallas", f)
                for f in ("pair_order", "one_level")]
    sets = {dev: _start_ranks(2, dev, "parity",
                              (PARITY_DIMS, runs + (controls if dev == "cuda"
                                                    else []), 3))
            for dev in ("cuda", "cpu")}
    res = {dev: _join_ranks(*sets[dev], timeout=300)[0] for dev in sets}
    ok = True
    for name, enabled, backend, fault in runs + controls:
        g = res["cuda"][name]
        c = res["cpu"]["compressed_pallas" if fault else name]
        within, loss_rel, steps, limit, worst, n_all = _parity_verdict(
            g, c, enabled)
        counters = (g["fused"] == c["fused"]
                    and (g["fused"] > 0) == (backend == "pallas")
                    and (not enabled or g["fallbacks"] > 0))
        good = (not within) if fault else (within and counters)
        ok = ok and good
        per_step = "; ".join(
            f"step {i + 1}: int4 gradient levels apart {h[0][0]} of "
            f"{h[0][1]} (first hop), {h[1][0]} of {h[1][1]} (re-quantized "
            f"chunk), max gap {gap}; {mv} weights beyond 1e-5"
            for i, (mv, h, gap) in enumerate(steps))
        log(f"zero3 parity: {name}: losses cuda {g['losses']} cpu "
            f"{c['losses']} (max rel {loss_rel:.2e}; tol "
            f"{2e-4 if enabled else 1e-5}); weights beyond 1e-5: "
            f"{steps[-1][0]} of {n_all} (<= {limit}"
            f"{f', step 1 <= {n_all // 200}' if enabled else ''}), max "
            f"{worst:.2e}; {per_step}; comm/facade/fused {g['fused']:.0f}, "
            f"fallbacks {g['fallbacks']:.0f}"
            + (f"; a planted fault ({fault}): "
               f"{'rejected' if not within else 'NOT rejected'}"
               if fault else "") + f" {'ok' if good else 'FAIL'}")
    for tag in ("compressed", "dense"):
        f, r = res["cuda"][f"{tag}_pallas"], res["cuda"][f"{tag}_xla"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(f["losses"],
                                                      r["losses"]))
        good = rel <= (2e-4 if tag == "compressed" else 1e-5)
        ok = ok and good
        log(f"zero3 parity: cuda fused vs reference, {tag}: losses max rel "
            f"{rel:.2e} {'ok' if good else 'FAIL'}")
    log(f"zero3 parity: {time.perf_counter() - t0:.1f} s")
    if not ok:
        raise SystemExit("ZeRO-3 parity failed")


def _bf16_ulp(x: float) -> float:
    """The spacing of bf16 values (8 significant bits) at ``x``."""
    return math.ldexp(1.0, math.frexp(abs(x))[1] - 8)


ZERO3_WARM = 1                 # phase 11's warm-up steps a run


def phase_zero3_training(card: str) -> dict:
    """The slice's path at full width: SequentialBlockModel(ZERO3_DIMS),
    world 2 on the one card over gloo, bf16 compute on fp32 masters, a bf16
    batch of 4096 x 4096 (2048 rows a rank), AdamW lr 1e-3, compressed
    (w8/g4) and dense, each on the fused and the reference backend: 1
    warm-up (2 until PR 24; time) and 4 timed steps with the kernel counts
    set to 0 between them. Every launch of rows 7-9 in a fused run must take the Hopper
    kernel. Returns each fused kernel's launches on rank 0 in the four
    timed steps of the run that takes it, and its launches on the Hopper
    kernel there."""
    t0 = time.perf_counter()
    runs = [(f"{c}_{b}", c == "compressed", "pallas" if b == "fused"
             else "xla") for c in ("compressed", "dense")
            for b in ("fused", "reference")]
    res = _join_ranks(*_start_ranks(2, "cuda", "train",
                                    (ZERO3_DIMS, runs, 4096, ZERO3_WARM, 4)),
                      timeout=900)
    n_params = sum(ZERO3_DIMS[i] * ZERO3_DIMS[i + 1] + ZERO3_DIMS[i + 1]
                   for i in range(len(ZERO3_DIMS) - 1))
    want = {"compressed_fused": {"dequant_matmul": 4, "matmul_pallas": 0,
                                 "matmul_quantize": 2},
            "dense_fused": {"dequant_matmul": 0, "matmul_pallas": 4,
                            "matmul_quantize": 0}}
    ok = True
    for name, *_ in runs:
        for r, rr in enumerate(res):
            x = rr[name]
            falling = x["losses"][-1] < x["losses"][0]
            finite = all(np.isfinite(x["losses"]))
            per_step = {k: v / 4 for k, v in x["launches"].items()}
            hopper = {k: v / 4 for k, v in x["wgmma_launches"].items()}
            counts_ok = all(per_step[k] == v
                            for k, v in want.get(name, {}).items())
            # rows 7-9: every launch on the Hopper kernel
            counts_ok = counts_ok and all(hopper[k] == per_step[k]
                                          for k in hopper)
            if name.endswith("reference"):
                counts_ok = all(per_step[k] == 0 for k in FUSED_KERNELS)
            good = falling and finite and counts_ok
            ok = ok and good
            step = sum(x["times"][ZERO3_WARM:]) / 4
            log(f"zero3 [{card}] {name} rank {r}: losses "
                f"{[round(v, 6) for v in x['losses']]}, step times "
                f"{[round(v, 4) for v in x['times']]} s, timed step (mean "
                f"of four) {step:.4f} s, launches per step {per_step} (on the "
                f"Hopper kernel {hopper}), peak "
                f"{x['peak']} B, built in {x['built_s']:.1f} s, transport "
                f"{x['transport']} (2 ranks on one card) "
                f"{'ok' if good else 'FAIL'}")
    for tag in ("compressed", "dense"):
        f, r = res[0][f"{tag}_fused"], res[0][f"{tag}_reference"]
        ulps = max(abs(a - b) / _bf16_ulp(b) for a, b in zip(f["losses"],
                                                              r["losses"]))
        good = ulps <= ZERO3_LOSS_ULPS
        ok = ok and good
        log(f"zero3 [{card}] {tag}: fused vs reference losses at most "
            f"{ulps:g} bf16 ulps apart (tol {ZERO3_LOSS_ULPS}) "
            f"{'ok' if good else 'FAIL'}")
    prof = res[0]["compressed_fused"]["profile"]
    if prof["busy_s"] > 0:
        log(f"zero3 profile [{card}] compressed fused rank 0: wall "
            f"{prof['wall_s']:.3f} s, {prof['launches']} kernel launches "
            f"(distinct spans), device busy {prof['busy_s']:.3f} s covered "
            f"(events summed {prof['events_s']:.3f} s), idle share "
            f"{prof['idle_share']:.3f}; device time covered " + ", ".join(
                f"{g} {ms:.1f} ms" for g, ms in prof["groups_ms"].items()))
        for key, ms, count in prof["top"]:
            log(f"zero3 profile: {ms:9.2f} ms x{count:<5d} {key}")
    else:
        log(f"zero3 profile [{card}]: torch.profiler recorded no device "
            f"time: breakdown not measured")
    log(f"zero3: SequentialBlockModel{ZERO3_DIMS} ({n_params} params), "
        f"world 2 over gloo, {time.perf_counter() - t0:.1f} s")
    if not ok:
        raise SystemExit("ZeRO-3 training phase failed")
    # each kernel's launches in the run that takes it: rows 7 and 9 the
    # compressed fused run, row 8 the dense fused run (4 timed steps, rank 0)
    run = {n: res[0]["dense_fused" if n == "matmul_pallas"
                     else "compressed_fused"] for n in FUSED_KERNELS}
    return ({n: run[n]["launches"][n] for n in FUSED_KERNELS},
            {n: run[n]["wgmma_launches"][n] for n in FUSED_KERNELS
             if n in run[n]["wgmma_launches"]})


# ---------------------------------------------------------------- phase 12
CKPT_LAYERS = 4                # (a): TinyLlama-1.1B's 22 layers cut (time)
CKPT_ROWS = (2, 2048)          # (a): micro-batch rows x tokens, GAS 2
CKPT_GAS = 2
CKPT_STEPS = 4
CKPT_HF_LAYERS = 2             # (b): Llama-2-7B's 32 layers cut
CKPT_HF_NEW = 16               # (b): new tokens a request
CKPT_HF_SHARD = 512 << 20      # (b): bytes a shard of the HF export
CKPT_FREE_BYTES = 24 << 30     # the tags, the export and slack
CKPT_PREDICTED_S = 55.0        # stated in PERF.md before the first run


def _ckpt_engine(ids, save_dir: Optional[str] = None, **ck):
    """(a)'s trainer: ``llama_config("1b")``'s widths at ``CKPT_LAYERS``
    layers from seed 12, fp32 masters (the model's own weights) with bf16
    compute, AdamW, clip 1.0, GAS 2, fed by a bound loader over ``ids``;
    ``ck`` is the ``checkpoint`` block under ``save_dir``."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import Llama

    cfg = {"train_batch_size": CKPT_ROWS[0] * CKPT_GAS,
           "gradient_accumulation_steps": CKPT_GAS,
           "bf16": {"enabled": True}, "gradient_clipping": 1.0, "seed": 12,
           "steps_per_print": 1000,
           "optimizer": {"type": "adamw",
                         "params": {"lr": 1e-4, "weight_decay": 0.01}}}
    if save_dir is not None:
        cfg["checkpoint"] = {"save_dir": save_dir, **ck}
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=Llama("1b", seed=12, n_layers=CKPT_LAYERS), config=cfg,
        training_data={"input_ids": ids})
    return engine, iter(loader)


def _ckpt_state(e) -> dict:
    """Copies on the card (3.7 GB a copy there; the host would take
    seconds a copy) of everything a resume restores."""
    def copy(tree):
        return {n: t.detach().clone() for n, t in tree.items()}

    return {"params": copy(e.params), "mu": copy(e.opt_state.mu),
            "nu": copy(e.opt_state.nu), "count": e.opt_state.count,
            "scaler": tuple(e.scaler_state), "step": e.global_steps,
            "micro": e.micro_steps, "rng": e.rng.get_state(),
            "loader": e._dataloader.state_dict()}


def _ckpt_diff(a: dict, b: dict) -> dict:
    """Where two states differ: per tree, leaves not bitwise equal and
    the largest |difference|; the scalars that differ."""
    out = {}
    for k in ("params", "mu", "nu"):
        bad = [n for n in a[k] if not torch.equal(a[k][n], b[k][n])]
        if bad:
            out[k] = (len(bad), max(float((a[k][n] - b[k][n]).abs().max())
                                    for n in bad))
    for k in ("count", "scaler", "step", "micro", "loader"):
        if a[k] != b[k]:
            out[k] = (a[k], b[k])
    if not torch.equal(a["rng"], b["rng"]):
        out["rng"] = "differs"
    return out


def _ckpt_gb_s(nbytes: float, s: float) -> str:
    return f"{nbytes / 1e9:.3f} GB in {s:.3f} s = {nbytes / 1e9 / s:.3f} GB/s"


def _ckpt_run(engine, batches, steps: int, at=()) -> tuple:
    """``steps`` training steps: (losses, each auto-save's numbers, the
    state at the steps in ``at``)."""
    losses, saves, states = [], [], {}
    for _ in range(steps):
        losses.append(float(engine.train_batch(next(batches))["loss"]))
        step = engine.global_steps
        if engine._ckpt_save_dir and step % 2 == 0:
            saves.append(dict(engine.ckpt_engine.last_save))
        if step in at:
            states[step] = _ckpt_state(engine)
    return losses, saves, states


def _ckpt_resume(card: str, tmp: str) -> dict:
    """12 (a): A runs ``CKPT_STEPS`` steps with a save every 2 (tags at
    steps 2 and 4). With A's step-4 tag set aside, R (a fresh
    ``initialize`` with ``auto_resume`` and no auto-save) loads the
    step-2 tag, which must equal A's state at step 2 bit for bit, and
    runs steps 3-4 with its flash launches counted from 0: its losses,
    masters, moments, scaler, step, random stream and loader position
    must equal A's. Bitwise; only were they not would A' (A's steps
    again, no saves) run, to measure the step's own spread on the card,
    and R be held within it. Two planted faults: R's save after step 4 is
    torn (chaos ``before_commit``), and with A's step-4 tag back, one
    byte of it is flipped; auto-resume must fall back each time to the
    previous valid tag, loaded bit for bit."""
    from deepspeed_tpu_torch.resilience import chaos
    from deepspeed_tpu_torch.runtime.checkpoint import find_valid_tag

    ids = np.random.default_rng(12).integers(
        0, 32000, (CKPT_STEPS * CKPT_ROWS[0] * CKPT_GAS, CKPT_ROWS[1]))
    d = os.path.join(tmp, "a")
    last = f"global_step{CKPT_STEPS}"
    ea, it = _ckpt_engine(ids, d, save_interval=2, keep_last_n=2)
    la, saves, sa = _ckpt_run(ea, it, CKPT_STEPS, at=(2, CKPT_STEPS))
    nbytes = saves[0]["bytes"]
    del ea, it
    gc.collect()
    torch.cuda.empty_cache()
    log(f"ckpt (a) [{card}]: A's losses {la}")
    for i, s in enumerate(saves):
        log(f"ckpt (a) save {i + 1} of A [{card}]: "
            f"{_ckpt_gb_s(s['bytes'], s['total_s'])} (write + CRC "
            f"{s['write_s']:.3f} s, commit {s['commit_s']:.3f} s)")
    aside = os.path.join(tmp, "a_last")
    os.rename(os.path.join(d, last), aside)
    t0 = time.perf_counter()
    er, it = _ckpt_engine(ids, d, keep_last_n=2, auto_resume=True)
    init_s = time.perf_counter() - t0
    load = dict(er.last_load)
    round_trip = _ckpt_diff(_ckpt_state(er), sa[2])
    log(f"ckpt (a) load [{card}]: initialize with auto_resume took "
        f"{init_s:.3f} s; the load of tag {load['tag']} "
        f"{_ckpt_gb_s(nbytes, load['s'])}, its CRC pass "
        f"{load['verify_s']:.3f} s ({nbytes / 1e9 / load['verify_s']:.3f} "
        f"GB/s); state against A's at step 2: "
        f"{'bitwise' if not round_trip else round_trip}")
    # steps 3-4, then a save that is torn: the process dies before the
    # commit rename
    _flash_reset()
    lr, _, _ = _ckpt_run(er, it, CKPT_STEPS - 2)
    launches, hopper = _flash_read()
    sr = _ckpt_state(er)
    chaos.install_fault_injector(chaos.FaultInjector(
        crash_before_commit_at_save=1))
    torn = False
    try:
        er.save_checkpoint(d)
    except chaos.InjectedFault:
        torn = True
    finally:
        chaos.install_fault_injector(None)
    want = {n: 2 * k for n, k in
            _flash_per_step([er.model.config], CKPT_GAS).items()}
    diff = _ckpt_diff(sr, sa[CKPT_STEPS])
    same = not diff
    if not same:
        # the step's own spread on the card: A's steps again
        eb, itb = _ckpt_engine(ids)
        lb, _, sb = _ckpt_run(eb, itb, CKPT_STEPS, at=(CKPT_STEPS,))
        del eb, itb
        spread = _ckpt_diff(sb[CKPT_STEPS], sa[CKPT_STEPS])
        same = set(diff) <= set(spread) and all(
            diff[k][1] <= spread[k][1] for k in ("params", "mu", "nu")
            if k in diff)
        log(f"ckpt (a) [{card}]: R is not bitwise A; A' (A's steps again) "
            f"losses {lb}, A vs A' {spread}: R within that spread {same}")
    log(f"ckpt (a) R [{card}]: steps 3-4's losses {lr} (A's {la[2:]}); state "
        f"after step {CKPT_STEPS} against A's: "
        f"{'bitwise' if not diff else diff}; flash launches {launches} "
        f"(expected {want}), on the Hopper kernels {hopper}")
    ok = (not round_trip and load["tag"] == "global_step2" and same
          and lr == la[2:] and launches == want and hopper == launches
          and all(np.isfinite(la)))
    # (i) the torn save: auto-resume falls back to step 2's tag
    er.load_checkpoint(d, auto=True)
    torn_tag = er.last_load["tag"]
    torn_ok = (torn and not os.path.isdir(os.path.join(d, last))
               and torn_tag == "global_step2"
               and not _ckpt_diff(_ckpt_state(er), sa[2]))
    log(f"ckpt (a) torn save [{card}]: R's save after step {CKPT_STEPS} crashed "
        f"before commit {torn}; auto-resume took {torn_tag} "
        f"({er.last_load['s']:.3f} s, CRC {er.last_load['verify_s']:.3f} "
        f"s), state bitwise A's at step 2 {'ok' if torn_ok else 'FAIL'}")
    # (ii) A's step-4 tag back as the newest, one bit of it flipped
    os.rename(aside, os.path.join(d, last))
    newest = find_valid_tag(d, checksums=False)
    victim = os.path.join(d, last, "state", "params.safetensors")
    with open(victim, "r+b") as f:
        f.seek(os.path.getsize(victim) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0x01]))
    er.load_checkpoint(d, auto=True)
    flip_tag = er.last_load["tag"]
    flip_ok = (newest == last and flip_tag == "global_step2"
               and not _ckpt_diff(_ckpt_state(er), sa[2]))
    log(f"ckpt (a) flipped byte [{card}]: one bit of the newest tag's "
        f"{victim[len(tmp) + 1:]} flipped; auto-resume took {flip_tag} "
        f"({er.last_load['s']:.3f} s, two CRC passes "
        f"{er.last_load['verify_s']:.3f} s), state bitwise A's at step 2 "
        f"{'ok' if flip_ok else 'FAIL'}")
    ok = ok and torn_ok and flip_ok
    if not ok:
        raise SystemExit("phase 12 (a): resume failed")
    return {"engine": er, "batches": it, "dir": d, "state2": sa[2],
            "bytes": nbytes, "saves": saves, "load": load,
            "launches": launches, "wgmma_launches": hopper}


def _ckpt_exports(res: dict, card: str, tmp: str) -> None:
    """12 (c), on (a)'s resumed engine R (at A's step-2 state):
    ``get_fp32_state_dict`` and ``save_16bit_model`` (read back) bitwise
    the masters and their bf16 cast, keyed as JAX keys them; then one
    step, and ``hot_swap_checkpoint`` onto the step-2 tag: the weights
    become that tag's again, while the step, moments, scaler, random
    stream and loader position stay."""
    from deepspeed_tpu_torch.checkpoint import safetensors_io as sio
    from deepspeed_tpu_torch.runtime.engine import jax_tree_keys

    er, want = res["engine"], res["state2"]["params"]
    fp32 = er.get_fp32_state_dict()
    fp32_ok = fp32.keys() == want.keys() and all(
        torch.equal(fp32[n], want[n].cpu()) for n in want)
    t0 = time.perf_counter()
    path = er.save_16bit_model(os.path.join(tmp, "export"))
    save16_s = time.perf_counter() - t0
    back = sio.load_file(path)
    ref16 = jax_tree_keys({n: t.bfloat16() for n, t in want.items()})
    b16_ok = back.keys() == ref16.keys() and all(
        torch.equal(back[k], ref16[k].cpu()) for k in ref16)
    er.train_batch(next(res["batches"]))
    before = _ckpt_state(er)
    t0 = time.perf_counter()
    version = er.hot_swap_checkpoint(res["dir"], tag="global_step2")
    torch.cuda.synchronize()
    swap_s = time.perf_counter() - t0
    after = _ckpt_state(er)
    diff = _ckpt_diff(after, before)
    swapped = all(torch.equal(t, want[n]) for n, t in after["params"].items())
    swap_ok = (swapped and set(diff) == {"params"} and version is None
               and after["step"] == 3)
    log(f"ckpt (c) [{card}]: get_fp32_state_dict bitwise the masters "
        f"{fp32_ok}; save_16bit_model {os.path.getsize(path)} B in "
        f"{save16_s:.3f} s, read back bitwise the bf16 cast under JAX's "
        f"keys {b16_ok}; after one more step, hot_swap_checkpoint in "
        f"{swap_s:.3f} s: weights now the step-2 tag's {swapped}, step "
        f"{after['step']}, moments, scaler, stream and loader position "
        f"unchanged {set(diff) == {'params'}} "
        f"{'ok' if fp32_ok and b16_ok and swap_ok else 'FAIL'}")
    if not (fp32_ok and b16_ok and swap_ok):
        raise SystemExit("phase 12 (c): exports failed")


def _ckpt_hf(card: str, tmp: str, prompts) -> dict:
    """12 (b): Llama-2-7B's widths at ``CKPT_HF_LAYERS`` layers, seed 3,
    bf16, exported by ``export_hf_llama`` as a sharded safetensors
    directory and read back by ``from_pretrained`` onto the card (every
    leaf bitwise); then phase 5's 8 requests, ``CKPT_HF_NEW`` new tokens
    each, through ``ServingEngine`` over the loaded model with the paged
    counters from 0 (one launch a layer a put, tile / lane counts), held
    to an engine on the in-memory weights: the first put's logits and the
    streams bitwise; and the v1 engine of ``init_inference(config=
    {"checkpoint": ...})`` against one on the in-memory model."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint import safetensors_io as sio
    from deepspeed_tpu_torch.checkpoint.export import export_hf_llama
    from deepspeed_tpu_torch.checkpoint.hf import from_pretrained
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)
    from deepspeed_tpu_torch.models.llama import Llama

    model = Llama("7b", dtype=torch.bfloat16, seed=3,
                  n_layers=CKPT_HF_LAYERS)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    out = os.path.join(tmp, "hf")
    t0 = time.perf_counter()
    export_hf_llama(model, None, out, max_shard_bytes=CKPT_HF_SHARD)
    export_s = time.perf_counter() - t0
    with open(os.path.join(out, sio.INDEX_FILE)) as f:
        shards = sorted(set(json.load(f)["weight_map"].values()))
    t0 = time.perf_counter()
    loaded, params = from_pretrained(out, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    own = dict(model.named_parameters())
    leaves_ok = params.keys() == own.keys() and all(
        torch.equal(params[n], own[n]) for n in own)
    log(f"ckpt (b) [{card}]: {sum(p.numel() for p in own.values())} "
        f"parameters exported as {len(shards)} shards + index: "
        f"{_ckpt_gb_s(nbytes, export_s)}; from_pretrained onto the card "
        f"{_ckpt_gb_s(nbytes, load_s)}; every leaf bitwise {leaves_ok}")
    cfg = RaggedConfig(n_kv_blocks=REPLICA_PAGES, **REPLICA_SHAPE)
    ref_eng = RaggedInferenceEngine(model, cfg)
    counter = _PutCounter(CKPT_HF_LAYERS)
    got_eng = counter.wrap(RaggedInferenceEngine(loaded, cfg))
    first_ref = _resolve(ref_eng, [1], [prompts[0]])[1]
    first_got = _resolve(got_eng, [1], [prompts[0]])[1]
    ref_eng.flush([1])
    got_eng.flush([1])
    logits_ok = bool(np.array_equal(first_ref, first_got))
    for name in PAGED_PATH_COUNTERS:
        setattr(pa.paged_attention, name, 0)
    counter.steps = {k: 0 for k in counter.steps}
    streams = _serve_once(got_eng, prompts, n=CKPT_HF_NEW)
    torch.cuda.synchronize()
    counts = {n: getattr(pa.paged_attention, n) for n in PAGED_PATH_COUNTERS}
    steps = dict(counter.steps)
    ref = _serve_once(ref_eng, prompts, n=CKPT_HF_NEW)
    del ref_eng, got_eng
    counts_ok = (counts["launches"] == CKPT_HF_LAYERS * steps["put"] > 0
                 and counts["tile_launches"]
                 == CKPT_HF_LAYERS * steps["tile"] > 0
                 and counts["split_launches"]
                 == CKPT_HF_LAYERS * steps["split"] > 0
                 and steps["odd"] == 0)
    streams_ok = streams == ref and all(len(s) == CKPT_HF_NEW
                                        for s in streams)
    log(f"ckpt (b) serving [{card}]: {len(prompts)} requests x "
        f"{CKPT_HF_NEW} new tokens over the loaded checkpoint: first put's "
        f"logits bitwise {logits_ok}; streams identical to the in-memory "
        f"engine's {streams_ok}; paged launches {counts['launches']} "
        f"({CKPT_HF_LAYERS} layers x {steps['put']} puts; tile items in "
        f"{steps['tile']} puts = {counts['tile_launches']} launches, lane "
        f"items in {steps['split']} = {counts['split_launches']})")
    ids = np.random.default_rng(13).integers(1, 32000, (4, 128))
    v1_ref = deepspeed_tpu_torch.init_inference(
        model, {"dtype": "bfloat16", "temperature": 0.0})
    want = v1_ref.generate(ids, max_new_tokens=CKPT_HF_NEW)
    want_logits = v1_ref.forward(ids)
    del v1_ref
    v1 = deepspeed_tpu_torch.init_inference(
        config={"checkpoint": out, "dtype": "bfloat16", "temperature": 0.0})
    got = v1.generate(ids, max_new_tokens=CKPT_HF_NEW)
    v1_ok = bool(np.array_equal(np.asarray(got), np.asarray(want))
                 and torch.equal(v1.forward(ids), want_logits))
    del v1
    log(f"ckpt (b) v1 [{card}]: init_inference(config={{'checkpoint': "
        f"...}}) streams and forward logits bitwise the in-memory "
        f"engine's {v1_ok}")
    ok = (len(shards) >= 2 and leaves_ok and logits_ok and streams_ok
          and counts_ok and v1_ok)
    if not ok:
        raise SystemExit("phase 12 (b): HF checkpoint serving failed")
    return {**counts, "puts": steps["put"], "bytes": nbytes,
            "export_s": export_s, "load_s": load_s}


def phase_checkpoints(card: str, prompts) -> dict:
    """12, checkpoints and recovery: (a) resume, (b) HF in, serving out,
    (c) the exports of (a)'s engine, all under one temporary directory
    (removed at the end) on a disk with ``CKPT_FREE_BYTES`` free."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    log(f"ckpt: phase 12 predicted {CKPT_PREDICTED_S:.0f} s")
    tmp = tempfile.mkdtemp(prefix="dst_ckpt_")
    try:
        free = shutil.disk_usage(tmp).free
        if free < CKPT_FREE_BYTES:
            raise SystemExit(f"phase 12: {free} B free under {tmp}; the "
                             f"checkpoints need {CKPT_FREE_BYTES} B")
        res = _ckpt_resume(card, tmp)
        t_a = time.perf_counter() - t_phase
        _ckpt_exports(res, card, tmp)
        del res["engine"], res["batches"], res["state2"]
        gc.collect()
        torch.cuda.empty_cache()
        t_c = time.perf_counter() - t_phase - t_a
        hf = _ckpt_hf(card, tmp, prompts)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    took = time.perf_counter() - t_phase
    log(f"ckpt: (a) {t_a:.1f} s, (c) {t_c:.1f} s, (b) "
        f"{took - t_a - t_c:.1f} s; phase 12 took {took:.1f} s (predicted "
        f"{CKPT_PREDICTED_S:.0f} s)")
    return {"launches": res["launches"],
            "wgmma_launches": res["wgmma_launches"], "hf": hf,
            "seconds": took}


OFFLOAD_ROWS = (2, 2048)        # rows x tokens a step, GAS 1
OFFLOAD_PARITY_LAYERS = 4       # (a): Llama-2-7B's 32 layers cut (time)
OFFLOAD_FIT_LAYERS = 24         # (b): a resident need above the card's HBM
OFFLOAD_NVME_LAYERS = 2         # (c): TinyLlama-1.1B's 22 layers cut (time)
OFFLOAD_PREDICTED_S = 60.0      # stated in PERF.md before the first run


def _offload_cfg(**zero) -> dict:
    """Phase 13's trainer: bf16 on fp32 masters, AdamW lr 1e-4, clipping
    1.0, ``OFFLOAD_ROWS`` a step; ``zero`` is the ZeRO block."""
    return {"train_batch_size": OFFLOAD_ROWS[0], "gradient_clipping": 1.0,
            "steps_per_print": 1000, "bf16": {"enabled": True}, "seed": 5,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-4, "weight_decay": 0.1}},
            "zero_optimization": {"stage": 1, **zero}}


def _offload_batches(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [{"input_ids": torch.from_numpy(rng.integers(
        0, 32000, OFFLOAD_ROWS)).cuda()} for _ in range(n)]


def _host_memory() -> str:
    with open("/proc/meminfo") as f:
        info = dict(line.split(":", 1) for line in f)
    return ", ".join(f"{k} {info[k].strip()}" for k in ("MemTotal",
                                                         "MemAvailable"))


def _offload_steps(label: str, engine, batches, warm: int) -> dict:
    """``warm`` warm-up steps, then the rest timed, with the flash counts
    set to 0 between them and the peak memory from before the first;
    each timed step's offload copies (``offload_stats``) on an offloaded
    engine. Correct: finite losses and norms, no skipped step, every
    flash launch of the timed steps on the Hopper kernels in the count
    :func:`_flash_per_step` gives."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times, copies, streamed = [], [], [], [], []
    for i, b in enumerate(batches):
        if i == warm:
            _flash_reset()
        t1 = time.perf_counter()
        m = engine.train_batch(b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if bool(m["skipped"]):
            raise SystemExit(f"phase 13: {label}: a skipped step")
        streamed.append(m.get("offload_streamed"))
        if i >= warm and engine._offloaded:
            copies.append(engine.offload_stats())
    launches, hopper = _flash_read()
    timed = len(batches) - warm
    want = {n: timed * k for n, k in _flash_per_step(
        [engine.model.config], 1).items()}
    peak = torch.cuda.max_memory_allocated()
    ok = (all(np.isfinite(losses)) and all(np.isfinite(norms))
          and launches == want and hopper == launches)
    log(f"offload {label}: losses {losses}, grad norms {norms}, "
        f"offload_streamed {streamed}; step times "
        f"{[round(x, 4) for x in times]} s; peak "
        f"torch.cuda.max_memory_allocated() {peak} B; flash launches in "
        f"{timed} timed steps {launches} (expected {want}), on the Hopper "
        f"kernels {hopper} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"phase 13: {label} failed")
    step_s = sum(times[warm:]) / timed
    for c in copies:
        log(f"offload {label}: copies a step: H2D "
            f"{_ckpt_gb_s(c['h2d_bytes'], c['h2d_s'])}, D2H "
            f"{_ckpt_gb_s(c['d2h_bytes'], c['d2h_s'])} (device-event time "
            f"of the side streams, beside compute); window "
            f"{c['window_leaves']:.0f} leaves, {c['window_bytes']:.0f} B")
    return {"losses": losses, "step_s": step_s, "peak": peak,
            "copies": copies, "launches": launches}


def _offload_parity(card: str) -> dict:
    """13 (a): Llama-2-7B's widths at ``OFFLOAD_PARITY_LAYERS`` layers,
    offloaded (``offload_optimizer: cpu``) then resident from the same
    seed-made weights and batches: losses, masters and moments bitwise,
    the offloaded peak below the resident one by at least the moments'
    bytes less the window's."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import Llama

    batches = _offload_batches(3, 13)
    runs = {}
    for label, zero in (("offloaded", {"offload_optimizer": {
            "device": "cpu"}}), ("resident", {})):
        model = Llama("7b", seed=13, n_layers=OFFLOAD_PARITY_LAYERS)
        engine = deepspeed_tpu_torch.initialize(
            model=model, config=_offload_cfg(**zero))[0]
        res = _offload_steps(f"(a) {label}", engine, batches, warm=1)
        if label == "offloaded":
            engine._fence()
            res["state"] = {"params": {n: p.detach().cpu() for n, p in
                                       engine.params.items()},
                            "mu": engine.opt_state.mu,
                            "nu": engine.opt_state.nu}
        else:
            got = runs["offloaded"]["state"]
            res["diff"] = [
                (k, n) for k, tree in (("params", engine.params),
                                       ("mu", engine.opt_state.mu),
                                       ("nu", engine.opt_state.nu))
                for n, t in tree.items()
                if not torch.equal(t, got[k][n].to(t.device))]
            res["moment_bytes"] = sum(
                t.numel() * t.element_size()
                for tree in (engine.opt_state.mu, engine.opt_state.nu)
                for t in tree.values())
        runs[label] = res
        del engine, model
        gc.collect()
        torch.cuda.empty_cache()
    off, ref = runs["offloaded"], runs["resident"]
    window = max(c["window_bytes"] for c in off["copies"])
    drop = ref["peak"] - off["peak"]
    ok = (off["losses"] == ref["losses"] and not ref["diff"]
          and drop >= ref["moment_bytes"] - window)
    log(f"offload (a) [{card}]: {OFFLOAD_PARITY_LAYERS} of 32 layers: step "
        f"{off['step_s']:.4f} s offloaded, {ref['step_s']:.4f} s resident; "
        f"peak {off['peak']} B offloaded, {ref['peak']} B resident: "
        f"{drop} B lower, moments {ref['moment_bytes']} B less the window's "
        f"{window:.0f} B; losses bitwise {off['losses'] == ref['losses']}; "
        f"leaves differing {ref['diff'][:4]} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 13 (a): offload parity failed")
    return {"step_s": (off["step_s"], ref["step_s"]),
            "peak": (off["peak"], ref["peak"])}


def _offload_fit(card: str) -> dict:
    """13 (b): Llama-2-7B's widths at ``OFFLOAD_FIT_LAYERS`` layers with
    the moments in pinned host memory: the resident need reckoned from
    the engine's own buffers above the card's memory, 1 warm-up and 1
    timed step, a finite loss."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import Llama

    log(f"offload (b): host memory before: {_host_memory()}")
    t0 = time.perf_counter()
    model = Llama("7b", seed=13, n_layers=OFFLOAD_FIT_LAYERS)
    t1 = time.perf_counter()
    engine = deepspeed_tpu_torch.initialize(
        model=model, config=_offload_cfg(offload_optimizer={
            "device": "cpu"}))[0]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    numel = sum(p.numel() for p in engine.params.values())
    masters = sum(p.numel() * p.element_size()
                  for p in engine.params.values())
    moments = sum(t.numel() * t.element_size()
                  for tree in (engine.opt_state.mu, engine.opt_state.nu)
                  for t in tree.values())
    pinned = all(t.is_pinned() for t in engine.opt_state.mu.values())
    need = masters + numel * 2 + numel * 4 + moments
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"offload (b): {numel} parameters; resident need: masters "
        f"{masters} + bf16 compute copy {numel * 2} + fp32 gradient "
        f"accumulator {numel * 4} + moments {moments} = {need} B against "
        f"the card's {total} B; moments pinned {pinned}; model built in "
        f"{t1 - t0:.1f} s, engine (moments made and pinned) in "
        f"{t2 - t1:.1f} s; host memory after: {_host_memory()}")
    res = _offload_steps("(b)", engine, _offload_batches(2, 14), warm=1)
    ok = need > total and pinned and all(np.isfinite(res["losses"]))
    log(f"offload (b) [{card}]: {OFFLOAD_FIT_LAYERS} of 32 layers: step "
        f"{res['step_s']:.4f} s, peak {res['peak']} B, loss "
        f"{res['losses'][-1]} {'ok' if ok else 'FAIL'}")
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("phase 13 (b): the fit case failed")
    return {"step_s": res["step_s"], "peak": res["peak"], "need": need}


def _offload_nvme(card: str, tmp: str) -> dict:
    """13 (c): TinyLlama-1.1B's widths at ``OFFLOAD_NVME_LAYERS`` layers,
    stage 3 on one rank with masters and moments on disk (``"nvme"``
    under ``tmp``), 2 steps bitwise the resident stage-3 run's; a tag
    saved after step 1 with the state parked, loaded by a fresh engine,
    resumes step 2 bitwise."""
    import copy

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import Llama

    # drawn on the card (the host draws 219 M numbers slowly), kept on
    # the host: the stage-3 engines copy from it
    host = Llama("1b", seed=14, n_layers=OFFLOAD_NVME_LAYERS).cpu()
    batches = _offload_batches(2, 15)

    def engine(cfg):
        # each engine on its own copy of the host model's weights
        return deepspeed_tpu_torch.initialize(model=copy.deepcopy(host),
                                              config=cfg)[0]

    def nvme(where):
        block = {"device": "nvme", "nvme_path": os.path.join(tmp, where)}
        return _offload_cfg(stage=3, offload_param=block,
                            offload_optimizer=block)

    def state(e):
        e._fence()
        if e._opt_store is None:
            return e.params, e.opt_state.mu, e.opt_state.nu
        return (e._materialized_params(), e._opt_store.read("mu"),
                e._opt_store.read("nu"))

    def same(a, b):
        return [n for ta, tb in zip(a, b) for n in ta
                if not torch.equal(ta[n].cpu(), tb[n].cpu())]

    ref = engine(_offload_cfg(stage=3))
    ref_losses = [float(ref.train_batch(b)["loss"]) for b in batches]
    ref_state = tuple({n: t.cpu() for n, t in tree.items()}
                      for tree in state(ref))
    del ref
    torch.cuda.empty_cache()
    a = engine(nvme("a"))
    _flash_reset()
    losses = [float(a.train_batch(batches[0])["loss"])]
    stats = [a.offload_stats()]
    t0 = time.perf_counter()
    a.save_checkpoint(os.path.join(tmp, "ckpt"), tag="s1")
    save_s = time.perf_counter() - t0
    losses.append(float(a.train_batch(batches[1])["loss"]))
    stats.append(a.offload_stats())
    launches, hopper = _flash_read()
    parked = a.params is None and a.opt_state is None
    a_state = state(a)
    diff = same(a_state, ref_state)
    b = engine(nvme("b"))
    t0 = time.perf_counter()
    b.load_checkpoint(os.path.join(tmp, "ckpt"), tag="s1")
    load_s = time.perf_counter() - t0
    resumed = float(b.train_batch(batches[1])["loss"])
    diff_resume = same(state(b), a_state)
    want = {n: 2 * k for n, k in _flash_per_step([host.config], 1).items()}
    ok = (losses == ref_losses and not diff and parked
          and resumed == losses[1] and not diff_resume
          and launches == want and hopper == launches)
    for i, s in enumerate(stats):
        log(f"offload (c) step {i + 1}: masters swap-in "
            f"{_ckpt_gb_s(s['param_swap_in_bytes'], s['param_swap_in_s'])},"
            f" swap-out {_ckpt_gb_s(s['param_swap_out_bytes'], s['param_swap_out_s'])};"
            f" moments swap-in "
            f"{_ckpt_gb_s(s['opt_swap_in_bytes'], s['opt_swap_in_s'])}, "
            f"swap-out {_ckpt_gb_s(s['opt_swap_out_bytes'], s['opt_swap_out_s'])}"
            f" (host clock, warm page cache); {s['opt_bytes_on_disk']:.0f} B on "
            f"disk")
    log(f"offload (c) [{card}]: TinyLlama-1.1B at {OFFLOAD_NVME_LAYERS} of "
        f"22 layers, stage 3, nvme: losses {losses} (resident "
        f"{ref_losses}), leaves differing {diff[:4]}, parked {parked}; "
        f"save {save_s:.2f} s, load {load_s:.2f} s, resumed loss {resumed} "
        f"(differing {diff_resume[:4]}); flash launches {launches} "
        f"(expected {want}), Hopper {hopper} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 13 (c): nvme offload failed")
    return {"stats": stats, "save_s": save_s, "load_s": load_s}


def phase_offload(card: str) -> dict:
    """13, ZeRO offload: (a) parity against resident, (b) the case offload
    exists for, (c) nvme at stage 3 with a checkpoint, under one temporary
    directory (removed after)."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    log(f"offload: phase 13 predicted {OFFLOAD_PREDICTED_S:.0f} s")
    a = _offload_parity(card)
    t_a = time.perf_counter() - t_phase
    b = _offload_fit(card)
    t_b = time.perf_counter() - t_phase - t_a
    tmp = tempfile.mkdtemp(prefix="dst_offload_")
    try:
        c = _offload_nvme(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    took = time.perf_counter() - t_phase
    log(f"offload: (a) {t_a:.1f} s, (b) {t_b:.1f} s, (c) "
        f"{took - t_a - t_b:.1f} s; phase 13 took {took:.1f} s (predicted "
        f"{OFFLOAD_PREDICTED_S:.0f} s)")
    return {"a": a, "b": b, "c": c, "seconds": took}


def main() -> int:
    from deepspeed_tpu_torch.models.llama import Llama

    t0 = time.perf_counter()

    def mark(what: str) -> None:
        log(f"chip_smoke: {what} done at {time.perf_counter() - t0:.1f} s")

    dev = phase_device()
    pending = phase_build()
    mark("build of all but fused_collectives.cu")
    phase_engine_parity()
    mark("engine parity (4)")
    phase_build_report(pending)
    mark("build")
    kern = phase_kernels()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    kern_q = phase_paged_quant(flush)
    quant_t = phase_quant_kernels(flush)
    flash_err = phase_flash_kernels()
    flash_t = phase_flash_timing(flush)
    fused_t = phase_fused_kernels(flush)
    mark("kernels (3, 5, 5q, 6k)")
    del flush
    torch.cuda.empty_cache()
    paths, eng, prompts = phase_serving(dev["card"])
    mixed_t = phase_paged_mixed(paths.pop("mixed"), dev["card"])
    phase_profile(eng, prompts, dev["card"])
    model = eng.model
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    mark("serving (5, 5b, profile)")
    spec = phase_speculative(model, dev["card"])
    mark("6b")
    paged_q, eng = {}, None
    for kvq in ("int8", "int4"):
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        paged_q[kvq], eng, _ = phase_serving(dev["card"], model, kvq)
        del paged_q[kvq]["mixed"]
        if kvq == "int8":
            phase_profile(eng, prompts, dev["card"], "profile int8")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    mark("int8 / int4 serving")
    # 6c-6e's replicas, fleets and regions over Llama-2-7B's width at a
    # quarter of its depth (time; each phase makes its own references)
    shallow = Llama("7b", dtype=torch.bfloat16, seed=0,
                    n_layers=SHALLOW_LAYERS)
    replicas = phase_replicas(shallow, dev["card"], spec["err"])
    mark("6c")
    gc.collect()
    torch.cuda.empty_cache()
    fleet = phase_fleet(shallow, dev["card"], spec["err"])
    mark("6d")
    gc.collect()
    torch.cuda.empty_cache()
    region = phase_region(shallow, dev["card"], spec["err"])
    mark("6e")
    del shallow
    gc.collect()
    torch.cuda.empty_cache()
    fam = phase_families(dev["card"])
    mark("6g")
    opt = fam.pop("opt")
    del model             # 6f builds its own depth; phase 5's prompts
    gc.collect()          # serve 6f and 12 (b) again
    torch.cuda.empty_cache()
    tp = phase_tp(dev["card"], spec["err"], prompts, spec, opt)
    mark("6f")
    del opt
    gc.collect()
    torch.cuda.empty_cache()
    enc = phase_encoders(dev["card"])
    mark("6h")
    moe = phase_moe(dev["card"])
    mark("6i")
    sd = phase_diffusion(dev["card"])
    mark("6j")
    quant_launches = phase_inference(dev["card"])
    mark("6a")
    phase_trainer_parity()
    engine, batch, flash_launches, flash_wgmma = phase_training(dev["card"])
    phase_training_profile(engine, batch, dev["card"])
    mark("7, 8, 9")
    rest = phase_trainer_rest(engine, batch, dev["card"])
    mark("8e")
    del engine, batch
    gc.collect()
    torch.cuda.empty_cache()
    fam_train = phase_train_families(dev["card"])
    mark("8b")
    tp_train = phase_tp_training(dev["card"])
    mark("8c")
    zero_train = phase_zero_training(dev["card"])
    mark("8d")
    zero_host = _zero_host_start(zero_train)
    phase_zero3_parity()
    mark("10")
    _zero_host_finish(zero_host, dev["card"])
    del zero_train["host"]
    mark("8d (d)'s host runs")
    fused_launches, fused_wgmma = phase_zero3_training(dev["card"])
    mark("11")
    ckpt = phase_checkpoints(dev["card"], prompts)
    mark("12")
    phase_offload(dev["card"])
    mark("13")
    d = kern["timings"]["decode_16x1024"]
    entries = [{"name": "paged_attention", "route": "cuda",
                "source": PAGED_SOURCE, "replaces": PAGED_REPLACES,
                "launches": paths["launches"],
                "tile_launches": paths["tile_launches"],
                "split_launches": paths["split_launches"],
                "verify_launches": spec["launches"],
                "verify_tile_launches": spec["tile_launches"],
                "verify_split_launches": spec["split_launches"],
                "replica_launches": replicas["launches"],
                "replica_tile_launches": replicas["tile_launches"],
                "replica_split_launches": replicas["split_launches"],
                "fleet_launches": fleet["launches"],
                "fleet_tile_launches": fleet["tile_launches"],
                "fleet_split_launches": fleet["split_launches"],
                "region_launches": region["launches"],
                "region_tile_launches": region["tile_launches"],
                "region_split_launches": region["split_launches"],
                "tp_launches": tp["launches"],
                "tp_tile_launches": tp["tile_launches"],
                "tp_split_launches": tp["split_launches"],
                "tp_spec_launches": tp["spec_launches"],
                "tp_spec_verify_puts": tp["spec_verify_puts"],
                "tp_opt_launches": tp["opt_launches"],
                "tp_opt_tile_launches": tp["opt_tile_launches"],
                "tp_opt_split_launches": tp["opt_split_launches"],
                **{f"{key}_{n}": fam[name][n] for key, name in FAMILY_KEYS
                   for n in ("launches", "tile_launches",
                             "split_launches")},
                **{f"moe_{n}": moe[n] for n in ("launches", "tile_launches",
                                                "split_launches")},
                # 12 (b): serving a Hugging Face export read back
                **{f"ckpt_{n}": ckpt["hf"][n] for n in (
                    "launches", "tile_launches", "split_launches")},
                "max_abs_err": kern["max_abs_err"],
                "ms": d["ms"], "kernel_ms": d["ms"],
                "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
                "bound_by": d["bound_by"], "library_ms": None,
                "parity": "ok", "shape": "decode_16x1024", "path": PAGED_PATH,
                "timings": {**kern["timings"], "mixed_put": mixed_t,
                            "verify_put": spec["bf16"],
                            "tp_put_rank0": tp["bf16"],
                            "tp_opt_put_rank0": tp["opt"],
                            **{f"{key}_mixed_put": fam[name]["mixed_put"]
                               for key, name in FAMILY_KEYS}},
                "card": dev["card"]}]
    for bits in (8, 4):
        kq, run = kern_q[bits], paged_q[f"int{bits}"]
        d = kq["timings"]["decode_16x1024"]
        entries.append({
            "name": f"paged_attention_int{bits}", "route": "cuda",
            "source": PAGED_SOURCE, "replaces": PAGED_QUANT_REPLACES,
            "launches": run["launches"],
            "tile_launches": run["tile_launches"],
            "split_launches": run["split_launches"],
            "max_abs_err": kq["max_abs_err"], "ms": d["ms"],
            "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": None, "parity": "ok",
            "shape": "decode_16x1024", "path": PAGED_QUANT_PATH,
            "timings": kq["timings"], "card": dev["card"]})
    entries[1]["verify_launches"] = spec["int8_launches"]
    entries[1]["replica_launches"] = replicas["int8_launches"]
    entries[1]["fleet_launches"] = fleet["int8_launches"]
    entries[1]["tp_launches"] = tp["int8_launches"]
    entries[1]["timings"] = {**entries[1]["timings"],
                             "verify_put": spec["int8"],
                             "tp_put_rank0": tp["int8"]}
    for name, (_, replaces, _) in FLASH_KERNELS.items():
        t = flash_t[name]
        entries.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": replaces, "launches": flash_launches[name],
            "max_abs_err": max([flash_err[name]] + [
                v[name]["max_abs_err"] for v in fam_train["flash"].values()]),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "parity": "ok", "shape": "b4_s2048_hq32_hkv4_d64_bf16_causal",
            "path": t["path"], "tflops": t["ops"] / t["ms"] / 1e9,
            "card": dev["card"]})
        if name in flash_wgmma:
            entries[-1]["wgmma_launches"] = flash_wgmma[name]
            entries[-1]["mma_sync_ms"] = t["mma_ms"]
        # the kernel at 8d (c)'s shape (d 128) beside its mma.sync kernel
        t128 = t["d128"]
        entries[-1]["d128_timing"] = {
            "shape": "b1_s2048_hq32_hkv32_d128_bf16_causal",
            **{key: t128[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "tflops")},
            "mma_sync_ms": t128["mma_ms"],
            "cudnn_backward_ms": t128.get("cudnn_backward_ms")}
        # 8b: launches in each family's 3 timed training steps, and the
        # kernel at each family's training shape
        entries[-1].update(
            train_family_launches={k: fam_train[k]["launches"][name]
                                   for k in TRAIN_SHAPES},
            train_family_wgmma_launches={
                k: fam_train[k]["wgmma_launches"][name]
                for k in TRAIN_SHAPES},
            train_family_timings={k: v[name]
                                  for k, v in fam_train["flash"].items()},
            # 8c: rank 0's launches in TinyLlama-1.1B's 3 timed steps at
            # TP 2 (hq 16, hkv 2 a rank)
            tp_train_launches=tp_train["launches"][name],
            tp_train_wgmma_launches=tp_train["wgmma_launches"][name],
            # 8d: rank 0's launches in each ZeRO run's 2 timed steps,
            # all on the Hopper kernels ((c)'s at d 128 too)
            zero_train_launches={k: v[name] for k, v in
                                 zero_train["launches"].items()},
            zero_train_wgmma_launches={k: v[name] for k, v in
                                       zero_train["wgmma_launches"].items()},
            zero3_timing=zero_train["flash"][name],
            # 12 (a): the 2 resumed steps
            ckpt_resume_launches=ckpt["launches"][name],
            ckpt_resume_wgmma_launches=ckpt["wgmma_launches"][name],
            # 8e (a): one step of TinyLlama-1.1B under each remat policy
            remat_launches={k: v[name] for k, v in
                            rest["launches"].items()},
            remat_wgmma_launches={k: v[name] for k, v in
                                  rest["wgmma_launches"].items()})
        if name == "flash_forward":
            # 6h: BERT-large's 10 timed forwards, CLIP's similarity, and
            # row 2 timed at their layer-0 calls
            bert, clip = enc["bert"], enc["clip"]
            entries[-1].update(
                bert_launches=bert["launches"],
                bert_wgmma_launches=bert["wgmma_launches"],
                clip_launches=clip["launches"],
                clip_wgmma_launches=clip["wgmma_launches"],
                sd_text_launches=sd["launches"],
                sd_text_wgmma_launches=sd["wgmma_launches"],
                encoder_timings={"bert_large": bert["row2"],
                                 "clip_vision": clip["row2_vision"],
                                 "clip_text": clip["row2_text"]})
    for name, (_, replaces, _) in QUANT_KERNELS.items():
        t = quant_t[name]
        entries.append({
            "name": name, "route": "cuda", "source": QUANT_SOURCE,
            "replaces": replaces, "launches": quant_launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "parity": "bitwise",
            "opt_launches": fam["v1"]["launches"][name],
            "tp_opt_launches": tp["opt_quantize" if name.startswith(
                "quantize") else "opt_dequantize"],
            "bert_launches": enc["bert"]["int8_launches"][name],
            # 8d (d): rank 0's launches in 2 steps of qgZ at stage 2
            "zero_qgz_launches": zero_train["quant_launches"][name],
            "moe_launches": moe["v1"]["launches"][name],
            "shape": "4096x11008_bf16_int8_block256", "card": dev["card"]})
        if name.startswith("dequantize"):
            entries[-1]["tp_shard"] = tp["dequant"]
    for name, (_, replaces) in FUSED_KERNELS.items():
        t = fused_t[name]
        entries.append({
            "name": name, "route": "cuda", "source": FUSED_SOURCE,
            "replaces": replaces, "launches": fused_launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library": FUSED_LIBRARY[name], "parity": "ok",
            "path": t["path"], "tflops": t["ops"] / t["ms"] / 1e9,
            "shape": FUSED_SHAPES[name], "card": dev["card"]})
        if name in fused_wgmma:
            entries[-1]["wgmma_launches"] = fused_wgmma[name]
        if "converter" in t:
            entries[-1]["converter_ms"] = t["converter"]
        if "mma_sync_ms" in t:
            entries[-1]["mma_sync_ms"] = t["mma_sync_ms"]
        if name == "matmul_pallas":
            # 6f (c): the v1 TP decode MLP's launches on rank 0, (d) the
            # kernel timed at that shape
            entries[-1].update(tp_decode_launches=tp["v1_launches"],
                               tp_decode_wgmma_launches=tp[
                                   "v1_wgmma_launches"],
                               tp_decode=tp["decode"],
                               tp_opt_decode_launches=tp["opt_v1_launches"],
                               tp_opt_decode_wgmma_launches=tp[
                                   "opt_v1_wgmma_launches"],
                               tp_opt_decode=tp["decode_opt"])
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": dev["name"],
                                           "count": dev["count"]}}))
    return 0


def probe_cpu_reference() -> int:
    """``python3 chip_smoke.py --probe-cpu-reference``: phase 10's cpu
    rank pair, unpinned, under ATEN_CPU_CAPABILITY default / avx2 / avx512
    at 1 / 2 / 8 threads, then at the host's own capability under each
    MKL_CBWR code path, then pinned, printing each step-0 loss of the
    compressed fused run (the one phase 10 once read another loss on) and
    of the dense run. Finds which property moves the cpu reference.
    Needs no card."""
    from deepspeed_tpu_torch.utils import cpu_pin

    log(f"host: {os.cpu_count()} CPUs, {cpu_pin.cpu_report()}")
    runs = [("compressed_pallas", True, "pallas", None),
            ("dense_xla", False, "xla", None)]
    settings = [({"ATEN_CPU_CAPABILITY": cap}, t)
                for cap in ("default", "avx2", "avx512") for t in (1, 2, 8)]
    settings += [({"MKL_CBWR": m}, 2) for m in ("AVX2", "AVX512",
                                               "COMPATIBLE")]
    settings.append((None, cpu_pin.PINNED_THREADS))
    for env, threads in settings:
        procs, q = _start_ranks(2, "cpu", "parity", (PARITY_DIMS, runs, 1),
                                env=env, pin=env is None, threads=threads)
        res = _join_ranks(procs, q, timeout=300)[0]
        log(f"cpu reference probe: {env or 'pinned'} threads {threads}: "
            f"step-0 loss compressed {res['compressed_pallas']['losses'][0]!r}"
            f" dense {res['dense_xla']['losses'][0]!r}")
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--probe-cpu-reference"]:
        sys.exit(probe_cpu_reference())
    sys.exit(main())

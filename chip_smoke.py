#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card; it fails (exit
code 1, no result line) without one.  Phases, each of which fails the run:

1. card: name, power limit, torch and CUDA versions; TF32 off for every
   fp32 comparison (``torch.backends.cuda.matmul.allow_tf32 = False``);
2. build: the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a,
   one process per source) and the Triton RMSNorm (for every row width the
   paths use: 128, 2048, 2560, 4096) and AdamW, with the ptxas
   register/shared/spill lines (kept beside each library, so a build made
   earlier in the same checkout prints them too);
3. kernels against their plain versions on the card, bf16 and fp32, at the
   shapes the serve and train paths give them, K1 also in its int8 mode
   over pools quantized by ``quantize_kv`` (where a D that is not a
   multiple of 16 is refused), and also against the plain version of its
   split schedule, one launch a call, two calls bitwise equal, at the
   serve shape and at a ragged 4,096-position table with NaN dead pages,
   its plan's split count and shared memory (equal to the kernel's), and
   its times at the serve shape and at a 4,096-position context (32,768
   rows, beyond L2) (fp32 1e-4, bf16 2e-2
   absolute; AdamW 1e-6; the softmax-xent backward elementwise, each
   element to 1e-5 (fp32) or 1e-2 (bf16) of its own size, since its
   elements span ten orders of magnitude; a row pitch that is not 16-byte
   aligned is refused), and their times (CUDA events) beside the plain
   version, one PyTorch call as a yardstick, and the bound from shapes
   (3.35 TB/s; 989 TFLOP/s bf16, 67 TFLOP/s fp32); K6 (the Mamba2 SSD scan)
   and K7 (the RWKV6 WKV recurrence), each bf16 on the tensor cores and
   fp32 on the CUDA cores, at the eval shapes of zamba2-1.2b and rwkv6-1.6b
   (B=4, S=2048) and at a ragged S=2000, on inputs shaped as the models
   make them (no PyTorch call computes either scan, so they have no
   yardstick), bf16 also against the plain emulation of its rounding points
   (equal in at least 99.9% of the elements), on the model layout through
   ``ops.mamba2_ssd`` and ``ops.rwkv6_wkv`` (equal to the public layout's
   output, K7 twice bitwise, one profiled call must show the scan as its
   only device kernel, the plan's shared memory and blocks per SM equal
   the kernel's) and timed there (K7 also in fp32); K3 timed over input
   and output buffers in turn, 126 MB in all, beyond the L2; K2 in both
   modes (bf16 on the tensor
   cores, fp32 on the CUDA cores) at D 32, 64, 128, G 1 and 4, S 16, 32,
   64, 128, 200, 256, 512, 2048, causal and not, with the plan's shared
   memory equal to the kernel's, on the model layout and on strided
   fused-projection views through ``ops.flash_attention`` (one profiled
   call must show K2 as its only device kernel), bf16 D=80 refused, and
   timed at the serve prefill shape, at zamba2-1.2b's shared attention
   block (B=4, H=KV=32, S=2048, D=64) and, fp32, at phase 4's prefill;
4. full-width qwen3-4b in fp32: one batched prefill (exactly 36 launches
   of K2's fp32 mode on the kernel path) and 16 decode steps
   through the kernels and through the plain path (dense prefill, gathered
   decode, plain RMSNorm), over native pages and over int8 pages; on each
   page format logits agree to a relative max error of 1e-3 and greedy
   tokens agree wherever the plain top-2 gap exceeds the error; the largest
   int8-vs-native logit difference and their greedy agreement are printed;
   then the same prompts landed again through ``LM.prefill_chunk`` in
   chunks of 48 (rounds of up to 4 x 48, K3 exactly 145 times a dispatch,
   no K2) over native and int8 pages, with the same 16 decode steps from
   the chunked pools: native against the bucketed prefill to a relative
   max error of 1e-3; int8 against the whole prompt landed as one chunk (a
   chunk reads its rows back from int8, the bucketed forward attends the
   float K/V: that difference is reported) on prompts from three seeds, to
   a relative 1e-2 with layer 0's int8 levels equal but for at most 0.1%
   of them, one level apart (fp32 rounding differs between the two
   chunkings' matmul shapes, a value near an int8 boundary takes the next
   level, later layers read it); two faulty chunk paths (one layer's
   scales unwritten, quantizing by truncation) must fail that gate, and
   the same inputs in fp64 must pass it at 1e-3; greedy tokens agree
   wherever the top-2 gap exceeds the error, against the bucketed int8
   prefill too;
5. serve: full-width qwen3-4b in bf16 through ``ServeEngine`` (16 requests,
   prompts of 16-200 tokens, some sharing a prefix, 32 new tokens each,
   max_batch 8, max_seq 512, page 16), each decode step one replay of the
   engine's CUDA graph: over native pages, over int8 pages, the same two
   eagerly (``cuda_graph=False``), over the contiguous cache (604 MB of
   bf16 K/V), and with chunked prefill (``prefill_chunk=64,
   prefill_budget=128``, the chunk rounds eager between graph replays)
   over native and int8 pages, and, with staggered lengths (8-56 new
   tokens, so admissions land among live streams), whole-prompt and
   chunked over native pages; in each run every request completes, one
   decode dispatch per iteration, one graph replay per decode iteration
   (none eagerly), and the kernel launch counts match the decode steps,
   prefill dispatches and norms of that run (the int8 runs launch K1's
   int8 mode, never the native one; the contiguous run no K1; a chunked
   run no K2 and K3 145 times a chunk dispatch); a chunked run's chunks
   equal the prompts' chunks less those skipped on landed shared pages,
   and its decode stall counter is 0 (by construction: a round spends at
   most the budget; the longest wait between two tokens, reported, is what
   a stream feels); the graph's streams equal the eager
   ones token for token (native and int8), contiguous, int8 and chunked
   streams are reported against whole-prompt ones; chunk and prefill
   dispatch ms, the longest wait between two tokens of one stream, decode
   step ms, tok/s, TTFT, the
   pools' bytes (``memory_stats()``, the tensors, as allocated at
   construction) and the graph's capture ms and private pool bytes; one
   replay timed with CUDA events; one fused decode step of each run
   profiled, the window held to K1's 36 launches (kernels, busy ms, idle
   share, K1's and K3's device time inside a replay), and one prefill
   forward of 8 prompts of bucket 256; then, on 8 prompts
   admitted together, one replayed step's (B, V) rows bitwise equal to the
   same step run eagerly, and the contiguous cache's rows bitwise equal to
   paged ``decode_impl="gather"`` rows;
5b. infrastructure (``repro_torch.core``): (a) Autopilot's two probes on
   the card (``Autopilot(measure_real=True)``: an fp32 256 x 256 matmul
   chained twice and a 4 MiB pinned host-to-device copy, each on the host
   clock up to a synchronize): both finite and > 0, every check PASS, no
   alert; a power brake and then a PCIe downgrade injected on the node
   must read 0.375x and 0.3x of the baselines, ERR and fire
   ``autopilot_err``; more readings, a pageable copy and a 64 MiB pinned
   copy printed for reference; (b) phase 5's native run again on its
   model and weights with the health loop wired in (``alerts``,
   ``health_every=16``, ``verify_cache=True``): its streams equal phase
   5's native graph streams token for token, one replay a decode step,
   launch counts exact, the checks ran ceil(steps / 16) times, every
   ``autopilot_serve_*`` gauge 1.0 at each, no alert; the host ms of the
   checks and of ``kv.verify()`` with 8 slots live, and the step ms beside
   phase 5's;
5c. tenancy and faults: (a) K1 at phase 3's serve shape (finite pools) in
   every mode (native bf16 and fp32, int8, partials merged over two
   shards) with one live page poisoned as ``PagedCache.poison_page`` does
   (NaN K and V, or NaN scales), mid-range and as the only page of a
   split's range: every element of the victim's row non-finite, every
   other row bitwise the clean call's; NaN rows past a new owner's
   position (a recycled page) change no row; (b) full-width qwen3-4b cut
   to 4 layers in fp32, 6 requests (two arriving later), each fault kind
   (nan_logits, poison_page over native and int8 pages, dispatch_error,
   stall_chunk with the watchdog, chip_failure with ``locality_chips=2``)
   and a preemption by an interactive tenant, through the graph, eagerly
   and on the CPU: counters equal across the three, every completed
   stream equal to the fault-free run (a greedy first difference allowed
   only at a top-2 gap below 1e-4, counted, 0 expected); (c) phase 5's
   bf16 workload with tenants (chat arrivals preempting bulk in a 96-page
   pool) and five faults, twice: every request completed or
   dead-lettered as the counters say, one replay a decode iteration, the
   graph never recaptured, K1/K2/K3 launches exact, the two runs bitwise
   equal; preemptions, recoveries, a resume prefill's host ms, the step
   ms and TTFT by class reported;
5d. the host-RAM page tier: (a) the JAX bench's prefix-hit workload
   (``run_offload``) on phase 5's model, native and int8 pages: 4
   prefixes of 480 tokens with 4-token tails, 6 new tokens, chunks of 32,
   page 16, max_batch 4, a 128-page store; a cold engine serves the four
   one at a time, a new engine on the same store serves them again; the
   warm streams bitwise the cold ones, chunks, skips, hits, misses,
   offload and prefetch bytes exact, one replay a decode step, launches
   exact; TTFT cold and warm and the tier's D2H and H2D GB/s (CUDA
   events) reported; (b) phase 5's workload with a 128-page tier
   (native, int8, chunked): ``serve_runs``' gates, the tier offloaded and
   hit, the decode step within 1.5x phase 5's native step; (c) the
   hazards on the card with the stream held busy: a freed page claimed
   at once by a chunked slot's ``extend`` and rewritten before the drain
   still offloads its first bytes (a view-storing cache must fail), and
   the host poisoning a store entry right after a prefetch from it leaves
   the prefetched page clean (an unfenced prefetch reported); (d) the 10x
   working-set soak at full width cut to 4 layers, fp32: drained, pages
   in use within the pool, streams equal the tierless engine's (tie rule,
   0 expected);
6. training parity: full-width qwen3-4b cut to 2 layers, fp32, two train
   steps through K4 and K5 and through their plain versions; loss,
   grad_norm and every parameter agree to a relative max error of 1e-3;
   then in bf16 compute (fp32 parameters, as the train path runs), the
   loss (1e-5) and every gradient leaf (relative max error 2e-2) through
   K4 against the plain loss;
7. training: full-width qwen3-4b cut to 12 layers (fp32 parameters, bf16
   compute), batch 8 x seq 256 from a synthetic corpus, through
   ``FTTrainLoop``; every loss is finite, the last is below the first, and
   K4 forward/backward and K5 launch exactly once per step and once per
   parameter tensor per step; tok/s, step ms, peak memory and MFU, then
   one profiled step: device time by kernel group and the idle share;
   then the same run from the same seed through the plain loss and plain
   AdamW, whose per-step losses the kernel run's match to 2e-2 relative;
8. full-width zamba2-1.2b and rwkv6-1.6b in fp32, random weights from a
   seed, B=2, S=512: the forward through K6/K7, K2 and K3 against the plain
   path (the models' chunked mixers, dense attention, plain RMSNorm), both
   against a float64 forward of the plain path; logits agree to a relative
   max error of 1e-3 at the full depth or, where the fp32 plain path is
   more than 1e-4 from float64 there (the random rwkv6 amplifies fp32
   rounding), at the first halved depth where it is not;
9. eval: full-width zamba2-1.2b and rwkv6-1.6b in bf16 through
   ``make_eval_step``, B=4, S=2048 from a synthetic corpus (seed 0); the
   loss is finite and agrees with the plain path's to 2e-2 relative; one
   counted eval launches exactly K6 38 times (zamba2) or K7 24 times
   (rwkv6), K2 6 times and K3 89 times (zamba2: ln1 and the gated norm of
   38 Mamba2 layers, ln1 and ln2 of 6 shared-block calls, the final norm),
   and K4 once, and the plain path launches nothing; eval tok/s, forward
   ms, peak memory, and one profiled forward with the scan's and the
   elementwise and copy kernels' share of its busy time;
10. sharded pools: (a) K1's partials mode, native and int8, on n = 2 and 4
   shards of the phase-3 pools (global table, ``page_offset``): each
   shard's triple against the plain partials and the plain split schedule
   (1e-4 relative), one launch a call, two calls bitwise equal, every slot
   with no live row in a shard exactly (0, 0, -1e30), the merged shards
   against the normalized K1 on the whole pool (fp32 1e-4, bf16 2e-2), and
   each shard's time (serve shape at n = 2 and 4, long shape at n = 2)
   beside its bound, the plain partials and SDPA on the shard's gathered
   view; (b) two rank processes of this script
   (``--sharded-rank R --ranks 2 --port P``) on this one card over gloo,
   spawned after the kernels are built and this process's memory freed:
   full-width qwen3-4b fp32, one prefill and one decode step over a pool
   split in two (30 pages, one slot's pages on both ranks), rank 0's
   logits against its own single-card cache (1e-4 relative max error);
   (c) the two ranks serve phase 5's workload (257 pages padded to 258)
   at full width cut to 12 layers over native, then int8 pages, then
   native pages over 129 pages (padded to 130), where the live slots
   outgrow one rank's shard, then with phase 5's chunked prefill over
   native pages (each chunk's attention merged across the ranks too),
   stepping eagerly (the merge goes through the host): each rank
   launches ``paged_flash_decode_partials[_int8]`` exactly 12 times per
   decode step and the normalized K1 never, pins half the padded pool plus
   one sink page, and both ranks emit the same streams (how many equal
   this process's single-card runs at 12 layers, the pages each rank
   handed out, and the decode step time are reported); then the
   gloo merge's time per layer; (d) a 2x2 batch x pages mesh: full-width
   qwen3-4b cut to 4 layers, fp32, phase 5's prompts (16 new tokens)
   whole-prompt, chunked, int8 and with a 128-page tier (whole and
   chunked), on one card through the graph, then in four rank processes
   (``--mesh2d-rank R --port P``, groups from the launcher's
   ``join_pool_group``) over gloo: every rank's streams equal the single
   card's (tie rule, 0 expected), each pool shard bitwise equal on its
   two dp replicas, every rank's store the same and the single card's,
   K1's partials mode 4 times a decode step.

11. biased dense (starcoder2-3b, granite-13b, granite-20b-code: LayerNorm,
   GELU, biases; every bias and norm leaf redrawn from a seed, since
   ``LM.init`` zeros them as JAX does): (a) K1 at their head layouts, KV=1
   G=48, KV=40 G=1 and KV=2 G=12 (D=128, page 16, phase 3's ragged
   positions and NaN dead pages), native and int8, fp32 and bf16 q,
   against its plain version and its plain split schedule, one launch a
   call, two calls bitwise equal, the plan's shared memory equal to the
   kernel's, timed at phase 3's serve positions; K2 at KV=1 G=48 and KV=40
   G=1 (8 prompts of 256, causal), bf16 and fp32, against its plain
   version, timed beside SDPA (``enable_gqa``) and the bound; (b) fp32, the
   kernel path against the plain path over native and int8 pages:
   starcoder2-3b at full width and depth, granite-13b and granite-20b-code
   at full width cut to 4 layers, one batched prefill and 16 decode steps,
   logits to 1e-3, greedy tokens equal wherever the plain top-2 gap exceeds
   the error, launches exact (K2 L times a prefill, K1 L times a decode
   step, no K3); (c) granite-20b-code at full width and depth in bf16
   served by ``ServeEngine`` on phase 5's workload through the graph over
   native and int8 pages and eagerly: graph streams equal eager streams,
   K1 52 times a replay, K2 52 times a prefill dispatch; ``LM.init``'s
   peak memory, tok/s, decode step, TTFT and pool bytes printed;
12. recurrent decode (zamba2-1.2b, rwkv6-1.6b, full width): (a) fp32 with
   the plain mixers at phase 8's gated depth, ``LM.prefill`` of 511 tokens
   and a decode step against the forward's row 511, then 8 chained decode
   steps against the forward over 520 tokens, each to 1e-3; (b) bf16, 4
   prompts of 512 and 64 greedy tokens on the kernel and plain paths:
   prefill ms, decode step ms (CUDA events), tok/s, state and shared-cache
   bytes, peak memory; launches exact (zamba2's prefill K2 6 and K3 89
   times, each decode step K3 89 times and no K2; rwkv6 none); the first
   tokens and the two paths' stream agreement printed.
13. recurrent training (zamba2-1.2b at 12 of 38 layers, rwkv6-1.6b at 6
   of 24, full width (depth cut for the smoke's time),
   fp32 parameters and moments, bf16 compute, random weights from seed
   0): ``FTTrainLoop`` over ``make_train_step`` (blockwise attention, plain
   norms, the plain chunked mixers; K4 and K5) on one fixed batch from a
   synthetic corpus, 6 steps under each remat policy: "none" at 4 x 512
   (at 4 x 1024 its activations would pass the card), "selective" and
   "full" at 4 x 1024; losses finite and falling, K4 forward and backward
   once a step, K5 once a parameter tensor a step, no other kernel; step
   0's loss bitwise equal across the policies and its grad_norm within
   1e-4 relative ("none" against one step of each other policy at 4 x 512,
   selective against full at 4 x 1024); step ms, tok/s, MFU and peak
   memory of each run; K4 at the phase's logits (4,096 x 32,000 and 4,096
   x 65,536, bf16) and K5 at each model's largest parameter tensor, timed;
14. vlm (internvl2-2b: the dense GQA decoder behind 256 stub-ViT patch
   embeddings, KV=8 G=2 D=128): K1 at that head layout against its plain
   version and split schedule, native and int8, fp32 and bf16 q, timed;
   K2 at the image-prefixed blocks (fp32 4 x 384, bf16 8 x 512) timed; (a)
   fp32 at full width cut to 4 layers, ``img_pos`` redrawn, 4 prompts
   behind seeded images: the kernel path against the plain path over
   native and int8 pages, one prefill and 16 decode steps, logits to 1e-3,
   greedy tokens equal wherever decided, K1/K2/K3 launches exact; (b)
   bf16 at full size on phase 5's workload, a seeded random (256, 2048)
   image a request, through the graph and eagerly, native and int8 pages
   (``serve_runs``' gates): graph streams equal the eager ones, no page
   shared; tok/s, TTFT p50, one replay's device ms, pool bytes; (c) 4 train
   steps at full size (remat "selective"), batch 4 x (256 + 256): losses
   finite and falling, K4/K5 launches exact, step ms, MFU, peak memory.
15. MoE (moonshot-v1-16b-a3b: 64 experts top-6; arctic-480b: 128 experts
   top-2 beside a dense residual FFN): K1 at KV=16 G=1 and KV=8 G=7 (seven
   query rows on the tensor cores' eight), native and int8, against its
   plain version and split schedule, the plan's shared memory, timed; K2
   at both (256-token buckets), K3 at d=2048 and d=7168, timed; (a)
   moonshot at full width cut to 4 layers in fp32, the kernel path against
   the plain path (4 prompts of 150-256 tokens in one bucket of 256, 16
   decode steps) with every layer's expert ids recorded on both paths: a
   row whose ids differ must be a router tie (gap below 1e-4) and takes
   its sequence (prefill) or the decode group (from that step) out of the
   logits gate, counted; (b) moonshot at full width in bf16 cut to 12 of
   its 48 layers (``LM.init`` draws each stacked leaf in fp32 first: 84.6
   GiB at 48 layers, 42.6 at 24, reckoned and measured; 12 for the smoke's
   time) on phase 5's
   workload through the graph and eagerly, native and int8: graph streams
   equal the eager ones, one replay a decode step, K1/K2/K3 launches exact;
   replay ms, tok/s, TTFT p50, pool and graph pool bytes, peak memory; (c)
   arctic-480b at 1 of its 35 layers (42.2 GiB reckoned at init, 84.0 at
   2), the same; (d) moonshot at 2 layers trained 4 steps at 4 x 256 under
   each remat policy: step 0's loss and grad_norm bitwise equal across
   them, ``moe_aux`` finite and non-zero, K4 and K5 timed at its shapes.
16. enc-dec (seamless-m4t-large-v2 at full size, 24 + 24 layers, every
   bias and LayerNorm leaf redrawn): K2 at D=64, KV=16 G=1, the encoder's
   non-causal launch (4 x 64 frames) and the decoder's causal one (4 x
   256), fp32 and bf16, timed; (a) fp32 kernel path against the plain path
   (4 x 256 tokens, 64 frames) to 1e-3, K2 launches exact, then
   ``LM.prefill`` and 32 decode steps over the dense cache against the
   forward to 1e-3; (b) bf16 ``LM.prefill`` of 4 x 256 and 32 greedy decode
   steps: prefill and step ms, greedy tokens equal to a bf16 forward's
   wherever decided; (c) 4 train steps at 4 x 512 with 128 frames, remat
   none, K4 and K5 timed at its shapes.
17. parallel training, every part on rank processes of this script over
   gloo on this card (``--train-mesh-rank R`` / ``--train-mesh-pair R``
   with ``--port P``; collectives staged through the host, the compute on
   the card): (a) full-width qwen3-4b cut to 4 layers, fp32 parameters and
   bf16 compute, 4 x 256 tokens, on a 2x2 ``data x model`` mesh (FSDP over
   data, tensor parallelism over model), selective remat, with the default
   opts and then ``tp_shardmap=True``: step-0 loss and gradient shards,
   then three steps (warmup 1, so steps 1 and 2 move the weights) held to a
   single-rank run on the same weights and batch, which the parent writes
   for the ranks to read (losses to 2e-2, each gradient leaf to 2e-2
   relative L2 error, each parameter leaf to 2e-2 of its largest value
   but for at most 1e-2 of its elements, those within 1.01 x two full
   AdamW steps); K4 and K5 launches exact per rank (one K4 forward and backward
   a step, one K5 a local leaf a step); step ms, the collectives' calls,
   bytes and share of the steps' host time, each rank's train-state bytes
   against the single rank's, the leaves left whole or that a dropped rule
   replicates, peak memory; (b) moonshot-v1-16b-a3b at full width cut to 2
   layers in fp32 on a 1x2 mesh with ``moe_ep=True`` (32 experts a rank),
   4 x 256: step-0 loss and gradients against the port's MoE with one
   capacity group a rank, to 1e-3, two steps, the all_to_all bytes a layer
   against ``epmoe``'s formula; (c) ``build_pp_forward`` over 2 stages on
   qwen3-4b cut to 4 layers in fp32 against ``LM.forward`` to 1e-3; (d)
   ``make_compressed_grad_sync`` over the four ranks on (a)'s gradients:
   the error against the fp32 mean within one quantization bucket, the
   bytes gathered against ``wire_bytes_int8_sync`` and
   ``wire_bytes_f32_allreduce``; the phase's time.
18. the dry-run against the card (``launch/dryrun.py``; its ranks of a
   fake group of four run as ``--dryrun-rank R`` with no card, alongside):
   (a) phase 7's step, counted once after its timed steps
   (``FlopCounterMode`` and the kernels' work, ``roofline.kernels``),
   against its dry-run on one rank: FLOPs equal, peak memory within 25%
   of the prediction, and the step's H100 roofline bound, the measured
   step's share of it and the MFU; (b) phase 17 (a)'s collectives by kind
   (count and bytes) on every rank against that rank's dry-run; (c) the
   sharded dense-cache decode of full-width qwen3-4b cut to 4 layers,
   bf16, 8 slots over 1,024 rows, 8 steps, on a 2x2 mesh of four rank
   processes (``--decode-mesh-rank R --port P``): logits against the
   single rank as phase 17 holds bf16 (relative L2 within 2e-2 or twice
   the single rank's own bf16 error against fp32 compute), the same in
   fp32 compute to 1e-3 (two steps), K3 launches and collectives equal to the
   dry-run's, step ms; (d) ``python -m repro_torch.launch.dryrun --arch
   qwen3-4b --shape decode_32k`` under this machine's torch.
19. tensor parallelism of the hybrid, ssm and enc-dec families on a 1x2
   ``data x model`` mesh of two rank processes (``--tp-families-rank R
   --port P``): zamba2-1.2b at 6 layers (2 x 256), rwkv6-1.6b at 4 (2 x
   128), seamless-m4t-large-v2 at 2 + 2 (2 x 64), full width, fp32
   parameters and bf16 compute, zero- and one-initialised leaves redrawn;
   each rank computes the single rank's references itself; (a) the bf16
   forward on the kernel path: logits by (c)'s bf16 rule below, launches
   exact, each K2/K6/K7 launch on the rank's heads run again and held to
   its plain version on the same shard (2e-2 of the output's largest
   value) and timed; (b) three train steps: losses and parameters after
   AdamW by phase 17's rules, each step-0 gradient shard within 2e-2 of
   the fp32-compute gradient or twice the single rank's own bf16 error,
   and in fp32 compute within 1e-3 of the single rank's; (c) 8 dense-cache
   decode steps over ``shard_cache``'s shards (4 slots, 256 rows; zamba2's
   conv shard misaligned with its mixer's split) by phase 18 (c)'s rules;
   step ms, collectives a step, the phase's time.

It then prints a ``kernels`` JSON line (K1's entries at the serve shape,
with the long shape's numbers under ``long``; phases 11 and 14's head
layouts as entries of their own, ``name[KV=..,G=..]`` and for K1, whose q
dtypes take different paths, ``name[KV=..,G=..,fp32|bf16]``, each timed in
the mode that the phase's runs launch at that layout and holding those
launches, phase 15's likewise and K3's ``rmsnorm_rows[d=..]``, phase 16's
K2 as ``name[KV=16,G=1,D=64]`` and ``name[KV=16,G=1,D=64,non-causal]``;
phases 13, 15 and 16's K4 and K5 as ``name[<arch> train]``, timed at
that phase's shapes and holding its launches, phase 17's as
``name[qwen3-4b 2x2 train]``, timed at a rank's shapes and holding rank
0's launches, phase 19's local-head launches as ``name[<arch> model split
1x2: ...]``, timed on rank 0's shard and holding both ranks' launches;
none with 0 launches), the
card's name and power limit, and, last,
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import socket
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the bound column's rates and formulas (each kernel's work), shared with
# the dry-run and the roofline
from repro_torch.roofline import kernels as rk  # noqa: E402
from repro_torch.roofline.kernels import k1_bound  # noqa: E402

T0 = time.perf_counter()
#: the card's bf16 dense peak, which every MFU line divides by
BF16_PEAK = rk.PEAK_FLOPS[torch.bfloat16]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DEV = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str) -> None:
    log(f"\n=== {name} === [{time.perf_counter() - T0:.1f} s since start]")


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Device ms per call: ``iters`` calls captured in one CUDA graph and
    replayed, timed with CUDA events, so host launch cost is excluded."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the capture stream
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def eager_ms(fn, iters: int = 50) -> float:
    """Ms per call of ``iters`` back-to-back eager calls: device time or,
    where it is larger, the host's cost of launching them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def elem_rel_err(a, b) -> float:
    """max |a - b| / |b| over the elements; where b is 0, a must be 0 too
    (else inf).  For softmax gradients, whose elements span ten orders of
    magnitude: one absolute tolerance would pass a kernel that got every
    small element wrong, so each element is held to its own size."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    rel = torch.where(b == 0, torch.where(diff == 0, 0.0, float("inf")),
                      diff / b.abs())
    return float(rel.max())


# ------------------------------------------------------------- phase 3 ----

K1_SERVE_POS = (40, 75, 110, 140, 170, 200, 231, 0)     # 974 live rows
K1_LONG_POS = (4095,) * 8                                # 32,768 live rows
K1_RAGGED_LONG_POS = (4095, 15, 16, 17, 130, 255, 511, 0)


def k1_inputs(dtype, gen, m: int = 32,
              positions=(0, 15, 16, 17, 130, 255, 511, 0), nan_dead=True,
              kv: int = 8, g: int = 4):
    """qwen3-4b decode shapes: B=8, KV=8, G=4, D=128, page 16, M=m (32: the
    served max_seq 512; 256: a 4,096-position context), or another head
    layout (``kv``, ``g``; phase 11).  Ragged positions (0, page
    boundaries, a full table), one freed slot (all-zero row at position 0,
    where the last slot's position is 0), and every dead page filled with
    NaN (``nan_dead``)."""
    b, d, page = 8, 128, 16
    n_pages = b * m + 1
    positions = torch.tensor(positions, dtype=torch.int32)
    perm = torch.randperm(n_pages - 1, generator=gen) + 1
    table = perm[: b * m].reshape(b, m).to(torch.int32)
    if int(positions[7]) == 0:
        table[7] = 0                                 # freed slot
    k = torch.randn(n_pages, page, kv, d, generator=gen)
    v = torch.randn(n_pages, page, kv, d, generator=gen)
    if nan_dead:
        for s in range(b - 1):
            dead = table[s, positions[s] // page + 1:].long()
            k[dead] = float("nan")
            v[dead] = float("nan")
    q = torch.randn(b, kv, g, d, generator=gen)
    return [t.to(DEV) for t in (q.to(dtype), k.to(dtype), v.to(dtype),
                                 table, positions)]


def k1_call(pd, q, pools, table, pos, off=None):
    """The K1 wrapper for these operands, called: int8 when ``pools`` is
    (k, v, k_scale, v_scale), partials of the shard at ``off`` when given."""
    if off is None:
        fn = pd.paged_flash_decode_int8 if len(pools) == 4 else \
            pd.paged_flash_decode
        return fn(q, *pools, table, pos)
    fn = pd.paged_flash_decode_partials_int8 if len(pools) == 4 else \
        pd.paged_flash_decode_partials
    return fn(q, *pools, table, pos, off)


def k1_plain(pd, q, pools, table, pos, off=None):
    """The plain version of ``k1_call``."""
    return pd.paged_decode_ref(q, pools[0], pools[1], table, pos,
                               *(pools[2:] or (None, None)),
                               page_offset=off or 0,
                               partials=off is not None)


def k1_library(q, pools, table, pos, off=None):
    """K1's yardstick, one PyTorch call on views made outside the timing:
    SDPA on the (shard's) gathered view, rows of dead pages and of other
    shards masked, K/V heads expanded to the G query heads (int8 partials:
    dequantized beforehand); for the normalized int8 mode two calls,
    ``dequantize_kv`` of the gathered int8 K and V laid out (B, KV, S, D),
    then SDPA with ``enable_gqa``.  Returns (callable, live rows)."""
    from repro_torch.kernels.quant import dequantize_kv
    b, kv, g, d = q.shape
    m = table.shape[1]
    pn, page = pools[0].shape[:2]
    live = torch.arange(m, device=DEV)[None] <= (pos.long() // page)[:, None]
    local = table.long() - (off or 0)
    ok = live & (local >= 0) & (local < pn)
    tbl = torch.where(ok, local, 0)
    mask = ((torch.arange(m * page, device=DEV)[None] <= pos.long()[:, None])
            & ok[:, :, None].expand(b, m, page).reshape(b, m * page))
    rows = int(mask.sum())
    mask = mask[:, None, None, :]
    qh = q.reshape(b, kv * g, 1, d)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    quant = len(pools) == 4
    if quant and off is None:
        def gathered(pool):
            x = pool[tbl].reshape(b, m * page, kv, *pool.shape[3:])
            return x.transpose(1, 2).contiguous()

        kg, vg, ksg, vsg = (gathered(t) for t in pools)
        return (lambda: sdpa(qh, dequantize_kv(kg, ksg, q.dtype),
                             dequantize_kv(vg, vsg, q.dtype), attn_mask=mask,
                             enable_gqa=True)), rows

    def heads(pool, scale):
        x = pool[tbl]
        if scale is not None:
            x = dequantize_kv(x, scale[tbl], q.dtype)
        x = x.reshape(b, m * page, kv, 1, d).expand(-1, -1, -1, g, -1)
        return x.reshape(b, m * page, kv * g, d).permute(0, 2, 1, 3) \
            .contiguous()

    kg = heads(pools[0], pools[2] if quant else None)
    vg = heads(pools[1], pools[3] if quant else None)
    return (lambda: sdpa(qh, kg, vg, attn_mask=mask)), rows


def k1_splits(pd, q, k_pool, table, quant=False) -> int:
    """The split count of K1's plan for these operands on this card."""
    b, kv, g, d = q.shape
    return pd.plan(b, kv, g, d, k_pool.shape[1], table.shape[1], q.dtype,
                   quant, False, pd._n_sms(0)).splits


def k1_agree(pd, what, q, pools, table, pos, tol):
    """One normalized K1 call against the plain version and the plain
    version of its split schedule, finite, one launch, and a second call
    bitwise equal."""
    from repro_torch.kernels import ops
    before = ops.launch_counts()
    out = k1_call(pd, q, pools, table, pos)
    counted = {n: c - before[n] for n, c in ops.launch_counts().items()
               if c != before[n]}
    again = k1_call(pd, q, pools, table, pos)
    ref = k1_plain(pd, q, pools, table, pos)
    split = pd.paged_decode_split_ref(
        q, pools[0], pools[1], table, pos, *(pools[2:] or (None, None)),
        splits=k1_splits(pd, q, pools[0], table, len(pools) == 4))
    torch.cuda.synchronize()
    err, serr = max_err(out, ref), max_err(out, split)
    finite = bool(torch.isfinite(out.float()).all())
    same = torch.equal(out, again)
    log(f"{what}: max_abs_err {err:.3e} vs plain, {serr:.3e} vs the plain "
        f"split schedule (tol {tol}), finite={finite}, two calls bitwise "
        f"equal {same}, launches {counted}")
    assert finite and err <= tol and serr <= tol, \
        f"{what} disagrees with its plain version"
    assert same, f"{what}: two calls on the same inputs differ"
    assert list(counted.values()) == [1], f"{what}: launches {counted}"


def k1_plan_check(pd) -> None:
    """K1's plan at the timed shapes: split count, grid, cluster, and its
    shared memory equal to the kernel's own figure."""
    from repro_torch.kernels import _build
    smem = _build.entry("paged_decode_smem_bytes")
    for m in (32, 256):
        for quant in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                pl = pd.plan(8, 8, 4, 128, 16, m, dtype, quant, False,
                             pd._n_sms(0))
                mine = smem(0 if dtype == torch.float32 else 1, int(quant),
                            4, 128, m)
                log(f"K1 plan M={m} {'int8' if quant else 'native'} "
                    f"{str(dtype)[6:]}: splits {pl.splits} (cluster "
                    f"{pl.cluster}, grid {pl.grid}, {pl.blocks_per_sm} "
                    f"blocks an SM, at most {pl.pages_per_split} pages a "
                    f"split), smem {pl.smem} B, kernel's {mine} B")
                assert pl.smem == mine, "K1 plan's shared memory differs"


def k1_timed(pd, what, q, pools, table, pos, off=None):
    """One K1 mode at one shape, gated and logged: its error against the
    plain version (normalized: max abs; partials: ``_triple_err``), finite,
    two calls bitwise equal; then the device times of the kernel, the plain
    version and the yardstick (``k1_library``) beside the bound."""
    got = k1_call(pd, q, pools, table, pos, off)
    again = k1_call(pd, q, pools, table, pos, off)
    ref = k1_plain(pd, q, pools, table, pos, off)
    torch.cuda.synchronize()
    if off is None:
        err = abs_err = max_err(got, ref)
        finite = bool(torch.isfinite(got.float()).all())
        same = torch.equal(got, again)
    else:
        err = _triple_err(got, ref)
        abs_err = max(max_err(a, r) for a, r in zip(got, ref))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        same = all(torch.equal(a, r) for a, r in zip(got, again))
    tol = 1e-4 if off is not None else TOL[q.dtype]
    assert finite and err <= tol and same, \
        f"{what} disagrees with its plain version or itself"
    lib, rows = k1_library(q, pools, table, pos, off)
    bms, by, nbytes = k1_bound(q, table, rows, len(pools) == 4,
                               off is not None)
    r = dict(max_abs_err=abs_err, bound_ms=bms, bound_by=by,
             ms=time_ms(lambda: k1_call(pd, q, pools, table, pos, off)),
             plain_ms=time_ms(lambda: k1_plain(pd, q, pools, table, pos,
                                               off), iters=10),
             library_ms=time_ms(lib, iters=10))
    eager = eager_ms(lambda: k1_call(pd, q, pools, table, pos, off))
    log(f"{what}, positions {pos.tolist()} ({rows} live rows): kernel "
        f"{r['ms']:.4f} ms (eager back-to-back {eager:.4f} ms), plain "
        f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
        f"{bms:.5f} ms ({by}; {nbytes} B), error {err:.3e} (tol {tol}), two "
        f"calls bitwise equal {same}")
    return r


def _k1_entry(serve, long):
    """A ``kernels`` entry: the serve shape's numbers, the long shape's
    beside them."""
    out = {key: serve[key] for key in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")}
    out["long"] = {key: long[key] for key in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms",
                                              "max_abs_err")}
    return out


def check_k1(report):
    """K1's native mode against the plain version and its split schedule
    (phase-3 inputs, fp32 and bf16; the long ragged table with NaN dead
    pages), the plan, then its times at the serve shape (974 live rows)
    and at a 4,096-position context (32,768 rows)."""
    from repro_torch.kernels import paged_decode as pd
    gen = torch.Generator().manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, table, pos = k1_inputs(dtype, gen)
        k1_agree(pd, f"K1 paged_flash_decode {str(dtype)[6:]:8s} B=8 KV=8 "
                 f"G=4 D=128 page=16 M=32", q, (k, v), table, pos,
                 TOL[dtype])
        q, k, v, table, pos = k1_inputs(dtype, gen, 256, K1_RAGGED_LONG_POS)
        k1_agree(pd, f"K1 paged_flash_decode {str(dtype)[6:]:8s} M=256 "
                 f"positions {list(K1_RAGGED_LONG_POS)}, NaN dead pages", q,
                 (k, v), table, pos, TOL[dtype])
    k1_plan_check(pd)
    # timing, bf16, finite dead pages
    q, k, v, table, _ = k1_inputs(torch.bfloat16, gen, nan_dead=False)
    pos = torch.tensor(K1_SERVE_POS, dtype=torch.int32, device=DEV)
    serve = k1_timed(pd, "K1 timing bf16 serve", q, (k, v), table, pos)
    q, k, v, table, pos = k1_inputs(torch.bfloat16, gen, 256, K1_LONG_POS,
                                    nan_dead=False)
    long = k1_timed(pd, "K1 timing bf16 long", q, (k, v), table, pos)
    report["paged_flash_decode"] = _k1_entry(serve, long)


def check_k1_int8(report):
    """K1's int8 mode: the pools of ``k1_inputs`` quantized by the port's
    ``quantize_kv`` (each dead page's NaN rows give NaN scales), with fp32
    and bf16 q, against the plain version and its split schedule; D=120
    refused; its times at the serve and long shapes."""
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels.quant import quantize_kv
    gen = torch.Generator().manual_seed(4)

    def quantized(dtype, *args, **kw):
        q, k, v, table, pos = k1_inputs(dtype, gen, *args, **kw)
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        return q, (kq, vq, ks, vs), table, pos

    for dtype in (torch.float32, torch.bfloat16):
        q, pools, table, pos = quantized(dtype)
        k1_agree(pd, f"K1 int8 paged_flash_decode_int8 q {str(dtype)[6:]:8s} "
                 f"B=8 KV=8 G=4 D=128 page=16 M=32", q, pools, table, pos,
                 TOL[dtype])
        q, pools, table, pos = quantized(dtype, 256, K1_RAGGED_LONG_POS)
        k1_agree(pd, f"K1 int8 paged_flash_decode_int8 q {str(dtype)[6:]:8s} "
                 f"M=256 positions {list(K1_RAGGED_LONG_POS)}, NaN dead "
                 f"pages and scales", q, pools, table, pos, TOL[dtype])
    kq, vq, ks, vs = pools
    cut = [t[..., :120].contiguous() for t in (q, kq, vq)]
    try:
        pd.paged_flash_decode_int8(cut[0], cut[1], cut[2], ks, vs, table, pos)
    except ValueError as e:
        assert "16-byte" in str(e), e
    else:
        raise AssertionError("K1 int8 took D=120, not a multiple of 16")
    log("K1 int8 refuses D=120 (not a multiple of 16)")
    # timing, bf16 q, finite dead pages
    q, pools, table, _ = quantized(torch.bfloat16, nan_dead=False)
    pos = torch.tensor(K1_SERVE_POS, dtype=torch.int32, device=DEV)
    serve = k1_timed(pd, "K1 int8 timing bf16 q serve", q, pools, table, pos)
    q, pools, table, pos = quantized(torch.bfloat16, 256, K1_LONG_POS,
                                     nan_dead=False)
    long = k1_timed(pd, "K1 int8 timing bf16 q long", q, pools, table, pos)
    report["paged_flash_decode_int8"] = _k1_entry(serve, long)


def k2_case(fa, dtype, n, kv, g, s, d, causal, gen):
    q = torch.randn(n * kv * g, s, d, device=DEV, generator=gen).to(dtype)
    k = torch.randn(n * kv, s, d, device=DEV, generator=gen).to(dtype)
    v = torch.randn(n * kv, s, d, device=DEV, generator=gen).to(dtype)
    out = fa.flash_attention_bhsd(q, k, v, causal=causal)
    ref = fa.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    assert bool(torch.isfinite(out.float()).all()) and err <= TOL[dtype], \
        (f"K2 {dtype} D={d} G={g} S={s} causal={causal} disagrees with its "
         f"plain version: max_abs_err {err:.3e}")
    return err


def model_layout(b, s, kv, g, d, dtype, gen, fused=False):
    """q (B, S, KV, G, D), k, v (B, S, KV, D); with ``fused``, strided
    slices of one (B, S, (KV*G + 2 KV) * D) projection."""
    if fused:
        qkv = torch.randn(b, s, (kv * g + 2 * kv) * d, device=DEV,
                          generator=gen).to(dtype)
        return (qkv[..., :kv * g * d].unflatten(-1, (kv, g, d)),
                qkv[..., kv * g * d:(kv * g + kv) * d].unflatten(-1, (kv, d)),
                qkv[..., (kv * g + kv) * d:].unflatten(-1, (kv, d)))
    return (torch.randn(b, s, kv, g, d, device=DEV, generator=gen).to(dtype),
            torch.randn(b, s, kv, d, device=DEV, generator=gen).to(dtype),
            torch.randn(b, s, kv, d, device=DEV, generator=gen).to(dtype))


def model_ref(fa, q, k, v, causal=True):
    b, s, kv, g, d = q.shape
    o = fa.flash_attention_ref(
        q.permute(0, 2, 3, 1, 4).reshape(b * kv * g, s, d),
        k.permute(0, 2, 1, 3).reshape(b * kv, s, d),
        v.permute(0, 2, 1, 3).reshape(b * kv, s, d), causal=causal)
    return o.reshape(b, kv, g, s, d).permute(0, 3, 1, 2, 4)


def time_k2(fa, what, b, s, kv, g, d, dtype, gen, causal=True):
    """K2 on the model layout (as ops.flash_attention launches it), its
    plain version, SDPA on contiguous (B, H, S, D) copies, and the bound
    from shapes, causal or not; returns the report entry."""
    from repro_torch.kernels import ops
    q, k, v = model_layout(b, s, kv, g, d, dtype, gen)

    def kernel():
        return ops.flash_attention(q, k, v, causal=causal)

    err = max_err(kernel(), model_ref(fa, q, k, v, causal))
    ms = time_ms(kernel)
    host_ms = eager_ms(kernel)
    plain_ms = time_ms(lambda: model_ref(fa, q, k, v, causal))
    qh = q.permute(0, 2, 3, 1, 4).reshape(b, kv * g, s, d).contiguous()
    kh = k.permute(0, 2, 1, 3).contiguous()
    vh = v.permute(0, 2, 1, 3).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: sdpa(qh, kh, vh, is_causal=causal,
                                  enable_gqa=g > 1))
    work = rk.flash_attention(q, k, causal)
    nbytes, flops = work.nbytes, work.total_flops
    bms, by = work.bound()
    log(f"K2 timing {what}: {str(dtype)[6:]} "
        f"{'causal' if causal else 'non-causal'} B={b} H={kv * g} "
        f"KV={kv} S={s} D={d}: kernel {ms:.4f} ms (eager back-to-back "
        f"{host_ms:.4f} ms), plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
        f"bound {bms:.5f} ms ({by}; {nbytes} B, {flops} flop), "
        f"max_abs_err {err:.3e} [{nvidia_smi_line()}]")
    assert err <= TOL[dtype], "K2 disagrees with its plain version"
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


def check_k2(report):
    """K2's two modes against the plain version: bf16 (tensor cores) and
    fp32 (CUDA cores), D 32, 64, 128, G 1 and 4, S 16, 32, 64, 128, 200,
    256, 512, 2048, causal and not; model-layout and strided (fused projection) inputs
    through ops.flash_attention, which must launch the one kernel and no
    copy; bf16 D = 80 refused; times at the serve prefill shape, at
    zamba2-1.2b's shared attention block and (fp32) at phase 4's prefill."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    gen = torch.Generator(device=DEV).manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        for d in (32, 64, 128):
            for g in (1, 4):
                worst, cases = 0.0, 0
                for s in (16, 32, 64, 128, 200, 256, 512, 2048):
                    for causal in (True, False):
                        worst = max(worst, k2_case(fa, dtype, 2, 8, g, s, d,
                                                   causal, gen))
                        cases += 1
                log(f"K2 flash_attention {str(dtype)[6:]:8s} D={d:3d} G={g}: "
                    f"{cases} cases (S 16 to 2048; causal and not), worst "
                    f"max_abs_err {worst:.3e} (limit {TOL[dtype]:g})")
    for dtype in (torch.float32, torch.bfloat16):
        for d, g in ((64, 1), (128, 4)):
            q, k, v = model_layout(2, 200, 8, g, d, dtype, gen, fused=True)
            before = ops.launch_counts()
            out = ops.flash_attention(q, k, v)
            after = ops.launch_counts()
            mode = ("flash_attention_bhsd" if dtype == torch.bfloat16
                    else "flash_attention_bhsd_fp32")
            assert after[mode] == before[mode] + 1 and \
                sum(after.values()) == sum(before.values()) + 1
            err = max_err(out, model_ref(fa, q, k, v))
            log(f"K2 model layout, strided fused-projection views "
                f"{str(dtype)[6:]} D={d} G={g} S=200: max_abs_err {err:.3e}, "
                f"out contiguous {out.is_contiguous()}")
            assert out.is_contiguous() and err <= TOL[dtype]
    from repro_torch.kernels import _build
    for dtype, mode in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for d in (32, 64, 128):
            built = _build.entry("flash_attention_smem_bytes")(
                fa._DTYPES[dtype], d)
            plan = fa.smem_bytes(mode, d)
            assert built == plan <= fa.SMEM_LIMIT, \
                (f"K2 {mode} D={d}: the kernel requests {built} B of shared "
                 f"memory, the plan (and its CPU tests) {plan}")
    log("K2 shared memory per launch, the plan's figures equal the kernel's: "
        + ", ".join(f"{m} D={d} {fa.smem_bytes(m, d)} B" for m in ("bf16",
                                                                    "fp32")
                    for d in (32, 64, 128)))
    q = torch.zeros(8, 64, 80, device=DEV, dtype=torch.bfloat16)
    before = ops.launch_counts()
    try:
        fa.flash_attention_bhsd(q, q[:2], q[:2])
        raise AssertionError("K2 took a bf16 head dim of 80")
    except ValueError as e:
        log(f"K2 bf16 D=80 refused: {e}")
    assert ops.launch_counts() == before
    # the model path's launch is the kernel alone: no permute or copy of
    # q, k, v or the output around it
    q, k, v = model_layout(8, 256, 8, 4, 128, torch.bfloat16, gen)
    ops.flash_attention(q, k, v)
    rows, _ = profiled_kernels(lambda: ops.flash_attention(q, k, v))
    log(f"K2 profiled ops.flash_attention on the model layout (8, 256, 8, "
        f"4, 128) bf16: device kernels {[(n[:60], c) for n, _, c in rows]}")
    assert len(rows) == 1 and "flash_attention_wgmma" in rows[0][0], \
        "ops.flash_attention launched more than K2"
    report["flash_attention_bhsd"] = time_k2(
        fa, "serve prefill (8 prompts of bucket 256)", 8, 256, 8, 4, 128,
        torch.bfloat16, gen)
    report["flash_attention_bhsd_zamba2"] = time_k2(
        fa, "zamba2-1.2b shared attention block", 4, 2048, 32, 1, 64,
        torch.bfloat16, gen)
    report["flash_attention_bhsd_fp32"] = time_k2(
        fa, "phase 4's fp32 prefill (4 prompts of bucket 128)", 4, 128, 8, 4,
        128, torch.float32, gen)


K3_BUFFERS = 6      # x and y of 2048 x 2560 bf16: 126 MB in turn


def rotating(inputs, fn):
    """A call of ``fn`` on the next of ``inputs`` in turn, keeping each
    output until its slot comes round again: successive calls read and
    write other buffers, so where those outgrow the L2 each call moves its
    bytes to and from device memory (a graph capture cannot reuse a buffer
    that is still held)."""
    outs, turn = [None] * len(inputs), [0]

    def call():
        i = turn[0] % len(inputs)
        turn[0] += 1
        outs[i] = fn(inputs[i])

    return call


def check_k3(report):
    from repro_torch.kernels import rmsnorm as rn
    gen = torch.Generator().manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        # ln1/ln2/final rows (decode and prefill) and q/k-norm head rows
        for n, d in ((8, 2560), (2048, 2560), (256, 128), (65536, 128)):
            x = (2 * torch.randn(n, d, generator=gen)).to(DEV, dtype)
            sc = (1 + 0.2 * torch.randn(d, generator=gen)).to(DEV)
            err = max_err(rn.rmsnorm_rows(x, sc, eps=1e-5),
                          rn.rmsnorm_ref(x, sc, eps=1e-5))
            log(f"K3 rmsnorm {str(dtype)[6:]:8s} N={n:5d} d={d:4d}: "
                f"max_abs_err {err:.3e}")
            assert err <= TOL[dtype], "K3 disagrees with its plain version"
    report["rmsnorm_rows"] = k3_timed(2048, 2560, gen)


def k3_timed(n, d, gen, what=""):
    """K3 over n x d bf16 rows, ``K3_BUFFERS`` inputs and outputs in turn:
    checked against its plain version, then timed beside it,
    ``F.rms_norm`` and the bound.  Returns the report entry."""
    from repro_torch.kernels import rmsnorm as rn
    xs = [(2 * torch.randn(n, d, generator=gen)).to(DEV, torch.bfloat16)
          for _ in range(K3_BUFFERS)]
    x = xs[0]
    sc = (1 + 0.2 * torch.randn(d, generator=gen)).to(DEV)
    err = max_err(rn.rmsnorm_rows(x, sc), rn.rmsnorm_ref(x, sc))
    assert err <= TOL[torch.bfloat16], "K3 disagrees with its plain version"
    sc16 = sc.to(torch.bfloat16)
    ms = time_ms(rotating(xs, lambda x: rn.rmsnorm_rows(x, sc)))
    host_ms = eager_ms(rotating(xs, lambda x: rn.rmsnorm_rows(x, sc)))
    plain_ms = time_ms(rotating(xs, lambda x: rn.rmsnorm_ref(x, sc)))
    lib_ms = time_ms(rotating(xs, lambda x: torch.nn.functional.rms_norm(
        x, (d,), sc16, 1e-5)))
    bms, by = rk.rmsnorm(x, d).bound()
    log(f"K3 timing bf16 N={n} d={d}{what}, {K3_BUFFERS} input and output "
        f"buffers in turn ({K3_BUFFERS * 2 * x.numel() * 2 / 1e6:.0f} MB, "
        f"beyond the 50 MB L2): kernel {ms:.4f} ms (eager "
        f"back-to-back {host_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, F.rms_norm {lib_ms:.4f} ms, bound {bms:.5f} ms "
        f"({by}) [{nvidia_smi_line()}]")
    del xs, x
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


K4_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}   # elementwise rel


def k4_check(x, y, g_nll, g_lse, vocab, what):
    """Forward (nll, lse to 1e-4 absolute; fp32 math on either dtype) and
    backward (each element to K4_BWD_TOL of its own size, the padded
    tail exactly 0) against the plain versions."""
    from repro_torch.kernels import softmax_xent as sx
    dtype = x.dtype
    nll, lse = sx.softmax_xent_fwd(x, y, vocab)
    rnll, rlse = sx.softmax_xent_ref(x, y, vocab)
    d = sx.softmax_xent_bwd(x, y, lse, g_nll, g_lse, vocab)
    rd = sx.softmax_xent_bwd_ref(x, y, lse, g_nll, g_lse, vocab)
    torch.cuda.synchronize()
    e_f = max(max_err(nll, rnll), max_err(lse, rlse))
    e_b, r_b = max_err(d, rd), elem_rel_err(d, rd)
    tail = float(d[:, vocab:].float().abs().sum())
    log(f"K4 softmax_xent {str(dtype)[6:]:8s} {what}: fwd max_abs_err "
        f"{e_f:.3e} (tol {TOL[torch.float32]}); bwd elementwise rel err "
        f"{r_b:.3e} (tol {K4_BWD_TOL[dtype]}), max_abs_err {e_b:.3e} "
        f"(|dlogits| in [{float(rd[:, :vocab].float().abs().min()):.2e}, "
        f"{float(rd.float().abs().max()):.2e}]), padded-tail grad {tail}")
    assert e_f <= TOL[torch.float32], "K4 fwd disagrees with plain"
    assert r_b <= K4_BWD_TOL[dtype] and tail == 0.0, \
        "K4 bwd disagrees with plain"
    return e_f, e_b, lse


def check_k4(report):
    from repro_torch.kernels import softmax_xent as sx
    gen = torch.Generator().manual_seed(6)
    check = k4_check
    # the train path's rows (8 x 256 tokens, qwen3 vocab) and a padded
    # vocab, with O(1) upstream gradients so both the softmax term and the
    # label term of the backward are of a size that the check can see
    for dtype in (torch.float32, torch.bfloat16):
        for n, vp, vocab in ((2048, 151936, 151936), (64, 151936, 151000)):
            x = (2 * torch.randn(n, vp, generator=gen)).to(DEV, dtype)
            y = torch.randint(0, vocab, (n,), generator=gen).to(DEV)
            g_nll = torch.rand(n, generator=gen).to(DEV)
            g_lse = torch.rand(n, generator=gen).to(DEV)
            check(x, y, g_nll, g_lse, vocab, f"N={n:4d} Vp={vp} vocab={vocab}")
            del x
    # rows that do not start on 16-byte boundaries are refused, not read
    x = torch.zeros(4, 1001, device=DEV, dtype=torch.bfloat16)
    y = torch.zeros(4, device=DEV, dtype=torch.int32)
    for fn, args in ((sx.softmax_xent_fwd, (x, y, 999)),
                     (sx.softmax_xent_bwd, (x, y, y.float(), y.float(),
                                            y.float(), 999))):
        try:
            fn(*args)
        except ValueError as e:
            assert "16-byte" in str(e), e
        else:
            raise AssertionError(f"{fn.__name__} took a 1001-column pitch")
    log("K4 refuses a 1001-column bf16 pitch (not 16-byte aligned)")
    # timing at the train path's shape, bf16 logits, the train path's
    # upstream gradients (mean loss with z-loss 1e-4)
    fwd, bwd = k4_timed(2048, 151936, gen)
    report["softmax_xent_fwd"] = fwd
    report["softmax_xent_bwd"] = bwd


def k4_timed(n, vp, gen, what=""):
    """K4's forward and backward at N x Vp bf16 logits (every column live),
    the train path's upstream gradients (mean loss, z-loss 1e-4): checked
    against the plain versions (``k4_check``), then timed beside them, the
    library call and the bound.  Returns the two report entries."""
    from repro_torch.kernels import softmax_xent as sx
    x = (2 * torch.randn(n, vp, generator=gen)).to(DEV, torch.bfloat16)
    y = torch.randint(0, vp, (n,), generator=gen).to(DEV, torch.int32)
    g_nll = torch.full((n,), 1.0 / n, device=DEV)
    _, rlse = sx.softmax_xent_ref(x, y, vp)
    g_lse = 2e-4 * rlse / n
    err_f, err_b, lse = k4_check(x, y, g_nll, g_lse, vp,
                                 f"timed inputs N={n} Vp={vp}{what}")
    ce = torch.nn.functional.cross_entropy
    fwd = dict(
        ms=time_ms(lambda: sx.softmax_xent_fwd(x, y, vp)),
        host_ms=eager_ms(lambda: sx.softmax_xent_fwd(x, y, vp)),
        plain_ms=time_ms(lambda: sx.softmax_xent_ref(x, y, vp)),
        library_ms=time_ms(lambda: ce(x.float(), y.long(),
                                      reduction="none")))
    bwd = dict(
        ms=time_ms(lambda: sx.softmax_xent_bwd(x, y, lse, g_nll, g_lse, vp)),
        host_ms=eager_ms(lambda: sx.softmax_xent_bwd(x, y, lse, g_nll, g_lse,
                                                     vp)),
        plain_ms=time_ms(lambda: sx.softmax_xent_bwd_ref(x, y, lse, g_nll,
                                                         g_lse, vp)))
    xf = x.float().requires_grad_()
    out = ce(xf, y.long(), reduction="none")
    bwd["library_ms"] = eager_ms(lambda: torch.autograd.grad(
        out, xf, g_nll, retain_graph=True), iters=20)
    del xf, out
    fwd["bound_ms"], fwd["bound_by"] = rk.softmax_xent_fwd(
        n, vp, x.element_size()).bound()
    bwd["bound_ms"], bwd["bound_by"] = rk.softmax_xent_bwd(
        n, vp, x.element_size()).bound()
    for name, r, err, lib in (("forward", fwd, err_f, "F.cross_entropy"),
                              ("backward", bwd, err_b,
                               "autograd of F.cross_entropy, eager")):
        log(f"K4 {name} timing bf16 N={n} Vp={vp}{what}: kernel "
            f"{r['ms']:.4f} ms (eager back-to-back {r['host_ms']:.4f} ms), "
            f"plain {r['plain_ms']:.4f} ms, {lib} on fp32 "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}) [{nvidia_smi_line()}]")
        r["max_abs_err"] = err
    del x, y, lse
    return fwd, bwd


K5_HYPER = dict(lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
                bias_corr1=1 - 0.9 ** 3, bias_corr2=1 - 0.95 ** 3)


def k5_inputs(n, gdtype, gen):
    g = torch.randn(n, generator=gen).to(DEV, gdtype)
    m = (0.1 * torch.randn(n, generator=gen)).to(DEV)
    v = (0.1 * torch.rand(n, generator=gen)).to(DEV)
    p = (0.02 * torch.randn(n, generator=gen)).to(DEV)
    return g, m, v, p


def k5_agree(g, m, v, p, what) -> float:
    """K5 against its plain version on copies of these operands (1e-6)."""
    from repro_torch.kernels import adamw_update as aw
    scale = torch.tensor(0.5, device=DEV)
    km, kv, kp = m.clone(), v.clone(), p.clone()
    rm, rv, rp = m.clone(), v.clone(), p.clone()
    aw.adamw_fused(g, km, kv, kp, scale, **K5_HYPER)
    aw.adamw_ref(g, rm, rv, rp, scale, **K5_HYPER)
    torch.cuda.synchronize()
    err = max(max_err(km, rm), max_err(kv, rv), max_err(kp, rp))
    log(f"K5 adamw grad {str(g.dtype)[6:]:8s} {what}: max_abs_err "
        f"{err:.3e} (tol 1e-6)")
    assert err <= 1e-6, "K5 disagrees with its plain version"
    return err


def check_k5(report):
    gen = torch.Generator().manual_seed(7)
    # the tied embedding's size (151936 x 2560), a ragged size and the
    # smallest leaves (qk norms)
    emb = 151936 * 2560
    for gdtype in (torch.float32, torch.bfloat16):
        for n in (emb, 3 * 4096 + 7, 128):
            k5_agree(*k5_inputs(n, gdtype, gen), f"n={n:9d}")
    # timing at the embedding's size with fp32 gradients (the train path's)
    report["adamw_fused"] = k5_timed(emb, gen, " (tied embedding)")


def k5_timed(n, gen, what=""):
    """K5 over n fp32 parameters with fp32 gradients (the train path's):
    checked against its plain version, then timed beside it, the library
    call and the bound.  Returns the report entry."""
    from repro_torch.kernels import adamw_update as aw
    g, m, v, p = k5_inputs(n, torch.float32, gen)
    err = k5_agree(g, m, v, p, f"n={n}{what}, the timed operands")
    scale = torch.tensor(0.5, device=DEV)
    ms = time_ms(lambda: aw.adamw_fused(g, m, v, p, scale, **K5_HYPER),
                 iters=10)
    host_ms = eager_ms(lambda: aw.adamw_fused(g, m, v, p, scale,
                                              **K5_HYPER), iters=10)
    plain_ms = time_ms(lambda: aw.adamw_ref(g, m, v, p, scale, **K5_HYPER),
                       iters=10)
    steps = [torch.tensor(3.0, device=DEV)]
    lib_ms = time_ms(lambda: torch._fused_adamw_(
        [p], [g], [m], [v], [], steps, lr=K5_HYPER["lr"], beta1=0.9,
        beta2=0.95, weight_decay=0.1, eps=1e-8, amsgrad=False,
        maximize=False, grad_scale=None, found_inf=None), iters=10)
    bms, by = rk.adamw(n, g.element_size()).bound()
    log(f"K5 timing fp32 grads, n={n}{what}: kernel {ms:.4f} ms (eager "
        f"back-to-back {host_ms:.4f} ms), plain {plain_ms:.4f} ms, "
        f"torch._fused_adamw_ {lib_ms:.4f} ms, bound {bms:.5f} ms ({by}) "
        f"[{nvidia_smi_line()}]")
    del g, m, v, p
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


def k6_inputs(b, s, h, p, n, dtype, gen):
    """Inputs as the Mamba2 block makes them: per step and head dt in
    [1e-3, 0.1] (log-uniform), per head A in [1, 16]; x = X * dt with X
    ~ N(0, 1), da = -dt * A; B, C ~ N(0, 0.25), shared by the heads."""
    dt = torch.empty(b * h, s).uniform_(math.log(1e-3), math.log(0.1),
                                        generator=gen).exp()
    a = torch.empty(h).uniform_(1.0, 16.0, generator=gen).repeat(b)
    x = torch.randn(b * h, s, p, generator=gen) * dt[..., None]
    bm = 0.5 * torch.randn(b, s, n, generator=gen)
    cm = 0.5 * torch.randn(b, s, n, generator=gen)
    return (x.to(DEV, dtype), (-dt * a[:, None]).to(DEV),
            bm.to(DEV, dtype), cm.to(DEV, dtype))


def k7_inputs(b, s, h, kd, dtype, gen):
    """The model layout r, k, v, lw (B, S, H, K), u (H, K), at the scale
    that keeps |y| of order 1: r, k, v ~ N(0, 0.15^2); lw = max(-exp(U[-6,
    1.5]), -2.5), the model's decays (w0 spans -exp(-6)..-exp(-1)) plus ones
    at the floor; u ~ N(0, 0.3^2)."""
    r, k, v = (0.15 * torch.randn(b, s, h, kd, generator=gen)
               for _ in range(3))
    lw = -torch.empty(b, s, h, kd).uniform_(-6.0, 1.5, generator=gen).exp()
    u = 0.3 * torch.randn(h, kd, generator=gen)
    return ([t.to(DEV, dtype) for t in (r, k, v)]
            + [lw.clamp(min=-2.5).to(DEV), u.to(DEV)])


def check_k6(report):
    """zamba2-1.2b's eval shape: B=4, H=64, P=N=64, chunk 256.  First one
    profiled ``ops.mamba2_ssd`` on the model layout, which must launch K6
    alone; then both modes (bf16 on the tensor cores, fp32 on the CUDA
    cores) against the plain version at S=2048 and a ragged 2000 on the
    public layout, bf16 also against the plain emulation of its rounding
    points; the model layout through ``ops.mamba2_ssd``, which must equal
    the public entry bitwise and return y contiguous; the plan's shared
    memory and blocks per SM against the kernel's; then timed on the model
    layout.  Bound: each input read once, y written once (x, da, B,
    C, y); operations of the naive recurrence (per step and head 3PN for
    the state update, 2PN for the output)."""
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import mamba2_ssd as ssd
    b, h, p, n, chunk = 4, 64, 64, 64, 256
    shape = f"B={b} H={h} P={p} N={n} chunk={chunk}"
    # the model path's launch is the kernel alone: no permute or copy of x,
    # da or y around it.  This runs at the start of the check, which phase
    # 3 runs right after K2's (see ``marked_profile``).
    x, da, bm, cm = k6_inputs(b, 2048, h, p, n, torch.bfloat16,
                              torch.Generator().manual_seed(12))
    args = (x.unflatten(0, (b, h)).transpose(1, 2).contiguous(),
            da.unflatten(0, (b, h)).transpose(1, 2).contiguous(), bm, cm)
    marked_profile("K6 profiled one ops.mamba2_ssd on the model layout bf16",
                   lambda: ops.mamba2_ssd(*args, chunk=chunk),
                   "ssd_scan_mma_kernel")
    del x, da, bm, cm, args
    gen = torch.Generator().manual_seed(10)
    for dtype in (torch.float32, torch.bfloat16):
        for s in (2048, 2000):
            x, da, bm, cm = k6_inputs(b, s, h, p, n, dtype, gen)
            out = ssd.ssd_scan_bhsd(x, da, bm, cm, chunk=chunk)
            ref = ssd.ssd_scan_ref(x, da, bm, cm, chunk=chunk)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            finite = bool(torch.isfinite(out.float()).all())
            log(f"ssd_scan_bhsd {str(dtype)[6:]:8s} {shape} S={s}: "
                f"max_abs_err {err:.3e} (tol {TOL[dtype]}; max |plain| "
                f"{float(ref.float().abs().max()):.3f}), finite={finite}")
            assert finite and err <= TOL[dtype], \
                "ssd_scan_bhsd disagrees with its plain version"
            if dtype == torch.bfloat16:
                # the bf16 mode rounds where its source says: its y equals
                # the plain emulation of those roundings, rounded to bf16,
                # in nearly every element (the rest: a rounding flipped by
                # fp32 arithmetic in another order), and that emulation is
                # within the stated 1e-2 of the all-fp32 version
                emu = ssd.ssd_scan_mma_emu(x, da, bm, cm)
                same = float((out == emu.to(dtype)).float().mean())
                emu_err = max_err(emu, ssd.ssd_scan_ref(
                    x.float(), da, bm.float(), cm.float(), chunk=chunk))
                log(f"  bf16 rounding points: kernel equal to "
                    f"ssd_scan_mma_emu rounded to bf16 in {same:.5f} of the "
                    f"elements (gate 0.999), which is {emu_err:.3e} from the "
                    f"all-fp32 plain version (gate 1e-2); max |kernel - "
                    f"emulation| {max_err(out, emu):.3e}")
                assert same >= 0.999 and emu_err <= 1e-2, \
                    "K6 bf16 rounds other than its source states"
                del emu
            # the model layout: the same kernel reading (B, S, H, P) in place
            xm = x.unflatten(0, (b, h)).transpose(1, 2).contiguous()
            dam = da.unflatten(0, (b, h)).transpose(1, 2).contiguous()
            before = ops.launch_counts()
            ym = ops.mamba2_ssd(xm, dam, bm, cm, chunk=chunk)
            after = ops.launch_counts()
            assert after["ssd_scan_bhsd"] == before["ssd_scan_bhsd"] + 1 \
                and sum(after.values()) == sum(before.values()) + 1
            same = bool(torch.equal(
                ym, out.unflatten(0, (b, h)).transpose(1, 2)))
            log(f"  model layout (B, S, H, P) through ops.mamba2_ssd: equal "
                f"to the public layout's output {same}, y contiguous "
                f"{ym.is_contiguous()}")
            assert same and ym.is_contiguous()
            if s == 2048 and dtype == torch.bfloat16:
                err_main, timed = err, (xm, dam, bm, cm)
            del x, da, bm, cm, out, ref, xm, dam, ym
    for dtype, mode in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        built = _build.entry("mamba2_ssd_smem_bytes")(ssd._DTYPES[dtype], p, n)
        assert built == ssd.smem_bytes(mode, p, n) <= ssd.SMEM_LIMIT, \
            (f"K6 {mode}: the kernel requests {built} B of shared memory, "
             f"the plan (and its CPU tests) {ssd.smem_bytes(mode, p, n)}")
    occupancy = _build.entry("mamba2_ssd_blocks_per_sm")()
    log(f"K6 shared memory per launch, the plan's figures equal the kernel's: "
        f"bf16 {ssd.smem_bytes('bf16', p, n)} B, fp32 "
        f"{ssd.smem_bytes('fp32', p, n)} B; bf16 blocks per SM: occupancy "
        f"API {occupancy}, plan {ssd.blocks_per_sm('bf16', p, n)}")
    assert occupancy == ssd.blocks_per_sm("bf16", p, n)
    xm, dam, bm, cm = timed
    ms = time_ms(lambda: ops.mamba2_ssd(*timed, chunk=chunk), iters=20)
    host_ms = eager_ms(lambda: ops.mamba2_ssd(*timed, chunk=chunk), iters=20)
    x, da = (t.transpose(1, 2).flatten(0, 1) for t in (xm, dam))
    plain_ms = time_ms(lambda: ssd.ssd_scan_ref(x, da, bm, cm, chunk=chunk),
                       iters=5)
    work = rk.ssd_scan(xm, dam, bm, cm)
    nbytes, flops = work.nbytes, work.total_flops
    bms, by = work.bound()
    log(f"ssd_scan_bhsd timing bf16 {shape} S=2048, model layout: kernel "
        f"{ms:.4f} ms (eager back-to-back {host_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, no PyTorch call computes the scan, bound "
        f"{bms:.5f} ms ({by}; {nbytes} bytes, {flops / 1e9:.2f} GFLOP)")
    report["ssd_scan_bhsd"] = dict(max_abs_err=err_main, ms=ms,
                                   plain_ms=plain_ms, bound_ms=bms,
                                   bound_by=by, library_ms=None)


def fold(t):
    """The model layout (B, S, H, D) as the public (B*H, S, D), a copy."""
    b, s, h, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b * h, s, d)


def marked_profile(what, fn, kernel):
    """One call of ``fn`` profiled between two marker kernels (a spin, a
    fill) that must both be recorded, which must show ``kernel`` as its only
    device kernel, launched once.  The profiler can miss the kernels of a
    window later in the script (PERF.md, open questions): a window that
    misses a marker is taken again (at most three times)."""
    flag = torch.zeros(1, device=DEV)
    fn()
    torch.cuda.synchronize()

    def marked():
        torch.cuda._sleep(1000)
        fn()
        flag.fill_(1.0)

    for attempt in range(1, 4):
        rows, _ = profiled_kernels(marked)
        marks = [any(m in k for k, _, _ in rows)
                 for m in ("spin_kernel", "FillFunctor")]
        rows = [r for r in rows
                if "spin_kernel" not in r[0] and "FillFunctor" not in r[0]]
        log(f"{what} between marker kernels (profile {attempt}): markers "
            f"recorded {marks}, other device kernels "
            f"{[(k[:60], c) for k, _, c in rows]}")
        if all(marks):
            break
    assert all(marks) and len(rows) == 1 and rows[0][2] == 1 \
        and kernel in rows[0][0], \
        f"{what} launched more than {kernel}, or the profiler saw nothing"


def check_k7(report):
    """rwkv6-1.6b's eval shape: B=4, H=32, K=V=64, chunk 32.  First one
    profiled ``ops.rwkv6_wkv`` on the model layout, which must launch K7
    alone (no permute or copy kernel); then both modes (bf16 on the tensor
    cores, fp32 on the CUDA cores) against the plain version at S=2048 and
    a ragged 2000, bf16 also against the plain emulation of its rounding
    points; the model layout through ``ops.rwkv6_wkv``, which must equal
    the public entry bitwise, twice, and return y contiguous; the plan's
    shared memory and blocks per SM against the kernel's; then timed on
    the model layout.  Bound: each input read once, y written once (r, k,
    v, lw, u, y); operations of the naive recurrence (per step and head
    3KV for the state update, 2KV for the output)."""
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import rwkv6_wkv as wkv
    b, h, kd, chunk = 4, 32, 64, 32
    shape = f"B={b} H={h} K=V={kd} chunk={chunk}"
    args = k7_inputs(b, 2048, h, kd, torch.bfloat16,
                     torch.Generator().manual_seed(12))
    marked_profile("K7 profiled one ops.rwkv6_wkv on the model layout bf16",
                   lambda: ops.rwkv6_wkv(*args, chunk=chunk),
                   "wkv6_mma_kernel")
    del args
    gen = torch.Generator().manual_seed(11)
    for dtype in (torch.float32, torch.bfloat16):
        for s in (2048, 2000):
            args = k7_inputs(b, s, h, kd, dtype, gen)
            u = args[4]
            public = [fold(t) for t in args[:4]]
            before = ops.launch_counts()
            out = wkv.wkv6_scan_bhsd(*public, u, chunk=chunk)
            ym = ops.rwkv6_wkv(*args, chunk=chunk)
            again = ops.rwkv6_wkv(*args, chunk=chunk)
            after = ops.launch_counts()
            assert after["wkv6_scan_bhsd"] == before["wkv6_scan_bhsd"] + 3 \
                and sum(after.values()) == sum(before.values()) + 3
            ref = wkv.wkv6_scan_ref(*public, u, chunk=chunk)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            finite = bool(torch.isfinite(out.float()).all())
            log(f"wkv6_scan_bhsd {str(dtype)[6:]:8s} {shape} S={s}: "
                f"max_abs_err {err:.3e} (tol {TOL[dtype]}; max |plain| "
                f"{float(ref.float().abs().max()):.3f}), finite={finite}")
            assert finite and err <= TOL[dtype], \
                "wkv6_scan_bhsd disagrees with its plain version"
            if dtype == torch.bfloat16:
                # the bf16 mode rounds where its source says: its y equals
                # the plain emulation of those roundings, rounded to bf16,
                # in nearly every element, and that emulation is within
                # 1e-2 of the all-fp32 version
                emu = wkv.wkv6_scan_mma_emu(*public, u)
                same = float((out == emu.to(dtype)).float().mean())
                emu_err = max_err(emu, wkv.wkv6_scan_ref(
                    *(t.float() for t in public), u, chunk=chunk))
                log(f"  bf16 rounding points: kernel equal to "
                    f"wkv6_scan_mma_emu rounded to bf16 in {same:.5f} of "
                    f"the elements (gate 0.999), which is {emu_err:.3e} from "
                    f"the all-fp32 plain version (gate 1e-2); max |kernel - "
                    f"emulation| {max_err(out, emu):.3e}")
                assert same >= 0.999 and emu_err <= 1e-2, \
                    "K7 bf16 rounds other than its source states"
                del emu
            same = bool(torch.equal(fold(ym), out))
            twice = bool(torch.equal(ym, again))
            log(f"  model layout (B, S, H, V) through ops.rwkv6_wkv: equal "
                f"to the public layout's output {same}, two calls bitwise "
                f"equal {twice}, y contiguous {ym.is_contiguous()}")
            assert same and twice and ym.is_contiguous()
            if s == 2048 and dtype == torch.bfloat16:
                err_main, timed = err, args
            del args, public, out, ref, ym, again
    for dtype, mode in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        vs = wkv.vs_for(mode, kd)
        code = wkv._DTYPES[dtype]
        smem = _build.entry("rwkv6_wkv_smem_bytes")(code, kd, vs)
        occupancy = _build.entry("rwkv6_wkv_blocks_per_sm")(code, kd, vs)
        log(f"K7 {mode}: {vs}-column V slices, {b * h * -(-kd // vs)} "
            f"blocks; shared memory kernel {smem} B, plan "
            f"{wkv.smem_bytes(mode, kd, vs)} B; blocks per SM occupancy API "
            f"{occupancy}, plan {wkv.blocks_per_sm(mode, kd, vs)}")
        assert smem == wkv.smem_bytes(mode, kd, vs) <= wkv.SMEM_LIMIT \
            and occupancy == wkv.blocks_per_sm(mode, kd, vs), \
            f"K7 {mode}: the plan's figures are not the kernel's"
    ms = time_ms(lambda: ops.rwkv6_wkv(*timed, chunk=chunk), iters=20)
    host_ms = eager_ms(lambda: ops.rwkv6_wkv(*timed, chunk=chunk), iters=20)
    public = [fold(t) for t in timed[:4]]
    plain_ms = time_ms(lambda: wkv.wkv6_scan_ref(*public, timed[4],
                                                 chunk=chunk), iters=5)
    fp32 = [t.float() for t in timed[:3]] + list(timed[3:])
    fp32_ms = time_ms(lambda: ops.rwkv6_wkv(*fp32, chunk=chunk), iters=20)
    work = rk.wkv6_scan(*timed)
    nbytes, flops = work.nbytes, work.total_flops
    bms, by = work.bound()
    fp32_work = rk.wkv6_scan(*fp32)
    fp32_bytes = fp32_work.nbytes
    fp32_bms, _ = fp32_work.bound()
    log(f"wkv6_scan_bhsd timing bf16 {shape} S=2048, model layout: kernel "
        f"{ms:.4f} ms (eager back-to-back {host_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, no PyTorch call computes the scan, bound "
        f"{bms:.5f} ms ({by}; {nbytes} bytes, {flops / 1e9:.2f} GFLOP); "
        f"fp32 mode {fp32_ms:.4f} ms (bound {fp32_bms:.5f} ms, {fp32_bytes} "
        f"bytes)")
    report["wkv6_scan_bhsd"] = dict(max_abs_err=err_main, ms=ms,
                                    plain_ms=plain_ms, bound_ms=bms,
                                    bound_by=by, library_ms=None)


# ------------------------------------------------------------- phase 4 ----

def model_check(report):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import ForwardOpts, LM
    from repro_torch.serve.kvcache import PagedCache
    cfg = dataclasses.replace(get_config("qwen3-4b"), dtype="float32")
    lm = LM(cfg)
    t0 = time.perf_counter()
    params = lm.init(11, device=DEV)
    torch.cuda.synchronize()
    log(f"fp32 params: {sum(t.numel() for t in _leaves(params))/1e9:.3f} B "
        f"in {time.perf_counter()-t0:.1f}s")
    rng = np.random.default_rng(4)
    lens = [70, 97, 115, 128]                       # one bucket of 128
    n, bucket, steps = len(lens), 128, 16
    tokens = np.zeros((n, bucket), np.int64)
    for j, plen in enumerate(lens):
        tokens[j, :plen] = rng.integers(0, cfg.vocab_size, plen)
    opts = {"kernel": ForwardOpts("flash", "kernel"),
            "plain": ForwardOpts("dense", "plain")}
    # path -> (prefill opts, decode impl, norm impl, page format)
    paths = {"kernel": ("kernel", "kernel", "kernel", "native"),
             "plain": ("plain", "gather", "plain", "native"),
             "kernel-int8": ("kernel", "kernel", "kernel", "int8"),
             "plain-int8": ("plain", "gather", "plain", "int8")}
    caches, logits = {}, {}
    tok_dev = torch.as_tensor(tokens, device=DEV)
    last = torch.as_tensor(np.array(lens) - 1, device=DEV)
    for oname, o in opts.items():
        ops.reset_launch_counts()
        lg, cache = lm.forward(params, tok_dev, o, collect_cache=True)
        torch.cuda.synchronize()
        k2 = {m: ops.launch_counts()[m] for m in ("flash_attention_bhsd",
                                                  "flash_attention_bhsd_fp32")}
        want = {"flash_attention_bhsd": 0, "flash_attention_bhsd_fp32":
                cfg.num_layers if oname == "kernel" else 0}
        log(f"fp32 {oname}-path prefill: K2 launches by mode {k2}, expected "
            f"{want}")
        assert k2 == want, "the fp32 prefill did not run K2's fp32 mode"
        if oname == "kernel":
            report["flash_attention_bhsd_fp32"]["launches"] = \
                k2["flash_attention_bhsd_fp32"]
        for name, (pre, _, _, kv_dtype) in paths.items():
            if pre != oname:
                continue
            kv = PagedCache(cfg, n, 256, page_size=16, device=DEV,
                            dtype=torch.float32, kv_dtype=kv_dtype)
            dest = np.zeros((n, bucket), np.int32)
            for j, plen in enumerate(lens):
                assert kv.alloc(j, plen + steps) == 0
                dest[j] = kv.prefill_dest(j, bucket, plen)
            kv.staged_write_prefill(kv.quantize_block(cache["layers"]),
                                    torch.as_tensor(dest, device=DEV))
            caches[name] = kv
            logits[name] = [lg[torch.arange(n, device=DEV), last]]
        del lg, cache
    # the two paths' prefill K/V differ in fp32 rounding; where a value
    # sits near a rounding boundary its int8 level differs by one (page 0,
    # the scratch page, takes the padding rows' racing writes: left out)
    moved = [(caches["kernel-int8"].state["layers"][k][:, 1:].int()
              - caches["plain-int8"].state["layers"][k][:, 1:].int()).abs()
             for k in ("k", "v")]
    log(f"int8 pools after prefill, kernel vs plain path: "
        f"{sum(int((d > 0).sum()) for d in moved)} of "
        f"{2 * sum(lens) * cfg.num_layers * cfg.num_kv_heads * cfg.resolved_head_dim}"
        f" written elements differ, by at most "
        f"{max(int(d.max()) for d in moved)} level")
    del moved
    # the same prompts landed again through LM.prefill_chunk in chunks of
    # 48 (rounds of up to 4 slots, (n, 48) each, uneven against the bucket
    # of 128) over native and int8 pages, and over int8 pages as one chunk
    # per prompt: K3 at every norm, no K2
    norms = cfg.num_layers * (2 + 2 * cfg.qk_norm) + 1
    for name, kv_dtype, chunk in (("chunked", "native", 48),
                                  ("chunked-int8", "int8", 48),
                                  ("one-chunk-int8", "int8", bucket)):
        kv, rows, rounds, k3 = chunked_prefill(lm, params, tokens, lens,
                                               kv_dtype, chunk, steps)
        log(f"fp32 {name} prefill: {rounds} chunk dispatches of up to {n} x "
            f"{chunk} tokens, K3 launches {k3} (expected {rounds} x "
            f"{norms}), K2 none")
        assert k3 == rounds * norms, "a chunk dispatch skipped a K3 norm"
        caches[name] = kv
        logits[name] = [rows]
        paths[name] = ("chunked", "kernel", "kernel", kv_dtype)
    pos = np.array(lens, np.int32)
    nxt = logits["plain"][0].argmax(-1)
    for t in range(steps):
        for name, (_, decode_impl, norm_impl, _) in paths.items():
            lg, _ = lm.decode_step(params, nxt[:, None],
                                   caches[name].decode_view(),
                                   torch.as_tensor(pos + t, device=DEV),
                                   decode_impl=decode_impl,
                                   norm_impl=norm_impl)
            logits[name].append(lg[:, -1])
        nxt = logits["plain"][-1].argmax(-1)

    def compare(kernel, plain, gate):
        worst_rel, agree, checked, worst_abs = 0.0, 0, 0, 0.0
        for a, b in zip(logits[kernel], logits[plain]):
            a, b = a[:, :cfg.vocab_size].float(), b[:, :cfg.vocab_size].float()
            assert a.shape == (n, cfg.vocab_size) \
                and bool(torch.isfinite(a).all())
            worst_abs = max(worst_abs, float((a - b).abs().max()))
            worst_rel = max(worst_rel,
                            float((a - b).abs().max() / b.abs().max()))
            top2 = b.topk(2, dim=-1).values
            decided = top2[:, 0] - top2[:, 1] > (a - b).abs().max(-1).values
            same = a.argmax(-1) == b.argmax(-1)
            agree += int(same.sum())
            checked += n
            if gate:
                assert bool((same | ~decided).all()), "greedy tokens disagree"
        return worst_rel, worst_abs, agree, checked

    for kernel, plain in (("kernel", "plain"), ("kernel-int8", "plain-int8")):
        worst_rel, _, agree, checked = compare(kernel, plain, True)
        log(f"fp32 {kernel} vs {plain} path: prefill + {steps} decode steps, "
            f"logits rel max err {worst_rel:.3e} (limit 1e-3), greedy agree "
            f"{agree}/{checked}")
        assert worst_rel <= 1e-3, \
            f"{kernel} path logits disagree with the {plain} path"
    worst_rel, worst_abs, agree, checked = compare("plain-int8", "plain",
                                                   False)
    log(f"fp32 int8 pages vs native pages (plain paths, same tokens): largest "
        f"|logit difference| {worst_abs:.4e} (rel max err {worst_rel:.3e}), "
        f"greedy agree {agree}/{checked} (reported, not a gate)")
    # chunked vs whole-prompt prefill, then 16 decode steps from each pool.
    # Native: against the bucketed prefill, to 1e-3.  int8: a chunk reads
    # its own rows and its earlier chunks' back from int8, where the
    # bucketed forward attends the float K/V (reported, not a gate); see
    # int8_chunk_gates for the whole prompt landed as one chunk
    for chunked, whole, limit in (("chunked", "kernel", 1e-3),
                                  ("chunked-int8", "kernel-int8", None)):
        worst_rel, worst_abs, agree, checked = compare(chunked, whole, True)
        first = compare_rows(logits[chunked][0], logits[whole][0], cfg)
        log(f"fp32 {chunked} vs {whole} path: final chunk rows rel max err "
            f"{first:.3e}, with {steps} decode steps {worst_rel:.3e} "
            f"({f'limit {limit:.0e}' if limit else 'reported, not a gate'}"
            f"), largest |logit difference| {worst_abs:.4e}, greedy agree "
            f"{agree}/{checked}")
        assert limit is None or worst_rel <= limit, \
            f"{chunked} prefill disagrees with {whole} prefill"
    int8_chunk_gates(lm, params, tokens, lens, steps, caches, logits,
                     compare)


#: chunked int8 prefill (chunks of 48) against the prompt landed as one
#: chunk, fp32, 16 decode steps: the largest relative max error allowed.
#: Readings on the H100 at full width (PERF.md §6): 3.8e-3 to 5.8e-3 on
#: three seeds, the faulty chunk paths 9.7e-2 and more; both controls below
#: must fail the gate
INT8_CHUNK_LIMIT = 1e-2
#: ... and in layer 0, which reads the same embeddings on both sides, the
#: share of the prompts' int8 K/V elements whose level may differ (by one)
INT8_LAYER0_SHARE = 1e-3


def int8_chunk_gates(lm, params, tokens, lens, steps, caches, logits,
                     compare) -> None:
    """Phase 4's int8 chunk gates.  Chunks of 48 and one chunk a prompt
    run different matmul shapes, so their fp32 K/V differ in rounding; a
    value near an int8 rounding boundary takes the next level on one side,
    and the later layers of both chunkings read that level.  The gate: the
    logits within ``INT8_CHUNK_LIMIT``, and layer 0's levels within one of
    each other in at most ``INT8_LAYER0_SHARE`` of its elements.

    * fp32, prompts drawn from seeds 4 (phase 4's), 5 and 6, pass;
    * two faulty chunk paths fail: one layer's scales left unwritten, and
      every chunk's K/V quantized by truncation instead of rounding to
      nearest;
    * the witness that the fp32 error is rounding: the same seed-4 inputs
      in fp64 (plain norms, gathered decode) pass with the logit limit at
      1e-3.

    Every reading prints before any gate asserts."""
    from repro_torch.models import attention as attn
    cfg = lm.cfg
    mid = cfg.num_layers // 2

    def scales_unwritten(kv):
        skip = {kv.state["layers"][k][mid].data_ptr()
                for k in ("k_scale", "v_scale")}
        real = attn._scatter_chunk_paged

        def scatter(pool, new, dest):
            if pool.data_ptr() not in skip:
                real(pool, new, dest)
        return _patched(attn, "_scatter_chunk_paged", scatter)

    def truncated(kv):
        real = attn.quantize_kv

        def quantize(x):
            _, scale = real(x)
            t = torch.trunc(x.float() / scale[..., None])
            return t.clamp(-127, 127).to(torch.int8), scale
        return _patched(attn, "quantize_kv", quantize)

    readings = [("fp32 seed 4", True,
                 compare("chunked-int8", "one-chunk-int8", True)[0],
                 INT8_CHUNK_LIMIT, caches["chunked-int8"],
                 caches["one-chunk-int8"])]
    for seed in (5, 6):
        toks = _draw(cfg, lens, tokens.shape[1], seed)
        readings.append((f"fp32 seed {seed}", True, *int8_chunk_pair(
            lm, params, toks, lens, steps)))
    for name, fault in ((f"scales of layer {mid} unwritten",
                         scales_unwritten),
                        ("quantized by truncation", truncated)):
        readings.append((f"fp32 seed 4, {name}", False, *int8_chunk_pair(
            lm, params, tokens, lens, steps, fault=fault)))
    lm64 = type(lm)(dataclasses.replace(cfg, dtype="float64"))
    rel64, limit, a, b = int8_chunk_pair(
        lm64, params, tokens, lens, steps, norm_impl="plain",
        decode_impl="gather", dtype=torch.float64)
    readings.append(("fp64 seed 4 (plain norms, gathered decode)", True,
                     rel64, 1e-3, a, b))
    verdicts = []
    for name, sound, rel, limit, a, b in readings:
        every, first = _level_flips(a, b, lens)
        ok = (rel <= limit and first[2] <= 1
              and first[0] <= INT8_LAYER0_SHARE * first[1])
        verdicts.append((name, sound, ok))
        log(f"int8 chunks of 48 vs one chunk, {name}: rel max err over the "
            f"final chunk rows and {steps} decode steps {rel:.3e} (limit "
            f"{limit:.0e}); int8 levels that differ: {every[0]} of "
            f"{every[1]} written (by at most {every[2]}), layer 0 {first[0]} "
            f"of {first[1]} (by at most {first[2]}; limit "
            f"{INT8_LAYER0_SHARE:.0e} of them, by 1): "
            f"{'passes' if ok else 'fails'}"
            f"{'' if sound else ' (a control: must fail)'}")
    del readings, a, b
    for name, sound, ok in verdicts:
        assert ok == sound, (f"int8 chunked prefill disagrees ({name})"
                             if sound else "the int8 chunk gate passes a "
                             f"faulty chunk path ({name})")


@contextlib.contextmanager
def _patched(module, name, value):
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, real)


def _draw(cfg, lens, bucket, seed):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((len(lens), bucket), np.int64)
    for j, plen in enumerate(lens):
        tokens[j, :plen] = rng.integers(0, cfg.vocab_size, plen)
    return tokens


def _level_flips(a, b, lens):
    """Two int8 caches holding the same prompts: over the prompts' rows,
    (elements differing, elements compared, largest level difference) in
    every layer and in layer 0.  Rows are read through each cache's own
    table, since the two chunkings claim pages in another order."""
    every, first = [0, 0, 0], [0, 0, 0]
    for j, plen in enumerate(lens):
        rows = []
        for kv in (a, b):
            table = torch.as_tensor(kv.table_row(j), device=DEV).long()
            pools = kv.state["layers"]
            rows.append([pools[k][:, table].flatten(1, 2)[:, :plen].int()
                         for k in ("k", "v")])
        for ra, rb in zip(*rows):
            d = (ra - rb).abs()
            for acc, part in ((every, d), (first, d[0])):
                acc[0] += int((part > 0).sum())
                acc[1] += part.numel()
                acc[2] = max(acc[2], int(part.max()))
    return every, first


def int8_chunk_pair(lm, params, tokens, lens, steps, *, norm_impl="kernel",
                    decode_impl="kernel", dtype=torch.float32, fault=None):
    """The prompts landed over int8 pages in chunks of 48 (under ``fault``,
    a context factory given the cache) and as one chunk each, then
    ``steps`` decode steps from each pool, both fed the one-chunk side's
    greedy tokens.  Returns (relative max error over the final chunk rows
    and every step's rows, ``INT8_CHUNK_LIMIT``, the chunked cache, the
    one-chunk cache)."""
    cfg = lm.cfg
    n, bucket = tokens.shape
    sides = []
    for chunk, f in ((48, fault), (bucket, None)):
        kv, rows, _, _ = chunked_prefill(lm, params, tokens, lens, "int8",
                                         chunk, steps, norm_impl=norm_impl,
                                         dtype=dtype, fault=f)
        sides.append((kv, [rows]))
    pos = np.array(lens, np.int32)
    nxt = sides[1][1][0].argmax(-1)
    for t in range(steps):
        for kv, out in sides:
            lg, _ = lm.decode_step(params, nxt[:, None], kv.decode_view(),
                                   torch.as_tensor(pos + t, device=DEV),
                                   decode_impl=decode_impl,
                                   norm_impl=norm_impl)
            out.append(lg[:, -1])
        nxt = sides[1][1][-1].argmax(-1)
    rel = max(compare_rows(a, b, cfg)
              for a, b in zip(sides[0][1], sides[1][1]))
    return rel, INT8_CHUNK_LIMIT, sides[0][0], sides[1][0]


def compare_rows(a, b, cfg) -> float:
    a, b = a[:, :cfg.vocab_size].float(), b[:, :cfg.vocab_size].float()
    return float((a - b).abs().max() / b.abs().max())


def chunked_prefill(lm, params, tokens, lens, kv_dtype, chunk, steps,
                    norm_impl="kernel", dtype=torch.float32, fault=None):
    """Land ``tokens`` (n, bucket; prompt j of ``lens[j]`` tokens) in
    ``chunk``-token chunks through ``LM.prefill_chunk`` over a fresh paged
    cache (``dtype``, page 16, max_seq 256), each round one (n', chunk)
    dispatch of the slots that still have a chunk, pages claimed by
    ``alloc_chunked``/``extend``; ``fault``, given the cache, returns a
    context the dispatches run in.  Returns (cache, each prompt's
    final-chunk logit row (n, Vp), dispatches, K3 launches during them)."""
    from repro_torch.kernels import ops
    from repro_torch.serve.kvcache import PagedCache
    cfg = lm.cfg
    n = len(lens)
    kv = PagedCache(cfg, n, 256, page_size=16, device=DEV, dtype=dtype,
                    kv_dtype=kv_dtype)
    for j, plen in enumerate(lens):
        assert kv.alloc_chunked(j, plen + steps, min(chunk, plen)) == 0
    rows = [None] * n
    done = [0] * n
    rounds = 0
    ops.reset_launch_counts()
    with fault(kv) if fault else contextlib.nullcontext():
        while any(d < plen for d, plen in zip(done, lens)):
            rounds += _chunk_round(lm, params, kv, tokens, lens, chunk,
                                   steps, done, rows, norm_impl)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention_bhsd"] == \
        counts["flash_attention_bhsd_fp32"] == 0
    kv.verify()
    return kv, torch.stack(rows), rounds, counts["rmsnorm_rows"]


def _chunk_round(lm, params, kv, tokens, lens, chunk, steps, done, rows,
                 norm_impl) -> int:
    """One (n', chunk) ``LM.prefill_chunk`` dispatch of the slots that
    still have a chunk; advances ``done`` and fills ``rows`` as prompts
    finish.  Returns 1."""
    n = len(lens)
    slots = [j for j in range(n) if done[j] < lens[j]]
    tok = np.zeros((len(slots), chunk), np.int64)
    dest = np.zeros((len(slots), chunk), np.int32)
    table = np.zeros((len(slots), kv.max_pages), np.int32)
    start, last = np.zeros(len(slots), np.int64), np.zeros(len(slots),
                                                           np.int64)
    for i, j in enumerate(slots):
        end = min(done[j] + chunk, lens[j])
        assert kv.extend(j, lens[j] + steps if end == lens[j] else end)
        tok[i, :end - done[j]] = tokens[j, done[j]:end]
        dest[i] = kv.chunk_dest(j, done[j], end, chunk)
        table[i] = kv.table_row(j)
        start[i], last[i] = done[j], end - 1
    lg, _ = lm.prefill_chunk(
        params, torch.as_tensor(tok, device=DEV),
        {**kv.state, "page_table": torch.as_tensor(table, device=DEV)},
        torch.as_tensor(start, device=DEV), torch.as_tensor(dest, device=DEV),
        torch.as_tensor(last, device=DEV), norm_impl=norm_impl)
    for i, j in enumerate(slots):
        done[j] = int(last[i]) + 1
        if done[j] == lens[j]:
            rows[j] = lg[i, -1]
    return 1


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    else:
        for v in tree.values():
            yield from _leaves(v)


# ------------------------------------------------------------- phase 5 ----

def serve_prompts(cfg):
    """Phase 5's 16 prompts of 16-200 tokens, 4 sharing a 64-token prefix
    (phase 10 serves them again over a sharded pool)."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, cfg.vocab_size, 64)
    prompts = []
    for i in range(16):
        plen = int(rng.integers(16, 201))
        prompt = rng.integers(0, cfg.vocab_size, plen)
        if i % 4 == 0:                        # 4 prompts share a prefix
            prompt = np.concatenate([shared, prompt[:max(plen - 64, 8)]])
        prompts.append(prompt.astype(np.int32))
    return prompts


def serve_runs(lm, params, runs, log_name, pool_group=None, profile=True,
               images=None):
    """Phase 5's served runs (phase 10's on one rank of a sharded pool):
    after a two-request warm-up, the 16 requests through one engine per
    ``(label, engine keywords)`` of ``runs`` (max_batch 8, max_seq 512, page
    16; the default pool, 257 pages), each run gated on its own launch
    counts and, on one card, on one graph replay per decode iteration
    (none with ``cuda_graph=False``; a sharded pool steps eagerly).  A vlm
    config's request i carries ``images[i]``.  Returns {label: {"streams",
    "launches", "decode_ms", "pool_bytes", ...}}."""
    from repro_torch.kernels import ops
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.kvcache import page_kv_bytes
    cfg = lm.cfg
    prompts = serve_prompts(cfg)
    sharded = pool_group is not None

    def requests(staggered=False):
        # staggered: 8-56 new tokens, so streams finish at different
        # iterations and later admissions land among live streams
        return [Request(i, p, max_new_tokens=8 + 13 * i % 49 if staggered
                        else 32,
                        img_embeds=None if images is None else images[i])
                for i, p in enumerate(prompts)]

    def engine(**kw):
        return ServeEngine(lm, params, max_batch=8, max_seq=512,
                           page_size=16, device=DEV, pool_group=pool_group,
                           **kw)

    warm = engine()                          # cuBLAS and allocator warm-up
    for r in requests()[:2]:
        warm.submit(r)
    warm.run_until_drained()
    del warm
    out = {}
    for label, kw in runs:
        tag = f"[{log_name} {label}]"
        free()
        kw = dict(kw)
        staggered = kw.pop("staggered", False)
        before = torch.cuda.memory_allocated()
        eng = engine(**kw)
        torch.cuda.synchronize()
        pool_bytes = torch.cuda.memory_allocated() - before
        graph = eng._graph is not None
        assert graph == (not sharded and kw.get("cuda_graph", True)), \
            f"{tag} captured a graph: {graph}"
        decode_ms, prefill_ms, replays = [], [], []

        def timed(fn, sink):
            def run(*a):
                t0 = time.perf_counter()
                out = fn(*a)
                torch.cuda.synchronize()
                sink.append((time.perf_counter() - t0) * 1e3)
                return out
            return run

        def counted_replay(view, replay=eng._replay):
            replays.append(1)
            return replay(view)

        captured = eng._graph
        eng._fused = timed(eng._fused, decode_ms)
        eng._prefill_group = timed(eng._prefill_group, prefill_ms)
        eng._chunk_group = timed(eng._chunk_group, prefill_ms)
        eng._replay = counted_replay
        per_chip = [0] * eng.kv.chips          # fresh pages handed out

        def counted(need, take=getattr(eng.kv, "_take_fresh", None)):
            pages = take(need)
            for pid in pages:
                per_chip[pid // eng.kv.pages_per_chip] += 1
            return pages

        shared = {}                             # prompt length -> shared

        def chunk_alloc(slot, length, first, prefix=None, tenant=None,
                        alloc=getattr(eng.kv, "alloc_chunked", None)):
            got = alloc(slot, length, first, prefix=prefix, tenant=tenant)
            if got is not None:
                shared[len(prefix)] = shared.get(len(prefix), []) + [got]
            return got

        if eng.kv.backend == "paged":
            eng.kv._take_fresh = counted
            eng.kv.alloc_chunked = chunk_alloc
        reqs = requests(staggered)
        # the host time of each token of each stream (every step ends in a
        # synchronizing copy of the sampled ids), for the longest wait
        # between two tokens of one stream
        seen, gaps, step_ms = {}, [], []

        def stepped(step=eng.step):
            t0 = time.perf_counter()
            live = step()
            now = time.perf_counter()
            step_ms.append((now - t0) * 1e3)
            for r in reqs:
                k = len(r.out_tokens)
                if k and seen.get(r.id, (0,))[0] != k:
                    if r.id in seen:
                        gaps.append((now - seen[r.id][1]) * 1e3)
                    seen[r.id] = (k, now)
            return live

        eng.step = stepped
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        reg = eng.reg
        iters = reg.counter("serve_iterations_total").get()
        decodes = reg.counter("serve_decode_dispatches_total").get()
        prefills = reg.counter("serve_prefill_dispatches_total").get()
        tokens = sum(len(r.out_tokens) for r in done)
        assert len(done) == 16 and all(
            r.status == "completed" and len(r.out_tokens) == r.max_new_tokens
            for r in done)
        assert all(0 <= t < cfg.vocab_size for r in done for t in r.out_tokens)
        assert decodes == iters, (decodes, iters)
        assert len(replays) == (decodes if graph else 0), \
            f"{tag} {len(replays)} graph replays for {decodes} decode steps"
        assert eng._graph is captured, f"{tag} the decode step was recaptured"
        L = cfg.num_layers
        # K3 runs every RMSNorm; a LayerNorm config's norms are plain torch
        norms = (L * (2 + 2 * cfg.qk_norm) + 1 if cfg.norm == "rmsnorm"
                 else 0)
        k1 = None
        if eng.kv.backend == "paged" and eng.decode_impl == "kernel":
            k1 = ("paged_flash_decode" + ("_partials" if sharded else "")
                  + ("_int8" if eng.kv.quantized else ""))
        want = {name: 0 for name in launches}
        # a chunk dispatch runs every norm through K3 and no K2
        want.update({"flash_attention_bhsd": 0 if eng.chunk else prefills * L,
                     "rmsnorm_rows": (decodes + prefills) * norms})
        if k1:
            want[k1] = decodes * L
        log(f"{tag} launch counts {launches}, expected {want}")
        assert launches == want, "the main path did not run every kernel"
        chunks = {}
        if eng.chunk:
            c = eng.chunk
            # each prompt's chunks, less the leading ones that lie wholly on
            # the landed shared pages its admission found
            lens = sorted(len(p) for p in prompts)
            assert sorted(k for k, v in shared.items() for _ in v) == lens
            skip = sum(min(sh, plen - 1) // c
                       for plen, v in shared.items() for sh in v)
            chunks = {k: reg.counter(f"serve_prefill_{k}").get()
                      for k in ("chunks_total", "chunk_stalls_total",
                                "chunks_skipped_total")}
            stall_iters = reg.counter("serve_decode_stall_iters").get()
            want_chunks = sum(-(-plen // c) for plen in lens) - skip
            log(f"{tag} {chunks['chunks_total']:.0f} chunks of {c} in "
                f"{prefills:.0f} dispatches (budget {eng.budget}), expected "
                f"{want_chunks} from the prompt lengths less {skip} skipped "
                f"on shared pages (counted "
                f"{chunks['chunks_skipped_total']:.0f}); "
                f"{chunks['chunk_stalls_total']:.0f} page-grant stalls, "
                f"decode stall iterations {stall_iters:.0f} (0 by "
                f"construction: a chunk round never spends past the budget; "
                f"the wait between tokens is the measure of the stall)")
            assert chunks["chunks_total"] == want_chunks \
                and chunks["chunks_skipped_total"] == skip, \
                "the chunk count is not what the prompts predict"
            assert stall_iters == 0, \
                "a chunk round spent more prefill tokens than the budget"
        ttft = reg.histogram("serve_ttft_seconds").quantile(0.5) * 1e3
        st = eng.kv.memory_stats()
        gs = eng.graph_stats or {}
        log(f"{tag} served 16 requests, {tokens} tokens in {wall:.3f}s: "
            f"{tokens / wall:.1f} tok/s, TTFT p50 {ttft:.1f} ms, "
            f"{iters:.0f} iterations, {prefills:.0f} prefill dispatches, mean "
            f"decode step {np.mean(decode_ms):.2f} ms "
            f"({'one CUDA graph replay' if graph else 'eager'}; "
            f"{len(replays)} replays), mean prefill "
            f"{'chunk ' if eng.chunk else ''}dispatch "
            f"{np.mean(prefill_ms):.2f} ms, longest wait between two tokens "
            f"of one stream {max(gaps):.2f} ms, pages shared "
            f"{reg.gauge('serve_kv_pages_shared').get():.0f} at last "
            f"admission, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"[{nvidia_smi_line()}]")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        pool_tensor_bytes = sum(t.numel() * t.element_size()
                                for t in eng.kv.state["layers"].values())
        log(f"{tag} KV cache [{st.backend}]: memory_stats {st.bytes_total} B "
            f"({st.pages_total + 1 if st.page_size else 0} pages of "
            f"{st.page_size}, scales {st.bytes_scales} B; per chip "
            f"{st.bytes_per_chip} B + sink {st.bytes_sink_per_chip} B), "
            f"pool tensors {pool_tensor_bytes} B, memory_allocated grew "
            f"{pool_bytes} B at construction; CUDA graph: capture "
            f"{gs.get('capture_ms', 0.0):.1f} ms, its private pool "
            f"{gs.get('pool_bytes', 0)} B reserved; saved vs bf16 pages "
            f"{reg.gauge('serve_kv_quant_bytes_saved').get():.0f} B; fresh "
            f"pages handed out per chip {per_chip}")
        assert pool_tensor_bytes == st.bytes_total or sharded
        # one more fused step, all slots parked (on the scratch page when
        # paged): the same launches and host work as a step of the run, a
        # graph replay where the run replayed one (every rank of a sharded
        # pool takes it, one profiled)
        zeros = np.zeros(8, np.int64)

        def step():
            return ServeEngine._fused(eng, zeros, zeros).cpu()

        prof = {}
        if graph:
            # the replay's device time alone (CUDA events over 20 replays,
            # every slot parked): the step's busy time, whether or not the
            # profiler records the window below
            view = eng.kv.decode_view()
            eng._replay(view)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                eng._replay(view)
            end.record()
            end.synchronize()
            prof["replay_ms"] = start.elapsed_time(end) / 20
            log(f"{tag} one replay on the device: {prof['replay_ms']:.3f} ms "
                f"(CUDA events, 20 replays); of the run's mean decode step "
                f"{np.mean(decode_ms):.2f} ms the device is idle "
                f"{1 - prof['replay_ms'] / np.mean(decode_ms):.3f} "
                f"[{nvidia_smi_line()}]")
        if profile and not eng.chunk and not staggered:
            # the window must hold K1's launches (every rank of a sharded
            # pool takes the step once, so it is not taken again there)
            expect = ({"paged_decode_split_kernel": L}
                      if k1 and not sharded else None)
            groups, busy, rows, wall_ms = profile_call(
                f"{tag} fused decode step (B=8), "
                f"{'one graph replay' if graph else 'eager'}", step, top=6,
                expect=expect)
            if busy:
                seen = {part: sum(n for key, _, n in rows if part in key)
                        for part in ("paged_decode_split", "rmsnorm_kernel")}
                prof.update(busy_ms=busy, wall_ms=wall_ms,
                            kernels=sum(n for _, _, n in rows),
                            idle=1 - busy / wall_ms,
                            k1_ms=groups.get("K1 paged_decode", 0.0),
                            k3_ms=groups.get("K3 rmsnorm", 0.0))
                log(f"{tag} profiled step: {prof['kernels']} kernels, busy "
                    f"{busy:.3f} ms, idle share {prof['idle']:.3f}; inside "
                    f"it K1 {prof['k1_ms']:.4f} ms over the "
                    f"{seen['paged_decode_split']} launches the profiler saw "
                    f"({L if k1 else 0} launched), K3 {prof['k3_ms']:.4f} ms "
                    f"over {seen['rmsnorm_kernel']} ({norms} launched) "
                    f"[{nvidia_smi_line()}]")
        else:
            step()
        if profile and label == "native":
            # one prefill forward of the largest bucket, 8 prompts of 256:
            # K2 runs on the model layout, with no copy of q, k, v or out
            toks = torch.as_tensor(np.stack([
                np.resize(p, 256) for p in prompts[:8]]), device=DEV)

            def prefill():
                with torch.no_grad():
                    lm.forward(params, toks, collect_cache=True)

            profile_call(f"{tag} prefill forward (8 x 256)", prefill, top=8)
        out[label] = dict(
            streams={r.id: r.out_tokens for r in done}, launches=launches,
            per_chip=per_chip, pool_tensor_bytes=pool_tensor_bytes,
            k1=k1, decode_ms=float(np.mean(decode_ms)), tok_s=tokens / wall,
            step_ms=float(np.mean(step_ms)), steps=eng._iter,
            ttft_ms=ttft, pool_bytes=pool_bytes, graph=graph,
            prefill_ms=float(np.mean(prefill_ms)), max_gap_ms=max(gaps),
            prefills=prefills, chunks=chunks, budget=eng.budget,
            stall_iters=reg.counter("serve_decode_stall_iters").get(),
            replays=len(replays), stats=dataclasses.asdict(st),
            page_bytes=page_kv_bytes(cfg, 16, eng.kv.dtype, st.kv_dtype),
            capture_ms=gs.get("capture_ms"),
            graph_pool_bytes=gs.get("pool_bytes"), peak_gib=peak_gib,
            store=(eng.kv.store.stats()
                   if getattr(eng.kv, "store", None) else None), **prof)
        del eng, done, reqs
    return out


def one_step_checks(lm, params) -> None:
    """Phase 5's one-step gates, on phase 5's first 8 prompts admitted
    together and one decode step: (a) the replay's (B, V) rows bitwise
    equal to the same step run eagerly on the same static inputs (its K/V
    writes rewrite the same rows with the same values); (b) the contiguous
    cache's rows bitwise equal to paged ``decode_impl="gather"`` rows (page
    16, M·page == S = 512), both from their graphs."""
    from repro_torch.serve import Request, ServeEngine
    prompts = serve_prompts(lm.cfg)[:8]
    rows = {}
    for label, kw in (("native", {}), ("gather", {"decode_impl": "gather"}),
                      ("contiguous", {"cache_backend": "contiguous"})):
        eng = ServeEngine(lm, params, max_batch=8, max_seq=512, page_size=16,
                          device=DEV, **kw)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, max_new_tokens=32))
        eng.step()                            # admit all 8, one decode step
        assert eng.active.all()
        rows[label] = eng._graph_out[0].clone()
        if label == "native":
            view = eng.kv.decode_view()
            eager, _ = eng._decode(view)
            replayed, _ = eng._replay(view)
            same = torch.equal(eager, replayed)
            log(f"[serve one step] native: replay vs eager rows (8 x "
                f"{lm.cfg.vocab_size}) bitwise equal {same}, max |diff| "
                f"{max_err(eager, replayed):.3e}")
            assert same, "a replayed step differs from the eager step"
        del eng
        free()
    same = torch.equal(rows["gather"], rows["contiguous"])
    log(f"[serve one step] contiguous vs paged gather rows bitwise equal "
        f"{same}, max |diff| {max_err(rows['gather'], rows['contiguous']):.3e}"
        f"; K1 vs gather max |diff| "
        f"{max_err(rows['native'], rows['gather']):.3e} (reported)")
    assert same, "contiguous and paged gather logits differ"


def serve(report):
    """The same 16 requests served through the graph over native bf16
    pages, then over int8 pages, then over the contiguous cache, then with
    chunked prefill (chunks of 64, budget 128) over native and int8 pages,
    then with staggered lengths (8-56 new tokens) whole-prompt and chunked
    (budget 128, and 64: one chunk an iteration) over native pages, then
    the first two eagerly; each run is gated on its own launch counts
    (and a chunked run on its chunk count and its stall counter), the
    graph's streams on the eager ones.  Returns the streams of each run
    through the graph, the native run's numbers, and the model and weights
    (phase 5b serves them again)."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    lm = LM(get_config("qwen3-4b"))
    params = lm.init(7, device=DEV)
    # the graph runs first: their profiled steps are the ones to keep where
    # the profiler starts missing windows (PERF.md, open questions)
    chunked = {"prefill_chunk": 64, "prefill_budget": 128}
    runs = serve_runs(lm, params, (
        ("native", {}), ("int8", {"kv_dtype": "int8"}),
        ("contiguous", {"cache_backend": "contiguous"}),
        ("chunked", chunked),
        ("chunked-int8", dict(chunked, kv_dtype="int8")),
        ("staggered", {"staggered": True}),
        ("chunked-staggered", dict(chunked, staggered=True)),
        ("chunked-staggered-64", dict(chunked, staggered=True,
                                      prefill_budget=64)),
        ("native-eager", {"cuda_graph": False}),
        ("int8-eager", {"kv_dtype": "int8", "cuda_graph": False})), "serve")
    for label in ("native", "int8"):
        run, names = runs[label], (runs[label]["k1"],)
        if label == "native":
            names += ("flash_attention_bhsd", "rmsnorm_rows")
        for name in names:
            report[name]["launches"] = run["launches"][name]
        same = run["streams"] == runs[label + "-eager"]["streams"]
        log(f"[serve {label}] graph streams equal the eager streams token "
            f"for token: {same}; decode step {run['decode_ms']:.2f} ms "
            f"(graph) vs {runs[label + '-eager']['decode_ms']:.2f} ms "
            f"(eager), {run['tok_s']:.1f} vs "
            f"{runs[label + '-eager']['tok_s']:.1f} tok/s "
            f"[{nvidia_smi_line()}]")
        assert same, f"[{label}] graph streams differ from eager streams"
    streams = {label: runs[label]["streams"]
               for label in ("native", "int8", "contiguous", "chunked",
                             "chunked-int8")}
    for other, base in (("int8", "native"), ("contiguous", "native"),
                        ("chunked", "native"), ("chunked-int8", "int8")):
        same = sum(a == b for i in streams[base]
                   for a, b in zip(streams[base][i], streams[other][i]))
        first = sum(streams[base][i][0] == streams[other][i][0]
                    for i in streams[base])
        log(f"{other} vs {base} streams (bf16, random weights): {same}/512 "
            f"tokens equal, first tokens equal {first}/16 (reported, not a "
            f"gate)")
    for label, base in (("chunked", "native"), ("chunked-int8", "int8"),
                        ("chunked-staggered", "staggered"),
                        ("chunked-staggered-64", "staggered")):
        run, whole = runs[label], runs[base]
        log(f"[serve {label}] vs whole-prompt [{base}]: prefill dispatch "
            f"{run['prefill_ms']:.2f} ms ({run['prefills']:.0f} chunk "
            f"rounds) vs {whole['prefill_ms']:.2f} ms ({whole['prefills']:.0f}"
            f" bucketed); decode step {run['decode_ms']:.2f} vs "
            f"{whole['decode_ms']:.2f} ms; {run['tok_s']:.1f} vs "
            f"{whole['tok_s']:.1f} tok/s; TTFT p50 {run['ttft_ms']:.1f} vs "
            f"{whole['ttft_ms']:.1f} ms; longest wait between two tokens of "
            f"one stream {run['max_gap_ms']:.2f} vs {whole['max_gap_ms']:.2f}"
            f" ms (budget {run['budget']}); decode stall iterations "
            f"{run['stall_iters']:.0f} (0 by construction) vs "
            f"{whole['stall_iters']:.0f} [{nvidia_smi_line()}]")
    one_step_checks(lm, params)
    chunk_attention_time()
    return streams, runs, (lm, params)


def chunk_attention_time() -> None:
    """One layer's chunk attention, which has no kernel (as JAX's has
    none): the gather of each slot's live pages and the masked fp32
    softmax over them (``gather_pages`` + ``chunk_attention``) at phase
    5's chunk round of two 64-token chunks (positions 64-127 and 128-191,
    a 257-page pool, M = 32), bf16; timed as a CUDA graph of 50 calls and
    back to back eagerly, beside its bound (the live rows read once, the
    causal work each query row needs) and SDPA on the same gathered view.
    Reported, not a gate."""
    import torch.nn.functional as F
    from repro_torch.models.attention import chunk_attention, gather_pages
    gen = torch.Generator(device=DEV).manual_seed(21)
    n, c, kv, g, d, page, m, pages = 2, 64, 8, 4, 128, 16, 32, 257

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEV,
                           dtype=torch.bfloat16)

    k, v, q = randn(pages, page, kv, d), randn(pages, page, kv, d), \
        randn(n, c, kv, g, d)
    table = (torch.randperm(pages - 1, generator=gen, device=DEV)[:n * m]
             + 1).view(n, m).int()
    last = torch.tensor([127, 191], device=DEV)
    qpos = last[:, None] - c + 1 + torch.arange(c, device=DEV)

    def plain():
        return chunk_attention(q, gather_pages(k, table, last),
                               gather_pages(v, table, last), qpos, last)

    kg, vg = gather_pages(k, table, last), gather_pages(v, table, last)
    mask = (torch.arange(m * page, device=DEV)[None, None, :]
            <= qpos[:, :, None])[:, None]                   # (n, 1, C, S)

    def library():
        return F.scaled_dot_product_attention(
            q.flatten(2, 3).transpose(1, 2), kg.transpose(1, 2),
            vg.transpose(1, 2), attn_mask=mask, enable_gqa=True)

    ref = plain().flatten(2, 3).transpose(1, 2).float()
    err = max_err(library(), ref)
    live = int(((last // page) + 1).sum()) * page
    cols = int((qpos + 1).sum())
    nbytes = 2 * (2 * live * kv * d + n * c * kv * g * d) + 4 * n * m
    t_bound, by = rk.Work(
        nbytes, ((torch.bfloat16, 4 * cols * kv * g * d),)).bound()
    ms, eager, lib = time_ms(plain), eager_ms(plain), time_ms(library)
    log(f"chunk attention (no kernel), one layer, 2 chunks of 64 over 32 "
        f"table pages ({live} live rows), bf16: {ms:.4f} ms (eager back to "
        f"back {eager:.4f} ms; x 36 layers = {36 * eager:.2f} ms a chunk "
        f"dispatch), SDPA on the gathered view {lib:.4f} ms (max_abs_err "
        f"{err:.3e} against it), bound {t_bound:.5f} ms ({by}; {nbytes} B)"
        f" [{nvidia_smi_line()}]")


# ------------------------------------------------------------ phase 5b ----

SERVE_CHECKS = ("dispatch_invariant", "streams_progressing",
                "cache_invariants")


def pageable_h2d_gbps(nbytes: int = 1 << 22) -> float:
    """The H2D probe's copy from a pageable host buffer (CUDA stages it
    through a pinned buffer of its own): for reference only."""
    host = torch.ones(nbytes, dtype=torch.uint8)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=DEV)
    dst.copy_(host)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dst.copy_(host)
    torch.cuda.synchronize()
    return nbytes / max(time.perf_counter() - t0, 1e-9) / 1e9


def infra_probes() -> None:
    """(a) Autopilot's two probes on the card: a one-node ``SimCluster``
    and ``Autopilot(measure_real=True)``; both baselines finite and > 0,
    every check PASS, no alert from ``DEFAULT_RULES + SERVE_RULES``.  Then
    the control: a power brake and a PCIe downgrade injected on the node
    must read 0.375x and 0.3x of the measured baselines, ERR and fire
    ``autopilot_err``.  Five more readings of each probe, the pageable copy
    and a 64 MiB pinned copy are printed for reference."""
    from repro_torch.core import alerts, health
    from repro_torch.core.cluster import FailureKind, SimCluster
    from repro_torch.core.telemetry import MetricsRegistry
    reg = MetricsRegistry()
    cluster = SimCluster(1, registry=reg)
    ap = health.Autopilot(cluster, reg, measure_real=True, device=DEV)
    t0 = time.perf_counter()
    res = {r.name: r for r in ap.run_checks()}
    first_ms = (time.perf_counter() - t0) * 1e3
    base = {name: res[name].value
            for name in ("gpu_dgemm_gflops", "pcie_h2d_gbps")}
    again = {"gemm": [health._measure_gemm_gflops(device=DEV)
                      for _ in range(5)],
             "h2d": [health._measure_h2d_gbps(device=DEV)
                     for _ in range(5)],
             "pageable": [pageable_h2d_gbps() for _ in range(5)],
             "h2d 64 MiB": [health._measure_h2d_gbps(64 << 20, device=DEV)
                            for _ in range(3)]}
    log(f"[infra probes] gpu_dgemm_gflops {base['gpu_dgemm_gflops']:.1f} "
        f"GF/s (fp32 256 x 256, 2 chained, host clock), pcie_h2d_gbps "
        f"{base['pcie_h2d_gbps']:.3f} GB/s (4 MiB pinned); first run_checks "
        f"(both probes) {first_ms:.2f} ms [{nvidia_smi_line()}]")
    for name, vals in again.items():
        log(f"[infra probes] {name} again: "
            + ", ".join(f"{v:.3f}" for v in vals)
            + (" GF/s" if name == "gemm" else " GB/s"))
    log("[infra probes] checks: " + ", ".join(
        f"{r.name}={r.value:.3f} {'PASS' if r.passed else 'ERR'}"
        for r in res.values()))
    assert all(math.isfinite(v) and v > 0 for v in base.values()), base
    assert all(r.passed for r in res.values()), res
    mgr = alerts.AlertManager(reg, rules=alerts.DEFAULT_RULES
                              + alerts.SERVE_RULES)
    assert mgr.evaluate() == [], mgr.fired
    # the control: each fault ERRs the check it is sensitive to
    for kind, check, factor in (
            (FailureKind.POWER_BRAKE, "gpu_dgemm_gflops", 0.375),
            (FailureKind.PCIE_DEGRADE, "pcie_h2d_gbps", 0.3)):
        cluster.inject(0, kind)
        res = {r.name: r for r in ap.run_checks()}
        log(f"[infra probes] after {kind.value}: {check} "
            f"{res[check].value:.3f} ({res[check].value / base[check]:.3f}x "
            f"the baseline) {'PASS' if res[check].passed else 'ERR'}")
        assert res[check].value == base[check] * factor
        assert not res[check].passed, f"{check} passed under {kind.value}"
    errs = sorted(a.labels["check"] for a in mgr.evaluate()
                  if a.rule == "autopilot_err")
    log(f"[infra probes] autopilot_err fired for {errs}")
    assert errs == ["gpu_dgemm_gflops", "pcie_h2d_gbps"], mgr.fired


def health_costs(lm, params, reps: int = 200) -> dict:
    """Host ms of one ``serve_light_checks`` + ``evaluate`` (with
    ``verify_cache``, so the checks walk the allocator once) and of one
    ``kv.verify()``, on an engine whose 8 slots are live (phase 5's
    prompts, two steps in); medians of ``reps`` calls."""
    from repro_torch.core import alerts, health
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(lm, params, max_batch=8, max_seq=512, page_size=16,
                      device=DEV, verify_cache=True)
    for i, p in enumerate(serve_prompts(lm.cfg)):
        eng.submit(Request(i, p, max_new_tokens=32))
    for _ in range(2):
        eng.step()
    assert eng.active.all()
    mgr = alerts.AlertManager(eng.reg, sinks=[], rules=alerts.DEFAULT_RULES
                              + alerts.SERVE_RULES)
    checks, verify = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        health.serve_light_checks(eng)
        mgr.evaluate()
        t1 = time.perf_counter()
        eng.kv.verify()
        verify.append((time.perf_counter() - t1) * 1e3)
        checks.append((t1 - t0) * 1e3)
    assert mgr.fired == [], mgr.fired
    return {"checks_ms": float(np.median(checks)),
            "verify_ms": float(np.median(verify)),
            "pages_in_use": eng.kv.memory_stats().pages_in_use}


def infrastructure(model, native_streams, native_run) -> None:
    """(b) Phase 5's native-page workload on its model and weights through
    the CUDA-graph step with the health loop wired in (``alerts`` over the
    engine's registry, ``health_every=16``, ``verify_cache=True``): its 16
    streams equal phase 5's native graph streams token for token (the
    checks are host code, so nothing on the device changes); one replay a
    decode step and the run's launch counts exact (``serve_runs``); the
    checks ran ceil(steps / 16) times and read every ``autopilot_serve_*``
    gauge 1.0 each time; no alert fired.  Prints the host cost of the
    checks and of ``kv.verify()``, and the step ms beside phase 5's."""
    from repro_torch.core import alerts
    from repro_torch.core.telemetry import MetricsRegistry
    lm, params = model

    class Recorded(alerts.AlertManager):
        """Keeps the serve checks' gauges at each evaluation."""
        def __init__(self, reg):
            super().__init__(reg, rules=alerts.DEFAULT_RULES
                             + alerts.SERVE_RULES)
            self.seen = []

        def evaluate(self):
            self.seen.append({c: self.reg.gauge(f"autopilot_serve_{c}").get()
                              for c in SERVE_CHECKS})
            return super().evaluate()

    reg = MetricsRegistry()
    mgr = Recorded(reg)
    run = serve_runs(lm, params, (("native-health", dict(
        registry=reg, alerts=mgr, health_every=16, verify_cache=True)),),
        "infra", profile=False)["native-health"]
    same = run["streams"] == native_streams
    want = math.ceil(run["steps"] / 16)
    log(f"[infra native-health] streams equal phase 5's native graph "
        f"streams token for token: {same}; {len(mgr.seen)} checks over "
        f"{run['steps']} steps (want {want}), every serve check PASS at "
        f"every one: {all(v == 1.0 for s in mgr.seen for v in s.values())};"
        f" alerts fired {len(mgr.fired)}")
    assert same, "the health loop changed the served streams"
    assert len(mgr.seen) == want
    assert all(v == 1.0 for s in mgr.seen for v in s.values()), mgr.seen
    assert mgr.fired == [], mgr.fired
    costs = health_costs(lm, params)
    log(f"[infra native-health] host ms, median of 200 with 8 slots live "
        f"({costs['pages_in_use']} pages in use): serve_light_checks + "
        f"evaluate {costs['checks_ms']:.4f} ms, kv.verify() "
        f"{costs['verify_ms']:.4f} ms; mean step {run['step_ms']:.2f} ms "
        f"(decode {run['decode_ms']:.2f}) vs phase 5's native "
        f"{native_run['step_ms']:.2f} ms (decode "
        f"{native_run['decode_ms']:.2f}), {run['tok_s']:.1f} vs "
        f"{native_run['tok_s']:.1f} tok/s [{nvidia_smi_line()}]")


# ------------------------------------------------------------ phase 5c ----

K1_NAN_MODES = ("native bf16", "native fp32", "int8", "partials n=2")


def _single_page_range(table, pos, lo, hi, splits, page=16):
    """(slot, logical page) of a live page in the pool window [lo, hi) that
    is the only page of its split's range under K1's schedule (a slot's
    live pages in the window, in logical order, cut into ranges of
    ceil(n / splits)), or None."""
    for s in range(table.shape[0]):
        live = [j for j in range(int(pos[s]) // page + 1)
                if lo <= int(table[s, j]) < hi]
        per = -(-len(live) // splits) if live else 1
        for r in range(splits):
            if len(live[r * per:(r + 1) * per]) == 1:
                return s, live[r * per]
    return None


def k1_nan_case(mode: str, where: str, seed: int = 23) -> dict:
    """One K1 NaN case at phase 3's serve shape (B=8, KV=8, G=4, D=128,
    page 16, M=32, positions ``K1_SERVE_POS``, finite pools).  ``mode``:
    one of ``K1_NAN_MODES`` (int8: the pools quantized by ``quantize_kv``,
    bf16 q; partials: two shards' triples merged by
    ``merge_partials_local``).  ``where``: ``"mid"`` poisons a live page in
    the middle of slot 4's 11 (what ``PagedCache.poison_page`` writes: NaN
    K and V, or on int8 pools NaN scales); ``"split"`` the only page of a
    split's range (of a shard's, for partials); ``"recycled"`` writes NaN
    into slot 0's last live page past its position (40) and into every
    page past it, as a freed poisoned page leaves them for a new owner.
    Returns the victim slot, its elements and non-finite ones, whether the
    other slots (recycled: every slot) are bitwise equal to the clean
    call, and the poisoned page."""
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels.quant import quantize_kv
    from repro_torch.models.attention import merge_partials_local
    gen = torch.Generator().manual_seed(seed)
    dtype = torch.float32 if mode == "native fp32" else torch.bfloat16
    q, k, v, table, pos = k1_inputs(dtype, gen, positions=K1_SERVE_POS,
                                    nan_dead=False)
    quant = mode == "int8"
    pools = ([*quantize_kv(k), *quantize_kv(v)] if quant else [k, None,
                                                              v, None])
    pools = [t for t in (pools[0], pools[2], pools[1], pools[3])
             if t is not None]                           # k, v(, ks, vs)
    shards = 2 if mode.startswith("partials") else 1
    splits = k1_splits(pd, q, k, table, quant)
    page, n_pages = k.shape[1], k.shape[0]

    def call(ps):
        if shards == 1:
            return k1_call(pd, q, ps, table, pos).float()
        triples = []
        for c in range(shards):
            shard = [_shard_of(t, shards, c)[0] for t in ps]
            acc, l, m = k1_call(pd, q, shard, table, pos,
                                _shard_of(ps[0], shards, c)[1])
            triples.append((acc[:, None], l, m))
        return merge_partials_local(triples)[:, 0]

    clean = call(pools)
    assert bool(torch.isfinite(clean).all()), f"K1 {mode}: clean call"
    bad = [t.clone() for t in pools]
    nan_of = bad[2:] if quant else bad[:2]        # what poison_page writes
    tbl = table.cpu()
    if where == "recycled":
        slot, p = 0, int(pos[0])
        last = int(tbl[0, p // page])
        for t in nan_of:
            t[last, p % page + 1:] = float("nan")
            t[tbl[0, p // page + 1:].long()] = float("nan")
        pid = last
    else:
        if where == "mid":
            slot, j = 4, 5
        else:
            pn = -(-n_pages // shards)
            found = [_single_page_range(tbl, pos.cpu(), c * pn,
                                        (c + 1) * pn, splits, page)
                     for c in range(shards)]
            slot, j = next(f for f in found if f is not None)
        pid = int(tbl[slot, j])
        for t in nan_of:
            t[pid] = float("nan")
    out = call(bad)
    torch.cuda.synchronize()
    others = [s for s in range(out.shape[0]) if s != slot]
    if where == "recycled":
        others = list(range(out.shape[0]))
    return dict(slot=slot, page=pid, splits=splits,
                victim=out[slot].numel(),
                victim_nonfinite=int((~torch.isfinite(out[slot])).sum()),
                others_equal=torch.equal(out[others], clean[others]))


def k1_nan_gates() -> None:
    """(a) K1 carries a poisoned page's NaN into its victim's row in every
    mode (native bf16 and fp32, int8, partials merged over two shards),
    for a page in mid-range and for the only page of a split's range;
    every other slot's row stays bitwise the unpoisoned call's; NaN rows
    of a recycled page past its new owner's position are never read."""
    for mode in K1_NAN_MODES:
        for where in ("mid", "split", "recycled"):
            r = k1_nan_case(mode, where)
            log(f"[faults K1 NaN] {mode:12s} {where:8s}: slot {r['slot']} "
                f"page {r['page']} ({r['splits']} splits): "
                f"{r['victim_nonfinite']}/{r['victim']} of its elements "
                f"non-finite; {'all' if where == 'recycled' else 'other'}"
                f" slots bitwise equal to the clean call {r['others_equal']}")
            want = 0 if where == "recycled" else r["victim"]
            assert r["victim_nonfinite"] == want and r["others_equal"], \
                f"K1 {mode} {where}: the poisoned page's NaN went astray"


FAULT_CASES = (
    # label, engine keywords, fault plan (tenancy: chat arrivals preempt)
    ("nan_logits", {}, "nan_logits@3,nan_logits@7"),
    ("poison_page", {}, "poison_page@3,poison_page@8"),
    ("poison_page-int8", {"kv_dtype": "int8"}, "poison_page@3,poison_page@8"),
    ("dispatch_error", {}, "dispatch_error@4:dur=2"),
    ("stall_chunk", {"prefill_chunk": 32}, "stall_chunk@1:dur=40"),
    ("preemption", {"tenancy": "chat=interactive,bulk=batch"}, None),
    ("chip_failure", {"locality_chips": 2}, "chip_failure@4:chip=1"))
FAULT_COUNTERS = ("serve_faults_injected_total", "serve_stream_retries_total",
                  "serve_dead_letter_total", "serve_preemptions_total")


def _fault_requests(vocab):
    """(b)'s 6 requests: prompts of 20-60 tokens, 12 new tokens; even ids
    greedy, odd ids seeded (temperature 0.8, top-k 20, top-p 0.9);
    requests 4 and 5 arrive at iteration 3 (tenant chat), the rest at 0
    (tenant bulk)."""
    from repro_torch.serve import Request, SamplingParams
    rng = np.random.default_rng(31)
    out = {}
    for i in range(6):
        sp = SamplingParams(temperature=0.8 if i % 2 else 0.0, top_k=20,
                            top_p=0.9, seed=i)
        req = Request(i, rng.integers(0, vocab, int(rng.integers(20, 61)))
                      .astype(np.int32), max_new_tokens=12, sampling=sp,
                      tenant="chat" if i >= 4 else "bulk")
        out.setdefault(3 if i >= 4 else 0, []).append(req)
    return out


def _drive(eng, arrivals, max_iters=500) -> list:
    """Submit each arrival at its iteration, step until drained."""
    for it in range(max_iters):
        for r in arrivals.get(it, []):
            eng.submit(r)
        if not eng.step() and not eng.queue and it >= max(arrivals):
            return eng.finished
    raise AssertionError("the engine did not drain")


def _fault_run(lm, params, device, kw, plan, graph=True):
    """One of (b)'s runs: the engine (max_batch 4, max_seq 128, page 16, 24
    pages) with ``kw``, ``plan`` and the watchdog (8 iterations) when there
    is a plan; returns ({id: (status, tokens)}, the fault counters)."""
    from repro_torch.serve import FaultPlan, ServeEngine, TenancyConfig
    kw = dict(kw)
    if "tenancy" in kw:
        kw["tenancy"] = TenancyConfig.parse(kw["tenancy"])
    if plan:
        kw.update(fault_plan=FaultPlan.parse(plan), watchdog_iters=8)
    eng = ServeEngine(lm, params, max_batch=4, max_seq=128, page_size=16,
                      num_pages=24, device=device, cuda_graph=graph,
                      verify_cache=True, **kw)
    if eng.device.type == "cuda":
        assert (eng._graph is not None) == graph
    done = _drive(eng, _fault_requests(lm.cfg.vocab_size))
    counters = {c: sorted(eng.reg.counter(c).labels_values())
                for c in FAULT_COUNTERS}
    return {r.id: (r.status, list(r.out_tokens)) for r in done}, counters


def _cpu_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    return {k: _cpu_tree(v) for k, v in tree.items()}


def fp32_recovery() -> None:
    """(b) Full-width qwen3-4b in fp32 cut to 4 layers (random weights,
    seed 13): ``_fault_requests`` fault-free and under each of
    ``FAULT_CASES``, through the graph and eagerly.  Every completed
    stream of the graph and eager runs equals the same configuration's
    fault-free graph run token for token (a greedy stream may first differ
    only where the top-2 gap of the card's fp32 forward is below 1e-4;
    such streams are counted, 0 expected; a seeded stream may not differ);
    each case injected what it planned and recovered or preempted at
    least once; its counters equal across graph, eager and the same run
    on the CPU through the port (whose seeded draws come from the CPU's
    generator, so only its counters are compared)."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=4,
                              dtype="float32")
    lm = LM(cfg)
    params = lm.init(13, device=DEV)
    cpu_params = _cpu_tree(params)
    reqs = {r.id: r for rs in _fault_requests(cfg.vocab_size).values()
            for r in rs}
    base, ties = {}, 0
    t0 = time.perf_counter()
    for label, kw, plan in FAULT_CASES:
        key = tuple(sorted((k, v) for k, v in kw.items() if k != "tenancy"))
        if key not in base:
            base[key] = _fault_run(lm, params, DEV, dict(key), None)
            assert all(s == "completed" for s, _ in base[key][0].values())
        ref = base[key][0]
        runs = {"graph": _fault_run(lm, params, DEV, kw, plan),
                "eager": _fault_run(lm, params, DEV, kw, plan, graph=False),
                "cpu": _fault_run(lm, cpu_params, "cpu", kw, plan)}
        for how, (out, counts) in runs.items():
            assert counts == runs["cpu"][1], \
                f"[faults fp32 {label}] {how} counters {counts} vs the " \
                f"CPU's {runs['cpu'][1]}"
            if how == "cpu":
                continue        # the CPU's seeded draws are its own
            for i, (status, toks) in out.items():
                if status != "completed" or toks == ref[i][1]:
                    continue
                t = next(k for k in range(len(toks)) if toks[k] != ref[i][1][k])
                seq = np.concatenate([reqs[i].prompt,
                                      np.asarray(toks[:t], np.int32)])
                with torch.no_grad():
                    logits, _ = lm.forward(params, torch.as_tensor(
                        seq, device=DEV)[None].long())
                top2 = logits[0, -1, :cfg.vocab_size].topk(2).values
                gap = float(top2[0] - top2[1])
                greedy = reqs[i].sampling.temperature == 0
                log(f"[faults fp32 {label}] {how}: request {i} first "
                    f"differs at token {t}, top-2 gap {gap:.3e}"
                    f"{'' if greedy else ' (seeded)'}")
                assert greedy and gap < 1e-4, \
                    f"[faults fp32 {label}] request {i} diverged"
                ties += 1
        out, counts = runs["graph"]
        fired = sum(v for _, v in counts["serve_faults_injected_total"])
        moved = sum(v for _, v in counts["serve_stream_retries_total"]) \
            + sum(v for _, v in counts["serve_preemptions_total"])
        statuses = sorted(s for s, _ in out.values())
        log(f"[faults fp32 {label}] graph, eager and CPU counters equal: "
            f"{counts}; statuses {statuses}; completed streams equal the "
            f"fault-free run")
        assert moved > 0 and (plan is None or fired == len(plan.split(",")))
    log(f"[faults fp32] {len(FAULT_CASES)} cases x (graph, eager, CPU) in "
        f"{time.perf_counter() - t0:.1f}s; streams equal only by the tie "
        f"rule: {ties} (0 expected) [{nvidia_smi_line()}]")
    assert ties == 0, "a recovered stream equals the fault-free one only " \
        "by the tie rule"


def faulted_serve(model, native_streams, native_run) -> None:
    """(c) Phase 5's bf16 workload on phase 5's model and weights, tenants
    chat (odd ids, interactive) and bulk (even ids, batch): the 8 bulk
    requests at iteration 0, the 8 chat ones at iteration 4 into a full
    batch (max_batch 8) and a 96-page pool, so they preempt; a plan of
    nan_logits, poison_page and dispatch_error with the watchdog (16
    iterations), twice.  Gates: every request completed or dead-lettered
    as the counters say; one decode dispatch per iteration and one graph
    replay per decode iteration, the graph never recaptured; K1 36
    launches per replay, K2 36 per bucketed prefill (resumes included), K3
    145 per dispatch; the two runs' streams, statuses and counters
    bitwise equal.  Reported: streams equal to phase 5's, preemptions,
    recoveries, ``serve_recovery_iters``, the host ms of a resume prefill,
    the decode step ms beside phase 5's, TTFT by class."""
    from repro_torch.kernels import ops
    from repro_torch.serve import (FaultPlan, Request, ServeEngine,
                                   TenancyConfig)
    lm, params = model
    cfg = lm.cfg
    L = cfg.num_layers
    norms = L * (2 + 2 * cfg.qk_norm) + 1
    prompts = serve_prompts(cfg)
    plan = ("nan_logits@8,poison_page@12,dispatch_error@16:dur=2,"
            "nan_logits@24,poison_page@30")
    results = []
    for run in range(2):
        free()
        eng = ServeEngine(lm, params, max_batch=8, max_seq=512,
                          page_size=16, num_pages=96, device=DEV,
                          tenancy=TenancyConfig.parse(
                              "chat=interactive,bulk=batch"),
                          fault_plan=FaultPlan.parse(plan),
                          watchdog_iters=16)
        captured, replays, decode_ms, resume_ms = eng._graph, [], [], []

        def counted_replay(view, replay=eng._replay):
            replays.append(1)
            return replay(view)

        def timed_fused(*a, fused=eng._fused):
            t0 = time.perf_counter()
            out = fused(*a)
            torch.cuda.synchronize()
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def timed_prefill(bucket, group, prefill=eng._prefill_group):
            t0 = time.perf_counter()
            prefill(bucket, group)
            torch.cuda.synchronize()
            if any(a[1].out_tokens for a in group):
                resume_ms.append((time.perf_counter() - t0) * 1e3)

        eng._replay, eng._fused = counted_replay, timed_fused
        eng._prefill_group = timed_prefill
        arrivals = {}
        for i, p in enumerate(prompts):
            arrivals.setdefault(4 * (i % 2), []).append(Request(
                i, p, max_new_tokens=32, tenant="chat" if i % 2 else "bulk"))
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = _drive(eng, arrivals, max_iters=2000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        reg = eng.reg
        iters = reg.counter("serve_iterations_total").get()
        decodes = reg.counter("serve_decode_dispatches_total").get()
        prefills = reg.counter("serve_prefill_dispatches_total").get()
        counts = {c: sorted(reg.counter(c).labels_values())
                  for c in FAULT_COUNTERS}
        dead = sum(v for _, v in counts["serve_dead_letter_total"])
        statuses = sorted(r.status for r in done)
        assert len(done) == 16 and statuses.count("dead_letter") == dead \
            and statuses.count("completed") == 16 - dead, statuses
        assert decodes == iters == len(replays), (decodes, iters,
                                                  len(replays))
        assert eng._graph is captured, "the decode step was recaptured"
        want = {name: 0 for name in launches}
        want.update({"paged_flash_decode": decodes * L,
                     "flash_attention_bhsd": prefills * L,
                     "rmsnorm_rows": (decodes + prefills) * norms})
        assert launches == want, (launches, want)
        streams = {r.id: (r.status, list(r.out_tokens)) for r in done}
        results.append((streams, counts))
        same = sum(s == "completed" and t == native_streams[i]
                   for i, (s, t) in streams.items())
        ttft = reg.histogram("serve_class_ttft_seconds")
        rec = reg.histogram("serve_recovery_iters")
        log(f"[faults bf16 serve] run {run}: {statuses.count('completed')} "
            f"completed, {dead:.0f} dead-lettered in {wall:.2f}s; "
            f"{iters:.0f} decode iterations = {len(replays)} graph replays, "
            f"{prefills:.0f} prefill dispatches ({len(resume_ms)} with a "
            f"resume); launches {launches} (exact); counters {counts}; "
            f"recoveries {rec.count()} over {sorted(rec.recent(64))} "
            f"iterations; streams equal to phase 5's native run {same}/16 "
            f"(reported); mean decode step {np.mean(decode_ms):.2f} ms vs "
            f"phase 5's native {native_run['decode_ms']:.2f} ms; resume "
            f"prefill dispatch host ms "
            f"{[round(x, 2) for x in resume_ms]}; TTFT p50 interactive "
            f"{ttft.quantile(0.5, {'class': 'interactive'}) * 1e3:.1f} ms, "
            f"batch {ttft.quantile(0.5, {'class': 'batch'}) * 1e3:.1f} ms "
            f"[{nvidia_smi_line()}]")
        del eng, done
    assert results[0] == results[1], "two faulted runs differ"
    assert any(v for _, v in results[0][1]["serve_preemptions_total"]), \
        "no chat admission preempted"
    log("[faults bf16 serve] the two runs' streams, statuses and counters "
        "are bitwise equal")


# ------------------------------------------------------------ phase 5d ----

def _serve_one(eng, rid, prompt, new_tokens=6):
    """The JAX bench's ``serve_one``: one request alone through the
    engine, then the drain (its prefix lands in the store now); returns
    (TTFT ms on the host clock, its tokens)."""
    from repro_torch.serve import Request
    eng.submit(Request(rid, prompt.copy(), max_new_tokens=new_tokens))
    n_done = len(eng.finished)
    while len(eng.finished) == n_done:
        eng.step()
    eng.kv.drain_offloads()
    r = eng.finished[-1]
    return (r.first_token_at - r.submitted_at) * 1e3, tuple(r.out_tokens)


def tier_rates(kv, pids, reps: int = 3) -> tuple:
    """The host tier's copies timed with CUDA events over ``pids`` (live
    pages of ``kv``): the offload's page copies into pinned page buffers
    (D2H) and the prefetch's copies from pinned memory back into the same
    pages (H2D, rewriting the bytes they hold), as ``_offload`` and
    ``_prefetch`` issue them.  Returns (D2H GB/s, H2D GB/s), each the best
    of ``reps``."""
    bufs = [kv._page_buffer() for _ in pids]
    views = [kv._page_views(b) for b in bufs]
    pools = kv.state["layers"]
    nbytes = len(pids) * kv.store.tier.page_bytes
    best = {"d2h": 0.0, "h2d": 0.0}
    for _ in range(reps):
        for way in ("d2h", "h2d"):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for pid, vs in zip(pids, views):
                for name, pool in pools.items():
                    if way == "d2h":
                        vs[name].copy_(pool[:, pid], non_blocking=True)
                    else:
                        pool[:, pid].copy_(vs[name], non_blocking=True)
            end.record()
            end.synchronize()
            best[way] = max(best[way],
                            nbytes / (start.elapsed_time(end) * 1e-3) / 1e9)
    return best["d2h"], best["h2d"]


def prefix_hits(model) -> dict:
    """(a) The JAX bench's prefix-hit workload (``run_offload`` phase 1) at
    full width on phase 5's bf16 model: 4 prefixes of 480 tokens, each
    prompt the prefix and a 4-token tail, 6 new tokens, chunks of 32, page
    16, max_batch 4, max_seq 512, one 128-page ``PrefixStore``.  A cold
    engine serves prefix 0 (its warm-up) and then prefixes 1-3 one at a
    time (every chunk recomputed, 30 pages offloaded each); a new engine on
    the same store serves prefix 0 and the same three prompts again (30
    host hits each, prefetched; 15 of 16 chunks skipped).  Native and int8
    pages.  Gates: the warm streams are bitwise the cold ones; chunks,
    skips, hits, misses, offload and prefetch bytes exactly what the
    prompts predict; one graph replay a decode step; K1, K2 and K3
    launches exact on both engines.  Reported: TTFT cold and warm (median
    of the three measured prompts), the tier's D2H and H2D GB/s by CUDA
    events."""
    from repro_torch.kernels import ops
    from repro_torch.serve import PrefixStore, ServeEngine
    lm, params = model
    cfg = lm.cfg
    L, norms = cfg.num_layers, cfg.num_layers * (2 + 2 * cfg.qk_norm) + 1
    plen, chunk, page = 480, 32, 16
    out = {}
    for kv_dtype in ("native", "int8"):
        tag = f"[tier prefix-hit {kv_dtype}]"
        free()
        rng = np.random.default_rng(17)
        store = PrefixStore(128)

        def prompt(prefix):
            return np.concatenate([prefix, rng.integers(
                0, cfg.vocab_size, 4).astype(np.int32)])

        prefixes = [rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
                    for _ in range(4)]
        k1 = "paged_flash_decode" + ("_int8" if kv_dtype == "int8" else "")
        runs = {}
        for phase in ("cold", "warm"):
            eng = ServeEngine(lm, params, 4, 512, page_size=page,
                              device=DEV, prefill_chunk=chunk,
                              prefix_store=store, kv_dtype=kv_dtype)
            replays = []

            def counted(view, replay=eng._replay):
                replays.append(1)
                return replay(view)

            eng._replay = counted
            before = store.stats()
            ops.reset_launch_counts()
            first = prompt(prefixes[0])
            _serve_one(eng, 0, first)
            if phase == "cold":
                measured = [prompt(pre) for pre in prefixes[1:]]
            ttft, streams = [], []
            for k, p in enumerate(measured):
                t, s = _serve_one(eng, 1 + k, p)
                ttft.append(t)
                streams.append(s)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
            reg = eng.reg
            decodes = reg.counter("serve_decode_dispatches_total").get()
            iters = reg.counter("serve_iterations_total").get()
            rounds = reg.counter("serve_prefill_dispatches_total").get()
            chunks = reg.counter("serve_prefill_chunks_total").get()
            skipped = reg.counter("serve_prefill_chunks_skipped_total").get()
            after = store.stats()
            delta = {k: after[k] - before[k] for k in after}
            want = {name: 0 for name in launches}
            want.update({k1: decodes * L,
                         "rmsnorm_rows": (decodes + rounds) * norms})
            assert launches == want, f"{tag} {phase} launches {launches} " \
                f"vs {want}"
            assert len(replays) == decodes == iters, \
                f"{tag} {phase}: {len(replays)} replays, {decodes} decodes"
            n_full = plen // page                      # 30 pages a prefix
            n_chunks = -(-(plen + 4) // chunk)         # 16 chunks a prompt
            pb = store.tier.page_bytes
            if phase == "cold":
                expect = dict(chunks=4 * n_chunks, skipped=0, hits=0,
                              misses=4, offloads=4 * n_full,
                              offload_bytes=4 * n_full * pb,
                              prefetch_bytes=0)
            else:
                expect = dict(chunks=4, skipped=4 * (n_chunks - 1),
                              hits=4 * n_full, misses=0, offloads=0,
                              offload_bytes=0,
                              prefetch_bytes=4 * n_full * pb)
            got = dict(chunks=chunks, skipped=skipped, hits=delta["hits"],
                       misses=delta["misses"], offloads=delta["offloads"],
                       offload_bytes=delta["offload_bytes"],
                       prefetch_bytes=delta["prefetch_bytes"])
            log(f"{tag} {phase}: TTFT median {np.median(ttft):.1f} ms "
                f"(prompts 1-3: {', '.join(f'{t:.1f}' for t in ttft)}), "
                f"{got}; {decodes:.0f} decode steps = replays, launches "
                f"exact {launches} [{nvidia_smi_line()}]")
            assert got == expect, f"{tag} {phase}: {got} vs {expect}"
            if phase == "warm":
                same = streams == runs["cold"]["streams"]
                log(f"{tag} warm streams bitwise the cold ones: {same}")
                assert same, f"{tag} the warm streams differ from the cold"
                d2h, h2d = tier_rates(eng.kv, list(range(1, n_full + 1)))
                log(f"{tag} the tier's copies of {n_full} pages "
                    f"({n_full * pb} B, {pb} B a page), CUDA events: D2H "
                    f"{d2h:.2f} GB/s into pinned page buffers, H2D "
                    f"{h2d:.2f} GB/s into the pools "
                    f"[{nvidia_smi_line()}]")
                runs["rates"] = (d2h, h2d)
            runs[phase] = dict(ttft=float(np.median(ttft)), streams=streams,
                               **got)
            del eng
        log(f"{tag} TTFT cold {runs['cold']['ttft']:.1f} ms vs warm "
            f"{runs['warm']['ttft']:.1f} ms ({runs['cold']['ttft'] / runs['warm']['ttft']:.2f}x); "
            f"store {store.pages_in_use()} pages, {store.bytes_in_use()} B "
            f"of {store.bytes_total()} B pinned")
        out[kv_dtype] = runs
    return out


def host_serve(model, native_streams, phase5_runs) -> None:
    """(b) Phase 5's workload and weights with a 128-page host tier:
    whole-prompt native and int8, chunked native (64, budget 128).
    ``serve_runs`` gates each run (one graph replay per decode step,
    launches exact, chunk counts with the prefetched pages as shared);
    here the decode step must stay within 1.5x phase 5's step of the same
    run without the tier in this call, and the tier must have offloaded,
    and hit where the prompts land whole.  The streams against phase 5's
    native ones are reported (a prefetched prefix holds the bytes of an
    earlier batch's forward, a recompute those of its own)."""
    lm, params = model
    runs = serve_runs(lm, params, (
        ("host", {"host_pages": 128}),
        ("host-int8", {"host_pages": 128, "kv_dtype": "int8"}),
        ("chunked-host", {"host_pages": 128, "prefill_chunk": 64,
                          "prefill_budget": 128})),
        "serve host", profile=False)
    for label, base in (("host", "native"), ("host-int8", "int8"),
                        ("chunked-host", "chunked")):
        run, ref = runs[label], phase5_runs[base]
        st = run["store"]
        same = sum(run["streams"][i] == native_streams[i]
                   for i in native_streams)
        log(f"[serve {label}] store {st}; decode step {run['decode_ms']:.2f} "
            f"ms vs phase 5's {base} {ref['decode_ms']:.2f} ms; "
            f"{run['tok_s']:.1f} tok/s, TTFT p50 {run['ttft_ms']:.1f} ms "
            f"(phase 5's {base} {ref['ttft_ms']:.1f}); {same}/16 streams "
            f"equal phase 5's native (reported) [{nvidia_smi_line()}]")
        # phase 5's chunked admissions find the shared prefix still on
        # the device: the tier offloads there but need not hit
        assert st["offloads"] > 0 and (st["hits"] > 0
                                       or "chunked" in label), \
            f"[serve {label}] the tier never engaged"
        assert run["decode_ms"] <= 1.5 * ref["decode_ms"], \
            f"[serve {label}] the decode step left phase 5's spread"


def _view_cache():
    """A ``PagedCache`` that keeps a view of a freed page, as JAX's slice is
    taken, instead of copying it at ``free``: the faulty port the view
    check must catch."""
    from repro_torch.serve.kvcache import PagedCache

    class ViewStoring(PagedCache):
        def _offload(self, key, pid):
            if self.store.has(key) or key in self._pending_keys:
                self.store.touch(key)
                return
            self._pending_offload.append(
                (key, {n: t[:, pid] for n, t in self.state["layers"].items()}))
            self._pending_keys.add(key)

        def drain_offloads(self):
            for key, views in self._pending_offload:
                self.store.put(key, views)
            self._pending_offload.clear()
            self._pending_keys.clear()

    return ViewStoring


def tier_hazards(variant: str = "port") -> dict:
    """(c) The two hazards of the host tier on the card, at full width cut
    to 2 layers (bf16 pools, page 16, random K/V blocks; the device stream
    held busy by ``torch.cuda._sleep`` so that every copy is still queued
    when the host moves on):
    * view: prompt A (2 full pages) lands in slot 0 while prompt B (48
      tokens) lands its first chunk in slot 1; slot 0 frees (A's pages
      offload), B's ``extend`` claims A's pages at once and its next
      chunks rewrite them before the drain.  The store must hold A's
      bytes.
    * fence: A is admitted again (its 2 pages prefetched from the store),
      and the host poisons the two store entries at once.  The device
      pages must hold A's bytes, not NaN.
    ``variant`` "view" runs a cache that stores a view of the freed page,
    "nofence" one whose prefetch fences nothing: each must fail its
    check.  Returns {"view_holds_a", "view_holds_b", "fence_clean"}."""
    from repro_torch.configs import get_config
    from repro_torch.serve.kvcache import PagedCache
    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=2)
    cls = _view_cache() if variant == "view" else PagedCache
    kv = cls(cfg, 3, 64, page_size=16, num_pages=8, device=DEV,
             dtype=torch.bfloat16, host_pages=4)
    if variant == "nofence":
        kv.store.tier.fence = lambda event: None
    gen = torch.Generator(device=DEV).manual_seed(9)
    shape = (cfg.num_layers, 1, 48, cfg.num_kv_heads, cfg.resolved_head_dim)
    blocks = {w: {n: torch.randn(shape, generator=gen, device=DEV,
                                 dtype=torch.bfloat16) for n in "kv"}
              for w in "ab"}
    rng = np.random.default_rng(9)
    a = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    b = rng.integers(0, cfg.vocab_size, 48).astype(np.int32)

    def land(slot, w, start, end):
        dest = kv.chunk_dest(slot, start, end, end - start)
        kv.staged_write_prefill({n: t[:, :, start:end]
                                 for n, t in blocks[w].items()},
                                torch.as_tensor(dest[None], device=DEV))

    def page_of(w, i):
        return {n: t[:, 0, 16 * i:16 * (i + 1)] for n, t in blocks[w].items()}

    assert kv.alloc(0, 48, prefix=a) == 0
    land(0, "a", 0, 32)
    assert kv.alloc_chunked(1, 48, 16, prefix=b) == 0
    land(1, "b", 0, 16)
    a_pages = list(kv._slot_pages[0][:2])
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)             # the stream stays busy
    kv.free(0)
    assert kv.extend(1, 48)
    land(1, "b", 16, 48)
    b_pages = list(kv._slot_pages[1])
    taken = [i for i in range(2) if a_pages[i] in b_pages]
    assert taken, "the freed pages were not reclaimed at once"
    kv.drain_offloads()
    keys = [kv._key(a, i) for i in range(2)]
    stored = [kv.store.lookup(k) for k in keys]
    out = {"view_holds_a": all(
        torch.equal(stored[i][n].to(DEV), page_of("a", i)[n])
        for i in range(2) for n in "kv"),
        "view_holds_b": all(
        torch.equal(stored[i][n].to(DEV),
                    page_of("b", b_pages.index(a_pages[i]))[n])
        for i in taken for n in "kv")}
    if variant == "view":
        return out
    kv.free(1)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    assert kv.alloc(2, 48, prefix=a) == 32     # both pages prefetched
    for k in keys:
        assert kv.store.poison(k)
    torch.cuda.synchronize()
    pages = kv._slot_pages[2][:2]
    out["fence_clean"] = all(
        torch.equal(kv.state["layers"][n][:, pages[i]], page_of("a", i)[n])
        for i in range(2) for n in "kv")
    return out


def host_soak() -> None:
    """(d) The JAX 10x working-set soak at full width cut to 4 layers, fp32
    (random weights, seed 13): 20 distinct 12-token prefixes, 40 requests
    arriving over 120 iterations, page 4, a 7-page pool (6 usable), max
    batch 4, max_seq 32, a 64-page tier, through the graph.  Gates: it
    drains, ``serve_kv_pages_in_use`` never exceeds the pool, the tier hit,
    one replay a decode step, and every stream equals the same engine's
    without a tier (a first difference allowed only at a top-2 gap below
    1e-4, counted, 0 expected)."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.serve import Request, ServeEngine
    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=4,
                              dtype="float32")
    lm = LM(cfg)
    params = lm.init(13, device=DEV)
    rng = np.random.default_rng(53)
    prefixes = [rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
                for _ in range(20)]
    reqs = []
    for i in range(40):
        tail = rng.integers(0, cfg.vocab_size,
                            int(rng.integers(1, 3))).astype(np.int32)
        reqs.append((i, np.concatenate([prefixes[i % 20], tail]),
                     int(rng.integers(2, 5))))
    arrivals: dict = {}
    for idx in rng.permutation(len(reqs)):
        arrivals.setdefault(int(rng.integers(0, 120)), []).append(reqs[idx])
    out = {}
    t0 = time.perf_counter()
    for host in (64, 0):
        eng = ServeEngine(lm, params, 4, 32, page_size=4, num_pages=7,
                          device=DEV, host_pages=host)
        replays = []

        def counted(view, replay=eng._replay):
            replays.append(1)
            return replay(view)

        eng._replay = counted
        total = eng.kv.memory_stats().pages_total
        gauge = eng.reg.gauge("serve_kv_pages_in_use")
        peak = 0
        for step in range(400):
            for i, p, n in arrivals.get(step, []):
                eng.submit(Request(i, p.copy(), max_new_tokens=n))
            eng.step()
            peak = max(peak, gauge.get())
            assert 0 <= gauge.get() <= total, step
        done = eng.run_until_drained(max_iters=2000)
        assert len(done) == 40 and all(r.status == "completed" for r in done)
        decodes = eng.reg.counter("serve_decode_dispatches_total").get()
        assert len(replays) == decodes
        out[host] = ({r.id: r.out_tokens for r in done},
                     eng.kv.store.stats() if host else None, peak, decodes)
    streams, stats, peak, decodes = out[64]
    ties = 0
    for i, toks in streams.items():
        ref = out[0][0][i]
        if toks == ref:
            continue
        t = next(k for k in range(len(toks)) if toks[k] != ref[k])
        prompt = next(p for j, p, _ in reqs if j == i)
        seq = np.concatenate([prompt, np.asarray(toks[:t], np.int32)])
        with torch.no_grad():
            logits, _ = lm.forward(params, torch.as_tensor(
                seq, device=DEV)[None].long())
        top2 = logits[0, -1, :cfg.vocab_size].topk(2).values
        gap = float(top2[0] - top2[1])
        log(f"[tier soak] request {i} first differs at token {t}, top-2 "
            f"gap {gap:.3e}")
        assert gap < 1e-4, f"[tier soak] request {i} diverged"
        ties += 1
    log(f"[tier soak] fp32 4 layers, 40 requests over 20 prefixes (60 "
        f"prefix pages vs a 6-page pool): drained, pages in use peaked at "
        f"{peak:.0f} of 6, {decodes:.0f} decode steps = replays, store "
        f"{stats}; streams equal the tierless engine's, {ties} only by the "
        f"tie rule (0 expected); {time.perf_counter() - t0:.1f}s "
        f"[{nvidia_smi_line()}]")
    assert stats["hits"] > 0 and ties == 0


def host_tier(model, native_streams, phase5_runs) -> dict:
    """Phase 5d: (a) ``prefix_hits``, (b) ``host_serve``, (c) the hazards,
    each with the faulty variant that must fail it, (d) ``host_soak``."""
    t0 = time.perf_counter()
    hits = prefix_hits(model)
    free()
    host_serve(model, native_streams, phase5_runs)
    free()
    port = tier_hazards()
    view = tier_hazards("view")
    nofence = tier_hazards("nofence")
    log(f"[tier hazards] port: store holds A {port['view_holds_a']} (B "
        f"{port['view_holds_b']}), prefetched pages clean after the host "
        f"poisoned the store {port['fence_clean']}; a view-storing cache: "
        f"holds A {view['view_holds_a']}, B {view['view_holds_b']}; an "
        f"unfenced prefetch: pages clean {nofence['fence_clean']}")
    assert port == {"view_holds_a": True, "view_holds_b": False,
                    "fence_clean": True}, port
    assert view["view_holds_b"] and not view["view_holds_a"], \
        "the view hazard did not show: the check proves nothing"
    if nofence["fence_clean"]:
        log("[tier hazards] the unfenced prefetch read clean bytes: the "
            "copy landed before the host wrote (reported)")
    free()
    host_soak()
    free()
    log(f"phase 5d took {time.perf_counter() - t0:.1f}s")
    return hits


# ------------------------------------------------------------- phase 6 ----

def rel_err(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def train_parity():
    import dataclasses
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.models import ForwardOpts, LM
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.optimizer import tree_leaves
    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=2,
                              dtype="float32")
    lm = LM(cfg)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(8)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 128)).astype(np.int32)
             for k in ("tokens", "labels")}
    states, metrics = {}, {}
    for path in ("kernel", "plain"):
        opts = ForwardOpts(attn_impl="blockwise", norm_impl="plain",
                           q_chunk=128, kv_chunk=128, xent_impl=path)
        state = init_train_state(lm, 5, tcfg, device=DEV)
        step = make_train_step(lm, tcfg, opts, adamw_impl=path)
        metrics[path] = []
        for _ in range(2):
            state, m = step(state, batch)
            metrics[path].append({k: float(m[k])
                                  for k in ("loss", "grad_norm")})
        states[path] = state
    worst = 0.0
    for mk, mp in zip(metrics["kernel"], metrics["plain"]):
        for k in mk:
            worst = max(worst, abs(mk[k] - mp[k]) / abs(mp[k]))
    worst_m = worst
    for tree in ("params", "opt"):
        for a, b in zip(tree_leaves(states["kernel"][tree]),
                        tree_leaves(states["plain"][tree])):
            worst = max(worst, rel_err(a, b))
    log(f"fp32 2-layer full-width train, 2 steps, kernel path (K4, K5) vs "
        f"plain: losses {[m['loss'] for m in metrics['kernel']]} vs "
        f"{[m['loss'] for m in metrics['plain']]}, grad_norm "
        f"{[m['grad_norm'] for m in metrics['kernel']]}; loss/grad_norm rel "
        f"err {worst_m:.3e}, worst rel max err over loss, grad_norm, params, "
        f"m, v {worst:.3e} (limit 1e-3)")
    assert worst <= 1e-3, "kernel-path training disagrees with plain path"
    del states, state
    free()
    train_grads_bf16()


def train_grads_bf16():
    """The train path's own precision: fp32 parameters, bf16 compute.  The
    loss and every gradient leaf through K4 (bf16 logits in, bf16 dlogits
    out) against the plain loss that autograd differentiates, on the same
    parameters and batch; relative max error per leaf within the bf16
    tolerance 2e-2 (the dlogits of the two paths round to bf16 apart by at
    most one unit in some elements, and the bf16 matmuls that follow round
    again)."""
    import dataclasses
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.models import ForwardOpts, LM
    from repro_torch.core.checkpoint import _flatten_with_paths
    from repro_torch.train.optimizer import tree_leaves
    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=2)
    assert cfg.dtype == "bfloat16" and cfg.param_dtype == "float32"
    lm = LM(cfg)
    z_loss = TrainConfig().z_loss
    rng = np.random.default_rng(9)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 256)),
                                device=DEV, dtype=torch.int32)
             for k in ("tokens", "labels")}
    params = lm.init(5, device=DEV, dtype=torch.float32)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    losses, grads = {}, {}
    for path in ("kernel", "plain"):
        opts = ForwardOpts(attn_impl="blockwise", norm_impl="plain",
                           q_chunk=256, kv_chunk=256, xent_impl=path)
        loss, _ = lm.loss(params, batch, opts, z_loss=z_loss)
        grads[path] = torch.autograd.grad(loss, leaves)
        losses[path] = float(loss.detach())
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in grads["kernel"])
    loss_rel = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
    names = [name for name, _ in _flatten_with_paths(params)]
    worst, name = max((rel_err(a, b), n) for a, b, n in
                      zip(grads["kernel"], grads["plain"], names))
    log(f"bf16-compute 2-layer full-width loss and gradients, batch 8 x 256, "
        f"K4 vs plain loss: loss {losses['kernel']:.6f} vs "
        f"{losses['plain']:.6f} (rel {loss_rel:.3e}), worst rel max err over "
        f"{len(leaves)} gradient leaves {worst:.3e} ({name}; limit 2e-2)")
    assert loss_rel <= 1e-5, "bf16 kernel-path loss disagrees with plain"
    assert worst <= 2e-2, "bf16 kernel-path gradients disagree with plain"


# ------------------------------------------------------------- phase 7 ----

def counted_step(fn) -> dict:
    """One call of ``fn`` (a step on the card) under ``FlopCounterMode``
    and a ``roofline.kernels`` counter: its aten FLOPs, its kernels' work
    and its peak device memory."""
    from torch.utils.flop_counter import FlopCounterMode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with FlopCounterMode(display=False) as fc, rk.WorkCounter() as kw:
        fn()
        torch.cuda.synchronize()
    return dict(aten_flops=fc.get_total_flops(),
                kernel_flops=kw.total_flops, kernels=kw.summary(),
                peak=torch.cuda.max_memory_allocated(), before=before)


def train_run(report, steps: int = 10) -> dict:
    """Phase 7; returns its counted step and setup, for phase 18 (a)."""
    import dataclasses
    import tempfile
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import FTTrainLoop
    from repro_torch.data import (DeterministicLoader, LoaderConfig,
                                  TokenDataset, synthetic_corpus,
                                  write_token_shards)
    from repro_torch.kernels import ops
    from repro_torch.models import ForwardOpts, LM
    from repro_torch.core.telemetry import MetricsRegistry
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.optimizer import tree_leaves
    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=12)
    lm = LM(cfg)
    b, s, microbatches = 8, 256, 1
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2, total_steps=steps)
    # remat "none", as the train launchers pass it: the numbers stay those
    # of the runs before remat (phase 13 runs every remat policy)
    opts = ForwardOpts(attn_impl="blockwise", norm_impl="plain", q_chunk=s,
                       kv_chunk=s, remat="none")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        toks = synthetic_corpus(max(2_000_000, b * s * 20), cfg.vocab_size,
                                seed=0)
        write_token_shards(f"{tmp}/data", toks)
        loader = DeterministicLoader(TokenDataset(f"{tmp}/data"),
                                     LoaderConfig(b, s))
        batch = loader.batch_at(0)                 # one fixed batch
        reg = MetricsRegistry()
        # checkpoints every steps + 1: none of 25 GB is written here
        loop = FTTrainLoop(make_train_step(lm, tcfg, opts, microbatches),
                           lambda: init_train_state(lm, 0, tcfg, device=DEV),
                           f"{tmp}/ckpt", ckpt_every=steps + 1, registry=reg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated() / 2**30
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        final = loop.run(lambda step: batch, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    leaves = tree_leaves(final["params"])
    n_params = sum(t.numel() for t in leaves)
    want = {name: 0 for name in launches}
    want.update(softmax_xent_fwd=steps * microbatches,
                softmax_xent_bwd=steps * microbatches,
                adamw_fused=steps * len(leaves))
    loop_log = loop.metrics_log
    losses = [m["loss"] for m in loop_log]
    step_s = reg.histogram("train_step_seconds").recent(steps)
    steady = float(np.mean(step_s[2:]))
    flops = cfg.flops_per_token(s, "train") * b * s
    log(f"train losses {[round(x, 4) for x in losses]}, grad_norm "
        f"{[round(m['grad_norm'], 3) for m in loop.metrics_log]}")
    log(f"launch counts {launches}, expected {want}")
    assert len(losses) == steps and all(np.isfinite(losses)), "loss not finite"
    assert losses[-1] < losses[0], "loss did not fall on a fixed batch"
    assert launches == want, "the train path did not run K4 and K5 as counted"
    log(f"trained full-width qwen3-4b cut to {cfg.num_layers} layers "
        f"({n_params / 1e9:.3f} B fp32 parameters, bf16 compute), batch {b} "
        f"x seq {s}, {steps} steps in {wall:.3f}s: first step "
        f"{step_s[0] * 1e3:.1f} ms, mean step {steady * 1e3:.2f} ms over "
        f"steps 2..{steps - 1} ({b * s / steady:.1f} tok/s), peak memory "
        f"{peak:.2f} GiB ({before:.2f} GiB allocated before the run), MFU "
        f"{flops / steady / BF16_PEAK * 100:.2f}% of "
        f"{BF16_PEAK / 1e12:.0f} TFLOP/s "
        f"({flops / 1e12:.2f} TFLOP per step) [{nvidia_smi_line()}]")
    for name in ("softmax_xent_fwd", "softmax_xent_bwd", "adamw_fused"):
        report[name]["launches"] = launches[name]
    # phase 18 (a) reads one counted step after the timed ones
    counted = dict(counted_step(lambda: loop.train_step(final, batch)),
                   lm=lm, tcfg=tcfg, opts=opts, step_ms=steady * 1e3,
                   batch={k: (tuple(np.shape(v)), torch.as_tensor(v).dtype)
                          for k, v in batch.items()},
                   model_flops=flops)
    profile_call("train step",
                 lambda: float(loop.train_step(final, batch)[1]["loss"]))
    del final, loop
    free()
    # the same run through the plain loss and plain AdamW, from the same
    # seed: does the kernel path's loss trajectory belong to the model?
    plain_step = make_train_step(
        lm, tcfg, dataclasses.replace(opts, xent_impl="plain"), microbatches,
        adamw_impl="plain")
    state = init_train_state(lm, 0, tcfg, device=DEV)
    plain = []
    for _ in range(steps):
        state, m = plain_step(state, batch)
        plain.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    del state
    rel = {k: [abs(a[k] - b[k]) / abs(b[k])
               for a, b in zip(loop_log, plain)]
           for k in ("loss", "grad_norm")}
    log(f"plain-path replay (plain loss, plain AdamW, same seed and batch): "
        f"losses {[round(m['loss'], 4) for m in plain]}, grad_norm "
        f"{[round(m['grad_norm'], 3) for m in plain]}; kernel vs plain "
        f"worst rel err loss {max(rel['loss']):.3e} (limit 2e-2), grad_norm "
        f"{max(rel['grad_norm']):.3e}")
    assert max(rel["loss"]) <= 2e-2, \
        "the kernel path's loss trajectory leaves the plain path's"
    return counted


KERNEL_GROUPS = (("K1 paged_decode", ("paged_decode_split_kernel",)),
                 ("K2 flash_attention", ("flash_attention_wgmma",
                                         "flash_attention_fp32")),
                 ("K3 rmsnorm", ("rmsnorm",)),
                 ("K4 softmax_xent", ("softmax_xent",)),
                 ("K5 adamw", ("adamw_kernel",)),
                 ("K6 ssd_scan", ("ssd_scan_mma_kernel",
                                  "ssd_scan_fp32_kernel")),
                 ("K7 wkv6", ("wkv6_mma_kernel", "wkv6_fp32_kernel")),
                 ("matmul", ("gemm", "sm90_", "cutlass", "cublas", "xmma",
                             "nvjet")),
                 ("indexing", ("index", "scatter", "gather", "embedding")),
                 ("reductions", ("reduce", "Reduce")),
                 ("elementwise and copies", ("elementwise", "Elementwise",
                                             "copy", "Copy", "CatArray",
                                             "fill")))


def profiled_kernels(fn):
    """One call of ``fn`` under torch.profiler (CUPTI): its device kernels
    as (name, ms, count) rows, and the call's wall ms."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows only: an operator's row repeats its kernels' time
    return [(ev.key, ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0], wall_ms


def profile_call(what: str, fn, top: int = 10, expect=None):
    """Where the time of one call of ``fn`` goes: device time by kernel
    group (torch.profiler, CUPTI), the number of kernels it launched, the
    device's busy and idle share of the call's wall time, and the largest
    kernels.  ``expect`` ({kernel-name part: launches}) holds the window to
    the launches the call is known to make: the profiler can miss kernels
    of a window (PERF.md, open questions), so a window short of them is
    taken again, at most three times, then reported as not measured.  It
    runs after a counted run; its launches are not counted.  Returns the
    device ms by group, the busy ms, the (name, ms, count) rows and the
    wall ms (nothing busy where the profiler saw nothing)."""
    for attempt in range(1, 4):
        rows, wall_ms = profiled_kernels(fn)
        seen = {part: sum(n for key, _, n in rows if part in key)
                for part in expect or {}}
        if seen == (expect or {}):
            break
        log(f"profiled {what} (window {attempt}): {seen} of the expected "
            f"launches {expect}")
        rows = []
    busy = sum(ms for _, ms, _ in rows)
    kernels = sum(n for _, _, n in rows)
    if not busy:
        log(f"profiled {what}: wall {wall_ms:.2f} ms; the profiler "
            "recorded no device time (device breakdown not measured)")
        return {}, 0.0, [], wall_ms
    log(f"profiled {what}: wall {wall_ms:.2f} ms, device busy "
        f"{busy:.2f} ms, device idle share {1 - busy / wall_ms:.3f}, "
        f"{kernels} device kernels")
    groups = {}
    for key, ms, _ in rows:
        group = next((g for g, subs in KERNEL_GROUPS
                      if any(x in key for x in subs)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {group:24s} {ms:9.3f} ms  {ms / busy * 100:5.1f}% of busy")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        log(f"  {ms:9.3f} ms  x{count:<5d} {key[:100]}")
    return groups, busy, rows, wall_ms


# --------------------------------------------------------- phases 8, 9 ----

RECURRENT = ("zamba2-1.2b", "rwkv6-1.6b")
MIXER_GROUP = {"ssd_scan_bhsd": "K6 ssd_scan", "wkv6_scan_bhsd": "K7 wkv6"}


def recurrent_opts():
    from repro_torch.models import ForwardOpts
    return {"kernel": ForwardOpts(attn_impl="flash", norm_impl="kernel",
                                  mixer_impl="kernel", xent_impl="kernel"),
            "plain": ForwardOpts(attn_impl="dense", norm_impl="plain",
                                 mixer_impl="plain", xent_impl="plain")}


@contextlib.contextmanager
def float64_upcasts():
    """Inside, ``Tensor.float()`` returns float64 and the compute dtype
    "float64" exists, so a float64 config runs the plain path in float64
    end to end (every fp32 upcast of the model code becomes a float64 one):
    the reference against which both fp32 paths' rounding is measured."""
    from repro_torch.models import common
    to_f32 = torch.Tensor.float
    common.DTYPES["float64"] = torch.float64
    torch.Tensor.float = lambda self: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = to_f32
        del common.DTYPES["float64"]


def recurrent_parity():
    """Full-width fp32 forward, kernel path against plain path, both against
    a float64 forward of the plain path.  The kernel path must agree with
    the plain path to 1e-3 (relative max error of the logits) at a depth
    where the fp32 plain path itself is within 1e-4 of float64: first the
    full depth, then, while the plain path is further from float64, half
    the depth again (full width throughout).  The random full-depth rwkv6
    amplifies fp32 rounding (its first positions' heads can output little,
    and ln_x's eps 64e-5 scales that up) so far that any two fp32
    implementations differ by ~1e-3-1e-2 there.  The choice of depth reads
    only the plain path and float64, never the kernel path.  Returns the
    depth gated for each config (phase 12 decodes at it)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    opts = recurrent_opts()
    rng = np.random.default_rng(12)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def rms(a, b):
        return float((a - b).norm() / b.norm())

    depths = {}
    for name in RECURRENT:
        full = dataclasses.replace(get_config(name), dtype="float32")
        params = LM(full).init(12, device=DEV)
        toks = torch.as_tensor(rng.integers(0, full.vocab_size, (2, 512)),
                               device=DEV)
        depth = full.num_layers
        while True:
            cfg = dataclasses.replace(full, num_layers=depth)
            lm = LM(cfg)
            p = dict(params, layers=_first_layers(params["layers"], depth))
            with torch.no_grad():
                logits = {path: lm.forward(p, toks, o)[0][..., :cfg.vocab_size]
                          .double() for path, o in opts.items()}
                with float64_upcasts():
                    ref = LM(dataclasses.replace(cfg, dtype="float64")) \
                        .forward(_to_float64(p), toks, opts["plain"])[0]
                    ref = ref[..., :cfg.vocab_size]
                    assert ref.dtype == torch.float64
            a, b = logits["kernel"], logits["plain"]
            assert a.shape == (2, 512, cfg.vocab_size) \
                and bool(torch.isfinite(a).all()), "kernel-path logits"
            agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
            log(f"fp32 full-width {name}, {depth} of {full.num_layers} layers "
                f"({sum(t.numel() for t in _leaves(p)) / 1e9:.3f} B "
                f"parameters), B=2 S=512, logits: kernel vs plain path rel "
                f"max err {rel(a, b):.3e}, argmax agree {agree:.4f}; against "
                f"the float64 plain forward: kernel path rel max "
                f"{rel(a, ref):.3e} rms {rms(a, ref):.3e}, plain path rel max "
                f"{rel(b, ref):.3e} rms {rms(b, ref):.3e}")
            well_conditioned = rel(b, ref) <= 1e-4
            del logits, ref, p
            if well_conditioned:
                assert rel(a, b) <= 1e-3, \
                    f"{name}: kernel-path logits leave the plain path"
                log(f"  gate at {depth} layers: kernel vs plain "
                    f"{rel(a, b):.3e} <= 1e-3")
                break
            assert depth > 1, f"{name}: fp32 forward ill-conditioned at depth 1"
            log(f"  the fp32 plain path is more than 1e-4 from float64 at "
                f"{depth} layers: 1e-3 between fp32 paths is no test of the "
                f"kernels there; halving the depth")
            depth //= 2
        depths[name] = depth
        del params, a, b
        free()
    return depths


def _first_layers(tree, n: int):
    if isinstance(tree, torch.Tensor):
        return tree[:n]
    return {k: _first_layers(v, n) for k, v in tree.items()}


def _to_float64(tree):
    if isinstance(tree, torch.Tensor):
        return tree.double()
    return {k: _to_float64(v) for k, v in tree.items()}


def recurrent_eval(report):
    """bf16 eval through ``make_eval_step``: launch counts, loss against
    the plain path, tok/s, forward ms, peak memory, a profiled forward."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_corpus
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.train import make_eval_step
    opts = recurrent_opts()
    b, s, runs = 4, 2048, 5
    for name in RECURRENT:
        cfg = get_config(name)
        assert cfg.dtype == "bfloat16"
        lm = LM(cfg)
        params = lm.init(13, device=DEV)
        toks = synthetic_corpus(b * (s + 1), cfg.vocab_size, seed=0) \
            .astype(np.int64).reshape(b, s + 1)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        evals = {path: make_eval_step(lm, o) for path, o in opts.items()}
        metrics, launches = {}, {}
        for path in ("kernel", "plain"):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            metrics[path] = {k: float(v)
                             for k, v in evals[path](params, batch).items()}
            torch.cuda.synchronize()
            launches[path] = ops.launch_counts()
        want = {k: 0 for k in launches["kernel"]}
        assert launches["plain"] == want, launches["plain"]
        want["softmax_xent_fwd"] = 1
        if cfg.family == "hybrid":
            n_shared = cfg.num_layers // cfg.hybrid_attn_every
            want.update(ssd_scan_bhsd=cfg.num_layers,
                        flash_attention_bhsd=n_shared,
                        rmsnorm_rows=2 * cfg.num_layers + 2 * n_shared + 1)
            mixer = "ssd_scan_bhsd"
        else:
            want["wkv6_scan_bhsd"] = cfg.num_layers
            mixer = "wkv6_scan_bhsd"
        log(f"[{name}] launch counts of one eval {launches['kernel']}, "
            f"expected {want}; plain path launched none")
        assert launches["kernel"] == want, "the eval did not run its kernels"
        report[mixer]["launches"] = launches["kernel"][mixer]
        lk, lp = metrics["kernel"]["loss"], metrics["plain"]["loss"]
        rel = abs(lk - lp) / abs(lp)
        log(f"[{name}] bf16 eval B={b} S={s}: loss {lk:.6f} (nll "
            f"{metrics['kernel']['nll']:.6f}) vs plain path {lp:.6f}, rel "
            f"{rel:.3e} (limit 2e-2)")
        assert np.isfinite(lk) and rel <= 2e-2, "eval loss leaves plain path"

        def run(fn):
            """Mean host ms of ``runs`` synchronized calls."""
            times = []
            for _ in range(runs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return float(np.mean(times)), float(np.min(times))

        tok_dev = torch.as_tensor(batch["tokens"], device=DEV)

        def forward(path):
            with torch.no_grad():
                lm.forward(params, tok_dev, opts[path])

        torch.cuda.reset_peak_memory_stats()
        eval_ms, eval_min = run(lambda: evals["kernel"](params, batch))
        peak = torch.cuda.max_memory_allocated() / 2**30
        fwd_ms, fwd_min = run(lambda: forward("kernel"))
        plain_eval_ms, _ = run(lambda: evals["plain"](params, batch))
        log(f"[{name}] bf16 eval, {cfg.num_layers} layers, "
            f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B "
            f"parameters, B={b} S={s}: eval {eval_ms:.2f} ms mean (min "
            f"{eval_min:.2f}) over {runs} = {b * s / eval_ms * 1e3:.1f} tok/s; "
            f"forward {fwd_ms:.2f} ms mean (min {fwd_min:.2f}); peak memory "
            f"{peak:.2f} GiB; plain-path eval {plain_eval_ms:.2f} ms mean "
            f"[{nvidia_smi_line()}]")
        groups, busy, _, _ = profile_call(
            f"[{name}] bf16 forward B={b} S={s}", lambda: forward("kernel"))
        if busy:
            shares = ", ".join(
                f"{g} {groups.get(g, 0.0):.3f} ms "
                f"({groups.get(g, 0.0) / busy * 100:.1f}%)"
                for g in (MIXER_GROUP[mixer], "elementwise and copies"))
            log(f"[{name}] of the profiled forward's {busy:.2f} ms busy: "
                f"{shares}")
        del params, evals
        free()


# ------------------------------------------------------------ phase 10 ----

PARTIALS = ("paged_flash_decode_partials", "paged_flash_decode_partials_int8")


def _shard_of(pool, n, c):
    """Shard c of n of a pool padded with zero pages to a multiple of n."""
    pad = -pool.shape[0] % n
    if pad:
        pool = torch.cat([pool, pool.new_zeros(pad, *pool.shape[1:])])
    pn = pool.shape[0] // n
    return pool[c * pn:(c + 1) * pn], c * pn


def _triple_err(got, ref) -> float:
    """Largest error of (acc, l, m) against the plain triple, each output
    relative to its own largest magnitude (at least 1)."""
    return max(float((a - r).abs().max()) / max(1.0, float(r.abs().max()))
               for a, r in zip(got, ref))


def check_k1_partials(report):
    """K1's partials mode, native and int8, on n = 2 and 4 shards of the
    phase-3 K1 pools (global table, page_offset = c * P/n): each shard's
    triple against the plain partials and the plain split schedule (1e-4
    relative; all fp32 arithmetic on the same inputs), one launch a call
    and two calls bitwise equal, every slot with no live row in a shard
    exactly (0, 0, -1e30), the merged shards against the normalized K1 on
    the whole pool (fp32 1e-4, bf16 2e-2); then each shard's time at the
    K1 row's serve shape (n = 2 and 4) and at the long shape (n = 2) beside
    its bound, the plain partials and SDPA on the shard's gathered view
    (the normalized function, not the triple)."""
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels.quant import quantize_kv
    from repro_torch.models.attention import merge_partials_local
    gen = torch.Generator().manual_seed(6)
    errs = {name: 0.0 for name in PARTIALS}
    for quant, name in zip((False, True), PARTIALS):
        fn = getattr(pd, name)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, table, pos = k1_inputs(dtype, gen)
            pools = ([*quantize_kv(k), *quantize_kv(v)] if quant else
                     [k, None, v, None])
            pools = [pools[0], pools[2], pools[1], pools[3]]  # k, v, ks, vs
            splits = k1_splits(pd, q, k, table, quant)
            for n in (2, 4):
                triples, empty = [], 0
                for c in range(n):
                    shard = [_shard_of(t, n, c)[0] for t in pools if
                             t is not None]
                    off = _shard_of(pools[0], n, c)[1]
                    before = fn.launches
                    got = fn(q, *shard, table, pos, off)
                    launched = fn.launches - before
                    again = fn(q, *shard, table, pos, off)
                    args = (q, shard[0], shard[1], table, pos,
                            *(shard[2:] or [None, None]), off, True)
                    ref = pd.paged_decode_ref(*args)
                    split = pd.paged_decode_split_ref(*args, splits=splits)
                    torch.cuda.synchronize()
                    err = max(_triple_err(got, ref), _triple_err(got, split))
                    errs[name] = max(errs[name], err)
                    hole = ref[2] == -1e30
                    empty += int(hole.sum())
                    exact = bool((got[2][hole] == -1e30).all()
                                 and (got[1][hole] == 0).all()
                                 and (got[0][hole] == 0).all())
                    same = all(torch.equal(a, b) for a, b in zip(got, again))
                    assert err <= 1e-4 and exact and same and launched == 1, \
                        f"{name} shard {c}/{n} disagrees with its plain"
                    triples.append((got[0][:, None], got[1], got[2]))
                merged = merge_partials_local(triples)[:, 0].to(dtype)
                whole = (pd.paged_flash_decode_int8(q, pools[0], pools[1],
                                                    pools[2], pools[3],
                                                    table, pos)
                         if quant else
                         pd.paged_flash_decode(q, k, v, table, pos))
                merr = max_err(merged, whole)
                log(f"K1 partials {name} {str(dtype)[6:]:8s} n={n}: triple "
                    f"rel err {errs[name]:.3e} vs plain and split schedule "
                    f"(tol 1e-4), one launch a call, repeated calls bitwise "
                    f"equal, {empty} empty (slot, head, group) triples "
                    f"exact; merged vs K1 on the whole pool max_abs_err "
                    f"{merr:.3e} (tol {TOL[dtype]})")
                assert merr <= TOL[dtype], f"{name} merged disagrees with K1"
    # timing: bf16 q, finite dead pages; the serve shape per shard at n = 2
    # and 4, the long shape per shard at n = 2
    shapes = (("serve", 32, K1_SERVE_POS, (2, 4)),
              ("long", 256, K1_LONG_POS, (2,)))
    rows_ms = {}
    for shape, m, positions, ns in shapes:
        q, k, v, table, pos = k1_inputs(torch.bfloat16, gen, m, positions,
                                        nan_dead=False)
        for quant, name in zip((False, True), PARTIALS):
            pools = [*quantize_kv(k), *quantize_kv(v)] if quant else [k, v]
            if quant:
                pools = [pools[0], pools[2], pools[1], pools[3]]
            for n in ns:
                for c in range(n):
                    shard = [_shard_of(t, n, c)[0] for t in pools]
                    off = _shard_of(pools[0], n, c)[1]
                    r = k1_timed(pd, f"K1 partials {name} timing bf16 q "
                                 f"{shape}, n={n} shard {c}", q, shard,
                                 table, pos, off)
                    if n == 2:
                        rows_ms.setdefault((name, shape), []).append(r)
    for name in PARTIALS:
        entry = {}
        for shape in ("serve", "long"):
            rs = rows_ms[(name, shape)]
            entry[shape] = dict(
                max_abs_err=max(r["max_abs_err"] for r in rs),
                bound_by=rs[0]["bound_by"],
                **{key: float(np.mean([r[key] for r in rs]))
                   for key in ("ms", "plain_ms", "library_ms", "bound_ms")})
        report[name] = dict(entry["serve"], long=entry["long"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


#: phase 10 (c): phase 5's workloads over a pool split over two ranks, at
#: full width cut to 12 of qwen3-4b's 36 layers (eager over gloo, each
#: layer's merge staged through the host, this is the smoke's longest
#: serving part)
SHARDED_RUNS = (("native", {}), ("int8", {"kv_dtype": "int8"}),
                ("native-129", {"num_pages": 129}),
                ("chunked", {"prefill_chunk": 64, "prefill_budget": 128}))
SHARDED_LAYERS = 12


def _sharded_model():
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    lm = LM(dataclasses.replace(get_config("qwen3-4b"),
                                num_layers=SHARDED_LAYERS))
    return lm, lm.init(7, device=DEV)


def sharded_ranks(report, n: int = 2, timeout_s: float = 600.0) -> None:
    """Phase 10 (b) and (c) in n rank processes on this one card over gloo
    (``python3 chip_smoke.py --sharded-rank R --ranks N --port P``), after
    this process has served (c)'s workloads on one card for the reference
    and freed its memory.  Each rank prints its log and, last, a RESULT
    line; a rank that fails or outlives ``timeout_s`` fails the phase, and
    every rank is stopped."""
    lm, params = _sharded_model()
    single = {label: run["streams"] for label, run in serve_runs(
        lm, params, SHARDED_RUNS, "sharded single-card", profile=False)
        .items()}
    del lm, params
    free()
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--sharded-rank",
         str(r), "--ranks", str(n), "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT) for r in range(n)]
    outs = [""] * n
    try:
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for r, p in enumerate(procs):
            outs[r] = p.communicate()[0]
            for line in outs[r].splitlines():
                if not line.startswith("RESULT "):
                    log(f"[rank {r}] {line}")
    codes = [p.returncode for p in procs]
    assert codes == [0] * n, f"sharded ranks exited with {codes}"
    results = [json.loads(next(l for l in out.splitlines()
                               if l.startswith("RESULT "))[7:])
               for out in outs]
    for label in ("native", "int8", "native-129", "chunked"):
        runs = [r["serve"][label] for r in results]
        assert all(run["streams"] == runs[0]["streams"] for run in runs), \
            f"[{label}] the ranks' streams differ"
        streams = {int(i): t for i, t in runs[0]["streams"].items()}
        ref = single[label]
        same = sum(streams[i] == ref[i] for i in ref)
        tokens = sum(a == b for i in ref for a, b in zip(streams[i], ref[i]))
        log(f"[sharded {label}] streams equal on all {n} ranks; "
            f"{same}/16 streams ({tokens}/512 tokens) equal the single "
            f"card's at {SHARDED_LAYERS} layers (reported, not a gate); "
            f"fresh pages per "
            f"rank {runs[0]['per_chip']}; mean decode step "
            f"{runs[0]['decode_ms']:.2f} ms on rank 0")
        name = runs[0]["k1"]
        if label in ("native", "int8"):
            report[name]["launches"] = runs[0]["launches"][name]


def rank_main(rank: int, n: int, port: int) -> int:
    """One rank of phase 10: (b) full-width qwen3-4b fp32, one prefill and
    one decode step over the sharded pool, rank 0 holding the logits
    against its own single-card cache (relative max error 1e-4: the two
    differ only in the order of the attention sums); (c) phase 5's bf16
    workload at ``SHARDED_LAYERS`` over sharded native, then int8, pages,
    then native pages over a smaller pool, then with phase 5's chunked
    prefill; then the gloo merge's cost per layer."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.models import ForwardOpts, LM
    from repro_torch.models.attention import merge_paged_partials
    from repro_torch.parallel import PoolGroup
    from repro_torch.serve.kvcache import PagedCache
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=n,
                            timeout=timedelta(seconds=300))
    group = PoolGroup.of()
    result = {"rank": rank}

    # (b) fp32 logits, sharded against single-card
    cfg = dataclasses.replace(get_config("qwen3-4b"), dtype="float32")
    lm = LM(cfg)
    params = lm.init(11, device=DEV)
    rng = np.random.default_rng(4)
    lens = [70, 97, 115, 128]
    tokens = np.zeros((len(lens), 128), np.int64)
    for j, plen in enumerate(lens):
        tokens[j, :plen] = rng.integers(0, cfg.vocab_size, plen)
    # 30 pages, 15 a rank: the 5-, 7- and 8-page slots fill one rank each
    # way and the 9-page slot spills over both, so the merge combines two
    # live shards there and a live shard with an empty one elsewhere; the
    # single-card cache takes the same page ids (locality_chips)
    groups = [group] + ([None] if rank == 0 else [])
    caches = [PagedCache(cfg, len(lens), 256, page_size=16, num_pages=30,
                         device=DEV, dtype=torch.float32, pool_group=g,
                         locality_chips=None if g else n) for g in groups]
    dest = np.zeros((len(lens), 128), np.int32)
    for kv in caches:
        for j, plen in enumerate(lens):
            assert kv.alloc(j, plen + 2) == 0
            dest[j] = kv.prefill_dest(j, 128, plen)
    assert all(kv.page_table.tolist() == caches[0].page_table.tolist()
               for kv in caches)
    spans = [len({p // caches[0].pages_per_chip for p in pages})
             for pages in caches[0]._slot_pages]
    assert max(spans) == n, spans
    logits, cache = lm.forward(params, torch.as_tensor(tokens, device=DEV),
                               ForwardOpts("flash", "kernel"),
                               collect_cache=True)
    for kv in caches:
        kv.staged_write_prefill(cache["layers"],
                                torch.as_tensor(dest, device=DEV))
    del cache
    nxt = logits[torch.arange(len(lens), device=DEV),
                 torch.as_tensor(np.array(lens) - 1, device=DEV)].argmax(-1)
    pos = torch.as_tensor(np.array(lens, np.int32), device=DEV)
    step = [lm.decode_step(params, nxt[:, None], kv.decode_view(), pos,
                           pool_group=g)[0][:, -1, :cfg.vocab_size]
            for kv, g in zip(caches, groups)]
    if rank == 0:
        a, b = step[0].float(), step[1].float()
        assert bool(torch.isfinite(a).all()) and a.shape == (4, cfg.vocab_size)
        err = float((a - b).abs().max() / b.abs().max())
        top2 = b.topk(2, dim=-1).values
        decided = top2[:, 0] - top2[:, 1] > (a - b).abs().max(-1).values
        same = a.argmax(-1) == b.argmax(-1)
        log(f"fp32 full-width qwen3-4b, 4 prompts of 70-128 tokens, prefill "
            f"+ 1 decode step over {n} shards (ranks each slot's pages lie "
            f"on: {spans}) vs one card: logits rel max err {err:.3e} "
            f"(limit 1e-4), greedy agree {int(same.sum())}/4")
        assert err <= 1e-4 and bool((same | ~decided).all()), \
            "sharded decode logits disagree with the single-card cache"
        result["fp32_rel_err"] = err
    del params, caches, logits, step
    free()

    # (c) phase 5's bf16 workload over sharded pools, at SHARDED_LAYERS:
    # phase 5's pool (257 pages) over native and int8 pages; then native
    # over 129 pages, where the live slots outgrow one rank's shard; then
    # phase 5's chunked prefill over native pages
    lm, params = _sharded_model()
    runs = serve_runs(lm, params, SHARDED_RUNS, f"sharded r{rank}",
                      pool_group=group, profile=rank == 0)
    for label, run in runs.items():
        st = run["stats"]
        want = st["bytes_total"] // n + run["page_bytes"]
        log(f"[sharded r{rank} {label}] pool tensors on this rank "
            f"{run['pool_tensor_bytes']} B = padded pool "
            f"{st['bytes_total']} / {n} + sink page {run['page_bytes']} "
            f"({want}); memory_allocated grew {run['pool_bytes']} B at "
            f"construction (the caching allocator's blocks, not a gate)")
        assert run["pool_tensor_bytes"] == want \
            == st["bytes_per_chip"] + st["bytes_sink_per_chip"], \
            "a rank pins other than its shard and its sink"
    result["serve"] = runs
    del params
    free()

    # the merge alone: one MAX and one SUM all_reduce of a decode layer's
    # triple (B=8, KV=8, G=4, D=128), synchronized
    acc = torch.randn(8, 1, 8, 4, 128, device=DEV)
    l = torch.rand(8, 8, 4, device=DEV) + 1
    m = torch.randn(8, 8, 4, device=DEV)
    for _ in range(5):
        merge_paged_partials(acc, l, m, group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        merge_paged_partials(acc, l, m, group)
    torch.cuda.synchronize()
    merge_ms = (time.perf_counter() - t0) / 50 * 1e3
    log(f"[sharded r{rank}] merge of one layer's partials over gloo, "
        f"{n} ranks on one card: {merge_ms:.3f} ms (x 36 layers = "
        f"{36 * merge_ms:.1f} ms per decode step)")
    result["merge_ms"] = merge_ms
    dist.destroy_process_group()
    print("RESULT " + json.dumps(result), flush=True)
    return 0


# the 2x2 mesh: full width cut to 4 layers, fp32, phase 5's prompts
MESH2D_RUNS = (("whole", {}), ("chunked", {"prefill_chunk": 64,
                                           "prefill_budget": 128}),
               ("int8", {"kv_dtype": "int8"}),
               ("host", {"host_pages": 128}),
               ("chunked-host", {"host_pages": 128, "prefill_chunk": 64,
                                 "prefill_budget": 128}))


def _mesh2d_model():
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=4,
                              dtype="float32")
    lm = LM(cfg)
    return lm, lm.init(13, device=DEV)


def _mesh2d_serve(lm, params, kw, **groups) -> dict:
    """One of the 2x2 runs: phase 5's 16 prompts, 16 new tokens each, max
    batch 8, max_seq 512, page 16, through an engine with ``kw`` (and the
    rank's groups).  Returns its streams, store, decode steps, K1 launches
    and a digest of its pool pages, scratch and sink pages left out."""
    import hashlib
    from repro_torch.kernels import ops
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(lm, params, 8, 512, page_size=16, device=DEV, **groups,
                      **kw)
    ops.reset_launch_counts()
    for i, p in enumerate(serve_prompts(lm.cfg)):
        eng.submit(Request(i, p, max_new_tokens=16))
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert len(done) == 16 and all(r.status == "completed" for r in done)
    # the pages a request can own: not scratch page 0, whose row 0 takes
    # every parked slot's and padding position's write at once (duplicate
    # indices, in no set order), nor a shard's sink page
    kv = eng.kv
    lo = 1 if kv.pool_group is None or kv.pool_group.rank == 0 else 0
    digest = hashlib.sha256()
    for t in kv.state["layers"].values():
        digest.update(t[:, lo:kv.pages_per_chip].contiguous()
                      .view(torch.uint8).cpu().numpy().tobytes())
    store = eng.kv.store
    out = dict(streams={r.id: r.out_tokens for r in done},
               pools=digest.hexdigest(), launches=ops.launch_counts(),
               decodes=eng.reg.counter(
                   "serve_decode_dispatches_total").get(), wall=wall)
    if store is not None:
        slabs = hashlib.sha256()
        for t in store.tier._slabs.values():
            slabs.update(t.view(torch.uint8).numpy().tobytes())
        keys = hashlib.sha256(b"".join(
            len(k).to_bytes(4, "little") + k for k in store.keys()))
        out["store"] = [store.stats(), keys.hexdigest(), slabs.hexdigest()]
    return out


def mesh2d_ranks(timeout_s: float = 600.0) -> None:
    """Phase 10 (d): the 2x2 batch x pages mesh.  This process serves
    ``MESH2D_RUNS`` on one card (graph replays) as the reference; then
    four rank processes of this script (``--mesh2d-rank R --port P``) on
    this card over gloo, rank r at (r // 2, r % 2), groups from the
    launcher's ``join_pool_group``, serve them eagerly: the pool split over
    a row's two ranks and replicated over the two rows, each row attending
    half the batch, the outputs all_gathered over the column.  Gates: every
    rank emits the same streams, equal to the single card's (a first
    difference allowed only at a top-2 gap below 1e-4, counted, 0
    expected); each pool shard is bitwise equal on its two dp replicas;
    every rank's store equals the others' (stats, key order, slab bytes)
    and the single card's (stats, a digest of the keys in order); each
    rank launches K1's
    partials mode 4 times a decode step and the normalized mode never."""
    lm, params = _mesh2d_model()
    t0 = time.perf_counter()
    ref = {label: _mesh2d_serve(lm, params, kw) for label, kw in MESH2D_RUNS}
    log(f"[2x2] single-card reference runs in "
        f"{time.perf_counter() - t0:.1f}s")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh2d-rank",
         str(r), "--port", str(port)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=ROOT) for r in range(4)]
    outs = [""] * 4
    try:
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for r, p in enumerate(procs):
            outs[r] = p.communicate()[0]
            for line in outs[r].splitlines():
                if not line.startswith("RESULT "):
                    log(f"[2x2 rank {r}] {line}")
    codes = [p.returncode for p in procs]
    assert codes == [0] * 4, f"2x2 ranks exited with {codes}"
    results = [json.loads(next(l for l in out.splitlines()
                               if l.startswith("RESULT "))[7:])
               for out in outs]
    prompts = serve_prompts(lm.cfg)
    ties = 0
    for label, _ in MESH2D_RUNS:
        runs = [r[label] for r in results]
        assert all(run["streams"] == runs[0]["streams"] for run in runs), \
            f"[2x2 {label}] the ranks' streams differ"
        assert runs[0]["pools"] == runs[2]["pools"] \
            and runs[1]["pools"] == runs[3]["pools"], \
            f"[2x2 {label}] a pool shard differs between its dp replicas"
        k1 = "paged_flash_decode_partials" + (
            "_int8" if label == "int8" else "")
        for run in runs:
            want = run["decodes"] * lm.cfg.num_layers
            assert run["launches"][k1] == want and \
                run["launches"]["paged_flash_decode"] == 0, \
                f"[2x2 {label}] K1 launches {run['launches']}"
        if "store" in runs[0]:
            assert all(run["store"] == runs[0]["store"] for run in runs), \
                f"[2x2 {label}] the ranks' stores differ"
            assert runs[0]["store"][:2] == ref[label]["store"][:2], \
                f"[2x2 {label}] the store differs from the single card's"
            # whole-prompt admissions hit the tier; phase 5's chunked ones
            # find the shared prefix still on the device
            st = runs[0]["store"][0]
            assert st["offloads"] > 0 and (st["hits"] > 0
                                           or "chunked" in label), st
        for i, toks in runs[0]["streams"].items():
            want = ref[label]["streams"][int(i)]
            if toks == want:
                continue
            t = next(k for k in range(len(toks)) if toks[k] != want[k])
            seq = np.concatenate([prompts[int(i)],
                                  np.asarray(toks[:t], np.int32)])
            with torch.no_grad():
                logits, _ = lm.forward(params, torch.as_tensor(
                    seq, device=DEV)[None].long())
            top2 = logits[0, -1, :lm.cfg.vocab_size].topk(2).values
            gap = float(top2[0] - top2[1])
            log(f"[2x2 {label}] request {i} first differs at token {t}, "
                f"top-2 gap {gap:.3e}")
            assert gap < 1e-4, f"[2x2 {label}] request {i} diverged"
            ties += 1
        log(f"[2x2 {label}] 4 ranks agree, streams equal the single card's, "
            f"shards equal on their dp replicas"
            + (f", stores equal everywhere ({runs[0]['store'][0]})"
               if "store" in runs[0] else "")
            + f"; {runs[0]['decodes']:.0f} eager decode steps in "
            f"{runs[0]['wall']:.2f}s on rank 0 (single card, graph: "
            f"{ref[label]['wall']:.2f}s) [{nvidia_smi_line()}]")
    log(f"[2x2] streams equal only by the tie rule: {ties} (0 expected)")
    assert ties == 0, "a 2x2 stream equals the single card's only by the " \
        "tie rule"


def mesh2d_main(rank: int, port: int) -> int:
    """One rank of phase 10 (d): the 2x2 mesh's groups through
    ``repro_torch.launch.serve.join_pool_group`` (gloo, this card), then
    ``MESH2D_RUNS``."""
    import os
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.serve import join_pool_group
    os.environ.update(RANK=str(rank), WORLD_SIZE="4",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    group, dp_group, dev = join_pool_group(2, 2, DEV)
    assert dist.get_backend() == "gloo" and dev.type == "cuda"
    lm, params = _mesh2d_model()
    out = {label: _mesh2d_serve(lm, params, kw, pool_group=group,
                                dp_group=dp_group)
           for label, kw in MESH2D_RUNS}
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


# ------------------------------------------------------------ phase 11 ----

#: the biased dense configs' head layouts: (config, KV, G)
BIAS_LAYOUTS = (("granite-20b-code", 1, 48), ("granite-13b", 40, 1),
                ("starcoder2-3b", 2, 12))


def layout_entry(kernel: str, kv: int, g: int, dtype) -> str:
    """A ``kernels`` entry's name for a kernel mode at a head layout.  K1's
    name covers both q dtypes, which take different paths (bf16 the tensor
    cores, fp32 the CUDA cores), so its entries name the dtype; K2's modes
    have a name each."""
    tail = f",{str(dtype)[6:]}" if kernel.startswith("paged_") else ""
    return f"{kernel}[KV={kv},G={g}{tail}]"


#: the q dtypes a phase-11 run launches K1 with at each layout: fp32 in (b)
#: at all three, bf16 only where granite-20b-code is served (c)
K1_LAYOUT_DTYPES = {48: (torch.float32, torch.bfloat16),
                    1: (torch.float32,), 12: (torch.float32,)}


def redraw_biases(params, seed: int) -> None:
    """Every bias leaf ~ N(0, 0.2) and every norm scale ~ N(1, 0.2), in
    place, from a generator on the card seeded with ``seed``: the port
    initializes biases at zero and LayerNorm at (1, 0), as JAX does, which
    would leave the bias and LayerNorm code with nothing to show."""
    gen = torch.Generator(device=DEV).manual_seed(seed)

    def walk(tree, key=None):
        if isinstance(tree, torch.Tensor):
            if key in ("bias", "scale"):
                noise = torch.randn(tree.shape, generator=gen, device=DEV)
                tree.copy_(noise.mul_(0.2).add_(float(key == "scale")))
            return
        for k, v in tree.items():
            walk(v, k)

    walk(params)


def k1_layout(report, name, kv, g, entry_dtypes) -> None:
    """K1 at a head layout (D=128, page 16, phase 3's ragged positions and
    NaN dead pages), native and int8, fp32 and bf16 q, against its plain
    version and its plain split schedule, one launch a call, two calls
    bitwise equal; the plan's shared memory equal to the kernel's; then
    timed at phase 3's serve positions, each mode an entry of its own for
    every q dtype of ``entry_dtypes`` (the dtypes the phase's runs launch
    there)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels.quant import quantize_kv
    gen = torch.Generator().manual_seed(kv * 100 + g)
    smem = _build.entry("paged_decode_smem_bytes")
    tag = f"KV={kv} G={g} D=128 page=16 M=32 ({name})"
    pos = torch.tensor(K1_SERVE_POS, dtype=torch.int32, device=DEV)
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        q, k, v, table, p0 = k1_inputs(dtype, gen, kv=kv, g=g)
        k1_agree(pd, f"K1 paged_flash_decode {dt:8s} {tag}", q, (k, v),
                 table, p0, TOL[dtype])
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        k1_agree(pd, f"K1 int8 paged_flash_decode_int8 q {dt:8s} {tag}", q,
                 (kq, vq, ks, vs), table, p0, TOL[dtype])
        for quant in (False, True):
            pl = pd.plan(8, kv, g, 128, 16, 32, dtype, quant, False,
                         pd._n_sms(0))
            mine = smem(0 if dtype == torch.float32 else 1, int(quant), g,
                        128, 32)
            log(f"K1 plan {tag} {'int8' if quant else 'native'} {dt}: "
                f"splits {pl.splits} (grid {pl.grid}, {pl.g_blocks} query "
                f"blocks of {pl.group}, tensor cores {pl.tensor_cores}), "
                f"smem {pl.smem} B, kernel's {mine} B")
            assert pl.smem == mine, "K1 plan's shared memory differs"
        if dtype not in entry_dtypes:
            continue
        q, k, v, table, _ = k1_inputs(dtype, gen, nan_dead=False, kv=kv, g=g)
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        for mode, pools in (("paged_flash_decode", (k, v)),
                            ("paged_flash_decode_int8", (kq, vq, ks, vs))):
            r = k1_timed(pd, f"K1 {mode} timing {dt} q serve {tag}", q,
                         pools, table, pos)
            report[layout_entry(mode, kv, g, dtype)] = dict(r, launches=0)
    free()


def check_bias_layouts(report) -> None:
    """(a) K1 at the biased configs' head layouts (KV=1 G=48, KV=40 G=1,
    KV=2 G=12; D=128, page 16, phase 3's ragged positions and NaN dead
    pages), native and int8, fp32 and bf16 q, against its plain version
    and its plain split schedule, one launch a call, two calls bitwise
    equal; the plan's shared memory equal to the kernel's (``k1_layout``),
    timed in the q dtypes phase 11 launches there.  K2 at KV=1 G=48 and
    KV=40 G=1 (8 prompts
    of 256, causal), bf16 and fp32, against its plain version, timed
    beside SDPA (``enable_gqa``) and its bound."""
    from repro_torch.kernels import flash_attention as fa
    for name, kv, g in BIAS_LAYOUTS:
        k1_layout(report, name, kv, g, K1_LAYOUT_DTYPES[g])
    # K2: bf16 where granite-20b-code is served (c), fp32 where (b) runs
    # both; the bf16 time at granite-13b's layout is logged only
    gen = torch.Generator(device=DEV).manual_seed(26)
    for name, kv, g in BIAS_LAYOUTS[:2]:
        for dtype, mode in ((torch.bfloat16, "flash_attention_bhsd"),
                            (torch.float32, "flash_attention_bhsd_fp32")):
            r = time_k2(fa, f"{name} prefill (8 prompts of bucket 256)", 8,
                        256, kv, g, 128, dtype, gen)
            if dtype == torch.float32 or name == "granite-20b-code":
                report[layout_entry(mode, kv, g, dtype)] = dict(
                    r, launches=0)
    free()


def count_layout(report, launches, cfg) -> None:
    """Add a run's K1 and K2 launches to the entries of its head layout and
    compute dtype (K1's q dtype), and its K3 launches to the entry of its
    row width, where those entries exist."""
    for kernel, n in launches.items():
        key = (f"rmsnorm_rows[d={cfg.d_model}]" if kernel == "rmsnorm_rows"
               else layout_entry(kernel, cfg.num_kv_heads,
                                 cfg.num_heads // cfg.num_kv_heads,
                                 getattr(torch, cfg.dtype)))
        if n and key in report:
            report[key]["launches"] += n


#: (b)'s configs: full width, full depth or cut to 4 layers
BIAS_FP32 = (("starcoder2-3b", None), ("granite-13b", 4),
             ("granite-20b-code", 4))


def bias_kernel_vs_plain(report) -> None:
    """(b) fp32, TF32 off: ``kernel_vs_plain`` for each of ``BIAS_FP32``'s
    configs at full width with its biases and LayerNorm leaves redrawn."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    for name, layers in BIAS_FP32:
        cfg = dataclasses.replace(get_config(name), dtype="float32",
                                  **({"num_layers": layers} if layers
                                     else {}))
        lm = LM(cfg)
        t0 = time.perf_counter()
        params = lm.init(25, device=DEV)
        redraw_biases(params, 25)
        torch.cuda.synchronize()
        log(f"[{name} fp32] {cfg.num_layers} layers, "
            f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B "
            f"parameters in {time.perf_counter() - t0:.1f}s")
        kernel_vs_plain(report, name, lm, params)
        del params, lm
        free()


class RouteLog:
    """Every MoE layer's expert ids, router probabilities and gaps (each
    row's k-th minus its (k+1)-th probability) under the key that ``at``
    sets, while ``moe.route`` is wrapped by ``wrapped``: what two paths
    routed, row for row."""

    def __init__(self):
        self.calls, self.key = {}, None

    @contextlib.contextmanager
    def at(self, key):
        self.key = key
        try:
            yield
        finally:
            self.key = None

    @contextlib.contextmanager
    def wrapped(self):
        from repro_torch.models import moe
        real = moe.route

        def route(router_p, cfg, xg):
            out = real(router_p, cfg, xg)
            if self.key is not None:
                probs = torch.softmax(xg.float() @ router_p["kernel"].float(),
                                      dim=-1)
                top = probs.sort(dim=-1, descending=True).values
                k = cfg.experts_per_token
                # with cap >= S no expert can overflow: the group's rows
                # route independently
                indep = moe._capacity(xg.shape[1], cfg) >= xg.shape[1]
                self.calls.setdefault(self.key, []).append(
                    (out[1].clone(), top[..., k - 1] - top[..., k], indep,
                     probs))
            return out

        with _patched(moe, "route", route):
            yield self

    def flips(self, a, b):
        """Layer by layer, the (groups, rows) mask of rows whose ids differ
        between keys a and b, b's router gaps, whether the group's rows
        route independently (no expert can overflow), and each row's
        largest router-probability difference between a and b."""
        assert len(self.calls[a]) == len(self.calls[b])
        return [((ia != ib).any(-1), gap, indep, (pa - pb).abs().amax(-1))
                for (ia, _, _, pa), (ib, gap, indep, pb)
                in zip(self.calls[a], self.calls[b])]


#: the router gap below which a row that routes otherwise on the kernel and
#: plain paths is a tie, both choices right: PR 21's 1e-4 over native
#: pages; over int8 pages the two paths' K/V round to levels one apart
#: here and there (PR 21's finding), which moves the routers' inputs ten
#: times more (the largest router-probability difference on rows that
#: route alike: 1.1e-6 native, 2.6e-5 int8, at moonshot's 4 layers)
ROUTE_GAP = {"native": 1e-4, "int8": 1e-3}


def kernel_vs_plain(report, name, lm, params, images=None, lens=None,
                    bucket=128) -> None:
    """fp32, TF32 off: the kernel path (K2 prefill, K1 decode, K3 at every
    RMSNorm) against the plain path (dense prefill, gathered decode, plain
    norms) over native and int8 pages: one batched prefill of 4 prompts
    (``lens``, default 70-128 tokens, in one ``bucket`` of 128; behind each
    prompt its image of ``images`` (4, n, d) for a vlm config, a block of n
    + 128) and 16 decode steps fed the plain path's greedy token.  Logits
    to 1e-3 relative max error; greedy tokens equal wherever the plain
    top-2 gap exceeds the error; launches exact (K2 fp32 L times a
    prefill, K1 L times a decode step, K3 once a norm of a prefill or a
    decode step (a LayerNorm has no kernel), nothing on the plain path).
    A moe config's expert ids are recorded on both paths (``RouteLog``):
    the first row of a routing group whose ids differ must be a router tie
    (gap below ``ROUTE_GAP`` of the page format); from there the group is tainted (its
    capacity positions, then its hidden states, differ) and leaves the
    logits gate, counted: a prefill sequence, or a decode slot for the
    rest of the run, or, where an expert of the decode group can overflow
    (cap below the group), every slot once one is tainted."""
    from repro_torch.kernels import ops
    from repro_torch.models import ForwardOpts
    from repro_torch.serve.kvcache import PagedCache
    opts = {"kernel": ForwardOpts("flash", "kernel"),
            "plain": ForwardOpts("dense", "plain")}
    # path -> (prefill opts, decode impl, page format)
    paths = {"kernel": ("kernel", "kernel", "native"),
             "plain": ("plain", "gather", "native"),
             "kernel-int8": ("kernel", "kernel", "int8"),
             "plain-int8": ("plain", "gather", "int8")}
    rng = np.random.default_rng(25)
    lens = lens or [70, 97, 115, 128]
    n, steps = len(lens), 16
    cfg = lm.cfg
    with RouteLog().wrapped() as routes:
        L = cfg.num_layers
        img = 0 if images is None else images.shape[1]
        norms = (L * (2 + 2 * cfg.qk_norm) + 1 if cfg.norm == "rmsnorm"
                 else 0)
        tokens = np.zeros((n, bucket), np.int64)
        for j, plen in enumerate(lens):
            tokens[j, :plen] = rng.integers(0, cfg.vocab_size, plen)
        tok_dev = torch.as_tensor(tokens, device=DEV)
        last = torch.as_tensor(img + np.array(lens) - 1, device=DEV)
        caches, logits = {}, {}
        for oname, o in opts.items():
            ops.reset_launch_counts()
            with torch.no_grad(), routes.at(("prefill", oname)):
                lg, cache = lm.forward(params, tok_dev, o,
                                       collect_cache=True, img_embeds=images)
            torch.cuda.synchronize()
            launches = {k: v for k, v in ops.launch_counts().items() if v}
            want = ({"flash_attention_bhsd_fp32": L, "rmsnorm_rows": norms}
                    if oname == "kernel" else {})
            want = {k: v for k, v in want.items() if v}
            assert launches == want, \
                (f"[{name}] {oname}-path prefill launched {launches}, not "
                 f"{want}")
            count_layout(report, launches, cfg)
            for pname, (pre, _, kv_dtype) in paths.items():
                if pre != oname:
                    continue
                kv = PagedCache(cfg, n, 512 if img or bucket + steps > 256
                                else 256, page_size=16, device=DEV,
                                dtype=torch.float32, kv_dtype=kv_dtype)
                dest = np.zeros((n, img + bucket), np.int32)
                for j, plen in enumerate(lens):
                    assert kv.alloc(j, img + plen + steps) == 0
                    dest[j] = kv.prefill_dest(j, img + bucket, img + plen)
                kv.staged_write_prefill(kv.quantize_block(cache["layers"]),
                                        torch.as_tensor(dest, device=DEV))
                caches[pname] = kv
                logits[pname] = [lg[torch.arange(n, device=DEV), last]]
            del lg, cache
        pos = torch.as_tensor(img + np.array(lens, np.int32), device=DEV)
        nxt = logits["plain"][0].argmax(-1)
        for t in range(steps):
            for pname, (pre, impl, kv_dtype) in paths.items():
                ops.reset_launch_counts()
                with torch.no_grad(), routes.at(("decode", pname, t)):
                    lg, _ = lm.decode_step(params, nxt[:, None],
                                           caches[pname].decode_view(),
                                           pos + t, decode_impl=impl,
                                           norm_impl=opts[pre].norm_impl)
                launches = {k: v for k, v in ops.launch_counts().items() if v}
                k1 = "paged_flash_decode" + ("_int8" if kv_dtype == "int8"
                                             else "")
                want = ({k1: L, "rmsnorm_rows": norms} if impl == "kernel"
                        else {})
                want = {k: v for k, v in want.items() if v}
                assert launches == want, \
                    f"[{name}] {pname} decode launched {launches}"
                count_layout(report, launches, cfg)
                logits[pname].append(lg[:, -1])
            nxt = logits["plain"][-1].argmax(-1)
        for kernel, plain in (("kernel", "plain"),
                              ("kernel-int8", "plain-int8")):
            # the sequences each step's logits gate holds: all, but those a
            # router tie sent other ways on the two paths
            held = [torch.ones(n, dtype=torch.bool, device=DEV)]
            first = later = ties = 0
            if routes.calls:
                # the router gap of each row first to route otherwise
                gaps, deltas = [], []
                limit = ROUTE_GAP["int8" if "int8" in kernel else "native"]

                def check(new, gap, delta, alike):
                    nonlocal first
                    deltas.append(float(delta[alike].max())
                                  if bool(alike.any()) else 0.0)
                    gaps.extend(gap[new].tolist())
                    first += int(new.sum())

                for diff, gap, _, delta in routes.flips(
                        ("prefill", "kernel"), ("prefill", "plain")):
                    live = held[0][:, None].expand_as(diff)
                    check(diff & live, gap, delta, ~diff & live)
                    later += int((diff & ~live).sum())
                    held[0] &= ~diff.any(-1)
                for t in range(steps):
                    ok = held[-1].clone()
                    for diff, gap, indep, delta in routes.flips(
                            ("decode", kernel, t), ("decode", plain, t)):
                        rows, gap, delta = diff[0], gap[0], delta[0]
                        if not indep and not bool(ok.all()):
                            ok[:] = False    # a tainted slot takes capacity
                        new = rows & ok
                        check(new, gap, delta, ~rows & ok)
                        later += int((rows & ~ok).sum())
                        if bool(new.any()):
                            ok = ok & ~rows if indep else \
                                torch.zeros_like(ok)
                    held.append(ok)
                ties = sum(int((~h).sum()) for h in held)
                log(f"[{name} fp32] {kernel} vs {plain} routing: "
                    f"{len(routes.calls[('prefill', 'plain')])} moe layers, "
                    f"largest router-probability difference on rows that "
                    f"route alike {max(deltas):.3e}; {first} rows first to "
                    f"route otherwise in their group, router gaps "
                    f"{[f'{g:.2e}' for g in gaps]} (limit {limit}), "
                    f"{later} rows downstream of them; {ties} of "
                    f"{n * (steps + 1)} sequence-steps left out of the "
                    "logits gate")
                assert all(g < limit for g in gaps), \
                    f"[{name}] expert ids differ off a router tie"
            worst, agree, decided = 0.0, 0, 0
            for a, b, h in zip(logits[kernel], logits[plain], held):
                a = a[h, :cfg.vocab_size].float()
                b = b[h, :cfg.vocab_size].float()
                if not len(b):
                    continue
                assert bool(torch.isfinite(a).all())
                diff = (a - b).abs()
                worst = max(worst, float(diff.max() / b.abs().max()))
                top2 = b.topk(2, dim=-1).values
                gap = top2[:, 0] - top2[:, 1] > diff.max(-1).values
                same = a.argmax(-1) == b.argmax(-1)
                assert bool((same | ~gap).all()), \
                    f"[{name}] {kernel}: greedy tokens disagree"
                agree += int(same.sum())
                decided += int(gap.sum())
            log(f"[{name} fp32] {kernel} vs {plain} path: prefill + {steps} "
                f"decode steps, logits rel max err {worst:.3e} (limit 1e-3), "
                f"greedy agree {agree}/{n * (steps + 1) - ties} ({decided} "
                f"decided by a gap above the error) [{nvidia_smi_line()}]")
            assert worst <= 1e-3, f"[{name}] {kernel} path leaves {plain}"
        del caches, logits



def granite_serve(report) -> None:
    """(c) granite-20b-code at full width and full depth in bf16, random
    weights from a seed (biases and LayerNorm leaves redrawn), served by
    ``ServeEngine`` on phase 5's workload (16 requests, 32 new tokens,
    max_batch 8, page 16) through the CUDA-graph step over native and int8
    pages, then the same eagerly: graph streams equal eager streams, one
    replay a decode step, K1 52 times a replay and K2 52 times a prefill
    dispatch (``serve_runs``'s gates).  ``LM.init``'s peak allocated
    memory is printed, and each run's fused step and one prefill forward
    are profiled."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    cfg = get_config("granite-20b-code")
    lm = LM(cfg)
    free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(20, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    redraw_biases(params, 20)
    log(f"[granite-20b-code] bf16 parameters "
        f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held; LM.init "
        f"{init_s:.1f}s, peak allocated during LM.init "
        f"{init_peak / 2**30:.2f} GiB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} "
        f"[{nvidia_smi_line()}]")
    runs = serve_runs(lm, params, (
        ("native", {}), ("int8", {"kv_dtype": "int8"}),
        ("native-eager", {"cuda_graph": False}),
        ("int8-eager", {"kv_dtype": "int8", "cuda_graph": False})),
        "granite-20b-code")
    for label in ("native", "int8"):
        run, eager = runs[label], runs[label + "-eager"]
        count_layout(report, run["launches"], cfg)
        same = run["streams"] == eager["streams"]
        log(f"[granite-20b-code {label}] graph streams equal the eager "
            f"streams token for token: {same}; {run['tok_s']:.1f} tok/s, "
            f"decode step {run['decode_ms']:.2f} ms (graph; one replay on "
            f"the device {run.get('replay_ms', float('nan')):.3f} ms) vs "
            f"{eager['decode_ms']:.2f} ms eager, TTFT p50 "
            f"{run['ttft_ms']:.1f} ms, pool {run['pool_tensor_bytes']} B "
            f"[{nvidia_smi_line()}]")
        assert same, f"[granite-20b-code {label}] graph streams differ"
    del params, runs
    free()


# ------------------------------------------------------------ phase 12 ----

def _grow_shared(cache, extra: int):
    """Zamba2's shared K/V rows grown by ``extra`` zero rows along S, so
    decode steps past the prompt have rows to write."""
    if "shared" in cache:
        cache["shared"] = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0,
                                                          extra))
                           for k, v in cache["shared"].items()}
    return cache


def _state_bytes(cache) -> tuple:
    layers = sum(t.numel() * t.element_size()
                 for t in cache["layers"].values())
    shared = sum(t.numel() * t.element_size()
                 for t in cache.get("shared", {}).values())
    return layers, shared


def recurrent_decode_parity(depths) -> None:
    """(a) fp32, plain mixers (K2 and K3 otherwise), full width at phase
    8's gated depth (the fp32 plain forward within 1e-4 of float64): a
    prefill of 511 tokens and one decode step against the forward's row
    511, then 8 chained decode steps against the forward over the 520-token
    sequence; each to 1e-3 relative max error."""
    from repro_torch.configs import get_config
    from repro_torch.models import ForwardOpts, LM
    opts = ForwardOpts(attn_impl="flash", norm_impl="kernel",
                       mixer_impl="plain")
    rng = np.random.default_rng(26)
    b, pre, steps = 2, 511, 9
    for name in RECURRENT:
        full = dataclasses.replace(get_config(name), dtype="float32")
        cfg = dataclasses.replace(full, num_layers=depths[name])
        lm = LM(cfg)
        params = LM(full).init(12, device=DEV)
        p = dict(params, layers=_first_layers(params["layers"],
                                              cfg.num_layers))
        v = cfg.vocab_size
        toks = torch.as_tensor(rng.integers(0, v, (b, pre + steps)),
                               device=DEV)
        with torch.no_grad():
            ref = lm.forward(p, toks, opts)[0][..., :v].double()
            _, cache = lm.prefill(p, toks[:, :pre], opts)
            cache = _grow_shared(cache, steps)
            errs = []
            for t in range(steps):
                lg, cache = lm.decode_step(
                    p, toks[:, pre + t:pre + t + 1], cache,
                    torch.full((b,), pre + t, dtype=torch.int32, device=DEV))
                a, r = lg[:, 0, :v].double(), ref[:, pre + t]
                assert bool(torch.isfinite(a).all())
                errs.append(float((a - r).abs().max() / r.abs().max()))
        log(f"[{name} fp32] {cfg.num_layers} of {full.num_layers} layers, "
            f"B={b}: prefill {pre} + decode: rel max err against the "
            f"forward's row {pre} {errs[0]:.3e}, then {steps - 1} chained "
            f"steps worst {max(errs[1:]):.3e} (limit 1e-3) "
            f"[{nvidia_smi_line()}]")
        assert max(errs) <= 1e-3, f"{name}: decode leaves the forward"
        del params, p, ref, cache
        free()


def recurrent_decode_serve() -> None:
    """(b) bf16, B=4 prompts of 512, 64 greedy tokens (the prefill's and
    63 decode steps'), the kernel path (K2, K3; a collected cache runs the
    plain mixers) and the plain path: prefill ms, decode step ms (CUDA
    events), tok/s, state and shared-cache bytes, peak memory.  Launches
    exact: zamba2's prefill runs K2 6 times and K3 89 times, each decode
    step K3 89 times and no K2; rwkv6 launches none; the plain path none.
    The kernel path's first tokens and its agreement with the plain path
    are printed."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import ForwardOpts, LM
    paths = {"kernel": ForwardOpts(),
             "plain": ForwardOpts(attn_impl="dense", norm_impl="plain",
                                  mixer_impl="plain")}
    b, s, new = 4, 512, 64
    rng = np.random.default_rng(27)
    for name in RECURRENT:
        cfg = get_config(name)
        assert cfg.dtype == "bfloat16"
        lm = LM(cfg)
        params = lm.init(13, device=DEV)
        v = cfg.vocab_size
        toks = torch.as_tensor(rng.integers(0, v, (b, s)), device=DEV)
        hybrid = cfg.family == "hybrid"
        n_shared = cfg.num_layers // cfg.hybrid_attn_every if hybrid else 0
        norms = 2 * cfg.num_layers + 2 * n_shared + 1 if hybrid else 0
        streams = {}
        for path, o in paths.items():
            kernel = path == "kernel"
            free()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, cache = lm.prefill(params, toks, o)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            launches = {k: c for k, c in ops.launch_counts().items() if c}
            want = ({"flash_attention_bhsd": n_shared, "rmsnorm_rows": norms}
                    if kernel and hybrid else {})
            assert launches == want, \
                f"[{name} {path}] prefill launched {launches}, not {want}"
            cache = _grow_shared(cache, new)
            state_b, shared_b = _state_bytes(cache)
            nxt = logits[:, -1, :v].argmax(-1)
            out = [nxt]
            events = []
            t0 = time.perf_counter()
            for t in range(new - 1):
                ops.reset_launch_counts()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                with torch.no_grad():
                    lg, cache = lm.decode_step(
                        params, nxt[:, None], cache,
                        torch.full((b,), s + t, dtype=torch.int32,
                                   device=DEV), norm_impl=o.norm_impl)
                end.record()
                events.append((start, end))
                launches = {k: c for k, c in ops.launch_counts().items()
                            if c}
                want = ({"rmsnorm_rows": norms} if kernel and hybrid
                        else {})
                assert launches == want, \
                    f"[{name} {path}] decode step launched {launches}"
                nxt = lg[:, -1, :v].argmax(-1)
                out.append(nxt)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
            step_ms = float(np.mean([a.elapsed_time(z) for a, z in events]))
            streams[path] = torch.stack(out, dim=1).cpu()
            assert streams[path].shape == (b, new)
            log(f"[{name} bf16 {path}] B={b} prompts of {s}: prefill "
                f"{prefill_ms:.2f} ms, decode step {step_ms:.3f} ms (CUDA "
                f"events, mean of {new - 1}), {b * (new - 1) / decode_s:.1f} "
                f"decode tok/s ({decode_s * 1e3:.1f} ms for {new - 1} steps "
                f"on the host clock); states {state_b} B, shared K/V "
                f"{shared_b} B; peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                f"[{nvidia_smi_line()}]")
            del logits, cache, lg
        same = int((streams["kernel"] == streams["plain"]).sum())
        first = int((streams["kernel"][:, 0] == streams["plain"][:, 0]).sum())
        log(f"[{name} bf16] kernel path's first tokens "
            f"{streams['kernel'][:, :8].tolist()}; {same}/{b * new} tokens "
            f"equal the plain path's, first tokens {first}/{b} (bf16, "
            f"random weights: reported, not a gate)")
        del params
        free()


# ----------------------------------------------------------------- main ----

# ------------------------------------------------------------ phase 13 ----

#: phase 13's remat runs: (policy, sequence length of the fixed batch); no
#: remat keeps every layer's plain-scan activations, ~1.8 GiB a zamba2 layer
#: at 4 x 1024, which with the 17.6 GiB of fp32 state passes the card: it
#: runs at 4 x 512 (PERF.md's prediction for phase 13)
REMAT_RUNS = (("none", 512), ("selective", 1024), ("full", 1024))
#: phase 13's depths (full width): a cut for the smoke's time, which phase
#: 19 brought near its limit on a slow host
RECURRENT_TRAIN_LAYERS = {"zamba2-1.2b": 12, "rwkv6-1.6b": 6}


def _train_loop_run(lm, tcfg, opts, batch, steps, tmp):
    """``steps`` steps of ``make_train_step`` through ``FTTrainLoop`` on one
    fixed batch from ``init_train_state(lm, 0)``: (metrics log, step
    seconds, peak GiB, launches, parameter leaves)."""
    from repro_torch.core import FTTrainLoop
    from repro_torch.core.telemetry import MetricsRegistry
    from repro_torch.kernels import ops
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.optimizer import tree_leaves
    reg = MetricsRegistry()
    # checkpoints every steps + 1: none is written here
    loop = FTTrainLoop(make_train_step(lm, tcfg, opts),
                       lambda: init_train_state(lm, 0, tcfg, device=DEV),
                       tmp, ckpt_every=steps + 1, registry=reg)
    free()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    final = loop.run(lambda step: batch, steps)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_leaves = len(tree_leaves(final["params"]))
    del final
    free()
    return (loop.metrics_log, reg.histogram("train_step_seconds").recent(
        steps), peak, launches, n_leaves)


def _train_gates(tag, log_, launches, steps, n_leaves):
    """Finite losses that fall on the fixed batch; K4 forward and backward
    once a step, K5 once a leaf a step, no other kernel (the train forward
    runs blockwise attention, plain norms and the plain mixers)."""
    losses = [m["loss"] for m in log_]
    want = {name: 0 for name in launches}
    want.update(softmax_xent_fwd=steps, softmax_xent_bwd=steps,
                adamw_fused=steps * n_leaves)
    log(f"{tag} losses {[round(x, 4) for x in losses]}, grad_norm "
        f"{[round(m['grad_norm'], 4) for m in log_]}; launch counts "
        f"{ {k: v for k, v in launches.items() if v} }, expected "
        f"{ {k: v for k, v in want.items() if v} }")
    assert len(losses) == steps and all(np.isfinite(losses)), \
        f"{tag} loss not finite"
    assert losses[-1] < losses[0], f"{tag} loss did not fall"
    assert launches == want, f"{tag} the train path's launches differ"


def recurrent_train(report, steps: int = 6) -> None:
    """Phase 13: zamba2-1.2b and rwkv6-1.6b at full width, cut to
    RECURRENT_TRAIN_LAYERS (the smoke's time; zamba2's shared block fires
    twice in 12 layers) (fp32
    parameters and moments, bf16 compute, random weights from seed 0)
    trained by ``FTTrainLoop`` over ``make_train_step`` (the plain chunked
    mixers, blockwise attention, plain norms; K4 and K5) on one fixed batch
    from a synthetic corpus, ``steps`` steps under each remat policy of
    ``REMAT_RUNS``; gated by ``_train_gates``.  Step 0's loss must be equal
    across the three policies (bitwise; the forward is the same ops) and
    its grad_norm within 1e-4 relative (bitwise reported): "none" at 4 x
    512 against one step of each other policy there, and selective against
    full at 4 x 1024.  Step ms, tok/s, MFU and peak memory of each run;
    then K4 at the phase's logits and K5 at each model's largest leaf,
    timed beside their plain versions, library calls and bounds."""
    import tempfile
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import (DeterministicLoader, LoaderConfig,
                                  TokenDataset, synthetic_corpus,
                                  write_token_shards)
    from repro_torch.models import LM
    from repro_torch.train import (TRAIN_OPTS, init_train_state,
                                   make_train_step)
    b, s_max = 4, max(s for _, s in REMAT_RUNS)
    gen = torch.Generator().manual_seed(13)
    (ROOT / "build").mkdir(exist_ok=True)
    for name in RECURRENT:
        cfg = dataclasses.replace(get_config(name),
                                  num_layers=RECURRENT_TRAIN_LAYERS[name])
        lm = LM(cfg)
        tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2,
                           total_steps=steps)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            toks = synthetic_corpus(max(2_000_000, b * s_max * 20),
                                    cfg.vocab_size, seed=0)
            write_token_shards(f"{tmp}/data", toks)
            full = DeterministicLoader(TokenDataset(f"{tmp}/data"),
                                       LoaderConfig(b, s_max)).batch_at(0)

            def cut(s):
                return {k: np.ascontiguousarray(v[:, :s])
                        for k, v in full.items()}

            def opts(remat, s):
                return dataclasses.replace(TRAIN_OPTS, remat=remat,
                                           q_chunk=s, kv_chunk=s)

            step0 = {}
            for remat, s in REMAT_RUNS:
                tag = f"[{name} train remat={remat} {b}x{s}]"
                log_, step_s, peak, launches, n_leaves = _train_loop_run(
                    lm, tcfg, opts(remat, s), cut(s), steps, f"{tmp}/{remat}")
                _train_gates(tag, log_, launches, steps, n_leaves)
                step0[(remat, s)] = (log_[0]["loss"], log_[0]["grad_norm"])
                steady = float(np.mean(step_s[2:]))
                flops = cfg.flops_per_token(s, "train") * b * s
                log(f"{tag} {steps} steps: first {step_s[0] * 1e3:.1f} ms, "
                    f"mean step {steady * 1e3:.2f} ms over steps 2..{steps - 1}"
                    f" ({b * s / steady:.1f} tok/s), MFU "
                    f"{flops / steady / BF16_PEAK * 100:.2f}% of "
                    f"{BF16_PEAK / 1e12:.0f} TFLOP/s "
                    f"({flops / 1e12:.2f} TFLOP a step), peak memory "
                    f"{peak:.2f} GiB [{nvidia_smi_line()}]")
                for kernel in ("softmax_xent_fwd", "softmax_xent_bwd",
                               "adamw_fused"):
                    key = f"{kernel}[{name} train]"
                    report.setdefault(key, {"launches": 0})
                    report[key]["launches"] += launches[kernel]
            # step 0 of the other policies at "none"'s length
            s0 = REMAT_RUNS[0][1]
            for remat in ("selective", "full"):
                state = init_train_state(lm, 0, tcfg, device=DEV)
                _, m = make_train_step(lm, tcfg, opts(remat, s0))(
                    state, cut(s0))
                step0[(remat, s0)] = (float(m["loss"]), float(m["grad_norm"]))
                del state, m
                free()
        for a, c in ((("none", s0), ("selective", s0)),
                     (("none", s0), ("full", s0)),
                     (("selective", s_max), ("full", s_max))):
            (la, ga), (lc, gc) = step0[a], step0[c]
            rel = abs(ga - gc) / abs(ga)
            log(f"[{name} train] step 0 {a[0]} vs {c[0]} at {b}x{a[1]}: loss "
                f"{la!r} vs {lc!r} (bitwise {la == lc}), grad_norm {ga!r} vs "
                f"{gc!r} (bitwise {ga == gc}, rel diff {rel:.3e}, limit 1e-4)")
            assert la == lc, f"[{name}] step 0's loss differs across remat"
            assert rel <= 1e-4, f"[{name}] step 0's grad_norm differs"
        # K4 at the phase's logits (b x s_max rows of the padded vocab) and
        # K5 at the largest parameter leaf
        fwd, bwd = k4_timed(b * s_max, cfg.padded_vocab, gen,
                            f" ({name} train logits)")
        report[f"softmax_xent_fwd[{name} train]"].update(fwd)
        report[f"softmax_xent_bwd[{name} train]"].update(bwd)
        def sizes(t):
            return ([math.prod(t.shape)] if hasattr(t, "shape")
                    else [n for v in t.values() for n in sizes(v)])
        n = max(sizes(lm.spec()))
        report[f"adamw_fused[{name} train]"].update(
            k5_timed(n, gen, f" ({name}'s largest leaf)"))
        free()


# ------------------------------------------------------------ phase 14 ----

def _vlm_params(lm, seed: int):
    """Random weights from ``seed``, with ``img_pos`` redrawn ~ N(0, 0.5):
    ``LM.init`` zeros it, as JAX does, which would hide a dropped table."""
    params = lm.init(seed, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    params["img_pos"].copy_(torch.randn(params["img_pos"].shape,
                                        generator=gen, device=DEV) * 0.5)
    return params


def _vlm_images(cfg, n: int, seed: int) -> np.ndarray:
    """n seeded random (num_image_tokens, d) stub-ViT images."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (n, cfg.num_image_tokens, cfg.d_model), dtype=np.float32)


def vlm_kernel_vs_plain(report) -> None:
    """(a) internvl2-2b at full width cut to 4 layers, fp32: the kernel path
    against the plain path over native and int8 pages, each prompt behind
    its image (``kernel_vs_plain``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    cfg = dataclasses.replace(get_config("internvl2-2b"), dtype="float32",
                              num_layers=4)
    lm = LM(cfg)
    params = _vlm_params(lm, 27)
    kernel_vs_plain(report, "internvl2-2b", lm, params,
                    torch.as_tensor(_vlm_images(cfg, 4, 27), device=DEV))
    del params
    free()


def vlm_layouts(report) -> None:
    """K1 at internvl2-2b's head layout (KV=8 G=2, D=128, page 16, phase
    3's ragged positions and NaN dead pages), native and int8, fp32 and
    bf16 q, against its plain version and its plain split schedule, and
    timed at phase 3's serve positions; K2 at the image-prefixed blocks,
    fp32 (a) 4 x (256 + 128) and bf16 (b) 8 x (256 + 256), causal, timed
    beside SDPA and the bound."""
    from repro_torch.kernels import flash_attention as fa
    kv, g = 8, 2
    k1_layout(report, "internvl2-2b", kv, g, (torch.float32, torch.bfloat16))
    gen = torch.Generator(device=DEV).manual_seed(15)
    for dtype, mode, n, s in ((torch.float32, "flash_attention_bhsd_fp32", 4,
                               256 + 128),
                              (torch.bfloat16, "flash_attention_bhsd", 8,
                               256 + 256)):
        r = time_k2(fa, f"internvl2-2b image-prefixed prefill ({n} x {s})", n,
                    s, kv, g, 128, dtype, gen)
        report[layout_entry(mode, kv, g, dtype)] = dict(r, launches=0)
    free()


def vlm_serve(report) -> None:
    """(b) internvl2-2b at full size in bf16 (random weights from a seed,
    ``img_pos`` redrawn) on phase 5's workload, each request with its own
    seeded random (256, 2048) image, through the CUDA-graph step and
    eagerly, over native and int8 pages (``serve_runs``' gates: launches
    exact, one replay a decode step, all requests complete): the graph's
    streams equal the eager ones token for token, and no page is shared
    (image prompts skip prefix sharing)."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    cfg = get_config("internvl2-2b")
    lm = LM(cfg)
    params = _vlm_params(lm, 28)
    images = _vlm_images(cfg, 16, 28)
    runs = serve_runs(lm, params, (
        ("native", {}), ("int8", {"kv_dtype": "int8"}),
        ("native-eager", {"cuda_graph": False}),
        ("int8-eager", {"kv_dtype": "int8", "cuda_graph": False})),
        "internvl2-2b", profile=False, images=images)
    for label in ("native", "int8"):
        run, eager = runs[label], runs[label + "-eager"]
        count_layout(report, run["launches"], cfg)
        same = run["streams"] == eager["streams"]
        log(f"[internvl2-2b {label}] graph streams equal the eager streams "
            f"token for token: {same}; {run['tok_s']:.1f} tok/s, decode step "
            f"{run['decode_ms']:.2f} ms (graph; one replay on the device "
            f"{run.get('replay_ms', float('nan')):.3f} ms) vs "
            f"{eager['decode_ms']:.2f} ms eager, TTFT p50 "
            f"{run['ttft_ms']:.1f} ms, mean prefill dispatch "
            f"{run['prefill_ms']:.2f} ms, pool {run['pool_tensor_bytes']} B, "
            f"pages shared {run['stats']['pages_shared']} "
            f"[{nvidia_smi_line()}]")
        assert same, f"[internvl2-2b {label}] graph streams differ"
        assert run["stats"]["pages_shared"] == 0, "an image prompt shared"
    del params, runs
    free()


def vlm_train(steps: int = 4) -> None:
    """(c) internvl2-2b at full size (fp32 parameters, bf16 compute, the
    default remat "selective"), ``steps`` steps of ``make_train_step`` on
    one fixed batch of 4 x (256 image + 256 text) positions: losses finite
    and falling, K4 and K5 launches exact, step ms, tok/s, MFU and peak
    memory."""
    import tempfile
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.models import LM
    from repro_torch.train import TRAIN_OPTS
    cfg = get_config("internvl2-2b")
    lm = LM(cfg)
    b, text = 4, 256
    s = cfg.num_image_tokens + text
    rng = np.random.default_rng(29)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, text)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, text)).astype(
                 np.int32),
             "img_embeds": _vlm_images(cfg, b, 29)}
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=steps)
    opts = dataclasses.replace(TRAIN_OPTS, q_chunk=s, kv_chunk=s)
    tag = f"[internvl2-2b train remat={opts.remat} {b}x({s - text}+{text})]"
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        log_, step_s, peak, launches, n_leaves = _train_loop_run(
            lm, tcfg, opts, batch, steps, tmp)
    _train_gates(tag, log_, launches, steps, n_leaves)
    steady = float(np.mean(step_s[1:]))
    flops = cfg.flops_per_token(s, "train") * b * s
    log(f"{tag} {steps} steps: first {step_s[0] * 1e3:.1f} ms, mean step "
        f"{steady * 1e3:.2f} ms over steps 1..{steps - 1} "
        f"({b * s / steady:.1f} positions/s), MFU "
        f"{flops / steady / BF16_PEAK * 100:.2f}% of "
        f"{BF16_PEAK / 1e12:.0f} TFLOP/s, peak memory "
        f"{peak:.2f} GiB [{nvidia_smi_line()}]")
    free()


# ------------------------------------------------------------ phase 15 ----

MOONSHOT, ARCTIC = "moonshot-v1-16b-a3b", "arctic-480b"


def moe_layouts(report) -> None:
    """K1 at moonshot-v1-16b-a3b's head layout (KV=16 G=1), entries fp32
    (run by (a)) and bf16 (served in (b)), and at arctic-480b's (KV=8
    G=7: seven query rows on the tensor cores' eight), entries bf16
    (served in (c)); K2 on the model layout at 256-token buckets, fp32 4
    prompts (a) and bf16 8 prompts (b, c), causal, beside SDPA; K3 at
    their row widths (d=2048, 7168; 2,048 rows), timed."""
    from repro_torch.kernels import flash_attention as fa
    k1_layout(report, MOONSHOT, 16, 1, (torch.float32, torch.bfloat16))
    k1_layout(report, ARCTIC, 8, 7, (torch.bfloat16,))
    gen = torch.Generator(device=DEV).manual_seed(150)
    for name, kv, g, dtype, n in ((MOONSHOT, 16, 1, torch.float32, 4),
                                  (MOONSHOT, 16, 1, torch.bfloat16, 8),
                                  (ARCTIC, 8, 7, torch.bfloat16, 8)):
        mode = ("flash_attention_bhsd_fp32" if dtype == torch.float32
                else "flash_attention_bhsd")
        r = time_k2(fa, f"{name} prefill ({n} prompts of bucket 256)", n,
                    256, kv, g, 128, dtype, gen)
        report[layout_entry(mode, kv, g, dtype)] = dict(r, launches=0)
    gen = torch.Generator().manual_seed(151)
    for d, name in ((2048, MOONSHOT), (7168, ARCTIC)):
        report[f"rmsnorm_rows[d={d}]"] = dict(
            k3_timed(2048, d, gen, f" ({name})"), launches=0)
    free()


def moe_kernel_vs_plain(report) -> None:
    """(a) moonshot-v1-16b-a3b at full width cut to 4 layers, fp32, random
    weights: ``kernel_vs_plain`` with 4 prompts of 150-256 tokens in one
    bucket of 256 (each its own routing group) and 16 decode steps (one
    group of 4), every layer's expert ids recorded on both paths."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    cfg = dataclasses.replace(get_config(MOONSHOT), dtype="float32",
                              num_layers=4)
    lm = LM(cfg)
    params = lm.init(150, device=DEV)
    kernel_vs_plain(report, MOONSHOT, lm, params, lens=[150, 201, 233, 256],
                    bucket=256)
    del params
    free()


def init_peak_reckoned(spec, dtype) -> int:
    """The bytes ``LM.init`` holds at its peak: it draws each leaf in fp32
    and casts it to ``dtype`` (fp32 leaves stay), so while a leaf is cast
    the leaves before it, its fp32 draw and its cast are all held."""
    held = peak = 0

    def walk(s):
        nonlocal held, peak
        if hasattr(s, "shape"):
            n = math.prod(s.shape)
            keep = 4 if s.fp32 else torch.finfo(dtype).bits // 8
            peak = max(peak, held + 4 * n + (0 if s.fp32 else keep * n))
            held += keep * n
            return
        for v in s.values():
            walk(v)

    walk(spec)
    return peak


def moe_serve(report, name, layers, runs, seed) -> None:
    """``name`` at full width in bf16 cut to ``layers`` layers, random
    weights from ``seed``: ``LM.init``'s reckoned and measured peaks, then
    phase 5's workload through ``serve_runs`` for each of ``runs`` (graph
    and eager pairs): graph streams equal the eager ones token for token,
    one replay a decode step, K1/K2/K3 launches exact (``serve_runs``'
    gates); replay ms (CUDA events), tok/s, TTFT p50, pool bytes, the
    graph's private pool, peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    cfg = dataclasses.replace(get_config(name), num_layers=layers)
    lm = LM(cfg)
    reckoned = init_peak_reckoned(lm.spec(), torch.bfloat16)
    free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(seed, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated()
    log(f"[{name} bf16, {layers} of {get_config(name).num_layers} layers] "
        f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B parameters, "
        f"{held / 2**30:.2f} GiB held; LM.init {init_s:.1f}s, peak allocated "
        f"during LM.init {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(reckoned {reckoned / 2**30:.2f} GiB) of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} "
        f"[{nvidia_smi_line()}]")
    out = serve_runs(lm, params, runs, name)
    for label, _ in runs:
        if label.endswith("-eager"):
            continue
        run, eager = out[label], out[label + "-eager"]
        count_layout(report, run["launches"], cfg)
        count_layout(report, eager["launches"], cfg)
        same = run["streams"] == eager["streams"]
        log(f"[{name} {label}] graph streams equal the eager streams token "
            f"for token: {same}; {run['tok_s']:.1f} tok/s, decode "
            f"step {run['decode_ms']:.2f} ms (graph; one replay on the "
            f"device {run.get('replay_ms', float('nan')):.3f} ms) vs "
            f"{eager['decode_ms']:.2f} ms eager, TTFT p50 "
            f"{run['ttft_ms']:.1f} ms, mean prefill dispatch "
            f"{run['prefill_ms']:.2f} ms, pool {run['pool_tensor_bytes']} B, "
            f"graph private pool {run['graph_pool_bytes']} B, peak memory "
            f"{run['peak_gib']:.2f} GiB [{nvidia_smi_line()}]")
        assert same, f"[{name} {label}] graph streams differ"
    del params, out
    free()


def moe_train(report, steps: int = 4) -> None:
    """(d) moonshot-v1-16b-a3b at full width cut to 2 layers (fp32 masters,
    bf16 compute), ``steps`` steps of ``make_train_step`` through
    ``FTTrainLoop`` on one fixed 4 x 256 batch under each remat policy
    (``_train_gates``): step 0's loss and grad_norm bitwise equal across
    the policies, ``moe_aux`` finite and non-zero at every step; step ms,
    tok/s and peak memory; K4 at its logits (1,024 x 163,840) and K5 at
    its largest leaf (the stacked expert matrices), timed."""
    import tempfile
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.models import LM
    from repro_torch.train import TRAIN_OPTS
    cfg = dataclasses.replace(get_config(MOONSHOT), num_layers=2)
    lm = LM(cfg)
    b, s = 4, 256
    rng = np.random.default_rng(152)
    batch = {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
             for k in ("tokens", "labels")}
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=steps)
    step0 = {}
    (ROOT / "build").mkdir(exist_ok=True)
    for remat in ("none", "selective", "full"):
        tag = f"[{MOONSHOT} train 2 layers remat={remat} {b}x{s}]"
        opts = dataclasses.replace(TRAIN_OPTS, remat=remat, q_chunk=s,
                                   kv_chunk=s)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            log_, step_s, peak, launches, n_leaves = _train_loop_run(
                lm, tcfg, opts, batch, steps, tmp)
        _train_gates(tag, log_, launches, steps, n_leaves)
        aux = [m["moe_aux"] for m in log_]
        assert all(np.isfinite(aux)) and all(a != 0 for a in aux), \
            f"{tag} moe_aux {aux}"
        step0[remat] = (log_[0]["loss"], log_[0]["grad_norm"])
        steady = float(np.mean(step_s[1:]))
        log(f"{tag} moe_aux {[round(a, 5) for a in aux]}; first step "
            f"{step_s[0] * 1e3:.1f} ms, mean step {steady * 1e3:.2f} ms over "
            f"steps 1..{steps - 1} ({b * s / steady:.1f} tok/s), peak memory "
            f"{peak:.2f} GiB [{nvidia_smi_line()}]")
        for kernel in ("softmax_xent_fwd", "softmax_xent_bwd",
                       "adamw_fused"):
            key = f"{kernel}[{MOONSHOT} train]"
            report.setdefault(key, {"launches": 0})
            report[key]["launches"] += launches[kernel]
    for remat in ("selective", "full"):
        log(f"[{MOONSHOT} train] step 0 none vs {remat}: loss "
            f"{step0['none'][0]!r} vs {step0[remat][0]!r}, grad_norm "
            f"{step0['none'][1]!r} vs {step0[remat][1]!r}")
        assert step0[remat] == step0["none"], \
            f"[{MOONSHOT}] step 0 differs under remat={remat}"
    gen = torch.Generator().manual_seed(153)
    fwd, bwd = k4_timed(b * s, cfg.padded_vocab, gen,
                        f" ({MOONSHOT} train logits)")
    report[f"softmax_xent_fwd[{MOONSHOT} train]"].update(fwd)
    report[f"softmax_xent_bwd[{MOONSHOT} train]"].update(bwd)
    n = cfg.num_layers * cfg.num_experts * cfg.d_model * cfg.moe_d_ff
    report[f"adamw_fused[{MOONSHOT} train]"].update(
        k5_timed(n, gen, f" ({MOONSHOT}'s stacked expert leaf)"))
    free()


# ------------------------------------------------------------ phase 16 ----

SEAMLESS = "seamless-m4t-large-v2"


def k2_entry(dtype, causal: bool) -> str:
    """seamless-m4t's K2 entries: head dim 64, the encoder's non-causal
    launches apart from the decoder's causal ones."""
    mode = ("flash_attention_bhsd_fp32" if dtype == torch.float32
            else "flash_attention_bhsd")
    return f"{mode}[KV=16,G=1,D=64{'' if causal else ',non-causal'}]"


def count_encdec(report, launches, cfg, dtype) -> None:
    """A forward's K2 launches into seamless-m4t's entries: the first
    ``encoder_layers`` of each forward are the encoder's (non-causal), the
    rest the decoder's; ``launches`` must be a whole number of forwards."""
    mode = ("flash_attention_bhsd_fp32" if dtype == torch.float32
            else "flash_attention_bhsd")
    n = launches.get(mode, 0)
    per = cfg.encoder_layers + cfg.num_layers
    assert n % per == 0, f"{n} K2 launches, not whole forwards of {per}"
    report[k2_entry(dtype, False)]["launches"] += n // per * \
        cfg.encoder_layers
    report[k2_entry(dtype, True)]["launches"] += n // per * cfg.num_layers


def encdec_layouts(report) -> None:
    """K2 at seamless-m4t's layout (KV=16 G=1 D=64) on the model layout:
    the encoder's non-causal attention over 64 frames and the decoder's
    causal attention over 256 tokens, 4 sequences, fp32 (a) and bf16 (b),
    beside SDPA and the bound."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=DEV).manual_seed(160)
    for dtype in (torch.float32, torch.bfloat16):
        for s, causal in ((64, False), (256, True)):
            r = time_k2(fa, f"{SEAMLESS} {'decoder' if causal else 'encoder'}"
                        f" (4 x {s})", 4, s, 16, 1, 64, dtype, gen, causal)
            report[k2_entry(dtype, causal)] = dict(r, launches=0)
    free()


def _encdec_inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                           device=DEV)
    frames = torch.as_tensor(rng.standard_normal(
        (b, s // cfg.enc_ratio, cfg.d_model), dtype=np.float32), device=DEV)
    return toks, frames


def encdec_parity(report) -> None:
    """(a) seamless-m4t-large-v2 at full size in fp32 (TF32 off), random
    weights with every bias and LayerNorm leaf redrawn: the kernel path
    (K2 in the encoder, non-causal, and in the decoder, causal) against
    the plain path (dense attention) on 4 x 256 tokens and 64 frames,
    logits to 1e-3 relative, greedy tokens equal where decided, K2
    launches exact; then ``LM.prefill`` of 223 tokens and 32
    ``decode_step``s fed the next tokens over the dense cache, the
    prefill's last row and each step's logits against the forward's row at
    its position to 1e-3."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import LM, ForwardOpts
    cfg = dataclasses.replace(get_config(SEAMLESS), dtype="float32")
    lm = LM(cfg)
    params = lm.init(160, device=DEV)
    redraw_biases(params, 160)
    b, s, steps = 4, 256, 32
    toks, frames = _encdec_inputs(cfg, b, s, 160)
    out = {}
    for path, opts in (("kernel", ForwardOpts("flash", "kernel")),
                       ("plain", ForwardOpts("dense", "plain"))):
        ops.reset_launch_counts()
        with torch.no_grad():
            out[path] = lm.forward(params, toks, opts,
                                   enc_embeds=frames)[0][..., :cfg.vocab_size]
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        want = ({"flash_attention_bhsd_fp32": cfg.encoder_layers
                 + cfg.num_layers} if path == "kernel" else {})
        assert launches == want, f"[{SEAMLESS}] {path} launched {launches}"
        count_encdec(report, launches, cfg, torch.float32)
    a, ref = out["kernel"].float(), out["plain"].float()
    diff = (a - ref).abs()
    rel = float(diff.max() / ref.abs().max())
    top2 = ref.topk(2, dim=-1).values
    decided = top2[..., 0] - top2[..., 1] > diff.max(-1).values
    same = a.argmax(-1) == ref.argmax(-1)
    log(f"[{SEAMLESS} fp32] kernel vs plain forward, 4 x 256 tokens, 64 "
        f"frames: logits rel max err {rel:.3e} (limit 1e-3), greedy agree "
        f"{int(same.sum())}/{same.numel()} ({int(decided.sum())} decided) "
        f"[{nvidia_smi_line()}]")
    assert rel <= 1e-3 and bool((same | ~decided).all()), \
        f"[{SEAMLESS}] kernel path leaves the plain path"
    full = out["kernel"]
    p = s - steps - 1
    ops.reset_launch_counts()
    with torch.no_grad():
        last, pre = lm.prefill(params, toks[:, :p], enc_embeds=frames)
        cache = lm.init_cache(b, s, backend=None, device=DEV,
                              enc_len=frames.shape[1])
        for k, t in pre["layers"].items():
            cache["layers"][k][:, :, :t.shape[2]] = t
        rows = [last[:, 0, :cfg.vocab_size]]
        for t in range(steps):
            lg, _ = lm.decode_step(params, toks[:, p + t:p + t + 1], cache,
                                   torch.full((b,), p + t, dtype=torch.int32,
                                              device=DEV))
            rows.append(lg[:, 0, :cfg.vocab_size])
    torch.cuda.synchronize()
    count_encdec(report, ops.launch_counts(), cfg, torch.float32)
    got = torch.stack(rows, 1).float()
    want = full[:, p - 1:p + steps].float()
    rel = float((got - want).abs().max() / want.abs().max())
    log(f"[{SEAMLESS} fp32] LM.prefill of {p} tokens + {steps} "
        f"decode_steps over the dense cache (enc_len {frames.shape[1]}) vs "
        f"the forward's rows: rel max err {rel:.3e} (limit 1e-3)")
    assert rel <= 1e-3, f"[{SEAMLESS}] decode leaves the forward"
    del params, out, cache, pre
    free()


def encdec_decode(report) -> None:
    """(b) seamless-m4t-large-v2 at full size in bf16 (biases and
    LayerNorm leaves redrawn): ``LM.prefill`` of 4 x 256 tokens with 64
    frames, then 32 greedy ``decode_step``s over the dense cache; the
    decode logits against a bf16 forward over prompt + generated tokens
    (greedy tokens equal wherever that forward's top-2 gap exceeds the
    difference); prefill ms, decode step ms (host clock, synchronised, and
    one step's device ms by CUDA events), peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    cfg = get_config(SEAMLESS)
    lm = LM(cfg)
    params = lm.init(161, device=DEV)
    redraw_biases(params, 161)
    b, s, steps = 4, 256, 32
    toks, frames = _encdec_inputs(cfg, b, s, 161)
    v = cfg.vocab_size
    with torch.no_grad():
        lm.prefill(params, toks, enc_embeds=frames)      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        last, pre = lm.prefill(params, toks, enc_embeds=frames)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        count_encdec(report, ops.launch_counts(), cfg, torch.bfloat16)
        cache = lm.init_cache(b, s + steps, backend=None, device=DEV,
                              enc_len=frames.shape[1])
        for k, t in pre["layers"].items():
            cache["layers"][k][:, :, :t.shape[2]] = t
        nxt = last[:, -1, :v].argmax(-1)
        gen, rows, step_ms = [nxt], [], []
        for t in range(steps):
            t0 = time.perf_counter()
            lg, _ = lm.decode_step(params, nxt[:, None], cache,
                                   torch.full((b,), s + t, dtype=torch.int32,
                                              device=DEV))
            nxt = lg[:, 0, :v].argmax(-1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            rows.append(lg[:, 0, :v])
            gen.append(nxt)
        pos = torch.full((b,), s, dtype=torch.int32, device=DEV)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        lm.decode_step(params, nxt[:, None], cache, pos)
        end.record()
        end.synchronize()
        step_dev = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated() / 2**30
        seq = torch.cat([toks, torch.stack(gen[:-1], 1)], 1)
        ops.reset_launch_counts()
        full, _ = lm.forward(params, seq, enc_embeds=frames)
        count_encdec(report, ops.launch_counts(), cfg, torch.bfloat16)
    want = full[:, s:s + steps, :v].float()
    got = torch.stack(rows, 1).float()
    diff = (got - want).abs()
    top2 = want.topk(2, dim=-1).values
    decided = top2[..., 0] - top2[..., 1] > diff.max(-1).values
    same = got.argmax(-1) == want.argmax(-1)
    log(f"[{SEAMLESS} bf16] LM.prefill 4 x {s} tokens + 64 frames "
        f"{prefill_ms:.1f} ms; {steps} greedy decode_steps over the dense "
        f"cache: mean {np.mean(step_ms[1:]):.2f} ms a step (host clock, "
        f"synchronised), one step {step_dev:.2f} ms by CUDA events (eager, "
        f"host-bound where it exceeds the kernels' time); decode vs a bf16 "
        f"forward of prompt + generated tokens: rel max err "
        f"{float(diff.max() / want.abs().max()):.3e}, greedy agree "
        f"{int(same.sum())}/{same.numel()} ({int(decided.sum())} decided); "
        f"peak memory {peak:.2f} GiB [{nvidia_smi_line()}]")
    assert bool(torch.isfinite(got).all())
    assert bool((same | ~decided).all()), f"[{SEAMLESS}] decode leaves " \
        "the forward"
    del params, cache, pre, full
    free()


def encdec_train(report, steps: int = 4) -> None:
    """(c) seamless-m4t-large-v2 at full size (fp32 masters, bf16 compute,
    remat none), ``steps`` steps of ``make_train_step`` through
    ``FTTrainLoop`` on one fixed batch of 4 x 512 tokens with 128 frames
    (``_train_gates``); step ms, tok/s, MFU and peak memory; K4 at its
    logits (2,048 x 256,256, the padded vocab) and K5 at its largest leaf
    (the embedding, 256,256 x 1,024), timed."""
    import tempfile
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.models import LM
    from repro_torch.train import TRAIN_OPTS
    cfg = get_config(SEAMLESS)
    lm = LM(cfg)
    b, s = 4, 512
    rng = np.random.default_rng(162)
    batch = {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
             for k in ("tokens", "labels")}
    batch["enc_embeds"] = rng.standard_normal(
        (b, s // cfg.enc_ratio, cfg.d_model), dtype=np.float32)
    # with no warm-up (warmup_steps=1, as phases 13 and 14 run) the loss
    # rose at the third step on the card: Adam's first steps move every
    # weight by about the learning rate at once; a warm-up of 6 steps, as
    # a real run has one, takes the loss down
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=6, total_steps=100)
    opts = dataclasses.replace(TRAIN_OPTS, remat="none", q_chunk=s,
                               kv_chunk=s)
    tag = f"[{SEAMLESS} train remat=none {b}x{s} + {s // cfg.enc_ratio} " \
        "frames]"
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        log_, step_s, peak, launches, n_leaves = _train_loop_run(
            lm, tcfg, opts, batch, steps, tmp)
    _train_gates(tag, log_, launches, steps, n_leaves)
    steady = float(np.mean(step_s[1:]))
    flops = cfg.flops_per_token(s, "train") * b * s
    log(f"{tag} {steps} steps: first {step_s[0] * 1e3:.1f} ms, mean step "
        f"{steady * 1e3:.2f} ms over steps 1..{steps - 1} "
        f"({b * s / steady:.1f} tok/s), MFU "
        f"{flops / steady / BF16_PEAK * 100:.2f}% of "
        f"{BF16_PEAK / 1e12:.0f} TFLOP/s, peak memory "
        f"{peak:.2f} GiB [{nvidia_smi_line()}]")
    gen = torch.Generator().manual_seed(163)
    fwd, bwd = k4_timed(b * s, cfg.padded_vocab, gen,
                        f" ({SEAMLESS} train logits)")
    n = cfg.padded_vocab * cfg.d_model
    for kernel, r in (("softmax_xent_fwd", fwd), ("softmax_xent_bwd", bwd),
                      ("adamw_fused", k5_timed(
                          n, gen, f" ({SEAMLESS}'s embedding)"))):
        report[f"{kernel}[{SEAMLESS} train]"] = dict(
            r, launches=launches[kernel])
    free()


def moe_phase(report) -> None:
    """Phase 15: the head layouts, (a) the fp32 kernel path against the
    plain path, (b) moonshot-v1-16b-a3b served at 12 of its 48 layers
    (native and int8 pages, graph and eager), (c) arctic-480b served at 1
    of its 35 layers (the same), (d) moonshot trained at 2 layers."""
    moe_layouts(report)
    moe_kernel_vs_plain(report)
    pairs = (("native", {}), ("int8", {"kv_dtype": "int8"}),
             ("native-eager", {"cuda_graph": False}),
             ("int8-eager", {"kv_dtype": "int8", "cuda_graph": False}))
    moe_serve(report, MOONSHOT, 12, pairs, 153)
    moe_serve(report, ARCTIC, 1, pairs, 154)
    moe_train(report)


def encdec_phase(report) -> None:
    """Phase 16: the K2 layouts, then (a) the fp32 parity checks, (b) the
    bf16 prefill and decode, (c) training."""
    encdec_layouts(report)
    encdec_parity(report)
    encdec_decode(report)
    encdec_train(report)


# ------------------------------------------------------------ phase 17 ----

TRAIN_MESH_SEED, EP_SEED, PP_SEED = 171, 172, 173
TRAIN_MESH_VARIANTS = (("default", {}), ("tp_shardmap", {"tp_shardmap": True}))
TRAIN_MESH_STEPS = 3
#: bf16 gates of phase 17 against the single-rank port: a loss to phase
#: 7's 2e-2 (the kernel path's trajectory against the plain path's), each
#: gradient leaf to phase 6's 2e-2 as a relative L2 error, or to twice the
#: single rank's own bf16 error where that is larger: the relative L2
#: distance between its gradient and the same rank's gradient in fp32
#: compute.  K's gradient through a near-uniform softmax is a small
#: remainder of cancelling terms, so k_norm's scale carries bf16 error of
#: ~2e-2 whichever way the activations round (on an H100 the 2x2 mesh is
#: 2.16e-2 from the single rank in relative L2, and the single rank 2.88e-2
#: from fp32 compute).  A
#: parameter after AdamW is held to 2e-2 of its leaf's largest value but
#: for at most ADAM_OUTLIERS of the leaf's elements, each within two full
#: steps (2 x the summed learning rates; AdamW's two-step |m/sqrt(v)| is at
#: most 1.0003, so the limit is 1.01 of that): AdamW divides by sqrt(v),
#: so where a gradient is at bf16's noise level its step carries that
#: noise, up to a full step of either sign.  The CPU tests allow 1e-3 of a
#: leaf in fp32; bf16's noise is ~2^8 larger, and this phase at the
#: reduced config's widths on the CPU gives 2.8e-3
BF16_GATE = 2e-2
ADAM_OUTLIERS = 1e-2
ADAM_STEPS = 1.01
#: (b)'s fp32 gate: phase 4's relative max error, kernel path against plain
EP_GATE = 1e-3


def _train_mesh_setup():
    """Phase 17 (a)'s workload: full-width qwen3-4b cut to 4 layers, fp32
    parameters and bf16 compute, 4 x 256 tokens, blockwise attention
    (256-row chunks), plain norms, selective remat; warmup 1, so steps 1
    and 2 have lr > 0."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.models import ForwardOpts, LM, make_batch
    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=4)
    assert cfg.dtype == "bfloat16" and cfg.param_dtype == "float32"
    lm = LM(cfg)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=10)
    opts = ForwardOpts(attn_impl="blockwise", norm_impl="plain",
                       mixer_impl="plain", q_chunk=256, kv_chunk=256,
                       remat="selective")
    return lm, tcfg, opts, make_batch(cfg, 4, 256, rng=TRAIN_MESH_SEED)


def _ref_dir(nbytes: int) -> Path:
    """Where the parent leaves a single-rank reference for the rank
    processes to read: host memory (/dev/shm) when it has room for twice
    ``nbytes``, else ``build/`` on disk."""
    import os
    import tempfile
    shm = Path("/dev/shm")
    if shm.is_dir():
        st = os.statvfs(shm)
        if st.f_bavail * st.f_frsize >= 2 * nbytes:
            return Path(tempfile.mkdtemp(prefix="repro_phase17_", dir=shm))
    (ROOT / "build").mkdir(exist_ok=True)
    return Path(tempfile.mkdtemp(prefix="phase17_", dir=ROOT / "build"))


def _save_ref(where: Path, tag: str, tensors) -> None:
    for i, t in enumerate(tensors):
        np.save(where / f"{tag}{i}.npy", t.detach().float().cpu().numpy())


def _ref_shard(where: Path, tag: str, i: int, spec, mesh):
    """This rank's shard of reference leaf ``i``, read from its file (only
    the slice is copied) and put on the card."""
    from repro_torch.parallel.sharding import shard
    arr = np.load(where / f"{tag}{i}.npy", mmap_mode="c")
    return shard(torch.from_numpy(arr), spec, mesh).to(DEV)


def _leaf_rel(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _leaf_l2(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp(min=1e-30))


def _adam_off(a, b, lr_sum: float) -> tuple:
    """(share of elements past BF16_GATE of the leaf's largest value, the
    largest of those differences in units of 2 x ``lr_sum``)."""
    d = (a.detach().float() - b.float()).abs()
    off = d > BF16_GATE * float(b.abs().max())
    worst = float(d[off].max()) / (2 * lr_sum) if bool(off.any()) else 0.0
    return float(off.float().mean()), worst


def _grads_of(lm, state, batch, opts, tcfg, mesh=None, rules=None):
    """Step 0's loss metrics and gradients (this rank's rows and shards
    under a context)."""
    from repro_torch.parallel.sharding import batch_rows
    from repro_torch.train.optimizer import tree_leaves
    leaves = tree_leaves(state["params"])
    for p in leaves:
        p.requires_grad_(True)
    if mesh is not None:
        r = batch_rows(mesh, rules, batch["tokens"].shape[0])
        batch = {k: v[r] for k, v in batch.items()}
    batch = {k: v.to(DEV) for k, v in batch.items()}
    loss, met = lm.loss(state["params"], batch, opts,
                        moe_aux_weight=tcfg.moe_aux_loss, z_loss=tcfg.z_loss)
    grads = torch.autograd.grad(loss, leaves)
    return {k: float(v.detach()) for k, v in met.items()}, grads


def _spawn(flag: str, n: int, env_extra: dict, timeout_s: float = 600.0):
    """``n`` rank processes of this script (``flag R --port P``) on this
    card; returns each rank's RESULT object, failing the phase if any rank
    fails."""
    return _collect(flag, _start(flag, n, env_extra), timeout_s)


def _start(flag: str, n: int, env_extra: dict) -> list:
    """Starts ``n`` processes of this script, ``flag R --port P``."""
    import os
    port = _free_port()
    env = dict(os.environ, **env_extra)
    return [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), flag, str(r),
         "--port", str(port)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=ROOT, env=env)
        for r in range(n)]


def _collect(flag: str, procs: list, timeout_s: float = 600.0) -> list:
    """Each of ``_start``'s processes' RESULT object, failing the phase if
    any fails or outlasts ``timeout_s``; every process is stopped."""
    n = len(procs)
    outs = [""] * n
    try:
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for r, p in enumerate(procs):
            outs[r] = p.communicate()[0]
            for line in outs[r].splitlines():
                if not line.startswith("RESULT "):
                    log(f"[{flag[2:]} {r}] {line}")
    codes = [p.returncode for p in procs]
    assert codes == [0] * n, f"{flag} ranks exited with {codes}"
    return [json.loads(next(l for l in out.splitlines()
                            if l.startswith("RESULT "))[7:]) for out in outs]


def train_mesh(report) -> list:
    """Phase 17 (a) and (d): full-width qwen3-4b cut to 4 layers, trained on
    a 2x2 ``data x model`` mesh of four rank processes of this script
    (``--train-mesh-rank R --port P``) over gloo on this card, with the
    default opts and then ``tp_shardmap=True``, against a single-rank run
    of the port on the same weights and batch; then the int8 gradient sync
    over the four ranks on (a)'s gradients.  Returns (a)'s collectives on
    each rank (the default opts, all steps), for phase 18 (b)."""
    import shutil
    from repro_torch.models import LM
    from repro_torch.models.common import spec_leaves
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.optimizer import tree_leaves
    lm, tcfg, opts, batch = _train_mesh_setup()
    leaf_paths = [path for path, _ in spec_leaves(lm.spec())]
    state = init_train_state(lm, TRAIN_MESH_SEED, tcfg, device=DEV)
    met, grads = _grads_of(lm, state, batch, opts, tcfg)
    # each gradient leaf's own bf16 error: its distance from the step-0
    # gradient in fp32 compute, on the same parameters and batch
    exact = _grads_of(LM(dataclasses.replace(lm.cfg, dtype="float32")),
                      state, batch, opts, tcfg)[1]
    noise = [_leaf_l2(g, e) for g, e in zip(grads, exact)]
    del exact
    step = make_train_step(lm, tcfg, opts)
    losses, times = [met["loss"]], []
    for i in range(TRAIN_MESH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    params = tree_leaves(state["params"])
    state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(
        {"params": state["params"], "opt": state["opt"]}))
    n_elems = sum(t.numel() for t in params)
    where = _ref_dir(8 * n_elems)
    try:
        t0 = time.perf_counter()
        _save_ref(where, "g", grads)
        _save_ref(where, "p", params)
        with open(where / "noise.json", "w") as f:
            json.dump(noise, f)
        log(f"[2x2 train] single-rank reference: losses (step-0 grads, then "
            f"{TRAIN_MESH_STEPS} steps) {losses}, step ms "
            f"{[round(t * 1e3, 1) for t in times]}, train state "
            f"{state_bytes / 2**30:.3f} GiB; written to {where} in "
            f"{time.perf_counter() - t0:.1f}s")
        del state, grads, params, m
        free()
        results = _spawn("--train-mesh-rank", 4,
                         {"REPRO_PHASE17_REF": str(where)})
    finally:
        shutil.rmtree(where, ignore_errors=True)
    n_leaves = len(results[0]["default"]["specs"])
    for variant, _ in TRAIN_MESH_VARIANTS:
        for r, res in enumerate(results):
            v = res[variant]
            rel = max(abs(a - b) / abs(b) for a, b in zip(v["losses"],
                                                           losses))
            want = {"softmax_xent_fwd": TRAIN_MESH_STEPS,
                    "softmax_xent_bwd": TRAIN_MESH_STEPS,
                    "adamw_fused": TRAIN_MESH_STEPS * n_leaves}
            got = {k: n for k, n in v["launches"].items() if n}
            (share, _, path), steps = v["param_off"]
            log(f"[2x2 train {variant} rank {r}] losses {v['losses']} "
                f"(single rank {losses}; worst rel {rel:.3e}, limit "
                f"{BF16_GATE}); step-0 gradient shards: relative L2 error at "
                f"most {v['grad_l2'][0]:.3f} of its leaf's limit "
                f"({v['grad_l2'][3]}: {v['grad_l2'][1]:.3e}, limit "
                f"{v['grad_l2'][2]:.3e}), worst rel max err "
                f"{v['grad_rel'][0]:.3e} "
                f"({v['grad_rel'][1]}); parameters after step "
                f"{TRAIN_MESH_STEPS - 1}: at most {share:.2e} of a leaf past "
                f"{BF16_GATE} of its largest value ({path}; limit "
                f"{ADAM_OUTLIERS}), those within {steps:.3f} x two full steps "
                f"(limit {ADAM_STEPS}); launches {got} (expected {want})")
            assert rel <= BF16_GATE, f"[2x2 {variant}] losses differ"
            assert v["grad_l2"][0] <= 1.0, \
                f"[2x2 {variant}] gradient shards differ"
            assert share <= ADAM_OUTLIERS and steps <= ADAM_STEPS, \
                f"[2x2 {variant}] parameters differ"
            assert got == want, f"[2x2 {variant}] K4/K5 launches differ"
            share = v["coll_s"] / sum(v["step_s"])
            log(f"[2x2 train {variant} rank {r}] step ms "
                f"{[round(t * 1e3, 1) for t in v['step_s']]} (single rank "
                f"{[round(t * 1e3, 1) for t in times]}), collectives "
                f"{v['coll_calls']} a step, {v['coll_bytes'] / 2**20:.1f} MiB "
                f"a step, {share * 100:.1f}% of the steps' host time inside "
                f"them; train state {v['state_bytes'] / 2**30:.3f} GiB "
                f"({v['state_bytes'] / state_bytes:.4f} of the single rank's "
                f"{state_bytes / 2**30:.3f} GiB), peak memory "
                f"{v['peak'] / 2**30:.2f} GiB [{nvidia_smi_line()}]")
    res0 = results[0]["default"]
    log(f"[2x2 train] the single rank's own bf16 gradient error (against "
        f"fp32 compute, relative L2): {max(noise):.3e} at most "
        f"({leaf_paths[int(np.argmax(noise))]}), "
        f"{sum(n > BF16_GATE / 2 for n in noise)} leaves above "
        f"{BF16_GATE / 2}")
    log(f"[2x2 train] leaves whole on every rank: {res0['whole']}; "
        f"leaves a dropped rule replicates: {res0['dropped'] or 'none'}")
    for kernel in ("softmax_xent_fwd", "softmax_xent_bwd", "adamw_fused"):
        report[f"{kernel}[qwen3-4b 2x2 train]"] = {
            "launches": results[0]["default"]["launches"][kernel]}
    gen = torch.Generator().manual_seed(17)
    fwd, bwd = k4_timed(2 * 256, lm.cfg.padded_vocab, gen,
                        " (a 2x2 rank's logit rows)")
    report["softmax_xent_fwd[qwen3-4b 2x2 train]"].update(fwd)
    report["softmax_xent_bwd[qwen3-4b 2x2 train]"].update(bwd)
    report["adamw_fused[qwen3-4b 2x2 train]"].update(
        k5_timed(res0["largest"], gen, " (a 2x2 rank's largest shard)"))
    free()
    for r, res in enumerate(results):
        c = res["compression"]
        log(f"[int8 sync rank {r}] {c['n']} gradient floats over 4 ranks: "
            f"max error against the fp32 mean {c['bucket']:.3f} quantization "
            f"buckets (limit 1); bytes gathered {c['bytes']} (formula: int8 "
            f"sync {c['int8_formula']}, f32 all-reduce {c['f32_formula']}), "
            f"{c['ms']:.1f} ms [{nvidia_smi_line()}]")
        assert c["bucket"] <= 1.0 + 1e-6, "int8 sync leaves its bucket"
    return [r["default"]["coll_kinds"] for r in results]


def _dropped(leaves, specs, rules, mesh) -> list:
    """The leaves with a dim whose rule names an axis of ``mesh`` but that
    stays whole (the dim does not divide, or the axis is taken): the
    replication a dropped rule costs."""
    out = []
    for (path, p), spec in zip(leaves, specs):
        entries = tuple(spec) + (None,) * (len(p.axes) - len(spec))
        for name, entry in zip(p.axes, entries):
            rule = rules.get(name) if name else None
            names = (rule,) if isinstance(rule, str) else (rule or ())
            if entry is None and any(a in mesh.shape for a in names):
                out.append(path)
                break
    return out


def train_mesh_main(rank: int, port: int) -> int:
    """One rank of phase 17 (a) and (d)."""
    import os
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import ops
    from repro_torch.models.common import spec_leaves
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.collectives import CollectiveCounter
    from repro_torch.parallel.compression import (
        init_error_state, make_compressed_grad_sync, wire_bytes_f32_allreduce,
        wire_bytes_int8_sync)
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.roofline.collectives import parse_collectives
    from repro_torch.parallel.sharding import (default_rules,
                                               sharding_context, shard_tree,
                                               spec_for)
    from repro_torch.train import make_train_step
    from repro_torch.train.optimizer import (init_opt_state, lr_schedule,
                                             tree_leaves, tree_map)
    from repro_torch.train.trainer import train_state_specs
    torch.cuda.reset_peak_memory_stats()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4,
                            timeout=timedelta(minutes=10))
    assert torch.cuda.is_available(), "a phase 17 rank found no card"
    where = Path(os.environ["REPRO_PHASE17_REF"])
    mesh = make_mesh((2, 2), ("data", "model"))
    rules = default_rules(mesh.axis_names)
    lm, tcfg, opts, batch = _train_mesh_setup()
    leaves = spec_leaves(lm.spec())
    specs = [spec_for(p.axes, p.shape, rules, mesh) for _, p in leaves]
    shards = shard_tree(lm.init(TRAIN_MESH_SEED, device=DEV,
                                dtype=torch.float32),
                        train_state_specs(lm, mesh, rules)["params"], mesh)
    free()

    with open(where / "noise.json") as f:
        noise = json.load(f)

    def grad_errs(got):
        """(the largest relative L2 error over its leaf's limit, the
        error, the limit, the leaf), then (the largest rel max err, the
        leaf)."""
        refs = [_ref_shard(where, "g", i, s, mesh)
                for i, s in enumerate(specs)]
        l2 = [(e / lim, e, lim, path) for (path, _), e, lim in zip(
            leaves, (_leaf_l2(g, r) for g, r in zip(got, refs)),
            (max(BF16_GATE, 2 * n) for n in noise))]
        return (max(l2), max((_leaf_rel(g, r), path) for (path, _), g, r in
                             zip(leaves, got, refs)))

    lr_sum = sum(lr_schedule(tcfg, i) for i in range(TRAIN_MESH_STEPS))

    def adam(got):
        offs = [(*_adam_off(g, _ref_shard(where, "p", i, s, mesh), lr_sum),
                 path) for i, ((path, _), g, s) in enumerate(zip(
                     leaves, got, specs))]
        return max(offs), max(o[1] for o in offs)

    out, kept = {}, None
    for variant, kw in TRAIN_MESH_VARIANTS:
        params = tree_map(torch.clone, shards)
        state = {"params": params, "opt": init_opt_state(params), "step": 0}
        o = dataclasses.replace(opts, **kw)
        with sharding_context(mesh, rules):
            met, grads = _grads_of(lm, state, batch, o, tcfg, mesh, rules)
            step = make_train_step(lm, tcfg, o)
            ops.reset_launch_counts()
            cc = CollectiveCounter()
            losses, times = [met["loss"]], []
            with cc:
                for _ in range(TRAIN_MESH_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, m = step(state, batch)
                    losses.append(float(m["loss"]))
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
            launches = ops.launch_counts()
        out[variant] = dict(
            losses=losses, step_s=times, launches=launches,
            **dict(zip(("grad_l2", "grad_rel"), grad_errs(grads))),
            param_off=adam(tree_leaves(state["params"])),
            coll_calls=cc.total // TRAIN_MESH_STEPS,
            coll_bytes=cc.bytes // TRAIN_MESH_STEPS, coll_s=cc.seconds,
            # phase 18 (b): every collective of the steps, by kind
            coll_kinds=parse_collectives(cc.records)["per_kind"],
            state_bytes=sum(t.numel() * t.element_size() for t in tree_leaves(
                {"params": state["params"], "opt": state["opt"]})),
            peak=torch.cuda.max_memory_allocated(),
            specs=[str(s) for s in specs],
            whole=sum(1 for s in specs if not s),
            dropped=_dropped(leaves, specs, rules, mesh),
            largest=max(t.numel() for t in tree_leaves(shards)))
        if kept is None:
            kept = [g.detach() for g in grads]
        del state, grads
        free()
    # (d) the int8 sync over the four ranks, each with its gradient tree
    m4 = make_mesh((4,), ("data",))
    sync = make_compressed_grad_sync(m4, "data")
    tree = {path: g for (path, _), g in zip(leaves, kept)}
    cc = CollectiveCounter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with cc:
        mean, _ = sync(tree, init_error_state(tree))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    bucket = 0.0
    for path, g in tree.items():
        q = mean[path]
        exact = coll.all_reduce(g, m4.group("data")) / 4
        amax = torch.tensor([float(g.abs().max())])
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=m4.group("data"))
        scale = max(float(amax[0]), 1e-12) / 127
        bucket = max(bucket, float((q - exact).abs().max()) / scale)
    n = sum(g.numel() for g in kept)
    out["compression"] = dict(
        n=n, bucket=bucket, bytes=cc.bytes, ms=ms,
        int8_formula=wire_bytes_int8_sync(n, 4),
        f32_formula=wire_bytes_f32_allreduce(n))
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


def ep_pp(report) -> None:
    """Phase 17 (b) and (c), on two rank processes of this script
    (``--train-mesh-pair R --port P``) over gloo on this card: (b)
    moonshot-v1-16b-a3b at full width cut to 2 layers on a 1x2 mesh with
    ``moe_ep=True`` (32 experts a rank), 4 x 256 tokens, in fp32: step 0's
    loss and gradients against the port's own MoE with one capacity group
    per rank (``moe_ffn(groups=2)``, the per-device capacity that expert
    parallelism counts) to phase 4's fp32 1e-3, then two steps.  fp32,
    because a router decision is discontinuous: in bf16 the split
    attention's rounding moves near-tied tokens to other experts, which
    moves whole tokens' gradients (at the reduced config's widths on the
    CPU, 16% on an expert leaf); (c) ``build_pp_forward`` over 2 stages on
    qwen3-4b cut to 4 layers at full width in fp32 against
    ``LM.forward``."""
    import shutil
    from functools import partial
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.models import ForwardOpts, LM, make_batch
    from repro_torch.models import moe as moe_mod
    del report
    cfg = dataclasses.replace(get_config(MOONSHOT), num_layers=2,
                              dtype="float32")
    lm = LM(cfg)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=10)
    opts = ForwardOpts(attn_impl="blockwise", norm_impl="plain",
                       mixer_impl="plain", q_chunk=256, kv_chunk=256,
                       remat="selective")
    batch = make_batch(cfg, 4, 256, rng=EP_SEED)
    params = lm.init(EP_SEED, device=DEV, dtype=torch.float32)
    state = {"params": params, "opt": {}, "step": 0}
    with _patched(moe_mod, "moe_ffn", partial(moe_mod.moe_ffn, groups=2)):
        met, grads = _grads_of(lm, state, batch, opts, tcfg)
    n_elems = sum(g.numel() for g in grads)
    where = _ref_dir(4 * n_elems)
    try:
        _save_ref(where, "g", grads)
        del params, state, grads
        free()
        with open(where / "loss.json", "w") as f:
            json.dump(met, f)
        log(f"[ep] reference (one capacity group a rank): loss "
            f"{met['loss']:.6f}, moe_aux {met['moe_aux']:.6f}")
        results = _spawn("--train-mesh-pair", 2,
                         {"REPRO_PHASE17_REF": str(where)})
    finally:
        shutil.rmtree(where, ignore_errors=True)
    for r, res in enumerate(results):
        e = res["ep"]
        rel = abs(e["loss"] - met["loss"]) / abs(met["loss"])
        log(f"[ep rank {r}] step-0 loss {e['loss']:.6f} (reference "
            f"{met['loss']:.6f}, rel {rel:.3e}, limit {EP_GATE}), worst "
            f"gradient shard rel max err {e['grad_rel'][0]:.3e} "
            f"({e['grad_rel'][1]}; limit {EP_GATE}); steps' losses "
            f"{e['losses']}; all_to_all {e['a2a_bytes']} bytes a layer "
            f"(forward, both hops: the slot buffers {e['slot_bytes']}; "
            f"epmoe's formula {e['wire_bytes']}), step ms "
            f"{[round(t * 1e3, 1) for t in e['step_s']]}, peak "
            f"{e['peak'] / 2**30:.2f} GiB [{nvidia_smi_line()}]")
        assert rel <= EP_GATE, "[ep] the loss differs from the reference"
        assert e["grad_rel"][0] <= EP_GATE, "[ep] gradients differ"
        assert all(np.isfinite(e["losses"])), "[ep] a loss is not finite"
        assert e["a2a_bytes"] == e["slot_bytes"], "[ep] a2a bytes"
        p = res["pp"]
        log(f"[pp rank {r}] 2 stages x 2 microbatches, logits against "
            f"LM.forward: rel max err {p['rel']:.3e} (limit 1e-3); "
            f"pipelined forward {p['ms']:.1f} ms, LM.forward {p['ref_ms']:.1f} "
            f"ms [{nvidia_smi_line()}]")
        assert p["rel"] <= 1e-3, "[pp] the pipelined forward differs"


def train_mesh_pair_main(rank: int, port: int) -> int:
    """One rank of phase 17 (b) and (c)."""
    import os
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.launch.pp_dryrun import build_pp_forward
    from repro_torch.models import ForwardOpts, LM, make_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import spec_leaves
    from repro_torch.parallel.collectives import CollectiveCounter
    from repro_torch.parallel.epmoe import slot_bytes, wire_bytes
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.parallel.sharding import (default_rules,
                                               sharding_context, shard_tree,
                                               spec_for)
    from repro_torch.train import make_train_step
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import train_state_specs
    torch.cuda.reset_peak_memory_stats()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2,
                            timeout=timedelta(minutes=10))
    assert torch.cuda.is_available(), "a phase 17 rank found no card"
    where = Path(os.environ["REPRO_PHASE17_REF"])
    out = {}
    # (b) expert parallel
    mesh = make_mesh((1, 2), ("data", "model"))
    rules = default_rules(mesh.axis_names)
    cfg = dataclasses.replace(get_config(MOONSHOT), num_layers=2,
                              dtype="float32")
    lm = LM(cfg)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=10)
    opts = ForwardOpts(attn_impl="blockwise", norm_impl="plain",
                       mixer_impl="plain", q_chunk=256, kv_chunk=256,
                       remat="selective", moe_ep=True)
    batch = make_batch(cfg, 4, 256, rng=EP_SEED)
    leaves = spec_leaves(lm.spec())
    specs = [spec_for(p.axes, p.shape, rules, mesh) for _, p in leaves]
    params = shard_tree(lm.init(EP_SEED, device=DEV, dtype=torch.float32),
                        train_state_specs(lm, mesh, rules)["params"], mesh)
    free()
    state = {"params": params, "opt": init_opt_state(params), "step": 0}
    cc = CollectiveCounter()
    with sharding_context(mesh, rules):
        with cc:
            met, grads = _grads_of(lm, state, batch, opts, tcfg, mesh, rules)
        errs = [(_leaf_rel(g, _ref_shard(where, "g", i, s, mesh)), path)
                for i, ((path, _), g, s) in enumerate(zip(leaves, grads,
                                                          specs))]
        del grads
        step = make_train_step(lm, tcfg, opts)
        losses, times = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    tokens = 4 * 256 // 2
    itemsize = 4                     # fp32 slots
    out["ep"] = dict(
        loss=met["loss"], grad_rel=max(errs), losses=losses, step_s=times,
        # fwd and bwd each run both hops of every layer
        a2a_bytes=cc.bytes_by.get("all_to_all_single", 0) // (
            2 * cfg.num_layers),
        slot_bytes=slot_bytes(cfg, tokens, itemsize),
        wire_bytes=wire_bytes(cfg, tokens, itemsize),
        peak=torch.cuda.max_memory_allocated())
    del state, params, m
    free()
    # (c) the pipelined forward
    pm = make_mesh((2, 1), ("pod", "data"))
    prules = default_rules(pm.axis_names)
    prules["batch"] = ("data",)
    qcfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=4,
                               dtype="float32")
    qlm = LM(qcfg)
    qp = qlm.init(PP_SEED, device=DEV, dtype=torch.float32)
    popts = ForwardOpts(attn_impl="blockwise", norm_impl="plain",
                        q_chunk=256, kv_chunk=256, remat="none")
    toks = make_batch(qcfg, 4, 256, rng=PP_SEED)["tokens"].to(DEV)
    s = pm.coords["pod"]
    stage = dict(qp, layers=tfm.layer_params(qp, slice(2 * s, 2 * s + 2)))
    fwd = build_pp_forward(qlm, qcfg, pm, prules, popts, 2)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref, _ = qlm.forward(qp, toks, popts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = fwd(stage, toks)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    out["pp"] = dict(rel=_leaf_rel(got, ref), ms=(t2 - t1) * 1e3,
                     ref_ms=(t1 - t0) * 1e3)
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


def train_mesh_phase(report) -> list:
    """Phase 17: (a) and (d) on four ranks, (b) and (c) on two.  Returns
    (a)'s collectives on each rank."""
    kinds = train_mesh(report)
    free()
    ep_pp(report)
    free()
    return kinds


# ------------------------------------------------------------ phase 18 ----

DECODE_MESH_SEED = 18
DECODE_MESH_STEPS = 8
#: the fp32-compute run of (c) shows the split exact; two steps do that
DECODE_FP32_STEPS = 2
#: (c)'s decode: qwen3-4b cut to 4 layers, B slots over a dense cache
DECODE_B, DECODE_S = 8, 1024
#: (a)'s gate on the card's peak memory against the dry-run's prediction
PEAK_GATE = 0.25


def _decode_mesh_setup(device):
    """Phase 18 (c)'s model and inputs on ``device`` ("meta": their meta
    stand-ins): full-width qwen3-4b cut to 4 layers, bf16, the dense
    cache of DECODE_B slots x DECODE_S rows filled from a seed, each
    step's tokens, and slot positions spread over the cache."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=4)
    lm = LM(cfg)
    cache = lm.init_cache(DECODE_B, DECODE_S, backend=None, device=device)
    if device == "meta":
        return lm, cache, None, None
    gen = torch.Generator(device=device).manual_seed(DECODE_MESH_SEED)
    for t in cache["layers"].values():
        t.normal_(generator=gen)
    toks = torch.randint(0, cfg.vocab_size,
                         (DECODE_MESH_STEPS, DECODE_B, 1), generator=gen,
                         device=device, dtype=torch.int32)
    pos = torch.tensor([100, 231, 362, 493, 624, 755, 886, 1000],
                       dtype=torch.int32, device=device)
    return lm, cache, toks, pos


def dryrun_rank_main(rank: int, port: int) -> int:
    """One rank of phase 18 (b) and (c)'s dry-runs, on a fake group of four
    ranks and no card: the collectives of phase 17 (a)'s train step and of
    (c)'s decode step on this rank of the 2x2 mesh."""
    del port
    from repro_torch.launch.dryrun import dryrun_step, init_fake_group
    from repro_torch.models import ForwardOpts
    from repro_torch.models.common import abstract_params
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.parallel.sharding import default_rules
    init_fake_group(4, rank)
    mesh = make_mesh((2, 2), ("data", "model"))
    rules = default_rules(mesh.axis_names)
    lm, tcfg, opts, batch = _train_mesh_setup()
    meta = {k: torch.empty(tuple(v.shape), dtype=v.dtype, device="meta")
            for k, v in batch.items()}
    t0 = time.perf_counter()
    train = dryrun_step(lm, "train", meta, mesh, rules, opts, tcfg)
    dlm, cache, _, _ = _decode_mesh_setup("meta")
    dmeta = {"tokens": torch.empty((DECODE_B, 1), dtype=torch.int32,
                                   device="meta"),
             "cache": cache,
             "cache_index": torch.empty((), dtype=torch.int32,
                                        device="meta")}
    decode = dryrun_step(dlm, "decode", dmeta, mesh, rules, ForwardOpts(),
                         params=abstract_params(dlm.spec(), torch.bfloat16))
    print("RESULT " + json.dumps({
        "train": train["collectives"]["per_kind"],
        "decode": decode["collectives"]["per_kind"],
        "decode_kernels": decode["kernels"],
        "s": time.perf_counter() - t0}), flush=True)
    return 0


def decode_mesh_main(rank: int, port: int) -> int:
    """One rank of phase 18 (c): the sharded dense-cache decode step on a
    2x2 ``data x model`` mesh over gloo on this card, against the single
    rank on the same weights, cache and tokens, in bf16 (counted) and in
    fp32 compute."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.parallel.collectives import CollectiveCounter
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.parallel.sharding import (default_rules,
                                               logical_to_sharding,
                                               sharding_context, shard_tree)
    from repro_torch.roofline.collectives import parse_collectives
    torch.cuda.reset_peak_memory_stats()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4,
                            timeout=timedelta(minutes=10))
    assert torch.cuda.is_available(), "a phase 18 rank found no card"
    mesh = make_mesh((2, 2), ("data", "model"))
    rules = default_rules(mesh.axis_names)
    lm, cache, toks, pos = _decode_mesh_setup(DEV)
    # the same weights, cache and tokens in fp32 compute: the single rank's
    # own bf16 error, and the split's exactness without bf16's rounding
    lm32 = LM(dataclasses.replace(lm.cfg, dtype="float32"))
    cache32 = {"layers": {k: v.float() for k, v in cache["layers"].items()}}
    params = lm.init(DECODE_MESH_SEED, device=DEV)

    def single(model, c, steps):
        c = {"layers": {k: v.clone() for k, v in c["layers"].items()}}
        with torch.no_grad():
            return [model.decode_step(params, toks[i], c, pos + i)[0]
                    for i in range(steps)]

    ref = single(lm, cache, DECODE_MESH_STEPS)
    ref32 = single(lm32, cache32, DECODE_MESH_STEPS)
    sp = shard_tree(params, logical_to_sharding(
        lm.param_logical_axes(), params, mesh, rules), mesh)
    sc, sc32 = (lm.shard_cache(c, mesh, rules) for c in (cache, cache32))
    del params, cache, cache32
    free()
    ops.reset_launch_counts()
    cc = CollectiveCounter()
    got, times = [], []
    with torch.no_grad(), sharding_context(mesh, rules), cc:
        for i in range(DECODE_MESH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got.append(lm.decode_step(sp, toks[i], sc, pos + i)[0])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    launches = ops.launch_counts()
    with torch.no_grad(), sharding_context(mesh, rules):
        got32 = [lm32.decode_step(sp, toks[i], sc32, pos + i)[0]
                 for i in range(DECODE_FP32_STEPS)]

    def worst(fn, a, b):
        return max(fn(x, y) for x, y in zip(a, b))

    out = dict(rel=worst(_leaf_rel, got, ref),
               l2=worst(_leaf_l2, got, ref),
               noise=worst(_leaf_l2, ref, ref32),
               rel32=worst(_leaf_rel, got32, ref32),
               shape=list(got[0].shape), step_s=times, launches=launches,
               kinds=parse_collectives(cc.records)["per_kind"],
               coll_s=cc.seconds, peak=torch.cuda.max_memory_allocated(),
               cache_shard=list(sc["layers"]["k"].shape))
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


def _times(kinds: dict, n: int) -> dict:
    return {k: {"count": v["count"] * n, "bytes": v["bytes"] * n}
            for k, v in kinds.items()}


def dryrun_phase(p7: dict, p17: list) -> None:
    """Phase 18: does the dry-run predict the port's real steps on this
    card?  (a) phase 7's counted step against its dry-run on one rank, (b)
    phase 17 (a)'s 2x2 collectives against each rank's dry-run, (c) the
    sharded dense-cache decode on 2x2 ranks against the single rank and
    its dry-run, (d) the command line on a full-size cell.  ``p7`` is
    ``train_run``'s counted step, ``p17`` phase 17 (a)'s collectives on
    each rank."""
    import os
    from repro_torch.launch.dryrun import dryrun_step
    from repro_torch.roofline.analysis import Roofline
    cpu_only = {"CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(ROOT / "src")}
    dry_procs = _start("--dryrun-rank", 4, cpu_only)
    out_dir = ROOT / "build" / "dryrun_torch"
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-4b", "--shape", "decode_32k", "--out-dir", str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT, env=dict(os.environ, **cpu_only))
    try:
        # (a) phase 7's step: the card's counts against the dry-run's
        meta = {k: torch.empty(shape, dtype=dt, device="meta")
                for k, (shape, dt) in p7["batch"].items()}
        t0 = time.perf_counter()
        rec = dryrun_step(p7["lm"], "train", meta, None, None, p7["opts"],
                          p7["tcfg"])
        dry_s = time.perf_counter() - t0
        card = p7["aten_flops"] + p7["kernel_flops"]
        ca, ma = rec["cost_analysis"], rec["memory_analysis"]
        peak, want = p7["peak"], ma["peak_size_in_bytes"]
        off = abs(peak - want) / want
        log(f"(a) phase 7's step (qwen3-4b at 12 layers, 8 x 256): FLOPs on "
            f"the card {p7['aten_flops']} (FlopCounterMode) + {p7['kernel_flops']} "
            f"(K4, K5) = {card}; dry-run on one rank {int(ca['aten_flops'])} + "
            f"{int(ca['kernel_flops'])} = {int(ca['flops'])} "
            f"({dry_s:.1f}s on meta tensors); kernels on the card "
            f"{ {k: v['launches'] for k, v in p7['kernels'].items()} }, "
            f"dry-run { {k: v['launches'] for k, v in rec['kernels'].items()} }")
        log(f"(a) peak memory: card {peak / 2**30:.3f} GiB "
            f"(max_memory_allocated over the step, {p7['before'] / 2**30:.3f} "
            f"GiB allocated before it), dry-run {want / 2**30:.3f} GiB "
            f"(arguments {ma['argument_size_in_bytes'] / 2**30:.3f} + temps "
            f"{ma['temp_size_in_bytes'] / 2**30:.3f}); off by {off * 100:.1f}% "
            f"(limit {PEAK_GATE * 100:.0f}%)")
        failed = [m for ok, m in (
            (card == ca["flops"], "(a) the dry-run's FLOPs are not the card's"),
            (off <= PEAK_GATE, "(a) the dry-run's peak memory misses the "
                               "card's")) if not ok]
        r = Roofline("qwen3-4b[12 layers]", "train 8x256", "1x1", 1,
                     ca["flops"], ca["bytes accessed"], 0.0,
                     p7["model_flops"], 8 * 256,
                     fp32_flops=ca["flops_by_dtype"].get("float32", 0.0))
        step_s = p7["step_ms"] / 1e3
        log(f"(a) H100 roofline of the step: compute {r.compute_s * 1e3:.3f} ms "
            f"({ca['flops_by_dtype']}), memory {r.memory_s * 1e3:.3f} ms "
            f"({int(ca['bytes accessed'])} B accessed), bound "
            f"{r.bound_s * 1e3:.3f} ms ({r.dominant}); measured step "
            f"{p7['step_ms']:.2f} ms (phase 7's mean), {r.bound_s / step_s * 100:.1f}% "
            f"of it the bound; MFU "
            f"{p7['model_flops'] / step_s / BF16_PEAK * 100:.2f}% "
            f"(at the bound {r.mfu_bound * 100:.2f}%) [{nvidia_smi_line()}]")
        # (c) the sharded decode on four rank processes
        t0 = time.perf_counter()
        dec = _spawn("--decode-mesh-rank", 4, {})
        dec_s = time.perf_counter() - t0
        dry = _collect("--dryrun-rank", dry_procs)
        cli_out = cli.communicate(timeout=300)[0]
    finally:
        for p in dry_procs + [cli]:
            if p.poll() is None:
                p.kill()
                p.wait()
    # (b) phase 17 (a)'s collectives on every rank: 3 steps of the dry-run's
    for r, (real, d) in enumerate(zip(p17, dry)):
        log(f"(b) rank {r}: phase 17 (a)'s {TRAIN_MESH_STEPS} steps {real}; "
            f"dry-run x {TRAIN_MESH_STEPS} {_times(d['train'], TRAIN_MESH_STEPS)}")
        if real != _times(d["train"], TRAIN_MESH_STEPS):
            failed.append(f"(b) rank {r}: the dry-run's collectives are not "
                          "the card's")
    for r, (res, d) in enumerate(zip(dec, dry)):
        k3 = res["launches"]["rmsnorm_rows"]
        want_k3 = DECODE_MESH_STEPS * d["decode_kernels"]["rmsnorm_rows"][
            "launches"]
        lim = max(BF16_GATE, 2 * res["noise"])
        log(f"(c) rank {r}: logits {res['shape']} against the single rank: "
            f"relative L2 error {res['l2']:.3e} (limit {lim:.3e}: {BF16_GATE} "
            f"or twice the single rank's own bf16 error against fp32 "
            f"compute, {res['noise']:.3e}), rel max err {res['rel']:.3e}; "
            f"in fp32 compute rel max err {res['rel32']:.3e} (limit "
            f"{EP_GATE}); cache shard "
            f"{res['cache_shard']}; K3 launches {k3} (dry-run {want_k3}); "
            f"step ms {[round(t * 1e3, 1) for t in res['step_s']]}, "
            f"{res['coll_s'] / sum(res['step_s']) * 100:.1f}% of it in "
            f"collectives; collectives {res['kinds']}, dry-run x "
            f"{DECODE_MESH_STEPS} {_times(d['decode'], DECODE_MESH_STEPS)}; "
            f"peak {res['peak'] / 2**30:.2f} GiB [{nvidia_smi_line()}]")
        failed += [m for ok, m in (
            (res["l2"] <= lim, f"(c) rank {r}: bf16 logits differ"),
            (res["rel32"] <= EP_GATE, f"(c) rank {r}: fp32 logits differ"),
            (k3 == want_k3 == DECODE_MESH_STEPS * 17,
             f"(c) rank {r}: K3 launches"),
            (res["kinds"] == _times(d["decode"], DECODE_MESH_STEPS),
             f"(c) rank {r}: the dry-run's collectives are not the card's"))
            if not ok]
    log(f"(c) 2x2 decode ranks took {dec_s:.1f}s; the four dry-run ranks "
        f"{max(d['s'] for d in dry):.1f}s each at most")
    # (d) the command line on a full-size cell under this machine's torch
    for line in cli_out.splitlines():
        log(f"(d) {line}")
    path = out_dir / "pod16x16" / "qwen3-4b__decode_32k.json"
    rec = json.loads(path.read_text()) if path.exists() else {}
    if cli.returncode != 0 or not rec.get("ok"):
        failed.append("(d) the dry-run CLI failed")
        rec = {"cost_analysis": {"flops": 0}, "dryrun_s": None,
               "collectives": {"total_bytes": 0},
               "memory_analysis": {"peak_size_in_bytes": 0}}
    log(f"(d) qwen3-4b x decode_32k on 256 fake ranks under torch "
        f"{torch.__version__}: {rec['cost_analysis']['flops']:.4g} FLOPs, "
        f"{rec['collectives']['total_bytes']:.4g} collective bytes, "
        f"{rec['memory_analysis']['peak_size_in_bytes'] / 2**30:.2f} GiB peak "
        f"a rank, in {rec['dryrun_s']}s")
    assert not failed, failed


# ------------------------------------------------------------ phase 19 ----

TP_SEED = 19
TP_STEPS = 3
TP_DECODE_STEPS = 8
#: the fp32-compute run of (c) shows the split exact; two steps do that
TP_FP32_STEPS = 2
TP_DECODE_B, TP_DECODE_S = 4, 256
TP_POSITIONS = (17, 100, 180, 240)
#: phase 19's families at full width and cut depth (zamba2's shared block
#: fires once in 6 layers), each with its train batch (B, S)
TP_FAMILIES = (("zamba2-1.2b", {"num_layers": 6}, (2, 256)),
               ("rwkv6-1.6b", {"num_layers": 4}, (2, 128)),
               (SEAMLESS, {"num_layers": 2, "encoder_layers": 2}, (2, 64)))
#: the ops wrappers whose launches phase 19 captures on each rank's heads
TP_OPS = {"mamba2_ssd": "ssd_scan_bhsd", "rwkv6_wkv": "wkv6_scan_bhsd",
          "flash_attention": "flash_attention_bhsd"}


def _exact_frac(a, b) -> float:
    """The fp32 split's gradient leaf ``a`` against the single rank's ``b``
    as a share of its limit: relative L2 EP_GATE, with the CPU tests'
    per-element atol of 1e-6 (GRAD's) as a floor, for the leaves whose
    gradient is zero up to rounding (softmax makes K's bias gradient
    zero)."""
    a, b = a.detach().float(), b.detach().float()
    return float(torch.linalg.vector_norm(a - b) / (
        EP_GATE * torch.linalg.vector_norm(b) + 1e-6 * b.numel() ** 0.5))


def _tp_setup(name, kw, bs):
    """A phase 19 family: fp32 parameters and bf16 compute, the train
    step's plain forms (blockwise attention in 256-row chunks, plain norms
    and mixers, selective remat), warmup 1, a batch from TP_SEED."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.models import ForwardOpts, LM, make_batch
    cfg = dataclasses.replace(get_config(name), **kw)
    assert cfg.dtype == "bfloat16" and cfg.param_dtype == "float32"
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=10)
    opts = ForwardOpts(attn_impl="blockwise", norm_impl="plain",
                       mixer_impl="plain", q_chunk=256, kv_chunk=256,
                       remat="selective")
    return LM(cfg), tcfg, opts, make_batch(cfg, *bs, rng=TP_SEED)


def _tp_redraw(lm, params) -> None:
    """Every leaf that init sets to zeros or ones (biases, LayerNorms,
    rwkv6's mixing coefficients, mamba2's D), drawn around that value from
    TP_SEED, in place: a zero bias hides a dropped one, and AdamW's step on
    a leaf whose gradient is rounding noise (softmax makes K's bias
    gradient zero) is past any gate relative to a zero leaf."""
    from repro_torch.models.common import spec_leaves
    gen = torch.Generator(device=DEV).manual_seed(TP_SEED)
    for path, p in spec_leaves(lm.spec()):
        if p.init in ("zeros", "ones"):
            *parents, last = path.split("/")
            node = params
            for k in parents:
                node = node[k]
            node[last] = float(p.init == "ones") + 0.2 * torch.randn(
                p.shape, generator=gen, device=DEV)


def _tp_expected(cfg) -> dict:
    """Each kernel's launches in one bf16 forward of ``cfg`` on the kernel
    path under a model split: K6 or K7 a layer, K2 each attention (not the
    plain cross-attention), K3 each RMSNorm but mamba2's gated one, which
    is split (``tpmm.split_rms_norm``)."""
    if cfg.family == "hybrid":
        shared = cfg.num_layers // cfg.hybrid_attn_every
        return {"ssd_scan_bhsd": cfg.num_layers,
                "flash_attention_bhsd": shared,
                "rmsnorm_rows": cfg.num_layers + 2 * shared + 1}
    if cfg.family == "ssm":
        return {"wkv6_scan_bhsd": cfg.num_layers}
    return {"flash_attention_bhsd": cfg.encoder_layers + cfg.num_layers}


def _tp_entry(cfg, fn, args, kw) -> str:
    """The ``kernels`` line's name of a launch on this rank's heads."""
    where = f"{cfg.name} model split 1x2"
    if fn == "flash_attention":
        _, _, kv, g, d = args[0].shape
        return (f"flash_attention_bhsd[{where}: {kv * g} of {cfg.num_heads} "
                f"heads, KV={kv},G={g},D={d}"
                f"{'' if kw.get('causal', True) else ',non-causal'}]")
    if fn == "mamba2_ssd":
        b, s, h, pd = args[0].shape
        return (f"ssd_scan_bhsd[{where}: {h} of {cfg.ssm_heads} heads, "
                f"P={pd},N={args[2].shape[-1]}]")
    b, s, h, kd = args[0].shape
    return (f"wkv6_scan_bhsd[{where}: {h} of {cfg.rwkv_heads} heads, "
            f"K=V={kd}]")


def _tp_kernel(fn, real, args, kw, timed: bool) -> dict:
    """A launch captured on this rank's heads, run again on the same
    inputs and held to its plain version; with ``timed``, the kernel, its
    plain version and (K2) SDPA timed on them, beside the bound."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import rwkv6_wkv as wkv
    if fn == "flash_attention":
        q, k, v = args
        causal = kw.get("causal", True)

        def plain():
            return model_ref(fa, q, k, v, causal)
        work = rk.flash_attention(q, k, causal)
    elif fn == "mamba2_ssd":
        x, da, bm, cm = args
        b, s, h, _ = x.shape

        def plain():
            return ssd.ssd_scan_ref(
                fold(x), da.transpose(1, 2).reshape(b * h, s), bm, cm,
                chunk=kw["chunk"]).unflatten(0, (b, h)).transpose(1, 2)
        work = rk.ssd_scan(*args)
    else:
        b, s, h, _ = args[0].shape

        def plain():
            return wkv.wkv6_scan_ref(
                *[fold(t) for t in args[:4]], args[4],
                chunk=kw["chunk"]).unflatten(0, (b, h)).transpose(1, 2)
        work = rk.wkv6_scan(*args)
    ref = plain()
    err = max_err(real(*args, **kw), ref)
    out = dict(max_abs_err=err, rel=err / float(ref.abs().max()),
               shapes=[list(t.shape) for t in args])
    if not timed:
        return out
    lib_ms = None
    if fn == "flash_attention":
        b, s, kv, g, d = q.shape
        qh = q.permute(0, 2, 3, 1, 4).reshape(b, kv * g, s, d).contiguous()
        kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (k, v))
        lib_ms = time_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(
                             qh, kh, vh, is_causal=causal,
                             enable_gqa=g > 1))
    bms, by = work.bound()
    return dict(out, ms=time_ms(lambda: real(*args, **kw)),
                plain_ms=time_ms(plain, iters=5), bound_ms=bms, bound_by=by,
                library_ms=lib_ms)


def _tp_family(name, kw, bs, mesh, rules, rank) -> dict:
    """One family of phase 19 on this rank: the single rank's references
    on the card (each rank computes them and keeps its shards), then (a)
    the bf16 forward on the kernel path, (b) the train steps, (c) the
    dense-cache decode, on the 1x2 mesh."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.models import ForwardOpts, LM
    from repro_torch.models.common import spec_leaves
    from repro_torch.parallel.collectives import CollectiveCounter
    from repro_torch.parallel.sharding import (sharding_context, shard,
                                               shard_tree, spec_for)
    from repro_torch.train import make_train_step
    from repro_torch.train.optimizer import (init_opt_state, lr_schedule,
                                             tree_leaves, tree_map)
    from repro_torch.train.trainer import train_state_specs
    lm, tcfg, opts, batch = _tp_setup(name, kw, bs)
    cfg = lm.cfg
    lm32 = LM(dataclasses.replace(cfg, dtype="float32"))
    leaves = spec_leaves(lm.spec())
    specs = [spec_for(p.axes, p.shape, rules, mesh) for _, p in leaves]
    params = lm.init(TP_SEED, device=DEV, dtype=torch.float32)
    _tp_redraw(lm, params)
    toks = batch["tokens"].to(DEV)
    enc = batch["enc_embeds"].to(DEV) if "enc_embeds" in batch else None
    fwd = ForwardOpts()
    t_ref = time.perf_counter()
    # the single rank: (a)'s logits, bf16 and fp32 compute
    with torch.no_grad():
        ref = lm.forward(params, toks, fwd, enc_embeds=enc)[0]
        noise_a = _leaf_l2(ref, lm32.forward(params, toks, fwd,
                                             enc_embeds=enc)[0])
    # (b)'s step-0 gradients (bf16, and fp32 compute for each leaf's own
    # bf16 error) and parameters after the steps, as this rank's shards
    state = {"params": tree_map(torch.clone, params),
             "opt": init_opt_state(params), "step": 0}
    met, grads = _grads_of(lm, state, batch, opts, tcfg)
    exact = _grads_of(lm32, state, batch, opts, tcfg)[1]
    noise = [_leaf_l2(g, e) for g, e in zip(grads, exact)]
    grads, exact = ([shard(g, sp, mesh) for g, sp in zip(t, specs)]
                    for t in (grads, exact))
    step = make_train_step(lm, tcfg, opts)
    losses = [met["loss"]]
    for _ in range(TP_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    ref_params = [shard(t, sp, mesh)
                  for t, sp in zip(tree_leaves(state["params"]), specs)]
    del state, m
    free()
    # (c)'s decode over a dense cache drawn from TP_SEED
    cache = lm.init_cache(TP_DECODE_B, TP_DECODE_S, backend=None, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(TP_SEED)
    for t in _leaves(cache):
        t.normal_(generator=gen)
    dtoks = torch.randint(0, cfg.vocab_size, (TP_DECODE_STEPS,
                                              TP_DECODE_B, 1),
                          generator=gen, device=DEV, dtype=torch.int32)
    pos = torch.tensor(TP_POSITIONS, dtype=torch.int32, device=DEV)
    cache32 = tree_map(lambda t: t.float(), cache)

    def single(model, c, steps):
        c = tree_map(torch.clone, c)
        with torch.no_grad():
            return [model.decode_step(params, dtoks[i], c, pos + i)[0]
                    for i in range(steps)]

    dref, dref32 = (single(lm, cache, TP_DECODE_STEPS),
                    single(lm32, cache32, TP_DECODE_STEPS))
    dnoise = max(_leaf_l2(a, b) for a, b in zip(dref, dref32))
    ref_s = time.perf_counter() - t_ref
    shards = shard_tree(params, train_state_specs(lm, mesh, rules)["params"],
                        mesh)
    del params
    free()
    out = dict(ref_s=ref_s)

    # (a) the bf16 forward on the kernel path, each launch captured
    captured, calls = {}, {}

    def capturing(fn, real):
        def run(*args, **kwargs):
            key = (fn, kwargs.get("causal", True))
            captured.setdefault(key, (args, kwargs))
            calls[key] = calls.get(key, 0) + 1
            return real(*args, **kwargs)
        return run

    reals = {fn: getattr(ops, fn) for fn in TP_OPS}
    ops.reset_launch_counts()
    with contextlib.ExitStack() as stack, torch.no_grad(), \
            sharding_context(mesh, rules):
        for fn, real in reals.items():
            stack.enter_context(_patched(ops, fn, capturing(fn, real)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = lm.forward(shards, toks, fwd, enc_embeds=enc)[0]
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    launches = {k: n for k, n in ops.launch_counts().items() if n}
    kernels = {}
    for (fn, causal), (args, kwargs) in sorted(captured.items()):
        dist.barrier()            # rank 0 times with the card to itself
        entry = _tp_entry(cfg, fn, args, kwargs)
        kernels[entry] = dict(
            _tp_kernel(fn, reals[fn], args, kwargs, timed=rank == 0),
            launches=calls[(fn, causal)])
        dist.barrier()
    per_kernel = {}
    for (fn, _), n in calls.items():
        per_kernel[TP_OPS[fn]] = per_kernel.get(TP_OPS[fn], 0) + n
    out["a"] = dict(l2=_leaf_l2(got, ref), rel=_leaf_rel(got, ref),
                    noise=noise_a, shape=list(got.shape), launches=launches,
                    expected=_tp_expected(cfg), calls=per_kernel,
                    kernels=kernels, ms=fwd_s * 1e3)
    del got, ref, captured
    free()

    # (b) the train steps on the mesh
    sp = tree_map(torch.clone, shards)
    state = {"params": sp, "opt": init_opt_state(sp), "step": 0}
    lr_sum = sum(lr_schedule(tcfg, i) for i in range(TP_STEPS))
    with sharding_context(mesh, rules):
        met, got = _grads_of(lm, state, batch, opts, tcfg, mesh, rules)
        # phase 17's reading: the split's bf16 gradient against the single
        # rank's, each leaf to 2e-2 or twice the single rank's own bf16
        # error (against fp32 compute).  Printed; where that error passes
        # ~50% (rwkv6's u: 104% at full width) the single rank's bf16
        # gradient is rounding noise, and the distance between two noise
        # samples bounds nothing
        p17 = max((e / max(BF16_GATE, 2 * n), e, max(BF16_GATE, 2 * n), path)
                  for (path, _), e, n in zip(
                      leaves, (_leaf_l2(g, r) for g, r in zip(got, grads)),
                      noise))
        # the gate: the split's bf16 gradient against fp32 compute (the
        # single rank's, on this rank's shard), each leaf to 2e-2 or twice
        # the single rank's own bf16 error on that shard
        l2 = [(_leaf_l2(g, e) / max(BF16_GATE, 2 * _leaf_l2(r, e)),
               _leaf_l2(g, e), max(BF16_GATE, 2 * _leaf_l2(r, e)), path)
              for (path, _), g, r, e in zip(leaves, got, grads, exact)]
        # and the split in fp32 compute against the single rank in fp32
        got32 = _grads_of(lm32, state, batch, opts, tcfg, mesh, rules)[1]
        exact32 = max((_exact_frac(g, e), _leaf_l2(g, e), path)
                      for (path, _), g, e in zip(leaves, got32, exact))
        del got, grads, got32, exact
        step = make_train_step(lm, tcfg, opts)
        ops.reset_launch_counts()
        cc = CollectiveCounter()
        mesh_losses, times = [met["loss"]], []
        with cc:
            for _ in range(TP_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                mesh_losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        train_launches = {k: n for k, n in ops.launch_counts().items() if n}
    offs = [(*_adam_off(g, r, lr_sum), path) for (path, _), g, r in zip(
        leaves, tree_leaves(state["params"]), ref_params)]
    out["b"] = dict(losses=mesh_losses, ref_losses=losses, grad_l2=max(l2),
                    p17=p17, exact32=exact32,
                    param_off=max(offs), param_steps=max(o[1] for o in offs),
                    step_s=times, coll_calls=cc.total // TP_STEPS,
                    coll_bytes=cc.bytes // TP_STEPS, coll_s=cc.seconds,
                    launches=train_launches, n_leaves=len(leaves))
    del state, sp, ref_params, m
    free()

    # (c) the dense-cache decode on the mesh, bf16 then fp32 compute
    sc, sc32 = (lm.shard_cache(tree_map(torch.clone, c), mesh, rules)
                for c in (cache, cache32))
    conv = ({} if cfg.family != "hybrid" else
            dict(conv_cols=sc["layers"]["conv"].shape[-1],
                 x_channels=cfg.d_inner // 2))
    del cache, cache32
    cc = CollectiveCounter()
    dgot, dtimes = [], []
    with torch.no_grad(), sharding_context(mesh, rules), cc:
        for i in range(TP_DECODE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dgot.append(lm.decode_step(shards, dtoks[i], sc, pos + i)[0])
            torch.cuda.synchronize()
            dtimes.append(time.perf_counter() - t0)
    with torch.no_grad(), sharding_context(mesh, rules):
        dgot32 = [lm32.decode_step(shards, dtoks[i], sc32, pos + i)[0]
                  for i in range(TP_FP32_STEPS)]
    out["c"] = dict(
        l2=max(_leaf_l2(a, b) for a, b in zip(dgot, dref)),
        rel=max(_leaf_rel(a, b) for a, b in zip(dgot, dref)), noise=dnoise,
        rel32=max(_leaf_rel(a, b) for a, b in zip(dgot32, dref32)),
        shape=list(dgot[0].shape), step_s=dtimes,
        coll_calls=cc.total // TP_DECODE_STEPS, coll_s=cc.seconds,
        peak=torch.cuda.max_memory_allocated(), **conv)
    return out


def tp_families_main(rank: int, port: int) -> int:
    """One rank of phase 19: each family on a 1x2 ``data x model`` mesh of
    two rank processes of this script over gloo on this card."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.parallel.sharding import default_rules
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2,
                            timeout=timedelta(minutes=10))
    assert torch.cuda.is_available(), "a phase 19 rank found no card"
    mesh = make_mesh((1, 2), ("data", "model"))
    rules = default_rules(mesh.axis_names)
    out = {}
    for name, kw, bs in TP_FAMILIES:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out[name] = _tp_family(name, kw, bs, mesh, rules, rank)
        out[name]["s"] = time.perf_counter() - t0
        free()
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


def tp_families_phase(report) -> None:
    """Phase 19: tensor parallelism of the hybrid, ssm and enc-dec families
    on two rank processes of this script (``--tp-families-rank R --port
    P``) over gloo on this card, a 1x2 ``data x model`` mesh: zamba2-1.2b
    at 6 layers, rwkv6-1.6b at 4, seamless-m4t-large-v2 at 2 + 2, full
    width, each against the single rank on the same weights (``LM.init``
    with its zero- and one-initialised leaves redrawn, ``_tp_redraw``).
    (a) The bf16 forward on the kernel path: K2, K6 and K7 on each rank's
    heads, each launch held to its plain version on the same shard (phase
    3's bf16 tolerance relative to the output's largest value: the model's
    activations are not phase 3's |y| ~ 1), the launch counts exact, the
    logits by phase 18 (c)'s bf16 rule.  (b) Three train steps: the loss
    and the parameters after AdamW by phase 17's rules; every step-0
    gradient shard in fp32 compute within EP_GATE of the single rank's,
    and in bf16 within 2e-2 of the fp32-compute gradient or twice the
    single rank's own bf16 error (phase 17's limit, measured from fp32
    compute rather than from the single rank's bf16 gradient, which for a
    leaf whose bf16 gradient is rounding noise bounds nothing).  (c) Eight
    dense-cache decode steps over ``shard_cache``'s shards (zamba2's conv
    shard misaligned with its mixer's split) by phase 18 (c)'s rules:
    bf16, and two steps in fp32 compute at 1e-3."""
    from repro_torch.configs import get_config
    results = _spawn("--tp-families-rank", 2, {})
    failed = []
    for name, _, bs in TP_FAMILIES:
        family = get_config(name).family
        for r, res in enumerate(results):
            f = res[name]
            a, b, c = f["a"], f["b"], f["c"]
            lim_a = max(BF16_GATE, 2 * a["noise"])
            log(f"[19 {name} rank {r}] (a) bf16 forward {bs[0]} x {bs[1]} on "
                f"the kernel path, {a['ms']:.1f} ms: logits {a['shape']} "
                f"against the single rank: relative L2 {a['l2']:.3e} (limit "
                f"{lim_a:.3e}: {BF16_GATE} or twice the single rank's own bf16 "
                f"error, {a['noise']:.3e}), rel max err {a['rel']:.3e}; "
                f"launches {a['launches']} (expected {a['expected']}, "
                f"captured calls {a['calls']})")
            for entry, k in a["kernels"].items():
                log(f"[19 {name} rank {r}]   {entry}: shapes {k['shapes']}, "
                    f"{k['launches']} launches, against the plain version on "
                    f"the same shard max_abs_err {k['max_abs_err']:.3e}, "
                    f"relative to its largest value {k['rel']:.3e} (limit "
                    f"{TOL[torch.bfloat16]}: phase 3's inputs keep |y| near "
                    "1, the model's do not)"
                    + (f"; kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} "
                       f"ms, library {k['library_ms']} ms, bound "
                       f"{k['bound_ms']:.5f} ms ({k['bound_by']}) "
                       f"[{nvidia_smi_line()}]" if "ms" in k else ""))
                failed += [m for ok, m in (
                    (k["rel"] <= TOL[torch.bfloat16],
                     f"{name} rank {r}: {entry} differs from its plain "
                     "version"),) if not ok]
            rel = max(abs(x - y) / abs(y) for x, y in zip(b["losses"],
                                                           b["ref_losses"]))
            (share, worst, path) = b["param_off"]
            want = {"softmax_xent_fwd": TP_STEPS,
                    "softmax_xent_bwd": TP_STEPS,
                    "adamw_fused": TP_STEPS * b["n_leaves"]}
            log(f"[19 {name} rank {r}] (b) losses {b['losses']} (single rank "
                f"{b['ref_losses']}; worst rel {rel:.3e}, limit {BF16_GATE}); "
                f"step-0 gradient shards against fp32 compute: relative L2 at "
                f"most {b['grad_l2'][0]:.3f} of its leaf's limit "
                f"({b['grad_l2'][3]}: {b['grad_l2'][1]:.3e}, limit "
                f"{b['grad_l2'][2]:.3e}: {BF16_GATE} or twice the single "
                f"rank's own bf16 error); against the single rank's bf16 "
                f"gradient (phase 17's reading, not gated) at most "
                f"{b['p17'][0]:.3f} of phase 17's limit ({b['p17'][3]}: "
                f"{b['p17'][1]:.3e}, limit {b['p17'][2]:.3e}); in fp32 compute "
                f"the split's gradient shards at most {b['exact32'][0]:.3f} of "
                f"their limit from the single rank's ({b['exact32'][2]}: "
                f"relative L2 {b['exact32'][1]:.3e}; limit {EP_GATE}, atol "
                f"1e-6 an element); "
                f"parameters after step {TP_STEPS - 1}: at most {share:.2e} of "
                f"a leaf past {BF16_GATE} of its largest value ({path}; limit "
                f"{ADAM_OUTLIERS}), those within {b['param_steps']:.3f} x two "
                f"full steps (limit {ADAM_STEPS}); step ms "
                f"{[round(t * 1e3, 1) for t in b['step_s']]}, collectives "
                f"{b['coll_calls']} a step, {b['coll_bytes'] / 2**20:.1f} MiB a "
                f"step, {b['coll_s'] / sum(b['step_s']) * 100:.1f}% of the "
                f"steps' host time in them; launches {b['launches']} "
                f"(expected {want})")
            lim_c = max(BF16_GATE, 2 * c["noise"])
            conv = (f"; conv shard {c['conv_cols']} columns against "
                    f"{c['x_channels']} x channels a rank"
                    if "conv_cols" in c else "")
            log(f"[19 {name} rank {r}] (c) {TP_DECODE_STEPS} decode steps, "
                f"{TP_DECODE_B} slots over {TP_DECODE_S} rows: logits "
                f"{c['shape']} relative L2 {c['l2']:.3e} (limit {lim_c:.3e}: "
                f"{BF16_GATE} or twice the single rank's own bf16 error, "
                f"{c['noise']:.3e}), rel max err {c['rel']:.3e}; in fp32 "
                f"compute rel max err {c['rel32']:.3e} (limit {EP_GATE}){conv}; "
                f"step ms {[round(t * 1e3, 1) for t in c['step_s']]}, "
                f"collectives {c['coll_calls']} a step, "
                f"{c['coll_s'] / sum(c['step_s']) * 100:.1f}% of the steps' "
                f"host time in them; peak {c['peak'] / 2**30:.2f} GiB; the "
                f"family took {f['s']:.1f}s on this rank ({f['ref_s']:.1f}s of "
                f"it the single rank's references) [{nvidia_smi_line()}]")
            failed += [m for ok, m in (
                (a["l2"] <= lim_a, f"{name} rank {r}: (a) logits differ"),
                (a["launches"] == a["expected"] and all(
                    a["launches"][k] == n for k, n in a["calls"].items()),
                 f"{name} rank {r}: (a) launch counts"),
                (b["exact32"][0] <= 1.0,
                 f"{name} rank {r}: (b) fp32 gradient shards differ"),
                (rel <= BF16_GATE, f"{name} rank {r}: (b) losses differ"),
                (b["grad_l2"][0] <= 1.0,
                 f"{name} rank {r}: (b) gradient shards differ"),
                (share <= ADAM_OUTLIERS and b["param_steps"] <= ADAM_STEPS,
                 f"{name} rank {r}: (b) parameters differ"),
                (b["launches"] == want, f"{name} rank {r}: (b) K4/K5 launches"),
                (c["l2"] <= lim_c, f"{name} rank {r}: (c) bf16 logits differ"),
                (c["rel32"] <= EP_GATE,
                 f"{name} rank {r}: (c) fp32 logits differ"),
                (family != "hybrid" or c["conv_cols"] != c["x_channels"],
                 f"{name} rank {r}: (c) the conv shard lines up"))
                if not ok]
        for entry, k in results[0][name]["a"]["kernels"].items():
            report[entry] = dict(
                launches=sum(res[name]["a"]["kernels"][entry]["launches"]
                             for res in results),
                max_abs_err=max(res[name]["a"]["kernels"][entry][
                    "max_abs_err"] for res in results),
                **{key: k[key] for key in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")})
    assert not failed, failed


def free() -> None:
    """Drop what a finished phase left, so the next one has the card."""
    gc.collect()
    torch.cuda.empty_cache()


def triton_adamw_build() -> None:
    """Compile K5 for fp32 and bf16 gradients by launching it once on a
    small tensor (outside any counted path), and print what the compiler
    reports of it (registers, spills, shared memory), where this Triton
    version exposes it."""
    from repro_torch.kernels import adamw_update as aw
    triton, kernel = aw._kernel()
    for gdtype in (torch.float32, torch.bfloat16):
        z = torch.zeros(aw.BLOCK, device=DEV)
        compiled = kernel[(1,)](z.to(gdtype), z.clone(), z.clone(), z.clone(),
                                torch.ones((), device=DEV), aw.BLOCK,
                                1e-3, 0.9, 0.95, 1e-8, 0.1, 0.1, 0.05,
                                BLOCK=aw.BLOCK, num_warps=8)
        torch.cuda.synchronize()
        info = {k: getattr(compiled, k, None)
                for k in ("n_regs", "n_spills")}
        shared = getattr(getattr(compiled, "metadata", None), "shared", None)
        log(f"  adamw_kernel grad {str(gdtype)[6:]}: registers "
            f"{info['n_regs']}, spills {info['n_spills']}, shared {shared}")

def main() -> int:
    phase("1 card")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"nvidia-smi: {smi}")
    log(f"device: {kind}, count {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}; TF32 off for matmul and cuDNN")

    phase("2 build")
    from repro_torch.kernels import _build, rmsnorm
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"nvcc: {sorted(logs) or 'cached'} in {time.perf_counter()-t0:.1f}s")
    for name in _build.SOURCES:     # built now or by an earlier run
        for line in _build.compiler_log(name).splitlines():
            if any(w in line for w in ("Used", "spill", "smem",
                                       "Compiling entry", "Performance")):
                log(f"  {name}: {line.strip()}")
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for d in (2560, 128, 2048, 4096, 7168):
            x = torch.ones(4, d, device=DEV, dtype=dtype)
            rmsnorm.rmsnorm_rows(x, torch.ones(d, device=DEV))
    torch.cuda.synchronize()
    log(f"triton rmsnorm compiled in {time.perf_counter()-t0:.1f}s")
    t0 = time.perf_counter()
    triton_adamw_build()
    log(f"triton adamw compiled in {time.perf_counter()-t0:.1f}s")

    phase("3 kernels against their plain versions")
    report = {}
    check_k1(report)
    check_k1_int8(report)
    check_k2(report)
    check_k6(report)
    check_k7(report)
    check_k3(report)
    check_k4(report)
    check_k5(report)
    free()

    phase("4 full-width qwen3-4b fp32: kernel path vs plain path, native "
          "and int8 pages")
    model_check(report)
    free()

    phase("5 serve full-width qwen3-4b bf16 through the CUDA-graph step: "
          "native, int8, eager, contiguous")
    phase5_streams, phase5_runs, model = serve(report)
    native_run = phase5_runs["native"]
    free()

    phase("5b infrastructure: Autopilot's probes on the card, then phase "
          "5's native run with the health loop")
    infra_probes()
    infrastructure(model, phase5_streams["native"], native_run)
    free()

    phase("5c tenancy and faults: K1 NaN gates, fp32 recovery, phase 5's "
          "bf16 workload with tenants and a fault plan")
    k1_nan_gates()
    fp32_recovery()
    free()
    faulted_serve(model, phase5_streams["native"], native_run)
    free()

    phase("5d host-RAM page tier: the prefix-hit workload cold and warm, "
          "phase 5's workload with the tier, the hazards, the soak")
    host_tier(model, phase5_streams["native"], phase5_runs)
    del model
    free()

    phase("6 training parity: 2-layer full-width qwen3-4b fp32, K4/K5 vs "
          "plain")
    train_parity()
    free()

    phase("7 train full-width qwen3-4b, 12 layers, bf16 compute")
    p7 = train_run(report)
    free()

    phase("8 full-width zamba2-1.2b and rwkv6-1.6b fp32: kernel path vs "
          "plain path")
    depths = recurrent_parity()

    phase("9 eval full-width zamba2-1.2b and rwkv6-1.6b bf16")
    recurrent_eval(report)

    phase("10 sharded pools: K1 partials, then full-width qwen3-4b on 2 "
          "ranks of this card over gloo, then a 2x2 batch x pages mesh of "
          "4 ranks")
    check_k1_partials(report)
    free()
    sharded_ranks(report)
    free()
    mesh2d_ranks()
    free()

    phase("11 biased dense: K1 and K2 at the new head layouts, the fp32 "
          "kernel path vs the plain path, granite-20b-code served in bf16")
    check_bias_layouts(report)
    bias_kernel_vs_plain(report)
    granite_serve(report)

    phase("12 recurrent decode: zamba2-1.2b and rwkv6-1.6b prefill states "
          "and decode steps, fp32 against the forward, then bf16")
    recurrent_decode_parity(depths)
    recurrent_decode_serve()
    free()

    phase("13 recurrent training: zamba2-1.2b (12 layers) and rwkv6-1.6b "
          "(6 layers) at full width, "
          "remat none, selective and full")
    t0 = time.perf_counter()
    recurrent_train(report)
    log(f"phase 13 took {time.perf_counter() - t0:.1f}s")

    phase("14 vlm: internvl2-2b fp32 kernel path vs plain path, served in "
          "bf16 with an image a request, trained")
    t0 = time.perf_counter()
    vlm_layouts(report)
    vlm_kernel_vs_plain(report)
    vlm_serve(report)
    vlm_train()
    log(f"phase 14 took {time.perf_counter() - t0:.1f}s")

    phase("15 moe: moonshot-v1-16b-a3b fp32 kernel path vs plain path, "
          "moonshot (12 layers) and arctic-480b (1 layer) served in bf16, "
          "moonshot trained")
    t0 = time.perf_counter()
    moe_phase(report)
    log(f"phase 15 took {time.perf_counter() - t0:.1f}s")

    phase("16 enc-dec: seamless-m4t-large-v2 fp32 kernel path vs plain "
          "path and decode vs forward, bf16 prefill and decode, trained")
    t0 = time.perf_counter()
    encdec_phase(report)
    log(f"phase 16 took {time.perf_counter() - t0:.1f}s")

    phase("17 parallel training on this card's rank processes: qwen3-4b "
          "(4 layers) FSDP + TP on 2x2, moonshot expert parallel on 1x2, a "
          "2-stage pipeline, the int8 gradient sync")
    t0 = time.perf_counter()
    p17 = train_mesh_phase(report)
    log(f"phase 17 took {time.perf_counter() - t0:.1f}s")

    phase("18 dry-run against the card: phase 7's step counted against its "
          "dry-run, phase 17's 2x2 collectives, the sharded dense-cache "
          "decode on 2x2, the dry-run CLI on a full-size cell")
    t0 = time.perf_counter()
    dryrun_phase(p7, p17)
    del p7
    free()
    log(f"phase 18 took {time.perf_counter() - t0:.1f}s")

    phase("19 tensor parallelism of the hybrid, ssm and enc-dec families on "
          "this card's rank processes: zamba2-1.2b (6 layers), rwkv6-1.6b (4) "
          "and seamless-m4t-large-v2 (2 + 2) on 1x2, forward, train, decode")
    t0 = time.perf_counter()
    tp_families_phase(report)
    free()
    log(f"phase 19 took {time.perf_counter() - t0:.1f}s")

    csrc = "src/repro_torch/csrc/"
    meta = {"paged_flash_decode": ("cuda", csrc + "paged_decode.cu",
                                   "src/repro/kernels/paged_decode.py:142"),
            "paged_flash_decode_int8": ("cuda", csrc + "paged_decode.cu",
                                        "src/repro/kernels/"
                                        "paged_decode.py:142"),
            "paged_flash_decode_partials": ("cuda", csrc + "paged_decode.cu",
                                            "src/repro/kernels/"
                                            "paged_decode.py:142"),
            "paged_flash_decode_partials_int8": ("cuda",
                                                 csrc + "paged_decode.cu",
                                                 "src/repro/kernels/"
                                                 "paged_decode.py:142"),
            "flash_attention_bhsd": ("cuda", csrc + "flash_attention.cu",
                                     "src/repro/kernels/"
                                     "flash_attention.py:60"),
            "flash_attention_bhsd_fp32": ("cuda", csrc + "flash_attention.cu",
                                          "src/repro/kernels/"
                                          "flash_attention.py:60"),
            "rmsnorm_rows": ("triton", "src/repro_torch/kernels/rmsnorm.py",
                             "src/repro/kernels/rmsnorm.py:19"),
            "softmax_xent_fwd": ("cuda", csrc + "softmax_xent.cu",
                                 "src/repro/kernels/softmax_xent.py:32"),
            # the TPU kernel has no backward: JAX differentiates the loss
            "softmax_xent_bwd": ("cuda", csrc + "softmax_xent.cu",
                                 "src/repro/kernels/softmax_xent.py:32"),
            "adamw_fused": ("triton", "src/repro_torch/kernels/"
                            "adamw_update.py",
                            "src/repro/kernels/adamw_update.py:34"),
            "ssd_scan_bhsd": ("cuda", csrc + "mamba2_ssd.cu",
                              "src/repro/kernels/mamba2_ssd.py:52"),
            "wkv6_scan_bhsd": ("cuda", csrc + "rwkv6_wkv.cu",
                               "src/repro/kernels/rwkv6_wkv.py:50")}
    # phases 11 and 14's head layouts and phase 13's train shapes: their own
    # entries, beside the base mode's, each launched by a run of its phase
    # in the mode it was timed in
    layouts = sorted(k for k in report if "[" in k)
    idle = [k for k in layouts if not report[k]["launches"]]
    assert not idle, f"no run launched {idle}"
    kernels = []
    for name in list(meta) + layouts:
        route, source, replaces = meta[name.split("[")[0]]
        r = report[name]
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        **({"long": r["long"]} if "long" in r else {})})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    for flag, entry in (("--tp-families-rank", "tp_families_main"),
                        ("--train-mesh-rank", "train_mesh_main"),
                        ("--train-mesh-pair", "train_mesh_pair_main"),
                        ("--decode-mesh-rank", "decode_mesh_main"),
                        ("--dryrun-rank", "dryrun_rank_main")):
        if flag in sys.argv:
            argv = sys.argv[1:]
            opt = {argv[i]: int(argv[i + 1]) for i in range(0, len(argv), 2)}
            sys.exit(globals()[entry](opt[flag], opt["--port"]))
    if "--mesh2d-rank" in sys.argv:
        argv = sys.argv[1:]
        opt = {argv[i]: int(argv[i + 1]) for i in range(0, len(argv), 2)}
        sys.exit(mesh2d_main(opt["--mesh2d-rank"], opt["--port"]))
    if "--sharded-rank" in sys.argv:
        argv = sys.argv[1:]
        opt = {argv[i]: int(argv[i + 1]) for i in range(0, len(argv), 2)}
        sys.exit(rank_main(opt["--sharded-rank"], opt["--ranks"],
                           opt["--port"]))
    sys.exit(main())

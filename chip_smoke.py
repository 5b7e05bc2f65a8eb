#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, in order (each prints its wall time; any failure exits non-zero):

1. device: the launch profile (``repro_torch.launch.profile.apply()``, run
   first; its ``describe()`` printed: tcmalloc, the log and allocator
   environment, torch and CUDA versions, the card, the build directory,
   TF32 and ``cudnn.benchmark``); the card's name and power limit
   (``nvidia-smi``), torch and CUDA versions; the kernels are built from
   ``src/repro_torch/kernels/{photonic_gemm,flash_attention}/csrc``, with
   two variants of the flash source that split P into the other counts of
   bf16 terms (one to three; the shipped source uses two), one ``nvcc``
   per source, all started together;
   each build's SASS counts of tensor-core (``HMMA``, ``IMMA``, ``HGMMA``)
   and asynchronous-copy (``LDGSTS``, ``UTMALDG``) instructions, and the
   SASS instructions of one Box-Muller draw (a probe built from the
   photonic kernel's own ``gaussian``) for the bound of noisy rows.
1b. keys: the port's ``prng`` (JAX's threefry2x32, bit for bit) on the
   card against the same calls on the CPU and against known answers of
   ``jax.random`` embedded here (``KEY_ANSWERS``; the card has no JAX,
   and ``tests/test_torch_prng.py`` recomputes them from JAX): ``fold_in``,
   ``split``, 8/16/32-bit words and f32 ``uniform`` bits exactly,
   ``categorical`` of a bf16 row of 151,936 logits under four per-row keys
   exactly, and the weight init's draws exactly: f32 ``normal`` bits (12
   values, and the sha256 of 2^20 draws) and ``randint(-127, 128)`` cast to
   int8; the Gumbel noise of the card against the CPU's is counted (f32
   ``log`` may round apart), not gated; the 2^20 normal draws are timed.
2. kernels: each CUDA kernel against its plain PyTorch twin on the card at
   the server's GEMM shapes (rows R in {4, 64}; the six qwen2-0.5b weight
   sites) under the ideal, SMWA and ASMW channels, at the ``lm_logits``
   shape (R = 2000; the six sites under the ideal channel and ``attn.wq``
   under SMWA, whose twin is timed once), at the training shape (R = 4096
   = 4 x 1024 tokens; the six sites under the ideal channel and ``attn.wq``
   under SMWA, twins timed once; the row also times the engine's whole
   forward of the site, ``matmul_float`` on bf16 operands, which quantizes
   and pads the float weight per call as a training step does), plus
   f32-prologue cases with bias and gelu/silu.  The kernel is called as the engine calls it, with
   the live row count (``rows=R``): it computes and writes only those rows,
   so the comparison with the twin covers the live rows.  Per case: median
   kernel time (CUDA graph of 10 launches, CUDA events), twin time,
   ``torch._int_mm`` time for the ideal int core (a yardstick only; the port
   never calls it), the bound of the logical GEMM (live rows, real K and C;
   the tile padding is the kernel's overhead, not work) and which of its
   terms binds, and whether the outputs agree, with the kernel launches the
   case made (its check, the graph's warm-up and capture).  Per channel and
   row count, the sums over one decoder layer.  Then bit-sliced GEMMs:
   ``PhotonicEngine.int_gemm(slicing=p)`` on CUDA operands (P^2 unfused
   ``photonic_gemm`` plane passes) at the six sites, R in {4, 64}, p = 2,
   and ``attn.wq`` at R = 64 for p in {1, 4, 8} (p = 8 under ASMW takes the
   kernel's split-neighbour crosstalk path), under the three channels,
   against the same call with every pass through the twin on the card
   (bitwise; under noise one-LSB roundings at <= 0.1% of elements per
   pass); ideal rows also equal ``exact_int_gemm``, and under SMWA the
   sliced ``attn.wq`` at R = 64, p = 2 must land closer to exact than the
   unsliced GEMM.  Per row: the P^2 kernel launches alone (CUDA graph),
   the engine's whole sliced call (CUDA graph), the twin passes,
   ``torch._int_mm`` (ideal), and the bound (bytes, and int8 ops and
   draws of all P^2 passes).  Then the new dense configs' shapes:
   granite-3-8b's six sites (K = 4096 and 12800, C up to 25600) and
   deepseek-67b's MLP down projection (K = 22016) and untied LM head
   (C = 102400), at R in {4, 64}, ideal and SMWA (the SMWA seed derived
   from a ``prng`` key, as ``PhotonicEngine.stream_seed`` derives it), each
   held to its twin bitwise, noise included, with its time, bound and the
   ``_int_mm`` time of its int core (on the rows padded to 32 at R = 4);
   and granite's ``attn.wq`` at R = 4 bit-sliced at p = 2 under SMWA with
   the key.  Then deepseek-v2-lite-16b's sites: ``attn.wq`` (C = 3072),
   ``attn.wdkv`` (C = 576), ``attn.wo``, the shared experts' ``wi`` / ``wo``
   and layer 0's dense ``ffn.wi`` (C = 21888) and ``ffn.wo`` (K = 10944) at
   R in {4, 64}, and the latent up-projections ``attn.wuk`` / ``attn.wuv``
   (K = 512) at R = 4 x 128 (expanded decode runs them over the padded
   cache), ideal and keyed SMWA, each bitwise its twin, with sums for a MoE
   layer's absorbed and expanded decode.
3. flash kernels: the flash-attention kernel on the card (qwen2-0.5b
   heads unless noted): B=4 at the four serve prompt lengths, B=2 T=1000
   (ragged edge), B=1 T=4096, B=1 Tq=64 Tk=1000 q_offset=936, non-causal
   B=2 T=1000 kv_valid=900, hd=128 (H=12, KV=2, T=1024), granite-3-8b's
   heads (H=32, KV=8, hd=128, B=2, T=1000) and one f32 case.
   Per case: median kernel time (CUDA graph), twin time,
   ``scaled_dot_product_attention`` time (``is_causal`` where the mask is
   plain causal, else an explicit boolean mask; a yardstick only, the port
   never calls it), the bound (q, k, v, out bytes at the HBM rate against
   4 hd flops per live score entry at the input type's peak) and
   agreement.  f32: max abs err to the twin <= 2e-5.  bf16 (the
   tensor-core kernel, which sums in another order than the twin): every
   element within the f64 bound of ``ref.oracle_and_bound``, |got - o| <=
   max(ulp(o), ulp(got)) + 2^-22 (n S + (hd + 16) A (S + |o|)); the worst
   |got - o| / bound is printed for the kernel, the twin and SDPA (SDPA for
   information only).  Then P's bf16 terms at the ``lm_logits`` shape and
   at the 16-token serve prompt: the twin with P in one bf16 term and the
   kernel built with one term must fail the bound at ``lm_logits``, the
   shipped kernel must hold it, and each build is reported with its time.
4. int_gemm path: ``PhotonicEngine.int_gemm`` (the integer entry point,
   kernel ``photonic_gemm``) at the six sites, launch counts reset before.
5. serve: qwen2-0.5b at full width (24 layers, bf16, seeded random weights
   from ``init_params``) answers 4 greedy requests through the port's
   paged ``Scheduler`` with every weight GEMM on the fused kernel, in the
   ideal and the SMWA-analog mode; launch counts are reset before each run
   and must equal 6 x 24 x forward calls; ideal-mode tokens must equal the
   same server's on the ``ref`` backend.  (Cut for the run's limit: every
   serving run's profiler report, 3-16 s each, with the two decode steps
   each run set apart for it; the tooling phase profiles one decode step.)
   The paged path runs chunked attention, so its flash count must stay 0.
5b. sliced serve: the same server, prompts and tokens with
   ``photonic_slicing=2`` in the ideal and SMWA modes: ``photonic_gemm``
   launches 16 x 6 x 24 x forwards, fused launches 0; ideal tokens equal
   the unsliced ideal tokens; SMWA logits finite.
5c. int8 serve: the seed-0 weights converted by ``quantize_params`` to
   ``photonic_scope="weights_int8"``, with ``kv_cache_int8`` and every
   layer's Q/K/V fused by ``fuse_qkv_params`` after the scheduler prepacks
   them, ideal channel: kernel tokens equal ``ref`` tokens, fused tokens
   equal the same server's with three sites, fused launches 4 x 24 x
   forwards with ``wqkv`` (6 x 24 x forwards without).
6. oneshot serve: ``lm_logits`` at full width (B=2, T=1000) with
   ``attn_impl="flash"``, ``"chunked"`` and, as a witness of how far the
   model carries a rounding difference of its attention core, ``"chunked"``
   at the flash kernel's key block (``attn_chunk=128``), in three
   numerics: bf16 on the ideal channel and kernel backend, bf16 with
   digital GEMMs, and f32 with digital GEMMs; flash launches 24 and 0,
   fused launches 6 x 24 on the photonic run.  Max |dlogit| / max |logit|
   and argmax agreement over the 2,000 positions, flash vs chunked and
   witness vs chunked, gated: f32 <= 1e-4 and every argmax equal; bf16
   <= max(2e-2, 2 x witness) and disagreement <= max(1%, 2 x witness).
   Then the one-shot ``LegacyEngine`` (batch 4, max_seq 128, the same 4
   prompts and 8 greedy tokens) with flash on the kernel and the ``ref``
   backends and chunked on the kernel backend: flash launches 24 x
   prefills (0 when chunked), fused launches 6 x 24 x forwards on the
   kernel backend, kernel tokens equal to ``ref`` tokens; ms per decode
   step, prefill seconds and tokens/s.
6i. init and examples (between phases 6 and 6a): (a) full-width
   qwen2-0.5b drawn on the card by ``init_params(cfg, prng.PRNGKey(0),
   "cuda")``, each of its 13 leaves in the reference's stacked layout
   hashed (sha256 of its bytes) and held to the digests of the reference's
   ``init_tree`` in ``KEY_ANSWERS``; the draw's seconds and peak memory
   printed; (b) 4 requests of 8-token prompts x 8 greedy tokens served
   from those weights through the paged ``Scheduler`` on the ideal
   channel, the ``kernel`` backend's logits bitwise the ``ref`` backend's,
   6 x 24 fused launches a forward; (c) the five ``repro_torch.examples``
   (``quickstart``, ``serve_lm``, ``train_lm --steps 20 --photonic``,
   ``map_workload``, ``paper_repro``), each its own process on the card at
   the reference script's sizes, all started when the phase starts and run
   beside (a) and (b) (whose host-timed seconds they share the host with):
   each must exit 0, and quickstart must print its CUDA kernel equal to
   its twin; their output is printed.
6a. tp: tensor-parallel photonic serving, K sharded over two shards.
   Kernel rows first, in this process: each shard's
   ``shard_local_engine(engine, K / 2).int_gemm(shard=i)`` on CUDA int8
   operands (the unfused ``photonic_gemm`` kernel at the shard-local
   fan-in: K_local 448 / 2432 for qwen2-0.5b's six sites at R in {4, 64},
   2048 / 6400 for granite-3-8b's at R = 4), ideal, SMWA under a ``prng``
   key and ASMW under its ``noise_seed``, against the same call through the
   twin on the card (bitwise; under noise one-LSB roundings at <= 0.1% of
   elements), each ideal sum over the shards equal to ``exact_int_gemm``;
   per shard the kernel's time (CUDA graph), the twin's, ``torch._int_mm``
   of the shard's int core and the bound.  Then a child process
   (``chip_smoke.py --phase tp TOKENS``) starts two ranks on the one card
   (``repro_torch.launch.mesh.spawn``, backend ``gloo`` with CUDA tensors:
   NCCL refuses two ranks on one device; the phase prints the backend),
   each building the ("data", "model") 1 x 2 mesh and qwen2-0.5b whole
   (``init_params`` seed 0, bf16), serving the serve phase's four prompts
   and 8 greedy tokens through ``serve.Engine`` → ``Scheduler`` with
   ``mesh=`` / ``tp_axis="model"`` and without a mesh, ideal and SMWA:
   per forward 6 x 24 unfused launches and as many int32 all-reduces
   (``repro_torch.analysis.contracts.ALL_REDUCES``), one per routed GEMM,
   and no fused launch (6 x 24 fused without the mesh); ideal TP = 2
   tokens and logits equal TP = 1's; SMWA unlike the unsharded logits; tokens
   and logits equal across the ranks (the second TP = 2 SMWA run, which
   held SMWA deterministic, is cut for the run's limit); after the ideal
   TP = 2 run, a ``ContractChecker`` over one more decode step
   (``Scheduler.decode_checker``, 4 rows): ``assert_psum_per_gemm(144)``,
   144 unfused launches, and the all-reduce wire bytes of
   ``collective_summary`` equal to the ring formula 2 (g - 1) / g x bytes
   summed over the (4, C) int32 partials of the six sites x 24 layers, g =
   2; then ``lm_logits`` at B = 2, T = 1000 under TP = 2 bitwise TP = 1's.  Prefill seconds and decode ms/step per run; whether the
   TP = 2 tokens equal the serve phase's (which prefills in chunks of 64
   tokens) is printed, not gated.
6b. dense serve: granite-3-8b at full width with 4 of its 40 layers
   (d=4096, 32/8 heads, hd=128, d_ff=12800, vocab 49155, bf16,
   ``init_params`` seed 0; cut from 40 to keep the run inside its limit,
   first to 10, then to 8, 6 and 4)
   on the paged ``Scheduler``, the serve phase's prompt lengths and 8 new
   tokens: ideal greedy on ``kernel`` and ``ref`` (tokens equal); ideal
   sampled at temperature 0.8 under the reference's keys (seed 0) twice
   on ``kernel`` and once on ``ref`` (all equal, and unlike the greedy
   tokens); the int8 layout with the bias-free fused ``wqkv`` bank on
   ``kernel`` and ``ref`` (tokens equal); then qwen2-1.5b at full width
   (28 layers) ideal greedy on ``kernel`` and ``ref`` (tokens equal).  The
   phase prints its peak memory.
6c. deepseek: deepseek-67b at full width with 4 of its 95 layers (its
   134 GB of bf16 weights do not fit one 80 GB card): ``lm_logits`` on
   B=1, T=512 on ``kernel`` and ``ref``, max |dlogit| / max |logit| <=
   2e-2 and argmax agreement >= 99% (the oneshot phase's bf16 floor), the
   untied ``lm_head`` routed; 2 prompts x 4 greedy tokens on the paged
   server, ``kernel`` tokens equal ``ref``'s.
6d. moe: deepseek-v2-lite-16b (MLA, 64 routed experts top-6 + 2 shared,
   a dense first block) at full width and all 27 layers, bf16,
   ``init_params`` seed 0: ``lm_logits`` B=1 T=512 on ``kernel`` and
   ``ref`` (190 fused launches = 27 x 7 + 1; the oneshot phase's bf16 gate
   on the logits, and on the aux loss); ``serve.Engine`` → ``LegacyEngine``
   with the serve phase's four prompt lengths, 8 new tokens, batch 4,
   max_seq 128: greedy expanded and absorbed (``mla_absorb``) on
   ``kernel`` and ``ref``, sampled at temperature 0.8, each pair's tokens
   equal; SMWA (``noise_seed=0``): logits finite, requests done; fused
   launches 190 a prefill and 190 (136 absorbed) a decode step; the agreement of
   absorbed and expanded tokens printed; peak memory of ``lm_logits`` and
   of serving.  Then phi3.5-moe-42b-a6.6b at full width with 4 of its 32
   layers (84 GB of bf16 weights do not fit): ``lm_logits`` B=1 T=512,
   ``kernel`` vs ``ref``, 17 launches.
6e. cross: the cross-attention families.  Kernel rows, each against its
   twin (bitwise, noise included; the gelu tail of whisper's ``ffn.wi``
   at float tolerance, 1e-5 relative, its bitwise agreement recorded) with
   its time, bound and the ``_int_mm`` time of its int core:
   llama-3.2-vision-90b's six self-layer sites and its cross layer's
   ``wq`` / ``wo`` / MLP at R in {4, 64} and its head at R = 4, ideal and
   SMWA under a ``prng`` key; ``cross_kv``'s ``wk`` / ``wv`` at R = 4 x
   1600, ideal; whisper-medium's encoder sites at R = 4 x 1500, ideal, and
   its decoder sites and head at R = 4, ideal and keyed SMWA; sums per
   layer and per decode step.  The flash kernel on whisper's encoder (B =
   4, T = 1500, 16 / 16 heads, hd 64, non-causal, bf16) against the f64
   bound, with the SDPA time.  Then llama-3.2-vision-90b at full width
   with 10 of its 100 layers (8 self + 2 cross, two groups: 180 GB of bf16
   weights do not fit one card), ``init_params`` seed 0, bf16, both gates
   of each cross layer set to 0.5 (at their zero init a cross layer is the
   identity, and a broken cross path would agree with itself): ``lm_logits``
   B = 1, T = 512 with an f32 and a bf16 vision input (1, 1600, 8192) on
   ``kernel`` and ``ref`` (61 fused launches, the oneshot phase's bf16
   floor, bitwise agreement printed), and with another vision input (the
   logits must move); ``arch.prefill`` of 4 x 64 tokens with bf16 vision
   (4, 1600, 8192), then 16 greedy ``arch.decode`` steps at max_seq 128 on
   ``kernel`` and ``ref`` (tokens equal; 61 launches a prefill, 57 a decode
   step) and 4 steps
   under SMWA (``noise_seed=0``: logits finite).  whisper-medium at full
   width with 2 + 2 of its 24 + 24 layers (cut for the run's
   limit, first to 8 + 8, then 6 + 6): ``whisper_logits`` with
   audio (4, 1500, 1024) in f32 and bf16 and 375 decoder tokens on
   ``kernel`` and ``ref`` (65 launches, the bf16 floor), and with
   ``attn_impl="flash"`` against chunked (8 flash launches) under the oneshot phase's gate: the witness, chunked at
   flash's key block (``attn_chunk=128``) against chunked, measures how far
   the model carries a rounding difference of its attention cores, and
   flash may be no further than max(2e-2, 2 x the witness's) with argmax
   disagreement <= max(1%, 2 x the witness's); ``arch.prefill`` of 4 x 4 tokens then 16 greedy decode steps
   at max_seq 375 on ``kernel``, ``ref`` and kernel with flash (tokens of
   the first two equal; 65 launches a prefill, 33 a decode step, flash
   8 a prefill).  Each model prints prefill seconds, decode ms/step and
   peak memory.
6f. recurrent: the ssm and hybrid families.  Kernel rows, each bitwise
   its twin (noise included) with its time, bound and the ``_int_mm``
   time of its int core: xlstm-350m's mLSTM sites (``up`` 1024->4096,
   ``wq``/``wk``/``wv`` 2048->2048, the gates ``wi``/``wf`` 2048->4, the
   narrowest GEMM the kernel runs, ``down`` 2048->1024), its sLSTM sites
   (``wx`` 1024->4096, ``down`` 1024->1024) and head (1024->50304), and
   zamba2-2.7b's Mamba2 sites (``in_proj`` 2560->10448, ``out_proj``
   5120->2560), shared-block sites (``attn.wq/wk/wv/wo`` 2560->2560,
   ``ffn.wi`` 2560->20480, ``ffn.wo`` 10240->2560) and head (2560->32000),
   at R = 4 and 4 x 64 (heads at R = 4), ideal and SMWA under a ``prng``
   key; sums per layer and per decode step.  Flash at zamba2's shared
   attention (B = 4, T = 512, 32 / 32 heads, hd 80, which the wrapper
   zero-pads to the 128 template; causal, bf16) against the f64 bound,
   with the SDPA time.  Then both models whole at full width,
   ``init_params`` seed 0, bf16 (xlstm-350m's mLSTM gates, zero at init,
   set to fan-in normals: a zero gate GEMM would agree with itself):
   ``xlstm_logits`` / ``zamba2_logits`` at B = 1, T = 600 (not a multiple
   of ``ssm_chunk`` = 256: the padded chunk path) on ``kernel`` and
   ``ref`` under the oneshot phase's bf16 floor, bitwise agreement printed,
   154 / 163 fused launches; zamba2 also with ``attn_impl="flash"`` (9
   flash launches) against chunked under the witness gate of whisper's,
   and each of those 9 flash calls against the f64 bound of
   ``ref.oracle_and_bound`` on its own inputs (every element within it);
   ``serve.Engine`` → ``LegacyEngine``, batch 4, max_seq 128, the serve
   phase's four prompts and 8 greedy tokens on ``kernel`` and ``ref``
   (tokens equal; 154 / 163 launches a prefill and a decode step), and SMWA
   (``noise_seed=0``) for 4 decode steps (logits finite).  Each model
   prints prefill seconds, decode ms/step, tokens/s and peak memory.
7. train, in a process of its own (``chip_smoke.py --phase train``, with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in that process's environment only,
   so the serve phases run without it; its result comes back as JSON on
   its last line, and a failing or crashing child fails the run):
   qwen2-0.5b at full width (24 layers, bf16, ``remat`` "full",
   weights drawn from ``PRNGKey(0)``, the reference's) trains 3 steps of 4 x 1024
   synthetic tokens (``DataConfig(vocab_size=151936, seq_len=1024,
   global_batch=4, seed=0)``, ``AdamWConfig(lr=3e-4, warmup_steps=1,
   total_steps=3)``) with ``torch.use_deterministic_algorithms(True)``,
   in four modes:
   (a) ideal channel, kernel backend, through ``runtime.train_loop.train``
   into a temporary checkpoint directory (the end-of-run checkpoint is
   timed, its size printed, and the directory removed): fused launches
   6 x 24 x 2 = 288 per step (forward and the recompute), flash 0; (b) the
   same on the ``exact`` backend: losses and final parameters bitwise equal
   to (a)'s; (d) (a) with ``remat=False``: step-1
   loss bitwise equal to (a)'s, 144 launches a step; (e) (a) with
   ``remat_policy="dots"``: the step-1 loss and gradient norm bitwise
   (a)'s and (b)'s, 288 launches a step (the kernel is no product the
   policy saves).  (b), (d) and (e) call
   ``build_train_step`` on the same batches, each from a copy of one draw
   of train()'s first weights.  Per mode: seconds per step
   (median of steps 2-3), tokens/s and ``torch.cuda.max_memory_allocated``.
   (d) and (e) take one step, whose loss is all their gates read, and
   (a) takes no profiled fourth step; the SMWA step that was mode (c) is
   gone (all cut for the run's limit: phases 7b and 7c train under SMWA).
7c. tp train: tensor- and data-parallel training.  Kernel rows first, in
   this process: each shard's ``shard_local_engine(engine, K / 2)
   .int_gemm(shard=i)`` at qwen2-0.5b's six sites at R = 4096 (TP = 2
   training) and R = 2048 (a data rank of DP 2 x TP 2), ideal, bitwise its
   twin, each sum over the shards equal to ``exact_int_gemm``, with the
   kernel's time (CUDA graph), the twin's, ``torch._int_mm`` of the shard's
   int core and the bound.  Then a child (``chip_smoke.py --phase tp-train
   PHASE7``, phase 7 (a)'s losses and final-parameter fingerprint as JSON;
   deterministic mode and ``CUBLAS_WORKSPACE_CONFIG`` as phase 7) starts
   ranks on the one card (``repro_torch.launch.mesh.spawn``, ``gloo`` with
   CUDA tensors; NCCL refuses two ranks on one device), bf16, weights
   drawn from ``PRNGKey(0)`` as ``train()`` draws them, phase 7's
   ``DataConfig`` and ``AdamWConfig``:
   (a) two ranks, the ("data", "model") 1 x 2 mesh, qwen2-0.5b at full
   width and all 24 layers, ideal, kernel backend,
   ``train(mesh=, tp_axis="model")`` for 3 steps of 4 x 1024 tokens into a
   shared temporary directory, the heads placed over "model" since the
   parameter-placement slice: losses and final parameters bitwise phase 7
   (a)'s, ranks equal, per step 432 unfused launches and 144 all-reduces
   (with remat, 24 x 2 x (two shard launches for each of ``wq`` / ``wk`` /
   ``wv``, column-parallel, and one launch and all-reduce for each of the
   three K-sharded sites)) and no fused launch, exactly one checkpoint,
   written by rank 0; s/step (median of steps 2-3), tokens/s, peak memory
   per rank, the checkpoint's blocking seconds.  (b) SMWA (``noise_seed=0``)
   at TP = 2 and (c)'s depth of 4 layers (cut from 24 for the run's
   limit): one ``build_train_step`` under ``tensor_parallel``, loss and
   grad norm finite and equal across the ranks, 48 unfused launches and
   48 all-reduces.
   (c) four ranks, the (2, 2) mesh, qwen2-0.5b at full width cut to 4 of
   its 24 layers (four ranks share the card and the run's time limit),
   after TP = 1 ``train()`` at that depth in the child: (c1)
   ``train(mesh=, tp_axis="model")`` for 2 steps, losses and parameters
   bitwise TP = 1's, per step per rank 48 unfused launches, 48 all-reduces
   and 48 row gathers (each rank runs its 2048 rows of a GEMM and the rows
   are gathered over "data"); (c2) one ``make_dp_train_step(tp_axis=
   "model")`` step: the loss within ``rtol=1e-5`` of the mean of TP = 1's
   losses on the two data blocks (a data rank quantizes its own rows, as
   the reference's ``shard_map`` body does; the gap to the whole batch's
   loss is printed), parameters within the reference's ``atol=2e-2`` of
   TP = 1's step on the whole batch, every rank's parameters bitwise equal;
   (c3) (c2) with ``compress_grads=True`` (the int8 ring): finite, the loss
   equal to (c2)'s, the ranks' parameters within what one AdamW step can
   open between them (2 x lr plus a bf16 rounding: the owner of a ring
   chunk keeps its f32 sum, the others its requantized copy), the gap to
   (c2) printed.
7b. train families: kernel rows at the training shape (R = 4 x 1024),
   ideal, each bitwise its twin with its time, bound and ``_int_mm`` time:
   xlstm-350m's mLSTM layer (the gates at C = 4) and sLSTM layer,
   zamba2-2.7b's Mamba2 layer and shared-block invocation, and a
   deepseek-v2-lite-16b MoE layer's routed GEMMs (MLA expanded, as
   training runs it).  Then, in a process of its own as phase 7
   (``chip_smoke.py --phase train-families``), deterministic mode, bf16,
   the ``train()`` entries' weights drawn once from ``PRNGKey(0)`` as
   ``train()`` draws them, the others' from ``init_params`` seed 0 (a torch
   stream), ``DataConfig(seq_len=1024, global_batch=4,
   seed=0)``, AdamW as phase 7, each model at published width:
   xlstm-350m cut to one group (7 mLSTM + 1 sLSTM of 24 layers) and
   zamba2-2.7b to one group, 6 of 54 layers (one shared-block invocation),
   both cut to keep the run inside its limit (zamba2 at its ``ssm_chunk`` of 256,
   from the zero init of ``a_log`` / ``dt_bias``, where the reference's
   SSD gradient is NaN; xlstm first records one loss and gradient at its
   published init, whose sLSTM ``r`` makes the gradient NaN at 1024
   tokens, then trains with ``r`` at std 1/sqrt(head_dim), entering
   ``train()`` as its step-0 checkpoint): (a) ``train()`` 3 steps on the
   ideal channel and the kernel, its end-of-run checkpoint timed in a
   temporary directory; (b) SMWA (``noise_seed=0``) through
   ``build_train_step``, one step; (c) the ``exact`` backend, 3 steps:
   losses and final parameters bitwise (a)'s.  deepseek-v2-lite-16b cut
   to its dense first block and one MoE layer (its AdamW moments alone
   take 128 GB whole; the run's limit cuts the other MoE layers):
   the same through ``build_train_step``.
   whisper-medium whole: one step of 4 x 448 target tokens over
   ``audio_embed`` (4, 1500, 1024) in modes (a) (b) (c);
   llama-3.2-vision-90b cut to one group (4 self + 1 cross layer, gates
   at 0.5): loss and gradients only (no optimizer state), 4 x 1024 tokens
   over ``vision`` (4, 1600, 8192), modes (a) and (c), (c)'s gradients
   bitwise (a)'s.  Gates: losses finite, grad norms finite, fused
   launches a step = the routed GEMMs of a forward plus those the
   backward recomputes (101, 31, 29, 721, 59), ``exact`` bitwise.  Per
   mode: s/step, tokens/s, peak memory, launches; for (a) also one more
   step with the card's NVML ``utilization.gpu`` sampled (device busy).

8. analytic: the paper's analytic tier and the photonic GEMM's ``ops``
   surface in the port.  (a) ``ops.photonic_gemm`` (f32 x and w, the
   fused kernel) and ``ops.photonic_gemm_int`` (int8, the unfused kernel)
   at qwen2-0.5b's six sites, R = 64, ideal and SMWA (``noise_seed=0``),
   plus ``photonic_gemm_int(tile_c=256)`` at ``attn.wq`` under SMWA: one
   counted run (12 fused and 13 unfused launches), each output bitwise the
   same call with the engine's kernel swapped for its twin, the whole call
   timed in a CUDA graph beside its bound, the twin path and, for the
   ideal ``photonic_gemm_int``, ``torch._int_mm``.  (b) ``evaluate_all()``
   (Fig. 7: 3 organizations x DR {1, 5, 10} x 4 CNNs) held to the
   reference's float-hex digest ``FIG7_DIGEST``; FPS, FPS/W and
   FPS/W/mm^2 per cell and SMWA's ratios to ASMW and MASW averaged over
   the CNNs, labelled as the simulator's outputs.  (c) The mapper's graph
   of qwen2-0.5b (``seq_len`` 1000) and deepseek-v2-lite-16b (512) mapped
   onto ``DpuPool.area_matched(org, 5)`` for SMWA, ASMW and MASW with
   ``MapperOptions(batch=2)``: simulated tokens/s, FPS/W, mean
   utilization, and the host seconds of the mapping.  (d) Each graph
   against the routed GEMMs (site, layer, K, C, rows) recorded during the
   oneshot phase's ideal flash ``lm_logits`` (B = 2, T = 1000) and the moe
   phase's kernel ``lm_logits`` (B = 1, T = 512): every node needs one GEMM
   of equal K, C and rows x batch and every GEMM a node, except the three
   differences of ``GRAPH_DIFFERENCES`` (a tied head, deepseek's dense
   first block, the routed experts), printed with their numbers; any other
   fails the phase.
9. tooling: the port's tooling tier (``repro_torch.launch.{profile,
   hlo_analysis,dryrun}``, ``analysis.contracts.ContractChecker``).  On
   qwen2-0.5b's paged ``Scheduler`` at full width (bf16,
   ``init_params`` seed 0, ideal channel, kernel backend, prepacked, the
   serve phase's four prompts prefilled): (b) ``decode_checker()`` over one
   decode step: ``assert_zero_weight_rounds`` at the smallest routed
   weight's size, 144 fused launches, its ``matmul_traffic_bytes``
   against the step's device time from (d); the same step over the float
   (unpacked) weights counts more than zero weight rounds; (d)
   ``hlo_analysis.dispatch_summary`` of one decode step under the torch
   profiler (launches, device busy share; photonic launches 144 and flash
   0, the serve phase's constants); (f) ``dryrun.account`` over phase 7
   (a)'s training step (qwen2-0.5b, 4 x 1024 tokens, TP = 1, ideal, on the
   ``ref`` backend, which fake tensors can run) for real on the card and
   under fake CUDA tensors: FLOPs, argument bytes, GEMM traffic and the
   aten op stream equal exactly, the fake peak against
   ``max_memory_allocated`` printed as a ratio.  (e) After the profiled
   decode step, so that its host time shares the CPU with none of them,
   and beside (f) (whose host seconds they share the CPU with), the dry-run
   cells of ``DRY_CELLS``, each a subprocess started together (``python -m
   repro_torch.launch.dryrun ... --device cuda``: fake CUDA tensors on a
   fake 256-rank group, the production (16, 16) mesh): qwen2-0.5b x
   decode_32k, qwen2-0.5b x train_4k with ``--photonic --dp-shardmap``,
   and xlstm-350m x decode_32k (its prefill_32k steps the sLSTM once a
   token, millions of fake ops past the phase's time).  Each exits 0 with
   ``ok`` (its ladder identity exact), with its bytes, FLOPs, collectives
   and whether it fits one 80 GB rank printed; the JSONs land in
   ``chiprun_out/dryrun/``.  (c) runs in the tp phase's ranks.  Since the
   placement slice the cells hold what one device of the reference's
   program holds along the names the port places (rows over "data", KV
   heads over "model", ZeRO-1 moments, and the dense decoders' parameters
   by their ``param_axes``), and a fourth cell, qwen2-0.5b x train_4k with
   ZeRO-1 moments, runs beside them.
10. placement (``repro_torch.runtime.sharding.placement``).  First in this
   process (a'): the kernel at a global column origin
   (``PhotonicEngine.int_gemm(columns=, w_word=)``, ``COLUMN_BLOCKS``:
   qwen2-0.5b's ``attn.wq`` block of 448 columns from 448 and ``attn.wk``
   block of 64 from 64, neither a multiple of ``tile_c``; deepseek-v2-lite's
   layer-0 ``ffn.wi`` halves, 5,472 columns from 5,472 and from 10,944, and
   MLA ``attn.wq`` block of 1,536 from 1,536, at K = 2,048), ideal and SMWA
   under the key, ``fused`` 0 and 1, R = 4: each block's launch bitwise
   those columns of the whole weight's launch, and held to its twin; (a'')
   the kernel at a global row origin (``int_gemm(rows=, x_word=)``,
   ``ROW_BLOCKS``: deepseek-v2-lite's ``attn.wuk`` on 2,048 of 4,096 latent
   rows from 2,048 and from 1,000, off the row tile), the same way.  Then
   a child process (``chip_smoke.py --phase placement``) that spawns four
   ranks on the one card over ``gloo`` with CUDA tensors as the (data 2,
   model 2) mesh, deterministic mode: (a) qwen2-0.5b at full width (24
   layers, 14 q / 2 KV heads, 7 / 1 a rank, ``attn.wo``'s K_local 448),
   ideal and SMWA with its noise key, TP over "model" on the kernel
   backend: a prefill of ``PLACEMENT_ROWS`` x ``PLACEMENT_PROMPT`` tokens
   and ``PLACEMENT_STEPS`` decode steps, the replicated program against
   the placed one (rows over "data", heads over "model", the parameters
   whole): logits bitwise on every rank, ``attn.wq`` / ``wk`` / ``wv``
   column-parallel (two shard passes each on the rank's columns), the
   placed run's ``photonic_gemm`` (``fused=0``) launches 216 and int32
   all-reduces 72 a forward, its GEMM rows never gathered
   (``ROW_GATHERS["tp_rows"] == 0``), one scale ``MAX`` all-reduce a GEMM,
   its cache leaves 2 rows and 1 KV head; and against the run with the
   parameters placed too (``place_params``: heads, KV heads, ``d_ff`` and
   vocab over "model"): logits bitwise, or within one bf16 ulp where the
   tied digital head's column block rounds otherwise (the gate says
   which), 288 launches and 48 int32 all-reduces a forward (the row-
   parallel ``attn.wo`` and ``ffn.wo``), parameter bytes a rank about half
   the whole; (b) ``train(mesh=(2, 2), tp_axis="model")`` at
   ``TP_TRAIN_GRID_LAYERS`` of 24 layers, phase 7's data (4 x 1024
   tokens), ``PLACEMENT_TRAIN_STEPS`` steps with the rows and heads placed
   (the parameters whole) against as many replicated
   (``place_rows=False``): losses within ``rtol=1e-3``, every parameter
   within ``2 x steps x lr`` plus one bf16 rounding of its value, peak
   memory a rank printed; (b') the dry run's train step
   (``dryrun.build_step``: the parameters placed, ZeRO-1 moments) run for
   real at the same depth and data against the replicated step, with the
   same gates; (d) the MoE decoders at full width (``PLACEMENT_MOE``:
   deepseek-v2-lite at 3 of 27 layers, its dense layer 0 and two MoE
   layers of 32 experts a rank, ideal and SMWA, expanded and absorbed
   decode; phi3.5-moe at 2 of 32 layers, 8 experts a rank, ideal), a
   prefill of ``PLACEMENT_ROWS`` x ``PLACEMENT_PROMPT`` tokens and
   ``PLACEMENT_MOE_STEPS`` decode steps, the replicated program against
   everything placed (rows, heads, ``d_ff``, vocab and experts: the MoE
   expert-parallel, its partial combines summed over "model"): every
   routed GEMM of the placed run, called again on this rank's block of
   the replicated program's input to it, bitwise this rank's block of its
   output, ideal and SMWA (the first GEMM whose own input a digital op
   upstream rounded otherwise is printed), ideal logits within 2^-5 of
   their largest (the bf16 MoE bar: the combine sums in another order),
   the reductions of a placed forward, parameter bytes a rank about half
   the whole; two negative controls on deepseek-v2-lite expanded: one
   rank's partial combine dropped fails the logits gate, every column
   origin moved one block fails the SMWA replay; launches a forward,
   all-reduces, parameter bytes, peak memory a rank and the SMWA logits'
   distance from the ideal runs printed; (e) the recurrent, audio and
   vision families at full width (``PLACEMENT_FAMILIES``: xlstm-350m at one
   group of 8 of 24 layers, ideal and keyed SMWA; zamba2-2.7b at one group,
   6 Mamba2 layers and one shared-block invocation, ideal and keyed SMWA;
   whisper-medium at 2 + 2 of 24 + 24 layers against 64 encoder frames a
   row; llama-3.2-vision-90b at one group, 4 self layers and 1 cross layer
   against its 1,600 patches; the zero-initialized gates and biases drawn
   from a seeded normal), a prefill of ``PLACEMENT_ROWS`` x
   ``PLACEMENT_PROMPT`` tokens and ``PLACEMENT_FAMILY_STEPS`` decode steps,
   the replicated program against everything placed (rows; ``inner`` and
   ``mamba_heads``; heads, KV heads, ``d_ff`` and vocab over "model"), the
   replicated run's tree freed before the placed run and the ranks drawing
   and placing their trees in turn: every routed GEMM replayed on each
   rank's block of the replicated run's input bitwise, ideal logits within
   2^-5 of their largest (bitwise printed), the recurrent gathers and sums
   of a placed forward (``contracts.RECURRENT_COLLECTIVES``), parameter
   bytes a rank about half the whole, the recurrent states a rank about
   half the rows' share, the four ranks' summed peak within 80 GB; two
   negative controls that must fail the logits gate (zamba2-2.7b with the
   model ranks' ``a_log`` / ``dt_bias`` blocks swapped, xlstm-350m with the
   row-parallel ``down``'s all-reduce dropped); launches a forward,
   all-reduces, peak memory a rank and the seconds of each run printed;
   zamba2-2.7b's and whisper-medium's runs (:data:`SEQ_FORWARD`) open with
   the training forward's logits, and their forward and prefill run with
   the residual's sequence placed too (``seq_sp``; whisper's 64 frames a
   row come in as 32 a rank), under the same gates; (f) ``seq_sp``:
   qwen2-0.5b's full-width prefill of ``PLACEMENT_ROWS`` x
   ``PLACEMENT_PROMPT`` tokens with the rows, heads and ``seq_sp`` placed
   (8 positions a rank), ideal and SMWA: logits bitwise (a)'s replicated
   prefill, the residual at every constraint a rank's block (printed),
   two sequence gathers a layer and one for the last position, each
   block's row-parallel output reduce-scattered over the sequence (two a
   layer, no all-reduce of a block's output); and (b)'s
   ``train(mesh=)`` run again with ``seq_sp`` placed against (b)'s placed
   run (rows and heads alone) within (b)'s gates, bitwise printed, peak
   memory a rank printed; (g) ``kv_seq``: one row, a prompt of
   ``KV_SEQ_PROMPT`` tokens prefilled by every rank alone into a cache of
   ``KV_SEQ_MAX`` positions, then ``PLACEMENT_STEPS`` decode steps writing
   across the blocks' boundary, replicated against the rows (falling
   back), heads and ``kv_seq`` placed (2,048 positions a rank over
   "data", the decode softmax merged by a ``MAX`` and a SUM all-reduce):
   qwen2-0.5b ideal and keyed SMWA, deepseek-v2-lite at 3 layers ideal,
   expanded and absorbed, and keyed SMWA expanded without a TP scope (its
   ``wuk`` / ``wuv`` on the fused kernel at the blocks' row origins, the
   content word summed over the blocks); every prefill's cache alike on
   the four ranks; every routed GEMM replayed bitwise (the expanded
   decode's ``wuk`` / ``wuv`` on the rank's latent rows), ideal logits
   within 2^-5 of their largest and every run's within 1e-5, each cache
   leaf a rank of half the positions, and the negative controls failing:
   the row max's ``MAX`` skipped (the logits gate), the row origin forced
   to 0 and the block's own content word (the SMWA replay of ``wuk`` /
   ``wuv``); (h) ``STRESS_ITERS`` K-sharded SMWA GEMMs of a decode step,
   each all-reduced over "model" and read at once: through the staged
   helper (``runtime.collectives``) every sum its partials' and alike on
   both model ranks, gloo's own CUDA path reported, and one rank's bumped
   partial tripping the check.  ``--phase gloo-repro N`` runs the child,
   then (g)'s qwen2-0.5b SMWA prefill and replicated decode ``N`` times on
   the shipped kernel and on a variant without the slice path's barrier
   between weight-slice passes (:func:`photonic_race_library`).
   Then in this process (c): the tooling
   phase's qwen2-0.5b x decode_32k and x train_4k (ZeRO-1) cells, their
   arguments, temp, peak and FLOPs a rank beside the reference's recorded
   decode cell (``REFERENCE_DECODE_CELL``; the reference records no
   train_4k cell); gates: the decode cell fits 80 GB, its cache a rank is
   the cache's global bytes / 256, its arguments the reference's to the
   byte; both cells hold nothing whole where the reference places it, and
   train_4k fits 80 GB; the phi3.5-moe, deepseek-v2-lite, zamba2-2.7b
   and llama-3.2-vision-90b x decode_32k cells (``PLACED_CELLS``): each
   fits 80 GB and holds nothing whole where the reference places it; and
   qwen2-0.5b x long_500k (one row: the cache by ``kv_seq`` over "data"):
   it fits, its cache a rank is the global cache / 256, nothing whole.

The last lines are the kernels JSON, the card's ``name, power.limit`` and
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device
or when the port's sources are not beside this script.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_INT8_OPS_PER_S = 1.979e15  # H100 SXM dense int8 tensor cores
LANES = 4 * 32  # CUDA-core lanes per SM issuing one instruction per clock: 4 schedulers x 32
SITES = [  # (site, K, C, bias) — one decoder layer of qwen2-0.5b
    ("attn.wq", 896, 896, True),
    ("attn.wk", 896, 128, True),
    ("attn.wv", 896, 128, True),
    ("attn.wo", 896, 896, False),
    ("ffn.wi", 896, 9728, False),
    ("ffn.wo", 4864, 896, False),
]
# (site, K, C, bias) — one decoder layer of granite-3-8b (no QKV bias), and
# deepseek-67b's two widest GEMMs: the MLP down projection (K = 22016) and
# the untied LM head (C = 102400)
GRANITE_SITES = [
    ("attn.wq", 4096, 4096, False),
    ("attn.wk", 4096, 1024, False),
    ("attn.wv", 4096, 1024, False),
    ("attn.wo", 4096, 4096, False),
    ("ffn.wi", 4096, 25600, False),
    ("ffn.wo", 12800, 4096, False),
]
DEEPSEEK_SITES = [("ffn.wo", 22016, 8192, False), ("lm_head", 8192, 102400, False)]
# granite-3-8b serves 4 of its 40 layers (at full width), cut to keep the
# run inside its time limit.
GRANITE_SERVE_LAYERS = 4
# (site, K, C, bias) — deepseek-v2-lite-16b: the MLA projections and the
# shared experts of a MoE layer, then layer 0's dense FFN (d_ff = 10944);
# the latent up-projections run over the padded cache in expanded decode,
# R = batch 4 x max_seq 128 rows.
V2_SITES = [
    ("attn.wq", 2048, 3072, False),
    ("attn.wdkv", 2048, 576, False),
    ("attn.wo", 2048, 2048, False),
    ("ffn.shared.wi", 2048, 5632, False),
    ("ffn.shared.wo", 2816, 2048, False),
    ("ffn.wi", 2048, 21888, False),
    ("ffn.wo", 10944, 2048, False),
]
V2_CACHE_SITES = [("attn.wuk", 512, 2048, False), ("attn.wuv", 512, 2048, False)]
V2_CACHE_ROWS = 4 * 128
# Fused launches of one deepseek-v2-lite-16b forward over its 27 layers:
# 7 routed GEMMs a layer (wq, wdkv, wuk, wuv, wo and the dense or shared
# FFN's wi and wo) and the untied head; absorbed decode drops wuk and wuv.
V2_FORWARD_LAUNCHES = 27 * 7 + 1
V2_ABSORBED_LAUNCHES = 27 * 5 + 1
# The analytic phase's mapper graphs: (seq_len, batch) of the lm_logits
# call whose routed GEMMs the oneshot and moe phases record.
LM_GRAPHS = {"qwen2-0.5b": (1000, 2), "deepseek-v2-lite-16b": (512, 1)}
# (site, K, C) — llama-3.2-vision-90b: one self layer's six sites; a cross
# layer runs wq, wo and the MLP at the decoder rows (the self layer's
# shapes) and cross_kv's wk / wv over the vision rows (batch 4 x
# vision_seq 1600); the untied head.  Its cut: 10 of 100 layers, 8 self and
# 2 cross (two groups, the fewest that run the reference's group loop).
VISION_SITES = [
    ("attn.wq", 8192, 8192),
    ("attn.wk", 8192, 1024),
    ("attn.wv", 8192, 1024),
    ("attn.wo", 8192, 8192),
    ("ffn.wi", 8192, 57344),
    ("ffn.wo", 28672, 8192),
]
VISION_CROSS_SITES = [VISION_SITES[i] for i in (0, 3, 4, 5)]
VISION_KV_SITES = VISION_SITES[1:3]
VISION_HEAD = ("lm_head", 8192, 128256)
VISION_KV_ROWS = 4 * 1600
VISION_LAYERS = 10
VISION_FORWARD_LAUNCHES = 8 * 6 + 2 * 6 + 1  # a forward or prefill: 6 a self layer, 6 a cross layer, the head
VISION_DECODE_LAUNCHES = 8 * 6 + 2 * 4 + 1  # a decode step: cross_kv is read from the cache
# (site, K, C) — whisper-medium: the six sites of an encoder layer (at the
# encoder rows, batch 4 x 1500 frames; ffn.wi with the gelu epilogue) and of
# a decoder layer, whose cross-attention adds wq and wo of the same shapes;
# the untied head.
WHISPER_SITES = [
    ("attn.wq", 1024, 1024),
    ("attn.wk", 1024, 1024),
    ("attn.wv", 1024, 1024),
    ("attn.wo", 1024, 1024),
    ("ffn.wi", 1024, 4096),
    ("ffn.wo", 4096, 1024),
]
WHISPER_HEAD = ("lm_head", 1024, 51865)
WHISPER_ENC_ROWS = 4 * 1500
WHISPER_PREFILL_LAUNCHES = 24 * 6 + 24 * 10 + 1  # encoder 6 a layer, decoder 10 (cross K/V included), head
WHISPER_DECODE_LAUNCHES = 24 * 8 + 1  # a decode step: the cross K/V are read from the cache
WHISPER_SERVE_LAYERS = 2  # the cross phase's whisper-medium: 2 + 2 of its 24 + 24 layers (the run's limit)
WHISPER_SERVE_PREFILL_LAUNCHES = WHISPER_SERVE_LAYERS * 6 + WHISPER_SERVE_LAYERS * 10 + 1
WHISPER_SERVE_DECODE_LAUNCHES = WHISPER_SERVE_LAYERS * 8 + 1
WHISPER_SERVE_FLASH = 2 * WHISPER_SERVE_LAYERS  # a flash forward: every encoder and decoder self-attention
# (label, B, Tq, Tk, H, KV, hd, causal, q_offset, kv_valid, dtype): whisper's
# encoder self-attention, non-causal MHA over its 1500 frames.
WHISPER_FLASH = ("whisper encoder", 4, 1500, 1500, 16, 16, 64, False, 0, None, "bf16")
# (site, K, C) — xlstm-350m: an mLSTM layer's seven sites (the gates wi / wf
# at C = num_heads = 4, the narrowest GEMM the kernel runs), an sLSTM layer's
# two (its down projection labelled apart from the mLSTM's), the untied head.
XLSTM_SITES = [
    ("up", 1024, 4096),
    ("wq", 2048, 2048),
    ("wk", 2048, 2048),
    ("wv", 2048, 2048),
    ("wi", 2048, 4),
    ("wf", 2048, 4),
    ("down", 2048, 1024),
]
XLSTM_SLSTM_SITES = [("wx", 1024, 4096), ("slstm down", 1024, 1024)]
XLSTM_HEAD = ("lm_head", 1024, 50304)
XLSTM_LAUNCHES = 21 * 7 + 3 * 2 + 1  # a forward, prefill or decode step: 21 mLSTM + 3 sLSTM layers, the head
# (site, K, C) — zamba2-2.7b: a Mamba2 layer's two sites, the shared
# attention block's six (one weight set, 9 invocations), the untied head.
ZAMBA_SITES = [("in_proj", 2560, 10448), ("out_proj", 5120, 2560)]
ZAMBA_SHARED_SITES = [
    ("attn.wq", 2560, 2560),
    ("attn.wk", 2560, 2560),
    ("attn.wv", 2560, 2560),
    ("attn.wo", 2560, 2560),
    ("ffn.wi", 2560, 20480),
    ("ffn.wo", 10240, 2560),
]
ZAMBA_HEAD = ("lm_head", 2560, 32000)
ZAMBA_LAUNCHES = 54 * 2 + 9 * 6 + 1  # 54 Mamba2 layers, 9 shared-block invocations, the head
# The shared attention's flash core: 32 / 32 heads of hd 80, which the
# wrapper pads with zeros to the 128-wide template.
ZAMBA_FLASH = ("zamba2 shared attention", 4, 512, 512, 32, 32, 80, True, 0, None, "bf16")
RECURRENT_ROWS = (4, 4 * 64)  # decode, and a 64-token prompt of the serve batch
TRAIN_ROWS = 4096  # the train phase's rows per GEMM: global_batch 4 x seq_len 1024
TP_SHARDS = 2  # the tp phase's tensor-parallel degree: two ranks sharing the one card
TRAIN_STEPS = 3
TP_TRAIN_ROWS = (TRAIN_ROWS, TRAIN_ROWS // 2)  # phase 7c's rows per GEMM: TP = 2, and a data rank of DP 2 x TP 2
TP_TRAIN_GRID_LAYERS = 4  # phase 7c (c): qwen2-0.5b cut to 4 of 24 layers, four ranks on the one card
TP_TRAIN_GRID_STEPS = 2
# Phase 10 (placement): the four-rank decode's rows, prompt, cache and steps.
PLACEMENT_ROWS, PLACEMENT_PROMPT, PLACEMENT_MAX_SEQ, PLACEMENT_STEPS = 4, 16, 32, 4  # steps cut from 8 for the run's limit
PLACEMENT_TRAIN_STEPS = 2
# Phase 10 (d): the MoE decoders at full width on the four ranks, cut in
# depth (arch, layers, cases): deepseek-v2-lite's dense layer 0 and two MoE
# layers (32 of 64 experts a rank), phi3.5-moe's first two layers (8 of 16
# experts a rank); each case (label, channel, absorbed decode).
PLACEMENT_MOE = [
    ("deepseek-v2-lite-16b", 3, [("ideal", "ideal", False), ("SMWA", "SMWA", False),
                                 ("ideal absorbed", "ideal", True), ("SMWA absorbed", "SMWA", True)]),
    ("phi3.5-moe-42b-a6.6b", 2, [("ideal", "ideal", False)]),
]
PLACEMENT_MOE_STEPS = 4
# Phase 10 (g): one row decoding against a cache placed by kv_seq over "data"
# (4,096 positions, 2,048 a rank): a prompt of 2,046, so that the decode
# steps write across the blocks' boundary (the second block all masked at
# first).
KV_SEQ_MAX, KV_SEQ_PROMPT = 4096, 2046
# The reference's qwen2-0.5b x decode_32k x single cell, as its
# tests/test_dryrun_integration.py records it (results/dryrun/, not committed).
REFERENCE_DECODE_CELL = dict(argument_size_in_bytes=1677959972, temp_size_in_bytes=4298902480,
                             flops_per_device_exact=3851878928)
# The train-families phase: the fused launches of one training step, the
# forward's and then the recompute of the blocks that run under remat
# "full" in the backward.  xlstm-350m recomputes its 21 mLSTM blocks (the
# sLSTM blocks and the head run once); zamba2-2.7b its 54 Mamba2 blocks
# (the shared block runs once an invocation).
# Depth cut for the run's time limit: xlstm-350m trains one group (7 mLSTM
# + 1 sLSTM layer of 24), zamba2-2.7b one group, 6 of 54 layers (one
# shared-block invocation); a step launches the forward's routed GEMMs plus
# the mLSTM / Mamba2 ones the backward recomputes.
XLSTM_TRAIN_LAYERS = 8
ZAMBA_TRAIN_LAYERS = 6
XLSTM_TRAIN_LAUNCHES = 2 * 7 * 7 + 1 * 2 + 1
ZAMBA_TRAIN_LAUNCHES = 2 * ZAMBA_TRAIN_LAYERS * 2 + 1 * 6 + 1
# deepseek-v2-lite-16b cut to its dense first block and one MoE layer (its
# AdamW moments alone would take 128 GB whole; the run's limit cuts the
# rest); every block under remat.
V2_TRAIN_LAYERS = 2
V2_TRAIN_LAUNCHES = 2 * V2_TRAIN_LAYERS * 7 + 1
# whisper-medium: 448 target tokens over 1500 frames; the encoder and the
# decoder blocks are recomputed, the cross K/V (computed outside the
# decoder's remat body) are not.
WHISPER_TRAIN_TOKENS = 448
WHISPER_TRAIN_LAUNCHES = WHISPER_PREFILL_LAUNCHES + 24 * 6 + 24 * 8
# llama-3.2-vision-90b cut to one group: 4 self layers and 1 cross layer;
# cross_kv runs outside the cross block's remat body.
VISION_TRAIN_LAYERS = 5
VISION_TRAIN_LAUNCHES = (4 * 6 + 6 + 1) + (4 * 6 + 4)
FUSED_SRC = "src/repro_torch/kernels/photonic_gemm/csrc/photonic_gemm.cu"
FLASH_SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
# Attention's least time counts its 4 * hd flops per live score entry at
# the tensor-core rate of its input type: bf16 inputs at the dense bf16
# peak (what a Hopper flash kernel runs, with f32 accumulation); f32 inputs
# at the f32 CUDA-core peak.  That is a CUDA-core bound, not the card's
# best rate for f32-grade products: TF32 keeps 10 mantissa bits, and three
# TF32 products per product (3xTF32) would run near 495 / 3 TFLOP/s.
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
# (label, B, Tq, Tk, H, KV, hd, causal, q_offset, kv_valid, dtype)
FLASH_CASES = [
    *(("serve prompt", 4, t, t, 14, 2, 64, True, 0, None, "bf16") for t in (16, 40, 64, 24)),
    ("lm_logits", 2, 1000, 1000, 14, 2, 64, True, 0, None, "bf16"),
    ("long", 1, 4096, 4096, 14, 2, 64, True, 0, None, "bf16"),
    ("offset", 1, 64, 1000, 14, 2, 64, True, 936, None, "bf16"),
    ("kv_valid", 2, 1000, 1000, 14, 2, 64, False, 0, 900, "bf16"),
    ("hd128", 2, 1024, 1024, 12, 2, 128, True, 0, None, "bf16"),
    ("granite", 2, 1000, 1000, 32, 8, 128, True, 0, None, "bf16"),
    ("f32", 2, 1000, 1000, 14, 2, 64, True, 0, None, "f32"),
]

# Known answers of jax.random (threefry2x32 with jax_threefry_partitionable
# on, its default since JAX 0.5), computed with JAX 0.9.0 on the CPU; the
# card has no JAX.  tests/test_torch_prng.py recomputes every one from JAX.
# "categorical" draws row / 0.8 of a bf16 row of 151,936 logits (numpy
# seed row_seed, standard normal x 3) under fold_in(fold_in(key, uid), n).
# "normal_sha256" is the sha256 of the f32 bytes of n_normal normal draws;
# "randint8" draws randint(-127, 128) as int32 cast to int8, as an int8
# weight's init does.  "qwen2_init_sha256" holds the sha256 of each leaf of
# the reference's init_tree of full-width qwen2-0.5b under PRNGKey(0) (its
# stacked layout, the bf16 bytes).
KEY_ANSWERS = {
    "seed": 7, "fold": 3, "n_bits": 12, "row_seed": 5, "vocab": 151936,
    "uid_n": [(0, 0), (1, 3), (7, 8), (123456, 2)],
    "fold_in": [276534068, 1641862660],
    "split": [[3625411723, 1954958720], [195045567, 4062205631], [966301609, 1948237315]],
    "bits8": [11, 0, 170, 48, 134, 107, 88, 106, 139, 174, 217, 78],
    "bits16": [10507, 32256, 10666, 17712, 25478, 39787, 13144, 54634, 3723, 45230, 36825, 15694],
    "bits32": [2895194379, 4185947648, 1300703658, 1906787632, 3139134342, 2709822315, 1926509400,
               1767298410, 299634315, 385396910, 1594265561, 3613146446],
    "uniform_f32_bits": [1059885352, 1064927358, 1050349136, 1055084168, 1060838242, 1059161242,
                         1055238244, 1053994408, 1032773744, 1035453824, 1052642588, 1062689852],
    "categorical": [67189, 148188, 84228, 111253],
    "normal_f32_bits": [1055328331, 1073351342, 3204720709, 3188740775, 1058902321, 1051405192, 3187961264,
                        3194297134, 3216842849, 3215709175, 3198700155, 1065346727],
    "n_normal": 1048576,
    "normal_sha256": "d81eec651979583417b65e88aa9679b03af5264114af015dd30aee7a73d826f2",
    "randint8": [-63, -20, 53, 105, 80, -26, 57, 67, 61, 44, -109, 85],
    "qwen2_init_sha256": {
        "embed/table": "194c6b5158e00b9a3cdbb4d29f1560e60210060ae40ea7bb42a60c0cac95d13b",
        "final_norm/scale": "a478e919dc5f7bba5da8d136b8b5b7b3e2b17e3a4ebb7ddafdda93af94823142",
        "layers/attn/wk/b": "fd9243e1ba57263ed469c3bdbd7ade6ec5254e7ed924a9f5737fa44749933cc0",
        "layers/attn/wk/w": "bd82497dbaf2ed8e71965591964a7226081871ba73ae9895d5089bb18ecfe44d",
        "layers/attn/wo/w": "75cdd19dd7b2476ee713b69398d0989eddd811d982b14f86f1f1ca685686c10e",
        "layers/attn/wq/b": "ccc1a10b7aac17225febe0b37d40d5b4575aebdad5bb1c291429f04d1a5892b4",
        "layers/attn/wq/w": "d1393586cce90697d12bab1d16a6ec7bba786991528c4e3aa48dd51094b1af1c",
        "layers/attn/wv/b": "fd9243e1ba57263ed469c3bdbd7ade6ec5254e7ed924a9f5737fa44749933cc0",
        "layers/attn/wv/w": "3b437545576e141565e0348c80f0d5c3bf1be6a0b90de6d8cf7255a7f2376948",
        "layers/ffn/wi/w": "1df47d427f73f1219ef196477d55306a90154f09918a2eb24b695af93fbeee90",
        "layers/ffn/wo/w": "fee9b3ed92aef97bf9a92805bc9fa8252e5bcb3f25c9e090546006c6ec7a9417",
        "layers/ln1/scale": "7f4abcaa6e0e736ea193eca9cc18ef6fefb52c425a833b9d1868b0904b216de5",
        "layers/ln2/scale": "7f4abcaa6e0e736ea193eca9cc18ef6fefb52c425a833b9d1868b0904b216de5",
    },
}


# The Fig. 7 grid (3 organizations x DR {1, 5, 10} x 4 CNNs) of the
# reference's ``repro.core.simulator.evaluate_all``: the sha256 of
# ``fig7_digest``'s float-hex lines.  The analytic phase holds the port's
# grid to it; tests/test_torch_analytic.py recomputes it from the reference.
FIG7_DIGEST = "bbfcd0ec74deb9672c3b29e267414c5a304a2c046e7cc20413284a86aaecdcd8"


def fig7_digest(results) -> str:
    """sha256 over one line per (org, DR, CNN) cell of an ``evaluate_all``
    result: FPS, FPS/W, FPS/W/mm^2 and dynamic energy in float hex."""
    lines = []
    for (org, dr, model), res in sorted(results.items()):
        lines.append(f"{org} {dr} {model} {res.fps.hex()} {res.fps_per_w.hex()} "
                     f"{res.fps_per_w_per_mm2().hex()} {res.dynamic_energy_j.hex()}")
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


def layer_sum(rs, key):
    """The sum of ``key`` over case rows, or None where a row has none."""
    vals = [x[key] for x in rs]
    return None if any(v is None for v in vals) else sum(vals)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"== phase {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== phase {self.name} done in {time.perf_counter() - self.t0:.3f} s")
        return False


def graph_ms(fn, calls: int = 10, replays: int = 5) -> float:
    """Median device time of one ``fn()`` from a CUDA graph of ``calls``
    back-to-back calls (no host overhead between launches)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def eager_ms(fn, reps: int = 3) -> float:
    """Median of ``reps`` host-timed calls, each ending in a synchronize."""
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


# Filled in by the device phase: CUDA-core instructions per Box-Muller draw
# (from the SASS of a probe built from the kernel's own gaussian()) and the
# card's SM count and maximum SM clock.
DRAW = {"instructions": None, "sms": None, "clock_hz": None}


def bound_ms(r, k, c, x_bytes, passes, xtalk_dots, with_bias, fused, draws=0) -> tuple:
    """(bytes ms, int8 ms, draws ms) for one call of the logical GEMM: ``r``
    live rows and the real K and C, not the tile padding the kernel pays.
    Inputs are read once and the output written once at the HBM rate; the
    int8 ops of every pass the channel needs (one exact pass when ideal) at
    the dense int8 peak; and under detector noise the ``draws`` Box-Muller
    draws (live rows x C x live chunks x passes), each taking the probe's
    SASS instruction count, at the CUDA cores' issue rate (SMs x 4 x 32
    lanes x the maximum SM clock).  The bound is the largest of the three."""
    nbytes = r * k * x_bytes + k * c + r * c * 4
    if fused:
        nbytes += 4 + c * 4 + (c * 4 if with_bias else 0)
    ops = 2.0 * r * k * c * passes * (1 + xtalk_dots)
    draw_ms = 0.0
    if draws:
        draw_ms = draws * DRAW["instructions"] / (DRAW["sms"] * LANES * DRAW["clock_hz"]) * 1e3
    return nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_INT8_OPS_PER_S * 1e3, draw_ms


def bound_of(parts) -> tuple:
    """(bound ms, "bytes" | "operations" | "draws") of one or more summed
    calls: the largest of the summed terms."""
    sums = [sum(p[i] for p in parts) for i in range(3)]
    best = max(range(3), key=lambda i: sums[i])
    return sums[best], ("bytes", "operations", "draws")[best]


def op_or_bytes(bound_by: str) -> str:
    """The kernels line's ``bound_by``: Box-Muller draws are operations."""
    return "bytes" if bound_by == "bytes" else "operations"


def draw_instructions(nvcc_flags) -> int:
    """CUDA-core instructions of one Box-Muller draw: the kernel source's
    mix32 / gaussian, built into two probe kernels with the kernel's flags
    (one draw per thread, and the same kernel storing its counter instead),
    counted in SASS from the entry to the first EXIT (the fast path: the
    cold branches of logf / cosf lie past it), the difference of the two."""
    import re
    import shutil

    from repro_torch.kernels._build import _nvcc, build_dir

    src = (ROOT / FUSED_SRC).read_text()
    body = src[src.index("__device__ __forceinline__ uint32_t mix32"):src.index("__device__ __forceinline__ float gelu_tanh")]
    probe = ("#include <cuda_runtime.h>\n#include <stdint.h>\n" + body +
             'extern "C" __global__ void probe_draw(float* o, uint32_t b) {\n'
             "  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; o[i] = gaussian(b, i); }\n"
             'extern "C" __global__ void probe_base(float* o, uint32_t b) {\n'
             "  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; o[i] = __uint2float_rn(b ^ i); }\n")
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    (out / "draw_probe.cu").write_text(probe)
    flags = [f for f in nvcc_flags if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_nvcc(), *flags, "-cubin", "-o", str(out / "draw_probe.cubin"), str(out / "draw_probe.cu")],
                   check=True, capture_output=True, timeout=300)
    cuobjdump = shutil.which("cuobjdump") or str(Path(_nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(out / "draw_probe.cubin")], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    counts = {}
    for name in ("probe_draw", "probe_base"):
        text = sass[sass.index(f"Function : {name}"):]
        n = 0
        for line in text.splitlines()[1:]:
            m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(.*?);", line)
            if m is None:
                continue
            n += 1
            if re.search(r"\bEXIT\b", m.group(1)):
                break
        counts[name] = n
    return counts["probe_draw"] - counts["probe_base"]


def sass_counts(path) -> dict:
    """Tensor-core and asynchronous-copy instructions in a built library's
    SASS (``cuobjdump -sass``)."""
    import re
    import shutil

    from repro_torch.kernels._build import _nvcc

    cuobjdump = shutil.which("cuobjdump") or str(Path(_nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)], check=True, capture_output=True, text=True,
                          timeout=120).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HMMA", "IMMA", "HGMMA", "LDGSTS", "UTMALDG")}


def dpu_for(org: str):
    """The operating point of a channel name: "ideal" (SMWA, calibrated N,
    no analog stage) or an organization's full analog channel at its
    calibrated N with ``noise_seed=0``."""
    from repro_torch.core.dpu import DPUConfig
    from repro_torch.noise.channel import build_channel_model

    if org == "ideal":
        return DPUConfig(organization="SMWA", bits=4, datarate_gs=5.0)
    n = DPUConfig(organization=org, bits=4, datarate_gs=5.0).n
    ch = build_channel_model(org, n=n, bits=4, datarate_gs=5.0)
    return DPUConfig(organization=org, bits=4, datarate_gs=5.0, channel=ch, noise_seed=0)


def operands(torch, gen, r, k, c, rp, kp, cp, x_f32):
    """Seeded operands of an (r, k) x (k, c) GEMM, zero-padded to the
    kernel's (rp, kp) x (kp, cp) as the engine pads them."""
    dev = torch.device("cuda")
    w = torch.zeros((kp, cp), dtype=torch.int8, device=dev)
    w[:k, :c] = torch.randint(-127, 128, (k, c), generator=gen, device=dev, dtype=torch.int8)
    if x_f32:
        x = torch.zeros((rp, kp), dtype=torch.float32, device=dev)
        x[:r, :k] = torch.randn((r, k), generator=gen, device=dev)
    else:
        x = torch.zeros((rp, kp), dtype=torch.int8, device=dev)
        x[:r, :k] = torch.randint(-127, 128, (r, k), generator=gen, device=dev, dtype=torch.int8)
    return x, w


def passes_of(dpu, stages) -> tuple:
    """(slice passes, crosstalk dots per pass) the channel makes the
    kernel run: one exact pass when ideal, num_slices^2 otherwise."""
    ch = dpu.effective_channel()
    analog = ch is not None and ch.analog
    passes = 1 if not analog and stages["adc_bits"] is None else dpu.num_slices**2
    return passes, int(stages["intermod_eps"] > 0) + int(stages["crossweight_eps"] > 0)


def kernel_case(torch, K, dpu, r, k, c, with_bias, x_f32, activation, gen, rows_out, *, model="qwen2-0.5b",
                site=None, key=None, exact=False, twin_once=False):
    """One kernel-vs-twin case at the stage arguments and padding the
    engine gives an (r, k) x (k, c) GEMM; appends a result dict to
    ``rows_out``.  With ``key`` (a ``repro_torch.prng`` key) a noisy case
    draws the stream the engine derives from it for ``site`` at layer 0;
    ``exact`` holds the kernel to its twin bitwise, noise included (a bias
    or activation tail still at float tolerance; whether it came out
    bitwise is in the row);
    ``twin_once`` times the twin once (a wide GEMM's twin is slow); the
    ``_int_mm`` yardstick of the int core is timed for every ``exact`` or
    ideal case with int8 ``x``, on the rows padded to 32 where fewer (its
    least row count is 17) and the columns to a multiple of 8 (its least
    step)."""
    from repro_torch.photonic.engine import PhotonicEngine, kernel_stages

    dev = torch.device("cuda")
    stages, (rp, kp, cp) = kernel_stages(dpu, r, k, c)
    ch = dpu.effective_channel()
    analog = ch is not None and ch.analog
    noisy = stages["noise_sigma"] > 0.0
    x, w = operands(torch, gen, r, k, c, rp, kp, cp, x_f32)
    if x_f32:
        xs = (x.abs().max() * (1.0 / 127.0)).reshape(1)
    else:
        xs = torch.rand((1,), generator=gen, device=dev) * 0.01 + 1e-3
    ws = torch.rand((cp,), generator=gen, device=dev) * 0.01 + 1e-3
    bias = torch.randn((cp,), generator=gen, device=dev) if with_bias else None
    seed = torch.randint(0, 2**32, (), generator=gen, device=dev, dtype=torch.int64)
    if key is not None and not x_f32:
        seed = PhotonicEngine(dpu=dpu).stream_seed(site, 0, x[:r, :k], w[:k, :c], prng_key=key)
    args = (x, w, xs, ws, bias, seed)
    kw = dict(operand_bits=8, activation=activation, **stages)

    n0 = K.LAUNCHES["photonic_gemm_fused"]

    def run_kernel():
        return K.photonic_gemm_fused(*args, rows=r, **kw)

    def run_twin():
        return K.photonic_gemm_fused_twin(*args, **kw)

    y_k = run_kernel()[:r]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y_t = run_twin()[:r]
    torch.cuda.synchronize()
    t_once = (time.perf_counter() - t0) * 1e3
    # Agreement, over the r live rows (the kernel leaves the padding rows
    # unwritten): bitwise for deterministic channels; with detector noise the
    # f32 log/cos may round apart, so psums may differ by one LSB at a few
    # elements: in accumulator units (|diff| / (x_scale * w_scale)) at most
    # two top-pass LSBs (2 * 2^(2B)) on at most 0.1% of elements.  Bias and
    # activation add float tolerance (1e-5 relative).
    unit = (xs * ws[None, :]).to(torch.float64)
    diff = (y_k.to(torch.float64) - y_t.to(torch.float64)).abs()
    err = float(diff.max())
    finite = bool(torch.isfinite(y_k).all())
    lsb = diff / unit
    if exact and activation is None and bias is None:
        ok = finite and err == 0.0
        tol = "bitwise" + (", noise included" if noisy else "")
    elif activation is None and bias is None:
        if noisy:
            frac = float((lsb > 0.5).to(torch.float64).mean())
            ok = finite and frac <= 1e-3 and float(lsb.max()) <= 2 * 2 ** (2 * dpu.bits)
            tol = "noisy: <=0.1% elements off, <= 2 top-pass LSB"
        else:
            ok = finite and err == 0.0
            tol = "bitwise"
    else:
        rel_ok = diff <= 1e-5 * y_t.to(torch.float64).abs() + 1e-5
        if noisy:
            ok = finite and float((~rel_ok).to(torch.float64).mean()) <= 1e-3 and float(lsb.max()) <= 2 * 2 ** (2 * dpu.bits) + 1
        else:
            ok = finite and bool(rel_ok.all())
        tol = "float 1e-5 rel (bias/activation tail)"
    k_ms = graph_ms(run_kernel)
    launched = K.LAUNCHES["photonic_gemm_fused"] - n0
    del y_k, y_t, diff, lsb
    t_ms = t_once if r >= 1000 or twin_once else eager_ms(run_twin)  # the twin at R = 2000 is slow: timed once
    lib_ms = None
    if not x_f32 and (exact or (not analog and stages["adc_bits"] is None)):
        xi = torch.zeros((max(r, 32), k), dtype=torch.int8, device=dev)
        xi[:r] = x[:r, :k]
        wl = w[:k, :-(-c // 8) * 8].contiguous()  # _int_mm takes C in multiples of 8: the zero tile padding
        lib_ms = graph_ms(lambda: torch._int_mm(xi, wl))
    elif not analog and stages["adc_bits"] is None and r > 16:
        xi = x if not x_f32 else torch.clamp(torch.round(x / xs), -127, 127).to(torch.int8)
        xi, wl = xi[:r, :k].contiguous(), w[:k, :c].contiguous()
        lib_ms = graph_ms(lambda: torch._int_mm(xi, wl))
    passes, xdots = passes_of(dpu, stages)
    draws = r * c * -(-k // stages["n_chunk"]) * passes if noisy else 0
    parts = bound_ms(r, k, c, 4 if x_f32 else 1, passes, xdots, with_bias, True, draws)
    b_ms, b_by = bound_of([parts])
    rows_out.append(dict(
        model=model, site=site, keyed=key is not None,
        R_live=r, R=rp, K=k, C=c, Kp=kp, Cp=cp, channel=dpu.organization if analog else "ideal",
        x="f32" if x_f32 else "int8", bias=with_bias, activation=activation,
        ms=k_ms, plain_ms=t_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, parts=parts,
        draws=draws, max_abs_err=err, bitwise=err == 0.0, tolerance=tol, ok=ok, launches=launched,
    ))
    log(f"  {'' if model == 'qwen2-0.5b' else model + ' ' + str(site) + (' keyed' if key is not None else '') + ' '}"
        f"R={r:3d}/{rp:3d} K={k:4d}/{kp:4d} C={c:5d} {rows_out[-1]['channel']:5s} x={rows_out[-1]['x']:4s} "
        f"bias={int(with_bias)} act={activation}: kernel {k_ms:.4f} ms, twin {t_ms:.3f} ms, "
        f"_int_mm {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, bound {b_ms:.5f} ms "
        f"({b_by}), {launched} launches, max_abs_err {err:.3g} [{tol}] -> {'ok' if ok else 'MISMATCH'}")
    return ok


def int_case(torch, K, dpu, r, k, c, gen):
    """photonic_gemm (int core) against its twin at the engine's stage
    arguments; returns (ok, err, ms, twin_ms, lib_ms, bound parts)."""
    from repro_torch.photonic.engine import kernel_stages

    stages, (rp, kp, cp) = kernel_stages(dpu, r, k, c)
    ch = dpu.effective_channel()
    analog = ch is not None and ch.analog
    noisy = stages["noise_sigma"] > 0.0
    x, w = operands(torch, gen, r, k, c, rp, kp, cp, False)
    seed = torch.randint(0, 2**32, (), generator=gen, device="cuda", dtype=torch.int64)
    n0 = K.LAUNCHES["photonic_gemm"]
    y_k = K.photonic_gemm(x, w, seed, rows=r, **stages)[:r]  # live rows, as the engine calls it
    y_t = K.photonic_gemm_twin(x, w, seed, **stages)[:r]
    d = (y_k.to(torch.int64) - y_t.to(torch.int64)).abs()
    err = float(d.max())
    if noisy:
        ok = float((d > 0).to(torch.float64).mean()) <= 1e-3 and err <= 2 * 2 ** (2 * dpu.bits)
    else:
        ok = err == 0.0
    k_ms = graph_ms(lambda: K.photonic_gemm(x, w, seed, rows=r, **stages))
    launched = K.LAUNCHES["photonic_gemm"] - n0
    t_ms = eager_ms(lambda: K.photonic_gemm_twin(x, w, seed, **stages))
    lib_ms = None
    if not analog and stages["adc_bits"] is None and r > 16:
        xl, wl = x[:r, :k].contiguous(), w[:k, :c].contiguous()
        lib_ms = graph_ms(lambda: torch._int_mm(xl, wl))
    passes, xdots = passes_of(dpu, stages)
    b = bound_ms(r, k, c, 1, passes, xdots, False, False, r * c * -(-k // stages["n_chunk"]) * passes if noisy else 0)
    bm, bb = bound_of([b])
    log(f"  int core R={r} K={k} C={c} {'ideal' if not analog else dpu.organization}: kernel "
        f"{k_ms:.4f} ms, twin {t_ms:.3f} ms, _int_mm {lib_ms} ms, bound {bm:.5f} ms ({bb}), "
        f"{launched} launches, max_abs_err {err} -> {'ok' if ok else 'MISMATCH'}")
    return ok, err, k_ms, t_ms, lib_ms, b


def engine_forward_ms(torch, dpu, r, k, c, with_bias, site, gen) -> float:
    """Host-timed median of the engine's whole forward of one routed GEMM
    on float weights, as a training step runs it: ``matmul_float`` on bf16
    ``(r, k)`` activations and a bf16 ``(k, c)`` weight, which quantizes the
    activations and the weight, pads the weight to the kernel's tiles,
    launches the fused kernel and casts back."""
    from repro_torch.photonic.engine import PhotonicEngine

    eng = PhotonicEngine(dpu=dpu, backend="kernel")
    x = torch.randn((r, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((k, c), generator=gen, device="cuda") * k**-0.5).to(torch.bfloat16)
    b = torch.randn((c,), generator=gen, device="cuda").to(torch.bfloat16) if with_bias else None
    with torch.no_grad():
        return eager_ms(lambda: eng.matmul_float(x, w, site=site, fold=0, bias=b))


def sliced_case(torch, K, dpu, r, k, c, plane_bits, site, gen, rows_out, card, *, prng_key=None, model="qwen2-0.5b"):
    """One bit-sliced GEMM, ``PhotonicEngine.int_gemm(slicing=plane_bits)``
    on CUDA int8 operands (the kernel backend: P^2 unfused ``photonic_gemm``
    plane passes), against the same call with every pass through the twin
    on the same card; ideal rows also against ``exact_int_gemm``.  Times:
    the P^2 kernel launches alone on the plane operands the engine made
    (CUDA graph), the engine's whole sliced call on the device (CUDA graph:
    slicing, hashing, seeds, the passes, the shift-add), the call with twin
    passes (host-timed), and ``torch._int_mm`` of the same int8 GEMM (rows
    padded to 32 where fewer).  Appends a result dict to ``rows_out``."""
    import repro_torch.photonic.engine as E
    from repro_torch.kernels.photonic_gemm.ref import exact_int_gemm
    from repro_torch.photonic.slicing import SlicingSpec

    dev = torch.device("cuda")
    eng = E.PhotonicEngine(dpu=dpu, backend="kernel")
    spec = SlicingSpec(plane_bits)
    pe = E._plane_engine(eng.with_slicing(spec), spec)
    stages, _ = E.kernel_stages(pe.dpu, r, k, c)
    planes = spec.num_planes(dpu.operand_bits)
    noisy = stages["noise_sigma"] > 0.0
    ideal = dpu.effective_channel() is None
    x = torch.randint(-127, 128, (r, k), generator=gen, device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, c), generator=gen, device=dev, dtype=torch.int8)
    kw = dict(site=site, fold=0, slicing=spec, prng_key=prng_key)
    kernel, calls = E.photonic_gemm, []

    def record(*a, **k_):
        calls.append((a, k_))
        return kernel(*a, **k_)

    def twin(xp, wp, seed, rows=None, **st):
        return K.photonic_gemm_twin(xp, wp, seed, **st)

    n0 = K.LAUNCHES["photonic_gemm"]
    try:
        E.photonic_gemm = record
        y_k = eng.int_gemm(x, w, **kw)
        E.photonic_gemm = twin
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y_t = eng.int_gemm(x, w, **kw)
        torch.cuda.synchronize()
        t_ms = (time.perf_counter() - t0) * 1e3  # the twin passes are slow: timed once
    finally:
        E.photonic_gemm = kernel
    launched = K.LAUNCHES["photonic_gemm"] - n0
    exact = exact_int_gemm(x, w).to(torch.int64)
    diff = (y_k.to(torch.int64) - y_t.to(torch.int64)).abs()
    err = float(diff.max())
    # Agreement: bitwise for deterministic channels; with detector noise a
    # pass's psum may round one LSB apart (ulp-close draws): at most 0.1% of
    # elements per pass, each by at most two LSBs of the top plane pass.
    top = 2 * 2 ** (2 * plane_bits * (planes - 1))
    if noisy:
        ok = float((diff > 0).to(torch.float64).mean()) <= 1e-3 * planes**2 and err <= top
        tol = f"noisy: <= {0.1 * planes**2:g}% elements off, <= 2 top-pass LSB ({top})"
    else:
        ok = err == 0.0
        tol = "bitwise"
    if ideal:
        ok = ok and bool(torch.equal(y_k.to(torch.int64), exact))
        tol += ", == exact_int_gemm"
    err_sliced = float((y_k.to(torch.int64) - exact).abs().to(torch.float64).mean())
    err_plain = float((eng.int_gemm(x, w, site=site, fold=0, prng_key=prng_key).to(torch.int64) - exact)
                      .abs().to(torch.float64).mean())
    k_ms = graph_ms(lambda: [kernel(*a, **k_) for a, k_ in calls])
    e_ms = graph_ms(lambda: eng.int_gemm(x, w, **kw))
    # The int core's yardstick, whatever the channel: torch._int_mm of the
    # same int8 GEMM, on the rows padded to 32 where fewer (its least row
    # count is 17).
    xi = torch.zeros((max(r, 32), k), dtype=torch.int8, device=dev)
    xi[:r] = x
    lib_ms = graph_ms(lambda: torch._int_mm(xi, w))
    xdots = int(stages["intermod_eps"] > 0) + int(stages["crossweight_eps"] > 0)
    draws = r * c * -(-k // stages["n_chunk"]) * planes**2 if noisy else 0
    parts = bound_ms(r, k, c, 1, planes**2, xdots, False, False, draws)
    b_ms, b_by = bound_of([parts])
    chan = "ideal" if ideal else dpu.organization
    rows_out.append(dict(
        model=model, keyed=prng_key is not None,
        site=site, R_live=r, K=k, C=c, channel=chan, plane_bits=plane_bits, passes=planes**2,
        ms=k_ms, engine_ms=e_ms, plain_ms=t_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
        parts=parts, draws=draws, max_abs_err=err, tolerance=tol, ok=ok, launches=launched,
        mean_abs_err_to_exact=err_sliced, unsliced_mean_abs_err_to_exact=err_plain,
    ))
    log(f"  sliced {'' if model == 'qwen2-0.5b' else model + ' '}{site:7s}{' keyed' if prng_key is not None else ''} "
        f"R={r:3d} K={k:4d} C={c:5d} {chan:5s} p={plane_bits}: {planes**2} passes, kernel "
        f"{k_ms:.4f} ms, engine {e_ms:.4f} ms, twin passes {t_ms:.3f} ms, _int_mm "
        f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, bound {b_ms:.5f} ms ({b_by}), {launched} "
        f"launches, max_abs_err {err:.3g} [{tol}], mean |y - exact| {err_sliced:.2f} (unsliced "
        f"{err_plain:.2f}) -> {'ok' if ok else 'MISMATCH'} [{card}]")
    return ok


def build_kernels(libs) -> None:
    """Build every kernel source at once (one ``nvcc`` each, started
    together) with ``-Xptxas -v``, and log each build's seconds."""
    from concurrent.futures import ThreadPoolExecutor

    def one(lib):
        t0 = time.perf_counter()
        return lib.build(verbose=True), time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as ex:
        done = [(lib, ex.submit(one, lib)) for lib in libs]
    for lib, fut in done:
        path, secs = fut.result()
        log(f"  built {path.relative_to(ROOT)} in {secs:.2f} s; SASS {sass_counts(path)}")
        lib.load()
    log(f"  all {len(libs)} kernel sources built in {time.perf_counter() - t0:.2f} s")


def keys_phase(torch, card):
    """The port's ``prng`` (JAX's threefry2x32) on the card against the
    same calls on the CPU and against ``KEY_ANSWERS``: keys, 8/16/32-bit
    words and f32 uniform bits exactly; ``categorical`` of the bf16 row of
    151,936 logits under four per-row keys exactly, on both devices.  The
    Gumbel noise of a (4, 151936) draw on the card is compared with the CPU
    draw's (their f32 ``log`` may round apart; counted, not gated); the
    vectorized draw over the four rows is timed.  Returns (ok, result)."""
    from repro_torch import prng

    c = KEY_ANSWERS
    key = prng.PRNGKey(c["seed"])
    checks = {
        "fold_in": prng.fold_in(key, c["fold"]).tolist() == c["fold_in"],
        "split": prng.split(key, 3).tolist() == c["split"],
    }
    n = c["n_bits"]
    row = torch.from_numpy(np.random.default_rng(c["row_seed"]).standard_normal(c["vocab"]).astype(np.float32) * 3)
    row = row.to(torch.bfloat16)
    keys = np.stack([prng.fold_in(prng.fold_in(key, u), i) for u, i in c["uid_n"]])
    for dev in ("cpu", "cuda"):
        for bits in (8, 16, 32):
            got = prng.random_bits(key, bits, (n,), device=dev)
            checks[f"bits{bits} {dev}"] = got.device.type == dev and got.cpu().tolist() == c[f"bits{bits}"]
        u = prng.uniform(key, (n,), torch.float32, device=dev).cpu().view(torch.int32).to(torch.int64)
        checks[f"uniform {dev}"] = (u & 0xFFFFFFFF).tolist() == c["uniform_f32_bits"]
        rows = row.to(dev)[None, :].expand(len(keys), -1)
        rows = rows / torch.full((), 0.8, dtype=rows.dtype, device=dev)  # the samplers' spelling
        checks[f"categorical {dev}"] = prng.categorical(keys, rows).cpu().tolist() == c["categorical"]
        z = prng.normal(key, (n,), device=dev).cpu().view(torch.int32).to(torch.int64)
        checks[f"normal {dev}"] = (z & 0xFFFFFFFF).tolist() == c["normal_f32_bits"]
        big_z = prng.normal(key, (c["n_normal"],), device=dev).cpu().numpy()
        checks[f"normal x {c['n_normal']} sha256 {dev}"] = hashlib.sha256(big_z.tobytes()).hexdigest() == \
            c["normal_sha256"]
        checks[f"randint int8 {dev}"] = prng.randint(key, (n,), -127, 128, device=dev).to(torch.int8).cpu().tolist() \
            == c["randint8"]
    big = (4, c["vocab"])
    same_bits = torch.equal(prng.random_bits(keys, 32, big[1:], device="cuda").cpu(),
                            prng.random_bits(keys, 32, big[1:], device="cpu"))
    checks["bits32 (4 x 151936) cuda == cpu"] = same_bits
    diffs = {}
    for dt in (torch.bfloat16, torch.float32):
        a = prng.gumbel(keys, big[1:], dt, device="cuda").cpu().float()
        b = prng.gumbel(keys, big[1:], dt, device="cpu").float()
        diffs[str(dt).removeprefix("torch.")] = (int((a != b).sum()), float((a - b).abs().max()))
    rows = (row.to("cuda")[None, :].expand(4, -1) / torch.full((), 0.8, dtype=torch.bfloat16, device="cuda"))
    ms = eager_ms(lambda: prng.categorical(keys, rows), reps=5)
    ok = all(checks.values())
    for name, good in checks.items():
        log(f"  {name}: {'ok' if good else 'MISMATCH'}")
    log(f"  gumbel (4 x 151936) cuda vs cpu, elements apart and max |diff|: {diffs} (not gated)")
    log(f"  categorical of 4 bf16 rows of 151936 under 4 keys on the card: {ms:.3f} ms host-timed; "
        f"draws {prng.categorical(keys, rows).tolist()} == {c['categorical']} [{card}]")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prng.normal(key, (c["n_normal"],), device="cuda")
    torch.cuda.synchronize()
    normal_s = time.perf_counter() - t0
    log(f"  normal of {c['n_normal']} f32 draws on the card: {normal_s:.4f} s host-timed [{card}]")
    return ok, dict(checks=checks, gumbel_cuda_vs_cpu=diffs, categorical_ms=ms, normal_s=normal_s)


def flash_case(torch, F, case, gen, rows_out, card):
    """One flash-attention case at the block sizes ``ops.flash_attention``
    picks: f32 against the twin, bf16 against the f64 bound; appends a
    result dict to ``rows_out``."""
    from repro_torch.kernels.flash_attention.ref import gate_ratio, oracle_and_bound

    label, b, tq, tk, h, kvh, hd, causal, q_offset, kv_valid, dt = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    dev = torch.device("cuda")
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((b, tq, h, hd), (b, tk, kvh, hd), (b, tk, kvh, hd)))
    valid = tk if kv_valid is None else min(kv_valid, tk)
    args = dict(scale=hd**-0.5, causal=causal, q_offset=q_offset, kv_valid=valid, n_rep=h // kvh,
                bq=min(128, -(-tq // 8) * 8), bk=min(128, -(-tk // 8) * 8))
    # SDPA's mask: plain causal where it can say so, else explicit (True = the key takes part).
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    plain_causal = causal and q_offset == 0 and tq == tk and valid == tk
    mask = None
    if not plain_causal and (causal or valid < tk):
        kv_pos = torch.arange(tk, device=dev)
        mask = (kv_pos < valid)[None, :].expand(tq, tk)
        if causal:
            mask = mask & (kv_pos[None, :] <= (q_offset + torch.arange(tq, device=dev))[:, None])
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def run_sdpa():
        return sdpa(qt, kt, vt, attn_mask=mask, is_causal=plain_causal, enable_gqa=True)

    n0 = F.LAUNCHES["flash_attention"]
    y_k = F.flash_attention_fwd(q, k, v, **args)
    y_t = F.flash_attention_fwd_twin(q, k, v, **args)
    torch.cuda.synchronize()
    err = float((y_k.to(torch.float32) - y_t.to(torch.float32)).abs().max())
    finite = bool(torch.isfinite(y_k.to(torch.float32)).all())
    ratios = {}
    if dt == "f32":
        ok, tol = finite and err <= 2e-5, "f32: max abs err to the twin <= 2e-5"
    else:
        o, bound = oracle_and_bound(q, k, v, scale=args["scale"], causal=causal, q_offset=q_offset,
                                    kv_valid=valid, bk=args["bk"])
        for name, y in (("kernel", y_k), ("twin", y_t), ("sdpa", run_sdpa().transpose(1, 2))):
            r = gate_ratio(y, o, bound)
            ratios[name] = (float(r.max()), int((r > 1).sum()))
        del o, bound
        ok = finite and ratios["kernel"][1] == 0
        tol = "bf16: within the f64 bound (worst |got - o| / bound <= 1)"
    k_ms = graph_ms(lambda: F.flash_attention_fwd(q, k, v, **args))
    launched = F.LAUNCHES["flash_attention"] - n0
    t_ms = eager_ms(lambda: F.flash_attention_fwd_twin(q, k, v, **args))
    lib_ms = graph_ms(run_sdpa)
    # Live score entries per (b, h): keys below kv_valid and, when causal,
    # at or before the row's position.
    rows = torch.arange(tq, dtype=torch.int64)
    per_row = torch.full((tq,), valid, dtype=torch.int64)
    if causal:
        per_row = torch.clamp(torch.minimum(per_row, q_offset + rows + 1), min=0)
    live = int(per_row.sum())
    es = 2 if dt == "bf16" else 4
    nbytes = (2 * b * tq * h * hd + 2 * b * tk * kvh * hd) * es
    parts = (nbytes / PEAK_BYTES_PER_S * 1e3, 4.0 * b * h * hd * live / PEAK_FLOPS[dt] * 1e3, 0.0)
    b_ms, b_by = bound_of([parts])
    rows_out.append(dict(
        case=label, B=b, Tq=tq, Tk=tk, H=h, KV=kvh, hd=hd, causal=causal, q_offset=q_offset,
        kv_valid=valid, dtype=dt, bq=args["bq"], bk=args["bk"], ms=k_ms, plain_ms=t_ms,
        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err, bound_ratio=ratios,
        tolerance=tol, ok=ok, launches=launched,
    ))
    gate = " ".join(f"{n} {r[0]:.3f} ({r[1]} over)" for n, r in ratios.items())
    log(f"  {label:12s} B={b} Tq={tq:4d} Tk={tk:4d} H={h} KV={kvh} hd={hd} causal={int(causal)} "
        f"q_offset={q_offset} kv_valid={valid} {dt}: kernel {k_ms:.4f} ms, twin {t_ms:.3f} ms, "
        f"sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), {launched} launches, max |kernel - twin| "
        f"{err:.3g}{'; |got - o| / bound: ' + gate if gate else ''} [{tol}] -> {'ok' if ok else 'MISMATCH'} [{card}]")
    return ok


def p_term_libraries():
    """The flash source rebuilt with P in each other count of bf16 terms
    (``kPTerms``) from one to three, as ``{terms: CudaLibrary}``, and the
    shipped count."""
    import re

    from repro_torch.kernels._build import CudaLibrary, build_dir
    from repro_torch.kernels.flash_attention import kernel as F

    src = (ROOT / FLASH_SRC).read_text()
    found = re.search(r"constexpr int kPTerms = (\d);", src)
    if found is None:
        raise RuntimeError(f"{FLASH_SRC} has no 'constexpr int kPTerms = <n>;'")
    shipped = int(found.group(1))
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    for n in {1, 2, 3} - {shipped}:
        path = out / f"flash_attention_p{n}.cu"
        path.write_text(src.replace(found.group(0), f"constexpr int kPTerms = {n};"))
        libs[n] = CudaLibrary(path, F._bind)
    return libs, shipped


RACE_LINE = "      if constexpr (!kCompact) __syncthreads();\n"


def photonic_race_library():
    """The photonic source rebuilt without the slice path's barrier between
    weight-slice passes on 64-row CTAs (ROADMAP Queue 3 item 22's cause):
    a ``CudaLibrary`` with the shipped entry point, for ``--phase
    gloo-repro``'s runs on the variant."""
    from repro_torch.kernels._build import CudaLibrary, build_dir
    from repro_torch.kernels.photonic_gemm import kernel as K

    src = (ROOT / FUSED_SRC).read_text()
    if src.count(RACE_LINE) != 1:
        raise RuntimeError(f"{FUSED_SRC} has no single line {RACE_LINE!r}")
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    path = out / "photonic_gemm_race.cu"
    path.write_text(src.replace(RACE_LINE, ""))
    return CudaLibrary(path, K._bind)


def p_terms_phase(torch, F, variants, shipped, gen, card):
    """The bound against the bf16 terms of P, at the ``lm_logits`` shape
    and at the 16-token serve prompt (rows with 1..16 live keys): the twin
    with P rounded to one term, and the kernel built with 1, 2 and 3 terms
    (``shipped`` of them in the shipped source).  Gate, at ``lm_logits``:
    both one-term versions fail the bound and the shipped kernel holds it.
    Returns (ok, rows)."""
    from repro_torch.kernels.flash_attention.ref import gate_ratio, oracle_and_bound

    ok, out = True, []
    libs = {**variants, shipped: F.LIBRARY}
    for label, b, t in (("lm_logits", 2, 1000), ("serve prompt", 4, 16)):
        h, kvh, hd = 14, 2, 64
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for shape in ((b, t, h, hd), (b, t, kvh, hd), (b, t, kvh, hd)))
        args = dict(scale=hd**-0.5, causal=True, q_offset=0, kv_valid=t, n_rep=h // kvh,
                    bq=min(128, -(-t // 8) * 8), bk=min(128, -(-t // 8) * 8))
        o, bound = oracle_and_bound(q, k, v, scale=args["scale"], causal=True, q_offset=0, kv_valid=t,
                                    bk=args["bk"])

        def worst(y):
            r = gate_ratio(y, o, bound)
            return float(r.max()), int((r > 1).sum())

        row = {"case": label, "twin, 1 term": worst(F.flash_attention_fwd_twin(q, k, v, **args, round_p=True))}
        for n in sorted(libs):
            F.LIBRARY = libs[n]
            try:
                y = F.flash_attention_fwd(q, k, v, **args)
                row[f"kernel, {n} terms"] = worst(y) + (graph_ms(lambda: F.flash_attention_fwd(q, k, v, **args)),)
            finally:
                F.LIBRARY = libs[shipped]
        good = True
        if label == "lm_logits":
            good = (row["twin, 1 term"][1] > 0 and row["kernel, 1 terms"][1] > 0
                    and row[f"kernel, {shipped} terms"][1] == 0)
        ok &= good
        out.append(row)
        log(f"  P terms, {label} (B={b} T={t}): worst |got - o| / bound (elements over, ms): "
            + "; ".join(f"{k_} {v_[0]:.3f} ({v_[1]}" + (f", {v_[2]:.4f} ms)" if len(v_) > 2 else ")")
                        for k_, v_ in row.items() if k_ != "case")
            + f" -> {'ok' if good else 'MISMATCH'} [{card}]")
    return ok, out


def profiled(torch, fn, label):
    """Run ``fn()`` under the torch profiler (CPU + CUDA) and log
    ``repro_torch.launch.hlo_analysis.dispatch_summary`` of it: device busy
    milliseconds and share, device events, ``cudaLaunchKernel`` calls, the
    photonic and flash kernels' launches, the top kernels and host ops; the
    full table goes to ``chiprun_out/profile_<label>.txt``.  Returns the
    summary with the profiler's own cost."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import hlo_analysis

    t_enter = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    t_exit = time.perf_counter()
    ka = prof.key_averages()
    t_avg = time.perf_counter()
    summary = hlo_analysis.dispatch_summary(ka, (t1 - t0) * 1e3)
    share = "not measured" if summary["busy_share"] is None else f"{summary['busy_share']:.1%}"
    log(f"  profile {label}: wall {summary['wall_ms']:.1f} ms under the profiler, device busy "
        f"{summary['device_busy_ms']:.1f} ms ({share}), {summary['device_events']} device events, "
        f"{summary['launch_calls']} cudaLaunchKernel calls, photonic launches {summary['photonic_launches']}, "
        f"flash launches {summary['flash_launches']}")
    for name, count, ms in summary["top_kernels"]:
        log(f"    device {ms:9.2f} ms x{count:<6d} {name[:70]}")
    for name, count, ms in summary["top_host_ops"]:
        log(f"    host   {ms:9.2f} ms x{count:<6d} {name[:70]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"profile_{label}.txt").write_text(ka.table(sort_by="self_cpu_time_total", row_limit=60))
    cost = dict(start_s=t0 - t_enter, stop_s=t_exit - t1, key_averages_s=t_avg - t_exit,
                report_s=time.perf_counter() - t_avg)
    log(f"  profiler cost {label}: " + ", ".join(f"{k} {v:.3f}" for k, v in cost.items()))
    return dict(summary, cost=cost)


def serve(torch, arch, params, dpu, backend, prompts, card, label, extra=None, fuse=False, temperature=None,
          new_tokens=8, batch=4):
    """Serve ``prompts`` through the port's Scheduler, greedily or, with a
    ``temperature``, sampled under the reference's keys (seed 0), the model
    config changed by ``extra`` (e.g. ``photonic_slicing``) and, with
    ``fuse``, every layer's Q/K/V fused into one ``wqkv`` bank after the
    scheduler prepacked them."""
    from repro_torch.kernels.flash_attention import kernel as F
    from repro_torch.kernels.photonic_gemm import kernel as K
    from repro_torch.photonic import fuse_qkv_params
    from repro_torch.serving import Request, Scheduler, ServingConfig

    cfg = dataclasses.replace(arch.config, photonic=dpu, photonic_backend=backend, **(extra or {}))
    sampling = {} if temperature is None else dict(greedy=False, temperature=temperature, seed=0)
    sch = Scheduler(
        arch, cfg, params,
        ServingConfig(batch_size=batch, max_seq=128, block_size=16, chunk_tokens=64, record_logits=True,
                      **sampling),
    )
    if fuse:
        for layer in sch.params["layers"]:
            layer["attn"] = fuse_qkv_params(layer["attn"], sch.photonic)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=new_tokens) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    K.reset_launches()
    F.reset_launches()
    t0 = time.perf_counter()
    sch.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(K.LAUNCHES, **F.LAUNCHES)
    st = sch.stats
    forwards = st["prefill_chunks"] + st["decode_steps"]
    toks = sum(len(r.output) for r in reqs)
    finite = all(bool(np.isfinite(row).all()) for r in reqs for row in r.logits)
    decode_ms = st["decode_s"] / max(st["decode_steps"], 1) * 1e3
    log(f"  {label}: {sch.photonic.describe()}: {toks} tokens in {dt:.3f} s = {toks / dt:.2f} tok/s; prefill "
        f"{st['prefill_s']:.3f} s over {st['prefill_chunks']} chunks, decode {decode_ms:.2f} ms/step over "
        f"{st['decode_steps']} steps; fused launches "
        f"{launches['photonic_gemm_fused']}, unfused launches {launches['photonic_gemm']} for "
        f"{forwards} forwards [{card}]")
    done = all(r.done and len(r.output) == new_tokens for r in reqs)
    st = dict(st, seconds=dt, tokens=toks, decode_ms_per_step=decode_ms, tok_per_s=toks / dt)
    return reqs, launches, forwards, done, finite, st


def legacy_serve(torch, arch, params, dpu, backend, impl, prompts, card):
    """Serve ``prompts`` greedily through the port's one-shot
    ``LegacyEngine`` with ``attn_impl=impl``; counts reset just before."""
    from repro_torch.kernels.flash_attention import kernel as F
    from repro_torch.kernels.photonic_gemm import kernel as K
    from repro_torch.runtime.serve import LegacyEngine, ServeConfig
    from repro_torch.serving import Request

    cfg = dataclasses.replace(arch.config, photonic=dpu, photonic_backend=backend, attn_impl=impl)
    eng = LegacyEngine(arch, cfg, params, ServeConfig(batch_size=4, max_seq=128))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    K.reset_launches()
    F.reset_launches()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(K.LAUNCHES, **F.LAUNCHES)
    st = dict(eng.stats)
    toks = sum(len(r.output) for r in reqs)
    st.update(seconds=dt, tokens=toks, tok_per_s=toks / dt,
              decode_ms_per_step=st["decode_s"] / max(st["decode_steps"], 1) * 1e3)
    log(f"  LegacyEngine {backend} backend, attn_impl={impl}: {toks} tokens in {dt:.3f} s = "
        f"{st['tok_per_s']:.2f} tok/s; prefill {st['prefill_s']:.3f} s over {st['prefills']} "
        f"prefills (batch 4), decode {st['decode_ms_per_step']:.2f} ms/step over "
        f"{st['decode_steps']} steps; flash launches {launches['flash_attention']}, fused launches "
        f"{launches['photonic_gemm_fused']} [{card}]")
    done = all(r.done and len(r.output) == 8 for r in reqs)
    return reqs, launches, st, done


def _cast(tree, dtype):
    """The parameter tree with every float leaf cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def oneshot_phase(torch, arch, params, ideal, prompts, card):
    """The one-shot path: ``lm_logits`` at full width (B=2, T=1000) with
    the flash and the chunked attention core, then ``LegacyEngine`` runs
    (flash on the kernel and ``ref`` backends, chunked on the kernel
    backend).  Gates: launch counts, finite logits, flash-vs-chunked
    logits, and kernel-vs-ref tokens.

    ``lm_logits`` runs in three numerics.  bf16 on the ideal channel and
    kernel backend is the served model; bf16 with digital GEMMs drops the
    int8 activation quantization; f32 with digital GEMMs has no rounding
    step at all.  Each also runs chunked attention with the flash
    kernel's key block (``attn_chunk=128``): the same maths as chunked
    at its own chunk, summed in other blocks, with no kernel involved.
    That witness measures how far the model carries a float-rounding
    difference of its attention core.  In f32 the cores must agree
    (<= 1e-4 of max |logit|, every argmax equal).  In bf16 flash may be
    no further from chunked than the witness allows: relative error
    <= max(2e-2, 2 x the witness's), disagreeing argmaxes <= max(1%,
    2 x the witness's), which is the 2e-2 / 99% gate wherever the model
    does not amplify rounding."""
    from repro_torch.kernels.flash_attention import kernel as F
    from repro_torch.kernels.photonic_gemm import kernel as K
    from repro_torch.models import lm
    from repro_torch.serving import prepack_serving_params

    n_layers = arch.config.num_layers
    ok = True
    res = {"flash_launches": 0, "lm_logits": {}}
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, arch.config.vocab_size, (2, 1000)), device="cuda")
    f32 = torch.float32

    def compare(a, b):
        a, b = a.float(), b.float()
        return float((a - b).abs().max() / b.abs().max()), float((a.argmax(-1) == b.argmax(-1)).float().mean())

    for label, kw in (
        ("bf16, ideal channel, kernel backend", dict(photonic=ideal, photonic_backend="kernel")),
        ("bf16, digital GEMMs", {}),
        ("f32, digital GEMMs", dict(param_dtype=f32, compute_dtype=f32)),
    ):
        base = dataclasses.replace(arch.config, **kw)
        photonic = base.photonic is not None
        with torch.no_grad():
            run_params = _cast(params, f32) if base.compute_dtype == f32 else params
            _, packed = prepack_serving_params(arch, base, run_params)
            logits = {}
            for name, impl, chunk in (("flash", "flash", base.attn_chunk),
                                      ("chunked", "chunked", base.attn_chunk),
                                      ("chunked_128", "chunked", 128)):
                torch.cuda.synchronize()
                K.reset_launches()
                F.reset_launches()
                record = photonic and name == "flash"  # the analytic phase's graph-vs-executed records
                t0 = time.perf_counter()
                with recorded_gemm_calls() if record else contextlib.nullcontext([]) as calls:
                    logits[name], _ = lm.lm_logits(
                        packed, tokens, dataclasses.replace(base, attn_impl=impl, attn_chunk=chunk))
                torch.cuda.synchronize()
                if record:
                    res["gemm_calls"] = calls
                dt = time.perf_counter() - t0
                want, want_fused = (n_layers if impl == "flash" else 0), (6 * n_layers if photonic else 0)
                finite = bool(torch.isfinite(logits[name].float()).all())
                good = (finite and F.LAUNCHES["flash_attention"] == want
                        and K.LAUNCHES["photonic_gemm_fused"] == want_fused)
                res["flash_launches"] += F.LAUNCHES["flash_attention"]
                log(f"  lm_logits {label}, attn_impl={impl} attn_chunk={chunk}: {dt:.3f} s; flash "
                    f"launches {F.LAUNCHES['flash_attention']} == {want}, fused launches "
                    f"{K.LAUNCHES['photonic_gemm_fused']} == {want_fused}, finite {finite}: {good} [{card}]")
                ok &= good
            rel, agree = compare(logits["flash"], logits["chunked"])
            w_rel, w_agree = compare(logits["chunked_128"], logits["chunked"])
            del logits, packed, run_params
        torch.cuda.empty_cache()
        if base.compute_dtype == f32:
            max_rel, min_agree = 1e-4, 1.0
        else:
            max_rel, min_agree = max(2e-2, 2 * w_rel), 1.0 - max(0.01, 2 * (1.0 - w_agree))
        good = rel <= max_rel and agree >= min_agree
        log(f"  lm_logits {label}, over 2 x 1000 positions, max |dlogit| / max |logit| and argmax "
            f"agreement: flash vs chunked {rel:.4g}, {agree:.4f}; witness chunked at 128 vs chunked at "
            f"{base.attn_chunk} {w_rel:.4g}, {w_agree:.4f} (gate: flash vs chunked <= {max_rel:.4g} and "
            f">= {min_agree:.4f}): {good} [{card}]")
        ok &= good
        res["lm_logits"][label] = dict(rel_err=rel, argmax_agreement=agree, witness_rel_err=w_rel,
                                       witness_argmax_agreement=w_agree, max_rel_err=max_rel,
                                       min_argmax_agreement=min_agree)

    runs = {}
    for label, backend, impl in (("flash", "kernel", "flash"), ("flash_ref", "ref", "flash"),
                                 ("chunked", "kernel", "chunked")):
        reqs, launches, st, done = legacy_serve(torch, arch, params, ideal, backend, impl, prompts, card)
        forwards = st["prefills"] + st["decode_steps"]
        want_flash = n_layers * st["prefills"] if impl == "flash" else 0
        want_fused = 6 * n_layers * forwards if backend == "kernel" else 0
        good = (done and launches["flash_attention"] == want_flash
                and launches["photonic_gemm_fused"] == want_fused and launches["photonic_gemm"] == 0)
        log(f"  {label}: all done {done}, flash launches {launches['flash_attention']} == {want_flash}, "
            f"fused launches {launches['photonic_gemm_fused']} == {want_fused}: {good}")
        ok &= good
        if impl == "flash":
            res["flash_launches"] += launches["flash_attention"]
        runs[label] = reqs
        res[f"legacy_{label}"] = st
        torch.cuda.empty_cache()
    same = all(a.output == b.output for a, b in zip(runs["flash"], runs["flash_ref"]))
    log(f"  LegacyEngine flash: ideal kernel tokens == ideal ref tokens: {same}")
    for a, b, c in zip(runs["flash"], runs["flash_ref"], runs["chunked"]):
        log(f"    uid {a.uid}: kernel {a.output} ref {b.output} chunked {c.output}")
    ok &= same
    res["ok"] = ok
    return res


EXAMPLES = {  # module -> arguments: the reference scripts' sizes, on the card
    "quickstart": [],
    "serve_lm": [],
    "train_lm": ["--steps", "20", "--photonic"],
    "map_workload": [],
    "paper_repro": [],
}


def reference_digests(torch, params, defs) -> dict:
    """sha256 of each leaf of ``params`` in the reference's layout: a
    per-layer list's tensors in order, which is the stacked leaf's bytes."""
    from repro_torch.models.common import reference_defs

    def parts(node, path):
        if isinstance(node, list):
            return [t for sub in node for t in parts(sub, path)]
        if path:
            return parts(node[path[0]], path[1:])
        return [node]

    def paths(ref, pre=()):
        if isinstance(ref, dict):
            for k in sorted(ref):
                yield from paths(ref[k], pre + (k,))
        else:
            yield pre

    out = {}
    for path in paths(reference_defs(defs)):
        h = hashlib.sha256()
        for t in parts(params, path):
            h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
        out["/".join(path)] = h.hexdigest()
    return out


def start_examples(ckpt_dir) -> tuple:
    """Every example of ``repro_torch.examples`` started as its own process
    on the card, all at once (``train_lm`` checkpointing into
    ``ckpt_dir``).  Returns (processes by name, start time)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    t0 = time.perf_counter()
    procs = {}
    for name, args in EXAMPLES.items():
        extra = ["--ckpt-dir", ckpt_dir] if name == "train_lm" else []
        procs[name] = subprocess.Popen([sys.executable, "-m", f"repro_torch.examples.{name}", "--device", "cuda",
                                        *args, *extra], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    return procs, t0


def finish_examples(procs, t0, card) -> tuple:
    """Wait for :func:`start_examples`' processes (each killed after 300 s)
    and print their output; each must exit 0, and quickstart must hold the
    CUDA kernel to its twin.  Returns (ok, result)."""
    res = {}
    for name, proc in procs.items():
        try:
            out, _ = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        res[name] = dict(rc=proc.returncode, seconds=time.perf_counter() - t0, output=out)
    ok = True
    for name, r in res.items():
        lines = r["output"].splitlines()
        log(f"  example {name} (exit {r['rc']}, done {r['seconds']:.1f} s after the start), its output:")
        for line in lines[-40:] if name != "map_workload" else [x for x in lines if x.strip()][-12:]:
            log(f"    | {line}")
        ok &= r["rc"] == 0
    twin = "  cuda kernel == twin: True" in res["quickstart"]["output"].splitlines()
    log(f"  examples all exit 0: {all(r['rc'] == 0 for r in res.values())}; quickstart's cuda kernel == twin: "
        f"{twin}; wall {time.perf_counter() - t0:.1f} s for the five [{card}]")
    return ok and twin, {name: dict(rc=r["rc"], seconds=r["seconds"]) for name, r in res.items()}


def init_phase(torch, registry, card):
    """The reference's weight init and its examples on the port (module
    docstring, phase 6i).  Returns (ok, result, fused launches of (b)'s
    kernel run)."""
    arch = registry.get("qwen2-0.5b")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_lm_")
    procs, t_examples = start_examples(ckpt_dir)  # (c) runs beside (a) and (b)
    try:
        ok, res = _init_and_serve(torch, arch, card)
        examples_ok, res["c"] = finish_examples(procs, t_examples, card)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return ok and examples_ok, res, res["b"]["fused_launches"]


def _init_and_serve(torch, arch, card) -> tuple:
    """Phase 6i (a) and (b).  Returns (ok, result)."""
    from repro_torch import prng
    from repro_torch.models.common import init_params

    res, ok = {}, True
    # (a) full-width qwen2-0.5b from PRNGKey(0), held to the reference's leaves.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(arch.config, prng.PRNGKey(0), "cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    t0 = time.perf_counter()
    digests = reference_digests(torch, params, arch.param_defs(arch.config))
    hash_s = time.perf_counter() - t0
    want = KEY_ANSWERS["qwen2_init_sha256"]
    bad = sorted(p for p in set(want) | set(digests) if digests.get(p) != want.get(p))
    good = not bad
    log(f"  (a) init_params(qwen2-0.5b full width, PRNGKey(0)) on the card: {draw_s:.3f} s, peak "
        f"{peak / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB it keeps; {len(digests)} leaves hashed in "
        f"{hash_s:.3f} s; sha256 == the reference's init_tree: {good}" + (f", apart: {bad}" if bad else "")
        + f" [{card}]")
    res["a"] = dict(draw_s=draw_s, peak_bytes=peak, held_bytes=held, hash_s=hash_s, leaves_apart=bad)
    ok &= good
    # (b) served from those weights, the kernel backend's logits bitwise the ref backend's.
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, arch.config.vocab_size, 8).astype(np.int32) for _ in range(4)]
    runs = {}
    for backend in ("kernel", "ref"):
        runs[backend] = serve(torch, arch, params, ideal_dpu(), backend, prompts, card, f"(b) ideal {backend}")
        torch.cuda.empty_cache()
    (kreqs, klaunch, kforwards, kdone, kfinite, kst), (rreqs, rlaunch, _, rdone, rfinite, rst) = runs.values()
    same = all(len(a.logits) == len(b.logits) and all(np.array_equal(x, y) for x, y in zip(a.logits, b.logits))
               for a, b in zip(kreqs, rreqs))
    expect = 6 * arch.config.num_layers * kforwards
    good = (same and kdone and rdone and kfinite and klaunch["photonic_gemm_fused"] == expect
            and rlaunch["photonic_gemm_fused"] == 0)
    log(f"  (b) 4 requests x 8 tokens: kernel logits bitwise the ref backend's: {same}; fused launches "
        f"{klaunch['photonic_gemm_fused']} == {expect} (ref 0): {good}")
    for a in kreqs:
        log(f"    uid {a.uid}: {a.output}")
    res["b"] = dict(kernel=kst, ref=rst, tokens=[a.output for a in kreqs], logits_bitwise=same,
                    fused_launches=klaunch["photonic_gemm_fused"])
    ok &= good
    del params, runs, kreqs, rreqs
    torch.cuda.empty_cache()
    return ok, res


def _leaf_digest(t) -> bytes:
    import torch

    return hashlib.sha256(t.detach().contiguous().view(torch.uint8).reshape(-1).cpu().numpy()).digest()


def _fingerprint(tree) -> str:
    """A sha256 over the sha256 of every leaf's bytes in the tree's walk
    order, the leaves copied and hashed on eight threads (a training
    state of a few GB would take tens of seconds on one)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch._tree import tree_leaves

    with ThreadPoolExecutor(8) as pool:
        digests = list(pool.map(_leaf_digest, tree_leaves(tree)))
    return hashlib.sha256(b"".join(digests)).hexdigest()[:16]


def train_phase(torch, arch, ideal, card):
    """Full-width training in four modes (module docstring, phase 7).
    Returns (ok, result dict, fused launches of the main-path run (a))."""
    from repro_torch import prng
    from repro_torch._tree import tree_map
    from repro_torch.checkpoint import ckpt
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens, make_global_batch
    from repro_torch.kernels.flash_attention import kernel as F
    from repro_torch.kernels.photonic_gemm import kernel as K
    from repro_torch.models.common import init_params
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import TrainConfig, build_train_step, train

    n_layers = arch.config.num_layers
    data = DataConfig(vocab_size=arch.config.vocab_size, seq_len=1024, global_batch=4, seed=0)
    tokens = data.global_batch * data.seq_len
    opt = adamw.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    stream = SyntheticTokens(data)
    ok, res = True, {}

    def rates(label, secs, launches, extra=""):
        per = statistics.median(secs[1:] or secs)
        peak = torch.cuda.max_memory_allocated()
        res[label].update(s_per_step=per, tokens_per_s=tokens / per, max_memory_allocated=peak,
                          step_seconds=secs, launches=launches)
        log(f"  train {label}: {per:.4f} s/step ({'median of steps 2-' + str(len(secs)) if len(secs) > 1 else 'one step'}; "
            f"all {[round(x, 4) for x in secs]}), "
            f"{tokens / per:.1f} tokens/s, max_memory_allocated {peak / 2**30:.2f} GiB, fused launches "
            f"{launches['photonic_gemm_fused']} ({launches['photonic_gemm_fused'] / len(secs):.0f}/step), "
            f"flash {launches['flash_attention']}{extra} [{card}]")

    def reset():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        F.reset_launches()

    first = {}

    def steps(cfg, n=TRAIN_STEPS):
        """(params, losses, grad norms, seconds, launches): ``n`` steps of
        build_train_step from train()'s first weights (``PRNGKey(0)``, drawn
        once and copied for each mode); counts reset first."""
        if "params" not in first:
            first["params"] = init_params(cfg, prng.PRNGKey(0), "cuda", defs=arch.param_defs(cfg))
        params = tree_map(torch.clone, first["params"])
        state = adamw.init(params)
        step = build_train_step(lambda p, b: arch.loss(p, b, cfg), opt)
        reset()
        losses, norms, secs = [], [], []
        for i in range(n):
            t0 = time.time()
            params, state, m = step(params, state, make_global_batch(stream, i, "cuda"))
            losses.append(float(m["loss"]))
            secs.append(time.time() - t0)
            norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        return params, losses, norms, secs, dict(K.LAUNCHES, **F.LAUNCHES)

    torch.use_deterministic_algorithms(True)
    try:
        # (a) the entry point: train() into a temporary checkpoint directory.
        cfg_a = dataclasses.replace(arch.config, photonic=ideal, photonic_backend="kernel")
        ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        try:
            reset()
            t0 = time.perf_counter()
            out = train(arch=arch, model_cfg=cfg_a, data_cfg=data,
                        train_cfg=TrainConfig(steps=TRAIN_STEPS, ckpt_every=1000, ckpt_dir=ckpt_dir, log_every=1),
                        opt_cfg=opt, log=lambda m: log(f"    {m}"), device="cuda")
            wall = time.perf_counter() - t0
            main_launches = dict(K.LAUNCHES, **F.LAUNCHES)
            step_dir = Path(ckpt_dir) / f"step_{TRAIN_STEPS:08d}"
            saved = ckpt.latest_step(ckpt_dir) == TRAIN_STEPS
            size = sum(f.stat().st_size for f in step_dir.iterdir()) if saved else 0
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        res["a"] = dict(losses=out["losses"], wall_s=wall, checkpoint_s=out["checkpoint_seconds"],
                        checkpoint_bytes=size)
        rates("a", out["step_seconds"], main_launches)
        log(f"  train a: train() wall {wall:.3f} s; end-of-run checkpoint (step {TRAIN_STEPS}, "
            f"{size / 1e9:.3f} GB) saved: {saved}, loop blocked on it {out['checkpoint_seconds']:.3f} s [{card}]")
        good = (saved and all(np.isfinite(out["losses"]))
                and main_launches["photonic_gemm_fused"] == 6 * n_layers * 2 * TRAIN_STEPS
                and main_launches["photonic_gemm"] == 0 and main_launches["flash_attention"] == 0)
        log(f"  train a: losses {out['losses']}, fused launches {main_launches['photonic_gemm_fused']} == "
            f"{6 * n_layers * 2 * TRAIN_STEPS}, flash 0, checkpoint saved: {good}")
        ok &= good
        params_a, fp_a = out["params"], _fingerprint(out["params"])
        res["a"]["fingerprint"] = fp_a
        del out

        # (b) exact backend, (d) no remat, (e) remat_policy "dots":
        # build_train_step on the same batches.  (d) and (e) take one step
        # (their gates read no later one; cut for the run's limit).
        for label, cfg, n in (
            ("b", dataclasses.replace(cfg_a, photonic_backend="exact"), TRAIN_STEPS),
            ("d", dataclasses.replace(cfg_a, remat=False), 1),
            ("e", dataclasses.replace(cfg_a, remat_policy="dots"), 1),
        ):
            params, losses, norms, secs, launches = steps(cfg, n)
            res[label] = dict(losses=losses, grad_norms=norms)
            gap = [abs(a - b) for a, b in zip(losses, res["a"]["losses"])]
            rates(label, secs, launches, f"; losses {losses}, grad norms {norms}, |loss - loss_a| {gap}")
            if label == "b":
                same = losses == res["a"]["losses"]
                fp = _fingerprint(params)
                good = same and fp == fp_a and launches["photonic_gemm_fused"] == 0
                log(f"  train b: losses bitwise equal to (a)'s: {same}; final params sha256 {fp} vs (a) "
                    f"{fp_a}: {good}")
            elif label == "d":
                good = (losses[0] == res["a"]["losses"][0]
                        and launches["photonic_gemm_fused"] == 6 * n_layers * n)
                log(f"  train d: step-1 loss bitwise equal to (a)'s, {launches['photonic_gemm_fused']} == "
                    f"{6 * n_layers * n} fused launches: {good}")
            else:
                # The kernel is no product the policy saves: recomputed, as under "full".
                same = losses[0] == res["a"]["losses"][0] and norms[0] == res["b"]["grad_norms"][0]
                good = same and launches["photonic_gemm_fused"] == 6 * n_layers * 2 * n
                log(f"  train e (remat_policy dots): step-1 loss and grad norm bitwise (a)'s / (b)'s: {same}; "
                    f"{launches['photonic_gemm_fused']} == {6 * n_layers * 2 * n} fused launches: {good}")
            ok &= good
            del params
        del params_a, first["params"]
    finally:
        torch.use_deterministic_algorithms(False)
        torch.cuda.empty_cache()
    return ok, res, main_launches


def _open_gates(params):
    """Both gates of every cross layer to 0.5: at their zero init a cross
    layer is the identity, and a broken cross path would agree with
    itself."""
    for c in params["cross"]:
        c["gate_ffn"].fill_(0.5)
        c["attn"]["gate"].fill_(0.5)


def busy_share(torch, fn):
    """Run ``fn()`` while ``nvidia-smi`` samples the card's NVML
    ``utilization.gpu`` (the share of each sample period in which a kernel
    ran) every 100 ms; returns (mean % over the samples taken while ``fn``
    ran, sample count).  The torch profiler's report takes minutes over the
    400,000 launches of an xLSTM training step, this costs nothing."""
    from datetime import datetime

    proc = subprocess.Popen(["nvidia-smi", "-i", "0", "--query-gpu=timestamp,utilization.gpu",
                             "--format=csv,noheader,nounits", "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(1.0)  # nvidia-smi's start-up
        t0 = datetime.now()
        fn()
        torch.cuda.synchronize()
        t1 = datetime.now()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    vals = []
    for line in out.splitlines():
        stamp, _, util = line.partition(",")
        try:
            at = datetime.strptime(stamp.strip(), "%Y/%m/%d %H:%M:%S.%f")
            if t0 <= at <= t1:
                vals.append(float(util))
        except ValueError:
            continue
    return (statistics.mean(vals) if vals else float("nan")), len(vals)


def _one_more(step, params, state, batch):
    """(one more training step from ``params`` / ``state`` as a call, the
    params), holding the only references the caller keeps."""
    return (lambda: step(params, state, batch), params)


def train_families_phase(torch, registry, card):
    """Training the non-dense families at full width (module docstring,
    phase 7b).  Returns (ok, result dict, fused launches of the main-path
    runs)."""
    from repro_torch import prng
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.checkpoint import ckpt
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens, make_global_batch
    from repro_torch.kernels.flash_attention import kernel as F
    from repro_torch.kernels.photonic_gemm import kernel as K
    from repro_torch.models.common import init_params
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import TrainConfig, _value_and_grad, build_train_step, train

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    # (arch, layers kept or None, fused launches a step, entry point, extra
    # batch input, decoder tokens a sequence, steps, SMWA steps).  One SMWA
    # step shows the noisy forward and backward finite (a zamba2 step takes
    # 25 s under SMWA, llama-3.2-vision's group 40 s, so that group runs
    # none).
    specs = [
        ("xlstm-350m", XLSTM_TRAIN_LAYERS, XLSTM_TRAIN_LAUNCHES, "train", None, 1024, TRAIN_STEPS, 1),
        ("zamba2-2.7b", ZAMBA_TRAIN_LAYERS, ZAMBA_TRAIN_LAUNCHES, "train", None, 1024, TRAIN_STEPS, 1),
        ("deepseek-v2-lite-16b", V2_TRAIN_LAYERS, V2_TRAIN_LAUNCHES, "step", None, 1024, TRAIN_STEPS, 1),
        ("whisper-medium", None, WHISPER_TRAIN_LAUNCHES, "step", "audio_embed", WHISPER_TRAIN_TOKENS, 1, 1),
        ("llama-3.2-vision-90b", VISION_TRAIN_LAYERS, VISION_TRAIN_LAUNCHES, "grads", "vision", 1024, 1, 0),
    ]
    ok, res, total = True, {}, 0

    def reset():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        F.reset_launches()

    torch.use_deterministic_algorithms(True)
    try:
        for name, layers, per_step, entry, extra, seq, n_steps, smwa_steps in specs:
            t0 = time.perf_counter()
            arch = registry.get(name)
            cfg = arch.config if layers is None else dataclasses.replace(arch.config, num_layers=layers)
            data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=4, seed=0)
            stream = SyntheticTokens(data)
            batches = [make_global_batch(stream, i, "cuda") for i in range(n_steps + 1)]  # + the busy step's
            if extra:
                side = torch.randn((4, 1500 if extra == "audio_embed" else cfg.vision_seq, cfg.d_model),
                                   generator=gen, device="cuda").to(cfg.compute_dtype)
                for b in batches:
                    b[extra] = side
            tokens = data.global_batch * seq
            opt = adamw.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
            out = {"layers": cfg.num_layers, "entry": entry, "launches_per_step": per_step}
            cfg_a = dataclasses.replace(cfg, photonic=ideal_dpu(), photonic_backend="kernel")
            log(f"  {name}: {'all' if layers is None else layers} of {arch.config.num_layers} layers, bf16, "
                + ("init_params(PRNGKey(0)), train()'s draw" if entry == "train" else "init_params seed 0")
                + ("; gates at 0.5" if extra == "vision" else "")
                + f"; {entry}, batch 4 x {seq} tokens" + (f" with {extra} {tuple(side.shape)}" if extra else ""))

            first = {}

            def init(cfg_):
                if entry == "train":  # train() draws from PRNGKey(0): the other modes start where it does
                    if "params" not in first:
                        first["params"] = init_params(cfg_, prng.PRNGKey(0), "cuda", defs=arch.param_defs(cfg_))
                    params = tree_map(torch.clone, first["params"])
                else:
                    params = init_params(cfg_, 0, "cuda", defs=arch.param_defs(cfg_))
                if extra == "vision":
                    _open_gates(params)
                if name == "xlstm-350m":
                    # The sLSTM's recurrent r inits at std 1/sqrt(num_heads), its
                    # fan over the head axis (the reference's P(fan_axis=0)):
                    # 0.5 here, and the backward through 1024 steps overflows
                    # (ROADMAP Queue 3 item 12).  The fan-in of its contraction
                    # is head_dim: scale r to std 1/sqrt(head_dim).
                    dh = cfg_.d_model // cfg_.num_heads
                    for s_ in params["slstm"]:
                        s_["r"].mul_((cfg_.num_heads / dh) ** 0.5)
                return params

            def loss_of(cfg_):
                return lambda p, b: arch.loss(p, b, cfg_)

            def steps(cfg_, n):
                """(losses, grad norms, seconds, fingerprint of the final
                params or of the gradients, what one more step needs) of n
                steps from ``init``; counts reset first."""
                params = init(cfg_)
                reset()
                losses, norms, secs = [], [], []
                if entry == "grads":
                    t1 = time.time()
                    loss, grads = _value_and_grad(loss_of(cfg_), params, batches[0])
                    losses, norms = [float(loss)], [float(adamw.global_norm(grads))]
                    secs.append(time.time() - t1)
                    fp = _fingerprint(grads)
                    del grads
                    return losses, norms, secs, fp, (lambda: _value_and_grad(loss_of(cfg_), params, batches[-1]), params)
                state = adamw.init(params)
                step = build_train_step(loss_of(cfg_), opt)
                for i in range(n):
                    t1 = time.time()
                    params, state, m = step(params, state, batches[i])
                    losses.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
                    secs.append(time.time() - t1)
                torch.cuda.synchronize()
                return losses, norms, secs, _fingerprint(params), _one_more(step, params, state, batches[-1])

            def record(label, losses, norms, secs, extra_log=""):
                per = statistics.median(secs[1:]) if len(secs) > 1 else secs[0]
                peak = torch.cuda.max_memory_allocated()
                n = K.LAUNCHES["photonic_gemm_fused"]
                out[label] = dict(losses=losses, grad_norms=norms, step_seconds=secs, s_per_step=per,
                                  tokens_per_s=tokens / per, max_memory_allocated=peak, fused_launches=n,
                                  flash_launches=F.LAUNCHES["flash_attention"])
                log(f"  {name} {label}: {per:.4f} s/step ({'median of steps 2-' + str(len(secs)) if len(secs) > 1 else 'one step'}; "
                    f"all {[round(x, 4) for x in secs]}), {tokens / per:.1f} tokens/s, max_memory_allocated "
                    f"{peak / 2**30:.2f} GiB, fused launches {n} ({n / len(secs):.0f}/step), flash "
                    f"{F.LAUNCHES['flash_attention']}; losses {losses}, grad norms {norms}{extra_log} [{card}]")
                return n

            if name == "xlstm-350m":
                # The published init, one loss and gradient: the reference's
                # fault of Queue 3 item 12, recorded, not gated.
                params = init_params(cfg_a, 0, "cuda", defs=arch.param_defs(cfg_a))
                loss, grads = _value_and_grad(loss_of(cfg_a), params, batches[0])
                bad = sum(not bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
                out["published_init"] = dict(loss=float(loss), grad_norm=float(adamw.global_norm(grads)),
                                             nonfinite_leaves=bad, leaves=len(tree_leaves(grads)))
                log(f"  {name} at its published init (r at std 1/sqrt(num_heads)): step-1 loss {float(loss):.6f}, "
                    f"grad norm {out['published_init']['grad_norm']}, {bad} of {len(tree_leaves(grads))} gradient "
                    f"leaves non-finite [{card}]")
                del params, grads, loss
            # (a) the entry point on the ideal channel and the kernel.
            if entry == "train":
                ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
                try:
                    if name == "xlstm-350m":  # the rescaled r enters train() as its step-0 checkpoint
                        params = init(cfg_a)
                        ckpt.save(ckpt_dir, 0, {"params": params, "opt": adamw.init(params)})
                        del params
                    reset()
                    t1 = time.perf_counter()
                    run = train(arch=arch, model_cfg=cfg_a, data_cfg=data,
                                train_cfg=TrainConfig(steps=n_steps, ckpt_every=1000, ckpt_dir=ckpt_dir,
                                                      log_every=1),
                                opt_cfg=opt, log=lambda m: log(f"    {m}"), device="cuda")
                    wall = time.perf_counter() - t1
                    step_dir = Path(ckpt_dir) / f"step_{n_steps:08d}"
                    saved = (step_dir / "manifest.json").exists()
                    size = sum(f.stat().st_size for f in step_dir.iterdir()) if saved else 0
                finally:
                    shutil.rmtree(ckpt_dir, ignore_errors=True)
                fp_a = _fingerprint(run["params"])
                losses_a = run["losses"]
                # train() reports no grad norms: (c)'s, bitwise the same run, stand for them.
                n_a = record("a", losses_a, [], run["step_seconds"], f"; train() wall {wall:.3f} s, end-of-run "
                             f"checkpoint {size / 1e9:.3f} GB saved: {saved}, loop blocked on it "
                             f"{run['checkpoint_seconds']:.3f} s")
                out["a"].update(wall_s=wall, checkpoint_s=run["checkpoint_seconds"], checkpoint_bytes=size)
                good = saved
                more = _one_more(build_train_step(loss_of(cfg_a), opt), run["params"], run["opt_state"], batches[-1])
                del run
            else:
                losses_a, norms, secs, fp_a, more = steps(cfg_a, n_steps)
                n_a = record("a", losses_a, norms, secs)
                good = all(np.isfinite(norms))
            good &= all(np.isfinite(losses_a)) and n_a == per_step * n_steps
            log(f"  {name} a: losses finite, fused launches {n_a} == {per_step} x {n_steps}: {good}")
            ok &= good
            total += n_a
            out["n_params"] = sum(t.numel() for t in tree_leaves(more[1]))
            # One more step of (a), its device busy share sampled (not gated).
            K.reset_launches()
            out["a"]["busy_pct"], samples = busy_share(torch, more[0])
            log(f"  {name}: {out['n_params'] / 1e9:.3f} B parameters; one more step of (a): device busy "
                f"{out['a']['busy_pct']:.1f}% (NVML utilization.gpu, {samples} samples of 100 ms) [{card}]")
            del more
            # (b) SMWA analog (noise_seed=0); (c) the exact backend, which
            # must give (a)'s losses and final state bit for bit.
            modes = [("b", dataclasses.replace(cfg_a, photonic=smwa_dpu()), smwa_steps)] if smwa_steps else []
            modes.append(("c", dataclasses.replace(cfg_a, photonic_backend="exact"), n_steps))
            for label, cfg_, n in modes:
                losses, norms, secs, fp, held = steps(cfg_, n)
                del held
                launched = record(label, losses, norms, secs)
                if label == "b":
                    good = all(np.isfinite(losses)) and all(np.isfinite(norms)) and launched == per_step * n
                    log(f"  {name} b (SMWA, noise_seed=0): losses and grad norms finite, {launched} == "
                        f"{per_step} x {n} fused launches; |loss - loss_a| "
                        f"{[abs(x - y) for x, y in zip(losses, losses_a)]}: {good}")
                else:
                    good = losses == losses_a and fp == fp_a and launched == 0 and all(np.isfinite(norms))
                    log(f"  {name} c (exact): losses bitwise (a)'s: {losses == losses_a}; "
                        f"{'gradients' if entry == 'grads' else 'final params'} sha256 {fp} vs (a) {fp_a}; grad "
                        f"norms finite: {good}")
                    if entry == "train":
                        out["a"]["grad_norms"] = norms
                ok &= good
                torch.cuda.empty_cache()
            out["seconds"] = time.perf_counter() - t0
            log(f"  {name}: {out['seconds']:.1f} s in all")
            res[name] = out
            first.clear()
            del batches
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.cuda.empty_cache()
    return ok, res, total


def smwa_dpu():
    """The serve and train phases' SMWA analog operating point (N = 42,
    ``noise_seed=0``)."""
    from repro_torch.core.dpu import DPUConfig
    from repro_torch.noise.channel import build_channel_model

    return DPUConfig(
        organization="SMWA", bits=4, datarate_gs=5.0,
        channel=build_channel_model("SMWA", n=42, bits=4, datarate_gs=5.0), noise_seed=0,
    )


def ideal_dpu():
    from repro_torch.core.dpu import DPUConfig

    return DPUConfig(organization="SMWA", bits=4, datarate_gs=5.0)


def setup(torch) -> None:
    """The import path and the matrix-product settings of every phase: f32
    products in full f32 (no TF32) for the twins and the digital GEMMs;
    both are PyTorch's defaults, stated here."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def child(phase: str, arg=None) -> int:
    """``chip_smoke.py --phase train``, ``--phase train-families``,
    ``--phase placement``, ``--phase tp TOKENS`` or ``--phase tp-train
    PHASE7``: the phase alone, in a process whose environment
    sets ``CUBLAS_WORKSPACE_CONFIG`` (cuBLAS's reproducible workspaces,
    which the deterministic mode needs) before CUDA starts.  The kernels
    were built by the parent; the last line of stdout is the phase's result
    as JSON."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") != ":4096:8":
        print(f"chip_smoke --phase {phase}: CUBLAS_WORKSPACE_CONFIG=:4096:8 must be set", file=sys.stderr)
        return 2
    setup(torch)
    from repro_torch.kernels.flash_attention import kernel as F
    from repro_torch.kernels.photonic_gemm import kernel as K
    from repro_torch.models import registry

    K.LIBRARY.load()
    F.LIBRARY.load()
    if phase == "gloo-repro":
        photonic_race_library().build()
    if phase == "train":
        ok, res, launches = train_phase(torch, registry.get("qwen2-0.5b"), ideal_dpu(), card_line())
    elif phase == "tp":
        ok, res, launches = tp_child(json.loads(arg))
    elif phase == "tp-train":
        ok, res, launches = tp_train_child(json.loads(arg))
    elif phase == "placement":
        ok, res, launches = placement_child()
    elif phase == "gloo-repro":
        ok, res, launches = placement_child(repeat=int(arg))
    else:
        ok, res, launches = train_families_phase(torch, registry, card_line())
    print(json.dumps({"ok": ok, "result": res, "launches": launches}))
    return 0 if ok else 1


def run_child(card, phase, timeout, args=()):
    """``phase`` in its own process (:func:`child`), with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in that process's environment only.
    Its log lines are relayed; returns (ok, result, launches), ok false when
    the child fails, crashes, outlives ``timeout`` seconds or prints no
    result."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--phase", phase, *args], env=env,
                            stdout=subprocess.PIPE, text=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        log(f"  {phase} child process: killed after {timeout} s")
    lines = out.splitlines()
    for line in lines[:-1]:
        log(line)
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        log(lines[-1])
        result = None
    ok = proc.returncode == 0 and result is not None and result.get("ok") is True
    log(f"  {phase} child process: exit code {proc.returncode}, result line {'read' if result else 'missing'}: "
        f"{ok} [{card}]")
    if result is None:
        return False, {}, {}
    return ok, result["result"], result["launches"]


def tp_case(torch, K, dpu, r, k, c, site, gen, rows_out, card, *, model="qwen2-0.5b", key=None, shards=TP_SHARDS):
    """One K-sharded GEMM as ``psum_int_gemm`` runs it, shard by shard in
    this process: shard ``i``'s ``int_gemm(shard=i)`` of the shard-local
    engine (``shard_local_engine(engine, K / shards)``) on CUDA int8
    operands (the unfused ``photonic_gemm`` kernel), against the same call
    with the kernel swapped for its twin on the card: bitwise, and under
    noise one-LSB roundings at <= 0.1% of elements (each within two
    top-pass LSBs); under the ideal channel the sum over shards also equals
    ``exact_int_gemm`` of the whole GEMM.  Per shard a row: the kernel
    launch alone (CUDA graph of the recorded call), the twin call
    (host-timed once), ``torch._int_mm`` of the shard's int core (rows
    padded to 32 where fewer) and the bound of the shard's logical GEMM.
    With ``key`` (a ``repro_torch.prng`` key) the stream is the key's."""
    import repro_torch.photonic.engine as E
    from repro_torch.kernels.photonic_gemm.ref import exact_int_gemm
    from repro_torch.photonic.sharded import shard_local_engine

    dev = torch.device("cuda")
    kl = k // shards
    local = shard_local_engine(E.PhotonicEngine(dpu=dpu, backend="kernel"), kl)
    stages, _ = E.kernel_stages(local.dpu, r, kl, c)
    noisy = stages["noise_sigma"] > 0.0
    ideal = dpu.effective_channel() is None
    chan = "ideal" if ideal else dpu.organization
    x = torch.randint(-127, 128, (r, k), generator=gen, device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, c), generator=gen, device=dev, dtype=torch.int8)
    kernel = E.photonic_gemm
    total, ok = None, True
    passes, xdots = passes_of(local.dpu, stages)
    for i in range(shards):
        xs, ws = x[:, i * kl:(i + 1) * kl].contiguous(), w[i * kl:(i + 1) * kl].contiguous()
        calls = []

        def record(*a, **k_):
            calls.append((a, k_))
            return kernel(*a, **k_)

        def twin(xp, wp, seed, rows=None, **st):
            return K.photonic_gemm_twin(xp, wp, seed, **st)

        kw = dict(site=site, fold=0, shard=i, prng_key=key)
        n0 = K.LAUNCHES["photonic_gemm"]
        try:
            E.photonic_gemm = record
            y_k = local.int_gemm(xs, ws, **kw)
            E.photonic_gemm = twin
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y_t = local.int_gemm(xs, ws, **kw)
            torch.cuda.synchronize()
            t_ms = (time.perf_counter() - t0) * 1e3
        finally:
            E.photonic_gemm = kernel
        diff = (y_k.to(torch.int64) - y_t.to(torch.int64)).abs()
        err = float(diff.max())
        if noisy:
            good = float((diff > 0).to(torch.float64).mean()) <= 1e-3 and err <= 2 * 2 ** (2 * dpu.bits)
            tol = "noisy: <=0.1% elements off, <= 2 top-pass LSB"
        else:
            good = err == 0.0
            tol = "bitwise"
        (a, k_), = calls
        k_ms = graph_ms(lambda: kernel(*a, **k_))
        launched = K.LAUNCHES["photonic_gemm"] - n0
        xi = torch.zeros((max(r, 32), kl), dtype=torch.int8, device=dev)
        xi[:r] = xs
        lib_ms = graph_ms(lambda: torch._int_mm(xi, ws))
        draws = r * c * -(-kl // stages["n_chunk"]) * passes if noisy else 0
        parts = bound_ms(r, kl, c, 1, passes, xdots, False, False, draws)
        b_ms, b_by = bound_of([parts])
        total = y_k.to(torch.int64) if total is None else total + y_k.to(torch.int64)
        ok &= good
        rows_out.append(dict(
            model=model, site=site, keyed=key is not None, shard=i, shards=shards, R_live=r, K=k, K_local=kl,
            C=c, n_chunk=stages["n_chunk"], channel=chan, ms=k_ms, plain_ms=t_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by, parts=parts, draws=draws, max_abs_err=err, bitwise=err == 0.0,
            tolerance=tol, ok=good, launches=launched,
        ))
        log(f"  tp {'' if model == 'qwen2-0.5b' else model + ' '}{site:8s}{' keyed' if key is not None else ''} "
            f"shard {i}/{shards} R={r:3d} K={kl:5d}/{k:5d} C={c:5d} {chan:5s} N_local={stages['n_chunk']}: kernel "
            f"{k_ms:.4f} ms, twin {t_ms:.3f} ms, _int_mm {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
            f"{launched} launches, max_abs_err {err:.3g} [{tol}] -> {'ok' if good else 'MISMATCH'} [{card}]")
    if ideal:
        same = bool(torch.equal(total, exact_int_gemm(x, w).to(torch.int64)))
        log(f"    sum over {shards} shards == exact_int_gemm: {same}")
        ok &= same
    return ok


def tp_kernel_rows(torch, K, chans, key, gen, rows, card):
    """The tp phase's kernel rows (:func:`tp_case`): qwen2-0.5b's six sites
    at R = 4 and 64 and granite-3-8b's at R = 4, K-sharded over two shards,
    ideal, SMWA under ``key`` and ASMW under its ``noise_seed``.  Logs one
    shard's sums over a layer.  Returns (ok, sums)."""
    ok = True
    cases = [("qwen2-0.5b", SITES, (4, 64)), ("granite-3-8b", GRANITE_SITES, (4,))]
    for model, sites, rs in cases:
        for name in ("ideal", "SMWA", "ASMW"):
            for r in rs:
                for site, k, c, _ in sites:
                    ok &= tp_case(torch, K, chans[name], r, k, c, site, gen, rows, card, model=model,
                                  key=key if name == "SMWA" else None)
    sums = {}
    for model, sites, rs in cases:
        for name in ("ideal", "SMWA", "ASMW"):
            for r in rs:
                layer = [x for x in rows if x["model"] == model and x["channel"] == name and x["R_live"] == r
                         and x["shard"] == 0]
                bm, bb = bound_of([x["parts"] for x in layer])
                tot = {k_: sum(x[k_] for x in layer) for k_ in ("ms", "plain_ms", "library_ms")}
                sums[f"{model} {name} R={r}"] = dict(tot, bound_ms=bm, bound_by=bb,
                                                     max_abs_err=max(x["max_abs_err"] for x in layer))
                log(f"  tp {model} layer, one shard of {TP_SHARDS} (six sites) {name} R={r}: kernel "
                    f"{tot['ms']:.4f} ms, twin {tot['plain_ms']:.3f} ms, bound {bm:.5f} ms ({bb}), _int_mm "
                    f"{tot['library_ms']:.4f} ms [{card}]")
    return ok, sums


def tp_serve(torch, arch, params, dpu, prompts, mesh, rank, card, label, *, check=False):
    """Serve ``prompts`` (8 greedy tokens each) through ``serve.Engine`` →
    ``Scheduler`` with ``mesh`` (None: one rank, unsharded) on the kernel
    backend, logits recorded.  With ``check``, one more decode
    step runs under the scheduler's ``decode_checker`` after the run (its
    collectives and launches in ``result["checker"]``).  Returns
    (requests, result)."""
    from repro_torch.analysis import contracts
    from repro_torch.kernels.photonic_gemm import kernel as K
    from repro_torch.runtime.serve import Engine, ServeConfig
    from repro_torch.serving import Request

    cfg = dataclasses.replace(arch.config, photonic=dpu, photonic_backend="kernel")
    eng = Engine(arch, cfg, params, ServeConfig(batch_size=4, max_seq=128), mesh=mesh)
    sch = eng.impl
    sch.cfg.record_logits = True
    reqs = [Request(uid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    K.reset_launches()
    contracts.reset_all_reduces()
    t0 = time.perf_counter()
    sch.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = sch.stats
    forwards = st["prefill_chunks"] + st["decode_steps"]
    res = dict(
        tokens=[r.output for r in reqs], seconds=dt, prefill_s=st["prefill_s"], forwards=forwards,
        decode_steps=st["decode_steps"],
        decode_ms_per_step=st["decode_s"] / max(st["decode_steps"], 1) * 1e3,
        launches=dict(K.LAUNCHES), all_reduces=contracts.ALL_REDUCES["psum_int_gemm"],
        done=all(r.done and len(r.output) == 8 for r in reqs),
        finite=all(bool(np.isfinite(row).all()) for r in reqs for row in r.logits),
        engine=str(eng.photonic.describe()),
    )
    if check:
        from repro_torch.analysis.contracts import ContractViolation

        checker = sch.decode_checker("tp_decode")
        torch.cuda.synchronize()
        try:
            checker.assert_psum_per_gemm(6 * arch.config.num_layers)
            psum = "held"
        except ContractViolation as e:
            psum = str(e)
        res["checker"] = dict(
            assert_psum_per_gemm=psum,
            all_reduces=checker.all_reduces(), summary=checker.collective_summary(), launches=checker.launches,
            partials=[c.out_bytes for c in checker.collectives if c.kind == "all-reduce"],
            group_sizes=sorted({c.group_size for c in checker.collectives}, key=str),
            matmul_traffic_bytes=checker.matmul_traffic_bytes(),
        )
    return reqs, res


def _logits_of(reqs):
    return np.concatenate([np.stack(r.logits) for r in reqs])


def tp_rank(rank, world, serve_tokens):
    """One rank of the tp phase: qwen2-0.5b at full width, whole (24
    layers, bf16, ``init_params`` seed 0), served through ``Engine`` with
    the ("data", "model") mesh of ``world`` ranks sharing the card and at
    TP = 1 on the same rank; ``lm_logits`` at B = 2, T = 1000 at both.
    Returns this rank's results and gates."""
    import torch
    import torch.distributed as dist

    setup(torch)
    from repro_torch.kernels.photonic_gemm import kernel as K
    from repro_torch.analysis import contracts
    from repro_torch.launch.mesh import make_tp_smoke_mesh
    from repro_torch.models import lm, registry
    from repro_torch.models.common import init_params
    from repro_torch.photonic import tensor_parallel

    K.LIBRARY.load()
    card = card_line()

    def say(msg):
        log(f"  [rank {rank}] {msg}")

    mesh = make_tp_smoke_mesh(world)
    say(f"backend {dist.get_backend()} (CUDA tensors), world {dist.get_world_size()}, mesh "
        f"{mesh.mesh_dim_names} {tuple(mesh.mesh.shape)}, model-axis rank {mesh.get_local_rank('model')}, "
        f"device {torch.cuda.current_device()} {torch.cuda.get_device_name()}")
    arch = registry.get("qwen2-0.5b")
    n_layers = arch.config.num_layers
    t0 = time.perf_counter()
    params = init_params(arch.config, 0, device="cuda")
    torch.cuda.synchronize()
    say(f"init_params (qwen2-0.5b full width, bf16) {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, arch.config.vocab_size, n).astype(np.int32) for n in (16, 40, 64, 24)]
    ideal, smwa = ideal_dpu(), smwa_dpu()
    out, gates = {"rank": rank}, {}
    runs, logits = {}, {}
    for label, dpu, m in (
        ("ideal_tp1", ideal, None), ("ideal", ideal, mesh), ("smwa_tp1", smwa, None), ("smwa", smwa, mesh),
    ):
        reqs, res = tp_serve(torch, arch, params, dpu, prompts, m, rank, card, label, check=label == "ideal")
        logits[label] = _logits_of(reqs)
        runs[label] = res
        tp = m is not None
        want = 6 * n_layers * res["forwards"]
        counts = ((res["launches"]["photonic_gemm"], res["all_reduces"], res["launches"]["photonic_gemm_fused"])
                  == ((want, want, 0) if tp else (0, 0, want)))
        gates[f"{label} done, finite, launches"] = res["done"] and res["finite"] and counts
        say(f"{label}: {res['engine']}: {res['seconds']:.3f} s, prefill {res['prefill_s']:.3f} s, decode "
            f"{res['decode_ms_per_step']:.2f} ms/step over {res['decode_steps']} steps; "
            f"photonic_gemm launches {res['launches']['photonic_gemm']}, all-reduces {res['all_reduces']}, fused "
            f"{res['launches']['photonic_gemm_fused']} for {res['forwards']} forwards "
            f"(want {'unfused = all-reduces' if tp else 'fused'} {want}): {counts} [{card}]")
        torch.cuda.empty_cache()
    out["runs"] = runs
    # The contract checker over one TP = 2 decode step (4 rows): one int32
    # all-reduce per routed GEMM, priced by the ring formula 2 (g - 1) / g x
    # bytes over the (R, C) partials the engine reduces, g = 2.
    from repro_torch.launch.hlo_analysis import _wire_bytes

    chk = runs["ideal"]["checker"]
    want_bytes = sum(n_layers * _wire_bytes("all-reduce", 4 * c * 4, world) for _, _, c, _ in SITES)
    gates[f"checker: assert_psum_per_gemm({6 * n_layers}) on a TP = 2 decode step"] = (
        chk["assert_psum_per_gemm"] == "held")
    gates["checker: all-reduce wire bytes == ring formula over the padded int32 partials"] = (
        chk["summary"].get("bytes_all-reduce") == want_bytes)
    gates["checker: 144 unfused launches, no fused"] = (
        chk["launches"]["photonic_gemm"] == 6 * n_layers and chk["launches"]["photonic_gemm_fused"] == 0)
    say(f"checker over one TP = 2 decode step: assert_psum_per_gemm({6 * n_layers}) {chk['assert_psum_per_gemm']}; "
        f"{chk['all_reduces']} all-reduces (group sizes {chk['group_sizes']}), "
        f"wire bytes {chk['summary'].get('bytes_all-reduce')} == ring formula {want_bytes} over "
        f"{sum(chk['partials'])} bytes of int32 partials; launches {chk['launches']}; GEMM traffic "
        f"{chk['matmul_traffic_bytes']} bytes [{card}]")
    gates["ideal TP=2 tokens == TP=1 tokens"] = runs["ideal"]["tokens"] == runs["ideal_tp1"]["tokens"]
    gates["ideal TP=2 logits == TP=1 logits"] = bool(np.array_equal(logits["ideal"], logits["ideal_tp1"]))
    gates["smwa TP=2 logits != unsharded"] = not np.array_equal(logits["smwa"], logits["smwa_tp1"])
    out["smwa_tokens_equal_unsharded"] = runs["smwa"]["tokens"] == runs["smwa_tp1"]["tokens"]
    out["ideal_tokens_equal_serve_phase"] = runs["ideal"]["tokens"] == serve_tokens
    out["digests"] = {k: hashlib.sha256(v.tobytes()).hexdigest()[:16] for k, v in logits.items()}
    del logits
    # lm_logits at the oneshot phase's shape: TP = 2 bitwise TP = 1.
    import repro_torch.serving as serving

    cfg = dataclasses.replace(arch.config, photonic=ideal, photonic_backend="kernel")
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, arch.config.vocab_size, (2, 1000)), device="cuda")
    got = {}
    with torch.no_grad():
        for label, m in (("tp1", None), ("tp", mesh)):
            _, packed = serving.prepack_serving_params(arch, cfg, params, mesh=m)
            torch.cuda.synchronize()
            K.reset_launches()
            contracts.reset_all_reduces()
            t0 = time.perf_counter()
            with tensor_parallel(m, "model") if m is not None else contextlib.nullcontext():
                got[label], _ = lm.lm_logits(packed, tokens, cfg)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            runs[f"lm_logits_{label}"] = dict(seconds=dt, launches=dict(K.LAUNCHES),
                                              all_reduces=contracts.ALL_REDUCES["psum_int_gemm"])
            say(f"lm_logits B=2 T=1000 {label}: {dt:.3f} s, photonic_gemm {K.LAUNCHES['photonic_gemm']}, fused "
                f"{K.LAUNCHES['photonic_gemm_fused']}, all-reduces {contracts.ALL_REDUCES['psum_int_gemm']} [{card}]")
            del packed
    want = 6 * n_layers
    gates["lm_logits TP=2 == TP=1 bitwise"] = bool(torch.equal(got["tp"], got["tp1"]))
    gates["lm_logits launches"] = (
        (runs["lm_logits_tp"]["launches"]["photonic_gemm"], runs["lm_logits_tp"]["all_reduces"],
         runs["lm_logits_tp1"]["launches"]["photonic_gemm_fused"]) == (want, want, want))
    gates["lm_logits finite"] = bool(torch.isfinite(got["tp"].float()).all())
    out["digests"]["lm_logits"] = hashlib.sha256(got["tp"].float().cpu().numpy().tobytes()).hexdigest()[:16]
    out["gates"] = gates
    out["backend"] = dist.get_backend()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    for k, v in gates.items():
        say(f"{k}: {v}")
    return out


def tp_child(serve_tokens):
    """``chip_smoke.py --phase tp``: two ranks of :func:`tp_rank` on the one
    card over ``gloo`` with CUDA tensors (NCCL refuses two ranks on one
    device), started by ``repro_torch.launch.mesh.spawn``.  Gates: each
    rank's own, and the ranks' tokens and logits equal.  Returns (ok,
    result, launches summed over the ranks)."""
    from repro_torch.launch.mesh import spawn

    backend = "gloo"
    log(f"  tp: {TP_SHARDS} ranks on one card, backend {backend}, CUDA tensors")
    res = spawn(tp_rank, TP_SHARDS, backend=backend, device="cuda", args=(serve_tokens,), timeout=600)
    ok = all(all(r["gates"].values()) for r in res)
    same = all(r["runs"][k]["tokens"] == res[0]["runs"][k]["tokens"] for r in res for k in ("ideal", "smwa"))
    same_logits = all(r["digests"] == res[0]["digests"] for r in res)
    log(f"  tp: every rank's gates {ok}; tokens equal across ranks {same}; logits equal across ranks "
        f"{same_logits}; ideal TP=2 tokens == the serve phase's (chunked prefill of 64 tokens, information "
        f"only) {res[0]['ideal_tokens_equal_serve_phase']}; SMWA TP=2 tokens == unsharded SMWA tokens "
        f"{res[0]['smwa_tokens_equal_unsharded']}")
    for i, tok in enumerate(res[0]["runs"]["ideal"]["tokens"]):
        log(f"    uid {i}: TP=2 {tok} TP=1 {res[0]['runs']['ideal_tp1']['tokens'][i]}")
    launches = {"photonic_gemm": sum(r["runs"][k]["launches"]["photonic_gemm"] for r in res
                                     for k in ("ideal", "smwa", "lm_logits_tp"))
                                 + sum(r["runs"]["ideal"]["checker"]["launches"]["photonic_gemm"] for r in res)}
    return ok and same and same_logits, {"backend": backend, "ranks": res}, launches


def tp_train_kernel_rows(torch, K, ideal, gen, rows, card):
    """Phase 7c's kernel rows (:func:`tp_case`): qwen2-0.5b's six sites
    K-sharded over two shards at the training shapes, R = 4096 (TP = 2) and
    R = 2048 (a data rank of DP 2 x TP 2), ideal.  Logs one shard's sums
    over a layer.  Returns (ok, sums)."""
    ok, sums = True, {}
    for r in TP_TRAIN_ROWS:
        for site, k, c, _ in SITES:
            ok &= tp_case(torch, K, ideal, r, k, c, site, gen, rows, card)
        layer = [x for x in rows if x["R_live"] == r and x["shard"] == 0]
        bm, bb = bound_of([x["parts"] for x in layer])
        tot = {k_: sum(x[k_] for x in layer) for k_ in ("ms", "plain_ms", "library_ms")}
        sums[f"qwen2-0.5b ideal R={r}"] = dict(tot, bound_ms=bm, bound_by=bb,
                                               max_abs_err=max(x["max_abs_err"] for x in layer))
        log(f"  tp train qwen2-0.5b layer, one shard of {TP_SHARDS} (six sites) ideal R={r}: kernel "
            f"{tot['ms']:.4f} ms, twin {tot['plain_ms']:.3f} ms, bound {bm:.5f} ms ({bb}), _int_mm "
            f"{tot['library_ms']:.4f} ms [{card}]")
    return ok, sums


def _train_inputs(arch):
    """Phase 7's data stream and optimizer settings."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim import adamw

    data = DataConfig(vocab_size=arch.config.vocab_size, seq_len=1024, global_batch=4, seed=0)
    return data, adamw.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)


class _SaveCounter:
    """Counts ``repro_torch.checkpoint.ckpt.save`` calls while active."""

    def __enter__(self):
        from repro_torch.checkpoint import ckpt

        self.ckpt, self.save, self.n = ckpt, ckpt.save, 0

        def counting(*a, **k):
            self.n += 1
            return self.save(*a, **k)

        ckpt.save = counting
        return self

    def __exit__(self, *exc):
        self.ckpt.save = self.save
        return False


def _tp_train_rank_setup(rank):
    """A tp-train rank's common start: the import path and matmul settings,
    deterministic mode, the kernel library; returns (torch, K, say)."""
    import torch

    setup(torch)
    torch.use_deterministic_algorithms(True)
    from repro_torch.kernels.photonic_gemm import kernel as K

    K.LIBRARY.load()

    def say(msg):
        log(f"  [rank {rank}] {msg}")

    return torch, K, say


def _reset_counts(torch, K):
    from repro_torch.analysis import contracts

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    contracts.reset_all_reduces()


def _counts(K):
    from repro_torch.analysis import contracts

    return dict(K.LAUNCHES, all_reduces=contracts.ALL_REDUCES["psum_int_gemm"],
                row_gathers=contracts.ROW_GATHERS["tp_rows"])


def _rank_spread(torch, tree, lr):
    """The largest difference of any parameter between the ranks (an
    ``all_reduce`` of the max and of the min), and whether every difference
    is within what one AdamW step from one state can open between ranks
    whose gradients differ: 2 x lr plus one bf16 rounding of the value."""
    import torch.distributed as dist

    from repro_torch._tree import tree_leaves

    worst, within = 0.0, True
    for t in tree_leaves(tree):
        hi = t.detach().to(torch.float32).clone()
        lo = hi.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        spread = hi - lo
        mag = torch.maximum(hi.abs(), lo.abs()).clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        worst = max(worst, float(spread.max()))
        within &= bool((spread <= 2 * lr + ulp).all())
    return worst, within


def tp_train_pair_rank(rank, world, phase7, ckpt_dir):
    """One rank of phase 7c (a) and (b): qwen2-0.5b at full width and all 24
    layers (bf16, ``init_params`` seed 0, phase 7's data and AdamW) on the
    ("data", "model") 1 x 2 mesh of two ranks sharing the card.  (a)
    ``train(mesh=, tp_axis="model")`` for phase 7's 3 steps into the shared
    ``ckpt_dir``, ideal channel, kernel backend, the heads placed over
    "model" (``attn.wq`` / ``wk`` / ``wv`` column-parallel; bitwise phase 7
    (a) all the same); (b) one ``build_train_step`` at
    :data:`TP_TRAIN_GRID_LAYERS` layers under ``tensor_parallel`` on the
    SMWA channel.  Returns this rank's results and gates."""
    import torch.distributed as dist

    torch, K, say = _tp_train_rank_setup(rank)
    from repro_torch import prng
    from repro_torch.data.pipeline import SyntheticTokens, make_global_batch
    from repro_torch.launch.mesh import make_tp_smoke_mesh
    from repro_torch.models import registry
    from repro_torch.models.common import init_params
    from repro_torch.optim import adamw
    from repro_torch.photonic import tensor_parallel
    from repro_torch.runtime.train_loop import TrainConfig, build_train_step, train

    card = card_line()
    mesh = make_tp_smoke_mesh(world)
    say(f"backend {dist.get_backend()} (CUDA tensors), world {dist.get_world_size()}, mesh {mesh.mesh_dim_names} "
        f"{tuple(mesh.mesh.shape)}, model-axis rank {mesh.get_local_rank('model')}")
    arch = registry.get("qwen2-0.5b")
    n_layers = arch.config.num_layers
    data, opt = _train_inputs(arch)
    tokens = data.global_batch * data.seq_len
    cfg = dataclasses.replace(arch.config, photonic=ideal_dpu(), photonic_backend="kernel")
    out, gates = {"rank": rank}, {}
    # (a) places the heads (train(mesh=)): wq / wk / wv column-parallel, two shard launches each and no
    # all-reduce; wo, ffn.wi, ffn.wo K-sharded, a launch and an all-reduce each; forward and remat recompute
    per_step, reduces = 9 * n_layers * 2, 3 * n_layers * 2
    k_sharded = 6 * TP_TRAIN_GRID_LAYERS * 2  # (b), nothing placed: all six sites K-sharded

    # (a) the entry point: train() on the mesh.
    _reset_counts(torch, K)
    with _SaveCounter() as saves:
        t0 = time.perf_counter()
        res = train(arch=arch, model_cfg=cfg, data_cfg=data,
                    train_cfg=TrainConfig(steps=TRAIN_STEPS, ckpt_every=1000, ckpt_dir=ckpt_dir, log_every=1),
                    opt_cfg=opt, mesh=mesh, tp_axis="model", log=say, device="cuda")
        wall = time.perf_counter() - t0
    counts = _counts(K)
    peak = torch.cuda.max_memory_allocated()
    fp = _fingerprint(res["params"])
    dist.barrier()
    written = sorted(q.name for q in Path(ckpt_dir).iterdir())
    size = sum(f.stat().st_size for f in (Path(ckpt_dir) / written[0]).iterdir()) if written else 0
    secs = res["step_seconds"]
    per = statistics.median(secs[1:])
    out["a"] = dict(losses=res["losses"], fingerprint=fp, step_seconds=secs, s_per_step=per,
                    tokens_per_s=tokens / per, max_memory_allocated=peak, wall_s=wall,
                    checkpoint_s=res["checkpoint_seconds"], checkpoint_bytes=size, saves=saves.n, counts=counts)
    gates["(a) losses bitwise phase 7 (a)'s"] = res["losses"] == phase7["losses"]
    gates["(a) final params bitwise phase 7 (a)'s"] = fp == phase7["fingerprint"]
    gates["(a) launches and collectives"] = (
        (counts["photonic_gemm"], counts["all_reduces"], counts["photonic_gemm_fused"], counts["row_gathers"])
        == (per_step * TRAIN_STEPS, reduces * TRAIN_STEPS, 0, 0))
    gates["(a) one checkpoint, by rank 0"] = (written == [f"step_{TRAIN_STEPS:08d}"]
                                              and saves.n == (1 if rank == 0 else 0))
    say(f"(a) train(mesh=(1, {world}), tp_axis='model'): {per:.4f} s/step (median of steps 2-{TRAIN_STEPS}; all "
        f"{[round(x, 4) for x in secs]}), {tokens / per:.1f} tokens/s, max_memory_allocated {peak / 2**30:.2f} GiB, "
        f"wall {wall:.3f} s; losses {res['losses']} (phase 7 (a) {phase7['losses']}); params sha256 {fp} (phase 7 "
        f"{phase7['fingerprint']}); photonic_gemm {counts['photonic_gemm']}, all-reduces {counts['all_reduces']}, "
        f"row gathers {counts['row_gathers']}, fused {counts['photonic_gemm_fused']} (want {per_step}/step unfused, "
        f"{reduces} all-reduces); checkpoint saves {saves.n}, on disk {written} ({size / 1e9:.3f} GB), loop blocked "
        f"{res['checkpoint_seconds']:.3f} s [{card}]")
    del res
    torch.cuda.empty_cache()

    # (b) SMWA: one step under the TP scope, at the grid's depth.
    cfg_b = dataclasses.replace(cfg, num_layers=TP_TRAIN_GRID_LAYERS, photonic=smwa_dpu())
    params = init_params(cfg_b, prng.PRNGKey(0), "cuda", defs=arch.param_defs(cfg_b))
    state = adamw.init(params)
    step = build_train_step(lambda p, b: arch.loss(p, b, cfg_b), opt)
    batch = make_global_batch(SyntheticTokens(data), 0, "cuda")
    _reset_counts(torch, K)
    with tensor_parallel(mesh, "model"):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        dt = time.perf_counter() - t0
    counts = _counts(K)
    out["b"] = dict(loss=loss, grad_norm=norm, seconds=dt, counts=counts,
                    max_memory_allocated=torch.cuda.max_memory_allocated())
    gates["(b) SMWA loss and grad norm finite, launches"] = (
        bool(np.isfinite(loss) and np.isfinite(norm))
        and (counts["photonic_gemm"], counts["all_reduces"], counts["photonic_gemm_fused"]) == (k_sharded, k_sharded, 0))
    say(f"(b) SMWA step under tensor_parallel at {TP_TRAIN_GRID_LAYERS} layers: loss {loss!r}, grad norm "
        f"{norm!r}, {dt:.3f} s, photonic_gemm {counts['photonic_gemm']}, all-reduces {counts['all_reduces']} "
        f"[{card}]")
    out["gates"] = gates
    for k, v in gates.items():
        say(f"{k}: {v}")
    return out


def tp_train_grid_rank(rank, world, tp1, ckpt_dir):
    """One rank of phase 7c (c): qwen2-0.5b at full width cut to
    ``TP_TRAIN_GRID_LAYERS`` of its 24 layers (four ranks share the card and
    the run's time limit), on the ("data", "model") 2 x 2 mesh.  (c1)
    ``train(mesh=, tp_axis="model", place_rows=False)`` (the replicated
    program; phase 10 (b) places the rows) for ``TP_TRAIN_GRID_STEPS`` steps,
    held to ``tp1`` (TP = 1 at the same depth); (c2) one
    ``make_dp_train_step(tp_axis="model")`` step; (c3) the same with
    ``compress_grads=True``.  Returns this rank's results and gates."""
    import torch.distributed as dist

    torch, K, say = _tp_train_rank_setup(rank)
    from repro_torch.data.pipeline import SyntheticTokens, make_global_batch
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.models import registry
    from repro_torch.models.common import init_params
    from repro_torch.optim import adamw
    from repro_torch.runtime.dp_step import make_dp_train_step
    from repro_torch.runtime.train_loop import TrainConfig, build_train_step, train

    card = card_line()
    mesh = build_mesh((2, 2), ("data", "model"))
    say(f"backend {dist.get_backend()} (CUDA tensors), mesh {mesh.mesh_dim_names} {tuple(mesh.mesh.shape)}, "
        f"coordinate (data {mesh.get_local_rank('data')}, model {mesh.get_local_rank('model')})")
    arch = registry.get("qwen2-0.5b")
    data, opt = _train_inputs(arch)
    tokens = data.global_batch * data.seq_len
    cfg = dataclasses.replace(arch.config, num_layers=TP_TRAIN_GRID_LAYERS, photonic=ideal_dpu(),
                              photonic_backend="kernel")
    per_step = 6 * TP_TRAIN_GRID_LAYERS * 2
    out, gates = {"rank": rank}, {}

    # (c1) train() on the grid.
    _reset_counts(torch, K)
    with _SaveCounter() as saves:
        res = train(arch=arch, model_cfg=cfg, data_cfg=data,
                    train_cfg=TrainConfig(steps=TP_TRAIN_GRID_STEPS, ckpt_every=1000, ckpt_dir=ckpt_dir, log_every=1),
                    opt_cfg=opt, mesh=mesh, tp_axis="model", place_rows=False, log=say, device="cuda")
    counts = _counts(K)
    fp = _fingerprint(res["params"])
    secs = res["step_seconds"]
    out["c1"] = dict(losses=res["losses"], fingerprint=fp, step_seconds=secs, counts=counts, saves=saves.n,
                     max_memory_allocated=torch.cuda.max_memory_allocated(), tokens_per_s=tokens / secs[-1])
    gates["(c1) losses and params bitwise TP = 1's"] = res["losses"] == tp1["losses"] and fp == tp1["fingerprint"]
    n = per_step * TP_TRAIN_GRID_STEPS
    gates["(c1) launches and collectives"] = (
        (counts["photonic_gemm"], counts["all_reduces"], counts["row_gathers"], counts["photonic_gemm_fused"])
        == (n, n, n, 0))
    gates["(c1) checkpoint by rank 0 only"] = saves.n == (1 if rank == 0 else 0)
    say(f"(c1) train(mesh=(2, 2), tp_axis='model') at {TP_TRAIN_GRID_LAYERS} layers: steps {[round(x, 4) for x in secs]} "
        f"s, losses {res['losses']} (TP = 1 {tp1['losses']}), params sha256 {fp} (TP = 1 {tp1['fingerprint']}); "
        f"photonic_gemm {counts['photonic_gemm']}, all-reduces {counts['all_reduces']}, row gathers "
        f"{counts['row_gathers']}, fused {counts['photonic_gemm_fused']} (want {per_step}/step each, fused 0); "
        f"max_memory_allocated {out['c1']['max_memory_allocated'] / 2**30:.2f} GiB [{card}]")
    del res
    torch.cuda.empty_cache()

    # (c2) the DP step, and its TP = 1 yardsticks on this rank (no collective).
    params0 = init_params(cfg, 0, "cuda", defs=arch.param_defs(cfg))
    batch = make_global_batch(SyntheticTokens(data), 0, "cuda")

    def loss_fn(p, b):
        return arch.loss(p, b, cfg)

    whole, _, m_whole = build_train_step(loss_fn, opt)(params0, adamw.init(params0), batch)
    with torch.no_grad():
        halves = [float(loss_fn(params0, {k: v[i * 2:(i + 1) * 2] for k, v in batch.items()})) for i in range(2)]
    blocks = (halves[0] + halves[1]) / 2
    lr = float(adamw.schedule_lr(opt, torch.tensor(1)))
    results = {}
    for label, compress in (("c2", False), ("c3", True)):
        step = make_dp_train_step(loss_fn, opt, mesh, compress_grads=compress, tp_axis="model")
        _reset_counts(torch, K)
        t0 = time.perf_counter()
        p, _, loss, norm = step(params0, adamw.init(params0), batch)
        loss, norm = float(loss), float(norm)
        dt = time.perf_counter() - t0
        counts = _counts(K)
        worst, within = _rank_spread(torch, p, lr)
        to_whole = max(float((a.float() - b.float()).abs().max()) for a, b in zip(_leaves(p), _leaves(whole)))
        results[label] = p
        out[label] = dict(loss=loss, grad_norm=norm, seconds=dt, counts=counts, rank_spread=worst,
                          within_one_step=within,
                          blocks_loss=blocks, whole_loss=float(m_whole["loss"]), max_abs_to_whole=to_whole,
                          finite=bool(np.isfinite(loss) and np.isfinite(norm)
                                      and all(bool(torch.isfinite(t).all()) for t in _leaves(p))))
        say(f"({label}) make_dp_train_step(compress_grads={compress}): loss {loss!r} (TP = 1: mean over the two "
            f"data blocks {blocks!r}, whole batch {float(m_whole['loss'])!r}), grad norm {norm!r} (whole batch "
            f"{float(m_whole['grad_norm'])!r}), max |p - p_whole| {to_whole:.4g}, largest difference between ranks "
            f"{worst:.4g}, {dt:.3f} s, photonic_gemm {counts['photonic_gemm']}, all-reduces {counts['all_reduces']} "
            f"[{card}]")
    c2, c3 = out["c2"], out["c3"]
    gates["(c2) loss within rtol 1e-5 of TP = 1 over the data blocks"] = abs(c2["loss"] - blocks) <= 1e-5 * abs(blocks)
    gates["(c2) params within atol 2e-2 of TP = 1 on the whole batch"] = c2["max_abs_to_whole"] <= 2e-2
    gates["(c2) ranks bitwise equal"] = c2["rank_spread"] == 0.0
    gates["(c2) launches"] = (c2["counts"]["photonic_gemm"], c2["counts"]["all_reduces"]) == (per_step, per_step)
    gates["(c3) finite, loss equal to (c2)'s"] = c3["finite"] and c3["loss"] == c2["loss"]
    gates["(c3) ranks agree within one AdamW step"] = c3["within_one_step"]
    c3["gap_to_c2"] = max(float((a.float() - b.float()).abs().max()) for a, b in zip(_leaves(results["c3"]),
                                                                                     _leaves(results["c2"])))
    say(f"(c3) against (c2): max |p_c3 - p_c2| {c3['gap_to_c2']:.4g}, |grad norm gap| "
        f"{abs(c3['grad_norm'] - c2['grad_norm']):.4g} [{card}]")
    out["gates"] = gates
    for k, v in gates.items():
        say(f"{k}: {v}")
    return out


def _leaves(tree):
    from repro_torch._tree import tree_leaves

    return tree_leaves(tree)


def tp_train_child(phase7):
    """``chip_smoke.py --phase tp-train PHASE7``: tensor- and data-parallel
    training of qwen2-0.5b on the one card, the ranks over ``gloo`` with
    CUDA tensors (NCCL refuses two ranks on one device), started by
    ``repro_torch.launch.mesh.spawn``.  (a) and (b) on two ranks
    (:func:`tp_train_pair_rank`), held to phase 7 (a)'s losses and final
    parameter fingerprint (``PHASE7``); then TP = 1 at
    ``TP_TRAIN_GRID_LAYERS`` layers in this process, and (c) on four ranks
    (:func:`tp_train_grid_rank`) held to it.  Gates: each rank's own, and
    the ranks' results equal.  Returns (ok, result, launches summed over
    the ranks)."""
    import torch

    from repro_torch.launch.mesh import spawn
    from repro_torch.models import registry
    from repro_torch.runtime.train_loop import TrainConfig, train

    backend = "gloo"
    log(f"  tp train: backend {backend}, CUDA tensors, ranks sharing the card")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_ckpt_")
    try:
        pair = spawn(tp_train_pair_rank, TP_SHARDS, backend=backend, device="cuda", args=(phase7, ckpt_dir),
                     timeout=420)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    ok = all(all(r["gates"].values()) for r in pair)
    same = (all(r["a"]["losses"] == pair[0]["a"]["losses"] and r["a"]["fingerprint"] == pair[0]["a"]["fingerprint"]
                for r in pair)
            and all((r["b"]["loss"], r["b"]["grad_norm"]) == (pair[0]["b"]["loss"], pair[0]["b"]["grad_norm"])
                    for r in pair))
    log(f"  tp train (a)/(b): every rank's gates {ok}; ranks agree (losses, params, SMWA loss and grad norm) {same}")

    # TP = 1 at the grid's depth, in this process, before the four ranks start.
    torch.use_deterministic_algorithms(True)
    arch = registry.get("qwen2-0.5b")
    data, opt = _train_inputs(arch)
    cfg = dataclasses.replace(arch.config, num_layers=TP_TRAIN_GRID_LAYERS, photonic=ideal_dpu(),
                              photonic_backend="kernel")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_ckpt_")
    try:
        res = train(arch=arch, model_cfg=cfg, data_cfg=data,
                    train_cfg=TrainConfig(steps=TP_TRAIN_GRID_STEPS, ckpt_every=1000, ckpt_dir=ckpt_dir, log_every=100),
                    opt_cfg=opt, log=lambda m: None, device="cuda")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    tp1 = dict(losses=res["losses"], fingerprint=_fingerprint(res["params"]), step_seconds=res["step_seconds"])
    log(f"  tp train: TP = 1 at {TP_TRAIN_GRID_LAYERS} layers, {TP_TRAIN_GRID_STEPS} steps: losses {tp1['losses']}, "
        f"params sha256 {tp1['fingerprint']}, steps {[round(x, 4) for x in tp1['step_seconds']]} s")
    del res
    torch.cuda.empty_cache()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_ckpt_")
    try:
        grid = spawn(tp_train_grid_rank, 4, backend=backend, device="cuda", args=(tp1, ckpt_dir), timeout=420)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    grid_ok = all(all(r["gates"].values()) for r in grid)
    grid_same = all(r["c1"]["fingerprint"] == grid[0]["c1"]["fingerprint"] and r["c2"]["loss"] == grid[0]["c2"]["loss"]
                    and r["c3"]["loss"] == grid[0]["c3"]["loss"] for r in grid)
    log(f"  tp train (c): every rank's gates {grid_ok}; ranks agree (c1 params, c2 and c3 losses) {grid_same}")
    launches = {"photonic_gemm": sum(r[k]["counts"]["photonic_gemm"] for r in pair for k in ("a", "b"))
                + sum(r[k]["counts"]["photonic_gemm"] for r in grid for k in ("c1", "c2", "c3"))}
    return (ok and same and grid_ok and grid_same, {"backend": backend, "pair": pair, "tp1_grid": tp1, "grid": grid},
            launches)


# Phase 10 (a'): column blocks of a 2-way "model" axis, each at its global
# column origin: qwen2-0.5b's attn.wq second block (448 columns from 448)
# and attn.wk's (64 from 64), neither origin a multiple of tile_c; and (d)'s
# deepseek-v2-lite: layer 0's SwiGLU ffn.wi ([u | g], 2 x 10,944 columns),
# rank 1's u block (5,472 from 5,472) and rank 0's g block (5,472 from
# 10,944), and MLA's attn.wq second head block (8 heads x 192, 1,536 from
# 1,536); and (e)'s: zamba2-2.7b's Mamba2 in_proj ([z | x | B C | dt], 2 x
# 5,120 + 128 + 80 columns), rank 1's block of each part (z 2,560 from
# 2,560, x 2,560 from 7,680, B C 64 from 10,304, dt 40 from 10,408);
# xlstm-350m's mLSTM up ([xin | gate], 2 x 2,048), rank 1's xin block
# (1,024 from 1,024) and rank 0's gate block (1,024 from 2,048), its wq's
# key block of head 0 (256 from 256), and the sLSTM wx ([i | f | z | o], 4
# x 1,024), rank 1's block of each quarter (512 from 512, 1,536, 2,560 and
# 3,584).  (model, site, K, C, origin, width)
COLUMN_BLOCKS = [("qwen2-0.5b", "attn.wq", 896, 896, 448, 448), ("qwen2-0.5b", "attn.wk", 896, 128, 64, 64),
                 ("deepseek-v2-lite-16b", "ffn.wi", 2048, 21888, 5472, 5472),
                 ("deepseek-v2-lite-16b", "ffn.wi", 2048, 21888, 10944, 5472),
                 ("deepseek-v2-lite-16b", "attn.wq", 2048, 3072, 1536, 1536),
                 ("zamba2-2.7b", "in_proj", 2560, 10448, 2560, 2560),
                 ("zamba2-2.7b", "in_proj", 2560, 10448, 7680, 2560),
                 ("zamba2-2.7b", "in_proj", 2560, 10448, 10304, 64),
                 ("zamba2-2.7b", "in_proj", 2560, 10448, 10408, 40),
                 ("xlstm-350m", "up", 1024, 4096, 1024, 1024),
                 ("xlstm-350m", "up", 1024, 4096, 2048, 1024),
                 ("xlstm-350m", "wq", 2048, 2048, 256, 256),
                 ("xlstm-350m", "wx", 1024, 4096, 512, 512),
                 ("xlstm-350m", "wx", 1024, 4096, 1536, 512),
                 ("xlstm-350m", "wx", 1024, 4096, 2560, 512),
                 ("xlstm-350m", "wx", 1024, 4096, 3584, 512)]


def column_origin_rows(torch, K, chans, key, rows_out, card):
    """Phase 10 (a'): the kernel at a global column origin, through
    ``PhotonicEngine.int_gemm(columns=, w_word=)`` on the kernel backend:
    for each of ``COLUMN_BLOCKS``, ideal and SMWA under ``key``, ``fused``
    0 (int8 x) and 1 (f32 x, bias epilogue), R = 4: the block's launch
    against those columns of the whole weight's launch (gate: bitwise, the
    noise ids and content word being the whole's), and against the block
    call with the kernel swapped for its twin on the card (bitwise ideal;
    under noise one-LSB roundings at <= 0.1% of elements, as the tp rows).
    Per case a row: the block's launch alone (CUDA graph of the recorded
    call), the twin call (host-timed once), ``torch._int_mm`` of the
    block's int core (rows padded to 32) and the block's bound.  Returns
    ok."""
    import repro_torch.photonic.engine as E
    from repro_torch.core.dpu import quantize_symmetric
    from repro_torch.kernels.photonic_gemm.epilogue import EpilogueArgs, EpilogueSpec
    from repro_torch.noise.stages import tweak_word

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(28)
    ok, r = True, 4
    kernels = {0: "photonic_gemm", 1: "photonic_gemm_fused"}
    for name in ("ideal", "SMWA"):
        eng = E.PhotonicEngine(dpu=chans[name], backend="kernel")
        for model, site, k, c, origin, width in COLUMN_BLOCKS:
            x = torch.randn(r, k, generator=gen, device=dev)
            w = torch.randint(-127, 128, (k, c), generator=gen, device=dev, dtype=torch.int8)
            ws = torch.rand(c, generator=gen, device=dev) * 1e-3 + 1e-3
            b = torch.randn(c, generator=gen, device=dev)
            xq, sx = quantize_symmetric(x, 8)
            cols = slice(origin, origin + width)
            block = w[:, cols].contiguous()
            for fused in (0, 1):
                kw = dict(site=site, fold=3, prng_key=key if name == "SMWA" else None)

                def call(weight, sel, **extra):
                    ep = EpilogueArgs(EpilogueSpec(bias=True), sx, ws[sel], b[sel]) if fused else None
                    return eng.int_gemm(x if fused else xq, weight, epilogue=ep, **kw, **extra)

                attr = kernels[fused]
                kernel, calls = getattr(E, attr), []

                def record(*a, **k_):
                    calls.append((a, k_))
                    return kernel(*a, **k_)

                def twin(*a, rows=None, **st):
                    return (K.photonic_gemm_fused_twin if fused else K.photonic_gemm_twin)(*a, **st)

                whole = call(w, slice(None))
                try:
                    setattr(E, attr, record)
                    got = call(block, cols, columns=(origin, c), w_word=tweak_word(w))
                    setattr(E, attr, twin)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    plain = call(block, cols, columns=(origin, c), w_word=tweak_word(w))
                    torch.cuda.synchronize()
                    t_ms = (time.perf_counter() - t0) * 1e3
                finally:
                    setattr(E, attr, kernel)
                same = torch.equal(got, whole[:, cols])
                diff = (got.double() - plain.double()).abs()
                err = float(diff.max())
                # int32 sums bitwise; an f32 epilogue to f32 rounding; under noise, one-LSB
                # roundings of the Box-Muller draws at <= 0.1% of elements
                off = diff > (1e-6 * (1.0 + plain.double().abs()) if fused else 0.0)
                twin_ok = float(off.double().mean()) <= 1e-3 if name != "ideal" else not bool(off.any())
                (a, k_), = calls
                k_ms = graph_ms(lambda: kernel(*a, **k_))
                xi = torch.zeros((32, k), dtype=torch.int8, device=dev)
                xi[:r] = xq
                lib_ms = graph_ms(lambda: torch._int_mm(xi, block))
                stages, _ = E.kernel_stages(eng.dpu, r, k, width)
                passes, xdots = passes_of(eng.dpu, stages)
                draws = r * width * -(-k // stages["n_chunk"]) * passes if stages["noise_sigma"] > 0 else 0
                parts = bound_ms(r, k, width, 4 if fused else 1, passes, xdots, bool(fused), bool(fused), draws)
                b_ms, b_by = bound_of([parts])
                ok &= same and twin_ok
                rows_out.append(dict(model=model, site=site, channel=name, fused=fused, R=r, K=k, C=c, origin=origin,
                                     width=width, same_as_whole=same, max_abs_err=err, twin_ok=twin_ok,
                                     ms=k_ms, plain_ms=t_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                                     parts=parts))
                log(f"  (a') {model} {site} {name:5s} fused={fused}: columns [{origin}, {origin + width}) of {c} at "
                    f"c_origin {origin}: bitwise the whole launch's {same}; against the twin max |d| {err} "
                    f"({'ok' if twin_ok else 'FAILED'}); kernel {k_ms:.4f} ms, twin {t_ms:.3f} ms, _int_mm "
                    f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}) [{card}]")
    return ok


# Phase 10 (a''): (model, site, K, C, rows of the whole operand, origin, rows):
# deepseek-v2-lite's attn.wuk over the latent rows of a 4,096-position cache,
# a rank's 2,048 from 2,048 (phase 10 (g)'s second block) and 2,048 from 1,000
# (off the row tile of 128: its CTAs straddle two logical row tiles).
ROW_BLOCKS = [("deepseek-v2-lite-16b", "attn.wuk", 512, 2048, 4096, 2048, 2048),
              ("deepseek-v2-lite-16b", "attn.wuk", 512, 2048, 4096, 1000, 2048)]


def row_origin_rows(torch, K, chans, key, rows_out, card):
    """Phase 10 (a''): the kernel at a global row origin, through
    ``PhotonicEngine.int_gemm(rows=, x_word=)`` on the kernel backend: for
    each of ``ROW_BLOCKS``, ideal and SMWA under ``key``, ``fused`` 0 (int8
    x) and 1 (f32 x, the quantize prologue): the block's launch against
    those rows of the whole operand's launch (gate: bitwise, the noise ids
    and content word being the whole's), and against the block call with
    the kernel swapped for its twin on the card (bitwise ideal; under
    noise one-LSB roundings at <= 0.1% of elements).  Per case a row: the
    block's launch alone (CUDA graph of the recorded call), the twin call
    (host-timed once), ``torch._int_mm`` of the block's int core and the
    block's bound.  Returns ok."""
    import repro_torch.photonic.engine as E
    from repro_torch.core.dpu import quantize_symmetric, quantize_with_scale
    from repro_torch.kernels.photonic_gemm.epilogue import EpilogueArgs, EpilogueSpec
    from repro_torch.noise.stages import tweak_word

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(33)
    ok = True
    kernels = {0: "photonic_gemm", 1: "photonic_gemm_fused"}
    for name in ("ideal", "SMWA"):
        eng = E.PhotonicEngine(dpu=chans[name], backend="kernel")
        for model, site, k, c, total, origin, n in ROW_BLOCKS:
            x = torch.randn(total, k, generator=gen, device=dev)
            w = torch.randint(-127, 128, (k, c), generator=gen, device=dev, dtype=torch.int8)
            ws = torch.rand(c, generator=gen, device=dev) * 1e-3 + 1e-3
            xq, sx = quantize_symmetric(x, 8)
            sel = slice(origin, origin + n)
            for fused in (0, 1):
                kw = dict(site=site, fold=3, prng_key=key if name == "SMWA" else None)
                word = tweak_word(quantize_with_scale(x, sx, 8) if fused else xq)

                def call(rows_of, **extra):
                    ep = EpilogueArgs(EpilogueSpec(bias=False), sx, ws, None) if fused else None
                    return eng.int_gemm((x if fused else xq)[rows_of].contiguous(), w, epilogue=ep, **kw, **extra)

                attr = kernels[fused]
                kernel, calls = getattr(E, attr), []

                def record(*a, **k_):
                    calls.append((a, k_))
                    return kernel(*a, **k_)

                def twin(*a, rows=None, **st):
                    return (K.photonic_gemm_fused_twin if fused else K.photonic_gemm_twin)(*a, **st)

                whole = call(slice(None))
                try:
                    setattr(E, attr, record)
                    got = call(sel, rows=(origin, total), x_word=word)
                    setattr(E, attr, twin)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    plain = call(sel, rows=(origin, total), x_word=word)
                    torch.cuda.synchronize()
                    t_ms = (time.perf_counter() - t0) * 1e3
                finally:
                    setattr(E, attr, kernel)
                same = torch.equal(got, whole[sel])
                diff = (got.double() - plain.double()).abs()
                err = float(diff.max())
                off = diff > (1e-6 * (1.0 + plain.double().abs()) if fused else 0.0)
                twin_ok = float(off.double().mean()) <= 1e-3 if name != "ideal" else not bool(off.any())
                (a, k_), = calls
                k_ms = graph_ms(lambda: kernel(*a, **k_))
                block = xq[sel].contiguous()
                lib_ms = graph_ms(lambda: torch._int_mm(block, w))
                stages, _ = E.kernel_stages(eng.dpu, total, k, c)
                passes, xdots = passes_of(eng.dpu, stages)
                draws = n * c * -(-k // stages["n_chunk"]) * passes if stages["noise_sigma"] > 0 else 0
                parts = bound_ms(n, k, c, 4 if fused else 1, passes, xdots, False, bool(fused), draws)
                b_ms, b_by = bound_of([parts])
                ok &= same and twin_ok
                rows_out.append(dict(model=model, site=site, channel=name, fused=fused, R=n, K=k, C=c, origin=origin,
                                     total_rows=total, tile_r=stages["tile_r"], same_as_whole=same, max_abs_err=err,
                                     twin_ok=twin_ok, ms=k_ms, plain_ms=t_ms, library_ms=lib_ms, bound_ms=b_ms,
                                     bound_by=b_by, parts=parts))
                log(f"  (a'') {model} {site} {name:5s} fused={fused}: rows [{origin}, {origin + n}) of {total} at "
                    f"r_origin {origin} (tile_r {stages['tile_r']}): bitwise the whole launch's {same}; against the "
                    f"twin max |d| {err} ({'ok' if twin_ok else 'FAILED'}); kernel {k_ms:.4f} ms, twin {t_ms:.3f} ms, "
                    f"_int_mm {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}) [{card}]")
    return ok


def _ulps(torch, got, want):
    """The largest ``|got - want|`` in units of the last place of ``want``'s
    dtype (bf16 or f32) at ``want``'s magnitude."""
    bits = {torch.bfloat16: 8, torch.float32: 24}[want.dtype]
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - bits).clamp_min(2.0**-126)
    return float(((got.float() - w).abs() / ulp).max())


def _placement_decode(torch, arch, cfg, params, prompt, steps, mesh, place, log=None, after=None):
    """Phase 10 (a) and (d): a prefill and decode steps of ``cfg`` on
    ``mesh`` under TP over "model"; ``place`` "heads": the rows and heads
    placed (the parameters whole), "params": every name the arch places
    (``placement_sizes``: the rows, heads, ``d_ff``, vocab, and experts)
    and the parameters cut to this rank's blocks (``place_params``); the
    token blocks cut from the global ones, the logits gathered.  ``log``
    gets every GEMM of the forwards (``models.common.recording``) and a
    ``None`` before each forward; ``after()`` runs last, in the run's
    placement and TP scopes, untimed.  Returns (the global logits of each
    call, the cache leaves' shapes, seconds, the parameter bytes the rank
    held)."""
    from repro_torch.models.common import axes_tree, recording
    from repro_torch.models.registry import ShapeSpec
    from repro_torch.photonic import sharded
    from repro_torch.runtime import sharding as shd

    if place == "params":
        sizes = arch.placement_sizes(cfg, ShapeSpec("decode", PLACEMENT_MAX_SEQ, PLACEMENT_ROWS, "decode"))
    else:
        sizes = {"batch": PLACEMENT_ROWS, "heads": cfg.n_q_heads, "kv_heads": cfg.num_kv_heads}
    tok_axes, logit_axes = ("batch", None), ("batch", None, "vocab")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as scopes:
        scopes.enter_context(shd.use_rules(mesh))
        scopes.enter_context(sharded.tensor_parallel(mesh, "model"))
        if place:
            scopes.enter_context(shd.placement(mesh, sizes))
            prompt = shd.place_tree(prompt, tok_axes)
            if place == "params":
                params = shd.place_params(params, axes_tree(arch.param_defs(cfg)))
        held = sum(t.numel() * t.element_size() for t in _leaves(params))
        mark = (lambda: None) if log is None else (lambda: log.append(None))
        with torch.no_grad(), (contextlib.nullcontext() if log is None else recording(log)):
            mark()
            logits, cache = arch.prefill(params, {"tokens": prompt}, cfg, PLACEMENT_MAX_SEQ)
            out = [logits]
            for t in steps:
                mark()
                logits, cache = arch.decode(params, shd.place_tree(t, tok_axes) if place else t, cache, cfg)
                out.append(logits)
        if place:
            out = [shd.gather_tree(x, logit_axes) for x in out]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if after is not None:
            after()
    return out, {k: tuple(v.shape) for k, v in cache["layers"].items()}, secs, held


def _without_seq(arch):
    """``arch`` whose ``placement_sizes`` leaves ``seq_sp`` out (phase 10
    (b)'s placed run, against which (f) holds the run with it)."""
    from repro_torch.models.registry import Arch

    class NoSeq(Arch):
        def placement_sizes(self, cfg, shape, *, params=True):
            return {k: v for k, v in Arch.placement_sizes(self, cfg, shape, params=params).items() if k != "seq_sp"}

    return NoSeq(**{f.name: getattr(arch, f.name) for f in dataclasses.fields(arch)})


@contextlib.contextmanager
def _residual_log(log):
    """Every ``("batch", "seq_sp", None)`` constraint in the scope appends
    the shape of the residual it checks to ``log`` (phase 10 (f))."""
    from repro_torch.models import common as cm
    from repro_torch.runtime import sharding as shd

    inner = shd.logical_constraint

    def record(x, axes):
        if tuple(axes) == shd.RESIDUAL:
            log.append(tuple(x.shape))
        return inner(x, axes)

    cm.logical_constraint = shd.logical_constraint = record
    try:
        yield log
    finally:
        cm.logical_constraint = shd.logical_constraint = inner


def _seq_counts(**counts):
    """``contracts.SEQ_COLLECTIVES`` with ``counts`` and every other key 0."""
    from repro_torch.analysis import contracts

    return {k: counts.get(k, 0) for k in contracts.SEQ_COLLECTIVES}


def _seq_prefill(torch, K, arch, cfg, params, prompt, mesh):
    """Phase 10 (f): ``cfg``'s prefill of ``prompt`` on ``mesh`` under TP
    over "model" with the rows, heads and ``seq_sp`` placed (the parameters
    whole), the logits gathered; with the residual shapes its constraints
    saw, the sequence collectives, the launches and the seconds."""
    from repro_torch.analysis import contracts
    from repro_torch.models.registry import ShapeSpec
    from repro_torch.photonic import sharded
    from repro_torch.runtime import sharding as shd

    sizes = arch.placement_sizes(cfg, ShapeSpec("prefill", prompt.shape[1], prompt.shape[0], "prefill"), params=False)
    residuals = []
    _reset_counts(torch, K)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as scopes, torch.no_grad():
        scopes.enter_context(shd.use_rules(mesh))
        scopes.enter_context(sharded.tensor_parallel(mesh, "model"))
        scopes.enter_context(shd.placement(mesh, sizes))
        scopes.enter_context(_residual_log(residuals))
        logits, _ = arch.prefill(params, {"tokens": shd.place_tree(prompt, ("batch", None))}, cfg, PLACEMENT_MAX_SEQ)
        logits = shd.gather_tree(logits, ("batch", None, "vocab"))
    torch.cuda.synchronize()
    return dict(logits=logits, residuals=residuals, seq=dict(contracts.SEQ_COLLECTIVES), counts=_counts(K),
                seconds=time.perf_counter() - t0, sizes=sizes)


def placement_rank(rank, world, ckpt_dir, repeat=0):
    """One rank of phase 10 (module docstring, (a), (b), (b'), (d), (e),
    (f), (g) and (h)); with ``repeat``, then :func:`_kv_repeat`.  Returns
    this rank's results and gates."""
    import torch.distributed as dist

    torch, K, say = _tp_train_rank_setup(rank)
    from repro_torch.analysis import contracts
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.models import registry
    from repro_torch.models.common import init_params
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import TrainConfig, train

    card = card_line()
    mesh = build_mesh((2, 2), ("data", "model"))
    coords = (mesh.get_local_rank("data"), mesh.get_local_rank("model"))
    say(f"backend {dist.get_backend()} (CUDA tensors), mesh {mesh.mesh_dim_names} {tuple(mesh.mesh.shape)}, "
        f"coordinate (data {coords[0]}, model {coords[1]})")
    arch = registry.get("qwen2-0.5b")
    rng = np.random.default_rng(11)
    prompt = torch.from_numpy(rng.integers(0, arch.config.vocab_size, (PLACEMENT_ROWS, PLACEMENT_PROMPT))).cuda()
    steps = torch.from_numpy(rng.integers(0, arch.config.vocab_size, (PLACEMENT_STEPS, PLACEMENT_ROWS, 1))).cuda()
    forwards = 1 + PLACEMENT_STEPS
    gemms = 6 * arch.config.num_layers * forwards
    out, gates = {"rank": rank, "coords": coords}, {}
    # (a) the four-rank decode, replicated and placed, ideal and SMWA
    for name, dpu in (("ideal", ideal_dpu()), ("SMWA", smwa_dpu())):
        cfg = dataclasses.replace(arch.config.pad_for_mesh(2), photonic=dpu, photonic_backend="kernel")
        params = init_params(cfg, 0, "cuda", defs=arch.param_defs(cfg))
        runs = {}
        for label, place in (("replicated", None), ("placed", "heads"), ("params", "params")):
            _reset_counts(torch, K)
            logits, cache, secs, held = _placement_decode(torch, arch, cfg, params, prompt, steps, mesh, place)
            counts = dict(_counts(K), outputs=contracts.ROW_GATHERS["outputs"],
                          amax=contracts.SCALE_REDUCTIONS["amax"], heads=contracts.HEAD_GATHERS["heads"],
                          **{f"param_{k}": v for k, v in contracts.PARAM_REDUCES.items()})
            runs[label] = dict(logits=logits, cache=cache, seconds=secs, counts=counts, param_bytes=held,
                               max_memory_allocated=torch.cuda.max_memory_allocated())
        rep, placed, pp = runs["replicated"], runs["placed"], runs["params"]
        same = all(torch.equal(a, b) for a, b in zip(rep["logits"], placed["logits"]))
        worst = max(float((a.float() - b.float()).abs().max()) for a, b in zip(rep["logits"], placed["logits"]))
        finite = all(bool(torch.isfinite(x).all()) for x in placed["logits"] + pp["logits"])
        fp = hashlib.sha256(b"".join(x.float().cpu().numpy().tobytes() for x in placed["logits"])).hexdigest()[:16]
        fpp = hashlib.sha256(b"".join(x.float().cpu().numpy().tobytes() for x in pp["logits"])).hexdigest()[:16]
        # placed parameters: the hidden states are the photonic GEMMs', bitwise; the tied digital head
        # runs on the rank's vocab rows, a column block of cuBLAS's product: bitwise or within one ulp
        p_same = all(torch.equal(a, b) for a, b in zip(rep["logits"], pp["logits"]))
        p_ulps = max(_ulps(torch, b, a) for a, b in zip(rep["logits"], pp["logits"]))
        c, cp = placed["counts"], pp["counts"]
        layers = arch.config.num_layers
        gates[f"(a) {name} logits bitwise the replicated program's"] = same and finite
        gates[f"(a) {name} launches, all-reduces, no row gathers, scale reductions"] = (
            (c["photonic_gemm"], c["photonic_gemm_fused"], c["all_reduces"], c["row_gathers"], c["amax"],
             c["outputs"], c["heads"]) == (9 * layers * forwards, 0, 3 * layers * forwards, 0, gemms, forwards, 0))
        half = (layers, PLACEMENT_ROWS // 2, PLACEMENT_MAX_SEQ, 1, cfg.hd)
        gates[f"(a) {name} cache leaves a rank"] = placed["cache"] == {"k": half, "v": half} == pp["cache"]
        gates[f"(a) {name} placed parameters: logits {'bitwise' if p_same else 'within one bf16 ulp of'} the "
              f"replicated program's"] = p_same or p_ulps <= 1.0
        gates[f"(a) {name} placed parameters: launches, all-reduces, gathers"] = (
            (cp["photonic_gemm"], cp["photonic_gemm_fused"], cp["all_reduces"], cp["row_gathers"], cp["amax"],
             cp["outputs"], cp["heads"]) == (12 * layers * forwards, 0, 2 * layers * forwards, 0, gemms,
                                             2 * forwards, 0))
        gates[f"(a) {name} placed parameters: bytes a rank about half the whole"] = (
            0.45 < pp["param_bytes"] / rep["param_bytes"] < 0.55)
        out[name] = dict(same=same, max_abs=worst, fingerprint=fp, cache=placed["cache"], params_same=p_same,
                         params_ulps=p_ulps, params_fingerprint=fpp,
                         **{f"{k}_{m}": v[m] for k, v in runs.items() for m in ("seconds", "counts", "param_bytes",
                                                                                "max_memory_allocated")})
        say(f"(a) {name}: qwen2-0.5b prefill {PLACEMENT_ROWS} x {PLACEMENT_PROMPT} + {PLACEMENT_STEPS} decode steps, "
            f"placed (rows over data, 7 q / 1 KV heads a rank, parameters whole) against replicated: logits bitwise "
            f"{same} (max |d| {worst}), sha256 {fp}; placed {placed['seconds']:.2f} s, replicated "
            f"{rep['seconds']:.2f} s; placed counts {c} (want photonic_gemm {9 * layers * forwards}, fused 0, "
            f"all-reduces {3 * layers * forwards}, row gathers 0, amax {gemms}, outputs {forwards}); replicated counts "
            f"{rep['counts']}; cache {placed['cache']} (replicated {rep['cache']}); max_memory_allocated placed "
            f"{placed['max_memory_allocated'] / 2**30:.2f} GiB, replicated {rep['max_memory_allocated'] / 2**30:.2f} "
            f"GiB [{card}]")
        say(f"(a) {name}: parameters placed too (heads, KV heads, d_ff, vocab over model): logits bitwise {p_same}, "
            f"{p_ulps:.3g} bf16 ulps at most from the replicated program's, sha256 {fpp}; {pp['seconds']:.2f} s; "
            f"counts {cp} (want photonic_gemm {12 * layers * forwards}, all-reduces {2 * layers * forwards}, "
            f"outputs {2 * forwards}); parameter bytes a rank {pp['param_bytes']} against {rep['param_bytes']} "
            f"whole ({pp['param_bytes'] / rep['param_bytes']:.4f}); max_memory_allocated "
            f"{pp['max_memory_allocated'] / 2**30:.2f} GiB [{card}]")
        # (f) the prefill with the residual's sequence placed too (seq_sp over "model"), against (a)'s replicated one
        fs = _seq_prefill(torch, K, arch, cfg, params, prompt, mesh)
        f_same = torch.equal(fs["logits"], rep["logits"][0]) and bool(torch.isfinite(fs["logits"]).all())
        block = (PLACEMENT_ROWS // 2, PLACEMENT_PROMPT // 2, cfg.d_model)
        gates[f"(f) {name} seq_sp prefill: logits bitwise the replicated program's"] = f_same
        gates[f"(f) {name} seq_sp prefill: the residual between blocks a rank's block"] = (
            fs["residuals"] == [block] * layers)
        gates[f"(f) {name} seq_sp prefill: two sequence gathers a layer and one for the last position, two "
              f"reduce-scatters a layer (attn.wo, ffn.wo), no all-reduce of a block's output"] = (
            fs["seq"] == _seq_counts(gather=2 * layers + 1, scatter=2 * layers))
        out[name]["seq_prefill"] = dict(same=f_same, residual=fs["residuals"][:1], seq=fs["seq"],
                                        counts=fs["counts"], seconds=fs["seconds"])
        say(f"(f) {name}: qwen2-0.5b prefill {PLACEMENT_ROWS} x {PLACEMENT_PROMPT} with rows, heads and seq_sp placed "
            f"({fs['sizes']}): logits bitwise (a)'s replicated prefill {f_same}; the residual between blocks "
            f"{fs['residuals'][0] if fs['residuals'] else None} a rank at each of {len(fs['residuals'])} constraints "
            f"(the whole is ({PLACEMENT_ROWS}, {PLACEMENT_PROMPT}, {cfg.d_model})); sequence collectives {fs['seq']}; "
            f"counts {fs['counts']}; {fs['seconds']:.2f} s [{card}]")
        del params, runs, rep, placed, pp
        torch.cuda.empty_cache()
    # (b) train(mesh=) with the rows placed against the replicated program
    data, opt = _train_inputs(arch)
    cfg = dataclasses.replace(arch.config, num_layers=TP_TRAIN_GRID_LAYERS, photonic=ideal_dpu(),
                              photonic_backend="kernel")
    runs = {}
    # (b) the rows and heads placed against the replicated run; (f) seq_sp placed too against (b)'s placed run
    for label, place, a in (("replicated", False, arch), ("placed", True, _without_seq(arch)), ("seq", True, arch)):
        _reset_counts(torch, K)
        res = train(arch=a, model_cfg=cfg, data_cfg=data,
                    train_cfg=TrainConfig(steps=PLACEMENT_TRAIN_STEPS, ckpt_every=1000,
                                          ckpt_dir=os.path.join(ckpt_dir, label), log_every=100),
                    opt_cfg=opt, mesh=mesh, tp_axis="model", place_rows=place, log=lambda m: None, device="cuda")
        runs[label] = dict(losses=res["losses"], params=_leaves(res["params"]), step_seconds=res["step_seconds"],
                           counts=dict(_counts(K), **{f"seq_{k}": v for k, v in contracts.SEQ_COLLECTIVES.items()}),
                           max_memory_allocated=torch.cuda.max_memory_allocated())
        del res
    rep, placed, seq = runs["replicated"], runs["placed"], runs["seq"]
    lrs = [float(adamw.schedule_lr(opt, torch.tensor(i + 1))) for i in range(PLACEMENT_TRAIN_STEPS)]
    bound = 2 * sum(lrs)

    def within_of(got, want):
        worst, within = 0.0, True
        for a, b in zip(got["params"], want["params"]):
            d = (a.float() - b.float()).abs()
            ulp = (b.float().abs() * 2.0**-7).clamp_min(2.0**-133)
            worst = max(worst, float(d.max()))
            within &= bool((d <= bound + ulp).all())
        return worst, within, all(abs(x - y) <= 1e-3 * abs(y) for x, y in zip(got["losses"], want["losses"]))

    worst, within, loss_ok = within_of(placed, rep)
    gates["(b) losses within rtol 1e-3 of the replicated run"] = loss_ok
    gates["(b) parameters within 2 x steps x lr + one bf16 rounding"] = within
    gates["(b) no row gathers when placed"] = placed["counts"]["row_gathers"] == 0
    s_worst, s_within, s_loss_ok = within_of(seq, placed)
    s_bitwise = seq["losses"] == placed["losses"] and all(torch.equal(a, b) for a, b in zip(seq["params"],
                                                                                             placed["params"]))
    gates["(f) train with seq_sp placed: losses within rtol 1e-3 of (b)'s placed run"] = s_loss_ok
    gates["(f) train with seq_sp placed: parameters within (b)'s bound of its placed run's"] = s_within
    gates["(f) train with seq_sp placed: the residual gathered, the blocks' outputs reduce-scattered and their "
          "gradients' blocks gathered"] = (
        seq["counts"]["seq_gather"] > 0 and seq["counts"]["seq_split_grad"] > 0 and seq["counts"]["seq_scatter"] > 0
        and seq["counts"]["row_gathers"] == 0)
    out["train"] = dict(losses=placed["losses"], replicated_losses=rep["losses"], max_abs_param=worst, bound=bound,
                        step_seconds=placed["step_seconds"], replicated_step_seconds=rep["step_seconds"],
                        counts=placed["counts"], replicated_counts=rep["counts"],
                        max_memory_allocated=placed["max_memory_allocated"],
                        replicated_max_memory_allocated=rep["max_memory_allocated"])
    say(f"(b) train(mesh=(2, 2), tp_axis='model') at {TP_TRAIN_GRID_LAYERS} layers, {PLACEMENT_TRAIN_STEPS} steps of "
        f"{data.global_batch} x {data.seq_len}: placed (rows and heads; parameters whole) losses {placed['losses']} against replicated {rep['losses']}; "
        f"max |p_placed - p_replicated| {worst:.4g} (bound 2 x sum lr = {bound:.4g} + a bf16 rounding); steps "
        f"placed {[round(x, 3) for x in placed['step_seconds']]} s, replicated "
        f"{[round(x, 3) for x in rep['step_seconds']]} s; row gathers placed {placed['counts']['row_gathers']}, "
        f"replicated {rep['counts']['row_gathers']}; peak memory a rank placed "
        f"{placed['max_memory_allocated'] / 2**30:.2f} GiB, replicated {rep['max_memory_allocated'] / 2**30:.2f} GiB "
        f"[{card}]")
    out["train_seq"] = dict(losses=seq["losses"], max_abs_param=s_worst, bitwise=s_bitwise,
                            step_seconds=seq["step_seconds"], counts=seq["counts"],
                            max_memory_allocated=seq["max_memory_allocated"])
    say(f"(f) train(mesh=(2, 2), tp_axis='model') at {TP_TRAIN_GRID_LAYERS} layers with seq_sp placed too (the "
        f"residual {data.seq_len // 2} positions a rank between blocks): losses {seq['losses']} against (b)'s placed "
        f"run's {placed['losses']}; max |p_seq - p_placed| {s_worst:.4g}, bitwise {s_bitwise}; steps "
        f"{[round(x, 3) for x in seq['step_seconds']]} s; sequence gathers {seq['counts']['seq_gather']}, gradient "
        f"gathers {seq['counts']['seq_split_grad']}, reduce-scatters {seq['counts']['seq_scatter']}; peak memory a rank {seq['max_memory_allocated'] / 2**30:.2f} GiB "
        f"against {placed['max_memory_allocated'] / 2**30:.2f} GiB without seq_sp [{card}]")
    del runs, rep, placed, seq
    torch.cuda.empty_cache()
    out["dry_train"] = _placement_dry_train(torch, K, arch, cfg, data, mesh, gates, say, card)
    del data
    torch.cuda.empty_cache()
    out["moe"] = placement_moe(torch, K, mesh, gates, say, card)
    out["families"] = placement_families(torch, K, mesh, gates, say, card)
    out["kv"] = placement_kv(torch, K, mesh, gates, say, card)
    out["stress"] = placement_stress(torch, mesh, gates, say, card)
    if repeat:
        out["repeat"] = _kv_repeat(torch, K, mesh, say, card, repeat)
    out["gates"] = gates
    for k, v in gates.items():
        say(f"{k}: {v}")
    return out


def _placement_dry_train(torch, K, arch, cfg, data, mesh, gates, say, card):
    """Phase 10 (b'): the dry run's train step (``dryrun.build_step``: the
    parameters placed by their ``param_axes``, ZeRO-1 moments over "data",
    the gradient norm over the placed leaves, TP over "model") run for real
    on ``cfg`` for ``PLACEMENT_TRAIN_STEPS`` steps of phase 7's data,
    against the replicated step (``build_train_step`` on whole parameters
    and the whole batch, every rank the same) with the dry run's optimizer
    settings: losses within ``rtol=1e-3``, every parameter block within
    ``2 x steps x lr`` plus one bf16 rounding of its value."""
    from repro_torch.analysis import contracts
    from repro_torch.data.pipeline import SyntheticTokens, make_global_batch
    from repro_torch.launch import dryrun
    from repro_torch.models.common import axes_tree, init_params
    from repro_torch.models.registry import ShapeSpec
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.train_loop import build_train_step

    shape = ShapeSpec("train", data.seq_len, data.global_batch, "train")
    defs = arch.param_defs(cfg)
    axes = axes_tree(defs)
    opt = adamw.AdamWConfig()  # the dry run's train step's
    stream = SyntheticTokens(data)
    batches = [make_global_batch(stream, i, "cuda") for i in range(PLACEMENT_TRAIN_STEPS)]
    params = init_params(cfg, 0, "cuda", defs=defs)
    _reset_counts(torch, K)
    step = build_train_step(lambda p, b: arch.loss(p, b, cfg), opt)
    p_rep, s_rep, rep_losses, rep_secs = params, adamw.init(params), [], []
    for b in batches:
        t0 = time.perf_counter()
        p_rep, s_rep, m = step(p_rep, s_rep, b)
        rep_losses.append(float(m["loss"]))
        rep_secs.append(time.perf_counter() - t0)
    rep_mem = torch.cuda.max_memory_allocated()
    del s_rep
    _reset_counts(torch, K)
    placed_step = dryrun.build_step(arch, cfg, shape, mesh)
    batch_axes = {"tokens": ("batch", None), "labels": ("batch", None)}
    with shd.use_rules(mesh):
        with shd.placement(mesh, arch.placement_sizes(cfg, shape)):
            p = shd.place_params(params, axes)
            want = shd.place_params(p_rep, axes)
            local = [shd.place_tree(b, batch_axes) for b in batches]
        held = sum(t.numel() * t.element_size() for t in _leaves(p))
        del params, p_rep
        torch.cuda.empty_cache()
        s = adamw.init(p, adamw.zero1(defs, axes, mesh))
        losses, secs = [], []
        for b in local:
            t0 = time.perf_counter()
            p, s, m = placed_step(p, s, b)
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t0)
    counts = dict(_counts(K), **{f"param_{k}": v for k, v in contracts.PARAM_REDUCES.items()})
    lrs = [float(adamw.schedule_lr(opt, torch.tensor(i + 1))) for i in range(PLACEMENT_TRAIN_STEPS)]
    bound = 2 * sum(lrs)
    worst, within = 0.0, True
    for a, b in zip(_leaves(p), _leaves(want)):
        d = (a.float() - b.float()).abs()
        ulp = (b.float().abs() * 2.0**-7).clamp_min(2.0**-133)
        worst = max(worst, float(d.max()))
        within &= bool((d <= bound + ulp).all())
    loss_ok = all(abs(x - y) <= 1e-3 * abs(y) for x, y in zip(losses, rep_losses))
    gates["(b') the dry run's placed train step: losses within rtol 1e-3 of the replicated step"] = loss_ok
    gates["(b') the dry run's placed train step: parameter blocks within 2 x steps x lr + one bf16 rounding"] = within
    res = dict(losses=losses, replicated_losses=rep_losses, max_abs_param=worst, bound=bound, step_seconds=secs,
               replicated_step_seconds=rep_secs, counts=counts, param_bytes=held,
               max_memory_allocated=torch.cuda.max_memory_allocated(), replicated_max_memory_allocated=rep_mem)
    say(f"(b') the dry run's train step on placed parameters (heads, KV heads, d_ff, vocab over model; ZeRO-1 over "
        f"data) at {cfg.num_layers} layers, {PLACEMENT_TRAIN_STEPS} steps of {data.global_batch} x {data.seq_len}: "
        f"losses {losses} against the replicated step's {rep_losses}; max |p - p_replicated| {worst:.4g} (bound "
        f"{bound:.4g} + a bf16 rounding); steps {[round(x, 3) for x in secs]} s, replicated "
        f"{[round(x, 3) for x in rep_secs]} s; counts {counts}; parameter bytes a rank {held}; peak memory a rank "
        f"{res['max_memory_allocated'] / 2**30:.2f} GiB, replicated {rep_mem / 2**30:.2f} GiB [{card}]")
    return res


def _replay_gemms(torch, rep_log, placed_log, cfg, shift=False):
    """Phase 10 (d), in the placed run's scopes: every routed GEMM of the
    placed run called again on this rank's block (rows, and K where it is
    placed) of the replicated run's input to it, against this rank's rows
    and columns of the replicated run's output.  The activation scale is a
    ``MAX`` over every rank's block, a row-parallel GEMM sums every K block
    and the noise ids are the whole weight's, so the GEMM gives the
    replicated program's output bit for bit only if each of its forms
    (column-parallel at its column origin, row-parallel, K-sharded) is
    right, whatever the digital ops upstream rounded.  ``shift``: each
    column segment's origin moved one block on (the negative control).
    Returns (sites checked, bitwise count, mismatches as (forward, site,
    layer, max |d|), the first GEMM whose own input differed from the
    replicated program's as (forward, site, layer, max |d|))."""
    from repro_torch.models.common import dense, engine_from_model_config
    from repro_torch.runtime import sharding as shd

    def mine(t, rows, segments=None, kb=None, seq=None):
        if rows is not None:
            t = t.narrow(0, rows[0] * rows[1], rows[1])
        if seq is not None:  # an operand of a rank's cache block (kv_seq rows)
            t = t.narrow(1, seq[0] * seq[1], seq[1])
        if segments is not None:
            t = torch.cat([t.narrow(-1, o, w) for o, w in segments], dim=-1)
        if kb is not None:
            n = t.shape[-1] // kb[1]
            t = t.narrow(-1, kb[0] * n, n)
        return t

    if len(rep_log) != len(placed_log):
        return [], 0, [("calls", len(rep_log), len(placed_log))], None
    eng, layout_of = engine_from_model_config(cfg), shd.column_layout

    def shifted(parts):
        lay = layout_of(parts)
        return lay if lay is None else dataclasses.replace(
            lay, segments=tuple(((o + w) % lay.total, w) for o, w in lay.segments))

    checked, same, bad, first, forward = set(), 0, [], None, -1
    try:
        if shift:
            shd.column_layout = shifted
        for rep, got in zip(rep_log, placed_log):
            if rep is None or got is None:
                forward += 1
                if rep is not got:
                    bad.append(("forward boundary", forward))
                continue
            if (rep.site, rep.layer) != (got.site, got.layer):
                bad.append((forward, got.site, got.layer, "another call"))
                continue
            if not eng.routes(got.site):
                continue
            x = mine(rep.x, got.rows, kb=got.k_block, seq=got.seq)
            if first is None and not (x.shape == got.x.shape and torch.equal(x, got.x)):
                first = (forward, got.site, got.layer,
                         float((x.float() - got.x.float()).abs().max()) if x.shape == got.x.shape else None)
            with torch.no_grad(), (shd.rows_over("kv_seq") if got.seq else contextlib.nullcontext()):
                y = dense(got.params, x, cfg, **got.kwargs)
            want = mine(rep.y, got.rows, got.segments, seq=got.seq)
            checked.add(f"{got.site}@{got.layer}")
            if want.shape == y.shape and torch.equal(want, y):
                same += 1
            else:
                bad.append((forward, got.site, got.layer,
                            float((y.float() - want.float()).abs().max()) if want.shape == y.shape else None))
    finally:
        shd.column_layout = layout_of
    return sorted(checked), same, bad, first


def _moe_forward_counts(name, absorbed):
    """Phase 10 (d): what one placed forward of ``PLACEMENT_MOE``'s cut
    reduces (deepseek-v2-lite: 3 layers, the first dense; phi3.5-moe: 2 MoE
    layers): psums of the row-parallel GEMMs and of ``wdkv`` (whole, K-sharded
    as in the TP program), routed GEMMs (one scale ``MAX`` each), content
    words of the noisy column-parallel GEMMs, weight-scale ``MAX``es of the
    row-parallel ones, expert combines; for the prefill and for a decode step."""
    if name.startswith("deepseek"):
        # wq wdkv wuk wuv wo + (ffn.wi ffn.wo | shared wi wo) a layer, lm_head; absorbed decode: no wuk / wuv
        routed, cols = 22, 13
        return dict(psum=9, routed=(routed, routed - (6 if absorbed else 0)), cols=(cols, cols - (6 if absorbed else 0)),
                    rows=6, moe=2)
    return dict(psum=2, routed=(9, 9), cols=(7, 7), rows=2, moe=2)  # wq wk wv wo a layer, lm_head


@contextlib.contextmanager
def _dropped_combine(torch):
    """Phase 10 (d)'s negative control: the expert-parallel MoE with the
    partial combine of the ranks at "model" index 1 zeroed before the sum,
    as a lost or skipped partial would leave it."""
    from repro_torch.models import ffn
    from repro_torch.runtime import sharding as shd

    inner = ffn.reduce_rows

    def dropped(x, part, what="row_output"):
        if what == "expert_combine" and shd.block("experts").index == 1:
            x = torch.zeros_like(x)
        return inner(x, part, what)

    ffn.reduce_rows = dropped
    try:
        yield
    finally:
        ffn.reduce_rows = inner


def placement_moe(torch, K, mesh, gates, say, card):
    """Phase 10 (d): for each of ``PLACEMENT_MOE`` at full width (its depth
    cut), a prefill of ``PLACEMENT_ROWS`` x ``PLACEMENT_PROMPT`` tokens and
    ``PLACEMENT_MOE_STEPS`` decode steps under TP over "model" on the kernel
    backend, the replicated program (whole parameters, nothing placed)
    against everything placed (rows, heads, ``d_ff``, vocab and experts;
    ``place_params``).  Gates: every routed GEMM of the placed run, called
    again on this rank's block of the replicated program's input to it,
    gives this rank's block of its output bit for bit
    (:func:`_replay_gemms`: the column-parallel, row-parallel and K-sharded
    forms, ideal and SMWA; the first GEMM whose own input a digital op
    upstream rounded otherwise is printed: on the card a batched product's
    kernel follows its batch count, which placed rows and heads halve);
    ideal: the logits within 2^-5 of their largest (the port's bf16 MoE
    bar: the combine sums in another order); the placed run's reductions,
    no GEMM row gathered, parameter bytes a rank about half the whole.
    SMWA logits are not gated end to end: a GEMM whose int8 input moved
    by one code draws another noise stream (its activation word is folded
    into the seed), so the placed and replicated runs part after the first
    such GEMM; their distance from their ideal runs is printed.  Negative
    controls, on deepseek-v2-lite expanded: ideal, a placed run with one
    rank's partial combine dropped (:func:`_dropped_combine`) must fail the
    logits gate; SMWA, the replay with every column origin one block on
    must fail the replay gate.  Returns the results."""
    from repro_torch.analysis import contracts
    from repro_torch.models import registry
    from repro_torch.models.common import init_params

    def rms(a, b):
        return math.sqrt(sum(float(((x.float() - y.float()) ** 2).sum()) for x, y in zip(a, b))
                         / sum(x.numel() for x in a))

    def worst_of(a, b):
        return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))

    res = {}
    for name, layers, cases in PLACEMENT_MOE:
        arch = registry.get(name)
        base = dataclasses.replace(arch.config, num_layers=layers).pad_for_mesh(2)
        rng = np.random.default_rng(13)
        prompt = torch.from_numpy(rng.integers(0, base.vocab_size, (PLACEMENT_ROWS, PLACEMENT_PROMPT))).cuda()
        steps = torch.from_numpy(rng.integers(0, base.vocab_size, (PLACEMENT_MOE_STEPS, PLACEMENT_ROWS, 1))).cuda()
        params = init_params(base, 0, "cuda", defs=arch.param_defs(base))
        forwards = 1 + PLACEMENT_MOE_STEPS
        ideal = {}
        for label, channel, absorbed in cases:
            cfg = dataclasses.replace(base, photonic=ideal_dpu() if channel == "ideal" else smwa_dpu(),
                                      photonic_backend="kernel", mla_absorb=absorbed)
            noisy = channel != "ideal"
            control = name.startswith("deepseek") and not absorbed
            runs = {}
            for run, place in (("replicated", None), ("placed", "params")):
                _reset_counts(torch, K)
                log, snap = [], {}

                def after(run=run, log=log, snap=snap):
                    snap["counts"] = dict(_counts(K), outputs=contracts.ROW_GATHERS["outputs"],
                                          amax=contracts.SCALE_REDUCTIONS["amax"],
                                          heads=contracts.HEAD_GATHERS["heads"],
                                          **{f"param_{k}": v for k, v in contracts.PARAM_REDUCES.items()})
                    snap["max_memory_allocated"] = torch.cuda.max_memory_allocated()
                    if run == "placed":
                        snap["replay"] = _replay_gemms(torch, runs["replicated"]["log"], log, cfg)
                        if control and noisy:
                            snap["shifted"] = _replay_gemms(torch, runs["replicated"]["log"], log, cfg, shift=True)

                logits, cache, secs, held = _placement_decode(torch, arch, cfg, params, prompt, steps, mesh,
                                                              place, log=log, after=after)
                runs[run] = dict(logits=logits, log=log, seconds=secs, param_bytes=held, **snap)
            rep, pp = runs["replicated"], runs["placed"]
            checked, same, bad, first = pp["replay"]
            worst = worst_of(rep["logits"], pp["logits"])
            scale = max(float(a.float().abs().max()) for a in rep["logits"])
            agree = float(sum(int((a.argmax(-1) == b.argmax(-1)).sum()) for a, b in zip(rep["logits"], pp["logits"]))
                          / (forwards * PLACEMENT_ROWS))
            finite = all(bool(torch.isfinite(x).all()) for x in pp["logits"])
            fp = hashlib.sha256(b"".join(x.float().cpu().numpy().tobytes() for x in pp["logits"])).hexdigest()[:16]
            want = _moe_forward_counts(name, absorbed)
            c = pp["counts"]
            routed = want["routed"][0] + PLACEMENT_MOE_STEPS * want["routed"][1]
            cols = want["cols"][0] + PLACEMENT_MOE_STEPS * want["cols"][1]
            got_counts = (c["photonic_gemm_fused"], c["all_reduces"], c["row_gathers"], c["amax"], c["outputs"],
                          c["heads"], c["param_weight_words"], c["param_weight_scale"], c["param_expert_combine"])
            want_counts = (0, want["psum"] * forwards, 0, routed, 2 * forwards, 0, cols if noisy else 0,
                           want["rows"] * forwards, want["moe"] * forwards)
            key = f"(d) {name} at {layers} layers, {label}"
            control_res = None
            if noisy:
                ref = ideal[absorbed]
                noise = (rms(pp["logits"], ref["placed"]), rms(rep["logits"], ref["replicated"]))
                if control:
                    s_checked, s_same, s_bad, _ = pp["shifted"]
                    control_res = dict(shifted_same=s_same, shifted_bad=len(s_bad), shifted_first_bad=s_bad[:2])
                    gates[f"{key}: negative control, every column origin one block on: the replay gate fails"] = (
                        len(s_bad) > 0)
            else:
                ideal[absorbed] = dict(placed=pp["logits"], replicated=rep["logits"])
                noise = None
                gates[f"{key}: logits within 2^-5 of their largest of the replicated program's"] = (
                    finite and worst <= 2.0**-5 * scale)
                if control:
                    with _dropped_combine(torch):
                        dropped, _, _, _ = _placement_decode(torch, arch, cfg, params, prompt, steps, mesh, "params")
                    control_res = dict(dropped_worst=worst_of(rep["logits"], dropped))
                    gates[f"{key}: negative control, one rank's partial combine dropped: the logits gate fails"] = (
                        control_res["dropped_worst"] > 2.0**-5 * scale)
            gates[f"{key}: every routed GEMM, replayed on the replicated program's input, bitwise its output"] = (
                not bad and same > 0)
            gates[f"{key}: fused launches, psums, row gathers, scale MAXes, gathers, content words, weight "
                  f"scales, expert combines"] = got_counts == want_counts
            gates[f"{key}: parameter bytes a rank about half the whole"] = 0.45 < pp["param_bytes"] / rep["param_bytes"] < 0.55
            res[f"{name} {label}"] = dict(
                max_abs=worst, scale=scale, argmax_agree=agree, noise_rms=noise, fingerprint=fp, gemms_checked=checked,
                gemms_same=same, gemms_bad=bad[:8], first_input_difference=first, control=control_res, counts=c,
                replicated_counts=rep["counts"], seconds=pp["seconds"], replicated_seconds=rep["seconds"],
                param_bytes=pp["param_bytes"], replicated_param_bytes=rep["param_bytes"],
                max_memory_allocated=pp["max_memory_allocated"],
                replicated_max_memory_allocated=rep["max_memory_allocated"],
                launches_a_forward=c["photonic_gemm"] / forwards)
            say(f"{key}: prefill {PLACEMENT_ROWS} x {PLACEMENT_PROMPT} + {PLACEMENT_MOE_STEPS} decode steps, placed "
                f"(rows, heads, d_ff, vocab, experts over model) against replicated: max |d logits| {worst:.4g} of "
                f"{scale:.4g} (ideal bar 2^-5 x), greedy tokens agree {agree:.3f}, noise rms placed / replicated "
                f"{noise}, sha256 {fp}; routed GEMMs replayed on the replicated program's input: {same} bitwise "
                f"({len(checked)} sites), mismatches {bad[:4]}; first GEMM whose own input differs (forward, site, "
                f"layer, max |d|): {first}; negative control {control_res}; placed counts {c} (want "
                f"{dict(zip(('fused', 'psum', 'tp_rows', 'amax', 'outputs', 'heads', 'words', 'scales', 'combines'), want_counts))}); "
                f"photonic_gemm launches {c['photonic_gemm'] / forwards:.1f} a forward (replicated "
                f"{rep['counts']['photonic_gemm'] / forwards:.1f}); {pp['seconds']:.2f} s placed, "
                f"{rep['seconds']:.2f} s replicated; parameter bytes a rank {pp['param_bytes']} against "
                f"{rep['param_bytes']} whole ({pp['param_bytes'] / rep['param_bytes']:.4f}); max_memory_allocated "
                f"placed {pp['max_memory_allocated'] / 2**30:.2f} GiB, replicated "
                f"{rep['max_memory_allocated'] / 2**30:.2f} GiB [{card}]")
            del runs, rep, pp
        del params, ideal
        torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def _dropped_max():
    """Phase 10 (g)'s negative control: the decode softmax's row max kept
    rank-local, its ``MAX`` all-reduce over the ``kv_seq`` blocks
    skipped."""
    from repro_torch.runtime import sharding as shd

    inner = shd.kv_merge

    def merge(t, op):
        return t if op == "max" else inner(t, op)

    shd.kv_merge = merge
    try:
        yield
    finally:
        shd.kv_merge = inner


def _kv_prefill(torch, arch, cfg, params, prompt):
    """Phase 10 (g): one row's prefill of ``prompt`` into a cache of
    ``KV_SEQ_MAX`` positions, every rank the whole program alone (no mesh
    scope: no collective, the replicated and placed decode runs start from
    the same cache)."""
    with torch.no_grad():
        _, cache = arch.prefill(params, {"tokens": prompt}, cfg, KV_SEQ_MAX)
    return cache


def _kv_decode(torch, K, arch, cfg, params, cache, steps, mesh, placed, log=None, after=None, tp=True):
    """Phase 10 (g): one row's decode ``steps`` on a copy of the prefill's
    ``cache`` under TP over "model" (with ``tp``; else every rank runs the
    single-device program on its blocks), the parameters whole; ``placed``: the
    rows (which fall back), heads and ``kv_seq`` placed
    (``placement_sizes(params=False)``), the cache cut to this rank's block
    of positions and KV heads, the decode softmax merged across the blocks.
    ``log`` / ``after`` as :func:`_placement_decode`'s.  Returns (the
    logits of each step, the cache leaves' shapes, the sequence
    collectives, seconds)."""
    from repro_torch._tree import tree_map
    from repro_torch.analysis import contracts
    from repro_torch.models.common import recording
    from repro_torch.models.registry import ShapeSpec
    from repro_torch.photonic import sharded
    from repro_torch.runtime import sharding as shd

    shape = ShapeSpec("decode", KV_SEQ_MAX, 1, "decode")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as scopes:
        scopes.enter_context(shd.use_rules(mesh))
        if tp:
            scopes.enter_context(sharded.tensor_parallel(mesh, "model"))
        if placed:
            scopes.enter_context(shd.placement(mesh, arch.placement_sizes(cfg, shape, params=False)))
            cache = shd.place_tree(cache, arch.decode_specs(cfg, shape)[1][1])
        else:
            cache = tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, cache)
        mark = (lambda: None) if log is None else (lambda: log.append(None))
        out = []
        with torch.no_grad(), (contextlib.nullcontext() if log is None else recording(log)):
            for t in steps:
                mark()
                logits, cache = arch.decode(params, t, cache, cfg)
                out.append(logits)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        seq = dict(contracts.SEQ_COLLECTIVES)
        if after is not None:
            after()
    shapes = {f"{k}/{n}": tuple(v.shape) for k in ("layers", "first") for n, v in cache.get(k, {}).items()}
    return out, shapes, seq, secs


@contextlib.contextmanager
def _origin_at_zero():
    """Phase 10 (g)'s negative control: every block of a placed
    ``kv_seq``'s rows drawn at row origin 0."""
    from repro_torch.runtime import sharding as shd

    inner = shd.row_segments

    def zero(lead):
        seg = inner(lead)
        return seg if seg is None else ((0,) * len(seg[0]), seg[1])

    shd.row_segments = zero
    try:
        yield
    finally:
        shd.row_segments = inner


@contextlib.contextmanager
def _block_word():
    """Phase 10 (g)'s negative control: a block of a placed ``kv_seq``'s
    rows draws with its own content word (no SUM over the blocks)."""
    from repro_torch.noise.stages import U32
    from repro_torch.runtime import sharding as shd

    inner = shd.rows_word
    shd.rows_word = lambda word: word & U32
    try:
        yield
    finally:
        shd.rows_word = inner


# Phase 10 (g)'s runs: (arch, layers, ((channel, mla_absorb, TP over "model"), ...)).
# deepseek-v2-lite's SMWA expanded run has no TP scope: the replicated
# program then runs the latent rows whole, and a rank's block of them runs at
# its global row origin with the whole operand's content word.
KV_SEQ_RUNS = (("qwen2-0.5b", None, (("ideal", False, True), ("SMWA", False, True))),
               ("deepseek-v2-lite-16b", 3, (("ideal", False, True), ("ideal", True, True), ("SMWA", False, False))))


def placement_kv(torch, K, mesh, gates, say, card):
    """Phase 10 (g): ``kv_seq``, one row's decode cache over "data".
    qwen2-0.5b at full width, ideal and keyed SMWA, and deepseek-v2-lite at
    (d)'s 3 layers, ideal, expanded and absorbed, and keyed SMWA expanded
    without a TP scope (:data:`KV_SEQ_RUNS`): a prefill of
    ``KV_SEQ_PROMPT`` tokens into a cache of ``KV_SEQ_MAX`` positions (the
    whole program on every rank, :func:`_kv_prefill`), then
    ``PLACEMENT_STEPS`` decode steps writing positions 2,046-2,049 across
    the blocks' boundary, the replicated program against the rows (one,
    falling back), heads and ``kv_seq`` placed, both from that cache.
    Gates: every routed GEMM of the placed steps replayed on this rank's
    block of the replicated steps' input bitwise its output (an expanded
    MLA decode's ``wuk`` / ``wuv`` on the rank's rows of the latent cache);
    ideal logits within 2^-5 of their largest, and every run's within 1e-5
    of it (the CPU tests' bar for the merge); one ``MAX`` and one SUM
    all-reduce a decode attention; each cache leaf a rank of ``KV_SEQ_MAX /
    2`` positions.  Negative control: qwen2-0.5b ideal with the row max's
    ``MAX`` skipped (:func:`_dropped_max`; the second block is all masked
    for the first two steps) must fail the logits gate.  deepseek-v2-lite
    SMWA expanded, whose ``wuk`` / ``wuv`` run on the fused kernel at
    their blocks' row origins (one SUM of the whole operand's content word
    each): two more controls, whose replays must fail on ``wuk`` and
    ``wuv`` (:func:`_origin_at_zero`, on the second block's ranks, the
    first's origin being 0; :func:`_block_word`, on every rank).  Returns
    the results."""
    import torch.distributed as dist

    from repro_torch.models import registry
    from repro_torch.models.common import init_params
    from repro_torch.runtime import collectives

    def worst_of(a, b):
        return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))

    res = {}
    data = mesh.get_local_rank("data")
    for name, layers, runs_of in KV_SEQ_RUNS:
        arch = registry.get(name)
        base = (arch.config if layers is None else dataclasses.replace(arch.config, num_layers=layers)).pad_for_mesh(2)
        params = init_params(base, 0, "cuda", defs=arch.param_defs(base))
        rng = np.random.default_rng(KV_SEQ_PROMPT)
        prompt = torch.from_numpy(rng.integers(0, base.vocab_size, (1, KV_SEQ_PROMPT))).cuda()
        steps = torch.from_numpy(rng.integers(0, base.vocab_size, (PLACEMENT_STEPS, 1, 1))).cuda()
        prefilled = {}
        for channel, absorbed, tp in runs_of:
            cfg = dataclasses.replace(base, photonic=ideal_dpu() if channel == "ideal" else smwa_dpu(),
                                      photonic_backend="kernel", mla_absorb=absorbed)
            if channel not in prefilled:  # the prefill does not read mla_absorb
                t0 = time.perf_counter()
                prefilled[channel] = (_kv_prefill(torch, arch, cfg, params, prompt), time.perf_counter() - t0)
                # every rank runs the same prefill alone: its cache must be the same on all four (a 64-row CTA
                # race in the kernel's slice path once made them differ, ROADMAP Queue 3 item 22)
                ch = _tree_hash(torch, prefilled[channel][0]).cpu()
                every = [torch.empty_like(ch) for _ in range(dist.get_world_size())]
                collectives.all_gather(every, ch)
                gates[f"(g) {name} {channel} prefill: the cache alike on the four ranks"] = all(
                    torch.equal(every[0], c) for c in every)
            cache, prefill_s = prefilled[channel]
            key = f"(g) {name}{'' if layers is None else f' at {layers} layers'} {channel}" + (
                " absorbed" if absorbed else "") + ("" if tp else " without TP (row origins)")
            runs = {}
            for run in ("replicated", "placed"):
                _reset_counts(torch, K)
                log, snap = [], {}

                def after(run=run, log=log, snap=snap, cfg=cfg, tp=tp):
                    snap["counts"] = _counts(K)
                    snap["max_memory_allocated"] = torch.cuda.max_memory_allocated()
                    if run == "placed":
                        snap["replay"] = _replay_gemms(torch, runs["replicated"]["log"], log, cfg)
                        if not tp:
                            for what, scope in (("origin_0", _origin_at_zero), ("block_word", _block_word)):
                                with scope():
                                    snap[what] = _replay_gemms(torch, runs["replicated"]["log"], log, cfg)

                logits, shapes, seq, secs = _kv_decode(torch, K, arch, cfg, params, cache, steps, mesh,
                                                       run == "placed", log=log, after=after, tp=tp)
                runs[run] = dict(logits=logits, log=log, cache=shapes, seq=seq, seconds=secs, **snap)
            rep, pp = runs["replicated"], runs["placed"]
            checked, same, bad, first = pp["replay"]
            worst = worst_of(rep["logits"], pp["logits"])
            scale = max(float(a.float().abs().max()) for a in rep["logits"])
            finite = all(bool(torch.isfinite(x).all()) for x in pp["logits"])
            fp = hashlib.sha256(b"".join(x.float().cpu().numpy().tobytes() for x in pp["logits"])).hexdigest()[:16]
            attn = cfg.num_layers * PLACEMENT_STEPS
            halved = all(shape[1 if k.startswith("first/") else 2] == KV_SEQ_MAX // 2
                         for k, shape in pp["cache"].items())
            control = None
            if (name, channel) == ("qwen2-0.5b", "ideal"):
                with _dropped_max():
                    wrong, _, _, _ = _kv_decode(torch, K, arch, cfg, params, cache, steps, mesh, True)
                control = worst_of(rep["logits"], wrong)
                gates[f"{key}: negative control, the row max's MAX skipped: the logits gate fails"] = (
                    control > 2.0**-5 * scale)
            if channel == "ideal":
                gates[f"{key}: logits within 2^-5 of their largest of the replicated program's"] = (
                    finite and worst <= 2.0**-5 * scale)
            # the merge's own bar, as on the CPU: a write or a mask off by one position moves the logits by
            # far less than 2^-5, but by far more than this
            gates[f"{key}: logits within 1e-5 of their largest of the replicated program's"] = (
                finite and worst <= 1e-5 * scale)
            gates[f"{key}: every routed GEMM, replayed on the replicated program's input, bitwise its output"] = (
                not bad and same > 0)
            words = 0 if tp else 2 * attn  # wuk's and wuv's content words summed over the blocks
            gates[f"{key}: one MAX and one SUM a decode attention, each cache leaf a rank of {KV_SEQ_MAX // 2} "
                  f"positions"] = (pp["seq"] == _seq_counts(kv_max=attn, kv_sum=attn, kv_word=words) and halved
                                   and (pp["counts"]["photonic_gemm_fused"] == 0) == tp)
            controls = {}
            for what in ("origin_0", "block_word"):
                if what in pp:
                    wrong = sorted({b[1] for b in pp[what][2] if len(b) == 4 and b[1] in ("attn.wuk", "attn.wuv")})
                    controls[what] = wrong
                    if what == "origin_0" and data == 0:  # the first block's origin is 0: the control is the run
                        gates[f"{key}: control, the row origin forced to 0: the first block's replay unchanged"] = (
                            not pp[what][2])
                    else:
                        gates[f"{key}: negative control, "
                              f"{'the row origin forced to 0' if what == 'origin_0' else 'the block content word'}: "
                              f"wuk and wuv fail the replay"] = wrong == ["attn.wuk", "attn.wuv"]
            res[key] = dict(max_abs=worst, scale=scale, fingerprint=fp, gemms_checked=checked, gemms_same=same,
                            gemms_bad=bad[:8], first_input_difference=first, control=control, cache=pp["cache"],
                            replicated_cache=rep["cache"], seq=pp["seq"], counts=pp["counts"],
                            replicated_counts=rep["counts"], seconds=pp["seconds"],
                            replicated_seconds=rep["seconds"], prefill_seconds=prefill_s, row_controls=controls,
                            max_memory_allocated=pp["max_memory_allocated"],
                            replicated_max_memory_allocated=rep["max_memory_allocated"])
            say(f"{key}: one row, a prompt of {KV_SEQ_PROMPT} into a cache of {KV_SEQ_MAX} positions "
                f"({KV_SEQ_MAX // 2} a rank of data; prefill {prefill_s:.2f} s, every rank alone), "
                f"{PLACEMENT_STEPS} decode steps (positions {KV_SEQ_PROMPT}-{KV_SEQ_PROMPT + PLACEMENT_STEPS - 1}), "
                f"heads and kv_seq placed against replicated: max |d logits| {worst:.4g} of {scale:.4g} "
                f"({worst / scale:.3g} of the largest; ideal bar 2^-5), sha256 {fp}; routed GEMMs replayed on the "
                f"replicated program's input: {same} bitwise ({len(checked)} sites), mismatches {bad[:4]}; first "
                f"GEMM whose own input differs {first}; negative control (no MAX) max |d| {control}; row-origin "
                f"controls (sites whose replay failed) {controls}; cache leaves a "
                f"rank {pp['cache']} (replicated {rep['cache']}); sequence collectives {pp['seq']}; counts "
                f"{pp['counts']} (replicated {rep['counts']}); {pp['seconds']:.2f} s placed, "
                f"{rep['seconds']:.2f} s replicated; max_memory_allocated placed "
                f"{pp['max_memory_allocated'] / 2**30:.2f} GiB, replicated "
                f"{rep['max_memory_allocated'] / 2**30:.2f} GiB [{card}]")
            del runs, rep, pp
        del params, prefilled
        torch.cuda.empty_cache()
    return res


# Phase 10 (h): the all-reduce pattern of a K-sharded decode step, repeated
# on small tensors (ROADMAP Queue 3 item 22).
STRESS_ITERS = 300


def _psum_stress(torch, mesh, reduce, bump=False):
    """``STRESS_ITERS`` K-sharded GEMMs as one decode step runs them: each
    rank's unfused SMWA launch on its K block (qwen2-0.5b's ``attn.wo``, R
    = 1, K_local = 448, C = 896), its int32 partial summed over "model" by
    ``reduce(out, group)`` and read at once by the next kernel; ``bump``:
    the second model rank adds 1 to its partial after it was recorded (the
    negative control).  Checked after the loop, on the host: every rank's
    sum is the sum of the recorded partials, and the two model ranks hold
    the same sums.  Returns (iterations whose sum differs from its
    partials', iterations whose sums differ across the ranks, seconds)."""
    from repro_torch.photonic import sharded
    from repro_torch.photonic.engine import PhotonicEngine
    from repro_torch.runtime import collectives

    group, m = mesh.get_group("model"), mesh.get_local_rank("model")
    local = sharded.shard_local_engine(PhotonicEngine(dpu=smwa_dpu(), backend="kernel"), 448)
    gen = torch.Generator(device="cuda").manual_seed(41 + 7 * mesh.get_local_rank("data") + m)
    partials, sums = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(STRESS_ITERS):
        xq = torch.randint(-127, 128, (1, 448), generator=gen, device="cuda", dtype=torch.int8)
        wq = torch.randint(-127, 128, (448, 896), generator=gen, device="cuda", dtype=torch.int8)
        out = local.int_gemm(xq, wq, site="attn.wo", fold=i % 24, shard=m).contiguous()
        partials.append(out.clone())
        if bump and m == 1:
            out += 1
        reduce(out, group)
        sums.append(out.to(torch.float64) * 0.5)  # the next kernel reads the sum at once
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    p, s = torch.stack(partials).cpu(), torch.stack(sums).cpu()
    ps, ss = [torch.empty_like(p) for _ in range(2)], [torch.empty_like(s) for _ in range(2)]
    collectives.all_gather(ps, p, group=group)
    collectives.all_gather(ss, s, group=group)
    want = (ps[0].to(torch.float64) + ps[1].to(torch.float64)) * 0.5
    wrong = int((s != want).reshape(STRESS_ITERS, -1).any(dim=1).sum())
    apart = int((ss[0] != ss[1]).reshape(STRESS_ITERS, -1).any(dim=1).sum())
    return wrong, apart, secs


def placement_stress(torch, mesh, gates, say, card):
    """Phase 10 (h): :func:`_psum_stress` through the port's staged
    all-reduce (``runtime.collectives``: CUDA tensors through host tensors
    on gloo), gated at zero mismatches; through gloo's own path on the CUDA
    tensors (``torch.distributed.all_reduce``, the port's path before the helper),
    reported; and the staged path with one rank's partial bumped after it
    was recorded, which must trip.  Returns the results."""
    import torch.distributed as dist

    from repro_torch.runtime import collectives

    res = {}
    for label, reduce, bump in (
            ("staged", lambda t, g: collectives.all_reduce(t, group=g), False),
            ("gloo_cuda", lambda t, g: dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g), False),
            ("control", lambda t, g: collectives.all_reduce(t, group=g), True)):
        wrong, apart, secs = _psum_stress(torch, mesh, reduce, bump)
        res[label] = dict(wrong=wrong, apart=apart, seconds=secs)
    gates[f"(h) {STRESS_ITERS} staged all-reduces of K-sharded partials: every sum the partials', the ranks alike"] = (
        res["staged"]["wrong"] == res["staged"]["apart"] == 0)
    gates["(h) negative control, one rank's partial bumped: the check trips"] = res["control"]["wrong"] == STRESS_ITERS
    say(f"(h) {STRESS_ITERS} K-sharded SMWA GEMMs (R=1, K_local 448, C 896) each all-reduced over model and read at "
        f"once: staged through the host {res['staged']}; gloo on the CUDA tensors {res['gloo_cuda']}; control (one "
        f"partial bumped) {res['control']} (wrong: sums unlike their partials'; apart: sums unlike across the model "
        f"ranks) [{card}]")
    return res


def _tree_hash(torch, tree):
    """A content hash of a tree's tensor leaves (int64 ``(2,)``: the sum and
    a position-weighted sum of their bit patterns), on the device."""
    from repro_torch._tree import tree_leaves

    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            v = t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32).reshape(-1).to(torch.int64)
            w = torch.arange(1, v.numel() + 1, device=v.device, dtype=torch.int64) * 2654435761 % 2**31
            out += torch.stack([v.sum(), (v * w).sum()])
    return out


def _kv_repeat(torch, K, mesh, say, card, n):
    """``--phase gloo-repro N``: after phase 10, (g)'s qwen2-0.5b SMWA
    prefill (every rank alone) and replicated decode (TP over "model")
    ``n`` times, on the shipped kernel (even runs) and on
    :func:`photonic_race_library`'s variant without the 64-row CTAs'
    barrier between weight-slice passes (odd runs).  Per run: the
    prefill caches' content hashes compared across the four ranks (they
    run the same program on the same inputs), the decode's K-sharded sums
    compared across the model ranks (each sum's hash, taken at once) and
    against the partials' (the hash is linear), and the logits'
    fingerprint.  Returns the counts by kernel."""
    import torch.distributed as dist

    from repro_torch.models import registry
    from repro_torch.models.common import init_params
    from repro_torch.runtime import collectives

    arch = registry.get("qwen2-0.5b")
    base = arch.config.pad_for_mesh(2)
    params = init_params(base, 0, "cuda", defs=arch.param_defs(base))
    rng = np.random.default_rng(KV_SEQ_PROMPT)
    prompt = torch.from_numpy(rng.integers(0, base.vocab_size, (1, KV_SEQ_PROMPT))).cuda()
    steps = torch.from_numpy(rng.integers(0, base.vocab_size, (PLACEMENT_STEPS, 1, 1))).cuda()
    cfg = dataclasses.replace(base, photonic=smwa_dpu(), photonic_backend="kernel")
    group, staged, shipped = mesh.get_group("model"), collectives.all_reduce, K.LIBRARY
    race = photonic_race_library()
    race.load()
    hashes = []

    def reduce(t, op=None, group=None):
        part = _tree_hash(torch, [t])
        staged(t, op, group=group)
        hashes.append(torch.cat([part, _tree_hash(torch, [t])]))
        return t

    res = {k: dict(runs=0, caches_unlike=0, sums_unlike=0, sums_off=0, fingerprints={}) for k in ("shipped", "race")}
    t0 = time.perf_counter()
    collectives.all_reduce = reduce
    try:
        for it in range(n):
            label = "race" if it % 2 else "shipped"
            K.LIBRARY = race if it % 2 else shipped
            r = res[label]
            r["runs"] += 1
            cache = _kv_prefill(torch, arch, cfg, params, prompt)
            ch = _tree_hash(torch, cache).cpu()
            every = [torch.empty_like(ch) for _ in range(dist.get_world_size())]
            collectives.all_gather(every, ch)
            r["caches_unlike"] += int(any(not torch.equal(every[0], c) for c in every))
            hashes.clear()
            logits, _, _, _ = _kv_decode(torch, K, arch, cfg, params, cache, steps, mesh, False)
            h = torch.stack(hashes).cpu()
            both = [torch.empty_like(h) for _ in range(2)]
            collectives.all_gather(both, h, group=group)
            r["sums_unlike"] += int((both[0][:, 2:] != both[1][:, 2:]).any(dim=1).sum())
            r["sums_off"] += int((h[:, 2:] != both[0][:, :2] + both[1][:, :2]).any(dim=1).sum())
            fp = hashlib.sha256(b"".join(x.float().cpu().numpy().tobytes() for x in logits)).hexdigest()[:16]
            r["fingerprints"][fp] = r["fingerprints"].get(fp, 0) + 1
            del cache
    finally:
        collectives.all_reduce, K.LIBRARY = staged, shipped
    secs = time.perf_counter() - t0
    say(f"gloo-repro: (g)'s qwen2-0.5b SMWA prefill and replicated decode {n} times, staged all-reduces; on the "
        f"shipped kernel {res['shipped']}; on the variant without the slice passes' barrier {res['race']} "
        f"(caches_unlike: runs whose prefill caches differ across the four ranks; sums_unlike / sums_off: decode "
        f"sums unlike across the model ranks / unlike their partials'); {secs:.1f} s [{card}]")
    return dict(res, seconds=secs)


# Phase 10 (e): the recurrent, audio and vision families at full width on
# the four ranks, cut in depth: (arch, config overrides, channels).
# xlstm-350m at one group (7 mLSTM + 1 sLSTM of 24 layers; 2 of 4 heads'
# key blocks and 1,024 of 2,048 inner a rank); zamba2-2.7b at one group (6
# Mamba2 layers and one shared-block invocation of 54 + 9; 40 of 80 Mamba2
# heads a rank); whisper-medium at 2 + 2 of 24 + 24 layers; llama-3.2-vision-90b
# at one group (4 self layers and 1 cross layer of 100).
PLACEMENT_FAMILIES = [
    ("xlstm-350m", dict(num_layers=8), ("ideal", "SMWA")),
    ("zamba2-2.7b", dict(num_layers=6), ("ideal", "SMWA")),
    ("whisper-medium", dict(encoder_layers=2, num_layers=2), ("ideal",)),
    ("llama-3.2-vision-90b", dict(num_layers=5), ("ideal",)),
]
PLACEMENT_FAMILY_STEPS = 4
PLACEMENT_AUDIO_FRAMES = 64  # whisper's encoder frames a row
# The leaves that initialize to zeros or ones and would hide a placement
# fault (a gate at zero makes a cross layer the identity; zero mLSTM gates
# and Mamba2 biases make every head alike): drawn here (_family_params).
PLACEMENT_SEEDED = ("wi/w", "wf/w", "conv_b", "a_log", "dt_bias", "d_skip", "gate", "gate_ffn")


def _family_params(torch, arch, cfg):
    """``cfg``'s whole parameters on the card, drawn from one seeded stream
    in chunks of 2^26 elements straight into the parameter dtype (no f32
    copy of a whole leaf: llama-3.2-vision-90b's embedding is 3.9 GiB in
    f32): fan-in-scaled normals, 0.02 normals for embeddings, zeros and
    ones by each definition's ``init``; the :data:`PLACEMENT_SEEDED`
    leaves drawn instead, vectors from N(0, 0.5^2), the mLSTM gates'
    matrices fan-in-scaled as every other weight; and the sLSTM's ``r`` at
    std ``1/sqrt(dh)``, as the train-families phase scales it (ROADMAP
    Queue 3 item 12).  At full width the published ``r`` (std 0.5, eight
    times that) and gates at std 0.5 over a fan-in of 2,048 make
    xlstm-350m chaotic: on the CPU a relative change of 2^-20 in its
    embedding moved its f32 logits by 0.41–1.70 over a prefill and four
    decode steps, against 8e-5–2e-4 with both drawn so."""
    from repro_torch.models.common import _DTYPES, P

    gen = torch.Generator(device="cuda").manual_seed(0)

    def make(path, p):
        dt = _DTYPES[p.dtype] if p.dtype else cfg.param_dtype
        if path.endswith(PLACEMENT_SEEDED) and "/ffn/" not in path:
            scale = 0.5 if len(p.shape) == 1 else 1.0 / math.sqrt(p.shape[p.fan_axis])
        elif path.endswith("/r") and arch.family == "ssm":
            scale = 1.0 / math.sqrt(p.shape[1])
        elif p.init in ("zeros", "ones"):
            return (torch.zeros if p.init == "zeros" else torch.ones)(p.shape, dtype=dt, device="cuda")
        else:
            scale = 0.02 if p.init in ("embed", "normal") else 1.0 / math.sqrt(max(p.shape[p.fan_axis], 1))
        t = torch.empty(p.shape, dtype=dt, device="cuda")
        flat, step = t.view(-1), 1 << 26
        for i in range(0, flat.numel(), step):
            n = min(step, flat.numel() - i)
            flat[i:i + n] = (torch.randn(n, generator=gen, device="cuda") * scale).to(dt)
        return t

    def walk(node, path):
        if isinstance(node, P):
            return make(path, node)
        if isinstance(node, dict):
            return {k: walk(node[k], f"{path}/{k}") for k in sorted(node)}
        return [walk(v, f"{path}/{i}") for i, v in enumerate(node)]

    return walk(arch.param_defs(cfg), "")


def _in_turns(torch, fn):
    """``fn()`` on each of the four ranks in turn (barriers between), so
    that the transient memory of one call is on the card at a time
    (llama-3.2-vision-90b's group is 12.8 GB whole, its embedding drawn in
    f32 first)."""
    import torch.distributed as dist

    out = None
    for turn in range(dist.get_world_size()):
        dist.barrier()
        if turn == dist.get_rank():
            out = fn()
            torch.cuda.empty_cache()
    dist.barrier()
    return out


def _placed_params(torch, arch, cfg, mesh, sizes):
    """This rank's blocks of ``cfg``'s parameters: ``place_params`` of a
    tree :func:`_family_params` makes anew, the ranks in turn
    (:func:`_in_turns`)."""
    from repro_torch.models.common import axes_tree
    from repro_torch.runtime import sharding as shd

    def place():
        with shd.placement(mesh, sizes):
            return shd.place_params(_family_params(torch, arch, cfg), axes_tree(arch.param_defs(cfg)))

    return _in_turns(torch, place)


def _family_batch(torch, arch, cfg, rows):
    """The prompt batch of phase 10 (e) (``tokens``; whisper's
    ``audio_embed`` of :data:`PLACEMENT_AUDIO_FRAMES` frames, the vision
    family's ``vision_seq`` patches, seeded, in the compute dtype), its
    logical axes and the decode steps' tokens."""
    rng = np.random.default_rng(17)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, PLACEMENT_PROMPT))).cuda()
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, (PLACEMENT_FAMILY_STEPS, rows, 1))).cuda()
    batch, axes = {"tokens": prompt}, {"tokens": ("batch", None)}
    gen = torch.Generator(device="cuda").manual_seed(9)
    memory = {"audio": ("audio_embed", PLACEMENT_AUDIO_FRAMES), "vlm": ("vision", cfg.vision_seq)}.get(arch.family)
    if memory is not None:
        batch[memory[0]] = torch.randn((rows, memory[1], cfg.d_model), generator=gen, device="cuda").to(
            cfg.compute_dtype)
        axes[memory[0]] = ("batch", "seq_sp" if arch.family == "audio" else None, None)  # the reference's axes
    return batch, axes, steps


# Phase 10 (e)/(f): the families whose runs open with the training
# forward's logits, its residual placed by seq_sp (zamba2-2.7b's Mamba2
# layers and shared block, whisper-medium's encoder and decoder).
SEQ_FORWARD = ("zamba2-2.7b", "whisper-medium")


def _forward_logits(arch, params, batch, cfg):
    """The training forward's logits of every position (no loss)."""
    from repro_torch.models import whisper, zamba2

    if arch.family == "audio":
        return whisper.whisper_logits(params, batch, cfg)[0]
    return zamba2.zamba2_logits(params, batch["tokens"], cfg)[0]


def _family_decode(torch, arch, cfg, params, batch, batch_axes, steps, mesh, placed, log=None, after=None):
    """Phase 10 (e): for :data:`SEQ_FORWARD`'s families the training
    forward's logits first ((f)), then a prefill and decode steps, under TP
    over "model"; ``placed``: every name the arch places
    (``placement_sizes`` of each step's shape: the forward's and the
    prefill's residual by ``seq_sp``, whisper's frames coming in by it),
    ``params`` this rank's blocks, the batch cut to this rank's blocks, the
    logits gathered.  ``log`` gets every GEMM and a ``None`` before each
    forward; ``after()`` runs last in the decode steps' scopes, untimed.
    Returns (the global logits of each call, the recurrent states' bytes,
    seconds)."""
    from repro_torch.models.common import recording
    from repro_torch.models.registry import ShapeSpec
    from repro_torch.photonic import sharded
    from repro_torch.runtime import sharding as shd

    tok_axes, logit_axes = ("batch", None), ("batch", None, "vocab")
    frames = batch["audio_embed"].shape[1] if "audio_embed" in batch else batch["tokens"].shape[1]

    def step(kind):
        """The placement of one step of ``kind`` (nothing unless ``placed``)."""
        if not placed:
            return contextlib.nullcontext()
        seq = PLACEMENT_MAX_SEQ if kind == "decode" else frames
        return shd.placement(mesh, arch.placement_sizes(cfg, ShapeSpec(kind, seq, PLACEMENT_ROWS, kind)))

    def gathered(x):
        return shd.gather_tree(x, logit_axes) if placed else x

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as scopes:
        scopes.enter_context(shd.use_rules(mesh))
        scopes.enter_context(sharded.tensor_parallel(mesh, "model"))
        mark = (lambda: None) if log is None else (lambda: log.append(None))
        out = []
        with torch.no_grad(), (contextlib.nullcontext() if log is None else recording(log)):
            if arch.name in SEQ_FORWARD:
                with step("train"):
                    mark()
                    out.append(gathered(_forward_logits(
                        arch, params, shd.place_tree(batch, batch_axes) if placed else batch, cfg)))
            with step("prefill"):
                mark()
                logits, cache = arch.prefill(params, shd.place_tree(batch, batch_axes) if placed else batch, cfg,
                                             PLACEMENT_MAX_SEQ)
                out.append(gathered(logits))
            scopes.enter_context(step("decode"))
            for t in steps:
                mark()
                logits, cache = arch.decode(params, shd.place_tree(t, tok_axes) if placed else t, cache, cfg)
                out.append(gathered(logits))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if after is not None:
            after()
    states = [t for k in ("mlstm", "slstm", "mamba") for t in cache.get(k, {}).values()]
    return out, sum(t.numel() * t.element_size() for t in states), secs


@contextlib.contextmanager
def _dropped_down_reduce():
    """Phase 10 (e)'s negative control on xlstm-350m: the row-parallel
    ``down``'s int32 partial products kept on each rank, the all-reduce that
    sums them over "model" skipped."""
    import torch.distributed as dist

    from repro_torch.photonic import sharded

    inner = sharded.psum_int_gemm

    def dropped(engine, xq, wq, *, group, site=None, **kw):
        if site != "down":
            return inner(engine, xq, wq, group=group, site=site, **kw)
        kw.pop("scatter", None)  # the down's output is not a sequence block's (xlstm places no seq_sp)
        k_local = int((kw.get("logical_kc") or tuple(wq.shape[-2:]))[0])
        return sharded.shard_local_engine(engine, k_local).int_gemm(
            xq, wq, site=site, shard=dist.get_rank(group), **kw).contiguous()

    sharded.psum_int_gemm = dropped
    try:
        yield
    finally:
        sharded.psum_int_gemm = inner


def _family_forward_counts(name, cfg):
    """Phase 10 (e): the collectives of one placed forward of
    :data:`PLACEMENT_FAMILIES`' cut: the recurrent gathers and sums
    (``contracts.RECURRENT_COLLECTIVES``) a layer."""
    if name.startswith("xlstm"):
        groups, per = cfg.num_layers // cfg.slstm_every, cfg.slstm_every - 1
        return dict(xin=groups * per, parts=groups * (per + 1), state_sum=groups * per, norm=0)
    if name.startswith("zamba2"):
        return dict(xin=0, parts=cfg.num_layers, state_sum=0, norm=cfg.num_layers)
    return dict(xin=0, parts=0, state_sum=0, norm=0)


def placement_families(torch, K, mesh, gates, say, card):
    """Phase 10 (e): for each of :data:`PLACEMENT_FAMILIES` at full width
    (its depth cut), a prefill of ``PLACEMENT_ROWS`` x ``PLACEMENT_PROMPT``
    tokens (whisper against ``PLACEMENT_AUDIO_FRAMES`` frames a row,
    llama-3.2-vision against its 1,600 patches) and
    ``PLACEMENT_FAMILY_STEPS`` decode steps under TP over "model" on the
    kernel backend, the replicated program (whole parameters, nothing
    placed) against everything placed (rows; ``inner`` and ``mamba_heads``
    for xLSTM and Zamba2; heads, KV heads, ``d_ff`` and vocab).  The
    replicated run's tree is freed before the placed run (the replay needs
    its recorded activations only) and the ranks draw and place their trees
    one at a time (:func:`_in_turns`).
    Gates: every routed GEMM of the placed run, called again on this
    rank's block of the replicated run's input, bitwise this rank's block
    of its output (ideal and SMWA); ideal: the logits within 2^-5 of their
    largest (bitwise where the placed program keeps the replicated one's
    sums; the mLSTM state's partial readouts meet in an f32 SUM over
    "model", another order); the recurrent collectives of a placed forward
    and no GEMM row gathered; parameter bytes a rank about half the whole;
    the recurrent states a rank about half the rows' share.  Negative
    controls: zamba2-2.7b ideal with the two model ranks' ``a_log`` /
    ``dt_bias`` blocks swapped, and xlstm-350m ideal with the row-parallel
    ``down``'s all-reduce dropped, each must fail the logits gate.  Returns
    the results."""
    import torch.distributed as dist

    from repro_torch.analysis import contracts
    from repro_torch.models import registry
    from repro_torch.models.registry import ShapeSpec

    def worst_of(a, b):
        return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))

    shape = ShapeSpec("decode", PLACEMENT_MAX_SEQ, PLACEMENT_ROWS, "decode")
    res = {}
    for name, overrides, channels in PLACEMENT_FAMILIES:
        gc.collect()
        torch.cuda.empty_cache()
        say(f"(e) {name}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved before it")
        arch = registry.get(name)
        base = dataclasses.replace(arch.config, **overrides).pad_for_mesh(2)
        batch, batch_axes, steps = _family_batch(torch, arch, base, PLACEMENT_ROWS)
        forwards = 1 + PLACEMENT_FAMILY_STEPS + (name in SEQ_FORWARD)
        sizes = arch.placement_sizes(base, shape)
        for channel in channels:
            cfg = dataclasses.replace(base, photonic=ideal_dpu() if channel == "ideal" else smwa_dpu(),
                                      photonic_backend="kernel")
            key = f"(e) {name} {channel}"
            runs = {}
            # the replicated run, its GEMM records kept without their (whole) parameters
            stages, t0 = {}, time.perf_counter()
            _reset_counts(torch, K)
            params = _in_turns(torch, lambda: _family_params(torch, arch, cfg))
            stages["draw"] = time.perf_counter() - t0
            whole_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
            rep_log = []
            logits, states, secs = _family_decode(torch, arch, cfg, params, batch, batch_axes, steps, mesh, False,
                                                  log=rep_log)
            rep_log = [r if r is None else r._replace(params=None) for r in rep_log]
            runs["replicated"] = dict(logits=logits, states=states, seconds=secs, counts=_counts(K),
                                      max_memory_allocated=torch.cuda.max_memory_allocated())
            del params
            stages["replicated"] = time.perf_counter() - t0 - stages["draw"]
            # the placed run and the replay
            _reset_counts(torch, K)
            t1 = time.perf_counter()
            placed = _placed_params(torch, arch, cfg, mesh, sizes)
            stages["place"] = time.perf_counter() - t1
            held = sum(t.numel() * t.element_size() for t in _leaves(placed))
            # the ranks place in turn, one whole tree on the card at a time: this rank's placing peak, apart
            placing_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            log_, snap = [], {}

            def after(log_=log_, snap=snap, cfg=cfg, rep_log=rep_log):
                snap["counts"] = dict(_counts(K), outputs=contracts.ROW_GATHERS["outputs"],
                                      amax=contracts.SCALE_REDUCTIONS["amax"],
                                      **{f"recurrent_{k}": v for k, v in contracts.RECURRENT_COLLECTIVES.items()},
                                      **{f"param_{k}": v for k, v in contracts.PARAM_REDUCES.items()})
                snap["max_memory_allocated"] = torch.cuda.max_memory_allocated()
                snap["replay"] = _replay_gemms(torch, rep_log, log_, cfg)

            t1 = time.perf_counter()
            logits, states, secs = _family_decode(torch, arch, cfg, placed, batch, batch_axes, steps, mesh, True,
                                                  log=log_, after=after)
            stages["placed and replay"] = time.perf_counter() - t1
            runs["placed"] = dict(logits=logits, states=states, seconds=secs, **snap)
            del log_, rep_log
            rep, pp = runs["replicated"], runs["placed"]
            checked, same, bad, first = pp["replay"]
            worst = worst_of(rep["logits"], pp["logits"])
            scale = max(float(a.float().abs().max()) for a in rep["logits"])
            bitwise = all(torch.equal(a, b) for a, b in zip(rep["logits"], pp["logits"]))
            finite = all(bool(torch.isfinite(x).all()) for x in pp["logits"])
            fp = hashlib.sha256(b"".join(x.float().cpu().numpy().tobytes() for x in pp["logits"])).hexdigest()[:16]
            c = pp["counts"]
            want = {k: v * forwards for k, v in _family_forward_counts(name, cfg).items()}
            got = {k: c[f"recurrent_{k}"] for k in want}
            control, t1 = None, time.perf_counter()
            if channel == "ideal" and name.startswith(("zamba2", "xlstm")):
                if name.startswith("zamba2"):
                    # each rank takes the other model rank's blocks: one all-gather of each leaf over "model"
                    model = mesh.get_group("model")
                    for group in placed["mamba"]:
                        for p in group:
                            for leaf in ("a_log", "dt_bias"):
                                both = [torch.empty_like(p[leaf]) for _ in range(2)]
                                dist.all_gather(both, p[leaf].contiguous(), group=model)
                                p[leaf] = both[1 - mesh.get_local_rank("model")]
                    wrong, _, _ = _family_decode(torch, arch, cfg, placed, batch, batch_axes, steps, mesh, True)
                    what = "the two model ranks' a_log / dt_bias blocks swapped"
                else:
                    with _dropped_down_reduce():
                        wrong, _, _ = _family_decode(torch, arch, cfg, placed, batch, batch_axes, steps, mesh, True)
                    what = "the row-parallel down's all-reduce dropped"
                control = dict(what=what, worst=worst_of(rep["logits"], wrong))
                stages["control"] = time.perf_counter() - t1
                gates[f"{key}: negative control, {what}: the logits gate fails"] = control["worst"] > 2.0**-5 * scale
            del placed
            torch.cuda.empty_cache()
            if channel == "ideal":
                gates[f"{key}: logits within 2^-5 of their largest of the replicated program's"] = (
                    finite and worst <= 2.0**-5 * scale)
            gates[f"{key}: every routed GEMM, replayed on the replicated program's input, bitwise its output"] = (
                not bad and same > 0)
            gates[f"{key}: recurrent gathers and sums a forward, no GEMM row gathered, no fused launch"] = (
                got == want and c["row_gathers"] == 0 and c["photonic_gemm_fused"] == 0)
            gates[f"{key}: parameter bytes a rank about half the whole"] = 0.45 < held / whole_bytes < 0.55
            state_ratio = None
            if rep["states"]:
                # the rows halve over "data" in both runs; "model" halves the placed states once more
                state_ratio = pp["states"] / (rep["states"] / 2)
                gates[f"{key}: recurrent state bytes a rank about half the rows' share"] = 0.45 < state_ratio < 0.56
            per_forward = [float((x.float() - y.float()).abs().max()) for x, y in zip(rep["logits"], pp["logits"])]
            res[f"{name} {channel}"] = dict(
                max_abs=worst, per_forward=per_forward, scale=scale, bitwise=bitwise, fingerprint=fp, gemms_checked=checked, gemms_same=same,
                gemms_bad=bad[:8], first_input_difference=first, control=control, counts=c,
                replicated_counts=rep["counts"], recurrent=got, seconds=pp["seconds"],
                replicated_seconds=rep["seconds"], param_bytes=held, whole_param_bytes=whole_bytes,
                state_bytes=pp["states"], replicated_state_bytes=rep["states"], state_ratio=state_ratio,
                max_memory_allocated=pp["max_memory_allocated"],
                replicated_max_memory_allocated=rep["max_memory_allocated"], placing_peak=placing_peak,
                stage_seconds=stages,
                launches_a_forward=c["photonic_gemm"] / forwards)
            say(f"{key}: prefill {PLACEMENT_ROWS} x {PLACEMENT_PROMPT} + {PLACEMENT_FAMILY_STEPS} decode steps, "
                f"placed ({', '.join(sorted(sizes))}) against replicated: max |d logits| {worst:.4g} of {scale:.4g} "
                f"(bitwise {bitwise}; ideal bar 2^-5 x; each forward {[round(x, 5) for x in per_forward]}), sha256 "
                f"{fp}; routed GEMMs replayed on the replicated "
                f"program's input: {same} bitwise ({len(checked)} sites), mismatches {bad[:4]}; first GEMM whose own "
                f"input differs (forward, site, layer, max |d|): {first}; negative control {control}; recurrent "
                f"collectives {got} (want {want}); photonic_gemm launches {c['photonic_gemm'] / forwards:.1f} a "
                f"forward (replicated {rep['counts']['photonic_gemm'] / forwards:.1f}), int32 all-reduces "
                f"{c['all_reduces']}; {pp['seconds']:.2f} s placed, {rep['seconds']:.2f} s replicated; parameter "
                f"bytes a rank {held} of {whole_bytes} whole ({held / whole_bytes:.4f}); recurrent state bytes a "
                f"rank {pp['states']} against {rep['states']} replicated (ratio to the rows' share {state_ratio}); "
                f"max_memory_allocated placed {pp['max_memory_allocated'] / 2**30:.2f} GiB, replicated "
                f"{rep['max_memory_allocated'] / 2**30:.2f} GiB, placing (in turn) {placing_peak / 2**30:.2f} GiB; "
                f"stage seconds {({k: round(v, 2) for k, v in stages.items()})} [{card}]")
            del runs, rep, pp, after, snap
        del batch, steps
        torch.cuda.empty_cache()
    dist.barrier()
    return res


def placement_child(repeat=0):
    """``chip_smoke.py --phase placement``: phase 10 (a), (b), (b'), (d),
    (e), (f), (g) and (h) on four ranks (:func:`placement_rank`); ``--phase
    gloo-repro N`` the same, then (g)'s replicated SMWA decode ``N`` times
    on gloo's own path (:func:`_kv_repeat`).  Gates: each rank's own, the
    ranks' logits and losses equal, and (e)'s four ranks' summed peak
    memory within the card's 80 GB.  Returns (ok, result, launches summed
    over the ranks)."""
    from repro_torch.launch.mesh import spawn

    log("  placement: backend gloo, CUDA tensors, four ranks sharing the card as the (data 2, model 2) mesh")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_placement_ckpt_")
    try:
        ranks = spawn(placement_rank, 4, backend="gloo", device="cuda", args=(ckpt_dir, repeat),
                      timeout=650 + 5 * repeat)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    ok = all(all(r["gates"].values()) for r in ranks)
    same = all(r[c][f] == ranks[0][c][f] for r in ranks for c in ("ideal", "SMWA")
               for f in ("fingerprint", "params_fingerprint")) and all(
        r[t]["losses"] == ranks[0][t]["losses"] for r in ranks for t in ("train", "dry_train")) and all(
        r["moe"][k]["fingerprint"] == ranks[0]["moe"][k]["fingerprint"] for r in ranks for k in ranks[0]["moe"]) and all(
        r["families"][k]["fingerprint"] == ranks[0]["families"][k]["fingerprint"]
        for r in ranks for k in ranks[0]["families"]) and all(
        r["kv"][k]["fingerprint"] == ranks[0]["kv"][k]["fingerprint"] for r in ranks for k in ranks[0]["kv"]) and all(
        r["train_seq"]["losses"] == ranks[0]["train_seq"]["losses"] for r in ranks)
    # the placed and replicated runs' peaks, summed over the ranks (each rank's placing peak comes in its own turn,
    # the other ranks holding their blocks or nothing)
    peaks = {k: sum(max(r["families"][k]["max_memory_allocated"], r["families"][k]["replicated_max_memory_allocated"])
                    for r in ranks) for k in ranks[0]["families"]}
    fits = all(v <= 80 * 10**9 for v in peaks.values())
    log(f"  placement (a)/(b)/(b')/(d)/(e)/(f)/(g): every rank's gates {ok}; ranks agree (logits, losses) {same}; (e) the "
        f"four ranks' summed peak max_memory_allocated {({k: round(v / 1e9, 3) for k, v in peaks.items()})} GB, "
        f"within 80 GB: {fits}")
    launches = {"photonic_gemm": sum(r[c][f"{k}_counts"]["photonic_gemm"] for r in ranks for c in ("ideal", "SMWA")
                                     for k in ("replicated", "placed", "params"))
                + sum(r["train"][k]["photonic_gemm"] for r in ranks for k in ("counts", "replicated_counts"))
                + sum(r["dry_train"]["counts"]["photonic_gemm"] for r in ranks)
                + sum(m[k]["photonic_gemm"] for r in ranks for m in r["moe"].values()
                      for k in ("counts", "replicated_counts"))
                # (f)'s seq_sp prefills and train() run, (g)'s kv_seq decode runs
                + sum(r[c]["seq_prefill"]["counts"]["photonic_gemm"] for r in ranks for c in ("ideal", "SMWA"))
                + sum(r["train_seq"]["counts"]["photonic_gemm"] for r in ranks)
                + sum(m[k]["photonic_gemm"] for r in ranks for m in r["kv"].values()
                      for k in ("counts", "replicated_counts")),
                # the column-parallel runs' launches alone: qwen2-0.5b's placed-parameter decode runs and the
                # dry run's step; (d)'s placed MoE decoders
                "column_parallel": sum(r[c]["params_counts"]["photonic_gemm"] for r in ranks for c in ("ideal", "SMWA"))
                + sum(r["dry_train"]["counts"]["photonic_gemm"] for r in ranks),
                "moe_column_parallel": sum(m["counts"]["photonic_gemm"] for r in ranks for m in r["moe"].values()),
                "families_column_parallel": sum(m["counts"]["photonic_gemm"] for r in ranks
                                                for m in r["families"].values()),
                # (g)'s runs without TP: every routed GEMM on the fused kernel, the placed run's wuk / wuv at
                # their blocks' row origins
                "row_origin_fused": sum(m["counts"]["photonic_gemm_fused"] for r in ranks
                                        for k, m in r["kv"].items() if "row origins" in k)}
    launches["photonic_gemm"] += launches["families_column_parallel"] + sum(
        m["replicated_counts"]["photonic_gemm"] for r in ranks for m in r["families"].values())
    return ok and same and fits, {"ranks": ranks, "family_peaks": peaks}, launches


# Phase 10 (c): the MoE decoders', zamba2-2.7b's and llama-3.2-vision-90b's
# decode cells, their parameters placed.
PLACED_CELLS = ("phi3.5-moe-42b-a6.6b", "deepseek-v2-lite-16b", "zamba2-2.7b", "llama-3.2-vision-90b")


def placement_cells(cells, registry, card):
    """Phase 10 (c): the tooling phase's qwen2-0.5b x decode_32k and x
    train_4k (ZeRO-1) cells beside the reference's recorded decode cell,
    and the decode_32k cells of ``PLACED_CELLS`` (the MoE decoders,
    zamba2-2.7b and llama-3.2-vision-90b: their parameters placed; gates:
    they fit 80 GB and hold nothing whole where the reference places
    it), and the qwen2-0.5b x long_500k cell (one row: the cache placed
    by ``kv_seq`` over "data"; gates: it fits, its cache a rank is the
    global cache / 256, nothing whole).  Returns (ok, result)."""
    from repro_torch._tree import tree_items

    ok, res = True, {}
    for name in PLACED_CELLS:
        cell = next((c for c in cells if c.get("arch") == name and c.get("shape") == "decode_32k"), None)
        if cell is None or "flops_per_device" not in cell:
            log(f"  (c) {name} x decode_32k: no cell")
            ok = False
            continue
        arch = registry.get(name)
        cfg = arch.config.pad_for_mesh(16)
        whole = sum(s.nbytes for s in tree_items(arch.param_specs(cfg, registry.SHAPES["decode_32k"])[0]).values())
        gates = {"fits 80 GB": cell["fits_device"] is True,
                 "nothing held whole where the reference places it": cell["replicated_by_port_bytes"] == {}}
        ok &= all(gates.values())
        res[f"{name} decode_32k"] = dict(
            {k: cell.get(k) for k in ("argument_size_in_bytes", "temp_size_in_bytes", "peak_size_in_bytes",
                                      "flops_per_device", "param_bytes", "cache_bytes", "fits_device", "placed")},
            whole_param_bytes=whole, gates=gates)
        log(f"  (c) {name} x decode_32k x single (placed: {cell['placed']}): arguments "
            f"{cell['argument_size_in_bytes']} B (params {cell['param_bytes']} B a rank, of {whole} B whole; cache "
            f"{cell['cache_bytes']} B), temp {cell['temp_size_in_bytes']} B, peak {cell['peak_size_in_bytes']} B "
            f"(fits 80 GB: {cell['fits_device']}), FLOPs a rank {cell['flops_per_device']}; still replicated by the "
            f"port: {cell['replicated_by_port_bytes']}; gates {gates} [{card}]")
    cell = next((c for c in cells if c.get("arch") == "qwen2-0.5b" and c.get("shape") == "long_500k"), None)
    if cell is None or "flops_per_device" not in cell:
        log("  (c) qwen2-0.5b x long_500k: no cell")
        ok = False
    else:
        arch = registry.get("qwen2-0.5b")
        (_, _), (cache, _) = arch.decode_specs(arch.config.pad_for_mesh(16), registry.SHAPES["long_500k"])
        global_cache = sum(s.nbytes for s in tree_items(cache).values() if s.shape)
        gates = {"fits 80 GB": cell["fits_device"] is True,
                 "cache a rank = global / 256 (positions over data, KV heads over model)":
                     cell["cache_bytes"] - 4 == global_cache // 256,
                 "nothing held whole where the reference places it": cell["replicated_by_port_bytes"] == {},
                 "kv_seq over data": cell["placed"].get("kv_seq") == "data"}
        ok &= all(gates.values())
        res["long_500k"] = dict({k: cell.get(k) for k in ("argument_size_in_bytes", "temp_size_in_bytes",
                                                         "peak_size_in_bytes", "cache_bytes", "placed",
                                                         "seq_collectives")},
                                global_cache_bytes=global_cache, gates=gates)
        log(f"  (c) qwen2-0.5b x long_500k x single (one row, placed: {cell['placed']}): cache "
            f"{cell['cache_bytes'] - 4} B a rank = {global_cache} / 256 ({global_cache // 16} B a rank before "
            f"kv_seq), arguments {cell['argument_size_in_bytes']} B, temp {cell['temp_size_in_bytes']} B, peak "
            f"{cell['peak_size_in_bytes']} B (fits 80 GB: {cell['fits_device']}); sequence collectives "
            f"{cell['seq_collectives']}; still replicated by the port: {cell['replicated_by_port_bytes']}; gates "
            f"{gates} [{card}]")
    ref = REFERENCE_DECODE_CELL
    ref_peak = ref["argument_size_in_bytes"] + ref["temp_size_in_bytes"]
    for shape in ("decode_32k", "train_4k"):
        cell = next((c for c in cells if c.get("arch") == "qwen2-0.5b" and c.get("shape") == shape
                     and not c.get("flags")), None)
        if cell is None or "flops_per_device" not in cell:
            log(f"  (c) qwen2-0.5b x {shape}: no cell")
            ok = False
            continue
        keep = ("argument_size_in_bytes", "temp_size_in_bytes", "peak_size_in_bytes", "flops_per_device",
                "param_bytes", "cache_bytes", "optimizer_state_bytes", "fits_device", "replicated_by_port_bytes",
                "placed", "zero1")
        res[shape] = {k: cell.get(k) for k in keep}
        if shape == "decode_32k":
            arch = registry.get("qwen2-0.5b")
            cfg = arch.config.pad_for_mesh(16)
            (_, _), (cache, _) = arch.decode_specs(cfg, registry.SHAPES[shape])
            global_cache = sum(s.nbytes for s in tree_items(cache).values() if s.shape)
            ratios = dict(arguments=cell["argument_size_in_bytes"] / ref["argument_size_in_bytes"],
                          temp=cell["temp_size_in_bytes"] / ref["temp_size_in_bytes"],
                          peak=cell["peak_size_in_bytes"] / ref_peak,
                          flops=cell["flops_per_device"] / ref["flops_per_device_exact"])
            gates = {"fits 80 GB": cell["fits_device"] is True,
                     "cache a rank = global / 256": cell["cache_bytes"] - 4 == global_cache // 256,
                     "arguments = the reference's to the byte":
                         cell["argument_size_in_bytes"] == ref["argument_size_in_bytes"],
                     "nothing held whole where the reference places it": cell["replicated_by_port_bytes"] == {}}
            ok &= all(gates.values())
            res[shape].update(ratios=ratios, gates=gates, global_cache_bytes=global_cache)
            log(f"  (c) qwen2-0.5b x decode_32k x single (placed: {cell['placed']}): arguments "
                f"{cell['argument_size_in_bytes']} B ({ratios['arguments']:.3f} x the reference's "
                f"{ref['argument_size_in_bytes']}; params {cell['param_bytes']} B, this rank's blocks), cache "
                f"{cell['cache_bytes'] - 4} B = {global_cache} / 256, temp {cell['temp_size_in_bytes']} B "
                f"({ratios['temp']:.3f} x {ref['temp_size_in_bytes']}), peak {cell['peak_size_in_bytes']} B "
                f"({ratios['peak']:.3f} x the reference's arguments + temp {ref_peak}), FLOPs a rank "
                f"{cell['flops_per_device']} ({ratios['flops']:.3f} x {ref['flops_per_device_exact']}); still "
                f"replicated by the port: {cell['replicated_by_port_bytes']}; gates {gates} [{card}]")
        else:
            gates = {"fits 80 GB": cell["fits_device"] is True,
                     "nothing held whole where the reference places it": cell["replicated_by_port_bytes"] == {}}
            ok &= all(gates.values())
            res[shape]["gates"] = gates
            log(f"  (c) qwen2-0.5b x train_4k x single (ZeRO-1 {cell['zero1']}, placed: {cell['placed']}): arguments "
                f"{cell['argument_size_in_bytes']} B (params {cell['param_bytes']} B, optimizer state "
                f"{cell['optimizer_state_bytes']} B), temp {cell['temp_size_in_bytes']} B, peak "
                f"{cell['peak_size_in_bytes']} B (fits 80 GB: {cell['fits_device']}), FLOPs a rank "
                f"{cell['flops_per_device']}; the reference records no train_4k cell, so no ratio; still replicated "
                f"by the port: {cell['replicated_by_port_bytes']}; gates {gates} [{card}]")
    return ok, res


def sliced_serve_phase(torch, arch, params, prompts, unsliced_ideal, card):
    """The paged server with ``photonic_slicing=2`` (every routed GEMM as 16
    unfused plane passes), ideal and SMWA-analog: tokens on the ideal
    channel equal the unsliced server's, SMWA logits finite, launches
    16 x 6 x 24 x forwards of ``photonic_gemm`` and none of the fused
    kernel.  Returns (ok, {label: (reqs, launches, stats)})."""
    n_layers = arch.config.num_layers
    ok, out = True, {}
    for label, dpu in (("sliced_ideal", ideal_dpu()), ("sliced_smwa", smwa_dpu())):
        reqs, launches, forwards, done, finite, st = serve(
            torch, arch, params, dpu, "kernel", prompts, card, label, extra=dict(photonic_slicing=2))
        expect = 16 * 6 * n_layers * forwards
        good = (done and finite and launches["photonic_gemm"] == expect
                and launches["photonic_gemm_fused"] == 0 and launches["flash_attention"] == 0)
        log(f"  {label}: all done {done}, logits finite {finite}, photonic_gemm launches "
            f"{launches['photonic_gemm']} == 16 x 6 x {n_layers} x {forwards} = {expect}, fused "
            f"{launches['photonic_gemm_fused']} == 0: {good}")
        ok &= good
        out[label] = (reqs, launches, st)
        torch.cuda.empty_cache()
    same = all(a.output == b.output for a, b in zip(out["sliced_ideal"][0], unsliced_ideal))
    log(f"  sliced ideal tokens == unsliced ideal tokens: {same}")
    for a, b, c in zip(out["sliced_ideal"][0], unsliced_ideal, out["sliced_smwa"][0]):
        log(f"    uid {a.uid}: sliced {a.output} unsliced {b.output} sliced smwa {c.output}")
    return ok and same, out


def int8_serve_phase(torch, arch, params, prompts, card):
    """The int8 serving layout: the seed-0 float params converted by
    ``quantize_params`` to ``photonic_scope="weights_int8"``, an int8 KV
    cache, and every layer's Q/K/V fused into one ``wqkv`` bank, on the
    paged server under the ideal channel.  Gates: kernel tokens == ``ref``
    tokens (both fused), fused tokens == the same server's with three
    sites, fused launches 4 x 24 x forwards with ``wqkv`` and 6 x 24 x
    forwards without.  Returns (ok, {label: (reqs, launches, stats)})."""
    from repro_torch.models.common import quantize_params

    n_layers = arch.config.num_layers
    extra = dict(photonic_scope="weights_int8", kv_cache_int8=True)
    cfg_q = dataclasses.replace(arch.config, photonic=ideal_dpu(), **extra)
    t0 = time.perf_counter()
    params_q = quantize_params(params, arch.param_defs(cfg_q))
    torch.cuda.synchronize()
    log(f"  quantize_params (full width, int8 w + f32 w_scale): {time.perf_counter() - t0:.2f} s")
    ok, out = True, {}
    for label, backend, fuse in (("int8_fused", "kernel", True), ("int8_fused_ref", "ref", True),
                                 ("int8_three_sites", "kernel", False)):
        reqs, launches, forwards, done, finite, st = serve(
            torch, arch, params_q, ideal_dpu(), backend, prompts, card, label, extra=extra, fuse=fuse)
        per_layer = 4 if fuse else 6
        expect = per_layer * n_layers * forwards if backend == "kernel" else 0
        good = (done and finite and launches["photonic_gemm_fused"] == expect
                and launches["photonic_gemm"] == 0 and launches["flash_attention"] == 0)
        log(f"  {label}: all done {done}, logits finite {finite}, fused launches "
            f"{launches['photonic_gemm_fused']} == {expect} ({per_layer} GEMMs a layer): {good}")
        ok &= good
        out[label] = (reqs, launches, st)
        torch.cuda.empty_cache()
    same_ref = all(a.output == b.output for a, b in zip(out["int8_fused"][0], out["int8_fused_ref"][0]))
    same_fuse = all(a.output == b.output for a, b in zip(out["int8_fused"][0], out["int8_three_sites"][0]))
    log(f"  int8 fused kernel tokens == ref tokens: {same_ref}; fused tokens == three-site tokens: {same_fuse}")
    for a, b, c in zip(out["int8_fused"][0], out["int8_fused_ref"][0], out["int8_three_sites"][0]):
        log(f"    uid {a.uid}: kernel {a.output} ref {b.output} three sites {c.output}")
    del params_q
    return ok and same_ref and same_fuse, out


def dense_serve_phase(torch, registry, card):
    """granite-3-8b at full width with ``GRANITE_SERVE_LAYERS`` of its 40
    layers (bf16, ``init_params`` seed 0
    on the card) on the paged Scheduler with the serve phase's four prompt
    lengths and 8 new tokens: ideal greedy on ``kernel`` and ``ref``
    (tokens equal); ideal at temperature 0.8 under the reference's keys
    (seed 0), twice on ``kernel`` and once on ``ref`` (all three equal); the
    int8 layout (``quantize_params``, ``kv_cache_int8``, the bias-free fused
    ``wqkv`` bank) on ``kernel`` and ``ref`` (tokens equal); then
    qwen2-1.5b at full width (28 layers) ideal greedy on ``kernel`` and
    ``ref`` (tokens equal).  Fused launches 6 (4 with ``wqkv``) x layers x
    forwards on ``kernel``, none on ``ref``.  Returns (ok, runs, peak
    memory in bytes)."""
    from repro_torch.models.common import init_params, quantize_params

    ok, runs = True, {}
    torch.cuda.reset_peak_memory_stats()

    def one(arch, params, label, backend, **kw):
        n_layers = arch.config.num_layers
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, arch.config.vocab_size, n).astype(np.int32) for n in (16, 40, 64, 24)]
        reqs, launches, forwards, done, finite, st = serve(
            torch, arch, params, ideal_dpu(), backend, prompts, card, label, **kw)
        expect = (4 if kw.get("fuse") else 6) * n_layers * forwards if backend == "kernel" else 0
        good = (done and finite and launches["photonic_gemm_fused"] == expect
                and launches["photonic_gemm"] == 0 and launches["flash_attention"] == 0)
        log(f"  {label}: all done {done}, logits finite {finite}, fused launches "
            f"{launches['photonic_gemm_fused']} == {expect}: {good}")
        runs[label] = (reqs, launches, st)
        torch.cuda.empty_cache()
        return good

    def same(a, b):
        eq = all(x.output == y.output for x, y in zip(runs[a][0], runs[b][0]))
        log(f"  {a} tokens == {b} tokens: {eq}")
        for x, y in zip(runs[a][0], runs[b][0]):
            log(f"    uid {x.uid}: {a} {x.output} {b} {y.output}")
        return eq

    arch = registry.get("granite-3-8b")
    arch = dataclasses.replace(arch, config=dataclasses.replace(arch.config, num_layers=GRANITE_SERVE_LAYERS))
    t0 = time.perf_counter()
    params = init_params(arch.config, 0, device="cuda")
    torch.cuda.synchronize()
    log(f"  init_params (granite-3-8b full width, {GRANITE_SERVE_LAYERS} of 40 layers, bf16) "
        f"{time.perf_counter() - t0:.2f} s")
    ok &= one(arch, params, "granite_ideal", "kernel")
    ok &= one(arch, params, "granite_ideal_ref", "ref")
    ok &= same("granite_ideal", "granite_ideal_ref")
    for label, backend in (("granite_t08", "kernel"), ("granite_t08_again", "kernel"), ("granite_t08_ref", "ref")):
        ok &= one(arch, params, label, backend, temperature=0.8)
    ok &= same("granite_t08", "granite_t08_again") & same("granite_t08", "granite_t08_ref")
    differs = any(x.output != y.output for x, y in zip(runs["granite_t08"][0], runs["granite_ideal"][0]))
    log(f"  granite sampled tokens differ from greedy ones (the draw is live): {differs}")
    ok &= differs
    extra = dict(photonic_scope="weights_int8", kv_cache_int8=True)
    params_q = quantize_params(params, arch.param_defs(dataclasses.replace(arch.config, photonic=ideal_dpu(), **extra)))
    del params
    torch.cuda.empty_cache()
    ok &= one(arch, params_q, "granite_int8_fused", "kernel", extra=extra, fuse=True)
    ok &= one(arch, params_q, "granite_int8_fused_ref", "ref", extra=extra, fuse=True)
    ok &= same("granite_int8_fused", "granite_int8_fused_ref")
    del params_q
    torch.cuda.empty_cache()

    arch = registry.get("qwen2-1.5b")
    params = init_params(arch.config, 0, device="cuda")
    ok &= one(arch, params, "qwen2_1_5b_ideal", "kernel")
    ok &= one(arch, params, "qwen2_1_5b_ideal_ref", "ref")
    ok &= same("qwen2_1_5b_ideal", "qwen2_1_5b_ideal_ref")
    del params
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    log(f"  dense serve peak memory (max_memory_allocated) {peak / 2**30:.2f} GiB [{card}]")
    return ok, runs, peak


def deepseek_phase(torch, registry, card):
    """deepseek-67b at full width with 4 of its 95 layers (the only cut:
    134 GB of bf16 weights do not fit one 80 GB card), ``init_params``
    seed 0 on the card, ideal channel.  ``lm_logits`` on B = 1, T = 512 on
    ``kernel`` and ``ref``, gated as the oneshot phase gates bf16 logits at
    its floor: max |dlogit| / max |logit| <= 2e-2 and argmax agreement >=
    99% (fused launches 6 x 4 + 1, the untied ``lm_head`` routed); then 2
    prompts (32 and 48 tokens) x 4 greedy tokens on the paged server,
    ``kernel`` tokens equal ``ref``'s.  Returns (ok, result, kernel
    launches)."""
    from repro_torch.kernels.photonic_gemm import kernel as K
    from repro_torch.models import lm
    from repro_torch.models.common import init_params
    from repro_torch.serving import prepack_serving_params

    arch = registry.get("deepseek-67b")
    cfg = dataclasses.replace(arch.config, num_layers=4)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    log(f"  init_params (deepseek-67b full width, 4 of 95 layers, bf16) {time.perf_counter() - t0:.2f} s")
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 512)), device="cuda")
    logits, res, ok, launches = {}, {}, True, 0
    for backend in ("kernel", "ref"):
        run = dataclasses.replace(cfg, photonic=ideal_dpu(), photonic_backend=backend)
        with torch.no_grad():
            _, packed = prepack_serving_params(arch, run, params)
            torch.cuda.synchronize()
            K.reset_launches()
            t0 = time.perf_counter()
            out, _ = lm.lm_logits(packed, tokens, run)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            logits[backend] = out.float()
            del packed, out
        want = 6 * 4 + 1 if backend == "kernel" else 0
        good = K.LAUNCHES["photonic_gemm_fused"] == want and bool(torch.isfinite(logits[backend]).all())
        launches += K.LAUNCHES["photonic_gemm_fused"]
        log(f"  deepseek lm_logits {backend} (B=1, T=512): {dt:.3f} s, fused launches "
            f"{K.LAUNCHES['photonic_gemm_fused']} == {want}, finite: {good} [{card}]")
        res[f"lm_logits_{backend}_s"] = dt
        ok &= good
        torch.cuda.empty_cache()
    a, b = logits["kernel"], logits["ref"]
    rel = float((a - b).abs().max() / b.abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    good = rel <= 2e-2 and agree >= 0.99
    log(f"  deepseek lm_logits kernel vs ref over 512 positions: max |dlogit| / max |logit| {rel:.4g} "
        f"(<= 2e-2), argmax agreement {agree:.4f} (>= 0.99), bitwise {bool(torch.equal(a, b))}: {good}")
    ok &= good
    res.update(rel_err=rel, argmax_agreement=agree)
    del logits, a, b
    torch.cuda.empty_cache()
    arch4 = dataclasses.replace(arch, config=cfg)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (32, 48)]
    outs = {}
    for backend in ("kernel", "ref"):
        reqs, lc, forwards, done, finite, st = serve(torch, arch4, params, ideal_dpu(), backend, prompts, card,
                                                     f"deepseek_{backend}", new_tokens=4, batch=2)
        # The head runs on a prompt's final prefill chunk and on every decode step.
        want = 6 * 4 * forwards + st["prefills"] + st["decode_steps"] if backend == "kernel" else 0
        good = done and finite and lc["photonic_gemm_fused"] == want
        log(f"  deepseek serve {backend}: all done {done}, logits finite {finite}, fused launches "
            f"{lc['photonic_gemm_fused']} == {want}: {good}")
        ok &= good
        if backend == "kernel":
            launches += lc["photonic_gemm_fused"]
        outs[backend] = reqs
        res[f"serve_{backend}"] = st
        torch.cuda.empty_cache()
    same = all(x.output == y.output for x, y in zip(outs["kernel"], outs["ref"]))
    for x, y in zip(outs["kernel"], outs["ref"]):
        log(f"    uid {x.uid}: kernel {x.output} ref {y.output}")
    log(f"  deepseek paged greedy kernel tokens == ref tokens: {same}")
    ok &= same
    del params
    torch.cuda.empty_cache()
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"  deepseek peak memory (max_memory_allocated) {res['peak_bytes'] / 2**30:.2f} GiB [{card}]")
    return ok, res, launches


def legacy_moe_serve(torch, arch, params, dpu, backend, prompts, card, label, *, absorb=False, temperature=None,
                     per_forward=None, new_tokens=8):
    """Serve ``prompts`` (``new_tokens`` each) through ``serve.Engine``,
    which must pick ``LegacyEngine`` for the family (batch 4, max_seq 128),
    greedily or sampled at ``temperature`` under the reference's keys (seed
    0), with ``mla_absorb``.  Launch counts are reset just before and held
    to deepseek-v2-lite's (190 a prefill, 190 or 136 absorbed a decode
    step) or, with ``per_forward``, to that many a prefill and a decode
    step.  Every prefill's and decode's logits are checked finite as they
    come."""
    from repro_torch.kernels.flash_attention import kernel as F
    from repro_torch.kernels.photonic_gemm import kernel as K
    from repro_torch.runtime.serve import Engine, LegacyEngine, ServeConfig
    from repro_torch.serving import Request

    finite = []

    def checked(fn):
        def call(*a):
            logits, cache = fn(*a)
            finite.append(bool(torch.isfinite(logits).all()))
            return logits, cache
        return call

    arch_chk = dataclasses.replace(arch, prefill=checked(arch.prefill), decode=checked(arch.decode))
    cfg = dataclasses.replace(arch.config, photonic=dpu, photonic_backend=backend, mla_absorb=absorb)
    sampling = {} if temperature is None else dict(greedy=False, temperature=temperature, seed=0)
    eng = Engine(arch_chk, cfg, params, ServeConfig(batch_size=4, max_seq=128, **sampling))
    legacy = isinstance(eng.impl, LegacyEngine)
    impl = eng.impl
    reqs = [Request(uid=i, prompt=p, max_new_tokens=new_tokens) for i, p in enumerate(prompts)]
    queue = list(reqs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    F.reset_launches()
    t0 = time.perf_counter()
    while queue or any(x is not None for x in impl.slots):
        impl.step(queue)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(K.LAUNCHES, **F.LAUNCHES)
    st = dict(impl.stats)
    toks = sum(len(r.output) for r in reqs)
    decode_ms = st["decode_s"] / max(st["decode_steps"], 1) * 1e3
    per_prefill = V2_FORWARD_LAUNCHES if per_forward is None else per_forward
    per_decode = per_forward or (V2_ABSORBED_LAUNCHES if absorb else V2_FORWARD_LAUNCHES)
    want = per_prefill * st["prefills"] + per_decode * st["decode_steps"] if backend == "kernel" else 0
    done = all(r.done and len(r.output) == new_tokens for r in reqs)
    good = (legacy and done and all(finite) and launches["photonic_gemm_fused"] == want
            and launches["photonic_gemm"] == 0 and launches["flash_attention"] == 0)
    st.update(seconds=dt, tokens=toks, tok_per_s=toks / dt, decode_ms_per_step=decode_ms,
              launches_per_decode=per_decode if backend == "kernel" else 0,
              peak_bytes=torch.cuda.max_memory_allocated())
    log(f"  {label}: LegacyEngine {legacy}, {eng.photonic.describe()}: {toks} tokens in {dt:.3f} s = "
        f"{st['tok_per_s']:.2f} tok/s; prefill {st['prefill_s']:.3f} s over {st['prefills']} prefills (batch 4), "
        f"decode {decode_ms:.2f} ms/step over {st['decode_steps']} steps; fused launches {launches['photonic_gemm_fused']} "
        f"== {per_prefill if backend == 'kernel' else 0} x {st['prefills']} + {per_decode if backend == 'kernel' else 0} x "
        f"{st['decode_steps']} = {want}; all done {done}, logits finite {all(finite)}: {good}; peak memory "
        f"(max_memory_allocated, this run) {st['peak_bytes'] / 2**30:.2f} GiB [{card}]")
    return reqs, launches, st, good


def moe_phase(torch, registry, card):
    """deepseek-v2-lite-16b (MLA with absorbed decode, 64 routed experts top-6
    + 2 shared) at full width and all 27 layers, bf16, ``init_params`` seed
    0 on the card: ``lm_logits`` at B = 1, T = 512 on ``kernel`` and
    ``ref`` on the ideal channel (fused launches 27 x 7 + 1 = 190; max
    |dlogit| / max |logit| <= 2e-2 and argmax agreement >= 99%, aux within
    2e-2 relative); ``serve.Engine`` (which must pick ``LegacyEngine``),
    the serve phase's four prompt lengths and 8 new tokens: greedy on
    ``kernel`` and ``ref``, expanded and with ``mla_absorb`` (190 launches
    a prefill, 190 or 136 a decode step; kernel tokens equal ``ref``'s in
    each mode; how far the two modes' tokens agree is printed, not gated),
    sampled at temperature 0.8 under the reference's keys (kernel tokens
    equal ``ref``'s), and the SMWA analog point (``noise_seed=0``: logits
    finite, all requests done).  Then phi3.5-moe-42b-a6.6b at full width with 4 of its 32
    layers (the whole model is 84 GB of bf16 weights): ``lm_logits`` B = 1,
    T = 512 on ``kernel`` and ``ref`` (4 x 4 + 1 = 17 launches), the same
    gate.  Returns (ok, result, kernel launches)."""
    from repro_torch._tree import tree_leaves
    from repro_torch.kernels.photonic_gemm import kernel as K
    from repro_torch.models import lm
    from repro_torch.models.common import init_params
    from repro_torch.serving import prepack_serving_params

    res, ok, launches_total = {}, True, 0

    def forward(arch, cfg, params, want_launches, tag):
        nonlocal ok, launches_total
        tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 512)), device="cuda")
        logits, auxes = {}, {}
        for backend in ("kernel", "ref"):
            run = dataclasses.replace(cfg, photonic=ideal_dpu(), photonic_backend=backend)
            torch.cuda.reset_peak_memory_stats()
            with torch.no_grad():
                _, packed = prepack_serving_params(arch, run, params)
                torch.cuda.synchronize()
                K.reset_launches()
                record = tag == "deepseek_v2_lite" and backend == "kernel"  # the analytic phase's records
                t0 = time.perf_counter()
                with recorded_gemm_calls() if record else contextlib.nullcontext([]) as calls:
                    out, aux = lm.lm_logits(packed, tokens, run)
                torch.cuda.synchronize()
                if record:
                    res["gemm_calls"] = calls
                dt = time.perf_counter() - t0
                logits[backend], auxes[backend] = out.float(), float(aux)
                del packed, out
            want = want_launches if backend == "kernel" else 0
            n = K.LAUNCHES["photonic_gemm_fused"]
            good = n == want and bool(torch.isfinite(logits[backend]).all())
            launches_total += n
            peak = torch.cuda.max_memory_allocated()
            log(f"  {tag} lm_logits {backend} (B=1, T=512): {dt:.3f} s, aux {auxes[backend]:.6f}, fused launches "
                f"{n} == {want}, finite: {good}; peak memory (max_memory_allocated, prepack and forward) "
                f"{peak / 2**30:.2f} GiB [{card}]")
            res[f"{tag}_lm_logits_{backend}_s"] = dt
            res[f"{tag}_lm_logits_{backend}_peak_bytes"] = peak
            ok &= good
            torch.cuda.empty_cache()
        a, b = logits["kernel"], logits["ref"]
        rel = float((a - b).abs().max() / b.abs().max())
        agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        aux_rel = abs(auxes["kernel"] - auxes["ref"]) / abs(auxes["ref"])
        good = rel <= 2e-2 and agree >= 0.99 and aux_rel <= 2e-2
        log(f"  {tag} lm_logits kernel vs ref over 512 positions: max |dlogit| / max |logit| {rel:.4g} (<= 2e-2), "
            f"argmax agreement {agree:.4f} (>= 0.99), aux relative difference {aux_rel:.3g} (<= 2e-2), bitwise "
            f"{bool(torch.equal(a, b))}: {good}")
        res[tag] = dict(rel_err=rel, argmax_agreement=agree, aux=auxes, aux_rel=aux_rel, bitwise=bool(torch.equal(a, b)))
        ok &= good

    arch = registry.get("deepseek-v2-lite-16b")
    cfg = arch.config
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"  init_params (deepseek-v2-lite-16b full width, 27 layers, bf16, {n_params / 1e9:.3f} B parameters) "
        f"{time.perf_counter() - t0:.2f} s")
    forward(arch, cfg, params, V2_FORWARD_LAUNCHES, "deepseek_v2_lite")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (16, 40, 64, 24)]
    runs = {}
    for label, backend, absorb, temp, dpu in (
        ("v2_greedy", "kernel", False, None, ideal_dpu()),
        ("v2_greedy_ref", "ref", False, None, ideal_dpu()),
        ("v2_absorbed", "kernel", True, None, ideal_dpu()),
        ("v2_absorbed_ref", "ref", True, None, ideal_dpu()),
        ("v2_t08", "kernel", False, 0.8, ideal_dpu()),
        ("v2_t08_ref", "ref", False, 0.8, ideal_dpu()),
        ("v2_smwa", "kernel", False, None, smwa_dpu()),
    ):
        reqs, lc, st, good = legacy_moe_serve(
            torch, arch, params, dpu, backend, prompts, card, label, absorb=absorb, temperature=temp)
        ok &= good
        if backend == "kernel":
            launches_total += lc["photonic_gemm_fused"]
        runs[label] = (reqs, lc, st)
        torch.cuda.empty_cache()

    def same(a_, b_):
        eq = all(x.output == y.output for x, y in zip(runs[a_][0], runs[b_][0]))
        log(f"  {a_} tokens == {b_} tokens: {eq}")
        for x, y in zip(runs[a_][0], runs[b_][0]):
            log(f"    uid {x.uid}: {a_} {x.output} {b_} {y.output}")
        return eq

    ok &= same("v2_greedy", "v2_greedy_ref") & same("v2_absorbed", "v2_absorbed_ref") & same("v2_t08", "v2_t08_ref")
    pairs = [(x.output, y.output) for x, y in zip(runs["v2_greedy"][0], runs["v2_absorbed"][0])]
    agree = sum(a_ == b_ for p in pairs for a_, b_ in zip(*p)) / sum(len(p[0]) for p in pairs)
    log(f"  absorbed vs expanded greedy tokens (kernel, not gated): {agree:.3f} of positions equal, "
        f"first tokens equal {all(p[0][0] == p[1][0] for p in pairs)}")
    res["absorbed_vs_expanded_token_agreement"] = agree
    for r in runs["v2_smwa"][0]:
        log(f"    smwa uid {r.uid}: {r.output}")
    res["serve"] = {k: v[2] for k, v in runs.items()}
    del params, runs
    torch.cuda.empty_cache()

    arch = registry.get("phi3.5-moe-42b-a6.6b")
    cfg = dataclasses.replace(arch.config, num_layers=4)
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    log(f"  init_params (phi3.5-moe full width, 4 of 32 layers, bf16) {time.perf_counter() - t0:.2f} s")
    forward(arch, cfg, params, 4 * 4 + 1, "phi3_5_moe")
    del params
    torch.cuda.empty_cache()
    return ok, res, launches_total


def cross_kernel_rows(torch, K, chans, key, gen, rows, card):
    """The cross phase's kernel rows, each against its twin on the card:
    llama-3.2-vision-90b's six self-layer sites and its cross layer's
    ``wq`` / ``wo`` / MLP at R = 4 and 64 and its head at R = 4, ideal and
    SMWA under ``key``; ``cross_kv``'s ``wk`` / ``wv`` at R = 4 x 1600,
    ideal; whisper-medium's encoder sites at R = 4 x 1500, ideal, and its
    decoder sites and head at R = 4, ideal and SMWA under ``key``.  Every
    row is bitwise its twin, noise included, except the gelu tail of
    ``ffn.wi`` (float tolerance, 1e-5 relative).  Logs the per-layer and
    per-step sums.  Returns ok."""
    ok = True

    def case(model, name, r, site, k, c, label=None):
        return kernel_case(torch, K, chans[name], r, k, c, False, False, "gelu" if model == "whisper-medium" and
                           site == "ffn.wi" else None, gen, rows, model=model, site=label or site,
                           key=key if name == "SMWA" else None, exact=True, twin_once=True)

    vlm, wh = "llama-3.2-vision-90b", "whisper-medium"
    for name in ("ideal", "SMWA"):
        for r in (4, 64):
            for site, k, c in VISION_SITES:
                ok &= case(vlm, name, r, site, k, c)
            for site, k, c in VISION_CROSS_SITES:
                ok &= case(vlm, name, r, site, k, c, label="cross " + site)
        ok &= case(vlm, name, 4, *VISION_HEAD)
    for site, k, c in VISION_KV_SITES:
        ok &= case(vlm, "ideal", VISION_KV_ROWS, site, k, c, label="cross_kv " + site)
    for site, k, c in WHISPER_SITES:
        ok &= case(wh, "ideal", WHISPER_ENC_ROWS, site, k, c, label="encoder " + site)
    for name in ("ideal", "SMWA"):
        for site, k, c in WHISPER_SITES:
            ok &= case(wh, name, 4, site, k, c)
        ok &= case(wh, name, 4, *WHISPER_HEAD)

    def pick(model, name, r, sites):
        return [next(x for x in rows if x["model"] == model and x["channel"] == name and x["R_live"] == r
                     and x["site"] == s) for s in sites]

    def log_sum(what, parts):
        """``parts``: (count, row) pairs summed as count x row."""
        bm, bb = bound_of([tuple(n * v for v in x["parts"]) for n, x in parts])
        tot = {key_: sum(n * x[key_] for n, x in parts) for key_ in ("ms", "plain_ms", "library_ms")}
        log(f"  {what}: kernel {tot['ms']:.4f} ms, twin {tot['plain_ms']:.3f} ms, bound {bm:.5f} ms ({bb}), "
            f"_int_mm {tot['library_ms']:.4f} ms [{card}]")
        return dict(tot, bound_ms=bm, bound_by=bb)

    sums = {}
    self_sites = [s for s, _, _ in VISION_SITES]
    cross_sites = ["cross " + s for s, _, _ in VISION_CROSS_SITES]
    for name in ("ideal", "SMWA"):
        for r in (4, 64):
            sums[f"vlm self layer {name} R={r}"] = log_sum(
                f"{vlm} self layer (6 sites) {name} R={r}", [(1, x) for x in pick(vlm, name, r, self_sites)])
            sums[f"vlm cross layer {name} R={r}"] = log_sum(
                f"{vlm} cross layer's wq/wo/MLP {name} R={r}", [(1, x) for x in pick(vlm, name, r, cross_sites)])
        step = ([(8, x) for x in pick(vlm, name, 4, self_sites)] + [(2, x) for x in pick(vlm, name, 4, cross_sites)]
                + [(1, x) for x in pick(vlm, name, 4, ["lm_head"])])
        sums[f"vlm decode step {name}"] = log_sum(
            f"{vlm} decode step's GEMMs (8 self layers + 2 cross layers + head, R=4) {name}", step)
    kv = pick(vlm, "ideal", VISION_KV_ROWS, ["cross_kv " + s for s, _, _ in VISION_KV_SITES])
    sums["vlm cross_kv"] = log_sum(f"{vlm} cross_kv (wk + wv, R={VISION_KV_ROWS}) ideal", [(1, x) for x in kv])
    enc = pick(wh, "ideal", WHISPER_ENC_ROWS, ["encoder " + s for s, _, _ in WHISPER_SITES])
    sums["whisper encoder layer"] = log_sum(f"{wh} encoder layer (R={WHISPER_ENC_ROWS}) ideal",
                                            [(1, x) for x in enc])
    for name in ("ideal", "SMWA"):
        dec = pick(wh, name, 4, [s for s, _, _ in WHISPER_SITES])
        # A decoder layer's eight calls: the self-attention's four, the cross wq and wo, the MLP.
        layer = [(1, x) for x in dec] + [(1, dec[0]), (1, dec[3])]
        sums[f"whisper decoder layer {name}"] = log_sum(f"{wh} decoder layer (8 calls, R=4) {name}", layer)
        sums[f"whisper decode step {name}"] = log_sum(
            f"{wh} decode step's GEMMs (24 decoder layers + head, R=4) {name}",
            [(24 * n, x) for n, x in layer] + [(1, x) for x in pick(wh, name, 4, ["lm_head"])])
    return ok, sums


def decode_run(torch, arch, packed, cfg, batch, max_seq, steps, card, label, *, want_prefill, want_step,
               want_flash=0):
    """``arch.prefill`` of ``batch`` then ``steps`` greedy ``arch.decode``
    steps, each step's logits checked finite, launch counts reset just
    before and held to ``want_prefill`` + ``want_step`` x steps fused
    launches (``want_flash`` flash launches).  Returns (tokens (B, steps + 1) as lists, result dict, ok)."""
    from repro_torch.kernels.flash_attention import kernel as F
    from repro_torch.kernels.photonic_gemm import kernel as K

    vocab = cfg.vocab_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    F.reset_launches()
    finite = []
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = arch.prefill(packed, batch, cfg, max_seq)
        tok = logits[:, -1, :vocab].argmax(-1)
        finite.append(bool(torch.isfinite(logits).all()))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        toks = [tok]

        def step():
            nonlocal cache
            logits, cache = arch.decode(packed, toks[-1][:, None], cache, cfg)
            toks.append(logits[:, -1, :vocab].argmax(-1))
            finite.append(bool(torch.isfinite(logits).all()))

        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    fused, flash = K.LAUNCHES["photonic_gemm_fused"], F.LAUNCHES["flash_attention"]
    want = want_prefill + want_step * steps
    ok = all(finite) and fused == want and flash == want_flash and K.LAUNCHES["photonic_gemm"] == 0
    res = dict(prefill_s=prefill_s, decode_ms_per_step=decode_s / steps * 1e3, steps=steps,
               fused_launches=fused, flash_launches=flash, peak_bytes=torch.cuda.max_memory_allocated(),
               finite=all(finite))
    log(f"  {label}: prefill {prefill_s:.3f} s, decode {res['decode_ms_per_step']:.2f} ms/step over {steps} "
        f"steps; fused launches {fused} == {want_prefill} + {want_step} x {steps} = {want}, flash {flash} == "
        f"{want_flash}, logits finite {all(finite)}: {ok}; peak memory (max_memory_allocated, this run) "
        f"{res['peak_bytes'] / 2**30:.2f} GiB [{card}]")
    return torch.stack(toks, dim=1).tolist(), res, ok


def floor_gate(a, b, what):
    """The oneshot phase's bf16 floor on two logits tensors of one shape:
    (pass, numbers)."""
    rel = float((a - b).abs().max() / b.abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    bitwise = bool((a == b).all())
    good = rel <= 2e-2 and agree >= 0.99
    log(f"  {what} over {a.shape[0] * a.shape[1]} positions: max |dlogit| / max |logit| {rel:.4g} (<= 2e-2), "
        f"argmax agreement {agree:.4f} (>= 0.99), bitwise {bitwise}: {good}")
    return good, dict(rel_err=rel, argmax_agreement=agree, bitwise=bitwise)


def cross_phase(torch, registry, card):
    """The cross-attention families at full width (module docstring, phase
    6e, after its kernel rows).  Returns (ok, result, fused launches,
    flash launches)."""
    from repro_torch._tree import tree_leaves
    from repro_torch.kernels.flash_attention import kernel as F
    from repro_torch.kernels.photonic_gemm import kernel as K
    from repro_torch.models import lm, whisper
    from repro_torch.models.common import init_params
    from repro_torch.serving import prepack_serving_params

    ok, res, fused_total, flash_total = True, {}, 0, 0  # launches summed over both models
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32

    def same_tokens(a, b, what):
        eq = a == b
        log(f"  {what}: {eq}")
        for i, (x, y) in enumerate(zip(a, b)):
            log(f"    row {i}: {x} / {y}")
        return eq

    # -- llama-3.2-vision-90b, 10 of 100 layers --------------------------------
    arch = registry.get("llama-3.2-vision-90b")
    cfg = dataclasses.replace(arch.config, num_layers=VISION_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    _open_gates(params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"  init_params (llama-3.2-vision-90b full width, {VISION_LAYERS} of 100 layers: 8 self + 2 cross, bf16, "
        f"{n_params / 1e9:.3f} B parameters) {time.perf_counter() - t0:.2f} s; gates set to 0.5")
    vision = {f32: torch.randn((4, cfg.vision_seq, cfg.d_model), generator=g, device="cuda")}
    vision[bf16] = vision[f32].to(bf16)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), generator=g, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (4, 64), generator=g, device="cuda")
    logits, packs, vlm = {}, {}, {}
    for backend in ("kernel", "ref"):
        run = dataclasses.replace(cfg, photonic=ideal_dpu(), photonic_backend=backend)
        with torch.no_grad():
            t0 = time.perf_counter()
            _, packs[backend] = prepack_serving_params(arch, run, params)
            torch.cuda.synchronize()
            log(f"  prepack ({backend}) {time.perf_counter() - t0:.2f} s")
            for dt in (bf16, f32):
                K.reset_launches()
                t0 = time.perf_counter()
                out, _ = lm.lm_logits(packs[backend], tokens, run, vision=vision[dt][:1])
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                logits[backend, dt] = out.float()
                want = VISION_FORWARD_LAUNCHES if backend == "kernel" else 0
                n = K.LAUNCHES["photonic_gemm_fused"]
                good = n == want and bool(torch.isfinite(out).all())
                fused_total += n
                log(f"  vlm lm_logits {backend}, vision {str(dt)[6:]} (B=1, T=512, vision 1600): {secs:.3f} s, "
                    f"fused launches {n} == {want}, finite: {good} [{card}]")
                vlm[f"lm_logits_{backend}_{str(dt)[6:]}_s"] = secs
                ok &= good
    vlm["lm_logits_peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"  vlm peak memory over init, both prepacks and the four lm_logits (max_memory_allocated) "
        f"{vlm['lm_logits_peak_bytes'] / 2**30:.2f} GiB [{card}]")
    for dt in (bf16, f32):
        good, vlm[f"lm_logits_{str(dt)[6:]}"] = floor_gate(logits["kernel", dt], logits["ref", dt],
                                                           f"vlm lm_logits kernel vs ref, vision {str(dt)[6:]}")
        ok &= good
    # The cross path is live: other vision, other logits.
    moved = float((logits["kernel", bf16] - logits["kernel", f32]).abs().max())
    K.reset_launches()
    with torch.no_grad():
        other, _ = lm.lm_logits(packs["kernel"], tokens, dataclasses.replace(cfg, photonic=ideal_dpu()),
                                vision=torch.randn((1, cfg.vision_seq, cfg.d_model), generator=g, device="cuda"))
    n = K.LAUNCHES["photonic_gemm_fused"]
    fused_total += n
    moved_other = float((other.float() - logits["kernel", f32]).abs().max() / logits["kernel", f32].abs().max())
    good = moved_other > 1e-2 and n == VISION_FORWARD_LAUNCHES
    log(f"  vlm lm_logits with another vision input: max |dlogit| / max |logit| {moved_other:.4g} (> 1e-2: the "
        f"cross layers read the vision input), fused launches {n} == {VISION_FORWARD_LAUNCHES}: {good}; bf16 vs "
        f"f32 vision max |dlogit| {moved:.4g}")
    ok &= good
    del logits, other
    batch = {"tokens": prompt, "vision": vision[bf16]}
    toks = {}
    for backend in ("kernel", "ref"):
        run = dataclasses.replace(cfg, photonic=ideal_dpu(), photonic_backend=backend)
        toks[backend], vlm[f"decode_{backend}"], good = decode_run(
            torch, arch, packs[backend], run, batch, 128, 16, card, f"vlm_{backend}",
            want_prefill=VISION_FORWARD_LAUNCHES if backend == "kernel" else 0,
            want_step=VISION_DECODE_LAUNCHES if backend == "kernel" else 0)
        ok &= good
        fused_total += vlm[f"decode_{backend}"]["fused_launches"]
    ok &= same_tokens(toks["kernel"], toks["ref"], "vlm greedy tokens (64-token prompt + 16 steps), kernel == ref")
    del packs
    torch.cuda.empty_cache()
    run = dataclasses.replace(cfg, photonic=smwa_dpu(), photonic_backend="kernel")
    with torch.no_grad():
        _, packed = prepack_serving_params(arch, run, params)
    smwa_toks, vlm["decode_smwa"], good = decode_run(
        torch, arch, packed, run, batch, 128, 4, card, "vlm_smwa",
        want_prefill=VISION_FORWARD_LAUNCHES, want_step=VISION_DECODE_LAUNCHES)
    ok &= good
    fused_total += vlm["decode_smwa"]["fused_launches"]
    log(f"  vlm SMWA (noise_seed=0) tokens: {smwa_toks}")
    vlm.update(n_params=n_params, fused_launches=fused_total)
    res["llama-3.2-vision-90b"] = vlm
    del packed, params, vision, batch
    torch.cuda.empty_cache()

    # -- whisper-medium, 2 + 2 of its 24 + 24 layers -----------------------------
    arch = registry.get("whisper-medium")
    cfg = dataclasses.replace(arch.config, num_layers=WHISPER_SERVE_LAYERS, encoder_layers=WHISPER_SERVE_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda", defs=arch.param_defs(cfg))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"  init_params (whisper-medium full width, {WHISPER_SERVE_LAYERS} + {WHISPER_SERVE_LAYERS} of its 24 + 24 "
        f"layers, bf16, {n_params / 1e9:.3f} B parameters) "
        f"{time.perf_counter() - t0:.2f} s")
    t_enc = 1500
    audio = {f32: torch.randn((4, t_enc, cfg.d_model), generator=g, device="cuda")}
    audio[bf16] = audio[f32].to(bf16)
    dec_tokens = torch.randint(0, cfg.vocab_size, (4, t_enc // cfg.decoder_ratio), generator=g, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (4, 4), generator=g, device="cuda")
    wres, logits, packs = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    for backend in ("kernel", "ref"):
        run = dataclasses.replace(cfg, photonic=ideal_dpu(), photonic_backend=backend)
        with torch.no_grad():
            _, packs[backend] = prepack_serving_params(arch, run, params)
            for dt in (bf16, f32):
                # On the kernel in bf16 also flash, and the witness: chunked at
                # flash's key block (the oneshot phase's gate).
                impls = (("chunked", "chunked", cfg.attn_chunk),)
                if backend == "kernel" and dt == bf16:
                    impls += (("flash", "flash", cfg.attn_chunk), ("chunked_128", "chunked", 128))
                for name, impl, chunk in impls:
                    K.reset_launches()
                    F.reset_launches()
                    t0 = time.perf_counter()
                    out, _ = whisper.whisper_logits(packs[backend], {"tokens": dec_tokens, "audio_embed": audio[dt]},
                                                    dataclasses.replace(run, attn_impl=impl, attn_chunk=chunk))
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t0
                    logits[backend, dt, name] = out.float()
                    want = WHISPER_SERVE_PREFILL_LAUNCHES if backend == "kernel" else 0
                    want_flash = WHISPER_SERVE_FLASH if impl == "flash" else 0
                    n, nf = K.LAUNCHES["photonic_gemm_fused"], F.LAUNCHES["flash_attention"]
                    good = n == want and nf == want_flash and bool(torch.isfinite(out).all())
                    fused_total += n
                    flash_total += nf
                    log(f"  whisper_logits {backend}, audio {str(dt)[6:]}, attn_impl={impl} attn_chunk={chunk} (B=4, "
                        f"1500 frames, 375 tokens): {secs:.3f} s, fused launches {n} == {want}, flash {nf} == "
                        f"{want_flash}, finite: {good} [{card}]")
                    wres[f"whisper_logits_{backend}_{str(dt)[6:]}_{name}_s"] = secs
                    ok &= good
    wres["whisper_logits_peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"  whisper peak memory over both prepacks and the six whisper_logits (max_memory_allocated) "
        f"{wres['whisper_logits_peak_bytes'] / 2**30:.2f} GiB [{card}]")
    for dt in (bf16, f32):
        good, wres[f"whisper_logits_{str(dt)[6:]}"] = floor_gate(
            logits["kernel", dt, "chunked"], logits["ref", dt, "chunked"],
            f"whisper_logits kernel vs ref, audio {str(dt)[6:]}")
        ok &= good
    # Flash against chunked under the oneshot phase's gate: the bf16 floor,
    # widened to twice what the witness (chunked at flash's key block
    # against chunked, no kernel involved) shows the model makes of a
    # rounding difference of its attention cores.
    _, witness = floor_gate(logits["kernel", bf16, "chunked_128"], logits["kernel", bf16, "chunked"],
                            "whisper_logits witness: chunked at 128 vs chunked (bf16; sets the flash gate)")
    max_rel = max(2e-2, 2 * witness["rel_err"])
    min_agree = 1.0 - max(0.01, 2 * (1.0 - witness["argmax_agreement"]))
    _, flash_cmp = floor_gate(logits["kernel", bf16, "flash"], logits["kernel", bf16, "chunked"],
                              "whisper_logits flash vs chunked (bf16; the plain bf16 floor, not gated)")
    good = flash_cmp["rel_err"] <= max_rel and flash_cmp["argmax_agreement"] >= min_agree
    log(f"  whisper_logits flash vs chunked, gate <= {max_rel:.4g} and >= {min_agree:.4f} (max(2e-2, 2 x witness), "
        f"max(1%, 2 x the witness's disagreement)): {good} [{card}]")
    wres["whisper_logits_flash_vs_chunked"] = dict(flash_cmp, witness=witness, max_rel_err=max_rel,
                                                   min_argmax_agreement=min_agree)
    ok &= good
    del logits
    batch = {"tokens": prompt, "audio_embed": audio[bf16]}
    toks = {}
    max_seq = t_enc // cfg.decoder_ratio
    for label, backend, impl in (("kernel", "kernel", "chunked"), ("ref", "ref", "chunked"),
                                 ("flash", "kernel", "flash")):
        run = dataclasses.replace(cfg, photonic=ideal_dpu(), photonic_backend=backend, attn_impl=impl)
        kernel = backend == "kernel"
        toks[label], wres[f"decode_{label}"], good = decode_run(
            torch, arch, packs[backend], run, batch, max_seq, 16, card, f"whisper_{label}",
            want_prefill=WHISPER_SERVE_PREFILL_LAUNCHES if kernel else 0,
            want_step=WHISPER_SERVE_DECODE_LAUNCHES if kernel else 0,
            want_flash=WHISPER_SERVE_FLASH if impl == "flash" else 0)
        ok &= good
        fused_total += wres[f"decode_{label}"]["fused_launches"]
        flash_total += wres[f"decode_{label}"]["flash_launches"]
    ok &= same_tokens(toks["kernel"], toks["ref"], "whisper greedy tokens (4-token prompt + 16 steps), kernel == ref")
    agree = sum(a == b for x, y in zip(toks["flash"], toks["kernel"]) for a, b in zip(x, y)) / (4 * 17)
    log(f"  whisper flash-prefill tokens vs chunked (not gated): {agree:.3f} of positions equal")
    wres["flash_token_agreement"] = agree
    wres.update(n_params=n_params, fused_launches=fused_total - vlm["fused_launches"], flash_launches=flash_total)
    res["whisper-medium"] = wres
    del packs, params, audio, batch
    torch.cuda.empty_cache()
    return ok, res, fused_total, flash_total


def recurrent_kernel_rows(torch, K, chans, key, gen, rows, card):
    """The recurrent phase's kernel rows, each bitwise its twin on the card
    (noise included): xlstm-350m's mLSTM sites (the gates ``wi`` / ``wf``
    at C = 4), sLSTM sites and head, and zamba2-2.7b's Mamba2 sites,
    shared-block sites and head, at R = 4 and 4 x 64 (the heads at R = 4),
    ideal and SMWA under ``key``.  Logs the per-layer and per-decode-step
    sums.  Returns (ok, sums)."""
    ok = True
    xl, zb = "xlstm-350m", "zamba2-2.7b"
    layers = {xl: (XLSTM_SITES, XLSTM_SLSTM_SITES, XLSTM_HEAD), zb: (ZAMBA_SITES, ZAMBA_SHARED_SITES, ZAMBA_HEAD)}
    for model, (first, second, head) in layers.items():
        for name in ("ideal", "SMWA"):
            for r in RECURRENT_ROWS:
                for site, k, c in first + second:
                    ok &= kernel_case(torch, K, chans[name], r, k, c, False, False, None, gen, rows, model=model,
                                      site=site, key=key if name == "SMWA" else None, exact=True, twin_once=True)
            ok &= kernel_case(torch, K, chans[name], 4, *head[1:], False, False, None, gen, rows, model=model,
                              site=head[0], key=key if name == "SMWA" else None, exact=True, twin_once=True)

    def pick(model, name, r, sites):
        return [next(x for x in rows if x["model"] == model and x["channel"] == name and x["R_live"] == r
                     and x["site"] == s) for s, _, _ in sites]

    def log_sum(what, parts):
        """``parts``: (count, row) pairs summed as count x row."""
        bm, bb = bound_of([tuple(n * v for v in x["parts"]) for n, x in parts])
        tot = {key_: sum(n * x[key_] for n, x in parts) for key_ in ("ms", "plain_ms", "library_ms")}
        log(f"  {what}: kernel {tot['ms']:.4f} ms, twin {tot['plain_ms']:.3f} ms, bound {bm:.5f} ms ({bb}), "
            f"_int_mm {tot['library_ms']:.4f} ms [{card}]")
        return dict(tot, bound_ms=bm, bound_by=bb)

    sums = {}
    counts = {xl: (21, 3, "mLSTM layer (7 sites)", "sLSTM layer (2 sites)"),
              zb: (54, 9, "Mamba2 layer (2 sites)", "shared-block invocation (6 sites)")}
    for model, (first, second, head) in layers.items():
        n1, n2, what1, what2 = counts[model]
        for name in ("ideal", "SMWA"):
            for r in RECURRENT_ROWS:
                sums[f"{model} first {name} R={r}"] = log_sum(
                    f"{model} {what1} {name} R={r}", [(1, x) for x in pick(model, name, r, first)])
                sums[f"{model} second {name} R={r}"] = log_sum(
                    f"{model} {what2} {name} R={r}", [(1, x) for x in pick(model, name, r, second)])
            step = ([(n1, x) for x in pick(model, name, 4, first)] + [(n2, x) for x in pick(model, name, 4, second)]
                    + [(1, x) for x in pick(model, name, 4, [head])])
            sums[f"{model} decode step {name}"] = log_sum(
                f"{model} decode step's GEMMs ({n1} x {what1.split(' (')[0]} + {n2} x {what2.split(' (')[0]} + head, "
                f"R=4) {name}", step)
    return ok, sums


def train_kernel_rows(torch, K, ideal, gen, rows, card):
    """The train-families phase's kernel rows at the training shape (R =
    4096 = 4 x 1024 tokens), ideal channel, each bitwise its twin, with its
    time, bound and the ``_int_mm`` time of its int core: xlstm-350m's
    mLSTM layer (the gates ``wi`` / ``wf`` at C = 4) and sLSTM layer,
    zamba2-2.7b's Mamba2 layer and shared-block invocation, and a
    deepseek-v2-lite-16b MoE layer's routed GEMMs (MLA expanded, as
    training runs it: ``wuk`` / ``wuv`` over the 4096 latent rows; the
    shared experts).  Logs the per-layer sums.  Returns (ok, sums)."""
    v2 = [x[:3] for x in V2_SITES[:3] + V2_CACHE_SITES + V2_SITES[3:5]]
    layers = [
        ("xlstm-350m", "mLSTM layer (7 sites)", XLSTM_SITES),
        ("xlstm-350m", "sLSTM layer (2 sites)", XLSTM_SLSTM_SITES),
        ("zamba2-2.7b", "Mamba2 layer (2 sites)", ZAMBA_SITES),
        ("zamba2-2.7b", "shared-block invocation (6 sites)", ZAMBA_SHARED_SITES),
        ("deepseek-v2-lite-16b", "MoE layer (7 routed sites, MLA expanded)", v2),
    ]
    ok, sums = True, {}
    for model, what, sites in layers:
        first = len(rows)
        for site, k, c in sites:
            ok &= kernel_case(torch, K, ideal, TRAIN_ROWS, k, c, False, False, None, gen, rows, model=model,
                              site=site, exact=True, twin_once=True)
        layer = rows[first:]
        bm, bb = bound_of([x["parts"] for x in layer])
        tot = {key: sum(x[key] for x in layer) for key in ("ms", "plain_ms", "library_ms")}
        sums[f"{model} {what}"] = dict(tot, bound_ms=bm, bound_by=bb)
        log(f"  {model} {what} ideal R={TRAIN_ROWS}: kernel {tot['ms']:.4f} ms, twin {tot['plain_ms']:.3f} ms, "
            f"bound {bm:.5f} ms ({bb}), _int_mm {tot['library_ms']:.4f} ms [{card}]")
    return ok, sums


@contextlib.contextmanager
def recorded_flash_calls():
    """Inside the block, every ``flash_attention_fwd`` call that
    ``ops.flash_attention`` makes is recorded as ``(q, k, v, args, out)``
    in the list the block receives."""
    from repro_torch.kernels.flash_attention import ops

    calls, real = [], ops.flash_attention_fwd

    def record(q, k, v, **args):
        out = real(q, k, v, **args)
        calls.append((q, k, v, args, out))
        return out

    ops.flash_attention_fwd = record
    try:
        yield calls
    finally:
        ops.flash_attention_fwd = real


def flash_calls_within_bound(torch, calls, what, card):
    """Each recorded flash call's output against the f64 bound of
    ``ref.oracle_and_bound`` on that call's own inputs (inside a model, not
    on random ones).  Returns (every element within the bound, [(worst
    |got - o| / bound, elements over it)] a call)."""
    from repro_torch.kernels.flash_attention.ref import gate_ratio, oracle_and_bound

    worst = []
    for q, k, v, args, y in calls:
        o, bound = oracle_and_bound(q, k, v, scale=args["scale"], causal=args["causal"], q_offset=args["q_offset"],
                                    kv_valid=args["kv_valid"], bk=args["bk"])
        r = gate_ratio(y, o, bound)
        worst.append((float(r.max()), int((r > 1).sum())))
        del o, bound, r
    ok = bool(worst) and all(n == 0 for _, n in worst)
    log(f"  {what} flash calls in the forward, each against the f64 bound of its own inputs (worst |got - o| / "
        f"bound, elements over): {[(round(x, 4), n) for x, n in worst]}: {ok} [{card}]")
    return ok, worst


@contextlib.contextmanager
def recorded_gemm_calls():
    """Inside the block, every routed GEMM that reaches
    ``PhotonicEngine.int_gemm`` is recorded in the list the block receives
    as ``dict(site, layer, K, C, rows)`` (the logical K and C, the live
    rows); a GEMM the site policy keeps digital never gets there."""
    from repro_torch.photonic.engine import PhotonicEngine

    calls, real = [], PhotonicEngine.int_gemm

    def record(self, xq, wq, **kw):
        k, c = kw.get("logical_kc") or tuple(wq.shape[-2:])
        fold = kw.get("fold")
        calls.append(dict(site=kw.get("site"), layer=None if fold is None else int(fold), K=int(k), C=int(c),
                          rows=int(xq.shape[0])))
        return real(self, xq, wq, **kw)

    PhotonicEngine.int_gemm = record
    try:
        yield calls
    finally:
        PhotonicEngine.int_gemm = real


# The mapper's LM graph (``repro.mapper.workload.WorkloadGraph.
# from_model_config``) differs from the model the port and the reference
# run in three places, each read in the reference's code (ROADMAP Queue 3):
GRAPH_DIFFERENCES = {
    "tied_head": "the graph prices lm_head on the DPU (src/repro/mapper/workload.py:202); a model that ties its "
                 "embeddings computes the digital x @ table.T (src/repro/models/lm.py:186-187; port "
                 "models/lm.py::_head), no routed GEMM",
    "first_block": "the graph lowers layer 0 of an MLA MoE model as routed plus shared experts "
                   "(src/repro/mapper/workload.py:181-197); the model's layer 0 is a dense FFN of width d_ff "
                   "(first_block, src/repro/models/lm.py:67-68, :146; port models/lm.py::_layers)",
    "expert_rows": "the graph prices the routed experts as ffn.wi / ffn.wo GEMMs of t x top_k rows on the DPU "
                   "(src/repro/mapper/workload.py:187-190); the model runs every expert on its capacity slots, "
                   "E x capacity rows a batch row, as digital einsums outside the engine "
                   "(src/repro/models/ffn.py:69-71, :112-119; port models/ffn.py::moe), no routed GEMM",
}


def graph_vs_executed(cfg, graph, calls, batch):
    """Each node of ``graph`` (the mapper's batch-free lowering of ``cfg``)
    against the routed GEMMs ``calls`` one forward of ``batch`` sequences
    made (``recorded_gemm_calls``): a node needs exactly one GEMM of its
    layer and site with equal K, C and rows x batch, and every GEMM a node.
    Returns ``(ok, report)``: ``report`` holds the matched count, each
    difference of ``GRAPH_DIFFERENCES`` with its nodes, and the unexplained
    ones (``ok`` when there are none)."""
    executed = {}
    for c in calls:
        name = c["site"] if c["layer"] is None else f"L{c['layer']}.{c['site']}"
        executed.setdefault(name, []).append((c["K"], c["C"], c["rows"]))
    swiglu = 2 if cfg.ffn_act == "swiglu" else 1
    first_block = bool(cfg.mla and cfg.num_experts)
    report = {"matched": 0, "unexplained": [], **{kind: [] for kind in GRAPH_DIFFERENCES}}
    for node in graph.nodes:
        want = (node.k, node.cols, node.rows * batch)
        got = executed.get(node.name)
        layer, _, site = node.name.partition(".")
        entry = dict(node=node.name, graph=list(want), executed=got)
        if got == [want]:
            report["matched"] += 1
        elif node.name == "lm_head" and cfg.tie_embeddings and got is None:
            report["tied_head"].append(entry)
        elif first_block and layer == "L0" and (
            (site == "ffn.wi" and got == [(cfg.d_model, swiglu * cfg.d_ff, node.rows // cfg.num_experts_per_tok * batch)])
            or (site == "ffn.wo" and got == [(cfg.d_ff, cfg.d_model, node.rows // cfg.num_experts_per_tok * batch)])
            or (site.startswith("ffn.shared.") and got is None)
        ):
            report["first_block"].append(entry)
        elif cfg.num_experts and site in ("ffn.wi", "ffn.wo") and got is None:
            report["expert_rows"].append(entry)
        else:
            report["unexplained"].append(entry)
    names = {node.name for node in graph.nodes}
    for name, got in executed.items():
        if name not in names:
            report["unexplained"].append(dict(node=name, graph=None, executed=got))
    return not report["unexplained"], report


def ops_rows(torch, K, chans, gen, rows_out, card):
    """The ``ops`` surface on the card: ``photonic_gemm`` (f32 x and w, the
    fused kernel) and ``photonic_gemm_int`` (int8, the unfused kernel) at
    qwen2-0.5b's six sites, R = 64, on the ideal channel and on SMWA
    (``noise_seed=0``), plus ``photonic_gemm_int(tile_c=256)`` at ``attn.wq``
    under SMWA (the legacy tiling, whose noise stream ids differ).  The
    calls run once with the launch counts reset just before and read just
    after (the main path's count: each call one launch); then each output
    is held bitwise to the same call with the engine's kernel swapped for
    its twin on the card, and each call is timed (CUDA graph of the whole
    ``ops`` call: quantization, seeds, padding, the kernel), its twin path
    host-timed.  Bounds: x, w read once, the output written once, the
    int8 ops of every pass and the Box-Muller draws (``bound_ms``).
    Library: ``torch._int_mm`` where it computes the same function (the
    ideal ``photonic_gemm_int``), else None.  Returns (ok, launches)."""
    import repro_torch.photonic.engine as E
    from repro_torch.kernels.photonic_gemm import ops

    r = 64
    cases = [(fn, name, site, k, c, 128) for fn in ("photonic_gemm", "photonic_gemm_int")
             for name in ("ideal", "SMWA") for site, k, c, _ in SITES]
    cases.append(("photonic_gemm_int", "SMWA", SITES[0][0], SITES[0][1], SITES[0][2], 256))
    dev = torch.device("cuda")
    args = []
    for fn, name, site, k, c, tile_c in cases:
        if fn == "photonic_gemm":
            x = torch.randn((r, k), generator=gen, device=dev)
            w = torch.randn((k, c), generator=gen, device=dev) * k**-0.5
            call = (lambda x=x, w=w, d=chans[name]: ops.photonic_gemm(x, w, d))
        else:
            x = torch.randint(-127, 128, (r, k), generator=gen, device=dev, dtype=torch.int8)
            w = torch.randint(-127, 128, (k, c), generator=gen, device=dev, dtype=torch.int8)
            call = (lambda x=x, w=w, d=chans[name], t=tile_c: ops.photonic_gemm_int(x, w, d, tile_c=t))
        args.append((x, w, call))
    torch.cuda.synchronize()
    K.reset_launches()
    outs = [call() for _, _, call in args]
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    want = {"photonic_gemm_fused": 12, "photonic_gemm": 13}
    ok = launches == want
    log(f"  ops main path: {len(cases)} calls, launches {launches} == {want}: {ok}")

    kernel_fused, kernel_int = E.photonic_gemm_fused, E.photonic_gemm

    def twin_fused(*a, rows=None, **kw):
        return K.photonic_gemm_fused_twin(*a, **kw)

    def twin_int(*a, rows=None, **kw):
        return K.photonic_gemm_twin(*a, **kw)

    for (fn, name, site, k, c, tile_c), (x, w, call), y in zip(cases, args, outs):
        try:
            E.photonic_gemm_fused, E.photonic_gemm = twin_fused, twin_int
            y_t = call()
            torch.cuda.synchronize()
            t_ms = eager_ms(call)
        finally:
            E.photonic_gemm_fused, E.photonic_gemm = kernel_fused, kernel_int
        err = float((y.to(torch.float64) - y_t.to(torch.float64)).abs().max())
        good = err == 0.0 and bool(torch.isfinite(y.to(torch.float32)).all())
        k_ms = graph_ms(call)
        dpu = chans[name]
        stages, _ = E.kernel_stages(dpu, r, k, c, tile_c=tile_c)
        passes, xdots = passes_of(dpu, stages)
        noisy = stages["noise_sigma"] > 0.0
        draws = r * c * -(-k // stages["n_chunk"]) * passes if noisy else 0
        fused = fn == "photonic_gemm"
        parts = bound_ms(r, k, c, 4 if fused else 1, passes, xdots, False, False, draws)
        if fused:  # f32 weights, read once (bound_ms counts int8 ones)
            parts = (parts[0] + k * c * 3 / PEAK_BYTES_PER_S * 1e3,) + parts[1:]
        b_ms, b_by = bound_of([parts])
        lib_ms = None
        if not fused and name == "ideal":
            lib_ms = graph_ms(lambda x=x, w=w: torch._int_mm(x, w))
        rows_out.append(dict(
            fn=fn, site=site, channel=name, tile_c=tile_c, R_live=r, K=k, C=c, ms=k_ms, plain_ms=t_ms,
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, parts=parts, draws=draws, max_abs_err=err,
            tolerance="bitwise" + (", noise included" if noisy else ""), ok=good,
        ))
        log(f"  ops.{fn:17s} {site:7s} R={r} K={k:4d} C={c:5d} {name:5s} tile_c={tile_c}: whole call {k_ms:.4f} ms "
            f"(CUDA graph), twin path {t_ms:.3f} ms, _int_mm {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
            f"bound {b_ms:.5f} ms ({b_by}), max_abs_err {err:.3g} [bitwise] -> {'ok' if good else 'MISMATCH'} "
            f"[{card}]")
        ok &= good
    return ok, launches


def analytic_phase(torch, K, chans, gen, ops_out, lm_records, card):
    """The analytic tier and the ``ops`` surface (module docstring, phase
    8): (a) ``ops_rows``; (b) the port's Fig. 7 grid against
    ``FIG7_DIGEST``, with FPS, FPS/W and FPS/W/mm^2 per cell and SMWA's
    ratios to ASMW and MASW averaged over the CNNs (the simulator's outputs,
    not measurements of the card); (c) the mapper on the LM configs the
    card serves, each graph mapped onto ``DpuPool.area_matched(org, 5)``
    for SMWA, ASMW and MASW with ``MapperOptions(batch=2)``: simulated
    tokens/s, FPS/W and mean utilization, and the host seconds of the
    mapping on this machine; (d) ``graph_vs_executed`` against the routed
    GEMMs recorded in the oneshot and moe phases' ``lm_logits``.  Returns
    (ok, result dict, launches of the ops main path)."""
    from repro_torch.core.simulator import evaluate_all
    from repro_torch.mapper import DpuPool, MapperOptions, WorkloadGraph, map_workload
    from repro_torch.models import registry

    res = {}
    ok, launches = ops_rows(torch, K, chans, gen, ops_out, card)

    t0 = time.perf_counter()
    grid = evaluate_all()
    host_s = time.perf_counter() - t0
    digest = fig7_digest(grid)
    good = digest == FIG7_DIGEST and len(grid) == 36
    log(f"  Fig. 7 grid (simulator outputs, not card measurements): evaluate_all() over 3 orgs x DR (1, 5, 10) x 4 "
        f"CNNs, {len(grid)} cells in {host_s:.3f} s of host time; digest {digest[:16]}... == the reference's "
        f"{FIG7_DIGEST[:16]}...: {good}")
    ok &= good
    cells = {}
    for (org, dr, model), r in grid.items():
        cells[f"{org} {dr} {model}"] = dict(fps=r.fps, fps_per_w=r.fps_per_w, fps_per_w_per_mm2=r.fps_per_w_per_mm2())
        log(f"    simulated {org} DR={dr:2d} {model:13s}: FPS {r.fps:.6g}, FPS/W {r.fps_per_w:.6g}, "
            f"FPS/W/mm^2 {r.fps_per_w_per_mm2():.6g}")
    models = sorted({m for _, _, m in grid})
    ratios = {}
    for dr in (1, 5, 10):
        for other in ("ASMW", "MASW"):
            vals = {}
            for metric in ("fps", "fps_per_w", "fps_per_w_per_mm2"):
                per = [cells[f"SMWA {dr} {m}"][metric] / cells[f"{other} {dr} {m}"][metric] for m in models]
                vals[metric], vals[metric + "_max"] = statistics.mean(per), max(per)
            ratios[f"SMWA/{other} DR={dr}"] = vals
            log(f"    simulated SMWA over {other} at DR={dr}, mean (max) over the 4 CNNs: FPS {vals['fps']:.4f}x "
                f"({vals['fps_max']:.4f}x), FPS/W {vals['fps_per_w']:.4f}x ({vals['fps_per_w_max']:.4f}x), "
                f"FPS/W/mm^2 {vals['fps_per_w_per_mm2']:.4f}x ({vals['fps_per_w_per_mm2_max']:.4f}x)")
    res["fig7"] = dict(digest=digest, host_s=host_s, cells=cells, ratios=ratios)

    res["mapper"], res["graph_vs_executed"] = {}, {}
    for arch_name, (seq_len, batch) in LM_GRAPHS.items():
        cfg = registry.get(arch_name).config
        t0 = time.perf_counter()
        graph = WorkloadGraph.from_model_config(cfg, seq_len=seq_len)
        build_s = time.perf_counter() - t0
        for org in ("SMWA", "ASMW", "MASW"):
            t0 = time.perf_counter()
            pool = DpuPool.area_matched(org, 5)
            tl = map_workload(graph, pool, MapperOptions(batch=2))
            map_s = time.perf_counter() - t0
            row = dict(nodes=len(graph), pool=pool.size, n=pool.cfg.n, tokens_per_s=tl.fps * seq_len,
                       fps=tl.fps, fps_per_w=tl.fps_per_w, mean_utilization=tl.mean_utilization,
                       host_s=map_s, graph_host_s=build_s)
            res["mapper"][f"{arch_name} {org}"] = row
            log(f"  mapper (simulated, not the card): {arch_name} seq_len {seq_len}, {len(graph)} nodes, "
                f"{graph.total_macs / 1e9:.2f} GMAC a sequence, on {pool.size} x {org} N={pool.cfg.n} at 5 GS/s, "
                f"batch 2: {row['tokens_per_s']:.6g} simulated tokens/s, FPS/W {tl.fps_per_w:.6g}, mean "
                f"utilization {tl.mean_utilization:.4f}; host {map_s:.3f} s to map ({build_s:.3f} s to build the "
                f"graph) [{card}]")
        good, report = graph_vs_executed(cfg, graph, lm_records[arch_name], batch)
        res["graph_vs_executed"][arch_name] = report
        log(f"  graph vs executed, {arch_name} (lm_logits B={batch} T={seq_len}, {len(lm_records[arch_name])} routed "
            f"GEMMs recorded): {report['matched']} of {len(graph)} nodes equal in K, C and rows x batch")
        for kind, text in GRAPH_DIFFERENCES.items():
            if report[kind]:
                log(f"    difference {kind}: {len(report[kind])} nodes; {text}")
                for e in report[kind][:4]:
                    log(f"      {e['node']}: graph (K, C, rows x batch) {tuple(e['graph'])}, executed {e['executed']}")
        if cfg.num_experts:
            cap = max(int(seq_len * cfg.num_experts_per_tok * cfg.capacity_factor / cfg.num_experts), 1)
            layers = len(report["expert_rows"]) // 2
            log(f"    expert_rows in numbers: the graph streams t x top_k = {seq_len} x {cfg.num_experts_per_tok} = "
                f"{seq_len * cfg.num_experts_per_tok} rows a sequence through each routed bank of {layers} layers; "
                f"the model dispatches E x capacity = {cfg.num_experts} x {cap} = {cfg.num_experts * cap} slots a "
                f"batch row (capacity factor {cfg.capacity_factor}), digitally")
        for e in report["unexplained"]:
            log(f"    UNEXPLAINED {e['node']}: graph {e['graph']}, executed {e['executed']}")
        log(f"  graph vs executed {arch_name}: only the named differences: {good}")
        ok &= good
    return ok, res, launches


def recurrent_phase(torch, registry, card):
    """The recurrent families whole at full width (module docstring, phase
    6f, after its kernel rows and flash case).  Returns (ok, result, fused
    launches, flash launches)."""
    from repro_torch._tree import tree_leaves
    from repro_torch.kernels.flash_attention import kernel as F
    from repro_torch.kernels.photonic_gemm import kernel as K
    from repro_torch.models import xlstm, zamba2
    from repro_torch.models.common import init_params
    from repro_torch.serving import prepack_serving_params

    ok, res, fused_total, flash_total = True, {}, 0, 0
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    rng = np.random.default_rng(0)
    models = (("xlstm-350m", xlstm.xlstm_logits, XLSTM_LAUNCHES), ("zamba2-2.7b", zamba2.zamba2_logits, ZAMBA_LAUNCHES))
    for name, logits_fn, launches in models:
        fused_before, flash_before = fused_total, flash_total
        arch = registry.get(name)
        cfg = arch.config
        t0 = time.perf_counter()
        params = init_params(cfg, 0, device="cuda")
        if name == "xlstm-350m":
            # The gates init to zero: every gate GEMM would return zeros, and
            # a broken C = 4 path would agree with itself.  Fan-in normals.
            for p in (p for group in params["mlstm"] for p in group):
                for gate in ("wi", "wf"):
                    w = p[gate]["w"]
                    w.copy_(torch.randn(w.shape, generator=g, device="cuda") * w.shape[0] ** -0.5)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in tree_leaves(params))
        log(f"  init_params ({name} full width, all {cfg.num_layers} layers, bf16, {n_params / 1e9:.3f} B "
            f"parameters) {time.perf_counter() - t0:.2f} s" + ("; mLSTM gates wi / wf set to fan-in normals"
                                                                  if name == "xlstm-350m" else ""))
        out = {"n_params": n_params}
        tokens = torch.randint(0, cfg.vocab_size, (1, 600), generator=g, device="cuda")
        logits = {}
        torch.cuda.reset_peak_memory_stats()
        for backend in ("kernel", "ref"):
            run = dataclasses.replace(cfg, photonic=ideal_dpu(), photonic_backend=backend)
            # (label, attn_impl, attn_chunk, groups): zamba2 on the kernel
            # also runs flash and the witness, whole and cut to its first
            # group (6 Mamba2 layers and one shared-attention invocation).
            impls = [("chunked", "chunked", cfg.attn_chunk, None)]
            if backend == "kernel" and name == "zamba2-2.7b":
                impls += [("flash", "flash", cfg.attn_chunk, None), ("chunked_128", "chunked", 128, None),
                          ("chunked_1group", "chunked", cfg.attn_chunk, 1), ("flash_1group", "flash", cfg.attn_chunk, 1),
                          ("chunked_128_1group", "chunked", 128, 1)]
            with torch.no_grad():
                _, packed = prepack_serving_params(arch, run, params)
                for label, impl, chunk, groups in impls:
                    p_, c_, want = packed, run, launches if backend == "kernel" else 0
                    if groups is not None:
                        p_ = {**packed, "mamba": packed["mamba"][:groups]}
                        c_ = dataclasses.replace(run, num_layers=groups * cfg.attn_every)
                        want = groups * (2 * cfg.attn_every + 6) + 1
                    K.reset_launches()
                    F.reset_launches()
                    record = label == "flash"  # each shared invocation's flash call, for the bound below
                    with recorded_flash_calls() if record else contextlib.nullcontext([]) as calls:
                        t0 = time.perf_counter()
                        y, _ = logits_fn(p_, tokens, dataclasses.replace(c_, attn_impl=impl, attn_chunk=chunk))
                        torch.cuda.synchronize()
                        secs = time.perf_counter() - t0
                    if record:
                        good, out["flash_invocations"] = flash_calls_within_bound(torch, calls, name, card)
                        ok &= good
                        del calls
                    logits[backend, label] = y.float()
                    want_flash = (groups or 9) if impl == "flash" else 0
                    n, nf = K.LAUNCHES["photonic_gemm_fused"], F.LAUNCHES["flash_attention"]
                    good = n == want and nf == want_flash and bool(torch.isfinite(y).all())
                    fused_total += n
                    flash_total += nf
                    log(f"  {name} logits {backend}, attn_impl={impl} attn_chunk={chunk}, "
                        f"{'all' if groups is None else groups} group(s) (B=1, T=600: the chunk path padded to "
                        f"768): {secs:.3f} s, fused launches {n} == {want}, flash {nf} == {want_flash}, "
                        f"finite: {good} [{card}]")
                    out[f"logits_{backend}_{label}_s"] = secs
                    ok &= good
                del packed
            torch.cuda.empty_cache()
        out["logits_peak_bytes"] = torch.cuda.max_memory_allocated()
        log(f"  {name} peak memory over init, both prepacks and the logits runs (max_memory_allocated) "
            f"{out['logits_peak_bytes'] / 2**30:.2f} GiB [{card}]")
        good, out["logits"] = floor_gate(logits["kernel", "chunked"], logits["ref", "chunked"],
                                         f"{name} logits kernel vs ref")
        ok &= good
        if name == "zamba2-2.7b":
            # Flash against chunked under the oneshot phase's gate (as
            # whisper's), whole and at the first group alone: the witness
            # (chunked at flash's key block against chunked) measures how
            # far each depth carries a rounding difference of the core.
            for depth in ("", "_1group"):
                _, witness = floor_gate(logits["kernel", "chunked_128" + depth], logits["kernel", "chunked" + depth],
                                        f"{name}{depth} logits witness: chunked at 128 vs chunked (sets the flash gate)")
                max_rel = max(2e-2, 2 * witness["rel_err"])
                min_agree = 1.0 - max(0.01, 2 * (1.0 - witness["argmax_agreement"]))
                _, cmp_ = floor_gate(logits["kernel", "flash" + depth], logits["kernel", "chunked" + depth],
                                     f"{name}{depth} logits flash (hd 80 padded to 128) vs chunked (not gated by "
                                     f"the plain floor)")
                good = cmp_["rel_err"] <= max_rel and cmp_["argmax_agreement"] >= min_agree
                log(f"  {name}{depth} flash vs chunked, gate <= {max_rel:.4g} and >= {min_agree:.4f}: {good} [{card}]")
                out["flash_vs_chunked" + depth] = dict(cmp_, witness=witness, max_rel_err=max_rel,
                                                       min_argmax_agreement=min_agree)
                ok &= good
        del logits
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (16, 40, 64, 24)]
        runs = {}
        for label, backend, dpu, steps in (("greedy", "kernel", ideal_dpu(), 8), ("greedy_ref", "ref", ideal_dpu(), 8),
                                           ("smwa", "kernel", smwa_dpu(), 5)):
            reqs, lc, st, good = legacy_moe_serve(
                torch, arch, params, dpu, backend, prompts, card, f"{name} {label}",
                per_forward=launches, new_tokens=steps)
            ok &= good
            fused_total += lc["photonic_gemm_fused"]
            runs[label] = (reqs, st)
            torch.cuda.empty_cache()
        eq = all(x.output == y.output for x, y in zip(runs["greedy"][0], runs["greedy_ref"][0]))
        log(f"  {name} greedy tokens (4 prompts x 8 tokens), kernel == ref: {eq}")
        for x, y in zip(runs["greedy"][0], runs["greedy_ref"][0]):
            log(f"    uid {x.uid}: kernel {x.output} ref {y.output}")
        for r in runs["smwa"][0]:
            log(f"    smwa (noise_seed=0, 4 decode steps) uid {r.uid}: {r.output}")
        ok &= eq
        out.update(serve={k: v[1] for k, v in runs.items()}, fused_launches=fused_total - fused_before,
                   flash_launches=flash_total - flash_before)
        res[name] = out
        del params, runs
        torch.cuda.empty_cache()
    return ok, res, fused_total, flash_total


# The tooling phase's dry-run cells: (arch, shape, flags).  xlstm-350m runs
# its decode step: its prefill at 32,768 tokens steps the sLSTM once a token
# eagerly, ~7.5 million fake ops, far past the phase's two minutes.
DRY_CELLS = [
    ("qwen2-0.5b", "decode_32k", ()),
    ("qwen2-0.5b", "train_4k", ("--photonic", "--dp-shardmap")),
    ("xlstm-350m", "decode_32k", ()),
    ("qwen2-0.5b", "train_4k", ()),
    ("phi3.5-moe-42b-a6.6b", "decode_32k", ()),
    ("deepseek-v2-lite-16b", "decode_32k", ()),
    ("zamba2-2.7b", "decode_32k", ()),
    ("llama-3.2-vision-90b", "decode_32k", ()),
    ("qwen2-0.5b", "long_500k", ()),
]
TOOLING_ROWS = 4  # the tooling phase's paged server: four decode rows


def start_dry_runs():
    """Each of :data:`DRY_CELLS` in a subprocess (``python -m
    repro_torch.launch.dryrun ... --device cuda``, fake CUDA tensors on a
    fake 256-rank group) under the launch profile's ``child_env``, all
    started together.  Returns [(cell, process, out dir)]."""
    from repro_torch.launch import profile as launch_profile

    out = ROOT / "chiprun_out" / "dryrun"
    out.mkdir(parents=True, exist_ok=True)
    env = launch_profile.child_env()
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT / "src"), env.get("PYTHONPATH")]))
    procs = []
    for arch, shape, flags in DRY_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape, "--mesh",
               "single", "--device", "cuda", "--out", str(out), "--force", *flags]
        procs.append(((arch, shape, flags), subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                                                             stderr=subprocess.PIPE, text=True), out))
    return procs


def finish_dry_runs(procs, card, timeout):
    """Wait for :func:`start_dry_runs`' cells and log each one's bytes,
    FLOPs, collectives and whether its peak fits one 80 GB rank.  Gates:
    each cell exits 0 with ``ok`` (its ladder identity exact).  Returns
    (ok, cells)."""
    from repro_torch.launch.dryrun import _cell_path

    ok, cells = True, []
    deadline = time.perf_counter() + timeout
    for (arch, shape, flags), proc, out in procs:
        try:
            _, err = proc.communicate(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
            log(f"  dry run {arch} x {shape}: killed after {timeout} s")
        variant = "photonic" if "--photonic" in flags else "base"
        path = _cell_path(out, arch, shape, "single", variant)
        cell = json.loads(path.read_text()) if path.exists() else {"ok": False, "error": (err or "")[-2000:]}
        good = proc.returncode == 0 and cell.get("ok") is True
        ok &= good
        cell["flags"] = list(flags)
        cells.append(cell)
        if "flops_per_device" not in cell:
            log(f"  dry run {arch} x {shape} x single {' '.join(flags)}: FAILED (exit {proc.returncode}): "
                f"{cell.get('error', '')[-1500:]}")
            continue
        coll = {k: v for k, v in cell.items() if k.startswith(("bytes_", "count_"))}
        log(f"  dry run {arch} x {shape} x single {' '.join(flags)} (fake cuda, world {cell['world']}): trace "
            f"{cell['trace_s']} s; arguments {cell['argument_size_in_bytes'] / 1e9:.3f} GB, temp "
            f"{cell['temp_size_in_bytes'] / 1e9:.3f} GB, peak {cell['peak_size_in_bytes'] / 1e9:.3f} GB a rank "
            f"(fits 80 GB: {cell['fits_device']}), output {cell['output_size_in_bytes'] / 1e9:.3f} GB; "
            f"{cell['flops_per_device']} FLOPs a rank (ladder {cell['flops_per_device_exact']}, exact "
            f"{cell['ladder_identity_holds']}); GEMM traffic {cell['matmul_traffic_bytes'] / 1e9:.3f} GB; "
            f"collectives {coll}; wire {cell['total_wire_bytes'] / 1e9:.3f} GB; fallbacks "
            f"{len(cell['sharding_fallbacks'])}: {good}")
    return ok, cells


def fake_vs_real(torch, registry, card):
    """Phase 9 (f): the dry run's accounting (``dryrun.account``) on phase 7
    (a)'s qwen2-0.5b training step (4 x 1024 tokens, TP = 1, ideal channel)
    run for real on the card and under fake CUDA tensors.  Both sides use
    the ``ref`` backend: a fake tensor cannot reach the ctypes kernel, and
    ``FlopCounterMode`` does not see inside it.  Gates: FLOPs, argument
    bytes and GEMM traffic equal exactly, and the same aten op stream (the
    ops in order with their shapes and dtypes, ``aten_op_stream_sha256``);
    a count of each op that differs is printed.  The fake peak (arguments + temp) against the real
    ``max_memory_allocated`` over what was allocated before is printed, not
    gated.  Returns (ok, result)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.data.pipeline import SyntheticTokens, make_global_batch
    from repro_torch.launch import dryrun
    from repro_torch.models.common import init_params
    from repro_torch.models.registry import ShapeSpec
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import build_train_step

    arch = registry.get("qwen2-0.5b")
    cfg = dataclasses.replace(arch.config, photonic=ideal_dpu(), photonic_backend="ref")
    data, opt = _train_inputs(arch)
    step = build_train_step(lambda p, b: arch.loss(p, b, cfg), opt)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, "cuda", defs=arch.param_defs(cfg))
    args = (params, adamw.init(params), make_global_batch(SyntheticTokens(data), 0, "cuda"))
    t0 = time.perf_counter()
    real = dryrun.account(step, args)
    torch.cuda.synchronize()
    real["wall_s"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    del params, args
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        fp = dryrun.fake_params(arch.param_defs(cfg), cfg, "cuda")
        shape = ShapeSpec("phase7", data.seq_len, data.global_batch, "train")
        fake = dryrun.account(step, (fp, adamw.init(fp), dryrun.materialize(arch.train_batch_spec(cfg, shape)[0],
                                                                           "cuda")))
    fake["wall_s"] = time.perf_counter() - t0
    same = {k: fake[k] == real[k] for k in ("flops_per_device", "argument_size_in_bytes", "matmul_traffic_bytes",
                                             "aten_op_stream_sha256")}
    ok = all(same.values())
    counts = {k: (real["aten_op_counts"].get(k, 0), fake["aten_op_counts"].get(k, 0))
              for k in set(real["aten_op_counts"]) | set(fake["aten_op_counts"])}
    differ = {k: v for k, v in counts.items() if v[0] != v[1]}
    ratio = fake["peak_size_in_bytes"] / peak
    log(f"  (f) phase 7 (a)'s training step (ref backend), real on the card: {real['flops_per_device']} FLOPs, "
        f"arguments {real['argument_size_in_bytes']} B, GEMM traffic {real['matmul_traffic_bytes']} B, "
        f"{real['aten_ops']} aten ops, {real['wall_s']:.2f} s; fake: {fake['flops_per_device']} FLOPs, arguments "
        f"{fake['argument_size_in_bytes']} B, GEMM traffic {fake['matmul_traffic_bytes']} B, {fake['aten_ops']} "
        f"aten ops, {fake['wall_s']:.2f} s; equal: {same}; ops whose counts differ (real, fake): "
        f"{differ or 'none'}: {ok}")
    log(f"  (f) peak: fake arguments + temp {fake['peak_size_in_bytes'] / 2**30:.3f} GiB against the real "
        f"max_memory_allocated {peak / 2**30:.3f} GiB over what was allocated before: ratio {ratio:.4f} "
        f"(not gated) [{card}]")
    return ok, dict(real=real, fake=fake, equal=same, counts_differ=differ, real_peak_bytes=peak, peak_ratio=ratio)


def tooling_phase(torch, registry, card):
    """Phase 9: the tooling tier on the card (module docstring).  Returns
    (ok, result, fused launches)."""
    from repro_torch.analysis.contracts import ContractViolation, min_weight_size
    from repro_torch.kernels.photonic_gemm import kernel as K
    from repro_torch.models.common import init_params
    from repro_torch.serving import Request, Scheduler, ServingConfig

    ok, res = True, {}
    arch = registry.get("qwen2-0.5b")
    n_layers = arch.config.num_layers
    cfg = dataclasses.replace(arch.config, photonic=ideal_dpu(), photonic_backend="kernel")
    params = init_params(arch.config, 0, device="cuda")
    sch = Scheduler(arch, cfg, params, ServingConfig(batch_size=TOOLING_ROWS, max_seq=128, block_size=16,
                                                     chunk_tokens=64))
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, arch.config.vocab_size, n).astype(np.int32), max_new_tokens=16)
            for i, n in enumerate((16, 40, 64, 24))]
    for r in reqs:
        sch.submit(r)
    while not all(r.output for r in reqs):
        sch.step()
    torch.cuda.synchronize()
    K.reset_launches()
    min_w = min_weight_size(arch.param_defs(cfg))
    # (b) the weight-stationary contract on the live prepacked decode step
    checker = sch.decode_checker()
    torch.cuda.synchronize()
    try:
        checker.assert_zero_weight_rounds(min_w)
        zero = True
    except ContractViolation as e:
        log(f"  (b) {e}")
        zero = False
    launches = checker.launches["photonic_gemm_fused"]
    traffic = checker.matmul_traffic_bytes()
    # (d) one decode step of the same server under the profiler
    summary = profiled(torch, sch.step, "tooling_decode")
    d_ok = summary["photonic_launches"] == 6 * n_layers and summary["flash_launches"] == 0
    # (b) without prepacking, the same step quantizes every weight
    packed = sch.params
    sch.params = params
    rounds = sch.decode_checker().weight_round_ops(min_w)
    sch.params = packed
    torch.cuda.synchronize()
    b_ok = zero and launches == 6 * n_layers and rounds > 0
    busy = summary["device_busy_ms"]
    log(f"  (b) decode_checker on qwen2-0.5b's paged decode step (4 rows, prepacked, kernel backend): "
        f"assert_zero_weight_rounds({min_w}) {'held' if zero else 'FAILED'}; fused launches {launches} == "
        f"{6 * n_layers}; GEMM traffic {traffic} B against the step's device time {busy:.3f} ms (torch "
        f"profiler, (d)): {traffic / (busy * 1e-3) / 1e9 if busy else float('nan'):.1f} GB/s; without "
        f"prepacking {rounds} weight rounds > 0: {b_ok} [{card}]")
    share = "not measured" if summary["busy_share"] is None else f"{summary['busy_share']:.1%}"
    log(f"  (d) dispatch_summary of one decode step: {summary['launch_calls']} cudaLaunchKernel calls, "
        f"{summary['device_events']} device events, busy {busy:.3f} of {summary['wall_ms']:.3f} ms "
        f"({share}), photonic "
        f"launches {summary['photonic_launches']} == {6 * n_layers} (the serve phase's 6 x 24 a forward), "
        f"flash {summary['flash_launches']} == 0 (chunked attention): {d_ok} [{card}]")
    ok &= b_ok and d_ok
    res["decode"] = dict(zero_weight_rounds=zero, fused_launches=launches, matmul_traffic_bytes=traffic,
                         unpacked_weight_rounds=rounds, dispatch=summary)
    fused = K.LAUNCHES["photonic_gemm_fused"]  # (b) twice and (d): 3 x 144
    del sch, params, packed
    torch.cuda.empty_cache()
    # (e) the dry-run cells, started after the profiled decode step so that
    # its host time shares the CPU with none of them; they run beside (f),
    # the dry run's accounting against a real step
    cells = start_dry_runs()
    f_ok, res["fake_vs_real"] = fake_vs_real(torch, registry, card)
    ok &= f_ok
    e_ok, res["dry_runs"] = finish_dry_runs(cells, card, timeout=240)
    ok &= e_ok
    return ok, res, fused


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--phase"] and sys.argv[2:] in (["train"], ["train-families"], ["placement"]):
        return child(sys.argv[2])
    if sys.argv[1:3] in (["--phase", "tp"], ["--phase", "tp-train"], ["--phase", "gloo-repro"]) and len(sys.argv) == 4:
        return child(sys.argv[2], sys.argv[3])
    setup(torch)
    from repro_torch.launch import profile as launch_profile

    profile_desc = launch_profile.apply()
    from repro_torch.kernels.flash_attention import kernel as F
    from repro_torch.kernels.photonic_gemm import kernel as K
    from repro_torch.models import registry
    from repro_torch.models.common import init_params

    card = card_line()
    all_ok = True
    with Phase("device"):
        log(f"  card: {card}")
        log(f"  launch profile (repro_torch.launch.profile.apply): {json.dumps(profile_desc)}")
        log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"device {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
        log(f"  CUBLAS_WORKSPACE_CONFIG in this process: {os.environ.get('CUBLAS_WORKSPACE_CONFIG')!r}")
        variants, shipped_terms = p_term_libraries()
        build_kernels([K.LIBRARY, F.LIBRARY, *variants.values()])
        from repro_torch.kernels._build import NVCC_FLAGS

        DRAW["instructions"] = draw_instructions(NVCC_FLAGS)
        DRAW["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
        DRAW["clock_hz"] = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60).stdout.split()[0]) * 1e6
        log(f"  Box-Muller draw: {DRAW['instructions']} SASS instructions; {DRAW['sms']} SMs x {LANES} lanes "
            f"at {DRAW['clock_hz'] / 1e6:.0f} MHz (max SM clock)")

    with Phase("keys"):
        keys_ok, keys_res = keys_phase(torch, card)
        all_ok &= keys_ok

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    sliced_rows = []
    with Phase("kernels"):
        chans = {name: dpu_for(name) for name in ("ideal", "SMWA", "ASMW")}
        for name, dpu in chans.items():
            for r in (4, 64):
                for site, k, c, b in SITES:
                    all_ok &= kernel_case(torch, K, dpu, r, k, c, b, False, None, gen, rows)
        # The lm_logits shape: B=2 x T=1000 rows.
        for site, k, c, b in SITES:
            all_ok &= kernel_case(torch, K, chans["ideal"], 2000, k, c, b, False, None, gen, rows)
        all_ok &= kernel_case(torch, K, chans["SMWA"], 2000, *SITES[0][1:], False, None, gen, rows)
        # The training shape: B=4 x T=1024 rows; the engine's forward of the
        # site also quantizes and pads the float weight, as every step does.
        for name, sites in (("ideal", SITES), ("SMWA", SITES[:1])):
            for site, k, c, b in sites:
                all_ok &= kernel_case(torch, K, chans[name], TRAIN_ROWS, k, c, b, False, None, gen, rows)
                rows[-1]["engine_ms"] = engine_forward_ms(torch, chans[name], TRAIN_ROWS, k, c, b, site, gen)
                log(f"    engine matmul_float {site} (bf16 x and w, weight quantized per call): "
                    f"{rows[-1]['engine_ms']:.4f} ms host-timed [{card}]")
        # f32 prologue with bias + gelu / silu, and without the tail
        for name in ("ideal", "SMWA"):
            for act, b in ((None, False), ("gelu", True), ("silu", True)):
                all_ok &= kernel_case(torch, K, chans[name], 64, 896, 896, b, True, act, gen, rows)
        int_rows = []
        for name in ("ideal", "SMWA", "ASMW"):
            for site, k, c, b in SITES:
                res = int_case(torch, K, chans[name], 64, k, c, gen)
                all_ok &= res[0]
                int_rows.append((name, k, c) + res)
        for name in chans:
            for r in (4, 64, 2000, TRAIN_ROWS):
                layer = [x for x in rows if x["channel"] == name and x["R_live"] == r and x["x"] == "int8"
                         and x["model"] == "qwen2-0.5b"]
                if len(layer) != len(SITES):
                    continue
                bm, bb = bound_of([x["parts"] for x in layer])
                lib = layer_sum(layer, "library_ms")
                log(f"  layer sum {name} R={r}: kernel {sum(x['ms'] for x in layer):.4f} ms, "
                    f"twin {sum(x['plain_ms'] for x in layer):.3f} ms, bound {bm:.5f} ms ({bb}), _int_mm "
                    f"{'n/a' if lib is None else f'{lib:.4f} ms'}"
                    + (f", engine forward {layer_sum(layer, 'engine_ms'):.4f} ms" if "engine_ms" in layer[0] else "")
                    + f" [{card}]")
        # Bit-sliced GEMMs: the six sites at 2-bit planes (the sliced serve
        # path's shapes), and attn.wq at the other plane widths.
        for name, dpu in chans.items():
            for r in (4, 64):
                for site, k, c, b in SITES:
                    all_ok &= sliced_case(torch, K, dpu, r, k, c, 2, site, gen, sliced_rows, card)
            for p in (1, 4, 8):
                all_ok &= sliced_case(torch, K, dpu, 64, *SITES[0][1:3], p, SITES[0][0], gen, sliced_rows, card)
        for name in chans:
            for r in (4, 64):
                layer = [x for x in sliced_rows if x["channel"] == name and x["R_live"] == r and x["plane_bits"] == 2]
                bm, bb = bound_of([x["parts"] for x in layer])
                lib = layer_sum(layer, "library_ms")
                log(f"  sliced layer sum {name} R={r} p=2 (16 passes a site): kernel "
                    f"{sum(x['ms'] for x in layer):.4f} ms, engine {sum(x['engine_ms'] for x in layer):.4f} ms, "
                    f"twin passes {sum(x['plain_ms'] for x in layer):.3f} ms, bound {bm:.5f} ms ({bb}), _int_mm "
                    f"{'n/a' if lib is None else f'{lib:.4f} ms'} [{card}]")
        wq = next(x for x in sliced_rows if x["channel"] == "SMWA" and x["R_live"] == 64
                  and x["plane_bits"] == 2 and x["site"] == "attn.wq")
        quieter = wq["mean_abs_err_to_exact"] < wq["unsliced_mean_abs_err_to_exact"]
        log(f"  SMWA attn.wq R=64: mean |y - exact| sliced p=2 {wq['mean_abs_err_to_exact']:.2f} < unsliced "
            f"{wq['unsliced_mean_abs_err_to_exact']:.2f}: {quieter}")
        all_ok &= quieter
        # The new dense configs' shapes: granite-3-8b's six sites and
        # deepseek-67b's MLP down projection and LM head, at decode and a
        # prefill chunk, ideal and SMWA (seeded through a prng key), each
        # held to its twin bitwise; one sliced SMWA row under a key.
        from repro_torch import prng

        key = prng.fold_in(prng.PRNGKey(0), 17)
        for model, sites in (("granite-3-8b", GRANITE_SITES), ("deepseek-67b", DEEPSEEK_SITES)):
            for name in ("ideal", "SMWA"):
                for r in (4, 64):
                    for site, k, c, b in sites:
                        all_ok &= kernel_case(torch, K, chans[name], r, k, c, b, False, None, gen, rows,
                                              model=model, site=site, key=key if name == "SMWA" else None,
                                              exact=True, twin_once=True)
            for name in ("ideal", "SMWA"):
                for r in (4, 64):
                    layer = [x for x in rows if x["model"] == model and x["channel"] == name and x["R_live"] == r]
                    bm, bb = bound_of([x["parts"] for x in layer])
                    log(f"  {model} {'layer' if model == 'granite-3-8b' else 'ffn.wo + lm_head'} sum {name} R={r}: "
                        f"kernel {sum(x['ms'] for x in layer):.4f} ms, twin {sum(x['plain_ms'] for x in layer):.3f} ms, "
                        f"bound {bm:.5f} ms ({bb}), _int_mm {layer_sum(layer, 'library_ms'):.4f} ms [{card}]")
        all_ok &= sliced_case(torch, K, chans["SMWA"], 4, *GRANITE_SITES[0][1:3], 2, GRANITE_SITES[0][0], gen,
                              sliced_rows, card, prng_key=key, model="granite-3-8b")
        # deepseek-v2-lite-16b's sites: decode (R = 4) and a prefill chunk
        # (R = 64), and wuk / wuv over the padded cache (R = 512), ideal and
        # SMWA under the key, each bitwise its twin.
        model = "deepseek-v2-lite-16b"
        for name in ("ideal", "SMWA"):
            cases = [(r, site) for r in (4, 64) for site in V2_SITES]
            cases += [(V2_CACHE_ROWS, site) for site in V2_CACHE_SITES]
            for r, (site, k, c, b) in cases:
                all_ok &= kernel_case(torch, K, chans[name], r, k, c, b, False, None, gen, rows,
                                      model=model, site=site, key=key if name == "SMWA" else None,
                                      exact=True, twin_once=True)
            v2 = [x for x in rows if x["model"] == model and x["channel"] == name]
            attn_ffn = ("attn.wq", "attn.wdkv", "attn.wo", "ffn.shared.wi", "ffn.shared.wo")
            sums = {
                "MoE layer, absorbed decode (R=4)": [x for x in v2 if x["R_live"] == 4 and x["site"] in attn_ffn],
                "MoE layer, expanded decode (R=4, wuk/wuv R=512)": [
                    x for x in v2 if (x["R_live"] == 4 and x["site"] in attn_ffn) or x["R_live"] == V2_CACHE_ROWS],
                "MoE layer sites at R=64": [x for x in v2 if x["R_live"] == 64 and x["site"] in attn_ffn],
                "layer 0 dense FFN (R=4)": [x for x in v2 if x["R_live"] == 4 and x["site"] in ("ffn.wi", "ffn.wo")],
            }
            for what, layer in sums.items():
                bm, bb = bound_of([x["parts"] for x in layer])
                log(f"  {model} {what} {name}: kernel {sum(x['ms'] for x in layer):.4f} ms, twin "
                    f"{sum(x['plain_ms'] for x in layer):.3f} ms, bound {bm:.5f} ms ({bb}), _int_mm "
                    f"{layer_sum(layer, 'library_ms'):.4f} ms [{card}]")
    flash_rows = []
    with Phase("flash kernels"):
        for case in FLASH_CASES:
            all_ok &= flash_case(torch, F, case, gen, flash_rows, card)
        p_ok, p_rows = p_terms_phase(torch, F, variants, shipped_terms, gen, card)
        all_ok &= p_ok
    if not all_ok:
        log("kernel phase: MISMATCH")
        return 1
    arch = registry.get("qwen2-0.5b")
    from repro_torch.photonic.engine import PhotonicEngine
    from repro_torch.photonic.packing import pack_dense

    smwa = smwa_dpu()
    with Phase("int_gemm path"):
        eng = PhotonicEngine(dpu=smwa, backend="kernel")
        packs = []
        for site, k, c, b in SITES:
            w = torch.randn((k, c), generator=gen, device="cuda").to(torch.bfloat16)
            packs.append((site, pack_dense({"w": w}, eng)["w"]))
        xq = torch.randint(-127, 128, (64, 896), generator=gen, device="cuda", dtype=torch.int8)
        xq2 = torch.randint(-127, 128, (64, 4864), generator=gen, device="cuda", dtype=torch.int8)
        K.reset_launches()
        outs = []
        for site, pk in packs:
            outs.append(eng.int_gemm(
                xq if pk.k == 896 else xq2, pk.wq, site=site, fold=0,
                logical_kc=(pk.k, pk.c), tiling=pk.tiling, pack=pk,
            ))
        torch.cuda.synchronize()
        int_path_launches = K.LAUNCHES["photonic_gemm"]
        int_ok = int_path_launches == len(SITES) and all(
            o.dtype == torch.int32 and tuple(o.shape) == (64, pk.c)
            for o, (_, pk) in zip(outs, packs)
        )
        log(f"  int_gemm over the six sites: photonic_gemm launches {int_path_launches}, "
            f"shapes ok {int_ok}")
        all_ok &= int_ok
        del packs, outs

    with Phase("serve"):
        t0 = time.perf_counter()
        params = init_params(arch.config, 0, device="cuda")
        torch.cuda.synchronize()
        log(f"  init_params (qwen2-0.5b full width, bf16) {time.perf_counter() - t0:.2f} s")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, arch.config.vocab_size, n).astype(np.int32) for n in (16, 40, 64, 24)]
        ideal = ideal_dpu()
        n_layers = arch.config.num_layers
        results = {}
        for label, dpu, backend in (
            ("ideal", ideal, "kernel"), ("smwa", smwa, "kernel"), ("ideal_ref", ideal, "ref"),
        ):
            reqs, launches, forwards, done, finite, st = serve(
                torch, arch, params, dpu, backend, prompts, card, label
            )
            expect = 6 * n_layers * forwards if backend == "kernel" else 0
            ok = (done and finite and launches["photonic_gemm_fused"] == expect
                  and launches["photonic_gemm"] == 0 and launches["flash_attention"] == 0)
            log(f"  {label}: all done {done}, logits finite {finite}, fused launches "
                f"{launches['photonic_gemm_fused']} == {expect}, flash launches "
                f"{launches['flash_attention']} == 0 (chunked attention): {ok}")
            results[label] = (reqs, launches, st)
            all_ok &= ok
            torch.cuda.empty_cache()
        same = all(a.output == b.output for a, b in zip(results["ideal"][0], results["ideal_ref"][0]))
        log(f"  ideal kernel tokens == ideal ref tokens: {same}")
        for a, b in zip(results["ideal"][0], results["ideal_ref"][0]):
            log(f"    uid {a.uid}: kernel {a.output} ref {b.output}")
        for r in results["smwa"][0]:
            log(f"    smwa uid {r.uid}: {r.output}")
        all_ok &= same

    with Phase("sliced serve"):
        sliced_ok, sliced = sliced_serve_phase(torch, arch, params, prompts, results["ideal"][0], card)
        all_ok &= sliced_ok

    with Phase("int8 serve"):
        int8_ok, int8 = int8_serve_phase(torch, arch, params, prompts, card)
        all_ok &= int8_ok

    with Phase("oneshot serve"):
        oneshot = oneshot_phase(torch, arch, params, ideal, prompts, card)
        all_ok &= oneshot["ok"]
    del params
    torch.cuda.empty_cache()

    with Phase("init and examples"):
        init_ok, init_res, init_launches = init_phase(torch, registry, card)
        all_ok &= init_ok

    tp_rows = []
    with Phase("tp"):
        rows_ok, tp_sums = tp_kernel_rows(torch, K, chans, key, gen, tp_rows, card)
        all_ok &= rows_ok
        serve_tokens = json.dumps([[int(t) for t in r.output] for r in results["ideal"][0]])
        tp_ok, tp_res, tp_launches = run_child(card, "tp", timeout=700, args=[serve_tokens])
        all_ok &= tp_ok

    with Phase("dense serve"):
        dense_ok, dense, dense_peak = dense_serve_phase(torch, registry, card)
        all_ok &= dense_ok

    with Phase("deepseek"):
        deepseek_ok, deepseek, deepseek_launches = deepseek_phase(torch, registry, card)
        all_ok &= deepseek_ok

    with Phase("moe"):
        moe_ok, moe, moe_launches = moe_phase(torch, registry, card)
        all_ok &= moe_ok

    cross_rows, cross_flash = [], []
    with Phase("cross"):
        rows_ok, cross_sums = cross_kernel_rows(torch, K, chans, key, gen, cross_rows, card)
        all_ok &= rows_ok
        all_ok &= flash_case(torch, F, WHISPER_FLASH, gen, cross_flash, card)
        cross_ok, cross, cross_fused, cross_flash_launches = cross_phase(torch, registry, card)
        all_ok &= cross_ok

    rec_rows, rec_flash = [], []
    with Phase("recurrent"):
        rows_ok, rec_sums = recurrent_kernel_rows(torch, K, chans, key, gen, rec_rows, card)
        all_ok &= rows_ok
        all_ok &= flash_case(torch, F, ZAMBA_FLASH, gen, rec_flash, card)
        rec_ok, rec, _, rec_flash_launches = recurrent_phase(torch, registry, card)
        all_ok &= rec_ok

    with Phase("train"):
        train_ok, train_res, train_launches = run_child(card, "train", timeout=600)
        all_ok &= train_ok

    tpt_rows = []
    with Phase("tp train"):
        rows_ok, tpt_sums = tp_train_kernel_rows(torch, K, chans["ideal"], gen, tpt_rows, card)
        all_ok &= rows_ok
        if "a" in train_res:
            arg = json.dumps({k: train_res["a"][k] for k in ("losses", "fingerprint")})
            tpt_ok, tpt_res, tpt_launches = run_child(card, "tp-train", timeout=600, args=[arg])
        else:
            log("  tp train: phase 7 (a) gave no losses to hold TP = 2 to")
            tpt_ok, tpt_res, tpt_launches = False, {}, {}
        all_ok &= tpt_ok

    fam_rows = []
    with Phase("train families"):
        rows_ok, fam_sums = train_kernel_rows(torch, K, chans["ideal"], gen, fam_rows, card)
        all_ok &= rows_ok
        fam_ok, fam, _ = run_child(card, "train-families", timeout=500)
        all_ok &= fam_ok

    ops_out = []
    with Phase("analytic"):
        records = {"qwen2-0.5b": oneshot["gemm_calls"], "deepseek-v2-lite-16b": moe["gemm_calls"]}
        analytic_ok, analytic, ops_launches = analytic_phase(torch, K, chans, gen, ops_out, records, card)
        all_ok &= analytic_ok

    with Phase("tooling"):
        tooling_ok, tooling, tooling_launches = tooling_phase(torch, registry, card)
        all_ok &= tooling_ok

    with Phase("placement"):
        col_rows = []
        all_ok &= column_origin_rows(torch, K, chans, key, col_rows, card)
        row_rows = []
        all_ok &= row_origin_rows(torch, K, chans, key, row_rows, card)
        place_ok, placement, place_launches = run_child(card, "placement", timeout=700)
        placement["column_origin_rows"] = col_rows
        placement["row_origin_rows"] = row_rows
        all_ok &= place_ok
        cells_ok, placement["cells"] = placement_cells(tooling.get("dry_runs", []), registry, card)
        all_ok &= cells_ok

    if not all_ok:
        log("chip_smoke: FAILED")
        return 1

    # The kernels line.  photonic_gemm_fused: one decoder layer's six GEMMs
    # at R=64 under the ideal channel (where _int_mm is a like-for-like
    # yardstick), launches from the paged serve runs, the int8 runs and
    # train().  photonic_gemm: the same layer bit-sliced at 2-bit planes (16
    # unfused passes a GEMM), launches from the sliced serve runs.
    fused_rows = [x for x in rows if x["R_live"] == 64 and x["channel"] == "ideal" and x["x"] == "int8"
                  and x["model"] == "qwen2-0.5b"]
    sliced_layer = [x for x in sliced_rows if x["R_live"] == 64 and x["channel"] == "ideal" and x["plane_bits"] == 2
                    and x["model"] == "qwen2-0.5b"]
    fused_bound = bound_of([x["parts"] for x in fused_rows])
    sliced_bound = bound_of([x["parts"] for x in sliced_layer])
    kernels = [
        dict(
            name="photonic_gemm_fused", route="cuda", source=FUSED_SRC,
            replaces="src/repro/kernels/photonic_gemm/kernel.py:412",
            launches=(results["ideal"][1]["photonic_gemm_fused"] + results["smwa"][1]["photonic_gemm_fused"]
                      + int8["int8_fused"][1]["photonic_gemm_fused"]
                      + int8["int8_three_sites"][1]["photonic_gemm_fused"]
                      + train_launches["photonic_gemm_fused"]
                      + sum(v[1]["photonic_gemm_fused"] for v in dense.values()) + deepseek_launches
                      + moe_launches + tooling_launches + init_launches),
            max_abs_err=max(x["max_abs_err"] for x in fused_rows),
            ms=layer_sum(fused_rows, "ms"), plain_ms=layer_sum(fused_rows, "plain_ms"),
            bound_ms=fused_bound[0], bound_by=op_or_bytes(fused_bound[1]),
            library_ms=None, case="six qwen2-0.5b sites, R=64, ideal channel, int8 x; launches from "
                                  "the ideal and SMWA serve runs, the two int8 kernel serve runs, the "
                                  "train() run, the granite-3-8b and qwen2-1.5b serve runs, the "
                                  "deepseek-67b lm_logits and serve runs, the moe phase's "
                                  "deepseek-v2-lite-16b and phi3.5-moe lm_logits and LegacyEngine runs, "
                                  "the tooling phase's checked and profiled decode steps, and the init "
                                  "phase's kernel serve run from the reference's weights",
        ),
        dict(
            name="photonic_gemm", route="cuda", source=FUSED_SRC,
            replaces="src/repro/kernels/photonic_gemm/kernel.py:319",
            launches=sliced["sliced_ideal"][1]["photonic_gemm"] + sliced["sliced_smwa"][1]["photonic_gemm"],
            max_abs_err=max(x["max_abs_err"] for x in sliced_layer),
            ms=layer_sum(sliced_layer, "ms"), plain_ms=layer_sum(sliced_layer, "plain_ms"),
            bound_ms=sliced_bound[0], bound_by=op_or_bytes(sliced_bound[1]),
            library_ms=layer_sum(sliced_layer, "library_ms"),
            case="six qwen2-0.5b sites, R=64, ideal channel, bit-sliced at 2-bit planes (16 unfused "
                 "passes a GEMM); library: torch._int_mm of the same int8 GEMMs; launches from the "
                 "sliced ideal and SMWA serve runs",
        ),
    ]
    fl = next(x for x in flash_rows if x["case"] == "lm_logits")
    kernels.append(dict(
        name="flash_attention", route="cuda", source=FLASH_SRC,
        replaces="src/repro/kernels/flash_attention/kernel.py:91",
        launches=oneshot["flash_launches"], max_abs_err=fl["max_abs_err"],
        bound_ratio=fl["bound_ratio"]["kernel"][0],
        ms=fl["ms"], plain_ms=fl["plain_ms"], bound_ms=fl["bound_ms"], bound_by=fl["bound_by"],
        library_ms=fl["library_ms"],
        case="B=2, T=1000, 14 heads / 2 KV heads, hd=64, causal, bf16 (the lm_logits shape); "
             "launches from the one-shot flash runs",
    ))
    # The cross phase's rows: llama-3.2-vision-90b's decode step (8 self
    # layers, 2 cross layers and the head at R = 4, ideal; launches from its
    # lm_logits and decode runs), whisper-medium's encoder layer (the six
    # sites at R = 4 x 1500, ideal; launches from its whisper_logits and
    # decode runs), and the flash kernel on whisper's encoder.
    for what, sums_key, rows_of, launches in (
        ("llama-3.2-vision-90b decode step: 8 self layers (6 sites) + 2 cross layers (wq, wo, ffn) + the head, "
         "R=4, ideal channel, int8 x; launches from the cross phase's llama-3.2-vision runs",
         "vlm decode step ideal", lambda x: x["model"] == "llama-3.2-vision-90b" and x["R_live"] == 4
         and x["channel"] == "ideal", cross["llama-3.2-vision-90b"]["fused_launches"]),
        ("whisper-medium encoder layer: six sites at R=4x1500 (ffn.wi with gelu), ideal channel, int8 x; "
         "launches from the cross phase's whisper runs", "whisper encoder layer",
         lambda x: x["model"] == "whisper-medium" and x["R_live"] == WHISPER_ENC_ROWS,
         cross["whisper-medium"]["fused_launches"]),
    ):
        sm = cross_sums[sums_key]
        kernels.append(dict(
            name="photonic_gemm_fused", route="cuda", source=FUSED_SRC,
            replaces="src/repro/kernels/photonic_gemm/kernel.py:412", launches=launches,
            max_abs_err=max(x["max_abs_err"] for x in cross_rows if rows_of(x)),
            ms=sm["ms"], plain_ms=sm["plain_ms"], bound_ms=sm["bound_ms"], bound_by=op_or_bytes(sm["bound_by"]),
            library_ms=sm["library_ms"], case=what + "; library: torch._int_mm of the int cores",
        ))
    wf = cross_flash[0]
    kernels.append(dict(
        name="flash_attention", route="cuda", source=FLASH_SRC,
        replaces="src/repro/kernels/flash_attention/kernel.py:91",
        launches=cross_flash_launches, max_abs_err=wf["max_abs_err"], bound_ratio=wf["bound_ratio"]["kernel"][0],
        ms=wf["ms"], plain_ms=wf["plain_ms"], bound_ms=wf["bound_ms"], bound_by=wf["bound_by"],
        library_ms=wf["library_ms"],
        case="whisper-medium encoder: B=4, T=1500, 16 / 16 heads, hd=64, non-causal, bf16; launches from the "
             "cross phase's whisper flash runs",
    ))
    # The recurrent phase's rows: each model's decode step (R = 4, ideal;
    # launches from its logits and LegacyEngine runs), and the flash kernel
    # at zamba2's shared-attention heads (hd 80, padded to the 128 template;
    # launches from zamba2's flash logits run).
    for model in ("xlstm-350m", "zamba2-2.7b"):
        sm = rec_sums[f"{model} decode step ideal"]
        kernels.append(dict(
            name="photonic_gemm_fused", route="cuda", source=FUSED_SRC,
            replaces="src/repro/kernels/photonic_gemm/kernel.py:412", launches=rec[model]["fused_launches"],
            max_abs_err=max(x["max_abs_err"] for x in rec_rows if x["model"] == model and x["R_live"] == 4
                            and x["channel"] == "ideal"),
            ms=sm["ms"], plain_ms=sm["plain_ms"], bound_ms=sm["bound_ms"], bound_by=op_or_bytes(sm["bound_by"]),
            library_ms=sm["library_ms"],
            case=f"{model} decode step's GEMMs at R=4, ideal channel, int8 x ({XLSTM_LAUNCHES if model == 'xlstm-350m' else ZAMBA_LAUNCHES} "
                 f"calls); library: torch._int_mm of the int cores; launches from the recurrent phase's {model} runs",
        ))
    zf = rec_flash[0]
    kernels.append(dict(
        name="flash_attention", route="cuda", source=FLASH_SRC,
        replaces="src/repro/kernels/flash_attention/kernel.py:91",
        launches=rec_flash_launches, max_abs_err=zf["max_abs_err"], bound_ratio=zf["bound_ratio"]["kernel"][0],
        ms=zf["ms"], plain_ms=zf["plain_ms"], bound_ms=zf["bound_ms"], bound_by=zf["bound_by"],
        library_ms=zf["library_ms"],
        case="zamba2-2.7b shared attention: B=4, T=512, 32 / 32 heads, hd=80 (zero-padded to the 128 template), "
             "causal, bf16; launches from the recurrent phase's zamba2 flash logits runs (whole: 9; first group: 1)",
    ))
    # The train-families phase's rows at R = 4096: xlstm-350m's mLSTM layer,
    # zamba2-2.7b's Mamba2 layer and deepseek-v2-lite-16b's MoE layer, each
    # with the launches of its model's training runs.
    for model, what in (("xlstm-350m", "mLSTM layer (7 sites)"), ("zamba2-2.7b", "Mamba2 layer (2 sites)"),
                        ("deepseek-v2-lite-16b", "MoE layer (7 routed sites, MLA expanded)")):
        sm = fam_sums[f"{model} {what}"]
        kernels.append(dict(
            name="photonic_gemm_fused", route="cuda", source=FUSED_SRC,
            replaces="src/repro/kernels/photonic_gemm/kernel.py:412",
            launches=sum(fam.get(model, {}).get(m, {}).get("fused_launches", 0) for m in ("a", "b")),
            max_abs_err=max(x["max_abs_err"] for x in fam_rows if x["model"] == model),
            ms=sm["ms"], plain_ms=sm["plain_ms"], bound_ms=sm["bound_ms"], bound_by=op_or_bytes(sm["bound_by"]),
            library_ms=sm["library_ms"],
            case=f"{model} {what} at the training shape R=4096, ideal channel, int8 x; library: torch._int_mm of "
                 f"the int cores; launches from the train-families phase's {model} runs (ideal and SMWA)",
        ))
    # The analytic phase's ops rows: the six qwen2-0.5b sites at R = 64 on the
    # ideal channel through ops.photonic_gemm (the fused kernel) and
    # ops.photonic_gemm_int (the unfused one), with the launches of the ops
    # main path (ideal and SMWA, and the tile_c=256 row).
    for name, fn, what in (
        ("photonic_gemm_fused", "photonic_gemm", "kernels/photonic_gemm/ops.py::photonic_gemm, f32 x and w (the "
         "weight quantized per call)"),
        ("photonic_gemm", "photonic_gemm_int", "kernels/photonic_gemm/ops.py::photonic_gemm_int, int8 x and w; "
         "library: torch._int_mm of the same GEMMs"),
    ):
        layer = [x for x in ops_out if x["fn"] == fn and x["channel"] == "ideal" and x["tile_c"] == 128]
        bm, bb = bound_of([x["parts"] for x in layer])
        kernels.append(dict(
            name=name, route="cuda", source=FUSED_SRC,
            replaces="src/repro/kernels/photonic_gemm/kernel.py:" + ("412" if name == "photonic_gemm_fused" else "319"),
            launches=ops_launches[name], max_abs_err=max(x["max_abs_err"] for x in layer),
            ms=layer_sum(layer, "ms"), plain_ms=layer_sum(layer, "plain_ms"), bound_ms=bm,
            bound_by=op_or_bytes(bb), library_ms=layer_sum(layer, "library_ms"),
            case=f"{what}: six qwen2-0.5b sites, R=64, ideal channel, the whole ops call in a CUDA graph; launches "
                 "from the analytic phase's ops main path (ideal and SMWA; photonic_gemm_int also at tile_c=256)",
        ))
    # The tp phase's row: one shard's six unfused GEMMs of a qwen2-0.5b layer
    # at R = 64, ideal channel, K-sharded over two shards; launches from the
    # tp phase's K-sharded serve and lm_logits runs, summed over the ranks.
    sm = tp_sums["qwen2-0.5b ideal R=64"]
    kernels.append(dict(
        name="photonic_gemm", route="cuda", source=FUSED_SRC,
        replaces="src/repro/kernels/photonic_gemm/kernel.py:319", launches=tp_launches["photonic_gemm"],
        max_abs_err=sm["max_abs_err"], ms=sm["ms"], plain_ms=sm["plain_ms"], bound_ms=sm["bound_ms"],
        bound_by=op_or_bytes(sm["bound_by"]), library_ms=sm["library_ms"],
        case=f"tensor-parallel: one shard of {TP_SHARDS} of a qwen2-0.5b layer's six sites (K_local 448 / 2432), "
             "R=64, ideal channel, shard_local_engine.int_gemm(shard=i); library: torch._int_mm of the shard's "
             "int cores; launches from the tp phase's K-sharded Engine and lm_logits runs, both ranks",
    ))
    # The tp-train phase's row: one shard's six unfused GEMMs of a qwen2-0.5b
    # layer at the TP = 2 training shape (R = 4096), ideal channel; launches
    # from the tp-train phase's runs, summed over the ranks.
    sm = tpt_sums[f"qwen2-0.5b ideal R={TRAIN_ROWS}"]
    kernels.append(dict(
        name="photonic_gemm", route="cuda", source=FUSED_SRC,
        replaces="src/repro/kernels/photonic_gemm/kernel.py:319", launches=tpt_launches["photonic_gemm"],
        max_abs_err=sm["max_abs_err"], ms=sm["ms"], plain_ms=sm["plain_ms"], bound_ms=sm["bound_ms"],
        bound_by=op_or_bytes(sm["bound_by"]), library_ms=sm["library_ms"],
        case=f"tensor-parallel training: one shard of {TP_SHARDS} of a qwen2-0.5b layer's six sites (K_local 448 / "
             f"2432), R={TRAIN_ROWS}, ideal channel, shard_local_engine.int_gemm(shard=i); library: torch._int_mm of "
             "the shard's int cores; launches from the tp-train phase's runs (TP = 2 train() and SMWA step, the "
             "DP 2 x TP 2 train() and DP steps), every rank",
    ))
    # The placement phase's row: one shard of two of a qwen2-0.5b layer's
    # six unfused GEMMs at R = 4, ideal channel (the tp phase's timing; the
    # placed decode runs 2 rows a rank, 4 in prefill x 16 tokens); launches
    # from phase 10's placed and replicated decode and train() runs, every rank.
    sm = tp_sums["qwen2-0.5b ideal R=4"]
    kernels.append(dict(
        name="photonic_gemm", route="cuda", source=FUSED_SRC,
        replaces="src/repro/kernels/photonic_gemm/kernel.py:319", launches=place_launches["photonic_gemm"],
        max_abs_err=sm["max_abs_err"], ms=sm["ms"], plain_ms=sm["plain_ms"], bound_ms=sm["bound_ms"],
        bound_by=op_or_bytes(sm["bound_by"]), library_ms=sm["library_ms"],
        case=f"placement: one shard of {TP_SHARDS} of a qwen2-0.5b layer's six sites (K_local 448 / 2432), R=4, "
             "ideal channel, shard_local_engine.int_gemm(shard=i) (timed in the tp phase); library: torch._int_mm "
             "of the shard's int cores; launches from phase 10's four ranks: the placed and replicated prefill + "
             "decode runs, ideal and SMWA, the placed and replicated train() runs, (d)'s MoE decoders at full "
             "width (deepseek-v2-lite, phi3.5-moe) and (e)'s recurrent, audio and vision families at full width "
             "(xlstm-350m, zamba2-2.7b, whisper-medium, llama-3.2-vision-90b), placed and replicated",
    ))
    # The placement phase's column-origin rows: a rank's column blocks at R = 4,
    # unfused, ideal channel, each at its global column origin; qwen2-0.5b's
    # attn.wq (448 columns from 448) and attn.wk (64 from 64), launches from
    # phase 10's qwen2-0.5b column-parallel runs (the placed-parameter prefill
    # + decode runs and the dry run's placed train step); deepseek-v2-lite's
    # ffn.wi halves and attn.wq head block, launches from (d)'s placed MoE
    # decoders; every rank.
    for models, launches, case in (
            (("qwen2-0.5b",), place_launches["column_parallel"],
             "column-parallel: a rank's column blocks of qwen2-0.5b's attn.wq (448 from c_origin 448) and attn.wk "
             "(64 from c_origin 64), R=4, K=896, ideal channel, PhotonicEngine.int_gemm(columns=); library: "
             "torch._int_mm of the blocks' int cores; launches from phase 10's column-parallel runs (placed-"
             "parameter prefill + decode, ideal and SMWA, and the dry run's placed train step), every rank"),
            (("deepseek-v2-lite-16b",), place_launches["moe_column_parallel"],
             "column-parallel, MoE decoders: a rank's column blocks of deepseek-v2-lite's layer-0 ffn.wi (u 5472 "
             "from c_origin 5472, g 5472 from c_origin 10944) and MLA attn.wq (1536 from c_origin 1536), R=4, "
             "K=2048, ideal channel, PhotonicEngine.int_gemm(columns=); library: torch._int_mm of the blocks' int "
             "cores; launches from (d)'s placed deepseek-v2-lite and phi3.5-moe prefill + decode runs (ideal and "
             "SMWA, expanded and absorbed), every rank"),
            (("zamba2-2.7b", "xlstm-350m"), place_launches["families_column_parallel"],
             "column-parallel, recurrent families: a rank's column blocks of zamba2-2.7b's Mamba2 in_proj by its "
             "parts (z 2560 from c_origin 2560, x 2560 from 7680, B C 64 from 10304, dt 40 from 10408; K=2560), "
             "xlstm-350m's mLSTM up halves (xin 1024 from 1024, gate 1024 from 2048; K=1024), its wq key block of "
             "head 0 (256 from 256; K=2048) and its sLSTM wx quarters (512 from 512, 1536, 2560, 3584; K=1024), "
             "R=4, ideal channel, PhotonicEngine.int_gemm(columns=); library: torch._int_mm of the blocks' int "
             "cores; launches from (e)'s placed xlstm-350m, zamba2-2.7b, whisper-medium and llama-3.2-vision-90b "
             "prefill + decode runs (ideal, and SMWA for the recurrent two), every rank")):
        blk = [x for x in col_rows if x["model"] in models and x["channel"] == "ideal" and x["fused"] == 0]
        bm, bb = bound_of([x["parts"] for x in blk])
        kernels.append(dict(
            name="photonic_gemm", route="cuda", source=FUSED_SRC,
            replaces="src/repro/kernels/photonic_gemm/kernel.py:319", launches=launches,
            max_abs_err=max(x["max_abs_err"] for x in blk), ms=layer_sum(blk, "ms"),
            plain_ms=layer_sum(blk, "plain_ms"), bound_ms=bm, bound_by=op_or_bytes(bb),
            library_ms=layer_sum(blk, "library_ms"), case=case,
        ))
    # The placement phase's row-origin rows: a rank's 2,048 of deepseek-v2-lite's
    # 4,096 latent rows through attn.wuk at r_origin 2048 and 1000, fused, keyed
    # SMWA; launches from (g)'s runs without TP, every rank.
    blk = [x for x in row_rows if x["channel"] == "SMWA" and x["fused"] == 1]
    bm, bb = bound_of([x["parts"] for x in blk])
    kernels.append(dict(
        name="photonic_gemm_fused", route="cuda", source=FUSED_SRC,
        replaces="src/repro/kernels/photonic_gemm/kernel.py:412", launches=place_launches["row_origin_fused"],
        max_abs_err=max(x["max_abs_err"] for x in blk), ms=layer_sum(blk, "ms"), plain_ms=layer_sum(blk, "plain_ms"),
        bound_ms=bm, bound_by=op_or_bytes(bb), library_ms=layer_sum(blk, "library_ms"),
        case="row origin: a rank's 2,048 of deepseek-v2-lite's 4,096 latent cache rows through attn.wuk (K=512, "
             "C=2048) at r_origin 2048 and 1000 (off the row tile), f32 x, keyed SMWA, "
             "PhotonicEngine.int_gemm(rows=, x_word=); library: torch._int_mm of the blocks' int cores; launches "
             "from phase 10 (g)'s deepseek-v2-lite SMWA expanded decode runs without TP (replicated and placed, "
             "every routed GEMM fused; the placed run's wuk / wuv at their blocks' row origins), every rank",
    ))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_rows.json").write_text(json.dumps(
        {"card": card, "kernel_rows": rows, "sliced_rows": sliced_rows, "flash_rows": flash_rows,
         "p_term_rows": p_rows, "oneshot": {k: v for k, v in oneshot.items() if k != "ok"},
         "int_rows": [list(x[:3]) + [x[4], x[5], x[6], x[7], bound_of([x[8]])[0]] for x in int_rows],
         "serve": {k: v[2] for k, v in {**results, **sliced, **int8, **dense}.items()}, "train": train_res,
         "keys": keys_res, "deepseek": deepseek, "moe": moe, "dense_serve_peak_bytes": dense_peak,
         "cross": {"kernel_rows": cross_rows, "sums": cross_sums, "flash_rows": cross_flash, **cross},
         "recurrent": {"kernel_rows": rec_rows, "sums": rec_sums, "flash_rows": rec_flash, **rec},
         "train_families": {"kernel_rows": fam_rows, "sums": fam_sums, **fam},
         "analytic": {"ops_rows": ops_out, **analytic},
         "tp": {"kernel_rows": tp_rows, "sums": tp_sums, **tp_res},
         "tp_train": {"kernel_rows": tpt_rows, "sums": tpt_sums, **tpt_res}, "tooling": tooling,
         "placement": {**placement, "launches": place_launches}, "init": init_res,
         "launch_profile": profile_desc}, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

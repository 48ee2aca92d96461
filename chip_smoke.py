#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Card: name and power limit from nvidia-smi.
2. Build: every CUDA kernel of the port from the sources in this
   checkout (``repro_torch.kernels._build``), with the build time; per
   kernel instantiation, ptxas' registers, spills and static shared
   memory, and the tensor-core instructions (``HGMMA``, ``HMMA``) and
   special-function-unit exponentials (``MUFU.EX2``) in its SASS
   (``cuobjdump -sass`` of the built library). The bf16 instantiations of
   the two prefill-attention kernels must hold ``HGMMA``; every
   instantiation of the fp32-compute flash forward (its P V; fp32 at
   head_dim 64 / 128, fp32 and bf16 at 8 / 16 in one- and four-warp blocks)
   and of the backward's product kernels must hold TF32 ``HMMA`` (3xTF32,
   ``_build.TF32_KERNELS``), printed with its registers and spill bytes.
3. Kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes plus long cases (bf16 flash attention also
   at S = 1, 63, 64, 65 and 129 around the 64-row tile edges, and with
   the GQA / MQA row packings of qwen2.5, G=5, and granite, G=48; bf16
   paged prefill also over a long prefix, B=4, C=128, offsets up to
   3968, on bf16 and int8 pages, whose lanes at offset >= 1000 are also
   held within 2^-7 of their largest plain value, a limit that a planted
   fault, one page of the deepest lane swapped, must exceed; the long
   paged-decode case, lengths 100 / 1000 / 2500 / 4096, holds its lanes of
   length >= 1000 the same way); dense decode at the serving shape, with
   every length 0 (the call's fixed cost; such a lane outputs 0, as the TPU
   kernel gives), and over a 4096-row cache, lengths 100 / 1000 / 2500 /
   4096, with the head packings of stablelm (MHA), phi4-mini (G=3), qwen2.5
   (G=5) and granite (G=48), whose deep lanes are held the same way (the
   planted fault: one 16-row tile of the deepest lane overwritten with
   another lane's rows); the selective scan at the falcon-mamba
   serving shape, at the served short prefills (B = 1..4, S = 8) and a
   120-token prompt, a ragged hymba-width case with a given initial state
   and a 4096-step case, fp32 only; rmsnorm on
   [512, 4096], [512, 2048], a ragged row count and [4096, 4096], one
   4096-token falcon-mamba prompt), fp32 (atol 2e-5;
   for the selective scan, whose y reaches ~10^2 at 4096 steps, where
   2e-5 is below one fp32 ulp, y and h_final each within 2e-5 of
   max(1, the plain value's magnitude)) and bf16
   (against the plain version run in fp32 on the same bf16 inputs, atol
   2e-2); the paged kernels also on int8 pages with fp32 and bf16 queries
   (the same tolerances, against the plain version on the same int8 pages
   and scales), all on shuffled block tables; bf16 paged prefill also as a
   speculative verify (C = 5, k = 4) with qwen2.5's (G=5) and granite's
   (G=48) packings on bf16 and int8 pages, and over a dense slot cache
   read as one page per lane (dense chunked prefill's route: C = 32,
   pages of 128 rows at granite's packing and of 133, a draft cache's
   max_len + k + 1, at stablelm's, offsets up to 120, one chunk past the
   cache), bf16 and fp32, and at phase 10's draft ingest (bf16, C = 5,
   eight lanes of a 261-row cache, offsets up to 255); bf16 dense decode
   also at the served shapes of phases 9 (granite, B=4, S=128, G=48) and
   10 (the draft's steps, B=8 over 261 rows, lengths up to 259); and at
   phase 13's hymba shapes (H=25, KV=5: G=5, D=64, bf16): flash over a
   1300-token prompt with the window of 1024 and without, dense decode
   over a 1024-row ring (lengths 1, 513, 1024, 1024, window 1024) and over
   the 1536-row global cache, the scan at B=1, S=1300, Din 3200 (fp32);
   and at the MoE phases' packings (bf16): granite-moe (H=16, KV=8: G=2,
   D=64) flash over its whole prompts, dense decode at its serving shape,
   paged decode and 32-token chunks on bf16 and int8 pages; qwen3-moe
   (H=32, KV=4: G=8, D=128) flash over a 200-token prompt, dense decode
   over a 4096-row cache, paged decode and its verify (C = 5); phi4-mini
   (G=3, D=128) paged decode and chunks as a target, and its draft steps
   and ingests over a 261-row cache;
   at the encoder-decoders' shapes (phases 18-19): flash at head_dim 8 on
   paper-block's packing (B=64, S=16, 100 heads) bidirectional (its encoder
   and its cross-attention, 16 frames) and causal (its decoder prompt), and
   flash cross at seamless's (B=4, 8 decoder tokens against 1000 frames, 16
   heads of 64), fp32 and bf16; dense decode at head_dim 8 over paper-block's
   32-row self cache and 16-row cross cache (fp32 and bf16) and over
   seamless's cross cache of 1000 rows and of ENC_LEN_DECODE = 4096 rows,
   every lane seeing every row; flash over internvl2-76b's 1100-token
   prompts (64 / 8 heads of 128); a windowed flash's yardstick is one SDPA
   call with a banded boolean mask, and its bound counts the band's (query,
   key) pairs. Kernel, plain-version and
   yardstick times (CUDA events, median of 20 runs, each queued behind a
   device sleep so the events time the device and not the launch): one
   ``scaled_dot_product_attention`` call for the dense kernels; for the
   paged ones, which no single PyTorch call matches, the port's dense
   decode kernel on the same rows laid out contiguously (what paging
   costs) and ``gather_pages`` (K and V) + ``scaled_dot_product_attention``;
   ``torch.nn.functional.rms_norm`` for rmsnorm; none for the selective
   scan (no PyTorch call computes the recurrence), whose bound counts its
   exponentials on the special-function units. An fp32 flash case's bound
   takes its products as 3xTF32 on the tensor cores (the kernel's P V),
   the fp32 CUDA-core figure printed beside it.
4. Serve dense: full-width stablelm-1.6b (24 layers, d_model 2048, vocab
   100352, bf16, random weights from a seeded ``torch.Generator``) through
   ``PipelineServer`` at G=3 x R=3, max_batch 4, max_len 128, async depth
   2, seed 0: ``run(60, arrival_p=0.5)`` plus four 64..120-token prompts.
   Both dense kernels' launch counters must grow (bf16: the flash
   kernel's tensor-core instantiation) and every parameter and cache
   tensor must live on the card. The served dense-decode calls are
   printed as a histogram by (lanes, longest length), and the kernel is
   re-timed warm (``time_ms``) at each served call's lengths and the
   times summed over the calls, as in phase 5.
5. Serve paged: the same weights, ``paged=True``, page 16, max_batch 8,
   max_len 256, 32 pages per replica (below the dense 128), chunked
   prefill of 32 tokens, async depth 2, seed 0: ``run(60,
   arrival_p=0.5)`` plus four 64..200-token prompts, with compute-dtype
   pages and then int8 pages. Both paged kernels' counters must grow,
   every pool, scale and block table must live on the card, and every
   manager's pages must be conserved. The served paged-decode calls are
   printed as a histogram by (lanes, longest length in pages), and the
   kernel is re-timed warm (``time_ms``) at each served call's lengths
   and the times summed over the calls: an estimate of its share of the
   run, not a trace of it.
6. Parity: the same weights in fp32. Every attention call of a
   monolithic prefill and 15 decode steps, and of a paged chunked prefill
   and 15 paged decode steps, runs the kernel and its plain version on
   the same full-width inputs (within 1e-3 of the output's scale); the
   first tokens of an fp32 dense server and of an fp32 paged server equal
   the monolithic kernel path's, and the dense server's 16 greedy tokens
   are compared with the plain path's. The stablelm weights are freed.
7. Serve SSM: full-width falcon-mamba-7b (64 layers, d_model 4096,
   d_inner 8192, state 16, vocab 65024, tied embeddings, 7.006 B params,
   bf16, random weights from a seeded ``torch.Generator``) through the
   dense ``PipelineServer`` at G=3 x R=3, max_batch 4, max_len 128, async
   depth 2, seed 0: ``run(60, arrival_p=0.5)`` plus four 64..120-token
   prompts. The selective-scan counter must grow, every parameter and
   every conv / SSM state tensor must live on the card, and the logits
   and states must be finite. The served scan calls are printed as a
   histogram by (B, S), and the kernel is re-timed warm (``time_ms``) at
   each served shape and the times summed over the calls, as in phase 5.
8. SSM parity: the same weights in fp32. Every selective-scan call of a
   monolithic 64-token prefill runs the kernel and its plain version on
   the model's own inputs (y and h_final within 1e-4 of the plain
   version's scale); the prefill's logits through the kernel agree with
   those through the plain version within 1e-4 of their scale and within
   1e-2 of how far zeroing every scan's y moves them (the random-init
   model's argmax echoes its last input token, whatever the Mamba layers
   return); the first token of an fp32 falcon-mamba server equals the
   monolithic kernel path's, and its 16 greedy tokens are compared with
   the plain path's.
9. Serve dense chunked: full-width granite-20b (52 layers, d_model 6144,
   48 heads, MQA, gelu MLP, vocab 49152, 20.3 B params, bf16, random
   weights from a seeded ``torch.Generator``) through the dense
   ``PipelineServer`` at G=3 x R=3, max_batch 4, max_len 128, 32-token
   chunks, async depth 2, seed 0: ``run(30, arrival_p=0.5)`` plus four
   64..120-token prompts. The paged-prefill kernel's dense-chunk route and
   the dense-decode kernel must launch; every parameter and cache tensor
   must live on the card. The chunk launches are printed as a histogram by
   (member lanes, deepest offset), with the phase's peak memory.
10. Serve speculative: full-width qwen2.5-14b (48 layers, d_model 5120,
   GQA 40/8, vocab 152064, bf16) with its registry draft, stablelm-1.6b
   (vocab 100352, its own seed), paged, page 16, max_batch 8, max_len 256,
   k = 4, G=3 x R=3, async depth 2, seed 0: ``run(30, arrival_p=0.5)``
   plus four 64..200-token prompts. The paged-prefill kernel's verify and
   dense-chunk routes and the dense-decode kernel (the draft's steps) must
   launch; the round counters, the acceptance rate and the plain
   paged-decode launches are printed; every finished request holds exactly
   its ``n_tokens``, every token lies in the target's vocabulary, and the
   draft's embedding takes the target's ids past its own.
11. Speculative parity: phase 4's stablelm weights in fp32, drafting for
   themselves (k = 4). Every attention call of a speculative request (a
   64-token prompt, 16 tokens), the verify and the draft's dense chunks
   included, runs the kernel and its plain version on the same inputs
   (within 1e-3 of the output's scale, as phase 6); the first token equals
   that of a plain fp32 paged server; some draft token is accepted.
12. The paper's simulator on the card (``repro_torch.core``; plain PyTorch,
   no kernel of its own), at the paper's 1000 Monte-Carlo runs, with the
   paper's calibration copied below: (a) Fig. 2a, the four power-mode
   strategies on one device (p = 0.62, harvest U{7..13}, 100 slots), one
   sweep, holding the orderings of the Fig. 2a test; (b) Fig. 4, the
   21-scenario grid on 3 x 3 ``paper_topology`` fleets (harvest means
   m-2 / m / m+2 for m in 4, 6, 8 at p = 0.7; p in 0.5 .. 1.0 on the
   default fleet; x three policies; 300 slots), one sweep, printing
   throughput and drops per scenario; (c) Fig. 2b analytics, q_lim of
   15 / 30 / 60 W and the dynamic mode's 1/kappa_bar at q = 0.34 (harvest
   U{6..10}, xi_lim 0.01) on the card, each within 1e-9 of the CPU's,
   beside the paper's markers; (d) the Fig. 4 grid at 64 runs on the
   card and on the CPU with the same draws (made by a CPU generator):
   integer counters and downtime equal, mean battery within 1e-6
   relative; (e) a fleet of 8 groups x 16 devices (harvest means 4..12,
   dynamic PM, long-term rates at xi_lim 0.01), three policies x p in
   0.4 / 0.7 / 1.0, 1000 slots, conserving jobs in every run. The step
   loops of (a), (b) and (e) run under ``torch.cuda.set_sync_debug_mode(
   "error")``: a readback to the host inside them fails the phase. Each
   sweep prints its wall time, slots x scenarios x runs per second and
   peak memory. ``python3 -c 'import chip_smoke, torch;
   chip_smoke.simulator_phase(torch.device("cuda"))'`` runs it alone.
13. Serve hybrid: full-width hymba-1.5b (32 layers, d_model 1600, 25 / 5
   heads of 64, d_ff 5504, vocab 32001, d_inner 3200, state 16; 29
   window-1024 layers and 3 global ones; bf16, random weights from a
   seeded ``torch.Generator``, the exact parameter count printed) through
   the dense ``PipelineServer`` at G=3 x R=3, max_batch 4, max_len 1536,
   async depth 2, seed 0: ``run(30, arrival_p=0.5)`` plus four prompts of
   1100..1400 tokens, which make windowed flash trim its keys, prefill
   store a rotated ring and decode read full rings. Flash must launch on
   both routes (windowed and full, counted apart, a windowed prompt longer
   than the window among them), dense decode and the scan must launch (a
   decode reading a full ring among them), rmsnorm must not; every
   parameter and cache tensor lives on the card, window classes hold 1024
   rows and global ones 1536. The flash, decode and scan calls are printed
   as histograms, and decode and the scan re-timed warm at each served
   shape and summed over the calls, as in phases 4 and 7, with the
   phase's tokens/s and peak memory.
14. Hybrid parity: the same weights in fp32. (a) At full depth, every
   attention and scan call of a 1100-token prefill and 1000 teacher-forced
   decode steps (every window layer's write slot wraps at position 2048)
   runs the kernel and its plain version on the same inputs (attention
   within 1e-3 of the output's scale, the windowed calls apart; the scan
   within 1e-4); an fp32 server's first token on the prompt equals the
   monolithic kernel path's. (b) On hymba's first three layers (one global,
   two of the window class) at full width, where rounding does not yet
   compound (``HYBRID_CUT``): each call's logits through the kernels, from
   the plain path's cache, within 1e-3 of the plain logits' scale; the
   plain decode's logits after the wrap within 1e-3 of a fresh plain
   prefill's of the same tokens (the ring check); an fp32 server's first
   token equals the plain path's.
   ``python3 -c 'import chip_smoke, torch;
   chip_smoke.hybrid_phase(torch.device("cuda"))'`` runs phases 13-14 alone.
15. Serve MoE: full-width granite-moe-1b-a400m (24 layers, d_model 1024,
   16 / 8 heads of 64, 32 experts of width 512, top 8; 1,384,963,072
   parameters, bf16, seed 0) at G=3 x R=3, async depth 2, seed 0: dense
   (whole prompts through flash, dense decode; max_batch 4, max_len 128,
   four 64..120-token prompts, ``run(60, arrival_p=0.5)``), then paged
   (page 16, max_batch 8, max_len 256, 32-token chunks, bf16 pages, four
   64..200-token prompts, ``run(60)``). Each run prints its tokens/s, peak
   memory, launches per kernel, and the share of routed assignments its
   MoE layers dropped (``moe_ffn.routed`` / ``dropped``, summed on the
   card). The path's kernels must launch and the MoE layers route on the
   card.
16. Serve MoE speculative: full-width qwen3-moe-30b-a3b (48 layers,
   d_model 2048, 32 / 4 heads of 128 with q/k norm, 128 experts of width
   768, top 8; 30,532,122,624 parameters, 61.06 GB bf16, seed 0; the peak
   while its weights are drawn is printed) with its registry draft
   phi4-mini-3.8b (seed 1): paged, page 16, max_batch 8, max_len 256,
   k = 4, four 64..200-token prompts, ``run(30)`` (as phase 10), printing
   the same and the acceptance; the verify and dense-chunk routes and
   dense decode must launch. Then phi4-mini-3.8b served as a target on
   its weights: paged, 32-token chunks, bf16 pages, ``run(30)``. The MoE
   call that first routes a whole verify and drops an assignment is kept
   for phase 17, with the first three layers of both models; the full
   weights are freed.
17. MoE parity, fp32: (a) every attention call of a dense and a paged
   served run of granite-moe at full depth against its plain version
   (within 1e-3 of the output's scale, as phase 6); (b) a recorded MoE
   call of each model (granite-moe's from (a), qwen3-moe's from phase
   16), einsum dispatch against gather: equal keep masks and dropped
   fractions, outputs within 1e-5 of scale; (c) on the first three
   layers at full width (a full-depth random-init model amplifies
   rounding, as phase 14 found), the first served token of granite-moe
   (dense and paged), qwen3-moe (paged) and phi4-mini (paged, chunked)
   through the kernels equal to that through the plain versions; (d)
   qwen3-moe's three layers through 13 teacher-forced paged calls (chunks
   of eight ragged prompts, decode steps and verifies, masked lanes
   included): the logits of each call through the kernels, from the plain
   path's pools, within 1e-3 of the plain logits' scale, and every
   attention call within 1e-3.
18. Serve encoder-decoders: full-size seamless-m4t-large-v2 (24 + 24
   layers, d_model 1024, 16 heads of 64, vocabulary 256206 tied;
   1,370,824,704 parameters, bf16, seed 0): 4 requests of 1000 frames x
   1024 (a 25 s utterance at 40 Hz frames) with 8-token prompts, 32 greedy
   tokens each, through ``prefill_batch`` / ``decode_batch(lanes)`` on a
   4-lane slot cache (max_len 64, enc_len 1000), two lanes prefilled at
   step 0 and two at step 8; then paper-block (the paper's Sec. V block:
   100 + 100 layers, d_model 512, 100 heads of 8; 944,237,568 parameters)
   at the paper's input, 64 requests of 16 frames x 512 with 16-token
   prompts, 16 greedy tokens each. Each prints its tokens/s, the wall time
   of one prefill (the paper's unit of work; warm, median of three) and its
   peak memory. Flash must launch on its ``bidirectional`` (encoder),
   ``full`` (decoder prompt) and ``cross`` routes and dense decode on
   ``self`` and ``cross`` (counted by route: a cross-attention block's calls
   are marked while it runs), and every parameter and cache tensor lives
   on the card.
19. Encoder-decoder parity: both models cut to 3 encoder + 3 decoder
   layers at full width, fp32 (seed 0). Every attention call of a prefill
   (seamless: 2 x 1000 frames, 8 tokens; paper-block: 64 x 16 frames, 16
   tokens) and 8 teacher-forced decode steps runs the kernel and its plain
   version on the same inputs (within 1e-4 of the output's scale, per
   route); the first greedy token of every request is equal on the kernel
   path and the plain path; the same weights in bf16, every call's kernel
   output against the plain version in fp32 within 2e-2 of scale.
20. internvl2-76b reduced to 8 of its 80 layers at full width (d_model
   8192, 64 / 8 heads of 128, vocabulary 128256, bf16, seed 0; the whole
   model, ~141 GB, does not fit the card): two 1100-token prompts whose
   first 1024 positions take projected patch embeddings [2, 1024, 3200],
   then 16 greedy decode steps (the patches must move the logits); then
   one dense ``PipelineServer`` run at G=2 x R=3 (phase 4's workload,
   tokens only, as the JAX fleet serves it), stage 0 alone holding
   ``vision_proj``.
21. Multi-process serving: phase 4's stablelm-1.6b (full width, bf16,
   seed 0) through ``MPPipelineServer`` at G=2 x R=2 — four worker
   processes on the card, each drawing the model from the seed and
   keeping its stage — and through the in-process ``PipelineServer`` on
   the same card and weights, driven through one schedule: three waves of
   eight prompts (64..120 tokens, 8 tokens each), a SIGKILL of stage 0's
   replica 0 three slots into wave 2 (the ``ProcessMonitor`` turns the
   exit into a membership leave: the router's rate for it drops to 0),
   and ``recover_replica`` (a respawn) before wave 3. Every wave's token
   streams and the servers' counters are equal; every worker's ``ping``
   names the card and counts flash and dense-decode launches, and the
   coordinator launches nothing. Prints both servers' tokens/s, the spawn
   and respawn seconds, and the device memory of each process and of the
   fleet.
22. The flash-attention backward kernel (``csrc/flash_attention_bwd.cu``)
   against its plain version per call, fp32: first its product kernels'
   SASS, where every instantiation must hold TF32 ``HMMA`` (3xTF32 on the
   tensor cores, ``csrc/tf32x3.cuh``); then causal at the trained shapes
   of phases 23-24 (B=4, S=256; 32 / 32 and 16 / 8 heads of 64), windowed
   over a ragged length, GQA with G = 4 and G = 16 (the widest split of a
   group's heads over blocks), S = 1024, bidirectional with Sq != Skv,
   head_dim 16, 64 and 128; dq, dk and dv within 1e-4 of their scale, a
   second call equal bit for bit, the forward's log-sum-exp against the
   plain one, and a planted fault (one dk element moved by 1% of dk's
   scale) that the check must catch; times of the kernel, the plain
   version and SDPA's fp32 backward through autograd (any backend, and
   the memory-efficient one alone, each named), and the bound in bytes
   and in 3xTF32 operations (the fp32 CUDA-core figure beside them); then
   ``flash_attention`` under autograd against autograd through the plain
   version; then the fp32 forward kernel (lse on; P V as 3xTF32 on the
   tensor cores) at the two trained shapes, hymba-1.5b's window class (B=1,
   S=1300, 25 / 5 heads, window 1024), seamless's cross packing (B=4, 8
   queries against 1000 keys, 16 / 16 heads, bidirectional) and head_dim
   128 with G=8 (B=2, S=200, 32 / 4 heads): the output within 2e-5 and the
   lse within 2e-5 of the plain versions, a second call equal bit for bit,
   and the kernel's, the plain version's and SDPA's fp32 forward's times
   beside the bound, max(bytes, 3xTF32 operations), with the fp32
   CUDA-core figure.
23. stablelm-1.6b trained at full width, fp32, through
   ``launch/train.py``'s ``train``: B=4, S=256, 20 AdamW steps (lr 3e-4,
   warmup 5), remat on; the losses, grad norms, s/step and peak memory;
   every loss finite and exactly 48 forward and 24 backward flash launches
   per step (24 layers, the forward recomputed under remat). Then the same
   run on a 3-layer cut at full width, whose loss must fall (the mean of
   its last 3 steps below that of its first 3): at full depth the random
   model's gradient norm is ~1e10 and the clip to 1 freezes nearly every
   leaf below AdamW's eps, so its loss is printed, not held.
24. granite-moe-1b-a400m, the same two runs; MoE routed and dropped
   assignments printed.
25. Training parity: a 3-layer full-width fp32 cut of stablelm-1.6b, the
   step-0 loss through the kernels within 1e-5 relative of the plain
   path's on the card, every parameter's gradient within 1e-3 of its own
   scale (each gate widened only as phase 32 says), and every flash call
   of the kernel run, forward and backward, within 1e-3 of its plain
   version on the step's own operands.
26. Checkpoints: stablelm's smoke config on the card, 6 steps with a
   checkpoint every 3, uninterrupted here, then in a process SIGKILLed
   right after its step-3 checkpoint and relaunched from it: steps 4-6
   give the uninterrupted losses bit for bit; the checkpoint's size on
   disk.
27. The selective scan's backward kernel (``csrc/selective_scan_bwd.cu``)
   against its plain version (``selective_scan_bwd_ref``) per call, from
   the forward kernel's state checkpoints: falcon-mamba-7b's trained shape
   (B=4, S=256, Din 8192, N=16), hymba-1.5b's (B=2, S=1280, Din 3200), at
   the segment lengths the wrapper picks, a ragged case (S=37, Din 100,
   N=5, h0 and dh_final given) and the boundaries of 64-step segments (S =
   63, 64, 65; five segments at S=300 with N=5 and A at -1e4); every gradient
   within 1e-4 of its scale, a second call equal bit for bit, a planted
   fault (one dB element moved by 1% of dB's scale) caught; the kernel's
   and the plain version's times beside the bound (bytes; fp32 and SFU
   operations; no library call computes this gradient), and the forward's
   time with and without the checkpoints. Then ``selective_scan`` under
   autograd against autograd through the plain version.
28. The flash backward at head_dim 8, paper-block's trained shape (B=4,
   S=256, 100 heads of 8): its bidirectional encoder, causal decoder and a
   cross-attention over 320 frames (Sq != Skv), phase 22's checks and
   times with SDPA's fp32 backward beside; and the head_dim-8 forward
   (``flash_fwd_kernel<8, float, 4>``, the fp32-compute tile kernel) at the
   same three shapes beside SDPA's fp32 forward and the bound, max(bytes,
   3xTF32 operations), with the fp32 CUDA-core figure.
29. hymba-1.5b trained at full width and depth, fp32, B=2, S=1280 (the
   window of 1024 bites): 10 AdamW steps, then 20 on a 3-layer cut whose
   loss must fall; s/step, peak memory, and exactly the launches of
   ``step_launches`` per step: each layer's flash forward twice (remat)
   and backward once, by route (``windowed`` / ``full``), and its scan
   forward twice and backward once. The full-depth run's step-0 gradient
   is described (norm summed in fp64, largest element, all finite).
30. falcon-mamba-7b at full width cut to 24 of 64 layers (its 7.006 B
   fp32 parameters with gradients and AdamW's moments need ~112 GB),
   B=4, S=256, the same two runs.
31. seamless-m4t-large-v2 and paper-block at full depth, fp32, B=4, S=256
   tokens with 256 frames, the same two runs (3 + 3 layer cuts); flash
   launches held per step and route (``bidirectional``, ``full``,
   ``cross``).
32. Training parity on the cuts of phases 29-31 at their trained shapes:
   the step-0 loss and every parameter's gradient through the kernels
   against the plain path's on the card, 1e-5 relative and 1e-3 of each
   leaf's scale; a loss or a leaf whose own value moves by more than that
   when every weight of the plain path moves one fp32 ulp is held to
   twice its own widest move over 3 such moves, and is printed with it.
   Every flash and scan call of the kernel run, forward and backward,
   within 1e-3 of its plain version on the step's own operands.
33. Mesh serving (``PipelineServer(mesh=...)``; positions are the card
   repeated, ``devices=[cuda] * n``): the attention kernels at each
   position's heads (stablelm-1.6b at model 2, 16 / 16; qwen2.5-14b at
   model 2, 20 / 4, also its verify, C = 5; granite-20b at model 4, 12 / 1;
   an uneven GQA split, H=12, KV=3 at model 4: 3 / 1 and 3 / 3), flash,
   dense decode, paged decode and paged prefill on bf16 and int8 pages,
   and the scan at Din 4096 and 1600, each held to its plain version with
   phase 3's tolerances and timed beside its bound.
34. stablelm-1.6b at full width, bf16, G=3 x R=3 on a (data=2, model=2)
   mesh: dense, then paged with int8 pages and 32-token chunks; tokens/s,
   the weights and caches of every (slice, position), stage calls and
   launches by route. Then the layer check: a prompt's whole prefill and
   two decode steps through every stage's placed weights on slice 0, each
   split layer held within 2e-2 of its output's scale to the unsplit
   layer on the same input and cache (the check's own launches are not
   counted; an MoE layer's kept and dropped assignments equal the unsplit
   call's); then a 3-layer full-width fp32 cut served single-device and on
   the mesh on one schedule, every request's first token equal.
35. qwen2.5-14b (12 of 48 layers, full width) on a (1, 2) mesh, paged and
   speculative with its stablelm-1.6b draft (k = 4), checked as phase 34.
36. hymba-1.5b (16 of 32 layers, the global layers 0 and 15 kept) on a
   (1, 2) mesh with 1100- and 1300-token prompts: sliding-window rings,
   attention replicated (25 heads), the SSM split; checked as phase 34.
37. falcon-mamba-7b (16 of 64 layers) on a (1, 2) mesh; checked as phase 34.
38. granite-moe-1b-a400m on a (1, 4) mesh: experts split, routing global,
   the vocabulary (49155) replicated; checked as phase 34, and the fp32
   cut's routed and dropped assignments equal the single-device run's.
39. ``MPPipelineServer(mesh_model=2)``: phase 21's stablelm-1.6b fleet,
   four workers with two positions each on the card, beside the
   in-process server on a (1, 2) mesh through the same SIGKILL of stage 0's
   replica 0 and respawn: streams and counters equal; spawn and respawn
   seconds and each worker's memory.
40. ``pipeline_apply``: four stages x eight microbatches on four positions
   of the card, equal bit for bit to the stages applied in sequence to
   each microbatch.
41. A JSON line of per-kernel results (the six kernels and the two
   backwards; training's launches of both flash kernels from phases 23-24
   and 29-31 and of the scan's two kernels from phases 29-31; the
   paged-prefill kernel's launches also by route: ``paged_chunk`` from
   phases 5, 15 and 16, ``verify`` and ``dense_chunk`` from phases 9, 10
   and 16; flash's by route: ``windowed`` from phases 13 and 29,
   ``bidirectional`` and ``cross`` from phases 18 and 31, ``full`` from
   the rest, and the flash backward's likewise; dense decode's ``cross``
   from phase 18 and ``self`` from the rest; launches by run, the MoE runs
   of phases 15-16 and phases 18, 20 and 21 included — phase 21's are the
   workers' (the live workers' last pings plus the killed worker's after
   wave 1); rmsnorm's counter is read over phases 4-21 and must stay 0: no
   served path launches it; the mesh runs of phases 34-39 by run, and the
   kernels' cases at the positions' shapes), then the script's seconds
   beside its time before phases 33-40 were added, then the device line
   last.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense; fp32 without tensor cores
# Special-function-unit rate for exp2: 16 results per clock per SM on
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput) against 128 fp32 FMA lanes of 2 flops each.
SFU_PER_S = PEAK_FLOPS[torch.float32] * 16 / 256
# 3xTF32: three TF32 tensor-core products per product (csrc/tf32x3.cuh), at
# the H100's dense TF32 rate: the fp32 flash forward at every head_dim and the
# flash backward.
TF32X3_FLOPS = 495e12 / 3
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
N_TIMED = 20


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Median device time of ``fn`` over N_TIMED runs after warm-up. A
    device sleep queued before each run lets the host enqueue the whole
    call before the start event fires, so launch overhead is excluded."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(N_TIMED):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float, dtype) -> tuple[float, str]:
    mem_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    op_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return (mem_ms, "bytes") if mem_ms >= op_ms else (op_ms, "operations")


def band_mask(Sq: int, window: int) -> torch.Tensor:
    """[Sq, Sq] bool: causal and within the window, as one SDPA mask."""
    pos = torch.arange(Sq, device="cuda")
    return (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)


def flash_case(B, S, H, KV, D, dtype, gen, window=None, *, Skv=None, causal=True, label=""):
    """One flash case: S queries against Skv keys (default S; a cross-
    attention's differ), causal or bidirectional; ``label`` names the
    route it stands for."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    Skv = Skv or S
    q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, Skv, KV, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, Skv, KV, D, generator=gen, device="cuda").to(dtype)
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal, window=window)
    err = (out.float() - want).abs().max().item()
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if window is None:
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=H != KV)
    else:  # one SDPA call with a banded boolean mask
        band = band_mask(S, window)
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=band, enable_gqa=H != KV)
    item = q.element_size()
    # (query, key) pairs scored: under a causal mask (positions compared
    # from 0) each query sees itself and the window - 1 keys before it.
    pairs = sum(min(i + 1, Skv, window or Skv) for i in range(S)) if causal else S * Skv
    flops = 4 * B * H * D * pairs
    bytes_moved = (2 * q.numel() + k.numel() + v.numel()) * item
    b_ms, b_by = bound(bytes_moved, flops, dtype)
    extra = {}
    if dtype == torch.float32:
        # fp32 (flash_fwd_kernel at every head_dim): the least time takes the
        # products as 3xTF32 on the tensor cores; the CUDA-core figure beside it.
        extra["fp32_cuda_core_ms"] = flops / PEAK_FLOPS[torch.float32] * 1e3
        mem_ms, op_ms = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / TF32X3_FLOPS * 1e3
        b_ms, b_by = (mem_ms, "bytes") if mem_ms >= op_ms else (op_ms, "operations")
    shape = f"B={B} S={S} H={H} KV={KV} D={D}" if Skv == S else \
        f"B={B} Sq={S} Skv={Skv} H={H} KV={KV} D={D}"
    return {
        "shape": shape + (f" window={window}" if window else "")
                 + ("" if causal else " bidirectional") + (f" ({label})" if label else ""),
        "dtype": str(dtype).removeprefix("torch."),
        "max_abs_err": err,
        "tol": TOL[dtype],
        "ms": time_ms(lambda: flash_attention(q, k, v, causal=causal, window=window)),
        "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v, causal=causal, window=window)),
        "library_ms": time_ms(library),
        "bound_ms": b_ms,
        "bound_by": b_by,
        **extra,
    }


def decode_bound(q, rows: int, KV: int, D: int) -> tuple[float, str]:
    """Bound of a dense decode call over ``rows`` visible rows in all: q
    read and the output written, each visible K/V row once, the lengths."""
    B, _, H, _ = q.shape
    item = q.element_size()
    return bound(2 * q.numel() * item + 2 * rows * KV * D * item + 4 * B, 4 * H * D * rows,
                 q.dtype)


def decode_case(B, S, H, KV, D, lengths, dtype, gen, window=None, label=""):
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref_model

    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype)
    kc = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    vc = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out = decode_attention(q, kc, vc, lens, window=window)
    torch.cuda.synchronize()
    want = decode_attention_ref_model(q.float(), kc.float(), vc.float(), lens, window=window)
    # A lane of length 0 sees no key: the TPU kernel (and this one) output 0
    # there, where the plain version averages V over the masked rows.
    want = torch.where((lens > 0)[:, None, None, None], want, 0.0)
    err = (out.float() - want).abs().max().item()
    pos = torch.arange(S, device="cuda")[None, :]
    mask = pos < lens[:, None]
    if window is not None:
        mask = mask & (pos >= lens[:, None] - window)
    mask = mask[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    b_ms, b_by = decode_bound(q, sum(min(n, S, window or S) for n in lengths), KV, D)
    deep = deep_lane_check(lens, out, want, decode_attention(q, *tile_overwritten(kc, vc, lens),
                                                             lens, window=window)) \
        if max(lengths) >= DEEP_OFFSET else {}
    return {
        "shape": f"B={B} S={S} H={H} KV={KV} D={D} lengths={lengths}"
                 + (f" window={window}" if window else "") + (f" ({label})" if label else ""),
        "dtype": str(dtype).removeprefix("torch."),
        "max_abs_err": err,
        "tol": TOL[dtype],
        "ms": time_ms(lambda: decode_attention(q, kc, vc, lens, window=window)),
        "plain_ms": time_ms(lambda: decode_attention_ref_model(q, kc, vc, lens, window=window)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=H != KV)),
        "bound_ms": b_ms,
        "bound_by": b_by,
        **deep,
    }


def tile_overwritten(kc, vc, lens):
    """Copies of a dense cache whose deepest lane has one visible 16-row
    tile, half way into its rows, overwritten with the rows of another lane
    at the same positions: the planted fault of the deep-lane check."""
    lane = int(lens.argmax())
    other = (lane + 1) % kc.shape[0]
    t0 = int(lens[lane]) // 2 // 16 * 16
    bad_k, bad_v = kc.clone(), vc.clone()
    bad_k[lane, t0:t0 + 16] = kc[other, t0:t0 + 16]
    bad_v[lane, t0:t0 + 16] = vc[other, t0:t0 + 16]
    return bad_k, bad_v


def page_swapped(depth, bt, n_pool_pages, page):
    """A copy of a block table whose deepest lane has one visible page, half
    way into its rows, swapped for a page outside every table: the planted
    fault of the paged deep-lane checks."""
    spare = torch.ones(n_pool_pages, dtype=torch.bool, device="cuda")
    spare[bt.flatten().long()] = False
    lane = int(depth.argmax())
    bad = bt.clone()
    bad[lane, int(depth[lane]) // page // 2] = spare.nonzero()[0, 0].int()
    return bad


def paged_operands(B, NB, page, KV, D, dtype, int8, gen):
    """A shuffled pool of B * NB + 3 pages (lane b's block j is page
    bt[b, j]; the rest hold garbage) in ``dtype``, or int8 with scales."""
    from repro_torch.kernels.decode_attention import quantize_kv

    P = B * NB + 3
    k = torch.randn(P, page, KV, D, generator=gen, device="cuda")
    v = torch.randn(P, page, KV, D, generator=gen, device="cuda")
    bt = torch.randperm(P, generator=gen, device="cuda")[: B * NB].reshape(B, NB).int()
    if int8:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        return k, v, ks, vs, bt
    return k.to(dtype), v.to(dtype), None, None, bt


def paged_bytes(q, rows: int, KV: int, D: int, k, pages_read: int) -> float:
    """Bytes a paged call must move: q read and the output written, each
    visible K/V row once (plus its two fp32 scales for int8 pages), and
    the block-table entries of the pages read."""
    scale_bytes = 8 if k.dtype == torch.int8 else 0
    return 2 * q.numel() * q.element_size() + rows * (2 * KV * D * k.element_size() + scale_bytes) \
        + 4 * pages_read


def _label(dtype, int8) -> str:
    return str(dtype).removeprefix("torch.") + (" q, int8 pages" if int8 else "")


def paged_decode_case(B, page, H, KV, D, lengths, dtype, int8, gen):
    from repro_torch.kernels.decode_attention import (
        decode_attention, gather_pages, paged_decode_attention, paged_decode_attention_ref)

    NB = -(-max(lengths) // page)
    k, v, ks, vs, bt = paged_operands(B, NB, page, KV, D, dtype, int8, gen)
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    run = lambda: paged_decode_attention(q, k, v, bt, lens, k_scales=ks, v_scales=vs)  # noqa: E731
    out = run()
    torch.cuda.synchronize()
    want = paged_decode_attention_ref(q.float(), k if int8 else k.float(), v if int8 else v.float(),
                                      bt, lens, k_scales=ks, v_scales=vs)
    err = (out.float() - want).abs().max().item()
    # Yardsticks: the same rows laid out contiguously for the dense kernel,
    # and gather + SDPA (two gathers and one SDPA call).
    kc, vc = gather_pages(k, bt, ks).to(dtype), gather_pages(v, bt, vs).to(dtype)
    S = NB * page
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]

    def gather_sdpa():
        kt = gather_pages(k, bt, ks).to(dtype).transpose(1, 2)
        vt = gather_pages(v, bt, vs).to(dtype).transpose(1, 2)
        return F.scaled_dot_product_attention(q.transpose(1, 2), kt, vt, attn_mask=mask,
                                              enable_gqa=H != KV)

    rows = sum(min(n, S) for n in lengths)
    pages_read = sum(-(-min(n, S) // page) for n in lengths)
    b_ms, b_by = bound(paged_bytes(q, rows, KV, D, k, pages_read) + 4 * B,
                       4 * H * D * rows, dtype)
    deep = deep_lane_check(lens, out, want, paged_decode_attention(
        q, k, v, page_swapped(lens, bt, k.shape[0], page), lens, k_scales=ks, v_scales=vs)) \
        if max(lengths) >= DEEP_OFFSET else {}
    return {
        "shape": f"B={B} page={page} H={H} KV={KV} D={D} lengths={lengths}",
        "dtype": _label(dtype, int8),
        "max_abs_err": err,
        "tol": TOL[dtype],
        "ms": time_ms(run),
        "plain_ms": time_ms(lambda: paged_decode_attention_ref(q, k, v, bt, lens,
                                                               k_scales=ks, v_scales=vs)),
        "library_ms": None,
        "dense_decode_ms": time_ms(lambda: decode_attention(q, kc, vc, lens)),
        "gather_sdpa_ms": time_ms(gather_sdpa),
        "bound_ms": b_ms,
        "bound_by": b_by,
        **deep,
    }


def paged_prefill_case(B, C, page, H, KV, D, offsets, dtype, int8, gen):
    from repro_torch.kernels.decode_attention import (
        gather_pages, paged_prefill_attention, paged_prefill_attention_ref)

    NB = -(-(max(offsets) + C) // page)
    k, v, ks, vs, bt = paged_operands(B, NB, page, KV, D, dtype, int8, gen)
    q = torch.randn(B, C, H, D, generator=gen, device="cuda").to(dtype)
    offs = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    run = lambda: paged_prefill_attention(q, k, v, bt, offs, k_scales=ks, v_scales=vs)  # noqa: E731
    out = run()
    torch.cuda.synchronize()
    want = paged_prefill_attention_ref(q.float(), k if int8 else k.float(),
                                       v if int8 else v.float(), bt, offs,
                                       k_scales=ks, v_scales=vs)
    err = (out.float() - want).abs().max().item()
    finite = bool(torch.isfinite(out.float()).all())
    deep = deep_lane_check(offs, out, want, paged_prefill_attention(
        q, k, v, page_swapped(offs, bt, k.shape[0], page), offs, k_scales=ks, v_scales=vs)) \
        if max(offsets) >= DEEP_OFFSET else {}
    S = NB * page
    q_pos = offs[:, None] + torch.arange(C, device="cuda")
    mask = (torch.arange(S, device="cuda")[None, None, :] <= q_pos[:, :, None])[:, None]

    def gather_sdpa():
        kt = gather_pages(k, bt, ks).to(dtype).transpose(1, 2)
        vt = gather_pages(v, bt, vs).to(dtype).transpose(1, 2)
        return F.scaled_dot_product_attention(q.transpose(1, 2), kt, vt, attn_mask=mask,
                                              enable_gqa=H != KV)

    rows = sum(min(o + C, S) for o in offsets)
    pairs = sum(min(o + i + 1, S) for o in offsets for i in range(C))
    pages_read = sum(-(-min(o + C, S) // page) for o in offsets)
    b_ms, b_by = bound(paged_bytes(q, rows, KV, D, k, pages_read) + 4 * B,
                       4 * H * D * pairs, dtype)
    return {
        "shape": f"B={B} C={C} page={page} H={H} KV={KV} D={D} offsets={offsets}",
        "dtype": _label(dtype, int8),
        "max_abs_err": err if finite else float("inf"),
        "tol": TOL[dtype],
        "ms": time_ms(run),
        "plain_ms": time_ms(lambda: paged_prefill_attention_ref(q, k, v, bt, offs,
                                                                k_scales=ks, v_scales=vs)),
        "library_ms": None,
        "gather_sdpa_ms": time_ms(gather_sdpa),
        "bound_ms": b_ms,
        "bound_by": b_by,
        **deep,
    }


def dense_view_case(W, C, L, H, KV, D, offsets, dtype, gen):
    """Dense chunked prefill's route: a [W, L, KV, D] slot cache read by
    the paged-prefill kernel as W pages of L rows, block table arange(W);
    a chunk may run past L (its queries then see the whole lane)."""
    from repro_torch.kernels.decode_attention import (
        paged_prefill_attention, paged_prefill_attention_ref)

    k = torch.randn(W, L, KV, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(W, L, KV, D, generator=gen, device="cuda").to(dtype)
    q = torch.randn(W, C, H, D, generator=gen, device="cuda").to(dtype)
    bt = torch.arange(W, dtype=torch.int32, device="cuda")[:, None]
    offs = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    run = lambda: paged_prefill_attention(q, k, v, bt, offs)  # noqa: E731
    out = run()
    torch.cuda.synchronize()
    want = paged_prefill_attention_ref(q.float(), k.float(), v.float(), bt, offs)
    err = (out.float() - want).abs().max().item()
    finite = bool(torch.isfinite(out.float()).all())
    q_pos = offs[:, None] + torch.arange(C, device="cuda")
    mask = (torch.arange(L, device="cuda")[None, None, :] <= q_pos[:, :, None])[:, None]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rows = sum(min(o + C, L) for o in offsets)
    pairs = sum(min(o + i + 1, L) for o in offsets for i in range(C))
    b_ms, b_by = bound(2 * q.numel() * q.element_size() + rows * 2 * KV * D * k.element_size()
                       + 4 * W * 2, 4 * H * D * pairs, dtype)
    return {
        "shape": f"dense view W={W} C={C} page={L} H={H} KV={KV} D={D} offsets={offsets}",
        "dtype": _label(dtype, False),
        "max_abs_err": err if finite else float("inf"),
        "tol": TOL[dtype],
        "ms": time_ms(run),
        "plain_ms": time_ms(lambda: paged_prefill_attention_ref(q, k, v, bt, offs)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=H != KV)),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


# Lanes this deep (a prefill chunk's offset, a decode lane's length)
# average over 1000+ keys, so their outputs are ~0.03 in size and the
# absolute bf16 limit (2e-2) cannot see a fault confined to their pages.
# They are held at their own limit, relative to their largest plain value:
# 2^-7 of it, twice the bf16 output rounding (at most 2^-8 of a value, 7
# stored mantissa bits), leaving room for the bf16 P. A planted fault (one
# visible page of the deepest lane swapped for a page outside every table;
# for a dense cache one 16-row tile of it overwritten with another lane's
# rows) must read above that limit.
DEEP_OFFSET = 1000
DEEP_TOL = 2.0**-7


def deep_lane_check(depth, out, want, faulted) -> dict:
    """``depth`` [B]: each lane's offset (prefill) or length (decode);
    ``faulted``: the kernel's output on the same operands with the planted
    fault (``page_swapped``, ``tile_overwritten``)."""
    lanes = depth >= DEEP_OFFSET
    scale = want[lanes].abs().max().item()
    rel = lambda got: (got[lanes].float() - want[lanes]).abs().max().item() / scale  # noqa: E731
    fault = rel(faulted)
    sound = rel(out)
    if not (sound <= DEEP_TOL < fault):
        raise AssertionError(f"deep lanes (depth >= {DEEP_OFFSET}): error {sound:.3g} and "
                             f"planted-fault error {fault:.3g} of their scale {scale:.3g}, "
                             f"limit {DEEP_TOL:.3g} between them expected")
    return {"deep_rel_err": sound, "deep_fault_rel_err": fault, "deep_scale": scale}


def scan_operands(B, S, Din, N, with_h0, gen):
    """fp32 operands as ``mamba_block`` forms them: dt a softplus
    (positive), A = -exp(.) (negative)."""
    rand = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")  # noqa: E731
    x, dt = rand(B, S, Din), F.softplus(rand(B, S, Din))
    Bm, Cm = rand(B, S, N), rand(B, S, N)
    A = -torch.exp(0.5 * rand(Din, N))
    h0 = rand(B, Din, N) if with_h0 else None
    return x, dt, Bm, Cm, A, h0


def scan_bound(B, S, Din, N, with_h0):
    """(bound ms, what bounds it, bytes ms, fp32 ms, SFU ms) of one scan.
    Bytes: x, dt, B, C, A (and h0) read once, y and h_final written once.
    Operations per (b, t, d, n): one exp on the SFUs; dt * A, a * h, + b,
    (dt x) * B, h * C and the sum over n on the fp32 lanes; plus dt * x
    per (b, t, d)."""
    n_state = B * Din * N
    scan_bytes = 4 * (3 * B * S * Din + 2 * B * S * N + Din * N + (2 if with_h0 else 1) * n_state)
    bytes_ms = scan_bytes / HBM_BYTES_PER_S * 1e3
    fp32_ms = B * S * Din * (6 * N + 1) / PEAK_FLOPS[torch.float32] * 1e3
    sfu_ms = B * S * Din * N / SFU_PER_S * 1e3
    b_ms, b_by = max((bytes_ms, "bytes"), (max(fp32_ms, sfu_ms), "operations"))
    return b_ms, b_by, bytes_ms, fp32_ms, sfu_ms


def scan_case(B, S, Din, N, with_h0, gen):
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_ref

    ops = scan_operands(B, S, Din, N, with_h0, gen)
    y, h = selective_scan(*ops)
    torch.cuda.synchronize()
    want_y, want_h = selective_scan_ref(*ops)
    errs = [(got - want).abs().max().item() for got, want in ((y, want_y), (h, want_h))]
    scales = [want.abs().max().item() for want in (want_y, want_h)]
    finite = bool(torch.isfinite(y).all() and torch.isfinite(h).all())
    b_ms, b_by, bytes_ms, fp32_ms, sfu_ms = scan_bound(B, S, Din, N, with_h0)
    return {
        "out_scale": scales[0],
        "bytes_ms": bytes_ms,
        "fp32_ms": fp32_ms,
        "sfu_ms": sfu_ms,
        "shape": f"B={B} S={S} Din={Din} N={N} h0={'given' if with_h0 else 'zero'}",
        "dtype": "float32",
        "max_abs_err": max(errs) if finite else float("inf"),
        # y and h_final each within TOL of max(1, its plain value's magnitude).
        "max_rel_err": max(e / max(1.0, m) for e, m in zip(errs, scales)) if finite
        else float("inf"),
        "tol": TOL[torch.float32],
        "ms": time_ms(lambda: selective_scan(*ops)),
        "plain_ms": time_ms(lambda: selective_scan_ref(*ops)),
        "library_ms": None,
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


def rmsnorm_case(R, D, dtype, gen):
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref

    x = (2.0 * torch.randn(R, D, generator=gen, device="cuda")).to(dtype)
    w = (1.0 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(dtype)
    out = rmsnorm(x, w)
    torch.cuda.synchronize()
    err = (out.float() - rmsnorm_ref(x.float(), w.float())).abs().max().item()
    rms_norm = getattr(F, "rms_norm", None)
    item = x.element_size()
    b_ms, b_by = bound(2 * x.numel() * item + D * w.element_size(), 4 * R * D, dtype)
    return {
        "shape": f"R={R} D={D}",
        "dtype": str(dtype).removeprefix("torch."),
        "max_abs_err": err,
        "tol": TOL[dtype],
        "ms": time_ms(lambda: rmsnorm(x, w)),
        "plain_ms": time_ms(lambda: rmsnorm_ref(x, w)),
        "library_ms": time_ms(lambda: rms_norm(x, (D,), w, 1e-6)) if rms_norm else None,
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


SERVE_LENGTHS = [9, 40, 77, 128, 150, 200, 231, 256]  # 8 lanes, max_len 256
LONG_LENGTHS = [100, 1000, 2500, 4096]  # a long cache's lanes, B=4, S=4096
# (H, KV, D) of the long dense-decode cases: stablelm (MHA), phi4-mini's
# packing (G=3), qwen2.5 (G=5) and granite (MQA, G=48).
LONG_DECODE_HEADS = [(32, 32, 64), (24, 8, 128), (40, 8, 128), (48, 1, 128)]
# rmsnorm: 4 x 128 rows of stablelm / falcon-mamba widths, a ragged row
# count, and one 4096-token falcon-mamba prompt (d_model 4096).
RMSNORM_SHAPES = [(4 * 128, 4096), (4 * 128, 2048), (77, 4096), (4096, 4096)]
SCAN_LONG_S = 4096
PREFILL_OFFSETS = [0, 16, 32, 45, 64, 100, 150, 224]  # C=32 chunks, ragged
LONG_PREFIX_OFFSETS = [0, 1000, 2500, 3968]  # C=128 chunks over prefixes up to 4096
VERIFY_OFFSETS = [0, 9, 40, 77, 128, 150, 200, 250]  # k + 1 = 5 positions, max_len 256
DENSE_VIEW_OFFSETS = [0, 40, 96, 120]  # C=32 chunks; 120 + 32 runs past L = 128 / 133
# Phase 10's draft (stablelm-1.6b, max_len 256, k = 4, a cache of 261 rows):
# its ingests (C = k + 1 = 5, offsets below 256) and its greedy steps
# (lengths up to 255 + 4).
DRAFT_INGEST_OFFSETS = [0, 9, 40, 77, 128, 150, 200, 255]
DRAFT_LENGTHS = [9, 40, 77, 128, 150, 200, 231, 259]
# (H, KV, D) of the speculative verify cases: qwen2.5 (G=5) and granite (G=48).
VERIFY_HEADS = [(40, 8, 128), (48, 1, 128)]
# Phase 13's hymba-1.5b: its window, max_len, the lengths of a ring's lanes
# (fresh, half full, full after the wrap) and of the global cache's (the
# 1100..1400-token prompts plus their tokens).
HYMBA_WINDOW, HYMBA_MAX_LEN = 1024, 1536
HYMBA_RING_LENGTHS = [1, 513, 1024, 1024]
HYMBA_GLOBAL_LENGTHS = [1101, 1201, 1301, 1408]
HYMBA_PROMPTS = (1100, 1200, 1300, 1400)
# (H, KV, D) of the MoE phases' attention: granite-moe-1b-a400m (G=2, half
# of a decode block's 4 packed query heads), qwen3-moe-30b-a3b (G=8, two
# full blocks) and phi4-mini-3.8b served as a target (G=3).
GRANITE_MOE_HEADS, QWEN3_MOE_HEADS, PHI4_HEADS = (16, 8, 64), (32, 4, 128), (24, 8, 128)
# (H, KV, D) of the encoder-decoders (phases 18-19): paper-block (100 heads
# of 8) and seamless-m4t-large-v2 (16 of 64); seamless's served prompt and
# frames (a 25 s utterance at 40 Hz), and the JAX package's encoder length
# of its decode cells (a ~100 s utterance).
PAPER_HEADS, SEAMLESS_HEADS = (100, 100, 8), (16, 16, 64)
SEAMLESS_PROMPT, SEAMLESS_FRAMES, ENC_LEN_DECODE = 8, 1000, 4096
# internvl2-76b (phase 20): 64 / 8 heads of 128, 1100-token prompts whose
# first 1024 positions are patches.
VLM_HEADS, VLM_PROMPT = (64, 8, 128), 1100


def check_kernels() -> dict[str, list[dict]]:
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash, decode, pdec, ppre, norm = [], [], [], [], []
    for dtype in (torch.bfloat16, torch.float32):
        for B in (1, 2, 3, 4):
            for S in (8, 128):
                flash.append(flash_case(B, S, 32, 32, 64, dtype, gen))
        flash.append(flash_case(1, 4096, 32, 32, 64, dtype, gen))
        flash.append(flash_case(1, 4096, 24, 8, 128, dtype, gen))
        decode.append(decode_case(4, 128, 32, 32, 64, [9, 40, 77, 128], dtype, gen))
        for H, KV, D in LONG_DECODE_HEADS[:2]:
            decode.append(decode_case(4, 4096, H, KV, D, LONG_LENGTHS, dtype, gen))
        for int8 in (False, True):
            pdec.append(paged_decode_case(8, 16, 32, 32, 64, SERVE_LENGTHS, dtype, int8, gen))
            pdec.append(paged_decode_case(4, 16, 24, 8, 128, LONG_LENGTHS, dtype, int8, gen))
            ppre.append(paged_prefill_case(8, 32, 16, 32, 32, 64, PREFILL_OFFSETS,
                                           dtype, int8, gen))
        # int8 whole-prompt prefill: one whole-length chunk at offset 0.
        ppre.append(paged_prefill_case(2, 120, 16, 32, 32, 64, [0, 0], dtype, True, gen))
        for R, D in RMSNORM_SHAPES:
            norm.append(rmsnorm_case(R, D, dtype, gen))
    # bf16 on the tensor cores: the 64-row tile edges, the GQA / MQA row
    # packings (qwen2.5 G=5, granite G=48) and a long paged prefix.
    for S in (1, 63, 64, 65, 129):
        flash.append(flash_case(2, S, 32, 32, 64, torch.bfloat16, gen))
    flash.append(flash_case(2, 1000, 40, 8, 128, torch.bfloat16, gen))
    flash.append(flash_case(1, 512, 48, 1, 128, torch.bfloat16, gen))
    # Dense decode: the same packings over a long cache, and the serving
    # shape with nothing to read (the call's fixed cost).
    for H, KV, D in LONG_DECODE_HEADS[2:]:
        decode.append(decode_case(4, 4096, H, KV, D, LONG_LENGTHS, torch.bfloat16, gen))
    decode.append(decode_case(4, 128, 32, 32, 64, [0] * 4, torch.bfloat16, gen))
    # The served shapes of phases 9 and 10: granite's decode (G=48, max_len
    # 128) and the draft's steps over its 261-row cache.
    decode.append(decode_case(4, 128, 48, 1, 128, [9, 40, 77, 128], torch.bfloat16, gen))
    decode.append(decode_case(8, 261, 32, 32, 64, DRAFT_LENGTHS, torch.bfloat16, gen))
    # hymba's served shapes (phase 13; H=25, KV=5: G=5, D=64): a 1300-token
    # prefill through the window-1024 class and through the global class;
    # decode over a 1024-row ring (a fresh lane, one half full, two full
    # after the wrap) and over the 1536-row global cache.
    flash.append(flash_case(1, 1300, 25, 5, 64, torch.bfloat16, gen, window=HYMBA_WINDOW))
    flash.append(flash_case(1, 1300, 25, 5, 64, torch.bfloat16, gen))
    decode.append(decode_case(4, HYMBA_WINDOW, 25, 5, 64, HYMBA_RING_LENGTHS, torch.bfloat16,
                              gen, window=HYMBA_WINDOW))
    decode.append(decode_case(4, HYMBA_MAX_LEN, 25, 5, 64, HYMBA_GLOBAL_LENGTHS, torch.bfloat16,
                              gen))
    for int8 in (False, True):
        ppre.append(paged_prefill_case(4, 128, 16, 24, 8, 128, LONG_PREFIX_OFFSETS,
                                       torch.bfloat16, int8, gen))
        # A speculative verify (k = 4) at qwen2.5's and granite's packings.
        for H, KV, D in VERIFY_HEADS:
            ppre.append(paged_prefill_case(8, 5, 16, H, KV, D, VERIFY_OFFSETS,
                                           torch.bfloat16, int8, gen))
    # Dense chunks: granite's cache (max_len 128) and a stablelm draft cache
    # of max_len + k + 1 = 133 rows, in bf16 and in fp32 (the parity path).
    for dtype in (torch.bfloat16, torch.float32):
        ppre.append(dense_view_case(4, 32, 128, 48, 1, 128, DENSE_VIEW_OFFSETS, dtype, gen))
        ppre.append(dense_view_case(4, 32, 133, 32, 32, 64, DENSE_VIEW_OFFSETS, dtype, gen))
    # Phase 10's draft ingest, the route's most launched shape.
    ppre.append(dense_view_case(8, 5, 261, 32, 32, 64, DRAFT_INGEST_OFFSETS, torch.bfloat16, gen))
    # The MoE phases' packings (15-16), bf16 at their served shapes:
    # granite-moe's whole prompts, dense decode, paged decode and 32-token
    # chunks; qwen3-moe's whole prompts (a speculative server prefills
    # whole), paged decode and verify (k = 4), and a long decode cache;
    # phi4-mini's paged decode and chunks as a target, and its dense draft
    # steps and ingests over qwen3-moe's 261-row draft cache.
    bf16 = torch.bfloat16
    flash.append(flash_case(2, 120, *GRANITE_MOE_HEADS, bf16, gen))
    flash.append(flash_case(1, 200, *QWEN3_MOE_HEADS, bf16, gen))
    decode.append(decode_case(4, 128, *GRANITE_MOE_HEADS, [9, 40, 77, 128], bf16, gen))
    decode.append(decode_case(4, 4096, *QWEN3_MOE_HEADS, LONG_LENGTHS, bf16, gen))
    decode.append(decode_case(8, 261, *PHI4_HEADS, DRAFT_LENGTHS, bf16, gen))
    for heads in (GRANITE_MOE_HEADS, QWEN3_MOE_HEADS, PHI4_HEADS):
        for int8 in (False, True):
            pdec.append(paged_decode_case(8, 16, *heads, SERVE_LENGTHS, bf16, int8, gen))
    for int8 in (False, True):
        ppre.append(paged_prefill_case(8, 32, 16, *GRANITE_MOE_HEADS, PREFILL_OFFSETS, bf16,
                                       int8, gen))
    ppre.append(paged_prefill_case(8, 5, 16, *QWEN3_MOE_HEADS, VERIFY_OFFSETS, bf16, False, gen))
    ppre.append(paged_prefill_case(8, 32, 16, *PHI4_HEADS, PREFILL_OFFSETS, bf16, False, gen))
    ppre.append(dense_view_case(8, 5, 261, *PHI4_HEADS, DRAFT_INGEST_OFFSETS, bf16, gen))
    # The encoder-decoders (phases 18-19): paper-block's 100 heads of 8 at
    # the paper's input (64 x 16 frames; its encoder and its cross-attention
    # are one shape, bidirectional, and its decoder prompt is causal) and its
    # decode over a 32-row self cache (16 prompt + 16 tokens) and its 16-row
    # cross cache; seamless's cross-attention (16 heads of 64, 8 decoder
    # tokens against 1000 frames) and its cross decode over 1000 rows and
    # over ENC_LEN_DECODE rows. internvl2-76b's 1100-token prefill (phase 20,
    # 64 / 8 heads of 128).
    for dtype in (torch.bfloat16, torch.float32):
        flash.append(flash_case(64, 16, *PAPER_HEADS, dtype, gen, causal=False,
                                label="paper-block encoder / cross"))
        flash.append(flash_case(64, 16, *PAPER_HEADS, dtype, gen, label="paper-block prompt"))
        flash.append(flash_case(4, SEAMLESS_PROMPT, *SEAMLESS_HEADS, dtype, gen,
                                Skv=SEAMLESS_FRAMES, causal=False, label="seamless cross"))
        decode.append(decode_case(64, 32, *PAPER_HEADS, [16 + i % 17 for i in range(64)], dtype,
                                  gen, label="paper-block self"))
        decode.append(decode_case(64, 16, *PAPER_HEADS, [16] * 64, dtype, gen,
                                  label="paper-block cross"))
    for S in (SEAMLESS_FRAMES, ENC_LEN_DECODE):
        decode.append(decode_case(4, S, *SEAMLESS_HEADS, [S] * 4, bf16, gen,
                                  label="seamless cross"))
    flash.append(flash_case(2, VLM_PROMPT, *VLM_HEADS, bf16, gen, label="internvl2 prompt"))
    # falcon-mamba's serving prefill; its served short prefills (8-token
    # arrivals, B = 1..4 lanes) and a 120-token prompt; hymba's width,
    # ragged, with a state; long.
    scan = [scan_case(4, 128, 8192, 16, False, gen)]
    scan += [scan_case(B, 8, 8192, 16, False, gen) for B in (1, 2, 3, 4)]
    scan += [scan_case(1, 120, 8192, 16, False, gen), scan_case(3, 77, 3200, 16, True, gen),
             scan_case(1, SCAN_LONG_S, 8192, 16, False, gen)]
    scan.append(scan_case(1, 1300, 3200, 16, False, gen))  # hymba's 1300-token prefill
    results = {"flash_attention": flash, "decode_attention": decode,
               "paged_decode_attention": pdec, "paged_prefill_attention": ppre,
               "selective_scan": scan, "rmsnorm": norm}
    for name, cases in results.items():
        for c in cases:
            if "gather_sdpa_ms" in c:
                yard = f"gather+sdpa {c['gather_sdpa_ms']:.4f} ms" + (
                    f" dense decode {c['dense_decode_ms']:.4f} ms" if "dense_decode_ms" in c
                    else "")
            elif c["library_ms"] is not None:
                yard = f"library {c['library_ms']:.4f} ms"
            else:
                yard = "library none"
            if "bytes_ms" in c:
                yard += (f" (bytes {c['bytes_ms']:.4f} ms, fp32 {c['fp32_ms']:.4f} ms, exp on "
                         f"the SFUs {c['sfu_ms']:.4f} ms; max|y| {c['out_scale']:.4g}, "
                         f"err / max(1, scale) {c['max_rel_err']:.3g})")
            if "deep_rel_err" in c:
                yard += (f" (deep lanes: err {c['deep_rel_err']:.3g}, planted fault "
                         f"{c['deep_fault_rel_err']:.3g} of their scale {c['deep_scale']:.3g}; "
                         f"limit {DEEP_TOL:.3g})")
            if "fp32_cuda_core_ms" in c:
                yard += f" (fp32 on the CUDA cores {c['fp32_cuda_core_ms']:.4f} ms)"
            print(f"  {name} {c['dtype']} {c['shape']}: err {c['max_abs_err']:.3g} "
                  f"kernel {c['ms']:.4f} ms plain {c['plain_ms']:.4f} ms {yard} "
                  f"bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
    bad = [(n, c) for n, cs in results.items() for c in cs
           if not c.get("max_rel_err", c["max_abs_err"]) <= c["tol"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    return results


def kernel_report(info) -> dict[str, dict]:
    """Per kernel instantiation, by readable name: ptxas' registers, spill
    bytes and static shared memory (from the build log), and the HGMMA
    (wgmma), HMMA (mma.sync) and MUFU.EX2 instructions in its SASS."""
    from repro_torch.kernels import _build

    bin_dir = Path(_build._nvcc()).parent
    report: dict[str, dict] = {}
    fn = None
    for line in info.log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            fn = m.group(1)
            report[fn] = {}
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            report[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            report[fn].update(registers=int(m.group(1)),
                              static_smem=int(smem.group(1)) if smem else 0)
    for name, counts in _build.sass_mma_counts(info.path).items():
        report.setdefault(name, {}).update(counts)
    names = sorted(report)
    readable = subprocess.run([str(bin_dir / "cu++filt")], input="\n".join(names),
                              capture_output=True, text=True, check=True,
                              timeout=60).stdout.splitlines()
    assert len(readable) == len(names), (len(readable), len(names))
    short = [re.search(r"(\w+(?:<[^<>]*>)?)\(", r) for r in readable]
    return {(m.group(1) if m else r): report[n] for n, r, m in zip(names, readable, short)}


def on_device(tree, device: torch.device) -> bool:
    return all(t.device.type == device.type for t in _leaves(tree))


def serve(params, model, device: torch.device, n_groups: int = 3) -> tuple[dict, dict]:
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import attention
    from repro_torch.serving import PipelineServer

    server = PipelineServer(model, params, n_groups=n_groups, n_replicas=3, max_batch=4,
                            max_len=128, async_depth=2, seed=0, device=device)
    flash_attention.launches = 0
    decode_attention.launches = 0
    rng = np.random.default_rng(1)
    V = model.cfg.vocab_size
    t0 = time.perf_counter()
    # Each served decode call's shapes and its lengths tensor, which a decode
    # step makes anew and never writes again (models/transformer.py); read
    # after the run, so recording adds no work on the card.
    key = lambda q, k, v, lens, **_: (tuple(q.shape), tuple(k.shape), lens)  # noqa: E731
    with calls_recorded(attention, "decode_attention", key) as calls:
        direct = [server.submit(rng.integers(0, V, size=L), n_tokens=8)
                  for L in (64, 88, 104, 120)]
        stats = server.run(60, arrival_p=0.5)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    served = collections.Counter((q, k, tuple(lens.tolist())) for q, k, lens in calls)
    hist = collections.Counter()
    for (q, _, lens), n in served.items():
        hist[q[0], max(lens)] += n
    print("  decode_attention calls by (lanes, longest length): "
          + ", ".join(f"({B}, {L}): {n}" for (B, L), n in sorted(hist.items())))
    print(f"  slots={stats.slots} submitted={stats.submitted} completed={stats.completed_jobs} "
          f"tokens={stats.tokens_generated} prefill_calls={stats.prefill_calls} "
          f"decode_calls={stats.decode_calls} downtime={stats.downtime_fraction:.4f} "
          f"wall_s={wall:.3f} tokens_per_s={stats.tokens_generated / wall:.2f} "
          f"peak_gb={peak_gb():.2f}")
    print(f"  launches {launches}; direct prompts generated "
          f"{[len(r.generated) if r is not None else None for r in direct]}")
    assert stats.completed_jobs >= 1, "no request completed"
    assert stats.tokens_generated > 0, "no token generated"
    assert all(0 <= t < V for r in direct if r is not None for t in r.generated)
    if device.type == "cuda":
        assert all(n > 0 for n in launches.values()), f"a kernel never ran: {launches}"
    assert all(on_device(p, device) for p in server._placed.values()), \
        "a parameter is off the card"
    assert all(on_device(c, device) for c in server._caches.values()), \
        "a cache tensor is off the card"
    return launches, {"served_calls_by_lanes_and_length": {
        f"{B},{L}": n for (B, L), n in sorted(hist.items())},
        "tokens": stats.tokens_generated, "wall_s": wall,
        "tokens_per_s": stats.tokens_generated / wall, "peak_gb": peak_gb(),
        **served_decode_times(served, model.cfg.compute_dtype)}


def served_decode_times(served: collections.Counter, dtype) -> dict:
    """The dense-decode kernel timed at each served call's shapes and
    lengths (random caches and queries), and the sums over the served calls
    of its time and of its bound. A served key is (q shape, cache shape,
    lengths) or, with the call's window (0 for none), (..., window)."""
    from repro_torch.kernels.decode_attention import decode_attention

    gen = torch.Generator(device="cuda").manual_seed(6)
    total = total_bound = 0.0
    operands = {}
    for (q_shape, k_shape, lengths, *window), n in sorted(served.items()):
        B, _, H, D = q_shape
        _, S, KV, _ = k_shape
        window = window[0] if window and window[0] else None  # 0: no window
        if (q_shape, k_shape) not in operands:
            operands[q_shape, k_shape] = [
                torch.randn(*shape, generator=gen, device="cuda").to(dtype)
                for shape in (q_shape, k_shape, k_shape)]
        q, kc, vc = operands[q_shape, k_shape]
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        total += n * time_ms(lambda: decode_attention(q, kc, vc, lens, window=window))
        total_bound += n * decode_bound(q, sum(min(max(x, 0), S) for x in lengths), KV, D)[0]
    n_calls = sum(served.values())
    print(f"  decode_attention at the served lengths: {total:.3f} ms over {n_calls} calls "
          f"({len(served)} distinct), bound {total_bound:.3f} ms")
    return {"served_ms": total, "served_bound_ms": total_bound, "served_calls": n_calls}


PAGED_KERNELS = ("paged_decode_attention", "paged_prefill_attention")


def serve_paged(params, model, device: torch.device, kv_dtype,
                n_slots: int = 60) -> tuple[dict, dict]:
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention, paged_prefill_attention)
    from repro_torch.models import attention
    from repro_torch.serving import PipelineServer

    server = PipelineServer(model, params, n_groups=3, n_replicas=3, paged=True, page_size=16,
                            max_pages=32, max_batch=8, max_len=256, prefill_chunk=32,
                            kv_dtype=kv_dtype, async_depth=2, seed=0, device=device)
    paged_decode_attention.launches = 0
    paged_prefill_attention.launches = 0
    rng = np.random.default_rng(1)
    V = model.cfg.vocab_size
    t0 = time.perf_counter()
    # Each served decode call's shapes and its lengths tensor, which a decode
    # step makes anew and never writes again (models/attention.py); read
    # after the run, so recording adds no work on the card.
    key = lambda q, k, v, bt, lens, **_: (  # noqa: E731
        tuple(q.shape), tuple(k.shape), bt.shape[1], lens)
    with calls_recorded(attention, "paged_decode_attention", key) as calls:
        direct = [server.submit(rng.integers(0, V, size=L), n_tokens=8)
                  for L in (64, 112, 160, 200)]
        stats = server.run(n_slots, arrival_p=0.5)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_decode_attention": paged_decode_attention.launches,
                "paged_prefill_attention": paged_prefill_attention.launches}
    served = collections.Counter((q, k, nb, tuple(lens.tolist())) for q, k, nb, lens in calls)
    hist = collections.Counter()
    for (q, k, _, lens), n in served.items():
        hist[q[0], -(-max(lens) // k[1])] += n
    print("  paged_decode_attention calls by (lanes, longest length in pages): "
          + ", ".join(f"({B}, {pg}): {n}" for (B, pg), n in sorted(hist.items())))
    print(f"  kv_dtype={kv_dtype or 'bf16'}: slots={stats.slots} submitted={stats.submitted} "
          f"completed={stats.completed_jobs} queued={stats.queued_jobs} "
          f"preempted_jobs={stats.preempted_jobs} tokens={stats.tokens_generated} "
          f"chunk_prefill_calls={stats.chunk_prefill_calls} decode_calls={stats.decode_calls} "
          f"downtime={stats.downtime_fraction:.4f} wall_s={wall:.3f} "
          f"tokens_per_s={stats.tokens_generated / wall:.2f} peak_gb={peak_gb():.2f}")
    print(f"  launches {launches}; direct prompts generated "
          f"{[len(r.generated) if r is not None else None for r in direct]}")
    assert stats.tokens_generated > 0, "no token generated"
    assert all(0 <= t < V for r in direct if r is not None for t in r.generated)
    assert all(n > 0 for n in launches.values()), f"a paged kernel never ran: {launches}"
    tables = [mgr.device_block_table() for mgr in server.managers.values()]
    assert all(on_device(c, device) for c in server._caches.values()), "a pool is off the card"
    assert all(t.device.type == "cuda" and t.dtype == torch.int32 for t in tables), \
        "a block table is off the card"
    if kv_dtype == "int8":
        assert all(c["k"].dtype == torch.int8 and "v_scale" in c
                   for pools in server._caches.values() for c in pools)
    for mgr in server.managers.values():
        mgr.check_conservation()
    return launches, {"served_calls_by_lanes_and_pages": {
        f"{B},{pg}": n for (B, pg), n in sorted(hist.items())},
        **served_paged_times(served, model.cfg.compute_dtype, kv_dtype == "int8")}


def served_paged_times(served: collections.Counter, dtype, int8: bool) -> dict:
    """The paged-decode kernel timed at each served call's shapes and
    lengths (random pools and queries, a shuffled block table), and the
    sums over the served calls of its time and of its bound."""
    from repro_torch.kernels.decode_attention import paged_decode_attention

    gen = torch.Generator(device="cuda").manual_seed(5)
    total = total_bound = 0.0
    operands = {}
    for (q_shape, k_shape, NB, lengths), n in sorted(served.items()):
        B, _, H, D = q_shape
        _, page, KV, _ = k_shape
        if (q_shape, k_shape, NB) not in operands:
            operands[q_shape, k_shape, NB] = (
                paged_operands(B, NB, page, KV, D, dtype, int8, gen),
                torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype))
        (k, v, ks, vs, bt), q = operands[q_shape, k_shape, NB]
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        total += n * time_ms(lambda: paged_decode_attention(q, k, v, bt, lens, k_scales=ks,
                                                            v_scales=vs))
        rows = sum(min(max(x, 0), NB * page) for x in lengths)
        pages_read = sum(-(-min(max(x, 0), NB * page) // page) for x in lengths)
        total_bound += n * bound(paged_bytes(q, rows, KV, D, k, pages_read) + 4 * B,
                                 4 * H * D * rows, dtype)[0]
    n_calls = sum(served.values())
    print(f"  paged_decode_attention at the served lengths: {total:.3f} ms over {n_calls} calls "
          f"({len(served)} distinct), bound {total_bound:.3f} ms")
    return {"served_ms": total, "served_bound_ms": total_bound, "served_calls": n_calls}


@contextlib.contextmanager
def calls_recorded(module, name: str, key):
    """Record ``key(*args, **kwargs)`` of every call of ``module.name`` (the
    wrapper still runs and counts its launches) for the duration of the
    block."""
    fn = getattr(module, name)
    calls = []

    def recorded(*args, **kwargs):
        calls.append(key(*args, **kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, recorded)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


# Kernel vs plain on the model's own full-width inputs, relative to the
# output's scale. The random-init model's attention scores reach ~10^2
# (the template's fan-in rule reads the head count, so wq/wk have std
# 1/sqrt(32)); fp32 rounding of such scores is ~1e-4 and softmax mixing of
# near-tied keys carries it into the output, so a bound of 1e-3 of the
# output's scale leaves room for rounding and none for a wrong result.
MODEL_REL_TOL = 1e-3


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@contextlib.contextmanager
def compared_attention(worst: dict[str, float]):
    """Run every attention call through the kernel AND its plain version
    on the same inputs, record the worst relative difference per kernel
    (the paged-prefill kernel's verify and dense-chunk routes apart, as
    ``routes_recorded`` tells them: ``paged_prefill_attention verify``
    ..., calls with a sliding window apart: ``flash_attention windowed``,
    ``decode_attention windowed``, and an encoder-decoder's routes apart,
    as ``attention_route`` tells them: ``flash_attention bidirectional``,
    ``flash_attention cross``, ``decode_attention cross``), and continue with the plain
    output, so the whole forward is the plain-attention reference and each
    comparison sees its exact inputs."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_ref_model, paged_decode_attention_ref, paged_prefill_attention_ref)
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.models import attention

    plain = {
        "flash_attention": flash_attention_ref,
        "decode_attention": decode_attention_ref_model,
        "paged_decode_attention": paged_decode_attention_ref,
        "paged_prefill_attention": paged_prefill_attention_ref,
    }
    kernels = {name: getattr(attention, name) for name in plain}

    def compared(name):
        def call(*args, **kwargs):
            want = plain[name](*args, **kwargs)
            got = kernels[name](*args, **kwargs)
            route = _route[-1] if name == "paged_prefill_attention" else "paged_chunk"
            key = f"{name} {route}" if route != "paged_chunk" else name
            if kwargs.get("window") is not None:
                key += " windowed"
            if _cross[-1] or not kwargs.get("causal", True):
                key += f" {attention_route(name, kwargs)}"
            worst[key] = max(worst.get(key, 0.0), _rel_err(got, want))
            return want
        return call

    for name in plain:
        setattr(attention, name, compared(name))
    try:
        yield
    finally:
        for name, fn in kernels.items():
            setattr(attention, name, fn)


def parity(params, cfg, device: torch.device) -> None:
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.serving import PipelineServer

    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model = build_model(cfg32)
    params32 = tree_map(lambda t: t.float(), params)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, size=64)
    batch = {"tokens": torch.from_numpy(prompt)[None].to(device)}
    worst: dict[str, float] = {}
    with torch.no_grad():
        logits_kernel, _ = model.prefill(params32, batch, 128)
        with compared_attention(worst):
            logits_plain, cache = model.prefill(params32, batch, 128)
            ref_tokens = [int(logits_plain[0, -1].argmax())]
            for _ in range(15):
                tok = torch.tensor([[ref_tokens[-1]]], device=device)
                logits, cache = model.decode_step(params32, tok, cache)
                ref_tokens.append(int(logits[0, -1].argmax()))
    print("  every attention call of a 64-token prefill + 15 decode steps, kernel vs plain "
          "on the same inputs: max|kernel - plain| / max|plain| = "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + f" (tol {MODEL_REL_TOL})")
    assert set(worst) == {"flash_attention", "decode_attention"}, worst
    assert all(v <= MODEL_REL_TOL for v in worst.values()), worst
    end_to_end = (logits_kernel - logits_plain).abs().max().item()
    print(f"  first-token logits, kernel path vs plain path end to end: max diff "
          f"{end_to_end:.3g} of scale {logits_plain.abs().max().item():.3g} (not asserted: "
          "rounding differences flip near-tied keys and grow layer over layer)")
    server = PipelineServer(model, params32, n_groups=3, n_replicas=3, max_batch=4,
                            max_len=128, async_depth=2, seed=0, device=device)
    req = server.submit(prompt, n_tokens=16)
    for _ in range(500):
        if req.done:
            break
        server.step()
    assert req.done, f"the fp32 server did not finish: {len(req.generated)} tokens"
    agree = sum(a == b for a, b in zip(req.generated, ref_tokens))
    print(f"  fp32 server vs plain monolithic greedy: {agree}/16 tokens agree "
          f"(server {req.generated}, plain {ref_tokens})")
    # The server's stage prefills run the monolithic kernel path's operations
    # on the same shapes, so its first token is that path's, exactly.
    assert req.generated[0] == int(logits_kernel[0, -1].argmax())
    paged_parity(params32, model, prompt, device)
    # A paged server without chunking prefills through the same flash
    # kernel into a transient cache, so its first token is that path's too.
    server = PipelineServer(model, params32, n_groups=3, n_replicas=3, max_batch=4,
                            max_len=128, paged=True, async_depth=2, seed=0, device=device)
    req = server.submit(prompt, n_tokens=16)
    for _ in range(500):
        if req.done:
            break
        server.step()
    assert req.done, f"the fp32 paged server did not finish: {len(req.generated)} tokens"
    print(f"  fp32 paged server: first token {req.generated[0]} "
          f"(monolithic kernel path {int(logits_kernel[0, -1].argmax())})")
    assert req.generated[0] == int(logits_kernel[0, -1].argmax())


def paged_parity(params32, model, prompt, device: torch.device) -> None:
    """Teacher-forced: every paged attention call of a chunked prefill of
    the prompt (32-token chunks) and 15 paged decode steps, kernel vs
    plain on the same inputs, on a shuffled block table."""
    cfg = model.cfg
    page, C = 16, 32
    NB = -(-(len(prompt) + 16) // page)
    P = NB + 3
    shape = (cfg.n_layers, P + 1, page, cfg.n_kv_heads, cfg.head_dim)
    pools = {"k": torch.zeros(shape, device=device), "v": torch.zeros(shape, device=device)}
    gen = torch.Generator(device="cuda").manual_seed(3)
    bt = torch.randperm(P, generator=gen, device="cuda")[:NB][None].int()
    worst: dict[str, float] = {}
    ids = torch.from_numpy(prompt).to(device)
    one = lambda x: torch.tensor([x], dtype=torch.int32, device=device)  # noqa: E731
    with torch.no_grad(), compared_attention(worst):
        for pos in range(0, len(prompt), C):
            chunk = ids[pos : pos + C][None]
            out = model.prefill_chunk_paged(params32, chunk, pools, one(pos),
                                            one(chunk.shape[1]), bt)
        tok = int(out[0, -1].argmax())
        for L in range(len(prompt), len(prompt) + 15):
            out = model.decode_paged(params32, torch.tensor([[tok]], device=device), pools,
                                     one(L), bt)
            tok = int(out[0, -1].argmax())
    print("  every paged attention call of a chunked prefill + 15 paged decode steps, kernel "
          "vs plain on the same inputs: max|kernel - plain| / max|plain| = "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + f" (tol {MODEL_REL_TOL})")
    assert set(worst) == set(PAGED_KERNELS), worst
    assert all(v <= MODEL_REL_TOL for v in worst.values()), worst


def serve_ssm(params, model, device: torch.device) -> tuple[dict, dict]:
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.models import ssm
    from repro_torch.serving import PipelineServer

    server = PipelineServer(model, params, n_groups=3, n_replicas=3, max_batch=4,
                            max_len=128, async_depth=2, seed=0, device=device)
    selective_scan.launches = 0
    rng = np.random.default_rng(1)
    V = model.cfg.vocab_size
    t0 = time.perf_counter()
    key = lambda x, dt, Bm, Cm, A: (*x.shape, A.shape[1])  # noqa: E731  (B, S, Din, N)
    with calls_recorded(ssm, "selective_scan", key) as recorded:
        direct = [server.submit(rng.integers(0, V, size=L), n_tokens=8)
                  for L in (64, 88, 104, 120)]
        stats = server.run(60, arrival_p=0.5)
        if device.type == "cuda":
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"selective_scan": selective_scan.launches}
    calls = collections.Counter(recorded)
    print("  selective_scan calls by (B, S): " + ", ".join(
        f"({B}, {S}): {n}" for (B, S, _, _), n in sorted(calls.items(), key=lambda kv: -kv[1])))
    print(f"  slots={stats.slots} submitted={stats.submitted} completed={stats.completed_jobs} "
          f"tokens={stats.tokens_generated} prefill_calls={stats.prefill_calls} "
          f"decode_calls={stats.decode_calls} downtime={stats.downtime_fraction:.4f} "
          f"wall_s={wall:.3f} tokens_per_s={stats.tokens_generated / wall:.2f}")
    print(f"  launches {launches}; direct prompts generated "
          f"{[len(r.generated) if r is not None else None for r in direct]}")
    assert stats.completed_jobs >= 1, "no request completed"
    assert stats.tokens_generated > 0, "no token generated"
    assert all(0 <= t < V for r in direct if r is not None for t in r.generated)
    if device.type == "cuda":
        assert launches["selective_scan"] > 0, f"the selective scan never ran: {launches}"
    assert all(on_device(p, device) for p in server._placed.values()), \
        "a parameter is off the card"
    states = [c["c0"][name] for cache in server._caches.values() for c in cache
              for name in ("conv", "ssm")]
    assert all(t.device.type == device.type for t in states), "a conv / SSM state is off the card"
    assert all(bool(torch.isfinite(t.float()).all()) for t in states), "a state is not finite"
    # One more prefill of a direct prompt on the whole model, outside the
    # counted run: its logits must be finite.
    prompt = torch.from_numpy(rng.integers(0, V, size=(1, 64))).to(device)
    logits, _ = model.prefill(params, {"tokens": prompt}, 64)
    assert bool(torch.isfinite(logits.float()).all()), "falcon-mamba logits are not finite"
    return launches, served_scan_times(calls)


def served_scan_times(calls: collections.Counter) -> dict:
    """The scan kernel timed at each served shape, and the sums over the
    served calls of its time and of its bound."""
    from repro_torch.kernels.selective_scan import selective_scan

    gen = torch.Generator(device="cuda").manual_seed(4)
    shapes, total, total_bound = [], 0.0, 0.0
    for (B, S, Din, N), n in sorted(calls.items()):
        args = scan_operands(B, S, Din, N, False, gen)
        ms = time_ms(lambda: selective_scan(*args))
        b_ms = scan_bound(B, S, Din, N, False)[0]
        shapes.append({"B": B, "S": S, "Din": Din, "N": N, "calls": n, "ms": ms, "bound_ms": b_ms})
        total += n * ms
        total_bound += n * b_ms
    print(f"  selective_scan at the served shapes: {total:.3f} ms over {sum(calls.values())} "
          f"calls (bound {total_bound:.3f} ms); " + ", ".join(
              f"({r['B']}, {r['S']}) x{r['calls']} {r['ms']:.4f} ms" for r in shapes))
    return {"served_shapes": shapes, "served_ms": total, "served_bound_ms": total_bound}


# Kernel vs plain selective scan on the model's own full-width inputs,
# relative to the plain output's scale. The two differ in rounding only
# (fused multiply-adds, the order of the sum over states); 1e-4 leaves
# room for that and none for a wrong result.
SCAN_REL_TOL = 1e-4
# The random-init model echoes its last input token (its tied embedding's
# own logit dominates), so its argmax does not depend on the Mamba layers.
# The end-to-end check therefore holds the logits of the kernel path to
# the plain path's and asks that their difference be at most this share
# of what the scans contribute (the logits moved by zeroing every scan's y).
SSM_EFFECT_SHARE = 1e-2


@contextlib.contextmanager
def scan_replaced(fn):
    """Route every selective-scan call of the SSM blocks through
    ``fn(kernel, *args)`` for the duration of the block."""
    from repro_torch.models import ssm

    kernel = ssm.selective_scan
    ssm.selective_scan = lambda *args: fn(kernel, *args)
    try:
        yield
    finally:
        ssm.selective_scan = kernel


def ssm_parity(params32, model, device: torch.device) -> dict:
    from repro_torch.kernels.selective_scan import selective_scan_ref
    from repro_torch.serving import PipelineServer

    cfg = model.cfg
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, size=64)
    batch = {"tokens": torch.from_numpy(prompt)[None].to(device)}
    worst = {"y": 0.0, "h_final": 0.0, "calls": 0}

    def compared(kernel, *args):
        """Kernel and plain version on the same inputs; go on with the plain."""
        want_y, want_h = selective_scan_ref(*args)
        got_y, got_h = kernel(*args)
        worst["y"] = max(worst["y"], _rel_err(got_y, want_y))
        worst["h_final"] = max(worst["h_final"], _rel_err(got_h, want_h))
        worst["calls"] += 1
        return want_y, want_h

    def zero_y(kernel, *args):
        y, h = kernel(*args)
        return torch.zeros_like(y), h

    with torch.no_grad():
        logits_kernel, _ = model.prefill(params32, batch, 128)
        with scan_replaced(compared):
            logits_plain, cache = model.prefill(params32, batch, 128)
        with scan_replaced(zero_y):
            logits_zero_y, _ = model.prefill(params32, batch, 128)
        # Decode runs no kernel (the O(1) step is plain tensor ops), so the
        # plain path's greedy tokens continue from its own cache.
        ref_tokens = [int(logits_plain[0, -1].argmax())]
        for _ in range(15):
            tok = torch.tensor([[ref_tokens[-1]]], device=device)
            logits, cache = model.decode_step(params32, tok, cache)
            ref_tokens.append(int(logits[0, -1].argmax()))
    print(f"  every selective-scan call of a 64-token prefill ({worst['calls']} calls), kernel "
          f"vs plain on the same inputs: max|kernel - plain| / max|plain| = y {worst['y']:.3g}, "
          f"h_final {worst['h_final']:.3g} (tol {SCAN_REL_TOL})")
    assert worst["calls"] == cfg.n_layers, worst
    assert worst["y"] <= SCAN_REL_TOL and worst["h_final"] <= SCAN_REL_TOL, worst
    scale = logits_plain.abs().max().item()
    end_to_end = (logits_kernel - logits_plain).abs().max().item()
    ssm_effect = (logits_kernel - logits_zero_y).abs().max().item()
    print(f"  first-token logits end to end: max|kernel path - plain path| {end_to_end:.6g}, "
          f"max|kernel path - path with every scan's y zeroed| {ssm_effect:.6g}, scale "
          f"{scale:.6g} (tol {SCAN_REL_TOL} of the scale and {SSM_EFFECT_SHARE} of the "
          f"scans' effect)")
    assert end_to_end <= SCAN_REL_TOL * scale, (end_to_end, scale)
    assert end_to_end <= SSM_EFFECT_SHARE * ssm_effect, (end_to_end, ssm_effect)
    server = PipelineServer(model, params32, n_groups=3, n_replicas=3, max_batch=4,
                            max_len=128, async_depth=2, seed=0, device=device)
    req = server.submit(prompt, n_tokens=16)
    for _ in range(500):
        if req.done:
            break
        server.step()
    assert req.done, f"the fp32 falcon-mamba server did not finish: {len(req.generated)} tokens"
    agree = sum(a == b for a, b in zip(req.generated, ref_tokens))
    print(f"  fp32 falcon-mamba server vs plain monolithic greedy: {agree}/16 tokens agree "
          f"(server {req.generated}, plain {ref_tokens}; last prompt token {int(prompt[-1])}, "
          f"argmax with every scan's y zeroed {int(logits_zero_y[0, -1].argmax())})")
    # The server's stage prefills run the monolithic kernel path's operations
    # on the same shapes, so its first token is that path's, exactly.
    assert req.generated[0] == int(logits_kernel[0, -1].argmax())
    return {"scan_rel_err": {k: worst[k] for k in ("y", "h_final")},
            "logits_end_to_end": end_to_end, "logits_scans_effect": ssm_effect,
            "logits_scale": scale, "greedy_agree": agree}


KERNELS = ("flash_attention", "decode_attention", "paged_decode_attention",
           "paged_prefill_attention", "selective_scan", "rmsnorm")


def kernel_wrappers() -> dict:
    from repro_torch.kernels.decode_attention import (
        decode_attention, paged_decode_attention, paged_prefill_attention)
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_bwd

    return {"flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
            "decode_attention": decode_attention,
            "paged_decode_attention": paged_decode_attention,
            "paged_prefill_attention": paged_prefill_attention,
            "selective_scan": selective_scan, "selective_scan_bwd": selective_scan_bwd,
            "rmsnorm": rmsnorm}


def zero_counters() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counters() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


# The serving paths that launch the paged-prefill kernel, told apart by the
# model entry point running at the launch (the registry's entry points look
# them up in ``transformer`` at call time): a speculative verify, a chunk
# into a dense slot cache (dense chunked prefill, a draft's ingest); any
# other launch is a paged chunk (chunked or int8 whole-prompt prefill).
ROUTE_ENTRIES = {"verify": "verify_step_paged", "dense_chunk": "prefill_chunk"}
_route = ["paged_chunk"]  # the route of the entry point now running


@contextlib.contextmanager
def routes_recorded():
    """Count the paged-prefill kernel's launches by route for the duration
    of the block, into the yielded Counter (complete when the block ends)."""
    from repro_torch.kernels.decode_attention import paged_prefill_attention as kernel
    from repro_torch.models import transformer

    counts = collections.Counter()
    entries = {route: getattr(transformer, fn) for route, fn in ROUTE_ENTRIES.items()}

    def entered(route, fn):
        def call(*args, **kwargs):
            _route.append(route)
            before = kernel.launches
            try:
                return fn(*args, **kwargs)
            finally:
                _route.pop()
                counts[route] += kernel.launches - before
        return call

    start = kernel.launches
    for route, fn in entries.items():
        setattr(transformer, ROUTE_ENTRIES[route], entered(route, fn))
    try:
        yield counts
    finally:
        for route, fn in entries.items():
            setattr(transformer, ROUTE_ENTRIES[route], fn)
        counts["paged_chunk"] = kernel.launches - start - sum(counts.values())


# The paper's calibration (the JAX package's benchmarks/common.py, which
# imports the JAX package): Fig. 2a p = 0.62 on U{7..13}; Fig. 2b harvest
# U{6..10}; Fig. 3/4 fleets of harvest means (6, 8, 10); risk xi_lim 0.01.
FIG2A_P, FIG2A_ARRIVALS = 0.62, (7, 13)
FIG2B_ARRIVALS = (6, 10)
XI_LIM = 0.01
PM_STRATEGIES = {"15W": ((), (1,)), "30W": ((), (2,)), "60W": ((), (3,)),
                 "dynamic": ((40.0, 60.0), (1, 2, 3))}
FIG2B_PAPER = {"15W": 1 / 3, "30W": 1 / 2, "60W": 0.33, "dynamic": 0.64}
SIM_POLICIES = ("uniform", "long_term", "adaptive")
SIM_RUNS = 1000  # the paper's Monte-Carlo repetitions
ANALYTICS_TOL = 1e-9


@contextlib.contextmanager
def no_host_sync():
    """Fail on any CUDA call that waits for the device (a readback)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def card_sweep(label: str, params, n_steps: int, seed: int, cuda: torch.device):
    """One sweep on the card, its step loop under ``no_host_sync``."""
    from repro_torch.core.simulator import SweepResult, build_runner, step_draws

    params = params.to(cuda)
    (S,), (G, N) = params.grid_shape, params.network_shape
    # Two slots first: the first call of each PyTorch op loads its kernels.
    build_runner(G, N, 2)(params, SIM_RUNS, step_draws(
        params, SIM_RUNS, 2, torch.Generator(device=cuda).manual_seed(seed)))
    run = build_runner(G, N, n_steps)
    draws = step_draws(params, SIM_RUNS, n_steps, torch.Generator(device=cuda).manual_seed(seed))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with no_host_sync():
        out = run(params, SIM_RUNS, draws)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    off_card = [name for name, t in out.items() if t.device != params.arrival_lo.device]
    assert not off_card, f"{label}: state off the card: {off_card}"
    rate = n_steps * S * SIM_RUNS / wall
    stats = {"slots": n_steps, "scenarios": S, "runs": SIM_RUNS, "groups": G, "per_group": N,
             "wall_s": wall, "slot_runs_per_s": rate, "peak_gb": peak_gb()}
    print(f"  {label}: {n_steps} slots x {S} scenarios x {SIM_RUNS} runs, G={G} N={N}: "
          f"{wall:.3f} s, {rate:.4g} slot-runs/s, {wall / n_steps * 1e3:.3f} ms/slot, "
          f"peak {stats['peak_gb']:.3f} GB", flush=True)
    res = SweepResult.from_run(out, n_steps)
    in_flight = res.arrivals - res.completed - res.dropped
    assert (in_flight >= 0).all() and (in_flight <= 2 * N).all(), f"{label}: jobs not conserved"
    return res, stats


def fig4_grid(cuda: torch.device):
    """Fig. 4's 21 scenarios (labels, stacked params): harvest means
    m-2 / m / m+2 for m in 4, 6, 8 at p = 0.7, and p in 0.5 .. 1.0 on the
    default fleet, each under the three policies; 300 slots."""
    from repro_torch.core import SimConfig, paper_topology, scenario_params, stack_scenarios

    base = SimConfig(n_groups=3, n_per_group=3, n_steps=300, p_arrival=0.7)
    points = []
    for mean in (4.0, 6.0, 8.0):
        topo = paper_topology(arrival_means=(mean - 2, mean, mean + 2), half_width=2)
        points.append((f"mean_arrival={mean:.0f}", topo, topo.long_term_rates(XI_LIM, cuda), {}))
    topo = paper_topology()
    rates = topo.long_term_rates(XI_LIM, cuda)
    for p in (0.5, 0.65, 0.8, 1.0):
        points.append((f"p={p:.2f}", topo, rates, {"p_arrival": p}))
    labels, grid = [], []
    for label, topo, rates, overrides in points:
        for pol in SIM_POLICIES:
            labels.append(f"{label}/{pol}")
            grid.append(scenario_params(topo, dataclasses.replace(base, policy=pol, **overrides),
                                        long_term_rates=rates))
    return labels, stack_scenarios(grid)


FLEET_SCENARIOS = [(p, pol) for p in (0.4, 0.7, 1.0) for pol in SIM_POLICIES]


def fleet_grid(cuda: torch.device):
    """8 groups x 16 devices (harvest means spread over 4..12, half-width 2,
    dynamic PM, e_max 100, long-term rates at xi_lim 0.01) under the
    three policies at p = 0.4 / 0.7 / 1.0; 1000 slots."""
    from repro_torch.core import (SimConfig, dynamic_policy, paper_topology, scenario_params,
                                  stack_scenarios)

    G, N = 8, 16
    topo = paper_topology(n_groups=G, n_per_group=N, arrival_means=tuple(np.linspace(4, 12, N)),
                          half_width=2, e_max=100, policy=dynamic_policy(100))
    rates = topo.long_term_rates(XI_LIM, cuda)
    return stack_scenarios([
        scenario_params(topo, SimConfig(n_groups=G, n_per_group=N, n_steps=1000, p_arrival=p,
                                        policy=pol), long_term_rates=rates)
        for p, pol in FLEET_SCENARIOS
    ])


def simulator_phase(cuda: torch.device) -> dict:
    """Phase 12: the paper's energy model and network simulator on the card."""
    from repro_torch.core import (DeviceModel, SimConfig, dynamic_policy, fixed_policy, q_lim,
                                  scenario_from_config, simulate_sweep, stack_scenarios,
                                  step_draws, uniform_mdf)

    report = {}
    # (a) Fig. 2a: the four strategies on one device, one sweep.
    strategies = [
        scenario_from_config(
            SimConfig(n_groups=1, n_per_group=1, n_steps=100, p_arrival=FIG2A_P,
                      pm_thresholds=thr, pm_allowed=allowed),
            np.array([[FIG2A_ARRIVALS[0]]]), np.array([[FIG2A_ARRIVALS[1]]]), n_thresholds=2)
        for thr, allowed in PM_STRATEGIES.values()
    ]
    res, report["fig2a"] = card_sweep("(a) fig2a", stack_scenarios(strategies), 100, 0, cuda)
    jobs = dict(zip(PM_STRATEGIES, res.completed.mean(axis=1)))
    down = dict(zip(PM_STRATEGIES, res.downtime_fraction.mean(axis=1)))
    batt = dict(zip(PM_STRATEGIES, res.mean_battery.mean(axis=1)))
    for name in PM_STRATEGIES:
        print(f"    {name}: jobs {jobs[name]:.3f}, battery {batt[name]:.3f}, "
              f"downtime {down[name]:.5f}")
    assert abs(jobs["15W"] - 31) <= 2, jobs
    assert jobs["15W"] < jobs["30W"] <= jobs["dynamic"] + 1.5 <= jobs["60W"] + 3.5, jobs
    assert down["dynamic"] < 1e-3 and down["60W"] > 0.01, down
    assert batt["dynamic"] > batt["60W"], batt
    report["fig2a"]["jobs"] = {k: float(v) for k, v in jobs.items()}

    # (b) Fig. 4: 7 settings x 3 policies, one sweep. The long-term rates
    # solve their chains on the card.
    t0 = time.perf_counter()
    labels, grid = fig4_grid(cuda)
    rates_s = time.perf_counter() - t0
    print(f"  (b) long-term rates of the four fleets on the card: {rates_s:.3f} s")
    res, report["fig4"] = card_sweep("(b) fig4", grid, 300, 0, cuda)
    report["fig4"]["rates_s"] = rates_s
    thr, drops = res.normalized_throughput.mean(axis=1), res.dropped.mean(axis=1)
    for label, t, d in zip(labels, thr, drops):
        print(f"    {label}: throughput {t:.4f}, dropped {d:.3f}")
    assert ((thr > 0) & (thr <= 1)).all(), thr

    # (c) Fig. 2b analytics on the card against the CPU.
    analytics = {}
    for name, pol in (("15W", fixed_policy(1)), ("30W", fixed_policy(2)), ("60W", fixed_policy(3)),
                      ("dynamic", dynamic_policy(100))):
        model = DeviceModel(mdf=uniform_mdf(*FIG2B_ARRIVALS), policy=pol, e_max=100)
        t0 = time.perf_counter()
        if name == "dynamic":
            on_card = 1.0 / model.chain(0.34, cuda).kappa_bar()
            on_cpu = 1.0 / model.chain(0.34, "cpu").kappa_bar()
            what = "1/kappa_bar(0.34)"
        else:
            on_card = q_lim(model, XI_LIM, device=cuda).q_lim
            on_cpu = q_lim(model, XI_LIM, device="cpu").q_lim
            what = "q_lim"
        seconds = time.perf_counter() - t0
        print(f"  (c) {name}: {what} card {on_card!r}, cpu {on_cpu!r}, |diff| "
              f"{abs(on_card - on_cpu):.3e} (paper {FIG2B_PAPER[name]:.3f}); "
              f"card + cpu {seconds:.3f} s")
        assert abs(on_card - on_cpu) <= ANALYTICS_TOL, (name, on_card, on_cpu)
        analytics[name] = {what: on_card, "cpu": on_cpu, "paper": FIG2B_PAPER[name]}
    report["fig2b"] = analytics

    # (d) The card against the CPU on the same draws: the Fig. 4 grid at 64 runs.
    n_runs = 64
    draws = list(step_draws(grid, n_runs, 300, torch.Generator().manual_seed(1)))
    t0 = time.perf_counter()
    cpu_res = simulate_sweep(None, grid, n_runs=n_runs, n_steps=300, device="cpu", draws=draws)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card_res = simulate_sweep(None, grid, n_runs=n_runs, n_steps=300, device=cuda,
                              draws=[d.to(cuda) for d in draws])
    card_s = time.perf_counter() - t0
    for field in ("completed", "dropped", "arrivals", "downtime_fraction"):
        assert np.array_equal(getattr(card_res, field), getattr(cpu_res, field)), field
    battery_rel = float(np.max(np.abs(card_res.mean_battery - cpu_res.mean_battery)
                               / np.abs(cpu_res.mean_battery)))
    assert battery_rel <= 1e-6, battery_rel
    print(f"  (d) card = cpu on shared draws, 21 x {n_runs} runs x 300 slots: counters equal, "
          f"mean battery within {battery_rel:.3e} relative; cpu {cpu_s:.3f} s, card {card_s:.3f} s")
    report["card_vs_cpu"] = {"battery_rel": battery_rel, "cpu_s": cpu_s, "card_s": card_s}

    # (e) A fleet: 8 groups x 16 devices, 9 scenarios, 1000 runs, 1000 slots.
    t0 = time.perf_counter()
    fleet = fleet_grid(cuda)
    rates_s = time.perf_counter() - t0
    print(f"  (e) long-term rates of the 8 x 16 fleet on the card: {rates_s:.3f} s")
    res, report["fleet"] = card_sweep("(e) fleet", fleet, 1000, 0, cuda)
    report["fleet"]["rates_s"] = rates_s
    for i, (p, pol) in enumerate(FLEET_SCENARIOS):
        print(f"    p={p}/{pol}: completed {res.completed[i].mean():.2f}, dropped "
              f"{res.dropped[i].mean():.2f}, downtime {res.downtime_fraction[i].mean():.5f}")
    return report


def load_model(name: str, seed: int, device: torch.device):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, count_params, init_from_template

    cfg = get_config(name)
    model = build_model(cfg)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_from_template(model.template, torch.Generator(device="cuda").manual_seed(seed),
                                cfg.param_dtype, device=device)
    torch.cuda.synchronize()
    load_model.draw_peak_gb = peak_gb()
    print(f"  {name} weights: {count_params(model.template) / 1e9:.3f} B params "
          f"({cfg.param_dtype}, seed {seed}) in {time.perf_counter() - t0:.2f} s, "
          f"peak {load_model.draw_peak_gb:.2f} GB while drawing")
    torch.cuda.reset_peak_memory_stats()  # the phases' peaks: serving, not drawing weights
    return model, params


def free_memory() -> None:
    """Release what earlier phases left: a server and its scheduler refer
    to each other, so its stage weights outlive it until a collection."""
    gc.collect()
    torch.cuda.empty_cache()


def peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def serve_dense_chunked(params, model, device: torch.device) -> tuple[dict, dict]:
    """Phase 9: full-width granite-20b through the dense server with
    32-token chunks."""
    from repro_torch.serving import PipelineServer

    server = PipelineServer(model, params, n_groups=3, n_replicas=3, max_batch=4, max_len=128,
                            prefill_chunk=32, async_depth=2, seed=0, device=device)
    rng = np.random.default_rng(1)
    V = model.cfg.vocab_size
    # Each served chunk launch: (member lanes, the deepest member's offset).
    key = lambda r, jobs, *rest: (len(jobs), max(pos for _, _, _, pos, _ in jobs))  # noqa: E731
    zero_counters()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        calls = [stack.enter_context(calls_recorded(ex, "run_chunks", key)) for ex in server._exec]
        routes = stack.enter_context(routes_recorded())
        direct = [server.submit(rng.integers(0, V, size=L), n_tokens=8)
                  for L in (64, 88, 104, 120)]
        stats = server.run(30, arrival_p=0.5)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = read_counters(), dict(routes)
    hist = collections.Counter((n, f"{off // 32 * 32}-{off // 32 * 32 + 31}")
                               for stage in calls for n, off in stage)
    print("  dense chunk launches by (lanes, deepest offset): " + ", ".join(
        f"({n}, {o}): {c}" for (n, o), c in sorted(hist.items(), key=lambda kv: kv[0])))
    print(f"  slots={stats.slots} submitted={stats.submitted} completed={stats.completed_jobs} "
          f"tokens={stats.tokens_generated} chunk_prefill_calls={stats.chunk_prefill_calls} "
          f"prefill_calls={stats.prefill_calls} decode_calls={stats.decode_calls} "
          f"downtime={stats.downtime_fraction:.4f} wall_s={wall:.3f} "
          f"tokens_per_s={stats.tokens_generated / wall:.2f} peak_gb={peak_gb():.2f}")
    print(f"  launches {launches}; paged_prefill_attention by route {routes}; direct prompts "
          f"generated {[len(r.generated) if r is not None else None for r in direct]}")
    assert stats.completed_jobs >= 1 and stats.tokens_generated > 0
    assert stats.chunk_prefill_calls > 0 and stats.prefill_calls == 0
    assert all(0 <= t < V for r in direct if r is not None for t in r.generated)
    assert routes.get("dense_chunk", 0) > 0 and launches["decode_attention"] > 0, \
        f"a kernel of the dense chunked path never ran: {launches} {routes}"
    assert all(on_device(p, device) for p in server._placed.values()), \
        "a parameter is off the card"
    assert all(on_device(c, device) for c in server._caches.values()), \
        "a cache tensor is off the card"
    return launches, {"routes": routes, "chunk_launches_by_lanes_and_offset": {
        f"{n},{o}": c for (n, o), c in sorted(hist.items())}, "tokens": stats.tokens_generated,
        "wall_s": wall, "peak_gb": peak_gb()}


def serve_spec(params, model, draft, draft_params, device: torch.device) -> tuple[dict, dict]:
    """Phase 10: full-width qwen2.5-14b, paged, verified against its
    registry draft (stablelm-1.6b) at k = 4."""
    from repro_torch.serving import PipelineServer

    server = PipelineServer(model, params, n_groups=3, n_replicas=3, paged=True, page_size=16,
                            max_batch=8, max_len=256, spec_draft=(draft, draft_params), spec_k=4,
                            async_depth=2, seed=0, device=device)
    reqs = []
    submit = server.submit
    server.submit = lambda *a, **kw: reqs.append(submit(*a, **kw)) or reqs[-1]
    rng = np.random.default_rng(1)
    V = model.cfg.vocab_size
    zero_counters()
    t0 = time.perf_counter()
    with routes_recorded() as routes:
        for L in (64, 112, 160, 200):
            server.submit(rng.integers(0, V, size=L), n_tokens=8)
        stats = server.run(30, arrival_p=0.5)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = read_counters(), dict(routes)
    print(f"  slots={stats.slots} submitted={stats.submitted} completed={stats.completed_jobs} "
          f"tokens={stats.tokens_generated} prefill_calls={stats.prefill_calls} "
          f"decode_calls={stats.decode_calls} draft_calls={stats.draft_calls} "
          f"verify_calls={stats.verify_calls} spec_rounds={stats.spec_rounds} "
          f"spec_proposed={stats.spec_proposed} spec_accepted={stats.spec_accepted} "
          f"acceptance_rate={stats.acceptance_rate:.4f} wall_s={wall:.3f} "
          f"tokens_per_s={stats.tokens_generated / wall:.2f} peak_gb={peak_gb():.2f}")
    print(f"  launches {launches}; paged_prefill_attention by route {routes}; plain paged "
          f"decode launches {launches['paged_decode_attention']}")
    done = [r for r in reqs if r is not None and r.done]
    assert done and stats.spec_rounds > 0, "no speculative round finished"
    assert stats.spec_accepted <= stats.spec_proposed
    assert all(len(r.generated) == r.n_tokens for r in done), "a request holds too many tokens"
    assert all(0 <= t < V for r in reqs if r is not None for t in r.generated)
    assert routes.get("verify", 0) > 0 and routes.get("dense_chunk", 0) > 0 \
        and launches["decode_attention"] > 0, \
        f"a kernel of the speculative path never ran: {launches} {routes}"
    assert all(on_device(p, device) for p in server._placed.values()), \
        "a parameter is off the card"
    assert on_device(server._spec.params_for(0), device), "a draft parameter is off the card"
    assert all(on_device(c, device) for c in [*server._caches.values(),
                                              *server._spec.caches.values()]), \
        "a pool or draft cache is off the card"
    for mgr in server.managers.values():
        mgr.check_conservation()
    return launches, {"routes": routes, "spec": {
        name: getattr(stats, name) for name in ("spec_rounds", "spec_proposed", "spec_accepted",
                                                "draft_calls", "verify_calls", "decode_calls")},
        "acceptance_rate": stats.acceptance_rate, "tokens": stats.tokens_generated,
        "wall_s": wall, "peak_gb": peak_gb()}


def spec_parity(params32, model, device: torch.device) -> dict:
    """Phase 11: fp32 stablelm-1.6b drafting for itself (k = 4)."""
    from repro_torch.serving import PipelineServer

    rng = np.random.default_rng(2)
    V = model.cfg.vocab_size
    prompt = rng.integers(0, V, size=64)
    # More requests for the acceptance rate: the random-init model is chaotic
    # under rounding, so a draft token computed by other kernels than the
    # verify's matches it only now and then.
    more = [rng.integers(0, V, size=L) for L in (16, 24, 32, 48, 64, 80, 96)]
    kw = dict(n_groups=3, n_replicas=3, max_batch=4, max_len=128, paged=True, page_size=16,
              async_depth=2, seed=0, device=device)

    def served(extra: dict, prompts) -> tuple:
        server = PipelineServer(model, params32, **kw, **extra)
        reqs = [server.submit(p, n_tokens=16 if i == 0 else 32) for i, p in enumerate(prompts)]
        for _ in range(2000):
            if all(r.done for r in reqs):
                break
            server.step()
        assert all(r.done for r in reqs), "an fp32 server did not finish"
        return server, reqs

    spec_kw = dict(spec_draft=(model, params32), spec_k=4)
    worst: dict[str, float] = {}
    with torch.no_grad():
        with compared_attention(worst), routes_recorded():
            compared, _ = served(spec_kw, [prompt])
        spec, spec_reqs = served(spec_kw, [prompt, *more])
        _, (plain_req,) = served({}, [prompt])
    print("  every attention call of an fp32 speculative server's request (a 64-token prompt, "
          f"16 tokens, {compared.stats.spec_rounds} rounds), kernel vs plain on the same inputs: "
          "max|kernel - plain| / max|plain| = "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + f" (tol {MODEL_REL_TOL})")
    routes = {"paged_prefill_attention verify", "paged_prefill_attention dense_chunk"}
    assert routes <= set(worst), worst
    assert all(v <= MODEL_REL_TOL for v in worst.values()), worst
    st = spec.stats
    first = spec_reqs[0].generated
    agree = sum(a == b for a, b in zip(first, plain_req.generated))
    print(f"  fp32 spec server: first token {first[0]} (plain paged server "
          f"{plain_req.generated[0]}); {agree}/16 tokens agree with the plain paged server; "
          f"{len(spec_reqs)} requests: spec_rounds={st.spec_rounds} proposed={st.spec_proposed} "
          f"accepted={st.spec_accepted} acceptance_rate={st.acceptance_rate:.4f} "
          f"peak_gb={peak_gb():.2f}")
    # Both prefill the prompt the same way (flash into a transient cache).
    assert first[0] == plain_req.generated[0]
    assert st.acceptance_rate > 0, "no draft token was ever accepted"
    return {"attention_rel_err": worst, "acceptance_rate": st.acceptance_rate,
            "spec_rounds": st.spec_rounds, "spec_proposed": st.spec_proposed,
            "spec_accepted": st.spec_accepted, "greedy_agree_with_plain": agree,
            "peak_gb": peak_gb()}


# Phase 14's fp32 parity: a 1100-token prompt (past the window: its ring is
# stored rotated), then 1000 teacher-forced decode steps, so that every
# window layer's write slot passes the ring's end (position 2048) and wraps.
HYBRID_PARITY_PROMPT, HYBRID_PARITY_STEPS, HYBRID_PARITY_MAX_LEN = 1100, 1000, 2176
# A full-width random-init attention model is chaotic under rounding: its
# logits through the kernels and through the plain versions part by O(1)
# at full depth (phase 6; phase 14 prints hymba's), and so do a decode's
# and a prefill's of the same tokens (rounding in another order), while a
# few layers keep them within ~1e-4 of their scale. The logits-level
# checks (kernel vs plain per call, the ring against a fresh prefill, the
# server's first token against the plain path's) therefore run on the
# first HYBRID_CUT layers, one global and two of the window class, at full
# width; the per-kernel-call checks run at full depth.
HYBRID_CUT = 3


@contextlib.contextmanager
def plain_versions():
    """Every kernel the models call replaced by its plain version."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_ref_model, paged_decode_attention_ref, paged_prefill_attention_ref)
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.selective_scan import selective_scan_ref
    from repro_torch.models import attention, ssm

    saved = [(attention, "flash_attention", flash_attention_ref),
             (attention, "decode_attention", decode_attention_ref_model),
             (attention, "paged_decode_attention", paged_decode_attention_ref),
             (attention, "paged_prefill_attention", paged_prefill_attention_ref),
             (ssm, "selective_scan", selective_scan_ref)]
    saved = [(mod, name, getattr(mod, name), plain) for mod, name, plain in saved]
    for mod, name, _, plain in saved:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn, _ in saved:
            setattr(mod, name, fn)


def serve_hybrid(params, model, device: torch.device) -> tuple[dict, dict]:
    """Phase 13: full-width hymba-1.5b through the dense server: windowed
    and full flash prefill, dense decode over 1024-row rings and 1536-row
    global caches, the selective scan."""
    from repro_torch.models import attention, ssm
    from repro_torch.models.transformer import layer_plan
    from repro_torch.serving import PipelineServer

    server = PipelineServer(model, params, n_groups=3, n_replicas=3, max_batch=4,
                            max_len=HYMBA_MAX_LEN, async_depth=2, seed=0, device=device)
    rng = np.random.default_rng(1)
    V = model.cfg.vocab_size
    # Recorded as phase 4 records decode: lengths tensors are read after the
    # run (a decode step makes them anew and never writes them again).
    flash_key = lambda q, k, v, causal=True, window=None: (  # noqa: E731
        "windowed" if window else "full", q.shape[1])
    decode_key = lambda q, k, v, lens, window=None: (  # noqa: E731
        tuple(q.shape), tuple(k.shape), lens, window or 0)
    scan_key = lambda x, dt, Bm, Cm, A: (*x.shape, A.shape[1])  # noqa: E731  (B, S, Din, N)
    zero_counters()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        flash_calls = stack.enter_context(calls_recorded(attention, "flash_attention", flash_key))
        decode_calls = stack.enter_context(calls_recorded(attention, "decode_attention",
                                                          decode_key))
        scan_calls = stack.enter_context(calls_recorded(ssm, "selective_scan", scan_key))
        direct = [server.submit(rng.integers(0, V, size=L), n_tokens=8) for L in HYMBA_PROMPTS]
        stats = server.run(30, arrival_p=0.5)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    routes = collections.Counter(route for route, _ in flash_calls)
    flash_hist = collections.Counter((route, f"{S // 256 * 256}-{S // 256 * 256 + 255}")
                                     for route, S in flash_calls)
    served = collections.Counter((q, k, tuple(lens.tolist()), w) for q, k, lens, w in decode_calls)
    decode_hist = collections.Counter()
    for (q, k, lens, _), n in served.items():
        top = max(lens)
        decode_hist[q[0], k[1], f"{top // 256 * 256}-{top // 256 * 256 + 255}"] += n
    print("  flash_attention calls by (route, prompt length): " + ", ".join(
        f"({r}, {b}): {n}" for (r, b), n in sorted(flash_hist.items())))
    print("  decode_attention calls by (lanes, cache rows, longest length): " + ", ".join(
        f"({B}, {L}, {b}): {n}" for (B, L, b), n in sorted(decode_hist.items())))
    print(f"  slots={stats.slots} submitted={stats.submitted} completed={stats.completed_jobs} "
          f"tokens={stats.tokens_generated} prefill_calls={stats.prefill_calls} "
          f"decode_calls={stats.decode_calls} downtime={stats.downtime_fraction:.4f} "
          f"wall_s={wall:.3f} tokens_per_s={stats.tokens_generated / wall:.2f} "
          f"peak_gb={peak_gb():.2f}")
    print(f"  launches {launches}; flash_attention by route {dict(routes)}; direct prompts "
          f"generated {[len(r.generated) if r is not None else None for r in direct]}")
    assert stats.completed_jobs >= 1 and stats.tokens_generated > 0
    assert all(0 <= t < V for r in direct if r is not None for t in r.generated)
    assert sum(routes.values()) == launches["flash_attention"], (routes, launches)
    assert routes["windowed"] > 0 and routes["full"] > 0, f"a flash route never ran: {routes}"
    assert any(r == "windowed" and S > HYMBA_WINDOW for r, S in flash_calls), \
        "no windowed prefill was longer than the window"
    assert launches["decode_attention"] > 0 and launches["selective_scan"] > 0, launches
    assert launches["rmsnorm"] == 0, f"a served path launched rmsnorm: {launches}"
    assert any(k[1] == HYMBA_WINDOW and HYMBA_WINDOW in lens for _, k, lens, _ in served), \
        "no decode read a full ring"
    assert all(on_device(p, device) for p in server._placed.values()), \
        "a parameter is off the card"
    assert all(on_device(c, device) for c in server._caches.values()), \
        "a cache tensor is off the card"
    for (g, _), (cache,) in server._caches.items():
        for i, cls in enumerate(layer_plan(server.stages[g][0].cfg).classes):
            rows = cache[f"c{i}"]["k"].shape[2]
            assert rows == (HYMBA_MAX_LEN if cls.window is None else HYMBA_WINDOW), (g, i, rows)
    return launches, {
        "flash_launches_by_route": dict(routes),
        "flash_calls_by_route_and_length": {f"{r},{b}": n for (r, b), n in
                                            sorted(flash_hist.items())},
        "decode_calls_by_lanes_rows_and_length": {f"{B},{L},{b}": n for (B, L, b), n in
                                                  sorted(decode_hist.items())},
        "decode": served_decode_times(served, model.cfg.compute_dtype),
        "scan": served_scan_times(collections.Counter(scan_calls)),
        "tokens": stats.tokens_generated, "wall_s": wall,
        "tokens_per_s": stats.tokens_generated / wall, "peak_gb": peak_gb()}


def _first_token(model, params, prompt: np.ndarray, device: torch.device, **kw) -> int:
    """The first token of an fp32 server (G=3 x R=3; by default hymba's:
    max_batch 4, max_len 1536) for one prompt."""
    from repro_torch.serving import PipelineServer

    kw = kw or dict(max_batch=4, max_len=HYMBA_MAX_LEN)
    server = PipelineServer(model, params, n_groups=3, n_replicas=3, async_depth=2, seed=0,
                            device=device, **kw)
    req = server.submit(prompt, n_tokens=2)
    for _ in range(500):
        if req.done:
            break
        server.step()
    assert req.done, f"an fp32 server did not finish: {len(req.generated)} tokens"
    return req.generated[0]


def hybrid_parity(params32, model, device: torch.device) -> dict:
    """Phase 14: fp32 hymba-1.5b, the kernels against their plain versions."""
    from repro_torch.kernels.selective_scan import selective_scan_ref
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import layer_plan

    cfg = model.cfg
    n_prompt, n_steps = HYBRID_PARITY_PROMPT, HYBRID_PARITY_STEPS
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(1, n_prompt + n_steps))).to(device)
    prompt = {"tokens": tokens[:, :n_prompt]}
    worst: dict[str, float] = {}
    scan_worst = {"y": 0.0, "h_final": 0.0, "calls": 0}

    def compared_scan(kernel, *args):
        want_y, want_h = selective_scan_ref(*args)
        got_y, got_h = kernel(*args)
        scan_worst["y"] = max(scan_worst["y"], _rel_err(got_y, want_y))
        scan_worst["h_final"] = max(scan_worst["h_final"], _rel_err(got_h, want_h))
        scan_worst["calls"] += 1
        return want_y, want_h

    # (a) Full depth, teacher-forced per kernel call: every attention and
    # scan call of the prefill and of every decode step runs the kernel and
    # its plain version on the same inputs, and goes on with the plain one.
    t0 = time.perf_counter()
    with torch.no_grad():
        kernel_logits, _ = model.prefill(params32, prompt, HYBRID_PARITY_MAX_LEN)
        with compared_attention(worst), scan_replaced(compared_scan):
            plain_logits, cache = model.prefill(params32, prompt, HYBRID_PARITY_MAX_LEN)
            for t in range(n_prompt, n_prompt + n_steps):
                _, cache = model.decode_step(params32, tokens[:, t:t + 1], cache)
    print(f"  every attention and scan call of a {n_prompt}-token prefill + {n_steps} decode "
          f"steps ({cfg.n_layers} layers), kernel vs plain on the same inputs: max|kernel - "
          "plain| / max|plain| = " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f" (tol {MODEL_REL_TOL}); selective_scan ({scan_worst['calls']} calls) y "
          f"{scan_worst['y']:.3g}, h_final {scan_worst['h_final']:.3g} (tol {SCAN_REL_TOL}); "
          f"{time.perf_counter() - t0:.1f} s")
    assert set(worst) == {"flash_attention", "flash_attention windowed", "decode_attention",
                          "decode_attention windowed"}, worst
    assert all(v <= MODEL_REL_TOL for v in worst.values()), worst
    assert scan_worst["calls"] == cfg.n_layers, scan_worst
    assert scan_worst["y"] <= SCAN_REL_TOL and scan_worst["h_final"] <= SCAN_REL_TOL, scan_worst
    end_to_end = _rel_err(kernel_logits, plain_logits)
    print(f"  first-token logits at full depth, kernel path vs plain path: max diff / scale "
          f"{end_to_end:.3g} (not asserted: rounding grows layer over layer)")
    served_first = _first_token(model, params32, prompt["tokens"][0].cpu().numpy(), device)
    # The server's stage prefills run the monolithic kernel path's operations
    # on the same shapes, so its first token is that path's, exactly.
    print(f"  fp32 server ({cfg.n_layers} layers): first token {served_first} (monolithic kernel "
          f"path {int(kernel_logits[0, -1].argmax())}, plain path "
          f"{int(plain_logits[0, -1].argmax())})")
    assert served_first == int(kernel_logits[0, -1].argmax())

    # (b) The first HYBRID_CUT layers at full width: per call, the kernel
    # path's logits from the plain path's cache against the plain path's;
    # the plain decode past the wrap against a fresh plain prefill of the
    # same tokens; the server's first token against the plain path's.
    cut_cfg = dataclasses.replace(cfg, n_layers=HYBRID_CUT, global_attn_layers=(0,))
    cut = build_model(cut_cfg)
    plan = layer_plan(cut_cfg)
    assert [(c.window, c.layer_ids) for c in plan.classes] == [(None, (0,)),
                                                               (HYMBA_WINDOW, (1, 2))]
    cut_params = {**params32, "classes": {  # hymba's layers 0 (global) and 1, 2 (window)
        f"c{i}": tree_map(lambda a, n=c.count: a[:n], params32["classes"][f"c{i}"])
        for i, c in enumerate(plan.classes)}}
    per_call = []
    with torch.no_grad():
        with plain_versions():
            plain, cache = cut.prefill(cut_params, prompt, HYBRID_PARITY_MAX_LEN)
        kernel, _ = cut.prefill(cut_params, prompt, HYBRID_PARITY_MAX_LEN)
        per_call.append(_rel_err(kernel, plain))
        plain_first = int(plain[0, -1].argmax())
        for t in range(n_prompt, n_prompt + n_steps):
            tok = tokens[:, t:t + 1]
            kernel, _ = cut.decode_step(cut_params, tok, tree_map(torch.clone, cache))
            with plain_versions():
                plain, cache = cut.decode_step(cut_params, tok, cache)
            per_call.append(_rel_err(kernel, plain))
        with plain_versions():
            fresh, _ = cut.prefill(cut_params, {"tokens": tokens}, HYBRID_PARITY_MAX_LEN)
    ring_err = _rel_err(plain, fresh)
    cut_first = _first_token(cut, cut_params, prompt["tokens"][0].cpu().numpy(), device)
    print(f"  first {HYBRID_CUT} layers: logits per call (prefill + {n_steps} steps), kernel vs "
          f"plain from the same cache: max diff / scale {max(per_call):.3g} (tol "
          f"{MODEL_REL_TOL}); plain decode at position {n_prompt + n_steps - 1} vs a fresh "
          f"plain prefill: {ring_err:.3g}; fp32 server's first token {cut_first} (plain path "
          f"{plain_first})")
    assert max(per_call) <= MODEL_REL_TOL, max(per_call)
    assert ring_err <= MODEL_REL_TOL, ring_err
    assert cut_first == plain_first
    return {"attention_rel_err": worst,
            "scan_rel_err": {k: scan_worst[k] for k in ("y", "h_final")},
            "logits_end_to_end_full_depth": end_to_end,
            "cut_logits_per_call_rel_err": max(per_call), "cut_ring_vs_prefill_rel_err": ring_err,
            "peak_gb": peak_gb()}


def hybrid_phase(cuda: torch.device) -> tuple[dict, dict]:
    """Phases 13-14: full-width hymba-1.5b served in bf16, then its fp32
    parity. Returns the kernels' launches in phase 13, and the report."""
    from repro_torch.models import build_model, count_params
    from repro_torch.models.common import tree_map

    print("[13] serve full-width hymba-1.5b, dense, sliding-window rings", flush=True)
    model, params = load_model("hymba-1.5b", 0, cuda)
    print(f"  hymba-1.5b: {count_params(model.template)} parameters")
    with torch.no_grad():
        launches, served = serve_hybrid(params, model, cuda)
    cfg32 = dataclasses.replace(model.cfg, dtype="float32", param_dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    del params, model
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    print("[14] hybrid parity at full width, fp32", flush=True)
    checks = hybrid_parity(params32, build_model(cfg32), cuda)
    del params32
    free_memory()
    return launches, {"served": served, "parity": checks}


# Phase 17's paged fp32 servers: phase 16's layout.
PAGED_KW = dict(paged=True, page_size=16, max_batch=8, max_len=256)
# Phase 17's logits per call, kernel path against plain path, on the first
# MOE_CUT layers of qwen3-moe at full width (PERF.md §7 q5: full depth
# amplifies rounding), and the first served tokens on the same cuts.
MOE_CUT = 3
DISPATCH_TOL = 1e-5  # einsum vs gather dispatch, fp32, of the output's scale


@contextlib.contextmanager
def moe_call_recorded(keep: list):
    """Append to ``keep`` the inputs (x cloned, the layer's weights, cfg)
    of the first MoE call of the block that routes a whole paged chunk or
    verify (one group of W x C tokens) and drops an assignment. The drop
    fractions are read after the block, so recording adds no host sync."""
    from repro_torch.models import transformer

    fn = transformer.moe_ffn
    seen = []

    def recorded(x, p, cfg, *, per_lane=False):
        out, aux = fn(x, p, cfg, per_lane=per_lane)
        if not per_lane and x.shape[1] > 1 and len(seen) < 64:
            seen.append((x.detach().clone(), p, cfg, aux["dropped_frac"]))
        return out, aux

    transformer.moe_ffn = recorded
    try:
        yield
    finally:
        transformer.moe_ffn = fn
    keep.extend([c[:3] for c in seen if float(c[3]) > 0][:1])


@contextlib.contextmanager
def moe_routing(label: str, device: torch.device):
    """Count the assignments the MoE layers route and drop in the block
    into the yielded dict (``moe_ffn``'s counters: the drops are summed on
    the device and read after the block), and print them."""
    from repro_torch.models import moe

    moe.moe_ffn.routed, moe.moe_ffn.dropped = 0, 0
    counts: dict = {}
    yield counts
    routed, dropped = moe.moe_ffn.routed, moe.moe_ffn.dropped
    assert routed > 0 and dropped.device.type == device.type, \
        f"{label}: the MoE layers did not route on the device"
    counts.update(moe_routed=routed, moe_dropped=int(dropped),
                  moe_dropped_frac=int(dropped) / routed)
    print(f"  {label}: MoE assignments routed {routed}, dropped {int(dropped)} "
          f"({counts['moe_dropped_frac']:.4f})")


def moe_dense_phase(cuda: torch.device) -> tuple[dict, dict]:
    """Phase 15: full-width granite-moe-1b-a400m, dense (whole prompts,
    flash + dense decode; phase 4's run) and paged (32-token chunks, bf16
    pages; phase 5's run). Returns each run's launches and report."""
    from repro_torch.models import count_params

    model, params = load_model("granite-moe-1b-a400m", 0, cuda)
    n = count_params(model.template)
    print(f"  granite-moe-1b-a400m: {n} parameters")
    runs = {}
    with torch.no_grad():
        with moe_routing("dense", cuda) as routing:
            launches, served = serve(params, model, cuda)
        runs["granite_moe_dense"] = (launches, {"served": served, **routing})
        with moe_routing("paged", cuda) as routing:
            launches, served = serve_paged(params, model, cuda, None)
        runs["granite_moe_paged"] = (launches, {
            "served": served, "routes": {"paged_chunk": launches["paged_prefill_attention"]},
            **routing})
    del params, model
    free_memory()
    return runs, {"params": n}


def layer_cut(params, cfg, n_layers: int):
    """The first ``n_layers`` layers of a uniform decoder (one layer class),
    with its embeddings and final norm: (cfg, params)."""
    from repro_torch.models.common import tree_map

    cut = {**params, "classes": {"c0": tree_map(lambda a: a[:n_layers],
                                                params["classes"]["c0"])}}
    return dataclasses.replace(cfg, n_layers=n_layers), cut


def moe_spec_phase(cuda: torch.device) -> tuple[dict, dict, dict]:
    """Phase 16: full-width qwen3-moe-30b-a3b, paged and speculative,
    drafted by its registry draft phi4-mini-3.8b; then phi4-mini served as
    a target on the same weights. Returns the runs, a report, and what
    phase 17 takes: the recorded MoE call and the 3-layer cuts (bf16
    copies; the full weights are freed here)."""
    from repro_torch.models import count_params
    from repro_torch.models.common import tree_map
    from repro_torch.models.registry import default_draft_for

    model, params = load_model("qwen3-moe-30b-a3b", 0, cuda)
    load_peak = load_model.draw_peak_gb
    draft_name = default_draft_for("qwen3-moe-30b-a3b")
    assert draft_name == "phi4-mini-3.8b", draft_name
    draft, draft_params = load_model(draft_name, 1, cuda)
    n, n_draft = count_params(model.template), count_params(draft.template)
    print(f"  qwen3-moe-30b-a3b: {n} parameters ({n / 1e9:.3f} B); {draft_name}: {n_draft}; "
          f"resident {torch.cuda.memory_allocated() / 1e9:.2f} GB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB")
    assert f"{n / 1e9:.3f}" == "30.532", n
    runs, recorded = {}, []
    with torch.no_grad():
        # Phase 10's run (serve_spec), then phase 5's at 30 slots.
        with moe_routing("qwen3-moe spec", cuda) as routing, moe_call_recorded(recorded):
            launches, served = serve_spec(params, model, draft, draft_params, cuda)
        runs["qwen3_moe_spec"] = (launches, {**served, **routing})
        launches, served = serve_paged(draft_params, draft, cuda, None, n_slots=30)
        runs["phi4_mini_paged"] = (launches, {
            "served": served, "routes": {"paged_chunk": launches["paged_prefill_attention"]}})
    free_memory()  # the servers' pools, before phase 17's copies
    assert recorded, "no served paged MoE call dropped an assignment"
    x, p, cfg = recorded[0]
    call = (x, tree_map(torch.clone, p), cfg)
    cuts = {"qwen3-moe-30b-a3b": layer_cut(params, model.cfg, MOE_CUT),
            "phi4-mini-3.8b": layer_cut(draft_params, draft.cfg, MOE_CUT)}
    cuts = {name: (c, tree_map(torch.clone, p)) for name, (c, p) in cuts.items()}
    report = {"params": n, "draft_params": n_draft, "load_peak_gb": load_peak,
              "peak_gb": peak_gb()}
    del params, model, draft, draft_params
    free_memory()
    return runs, report, {"call": call, "cuts": cuts}


def dispatch_parity(x, p, cfg) -> dict:
    """One recorded MoE call in fp32, einsum dispatch against gather:
    equal keep masks and dropped fractions, outputs within DISPATCH_TOL of
    the output's scale."""
    from repro_torch.models import moe
    from repro_torch.models.common import tree_map

    einsum = dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                                 moe_impl="einsum")
    gather = dataclasses.replace(einsum, moe_impl="gather")
    x32, p32 = x.float(), tree_map(lambda t: t.float(), p)
    keep = [moe._route(x32, p32, c, False)[6] for c in (einsum, gather)]
    (a, a_aux), (b, b_aux) = (moe.moe_ffn(x32, p32, c) for c in (einsum, gather))
    err = _rel_err(b, a)
    out = {"tokens": x.shape[0] * x.shape[1], "dropped_frac": float(a_aux["dropped_frac"]),
           "rel_err": err}
    assert torch.equal(keep[0], keep[1]) and float(a_aux["dropped_frac"]) == float(
        b_aux["dropped_frac"]), out
    assert err <= DISPATCH_TOL, out
    return out


def paged_calls_parity(model, params, cuda: torch.device) -> dict:
    """Teacher-forced paged calls of a model at fp32 on one stage: 32-token
    chunks of eight ragged prompts (finished lanes masked), four decode
    steps and two verifies of k = 4 (a lane masked). Per call: the kernel
    path's logits from the plain path's pools against the plain path's,
    every lane and position, and every attention call of the plain path
    kernel against plain (``compared_attention``)."""
    from repro_torch.models.common import tree_map

    cfg = model.cfg
    rng = np.random.default_rng(3)
    W, page, NB, C = 8, 16, 16, 32
    lens = [64, 112, 160, 200, 37, 90, 128, 17]
    shape = (cfg.n_layers, W * NB + 1, page, cfg.n_kv_heads, cfg.head_dim)
    pools = {"k": torch.zeros(shape, device=cuda), "v": torch.zeros(shape, device=cuda)}
    bt = torch.from_numpy(rng.permutation(W * NB).reshape(W, NB).astype(np.int32)).to(cuda)
    tok = lambda *s: torch.from_numpy(rng.integers(0, cfg.vocab_size, s)).to(cuda)  # noqa: E731
    prompts = rng.integers(0, cfg.vocab_size, (W, max(lens)))
    calls = []
    pos = [0] * W
    while any(p < n for p, n in zip(pos, lens)):
        offs = [p if p < n else -1 for p, n in zip(pos, lens)]
        valids = [min(C, n - p) if p < n else 0 for p, n in zip(pos, lens)]
        chunk = np.zeros((W, C), np.int64)  # padding and masked lanes: token 0
        for w, (o, v) in enumerate(zip(offs, valids)):
            chunk[w, :v] = prompts[w, o:o + v]
        calls.append(("chunk", model.prefill_chunk_paged, torch.from_numpy(chunk).to(cuda),
                      offs, valids))
        pos = [p + v for p, v in zip(pos, valids)]
    length = list(lens)
    for step in range(4):
        masked = [w == step for w in range(W)]
        calls.append(("decode", model.decode_paged, tok(W, 1),
                      [-1 if m else n for m, n in zip(masked, length)], None))
        length = [n if m else n + 1 for m, n in zip(masked, length)]
    for _ in range(2):
        offs = [-1 if w == 5 else n for w, n in enumerate(length)]
        calls.append(("verify", model.verify_step_paged, tok(W, 5), offs,
                      [0 if w == 5 else 5 for w in range(W)]))
        length = [n if w == 5 else n + 5 for w, n in enumerate(length)]
    worst_logits: dict[str, float] = {}
    worst: dict[str, float] = {}
    with torch.no_grad():
        for name, fn, inp, offs, valids in calls:
            offs_t = torch.tensor(offs, dtype=torch.int32, device=cuda)
            args = (offs_t,) if valids is None else (
                offs_t, torch.tensor(valids, dtype=torch.int32, device=cuda))
            kernel = fn(params, inp, tree_map(torch.clone, pools), *args, bt)
            with compared_attention(worst), routes_recorded():
                plain = fn(params, inp, pools, *args, bt)
            worst_logits[name] = max(worst_logits.get(name, 0.0), _rel_err(kernel, plain))
    return {"calls": len(calls), "logits_rel_err": worst_logits, "attention_rel_err": worst}


def moe_parity_phase(cuda: torch.device, carried: dict) -> dict:
    """Phase 17: fp32 parity of the MoE phases (module docstring)."""
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.serving import PipelineServer

    torch.cuda.reset_peak_memory_stats()
    report: dict = {}
    fp32 = dict(dtype="float32", param_dtype="float32")
    # (a) granite-moe at full depth: every attention call of a dense and a
    # paged served run against the plain version; a paged MoE call is kept.
    model, params = load_model("granite-moe-1b-a400m", 0, cuda)
    cfg32 = dataclasses.replace(model.cfg, **fp32)
    model32, params32 = build_model(cfg32), tree_map(lambda t: t.float(), params)
    del params
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg32.vocab_size, size=L) for L in (64, 112)]
    worst: dict[str, float] = {}
    recorded = []
    with torch.no_grad():
        for kw in (dict(max_batch=4, max_len=128),
                   dict(prefill_chunk=32, **PAGED_KW)):
            with compared_attention(worst), routes_recorded(), moe_call_recorded(recorded):
                server = PipelineServer(model32, params32, n_groups=3, n_replicas=3,
                                        async_depth=2, seed=0, device=cuda, **kw)
                reqs = [server.submit(p, n_tokens=8) for p in prompts]
                for _ in range(500):
                    if all(r.done for r in reqs):
                        break
                    server.step()
                assert all(r.done for r in reqs), "an fp32 granite-moe server did not finish"
    print("  granite-moe fp32, every attention call of a dense and a paged served run, kernel "
          "vs plain on the same inputs: max|kernel - plain| / max|plain| = "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + f" (tol {MODEL_REL_TOL})")
    assert {"flash_attention", "decode_attention", "paged_decode_attention",
            "paged_prefill_attention"} <= set(worst), worst
    assert all(v <= MODEL_REL_TOL for v in worst.values()), worst
    report["granite_moe_attention_rel_err"] = worst
    assert recorded, "no served paged granite-moe call dropped an assignment"
    report["granite_moe_dispatch"] = dispatch_parity(*recorded[0])
    # (b) einsum against gather on a recorded paged call of each model.
    report["qwen3_moe_dispatch"] = dispatch_parity(*carried["call"])
    print(f"  einsum vs gather dispatch on one recorded paged MoE call, fp32: granite-moe "
          f"{report['granite_moe_dispatch']}, qwen3-moe {report['qwen3_moe_dispatch']} "
          f"(tol {DISPATCH_TOL})")
    # (c) The first served token of each model against the plain path's,
    # on the first MOE_CUT layers at full width.
    firsts = {}
    prompt = prompts[1]
    granite_cut = layer_cut(params32, cfg32, MOE_CUT)
    del params32, model32
    free_memory()
    cuts = {"granite-moe-1b-a400m": [(granite_cut, dict(max_batch=4, max_len=128)),
                                     (granite_cut, dict(prefill_chunk=32, **PAGED_KW))]}
    for name, (cut_cfg, cut_params) in carried.pop("cuts").items():
        cut = (dataclasses.replace(cut_cfg, **fp32), tree_map(lambda t: t.float(), cut_params))
        kw = dict(PAGED_KW) if name.startswith("qwen3") else dict(prefill_chunk=32, **PAGED_KW)
        cuts[name] = [(cut, kw)]
    qwen_cut = None
    with torch.no_grad():
        for name, runs in cuts.items():
            for (cfg, params), kw in runs:
                model = build_model(cfg)
                p = rng.integers(0, cfg.vocab_size, size=len(prompt))
                kernel = _first_token(model, params, p, cuda, **kw)
                with plain_versions():
                    plain = _first_token(model, params, p, cuda, **kw)
                firsts[f"{name} {'paged' if kw.get('paged') else 'dense'}"] = (kernel, plain)
                if name.startswith("qwen3"):
                    qwen_cut = (model, params)
    print(f"  first {MOE_CUT} layers at full width, fp32: first served token (kernel path, "
          f"plain path) {firsts}")
    assert all(k == p for k, p in firsts.values()), firsts
    report["first_tokens"] = {k: list(v) for k, v in firsts.items()}
    # (d) qwen3-moe's cut: logits per paged call, kernel path against plain.
    checks = paged_calls_parity(*qwen_cut, cuda)
    print(f"  qwen3-moe first {MOE_CUT} layers, {checks['calls']} teacher-forced paged calls "
          f"(chunks, decode, verify): logits max diff / scale "
          + ", ".join(f"{k} {v:.3g}" for k, v in checks["logits_rel_err"].items())
          + "; attention calls " + ", ".join(f"{k} {v:.3g}" for k, v in
                                              checks["attention_rel_err"].items())
          + f" (tol {MODEL_REL_TOL})")
    assert set(checks["logits_rel_err"]) == {"chunk", "decode", "verify"}, checks
    assert all(v <= MODEL_REL_TOL for v in checks["logits_rel_err"].values()), checks
    assert all(v <= MODEL_REL_TOL for v in checks["attention_rel_err"].values()), checks
    assert "paged_prefill_attention verify" in checks["attention_rel_err"], checks
    report["qwen3_moe_cut_paged_calls"] = checks
    report["peak_gb"] = peak_gb()
    return report


# ---------------------------------------------------------------------------
# Phases 18-20: the encoder-decoders and internvl2's patches frontend
# ---------------------------------------------------------------------------

_cross = [False]  # True inside an encoder-decoder's cross-attention block


@contextlib.contextmanager
def cross_marked():
    """Mark the attention calls made inside ``cross_attention_block`` (a
    prompt's flash call, a decode step's decode call) for the duration of
    the block: ``encdec`` looks the block up in its own module at call
    time."""
    from repro_torch.models import encdec

    fn = encdec.cross_attention_block

    def marked(*args, **kwargs):
        _cross.append(True)
        try:
            return fn(*args, **kwargs)
        finally:
            _cross.pop()

    encdec.cross_attention_block = marked
    try:
        yield
    finally:
        encdec.cross_attention_block = fn


def attention_route(name: str, kwargs: dict) -> str:
    """The route of a flash or decode call: ``cross`` inside a
    cross-attention block; else flash's ``bidirectional`` (an encoder,
    ``causal=False``), ``windowed`` or ``full``, and decode's ``self``."""
    if _cross[-1]:
        return "cross"
    if name != "flash_attention":
        return "self"
    if not kwargs.get("causal", True):
        return "bidirectional"
    return "windowed" if kwargs.get("window") else "full"


# Phase 19: the encoder-decoders cut to their first ENCDEC_CUT encoder and
# decoder layers at full width (a full-depth random-init model amplifies
# rounding, PERF.md §7 q5); the bf16 calls of the cut against the plain
# version in fp32, relative to the output's scale (the random-init V rows
# reach ~10, where bf16's own rounding is ~2^-8 of a value).
ENCDEC_CUT = 3
ENCDEC_REL_TOL = 1e-4
BF16_REL_TOL = 2e-2
# Phase 20: internvl2-76b's first VLM_LAYERS of 80 layers at full width
# (the whole model, ~141 GB in bf16, does not fit the card's 80 GB).
VLM_LAYERS = 8


def encdec_batch(cfg, n_req: int, n_frames: int, prompt: int, device) -> dict:
    """n_req requests of n_frames frames and prompt decoder tokens, from
    the port's make_inputs (the JAX package's draws)."""
    from repro_torch.configs import ShapeCell
    from repro_torch.models.inputs import make_inputs

    return {
        "tokens": make_inputs(cfg, ShapeCell("prompt", "prefill", prompt, n_req), 2,
                              device)["tokens"],
        "frames": make_inputs(cfg, ShapeCell("frames", "prefill", n_frames, n_req), 1,
                              device)["frames"],
    }


def serve_encdec(params, model, device: torch.device, *, n_req: int, n_frames: int,
                 prompt: int, n_tokens: int, max_len: int, waves) -> tuple[dict, dict]:
    """Greedy-decode ``n_tokens`` tokens for each of ``n_req`` requests
    through the slot-batched entry points on a slot cache of ``n_req``
    lanes (``max_len`` self rows, ``n_frames`` cross rows). ``waves``:
    (decode step, lanes) at which groups of requests are prefilled into
    their lanes; every decode step runs over the whole slot width for the
    lanes still decoding (``decode_batch``'s ``lanes``), the others masked.
    Returns the kernels' launches and a report (launches by route, tokens/s,
    prefill wall times, peak memory)."""
    from repro_torch.models import attention

    cfg = model.cfg
    batch = encdec_batch(cfg, n_req, n_frames, prompt, device)
    cache = model.init_cache(n_req, max_len, device, n_frames)
    flash_key = lambda q, k, v, causal=True, window=None: attention_route(  # noqa: E731
        "flash_attention", {"causal": causal, "window": window})
    decode_key = lambda *args, **kwargs: attention_route("decode_attention", kwargs)  # noqa: E731
    token = torch.zeros(n_req, 1, dtype=torch.long, device=device)
    generated = [[] for _ in range(n_req)]  # device scalars, read after the run
    pending, active, prefill_s, step = list(waves), [], [], 0
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(cross_marked())
        flash_calls = stack.enter_context(calls_recorded(attention, "flash_attention", flash_key))
        decode_calls = stack.enter_context(calls_recorded(attention, "decode_attention",
                                                          decode_key))
        while True:
            while pending and pending[0][0] == step:
                lanes = pending.pop(0)[1]
                idx = torch.tensor(lanes, device=device)
                t = time.perf_counter()
                logits = model.prefill_batch(
                    params, {k: v[idx] for k, v in batch.items()}, cache, idx)
                nxt = logits[:, -1].argmax(-1)
                torch.cuda.synchronize()
                prefill_s.append(time.perf_counter() - t)
                token[idx, 0] = nxt
                for i, lane in enumerate(lanes):
                    generated[lane].append(nxt[i])
                active += lanes
            active = [lane for lane in active if len(generated[lane]) < n_tokens]
            if not active and not pending:
                break
            idx = torch.tensor(active, device=device)
            logits = model.decode_batch(params, token, cache, idx)
            nxt = logits[:, -1].argmax(-1)
            token[idx, 0] = nxt[idx]
            for lane in active:
                generated[lane].append(nxt[lane])
            step += 1
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    tokens = torch.stack([torch.stack(g) for g in generated]).tolist()
    routes = {"flash_attention": dict(collections.Counter(flash_calls)),
              "decode_attention": dict(collections.Counter(decode_calls))}
    n_gen = sum(len(g) for g in tokens)
    # The paper's unit of work, warm: one prefill of the first wave into a
    # fresh cache (median of three).
    first = torch.tensor(waves[0][1], device=device)
    fresh = model.init_cache(n_req, max_len, device, n_frames)
    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.prefill_batch(params, {k: v[first] for k, v in batch.items()}, fresh, first)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t)
    report = {"requests": n_req, "frames": n_frames, "prompt": prompt, "tokens": n_gen,
              "decode_steps": step, "wall_s": wall, "tokens_per_s": n_gen / wall,
              "prefill_s": prefill_s, "prefill_wall_s": statistics.median(warm),
              "peak_gb": peak_gb(), "launches_by_route": routes,
              "flash_launches": launches["flash_attention"]}
    print(f"  {cfg.name}: {n_req} requests of {n_frames} frames x {cfg.frontend_dim} and "
          f"{prompt}-token prompts, {n_tokens} greedy tokens each: {n_gen} tokens, {step} "
          f"decode steps in {wall:.3f} s ({n_gen / wall:.2f} tokens/s); prefills "
          f"{[round(x, 4) for x in prefill_s]} s, one prefill of {len(waves[0][1])} requests "
          f"warm {report['prefill_wall_s']:.4f} s; peak {peak_gb():.2f} GB")
    print(f"  launches {launches}; by route {routes}")
    V = cfg.vocab_size
    assert all(len(g) == n_tokens for g in tokens), [len(g) for g in tokens]
    assert all(0 <= t < V for g in tokens for t in g), "a token outside the vocabulary"
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    assert cache["len"].tolist() == [prompt + n_tokens - 1] * n_req, cache["len"].tolist()
    for name, want in (("flash_attention", {"bidirectional", "full", "cross"}),
                       ("decode_attention", {"self", "cross"})):
        assert set(routes[name]) == want and all(routes[name].values()), (name, routes[name])
        assert sum(routes[name].values()) == launches[name], (name, routes[name], launches)
    assert all(n == 0 for k, n in launches.items()
               if k not in ("flash_attention", "decode_attention")), launches
    assert on_device(params, device), "a parameter is off the card"
    assert on_device(cache, device), "a cache tensor is off the card"
    assert cache["ck"].shape[2] == n_frames
    return launches, report


def encdec_serve_phase(cuda: torch.device) -> tuple[dict, dict]:
    """Phase 18: full-size seamless-m4t-large-v2 (4 requests of 1000
    frames, 8-token prompts, 32 tokens each, two waves of two lanes) and
    paper-block at the paper's input (64 x 16 x 512 frames, 16-token
    prompts, 16 tokens each, one wave), both bf16. Returns the launches
    summed over both runs and a report per model."""
    from repro_torch.models import count_params
    from repro_torch.models.inputs import ENC_LEN_DECODE as PORT_ENC_LEN

    assert PORT_ENC_LEN == ENC_LEN_DECODE, PORT_ENC_LEN
    runs = {}
    for name, kw in (
        ("seamless-m4t-large-v2", dict(n_req=4, n_frames=SEAMLESS_FRAMES,
                                       prompt=SEAMLESS_PROMPT, n_tokens=32, max_len=64,
                                       waves=[(0, [0, 1]), (8, [2, 3])])),
        ("paper-block", dict(n_req=64, n_frames=16, prompt=16, n_tokens=16, max_len=32,
                             waves=[(0, list(range(64)))])),
    ):
        model, params = load_model(name, 0, cuda)
        n = count_params(model.template)
        print(f"  {name}: {n} parameters, {model.cfg.encoder_layers} + {model.cfg.n_layers} "
              f"layers, d_model {model.cfg.d_model}, {model.cfg.n_heads} heads of "
              f"{model.cfg.head_dim}, vocabulary {model.cfg.vocab_size}")
        with torch.no_grad():
            launches, report = serve_encdec(params, model, cuda, **kw)
        runs[name] = (launches, {"params": n, **report})
        del params, model
        free_memory()
    total = {k: sum(launches[k] for launches, _ in runs.values()) for k in KERNELS}
    return total, {name: report for name, (_, report) in runs.items()}


@contextlib.contextmanager
def compared_bf16(worst: dict[str, float]):
    """Every flash and decode call of the block runs the kernel on its bf16
    inputs and the plain version on the same inputs in fp32; the worst
    difference relative to the plain output's scale is kept per route, and
    the forward goes on with the kernel's output."""
    from repro_torch.kernels.decode_attention import decode_attention_ref_model
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.models import attention

    plain = {"flash_attention": flash_attention_ref, "decode_attention": decode_attention_ref_model}
    kernels = {name: getattr(attention, name) for name in plain}

    def compared(name):
        def call(*args, **kwargs):
            got = kernels[name](*args, **kwargs)
            up = [a.float() if a.is_floating_point() else a for a in args]
            want = plain[name](*up, **kwargs)
            key = f"{name} {attention_route(name, kwargs)}"
            worst[key] = max(worst.get(key, 0.0), _rel_err(got, want))
            return got
        return call

    for name in plain:
        setattr(attention, name, compared(name))
    try:
        yield
    finally:
        for name, fn in kernels.items():
            setattr(attention, name, fn)


def encdec_parity_phase(cuda: torch.device) -> dict:
    """Phase 19: each encoder-decoder cut to ENCDEC_CUT encoder and decoder
    layers at full width, fp32 (random weights, seed 0): (a) every
    attention call of a prefill and 8 teacher-forced decode steps, kernel
    against plain version on the same inputs, within ENCDEC_REL_TOL of the
    output's scale, per route; (b) the first greedy token of every request
    equal on the kernel path and the plain path; (c) the same weights in
    bf16: every call's kernel output against the plain version in fp32,
    within BF16_REL_TOL of scale."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_from_template
    from repro_torch.models.common import tree_map

    out = {}
    for name, (n_req, n_frames, prompt) in (
            ("seamless-m4t-large-v2", (2, SEAMLESS_FRAMES, SEAMLESS_PROMPT)),
            ("paper-block", (64, 16, 16))):
        cfg = dataclasses.replace(get_config(name), n_layers=ENCDEC_CUT,
                                  encoder_layers=ENCDEC_CUT, dtype="float32",
                                  param_dtype="float32")
        model = build_model(cfg)
        params = init_from_template(model.template, torch.Generator(device="cuda").manual_seed(0),
                                    "float32", device=cuda)
        batch = encdec_batch(cfg, n_req, n_frames, prompt, cuda)
        max_len = prompt + 8
        worst: dict[str, float] = {}
        with torch.no_grad():
            kernel_logits, _ = model.prefill(params, batch, max_len)
            with cross_marked(), compared_attention(worst):
                plain_logits, cache = model.prefill(params, batch, max_len)
                tok = plain_logits[:, -1].argmax(-1, keepdim=True)
                for _ in range(8):
                    logits, cache = model.decode_step(params, tok, cache)
                    tok = logits[:, -1].argmax(-1, keepdim=True)
            kernel_first = kernel_logits[:, -1].argmax(-1)
            plain_first = plain_logits[:, -1].argmax(-1)
            cfg16 = dataclasses.replace(cfg, dtype="bfloat16", param_dtype="bfloat16")
            model16 = build_model(cfg16)
            params16 = tree_map(lambda t: t.bfloat16(), params)
            worst16: dict[str, float] = {}
            with cross_marked(), compared_bf16(worst16):
                logits16, cache16 = model16.prefill(params16, batch, max_len)
                tok = logits16[:, -1].argmax(-1, keepdim=True)
                for _ in range(8):
                    logits16, cache16 = model16.decode_step(params16, tok, cache16)
                    tok = logits16[:, -1].argmax(-1, keepdim=True)
        agree = int((kernel_first == plain_first).sum())
        print(f"  {name} cut to {ENCDEC_CUT} + {ENCDEC_CUT} layers, fp32: every attention call "
              f"of a prefill ({n_req} x {n_frames} frames, {prompt} tokens) + 8 decode steps, "
              f"kernel vs plain: max|kernel - plain| / max|plain| = "
              + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items()))
              + f" (tol {ENCDEC_REL_TOL}); first tokens equal on {agree}/{n_req} requests; "
              "bf16 kernel vs fp32 plain: "
              + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst16.items()))
              + f" (tol {BF16_REL_TOL})")
        routes = {"flash_attention", "flash_attention bidirectional", "flash_attention cross",
                  "decode_attention", "decode_attention cross"}
        assert set(worst) == routes, worst
        assert all(v <= ENCDEC_REL_TOL for v in worst.values()), worst
        assert agree == n_req, (kernel_first.tolist(), plain_first.tolist())
        assert {k.replace(" self", "").replace(" full", "") for k in worst16} == routes, worst16
        assert all(v <= BF16_REL_TOL for v in worst16.values()), worst16
        out[name] = {"attention_rel_err": worst, "bf16_rel_err": worst16,
                     "first_tokens_equal": agree, "requests": n_req}
        del params, params16, cache, cache16
        free_memory()
    return out


def vlm_phase(cuda: torch.device) -> tuple[dict, dict]:
    """Phase 20: internvl2-76b cut to VLM_LAYERS of its 80 layers at full
    width (bf16, seed 0): two 1100-token prompts whose first 1024 positions
    take projected patch embeddings [2, 1024, 3200], then 16 greedy decode
    steps; then one dense PipelineServer run at G=2 x R=3 (phase 4's, as
    the JAX fleet serves it: tokens only). Returns the launches of both and
    a report."""
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.models import build_model, count_params, init_from_template
    from repro_torch.models.inputs import make_inputs
    from repro_torch.serving import slice_stage_params

    full = get_config("internvl2-76b")
    cfg = dataclasses.replace(full, n_layers=VLM_LAYERS)
    model = build_model(cfg)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_from_template(model.template, torch.Generator(device="cuda").manual_seed(0),
                                cfg.param_dtype, device=cuda)
    n, n_full = count_params(model.template), count_params(build_model(full).template)
    print(f"  internvl2-76b reduced: {VLM_LAYERS} of {full.n_layers} layers at full width "
          f"(d_model {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.head_dim}, "
          f"vocabulary {cfg.vocab_size}, vision_proj {tuple(model.template['vision_proj'].shape)})"
          f": {n} parameters ({n / 1e9:.3f} B; the whole model {n_full / 1e9:.3f} B), drawn in "
          f"{time.perf_counter() - t0:.2f} s, peak {peak_gb():.2f} GB")
    batch = make_inputs(cfg, ShapeCell("vlm", "prefill", VLM_PROMPT, 2), 3, cuda)
    assert tuple(batch["patch_embeds"].shape) == (2, cfg.n_frontend_tokens, cfg.frontend_dim)
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, VLM_PROMPT + 16)
        tokens = [logits[:, -1].argmax(-1)]
        for _ in range(16):
            logits, cache = model.decode_step(params, tokens[-1][:, None], cache)
            tokens.append(logits[:, -1].argmax(-1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        direct = read_counters()
        # The same prompts without their patches: the last position's logits move.
        with_patches, _ = model.prefill(params, batch, VLM_PROMPT)
        text, _ = model.prefill(params, {"tokens": batch["tokens"]}, VLM_PROMPT)
    tokens = torch.stack(tokens, 1).tolist()
    moved = _rel_err(with_patches, text)
    print(f"  2 prompts of {VLM_PROMPT} tokens (patches at positions 0.."
          f"{cfg.n_frontend_tokens - 1})"
          f" + 16 decode steps: {wall:.3f} s, {2 * 17 / wall:.2f} tokens/s, peak {peak_gb():.2f} "
          f"GB; tokens {tokens}; launches {direct}; the patches move the last prompt position's "
          f"logits by {moved:.3g} of their scale")
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    assert all(0 <= t < cfg.vocab_size for row in tokens for t in row)
    assert direct["flash_attention"] == VLM_LAYERS, direct
    assert direct["decode_attention"] == 16 * VLM_LAYERS, direct
    assert moved > 0, "the patch embeddings did not reach the logits"
    stages = slice_stage_params(cfg, params, 2)
    assert ["vision_proj" in s for s in stages] == [True, False]
    with torch.no_grad():
        served_launches, served = serve(params, model, cuda, n_groups=2)
    launches = {k: direct[k] + served_launches.get(k, 0) for k in KERNELS}
    report = {"params": n, "params_full": n_full, "layers": f"{VLM_LAYERS} of {full.n_layers}",
              "direct": {"wall_s": wall, "tokens": 2 * 17, "tokens_per_s": 2 * 17 / wall,
                         "launches": direct, "patches_rel_move": moved},
              "served": served, "peak_gb": peak_gb()}
    del params, model, cache, stages, with_patches, text
    free_memory()
    return launches, report



# Phase 21: phase 4's stablelm-1.6b through MPPipelineServer, G=2 x R=2.
MP_FLEET = dict(n_groups=2, n_replicas=2, max_batch=4, max_len=128, async_depth=2, seed=0)
MP_PROMPTS = (64, 88, 104, 120) * 2  # phase 4's direct prompts, twice: every stage-0 slot
MP_TOKENS = 8
MP_KILL_AFTER = 3  # slots into wave 2 before stage 0's replica 0 is killed
MP_KERNELS = ("flash_attention", "decode_attention")  # the dense path's kernels
STAT_COUNTERS = ("submitted", "completed_jobs", "dropped_jobs", "queued_jobs",
                 "tokens_generated", "prefill_calls", "decode_calls", "rerouted_stages",
                 "slots", "downtime_replica_slots", "energy_charged")


def mp_waves(server, vocab: int, fault, recover, after_wave=lambda wave: None) -> list[dict]:
    """Three waves of MP_PROMPTS (seeded), MP_TOKENS each, drained: fault()
    before slot MP_KILL_AFTER of wave 2, recover() before wave 3, and
    after_wave(i) after wave i, each outside the waves' wall time. Returns
    each wave's streams, wall seconds, tokens and slots."""
    rng = np.random.default_rng(2)
    waves = []
    for wave in range(3):
        prompts = [rng.integers(0, vocab, size=n) for n in MP_PROMPTS]
        if wave == 2:
            recover()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [server.submit(p, n_tokens=MP_TOKENS) for p in prompts]
        steps = 0
        while not all(r.done or r.dropped for r in reqs):
            if wave == 1 and steps == MP_KILL_AFTER:
                fault()
            server.step()
            steps += 1
            assert steps < 2000, "a wave did not drain"
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert all(r.done and len(r.generated) == MP_TOKENS for r in reqs), "a request was lost"
        waves.append({"streams": [list(r.generated) for r in reqs], "wall_s": wall,
                      "tokens": len(reqs) * MP_TOKENS, "slots": steps,
                      "tokens_per_s": len(reqs) * MP_TOKENS / wall})
        after_wave(wave)
    return waves


def process_memory_mib() -> dict[int, int]:
    """Device memory per process (MiB) by the pid nvidia-smi reports, which
    is the host's: inside a container it names no pid of this one."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60).stdout
    rows = [line.split(",") for line in out.strip().splitlines()]
    return {int(r[0]): int(r[1]) for r in rows
            if len(r) == 2 and r[0].strip().isdigit() and r[1].strip().isdigit()}


def multiprocess_phase(cuda: torch.device) -> tuple[dict, dict]:
    """Phase 21: phase 4's stablelm-1.6b (full width, bf16, seed 0) served
    by MPPipelineServer at G=2 x R=2, four worker processes on the card,
    beside the in-process PipelineServer on the same card and weights
    driven through the same schedule: a fault-free wave, a SIGKILL of
    stage 0's replica 0 mid-stream (in process: ``fail_replica`` and the
    ring abort, as the multi-process ``fail_replica`` does), then
    ``recover_replica`` (in process after evicting the replica's stage
    residents, as the respawn does) and a third wave. Every wave's streams
    and the server counters must be equal. Returns the workers' kernel
    launches (the live workers' last pings, plus the killed worker's
    after wave 1) and a report."""
    from repro_torch.core.network import DeviceSpec
    from repro_torch.ft import ElasticController
    from repro_torch.serving import MPPipelineServer, PipelineServer

    model, params = load_model("stablelm-1.6b", 0, cuda)  # phase 4's weights
    V = model.cfg.vocab_size
    ref = PipelineServer(model, params, device=cuda, **MP_FLEET)
    specs = [[DeviceSpec(6, 10, ref.pm_policy) for _ in range(ref.R)] for _ in range(ref.G)]
    ref.elastic = ElasticController(ref.router, specs, device=cuda)  # the MP server's default
    zero_counters()
    with torch.no_grad():
        want = mp_waves(ref, V,
                        lambda: (ref.fail_replica(0, 0), ref._abort_ring(0, 0)),
                        lambda: (ref.scheduler.evict_stage_residents(0, 0),
                                 ref.recover_replica(0, 0)))
    in_process = read_counters()
    ref_stats = {k: getattr(ref.stats, k) for k in STAT_COUNTERS}
    ref_peak = peak_gb()
    del ref, params, model
    free_memory()

    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    spec = {"arch": "stablelm-1.6b", "smoke": False, "seed": 0}
    t0 = time.perf_counter()
    mp = MPPipelineServer(spec, device=cuda, **MP_FLEET)
    procs = [w.proc for w in mp._workers.values()]
    try:
        spawn_s = time.perf_counter() - t0
        assert mp.elastic.specs == specs
        boot = mp.ping()
        seen = {}

        def after_wave(wave):
            if wave == 0:
                seen["wave1"] = mp.ping()

        def fault():
            w = mp._workers[(0, 0)]
            seen["pid"], seen["version"] = w.proc.pid, mp.router.membership_version
            w.proc.kill()  # SIGKILL: the ProcessMonitor sees the exit at the next slot
            w.proc.wait()

        def recover():
            assert not mp.budgets[0][0].alive
            rates = mp.router.long_term_rates
            assert rates[0][0] == 0.0 and rates[0][1] > 0.0, rates
            assert mp.router.membership_version > seen["version"]
            t = time.perf_counter()
            mp.recover_replica(0, 0)
            seen["respawn_s"] = time.perf_counter() - t
            procs.append(mp._workers[(0, 0)].proc)
            assert procs[-1].pid != seen["pid"] and mp.router.long_term_rates[0][0] > 0.0

        with torch.no_grad():
            got = mp_waves(mp, V, fault, recover, after_wave)
        final = mp.ping()
        smi = process_memory_mib()
        coordinator = read_counters()
        coordinator_peak = peak_gb()
        mp_stats = {k: getattr(mp.stats, k) for k in STAT_COUNTERS}
    finally:
        mp.close()
    assert all(p.poll() is not None for p in procs), "a worker outlived the server"

    card = torch.cuda.get_device_name(0)
    for key, ping in {**boot, **final}.items():
        assert ping["device"] == card, (key, ping["device"])
    for key, ping in final.items():
        assert all(ping["launches"][k] > 0 for k in MP_KERNELS), (key, ping["launches"])
    killed = seen["wave1"][(0, 0)]
    assert all(killed["launches"][k] > 0 for k in MP_KERNELS), killed["launches"]
    assert all(n == 0 for n in coordinator.values()), f"the coordinator launched {coordinator}"
    launches = {k: sum(p["launches"][k] for p in final.values()) + killed["launches"][k]
                for k in KERNELS}
    for i, (a, b) in enumerate(zip(want, got)):
        assert a["streams"] == b["streams"], f"wave {i + 1}: the streams differ"
    assert mp_stats == ref_stats, (mp_stats, ref_stats)
    assert mp_stats["rerouted_stages"] > 0, "the kill rerouted nothing"

    gb = 1e9
    workers = {f"{g},{r}": {
        "pid": p["pid"], "build_peak_gb": p["build_peak_bytes"] / gb,
        "serve_peak_gb": p["peak_bytes"] / gb, "reserved_gb": p["reserved_bytes"] / gb,
        "launches": p["launches"],
        "prefill_calls": p["prefill_calls"], "decode_calls": p["decode_calls"]}
        for (g, r), p in final.items()}
    tps = lambda waves: sum(w["tokens"] for w in waves) / sum(w["wall_s"] for w in waves)  # noqa: E731
    report = {
        "card": card_name(), "fleet": "G=2 x R=2, max_batch 4, max_len 128, async depth 2",
        "waves": [{"prompts": len(MP_PROMPTS), "tokens": w["tokens"], "slots": w["slots"],
                   "in_process_s": a["wall_s"], "multiprocess_s": w["wall_s"],
                   "in_process_tokens_per_s": a["tokens_per_s"],
                   "multiprocess_tokens_per_s": w["tokens_per_s"]}
                  for a, w in zip(want, got)],
        "in_process_tokens_per_s": tps(want), "multiprocess_tokens_per_s": tps(got),
        "spawn_s": spawn_s, "respawn_s": seen["respawn_s"],
        "in_process_peak_gb": ref_peak, "coordinator_peak_gb": coordinator_peak,
        "nvidia_smi_mib_by_host_pid": smi, "workers": workers, "killed_worker_after_wave1": killed["launches"],
        "fleet_reserved_gb": sum(w["reserved_gb"] for w in workers.values()),
        "fleet_smi_mib": sum(smi.values()) if smi else "not measured",
        "stats": mp_stats, "in_process_launches": in_process, "launches": launches,
    }
    print(f"  card {report['card']}; spawn {spawn_s:.2f} s (4 workers, each drawing the whole "
          f"model on the card), respawn {seen['respawn_s']:.2f} s")
    for i, w in enumerate(report["waves"], 1):
        print(f"  wave {i}: {w['tokens']} tokens in {w['slots']} slots: in process "
              f"{w['in_process_s']:.3f} s ({w['in_process_tokens_per_s']:.2f} tokens/s), "
              f"multi-process {w['multiprocess_s']:.3f} s ({w['multiprocess_tokens_per_s']:.2f} "
              f"tokens/s); streams equal")
    print(f"  tokens/s over the three waves: in process {report['in_process_tokens_per_s']:.2f}, "
          f"multi-process {report['multiprocess_tokens_per_s']:.2f}; stats equal {mp_stats}")
    for key, w in workers.items():
        print(f"  worker {key} (pid {w['pid']}): build peak {w['build_peak_gb']:.2f} GB, serve "
              f"peak {w['serve_peak_gb']:.2f} GB, reserved {w['reserved_gb']:.2f} GB; launches "
              f"{w['launches']}")
    print(f"  killed worker after wave 1: {killed['launches']}; coordinator: launches "
          f"{coordinator}, peak {coordinator_peak:.2f} GB; fleet reserved "
          f"{report['fleet_reserved_gb']:.2f} GB; nvidia-smi per process (host pids) {smi} MiB, "
          f"{report['fleet_smi_mib']} MiB in all; in-process peak {ref_peak:.2f} GB")
    print(f"  launches: multi-process {launches} (the killed worker's wave-2 launches died with "
          f"it), in process {in_process}")
    return launches, report


# ---- training: phases 22-26 -------------------------------------------------

BWD_TOL = 1e-4  # dq, dk, dv against the plain backward, relative to each one's scale
LSE_TOL = 2e-5  # the forward kernel's row log-sum-exp against the plain one, absolute
# Phase 22's cases: (B, Sq, Skv, H, KV, D, causal, window, label). The first
# two are the trained shapes of phases 23 and 24.
BWD_CASES = (
    (4, 256, 256, 32, 32, 64, True, None, "stablelm-1.6b trained"),
    (4, 256, 256, 16, 8, 64, True, None, "granite-moe-1b-a400m trained"),
    (2, 300, 300, 8, 8, 64, True, 100, "windowed, ragged"),
    (2, 256, 256, 16, 4, 64, True, None, "GQA G=4"),
    (2, 100, 177, 8, 4, 64, False, None, "bidirectional Sq != Skv"),
    (2, 256, 256, 8, 8, 128, True, None, "head_dim 128"),
    (4, 64, 64, 4, 2, 16, True, None, "head_dim 16, smoke"),
    (2, 90, 130, 4, 4, 16, False, None, "head_dim 16 bidirectional"),
    (1, 1024, 1024, 16, 4, 64, True, None, "long, many tiles through the ring"),
    (2, 256, 256, 32, 2, 64, True, None, "GQA G=16, the widest head split"),
)
# Phase 22 also holds and times the fp32 forward kernel (lse on): (B, Sq,
# Skv, H, KV, D, causal, window, label). The first two are the trained
# shapes of phases 23 and 24.
FWD_SHAPES = (
    (4, 256, 256, 32, 32, 64, True, None, "stablelm-1.6b trained"),
    (4, 256, 256, 16, 8, 64, True, None, "granite-moe-1b-a400m trained"),
    (1, 1300, 1300, 25, 5, 64, True, 1024, "hymba-1.5b's window class"),
    (4, 8, 1000, 16, 16, 64, False, None, "seamless-m4t-large-v2's cross packing"),
    (2, 200, 200, 32, 4, 128, True, None, "head_dim 128, GQA G=8"),
)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 20, 4, 256, 3e-4
TRAIN_CUT_LAYERS = 3  # the full-width cut that phases 23-25 train and hold
LOSS_REL_TOL, GRAD_REL_TOL = 1e-5, 1e-3
# Full depth: the step-0 gradient's norm at layer 0 over that at the last
# layer, at least; and each layer's norm through the kernels within this
# factor of the plain one's (a one-ulp change of the JAX package's own
# weights moves its 24-layer norm by up to 2.2 times; PERF.md, section 7).
DEPTH_GROWTH, DEPTH_SPREAD = 1e3, 4.0


def sdpa_backend(out: torch.Tensor) -> str:
    """The SDPA backend an output came from, read off its backward node."""
    name = out.grad_fn.name()
    for key, backend in (("Efficient", "efficient"), ("Flash", "flash"), ("Cudnn", "cudnn")):
        if key in name:
            return backend
    return f"math ({name})"


def sdpa_backward(q, k, v, do, causal: bool, window, efficient: bool = False):
    """SDPA's fp32 backward through autograd on the model-layout inputs:
    the forward graph built once (any backend, or the memory-efficient one
    alone), a function that runs its backward, the backend it took, and
    how GQA went in (SDPA's ``enable_gqa``, or K and V repeated over the
    group inside the graph where the backend refuses it)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    H, KV = q.shape[2], k.shape[2]
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    kw = dict(is_causal=causal) if window is None else dict(attn_mask=band_mask(q.shape[1],
                                                                              window))
    ctx = sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION) if efficient else contextlib.nullcontext()
    with ctx:
        try:
            out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=H != KV, **kw)
            gqa = "enable_gqa" if H != KV else "none"
        except RuntimeError:
            G = H // KV
            out = F.scaled_dot_product_attention(qt, kt.repeat_interleave(G, 1),
                                                 vt.repeat_interleave(G, 1), **kw)
            gqa = "repeat_interleave"
    dot = do.transpose(1, 2)
    run = lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)  # noqa: E731
    return run, sdpa_backend(out), gqa


def bwd_inputs(B, Sq, Skv, H, KV, D, causal, window, gen):
    """One backward case's inputs on the card, drawn from ``gen``: q, k, v,
    do, and o, lse from the forward kernel, with the mask's keywords."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    q = torch.randn(B, Sq, H, D, generator=gen, device="cuda")
    k = torch.randn(B, Skv, KV, D, generator=gen, device="cuda")
    v = torch.randn(B, Skv, KV, D, generator=gen, device="cuda")
    do = torch.randn(B, Sq, H, D, generator=gen, device="cuda")
    kw = dict(causal=causal, window=window)
    o, lse = flash_attention_fwd(q, k, v, **kw)
    return q, k, v, do, o, lse, kw


def flash_bwd_case(B, Sq, Skv, H, KV, D, causal, window, label, gen) -> dict:
    """The backward kernel against its plain version on the same inputs
    (o and lse from the forward kernel, whose lse is held against the plain
    one too), a second call that must give the same bits, a planted fault
    (one dk element moved) that the check must catch, and the times:
    kernel, plain, and SDPA's fp32 backward through autograd, with any
    backend and with the memory-efficient one alone."""
    from repro_torch.kernels.flash_attention import (
        attention_lse_ref, bwd_head_splits, flash_attention_bwd, flash_attention_bwd_ref)

    q, k, v, do, o, lse, kw = bwd_inputs(B, Sq, Skv, H, KV, D, causal, window, gen)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    lse_err = (lse - attention_lse_ref(q, k, **kw)).abs().max().item()
    errs = {n: _rel_err(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    faulted = got[1].clone()
    faulted.view(-1)[faulted.numel() // 2] += 0.01 * want[1].abs().max()
    fault_err = _rel_err(faulted, want[1])
    library, backend, gqa = sdpa_backward(q, k, v, do, causal, window)
    efficient, eff_backend, eff_gqa = sdpa_backward(q, k, v, do, causal, window, efficient=True)
    pairs = sum(min(i + 1, Skv, window or Skv) for i in range(Sq)) if causal else Sq * Skv
    # Bytes: q, o, do read and dq written; k, v read and dk, dv written;
    # lse read. Operations: the five products, 2.5 times the forward's two
    # matmuls, each as three TF32 products; beside them the same on the
    # CUDA cores in fp32, the first design's bound.
    bytes_ms = (4 * q.numel() + 4 * k.numel() + lse.numel()) * 4 / HBM_BYTES_PER_S * 1e3
    flops = 2.5 * 4 * B * H * D * pairs
    tf32x3_ms = flops / TF32X3_FLOPS * 1e3
    shape = (f"B={B} S={Sq} H={H} KV={KV} D={D}" if Sq == Skv else
             f"B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} D={D}")
    return {
        "shape": shape + (f" window={window}" if window else "")
                 + ("" if causal else " bidirectional") + f" ({label})",
        "dtype": "float32",
        "max_abs_err": max((g - w).abs().max().item() for g, w in zip(got, want)),
        "max_rel_err": max(errs.values()),
        "rel_err": errs,
        "lse_max_abs_err": lse_err,
        "planted_fault_rel_err": fault_err,
        "bitwise_repeat": bitwise,
        "head_splits": bwd_head_splits(
            B, Skv, KV, H // KV, torch.cuda.get_device_properties(0).multi_processor_count),
        "tol": BWD_TOL,
        "ms": time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw)),
        "plain_ms": time_ms(lambda: flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)),
        "library_ms": time_ms(library),
        "library_backend": backend,
        "library_gqa": gqa,
        "library_efficient_ms": time_ms(efficient),
        "library_efficient_backend": eff_backend,
        "library_efficient_gqa": eff_gqa,
        "bound_ms": max(bytes_ms, tf32x3_ms),
        "bound_by": "bytes" if bytes_ms >= tf32x3_ms else "operations",
        "bytes_ms": bytes_ms,
        "tf32x3_ms": tf32x3_ms,
        "fp32_cuda_core_ms": flops / PEAK_FLOPS[torch.float32] * 1e3,
    }


def flash_bwd_nan_check(gen) -> dict:
    """The card's own NaN (0x7fffffff) planted in one element of dO, at
    granite-moe-1b-a400m's trained shape (two head splits): dq, dk and dv
    are non-finite exactly where the plain version's are, which the
    3xTF32 rounding must not turn into zeros. The NaN sits in the last
    query row, which every KV tile sees: for an earlier row the plain
    version also multiplies the masked zeros of the tiles the kernel
    skips by it."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_bwd_ref

    q, k, v, do, o, lse, kw = bwd_inputs(*BWD_CASES[1][:8], gen)
    do.view(torch.int32)[1, -1, 3, 5] = 0x7FFFFFFF
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    return {n: {"non_finite": int((~g.isfinite()).sum()),
                "plain_non_finite": int((~w.isfinite()).sum()),
                "same_places": bool(torch.equal(g.isfinite(), w.isfinite()))}
            for n, g, w in zip(("dq", "dk", "dv"), got, want)}


def flash_fwd_fp32_case(B, Sq, Skv, H, KV, D, causal, window, label, gen) -> dict:
    """The fp32 forward kernel with the lse on (what training launches)
    against its plain versions (output within TOL, lse within LSE_TOL), a
    second call that must give the same bits, and the times: kernel, plain,
    and SDPA's fp32 forward (one call; a window as a banded boolean mask).
    Bound: max(bytes, 3xTF32 operations), the fp32 CUDA-core figure beside."""
    from repro_torch.kernels.flash_attention import (
        attention_lse_ref, flash_attention_fwd, flash_attention_ref)

    q = torch.randn(B, Sq, H, D, generator=gen, device="cuda")
    k = torch.randn(B, Skv, KV, D, generator=gen, device="cuda")
    v = torch.randn(B, Skv, KV, D, generator=gen, device="cuda")
    kw = dict(causal=causal, window=window)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    again, lse_again = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (out - flash_attention_ref(q, k, v, **kw)).abs().max().item()
    lse_err = (lse - attention_lse_ref(q, k, **kw)).abs().max().item()
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = dict(is_causal=causal) if window is None else dict(attn_mask=band_mask(Sq, window))
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, enable_gqa=H != KV, **mask)
    plain = lambda: (flash_attention_ref(q, k, v, **kw),  # noqa: E731
                     attention_lse_ref(q, k, **kw))
    pairs = sum(min(i + 1, Skv, window or Skv) for i in range(Sq)) if causal else Sq * Skv
    flops = 4 * B * H * D * pairs
    # Bytes: q read and o written, k and v read, the lse written.
    bytes_ms = (2 * q.numel() + k.numel() + v.numel() + lse.numel()) * 4 / HBM_BYTES_PER_S * 1e3
    tf32x3_ms = flops / TF32X3_FLOPS * 1e3
    shape = (f"B={B} S={Sq} H={H} KV={KV} D={D}" if Sq == Skv else
             f"B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} D={D}")
    return {
        "shape": shape + (f" window={window}" if window else "")
                 + ("" if causal else " bidirectional") + f" ({label})",
        "dtype": "float32",
        "max_abs_err": err,
        "lse_max_abs_err": lse_err,
        "bitwise_repeat": torch.equal(out, again) and torch.equal(lse, lse_again),
        "tol": TOL[torch.float32],
        "ms": time_ms(lambda: flash_attention_fwd(q, k, v, **kw)),
        "plain_ms": time_ms(plain),
        "library_ms": time_ms(library),
        "bound_ms": max(bytes_ms, tf32x3_ms),
        "bound_by": "bytes" if bytes_ms >= tf32x3_ms else "operations",
        "bytes_ms": bytes_ms,
        "tf32x3_ms": tf32x3_ms,
        "fp32_cuda_core_ms": flops / PEAK_FLOPS[torch.float32] * 1e3,
    }


def flash_bwd_phase(cuda: torch.device, report: dict | None = None) -> dict:
    """Phase 22: the flash-attention backward kernel per call, its SASS
    (``report``, phase 2's, or built here when phase 22 runs alone: every
    instantiation of its product kernels must hold TF32 HMMA), the autograd
    wiring (``flash_attention`` under grad against autograd through the
    plain version), and the fp32 forward at the trained shapes."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    report = report or kernel_report(_build.build())
    tf32 = _build.tensor_core_check(report, _build.TF32_KERNELS, key="hmma_tf32")
    for kernel in tf32.values():
        for name in kernel:
            r = report[name]
            print(f"  {name}: HMMA on TF32 {r['hmma_tf32']} (of {r['hmma']} HMMA), FFMA "
                  f"{r['ffma']}, {r.get('registers')} registers, {r.get('spill_bytes')} spill "
                  "bytes")
    gen = torch.Generator(device=cuda).manual_seed(22)
    cases = [flash_bwd_case(*c, gen) for c in BWD_CASES]
    for c in cases:
        print(f"  flash_attention_bwd {c['shape']}: dq/dk/dv err / scale "
              + "/".join(f"{e:.3g}" for e in c["rel_err"].values())
              + f" (tol {c['tol']:g}; planted fault {c['planted_fault_rel_err']:.3g}), lse err "
              f"{c['lse_max_abs_err']:.3g} (tol {LSE_TOL:g}); repeat bit for bit "
              f"{c['bitwise_repeat']}; head splits {c['head_splits']}; kernel {c['ms']:.4f} ms "
              f"plain {c['plain_ms']:.4f} ms SDPA backward {c['library_ms']:.4f} ms "
              f"({c['library_backend']}, GQA {c['library_gqa']}), efficient backend alone "
              f"{c['library_efficient_ms']:.4f} ms ({c['library_efficient_backend']}, GQA "
              f"{c['library_efficient_gqa']}); bound {c['bound_ms']:.4f} ms ({c['bound_by']}: "
              f"bytes {c['bytes_ms']:.4f}, 3xTF32 operations {c['tf32x3_ms']:.4f}; fp32 on "
              f"the CUDA cores {c['fp32_cuda_core_ms']:.4f})")
    bad = [c for c in cases if not (c["max_rel_err"] <= BWD_TOL < c["planted_fault_rel_err"]
                                    and c["lse_max_abs_err"] <= LSE_TOL
                                    and c["bitwise_repeat"])]
    assert not bad, f"the backward kernel disagrees with its plain version: {bad}"
    nan = flash_bwd_nan_check(gen)
    print("  a NaN (0x7fffffff) in dO: non-finite entries kernel / plain "
          + ", ".join(f"{n} {r['non_finite']} / {r['plain_non_finite']}" for n, r in nan.items()))
    assert all(r["non_finite"] and r["same_places"] for r in nan.values()), nan
    B, S, H, KV, D = 2, 256, 16, 8, 64
    leaves = [torch.randn(B, S, n, D, generator=gen, device=cuda).requires_grad_()
              for n in (H, KV, KV)]
    do = torch.randn(B, S, H, D, generator=gen, device=cuda)
    got = torch.autograd.grad(flash_attention(*leaves), leaves, do)
    want = torch.autograd.grad(flash_attention_ref(*leaves), leaves, do)
    wiring = max(_rel_err(g, w) for g, w in zip(got, want))
    print(f"  autograd through the kernels vs through the plain version: err / scale {wiring:.3g}")
    assert wiring <= BWD_TOL, wiring
    forward = [flash_fwd_fp32_case(*c, gen) for c in FWD_SHAPES]
    for c in forward:
        print(f"  flash_attention_fwd fp32, lse on, {c['shape']}: err {c['max_abs_err']:.3g} "
              f"(tol {c['tol']:g}), lse err {c['lse_max_abs_err']:.3g} (tol {LSE_TOL:g}); "
              f"repeat bit for bit {c['bitwise_repeat']}; kernel {c['ms']:.4f} ms plain "
              f"{c['plain_ms']:.4f} ms SDPA forward {c['library_ms']:.4f} ms; bound "
              f"{c['bound_ms']:.4f} ms ({c['bound_by']}: bytes {c['bytes_ms']:.4f}, 3xTF32 "
              f"operations {c['tf32x3_ms']:.4f}; fp32 on the CUDA cores "
              f"{c['fp32_cuda_core_ms']:.4f})")
    assert all(c["max_abs_err"] <= c["tol"] and c["lse_max_abs_err"] <= LSE_TOL
               and c["bitwise_repeat"] for c in forward), forward
    return {"cases": cases, "tf32_sass": tf32, "nan_in_do": nan, "fp32_forward": forward}


@contextlib.contextmanager
def training_calls_compared(worst: dict[str, float]):
    """Inside the block (and inside :func:`flash_routes_recorded`, which
    names each flash call's route), each flash and scan kernel call under
    autograd, forward and backward, is also run through its plain version
    on the same operands, and the worst difference relative to the plain
    result's scale is recorded into ``worst`` per kernel and flash route;
    the kernels' results go on, so the step runs through the kernels and
    each comparison sees the step's own operands."""
    from repro_torch.kernels.flash_attention import (
        attention_lse_ref, flash_attention_bwd_ref, flash_attention_ref)
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.selective_scan import selective_scan_bwd_ref, selective_scan_ref
    from repro_torch.kernels.selective_scan import ops as scan_ops

    flash, scan = flash_ops._FlashAttention, scan_ops._SelectiveScan
    saved = [(flash, flash.forward, flash.backward), (scan, scan.forward, scan.backward)]

    def note(key, got, want):
        pairs = [(g, w) for g, w in zip(got, want) if g is not None]
        worst[key] = max(worst.get(key, 0.0), *(_rel_err(g, w) for g, w in pairs))

    # The operands ride on the autograd context beside its saved tensors,
    # which a checkpointed layer lets the backward unpack only once.
    def flash_forward(ctx, q, k, v, causal, window):
        out = saved[0][1](ctx, q, k, v, causal, window)
        note(f"flash_attention {ctx.route}", (out,),
             (flash_attention_ref(q, k, v, causal=causal, window=window),))
        ctx.operands = q, k, v, out
        return out

    def flash_backward(ctx, do):
        got = saved[0][2](ctx, do)
        q, k, v, out = ctx.operands
        kw = dict(causal=ctx.causal, window=ctx.window)
        note(f"flash_attention_bwd {ctx.route}", got[:3], flash_attention_bwd_ref(
            q, k, v, out, attention_lse_ref(q, k, **kw), do, **kw))
        return got

    def scan_forward(ctx, x, dt, Bmat, Cmat, A, h0):
        got = saved[1][1](ctx, x, dt, Bmat, Cmat, A, h0)
        note("selective_scan", got, selective_scan_ref(x, dt, Bmat, Cmat, A, h0))
        ctx.operands = x, dt, Bmat, Cmat, A, h0
        return got

    def scan_backward(ctx, dy, dh_final):
        got = saved[1][2](ctx, dy, dh_final)
        note("selective_scan_bwd", got, selective_scan_bwd_ref(
            *ctx.operands, torch.zeros_like(ctx.operands[0]) if dy is None else dy, dh_final))
        return got

    flash.forward, flash.backward = staticmethod(flash_forward), staticmethod(flash_backward)
    scan.forward, scan.backward = staticmethod(scan_forward), staticmethod(scan_backward)
    try:
        yield
    finally:
        for cls, fwd, bwd in saved:
            cls.forward, cls.backward = staticmethod(fwd), staticmethod(bwd)


@contextlib.contextmanager
def flash_routes_recorded():
    """Count the flash kernels' launches made under grad by route, forward
    and backward, for the duration of the block (inside ``cross_marked``
    for the encoder-decoders' cross route): the yielded {"flash_attention":
    Counter, "flash_attention_bwd": Counter}. The forward of
    ``_FlashAttention`` stores its route (:func:`attention_route`) on the
    autograd context, where its backward reads it."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    counts = {"flash_attention": collections.Counter(),
              "flash_attention_bwd": collections.Counter()}
    cls = flash_ops._FlashAttention
    fwd, bwd = cls.forward, cls.backward

    def forward(ctx, q, k, v, causal, window):
        ctx.route = attention_route("flash_attention", dict(causal=causal, window=window))
        counts["flash_attention"][ctx.route] += 1
        return fwd(ctx, q, k, v, causal, window)

    def backward(ctx, do):
        counts["flash_attention_bwd"][ctx.route] += 1
        return bwd(ctx, do)

    cls.forward, cls.backward = staticmethod(forward), staticmethod(backward)
    try:
        yield counts
    finally:
        cls.forward, cls.backward = staticmethod(fwd), staticmethod(bwd)


def step_launches(cfg) -> dict:
    """The kernel launches of one train step (one ``loss_and_grad``) of
    ``cfg`` under remat: each attention layer's flash forward twice (the
    recompute) and its backward once, by route; each Mamba layer's scan
    forward twice and its backward once."""
    from repro_torch.models.transformer import layer_plan

    routes = collections.Counter()
    if cfg.is_encdec:
        routes.update(bidirectional=cfg.encoder_layers, full=cfg.n_layers, cross=cfg.n_layers)
    elif cfg.block in ("attn", "hymba"):
        for c in layer_plan(cfg).classes:
            routes["windowed" if c.window else "full"] += c.count
    mamba = cfg.n_layers if cfg.block in ("mamba", "hymba") else 0
    assert cfg.remat, cfg.name
    return {"flash_attention": {r: 2 * n for r, n in routes.items()},
            "flash_attention_bwd": dict(routes),
            "selective_scan": 2 * mamba, "selective_scan_bwd": mamba}


def check_step_launches(cfg, launches: dict, routes: dict, steps: int) -> None:
    """Hold a run's launches (``read_counters``) and flash routes
    (:func:`flash_routes_recorded`) to ``steps`` times :func:`step_launches`,
    and every other kernel to none."""
    want = step_launches(cfg)
    for name in ("flash_attention", "flash_attention_bwd"):
        got = {r: n for r, n in routes[name].items() if n}
        assert got == {r: steps * n for r, n in want[name].items()}, (name, got, want)
        assert launches[name] == sum(got.values()), (name, launches, got)
    for name in ("selective_scan", "selective_scan_bwd"):
        assert launches[name] == steps * want[name], (name, launches, want)
    assert all(launches[k] == 0 for k in KERNELS if k not in want), launches


def train_run(cfg, cuda: torch.device, *, steps: int = None, batch: int = None,
              seq: int = None) -> dict:
    """``cfg`` trained through ``launch/train.py``'s ``train`` (fp32, from
    seed 0): ``steps`` AdamW steps (default TRAIN_STEPS; lr TRAIN_LR,
    warmup 5) on ``batch`` x ``seq`` tokens (default TRAIN_BATCH x
    TRAIN_SEQ; an encoder-decoder's batches add as many frames), every
    layer recomputed under remat. Returns the run's report; asserts finite
    losses and exactly :func:`step_launches` per step, flash by route."""
    from repro_torch.launch.train import train
    from repro_torch.models import build_model, count_params
    from repro_torch.models.moe import moe_ffn

    steps, batch, seq = steps or TRAIN_STEPS, batch or TRAIN_BATCH, seq or TRAIN_SEQ
    zero_counters()
    moe_ffn.routed, moe_ffn.dropped = 0, 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with cross_marked(), flash_routes_recorded() as routes:
        history = train(cfg, steps=steps, batch=batch, seq=seq, lr=TRAIN_LR, device=cuda)
    seconds = time.perf_counter() - t0
    launches = read_counters()
    free_memory()
    losses = [h["loss"] for h in history]
    step_s = [h["seconds"] for h in history]
    report = {
        "layers": cfg.n_layers,
        "params": count_params(build_model(cfg).template),
        "batch": batch, "seq": seq, "steps": steps,
        "losses": losses,
        "first3_mean": float(np.mean(losses[:3])),
        "last3_mean": float(np.mean(losses[-3:])),
        "grad_norms": [h["grad_norm"] for h in history],
        "lb_losses": [h["lb_loss"] for h in history],
        "s_per_step_median": statistics.median(step_s),
        "s_first_step": step_s[0],
        "seconds": seconds,
        "peak_gb": peak_gb(),
        "launches": launches,
        "launches_per_step": {k: launches[k] / steps for k in
                              ("flash_attention", "flash_attention_bwd", "selective_scan",
                               "selective_scan_bwd")},
        "flash_routes": {k: dict(v) for k, v in routes.items()},
    }
    if cfg.is_encdec:
        report["encoder_layers"] = cfg.encoder_layers
    if cfg.is_moe:
        report["moe_routed"] = moe_ffn.routed
        report["moe_dropped"] = int(moe_ffn.dropped)
    layers = (f"{cfg.encoder_layers} + {cfg.n_layers}" if cfg.is_encdec else str(cfg.n_layers))
    print(f"  {cfg.name}, {layers} layers, B={batch} S={seq}: {report['params'] / 1e9:.3f} B "
          "params fp32; losses " + " ".join(f"{x:.4f}" for x in losses)
          + f" (mean of the first 3 {report['first3_mean']:.4f}, of the last 3 "
          f"{report['last3_mean']:.4f})")
    print("  grad_norm " + " ".join(f"{x:.4g}" for x in report["grad_norms"]))
    print(f"  {report['s_per_step_median']:.4f} s/step (median; first step "
          f"{report['s_first_step']:.3f} s), peak {report['peak_gb']:.2f} GB, launches per "
          f"step {report['launches_per_step']}, flash routes {report['flash_routes']}"
          + (f", MoE routed {report['moe_routed']} dropped {report['moe_dropped']}"
             if cfg.is_moe else ""))
    assert all(np.isfinite(losses)), losses
    check_step_launches(cfg, launches, routes, steps)
    return report


def step0_setup(cfg, cuda: torch.device, *, batch: int = None, seq: int = None):
    """``cfg`` in fp32 as ``launch/train.py`` builds it, and batch 0
    (default TRAIN_BATCH x TRAIN_SEQ): (model, draw, batch), ``draw(move)``
    the weights drawn from seed 0 as ``launch/train.py`` draws them, and
    with ``move`` a seed, every weight then moved one fp32 ulp up or down
    (signs drawn from that seed)."""
    from repro_torch.models import build_model, init_from_template
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import SyntheticLM, make_batch

    cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model = build_model(cfg)

    def draw(move: int | None = None):
        params = init_from_template(model.template, torch.Generator(device=cuda).manual_seed(0),
                                    "float32", device=cuda)
        if move is not None:
            gen = torch.Generator(device=cuda).manual_seed(move)
            with torch.no_grad():
                for t in tree_leaves(params):
                    sign = torch.randint(0, 2, t.shape, generator=gen, device=cuda) * 2 - 1
                    t.mul_(1 + 2.0**-23 * sign)
        return params

    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq or TRAIN_SEQ,
                       global_batch=batch or TRAIN_BATCH)
    return model, draw, make_batch(cfg, data, 0, device=cuda)


def step0_gradients(cfg, cuda: torch.device, *, batch: int = None, seq: int = None,
                    calls: dict | None = None):
    """The train loss of ``cfg`` with its gradient on batch 0
    (:func:`step0_setup`) through the kernels and through the plain
    versions: (kernel, plain, the kernel run's launches and flash routes),
    kernel and plain as ``loss_and_grad`` returns them. With ``calls``, the
    kernel run's every flash and scan call is also held to its plain
    version (:func:`training_calls_compared`)."""
    from repro_torch.training.train_loop import loss_and_grad

    model, draw, batch = step0_setup(cfg, cuda, batch=batch, seq=seq)
    params = draw()
    zero_counters()
    with (cross_marked(), flash_routes_recorded() as routes,
          training_calls_compared(calls) if calls is not None else contextlib.nullcontext()):
        kernel = loss_and_grad(model, params, batch)
    launched = {**read_counters(), "routes": routes}
    with plain_versions():
        return kernel, loss_and_grad(model, params, batch), launched


def plain_one_ulp(cfg, cuda: torch.device, moves: int, *, batch: int = None, seq: int = None):
    """Yields, for seeds 1 .. ``moves``, the plain path's step-0 train loss
    and gradient (as :func:`step0_gradients`) with every weight moved one
    fp32 ulp, signs drawn from the seed: how far rounding alone moves the
    model's own fp32 loss and gradient."""
    from repro_torch.training.train_loop import loss_and_grad

    model, draw, batch = step0_setup(cfg, cuda, batch=batch, seq=seq)
    with plain_versions():
        for seed in range(1, moves + 1):
            yield loss_and_grad(model, draw(seed), batch)


def layer_grad_norms(grads) -> list[float]:
    """The gradient's norm over each layer's slice of the layer stacks,
    layer 0 first (one layer class, as the trained models have)."""
    from repro_torch.models.common import tree_flatten_with_names

    sq = sum(g.float().square().flatten(1).sum(1) for n, g in tree_flatten_with_names(grads)
             if n.startswith("['classes']"))
    return sq.sqrt().tolist()


def depth_witness(cfg, cuda: torch.device) -> dict:
    """Why the full-depth loss does not fall, measured at step 0: the
    gradient per layer through the kernels and through the plain
    versions. Holds that it grows toward the input on the plain path, so
    without the kernels (layer 0's norm at least DEPTH_GROWTH times the
    last layer's), as the JAX package's does at stablelm's depth
    (``tests/test_torch_training.py``), and that every layer's norm
    through the kernels is within a factor DEPTH_SPREAD of the plain one.
    Reports how far a one-ulp move of every weight shifts the plain
    path's own layer norms (what rounding alone does at this depth), and
    the share of parameters whose clipped gradient lies below AdamW's
    eps, the updates that the clip to norm 1 all but stops."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import AdamWConfig
    from repro_torch.training.optimizer import global_norm

    ((_, _), grads_k), ((_, _), grads_p), _ = step0_gradients(cfg, cuda)
    ((_, _), grads_u), = plain_one_ulp(cfg, cuda, 1)
    norm_k, norm_p = global_norm(grads_k).item(), global_norm(grads_p).item()
    layers_k, layers_p = layer_grad_norms(grads_k), layer_grad_norms(grads_p)
    layers_u = layer_grad_norms(grads_u)
    eps, clip = AdamWConfig().eps, AdamWConfig().clip_norm
    leaves = tree_leaves(grads_k)
    below = sum(int((g.abs() * (clip / norm_k) < eps).sum()) for g in leaves)
    report = {
        "grad_norm_kernels": norm_k, "grad_norm_plain": norm_p,
        "layer_grad_norms_kernels": layers_k, "layer_grad_norms_plain": layers_p,
        "growth_plain": layers_p[0] / layers_p[-1],
        "worst_layer_ratio": max(max(a / b, b / a) for a, b in zip(layers_k, layers_p)),
        "grad_norm_plain_one_ulp": global_norm(grads_u).item(),
        "layer_grad_norms_plain_one_ulp": layers_u,
        "worst_layer_ratio_one_ulp": max(max(a / b, b / a) for a, b in zip(layers_u, layers_p)),
        "share_below_eps": below / sum(g.numel() for g in leaves),
    }
    del grads_k, grads_p, grads_u, leaves
    free_memory()
    print(f"  step-0 gradient at full depth: norm {norm_k:.4g} through the kernels, "
          f"{norm_p:.4g} through the plain versions; per layer (0 .. {len(layers_p) - 1}) "
          "kernels " + " ".join(f"{x:.3g}" for x in layers_k)
          + " plain " + " ".join(f"{x:.3g}" for x in layers_p))
    print(f"  layer 0 / last layer {report['growth_plain']:.3g} on the plain path "
          f"(at least {DEPTH_GROWTH:g}); worst kernel / plain layer ratio "
          f"{report['worst_layer_ratio']:.3g} (at most {DEPTH_SPREAD:g}); the plain path's "
          f"own worst layer ratio with every weight moved one ulp "
          f"{report['worst_layer_ratio_one_ulp']:.3g} (norm "
          f"{report['grad_norm_plain_one_ulp']:.4g}); {report['share_below_eps']:.4f} of the "
          f"parameters' clipped gradients below eps {eps:g}")
    assert report["growth_plain"] >= DEPTH_GROWTH, report["growth_plain"]
    assert report["worst_layer_ratio"] <= DEPTH_SPREAD, report["worst_layer_ratio"]
    return report


def train_phase(name: str, cuda: torch.device) -> dict:
    """Phases 23-24: ``name`` at full width, fp32 (:func:`train_run`), at
    full depth and cut to TRAIN_CUT_LAYERS layers. The cut's loss must
    fall: the mean of its last 3 steps below that of its first 3. The
    full-depth run is held for finite losses and its launch counts, and
    its loss is printed, not held: the JAX init makes the random model's
    gradient grow toward the input, to a norm of ~1e10, so the clip to
    norm 1 leaves nearly every leaf's update below AdamW's eps and the
    loss moves by less than its batch to batch spread. :func:`depth_witness`
    measures that cause with and without the kernels (PERF.md, PR 24)."""
    from repro_torch.configs import get_config

    cfg = get_config(name)
    full = train_run(cfg, cuda)
    full["depth_witness"] = depth_witness(cfg, cuda)
    cut = train_run(dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS), cuda)
    assert cut["last3_mean"] < cut["first3_mean"], cut["losses"]
    return {"full_depth": full, "cut": cut}


def train_parity(cfg, cuda: torch.device, *, batch: int = None, seq: int = None) -> dict:
    """One train loss of ``cfg`` (fp32, a full-width cut) and its gradients
    through the kernels against the same through the plain versions on the
    card, the kernel run's launches exactly one step's
    (:func:`step_launches`), and every flash and scan call of that run,
    forward and backward, within MODEL_REL_TOL of its plain version on the
    step's own operands (:func:`training_calls_compared`).

    The loss is held within LOSS_REL_TOL relative and each parameter's
    gradient within GRAD_REL_TOL of its own scale, or, where the model's
    own fp32 value moves by more than that, within RESOLUTION_FACTOR times
    that move: the widest of ULP_MOVES evaluations of the plain path with
    every weight moved one fp32 ulp (:func:`plain_one_ulp`), taken for the
    loss and for each leaf on its own. The moves are measured only when a
    strict gate fails (the verdict is the same), and every leaf held to a
    gate wider than GRAD_REL_TOL is printed with its move."""
    from repro_torch.models.common import tree_flatten_with_names

    calls = {}
    ((loss_k, _), grads_k), ((loss_p, _), grads_p), launched = step0_gradients(
        cfg, cuda, batch=batch, seq=seq, calls=calls)
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    names = [n for n, _ in tree_flatten_with_names(grads_p)]
    leaves_p = [g for _, g in tree_flatten_with_names(grads_p)]
    errs = [_rel_err(g, w) for (_, g), w in zip(tree_flatten_with_names(grads_k), leaves_p)]
    del grads_k
    free_memory()
    loss_gate, gates, moves = LOSS_REL_TOL, [GRAD_REL_TOL] * len(errs), None
    if loss_rel > LOSS_REL_TOL or max(errs) > GRAD_REL_TOL:
        loss_move, moves = 0.0, [0.0] * len(errs)
        for (loss_u, _), grads_u in plain_one_ulp(cfg, cuda, ULP_MOVES, batch=batch, seq=seq):
            loss_move = max(loss_move, abs(loss_u.item() - loss_p.item()) / abs(loss_p.item()))
            moves = [max(m, _rel_err(g, w)) for m, (_, g), w in
                     zip(moves, tree_flatten_with_names(grads_u), leaves_p)]
            del grads_u
            free_memory()
        loss_gate = max(LOSS_REL_TOL, RESOLUTION_FACTOR * loss_move)
        gates = [max(GRAD_REL_TOL, RESOLUTION_FACTOR * m) for m in moves]
    worst, worst_leaf = max(zip(errs, names))
    wide = [(n, e, m) for n, e, m in zip(names, errs, moves or errs) if e > GRAD_REL_TOL]
    failed = [n for n, e, g in zip(names, errs, gates) if e > g]
    report = {"loss_rel_err": loss_rel, "loss_gate": loss_gate, "worst_grad_rel_err": worst,
              "worst_leaf": worst_leaf, "leaf_rel_err": dict(zip(names, errs)),
              "plain_one_ulp_loss_rel": None if moves is None else loss_move,
              "plain_one_ulp_leaf_rel": None if moves is None else dict(zip(names, moves)),
              "leaves_past_grad_tol": [n for n, e in zip(names, errs) if e > GRAD_REL_TOL],
              "leaves_failed": failed, "calls_rel_err": calls}
    routes = launched.pop("routes")
    layers = (f"{cfg.encoder_layers} + {cfg.n_layers}" if cfg.is_encdec else str(cfg.n_layers))
    print(f"  {cfg.name}, {layers} layers, B={batch or TRAIN_BATCH} S={seq or TRAIN_SEQ}: "
          f"step-0 loss kernel {loss_k.item()!r} plain {loss_p.item()!r} (rel {loss_rel:.3g}, "
          f"gate {loss_gate:.3g}); worst leaf gradient err / its scale {worst:.3g} "
          f"({worst_leaf}); {len(report['leaves_past_grad_tol'])} of {len(names)} leaves past "
          f"{GRAD_REL_TOL:g}, {len(failed)} past their gates")
    if moves is not None:
        print(f"    the plain path with every weight moved one ulp ({ULP_MOVES} moves): loss rel "
              f"{loss_move:.3g}; {sum(g > GRAD_REL_TOL for g in gates)} leaves held to "
              f"{RESOLUTION_FACTOR:g}x their own move, those past {GRAD_REL_TOL:g} (err / own "
              "move): " + ", ".join(f"{n} {e:.3g} / {m:.3g}" for n, e, m in wide))
    print("    every kernel call vs its plain version on the step's operands, worst err / "
          f"scale (tol {MODEL_REL_TOL:g}): " + ", ".join(f"{k} {v:.3g}" for k, v in calls.items()))
    print(f"    kernel launches {launched}, flash routes "
          f"{ {k: dict(v) for k, v in routes.items()} }")
    del grads_p, leaves_p
    free_memory()
    check_step_launches(cfg, launched, routes, 1)
    assert loss_rel <= loss_gate and not failed, (cfg.name, loss_rel, loss_gate, failed)
    assert calls and max(calls.values()) <= MODEL_REL_TOL, (cfg.name, calls)
    return report


def train_parity_phase(cuda: torch.device) -> dict:
    """Phase 25: a 3-layer full-width fp32 cut of stablelm-1.6b, one train
    loss and its gradients through the kernels against the same through
    the plain versions on the card."""
    from repro_torch.configs import get_config

    return train_parity(dataclasses.replace(get_config("stablelm-1.6b"),
                                            n_layers=TRAIN_CUT_LAYERS), cuda)


# Runs launch/train.py's main in a fresh process and SIGKILLs that process
# right after the checkpoint of step {kill_at} lands.
KILLED_RUN = """
import os, signal, sys
sys.path.insert(0, "src")
from repro_torch.launch import train as launcher
save = launcher.save_checkpoint
def save_then_die(directory, step, tree, **kw):
    path = save(directory, step, tree, **kw)
    if step == {kill_at}:
        os.kill(os.getpid(), signal.SIGKILL)
    return path
launcher.save_checkpoint = save_then_die
launcher.main({argv!r})
"""


def step_losses(stdout: str) -> dict[int, float]:
    """The per-step losses that launch/train.py prints."""
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"^step\s+(\d+) loss=(\S+)", stdout, re.M)}


def checkpoint_phase(cuda: torch.device) -> dict:
    """Phase 26: stablelm's smoke config on the card, 6 steps with a
    checkpoint every 3: uninterrupted here, then in a process killed after
    step 3's checkpoint and relaunched from it. Steps 4-6 must give the
    same losses, bit for bit."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import train

    out = Path(__file__).resolve().parent / "build" / "train_ckpt"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    argv = ["--arch", "stablelm-1.6b", "--smoke", "--steps", "6", "--ckpt-every", "3",
            "--seq", "64", "--ckpt-dir", str(out / "killed")]
    whole = train(get_smoke_config("stablelm-1.6b"), steps=6, batch=4, seq=64, lr=3e-3,
                  ckpt_dir=str(out / "whole"), ckpt_every=3, device=cuda)
    root = str(Path(__file__).resolve().parent)
    killed = subprocess.run([sys.executable, "-c", KILLED_RUN.format(kill_at=3, argv=argv)],
                            capture_output=True, text=True, timeout=600, cwd=root)
    assert killed.returncode == -9, (killed.returncode, killed.stderr[-2000:])
    size = sum(f.stat().st_size for f in (out / "killed").rglob("*") if f.is_file())
    relaunched = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *argv],
                                capture_output=True, text=True, timeout=600, cwd=root,
                                env={**os.environ, "PYTHONPATH": "src"})
    assert relaunched.returncode == 0, relaunched.stderr[-2000:]
    before, after = step_losses(killed.stdout), step_losses(relaunched.stdout)
    expected = {h["step"]: h["loss"] for h in whole}
    print(f"  killed after step 3 (exit {killed.returncode}) having run steps {sorted(before)}; "
          f"relaunched: {relaunched.stdout.splitlines()[0]!r}, steps {sorted(after)}; "
          f"checkpoint of step 3 on disk: {size} bytes")
    print(f"  losses uninterrupted {[expected[s] for s in (4, 5, 6)]} resumed "
          f"{[after.get(s) for s in (4, 5, 6)]}")
    assert "restored checkpoint at step 3" in relaunched.stdout, relaunched.stdout
    assert sorted(after) == [4, 5, 6], after
    assert all(after[s] == expected[s] for s in (4, 5, 6)), (after, expected)
    assert all(before[s] == expected[s] for s in (1, 2, 3)), (before, expected)
    shutil.rmtree(out, ignore_errors=True)
    return {"checkpoint_bytes": size, "losses": [expected[s] for s in range(1, 7)]}



def training_phases(cuda: torch.device, report: dict | None = None) -> tuple[dict, dict]:
    """Phases 22-26 (``report``: phase 2's SASS report). Returns training's
    launches of both flash kernels (phases 23-24, the counts zeroed before
    each run) and the backward kernel's entry of the kernels line."""
    print("[22] the flash-attention backward kernel vs its plain version, per call", flush=True)
    bwd = flash_bwd_phase(cuda, report)
    bwd_cases = bwd["cases"]
    reports = {}
    for phase, name in ((23, "stablelm-1.6b"), (24, "granite-moe-1b-a400m")):
        print(f"[{phase}] train {name} at full width, fp32, through launch/train.py: full "
              f"depth, then cut to {TRAIN_CUT_LAYERS} layers", flush=True)
        reports[name] = train_phase(name, cuda)
    runs = {f"{name} {run}": r[run] for name, r in reports.items() for run in r}
    train_launches = {k: sum(run["launches"][k] for run in runs.values())
                      for k in ("flash_attention", "flash_attention_bwd")}
    # Training's path launches the flash kernels and nothing else.
    assert all(run["launches"][k] == 0 for run in runs.values() for k in KERNELS
               if k != "flash_attention"), [run["launches"] for run in runs.values()]
    print(f"[25] training parity: a {TRAIN_CUT_LAYERS}-layer full-width fp32 cut of "
          "stablelm-1.6b, kernels vs plain versions on the card", flush=True)
    parity_report = train_parity_phase(cuda)
    print("[26] checkpoint kill and relaunch: stablelm's smoke config on the card", flush=True)
    ckpt = checkpoint_phase(cuda)
    main_case = bwd_cases[0]  # stablelm-1.6b's trained shape
    entry = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:76",
        "replaces_note": ("no TPU kernel: JAX's trainer differentiates XLA's chunked_attention "
                          "(attn_impl='xla'); this is the gradient of the port of "
                          "src/repro/kernels/flash_attention/flash_attention.py:113"),
        "launches": train_launches["flash_attention_bwd"],
        **{k: main_case[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
        "main_case": f"{main_case['shape']} {main_case['dtype']}",
        "library_note": ("the backward of F.scaled_dot_product_attention, fp32, through autograd, "
                         f"any backend ({main_case['library_backend']}); the memory-efficient "
                         f"backend alone: {main_case['library_efficient_ms']} ms"),
        "bound_note": (f"bytes {main_case['bytes_ms']} ms, 3xTF32 operations "
                       f"{main_case['tf32x3_ms']} ms at 495 / 3 TFLOP/s; fp32 on the CUDA cores "
                       f"{main_case['fp32_cuda_core_ms']} ms"),
        "tf32_sass": bwd["tf32_sass"],
        "fp32_forward": bwd["fp32_forward"],
        "launches_by_run": {name: run["launches"]["flash_attention_bwd"]
                            for name, run in runs.items()},
        "cases": bwd_cases,
        "training": reports,
        "train_parity": parity_report,
        "checkpoint": ckpt,
    }
    return train_launches, entry


# ---- training the SSM, hybrid and encoder-decoder families: phases 27-32 ---

SCAN_BWD_TOL = 1e-4  # each scan gradient against the plain backward, of its own scale
# Phase 27's cases: (B, S, Din, N, h0 given, dh_final given, steps a segment
# (None: the wrapper's choice), slot 0 of A at -1e4, label). The first two are
# the trained shapes of phases 29-30; the last four cross the boundaries of
# 64-step segments.
SCAN_BWD_CASES = (
    (4, 256, 8192, 16, False, False, None, False, "falcon-mamba-7b trained"),
    (2, 1280, 3200, 16, False, False, None, False, "hymba-1.5b trained"),
    (2, 37, 100, 5, True, True, None, False, "ragged: S past a chunk, Din past a block, N = 5"),
    (2, 63, 100, 16, True, True, 64, False, "S = L - 1, one segment of L = 64"),
    (2, 64, 100, 16, True, True, 64, False, "S = L"),
    (2, 65, 100, 16, True, True, 64, False, "S = L + 1, two segments"),
    (3, 300, 100, 5, True, True, 64, True,
     "five segments, the last ragged, Din past a block, N = 5, A at -1e4"),
)
# Phase 27's autograd wiring case: (B, S, Din, N).
SCAN_GRAD_SHAPE = (2, 300, 1024, 16)
# Phases 25 and 32: a loss or a gradient leaf whose own fp32 value moves by
# more than its gate when every weight of the plain path moves one ulp is
# held to this factor times the widest of ULP_MOVES such moves, measured for
# that loss or leaf (the kernel path and the plain path part as two such
# evaluations do).
RESOLUTION_FACTOR, ULP_MOVES = 2.0, 3
# Phases 29-31's runs at full (or 24-layer) depth take FAMILY_STEPS steps;
# their 3-layer cuts, whose loss must fall, TRAIN_STEPS.
FAMILY_STEPS = 10
# Phase 28: paper-block's trained shape at head_dim 8 (B=4, S=256 tokens and
# 256 frames, 100 heads of 8, KV = H), its three routes; the cross case with
# 320 frames, Sq != Skv. Same fields as BWD_CASES.
PAPER_BWD_CASES = (
    (4, 256, 256, 100, 100, 8, False, None, "paper-block's encoder, trained"),
    (4, 256, 256, 100, 100, 8, True, None, "paper-block's decoder, trained"),
    (4, 256, 320, 100, 100, 8, False, None, "paper-block's cross, Sq != Skv"),
)
# Phases 29-31: (arch, B, S, layers at "full" depth, None = the config's).
# falcon-mamba-7b's 64 layers do not fit: 7.006 B fp32 parameters with
# their gradients and AdamW's two moments take ~112 GB of the card's 80.
FAMILY_RUNS = (
    (29, "hymba-1.5b", 2, 1280, None),
    (30, "falcon-mamba-7b", 4, 256, 24),
    (31, "seamless-m4t-large-v2", 4, 256, None),
    (31, "paper-block", 4, 256, None),
)


def scan_bwd_bound(B, S, Din, N, with_h0, with_dh):
    """(bound ms, what bounds it, bytes ms, fp32 ms, SFU ms) of one scan
    backward. Bytes: x, dt, B, C, A, dy (h0, dh_final) read once; dx, ddt,
    dB, dC, dA, dh0 written once (the forward's checkpoints, the kernel's
    own, are not counted). Operations per (b, t, d, n): one exp(dt A) on the
    SFUs (h rebuilt from the inputs and the reverse step share it); about
    24 fp32 flops on the lanes (h's update, g, the dB, dC, dx, ddt and dA
    terms, the carry and the sums over d)."""
    elems = B * S * Din * N
    n_bytes = 4 * (5 * B * S * Din + 4 * B * S * N + 2 * Din * N
                   + (2 + int(with_h0) + int(with_dh)) * B * Din * N)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    fp32_ms = 24 * elems / PEAK_FLOPS[torch.float32] * 1e3
    sfu_ms = elems / SFU_PER_S * 1e3
    b_ms, b_by = max((bytes_ms, "bytes"), (max(fp32_ms, sfu_ms), "operations"))
    return b_ms, b_by, bytes_ms, fp32_ms, sfu_ms


def scan_bwd_case(B, S, Din, N, with_h0, with_dh, seg_steps, strong_decay, label,
                  gen) -> dict:
    """The scan's backward kernel against its plain version on the same
    operands (the forward kernel's checkpoints), a second call that must
    give the same bits, a planted fault (one dB element moved by 1% of
    dB's scale, the cross-block sum) that the check must catch, and the
    times: the backward kernel and its plain version, and the forward with
    and without the checkpoints it writes under grad. ``seg_steps``: the
    backward's segment length (None: the wrapper's choice);
    ``strong_decay``: slot 0 of A at -1e4, whose exp(dt A) underflows."""
    from repro_torch.kernels.selective_scan import (
        selective_scan, selective_scan_bwd, selective_scan_bwd_ref, selective_scan_fwd)
    from repro_torch.kernels.selective_scan.ops import _bwd_segment_steps

    ops = scan_operands(B, S, Din, N, with_h0, gen)
    if strong_decay:
        ops[4][:, 0] = -1e4
    dy = torch.randn(B, S, Din, generator=gen, device="cuda")
    dh = torch.randn(B, Din, N, generator=gen, device="cuda") if with_dh else None
    if seg_steps is None:
        seg_steps = _bwd_segment_steps(B, S, Din, N, torch.device("cuda"))
    _, _, ckpt = selective_scan_fwd(*ops)
    got = selective_scan_bwd(*ops, ckpt, dy, dh, _seg_steps=seg_steps)
    again = selective_scan_bwd(*ops, ckpt, dy, dh, _seg_steps=seg_steps)
    torch.cuda.synchronize()
    want = selective_scan_bwd_ref(*ops, dy, dh)
    names = ("dx", "ddt", "dB", "dC", "dA", "dh0")
    errs = {n: _rel_err(g, w) for n, g, w in zip(names, got, want)}
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    faulted = got[2].clone()
    faulted.view(-1)[faulted.numel() // 2] += 0.01 * want[2].abs().max()
    b_ms, b_by, bytes_ms, fp32_ms, sfu_ms = scan_bwd_bound(B, S, Din, N, with_h0, with_dh)
    return {
        "shape": f"B={B} S={S} Din={Din} N={N} h0={'given' if with_h0 else 'zero'} "
                 f"dh_final={'given' if with_dh else 'zero'} segments of {seg_steps or S} "
                 f"steps ({label})",
        "seg_steps": seg_steps,
        "dtype": "float32",
        "max_abs_err": max((g - w).abs().max().item() for g, w in zip(got, want)),
        "max_rel_err": max(errs.values()) if finite else float("inf"),
        "rel_err": errs,
        "planted_fault_rel_err": _rel_err(faulted, want[2]),
        "bitwise_repeat": all(torch.equal(a, b) for a, b in zip(got, again)),
        "tol": SCAN_BWD_TOL,
        "ms": time_ms(lambda: selective_scan_bwd(*ops, ckpt, dy, dh, _seg_steps=seg_steps)),
        "plain_ms": time_ms(lambda: selective_scan_bwd_ref(*ops, dy, dh)),
        "library_ms": None,
        "forward_ms": time_ms(lambda: selective_scan(*ops)),
        "forward_with_checkpoints_ms": time_ms(lambda: selective_scan_fwd(*ops)),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "bytes_ms": bytes_ms,
        "fp32_ms": fp32_ms,
        "sfu_ms": sfu_ms,
    }


def scan_bwd_phase(cuda: torch.device) -> dict:
    """Phase 27: the scan's backward kernel per call at SCAN_BWD_CASES, and
    ``selective_scan`` under autograd against autograd through the plain
    version (every operand's gradient, h0 and dh_final given)."""
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_ref

    gen = torch.Generator(device=cuda).manual_seed(27)
    cases = [scan_bwd_case(*c, gen) for c in SCAN_BWD_CASES]
    for c in cases:
        print(f"  selective_scan_bwd {c['shape']}: err / scale "
              + " ".join(f"{n} {e:.3g}" for n, e in c["rel_err"].items())
              + f" (tol {c['tol']:g}; planted fault {c['planted_fault_rel_err']:.3g}); repeat "
              f"bit for bit {c['bitwise_repeat']}; kernel {c['ms']:.4f} ms plain "
              f"{c['plain_ms']:.4f} ms, no library call; bound {c['bound_ms']:.4f} ms "
              f"({c['bound_by']}: bytes {c['bytes_ms']:.4f}, fp32 {c['fp32_ms']:.4f}, SFU "
              f"{c['sfu_ms']:.4f}); forward {c['forward_ms']:.4f} ms, with the backward's "
              f"checkpoints {c['forward_with_checkpoints_ms']:.4f} ms")
    bad = [c for c in cases if not (c["max_rel_err"] <= SCAN_BWD_TOL < c["planted_fault_rel_err"]
                                    and c["bitwise_repeat"])]
    assert not bad, f"the scan's backward kernel disagrees with its plain version: {bad}"
    B, S, Din, N = SCAN_GRAD_SHAPE
    leaves = [t.requires_grad_() for t in scan_operands(B, S, Din, N, True, gen)]
    grads_out = (torch.randn(B, S, Din, generator=gen, device=cuda),
                 torch.randn(B, Din, N, generator=gen, device=cuda))
    got = torch.autograd.grad(selective_scan(*leaves), leaves, grads_out)
    want = torch.autograd.grad(selective_scan_ref(*leaves), leaves, grads_out)
    wiring = max(_rel_err(g, w) for g, w in zip(got, want))
    print(f"  autograd through the kernels vs through the plain version (B={B} S={S} Din={Din} "
          f"N={N}, h0 and dh_final given): err / scale {wiring:.3g}")
    assert wiring <= SCAN_BWD_TOL, wiring
    return {"cases": cases, "autograd_rel_err": wiring}


def paper_flash_phase(cuda: torch.device) -> dict:
    """Phase 28: the flash backward kernel at head_dim 8 per call at
    paper-block's trained shape (phase 22's checks and times, SDPA's fp32
    backward beside it), and the head_dim-8 forward (flash_fwd_kernel<8, float, 4>)
    at the same shape, beside SDPA's fp32 forward."""
    gen = torch.Generator(device=cuda).manual_seed(28)
    cases = [flash_bwd_case(*c, gen) for c in PAPER_BWD_CASES]
    for c in cases:
        print(f"  flash_attention_bwd {c['shape']}: dq/dk/dv err / scale "
              + "/".join(f"{e:.3g}" for e in c["rel_err"].values())
              + f" (tol {c['tol']:g}; planted fault {c['planted_fault_rel_err']:.3g}), lse err "
              f"{c['lse_max_abs_err']:.3g} (tol {LSE_TOL:g}); repeat bit for bit "
              f"{c['bitwise_repeat']}; kernel {c['ms']:.4f} ms plain {c['plain_ms']:.4f} ms SDPA "
              f"backward {c['library_ms']:.4f} ms ({c['library_backend']}), efficient backend "
              f"alone {c['library_efficient_ms']:.4f} ms; bound {c['bound_ms']:.4f} ms "
              f"({c['bound_by']}: bytes {c['bytes_ms']:.4f}, 3xTF32 operations "
              f"{c['tf32x3_ms']:.4f})")
    bad = [c for c in cases if not (c["max_rel_err"] <= BWD_TOL < c["planted_fault_rel_err"]
                                    and c["lse_max_abs_err"] <= LSE_TOL
                                    and c["bitwise_repeat"])]
    assert not bad, f"the backward kernel at head_dim 8 disagrees with its plain version: {bad}"
    forward = [flash_case(B, Sq, H, KV, D, torch.float32, gen, Skv=Skv, causal=causal,
                          label=label)
               for B, Sq, Skv, H, KV, D, causal, _, label in PAPER_BWD_CASES]
    for c in forward:
        print(f"  flash_attention fp32 {c['shape']}: err {c['max_abs_err']:.3g} (tol "
              f"{c['tol']:g}); kernel {c['ms']:.4f} ms plain {c['plain_ms']:.4f} ms SDPA forward "
              f"{c['library_ms']:.4f} ms; bound {c['bound_ms']:.4f} ms ({c['bound_by']}; fp32 on "
              f"the CUDA cores {c['fp32_cuda_core_ms']:.4f} ms)")
    assert all(c["max_abs_err"] <= c["tol"] for c in forward), forward
    return {"cases": cases, "forward": forward}


def family_cfg(name: str, layers: int | None):
    """``name``'s full-width config, its depth cut to ``layers`` (both
    stacks of an encoder-decoder) when given."""
    from repro_torch.configs import get_config

    cfg = get_config(name)
    if layers is None:
        return cfg
    return dataclasses.replace(cfg, n_layers=layers,
                               **({"encoder_layers": layers} if cfg.is_encdec else {}))


def deep_gradient(cfg, cuda: torch.device, *, batch: int, seq: int) -> dict:
    """The deep run's step-0 gradient through the kernels, described: its
    global norm summed in fp64 (the trainer's fp32 sum of squares passes
    fp32's 3.4e38 once the norm passes ~1.8e19), its largest element, and
    whether every element is finite."""
    from repro_torch.models import build_model, init_from_template
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import SyntheticLM, make_batch
    from repro_torch.training.train_loop import loss_and_grad

    cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    params = init_from_template(model.template, torch.Generator(device=cuda).manual_seed(0),
                                "float32", device=cuda)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch)
    (_, _), grads = loss_and_grad(model, params, make_batch(cfg, data, 0, device=cuda))
    leaves = tree_leaves(grads)
    report = {"norm_fp64": math.sqrt(sum(g.double().square().sum().item() for g in leaves)),
              "max_abs": max(g.abs().max().item() for g in leaves),
              "all_finite": all(bool(torch.isfinite(g).all()) for g in leaves)}
    del params, grads, leaves
    free_memory()
    print(f"  step-0 gradient: norm {report['norm_fp64']:.4g} (summed in fp64), largest element "
          f"{report['max_abs']:.4g}, every element finite {report['all_finite']}")
    return report


def family_train_phase(name: str, batch: int, seq: int, layers: int | None,
                       cuda: torch.device) -> dict:
    """Phases 29-31: ``name`` at full width, fp32, through
    :func:`train_run` at ``layers`` (None: full depth), then cut to
    TRAIN_CUT_LAYERS layers (both stacks of an encoder-decoder), whose
    loss must fall (the mean of its last 3 steps below that of its first
    3). The deep run is held for finite losses and its launches per step;
    its loss is printed, not held (phases 23-24)."""
    deep = train_run(family_cfg(name, layers), cuda, steps=FAMILY_STEPS, batch=batch, seq=seq)
    deep["step0_gradient"] = deep_gradient(family_cfg(name, layers), cuda, batch=batch, seq=seq)
    cut = train_run(family_cfg(name, TRAIN_CUT_LAYERS), cuda, batch=batch, seq=seq)
    assert cut["last3_mean"] < cut["first3_mean"], cut["losses"]
    return {"deep": deep, "cut": cut}


def family_phases(cuda: torch.device) -> tuple[dict, dict, dict]:
    """Phases 27-32. Returns the training runs' launches (phases 29-31, the
    counts zeroed before each run), their flash forward launches by route,
    and the scan backward kernel's entry of the kernels line, which also
    carries phase 28's head_dim-8 cases and the runs' reports."""
    print("[27] the selective scan's backward kernel vs its plain version, per call", flush=True)
    scan = scan_bwd_phase(cuda)
    print("[28] the flash-attention backward kernel at head_dim 8, paper-block's trained shape",
          flush=True)
    paper = paper_flash_phase(cuda)
    reports = {}
    for phase, name, batch, seq, layers in FAMILY_RUNS:
        depth = "full depth" if layers is None else f"{layers} layers"
        print(f"[{phase}] train {name} at full width, fp32, B={batch} S={seq}, through "
              f"launch/train.py: {depth}, then cut to {TRAIN_CUT_LAYERS} layers", flush=True)
        reports[name] = family_train_phase(name, batch, seq, layers, cuda)
    print(f"[32] training parity: {TRAIN_CUT_LAYERS}-layer full-width fp32 cuts, kernels vs "
          "plain versions on the card", flush=True)
    parity = {name: train_parity(family_cfg(name, TRAIN_CUT_LAYERS), cuda, batch=batch, seq=seq)
              for _, name, batch, seq, _ in FAMILY_RUNS}
    runs = {f"{name} {run}": r[run] for name, r in reports.items() for run in r}
    launches = {k: sum(run["launches"][k] for run in runs.values())
                for k in ("flash_attention", "flash_attention_bwd", "selective_scan",
                          "selective_scan_bwd")}
    routes = {k: collections.Counter() for k in ("flash_attention", "flash_attention_bwd")}
    for run in runs.values():
        for k in routes:
            routes[k].update(run["flash_routes"][k])
    main_case = scan["cases"][0]  # falcon-mamba-7b's trained shape
    entry = {
        "name": "selective_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
        "replaces": "src/repro/models/ssm.py:65",
        "replaces_note": ("no TPU kernel: JAX's trainer differentiates its chunked XLA scan "
                          "(models/ssm.py:selective_scan); this is the gradient of the port of "
                          "src/repro/kernels/selective_scan/selective_scan.py:69"),
        "launches": launches["selective_scan_bwd"],
        **{k: main_case[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
        "main_case": f"{main_case['shape']} {main_case['dtype']}",
        "library_note": "no PyTorch call computes the recurrence's gradient",
        "bound_note": (f"bytes {main_case['bytes_ms']} ms; operations: fp32 "
                       f"{main_case['fp32_ms']} ms, SFU exp {main_case['sfu_ms']} ms"),
        "launches_by_run": {name: run["launches"]["selective_scan_bwd"]
                            for name, run in runs.items()},
        "cases": scan["cases"],
        "autograd_rel_err": scan["autograd_rel_err"],
        "flash_bwd_head_dim_8": paper,
        "training": reports,
        "train_parity": parity,
    }
    return launches, routes, entry


# ---- mesh serving: phases 33-40 ----------------------------------------------

MESH_LAYER_TOL = TOL[torch.bfloat16]  # a bf16 layer on a mesh vs the unsplit one, of its scale
MESH_CUT_LAYERS = 3  # the fp32 cut whose every first token must match the single-device port's
# Phase 33's cases: the attention kernels at each position's heads, (label,
# H, KV, D): stablelm-1.6b at model 2 (32 / 32 -> 16 / 16), qwen2.5-14b at
# model 2 (40 / 8 -> 20 / 4, G=5), granite-20b at model 4 (48 / 1 -> 12 / 1,
# KV replicated, G=12), and an uneven GQA split (H=12, KV=3 at model 4 of
# head_dim 128): positions 0 and 3 read one KV head (G=3), positions 1 and 2
# three, one per query head (G=1).
MESH_HEADS = (("stablelm-1.6b model 2", 16, 16, 64), ("qwen2.5-14b model 2", 20, 4, 128),
              ("granite-20b model 4", 12, 1, 128), ("uneven GQA, position 0", 3, 1, 128),
              ("uneven GQA, position 1", 3, 3, 128))
# The scan at each position's channels: falcon-mamba-7b (Din 8192 / 2) and
# hymba-1.5b (3200 / 2), at phase 7's and phase 13's served shapes.
MESH_SCANS = ((4, 128, 4096, 16), (1, 120, 4096, 16), (1, 1300, 1600, 16), (4, 8, 1600, 16))
MESH_FLEET = dict(n_groups=3, n_replicas=3, async_depth=2, seed=0)
# Depth cuts of the mesh phases (full width): the script's time limit.
MESH_QWEN_LAYERS, MESH_HYMBA_LAYERS, MESH_MAMBA_LAYERS = 12, 16, 16
MESH_MP_SPEC = {"arch": "stablelm-1.6b", "smoke": False, "seed": 0}  # phase 21's model


def mesh_over(device: torch.device, data: int, model: int):
    """A (data, model) serving mesh whose every position is ``device`` (a
    card by its index)."""
    from repro_torch.launch.mesh import make_serving_mesh

    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_serving_mesh(model_axis=model, data_axis=data, devices=[device] * (data * model))
    print(f"  mesh (data={data}, model={model}): positions "
          f"{[[str(d) for d in row] for row in mesh.devices]}")
    return mesh


def mesh_kernels_phase() -> dict[str, list[dict]]:
    """Phase 33: every kernel of the mesh path at the positions' shapes,
    held against its plain version with phase 3's tolerances."""
    gen = torch.Generator(device="cuda").manual_seed(33)
    out = {name: [] for name in ("flash_attention", "decode_attention", "paged_decode_attention",
                                 "paged_prefill_attention", "selective_scan")}
    for label, H, KV, D in MESH_HEADS:
        out["flash_attention"].append(flash_case(2, 120, H, KV, D, torch.bfloat16, gen,
                                                 label=label))
        out["decode_attention"].append(decode_case(4, 128, H, KV, D, [9, 40, 77, 128],
                                                   torch.bfloat16, gen, label=label))
        for int8 in (False, True):
            c = paged_decode_case(8, 16, H, KV, D, SERVE_LENGTHS, torch.bfloat16, int8, gen)
            out["paged_decode_attention"].append({**c, "shape": f"{c['shape']} ({label})"})
            c = paged_prefill_case(8, 32, 16, H, KV, D, PREFILL_OFFSETS, torch.bfloat16, int8, gen)
            out["paged_prefill_attention"].append({**c, "shape": f"{c['shape']} ({label})"})
    # qwen2.5-14b's speculative verify at model 2: C = k + 1 = 5.
    c = paged_prefill_case(8, 5, 16, 20, 4, 128, [0, 16, 40, 77, 100, 150, 200, 231],
                           torch.bfloat16, False, gen)
    out["paged_prefill_attention"].append({**c, "shape": f"{c['shape']} (qwen2.5-14b verify, "
                                                          "model 2)"})
    for B, S, Din, N in MESH_SCANS:
        out["selective_scan"].append(scan_case(B, S, Din, N, False, gen))
    for name, cases in out.items():
        for c in cases:
            print(f"  {name} {c['dtype']} {c['shape']}: err {c['max_abs_err']:.3g} kernel "
                  f"{c['ms']:.4f} ms plain {c['plain_ms']:.4f} ms library {c['library_ms']} "
                  f"bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
    bad = [(n, c["shape"]) for n, cs in out.items() for c in cs
           if not c.get("max_rel_err", c["max_abs_err"]) <= c["tol"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions at the positions' "
                             f"shapes: {bad}")
    print(f"  card: {card_name()}")
    return out


def _gathered(cache: list, tp, device) -> dict:
    """One layer's unsplit cache views from a slice's per-position views:
    each K/V head from a position that holds it and the SSM channels in
    position order, or position 0's where the block is replicated;
    copies, so the unsplit layer writes none of the slice's."""
    out = {k: v.clone() for k, v in cache[0].items()}
    if "k" in out and tp.plan.attn:
        where = {}
        for m, heads in enumerate(tp.kv_heads):
            for i, h in enumerate(heads):
                where.setdefault(h, (m, i))
        for name in ("k", "v"):
            out[name] = torch.stack([cache[m][name][..., i, :].to(device)
                                     for m, i in (where[h] for h in sorted(where))], dim=-2)
    for name, dim in (("conv", -1), ("ssm", -2)):
        if name in out and tp.plan.ssm:
            out[name] = torch.cat([c[name].to(device) for c in cache], dim=dim)
    return out


@contextlib.contextmanager
def routing_recorded():
    """Every MoE routing in the block: (experts chosen, kept) per token,
    [tokens, k] each, in call order."""
    from repro_torch.models import moe

    route, calls = moe._route, []

    def recorded(x, p, cfg, per_lane):
        out = route(x, p, cfg, per_lane)
        calls.append((out[3].reshape(-1, cfg.moe_top_k), out[6].reshape(-1, cfg.moe_top_k)))
        return out

    moe._route = recorded
    try:
        yield calls
    finally:
        moe._route = route


@contextlib.contextmanager
def mesh_layer_parity(params):
    """Hold every split layer call in the block (``transformer._layer``
    with several positions) against the unsplit layer on the same input
    and cache state: the full model's layer from ``params`` (found by its
    ``ln1`` row, which the placement shares), run after the split call
    with the kernel counters and the MoE counters restored, so the check
    adds no launch. An MoE layer's kept and dropped assignments must equal
    its unsplit call's on the same input (the layer's ``ln2`` norm of its
    input). Yields a report: calls, the worst error of each kind relative
    to the output's scale."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import rmsnorm as rmsnorm_plain
    from repro_torch.models.moe import moe_ffn, uncounted
    from repro_torch.models.parallel import one_position

    rows = {}
    for c, stack in params["classes"].items():
        for l in range(stack["ln1"].shape[0]):
            rows[stack["ln1"][l].data_ptr()] = (c, l)
    layer = transformer._layer
    report = {"prefill_calls": 0, "decode_calls": 0, "prefill_worst": 0.0, "decode_worst": 0.0,
              "moe_calls_equal": 0, "moe_worst": 0.0, "moe_tokens_moved": 0}

    def checked(x, p_layer, cfg, **kw):
        tp = kw["tp"]
        if tp.count == 1:
            return layer(x, p_layer, cfg, **kw)
        c, l = rows[p_layer[0]["ln1"].data_ptr()]
        full = transformer._layer_params(params["classes"][c], l)
        one = one_position(full, x.device).positions  # the unsplit layer
        cache = kw.get("cache")
        views = None if cache is None else [_gathered(cache, tp, x.device)]
        with routing_recorded() as split_routes:
            out = layer(x, p_layer, cfg, **kw)
        counts = read_counters()
        with uncounted():
            with routing_recorded() as routes:
                want = layer(x, [full], cfg, **{**kw, "tp": one, "cache": views})[0]
            # A token whose MoE routing moved (the split sum before the
            # router moved a near tie) is left out of the layer's error and
            # counted; the feed-forward is then held on one input below.
            moved = torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)
            for (e0, k0), (e1, k1) in zip(split_routes, routes):
                moved |= ((e0 != e1) | (k0 != k1)).any(-1).reshape(x.shape[:2])
            report["moe_tokens_moved"] += int(moved.sum())
            if cfg.is_moe:
                # The feed-forward alone on one input: the split call routes
                # on it as the unsplit call does (the sum before it may
                # move a near tie), so the kept and dropped assignments match.
                h = rmsnorm_plain(x, full["ln2"], cfg.rms_eps)
                moe = []
                for p, t in (([full], one), (p_layer, tp)):
                    r0, d0 = moe_ffn.routed, moe_ffn.dropped
                    y = transformer._ffn(h, p, cfg, per_lane=kw.get("per_lane", True), tp=t)[0]
                    moe.append((moe_ffn.routed - r0, int(moe_ffn.dropped - d0), y))
                assert moe[0][:2] == moe[1][:2], (cfg.name, moe[0][:2], moe[1][:2])
                report["moe_worst"] = max(report["moe_worst"], _rel_err(moe[1][2], moe[0][2]))
                report["moe_calls_equal"] += 1
        for name, fn in kernel_wrappers().items():
            fn.launches = counts[name]
        kept = ~moved[..., None]
        err = _rel_err(torch.where(kept, out[0], 0.0), torch.where(kept, want, 0.0))
        kind = "prefill" if cache is None else "decode"
        report[f"{kind}_calls"] += 1
        report[f"{kind}_worst"] = max(report[f"{kind}_worst"], err)
        assert err <= MESH_LAYER_TOL, f"{cfg.name} layer {c}[{l}] {kind}: {err:.3g} of scale"
        return out

    transformer._layer = checked
    try:
        yield report
    finally:
        transformer._layer = layer


def mesh_stage_parity(server, params, prompt_len: int = 96, n_decode: int = 2) -> dict:
    """Phase 34-38's layer check: the first stage calls of a prompt on the
    server's first slice — a whole-prompt prefill through every stage's
    placed weights, then ``n_decode`` decode steps — each split layer held
    to the unsplit layer (:func:`mesh_layer_parity`)."""
    cfg = server.cfg
    rng = np.random.default_rng(7)
    device = server._device_of(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, prompt_len))).to(device)
    max_len = prompt_len + n_decode + 1
    with torch.no_grad(), mesh_layer_parity(params) as report:
        caches, x = [], ids
        for g, (model_g, _) in enumerate(server.stages):
            out, cache = model_g.prefill(server._placed[(g, 0)],
                                         {"tokens" if g == 0 else "hidden": x}, max_len)
            caches.append(cache)
            x = out
        for _ in range(n_decode):
            x = x[:, -1].argmax(dim=-1, keepdim=True)
            for g, (model_g, _) in enumerate(server.stages):
                x, caches[g] = model_g.decode_step(server._placed[(g, 0)], x, caches[g])
        torch.cuda.synchronize()
    print(f"  layer check, {len(server.stages)} stages on slice 0: {report['prefill_calls']} "
          f"prefill and {report['decode_calls']} decode layer calls, worst "
          f"{report['prefill_worst']:.3g} / {report['decode_worst']:.3g} of scale (limit "
          f"{MESH_LAYER_TOL}); MoE calls with the unsplit kept and dropped assignments: "
          f"{report['moe_calls_equal']} (outputs within {report['moe_worst']:.3g} of scale); "
          f"tokens whose routing moved, left out of the layer error: "
          f"{report['moe_tokens_moved']}")
    assert report["moe_worst"] <= MESH_LAYER_TOL, report
    assert report["prefill_calls"] > 0 and report["decode_calls"] > 0, report
    return report


def position_memory(server) -> dict:
    """Bytes per (slice, position): its weight shards over every stage
    (replicated leaves at position 0, where they live) and its replicas'
    caches or pools."""
    out = collections.defaultdict(lambda: {"weights_gb": 0.0, "cache_gb": 0.0})
    gb = lambda tree: sum(t.numel() * t.element_size() for t in _leaves(tree)) / 1e9  # noqa: E731
    for (g, d), placed in server._placed.items():
        for m, shard in enumerate(placed.shards):
            out[f"{d},{m}"]["weights_gb"] += gb(shard)
    for (g, r), cache in server._caches.items():
        for m, tree in enumerate(cache):
            out[f"{server._slice_of[r]},{m}"]["cache_gb"] += gb(tree)
    return dict(out)


def serve_on_mesh(label: str, model, params, mesh, *, prompts, n_slots: int, kernels,
                  draft=None, **kw) -> tuple[object, dict, dict]:
    """One full-width mesh run: the server placed, counters zeroed, the
    direct prompts and ``run(n_slots)`` served, counters read. Fails if a
    kernel of ``kernels`` never launched, a token is out of the
    vocabulary, or a cache left the card. Returns the server, the
    launches and a report."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import attention
    from repro_torch.serving import PipelineServer

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    server = PipelineServer(model, params, mesh=mesh, spec_draft=draft, **MESH_FLEET, **kw)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    V = model.cfg.vocab_size
    flash_key = lambda q, k, v, causal=True, window=None: "windowed" if window else "full"  # noqa: E731
    zero_counters()
    t0 = time.perf_counter()
    with torch.no_grad(), routes_recorded() as routes, \
            calls_recorded(attention, "flash_attention", flash_key) as flash_calls:
        direct = [server.submit(rng.integers(0, V, size=L), n_tokens=8) for L in prompts]
        stats = server.run(n_slots, arrival_p=0.5)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    assert flash_attention.launches == launches["flash_attention"]
    memory = position_memory(server)
    calls = {"prefill_calls": stats.prefill_calls, "chunk_prefill_calls":
             stats.chunk_prefill_calls, "decode_calls": stats.decode_calls,
             "verify_calls": stats.verify_calls, "draft_calls": stats.draft_calls}
    by_route = {"paged_prefill_attention": dict(routes),
                "flash_attention": dict(collections.Counter(flash_calls))}
    report = {"label": label, "tokens": stats.tokens_generated, "wall_s": wall,
              "tokens_per_s": stats.tokens_generated / wall, "place_s": place_s,
              "completed": stats.completed_jobs, "slots": stats.slots, **calls,
              "spec_accepted": stats.spec_accepted, "spec_proposed": stats.spec_proposed,
              "peak_gb": peak_gb(), "positions": memory, "launches": launches,
              "launches_by_route": by_route}
    print(f"  {label}: tokens={stats.tokens_generated} completed={stats.completed_jobs} "
          f"wall_s={wall:.3f} tokens_per_s={report['tokens_per_s']:.2f} (placing the weights "
          f"{place_s:.2f} s) peak_gb={report['peak_gb']:.2f}; stage calls {calls}")
    print(f"  launches {launches}; by route {by_route}")
    print("  per (slice, position): " + "; ".join(
        f"{k} weights {v['weights_gb']:.2f} GB cache {v['cache_gb']:.3f} GB"
        for k, v in sorted(memory.items())))
    assert stats.tokens_generated > 0 and stats.completed_jobs >= 1, f"{label}: nothing served"
    assert all(0 <= t < V for r in direct if r is not None for t in r.generated)
    if server.device.type == "cuda":
        assert all(launches[k] > 0 for k in kernels), f"{label}: a kernel never ran: {launches}"
    assert launches["rmsnorm"] == 0, f"{label}: a served path launched rmsnorm"
    assert all(t.device.type == server.device.type for c in server._caches.values()
               for t in _leaves(c)), f"{label}: a cache left the card"
    return server, launches, report


def mesh_first_tokens(name: str, mesh_shape, cuda, *, prompts, n_slots: int, **kw) -> dict:
    """A 3-layer full-width fp32 cut of ``name`` served by the single-device
    port and by the mesh server on one schedule: every request's first
    token must be equal (whole streams are counted, not held: PERF.md
    section 7 question 5), and for MoE the routed and dropped assignments."""
    from repro_torch.models import build_model, init_from_template
    from repro_torch.models.moe import moe_ffn
    from repro_torch.serving import PipelineServer

    cfg = family_cfg(name, MESH_CUT_LAYERS)
    cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    params = init_from_template(model.template, torch.Generator(device=cuda).manual_seed(0),
                                "float32", device=cuda)
    runs = []
    for mesh in (None, mesh_over(cuda, *mesh_shape)):
        server = PipelineServer(model, params, mesh=mesh, device=None if mesh else cuda,
                                **MESH_FLEET, **kw)
        reqs = []
        submit = server.submit
        server.submit = lambda *a, **k: reqs.append(submit(*a, **k)) or reqs[-1]
        rng = np.random.default_rng(1)
        moe_ffn.routed, moe_ffn.dropped = 0, 0
        saved = read_counters()
        with torch.no_grad():
            for L in prompts:
                server.submit(rng.integers(0, cfg.vocab_size, size=L), n_tokens=4)
            server.run(n_slots, arrival_p=0.5)
        for fn_name, fn in kernel_wrappers().items():
            fn.launches = saved[fn_name]  # a check: its launches do not count
        runs.append(([list(r.generated) if r is not None else None for r in reqs],
                     (moe_ffn.routed, int(moe_ffn.dropped))))
        del server
    (want, want_moe), (got, got_moe) = runs
    firsts = [(a[0] if a else None, b[0] if b else None) for a, b in zip(want, got)
              if a is not None and b is not None]
    assert len(want) == len(got) and firsts and all(a == b for a, b in firsts), \
        f"{name}: first tokens differ on the fp32 cut: {firsts}"
    equal_streams = sum(a == b for a, b in zip(want, got))
    if cfg.is_moe:
        assert want_moe == got_moe, (want_moe, got_moe)
    print(f"  fp32 {MESH_CUT_LAYERS}-layer cut: {len(firsts)} first tokens equal to the "
          f"single-device port's; whole streams equal {equal_streams} of {len(want)}"
          + (f"; MoE routed / dropped {got_moe} both" if cfg.is_moe else ""))
    del params
    free_memory()
    return {"first_tokens_equal": len(firsts), "streams_equal": equal_streams,
            "requests": len(want), **({"moe_routed_dropped": got_moe} if cfg.is_moe else {})}


def mesh_model(name: str, layers: int | None, cuda):
    """``name`` at full width, cut to ``layers`` layers (None: all), bf16,
    seed 0."""
    from repro_torch.models import build_model, count_params, init_from_template

    cfg = family_cfg(name, layers)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = init_from_template(model.template, torch.Generator(device=cuda).manual_seed(0),
                                cfg.param_dtype, device=cuda)
    torch.cuda.synchronize()
    print(f"  {name}: {cfg.n_layers} of {family_cfg(name, None).n_layers} layers at full width "
          f"(d_model {cfg.d_model}), {count_params(model.template) / 1e9:.3f} B params, drawn in "
          f"{time.perf_counter() - t0:.2f} s")
    return model, params


def mesh_serve_phase(phase: str, name: str, layers, shape, cuda, runs: dict, *, kernels,
                     prompts, n_slots: int, cut_kw=None, draft: str | None = None,
                     variants=(("dense", {}),)) -> dict:
    """One model's mesh phase: the full-width runs of ``variants`` (their
    launches into ``runs``), the layer check on the first stage calls,
    and the fp32 cut's first tokens against the single-device port."""
    model, params = mesh_model(name, layers, cuda)
    mesh = mesh_over(cuda, *shape)
    draft_pair = None
    if draft is not None:
        draft_pair = load_model(draft, 1, cuda)
    report = {"layers": model.cfg.n_layers, "mesh": {"data": shape[0], "model": shape[1]}}
    server = None
    for variant, kw in variants:
        server = None
        free_memory()
        server, launches, rep = serve_on_mesh(
            f"{name} {variant} on (data={shape[0]}, model={shape[1]})", model, params, mesh,
            prompts=prompts, n_slots=n_slots, kernels=kernels[variant],
            draft=draft_pair if "spec_k" in kw else None, **kw)
        runs[f"mesh {name} {variant}"] = launches
        report[variant] = rep
    report["plan"] = dataclasses.asdict(server._placed[(0, 0)].positions.plan)
    report["layer_check"] = mesh_stage_parity(server, params)
    del server, params, draft_pair
    free_memory()
    report["fp32_cut"] = mesh_first_tokens(name, shape, cuda, prompts=prompts[:2],
                                           n_slots=min(n_slots, 12), **(cut_kw or {}))
    return report


def mesh_multiprocess_phase(cuda: torch.device) -> tuple[dict, dict]:
    """Phase 39: phase 21's fleet with ``mesh_model=2``: stablelm-1.6b at
    full width, G=2 x R=2, four workers with two positions each on the
    card, beside the in-process mesh server on a (1, 2) mesh over the same
    card, through a SIGKILL of stage 0's replica 0 and a respawn; streams
    and counters must be equal. Returns the workers' launches and a
    report."""
    from repro_torch.core.network import DeviceSpec
    from repro_torch.ft import ElasticController
    from repro_torch.serving import MPPipelineServer, PipelineServer

    model, params = load_model("stablelm-1.6b", 0, cuda)
    V = model.cfg.vocab_size
    ref = PipelineServer(model, params, mesh=mesh_over(cuda, 1, 2), **MP_FLEET)
    specs = [[DeviceSpec(6, 10, ref.pm_policy) for _ in range(ref.R)] for _ in range(ref.G)]
    ref.elastic = ElasticController(ref.router, specs, device=cuda)
    saved = read_counters()
    with torch.no_grad():
        want = mp_waves(ref, V,
                        lambda: (ref.fail_replica(0, 0), ref._abort_ring(0, 0)),
                        lambda: (ref.scheduler.evict_stage_residents(0, 0),
                                 ref.recover_replica(0, 0)))
    for name, fn in kernel_wrappers().items():
        fn.launches = saved[name]  # the reference's launches do not count
    ref_stats = {k: getattr(ref.stats, k) for k in STAT_COUNTERS}
    del ref, params, model
    free_memory()

    t0 = time.perf_counter()
    mp = MPPipelineServer(MESH_MP_SPEC, device=cuda, mesh_model=2, **MP_FLEET)
    procs = [w.proc for w in mp._workers.values()]
    seen = {}
    try:
        spawn_s = time.perf_counter() - t0
        boot = mp.ping()

        def fault():
            w = mp._workers[(0, 0)]
            w.proc.kill()
            w.proc.wait()

        def recover():
            t = time.perf_counter()
            mp.recover_replica(0, 0)
            seen["respawn_s"] = time.perf_counter() - t
            procs.append(mp._workers[(0, 0)].proc)

        def after_wave(wave):
            if wave == 0:
                seen["killed"] = mp.ping()[(0, 0)]["launches"]

        with torch.no_grad():
            got = mp_waves(mp, V, fault, recover, after_wave)
        final = mp.ping()
        mp_stats = {k: getattr(mp.stats, k) for k in STAT_COUNTERS}
    finally:
        mp.close()
    assert all(p.poll() is not None for p in procs), "a worker outlived the server"
    for i, (a, b) in enumerate(zip(want, got)):
        assert a["streams"] == b["streams"], f"wave {i + 1}: the streams differ"
    assert mp_stats == ref_stats, (mp_stats, ref_stats)
    assert all(p["mesh_model"] == 2 for p in {**boot, **final}.values())
    if cuda.type == "cuda":
        assert all(p["launches"][k] > 0 for p in final.values() for k in MP_KERNELS)
    launches = {k: sum(p["launches"][k] for p in final.values()) + seen["killed"][k]
                for k in KERNELS}
    gb = 1e9
    workers = {f"{g},{r}": {k: (p[f"{k[:-3]}_bytes"] or 0) / gb
                            for k in ("build_peak_gb", "peak_gb", "reserved_gb")}
               | {"launches": p["launches"]} for (g, r), p in final.items()}
    tps = lambda waves: sum(w["tokens"] for w in waves) / sum(w["wall_s"] for w in waves)  # noqa: E731
    report = {"spawn_s": spawn_s, "respawn_s": seen["respawn_s"], "workers": workers,
              "in_process_tokens_per_s": tps(want), "multiprocess_tokens_per_s": tps(got),
              "stats": mp_stats, "launches": launches}
    print(f"  spawn {spawn_s:.2f} s (4 workers x 2 positions), respawn "
          f"{seen['respawn_s']:.2f} s; tokens/s in process (1, 2) mesh {tps(want):.2f}, "
          f"multi-process {tps(got):.2f}; streams and stats equal {mp_stats}")
    for key, w in workers.items():
        print(f"  worker {key}: build peak {w['build_peak_gb']:.2f} GB, serve peak "
              f"{w['peak_gb']:.2f} GB, reserved {w['reserved_gb']:.2f} GB; launches "
              f"{w['launches']}")
    return launches, report


def pipeline_phase(cuda: torch.device) -> dict:
    """Phase 40: ``pipeline_apply``, four stages x eight microbatches on
    four positions of the card, against the stages applied in sequence to
    each microbatch (the same products: equal bit for bit) and to the
    whole batch (within fp32 rounding)."""
    from repro_torch.distributed import Mesh, pipeline_apply

    gen = torch.Generator(device=cuda).manual_seed(40)
    w = torch.randn(4, 1024, 1024, generator=gen, device=cuda) * 0.03
    x = torch.randn(64, 1024, generator=gen, device=cuda)
    mesh = Mesh(np.array([cuda] * 4, dtype=object), ("stage",))
    stage = lambda p, h: torch.tanh(h @ p)  # noqa: E731
    t0 = time.perf_counter()
    got = pipeline_apply(mesh, stage, w, x, n_micro=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_micro, whole = list(x.split(8)), x
    for s in range(4):
        per_micro = [stage(w[s], h) for h in per_micro]
        whole = stage(w[s], whole)
    exact = (got - torch.cat(per_micro)).abs().max().item()
    err = (got - whole).abs().max().item()
    print(f"  4 stages x 8 microbatches of 8 x 1024: max |pipeline - sequential| {exact:.3g} "
          f"per microbatch (0 expected), {err:.3g} against the whole batch; {wall * 1e3:.2f} ms")
    assert exact == 0.0 and err <= TOL[torch.float32], (exact, err)
    return {"max_abs_err_per_microbatch": exact, "max_abs_err": err, "wall_ms": wall * 1e3}


def mesh_phases(cuda: torch.device) -> tuple[dict, dict, dict]:
    """Phases 33-40. Returns the kernels' cases at the positions' shapes,
    the mesh runs' launches by run, and the report."""
    print("[33] kernels at the mesh positions' shapes vs plain versions", flush=True)
    cases = mesh_kernels_phase()
    runs: dict = {}
    report: dict = {"card": card_name()}
    attn = ("flash_attention", "decode_attention")
    paged = ("paged_decode_attention", "paged_prefill_attention")
    print("[34] serve full-width stablelm-1.6b on a (data=2, model=2) mesh, G=3 x R=3: dense, "
          "then paged with int8 pages and chunked prefill (phase 4's and 5's schedules)",
          flush=True)
    report["stablelm-1.6b"] = mesh_serve_phase(
        "34", "stablelm-1.6b", None, (2, 2), cuda, runs, prompts=(64, 88, 104, 120), n_slots=60,
        kernels={"dense": attn, "paged int8 chunked": paged},
        variants=(("dense", dict(max_batch=4, max_len=128)),
                  ("paged int8 chunked", dict(paged=True, page_size=16, max_pages=32,
                                              max_batch=8, max_len=256, prefill_chunk=32,
                                              kv_dtype="int8"))),
        cut_kw=dict(max_batch=4, max_len=128))
    print(f"[35] serve qwen2.5-14b at full width ({MESH_QWEN_LAYERS} of 48 layers) on a "
          "(1, 2) mesh, paged, speculative with its stablelm-1.6b draft", flush=True)
    report["qwen2.5-14b"] = mesh_serve_phase(
        "35", "qwen2.5-14b", MESH_QWEN_LAYERS, (1, 2), cuda, runs, prompts=(64, 112, 160, 200),
        n_slots=30, draft="stablelm-1.6b",
        # Every decode is a verify (paged prefill) and the draft's steps
        # (dense decode): the paged-decode kernel has no call, as in phase 10.
        kernels={"paged speculative": attn + ("paged_prefill_attention",)},
        variants=(("paged speculative", dict(paged=True, page_size=16, max_batch=8,
                                             max_len=256, spec_k=4)),),
        cut_kw=dict(paged=True, page_size=16, max_batch=8, max_len=256))
    print(f"[36] serve hymba-1.5b at full width ({MESH_HYMBA_LAYERS} of 32 layers) on a (1, 2) "
          "mesh: rings, replicated attention, split SSM", flush=True)
    report["hymba-1.5b"] = mesh_serve_phase(
        "36", "hymba-1.5b", MESH_HYMBA_LAYERS, (1, 2), cuda, runs, prompts=(1100, 1300),
        n_slots=30, kernels={"dense": attn + ("selective_scan",)},
        variants=(("dense", dict(max_batch=4, max_len=HYMBA_MAX_LEN)),),
        cut_kw=dict(max_batch=4, max_len=HYMBA_MAX_LEN))
    print(f"[37] serve falcon-mamba-7b at full width ({MESH_MAMBA_LAYERS} of 64 layers) on a "
          "(1, 2) mesh", flush=True)
    report["falcon-mamba-7b"] = mesh_serve_phase(
        "37", "falcon-mamba-7b", MESH_MAMBA_LAYERS, (1, 2), cuda, runs,
        prompts=(64, 88, 104, 120), n_slots=30, kernels={"dense": ("selective_scan",)},
        variants=(("dense", dict(max_batch=4, max_len=128)),),
        cut_kw=dict(max_batch=4, max_len=128))
    print("[38] serve granite-moe-1b-a400m at full width on a (1, 4) mesh: experts split, "
          "routing global", flush=True)
    report["granite-moe-1b-a400m"] = mesh_serve_phase(
        "38", "granite-moe-1b-a400m", None, (1, 4), cuda, runs, prompts=(64, 88, 104, 120),
        n_slots=30, kernels={"dense": attn},
        variants=(("dense", dict(max_batch=4, max_len=128)),),
        cut_kw=dict(max_batch=4, max_len=128))
    print("[39] serve full-width stablelm-1.6b through four worker processes with mesh_model=2, "
          "a SIGKILL failover and a respawn", flush=True)
    runs["mesh multiprocess"], report["multiprocess"] = mesh_multiprocess_phase(cuda)
    print("[40] pipeline_apply: four stages on the card against the sequential result",
          flush=True)
    report["pipeline"] = pipeline_phase(cuda)
    free_memory()
    return cases, runs, report


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.models import build_model, count_params, init_from_template
    from repro_torch.models.common import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(f"[1] card: {card_name()}", flush=True)

    info = _build.build()
    _build.load()
    print(f"[2] build: {info.seconds:.2f} s -> {info.path}")
    report = kernel_report(info)
    for name, r in sorted(report.items()):
        print(f"    {name}: {r.get('registers')} registers, {r.get('spill_bytes')} spill bytes, "
              f"{r.get('static_smem')} B static smem, HGMMA {r.get('hgmma')}, HMMA {r.get('hmma')}, "
              f"MUFU.EX2 {r.get('mufu_ex2')}")
    tensor_core = _build.tensor_core_check(report)
    tf32 = _build.tensor_core_check(report, _build.TF32_KERNELS, key="hmma_tf32")
    for name in (n for kernel in tf32.values() for n in kernel):
        r = report[name]
        print(f"    {name}: HMMA on TF32 {r['hmma_tf32']} (of {r['hmma']} HMMA), FFMA "
              f"{r['ffma']}, {r.get('registers')} registers, {r.get('spill_bytes')} spill bytes")

    print("[3] kernels vs plain versions", flush=True)
    results = check_kernels()
    rmsnorm.launches = 0  # no served path below may launch it

    print("[4] serve full-width stablelm-1.6b", flush=True)
    cfg = get_config("stablelm-1.6b")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_from_template(model.template, gen, cfg.param_dtype, device="cuda")
    torch.cuda.synchronize()
    print(f"  weights: {count_params(model.template) / 1e9:.3f} B params "
          f"({cfg.param_dtype}) in {time.perf_counter() - t0:.2f} s")
    cuda = torch.device("cuda")
    # bf16 queries: the served attention calls launch the tensor-core
    # instantiations of the prefill kernels (phases 4 and 5).
    assert cfg.compute_dtype == torch.bfloat16, cfg.dtype
    with torch.no_grad():
        launches, decode_served = serve(params, model, cuda)

    print("[5] serve full-width stablelm-1.6b, paged, chunked prefill", flush=True)
    by_run, paged_served = {}, {}
    with torch.no_grad():
        for kv_dtype in (None, "int8"):
            run = kv_dtype or "bf16"
            by_run[run], paged_served[run] = serve_paged(params, model, cuda, kv_dtype)
    for name in PAGED_KERNELS:
        launches[name] = sum(run[name] for run in by_run.values())

    print("[6] parity at full width, fp32", flush=True)
    parity(params, cfg, cuda)
    del params, model
    torch.cuda.empty_cache()

    print("[7] serve full-width falcon-mamba-7b", flush=True)
    cfg = get_config("falcon-mamba-7b")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_from_template(model.template, gen, cfg.param_dtype, device="cuda")
    torch.cuda.synchronize()
    print(f"  weights: {count_params(model.template) / 1e9:.3f} B params "
          f"({cfg.param_dtype}) in {time.perf_counter() - t0:.2f} s")
    with torch.no_grad():
        ssm_launches, scan_served = serve_ssm(params, model, cuda)
    launches.update(ssm_launches)
    # The models call their plain rmsnorm (models/layers.py), as the JAX models do.
    launches["rmsnorm"] = rmsnorm.launches
    assert launches["rmsnorm"] == 0, f"a served path launched rmsnorm: {launches}"

    print("[8] SSM parity at full width, fp32", flush=True)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    del params
    torch.cuda.empty_cache()
    ssm_checks = ssm_parity(params32, build_model(cfg32), cuda)
    del params32
    free_memory()

    print("[9] serve full-width granite-20b, dense, chunked prefill", flush=True)
    model, params = load_model("granite-20b", 0, cuda)
    with torch.no_grad():
        chunked_launches, chunked = serve_dense_chunked(params, model, cuda)
    del params, model
    free_memory()

    print("[10] serve full-width qwen2.5-14b, paged, speculative with its registry draft",
          flush=True)
    from repro_torch.models.registry import default_draft_for

    model, params = load_model("qwen2.5-14b", 0, cuda)
    draft, draft_params = load_model(default_draft_for("qwen2.5-14b"), 1, cuda)
    with torch.no_grad():
        spec_launches, spec_served = serve_spec(params, model, draft, draft_params, cuda)
    del params, model, draft, draft_params
    free_memory()
    for name in KERNELS:
        launches[name] += chunked_launches[name] + spec_launches[name]
    assert launches["rmsnorm"] == 0, f"a served path launched rmsnorm: {launches}"
    # Phase 5 launches the kernel on the paged-chunk route only.
    routes = {"paged_chunk": sum(run["paged_prefill_attention"] for run in by_run.values())}
    for route in ("paged_chunk", "verify", "dense_chunk"):
        routes[route] = routes.get(route, 0) + chunked["routes"].get(route, 0) \
            + spec_served["routes"].get(route, 0)
    assert all(n > 0 for n in routes.values()), f"a paged-prefill route never ran: {routes}"

    print("[11] speculative parity at full width, fp32, stablelm-1.6b drafting for itself",
          flush=True)
    cfg = get_config("stablelm-1.6b")
    params = init_from_template(build_model(cfg).template,
                                torch.Generator(device="cuda").manual_seed(0),
                                cfg.param_dtype, device="cuda")  # phase 4's weights
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    del params
    torch.cuda.reset_peak_memory_stats()
    spec_checks = spec_parity(params32, build_model(cfg32), cuda)
    del params32
    free_memory()

    print("[12] the paper's simulator and analytics on the card", flush=True)
    print("  simulator:", json.dumps(simulator_phase(cuda)))

    hybrid_launches, hybrid = hybrid_phase(cuda)
    for name in KERNELS:
        launches[name] += hybrid_launches[name]
    assert launches["rmsnorm"] == 0, f"a served path launched rmsnorm: {launches}"

    print("[15] serve full-width granite-moe-1b-a400m, dense and paged", flush=True)
    moe_runs, granite_report = moe_dense_phase(cuda)
    print("[16] serve full-width qwen3-moe-30b-a3b, paged, speculative with its registry draft "
          "phi4-mini-3.8b; then phi4-mini-3.8b served paged", flush=True)
    spec_runs, qwen_report, carried = moe_spec_phase(cuda)
    moe_runs.update(spec_runs)
    print("[17] MoE parity, fp32", flush=True)
    moe_checks = moe_parity_phase(cuda, carried)
    del carried
    free_memory()
    for run_launches, run in moe_runs.values():
        for name in KERNELS:
            launches[name] += run_launches.get(name, 0)
        for route in routes:
            routes[route] += run.get("routes", {}).get(route, 0)
    assert launches["rmsnorm"] == 0, f"a served path launched rmsnorm: {launches}"

    print("[18] serve full-size seamless-m4t-large-v2 and paper-block, encoder-decoders",
          flush=True)
    encdec_launches, encdec = encdec_serve_phase(cuda)
    print("[19] encoder-decoder parity, fp32 cuts of 3 + 3 layers at full width", flush=True)
    encdec_checks = encdec_parity_phase(cuda)
    print(f"[20] internvl2-76b, {VLM_LAYERS} of 80 layers at full width, patches frontend",
          flush=True)
    vlm_launches, vlm = vlm_phase(cuda)
    for name in KERNELS:
        launches[name] += encdec_launches[name] + vlm_launches[name]
    assert launches["rmsnorm"] == 0, f"a served path launched rmsnorm: {launches}"
    print("[21] serve full-width stablelm-1.6b through four worker processes, a SIGKILL "
          "failover and a respawn", flush=True)
    mp_launches, mp_report = multiprocess_phase(cuda)
    for name in KERNELS:
        launches[name] += mp_launches[name]
    assert launches["rmsnorm"] == 0, f"a served path launched rmsnorm: {launches}"
    train_launches, bwd_entry = training_phases(cuda, report)
    launches["flash_attention"] += train_launches["flash_attention"]
    family_launches, family_routes, scan_bwd_entry = family_phases(cuda)
    launches["flash_attention"] += family_launches["flash_attention"]
    launches["selective_scan"] += family_launches["selective_scan"]
    mesh_cases, mesh_runs, mesh_report = mesh_phases(cuda)
    mesh_routes = {"flash_attention": collections.Counter(),
                   "paged_prefill_attention": collections.Counter()}
    for name, run in mesh_runs.items():
        for kernel in KERNELS:
            launches[kernel] += run[kernel]
    for model_report in (v for v in mesh_report.values() if isinstance(v, dict)):
        for rep in (v for v in model_report.values() if isinstance(v, dict) and "launches" in v
                    and "launches_by_route" in v):
            for kernel, counts in rep["launches_by_route"].items():
                mesh_routes[kernel].update(counts)
    for route in routes:
        routes[route] += mesh_routes["paged_prefill_attention"][route]
    assert launches["rmsnorm"] == 0, f"a served path launched rmsnorm: {launches}"
    bwd_entry["launches"] += family_launches["flash_attention_bwd"]
    bwd_routes = family_routes["flash_attention_bwd"].copy()
    bwd_routes["full"] += train_launches["flash_attention_bwd"]  # phases 23-24: full only
    bwd_entry["launches_by_route"] = dict(bwd_routes)
    for name, r in scan_bwd_entry["training"].items():
        for run, rep in r.items():
            bwd_entry["launches_by_run"][f"{name} {run}"] = rep["launches"]["flash_attention_bwd"]
    encdec_routes = {name: collections.Counter() for name in ("flash_attention",
                                                               "decode_attention")}
    for report in encdec.values():
        for name, counts in report["launches_by_route"].items():
            encdec_routes[name].update(counts)

    kernels = []
    for name, source, replaces, main_shape in (
        ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/flash_attention.py:113", "B=4 S=128"),
        ("decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
         "src/repro/kernels/decode_attention/decode_attention.py:66", "B=4 S=128"),
        ("paged_decode_attention", "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
         "src/repro/kernels/decode_attention/paged.py:88", "B=8 page=16"),
        ("paged_prefill_attention", "src/repro_torch/kernels/csrc/paged_prefill_attention.cu",
         "src/repro/kernels/decode_attention/paged_prefill.py:95", "B=8 C=32"),
        ("selective_scan", "src/repro_torch/kernels/csrc/selective_scan.cu",
         "src/repro/kernels/selective_scan/selective_scan.py:69", "B=4 S=128"),
        ("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
         "src/repro/kernels/rmsnorm/rmsnorm.py:25", "R=512 D=4096"),
    ):
        cases = results[name]
        main_dtype = "float32" if name == "selective_scan" else "bfloat16"  # the scan takes fp32
        main_case = next(c for c in cases if c["dtype"] == main_dtype
                         and c["shape"].startswith(main_shape))
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            **{k: main_case[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            "main_case": f"{main_case['shape']} {main_case['dtype']}",
            "cases": cases,
        }
        if name == "flash_attention":
            entry["tensor_core_sass"] = tensor_core["flash_fwd_tc_kernel"]
            entry["tf32_sass"] = tf32["flash_fwd_kernel"]
            entry["fp32_forward"] = bwd_entry["fp32_forward"]
            windowed = (hybrid["served"]["flash_launches_by_route"]["windowed"]
                        + family_routes[name]["windowed"] + mesh_routes[name]["windowed"])
            bidir, cross = (encdec_routes[name][r] + family_routes[name][r]
                            for r in ("bidirectional", "cross"))
            entry["launches_by_route"] = {"full": launches[name] - windowed - bidir - cross,
                                          "windowed": windowed, "bidirectional": bidir,
                                          "cross": cross}
        if name == "decode_attention":
            cross = encdec_routes[name]["cross"]
            entry["launches_by_route"] = {"self": launches[name] - cross, "cross": cross}
        if name in ("flash_attention", "decode_attention"):
            entry["launches_by_run"] = {"encdec": encdec_launches[name],
                                        "internvl2": vlm_launches[name],
                                        "multiprocess": mp_launches[name]}
        if name == "flash_attention":
            entry["launches_by_run"]["training"] = train_launches[name]
            entry["launches_by_run"]["training_families"] = family_launches[name]
            entry["head_dim_8_trained"] = scan_bwd_entry["flash_bwd_head_dim_8"]["forward"]
            # paper-block is the one model at head_dim 8 (phases 18 and 31);
            # none on the main path has head_dim 16.
            head8 = encdec["paper-block"]["flash_launches"] + sum(
                run["launches"][name]
                for run in scan_bwd_entry["training"]["paper-block"].values())
            entry["head_dim_8_16"] = {
                "kernel": "flash_fwd_kernel<D, T, W> at D = 8 / 16, fp32 and bf16 (fp32 compute, "
                          "P V as 3xTF32; one-warp blocks where a KV head has at most 16 rows), "
                          "in place of flash_small_kernel",
                "launches": head8,
                "launches_by_run": {"encdec paper-block": encdec["paper-block"]["flash_launches"],
                                    **{f"paper-block {run}": rep["launches"][name] for run, rep
                                       in scan_bwd_entry["training"]["paper-block"].items()}}}
            entry["launches_by_head_dim"] = {"8": head8, "64 / 128": launches[name] - head8}
        if name == "selective_scan":
            entry["launches_by_run"] = {"training_families": family_launches[name]}
        if name == "flash_attention":
            entry["served_encdec"] = encdec
            entry["encdec_parity"] = encdec_checks
            entry["served_internvl2"] = vlm
        if name in ("flash_attention", "decode_attention", "selective_scan"):
            entry["launches_by_run"] = {**entry.get("launches_by_run", {}),
                                        "hybrid": hybrid_launches[name]}
        if name == "paged_prefill_attention":
            entry["tensor_core_sass"] = tensor_core["paged_prefill_tc_kernel"]
        if name in PAGED_KERNELS:
            entry["launches_by_run"] = {run: counts[name] for run, counts in by_run.items()}
            entry["launches_by_run"].update(dense_chunked=chunked_launches[name],
                                            spec=spec_launches[name])
        if name == "paged_prefill_attention":
            entry["launches_by_route"] = routes
            entry["spec_parity"] = spec_checks
            entry["served_dense_chunked"] = chunked
            entry["served_spec"] = spec_served
        if name == "decode_attention":
            entry["served"] = decode_served
            entry["served_multiprocess"] = mp_report
        if name == "paged_decode_attention":
            entry["served"] = paged_served
            entry["library_note"] = ("no single PyTorch call reads a block table; "
                                     "gather_sdpa_ms = gather_pages (K, V) + SDPA")
        if name == "selective_scan":
            entry["library_note"] = "no PyTorch call computes the recurrence"
            entry["model_parity"] = ssm_checks
            entry.update(scan_served)
            entry["served_hybrid"] = hybrid["served"]["scan"]
        if name == "decode_attention":
            entry["served_hybrid"] = hybrid["served"]["decode"]
        if name == "flash_attention":
            entry["hybrid_parity"] = hybrid["parity"]
        entry.setdefault("launches_by_run", {}).update(
            {run: counts.get(name, 0) for run, (counts, _) in moe_runs.items()})
        if name == "paged_prefill_attention":
            entry["served_moe"] = {
                "granite_moe_1b_a400m": granite_report, "qwen3_moe_30b_a3b": qwen_report,
                **{run: {k: v for k, v in out.items() if k != "launches"}
                   for run, (_, out) in moe_runs.items()}}
            entry["moe_parity"] = moe_checks
        entry["launches_by_run"].update({run: counts[name] for run, counts in mesh_runs.items()})
        if name in mesh_cases:
            entry["mesh_cases"] = mesh_cases[name]
        if name == "flash_attention":
            entry["served_mesh"] = mesh_report
        if name == "rmsnorm":
            entry["library_note"] = "torch.nn.functional.rms_norm"
            entry["launches_note"] = ("no served path launches it: the models call their plain "
                                      "rmsnorm (models/layers.py), as the JAX models do")
        kernels.append(entry)
    kernels.append(bwd_entry)
    kernels.append(scan_bwd_entry)
    print(f"[41] all phases passed in {time.perf_counter() - t_start:.1f} s, build included "
          f"(before phases 33-40 were added: 600.7 s on this card model, PERF.md)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if hasattr(tree, "shards"):  # a stage's weights placed on a slice
        return _leaves(tree.shards)
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):  # a mesh slice's caches, one tree per position
        return [x for v in tree for x in _leaves(v)]
    return [tree]


if __name__ == "__main__":
    sys.exit(main())

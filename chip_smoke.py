#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N] [--json-out PATH]

Phases, each of which exits nonzero on a failed check:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the serving and training paths from
   ``kernels/csrc``; in the SASS (``cuobjdump -sass``) of each LoRA
   library and of the ``flash_attention`` library, every bf16 tile (the
   three attention instances, head dims 64, 128 and 256) must run
   ``HGMMA`` (wgmma) on ``UTMALDG`` (TMA) loads, in the ``flash_decode`` and
   ``flash_decode_paged`` libraries every bf16 split-KV tile (head dims
   64, 128, 256 dense; 64, 128 paged) ``HMMA`` (mma.sync) on ``UTMALDG``
   loads, and every f32 tile none of them; the two bf16 tensor-core rank
   passes of ``lora_matmul_bwd`` must run ``HMMA``, and the six bf16
   ``selective_scan`` instances and the four bf16 ``rglru_scan`` ones
   (with and without the checkpoint stores) ``MUFU.EX2`` (one
   instruction an exponential); each bf16 instance of the two backward
   kernels holds the ``MUFU.EX2`` count of its design
   (``mufu_design``); ptxas's registers and
   spills of every kernel (each ``rglru_scan`` plan among them) are
   printed;
3. kernels: at the main path's shapes, each kernel against its plain
   PyTorch version on the same inputs, with its time (CUDA events, median,
   L2 flushed between launches), the plain version's time, one PyTorch
   library call's time as a yardstick and the card's least time (bound;
   for decode, the visible cache keys' bytes and each prefix bank slot
   read once);
   the two multi-LoRA kernels also row by row against ``lora_matmul`` run
   with that row's adapter, which must give the same bits; each LoRA and
   attention case names its ``path``, ``wgmma`` (bf16) or ``cuda-core``
   (f32); flash_attention at head dim 128 (qwen2-7b's prefill) and, in
   bf16, at head dim 64: vit-edge's classify (B 8, S 197, 16 prefix
   slots, 12 / 12 heads) and 512 tokens, which refill the instance's
   4-stage ring; flash_decode as the models call it (B 8, 1024 slots,
   a 16-slot prefix bank, 28/4 heads, D 128), with its ``path``
   (``split-mma`` in bf16, ``cuda-core`` in f32), its splits, and the
   host microseconds of a call; in bf16 also with a 4-domain bank's
   stacked prefix slots read by the rows' ids, the bank drains' layout;
4. main path: qwen2-7b at its full published size (28 layers, d_model
   3584, bf16, random weights from the seed) serves 16 ragged requests
   through ``DecodeEngine(slots=8)``, with in-wave refill; lora_matmul,
   flash_attention and flash_decode must launch during the drain, and the
   full-size prefill logits through the kernels must agree with the plain
   path's;
5. bank path, on the same backbone: an ``AdapterBank`` of 4 domains
   (seeded prefix slots, seeded nonzero LoRA b) serves 16 ragged requests
   of mixed domains through ``DecodeEngine(slots=8, bank=...)``; the
   multi-LoRA kernels, flash_attention and flash_decode must launch and
   lora_matmul must not; the drain must encode fewer TMA maps than it
   makes decode calls (the bank's slots are read by id, so its maps are
   encoded once); a mixed 4-domain prefill must agree with each
   domain's own prefill (cosine > 0.999, same top-1), and the domains must
   not all give the same tokens;
6. end to end: a 2-layer, full-width f32 qwen2-7b drains the same kind of
   queue through the kernels and through ``backend="torch"``; the greedy
   tokens must be identical, and equal to solo generation; a mixed-domain
   bank drain must give identical tokens through the kernels, through
   ``backend="torch"`` and through per-domain single-tenant drains;
7. classify: vit-edge at its configured size (12 layers, d_model 768)
   scores a mixed-domain batch through the bank's per-row heads, within
   bf16 tolerance of each domain's own ``classify``;
8. training kernels (timed beside phase 3): ``lora_matmul_bwd`` against
   its plain version at the HFSL round's shapes (M 1024, K 3584, N 3584
   and 512, r 8, bf16 and f32), its bits repeated by a second call, with
   its ``path`` (the rank pass's route, the sweep's tiles and M splits),
   beside the library call and the bound; ``lora_matmul`` at the backward's ``dx``
   shape (dy against Wᵀ) and the Wᵀ copy; the autograd ``lora_matmul``
   (dx, dA, dB, dbias, and dW only when w requires grad) and the
   flash-attention backward on the card against autograd through their
   plain versions;
9. training round: qwen2-7b at its published size with a 5-class head, one
   HFSL round of 4 steps over 2 clusters (batch 4, seq 256, FedAvg every
   2 steps, AdamW 5e-3) from a ClassificationTask bank; losses finite,
   adapters moved, replicas equal right after the syncs and apart after
   step 1, the predicted launch counts and no plain version run;
10. the paper's round: vit-edge at its configured size with
   ``IntegratedRuntime``'s upgrade settings (2 clusters, 20 steps, batch
   16, FedAvg every 5 steps, AdamW 5e-3), with the same checks;
11. training exactness: a 2-layer, full-width f32 qwen2-7b round (2
   clusters, 3 steps, SGD with momentum) through the kernels and through
   ``backend="torch"``: adapters and losses within 1e-4, each leaf's
   update within 1e-3 of its largest; the same round with AdamW is
   recorded;
12. the paged decode kernel against its plain version at the paged
   drain's shape (B 8, Hq 28 / Hkv 4, D 128, block 16, 64 blocks per row,
   16 per-row prefix slots, ragged q_pos, bf16 and f32), timed beside
   phase 3; the same inputs through the dense ``flash_decode`` kernel on
   ``cat(prefix, pool[table])`` and on ``pool[table]`` with the prefix
   bank read in place must give the same bits; in bf16, a 4-domain bank's
   stacked slots read by the rows' ids must give the bits of the same
   slots gathered per row; path, splits and host microseconds a call as
   in phase 3, also by id;
13. paged serving at full size, on phase 5's backbone and bank:
   ``DecodeEngine(slots=8, bank=..., paged=PagedSpec(512, 16,
   share_prefix=True))`` drains 16 requests, 4 per domain sharing a
   256-token system prompt; the paged kernel, the multi-LoRA kernels and
   flash_attention must launch, the dense flash_decode and lora_matmul
   must not; fewer TMA maps encoded than decode calls; prefixes must be
   shared, the pool must be empty and
   consistent after the drain, and a second drain of the same prompts
   must revive blocks off the free list;
14. paged exactness: the 2-layer f32 qwen2-7b of phase 6 drains a ragged
   queue with shared prefixes, single-tenant and from the bank, paged with
   and without prefix sharing, through the kernels and through
   ``backend="torch"``: the tokens must equal each other, the dense drain
   and solo generation; a ``serve_trace`` of the queue at staggered
   arrivals too;
15. the paper's loop: ``IntegratedRuntime`` on vit-edge at its configured
   size (2 domains, MLCP over a 10-round demand, paged produce rounds)
   runs upgrade and produce rounds through the kernels with no plain
   version; each upgrade publishes, upgraded accuracy holds, and
   ``save`` / ``restore`` resume the loop;
16. the selective scan kernel against its plain version at falcon-mamba-7b's
   prefill shape (B 8, S 512, Di 8192, N 16; bf16 and f32, with and
   without a per-row initial state, B and C as strided views of the
   x_proj output), a one-row refill (B 1, S 512, timed), an odd shape
   (S 37, Di 200), and a ragged case: a
   right-padded row with dt = 0 must end in the state of the same row run
   alone at its own length, bit for bit, through the kernel; times beside
   the plain version and the bound (the exponentials through the
   special-function units, or the bytes); no library call computes a scan;
17. falcon-mamba-7b at its published size (64 layers, d 4096, d_inner
   8192, d_state 16, vocab 65024, untied head, bf16, random weights from
   the seed) drains phase 4's queue shape through ``DecodeEngine(slots=8)``
   single-tenant and from a 4-domain ``AdapterBank`` whose domains differ
   in their state prompts: ``selective_scan`` must launch 64 times per
   prefill or refill and no attention or LoRA kernel at all; a mixed
   prefill must agree with per-domain prefills (same top-1) and the
   domains must give different tokens;
18. ssm exactness, a 2-layer full-width f32 falcon-mamba-7b: the kernel
   drain gives the plain drain's tokens and each solo row's, and a mixed
   bank drain gives the per-domain drains' tokens;
19. speculative serving of phase 4's qwen2-7b and queue with the default
   recurrent drafter (d_model 64, 2 layers) and k = 4, inside phase 4:
   tokens against phase 4's drain (recorded: bf16 verify and decode round
   differently), drafted, acceptance, tok/s; ``selective_scan`` launches
   for the drafter, ``flash_decode`` never;
20. speculative exactness: 2-layer f32 qwen2-7b (inside phase 6) and
   falcon-mamba-7b (inside phase 18) spec drains, with rows opted out,
   give the plain drains' tokens; falcon-mamba-7b as its own drafter
   accepts every draft; the vit-edge ``IntegratedRuntime(spec_k=4)`` runs
   phase 15's 10 rounds and books drafted and accepted tokens;
21. the RG-LRU kernel against its plain version at recurrentgemma-2b's
   prefill shape (B 8, S 512, W 2560; bf16 and f32, with and without a
   per-row initial state, and one (W,) state shared by the rows), an odd
   shape (S 37, W 200), and a ragged case: a right-padded row with r_gate
   = -1e9 must end in the state of the same row run alone, bit for bit,
   through the kernel (rows of 1 to 512 tokens); times, at B 8 and at a
   one-row refill (B 1), beside the plain version and the bound, whose
   terms are named apart: the bytes, the special-function operations, the
   f32 operations, and the serial chain (S dependent multiply-adds, not
   part of ``bound_ms``); each case names its ``plan``; no library call
   computes the recurrence;
22. the head-dim-256 instances of flash_attention (B 8, S 512, 16 prefix
   slots, 10 query heads over 1 KV head, window 2048) and flash_decode (8
   rows against a 2048-slot rolling buffer behind 16 prefix slots, group
   10) against their plain versions, timed beside phase 3's head dim 128
   rows, which re-time the dense shapes; each attention case names its
   ``path``, each decode case its path, splits and host microseconds a
   call;
23. recurrentgemma-2b at its published size (26 layers: 8 groups of
   (rglru, rglru, attn) and an (rglru, rglru) tail, d 2560, lru_width
   2560, 10 / 1 heads of 256, d_ff 7680, vocab 256000 tied, window 2048,
   bf16, random weights from the seed) drains phase 4's queue shape
   through ``DecodeEngine(slots=8)`` single-tenant and from a 4-domain
   ``AdapterBank`` whose domains differ in prefix, LoRA and state prompts:
   ``rglru_scan`` must launch 18 times and flash_attention 8 times per
   prefill or refill, no plain version may run; a mixed prefill must agree
   with per-domain prefills and the domains must give different tokens;
   f32 full-depth prefill logits kernels vs plain;
24. hybrid exactness, recurrentgemma-2b at full width in f32 with 5 layers
   (one group and the tail): prefill logits kernels vs plain within 1e-3
   and the same greedy tokens (kernels == plain == solo rows), again with
   the window cut to 8 so that the rolling buffer wraps, and a speculative
   drain (default drafter, k 4) inside the window giving the plain
   tokens;
25. the two backward kernels (``selective_scan_bwd``, ``rglru_scan_bwd``)
   against their plain versions at the HFSL rounds' shapes (falcon-mamba
   B 4, S 256, Di 8192, N 16; recurrentgemma B 4, S 256, W 2560; bf16 and
   f32; h0 per row, shared, none) and an odd shape (S 37, Di / W 200):
   every gradient within 1e-5 (f32) or 2e-2 (bf16) of its largest value,
   fed the forward kernel's checkpoints (the forward's y / h_final bits
   the same with and without storing them, and its time both ways), the
   bits repeated by a second call, the kernel's recompute of the last
   chunk ending in the forward kernel's h_final bit for bit; a ragged row's
   gradients bit for bit the solo row's; the RG-LRU's saturated gate
   (r = -1e9): dr_gate and da_param non-finite exactly where the plain
   backward's are, everything else within tolerance; the autograd
   Functions on the card against autograd through the plain versions,
   running no plain version; times (events, L2 flushed, and
   ``torch.profiler`` device microseconds) beside the plain version and
   the bound, whose terms are named apart; no library call computes
   either VJP. Beside them, ``lora_matmul_bwd`` at recurrentgemma-2b's q
   and v shapes (K 2560, N 2560 and 256) against its plain version;
26. one HFSL round of falcon-mamba-7b at its published size (64 layers,
   d 4096, d_inner 8192, bf16, random weights from the seed) as phase 9
   runs qwen2-7b (a 5-class head, 2 clusters, 4 steps, batch 4, seq 256,
   FedAvg every 2 steps, AdamW): the replicas equal right after each
   sync and apart after step 1, finite losses, the adapters moved; the
   predicted launches exactly (selective_scan and its backward 64 x 8,
   no attention, LoRA or RG-LRU kernel) and no plain version; step time,
   examples/s and peak memory;
27. the same round of recurrentgemma-2b at its published size: rglru_scan
   and its backward 18 x 8, flash_attention 8 x 8, lora_matmul_bwd 2 x 8
   x 8, no plain version;
28. training exactness: a 2-layer full-width f32 falcon-mamba-7b and a
   5-layer full-width f32 recurrentgemma-2b, 2 clusters, 3 steps of SGD
   with momentum, through the kernels and through ``backend="torch"``:
   adapters and losses within 1e-4, each leaf's update within 1e-3 of
   its largest update;
29. the data-free knowledge relay (``core/relay.py``) on one qwen2-7b
   backbone at its published size (bf16, a 5-class head): 4 domains
   (``domain_adapters``) in an ``AdapterBank`` attached to the relay,
   delivery to each, ``edge_deliver`` to 4 clusters; one HFSL round of 4
   clusters at phase 9's shapes from the delivered adapters (launches as
   ``round_launches`` predicts); ``edge_absorb`` of the 4 cluster trees
   (the bank's slot bit for bit the relay's edge, its version up by 1); a
   12-request 4-domain drain from the bank must give a fresh
   ``AdapterBank.create(relay.edges)``'s tokens, and some d0 request
   other tokens than before the absorb; ``cloud_aggregate``, every ledger
   field its analytic count times ``tree_bytes``; the same flow under
   ``FaultPlan(seed, link_loss=0.2, payload_corrupt=0.3)`` bit for bit the
   clean relay, retransmits booked, some smaller than a whole tree; d0's
   int8 checkpoint beside its bf16 one, classify of 64 examples through a
   bank slot loaded from it agreeing with the bf16 slot on at least 0.75;
   the host ms of each relay call, and of cloning one edge tree (every
   method hands back a clone; an in-place step on the aggregate it
   returns leaves the relay's cloud as it was);
30. split-learning inference (``core/sl_pipeline.py``), the chain of 4
   stages and 4 microbatches against monolithic ``classify``: vit-edge
   f32 at its configured size (B 16, S 197; max_abs_err 1e-4), qwen2-7b
   bf16 at its published size with phase 29's d0 adapters (B 16, S 256;
   cosine > 0.999, top-1 on every row decided beyond bf16 rounding),
   falcon-mamba-7b f32 at full width with 8 layers (``selective_scan``;
   1e-4); launches exactly microbatches x layers x per-layer launches,
   no plain version; CUDA-event ms of the chain and the monolithic call;
31. split-learning fine-tuning: vit-edge f32 gradients of the 4-stage
   chain against monolithic autograd (within 1e-5 of max(1, the leaf's
   largest)) and one sgd step (1e-5); qwen2-7b bf16 gradients against
   monolithic (atol 1e-1 / rtol 5e-2) and 3 adamw steps with finite
   losses and the predicted launches (``lora_matmul_bwd`` 3 x 4 x 28 x
   2), step time beside phase 9's;
32. the serving CLI in process on qwen2-7b at its published size:
   ``--impl loop`` prints ``--impl scan``'s rows, ``--adapters`` loads
   phase 29's checkpoint, ``--trace-out`` / ``--metrics-out`` write JSON;
   ``generate_loop`` gives ``generate``'s tokens on every row;
33. granite-moe-1b-a400m at its published size (24 layers, d 1024, 16/8
   heads of 64, 32 experts top-8, d_ff_expert 512, bf16, random weights
   from the seed): one decode step of 8 slots launches exactly one
   ``flash_decode`` a layer and one ``lora_matmul`` a LoRA target a layer
   (``moe_step_launches``: the moe FFN is torch), timed; phase 4's queue
   shape drained single-tenant, from a 4-domain bank and paged with
   prefix sharing from the bank, each drain's launches as predicted
   (``moe_drain_launches_ok``), no plain version;
34. moe exactness: two bf16 prefills of the full model on one batch give
   the same bits (the dispatch and combine take no atomics); the kernel
   path's logits against the plain path's (cosine, top-1) and the share
   of routing decisions the two share, recorded; a 2-layer full-width f32
   granite with ``capacity_factor=-1`` drains 8 requests sharing a
   64-token prefix through the kernels, the plain versions and the paged
   engine, all equal to each request's solo ``generate``;
35. one HFSL round of granite at its published size as phase 9 runs
   qwen2-7b (launches as ``round_launches`` predicts), and a 2-layer f32
   round kernels vs plain within 1e-4 (``f32_round_exactness``, phase
   11's);
36. kernels 1-3 at granite's shapes (LoRA K 1024 to N 1024 and 512,
   attention and decode at head dim 64 with 16/8 heads) against their
   plain versions, timed with the library call and the bound (run with
   phase 3's cases);
37. llava-next-mistral-7b at its published size (32 layers, d 4096, 32/8
   heads of 128, d_ff 14336, vocab 32000, window 4096, bf16, random
   weights from the seed) drains phase 4's queue shape, each request with
   its own (576, 4096) vision row, single-tenant and from a 4-domain
   bank; every kernel's launches equal the prediction per admission and
   per decode step (``family_launches``), no plain version runs; two
   requests' full-depth prefill logits kernels vs plain (cosine > 0.99);
38. whisper-small at its published size (12 + 12 layers, d 768, 12/12
   heads of 64, 1500 frames, vocab 51865, bf16) drains 16 requests, each
   with its own (1500, 768) frames row: an admission runs 12 + 12 + 12
   ``flash_attention`` (encoder and cross non-causal, decoder causal), a
   decode step 12 causal and 12 non-causal ``flash_decode``; launches as
   predicted, the cross cache's size, full-depth logits as phase 37;
39. exactness in f32: a 2-layer full-width llava drain (one request's
   576 + 3,520 prompt and 64 generated tokens run past the 4096-slot
   window) and a 2 + 2-layer whisper drain give, through the kernels, the
   plain versions' tokens and each request's solo ``generate`` with its
   own row; both families refuse mismatched extras keys, paged serving
   and speculative decoding, as the reference does;
40. kernels at these families' shapes (run with phase 3's cases):
   ``flash_attention`` non-causal at whisper's encoder (1500 frames + 16
   prefix slots) and cross attention (64 rows, 1500 keys), llava's
   windowed prefill (576 + 512 tokens, D 128); ``flash_decode``
   non-causal against whisper's cross cache (T 1500) and at llava's
   4096-slot rolling buffer; ``lora_matmul`` and both ``lora_bgmv``
   kernels at K 4096 and K 768.

41. the dry-run (``launch/dryrun.py``) over every ASSIGNED x INPUT_SHAPES
   pair on ``meta``, one data row of the reference's 16 x 16 mesh on one
   card: each pair ok or skipped with a reason, its fit on one H100, bytes,
   flops, bottleneck and MFU bound (run in the background beside 42-44);
42. ``launch/profile.py`` on the card: qwen2-7b's decode_32k (B 8, a
   32,768-slot cache) and prefill_32k (B 2 x 32,768) steps, its train_4k
   step where phase 41's count says it fits, and one decode step of
   llava-next-mistral-7b and whisper-small at phases 37-38's drain shapes:
   device time by kernel and group, launches, busy share, MFU, and the
   measured peak memory within 20 % of the dry-run's estimate; beside
   them flash_attention at (B 2, S 32,768, 28/4 heads, D 128, causal) and
   flash_decode at (B 8, T 32,768 + 16) against their plain versions,
   timed with the bound and the library call;
43. ``python -m repro_torch.analysis`` (the port's tracelint) exits 0, and
   a second drain of phase 4's queue on phase 4's backbone runs under
   ``compile_guard(max_compiles=0)`` (inside phase 4);
44. the five examples (``examples/torch_*.py``) on the card, each in a
   subprocess with its own timeout, all at once; each must exit 0, and
   each one's last line is recorded;
45. the dense main path on a 1x1 NCCL device mesh (``launch/mesh.py::
   single_process_mesh``; inside phase 4, on its backbone): phase 5's
   queue and bank adapters drained by ``DecodeEngine(mesh=)`` from a
   slot-sharded bank and a backbone placed by ``place_params``, against
   the same drain without a mesh: the same tokens (else each request's first token and the
   full-size mixed prefill logits' cosine and top-1), the same launches
   of every kernel, no plain version; tok/s of both;
46. ``make_hfsl_round(mesh=)`` on phase 9's qwen2-7b round (state and
   batch bank placed per ``hfsl_round_rules``) against the round
   without a mesh: the same launches, losses and adapters within bf16's
   tolerance; then ``IntegratedRuntime(mesh=)`` on vit-edge: one produce
   of two domains, one upgrade (its adapters stay on the mesh), one
   produce;
47. the mesh path's kernels at the shapes one rank of a 2x2 mesh hands
   them for qwen2-7b (run with phase 3's cases): ``lora_matmul`` and
   both ``lora_bgmv`` kernels at q's 1792 and v's 256 output columns and
   4 wave rows (4 x 512 at prefill), ``flash_attention`` at B 4 with
   14 / 2 heads, ``flash_decode`` at B 4 with 14 / 2 heads, shared and
   bank prefix;
48. the dry-run with ``--multi-pod`` for qwen2-7b on ``meta``: one data
   row of the 2 x 16 x 16 mesh, each batch its global batch / 32;
49. qwen2-7b's paged bank drain with prefix sharing on the 1x1 NCCL mesh
   (the pool's blocks on `data`, its kv heads on `model`, the allocator
   on the host) against the same drain without a mesh;
50. qwen2-7b's speculative drain (the recurrent drafter, k = 4, placed
   under ``drafter_rules``) on the mesh against the one without;
51. granite-moe-1b-a400m on the mesh: a drain and a 2-cluster x 2-step
   HFSL round, each against its mesh-less twin;
52. falcon-mamba-7b and recurrentgemma-2b on the mesh: a drain and a
   round each; llava-next-mistral-7b and whisper-small: a 4-request
   drain each. In 49-52 each drain gives the mesh-less tokens, engine
   stats and launches, each round the mesh-less losses and adapters bit
   for bit with its launches, and no plain version runs;
53. the paged decode and the two scans at the shapes one rank of a 2x2
   mesh hands them, through their mesh wrappers (``ops.*`` on DTensors of
   the 1x1 mesh) against the plain versions, and timed as kernels:
   ``flash_decode_paged`` at B 4 with 14 / 2 heads over the pool gathered
   whole; ``selective_scan`` at Di 4096 (channels on `model`) and at B 2
   x S 256 x Di 8192 (rows on `model`, a round's) with its backward;
   ``rglru_scan`` at W 1280 and at B 2 x S 256 x W 2560 with its
   backward;
54. long decode: qwen2-7b at its published size with ``long_500k``'s
   sliding-window variant (window 4096) decodes a batch of 1 under
   ``long_decode_rules`` on the 1x1 NCCL mesh (the cache's slot dim on
   `data`, each layer's ``flash_decode`` in its partial mode and the
   ranks' partials merged): a 4,064-token prompt and 64 greedy steps that
   wrap the ring, the mesh-less tokens and logits bit for bit, equal
   launches; and ``flash_decode`` with its ``lse`` output at one of two
   `data` shards of a decode_32k-shaped cache (B 1, 16,384 of 32,768 keys
   + 16 prefix, 28 / 4 heads, D 128): each half against its plain
   version (output and lse), the two halves merged by
   ``flash_decode.combine`` against one whole call, each half and the
   merge timed (row 3h of the kernel table, in ``flash_decode``'s
   ``cases``);
55. moe serving: granite-moe-1b-a400m at its published size (32 experts,
   top 8) prefills 8 x 512 tokens under ``moe_serving_rules`` on the 1x1
   mesh (experts on `data`, their d_model on `model`): the mesh-less
   logits bit for bit and equal launches;
56. the SL chain's `stage` axis: vit-edge's 12-layer f32 chain with
   ``mesh=`` a 1-stage NCCL `stage` mesh, its logits and one
   ``make_sl_finetune_step(mesh=)`` sgd step bit for bit those of the
   mesh-less chain of phases 30-31, each timed beside it.

Each kernel's ``launches`` adds phases 29-39's, 45-46's, 49-52's and
54-56's runs to its own path's (``launches_by_path``: ``relay``, ``sl``,
``sl_train``, ``cli``, ``moe``, ``vlm``, ``audio``, ``mesh``,
``mesh_train``, ``mesh_paged``, ``mesh_spec``, ``mesh_moe``,
``mesh_ssm``, ``mesh_hybrid``, ``mesh_vlm``, ``mesh_audio``,
``mesh_long_decode``, ``mesh_moe_serve``, ``mesh_sl``).
Every full-size drain and round (phases 4,
5, 9, 10, 13, 15, 17, 23, 26, 27, 33, 35, 37, 38, 45, 46, 49-52, 54-56)
and phases 29-32
must leave ``lora_matmul.pad_copies``, ``flash_attention.pad_copies``
and ``flash_decode.pad_copies`` at 0: no LoRA, attention or decode
operand of a model is padded for TMA.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside the
repository, the script exits nonzero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the card's peaks (the H100 SXM data sheet) and the kernels' counts have
# one home, the port's roofline
from repro_torch.launch.roofline import (HBM_BW, SM_CLOCK,  # noqa: E402
                                         KernelCost, kernel_costs)

TOL = {torch.bfloat16: 2e-2,
       # f32: sums of up to 3584 terms taken in another order than cuBLAS
       torch.float32: 1e-4}
REPLACES = {
    "lora_matmul": "src/repro/kernels/lora_matmul.py:75",
    "lora_matmul_bwd": "src/repro/kernels/lora_matmul.py:144",
    "flash_attention": "src/repro/kernels/flash_attention.py:87",
    "flash_decode": "src/repro/kernels/flash_decode.py:207",
    "flash_decode_paged": "src/repro/kernels/flash_decode.py:149",
    "lora_bgmv_rows": "src/repro/kernels/lora_bgmv.py:91",
    "lora_bgmv_seq": "src/repro/kernels/lora_bgmv.py:168",
    "selective_scan": "src/repro/kernels/selective_scan.py:56",
    "rglru_scan": "src/repro/kernels/rglru_scan.py:51",
    # no TPU kernel: the reference differentiates both scans through XLA
    "selective_scan_bwd": "src/repro/kernels/ops.py:391",
    "rglru_scan_bwd": "src/repro/kernels/ops.py:470",
}
N_DOMAINS = 4
# the path whose launches a kernel's record reports
PATH_OF = {"lora_bgmv_rows": "bank", "lora_bgmv_seq": "bank",
           "lora_matmul_bwd": "train", "flash_decode_paged": "paged",
           "selective_scan": "mamba", "rglru_scan": "hybrid",
           "selective_scan_bwd": "train-ssm",
           "rglru_scan_bwd": "train-hybrid"}
# kernels of the attention, LoRA and RG-LRU paths, none of which an ssm
# model runs
NOT_SSM = ("lora_matmul", "flash_attention", "flash_decode",
           "flash_decode_paged", "lora_bgmv_rows", "lora_bgmv_seq",
           "rglru_scan")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

class Timer:
    """Median CUDA-event time of one call, L2 flushed before each launch
    (the main path reads weights and caches far larger than the 50 MB L2)."""

    def __init__(self, reps: int = 15):
        self.reps = reps
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn) -> float:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(self.reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return float(np.median(ts))


def host_us(fn, calls: int = 1000, batch: int = 50) -> float:
    """Host microseconds a call of ``fn`` takes to return: ``calls`` calls
    timed with ``time.perf_counter`` in batches of ``batch``, synchronised
    outside the timing between batches, so that the launch queue never
    fills and blocks the host; the median batch's time a call (the host's
    cores are shared, and a batch that another process interrupts is an
    outlier)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(calls // batch):
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        per_call.append((time.perf_counter() - t0) / batch)
        torch.cuda.synchronize()
    return float(np.median(per_call)) * 1e6


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """Least time (ms) the card could take for work that is no kernel
    call (a copy): bytes over the memory rate or operations over the peak
    rate of the dtype, whichever is larger."""
    return KernelCost(nbytes, flops, flops_dtype=dtype).bound()


def tile_path(dtype) -> str:
    """The tile a LoRA or attention kernel runs in this dtype."""
    return "wgmma" if dtype == torch.bfloat16 else "cuda-core"


def decode_plan(dtype, D: int, n_keys: int, B: int, Hkv: int) -> dict:
    """The tile a decode kernel runs in this dtype and, in bf16, its
    split-KV grid (``flash_decode.split_plan``)."""
    from repro_torch.kernels import flash_decode as fd
    if dtype != torch.bfloat16:
        return dict(path="cuda-core", splits=None)
    tps, n = fd.split_plan(D, n_keys)
    return dict(path="split-mma", splits=dict(
        tiles_per_split=tps, splits=n, blocks=n * Hkv * B))


def no_pad_copies(what: str) -> None:
    """Every model width and head dim is a multiple of 8, so no LoRA,
    attention or decode operand on a main path is padded for TMA."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import lora_matmul as lm
    check(lm.pad_copies == 0, f"{what}: {lm.pad_copies} LoRA operands "
          "were padded for TMA")
    check(fa.pad_copies == 0, f"{what}: {fa.pad_copies} attention calls "
          "padded their operands for TMA")
    check(fd.pad_copies == 0, f"{what}: {fd.pad_copies} decode calls "
          "padded their operands for TMA")


# per library: the name of its bf16 tensor-core kernels, of its f32
# CUDA-core kernels, how many of each it must hold, and the instructions
# each bf16 kernel must hold (HGMMA: wgmma; HMMA: mma.sync; UTMALDG: TMA
# loads); an f32 kernel must hold none of them
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG")
SASS_TILES = {
    "lora_matmul": ("lora_wgmma_kernel", "_f32_kernel", 1, 1,
                    {"HGMMA", "UTMALDG"}),
    "lora_bgmv_rows": ("lora_wgmma_kernel", "_f32_kernel", 1, 1,
                       {"HGMMA", "UTMALDG"}),
    "lora_bgmv_seq": ("lora_wgmma_kernel", "_f32_kernel", 1, 1,
                      {"HGMMA", "UTMALDG"}),
    # head dims 64, 128, 256 in bf16; 128 and 256 in f32
    "flash_attention": ("attn_wgmma_kernel", "flash_attention_kernel", 3,
                        2, {"HGMMA", "UTMALDG"}),
    # the split-KV decode tile: head dims 64, 128, 256 dense, 64 and 128
    # paged, in bf16; 128 and 256 dense, 128 paged, in f32
    "flash_decode": ("split_kernel", "flash_decode_kernel", 3, 2,
                     {"HMMA", "UTMALDG"}),
    "flash_decode_paged": ("split_kernel", "flash_decode_paged_kernel", 2,
                           1, {"HMMA", "UTMALDG"})}


def sass_functions(build, name: str, ops) -> dict:
    """Each function of library ``name``'s SASS (``cuobjdump -sass``): how
    many instructions it holds of each of ``ops``."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(build._target(name))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs[m.group(1)] = dict.fromkeys(ops, 0)
        elif cur is not None:
            for op in ops:
                if re.search(rf"\b{re.escape(op)}\b", line):
                    cur[op] += 1
    return funcs


def sass_check(build) -> dict:
    """Phase 2: per LoRA library and the attention and decode libraries,
    the kernels whose SASS holds ``HGMMA`` (wgmma), ``HMMA`` (mma.sync)
    and ``UTMALDG`` (TMA loads). Every bf16 tile must hold exactly its
    library's set, every f32 tile none."""
    rec = {}
    for name, (tc_name, cc_name, n_tc, n_cc, want) in SASS_TILES.items():
        ops_of = {f: {op for op, n in c.items() if n}
                  for f, c in sass_functions(build, name, SASS_OPS).items()}
        tc = [f for f in ops_of if tc_name in f]
        cc = [f for f in ops_of if cc_name in f]
        check(len(tc) == n_tc and all(ops_of[f] == want for f in tc),
              f"{name}: a bf16 tile lacks {sorted(want)}, holds more, or "
              f"is missing: { {f: sorted(ops_of[f]) for f in tc} }")
        check(len(cc) == n_cc and not any(ops_of[f] for f in cc),
              f"{name}: an f32 tile runs {[ops_of[f] for f in cc]}, or is "
              "missing")
        rec[name] = {"tensor-core": {f: sorted(ops_of[f]) for f in tc},
                     "cuda-core": {f: sorted(ops_of[f]) for f in cc}}
        log(f"sass {name}: bf16 tile {len(tc)} kernel(s) with "
            f"{' and '.join(sorted(want))}; f32 tile {len(cc)} kernel(s) "
            "with neither")
    return rec


# per library: kernels (by a piece of their name) whose SASS must hold an
# instruction: the bf16 rank pass of lora_matmul_bwd runs on the tensor
# cores (HMMA, r <= 8 and r <= 16 instances), and the bf16 selective scan
# (3 state widths) and RG-LRU (4- and 16-warp plans), each with and
# without its checkpoint stores, take each exponential as one MUFU.EX2
SASS_NEEDS = {
    "lora_matmul_bwd": ("lora_bwd_ug_mma_kernel", 2, "HMMA"),
    "selective_scan": ("selective_scan_kernelI13__nv_bfloat16", 6,
                       "MUFU.EX2"),
    "rglru_scan": ("rglru_scan_kernelI13__nv_bfloat16", 4, "MUFU.EX2")}


def sass_needs(build) -> dict:
    """Phase 2, the redesigned kernels: each listed kernel's SASS holds its
    instruction."""
    rec = {}
    for name, (piece, count, op) in SASS_NEEDS.items():
        has = {f: c[op] for f, c in sass_functions(build, name, (op,)).items()
               if piece in f}
        check(len(has) == count and all(has.values()),
              f"{name}: {count} kernels named {piece} with {op} expected, "
              f"found {has}")
        rec[name] = {"kernels": len(has), "op": op,
                     "per_kernel": list(has.values())}
        log(f"sass {name}: {len(has)} {piece} kernel(s), each with {op} "
            f"({min(has.values())}-{max(has.values())} a kernel)")
    return rec


def mufu_design(name: str, fn: str) -> int:
    """The MUFU.EX2 a bf16 backward kernel's SASS holds by design. The
    selective scan: per state of a thread (NM / 4 of them, NM the
    instance's state width in the name, 16 for the generic one) one for
    each of a chunk's 16 steps in the recompute and one for each in the
    reverse walk but its first, whose exponential is the recompute's
    last, still in a register (ptxas reuses it). The RG-LRU: 3 per gate
    element (two sigmoids and a_t) over its steps of a chunk of 32 (32 /
    NW, NW the warps in the name), and one in each of the two precise
    expf of a_param's softplus and sigmoid(-a_param)."""
    m = re.search(r"Li(\d+)E", fn)
    if name == "selective_scan_bwd":
        nm = int(m.group(1)) or 16 if m else 16
        return (2 * 16 - 1) * (nm // 4)
    return 3 * (32 // int(m.group(1))) + 2


# the backward kernels whose bf16 instances must hold mufu_design's count
MUFU_DESIGN = {
    "selective_scan_bwd": "selective_scan_bwd_kernelI13__nv_bfloat16",
    "rglru_scan_bwd": "rglru_scan_bwd_kernelI13__nv_bfloat16"}


def sass_mufu(build) -> dict:
    """Phase 2, the backward kernels: each bf16 instance holds the
    MUFU.EX2 count of its design (so no exponential is taken more often
    than the design says, and none is kept where it is to be taken
    again)."""
    rec = {}
    for name, piece in MUFU_DESIGN.items():
        has = {f: c["MUFU.EX2"]
               for f, c in sass_functions(build, name, ("MUFU.EX2",)).items()
               if piece in f}
        want = {f: mufu_design(name, f) for f in has}
        check(has and has == want, f"{name}: MUFU.EX2 per kernel {has}, "
              f"by design {want}")
        rec[name] = {"kernels": len(has), "per_kernel": sorted(has.values())}
        log(f"sass {name}: {len(has)} bf16 kernel(s), MUFU.EX2 "
            f"{sorted(has.values())} as designed")
    return rec


def ptxas_entry(line: str) -> str:
    """A short name for the kernel of a ptxas "Compiling entry function"
    line: its name and template arguments (dtype, integers), read from the
    mangled name."""
    i = line.find("_kernelI")
    if i < 0:
        return ""
    j = i
    while j > 0 and (line[j - 1].isalpha() or line[j - 1] == "_"):
        j -= 1
    args = line[i + 8:line.find("EE", i)]
    dtype = "bf16" if "bfloat16" in args else \
        "f32" if args.startswith("f") else ""
    return f"{line[j:i + 7]}<{','.join(filter(None, [dtype] + re.findall(r'Li(\d+)', args)))}>"


def compare(name: str, got, want, dtype) -> float:
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[dtype]
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
    check(bool(ok) and np.isfinite(err),
          f"{name}: kernel vs plain max_abs_err {err} beyond tol {tol}")
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def attn_case(cases: dict, randn, timer: Timer, B: int, S: int, n_p: int,
              Hq: int, Hkv: int, D: int, dtype, *, label: str,
              window: int = 0, sentinel: bool = False, causal: bool = True,
              n_keys: int | None = None) -> None:
    """flash_attention at a prefill of B rows x S tokens behind n_p prefix
    slots (position -1), causal or not, against its plain version, with its
    times and bound (into ``cases``). ``sentinel`` puts the last 64 keys at
    the +1e9 sentinel; ``n_keys`` gives the keys (at positions 0 to n_keys
    - 1) a length of their own (cross attention; default S)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    n_keys = S if n_keys is None else n_keys
    T = n_p + n_keys
    q_pos = torch.arange(S, dtype=torch.int32, device="cuda")
    kv_pos = torch.cat([torch.full((n_p,), -1, dtype=torch.int32,
                                   device="cuda"),
                        torch.arange(n_keys, dtype=torch.int32,
                                     device="cuda")])
    if sentinel:
        kv_pos[-64:] = 10 ** 9
    q = randn(B, S, Hq, D, dtype=dtype)
    k, v = randn(B, T, Hkv, D, dtype=dtype), randn(B, T, Hkv, D, dtype=dtype)
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, window=window, causal=causal)
    got = fa.flash_attention(q, k, v, backend="cuda", **kw)
    want = fa.flash_attention(q, k, v, backend="torch", **kw)
    torch.cuda.synchronize()
    err = compare(f"flash_attention D {D} {label} {dtype}", got, want, dtype)
    vis = ref.visibility_mask(q_pos, kv_pos, window=window, causal=causal)
    bms, by = kernel_costs("flash_attention", dtype, B=B, S=S, T=T, Hq=Hq,
                           Hkv=Hkv, D=D,
                           visible=int(vis.sum().item())).bound()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    cases["flash_attention"].append(dict(
        shape=f"B={B} S={S} "
              f"{'' if n_keys == S else f'T={n_keys} '}prefix={n_p} "
              f"Hq={Hq} Hkv={Hkv} D={D} {label} {str(dtype)[6:]}",
        path=tile_path(dtype), max_abs_err=err, tol=TOL[dtype],
        ms=timer(lambda: fa.flash_attention(q, k, v, backend="cuda", **kw)),
        plain_ms=timer(lambda: fa.flash_attention(q, k, v, backend="torch",
                                                  **kw)),
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=vis, enable_gqa=True)),
        bound_ms=bms, bound_by=by))
    log(f"kernel flash_attention {cases['flash_attention'][-1]}")


def bank_slots(*shape, dtype) -> tuple:
    """A multi-tenant bank's stacked K and V prefix slots, from a generator
    of their own."""
    g = torch.Generator(device="cuda").manual_seed(len(shape) + shape[0])
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for _ in range(2))


def decode_case(cases: dict, timer: Timer, q, kc, vc, qp, kpc, pk, pv,
                window: int, label: str, pids=None,
                causal: bool = True, plain_timer=None) -> None:
    """flash_decode as the models call it (the cache kc / vc at positions
    kpc, the prefix bank pk / pv: shared, or a multi-tenant bank's stacked
    slots read through the rows' ids ``pids``) against its plain version,
    with its path, splits, times, host time per call and bound (into
    ``cases``). The bound reads q, the output, every row's positions (and
    ids), each visible cache key's K and V once (the +1e9 sentinel tails
    and the keys outside the window are not needed) and each bank slot
    that some row reads once: a shared bank once, not once a row.
    ``causal`` False is the cross attention's decode: every cache key but
    the sentinels is visible, and the call takes no prefix bank (``pk``
    None). ``plain_timer`` times the plain version, if given (phase 42's
    32k cache). Returns the plain version's output."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops

    dtype = q.dtype
    B, Hq, D = q.shape
    Tc, Hkv = kc.shape[1], kc.shape[2]
    n_p = 0 if pk is None else pk.shape[-3]
    kw = dict(q_pos=qp, kv_pos=kpc, prefix_k=pk, prefix_v=pv,
              prefix_ids=pids, window=window, causal=causal)
    got = fd.flash_decode(q, kc, vc, backend="cuda", **kw)
    want = fd.flash_decode(q, kc, vc, backend="torch", **kw)
    torch.cuda.synchronize()
    err = compare(f"flash_decode D {D} {dtype}", got, want, dtype)
    qp64, kp64 = qp.long()[:, None], kpc.long()
    vis = (kp64 <= qp64) if causal else (kp64 < 10 ** 8)
    if window:
        vis = vis & (qp64 - kp64 < window)
    vis = vis | (kp64 < 0)                                    # (B, Tc)
    cache_keys = int(vis.sum().item())
    keys = cache_keys + B * n_p                      # every row sees its bank
    n_read = 1 if pids is None else len(set(pids.tolist()))  # bank slots
    bms, by = kernel_costs("flash_decode", dtype, B=B, Hq=Hq, Hkv=Hkv, D=D,
                           Tc=Tc, keys=cache_keys, n_p=n_p, n_read=n_read,
                           ids=pids is not None).bound()
    if pk is None:
        kd, vd = kc, vc
    else:
        rows_k, rows_v = fd.select_rows(pk, pv, pids)
        kd, vd, _ = fd.with_prefix(kc, vc, kpc, rows_k, rows_v)
    qt, kt, vt = q[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2)
    mask = torch.cat([vis.new_ones(B, n_p), vis], 1)[:, None, None, :]
    cases["flash_decode"].append(dict(
        shape=f"{label} {str(dtype)[6:]}",
        **decode_plan(dtype, D, n_p + Tc, B, Hkv),
        max_abs_err=err, tol=TOL[dtype], visible_keys=keys,
        bank="none" if pk is None else "shared" if pids is None
        else f"{pk.shape[0]} slots by id",
        ms=timer(lambda: fd.flash_decode(q, kc, vc, backend="cuda", **kw)),
        ops_ms=timer(lambda: ops.flash_decode(q, kc, vc, **kw)),
        host_us=host_us(lambda: ops.flash_decode(q, kc, vc, **kw)),
        plain_ms=(plain_timer or timer)(lambda: fd.flash_decode(
            q, kc, vc, backend="torch", **kw)),
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)),
        bound_ms=bms, bound_by=by))
    log(f"kernel flash_decode {cases['flash_decode'][-1]}")
    return want


def randn_of(gen: torch.Generator):
    """Normal draws on the card from ``gen``, scaled by ``s``, in
    ``dtype``."""
    def randn(*shape, dtype=torch.bfloat16, s=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * s).to(dtype)
    return randn


def lora_case(cases: dict, randn, timer: Timer, M: int, K: int, N: int,
              dtype, label: str = "") -> None:
    """lora_matmul at M rows, K to N, r 8 with a bias, against its plain
    version, with its times and bound (into ``cases``)."""
    from repro_torch.kernels import lora_matmul as lm
    r, scale = 8, 16.0 / 8
    x = randn(M, K, dtype=dtype)
    w, a = randn(K, N, dtype=dtype, s=K ** -0.5), \
        randn(K, r, dtype=dtype, s=K ** -0.5)
    b, bias = randn(r, N, dtype=dtype, s=0.1), randn(N, dtype=dtype, s=0.1)
    got = lm.lora_matmul(x, w, a, b, scale, bias, backend="cuda")
    want = lm.lora_matmul(x, w, a, b, scale, bias, backend="torch")
    torch.cuda.synchronize()
    err = compare(f"lora_matmul {label}M={M} N={N} {dtype}", got, want,
                  dtype)
    bms, by = kernel_costs("lora_matmul", dtype, M=M, K=K, N=N,
                           r=r).bound()
    cases["lora_matmul"].append(dict(
        shape=f"{label}M={M} K={K} N={N} r={r} bias {str(dtype)[6:]}",
        path=tile_path(dtype), max_abs_err=err, tol=TOL[dtype],
        ms=timer(lambda: lm.lora_matmul(x, w, a, b, scale, bias,
                                        backend="cuda")),
        plain_ms=timer(lambda: lm.lora_matmul(x, w, a, b, scale, bias,
                                              backend="torch")),
        library_ms=timer(lambda: torch.addmm(bias, x, w)
                         + scale * ((x @ a) @ b)),
        bound_ms=bms, bound_by=by))
    log(f"kernel lora_matmul {cases['lora_matmul'][-1]}")


def decode_inputs(randn, gen: torch.Generator, B: int, Tc: int, n_p: int,
                  Hq: int, Hkv: int, D: int, dtype, s_qk: float = 1.0
                  ) -> tuple:
    """flash_decode's operands as the models pass them: B rows against a
    Tc-slot cache, per-row q_pos, sentinels past each row's position, and
    an n_p-slot shared prefix bank; queries and keys drawn at scale
    ``s_qk``. Returns q, kc, vc, qp, kpc, pk, pv."""
    q = randn(B, Hq, D, dtype=dtype, s=s_qk)
    kc, vc = randn(B, Tc, Hkv, D, dtype=dtype, s=s_qk), \
        randn(B, Tc, Hkv, D, dtype=dtype)
    pk, pv = randn(n_p, Hkv, D, dtype=dtype, s=s_qk), \
        randn(n_p, Hkv, D, dtype=dtype)
    qp = torch.randint(32, Tc, (B,), generator=gen, device="cuda",
                       dtype=torch.int32)
    slots = torch.arange(Tc, dtype=torch.int32, device="cuda")[None]
    kpc = torch.where(slots <= qp[:, None], slots,
                      torch.full_like(slots, 10 ** 9)).contiguous()
    return q, kc, vc, qp, kpc, pk, pv


def bgmv_case(cases: dict, randn, timer: Timer, name: str, lead: tuple,
              K: int, N: int, dtype, label: str = "") -> None:
    """A multi-LoRA kernel (``name``: rows at decode, lead (M,); seq at
    prefill, lead (B, S)) at K to N, r 8 with a bias, over a 4-domain bank
    with repeating ids, against its plain version and, row by row
    (sequence by sequence), bit for bit against lora_matmul with the
    row's own adapter; with its times and bound (into ``cases``)."""
    from repro_torch.kernels import lora_bgmv as bg
    from repro_torch.kernels import lora_matmul as lm
    r, scale, n_slots = 8, 16.0 / 8, N_DOMAINS
    x = randn(*lead, K, dtype=dtype)
    w = randn(K, N, dtype=dtype, s=K ** -0.5)
    a = randn(n_slots, K, r, dtype=dtype, s=K ** -0.5)
    b = randn(n_slots, r, N, dtype=dtype, s=0.1)
    bias = randn(N, dtype=dtype, s=0.1)
    ids = torch.tensor([1, 3, 0, 1, 2, 2, 3, 0][:lead[0]], dtype=torch.int32,
                       device="cuda")
    fn = bg.lora_bgmv_rows if name == "lora_bgmv_rows" else bg.lora_bgmv_seq
    got = fn(x, w, a, b, ids, scale, bias, backend="cuda")
    want = fn(x, w, a, b, ids, scale, bias, backend="torch")
    torch.cuda.synchronize()
    err = compare(f"{name} {label}K={K} N={N} {dtype}", got, want, dtype)
    bit_err = 0.0
    for i, sl in enumerate(ids.tolist()):
        xi = x[i:i + 1] if x.dim() == 2 else x[i]
        gi = got[i:i + 1] if x.dim() == 2 else got[i]
        one = lm.lora_matmul(xi, w, a[sl], b[sl], scale, bias,
                             backend="cuda")
        bit_err = max(bit_err, (gi.float() - one.float()).abs().max().item())
        check(torch.equal(gi, one),
              f"{name} {label}K={K} N={N} {dtype}: row {i} differs from "
              f"lora_matmul with its adapter by {bit_err}")
    M_ = x.numel() // K
    bms, by = kernel_costs(name, dtype, M=M_, K=K, N=N, r=r,
                           slots=len(set(ids.tolist())),
                           ids=ids.numel()).bound()
    x2 = x.reshape(M_, K)

    def library():
        # addmm for x W + bias, a gathered bmm for the low-rank term
        if x.dim() == 2:
            lo = torch.bmm(torch.bmm(x[:, None], a[ids]), b[ids])[:, 0]
        else:
            lo = torch.bmm(torch.bmm(x, a[ids]), b[ids]).reshape(M_, N)
        return torch.addmm(bias, x2, w) + scale * lo

    cases[name].append(dict(
        shape=f"{label}{'M' if x.dim() == 2 else 'B x S'}="
              f"{' x '.join(map(str, lead))} K={K} N={N} r={r} "
              f"slots={n_slots} bias {str(dtype)[6:]}",
        path=tile_path(dtype), max_abs_err=err, tol=TOL[dtype],
        bits_vs_lora_matmul=bit_err,
        ms=timer(lambda: fn(x, w, a, b, ids, scale, bias, backend="cuda")),
        plain_ms=timer(lambda: fn(x, w, a, b, ids, scale, bias,
                                  backend="torch")),
        library_ms=timer(library), bound_ms=bms, bound_by=by))
    log(f"kernel {name} {cases[name][-1]}")


def kernel_cases(gen: torch.Generator, timer: Timer) -> dict:
    randn = randn_of(gen)
    cases = {"lora_matmul": [], "flash_attention": [], "flash_decode": [],
             "lora_bgmv_rows": [], "lora_bgmv_seq": []}

    # lora_matmul: q (N 3584) and v (N 512) projections of qwen2-7b, at
    # decode (M = 8 rows) and prefill (M = 8 x 512); r = 8, bias
    K = 3584
    for dtype, shapes in ((torch.bfloat16, [(8, 3584), (8, 512),
                                            (4096, 3584), (4096, 512)]),
                          (torch.float32, [(4096, 3584)])):
        for M, N in shapes:
            lora_case(cases, randn, timer, M, K, N, dtype)

    # flash_attention: prefill of 8 rows x 512 tokens behind 16 prefix
    # slots, Hq 28 / Hkv 4 (g = 7), D 128; plus a case whose last 64 keys
    # carry the +1e9 sentinel; then the head-dim-64 instance at vit-edge's
    # classify (8 x 197 tokens, 12 / 12 heads) and at 512 tokens, where
    # its 4-stage ring is refilled (9 key tiles)
    B, S, n_p, Hq, Hkv, D = 8, 512, 16, 28, 4, 128
    for dtype, label in ((torch.bfloat16, "causal"),
                         (torch.bfloat16, "sentinel"),
                         (torch.float32, "causal")):
        attn_case(cases, randn, timer, B, S, n_p, Hq, Hkv, D, dtype,
                  label=label, sentinel=label == "sentinel")
    for S in (197, 512):
        attn_case(cases, randn, timer, B, S, n_p, 12, 12, 64,
                  torch.bfloat16, label="causal")

    # flash_decode: 8 rows against a 1024-slot cache and a 16-slot prefix
    # bank (shared, position -1) as the models pass it: read in place in
    # bf16, concatenated in front in f32
    Tc = 1024
    for dtype in (torch.bfloat16, torch.float32):
        q, kc, vc, qp, kpc, pk, pv = decode_inputs(randn, gen, B, Tc, n_p,
                                                   Hq, Hkv, D, dtype)
        decode_case(cases, timer, q, kc, vc, qp, kpc, pk, pv, 0,
                    f"B={B} T={Tc}+{n_p} prefix Hq={Hq} Hkv={Hkv} D={D} "
                    f"per-row q_pos")
        if dtype == torch.bfloat16:
            # the bank drains' layout (phases 5 and 13): a 4-domain bank's
            # stacked prefix slots, each row reading its domain's by id
            # (drawn from a generator of its own: the later phases' inputs
            # stay those of a run without this case)
            bk, bv = bank_slots(N_DOMAINS, n_p, Hkv, D, dtype=dtype)
            ids = torch.tensor([1, 3, 0, 1, 2, 2, 3, 0], dtype=torch.int32,
                               device="cuda")
            decode_case(cases, timer, q, kc, vc, qp, kpc, bk, bv, 0,
                        f"B={B} T={Tc}+{n_p} prefix of {N_DOMAINS} domains "
                        f"by id Hq={Hq} Hkv={Hkv} D={D} per-row q_pos",
                        pids=ids)

    # multi-LoRA: the q (N 3584) and v (N 512) projections of a 4-domain
    # bank wave; rows at decode (M = 8 rows, ids repeating), seq at
    # prefill (8 sequences x 512 tokens); r = 8, bias
    for name, dtype, lead, N in (
            ("lora_bgmv_rows", torch.bfloat16, (8,), 3584),
            ("lora_bgmv_rows", torch.bfloat16, (8,), 512),
            ("lora_bgmv_rows", torch.float32, (8,), 3584),
            ("lora_bgmv_seq", torch.bfloat16, (8, 512), 3584),
            ("lora_bgmv_seq", torch.bfloat16, (8, 512), 512),
            ("lora_bgmv_seq", torch.float32, (8, 512), 3584)):
        bgmv_case(cases, randn, timer, name, lead, K, N, dtype)
    return cases


# ---------------------------------------------------------------------------
# phase 12: the paged decode kernel
# ---------------------------------------------------------------------------

def paged_kernel_cases(gen: torch.Generator, timer: Timer,
                       cases: dict) -> None:
    """flash_decode_paged at qwen2-7b's paged drain (into ``cases``)."""
    cases["flash_decode_paged"] = []
    for dtype in (torch.bfloat16, torch.float32):
        paged_case(cases, randn_of(gen), gen, timer, 28, 4, 128, dtype)


def paged_case(cases: dict, randn, gen: torch.Generator, timer: Timer,
               Hq: int, Hkv: int, D: int, dtype, label: str = "",
               B: int = 8) -> None:
    """flash_decode_paged at a paged drain's shape (``B`` rows, blocks of
    16, 64 a row, a 16-slot prefix per row) against its plain version, and
    bit for bit against the dense kernel on the gathered keys; in bf16
    also the bank's slots read by id against the same slots gathered per
    row (into ``cases``)."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops

    bs, maxb, n_p, nb = 16, 64, 16, 512
    q = randn(B, Hq, D, dtype=dtype)
    k_pool, v_pool = randn(nb, bs, Hkv, D, dtype=dtype), \
        randn(nb, bs, Hkv, D, dtype=dtype)
    pk, pv = randn(B, n_p, Hkv, D, dtype=dtype), \
        randn(B, n_p, Hkv, D, dtype=dtype)
    # distinct blocks per row; past each row's written blocks the
    # table holds the n_blocks sentinel, as the engine's tables do
    perm = torch.randperm(nb, generator=gen, device="cuda")
    table = perm[:B * maxb].reshape(B, maxb).to(torch.int32)
    qp = torch.randint(32, maxb * bs, (B,), generator=gen, device="cuda",
                       dtype=torch.int32)
    cols = torch.arange(maxb, device="cuda")[None]
    table = torch.where(cols <= qp[:, None] // bs, table,
                        torch.full_like(table, nb))
    kw = dict(q_pos=qp, prefix_k=pk, prefix_v=pv)
    got = fd.flash_decode_paged(q, k_pool, v_pool, table, **kw)
    want = fd.flash_decode_paged(q, k_pool, v_pool, table,
                                 backend="torch", **kw)
    torch.cuda.synchronize()
    err = compare(f"flash_decode_paged {label}{dtype}", got, want, dtype)

    # the dense kernel on the same keys: cat(prefix, pool[table]), and
    # pool[table] with the prefix bank read in place
    kg, vg = fd.gather_pool(k_pool, v_pool, table)
    slots = torch.arange(maxb * bs, dtype=torch.int32,
                         device="cuda")[None].expand(B, -1).contiguous()
    kd, vd, kpd = fd.with_prefix(kg, vg, slots, pk, pv)
    kd, vd, kpd = kd.contiguous(), vd.contiguous(), kpd.contiguous()
    dense = fd.flash_decode(q, kd, vd, q_pos=qp, kv_pos=kpd)
    in_place = fd.flash_decode(q, kg, vg, q_pos=qp, kv_pos=slots,
                               prefix_k=pk, prefix_v=pv)
    torch.cuda.synchronize()
    bits = (got.float() - dense.float()).abs().max().item()
    check(torch.equal(got, dense),
          f"flash_decode_paged {label}{dtype}: differs from the dense kernel "
          f"on the gathered keys by {bits}")
    bits_in_place = (got.float() - in_place.float()).abs().max().item()
    check(torch.equal(got, in_place),
          f"flash_decode_paged {label}{dtype}: differs from the dense kernel "
          f"with the prefix in place by {bits_in_place}")

    vis = (kpd <= qp[:, None]) | (kpd < 0)               # (B, T)
    keys = int(vis.sum().item())
    bms, by = kernel_costs("flash_decode_paged", dtype, B=B, Hq=Hq, Hkv=Hkv,
                           D=D, maxb=maxb, keys=keys).bound()
    qt = q[:, :, None]
    mask = vis[:, None, None, :]

    def library(gather: bool):
        kk, vv = (kd, vd)
        if gather:
            kk, vv = fd.gather_pool(k_pool, v_pool, table)
            kk = torch.cat([pk, kk], 1)
            vv = torch.cat([pv, vv], 1)
        return F.scaled_dot_product_attention(
            qt, kk.transpose(1, 2), vv.transpose(1, 2), attn_mask=mask,
            enable_gqa=True)

    cases["flash_decode_paged"].append(dict(
        shape=f"{label}B={B} bs={bs} maxb={maxb} blocks={nb} prefix={n_p} "
              f"per-row Hq={Hq} Hkv={Hkv} D={D} per-row q_pos "
              f"{str(dtype)[6:]}",
        **decode_plan(dtype, D, n_p + maxb * bs, B, Hkv),
        max_abs_err=err, tol=TOL[dtype], bits_vs_dense_kernel=bits,
        bits_vs_dense_in_place=bits_in_place, visible_keys=keys,
        ms=timer(lambda: fd.flash_decode_paged(q, k_pool, v_pool, table,
                                               **kw)),
        host_us=host_us(lambda: ops.flash_decode_paged(
            q, k_pool, v_pool, table, **kw)),
        dense_kernel_ms=timer(lambda: fd.flash_decode(
            q, kg, vg, q_pos=qp, kv_pos=slots, prefix_k=pk,
            prefix_v=pv)),
        plain_ms=timer(lambda: fd.flash_decode_paged(
            q, k_pool, v_pool, table, backend="torch", **kw)),
        library_ms=timer(lambda: library(True)),
        library_without_gather_ms=timer(lambda: library(False)),
        bound_ms=bms, bound_by=by))
    if dtype == torch.bfloat16:
        # the paged bank drain's layout (phase 13): a 4-domain bank's
        # stacked prefix slots read by the rows' ids give the bits of
        # the same slots gathered per row; its host time a call
        bk, bv = bank_slots(N_DOMAINS, n_p, Hkv, D, dtype=dtype)
        ids = torch.tensor([1, 3, 0, 1, 2, 2, 3, 0][:B], dtype=torch.int32,
                           device="cuda")
        kw_ids = dict(q_pos=qp, prefix_k=bk, prefix_v=bv,
                      prefix_ids=ids)
        by_id = fd.flash_decode_paged(q, k_pool, v_pool, table, **kw_ids)
        rows = fd.flash_decode_paged(q, k_pool, v_pool, table, q_pos=qp,
                                     prefix_k=bk[ids.long()],
                                     prefix_v=bv[ids.long()])
        torch.cuda.synchronize()
        check(torch.equal(by_id, rows),
              f"flash_decode_paged {label}: the bank read by id differs "
              "from its slots gathered per row by "
              f"{(by_id.float() - rows.float()).abs().max().item()}")
        cases["flash_decode_paged"][-1]["host_us_bank_by_id"] = host_us(
            lambda: ops.flash_decode_paged(q, k_pool, v_pool, table,
                                           **kw_ids))
    log(f"kernel flash_decode_paged {cases['flash_decode_paged'][-1]}")


# ---------------------------------------------------------------------------
# phases 4 to 7: the serving paths
# ---------------------------------------------------------------------------

def queue(rng, n, lens, gens, vocab):
    return [(rng.integers(0, vocab, int(rng.integers(*lens))).astype(np.int32),
             int(rng.integers(*gens))) for _ in range(n)]


def serve_on(eng, params, reqs, domains=None, extras=None):
    """Submit ``reqs`` to ``eng`` (request i with ``extras[i]``, its
    modality row, if given) and drain; completions in request order."""
    uids = [eng.submit(p, g, domain=None if domains is None else domains[i],
                       extras=None if extras is None else extras[i])
            for i, (p, g) in enumerate(reqs)]
    comps, stats = eng.run(params)
    torch.cuda.synchronize()
    by = {c.uid: c for c in comps}
    check(sorted(by) == sorted(uids), "engine lost a request")
    return [by[u] for u in uids], stats


def drain(cfg, params, reqs, slots, bank=None, domains=None, paged=None,
          extras=None):
    from repro_torch.launch.engine import DecodeEngine
    eng = DecodeEngine(cfg, slots=slots, bank=bank, paged=paged,
                       device="cuda")
    return serve_on(eng, params, reqs, domains, extras)


def domain_adapters(cfg, seed: int) -> dict:
    """N_DOMAINS adapter sets from the spec alone (no backbone is built):
    seeded prefix slots and LoRA a, and seeded nonzero LoRA b (the spec
    inits b to zeros, which would make every domain serve alike)."""
    from repro_torch.models.model import adapter_spec
    from repro_torch.models.params import init_from_spec
    out = {}
    for i in range(N_DOMAINS):
        gen = torch.Generator(device="cuda").manual_seed(seed * 1000 + i)
        ad = init_from_spec(gen, adapter_spec(cfg), torch.device("cuda"))
        for layer in ad["stack"]["g0"]:
            for t in layer["s0"]["lora"].values():
                t["b"] = (torch.randn(t["b"].shape, generator=gen,
                                      device="cuda") * 0.1).to(t["b"].dtype)
        out[f"domain{i}"] = ad
    return out


def served_ok(cfg, comps, reqs, what):
    for c, (p, g) in zip(comps, reqs):
        check(len(c.tokens) == g and not c.timed_out,
              f"{what}: request {c.uid}: {len(c.tokens)} tokens, budget {g}")
        check(bool(((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all()),
              f"{what}: request {c.uid}: token out of vocab")


def drain_record(stats, launches, peak) -> dict:
    h = stats.ttft_hist
    return dict(launches=launches, requests=stats.requests,
                tokens=stats.tokens, wall_s=stats.wall_s,
                tok_per_s=stats.tok_per_s, waves=stats.waves,
                segments=stats.segments, padded_tokens=stats.padded_tokens,
                ttft_p50_s=h["p50"], ttft_p99_s=h["p99"],
                tok_latency_p50_s=stats.tok_latency_hist["p50"],
                peak_mem_gib=peak / 2 ** 30)


def maps_ok(what: str, encodes: int, decode_launches: int) -> int:
    """A bank drain's decode calls read the bank's stacked prefix slots by
    id, so its TMA maps are encoded once a tensor (the bank's once, each
    wave's cache once), never once a call: fewer encodes than calls."""
    check(encodes < decode_launches,
          f"{what}: {encodes} TMA maps encoded over {decode_launches} "
          "decode calls")
    log(f"{what}: {encodes} TMA maps encoded over {decode_launches} decode "
        "calls")
    return encodes


def drain_line(r: dict) -> str:
    return (f"{r['requests']} requests, {r['tokens']} tokens in "
            f"{r['wall_s']:.3f}s = {r['tok_per_s']:.2f} tok/s; waves "
            f"{r['waves']}, segments {r['segments']}, padded_tokens "
            f"{r['padded_tokens']}; ttft p50 {r['ttft_p50_s']:.4f}s p99 "
            f"{r['ttft_p99_s']:.4f}s; peak memory {r['peak_mem_gib']:.2f} "
            f"GiB; launches {r['launches']}")


def main_path(seed: int) -> tuple[dict, dict]:
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    cfg = get_config("qwen2-7b")
    check((cfg.n_layers, cfg.d_model, cfg.dtype) == (28, 3584, "bfloat16"),
          "qwen2-7b is not at its published size")
    t0 = time.perf_counter()
    params = M.init(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"main: qwen2-7b init {n_params / 1e9:.3f} B params in "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(seed)
    reqs = queue(rng, 16, (32, 513), (16, 65), cfg.vocab_size)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    comps, stats = drain(cfg, params, reqs, slots=8)
    launches = ops.launch_counts()
    rec = drain_record(stats, launches, torch.cuda.max_memory_allocated())
    served_ok(cfg, comps, reqs, "main")
    check(all(launches[k] > 0 for k in ("lora_matmul", "flash_attention",
                                        "flash_decode")),
          f"a kernel of the single-tenant path never launched: {launches}")
    check(stats.waves > 1, "no in-wave refill happened")
    no_pad_copies("phase 4")
    log(f"main: {drain_line(rec)}")

    # full-size reference check: one prompt's prefill logits through the
    # kernels against the plain path (bf16 through 28 layers: cosine)
    toks = torch.as_tensor(reqs[0][0][None], device="cuda")
    kl, _ = M.prefill(params, {"tokens": toks}, cfg)
    with ops.backend("torch"):
        pl, _ = M.prefill(params, {"tokens": toks}, cfg)
    cos = F.cosine_similarity(kl.flatten(), pl.flatten(), dim=0).item()
    check(bool(torch.isfinite(kl).all()) and cos > 0.99,
          f"full-size prefill logits: kernels vs plain cosine {cos}")
    log(f"main: full-size prefill logits kernels vs plain: cosine {cos:.6f},"
        f" max_abs_err {(kl - pl).abs().max().item():.4f}, top-1 "
        f"{int(kl.argmax())} vs {int(pl.argmax())}")
    rec["prefill_logits_cosine"] = cos
    rec["warm_drain"] = warm_drain(cfg, params, reqs, comps)
    spec_rec = spec_path(cfg, params, reqs, comps, rec, seed)
    from repro_torch.core.adapter_bank import AdapterBank
    bank = AdapterBank.create(domain_adapters(cfg, seed + 1))
    bank_rec = bank_path(cfg, params["backbone"], bank, reqs, seed)
    paged_rec = paged_path(cfg, params["backbone"], bank, seed, bank_rec)
    mesh_rec = mesh_drain(cfg, params["backbone"], bank, reqs,
                          bank_rec["domains"])
    del params, bank
    torch.cuda.empty_cache()
    return rec, bank_rec, paged_rec, spec_rec, mesh_rec


def warm_drain(cfg, params, reqs, comps) -> dict:
    """Phase 43's guard, on phase 4's backbone: a second drain of its
    queue runs under ``compile_guard(max_compiles=0)``: every kernel
    library it needs was built and loaded before."""
    from repro_torch.analysis.guards import compile_guard
    with compile_guard(max_compiles=0) as log_:
        again, stats = drain(cfg, params, reqs, slots=8)
    same = all(np.array_equal(a.tokens, b.tokens)
               for a, b in zip(again, comps))
    log(f"phase 43: warm drain of phase 4's queue under compile_guard("
        f"max_compiles=0): {log_.count} compilations, "
        f"{stats.tok_per_s:.2f} tok/s, tokens as phase 4's: {same}")
    return {"compiles": log_.count, "tok_per_s": stats.tok_per_s,
            "same_tokens": same}


def bank_path(cfg, backbone: dict, bank, reqs: list, seed: int) -> dict:
    """The multi-tenant path on the main path's backbone, serving the main
    path's queue with a seeded domain per request."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    sp = bank.serving_params(backbone)
    rng = np.random.default_rng(seed + 10)
    doms = [bank.domains[int(i)]
            for i in rng.integers(0, N_DOMAINS, len(reqs))]

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    enc0 = fd.map_encodes
    comps, stats = drain(cfg, sp, reqs, slots=8, bank=bank, domains=doms)
    launches = ops.launch_counts()
    rec = drain_record(stats, launches, torch.cuda.max_memory_allocated())
    served_ok(cfg, comps, reqs, "bank")
    rec["map_encodes"] = maps_ok("bank", fd.map_encodes - enc0,
                                 launches["flash_decode"])
    check(all(launches[k] > 0 for k in ("lora_bgmv_rows", "lora_bgmv_seq",
                                        "flash_attention", "flash_decode"))
          and launches["lora_matmul"] == 0,
          f"bank path: every LoRA projection must go through the "
          f"multi-LoRA kernels: {launches}")
    check(stats.waves > 1, "bank: no in-wave refill happened")
    log(f"bank: {N_DOMAINS} domains, mix "
        f"{[doms.count(d) for d in bank.domains]}: {drain_line(rec)}")

    # full-size check: one prompt per domain in one mixed prefill through
    # the multi-LoRA kernels, against each domain's own single-tenant
    # prefill through lora_matmul
    S = 256
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (N_DOMAINS, S)),
                           device="cuda")
    ids = bank.adapter_ids(bank.domains)
    ops.reset_launch_counts()
    mixed, _ = M.prefill(sp, {"tokens": toks}, cfg, adapter_ids=ids)
    n = ops.launch_counts()
    check(n["lora_bgmv_seq"] > 0 and n["lora_matmul"] == 0,
          f"mixed prefill did not take the seq kernel: {n}")
    coss, errs, same = [], [], []
    for i, d in enumerate(bank.domains):
        one, _ = M.prefill({"backbone": backbone,
                            "adapters": bank.snapshot(d)},
                           {"tokens": toks[i:i + 1]}, cfg)
        cos = F.cosine_similarity(mixed[i].flatten(), one[0].flatten(),
                                  dim=0).item()
        top = (int(mixed[i].argmax()), int(one[0].argmax()))
        coss.append(cos)
        errs.append((mixed[i] - one[0]).abs().max().item())
        same.append(bool(torch.equal(mixed[i], one[0])))
        check(bool(torch.isfinite(mixed[i]).all()) and cos > 0.999
              and top[0] == top[1],
              f"bank: mixed vs {d} prefill logits cosine {cos}, top-1 {top}")
    log(f"bank: mixed vs per-domain prefill logits at full size: cosine "
        f"{['%.6f' % c for c in coss]}, max_abs_err "
        f"{['%.4f' % e for e in errs]}, bit-equal {same}")
    # adapter selection is visible: one prompt, every domain
    gen = M.generate(sp, cfg, toks[:1].expand(N_DOMAINS, S), gen=8,
                     adapter_ids=ids).cpu().numpy()
    distinct = len({tuple(r) for r in gen})
    check(distinct >= 2, f"bank: all {N_DOMAINS} domains gave the same "
                         f"tokens {gen[0]}")
    log(f"bank: one prompt through {N_DOMAINS} domains: {distinct} distinct "
        f"token rows")
    rec.update(mixed_prefill_cosine=coss, mixed_prefill_max_abs_err=errs,
               mixed_prefill_bit_equal=same, distinct_domain_rows=distinct,
               domains=doms)
    no_pad_copies("phase 5")
    return rec


def paged_queue(rng, bank, n, tail, gens, vocab, system_len):
    """``n`` requests over the bank's domains in turn; a domain's requests
    share that domain's ``system_len``-token system prompt, then a tail of
    ``tail`` tokens (a range) and a budget in ``gens``."""
    systems = {d: rng.integers(0, vocab, system_len).astype(np.int32)
               for d in bank.domains}
    reqs, doms = [], []
    for i in range(n):
        d = bank.domains[i % len(bank.domains)]
        t = rng.integers(0, vocab, int(rng.integers(*tail))).astype(np.int32)
        reqs.append((np.concatenate([systems[d], t]),
                     int(rng.integers(*gens))))
        doms.append(d)
    return reqs, doms


def paged_path(cfg, backbone: dict, bank, seed: int, dense: dict) -> dict:
    """Phase 13: paged serving of full-size qwen2-7b from the 4-domain bank
    with prefix sharing, twice on one engine."""
    from repro_torch.core.paged import PagedSpec
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import DecodeEngine

    rng = np.random.default_rng(seed + 20)
    reqs, doms = paged_queue(rng, bank, 16, (32, 257), (16, 65),
                             cfg.vocab_size, 256)
    spec = PagedSpec(n_blocks=512, block_size=16, share_prefix=True)
    eng = DecodeEngine(cfg, slots=8, bank=bank, paged=spec, device="cuda")
    sp = bank.serving_params(backbone)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    enc0 = fd.map_encodes
    with plain_calls(serving=True) as plain:
        comps, stats = serve_on(eng, sp, reqs, doms)
    launches = ops.launch_counts()
    rec = drain_record(stats, launches, torch.cuda.max_memory_allocated())
    served_ok(cfg, comps, reqs, "paged")
    rec["map_encodes"] = maps_ok("paged", fd.map_encodes - enc0,
                                 launches["flash_decode_paged"])
    check(all(launches[k] > 0 for k in ("flash_decode_paged",
                                        "lora_bgmv_rows", "lora_bgmv_seq",
                                        "flash_attention"))
          and launches["flash_decode"] == 0 and launches["lora_matmul"] == 0,
          f"paged path: launches {launches}")
    check(all(v == 0 for v in plain.values()),
          f"paged path: a plain version ran on the card: {plain}")
    check(stats.prefix_hits > 0, "paged path: no prefix was shared")
    check(eng._alloc.used_blocks == 0, "paged path: blocks still held")
    eng._alloc.check()
    rec.update(pool_peak_blocks=stats.pool_peak_blocks,
               pool_blocks_alloc=stats.pool_blocks_alloc,
               pool_occupancy=stats.pool_occupancy,
               prefix_hits=stats.prefix_hits,
               prefix_hit_tokens=stats.prefix_hit_tokens,
               cache_tokens=stats.cache_tokens)
    log(f"paged: {N_DOMAINS} domains x 4 requests sharing a 256-token "
        f"system prompt: {drain_line(rec)}; pool peak "
        f"{stats.pool_peak_blocks} blocks, {stats.pool_blocks_alloc} "
        f"allocated, occupancy {stats.pool_occupancy:.4f}, prefix hits "
        f"{stats.prefix_hits} ({stats.prefix_hit_tokens} tokens)")
    log(f"paged: bank drain paged {rec['tok_per_s']:.2f} tok/s, ttft p50 "
        f"{rec['ttft_p50_s']:.4f}s p99 {rec['ttft_p99_s']:.4f}s, peak "
        f"{rec['peak_mem_gib']:.2f} GiB beside dense (phase 5) "
        f"{dense['tok_per_s']:.2f} tok/s, ttft p50 "
        f"{dense['ttft_p50_s']:.4f}s p99 {dense['ttft_p99_s']:.4f}s, peak "
        f"{dense['peak_mem_gib']:.2f} GiB")

    # a second drain of the same prompts: the freed blocks keep their
    # hashes on the free list and are revived
    again, st2 = serve_on(eng, sp, reqs, doms)
    check(st2.prefix_hits > 0, "paged path: no block revived on redrain")
    check(eng._alloc.used_blocks == 0, "paged path: blocks held on redrain")
    eng._alloc.check()
    same = sum(np.array_equal(a.tokens, b.tokens)
               for a, b in zip(comps, again))
    log(f"paged: second drain of the same prompts: {st2.prefix_hits} prefix "
        f"hits ({st2.prefix_hit_tokens} tokens), {st2.tok_per_s:.2f} tok/s,"
        f" {same}/{len(reqs)} requests gave the first drain's tokens")
    rec.update(redrain_prefix_hits=st2.prefix_hits,
               redrain_tok_per_s=st2.tok_per_s, redrain_same_tokens=same)
    no_pad_copies("phase 13")
    return rec


def end_to_end(seed: int) -> dict:
    from repro_torch.configs.base import get_config
    from repro_torch.core.adapter_bank import AdapterBank
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    cfg = get_config("qwen2-7b").with_(n_layers=2, dtype="float32")
    params = M.init(cfg, seed, device="cuda")
    reqs = queue(np.random.default_rng(seed + 1), 8, (32, 513), (4, 17),
                 cfg.vocab_size)
    kernel, st = drain(cfg, params, reqs, slots=4)
    with ops.backend("torch"):
        plain, _ = drain(cfg, params, reqs, slots=4)
    for a, b in zip(kernel, plain):
        check(np.array_equal(a.tokens, b.tokens),
              f"e2e f32: request {a.uid} kernel {a.tokens} vs plain "
              f"{b.tokens}")
    p, g = reqs[0]
    solo = M.generate(params, cfg, torch.as_tensor(p[None], device="cuda"),
                      gen=g)[0].cpu().numpy()
    check(np.array_equal(solo, kernel[0].tokens),
          "e2e f32: drain differs from solo generate")
    log(f"e2e: 2-layer f32 qwen2-7b, {len(reqs)} requests, {st.waves} waves:"
        f" kernel tokens == plain tokens == solo generate")

    # the bank path at the same size: one mixed-domain drain through the
    # kernels, through the plain versions, and per domain single-tenant
    backbone = params["backbone"]
    bank = AdapterBank.create(domain_adapters(cfg, seed + 2))
    sp = bank.serving_params(backbone)
    rng = np.random.default_rng(seed + 3)
    breqs = queue(rng, 8, (32, 513), (4, 17), cfg.vocab_size)
    doms = [bank.domains[int(i)] for i in rng.integers(0, N_DOMAINS, 8)]
    ops.reset_launch_counts()
    bk, bst = drain(cfg, sp, breqs, slots=4, bank=bank, domains=doms)
    n = ops.launch_counts()
    check(n["lora_bgmv_rows"] > 0 and n["lora_bgmv_seq"] > 0
          and n["lora_matmul"] == 0, f"e2e bank launches {n}")
    with ops.backend("torch"):
        bp, _ = drain(cfg, sp, breqs, slots=4, bank=bank, domains=doms)
    for a, b in zip(bk, bp):
        check(np.array_equal(a.tokens, b.tokens),
              f"e2e f32 bank: request {a.uid} kernel {a.tokens} vs plain "
              f"{b.tokens}")
    for d in sorted(set(doms)):
        idx = [i for i, x in enumerate(doms) if x == d]
        one, _ = drain(cfg, {"backbone": backbone,
                             "adapters": bank.snapshot(d)},
                       [breqs[i] for i in idx], slots=4)
        for i, c in zip(idx, one):
            check(np.array_equal(bk[i].tokens, c.tokens),
                  f"e2e f32 bank: request {i} ({d}) mixed {bk[i].tokens} vs "
                  f"per-domain {c.tokens}")
    log(f"e2e: 2-layer f32 bank of {N_DOMAINS} domains, {len(breqs)} "
        f"requests, {bst.waves} waves: kernel tokens == plain tokens == "
        f"per-domain drains")
    paged = paged_exactness(cfg, params, bank, seed)
    spec = spec_exactness("e2e", cfg, params, seed)
    del params
    torch.cuda.empty_cache()
    return dict(requests=len(reqs), waves=st.waves, tokens_equal=True,
                bank_requests=len(breqs), bank_waves=bst.waves,
                bank_tokens_equal=True, paged=paged, spec=spec)


def paged_exactness(cfg, params, bank, seed: int) -> dict:
    """Phase 14: paged drains of a ragged queue with shared prefixes,
    through the kernels and the plain versions, single-tenant and from the
    bank, with and without prefix sharing, against the dense drains, solo
    generation and a staggered serve_trace."""
    from repro_torch.core.paged import PagedSpec
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.models import model as M

    rng = np.random.default_rng(seed + 6)
    reqs, doms = paged_queue(rng, bank, 8, (8, 257), (4, 17),
                             cfg.vocab_size, 64)
    sp = bank.serving_params(params["backbone"])
    out = {}
    for tenant in (False, True):
        pp, dd = (sp, doms) if tenant else (params, None)
        what = "bank" if tenant else "single-tenant"
        dense, _ = drain(cfg, pp, reqs, slots=4, bank=bank if tenant
                         else None, domains=dd)
        if not tenant:
            for (p, g), c in zip(reqs, dense):
                solo = M.generate(params, cfg,
                                  torch.as_tensor(p[None], device="cuda"),
                                  gen=g)[0].cpu().numpy()
                check(np.array_equal(solo, c.tokens),
                      f"paged e2e: dense drain differs from solo for "
                      f"request {c.uid}")
        for share in (False, True):
            spec = PagedSpec(n_blocks=256, block_size=16, share_prefix=share)
            ops.reset_launch_counts()
            kern, st = drain(cfg, pp, reqs, slots=4, bank=bank if tenant
                             else None, domains=dd, paged=spec)
            n = ops.launch_counts()
            check(n["flash_decode_paged"] > 0 and n["flash_decode"] == 0,
                  f"paged e2e {what}: launches {n}")
            check(not share or st.prefix_hits > 0,
                  f"paged e2e {what}: no prefix shared")
            with ops.backend("torch"):
                plain, _ = drain(cfg, pp, reqs, slots=4, bank=bank if tenant
                                 else None, domains=dd, paged=spec)
            for a, b, c in zip(kern, plain, dense):
                check(np.array_equal(a.tokens, b.tokens)
                      and np.array_equal(a.tokens, c.tokens),
                      f"paged e2e {what} share_prefix={share}: request "
                      f"{a.uid} kernel {a.tokens} plain {b.tokens} dense "
                      f"{c.tokens}")
            out[f"{what} share_prefix={share}"] = dict(
                waves=st.waves, prefix_hits=st.prefix_hits,
                pool_peak_blocks=st.pool_peak_blocks)
        if not tenant:
            eng = DecodeEngine(cfg, slots=4, device="cuda",
                               paged=PagedSpec(256, 16, share_prefix=True))
            comps, st = eng.serve_trace(params, [
                (0.02 * i, p, g) for i, (p, g) in enumerate(reqs)])
            torch.cuda.synchronize()
            by = {c.uid: c.tokens for c in comps}
            check(sorted(by) == list(range(len(reqs))) and all(
                np.array_equal(by[i], dense[i].tokens)
                for i in range(len(reqs))),
                "paged e2e: serve_trace tokens differ from the dense drain")
            out["serve_trace"] = dict(waves=st.waves,
                                      prefix_hits=st.prefix_hits)
    log(f"paged e2e: 2-layer f32 qwen2-7b, {len(reqs)} requests sharing "
        f"per-domain 64-token prefixes: paged kernel == paged plain == "
        f"dense == solo, single-tenant and bank, with and without prefix "
        f"sharing, and a staggered serve_trace: {out}")
    return out


def classify_phase(seed: int) -> dict:
    """vit-edge (the paper's case-study backbone) at its configured size:
    mixed-domain classify through the bank's per-row heads."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.adapter_bank import AdapterBank
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    cfg = get_config("vit-edge")
    check((cfg.n_layers, cfg.d_model) == (12, 768),
          "vit-edge is not at its configured size")
    backbone = M.init(cfg, seed, device="cuda")["backbone"]
    adapters = domain_adapters(cfg, seed + 4)
    bank = AdapterBank.create(adapters)
    rng = np.random.default_rng(seed + 5)
    B, S = 8, 197
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                           device="cuda")
    doms = [bank.domains[int(i)] for i in rng.integers(0, N_DOMAINS, B)]
    dt = getattr(torch, cfg.dtype)
    with torch.no_grad():
        ops.reset_launch_counts()
        mixed = M.classify(bank.serving_params(backbone), {"tokens": toks},
                           cfg, adapter_ids=bank.adapter_ids(doms))
        n = ops.launch_counts()
        check(n["lora_bgmv_seq"] > 0 and n["lora_matmul"] == 0,
              f"classify did not take the seq kernel: {n}")
        want = torch.cat([M.classify({"backbone": backbone,
                                      "adapters": adapters[d]},
                                     {"tokens": toks[i:i + 1]}, cfg)
                          for i, d in enumerate(doms)])
    err = compare("classify mixed vs per-domain", mixed, want, dt)
    check(mixed.shape == (B, cfg.peft.head_dim_out), "classify shape")
    log(f"classify: vit-edge {B} x {S} tokens over {len(set(doms))} domains:"
        f" mixed vs per-domain max_abs_err {err:.3e} (tol {TOL[dt]})")
    return dict(batch=B, seq=S, max_abs_err=err, tol=TOL[dt])


# ---------------------------------------------------------------------------
# phase 8: the training kernels
# ---------------------------------------------------------------------------

def lora_bwd_case(randn, timer: Timer, M: int, K: int, N: int, r: int,
                  dtype, what: str = "") -> dict:
    """lora_matmul_bwd at one shape against its plain version: the
    error, bits repeated by a second call, the kernel's, plain and
    library times and the bound."""
    from repro_torch.kernels import lora_matmul as lm
    scale = 16.0 / r
    x, dy = randn(M, K, dtype=dtype), randn(M, N, dtype=dtype)
    a = randn(K, r, dtype=dtype, s=K ** -0.5)
    b = randn(r, N, dtype=dtype, s=0.1)
    got = lm.lora_matmul_bwd(x, dy, a, b, scale, backend="cuda")
    want = lm.lora_matmul_bwd(x, dy, a, b, scale, backend="torch")
    torch.cuda.synchronize()
    # both sum in f32 from the same inputs, in other orders: each output
    # is a sum over M rows of terms up to ~10 in size, so the f32
    # tolerance is taken relative to the largest output (a normwise 1e-4)
    tol = TOL[torch.float32] * max(w.abs().max().item() for w in want)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    label = f"M={M} K={K} N={N} r={r} {str(dtype)[6:]}{what}"
    check(np.isfinite(err) and err <= tol,
          f"lora_matmul_bwd {label}: kernel vs plain max_abs_err {err} "
          f"beyond tol {tol}")
    bms, by = kernel_costs("lora_matmul_bwd", dtype, M=M, K=K, N=N,
                           r=r).bound()

    def library():
        g = dy @ b.t()
        return scale * (x.t() @ g), scale * ((x @ a).t() @ dy)

    plan = lm.bwd_plan(M, K, N, r, _build_sms(), dtype)
    again = lm.lora_matmul_bwd(x, dy, a, b, scale, backend="cuda")
    torch.cuda.synchronize()
    check(all(torch.equal(g, h) for g, h in zip(got, again)),
          f"lora_matmul_bwd {label}: a second call gave other bits")
    c = dict(shape=label,
             path=f"rank pass {plan['rank']}, sweep "
                  f"{plan['n_k'] + plan['n_n']} tiles x "
                  f"{plan['splits']} splits of {plan['rows']} rows",
             max_abs_err=err, tol=tol, bits_repeat=True,
             ms=timer(lambda: lm.lora_matmul_bwd(x, dy, a, b, scale,
                                                 backend="cuda")),
             plain_ms=timer(lambda: lm.lora_matmul_bwd(
                 x, dy, a, b, scale, backend="torch")),
             library_ms=timer(library), bound_ms=bms, bound_by=by)
    log(f"kernel lora_matmul_bwd {c}")
    return c


def train_kernel_cases(gen: torch.Generator, timer: Timer,
                       cases: dict) -> dict:
    """lora_matmul_bwd cases (into ``cases``), the dx-shape lora_matmul
    cases (appended to lora_matmul's), the Wᵀ copy times and the autograd
    checks. Returns the record of the checks and copies."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ops

    randn = randn_of(gen)

    # the HFSL round's projections: M = 4 x 256 tokens, K = d_model, q
    # (N 3584) and v (N 512), r = 8
    M, K, r, scale = 1024, 3584, 8, 16.0 / 8
    cases["lora_matmul_bwd"] = [
        lora_bwd_case(randn, timer, M, K, N, r, dtype)
        for dtype in (torch.bfloat16, torch.float32) for N in (3584, 512)]

    # dx = dy Wᵀ + s (dy Bᵀ) Aᵀ through the forward kernel, and the copy
    # of the frozen W into Wᵀ that each backward call makes
    copies = {}
    for N, proj in ((3584, "q"), (512, "v")):
        dy = randn(M, N)
        w = randn(K, N, s=K ** -0.5)
        a, b = randn(K, r, s=K ** -0.5), randn(r, N, s=0.1)
        wt, bt, at = w.t().contiguous(), b.t().contiguous(), \
            a.t().contiguous()
        got = lm.lora_matmul(dy, wt, bt, at, scale, backend="cuda")
        want = lm.lora_matmul(dy, wt, bt, at, scale, backend="torch")
        torch.cuda.synchronize()
        err = compare(f"lora_matmul dx {proj}", got, want, torch.bfloat16)
        # the forward kernel on (dy, Wᵀ, Bᵀ, Aᵀ): K and N trade places
        bms, by = kernel_costs("lora_matmul", torch.bfloat16, M=M, K=N,
                               N=K, r=r, bias=False).bound()
        cases["lora_matmul"].append(dict(
            shape=f"dx of {proj}: dy M={M} N={N} against W^T ({N}x{K}) "
                  f"r={r} bf16",
            path=tile_path(torch.bfloat16), max_abs_err=err,
            tol=TOL[torch.bfloat16],
            ms=timer(lambda: lm.lora_matmul(dy, wt, bt, at, scale,
                                            backend="cuda")),
            plain_ms=timer(lambda: lm.lora_matmul(dy, wt, bt, at, scale,
                                                  backend="torch")),
            library_ms=timer(lambda: dy @ wt + scale * ((dy @ bt) @ at)),
            bound_ms=bms, bound_by=by))
        log(f"kernel lora_matmul {cases['lora_matmul'][-1]}")
        copies[proj] = dict(
            shape=f"{K}x{N} bf16", ms=timer(lambda: w.t().contiguous()),
            bound_ms=bound(2 * 2 * K * N, 0, torch.bfloat16)[0])
        log(f"W^T copy {proj}: {copies[proj]}")

    # the autograd lora_matmul on the card (v shape, B != 0) against
    # autograd through the plain version; dW only when w requires grad
    N = 512
    x, w = randn(M, K), randn(K, N, s=K ** -0.5)
    a, b = randn(K, r, s=K ** -0.5), randn(r, N, s=0.1)
    bias, dy = randn(N, s=0.1), randn(M, N)
    vjp_tol = dict(atol=1e-1, rtol=5e-2)      # tests/test_kernels.py, bf16
    errs = {}
    for train_w in (False, True):
        def grads(fn):
            ts = [t.clone().requires_grad_(True) for t in (x, a, b, bias)]
            wt_ = w.clone().requires_grad_(train_w)
            (fn(ts[0], wt_, ts[1], ts[2], scale, ts[3]).float()
             * dy.float()).sum().backward()
            return [t.grad for t in ts] + [wt_.grad]

        ops.reset_launch_counts()
        got = grads(lambda *t: ops.lora_matmul(*t))
        n = ops.launch_counts()
        check((n["lora_matmul"], n["lora_matmul_bwd"]) == (2, 1),
              f"autograd lora_matmul launches {n}")
        want = grads(lm.lora_matmul_torch)
        torch.cuda.synchronize()
        for name, g, w_ in zip(("dx", "dA", "dB", "dbias"), got, want):
            e = (g.float() - w_.float()).abs().max().item()
            check(bool(torch.allclose(g.float(), w_.float(), **vjp_tol)),
                  f"autograd lora_matmul {name}: max_abs_err {e}")
            errs[name] = max(errs.get(name, 0.0), e)
        if train_w:
            e = (got[4].float() - x.float().t() @ dy.float()).abs().max()
            check(bool(torch.allclose(got[4].float(),
                                      x.float().t() @ dy.float(),
                                      **vjp_tol)), f"dW max_abs_err {e}")
            errs["dW"] = e.item()
        else:
            check(got[4] is None, "PEFT: w.grad was formed")
    log(f"autograd lora_matmul vs plain (bf16, M={M} K={K} N={N}): "
        f"max_abs_err {errs}; w.grad None under PEFT")

    # the flash-attention backward on the card against autograd through
    # the plain tile loop, with prefix slots and GQA
    B, S, n_p, Hq, Hkv, D = 2, 64, 16, 28, 4, 128
    fa_errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = randn(B, S, Hq, D, dtype=dtype)
        k, v = randn(B, n_p + S, Hkv, D, dtype=dtype), \
            randn(B, n_p + S, Hkv, D, dtype=dtype)
        do = randn(B, S, Hq, D, dtype=dtype)
        q_pos = torch.arange(S, dtype=torch.int32, device="cuda")
        kv_pos = torch.cat([torch.full((n_p,), -1, dtype=torch.int32,
                                       device="cuda"), q_pos])

        def fgrads(fn):
            ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
            (fn(*ts, q_pos=q_pos, kv_pos=kv_pos).float()
             * do.float()).sum().backward()
            return [t.grad for t in ts]

        with plain_calls() as plain:
            got = fgrads(fa.flash_attention)
        check(plain["flash_attention"] == 0,
              "the attention backward ran the plain tile loop")
        want = fgrads(fa.flash_attention_torch)
        torch.cuda.synchronize()
        tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
        for name, g, w_ in zip(("dq", "dk", "dv"), got, want):
            e = (g.float() - w_.float()).abs().max().item()
            check(bool(torch.allclose(g.float(), w_.float(), atol=tol,
                                      rtol=tol)),
                  f"flash_attention {name} {dtype}: max_abs_err {e}")
            fa_errs[f"{name} {str(dtype)[6:]}"] = e
    log(f"flash_attention backward vs autograd through the tile loop "
        f"(B={B} S={S} prefix={n_p} Hq={Hq} Hkv={Hkv} D={D}): {fa_errs}")
    return dict(wt_copy=copies, autograd_lora_max_abs_err=errs,
                attention_bwd_max_abs_err=fa_errs)


def _build_sms() -> int:
    """The card's SMs, as the wrappers read them."""
    return torch.cuda.get_device_properties(0).multi_processor_count


class plain_calls:
    """Counts calls of the plain versions on the training path (and, with
    ``serving``, on the serving path; with ``scans``, the two scans'
    forward and backward) while active: a round or a drain on the card
    must run none of them."""

    def __init__(self, serving: bool = False, scans: bool = False):
        self.serving, self.scans = serving, scans

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import flash_decode as fd
        from repro_torch.kernels import lora_bgmv as bg
        from repro_torch.kernels import lora_matmul as lm
        from repro_torch.kernels import rglru_scan as rg
        from repro_torch.kernels import selective_scan as ss
        self.counts = {}
        self.patched = []
        targets = [(lm, "lora_matmul_torch", "lora_matmul"),
                   (lm, "lora_matmul_bwd_torch", "lora_matmul_bwd"),
                   (fa, "online_softmax", "flash_attention")]
        if self.serving:
            targets += [(bg, "lora_bgmv_torch", "lora_bgmv"),
                        (fd, "flash_decode_torch", "flash_decode"),
                        (fd, "flash_decode_paged_torch",
                         "flash_decode_paged")]
        if self.serving or self.scans:
            targets += [(ss, "selective_scan_torch", "selective_scan"),
                        (rg, "rglru_torch", "rglru_scan")]
        if self.scans:
            targets += [(ss, "selective_scan_bwd_torch",
                         "selective_scan_bwd"),
                        (rg, "rglru_bwd_torch", "rglru_scan_bwd")]
        for mod, attr, key in targets:
            fn = getattr(mod, attr)
            self.counts[key] = 0
            self.patched.append((mod, attr, fn))
            setattr(mod, attr, self._counted(fn, key))
        return self.counts

    def _counted(self, fn, key):
        def counted(*a, **k):
            self.counts[key] += 1
            return fn(*a, **k)
        return counted

    def __exit__(self, *exc):
        for mod, attr, fn in self.patched:
            setattr(mod, attr, fn)


# ---------------------------------------------------------------------------
# phases 9 to 11: HFSL training rounds
# ---------------------------------------------------------------------------

def classify_bank(task_args: tuple, n_clusters: int, batch: int,
                  steps: int, seed: int, classes_per_client: int):
    """A BatchBank from ClassificationTask + partition_by_classes, as
    ``launch/train.py`` and ``IntegratedRuntime`` build theirs."""
    from repro_torch.data.noniid import partition_by_classes
    from repro_torch.data.pipeline import BatchBank
    from repro_torch.data.synthetic import ClassificationTask
    n_classes, vocab, seq, strength = task_args
    task = ClassificationTask(n_classes, vocab, seq, seed=seed,
                              class_strength=strength)
    data = task.dataset(200 * n_clusters, seed=seed + 11)
    parts = partition_by_classes(data["label"], n_clusters,
                                 classes_per_client, seed=seed)
    return BatchBank.pack(data, parts, batch, seed=seed, steps=steps,
                          device="cuda")


def spread(state) -> float:
    """Largest difference between cluster replicas over all leaves."""
    return max(float((x.float().amax(0) - x.float().amin(0)).abs().max())
               for x in _leaves(state["adapters_c"]))


def round_launches(cfg, n_clusters: int, steps: int) -> dict:
    """The launches an HFSL round of ``cfg`` (classify_loss) must make,
    kernel by kernel (None: at least one): classify_loss runs no remat, so
    each scan's forward and backward kernel launch once a sub-layer a
    step, and flash_attention once an attention sub-layer a step (its
    backward is torch); lora_matmul_bwd once a LoRA target an attention
    sub-layer a step (a moe sub-layer is one: its FFN launches no kernel
    of the port); lora_matmul at least once where there is attention; no
    serving kernel."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import ATTN_KINDS, groups_for
    cs = n_clusters * steps
    count = {k: sum(sum(kinds.count(x) for x in xs) * n
                    for _, kinds, n in groups_for(cfg))
             for k, xs in (("ssm", ("ssm",)), ("rglru", ("rglru",)),
                           ("attn", ATTN_KINDS))}
    want = dict.fromkeys(ops.launch_counts(), 0)
    want.update(selective_scan=count["ssm"] * cs,
                selective_scan_bwd=count["ssm"] * cs,
                rglru_scan=count["rglru"] * cs,
                rglru_scan_bwd=count["rglru"] * cs,
                flash_attention=count["attn"] * cs,
                lora_matmul_bwd=len(cfg.peft.lora_targets) * count["attn"]
                * cs)
    if count["attn"]:
        want["lora_matmul"] = None
    return want


def launches_as_predicted(launches: dict, want: dict) -> bool:
    return all(launches[k] > 0 if n is None else launches[k] == n
               for k, n in want.items())


def train_round(name: str, cfg, *, n_clusters: int, steps: int, batch: int,
                sync_every: int, task_args: tuple, seed: int) -> dict:
    """One HFSL round of ``steps`` steps at ``cfg``'s full width: first
    ``steps`` one-step rounds (the sync pattern, and a warm-up), then the
    timed ``steps``-step round from the same state, whose launches must
    be :func:`round_launches`' prediction and which must run no plain
    version."""
    from repro_torch.core import hfsl
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import adamw

    t0 = time.perf_counter()
    opt = adamw(5e-3)
    state = hfsl.init_hfsl_state(seed, cfg, n_clusters, opt, M.init,
                                 device="cuda")
    bank = classify_bank(task_args, n_clusters, batch, steps, seed,
                         cfg.peft.head_dim_out)
    torch.cuda.synchronize()
    log(f"{name}: {cfg.name} {cfg.n_layers} layers d {cfg.d_model} "
        f"{cfg.dtype}, state and a {bank.steps}-row bank in "
        f"{time.perf_counter() - t0:.1f}s")

    one = hfsl.make_hfsl_round(cfg, opt, M.classify_loss, steps=1,
                               sync_every=sync_every)
    s, spreads = state, []
    for i in range(steps):
        s, _ = one(s, bank.arrays, i % bank.steps)
        spreads.append(spread(s))
    for i, sp in enumerate(spreads, 1):
        if i % sync_every == 0:
            check(sp == 0.0, f"{name}: replicas differ by {sp} right after "
                             f"the sync at step {i}")
        elif i == 1:
            check(sp > 0.0, f"{name}: replicas equal after step 1")
    check(int(s["step"]) == steps, f"{name}: step counter {s['step']}")

    rnd = hfsl.make_hfsl_round(cfg, opt, M.classify_loss, steps=steps,
                               sync_every=sync_every)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = round_launches(cfg, n_clusters, steps)
    log(f"{name}: predicted launches of the timed round "
        f"{ {k: v for k, v in want.items() if v != 0} } (None: at least "
        "one), every other kernel 0")
    ops.reset_launch_counts()
    with plain_calls(scans=True) as plain:
        t0 = time.perf_counter()
        out, metrics = rnd(state, bank.arrays, 0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = metrics["loss"].cpu().numpy()
    check(bool(np.isfinite(losses).all()), f"{name}: losses {losses}")
    moved = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(_leaves(out["adapters_c"]),
                                _leaves(state["adapters_c"])))
    check(moved > 0.0, f"{name}: the adapters did not change")
    # recorded, not checked: the CPU tests hold the two bit for bit
    vs_steps = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(_leaves(out["adapters_c"]),
                                   _leaves(s["adapters_c"])))
    check(launches_as_predicted(launches, want),
          f"{name}: launches {launches}, predicted {want}")
    check(all(v == 0 for v in plain.values()),
          f"{name}: a plain version ran on the card: {plain}")
    examples = steps * n_clusters * batch
    rec = dict(config=f"{cfg.name} {cfg.n_layers} layers d {cfg.d_model} "
                      f"{cfg.dtype}", clusters=n_clusters, steps=steps,
               batch=batch, seq=task_args[2], sync_every=sync_every,
               wall_s=wall, step_s=wall / steps, examples_per_s=examples / wall,
               peak_mem_gib=peak / 2 ** 30, launches=launches,
               predicted_launches=want,
               losses=losses.tolist(), spreads=spreads,
               adapter_change=moved, round_vs_one_step_rounds=vs_steps)
    log(f"{name}: {steps} steps x {n_clusters} clusters x batch {batch} "
        f"(seq {task_args[2]}) in {wall:.3f}s = {wall / steps:.4f} s/step, "
        f"{examples / wall:.2f} examples/s, peak memory "
        f"{peak / 2 ** 30:.2f} GiB; losses {np.round(losses, 4).tolist()}; "
        f"replica spread after each step {['%.2e' % x for x in spreads]}; "
        f"launches {launches}")
    del state, out, s, bank
    torch.cuda.empty_cache()
    return rec


def round_exactness(ks, km, ps, pm, state) -> dict:
    """A round through the kernels (``ks``, metrics ``km``) against the
    same round through the plain versions (``ps``, ``pm``) from
    ``state``: the losses' and adapters' largest differences, and each
    leaf's largest update difference relative to the leaf's largest
    update (an absolute 1e-4 is blind on leaves whose updates are
    smaller than that)."""
    trip = list(zip(_leaves(ks["adapters_c"]), _leaves(ps["adapters_c"]),
                    _leaves(state["adapters_c"])))
    return dict(
        loss_max_abs_err=(km["loss"] - pm["loss"]).abs().max().item(),
        adapters_max_abs_err=max((a - b).abs().max().item()
                                 for a, b, _ in trip),
        update_max_rel_err=max(
            (a - b).abs().max().item()
            / max((b - c).abs().max().item(), 1e-30) for a, b, c in trip),
        update_max=max((b - c).abs().max().item() for _, b, c in trip))


def exact_enough(r: dict) -> bool:
    """Phase 11's criteria: losses and adapters within 1e-4, each leaf's
    update within 1e-3 of its largest."""
    return r["loss_max_abs_err"] <= 1e-4 and \
        r["adapters_max_abs_err"] <= 1e-4 and r["update_max_rel_err"] <= 1e-3


def train_phases(seed: int) -> dict:
    import dataclasses

    from repro_torch.configs.base import get_config

    # phase 9: qwen2-7b at its published size, as launch/train.py's
    # build_cfg builds it for --task classify (a 5-class head); the data's
    # Markov vocab is 1000 (dense vocab x vocab transition matrices at
    # 152064 would take 185 GB)
    cfg = get_config("qwen2-7b")
    cfg = cfg.with_(peft=dataclasses.replace(cfg.peft, head_dim_out=5))
    check((cfg.n_layers, cfg.d_model) == (28, 3584),
          "qwen2-7b is not at its published size")
    rec = {"train": train_round(
        "train", cfg, n_clusters=2, steps=4, batch=4, sync_every=2,
        task_args=(5, 1000, 256, 0.5), seed=seed)}
    no_pad_copies("phase 9")

    # phase 10: the paper's round, vit-edge with IntegratedRuntime's
    # upgrade settings and its examples' task
    vit = get_config("vit-edge")
    check((vit.n_layers, vit.d_model, vit.peft.head_dim_out) == (12, 768, 5),
          "vit-edge is not at its configured size")
    rec["paper_round"] = train_round(
        "paper round", vit, n_clusters=2, steps=20, batch=16, sync_every=5,
        task_args=(5, 64, 48, 0.6), seed=seed)
    no_pad_copies("phase 10")

    # phase 11: f32 2-layer full-width qwen2-7b, kernels against plain
    rec["train_e2e"] = f32_round_exactness(
        "e2e train", cfg.with_(n_layers=2, dtype="float32"), seed)
    return rec


def f32_round_exactness(name: str, small, seed: int) -> dict:
    """Phases 11 and 35: a 2-cluster, 3-step HFSL round of the f32 config
    ``small`` through the kernels and through the plain versions.
    SGD with momentum: AdamW's m / (sqrt(v) + eps) turns a gradient
    difference d on an element whose gradient is near eps into an update
    difference of up to lr * d / eps (5e5 d at lr 5e-3), so an AdamW
    round measures Adam's conditioning, not the kernels; it is run and
    recorded, not checked. An absolute 1e-4 is blind on leaves whose
    SGD updates are smaller than that, so each leaf's update must also
    agree within 1e-3 of the leaf's largest update."""
    from repro_torch.core import hfsl
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.transformer import groups_for
    from repro_torch.optim.optimizers import adamw, sgd

    state = hfsl.init_hfsl_state(seed, small, 2, sgd(0.1, momentum=0.9),
                                 M.init, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    for layer in state["adapters_c"]["stack"]["g0"]:
        for t in layer["s0"]["lora"].values():
            t["b"] = torch.randn(t["b"].shape, generator=gen,
                                 device="cuda") * 0.1
    bank = classify_bank((5, 1000, 256, 0.5), 2, 4, 3, seed,
                         small.peft.head_dim_out)
    n_layers = sum(n for _, _, n in groups_for(small))
    n_targets = len(small.peft.lora_targets)
    out = {}
    for opt_name, opt in (("sgd", sgd(0.1, momentum=0.9)),
                          ("adamw", adamw(5e-3))):
        if opt_name == "adamw":
            state = {**state, "opt": hfsl.init_opt_state(
                opt, state["adapters_c"])}
        rnd = hfsl.make_hfsl_round(small, opt, M.classify_loss, steps=3,
                                   sync_every=2)
        ops.reset_launch_counts()
        ks, km = rnd(state, bank.arrays, 0)
        n = ops.launch_counts()
        check(n["lora_matmul_bwd"] == n_targets * n_layers * 2 * 3,
              f"{name}: launches {n}")
        with ops.backend("torch"):
            with plain_calls() as plain:
                ps, pm = rnd(state, bank.arrays, 0)
        check(all(v > 0 for v in plain.values()),
              f"the plain round did not run the plain versions: {plain}")
        torch.cuda.synchronize()
        out[opt_name] = round_exactness(ks, km, ps, pm, state)
    r = out["sgd"]
    check(exact_enough(r), f"{name} f32 (sgd): kernels vs plain {r}")
    log(f"{name}: {n_layers}-layer f32 {small.name} round (2 clusters, 3 "
        f"steps, sgd 0.1 momentum 0.9): kernels vs plain adapters "
        f"max_abs_err {r['adapters_max_abs_err']:.3e}, losses "
        f"{r['loss_max_abs_err']:.3e} (tol 1e-4); largest per-leaf update "
        f"difference {r['update_max_rel_err']:.3e} of the leaf's largest "
        f"update (tol 1e-3; largest update {r['update_max']:.3e}); the same "
        f"round with adamw 5e-3 (recorded): {out['adamw']}")
    del state, ks, ps
    torch.cuda.empty_cache()
    return dict(out, tol=1e-4, update_rel_tol=1e-3)


# ---------------------------------------------------------------------------
# phase 15: the paper's loop
# ---------------------------------------------------------------------------

def paper_loop(seed: int) -> dict:
    """``IntegratedRuntime`` on vit-edge at its configured size, with
    ``examples/integrated_runtime.py``'s tasks and demand, the default MLCP
    policy and paged produce rounds."""
    import tempfile

    from repro_torch.configs.base import get_config
    from repro_torch.core.integrated import IntegratedRuntime
    from repro_torch.core.paged import PagedSpec
    from repro_torch.data.synthetic import ClassificationTask
    from repro_torch.kernels import ops

    cfg = get_config("vit-edge")
    check((cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.peft.head_dim_out,
           cfg.dtype) == (12, 768, 1000, 5, "bfloat16"),
          "vit-edge is not at its configured size")
    tasks = {"nlp": ClassificationTask(5, 64, 48, class_strength=0.6, seed=0),
             "cv": ClassificationTask(5, 64, 48, class_strength=0.6, seed=7)}
    kw = dict(n_clusters=2, steps_per_upgrade=20, batch=16, sync_every=5,
              serve_batch=64, serve_gen=4, serve_slots=16, seed=seed,
              paged=PagedSpec(n_blocks=128, block_size=16), device="cuda")
    t0 = time.perf_counter()
    rt = IntegratedRuntime(cfg, tasks, **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cold = {n: d.accuracy for n, d in rt.domains.items()}
    demand = ["nlp"] * 2 + ["cv"] + ["nlp"] * 7

    per_round: list[dict] = []

    def counted(fn):
        def call(*a):
            before = ops.launch_counts()
            out = fn(*a)
            after = ops.launch_counts()
            per_round.append({k: after[k] - before[k] for k in after})
            return out
        return call

    rt.produce, rt.upgrade = counted(rt.produce), counted(rt.upgrade)
    with plain_calls(serving=True) as plain:
        t0 = time.perf_counter()
        recs = rt.run(demand)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(len(recs) == len(demand) and len(per_round) == len(demand),
          f"loop: {len(recs)} rounds recorded of {len(demand)}")
    acts = [r.action for r in recs]
    check("upgrade" in acts and "produce" in acts,
          f"loop: the policy ran only {set(acts)}")
    check(all(v == 0 for v in plain.values()),
          f"loop: a plain version ran on the card: {plain}")
    rows = []
    for r, n in zip(recs, per_round):
        if r.action == "produce":
            check(all(n[k] > 0 for k in ("flash_decode_paged",
                                         "lora_bgmv_rows", "lora_bgmv_seq"))
                  and n["flash_decode"] == 0 and n["lora_matmul"] == 0,
                  f"loop: produce round {r.round} launches {n}")
            rate = f"{r.cost.tok_per_s:.2f} tok/s"
        else:
            check(n["lora_matmul_bwd"] > 0,
                  f"loop: upgrade round {r.round} launches {n}")
            rate = f"{r.cost.ex_per_s:.2f} ex/s"
        rows.append(dict(round=r.round, action=r.action, domain=r.domain,
                         profit=r.profit, accuracy=r.accuracy,
                         latency_s=r.cost.latency_s,
                         tok_per_s=r.cost.tok_per_s,
                         ex_per_s=r.cost.ex_per_s, tokens=r.cost.tokens,
                         examples=r.cost.examples, launches=n))
        log(f"loop: round {r.round:2d} {r.action:8s} {r.domain:4s} profit "
            f"{r.profit:+7.2f} accuracy {r.accuracy:.4f} "
            f"{r.cost.latency_s:.3f}s {rate}")
    ups = {n: acts_n for n, acts_n in
           ((n, sum(1 for r in recs if r.action == "upgrade"
                    and r.domain == n)) for n in rt.domains)}
    check(rt.publish_rejects == 0
          and all(rt.versions_of(n) == ups[n] for n in rt.domains),
          f"loop: bank versions {[rt.versions_of(n) for n in rt.domains]} "
          f"after upgrades {ups}")
    for n, u in ups.items():
        if u:
            check(rt.domains[n].accuracy >= cold[n] - 0.05,
                  f"loop: {n} accuracy {rt.domains[n].accuracy} below its "
                  f"cold start {cold[n]}")
    log(f"loop: vit-edge 10 rounds in {wall:.3f}s (runtime built in "
        f"{build_s:.1f}s), total profit {rt.total_profit():.2f}; cold "
        f"accuracy {cold}, final "
        f"{ {n: d.accuracy for n, d in rt.domains.items()} }, upgrades "
        f"{ups}")

    # save, restore into a fresh runtime, and continue both by one round
    with tempfile.TemporaryDirectory() as tmp:
        nbytes = rt.save(f"{tmp}/rt.npz")
        fresh = IntegratedRuntime(cfg, tasks, **kw)
        fresh.restore(f"{tmp}/rt.npz")
    for n, d in rt.domains.items():
        f = fresh.domains[n]
        check((f.level, int(f.step), fresh.versions_of(n),
               fresh._banks[n].offset)
              == (d.level, int(d.step), rt.versions_of(n),
                  rt._banks[n].offset)
              and all(torch.equal(a, b) for a, b in zip(
                  _leaves([f.adapters_c, f.opt_state]),
                  _leaves([d.adapters_c, d.opt_state]))),
              f"loop: restored {n} differs from the saved runtime")
    rt.upgrade("cv")
    fresh.upgrade("cv")
    d, f = rt.domains["cv"], fresh.domains["cv"]
    diff = max((a.float() - b.float()).abs().max().item()
               for a, b in zip(_leaves(f.adapters_c), _leaves(d.adapters_c)))
    check(int(f.step) == int(d.step) and f.level == d.level
          and fresh.versions_of("cv") == rt.versions_of("cv")
          and diff <= TOL[torch.bfloat16],
          f"loop: the restored runtime did not continue: step "
          f"{int(f.step)} vs {int(d.step)}, adapters differ by {diff}")
    log(f"loop: save ({nbytes} bytes) and restore into a fresh runtime: "
        f"state equal; one more upgrade each: step {int(d.step)}, version "
        f"{rt.versions_of('cv')}, adapters differ by {diff:.3e}")
    del rt, fresh
    torch.cuda.empty_cache()
    no_pad_copies("phase 15")
    return dict(config=f"vit-edge {cfg.n_layers} layers d {cfg.d_model} "
                       f"{cfg.dtype}", wall_s=wall, build_s=build_s,
                rounds=rows, total_profit=recs[-1].cumulative,
                cold_accuracy=cold, upgrades=ups, checkpoint_bytes=nbytes,
                resumed_adapters_max_abs_diff=diff)


# ---------------------------------------------------------------------------
# phases 16 to 20: the ssm family and speculative decoding
# ---------------------------------------------------------------------------

def scan_kernel_cases(gen: torch.Generator, timer: Timer,
                      cases: dict) -> None:
    """Phase 16: selective_scan at falcon-mamba-7b's prefill shape and at a
    one-row refill against its plain version, an odd shape, and the ragged
    bit-for-bit case (into ``cases``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import selective_scan as ss

    cfg = get_config("falcon-mamba-7b")
    dr, N = cfg.dt_rank, cfg.ssm.d_state
    cases["selective_scan"] = []

    def operands(B, S, Di, dtype, with_h0):
        def rn(*shape, s=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * s
        x = rn(B, S, Di, s=0.5).to(dtype)
        dt = (F.softplus(rn(B, S, Di)) * 0.1).to(dtype)
        A = -torch.exp(rn(Di, N, s=0.3))
        xdbc = rn(B, S, dr + 2 * N, s=0.5).to(dtype)  # the x_proj output
        D = rn(Di)
        h0 = rn(B, Di, N, s=0.1) if with_h0 else None
        return [x, dt, A, xdbc[..., dr:dr + N], xdbc[..., dr + N:], D, h0]

    def one(B, S, Di, dtype, with_h0, timed):
        args = operands(B, S, Di, dtype, with_h0)
        label = (f"B={B} S={S} Di={Di} N={N} "
                 f"{'h0 per row' if with_h0 else 'no h0'} "
                 f"{str(dtype)[6:]}")
        y, h = ss.selective_scan(*args)
        yw, hw = ss.selective_scan(*args, backend="torch")
        torch.cuda.synchronize()
        err = compare(f"selective_scan {label}", y, yw, dtype)
        herr = (h - hw).abs().max().item()
        check(bool(torch.allclose(h, hw, atol=1e-3, rtol=1e-3)),
              f"selective_scan {label}: h_final max_abs_err {herr} beyond "
              f"the scan tolerance 1e-3")
        c = dict(shape=label + ", B and C strided views", max_abs_err=err,
                 tol=TOL[dtype], h_final_max_abs_err=herr, h_final_tol=1e-3,
                 path="a channel's states over 4 warps, ex2.approx, 16-step "
                      "tiles through a 4-stage cp.async ring")
        if timed:
            kc = kernel_costs("selective_scan", dtype, B=B, S=S, Di=Di, N=N,
                              h0=with_h0)
            t = kc.terms()
            c.update(
                ms=timer(lambda: ss.selective_scan(*args)),
                plain_ms=timer(lambda: ss.selective_scan(
                    *args, backend="torch")),
                library_ms=None,
                library="none: no single PyTorch call computes a "
                        "selective scan",
                bound_ms=kc.bound()[0], bound_by=kc.bound()[1],
                bytes_ms=t["bytes"], exp_ms=t["exp"], flops_ms=t["flops"])
        cases["selective_scan"].append(c)
        log(f"kernel selective_scan {c}")

    for dtype in (torch.bfloat16, torch.float32):
        for with_h0 in (True, False):
            one(8, 512, cfg.d_inner, dtype, with_h0, True)
    one(1, 512, cfg.d_inner, torch.bfloat16, True, True)   # a one-row refill
    for dtype in (torch.bfloat16, torch.float32):
        one(3, 37, 200, dtype, True, False)

    # ragged: right-padded rows with dt = 0 end in their solo state
    x, dt, A, Bm, C, D, h0 = operands(8, 512, cfg.d_inner, torch.bfloat16,
                                      True)
    lens = [512, 37, 200, 511, 1, 256, 300, 129]
    dtp = dt.clone()
    for b, n in enumerate(lens):
        dtp[b, n:] = 0
    _, h = ss.selective_scan(x, dtp, A, Bm, C, D, h0)
    same = []
    for b, n in enumerate(lens):
        _, hb = ss.selective_scan(x[b:b + 1, :n].contiguous(),
                                  dt[b:b + 1, :n].contiguous(), A,
                                  Bm[b:b + 1, :n], C[b:b + 1, :n], D,
                                  h0[b:b + 1])
        same.append(bool(torch.equal(h[b], hb[0])))
    check(all(same), f"selective_scan ragged: padded rows' final state "
                     f"bit-equal to the solo rows' {same}")
    cases["selective_scan"][0]["ragged_rows_bit_equal"] = same
    log(f"kernel selective_scan ragged B=8 lens {lens}: h_final of each "
        f"padded row == its solo run, bit for bit")


def mamba_domains(cfg, seed: int) -> dict:
    """N_DOMAINS ssm adapter sets that differ in their state prompts alone
    (seeded, drawn large: with random weights a step scales the state by
    about exp(dt A) ~ 0.03, so a prompt acts on a sequence's first
    tokens)."""
    from repro_torch.models.model import adapter_spec
    from repro_torch.models.params import init_from_spec
    out = {}
    for i in range(N_DOMAINS):
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + i)
        ad = init_from_spec(g, adapter_spec(cfg), torch.device("cuda"))
        for layer in ad["stack"]["g0"]:
            s0 = layer["s0"]["state0"]
            layer["s0"]["state0"] = torch.randn(
                s0.shape, generator=g, device="cuda") * 5.0
        out[f"domain{i}"] = ad
    return out


def ssm_launches_ok(cfg, launches, stats, what) -> None:
    check(launches["selective_scan"] == cfg.n_layers * stats.waves
          and all(launches[k] == 0 for k in NOT_SSM),
          f"{what}: selective_scan must launch {cfg.n_layers} times per "
          f"prefill or refill ({stats.waves}) and no attention or LoRA "
          f"kernel: {launches}")


def mamba_path(seed: int) -> tuple[dict, dict]:
    """Phase 17: falcon-mamba-7b at its published size, single-tenant and
    from a 4-domain bank of state prompts."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.adapter_bank import AdapterBank
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    cfg = get_config("falcon-mamba-7b")
    check((cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm.d_state,
           cfg.ssm.d_conv, cfg.dt_rank, cfg.vocab_size, cfg.tie_embeddings,
           cfg.dtype) == (64, 4096, 8192, 16, 4, 256, 65024, False,
                          "bfloat16"),
          "falcon-mamba-7b is not at its published size")
    t0 = time.perf_counter()
    params = M.init(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params["backbone"]))
    check(n_params == cfg.param_count() + cfg.n_layers * cfg.d_inner,
          f"falcon-mamba-7b: {n_params} backbone params, param_count "
          f"{cfg.param_count()} + conv biases")
    log(f"mamba: falcon-mamba-7b init {n_params / 1e9:.3f} B params "
        f"(param_count {cfg.param_count()} + {cfg.n_layers * cfg.d_inner} "
        f"conv biases) in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(seed)
    reqs = queue(rng, 16, (32, 513), (16, 65), cfg.vocab_size)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with plain_calls(serving=True) as plain:
        comps, stats = drain(cfg, params, reqs, slots=8)
    launches = ops.launch_counts()
    rec = drain_record(stats, launches, torch.cuda.max_memory_allocated())
    served_ok(cfg, comps, reqs, "mamba")
    ssm_launches_ok(cfg, launches, stats, "mamba")
    check(all(v == 0 for v in plain.values()),
          f"mamba: a plain version ran on the card: {plain}")
    check(stats.waves > 1, "mamba: no in-wave refill happened")
    log(f"mamba: {drain_line(rec)}")

    # one prompt's prefill logits through the kernel against the plain
    # scan, recorded: in bf16 this random 64-layer stack amplifies a
    # one-ulp difference (two plain scans that differ only in rounding
    # order drift as far, scripts/ssm_divergence.py); the check is made
    # in f32 at full depth below
    toks = torch.as_tensor(reqs[0][0][None, :128], device="cuda")
    kl, _ = M.prefill(params, {"tokens": toks}, cfg)
    with ops.backend("torch"):
        pl, _ = M.prefill(params, {"tokens": toks}, cfg)
    cos = F.cosine_similarity(kl.flatten(), pl.flatten(), dim=0).item()
    check(bool(torch.isfinite(kl).all()),
          "mamba: full-size prefill logits not finite")
    log(f"mamba: full-size bf16 prefill logits (128 tokens) kernel vs "
        f"plain, recorded: cosine {cos:.6f}, top-1 {int(kl.argmax())} vs "
        f"{int(pl.argmax())}")
    rec["bf16_prefill_logits_cosine"] = cos

    bank = AdapterBank.create(mamba_domains(cfg, seed + 1))
    sp = bank.serving_params(params["backbone"])
    doms = [bank.domains[int(i)]
            for i in np.random.default_rng(seed + 10).integers(
                0, N_DOMAINS, len(reqs))]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    bcomps, bstats = drain(cfg, sp, reqs, slots=8, bank=bank, domains=doms)
    bl = ops.launch_counts()
    brec = drain_record(bstats, bl, torch.cuda.max_memory_allocated())
    served_ok(cfg, bcomps, reqs, "mamba bank")
    ssm_launches_ok(cfg, bl, bstats, "mamba bank")
    log(f"mamba bank: {N_DOMAINS} domains of state prompts, mix "
        f"{[doms.count(d) for d in bank.domains]}: {drain_line(brec)}")

    # one short prompt per domain in one mixed prefill (the state prompt
    # acts on the first tokens) against each domain's own single-tenant
    # prefill of the same batch (the same shapes, so bf16 rounds alike)
    ptoks = torch.as_tensor(np.random.default_rng(seed + 11).integers(
        0, cfg.vocab_size, (N_DOMAINS, 4)), device="cuda")
    ids = bank.adapter_ids(bank.domains)
    mixed, _ = M.prefill(sp, {"tokens": ptoks}, cfg, adapter_ids=ids)
    coss, tops = [], []
    for i, d in enumerate(bank.domains):
        one, _ = M.prefill({"backbone": params["backbone"],
                            "adapters": bank.snapshot(d)},
                           {"tokens": ptoks}, cfg)
        coss.append(F.cosine_similarity(mixed[i].flatten(),
                                        one[i].flatten(), dim=0).item())
        tops.append((int(mixed[i].argmax()), int(one[i].argmax())))
        check(bool(torch.isfinite(mixed[i]).all()) and coss[-1] > 0.999
              and tops[-1][0] == tops[-1][1],
              f"mamba bank: mixed vs {d} prefill cosine {coss[-1]}, top-1 "
              f"{tops[-1]}")
    out = M.generate(sp, cfg, ptoks[:1, :1].expand(N_DOMAINS, 1), gen=8,
                     adapter_ids=ids).cpu().numpy()
    distinct = len({tuple(r) for r in out})
    check(distinct >= 2, f"mamba bank: all {N_DOMAINS} domains gave the "
                         f"same tokens {out[0]}")
    log(f"mamba bank: mixed vs per-domain prefill cosine "
        f"{['%.6f' % c for c in coss]}, top-1 {tops}; one 1-token prompt "
        f"through {N_DOMAINS} domains: {distinct} distinct token rows")
    brec.update(mixed_prefill_cosine=coss, distinct_domain_rows=distinct)
    rec["config"] = (f"falcon-mamba-7b {cfg.n_layers} layers d "
                     f"{cfg.d_model} d_inner {cfg.d_inner} {cfg.dtype}, "
                     f"{n_params} params")
    del params, bank, sp
    torch.cuda.empty_cache()

    # full depth in f32: the same prompt's logits through the kernel and
    # through the plain scan
    cfg32 = cfg.with_(dtype="float32")
    params = M.init(cfg32, seed, device="cuda")
    kl, _ = M.prefill(params, {"tokens": toks}, cfg32)
    with ops.backend("torch"):
        pl, _ = M.prefill(params, {"tokens": toks}, cfg32)
    cos = F.cosine_similarity(kl.flatten(), pl.flatten(), dim=0).item()
    err = (kl - pl).abs().max().item()
    check(bool(torch.isfinite(kl).all()) and cos > 0.9999
          and int(kl.argmax()) == int(pl.argmax()),
          f"mamba: f32 full-depth prefill logits kernel vs plain cosine {cos}"
          f", top-1 {int(kl.argmax())} vs {int(pl.argmax())}")
    log(f"mamba: f32 {cfg32.n_layers}-layer prefill logits (128 tokens) "
        f"kernel vs plain: "
        f"cosine {cos:.8f}, max_abs_err {err:.4e}, top-1 {int(kl.argmax())}"
        f" == {int(pl.argmax())}")
    rec.update(f32_prefill_logits_cosine=cos, f32_prefill_max_abs_err=err)
    del params
    torch.cuda.empty_cache()
    no_pad_copies("phase 17")
    return rec, brec


def mamba_exactness(seed: int) -> dict:
    """Phase 18 (and the ssm half of phase 20): a 2-layer full-width f32
    falcon-mamba-7b."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.adapter_bank import AdapterBank
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    cfg = get_config("falcon-mamba-7b").with_(n_layers=2, dtype="float32")
    params = M.init(cfg, seed, device="cuda")
    reqs = queue(np.random.default_rng(seed + 1), 8, (32, 513), (4, 17),
                 cfg.vocab_size)
    ops.reset_launch_counts()
    kern, st = drain(cfg, params, reqs, slots=4)
    ssm_launches_ok(cfg, ops.launch_counts(), st, "mamba e2e")
    with ops.backend("torch"):
        plain, _ = drain(cfg, params, reqs, slots=4)
    for a, b in zip(kern, plain):
        check(np.array_equal(a.tokens, b.tokens),
              f"mamba e2e f32: request {a.uid} kernel {a.tokens} vs plain "
              f"{b.tokens}")
    for (p, g), c in zip(reqs, kern):
        solo = M.generate(params, cfg, torch.as_tensor(p[None],
                                                       device="cuda"),
                          gen=g)[0].cpu().numpy()
        check(np.array_equal(solo, c.tokens),
              f"mamba e2e f32: request {c.uid} drain {c.tokens} vs solo "
              f"{solo}")
    log(f"mamba e2e: 2-layer f32 falcon-mamba-7b, {len(reqs)} requests, "
        f"{st.waves} waves: kernel tokens == plain tokens == solo rows")

    bank = AdapterBank.create(mamba_domains(cfg, seed + 2))
    sp = bank.serving_params(params["backbone"])
    rng = np.random.default_rng(seed + 3)
    breqs = queue(rng, 8, (2, 40), (4, 17), cfg.vocab_size)
    doms = [bank.domains[int(i)] for i in rng.integers(0, N_DOMAINS, 8)]
    bk, bst = drain(cfg, sp, breqs, slots=4, bank=bank, domains=doms)
    for d in sorted(set(doms)):
        idx = [i for i, x in enumerate(doms) if x == d]
        one, _ = drain(cfg, {"backbone": params["backbone"],
                             "adapters": bank.snapshot(d)},
                       [breqs[i] for i in idx], slots=4)
        for i, c in zip(idx, one):
            check(np.array_equal(bk[i].tokens, c.tokens),
                  f"mamba e2e bank: request {i} ({d}) mixed {bk[i].tokens} "
                  f"vs per-domain {c.tokens}")
    log(f"mamba e2e: 2-layer f32 bank of {N_DOMAINS} state-prompt domains, "
        f"{len(breqs)} requests, {bst.waves} waves: mixed tokens == "
        f"per-domain drains")
    spec = spec_exactness("mamba e2e", cfg, params, seed)

    # the target as its own drafter accepts every draft (budgets a whole
    # number of k+1 chunks)
    from repro_torch.core.spec_decode import SpecDecoder, spec_generate
    k = 4
    toks = torch.as_tensor(np.random.default_rng(seed + 4).integers(
        0, cfg.vocab_size, (4, 64)), device="cuda")
    lens = torch.tensor([64, 17, 40, 3], device="cuda")
    out, sstats = spec_generate(params, cfg, SpecDecoder(cfg, params, k=k),
                                toks, gen=2 * (k + 1), prompt_lens=lens)
    want = M.generate(params, cfg, toks, gen=2 * (k + 1), prompt_lens=lens)
    check(torch.equal(out, want.to(out.dtype)),
          "mamba e2e: self-drafted tokens differ from generate")
    check(sstats.drafted > 0 and sstats.acceptance_rate == 1.0,
          f"mamba e2e: the target as its own drafter accepted "
          f"{sstats.accepted} of {sstats.drafted}")
    log(f"mamba e2e: falcon-mamba-7b as its own drafter (k {k}): "
        f"{sstats.accepted}/{sstats.drafted} accepted, tokens == generate")
    del params, bank, sp
    torch.cuda.empty_cache()
    return dict(requests=len(reqs), waves=st.waves, tokens_equal=True,
                bank_requests=len(breqs), bank_waves=bst.waves, spec=spec,
                self_draft=dict(drafted=sstats.drafted,
                                accepted=sstats.accepted,
                                acceptance_rate=sstats.acceptance_rate))


def spec_exactness(what: str, cfg, params, seed: int) -> dict:
    """Phase 20: a spec drain of a ragged queue, every third request opted
    out of drafting, against the plain drain, token for token."""
    from repro_torch.core.spec_decode import SpecDecoder
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import DecodeEngine

    reqs = queue(np.random.default_rng(seed + 5), 8, (32, 513), (4, 17),
                 cfg.vocab_size)
    spec = SpecDecoder.init(cfg, seed + 997, device="cuda", k=4)
    eng = DecodeEngine(cfg, slots=4, spec=spec, device="cuda")
    flags = [i % 3 != 1 for i in range(len(reqs))]
    uids = [eng.submit(p, g, speculative=f)
            for (p, g), f in zip(reqs, flags)]
    ops.reset_launch_counts()
    comps, st = eng.run(params)
    n = ops.launch_counts()
    by = {c.uid: c.tokens for c in comps}
    plain, _ = drain(cfg, params, reqs, slots=4)
    for u, c in zip(uids, plain):
        check(np.array_equal(by[u], c.tokens),
              f"{what} spec: request {u} spec {by[u]} vs plain {c.tokens}")
    check(st.drafted > 0 and n["selective_scan"] > 0
          and n["flash_decode"] == 0,
          f"{what} spec: drafted {st.drafted}, launches {n}")
    log(f"{what} spec: {cfg.name} {cfg.n_layers} layers f32, {len(reqs)} "
        f"requests ({flags.count(False)} opted out), k 4: spec tokens == "
        f"plain tokens; drafted {st.drafted}, accepted {st.accepted}")
    return dict(requests=len(reqs), drafted=st.drafted,
                accepted=st.accepted, tokens_equal=True)


def spec_path(cfg, params, reqs, plain_comps, plain_rec, seed: int) -> dict:
    """Phase 19: phase 4's qwen2-7b and queue served speculatively with the
    default recurrent drafter, k = 4."""
    from repro_torch.core.spec_decode import SpecDecoder
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import DecodeEngine

    spec = SpecDecoder.init(cfg, seed + 997, device="cuda", k=4)
    dcfg = spec.cfg
    check((dcfg.family, dcfg.d_model, dcfg.n_layers, dcfg.vocab_size) ==
          ("ssm", 64, 2, cfg.vocab_size), f"spec: drafter {dcfg}")
    eng = DecodeEngine(cfg, slots=8, spec=spec, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with plain_calls(serving=True) as plain:
        comps, stats = serve_on(eng, params, reqs)
    launches = ops.launch_counts()
    rec = drain_record(stats, launches, torch.cuda.max_memory_allocated())
    served_ok(cfg, comps, reqs, "spec")
    check(launches["selective_scan"] > 0 and launches["flash_decode"] == 0
          and launches["lora_matmul"] > 0
          and launches["flash_attention"] > 0,
          f"spec: launches {launches}")
    check(all(v == 0 for v in plain.values()),
          f"spec: a plain version ran on the card: {plain}")
    same = sum(np.array_equal(a.tokens, b.tokens)
               for a, b in zip(comps, plain_comps))
    rec.update(drafted=stats.drafted, accepted=stats.accepted,
               acceptance_rate=stats.acceptance_rate,
               same_tokens_as_plain=same)
    log(f"spec: qwen2-7b + drafter ssm d 64 x 2 layers, k 4: "
        f"{drain_line(rec)}; drafted {stats.drafted}, accepted "
        f"{stats.accepted} (rate {stats.acceptance_rate:.4f}); {same}/"
        f"{len(reqs)} requests gave phase 4's tokens; plain drain "
        f"{plain_rec['tok_per_s']:.2f} tok/s")
    return rec


def spec_loop(seed: int) -> dict:
    """Phase 20: the vit-edge loop of phase 15 with speculative produce
    rounds (``spec_k=4``; dense caches, as spec excludes paged)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.integrated import IntegratedRuntime
    from repro_torch.data.synthetic import ClassificationTask
    from repro_torch.kernels import ops

    cfg = get_config("vit-edge")
    tasks = {"nlp": ClassificationTask(5, 64, 48, class_strength=0.6, seed=0),
             "cv": ClassificationTask(5, 64, 48, class_strength=0.6, seed=7)}
    rt = IntegratedRuntime(cfg, tasks, n_clusters=2, steps_per_upgrade=20,
                           batch=16, sync_every=5, serve_batch=64,
                           serve_gen=4, serve_slots=16, seed=seed, spec_k=4,
                           device="cuda")
    demand = ["nlp"] * 2 + ["cv"] + ["nlp"] * 7
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    recs = rt.run(demand)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = ops.launch_counts()
    acts = [(r.action, r.domain) for r in recs]
    prod = [r for r in recs if r.action == "produce"]
    check(len(recs) == len(demand) and prod
          and all(r.cost.drafted_tokens > 0 for r in prod)
          and n["selective_scan"] > 0 and n["flash_decode"] == 0,
          f"spec loop: rounds {acts}, launches {n}")
    drafted = sum(r.cost.drafted_tokens for r in prod)
    accepted = sum(r.cost.accepted_tokens for r in prod)
    log(f"spec loop: vit-edge, spec_k 4, 10 rounds in {wall:.3f}s: "
        f"{acts}; drafted {drafted}, accepted {accepted}, total profit "
        f"{rt.total_profit():.2f}")
    del rt
    torch.cuda.empty_cache()
    return dict(wall_s=wall, actions=acts, drafted=drafted,
                accepted=accepted, total_profit=recs[-1].cumulative,
                rounds=[dict(round=r.round, action=r.action,
                             domain=r.domain, profit=r.profit,
                             latency_s=r.cost.latency_s,
                             tok_per_s=r.cost.tok_per_s,
                             drafted=r.cost.drafted_tokens,
                             accepted=r.cost.accepted_tokens)
                        for r in recs])


# ---------------------------------------------------------------------------
# phases 21 to 24: the hybrid family (recurrentgemma-2b)
# ---------------------------------------------------------------------------

def lru_kernel_cases(gen: torch.Generator, timer: Timer,
                     cases: dict) -> None:
    """Phase 21: rglru_scan at recurrentgemma-2b's prefill shape (B 8, S
    512, W 2560) and at a one-row refill against its plain version, a
    shared (W,) initial state, an odd shape, and the ragged bit-for-bit
    case (into ``cases``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import rglru_scan as rg

    W = get_config("recurrentgemma-2b").lru_width
    cases["rglru_scan"] = []

    def operands(B, S, W, dtype, h0_kind):
        def rn(*shape, s=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * s
        x = rn(B, S, W, s=0.5).to(dtype)
        r, i = rn(B, S, W).to(dtype), rn(B, S, W).to(dtype)
        a = rn(W)
        h0 = {"none": None, "per row": rn(B, W, s=0.1),
              "shared (W,)": rn(W, s=0.1)}[h0_kind]
        return [x, r, i, a, h0]

    def one(B, S, W, dtype, h0_kind, timed):
        args = operands(B, S, W, dtype, h0_kind)
        label = f"B={B} S={S} W={W} h0 {h0_kind} {str(dtype)[6:]}"
        hs, hT = rg.rglru(*args)
        p = rg.last_plan                  # the plan that launch ran
        hsw, hTw = rg.rglru(*args, backend="torch")
        torch.cuda.synchronize()
        err = compare(f"rglru_scan {label}", hs, hsw, dtype)
        herr = (hT - hTw).abs().max().item()
        check(bool(torch.allclose(hT, hTw, atol=1e-3, rtol=1e-3)),
              f"rglru_scan {label}: h_final max_abs_err {herr} beyond the "
              f"scan tolerance 1e-3")
        c = dict(shape=label, max_abs_err=err, tol=TOL[dtype],
                 h_final_max_abs_err=herr, h_final_tol=1e-3,
                 plan=f"{p['warps']} warps, {p['tile']}-step tiles "
                      f"{p['ahead']} ahead, {p['blocks']} blocks, "
                      f"{p['route']}")
        if timed:
            kc = kernel_costs("rglru_scan", dtype, B=B, S=S, W=W,
                              h0=h0_kind != "none")
            t = kc.terms()
            # the serial chain: S dependent FMUL + FADD, 4 clocks each
            t_c = S * 8 / SM_CLOCK
            c.update(
                ms=timer(lambda: rg.rglru(*args)),
                plain_ms=timer(lambda: rg.rglru(*args, backend="torch")),
                library_ms=None,
                library="none: no single PyTorch call computes an RG-LRU "
                        "scan",
                bound_ms=kc.bound()[0], bound_by=kc.bound()[1],
                bytes_ms=t["bytes"], mufu_ms=t["exp"], flops_ms=t["flops"],
                chain_ms=t_c * 1e3)
        cases["rglru_scan"].append(c)
        log(f"kernel rglru_scan {c}")

    for dtype in (torch.bfloat16, torch.float32):
        for h0_kind in ("per row", "none"):
            one(8, 512, W, dtype, h0_kind, True)
    one(1, 512, W, torch.bfloat16, "per row", True)   # a one-row refill
    one(8, 512, W, torch.bfloat16, "shared (W,)", False)
    for dtype in (torch.bfloat16, torch.float32):
        one(3, 37, 200, dtype, "per row", False)

    # ragged: right-padded rows with r = -1e9 end in their solo state
    x, r, i, a, h0 = operands(8, 512, W, torch.bfloat16, "per row")
    lens = [512, 37, 200, 511, 1, 256, 300, 129]
    rp = r.clone()
    for b, n in enumerate(lens):
        rp[b, n:] = -1e9
    _, h = rg.rglru(x, rp, i, a, h0)
    same = []
    for b, n in enumerate(lens):
        _, hb = rg.rglru(x[b:b + 1, :n].contiguous(),
                         r[b:b + 1, :n].contiguous(),
                         i[b:b + 1, :n].contiguous(), a, h0[b:b + 1])
        same.append(bool(torch.equal(h[b], hb[0])))
    check(all(same), f"rglru_scan ragged: padded rows' final state "
                     f"bit-equal to the solo rows' {same}")
    cases["rglru_scan"][0]["ragged_rows_bit_equal"] = same
    log(f"kernel rglru_scan ragged B=8 lens {lens}: h_final of each padded "
        f"row == its solo run, bit for bit")


def attn256_cases(gen: torch.Generator, timer: Timer, cases: dict) -> None:
    """Phase 22: the head-dim-256 instances of flash_attention and
    flash_decode at recurrentgemma-2b's shapes (10 query heads over 1 KV
    head, window 2048, 16 prefix slots) against their plain versions,
    timed beside phase 3's head-dim-128 rows (into ``cases``)."""
    from repro_torch.configs.base import get_config

    cfg = get_config("recurrentgemma-2b")
    B, S, n_p = 8, 512, 16
    Hq, Hkv, D, win = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, \
        cfg.hybrid.window

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for dtype in (torch.bfloat16, torch.float32):
        attn_case(cases, randn, timer, B, S, n_p, Hq, Hkv, D, dtype,
                  label=f"window={win}", window=win)

    # decode: the 2048-slot rolling buffer of a windowed layer in its
    # steady state (every row at or past the window, most wrapped, so
    # every slot is written and visible), a 16-slot prefix bank, per-row
    # positions
    Tc = win
    for dtype in (torch.bfloat16, torch.float32):
        q = randn(B, Hq, D, dtype=dtype)
        kc, vc = randn(B, Tc, Hkv, D, dtype=dtype), randn(B, Tc, Hkv, D,
                                                          dtype=dtype)
        pk, pv = randn(n_p, Hkv, D, dtype=dtype), randn(n_p, Hkv, D,
                                                        dtype=dtype)
        qp = torch.randint(Tc - 1, 2 * Tc, (B,), generator=gen,
                           device="cuda", dtype=torch.int32)
        slots = torch.arange(Tc, dtype=torch.int32, device="cuda")[None]
        # the absolute position each slot holds: the newest p <= q_pos
        # with p % Tc == slot
        held = slots + torch.div(qp[:, None] - slots, Tc,
                                 rounding_mode="floor") * Tc
        decode_case(cases, timer, q, kc, vc, qp,
                    held.to(torch.int32).contiguous(), pk, pv, win,
                    f"B={B} T={Tc}+{n_p} prefix, all visible, Hq={Hq} "
                    f"Hkv={Hkv} D={D} window={win} per-row q_pos")
        check(cases["flash_decode"][-1]["visible_keys"] == B * (n_p + Tc),
              "flash_decode D 256: every slot of the steady-state window "
              "must be visible")


def hybrid_domains(cfg, seed: int) -> dict:
    """N_DOMAINS hybrid adapter sets that differ in prefix slots, LoRA (a
    and a seeded nonzero b) and state prompts (seeded, drawn large, as
    mamba_domains draws them)."""
    from repro_torch.models.model import adapter_spec
    from repro_torch.models.params import init_from_spec
    out = {}
    for i in range(N_DOMAINS):
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + i)
        ad = init_from_spec(g, adapter_spec(cfg), torch.device("cuda"))
        for grp in ad["stack"].values():
            for layer in grp:
                for sub in layer.values():
                    if "state0" in sub:
                        sub["state0"] = torch.randn(
                            sub["state0"].shape, generator=g,
                            device="cuda") * 5.0
                    for t in sub.get("lora", {}).values():
                        t["b"] = (torch.randn(t["b"].shape, generator=g,
                                              device="cuda") * 0.1
                                  ).to(t["b"].dtype)
        out[f"domain{i}"] = ad
    return out


def hybrid_launches_ok(cfg, launches, stats, what, bank: bool) -> None:
    """rglru_scan and flash_attention once per sub-layer of their kind per
    prefill or refill; decode through flash_decode; the projections
    through lora_matmul single-tenant and the multi-LoRA kernels from the
    bank; no paged or ssm kernel."""
    from repro_torch.models.transformer import groups_for
    n_rec = sum(k.count("rglru") * n for _, k, n in groups_for(cfg))
    n_attn = sum(k.count("attn") * n for _, k, n in groups_for(cfg))
    lora = ("lora_bgmv_rows", "lora_bgmv_seq") if bank else ("lora_matmul",)
    off = ("lora_matmul",) if bank else ("lora_bgmv_rows", "lora_bgmv_seq")
    check(launches["rglru_scan"] == n_rec * stats.waves
          and launches["flash_attention"] == n_attn * stats.waves
          and launches["flash_decode"] > 0
          and all(launches[k] > 0 for k in lora)
          and all(launches[k] == 0 for k in off + (
              "flash_decode_paged", "selective_scan")),
          f"{what}: rglru_scan must launch {n_rec} and flash_attention "
          f"{n_attn} times per prefill or refill ({stats.waves}): "
          f"{launches}")


def hybrid_path(seed: int) -> tuple[dict, dict]:
    """Phase 23: recurrentgemma-2b at its published size, single-tenant and
    from a 4-domain bank whose domains differ in prefix, LoRA and state
    prompts."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.adapter_bank import AdapterBank
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    cfg = get_config("recurrentgemma-2b")
    check((cfg.n_layers, cfg.d_model, cfg.lru_width, cfg.n_heads,
           cfg.n_kv_heads, cfg.head_dim_, cfg.d_ff, cfg.vocab_size,
           cfg.hybrid.window, cfg.tie_embeddings, cfg.dtype) ==
          (26, 2560, 2560, 10, 1, 256, 7680, 256000, 2048, True,
           "bfloat16"), "recurrentgemma-2b is not at its published size")
    t0 = time.perf_counter()
    params = M.init(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params["backbone"]))
    log(f"hybrid: recurrentgemma-2b init {n_params / 1e9:.3f} B params "
        f"(param_count {cfg.param_count()}) in "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(seed)
    reqs = queue(rng, 16, (32, 513), (16, 65), cfg.vocab_size)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with plain_calls(serving=True) as plain:
        comps, stats = drain(cfg, params, reqs, slots=8)
    launches = ops.launch_counts()
    rec = drain_record(stats, launches, torch.cuda.max_memory_allocated())
    served_ok(cfg, comps, reqs, "hybrid")
    hybrid_launches_ok(cfg, launches, stats, "hybrid", bank=False)
    check(all(v == 0 for v in plain.values()),
          f"hybrid: a plain version ran on the card: {plain}")
    check(stats.waves > 1, "hybrid: no in-wave refill happened")
    log(f"hybrid: {drain_line(rec)}; per-token p50 "
        f"{rec['tok_latency_p50_s'] * 1e3:.1f} ms")

    # one prompt's bf16 prefill logits through the kernels against the
    # plain versions, recorded (a random deep stack amplifies one-ulp
    # differences, as phase 17 found); the check is made in f32 below
    toks = torch.as_tensor(reqs[0][0][None, :128], device="cuda")
    kl, _ = M.prefill(params, {"tokens": toks}, cfg)
    with ops.backend("torch"):
        pl, _ = M.prefill(params, {"tokens": toks}, cfg)
    cos = F.cosine_similarity(kl.flatten(), pl.flatten(), dim=0).item()
    check(bool(torch.isfinite(kl).all()),
          "hybrid: full-size prefill logits not finite")
    log(f"hybrid: full-size bf16 prefill logits (128 tokens) kernels vs "
        f"plain, recorded: cosine {cos:.6f}, top-1 {int(kl.argmax())} vs "
        f"{int(pl.argmax())}")
    rec["bf16_prefill_logits_cosine"] = cos

    bank = AdapterBank.create(hybrid_domains(cfg, seed + 1))
    sp = bank.serving_params(params["backbone"])
    doms = [bank.domains[int(i)]
            for i in np.random.default_rng(seed + 10).integers(
                0, N_DOMAINS, len(reqs))]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with plain_calls(serving=True) as plain:
        bcomps, bstats = drain(cfg, sp, reqs, slots=8, bank=bank,
                               domains=doms)
    bl = ops.launch_counts()
    brec = drain_record(bstats, bl, torch.cuda.max_memory_allocated())
    served_ok(cfg, bcomps, reqs, "hybrid bank")
    hybrid_launches_ok(cfg, bl, bstats, "hybrid bank", bank=True)
    check(all(v == 0 for v in plain.values()),
          f"hybrid bank: a plain version ran on the card: {plain}")
    log(f"hybrid bank: {N_DOMAINS} domains (prefix, LoRA, state0), mix "
        f"{[doms.count(d) for d in bank.domains]}: {drain_line(brec)}")

    # one short prompt per domain in one mixed prefill against each
    # domain's own single-tenant prefill of the same batch
    ptoks = torch.as_tensor(np.random.default_rng(seed + 11).integers(
        0, cfg.vocab_size, (N_DOMAINS, 4)), device="cuda")
    ids = bank.adapter_ids(bank.domains)
    mixed, _ = M.prefill(sp, {"tokens": ptoks}, cfg, adapter_ids=ids)
    coss, tops = [], []
    for i, d in enumerate(bank.domains):
        one, _ = M.prefill({"backbone": params["backbone"],
                            "adapters": bank.snapshot(d)},
                           {"tokens": ptoks}, cfg)
        coss.append(F.cosine_similarity(mixed[i].flatten(),
                                        one[i].flatten(), dim=0).item())
        tops.append((int(mixed[i].argmax()), int(one[i].argmax())))
        check(bool(torch.isfinite(mixed[i]).all()) and coss[-1] > 0.999
              and tops[-1][0] == tops[-1][1],
              f"hybrid bank: mixed vs {d} prefill cosine {coss[-1]}, top-1 "
              f"{tops[-1]}")
    out = M.generate(sp, cfg, ptoks[:1, :1].expand(N_DOMAINS, 1), gen=8,
                     adapter_ids=ids).cpu().numpy()
    distinct = len({tuple(r) for r in out})
    check(distinct >= 2, f"hybrid bank: all {N_DOMAINS} domains gave the "
                         f"same tokens {out[0]}")
    log(f"hybrid bank: mixed vs per-domain prefill cosine "
        f"{['%.6f' % c for c in coss]}, top-1 {tops}; one 1-token prompt "
        f"through {N_DOMAINS} domains: {distinct} distinct token rows")
    brec.update(mixed_prefill_cosine=coss, distinct_domain_rows=distinct)
    rec["config"] = (f"recurrentgemma-2b {cfg.n_layers} layers d "
                     f"{cfg.d_model} lru {cfg.lru_width} heads {cfg.n_heads}"
                     f"/{cfg.n_kv_heads} x {cfg.head_dim_} window "
                     f"{cfg.hybrid.window} {cfg.dtype}, {n_params} params")
    del params, bank, sp
    torch.cuda.empty_cache()

    # full depth in f32: the same prompt's logits through the kernels and
    # through the plain versions
    cfg32 = cfg.with_(dtype="float32")
    params = M.init(cfg32, seed, device="cuda")
    kl, _ = M.prefill(params, {"tokens": toks}, cfg32)
    with ops.backend("torch"):
        pl, _ = M.prefill(params, {"tokens": toks}, cfg32)
    cos = F.cosine_similarity(kl.flatten(), pl.flatten(), dim=0).item()
    err = (kl - pl).abs().max().item()
    check(bool(torch.isfinite(kl).all()) and cos > 0.9999
          and int(kl.argmax()) == int(pl.argmax()),
          f"hybrid: f32 full-depth prefill logits kernels vs plain cosine "
          f"{cos}, top-1 {int(kl.argmax())} vs {int(pl.argmax())}")
    log(f"hybrid: f32 {cfg32.n_layers}-layer prefill logits (128 tokens) "
        f"kernels vs plain: cosine {cos:.8f}, max_abs_err {err:.4e}, top-1 "
        f"{int(kl.argmax())} == {int(pl.argmax())}")
    rec.update(f32_prefill_logits_cosine=cos, f32_prefill_max_abs_err=err)
    del params
    torch.cuda.empty_cache()
    no_pad_copies("phase 23")
    return rec, brec


def hybrid_exactness(seed: int) -> dict:
    """Phase 24: recurrentgemma-2b at full width in f32, 5 layers (one
    ``(rglru, rglru, attn)`` group and the ``(rglru, rglru)`` tail):
    logits (within 1e-3) and greedy tokens through the kernels against
    the plain versions and solo rows, again with the window cut to 8 so
    that the rolling buffer wraps, and a speculative drain inside the
    window against the plain drain."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.transformer import groups_for

    base = get_config("recurrentgemma-2b").with_(n_layers=5,
                                                 dtype="float32")
    check([k for _, k, _ in groups_for(base)] ==
          [("rglru", "rglru", "attn"), ("rglru", "rglru")],
          f"hybrid e2e: groups {groups_for(base)}")
    params = M.init(base, seed, device="cuda")
    out = {}
    for win in (base.hybrid.window, 8):
        cfg = base.with_(hybrid=dataclasses.replace(base.hybrid,
                                                    window=win))
        toks = torch.as_tensor(np.random.default_rng(seed + 7).integers(
            0, cfg.vocab_size, (2, 40)), device="cuda")
        kl, _ = M.prefill(params, {"tokens": toks}, cfg)
        with ops.backend("torch"):
            pl, _ = M.prefill(params, {"tokens": toks}, cfg)
        err = (kl - pl).abs().max().item()
        check(bool(torch.allclose(kl, pl, atol=1e-3, rtol=1e-3))
              and torch.equal(kl.argmax(-1), pl.argmax(-1)),
              f"hybrid e2e window {win}: prefill logits kernels vs plain "
              f"max_abs_err {err} beyond 1e-3")
        reqs = queue(np.random.default_rng(seed + 1), 8, (4, 97), (4, 33),
                     cfg.vocab_size)
        ops.reset_launch_counts()
        kern, st = drain(cfg, params, reqs, slots=4)
        hybrid_launches_ok(cfg, ops.launch_counts(), st,
                           f"hybrid e2e window {win}", bank=False)
        with ops.backend("torch"):
            plain, _ = drain(cfg, params, reqs, slots=4)
        for a, b in zip(kern, plain):
            check(np.array_equal(a.tokens, b.tokens),
                  f"hybrid e2e window {win}: request {a.uid} kernel "
                  f"{a.tokens} vs plain {b.tokens}")
        for (p, g), c in zip(reqs, kern):
            solo = M.generate(params, cfg, torch.as_tensor(
                p[None], device="cuda"), gen=g)[0].cpu().numpy()
            check(np.array_equal(solo, c.tokens),
                  f"hybrid e2e window {win}: request {c.uid} drain "
                  f"{c.tokens} vs solo {solo}")
        wraps = sum(len(p) + g > win for p, g in reqs)
        log(f"hybrid e2e: 5-layer f32 recurrentgemma-2b, window {win}: "
            f"prefill logits max_abs_err {err:.3e} (tol 1e-3), same top-1; "
            f"{len(reqs)} requests ({wraps} past the window), {st.waves} "
            f"waves: kernel tokens == plain tokens == solo rows")
        out[f"window {win}"] = dict(prefill_logits_max_abs_err=err,
                                    requests=len(reqs), past_window=wraps,
                                    waves=st.waves, tokens_equal=True)
    out["spec"] = spec_exactness("hybrid e2e", base, params, seed)
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 25 to 28: ssm and hybrid training
# ---------------------------------------------------------------------------

# the backward kernels against the plain backwards: each output within the
# dtype's tolerance of its largest value (sums over up to a few thousand
# terms in other orders; bf16 outputs rounded once)
GRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
SCAN_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
LRU_GRADS = ("dx", "dr", "di", "da_param", "dh0")


def grads_close(what: str, got, want, dtype, names) -> dict:
    """Each gradient within ``GRAD_TOL`` of its largest value, finite,
    of the plain backward's dtype and shape; returns the errors."""
    torch.cuda.synchronize()
    errs = {}
    for name, g, w in zip(names, got, want):
        if w is None:
            check(g is None, f"{what}: {name} computed though not asked")
            continue
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{what}: {name} {g.dtype} {tuple(g.shape)} vs plain "
              f"{w.dtype} {tuple(w.shape)}")
        err = (g.float() - w.float()).abs().max().item()
        tol = GRAD_TOL[dtype] * max(1.0, w.float().abs().max().item())
        check(np.isfinite(err) and err <= tol,
              f"{what}: {name} kernel vs plain max_abs_err {err} beyond "
              f"{tol}")
        errs[name] = err
    return errs


def timed(c: dict, timer: Timer, kernel: str, fn, plain, terms: dict,
          bound_kind: dict) -> None:
    """Times ``fn`` (events, and device microseconds by kernel from
    ``scripts/time_lora_kernels.py::device_us``) and ``plain`` into case
    ``c``, with the bound from ``terms`` (ms each)."""
    from scripts.time_lora_kernels import device_us
    dev = device_us(fn, timer.flush)
    k_us = sum(v for k, v in dev.items() if kernel in k)
    c.update(ms=timer(fn), plain_ms=timer(plain), library_ms=None,
             library="none: no single PyTorch call computes this VJP",
             device_us=dev, kernel_device_us=k_us or None,
             bound_ms=max(terms.values()),
             bound_by=bound_kind[max(terms, key=terms.get)],
             **{f"{k}_ms": v for k, v in terms.items()})


def fwd_times(c: dict, timer: Timer, kernel: str, plain_fwd, ck_fwd,
              terms: dict, ck_bytes: int, torch_ck_fwd) -> None:
    """The forward kernel at a backward case's shape, without and with its
    checkpoint output (events ms and device microseconds), into case
    ``c``: what storing the checkpoints costs a training forward. Each
    with its bound, from ``terms`` (ms each: the forward's rule of phase
    16 or 21) and, with the checkpoints, their ``ck_bytes`` written
    once; and the plain version's time with its checkpoints
    (``torch_ck_fwd``)."""
    from scripts.time_lora_kernels import device_us
    ck_terms = dict(terms, bytes=terms["bytes"] + ck_bytes / HBM_BW * 1e3)
    for key, fn, t in (("fwd", plain_fwd, terms),
                       ("fwd_ck", ck_fwd, ck_terms)):
        dev = device_us(fn, timer.flush)
        c[f"{key}_ms"] = timer(fn)
        c[f"{key}_device_us"] = sum(v for k, v in dev.items()
                                    if kernel in k) or None
        c[f"{key}_bound_ms"] = max(t.values())
        c[f"{key}_bound_by"] = "bytes" if t["bytes"] >= max(t.values()) \
            else "operations"
        c[f"{key}_bound_terms_ms"] = t
    c["fwd_ck_plain_ms"] = timer(torch_ck_fwd)


def scan_bwd_cases(gen: torch.Generator, timer: Timer, cases: dict) -> dict:
    """Phase 25: the two backward kernels against their plain versions at
    the HFSL rounds' shapes (falcon-mamba-7b: B 4, S 256, Di 8192, N 16;
    recurrentgemma-2b: B 4, S 256, W 2560), bf16 and f32, h0 per row /
    shared / None, fed the forward kernel's checkpoints (the forward's
    bits the same with and without them, and its time both ways); an
    odd shape; bits repeated by a second call; the kernels' recompute of
    the last chunk ending in the forward kernel's h_final bit for bit; a
    ragged row's gradients bit for bit the solo row's; the
    RG-LRU's saturated gate; the autograd Functions on the card against
    autograd through the plain versions (into ``cases``). Returns the
    record of the checks that are not cases."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import selective_scan as ss

    mcfg, hcfg = get_config("falcon-mamba-7b"), get_config("recurrentgemma-2b")
    dr, N, Di, W = mcfg.dt_rank, mcfg.ssm.d_state, mcfg.d_inner, \
        hcfg.lru_width
    rec = {}

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s

    def scan_ops(B, S, Di, dtype, h0_kind):
        x = rn(B, S, Di, s=0.5).to(dtype)
        dt = (F.softplus(rn(B, S, Di)) * 0.1).to(dtype)
        A = -torch.exp(rn(Di, N, s=0.3))
        xdbc = rn(B, S, dr + 2 * N, s=0.5).to(dtype)
        D = rn(Di)
        h0 = {"none": None, "per row": rn(B, Di, N, s=0.1),
              "shared": rn(Di, N, s=0.1).expand(B, Di, N)}[h0_kind]
        return [x, dt, A, xdbc[..., dr:dr + N], xdbc[..., dr + N:], D, h0]

    def lru_ops(B, S, W, dtype, h0_kind):
        x = rn(B, S, W, s=0.5).to(dtype)
        r, i = rn(B, S, W).to(dtype), rn(B, S, W).to(dtype)
        h0 = {"none": None, "per row": rn(B, W, s=0.1),
              "shared": rn(W, s=0.1).expand(B, W)}[h0_kind]
        return [x, r, i, rn(W), h0]

    # selective_scan_bwd
    cases["selective_scan_bwd"] = []
    for B, S, D_, dtype, h0_kind, timed_ in (
            (4, 256, Di, torch.bfloat16, "per row", True),
            (4, 256, Di, torch.bfloat16, "shared", False),
            (4, 256, Di, torch.bfloat16, "none", False),
            (4, 256, Di, torch.float32, "per row", True),
            (3, 37, 200, torch.bfloat16, "per row", False),
            (3, 37, 200, torch.float32, "shared", False)):
        args = scan_ops(B, S, D_, dtype, h0_kind)
        dy = rn(B, S, D_).to(dtype)
        # the round's call: no dh_final, dA and dD not asked (frozen);
        # the other cases with dh_final and every gradient
        full = not timed_
        dh = rn(B, D_, N) if full else None
        kw = dict(need_A=full, need_D=full)
        label = (f"B={B} S={S} Di={D_} N={N} h0 {h0_kind} "
                 f"{str(dtype)[6:]}" + ("" if full else
                                        ", no dh_final, dA/dD not asked"))
        hT = torch.empty((B, D_, N), dtype=torch.float32, device="cuda")
        # the checkpoints from the forward kernel, as autograd keeps them;
        # the forward's y and h_final keep their bits with the stores
        ck = ss.checkpoints(args[0], args[2])
        y_ck, hf_ck = ss._launch(*args, ck=ck)
        y, hf = ss._launch(*args)
        torch.cuda.synchronize()
        check(torch.equal(y_ck, y) and torch.equal(hf_ck, hf),
              f"selective_scan {label}: the forward with its checkpoint "
              "output gave other bits")
        got = ss._launch_bwd(*args, dy, dh, h_final_out=hT, ck=ck, **kw)
        want = ss.selective_scan_bwd_torch(*args, dy, dh, **kw)
        errs = grads_close(f"selective_scan_bwd {label}", got, want, dtype,
                           SCAN_GRADS)
        again = ss._launch_bwd(*args, dy, dh, ck=ck, **kw)
        torch.cuda.synchronize()
        check(all(a is None and b is None or torch.equal(a, b)
                  for a, b in zip(got, again)),
              f"selective_scan_bwd {label}: a second call gave other bits")
        check(torch.equal(hT, hf), f"selective_scan_bwd {label}: the "
              f"recompute of the last chunk ended "
              f"{(hT - hf).abs().max().item()} from the forward kernel's "
              "h_final")
        c = dict(shape=label + ", B and C strided views",
                 max_abs_err=max(errs.values()), errs=errs,
                 tol=GRAD_TOL[dtype], tol_of="each output's largest value",
                 bits_repeat=True, fwd_ck_bits_unchanged=True,
                 rerun_h_final_bit_equal=True,
                 path="the forward's blocks fed the forward kernel's "
                      "checkpoints (every 16 steps); a cp.async ring in "
                      "reverse; each chunk's states recomputed into "
                      "registers, then walked back")
        if timed_:
            h0_ = h0_kind != "none"
            # ms: the whole _launch_bwd call (outputs allocated, the
            # kernel, dB / dC summed over the blocks, casts)
            timed(c, timer, "selective_scan_bwd_kernel",
                  lambda: ss._launch_bwd(*args, dy, ck=ck, **kw),
                  lambda: ss.selective_scan_bwd_torch(*args, dy, **kw),
                  kernel_costs("selective_scan_bwd", dtype, B=B, S=S, Di=D_,
                               N=N, h0=h0_).terms(),
                  dict(bytes="bytes", exp="operations", flops="operations"))
            # the forward's terms by phase 16's rule
            fwd_times(c, timer, "selective_scan_kernel",
                      lambda: ss._launch(*args),
                      lambda: ss._launch(*args, ck=ck),
                      kernel_costs("selective_scan", dtype, B=B, S=S, Di=D_,
                                   N=N, h0=h0_).terms(),
                      ck.numel() * ck.element_size(),
                      lambda: ss.selective_scan_torch(*args, ck=ck))
        cases["selective_scan_bwd"].append(c)
        log(f"kernel selective_scan_bwd {c}")

    # ragged: dt = 0 and dy = 0 over a padded row's tail
    x, dt, A, Bm, C, D, h0 = scan_ops(8, 256, Di, torch.bfloat16, "per row")
    dy = rn(8, 256, Di).to(torch.bfloat16)
    lens = [256, 37, 200, 255, 1, 128, 150, 129]
    dtp, dyp = dt.clone(), dy.clone()
    for b, n in enumerate(lens):
        dtp[b, n:] = 0
        dyp[b, n:] = 0
    pad = ss._launch_bwd(x, dtp, A, Bm, C, D, h0, dyp, need_A=False,
                         need_D=False)
    same = []
    for b, n in enumerate(lens):
        solo = ss._launch_bwd(
            x[b:b + 1, :n].contiguous(), dt[b:b + 1, :n].contiguous(), A,
            Bm[b:b + 1, :n], C[b:b + 1, :n], D, h0[b:b + 1],
            dy[b:b + 1, :n].contiguous(), need_A=False, need_D=False)
        same.append(all(torch.equal(pad[k][b, :n], solo[k][0])
                        for k in (0, 1, 3, 4))
                    and torch.equal(pad[6][b], solo[6][0]))
    check(all(same), f"selective_scan_bwd ragged: padded rows' gradients "
                     f"bit-equal to the solo rows' {same}")
    cases["selective_scan_bwd"][0]["ragged_rows_bit_equal"] = same
    log(f"kernel selective_scan_bwd ragged B=8 S=256 lens {lens}: the "
        "valid part's gradients == the solo rows', bit for bit")

    # rglru_scan_bwd
    cases["rglru_scan_bwd"] = []
    for B, S, W_, dtype, h0_kind, timed_ in (
            (4, 256, W, torch.bfloat16, "shared", True),
            (4, 256, W, torch.bfloat16, "per row", False),
            (4, 256, W, torch.bfloat16, "none", False),
            (4, 256, W, torch.float32, "shared", True),
            (3, 37, 200, torch.bfloat16, "per row", False),
            (3, 37, 200, torch.float32, "none", False)):
        args = lru_ops(B, S, W_, dtype, h0_kind)
        dhs = rn(B, S, W_).to(dtype)
        full = not timed_
        dh = rn(B, W_) if full else None
        label = (f"B={B} S={S} W={W_} h0 {h0_kind} {str(dtype)[6:]}"
                 + ("" if full else ", no dh_final, da_param not asked"))
        hT = torch.empty((B, W_), dtype=torch.float32, device="cuda")
        # the checkpoints from the forward kernel, as autograd keeps them;
        # the forward's h_seq and h_final keep their bits with the stores
        ck = rg.checkpoints(args[0])
        hs_ck, hf_ck = rg._launch(*args, 8.0, ck=ck)
        hs_, hf = rg._launch(*args, 8.0)
        torch.cuda.synchronize()
        check(torch.equal(hs_ck, hs_) and torch.equal(hf_ck, hf),
              f"rglru_scan {label}: the forward with its checkpoint output "
              "gave other bits")
        got = rg._launch_bwd(*args, dhs, dh, need_a=full, h_final_out=hT,
                             ck=ck)
        want = rg.rglru_bwd_torch(*args, dhs, dh, need_a=full)
        errs = grads_close(f"rglru_scan_bwd {label}", got, want, dtype,
                           LRU_GRADS)
        again = rg._launch_bwd(*args, dhs, dh, need_a=full, ck=ck)
        torch.cuda.synchronize()
        check(all(a is None and b is None or torch.equal(a, b)
                  for a, b in zip(got, again)),
              f"rglru_scan_bwd {label}: a second call gave other bits")
        check(torch.equal(hT, hf), f"rglru_scan_bwd {label}: the "
              f"recompute of the last chunk ended "
              f"{(hT - hf).abs().max().item()} from the forward kernel's "
              "h_final")
        c = dict(shape=label, max_abs_err=max(errs.values()), errs=errs,
                 tol=GRAD_TOL[dtype], tol_of="each output's largest value",
                 bits_repeat=True, fwd_ck_bits_unchanged=True,
                 rerun_h_final_bit_equal=True, plan=rg.last_bwd_plan,
                 path="32 channels of one row a block, chunks of 32 steps "
                      "in reverse fed the forward kernel's checkpoints: "
                      "a cp.async ring, the gates by all warps, the h and "
                      "g chains on two warps, the gradients by all warps "
                      "in 16-byte vectors")
        if timed_:
            bt = kernel_costs("rglru_scan_bwd", dtype, B=B, S=S, W=W_, h0={
                "per row": "row"}.get(h0_kind, h0_kind)).terms()
            ft = kernel_costs("rglru_scan", dtype, B=B, S=S, W=W_,
                              h0=h0_kind != "none").terms()
            # ms: the whole _launch_bwd call (outputs allocated, the
            # kernel, the rows' da_param partials summed when asked)
            timed(c, timer, "rglru_scan_bwd_kernel",
                  lambda: rg._launch_bwd(*args, dhs, need_a=False, ck=ck),
                  lambda: rg.rglru_bwd_torch(*args, dhs, need_a=False),
                  dict(bytes=bt["bytes"], mufu=bt["exp"], flops=bt["flops"]),
                  dict(bytes="bytes", mufu="operations", flops="operations"))
            # the forward's terms by phase 21's rule
            fwd_times(c, timer, "rglru_scan_kernel",
                      lambda: rg._launch(*args, 8.0),
                      lambda: rg._launch(*args, 8.0, ck=ck),
                      dict(bytes=ft["bytes"], mufu=ft["exp"],
                           flops=ft["flops"]),
                      ck.numel() * ck.element_size(),
                      lambda: rg.rglru_torch(*args, 8.0, ck=ck))
        cases["rglru_scan_bwd"].append(c)
        log(f"kernel rglru_scan_bwd {c}")

    # ragged: r = -1e9 and dhs = 0 over a padded row's tail
    x, r, i, a, h0 = lru_ops(8, 256, W, torch.bfloat16, "per row")
    dhs = rn(8, 256, W).to(torch.bfloat16)
    rp, dhp = r.clone(), dhs.clone()
    for b, n in enumerate(lens):
        rp[b, n:] = -1e9
        dhp[b, n:] = 0
    pad = rg._launch_bwd(x, rp, i, a, h0, dhp, need_a=False)
    same = []
    for b, n in enumerate(lens):
        solo = rg._launch_bwd(
            x[b:b + 1, :n].contiguous(), r[b:b + 1, :n].contiguous(),
            i[b:b + 1, :n].contiguous(), a, h0[b:b + 1],
            dhs[b:b + 1, :n].contiguous(), need_a=False)
        same.append(all(torch.equal(pad[k][b, :n], solo[k][0])
                        for k in range(3))
                    and torch.equal(pad[4][b], solo[4][0]))
    check(all(same), f"rglru_scan_bwd ragged: padded rows' gradients "
                     f"bit-equal to the solo rows' {same}")
    cases["rglru_scan_bwd"][0]["ragged_rows_bit_equal"] = same
    log(f"kernel rglru_scan_bwd ragged B=8 S=256 lens {lens}: the valid "
        "part's gradients == the solo rows', bit for bit")

    # a saturated gate: non-finite dr_gate and da_param where the plain
    # backward's are, agreement elsewhere, finite dx, di and dh0
    for dtype in (torch.bfloat16, torch.float32):
        x, r, i, a, h0 = lru_ops(4, 256, W, dtype, "per row")
        r = r.clone()
        r[1, 246:] = -1e9                      # 10 steps x W channels
        dhs = rn(4, 256, W).to(dtype)
        got = rg._launch_bwd(x, r, i, a, h0, dhs)
        want = rg.rglru_bwd_torch(x, r, i, a, h0, dhs)
        torch.cuda.synchronize()
        masked = ([], [])
        for name, g, w in zip(LRU_GRADS, got, want):
            bad = ~torch.isfinite(w)
            check(torch.equal(~torch.isfinite(g), bad),
                  f"rglru_scan_bwd saturated {dtype}: {name} non-finite "
                  "elsewhere than the plain backward's")
            n_bad = int(bad.sum())
            check(n_bad == {"dr": 10 * W, "da_param": W}.get(name, 0),
                  f"rglru_scan_bwd saturated {dtype}: {n_bad} non-finite "
                  f"{name}")
            masked[0].append(torch.where(bad, 0, g.float()))
            masked[1].append(torch.where(bad, 0, w.float()))
        errs = grads_close(f"rglru_scan_bwd saturated {dtype}", *masked,
                           dtype, LRU_GRADS)
        rec[f"rglru_saturated_{str(dtype)[6:]}"] = dict(
            nonfinite_dr=10 * W, nonfinite_da_param=W, errs_elsewhere=errs)
        log(f"kernel rglru_scan_bwd saturated gate ({dtype}, 10 steps of "
            f"row 1): dr_gate non-finite on those {10 * W} entries and "
            f"da_param on all {W} channels, as the plain backward; "
            f"elsewhere {errs}")

    # the autograd Functions on the card against autograd through the
    # plain versions, as the layers call them (B and C views of one leaf,
    # shared state prompts expanded over the rows)
    for dtype in (torch.bfloat16, torch.float32):
        x, dt, A, _, _, D, _ = scan_ops(2, 64, 512, dtype, "none")
        xdbc = rn(2, 64, dr + 2 * N, s=0.5).to(dtype)
        s0 = rn(512, N, s=0.1)
        dy = rn(2, 64, 512).to(dtype)

        def sgrads(backend):
            leaves = [t.clone().requires_grad_(True)
                      for t in (x, dt, xdbc, s0)]
            xx, dd, xd, h = leaves
            y, _ = ss.selective_scan(xx, dd, A, xd[..., dr:dr + N],
                                     xd[..., dr + N:], D,
                                     h[None].expand(2, 512, N),
                                     backend=backend)
            (y.float() * dy.float()).sum().backward()
            return [t.grad for t in leaves]

        with plain_calls(scans=True) as plain:
            got = sgrads(None)
        check(plain["selective_scan"] == plain["selective_scan_bwd"] == 0,
              f"autograd selective_scan ran a plain version: {plain}")
        serr = grads_close(f"autograd selective_scan {dtype}", got,
                           sgrads("torch"), dtype,
                           ("dx", "ddt", "dxdbc", "dstate0"))
        x, r, i, a, _ = lru_ops(2, 64, W, dtype, "none")
        s0 = rn(W, s=0.1)
        dhs = rn(2, 64, W).to(dtype)

        def lgrads(backend):
            leaves = [t.clone().requires_grad_(True) for t in (x, r, i, s0)]
            hs, _ = rg.rglru(*leaves[:3], a, leaves[3], backend=backend)
            (hs.float() * dhs.float()).sum().backward()
            return [t.grad for t in leaves]

        with plain_calls(scans=True) as plain:
            got = lgrads(None)
        check(plain["rglru_scan"] == plain["rglru_scan_bwd"] == 0,
              f"autograd rglru ran a plain version: {plain}")
        lerr = grads_close(f"autograd rglru {dtype}", got, lgrads("torch"),
                           dtype, ("dx", "dr", "di", "dstate0"))
        rec[f"autograd_{str(dtype)[6:]}"] = dict(selective_scan=serr,
                                                 rglru=lerr)
        log(f"autograd selective_scan / rglru on the card vs autograd "
            f"through the plain versions ({dtype}): {serr} / {lerr}")
    return rec


def lora_bwd_hybrid_cases(gen: torch.Generator, timer: Timer,
                          cases: dict) -> None:
    """Phase 27's kernel check: lora_matmul_bwd at recurrentgemma-2b's q
    (N 2560) and v (N 256) projections of the round (M 1024, K 2560, r 8)
    against its plain version, beside phase 8's qwen2-7b shapes (into
    ``cases``)."""
    randn = randn_of(gen)
    for N, proj in ((2560, "q"), (256, "v")):
        cases["lora_matmul_bwd"].append(lora_bwd_case(
            randn, timer, 1024, 2560, N, 8, torch.bfloat16,
            f" (recurrentgemma-2b's {proj})"))


def scan_train_phases(seed: int) -> dict:
    """Phases 26 and 27: one HFSL round of falcon-mamba-7b and of
    recurrentgemma-2b at their published sizes, as phase 9 runs qwen2-7b:
    a 5-class head, a ClassificationTask bank, 2 clusters, 4 steps, batch
    4, seq 256, FedAvg every 2 steps, AdamW 5e-3."""
    import dataclasses

    from repro_torch.configs.base import get_config

    rec = {}
    for key, arch, shape in (
            ("train-ssm", "falcon-mamba-7b",
             lambda c: (c.n_layers, c.d_model, c.d_inner, c.ssm.d_state) ==
             (64, 4096, 8192, 16)),
            ("train-hybrid", "recurrentgemma-2b",
             lambda c: (c.n_layers, c.d_model, c.lru_width, c.n_heads,
                        c.head_dim_) == (26, 2560, 2560, 10, 256))):
        cfg = get_config(arch)
        cfg = cfg.with_(peft=dataclasses.replace(cfg.peft, head_dim_out=5))
        check(shape(cfg) and cfg.dtype == "bfloat16",
              f"{arch} is not at its published size")
        rec[key] = train_round(
            key, cfg, n_clusters=2, steps=4, batch=4, sync_every=2,
            task_args=(5, 1000, 256, 0.5), seed=seed)
        no_pad_copies(f"phase {26 if key == 'train-ssm' else 27}")
    return rec


def scan_train_exactness(seed: int) -> dict:
    """Phase 28: a 2-layer full-width f32 falcon-mamba-7b and a 5-layer
    full-width f32 recurrentgemma-2b (one (rglru, rglru, attn) group and
    the tail), 2 clusters, 3 steps of SGD with momentum, through the
    kernels and through ``backend="torch"``, held as phase 11 holds
    qwen2-7b: adapters and losses within 1e-4, each leaf's update within
    1e-3 of the leaf's largest update."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.core import hfsl
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_paths
    from repro_torch.optim.optimizers import sgd

    out = {}
    for arch, layers in (("falcon-mamba-7b", 2), ("recurrentgemma-2b", 5)):
        cfg = get_config(arch)
        cfg = cfg.with_(n_layers=layers, dtype="float32",
                        peft=dataclasses.replace(cfg.peft, head_dim_out=5))
        opt = sgd(0.1, momentum=0.9)
        state = hfsl.init_hfsl_state(seed, cfg, 2, opt, M.init,
                                     device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(seed + 5)
        # state prompts and LoRA b init to zeros; seeded, every adapter's
        # gradient is reached
        for path, t in tree_paths(state["adapters_c"]):
            if "state0" in path or path[-1] == "b" and "lora" in path:
                t.copy_(torch.randn(t.shape, generator=gen, device="cuda")
                        * 0.1)
        bank = classify_bank((5, 1000, 256, 0.5), 2, 4, 3, seed,
                             cfg.peft.head_dim_out)
        rnd = hfsl.make_hfsl_round(cfg, opt, M.classify_loss, steps=3,
                                   sync_every=2)
        want = round_launches(cfg, 2, 3)
        ops.reset_launch_counts()
        with plain_calls(scans=True) as plain:
            ks, km = rnd(state, bank.arrays, 0)
        n = ops.launch_counts()
        check(launches_as_predicted(n, want) and not any(plain.values()),
              f"{arch} e2e train: launches {n}, predicted {want}; plain "
              f"calls {plain}")
        with ops.backend("torch"):
            with plain_calls(scans=True) as plain:
                ps, pm = rnd(state, bank.arrays, 0)
        scan = "selective_scan" if cfg.family == "ssm" else "rglru_scan"
        check(plain[scan] > 0 and plain[scan + "_bwd"] > 0,
              f"{arch}: the plain round did not run the plain scans: "
              f"{plain}")
        torch.cuda.synchronize()
        r = dict(round_exactness(ks, km, ps, pm, state),
                 losses=km["loss"].tolist())
        check(exact_enough(r),
              f"{arch} e2e train f32 (sgd): kernels vs plain {r}")
        log(f"e2e train: {layers}-layer f32 {arch} round (2 clusters, 3 "
            f"steps, sgd 0.1 momentum 0.9): kernels vs plain adapters "
            f"max_abs_err {r['adapters_max_abs_err']:.3e}, losses "
            f"{r['loss_max_abs_err']:.3e} (tol 1e-4); largest per-leaf "
            f"update difference {r['update_max_rel_err']:.3e} of the "
            f"leaf's largest update (tol 1e-3; largest update "
            f"{r['update_max']:.3e}); launches "
            f"{ {k: v for k, v in n.items() if v} }")
        out[arch] = dict(r, layers=layers, launches=n)
        del state, ks, ps
        torch.cuda.empty_cache()
    return dict(out, tol=1e-4, update_rel_tol=1e-3)


# ---------------------------------------------------------------------------
# phases 29 to 32: the paper's knowledge flow (relay, split learning, CLI)
# ---------------------------------------------------------------------------

# the paths these phases drive; each kernel's record adds their launches
FLOW_PATHS = ("relay", "sl", "sl_train", "cli")
# the later families' phases, each with its own launch record
FAMILY_PATHS = ("moe", "vlm", "audio")
N_STAGES, N_MICRO = 4, 4


def counted(total: dict, fn):
    """``fn()`` with every launch count set to 0 just before and read just
    after (synchronised); the counts are added into ``total``. Returns
    (``fn()``'s result, the counts)."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    n = ops.launch_counts()
    for k, v in n.items():
        total[k] = total.get(k, 0) + v
    return out, n


def host_ms(times: dict, name: str, fn):
    """``fn()``, its host milliseconds (synchronised) appended to
    ``times[name]``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
    return out


def bits_equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def flow_queue(rng, domains, vocab):
    """12 ragged requests over the bank's domains, three to a domain."""
    reqs = queue(rng, 3 * len(domains), (32, 257), (8, 33), vocab)
    doms = [domains[i % len(domains)] for i in range(len(reqs))]
    return reqs, doms


def relay_steps(relay, d0: str, clusters: list, times: dict) -> None:
    """Deliver to every domain, segment d0's adapters to the clusters,
    absorb their trees and aggregate at the cloud, each call timed."""
    for d in relay.edges:
        host_ms(times, "cloud_deliver", lambda d=d: relay.cloud_deliver(d))
    host_ms(times, "edge_deliver", lambda: relay.edge_deliver(d0, 4))
    host_ms(times, "edge_absorb", lambda: relay.edge_absorb(d0, clusters))
    host_ms(times, "cloud_aggregate", relay.cloud_aggregate)


def relay_phase(cfg, backbone: dict, seed: int, tmp: str) -> tuple:
    """Phase 29: the data-free knowledge relay at qwen2-7b's full size.
    Returns (record, d0's adapters after the absorb, their checkpoint)."""
    import os

    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import hfsl
    from repro_torch.core.adapter_bank import AdapterBank
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.peft import tree_bytes
    from repro_torch.core.relay import KnowledgeRelay
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import adamw

    total, times = {}, {}
    cloud = domain_adapters(cfg, seed + 2)["domain0"]
    bank = AdapterBank.create(domain_adapters(cfg, seed + 1))
    doms = list(bank.domains)
    d0 = doms[0]
    relay = host_ms(times, "attach", lambda: KnowledgeRelay(cloud, doms,
                                                            bank=bank))
    for d in doms:
        host_ms(times, "cloud_deliver", lambda d=d: relay.cloud_deliver(d))
    delivered = host_ms(times, "edge_deliver",
                        lambda: relay.edge_deliver(d0, 4))
    check(all(bits_equal(bank.snapshot(d), cloud) for d in doms),
          "relay: a bank slot is not the delivered cloud adapters")
    rng = np.random.default_rng(seed + 20)
    reqs, qdoms = flow_queue(rng, doms, cfg.vocab_size)
    sp = bank.serving_params(backbone)
    with plain_calls(serving=True) as plain:
        (pre, _), _ = counted(total, lambda: drain(
            cfg, sp, reqs, slots=8, bank=bank, domains=qdoms))

        # one HFSL round of 4 clusters at phase 9's shapes, from the
        # delivered adapters
        opt = adamw(5e-3)
        adapters_c = hfsl._stack_clusters([delivered] * 4)
        state = {"backbone": backbone, "adapters_c": adapters_c,
                 "opt": hfsl.init_opt_state(opt, adapters_c),
                 "step": torch.zeros((), dtype=torch.int32, device="cuda")}
        data = classify_bank((5, 1000, 256, 0.5), 4, 4, 4, seed,
                             cfg.peft.head_dim_out)
        rnd = hfsl.make_hfsl_round(cfg, opt, M.classify_loss, steps=4,
                                   sync_every=2)
        t0 = time.perf_counter()
        (out, metrics), n = counted(total, lambda: rnd(state, data.arrays,
                                                       0))
        round_s = time.perf_counter() - t0
        want = round_launches(cfg, 4, 4)
        check(launches_as_predicted(n, want),
              f"relay: round launches {n}, predicted {want}")
        losses = metrics["loss"].cpu().numpy()
        check(bool(np.isfinite(losses).all()), f"relay: losses {losses}")
        clusters = [hfsl._cluster(out["adapters_c"], c) for c in range(4)]

        v0 = bank.version(d0)
        host_ms(times, "edge_absorb", lambda: relay.edge_absorb(d0,
                                                                clusters))
        check(bank.version(d0) == v0 + 1,
              f"relay: bank version {v0} -> {bank.version(d0)}")
        check(bits_equal(bank.snapshot(d0), relay.edges[d0]),
              "relay: the bank's d0 slot is not the relay's edge")
        (post, stats), _ = counted(total, lambda: drain(
            cfg, sp, reqs, slots=8, bank=bank, domains=qdoms))
        fresh_bank = AdapterBank.create(relay.edges)
        (fresh, _), _ = counted(total, lambda: drain(
            cfg, fresh_bank.serving_params(backbone), reqs, slots=8,
            bank=fresh_bank, domains=qdoms))
    check(all(v == 0 for v in plain.values()),
          f"relay: a plain version ran on the card: {plain}")
    served_ok(cfg, post, reqs, "relay")
    same = [np.array_equal(a.tokens, b.tokens) for a, b in zip(post, fresh)]
    check(all(same), f"relay: the relay-fed bank's drain differs from a "
                     f"fresh bank's on {same.count(False)} requests")
    changed = sum(not np.array_equal(a.tokens, b.tokens)
                  for a, b, d in zip(pre, post, qdoms) if d == d0)
    check(changed >= 1, "relay: no d0 request changed after the absorb")
    agg = host_ms(times, "cloud_aggregate", relay.cloud_aggregate)
    # every method hands back a clone: an in-place step on the returned
    # tree leaves the relay's cloud as it was; what the clone of one edge
    # tree costs, the part of each call's host time it adds
    cloud_now = [x.clone() for x in _leaves(relay.cloud)]
    for x in _leaves(agg):
        x.add_(1.0)
    check(bits_equal(relay.cloud, cloud_now),
          "relay: the aggregate handed back aliases the relay's cloud")
    host_ms(times, "clone", lambda: [x.clone()
                                     for x in _leaves(relay.edges[d0])])

    tb = tree_bytes(cloud)
    ledger = relay.ledger
    analytic = dict(cloud_to_edge=4 * tb, edge_to_end=4 * tb,
                    end_to_edge=4 * tb, edge_to_cloud=4 * tb, transfers=16,
                    retries=0, retransmit_bytes=0)
    got = {k: getattr(ledger, k) for k in analytic}
    check(got == analytic, f"relay: ledger {got}, analytic {analytic}")
    log(f"relay: qwen2-7b adapters {tb} B a tree; ledger {got} (= analytic "
        f"counts x tree_bytes); cost latency {relay.cost.latency_s:.4f} s, "
        f"energy {relay.cost.energy_j:.4f} J; HFSL round 4 clusters x 4 "
        f"steps in {round_s:.3f}s, losses {np.round(losses, 4).tolist()}; "
        f"drain after the absorb {drain_line(drain_record(stats, {}, 0))}; "
        f"{changed} of {qdoms.count(d0)} d0 requests changed, all "
        f"{len(reqs)} equal to a fresh bank's drain")

    # the same flow over lossy links: bit for bit the clean relay
    plan = FaultPlan(seed, link_loss=0.2, payload_corrupt=0.3)
    bank_f = AdapterBank.create(domain_adapters(cfg, seed + 1))
    lossy = host_ms(times, "attach lossy", lambda: KnowledgeRelay(
        cloud, doms, bank=bank_f, faults=plan, max_retries=50,
        backoff_s=0.0))
    lossy_times: dict = {}
    relay_steps(lossy, d0, clusters, lossy_times)
    lossy_ledger = lossy.ledger
    check(bits_equal(lossy.cloud, relay.cloud)
          and all(bits_equal(lossy.edges[d], relay.edges[d]) for d in doms)
          and all(bits_equal(bank_f.snapshot(d), bank.snapshot(d))
                  for d in doms),
          "relay: the lossy relay's trees differ from the clean relay's")
    lo = lossy_ledger
    check(lo.retries > 0
          and lo.total() == ledger.total() + lo.retransmit_bytes
          and lo.retransmit_bytes < lo.retries * tb,
          f"relay: lossy ledger {lo} beside clean {ledger}")
    log(f"relay: lossy links ({plan}): {lo.retries} retries, "
        f"{lo.retransmit_bytes} B retransmitted (< {lo.retries} whole "
        f"trees: corrupted leaves re-sent alone), total {lo.total()} = "
        f"clean {ledger.total()} + retransmits; cloud, edges and bank "
        f"slots bit for bit the clean relay's")

    # the int8 transport of d0's adapters, served from a bank slot
    fp_path = os.path.join(tmp, "d0.npz")
    q8_path = os.path.join(tmp, "d0_q8.npz")
    d0_ad = relay.edges[d0]
    fp_bytes = ckpt_io.save_adapters(fp_path, {"adapters": d0_ad})
    q8_bytes = ckpt_io.save_adapters_quantized(q8_path, {"adapters": d0_ad})
    q8 = ckpt_io.load_adapters_quantized(q8_path,
                                         {"adapters": d0_ad})["adapters"]
    qbank = AdapterBank.create({"bf16": d0_ad, "int8": q8})
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (64, 128)),
                           device="cuda")
    with torch.no_grad():
        logits, _ = counted(total, lambda: M.classify(
            qbank.serving_params(backbone), {"tokens": torch.cat([toks,
                                                                  toks])},
            cfg, adapter_ids=qbank.adapter_ids(["bf16"] * 64
                                               + ["int8"] * 64)))
    agree = (logits[:64].argmax(-1) == logits[64:].argmax(-1)).float() \
        .mean().item()
    check(bool(torch.isfinite(logits).all()) and agree >= 0.75,
          f"relay: int8 slot agrees with the bf16 slot on {agree} of 64")
    log(f"relay: d0's adapters int8 {q8_bytes} B beside bf16 {fp_bytes} B "
        f"({q8_bytes / fp_bytes:.3f}x); classify of 64 examples through "
        f"the int8 slot agrees with the bf16 slot on {agree:.4f} "
        f"(bound 0.75)")
    ms = {k: [round(t, 3) for t in v] for k, v in times.items()}
    lossy_ms = {k: [round(t, 3) for t in v] for k, v in lossy_times.items()}
    log(f"relay: host ms of each call, clean {ms}; lossy {lossy_ms}")
    no_pad_copies("phase 29")
    rec = dict(launches=total, tree_bytes=tb, ledger=got,
               lossy_ledger=dataclasses.asdict(lossy_ledger),
               cost=dataclasses.asdict(relay.cost),
               lossy_cost=dataclasses.asdict(lossy.cost),
               round_s=round_s, round_launches=n, losses=losses.tolist(),
               d0_requests_changed=changed, int8_bytes=q8_bytes,
               bf16_bytes=fp_bytes, int8_agreement=agree, host_ms=ms,
               lossy_host_ms=lossy_ms,
               drain=drain_record(stats, {}, 0))
    return rec, d0_ad, fp_path


def chain_launches(cfg, n_layers: int, passes: int, train: bool) -> dict:
    """The launches ``passes`` microbatch passes of the SL chain must
    make, kernel by kernel: each layer once a pass; an attention layer
    one flash_attention and one lora_matmul a LoRA target, and in
    training one lora_matmul_bwd a target and one more lora_matmul a
    target for dx in every layer but the first (the embedding needs no
    gradient); an ssm layer one selective_scan (and its backward)."""
    from repro_torch.kernels import ops
    want = dict.fromkeys(ops.launch_counts(), 0)
    if cfg.family == "ssm":
        want["selective_scan"] = n_layers * passes
        if train:
            want["selective_scan_bwd"] = n_layers * passes
        return want
    t = len(cfg.peft.lora_targets)
    want["flash_attention"] = n_layers * passes
    want["lora_matmul"] = t * n_layers * passes
    if train:
        want["lora_matmul"] += t * (n_layers - 1) * passes
        want["lora_matmul_bwd"] = t * n_layers * passes
    return want


def chain_case(name: str, cfg, params: dict, toks, total: dict,
               timer: Timer) -> dict:
    """The SL chain (``N_STAGES`` stages, ``N_MICRO`` microbatches)
    against monolithic ``classify`` on the same inputs, each timed."""
    from repro_torch.core import sl_pipeline as sl
    from repro_torch.models import model as M

    st = sl.split_for_stages(params, cfg, N_STAGES)
    L = cfg.n_layers

    def chain():
        return sl.pipeline_classify(params, st, toks, cfg,
                                    n_microbatches=N_MICRO)

    def mono():
        return M.classify(params, {"tokens": toks}, cfg)

    with torch.no_grad(), plain_calls(serving=True) as plain:
        got, n = counted(total, chain)
        want = mono()
        chain_ms, mono_ms = timer(chain), timer(mono)
    check(all(v == 0 for v in plain.values()),
          f"{name}: a plain version ran on the card: {plain}")
    pred = chain_launches(cfg, L, N_MICRO, train=False)
    check(n == pred, f"{name}: chain launches {n}, predicted {pred}")
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{name}: chain logits {tuple(got.shape)}")
    err = (got - want).abs().max().item()
    cos = F.cosine_similarity(got.flatten(), want.flatten(), dim=0).item()
    top2 = want.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > TOL[torch.bfloat16] * \
        want.abs().max()
    top1 = (got.argmax(-1) == want.argmax(-1))
    dt = getattr(torch, cfg.dtype)
    if dt == torch.float32:
        check(err <= 1e-4, f"{name}: chain vs monolithic max_abs_err {err}")
    else:
        check(cos > 0.999 and bool(top1[decided].all()),
              f"{name}: chain vs monolithic cosine {cos}, top-1 {top1}")
    r = dict(config=f"{cfg.name} {L} layers d {cfg.d_model} {cfg.dtype}",
             batch=toks.shape[0], seq=toks.shape[1], stages=N_STAGES,
             microbatches=N_MICRO, max_abs_err=err, cosine=cos,
             top1_agree=int(top1.sum()), top1_decided=int(decided.sum()),
             chain_ms=chain_ms, mono_ms=mono_ms, launches=n,
             predicted_launches=pred)
    log(f"{name}: {r['config']}, B {toks.shape[0]} S {toks.shape[1]}, "
        f"{N_STAGES} stages x {N_MICRO} microbatches: chain vs monolithic "
        f"classify max_abs_err {err:.3e}, cosine {cos:.6f}, top-1 "
        f"{int(top1.sum())}/{len(top1)} ({int(decided.sum())} rows decided "
        f"beyond bf16 rounding); chain {chain_ms:.3f} ms, monolithic "
        f"{mono_ms:.3f} ms (CUDA events); launches "
        f"{ {k: v for k, v in n.items() if v} } = predicted "
        f"(stages x microbatches x per-layer launches)")
    return r


def sl_phase(seed: int, qwen_cfg, qwen_params: dict) -> dict:
    """Phase 30: SL inference, the chain against monolithic ``classify``:
    vit-edge f32 at its configured size, qwen2-7b bf16 at its published
    size, falcon-mamba-7b f32 at full width with 8 layers."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    total, timer = {}, Timer(reps=3)
    rng = np.random.default_rng(seed + 30)
    vit = get_config("vit-edge").with_(dtype="float32")
    check((vit.n_layers, vit.d_model) == (12, 768),
          "vit-edge is not at its configured size")
    vp = {"backbone": M.init(vit, seed, device="cuda")["backbone"],
          "adapters": domain_adapters(vit, seed + 6)["domain0"]}
    toks = torch.as_tensor(rng.integers(0, vit.vocab_size, (16, 197)),
                           device="cuda")
    rec = {"vit-edge": chain_case("sl vit-edge", vit, vp, toks, total,
                                  timer)}
    del vp
    toks = torch.as_tensor(rng.integers(0, qwen_cfg.vocab_size, (16, 256)),
                           device="cuda")
    rec["qwen2-7b"] = chain_case("sl qwen2-7b", qwen_cfg, qwen_params, toks,
                                 total, timer)
    fm = get_config("falcon-mamba-7b")
    check(fm.d_model == 4096, "falcon-mamba-7b is not at its published "
                              "width")
    fm = fm.with_(n_layers=8, dtype="float32", peft=dataclasses.replace(
        fm.peft, head_dim_out=5))
    params = M.init(fm, seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    for layer in params["adapters"]["stack"]["g0"]:
        s0 = layer["s0"]["state0"]
        s0.copy_(torch.randn(s0.shape, generator=gen, device="cuda") * 0.1)
    toks = torch.as_tensor(rng.integers(0, fm.vocab_size, (16, 256)),
                           device="cuda")
    rec["falcon-mamba-7b"] = chain_case("sl falcon-mamba-7b", fm, params,
                                        toks, total, timer)
    del params
    torch.cuda.empty_cache()
    rec["launches"] = total
    no_pad_copies("phase 30")
    return rec


def chain_grads(cfg, params: dict, batch: dict):
    """Loss and gradients of the SL chain's cross entropy with respect to
    the stage adapters and the head, and those of monolithic
    ``classify``, as trees of the same order."""
    from repro_torch.core import sl_pipeline as sl
    from repro_torch.core.peft import value_and_grad
    from repro_torch.models import model as M
    from repro_torch.models.layers import cross_entropy

    st = sl.split_for_stages(params, cfg, N_STAGES)

    def chain_loss(tr):
        p = {"backbone": params["backbone"],
             "adapters": {**params["adapters"], "head": tr["h"]}}
        logits = sl.pipeline_classify(
            p, {"layers": st["layers"], "adapters": tr["a"]},
            batch["tokens"], cfg, n_microbatches=N_MICRO)
        return cross_entropy(logits, batch["label"])

    def mono_loss(tr):
        p = {"backbone": params["backbone"],
             "adapters": {**params["adapters"], "head": tr["h"],
                          "stack": {"g0": [la for s in tr["a"] for la in s]}}}
        return cross_entropy(M.classify(p, batch, cfg), batch["label"])

    tr = {"a": st["adapters"], "h": params["adapters"]["head"]}
    return value_and_grad(chain_loss, tr, has_aux=False), \
        value_and_grad(mono_loss, tr, has_aux=False)


def grads_err(got, want) -> float:
    """Largest gradient difference relative to max(1, the leaf's largest
    gradient)."""
    return max((g.float() - w.float()).abs().max().item()
               / max(1.0, w.float().abs().max().item())
               for g, w in zip(_leaves(got), _leaves(want)))


def sl_train_phase(seed: int, qwen_cfg, qwen_params: dict,
                   hfsl_step_s: float) -> dict:
    """Phase 31: SL fine-tuning. vit-edge f32 at 4 stages against a
    monolithic autograd step (gradients, one sgd update); qwen2-7b bf16,
    3 adamw steps of the chain."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import sl_pipeline as sl
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map
    from repro_torch.optim.optimizers import adamw, sgd

    total = {}
    rng = np.random.default_rng(seed + 40)
    vit = get_config("vit-edge").with_(dtype="float32")
    vp = {"backbone": M.init(vit, seed, device="cuda")["backbone"],
          "adapters": domain_adapters(vit, seed + 6)["domain0"]}

    def batch_of(cfg, B, S):
        return {"tokens": torch.as_tensor(
                    rng.integers(0, cfg.vocab_size, (B, S)), device="cuda"),
                "label": torch.as_tensor(rng.integers(0, 5, (B,)),
                                         device="cuda")}

    batch = batch_of(vit, 16, 197)
    (closs, cg), (mloss, mg) = chain_grads(vit, vp, batch)
    gerr = grads_err(cg, mg)
    check(abs(closs.item() - mloss.item()) <= 1e-5 and gerr <= 1e-5,
          f"sl train vit-edge: loss {closs.item()} vs {mloss.item()}, "
          f"gradients {gerr}")
    opt = sgd(0.1)
    st = sl.split_for_stages(vp, vit, N_STAGES)
    tr = {"a": st["adapters"], "h": vp["adapters"]["head"]}
    step = sl.make_sl_finetune_step(vp, vit, opt, n_microbatches=N_MICRO)
    with plain_calls() as plain:
        (new_st, new_h, _, loss), n_vit = counted(
            total, lambda: step(st, tr["h"], opt.init(tr), batch))
    want = tree_map(lambda p, g: p - 0.1 * g, tr, mg)
    uerr = max((a - b).abs().max().item() for a, b in zip(
        _leaves({"a": new_st["adapters"], "h": new_h}), _leaves(want)))
    pred = chain_launches(vit, vit.n_layers, N_MICRO, train=True)
    check(uerr <= 1e-5 and n_vit == pred
          and all(v == 0 for v in plain.values()),
          f"sl train vit-edge: sgd update max_abs_err {uerr}, launches "
          f"{n_vit} (predicted {pred}), plain {plain}")
    log(f"sl train vit-edge: 12 layers f32, B 16 S 197, {N_STAGES} stages x "
        f"{N_MICRO} microbatches: loss {closs.item():.6f} vs monolithic "
        f"{mloss.item():.6f}; gradients within {gerr:.3e} of monolithic "
        f"autograd (of max(1, leaf max); tol 1e-5); one sgd 0.1 step within "
        f"{uerr:.3e} (tol 1e-5); launches "
        f"{ {k: v for k, v in n_vit.items() if v} } as predicted")
    rec = {"vit-edge": dict(loss=closs.item(), mono_loss=mloss.item(),
                            grads_rel_err=gerr, update_max_abs_err=uerr,
                            launches=n_vit)}
    del vp, st, tr, new_st, cg, mg
    torch.cuda.empty_cache()

    # qwen2-7b bf16: gradients against monolithic, then 3 adamw steps
    cfg, params = qwen_cfg, qwen_params
    batch = batch_of(cfg, 16, 256)
    (closs, cg), (mloss, mg) = chain_grads(cfg, params, batch)
    bad = [(g.float() - w.float()).abs().max().item()
           for g, w in zip(_leaves(cg), _leaves(mg))
           if not torch.allclose(g.float(), w.float(), atol=1e-1, rtol=5e-2)]
    gmax = max((g.float() - w.float()).abs().max().item()
               for g, w in zip(_leaves(cg), _leaves(mg)))
    check(not bad and abs(closs.item() - mloss.item()) <= 2e-2,
          f"sl train qwen2-7b: loss {closs.item()} vs {mloss.item()}, "
          f"gradients beyond atol 1e-1 / rtol 5e-2: {bad}")
    del cg, mg
    opt = adamw(5e-3)
    st = sl.split_for_stages(params, cfg, N_STAGES)
    head = params["adapters"]["head"]
    state = opt.init({"a": st["adapters"], "h": head})
    step = sl.make_sl_finetune_step(params, cfg, opt, n_microbatches=N_MICRO)
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, n = [], [], {}
    with plain_calls() as plain:
        for _ in range(3):
            t0 = time.perf_counter()
            (st, head, state, loss), ni = counted(
                total, lambda: step(st, head, state, batch))
            step_s.append(time.perf_counter() - t0)
            losses.append(loss.item())
            n = {k: n.get(k, 0) + v for k, v in ni.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pred = chain_launches(cfg, cfg.n_layers, 3 * N_MICRO, train=True)
    check(bool(np.isfinite(losses).all()) and n == pred
          and all(v == 0 for v in plain.values()),
          f"sl train qwen2-7b: losses {losses}, launches {n} (predicted "
          f"{pred}), plain {plain}")
    log(f"sl train qwen2-7b: 28 layers bf16, B 16 S 256, {N_STAGES} stages "
        f"x {N_MICRO} microbatches: loss {closs.item():.4f} vs monolithic "
        f"{mloss.item():.4f}, gradients within atol 1e-1 / rtol 5e-2 "
        f"(largest difference {gmax:.3e}); 3 adamw steps, losses "
        f"{np.round(losses, 4).tolist()}, {['%.4f' % s for s in step_s]} "
        f"s/step beside phase 9's HFSL step {hfsl_step_s:.4f} s (2 clusters "
        f"x batch 4); peak memory {peak:.2f} GiB; launches "
        f"{ {k: v for k, v in n.items() if v} } as predicted")
    rec["qwen2-7b"] = dict(loss=closs.item(), mono_loss=mloss.item(),
                           grads_max_abs_err=gmax, losses=losses,
                           step_s=step_s, hfsl_step_s=hfsl_step_s,
                           peak_mem_gib=peak, launches=n,
                           predicted_launches=pred)
    rec["launches"] = total
    no_pad_copies("phase 31")
    return rec


def cli_phase(cfg, params: dict, ckpt: str, tmp: str) -> dict:
    """Phase 32: ``repro_torch.launch.serve.main`` in process on qwen2-7b
    at its published size: ``--impl loop`` prints ``--impl scan``'s rows,
    ``--adapters`` loads the relay's checkpoint, ``--trace-out`` and
    ``--metrics-out`` write JSON; and ``generate_loop`` against
    ``generate`` on every row."""
    import contextlib
    import io
    import os

    from repro_torch.core import telemetry
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    total = {}
    trace, metrics = os.path.join(tmp, "trace.json"), \
        os.path.join(tmp, "metrics.json")
    base = ["--arch", "qwen2-7b", "--batch", "4", "--prompt-len", "64",
            "--gen", "16", "--requests", "2", "--adapters", ckpt]

    def run(extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(base + extra)
        out = buf.getvalue()
        rows = [ln.split("first row: ")[1] for ln in out.splitlines()
                if "first row: " in ln]
        check(f"loaded adapters from {ckpt}" in out and len(rows) == 2,
              f"cli: {out}")
        return out, rows

    try:
        (out_loop, loop), n_loop = counted(total, lambda: run(
            ["--impl", "loop", "--trace-out", trace, "--metrics-out",
             metrics]))
    finally:
        telemetry.disable()
    (out_scan, scan), n_scan = counted(total, lambda: run(["--impl",
                                                           "scan"]))
    check(loop == scan, f"cli: loop rows {loop}, scan rows {scan}")
    with open(trace) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    with open(metrics) as f:
        snap = json.load(f)
    check([e["name"] for e in spans] == ["serve.request"] * 2
          and snap["spans"] == 2, f"cli: trace {spans}, metrics {snap}")
    rng = np.random.default_rng(50)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 64)),
                              device="cuda")
    (want, got), n_gen = counted(total, lambda: (
        M.generate(params, cfg, prompts, gen=16),
        serve.generate_loop(params, cfg, prompts, gen=16)))
    check(torch.equal(want, got), "cli: generate_loop differs from "
                                  "generate")
    check(n_loop["lora_matmul"] > 0 and n_loop["flash_decode"] > 0,
          f"cli: --impl loop launches {n_loop}")
    log(f"cli: --impl loop and --impl scan print the same rows {loop}; "
        f"--adapters loaded the relay's checkpoint; trace {len(spans)} "
        f"spans, metrics JSON; generate_loop = generate on all 4 rows x 16 "
        f"tokens; launches loop {n_loop}, scan {n_scan}")
    no_pad_copies("phase 32")
    return dict(launches=total, rows=loop, loop_launches=n_loop,
                scan_launches=n_scan, generate_launches=n_gen)


def knowledge_flow(seed: int, hfsl_step_s: float) -> dict:
    """Phases 29 to 32 on one qwen2-7b backbone at its published size,
    with a 5-class head for classify."""
    import tempfile

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    cfg = get_config("qwen2-7b")
    check((cfg.n_layers, cfg.d_model) == (28, 3584),
          "qwen2-7b is not at its published size")
    cfg = cfg.with_(peft=dataclasses.replace(cfg.peft, head_dim_out=5))
    backbone = M.init(cfg, seed, device="cuda")["backbone"]
    with tempfile.TemporaryDirectory() as tmp:
        rec, d0_ad, ckpt = relay_phase(cfg, backbone, seed, tmp)
        out = {"relay": rec}
        params = {"backbone": backbone, "adapters": d0_ad}
        out["sl"] = sl_phase(seed, cfg, params)
        out["sl_train"] = sl_train_phase(seed, cfg, params, hfsl_step_s)
        out["cli"] = cli_phase(cfg, params, ckpt, tmp)
    del backbone, params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 33 to 36: the moe family, granite-moe-1b-a400m
# ---------------------------------------------------------------------------

# granite-moe-1b-a400m's published widths: layers, d_model, heads, kv
# heads, head dim, experts, top-k, d_ff_expert, vocab, tied embeddings
GRANITE = (24, 1024, 16, 8, 64, 32, 8, 512, 49155, True)


def granite_config(**kw):
    from repro_torch.configs.base import get_config
    cfg = get_config("granite-moe-1b-a400m")
    m = cfg.moe
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim_, m.n_experts, m.top_k, m.d_ff_expert,
           cfg.vocab_size, cfg.tie_embeddings) == GRANITE
          and cfg.dtype == "bfloat16",
          "granite-moe-1b-a400m is not at its published size")
    return cfg.with_(**kw) if kw else cfg


def no_dropping(cfg):
    """``capacity_factor=-1``: every expert takes all T k assignments, so
    a ragged wave routes each row as it would alone."""
    return cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=-1))


def moe_step_launches(cfg, bank: bool, paged: bool) -> dict:
    """The launches one decode step must make: per layer one decode call
    (the paged kernel on a paged cache) and one LoRA launch a target (the
    rows kernel from a bank); the moe FFN (router, sort, dispatch, three
    bmm, combine) launches no kernel of the port."""
    from repro_torch.kernels import ops
    n, t = cfg.n_layers, len(cfg.peft.lora_targets)
    want = dict.fromkeys(ops.launch_counts(), 0)
    want["flash_decode_paged" if paged else "flash_decode"] = n
    want["lora_bgmv_rows" if bank else "lora_matmul"] = n * t
    return want


def moe_drain_launches_ok(cfg, launches: dict, stats, what: str,
                          bank: bool, admits: dict | None = None) -> int:
    """A drain's launches: per prefill or refill (``stats.waves`` on a
    dense cache; ``admits["dense"]`` on a paged one) flash_attention once
    a layer and the prefill's LoRA kernel once a target a layer; per
    prefix-hit suffix (``admits["suffix"]``, paged) the LoRA kernel once
    a target a layer (its attention over the pool is torch's, as the
    reference's is XLA); per decode step :func:`moe_step_launches`.
    Returns the decode steps, read off the decode launches."""
    n, t = cfg.n_layers, len(cfg.peft.lora_targets)
    paged = admits is not None
    steps, rest = divmod(
        launches["flash_decode_paged" if paged else "flash_decode"], n)
    want = moe_step_launches(cfg, bank, paged=paged)
    want = {k: v * steps for k, v in want.items()}
    dense = admits["dense"] if paged else stats.waves
    seqs = dense + (admits["suffix"] if paged else 0)
    want["flash_attention"] = n * dense
    want["lora_bgmv_seq" if bank else "lora_matmul"] += n * t * seqs
    check(rest == 0 and steps > 0 and launches == want,
          f"{what}: launches {launches}, predicted {want} ({stats.waves} "
          f"waves, admissions {admits}, {steps} decode steps)")
    return steps


class admissions:
    """Counts the paged engine's admissions while active: ``dense``, a
    prefill or in-wave refill of whole prompts (``model.paged_wave_prefill``
    / ``paged_refill``); ``suffix``, the prefix-hit rows' suffix chunk
    (``model.paged_suffix``)."""
    KINDS = {"paged_wave_prefill": "dense", "paged_refill": "dense",
             "paged_suffix": "suffix"}

    def __enter__(self):
        from repro_torch.models import model as M
        self.counts = {"dense": 0, "suffix": 0}
        self.saved = {f: getattr(M, f) for f in self.KINDS}
        for f, kind in self.KINDS.items():
            setattr(M, f, self._counted(self.saved[f], kind))
        return self.counts

    def _counted(self, fn, kind):
        def counted(*a, **k):
            self.counts[kind] += 1
            return fn(*a, **k)
        return counted

    def __exit__(self, *exc):
        from repro_torch.models import model as M
        for f, fn in self.saved.items():
            setattr(M, f, fn)


def step_profile(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the device kernels it
    launches (every one, the port's and torch's), their summed device
    time, and the five largest by device time (us)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(evs, key=lambda e: -e.device_time_total)[:5]
    return dict(kernels=sum(e.count for e in evs),
                device_us=sum(e.device_time_total for e in evs),
                top={e.key[:60]: round(e.device_time_total, 1) for e in top})


def routing_spy():
    """Records the experts ``moe.top_k`` picks, call by call, while active
    (the moe layers' routing decisions)."""
    from repro_torch.models import moe

    class Spy:
        def __enter__(self):
            self.picks, self.fn = [], moe.top_k

            def spy(probs, k):
                v, i = self.fn(probs, k)
                self.picks.append(i)
                return v, i
            moe.top_k = spy
            return self.picks

        def __exit__(self, *exc):
            moe.top_k = self.fn
    return Spy()


def routing_agreement(a: list, b: list) -> float:
    """The share of (token, slot) routing decisions two runs share: per
    token and layer, the experts both picked over k."""
    same = total = 0
    for x, y in zip(a, b):
        xs, ys = x.sort(-1).values, y.sort(-1).values
        hit = (xs[..., :, None] == ys[..., None, :]).any(-1)
        same += int(hit.sum())
        total += hit.numel()
    return same / max(total, 1)


def moe_path(seed: int, total: dict) -> dict:
    """Phases 33 and 34 (full depth): granite-moe-1b-a400m at its
    published size drains phase 4's queue shape single-tenant, from a
    4-domain bank and paged with prefix sharing from the bank, launches
    as predicted; two bf16 prefills of one batch give the same bits; the
    kernel path's logits and routing against the plain path's,
    recorded."""
    from repro_torch.core.adapter_bank import AdapterBank
    from repro_torch.core.paged import PagedSpec
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.models import model as M

    cfg = granite_config()
    t0 = time.perf_counter()
    params = M.init(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params["backbone"]))
    check(n_params == cfg.param_count(),
          f"moe: {n_params} params, param_count {cfg.param_count()}")
    log(f"moe: granite-moe-1b-a400m init {n_params / 1e9:.3f} B params in "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(seed)
    reqs = queue(rng, 16, (32, 513), (16, 65), cfg.vocab_size)
    rec = {"config": f"granite-moe-1b-a400m {cfg.n_layers} layers d "
                     f"{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} x "
                     f"{cfg.head_dim_} experts {cfg.moe.n_experts} top-"
                     f"{cfg.moe.top_k} d_ff_expert {cfg.moe.d_ff_expert} "
                     f"{cfg.dtype}, {n_params} params"}

    # one decode step of an 8-slot wave, its launches against the
    # prediction and its time (host clock, synchronised)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 64)),
                           device="cuda")
    _, caches = M.prefill(params, {"tokens": toks}, cfg, max_len=128)
    tok = toks[:, -1:].to(torch.int32)
    pos = torch.full((8,), 64, dtype=torch.int32, device="cuda")

    def step():
        return M.decode_step(params, tok, caches, pos, cfg)

    step()
    _, n = counted(total, step)
    want = moe_step_launches(cfg, bank=False, paged=False)
    check(n == want, f"moe: a decode step launched {n}, predicted {want}")
    step_times: dict = {}
    for _ in range(5):
        host_ms(step_times, "step", step)
    step_ms = float(np.median(step_times["step"]))
    log(f"moe: one decode step of 8 slots launches {n} (predicted "
        f"{ {k: v for k, v in want.items() if v} }, every other kernel 0); "
        f"{step_ms:.2f} ms a step (median of 5, host clock, synchronised)")
    prof = step_profile(step)
    log(f"moe: one decode step under torch.profiler: {prof['kernels']} "
        f"device kernels, {prof['device_us']:.0f} us of device time "
        f"({prof['device_us'] / 1e3 / step_ms:.3f} of the step's host ms); "
        f"largest {prof['top']}")
    rec.update(step_launches=n, step_ms=step_ms, step_profile=prof)
    del caches

    # phase 33: the drains
    torch.cuda.reset_peak_memory_stats()
    plain: dict = {}
    with plain_calls(serving=True) as p:
        (comps, stats), launches = counted(
            total, lambda: drain(cfg, params, reqs, slots=8))
    plain["single"] = dict(p)
    r = drain_record(stats, launches, torch.cuda.max_memory_allocated())
    served_ok(cfg, comps, reqs, "moe")
    r["decode_steps"] = moe_drain_launches_ok(cfg, launches, stats, "moe",
                                              bank=False)
    check(stats.waves > 1, "moe: no in-wave refill happened")
    log(f"moe: single-tenant {drain_line(r)}; per-token p50 "
        f"{r['tok_latency_p50_s'] * 1e3:.1f} ms")
    rec["single"] = r

    bank = AdapterBank.create(domain_adapters(cfg, seed + 1))
    sp = bank.serving_params(params["backbone"])
    doms = [bank.domains[int(i)] for i in np.random.default_rng(
        seed + 10).integers(0, N_DOMAINS, len(reqs))]
    torch.cuda.reset_peak_memory_stats()
    with plain_calls(serving=True) as p:
        (bcomps, bstats), bl = counted(total, lambda: drain(
            cfg, sp, reqs, slots=8, bank=bank, domains=doms))
    plain["bank"] = dict(p)
    br = drain_record(bstats, bl, torch.cuda.max_memory_allocated())
    served_ok(cfg, bcomps, reqs, "moe bank")
    br["decode_steps"] = moe_drain_launches_ok(cfg, bl, bstats, "moe bank",
                                               bank=True)
    log(f"moe bank: {N_DOMAINS} domains, mix "
        f"{[doms.count(d) for d in bank.domains]}: {drain_line(br)}")
    rec["bank"] = br

    preqs, pdoms = paged_queue(np.random.default_rng(seed + 20), bank, 16,
                               (32, 257), (16, 65), cfg.vocab_size, 256)
    eng = DecodeEngine(cfg, slots=8, bank=bank, device="cuda",
                       paged=PagedSpec(n_blocks=512, block_size=16,
                                       share_prefix=True))
    torch.cuda.reset_peak_memory_stats()
    with plain_calls(serving=True) as p, admissions() as adm:
        (pcomps, pstats), pl = counted(total, lambda: serve_on(
            eng, sp, preqs, pdoms))
    plain["paged"] = dict(p)
    pr = drain_record(pstats, pl, torch.cuda.max_memory_allocated())
    served_ok(cfg, pcomps, preqs, "moe paged")
    p_steps = moe_drain_launches_ok(cfg, pl, pstats, "moe paged", bank=True,
                                    admits=adm)
    check(pstats.prefix_hits > 0 and adm["suffix"] > 0,
          f"moe paged: no prefix was shared ({adm})")
    check(eng._alloc.used_blocks == 0, "moe paged: blocks still held")
    eng._alloc.check()
    pr.update(decode_steps=p_steps, admissions=dict(adm),
              prefix_hits=pstats.prefix_hits,
              prefix_hit_tokens=pstats.prefix_hit_tokens,
              pool_peak_blocks=pstats.pool_peak_blocks)
    log(f"moe paged: {N_DOMAINS} domains x 4 requests sharing a 256-token "
        f"system prompt: {drain_line(pr)}; prefix hits {pstats.prefix_hits}"
        f" ({pstats.prefix_hit_tokens} tokens), pool peak "
        f"{pstats.pool_peak_blocks} blocks; {adm['dense']} dense "
        f"admissions and {adm['suffix']} suffix chunks, launches as "
        f"predicted")
    rec["paged"] = pr
    check(all(v == 0 for d in plain.values() for v in d.values()),
          f"moe: a plain version ran on the card: {plain}")
    del eng, bank, sp
    no_pad_copies("phase 33")

    # phase 34, full depth: the dispatch and combine repeat their bits;
    # the kernel path against the plain path, recorded (a bf16 ulp in
    # attention can flip the 8th expert of a token)
    ptoks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 256)),
                            device="cuda")
    with routing_spy() as kpicks:
        (k1, _), _ = counted(total, lambda: M.prefill(
            params, {"tokens": ptoks}, cfg))
    k2, _ = M.prefill(params, {"tokens": ptoks}, cfg)
    check(torch.equal(k1, k2), "moe: two bf16 prefills of one batch differ")
    with ops.backend("torch"), routing_spy() as ppicks:
        pl_, _ = M.prefill(params, {"tokens": ptoks}, cfg)
    cos = F.cosine_similarity(k1.flatten(1), pl_.flatten(1), dim=1)
    top1 = (k1.argmax(-1) == pl_.argmax(-1)).float().mean().item()
    agree = routing_agreement(kpicks, ppicks)
    check(bool(torch.isfinite(k1).all()) and len(kpicks) == cfg.n_layers,
          f"moe: full-depth prefill logits not finite, or {len(kpicks)} "
          f"routed layers")
    log(f"moe: full-depth bf16 prefill (4 x 256): two runs bit-equal; "
        f"kernels vs plain, recorded: cosine per row "
        f"{['%.6f' % c for c in cos.tolist()]}, top-1 agreement {top1:.4f},"
        f" routing decisions shared {agree:.6f}")
    rec.update(prefill_bits_repeat=True,
               prefill_logits_cosine=cos.tolist(), prefill_top1=top1,
               routing_agreement=agree)
    del params
    torch.cuda.empty_cache()
    return rec


def moe_exactness(seed: int, total: dict) -> dict:
    """Phase 34 at 2 layers: granite at full width in f32 with no
    dropping: a ragged drain through the kernels gives the plain path's
    tokens and each request's solo tokens, and the paged drain with
    prefix sharing gives the dense drain's."""
    from repro_torch.core.paged import PagedSpec
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.models import model as M

    cfg = no_dropping(granite_config(n_layers=2, dtype="float32"))
    params = M.init(cfg, seed, device="cuda")
    rng = np.random.default_rng(seed + 1)
    system = rng.integers(0, cfg.vocab_size, 64).astype(np.int32)
    reqs = [(np.concatenate([system, p]), g) for p, g in queue(
        rng, 8, (8, 97), (4, 17), cfg.vocab_size)]
    (kern, st), _ = counted(total, lambda: drain(cfg, params, reqs,
                                                 slots=4))
    with ops.backend("torch"):
        plain, _ = drain(cfg, params, reqs, slots=4)
    eng = DecodeEngine(cfg, slots=4, device="cuda",
                       paged=PagedSpec(n_blocks=128, block_size=16,
                                       share_prefix=True))
    (paged, pst), pn = counted(total, lambda: serve_on(eng, params, reqs))
    check(pn["flash_decode_paged"] > 0 and pn["flash_decode"] == 0
          and pst.prefix_hits > 0, f"moe e2e paged: launches {pn}, prefix "
                                   f"hits {pst.prefix_hits}")
    for i, ((p, g), a, b, c) in enumerate(zip(reqs, kern, plain, paged)):
        solo = M.generate(params, cfg, torch.as_tensor(p[None],
                                                       device="cuda"),
                          gen=g)[0].cpu().numpy()
        check(np.array_equal(a.tokens, b.tokens)
              and np.array_equal(a.tokens, c.tokens)
              and np.array_equal(a.tokens, solo),
              f"moe e2e f32: request {i}: kernels {a.tokens}, plain "
              f"{b.tokens}, paged {c.tokens}, solo {solo}")
    log(f"moe e2e: 2-layer f32 granite (no dropping), {len(reqs)} requests "
        f"sharing a 64-token prefix, {st.waves} waves: kernel tokens == "
        f"plain tokens == paged ({pst.prefix_hits} prefix hits) == solo "
        f"generate")
    del params
    torch.cuda.empty_cache()
    return dict(requests=len(reqs), waves=st.waves, tokens_equal=True,
                paged_prefix_hits=pst.prefix_hits)


def moe_kernel_cases(timer: Timer, cases: dict, seed: int) -> None:
    """Phase 36: kernels 1 to 7 at granite-moe-1b-a400m's shapes on the
    moe path, in bf16, each against its plain version, with its time, one
    library call's and its bound (into ``cases``): lora_matmul at K 1024
    to N 1024 (q) and 512 (v) at decode (8 rows) and prefill (8 x 512);
    flash_attention at head dim 64 with 16 / 8 heads (GQA group 2), a
    512-token prefill behind 16 prefix slots; flash_decode at the same
    heads against a 1024-slot cache and the 16-slot prefix bank;
    flash_decode_paged at the same heads in blocks of 16; the bank's
    lora_bgmv_rows (8 rows) and lora_bgmv_seq (8 x 512) at K 1024 to N
    1024 and 512 over 4 slots; lora_matmul_bwd at the round's M 1024, K
    1024 to N 1024 and 512."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 36)
    randn = randn_of(gen)
    dtype, K, tag = torch.bfloat16, 1024, "granite "
    for M_, N in ((8, 1024), (8, 512), (4096, 1024), (4096, 512)):
        lora_case(cases, randn, timer, M_, K, N, dtype, tag)
    B, S, n_p, Hq, Hkv, D = 8, 512, 16, 16, 8, 64
    attn_case(cases, randn, timer, B, S, n_p, Hq, Hkv, D, dtype,
              label="granite causal")
    Tc = 1024
    q, kc, vc, qp, kpc, pk, pv = decode_inputs(randn, gen, B, Tc, n_p, Hq,
                                               Hkv, D, dtype)
    decode_case(cases, timer, q, kc, vc, qp, kpc, pk, pv, 0,
                f"granite B={B} T={Tc}+{n_p} prefix Hq={Hq} Hkv={Hkv} "
                f"D={D} per-row q_pos")
    paged_case(cases, randn, gen, timer, Hq, Hkv, D, dtype, tag)
    for name, lead in (("lora_bgmv_rows", (8,)), ("lora_bgmv_seq", (8, 512))):
        for N in (1024, 512):
            bgmv_case(cases, randn, timer, name, lead, K, N, dtype, tag)
    for N, proj in ((1024, "q"), (512, "v")):
        cases["lora_matmul_bwd"].append(lora_bwd_case(
            randn, timer, 1024, K, N, 8, dtype, f" (granite's {proj})"))


def moe_phases(seed: int) -> dict:
    """Phases 33 to 35 on granite-moe-1b-a400m; every launch is counted
    into the ``moe`` path's record."""
    total: dict = {}
    t0 = time.perf_counter()
    rec = moe_path(seed, total)
    rec["e2e"] = moe_exactness(seed, total)
    # phase 35: one HFSL round at the published size, as phase 9 runs
    # qwen2-7b (a 5-class head, 2 clusters, 4 steps, batch 4, seq 256),
    # then an f32 2-layer round kernels against plain
    cfg = granite_config(peft=dataclasses.replace(
        granite_config().peft, head_dim_out=5))
    tr = train_round("moe train", cfg, n_clusters=2, steps=4, batch=4,
                     sync_every=2, task_args=(5, 1000, 256, 0.5), seed=seed)
    for k, v in tr["launches"].items():
        total[k] = total.get(k, 0) + v
    no_pad_copies("phase 35")
    rec["train"] = tr
    rec["train_e2e"] = f32_round_exactness(
        "moe train e2e", cfg.with_(n_layers=2, dtype="float32"), seed)
    rec["launches"] = total
    rec["s"] = time.perf_counter() - t0
    log(f"moe (phases 33-35): {rec['s']:.1f}s; launches {total}")
    return rec


# ---------------------------------------------------------------------------
# phases 37 to 40: the vlm and audio families
# ---------------------------------------------------------------------------

# llava-next-mistral-7b: layers, d_model, heads, kv heads, head dim, d_ff,
# vocab, sliding window, vision rows
LLAVA = (32, 4096, 32, 8, 128, 14336, 32000, 4096, 576)
# whisper-small: encoder layers, decoder layers, d_model, heads, kv heads,
# head dim, d_ff, vocab, frames
WHISPER = (12, 12, 768, 12, 12, 64, 3072, 51865, 1500)


def llava_config(**kw):
    from repro_torch.configs.base import get_config
    cfg = get_config("llava-next-mistral-7b")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim_, cfg.d_ff, cfg.vocab_size, cfg.sliding_window,
           cfg.vlm.n_vis_tokens) == LLAVA
          and cfg.attn_variant == "sliding" and cfg.dtype == "bfloat16",
          "llava-next-mistral-7b is not at its published size")
    return cfg.with_(**kw) if kw else cfg


def whisper_config(**kw):
    from repro_torch.configs.base import get_config
    cfg = get_config("whisper-small")
    check((cfg.audio.n_enc_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
           cfg.n_kv_heads, cfg.head_dim_, cfg.d_ff, cfg.vocab_size,
           cfg.audio.n_audio_frames) == WHISPER and cfg.dtype == "bfloat16",
          "whisper-small is not at its published size")
    return cfg.with_(**kw) if kw else cfg


def modality_rows(cfg, seed: int, n: int) -> list:
    """One modality row a request, drawn from the seed x 0.1 on the card in
    the model's dtype: ``vision_embeds`` (576, d) for a vlm, ``frames``
    (n_frames, d) for an audio model."""
    key, rows = (("vision_embeds", cfg.vlm.n_vis_tokens)
                 if cfg.family == "vlm"
                 else ("frames", cfg.audio.n_audio_frames))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((n, rows, cfg.d_model), generator=gen, device="cuda")
         * 0.1).to(getattr(torch, cfg.dtype))
    return [{key: x[i]} for i in range(n)]


class model_calls:
    """Counts the engine's admissions (``model.wave_prefill`` and
    ``model.refill``) and the decode steps (``model.decode_step``) while
    active."""
    KINDS = {"wave_prefill": "admits", "refill": "admits",
             "decode_step": "steps"}

    def __enter__(self):
        from repro_torch.models import model as M
        self.counts = {"admits": 0, "steps": 0}
        self.saved = {f: getattr(M, f) for f in self.KINDS}
        for f, kind in self.KINDS.items():
            setattr(M, f, self._counted(self.saved[f], kind))
        return self.counts

    def _counted(self, fn, kind):
        def counted(*a, **k):
            self.counts[kind] += 1
            return fn(*a, **k)
        return counted

    def __exit__(self, *exc):
        from repro_torch.models import model as M
        for f, fn in self.saved.items():
            setattr(M, f, fn)


def family_launches(cfg, bank: bool, admits: int, steps: int) -> dict:
    """The launches of ``admits`` prefills or refills and ``steps`` decode
    steps. vlm: an admission runs flash_attention once a layer and the
    LoRA kernel (``lora_matmul``; a bank's ``lora_bgmv_seq``) once a
    target a layer; a step flash_decode once a layer and the LoRA kernel
    (``lora_matmul``; ``lora_bgmv_rows``) once a target a layer. audio: an
    admission runs flash_attention once an encoder layer and twice a
    decoder layer (self, causal, and cross, not), ``lora_matmul`` once a
    target an encoder or decoder layer (cross attention has no adapter); a
    step flash_decode twice a decoder layer (self causal, cross not) and
    ``lora_matmul`` once a target a decoder layer."""
    from repro_torch.kernels import ops
    n, t = cfg.n_layers, len(cfg.peft.lora_targets)
    want = dict.fromkeys(ops.launch_counts(), 0)
    if cfg.family == "audio":
        ne = cfg.audio.n_enc_layers
        want["flash_attention"] = admits * (ne + 2 * n)
        want["flash_decode"] = steps * 2 * n
        want["lora_matmul"] = t * (admits * (ne + n) + steps * n)
    else:
        want["flash_attention"] = admits * n
        want["flash_decode"] = steps * n
        if bank:
            want["lora_bgmv_seq"] = admits * n * t
            want["lora_bgmv_rows"] = steps * n * t
        else:
            want["lora_matmul"] = (admits + steps) * n * t
    return want


def family_drain(what: str, cfg, params, reqs, rows, total: dict, *,
                 bank=None, domains=None, slots: int = 8) -> tuple:
    """One drain of ``reqs`` with their modality ``rows``, its launches
    held to :func:`family_launches` for the admissions and decode steps
    it made, no plain version run; returns (completions, record)."""
    torch.cuda.reset_peak_memory_stats()
    with plain_calls(serving=True) as p, model_calls() as mc:
        (comps, stats), launches = counted(total, lambda: drain(
            cfg, params, reqs, slots, bank=bank, domains=domains,
            extras=rows))
    r = drain_record(stats, launches, torch.cuda.max_memory_allocated())
    served_ok(cfg, comps, reqs, what)
    want = family_launches(cfg, bank is not None, mc["admits"], mc["steps"])
    check(launches == want and mc["admits"] == stats.waves > 1,
          f"{what}: launches {launches}, predicted {want} ({stats.waves} "
          f"waves, {mc})")
    check(all(v == 0 for v in p.values()),
          f"{what}: a plain version ran on the card: {dict(p)}")
    r.update(admissions=mc["admits"], decode_steps=mc["steps"])
    log(f"{what}: {drain_line(r)}; {mc['admits']} admissions and "
        f"{mc['steps']} decode steps, launches as predicted; per-token p50 "
        f"{r['tok_latency_p50_s'] * 1e3:.1f} ms")
    return comps, r


def full_depth_logits(what: str, cfg, params, reqs, rows) -> dict:
    """Two requests' prefill logits at full depth through the kernels
    against the plain versions (bf16: cosine and top-1, recorded; the
    cosine must pass 0.99)."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    n = min(len(r[0]) for r in reqs[:2])
    batch = {"tokens": torch.as_tensor(np.stack([r[0][:n] for r in reqs[:2]]),
                                       device="cuda")}
    for k in rows[0]:
        batch[k] = torch.stack([rows[0][k], rows[1][k]])
    kl, _ = M.prefill(params, batch, cfg)
    with ops.backend("torch"):
        pl, _ = M.prefill(params, batch, cfg)
    cos = F.cosine_similarity(kl.flatten(1), pl.flatten(1), dim=1)
    top1 = (kl.argmax(-1) == pl.argmax(-1)).float().mean().item()
    check(bool(torch.isfinite(kl).all()) and bool((cos > 0.99).all()),
          f"{what}: full-depth prefill logits kernels vs plain cosine "
          f"{cos.tolist()}")
    log(f"{what}: full-depth bf16 prefill (2 x {n} tokens with their rows) "
        f"kernels vs plain: cosine {['%.6f' % c for c in cos.tolist()]}, "
        f"top-1 agreement {top1:.2f}")
    return dict(prefill_logits_cosine=cos.tolist(), prefill_top1=top1)


def vlm_path(seed: int, total: dict) -> dict:
    """Phase 37: llava-next-mistral-7b at its published size drains phase
    4's queue shape, each request with its own (576, 4096) vision row,
    single-tenant and from a 4-domain AdapterBank."""
    from repro_torch.core.adapter_bank import AdapterBank
    from repro_torch.models import model as M

    cfg = llava_config()
    t0 = time.perf_counter()
    params = M.init(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params["backbone"]))
    check(n_params == cfg.param_count(),
          f"vlm: {n_params} params, param_count {cfg.param_count()}")
    log(f"vlm: llava-next-mistral-7b init {n_params / 1e9:.3f} B params "
        f"({sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9:.2f} GB) "
        f"in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(seed)
    reqs = queue(rng, 16, (32, 513), (16, 65), cfg.vocab_size)
    rows = modality_rows(cfg, seed + 37, len(reqs))
    rec = {"config": f"llava-next-mistral-7b {cfg.n_layers} layers d "
                     f"{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} x "
                     f"{cfg.head_dim_} d_ff {cfg.d_ff} window "
                     f"{cfg.sliding_window} vision rows "
                     f"{cfg.vlm.n_vis_tokens} {cfg.dtype}, {n_params} params"}
    _, rec["single"] = family_drain("vlm", cfg, params, reqs, rows, total)
    bank = AdapterBank.create(domain_adapters(cfg, seed + 1))
    sp = bank.serving_params(params["backbone"])
    doms = [bank.domains[int(i)] for i in np.random.default_rng(
        seed + 10).integers(0, N_DOMAINS, len(reqs))]
    bcomps, rec["bank"] = family_drain("vlm bank", cfg, sp, reqs, rows,
                                       total, bank=bank, domains=doms)
    check(len({tuple(c.tokens[:8]) for c in bcomps}) > 1,
          "vlm bank: every request gave the same tokens")
    rec.update(full_depth_logits("vlm", cfg, params, reqs, rows))
    no_pad_copies("phase 37")
    del params, bank, sp
    torch.cuda.empty_cache()
    return rec


def audio_path(seed: int, total: dict) -> dict:
    """Phase 38: whisper-small at its published size drains 16 requests,
    each with its own (1500, 768) frames row."""
    from repro_torch.models import model as M

    cfg = whisper_config()
    t0 = time.perf_counter()
    params = M.init(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params["backbone"]))
    log(f"audio: whisper-small init {n_params / 1e6:.1f} M params (the "
        f"reference's 32768 learned decoder positions included; "
        f"param_count {cfg.param_count() / 1e6:.1f} M counts none) in "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(seed + 38)
    reqs = queue(rng, 16, (4, 65), (16, 65), cfg.vocab_size)
    rows = modality_rows(cfg, seed + 38, len(reqs))
    rec = {"config": f"whisper-small {cfg.audio.n_enc_layers} + "
                     f"{cfg.n_layers} layers d {cfg.d_model} heads "
                     f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim_} "
                     f"frames {cfg.audio.n_audio_frames} vocab "
                     f"{cfg.vocab_size} {cfg.dtype}, {n_params} params"}
    _, rec["single"] = family_drain("audio", cfg, params, reqs, rows, total)
    spec = M.cache_spec(cfg, 8, 128)["cross"]
    rec["cross_cache_gb"] = sum(
        int(np.prod(s.shape)) * torch.tensor([], dtype=s.dtype)
        .element_size() for s in spec.values()) / 1e9
    log(f"audio: the cross cache of 8 slots holds "
        f"{rec['cross_cache_gb']:.3f} GB")
    rec.update(full_depth_logits("audio", cfg, params, reqs, rows))
    no_pad_copies("phase 38")
    del params
    torch.cuda.empty_cache()
    return rec


def family_exactness(seed: int, totals: dict) -> dict:
    """Phase 39: 2-layer llava at full width and 2 + 2-layer whisper, f32:
    a ragged drain through the kernels gives the plain versions' tokens
    and each request's solo ``generate`` with its own row; one llava
    request's 576 + 3,520 prompt and 64 generated tokens cross the 4096
    window (the rolling buffer wraps). Then the refusals: mismatched
    extras keys, paged serving and speculative decoding of both
    families. Launches are counted into ``totals[what]``."""
    import dataclasses as dc

    from repro_torch.core.paged import PagedSpec
    from repro_torch.core.spec_decode import SpecDecoder
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.models import model as M

    rec = {}
    for what, cfg, long in (
            ("vlm e2e", llava_config(n_layers=2, dtype="float32"), 3520),
            ("audio e2e", whisper_config(
                n_layers=2, dtype="float32",
                audio=dc.replace(whisper_config().audio, n_enc_layers=2)),
             0)):
        params = M.init(cfg, seed, device="cuda")
        rng = np.random.default_rng(seed + 39)
        reqs = queue(rng, 5, (8, 97), (4, 17), cfg.vocab_size)
        if long:
            reqs.append((rng.integers(0, cfg.vocab_size, long)
                         .astype(np.int32), 64))
        rows = modality_rows(cfg, seed + 39, len(reqs))
        (kern, st), n = counted(totals[what], lambda: drain(
            cfg, params, reqs, 2, extras=rows))
        check(n["flash_attention"] > 0 and n["flash_decode"] > 0
              and st.waves > 1, f"{what}: launches {n}, {st.waves} waves")
        with ops.backend("torch"):
            plain, _ = drain(cfg, params, reqs, 2, extras=rows)
        for i, ((p, g), a, b) in enumerate(zip(reqs, kern, plain)):
            solo = M.generate(params, cfg, torch.as_tensor(
                p[None], device="cuda"), gen=g, extra_batch={
                k: r[None] for k, r in rows[i].items()})[0].cpu().numpy()
            check(np.array_equal(a.tokens, b.tokens)
                  and np.array_equal(a.tokens, solo),
                  f"{what}: request {i}: kernels {a.tokens}, plain "
                  f"{b.tokens}, solo {solo}")
        past = (cfg.vlm.n_vis_tokens + long + 64 - cfg.sliding_window
                if long else 0)
        log(f"{what}: {cfg.n_layers}-layer f32 ({cfg.d_model} wide), "
            f"{len(reqs)} requests with their own rows, {st.waves} waves: "
            f"kernel tokens == plain tokens == solo generate"
            + (f"; one request ran {past} tokens past the "
               f"{cfg.sliding_window}-slot window" if long else ""))
        rec[what] = dict(requests=len(reqs), waves=st.waves,
                         tokens_equal=True, past_window=past)
        eng = DecodeEngine(cfg, slots=2, device="cuda")
        eng.submit(reqs[0][0], 2, extras=rows[0])
        eng.submit(reqs[1][0], 2)
        refused = []
        try:
            eng.run(params)
        except ValueError as e:
            refused.append(f"extras: {e}")
        try:
            DecodeEngine(cfg, slots=2, device="cuda",
                         paged=PagedSpec(n_blocks=16, block_size=16))
        except ValueError as e:
            refused.append(f"paged: {e}")
        try:
            DecodeEngine(cfg, slots=2, device="cuda", spec=SpecDecoder.init(
                cfg, seed, device="cuda", k=2))
        except NotImplementedError as e:
            refused.append(f"spec: {e}")
        check(len(refused) == 3, f"{what}: refusals {refused}")
        log(f"{what}: refused as the reference does: {refused}")
        rec[what]["refusals"] = refused
        del params
        torch.cuda.empty_cache()
    return rec


def family_kernel_cases(timer: Timer, cases: dict, seed: int) -> None:
    """Phase 40: the kernels at these families' shapes in bf16, each
    against its plain version, with its time, one library call's and its
    bound (into ``cases``): flash_attention non-causal at whisper's
    encoder (B 8, 1500 frames behind 16 prefix slots, 12 / 12 heads of
    64), its cross attention (64 decoder rows against 1500 frames) and
    llava's windowed prefill (576 vision rows + 512 tokens behind 16
    prefix slots, 32 / 8 heads of 128, window 4096); flash_decode non-
    causal against whisper's cross cache (B 8, T 1500) and at llava's
    rolling buffer (4096 slots, 1152 positions written, 16 prefix slots);
    lora_matmul at K 4096 (N 4096 and 1024, M 8 and 8 x 1088) and K 768
    (N 768, M 8 and 8 x 1500); both lora_bgmv kernels at K 4096 and 768
    over 4 slots."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 40)
    randn = randn_of(gen)
    dtype = torch.bfloat16
    attn_case(cases, randn, timer, 8, 1500, 16, 12, 12, 64, dtype,
              label="whisper encoder non-causal", causal=False)
    attn_case(cases, randn, timer, 8, 64, 0, 12, 12, 64, dtype,
              label="whisper cross non-causal", causal=False, n_keys=1500)
    attn_case(cases, randn, timer, 8, 576 + 512, 16, 32, 8, 128, dtype,
              label="llava window 4096", window=4096)
    B, F_, Hkv, D = 8, 1500, 12, 64
    q = randn(B, 12, D, dtype=dtype)
    kc, vc = randn(B, F_, Hkv, D, dtype=dtype), randn(B, F_, Hkv, D,
                                                      dtype=dtype)
    qp = torch.randint(4, 128, (B,), generator=gen, device="cuda",
                       dtype=torch.int32)
    kpc = torch.arange(F_, dtype=torch.int32, device="cuda")[None] \
        .expand(B, F_).contiguous()
    decode_case(cases, timer, q, kc, vc, qp, kpc, None, None, 0,
                f"whisper cross B={B} T={F_} Hq=12 Hkv={Hkv} D={D} "
                f"non-causal", causal=False)
    W, n_p = 4096, 16
    q, kc, vc, _, _, pk, pv = decode_inputs(randn, gen, B, W, n_p, 32, 8,
                                            128, dtype)
    qp = torch.randint(576 + 32, 1152, (B,), generator=gen, device="cuda",
                       dtype=torch.int32)
    slots = torch.arange(W, dtype=torch.int32, device="cuda")[None]
    kpc = torch.where(slots <= qp[:, None], slots,
                      torch.full_like(slots, 10 ** 9)).contiguous()
    decode_case(cases, timer, q, kc, vc, qp, kpc, pk, pv, W,
                f"llava B={B} T={W} (rolling buffer, <= 1152 written)"
                f"+{n_p} prefix Hq=32 Hkv=8 D=128 window {W}")
    for K, shapes, tag in ((4096, ((8, 4096), (8, 1024), (8 * 1088, 4096),
                                   (8 * 1088, 1024)), "llava "),
                           (768, ((8, 768), (8 * 1500, 768)), "whisper ")):
        for M_, N in shapes:
            lora_case(cases, randn, timer, M_, K, N, dtype, tag)
    for K, Ns, S, tag in ((4096, (4096, 1024), 1088, "llava "),
                          (768, (768,), 64, "whisper ")):
        for name, lead in (("lora_bgmv_rows", (8,)),
                           ("lora_bgmv_seq", (8, S))):
            for N in Ns:
                bgmv_case(cases, randn, timer, name, lead, K, N, dtype, tag)


def family_phases(seed: int) -> dict:
    """Phases 37 to 39; each phase's launches are counted into its path's
    record (``vlm``: 37 and the llava half of 39; ``audio``: 38 and the
    whisper half)."""
    t0 = time.perf_counter()
    vlm_total: dict = {}
    audio_total: dict = {}
    vlm = vlm_path(seed, vlm_total)
    audio = audio_path(seed, audio_total)
    e2e = family_exactness(seed, {"vlm e2e": vlm_total,
                                  "audio e2e": audio_total})
    vlm["e2e"], audio["e2e"] = e2e["vlm e2e"], e2e["audio e2e"]
    vlm["launches"], audio["launches"] = vlm_total, audio_total
    s = time.perf_counter() - t0
    log(f"vlm and audio (phases 37-39): {s:.1f}s; launches vlm {vlm_total}, "
        f"audio {audio_total}")
    return {"vlm": vlm, "audio": audio, "family_s": s}


# ---------------------------------------------------------------------------
# phases 41 to 44: the tools
# ---------------------------------------------------------------------------

# phase 42's steps: the dry-run's one-data-row shapes of qwen2-7b, and one
# decode step of llava and whisper at phases 37-38's drain shapes (8
# slots; llava's 4096-slot rolling buffer, whisper's 128-slot self cache
# beside its 1500 cross frames); each with the steps it is timed over
# (the device-bound prefill, 3.3 s a step, spreads by under 1 %)
PROFILES = (("qwen2-7b", "decode_32k", 5), ("qwen2-7b", "prefill_32k", 2),
            ("qwen2-7b", "train_4k", 5),
            ("llava-next-mistral-7b", ("decode_4096", 4096, 8, "decode"), 5),
            ("whisper-small", ("decode_128", 128, 8, "decode"), 5))
EXAMPLES = ("quickstart", "hfsl_finetune", "integrated_runtime",
            "scheduler_demo", "sl_inference")
EXAMPLE_TIMEOUT_S = 400


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def dryrun_start(out: str) -> subprocess.Popen:
    """Phase 41, started in the background: the dry-run over every
    ASSIGNED x INPUT_SHAPES pair on ``meta`` (host work only)."""
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--json", out], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def dryrun_phase(proc: subprocess.Popen, out: str) -> dict:
    """Phase 41's result: each pair ok or skipped, none an error."""
    text, _ = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"phase 41: the dry-run sweep exited "
          f"{proc.returncode}:\n{text[-4000:]}")
    results = json.loads(Path(out).read_text())
    from repro_torch.launch import dryrun
    check(len(results) == len(dryrun.ASSIGNED) * 4,
          f"phase 41: {len(results)} pairs")
    for r in results:
        check(r["status"] in ("ok", "skipped"),
              f"phase 41: {r['arch']} x {r['shape']}: {r['status']} "
              f"{r.get('error')}")
        log(f"phase 41: {dryrun.summary(r)}")
    log(text.strip().splitlines()[-2])
    return {f"{r['arch']} {r['shape']}": {
        k: r.get(k) for k in ("status", "reason", "batch", "fits_one_h100",
                              "memory_analysis", "model_flops", "mfu_bound",
                              "kernel_calls")}
        | ({"flops": r["roofline"]["flops_per_device"],
            "bytes": r["roofline"]["bytes_per_device"],
            "bottleneck": r["roofline"]["bottleneck"],
            "compute_s": r["roofline"]["compute_s"],
            "memory_s": r["roofline"]["memory_s"]}
           if r["status"] == "ok" else {}) for r in results}


def once_ms(fn):
    """``fn()`` and its CUDA-event ms: one call of a plain version too
    slow to repeat (the call that the kernel is compared with)."""
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    e.synchronize()
    return out, s.elapsed_time(e)


# phase 42's 32k cases draw queries and keys at this scale: scores of
# std 4, so each row's softmax rests on a few of its up to 32k keys and
# the outputs are O(1). Unit draws leave the softmax nearly flat and a
# late row's output near 1e-2, under the tolerance, where a lost key
# tile or split would pass unseen.
SHARP = 2.0


def lost_tile_reading(name: str, got, want, dtype) -> float:
    """The reading of a deliberately broken case: the kernel fed with
    keys masked out (at the +1e9 sentinel, which no query sees) computes
    what a kernel that lost those tiles would. It must fail the
    comparison that the real case passes; its max_abs_err."""
    tol = TOL[dtype]
    err = (got.float() - want.float()).abs().max().item()
    check(not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
          f"{name}: a lost key tile passes the comparison (max_abs_err "
          f"{err}, tol {tol})")
    return err


def kernels_32k(gen: torch.Generator, timer: Timer, cases: dict) -> None:
    """Phase 42's kernel cases, the first at 32k keys on the card:
    flash_attention at qwen2-7b's prefill_32k (B 2, S 32,768, 28/4
    heads, D 128, causal) and flash_decode at its decode_32k (B 8, a
    32,768-slot cache and 16 prefix slots), each against its plain
    version (queries and keys at scale ``SHARP``), timed beside its bound
    and the library call (into ``cases``); and each fed with keys lost
    (flash_attention its last 64-key tile, flash_decode a split's worth
    at the end of each row), which must fail the same comparison."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    randn = randn_of(gen)
    B, S, Hq, Hkv, D, dtype = 2, 32768, 28, 4, 128, torch.bfloat16
    q = randn(B, S, Hq, D, dtype=dtype, s=SHARP)
    k = randn(B, S, Hkv, D, dtype=dtype, s=SHARP)
    v = randn(B, S, Hkv, D, dtype=dtype)
    pos = torch.arange(S, dtype=torch.int32, device="cuda")
    kw = dict(q_pos=pos, kv_pos=pos, window=0, causal=True)
    got = fa.flash_attention(q, k, v, backend="cuda", **kw)
    want, plain_ms = once_ms(lambda: fa.flash_attention(
        q, k, v, backend="torch", **kw))
    err = compare("flash_attention 32k", got, want, dtype)
    lost = pos.clone()
    lost[-64:] = 10 ** 9                      # the last 64-key tile
    lost_err = lost_tile_reading(
        "flash_attention 32k", fa.flash_attention(
            q, k, v, backend="cuda", **(kw | {"kv_pos": lost})), want, dtype)
    mean_abs = want.float().abs().mean().item()
    del got, want
    bms, by = kernel_costs("flash_attention", dtype, B=B, S=S, T=S, Hq=Hq,
                           Hkv=Hkv, D=D, visible=S * (S + 1) // 2).bound()
    # SDPA's causal flash path takes no GQA: K and V repeated to the 28
    # query heads outside the timed call
    qt = q.transpose(1, 2)
    kt, vt = (t.transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1)
              for t in (k, v))
    cases["flash_attention"].append(dict(
        shape=f"B={B} S={S} prefix=0 Hq={Hq} Hkv={Hkv} D={D} causal "
              f"bfloat16, q and k at scale {SHARP} (qwen2-7b's prefill_32k)",
        path=tile_path(dtype), max_abs_err=err, tol=TOL[dtype],
        want_mean_abs=mean_abs, lost_tile_err=lost_err,
        ms=timer(lambda: fa.flash_attention(q, k, v, backend="cuda", **kw)),
        plain_ms=plain_ms,
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        library="SDPA is_causal, K/V repeated to the query heads",
        bound_ms=bms, bound_by=by))
    log(f"kernel flash_attention {cases['flash_attention'][-1]}")
    del q, k, v, qt, kt, vt
    Tc, n_p = 32768, 16
    args = decode_inputs(randn, gen, 8, Tc, n_p, Hq, Hkv, D, dtype,
                         s_qk=SHARP)
    want = decode_case(cases, timer, *args, 0,
                       f"B=8 T={Tc}+{n_p} prefix Hq={Hq} Hkv={Hkv} D={D} "
                       f"per-row q_pos, q and k at scale {SHARP} (qwen2-7b's "
                       "decode_32k)", plain_timer=Timer(reps=1))
    q, kc, vc, qp, kpc, pk, pv = args
    # a split's worth of keys lost at the end of each row: the last
    # tiles_per_split x 64 cache keys through its position (one tile
    # alone holds as few as 1 of a row's keys, too few to show reliably)
    n_lost = decode_plan(dtype, D, n_p + Tc, 8, Hkv)["splits"][
        "tiles_per_split"] * 64
    slots = torch.arange(Tc, dtype=torch.int32, device="cuda")[None]
    last = (slots > (qp - n_lost)[:, None]) & (slots <= qp[:, None])
    lost = torch.where(last, torch.full_like(kpc, 10 ** 9), kpc)
    cases["flash_decode"][-1].update(
        want_mean_abs=want.float().abs().mean().item(),
        lost_tile_err=lost_tile_reading(
            "flash_decode 32k", fd.flash_decode(
                q, kc, vc, backend="cuda", q_pos=qp, kv_pos=lost,
                prefix_k=pk, prefix_v=pv), want, dtype))
    cases["flash_decode"][-1]["lost_keys"] = n_lost
    log(f"kernel flash_decode 32k: outputs' mean |x| "
        f"{cases['flash_decode'][-1]['want_mean_abs']:.4f}, each row's "
        f"last {n_lost} keys lost reads max_abs_err "
        f"{cases['flash_decode'][-1]['lost_tile_err']:.4f}")
    torch.cuda.empty_cache()


def profile_phase(seed: int, dry: dict) -> dict:
    """Phase 42's steps (``PROFILES``), each run on the card by
    ``launch/profile.py``: its peak memory held within 20 % of the
    dry-run's estimate; qwen2-7b's train_4k only where phase 41's sweep
    (``dry``) says it fits one H100."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import profile as P
    out = {}
    for arch, shape, reps in PROFILES:
        swept = dry.get(f"{arch} {shape}")
        if swept is not None and not swept["fits_one_h100"]:
            peak = swept["memory_analysis"]["peak_memory_in_bytes"]
            check(shape == "train_4k", f"phase 42: {arch} {shape} does "
                  f"not fit: {peak} B")
            reason = f"phase 41's peak {peak} B does not fit one H100"
            log(f"phase 42: {arch} {shape} not run: {reason}")
            out[f"{arch} {shape}"] = {"status": "refused", "reason": reason}
            continue
        if isinstance(shape, tuple):
            shape = InputShape(*shape)
        r = P.profile_step(arch, shape, seed=seed, reps=reps,
                           verbose=False)
        name = f"{arch} {r['shape']}"
        check(r["status"] == "ok", f"phase 42: {name} refused: "
              f"{r.get('reason')}")
        log(f"phase 42:\n{P.report(r)}")
        check(0.8 <= r["peak_over_estimate"] <= 1.2,
              f"phase 42: {name}: peak {r['peak_bytes']} B is "
              f"{r['peak_over_estimate']:.3f} of the dry-run's estimate "
              f"{r['peak_estimate_bytes']} B")
        out[name] = r
        torch.cuda.empty_cache()
    return out


def lint_phase() -> dict:
    """Phase 43's lint: ``python -m repro_torch.analysis`` exits 0."""
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                         cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=300)
    last = res.stdout.strip().splitlines()[-1] if res.stdout.strip() else ""
    check(res.returncode == 0, f"phase 43: the port's lint exited "
          f"{res.returncode}:\n{res.stdout[-4000:]}{res.stderr[-2000:]}")
    log(f"phase 43: {last}")
    return {"rc": res.returncode, "last_line": last}


def examples_start() -> dict:
    """Phase 44, started: the five examples on the card, each in a
    subprocess of its own, all at once."""
    return {e: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"torch_{e}.py")],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for e in EXAMPLES}


def examples_phase(procs: dict, t0: float) -> dict:
    """Phase 44's result: each example within its timeout from ``t0``,
    its last line; a nonzero exit fails."""
    out = {}
    for e, p in procs.items():
        try:
            text, _ = p.communicate(timeout=max(
                1.0, EXAMPLE_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"phase 44: examples/torch_{e}.py ran past "
                               f"{EXAMPLE_TIMEOUT_S}s")
        lines = text.strip().splitlines()
        check(p.returncode == 0, f"phase 44: examples/torch_{e}.py exited "
              f"{p.returncode}:\n" + "\n".join(lines[-30:]))
        out[e] = {"rc": p.returncode, "s": time.perf_counter() - t0,
                  "last_line": lines[-1] if lines else ""}
        log(f"phase 44: torch_{e}.py rc 0 by {out[e]['s']:.1f}s: "
            f"{out[e]['last_line']}")
    return out


def tools_phases(seed: int, gen: torch.Generator, timer: Timer,
                 cases: dict) -> dict:
    """Phases 41 to 44. The dry-run sweep (host work), the examples and
    the lint run side by side first; the 32k kernels and the profiled
    steps (host-bound decode steps timed on the host's clock) run after
    them, alone."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "dryrun.json")
        procs = {"dryrun": dryrun_start(out)}
        try:
            procs |= examples_start()
            rec = {"lint": lint_phase()}
            rec["examples"] = examples_phase(
                {e: procs[e] for e in EXAMPLES}, t0)
            rec["dryrun"] = dryrun_phase(procs["dryrun"], out)
            rec["alongside_s"] = time.perf_counter() - t0
            kernels_32k(gen, timer, cases)
            rec["profiles"] = profile_phase(seed, rec["dryrun"])
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
    rec["tools_s"] = time.perf_counter() - t0
    log(f"tools (phases 41-44): {rec['tools_s']:.1f}s")
    return rec


# ---------------------------------------------------------------------------
# phases 45 to 48: the dense main path on a device mesh
# ---------------------------------------------------------------------------

# the paths whose launches a kernel's record also reports
MESH_PATHS = ("mesh", "mesh_train", "mesh_paged", "mesh_spec", "mesh_moe",
              "mesh_ssm", "mesh_hybrid", "mesh_vlm", "mesh_audio",
              "mesh_long_decode", "mesh_moe_serve", "mesh_sl")


def mesh_drain(cfg, backbone: dict, bank, reqs: list, doms: list) -> dict:
    """Phase 45: phase 5's queue, domains and bank adapters on phase 4's
    qwen2-7b backbone, drained on a 1x1 NCCL mesh (``DecodeEngine(mesh=)``,
    the backbone placed by ``place_params``, a slot-sharded bank), held to
    the same drain without a mesh: the same tokens (else each request's
    first token and the full-size prefill logits' cosine), the same
    launches of every kernel, no plain version; tok/s of both."""
    from repro_torch.core.adapter_bank import AdapterBank
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.launch.mesh import single_process_mesh
    from repro_torch.models import model as M
    from repro_torch.sharding import rules as R

    adapters = {d: bank.snapshot(d) for d in bank.domains}

    def run(eng, params):
        ops.reset_launch_counts()
        with plain_calls(serving=True) as plain:
            comps, stats = serve_on(eng, params, reqs, doms)
        launches = ops.launch_counts()
        check(all(v == 0 for v in plain.values()),
              f"phase 45: a plain version ran: {plain}")
        return comps, stats, launches

    t0 = time.perf_counter()
    p_comps, p_stats, p_launches = run(
        DecodeEngine(cfg, slots=8, bank=bank, device="cuda"),
        bank.serving_params(backbone))
    rec = {"meshless_tok_per_s": p_stats.tok_per_s,
           "meshless_wall_s": p_stats.wall_s,
           "meshless_tok_latency_p50_s": p_stats.tok_latency_hist["p50"]}
    with single_process_mesh() as mesh:
        bank_m = AdapterBank.create(adapters, mesh=mesh)
        bb_m = M.place_params({"backbone": backbone}, cfg, mesh)["backbone"]
        sp = bank_m.serving_params(bb_m)
        comps, stats, launches = run(
            DecodeEngine(cfg, slots=8, bank=bank_m, mesh=mesh,
                         device="cuda"), sp)
        check(launches == p_launches,
              f"phase 45: mesh drain launches {launches}, without a mesh "
              f"{p_launches}")
        served_ok(cfg, comps, reqs, "mesh")
        no_pad_copies("phase 45")
        same = [bool(np.array_equal(a.tokens, b.tokens))
                for a, b in zip(comps, p_comps)]
        first = [int(a.tokens[0]) == int(b.tokens[0])
                 for a, b in zip(comps, p_comps)]
        S = 256
        rng = np.random.default_rng(45)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (N_DOMAINS, S)),
                               device="cuda")
        ids = bank.adapter_ids(bank.domains)
        with R.use_rules(mesh, R.serving_rules()):
            ml, _ = M.prefill(sp, {"tokens": toks}, cfg, adapter_ids=ids)
        ml = ml.full_tensor()
        pl, _ = M.prefill(bank.serving_params(backbone), {"tokens": toks},
                          cfg, adapter_ids=ids)
        cos = F.cosine_similarity(ml.flatten().float(), pl.flatten().float(),
                                  dim=0).item()
        top = bool((ml.argmax(-1) == pl.argmax(-1)).all())
        check(all(same) or (all(first) and cos > 0.999 and top),
              f"phase 45: mesh vs mesh-less tokens equal {same}, first "
              f"tokens {first}, prefill logits cosine {cos}, top-1 {top}")
        wq = bb_m["layers"]["g0"][0]["s0"]["attn"]["wq"]
        rec.update(
            mesh="1x1 (data, model), nccl", launches=launches,
            tokens=stats.tokens, wall_s=stats.wall_s,
            tok_per_s=stats.tok_per_s,
            tok_latency_p50_s=stats.tok_latency_hist["p50"],
            same_tokens=sum(same),
            requests=len(same), prefill_logits_cosine=cos,
            prefill_top1_equal=top,
            prefill_bit_equal=bool(torch.equal(ml, pl)),
            wq_placements=str(tuple(wq.placements)),
            bank_placements=str(tuple(
                _leaves(bank_m.stacked["stack"])[0].placements)))
        del bank_m, bb_m, sp
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t0
    log(f"phase 45: 1x1 NCCL mesh bank drain {rec['tok_per_s']:.2f} tok/s "
        f"(per-token p50 "
        f"{rec['tok_latency_p50_s'] * 1e3:.1f} ms) beside "
        f"{rec['meshless_tok_per_s']:.2f} without a mesh (p50 "
        f"{rec['meshless_tok_latency_p50_s'] * 1e3:.1f} ms); tokens equal on "
        f"{sum(same)} of {len(same)} requests; launches equal "
        f"{launches}; full-size mixed prefill logits mesh vs mesh-less "
        f"cosine {cos:.6f}, bit-equal {rec['prefill_bit_equal']}; wq "
        f"{rec['wq_placements']}, bank {rec['bank_placements']}; "
        f"{rec['phase_s']:.1f}s")
    return rec


def mesh_train(seed: int) -> dict:
    """Phase 46: phase 9's HFSL round (qwen2-7b at its published size, 2
    clusters x 4 steps x batch 4, seq 256) on a 1x1 NCCL mesh
    (``make_hfsl_round(mesh=)``, state and batch bank placed per
    ``hfsl_round_rules``) against the same round without a mesh: losses
    and adapters within bf16's tolerance, the same launches, no plain
    version; then ``IntegratedRuntime(mesh=)`` on vit-edge: one produce of
    two domains, one upgrade, one produce, its placements kept."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.core import hfsl
    from repro_torch.core.integrated import IntegratedRuntime
    from repro_torch.data.pipeline import BatchBank
    from repro_torch.data.synthetic import ClassificationTask
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import single_process_mesh
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import adamw
    from repro_torch.sharding import rules as R

    t_phase = time.perf_counter()
    cfg = get_config("qwen2-7b")
    cfg = cfg.with_(peft=dataclasses.replace(cfg.peft, head_dim_out=5))
    C, steps = 2, 4
    opt = adamw(5e-3)
    state = hfsl.init_hfsl_state(seed, cfg, C, opt, M.init, device="cuda")
    bank = classify_bank((5, 1000, 256, 0.5), C, 4, steps, seed, 5)
    rnd = hfsl.make_hfsl_round(cfg, opt, M.classify_loss, steps=steps,
                               sync_every=2)

    def timed(fn, *a):
        ops.reset_launch_counts()
        with plain_calls(scans=True) as plain:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        check(all(v == 0 for v in plain.values()),
              f"phase 46: a plain version ran: {plain}")
        return out, wall, ops.launch_counts()

    (out_u, m_u), wall_u, l_u = timed(rnd, state, bank.arrays, 0)
    rec = {"meshless_wall_s": wall_u, "meshless_step_s": wall_u / steps}
    with single_process_mesh() as mesh:
        rules = R.hfsl_round_rules(cfg.family)
        spec = hfsl.hfsl_state_spec(cfg, C, opt, M.model_spec)
        sh = hfsl.hfsl_state_shardings(cfg, C, opt, M.model_spec, mesh,
                                       rules)
        state_m = R.distribute_tree(state, sh, mesh)
        rows = [{k: v[i] for k, v in bank.arrays.items()}
                for i in range(bank.steps)]
        bank_m = BatchBank.from_iterator(iter(rows), bank.steps, mesh=mesh,
                                         rules=rules, device="cuda")
        rnd_m = hfsl.make_hfsl_round(cfg, opt, M.classify_loss, steps=steps,
                                     sync_every=2, mesh=mesh, rules=rules,
                                     state_spec=spec)
        walls = []
        for _ in range(2):                 # the first fills DTensor's caches
            (out_m, m_m), wall, l_m = timed(rnd_m, state_m, bank_m.arrays, 0)
            check(l_m == l_u, f"phase 46: mesh round launches {l_m}, "
                              f"without a mesh {l_u}")
            walls.append(wall)
        loss_err = (m_m["loss"] - m_u["loss"]).abs().max().item()
        ad_err = max((a.full_tensor().float() - b.float()).abs().max().item()
                     for a, b in zip(_leaves(out_m["adapters_c"]),
                                     _leaves(out_u["adapters_c"])))
        tol = TOL[torch.bfloat16]
        check(loss_err <= tol and ad_err <= tol,
              f"phase 46: mesh round vs without: losses {loss_err}, "
              f"adapters {ad_err} beyond {tol}")
        no_pad_copies("phase 46")
        placed = str(tuple(_leaves(out_m["adapters_c"])[0].placements))
        rec.update(mesh="1x1 (data, model), nccl", launches=l_m,
                   cold_wall_s=walls[0], wall_s=walls[1],
                   step_s=walls[1] / steps, loss_max_abs_err=loss_err,
                   adapters_max_abs_err=ad_err,
                   losses=m_m["loss"].tolist(),
                   meshless_losses=m_u["loss"].tolist(),
                   adapters_c_placements=placed)
        log(f"phase 46: qwen2-7b HFSL round on the 1x1 mesh "
            f"{walls[1]:.3f}s (cold {walls[0]:.3f}) beside {wall_u:.3f}s "
            f"without; losses max_abs_err {loss_err:.2e}, adapters "
            f"{ad_err:.2e}; launches equal {l_m}; adapters_c {placed}")
        del state_m, bank_m, out_m, state, out_u, bank
        torch.cuda.empty_cache()

        vit = get_config("vit-edge")
        tasks = {n: ClassificationTask(5, 64, 48, class_strength=0.6,
                                       seed=s) for n, s in (("nlp", 0),
                                                            ("cv", 7))}
        t0 = time.perf_counter()
        rt = IntegratedRuntime(vit, tasks, mesh=mesh, n_clusters=2,
                               steps_per_upgrade=4, batch=16,
                               serve_batch=16, serve_gen=4, serve_slots=8,
                               seed=seed, device="cuda")
        build_s = time.perf_counter() - t0
        profit, cost = rt.produce(["nlp", "cv"])
        check(0.0 <= profit <= rt.profit_scale and cost.tokens == 16 * 4,
              f"phase 46: runtime produce {profit}, {cost.tokens} tokens")
        v0 = rt.bank.version("nlp")
        _, up = rt.upgrade("nlp")
        check(rt.bank.version("nlp") == v0 + 1, "phase 46: no publish")
        after = str(tuple(_leaves(rt.domains["nlp"].adapters_c)[0]
                          .placements))
        check(after.startswith("(Shard(dim=0)"),
              f"phase 46: adapters_c left the mesh: {after}")
        profit2, cost2 = rt.produce("nlp")
        check(0.0 <= profit2 <= rt.profit_scale,
              f"phase 46: runtime produce {profit2}")
        rec["runtime"] = dict(
            build_s=build_s, produce_s=cost.latency_s,
            produce_tok_per_s=cost.tok_per_s, profit=profit,
            upgrade_s=up.latency_s, upgrade_ex_per_s=up.ex_per_s,
            profit_after=profit2, accuracy=rt.domains["nlp"].accuracy,
            adapters_c_placements=after)
        log(f"phase 46: vit-edge IntegratedRuntime on the mesh: built in "
            f"{build_s:.1f}s, produce {cost.latency_s:.3f}s "
            f"({cost.tok_per_s:.2f} tok/s) profit {profit:.1f}, upgrade "
            f"{up.latency_s:.3f}s ({up.ex_per_s:.1f} examples/s), produce "
            f"{cost2.latency_s:.3f}s profit {profit2:.1f}; adapters_c "
            f"{after}")
        del rt
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


def mesh_kernel_cases(gen: torch.Generator, timer: Timer,
                      cases: dict) -> None:
    """Phase 47: each kernel of the mesh path at the shapes one rank of a
    2x2 (`data`, `model`) mesh hands it for qwen2-7b: q's 3584 output
    columns and v's 512 split in two (1792, 256), 28 / 4 heads in two (14
    / 2), 8 wave rows in two (4 a `data` rank)."""
    randn = randn_of(gen)
    K, dtype, label = 3584, torch.bfloat16, "2x2 rank: "
    for M_, N in ((4, 1792), (4, 256), (4 * 512, 1792), (4 * 512, 256)):
        lora_case(cases, randn, timer, M_, K, N, dtype, label=label)
    for name, lead in (("lora_bgmv_rows", (4,)), ("lora_bgmv_seq", (4, 512))):
        for N in (1792, 256):
            bgmv_case(cases, randn, timer, name, lead, K, N, dtype,
                      label=label)
    B, S, n_p, Hq, Hkv, D = 4, 512, 16, 14, 2, 128
    attn_case(cases, randn, timer, B, S, n_p, Hq, Hkv, D, dtype,
              label="causal, 2x2 rank")
    q, kc, vc, qp, kpc, pk, pv = decode_inputs(randn, gen, B, 1024, n_p, Hq,
                                               Hkv, D, dtype)
    decode_case(cases, timer, q, kc, vc, qp, kpc, pk, pv, 0,
                f"{label}B={B} T=1024+{n_p} prefix Hq={Hq} Hkv={Hkv} D={D} "
                f"per-row q_pos")
    bk, bv = bank_slots(N_DOMAINS, n_p, Hkv, D, dtype=dtype)
    ids = torch.tensor([1, 3, 0, 1], dtype=torch.int32, device="cuda")
    decode_case(cases, timer, q, kc, vc, qp, kpc, bk, bv, 0,
                f"{label}B={B} T=1024+{n_p} prefix of {N_DOMAINS} domains by "
                f"id Hq={Hq} Hkv={Hkv} D={D} per-row q_pos", pids=ids)


def multipod_phase() -> dict:
    """Phase 48: the dry-run with ``--multi-pod`` for qwen2-7b on
    ``meta``: one card is one of the 2 x 16 x 16 mesh's 32 data rows, so
    each shape's batch is its global batch / 32 (long_500k keeps 1 and,
    under ``long_decode_rules``, 1/32 of its cache's slots)."""
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    results = dryrun.sweep([("qwen2-7b", s) for s in INPUT_SHAPES],
                           multi_pod=True)
    for r, (name, shape) in zip(results, INPUT_SHAPES.items()):
        check(r["status"] == "ok", f"phase 48: {name}: {r}")
        split = shape.kind == "decode" and shape.global_batch == 1
        mesh = "1 (one data row of the 2x16x16 mesh" + (
            "; long_decode_rules: the KV cache's kv_seq split over the 32 "
            "data rows, 1/32 of its slots a card)" if split else ")")
        check(r["batch"] == max(1, shape.global_batch // 32)
              and r["data_rows"] == 32 and r["mesh"] == mesh,
              f"phase 48: {name}: batch {r['batch']}, {r['mesh']}")
        log(f"phase 48: {dryrun.summary(r)}")
    return {"pairs": [{k: r[k] for k in ("shape", "batch", "global_batch",
                                         "mesh", "fits_one_h100",
                                         "mfu_bound")}
                      for r in results],
            "phase_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phases 49 to 53: every serving mode and every family on a device mesh
# ---------------------------------------------------------------------------

# the engine stats a mesh drain must share with its mesh-less twin
MESH_STATS = ("requests", "waves", "segments", "tokens", "padded_tokens",
              "drafted", "accepted", "prefix_hits", "prefix_hit_tokens",
              "pool_peak_blocks", "pool_blocks_alloc", "cache_tokens")


def mesh_drain_pair(phase: int, what: str, cfg, reqs: list, make, *,
                    doms=None, extras=None, slots: int = 8, **kw) -> dict:
    """A drain of ``reqs`` without a mesh and on a 1x1 NCCL mesh: ``make
    (mesh)`` gives (params, bank) laid out on ``mesh`` (as they are for
    None), ``kw`` the engine's serving mode (``paged=``, ``spec=``). The
    mesh drain must give the same tokens, engine stats and launches, and
    no plain version may run in either. Returns the mesh drain's record."""
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.launch.mesh import single_process_mesh

    def run(mesh):
        params, bank = make(mesh)
        eng = DecodeEngine(cfg, slots=slots, bank=bank, mesh=mesh,
                           device="cuda", **kw)
        ops.reset_launch_counts()
        with plain_calls(serving=True) as plain:
            comps, stats = serve_on(eng, params, reqs, doms, extras)
        check(all(v == 0 for v in plain.values()),
              f"phase {phase} {what}: a plain version ran: {plain}")
        return comps, stats, ops.launch_counts()

    t0 = time.perf_counter()
    p_comps, p_stats, p_launches = run(None)
    with single_process_mesh() as mesh:
        comps, stats, launches = run(mesh)
    torch.cuda.empty_cache()
    served_ok(cfg, comps, reqs, f"phase {phase} {what}")
    same = [bool(np.array_equal(a.tokens, b.tokens))
            for a, b in zip(comps, p_comps)]
    diff = {k: (getattr(p_stats, k), getattr(stats, k)) for k in MESH_STATS
            if getattr(p_stats, k) != getattr(stats, k)}
    check(all(same), f"phase {phase} {what}: mesh tokens equal the "
                     f"mesh-less ones on {same}")
    check(not diff, f"phase {phase} {what}: engine stats (mesh-less, mesh) "
                    f"differ: {diff}")
    check(launches == p_launches,
          f"phase {phase} {what}: mesh launches {launches}, without a mesh "
          f"{p_launches}")
    no_pad_copies(f"phase {phase}")
    rec = dict(mesh="1x1 (data, model), nccl", launches=launches,
               requests=len(reqs), same_tokens=sum(same),
               stats={k: getattr(stats, k) for k in MESH_STATS},
               tok_per_s=stats.tok_per_s, wall_s=stats.wall_s,
               meshless_tok_per_s=p_stats.tok_per_s,
               meshless_wall_s=p_stats.wall_s,
               phase_s=time.perf_counter() - t0)
    log(f"phase {phase}: {what} on the 1x1 mesh {stats.tok_per_s:.2f} tok/s "
        f"beside {p_stats.tok_per_s:.2f} without; tokens equal on "
        f"{sum(same)} of {len(same)} requests, stats equal "
        f"{ {k: v for k, v in rec['stats'].items() if v} }, launches equal "
        f"{ {k: v for k, v in launches.items() if v} }; "
        f"{rec['phase_s']:.1f}s")
    return rec


def mesh_round_pair(phase: int, what: str, cfg, params: dict, seed: int, *,
                    n_clusters: int = 2, steps: int = 2, batch: int = 2,
                    seq: int = 64) -> dict:
    """An HFSL round (classify_loss, AdamW, ``sync_every=2``) from
    ``params`` (``cfg`` has a 5-class head) without a mesh and on a 1x1
    NCCL mesh under ``hfsl_round_rules``: the same losses and adapters bit
    for bit, the same launches, no plain version in either."""
    from repro_torch.core import hfsl
    from repro_torch.data.pipeline import BatchBank
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import single_process_mesh
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import adamw
    from repro_torch.sharding import rules as R

    t0 = time.perf_counter()
    opt = adamw(5e-3)
    state = hfsl.init_hfsl_state(seed, cfg, n_clusters, opt,
                                 lambda c, s, device=None: params)
    bank = classify_bank((5, 1000, seq, 0.5), n_clusters, batch, steps,
                         seed, 5)

    def timed(rnd, st, arrays):
        ops.reset_launch_counts()
        with plain_calls(scans=True) as plain:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = rnd(st, arrays, 0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        check(all(v == 0 for v in plain.values()),
              f"phase {phase} {what}: a plain version ran: {plain}")
        return out, wall, ops.launch_counts()

    (out_u, m_u), wall_u, l_u = timed(hfsl.make_hfsl_round(
        cfg, opt, M.classify_loss, steps=steps, sync_every=2), state,
        bank.arrays)
    with single_process_mesh() as mesh:
        rules = R.hfsl_round_rules(cfg.family)
        spec = hfsl.hfsl_state_spec(cfg, n_clusters, opt, M.model_spec)
        sh = hfsl.hfsl_state_shardings(cfg, n_clusters, opt, M.model_spec,
                                       mesh, rules)
        state_m = R.distribute_tree(state, sh, mesh)
        rows = [{k: v[i] for k, v in bank.arrays.items()}
                for i in range(bank.steps)]
        bank_m = BatchBank.from_iterator(iter(rows), bank.steps, mesh=mesh,
                                         rules=rules, device="cuda")
        (out_m, m_m), wall, l_m = timed(hfsl.make_hfsl_round(
            cfg, opt, M.classify_loss, steps=steps, sync_every=2, mesh=mesh,
            rules=rules, state_spec=spec), state_m, bank_m.arrays)
        bits = bool(torch.equal(m_m["loss"], m_u["loss"])) and all(
            torch.equal(a.full_tensor(), b) for a, b in zip(
                _leaves(out_m["adapters_c"]), _leaves(out_u["adapters_c"])))
        placed = [str(tuple(a.placements)) for a in
                  _leaves(out_m["adapters_c"])]
        want = [str(tuple(a.placements)) for a in
                _leaves(state_m["adapters_c"])]
        del state_m, bank_m, out_m
    torch.cuda.empty_cache()
    check(bits, f"phase {phase} {what}: the mesh round's losses or adapters "
                "are not the mesh-less round's bits")
    check(l_m == l_u, f"phase {phase} {what}: mesh round launches {l_m}, "
                      f"without a mesh {l_u}")
    check(placed == want, f"phase {phase} {what}: the round moved the "
                          f"adapters' placements {placed} from {want}")
    no_pad_copies(f"phase {phase}")
    rec = dict(mesh="1x1 (data, model), nccl", launches=l_m,
               clusters=n_clusters, steps=steps, batch=batch, seq=seq,
               wall_s=wall, meshless_wall_s=wall_u, bit_equal=bits,
               losses=m_m["loss"].tolist(), adapters_c_placements=placed[0],
               phase_s=time.perf_counter() - t0)
    log(f"phase {phase}: {what} round ({n_clusters} clusters x {steps} steps"
        f" x batch {batch}, seq {seq}) on the 1x1 mesh {wall:.3f}s beside "
        f"{wall_u:.3f}s without; bit for bit {bits}; launches equal "
        f"{ {k: v for k, v in l_m.items() if v} }; adapters_c {placed[0]}")
    return rec


def _add(total: dict, launches: dict) -> dict:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    return total


def mesh_serving_phases(seed: int) -> dict:
    """Phases 49 and 50 on one full-size qwen2-7b backbone."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.adapter_bank import AdapterBank
    from repro_torch.core.paged import PagedSpec
    from repro_torch.core.spec_decode import SpecDecoder
    from repro_torch.models import model as M

    cfg = get_config("qwen2-7b")
    params = M.init(cfg, seed, device="cuda")
    adapters = domain_adapters(cfg, seed + 1)
    bank = AdapterBank.create(adapters)
    rng = np.random.default_rng(seed + 49)
    reqs, doms = paged_queue(rng, bank, 8, (16, 65), (8, 17),
                             cfg.vocab_size, 64)

    def banked(mesh):
        if mesh is None:
            return bank.serving_params(params["backbone"]), bank
        b = AdapterBank.create(adapters, mesh=mesh)
        bb = M.place_params({"backbone": params["backbone"]}, cfg,
                            mesh)["backbone"]
        return b.serving_params(bb), b

    paged = mesh_drain_pair(
        49, "qwen2-7b paged bank drain, prefix sharing", cfg, reqs, banked,
        doms=doms, paged=PagedSpec(n_blocks=256, block_size=16,
                                   share_prefix=True))
    check(paged["stats"]["prefix_hits"] > 0, "phase 49: no prefix shared")
    reqs = queue(rng, 8, (32, 129), (8, 17), cfg.vocab_size)
    spec = mesh_drain_pair(
        50, "qwen2-7b speculative drain (k 4)", cfg, reqs,
        lambda mesh: (params if mesh is None else
                      M.place_params(params, cfg, mesh), None),
        spec=SpecDecoder.init(cfg, seed + 997, device="cuda", k=4))
    check(spec["stats"]["drafted"] > 0, "phase 50: nothing drafted")
    del params, bank, adapters
    torch.cuda.empty_cache()
    return {"mesh_paged": paged, "mesh_spec": spec}


def mesh_family(phase: int, what: str, cfg, seed: int, *, n: int,
                lens: tuple, gens: tuple, rows: bool = False,
                train: bool = True) -> dict:
    """One family's full-size drain (``n`` requests, with modality rows
    for vlm and audio) and, with ``train``, its round, each against its
    mesh-less twin; the path's record with both runs' launches."""
    from repro_torch.models import model as M

    cfg = cfg.with_(peft=dataclasses.replace(cfg.peft, head_dim_out=5))
    params = M.init(cfg, seed, device="cuda")
    rng = np.random.default_rng(seed + phase)
    reqs = queue(rng, n, lens, gens, cfg.vocab_size)
    rec = {"drain": mesh_drain_pair(
        phase, f"{what} drain", cfg, reqs,
        lambda mesh: (params if mesh is None else
                      M.place_params(params, cfg, mesh), None),
        extras=modality_rows(cfg, seed, n) if rows else None)}
    total = _add({}, rec["drain"]["launches"])
    if train:
        rec["train"] = mesh_round_pair(phase, what, cfg, params, seed)
        _add(total, rec["train"]["launches"])
    rec["launches"] = total
    del params
    torch.cuda.empty_cache()
    return rec


def mesh_scan_cases(gen: torch.Generator, timer: Timer, cases: dict) -> None:
    """Phase 53: ``flash_decode_paged`` at one 2x2 rank's qwen2-7b decode
    (B 4, 14 / 2 heads, D 128, blocks of 16, the pool gathered whole); the
    two scans through their mesh wrappers on the 1x1 NCCL mesh against
    the plain versions on the whole tensors, at falcon-mamba-7b's and
    recurrentgemma-2b's rank shapes: serving's channel split (Di 4096, W
    1280 of B 4 x S 512) and a round's row split (B 2 x S 256, every
    channel) with the backward, autograd through the wrapper against
    autograd through the plain version; each kernel also timed alone with
    its bound (into ``cases``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.launch.mesh import single_process_mesh

    dtype = torch.bfloat16
    paged_case(cases, randn_of(gen), gen, timer, 14, 2, 128, dtype,
               label="2x2 rank, the pool gathered whole: ", B=4)
    mcfg = get_config("falcon-mamba-7b")
    dr, N, Di = mcfg.dt_rank, mcfg.ssm.d_state, mcfg.d_inner
    W = get_config("recurrentgemma-2b").lru_width

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s

    def scan_args(B, S, C):
        xdbc = rn(B, S, dr + 2 * N, s=0.5).to(dtype)
        return [rn(B, S, C, s=0.5).to(dtype),
                (F.softplus(rn(B, S, C)) * 0.1).to(dtype),
                -torch.exp(rn(C, N, s=0.3)), xdbc[..., dr:dr + N],
                xdbc[..., dr + N:], rn(C), rn(B, C, N, s=0.1)]

    def lru_args(B, S, C):
        return [rn(B, S, C, s=0.5).to(dtype), rn(B, S, C).to(dtype),
                rn(B, S, C).to(dtype), rn(C), rn(B, C, s=0.1)]

    R_, S_ = Replicate(), Shard
    # placements of (x-like..., per-channel, h0) by split: serving's
    # channels on `model`, a round's rows on `model`
    PL = {("selective_scan", "channels"):
          [(S_(0), S_(2))] * 2 + [(R_, S_(0)), (S_(0), R_), (S_(0), R_),
                                  (R_, S_(0)), (S_(0), S_(1))],
          ("selective_scan", "rows"):
          [(R_, S_(0))] * 2 + [(R_, R_), (R_, S_(0)), (R_, S_(0)), (R_, R_),
                               (R_, S_(0))],
          ("rglru_scan", "channels"):
          [(S_(0), S_(2))] * 3 + [(R_, S_(0)), (S_(0), S_(1))],
          ("rglru_scan", "rows"):
          [(R_, S_(0))] * 3 + [(R_, R_), (R_, S_(0))]}
    with single_process_mesh() as mesh:
        for name, B, S, C, split in (
                ("selective_scan", 4, 512, Di // 2, "channels"),
                ("selective_scan", 2, 256, Di, "rows"),
                ("rglru_scan", 4, 512, W // 2, "channels"),
                ("rglru_scan", 2, 256, W, "rows")):
            scan = name == "selective_scan"
            mod = ss if scan else rg
            args = scan_args(B, S, C) if scan else lru_args(B, S, C)
            wrapper = ops.selective_scan if scan else ops.rglru
            kernel = ss.selective_scan if scan else rg.rglru
            pls = PL[(name, split)]

            def on_mesh(a, pls=pls, wrapper=wrapper):
                return [y.to_local() for y in wrapper(*[
                    DTensor.from_local(t, mesh, p, run_check=False)
                    for t, p in zip(a, pls)])]
            label = (f"2x2 rank, {split} on model: B={B} S={S} "
                     f"{'Di' if scan else 'W'}={C}"
                     f"{f' N={N}' if scan else ''} h0 per row bf16")
            n0 = mod.launches
            y, h = on_mesh(args)
            check(mod.launches == n0 + 1,
                  f"{name} {label}: the mesh wrapper launched "
                  f"{mod.launches - n0} kernels")
            yw, hw = kernel(*args, backend="torch")
            torch.cuda.synchronize()
            err = compare(f"{name} {label}", y, yw, dtype)
            herr = (h - hw).abs().max().item()
            check(bool(torch.allclose(h, hw, atol=1e-3, rtol=1e-3)),
                  f"{name} {label}: h_final max_abs_err {herr} beyond 1e-3")
            kc = kernel_costs(name, dtype, B=B, S=S, h0=True,
                              **({"Di": C, "N": N} if scan else {"W": C}))
            c = dict(shape=label, max_abs_err=err, tol=TOL[dtype],
                     h_final_max_abs_err=herr, h_final_tol=1e-3,
                     ms=timer(lambda: kernel(*args)),
                     mesh_wrapper_ms=timer(lambda: on_mesh(args)),
                     plain_ms=timer(lambda: kernel(*args, backend="torch")),
                     library_ms=None, library="none: no single PyTorch "
                     "call computes this scan",
                     bound_ms=kc.bound()[0], bound_by=kc.bound()[1])
            cases[name].append(c)
            log(f"kernel {name} {c}")
            if split != "rows":
                continue
            # the round's backward: autograd through the wrapper against
            # autograd through the plain version (A / a_param and D
            # frozen, as the backbone is)
            frozen = (2, 5) if scan else (3,)

            def grads(fn):
                leaves = [a if i in frozen else
                          a.detach().clone().requires_grad_(True)
                          for i, a in enumerate(args)]
                out = fn(leaves)
                g = torch.Generator(device="cuda").manual_seed(53)
                sum((o.float() * torch.randn(o.shape, generator=g,
                                             device="cuda")).sum()
                    for o in out).backward()
                return [None if i in frozen else a.grad
                        for i, a in enumerate(leaves)]
            b0 = mod.bwd_launches
            got = grads(on_mesh)
            check(mod.bwd_launches == b0 + 1,
                  f"{name}_bwd {label}: {mod.bwd_launches - b0} launches")
            want = grads(lambda a: kernel(*a, backend="torch"))
            names = SCAN_GRADS if scan else LRU_GRADS
            errs = grads_close(f"{name}_bwd {label}", got, want, dtype, names)
            dy = rn(B, S, C).to(dtype)
            if scan:
                def bwd():
                    return ss._launch_bwd(*args, dy, None, need_A=False,
                                          need_D=False)

                def plain_bwd():
                    return ss.selective_scan_bwd_torch(
                        *args, dy, need_A=False, need_D=False)
                kb = kernel_costs("selective_scan_bwd", dtype, B=B, S=S,
                                  Di=C, N=N, h0=True)
            else:
                def bwd():
                    return rg._launch_bwd(*args, dy, need_a=False)

                def plain_bwd():
                    return rg.rglru_bwd_torch(*args, dy, need_a=False)
                kb = kernel_costs("rglru_scan_bwd", dtype, B=B, S=S, W=C,
                                  h0="row")
            cb = dict(shape=label + ", through autograd (parameters "
                      "frozen)", max_abs_err=max(errs.values()),
                      tol=GRAD_TOL[dtype], grad_errs=errs,
                      ms=timer(bwd), plain_ms=timer(plain_bwd),
                      library_ms=None, library="none: no single PyTorch "
                      "call computes this VJP",
                      bound_ms=kb.bound()[0], bound_by=kb.bound()[1])
            cases[f"{name}_bwd"].append(cb)
            log(f"kernel {name}_bwd {cb}")


def mesh_phases(seed: int) -> dict:
    """Phases 49 to 52, each path's launches in its record."""
    t0 = time.perf_counter()
    out = mesh_serving_phases(seed)
    out["mesh_moe"] = mesh_family(51, "granite-moe-1b-a400m",
                                  granite_config(), seed, n=8,
                                  lens=(32, 129), gens=(8, 17))
    from repro_torch.configs.base import get_config
    out["mesh_ssm"] = mesh_family(52, "falcon-mamba-7b",
                                  get_config("falcon-mamba-7b"), seed, n=8,
                                  lens=(32, 129), gens=(8, 17))
    out["mesh_hybrid"] = mesh_family(52, "recurrentgemma-2b",
                                     get_config("recurrentgemma-2b"), seed,
                                     n=8, lens=(32, 129), gens=(8, 17))
    out["mesh_vlm"] = mesh_family(52, "llava-next-mistral-7b",
                                  llava_config(), seed, n=4, lens=(16, 65),
                                  gens=(4, 9), rows=True, train=False)
    out["mesh_audio"] = mesh_family(52, "whisper-small", whisper_config(),
                                    seed, n=4, lens=(16, 65), gens=(4, 9),
                                    rows=True, train=False)
    out["mesh_serving_s"] = time.perf_counter() - t0
    log(f"phases 49-52: {out['mesh_serving_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phases 54 to 56: long decode, moe serving and the SL chain on a mesh
# ---------------------------------------------------------------------------

LONG_PROMPT, LONG_STEPS = 4064, 64


def shard_decode_case(gen: torch.Generator, timer: Timer,
                      cases: dict) -> None:
    """Phase 54's kernel case (row 3h): ``flash_decode``'s partial mode
    at one of two `data` shards of a decode_32k-shaped cache at its last
    position (B 1, every key visible; the first half holds the 16 prefix
    slots, as the rank at `data` coordinate 0 reads the bank): each half
    (output and lse) against its plain version; the halves merged by
    ``flash_decode.combine`` against one whole call; each half and the
    merge timed, the first half's bound, plain and SDPA times (into
    ``cases``)."""
    from repro_torch.kernels import flash_decode as fd
    randn = randn_of(gen)
    T, n_p, Hq, Hkv, D, dtype = 32768, 16, 28, 4, 128, torch.bfloat16
    h = T // 2
    q = randn(1, Hq, D, dtype=dtype, s=SHARP)
    kc = randn(1, T, Hkv, D, dtype=dtype, s=SHARP)
    vc = randn(1, T, Hkv, D, dtype=dtype)
    pk = randn(n_p, Hkv, D, dtype=dtype, s=SHARP)
    pv = randn(n_p, Hkv, D, dtype=dtype)
    qp = torch.full((1,), T - 1, dtype=torch.int32, device="cuda")
    kpc = torch.arange(T, dtype=torch.int32, device="cuda")[None]
    halves = [dict(k=kc[:, :h].contiguous(), v=vc[:, :h].contiguous(),
                   kv_pos=kpc[:, :h].contiguous(), prefix_k=pk,
                   prefix_v=pv),
              dict(k=kc[:, h:].contiguous(), v=vc[:, h:].contiguous(),
                   kv_pos=kpc[:, h:].contiguous())]
    parts, errs, lse_errs, ms = [], [], [], []
    for i, hv in enumerate(halves):
        def call(backend, hv=hv):
            kw = {k: v for k, v in hv.items() if k not in ("k", "v")}
            return fd.flash_decode(q, hv["k"], hv["v"], q_pos=qp,
                                   backend=backend, return_lse=True, **kw)
        got, want = call("cuda"), call("torch")
        torch.cuda.synchronize()
        errs.append(compare(f"flash_decode half {i} lse mode", got[0],
                            want[0], dtype))
        lse_errs.append((got[1] - want[1]).abs().max().item())
        check(lse_errs[-1] <= TOL[dtype], f"flash_decode half {i}: lse "
              f"max_abs_err {lse_errs[-1]} > {TOL[dtype]}")
        parts.append(got)
        ms.append(timer(lambda call=call: call("cuda")))
    whole = fd.flash_decode(q, kc, vc, q_pos=qp, kv_pos=kpc, prefix_k=pk,
                            prefix_v=pv, backend="cuda")
    merge = [[p[0] for p in parts], [p[1] for p in parts]]
    merged, _ = fd.combine(*merge)
    torch.cuda.synchronize()
    merge_err = compare("flash_decode two halves merged vs whole", merged,
                        whole, dtype)
    first = halves[0]
    _, plain_ms = once_ms(lambda: fd.flash_decode(
        q, first["k"], first["v"], q_pos=qp, kv_pos=first["kv_pos"],
        prefix_k=pk, prefix_v=pv, backend="torch", return_lse=True))
    bms, by = kernel_costs("flash_decode", dtype, B=1, Hq=Hq, Hkv=Hkv, D=D,
                           Tc=h, keys=h, n_p=n_p, n_read=1,
                           lse=True).bound()
    # the merge reads both halves' outputs and lse, writes one output
    cms, cby = bound(2 * (2 * Hq * D + 4 * Hq) + 2 * Hq * D,
                     2 * 3 * Hq * D, torch.float32)
    kt = torch.cat([pk[None], first["k"]], 1).transpose(1, 2)
    vt = torch.cat([pv[None], first["v"]], 1).transpose(1, 2)
    qt = q[:, :, None]
    cases["flash_decode"].append(dict(
        shape=f"one of 2 `data` shards: B=1 T={h} of {T}+{n_p} prefix "
              f"Hq={Hq} Hkv={Hkv} D={D}, every key visible, q and k at "
              f"scale {SHARP}, return_lse bfloat16 (decode_32k's cache "
              "split over `data`)",
        **decode_plan(dtype, D, n_p + h, 1, Hkv), max_abs_err=max(errs),
        tol=TOL[dtype], lse_max_abs_err=max(lse_errs),
        merged_vs_whole_err=merge_err, visible_keys=h + n_p,
        ms=ms[0], second_half_ms=ms[1],
        combine_ms=timer(lambda: fd.combine(*merge)),
        combine_bound_ms=cms, combine_bound_by=cby, plain_ms=plain_ms,
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True)),
        library="SDPA on the half, the prefix slots in front",
        bound_ms=bms, bound_by=by))
    log(f"kernel flash_decode {cases['flash_decode'][-1]}")
    del q, kc, vc, halves, parts, whole, merged, kt, vt
    torch.cuda.empty_cache()


def long_decode_phase(seed: int) -> dict:
    """Phase 54: qwen2-7b's long_500k variant (window 4096) decodes a
    batch of 1, without a mesh and under ``long_decode_rules`` on the 1x1
    NCCL mesh: prefill of ``LONG_PROMPT`` tokens, the caches laid out by
    ``place_caches``, ``LONG_STEPS`` greedy ``decode_step``s (the ring
    wraps); tokens and every step's logits bit for bit, equal launches,
    no plain version."""
    import contextlib

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import single_process_mesh
    from repro_torch.models import model as M
    from repro_torch.sharding import dtensor as dtn
    from repro_torch.sharding import rules as R

    t0 = time.perf_counter()
    cfg = dryrun.variant_for(get_config("qwen2-7b"), "long_500k")
    check((cfg.n_layers, cfg.d_model, cfg.attn_variant, cfg.sliding_window)
          == (28, 3584, "sliding", 4096),
          "phase 54: qwen2-7b long_500k is not at its published size")
    params = {"backbone": M.init(cfg, seed, device="cuda")["backbone"],
              "adapters": domain_adapters(cfg, seed + 54)["domain0"]}
    rng = np.random.default_rng(seed + 54)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (1, LONG_PROMPT)), device="cuda")
    T = cfg.sliding_window

    def run(mesh):
        p = params if mesh is None else M.place_params(
            params, cfg, mesh, R.long_decode_rules())
        rules = contextlib.nullcontext() if mesh is None else \
            R.use_rules(mesh, R.long_decode_rules())
        with rules, torch.no_grad(), plain_calls(serving=True) as plain:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t_a = time.perf_counter()
            logits, caches = M.prefill(p, {"tokens": toks}, cfg, max_len=T)
            if mesh is not None:
                caches = M.place_caches(caches, cfg, 1, T)
            tok = dtn.whole(logits)[:, -1].argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            t_b = time.perf_counter()
            steps, got = [], [tok]
            for i in range(LONG_STEPS):
                logits, caches = M.decode_step(
                    p, tok, caches, torch.tensor([LONG_PROMPT + i],
                                                 device="cuda"), cfg)
                lg = dtn.whole(logits)[:, -1]
                steps.append(lg)
                tok = lg.argmax(-1, keepdim=True)
                got.append(tok)
            torch.cuda.synchronize()
            t_c = time.perf_counter()
            launches = ops.launch_counts()
        check(all(v == 0 for v in plain.values()),
              f"phase 54: a plain version ran: {plain}")
        k = caches["g0"]["s0"]["k"]
        where = repr(tuple(k.placements)) if dtn.is_dt(k) else "whole"
        local = (k.to_local() if dtn.is_dt(k) else k).shape[2]
        del caches, p
        return (torch.stack(steps), torch.cat(got, 1), launches,
                (t_b - t_a, (t_c - t_b) / LONG_STEPS), where, local)

    with torch.no_grad():          # warm: the timed runs start alike
        _, c = M.prefill(params, {"tokens": toks[:, :64]}, cfg, max_len=T)
        M.decode_step(params, toks[:, :1], c, 64, cfg)
        del c
    u_lg, u_tok, u_n, u_t, _, _ = run(None)
    with single_process_mesh() as mesh:
        m_lg, m_tok, m_n, m_t, where, local = run(mesh)
    torch.cuda.empty_cache()
    bits = torch.equal(m_lg, u_lg)
    check(torch.equal(m_tok, u_tok) and bits,
          f"phase 54: the mesh's tokens / logits differ from the mesh-less "
          f"ones: tokens equal {torch.equal(m_tok, u_tok)}, logits max "
          f"diff {(m_lg - u_lg).abs().max().item()}")
    check(m_n == u_n and m_n["flash_decode"] == cfg.n_layers * LONG_STEPS,
          f"phase 54: launches {m_n}, without a mesh {u_n}")
    check(where == "(Shard(dim=2), Shard(dim=3))" and local == T,
          f"phase 54: the cache is {where}, {local} local slots")
    check(len(set(u_tok[0].tolist())) > 1 and bool(
        torch.isfinite(u_lg).all()), "phase 54: degenerate decode")
    no_pad_copies("phase 54")
    rec = dict(config=f"qwen2-7b long_500k variant, {cfg.n_layers} layers, "
                      f"window {T}, bf16", mesh="1x1 (data, model), nccl",
               rules="long_decode_rules", prompt=LONG_PROMPT,
               steps=LONG_STEPS, cache=where, local_slots=local,
               bit_equal=bits, launches=m_n,
               prefill_s=m_t[0], meshless_prefill_s=u_t[0],
               step_s=m_t[1], meshless_step_s=u_t[1],
               tokens=u_tok[0, :8].tolist(),
               phase_s=time.perf_counter() - t0)
    log(f"phase 54: long decode on the 1x1 mesh, the cache {where}: "
        f"{LONG_PROMPT}-token prompt, {LONG_STEPS} steps (positions "
        f"{LONG_PROMPT}-{LONG_PROMPT + LONG_STEPS - 1}, window {T}); tokens "
        f"and logits bit for bit {bits}; a step {m_t[1] * 1e3:.2f} ms beside "
        f"{u_t[1] * 1e3:.2f} ms without the mesh, prefill {m_t[0]:.3f} s / "
        f"{u_t[0]:.3f} s; launches equal "
        f"{ {k: v for k, v in m_n.items() if v} }; {rec['phase_s']:.1f}s")
    del params
    torch.cuda.empty_cache()
    return rec


def moe_serve_phase(seed: int) -> dict:
    """Phase 55: granite-moe-1b-a400m at its published size prefills 8 x
    512 tokens without a mesh and under ``moe_serving_rules`` on the 1x1
    NCCL mesh (experts on `data`, their d_model on `model`): logits bit
    for bit, equal launches, no plain version."""
    import contextlib

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import single_process_mesh
    from repro_torch.models import model as M
    from repro_torch.sharding import dtensor as dtn
    from repro_torch.sharding import rules as R

    t0 = time.perf_counter()
    cfg = granite_config()
    params = M.init(cfg, seed, device="cuda")
    rng = np.random.default_rng(seed + 55)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 512)),
                           device="cuda")

    def run(mesh):
        p = params if mesh is None else M.place_params(
            params, cfg, mesh, R.moe_serving_rules())
        rules = contextlib.nullcontext() if mesh is None else \
            R.use_rules(mesh, R.moe_serving_rules())
        with rules, torch.no_grad(), plain_calls(serving=True) as plain:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t_a = time.perf_counter()
            logits = dtn.whole(M.prefill(p, {"tokens": toks}, cfg)[0])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_a
            launches = ops.launch_counts()
        check(all(v == 0 for v in plain.values()),
              f"phase 55: a plain version ran: {plain}")
        gate = p["backbone"]["layers"]["g0"][0]["s0"]["moe"]["gate"]
        where = repr(tuple(gate.placements)) if dtn.is_dt(gate) else "whole"
        return logits, launches, wall, where

    u_lg, u_n, u_wall, _ = run(None)
    with single_process_mesh() as mesh:
        m_lg, m_n, m_wall, where = run(mesh)
    torch.cuda.empty_cache()
    bits = torch.equal(m_lg, u_lg)
    check(bits, f"phase 55: logits max diff "
                f"{(m_lg - u_lg).abs().max().item()}")
    check(m_n == u_n and m_n["flash_attention"] == cfg.n_layers,
          f"phase 55: launches {m_n}, without a mesh {u_n}")
    check(where == "(Shard(dim=0), Shard(dim=1))",
          f"phase 55: the expert weights are {where}")
    no_pad_copies("phase 55")
    rec = dict(config="granite-moe-1b-a400m, 24 layers, 32 experts top 8, "
                      "bf16", mesh="1x1 (data, model), nccl",
               rules="moe_serving_rules", batch=8, seq=512, experts=where,
               bit_equal=bits, launches=m_n, prefill_s=m_wall,
               meshless_prefill_s=u_wall, phase_s=time.perf_counter() - t0)
    log(f"phase 55: moe serving prefill (8 x 512) on the 1x1 mesh, experts "
        f"{where}: logits bit for bit {bits}; {m_wall:.3f} s beside "
        f"{u_wall:.3f} s without; launches equal "
        f"{ {k: v for k, v in m_n.items() if v} }")
    del params
    torch.cuda.empty_cache()
    return rec


def sl_mesh_phase(seed: int) -> dict:
    """Phase 56: vit-edge's 12-layer f32 chain (B 16 x S 197, ``N_MICRO``
    microbatches) with ``mesh=`` a 1-stage NCCL `stage` mesh against the
    mesh-less chain of phases 30-31 (``N_STAGES`` stages): logits and one
    sgd ``make_sl_finetune_step`` bit for bit, equal launches, each
    timed."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import sl_pipeline as sl
    from repro_torch.launch.mesh import single_process_mesh
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import sgd

    t0 = time.perf_counter()
    vit = get_config("vit-edge").with_(dtype="float32")
    vp = {"backbone": M.init(vit, seed, device="cuda")["backbone"],
          "adapters": domain_adapters(vit, seed + 6)["domain0"]}
    rng = np.random.default_rng(seed + 56)
    batch = {"tokens": torch.as_tensor(rng.integers(0, vit.vocab_size,
                                                    (16, 197)),
                                       device="cuda"),
             "label": torch.as_tensor(rng.integers(0, 5, (16,)),
                                      device="cuda")}
    opt = sgd(0.1)
    head = vp["adapters"]["head"]

    def run(mesh, n_stages):
        st = sl.split_for_stages(vp, vit, n_stages)
        step = sl.make_sl_finetune_step(vp, vit, opt, n_microbatches=N_MICRO,
                                        mesh=mesh)
        state = opt.init({"a": st["adapters"], "h": head})
        times, n = {}, {}
        with plain_calls() as plain:
            with torch.no_grad():
                logits, n["chain"] = counted({}, lambda: host_ms(
                    times, "chain", lambda: sl.pipeline_classify(
                        vp, st, batch["tokens"], vit, n_microbatches=N_MICRO,
                        mesh=mesh)))
            (new, nh, _, loss), n["step"] = counted({}, lambda: host_ms(
                times, "step", lambda: step(st, head, state, batch)))
        check(all(v == 0 for v in plain.values()),
              f"phase 56: a plain version ran: {plain}")
        return [logits, loss] + _leaves([new["adapters"], nh]), n, times

    u_out, u_n, u_t = run(None, N_STAGES)
    with single_process_mesh(stage=True) as mesh:
        m_out, m_n, m_t = run(mesh, 1)
    torch.cuda.empty_cache()
    bits = len(u_out) == len(m_out) and all(
        torch.equal(a, b) for a, b in zip(u_out, m_out))
    check(bits, "phase 56: the stage mesh's logits / step differ from the "
                "mesh-less chain's")
    check(m_n == u_n, f"phase 56: launches {m_n}, without a mesh {u_n}")
    total = {}
    for v in m_n.values():
        _add(total, v)
    no_pad_copies("phase 56")
    rec = dict(config="vit-edge 12 layers f32, B 16 S 197",
               mesh="1-stage (stage,), nccl", microbatches=N_MICRO,
               meshless_stages=N_STAGES, bit_equal=bits, launches=total,
               chain_ms=m_t["chain"][0], meshless_chain_ms=u_t["chain"][0],
               step_ms=m_t["step"][0], meshless_step_ms=u_t["step"][0],
               loss=float(m_out[1]), phase_s=time.perf_counter() - t0)
    log(f"phase 56: the SL chain on a 1-stage mesh: logits and an sgd step "
        f"bit for bit {bits}; chain {m_t['chain'][0]:.2f} ms beside "
        f"{u_t['chain'][0]:.2f} ms without the mesh, step "
        f"{m_t['step'][0]:.2f} / {u_t['step'][0]:.2f} ms (host, "
        f"synchronised); launches equal "
        f"{ {k: v for k, v in total.items() if v} }")
    del vp
    return rec


def last_mesh_phases(seed: int) -> dict:
    """Phases 54 to 56, each path's launches in its record."""
    t0 = time.perf_counter()
    out = {"mesh_long_decode": long_decode_phase(seed),
           "mesh_moe_serve": moe_serve_phase(seed),
           "mesh_sl": sl_mesh_phase(seed)}
    out["last_mesh_s"] = time.perf_counter() - t0
    log(f"phases 54-56: {out['last_mesh_s']:.1f}s")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None,
                    help="also write the full record as JSON here")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
    # the card's own clocks, beside the data sheet's that the bounds use
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.max.mem",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(f"max clocks (sm, memory): {clocks}; bounds use "
        f"{SM_CLOCK / 1e6:.0f} MHz and "
        f"{HBM_BW / 1e12:.2f} TB/s")

    t0 = time.perf_counter()
    nvcc = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build: {len(nvcc)} kernels in {build_s:.1f}s")
    for name, text in nvcc.items():
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = ptxas_entry(line)
            if "registers" in line or "spill" in line or "wgmma" in line:
                log(f"  ptxas {name} {entry}: {line.strip()}")

    rec = {"gpu": smi, "kind": kind, "clocks": clocks, "build_s": build_s,
           "sass": sass_check(_build), "sass_needs": sass_needs(_build),
           "sass_mufu": sass_mufu(_build)}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timer = Timer()
    cases = kernel_cases(gen, timer)
    rec["train_kernels"] = train_kernel_cases(gen, timer, cases)
    paged_kernel_cases(gen, timer, cases)
    scan_kernel_cases(gen, timer, cases)
    lru_kernel_cases(gen, timer, cases)
    attn256_cases(gen, timer, cases)
    rec["scan_bwd"] = scan_bwd_cases(gen, timer, cases)
    lora_bwd_hybrid_cases(gen, timer, cases)
    moe_kernel_cases(timer, cases, args.seed)
    family_kernel_cases(timer, cases, args.seed)
    mesh_kernel_cases(gen, timer, cases)
    mesh_scan_cases(gen, timer, cases)
    shard_decode_case(gen, timer, cases)
    rec["main"], rec["bank"], rec["paged"], rec["spec"], rec["mesh"] = \
        main_path(args.seed)
    log(f"multi-tenancy: bank drain {rec['bank']['tok_per_s']:.2f} tok/s "
        f"beside single-tenant {rec['main']['tok_per_s']:.2f} tok/s")
    rec["e2e"] = end_to_end(args.seed)
    rec["classify"] = classify_phase(args.seed)
    rec.update(train_phases(args.seed))
    rec["mesh_train"] = mesh_train(args.seed)
    rec["loop"] = paper_loop(args.seed)
    rec["mamba"], rec["mamba_bank"] = mamba_path(args.seed)
    rec["mamba_e2e"] = mamba_exactness(args.seed)
    rec["spec_loop"] = spec_loop(args.seed)
    rec["hybrid"], rec["hybrid_bank"] = hybrid_path(args.seed)
    rec["hybrid_e2e"] = hybrid_exactness(args.seed)
    rec.update(scan_train_phases(args.seed))
    rec["train_scan_e2e"] = scan_train_exactness(args.seed)
    t_flow = time.perf_counter()
    rec.update(knowledge_flow(args.seed, rec["train"]["step_s"]))
    rec["flow_s"] = time.perf_counter() - t_flow
    log(f"knowledge flow (phases 29-32): {rec['flow_s']:.1f}s")
    rec["moe"] = moe_phases(args.seed)
    rec.update(family_phases(args.seed))
    rec["tools"] = tools_phases(args.seed, gen, timer, cases)
    rec["multipod"] = multipod_phase()
    rec.update(mesh_phases(args.seed))
    rec.update(last_mesh_phases(args.seed))

    kernels = []
    for name, cs in cases.items():
        head = cs[0]
        path = PATH_OF.get(name, "main")
        by_path = {p: rec[p]["launches"].get(name, 0)
                   for p in (path,) + FLOW_PATHS + FAMILY_PATHS
                   + MESH_PATHS}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": head["max_abs_err"], "tol": head["tol"],
            "shape": head["shape"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "cases": cs})
    rec["kernels"] = kernels
    rec["total_s"] = time.perf_counter() - t_start
    log(f"chip_smoke: {rec['total_s']:.1f}s in all, the build included")
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rec, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)

"""Drive the PyTorch/CUDA port's main path on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build the six CUDA sources from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for sm_90a (one process per source, in parallel);
3. the wgmma libraries of K1 and K3 (SISA GEMM and split-K, one
   library), K4 and K5 (the grouped GEMMs), K6 (co-execution) and K7 (the
   capacity MoE GEMM): each one's ``ptxas -v`` report per wgmma kernel and
   its count of
   ``HGMMA`` and ``UTMALDG`` instructions (``cuobjdump -sass``), which must
   be > 0; then K1 against its plain version at the main
   path's shapes (qwen's, and phi3.5-moe's 4096-wide projections at 8 and
   208 rows), every tile height at full height and the ragged residual
   split (the 208-row prefill's 128 + 80), in float32 and bfloat16
   (elementwise, one bf16 ulp in bfloat16), with every branch of the
   wgmma body the main path uses reached (swap-AB at n8 and n16, each
   cluster size, each CTA tile), in bf16 also at gemma3-1b's,
   recurrentgemma-2b's, rwkv6-3b's and internvl2-76b's shapes and LM
   heads at every row count their serves give K1 (internvl2's
   ``frontend_proj``, 3200 x 8192, at a 208-row prefill), and at
   whisper-base's (512 x 512, 512 x 2048, 2048 x 512 at its decode rungs,
   prompt buckets, exact prompt lengths and 1,500 encoder frames, its
   tied 53,248-row head, and ``frontend_proj``, 80 x 512: K 80, a last
   stage 16 deep); and K1's
   backward at 2048 rows (dA with B transposed, dB = Aᵀ dC with Aᵀ read
   in place, the LM head's ``table.T``) at phi3.5-moe's training shapes
   and, forward and backward in bf16, at those of recurrentgemma-2b,
   rwkv6-3b and internvl2-76b with their LM heads, and internvl2's
   ``frontend_proj`` with its bias at 208 and 2048 rows; and at
   whisper-base's (12,000 encoder rows, 3,584 decoder rows with the
   head), and its ``frontend_proj`` with its bias at 1,500 and 12,000
   rows (dA with N = 80, dB with M = 80);
4. K2 (split-KV paged attention) against its plain version: GQA 14/2
   with head_dim 64 (qwen), 32/8 with head_dim 128 (phi3.5-moe), 4/1
   with head_dim 256 (gemma3-1b's global layers) and 64/8 with head_dim
   128 (internvl2-76b: a group of 8 query heads, each plan's threads
   and shared memory within a CTA's) and 8/8 with head_dim 64
   (whisper-base: a group of 1), 16-token pages and 16-page tables, and
   whisper-base's layout also on its 28-page tables with pages of 16 and
   of 32, q in f32 and bf16, tables with sink entries, a row at
   position 0 (every split but the first empty), rows on page edges and
   on either side of the plan's first two split edges, a full row;
5. K4 (flat grouped GEMM) against its plain version at phi3.5-moe's
   expert shapes (4096 -> 6400 and 6400 -> 4096, 16 experts): decode-
   and prefill-like expert sizes, sizes off the row block, tail tiles, a
   capacity-strided layout, a 2048-token training layout and shared-gid
   a2a segments, in float32 and bfloat16; rows past each tile's ``hi``
   must be exactly 0.  Then the backward at the same layouts: K4's dX
   (``w`` read transposed, through a K-major map) and K5's dW against
   their plain versions, with empty experts' dW blocks exactly 0.  The
   rows outside every segment hold NaN in x and large finite values in
   dy (the reference masks only X).  Every bf16 case must take the wgmma
   route, and together they must reach every route (``k4_plan`` /
   ``k5_plan``: swap-AB width, warpgroups, stages) of phi3.5-moe's
   decode, 208-token prefill and 2048-token training step.  Then K2 on
   int8 pools (``quantize_page_pool``) at the cases of phase 4; K3 (split-K)
   at qwen's decode GEMV shapes, two slab depths each (clusters of 2, 4,
   7 and 8), two taller passes, and ragged edges (bf16 of whole-stage
   slabs one launch of the wgmma body, the rest on the CUDA-core route);
   K7 (the capacity MoE GEMM) at phi3.5-moe's expert shapes with
   capacities 2, 37 and 320; and K6 (co-execution) on the four
   scenarios of ``benchmarks/multi_tenant_bench.py`` at Qwen2.5-0.5B's
   Table 2 widths, tasks in the packer's order: each against its plain
   version in f32 and bf16, padding rows exactly 0, and fused equal to
   ``sequential_matmul`` bit for bit;
6. small float32 models (qwen2.5-0.5b's widths, and phi3.5-moe's layer
   structure at narrow widths with 8 experts, each 2 layers; gemma3-1b's
   layer structure, 5 sliding-window layers to 1 global, at narrow
   widths with a window of 16 and 12 layers; internvl2-76b's, GQA 8 to
   a KV head and its stub frontend, with 2 layers; recurrentgemma-2b's,
   RG-LRU and sliding-window layers, with a window of 16 and 6 layers,
   and rwkv6-3b's, WKV layers, with 4 layers, at narrow widths) served on the
   card (kernels) and on the CPU (plain versions) through each engine
   kind (``"paged"``, ``"slot"``, ``"sequential"``; all but the
   global-only ones with prompts across the window and past
   ``max_seq``, those past the page table left out on paged): identical
   greedy tokens per kind, and on the card the slot engine's equal to
   the paged engine's; the same requests through ``ServeFrontend`` over
   the slot and paged engines on the card, submitted out of order from
   two threads, equal to the CPU offline ``run()``'s; and one train
   step of each on both (internvl2's on a batch with
   ``frontend_embeds``): the loss, every gradient and the parameters
   after AdamW; and whisper-base's structure (2 bidirectional encoder
   layers, 2 decoder layers with cross-attention, 37 frames) served on
   the card and the CPU through all three kinds, each request with its
   own seeded features but one sharing another's (identical greedy
   tokens; on paged, pages of 16 leave the last cross page ragged, one
   cross block is shared and every page comes back), and one train step
   card vs CPU;
7. ``qwen2.5-0.5b`` at full width in bfloat16 (seeded random weights)
   served through ``make_engine(kind="paged")``: 8 requests of 16-200
   prompt tokens, two sharing a 32-token prefix, 32 new tokens each;
   the launch counters are zeroed just before and K1's and K2's must be
   > 0 just after, every request prefilled once; the same 8 requests
   through ``kind="slot"`` (after ``warmup()``, ``decode_compiles`` 0)
   and ``kind="sequential"`` on the dense KV cache: K1's counter > 0 and
   K2's 0, every slot drained, and how many completions equal the paged
   serve's (printed, not asserted: bf16 sums at other M may flip a
   greedy token); one ``prefill_batch`` of the 8 prompts on the slot
   engine, its first tokens and parked caches against single prefills
   (``COALESCED_REL``); then the same serve on
   int8 page pools (``kv_quant="int8"``: K2's int8 variant > 0 and its
   float one 0, pool bytes (hd + 2) / (2 hd) of the bf16 pools', one K2
   launch on the serve's own pools against the plain version), and 16
   requests on the 8 slots with and without ``coexec_backend="kernel"``
   (identical tokens, backfilled prefills > 0; the serve without it runs
   with ``multi_tenant=False``, whose packing stats nothing reads);
8. the online frontend, after the coalesced-prefill check of phase 7,
   on the same weights: the 8 requests through ``ServeFrontend`` over
   ``make_engine(kind="paged")`` (``warmup()`` first), submitted by a
   separate thread at seeded exponential gaps (mean 100 ms), one with
   an ``on_token`` callback, then ``drain``: every handle at
   ``length``, the callback's stream its handle's tokens, K1 and K2 > 0
   (counters zeroed just before), ``decode_compiles`` 0, the pool
   drained; printed: completions equal to the offline paged serve's,
   user-observed TTFT and TPOT p50/p99 and tok/s beside the offline
   serve's in the same call, and the card's idle share over a second,
   profiled online serve.  Then a seeded fault storm
   (``FaultPlan.random(0, n_events=10, horizon=24)``, a straggler
   watchdog) on a pool of half the pages the 8 requests reserve: every
   handle resolved (``length``, ``cancelled`` or ``deadline``), no
   slot, page, reservation, orphan or prefix entry leaked, faults
   logged, K1 and K2 > 0; printed: the ``length`` survivors equal to
   the online serve's.  Then ``repro_torch.launch.serve.main`` at full
   width on the paged engine (returns 0, K1 and K2 > 0) and
   ``repro_torch.launch.train.main`` on the smoke config (returns 0,
   finite losses).  An exception in a frontend thread is recorded by
   ``threading.excepthook`` and fails the run at the next drain wait;
   both frontend threads must be gone after ``shutdown``;
9. where one decode window's time goes (``torch.profiler``), on the
   paged and on the slot engine: device time per kernel family against
   the window's wall time, and the top host ops;
10. kernel times at the main path's shapes, beside the plain versions',
   one PyTorch library call's where one computes the same function, and
   the least time the card could take (bytes over 3.35 TB/s or
   operations over 989 TFLOP/s, H100 SXM data sheet).  A time is the
   CUDA-event time of calls queued back to back behind a spin kernel, so
   the host's launch gaps do not count; the span of calls issued one
   after another (gaps included) is printed beside the kernel's as
   ``*_span``, and the kernel time ``torch.profiler`` recorded as
   ``*_profiler`` (it can drop kernels on this card).  K1's host cost per launch
   (``host_us``, beside ``torch.matmul``'s) is the host time to issue
   one step's calls, and K2's (``host_us``) the host time a
   ``paged_attention`` call.  K2 on bf16 and int8 pools is timed at the
   qwen decode step (24 layers) and at phi3.5-moe's layout (8 layers), K3
   at the qwen decode step (168 launches, every one on the wgmma route);
   K6 on each
   scenario (one fused launch on
   pre-packed operands against ``sequential_matmul``'s launches, with
   the plain version and ``torch._grouped_mm`` as the yardstick in
   bf16), each path first run once
   with the counters zeroed; K7 at phi3.5-moe's expert shapes at
   capacities 2, 37 and 320 (``torch.bmm`` as the yardstick);
11. ``gemma3-1b`` at full width and depth (26 layers, 22 of them
    sliding-window with a window of 512) in bfloat16 with seeded random
    weights, once the qwen model is freed: 8 requests of 16, 300, 511,
    512, 513, 700, 1000 and 1100 prompt tokens (1100 is past
    ``max_seq``), 32 new tokens each, through ``make_engine(kind="slot",
    max_slots=8, max_seq=1024, window=8)`` after ``warmup()``, then
    through ``kind="sequential"``, then (all but 1100, which its page
    table refuses) through ``kind="paged"`` on bf16 pools after
    ``warmup()``; the launch counters zeroed just before each serve:
    K1 > 0, every K1 launch on the wgmma route, K2 0 on the dense
    engines and 4 a decode step on paged (its int8 variant 0); each
    request's token count that of the ``max_seq`` stop rule; on slot
    and paged ``decode_compiles`` 0 and every slot drained; the dense
    cache exactly 125,829,120 bytes (the local layers' rings hold 512
    cells, the global layers' 1024), the paged pools exactly
    132,025,408 (rings of 34 pages of 16), every page and ring page
    back, ring pages reclaimed; finite logits of the 1100-token prompt;
    printed: K1's plans at gemma3's shapes, the completions the engines
    share, one profiled slot window and one paged, K1's times (as in
    phase 10) for one decode step at rung 8 and one 512-row prefill, and
    K2's for one decode step at gemma3's layout;
12. ``recurrentgemma-2b`` (13 of its 26 layers: 9 RG-LRU, 4
    sliding-window with a window of 2048, GQA 10/1 at head_dim 256) and
    ``rwkv6-3b`` (16 of its 32 WKV layers, 40 heads of 64; half depth
    since phase 20 joined, for the script's time) at full width in
    bfloat16 with
    seeded random weights, each once the model before it is freed: 8
    requests of 16, 512, 1500, 2047, 2048, 2049, 2600 and 3000 prompt
    tokens (past 2048 recurrentgemma's ring prefill and decode wrap), 32
    new tokens each, through ``make_engine(kind="slot", max_slots=8,
    max_seq=3072, window=8)`` after ``warmup()``, ``kind="sequential"``
    and ``kind="paged"`` (pages of 16) after ``warmup()``; the launch
    counters zeroed just before each serve: K1 > 0, every K1 launch on
    the wgmma route, K2 and its int8 variant 0; each request's token
    count that of the ``max_seq`` stop rule; on slot and paged
    ``decode_compiles`` 0 and every slot drained; the storage exactly the
    bytes of ``RECURRENT_BYTES`` (slot buffers and state slabs, rings,
    tables), computed from the config and printed beside; finite logits
    of the 3000-token prompt; printed: the completions the engines share,
    one profiled slot window and one paged, and K1's times for one
    decode step (rung 8) and one 2048-row prefill;
13. ``phi3.5-moe-42b`` at full width, 8 of its 32 layers (all 32 do not
    fit in 80 GB), in bfloat16 with seeded random weights, once the qwen
    model is freed: the same workload through ``make_engine(kind=
    "paged")``, with K1's, K2's and K4's counters zeroed before and > 0
    after, finite logits, ``decode_compiles`` 0, a drained pool, peak
    memory, one profiled decode window, and K4's times at the decode
    (rung 8) and 208-row prefill shapes;
14. ``phi3.5-moe-42b`` training at full width, 2 of its 32 layers (the
    most that fit with AdamW's state), once the serve's model is freed:
    ``Trainer(cfg, TrainerConfig(...)).run()`` for 6 steps of 8 x 256
    synthetic tokens, ``remat="none"``, with K1's, K4's (forward and dX)
    and K5's counters zeroed before and > 0 after and finite losses; the
    median step time, tokens/s and peak memory; one profiled step
    (device time per family: K1, K4 forward, K4 dX, K5, optimizer,
    other, and the idle share); and the times of one step's K1 (forward
    and backward), K4 forward, K4 dX and K5 work beside their plain
    versions, bounds and library calls (``torch._grouped_mm`` for K4 and
    K5).  The serve and the training run must launch K4 and K5 only
    through their wgmma routes;
15. ``internvl2-76b`` at full width, 8 of its 80 layers (all 80 are about
    141 GB), in bfloat16 with seeded random weights (exactly
    17,970,790,400 bytes): the qwen workload through
    ``make_engine(kind="slot")`` after ``warmup()``, ``kind=
    "sequential"`` and ``kind="paged"`` after ``warmup()`` (tokens, as
    the reference's engines serve it), the launch counters zeroed just
    before each serve: K1 > 0, every K1 launch on the wgmma route, K2 8
    launches a decode step on paged and 0 on the dense engines, its
    int8 variant 0; 32 tokens each, ``decode_compiles`` 0, slots drained;
    the dense cache exactly 67,108,864 bytes and the pools 67,633,664,
    computed from the config; then one ``forward_prefill`` with
    ``frontend_embeds`` of shape (1, 208, 3200): finite logits and K1's
    launches those of the token prefill plus ``frontend_proj``'s.
    Printed: the completions the engines share, one profiled paged
    window, K1's times for one decode step and K2's at the serve's
    layout (GQA 64/8 at head_dim 128, 8 layers);
16. training at full width, each model freed before the next:
    ``recurrentgemma-2b`` at 6 of its 26 layers and ``rwkv6-3b`` at 8
    of its 32 (cut since phase 20 joined, to keep the script within its
    time),
    ``internvl2-76b`` at 1 of its 80 layers with ``frontend_embeds`` in
    its batches: ``Trainer(...).run()`` for 6 steps of 8 x 256 synthetic
    tokens, ``remat="none"``: finite losses, K1 > 0 on the wgmma route;
    the median step time, tokens/s and peak memory; one step profiled
    part by part (K1 forward, K1 backward, optimizer, the recurrences
    timed alone at the step's shapes, other, and the idle share), whose
    K1 launches, forward and backward, times 6 must be the run's; and
    K1's times for one step's forward and backward GEMMs beside their
    plain versions, bounds and ``torch.matmul``;
17. ``whisper-base`` at full width and depth (6 bidirectional encoder
    layers over 1,500 frames, 6 decoder layers with cross-attention,
    bf16, 71,428,608 seeded parameters): the qwen workload, each request
    with its own seeded (1,500, 80) features (two share a block),
    through ``make_engine(kind="slot", max_slots=8, max_seq=448,
    window=8)`` after ``warmup()`` and ``kind="sequential"``, the
    counters zeroed just before each serve: K1 > 0 all on the wgmma
    route, K2 and its int8 variant 0, 32 tokens each; slot:
    ``decode_compiles`` 0, slots drained, buffers exactly 191,496,192
    bytes (the cross stacks at 1,500 frames), one window at rung 8 with
    49 K1 launches a step and the cross stacks bitwise unchanged,
    finite logits of a prefill with features.  Printed: the completions
    the engines share, one profiled slot window, K1's times for a rung-8
    decode step, one request's encoder (with the cross K/V projections)
    and ``frontend_proj``.  Then the same requests through
    ``kind="paged"`` (pages of 16) after ``warmup()``, on bf16 pools and
    on ``kv_quant="int8"``, the counters zeroed just before each: K1 > 0
    all wgmma, K2 6 launches a decode step on the pools' variant and 0
    on the other, 32 tokens each, ``decode_compiles`` 0, 7 cross blocks
    admitted and 1 shared, no prefix shared, pools exactly 192,286,528
    and 170,859,328 bytes (the cross pools, 94 pages a block, at bf16 on
    both), every slot, global page and cross page back; on bf16 pools
    one rung-8 window of 49 K1 and 6 K2 launches a step with ``ck``/``cv``
    bitwise unchanged.  Printed: the completions each paged serve shares
    with the slot serve, one profiled paged window, and K2's times at
    whisper's layout (GQA 8/8 hd 64, 6 layers, 28-page tables) on bf16
    and int8 pools.  Then ``Trainer`` for 6 steps of 8 x (1,500
    frames, 448 tokens), ``remat="none"``: finite losses, K1 > 0 on the
    wgmma route, a step profiled part by part whose K1 launches times 6
    are the run's, and K1's forward and backward times beside the plain
    version, the bound and ``torch.matmul``.
18. sharded serving on virtual ``("data", "model")`` meshes of the card
    (every shard its own allocation on ``cuda:0``): K1 at the shard
    widths of qwen2.5-0.5b and phi3.5-moe-42b on (1, 2) and (1, 4)
    (q 896 -> 448, k/v 896 -> 64, o 448 -> 896, up/gate 896 -> 2432 and
    down 2432 -> 896 at model 2, the MLP 896 -> 1216 -> 896 at 4, the
    LM head the padded vocabulary / 2 and / 4; phi's 4096 -> 2048/512
    and 1024/256), K2 at GQA 7/1 hd 64, 16/4 and 8/2 hd 128 on bf16 and
    int8 pools, ``paged_attention_sharded`` on (1, 2) against one
    launch on the whole heads, and K4 on 8 and 4 local experts (decode
    prefixes and ``a2a_segments`` tables), each against its plain
    version; the small f32 models of qwen's widths and phi's structure
    through slot and paged on (1, 2) and (2, 2), tokens identical to the
    CPU engine without a mesh; full-width qwen2.5-0.5b (24 layers, bf16)
    through slot and paged on (1, 2) and (1, 4) beside the engine
    without a mesh: K1 and K2 launches a decode step as the specs
    predict (at (1, 2) 338 and 48, at (1, 4) 388 and 24), the ranks'
    storage bytes summing to the meshless engine's, the first decode
    step's logits within ``SHARDED_REL`` of the meshless engine's, the
    tokens that agree counted, one profiled window each (collectives and
    copies shown), K1 timed at a sharded decode step; phi3.5-moe-42b at
    8 of 32 layers through paged on (1, 2) under ``"psum"`` and
    ``"all_to_all"`` expert parallelism (K1, K2, K4 launched), K4 timed
    at 8 and 4 local experts; a fault run: ``ServeFrontend`` over a
    virtual (2, 2) mesh whose probe drops the last two devices, which
    re-meshes to (1, 2) with the completions of an uninterrupted serve
    on (1, 2) (qwen's widths, 2 layers, f32); K2 timed at the shard
    layouts.  The phase prints its own elapsed time.
19. sharded training on virtual meshes of the card: K1 forward, dA and
    dB at every shard shape of the training steps and K4 forward, dX
    and K5 at 8 local experts (the psum and all_to_all layouts) against
    their plain versions on their wgmma routes; qwen2.5-0.5b at full
    width and 12 of 24 layers (bf16, seeded weights) 3 steps of 8 x 256
    tokens through ``make_train_step(cfg, mesh)`` on (2, 2) (FSDP x TP)
    and (1, 4) (attention whole), and phi3.5-moe-42b at 2 layers 2 steps
    on (1, 2) under ``"psum"`` and ``"all_to_all"``: the first step's loss
    within ``SHARD_LOSS_REL`` and ``grad_norm`` within
    ``SHARD_NORM_REL`` of the meshless port step from the same weights
    (``all_to_all``, whose capacity is per sequence chunk, too), every
    gathered gradient leaf within ``SHARDED_REL`` of it (the top-2
    flips of psum's first step against the meshless one counted by
    layer: an expert whose routed token set changed, and a router of a
    layer with a flip, in relative Frobenius norm to
    ``SHARD_EXPERT_REL``), K1, K4 and K5 launches a step equal to
    ``_predicted_train_launches``, every bf16 launch on a wgmma route,
    every replica of a part bitwise equal after every step, the ranks'
    unique parameter and moment bytes equal to the meshless bytes, each
    step's peak memory beside the bytes a rank holds, qwen's last (2, 2)
    step under ``remat="full"``, a profiled step of qwen on (2, 2) and of
    phi under psum (wall, busy and idle share, ``collective::`` device
    ms); an elastic restart: the (2, 2) state saved,
    restored onto (1, 2) by ``restore(..., mesh=, specs=)``, one more
    step whose loss is that of the meshless step from the restored
    leaves; K1 and K4/K5 timed at the sharded steps' shapes.  The phase
    prints its own elapsed time.
20. sliding-window, RG-LRU and RWKV6 layers and the vision stub on
    virtual meshes of the card: K1 forward, dA and dB at every shard
    shape of the serves and training runs below (``frontend_proj``'s
    among them) on the wgmma route, and K2 at internvl2-76b's shard
    layouts (GQA 32/4 and 16/2 hd 128) on bf16 and int8 pools, against
    their plain versions; small f32 models of gemma3's, recurrentgemma's,
    rwkv6's and internvl2's structures through slot and paged on (1, 2)
    and (2, 2) with the CPU engine's tokens, and one sharded
    ``loss_and_grads`` each on (2, 2) card against CPU; at full width
    (bf16, seeded weights, the qwen workload) gemma3-1b and
    recurrentgemma-2b at 12 of 26 layers on (1, 2), rwkv6-3b at 8 of 32
    layers and internvl2-76b at 8 of 80 on (1, 4) through slot and paged
    beside the engine without a mesh: K1 and K2 launches a decode step as
    the specs predict, the storage bytes of each part's first holder
    summing to the meshless engine's (RG-LRU's ``conv``, replicated,
    equal on every rank), the first decode step's logits on the
    meshless engine's inputs of that step within ``SHARDED_REL``, the
    tokens that agree counted, a profiled paged window with
    ``collectives_device_ms``, K1 timed at a sharded decode step;
    internvl2-76b's 208-row ``frontend_embeds`` prefill on the mesh
    within ``SHARDED_REL`` of the meshless one, K1's launches a token
    prefill's plus ``frontend_proj``'s; K2 timed at the two shard
    layouts; recurrentgemma-2b (6 layers: two pattern periods) and
    rwkv6-3b (4 layers) on (2, 2) and internvl2-76b (1 layer, batches
    of ``frontend_embeds``) on (1, 2), 2 steps of 8 x 256 tokens each
    through ``_run_sharded_train`` (the first step against the meshless
    step: loss, ``grad_norm``, every gradient leaf; launches a step as
    predicted, replicas bitwise, unique bytes, peaks, the second step
    profiled) and K1 timed at each run's step.  The phase prints its
    own elapsed time.
21. whisper-base's encoder-decoder and co-execution on virtual meshes
    of the card: K1 forward, dA and dB at every whisper shard shape of
    the serves and the training step below (q/k/v 512 -> 256 and 128,
    fc1 512 -> 1024 and 512, ``frontend_proj`` 80 -> 256 and 128, cross
    k/v on 1,500 frames, the tied head's 26,624 and 13,312 rows) on the
    wgmma route, and K2 at GQA 4/4 and 2/2 hd 64 on 28-page tables on
    bf16 and int8 pools, against their plain versions; whisper-base at
    full size (bf16, seeded weights, the qwen workload with each
    request's own (1,500, 80) features, one block shared) through slot
    and paged on (1, 2) and (1, 4) and paged on int8 pools on (1, 2),
    beside the engine without a mesh: K1 and K2 launches a decode step
    as the specs predict (98 and 12 at (1, 2), 196 and 24 at (1, 4)),
    the first holders' storage bytes, cross stacks and pools included,
    summing to the meshless engine's, ``cross_admits`` and
    ``cross_shared`` the meshless engine's, the first decode step's
    logits on the meshless engine's inputs of that step within
    ``SHARDED_REL``, tokens that agree counted, a profiled paged window,
    K1 timed at a sharded decode step and K2 at the two layouts;
    whisper-base 2 steps of 8 x (1,500 frames, 448 tokens) on (2, 2)
    through ``_run_sharded_train`` (loss, ``grad_norm``, every gradient
    leaf, the cross-attention key biases' exact-zero gradients as noise;
    launches a step, replicas bitwise, unique bytes, peaks) and K1
    timed at its step; qwen2.5-0.5b's 16 requests
    on 8 slots through paged on (1, 2) with
    ``coexec_backend="kernel"``: backfills, ``coexec_tiles`` and the
    packer's other stats equal to phase 7's meshless co-executed
    serve's, tokens that agree counted.  The phase prints its own
    elapsed time.

Phases 15-21 run after phase 14; ``elapsed after ...`` lines give the
script's time at the end of each group of phases.

The line before the last is a JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
from contextlib import redirect_stdout
from io import StringIO
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PROMPT_LENS = (16, 40, 64, 97, 128, 150, 176, 200)
NEW_TOKENS = 32
SHARED_PREFIX = 32
# phi3.5-moe-42b: 8 of its 32 layers at full width fit one 80 GB card
# (about 21 GB of bf16 weights; all 32 layers are about 84 GB).
MOE_LAYERS = 8


def _say(msg: str) -> None:
    print(msg, flush=True)


def _cuda_ms(torch, fn, iters: int = 5, warmup: int = 2) -> float:
    """CUDA-event span of one call of ``fn`` (host launch gaps included)."""
    for _ in range(warmup):
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


def _device_ms(torch, fn, iters: int = 3, label: str = ""):
    """Device time of one call of ``fn``: the self device time of every
    kernel, copy and fill it ran, from ``torch.profiler``, so the host's
    launch gaps between small kernels do not count.  Where two profiles
    in a row record no device time, None, and the events seen are
    printed.  On the H100 machines this profiler has dropped kernels
    (a sum below the work's bound, or nothing at all), so kernel times
    come from :func:`_queued_ms`; this is kept beside them."""
    from torch.profiler import profile, ProfilerActivity

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evts = prof.key_averages()
        us = sum(_self_device_us(e) for e in evts
                 if "CUDA" in str(getattr(e, "device_type", ""))
                 and not getattr(e, "is_user_annotation", False))
        if us > 0:
            return us / 1e3 / iters
    seen = sorted(((e.count, str(getattr(e, "device_type", "")), e.key[:60])
                   for e in evts), reverse=True)[:8]
    _say(f"torch.profiler recorded no device time for {label!r}: "
         f"{len(evts)} event kinds, top {seen}")
    return None


def _self_device_us(evt) -> float:
    return (getattr(evt, "self_device_time_total", 0.0)
            or getattr(evt, "self_cuda_time_total", 0.0))


def _queued_ms(torch, fn, iters: int = 5):
    """Device time of one call of ``fn``: CUDA events around ``iters``
    calls that the host queued behind a spin kernel
    (``torch.cuda._sleep``), so they run back to back without the host's
    launch gaps.  Returns ``(ms, clean)``; ``clean`` is False where the
    device reached the timed calls before the host had queued them all
    (a call that waits for the device, or more launches than the queue
    holds): the time then includes launch gaps."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    spin_s = min(2.0, 0.005 + 2 * iters * (time.perf_counter() - t0))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_s * 2e9))     # cycles, about 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    clean = not start.query()
    end.synchronize()
    return start.elapsed_time(end) / iters, clean


def _times(torch, fns: dict) -> dict:
    """For each callable: its device time under its key (CUDA events
    around calls queued back to back, :func:`_queued_ms`; ``<key>_gaps``
    is true where launch gaps could not be kept out), the CUDA-event span
    of calls issued one after another (host launch gaps included) under
    ``<key>_span``, and the sum of kernel times ``torch.profiler``
    recorded under ``<key>_profiler`` (None where it recorded none; on
    this card it can drop kernels, so it is a lower bound).  A plain
    version, the library call and any other key but ``ms`` get their
    device time only: the plain versions' thousands of small kernels
    made the span and the profile the costliest part of the script, and
    nothing reads them but the kernel's."""
    out = {}
    for key, fn in fns.items():
        out[key], clean = _queued_ms(torch, fn)
        if not clean:                   # fewer launches behind the spin
            out[key], clean = _queued_ms(torch, fn, iters=1)
        if not clean:
            out[key + "_gaps"] = True
        if key != "ms":
            continue
        out[key + "_span"] = _cuda_ms(torch, fn, iters=3)
        out[key + "_profiler"] = _device_ms(torch, fn, label=key)
    return out


# Each kernel's launch counter name, also a substring of its CUDA symbol.
KERNEL_NAMES = ("sisa_gemm", "paged_attn", "grouped_gemm")
K1_ROWS = (1, 8, 16, 32, 64, 128, 200, 208, 256)
K1_PHI_ROWS = (8, 208)      # phi3.5-moe's 4096-wide projections
BF16_REL = 2.0 ** -7        # one bf16 ulp, relative to the value
# A coalesced prefill runs K1 at M = rung x bucket, a single one at M =
# bucket: other plans, other summation orders, and the difference passes
# through 24 layers.  A parked cache tensor must lie within 2^-4 of its
# largest magnitude (8 bf16 ulps there) of the single prefill's, and a
# first token must equal the single prefill's wherever that prefill's
# top-2 logit margin exceeds 2^-4 of its top logit's magnitude.
COALESCED_REL = 2.0 ** -4


def _f32_atol(ref) -> float:
    """f32 sums of up to 4864 terms in different orders."""
    return 2e-5 * max(1.0, ref.float().abs().max().item())


def _max_err(what, got, ref, rel, atol) -> float:
    """Max abs error of ``got`` against ``ref``; raises unless every
    element holds ``|got - ref| <= rel * |ref| + atol``.  bf16 takes
    ``rel`` = one ulp: the kernel and the plain version sum in f32 in
    different orders (``atol``), then each rounds once."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    bad = ~(diff <= rel * ref.abs() + atol)
    if bad.any():
        i = bad.nonzero()[0].tolist()
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements off, first at {i}: got "
            f"{got[tuple(i)].item()}, plain {ref[tuple(i)].item()} "
            f"(rel {rel}, atol {atol})")
    return diff.max().item()


def _k1_cases(torch, gen, dtype, table, m):
    """(name, A's column count, A's row stride, B) at the main path's
    shapes, then ragged edges: K and N off every tile multiple with
    16-byte aligned rows (strided views: TMA's zero fill on the tensor
    cores), and K = 100, whose rows are not 16-byte aligned (the
    CUDA-core body).  phi3.5-moe's 4096-wide q and k/v projections at
    ``K1_PHI_ROWS``."""
    def rand(*shape):
        return (torch.randn(*shape, device="cuda", generator=gen)
                / shape[0] ** 0.5).to(dtype)

    for k, n in ((896, 896), (896, 128), (896, 4864), (4864, 896)):
        yield f"{k}x{n}", k, k, rand(k, n)
    if m in K1_PHI_ROWS:
        for k, n in ((4096, 4096), (4096, 1024)):
            yield f"phi {k}x{n}", k, k, rand(k, n)
    yield "lm_head 896x153600 trans_b", 896, 896, table.T
    yield "ragged 900x1000", 900, 904, rand(900, 1008)[:, :1000]
    yield "ragged 900x1000 trans_b", 900, 904, rand(1000, 904)[:, :900].T
    yield "unaligned 100x36", 100, 100, rand(100, 36)


# gemma3-1b's K1 shapes (k, n): q, k and v, o, gate and up, down; its tied
# LM head is table.T, 1152 x 262144.
GEMMA_K1 = ((1152, 1024), (1152, 256), (1024, 1152), (1152, 6912),
            (6912, 1152))
GEMMA_HEAD = (262144, 1152)


def _gemma_k1_rows():
    """The rows gemma3's serve (``serve_gemma3``) gives K1: decode
    batches of 1 to 8 rows, logits read for every row; and the prefills
    of ``GEMMA_LENS``, the slot engine's power-of-two buckets (8 at
    least, ``GEMMA_MAX_SEQ`` at most) and the sequential engine's exact
    lengths, 1100 exact in both, the LM head on 1 row."""
    buckets = {min(1 << max(3, (s - 1).bit_length()), GEMMA_MAX_SEQ)
               for s in GEMMA_LENS if s <= GEMMA_MAX_SEQ}
    return tuple(range(1, 9)), tuple(sorted(buckets | set(GEMMA_LENS)))


def _k1_gemma_cases(torch, gen, table, head):
    """(name, A's column count, A's row stride, B) at gemma3's shapes,
    bf16; the tied LM head (trans_b) when ``head``."""
    for k, n in GEMMA_K1:
        yield (f"gemma {k}x{n}", k, k,
               (torch.randn(k, n, device="cuda", generator=gen)
                / k ** 0.5).bfloat16())
    if head:
        yield (f"gemma lm_head {table.shape[1]}x{table.shape[0]} trans_b",
               table.shape[1], table.shape[1], table.T)


# recurrentgemma-2b's and rwkv6-3b's K1 shapes (k, n), bf16: q, o and the
# RG-LRU in_gate, in_rec and out (2560 x 2560, also rwkv6's r, k, v, w and
# o), recurrentgemma's k and v (one KV head of 256), its gate and up, and
# down; rwkv6's relu^2 up and down.  Their LM heads are table.T:
# recurrentgemma's tied 256000-row table, rwkv6's untied 65536 rows.
RECURRENT_K1 = ((2560, 2560), (2560, 256), (2560, 7680), (7680, 2560),
                (2560, 8960), (8960, 2560))
RECURRENT_HEADS = ((256000, 2560), (65536, 2560))
# internvl2-76b's K1 shapes (k, n), bf16: q and o, k and v (8 KV heads of
# 128), gate and up, down; its stub vision frontend's frontend_proj (3200
# -> 8192; its bias is added after K1) at the rows of one prefill with
# frontend_embeds; its untied LM head is table.T, 8192 x 129024 (the
# 128,256-token vocabulary padded to a multiple of 1024, padded_vocab).
INTERNVL_K1 = ((8192, 8192), (8192, 1024), (8192, 28672), (28672, 8192))
INTERNVL_FRONTEND = (3200, 8192)
INTERNVL_HEAD = (129024, 8192)
FRONTEND_ROWS = 208
# whisper-base's K1 shapes (k, n), bf16: q, k, v and o of its self and
# cross attention (8 heads of 64), up (GELU, no gate) and down, each with
# a bias added after K1; its stub audio frontend's frontend_proj (80 mel
# bins -> 512: K = 80, two 64-deep stages, the second 16 deep, the first
# K of the main path that is not whole stages); its tied LM head is
# table.T, 512 x 53248 (the 51,865 tokens padded to a multiple of 2048).
# A request's encoder runs over 1,500 frames (11 x 128 + 92 rows), and so
# do its cross K/V projections; training over 8 x 1,500 frames and the
# decoder's 8 x 448 tokens.
WHISPER_K1 = ((512, 512), (512, 2048), (2048, 512))
WHISPER_FRONTEND = (80, 512)
WHISPER_HEAD = (53248, 512)
WHISPER_FRAMES = 1500
WHISPER_MAX_SEQ = 448


def _recurrent_k1_rows():
    """The rows the recurrent serve (``serve_recurrent``) gives K1:
    decode batches of 1 to 8 rows, logits read for every row; and the
    prefills of ``RECURRENT_LENS`` at the slot engine's power-of-two
    buckets (at most ``RECURRENT_MAX_SEQ``), the paged engine's 16-token
    pages and the sequential engine's exact lengths, each also padded
    to the WKV layers' 32-token chunks (their r/k/v/w projections run
    on the padded rows), the LM head on 1 row."""
    lens = set(RECURRENT_LENS)
    lens |= {min(1 << max(3, (s - 1).bit_length()), RECURRENT_MAX_SEQ)
             for s in RECURRENT_LENS}
    lens |= {-(-s // 16) * 16 for s in RECURRENT_LENS}
    lens |= {-(-s // 32) * 32 for s in lens}
    return tuple(range(1, 9)), tuple(sorted(lens))


def _internvl_k1_rows():
    """The rows the internvl2-76b serve (``serve_internvl2``, the qwen
    workload at ``max_seq`` 256) gives K1: decode batches of 1 to 8
    rows, logits read for every row; the prefills of ``PROMPT_LENS`` at
    the slot engine's power-of-two buckets (8 at least, 256 at most),
    the paged engine's 16-token pages and the sequential engine's exact
    lengths, the LM head on 1 row; and the frontend prefill's
    ``FRONTEND_ROWS``."""
    lens = set(PROMPT_LENS) | {FRONTEND_ROWS}
    lens |= {min(1 << max(3, (s - 1).bit_length()), 256)
             for s in PROMPT_LENS}
    lens |= {-(-s // 16) * 16 for s in PROMPT_LENS}
    return tuple(range(1, 9)), tuple(sorted(lens))


def _whisper_k1_rows():
    """The rows whisper-base's serves (``serve_whisper``: ``PROMPT_LENS``
    at ``max_seq`` 448) give K1: decode batches of 1 to 8 rows, logits
    read for every row; the decoder's prefills at the slot engine's
    power-of-two buckets (8 at least) and the sequential engine's exact
    lengths, the LM head on 1 row; and each request's 1,500-frame
    encoder and cross K/V projections."""
    lens = set(PROMPT_LENS) | {WHISPER_FRAMES}
    lens |= {min(1 << max(3, (s - 1).bit_length()), WHISPER_MAX_SEQ)
             for s in PROMPT_LENS}
    return tuple(range(1, 9)), tuple(sorted(lens))


def _k1_plans_of(kernels, m, k, n):
    """The launch plans of one bf16 K1 call with aligned rows: one per
    row pass (the ragged residual is its own pass)."""
    return [kernels.k1_plan(hi - lo, n, k) for lo, hi in kernels.row_passes(m)]


def check_k1(torch, kernels, gen) -> float:
    """Every tile height at full height (M = 16, 32, 64, 128, 256), the
    decode rungs 1 and 8, and the ragged main-plus-residual split
    (M = 200 and the 208-row prefill's 128 + 80), each at the main path's
    shapes and the ragged cases; then, in bf16, gemma3's shapes at every
    row count its serve gives K1 (``_gemma_k1_rows``), and the recurrent
    models' at theirs (``_recurrent_k1_rows``).  The bf16 plans
    reached must cover every branch of K1's wgmma body that the main
    path's shapes use: swap-AB at n8 and n16, each cluster size, and
    each CTA tile."""
    worst, n_cases = 0.0, 0
    reached = set()

    def check(dtype, m, name, k, lda, b):
        nonlocal worst, n_cases
        a = torch.randn(m, lda, device="cuda",
                        generator=gen).to(dtype)[:, :k]
        ref = kernels.sisa_gemm_plain(a, b)
        err = _max_err(f"K1 {dtype} M={m} {name}", kernels.sisa_matmul(a, b),
                       ref, 0.0 if dtype == torch.float32 else BF16_REL,
                       _f32_atol(ref))
        worst = max(worst, err)
        n_cases += 1
        if dtype == torch.bfloat16 and k % 8 == 0:
            reached.update((p.swap_ab, p.bm, p.bn, p.cluster)
                           for p in _k1_plans_of(kernels, m, k, b.shape[1]))

    for dtype in (torch.float32, torch.bfloat16):
        table = (torch.randn(153600, 896, device="cuda", generator=gen)
                 / 896 ** 0.5).to(dtype)
        for m in K1_ROWS:
            for case in _k1_cases(torch, gen, dtype, table, m):
                check(dtype, m, *case)
    decode_rows, prefill_rows = _gemma_k1_rows()
    table = (torch.randn(*GEMMA_HEAD, device="cuda", generator=gen)
             / GEMMA_HEAD[1] ** 0.5).bfloat16()
    for m in decode_rows + prefill_rows:
        for case in _k1_gemma_cases(torch, gen, table,
                                    head=m in decode_rows):
            check(torch.bfloat16, m, *case)
    del table
    rec_decode, rec_prefill = _recurrent_k1_rows()
    for head in RECURRENT_HEADS:
        table = (torch.randn(*head, device="cuda", generator=gen)
                 / head[1] ** 0.5).bfloat16()
        for m in rec_decode:
            check(torch.bfloat16, m, f"lm_head {head[1]}x{head[0]} "
                  "trans_b", head[1], head[1], table.T)
        del table
    for k, n in RECURRENT_K1:
        b = (torch.randn(k, n, device="cuda", generator=gen)
             / k ** 0.5).bfloat16()
        for m in rec_decode + rec_prefill:
            check(torch.bfloat16, m, f"recurrent {k}x{n}", k, k, b)
    in_decode, in_prefill = _internvl_k1_rows()
    table = (torch.randn(*INTERNVL_HEAD, device="cuda", generator=gen)
             / INTERNVL_HEAD[1] ** 0.5).bfloat16()
    for m in in_decode:
        check(torch.bfloat16, m, f"internvl2 lm_head {INTERNVL_HEAD[1]}x"
              f"{INTERNVL_HEAD[0]} trans_b", INTERNVL_HEAD[1],
              INTERNVL_HEAD[1], table.T)
    del table
    for k, n in INTERNVL_K1:
        b = (torch.randn(k, n, device="cuda", generator=gen)
             / k ** 0.5).bfloat16()
        for m in in_decode + in_prefill:
            check(torch.bfloat16, m, f"internvl2 {k}x{n}", k, k, b)
        del b
    k, n = INTERNVL_FRONTEND
    check(torch.bfloat16, FRONTEND_ROWS, f"internvl2 frontend_proj {k}x{n}",
          k, k, (torch.randn(k, n, device="cuda", generator=gen)
                 / k ** 0.5).bfloat16())
    wh_decode, wh_prefill = _whisper_k1_rows()
    table = (torch.randn(*WHISPER_HEAD, device="cuda", generator=gen)
             / WHISPER_HEAD[1] ** 0.5).bfloat16()
    for m in wh_decode:
        check(torch.bfloat16, m, f"whisper lm_head {WHISPER_HEAD[1]}x"
              f"{WHISPER_HEAD[0]} trans_b", WHISPER_HEAD[1],
              WHISPER_HEAD[1], table.T)
    del table
    for k, n in WHISPER_K1:
        b = (torch.randn(k, n, device="cuda", generator=gen)
             / k ** 0.5).bfloat16()
        for m in wh_decode + wh_prefill:
            check(torch.bfloat16, m, f"whisper {k}x{n}", k, k, b)
    k, n = WHISPER_FRONTEND
    b = (torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
         ).bfloat16()
    for m in (1, 8, WHISPER_FRAMES):      # K = 80: the 16-deep last stage
        check(torch.bfloat16, m, f"whisper frontend_proj {k}x{n}", k, k, b)
    # qwen's serve (decode rungs, the 208-row prefill), phi's serve and
    # training (2048 rows), gemma3's serve, the recurrent models' serves.
    qwen = ((896, 896), (896, 128), (896, 4864), (4864, 896), (896, 153600))
    phi = ((4096, 4096), (4096, 1024), (4096, 32768))
    gemma_head = GEMMA_K1 + ((GEMMA_HEAD[1], GEMMA_HEAD[0]),)
    rec_head = RECURRENT_K1 + tuple((h[1], h[0]) for h in RECURRENT_HEADS)
    in_head = INTERNVL_K1 + ((INTERNVL_HEAD[1], INTERNVL_HEAD[0]),)
    wh_head = WHISPER_K1 + ((WHISPER_HEAD[1], WHISPER_HEAD[0]),)
    main_path = [p for ms, shapes in (((1, 8, 16, 208), qwen),
                                      ((8, 208, 2048), phi),
                                      (decode_rows, gemma_head),
                                      (prefill_rows, GEMMA_K1),
                                      (rec_decode, rec_head),
                                      (rec_prefill, RECURRENT_K1),
                                      (in_decode, in_head),
                                      (in_prefill, INTERNVL_K1),
                                      ((FRONTEND_ROWS,),
                                       (INTERNVL_FRONTEND,)),
                                      (wh_decode, wh_head),
                                      (wh_prefill, WHISPER_K1),
                                      ((WHISPER_FRAMES,),
                                       (WHISPER_FRONTEND,)))
                 for m in ms for k, n in shapes
                 for p in _k1_plans_of(kernels, m, k, n)]

    def branches(plans):
        return ({("swap", p[1]) for p in plans if p[0]}
                | {("cluster", p[3]) for p in plans}
                | {("tile", p[1], p[2]) for p in plans if not p[0]})

    need = branches([(p.swap_ab, p.bm, p.bn, p.cluster) for p in main_path])
    got = branches(reached)
    if need - got:
        raise AssertionError(f"K1 branches of the main path not checked: "
                             f"{sorted(need - got)}")
    _say(f"k1: {n_cases} cases (M in {K1_ROWS}; main-path shapes and "
         f"ragged edges; f32 and bf16; gemma3's shapes in bf16 at M in "
         f"{decode_rows + prefill_rows}; recurrentgemma-2b's and "
         f"rwkv6-3b's in bf16 at M in {rec_decode + rec_prefill}, their "
         f"LM heads at M in {rec_decode}; internvl2-76b's in bf16 at M in "
         f"{in_decode + in_prefill}, its LM head at M in {in_decode}, its "
         f"frontend_proj at M {FRONTEND_ROWS}; whisper-base's in bf16 at M "
         f"in {wh_decode + wh_prefill}, its LM head at M in {wh_decode}, "
         f"its frontend_proj (K 80) at M 1, 8 and {WHISPER_FRAMES}) agree "
         f"with the plain "
         f"version (max abs err {worst}; elementwise tol f32 2e-5*max|ref|, "
         f"bf16 "
         f"2^-7*|ref| + 2e-5*max|ref|); bf16 plans reached (swap-AB, bm, bn, "
         f"cluster): {sorted(reached)}")
    return worst


# The libraries whose bf16 bodies run on hopper_gemm.cuh's TMA + wgmma
# mainloop, with the template parameters of their wgmma kernels (K3 runs
# K1's instantiations, in sisa_gemm's library; K6's one kernel switches
# over its group widths at run time).
WGMMA_LIBS = {"sisa_gemm": "NWG, BQ, STAGES, X_MN, Y_MN, SWAP",
              "grouped_gemm": "NWG, BQ, STAGES, X_MN",
              "grouped_dw": "NWG, BQ, STAGES",
              "moe_gemm": "NWG, BQ, STAGES",
              "coexec": ""}


def wgmma_build_report(build) -> None:
    """The libraries of K1 and K3, K4, K5, K6 and K7 as built: ``ptxas -v``
    (registers, shared memory, spills) of each wgmma kernel, and the count of
    ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions in each
    library's SASS, which must be > 0; then K2's registers and spills."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    for name, params in WGMMA_LIBS.items():
        lib = build.library_path(name)
        lines = lib.with_suffix(".log").read_text().splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "wgmma_kernel" in line:
                args = re.findall(r"L[ib](\d+)E",
                                  line.split("wgmma_kernelI")[-1])
                stats = " ".join(x.split("ptxas info    :")[-1].strip()
                                 for x in lines[i + 1:i + 4]
                                 if "registers" in x or "spill" in x)
                n = params.count(",") + 1
                what = (f"<{params}> = <{', '.join(args[:n])}>" if params
                        else "wgmma kernel")
                _say(f"{name} ptxas {what}: {stats}")
        if not tool.exists():
            _say(f"{name} sass: cuobjdump not in the toolkit; HGMMA/UTMALDG "
                 "not counted")
            continue
        sass = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        hgmma, utmaldg = sass.count("HGMMA"), sass.count("UTMALDG")
        _say(f"{name} sass: {hgmma} HGMMA, {utmaldg} UTMALDG, "
             f"{sass.count('UTMASTG')} UTMASTG instructions")
        if not hgmma or not utmaldg:
            raise AssertionError(f"{name}'s library has no wgmma or no TMA "
                                 "load")
    # K2's instantiations (<q, pool, head_dim, int8> as mangled): registers
    # and spills.
    lines = build.library_path("paged_attn").with_suffix(
        ".log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "split_kernelI" in line:
            args = line.split("split_kernelI")[-1].split("EEv")[0]
            stats = " ".join(x.split("ptxas info    :")[-1].strip()
                             for x in lines[i + 1:i + 4]
                             if "registers" in x or "spill" in x)
            _say(f"paged_attn ptxas <{args}>: {stats}")


def _attn_inputs(torch, gen, dtype, pos, n_pages=128, pmax=16,
                 heads=(14, 2, 64), psz=16):
    b = len(pos)
    h, hkv, hd = heads
    q = torch.randn(b, h, hd, device="cuda", generator=gen).to(dtype)
    pk = torch.randn(n_pages + 1, psz, hkv, hd, device="cuda",
                     generator=gen).to(dtype)
    pv = torch.randn(n_pages + 1, psz, hkv, hd, device="cuda",
                     generator=gen).to(dtype)
    perm = torch.randperm(n_pages, device="cuda", generator=gen)
    table = perm[:b * pmax].reshape(b, pmax).to(torch.int32)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    live = (torch.arange(pmax, device="cuda")[None, :]
            <= (pos_t // psz)[:, None])
    table = torch.where(live, table, n_pages)          # sink past pos
    return q, pk, pv, table, pos_t


# qwen2.5-0.5b, phi3.5-moe-42b, gemma3-1b's global layers, internvl2-76b
# (a group of 8 query heads, the widest K2 runs), whisper-base's decoder
# self-attention (a group of 1: a CTA of 64 threads at 2 pages a split).
K2_HEADS = ((14, 2, 64), (32, 8, 128), (4, 1, 256), (64, 8, 128),
            (8, 8, 64))
# whisper-base's page table at max_seq 448 in pages of 16 is 28 pages
# wide; K2 is held there at pages of 16 and of 32 (the most its lanes
# take), on 16-page tables at every layout above.
WHISPER_PMAX = 28
K2_CASES = tuple((heads, 16, 16) for heads in K2_HEADS) + tuple(
    (K2_HEADS[4], psz, WHISPER_PMAX) for psz in (16, 32))


def _k2_cases(torch, kernels, gen, quant):
    """K2 against its plain version at every case of ``K2_CASES`` (head
    layout, page size, table width), q in f32 and bf16, float or int8
    pools, 8 rows: a row at ``pos`` 0 (every split but the first empty),
    rows ending on a page edge and on either side of the first two split
    edges of the plan the wrapper takes, a full row, and dead table
    entries on the sink."""
    worst, edges = 0.0, set()
    for heads, psz, pmax in K2_CASES:
        h, hkv, hd = heads
        for dtype in (torch.float32, torch.bfloat16):
            size = 1 if quant else torch.tensor([], dtype=dtype).element_size()
            plan = kernels.k2_plan(8, h, hkv, hd, psz, pmax, size, quant)
            # One warp a (page of the split, query head) of one KV head,
            # and the split's pages in shared memory, within a CTA.
            pps = plan.pages_per_split
            smem = kernels.paged_attn.k2_smem_bytes(h // hkv, psz, pps, hd,
                                                    size, quant)
            if 32 * (h // hkv) * pps > 1024 \
                    or smem > kernels.paged_attn.K2_MAX_SMEM:
                raise AssertionError(f"K2 plan {plan} at {heads}: "
                                     f"{32 * (h // hkv) * pps} threads, "
                                     f"{smem} bytes of shared memory")
            edge, full = pps * psz, pmax * psz
            edges.add(edge)
            pos = [0, psz, edge - 1, edge, 2 * edge - 1,
                   min(2 * edge, full - 2), full // 2, full - 1]
            q, pk, pv, table, pos_t = _attn_inputs(
                torch, gen, dtype, pos, n_pages=8 * pmax, pmax=pmax,
                heads=heads, psz=psz)
            pools = _int8_pools(kernels, pk, pv) if quant else (pk, pv)
            rel = 0.0 if dtype == torch.float32 else BF16_REL
            worst = max(worst, _max_err(
                f"K2 {'int8 ' if quant else ''}{heads} psz {psz} pmax "
                f"{pmax} {dtype} {plan}",
                kernels.paged_attention(q, pools[0], pools[1], table, pos_t,
                                        *pools[2:]),
                kernels.paged_attention_plain(q, pools[0], pools[1], table,
                                              pos_t, *pools[2:]),
                rel, 1e-5))
    return worst, sorted(edges)


def check_k2(torch, kernels, gen) -> float:
    worst, edges = _k2_cases(torch, kernels, gen, quant=False)
    _say(f"k2: GQA 14/2 hd 64, GQA 32/8 hd 128, GQA 4/1 hd 256, GQA 64/8 "
         f"hd 128 and GQA 8/8 hd 64 (plans within a CTA's threads and "
         f"shared memory), psz 16 on 16-page tables, and GQA 8/8 hd 64 at "
         f"psz 16 and 32 on {WHISPER_PMAX}-page tables, "
         f"f32 and bf16, split edges at cells {edges}, pos 0, full rows and "
         f"sink entries, "
         f"agree with the plain version (max abs err {worst}; elementwise "
         f"tol f32 1e-5, bf16 2^-7*|ref| + 1e-5)")
    return worst


# phi3.5-moe-42b's expert FFN: 16 experts, top-2, d 4096, d_ff 6400.
MOE_D, MOE_FF, MOE_E = 4096, 6400, 16


def _k4_layouts(torch, kernels):
    """(name, m, starts, sizes, gids, bm) at the path's row blocks: the
    rung-8 decode (16 pairs over 16 experts, capacity 8, bm 16), 208-token
    prefills (416 pairs; capacity 32 with bm 32 and the serve's capacity
    40 with bm 64, sizes off the row block, some experts full and some
    empty), each with tail tiles past every segment, and a capacity-
    strided layout whose stride 40 forces ``aligned_block_rows`` to 8."""
    def prefix(sizes, cap, bm):
        sizes = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        starts = kernels.flat_group_offsets(sizes, bm)[:-1]
        m = MOE_E * (-(-cap // bm)) * bm
        return m, starts, sizes, torch.arange(MOE_E, dtype=torch.int32,
                                              device="cuda"), bm

    decode = [2, 0, 1, 1, 0, 2, 3, 0, 1, 1, 2, 0, 1, 1, 1, 0]
    pre32 = [32, 0, 32, 17, 32, 32, 5, 0, 32, 31, 32, 32, 9, 32, 32, 32]
    pre40 = [40, 0, 40, 40, 37, 0, 21, 40, 40, 40, 3, 40, 40, 1, 40, 34]
    bm8 = kernels.aligned_block_rows(40, MOE_FF, MOE_D, torch.bfloat16,
                                     align_to=40)
    ar = torch.arange(MOE_E, dtype=torch.int32, device="cuda")
    yield ("decode rung 8",) + prefix(decode, 8, 16)
    yield ("prefill cap 32",) + prefix(pre32, 32, 32)
    yield ("prefill cap 40",) + prefix(pre40, 40, 64)
    yield ("capacity stride 40",  MOE_E * 40, ar * 40,
           torch.tensor(pre40, dtype=torch.int32, device="cuda"), ar, bm8)


DEAD_DY = 3.0e4     # dy's rows outside every segment: large, finite


def _poison(x, covered, value):
    """``x`` with the rows outside every segment set to ``value``: the
    kernels must not let them reach a live output."""
    return x.masked_fill(~covered[:, None], value)


def _covered(torch, m, starts, sizes):
    covered = torch.zeros(m, dtype=torch.bool, device="cuda")
    for s, n in zip(starts.tolist(), sizes.tolist()):
        covered[s:s + n] = True
    return covered


def _main_routes(torch, kernels):
    """The wgmma routes, ``(counter, bq, nwg, stages)``, that phi3.5-moe's
    serve and training take: K4's forward at the rung-8 decode, a
    208-token prefill and a 2048-token step, K4's dX and K5 at the step,
    each at the row block and flat size the MoE layer picks."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cf = get_config("phi3.5-moe-42b").moe.capacity_factor
    routes = set()
    for tokens in (8, 208, 2048):
        cap = moe._capacity(tokens, MOE_E, 2, cf)
        bm = kernels.flat_block_rows(min(cap, 64), MOE_FF, MOE_D,
                                     torch.bfloat16)
        n_mt = MOE_E * -(-cap // bm)
        names = ("grouped_gemm",) + (("grouped_gemm_dx",) if tokens == 2048
                                     else ())
        for k in (MOE_D, MOE_FF):
            p = kernels.k4_plan(bm, n_mt, k)
            routes |= {(name, p.bq, p.nwg, p.stages) for name in names}
    p = kernels.k5_plan()
    return routes | {("grouped_dw", p.bq, p.nwg, p.stages)}


def _wgmma_routed(routes, before, names) -> None:
    """One more launch of each of ``names`` on a wgmma route than
    ``before``: the case did not take the CUDA-core body."""
    for name in names:
        n = sum(c for r, c in routes.items() if r[0] == name)
        m = sum(c for r, c in before.items() if r[0] == name)
        if n != m + 1:
            raise AssertionError(f"a bf16 {name} launch left the wgmma "
                                 f"route ({m} -> {n})")


def check_k4(torch, kernels, gen) -> float:
    """K4 against its plain version at every layout of ``_k5_layouts``,
    up/gate (4096 -> 6400) and down (6400 -> 4096), f32 and bf16, with
    NaN in x's rows outside every segment; those rows must come out
    exactly 0, and each bf16 case must take the wgmma route."""
    from repro_torch.kernels.grouped_gemm import ROUTE_LAUNCHES

    worst, n_cases = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        rel = 0.0 if dtype == torch.float32 else BF16_REL
        ws = {(k, n): (torch.randn(MOE_E, k, n, device="cuda", generator=gen)
                       / k ** 0.5).to(dtype)
              for k, n in ((MOE_D, MOE_FF), (MOE_FF, MOE_D))}
        for name, m, starts, sizes, gids, bm in _k5_layouts(torch, kernels):
            covered = _covered(torch, m, starts, sizes)
            for (k, n), w in ws.items():
                x = _poison(torch.randn(m, k, device="cuda",
                                        generator=gen).to(dtype),
                            covered, float("nan"))
                before = dict(ROUTE_LAUNCHES)
                got = kernels.segment_grouped_gemm(x, w, starts, sizes, gids,
                                                   block_rows=bm)
                ref = kernels.segment_grouped_gemm_plain(
                    x, w, starts, sizes, gids, block_rows=bm)
                what = f"K4 {dtype} {name} bm {bm} {k}x{n}"
                if dtype == torch.bfloat16:
                    _wgmma_routed(ROUTE_LAUNCHES, before, ("grouped_gemm",))
                worst = max(worst, _max_err(what, got, ref, rel,
                                            _f32_atol(ref)))
                if (got[~covered] != 0).any():
                    raise AssertionError(f"{what}: a row outside every "
                                         "segment is not 0")
                n_cases += 1
    _say(f"k4: {n_cases} cases (decode- and prefill-like expert sizes, "
         f"tail tiles, capacity stride, 2048-token training, shared-gid "
         f"a2a; 4096x6400 and 6400x4096; f32 and bf16; NaN in x's rows "
         f"outside every segment) agree with the plain version (max abs "
         f"err {worst}; elementwise tol f32 2e-5*max|ref|, bf16 "
         f"2^-7*|ref| + 2e-5*max|ref|; uncovered rows exactly 0)")
    return worst


def _k5_layouts(torch, kernels):
    """K4's layouts, a training step's (2048 tokens top-2 over 16 experts,
    capacity 320 at bm 64: sizes off the row block, one expert empty,
    some full), and an ``a2a_segments``-style layout in which each
    expert owns two segments (two source ranks, capacity 40 each, bm 8):
    segments that share a gid are summed by K5."""
    yield from _k4_layouts(torch, kernels)
    train = [256, 0, 320, 301, 257, 63, 320, 190, 255, 320, 1, 320, 288,
             320, 129, 300]
    sizes = torch.tensor(train, dtype=torch.int32, device="cuda")
    yield ("train 2048 tokens cap 320", MOE_E * 320,
           kernels.flat_group_offsets(sizes, 64)[:-1], sizes,
           torch.arange(MOE_E, dtype=torch.int32, device="cuda"), 64)
    recv = [[5, 40, 0, 17, 40, 33, 1, 0, 40, 12, 9, 40, 28, 0, 40, 39],
            [40, 3, 0, 40, 21, 40, 0, 8, 40, 40, 31, 2, 0, 40, 19, 40]]
    ms, cap = 2, 40
    sizes = torch.tensor(recv, dtype=torch.int32, device="cuda").T.reshape(-1)
    gids = torch.arange(MOE_E, dtype=torch.int32,
                        device="cuda").repeat_interleave(ms)
    starts = torch.arange(MOE_E * ms, dtype=torch.int32, device="cuda") * cap
    yield "a2a 2 ranks cap 40", MOE_E * ms * cap, starts, sizes, gids, 8


def check_k4_dx_and_k5(torch, kernels, gen):
    """The backward of ``segment_grouped_gemm`` on the card, at every
    layout of ``_k5_layouts``, up/gate (4096 -> 6400) and down (6400 ->
    4096), f32 and bf16, with NaN in x's rows outside every segment and
    ``DEAD_DY`` in dy's: dX (K4 reading ``w`` transposed) against the
    plain K4 with ``w.transpose(1, 2)``, dW (K5) against
    ``segment_grouped_dw_plain``.  Rows of dX outside every segment and
    dW blocks of groups with no rows must be exactly 0; each bf16 case
    must take both wgmma routes.  Then every route of the main path
    (``_main_routes``) must have been reached, here or in ``check_k4``
    (the route counts start at zero there)."""
    from repro_torch.kernels.grouped_gemm import ROUTE_LAUNCHES

    worst = {"dx": 0.0, "dw": 0.0}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        rel = 0.0 if dtype == torch.float32 else BF16_REL
        for k, n in ((MOE_D, MOE_FF), (MOE_FF, MOE_D)):
            w = ((torch.randn(MOE_E, k, n, device="cuda", generator=gen)
                  / k ** 0.5).to(dtype).requires_grad_())
            for name, m, starts, sizes, gids, bm in _k5_layouts(torch,
                                                                 kernels):
                covered = _covered(torch, m, starts, sizes)
                rows = torch.zeros(MOE_E, dtype=torch.long, device="cuda")
                rows.index_add_(0, gids.long(), sizes.long())
                x = _poison(torch.randn(m, k, device="cuda",
                                        generator=gen).to(dtype),
                            covered, float("nan")).requires_grad_()
                dy = _poison(torch.randn(m, n, device="cuda",
                                         generator=gen).to(dtype),
                             covered, DEAD_DY)
                w.grad = None
                before = dict(ROUTE_LAUNCHES)
                kernels.segment_grouped_gemm(x, w, starts, sizes, gids,
                                             block_rows=bm).backward(dy)
                if dtype == torch.bfloat16:
                    _wgmma_routed(ROUTE_LAUNCHES, before,
                                  ("grouped_gemm_dx", "grouped_dw"))
                with torch.no_grad():
                    dx_ref = kernels.segment_grouped_gemm_plain(
                        dy, w.transpose(1, 2), starts, sizes, gids,
                        block_rows=bm)
                    dw_ref = kernels.segment_grouped_dw_plain(
                        x, dy, starts, sizes, gids, MOE_E)
                what = f"{dtype} {name} bm {bm} {k}x{n}"
                worst["dx"] = max(worst["dx"], _max_err(
                    f"K4 dX {what}", x.grad, dx_ref, rel, _f32_atol(dx_ref)))
                worst["dw"] = max(worst["dw"], _max_err(
                    f"K5 {what}", w.grad, dw_ref, rel, _f32_atol(dw_ref)))
                if (x.grad[~covered] != 0).any():
                    raise AssertionError(f"K4 dX {what}: a row outside "
                                         "every segment is not 0")
                if (w.grad[rows == 0] != 0).any():
                    raise AssertionError(f"K5 {what}: a group with no rows "
                                         "has a nonzero block")
                n_cases += 1
            del w
    missing = _main_routes(torch, kernels) - {r for r, c in
                                              ROUTE_LAUNCHES.items() if c}
    if missing:
        raise AssertionError(f"wgmma routes of the main path not checked: "
                             f"{sorted(missing)}")
    _say(f"k4 dX and k5: {n_cases} backward cases (decode, prefill, "
         f"capacity-stride, 2048-token training and shared-gid a2a "
         f"layouts; 4096x6400 and 6400x4096; f32 and bf16; NaN in x's and "
         f"{DEAD_DY} in dy's rows outside every segment) agree with the "
         f"plain versions (max abs err dX {worst['dx']}, dW {worst['dw']}; "
         f"elementwise tol f32 2e-5*max|ref|, bf16 2^-7*|ref| + "
         f"2e-5*max|ref|; uncovered dX rows and empty-group dW blocks "
         f"exactly 0); wgmma launches by route (counter, bq, nwg, stages): "
         f"{sorted(ROUTE_LAUNCHES.items())}")
    return worst


# K1's backward at the training shapes of phi3.5-moe-42b (2048 tokens):
# (K, N) of the attention projections and the untied LM head.
K1_TRAIN = ((MOE_D, MOE_D), (MOE_D, 1024), (MOE_D, 32768))


def check_k1_backward(torch, kernels, gen) -> float:
    """``sisa_matmul``'s backward on the card at 2048 rows: dA = dC @ Bᵀ
    (K1 reading B transposed) and dB = Aᵀ @ dC (M = d_model, contracting
    over the 2048 tokens), for row-major weights and for the LM head read
    as ``table.T`` (its gradient lands on the (vocab, d) table), f32 and
    bf16, against the plain K1."""
    worst, n_cases = 0.0, 0
    rows = 2048
    for dtype in (torch.float32, torch.bfloat16):
        rel = 0.0 if dtype == torch.float32 else BF16_REL
        for k, n in K1_TRAIN:
            a = torch.randn(rows, k, device="cuda",
                            generator=gen).to(dtype).requires_grad_()
            dc = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
            if n == 32768:          # the LM head: B = table.T, in place
                table = ((torch.randn(n, k, device="cuda", generator=gen)
                          / k ** 0.5).to(dtype).requires_grad_())
                b, leaf, name = table.T, table, "lm_head table.T"
            else:
                b = ((torch.randn(k, n, device="cuda", generator=gen)
                      / k ** 0.5).to(dtype).requires_grad_())
                leaf, name = b, f"{k}x{n}"
            kernels.sisa_matmul(a, b).backward(dc)
            with torch.no_grad():
                da = kernels.sisa_gemm_plain(dc, b.detach().t())
                db = kernels.sisa_gemm_plain(a.detach().t(), dc)
                db = db.t() if leaf is not b else db
            worst = max(worst, _max_err(f"K1 dA {dtype} {name}", a.grad, da,
                                        rel, _f32_atol(da)))
            worst = max(worst, _max_err(f"K1 dB {dtype} {name}", leaf.grad,
                                        db, rel, _f32_atol(db)))
            n_cases += 2
    new = check_k1_train_shapes(torch, kernels, gen)
    _say(f"k1 backward: {n_cases} cases (2048 rows; dA via B transposed, "
         f"dB = A^T dC contracting over the tokens; 4096x4096, 4096x1024 "
         f"and the LM head's table.T; f32 and bf16) agree with the plain "
         f"version (max abs err {worst})")
    return max(worst, new)


# The training shapes (k, n) of recurrentgemma-2b, rwkv6-3b and
# internvl2-76b at full width, bf16, beside their LM heads (vocab rows,
# d: recurrentgemma's tied table, the others' untied) and internvl2's
# frontend_proj with its bias.
K1_TRAIN_MODELS = {
    "recurrentgemma-2b": (RECURRENT_K1[:4], RECURRENT_HEADS[0]),
    "rwkv6-3b": (RECURRENT_K1[:1] + RECURRENT_K1[4:], RECURRENT_HEADS[1]),
    "internvl2-76b": (INTERNVL_K1, INTERNVL_HEAD)}


# whisper-base's training rows: the encoder's 8 x 1,500 frames (and the
# cross K/V projections over them), the decoder's 8 x 448 tokens.
WHISPER_TRAIN_ROWS = {"encoder": 8 * WHISPER_FRAMES,
                      "decoder": 8 * WHISPER_MAX_SEQ}


def check_k1_train_shapes(torch, kernels, gen, rows: int = 2048) -> float:
    """``sisa_matmul`` forward and backward on the card at the training
    shapes of ``K1_TRAIN_MODELS`` (``rows`` tokens, bf16) and of
    whisper-base (its projections at the encoder's and the decoder's
    ``WHISPER_TRAIN_ROWS``, its LM head at the decoder's): C, dA and dB
    against the plain K1, the LM heads read as ``table.T`` (dB lands on
    the (vocab, d) table); and the stub frontends' ``frontend_proj``
    through ``linear_apply`` with its bias (y = x W + b: C, dx, dW and
    db against the plain K1 plus the bias), internvl2's at 208 and
    ``rows`` rows, whisper's (K 80: dx has N = 80, dW M = 80) at one
    request's 1,500 frames and the training run's 12,000.  The LM
    heads' dA contracts over the vocabulary (K up to 256,000): there the
    tensor cores' float32 accumulator, which truncates each k16 step's
    sum, may part from the plain version's by up to K / 16 steps x 2^-24
    of the largest partial sum, so a case's ``atol`` is the larger of
    ``_f32_atol`` and ``K x 2^-28 x max|ref|``; the largest error
    against max|ref| of each K is printed."""
    from repro_torch.models.common import linear_apply

    worst, n_cases, by_k = 0.0, 0, {}

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).bfloat16()

    def held(what, got, ref, k):
        nonlocal worst, n_cases
        top = ref.float().abs().max().item()
        err = _max_err(what, got, ref, BF16_REL,
                       max(_f32_atol(ref), k * 2.0 ** -28 * top))
        worst = max(worst, err)
        by_k[k] = max(by_k.get(k, 0.0), err / max(top, 1e-30))
        n_cases += 1

    def gemm(name, m, k, n, is_head):
        a = rand(m, k).requires_grad_()
        dc = rand(m, n)
        w = rand(*((n, k) if is_head else (k, n)),
                  scale=k ** -0.5).requires_grad_()
        b = w.T if is_head else w
        c = kernels.sisa_matmul(a, b)
        c.backward(dc)
        what = (f"K1 train {name} M={m} "
                f"{'lm_head table.T ' if is_head else ''}")
        with torch.no_grad():
            bd = b.detach()
            held(f"{what}{k}x{n} C", c, kernels.sisa_gemm_plain(a, bd), k)
            held(f"{what}{k}x{n} dA", a.grad,
                 kernels.sisa_gemm_plain(dc, bd.t()), n)
            db = kernels.sisa_gemm_plain(a.detach().t(), dc)
            held(f"{what}{k}x{n} dB", w.grad, db.t() if is_head else db, m)

    def frontend(name, m, k, n):
        nonlocal worst, n_cases
        proj = {"w": rand(k, n, scale=k ** -0.5).requires_grad_(),
                "b": rand(n).requires_grad_()}
        x = rand(m, k).requires_grad_()
        dy = rand(m, n)
        y = linear_apply(proj, x)
        y.backward(dy)
        with torch.no_grad():
            w = proj["w"].detach()
            # y rounds twice (x W, then + b): one ulp of each term.
            xw = kernels.sisa_gemm_plain(x, w)
            ref = xw + proj["b"].detach()
            err = (y.float() - ref.float()).abs()
            tol = BF16_REL * (xw.float().abs() + ref.float().abs()) \
                + _f32_atol(ref)
            if not (err <= tol).all():
                raise AssertionError(f"{name} frontend_proj y M={m}: "
                                     f"{int((err > tol).sum())} elements off")
            worst, n_cases = max(worst, err.max().item()), n_cases + 1
            held(f"{name} frontend_proj dx M={m}", x.grad,
                 kernels.sisa_gemm_plain(dy, w.t()), n)
            held(f"{name} frontend_proj dW M={m}", proj["w"].grad,
                 kernels.sisa_gemm_plain(x.detach().t(), dy), m)
            held(f"{name} frontend_proj db M={m}", proj["b"].grad,
                 dy.float().sum(0).bfloat16(), m)

    for name, (shapes, head) in K1_TRAIN_MODELS.items():
        for k, n in shapes:
            gemm(name, rows, k, n, False)
        gemm(name, rows, head[1], head[0], True)
    for part, m in WHISPER_TRAIN_ROWS.items():
        for k, n in WHISPER_K1:
            gemm(f"whisper-base {part}", m, k, n, False)
    gemm("whisper-base decoder", WHISPER_TRAIN_ROWS["decoder"],
         WHISPER_HEAD[1], WHISPER_HEAD[0], True)
    for m in (FRONTEND_ROWS, rows):
        frontend("internvl2", m, *INTERNVL_FRONTEND)
    for m in (WHISPER_FRAMES, WHISPER_TRAIN_ROWS["encoder"]):
        frontend("whisper", m, *WHISPER_FRONTEND)
    _say(f"k1 training shapes: {n_cases} cases (C, dA and dB at {rows} "
         f"rows, bf16, of recurrentgemma-2b's, rwkv6-3b's and "
         f"internvl2-76b's projections and LM heads' table.T, of "
         f"whisper-base's at {json.dumps(WHISPER_TRAIN_ROWS)} rows and its "
         f"LM head's at the decoder's, and the frontend_proj with its "
         f"bias of internvl2 at {FRONTEND_ROWS} and {rows} rows and of "
         f"whisper (K 80) at {WHISPER_FRAMES} and "
         f"{WHISPER_TRAIN_ROWS['encoder']}) agree with the plain version "
         f"(max abs err {worst}; elementwise tol 2^-7*|ref| + max(2e-5, "
         f"K*2^-28)*max|ref|; the largest error / max|ref| by K: "
         f"{json.dumps(by_k)})")
    return worst


def _requests(Request, rng, vocab, lens):
    prompts = [rng.integers(0, vocab, n).astype("int32") for n in lens]
    prompts[2][:SHARED_PREFIX] = prompts[1][:SHARED_PREFIX]
    return [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]


def _max_seq_counts(lens, new, max_seq):
    """Each request's token count under the ``max_seq`` stop rule: the
    first token, then decode (one step at least) until ``new`` tokens
    or the position reaches ``max_seq - 1``."""
    return [1 + min(new - 1, max(1, max_seq - 1 - s)) for s in lens]


def _serve_offline(eng, kind, reqs, max_seq):
    """``reqs`` served offline; completions in rid order.  The
    sequential engine decodes a batch at its longest row's position and
    stops the whole batch at ``max_seq``, so there the requests that
    leave room for every new token run together and each longer one in
    a run of its own: each request then gets its count of
    :func:`_max_seq_counts`, as on the slot engine."""
    groups = [reqs]
    if kind == "sequential":
        fits = [len(r.prompt) + r.max_new_tokens <= max_seq for r in reqs]
        groups = ([[r for r, f in zip(reqs, fits) if f]]
                  + [[r] for r, f in zip(reqs, fits) if not f])
    done = []
    for group in groups:
        for req in group:
            eng.submit(req)
        done += eng.run()
    return sorted(done, key=lambda c: c.rid)


def _small_configs():
    """qwen2.5-0.5b's widths, phi3.5-moe-42b's layer structure (GQA 32/8
    at head_dim 128, top-2 MoE) at narrow widths with 8 experts, each
    cut to 2 layers, gemma3-1b's layer structure (5 sliding-window
    layers to 1 global, GQA 4/1) at narrow widths with a window of 16
    and 12 layers, and internvl2-76b's (GQA 8 to a KV head, untied
    head, its stub frontend with ``frontend_dim`` 64: the train step's
    batch carries ``frontend_embeds``) at narrow widths with 2 layers; a
    4096-token vocabulary, float32."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoEConfig

    qwen = dataclasses.replace(get_config("qwen2.5-0.5b"), n_layers=2,
                               vocab_size=4096, param_dtype="float32")
    phi = dataclasses.replace(get_config("phi3.5-moe-42b"), n_layers=2,
                              d_model=512, d_ff=1024, vocab_size=4096,
                              moe=MoEConfig(n_experts=8, top_k=2),
                              param_dtype="float32")
    gemma = dataclasses.replace(get_config("gemma3-1b"), n_layers=12,
                                d_model=512, head_dim=128, d_ff=1024,
                                sliding_window=16, vocab_size=4096,
                                param_dtype="float32")
    internvl = dataclasses.replace(get_config("internvl2-76b"), n_layers=2,
                                   d_model=512, n_heads=16, n_kv_heads=2,
                                   head_dim=64, d_ff=1024, frontend_dim=64,
                                   vocab_size=4096, param_dtype="float32")
    return {"qwen2.5-0.5b widths": qwen, "phi3.5-moe structure": phi,
            "gemma3 structure": gemma, "internvl2 structure": internvl}


def _small_recurrent_configs():
    """recurrentgemma-2b's layer structure (RG-LRU, RG-LRU, sliding
    window; GQA 4/1) at narrow widths with a window of 16 and 6 layers,
    and rwkv6-3b's (WKV layers, 8 heads of 64, relu^2 MLP) with 4
    layers; a 4096-token vocabulary, float32.  Each is served and takes
    a train step, as the attention models do."""
    from repro_torch.configs import get_config

    rg = dataclasses.replace(get_config("recurrentgemma-2b"), n_layers=6,
                             d_model=512, n_heads=4, n_kv_heads=1,
                             head_dim=128, d_ff=1024, sliding_window=16,
                             vocab_size=4096, param_dtype="float32")
    rwkv = dataclasses.replace(get_config("rwkv6-3b"), n_layers=4,
                               d_model=512, n_heads=8, n_kv_heads=8,
                               head_dim=64, d_ff=1024, vocab_size=4096,
                               param_dtype="float32")
    return {"recurrentgemma structure": rg, "rwkv6 structure": rwkv}


def _small_enc_dec_config():
    """whisper-base's structure (bidirectional encoder layers, decoder
    layers with cross-attention, biases, GELU MLP, tied head, its
    80-wide frontend) at narrow widths with 2 + 2 layers, 4 heads of 64,
    a 4096-token vocabulary and 37 encoder frames (not a multiple of
    16), float32."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("whisper-base"), n_layers=2,
                               n_enc_layers=2, d_model=256, n_heads=4,
                               n_kv_heads=4, head_dim=64, d_ff=512,
                               vocab_size=4096, enc_frames=37,
                               param_dtype="float32")


def check_small_enc_dec(torch, np, label, cfg) -> None:
    """``cfg`` (an enc-dec model) served on the card (kernels) and on the
    CPU (plain versions) through each engine kind, each request with its
    own seeded ``(enc_frames, frontend_dim)`` features but rid 4, which
    shares rid 3's: the same greedy tokens per kind, each request's token
    count that of the ``max_seq`` stop rule; on paged (pages of 16, so
    the last cross page is ragged) the prompts within its page table,
    one cross block shared, every page of both classes back, and the
    card's tokens equal to the slot engine's there."""
    from repro_torch.models import init_params
    from repro_torch.serve import make_engine, Request

    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = _tree_map(lambda t: t.cuda(), cpu)
    rng = np.random.default_rng(7)
    feats = [rng.standard_normal((cfg.enc_frames, cfg.frontend_dim),
                                 dtype=np.float32) for _ in SMALL_LOCAL_LENS]
    feats[4] = feats[3]
    outs, cross = {}, {}
    for kind in KINDS:
        for params, dev in ((cpu, "cpu"), (gpu, "cuda")):
            eng = make_engine(cfg, params, kind=kind, device=dev,
                              max_slots=4, max_seq=64, page_size=16,
                              window=4)
            reqs = _small_requests(Request, np, cfg, kind, SMALL_LOCAL_LENS)
            for req in reqs:
                req.max_new_tokens, req.enc_embeds = 12, feats[req.rid]
            done = _serve_offline(eng, kind, reqs, 64)
            counts = [c.n_tokens for c in done]
            want = _max_seq_counts([len(r.prompt) for r in reqs], 12, 64)
            if counts != want:
                raise AssertionError(f"{label}, kind={kind} on {dev}: token "
                                     f"counts {counts}, want {want}")
            outs[kind, dev] = [(c.rid, c.tokens) for c in done]
            if kind == "paged":
                c, ext = eng.cache, eng.stats["engine"]
                cross[dev] = (ext["cross_admits"], ext["cross_shared"])
                if ext["cross_shared"] < 1 or c.n_free_cross \
                        != c.num_cross_pages or c.n_free_pages \
                        != c.num_pages or eng._cross_registry:
                    raise AssertionError(f"{label}, paged on {dev}: cross "
                                         f"{cross[dev]}, pages not back")
        if outs[kind, "cpu"] != outs[kind, "cuda"]:
            raise AssertionError(
                f"{label}, kind={kind}: card tokens {outs[kind, 'cuda']} "
                f"differ from the CPU's {outs[kind, 'cpu']}")
    paged_rids = {rid for rid, _ in outs["paged", "cuda"]}
    if cross["cpu"] != cross["cuda"] or [
            o for o in outs["slot", "cuda"] if o[0] in paged_rids] \
            != outs["paged", "cuda"]:
        raise AssertionError(f"{label}: paged cross blocks {cross} or its "
                             "tokens differ from the slot engine's")
    _say(f"small model ({label}, {cfg.n_enc_layers} + {cfg.n_layers} "
         f"layers, {cfg.enc_frames} frames, f32): {len(SMALL_LOCAL_LENS)} "
         f"requests of {list(SMALL_LOCAL_LENS)} prompt tokens, each with "
         f"its features (rid 4 sharing rid 3's), through the slot and "
         f"sequential engines and ({len(paged_rids)} within the page "
         f"table) the paged one, {_max_seq_counts(SMALL_LOCAL_LENS, 12, 64)}"
         f" tokens each, tokens on the card identical to the CPU plain "
         f"path, slot == paged; paged cross blocks (admitted, shared) "
         f"{cross['cuda']} on both, every page back")


# The small models' prompts: each crosses the paged engine's 16-token
# pages; those of the models with other layers than global ones also
# cross their window of 16 and max_seq = 64 (70 and 100 take the
# exact-length prefill into the dense rings and states; the paged engine,
# like the reference's, refuses a prompt past its page table where it
# has one, and is given the others).
SMALL_LENS = (33, 40, 50, 7, 16)
SMALL_LOCAL_LENS = (33, 40, 70, 7, 16, 17, 100)
KINDS = ("paged", "slot", "sequential")


def _small_requests(Request, np, cfg, kind, lens):
    """The small models' requests of ``lens`` (rids by position), those
    past the page table left out for the paged engine."""
    reqs = _requests(Request, np.random.default_rng(1), cfg.vocab_size,
                     lens)
    return [r for r in reqs if kind != "paged" or len(r.prompt) <= 64]


def check_small_model(torch, np, label, cfg) -> None:
    """``cfg`` served on the card (kernels) and on the CPU (plain
    versions) through each engine kind: same weights, same requests,
    same greedy tokens per kind; on the card the slot engine's tokens
    equal the paged engine's for the prompts both serve (rows are
    independent in both).  Then the same requests through
    ``ServeFrontend`` over the paged and slot engines on the card,
    submitted out of order from two threads: the tokens must equal the
    CPU offline ``run()``'s (the coalesced prefill is bitwise the single
    one in float32)."""
    from repro_torch.configs.base import ATTN
    from repro_torch.models import init_params
    from repro_torch.serve import make_engine, Request, ServeFrontend

    global_only = set(cfg.layer_kinds()) == {ATTN}
    lens = SMALL_LENS if global_only else SMALL_LOCAL_LENS
    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = _tree_map(lambda t: t.cuda(), cpu)
    outs = {}
    for kind in KINDS:
        for params, dev in ((cpu, "cpu"), (gpu, "cuda")):
            eng = make_engine(cfg, params, kind=kind, device=dev,
                              max_slots=4, max_seq=64, page_size=16,
                              window=4)
            reqs = _small_requests(Request, np, cfg, kind, lens)
            for req in reqs:
                req.max_new_tokens = 12
            done = _serve_offline(eng, kind, reqs, 64)
            counts = [c.n_tokens for c in done]
            want = _max_seq_counts([len(r.prompt) for r in reqs], 12, 64)
            if counts != want:
                raise AssertionError(
                    f"small model, kind={kind} on {dev}: token counts "
                    f"{counts}, want {want}")
            outs[kind, dev] = [(c.rid, c.tokens) for c in done]
        if outs[kind, "cpu"] != outs[kind, "cuda"]:
            raise AssertionError(
                f"small model, kind={kind}: card tokens {outs[kind, 'cuda']}"
                f" differ from the CPU's {outs[kind, 'cpu']}")
    paged_rids = {rid for rid, _ in outs["paged", "cuda"]}
    if [o for o in outs["slot", "cuda"] if o[0] in paged_rids] \
            != outs["paged", "cuda"]:
        raise AssertionError("small model: slot tokens on the card differ "
                             "from the paged engine's")
    for kind in KINDS[:-1]:
        eng = make_engine(cfg, gpu, kind=kind, device="cuda", max_slots=4,
                          max_seq=64, page_size=16, window=4)
        reqs = {r.rid: r for r in _small_requests(Request, np, cfg, kind,
                                                  lens)}
        fe = ServeFrontend(eng)
        handles = {}
        start = threading.Barrier(2, timeout=60)

        def submitter(rids):
            start.wait()
            for rid in rids:
                handles[rid] = fe.submit(reqs[rid].prompt, 12, rid=rid)

        rids = sorted(reqs)[::-1]
        threads = [threading.Thread(target=submitter, args=(rids[i::2],))
                   for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        online = sorted((c.rid, c.tokens) for c in _drain(fe, 300))
        _shutdown(fe)
        if online != outs[kind, "cpu"]:
            raise AssertionError(
                f"small model, ServeFrontend over kind={kind}: card tokens "
                f"{online} differ from the CPU offline run's "
                f"{outs[kind, 'cpu']}")
    _say(f"small model ({label}, {cfg.n_layers} layers, f32): "
         f"{len(lens)} requests of {list(lens)} prompt tokens through the "
         f"slot and sequential engines (the sequential one's past max_seq "
         f"- 12 each alone), {len(paged_rids)} of them (those within the "
         f"page table) through the paged one, "
         f"{_max_seq_counts(lens, 12, 64)} tokens each, tokens on the "
         f"card identical to the CPU plain path, slot == paged; through "
         f"ServeFrontend over paged and slot (submitted out of order from "
         "two threads) identical to the CPU offline run")


def check_small_train(torch, np, label, cfg) -> None:
    """One train step of ``cfg`` (float32) on the card (kernels) and on
    the CPU (plain versions), from the same weights and batch: the
    loss, every gradient, AdamW's moments and the parameters after the
    update.  The step is ``loss_and_grads`` then ``apply_updates``, what
    ``make_train_step`` runs with ``accum_steps=1``, split so the
    gradients can be read.  lr 1e-3 with one warmup step makes the
    update about 1e-3 per element, far above the tolerances.  An
    enc-dec model's cross-attention key biases have an exact gradient
    of 0 (with no RoPE, a key bias adds one constant to a query's
    logits, which the softmax removes): both sides hold rounding noise
    there, each within 1e-6 of the largest gradient, and their moments
    and steps (Adam's step of noise, up to lr either way) are held by
    the parameters' rule for gradients that are not firm."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import loss_and_grads

    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = _tree_map(lambda t: t.cuda(), cpu)
    batch = SyntheticLM(cfg, 4, 64, DataConfig(seed=1)).batch(0)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    res = {}
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    for params, dev in ((cpu, "cpu"), (gpu, "cuda")):
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss, _, grads = loss_and_grads(params, cfg, b, remat="none")
        grads = _tree_map(lambda g: g.detach().clone(), grads)
        before = [p.detach().clone() for p in _leaves(params)]
        params, state, _ = adamw.apply_updates(params, grads,
                                               adamw.init_state(params), opt)
        res[dev] = (float(loss), list(_leaves(grads)), before,
                    list(_leaves(params)), list(_leaves(state.mu)),
                    list(_leaves(state.nu)),
                    float(adamw.global_norm(grads)))
    launches = {k: c.n for k, c in LAUNCH_COUNTERS.items() if c.n}
    l_cpu, g_cpu, p0, p_cpu, mu_cpu, nu_cpu, norm = res["cpu"]
    l_gpu, g_gpu, _, p_gpu, mu_gpu, nu_gpu, norm_gpu = res["cuda"]
    if not abs(l_gpu - l_cpu) <= 1e-5 * max(1.0, abs(l_cpu)):
        raise AssertionError(f"small train ({label}): loss {l_gpu} on the "
                             f"card, {l_cpu} on the CPU")
    lr1 = float(adamw.cosine_lr(opt, 1))
    clip = min(1.0, opt.grad_clip_norm / (norm + 1e-9))
    # The moments carry the clip factor 1/||g||, a sum of squares over
    # every element taken in another order on each side: their tolerance
    # adds the measured relative difference of the two factors.
    if not abs(norm_gpu - norm) <= 1e-3 * norm:
        raise AssertionError(f"small train ({label}): gradient norm "
                             f"{norm_gpu} on the card, {norm} on the CPU")
    dclip = abs(min(1.0, opt.grad_clip_norm / (norm_gpu + 1e-9)) - clip) \
        / clip
    err = {"grad": 0.0, "mu": 0.0, "nu": 0.0, "param": 0.0}
    firm = total = 0
    zero = {id(layer["cross"]["k"]["b"]) for layer in cpu["layers"]
            if "cross" in layer and "b" in layer["cross"]["k"]}
    zero = [i for i, t in enumerate(_leaves(cpu)) if id(t) in zero]
    top = max(g.abs().max().item() for g in g_cpu)
    for i, (gg, gc) in enumerate(zip(g_gpu, g_cpu)):
        gg = gg.cpu()
        if i in zero:
            noise = max(gg.abs().max().item(), gc.abs().max().item())
            if noise > 1e-6 * top:
                raise AssertionError(f"small train ({label}) leaf {i}: a "
                                     f"key bias's gradient {noise} of "
                                     f"{top}")
        else:
            # f32 sums in other orders: 1e-4 of the leaf's largest value.
            scale = max(gc.abs().max().item(), 1e-30)
            err["grad"] = max(err["grad"], _max_err(
                f"small train ({label}) grad", gg, gc, 0.0,
                1e-4 * scale) / scale)
            for key, got, want, rel in (
                    ("mu", mu_gpu, mu_cpu, 1e-4 + 2 * dclip),
                    ("nu", nu_gpu, nu_cpu, 2e-4 + 4 * dclip)):
                sc = max(want[i].abs().max().item(), 1e-30)
                err[key] = max(err[key], _max_err(
                    f"small train ({label}) {key}", got[i].cpu(), want[i],
                    0.0, rel * sc) / sc)
        # Adam's first step moves an element by lr * g / (|g| + eps)
        # (plus weight decay): about lr * sign(g).  Where the clipped
        # gradient is at least 1000 eps and four times the leaf's
        # card-vs-CPU difference, both sides take the same step within
        # lr / 1000; elsewhere (rounding-noise gradients) the sign may
        # differ, and the step may be any value up to lr either way.
        dev = (gg - gc).abs().max().item()
        sure = ((gc.abs() >= 4 * dev)
                & (gc.abs() * clip >= 1000 * opt.eps))
        diff = (p_gpu[i].cpu() - p_cpu[i]).abs()
        tol = torch.where(sure, torch.full_like(diff, lr1 / 100 + 1e-6),
                          torch.full_like(diff, 2 * lr1 + 1e-6))
        moved = (p_cpu[i] - p0[i]).abs()
        if (diff > tol).any() or (moved[sure] < lr1 / 2).any():
            raise AssertionError(
                f"small train ({label}) params, leaf {i}: max abs err "
                f"{diff.max().item()} (tol lr/100 + 1e-6 where the gradient "
                f"is firm, 2 lr + 1e-6 elsewhere); smallest firm CPU step "
                f"{moved[sure].min().item() if sure.any() else None}")
        err["param"] = max(err["param"], diff[sure].max().item()
                           if sure.any() else 0.0)
        firm += int(sure.sum())
        total += sure.numel()
    _say(f"small train step ({label}, f32, 4x64 tokens, lr {lr1}): loss "
         f"card {l_gpu} CPU {l_cpu}; {len(g_cpu)} leaves agree: gradients "
         f"(max err {err['grad']} of each leaf's max; tol 1e-4), global "
         f"norm card {norm_gpu} CPU {norm} (clip factors differ by "
         f"{dclip}), AdamW mu ({err['mu']}; tol 1e-4 + 2x that) and nu "
         f"({err['nu']}; tol 2e-4 + 4x that), params "
         f"after the step at the {firm} of {total} elements with a firm "
         f"gradient (max abs err {err['param']}; tol lr/100 + 1e-6 = "
         f"{lr1 / 100 + 1e-6}; each moved by >= lr/2 on the CPU), the rest "
         f"(and the {len(zero)} cross-attention key biases' noise "
         f"gradients, within 1e-6 of the largest) "
         f"within 2 lr + 1e-6; card launches {json.dumps(launches)}")


def serve_full_width(torch, np, cfg, need, params=None, lens=PROMPT_LENS,
                     kind="paged", absent=(), before_serve=None,
                     warm_rungs=None, prepare=None, **engine_kw):
    """Serve the workload of ``lens`` prompts (8 by default) through
    ``make_engine(kind=kind, **engine_kw)`` at ``cfg``'s widths with
    seeded random bf16 weights (``params``, or made here).  Every launch
    counter is zeroed just before the serve; those of ``need`` must be
    > 0 just after and those of ``absent`` 0, every request must be
    prefilled once, and the storage must drain.  ``warm_rungs`` limits
    the warmup to those rungs (the workload runs at rung 8);
    ``before_serve(eng)``, if given, runs after the warmup;
    ``prepare(reqs)``, if given, amends the requests before they are
    submitted (an enc-dec model's features).  Returns the engine, the
    weights, the launch counts and the completions."""
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.kernels.grouped_gemm import ROUTE_LAUNCHES
    from repro_torch.models import init_params
    from repro_torch.models.common import padded_vocab
    from repro_torch.serve import make_engine, Request, validate_stats
    from repro_torch.serve.engine import prefill_batch_of

    if params is None:
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0)
        torch.cuda.synchronize()
        _say(f"params: {cfg.name} full width, {cfg.n_layers} layers, "
             f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} G "
             f"weights ({torch.cuda.memory_allocated() / 1e9:.2f} GB "
             f"allocated), init {time.perf_counter() - t0:.2f} s")
    eng = make_engine(cfg, params, kind=kind, max_slots=8, max_seq=256,
                      page_size=16, window=8, **engine_kw)
    if kind != "sequential":            # it has no warmup, as in the JAX one
        eng.warmup(rungs=warm_rungs)
    if before_serve is not None:
        before_serve(eng)
    prefill, prefills = eng.prefill_fn, []

    def counted_prefill(p, batch):
        prefills.append(1)
        return prefill(p, batch)

    eng.prefill_fn = counted_prefill
    reqs = _requests(Request, np.random.default_rng(0), cfg.vocab_size,
                     lens)
    if prepare is not None:
        prepare(reqs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    ROUTE_LAUNCHES.clear()
    t0 = time.perf_counter()
    for req in reqs:
        eng.submit(req)
    outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.n for name, c in LAUNCH_COUNTERS.items()}
    routes = _only_wgmma_routes(launches)
    n_prefills = len(prefills)
    peak = torch.cuda.max_memory_allocated()
    validate_stats(eng.stats)
    if n_prefills != len(lens):
        raise AssertionError(f"{n_prefills} prefills for {len(lens)} "
                             "requests")
    if len(outs) != len(lens) or any(
            c.n_tokens != NEW_TOKENS or c.finish_reason != "length"
            for c in outs):
        raise AssertionError("incomplete serve: " + str(
            [(c.rid, c.n_tokens, c.finish_reason) for c in outs]))
    if not all(0 <= t < cfg.vocab_size for c in outs for t in c.tokens):
        raise AssertionError("token outside the vocabulary")
    if any(launches[name] <= 0 for name in need):
        raise AssertionError(f"main path skipped a kernel: {launches}")
    if any(launches[name] for name in absent):
        raise AssertionError(f"{kind} serve launched one of {absent}: "
                             f"{launches}")
    if kind != "sequential" and eng.stats["decode_compiles"] != 0:
        raise AssertionError(f"decode_compiles "
                             f"{eng.stats['decode_compiles']} after warmup")
    ext = eng.stats["engine"]
    if kind == "paged" and eng.prefix_sharing \
            and ext["pages_shared"] < SHARED_PREFIX // 16:
        raise AssertionError(f"prefix not shared: {ext['pages_shared']}")
    if kind == "paged" and eng.cache.n_free_pages != eng.cache.num_pages:
        raise AssertionError("page pool did not drain")
    if kind != "sequential" and eng.cache.n_free != eng.max_batch:
        raise AssertionError(f"{eng.max_batch - eng.cache.n_free} slots "
                             "did not drain")
    # Finite f32 logits of the expected shape from the same weights.
    batch = prefill_batch_of(reqs[0].prompt[None], reqs[:1], cfg, "cuda")
    batch["last_index"] = len(reqs[0].prompt) - 1
    logits, _ = eng.prefill_fn(eng.params, batch)
    if logits.shape != (1, 1, padded_vocab(cfg.vocab_size)) \
            or logits.dtype != torch.float32 \
            or not torch.isfinite(logits[..., :cfg.vocab_size]).all():
        raise AssertionError(f"bad logits {logits.shape} {logits.dtype}")
    n_tok = sum(c.n_tokens for c in outs)
    summary = {"model": cfg.name, "kind": kind, "layers": cfg.n_layers,
               "requests": len(outs), "tokens": n_tok, "wall_s": wall,
               "tok_per_s": n_tok / wall,
               "ttft_p50_ms": statistics.median(eng.stats["ttft"]) * 1e3,
               "peak_memory_gb": peak / 1e9,
               "decode_compiles": eng.stats["decode_compiles"],
               "decode_steps": eng.stats["decode_steps"],
               "batches": eng.stats["batches"], "rungs": ext.get("rungs"),
               "pages_shared": ext.get("pages_shared"),
               "expert_backend": eng.stats["expert_backend"],
               "kv_pool": ext.get("kv_pool"),
               "coexec_backend": eng.stats["coexec_backend"],
               "backfilled": eng.stats["backfilled"],
               "coexec_steps": len(eng.stats["coexec_tiles"]),
               "prefills": n_prefills, "launches": launches,
               "wgmma_routes": routes}
    _say(f"serve: {json.dumps(summary)}")
    return eng, params, launches, sorted(outs, key=lambda c: c.rid)


def serve_dense(torch, np, cfg, params, paged_outs):
    """Phase 7's dense serves: the 8 requests through ``kind="slot"`` and
    ``kind="sequential"`` on the paged serve's weights (K1 > 0, K2 0,
    slots drained), each one's completions compared with the paged
    serve's (printed); then one ``prefill_batch`` on the slot engine and
    one profiled slot window."""
    for kind in ("sequential", "slot"):        # the slot engine stays
        eng, _, _, outs = serve_full_width(
            torch, np, cfg, ("sisa_gemm",), params=params, kind=kind,
            absent=("paged_attn", "paged_attn_int8"))
        same = sum(a.tokens == b.tokens for a, b in zip(outs, paged_outs))
        _say(f"{kind} serve: {same} of {len(outs)} completions equal the "
             "paged serve's")
    check_prefill_batch(torch, np, eng, cfg)
    profile_window(torch, np, eng, cfg)


def check_prefill_batch(torch, np, eng, cfg) -> None:
    """One ``prefill_batch`` of the 8 prompts on the slot engine (runs of
    one bucket coalesce at a ladder rung): every parked cache and first
    token against the request's single prefill at ``COALESCED_REL``;
    then the parked requests are served and the slots drain."""
    from repro_torch.serve import Request

    eng.reset()
    reqs = _requests(Request, np.random.default_rng(0), cfg.vocab_size,
                     PROMPT_LENS)
    eng.prefill_batch(reqs)
    torch.cuda.synchronize()
    ext = eng.stats["engine"]
    if ext["prefill_batches"] < 1 or len(eng._backfilled) != len(reqs):
        raise AssertionError(f"prefill_batch: {ext['prefill_batches']} "
                             f"batches, {len(eng._backfilled)} parked")
    parked = {r.rid: c for r, c, _ in eng._backfilled}
    worst, same = 0.0, 0
    for req in reqs:
        s = len(req.prompt)
        toks = np.zeros(eng._bucket_len(s), np.int32)
        toks[:s] = req.prompt
        logits, cache = eng.prefill_fn(eng.params, {
            "tokens": torch.as_tensor(toks[None], device="cuda"),
            "last_index": s - 1})
        top = torch.topk(logits[0, -1, :cfg.vocab_size], 2).values
        single = int(torch.argmax(logits[0, -1, :cfg.vocab_size]))
        same += req.generated[0] == single
        if req.generated[0] != single and \
                (top[0] - top[1]).item() > COALESCED_REL * top[0].abs().item():
            raise AssertionError(f"prefill_batch rid {req.rid}: first token "
                                 f"{req.generated[0]}, single prefill's "
                                 f"{single} by margin {top.tolist()}")
        for name, t in cache.items():
            ref = t.float().abs().max().item()
            err = (parked[req.rid][name].float() - t.float()).abs().max()
            worst = max(worst, err.item() / ref)
            if err > COALESCED_REL * ref:
                raise AssertionError(f"prefill_batch rid {req.rid} {name}: "
                                     f"max abs err {err.item()} of {ref}")
    outs = eng.run()
    if len(outs) != len(reqs) or eng.cache.n_free != eng.max_batch:
        raise AssertionError("parked requests did not serve and drain")
    _say(f"prefill_batch (slot engine, bf16): {ext['prefill_batches']} "
         f"coalesced prefills of {ext['prefill_batched_reqs']} of "
         f"{len(reqs)} prompts; parked caches within {worst} of their "
         f"largest magnitude of the single prefills' (tol {COALESCED_REL}); "
         f"{same} of {len(reqs)} first tokens equal")


# gemma3-1b at full width: 8 requests whose prompts sit below, at and
# above its 512-token window and up to past max_seq (1100 takes the
# exact-length prefill into every ring).  The dense cache at 8 slots and
# max_seq 1024, bf16: 2 (K, V) x 8 slots x 1 KV head x 256 x 2 bytes x
# (4 global layers x 1024 + 22 local layers x 512) cells.
GEMMA_LENS = (16, 300, 511, 512, 513, 700, 1000, 1100)
GEMMA_MAX_SEQ = 1024
GEMMA_CACHE_BYTES = 125_829_120
# The paged engine's pools at 8 slots, max_seq 1024, pages of 16 and
# window 8, bf16: rings of R = ceil((512 + 8) / 16) + 1 = 34 pages, so 2
# (K, V) x 22 local layers x (8 x 34 + 1 sink) pages plus 2 x 4 global
# layers x (8 x 64 + 1) pages, each 16 x 256 x 2 bytes, and the tables
# (8 x 64 + 8 x 34 int32).  The paged engine serves the prompts within
# its page table (1100 is refused, as the reference refuses it).
GEMMA_POOL_BYTES = 132_025_408
GEMMA_PAGED_LENS = tuple(n for n in GEMMA_LENS if n <= GEMMA_MAX_SEQ)


def _k1_wgmma_only(launches) -> None:
    """Raises unless every K1 launch of a run took the wgmma body (none
    fell to the CUDA-core body)."""
    if launches["sisa_gemm_core"]:
        raise AssertionError(f"{launches['sisa_gemm_core']} of "
                             f"{launches['sisa_gemm']} K1 launches took the "
                             "CUDA-core body")


def serve_gemma3(torch, np, kernels) -> None:
    """``gemma3-1b`` at full width and depth in bf16 (seeded random
    weights): the 8 requests of ``GEMMA_LENS``, 32 new tokens each,
    through ``make_engine(kind="slot", max_slots=8, max_seq=1024,
    window=8)`` after ``warmup()``, then through ``kind="sequential"``
    (``_serve_offline``: the 1000- and 1100-token prompts each in a run
    of its own), then the 7 of ``GEMMA_PAGED_LENS`` through
    ``kind="paged"`` on bf16 pools after ``warmup()``.  Every launch
    counter is zeroed just before each serve; K1's must be > 0 just
    after, every K1 launch on the wgmma route, and K2's 0 on the dense
    engines, 4 a decode step (the global layers) on the paged one, whose
    int8 variant stays 0.  Each request's token count is that of the
    ``max_seq`` stop rule on every engine.  Slot and paged:
    ``decode_compiles`` 0, every slot drained.  The slot serve's dense
    cache is exactly ``GEMMA_CACHE_BYTES``; the paged serve's pools
    ``GEMMA_POOL_BYTES``, every page and ring back in its pool, and some
    ring pages reclaimed.  Finite logits of the expected shape from the
    1100-token prompt.  Printed: the completions the engines share, one
    profiled slot window and one paged, K1's time for one decode step
    (rung 8) and one 512-row prefill at gemma3's shapes, and K2's for
    one decode step at the paged serve's last positions (returned)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.kernels.sisa_gemm import k1_plan
    from repro_torch.models import init_params
    from repro_torch.models.attention import cache_capacity
    from repro_torch.models.common import padded_vocab
    from repro_torch.serve import make_engine, Request, validate_stats

    cfg = get_config("gemma3-1b")
    kinds = cfg.layer_kinds()
    cells = sum(cache_capacity(kind, GEMMA_MAX_SEQ, cfg.sliding_window)
                for kind in kinds)
    cell = cfg.n_kv_heads * cfg.resolved_head_dim * 2
    if 2 * 8 * cell * cells != GEMMA_CACHE_BYTES:
        raise AssertionError(f"gemma3 cache cells {cells}")
    ring = -(-(cfg.sliding_window + 8) // 16) + 1
    pmax = GEMMA_MAX_SEQ // 16
    if 2 * 16 * cell * (kinds.count("local") * (8 * ring + 1)
                        + kinds.count("attn") * (8 * pmax + 1)) \
            + 4 * 8 * (pmax + ring) != GEMMA_POOL_BYTES:
        raise AssertionError(f"gemma3 pool bytes at rings of {ring}")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    _say(f"params: {cfg.name} full width, {cfg.n_layers} layers "
         f"({cfg.layer_kinds().count('local')} sliding-window, window "
         f"{cfg.sliding_window}), "
         f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} G weights "
         f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated), init "
         f"{time.perf_counter() - t0:.2f} s")
    hd, d, ff = cfg.resolved_head_dim, cfg.d_model, cfg.d_ff
    shapes = {"q": (d, cfg.n_heads * hd), "k, v": (d, cfg.n_kv_heads * hd),
              "o": (cfg.n_heads * hd, d), "gate, up": (d, ff),
              "down": (ff, d), "lm head (table.T)": (d, padded_vocab(
                  cfg.vocab_size))}
    _say("gemma3 K1 plans (k, n) at the decode rung 8 and a 512-row "
         "prefill: " + json.dumps({
             name: [dataclasses.asdict(k1_plan(m, n, k)) for m in (8, 512)]
             for name, (k, n) in shapes.items()}))
    outs, engs = {}, {}
    for kind in ("slot", "sequential", "paged"):
        lens = GEMMA_PAGED_LENS if kind == "paged" else GEMMA_LENS
        eng = make_engine(cfg, params, kind=kind, max_slots=8,
                          max_seq=GEMMA_MAX_SEQ, window=8)
        if kind != "sequential":
            eng.warmup()
        reqs = [r for r in _requests(Request, np.random.default_rng(0),
                                     cfg.vocab_size, GEMMA_LENS)
                if len(r.prompt) in lens]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for counter in LAUNCH_COUNTERS.values():
            counter.reset()
        t0 = time.perf_counter()
        done = _serve_offline(eng, kind, reqs, GEMMA_MAX_SEQ)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: c.n for name, c in LAUNCH_COUNTERS.items()}
        _k1_wgmma_only(launches)
        validate_stats(eng.stats)
        k2 = (4 * eng.stats["decode_steps"] if kind == "paged" else 0)
        if launches["sisa_gemm"] <= 0 or launches["paged_attn"] != k2 \
                or launches["paged_attn_int8"]:
            raise AssertionError(f"gemma3 {kind} serve: {launches}, K2 "
                                 f"launches want {k2}")
        if len(done) != len(lens) or not all(
                0 <= t < cfg.vocab_size for c in done for t in c.tokens):
            raise AssertionError(f"gemma3 {kind} serve: {done}")
        counts = [c.n_tokens for c in done]
        want = _max_seq_counts(lens, NEW_TOKENS, GEMMA_MAX_SEQ)
        if counts != want:
            raise AssertionError(f"gemma3 {kind} token counts {counts}, "
                                 f"want {want}")
        ext = eng.stats["engine"]
        if kind != "sequential":
            if eng.stats["decode_compiles"] != 0:
                raise AssertionError(f"gemma3 {kind} decode_compiles "
                                     f"{eng.stats['decode_compiles']}")
            if eng.cache.n_free != eng.max_batch or ext["slot_admits"] \
                    != ext["slot_releases"]:
                raise AssertionError(f"gemma3 {kind} slots did not drain")
            nbytes = eng.cache.resident_bytes()
            want_bytes = (GEMMA_POOL_BYTES if kind == "paged"
                          else GEMMA_CACHE_BYTES)
            if nbytes != want_bytes:
                raise AssertionError(f"gemma3 {kind} storage {nbytes} "
                                     f"bytes, want {want_bytes}")
        if kind == "paged" and (
                eng.cache.n_free_local != eng.num_local_pages
                or eng.cache.n_free_pages != eng.num_pages
                or ext["window_pages_reclaimed"] <= 0
                or ext["local_ring_pages"] != ring):
            raise AssertionError(
                f"gemma3 paged: {eng.cache.n_free_local} of "
                f"{eng.num_local_pages} ring pages and "
                f"{eng.cache.n_free_pages} of {eng.num_pages} pages free, "
                f"{ext['window_pages_reclaimed']} reclaimed, rings of "
                f"{ext['local_ring_pages']}")
        outs[kind], engs[kind] = done, eng
        k2_launches = launches["paged_attn"]
        n_tok = sum(counts)
        summary = {
            "model": cfg.name, "kind": kind, "layers": cfg.n_layers,
            "max_seq": GEMMA_MAX_SEQ, "prompts": list(lens),
            "tokens": counts, "finish": [c.finish_reason for c in done],
            "wall_s": wall, "tok_per_s": n_tok / wall,
            "ttft_p50_ms": statistics.median(eng.stats["ttft"]) * 1e3,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "decode_compiles": eng.stats["decode_compiles"],
            "decode_steps": eng.stats["decode_steps"],
            "batches": eng.stats["batches"],
            "cache_bytes": (eng.cache.resident_bytes()
                            if kind != "sequential" else None),
            "launches": launches}
        if kind == "paged":
            summary.update({key: ext[key] for key in (
                "local_ring_pages", "window_pages_reclaimed", "page_admits",
                "page_grows", "pages_mapped_peak", "pages_shared")})
        _say(f"gemma3 serve: {json.dumps(summary)}")
    # Finite f32 logits of the expected shape, from the prompt past
    # max_seq (exact length: every ring laid by the per-row gather).
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    prompt = _requests(Request, np.random.default_rng(0), cfg.vocab_size,
                       GEMMA_LENS)[-1].prompt
    slot_eng = engs["slot"]
    logits, cache = slot_eng.prefill_fn(params, {
        "tokens": torch.as_tensor(prompt[None], device=slot_eng.device),
        "last_index": len(prompt) - 1})
    _k1_wgmma_only({name: c.n for name, c in LAUNCH_COUNTERS.items()})
    if logits.shape != (1, 1, padded_vocab(cfg.vocab_size)) \
            or not torch.isfinite(logits[..., :cfg.vocab_size]).all():
        raise AssertionError(f"gemma3 bad logits {logits.shape}")
    if sum(t.numel() * t.element_size() for t in cache.values()) \
            != GEMMA_CACHE_BYTES // 8:
        raise AssertionError("gemma3 prefill cache bytes")
    same = sum(a.tokens == b.tokens
               for a, b in zip(outs["slot"], outs["sequential"]))
    first = sum(a.tokens[:2] == b.tokens[:2]
                for a, b in zip(outs["slot"], outs["sequential"]))
    _say(f"gemma3: {same} of {len(GEMMA_LENS)} completions of the slot and "
         f"sequential serves equal, {first} equal in their first two "
         "tokens (the sequential engine decodes a batch at its longest "
         "row's position; its prefill is exact-length, the slot engine's "
         "bucketed)")
    paged = sum(a.tokens == b.tokens for a, b in zip(outs["slot"],
                                                      outs["paged"]))
    _say(f"gemma3: {paged} of {len(GEMMA_PAGED_LENS)} completions of the "
         "paged serve equal the slot serve's (bf16: K2 and the dense "
         "attention sum in other orders)")
    profile_window(torch, np, slot_eng, cfg)
    profile_window(torch, np, engs["paged"], cfg)
    del engs
    for rows, what in ((8, "decode step (rung 8"), (512, "prefill (512 rows, "
                                                     "LM head on 1 row")):
        t = time_k1(torch, kernels, params, cfg, rows=rows)
        _say(f"k1 gemma3-1b {what}, {t['gemms']} GEMMs): {json.dumps(t)}")
    k2 = time_k2(torch, kernels, K2_HEADS[2], kinds.count("attn"), pos=[
        min(n + NEW_TOKENS - 1, GEMMA_MAX_SEQ - 1) for n in GEMMA_PAGED_LENS],
        pmax=pmax)
    _say(f"k2 gemma3-1b layout decode step ({len(GEMMA_PAGED_LENS)} rows, "
         f"GQA 4/1 hd 256, {k2['launches_timed']} layers, pmax {pmax}): "
         f"{json.dumps(k2)}")
    return {**k2, "serve_launches": k2_launches}


# recurrentgemma-2b and rwkv6-3b at full width: 8 requests whose prompts
# cross recurrentgemma's 2048-token window (2049-3000: its ring prefill
# and decode wrap), 32 new tokens each, on 8 slots at max_seq 3072 with
# pages of 16 and windows of 8.  Their storage in bf16, in bytes: the
# dense slot cache (recurrentgemma: 8 local layers' rings of 2048 cells,
# 1 KV head of 256, K and V; 18 RG-LRU layers' f32 h and bf16 3-tap
# conv; rwkv6: 32 WKV layers' f32 40 x 64 x 64 state and bf16 shift)
# and the paged engine's (rings of R = ceil((2048 + 8) / 16) + 1 = 130
# pages a slot plus a sink, the same state slabs, the page table of
# 3072 / 16 columns and the ring table).  _recurrent_bytes computes each
# from the config.
RECURRENT_LENS = (16, 512, 1500, 2047, 2048, 2049, 2600, 3000)
RECURRENT_MAX_SEQ = 3072
# Phase 12's depths (half of each model's; at full depth, 26 and 32
# layers, the storage was 137,904,128 / 140,142,656 and 169,082,880 /
# 169,089,024 bytes) and their storage at 8 slots, max_seq 3072.
RECURRENT_LAYERS = {"recurrentgemma-2b": 13, "rwkv6-3b": 16}
RECURRENT_BYTES = {"recurrentgemma-2b": {"slot": 68_952_064,
                                         "paged": 70_076_480},
                   "rwkv6-3b": {"slot": 84_541_440,
                                "paged": 84_547_584}}


def _recurrent_bytes(cfg, kind: str, slots=8, max_seq=RECURRENT_MAX_SEQ,
                     page=16, window=8) -> dict:
    """The slot or paged storage of ``cfg`` in bf16, by part, from the
    layer counts and widths."""
    kinds = cfg.layer_kinds()
    d, hd = cfg.d_model, cfg.resolved_head_dim
    cell = cfg.n_kv_heads * hd * 2                 # one position, K or V
    w = min(cfg.sliding_window, max_seq)
    parts = {"h": kinds.count("rglru") * slots * d * 4,
             "conv": kinds.count("rglru") * slots * 3 * d * 2,
             "state": kinds.count("wkv") * slots * (d // hd) * hd * hd * 4,
             "shift": kinds.count("wkv") * slots * d * 2}
    n_local = kinds.count("local")
    if kind == "slot":
        parts["rings"] = 2 * n_local * slots * w * cell
    else:
        ring = -(-(w + window) // page) + 1 if n_local else 0
        parts["rings"] = 2 * n_local * (slots * ring + 1) * page * cell
        parts["tables"] = 4 * slots * (max_seq // page + ring)
    parts["total"] = sum(parts.values())
    return parts


def serve_recurrent(torch, np, kernels, name: str) -> dict:
    """``name`` (recurrentgemma-2b or rwkv6-3b) at full width and
    ``RECURRENT_LAYERS`` depth in bf16 with seeded random weights: the 8
    requests of
    ``RECURRENT_LENS``, 32 new tokens each, through ``make_engine(kind=
    "slot", max_slots=8, max_seq=3072, window=8)`` after ``warmup()``,
    ``kind="sequential"`` and ``kind="paged"`` (pages of 16) after
    ``warmup()``.  Every launch counter is zeroed just before each serve;
    after it K1's must be > 0 with every launch on the wgmma route, K2's
    and its int8 variant's 0 (neither model has a global layer); each
    request's token count is that of the ``max_seq`` stop rule; slot and
    paged: ``decode_compiles`` 0, every slot drained, the storage exactly
    ``RECURRENT_BYTES`` (and ``_recurrent_bytes``), every ring page
    back.  Finite logits of the expected shape from the 3000-token
    prompt.  Printed: the completions slot and paged share, one profiled
    slot window and one paged, and K1's times for one decode step (rung
    8) and one 2048-row prefill (returned)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.models import init_params
    from repro_torch.models.common import padded_vocab
    from repro_torch.serve import make_engine, Request, validate_stats

    cfg = dataclasses.replace(get_config(name),
                              n_layers=RECURRENT_LAYERS[name])
    want_bytes = {kind: _recurrent_bytes(cfg, kind)
                  for kind in ("slot", "paged")}
    for kind, parts in want_bytes.items():
        if parts["total"] != RECURRENT_BYTES[name][kind]:
            raise AssertionError(f"{name} {kind} bytes {parts}, want "
                                 f"{RECURRENT_BYTES[name][kind]}")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    kinds = cfg.layer_kinds()
    _say(f"params: {name} full width, {cfg.n_layers} layers "
         f"({ {k: kinds.count(k) for k in sorted(set(kinds))} }), "
         f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} G weights "
         f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated), init "
         f"{time.perf_counter() - t0:.2f} s")
    outs, engs, summaries = {}, {}, {}
    for kind in ("slot", "sequential", "paged"):
        eng = make_engine(cfg, params, kind=kind, max_slots=8,
                          max_seq=RECURRENT_MAX_SEQ, page_size=16, window=8)
        if kind != "sequential":
            eng.warmup()
        reqs = _requests(Request, np.random.default_rng(0), cfg.vocab_size,
                         RECURRENT_LENS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for counter in LAUNCH_COUNTERS.values():
            counter.reset()
        t0 = time.perf_counter()
        done = _serve_offline(eng, kind, reqs, RECURRENT_MAX_SEQ)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.n for k, c in LAUNCH_COUNTERS.items()}
        _k1_wgmma_only(launches)
        validate_stats(eng.stats)
        if launches["sisa_gemm"] <= 0 or launches["paged_attn"] \
                or launches["paged_attn_int8"]:
            raise AssertionError(f"{name} {kind} serve: {launches}")
        if len(done) != len(RECURRENT_LENS) or not all(
                0 <= t < cfg.vocab_size for c in done for t in c.tokens):
            raise AssertionError(f"{name} {kind} serve: {done}")
        counts = [c.n_tokens for c in done]
        want = _max_seq_counts(RECURRENT_LENS, NEW_TOKENS,
                               RECURRENT_MAX_SEQ)
        if counts != want:
            raise AssertionError(f"{name} {kind} token counts {counts}, "
                                 f"want {want}")
        ext = eng.stats["engine"]
        nbytes = None
        if kind != "sequential":
            if eng.stats["decode_compiles"] != 0:
                raise AssertionError(f"{name} {kind} decode_compiles "
                                     f"{eng.stats['decode_compiles']}")
            if eng.cache.n_free != eng.max_batch or ext["slot_admits"] \
                    != ext["slot_releases"]:
                raise AssertionError(f"{name} {kind} slots did not drain")
            nbytes = eng.cache.resident_bytes()
            if nbytes != RECURRENT_BYTES[name][kind]:
                raise AssertionError(f"{name} {kind} storage {nbytes} "
                                     f"bytes, want {want_bytes[kind]}")
        if kind == "paged" and (
                eng.cache.n_free_local != eng.num_local_pages
                or eng.cache.n_free_pages != eng.num_pages
                or ext["page_admits"] or ext["page_grows"]):
            raise AssertionError(
                f"{name} paged: {eng.cache.n_free_local} of "
                f"{eng.num_local_pages} ring pages free, "
                f"{ext['page_admits']} pages admitted")
        outs[kind], engs[kind] = done, eng
        n_tok = sum(counts)
        summaries[kind] = {
            "model": name, "kind": kind, "layers": cfg.n_layers,
            "max_seq": RECURRENT_MAX_SEQ, "prompts": list(RECURRENT_LENS),
            "tokens": counts, "finish": [c.finish_reason for c in done],
            "wall_s": wall, "tok_per_s": n_tok / wall,
            "ttft_p50_ms": statistics.median(eng.stats["ttft"]) * 1e3,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "decode_compiles": eng.stats["decode_compiles"],
            "decode_steps": eng.stats["decode_steps"],
            "batches": eng.stats["batches"], "storage_bytes": nbytes,
            "storage_formula": want_bytes.get(kind),
            "local_ring_pages": ext.get("local_ring_pages"),
            "window_pages_reclaimed": ext.get("window_pages_reclaimed"),
            "launches": launches}
        _say(f"recurrent serve: {json.dumps(summaries[kind])}")
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    prompt = _requests(Request, np.random.default_rng(0), cfg.vocab_size,
                       RECURRENT_LENS)[-1].prompt
    logits, _ = engs["slot"].prefill_fn(params, {
        "tokens": torch.as_tensor(prompt[None], device="cuda"),
        "last_index": len(prompt) - 1})
    _k1_wgmma_only({k: c.n for k, c in LAUNCH_COUNTERS.items()})
    if logits.shape != (1, 1, padded_vocab(cfg.vocab_size)) \
            or not torch.isfinite(logits[..., :cfg.vocab_size]).all():
        raise AssertionError(f"{name} bad logits {logits.shape}")
    same = sum(a.tokens == b.tokens
               for a, b in zip(outs["slot"], outs["paged"]))
    seq = sum(a.tokens == b.tokens
              for a, b in zip(outs["slot"], outs["sequential"]))
    _say(f"{name}: {same} of {len(RECURRENT_LENS)} completions of the "
         f"paged serve equal the slot serve's, {seq} the sequential "
         "serve's (bf16: K1 sums at other M in other orders; the "
         "sequential prefill is exact-length, the slot one bucketed)")
    profiles = {kind: profile_window(torch, np, engs[kind], cfg)
                for kind in ("slot", "paged")}
    del engs
    gc.collect()
    torch.cuda.empty_cache()
    k1 = {}
    for rows, what in ((8, "decode step (rung 8"), (2048, "prefill (2048 "
                                                       "rows, LM head on "
                                                       "1 row")):
        k1[rows] = time_k1(torch, kernels, params, cfg, rows=rows)
        _say(f"k1 {name} {what}, {k1[rows]['gemms']} GEMMs): "
             f"{json.dumps(k1[rows])}")
    return {"k1": k1, "serves": summaries, "profiles": profiles}


# internvl2-76b at full width, 8 of its 80 layers (all 80 are about 141 GB
# of bf16 weights), bf16: 8 x 1,711,308,800 bytes a layer (q and o 8192 x
# 8192, k and v 8192 x 1024, gate, up and down 8192 x 28672, two norms),
# 2 x 2,113,929,216 for the embedding and the untied head (the 128,256
# rows padded to 129,024, x 8192), 16,384 for the final norm and
# 52,445,184 for frontend_proj (3200 x 8192 and its bias).  The
# qwen workload (PROMPT_LENS, 32 new tokens, 8 slots, max_seq 256): the
# dense slot cache is 2 (K, V) x 8 layers x 8 slots x 256 cells x 8 KV
# heads x 128 x 2 bytes, the paged pools 2 x 8 layers x (8 x 16 + 1 sink)
# pages of 16 cells, and the page table 8 x 16 int32.
INTERNVL_LAYERS = 8
INTERNVL_WEIGHT_BYTES = 17_970_790_400
INTERNVL_CACHE_BYTES = 67_108_864
INTERNVL_POOL_BYTES = 67_633_664


def _internvl_bytes(cfg) -> dict:
    """internvl2's weight, dense cache and pool bytes in bf16 from the
    config (the comment above ``INTERNVL_LAYERS``)."""
    from repro_torch.models.common import padded_vocab

    d, hd, ff = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    layer = 2 * (2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                 + 3 * d * ff + 2 * d)
    table = 2 * padded_vocab(cfg.vocab_size) * d
    cell = 2 * cfg.n_kv_heads * hd
    pmax = 256 // 16
    return {"weights": cfg.n_layers * layer + 2 * table + 2 * d
            + 2 * (cfg.frontend_dim + 1) * d,
            "cache": 2 * cfg.n_layers * 8 * 256 * cell,
            "pools": 2 * cfg.n_layers * (8 * pmax + 1) * 16 * cell
            + 4 * 8 * pmax}


def serve_internvl2(torch, np, kernels) -> dict:
    """``internvl2-76b`` at full width, ``INTERNVL_LAYERS`` of its 80
    layers, bf16, seeded random weights (exactly ``INTERNVL_WEIGHT_BYTES``
    of them): the qwen workload through ``make_engine(kind="slot")``
    after ``warmup()``, ``kind="sequential"`` and ``kind="paged"`` (pages
    of 16) after ``warmup()`` (``serve_full_width``: counters zeroed just
    before each serve, every request prefilled once, 32 tokens each,
    ``decode_compiles`` 0 and slots drained on slot and paged); K1 > 0
    with every launch on the wgmma route; K2 8 launches a decode step
    on paged (its int8 variant 0) and 0 on the dense engines; the dense
    cache exactly ``INTERNVL_CACHE_BYTES``, the pools
    ``INTERNVL_POOL_BYTES``.  Then one ``forward_prefill`` with
    ``frontend_embeds`` of shape (1, 208, 3200): finite logits, and K1's
    launches those of a 208-token prefill plus ``frontend_proj``'s.
    Printed: the completions the engines share, one profiled paged
    window, K1's times for one decode step (rung 8), one 208-row prefill
    of image features (``frontend_proj``, the layers, the head on the
    last row) and ``frontend_proj`` alone, and K2's at the serve's
    layout (8 layers, GQA 64/8 at head_dim 128)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.models import forward_prefill, init_params
    from repro_torch.models.common import padded_vocab

    cfg = dataclasses.replace(get_config("internvl2-76b"),
                              n_layers=INTERNVL_LAYERS)
    want = _internvl_bytes(cfg)
    if (want["weights"], want["cache"], want["pools"]) != (
            INTERNVL_WEIGHT_BYTES, INTERNVL_CACHE_BYTES, INTERNVL_POOL_BYTES):
        raise AssertionError(f"internvl2 bytes from the config: {want}")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    _say(f"params: {cfg.name} full width, {cfg.n_layers} of 80 layers, "
         f"{nbytes} bytes of weights "
         f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated), init "
         f"{time.perf_counter() - t0:.2f} s")
    if nbytes != INTERNVL_WEIGHT_BYTES:
        raise AssertionError(f"internvl2 weights {nbytes} bytes")
    outs, k2_launches = {}, None
    for kind in ("slot", "sequential", "paged"):
        eng, _, launches, done = serve_full_width(
            torch, np, cfg, ("sisa_gemm",) + (("paged_attn",) if kind ==
                                              "paged" else ()),
            params=params, kind=kind,
            absent=("paged_attn_int8",) + (() if kind == "paged"
                                           else ("paged_attn",)))
        _k1_wgmma_only(launches)
        if kind == "paged":
            steps = eng.stats["decode_steps"]
            if launches["paged_attn"] != cfg.n_layers * steps:
                raise AssertionError(
                    f"internvl2 paged: {launches['paged_attn']} K2 launches "
                    f"for {steps} decode steps of {cfg.n_layers} layers")
            k2_launches = launches["paged_attn"]
        if kind != "sequential":
            got = eng.cache.resident_bytes()
            need = want["pools" if kind == "paged" else "cache"]
            if got != need:
                raise AssertionError(f"internvl2 {kind} storage {got} "
                                     f"bytes, want {need}")
            _say(f"internvl2 {kind} storage: {got} bytes (config: {need})")
        outs[kind] = done
        if kind == "paged":
            profile = profile_window(torch, np, eng, cfg)
        del eng
    for kind in ("sequential", "paged"):
        same = sum(a.tokens == b.tokens
                   for a, b in zip(outs["slot"], outs[kind]))
        _say(f"internvl2: {same} of {len(PROMPT_LENS)} completions of the "
             f"{kind} serve equal the slot serve's (bf16: K1 and K2 sum in "
             "other orders)")
    # One prefill of image features: frontend_proj in place of the token
    # embedding, then the 8 layers and the head on the last row.
    gen = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (1, FRONTEND_ROWS),
                           device="cuda", generator=gen)
    embeds = torch.randn(1, FRONTEND_ROWS, cfg.frontend_dim, device="cuda",
                         generator=gen)
    counts = {}
    for label, batch in (("tokens", {"tokens": tokens}),
                         ("frontend_embeds", {"tokens": tokens,
                                              "frontend_embeds": embeds})):
        for counter in LAUNCH_COUNTERS.values():
            counter.reset()
        logits, _ = forward_prefill(params, cfg, batch)
        torch.cuda.synchronize()
        launches = {k: c.n for k, c in LAUNCH_COUNTERS.items()}
        _k1_wgmma_only(launches)
        if logits.shape != (1, 1, padded_vocab(cfg.vocab_size)) \
                or not torch.isfinite(logits[..., :cfg.vocab_size]).all():
            raise AssertionError(f"internvl2 prefill ({label}): bad logits")
        counts[label] = launches["sisa_gemm"]
    passes = len(kernels.row_passes(FRONTEND_ROWS))
    layer_gemms = 7 * cfg.n_layers               # q, k, v, o, gate, up, down
    if counts != {"tokens": layer_gemms * passes + 1,
                  "frontend_embeds": (layer_gemms + 1) * passes + 1}:
        raise AssertionError(f"internvl2 prefill K1 launches {counts}")
    _say(f"internvl2 prefill of {FRONTEND_ROWS} positions: finite logits; "
         f"K1 launches {counts} ({passes} a {FRONTEND_ROWS}-row GEMM, the "
         f"head on the last row: frontend_proj's {passes} beside the "
         "token prefill's)")
    k1 = {"decode": time_k1(torch, kernels, params, cfg, rows=8),
          "prefill": time_k1(torch, kernels, params, cfg,
                             rows=FRONTEND_ROWS, embeds=True),
          "frontend_proj": time_gemms(torch, kernels, [(
              embeds[0].bfloat16(), params["frontend_proj"]["w"])])}
    for what, t in k1.items():
        rows = "rung 8" if what == "decode" else f"{FRONTEND_ROWS} rows"
        _say(f"k1 internvl2-76b {what} ({rows}, {t['gemms']} GEMMs): "
             f"{json.dumps(t)}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    k2 = time_k2(torch, kernels, K2_HEADS[3], cfg.n_layers)
    _say(f"k2 internvl2-76b layout decode step (8 rows, GQA 64/8 hd 128, "
         f"{k2['launches_timed']} layers): {json.dumps(k2)}")
    return {"k1": k1, "k2": k2, "k2_serve_launches": k2_launches,
            "profile": profile}


# whisper-base at full width and depth, bf16: 71,428,608 parameters
# (the tied 51,865-row table padded to 53,248 x 512; 6 decoder layers of
# self and cross attention and a GELU MLP, biases on every linear; 6
# encoder layers; frontend_proj 80 x 512 with its bias).  The slot
# buffers at 8 slots and max_seq 448: the self stacks 2 (K, V) x 6 layers
# x 8 slots x 448 cells and the cross stacks 2 x 6 x 8 x 1,500 frames,
# each cell 8 KV heads x 64 x 2 bytes.  A decode step launches K1 49
# times at rung 8: q, k, v and o, the cross attention's q and o, up and
# down in each of 6 layers, and the head; the cross K/V are projected
# once, at prefill.
WHISPER_PARAMS = 71_428_608
WHISPER_SLOT_BYTES = 191_496_192
WHISPER_DECODE_K1 = 49
# The paged engine at the same 8 slots, max_seq 448 and pages of 16:
# global pools 2 x 6 layers x (8 x 28 + 1) pages x 16 cells x 8 x 64 x 2
# bytes = 44,236,800 (int8 values and bf16 scales: 22,809,600), cross
# pools 2 x 6 x (8 x 94 + 1) x 16 x 8 x 64 x 2 = 148,045,824 (the 1,500
# frames in 94 pages, 12 cells in the last; bf16 also on int8 pools), and
# the page and cross tables 8 x 28 and 8 x 94 int32.  rid 2 shares rid
# 1's features, so the 8 requests admit 7 cross blocks and share 1.
WHISPER_POOL_BYTES = 192_286_528
WHISPER_POOL_INT8_BYTES = 170_859_328
WHISPER_CROSS_PAGES = 94


def _whisper_counts(cfg) -> dict:
    """whisper's parameter count, slot buffer and page pool bytes (bf16
    weights; pools of bf16 and of int8) and K1 launches a decode step,
    from the config (the comment above ``WHISPER_PARAMS``)."""
    from repro_torch.models.common import padded_vocab

    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    # q, k, v and o with their biases
    attn = 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
        + cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd + d
    mlp = 2 * d * ff + ff + d
    cell = 2 * cfg.n_kv_heads * hd
    # Paged: K and V cells of a page in every layer, the global pools'
    # 8 x 28 pages + sink, the cross pools' 8 blocks of 94 pages + sink
    # (bf16 whatever kv_quant says), both tables in int32.
    page_cells = 2 * cfg.n_layers * 16 * cfg.n_kv_heads
    cpages = -(-cfg.enc_frames // 16)
    glob = page_cells * (8 * WHISPER_PMAX + 1)
    cross = 2 * page_cells * hd * (8 * cpages + 1)
    tables = 4 * 8 * (WHISPER_PMAX + cpages)
    return {"params": padded_vocab(cfg.vocab_size) * d + d
            + cfg.n_layers * (3 * d + 2 * attn + mlp)
            + cfg.n_enc_layers * (2 * d + attn + mlp) + d
            + (cfg.frontend_dim + 1) * d,
            "slot_bytes": 2 * cfg.n_layers * 8 * (WHISPER_MAX_SEQ
                                                   + cfg.enc_frames) * cell,
            "pool_bytes": 2 * glob * hd + cross + tables,
            "pool_int8_bytes": glob * (hd + 2) + cross + tables,
            "cross_pages": cpages,
            "decode_k1": 8 * cfg.n_layers + 1}


def _whisper_requests(Request, np, cfg):
    """The qwen workload (``PROMPT_LENS``, two prompts sharing a prefix,
    32 new tokens each) with ``_whisper_features``."""
    reqs = _requests(Request, np.random.default_rng(0), cfg.vocab_size,
                     PROMPT_LENS)
    _whisper_features(np, cfg)(reqs)
    return reqs


def _whisper_features(np, cfg):
    """A ``prepare`` hook (``serve_full_width``): each request its own
    seeded (1,500, 80) float32 features but rid 2, which shares rid 1's
    block."""
    def prepare(reqs):
        rng = np.random.default_rng(11)
        for req in reqs:
            req.enc_embeds = rng.standard_normal(
                (cfg.enc_frames, cfg.frontend_dim), dtype=np.float32)
        reqs[2].enc_embeds = reqs[1].enc_embeds
    return prepare


def _whisper_gemms(torch, params, cfg, part: str, rows: int, gen):
    """K1's ``(a, b)`` pairs of one whisper pass, a random bf16 input a
    (rows, K): ``"decode"`` one decode step (each layer's q, k, v, o,
    cross q and o, up and down, and the head on every row);
    ``"encoder"`` one request's encoder over ``rows`` frames
    (``frontend_proj``, each encoder layer's q, k, v, o, up and down) and
    the decoder's cross K/V projections over its output;
    ``"frontend_proj"`` that GEMM alone."""
    xs = {}

    def x_of(k):
        if k not in xs:
            xs[k] = torch.randn(rows, k, device="cuda",
                                generator=gen).bfloat16()
        return xs[k]

    def lin(p):
        return (x_of(p["w"].shape[0]), p["w"])

    proj = [lin(params["frontend_proj"])]
    if part == "frontend_proj":
        return proj
    if part == "encoder":
        return proj + [lin(layer[group][name])
                       for layer in params["encoder"]["layers"]
                       for group, names in (("mixer", "qkvo"),
                                            ("mlp", ("up", "down")))
                       for name in names] + [
            lin(layer["cross"][name]) for layer in params["layers"]
            for name in "kv"]
    gemms = [lin(layer[group][name]) for layer in params["layers"]
             for group, names in (("mixer", "qkvo"), ("cross", "qo"),
                                  ("mlp", ("up", "down")))
             for name in names]
    return gemms + [(x_of(cfg.d_model), params["embed"]["table"].T)]


def _whisper_window(torch, np, eng, cfg) -> dict:
    """One window at rung 8 with all 8 requests resident: K1 launches
    ``WHISPER_DECODE_K1`` times a step, every one on the wgmma route, and
    on the paged engine K2 once a layer a step; the cross K/V (the slot
    buffers' ``xk``, ``xv``, the paged engine's pools ``ck``, ``cv``) is
    bitwise unchanged across it; then the requests finish and the slots
    drain."""
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.serve import Request

    reqs = _whisper_requests(Request, np, cfg)
    for req in reqs:
        req.max_new_tokens = 2 * eng.window + 1
        eng.submit(req)
    finished = []
    eng.step(finished)                  # admission, prefills, one window
    if eng.queue or eng._n_active() != len(reqs):
        raise AssertionError(f"whisper: {eng._n_active()} resident after "
                             f"the first step, {len(eng.queue)} queued")
    paged = hasattr(eng.cache, "pools")
    store = eng.cache.pools if paged else eng.cache.buffers
    held = {k: store[k].clone()
            for k in (("ck", "cv") if paged else ("xk", "xv"))}
    torch.cuda.synchronize()
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    eng.step(finished)                  # one decode window, nothing else
    torch.cuda.synchronize()
    launches = {name: c.n for name, c in LAUNCH_COUNTERS.items()}
    _k1_wgmma_only(launches)
    rung = eng.stats["engine"]["rungs"][-1]
    k2 = cfg.n_layers * eng.window if paged else 0
    if rung != 8 or launches["sisa_gemm"] != WHISPER_DECODE_K1 * eng.window \
            or launches["paged_attn"] != k2 or launches["paged_attn_int8"]:
        raise AssertionError(f"whisper window at rung {rung}: "
                             f"{launches['sisa_gemm']} K1 and "
                             f"{launches['paged_attn']} K2 launches for "
                             f"{eng.window} steps")
    for k, t in held.items():
        if not torch.equal(store[k], t):
            raise AssertionError(f"whisper: the cross stack {k} changed "
                                 "across a decode window")
    eng.run()
    if eng.cache.n_free != eng.max_batch:
        raise AssertionError("whisper: slots did not drain after the window")
    out = {"rung": rung, "steps": eng.window,
           "k1_launches": launches["sisa_gemm"],
           "k1_per_step": launches["sisa_gemm"] / eng.window,
           "k2_per_step": launches["paged_attn"] / eng.window,
           "cross_stacks_unchanged": True}
    _say(f"whisper {'paged' if paged else 'slot'} window: {json.dumps(out)}")
    return out


def serve_whisper(torch, np, kernels) -> dict:
    """``whisper-base`` at full width and depth in bf16, seeded random
    weights (exactly ``WHISPER_PARAMS`` parameters): the 8 requests of
    ``_whisper_requests`` through ``make_engine(kind="slot",
    max_slots=8, max_seq=448, window=8)`` after ``warmup()``, then
    ``kind="sequential"``; every launch counter zeroed just before each
    serve: K1 > 0, all on the wgmma route (``sisa_gemm_core`` 0), K2 and
    its int8 variant 0, 32 tokens each; slot: ``decode_compiles`` 0, every
    slot drained, the buffers exactly ``WHISPER_SLOT_BYTES`` (the cross
    stacks at 1,500 frames); one window at rung 8 (``_whisper_window``:
    49 K1 launches a step, the cross stacks bitwise unchanged); finite
    logits of the expected shape from one prefill with features.
    Printed: the completions the two engines share, one profiled slot
    window, and K1's times for a rung-8 decode step, one request's
    1,500-frame encoder (with the cross K/V projections) and
    ``frontend_proj`` alone."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.models import forward_prefill, init_params
    from repro_torch.models.common import padded_vocab
    from repro_torch.serve import make_engine, Request, validate_stats
    from repro_torch.serve.engine import prefill_batch_of

    cfg = get_config("whisper-base")
    want = _whisper_counts(cfg)
    if (want["params"], want["slot_bytes"], want["decode_k1"],
            want["pool_bytes"], want["pool_int8_bytes"],
            want["cross_pages"]) != (
            WHISPER_PARAMS, WHISPER_SLOT_BYTES, WHISPER_DECODE_K1,
            WHISPER_POOL_BYTES, WHISPER_POOL_INT8_BYTES,
            WHISPER_CROSS_PAGES):
        raise AssertionError(f"whisper counts from the config: {want}")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    _say(f"params: {cfg.name} full width, {cfg.n_enc_layers} encoder + "
         f"{cfg.n_layers} decoder layers, {n_params} parameters "
         f"({torch.cuda.memory_allocated() / 1e9:.3f} GB allocated), init "
         f"{time.perf_counter() - t0:.2f} s")
    if n_params != WHISPER_PARAMS:
        raise AssertionError(f"whisper parameters {n_params}")
    outs, summaries, window = {}, {}, None
    for kind in ("slot", "sequential"):
        eng = make_engine(cfg, params, kind=kind, max_slots=8,
                          max_seq=WHISPER_MAX_SEQ, window=8)
        if kind == "slot":
            eng.warmup()
        reqs = _whisper_requests(Request, np, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for counter in LAUNCH_COUNTERS.values():
            counter.reset()
        t0 = time.perf_counter()
        done = _serve_offline(eng, kind, reqs, WHISPER_MAX_SEQ)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: c.n for name, c in LAUNCH_COUNTERS.items()}
        _k1_wgmma_only(launches)
        validate_stats(eng.stats)
        if launches["sisa_gemm"] <= 0 or launches["paged_attn"] \
                or launches["paged_attn_int8"]:
            raise AssertionError(f"whisper {kind} serve: {launches}")
        if len(done) != len(reqs) or any(
                c.n_tokens != NEW_TOKENS or c.finish_reason != "length"
                or not all(0 <= t < cfg.vocab_size for t in c.tokens)
                for c in done):
            raise AssertionError(f"whisper {kind} serve: " + str(
                [(c.rid, c.n_tokens, c.finish_reason) for c in done]))
        ext = eng.stats["engine"]
        if kind == "slot":
            if eng.stats["decode_compiles"] != 0:
                raise AssertionError(f"whisper slot decode_compiles "
                                     f"{eng.stats['decode_compiles']}")
            if eng.cache.n_free != eng.max_batch or ext["slot_admits"] \
                    != ext["slot_releases"]:
                raise AssertionError("whisper slots did not drain")
            nbytes = eng.cache.resident_bytes()
            if nbytes != WHISPER_SLOT_BYTES:
                raise AssertionError(f"whisper slot buffers {nbytes} bytes, "
                                     f"want {WHISPER_SLOT_BYTES}")
        n_tok = sum(c.n_tokens for c in done)
        summaries[kind] = {
            "model": cfg.name, "kind": kind, "max_seq": WHISPER_MAX_SEQ,
            "prompts": list(PROMPT_LENS), "frames": cfg.enc_frames,
            "wall_s": wall, "tok_per_s": n_tok / wall,
            "ttft_p50_ms": statistics.median(eng.stats["ttft"]) * 1e3,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "decode_compiles": eng.stats["decode_compiles"],
            "decode_steps": eng.stats["decode_steps"],
            "batches": eng.stats["batches"],
            "cache_bytes": (eng.cache.resident_bytes() if kind == "slot"
                            else None),
            "launches": launches}
        _say(f"whisper serve: {json.dumps(summaries[kind])}")
        outs[kind] = done
        if kind == "slot":
            window = _whisper_window(torch, np, eng, cfg)
            profile = profile_window(torch, np, eng, cfg)
            # Finite f32 logits of the expected shape from one prefill
            # of a prompt with its features.
            req = _whisper_requests(Request, np, cfg)[0]
            for counter in LAUNCH_COUNTERS.values():
                counter.reset()
            logits, cache = forward_prefill(params, cfg, prefill_batch_of(
                req.prompt[None], [req], cfg, "cuda"))
            torch.cuda.synchronize()
            _k1_wgmma_only({k: c.n for k, c in LAUNCH_COUNTERS.items()})
            if tuple(cache["xk"].shape) != (
                    cfg.n_layers, 1, cfg.enc_frames, cfg.n_kv_heads,
                    cfg.resolved_head_dim) or logits.shape != (
                    1, 1, padded_vocab(cfg.vocab_size)) \
                    or not torch.isfinite(logits[..., :cfg.vocab_size]).all():
                raise AssertionError("whisper prefill: bad logits or cache")
        del eng
    same = sum(a.tokens == b.tokens
               for a, b in zip(outs["slot"], outs["sequential"]))
    _say(f"whisper: {same} of {len(PROMPT_LENS)} completions of the slot "
         "and sequential serves equal (the sequential engine decodes a "
         "batch at its longest row's position; its prefill is "
         "exact-length, the slot engine's bucketed)")
    paged = serve_whisper_paged(torch, np, kernels, cfg, params,
                                outs["slot"])
    gen = torch.Generator(device="cuda").manual_seed(12)
    k1 = {part: time_gemms(torch, kernels, _whisper_gemms(
              torch, params, cfg, part, rows, gen))
          for part, rows in (("decode", 8), ("encoder", WHISPER_FRAMES),
                             ("frontend_proj", WHISPER_FRAMES))}
    for part, t in k1.items():
        rows = "rung 8" if part == "decode" else f"{WHISPER_FRAMES} frames"
        _say(f"k1 whisper-base {part} ({rows}, {t['gemms']} GEMMs): "
             f"{json.dumps(t)}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"k1": k1, "serves": summaries, "window": window,
            "profile": profile, "paged": paged}


def serve_whisper_paged(torch, np, kernels, cfg, params, slot_outs) -> dict:
    """The 8 requests of ``_whisper_requests`` through
    ``make_engine(kind="paged", max_slots=8, max_seq=448, page_size=16,
    window=8)`` after ``warmup()``, on bf16 pools and then on
    ``kv_quant="int8"``; every launch counter zeroed just before each
    serve: K1 > 0, all on the wgmma route, K2 once a layer a decode step
    on the pools' variant and never on the other, 32 tokens each,
    ``decode_compiles`` 0, 7 cross blocks admitted and 1 shared (rid 2
    maps rid 1's), no token prefix shared, the pools exactly
    ``WHISPER_POOL_BYTES`` / ``WHISPER_POOL_INT8_BYTES``, and every slot,
    global page and cross page back (no refcount, no registry entry
    left).  On bf16 pools one window at rung 8 (``_whisper_window``: 49
    K1 and 6 K2 launches a step, ``ck``/``cv`` bitwise unchanged).
    Printed: the completions each paged serve shares with the slot
    serve, one profiled paged window, and K2's times at whisper's layout
    (GQA 8/8 hd 64, 6 layers, the serve's end positions, 28-page tables)
    on bf16 and int8 pools beside the plain version and the bound."""
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.serve import make_engine, Request, validate_stats

    t_start = time.perf_counter()
    want = {None: WHISPER_POOL_BYTES, "int8": WHISPER_POOL_INT8_BYTES}
    summaries, window, profile = {}, None, None
    for quant, nbytes in want.items():
        label = quant or "bf16"
        eng = make_engine(cfg, params, kind="paged", max_slots=8,
                          max_seq=WHISPER_MAX_SEQ, page_size=16, window=8,
                          kv_quant=quant)
        eng.warmup()
        reqs = _whisper_requests(Request, np, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for counter in LAUNCH_COUNTERS.values():
            counter.reset()
        t0 = time.perf_counter()
        done = _serve_offline(eng, "paged", reqs, WHISPER_MAX_SEQ)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: c.n for name, c in LAUNCH_COUNTERS.items()}
        _k1_wgmma_only(launches)
        validate_stats(eng.stats)
        k2, off = (("paged_attn_int8", "paged_attn") if quant
                   else ("paged_attn", "paged_attn_int8"))
        steps = eng.stats["decode_steps"]
        if launches["sisa_gemm"] <= 0 or launches[off] \
                or launches[k2] != cfg.n_layers * steps:
            raise AssertionError(f"whisper paged {label} serve: {steps} "
                                 f"decode steps, launches {launches}")
        if len(done) != len(reqs) or any(
                c.n_tokens != NEW_TOKENS or c.finish_reason != "length"
                or not all(0 <= t < cfg.vocab_size for t in c.tokens)
                for c in done):
            raise AssertionError(f"whisper paged {label} serve: " + str(
                [(c.rid, c.n_tokens, c.finish_reason) for c in done]))
        ext, c = eng.stats["engine"], eng.cache
        got = c.resident_bytes()
        back = (c.n_free == eng.max_batch and c.n_free_pages == c.num_pages
                and c.reserved_total == 0 and c.orphaned_pages == 0
                and c.n_free_cross == c.num_cross_pages
                == 8 * WHISPER_CROSS_PAGES
                and not any(c.cross_refcount(p)
                            for p in range(c.num_cross_pages))
                and not eng._cross_registry and not eng._cross_key)
        if eng.stats["decode_compiles"] != 0 or ext["cross_admits"] != 7 \
                or ext["cross_shared"] != 1 or ext["pages_shared"] \
                or got != nbytes or not back:
            raise AssertionError(
                f"whisper paged {label}: decode_compiles "
                f"{eng.stats['decode_compiles']}, cross blocks "
                f"{ext['cross_admits']} admitted / {ext['cross_shared']} "
                f"shared, pages shared {ext['pages_shared']}, pools {got} "
                f"bytes (want {nbytes}), storage back {back}")
        same = sum(a.tokens == b.tokens for a, b in zip(slot_outs, done))
        n_tok = sum(x.n_tokens for x in done)
        summaries[label] = {
            "model": cfg.name, "kind": "paged", "kv_pool": ext["kv_pool"],
            "max_seq": WHISPER_MAX_SEQ, "page_size": 16,
            "wall_s": wall, "tok_per_s": n_tok / wall,
            "ttft_p50_ms": statistics.median(eng.stats["ttft"]) * 1e3,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "decode_compiles": eng.stats["decode_compiles"],
            "decode_steps": steps, "batches": eng.stats["batches"],
            "cross_admits": ext["cross_admits"],
            "cross_shared": ext["cross_shared"],
            "page_admits": ext["page_admits"],
            "pages_mapped_peak": ext["pages_mapped_peak"],
            "pool_bytes": got, "k2_launches": launches[k2],
            "k2_per_step": launches[k2] / steps,
            "same_as_slot": same, "launches": launches}
        _say(f"whisper serve: {json.dumps(summaries[label])}")
        _say(f"whisper paged {label}: {same} of {len(PROMPT_LENS)} "
             "completions equal the slot serve's (bf16: K2 sums the "
             "self-attention in another order than the dense decode)")
        if quant is None:
            window = _whisper_window(torch, np, eng, cfg)
            profile = profile_window(torch, np, eng, cfg)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    k2 = {label: time_k2(torch, kernels, K2_HEADS[4], cfg.n_layers,
                         quant=quant, pmax=WHISPER_PMAX)
          for label, quant in (("bf16", False), ("int8", True))}
    for label, t in k2.items():
        _say(f"k2 whisper-base layout decode step ({label} pools, 8 rows, "
             f"GQA 8/8 hd 64, {WHISPER_PMAX}-page tables, "
             f"{t['launches_timed']} layers): {json.dumps(t)}")
    _say(f"whisper paged serves and K2 times: "
         f"{time.perf_counter() - t_start:.1f} s")
    return {"serves": summaries, "window": window, "profile": profile,
            "k2": k2}


def train_whisper(torch, kernels) -> dict:
    """``whisper-base`` at full width and depth through
    ``train_full_width``: ``TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x
    (1,500 frames of features, 448 tokens), ``remat="none"``; K1 > 0,
    every launch on the wgmma route, finite losses; one step profiled
    part by part (``profile_train_phases``), whose K1 launches, forward
    and backward, times ``TRAIN_STEPS`` must be the run's; and K1's
    times for one step's forward and backward GEMMs (the encoder's and
    the cross K/V projections at 12,000 rows, the decoder's and the head
    at 3,584) beside the plain version, the bound and
    ``torch.matmul``."""
    from repro_torch.configs import get_config

    cfg = get_config("whisper-base")
    trainer, out, launches, summary = train_full_width(
        torch, cfg, need=("sisa_gemm",), seq=WHISPER_FRAMES,
        tokens=TRAIN_BATCH * WHISPER_MAX_SEQ)
    _k1_wgmma_only(launches)
    batch = trainer.data.batch(0)
    if batch["frontend_embeds"].shape != (TRAIN_BATCH, WHISPER_FRAMES,
                                          cfg.frontend_dim) \
            or batch["tokens"].shape != (TRAIN_BATCH, WHISPER_MAX_SEQ):
        raise AssertionError(f"whisper batch: { {k: v.shape for k, v in batch.items()} }")
    params, opt_state = out["params"], out["opt_state"]
    del out
    prof = profile_train_phases(torch, trainer, params, opt_state)
    per_step = prof["k1_launches"]["forward"] \
        + prof["k1_launches"]["backward"]
    if launches["sisa_gemm"] != TRAIN_STEPS * per_step:
        raise AssertionError(f"whisper: {launches['sisa_gemm']} K1 launches "
                             f"in {TRAIN_STEPS} steps of {per_step}")
    del opt_state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(13)
    enc = _whisper_gemms(torch, params, cfg, "encoder",
                         WHISPER_TRAIN_ROWS["encoder"], gen)
    dec = _whisper_gemms(torch, params, cfg, "decode",
                         WHISPER_TRAIN_ROWS["decoder"], gen)
    k1 = time_train_gemms(torch, kernels, enc + dec, gen)
    _say(f"k1 train step (whisper-base, {len(enc)} GEMMs at "
         f"{WHISPER_TRAIN_ROWS['encoder']} rows, {len(dec)} at "
         f"{WHISPER_TRAIN_ROWS['decoder']}): {json.dumps(k1)}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"summary": summary, "profile": prof, "k1": k1}


# An exception in a frontend thread ends that thread (the scheduler's
# ends the serve): each one is recorded here and re-raised in the main
# thread by _drain.
THREAD_ERRORS = []


def _record_thread_error(args) -> None:
    THREAD_ERRORS.append(args)
    _say(f"thread {args.thread.name if args.thread else '?'} raised "
         f"{args.exc_type.__name__}: {args.exc_value}")


def _drain(fe, timeout: float):
    """``fe.drain`` in 5-second waits, failing at once on an exception
    recorded from a frontend thread (or at ``timeout``)."""
    end = time.perf_counter() + timeout
    while True:
        if THREAD_ERRORS:
            err = THREAD_ERRORS[0]
            raise RuntimeError(f"frontend thread {err.thread.name} died: "
                               f"{err.exc_type.__name__}") from err.exc_value
        try:
            return fe.drain(timeout=min(5.0, end - time.perf_counter()))
        except TimeoutError:
            if time.perf_counter() >= end:
                raise


def _shutdown(fe) -> None:
    """Stop the frontend; both of its threads must be gone."""
    fe.shutdown(timeout=60)
    alive = [t.name for t in (fe._scheduler_t, fe._emitter_t)
             if t is not None and t.is_alive()]
    if alive or THREAD_ERRORS:
        raise AssertionError(f"frontend threads alive after shutdown: "
                             f"{alive}; thread errors: {THREAD_ERRORS}")


ONLINE_GAP_S = 0.1     # mean inter-arrival gap of the online serve


def _online(torch, fe, prompts, gaps, on_token=None):
    """Submit ``prompts`` (NEW_TOKENS each) from a separate thread at
    ``gaps`` (request 3 carries ``on_token``) and drain.  Returns the
    handles by rid, the completions and the wall from the first submit
    to the drain's end."""
    handles = {}

    def submitter():
        for rid, (p, gap) in enumerate(zip(prompts, gaps)):
            if rid:
                time.sleep(gap)
            handles[rid] = fe.submit(p, NEW_TOKENS, rid=rid,
                                     on_token=on_token if rid == 3
                                     else None)

    t0 = time.perf_counter()
    thread = threading.Thread(target=submitter, name="submitter")
    thread.start()
    thread.join(60)
    done = _drain(fe, 600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(handles) != len(prompts):
        raise AssertionError(f"{len(handles)} of {len(prompts)} submitted")
    return handles, sorted(done, key=lambda c: c.rid), wall


def serve_online(torch, np, cfg, params):
    """The online serve of full-width qwen2.5-0.5b (bf16): the 8 requests
    through ``ServeFrontend`` over the paged engine of phase 7, submitted
    by a separate thread at seeded exponential gaps (mean 100 ms), one
    with an ``on_token`` callback; then a seeded fault storm on a pool of
    half the pages 8 residents reserve.  Each is checked for K1 and K2
    launches, finish reasons and a drained pool; the offline serve of the
    same requests on the same engine runs first, and the online metrics
    are printed beside it."""
    from torch.profiler import profile, ProfilerActivity

    from repro_torch.distributed.fault import StragglerWatchdog
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.serve import (FaultPlan, make_engine, Request,
                                   ServeFrontend)

    opts = dict(kind="paged", max_slots=8, max_seq=256, page_size=16,
                window=8)

    def reqs():
        return _requests(Request, np.random.default_rng(0), cfg.vocab_size,
                         PROMPT_LENS)

    prompts = [r.prompt for r in reqs()]
    gaps = np.random.default_rng(0).exponential(ONLINE_GAP_S,
                                                size=len(prompts))
    eng = make_engine(cfg, params, **opts)
    eng.warmup()
    for req in reqs():
        eng.submit(req)
    t0 = time.perf_counter()
    offline = sorted(eng.run(), key=lambda c: c.rid)
    torch.cuda.synchronize()
    offline_wall = time.perf_counter() - t0

    fe = ServeFrontend(eng)
    fe.warmup()
    stream = []
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    handles, online, wall = _online(torch, fe, prompts, gaps,
                                    on_token=stream.append)
    launches = {k: c.n for k, c in LAUNCH_COUNTERS.items() if c.n}
    stats, metrics = fe.stats, fe.metrics()
    _shutdown(fe)
    if any(not h.done for h in handles.values()) or any(
            c.finish_reason != "length" or c.n_tokens != NEW_TOKENS
            for c in online):
        raise AssertionError("online serve: " + str(
            [(c.rid, c.n_tokens, c.finish_reason) for c in online]))
    if tuple(stream) != handles[3].result(timeout=1).tokens \
            or tuple(handles[3].tokens) != online[3].tokens:
        raise AssertionError(f"on_token stream {stream} differs from its "
                             f"handle's {handles[3].tokens}")
    if launches.get("sisa_gemm", 0) <= 0 or launches.get("paged_attn", 0) <= 0:
        raise AssertionError(f"online serve skipped a kernel: {launches}")
    if stats["decode_compiles"] != 0:
        raise AssertionError(f"online decode_compiles "
                             f"{stats['decode_compiles']} after warmup")
    # PROMPT_LENS fall in 8 different page-multiple buckets, so the
    # paged engine batches no group (prefill_batches stays 0); every
    # admission still goes through the frontend's coalesced prefill.
    if fe.coalesced_prefills <= 0:
        raise AssertionError("no admission through prefill_batch")
    if eng.cache.n_free_pages != eng.cache.num_pages \
            or eng.cache.reserved_total != 0:
        raise AssertionError("online serve: page pool did not drain")
    n_tok = sum(c.n_tokens for c in online)
    pct = lambda xs, q: float(np.percentile(xs, q)) * 1e3  # noqa: E731
    out = {"requests": len(online), "tokens": n_tok,
           "arrival_gaps_s": float(gaps[1:].sum()), "wall_s": wall,
           "tok_per_s": n_tok / wall,
           "ttft_p50_ms": pct(metrics["ttft"], 50),
           "ttft_p99_ms": pct(metrics["ttft"], 99),
           "tpot_p50_ms": pct(metrics["tpot"], 50),
           "tpot_p99_ms": pct(metrics["tpot"], 99),
           "offline_wall_s": offline_wall,
           "offline_tok_per_s": sum(c.n_tokens for c in offline)
           / offline_wall,
           "offline_ttft_p50_ms": statistics.median(
               [c.ttft for c in offline]) * 1e3,
           "equal_to_offline": sum(a.tokens == b.tokens
                                   for a, b in zip(online, offline)),
           "coalesced_prefills": fe.coalesced_prefills,
           "prefill_batches": stats["engine"]["prefill_batches"],
           "decode_compiles": stats["decode_compiles"],
           "decode_steps": stats["decode_steps"],
           "launches": launches}
    _say(f"online serve (ServeFrontend over paged, seeded arrivals): "
         f"{json.dumps(out)}")

    # The same online serve again, under torch.profiler's device trace
    # only: the card's idle share over the serve's wall.
    fe = ServeFrontend(eng)
    fe.warmup()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, pwall = _online(torch, fe, prompts, gaps)
    _shutdown(fe)
    busy = sum(_self_device_us(e) for e in prof.key_averages()
               if "CUDA" in str(getattr(e, "device_type", ""))) / 1e3
    _say(f"online serve profile: wall {pwall * 1e3:.1f} ms, device busy "
         f"{busy:.2f} ms, idle share "
         f"{(1 - busy / (pwall * 1e3)) if busy else None}")

    need = sum(eng._pages_for(r) for r in reqs())
    storm = make_engine(cfg, params, num_pages=need // 2, **opts)
    storm.warmup()
    plan = FaultPlan.random(0, n_events=10, horizon=24)
    fe = ServeFrontend(storm, fault_plan=plan, watchdog=StragglerWatchdog())
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    _, faulted, swall = _online(torch, fe, prompts, np.zeros(len(prompts)))
    launches = {k: c.n for k, c in LAUNCH_COUNTERS.items() if c.n}
    _shutdown(fe)
    reasons = [c.finish_reason for c in faulted]
    c = storm.cache
    leaks = {"free_slots": c.n_free - storm.max_batch,
             "free_pages": c.n_free_pages - c.num_pages,
             "reserved": c.reserved_total, "orphaned": c.orphaned_pages,
             "prefix_entries": len(storm._prefix_registry)
             + len(storm._page_key)}
    if len(faulted) != len(prompts) or any(
            r not in ("length", "cancelled", "deadline") for r in reasons):
        raise AssertionError(f"fault storm: reasons {reasons}")
    if any(leaks.values()):
        raise AssertionError(f"fault storm leaked: {leaks}")
    if not fe.fault_log:
        raise AssertionError("fault storm: no fault fired")
    if launches.get("sisa_gemm", 0) <= 0 or launches.get("paged_attn", 0) <= 0:
        raise AssertionError(f"fault storm skipped a kernel: {launches}")
    survivors = [f for f in faulted if f.finish_reason == "length"]
    out = {"num_pages": c.num_pages, "reserve_of_8": need,
           "fault_log": fe.fault_log,
           "finish_reasons": {r: reasons.count(r) for r in set(reasons)},
           "length_survivors": len(survivors),
           "survivors_equal_to_online": sum(
               f.tokens == online[f.rid].tokens for f in survivors),
           "truncated_prefix_of_online": sum(
               f.tokens == online[f.rid].tokens[:f.n_tokens]
               for f in faulted if f.finish_reason != "length"),
           "preemptions": storm.stats["engine"]["preemptions"],
           "wall_s": swall, "leaks": leaks, "launches": launches}
    _say(f"fault storm (FaultPlan.random(0, n_events=10, horizon=24)): "
         f"{json.dumps(out)}")
    del storm, eng


def run_launchers(torch) -> None:
    """Both launchers in-process on the card: ``launch.serve`` at full
    width on the paged engine (returns 0, K1 and K2 launched), then
    ``launch.train`` on the smoke config (returns 0, finite losses)."""
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.launch import serve, train

    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    buf = StringIO()
    with redirect_stdout(buf):
        rc = serve.main(["--arch", "qwen2.5-0.5b", "--engine", "paged",
                         "--requests", "8"])
    launches = {k: c.n for k, c in LAUNCH_COUNTERS.items() if c.n}
    _say(buf.getvalue().rstrip())
    if rc != 0 or launches.get("sisa_gemm", 0) <= 0 \
            or launches.get("paged_attn", 0) <= 0:
        raise AssertionError(f"launch.serve returned {rc}, launches "
                             f"{launches}")
    buf = StringIO()
    with redirect_stdout(buf):
        rc = train.main(["--arch", "qwen2.5-0.5b", "--smoke", "--steps",
                         "2"])
    _say(buf.getvalue().rstrip())
    m = re.search(r"done: loss (\S+) -> (\S+);", buf.getvalue())
    if rc != 0 or not m or not all(math.isfinite(float(x))
                                   for x in m.groups()):
        raise AssertionError(f"launch.train returned {rc}")
    _say(f"launchers: launch.serve rc 0 with launches {json.dumps(launches)};"
         f" launch.train rc 0, loss {m.group(1)} -> {m.group(2)}")


def _only_wgmma_routes(launches) -> dict:
    """Launches of K4 and K5 by wgmma route (``counter bq nwg stages``);
    raises unless every bf16 launch of a run took one (none fell to the
    CUDA-core bodies)."""
    from repro_torch.kernels.grouped_gemm import ROUTE_LAUNCHES

    for name in ("grouped_gemm", "grouped_gemm_dx", "grouped_dw"):
        routed = sum(c for r, c in ROUTE_LAUNCHES.items() if r[0] == name)
        if routed != launches[name]:
            raise AssertionError(f"{launches[name] - routed} of "
                                 f"{launches[name]} {name} launches left "
                                 "the wgmma route")
    return {" ".join(map(str, r)): c for r, c in sorted(
        ROUTE_LAUNCHES.items())}


def profile_window(torch, np, eng, cfg, steps=None) -> dict:
    """Where one decode window's time goes at rung 8: device time per
    kernel family from ``torch.profiler`` against the window's wall
    time (the rest of the wall is the host launching work).  Kernels of
    no family that copy (casts, ``cat``, memcpy) count as ``copy``, and
    ``collectives_device_ms`` gives the device time of a sharded
    engine's collective ranges (their kernels, inside the families);
    ``launches_a_step`` the window's launches a decode step.  ``steps``,
    if given, shortens the profiled window to that many decode steps."""
    from torch.profiler import profile, ProfilerActivity

    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.serve import Request

    rng = np.random.default_rng(5)
    for req in _requests(Request, rng, cfg.vocab_size, PROMPT_LENS):
        req.max_new_tokens = 2 * eng.window + 1
        eng.submit(req)
    finished = []
    eng.step(finished)                  # admission, prefills, one window
    torch.cuda.synchronize()
    queued = len(eng.queue)
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    window, eng.window = eng.window, steps or eng.window
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step(finished)              # one decode window, nothing else
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {name: c.n / eng.window for name, c in LAUNCH_COUNTERS.items()
                if c.n}
    eng.window = window
    eng.run()
    fam = {"sisa_gemm": 0.0, "paged_attn": 0.0, "grouped_gemm": 0.0,
           "copy": 0.0, "other": 0.0}
    host, collectives = [], {}
    for evt in prof.events():
        if evt.name.startswith("collective::") \
                and "CUDA" not in str(evt.device_type):
            # The kernels a sharded engine's collective range launched
            # (its gathers and sums), inside the families below.
            collectives[evt.name] = (collectives.get(evt.name, 0.0)
                                     + evt.device_time_total / 1e3)
    for evt in prof.key_averages():
        if getattr(evt, "is_user_annotation", False):
            continue                    # a range's span, not a kernel
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            host.append((evt.self_cpu_time_total / 1e3, evt.count, evt.key))
            continue                    # host ops; their kernels count below
        dev_us = _self_device_us(evt)
        name = next((k for k in KERNEL_NAMES if k in evt.key), None)
        if name is None:
            name = ("copy" if any(w in evt.key.lower()
                                  for w in ("memcpy", "copy", "cat"))
                    else "other")
        fam[name] += dev_us / 1e3
    busy = sum(fam.values())
    out = {"model": cfg.name, "engine": type(eng).__name__,
           "kv_pool": eng.stats["engine"].get("kv_pool"),
           "window_wall_ms": wall_ms, "steps": steps or eng.window,
           "device_ms": fam, "device_busy_ms": busy,
           "idle_share": (1 - busy / wall_ms) if busy else None,
           "collectives_device_ms": collectives,
           "launches_a_step": launches, "queued_after_admission": queued,
           "host_ops": sum(n for _, n, _ in host),
           "host_self_ms_top": [[key, round(ms, 3), n] for ms, n, key
                                in sorted(host, reverse=True)[:8]]}
    _say(f"decode window profile (rung 8, {out['steps']} steps): "
         f"{json.dumps(out)}")
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _bound_ms(nbytes: float, flops: float):
    from repro_torch.hw import H100_SXM
    t_bytes = nbytes / H100_SXM.hbm_bw
    t_ops = flops / H100_SXM.peak_flops_bf16
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _host_us(torch, fns: dict, calls: int) -> dict:
    """Host microseconds per call to issue ``calls`` calls (the best of
    three runs, no synchronisation inside): what a host-bound step pays
    for each launch."""
    out = {}
    for key, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
            torch.cuda.synchronize()
        out[key] = best / calls * 1e6
    return out


def time_k1(torch, kernels, params, cfg, rows: int, embeds: bool = False):
    """All K1 work of one forward at ``rows`` rows: every linear of each
    layer's mixer (attention, RG-LRU or WKV) and MLP, plus the LM head
    (tied or not) over ``min(rows, 8)`` rows (decode reads logits for
    every row, prefill for the last token only), and with ``embeds`` a
    stub frontend's ``frontend_proj`` over the rows (a prefill of
    ``frontend_embeds``)."""
    return time_gemms(torch, kernels,
                      _k1_gemms(torch, params, cfg, rows, embeds))


def _k1_gemms(torch, params, cfg, rows: int, embeds: bool = False,
              ranks=None):
    """The ``(a, b)`` of :func:`time_k1`'s forward.  With ``ranks`` (a
    sharded engine's ``Placed`` parameters), the model row's: a linear
    the specs split over ``model`` once a rank, on the rank's weights,
    else once, on rank 0's; ``params`` is then unused."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    xs = {}                             # one input a contraction width

    def x_of(k):
        if k not in xs:
            xs[k] = torch.randn(rows, k, device="cuda",
                                generator=gen).bfloat16()
        return xs[k]

    head_rows = rows if rows <= 8 else 1
    head = "lm_head" if "lm_head" in (params or ranks.local[0]) else "embed"
    if ranks is not None:
        def split(spec):
            return any(e == "model" or (isinstance(e, tuple) and "model" in e)
                       for e in spec)

        gemms = []
        for i, spec in enumerate(ranks.specs["layers"]):
            for part, name, lin in _decode_linears(spec):
                for t in (ranks.local if split(lin["w"])
                          else ranks.local[:1]):
                    w = t["layers"][i][part][name]["w"]
                    gemms.append((x_of(w.shape[0]), w))
        for t in (ranks.local if split(ranks.specs[head]["table"])
                  else ranks.local[:1]):
            gemms.append((x_of(cfg.d_model)[:head_rows],
                          t[head]["table"].T))
        return gemms
    gemms = []
    if embeds:
        gemms.append((x_of(cfg.frontend_dim), params["frontend_proj"]["w"]))
    for layer in params["layers"]:
        gemms += [(x_of(lin["w"].shape[0]), lin["w"])
                  for part in (layer["mixer"], layer["mlp"])
                  for lin in part.values()
                  if isinstance(lin, dict) and "w" in lin]
    table = params[head]["table"]
    gemms.append((x_of(cfg.d_model)[:head_rows], table.T))
    return gemms


def time_gemms(torch, kernels, gemms):
    """K1 on each ``(a, b)`` of ``gemms`` in turn, beside the plain
    version and ``torch.matmul`` (``_times``), the host microseconds a
    call, and the bound of the bytes and operations of the calls."""
    def run(fn):
        return lambda: [fn(a, b) for a, b in gemms]

    out = _times(torch, {"ms": run(kernels.sisa_matmul),
                         "plain_ms": run(kernels.sisa_gemm_plain),
                         "library_ms": run(torch.matmul)})
    out.update(_host_us(torch, {"host_us": run(kernels.sisa_matmul),
                                "library_host_us": run(torch.matmul)},
                        len(gemms)))
    nbytes = sum(2 * (a.shape[0] * a.shape[1] + b.shape[0] * b.shape[1]
                      + a.shape[0] * b.shape[1]) for a, b in gemms)
    flops = sum(2 * a.shape[0] * a.shape[1] * b.shape[1] for a, b in gemms)
    bound, by = _bound_ms(nbytes, flops)
    return {**out, "bound_ms": bound, "bound_by": by, "gemms": len(gemms),
            "bytes": nbytes, "flops": flops}


def time_k2(torch, kernels, heads=K2_HEADS[0], layers=24, quant=False,
            pos=None, pmax=16, plain=True):
    """One decode step of K2 (a launch a layer) at a row each of ``pos``
    (default: the 8 positions the serve phase ends at), ``pmax`` pages a
    table row: qwen2.5-0.5b's layout (14/2 heads, hd 64, 24 layers)
    unless ``heads``/``layers`` say otherwise, on bf16 pools or
    (``quant``) int8 pools; with the host microseconds a
    ``paged_attention`` call.  ``plain=False`` leaves the plain version
    (thousands of small kernels a call) untimed."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    pos = pos or [n + NEW_TOKENS - 1 for n in PROMPT_LENS]
    q, pk, pv, table, pos_t = _attn_inputs(torch, gen, torch.bfloat16, pos,
                                           n_pages=len(pos) * pmax,
                                           pmax=pmax, heads=heads)
    scales = ()
    if quant:
        pk, pv, *scales = _int8_pools(kernels, pk, pv)

    def run(fn):
        return lambda: [fn(q, pk, pv, table, pos_t, *scales)
                        for _ in range(layers)]

    fns = {"ms": run(kernels.paged_attention)}
    if plain:
        fns["plain_ms"] = run(kernels.paged_attention_plain)
    out = _times(torch, fns)
    out.update(_host_us(torch, {"host_us": run(kernels.paged_attention)},
                        layers))
    h, hkv, hd = heads
    cells = sum(p + 1 for p in pos)              # cells this data attends
    kv_cell = hd + 2 if quant else 2 * hd        # int8 + bf16 scale, or bf16
    per_layer = (2 * cells * hkv * kv_cell       # K and V
                 + 2 * 2 * len(pos) * h * hd     # q in, out
                 + 4 * (table.numel() + len(pos)))
    flops = layers * 4 * cells * h * hd
    bound, by = _bound_ms(layers * per_layer, flops)
    return {**out, "library_ms": None, "bound_ms": bound, "bound_by": by,
            "launches_timed": layers, "heads": list(heads)}


def time_k4(torch, kernels, params, cfg, n_tokens: int, ranks: int = 1):
    """All K4 work of one forward over ``n_tokens`` tokens: up, gate and
    down of every layer (3 launches a layer), each layer's expert sizes
    routed by its own router from random hidden states, at the row
    block and flat size the MoE layer picks for that count.  With
    ``ranks`` > 1, as expert parallelism's ``"psum"`` runs it: each rank
    its ``E / ranks`` local experts (3 launches a layer a rank).  The
    bound counts the weights of the experts that hold rows, the live
    input rows and the whole output; FLOPs count live rows only."""
    from repro_torch.models import moe

    gen = torch.Generator(device="cuda").manual_seed(6)
    d, ff = cfg.d_model, cfg.d_ff
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    el = e // ranks
    cap = moe._capacity(n_tokens, e, k, cfg.moe.capacity_factor)
    bm = kernels.flat_block_rows(min(cap, 64), ff, d, torch.bfloat16)
    m_flat = el * (-(-cap // bm)) * bm
    gids = torch.arange(el, dtype=torch.int32, device="cuda")
    calls, nbytes, flops, live = [], 0, 0, []
    for layer in params["layers"]:
        p = layer["moe"]
        h = torch.randn(n_tokens, d, device="cuda", generator=gen)
        topi = torch.topk(torch.softmax(h @ p["router"], -1), k, -1).indices
        all_sizes = torch.bincount(topi.reshape(-1), minlength=e).clamp(
            max=cap).to(torch.int32)
        x_d = torch.randn(m_flat, d, device="cuda",
                          generator=gen).bfloat16()
        x_ff = torch.randn(m_flat, ff, device="cuda",
                           generator=gen).bfloat16()
        for r in range(ranks):
            sizes = all_sizes[r * el:(r + 1) * el]
            offs = kernels.flat_group_offsets(sizes, bm)
            rows, active = int(sizes.sum()), int((sizes > 0).sum())
            live.append([rows, active])
            for x, w in ((x_d, p["up"]), (x_d, p["gate"]),
                         (x_ff, p["down"])):
                w = w[r * el:(r + 1) * el]
                calls.append((x, w, offs, sizes))
                kk, nn = w.shape[1:]
                nbytes += 2 * (active * kk * nn + rows * kk + m_flat * nn)
                flops += 2 * rows * kk * nn

    def run(fn):
        return lambda: [fn(x, w, offs[:-1], sizes, gids, block_rows=bm)
                        for x, w, offs, sizes in calls]

    library, lib_name = _k4_library(torch, kernels, calls, gids, bm)
    out = _times(torch, {"ms": run(kernels.segment_grouped_gemm),
                         "plain_ms": run(kernels.segment_grouped_gemm_plain),
                         "library_ms": library})
    bound, by = _bound_ms(nbytes, flops)
    return {**out, "bound_ms": bound, "bound_by": by, "library": lib_name,
            "launches_timed": len(calls), "tokens": n_tokens,
            "capacity": cap, "bm": bm, "m_flat": m_flat,
            "rows_and_active_experts_per_layer": live, "bytes": nbytes,
            "flops": flops}


def _k4_library(torch, kernels, calls, gids, bm):
    """One PyTorch call per K4 launch that computes the same products:
    ``torch._grouped_mm`` over each expert's aligned region where this
    PyTorch runs it on these shapes and agrees with the plain version on
    the live rows, else a per-expert ``torch.matmul`` loop.  A
    yardstick only; the port never calls either."""
    x, w, offs, sizes = calls[0]
    live = torch.zeros(x.shape[0], dtype=torch.bool, device="cuda")
    for s, n in zip(offs[:-1].tolist(), sizes.tolist()):
        live[s:s + n] = True
    ref = kernels.segment_grouped_gemm_plain(x, w, offs[:-1], sizes, gids,
                                             block_rows=bm)
    try:
        got = torch._grouped_mm(x, w, offs=offs[1:].contiguous())
        _max_err("torch._grouped_mm", got[live], ref[live], BF16_REL,
                 _f32_atol(ref))
        return (lambda: [torch._grouped_mm(x_, w_, offs=o[1:].contiguous())
                         for x_, w_, o, _ in calls]), "torch._grouped_mm"
    except (AttributeError, RuntimeError, AssertionError) as exc:
        _say(f"k4 library: torch._grouped_mm unusable here ({exc}); "
             "timing a per-expert torch.matmul loop instead")
    segs = [[(s, n, g) for s, n, g in zip(o[:-1].tolist(), sz.tolist(),
                                          range(w_.shape[0])) if n]
            for _, w_, o, sz in calls]

    def loop():
        return [[x_[s:s + n] @ w_[g] for s, n, g in seg]
                for (x_, w_, _, _), seg in zip(calls, segs)]
    return loop, "per-expert torch.matmul loop"


# phi3.5-moe-42b training: 2 of its 32 layers at full width fit one 80 GB
# card with AdamW (about 12 bytes per parameter of weights, gradients and
# f32 moments: 2.87 G parameters, 34 GB, plus one leaf's f32
# temporaries and the activations; PERF.md section 4).
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 8, 256, 6
TRAIN_NEED = ("sisa_gemm", "grouped_gemm", "grouped_gemm_dx", "grouped_dw")


def train_full_width(torch, cfg, need=TRAIN_NEED, seq=TRAIN_SEQ,
                     tokens=None):
    """``Trainer(cfg, TrainerConfig(...)).run()`` for ``TRAIN_STEPS`` steps
    of ``TRAIN_BATCH`` x ``seq`` synthetic tokens (an enc-dec model's
    batch: ``seq`` frames of features and its decoder's tokens, of which
    ``tokens`` a step count in tokens/s), ``remat="none"``, from seeded
    random bf16 weights.  Every launch counter is zeroed just before the
    run; those of ``need`` (by default K1's, K4's forward and dX and
    K5's) must be > 0 just after, and every loss finite."""
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.kernels.grouped_gemm import ROUTE_LAUNCHES
    from repro_torch.models import init_params
    from repro_torch.train import Trainer, TrainerConfig

    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    _say(f"train params: {cfg.name} full width, {cfg.n_layers} layers, "
         f"{n_params / 1e9:.3f} G weights "
         f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated), init "
         f"{time.perf_counter() - t0:.2f} s")
    tcfg = TrainerConfig(steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                         seq_len=seq, remat="none", log_every=1)
    trainer = Trainer(cfg, tcfg, params=params)
    del params
    torch.cuda.reset_peak_memory_stats()
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    ROUTE_LAUNCHES.clear()
    out = trainer.run()
    torch.cuda.synchronize()
    launches = {name: c.n for name, c in LAUNCH_COUNTERS.items()}
    routes = _only_wgmma_routes(launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in out["history"]]
    if len(losses) != TRAIN_STEPS or not all(
            l == l and abs(l) < float("inf") for l in losses):
        raise AssertionError(f"train losses {losses}")
    if any(launches[name] <= 0 for name in need):
        raise AssertionError(f"training skipped a kernel: {launches}")
    step_s = statistics.median(h["dt"] for h in out["history"][1:])
    tokens = tokens or TRAIN_BATCH * seq
    summary = {"model": cfg.name, "layers": cfg.n_layers,
               "params_g": n_params / 1e9, "steps": TRAIN_STEPS,
               "tokens_per_step": tokens, "remat": "none", "losses": losses,
               "first_step_s": out["history"][0]["dt"],
               "median_step_s": step_s, "tokens_per_s": tokens / step_s,
               "peak_memory_gb": peak / 1e9,
               "launches": launches, "wgmma_routes": routes,
               "launches_per_step": {k: v / TRAIN_STEPS
                                     for k, v in launches.items() if v}}
    _say(f"train: {json.dumps(summary)}")
    return trainer, out, launches, summary


def _train_family(key: str) -> str:
    if "grouped_dw" in key:
        return "K5"
    if "grouped_gemm" in key:        # TRANS_B = true: the backward's dX
        return "K4 dX" if "true>" in key else "K4 forward"
    return "K1" if "sisa_gemm" in key else "other"


def profile_train_step(torch, trainer, params, opt_state) -> dict:
    """Where one train step's time goes: device time per family (K1, K4
    forward, K4 dX, K5, optimizer, other) from ``torch.profiler`` against
    the step's wall time.  The optimizer's device time is that of one
    ``apply_updates`` on the step's gradients, profiled alone."""
    from torch.profiler import profile, ProfilerActivity

    from repro_torch.optim import adamw
    from repro_torch.train import loss_and_grads

    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in trainer.data.batch(TRAIN_STEPS).items()}
    trainer.step_fn(params, opt_state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, _ = trainer.step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam = {"K1": 0.0, "K4 forward": 0.0, "K4 dX": 0.0, "K5": 0.0,
           "other": 0.0}
    for evt in prof.key_averages():
        if "CUDA" in str(getattr(evt, "device_type", "")):
            fam[_train_family(evt.key)] += _self_device_us(evt) / 1e3
    busy = sum(fam.values())
    _, _, grads = loss_and_grads(params, trainer.cfg, batch, remat="none")
    fam["optimizer"] = _device_ms(
        torch, lambda: adamw.apply_updates(params, grads, opt_state,
                                           trainer.opt_cfg), iters=1,
        label="optimizer")
    if fam["optimizer"] is None:
        raise AssertionError("torch.profiler recorded no optimizer time")
    fam["other"] -= fam["optimizer"]
    del grads
    out = {"step_wall_ms": wall_ms, "device_ms": fam,
           "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms}
    _say(f"train step profile ({TRAIN_BATCH}x{TRAIN_SEQ} tokens): "
         f"{json.dumps(out)}")
    return out


def time_train_k1(torch, kernels, params, cfg, rows: int):
    """K1's work in one train step at ``rows`` tokens: the forward GEMMs
    (every linear of each layer's mixer and dense MLP, the LM head, tied
    or not, and a stub frontend's ``frontend_proj``; phi3.5-moe's
    experts are K4's) and their backward (dA = dC Bᵀ with B read
    transposed, dB = Aᵀ dC with Aᵀ read in place), as ``sisa_matmul``'s
    backward runs them; beside the backward, ``at_copy_ms``, the time of
    the Aᵀ copies that reading Aᵀ in place saves."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    xs = {}                             # one input a contraction width

    def x_of(k):
        if k not in xs:
            xs[k] = torch.randn(rows, k, device="cuda",
                                generator=gen).bfloat16()
        return xs[k]

    gemms = [(x_of(lin["w"].shape[0]), lin["w"])
             for layer in params["layers"]
             for part in ("mixer", "mlp") if part in layer
             for lin in layer[part].values()
             if isinstance(lin, dict) and "w" in lin]
    table = params["lm_head" if "lm_head" in params else "embed"]["table"]
    gemms.append((x_of(cfg.d_model), table.T))
    if "frontend_proj" in params:
        gemms.append((x_of(cfg.frontend_dim), params["frontend_proj"]["w"]))
    out = time_train_gemms(torch, kernels, gemms, gen)
    _say(f"k1 train step ({cfg.name}, {rows} tokens, {len(gemms)} forward "
         f"GEMMs): {json.dumps(out)}")
    return out


def time_train_gemms(torch, kernels, gemms, gen):
    """K1 on the forward GEMMs ``gemms`` (``(a, b)`` pairs) and on their
    backward (dA = dC Bᵀ, dB = Aᵀ dC on random dC), beside the plain
    version, ``torch.matmul`` and the bound of each pass's bytes and
    operations; beside the backward, ``at_copy_ms``."""
    dcs = [torch.randn(a.shape[0], b.shape[1], device="cuda",
                       generator=gen).bfloat16() for a, b in gemms]

    def fwd(fn):
        return lambda: [fn(a, b) for a, b in gemms]

    def bwd(fn):
        return lambda: [(fn(dc, b.t()), fn(a.t(), dc))
                        for (a, b), dc in zip(gemms, dcs)]

    out = {}
    for label, run in (("fwd", fwd), ("bwd", bwd)):
        fns = {"ms": run(kernels.sisa_matmul),
               "plain_ms": run(kernels.sisa_gemm_plain),
               "library_ms": run(torch.matmul)}
        if label == "bwd":   # what copying each Aᵀ before dB would add
            fns["at_copy_ms"] = lambda: [a.t().contiguous() for a, _ in gemms]
        t = _times(torch, fns)
        mult = 1 if label == "fwd" else 2
        nbytes = mult * sum(2 * (a.numel() + b.numel() + a.shape[0]
                                 * b.shape[1]) for a, b in gemms)
        flops = mult * sum(2 * a.shape[0] * a.shape[1] * b.shape[1]
                           for a, b in gemms)
        bound, by = _bound_ms(nbytes, flops)
        out[label] = {**t, "bound_ms": bound, "bound_by": by,
                      "gemms": mult * len(gemms)}
    return out


def time_train_experts(torch, kernels, params, cfg, n_tokens: int,
                       ranks: int = 1):
    """One train step's K4 forward, K4 dX and K5 work at ``n_tokens``
    tokens: up, gate and down of every layer, each layer's expert sizes
    routed by its own router from random hidden states, at the row block
    and flat size the MoE layer picks; rows outside every segment are 0
    in x and dy, as in the layer.  With ``ranks`` > 1, as ``"psum"``
    expert parallelism runs it: each rank its ``E / ranks`` local
    experts.  Bounds: K4 (forward and dX) reads the live experts'
    weights and live input rows and writes the whole output; K5 reads
    the live rows of x and dy and writes every local expert's dW block;
    FLOPs count live rows."""
    from repro_torch.models import moe

    gen = torch.Generator(device="cuda").manual_seed(9)
    d, ff = cfg.d_model, cfg.d_ff
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    el = e // ranks
    cap = moe._capacity(n_tokens, e, k, cfg.moe.capacity_factor)
    bm = kernels.flat_block_rows(min(cap, 64), ff, d, torch.bfloat16)
    m_flat = el * (-(-cap // bm)) * bm
    gids = torch.arange(el, dtype=torch.int32, device="cuda")
    fwd_calls, dx_calls, dw_calls, live = [], [], [], []
    cost = {"fwd": [0, 0], "dx": [0, 0], "dw": [0, 0]}
    for layer in params["layers"]:
        p = layer["moe"]
        h = torch.randn(n_tokens, d, device="cuda", generator=gen)
        topi = torch.topk(torch.softmax(h @ p["router"], -1), k, -1).indices
        all_sizes = torch.bincount(topi.reshape(-1), minlength=e).clamp(
            max=cap).to(torch.int32)
        for r in range(ranks):
            sizes = all_sizes[r * el:(r + 1) * el]
            offs = kernels.flat_group_offsets(sizes, bm)
            mask = torch.zeros(m_flat, 1, device="cuda")
            for s0, n in zip(offs[:-1].tolist(), sizes.tolist()):
                mask[s0:s0 + n] = 1

            def rand(cols):
                return (torch.randn(m_flat, cols, device="cuda",
                                    generator=gen) * mask).bfloat16()
            x_d, x_ff, dy_d, dy_ff = rand(d), rand(ff), rand(d), rand(ff)
            rows, active = int(sizes.sum()), int((sizes > 0).sum())
            live.append([rows, active])
            for x, dy, w in ((x_d, dy_ff, p["up"]), (x_d, dy_ff, p["gate"]),
                             (x_ff, dy_d, p["down"])):
                w = w[r * el:(r + 1) * el]
                kk, nn = w.shape[1:]
                fwd_calls.append((x, w, offs, sizes))
                dx_calls.append((dy, w.transpose(1, 2), offs, sizes))
                dw_calls.append((x, dy, offs, sizes))
                cost["fwd"][0] += 2 * (active * kk * nn + rows * kk
                                       + m_flat * nn)
                cost["dx"][0] += 2 * (active * kk * nn + rows * nn
                                      + m_flat * kk)
                cost["dw"][0] += 2 * (rows * kk + rows * nn + el * kk * nn)
                for key in cost:
                    cost[key][1] += 2 * rows * kk * nn

    def run_k4(fn, calls):
        return lambda: [fn(a, w, offs[:-1], sizes, gids, block_rows=bm)
                        for a, w, offs, sizes in calls]

    def run_dw(fn):
        return lambda: [fn(x, dy, offs[:-1], sizes, gids, el)
                        for x, dy, offs, sizes in dw_calls]

    # K5 as the backward runs it: on the tile table the forward built
    # (here built once, outside the timed calls).
    from repro_torch.kernels.grouped_gemm import _launch_dw, _tile_metadata
    metas = [_tile_metadata(offs[:-1], sizes, gids, m_flat // bm, bm)
             for _, _, offs, sizes in dw_calls]

    def run_k5():
        return [_launch_dw(x, dy, meta, bm, el)
                for (x, dy, _, _), meta in zip(dw_calls, metas)]

    k4 = {}
    for key, calls in (("fwd", fwd_calls), ("dx", dx_calls)):
        library, lib_name = _k4_library(torch, kernels, calls, gids, bm)
        k4[key] = _times(torch, {
            "ms": run_k4(kernels.segment_grouped_gemm, calls),
            "plain_ms": run_k4(kernels.segment_grouped_gemm_plain, calls),
            "library_ms": library})
        k4[key].update(zip(("bound_ms", "bound_by"), _bound_ms(*cost[key])))
        k4[key]["library"] = lib_name
    library, lib_name = _k5_library(torch, kernels, dw_calls, gids, el)
    dw = _times(torch, {"ms": run_k5,
                        "plain_ms": run_dw(kernels.segment_grouped_dw_plain),
                        "library_ms": library})
    dw.update(zip(("bound_ms", "bound_by"), _bound_ms(*cost["dw"])))
    dw["library"] = lib_name
    common = {"launches_timed": len(dw_calls), "tokens": n_tokens,
              "ranks": ranks, "capacity": cap, "bm": bm, "m_flat": m_flat,
              "rows_and_active_experts_per_layer": live}
    out = {f"k4_{key}": {**k4[key], **common, "bytes": cost[key][0],
                         "flops": cost[key][1]} for key in k4}
    out["k5"] = {**dw, **common, "bytes": cost["dw"][0],
                 "flops": cost["dw"][1]}
    _say(f"k4 forward, train step ({n_tokens} tokens, {len(fwd_calls)} "
         f"launches): {json.dumps(out['k4_fwd'])}")
    _say(f"k4 dX, train step ({n_tokens} tokens, {len(dx_calls)} launches): "
         f"{json.dumps(out['k4_dx'])}")
    _say(f"k5, train step ({n_tokens} tokens, {len(dw_calls)} launches): "
         f"{json.dumps(out['k5'])}")
    return out


def _k5_library(torch, kernels, calls, gids, e):
    """One PyTorch call per K5 launch that computes the same dW:
    ``torch._grouped_mm`` of xᵀ and dy grouped along the contraction
    (2-D x 2-D, each expert's aligned region one group; rows outside
    every segment are 0), where this PyTorch runs it and agrees with the
    plain version, else a per-expert ``torch.matmul`` loop.  A yardstick
    only; the port never calls either."""
    x, dy, offs, sizes = calls[0]
    ref = kernels.segment_grouped_dw_plain(x, dy, offs[:-1], sizes, gids, e)
    try:
        got = torch._grouped_mm(x.t(), dy, offs=offs[1:].contiguous())
        _max_err("torch._grouped_mm (dW)", got, ref, BF16_REL,
                 _f32_atol(ref))
        return (lambda: [torch._grouped_mm(x_.t(), dy_,
                                           offs=o[1:].contiguous())
                         for x_, dy_, o, _ in calls]), "torch._grouped_mm"
    except (AttributeError, RuntimeError, AssertionError) as exc:
        _say(f"k5 library: torch._grouped_mm unusable here ({exc}); timing "
             "a per-expert torch.matmul loop instead")
    segs = [[(s, n, g) for s, n, g in zip(o[:-1].tolist(), sz.tolist(),
                                          range(e))]
            for _, _, o, sz in calls]

    def loop():
        return [[x_[s:s + n].t() @ dy_[s:s + n] for s, n, g in seg]
                for (x_, dy_, _, _), seg in zip(calls, segs)]
    return loop, "per-expert torch.matmul loop"


# Training at full width on the models of the fifteenth slice, each freed
# before the next: recurrentgemma-2b at 6 of 26 layers (two pattern
# periods) and rwkv6-3b at 8 of 32 (since phase 20 joined, for the
# script's time; at full depth they took 51.3 and 76.2 s, at 13 and 16
# layers 31.1 and 43.0), and internvl2-76b at 1 of its
# 80 layers (about 2.98 G parameters, its two 128,256-row tables the most
# of them), its batches with frontend_embeds.  With AdamW's f32 moments
# that is about 12 bytes a parameter, plus the activations of
# remat="none" (at full depth the peaks were 54.05, 57.19 and 45.47 GB on
# an H100 80GB HBM3 at 700 W; PERF.md).
FULL_TRAIN = (("recurrentgemma-2b", 6), ("rwkv6-3b", 8),
              ("internvl2-76b", 1))


def _scans_ms(torch, cfg, rows: int) -> dict:
    """The device time of one train step's recurrences alone, forward and
    backward, at ``rows`` = ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens: the
    RG-LRU doubling scan (``rglru._scan``) of every RG-LRU layer on
    float32 decays and inputs, and the WKV chunk scan
    (``rwkv6._chunk_scan``) of every WKV layer on bf16 r, k, v and
    float32 log-decays at the bound; none for a model of neither."""
    from repro_torch.models import rglru, rwkv6

    kinds = cfg.layer_kinds()
    n_rg, n_wkv = kinds.count("rglru"), kinds.count("wkv")
    if not n_rg + n_wkv:
        return {"ms": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(9)
    b, s, d = TRAIN_BATCH, rows // TRAIN_BATCH, cfg.d_model

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    if n_rg:
        a = torch.rand(b, s, d, device="cuda",
                       generator=gen).requires_grad_()
        x, dh = rand(b, s, d).requires_grad_(), rand(b, s, d)
    if n_wkv:
        h, hd = rwkv6.rwkv_head_dims(cfg)
        rkv = [(rand(b, s, h, hd, dtype=torch.bfloat16) * 0.1
                ).requires_grad_() for _ in range(3)]
        wlog = (-(1e-4 + 1.4 * torch.rand(b, s, h, hd, device="cuda",
                                          generator=gen))).requires_grad_()
        u, dy = rand(h, hd).requires_grad_(), rand(b, s, h, hd)
        s0 = torch.zeros(b, h, hd, hd, device="cuda")

    def run():
        for _ in range(n_rg):
            rglru._scan(a, x).backward(dh)
        for _ in range(n_wkv):
            rwkv6._chunk_scan(*rkv, wlog, u, s0)[0].backward(dy)

    return _times(torch, {"ms": run})


def profile_train_phases(torch, trainer, params, opt_state) -> dict:
    """Where one train step's time goes, its parts run one after another
    under ``torch.profiler``: the forward (``forward_train``), the
    backward (``torch.autograd.grad``) and the optimizer
    (``apply_updates``): K1's device time in the forward and in the
    backward (kernels named ``sisa_gemm``), the optimizer's, the
    recurrences' (forward and backward, profiled alone at the step's
    shapes by :func:`_scans_ms`), the rest (other), and the idle share
    of the three parts' wall time.  K1's launches in the forward and in the
    backward are read from its counter, zeroed before each part."""
    from torch.profiler import profile, ProfilerActivity

    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.models import forward_train
    from repro_torch.optim import adamw

    cfg = trainer.cfg
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in trainer.data.batch(TRAIN_STEPS).items()}
    trainer.step_fn(params, opt_state, batch)
    torch.cuda.synchronize()
    walls, k1, rest, k1_launches = {}, {}, {}, {}

    def part(label, fn):
        for counter in LAUNCH_COUNTERS.values():
            counter.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            walls[label] = (time.perf_counter() - t0) * 1e3
        k1_launches[label] = LAUNCH_COUNTERS["sisa_gemm"].n
        k1[label] = rest[label] = 0.0
        for evt in prof.key_averages():
            if "CUDA" in str(getattr(evt, "device_type", "")):
                fam = k1 if "sisa_gemm" in evt.key else rest
                fam[label] += _self_device_us(evt) / 1e3
        return res

    leaves = list(_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, _ = part("forward", lambda: forward_train(
            params, cfg, batch, remat=trainer.tcfg.remat))
        grads = part("backward", lambda: torch.autograd.grad(
            loss, leaves, allow_unused=True))
    finally:
        for t in leaves:
            t.requires_grad_(False)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    grads = _tree_map(lambda _: next(it), params)
    part("optimizer", lambda: adamw.apply_updates(params, grads, opt_state,
                                                  trainer.opt_cfg))
    del grads, loss
    scans = _scans_ms(torch, cfg, TRAIN_BATCH * TRAIN_SEQ)
    wall = sum(walls.values())
    fam = {"K1 forward": k1["forward"], "K1 backward": k1["backward"],
           "optimizer": k1["optimizer"] + rest["optimizer"],
           # the profiler's kernel sum: the queued time of these many
           # small launches still holds launch gaps
           "scans": scans.get("ms_profiler") or scans["ms"]}
    busy = sum(k1.values()) + sum(rest.values())
    fam["other"] = busy - sum(fam.values())
    out = {"model": cfg.name, "step_wall_ms": wall, "part_wall_ms": walls,
           "device_ms": fam, "device_busy_ms": busy,
           "idle_share": 1 - busy / wall, "k1_launches": k1_launches,
           "scans": scans}
    if min(k1_launches["forward"], k1_launches["backward"]) <= 0:
        raise AssertionError(f"{cfg.name} train step: K1 launches "
                             f"{k1_launches}")
    _say(f"train step profile ({cfg.name}, {trainer.tcfg.global_batch}x"
         f"{trainer.tcfg.seq_len} batch; scans timed alone): "
         f"{json.dumps(out)}")
    return out


def train_model(torch, kernels, name: str, layers: int) -> dict:
    """``name`` at full width and ``layers`` layers through
    ``train_full_width`` (K1 > 0, every K1 launch on the wgmma route,
    finite losses; a model with a frontend trains on batches with
    ``frontend_embeds``); one profiled step (``profile_train_phases``),
    whose K1 launches, forward and backward, times ``TRAIN_STEPS`` must
    be the run's; and K1's times for one step's forward and backward
    (``time_train_k1``)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(name), n_layers=layers)
    trainer, out, launches, summary = train_full_width(
        torch, cfg, need=("sisa_gemm",))
    _k1_wgmma_only(launches)
    if (cfg.frontend is not None) != ("frontend_embeds"
                                      in trainer.data.batch(0)):
        raise AssertionError(f"{name}: frontend_embeds in the batches?")
    params, opt_state = out["params"], out["opt_state"]
    del out
    prof = profile_train_phases(torch, trainer, params, opt_state)
    per_step = prof["k1_launches"]["forward"] \
        + prof["k1_launches"]["backward"]
    if launches["sisa_gemm"] != TRAIN_STEPS * per_step:
        raise AssertionError(f"{name}: {launches['sisa_gemm']} K1 launches "
                             f"in {TRAIN_STEPS} steps of {per_step}")
    del opt_state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    k1 = time_train_k1(torch, kernels, params, cfg,
                       rows=TRAIN_BATCH * TRAIN_SEQ)
    return {"summary": summary, "profile": prof, "k1": k1}


# ---------------------------------------------------------------------------
# The fourth slice: K2 on int8 pools, K3 (split-K), K6 (co-execution) and
# K7 (the capacity MoE GEMM).
# ---------------------------------------------------------------------------
def _drive(torch, name, fn) -> int:
    """Run ``fn`` (a path through kernel ``name``'s entry point) once
    with every launch counter zeroed just before; the kernel's count
    just after, which must be > 0."""
    from repro_torch.kernels import LAUNCH_COUNTERS
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    fn()
    torch.cuda.synchronize()
    n = LAUNCH_COUNTERS[name].n
    if n <= 0:
        raise AssertionError(f"{name}: its path launched it no time")
    return n


def _int8_pools(kernels, pk, pv):
    (pk8, pks), (pv8, pvs) = (kernels.quantize_page_pool(pk),
                              kernels.quantize_page_pool(pv))
    return pk8, pv8, pks, pvs


def check_k2_int8(torch, kernels, gen) -> float:
    """K2 on int8 pools made by ``quantize_page_pool``, against its plain
    version, at the cases of :func:`_k2_cases`."""
    worst, edges = _k2_cases(torch, kernels, gen, quant=True)
    _say(f"k2 int8: GQA 14/2 hd 64, GQA 32/8 hd 128, GQA 4/1 hd 256, GQA "
         f"64/8 hd 128 and GQA 8/8 hd 64, psz 16 on 16-page tables, and "
         f"GQA 8/8 hd 64 at psz 16 and 32 on {WHISPER_PMAX}-page tables, "
         f"int8 pools with bf16 scale planes, q in f32 and bf16, split "
         f"edges at cells "
         f"{edges}, pos 0, full rows and sink entries, agree with the plain "
         f"version (max abs err {worst}; elementwise tol f32 1e-5, bf16 "
         f"2^-7*|ref| + 1e-5)")
    return worst


# K3 at qwen's decode GEMV shapes (M 8 and 16; K x N) at the slab depths
# of K3_SLABS (clusters of 7, 4 and 2 at K 896, 8 and 4 at K 4864); K 896
# in slabs of 256 is the timed decode step's setup, 3.5 slabs, the last
# rank's run cut at K.  Then one-stage slabs, a cut last slab at K 4864
# (slabs of 384), three taller passes on K1's normal tiles; then ragged
# edges and slabs that are not whole stages, which take the CUDA-core
# route.
K3_SHAPES = ((896, 896), (896, 128), (896, 4864), (4864, 896))
K3_SLABS = {896: (128, 256, 448), 4864: (256, 1216)}
K3_BK = 256                     # slab depth of the timed decode step


def check_k3(torch, kernels, gen) -> float:
    sg = sys.modules["repro_torch.kernels.sisa_gemm"]
    worst, n_cases, timed_setup = 0.0, 0, 0
    clusters = set()
    for dtype in (torch.float32, torch.bfloat16):
        rel = 0.0 if dtype == torch.float32 else BF16_REL
        cases = [(m, k, n, bk) for m in (8, 16) for k, n in K3_SHAPES
                 for bk in K3_SLABS[k]]
        cases += [(8, 896, 896, 64), (8, 4864, 896, 384),
                  (40, 896, 896, 128), (40, 896, 4864, 256),
                  (130, 4864, 896, 256)]
        ragged = [(13, 904, 1000, 200), (13, 900, 1000, 256)]
        for m, k, n, bk in cases + ragged:
            a = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
            b = (torch.randn(k, n, device="cuda", generator=gen)
                 / k ** 0.5).to(dtype)
            cfg = kernels.BlockConfig(
                kernels.choose_block_config(m, n, k).bm, bk=bk)
            ref = kernels.sisa_gemm_splitk_plain(a, b, bk).sum(0).to(dtype)
            before = (sg.SPLITK_LAUNCHES.n, sg.SPLITK_CORE_LAUNCHES.n)
            got = kernels.sisa_gemm_splitk(a, b, cfg)
            wgmma = sg.SPLITK_LAUNCHES.n - before[0]
            core = sg.SPLITK_CORE_LAUNCHES.n - before[1]
            want = dtype == torch.bfloat16 and (m, k, n, bk) in cases
            if (wgmma, core) != (int(want), int(not want)):
                raise AssertionError(f"K3 {dtype} M={m} K={k} N={n} bk={bk}: "
                                     f"{wgmma} wgmma and {core} CUDA-core "
                                     f"launches")
            if wgmma:
                plan = kernels.k3_plan(m, n, k, bk)
                clusters.add(plan.cluster)
                slices = sg.plan_k_slices(plan, k)
                if (k, bk) == (896, K3_BK) and m <= 16:
                    # The timed step's setup: 4 ranks, the last one's run
                    # cut to K's last 2 of its 4 stages.
                    if plan.cluster != 4 or slices[-1] != (768, 896):
                        raise AssertionError(f"K3 M={m} N={n}: plan {plan}")
                    timed_setup += 1
            worst = max(worst, _max_err(
                f"K3 {dtype} M={m} K={k} N={n} bk={bk}", got, ref, rel,
                _f32_atol(ref)))
            n_cases += 1
    if timed_setup != 6:
        raise AssertionError(f"K3: {timed_setup} wgmma cases at K 896 in "
                             f"slabs of {K3_BK}, not 6")
    _say(f"k3: {n_cases} cases (M 8 and 16 at qwen's decode GEMV shapes at "
         f"the slab depths {K3_SLABS}, among them the timed step's K 896 in "
         f"slabs of {K3_BK} on clusters of 4 with the last run cut at K; "
         f"one-stage slabs, a cut last slab at K 4864, M 40 and 130 on "
         f"normal tiles; ragged M/N/K and slab tails on the CUDA-core route; "
         f"f32 and bf16) agree with the plain version (max abs err {worst}; "
         f"elementwise tol f32 2e-5*max|ref|, bf16 2^-7*|ref| + "
         f"2e-5*max|ref|); bf16 wgmma launches at clusters "
         f"{sorted(clusters)}")
    return worst


# K7 at phi3.5-moe-42b's expert shapes, with the decode capacity (2 rows
# an expert at rung 8), a ragged one and the 2,048-token training
# capacity (320).
K7_CAPS = (2, 37, 320)


def check_k7(torch, kernels, gen) -> float:
    worst, n_cases = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        rel = 0.0 if dtype == torch.float32 else BF16_REL
        shapes = [(MOE_E, c, d, f) for d, f in ((MOE_D, MOE_FF),
                                                (MOE_FF, MOE_D))
                  for c in K7_CAPS] + [(3, 5, 36, 70)]
        for e, c, d, f in shapes:
            x = torch.randn(e, c, d, device="cuda", generator=gen).to(dtype)
            w = (torch.randn(e, d, f, device="cuda", generator=gen)
                 / d ** 0.5).to(dtype)
            ref = kernels.moe_grouped_gemm_plain(x, w)
            worst = max(worst, _max_err(
                f"K7 {dtype} E={e} C={c} d={d} f={f}",
                kernels.moe_grouped_gemm(x, w), ref, rel, _f32_atol(ref)))
            n_cases += 1
            del x, w, ref
    _say(f"k7: {n_cases} cases (E 16, d 4096 -> 6400 and back, C in "
         f"{K7_CAPS}; a ragged C/d/f; f32 and bf16) agree with the plain "
         f"version (max abs err {worst}; elementwise tol f32 2e-5*max|ref|, "
         f"bf16 2^-7*|ref| + 2e-5*max|ref|)")
    return worst


def _k6_scenarios():
    """The four tenant sets of ``benchmarks/multi_tenant_bench.py::
    _scenarios`` at their full sizes, on Qwen2.5-0.5B's Table 2 widths:
    (m, n, k) per tenant (the LM head is shared and batchable, so
    left out)."""
    from repro_torch.core import TABLE2

    layers = [ly for ly in TABLE2["Qwen2.5-0.5B"].layers
              if ly.name != "lm_head"]
    return {
        "decode_batch": [(4, ly.n, ly.k) for _ in range(16) for ly in layers],
        "narrow_proj": [(8, 128, 896)] * 32,
        "moe_dispatch": [(m, 4864, 896) for m in
                         (3, 16, 1, 9, 12, 2, 16, 5, 7, 1, 14, 4, 10, 6, 2,
                          8)],
        "mixed_serving": [(16, ly.n, ly.k) for ly in layers]
        + [(s, ly.n, ly.k) for s in (12, 40, 100, 150) for ly in layers],
    }


def _k6_case(torch, kernels, gen, shapes, dtype):
    """Operands and the plan of one scenario, its tasks in the packer's
    placement order (``coexec_tile_sequence(pack_requests(...))``)."""
    from repro_torch.core import coexec_tile_sequence, pack_requests
    from repro_torch.core.multi import GemmRequest

    reqs = [GemmRequest(rid=i, m=m, n=n, k=k)
            for i, (m, n, k) in enumerate(shapes)]
    order = coexec_tile_sequence(pack_requests(reqs),
                                 rids=[r.rid for r in reqs])
    xs = [torch.randn(m, k, device="cuda", generator=gen).to(dtype)
          for m, n, k in shapes]
    ws = [(torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5)
          .to(dtype) for m, n, k in shapes]
    tenants = [kernels.CoexecTenant(rid=i, m=m, n=n, k=k)
               for i, (m, n, k) in enumerate(shapes)]
    plan = kernels.build_coexec_plan(tenants, dtype, order=order,
                                     device="cuda")
    return xs, ws, plan, order


def _k6_column(plan, field: str):
    """One field of a bf16 plan's CTA rows (``k6_plan``)."""
    co = sys.modules["repro_torch.kernels.coexec"]
    return plan.groups[:, co.K6_FIELDS.index(field)]


def _k6_groups(plan) -> int:
    """Tile groups of a plan's bf16 CTA rows: rank-0 rows."""
    return int((_k6_column(plan, "rank") == 0).sum())


def _k6_widths(plan):
    """The wgmma widths of a plan's bf16 CTA rows."""
    return sorted(set(_k6_column(plan, "width").tolist()))


def check_k6(torch, kernels, gen) -> float:
    """K6 on each scenario in f32 and bf16: the fused launch against its
    plain version, the rows past each tenant's m (inside its blocks)
    exactly 0, and fused equal to ``sequential_matmul`` bit for bit."""
    worst = 0.0
    for name, shapes in _k6_scenarios().items():
        for dtype in (torch.float32, torch.bfloat16):
            xs, ws, plan, _ = _k6_case(torch, kernels, gen, shapes, dtype)
            a, b = kernels.pack_operands(plan, xs, ws)
            out = kernels.run_plan(plan, a, b)
            ref = kernels.run_plan_plain(plan, a, b)
            rel = 0.0 if dtype == torch.float32 else BF16_REL
            worst = max(worst, _max_err(f"K6 {name} {dtype}", out, ref, rel,
                                        _f32_atol(ref)))
            for off, t in zip(plan.row_offsets, plan.tenants):
                end = off + -(-t.m // plan.bm) * plan.bm
                cols = -(-t.n // plan.bn) * plan.bn
                if torch.count_nonzero(out[off + t.m:end, :cols]):
                    raise AssertionError(f"K6 {name} {dtype}: padding rows "
                                         f"of tenant {t.rid} not 0")
            del a, b, ref
            fused = kernels.unpack_outputs(plan, out)
            serial = kernels.sequential_matmul(xs, ws, plan=plan)
            bad = [i for i, (f, s_) in enumerate(zip(fused, serial))
                   if not torch.equal(f, s_)]
            if bad:
                raise AssertionError(f"K6 {name} {dtype}: fused differs from "
                                     f"sequential for tenants {bad}")
            where = (f"{_k6_groups(plan)} tile groups of widths "
                     f"{_k6_widths(plan)} on {len(plan.groups)} CTAs "
                     f"(clusters of {plan.k6_cluster})"
                     if plan.groups is not None else "one block a task")
            _say(f"k6 {name} {dtype}: {len(shapes)} tenants, "
                 f"{plan.n_tasks} tasks (bm {plan.bm}), {where}; fused == "
                 f"sequential bit for bit")
            del xs, ws, out, fused, serial
    _say(f"k6: 4 scenarios x f32/bf16 agree with the plain version (max abs "
         f"err {worst}; elementwise tol f32 2e-5*max|ref|, bf16 2^-7*|ref| + "
         f"2e-5*max|ref|); padding rows exactly 0")
    return worst


def serve_int8(torch, np, kernels, cfg, params, flt_eng, flt_outs):
    """The 8-request serve on int8 page pools: K2's int8 variant (and
    not its float one) on every decode step, the pools' resident bytes
    (hd + 2) / (2 hd) of the bf16 serve's, and one K2 launch on the
    serve's own pools after its last window against the plain
    version."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    eng, _, launches, outs = serve_full_width(
        torch, np, cfg, ("sisa_gemm", "paged_attn_int8"), params=params,
        kv_quant="int8")
    if launches["paged_attn"]:
        raise AssertionError(f"int8 serve launched float K2: {launches}")
    table = eng.cache.table.numel() * eng.cache.table.element_size()
    q8, flt = (e.cache.resident_bytes() - table for e in (eng, flt_eng))
    hd = cfg.resolved_head_dim
    if q8 * 2 * hd != flt * (hd + 2):
        raise AssertionError(f"int8 pools {q8} B vs bf16 pools {flt} B: not "
                             f"(hd + 2) / (2 hd)")
    differ = sum(a.tokens != b.tokens for a, b in zip(outs, flt_outs))
    profile_window(torch, np, eng, cfg)
    pools = {k: v[0] for k, v in eng.cache.pools.items()}
    n_pages = pools["pk"].shape[0] - 1
    pos = [0, 15, 16, 31, 32, 127, 128, 255]
    pmax = eng.cache.max_pages_per_slot
    pages = torch.randperm(n_pages, device="cuda", generator=gen)
    tbl = pages[:len(pos) * pmax].reshape(len(pos), pmax).to(torch.int32)
    q = torch.randn(len(pos), cfg.n_heads, hd, device="cuda",
                    generator=gen).bfloat16()
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    args = (q, pools["pk"], pools["pv"], tbl, pos_t, pools["pk_s"],
            pools["pv_s"])
    err = _max_err("K2 int8 on the serve's pools",
                   kernels.paged_attention(*args),
                   kernels.paged_attention_plain(*args), BF16_REL, 1e-5)
    out = {"resident_bytes_int8_pools": q8, "resident_bytes_bf16_pools": flt,
           "ratio": q8 / flt, "expected": (hd + 2) / (2 * hd),
           "completions_differing_from_bf16_pools": differ,
           "of": len(outs), "serve_pool_check_max_abs_err": err}
    _say(f"int8 serve: {json.dumps(out)}")
    return eng, launches, err


def serve_coexec(torch, np, cfg, params):
    """16 requests on 8 slots, so the queue is non-empty at window
    boundaries, with and without ``coexec_backend="kernel"``: the
    co-scheduled prefills run as backfill, the tokens do not change.
    Returns the launches, and the co-executed serve's completions and
    co-execution stats (phase 21's meshless reference)."""
    lens = PROMPT_LENS + PROMPT_LENS[::-1]
    need = ("sisa_gemm", "paged_attn")
    # Without co-execution the multi-tenant plan only fills stats that
    # nothing here reads (its host-side simulation is most of a serve's
    # wall), and the tokens do not depend on it.
    eng0, _, _, plain = serve_full_width(torch, np, cfg, need, params=params,
                                         lens=lens, multi_tenant=False)
    del eng0
    eng, _, launches, outs = serve_full_width(
        torch, np, cfg, need, params=params, lens=lens,
        coexec_backend="kernel")
    if [c.tokens for c in outs] != [c.tokens for c in plain]:
        raise AssertionError("coexec serve tokens differ from the serve "
                             "without co-execution")
    st = eng.stats
    if st["backfilled"] <= 0 or not st["coexec_tiles"]:
        raise AssertionError(f"no backfill: backfilled {st['backfilled']}, "
                             f"coexec_tiles {st['coexec_tiles']}")
    _say(f"coexec serve: {len(outs)} requests token-identical to the serve "
         f"without co-execution; backfilled {st['backfilled']}, packed "
         f"prefills {st['packed_prefills']}, coexec_tiles "
         f"{st['coexec_tiles']}, coexec_interleave "
         f"{st['coexec_interleave']}")
    return launches, outs, {k: st[k] for k in COEXEC_STATS}


COEXEC_STATS = ("backfilled", "packed_prefills", "coexec_tiles",
                "coexec_interleave", "batches")


def time_k2_int8(torch, kernels, heads=K2_HEADS[0], layers=24,
                 plain=True):
    """:func:`time_k2` on int8 pools (``quantize_page_pool``)."""
    return time_k2(torch, kernels, heads, layers, quant=True, plain=plain)


def time_k3(torch, kernels, params, cfg, rows: int = 8):
    """K3 on one qwen2.5-0.5b decode step's projections (7 a layer x 24,
    rung 8), slabs of ``K3_BK``; its path run is one such step, which
    must take the wgmma route only: one launch a GEMM (the partials'
    route added a sum and a cast to each)."""
    sg = sys.modules["repro_torch.kernels.sisa_gemm"]
    gen = torch.Generator(device="cuda").manual_seed(10)
    xs = {}                                     # one activation per K

    def act(w):
        if w.shape[0] not in xs:
            xs[w.shape[0]] = torch.randn(rows, w.shape[0], device="cuda",
                                         generator=gen).bfloat16()
        return xs[w.shape[0]], w

    gemms = [act(layer[part][n]["w"]) for layer in params["layers"]
             for part, n in (("mixer", "q"), ("mixer", "k"), ("mixer", "v"),
                             ("mixer", "o"), ("mlp", "gate"), ("mlp", "up"),
                             ("mlp", "down"))]
    cfg = kernels.BlockConfig(kernels.choose_block_config(rows, 0, 0).bm,
                              bk=K3_BK)

    def run(fn):
        return lambda: [fn(a, b) for a, b in gemms]

    def plain(a, b):
        return kernels.sisa_gemm_splitk_plain(a, b, K3_BK).sum(0).to(a.dtype)

    step = run(lambda a, b: kernels.sisa_gemm_splitk(a, b, cfg))
    launches = _drive(torch, "sisa_gemm_splitk", step)
    if launches != len(gemms) or sg.SPLITK_CORE_LAUNCHES.n:
        raise AssertionError(f"K3's decode step: {launches} wgmma and "
                             f"{sg.SPLITK_CORE_LAUNCHES.n} CUDA-core launches "
                             f"for {len(gemms)} GEMMs")
    out = _times(torch, {"ms": step, "plain_ms": run(plain),
                         "library_ms": run(torch.matmul)})
    nbytes = sum(2 * (a.numel() + b.numel() + a.shape[0] * b.shape[1])
                 for a, b in gemms)
    flops = sum(2 * a.shape[0] * a.shape[1] * b.shape[1] for a, b in gemms)
    bound, by = _bound_ms(nbytes, flops)
    return {**out, "bound_ms": bound, "bound_by": by, "gemms": len(gemms),
            "bk": K3_BK, "launches": launches,
            "clusters": sorted({kernels.k3_plan(a.shape[0], b.shape[1],
                                                a.shape[1], K3_BK).cluster
                                for a, b in gemms})}


def time_k7(torch, kernels, cap: int):
    """K7 at phi3.5-moe-42b's expert shapes (E 16, up and gate 4096 ->
    6400, down 6400 -> 4096; random bf16 weights) at capacity ``cap``;
    its path run is those 3 launches."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    w_in = [(torch.randn(MOE_E, MOE_D, MOE_FF, device="cuda", generator=gen)
             / MOE_D ** 0.5).bfloat16() for _ in range(2)]
    w_dn = (torch.randn(MOE_E, MOE_FF, MOE_D, device="cuda", generator=gen)
            / MOE_FF ** 0.5).bfloat16()
    x_d = torch.randn(MOE_E, cap, MOE_D, device="cuda",
                      generator=gen).bfloat16()
    x_ff = torch.randn(MOE_E, cap, MOE_FF, device="cuda",
                       generator=gen).bfloat16()
    calls = [(x_d, w_in[0]), (x_d, w_in[1]), (x_ff, w_dn)]

    def run(fn):
        return lambda: [fn(x, w) for x, w in calls]

    launches = _drive(torch, "moe_gemm", run(kernels.moe_grouped_gemm))
    out = _times(torch, {"ms": run(kernels.moe_grouped_gemm),
                         "plain_ms": run(kernels.moe_grouped_gemm_plain),
                         "library_ms": run(torch.bmm)})
    nbytes = sum(2 * (x.numel() + w.numel() + x.shape[0] * x.shape[1]
                      * w.shape[2]) for x, w in calls)
    flops = sum(2 * x.shape[0] * x.shape[1] * x.shape[2] * w.shape[2]
                for x, w in calls)
    bound, by = _bound_ms(nbytes, flops)
    return {**out, "bound_ms": bound, "bound_by": by, "capacity": cap,
            "launches": launches}


def _k6_library(torch, kernels, plan, a, b, ref):
    """``torch._grouped_mm`` on the flat A with the tenants' row
    offsets, where this PyTorch runs it and agrees with the plain
    version, else a per-tenant ``torch.matmul`` loop.  A yardstick only;
    the port never calls either."""
    ends = torch.tensor(list(plan.row_offsets[1:]) + [plan.m_flat],
                        dtype=torch.int32, device="cuda")
    try:
        got = torch._grouped_mm(a, b, offs=ends)
        for g, r in zip(kernels.unpack_outputs(plan, got),
                        kernels.unpack_outputs(plan, ref)):
            _max_err("torch._grouped_mm (K6)", g, r, BF16_REL,
                     _f32_atol(ref))
        return (lambda: torch._grouped_mm(a, b, offs=ends)), \
            "torch._grouped_mm"
    except (AttributeError, RuntimeError, AssertionError) as exc:
        _say(f"k6 library: torch._grouped_mm unusable here ({exc}); timing "
             "a per-tenant torch.matmul loop instead")
    spans = [(off, t.m, t.k, t.n, i) for i, (off, t) in
             enumerate(zip(plan.row_offsets, plan.tenants))]
    return (lambda: [a[o:o + m, :k] @ b[i, :k, :n]
                     for o, m, k, n, i in spans]), "per-tenant torch.matmul"


def time_k6(torch, kernels, name: str, dtype, plain: bool):
    """One scenario's placement: K6's one launch on pre-packed operands
    (``run_plan``) against ``sequential_matmul``'s T launches (each on
    its own pre-packed single-tenant operands), the plain version
    (``plain``) and the library yardstick.  The bound counts the live
    bytes (each tenant's A, weight and C once, not the padded stack)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    shapes = _k6_scenarios()[name]
    xs, ws, plan, _ = _k6_case(torch, kernels, gen, shapes, dtype)
    a, b = kernels.pack_operands(plan, xs, ws)
    singles = kernels.single_tenant_plans(plan, dtype)
    packed = [kernels.pack_operands(sp, [x], [w])
              for sp, x, w in zip(singles, xs, ws)]
    del xs, ws
    fns = {"ms": lambda: kernels.run_plan(plan, a, b),
           "sequential_ms": lambda: [kernels.run_plan(sp, a_, b_) for sp,
                                     (a_, b_) in zip(singles, packed)]}
    if plain:
        fns["plain_ms"] = lambda: kernels.run_plan_plain(plan, a, b)
    lib, lib_name = (None, None)
    if dtype == torch.bfloat16:
        lib, lib_name = _k6_library(torch, kernels, plan, a, b,
                                    kernels.run_plan_plain(plan, a, b))
        fns["library_ms"] = lib
    out = _times(torch, fns)
    size = a.element_size()
    nbytes = sum(size * (m * k + k * n + m * n) for m, n, k in shapes)
    flops = sum(2 * m * n * k for m, n, k in shapes)
    bound, by = _bound_ms(nbytes, flops)
    return {**out, "library_ms": out.get("library_ms"), "library": lib_name,
            "plain_ms": out.get("plain_ms"), "bound_ms": bound,
            "bound_by": by, "scenario": name,
            "dtype": str(dtype).replace("torch.", ""),
            "tenants": len(shapes), "tasks": plan.n_tasks, "bm": plan.bm,
            "live_bytes": nbytes, "flops": flops,
            **({"groups": _k6_groups(plan), "ctas": len(plan.groups)}
               if plan.groups is not None else {})}


def drive_k6(torch, kernels):
    """K6's path: ``coexec_matmul`` on the packer's placement of each
    scenario (bf16, tasks in ``coexec_tile_sequence`` order), with the
    launch counters zeroed just before; one launch a scenario."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    cases = [_k6_case(torch, kernels, gen, shapes, torch.bfloat16)
             for shapes in _k6_scenarios().values()]
    return _drive(torch, "coexec", lambda: [
        kernels.coexec_matmul(xs, ws, order=order)
        for xs, ws, _, order in cases])



# --------------------------------------------------------------------------
# Phase 18: sharded serving on virtual meshes over one card
# --------------------------------------------------------------------------
# Every shard of a virtual mesh is its own allocation on cuda:0, and its
# kernels run in turn.  qwen2.5-0.5b splits its 14/2 heads at model 2
# (GQA 7/1 a shard) and not at 4 (attention runs once, on caches split on
# the sequence); phi3.5-moe-42b's 32/8 heads split at 2 (16/4) and 4
# (8/2), its 16 experts 8 and 4 a rank.
SHARD_MESHES = ((1, 2), (1, 4))
SHARD_K1_ROWS = (8, 200, 256)
SHARD_K2_HEADS = ((7, 1, 64), (16, 4, 128), (8, 2, 128))
# A sharded engine's first decode step against the meshless engine's, in
# bf16 over 24 layers: each row-parallel projection rounds its ranks'
# partial sums to bf16 (2^-9 relative each) before the f32 reduction,
# where one K1 launch rounds the whole sum once, and K1 sums in other
# orders at the shard widths.  Those 48 perturbations of 2^-9 to 2^-8
# of an activation a step add up like a random walk: sqrt(48) * 2^-8 is
# about 2^-5.2 of a logit's scale.  The bound is COALESCED_REL, 2^-4 of
# the largest logit magnitude, the tolerance the meshless engine already
# takes for another summation order through the same 24 layers.
SHARDED_REL = COALESCED_REL


def _split_over_model(spec) -> bool:
    return any(e == "model" or (isinstance(e, tuple) and "model" in e)
               for e in spec)


def _mixer_shapes(cfg, kind: str) -> dict:
    """A layer's mixer linears of ``kind``, whole: ``{name: (k, n)}``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    if kind == "rglru":
        return {"in_gate": (d, d), "in_rec": (d, d), "out": (d, d)}
    if kind == "wkv":
        return {n: (d, d) for n in ("r", "k", "v", "w", "o")}
    return {"q": (d, cfg.n_heads * hd), "k": (d, cfg.n_kv_heads * hd),
            "v": (d, cfg.n_kv_heads * hd), "o": (cfg.n_heads * hd, d)}


def _tp_linears(torch, cfg, shape) -> dict:
    """Rank 0's K1 operands of every layer, the LM head and a stub
    frontend's ``frontend_proj`` on a mesh of ``shape``, from the
    sharding rules (``param_specs``, the serving layout) and the split
    the sharded forward runs (``tensor_parallel``): ``{"layers": [[(name,
    k, n, launches), ...] a layer], "head": (k, n, launches), "frontend":
    (k, n, launches) or None}``, each linear launched once a rank where
    it is split (or, under split heads, cut to the rank's heads), else
    once.  An enc-dec model's decoder layers list their cross linears
    too, and ``"encoder"`` its encoder layers'."""
    from repro_torch.distributed import param_specs, virtual_mesh
    from repro_torch.distributed.mesh import local_shape
    from repro_torch.models.common import padded_vocab, tensor_parallel

    d = cfg.d_model
    kinds = cfg.layer_kinds()
    tree = {"embed": {"table": (padded_vocab(cfg.vocab_size), d)},
            "layers": []}

    def mixer(kind):
        return {n: {"w": s} for n, s in _mixer_shapes(cfg, kind).items()}

    def mlp():
        out = {"up": {"w": (d, cfg.d_ff)}, "down": {"w": (cfg.d_ff, d)}}
        if cfg.gated_mlp:
            out["gate"] = {"w": (d, cfg.d_ff)}
        return out

    for kind in kinds:
        layer = {"mixer": mixer(kind)}
        if cfg.enc_dec:
            layer["cross"] = mixer("attn")
        if cfg.moe is None:
            layer["mlp"] = mlp()
        tree["layers"].append(layer)
    if cfg.enc_dec:
        tree["encoder"] = {"layers": [{"mixer": mixer("attn"), "mlp": mlp()}
                                      for _ in range(cfg.n_enc_layers)]}
    if cfg.frontend is not None:
        tree["frontend_proj"] = {"w": (cfg.frontend_dim, d)}
    tree = _tree_map(lambda s: torch.empty(s, device="meta"), tree)
    mesh = virtual_mesh(shape, "cpu")
    specs = param_specs(tree, cfg, mesh, fsdp=False)
    tp = tensor_parallel(cfg, mesh)
    ms = shape[1]
    cut = {"attn": tp.head_ok, "local": tp.head_ok, "rglru": False,
           "wkv": tp.wkv_heads is not None}

    def lin(w, spec, whole_cut):
        k, n = local_shape(w.shape, spec, mesh)
        split = (k, n) != tuple(w.shape)
        if whole_cut and not split:     # a whole weight cut to the heads
            k, n = (k // ms, n) if w.shape[0] != d else (k, n // ms)
        return k, n, ms if split or whole_cut else 1

    def layers(kinds, trees, spec_trees):
        return [[(f"{part} {n}",) + lin(layer[part][n]["w"],
                                         lspec[part][n]["w"],
                                         part != "mlp" and cut[kind])
                 for part in layer for n in layer[part]]
                for kind, layer, lspec in zip(kinds, trees, spec_trees)]

    v, dd, launches = lin(tree["embed"]["table"], specs["embed"]["table"],
                          False)
    front = (lin(tree["frontend_proj"]["w"], specs["frontend_proj"]["w"],
                 False) if cfg.frontend is not None else None)
    out = {"layers": layers(kinds, tree["layers"], specs["layers"]),
           "head": (dd, v, launches), "frontend": front}
    if cfg.enc_dec:
        out["encoder"] = layers(["attn"] * cfg.n_enc_layers,
                                tree["encoder"]["layers"],
                                specs["encoder"]["layers"])
    return out


def _shard_weights(torch, cfg, shape):
    """Rank 0's weight shapes of the first layer and the LM head on a
    mesh of ``shape`` (``_tp_linears``): ``{name: (k, n)}``."""
    tl = _tp_linears(torch, cfg, shape)
    out = {name: (k, n) for name, k, n, _ in tl["layers"][0]}
    out["lm_head trans_b"] = tl["head"][:2]
    return out


def check_shard_kernels(torch, kernels, gen) -> dict:
    """K1 at the shard widths of qwen2.5-0.5b and phi3.5-moe-42b on
    (1, 2) and (1, 4) (``_shard_weights``), at rows ``SHARD_K1_ROWS``;
    K2 at the shard layouts ``SHARD_K2_HEADS``, float and int8 pools;
    ``paged_attention_sharded`` on a virtual (1, 2) mesh at qwen's
    layout; K4 on 8 and 4 local experts at decode, prefix segments, and
    on ``a2a_segments`` tables: each against its plain version, bf16."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import virtual_mesh
    from repro_torch.distributed.mesh import P, Sharded
    from repro_torch.models.moe import _capacity

    worst = {"sisa_gemm": 0.0, "paged_attn": 0.0, "paged_attn_int8": 0.0,
             "grouped_gemm": 0.0}
    widths = set()
    for name in ("qwen2.5-0.5b", "phi3.5-moe-42b"):
        cfg = get_config(name)
        for shape in SHARD_MESHES:
            for what, (k, n) in _shard_weights(torch, cfg, shape).items():
                widths.add((k, n))
                b = (torch.randn(n, k, device="cuda", generator=gen)
                     / k ** 0.5).bfloat16().T if "trans_b" in what else (
                    torch.randn(k, n, device="cuda", generator=gen)
                    / k ** 0.5).bfloat16()
                for m in SHARD_K1_ROWS:
                    a = torch.randn(m, k, device="cuda",
                                    generator=gen).bfloat16()
                    ref = kernels.sisa_gemm_plain(a, b)
                    worst["sisa_gemm"] = max(worst["sisa_gemm"], _max_err(
                        f"K1 {name} {shape} {what} {k}x{n} M={m}",
                        kernels.sisa_matmul(a, b), ref, BF16_REL,
                        _f32_atol(ref)))
    for heads in SHARD_K2_HEADS:
        pos = [0, 15, 16, 47, 100, 150, 200, 255]
        q, pk, pv, table, pos_t = _attn_inputs(torch, gen, torch.bfloat16,
                                               pos, heads=heads)
        for quant in (False, True):
            pools = _int8_pools(kernels, pk, pv) if quant else (pk, pv)
            key = "paged_attn_int8" if quant else "paged_attn"
            worst[key] = max(worst[key], _max_err(
                f"K2 {'int8 ' if quant else ''}{heads}",
                kernels.paged_attention(q, *pools[:2], table, pos_t,
                                        *pools[2:]),
                kernels.paged_attention_plain(q, *pools[:2], table, pos_t,
                                              *pools[2:]),
                BF16_REL, 1e-5))
    # The sharded call against one K2 launch on the whole heads.
    mesh = virtual_mesh((1, 2), "cuda:0")
    q, pk, pv, table, pos_t = _attn_inputs(torch, gen, torch.bfloat16, pos)
    got = kernels.paged_attention_sharded(
        Sharded.of(q, P(None, "model"), mesh),
        Sharded.of(pk, P(None, None, "model"), mesh),
        Sharded.of(pv, P(None, None, "model"), mesh), table, pos_t,
        mesh=mesh).gather()
    worst["paged_attn"] = max(worst["paged_attn"], _max_err(
        "paged_attention_sharded (1, 2) 14/2", got,
        kernels.paged_attention(q, pk, pv, table, pos_t), BF16_REL, 1e-5))
    # K4 on the local experts: "psum" decode prefixes, "all_to_all" tables.
    d, ff, e = MOE_D, MOE_FF, MOE_E
    ws = {(kk, nn): (torch.randn(e, kk, nn, device="cuda", generator=gen)
                     / kk ** 0.5).bfloat16()
          for kk, nn in ((d, ff), (ff, d))}
    cap = _capacity(8, e, 2, 1.25)
    decode = torch.tensor([2, 0, 1, 1, 0, 2, 3, 0, 1, 1, 2, 0, 1, 1, 1, 0],
                          dtype=torch.int32, device="cuda")
    n_k4 = 0
    for ms in (2, 4):
        el = e // ms
        for r in range(ms):
            sizes = decode[r * el:(r + 1) * el]
            bm = kernels.flat_block_rows(min(cap, 64), ff, d, torch.bfloat16)
            starts = kernels.flat_group_offsets(sizes, bm)[:-1]
            gids = torch.arange(el, dtype=torch.int32, device="cuda")
            layouts = [("psum", el * (-(-cap // bm)) * bm, starts, sizes,
                        gids, bm)]
            recv = torch.randint(0, cap + 1, (ms, el), device="cuda",
                                 generator=gen, dtype=torch.int32)
            a_starts, a_sizes, a_gids = kernels.a2a_segments(el, ms, cap,
                                                             recv)
            a_bm = kernels.aligned_block_rows(min(cap, 64), ff, d,
                                              torch.bfloat16, align_to=cap)
            layouts.append(("all_to_all", el * ms * cap, a_starts, a_sizes,
                            a_gids, a_bm))
            for impl, m, st, sz, gd, bmm in layouts:
                for (kk, nn), w in ws.items():
                    x = torch.randn(m, kk, device="cuda",
                                    generator=gen).bfloat16()
                    wl = w[r * el:(r + 1) * el]
                    ref = kernels.segment_grouped_gemm_plain(
                        x, wl, st, sz, gd, block_rows=bmm)
                    worst["grouped_gemm"] = max(
                        worst["grouped_gemm"], _max_err(
                            f"K4 {impl} ms {ms} rank {r} {kk}x{nn}",
                            kernels.segment_grouped_gemm(
                                x, wl, st, sz, gd, block_rows=bmm),
                            ref, BF16_REL, _f32_atol(ref)))
                    n_k4 += 1
    _say(f"phase 18 kernels: K1 at the shard widths {sorted(widths)} "
         f"(rows {SHARD_K1_ROWS}), K2 at GQA {SHARD_K2_HEADS} on bf16 and "
         f"int8 pools and paged_attention_sharded on a virtual (1, 2) mesh "
         f"against one launch on the whole heads, K4 on 8 and 4 local "
         f"experts ({n_k4} cases: decode prefixes and a2a_segments tables) "
         f"agree with their plain versions (max abs err "
         f"{json.dumps(worst)}; bf16 2^-7*|ref| + atol)")
    return worst


def check_sharded_small(torch, np, label, cfg) -> None:
    """``cfg`` (float32) through the slot and paged engines on virtual
    (1, 2) and (2, 2) meshes on the card: tokens identical to the CPU
    engine without a mesh (plain versions).  An MoE model also runs
    ``"all_to_all"`` EP on (1, 2), against the CPU's (1, 2) mesh under
    it (each shard's own capacity: its own tokens)."""
    from repro_torch.distributed import virtual_mesh
    from repro_torch.models import init_params, moe
    from repro_torch.serve import make_engine, Request

    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = _tree_map(lambda t: t.cuda(), cpu)
    cases = [("psum", "cpu", None), ("psum", "cuda:0", (1, 2)),
             ("psum", "cuda:0", (2, 2))]
    if cfg.moe is not None:
        cases += [("all_to_all", "cpu", (1, 2)),
                  ("all_to_all", "cuda:0", (1, 2))]
    try:
        for kind in ("slot", "paged"):
            outs = {}
            for impl, dev, shape in cases:
                moe.set_ep_impl(impl)
                kw = (dict(device="cpu") if shape is None
                      else dict(mesh=virtual_mesh(shape, dev)))
                eng = make_engine(cfg, cpu if dev == "cpu" else gpu,
                                  kind=kind, max_slots=4, max_seq=64,
                                  page_size=16, window=4, **kw)
                reqs = _small_requests(Request, np, cfg, kind, SMALL_LENS)
                for req in reqs:
                    req.max_new_tokens = 12
                outs[impl, dev, shape] = [
                    (c.rid, c.tokens)
                    for c in _serve_offline(eng, kind, reqs, 64)]
                want = outs[impl, "cpu", None if impl == "psum" else shape]
                if outs[impl, dev, shape] != want:
                    raise AssertionError(
                        f"sharded small model ({label}), {kind} {impl} on "
                        f"{dev} {shape}: tokens {outs[impl, dev, shape]} "
                        f"differ from the CPU's {want}")
    finally:
        moe.set_ep_impl("psum")
    _say(f"sharded small model ({label}, {cfg.n_layers} layers, f32): slot "
         f"and paged on virtual (1, 2) and (2, 2) meshes of the card, "
         f"tokens identical to the CPU engine without a mesh"
         + ("; all_to_all EP on (1, 2) identical to the CPU's (1, 2) mesh"
            if cfg.moe is not None else ""))


def _capture_first_step(store, cfg):
    """A ``before_serve`` hook: after the warmup, the first decode step's
    logits of the live rows, their rids, and the launches of that one
    step, appended to ``store``."""
    from repro_torch.kernels import LAUNCH_COUNTERS

    def hook(eng):
        decode = eng.decode_fn

        def first_step(*args):
            before = {k: c.n for k, c in LAUNCH_COUNTERS.items()}
            logits, caches = decode(*args)
            if not store:
                live = [i for i, r in enumerate(eng._req) if r is not None]
                store.append((logits[live, 0, :cfg.vocab_size].float()
                              .clone(), [eng._req[i].rid for i in live],
                              {k: c.n - before[k] for k, c
                               in LAUNCH_COUNTERS.items()
                               if c.n > before[k]}))
            return logits, caches
        eng.decode_fn = first_step
    return hook


def _predicted_launches(eng, cfg) -> dict:
    """K1 and K2 launches of one decode step from the placed specs: a
    linear split over ``model`` launches once a rank, a whole one once
    (an enc-dec decoder layer's cross q and o among them: decode reads
    the cross K/V it never projects); K2 (paged storage of global layers
    only) once a rank a global layer where the pools' spec splits the KV
    heads, else once a layer."""
    ranks = eng.mesh.shape["model"]
    specs = eng.params.specs
    k1 = 0
    for layer in specs["layers"]:
        for part, name, lin in _decode_linears(layer):
            k1 += ranks if _split_over_model(lin["w"]) else 1
    head = "lm_head" if "lm_head" in specs else "embed"
    k1 += ranks if _split_over_model(specs[head]["table"]) else 1
    pools = getattr(eng.cache, "pools", None)
    if pools is None or "pk" not in pools:
        k2 = 0
    else:
        spec = tuple(pools["pk"].spec) + (None,) * 5
        k2 = cfg.layer_kinds().count("attn") * (ranks if spec[3] is not None
                                                else 1)
    return {"sisa_gemm": k1, "paged_attn": k2}


def _decode_linears(layer) -> list:
    """``(part, name, linear)`` of each linear a decode step runs in a
    layer's tree (or spec tree): its mixer's and MLP's, and an enc-dec
    layer's cross q and o."""
    out = []
    for part in ("mixer", "cross", "mlp"):
        for name, lin in layer.get(part, {}).items():
            if isinstance(lin, dict) and "w" in lin and (
                    part != "cross" or name in ("q", "o")):
                out.append((part, name, lin))
    return out


def _storage_bytes(eng) -> dict:
    """Bytes of each stack of the engine's storage a rank (its own
    tensors), and the whole tables."""
    from repro_torch.distributed.mesh import Sharded

    store = eng.cache.pools if hasattr(eng.cache, "pools") \
        else eng.cache.buffers
    out = {name: t.nbytes() for name, t in store.items()
           if isinstance(t, Sharded)}
    if hasattr(eng.cache, "tables"):
        out["tables"] = sum(t.numel() * t.element_size()
                            for t in eng.cache.tables().values())
    return out


def serve_sharded_qwen(torch, np, kernels) -> dict:
    """Full-width qwen2.5-0.5b (24 layers, bf16) through slot and paged
    on virtual (1, 2) and (1, 4) meshes of the card, the qwen workload
    at ``max_slots=8, max_seq=256, page_size=16``, beside the engine
    without a mesh (each warmed at rung 8, where the workload runs): K1
    and K2 launches of the first decode step as the specs predict,
    per-rank storage bytes summing to the meshless engine's, the first
    decode step's logits within ``SHARDED_REL``, tokens that agree
    counted, one profiled window (paged on (1, 2)) and K1 timed at a
    sharded decode step."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import virtual_mesh
    from repro_torch.models import init_params

    cfg = get_config("qwen2.5-0.5b")
    params = init_params(cfg, seed=0)
    out = {"serves": {}, "k1": {}}

    def capture(store):
        return _capture_first_step(store, cfg)

    for kind in ("slot", "paged"):
        need = ("sisa_gemm",) + (("paged_attn",) if kind == "paged" else ())
        ref_store = []
        ref, _, _, ref_outs = serve_full_width(
            torch, np, cfg, need, params=params, kind=kind,
            warm_rungs=(8,), before_serve=capture(ref_store))
        ref_bytes = ref.cache.resident_bytes()
        del ref
        for shape in SHARD_MESHES:
            store = []
            eng, _, launches, outs = serve_full_width(
                torch, np, cfg, need, params=params, kind=kind,
                mesh=virtual_mesh(shape, "cuda:0"), warm_rungs=(8,),
                before_serve=capture(store))
            (got, rids, measured), (want, want_rids, _) = (store[0],
                                                           ref_store[0])
            if rids != want_rids:
                raise AssertionError(f"first decode step rows {rids} vs "
                                     f"{want_rids}")
            scale = want.abs().max().item()
            err = (got - want).abs().max().item()
            if not err <= SHARDED_REL * scale:
                raise AssertionError(
                    f"{kind} on {shape}: first decode step's logits off by "
                    f"{err} > {SHARDED_REL} * {scale}")
            agree = sum(a == b for o, r in zip(outs, ref_outs)
                        for a, b in zip(o.tokens, r.tokens))
            same = sum(o.tokens == r.tokens for o, r in zip(outs, ref_outs))
            predicted = _predicted_launches(eng, cfg)
            # One window profiled (the profiler's post-processing of a
            # sharded window's events is slow); the others counted
            # unprofiled.
            for name, n in predicted.items():
                if measured.get(name, 0) != n:
                    raise AssertionError(
                        f"{kind} on {shape}: {name} {measured.get(name, 0)} "
                        f"launches a decode step, predicted {n}")
            nbytes = _storage_bytes(eng)
            total = sum(sum(v) if isinstance(v, list) else v
                        for v in nbytes.values())
            if total != ref_bytes:
                raise AssertionError(f"{kind} on {shape}: {total} bytes of "
                                     f"storage, the meshless {ref_bytes}")
            if (kind, shape) == ("paged", (1, 2)):
                # One sharded window profiled, at 2 steps: the profiler's
                # post-processing grows with the window's events.
                prof = profile_window(torch, np, eng, cfg, steps=2)
                if prof["queued_after_admission"] or \
                        prof["launches_a_step"] != {k: float(v) for k, v
                                                    in measured.items()}:
                    raise AssertionError(f"profiled window: {prof}")
            rec = {"launches_a_step": measured, "predicted": predicted,
                   "serve_launches": launches, "storage_bytes": nbytes,
                   "first_step_logits_max_abs_err": err,
                   "first_step_logits_rel_to_max": err / scale,
                   "tokens_agreeing": agree,
                   "tokens": sum(len(r.tokens) for r in ref_outs),
                   "completions_equal": same}
            out["serves"][f"{kind} {shape}"] = rec
            _say(f"sharded serve qwen2.5-0.5b {kind} on a virtual {shape} "
                 f"mesh: {json.dumps(rec)}")
            if kind == "paged":
                gemms = _k1_gemms(torch, None, cfg, 8, ranks=eng.params)
                if len(gemms) != predicted["sisa_gemm"]:
                    raise AssertionError(f"{len(gemms)} timed GEMMs, "
                                         f"{predicted['sisa_gemm']} a step")
                out["k1"][shape] = time_gemms(torch, kernels, gemms)
                _say(f"k1 sharded decode step {shape} (rung 8, "
                     f"{len(gemms)} GEMMs over the ranks): "
                     f"{json.dumps(out['k1'][shape])}")
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    del params
    return out


# A sharded MoE layer against the meshless one on the same input rows.
# The router is whole on every rank and sees the same rows (under
# all_to_all each rank's chunk, compared with the meshless layer on that
# chunk, which has the same capacity), so both pick the same top-2
# experts for every token: that is checked, not assumed.  They then
# differ only where K4's plan for the local experts sums K in another
# order than the plan for all of them, so gate, up and down may each
# round to another bf16 neighbour (2^-8 of an element), and a rank's
# output is rounded once more before the f32 sum: a few 2^-8 of the
# terms, under 2^-6 of the largest output.  The bound takes 2^-5.  An
# expert on the wrong rank, or a rank's rows at the wrong offsets, puts
# whole outputs of the order of the largest in the wrong place.
EP_LAYER_REL = 2.0 ** -5


def _spy_routes(moe):
    """Wrap ``moe._route`` to record each call's input rows, weights and
    top-k choices; returns the record and the function that unwraps."""
    route, calls = moe._route, []

    def spy(x, p, cfg, valid):
        rt = route(x, p, cfg, valid)
        calls.append((x, p, rt["topi"]))
        return rt

    moe._route = spy

    def undo():
        moe._route = route
    return calls, undo


def _top2_flips(a, b) -> int:
    """Tokens whose top-k expert sets differ between two routings."""
    return int((a.sort(dim=-1).values != b.sort(dim=-1).values).any(-1)
               .sum().item())


def check_moe_ep_layers(torch, np, cfg, params) -> dict:
    """Every MoE layer of ``params`` (phi3.5-moe-42b at full width, bf16)
    on virtual (1, 2) and (1, 4) meshes of the card under ``"psum"`` and
    ``"all_to_all"``, against the meshless layer on the same input rows
    (those the meshless prefill of the 200-token prompt gives it):
    routing identical, outputs within ``EP_LAYER_REL`` of the largest.
    This is the check that a routing flip cannot move."""
    from repro_torch.distributed import place_params, virtual_mesh
    from repro_torch.models import forward_prefill, moe

    rng = np.random.default_rng(0)
    prompt = _requests(lambda **kw: kw["prompt"], rng, cfg.vocab_size,
                       PROMPT_LENS)[-1]
    calls, undo = _spy_routes(moe)
    try:
        forward_prefill(params, cfg, {"tokens": torch.as_tensor(
            prompt[None], device="cuda:0")})
    finally:
        undo()
    if len(calls) != cfg.n_layers:
        raise AssertionError(f"{len(calls)} routings for {cfg.n_layers} "
                             "MoE layers")
    inputs = [(x, p) for x, p, _ in calls]
    out = {}
    for ranks in (2, 4):
        mesh = virtual_mesh((1, ranks), "cuda:0")
        worst = {"psum": 0.0, "all_to_all": 0.0}
        for x, p in inputs:
            local = [t["layers"][0]["moe"] for t in
                     place_params({"layers": [{"moe": p}]}, cfg, mesh).local]
            if local[0]["up"].shape[0] != cfg.moe.n_experts // ranks:
                raise AssertionError(f"{local[0]['up'].shape[0]} experts a "
                                     f"rank at {ranks} ranks")
            chunks = torch.chunk(x, ranks, dim=1)
            for impl in ("psum", "all_to_all"):
                moe.set_ep_impl(impl)
                calls, undo = _spy_routes(moe)
                try:
                    want = (moe.moe_apply(p, x, cfg)[0] if impl == "psum"
                            else torch.cat([moe.moe_apply(p, c, cfg)[0]
                                            for c in chunks], dim=1))
                    n_want = len(calls)
                    got = moe.moe_apply(local, x, cfg, mesh=mesh)[0]
                finally:
                    undo()
                    moe.set_ep_impl("psum")
                torch.cuda.synchronize()
                want_routes = [c[2] for c in calls[:n_want]]
                got_routes = [c[2] for c in calls[n_want:]]
                if impl == "psum":
                    want_routes = want_routes * ranks   # each rank: all rows
                if len(got_routes) != ranks or any(
                        not torch.equal(a, b)
                        for a, b in zip(want_routes, got_routes)):
                    raise AssertionError(f"{impl} at {ranks} ranks: routing "
                                         "differs from the meshless layer's")
                rel = ((got.float() - want.float()).abs().max()
                       / want.float().abs().max()).item()
                if not rel <= EP_LAYER_REL:
                    raise AssertionError(
                        f"{impl} at {ranks} ranks: a MoE layer off by {rel} "
                        f"of the largest output > {EP_LAYER_REL}")
                worst[impl] = max(worst[impl], rel)
            del local
        out[f"(1, {ranks})"] = worst
    del inputs, calls
    gc.collect()
    torch.cuda.empty_cache()
    _say(f"sharded MoE layers phi3.5-moe-42b ({cfg.n_layers} layers, 200 "
         f"rows each, routing identical to the meshless layer's): worst "
         f"output error over the largest {json.dumps(out)} (bound "
         f"{EP_LAYER_REL})")
    return out


def explain_moe_divergence(torch, np, cfg, params) -> dict:
    """The workload's 8 prompts prefilled without a mesh and on a virtual
    (1, 2) mesh under ``"psum"``: per layer, the tokens whose top-2
    expert set differs between the two; per prompt, the prefill logits'
    error over the largest.  Every prompt whose logits are off by more
    than ``SHARDED_REL`` must have a routing flip, and the prompts that
    route identically in every layer must be within it."""
    from repro_torch.distributed import place_params, virtual_mesh
    from repro_torch.models import forward_prefill, moe

    mesh = virtual_mesh((1, 2), "cuda:0")
    placed = place_params(params, cfg, mesh)
    rng = np.random.default_rng(0)
    prompts = _requests(lambda **kw: kw["prompt"], rng, cfg.vocab_size,
                        PROMPT_LENS)
    flips = [0] * cfg.n_layers
    rows = []
    moe.set_ep_impl("psum")
    for prompt in prompts:
        tokens = torch.as_tensor(prompt[None], device="cuda:0")
        got = {}
        for label, tree, m in (("meshless", params, None),
                               ("psum", placed, mesh)):
            calls, undo = _spy_routes(moe)
            try:
                logits = forward_prefill(tree, cfg, {"tokens": tokens},
                                         mesh=m)[0]
            finally:
                undo()
            got[label] = (logits[0, -1, :cfg.vocab_size].float(),
                          [c[2] for c in calls])
        a, b = got["meshless"][1], got["psum"][1]
        if len(b) != 2 * len(a) or any(not torch.equal(x, y)
                                       for x, y in zip(b[::2], b[1::2])):
            raise AssertionError("psum ranks routed a layer differently")
        per_layer = [_top2_flips(x, y) for x, y in zip(a, b[::2])]
        flips = [f + g for f, g in zip(flips, per_layer)]
        want = got["meshless"][0]
        rel = ((got["psum"][0] - want).abs().max()
               / want.abs().max()).item()
        rows.append({"len": len(prompt), "flips": sum(per_layer),
                     "first_flip_layer": next(
                         (i for i, f in enumerate(per_layer) if f), None),
                     "logits_rel": rel})
    del placed
    gc.collect()
    torch.cuda.empty_cache()
    unexplained = [r for r in rows if r["flips"] == 0
                   and not r["logits_rel"] <= SHARDED_REL]
    if unexplained:
        raise AssertionError(f"prompts routed identically in every layer "
                             f"but off by more than {SHARDED_REL}: "
                             f"{unexplained}")
    out = {"flips_by_layer": flips,
           "routings": cfg.n_layers * sum(len(p) for p in prompts),
           "prompts": rows,
           "clean_prompts": sum(r["flips"] == 0 for r in rows),
           "clean_max_rel": max((r["logits_rel"] for r in rows
                                 if r["flips"] == 0), default=None),
           "divergent_prompts_all_flipped": all(
               r["flips"] > 0 for r in rows
               if not r["logits_rel"] <= SHARDED_REL)}
    _say(f"sharded prefill phi3.5-moe-42b on (1, 2) psum vs meshless, top-2 "
         f"flips and prefill logits: {json.dumps(out)}")
    return out


def serve_sharded_phi(torch, np, kernels) -> dict:
    """phi3.5-moe-42b at 8 of 32 layers (bf16) through paged without a
    mesh and on a virtual (1, 2) mesh under ``"psum"`` and
    ``"all_to_all"`` expert parallelism (the prefills split their
    sequence for the latter): K1, K2 and K4 launched, tokens compared
    (psum with the meshless serve, all_to_all with psum); every MoE
    layer held against the meshless one on the same rows
    (:func:`check_moe_ep_layers`) and the prefills' routing flips
    counted against their logits (:func:`explain_moe_divergence`); K4
    timed at 8 and 4 local experts."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import virtual_mesh
    from repro_torch.models import init_params, moe

    cfg = dataclasses.replace(get_config("phi3.5-moe-42b"),
                              n_layers=MOE_LAYERS)
    params = init_params(cfg, seed=0)
    out = {}
    firsts = {"meshless": []}
    eng, _, _, plain = serve_full_width(
        torch, np, cfg, KERNEL_NAMES, params=params, kind="paged",
        warm_rungs=(8,), before_serve=_capture_first_step(
            firsts["meshless"], cfg))
    del eng
    outs = {}
    try:
        for impl in ("psum", "all_to_all"):
            moe.set_ep_impl(impl)
            firsts[impl] = []
            eng, _, launches, outs[impl] = serve_full_width(
                torch, np, cfg, KERNEL_NAMES, params=params, kind="paged",
                mesh=virtual_mesh((1, 2), "cuda:0"), warm_rungs=(8,),
                before_serve=_capture_first_step(firsts[impl], cfg))
            out[impl] = launches
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        moe.set_ep_impl("psum")

    def agreement(a_outs, b_outs):
        pairs = list(zip(a_outs, b_outs))
        return {"completions": sum(a.tokens == b.tokens for a, b in pairs),
                "first_tokens": sum(a.tokens[0] == b.tokens[0]
                                    for a, b in pairs),
                "tokens": sum(x == y for a, b in pairs
                              for x, y in zip(a.tokens, b.tokens)),
                "of": sum(len(a.tokens) for a, _ in pairs)}

    def rel(a, b):
        """Max abs difference of two first decode steps' logits over the
        largest magnitude of ``b``'s."""
        return ((firsts[a][0][0] - firsts[b][0][0]).abs().max()
                / firsts[b][0][0].abs().max()).item()

    out["agreement"] = {"psum_vs_meshless": agreement(outs["psum"], plain),
                        "all_to_all_vs_psum": agreement(outs["all_to_all"],
                                                        outs["psum"])}
    out["first_step_logits_rel"] = {
        "psum_vs_meshless": rel("psum", "meshless"),
        "all_to_all_vs_psum": rel("all_to_all", "psum")}
    _say(f"sharded serve phi3.5-moe-42b ({cfg.n_layers} layers) paged on "
         f"(1, 2), agreement (completions, first tokens, tokens): "
         f"{json.dumps(out['agreement'])}, the first decode step's logits "
         f"off by {json.dumps(out['first_step_logits_rel'])} of the "
         f"largest (all_to_all gives each shard its own capacity at "
         f"prefill)")
    out["ep_layers"] = check_moe_ep_layers(torch, np, cfg, params)
    out["prefill_routing"] = explain_moe_divergence(torch, np, cfg, params)
    for ranks in (2, 4):
        out[f"k4_{ranks}"] = time_k4(torch, kernels, params, cfg,
                                     n_tokens=8, ranks=ranks)
        _say(f"k4 sharded decode step ({MOE_E // ranks} local experts a "
             f"rank, {ranks} ranks, {out[f'k4_{ranks}']['launches_timed']} "
             f"launches): {json.dumps(out[f'k4_{ranks}'])}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_sharded_fault(torch, np, cfg) -> None:
    """``ServeFrontend`` over a virtual (2, 2) mesh of the card whose
    device probe drops the last two devices mid-serve: the engine
    re-meshes to (1, 2) and its completions equal an uninterrupted serve
    on a virtual (1, 2) mesh (``cfg`` in float32)."""
    from repro_torch.distributed import (simulate_failure, StragglerWatchdog,
                                         virtual_mesh)
    from repro_torch.models import init_params
    from repro_torch.serve import make_engine, ServeFrontend

    params = init_params(cfg, seed=0)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype("int32")
               for n in (5, 13, 9, 21, 7)]
    budgets = (10, 8, 12, 6, 9)
    done = {}
    for label, shape in (("uninterrupted", (1, 2)), ("fault", (2, 2))):
        mesh = virtual_mesh(shape, "cuda:0")
        eng = make_engine(cfg, params, kind="paged", mesh=mesh, max_slots=4,
                          max_seq=64, page_size=16, window=4)
        devs, calls = list(mesh.devices.flat), [0]

        def probe():
            calls[0] += 1
            return simulate_failure(devs, 2) if calls[0] > 2 else devs

        fe = ServeFrontend(eng, watchdog=StragglerWatchdog(),
                           device_probe=probe if label == "fault" else None)
        fe.warmup(max_prompt_len=64)
        handles = [fe.submit(p, b) for p, b in zip(prompts, budgets)]
        done[label] = [tuple(h.result(300).tokens) for h in handles]
        metrics = fe.metrics()
        _shutdown(fe)
        if label == "fault":
            if metrics["remeshes"] < 1 or eng.mesh.shape != {"data": 1,
                                                             "model": 2}:
                raise AssertionError(f"fault run: remeshes "
                                     f"{metrics['remeshes']}, mesh "
                                     f"{eng.mesh.shape}")
            remeshes = eng.stats["engine"]["remeshes"]
    if done["fault"] != done["uninterrupted"]:
        raise AssertionError("fault run: completions differ from the "
                             "uninterrupted serve")
    _say(f"sharded fault run ({cfg.name} widths, {cfg.n_layers} layers, "
         f"f32): ServeFrontend over a virtual (2, 2) mesh lost 2 devices, "
         f"re-meshed to (1, 2) ({remeshes} remesh), {len(prompts)} "
         f"completions equal to an uninterrupted serve on (1, 2)")


# --------------------------------------------------------------------------
# Phase 19: sharded training on virtual meshes over one card
# --------------------------------------------------------------------------
# qwen2.5-0.5b at full width (bf16, seeded weights), cut to 12 of its 24
# layers since phase 21 joined (for the script's time), trains 3 steps of
# 8 x 256 tokens on (2, 2) (FSDP over data, 7/1 heads a shard, 1,024 rows
# a data replica) and on (1, 4) (the 14/2 heads do not split: q/k/v/o stay
# whole on every rank and attention runs once; the MLP is 1,216 wide a
# rank).  phi3.5-moe-42b cut to 2 layers trains 2 steps on (1, 2) under
# "psum" and "all_to_all" (8 local experts a rank).  Then an elastic
# restart: qwen's (2, 2) state saved and restored onto (1, 2) for one
# more step.  Every shard is its own allocation on cuda:0 and the ranks
# run in turn: the phase measures what sharding costs, never a speedup.
SHARD_TRAIN_MESHES = ((2, 2), (1, 4))
SHARD_TRAIN_LAYERS = 12
SHARD_TRAIN_STEPS, SHARD_MOE_STEPS = 3, 2
# Against the meshless port step from the same weights (``accum_steps``
# D for a dense model, as the reference's sharded step): each row-
# parallel projection rounds its ranks' partial sums to bf16 before the
# f32 reduction, the data gather's backward adds the replicas' bf16
# gradients in bf16, and K1 sums in other orders at the shard widths.
# The loss is a mean over 2,048 tokens, where those 2^-8 perturbations
# average out: SHARD_LOSS_REL, 2^-8 of the loss.  The global norm sums
# every gradient's square: SHARD_NORM_REL, 2^-5 of it.  A gradient leaf
# is held elementwise to SHARDED_REL (2^-4) of its largest magnitude,
# the bound of the sharded serve's logits after the same 24 layers.
SHARD_LOSS_REL = 2.0 ** -8
SHARD_NORM_REL = 2.0 ** -5


def _train_k1_gemms(torch, cfg, shape, rows: int, frontend: bool = False,
                    enc_rows: int = None):
    """Every K1 forward GEMM ``(m, k, n, head)`` of one sharded train step
    (all data replicas and model ranks), from the TP layout
    (``_tp_linears``): each layer's linears and the LM head (``head``
    True: read as ``table.T``) once a rank where they split, else once;
    with ``frontend`` (a batch of ``frontend_embeds``) ``frontend_proj``
    too (``head`` None: outside the layers, never recomputed).  ``rows``
    is a data replica's tokens; on an enc-dec model ``enc_rows`` its
    encoder frames, over which ``frontend_proj``, each encoder layer and
    each decoder layer's cross k and v run."""
    tl = _tp_linears(torch, cfg, shape)
    enc = {"cross k", "cross v"}
    gemms = [(enc_rows if name in enc else rows, k, n, False)
             for layer in tl["layers"]
             for name, k, n, times in layer for _ in range(times)]
    gemms += [(enc_rows, k, n, False) for layer in tl.get("encoder", [])
              for _, k, n, times in layer for _ in range(times)]
    k, n, times = tl["head"]
    gemms += [(rows, k, n, True)] * times
    if frontend:
        k, n, times = tl["frontend"]
        gemms += [(enc_rows or rows, k, n, None)] * times
    return gemms * shape[0]


def _predicted_train_launches(cfg, shape, rows: int, torch,
                              remat: str = "none", frontend: bool = False,
                              enc_rows: int = None) -> dict:
    """K1, K4 and K5 launches of one sharded train step, from the specs:
    each forward GEMM is one launch a row pass (``row_passes``) forward
    and for dA, and one a pass of its K rows for dB; each MoE layer runs
    up, gate and down through K4 forward, K4 dX and K5 once a rank that
    holds experts, a data replica.  Under ``remat="full"`` every layer's
    forward runs again in the backward (the LM head's does not).
    ``enc_rows``: an enc-dec model's encoder frames a data replica."""
    from repro_torch.kernels.ops import row_passes

    again = remat != "none"
    gemms = _train_k1_gemms(torch, cfg, shape, rows, frontend, enc_rows)
    k1 = sum((2 + (again and head is False)) * len(row_passes(m))
             + len(row_passes(k)) for m, k, _, head in gemms)
    out = {"sisa_gemm": k1}
    if cfg.moe is not None:
        ranks = shape[1] if cfg.moe.n_experts % shape[1] == 0 else 1
        k4 = 3 * cfg.n_layers * ranks * shape[0]
        out.update(grouped_gemm=k4 * (1 + again), grouped_gemm_dx=k4,
                   grouped_dw=k4)
    return out


def _assert_replicas_bitwise(placed, what: str) -> None:
    """Every device's copy of a part equal, bit for bit, to the first
    holder's."""
    from repro_torch.distributed.sharding import _leaves, replica_groups

    for li, spec in enumerate(_leaves(placed.specs)):
        for group in replica_groups(spec, placed.mesh):
            first = _leaves(placed.shards[group[0]])[li]
            for c in group[1:]:
                if not _leaves(placed.shards[c])[li].equal(first):
                    raise AssertionError(f"{what}: leaf {li} {spec} on {c} "
                                         f"differs from {group[0]}")


def _meshless_reference(torch, cfg, params, batch, accum: int) -> dict:
    """The meshless port step's loss and ``grad_norm`` on ``batch`` with
    ``accum`` microbatches (the loss and the norm of the averaged
    gradients, which the AdamW update clips by), its gradients, and for
    a MoE model (``accum`` 1) each layer's top-k choices."""
    from repro_torch.models import moe
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import loss_and_grads

    b = batch["tokens"].shape[0]
    loss, grads, routes = 0.0, None, None
    for i in range(accum):
        mb = {k: v[i * b // accum:(i + 1) * b // accum].cuda()
              for k, v in batch.items()}
        calls, undo = _spy_routes(moe)
        try:
            mb_loss, _, g = loss_and_grads(params, cfg, mb, remat="none")
        finally:
            undo()
        if cfg.moe is not None and accum == 1:
            routes = [c[2] for c in calls]
        loss = loss + float(mb_loss) / accum
        if grads is None:
            grads = g if accum == 1 else [t.float() / accum
                                          for t in tree_leaves(g)]
        else:
            for a, t in zip(grads, tree_leaves(g)):
                a.add_(t.float() / accum)
        del g
    leaves = tree_leaves(grads) if accum == 1 else grads
    return {"loss": loss, "grad_norm": float(adamw.global_norm(leaves)),
            "grads": leaves, "routes": routes}


# Where the sharded forward's rounding flips a token's top-2 expert set,
# the gradients of the experts it left and joined, and its layer's
# router, move by that token's whole term.  Those, and only those, are
# held in relative Frobenius norm, to SHARD_EXPERT_REL (2^-2); every
# expert whose routed token set is the meshless one (its queue, and so
# its capacity drops, the same) is held elementwise like any other leaf,
# to SHARDED_REL of its stack's largest magnitude.
SHARD_EXPERT_REL = 2.0 ** -2


def _routing_changes(torch, ref_routes, calls, ranks: int) -> list:
    """Per MoE layer, the tokens whose top-k expert set differs between
    the meshless step (``ref_routes``) and a psum step's (``calls`` of
    ``_spy_routes``: each of the ``ranks`` ranks routes every layer, all
    alike), and the experts such a token left or joined."""
    got = [c[2] for c in calls]
    if len(got) != ranks * len(ref_routes) or any(
            not torch.equal(got[i], got[i - i % ranks])
            for i in range(len(got))):
        raise AssertionError("psum ranks routed a layer differently")
    out = []
    for a, b in zip(ref_routes, got[::ranks], strict=True):
        a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        sa, sb = a.sort(dim=-1).values, b.sort(dim=-1).values
        moved = (sa != sb).any(-1)
        experts = set()
        for x, y in zip(sa[moved].tolist(), sb[moved].tolist()):
            experts |= set(x) ^ set(y)
        out.append({"flips": int(moved.sum().item()),
                    "tokens": int(a.shape[0]),
                    "experts_changed": sorted(experts)})
    return out


def _grads_vs_meshless(torch, placed_grads, ref_leaves, what: str,
                       changes: list = None) -> dict:
    """Every gathered gradient leaf against the meshless one: each element
    within ``SHARDED_REL`` of the leaf's largest magnitude; in a MoE
    layer whose routing ``changes`` (``_routing_changes``) show flips,
    its router and the experts that a flipped token left or joined
    within ``SHARD_EXPERT_REL`` in relative Frobenius norm instead.  An
    enc-dec decoder layer's cross-attention key bias has an exact
    gradient of 0 (it adds one constant to a query's logits, which the
    softmax removes): both sides hold rounding noise, held within
    ``SHARDED_REL`` of the largest gradient magnitude of the tree.
    Returns the worst of each and its leaf."""
    from repro_torch.distributed import unshard_tree
    from repro_torch.optim.adamw import tree_leaves

    whole = unshard_tree(placed_grads.shards, placed_grads.specs,
                         placed_grads.mesh, device="cuda")
    names = _leaf_paths(whole)
    out = {"leaves": 0, "worst_rel": 0.0, "worst_leaf": None,
           "experts_elementwise": 0, "experts_fro": 0,
           "routers_elementwise": 0, "routers_fro": 0,
           "moe_worst_fro": None, "moe_worst_fro_leaf": None,
           "zero_gradient_leaves": 0, "zero_gradient_noise_rel": None}
    top = max(r.float().abs().max().item() for r in ref_leaves)

    def hold(name, got, ref, scale):
        rel = (got - ref).abs().max().item() / max(scale, 1e-30)
        if rel > SHARDED_REL:
            raise AssertionError(f"{what}: gradient {name} off by {rel} of "
                                 f"its largest magnitude {scale}")
        if rel >= out["worst_rel"]:
            out["worst_rel"], out["worst_leaf"] = rel, name

    def hold_fro(name, got, ref):
        fro = ((got - ref).norm() / max(ref.norm().item(), 1e-30)).item()
        if fro > SHARD_EXPERT_REL:
            raise AssertionError(f"{what}: MoE gradient {name} off by "
                                 f"{fro} in relative Frobenius norm")
        if fro >= (out["moe_worst_fro"] or 0.0):
            out["moe_worst_fro"], out["moe_worst_fro_leaf"] = fro, name

    for name, got, ref in zip(names, tree_leaves(whole), ref_leaves,
                              strict=True):
        got, ref = got.float(), ref.float()
        scale = ref.abs().max().item()
        out["leaves"] += 1
        if name.endswith("/cross/k/b"):
            noise = max(got.abs().max().item(), scale) / top
            if noise > SHARDED_REL:
                raise AssertionError(f"{what}: {name}'s exact-zero gradient "
                                     f"holds {noise} of the largest")
            out["zero_gradient_leaves"] += 1
            out["zero_gradient_noise_rel"] = max(
                noise, out["zero_gradient_noise_rel"] or 0.0)
            continue
        if "/moe/" not in name:
            hold(name, got, ref, scale)
            continue
        change = changes[int(name.split("/")[2])]
        if name.endswith("/router"):
            key = "routers_fro" if change["flips"] else "routers_elementwise"
            out[key] += 1
            (hold_fro(name, got, ref) if change["flips"]
             else hold(name, got, ref, scale))
            continue
        moved = change["experts_changed"]
        kept = [e for e in range(ref.shape[0]) if e not in moved]
        out["experts_fro"] += len(moved)
        out["experts_elementwise"] += len(kept)
        if kept:
            hold(f"{name}{kept}", got[kept], ref[kept], scale)
        for e in moved:
            hold_fro(f"{name}[{e}]", got[e], ref[e])
    return out


def _leaf_paths(tree, prefix: str = "") -> list:
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _leaf_paths(v, f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, f"{prefix}/{i}")]
    return [prefix]


def _profile_train_step(torch, step, placed, opt, batch) -> tuple:
    """One sharded train step under ``torch.profiler``: wall, device busy
    and idle share, the device time of the ``collective::`` ranges (the
    forward's; the backward's exchanges run in autograd outside them),
    the kernels by family, and the seconds the profiler's own processing
    took after the step."""
    from torch.profiler import profile, ProfilerActivity

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        placed, opt, m = step(placed, opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam = {"K1": 0.0, "K4 forward": 0.0, "K4 dX": 0.0, "K5": 0.0,
           "copy": 0.0, "other": 0.0}
    collectives = {}
    for evt in prof.key_averages():
        on_device = "CUDA" in str(getattr(evt, "device_type", ""))
        if getattr(evt, "is_user_annotation", False):
            if evt.key.startswith("collective::") and not on_device:
                collectives[evt.key] = evt.device_time_total / 1e3
            continue
        if not on_device:
            continue
        name = _train_family(evt.key)
        if name == "other" and any(w in evt.key.lower()
                                   for w in ("memcpy", "copy", "cat")):
            name = "copy"
        fam[name] += _self_device_us(evt) / 1e3
    busy = sum(fam.values())
    return placed, opt, m, {
        "step_wall_ms": wall_ms, "device_ms": fam, "device_busy_ms": busy,
        "busy_share": busy / wall_ms, "idle_share": 1 - busy / wall_ms,
        "collectives_device_ms": collectives,
        "profiler_s": time.perf_counter() - t0 - wall_ms / 1e3}


def _run_sharded_train(torch, cfg, shape, host_params, batches, ref,
                       steps: int, impl: str = "psum",
                       profile_step: int = None, remats: tuple = None,
                       check_grads: bool = True) -> dict:
    """``steps`` sharded train steps of ``cfg`` on a virtual ``shape``
    mesh of cuda:0 from ``host_params`` (copied; left as they are),
    through ``make_train_step(cfg, mesh, remat=remats[s])`` (default
    ``"none"``): the first step's loss and ``grad_norm`` against ``ref``
    (the meshless step's), with ``check_grads`` its gradients leaf by
    leaf (a MoE model's top-2 flips counted first, ``_routing_changes``),
    launches a step against ``_predicted_train_launches``, every bf16
    launch on a wgmma route, replicas bitwise equal after every step,
    the ranks' unique parameter and moment bytes against the meshless
    ones, each step's peak memory; step ``profile_step`` under
    ``torch.profiler``.  Returns the state and the record."""
    from repro_torch.distributed import (init_opt_state, place_train,
                                         virtual_mesh)
    from repro_torch.distributed.sharding import reduce_replicas
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.kernels.grouped_gemm import ROUTE_LAUNCHES
    from repro_torch.models import moe
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import loss_and_grads, make_train_step

    remats = remats or ("none",) * steps
    moe.set_ep_impl(impl)
    t_run = time.perf_counter()
    try:
        mesh = virtual_mesh(shape, "cuda:0")
        t0 = time.perf_counter()
        placed = place_train(host_params, cfg, mesh)
        opt = init_opt_state(placed)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in tree_leaves(host_params))
        p_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(host_params))
        unique = (sum(placed.nbytes(unique=True).values())
                  + sum(opt.mu.nbytes(unique=True).values())
                  + sum(opt.nu.nbytes(unique=True).values()))
        if unique != p_bytes + 8 * n_params:
            raise AssertionError(f"{cfg.name} {shape}: unique bytes {unique}"
                                 f" != meshless {p_bytes + 8 * n_params}")
        held = {c: placed.nbytes()[c] + opt.mu.nbytes()[c]
                + opt.nu.nbytes()[c] for c in mesh.coords()}
        ranks = len(held)
        rows = batches[0]["tokens"].numel() // shape[0]
        rec = {"model": cfg.name, "layers": cfg.n_layers, "mesh": shape,
               "impl": impl, "place_s": place_s,
               "bytes_a_rank": {str(c): n for c, n in held.items()},
               "bytes_unique": unique, "bytes_meshless": p_bytes + 8 * n_params,
               "steps": []}
        if check_grads:
            calls, undo = _spy_routes(moe)
            try:
                _, _, g = loss_and_grads(placed, cfg, batches[0],
                                         remat="none", mesh=mesh)
            finally:
                undo()
            changes = None
            if cfg.moe is not None:
                changes = _routing_changes(torch, ref["routes"], calls,
                                           shape[1])
                rec["routing_changes"] = changes
            rec["grads"] = _grads_vs_meshless(
                torch, reduce_replicas(g), ref["grads"],
                f"{cfg.name} {shape} {impl}", changes)
            del g, calls
        enc_rows = (batches[0]["frontend_embeds"].shape[:2].numel()
                    // shape[0] if cfg.enc_dec else None)
        for s, batch in enumerate(batches[:steps]):
            want = _predicted_train_launches(
                cfg, shape, rows, torch, remats[s],
                frontend="frontend_embeds" in batch, enc_rows=enc_rows)
            step = make_train_step(cfg, mesh, remat=remats[s])
            for counter in LAUNCH_COUNTERS.values():
                counter.reset()
            ROUTE_LAUNCHES.clear()
            torch.cuda.synchronize()
            resting = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            prof = None
            if s == profile_step:
                placed, opt, m, prof = _profile_train_step(
                    torch, step, placed, opt, batch)
                rec["profile"] = prof
                dt = prof["step_wall_ms"] / 1e3
            else:
                placed, opt, m = step(placed, opt, batch)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            launches = {name: c.n for name, c in LAUNCH_COUNTERS.items()}
            _k1_wgmma_only(launches)
            routes = _only_wgmma_routes(launches)
            got = {k: launches[k] for k in want}
            if got != want:
                raise AssertionError(f"{cfg.name} {shape} {impl} step {s}: "
                                     f"launches {got}, predicted {want}")
            for tree, what in ((placed, "params"), (opt.mu, "mu"),
                               (opt.nu, "nu")):
                _assert_replicas_bitwise(tree, f"{cfg.name} {shape} step "
                                         f"{s} {what}")
            loss, norm = float(m["loss"]), float(m["grad_norm"])
            if not (abs(loss) < float("inf") and abs(norm) < float("inf")):
                raise AssertionError(f"{cfg.name} {shape} step {s}: loss "
                                     f"{loss}, grad_norm {norm}")
            # The ranks share the card, and their work in a step is
            # symmetric: a rank's share of the step's transient is the
            # card's rise over its resting bytes, split evenly.
            rec["steps"].append({
                "loss": loss, "grad_norm": norm, "remat": remats[s],
                "wall_s": dt, "launches": got, "launches_predicted": want,
                "wgmma_routes": routes, "card_resting_gb": resting / 1e9,
                "card_peak_gb": peak / 1e9,
                "peak_a_rank_gb": (max(held.values())
                                   + (peak - resting) / ranks) / 1e9})
        first = rec["steps"][0]
        rec["loss_rel"] = abs(first["loss"] - ref["loss"]) / ref["loss"]
        rec["norm_rel"] = (abs(first["grad_norm"] - ref["grad_norm"])
                           / ref["grad_norm"])
        rec["meshless"] = {k: ref[k] for k in ("loss", "grad_norm")}
        if rec["loss_rel"] > SHARD_LOSS_REL \
                or rec["norm_rel"] > SHARD_NORM_REL:
            raise AssertionError(f"{cfg.name} {shape} {impl}: first step "
                                 f"{first} against meshless {ref['loss']}"
                                 f", {ref['grad_norm']}")
        rec["elapsed_s"] = time.perf_counter() - t_run
        _say(f"sharded train {cfg.name} {shape} {impl}: {json.dumps(rec)}")
        return placed, opt, rec
    finally:
        moe.set_ep_impl("psum")


def time_shard_train_k1(torch, kernels, cfg, shape, rows: int,
                        frontend: bool = False, enc_rows: int = None
                        ) -> dict:
    """K1's work in one sharded train step: every forward GEMM of
    ``_train_k1_gemms`` on random bf16 operands of its shard's shape
    (each its own weight, the LM head's read as ``table.T``) and their
    backward, through ``time_train_gemms``."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    xs = {}
    gemms = []
    for m, k, n, head in _train_k1_gemms(torch, cfg, shape, rows, frontend,
                                         enc_rows):
        if (m, k) not in xs:
            xs[(m, k)] = torch.randn(m, k, device="cuda",
                                     generator=gen).bfloat16()
        w = ((torch.randn(n, k, device="cuda", generator=gen) / k ** 0.5
              ).bfloat16().T if head else
             (torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
              ).bfloat16())
        gemms.append((xs[(m, k)], w))
    out = time_train_gemms(torch, kernels, gemms, gen)
    _say(f"k1 sharded train step ({cfg.name} {shape}, {rows} rows a data "
         f"replica, {len(gemms)} forward GEMMs): {json.dumps(out)}")
    return out


def check_shard_train_kernels(torch, kernels, gen) -> dict:
    """K1 forward, dA and dB at every distinct shard shape of the sharded
    train steps (qwen2.5-0.5b on (2, 2) and (1, 4), phi3.5-moe-42b's
    attention and head on (1, 2)), and K4 forward, dX and K5 at phi's 8
    local experts in training (a 2,048-token "psum" layout and the
    "all_to_all" segments of 1,024 tokens a rank, cap-strided), bf16,
    each against its plain version and on its wgmma route.  K1's bound
    is ``check_k1_train_shapes``': one bf16 ulp plus the larger of
    ``_f32_atol`` and K x 2^-28 of the largest magnitude."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.kernels.grouped_gemm import ROUTE_LAUNCHES
    from repro_torch.models.moe import _capacity

    worst = {"sisa_gemm": 0.0, "grouped_gemm": 0.0, "grouped_gemm_dx": 0.0,
             "grouped_dw": 0.0}
    shapes = set()
    for name, meshes, rows in (("qwen2.5-0.5b", ((2, 2), (1, 4)), 2048),
                               ("phi3.5-moe-42b", ((1, 2),), 2048)):
        cfg = get_config(name)
        for shape in meshes:
            shapes |= set(_train_k1_gemms(torch, cfg, shape,
                                          rows // shape[0]))
    core0 = LAUNCH_COUNTERS["sisa_gemm_core"].n
    for m, k, n, head in sorted(shapes):
        a = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
        b = ((torch.randn(n, k, device="cuda", generator=gen) / k ** 0.5
              ).bfloat16().T if head else
             (torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
              ).bfloat16())
        dc = torch.randn(m, n, device="cuda", generator=gen).bfloat16()
        for what, x, y in (("fwd", a, b), ("dA", dc, b.t()),
                           ("dB", a.t(), dc)):
            ref = kernels.sisa_gemm_plain(x, y)
            # check_k1_train_shapes' bound for a long contraction (the
            # LM head's dA runs over a vocabulary shard): K x 2^-28 of
            # the largest magnitude, where that exceeds _f32_atol.
            atol = max(_f32_atol(ref), x.shape[1] * 2.0 ** -28
                       * ref.float().abs().max().item())
            worst["sisa_gemm"] = max(worst["sisa_gemm"], _max_err(
                f"K1 train shard {what} {m}x{k}x{n}",
                kernels.sisa_matmul(x, y), ref, BF16_REL, atol))
    if LAUNCH_COUNTERS["sisa_gemm_core"].n != core0:
        raise AssertionError("a K1 launch at a sharded training shape took "
                             "the CUDA-core body")
    d, ff, e = MOE_D, MOE_FF, MOE_E
    el, ms = e // 2, 2
    layouts = []
    cap = _capacity(2048, e, 2, 1.25)
    sizes = torch.randint(cap // 2, cap + 1, (el,), device="cuda",
                          generator=gen, dtype=torch.int32)
    sizes[3] = 0
    bm = kernels.flat_block_rows(min(cap, 64), ff, d, torch.bfloat16)
    offs = kernels.flat_group_offsets(sizes, bm)
    layouts.append(("psum 2048 tokens", el * (-(-cap // bm)) * bm,
                    offs[:-1], sizes,
                    torch.arange(el, dtype=torch.int32, device="cuda"), bm))
    cap = _capacity(1024, e, 2, 1.25)
    recv = torch.randint(0, cap + 1, (ms, el), device="cuda", generator=gen,
                         dtype=torch.int32)
    st, sz, gd = kernels.a2a_segments(el, ms, cap, recv)
    layouts.append(("all_to_all 1024 tokens a rank", el * ms * cap, st, sz,
                    gd, kernels.aligned_block_rows(min(cap, 64), ff, d,
                                                   torch.bfloat16,
                                                   align_to=cap)))
    n_cases = 0
    for label, m, starts, sz, gids, bmm in layouts:
        covered = _covered(torch, m, starts, sz)
        for kk, nn in ((d, ff), (ff, d)):
            w = ((torch.randn(el, kk, nn, device="cuda", generator=gen)
                  / kk ** 0.5).bfloat16().requires_grad_())
            x = (torch.randn(m, kk, device="cuda", generator=gen)
                 * covered[:, None]).bfloat16().requires_grad_()
            dy = (torch.randn(m, nn, device="cuda", generator=gen)
                  * covered[:, None]).bfloat16()
            before = dict(ROUTE_LAUNCHES)
            y = kernels.segment_grouped_gemm(x, w, starts, sz, gids,
                                             block_rows=bmm)
            y.backward(dy)
            _wgmma_routed(ROUTE_LAUNCHES, before, (
                "grouped_gemm", "grouped_gemm_dx", "grouped_dw"))
            with torch.no_grad():
                refs = {"grouped_gemm": kernels.segment_grouped_gemm_plain(
                            x, w, starts, sz, gids, block_rows=bmm),
                        "grouped_gemm_dx": kernels.segment_grouped_gemm_plain(
                            dy, w.transpose(1, 2), starts, sz, gids,
                            block_rows=bmm),
                        "grouped_dw": kernels.segment_grouped_dw_plain(
                            x, dy, starts, sz, gids, el)}
            for key, got in (("grouped_gemm", y), ("grouped_gemm_dx", x.grad),
                             ("grouped_dw", w.grad)):
                ref = refs[key]
                if key != "grouped_dw":
                    got, ref = got[covered], ref[covered]
                worst[key] = max(worst[key], _max_err(
                    f"{key} train {label} {kk}x{nn}", got, ref, BF16_REL,
                    _f32_atol(ref)))
            n_cases += 1
    _say(f"phase 19 kernels: K1 forward, dA and dB at the sharded training "
         f"shapes {sorted(shapes)} and K4 forward, dX and K5 at 8 local "
         f"experts ({n_cases} cases: the psum and all_to_all training "
         f"layouts) agree with their plain versions on the wgmma routes "
         f"(max abs err {json.dumps(worst)})")
    return worst


def train_sharded(torch, np, kernels) -> dict:
    """Phase 19 (module doc): qwen2.5-0.5b (``SHARD_TRAIN_LAYERS``) on
    (2, 2) and (1, 4),
    phi3.5-moe-42b (2 layers) on (1, 2) under both EP impls, the elastic
    restart, and K1, K4 and K5 timed at the sharded steps' shapes."""
    import tempfile

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import (opt_state_specs, param_specs,
                                         unshard_tree, virtual_mesh)
    from repro_torch.models import init_params
    from repro_torch.train import make_train_step

    out = {"runs": {}}
    cfg = dataclasses.replace(get_config("qwen2.5-0.5b"),
                              n_layers=SHARD_TRAIN_LAYERS)
    params = init_params(cfg, seed=0)
    data = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ)
    batches = [{k: torch.as_tensor(v) for k, v in data.batch(s).items()}
               for s in range(SHARD_TRAIN_STEPS + 1)]
    state = None
    for shape in SHARD_TRAIN_MESHES:
        ref = _meshless_reference(torch, cfg, params, batches[0], shape[0])
        # (2, 2): the second step profiled, the last under remat="full",
        # whose backward gathers each layer's shards again.
        placed, opt, rec = _run_sharded_train(
            torch, cfg, shape, params, batches, ref, SHARD_TRAIN_STEPS,
            **({"profile_step": 1, "remats": ("none", "none", "full")}
               if shape == (2, 2) else {}))
        del ref
        out["runs"][f"qwen {shape}"] = rec
        if shape == (2, 2):
            state = (placed, opt)
        else:
            del placed, opt
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["k1"] = {shape: time_shard_train_k1(
        torch, kernels, cfg, shape, TRAIN_BATCH * TRAIN_SEQ // shape[0])
        for shape in SHARD_TRAIN_MESHES}
    _say(f"phase 19 K1 timing: {time.perf_counter() - t0:.1f} s")

    # The elastic restart: (2, 2)'s state through a checkpoint onto (1, 2);
    # the meshless step runs from the restored leaves, gathered.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/step_{SHARD_TRAIN_STEPS}"
        ckpt.save(path, SHARD_TRAIN_STEPS, state)
        save_s = time.perf_counter() - t0
        like = state
        del state
        mesh2 = virtual_mesh((1, 2), "cuda:0")
        pspecs = param_specs(params, cfg, mesh2)
        step0, (p2, o2) = ckpt.restore(
            path, like, mesh=mesh2, specs=(pspecs, opt_state_specs(pspecs)))
    del like
    gc.collect()
    torch.cuda.empty_cache()
    _assert_replicas_bitwise(p2, "restored (1, 2) params")
    wp = unshard_tree(p2.shards, p2.specs, mesh2, device="cuda")
    wo = type(o2)(o2.step.clone(), *(unshard_tree(
        t.shards, t.specs, mesh2, device="cuda") for t in (o2.mu, o2.nu)))
    batch = batches[SHARD_TRAIN_STEPS]
    p2, o2, m2 = make_train_step(cfg, mesh2, remat="none")(p2, o2, batch)
    _assert_replicas_bitwise(p2, "(1, 2) params after the restored step")
    del p2, o2
    gc.collect()
    torch.cuda.empty_cache()
    _, _, wm = make_train_step(cfg, remat="none")(
        wp, wo, {k: v.cuda() for k, v in batch.items()})
    del wp, wo
    loss, ref_loss = float(m2["loss"]), float(wm["loss"])
    elastic = {"from": (2, 2), "to": (1, 2), "step": step0,
               "save_s": save_s, "total_s": time.perf_counter() - t0,
               "loss": loss, "meshless_loss": ref_loss,
               "loss_rel": abs(loss - ref_loss) / ref_loss}
    if step0 != SHARD_TRAIN_STEPS or not abs(loss) < float("inf") \
            or elastic["loss_rel"] > SHARD_LOSS_REL:
        raise AssertionError(f"elastic restart: {elastic}")
    out["elastic"] = elastic
    _say(f"phase 19 elastic restart: {json.dumps(elastic)}")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # phi3.5-moe-42b, 2 layers, on (1, 2) under both EP impls.
    moe_cfg = dataclasses.replace(get_config("phi3.5-moe-42b"),
                                  n_layers=TRAIN_LAYERS)
    params = init_params(moe_cfg, seed=0)
    data = SyntheticLM(moe_cfg, TRAIN_BATCH, TRAIN_SEQ)
    batches = [{k: torch.as_tensor(v) for k, v in data.batch(s).items()}
               for s in range(SHARD_MOE_STEPS)]
    ref = _meshless_reference(torch, moe_cfg, params, batches[0], 1)
    for impl in ("psum", "all_to_all"):
        # all_to_all's capacity is per sequence chunk, so its routed
        # token sets (and gradients) are not the meshless step's; its
        # loss and grad_norm are held to the same bounds all the same.
        placed, opt, rec = _run_sharded_train(
            torch, moe_cfg, (1, 2), params, batches, ref, SHARD_MOE_STEPS,
            impl=impl, profile_step=1 if impl == "psum" else None,
            check_grads=impl == "psum")
        out["runs"][f"phi {impl}"] = rec
        del placed, opt
        gc.collect()
        torch.cuda.empty_cache()
    del ref
    t0 = time.perf_counter()
    out["k4"] = time_train_experts(torch, kernels, params, moe_cfg,
                                   TRAIN_BATCH * TRAIN_SEQ, ranks=2)
    _say(f"phase 19 K4/K5 timing: {time.perf_counter() - t0:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out




# Phase 20: the sliding-window, RG-LRU and RWKV6 layers and the vision
# stub on a mesh.  (name, layers or None for all, serving mesh); the
# training runs (name, layers, mesh), at TRAIN_BATCH x TRAIN_SEQ.
# rwkv6-3b serves at 8 of its 32 layers, for the script's time: on (1,
# 4) its 900 launches a decode step at full depth took 60.2 s of the
# phase, 41.2 s at 16 layers.  gemma3-1b and recurrentgemma-2b serve at
# 12 of their 26 layers (two and four pattern periods, every layer kind
# among them) since phase 21 joined: at full depth they took 32.2 and
# 28.8 s.
SHARD20_SERVES = (("gemma3-1b", 12, (1, 2)),
                  ("recurrentgemma-2b", 12, (1, 2)),
                  ("rwkv6-3b", 8, (1, 4)),
                  ("internvl2-76b", INTERNVL_LAYERS, (1, 4)))
SHARD20_TRAIN = (("recurrentgemma-2b", 6, (2, 2)), ("rwkv6-3b", 4, (2, 2)),
                 ("internvl2-76b", 1, (1, 2)))
SHARD20_STEPS = 2
# internvl2-76b's layouts of K2 on (1, 2) and (1, 4): GQA 64/8 cut in two
# and in four.
SHARD20_K2_HEADS = ((32, 4, 128), (16, 2, 128))


def _cfg_at(name, layers):
    from repro_torch.configs import get_config

    cfg = get_config(name)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def check_shard20_kernels(torch, kernels, gen) -> dict:
    """K1 forward, dA and dB at every distinct shard shape of phase 20's
    serves (rows 8 and 208) and training steps (a data replica's rows),
    ``frontend_proj``'s among them, each against its plain version on
    the wgmma route (``check_shard_train_kernels``' bound); K2 at
    internvl2-76b's shard layouts ``SHARD20_K2_HEADS`` on bf16 and int8
    pools against its plain version."""
    from repro_torch.kernels import LAUNCH_COUNTERS

    worst = {"sisa_gemm": 0.0, "paged_attn": 0.0, "paged_attn_int8": 0.0}
    shapes = set()
    for name, layers, shape in SHARD20_SERVES:
        cfg = _cfg_at(name, layers)
        for rows in (8, FRONTEND_ROWS):
            shapes |= set(_train_k1_gemms(torch, cfg, shape, rows,
                                          cfg.frontend is not None))
    for name, layers, shape in SHARD20_TRAIN:
        cfg = _cfg_at(name, layers)
        shapes |= set(_train_k1_gemms(
            torch, cfg, shape, TRAIN_BATCH * TRAIN_SEQ // shape[0],
            cfg.frontend is not None))
    shapes = {(m, k, n, bool(head)) for m, k, n, head in shapes}
    core0 = LAUNCH_COUNTERS["sisa_gemm_core"].n
    for m, k, n, head in sorted(shapes):
        a = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
        b = ((torch.randn(n, k, device="cuda", generator=gen) / k ** 0.5
              ).bfloat16().T if head else
             (torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
              ).bfloat16())
        dc = torch.randn(m, n, device="cuda", generator=gen).bfloat16()
        for what, x, y in (("fwd", a, b), ("dA", dc, b.t()),
                           ("dB", a.t(), dc)):
            ref = kernels.sisa_gemm_plain(x, y)
            atol = max(_f32_atol(ref), x.shape[1] * 2.0 ** -28
                       * ref.float().abs().max().item())
            worst["sisa_gemm"] = max(worst["sisa_gemm"], _max_err(
                f"K1 phase 20 shard {what} {m}x{k}x{n}",
                kernels.sisa_matmul(x, y), ref, BF16_REL, atol))
    if LAUNCH_COUNTERS["sisa_gemm_core"].n != core0:
        raise AssertionError("a K1 launch at a phase 20 shard shape took "
                             "the CUDA-core body")
    for heads in SHARD20_K2_HEADS:
        pos = [0, 15, 16, 47, 100, 150, 200, 255]
        q, pk, pv, table, pos_t = _attn_inputs(torch, gen, torch.bfloat16,
                                               pos, heads=heads)
        for quant in (False, True):
            pools = _int8_pools(kernels, pk, pv) if quant else (pk, pv)
            key = "paged_attn_int8" if quant else "paged_attn"
            worst[key] = max(worst[key], _max_err(
                f"K2 {'int8 ' if quant else ''}{heads}",
                kernels.paged_attention(q, *pools[:2], table, pos_t,
                                        *pools[2:]),
                kernels.paged_attention_plain(q, *pools[:2], table, pos_t,
                                              *pools[2:]),
                BF16_REL, 1e-5))
    _say(f"phase 20 kernels: K1 forward, dA and dB at {len(shapes)} shard "
         f"shapes {sorted(shapes)} on the wgmma route, K2 at GQA "
         f"{SHARD20_K2_HEADS} on bf16 and int8 pools, agree with their "
         f"plain versions (max abs err {json.dumps(worst)})")
    return worst


def check_sharded_small_train(torch, np, label, cfg) -> None:
    """One sharded ``loss_and_grads`` of ``cfg`` (float32) on a virtual
    (2, 2) mesh of the card (kernels) and of the CPU (plain versions),
    from the same weights and batch: the loss within 1e-5, every
    gathered, replica-summed gradient leaf within 1e-4 of its largest
    magnitude (``check_small_train``'s bound: f32 sums in other
    orders)."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import place_train, unshard_tree
    from repro_torch.distributed import virtual_mesh
    from repro_torch.distributed.sharding import reduce_replicas
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.models import init_params
    from repro_torch.train import loss_and_grads

    cpu = init_params(cfg, seed=0, device="cpu")
    batch = SyntheticLM(cfg, 4, 64, DataConfig(seed=1)).batch(0)
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    res = {}
    for dev in ("cpu", "cuda:0"):
        mesh = virtual_mesh((2, 2), dev)
        placed = place_train(cpu, cfg, mesh)
        loss, _, g = loss_and_grads(
            placed, cfg, {k: torch.as_tensor(v) for k, v in batch.items()},
            remat="none", mesh=mesh)
        g = reduce_replicas(g)
        res[dev] = (float(loss), list(_leaves(
            unshard_tree(g.shards, g.specs, mesh))))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = res["cpu"], res["cuda:0"]
    if LAUNCH_COUNTERS["sisa_gemm"].n <= 0:
        raise AssertionError(f"sharded small train ({label}): no K1 launch")
    if not abs(l_gpu - l_cpu) <= 1e-5 * max(1.0, abs(l_cpu)):
        raise AssertionError(f"sharded small train ({label}): loss {l_gpu} "
                             f"on the card, {l_cpu} on the CPU")
    worst = 0.0
    for gg, gc_ in zip(g_gpu, g_cpu, strict=True):
        scale = max(gc_.abs().max().item(), 1e-30)
        worst = max(worst, _max_err(f"sharded small train ({label}) grad",
                                    gg, gc_, 0.0, 1e-4 * scale) / scale)
    _say(f"sharded small train ({label}, f32, 4x64 tokens, (2, 2)): loss "
         f"card {l_gpu} CPU {l_cpu}; {len(g_cpu)} gradient leaves within "
         f"{worst} of their largest (tol 1e-4)")


def serve_sharded_layers(torch, np, kernels, name, layers, shape) -> dict:
    """``name`` at full width (``layers`` of its layers, or all), bf16,
    seeded weights, through slot and paged on a virtual ``shape`` mesh
    of the card beside the engine without a mesh (the qwen workload,
    each warmed at rung 8): K1 and K2 launches of the first decode step
    as the specs predict (``_predicted_launches``), the storage's bytes
    of each part's first holder summing to the meshless engine's, an
    RG-LRU model's ``conv`` equal on every rank, the first decode step's
    logits on the meshless engine's inputs of that step within
    ``SHARDED_REL`` (the drift of the mesh's own serve recorded: a
    random-weight rwkv6-3b in bf16 drifts past it through 32 layers of
    prefill on either side), tokens that agree counted, one
    profiled paged window (``collectives_device_ms``), K1 timed at a
    sharded decode step.  A model with a stub frontend then prefills
    208 rows of ``frontend_embeds`` on the mesh and without it: the
    logits within ``SHARDED_REL``, K1's launches a 208-token prefill's
    plus ``frontend_proj``'s."""
    from repro_torch.distributed import virtual_mesh
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.models import forward_prefill, init_params

    cfg = _cfg_at(name, layers)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    _say(f"params: {cfg.name} full width, {cfg.n_layers} layers, init "
         f"{time.perf_counter() - t0:.2f} s")
    out = {"serves": {}}
    has_global = "attn" in cfg.layer_kinds()
    for kind in ("slot", "paged"):
        need = ("sisa_gemm",) + (("paged_attn",) if kind == "paged"
                                 and has_global else ())
        absent = ("paged_attn", "paged_attn_int8") if not need[1:] else ()
        ref_store, ref_state, store = [], [], []

        def capture_ref(eng):
            _capture_first_step(ref_store, cfg)(eng)
            _capture_step_state(ref_state)(eng)

        ref, _, _, ref_outs = serve_full_width(
            torch, np, cfg, need, params=params, kind=kind, absent=absent,
            warm_rungs=(8,), before_serve=capture_ref)
        ref_bytes = ref.cache.resident_bytes()
        del ref
        eng, _, launches, outs = serve_full_width(
            torch, np, cfg, need, params=params, kind=kind, absent=absent,
            mesh=virtual_mesh(shape, "cuda:0"), warm_rungs=(8,),
            before_serve=_capture_first_step(store, cfg))
        (own, rids, measured), (want, want_rids, _) = store[0], ref_store[0]
        if rids != want_rids:
            raise AssertionError(f"{name} {kind}: first decode step rows "
                                 f"{rids} vs {want_rids}")
        scale = want.abs().max().item()
        got = _mesh_step_from(torch, eng, cfg, ref_state[0])
        err = (got - want).abs().max().item()
        if not err <= SHARDED_REL * scale:
            raise AssertionError(f"{name} {kind} on {shape}: first decode "
                                 f"step's logits from the meshless state "
                                 f"off by {err} > {SHARDED_REL} * {scale}")
        predicted = _predicted_launches(eng, cfg)
        for key, n in predicted.items():
            if measured.get(key, 0) != n:
                raise AssertionError(f"{name} {kind} on {shape}: {key} "
                                     f"{measured.get(key, 0)} launches a "
                                     f"decode step, predicted {n}")
        unique = eng.cache.resident_bytes(unique=True)
        if unique != ref_bytes:
            raise AssertionError(f"{name} {kind} on {shape}: first holders' "
                                 f"bytes {unique}, the meshless {ref_bytes}")
        store_ = eng.cache.pools if kind == "paged" else eng.cache.buffers
        if "conv" in store_ and not all(
                c.equal(store_["conv"].shards[0])
                for c in store_["conv"].shards):
            raise AssertionError(f"{name} {kind}: conv copies differ")
        rec = {"launches_a_step": measured, "predicted": predicted,
               "serve_launches": launches,
               "storage_bytes": _storage_bytes(eng),
               "storage_bytes_unique": unique, "meshless_bytes": ref_bytes,
               "first_step_logits_max_abs_err": err,
               "first_step_logits_rel_to_max": err / scale,
               "own_serve_first_step_rel_to_max":
                   (own - want).abs().max().item() / scale,
               "tokens_agreeing": sum(a == b for o, r in zip(outs, ref_outs)
                                      for a, b in zip(o.tokens, r.tokens)),
               "tokens": sum(len(r.tokens) for r in ref_outs),
               "completions_equal": sum(o.tokens == r.tokens
                                        for o, r in zip(outs, ref_outs))}
        if kind == "paged":
            prof = profile_window(torch, np, eng, cfg, steps=2)
            if prof["queued_after_admission"] or not (
                    prof["collectives_device_ms"]):
                raise AssertionError(f"{name} profiled window: {prof}")
            rec["profile"] = prof
            gemms = _k1_gemms(torch, None, cfg, 8, ranks=eng.params)
            if len(gemms) != predicted["sisa_gemm"]:
                raise AssertionError(f"{len(gemms)} timed GEMMs, "
                                     f"{predicted['sisa_gemm']} a step")
            out["k1"] = time_gemms(torch, kernels, gemms)
            _say(f"k1 sharded decode step {name} {shape} (rung 8, "
                 f"{len(gemms)} GEMMs over the ranks): "
                 f"{json.dumps(out['k1'])}")
        if kind == "slot" and cfg.frontend is not None:
            rec["frontend_prefill"] = _frontend_prefill_on_mesh(
                torch, cfg, params, eng, forward_prefill, LAUNCH_COUNTERS)
        out["serves"][kind] = rec
        _say(f"phase 20 serve {name} {kind} on a virtual {shape} mesh: "
             f"{json.dumps(rec)}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _capture_step_state(store):
    """A ``before_serve`` hook: copies of the first decode step's inputs
    (the storage its rows read, the tables, tokens and positions) taken
    before it runs, with the indices of its live rows, appended to
    ``store``."""
    def hook(eng):
        decode = eng.decode_fn

        def first_step(*args):
            if not store:
                store.append(([_tree_map(lambda t: t.clone(), a)
                               for a in args[1:]],
                              [i for i, r in enumerate(eng._req)
                               if r is not None]))
            return decode(*args)
        eng.decode_fn = first_step
    return hook


def _mesh_step_from(torch, eng, cfg, state):
    """The logits of ``eng``'s decode step (a mesh engine) on a meshless
    engine's first decode step's inputs (``_capture_step_state``), the
    storage laid out by ``cache_specs``: the mesh's arithmetic alone,
    without the drift of its own prefills."""
    from repro_torch.distributed import cache_specs
    from repro_torch.distributed.mesh import Sharded

    (caches, *rest), live = state
    specs = cache_specs(caches, cfg, eng.mesh, batch_axes=())
    sharded = {n: Sharded.of(t, specs[n], eng.mesh)
               for n, t in caches.items()}
    logits, _ = eng.decode_fn(eng.params, sharded, *rest)
    return logits[live, 0, :cfg.vocab_size].float()


def _frontend_prefill_on_mesh(torch, cfg, params, eng, forward_prefill,
                              counters) -> dict:
    """One prefill of ``FRONTEND_ROWS`` rows of seeded
    ``frontend_embeds`` on ``eng``'s mesh and without one: the logits
    within ``SHARDED_REL``, and K1's launches on the mesh those of a
    token prefill of the same rows plus ``frontend_proj``'s (a launch a
    rank a row pass)."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    embeds = torch.randn(1, FRONTEND_ROWS, cfg.frontend_dim, device="cuda",
                         generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, FRONTEND_ROWS),
                           device="cuda", generator=gen)
    runs = {}
    for key, batch in (("tokens", {"tokens": tokens}),
                       ("frontend_embeds", {"tokens": tokens,
                                            "frontend_embeds": embeds})):
        counters["sisa_gemm"].reset()
        logits, _ = forward_prefill(eng.params, cfg, batch, mesh=eng.mesh)
        torch.cuda.synchronize()
        runs[key] = (logits[..., :cfg.vocab_size].float(),
                     counters["sisa_gemm"].n)
    want, _ = forward_prefill(params, cfg, {"tokens": tokens,
                                            "frontend_embeds": embeds})
    want = want[..., :cfg.vocab_size].float()
    got, n = runs["frontend_embeds"]
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    from repro_torch.kernels.ops import row_passes

    proj = (eng.mesh.shape["model"] if _split_over_model(
        eng.params.specs["frontend_proj"]["w"]) else 1) * len(
        row_passes(FRONTEND_ROWS))
    if not torch.isfinite(got).all() or err > SHARDED_REL * scale \
            or n != runs["tokens"][1] + proj:
        raise AssertionError(f"{cfg.name} frontend prefill on the mesh: err "
                             f"{err} of {scale}, K1 {n} launches, a token "
                             f"prefill {runs['tokens'][1]} + {proj}")
    return {"rows": FRONTEND_ROWS, "logits_max_abs_err": err,
            "logits_rel_to_max": err / scale, "k1_launches": n,
            "k1_launches_token_prefill": runs["tokens"][1],
            "frontend_proj_launches": proj}


def train_sharded_layers(torch, kernels) -> dict:
    """``SHARD20_TRAIN``: each model at full width (bf16, seeded weights,
    cut to its layers), ``SHARD20_STEPS`` steps of TRAIN_BATCH x
    TRAIN_SEQ tokens (internvl2's batches carry ``frontend_embeds``)
    through ``_run_sharded_train`` against the meshless port step, and
    K1 timed at each run's sharded step."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params

    out = {"runs": {}, "k1": {}}
    for name, layers, shape in SHARD20_TRAIN:
        cfg = _cfg_at(name, layers)
        params = init_params(cfg, seed=0)
        data = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ)
        batches = [{k: torch.as_tensor(v) for k, v in data.batch(s).items()}
                   for s in range(SHARD20_STEPS)]
        ref = _meshless_reference(torch, cfg, params, batches[0], shape[0])
        placed, opt, rec = _run_sharded_train(
            torch, cfg, shape, params, batches, ref, SHARD20_STEPS,
            profile_step=1)
        del placed, opt, ref
        gc.collect()
        torch.cuda.empty_cache()
        out["runs"][name] = rec
        out["k1"][name] = time_shard_train_k1(
            torch, kernels, cfg, shape, TRAIN_BATCH * TRAIN_SEQ // shape[0],
            frontend=cfg.frontend is not None)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase20(torch, np, kernels, gen) -> dict:
    """Phase 20 (module doc), timed; returns its records."""
    t20 = time.perf_counter()
    out = {"err": check_shard20_kernels(torch, kernels, gen)}
    smalls = {**_small_configs(), **_small_recurrent_configs()}
    for label in ("gemma3 structure", "recurrentgemma structure",
                  "rwkv6 structure", "internvl2 structure"):
        check_sharded_small(torch, np, label, smalls[label])
        check_sharded_small_train(torch, np, label, smalls[label])
    _say(f"phase 20 small models: {time.perf_counter() - t20:.1f} s")
    out["serves"] = {}
    for name, layers, shape in SHARD20_SERVES:
        t0 = time.perf_counter()
        out["serves"][name] = serve_sharded_layers(torch, np, kernels, name,
                                                   layers, shape)
        _say(f"phase 20 {name} serves: {time.perf_counter() - t0:.1f} s")
    out["k2"] = {heads: time_k2(torch, kernels, heads,
                                INTERNVL_LAYERS * (64 // heads[0]))
                 for heads in SHARD20_K2_HEADS}
    for heads, t in out["k2"].items():
        _say(f"k2 sharded decode step internvl2-76b GQA {heads} (8 rows, "
             f"{t['launches_timed']} launches: 8 layers x ranks): "
             f"{json.dumps(t)}")
    t0 = time.perf_counter()
    out["train"] = train_sharded_layers(torch, kernels)
    _say(f"phase 20 training: {time.perf_counter() - t0:.1f} s")
    _say(f"phase 20 (sliding-window, recurrent and frontend layers on a "
         f"mesh) elapsed: {time.perf_counter() - t20:.1f} s")
    return out


# whisper-base on virtual meshes of the card (phase 21): the serves on
# (1, 2) and (1, 4), int8 pools on (1, 2), training on (2, 2), and qwen's
# co-executed serve on (1, 2).  whisper's 8/8 heads split on every such
# mesh; K2 runs GQA 4/4 and 2/2 hd 64 a rank on its 28-page tables.
SHARD21_SERVE_MESHES = ((1, 2), (1, 4))
SHARD21_INT8_MESH = (1, 2)
SHARD21_TRAIN_MESH = (2, 2)
SHARD21_COEXEC_MESH = (1, 2)
SHARD21_STEPS = 2
SHARD21_K2_HEADS = ((4, 4, 64), (2, 2, 64))
# The serves' prefill buckets (the workload's prompts of 16-200 tokens in
# buckets of 8 doubling, up to 256), the decode rung, and the 1,500
# encoder frames of a request.
SHARD21_DEC_ROWS = (8, 16, 64, 128, 256)


def _whisper_serve_k1_shapes(torch, cfg, shape) -> set:
    """K1's ``(m, k, n, head)`` in whisper's sharded serves on ``shape``:
    the decoder's linears (cross q and o among them) at the decode rung
    and the prefill buckets (``SHARD21_DEC_ROWS``), the head at those of
    decode and at a prefill's one row, and ``frontend_proj``, the
    encoder's linears and the cross k and v over 1,500 frames."""
    tl = _tp_linears(torch, cfg, shape)
    frames = cfg.enc_frames
    out = {(frames,) + tl["frontend"][:2] + (False,)}
    out |= {(frames, k, n, False) for layer in tl["encoder"]
            for _, k, n, _ in layer}
    for name, k, n, _ in tl["layers"][0]:
        if name in ("cross k", "cross v"):
            out.add((frames, k, n, False))
        else:
            out |= {(m, k, n, False) for m in SHARD21_DEC_ROWS}
    k, n, _ = tl["head"]
    out |= {(m, k, n, True) for m in (1, 8)}
    return out


def check_shard21_kernels(torch, kernels, gen) -> dict:
    """K1 forward, dA and dB at every distinct whisper shard shape of
    phase 21's serves on ``SHARD21_SERVE_MESHES`` and of its training
    step on ``SHARD21_TRAIN_MESH`` (a data replica's 1,792 tokens and
    6,000 frames), ``frontend_proj`` (K 80) and the tied head's halves
    and quarters among them, against the plain version on the wgmma
    route (``check_shard_train_kernels``' bound); K2 at
    ``SHARD21_K2_HEADS`` on whisper's 28-page tables (rows at 0, on page
    and split edges, full) on bf16 and int8 pools against its plain
    version."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCH_COUNTERS

    cfg = get_config("whisper-base")
    worst = {"sisa_gemm": 0.0, "paged_attn": 0.0, "paged_attn_int8": 0.0}
    shapes = set()
    for shape in SHARD21_SERVE_MESHES:
        shapes |= _whisper_serve_k1_shapes(torch, cfg, shape)
    shapes |= {(m, k, n, bool(head)) for m, k, n, head in
               _train_k1_gemms(
                   torch, cfg, SHARD21_TRAIN_MESH,
                   TRAIN_BATCH * WHISPER_MAX_SEQ // SHARD21_TRAIN_MESH[0],
                   True,
                   TRAIN_BATCH * WHISPER_FRAMES // SHARD21_TRAIN_MESH[0])}
    core0 = LAUNCH_COUNTERS["sisa_gemm_core"].n
    for m, k, n, head in sorted(shapes):
        a = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
        b = ((torch.randn(n, k, device="cuda", generator=gen) / k ** 0.5
              ).bfloat16().T if head else
             (torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
              ).bfloat16())
        dc = torch.randn(m, n, device="cuda", generator=gen).bfloat16()
        for what, x, y in (("fwd", a, b), ("dA", dc, b.t()),
                           ("dB", a.t(), dc)):
            ref = kernels.sisa_gemm_plain(x, y)
            atol = max(_f32_atol(ref), x.shape[1] * 2.0 ** -28
                       * ref.float().abs().max().item())
            worst["sisa_gemm"] = max(worst["sisa_gemm"], _max_err(
                f"K1 phase 21 shard {what} {m}x{k}x{n}",
                kernels.sisa_matmul(x, y), ref, BF16_REL, atol))
    if LAUNCH_COUNTERS["sisa_gemm_core"].n != core0:
        raise AssertionError("a K1 launch at a phase 21 shard shape took "
                             "the CUDA-core body")
    pos = [0, 15, 16, 31, 32, 63, 100, WHISPER_PMAX * 16 - 1]
    for heads in SHARD21_K2_HEADS:
        q, pk, pv, table, pos_t = _attn_inputs(
            torch, gen, torch.bfloat16, pos, n_pages=len(pos) * WHISPER_PMAX,
            pmax=WHISPER_PMAX, heads=heads)
        for quant in (False, True):
            pools = _int8_pools(kernels, pk, pv) if quant else (pk, pv)
            key = "paged_attn_int8" if quant else "paged_attn"
            worst[key] = max(worst[key], _max_err(
                f"K2 {'int8 ' if quant else ''}{heads} 28-page tables",
                kernels.paged_attention(q, *pools[:2], table, pos_t,
                                        *pools[2:]),
                kernels.paged_attention_plain(q, *pools[:2], table, pos_t,
                                              *pools[2:]),
                BF16_REL, 1e-5))
    _say(f"phase 21 kernels: K1 forward, dA and dB at {len(shapes)} whisper "
         f"shard shapes {sorted(shapes)} on the wgmma route, K2 at GQA "
         f"{SHARD21_K2_HEADS} on 28-page tables, bf16 and int8 pools, agree "
         f"with their plain versions (max abs err {json.dumps(worst)})")
    return worst


def serve_sharded_whisper(torch, np, kernels) -> dict:
    """whisper-base at full size (bf16, seeded weights), the qwen workload
    with each request's own seeded (1,500, 80) features (rid 2 sharing
    rid 1's: ``_whisper_features``), through slot and paged on
    ``SHARD21_SERVE_MESHES`` and paged on int8 pools on
    ``SHARD21_INT8_MESH``, each beside the engine without a mesh (warmed
    at rung 8): K1 and K2 launches of the first decode step as the specs
    predict (``_predicted_launches``: 98 and 12 at (1, 2), 196 and 24 at
    (1, 4)), the first holders' storage bytes, the cross stacks or pools
    included, summing to the meshless engine's, ``cross_admits`` and
    ``cross_shared`` the meshless engine's, the first decode step's
    logits on the meshless engine's inputs of that step
    (``_mesh_step_from``) within ``SHARDED_REL``, the tokens that agree
    counted; a paged window on (1, 2) profiled; K1 timed at a sharded
    decode step on each mesh, K2 at ``SHARD21_K2_HEADS`` on bf16 and
    int8 pools."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import virtual_mesh
    from repro_torch.models import init_params

    cfg = get_config("whisper-base")
    params = init_params(cfg, seed=0)
    prepare = _whisper_features(np, cfg)
    out = {"serves": {}, "k1": {}}
    for kind, quant in (("slot", None), ("paged", None), ("paged", "int8")):
        kw = {"kv_quant": quant} if quant else {}
        k2 = "paged_attn_int8" if quant else "paged_attn"
        need = ("sisa_gemm",) + ((k2,) if kind == "paged" else ())
        absent = tuple(n for n in ("paged_attn", "paged_attn_int8")
                       if n not in need)
        ref_store, ref_state = [], []

        def capture_ref(eng):
            _capture_first_step(ref_store, cfg)(eng)
            _capture_step_state(ref_state)(eng)

        ref, _, _, ref_outs = serve_full_width(
            torch, np, cfg, need, params=params, kind=kind, absent=absent,
            warm_rungs=(8,), before_serve=capture_ref, prepare=prepare, **kw)
        ref_bytes = ref.cache.resident_bytes()
        ref_ext = dict(ref.stats["engine"])
        del ref
        gc.collect()
        meshes = SHARD21_SERVE_MESHES if quant is None \
            else (SHARD21_INT8_MESH,)
        for shape in meshes:
            label = f"{kind}{'-int8' if quant else ''} {shape[0]}x{shape[1]}"
            store = []
            eng, _, launches, outs = serve_full_width(
                torch, np, cfg, need, params=params, kind=kind,
                absent=absent, mesh=virtual_mesh(shape, "cuda:0"),
                warm_rungs=(8,), before_serve=_capture_first_step(store, cfg),
                prepare=prepare, **kw)
            (own, rids, measured), (want, want_rids, _) = (store[0],
                                                           ref_store[0])
            if rids != want_rids:
                raise AssertionError(f"whisper {label}: first decode step "
                                     f"rows {rids} vs {want_rids}")
            scale = want.abs().max().item()
            got = _mesh_step_from(torch, eng, cfg, ref_state[0])
            err = (got - want).abs().max().item()
            if not err <= SHARDED_REL * scale:
                raise AssertionError(f"whisper {label}: first decode step's "
                                     f"logits from the meshless state off "
                                     f"by {err} > {SHARDED_REL} * {scale}")
            predicted = _predicted_launches(eng, cfg)
            predicted[k2] = predicted.pop("paged_attn")
            for key, n in predicted.items():
                if measured.get(key, 0) != n:
                    raise AssertionError(f"whisper {label}: {key} "
                                         f"{measured.get(key, 0)} launches "
                                         f"a decode step, predicted {n}")
            unique = eng.cache.resident_bytes(unique=True)
            if unique != ref_bytes:
                raise AssertionError(f"whisper {label}: first holders' bytes "
                                     f"{unique}, the meshless {ref_bytes}")
            ext = eng.stats["engine"]
            cross = {k: (ext[k], ref_ext[k]) for k in
                     ("cross_admits", "cross_shared") if k in ref_ext}
            if any(a != b for a, b in cross.values()) or (
                    kind == "paged" and cross["cross_shared"][0] != 1):
                raise AssertionError(f"whisper {label}: cross blocks (mesh, "
                                     f"meshless) {cross}")
            rec = {"launches_a_step": measured, "predicted": predicted,
                   "serve_launches": launches,
                   "storage_bytes": _storage_bytes(eng),
                   "storage_bytes_unique": unique,
                   "meshless_bytes": ref_bytes, "cross_blocks": cross,
                   "first_step_logits_max_abs_err": err,
                   "first_step_logits_rel_to_max": err / scale,
                   "own_serve_first_step_rel_to_max":
                       (own - want).abs().max().item() / scale,
                   "tokens_agreeing": sum(
                       a == b for o, r in zip(outs, ref_outs)
                       for a, b in zip(o.tokens, r.tokens)),
                   "tokens": sum(len(r.tokens) for r in ref_outs),
                   "completions_equal": sum(o.tokens == r.tokens for o, r
                                            in zip(outs, ref_outs))}
            if (kind, quant, shape) == ("paged", None, SHARD21_INT8_MESH):
                prof = profile_window(torch, np, eng, cfg, steps=2)
                if prof["queued_after_admission"] or not (
                        prof["collectives_device_ms"]):
                    raise AssertionError(f"whisper profiled window: {prof}")
                rec["profile"] = prof
            if (kind, quant) == ("paged", None):
                gemms = _k1_gemms(torch, None, cfg, 8, ranks=eng.params)
                if len(gemms) != predicted["sisa_gemm"]:
                    raise AssertionError(f"{len(gemms)} timed GEMMs, "
                                         f"{predicted['sisa_gemm']} a step")
                out["k1"][shape] = time_gemms(torch, kernels, gemms)
                _say(f"k1 sharded decode step whisper-base {shape} (rung 8, "
                     f"{len(gemms)} GEMMs over the ranks): "
                     f"{json.dumps(out['k1'][shape])}")
            out["serves"][label] = rec
            _say(f"phase 21 serve whisper-base {label}: {json.dumps(rec)}")
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["k2"] = {}
    for heads in SHARD21_K2_HEADS:
        for quant in (False, True):
            t = time_k2(torch, kernels, heads,
                        cfg.n_layers * (cfg.n_kv_heads // heads[1]),
                        quant=quant, pmax=WHISPER_PMAX)
            out["k2"][(heads, quant)] = t
            _say(f"k2 sharded decode step whisper-base GQA {heads} "
                 f"({'int8' if quant else 'bf16'} pools, 8 rows, "
                 f"{WHISPER_PMAX}-page tables, {t['launches_timed']} "
                 f"launches: 6 layers x ranks): {json.dumps(t)}")
    return out


def train_sharded_whisper(torch, kernels) -> dict:
    """whisper-base at full size (bf16, seeded weights), ``SHARD21_STEPS``
    steps of ``TRAIN_BATCH`` x (1,500 frames, 448 tokens) on
    ``SHARD21_TRAIN_MESH`` through ``_run_sharded_train`` against the
    meshless port step (loss, ``grad_norm``, every gradient leaf, the
    cross-attention key biases' exact-zero gradients as noise; launches
    a step as ``_predicted_train_launches``; replicas bitwise; unique
    bytes; peaks),
    and K1 timed at the step's shapes."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params

    cfg = get_config("whisper-base")
    shape = SHARD21_TRAIN_MESH
    params = init_params(cfg, seed=0)
    data = SyntheticLM(cfg, TRAIN_BATCH, WHISPER_FRAMES)
    batches = [{k: torch.as_tensor(v) for k, v in data.batch(s).items()}
               for s in range(SHARD21_STEPS)]
    ref = _meshless_reference(torch, cfg, params, batches[0], shape[0])
    placed, opt, rec = _run_sharded_train(
        torch, cfg, shape, params, batches, ref, SHARD21_STEPS)
    del placed, opt, ref, params
    gc.collect()
    torch.cuda.empty_cache()
    rows = TRAIN_BATCH * WHISPER_MAX_SEQ // shape[0]
    k1 = time_shard_train_k1(torch, kernels, cfg, shape, rows, True,
                             TRAIN_BATCH * WHISPER_FRAMES // shape[0])
    return {"run": rec, "k1": k1}


def serve_coexec_mesh(torch, np, ref_outs, ref_stats) -> dict:
    """qwen2.5-0.5b at full width, the 16 requests of ``serve_coexec`` on
    8 slots through paged on ``SHARD21_COEXEC_MESH`` with
    ``coexec_backend="kernel"``, beside phase 7's meshless co-executed
    serve (``ref_outs``, ``ref_stats``): backfills, packed prefills,
    ``coexec_tiles``, ``coexec_interleave`` and batches equal (the
    packer's schedule), the tokens that agree counted."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import virtual_mesh

    cfg = get_config("qwen2.5-0.5b")
    lens = PROMPT_LENS + PROMPT_LENS[::-1]
    eng, params, launches, outs = serve_full_width(
        torch, np, cfg, ("sisa_gemm", "paged_attn"), lens=lens,
        coexec_backend="kernel", mesh=virtual_mesh(SHARD21_COEXEC_MESH,
                                                   "cuda:0"))
    stats = {k: eng.stats[k] for k in COEXEC_STATS}
    if stats != ref_stats or stats["backfilled"] <= 0:
        raise AssertionError(f"co-executed serve on {SHARD21_COEXEC_MESH}: "
                             f"{stats}, meshless {ref_stats}")
    rec = {"mesh": SHARD21_COEXEC_MESH, "stats": stats,
           "launches": launches,
           "tokens_agreeing": sum(a == b for o, r in zip(outs, ref_outs)
                                  for a, b in zip(o.tokens, r.tokens)),
           "tokens": sum(len(r.tokens) for r in ref_outs),
           "completions_equal": sum(o.tokens == r.tokens
                                    for o, r in zip(outs, ref_outs))}
    _say(f"phase 21 co-executed serve qwen2.5-0.5b on a virtual "
         f"{SHARD21_COEXEC_MESH} mesh: {json.dumps(rec)}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase21(torch, np, kernels, gen, coexec_outs, coexec_stats) -> dict:
    """Phase 21 (module doc), timed; returns its records."""
    t21 = time.perf_counter()
    out = {"err": check_shard21_kernels(torch, kernels, gen)}
    _say(f"phase 21 kernels: {time.perf_counter() - t21:.1f} s")
    t0 = time.perf_counter()
    out["serve"] = serve_sharded_whisper(torch, np, kernels)
    _say(f"phase 21 whisper serves: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["train"] = train_sharded_whisper(torch, kernels)
    _say(f"phase 21 whisper training: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["coexec"] = serve_coexec_mesh(torch, np, coexec_outs, coexec_stats)
    _say(f"phase 21 co-executed serve: {time.perf_counter() - t0:.1f} s")
    _say(f"phase 21 (whisper-base and co-execution on a mesh) elapsed: "
         f"{time.perf_counter() - t21:.1f} s")
    return out


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port's package is missing ({exc}); run "
              "from the root of a checkout", file=sys.stderr)
        return 1
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    threading.excepthook = _record_thread_error
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    _say(smi)
    t0 = time.perf_counter()

    def lap(label):
        _say(f"elapsed after {label}: {time.perf_counter() - t0:.1f} s")

    secs = _build.build()
    _say(f"build: {json.dumps(secs)}, {time.perf_counter() - t0:.2f} s wall")

    wgmma_build_report(_build)
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1_err = check_k1(torch, kernels, gen)
    k1_bwd_err = check_k1_backward(torch, kernels, gen)
    k2_err = check_k2(torch, kernels, gen)
    kernels.grouped_gemm.ROUTE_LAUNCHES.clear()
    k4_err = check_k4(torch, kernels, gen)
    k45_err = check_k4_dx_and_k5(torch, kernels, gen)
    k2_int8_err = check_k2_int8(torch, kernels, gen)
    k3_err = check_k3(torch, kernels, gen)
    k7_err = check_k7(torch, kernels, gen)
    k6_err = check_k6(torch, kernels, gen)
    lap("the kernel checks")
    gc.collect()
    torch.cuda.empty_cache()
    for label, small in _small_configs().items():
        check_small_model(torch, np, label, small)
        check_small_train(torch, np, label, small)
    for label, small in _small_recurrent_configs().items():
        check_small_model(torch, np, label, small)
        check_small_train(torch, np, label, small)
    small = _small_enc_dec_config()
    check_small_enc_dec(torch, np, "whisper structure", small)
    check_small_train(torch, np, "whisper structure", small)
    lap("the small models")

    cfg = get_config("qwen2.5-0.5b")
    eng, params, launches, flt_outs = serve_full_width(
        torch, np, cfg, ("sisa_gemm", "paged_attn"))
    profile_window(torch, np, eng, cfg)
    serve_dense(torch, np, cfg, params, flt_outs)
    lap("qwen2.5-0.5b paged and dense serves")
    serve_online(torch, np, cfg, params)
    lap("qwen2.5-0.5b online serves")
    run_launchers(torch)
    eng8, int8_launches, k2_pool_err = serve_int8(torch, np, kernels, cfg,
                                                  params, eng, flt_outs)
    del eng8
    lap("the launchers and the int8 serve")
    _, coexec_outs, coexec_stats = serve_coexec(torch, np, cfg, params)
    lap("qwen2.5-0.5b co-execution serves")
    k1 = time_k1(torch, kernels, params, cfg, rows=8)
    k1_prefill = time_k1(torch, kernels, params, cfg, rows=208)
    k2 = time_k2(torch, kernels, layers=cfg.n_layers)
    k2_int8 = time_k2_int8(torch, kernels, layers=cfg.n_layers)
    k2_phi = time_k2(torch, kernels, K2_HEADS[1], MOE_LAYERS)
    k2_phi_int8 = time_k2_int8(torch, kernels, K2_HEADS[1], MOE_LAYERS)
    k3 = time_k3(torch, kernels, params, cfg)
    _say(f"k1 decode step (rung 8, {k1['gemms']} GEMMs): {json.dumps(k1)}")
    _say(f"k1 prefill (208 rows, LM head on 1 row): {json.dumps(k1_prefill)}")
    _say(f"k2 decode step (8 rows, {k2['launches_timed']} layers): "
         f"{json.dumps(k2)}")
    _say(f"k2 int8 decode step (8 rows, {k2_int8['launches_timed']} "
         f"layers): {json.dumps(k2_int8)}")
    _say(f"k2 phi3.5-moe-42b layout decode step (8 rows, GQA 32/8 hd 128, "
         f"{k2_phi['launches_timed']} layers): {json.dumps(k2_phi)}")
    _say(f"k2 int8 phi3.5-moe-42b layout decode step (8 rows, "
         f"{k2_phi_int8['launches_timed']} layers): "
         f"{json.dumps(k2_phi_int8)}")
    _say(f"k3 decode step (rung 8, {k3['gemms']} GEMMs, slabs of "
         f"{K3_BK}): {json.dumps(k3)}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    lap("qwen2.5-0.5b")

    k2_gemma = serve_gemma3(torch, np, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    lap("gemma3-1b")
    recurrent = {}
    for name in RECURRENT_BYTES:
        recurrent[name] = serve_recurrent(torch, np, kernels, name)
        gc.collect()
        torch.cuda.empty_cache()
        lap(name)

    k6_launches = drive_k6(torch, kernels)
    k6 = {}
    for name in _k6_scenarios():
        for dtype in (torch.bfloat16, torch.float32):
            t = time_k6(torch, kernels, name, dtype,
                        plain=dtype == torch.bfloat16)
            k6[(name, t["dtype"])] = t
            _say(f"k6 {name} {t['dtype']} (fused vs {t['tenants']} "
                 f"sequential launches): {json.dumps(t)}")
            gc.collect()
            torch.cuda.empty_cache()
    k7 = time_k7(torch, kernels, cap=2)
    k7_ragged = time_k7(torch, kernels, cap=37)
    k7_train = time_k7(torch, kernels, cap=320)
    _say(f"k7 decode capacity (E 16, C 2, up/gate/down): {json.dumps(k7)}")
    _say(f"k7 ragged capacity (E 16, C 37, up/gate/down): "
         f"{json.dumps(k7_ragged)}")
    _say(f"k7 training capacity (E 16, C 320, up/gate/down): "
         f"{json.dumps(k7_train)}")
    gc.collect()
    torch.cuda.empty_cache()
    lap("K6 and K7")

    moe_cfg = dataclasses.replace(get_config("phi3.5-moe-42b"),
                                  n_layers=MOE_LAYERS)
    eng, params, moe_launches, _ = serve_full_width(torch, np, moe_cfg,
                                                    KERNEL_NAMES)
    profile_window(torch, np, eng, moe_cfg)
    k4 = time_k4(torch, kernels, params, moe_cfg, n_tokens=8)
    k4_prefill = time_k4(torch, kernels, params, moe_cfg, n_tokens=208)
    _say(f"k4 decode step (rung 8, {k4['launches_timed']} launches): "
         f"{json.dumps(k4)}")
    _say(f"k4 prefill (208 tokens, {k4_prefill['launches_timed']} "
         f"launches): {json.dumps(k4_prefill)}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    lap("phi3.5-moe-42b serve")

    train_cfg = dataclasses.replace(get_config("phi3.5-moe-42b"),
                                    n_layers=TRAIN_LAYERS)
    trainer, out, train_launches, _ = train_full_width(torch, train_cfg)
    params, opt_state = out["params"], out["opt_state"]
    del out
    profile_train_step(torch, trainer, params, opt_state)
    del opt_state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    time_train_k1(torch, kernels, params, train_cfg,
                  rows=TRAIN_BATCH * TRAIN_SEQ)
    train_t = time_train_experts(torch, kernels, params, train_cfg,
                                 n_tokens=TRAIN_BATCH * TRAIN_SEQ)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    lap("phi3.5-moe-42b training")

    internvl = serve_internvl2(torch, np, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    lap("internvl2-76b serve")
    trained = {}
    for name, layers in FULL_TRAIN:
        trained[name] = train_model(torch, kernels, name, layers)
        gc.collect()
        torch.cuda.empty_cache()
        lap(f"{name} training")
    whisper = serve_whisper(torch, np, kernels)
    lap("whisper-base serve")
    whisper_train = train_whisper(torch, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    lap("whisper-base training")

    t18 = time.perf_counter()
    shard_err = check_shard_kernels(torch, kernels, gen)
    smalls = _small_configs()
    for label in ("qwen2.5-0.5b widths", "phi3.5-moe structure"):
        check_sharded_small(torch, np, label, smalls[label])
    sharded = serve_sharded_qwen(torch, np, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    sharded_phi = serve_sharded_phi(torch, np, kernels)
    check_sharded_fault(torch, np, smalls["qwen2.5-0.5b widths"])
    shard_k2 = {
        "qwen": time_k2(torch, kernels, SHARD_K2_HEADS[0],
                        2 * cfg.n_layers),
        "qwen_int8": time_k2_int8(torch, kernels, SHARD_K2_HEADS[0],
                                  2 * cfg.n_layers),
        "phi2": time_k2(torch, kernels, SHARD_K2_HEADS[1], 2 * MOE_LAYERS),
        "phi4": time_k2(torch, kernels, SHARD_K2_HEADS[2], 4 * MOE_LAYERS)}
    for key, t in shard_k2.items():
        _say(f"k2 sharded decode step {key} (8 rows, GQA {t['heads']}, "
             f"{t['launches_timed']} launches: the layers x ranks): "
             f"{json.dumps(t)}")
    gc.collect()
    torch.cuda.empty_cache()
    _say(f"phase 18 (sharded serving) elapsed: "
         f"{time.perf_counter() - t18:.1f} s")
    lap("phase 18: sharded serving")
    shard_serve = sharded["serves"]

    t19 = time.perf_counter()
    train_shard_err = check_shard_train_kernels(torch, kernels, gen)
    sharded_train = train_sharded(torch, np, kernels)
    _say(f"phase 19 (sharded training) elapsed: "
         f"{time.perf_counter() - t19:.1f} s")
    lap("phase 19: sharded training")
    st_runs = sharded_train["runs"]
    p20 = phase20(torch, np, kernels, gen)
    lap("phase 20: sliding-window, recurrent and frontend layers on a mesh")
    p20_serves, p20_train = p20["serves"], p20["train"]
    p21 = phase21(torch, np, kernels, gen, coexec_outs, coexec_stats)
    lap("phase 21: whisper-base and co-execution on a mesh")
    p21_serves, p21_train = p21["serve"]["serves"], p21["train"]

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi)
    print(json.dumps({"kernels": [
        {"name": "sisa_gemm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sisa_gemm.cu",
         "replaces": "src/repro/kernels/sisa_gemm.py:95",
         "note": "launches: the qwen2.5-0.5b paged serve; times: one "
                 "qwen2.5-0.5b decode step (rung 8); <model>_decode_* one "
                 "decode step (rung 8) and <model>_prefill_* one 2048-row "
                 "prefill of recurrentgemma-2b and rwkv6-3b, whose serves "
                 "launched it <model>_serve_launches times (slot, "
                 "sequential, paged); internvl2_decode_* one decode step, "
                 "internvl2_prefill_* one 208-row prefill of image "
                 "features and internvl2_frontend_proj_* its "
                 "frontend_proj alone, of internvl2-76b's 8-layer serve; "
                 "<model>_train_fwd_* "
                 "and _bwd_* one train step's forward and backward GEMMs "
                 "(8 x 256 tokens) of the full-width training runs, which "
                 "launched it <model>_train_launches times in 6 steps; "
                 "whisper_decode_* one whisper-base decode step (rung 8), "
                 "whisper_encoder_* one request's 1,500-frame encoder with "
                 "the cross K/V projections and whisper_frontend_proj_* "
                 "its frontend_proj (K 80) alone, of the serves that "
                 "launched it whisper_serve_launches times (slot, "
                 "sequential, paged on bf16 and on int8 pools); "
                 "whisper_train_* one step of 8 x (1,500 frames, 448 "
                 "tokens); shard_<d>x<m>_* one qwen2.5-0.5b decode step "
                 "(rung 8) at the shard widths of a virtual (d, m) mesh, "
                 "every rank's GEMMs; shard_<kind>_<mesh>_launches its "
                 "sharded serves'; shard_train_<d>x<m>_fwd_*/_bwd_* one "
                 "qwen2.5-0.5b train step's forward and backward GEMMs "
                 "(12 layers, 8 x 256 tokens) at the shard widths of a "
                 "virtual (d, m) "
                 "mesh, every replica's and rank's, and "
                 "shard_train_<run>_launches_a_step a sharded train "
                 "step's launches; shard20_<model>_decode_* one decode "
                 "step (rung 8) of phase 20's sharded paged serve of that "
                 "model (gemma3-1b's and recurrentgemma-2b's 12 layers "
                 "on (1, 2), "
                 "rwkv6-3b's 8 layers and internvl2-76b's 8 on (1, 4)), "
                 "shard20_<model>_<kind>_launches its slot and paged "
                 "serves'; shard20_train_<model>_fwd_*/_bwd_* one train "
                 "step's GEMMs (8 x 256 tokens) of phase 20's runs "
                 "(recurrentgemma-2b 6 layers and rwkv6-3b 4 on (2, 2), "
                 "internvl2-76b 1 layer with frontend_proj on (1, 2)) and "
                 "shard20_train_<model>_launches_a_step their steps'; "
                 "shard21_whisper_<d>x<m>_decode_* one whisper-base "
                 "decode step (rung 8, every rank's GEMMs) of phase 21's "
                 "sharded paged serve on that mesh, "
                 "shard21_whisper_<serve>_launches phase 21's whisper "
                 "serves' (slot and paged on (1, 2) and (1, 4), paged on "
                 "int8 pools on (1, 2)); shard21_train_whisper_fwd_*/"
                 "_bwd_* one whisper-base train step's GEMMs (8 x (1,500 "
                 "frames, 448 tokens)) on (2, 2), every replica's and "
                 "rank's, and shard21_train_whisper_launches_a_step its "
                 "steps'; shard21_coexec_launches the co-executed qwen "
                 "serve on (1, 2)",
         "launches": launches["sisa_gemm"],
         "max_abs_err": max(k1_err, k1_bwd_err, shard_err["sisa_gemm"],
                            train_shard_err["sisa_gemm"],
                            p20["err"]["sisa_gemm"],
                            p21["err"]["sisa_gemm"]),
         **{k: k1[k] for k in keys},
         **{f"shard21_whisper_{a}x{b}_decode_{k}":
            p21["serve"]["k1"][(a, b)][k] for a, b in SHARD21_SERVE_MESHES
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
         **{f"shard21_whisper_{label.replace(' ', '_')}"
            "_launches": rec["serve_launches"]["sisa_gemm"]
            for label, rec in p21_serves.items()},
         **{f"shard21_train_whisper_{part}_{k}": p21_train["k1"][part][k]
            for part in ("fwd", "bwd")
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
         "shard21_train_whisper_launches_a_step":
             p21_train["run"]["steps"][0]["launches"]["sisa_gemm"],
         "shard21_coexec_launches": p21["coexec"]["launches"]["sisa_gemm"],
         **{f"shard20_{name.split('-')[0]}_decode_{k}": rec["k1"][k]
            for name, rec in p20_serves.items()
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
         **{f"shard20_{name.split('-')[0]}_{kind}_launches":
            rec["serves"][kind]["serve_launches"]["sisa_gemm"]
            for name, rec in p20_serves.items() for kind in ("slot", "paged")},
         **{f"shard20_train_{name.split('-')[0]}_{part}_{k}":
            p20_train["k1"][name][part][k]
            for name in p20_train["k1"] for part in ("fwd", "bwd")
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
         **{f"shard20_train_{name.split('-')[0]}_launches_a_step":
            rec["steps"][0]["launches"]["sisa_gemm"]
            for name, rec in p20_train["runs"].items()},
         **{f"shard_train_{a}x{b}_{part}_{k}":
            sharded_train["k1"][(a, b)][part][k]
            for a, b in SHARD_TRAIN_MESHES for part in ("fwd", "bwd")
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
         **{f"shard_train_{name.replace(' ', '_').replace(',', '')}_"
            "launches_a_step": rec["steps"][0]["launches"]["sisa_gemm"]
            for name, rec in st_runs.items()},
         **{f"shard_{a}x{b}_{k}": sharded["k1"][(a, b)][k]
            for a, b in SHARD_MESHES
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
         **{f"shard_{name.replace(' ', '_').replace(',', '')}_launches":
            rec["serve_launches"]["sisa_gemm"]
            for name, rec in shard_serve.items()},
         **{f"{name.split('-')[0]}_{step}_{k}": rec["k1"][rows][k]
            for name, rec in recurrent.items()
            for step, rows in (("decode", 8), ("prefill", 2048))
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
         **{f"{name.split('-')[0]}_serve_launches": [
             rec["serves"][kind]["launches"]["sisa_gemm"]
             for kind in ("slot", "sequential", "paged")]
            for name, rec in recurrent.items()},
         **{f"internvl2_{what}_{k}": internvl["k1"][what][k]
            for what in ("decode", "prefill", "frontend_proj")
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
         **{f"{name.split('-')[0]}_train_{part}_{k}": rec["k1"][part][k]
            for name, rec in trained.items() for part in ("fwd", "bwd")
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
         **{f"{name.split('-')[0]}_train_launches":
            rec["summary"]["launches"]["sisa_gemm"]
            for name, rec in trained.items()},
         **{f"whisper_{part}_{k}": whisper["k1"][part][k]
            for part in ("decode", "encoder", "frontend_proj")
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
         "whisper_serve_launches": [
             whisper["serves"][kind]["launches"]["sisa_gemm"]
             for kind in ("slot", "sequential")] + [
             whisper["paged"]["serves"][pool]["launches"]["sisa_gemm"]
             for pool in ("bf16", "int8")],
         **{f"whisper_train_{part}_{k}": whisper_train["k1"][part][k]
            for part in ("fwd", "bwd")
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
         "whisper_train_launches":
             whisper_train["summary"]["launches"]["sisa_gemm"]},
        {"name": "paged_attn", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
         "replaces": "src/repro/kernels/paged_attn.py:88",
         "note": "shard_qwen_* one qwen2.5-0.5b decode step on a (1, 2) "
                 "mesh (GQA 7/1 hd 64, 48 launches), shard_phi2_*/phi4_* "
                 "phi3.5-moe-42b's 8 layers on (1, 2)/(1, 4) (16/4 and 8/2 "
                 "hd 128), shard_paged_<mesh>_launches the sharded paged "
                 "serves'; "
                 "times: one qwen2.5-0.5b decode step (24 launches); "
                 "phi_* at phi3.5-moe-42b's layout (8 launches); gemma3_* "
                 "at gemma3-1b's (4 launches, 7 rows, pmax 64), launches "
                 "from its paged serve; internvl2_* at internvl2-76b's "
                 "(GQA 64/8 hd 128, 8 launches), launches from its 8-layer "
                 "paged serve; whisper_* at whisper-base's (GQA 8/8 hd "
                 "64, 6 launches, 8 rows, 28-page tables), launches from "
                 "its paged serve on bf16 pools; shard20_internvl2_<h>_<hkv>_* "
                 "at internvl2-76b's (1, 2) and (1, 4) shard layouts (GQA "
                 "32/4 and 16/2 hd 128, 16 and 32 launches: 8 layers x "
                 "ranks), shard20_<model>_paged_launches phase 20's "
                 "sharded paged serves' (gemma3-1b on (1, 2): its global "
                 "layers on gathered pools, internvl2-76b on (1, 4)); "
                 "shard21_whisper_<h>_<hkv>_* at whisper-base's (1, 2) and "
                 "(1, 4) shard layouts (GQA 4/4 and 2/2 hd 64, 28-page "
                 "tables, 12 and 24 launches: 6 layers x ranks), "
                 "shard21_whisper_paged_<mesh>_launches phase 21's sharded "
                 "paged serves' on bf16 pools",
         "launches": launches["paged_attn"],
         "max_abs_err": max(k2_err, shard_err["paged_attn"],
                            p20["err"]["paged_attn"],
                            p21["err"]["paged_attn"]),
         **{f"shard21_whisper_{h}_{hkv}_{k}":
            p21["serve"]["k2"][((h, hkv, hd), False)][k]
            for h, hkv, hd in SHARD21_K2_HEADS
            for k in ("ms", "plain_ms", "bound_ms")},
         **{f"shard21_whisper_paged_{a}x{b}_launches":
            p21_serves[f"paged {a}x{b}"]["serve_launches"]["paged_attn"]
            for a, b in SHARD21_SERVE_MESHES},
         **{k: k2[k] for k in keys},
         **{f"phi_{k}": k2_phi[k] for k in ("ms", "bound_ms")},
         **{f"gemma3_{k}": k2_gemma[k] for k in (
             "ms", "plain_ms", "bound_ms", "serve_launches")},
         **{f"internvl2_{k}": internvl["k2"][k]
            for k in ("ms", "plain_ms", "bound_ms")},
         "internvl2_serve_launches": internvl["k2_serve_launches"],
         **{f"whisper_{k}": whisper["paged"]["k2"]["bf16"][k]
            for k in ("ms", "plain_ms", "bound_ms")},
         "whisper_serve_launches":
             whisper["paged"]["serves"]["bf16"]["k2_launches"],
         **{f"shard_{key}_{k}": shard_k2[key][k]
            for key in ("qwen", "phi2", "phi4")
            for k in ("ms", "plain_ms", "bound_ms")},
         **{f"shard20_internvl2_{h}_{hkv}_{k}": p20["k2"][(h, hkv, hd)][k]
            for h, hkv, hd in SHARD20_K2_HEADS
            for k in ("ms", "plain_ms", "bound_ms")},
         "shard20_internvl2_paged_launches":
             p20_serves["internvl2-76b"]["serves"]["paged"][
                 "serve_launches"]["paged_attn"],
         "shard20_gemma3_paged_launches":
             p20_serves["gemma3-1b"]["serves"]["paged"][
                 "serve_launches"]["paged_attn"],
         **{f"shard_paged_{a}x{b}_launches":
            shard_serve[f"paged ({a}, {b})"]["serve_launches"]["paged_attn"]
            for a, b in SHARD_MESHES}},
        {"name": "grouped_gemm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/grouped_gemm.cu",
         "replaces": "src/repro/kernels/grouped_gemm.py:160",
         "note": "shard_ep<r>_*: one phi3.5-moe-42b decode step (rung 8, 8 "
                 "layers) with E / r local experts a rank (3 launches a "
                 "layer a rank); shard_<impl>_launches: its paged serve on "
                 "a virtual (1, 2) mesh under that EP impl; "
                 "shard_train_ep2_*: one train step's forward (2 layers, "
                 "2,048 tokens) at 8 local experts a rank, and "
                 "shard_train_<impl>_launches_a_step a step of the (1, 2) "
                 "training run under that impl",
         "launches": moe_launches["grouped_gemm"],
         "max_abs_err": max(k4_err, shard_err["grouped_gemm"],
                            train_shard_err["grouped_gemm"]),
         **{f"shard_train_ep2_{k}": sharded_train["k4"]["k4_fwd"][k]
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
         **{f"shard_train_{impl}_launches_a_step":
            st_runs[f"phi {impl}"]["steps"][0]["launches"]["grouped_gemm"]
            for impl in ("psum", "all_to_all")},
         **{k: k4[k] for k in keys},
         **{f"shard_ep{r}_{k}": sharded_phi[f"k4_{r}"][k] for r in (2, 4)
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
         **{f"shard_{impl}_launches": sharded_phi[impl]["grouped_gemm"]
            for impl in ("psum", "all_to_all")}},
        {"name": "grouped_gemm_dx", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/grouped_gemm.cu",
         "replaces": "src/repro/kernels/grouped_gemm.py:160",
         "note": "K4's backward: dX = dY W^T through the same kernel's "
                 "TRANS_B bodies (the VJP at grouped_gemm.py:301-310); "
                 "launches and times from the training run; "
                 "shard_train_ep2_* at 8 local experts a rank and "
                 "shard_train_<impl>_launches_a_step, as grouped_gemm's",
         "launches": train_launches["grouped_gemm_dx"],
         "max_abs_err": max(k45_err["dx"],
                            train_shard_err["grouped_gemm_dx"]),
         **{k: train_t["k4_dx"][k] for k in keys},
         **{f"shard_train_ep2_{k}": sharded_train["k4"]["k4_dx"][k]
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
         **{f"shard_train_{impl}_launches_a_step":
            st_runs[f"phi {impl}"]["steps"][0]["launches"][
                "grouped_gemm_dx"] for impl in ("psum", "all_to_all")}},
        {"name": "grouped_dw", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/grouped_dw.cu",
         "replaces": "src/repro/kernels/grouped_gemm.py:186",
         "note": "shard_train_ep2_* at 8 local experts a rank and "
                 "shard_train_<impl>_launches_a_step, as grouped_gemm's",
         "launches": train_launches["grouped_dw"],
         "max_abs_err": max(k45_err["dw"], train_shard_err["grouped_dw"]),
         **{k: train_t["k5"][k] for k in keys},
         **{f"shard_train_ep2_{k}": sharded_train["k4"]["k5"][k]
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
         **{f"shard_train_{impl}_launches_a_step":
            st_runs[f"phi {impl}"]["steps"][0]["launches"]["grouped_dw"]
            for impl in ("psum", "all_to_all")}},
        {"name": "paged_attn_int8", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
         "replaces": "src/repro/kernels/paged_attn.py:88",
         "note": "K2's quant=True branch: int8 pools with bf16 scale "
                 "planes; shard_qwen_* at qwen2.5-0.5b's (1, 2) shard "
                 "layout (GQA 7/1, 48 launches); "
                 "launches from the kv_quant='int8' serve; phi_* "
                 "at phi3.5-moe-42b's layout; whisper_* at whisper-base's "
                 "(GQA 8/8 hd 64, 6 launches, 28-page tables), launches "
                 "from its int8 paged serve; shard21_whisper_<h>_<hkv>_* "
                 "at whisper-base's shard layouts (GQA 4/4 and 2/2 hd 64, "
                 "12 and 24 launches), shard21_whisper_int8_launches "
                 "phase 21's int8 paged serve on (1, 2)",
         "launches": int8_launches["paged_attn_int8"],
         "max_abs_err": max(k2_int8_err, k2_pool_err,
                            shard_err["paged_attn_int8"],
                            p20["err"]["paged_attn_int8"],
                            p21["err"]["paged_attn_int8"]),
         **{f"shard21_whisper_{h}_{hkv}_{k}":
            p21["serve"]["k2"][((h, hkv, hd), True)][k]
            for h, hkv, hd in SHARD21_K2_HEADS
            for k in ("ms", "plain_ms", "bound_ms")},
         "shard21_whisper_int8_launches": p21_serves[
             "paged-int8 %dx%d" % SHARD21_INT8_MESH]["serve_launches"][
             "paged_attn_int8"],
         **{k: k2_int8[k] for k in keys},
         **{f"phi_{k}": k2_phi_int8[k] for k in ("ms", "bound_ms")},
         **{f"whisper_{k}": whisper["paged"]["k2"]["int8"][k]
            for k in ("ms", "plain_ms", "bound_ms")},
         **{f"shard_qwen_{k}": shard_k2["qwen_int8"][k]
            for k in ("ms", "plain_ms", "bound_ms")},
         "whisper_serve_launches":
             whisper["paged"]["serves"]["int8"]["k2_launches"]},
        {"name": "coexec", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/coexec.cu",
         "replaces": "src/repro/kernels/coexec.py:209",
         "note": "launches: coexec_matmul on the packer's placement of the "
                 "four scenarios (bf16); times: mixed_serving, bf16; "
                 "<scenario>_* the other three, bf16",
         "launches": k6_launches, "max_abs_err": k6_err,
         **{k: k6[("mixed_serving", "bfloat16")][k] for k in keys},
         **{f"{name}_{k}": k6[(name, "bfloat16")][k]
            for name in ("decode_batch", "narrow_proj", "moe_dispatch")
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")}},
        {"name": "sisa_gemm_splitk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sisa_gemm.cu",
         "replaces": "src/repro/kernels/sisa_gemm.py:111",
         "note": "launches and times: one qwen2.5-0.5b decode step's 168 "
                 "projections through sisa_gemm_splitk, one wgmma launch "
                 "each (no partials, no sum; the partials' route issued "
                 "three kernels a GEMM, 504), slabs of 256",
         "launches": k3["launches"], "max_abs_err": k3_err,
         **{k: k3[k] for k in keys}},
        {"name": "moe_gemm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/moe_gemm.cu",
         "replaces": "src/repro/kernels/moe_gemm.py:22",
         "note": "launches and times: phi3.5-moe-42b's up, gate and down "
                 "expert GEMMs at decode capacity 2 through "
                 "moe_grouped_gemm; c37_*, c320_* at capacities 37, 320",
         "launches": k7["launches"], "max_abs_err": k7_err,
         **{k: k7[k] for k in keys},
         **{f"c37_{k}": k7_ragged[k] for k in ("ms", "library_ms")},
         **{f"c320_{k}": k7_train[k] for k in ("ms", "library_ms")}},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. device probe: needs ``torch.cuda.is_available()``; prints the card's
   ``nvidia-smi`` name and power limit; float32 matmuls without TF32;
   the caching allocator maps expandable segments (as the ``train``
   launcher asks; full-width hymba training fills ~71 of the card's
   79 GiB, and split blocks of the earlier phases must not strand the
   rest).
2. build: compiles every CUDA kernel of the port from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel).
3. kernels: each kernel against its plain PyTorch version at the serve
   path's full-width shapes (H=14, KV=2, Dh=64, BS=8, M=32, B=4,
   T in {1, 16, 32}) plus ragged edge cases and contexts of up to 239
   keys (four 64-key tiles, global and windowed), and the speculative
   verify shape (``paged_attention_multi``, B 4 x T 4 and T 2 ending at
   the decode contexts), in float32 and bfloat16; float32 within 2e-5, bfloat16
   within 2e-2, the K/V row write bit-exact.  Times each with CUDA
   events beside the plain version, a library call and its bound.  The
   K/V row write is timed twice: the wrapper called directly with an
   int32 mask, and ``ops.paged_kv_write`` with the step's bool mask (what
   a model layer pays), each beside ``index_copy_``.
4. serve: full-width qwen2.5-0.5b (24 layers, seeded random init) through
   the launcher's ``serve`` with its defaults; every request must retire
   and every kernel must have launched.  Then ``serve --controller``'s
   shadow scoring (``launch.serve.shadow_admission``, what ``serve``
   runs after its report) under ``tv_gate:delta=0.05,mode=downweight``
   over the retired requests: the verdicts and the
   ``serve_shadow_admission_total`` counters sum to the requests,
   ``fused_logprob`` launches once a request, every TV finite.
5. parity: the same width at 2 layers, dense weights scaled x3 so that
   random-init output varies, on ``cpu`` (plain path) and ``cuda``
   (kernels): one decode and one varlen model pass with logits within
   1e-4; greedy and sampled serving (the same Gumbel noise on both)
   with equal token streams and log_beta within 1e-4.
6. log-prob kernels: ``fused_logprob`` against the plain forward and
   ``fused_logprob_bwd`` against autograd of it, at the learner's shape
   (N = 512 rows, V = 151936) and a ragged one (37 x 1000), float32 and
   bfloat16, with targets at 0 and V-1 and a row padded with -1e30.
   logp within 1e-5, entropy 1e-4, bfloat16 2e-2; the gradient within
   1e-5 (bfloat16 2e-2) of its largest magnitude.  Timed beside the
   plain version, ``F.cross_entropy`` (logp only) as the yardstick, and
   the bound.
7. train: ``repro_torch.launch.train rlvr --full-width`` in-process with
   2 warmup steps and one phase of 2 minibatches; both log-prob kernels
   must launch once on every learner step, and ``flash_attention`` with
   its backward once a layer on every warmup and learner step (24
   ``flash_attention_bwd`` a step) beside each generate's prefill.
8. full-width step: one ``make_update_step`` on a generated minibatch
   with rewards drawn from a seed (nonzero advantages): finite loss,
   grad norm > 0, params moved; the kernels' logp, entropy and
   d logits on that step's own logits against the plain versions.
9. train parity: the same width at 2 layers, one warmup step and one
   VACO learner step (filter active) on ``cpu`` and ``cuda``: losses,
   tv, frac_filtered and grad norm within 1e-4 (relative); the update
   each AdamW step made to the params within 1e-2 in L2 norm, and no
   entry of the updates further apart than 2 x lr.

10. V-trace kernel: ``vtrace`` against ``ref_vtrace`` at the paper's
    shape (B = 500 trajectories, T = 1000 steps), the JAX sweep shapes
    (1, 5), (4, 13), (8, 64), (13, 100), the scan's tile and lane edges
    (T = 1, 31, 32, 33, 1000 at B 1, 4096), B = 4224 and rows of nothing
    but episode ends, with episode ends (zero discounts), log-ratios of
    +-3 (both clips bite) and (rho_bar, c_bar, lam) = (1, 1, 1) and (2,
    0.5, 0.95), from float32 and bfloat16 inputs; within 1e-5 (bfloat16
    5e-2) of max(1, |ref|).  Timed at 500 x 1000 beside the plain version
    and the bound; no single PyTorch call computes the recurrence, so no
    library time.  Then device time against B and T
    (``vtrace_scaling``).
11. rl: ``repro_torch.launch.train rl`` in-process at the paper's scale
    (500 actors x 1000 steps, a 4-snapshot mixture) with the launcher's
    defaults (VACO, ``backward_mixture``, ``pass_through``) for 2
    phases: finite returns and metrics, ``vtrace`` launched once per
    phase, the policy moved.  Then one collection and one learner phase
    of 100 actors x 100 steps (the paper's 500 x 1000, cut in depth for
    time),
    each timed and profiled (device busy / idle share).
12. rl parity: hidden 64, 8 actors x 32 steps, on ``cpu`` and ``cuda``
    with the same draws: one ``collect_rollout`` over a 4-slot mixture
    (obs, actions, log_beta within 1e-4 of max(1, |cpu|), equal slots
    and dones), then one VACO ``train_phase`` (1 epoch, 4 minibatches,
    filter active): losses, tv, frac_filtered and grad norm within 1e-4
    relative, the param update within 1e-2 in L2 norm.

13. WKV6 kernels: every instantiation of ``wkv6`` (``serial``,
    ``chunked``, ``split``, each forced) against ``ref_wkv6`` at the
    rwkv6 serve path's shapes (B 8, H 32, K = V = 64: the S = 32 prefill
    from a zero state, one S = 1 decode step from a carried state), B 8
    x S 512, the long forward's layer (``long_b1``: B 1 x S 2048), the
    16-step sub-chunk's edges (S 63, 64, 65, 129), a ragged last segment
    (S 1000), decays mixing exact 0s, exact 1s and 1e-6, the JAX sweep
    shapes (K = V in 16, 32, 64, 8), a ragged S = 50 and near-total
    forgetting (w = 1e-6); float32 within 3e-4 and bfloat16 within 2e-2,
    of max(1, |ref|).  The four timed cases take the instantiation
    ``wkv6_impl`` picks (``impl`` in the record), beside the plain
    version and the bound; no single PyTorch call computes the
    recurrence, so no library time.  Then the crossover: all three
    instantiations' device time, forced, at B 1 to 8 over S 4 to 2048
    (S 4, 16, 64, 256, 2048)
    (``wkv6_crossover``).
14. rwkv6 serve: ``repro_torch.launch.serve --engine static --arch
    rwkv6-1.6b --full-width --batch 8 --max-new-tokens 16`` in-process
    (24 layers, d 2048, vocab 65536, seeded random init, float32): one
    warm ``generate``, then the timed one, in which ``wkv6`` must launch
    24 x (1 prefill + 16 decode steps) = 408 times; every row gets its
    tokens and finite ``log_beta``.  Prefill ms, tokens/s, peak memory
    and the device idle share over a profiled ``generate``; then one
    forward at B 1 x S 2048 (24 ``wkv6`` launches), its wall, device
    busy time and ``wkv6``'s share (``rwkv_long_forward``).
15. rwkv6 parity: the same width at 2 layers, dense weights scaled x3,
    on ``cpu`` (plain path) and ``cuda`` (kernel): forward logits within
    1e-4 and the returned cache within 1e-4 of max(1, |cpu|); greedy
    generation token-exact; sampled generation with the same Gumbel
    noise gives equal streams and log_beta within 1e-4.

16. flash attention and selective-scan kernels: ``flash_attention``
    against ``ref_attention`` at hymba's prefill (B 8, S 32, 25 q / 5 kv
    heads of 64, window 1024 and global), at B 1 x S 2048 (window 1024
    and global; qwen's 14 / 2 heads global), past the window (S 1100),
    at qwen's widths (the RLVR generation prefill, B 64 x S 32, and a
    windowed ragged S 300), at S 1, 63 and 65, and on the JAX sweep's
    shapes (D 8 to 64, ragged S); float32 within 2e-5 and bfloat16
    within 3e-2.  Each timed record names the instantiation that ran
    (``impl``: ``tf32`` for float32 and ``wgmma`` for bfloat16 at D 64
    and 128, ``fma`` at D 8, 16 and 32) and
    takes its device time from that kernel's profiled name.  ``ssm_scan`` against
    ``ref_ssm_scan`` at hymba's prefill (B 8, S 32, I 3200, N 16, zero
    state), one decode step (S 1, carried state), B 8 x S 512 and the
    long forward's layer (``long_b1``: B 1 x S 2048, zero state), all
    timed; untimed checks of b_t / c_t read in place as slices of one
    ``[B, S, dt_rank + 2N]`` tensor, S either side of the crossover, a
    ragged last chunk (of 32 and of 64 steps), decays that underflow to
    0 (dt x 200), a carried state at S 2048, the JAX sweep's shapes and
    a ragged I 300; within 2e-4 (bfloat16 2e-2) of max(1, |ref|).  Each
    record names the instantiation that ran (``impl``: ``serial`` or
    ``chunked``, with its ``chunk`` steps).  Then the crossover: both
    instantiations' device time, forced, at B 1 to 8 over S 64 to 2048
    (B 1, 2, 4, 8)
    (``ssm_crossover``).  Each timed beside its plain version
    and bound, flash also beside ``F.scaled_dot_product_attention``
    (timed only); no single PyTorch call computes the scan, so no
    library time for it.
    (Phases 7-9 run qwen's generation prefill through ``flash_attention``
    too: phase 7 checks 24 launches per ``generate``, exactly.)
17. hymba serve: ``repro_torch.launch.serve --engine static --arch
    hymba-1.5b --full-width --batch 8 --max-new-tokens 16`` in-process
    (32 layers, d 1600, vocab 32001, seeded random init, float32): one
    warm ``generate``, then the timed one, in which ``flash_attention``
    must launch 32 times (the prefill) and ``ssm_scan`` 32 x (1 + 16) =
    544 times; every row gets its tokens, finite ``log_beta`` and
    values.  Tokens/s, prefill ms, decode step ms, peak memory and the
    device idle share over a profiled ``generate``; then one forward at
    B 1 x S 2048, timed and profiled (flash's device time per windowed
    and per global layer, ``ssm_scan``'s per kernel of its chunked
    instantiation), in which each of the two kernels launches 32 times.
18. hymba parity: the same width at 2 layers, dense weights scaled x3,
    on ``cpu`` (plain path) and ``cuda`` (kernels): forward logits
    within 2e-4 + 1e-4 |cpu| elementwise and the returned caches (K/V
    rows, SSM state, conv window) within 1e-4 of max(1, |cpu|), at S 32
    and at B 1 x S 1100 (past the 1024 window); greedy generation
    token-exact; sampled generation with the same Gumbel noise gives
    equal streams and log_beta within 1e-4.  (The card with the plain
    attention in the kernel's place is as far from the CPU at S 1100:
    ``tests/test_torch_cuda.py``'s hymba logits-gap test.)

19. serve-producer RLVR: ``repro_torch.launch.train rlvr --full-width
    --producer serve --forced-lag 2 --controller
    "tv_gate:delta=0.05,mode=downweight"`` in-process, cut as phase 7 is
    (2 warmup steps, one phase of 2 minibatches): every item's tokens
    carry the one version ``resolve_lagged(-2)`` gave when it was
    produced; the three paged kernels launched; ``fused_logprob_bwd``
    once a learner step, ``fused_logprob`` once a learner step and once
    a TV-gate scoring, ``flash_attention`` once a layer for each no-grad
    forward (scorings and eval prefills) and, with ``flash_attention_bwd``,
    for each warmup and learner step; finite warmup loss, tv,
    weights and grad norms, and the params moved.  Generation tokens/s
    over the ``produce`` spans, learner step ms, the engine's swaps,
    each item's lag; then one more minibatch timed and one profiled
    (device idle share).
20. swap parity: 2 layers at full width, dense weights scaled x3, one
    engine over a ``PolicyStore`` (``swap_interval=1``) on ``cpu``
    (plain path) and on ``cuda`` (kernels), a second policy published
    before step 4: greedy and sampled (the same Gumbel noise on both)
    give equal token streams, equal per-token versions (a request spans
    the swap) and one swap each, each engine serving the ring's own
    tensors (no copy); log_beta within 1e-4.

21. threaded classic RL: ``train rl --runtime threaded`` in-process at
    100 actors x 100 steps (the paper's 500 x 1000 cut in depth for
    time; VACO) for 3 phases with
    K 4 and K 1, beside ``backward_mixture`` at K 4: every consumed
    item's ``log_beta`` within 1e-5 (of max(1, |ref|)) of its actions
    re-scored, step by step, under a copy of the version it is stamped
    with, and further than that from the version next to it (the check
    against torn weights, able to tell versions apart); ``vtrace`` once
    a phase; the producer thread joined, no producer error.  Consumed
    env steps per second of each run to its last eval (and the
    producer's own rate), the lag histogram.
22. threaded serve-producer RLVR: ``train rlvr --full-width --producer
    serve --runtime threaded --controller
    "tv_gate:delta=0.05,mode=downweight"`` in-process (2 warmup steps,
    one phase of 3 minibatches, in-flight swaps every round, rewards
    drawn from a seed so every learner step moves the weights): every
    token whose whole history (prompt prefill, earlier tokens) ran under
    one version within 1e-4 of its re-scoring on a copy of that version
    and further from the version before; at least one trajectory spans
    two versions (a swap changes the weights, not the KV cache, so a
    spanning request's later tokens are not re-scorable by one
    version); the kernels launched as in phase 19; the thread joined.
    Generation tokens/s, learner step p50, swaps, lags, peak memory;
    then one more minibatch timed and profiled (device idle share).
23. figure harnesses: each ``repro_torch.experiments`` runner's ``main``
    on a grid cut for time (fig3 at 100 x 100, the paper's 500 x 1000
    cut in depth: pendulum, vaco, K 1 and 4, 1 seed, 2 phases; fig4 at
    48 rollout steps; fig11 at K 8, the realignment ablation at K 16,
    the delta and rho sweeps at their two ends (deltas 0.05 and 0.4,
    rho 1 and 8), each at its own scale, pendulum, 1 seed, 2 phases;
    fig5 ``--full-width`` with N 1 and 2, 1 phase, 4 warmup steps):
    each report finite with its reference's keys, its kernel launched.
24. the learner controllers: ``train rlvr --full-width --producer serve
    --forced-lag 2`` in-process (2 warmup steps, 2 minibatches, rewards
    drawn from a seed) under ``gac``, ``stable_async:var_max=0.5`` and
    ``asympo``: GAC's cosine of every stale step within 1e-5 of a
    float64 one of the same gradients and anchor on the host; the loss
    weights and ``item.meta`` recomputed on the CPU by fresh controllers
    from the same arrays, equal (plumbing and determinism: their parity
    with JAX is ``tests/test_torch_controllers.py``'s);
    ``fused_logprob`` once a step (twice, and ``flash_attention`` once a
    layer more, under ``stable_async``'s scoring), its backward once;
    ``flash_attention`` and its backward once a layer a step.
    Then on one more minibatch: the learner step timed, and with GAC's
    transform between its halves; ``_score_log_pi``'s ``fused_logprob``
    within 1e-5 of the plain version on the same logits.
25. chaos: the threaded serve producer at full width under the chaos
    bench's plan, read from ``results/BENCH_chaos.json`` (a producer
    crash, a 7.5 s engine stall past the 3 s request deadline, a NaN
    publish, a queue stall, a poisoned learner step), watchdog 2, 5
    phases x 3 minibatches, beside a fault-free run of the same seed
    from one warm start: it completes; no page, refcount or thread
    leaks; no quarantined version put or consumed; restarts 1, timeouts
    >= 1, quarantined 1, non-finite 1; the final evals reported, not
    gated.
26. checkpoints: phase 24's last params saved by ``train rlvr
    --checkpoint-dir`` (1.98 GB) and served by ``launch.serve
    --checkpoint --full-width``: leaves bit-equal, greedy tokens equal
    to the in-memory params'; a reduced-width ``learner_nan`` run on the
    card restores from ``--guard-checkpoint-dir``.
27. speculative serve: ``repro_torch.launch.serve --engine continuous
    --full-width --runtime versioned --speculate 4 --draft version:-1``
    in-process, greedy, 8 requests x 16 tokens: v0 alone drafts for
    itself, so acceptance must be exactly 1.0; the verify pass launches
    the varlen kernel at T 4 (``paged_attention_multi``) once a layer a
    round.  Then over a store of v0 and v1 = v0's dense weights x 1.01
    (v1 serves, v0 drafts, pinned): sampled (temperature 1.0, 8
    requests of 8-32 tokens; acceptance, tokens/s, the draft-lag
    histogram, T 4 launches, a profiled repeat's idle share; every
    request retires, no page leaks) and greedy against plain greedy
    serving of v1 (token agreement; a divergence must sit at a top-2
    logit gap under 1e-3 of a dense forward).  Then 2 layers at full
    width, dense x3, a draft of dense x3.3: greedy speculative equal to
    plain greedy on the CPU and on the card, equal acceptance counts
    card and CPU; sampled on the same injected draws, equal tokens and
    counts, log_beta within 1e-4.
28. prefix cache: ``benchmarks.bench_serve.run_best_of``'s run shape at
    full width (2 prompts x best-of 4, greedy, unshared and cached
    engines, a warm pair then 4 pairs): token-exact, and the bench's
    token counts exactly (``results/BENCH_serve.json``: 56 / 17 prefill
    rows, 7 copy-on-write copies, hit rates 0.975 / 0.825); the cached
    engine with ``speculate_k=3`` token-exact too; no page leaks;
    tokens/s of each.
29. RLVR through both: phase 19's cell with ``engine_prefix_cache=True``
    and ``engine_speculate_k=2`` in ``RLVRHyperparams``: prefix hits and
    fewer prefill rows a minibatch than phase 19's, every token's
    ``log_beta`` within 1.43e-5 of its re-scoring on v0 (under forced
    lag every token and its whole history ran under v0), both log-prob
    kernels once a learner step (the gate's scoring twice); generation
    tokens/s, acceptance and the learner step p50 beside phase 19's.
    The draft is the served v0 here, so every draft is accepted: this
    phase covers the draft pool, the verify shape and the cache, and
    phase 27's lagged and 2-layer runs cover rejection.

30. backward kernels: ``flash_attention_bwd`` and ``ssm_scan_bwd`` against
    their plain backwards (``ref_attention_backward`` on the forward's own
    output and logsumexp, ``ref_ssm_scan_backward``) and against autograd
    of the plain forwards, float32 within 2e-5 (flash) / 2e-4 (scan) and
    bfloat16 within 2e-2, of max(1, |ref|): hymba's learner shape (B 64 x
    S 40; 25 / 5 heads of 64, window 1024; the scan's b_t / c_t as
    column slices of ``x_proj``'s output), qwen's 14 / 2 heads, S 1, a
    ragged S 37 with a carried state, B 1 x S 2048 (windowed 1024 and
    global; the scan from zero), small sweeps; the scan held to autograd
    up to S 64.  The learner shapes (both dtypes) and the long ones
    (float32) timed beside the plain version and the bound; flash also
    beside ``F.scaled_dot_product_attention``'s backward (timed only).
31. hymba training: ``repro_torch.launch.train rlvr --full-width --arch
    hymba-1.5b`` in-process (32 layers, d 1600, 2 warmup steps, one
    phase of 2 minibatches): ``ssm_scan_bwd`` and ``flash_attention_bwd``
    32 times a warmup or learner step, both log-prob kernels once a
    learner step; finite loss and tv, grad norm > 0.  Then one learner
    step with seeded rewards: exactly those launches, the params moved,
    its wall, idle share and peak memory (allocated and reserved);
    learner step p50 and generation tokens/s of the run.
32. hymba train parity: phase 9 at 2 full-width hymba layers with dense
    weights x3 (losses, tv, frac_filtered, grad norm within 1e-4
    relative; the updates as phase 9 holds them), the card's learner step
    from the CPU's warmed params.  The chained step (from the card's
    own warm params) is recorded, not gated, under ``chained``: its gap
    to the CPU through the kernels and with the plain attention and
    scan in their place on the card (both miss these limits alike:
    AdamW's first step sends near-zero gradient entries to +-lr, and
    dense x3 makes the next step feel it).  Then one B 1 x S 2100
    forward and backward (past the 2048-token threshold: the CPU's
    chunked plain attention against the card's kernels), loss and every
    param grad within 1e-4 of its largest magnitude.

33. wkv6 backward kernel: ``wkv6_bwd`` against ``ref_wkv6_backward`` and
    against autograd of ``ref_wkv6`` (up to S 64), float32 within 3e-4
    and bfloat16 within 2e-2, of max(1, |ref|), each instantiation
    (``chunked``; ``split`` with ~3 segments) forced at every case and
    the picked one: the learner shape (B 64 x S 40, 32 heads of 64, zero
    state), B 8 x S 32, S 1, a ragged S 37 with a carried state and a
    final-state cotangent, decays of exactly 0 and 1 (and 1e-6), B 1 x S
    2048, S 150 (sub-chunk starts in device scratch), S 1000 over many
    segments, K 8, 16 and 32; two launches on the same inputs
    bit-identical.  The learner shape and B 1 x S 2048 (both dtypes)
    timed beside the plain backward and the bound (no single PyTorch
    call computes it), with each kernel's registers, spills and
    residency and the call's kernels by device time; the forward at the
    learner shape (``chunked``), row 7's learner line; then the
    ``wkv6_bwd_crossover`` records (both instantiations forced, B 1-8 x
    S 64, 256, 2048, and the split's segment length at B 1 x S 2048).
34. rwkv6 training: ``repro_torch.launch.train rlvr --full-width --arch
    rwkv6-1.6b`` in-process (24 layers, d 2048, vocab 65536, 2 warmup
    steps, one phase of 2 minibatches): ``wkv6_bwd`` 24 times a warmup
    or learner step, ``wkv6`` 24 times a step and 24 x (1 + new tokens)
    a generate, exactly; both log-prob kernels once a learner step;
    finite loss and tv; the learner steps' grad norm exactly 0 when the
    random init earned no reward (every advantage 0), else > 0.  Then
    one learner step with N(0, 1) advantages on seeded completions the
    model did not sample (``log_beta`` their log-probs under the current
    params; on its own samples p ~ 1 and the gradient is ~1e-8): exactly
    those launches (24, 24, 1, 1), grad norm > 0, the params moved, its
    wall, idle share and peak memory (allocated and reserved); learner
    step p50 and generation tokens/s of the run.  The step's gradient
    again through the kernels and with ``ops.wkv6`` on the plain
    forward and backward on the card: grad norm at least 1e-3 and within
    1e-4 of the plain route's; and on every layer's own inputs and
    output cotangent of that step, each output of ``wkv6_bwd`` within
    3e-4 of its largest magnitude from ``ref_wkv6_backward`` in float64,
    and du within 1e-5 of it.
35. rwkv6 train parity: phase 9 at 2 full-width rwkv6 layers, the card's
    learner step from the CPU's warmed params (as phase 32 holds hymba,
    but unscaled: with dense weights x3 float32 cannot hold this
    gradient to 1e-4, as ``chip_smoke.py --grad-conditioning`` measures
    against float64; the chained step's plain route swaps ``ops.wkv6``
    for ``ref_wkv6`` too), then one B 1 x S 2048 forward and backward (the card's split
    forward and split backward; the CPU's ``WKV6Fn`` on the plain
    versions), loss and every param grad within 1e-4 of its largest
    magnitude.

36. head dim 128: ``flash_attention`` against ``ref_attention`` at
    qwen2.5-14b's batched-prefill shape (B 8 x S 32, 40 / 8 heads),
    codeqwen1.5-7b's (32 / 32), a ragged S 37 and B 1 x S 2048 global
    (operations-bound), each timed beside the plain version, SDPA (timed
    only) and the bound, plus S 1 and windowed cases, and with the
    logsumexp at four of them (the logsumexp within 1e-5 of
    ``ref_attention_lse``, a bfloat16 output there within 2e-2 of max(1,
    |plain|)); then
    ``paged_attention`` (decode), ``paged_attention_varlen`` (T 16) and
    ``paged_kv_write`` (bit-exact, directly and through
    ``ops.paged_kv_write``) at both head geometries, timed the same way;
    float32 within 2e-5, bfloat16 within 2e-2.
37. qwen2.5-14b serve: full width (48 layers, d 5120, 40 / 8 heads of
    128, vocab 152064, 14.77 B params, seeded random init, float32)
    with the launcher's defaults (8 prompts, 4 slots, 128 blocks of 8,
    16 tokens, greedy: the launcher's own draws at the floor
    temperature, with each token's untempered log-prob as
    ``log_beta``), one set of params through three
    continuous engines: chunked prefill, ``--no-chunked-prefill`` and
    ``--no-batch-prefill``.  Equal tokens, but at a step where the
    chunked engine's top-2 log-prob gap is under 1e-4 (each such step
    printed); the first tokens' log-probs within 1e-4; ``flash_attention``
    48 x each batched engine's prefill dispatches and the varlen kernel
    never there, the chunked engine the reverse; tokens/s, TTFT, the
    batched engine's idle share over its first wave of 4 prompts (a
    profiled repeat's kernel time over an unprofiled one's wall), peak
    memory, the parameter count.  Then one 2,048-token prompt through a
    batched engine on the same weights (4 new tokens): ``flash_attention``
    exactly 48 launches, the first token's untempered log-prob within
    1e-4 of the same forward with the plain attention on the card,
    flash's device share of that forward and the peak memory.
38. codeqwen1.5-7b serve: full width (32 layers, d 4096, 32 / 32 heads
    of 128, vocab 92416) through the launcher's ``serve
    --no-chunked-prefill``: every request retires, ``flash_attention``
    32 x the prefill dispatches.
39. batched parity: 2 layers of qwen2.5-14b's widths (the math
    tokenizer's vocab), dense weights x3, ``cpu`` against ``cuda``: the
    prefill ``forward`` with a right-padding mask (logits within 1e-4,
    K/V rows within 1e-5 of their largest magnitude; a mask with a hole
    raises on the card), then the batched engine greedy and sampled on
    the same noise: equal tokens and prefill counts, log_beta within
    1e-4, pools within 1e-5 of their largest magnitude.

40. head dim 256: ``flash_attention`` (float32 ``flash_kernel_d256``,
    bfloat16 ``flash_kernel_wgmma256``) against ``ref_attention`` at
    gemma3-12b's batched-prefill shape (B 8 x S 32, 16 / 8 heads) and
    B 1 x S 2048 global and with a window of 1024 (timed beside the
    plain version, SDPA and the bound), S 1, ragged and windowed cases,
    the logsumexp at three of them; then ``paged_attention`` (split over
    the context) at contexts 45/17/64/33, past a window of 1024, at B 1
    over 2,064 keys global and windowed (all timed) and at contexts 0 /
    1 / 2,080 (each decode case called twice for the same bits),
    ``paged_attention_varlen`` (on the tensor cores, split over the
    context) at T 16 near and past the window and at phase 41's last
    chunked round of the long prompt, 64 rows at position 1,984, global
    and past a window of 1024 (timed; each varlen case called twice for
    the same bits), and ``paged_kv_write`` (4 rows, KV 8, bit-exact);
    float32 within 2e-5, bfloat16 within 2e-2 (the paged kernels' of
    max(1, |plain|)).
41. gemma3-12b serve: full width (48 layers, d 3840, 16 / 8 heads of
    256, d_ff 15360, vocab 262144, softcap 30, window 1024 on five
    layers of six, 11.77 B params, seeded random init, float32) with
    the launcher's defaults through the chunked, batched and unbatched
    continuous engines and the static engine, then one 2,048-token
    prompt through the chunked and batched engines (16 new tokens past
    position 1,024).  Each run against the same run with the plain
    attention on the card: equal greedy tokens but at a top-2 log-prob
    gap under 1e-4, first-token log-probs within 1e-4; launches (flash
    48 a batched prefill dispatch), peak memory, the batched engine's
    idle share (its profile must show the split decode kernel), flash's
    share of the long prefill, the long prompt's decode ms a token after
    the first, and one batched decode round past position 2,048
    profiled: device ms a step and the split decode's share.
42. gemma3 parity: the reduced gemma3-12b at head dim 256, dense
    weights x3, ``cpu`` against ``cuda``: 32-token prompts, 16 new
    tokens (past the window of 16) through the chunked and batched
    engines and the static ``generate``: equal greedy tokens, log_beta
    within 1e-4.

Then one JSON line of every phase's wall seconds and the total, one of
every kernel's numbers (``paged_attention_multi``'s launches are phase
27's first run's; the hymba backward kernels' phase 31's, ``wkv6_bwd``'s
phase 34's; ``flash_attention_d128`` is ``flash_attention`` at head dim
128, its numbers phase 36's at qwen2.5-14b's prefill shape, its
launches phase 37's batched engine's; the ``_d256`` rows are the three
attention kernels at head dim 256, their numbers phase 40's, their
launches phase 41's runs with the kernels together), the ``nvidia-smi``
line, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# Read when the CUDA allocator starts, so set before torch is imported.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, published
# Operations a second: float32 on the FMA pipes, bf16 tensor cores, and
# float32 as 3xTF32 on the tensor cores (495 TFLOP/s of TF32, three
# products each: the rate of a ``tf32`` flash row's bound).
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
H, KV, DH, BS, NB, M, B, L = 14, 2, 64, 8, 128, 32, 4, 24
# The learner's log-prob shape: 16 prompts x 4 completions x 8 tokens
# over the qwen vocab.
N_LEARN, V_FULL = 512, 151936
LOGPROB_TOL = {"float32": (1e-5, 1e-4, 1e-5),     # logp, entropy, grad
               "bfloat16": (2e-2, 2e-2, 2e-2)}
SERVE_KERNELS = ("paged_kv_write", "paged_attention", "paged_attention_varlen")
SHADOW_SPEC = "tv_gate:delta=0.05,mode=downweight"   # phase 4's --controller
# The paper's classic-RL scale (Table 1): 500 envs x 1000 steps.
RL_ACTORS, RL_STEPS, RL_PHASES = 500, 1000, 2
# Host-bound runs cut in depth to keep the script in its time limit:
# phase 11's profiled collection and learner phase, phase 21's threaded
# runs and phase 23's fig3 run 100 actors x 100 steps a phase (the
# paper's 500 x 1000 before).
CUT_RL_ACTORS, CUT_RL_STEPS = 100, 100
VTRACE_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
# rwkv6-1.6b's static serve: 8 prompts of 32 tokens, 16 new tokens, 32
# WKV heads of 64 over 24 layers.
RWKV_B, RWKV_P, RWKV_NEW, RWKV_H, RWKV_L = 8, 32, 16, 32, 24
RWKV_LONG = 2048                          # one B 1 x S 2048 forward
WKV6_TOL = {"float32": 3e-4, "bfloat16": 2e-2}
# hymba-1.5b's static serve: 8 prompts of 32 tokens, 16 new tokens, 32
# layers of 25 query / 5 kv heads of 64 (window 1024, layers 15 and 31
# global) beside an SSM of 3200 channels x state 16; one long forward of
# B 1 x S 2048.
HYMBA_B, HYMBA_P, HYMBA_NEW, HYMBA_L = 8, 32, 16, 32
HYMBA_H, HYMBA_KV, HYMBA_I, HYMBA_N, HYMBA_WINDOW = 25, 5, 3200, 16, 1024
HYMBA_LONG = 2048
HYMBA_DT_RANK = 100                       # d_model / 16: x_proj's lead
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# Phase 18's logits, card against CPU: the card's float32 matmuls and
# the SSM branch put S 1100 1.3e-4 from the CPU with the plain
# attention as with the kernel; dropping the window moves it far more.
HYMBA_LOGITS_ATOL = 2e-4
SSM_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def time_ms(fn, iters: int = 100, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_rows(prof, kind=None):
    """``[name, device ms, records]`` of each kernel name in a finished
    ``torch.profiler`` capture (``kind``: the device type, CUDA by
    default), largest first.  Read from the raw Kineto records, as
    ``key_averages`` groups them (demangled names, async and hidden
    records left out): ``key_averages`` first builds a Python event of
    every record, ~90 us each, which for the ~150k launches of one
    serve minibatch took longer than the minibatch."""
    from torch.autograd import DeviceType

    kind = DeviceType.CUDA if kind is None else kind
    agg, names = {}, {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != kind or e.is_async()
                or e.start_thread_id() != e.end_thread_id()
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        ns = e.end_ns() - e.start_ns()
        if ns <= 0:
            continue
        raw = e.name()
        name = names.get(raw)
        if name is None:
            import torch
            name = names[raw] = (torch._C._demangle(raw) if len(raw) > 1
                                 else raw)
        row = agg.setdefault(name, [name, 0.0, 0])
        row[1] += ns / 1e6
        row[2] += 1
    return sorted(agg.values(), key=lambda r: -r[1])


def device_ms(fn, match=None, iters: int = 20, attempts: int = 6):
    """Device time per call from a ``torch.profiler`` capture: the CUDA
    kernels whose name contains ``match`` (None: every kernel the call
    runs).  A capture now and then comes back without the card's kernel
    records (three in a row once, for bf16 flash at S 2048, late in a
    full run), so up to ``attempts`` captures are taken; None when none
    of them holds the device time.  A capture can also hold only some of
    the ``iters`` launches of a kernel (13 of 20 records of a 0.6 ms
    scan, and 1 of 20 late in a full run): with ``match``, where every
    matched kernel launches once a call, the time is the sum of each
    kernel's mean over the records it has.  Without it the total is
    divided by ``iters`` and reads low when records are missing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [r for r in _kernel_rows(prof)
                if match is None or match in r[0]]
        if not rows:
            continue
        if match is None:
            return sum(ms for _, ms, _ in rows) / iters
        return sum(ms / n for _, ms, n in rows)
    return None


def profile_kernels(fn, complete=None, attempts: int = 6):
    """One profiled call of ``fn``: its total CUDA kernel time (ms) and
    every kernel by device time, largest first, as ``[name, ms,
    calls]``.  A capture can drop some of a call's kernel records (1 of
    32 flash launches of the hymba long forward once), so where the
    caller knows what a whole capture holds, ``complete(rows)`` says so
    and up to ``attempts`` captures are taken until one is whole; the
    last is returned either way and the caller's own check decides."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts if complete else 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [[name[:80], ms, n] for name, ms, n in _kernel_rows(prof)]
        if complete is None or complete(rows):
            break
    return sum(r[1] for r in rows), rows


def bound(nbytes: float, flops: float, dtype: str):
    """Least ms for ``nbytes`` moved and ``flops`` done at ``dtype``'s
    peak (a ``PEAK_FLOPS`` key), and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _tables(gen, lens, torch, nb=NB, m=M):
    """Distinct pages per slot drawn from 1..nb-1; pads are page 0."""
    perm = torch.randperm(nb - 1, generator=gen)[: len(lens) * m] + 1
    tables = torch.zeros(len(lens), m, dtype=torch.int32)
    nxt = 0
    for b, ctx in enumerate(lens):
        n = -(-int(ctx) // BS)
        tables[b, :n] = perm[nxt:nxt + n]
        nxt += n
    return tables


def _pools(gen, dtype, torch, layers=None):
    shape = (KV, NB, BS, DH) if layers is None else (layers, KV, NB, BS, DH)
    k = torch.randn(shape, generator=gen)
    v = torch.randn(shape, generator=gen)
    if layers is None:
        # Page 0 is the table's pad id: poison it so a kernel that reads a
        # pad entry as context disagrees with the plain version.
        k[:, 0] = 1e4
        v[:, 0] = 1e4
    return k.to(dtype), v.to(dtype)


def _attention_cases():
    """(case, T, row_start, row_len, window) at the serve path's widths."""
    yield "decode", 1, None, [45, 17, 64, 33], None
    yield "decode_edges", 1, None, [0, 1, 256, 8], None
    yield "decode_window", 1, None, [45, 17, 64, 33], 12
    yield "varlen_t1", 1, [44, 16, 63, 0], [1, 1, 1, 0], None
    yield "varlen_t16", 16, [40, 16, 0, 9], [1, 16, 7, 0], None
    yield "varlen_t32", 32, [0, 24, 70, 5], [32, 32, 1, 19], None
    yield "varlen_window", 16, [40, 16, 0, 9], [1, 16, 7, 0], 12
    # Contexts of up to 239 keys: four 64-key tiles of M 32 x BS 8.
    yield "varlen_long", 16, [200, 180, 0, 230], [16, 16, 3, 9], None
    yield "varlen_long_window", 16, [200, 180, 0, 230], [16, 16, 3, 9], 100
    # The speculative verify shape (paged_attention_multi, a wrapper over
    # the varlen kernel): T 4 tokens a slot ending at the decode contexts.
    yield "multi_t4", 4, [41, 13, 60, 29], [4, 4, 4, 4], None
    yield "multi_t2", 2, [43, 15, 62, 31], [2, 2, 2, 2], None


def _attention_bound(q, rows, lens, window, n_scalars, esize, dtype,
                     h=H, kv=KV, dh=DH):
    """Least time for one call.  Bytes: the whole output written once;
    ``n_scalars`` int32 per slot; for each live slot its live query rows,
    the K/V rows its oldest row can see and the table entries of their
    pages, each read once.  Flops: the valid (query, key) pairs."""
    nbytes = q.numel() * esize + n_scalars * len(lens) * 4
    flops = 0
    for (start, n), ctx in zip(rows, lens):
        if n <= 0:
            continue
        first = 0 if window is None else max(0, start - window + 1)
        nbytes += n * h * dh * esize
        nbytes += 2 * kv * (ctx - first) * dh * esize
        nbytes += (-(-ctx // BS) - first // BS) * 4
        for qpos in range(start, start + n):
            keys = qpos + 1 if window is None else min(qpos + 1, window)
            flops += 4 * h * keys * dh
    return bound(nbytes, flops, dtype)


def kernel_phase(torch):
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.kernels.paged_attention_varlen import \
        paged_attention_varlen_cuda
    from repro_torch.kernels.paged_kv_write import paged_kv_write_cuda

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1234)
    headline, worst = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        esize = torch.empty((), dtype=dtype).element_size()
        kp, vp = (t.to(dev) for t in _pools(gen, dtype, torch))
        for case, t, row_start, lens, window in _attention_cases():
            decode = row_start is None
            if decode:
                ctx = lens
                rows = [(max(c - 1, 0), 1 if c > 0 else 0) for c in ctx]
            else:
                rows = list(zip(row_start, lens))
                ctx = [s + n for s, n in rows]
            tables = _tables(gen, [max(c, 1) for c in ctx], torch).to(dev)
            shape = (B, H, DH) if decode else (B, t, H, DH)
            q = torch.randn(shape, generator=gen).to(dtype).to(dev)
            if decode:
                cl = torch.tensor(ctx, dtype=torch.int32, device=dev)
                args = (q, kp, vp, tables, cl)
                kern = lambda: paged_attention_cuda(*args, window=window)
                plain = lambda: ref.ref_paged_attention(*args, window=window)
                name = "paged_attention"
                symbol = "paged_attention_kernel"
            elif case.startswith("multi"):
                cl = torch.tensor(ctx, dtype=torch.int32, device=dev)
                args = (q, kp, vp, tables, cl)
                kern = lambda: ops.paged_attention_multi(*args)
                plain = lambda: ref.ref_paged_attention_multi(*args)
                name = "paged_attention_multi"
                symbol = "paged_attention_varlen_kernel"
            else:
                rs = torch.tensor(row_start, dtype=torch.int32, device=dev)
                rl = torch.tensor(lens, dtype=torch.int32, device=dev)
                args = (q, kp, vp, tables, rs, rl)
                kern = lambda: paged_attention_varlen_cuda(*args,
                                                           window=window)
                plain = lambda: ref.ref_paged_attention_varlen(
                    *args, window=window)
                name = "paged_attention_varlen"
                symbol = "paged_attention_varlen_kernel"
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(bool(torch.isfinite(got).all()), f"{name}/{case}: non-finite")
            check(err <= TOL[dname], f"{name}/{case}/{dname}: max_abs_err "
                  f"{err} > {TOL[dname]}")
            # Padding rows and idle slots must be exact zeros.
            g4 = got if not decode else got[:, None]
            for b, (_, n) in enumerate(rows):
                check(bool((g4[b, n:] == 0).all()),
                      f"{name}/{case}: padding rows of slot {b} not zero")
            # Library yardstick: SDPA over K/V already gathered to dense,
            # GQA-expanded, with the same validity mask (timed only).
            keys = ref._gather_pages(kp, tables).repeat_interleave(H // KV, 0)
            vals = ref._gather_pages(vp, tables).repeat_interleave(H // KV, 0)
            keys, vals = keys.transpose(0, 1), vals.transpose(0, 1)
            qs = q[:, None] if decode else q
            qpos = torch.tensor([[s + i for i in range(qs.shape[1])]
                                 for s, _ in rows], device=dev)
            kpos = torch.arange(M * BS, device=dev)
            mask = kpos[None, None, :] <= qpos[:, :, None]
            if window is not None:
                mask &= (qpos[:, :, None] - kpos[None, None, :]) < window
            qh = qs.transpose(1, 2)
            lib = lambda: F.scaled_dot_product_attention(
                qh, keys, vals, attn_mask=mask[:, None])
            b_ms, b_by = _attention_bound(
                q, rows, ctx, window, 2 if name.endswith("varlen") else 1,
                esize, dname)
            rec = dict(phase="kernel", kernel=name, case=case, dtype=dname,
                       T=t, max_abs_err=err, tol=TOL[dname],
                       kernel_ms=time_ms(kern), plain_ms=time_ms(plain),
                       library_ms=time_ms(lib), bound_ms=b_ms, bound_by=b_by,
                       kernel_device_ms=device_ms(kern, symbol),
                       plain_device_ms=device_ms(plain),
                       library_device_ms=device_ms(lib))
            emit(**rec)
            key = (name, dname)
            worst[key] = max(worst.get(key, 0.0), err)
            if name == "paged_attention_multi":
                # It runs kernel 3: its error is kernel 3's too.
                k3 = ("paged_attention_varlen", dname)
                worst[k3] = max(worst.get(k3, 0.0), err)
            if case in ("decode", "varlen_t16", "multi_t4"):
                headline[key] = rec

        # K/V row write: a decode step's 4 rows and a varlen round's 64.
        for case, n_rows in (("decode_rows", B), ("varlen_rows", B * 16)):
            pk, pv = (x.to(dev) for x in _pools(gen, dtype, torch, layers=L))
            kr = torch.randn(n_rows, KV, DH, generator=gen).to(dtype).to(dev)
            vr = torch.randn(n_rows, KV, DH, generator=gen).to(dtype).to(dev)
            dest = torch.randperm(NB * BS, generator=gen)[:n_rows]
            page = (dest // BS).to(torch.int32).to(dev)
            off = (dest % BS).to(torch.int32).to(dev)
            act = (torch.arange(n_rows) % 5 != 3).to(torch.int32).to(dev)
            layer = 7
            pk0, pv0 = pk.clone(), pv.clone()
            wk, wv = pk.clone(), pv.clone()
            ref.ref_paged_kv_write(wk, wv, kr, vr, page, off, act,
                                   layer=layer)
            paged_kv_write_cuda(pk, pv, kr, vr, page, off, act, layer=layer)
            torch.cuda.synchronize()
            check(torch.equal(pk, wk) and torch.equal(pv, wv),
                  f"paged_kv_write/{case}/{dname}: not bit-exact")
            touched = torch.zeros(pk.shape, dtype=torch.bool, device=dev)
            sel = act.bool()
            touched[layer, :, page[sel].long(), off[sel].long()] = True
            check(torch.equal(pk[~touched], pk0[~touched]) and
                  torch.equal(pv[~touched], pv0[~touched]),
                  f"paged_kv_write/{case}: untouched rows changed")
            kern = lambda: paged_kv_write_cuda(pk, pv, kr, vr, page, off,
                                               act, layer=layer)
            plain = lambda: ref.ref_paged_kv_write(pk, pv, kr, vr, page, off,
                                                   act, layer=layer)
            # Library yardstick: index_copy_ of the active rows into the
            # flattened pools at precomputed row ids (K then V).
            hs = torch.arange(KV, device=dev)
            rid = (((layer * KV + hs[None, :]) * NB + page[sel].long()[:, None])
                   * BS + off[sel].long()[:, None]).reshape(-1)
            ksrc, vsrc = kr[sel].reshape(-1, DH), vr[sel].reshape(-1, DH)
            fk, fv = pk.view(-1, DH), pv.view(-1, DH)
            lib = lambda: (fk.index_copy_(0, rid, ksrc),
                           fv.index_copy_(0, rid, vsrc))
            n_act = int(sel.sum())
            # K and V rows of the active rows read and written once; the
            # active flags of every row, page and offset of active rows.
            nbytes = (2 * 2 * n_act * KV * DH * esize
                      + (n_rows + 2 * n_act) * 4)
            b_ms, b_by = bound(nbytes, 0, dname)
            rec = dict(phase="kernel", kernel="paged_kv_write", case=case,
                       dtype=dname, N=n_rows, max_abs_err=0.0, tol=0.0,
                       kernel_ms=time_ms(kern), plain_ms=time_ms(plain),
                       library_ms=time_ms(lib), bound_ms=b_ms, bound_by=b_by,
                       kernel_device_ms=device_ms(kern, "kv_write_kernel"),
                       plain_device_ms=device_ms(plain),
                       library_device_ms=device_ms(lib))
            emit(**rec)
            if case == "decode_rows":
                headline[("paged_kv_write", dname)] = rec
            # What a layer of the model pays: ops.paged_kv_write with the
            # step's bool mask (no cast), bit-exact, beside index_copy_.
            mask = act.bool()
            ok, ov = pk0.clone(), pv0.clone()
            ops.paged_kv_write(ok, ov, kr, vr, page, off, mask, layer=layer)
            torch.cuda.synchronize()
            check(torch.equal(ok, wk) and torch.equal(ov, wv),
                  f"ops.paged_kv_write/{case}/{dname}: not bit-exact")
            kern = lambda: ops.paged_kv_write(ok, ov, kr, vr, page, off,
                                              mask, layer=layer)
            plain = lambda: ref.ref_paged_kv_write(ok, ov, kr, vr, page, off,
                                                   mask, layer=layer)
            emit(**dict(rec, case=f"{case}_ops", path="ops, bool mask",
                        kernel_ms=time_ms(kern), plain_ms=time_ms(plain),
                        library_ms=time_ms(lib),
                        kernel_device_ms=device_ms(kern, "kv_write_kernel"),
                        plain_device_ms=device_ms(plain),
                        library_device_ms=device_ms(lib)))
    for key, err in worst.items():           # worst case of each kernel
        headline[key] = dict(headline[key], max_abs_err=err)
    return headline


# ---------------------------------------------------------------------------
# Phase 6: the log-prob kernels against their plain versions
# ---------------------------------------------------------------------------


def _logprob_inputs(torch, n, v, dtype, seed):
    """Logits ~ N(0, 4^2) and targets on the card, with the edges: targets
    0 and V-1, and row 1 padded with -1e30 from V/2 on."""
    from repro_torch.kernels.ref import NEG_INF

    gen = torch.Generator(device="cuda").manual_seed(seed)
    logits = (4.0 * torch.randn(n, v, generator=gen, device="cuda"))
    targets = torch.randint(0, v, (n,), generator=gen, device="cuda")
    targets[0], targets[-1] = 0, v - 1
    logits[1, v // 2:] = NEG_INF
    targets[1] = v // 4
    return logits.to(dtype), targets.to(torch.int32)


def logprob_kernel_phase(torch):
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.logprobs import (fused_logprob_bwd_cuda,
                                              fused_logprob_cuda)

    headline, worst = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        esize = torch.empty((), dtype=dtype).element_size()
        tol_lp, tol_ent, tol_grad = LOGPROB_TOL[dname]
        for case, n, v in (("learner", N_LEARN, V_FULL), ("ragged", 37, 1000)):
            x, t = _logprob_inputs(torch, n, v, dtype, seed=n + v)
            gen = torch.Generator(device="cuda").manual_seed(7)
            g_lp = torch.randn(n, generator=gen, device="cuda")
            g_ent = torch.randn(n, generator=gen, device="cuda")
            # Forward.
            lp, ent, lse = fused_logprob_cuda(x, t)
            want_lp = ref.ref_logprobs_from_logits(x, t)
            want_ent = ref.ref_entropy_from_logits(x)
            torch.cuda.synchronize()
            err_lp = (lp - want_lp).abs().max().item()
            err_ent = (ent - want_ent).abs().max().item()
            check(bool(torch.isfinite(lp).all() and torch.isfinite(ent).all()),
                  f"fused_logprob/{case}/{dname}: non-finite")
            check(err_lp <= tol_lp and err_ent <= tol_ent,
                  f"fused_logprob/{case}/{dname}: logp err {err_lp} "
                  f"(tol {tol_lp}), entropy err {err_ent} (tol {tol_ent})")
            # Backward, with and without the entropy term, against
            # autograd of the plain forward in float32.
            xf = x.float().requires_grad_(True)
            lp_f = ref.ref_logprobs_from_logits(xf, t)
            ent_f = ref.ref_entropy_from_logits(xf)
            err_grad = 0.0
            for g_e in (None, g_ent):
                out = (g_lp * lp_f).sum()
                if g_e is not None:
                    out = out + (g_e * ent_f).sum()
                (want,) = torch.autograd.grad(out, xf, retain_graph=True)
                got = fused_logprob_bwd_cuda(x, t, lse, ent, g_lp, g_e)
                torch.cuda.synchronize()
                check(got.dtype == dtype, "fused_logprob_bwd: wrong dtype")
                scale = max(1.0, want.abs().max().item())
                e = (got.float() - want).abs().max().item()
                check(e <= tol_grad * scale,
                      f"fused_logprob_bwd/{case}/{dname}/entropy="
                      f"{g_e is not None}: err {e} > {tol_grad} x {scale}")
                err_grad = max(err_grad, e)
            del xf, lp_f, ent_f, want, got
            # Times: the learner's calls (the backward without the entropy
            # term), the plain versions, and F.cross_entropy (logp only)
            # and its backward as the library yardstick.
            xl = x.detach().requires_grad_(True)
            ce = F.cross_entropy(xl, t.long(), reduction="none")
            fwd = dict(
                kern=lambda: fused_logprob_cuda(x, t),
                plain=lambda: (ref.ref_logprobs_from_logits(x, t),
                               ref.ref_entropy_from_logits(x)),
                lib=lambda: F.cross_entropy(x, t.long(), reduction="none"),
                symbol="logprob_kernel", err=max(err_lp, err_ent),
                # logits once, targets once, three [N] outputs.
                nbytes=n * v * esize + 4 * n * 4, flops=4 * n * v)
            bwd = dict(
                kern=lambda: fused_logprob_bwd_cuda(x, t, lse, ent, g_lp,
                                                    None),
                plain=lambda: ref.ref_logprobs_backward(x, t, lse, ent, g_lp,
                                                        None),
                lib=lambda: torch.autograd.grad(ce, xl, g_lp,
                                                retain_graph=True),
                symbol="logprob_bwd_kernel", err=err_grad,
                # logits read, gradient written; targets, lse, g_lp read.
                nbytes=2 * n * v * esize + 3 * n * 4, flops=5 * n * v)
            for name, k in (("fused_logprob", fwd),
                            ("fused_logprob_bwd", bwd)):
                b_ms, b_by = bound(k["nbytes"], k["flops"], dname)
                rec = dict(phase="kernel", kernel=name, case=case,
                           dtype=dname, N=n, V=v, max_abs_err=k["err"],
                           kernel_ms=time_ms(k["kern"], iters=50),
                           plain_ms=time_ms(k["plain"], iters=10),
                           library_ms=time_ms(k["lib"], iters=50),
                           bound_ms=b_ms, bound_by=b_by,
                           kernel_device_ms=device_ms(k["kern"], k["symbol"]),
                           plain_device_ms=device_ms(k["plain"]),
                           library_device_ms=device_ms(k["lib"]))
                emit(**rec)
                key = (name, dname)
                worst[key] = max(worst.get(key, 0.0), k["err"])
                if case == "learner":
                    headline[key] = rec
            del x, xl, ce, lse, ent, lp
            torch.cuda.empty_cache()
    for key, err in worst.items():
        headline[key] = dict(headline[key], max_abs_err=err)
    return headline


# ---------------------------------------------------------------------------
# Phases 4 and 5: the serve path
# ---------------------------------------------------------------------------


def serve_phase(torch):
    from repro_torch import kernels
    from repro_torch.launch import serve as launcher
    from repro_torch.metrics import collect_serve_stats

    args = launcher.build_parser().parse_args([
        "--engine", "continuous", "--full-width", "--device", "cuda",
        "--requests", "8", "--mixed-lengths", "4,8,16,32",
        "--temperature", "0"])
    kernels.reset_launch_counts()
    engine, trajs, seconds = launcher.serve(args)
    launches = kernels.launch_counts()
    cfg = engine.bundle.cfg
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.d_ff, cfg.vocab_size) == (24, 896, 14, 2, 4864, 151936),
          f"serve phase is not full width: {cfg}")
    check(len(trajs) == 8 and not engine.has_work,
          f"only {len(trajs)} of 8 requests retired")
    for t in trajs:
        check(t.num_tokens > 0 and t.tokens.min() >= 0
              and t.tokens.max() < cfg.vocab_size,
              f"request {t.request_id}: bad tokens {t.tokens}")
        check(bool(((t.log_beta <= 1e-6) & (t.log_beta > -1e9)).all()),
              f"request {t.request_id}: bad log_beta {t.log_beta}")
    for name in SERVE_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} never launched on the serve path")
    st = collect_serve_stats(engine)
    emit(phase="serve", config=cfg.name, layers=cfg.n_layers,
         requests=len(trajs), tokens_out=st["tokens_out"], seconds=seconds,
         tokens_per_s=st["tokens_out"] / seconds,
         ttft_p50_ms=st["ttft_p50_ms"], ttft_p99_ms=st["ttft_p99_ms"],
         inter_token_p50_ms=st["inter_token_p50_ms"],
         inter_token_p99_ms=st["inter_token_p99_ms"],
         decode_steps=st["decode_steps"],
         prefill_dispatches=st["prefill_dispatches"],
         preemptions=st["preemptions"], launches=launches)
    # serve --controller: the shadow scoring serve() runs after its
    # report, over the same retired requests.
    args.controller = SHADOW_SPEC
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    decisions = launcher.shadow_admission(args, engine, trajs)
    torch.cuda.synchronize()
    shadow_s = time.perf_counter() - t0
    scored = kernels.launch_counts()["fused_logprob"]
    counters = engine.metrics.counter_values("serve_shadow_admission_total")
    tvs = [d[3] for d in decisions]
    emit(phase="serve_shadow", controller=SHADOW_SPEC, seconds=shadow_s,
         decisions=decisions, counters=counters,
         fused_logprob_launches=scored)
    check(len(decisions) == len(trajs) == sum(counters.values())
          and scored == len(trajs)
          and all(tv is not None and math.isfinite(tv) for tv in tvs),
          f"serve --controller: {len(decisions)} verdicts, counters "
          f"{counters}, {scored} fused_logprob launches for {len(trajs)} "
          f"requests, tvs {tvs}")
    return launches


def _scale_dense(tree, by: float = 3.0):
    """The dense weights (``"w"`` leaves) scaled by ``by``.  At random
    init the tied readout otherwise repeats the last prompt token, and
    equal token streams would prove nothing."""
    return {k: _scale_dense(v, by) if isinstance(v, dict)
            else v * by if k == "w" else v for k, v in tree.items()}


def _step_parity(torch, cfg, params):
    """One ``decode_step_paged`` and one ``decode_step_paged_varlen``
    pass on the same random pools, CPU (plain path) against the card
    (kernels): logits within 1e-4 (absolute and relative), pools within
    1e-5 of their largest magnitude where that exceeds 1 (random pool
    entries and the new K/V rows reach several units).  Returns the
    largest absolute logit and pool error of each."""
    from repro_torch.models import transformer as tf

    gen = torch.Generator().manual_seed(3)
    shape = (cfg.n_layers, cfg.n_kv_heads, NB, BS, cfg.head_dim)
    pages = {k: torch.randn(shape, generator=gen)
             for k in ("k_pages", "v_pages")}
    tables = torch.randperm(NB, generator=gen)[:B * M].reshape(B, M)
    tables = tables.to(torch.int32)
    t = 16
    row_len = torch.tensor([1, 16, 7, 0], dtype=torch.int32)
    steps = {
        "decode": (tf.decode_step_paged, (
            torch.randint(0, cfg.vocab_size, (B,), generator=gen), tables,
            torch.tensor([45, 17, 0, 33], dtype=torch.int32),
            torch.tensor([True, True, False, True]))),
        "varlen": (tf.decode_step_paged_varlen, (
            torch.randint(0, cfg.vocab_size, (B, t), generator=gen), tables,
            torch.tensor([40, 16, 0, 9], dtype=torch.int32), row_len,
            torch.full((B,), M * BS, dtype=torch.int32))),
    }
    card_params = tf.tree_to(params, "cuda")
    errs = {}
    for name, (step, args) in steps.items():
        want, want_pages = step(params, cfg, args[0],
                                {k: v.clone() for k, v in pages.items()},
                                *args[1:])
        got, got_pages = step(card_params, cfg, args[0].cuda(),
                              tf.tree_to(pages, "cuda"),
                              *(a.cuda() for a in args[1:]))
        g, w = got.logits.cpu(), want.logits
        if name == "varlen":                 # padding rows are garbage
            live = torch.arange(t)[None, :] < row_len[:, None]
            g, w = g[live], w[live]
        check(bool(torch.isfinite(g).all()), f"parity/{name}: non-finite")
        errs[name] = {"logits": (g - w).abs().max().item()}
        check(torch.allclose(g, w, rtol=1e-4, atol=1e-4),
              f"parity/{name}: logits differ by {errs[name]['logits']}")
        for k in pages:
            errs[name][k] = _scaled_err(got_pages[k].cpu(), want_pages[k],
                                        1e-5, f"{name} {k}")
    return errs


def _scaled_err(got, want, tol: float, what: str) -> float:
    """Largest absolute error; fails past ``tol * max(1, max|want|)``."""
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    check(err <= tol * scale, f"parity: {what} differ by {err} "
          f"(largest magnitude {scale}, tolerance {tol} of it)")
    return err


def parity_phase(torch):
    from repro_torch.configs import get_config
    from repro_torch.data.mathgen import MathTaskDataset
    from repro_torch.data.tokenizer import get_tokenizer
    from repro_torch.models.registry import build
    from repro_torch.rollout.sampler import gumbel_noise, sample
    from repro_torch.serve import ServeEngine

    cfg = get_config("qwen2.5-0.5b").replace(n_layers=2)
    bundle = build(cfg)
    params = _scale_dense(bundle.init(torch.Generator().manual_seed(0)))
    step_errs = _step_parity(torch, cfg, params)
    tok = get_tokenizer()
    toks, _, _ = MathTaskDataset(prompt_len=32, seed=1).sample_batch(4)
    prompts = [row[row != tok.pad_id] for row in toks]
    rec = dict(phase="parity", config=cfg.name, layers=cfg.n_layers,
               step_max_abs_err=step_errs, logits_tol=1e-4, pools_tol=1e-5)
    for mode, temperature in (("greedy", 0.0), ("sampled", 1.0)):
        out = {}
        for dev in ("cpu", "cuda"):
            eng = ServeEngine(bundle, params, num_blocks=128, block_size=8,
                              max_batch=4, decode_chunk=4, prefill_chunk=16,
                              dispatch_budget=32, temperature=temperature,
                              seed=2, device=dev)
            # Both engines draw the same Gumbel noise, from one CPU
            # stream, so sampled streams can be held equal too.
            noise = torch.Generator().manual_seed(5)
            eng._sample = lambda logits, e=eng, g=noise: sample(
                logits, e._temperature, e._top_p,
                gumbel_noise(logits.shape, g, "cpu").to(logits.device))
            for i, p in enumerate(prompts):
                eng.submit(p, (4, 8, 16, 8)[i], request_id=i)
            out[dev] = {t.request_id: t for t in eng.run(max_steps=1000)}
        check(sorted(out["cpu"]) == sorted(out["cuda"]) == [0, 1, 2, 3],
              f"parity/{mode}: not every request retired")
        worst = 0.0
        for rid, want in out["cpu"].items():
            got = out["cuda"][rid]
            check(got.tokens.tolist() == want.tokens.tolist(),
                  f"parity/{mode}: request {rid} tokens differ: cuda "
                  f"{got.tokens} cpu {want.tokens}")
            worst = max(worst, float(abs(got.log_beta - want.log_beta).max()))
        check(worst <= 1e-4, f"parity/{mode}: log_beta differs by {worst}")
        distinct = len({int(x) for t in out["cpu"].values() for x in t.tokens})
        min_lb = min(float(t.log_beta.min()) for t in out["cpu"].values())
        # Streams that vary, and draws off the argmax, or equality says
        # little.
        if mode == "greedy":
            check(distinct > 5, f"parity/greedy: only {distinct} distinct "
                  "tokens")
        else:
            check(min_lb < -0.1, f"parity/sampled: every draw was the "
                  f"argmax (min log_beta {min_lb})")
        rec[mode] = dict(
            tokens=sum(t.num_tokens for t in out["cpu"].values()),
            distinct_tokens=distinct, min_log_beta=min_lb,
            log_beta_max_abs_err=worst, tol=1e-4)
    emit(**rec)


# ---------------------------------------------------------------------------
# Phases 7-9: the RLVR learner path
# ---------------------------------------------------------------------------


def _span_seconds(tracer, name):
    """Durations (s) of the sync spans called ``name``."""
    open_at, out = {}, []
    for e in tracer.events():
        if e.name != name:
            continue
        if e.ph == "B":
            open_at[(e.pid, e.tid)] = e.ts
        elif e.ph == "E":
            out.append((e.ts - open_at.pop((e.pid, e.tid))) / 1e9)
    return out


def train_phase(torch):
    from repro_torch import kernels
    from repro_torch.launch import train as launcher
    from repro_torch.obs.tracer import Tracer

    args = launcher.build_parser().parse_args([
        "rlvr", "--full-width", "--device", "cuda", "--warmup-steps", "2",
        "--n-minibatches", "2", "--phases", "1"])
    tracer = Tracer(detail="spans")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trainer, res, warm_loss = launcher.run(args, tracer)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    cfg, hp = trainer.bundle.cfg, trainer.hp
    check((cfg.n_layers, cfg.d_model, cfg.vocab_size) == (24, 896, 151936),
          f"train phase is not full width: {cfg}")
    steps = len(res.phase_logs)
    check(steps == hp.n_minibatches and trainer.nonfinite_skipped == 0,
          f"{steps} learner steps logged of {hp.n_minibatches}")
    # pass_through: one forward and one backward launch per learner step.
    for name in ("fused_logprob", "fused_logprob_bwd"):
        check(launches[name] == steps,
              f"{name} launched {launches[name]} times in {steps} "
              "learner steps")
    produce = _span_seconds(tracer, "produce")
    # Every generate's prefill runs flash_attention once a layer (24):
    # one generate per produced minibatch, one for the launcher's eval
    # after warmup and one per eval of the train loop.  Every forward
    # with a gradient (each warmup and learner step) runs it once a
    # layer too, and its backward once a layer: 24 flash_attention_bwd
    # a learner step.  pass_through scores no minibatch without one.
    generates = len(produce) + 1 + len(res.eval_accuracy)
    grad_steps = hp.warmup_steps + steps
    check(len(produce) > 0 and launches["flash_attention"]
          == cfg.n_layers * (generates + grad_steps),
          f"flash_attention launched {launches['flash_attention']} times "
          f"for {generates} generates and {grad_steps} steps of "
          f"{cfg.n_layers} layers")
    check(launches["flash_attention_bwd"] == cfg.n_layers * grad_steps,
          f"flash_attention_bwd launched {launches['flash_attention_bwd']} "
          f"times in {grad_steps} steps of {cfg.n_layers} layers")
    check(all(math.isfinite(l.tv) for l in res.phase_logs) and
          math.isfinite(warm_loss), "non-finite warmup loss or tv")
    batch = hp.prompts_per_minibatch * hp.completions_per_prompt
    step = trainer.metrics.histogram("train_step_s").summary()
    gnorm = trainer.metrics.histogram("train_grad_norm").summary()
    emit(phase="train", config=cfg.name, layers=cfg.n_layers,
         seconds=seconds, warmup_loss=warm_loss,
         eval_accuracy=res.eval_accuracy, learner_steps=steps,
         learner_step_p50_ms=step["p50"] * 1e3,
         learner_step_mean_ms=step["mean"] * 1e3,
         minibatches_generated=len(produce),
         generation_tokens_per_s=(len(produce) * batch * hp.max_new_tokens
                                  / sum(produce)),
         mean_reward=sum(l.mean_reward for l in res.phase_logs) / steps,
         tv=[l.tv for l in res.phase_logs],
         grad_norm_mean=gnorm["mean"],
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         launches=launches)
    return trainer, launches


def step_phase(torch, trainer):
    """One learner step at full width with rewards from a seed, and the
    kernels checked on that step's own logits."""
    from repro_torch import kernels
    from repro_torch.core.losses import (GRPOConfig, group_advantages,
                                         grpo_token_loss)
    from repro_torch.kernels import ref
    from repro_torch.kernels.logprobs import (fused_logprob_bwd_cuda,
                                              fused_logprob_cuda)
    from repro_torch.train import make_update_step
    from repro_torch.utils.tree import tree_leaves

    hp, bundle = trainer.hp, trainer.bundle
    p_len = trainer.dataset.prompt_len
    state = trainer.state
    mb = trainer.generator.generate_minibatch(state.params)
    tokens, log_beta, mask = mb.gen.tokens, mb.gen.log_beta, mb.gen.mask
    b, n_new = mask.shape
    gen = torch.Generator().manual_seed(11)
    rewards = (torch.rand(b, generator=gen) < 0.5).float().to(tokens.device)
    adv = group_advantages(rewards, hp.completions_per_prompt)
    check(adv.abs().sum().item() > 0, "seeded rewards gave zero advantages")
    with torch.no_grad():
        logits = bundle.forward(state.params, tokens).logits[:, p_len - 1:-1]
    x = logits.reshape(b * n_new, -1).contiguous()
    t = tokens[:, p_len:].reshape(-1).to(torch.int32).contiguous()
    lp, ent, lse = fused_logprob_cuda(x, t)
    # Each row sums 151,936 terms, where the JAX tolerances were set at
    # V <= 2048: hold the kernel and the plain version to the same
    # formulas in float64, and the kernel to the JAX tolerance or to the
    # plain version's own error, whichever is larger.
    x64 = x.double()
    lsm64 = torch.log_softmax(x64, -1)
    truth = {"logp": torch.gather(lsm64, 1, t.long()[:, None])[:, 0],
             "entropy": -(lsm64.exp() * lsm64).sum(-1)}
    del x64, lsm64
    plain = {"logp": ref.ref_logprobs_from_logits(x, t),
             "entropy": ref.ref_entropy_from_logits(x)}
    errs = {}
    for k, got_k, tol in (("logp", lp, 1e-5), ("entropy", ent, 1e-4)):
        e_kern = (got_k.double() - truth[k]).abs().max().item()
        e_plain = (plain[k].double() - truth[k]).abs().max().item()
        errs[k] = dict(kernel_vs_f64=e_kern, plain_vs_f64=e_plain,
                       kernel_vs_plain=(got_k - plain[k]).abs().max().item())
        check(e_kern <= max(tol, e_plain),
              f"step phase: kernel {k} {e_kern} from float64, plain "
              f"{e_plain}, tolerance {tol}")
    # The VACO loss's gradient w.r.t. log_pi at this step, through both
    # backward versions.
    lp_leaf = lp.reshape(b, n_new).clone().requires_grad_(True)
    loss, _ = grpo_token_loss(
        log_pi=lp_leaf, log_beta=log_beta, advantages=adv, token_mask=mask,
        cfg=GRPOConfig(clip_low=hp.clip_low, clip_high=hp.clip_high,
                       use_vaco=hp.algorithm == "grpo_vaco", delta=hp.delta,
                       entropy_coef=hp.entropy_coef))
    (g_lp,) = torch.autograd.grad(loss, lp_leaf)
    g_lp = g_lp.reshape(-1).contiguous()
    got = fused_logprob_bwd_cuda(x, t, lse, ent, g_lp, None)
    want = ref.ref_logprobs_backward(x, t, torch.logsumexp(x, -1),
                                     plain["entropy"], g_lp, None)
    scale = max(1.0, want.abs().max().item())
    errs["dlogits"] = (got - want).abs().max().item()
    check(errs["dlogits"] <= 1e-5 * scale,
          f"step phase: d logits differ by {errs['dlogits']}")
    check(g_lp.abs().max().item() > 0, "step phase: zero gradient of log_pi")
    del logits, x, got, want
    update = make_update_step(bundle, hp, p_len)
    kernels.reset_launch_counts()
    new, aux = update(state, tokens, log_beta, mask, adv)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    loss_v, gnorm = aux["loss"].item(), aux["grad_norm"].item()
    check(math.isfinite(loss_v) and math.isfinite(gnorm) and gnorm > 0,
          f"step phase: loss {loss_v}, grad norm {gnorm}")
    check(launches["fused_logprob"] == 1 and
          launches["fused_logprob_bwd"] == 1,
          f"step phase launched {launches}")
    moved = max((a - b_).abs().max().item() for a, b_ in
                zip(tree_leaves(new.params), tree_leaves(state.params)))
    check(moved > 0, "step phase: the params did not move")
    # Where a learner step's device time goes: one more step, profiled.
    sync_t0 = time.perf_counter()
    update(state, tokens, log_beta, mask, adv)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - sync_t0) * 1e3
    busy_ms, rows = profile_kernels(
        lambda: update(state, tokens, log_beta, mask, adv))
    logprob_ms = sum(ms for name, ms, _ in rows if "logprob" in name)
    emit(phase="step_profile", wall_ms=wall_ms, device_busy_ms=busy_ms,
         idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
         kernel_launches=sum(n for _, _, n in rows),
         logprob_kernels_ms=logprob_ms, top_kernels=rows[:8])
    emit(phase="step", config=bundle.cfg.name, rows=b, tokens=b * n_new,
         loss=loss_v, grad_norm=gnorm, tv=aux["tv"].item(),
         frac_filtered=aux["frac_filtered"].item(),
         nonzero_advantages=int((adv != 0).sum().item()),
         max_param_change=moved, kernel_errs=errs, dlogits_scale=scale,
         launches=launches)


def _parity_batch(torch, hp):
    """Phase 9's batch: 8 supervised warmup rows, 8 completions of 2
    prompts (seeded tokens and mask) with the group advantages of fixed
    rewards, and the numpy generator the ``log_beta`` noise goes on
    from."""
    import numpy as np

    from repro_torch.core.losses import group_advantages
    from repro_torch.data.mathgen import MathTaskDataset

    ds = MathTaskDataset(prompt_len=32, level=0, seed=4)
    w_tok, w_mask = ds.supervised_batch(8, hp.max_new_tokens)
    prompts, _, _ = ds.sample_batch(2)
    rng = np.random.default_rng(5)
    tokens = np.concatenate(
        [np.repeat(prompts, hp.completions_per_prompt, axis=0),
         rng.integers(3, 54, (8, hp.max_new_tokens)).astype(np.int32)], 1)
    mask = (rng.random((8, hp.max_new_tokens)) > 0.1).astype(np.float32)
    adv = group_advantages(torch.tensor([1., 0., 0., 1., 0., 1., 1., 1.]),
                           hp.completions_per_prompt)
    return w_tok, w_mask, tokens, mask, adv, rng


def train_parity_phase(torch, arch="qwen2.5-0.5b", dense_scale=None,
                       tag="train_parity", same_start=False):
    """2 layers of ``arch`` at full width (dense weights x ``dense_scale``
    when given): one warmup step and one VACO learner step on the CPU
    (plain path) and the card (kernels).  ``same_start``: the card's
    learner step starts from the CPU's warmed params, not its own, so
    the step is compared alone; the chained step (the card's warmup,
    then its learner step from its own warm params) is recorded beside
    it, with the kernels and with the plain attention and scan in their
    place on the card, as information (``chained`` in the JSON line).
    Returns ``(cfg, bundle, init params)``."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build
    from repro_torch.optim import adamw_init
    from repro_torch.rollout.sampler import score_tokens
    from repro_torch.train import (RLVRHyperparams, make_update_step,
                                   make_warmup_step)
    from repro_torch.train.trainer_rlvr import RLVRTrainState
    from repro_torch.utils.tree import tree_leaves, tree_to

    cfg = get_config(arch).replace(n_layers=2)
    bundle = build(cfg)
    hp = RLVRHyperparams(algorithm="grpo_vaco")
    params = bundle.init(torch.Generator().manual_seed(0))
    if dense_scale is not None:
        params = _scale_dense(params, dense_scale)
    w_tok, w_mask, tokens, mask, adv, rng = _parity_batch(torch, hp)
    warm = make_warmup_step(bundle, hp)
    update = make_update_step(bundle, hp, 32)
    out = {}
    log_beta = warm_cpu = None
    for dev in ("cpu", "cuda"):
        on = lambda a: torch.as_tensor(a).to(dev)
        p = tree_to(params, dev)
        st, w_loss = warm(RLVRTrainState(p, adamw_init(p), 0), on(w_tok),
                          on(w_mask))
        st = st._replace(opt_state=adamw_init(st.params))
        warm_params = [a.cpu() for a in tree_leaves(st.params)]
        if same_start and warm_cpu is not None:
            p = tree_to(warm_cpu, dev)
            st = RLVRTrainState(p, adamw_init(p), st.updates)
        warm_cpu = st.params if warm_cpu is None else warm_cpu
        if log_beta is None:             # 0.3 nats off the CPU's policy
            with torch.no_grad():
                lp, _, _ = score_tokens(bundle, st.params, on(tokens), 32)
            log_beta = lp + 0.3 * torch.from_numpy(
                rng.standard_normal(lp.shape).astype(np.float32))
        st2, aux = update(st, on(tokens), on(log_beta), on(mask), on(adv))
        out[dev] = dict(warmup_loss=w_loss.item(),
                        **{k: aux[k].item() for k in (
                            "loss", "tv", "frac_filtered", "filter_active",
                            "grad_norm")},
                        warm_params=warm_params,
                        start_params=[a.cpu() for a in tree_leaves(st.params)],
                        params=[a.cpu() for a in tree_leaves(st2.params)])
    cpu, card = out["cpu"], out["cuda"]
    init = [a.clone() for a in tree_leaves(params)]
    rec = dict(phase=tag, config=cfg.name, layers=cfg.n_layers,
               dense_scale=dense_scale, same_start=same_start, tol=1e-4,
               update_tol=1e-2)
    if same_start:
        rec["chained"] = _chained_card_steps(
            torch, warm, update, params, cpu,
            [torch.as_tensor(a).to("cuda")
             for a in (w_tok, w_mask, tokens, log_beta, mask, adv)])
    failures = []
    for k in ("warmup_loss", "loss", "tv", "frac_filtered", "grad_norm"):
        err = abs(card[k] - cpu[k])
        rec[k] = dict(cpu=cpu[k], cuda=card[k], abs_err=err)
        if err > 1e-4 * max(1.0, abs(cpu[k])):
            failures.append(f"{k} cpu {cpu[k]} cuda {card[k]}")
    # AdamW's early steps send each gradient entry g to ~lr*g/(|g|+eps):
    # where |g| is near eps, float noise in g moves that entry by up to
    # lr, so the parameters are compared through the update each step
    # made: card and CPU updates agree to 1e-2 in L2 norm (a wrong sign
    # pattern moves whole tensors), no entry of the two differs by more
    # than the 2 x lr they can span, and the gradient's magnitude is
    # held by the grad norm above.
    for k, before, lr in (("warm_params", None, hp.warmup_lr),
                          ("params", "start_params", hp.lr)):
        start = {d: init if before is None else out[d][before]
                 for d in ("cpu", "cuda")}
        upd = {d: [x - x0 for x, x0 in zip(out[d][k], start[d])]
               for d in ("cpu", "cuda")}
        diff = sum(((x - y) ** 2).sum().item()
                   for x, y in zip(upd["cuda"], upd["cpu"])) ** 0.5
        step = sum((y ** 2).sum().item() for y in upd["cpu"]) ** 0.5
        worst = max((x - y).abs().max().item()
                    for x, y in zip(upd["cuda"], upd["cpu"]))
        rec[k] = dict(
            update_norm=step, update_diff_norm=diff, rel_err=diff / step,
            update_max_abs_err=worst,
            params_max_abs_err=max((x - y).abs().max().item()
                                   for x, y in zip(card[k], cpu[k])))
        if not (diff <= 1e-2 * step and worst <= 2 * lr):
            failures.append(f"{k}: {rec[k]}")
    emit(**rec)
    check(cpu["filter_active"] == card["filter_active"] == 1.0 and
          cpu["frac_filtered"] > 0, f"{tag}: VACO filter idle {cpu}")
    check(not failures, f"{tag}: " + "; ".join(failures))
    return cfg, bundle, params


def _chained_card_steps(torch, warm, update, params, cpu, batch):
    """The card's warmup then learner step from its own warm params, once
    through the kernels and once with ``ops.attention``, ``ops.ssm_scan``
    and ``ops.wkv6`` replaced by the plain versions on the card (under
    autograd): each one's gap to the CPU's chained run (loss, tv and grad
    norm relative to max(1, |cpu|), and the learner step's update
    relative to the CPU's).  Information
    only: AdamW's first step sends near-zero gradient entries to +-lr,
    so the chained step drifts on either route."""
    from repro_torch.kernels import ops, ref
    from repro_torch.optim import adamw_init
    from repro_torch.train.trainer_rlvr import RLVRTrainState
    from repro_torch.utils.tree import tree_leaves, tree_to

    w_tok, w_mask, tokens, log_beta, mask, adv = batch
    cpu_upd = [x - x0 for x, x0 in zip(cpu["params"], cpu["start_params"])]
    cpu_norm = sum((y ** 2).sum().item() for y in cpu_upd) ** 0.5
    plain = {"attention": ref.ref_attention, "ssm_scan": ref.ref_ssm_scan,
             "wkv6": ref.ref_wkv6}
    kept = {name: getattr(ops, name) for name in plain}
    res = {}
    try:
        for route, fns in (("kernels", kept), ("plain", plain)):
            for name, fn in fns.items():
                setattr(ops, name, fn)
            p = tree_to(params, "cuda")
            st, _ = warm(RLVRTrainState(p, adamw_init(p), 0), w_tok, w_mask)
            st = st._replace(opt_state=adamw_init(st.params))
            before = [a.cpu() for a in tree_leaves(st.params)]
            st2, aux = update(st, tokens, log_beta, mask, adv)
            upd = [x.cpu() - x0 for x, x0 in
                   zip(tree_leaves(st2.params), before)]
            diff = sum(((x - y) ** 2).sum().item()
                       for x, y in zip(upd, cpu_upd)) ** 0.5
            res[route] = {k: abs(aux[k].item() - cpu[k])
                          / max(1.0, abs(cpu[k]))
                          for k in ("loss", "tv", "grad_norm")}
            res[route]["update_rel_err"] = diff / cpu_norm
            del st, st2, p, before, upd
    finally:
        for name, fn in kept.items():
            setattr(ops, name, fn)
    return res


# ---------------------------------------------------------------------------
# Phases 10-12: the classic-RL path
# ---------------------------------------------------------------------------


def _vtrace_inputs(torch, b, t, dtype, seed):
    """Log-ratios 0.5 N(0, 1) with +-3 mixed in, values/rewards/bootstrap
    N(0, 1), discounts 0.99 with 10 % episode ends, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    uni = lambda: torch.rand(b, t, generator=gen, device="cuda")
    lr = 0.5 * rnd(b, t)
    lr[uni() < 0.1] = 3.0
    lr[uni() < 0.1] = -3.0
    d = 0.99 * (uni() > 0.1).float()
    return tuple(x.to(dtype) for x in (lr, rnd(b, t), rnd(b), rnd(b, t), d))


def vtrace_kernel_phase(torch):
    from repro_torch.kernels import ref
    from repro_torch.kernels.vtrace import vtrace_cuda

    headline, worst = {}, {}
    # The paper's shape, the JAX sweep's, tile and lane edges (T 1, 31,
    # 32, 33, a ragged 1000 at B 1, four 1024-step tiles), a grid of
    # 4224 warps, and rows that are all episode ends.
    shapes = ((RL_ACTORS, RL_STEPS), (1, 5), (4, 13), (8, 64), (13, 100),
              (RL_ACTORS, 1), (1, 1), (3, 31), (3, 32), (3, 33),
              (1, RL_STEPS), (2, 4096), (4224, 100), ("dones", 7, 300))
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        esize = torch.empty((), dtype=dtype).element_size()
        for shape in shapes:
            dones = shape[0] == "dones"
            b, t = shape[-2:]
            for clips in ((1.0, 1.0, 1.0), (2.0, 0.5, 0.95)):
                kw = dict(zip(("rho_bar", "c_bar", "lam"), clips))
                args = _vtrace_inputs(torch, b, t, dtype, seed=b * t)
                if dones:
                    args = args[:4] + (torch.zeros_like(args[4]),)
                got = vtrace_cuda(*args, **kw)
                want = ref.ref_vtrace(*args, **kw)
                torch.cuda.synchronize()
                err = 0.0
                for g, w, what in zip(got, want, ("vs", "adv")):
                    check(bool(torch.isfinite(g).all()) and g.shape == (b, t),
                          f"vtrace/{b}x{t}/{dname}: bad {what}")
                    e = (g - w).abs().max().item()
                    check(e <= VTRACE_TOL[dname] * max(
                        1.0, w.abs().max().item()),
                        f"vtrace/{b}x{t}/{dname}/{clips}: {what} err {e}")
                    err = max(err, e)
                worst[dname] = max(worst.get(dname, 0.0), err)
                if (b, t) != (RL_ACTORS, RL_STEPS) or clips[0] != 1.0:
                    continue
                # The main path's call: Table 1 clips, 500 x 1000.
                kern = lambda: vtrace_cuda(*args, **kw)
                plain = lambda: ref.ref_vtrace(*args, **kw)
                # Four [B, T] inputs and the bootstrap read once, two
                # [B, T] float32 outputs written once; ~12 operations per
                # element (exp, two mins, the delta, the carry, the
                # advantage).
                b_ms, b_by = bound(4 * b * t * esize + b * esize
                                   + 2 * b * t * 4, 12 * b * t, dname)
                rec = dict(phase="kernel", kernel="vtrace", case="paper",
                           dtype=dname, B=b, T=t, max_abs_err=err,
                           tol=VTRACE_TOL[dname],
                           kernel_ms=time_ms(kern, iters=100),
                           plain_ms=time_ms(plain, iters=5, warmup=1),
                           library_ms=None, bound_ms=b_ms, bound_by=b_by,
                           kernel_device_ms=device_ms(kern, "vtrace_kernel"),
                           plain_device_ms=device_ms(plain, iters=2))
                emit(**rec)
                headline[("vtrace", dname)] = rec
    for dname, err in worst.items():
        headline[("vtrace", dname)] = dict(headline[("vtrace", dname)],
                                           max_abs_err=err)
    # Width and length: one warp per trajectory, four a block (B 4224 is
    # 1056 blocks, 8 an SM); T = 250 against 1000 gives the cost of a
    # tile's length, T 4096 that of four tiles in turn.
    scaling = {}
    for b, t in ((32, RL_STEPS), (RL_ACTORS, RL_STEPS), (4224, RL_STEPS),
                 (RL_ACTORS, 250), (RL_ACTORS, 4096)):
        args = _vtrace_inputs(torch, b, t, torch.float32, seed=7)
        scaling[f"{b}x{t}"] = device_ms(lambda: vtrace_cuda(*args),
                                        "vtrace_kernel")
    emit(phase="vtrace_scaling", device_ms=scaling)
    return headline


def rl_phase(torch):
    from repro_torch import kernels
    from repro_torch.launch import train as launcher
    from repro_torch.obs.tracer import Tracer

    args = launcher.build_parser().parse_args([
        "rl", "--device", "cuda", "--n-actors", str(RL_ACTORS),
        "--rollout-steps", str(RL_STEPS), "--buffer-capacity", "4",
        "--phases", str(RL_PHASES)])
    tracer = Tracer(detail="spans")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = launcher.run_rl(args, tracer)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check(len(res.returns) == RL_PHASES,
          f"rl: {len(res.returns)} of {RL_PHASES} phases ran")
    check(all(math.isfinite(r) for r in res.returns) and
          all(math.isfinite(v) for m in res.metrics for v in m.values()),
          f"rl: non-finite returns {res.returns} or metrics")
    # VACO realigns once per phase; nothing else launches V-trace.
    check(launches["vtrace"] == RL_PHASES,
          f"vtrace launched {launches['vtrace']} times in {RL_PHASES} phases")
    # Phase 1 trains on data from the initial policy alone: unchanged
    # params would leave its final TV at float noise (< 1e-6).
    m0 = res.metrics[0]
    check(m0["policy_lag"] == 0 and m0["final_tv"] > 1e-4 and
          m0["grad_norm"] > 0, f"rl: the policy did not move: {m0}")
    produce = _span_seconds(tracer, "produce")
    learn = _span_seconds(tracer, "learner_step")
    evals = _span_seconds(tracer, "eval")
    emit(phase="rl", env=args.env, algorithm=args.algorithm,
         runtime=args.runtime, actors=RL_ACTORS, steps=RL_STEPS,
         buffer_capacity=args.buffer_capacity, phases=RL_PHASES,
         seconds=seconds, collect_s=produce, learner_s=learn, eval_s=evals,
         env_steps_per_s=len(produce) * RL_ACTORS * RL_STEPS / sum(produce),
         learner_phase_ms=[x * 1e3 for x in learn],
         eval_ms=[x * 1e3 for x in evals], returns=res.returns,
         metrics=res.metrics,
         lag_histogram=res.runtime_stats["queue"]["lag_histogram"],
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         launches=launches)
    return launches


def rl_profile_phase(torch):
    """One collection and one learner phase at 100 actors x 100 steps, each
    timed once plain and once under the profiler: device busy time, idle
    share and launches, by kernel."""
    from repro_torch.envs import make_env, wrap_autoreset
    from repro_torch.models.mlp_policy import act, mlp_policy_init
    from repro_torch.runtime import MixtureRolloutProducer, PolicyStore
    from repro_torch.train import (RLHyperparams, init_train_state,
                                   make_train_phase)
    from repro_torch.rollout.env_rollout import default_draws

    env = wrap_autoreset(make_env("pendulum"))
    params = mlp_policy_init(torch.Generator(device="cuda").manual_seed(0),
                             env.obs_dim, env.act_dim)
    store = PolicyStore(params, 4)
    producer = MixtureRolloutProducer(env, act, n_actors=CUT_RL_ACTORS,
                                      rollout_steps=CUT_RL_STEPS, seed=1,
                                      device="cuda")
    train_phase = make_train_phase(RLHyperparams())
    state = init_train_state(params)
    batch = None

    def collect():
        nonlocal batch
        batch, slots = producer(store.buffer)
        return slots.cpu()

    def learn():
        return train_phase(state, batch, default_draws(2, "cuda"))

    rec = dict(phase="rl_profile", actors=CUT_RL_ACTORS, steps=CUT_RL_STEPS)
    for name, fn in (("collect", collect), ("learner", learn)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, rows = profile_kernels(fn)
        n = sum(c for _, _, c in rows)
        rec[name] = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                         idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
                         kernel_launches=n, top_kernels=rows[:8],
                         vtrace_ms=sum(ms for k, ms, _ in rows
                                       if "vtrace" in k))
    rec["collect"]["launches_per_env_step"] = (
        rec["collect"]["kernel_launches"] / CUT_RL_STEPS)
    emit(**rec)


def rl_parity_phase(torch):
    from repro_torch import kernels
    from repro_torch.envs import make_env, wrap_autoreset
    from repro_torch.models.mlp_policy import act, mlp_policy_init
    from repro_torch.rollout.async_engine import SimulatedAsyncActors
    from repro_torch.rollout.env_rollout import GeneratorDraws, RolloutBatch
    from repro_torch.train import (RLHyperparams, init_train_state,
                                   make_train_phase)
    from repro_torch.utils.tree import tree_leaves, tree_to

    env = wrap_autoreset(make_env("pendulum"))
    gen = torch.Generator().manual_seed(0)
    snaps = [mlp_policy_init(gen, env.obs_dim, env.act_dim)
             for _ in range(4)]
    for p in snaps:                # actions off the mean by more than eps
        p["actor"]["head"]["w"] *= 30.0
    rec = dict(phase="rl_parity", actors=8, steps=32, hidden=64, tol=1e-4,
               update_tol=1e-2)
    out = {}
    for dev in ("cpu", "cuda"):
        # One CPU stream of draws for both devices.
        draws = GeneratorDraws(torch.Generator().manual_seed(21), dev)
        actors = SimulatedAsyncActors(
            env, act, tree_to(snaps[0], dev), n_actors=8, buffer_capacity=4,
            rollout_steps=32, device=dev, draws=draws)
        for p in snaps[1:]:
            actors.push_policy(tree_to(p, dev))
        batch, slots = actors.collect()
        out[dev] = (RolloutBatch(*(x.cpu() for x in batch)), slots.cpu())
    (cb, cs), (gb, gs) = out["cpu"], out["cuda"]
    check(torch.equal(cs, gs) and len(set(cs.tolist())) > 1,
          f"rl parity: slots cpu {cs} cuda {gs}")
    check(torch.equal(cb.dones, gb.dones), "rl parity: dones differ")
    rec["collect_max_abs_err"] = {}
    for k in ("obs", "actions", "log_beta", "rewards", "final_obs"):
        rec["collect_max_abs_err"][k] = _scaled_err(
            getattr(gb, k), getattr(cb, k), 1e-4, f"collect {k}")
    # One VACO phase on the CPU's batch, behaviour 0.3 nats off so the
    # TV filter acts, with one CPU stream of permutations.
    noise = torch.randn(cb.log_beta.shape,
                        generator=torch.Generator().manual_seed(23))
    batch = cb._replace(log_beta=cb.log_beta + 0.3 * noise)
    hp = RLHyperparams(num_epochs=1, num_minibatches=4)
    res = {}
    for dev in ("cpu", "cuda"):
        kernels.reset_launch_counts()
        state = init_train_state(tree_to(snaps[-1], dev))
        new, m = make_train_phase(hp)(
            state, RolloutBatch(*(x.to(dev) for x in batch)),
            GeneratorDraws(torch.Generator().manual_seed(22), dev))
        res[dev] = (m, [(a - b).cpu() for a, b in
                        zip(tree_leaves(new.params),
                            tree_leaves(state.params))],
                    kernels.launch_counts()["vtrace"])
    (cm, cu, cl), (gm, gu, gl) = res["cpu"], res["cuda"]
    check(cl == 0 and gl == 1, f"rl parity: vtrace launches cpu {cl} "
          f"cuda {gl}")
    failures = []
    for k in ("total_loss", "policy_loss", "value_loss", "tv",
              "frac_filtered", "grad_norm"):
        err = abs(gm[k] - cm[k])
        rec[k] = dict(cpu=cm[k], cuda=gm[k], abs_err=err)
        if err > 1e-4 * max(1.0, abs(cm[k])):
            failures.append(f"{k} cpu {cm[k]} cuda {gm[k]}")
    diff = sum(((x - y) ** 2).sum().item() for x, y in zip(gu, cu)) ** 0.5
    step = sum((y ** 2).sum().item() for y in cu) ** 0.5
    rec["update"] = dict(update_norm=step, update_diff_norm=diff,
                         rel_err=diff / step)
    if not diff <= 1e-2 * step:
        failures.append(f"update: {rec['update']}")
    emit(**rec)
    check(cm["frac_filtered"] > 0 and step > 0,
          f"rl parity: VACO filter idle or no update {cm}")
    check(not failures, "rl parity: " + "; ".join(failures))


# ---------------------------------------------------------------------------
# Phases 13-15: the rwkv6 static serve path
# ---------------------------------------------------------------------------


def _wkv6_inputs(torch, dtype, b, s, h, kd, state, decay=None, seed=0):
    """r, k, v ~ N(0, 1), decays in (0.1, 0.9) (or all ``decay``; "mix":
    a fifth of them exactly 0, a fifth exactly 1, a tenth 1e-6), u ~
    0.3 N(0, 1) and a N(0, 1) float32 state (or None), on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    w = torch.sigmoid(n(b, s, h, kd)) * 0.8 + 0.1
    if decay == "mix":
        m = torch.rand(w.shape, generator=gen, device="cuda")
        w[m < 0.2] = 0.0
        w[(m >= 0.2) & (m < 0.4)] = 1.0
        w[(m >= 0.4) & (m < 0.5)] = 1e-6
    elif decay is not None:
        w = torch.full_like(w, decay)
    args = [n(b, s, h, kd), n(b, s, h, kd), n(b, s, h, kd), w, 0.3 * n(h, kd)]
    return [a.to(dtype) for a in args] + [n(b, h, kd, kd) if state else None]


def _wkv6_bound(bb, s, hh, kd, state, esize, dname):
    """r, k, v, w and y once each, u once, the state read where the call
    carries one and written once; 5 operations per state element and
    step (r.S, then w*S + k*v; the bonus term is per key, not per
    element)."""
    n_tok = bb * s * hh * kd
    st_bytes = bb * hh * kd * kd * 4
    nbytes = (5 * n_tok + hh * kd) * esize + st_bytes * (2 if state else 1)
    return bound(nbytes, 5 * n_tok * kd, dname)


def wkv6_kernel_phase(torch):
    from repro_torch.kernels import ref
    from repro_torch.kernels.wkv6 import (IMPLS, split_steps, wkv6_cuda,
                                          wkv6_impl)

    b, h = RWKV_B, RWKV_H
    timed = ("prefill", "decode", "long", "long_b1")
    cases = (   # (case, B, S, H, K, carried state, decay); timed first
        ("prefill", b, RWKV_P, h, 64, False, None),
        ("decode", b, 1, h, 64, True, None),
        ("long", b, 512, h, 64, True, None),
        ("long_b1", 1, RWKV_LONG, h, 64, False, None),
        ("s63", 2, 63, 3, 64, True, None),        # sub-chunk edges
        ("s64", 2, 64, 3, 64, True, None),
        ("s65", 2, 65, 3, 64, True, None),
        ("s129", 1, 129, 2, 64, True, None),
        ("split_ragged", 1, 1000, 3, 64, True, None),   # ragged segment
        ("zero_decay", 2, 130, 2, 64, True, "mix"),     # w = 0, 1, 1e-6
        ("sweep_16", 2, 32, 2, 16, True, None),
        ("sweep_32", 2, 50, 3, 32, True, None),
        ("sweep_64", 2, 64, 2, 64, True, None),
        ("sweep_8", 2, 17, 1, 8, True, None),
        ("ragged", 3, 50, 5, 64, True, None),
        ("extreme_decay", 1, 32, 1, 64, False, 1e-6))
    headline, worst = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        esize = torch.empty((), dtype=dtype).element_size()
        for case, bb, s, hh, kd, state, decay in cases:
            args = _wkv6_inputs(torch, dtype, bb, s, hh, kd, state, decay,
                                seed=s * hh + kd)
            want_y, want_sf = ref.ref_wkv6(*args)
            picked = wkv6_impl(bb, s, hh)
            errs = {}
            for impl in IMPLS:   # every instantiation, forced
                y, sf = wkv6_cuda(*args, impl=impl)
                torch.cuda.synchronize()
                err = 0.0
                for got, want, what in ((y, want_y, "y"),
                                        (sf, want_sf, "state")):
                    check(bool(torch.isfinite(got).all())
                          and got.shape == want.shape,
                          f"wkv6/{case}/{dname}/{impl}: bad {what}")
                    e = (got.float() - want.float()).abs().max().item()
                    check(e <= WKV6_TOL[dname] * max(
                        1.0, want.float().abs().max().item()),
                        f"wkv6/{case}/{dname}/{impl}: {what} err {e}")
                    err = max(err, e)
                errs[impl] = err
            worst[dname] = max(worst.get(dname, 0.0), *errs.values())
            if case not in timed:
                emit(phase="kernel_check", kernel="wkv6", case=case,
                     dtype=dname, B=bb, S=s, H=hh, K=kd, impl=picked,
                     max_abs_err=errs, tol=WKV6_TOL[dname])
                continue
            kern = lambda: wkv6_cuda(*args)
            plain = lambda: ref.ref_wkv6(*args)
            b_ms, b_by = _wkv6_bound(bb, s, hh, kd, state, esize, dname)
            rec = dict(phase="kernel", kernel="wkv6", case=case,
                       dtype=dname, B=bb, S=s, H=hh, K=kd, impl=picked,
                       seg=split_steps(bb, s, hh) if picked == "split"
                       else 0,
                       max_abs_err=errs[picked], tol=WKV6_TOL[dname],
                       kernel_ms=time_ms(kern, iters=100),
                       plain_ms=time_ms(plain, iters=2 if s > 512 else 5,
                                        warmup=1),
                       library_ms=None, bound_ms=b_ms, bound_by=b_by,
                       kernel_device_ms=device_ms(kern, "wkv6_"),
                       plain_device_ms=device_ms(plain, iters=2))
            emit(**rec)
            if case == "decode":         # 384 of the path's 408 launches
                headline[("wkv6", dname)] = rec
    for dname, err in worst.items():
        headline[("wkv6", dname)] = dict(headline[("wkv6", dname)],
                                         max_abs_err=err)
    # Where each instantiation pays: device time of all three, forced,
    # at rwkv6's 32 heads of 64, float32, zero state.
    for bb in (1, 2, 4, 8):
        for s in (4, 16, 64, 256, 2048):
            args = _wkv6_inputs(torch, torch.float32, bb, s, h, 64, False,
                                seed=s)
            ms = {impl: device_ms(lambda: wkv6_cuda(*args, impl=impl),
                                  "wkv6_")
                  for impl in IMPLS}
            emit(phase="wkv6_crossover", B=bb, S=s, H=h, device_ms=ms,
                 picked=wkv6_impl(bb, s, h), seg=split_steps(bb, s, h))
    return headline


def rwkv_serve_phase(torch):
    from repro_torch import kernels
    from repro_torch.kernels.wkv6 import wkv6_impl
    from repro_torch.launch import serve as launcher
    from repro_torch.utils.tree import tree_leaves

    args = launcher.build_parser().parse_args([
        "--engine", "static", "--arch", "rwkv6-1.6b", "--full-width",
        "--device", "cuda", "--batch", str(RWKV_B), "--max-new-tokens",
        str(RWKV_NEW)])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    static = launcher.prepare_static(args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = static.bundle.cfg
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff,
           cfg.vocab_size) == (RWKV_L, 2048, RWKV_H, 7168, 65536)
          and cfg.attn_free, f"rwkv serve phase is not full width: {cfg}")
    check(tuple(static.prompts.shape) == (RWKV_B, RWKV_P),
          f"prompts {tuple(static.prompts.shape)}")
    static.generate()                                   # warm
    kernels.reset_launch_counts()
    res, seconds = launcher.run_static(static)
    launches = kernels.launch_counts()
    launcher.report_static(static, res, seconds)
    want = RWKV_L * (1 + RWKV_NEW)
    check(launches["wkv6"] == want,
          f"wkv6 launched {launches['wkv6']} times, want {want}")
    check(all(n == 0 for k, n in launches.items() if k != "wkv6"),
          f"the rwkv path launched other kernels: {launches}")
    comp, lb, mask = res.completion, res.log_beta, res.mask
    check(tuple(comp.shape) == (RWKV_B, RWKV_NEW) and
          bool((comp >= 0).all() and (comp < cfg.vocab_size).all()),
          f"bad completion {comp}")
    check(bool((mask[:, 0] == 1).all()), "a row got no token")
    live = mask > 0
    check(bool(torch.isfinite(lb).all() and (lb[live] <= 1e-6).all()),
          f"bad log_beta {lb}")
    # Prefill alone (the forward that fills the cache), then one
    # profiled generate against the unprofiled wall above.
    prefill = lambda: static.bundle.forward(static.params, static.prompts,
                                            return_cache=True)
    prefill()
    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t1) * 1e3)
    busy_ms, rows = profile_kernels(static.generate)
    wall_ms = seconds * 1e3
    n_tok = RWKV_B * RWKV_NEW
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(static.params))
    emit(phase="rwkv_serve", config=cfg.name, layers=cfg.n_layers,
         batch=RWKV_B, prompt_len=RWKV_P, new_tokens=RWKV_NEW,
         init_s=init_s, seconds=seconds, tokens_per_s=n_tok / seconds,
         prefill_ms=sorted(prefill_ms)[1],
         decode_tokens_per_s=n_tok / (seconds - sorted(prefill_ms)[1] / 1e3),
         decode_step_ms=(wall_ms - sorted(prefill_ms)[1]) / RWKV_NEW,
         weights_gb=weight_bytes / 1e9,
         decode_step_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
         device_busy_ms=busy_ms, idle_share=max(0.0, 1 - busy_ms / wall_ms),
         kernel_launches=sum(n for _, _, n in rows),
         wkv6_ms=sum(ms for k, ms, _ in rows if "wkv6" in k),
         top_kernels=rows[:8],
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         min_log_beta=lb[live].min().item(), launches=launches)
    rwkv_long_forward(torch, static, kernels,
                      wkv6_impl(1, RWKV_LONG, RWKV_H))
    del static, res
    torch.cuda.empty_cache()
    return launches


def _rwkv_long_whole(rows) -> bool:
    """A whole capture of the rwkv6 long forward holds each wkv6 kernel
    once a layer."""
    counts = [c for k, _, c in rows if "wkv6_" in k]
    return bool(counts) and all(c == RWKV_L for c in counts)


def rwkv_long_forward(torch, static, kernels, impl,
                      tag="rwkv_long_forward"):
    """One forward of B 1 x S 2048 through the static engine's bundle:
    24 ``wkv6`` calls (``impl`` names the instantiation they take), wall
    and device time, ``wkv6``'s share."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(3, static.bundle.cfg.vocab_size, (1, RWKV_LONG),
                           generator=gen, device="cuda")
    long_fwd = lambda: static.bundle.forward(static.params, tokens)
    out = long_fwd()
    check(bool(torch.isfinite(out.logits).all())
          and tuple(out.logits.shape[:2]) == (1, RWKV_LONG),
          "rwkv long forward: bad logits")
    del out
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        long_fwd()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    kernels.reset_launch_counts()
    long_fwd()
    torch.cuda.synchronize()
    n_wkv = kernels.launch_counts()["wkv6"]
    check(n_wkv == RWKV_L, f"rwkv long forward launched wkv6 {n_wkv} times")
    busy, rows = profile_kernels(long_fwd, _rwkv_long_whole)
    wkv_rows = [r for r in rows if "wkv6_" in r[0]]
    emit(phase=tag, batch=1, seq=RWKV_LONG, wall_ms=sorted(walls)[1],
         device_busy_ms=busy,
         wkv6_ms=sum(ms for _, ms, _ in wkv_rows),
         wkv6_share=sum(ms for _, ms, _ in wkv_rows) / busy,
         wkv6_launches=n_wkv, wkv6_impl=impl,
         wkv6_kernels=wkv_rows, top_kernels=rows[:8],
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del tokens


def rwkv_parity_phase(torch):
    from repro_torch.configs import get_config
    from repro_torch.data.mathgen import MathTaskDataset
    from repro_torch.models.registry import build
    from repro_torch.rollout.sampler import generate, gumbel_noise
    from repro_torch.utils.tree import tree_to

    cfg = get_config("rwkv6-1.6b").replace(n_layers=2)
    bundle = build(cfg)
    params = _scale_dense(bundle.init(torch.Generator().manual_seed(0)))
    toks, _, _ = MathTaskDataset(prompt_len=RWKV_P, seed=1).sample_batch(
        RWKV_B)
    prompts = torch.from_numpy(toks)
    noise_gen = torch.Generator().manual_seed(5)
    noises = [gumbel_noise((RWKV_B, cfg.vocab_size), noise_gen, "cpu")
              for _ in range(RWKV_NEW)]
    out = {}
    for dev in ("cpu", "cuda"):
        p, x = tree_to(params, dev), prompts.to(dev)
        fwd = bundle.forward(p, x, return_cache=True)
        gens = {mode: generate(bundle, p, x, max_new_tokens=RWKV_NEW,
                               temperature=temp,
                               noise=lambda t, shape: noises[t])
                for mode, temp in (("greedy", 0.0), ("sampled", 1.0))}
        out[dev] = (tree_to({"logits": fwd.logits, **fwd.cache}, "cpu"),
                    {m: tree_to(g._asdict(), "cpu") for m, g in gens.items()})
        del p, fwd, gens
    (cpu_f, cpu_g), (card_f, card_g) = out["cpu"], out["cuda"]
    g, w = card_f["logits"], cpu_f["logits"]
    check(bool(torch.isfinite(g).all()), "rwkv parity: non-finite logits")
    rec = dict(phase="rwkv_parity", config=cfg.name, layers=cfg.n_layers,
               logits_max_abs_err=(g - w).abs().max().item(),
               logits_max_abs=w.abs().max().item(), tol=1e-4)
    check(torch.allclose(g, w, rtol=1e-4, atol=1e-4),
          f"rwkv parity: logits differ by {rec['logits_max_abs_err']}")
    rec["cache_max_abs_err"] = {
        k: _scaled_err(card_f[k], cpu_f[k], 1e-4, f"rwkv cache {k}")
        for k in ("wkv", "shift_tm", "shift_cm")}
    rec["cache_max_abs"] = {k: cpu_f[k].abs().max().item()
                            for k in ("wkv", "shift_tm", "shift_cm")}
    check(torch.equal(card_f["pos"], cpu_f["pos"]), "rwkv parity: pos")
    for mode in ("greedy", "sampled"):
        want, got = cpu_g[mode], card_g[mode]
        check(torch.equal(got["tokens"], want["tokens"]),
              f"rwkv parity/{mode}: tokens differ: cuda {got['completion']} "
              f"cpu {want['completion']}")
        err = (got["log_beta"] - want["log_beta"]).abs().max().item()
        check(err <= 1e-4, f"rwkv parity/{mode}: log_beta differs by {err}")
        distinct = len(torch.unique(want["completion"]))
        min_lb = want["log_beta"][want["mask"] > 0].min().item()
        if mode == "greedy":
            check(distinct > 5, f"rwkv parity/greedy: only {distinct} "
                  "distinct tokens")
        else:
            check(min_lb < -0.1, "rwkv parity/sampled: every draw was the "
                  f"argmax (min log_beta {min_lb})")
        rec[mode] = dict(tokens=int(want["mask"].sum().item()),
                         distinct_tokens=distinct, min_log_beta=min_lb,
                         log_beta_max_abs_err=err, tol=1e-4)
    emit(**rec)


# ---------------------------------------------------------------------------
# Phases 16-18: the hymba static serve path
# ---------------------------------------------------------------------------


def _attended_pairs(s, window):
    """(query, key) pairs a causal row set of length ``s`` attends."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_kernel_phase(torch):
    h, kv, w = HYMBA_H, HYMBA_KV, HYMBA_WINDOW
    cases = (   # (case, B, S, H, KV, D, window); the first five timed
        ("prefill_local", HYMBA_B, HYMBA_P, h, kv, 64, w),
        ("prefill_global", HYMBA_B, HYMBA_P, h, kv, 64, None),
        ("long_local", 1, HYMBA_LONG, h, kv, 64, w),
        ("long_global", 1, HYMBA_LONG, h, kv, 64, None),
        ("qwen_long", 1, HYMBA_LONG, 14, 2, 64, None),
        ("past_window", 1, 1100, h, kv, 64, w),
        ("qwen_prefill", 64, 32, 14, 2, 64, None),
        ("qwen_window", 4, 300, 14, 2, 64, 100),
        ("edge_s1", 2, 1, h, kv, 64, None),
        ("edge_s63", 2, 63, 14, 2, 64, None),
        ("edge_s65", 2, 65, 14, 2, 64, 16),
        ("sweep_32", 2, 64, 4, 2, 32, None),
        ("sweep_16", 2, 100, 4, 1, 16, None),
        ("sweep_64", 2, 128, 8, 8, 64, 32),
        ("sweep_32w", 2, 96, 4, 2, 32, 16),
        ("sweep_8", 2, 65, 2, 2, 8, 7))
    timed = ("prefill_local", "prefill_global", "long_local", "long_global",
             "qwen_long")
    headline, worst = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for case in cases:
            err, rec = _flash_case(torch, dtype, *case,
                                   timed=case[0] in timed)
            worst[dname] = max(worst.get(dname, 0.0), err)
            if case[0] == "prefill_local":  # 30 of a generate's 32 launches
                headline[("flash_attention", dname)] = rec
    for dname, err in worst.items():
        headline[("flash_attention", dname)] = dict(
            headline[("flash_attention", dname)], max_abs_err=err)
    return headline


def _sdpa_fwd(torch, q, k, v, window):
    """The library yardstick of the flash forward, timed only: SDPA on
    [B, H, S, D] with the kv heads repeated (not timed), causal, or with
    the band mask when a window is given."""
    import torch.nn.functional as F

    s, hh, kk = q.shape[1], q.shape[2], k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.repeat_interleave(hh // kk, dim=2).transpose(1, 2)
              .contiguous() for x in (k, v))
    if window is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)
    i = torch.arange(s, device="cuda")
    band = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band)


def _flash_rate(impl: str, dname: str) -> str:
    """The ``PEAK_FLOPS`` key of a flash instantiation's bound: 3xTF32 on
    the tensor cores for ``tf32`` and float32 ``d256``, else the
    dtype's."""
    return "tf32x3" if impl == "tf32" or (impl == "d256"
                                          and dname == "float32") else dname


def _flash_case(torch, dtype, case, b, s, hh, kk, d, window, timed,
                tol=FLASH_TOL):
    """``flash_attention_cuda`` against ``ref_attention`` on one case,
    within ``tol``; a timed case also beside the plain version,
    SDPA (timed only) and its bound, emitted.  Returns ``(max_abs_err,
    record or None)``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (FLASH_SYMBOLS,
                                                     flash_attention_cuda,
                                                     flash_impl)

    dname = str(dtype).split(".")[-1]
    esize = torch.empty((), dtype=dtype).element_size()
    gen = torch.Generator(device="cuda").manual_seed(s + hh + d)
    q, k, v = (torch.randn(b, s, n, d, generator=gen,
                           device="cuda").to(dtype)
               for n in (hh, kk, kk))
    got = flash_attention_cuda(q, k, v, window=window)
    want = ref.ref_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()) and got.shape == want.shape
          and got.dtype == dtype, f"flash/{case}/{dname}: bad output")
    err = (got.float() - want.float()).abs().max().item()
    check(err <= tol[dname], f"flash/{case}/{dname}: max_abs_err {err}")
    if not timed:
        return err, None
    kern = lambda: flash_attention_cuda(q, k, v, window=window)
    plain = lambda: ref.ref_attention(q, k, v, window=window)
    lib = _sdpa_fwd(torch, q, k, v, window)
    # q, k, v read once and out written once; 4 D operations (the two
    # products) per attended (query, key) pair and head.
    nbytes = (2 * b * s * hh * d + 2 * b * s * kk * d) * esize
    flops = 4 * d * hh * b * _attended_pairs(s, window)
    # The instantiation that ran, by its profiled name.
    impl = flash_impl(dtype, d)
    symbol = FLASH_SYMBOLS[impl]
    b_ms, b_by = bound(nbytes, flops, _flash_rate(impl, dname))
    rec = dict(phase="kernel", kernel="flash_attention", case=case,
               dtype=dname, impl=impl, B=b, S=s, H=hh, KV=kk, D=d,
               window=window, max_abs_err=err, tol=tol[dname],
               kernel_ms=time_ms(kern, iters=50),
               plain_ms=time_ms(plain, iters=5, warmup=1),
               library_ms=time_ms(lib, iters=50),
               bound_ms=b_ms, bound_by=b_by,
               kernel_device_ms=device_ms(kern, symbol),
               plain_device_ms=device_ms(plain, iters=3),
               library_device_ms=device_ms(lib, iters=5))
    emit(**rec)
    check(rec["kernel_device_ms"] is not None,
          f"flash/{case}/{dname}: no {symbol} in the profile")
    return err, rec


def _ssm_args(torch, dtype, bb, s, ii, nn, state, dt_scale=1.0,
              strided=False, seed=0):
    """u, dt = softplus(N(0, 1)) x ``dt_scale``, b_t, c_t, a = -exp(N(0, 1))
    and h0 on the card; ``strided``: b_t and c_t as column slices of one
    ``[B, S, dt_rank + 2N]`` tensor, the layout of hymba's ``x_proj``."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    u, dt = r(bb, s, ii), F.softplus(r(bb, s, ii)) * dt_scale
    if strided:
        proj = r(bb, s, HYMBA_DT_RANK + 2 * nn).to(dtype)
        b_t = proj[..., HYMBA_DT_RANK:HYMBA_DT_RANK + nn]
        c_t = proj[..., HYMBA_DT_RANK + nn:]
    else:
        b_t, c_t = r(bb, s, nn).to(dtype), r(bb, s, nn).to(dtype)
    return [u.to(dtype), dt.to(dtype), b_t, c_t, -torch.exp(r(ii, nn)),
            r(bb, ii, nn) if state else None]


def ssm_kernel_phase(torch):
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssm_scan import (CHUNKED_MIN_STEPS,
                                              chunk_steps, ssm_impl,
                                              ssm_scan_cuda)

    b, i, n = HYMBA_B, HYMBA_I, HYMBA_N
    sx = CHUNKED_MIN_STEPS[0]   # a grid of few blocks (B 2 x I 300)
    timed = ("prefill", "decode", "long", "long_b1")
    cases = (   # (case, B, S, I, N, carried state, dt scale, strided b/c)
        ("prefill", b, HYMBA_P, i, n, False, 1.0, False),
        ("decode", b, 1, i, n, True, 1.0, False),
        ("long", b, 512, i, n, True, 1.0, False),
        ("long_b1", 1, HYMBA_LONG, i, n, False, 1.0, False),
        ("strided_decode", b, 1, i, n, True, 1.0, True),
        ("strided_long", 2, 600, i, n, True, 1.0, True),
        ("below_crossover", 2, sx - 1, 300, n, True, 1.0, False),
        ("at_crossover", 2, sx, 300, n, True, 1.0, False),
        ("ragged_chunk", 2, sx + 67, 300, n, True, 1.0, False),
        ("ragged_chunk64", 1, HYMBA_LONG + 37, i, n, True, 1.0, True),
        ("underflow", 2, 300, 300, n, True, 200.0, False),
        ("carried_long", 1, HYMBA_LONG, 300, n, True, 1.0, True),
        ("sweep_8", 2, 16, 32, 8, True, 1.0, False),
        ("sweep_16", 2, 33, 100, 16, True, 1.0, False),
        ("sweep_64", 2, 64, 128, 16, True, 1.0, False),
        ("sweep_4", 2, 7, 8, 4, True, 1.0, False),
        ("ragged", 3, 50, 300, 16, False, 1.0, False))
    headline, worst = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        esize = torch.empty((), dtype=dtype).element_size()
        for case, bb, s, ii, nn, state, scale, strided in cases:
            args = _ssm_args(torch, dtype, bb, s, ii, nn, state, scale,
                             strided, seed=s * ii)
            impl = ssm_impl(bb, s, ii)
            chunk = chunk_steps(bb, s, ii) if impl == "chunked" else 0
            y, hf = ssm_scan_cuda(*args)
            want_y, want_h = ref.ref_ssm_scan(*args)
            torch.cuda.synchronize()
            err = 0.0
            for got, want, what in ((y, want_y, "y"), (hf, want_h, "state")):
                check(bool(torch.isfinite(got).all())
                      and got.shape == want.shape,
                      f"ssm_scan/{case}/{dname}: bad {what}")
                e = (got.float() - want.float()).abs().max().item()
                check(e <= SSM_TOL[dname] * max(
                    1.0, want.float().abs().max().item()),
                    f"ssm_scan/{case}/{dname}/{impl}: {what} err {e}")
                err = max(err, e)
            worst[dname] = max(worst.get(dname, 0.0), err)
            if case not in timed:
                emit(phase="kernel_check", kernel="ssm_scan", case=case,
                     dtype=dname, B=bb, S=s, I=ii, N=nn, impl=impl,
                     chunk=chunk, strided=strided, max_abs_err=err,
                     tol=SSM_TOL[dname])
                continue
            kern = lambda: ssm_scan_cuda(*args)
            plain = lambda: ref.ref_ssm_scan(*args)
            # u, dt, b, c and y once each, a once, the state read where
            # the call carries one and written once; about 7 operations
            # per state element and step (exp, the update, the y term).
            st_bytes = bb * ii * nn * 4
            nbytes = ((3 * bb * s * ii + 2 * bb * s * nn) * esize
                      + ii * nn * 4 + st_bytes * (2 if state else 1))
            b_ms, b_by = bound(nbytes, 7 * bb * s * ii * nn, dname)
            rec = dict(phase="kernel", kernel="ssm_scan", case=case,
                       dtype=dname, B=bb, S=s, I=ii, N=nn, impl=impl,
                       chunk=chunk, max_abs_err=err, tol=SSM_TOL[dname],
                       kernel_ms=time_ms(kern, iters=100),
                       plain_ms=time_ms(plain, iters=3, warmup=1),
                       library_ms=None, bound_ms=b_ms, bound_by=b_by,
                       kernel_device_ms=device_ms(kern, "ssm_scan_"),
                       plain_device_ms=device_ms(plain, iters=2))
            emit(**rec)
            if case == "decode":         # 512 of a generate's 544 launches
                headline[("ssm_scan", dname)] = rec
    for dname, err in worst.items():
        headline[("ssm_scan", dname)] = dict(headline[("ssm_scan", dname)],
                                             max_abs_err=err)
    # Where the chunked scan starts to beat the serial kernel: device time
    # of each, forced, at hymba's width, float32, zero state.
    for bb, s in ([(1, s) for s in (64, 256)]
                  + [(bb, s) for bb in (1, 2, 4, 8)
                     for s in (128, 512, 2048)]):
        args = _ssm_args(torch, torch.float32, bb, s, i, n, False, seed=s)
        ms = {impl: device_ms(lambda: ssm_scan_cuda(*args, impl=impl),
                              "ssm_scan_")
              for impl in ("serial", "chunked")}
        emit(phase="ssm_crossover", B=bb, S=s, I=i, N=n,
             serial_device_ms=ms["serial"], chunked_device_ms=ms["chunked"],
             chunk=chunk_steps(bb, s, i), picked=ssm_impl(bb, s, i))
    return headline


def _long_forward_whole(rows) -> bool:
    """A whole capture of the hymba long forward holds every layer's
    flash and scan kernels."""
    return (sum(c for k, _, c in rows if "flash_kernel" in k) == HYMBA_L
            and all(c == HYMBA_L for k, _, c in rows if "ssm_scan_" in k))


def hymba_serve_phase(torch):
    from repro_torch import kernels
    from repro_torch.kernels.ssm_scan import ssm_impl
    from repro_torch.launch import serve as launcher
    from repro_torch.utils.tree import tree_leaves

    args = launcher.build_parser().parse_args([
        "--engine", "static", "--arch", "hymba-1.5b", "--full-width",
        "--device", "cuda", "--batch", str(HYMBA_B), "--max-new-tokens",
        str(HYMBA_NEW)])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    static = launcher.prepare_static(args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = static.bundle.cfg
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.d_ff, cfg.vocab_size, cfg.ssm.state_dim) ==
          (HYMBA_L, 1600, HYMBA_H, HYMBA_KV, 5504, 32001, HYMBA_N)
          and cfg.hybrid_attn_ssm, f"hymba serve phase is not full width: "
          f"{cfg}")
    check(tuple(static.prompts.shape) == (HYMBA_B, HYMBA_P),
          f"prompts {tuple(static.prompts.shape)}")
    n_params = sum(t.numel() for t in tree_leaves(static.params))
    static.generate()                                   # warm
    kernels.reset_launch_counts()
    res, seconds = launcher.run_static(static)
    launches = kernels.launch_counts()
    launcher.report_static(static, res, seconds)
    want = {"flash_attention": HYMBA_L,                  # the prefill
            "ssm_scan": HYMBA_L * (1 + HYMBA_NEW)}       # + every step
    for name, n in want.items():
        check(launches[name] == n,
              f"{name} launched {launches[name]} times, want {n}")
    check(all(n == 0 for k, n in launches.items() if k not in want),
          f"the hymba path launched other kernels: {launches}")
    comp, lb, mask = res.completion, res.log_beta, res.mask
    check(tuple(comp.shape) == (HYMBA_B, HYMBA_NEW) and
          bool((comp >= 0).all() and (comp < cfg.vocab_size).all()),
          f"bad completion {comp}")
    check(bool((mask[:, 0] == 1).all()), "a row got no token")
    live = mask > 0
    check(bool(torch.isfinite(lb).all() and (lb[live] <= 1e-6).all()),
          f"bad log_beta {lb}")
    check(bool(torch.isfinite(res.values).all()), "non-finite values")
    prefill = lambda: static.bundle.forward(
        static.params, static.prompts, return_cache=True,
        cache_len=HYMBA_P + HYMBA_NEW)
    prefill()
    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t1) * 1e3)
    busy_ms, rows = profile_kernels(static.generate)
    wall_ms = seconds * 1e3
    n_tok = HYMBA_B * HYMBA_NEW
    pre = sorted(prefill_ms)[1]
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(static.params))
    emit(phase="hymba_serve", config=cfg.name, layers=cfg.n_layers,
         params=n_params, batch=HYMBA_B, prompt_len=HYMBA_P,
         new_tokens=HYMBA_NEW, init_s=init_s, seconds=seconds,
         tokens_per_s=n_tok / seconds, prefill_ms=pre,
         decode_tokens_per_s=n_tok / (seconds - pre / 1e3),
         decode_step_ms=(wall_ms - pre) / HYMBA_NEW,
         weights_gb=weight_bytes / 1e9,
         decode_step_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
         device_busy_ms=busy_ms, idle_share=max(0.0, 1 - busy_ms / wall_ms),
         kernel_launches=sum(c for _, _, c in rows),
         flash_ms=sum(ms for k, ms, _ in rows if "flash_kernel" in k),
         ssm_scan_ms=sum(ms for k, ms, _ in rows if "ssm_scan_" in k),
         top_kernels=rows[:8],
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         min_log_beta=lb[live].min().item(), launches=launches)
    # One long forward (B 1 x S 2048): 30 windowed layers skip the key
    # tiles wholly before their window, the 2 global ones do not.
    gen = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(3, cfg.vocab_size, (1, HYMBA_LONG), generator=gen,
                           device="cuda")
    long_fwd = lambda: static.bundle.forward(static.params, tokens)
    out = long_fwd()
    check(bool(torch.isfinite(out.logits).all()), "long forward: non-finite")
    del out
    long_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        long_fwd()
        torch.cuda.synchronize()
        long_ms.append((time.perf_counter() - t1) * 1e3)
    kernels.reset_launch_counts()
    long_fwd()
    torch.cuda.synchronize()
    check(kernels.launch_counts()["flash_attention"] == HYMBA_L
          and kernels.launch_counts()["ssm_scan"] == HYMBA_L,
          f"long forward launched {kernels.launch_counts()}")
    long_busy, long_rows = profile_kernels(long_fwd, _long_forward_whole)
    flash = {kind: [(ms, c) for k, ms, c in long_rows
                    if "flash_kernel" in k and tag in k]
             for kind, tag in (("local", "true>"), ("global", "false>"))}
    per_layer = {kind: (sum(ms for ms, _ in r) / max(1, sum(c for _, c in r)))
                 for kind, r in flash.items()}
    check(sum(c for r in flash.values() for _, c in r) == HYMBA_L,
          f"long forward: flash rows {flash}")
    emit(phase="hymba_long_forward", batch=1, seq=HYMBA_LONG,
         wall_ms=sorted(long_ms)[1], device_busy_ms=long_busy,
         flash_local_ms_per_layer=per_layer["local"],
         flash_global_ms_per_layer=per_layer["global"],
         flash_ms=sum(ms for r in flash.values() for ms, _ in r),
         ssm_scan_ms=sum(ms for k, ms, _ in long_rows if "ssm_scan_" in k),
         ssm_scan_impl=ssm_impl(1, HYMBA_LONG, HYMBA_I),
         ssm_scan_kernels=[r for r in long_rows if "ssm_scan_" in r[0]],
         top_kernels=long_rows[:8],
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del static, res, tokens
    torch.cuda.empty_cache()
    return launches


def hymba_parity_phase(torch):
    from repro_torch.configs import get_config
    from repro_torch.data.mathgen import MathTaskDataset
    from repro_torch.models.registry import build
    from repro_torch.rollout.sampler import generate, gumbel_noise
    from repro_torch.utils.tree import tree_to

    cfg = get_config("hymba-1.5b").replace(n_layers=2)
    bundle = build(cfg)
    params = _scale_dense(bundle.init(torch.Generator().manual_seed(0)))
    toks, _, _ = MathTaskDataset(prompt_len=HYMBA_P, seed=1).sample_batch(
        HYMBA_B)
    prompts = torch.from_numpy(toks)
    long_tokens = torch.randint(3, cfg.vocab_size, (1, 1100),
                                generator=torch.Generator().manual_seed(9))
    noise_gen = torch.Generator().manual_seed(5)
    noises = [gumbel_noise((HYMBA_B, cfg.vocab_size), noise_gen, "cpu")
              for _ in range(HYMBA_NEW)]
    inputs = (("prompts", prompts), ("past_window", long_tokens))

    def forwards(p, dev):
        fwds = {}
        for name, x in inputs:
            f = bundle.forward(p, x.to(dev), return_cache=True)
            fwds[name] = tree_to({"logits": f.logits, **f.cache}, "cpu")
            del f
        return fwds

    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_to(params, dev)
        fwds = forwards(p, dev)
        gens = {mode: generate(bundle, p, prompts.to(dev),
                               max_new_tokens=HYMBA_NEW, temperature=temp,
                               noise=lambda t, shape: noises[t])
                for mode, temp in (("greedy", 0.0), ("sampled", 1.0))}
        out[dev] = (fwds,
                    {m: tree_to(g._asdict(), "cpu") for m, g in gens.items()})
        del p, gens
    (cpu_f, cpu_g), (card_f, card_g) = out["cpu"], out["cuda"]
    rec = dict(phase="hymba_parity", config=cfg.name, layers=cfg.n_layers,
               logits_rtol=1e-4, logits_atol=HYMBA_LOGITS_ATOL, tol=1e-4)
    for name, _ in inputs:
        g, w = card_f[name]["logits"], cpu_f[name]["logits"]
        check(bool(torch.isfinite(g).all()),
              f"hymba parity/{name}: non-finite logits")
        err = (g - w).abs().max().item()
        check(torch.allclose(g, w, rtol=1e-4, atol=HYMBA_LOGITS_ATOL),
              f"hymba parity/{name}: logits differ by {err}")
        keys = ("k", "v", "ssm", "conv")
        rec[name] = dict(
            seq=int(g.shape[1]), logits_max_abs_err=err,
            logits_max_abs=w.abs().max().item(),
            cache_max_abs_err={k: _scaled_err(
                card_f[name][k], cpu_f[name][k], 1e-4,
                f"hymba {name} cache {k}") for k in keys},
            cache_max_abs={k: cpu_f[name][k].abs().max().item()
                           for k in keys})
        check(torch.equal(card_f[name]["pos"], cpu_f[name]["pos"]),
              f"hymba parity/{name}: pos")
    for mode in ("greedy", "sampled"):
        want, got = cpu_g[mode], card_g[mode]
        check(torch.equal(got["tokens"], want["tokens"]),
              f"hymba parity/{mode}: tokens differ: cuda "
              f"{got['completion']} cpu {want['completion']}")
        err = (got["log_beta"] - want["log_beta"]).abs().max().item()
        check(err <= 1e-4, f"hymba parity/{mode}: log_beta differs by {err}")
        distinct = len(torch.unique(want["completion"]))
        min_lb = want["log_beta"][want["mask"] > 0].min().item()
        if mode == "greedy":
            check(distinct > 5, f"hymba parity/greedy: only {distinct} "
                  "distinct tokens")
        else:
            check(min_lb < -0.1, "hymba parity/sampled: every draw was the "
                  f"argmax (min log_beta {min_lb})")
        rec[mode] = dict(tokens=int(want["mask"].sum().item()),
                         distinct_tokens=distinct, min_log_beta=min_lb,
                         log_beta_max_abs_err=err, tol=1e-4)
    emit(**rec)


# ---------------------------------------------------------------------------
# Phases 19-20: RLVR through the serve engine
# ---------------------------------------------------------------------------

SERVE_RLVR_ARGS = [
    "rlvr", "--full-width", "--device", "cuda", "--warmup-steps", "2",
    "--n-minibatches", "2", "--phases", "1", "--producer", "serve",
    "--forced-lag", "2", "--controller", "tv_gate:delta=0.05,mode=downweight"]


def serve_rlvr_phase(torch):
    """``train rlvr --full-width --producer serve --forced-lag 2`` with the
    TV gate, cut as phase 7 is; then one more minibatch, timed, and one
    profiled.  Returns the prefill rows a minibatch, the learner step
    p50 and the generation rate, which phase 29 reports beside its own."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.launch import train as launcher
    from repro_torch.obs.tracer import Tracer
    from repro_torch.runtime import ServeRolloutProducer
    from repro_torch.utils.tree import tree_leaves

    args = launcher.build_parser().parse_args(SERVE_RLVR_ARGS)
    tracer = Tracer(detail="spans")
    items = []
    put = ServeRolloutProducer._put

    def recording_put(self, mb, **meta):
        # The store has not moved since this minibatch was produced
        # (phase-locked), so this is the version the lag resolved to.
        items.append((sorted(set(np.asarray(mb.versions).ravel().tolist())),
                      self.store.resolve_lagged(-self.version_offset),
                      self.engine.version))
        put(self, mb, **meta)

    torch.cuda.reset_peak_memory_stats()
    ServeRolloutProducer._put = recording_put
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        trainer, res, warm_loss = launcher.run(args, tracer)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        ServeRolloutProducer._put = put
    cfg, hp, engine = trainer.bundle.cfg, trainer.hp, trainer.engine
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.d_ff, cfg.vocab_size) == (24, 896, 14, 2, 4864, 151936),
          f"serve rlvr phase is not full width: {cfg}")
    steps = len(res.phase_logs)
    check(steps == hp.n_minibatches and trainer.nonfinite_skipped == 0,
          f"{steps} learner steps logged of {hp.n_minibatches}")
    check(len(items) == steps and all(
        got == [want] and want == served for got, want, served in items),
        f"items' versions against resolve_lagged(-2): {items}")
    for name in SERVE_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} never launched on the serve-producer path")
    # One backward a learner step; one forward a learner step and one a
    # TV-gate scoring (every item is scored once, none dropped).
    check(launches["fused_logprob_bwd"] == steps
          and launches["fused_logprob"] == 2 * steps,
          f"log-prob kernels launched {launches['fused_logprob']} / "
          f"{launches['fused_logprob_bwd']} times in {steps} learner steps")
    # flash: each TV scoring's forward and each eval generate's prefill,
    # once a layer, and each warmup and learner step's forward with its
    # backward; the engine's prefill is paged.
    forwards = steps + 1 + len(res.eval_accuracy)
    grad_steps = hp.warmup_steps + steps
    check(launches["flash_attention"]
          == cfg.n_layers * (forwards + grad_steps)
          and launches["flash_attention_bwd"] == cfg.n_layers * grad_steps,
          f"flash_attention / _bwd launched {launches['flash_attention']} "
          f"/ {launches['flash_attention_bwd']} times for {forwards} no-grad "
          f"forwards and {grad_steps} steps of {cfg.n_layers} layers")
    gnorm = trainer.metrics.histogram("train_grad_norm").summary()
    check(math.isfinite(warm_loss) and all(
        math.isfinite(l.tv) and math.isfinite(l.weight)
        for l in res.phase_logs) and math.isfinite(gnorm["max"]),
        "non-finite warmup loss, tv, weight or grad norm")
    # The init (v0, which the engine still holds) against the trained
    # params; and the RL phase alone (v1, the warm-started base).
    moved = max((a - b).abs().max().item() for a, b in zip(
        tree_leaves(trainer.state.params), tree_leaves(engine.params)))
    moved_rl = max((a - b).abs().max().item() for a, b in zip(
        tree_leaves(trainer.state.params),
        tree_leaves(trainer.store.get(1))))
    check(moved > 0, "serve rlvr phase: the params did not move")
    produce = _span_seconds(tracer, "produce")
    tokens_out = engine.stats.tokens_out
    prefill_rows = engine.stats.prefill_tokens / len(produce)
    step = trainer.metrics.histogram("train_step_s").summary()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # One more minibatch through the engine: wall, then device time.
    produce_one = trainer.regime._produce_minibatch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    produce_one()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, rows = profile_kernels(produce_one)
    emit(phase="serve_rlvr", config=cfg.name, layers=cfg.n_layers,
         seconds=seconds, warmup_loss=warm_loss,
         eval_accuracy=res.eval_accuracy, learner_steps=steps,
         learner_step_p50_ms=step["p50"] * 1e3,
         learner_step_mean_ms=step["mean"] * 1e3,
         minibatches_generated=len(produce), tokens_out=tokens_out,
         generation_tokens_per_s=tokens_out / sum(produce),
         prefill_rows_per_minibatch=prefill_rows,
         swaps=engine.stats.swaps,
         forced_versions=[want for _, want, _ in items],
         item_lag=[l.staleness for l in res.phase_logs],
         tv=[l.tv for l in res.phase_logs],
         weight=[l.weight for l in res.phase_logs],
         mean_reward=[l.mean_reward for l in res.phase_logs],
         grad_norm_max=gnorm["max"], max_param_change=moved,
         max_param_change_rl=moved_rl, peak_memory_gib=peak,
         launches=launches)
    emit(phase="serve_rlvr_profile", wall_ms=wall_ms, device_busy_ms=busy_ms,
         idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
         kernel_launches=sum(n for _, _, n in rows), top_kernels=rows[:8])
    # Phase 29 runs this cell with the prefix cache and speculation on.
    return dict(prefill_rows=prefill_rows,
                learner_step_p50_ms=step["p50"] * 1e3,
                generation_tokens_per_s=tokens_out / sum(produce))


SWAP_PUBLISH_AT = 4         # the step before which v1 is published


def swap_parity_phase(torch):
    """2 layers at full width over a ``PolicyStore``, ``swap_interval=1``,
    one publish mid-generation: the CPU's plain path against the card's
    kernels, greedy and sampled on the same Gumbel noise."""
    from repro_torch.configs import get_config
    from repro_torch.data.mathgen import MathTaskDataset
    from repro_torch.data.tokenizer import get_tokenizer
    from repro_torch.models.registry import build
    from repro_torch.rollout.sampler import gumbel_noise, sample
    from repro_torch.runtime import PolicyStore
    from repro_torch.serve import ServeEngine
    from repro_torch.utils.tree import tree_leaves, tree_to

    cfg = get_config("qwen2.5-0.5b").replace(n_layers=2)
    bundle = build(cfg)
    policies = [_scale_dense(bundle.init(torch.Generator().manual_seed(s)))
                for s in (0, 1)]
    tok = get_tokenizer()
    toks, _, _ = MathTaskDataset(prompt_len=32, seed=1).sample_batch(4)
    prompts = [row[row != tok.pad_id] for row in toks]
    rec = dict(phase="swap_parity", config=cfg.name, layers=cfg.n_layers,
               publish_at_step=SWAP_PUBLISH_AT, tol=1e-4)
    for mode, temperature in (("greedy", 0.0), ("sampled", 1.0)):
        out = {}
        for dev in ("cpu", "cuda"):
            store = PolicyStore(tree_to(policies[0], dev), capacity=2)
            eng = ServeEngine(bundle, store=store, swap_interval=1,
                              num_blocks=128, block_size=8, max_batch=4,
                              decode_chunk=4, prefill_chunk=16,
                              dispatch_budget=32, temperature=temperature,
                              seed=2, device=dev)
            noise = torch.Generator().manual_seed(5)
            eng._sample = lambda logits, e=eng, g=noise: sample(
                logits, e._temperature, e._top_p,
                gumbel_noise(logits.shape, g, "cpu").to(logits.device))
            for i, p in enumerate(prompts):
                eng.submit(p, (8, 16, 24, 16)[i], request_id=i)
            trajs, step = {}, 0
            while eng.has_work and step < 1000:
                if step == SWAP_PUBLISH_AT:
                    store.publish(tree_to(policies[1], dev))
                trajs.update({t.request_id: t for t in eng.step()})
                step += 1
            ring = {t.untyped_storage().data_ptr()
                    for t in tree_leaves(store.buffer.stacked)}
            check({t.untyped_storage().data_ptr()
                   for t in tree_leaves(eng.params)} <= ring,
                  f"swap parity/{mode}: the {dev} engine serves a copy")
            out[dev] = (trajs, eng.stats.swaps)
        (want, w_swaps), (got, g_swaps) = out["cpu"], out["cuda"]
        check(sorted(want) == sorted(got) == [0, 1, 2, 3],
              f"swap parity/{mode}: not every request retired")
        check(w_swaps == g_swaps == 1,
              f"swap parity/{mode}: swaps {w_swaps} / {g_swaps}")
        worst = 0.0
        for rid, w in want.items():
            g = got[rid]
            check(g.tokens.tolist() == w.tokens.tolist()
                  and g.versions.tolist() == w.versions.tolist(),
                  f"swap parity/{mode}: request {rid} differs: "
                  f"{g.tokens} v{g.versions} / {w.tokens} v{w.versions}")
            worst = max(worst, float(abs(g.log_beta - w.log_beta).max()))
        check(worst <= 1e-4,
              f"swap parity/{mode}: log_beta differs by {worst}")
        crossing = sum(len(set(t.versions.tolist())) > 1
                       for t in want.values())
        check(crossing > 0, f"swap parity/{mode}: no request spans the swap")
        rec[mode] = dict(
            tokens=sum(t.num_tokens for t in want.values()),
            requests_spanning_swap=crossing,
            distinct_tokens=len({int(x) for t in want.values()
                                 for x in t.tokens}),
            log_beta_max_abs_err=worst)
    emit(**rec)


# ---------------------------------------------------------------------------
# Phases 21-23: the threaded runtime and the figure harnesses
# ---------------------------------------------------------------------------

THREADED_RL_PHASES = 3
LOG_BETA_TOL = 1e-5          # phase 21, of max(1, |rescored|)
RESCORE_TOL = 1e-4           # phase 22


def _producer_threads():
    import threading

    return [t.name for t in threading.enumerate() if t.is_alive() and
            t.name in ("runtime-producer", "engine-producer",
                       "serve-producer")]


class _Recorder:
    """Patches the store, the regime class and the serve engine for one
    run: a copy of every version the store starts with or publishes (the
    learner's side, taken on the learner's stream when it publishes),
    every item the learner consumes and the regime it came from; the ids
    of the requests the engine is given, in order, and the versions each
    request's prompt rows were prefilled under."""

    def __init__(self, torch, regime_cls):
        from repro_torch.runtime import PolicyStore
        from repro_torch.serve import ServeEngine
        from repro_torch.utils.tree import tree_map

        self.versions, self.items, self.regimes = {}, [], []
        self.submitted, self.prefill_versions = [], {}
        self._undo = []
        clone = lambda tree: tree_map(torch.clone, tree)
        init, publish = PolicyStore.__init__, PolicyStore.publish
        next_item = regime_cls.next_item
        submit, chunked_round = ServeEngine.submit, ServeEngine._chunked_round

        def recording_init(store, params, *a, **k):
            init(store, params, *a, **k)
            self.versions[0] = clone(params)

        def recording_publish(store, params, **meta):
            version = publish(store, params, **meta)
            self.versions[version] = clone(params)
            return version

        def recording_next_item(regime, *a, **k):
            item = next_item(regime, *a, **k)
            if regime not in self.regimes:
                self.regimes.append(regime)
            if item is not None:
                self.items.append(item)
            return item

        def recording_submit(engine, *a, **k):
            req = submit(engine, *a, **k)
            self.submitted.append(req.request_id)
            return req

        def recording_chunked_round(engine, finished):
            pending = [(r, r.num_prefilled) for r in engine.scheduler.running
                       if not r.prefill_done]
            out = chunked_round(engine, finished)
            for r, before in pending:
                if r.num_prefilled > before:
                    self.prefill_versions.setdefault(
                        r.request_id, set()).add(engine.version)
            return out

        for cls, name, fn in ((PolicyStore, "__init__", recording_init),
                              (PolicyStore, "publish", recording_publish),
                              (regime_cls, "next_item", recording_next_item),
                              (ServeEngine, "submit", recording_submit),
                              (ServeEngine, "_chunked_round",
                               recording_chunked_round)):
            self._undo.append((cls, name, cls.__dict__.get(name)))
            setattr(cls, name, fn)

    def close(self):
        for cls, name, fn in self._undo:
            if fn is None:
                delattr(cls, name)       # it was inherited
            else:
                setattr(cls, name, fn)


def _span_end_s(tracer, name):
    """When the last sync span called ``name`` ended, in seconds from the
    tracer's start."""
    return max(e.ts for e in tracer.events()
               if e.name == name and e.ph == "E") / 1e9


def _rl_run(torch, capacity, runtime):
    """``train rl`` at 100 actors x 100 steps for THREADED_RL_PHASES phases,
    recorded (``_Recorder``); returns (result, recorder, seconds,
    launches, produce spans, learner spans, seconds to the end of the
    last phase's eval: the run's wall without the threaded producer's
    shutdown, which waits for the rollout in progress)."""
    from repro_torch import kernels
    from repro_torch.launch import train as launcher
    from repro_torch.obs.tracer import Tracer
    from repro_torch.runtime import LagRegime

    args = launcher.build_parser().parse_args([
        "rl", "--device", "cuda", "--n-actors", str(CUT_RL_ACTORS),
        "--rollout-steps", str(CUT_RL_STEPS), "--buffer-capacity",
        str(capacity), "--phases", str(THREADED_RL_PHASES),
        "--runtime", runtime])
    rec = _Recorder(torch, LagRegime)
    try:
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        tracer = Tracer(detail="spans")    # its clock starts with the run
        t0 = time.perf_counter()
        res = launcher.run_rl(args, tracer)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        rec.close()
    return (res, rec, seconds, launches, _span_seconds(tracer, "produce"),
            _span_seconds(tracer, "learner_step"),
            _span_end_s(tracer, "eval"))


def _rescore_rollout(torch, params, batch):
    """``log_beta`` of a rollout's actions under ``params``, step by step
    as the actors ran (the params stacked per actor)."""
    from repro_torch.models.mlp_policy import policy_dist
    from repro_torch.utils.tree import tree_map

    n, steps = batch.log_beta.shape
    stacked = tree_map(lambda x: x[None].expand(n, *x.shape), params)
    out = torch.empty_like(batch.log_beta)
    with torch.no_grad():
        for t in range(steps):
            out[:, t] = policy_dist(stacked, batch.obs[:, t]).log_prob(
                batch.actions[:, t])
    return out


def threaded_rl_phase(torch):
    """``train rl --runtime threaded`` at 100 actors x 100 steps (VACO)
    with K 4 and K 1, beside ``backward_mixture`` at K
    4 for the same phases: every consumed item's ``log_beta`` against
    its actions re-scored under a copy of the version it is stamped with
    (the check against torn weights; re-scored under another version it
    must miss, or the check could not tell versions apart), ``vtrace``
    once a phase, the producer thread joined and no producer error."""
    recs = []
    for runtime, capacity in (("backward_mixture", 4), ("threaded", 4),
                              ("threaded", 1)):
        res, rec, seconds, launches, produce, learn, loop_s = _rl_run(
            torch, capacity, runtime)
        tag = f"threaded rl/{runtime}/K{capacity}"
        check(len(res.returns) == THREADED_RL_PHASES and all(
            math.isfinite(r) for r in res.returns) and all(
            math.isfinite(v) for m in res.metrics for v in m.values()),
            f"{tag}: returns {res.returns} or metrics not finite")
        check(launches["vtrace"] == THREADED_RL_PHASES,
              f"{tag}: vtrace launched {launches['vtrace']} times in "
              f"{THREADED_RL_PHASES} phases")
        worst, checked, wrong = 0.0, 0, math.inf
        if runtime == "threaded":
            regime = rec.regimes[0]
            check(regime.error is None and not regime.running
                  and not _producer_threads(),
                  f"{tag}: producer error {regime.error!r} or a live "
                  f"thread {_producer_threads()}")
            check(len(rec.items) == THREADED_RL_PHASES,
                  f"{tag}: {len(rec.items)} items consumed")
            for item in rec.items:
                batch, v = item.payload, item.behavior_version
                for other in (v, v + 1 if v == 0 else v - 1):
                    want = _rescore_rollout(torch, rec.versions[other],
                                            batch)
                    err = ((batch.log_beta - want).abs()
                           / want.abs().clamp(min=1.0)).max().item()
                    if other == v:
                        worst, checked = max(worst, err), checked + 1
                    else:
                        wrong = min(wrong, err)
            check(worst <= LOG_BETA_TOL,
                  f"{tag}: log_beta {worst} from its stamped version's "
                  "re-scoring (torn weights?)")
            check(wrong > LOG_BETA_TOL,
                  f"{tag}: a neighbouring version re-scores within "
                  f"{wrong}: the check cannot tell versions apart")
        queue = res.runtime_stats["queue"]
        env_steps = CUT_RL_ACTORS * CUT_RL_STEPS
        recs.append(dict(
            runtime=runtime, buffer_capacity=capacity,
            phases=THREADED_RL_PHASES, seconds=seconds, loop_s=loop_s,
            consumed_env_steps_per_s=THREADED_RL_PHASES * env_steps
            / loop_s,
            produced_env_steps_per_s=len(produce) * env_steps / sum(produce),
            items_produced=len(produce), produce_s=produce,
            learner_phase_ms=[x * 1e3 for x in learn],
            lag_histogram=queue["lag_histogram"], puts=queue["puts"],
            admitted=queue["admitted"], returns=res.returns,
            items_checked=checked, log_beta_max_rel_err=worst,
            other_version_min_rel_err=None if wrong == math.inf else wrong,
            launches=launches))
    base = recs[0]["consumed_env_steps_per_s"]
    emit(phase="threaded_rl", actors=CUT_RL_ACTORS, steps=CUT_RL_STEPS,
         tol=LOG_BETA_TOL, runs=recs,
         threaded_speedup_k4=recs[1]["consumed_env_steps_per_s"] / base,
         threaded_speedup_k1=recs[2]["consumed_env_steps_per_s"] / base)
    return recs[1]["launches"]


THREADED_RLVR_ARGS = [
    "rlvr", "--full-width", "--device", "cuda", "--warmup-steps", "2",
    "--n-minibatches", "3", "--phases", "1", "--producer", "serve",
    "--runtime", "threaded", "--controller",
    "tv_gate:delta=0.05,mode=downweight"]


def threaded_serve_rlvr_phase(torch):
    """``train rlvr --full-width --producer serve --runtime threaded`` with
    the TV gate (in-flight swaps every round): the producer thread's
    per-token ``log_beta`` against its version re-scored on a copy of
    that version, at least one trajectory spanning two versions; then
    one more minibatch, timed and profiled.

    A swap changes the weights, not the KV cache: a token after the
    swap in a request that spans it attends over keys and values the
    old version wrote, which no single version's forward reproduces.  So
    the tokens re-scored are those whose whole history ran under their
    own version: every prompt row prefilled, and every token before it
    produced, under that version (``_Recorder``).  Those include the
    first tokens after each swap of the requests admitted at it."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.launch import train as launcher
    from repro_torch.obs.tracer import Tracer
    from repro_torch.rollout.sampler import score_tokens
    from repro_torch.runtime import ServeRolloutProducer

    args = launcher.build_parser().parse_args(THREADED_RLVR_ARGS)
    tracer = Tracer(detail="spans")
    torch.cuda.reset_peak_memory_stats()
    rec = _Recorder(torch, ServeRolloutProducer)
    # Rewards drawn from a seed (the random init earns none): nonzero
    # advantages, so each learner step publishes different weights.
    produce_mb, draws = (ServeRolloutProducer._produce_minibatch,
                         torch.Generator().manual_seed(5))

    def seeded_rewards(self):
        mb = produce_mb(self)
        rewards = torch.rand(mb.rewards.shape, generator=draws) < 0.5
        return mb._replace(rewards=rewards.float().to(mb.rewards.device))

    ServeRolloutProducer._produce_minibatch = seeded_rewards
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        trainer, res, warm_loss = launcher.run(args, tracer)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        ServeRolloutProducer._produce_minibatch = produce_mb
        rec.close()
    cfg, hp, engine = trainer.bundle.cfg, trainer.hp, trainer.engine
    check((cfg.n_layers, cfg.d_model, cfg.vocab_size) == (24, 896, 151936),
          f"threaded serve rlvr phase is not full width: {cfg}")
    steps = len(res.phase_logs)
    check(steps == hp.n_minibatches and trainer.nonfinite_skipped == 0,
          f"{steps} learner steps logged of {hp.n_minibatches}")
    regime = trainer.regime
    check(regime.error is None and not regime.running
          and not _producer_threads(),
          f"threaded serve rlvr: producer error {regime.error!r} or a live "
          f"thread {_producer_threads()}")
    for name in SERVE_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} never launched on the threaded serve path")
    check(launches["fused_logprob_bwd"] == steps
          and launches["fused_logprob"] == 2 * steps,
          f"log-prob kernels launched {launches['fused_logprob']} / "
          f"{launches['fused_logprob_bwd']} times in {steps} learner steps")
    forwards = steps + 1 + len(res.eval_accuracy)
    grad_steps = hp.warmup_steps + steps
    check(launches["flash_attention"]
          == cfg.n_layers * (forwards + grad_steps)
          and launches["flash_attention_bwd"] == cfg.n_layers * grad_steps,
          f"flash_attention / _bwd launched {launches['flash_attention']} "
          f"/ {launches['flash_attention_bwd']} times for {forwards} no-grad "
          f"forwards and {grad_steps} steps of {cfg.n_layers} layers")
    # Every token whose history ran under one version, re-scored on it.
    prompt_len = trainer.dataset.prompt_len
    rows = hp.prompts_per_minibatch * hp.completions_per_prompt
    worst, spanning, by_version, checked = 0.0, 0, {}, {}
    wrong = math.inf
    check(len(rec.items) == steps, f"{len(rec.items)} items consumed")
    for j, item in enumerate(rec.items):
        # Minibatches are produced and consumed in order (the gate only
        # downweights), row i from the i-th request submitted for it.
        rids = rec.submitted[j * rows:(j + 1) * rows]
        mb = item.payload
        versions = np.asarray(mb.versions)
        valid = mb.gen.mask.cpu().numpy() > 0
        check(int(versions.min()) == item.behavior_version,
              "an item's tag is not its oldest token version")
        sel = np.zeros_like(valid)
        for i, rid in enumerate(rids):
            seen = versions[i][valid[i]]
            prefill = rec.prefill_versions[rid]
            spanning += len(prefill | set(seen.tolist())) > 1
            if seen.size and prefill == {int(seen[0])}:
                run = np.cumprod(versions[i] == seen[0]).astype(bool)
                sel[i] = valid[i] & run
        log_beta = mb.gen.log_beta.cpu().numpy()
        for v in sorted(set(versions[valid].tolist())):
            by_version[v] = by_version.get(v, 0) + int(
                (valid & (versions == v)).sum())
            mine = sel & (versions == v)
            if not mine.any():
                continue
            # Its own version, then the one before it, which must miss.
            for other in (v, v - 1):
                with torch.no_grad():
                    log_pi, _, _ = score_tokens(
                        trainer.bundle, rec.versions[other], mb.gen.tokens,
                        prompt_len)
                err = float(np.abs(log_pi.cpu().numpy()[mine]
                                   - log_beta[mine]).max())
                if other == v:
                    worst = max(worst, err)
                else:
                    wrong = min(wrong, err)
            checked[v] = checked.get(v, 0) + int(mine.sum())
    check(sum(checked.values()) > 0 and len(checked) > 1,
          f"threaded serve rlvr: tokens re-scored by version {checked}")
    check(worst <= RESCORE_TOL,
          f"threaded serve rlvr: log_beta {worst} from its version's "
          "re-scoring")
    check(spanning > 0, "threaded serve rlvr: no trajectory spans two "
          f"versions (tokens by version {by_version})")
    check(wrong > RESCORE_TOL,
          f"threaded serve rlvr: the version before re-scores within "
          f"{wrong}: the check cannot tell versions apart")
    produce = _span_seconds(tracer, "produce")
    step = trainer.metrics.histogram("train_step_s").summary()
    gnorm = trainer.metrics.histogram("train_grad_norm").summary()
    check(gnorm["min"] > 0, f"threaded serve rlvr: a zero gradient {gnorm}")
    check(math.isfinite(warm_loss) and math.isfinite(gnorm["max"]) and all(
        math.isfinite(l.tv) and math.isfinite(l.weight)
        for l in res.phase_logs), "non-finite warmup loss, tv or weight")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    produce_one = regime._produce_minibatch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    produce_one()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, rows = profile_kernels(produce_one)
    emit(phase="threaded_serve_rlvr", config=cfg.name, layers=cfg.n_layers,
         seconds=seconds, warmup_loss=warm_loss,
         eval_accuracy=res.eval_accuracy, learner_steps=steps,
         learner_step_p50_ms=step["p50"] * 1e3,
         learner_step_mean_ms=step["mean"] * 1e3,
         minibatches_generated=len(produce), produce_s=produce,
         tokens_out=engine.stats.tokens_out,
         generation_tokens_per_s=engine.stats.tokens_out / sum(produce),
         swaps=engine.stats.swaps,
         item_lag=[l.staleness for l in res.phase_logs],
         item_versions=[[item.behavior_version, item.behavior_version_newest]
                        for item in rec.items],
         lag_histogram=res.runtime_stats["queue"]["lag_histogram"],
         tokens_by_version=by_version, tokens_rescored=checked,
         trajectories_spanning=spanning, preemptions=engine.stats.preemptions,
         log_beta_max_abs_err=worst, tol=RESCORE_TOL,
         version_before_min_abs_err=wrong,
         tv=[l.tv for l in res.phase_logs],
         weight=[l.weight for l in res.phase_logs],
         grad_norm_max=gnorm["max"], peak_memory_gib=peak,
         launches=launches)
    emit(phase="threaded_serve_rlvr_profile", wall_ms=wall_ms,
         device_busy_ms=busy_ms, idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
         kernel_launches=sum(n for _, _, n in rows), top_kernels=rows[:8])
    return launches


def _finite_report(tree) -> bool:
    if isinstance(tree, dict):
        return all(_finite_report(v) for v in tree.values())
    if isinstance(tree, list):
        return all(_finite_report(v) for v in tree)
    if isinstance(tree, float):
        return math.isfinite(tree)
    return tree is None or isinstance(tree, (int, str))


HARNESSES = (
    # (module, argv, top-level keys of its report, kernel that must run)
    # Cut for time: each learner phase is ~3 s of host-bound launches
    # whatever the rollout size, so the grids are cut, not the rollouts.
    # fig3 runs VACO alone (PPO runs in fig4 and fig11), fig11 and the
    # realignment ablation their most lagged capacity (8 of 1, 8; 16 of
    # 4, 16), the delta and rho sweeps their two ends (0.05 and 0.4 of
    # 0.05-0.4; 1 and 8 of 1, 2, 8).
    ("fig3_backward_lag",
     ["--envs", "pendulum", "--algorithms", "vaco", "--capacities", "1",
      "4", "--seeds", "0", "--phases", "2", "--n-actors",
      str(CUT_RL_ACTORS), "--rollout-steps", str(CUT_RL_STEPS)],
     {"K=1", "K=4", "_raw", "_seconds"}, "vtrace"),
    ("fig4_sample_efficiency",
     ["--envs", "pendulum", "--seeds", "0", "--phases", "2",
      "--rollout-steps", "48"],
     {"vaco", "ppo", "spo", "impala"}, "vtrace"),
    ("fig11_tv_tracking", ["--envs", "pendulum", "--seeds", "0",
                           "--phases", "2", "--capacities", "8"],
     {"vaco", "ppo", "ppo_kl"}, "vtrace"),
    ("ablation_delta", ["--envs", "pendulum", "--seeds", "0", "--phases",
                        "2", "--deltas", "0.05", "0.4"],
     {f"delta={d}" for d in (0.05, 0.4)}, "vtrace"),
    ("ablation_rho", ["--envs", "pendulum", "--seeds", "0", "--phases",
                      "2", "--rhos", "1.0", "8.0"],
     {f"rho={r}" for r in (1.0, 8.0)}, "vtrace"),
    ("ablation_realignment", ["--envs", "pendulum", "--seeds", "0",
                              "--phases", "2", "--capacities", "16"],
     {"K=16"}, "vtrace"),
    ("fig5_rlvr_forward_lag",
     ["--full-width", "--minibatches", "1", "2", "--phases", "1",
      "--warmup-steps", "4"],
     {"grpo", "grpo_vaco"}, "fused_logprob_bwd"),
)


def harness_phase(torch):
    """The figure runners (``repro_torch.experiments``) on reduced grids
    (``HARNESSES``): fig3 at 100 actors x 100 steps, the rest at their
    own, fig5 at full width; each report finite, with its keys, its kernel launched."""
    import importlib

    from repro_torch import kernels

    out_dir = ROOT / "build" / "harnesses"
    out_dir.mkdir(parents=True, exist_ok=True)
    total = {}
    for name, argv, keys, kernel in HARNESSES:
        mod = importlib.import_module(f"repro_torch.experiments.{name}")
        out = out_dir / f"{name}.json"
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        check(mod.main(argv + ["--device", "cuda", "--out", str(out)]) == 0,
              f"{name}: main failed")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        report = json.loads(out.read_text())
        check(set(report) == keys, f"{name}: report keys {sorted(report)}")
        check(_finite_report(report), f"{name}: non-finite report")
        check(launches[kernel] > 0, f"{name}: {kernel} never launched")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        emit(phase="harness", runner=name, argv=argv, seconds=seconds,
             report=report, launches=launches)
    return total


# ---------------------------------------------------------------------------
# Phases 24-26: the learner controllers, the chaos plan, checkpoints
# ---------------------------------------------------------------------------

CONTROLLER_ARGS = [
    "rlvr", "--full-width", "--device", "cuda", "--warmup-steps", "2",
    "--n-minibatches", "2", "--phases", "1", "--producer", "serve",
    "--forced-lag", "2"]
CONTROLLER_SPECS = ("gac", "stable_async:var_max=0.5", "asympo")
GAC_COS_TOL = 1e-5           # against a float64 cosine of the same grads
SCORE_TOL = 1e-5             # fused_logprob vs the plain version
TIMED_STEPS = 5


def _seeded_serve_rewards(torch, seed):
    """``ServeRolloutProducer._produce_minibatch`` with rewards drawn from
    a seed (a random init earns none: the advantages, and so every
    gradient, would be zero); returns the undo."""
    from repro_torch.runtime import ServeRolloutProducer

    produce, draws = (ServeRolloutProducer._produce_minibatch,
                      torch.Generator().manual_seed(seed))

    def seeded(self):
        mb = produce(self)
        rewards = torch.rand(mb.rewards.shape, generator=draws) < 0.5
        return mb._replace(rewards=rewards.float().to(mb.rewards.device))

    ServeRolloutProducer._produce_minibatch = seeded
    return lambda: setattr(ServeRolloutProducer, "_produce_minibatch",
                           produce)


def _cos64_host(torch, a, b):
    """The cosine of two trees of one structure in float64 on the host,
    one leaf at a time."""
    from repro_torch.utils.tree import tree_leaves

    dot = na = nb = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        x, y = x.detach().cpu().double(), y.detach().cpu().double()
        dot += float(torch.dot(x.reshape(-1), y.reshape(-1)))
        na += float(torch.dot(x.reshape(-1), x.reshape(-1)))
        nb += float(torch.dot(y.reshape(-1), y.reshape(-1)))
    return dot / math.sqrt(na * nb) if na * nb > 0 else 0.0


class _ControllerRecorder:
    """Patches the three learner controllers' hooks for one run: GAC's
    reported cosine and scale with the gradients and anchor it compared
    (kept by reference: neither is written after, so the timed step
    copies nothing; ``gac_rows`` adds the float64 cosine after the run),
    and each ``loss_weights`` call's arrays, output and ``item.meta``."""

    def __init__(self, torch):
        import numpy as np
        from repro_torch.runtime import controllers as ctl

        self.torch = torch
        self.cos, self.weights = [], []
        self._undo = []
        gac = ctl.GradientAlignmentController.transform_gradients

        def recording_transform(ctrl, item, grads):
            stale = ctrl._anchor is not None and item.lag > ctrl.fresh_lag
            anchor = ctrl._anchor
            out, info = gac(ctrl, item, grads)
            if stale:
                self.cos.append((info["gac_cos"], (grads, anchor),
                                 info["gac_scale"]))
            return out, info

        self._patch(ctl.GradientAlignmentController, "transform_gradients",
                    recording_transform)
        for cls in (ctl.StableAsyncController, ctl.AsymPOController):
            hook = cls.loss_weights

            def recording_weights(ctrl, item, hook=hook, **kw):
                w = hook(ctrl, item, **kw)
                self.weights.append((ctrl, item.lag, {
                    k: None if v is None else np.array(v)
                    for k, v in kw.items()}, w, dict(item.meta)))
                return w

            self._patch(cls, "loss_weights", recording_weights)

    def _patch(self, cls, name, fn):
        self._undo.append((cls, name, cls.__dict__[name]))
        setattr(cls, name, fn)

    def gac_rows(self):
        """``(cos, float64 cos, scale)`` of each stale GAC step, the
        float64 one from the same trees copied to the host."""
        rows = [(c, _cos64_host(self.torch, *trees), scale)
                for c, trees, scale in self.cos]
        self.cos = []
        return rows

    def close(self):
        for cls, name, fn in self._undo:
            setattr(cls, name, fn)


def _timed_ms(torch, fn, n):
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return sorted(out)[len(out) // 2]


def _step_timings(torch, trainer, mb):
    """One state, one minibatch: the learner step as the trainer runs it
    (the split step's halves back to back) timed, and under ``gac`` the
    same step with the controller's transform of a stale item between
    the halves (a copy of the controller: its anchor is replaced, never
    written, so the run's is left as it was)."""
    import copy
    import types

    from repro_torch.core.losses import group_advantages

    state = trainer.state
    adv = group_advantages(mb.rewards, trainer.hp.completions_per_prompt)
    args = (mb.gen.tokens, mb.gen.log_beta, mb.gen.mask, adv)
    grad_step, apply_step = trainer._grad_step, trainer._apply_step
    step_ms = _timed_ms(torch, lambda: apply_step(
        state, grad_step(state, *args)[0]), TIMED_STEPS)
    gac_ms = None
    if trainer.controller.needs_gradients:
        stale = types.SimpleNamespace(lag=2, meta={})

        def gac_step():
            ctrl = copy.copy(trainer.controller)
            grads, _ = grad_step(state, *args)
            grads, info = ctrl.transform_gradients(stale, grads)
            return apply_step(state, grads)

        gac_ms = _timed_ms(torch, gac_step, TIMED_STEPS)
    return step_ms, gac_ms


def _score_check(torch, trainer, mb):
    """``_score_log_pi`` (the no-grad forward through flash and the
    ``fused_logprob`` kernel) against the plain log-prob on the same
    logits, and against the plain forward (grad enabled: the plain
    attention) and plain log-prob."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.logprobs import fused_logprob_cuda
    from repro_torch.utils.tree import tree_trainable

    p_len = trainer.dataset.prompt_len
    tokens = mb.gen.tokens
    b, n_new = mb.gen.mask.shape
    got = trainer._score_log_pi(tokens)
    with torch.no_grad():
        logits = trainer.bundle.forward(trainer.state.params,
                                        tokens).logits[:, p_len - 1:-1]
    x = logits.reshape(b * n_new, -1).contiguous()
    t = tokens[:, p_len:].reshape(-1).to(torch.int32).contiguous()
    kernel, _, _ = fused_logprob_cuda(x, t)
    plain = ref.ref_logprobs_from_logits(x, t)
    kernel_err = (kernel - plain).abs().max().item()
    path_err = (got.reshape(-1) - kernel).abs().max().item()
    with torch.enable_grad():       # trainable leaves: the einsum path
        plain_logits = trainer.bundle.forward(
            tree_trainable(trainer.state.params),
            tokens).logits[:, p_len - 1:-1].detach()
    plain_all = ref.ref_logprobs_from_logits(
        plain_logits.reshape(b * n_new, -1).contiguous(), t)
    forward_err = (got.reshape(-1) - plain_all).abs().max().item()
    return kernel_err, path_err, forward_err


def controllers_phase(torch):
    """``train rlvr --full-width --producer serve --forced-lag 2`` under
    ``gac``, ``stable_async:var_max=0.5`` and ``asympo`` (2 warmup steps,
    2 minibatches, seeded rewards): GAC's cosine against float64,
    ``_score_log_pi`` against the plain version, the loss weights
    recomputed on the CPU, launch counts a step, the step timed.  Returns the last run's trainer (phase 26 saves its params)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.launch import train as launcher
    from repro_torch.obs.tracer import NULL_TRACER
    from repro_torch.runtime import controllers as ctl

    trainer = None
    for spec in CONTROLLER_SPECS:
        # A trainer sits in a reference cycle (its registry's producer
        # closes over it): collect it before the next one is built.
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        held_gib = torch.cuda.memory_allocated() / 2 ** 30
        name = spec.split(":")[0]
        args = launcher.build_parser().parse_args(
            CONTROLLER_ARGS + ["--controller", spec])
        undo = _seeded_serve_rewards(torch, 5)
        rec = _ControllerRecorder(torch)
        try:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            trainer, res, warm_loss = launcher.run(args, NULL_TRACER)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = kernels.launch_counts()
        finally:
            rec.close()
        cfg, hp = trainer.bundle.cfg, trainer.hp
        check((cfg.n_layers, cfg.d_model, cfg.vocab_size)
              == (24, 896, 151936), f"controllers phase: not full width")
        steps = len(res.phase_logs)
        check(steps == hp.n_minibatches and trainer.nonfinite_skipped == 0,
              f"{spec}: {steps} learner steps of {hp.n_minibatches}")
        check(trainer.controller.name == name, f"{spec}: built "
              f"{trainer.controller.name}")
        # (GAC may scale a stale step's gradient to zero.)
        gnorm = trainer.metrics.histogram("train_grad_norm").summary()
        check(gnorm["max"] > 0 and math.isfinite(gnorm["max"])
              and math.isfinite(warm_loss), f"{spec}: grad norms {gnorm}")
        # Launches a learner step: the loss's log-prob forward and its
        # backward, flash and its backward once a layer (warmup steps
        # too); stable_async scores log_pi once more (a no-grad forward,
        # flash once a layer); the evals' prefills run flash.
        extra = steps if name == "stable_async" else 0
        forwards = extra + 1 + len(res.eval_accuracy)
        grad_steps = hp.warmup_steps + steps
        check(launches["fused_logprob"] == steps + extra
              and launches["fused_logprob_bwd"] == steps
              and launches["flash_attention"]
              == cfg.n_layers * (forwards + grad_steps)
              and launches["flash_attention_bwd"]
              == cfg.n_layers * grad_steps,
              f"{spec}: launches {launches} for {steps} steps")
        cos_rows, weight_rows = rec.gac_rows(), list(rec.weights)
        if name == "gac":
            # The first item is fresh (no anchor yet), the others stale.
            check(len(cos_rows) == steps - 1, f"gac: {cos_rows}")
            for got_cos, exact, _ in cos_rows:
                check(abs(got_cos - exact) <= GAC_COS_TOL,
                      f"gac cosine {got_cos} against float64 {exact}")
        else:
            check(len(weight_rows) == steps, f"{spec}: {len(weight_rows)} "
                  "loss_weights calls")
            for ctrl, lag, kw, w, meta in weight_rows:
                fresh = (ctl.StableAsyncController(
                    c_max=ctrl.c_max, c_min=ctrl.c_min,
                    var_max=ctrl.var_max) if name == "stable_async" else
                    ctl.AsymPOController(
                        pos_scale=ctrl.pos_scale, neg_scale=ctrl.neg_scale,
                        pos_decay=ctrl.pos_decay))
                item = type("Item", (), {"lag": lag, "meta": {}})()
                again = fresh.loss_weights(item, **kw)
                check(np.array_equal(again, w)
                      and item.meta == {name: meta[name]},
                      f"{spec}: CPU recomputation differs: {item.meta} "
                      f"against {meta}")
                if name == "stable_async":
                    check(kw["log_pi"] is not None
                          and kw["log_pi"].shape == kw["log_beta"].shape,
                          "stable_async got no log_pi")
        # One more minibatch (seeded rewards): step timings, scoring.
        try:
            mb = trainer.regime._produce_minibatch()
        finally:
            undo()
        step_ms, gac_ms = _step_timings(torch, trainer, mb)
        kernel_err, path_err, forward_err = _score_check(torch, trainer, mb)
        check(kernel_err <= SCORE_TOL and path_err == 0.0,
              f"{spec}: _score_log_pi kernel {kernel_err} from the plain "
              f"version, {path_err} from the kernel")
        step = trainer.metrics.histogram("train_step_s").summary()
        emit(phase="controllers", controller=spec, config=cfg.name,
             seconds=seconds, learner_steps=steps,
             allocated_before_gib=held_gib,
             learner_step_p50_ms=step["p50"] * 1e3,
             learner_step_mean_ms=step["mean"] * 1e3,
             step_p50_ms=step_ms, gac_step_p50_ms=gac_ms,
             fused_logprob_per_step=launches["fused_logprob"] / steps,
             flash_per_step=(launches["flash_attention"]
                             - cfg.n_layers * (1 + len(res.eval_accuracy)
                                               + hp.warmup_steps))
             / steps,
             gac=[{"cos": c, "cos_f64": e, "scale": s}
                  for c, e, s in cos_rows],
             meta=[m for *_, m in weight_rows],
             score_kernel_vs_plain=kernel_err,
             score_vs_plain_forward=forward_err,
             item_lag=[l.staleness for l in res.phase_logs],
             mean_reward=[l.mean_reward for l in res.phase_logs],
             grad_norm_max=gnorm["max"], launches=launches)
        del mb
    return trainer


CHAOS_BENCH = ROOT / "results" / "BENCH_chaos.json"
CHAOS_FULL_WIDTH = True
CHAOS_DEVICE = "cuda"
CHAOS_WATCHDOG = 2
CHAOS_JOIN_S = 10.0


def _chaos_parts():
    """The chaos bench's configuration (its committed ``config``, read):
    the plan, the deadline, the phases, the seed; the port's model at
    full width and the bench's run shape."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.mathgen import MathTaskDataset
    from repro_torch.data.tokenizer import get_tokenizer
    from repro_torch.models.registry import build

    config = json.loads(CHAOS_BENCH.read_text())["config"]
    cfg = (get_config("qwen2.5-0.5b") if CHAOS_FULL_WIDTH else
           reduced_config("qwen2.5-0.5b", vocab=get_tokenizer().vocab_size))
    seed = config["seed"]

    def make_ds():
        return MathTaskDataset(prompt_len=16, level=0, pool_size=256,
                               seed=seed + 1)

    return config, build(cfg), make_ds


def _chaos_hp(config, fault_plan, deadline_s):
    from repro_torch.train import RLVRHyperparams

    return RLVRHyperparams(
        algorithm="grpo", lr=1e-3, n_minibatches=3,
        prompts_per_minibatch=4, completions_per_prompt=4,
        max_new_tokens=6, warmup_steps=2, producer="serve",
        runtime="threaded", queue_maxsize=2, controller="pass_through",
        store_capacity=6, engine_max_batch=8, engine_num_blocks=48,
        get_timeout=120.0, fault_plan=fault_plan, fault_seed=config["seed"],
        watchdog_restarts=CHAOS_WATCHDOG, watchdog_backoff_ms=40.0,
        request_deadline_s=deadline_s, finiteness_guard=True)


def _chaos_run(torch, bundle, make_ds, hp, warm, phases, seed):
    """One threaded serve-producer run from the warm start; what the
    gates read."""
    import threading

    import numpy as np
    from repro_torch.train import RLVRTrainer

    threads = {t.ident for t in threading.enumerate()}
    tr = RLVRTrainer(bundle, make_ds(), hp, seed=seed, params=warm,
                     device=CHAOS_DEVICE)
    tr.store.publish(warm, event="chaos_base")
    put_versions, consumed_versions = set(), set()
    put, next_item = tr.queue.put, tr.regime.next_item

    def audited_put(payload, **kw):
        put_versions.update(np.unique(np.asarray(payload.versions)).tolist())
        return put(payload, **kw)

    def audited_next_item(*a, **k):
        item = next_item(*a, **k)
        if item is not None:
            consumed_versions.update(
                np.unique(np.asarray(item.payload.versions)).tolist())
        return item

    tr.queue.put, tr.regime.next_item = audited_put, audited_next_item
    t0 = time.perf_counter()
    res = tr.train(phases, eval_every=10 ** 9)
    final = tr.evaluate(128)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    tr.close()
    deadline = time.monotonic() + CHAOS_JOIN_S
    while True:
        alive = [t.name for t in threading.enumerate()
                 if t.ident not in threads and t.is_alive()]
        if not alive or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    alloc = tr.engine.allocator
    counters = tr.metrics.counter_values()
    total = lambda name: int(sum(v for k, v in counters.items()
                                 if k.split("{")[0] == name))
    quarantined = tr.store.quarantined_versions()
    step = tr.metrics.histogram("train_step_s").summary()
    out = dict(
        updates=len(res.phase_logs), final_eval=final, wall_s=wall_s,
        learner_step_p50_ms=step["p50"] * 1e3,
        restarts=tr.regime.restarts, timeouts=int(tr.engine.stats.timeouts),
        quarantined=quarantined, nonfinite=tr.nonfinite_skipped,
        quarantine_put=sorted(put_versions & set(quarantined)),
        quarantine_consumed=sorted(consumed_versions & set(quarantined)),
        leaked_pages=alloc.num_blocks - alloc.num_free,
        leaked_refs=int(sum(alloc._refs)), leaked_threads=alive,
        producer_error=repr(tr.regime.error) if tr.regime.error else None,
        faults=tr.injector.fired_counts(),
        watchdog_restart_total=total("watchdog_restart_total"),
        restart_admitted_total=total("restart_admitted_total"),
        request_timeout_total=total("request_timeout_total"),
        publish_quarantined_total=total("publish_quarantined_total"),
        learner_nonfinite_total=total("learner_nonfinite_total"),
        lag_histogram=res.runtime_stats["queue"]["lag_histogram"],
        mean_reward=float(np.mean([l.mean_reward for l in res.phase_logs]))
        if res.phase_logs else 0.0)
    del tr
    return out


def chaos_phase(torch):
    """The threaded serve producer at full width under the chaos bench's
    canned plan (a producer crash the watchdog restarts, a 7.5 s engine
    stall past the 3 s request deadline, a NaN publish, a queue stall, a
    poisoned learner step), beside a fault-free run of the same seed from
    the same warm start: completion, leaks, quarantine and fault gates;
    the final evals reported, not gated."""
    from repro_torch.train import RLVRTrainer

    config, bundle, make_ds = _chaos_parts()
    seed, phases = config["seed"], config["phases"]
    warm_hp = _chaos_hp(config, "", None)
    warm_tr = RLVRTrainer(bundle, make_ds(), warm_hp, seed=seed,
                          device=CHAOS_DEVICE)
    warm_loss = warm_tr.warmup()
    warm = warm_tr.state.params
    del warm_tr
    gc.collect()
    torch.cuda.empty_cache()
    base = _chaos_run(torch, bundle, make_ds, warm_hp, warm, phases, seed)
    gc.collect()
    torch.cuda.empty_cache()
    chaos = _chaos_run(
        torch, bundle, make_ds,
        _chaos_hp(config, config["fault_plan"],
                  config["request_deadline_s"]), warm, phases, seed)
    del warm
    gc.collect()
    torch.cuda.empty_cache()
    full = phases * warm_hp.n_minibatches
    emit(phase="chaos", config=bundle.cfg.name, layers=bundle.cfg.n_layers,
         fault_plan=config["fault_plan"],
         request_deadline_s=config["request_deadline_s"],
         watchdog_restarts=CHAOS_WATCHDOG, warmup_loss=warm_loss,
         baseline=base, chaos=chaos,
         final_eval_delta=chaos["final_eval"] - base["final_eval"])
    for name, run in (("baseline", base), ("chaos", chaos)):
        check(run["producer_error"] is None,
              f"chaos {name}: producer error {run['producer_error']}")
        check(run["leaked_pages"] == 0 and run["leaked_refs"] == 0
              and not run["leaked_threads"],
              f"chaos {name}: leaked pages {run['leaked_pages']}, refs "
              f"{run['leaked_refs']}, threads {run['leaked_threads']}")
    # Every item is consumed once: only the skipped non-finite step
    # makes no update (the crashed round restarts before its item).
    check(base["updates"] == full
          and chaos["updates"] == full - chaos["nonfinite"],
          f"chaos: updates {base['updates']} / {chaos['updates']} of {full}")
    check(not base["quarantined"] and base["restarts"] == 0,
          f"chaos: the fault-free run quarantined or restarted: {base}")
    check(not chaos["quarantine_put"] and not chaos["quarantine_consumed"],
          f"chaos: a quarantined version was served: {chaos}")
    check(chaos["restarts"] == 1 and chaos["watchdog_restart_total"] == 1
          and chaos["restart_admitted_total"] == 1,
          f"chaos: restarts {chaos['restarts']}")
    check(chaos["timeouts"] >= 1, "chaos: the stall timed out no request")
    check(len(chaos["quarantined"]) == 1
          and chaos["publish_quarantined_total"] == 1,
          f"chaos: quarantined {chaos['quarantined']}")
    check(chaos["nonfinite"] == 1 and chaos["learner_nonfinite_total"] == 1,
          f"chaos: non-finite steps {chaos['nonfinite']}")


CHECKPOINT_DIR = ROOT / "build" / "checkpoints"
SERVE_CKPT_ARGS = ["--engine", "static", "--full-width", "--device", "cuda",
                   "--temperature", "0", "--batch", "8",
                   "--max-new-tokens", "8"]
GUARD_ARGS = [
    "rlvr", "--device", "cuda", "--warmup-steps", "2", "--n-minibatches",
    "3", "--phases", "1", "--fault-plan", "learner_nan:at_step=2"]


def checkpoint_phase(torch, trainer):
    """Phase 24's last trainer's params saved by ``train rlvr
    --checkpoint-dir`` and served by ``launch.serve --checkpoint
    --full-width``: the loaded leaves bit-equal, greedy tokens identical
    to serving the in-memory params; then a reduced-width ``learner_nan``
    run whose guard restores from ``--guard-checkpoint-dir``."""
    import shutil

    from repro_torch.checkpoint import latest_checkpoint
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as launcher
    from repro_torch.obs.tracer import NULL_TRACER
    from repro_torch.rollout.sampler import generate
    from repro_torch.utils.tree import tree_leaves

    shutil.rmtree(CHECKPOINT_DIR, ignore_errors=True)
    args = launcher.build_parser().parse_args(
        CONTROLLER_ARGS + ["--checkpoint-dir", str(CHECKPOINT_DIR / "rlvr")])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = launcher.save_params(args, trainer)
    save_s = time.perf_counter() - t0
    size = Path(path).stat().st_size
    sargs = serve_launcher.build_parser().parse_args(
        SERVE_CKPT_ARGS + ["--checkpoint", path])
    t0 = time.perf_counter()
    static = serve_launcher.prepare_static(sargs)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    equal = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(static.params), tree_leaves(trainer.state.params)))
    check(equal, "checkpoint phase: loaded leaves differ from the saved")
    loaded, dt = serve_launcher.run_static(static)
    serve_launcher.report_static(static, loaded, dt)
    # The launcher's own draws: a generator seeded from --seed, as
    # prepare_static seeds each call's.
    draws = torch.Generator(device=static.device).manual_seed(sargs.seed + 2)
    memory = generate(static.bundle, trainer.state.params, static.prompts,
                      draws, max_new_tokens=sargs.max_new_tokens,
                      temperature=sargs.temperature, top_p=sargs.top_p)
    check(torch.equal(loaded.completion, memory.completion),
          "checkpoint phase: greedy tokens from the loaded checkpoint "
          "differ from the in-memory params'")
    del static, loaded, memory
    # The guard's checkpoint restore, at reduced width on the card.
    guard_dir = CHECKPOINT_DIR / "guard"
    gargs = launcher.build_parser().parse_args(
        GUARD_ARGS + ["--guard-checkpoint-dir", str(guard_dir)])
    t0 = time.perf_counter()
    gtr, gres, _ = launcher.run(gargs, NULL_TRACER)
    torch.cuda.synchronize()
    guard_s = time.perf_counter() - t0
    counters = gtr.metrics.counter_values("learner_nonfinite_total")
    check(counters == {"learner_nonfinite_total{restored=checkpoint}": 1.0}
          and gtr.nonfinite_skipped == 1 and len(gres.phase_logs) == 2,
          f"checkpoint phase: guard restore {counters}")
    check(all(bool(torch.isfinite(x).all())
              for x in tree_leaves(gtr.state.params)),
          "checkpoint phase: the restored params are not finite")
    newest = latest_checkpoint(str(guard_dir))
    emit(phase="checkpoint", path=str(Path(path).relative_to(ROOT)),
         bytes=size, save_s=save_s, serve_prepare_s=load_s,
         save_gb_per_s=size / save_s / 1e9, greedy_tokens_identical=True,
         tokens=int(sargs.batch * sargs.max_new_tokens),
         guard_counters=counters, guard_newest=Path(newest).name,
         guard_seconds=guard_s, guard_config=gtr.bundle.cfg.name)
    shutil.rmtree(CHECKPOINT_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phases 27-29: speculative decode and the prefix cache
# ---------------------------------------------------------------------------

SPEC_ARGS = ["--engine", "continuous", "--full-width", "--device", "cuda",
             "--runtime", "versioned", "--speculate", "4", "--draft",
             "version:-1", "--temperature", "0", "--requests", "8"]
SPEC_BUDGETS = (8, 16, 24, 32, 8, 16, 24, 32)   # the lagged-draft runs
NEAR_TIE = 1e-3              # phase 27: a divergence's top-2 logit gap
SPEC_DEVICE = "cuda"         # phases 27-29 (a CPU rehearsal sets "cpu")


def _prompts(n, seed=1):
    from repro_torch.data.mathgen import MathTaskDataset
    from repro_torch.data.tokenizer import get_tokenizer

    tok = get_tokenizer()
    toks, _, _ = MathTaskDataset(prompt_len=32, level=0,
                                 seed=seed).sample_batch(n)
    return [row[row != tok.pad_id] for row in toks]


def _serve_timed(torch, eng, prompts, budgets):
    """Submit, run to the end between device synchronisations; returns
    ``({request_id: trajectory}, seconds)``."""
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        eng.submit(p, n, request_id=i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trajs = eng.run(max_steps=10_000)
    torch.cuda.synchronize()
    return {t.request_id: t for t in trajs}, time.perf_counter() - t0


def _injected_noise(torch, eng, seed=5):
    """Draw the engine's sampling and accept noise from one CPU stream,
    so the card and the CPU take the same draws."""
    from repro_torch.rollout.sampler import accept_noise, gumbel_noise, sample

    g = torch.Generator().manual_seed(seed)
    eng._sample = lambda logits: sample(
        logits, eng._temperature, eng._top_p,
        gumbel_noise(logits.shape, g, "cpu").to(logits.device))
    eng._accept_noise = lambda b, k, v: tuple(
        t.to(eng.device) for t in accept_noise(b, k, v, g, "cpu"))


def _spec_parity(torch):
    """2 layers at full width, dense weights x3, a draft of dense x3.3:
    greedy speculative against plain greedy serving on the CPU and on the
    card, then sampled speculative serving card against CPU on the same
    injected draws."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build
    from repro_torch.serve import ServeEngine

    cfg = get_config("qwen2.5-0.5b").replace(n_layers=2)
    bundle = build(cfg)
    params = _scale_dense(bundle.init(torch.Generator().manual_seed(0)))
    draft = _scale_dense(params, 1.1)
    prompts, budgets = _prompts(4), (4, 8, 16, 8)
    kw = dict(num_blocks=128, block_size=8, max_batch=4, decode_chunk=4,
              prefill_chunk=16, dispatch_budget=32, seed=2)
    out = {}
    for mode, temperature in (("greedy", 0.0), ("sampled", 1.0)):
        for dev in ("cpu", "cuda"):
            for spec in ((4,) if mode == "sampled" else (0, 4)):
                eng = ServeEngine(bundle, params, temperature=temperature,
                                  speculate_k=spec, device=dev,
                                  draft=("params", draft) if spec else None,
                                  **kw)
                if mode == "sampled":
                    _injected_noise(torch, eng)
                for i, (p, n) in enumerate(zip(prompts, budgets)):
                    eng.submit(p, n, request_id=i)
                trajs = {t.request_id: t for t in eng.run(max_steps=1000)}
                check(sorted(trajs) == [0, 1, 2, 3],
                      f"spec parity/{mode}/{dev}: not every request retired")
                out[(mode, dev, spec)] = (trajs, eng.stats)
    rec = {}
    for dev in ("cpu", "cuda"):
        spec, plain = out[("greedy", dev, 4)][0], out[("greedy", dev, 0)][0]
        for rid in plain:
            check(spec[rid].tokens.tolist() == plain[rid].tokens.tolist(),
                  f"spec parity/greedy/{dev}: request {rid} speculative "
                  f"{spec[rid].tokens} plain {plain[rid].tokens}")
    for mode in ("greedy", "sampled"):
        (want, ws), (got, gs) = out[(mode, "cpu", 4)], out[(mode, "cuda", 4)]
        worst = 0.0
        for rid, w in want.items():
            check(got[rid].tokens.tolist() == w.tokens.tolist(),
                  f"spec parity/{mode}: request {rid} cuda "
                  f"{got[rid].tokens} cpu {w.tokens}")
            worst = max(worst, float(abs(got[rid].log_beta
                                         - w.log_beta).max()))
        counts = [(s.spec_rounds, s.drafted_tokens, s.accepted_tokens)
                  for s in (gs, ws)]
        check(counts[0] == counts[1],
              f"spec parity/{mode}: cuda / cpu rounds, drafted, accepted "
              f"{counts}")
        check(worst <= 1e-4, f"spec parity/{mode}: log_beta differs by "
              f"{worst}")
        check(0 < ws.accepted_tokens < ws.drafted_tokens,
              f"spec parity/{mode}: acceptance {counts[1]} exercises "
              "only one outcome")
        rec[mode] = dict(tokens=sum(t.num_tokens for t in want.values()),
                         distinct_tokens=len({int(x) for t in want.values()
                                              for x in t.tokens}),
                         rounds_drafted_accepted=counts[1],
                         log_beta_max_abs_err=worst, tol=1e-4)
    check(min(float(t.log_beta.min())
              for t in out[("sampled", "cpu", 4)][0].values()) < -0.1,
          "spec parity/sampled: every draw was the argmax")
    return dict(config=cfg.name, layers=cfg.n_layers, **rec)


def _top2_gap(torch, bundle, params, prompt, tokens):
    """The top-2 logit gap of the next token after ``prompt + tokens``,
    from a dense forward of the same weights."""
    row = torch.tensor(list(prompt) + list(tokens), device=SPEC_DEVICE)[None]
    with torch.no_grad():
        logits = bundle.forward(params, row).logits[0, -1].float()
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def spec_serve_phase(torch):
    """Phase 27: speculative serving at full width through the launcher
    (v0 alone, drafting for itself: the acceptance ceiling), a lagged
    draft (v1 = v0's dense weights x 1.01, v0 drafting) sampled and
    greedy against plain greedy serving, and the 2-layer parity."""
    from repro_torch import kernels
    from repro_torch.launch import serve as launcher
    from repro_torch.metrics import collect_serve_stats
    from repro_torch.runtime import PolicyStore
    from repro_torch.serve import ServeEngine

    args = launcher.build_parser().parse_args(SPEC_ARGS)
    kernels.reset_launch_counts()
    engine, trajs, seconds = launcher.serve(args)
    launches = kernels.launch_counts()
    cfg = engine.bundle.cfg
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.d_ff, cfg.vocab_size) == (24, 896, 14, 2, 4864, 151936),
          f"spec serve phase is not full width: {cfg}")
    st = collect_serve_stats(engine)
    check(len(trajs) == args.requests and not engine.has_work,
          f"spec serve: {len(trajs)} of {args.requests} requests retired")
    check(st["drafted_tokens"] > 0 and st["acceptance_rate"] == 1.0,
          f"spec serve: v0 drafting for itself accepted "
          f"{st['accepted_tokens']} of {st['drafted_tokens']}")
    for name in SERVE_KERNELS + ("paged_attention_multi",):
        check(launches[name] > 0, f"kernel {name} never launched on the "
              "speculative serve path")
    check(launches["paged_attention_multi"]
          == st["spec_rounds"] * cfg.n_layers,
          f"spec serve: {launches['paged_attention_multi']} verify "
          f"launches for {st['spec_rounds']} rounds")
    check(engine.allocator.num_free == engine.allocator.num_blocks,
          "spec serve: pages leaked")
    emit(phase="spec_serve", config=cfg.name, layers=cfg.n_layers,
         requests=len(trajs), tokens_out=st["tokens_out"], seconds=seconds,
         tokens_per_s=st["tokens_out"] / seconds,
         spec_rounds=st["spec_rounds"], drafted=st["drafted_tokens"],
         accepted=st["accepted_tokens"],
         acceptance_rate=st["acceptance_rate"],
         draft_version=st["draft_version"],
         inter_token_p50_ms=st["inter_token_p50_ms"],
         ttft_p50_ms=st["ttft_p50_ms"], launches=launches)
    bundle, v0 = engine.bundle, engine.params
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # The lagged draft: v1 serves, v0 (one publish behind) drafts.
    store = PolicyStore(v0, capacity=2)
    store.publish(_scale_dense(v0, 1.01))
    prompts = _prompts(len(SPEC_BUDGETS))
    kw = dict(num_blocks=128, block_size=8, max_batch=4, seed=2,
              max_seq_len=256, device=SPEC_DEVICE)

    def lagged(temperature, spec=4):
        return ServeEngine(bundle, store=store, speculate_k=spec,
                           temperature=temperature,
                           decode_chunk=4, **kw)

    eng = lagged(1.0)
    kernels.reset_launch_counts()
    out, secs = _serve_timed(torch, eng, prompts, SPEC_BUDGETS)
    lag_launches = kernels.launch_counts()
    st = collect_serve_stats(eng)
    check(sorted(out) == list(range(len(SPEC_BUDGETS))),
          f"lagged draft: {len(out)} requests retired")
    check(eng.allocator.num_free == eng.allocator.num_blocks,
          "lagged draft: pages leaked")
    check((eng.version, eng.draft.version) == (1, 0)
          and store.pinned_versions() == [0],
          f"lagged draft: versions {eng.version}/{eng.draft.version}, "
          f"pins {store.pinned_versions()}")
    check(0 < st["accepted_tokens"] <= st["drafted_tokens"],
          f"lagged draft: accepted {st['accepted_tokens']}")
    # The same traffic once more, profiled (device busy / idle share).
    eng2 = lagged(1.0)
    for i, (p, n) in enumerate(zip(prompts, SPEC_BUDGETS)):
        eng2.submit(p, n, request_id=i)
    busy_ms, rows = profile_kernels(lambda: eng2.run(max_steps=10_000))
    emit(phase="spec_serve_lagged", temperature=1.0, requests=len(out),
         tokens_out=st["tokens_out"], seconds=secs,
         tokens_per_s=st["tokens_out"] / secs,
         spec_rounds=st["spec_rounds"], drafted=st["drafted_tokens"],
         accepted=st["accepted_tokens"],
         acceptance_rate=st["acceptance_rate"],
         draft_version_lag_histogram=st["draft_version_lag_histogram"],
         verify_varlen_launches_t4=lag_launches["paged_attention_multi"],
         device_busy_ms=busy_ms,
         idle_share=max(0.0, 1.0 - busy_ms / (secs * 1e3)),
         top_kernels=rows[:6], launches=lag_launches)
    del eng, eng2

    # Greedy: the lagged draft against plain greedy serving of v1.
    spec_eng, plain_eng = lagged(0.0), lagged(0.0, spec=0)
    spec_out, spec_s = _serve_timed(torch, spec_eng, prompts, SPEC_BUDGETS)
    plain_out, plain_s = _serve_timed(torch, plain_eng, prompts, SPEC_BUDGETS)
    same = total = 0
    gaps = []
    for rid, p in plain_out.items():
        a, b = spec_out[rid].tokens.tolist(), p.tokens.tolist()
        n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        total += len(b)
        same += len(b) if n is None else n
        if n is not None:
            gaps.append(_top2_gap(torch, bundle, store.get(1), prompts[rid],
                                  b[:n]))
    check(all(g < NEAR_TIE for g in gaps),
          f"spec greedy diverges from plain greedy away from a near tie: "
          f"top-2 gaps {gaps}")
    sst = collect_serve_stats(spec_eng)
    emit(phase="spec_serve_divergence", temperature=0.0,
         tokens=total, tokens_agreeing=same,
         token_agreement=same / max(total, 1),
         requests_diverging=len(gaps), top2_gaps_at_divergence=gaps,
         near_tie=NEAR_TIE, acceptance_rate=sst["acceptance_rate"],
         spec_tokens_per_s=sst["tokens_out"] / spec_s,
         plain_tokens_per_s=plain_eng.stats.tokens_out / plain_s)
    del spec_eng, plain_eng, store, v0
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase="spec_parity", **_spec_parity(torch))
    return launches


BEST_OF = dict(best_of=4, n_prompts=2, max_batch=4, gen_len=16,
               block_size=8, num_blocks=64, prompt_len=32, decode_chunk=8,
               repeats=3)
BENCH_SERVE = ROOT / "results" / "BENCH_serve.json"


def prefix_cache_phase(torch):
    """Phase 28: ``benchmarks.bench_serve.run_best_of``'s run shape at full
    width (2 prompts x best-of 4, greedy, unshared against prefix-cached
    engines, a warm pair then ``repeats`` + 1 pairs), gated on the
    bench's token counts; then the cached engine with ``speculate_k=3``."""
    from repro_torch.configs import get_config
    from repro_torch.metrics import collect_serve_stats
    from repro_torch.models.registry import build
    from repro_torch.serve import ServeEngine

    want = json.loads(BENCH_SERVE.read_text())["best_of"]
    c = BEST_OF
    check(all(want["config"][k] == c[k] for k in want["config"]
              if k in c), f"prefix phase: run shape {c} is not the "
              f"bench's {want['config']}")
    cfg = get_config("qwen2.5-0.5b")
    bundle = build(cfg)
    params = bundle.init(torch.Generator(device=SPEC_DEVICE).manual_seed(0),
                         device=SPEC_DEVICE)
    prompts = _prompts(c["n_prompts"], seed=1)

    def make(prefix, spec=0):
        return ServeEngine(
            bundle, params, num_blocks=c["num_blocks"],
            block_size=c["block_size"], max_batch=c["max_batch"],
            max_seq_len=c["prompt_len"] + c["gen_len"] + c["block_size"],
            decode_chunk=c["decode_chunk"], temperature=1e-4, seed=2,
            prefix_cache=prefix, speculate_k=spec, device=SPEC_DEVICE)

    def run(eng):
        before = eng.stats.prefill_tokens, eng.stats.cow_copies, \
            eng.stats.tokens_out
        rid = 0
        for p in prompts:
            for _ in range(c["best_of"]):
                eng.submit(p, c["gen_len"], request_id=f"bo{rid}")
                rid += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trajs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return dict(wall_s=wall, tokens=eng.stats.tokens_out - before[2],
                    prefill=eng.stats.prefill_tokens - before[0],
                    cow=eng.stats.cow_copies - before[1],
                    out={t.request_id: t.tokens.tolist() for t in trajs})

    dense, shared = make(False), make(True)
    warm_d, warm_s = run(dense), run(shared)
    pairs = [(run(dense), run(shared)) for _ in range(c["repeats"] + 1)][1:]
    st = collect_serve_stats(shared)
    spec = make(True, spec=3)
    spec_run = run(spec)
    sst = collect_serve_stats(spec)
    exact = warm_s["out"] == warm_d["out"]
    exact_spec = spec_run["out"] == warm_d["out"]
    ratio = warm_d["prefill"] / max(warm_s["prefill"], 1)
    check(exact, "prefix phase: shared output differs from unshared")
    check(exact_spec, "prefix phase: speculative shared output differs "
          "from unshared")
    check((warm_d["prefill"], warm_s["prefill"]) == (
        want["unshared_prefill_tokens"], want["shared_prefill_tokens"]),
        f"prefix phase: prefill rows {warm_d['prefill']} / "
        f"{warm_s['prefill']}, the bench's "
        f"{want['unshared_prefill_tokens']} / "
        f"{want['shared_prefill_tokens']}")
    check(warm_s["cow"] == want["cow_copies"],
          f"prefix phase: {warm_s['cow']} copies, the bench's "
          f"{want['cow_copies']}")
    for key in ("prefix_hit_rate", "prefix_token_hit_rate"):
        check(st[key] == want[key], f"prefix phase: {key} {st[key]}, the "
              f"bench's {want[key]}")
    for eng in (dense, shared, spec):
        check(eng.allocator.num_free == eng.allocator.num_blocks
              and not eng.scheduler.running,
              "prefix phase: pages leaked")
    d_best = min((d for d, _ in pairs), key=lambda r: r["wall_s"])
    s_best = min((s for _, s in pairs), key=lambda r: r["wall_s"])
    ratios = sorted((s["tokens"] / s["wall_s"]) / (d["tokens"] / d["wall_s"])
                    for d, s in pairs)
    emit(phase="prefix_cache", config=cfg.name, layers=cfg.n_layers,
         run_shape=c, token_exact=exact, token_exact_speculative=exact_spec,
         prefill_cost_ratio=ratio, unshared_prefill_tokens=warm_d["prefill"],
         shared_prefill_tokens=warm_s["prefill"],
         cow_copies=warm_s["cow"], prefix_hit_rate=st["prefix_hit_rate"],
         prefix_token_hit_rate=st["prefix_token_hit_rate"],
         unshared_tokens_per_s=d_best["tokens"] / d_best["wall_s"],
         tokens_per_s=s_best["tokens"] / s_best["wall_s"],
         paired_speedup_median=ratios[len(ratios) // 2],
         speculative_tokens_per_s=spec_run["tokens"] / spec_run["wall_s"],
         speculative_acceptance=sst["acceptance_rate"],
         speculative_prefill_tokens=spec_run["prefill"])


SPEC_RLVR_K = 2
SPEC_RLVR_TOL = 1.43e-5      # phase 22's reading of the same rule


def spec_rlvr_phase(torch, baseline):
    """Phase 29: phase 19's cell with ``engine_prefix_cache=True`` and
    ``engine_speculate_k=2`` set in ``RLVRHyperparams``: prefix hits,
    fewer prefill rows a minibatch than phase 19's (``baseline``), every
    token's ``log_beta`` against the serving version's re-scoring (under
    forced lag every token and its whole history ran under v0), both
    log-prob kernels on every learner step."""
    import numpy as np
    import repro_torch.train as train_pkg
    from repro_torch import kernels
    from repro_torch.launch import train as launcher
    from repro_torch.metrics import collect_serve_stats
    from repro_torch.obs.tracer import Tracer
    from repro_torch.rollout.sampler import score_tokens
    from repro_torch.runtime import ServeRolloutProducer

    args = launcher.build_parser().parse_args(SERVE_RLVR_ARGS)
    tracer = Tracer(detail="spans")
    items = []
    put = ServeRolloutProducer._put
    hparams = train_pkg.RLVRHyperparams

    def recording_put(self, mb, **meta):
        items.append((mb, int(self.engine.version)))
        put(self, mb, **meta)

    ServeRolloutProducer._put = recording_put
    train_pkg.RLVRHyperparams = lambda **kw: hparams(
        engine_prefix_cache=True, engine_speculate_k=SPEC_RLVR_K, **kw)
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        trainer, res, warm_loss = launcher.run(args, tracer)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        ServeRolloutProducer._put = put
        train_pkg.RLVRHyperparams = hparams
    cfg, hp, engine = trainer.bundle.cfg, trainer.hp, trainer.engine
    check((cfg.n_layers, cfg.d_model, cfg.vocab_size) == (24, 896, 151936)
          and hp.engine_prefix_cache and hp.engine_speculate_k == SPEC_RLVR_K,
          f"spec rlvr phase: {cfg.name} {hp}")
    steps = len(res.phase_logs)
    check(steps == hp.n_minibatches and len(items) == steps,
          f"spec rlvr: {steps} learner steps, {len(items)} items")
    st = collect_serve_stats(engine)
    produce = _span_seconds(tracer, "produce")
    rows_per_mb = st["prefill_tokens"] / len(produce)
    check(st["prefix_hits"] > 0 and rows_per_mb < baseline["prefill_rows"],
          f"spec rlvr: prefix hits {st['prefix_hits']}, prefill rows a "
          f"minibatch {rows_per_mb} (phase 19: {baseline['prefill_rows']})")
    check(st["drafted_tokens"] > 0 and launches["paged_attention_multi"] > 0,
          f"spec rlvr: drafted {st['drafted_tokens']}, verify launches "
          f"{launches['paged_attention_multi']}")
    check(launches["fused_logprob_bwd"] == steps
          and launches["fused_logprob"] == 2 * steps,
          f"spec rlvr: log-prob kernels launched {launches['fused_logprob']}"
          f" / {launches['fused_logprob_bwd']} in {steps} learner steps")
    # Cached pages with no reference count as free.
    check(engine.allocator.num_free == engine.allocator.num_blocks
          and not engine.scheduler.running, "spec rlvr: pages leaked")
    # Forced lag 2 from v1 and v2 resolves to v0 both times, and the
    # engine still holds v0: every token and its history ran under it.
    worst, n_tokens = 0.0, 0
    for mb, version in items:
        versions = np.asarray(mb.versions)
        valid = mb.gen.mask.cpu().numpy() > 0
        check(version == engine.version == 0
              and set(versions[valid].tolist()) <= {0},
              f"spec rlvr: an item from version {version}")
        with torch.no_grad():
            log_pi, _, _ = score_tokens(trainer.bundle, engine.params,
                                        mb.gen.tokens,
                                        trainer.dataset.prompt_len)
        err = np.abs(log_pi.cpu().numpy() - mb.gen.log_beta.cpu().numpy())
        worst = max(worst, float(err[valid].max()))
        n_tokens += int(valid.sum())
    check(worst <= SPEC_RLVR_TOL, f"spec rlvr: log_beta {worst} from the "
          "verifier's re-scoring")
    step = trainer.metrics.histogram("train_step_s").summary()
    emit(phase="spec_rlvr", config=cfg.name, layers=cfg.n_layers,
         seconds=seconds, warmup_loss=warm_loss, learner_steps=steps,
         learner_step_p50_ms=step["p50"] * 1e3,
         phase19_learner_step_p50_ms=baseline["learner_step_p50_ms"],
         tokens_out=engine.stats.tokens_out,
         generation_tokens_per_s=engine.stats.tokens_out / sum(produce),
         phase19_generation_tokens_per_s=baseline["generation_tokens_per_s"],
         prefill_rows_per_minibatch=rows_per_mb,
         phase19_prefill_rows_per_minibatch=baseline["prefill_rows"],
         prefix_hits=st["prefix_hits"], prefix_queries=st["prefix_queries"],
         prefix_token_hit_rate=st["prefix_token_hit_rate"],
         cow_copies=st["cow_copies"], spec_rounds=st["spec_rounds"],
         drafted=st["drafted_tokens"], accepted=st["accepted_tokens"],
         acceptance_rate=st["acceptance_rate"],
         log_beta_max_abs_err=worst, tokens_rescored=n_tokens,
         tol=SPEC_RLVR_TOL,
         tv=[l.tv for l in res.phase_logs], launches=launches)


# ---------------------------------------------------------------------------
# Phases 30-32: training hymba (the two backward kernels)
# ---------------------------------------------------------------------------

# The learner's shape: 16 prompts x 4 completions of 32 + 8 tokens.
LEARN_B, LEARN_S = 64, 40
FLASH_BWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # of max(1, |ref|)
HYMBA_TRAIN_ARGS = [
    "rlvr", "--full-width", "--arch", "hymba-1.5b", "--device", "cuda",
    "--warmup-steps", "2", "--n-minibatches", "2", "--phases", "1"]
HYMBA_LONG_TRAIN = 2100          # phase 32's forward past CHUNKED_ATTN_THRESHOLD


def _grad_err(got, want, tol: float, what: str) -> float:
    """Largest error of a gradient; fails past ``tol * max(1, |want|)``."""
    check(got.shape == want.shape and got.dtype == want.dtype
          and bool(got.isfinite().all()), f"{what}: bad gradient")
    return _scaled_err(got.float(), want.float(), tol, what)


def _flash_bwd_case(torch, dtype, b, s, hh, kk, d, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, d_out = (torch.randn(b, s, n, d, generator=gen,
                                  device="cuda").to(dtype)
                      for n in (hh, kk, kk, hh))
    return q, k, v, d_out


def _flash_bwd_bound(b, s, hh, kk, d, window, dname):
    """``flash_attention_bwd``'s bound: q, out, d_out, k, v and lse read
    once, dq, dk, dv written once; 10 D operations per attended (query,
    key) pair and head (scores recomputed, dP, dV, dK, dQ), at the peak
    for the inputs' type, as the forward's bound takes it."""
    esize = 4 if dname == "float32" else 2
    nbytes = (4 * b * s * hh * d + 4 * b * s * kk * d) * esize + b * s * hh * 4
    return bound(nbytes, 10 * d * hh * b * _attended_pairs(s, window), dname)


def _sdpa_bwd(torch, q, k, v, d_out, window):
    """The library yardstick of ``flash_attention_bwd``, timed only: a
    call of SDPA's backward on [B, H, S, D] with the kv heads repeated,
    causal or with the band mask, through the kept graph."""
    import torch.nn.functional as F

    s, hh, kk = q.shape[1], q.shape[2], k.shape[2]
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    kt, vt = (x.repeat_interleave(hh // kk, dim=2).transpose(1, 2)
              .contiguous().requires_grad_(True) for x in (k, v))
    if window is None or window >= s:
        o_t = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    else:
        i = torch.arange(s, device="cuda")
        band = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
        o_t = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band)
    do_t = d_out.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(o_t, (qt, kt, vt), do_t,
                                       retain_graph=True)


def _flash_fwd_learner(torch):
    """Kernel 6, the forward, at the learner shapes with the logsumexp
    kept (every warmup and learner step asks for it), both dtypes, timed
    beside its plain version and SDPA's forward."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (FLASH_SYMBOLS,
                                                     flash_attention_cuda,
                                                     flash_impl)

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        esize = torch.empty((), dtype=dtype).element_size()
        for case, hh, kk, window in (
                ("hymba_learner_lse", HYMBA_H, HYMBA_KV, HYMBA_WINDOW),
                ("qwen_learner_lse", 14, 2, None)):
            b, s, d = LEARN_B, LEARN_S, 64
            q, k, v, _ = _flash_bwd_case(torch, dtype, b, s, hh, kk, d,
                                         seed=s + hh + 1)
            out, lse = flash_attention_cuda(q, k, v, window=window,
                                            return_lse=True)
            want, want_lse = ref.ref_attention_lse(q, k, v, window=window)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            lse_err = (lse - want_lse).abs().max().item()
            check(err <= FLASH_TOL[dname] and lse_err <= 2e-5 * max(
                1.0, want_lse.abs().max().item()),
                f"flash/{case}/{dname}: out {err}, lse {lse_err}")
            kern = lambda: flash_attention_cuda(q, k, v, window=window,
                                                return_lse=True)
            plain = lambda: ref.ref_attention_lse(q, k, v, window=window)
            qt = q.transpose(1, 2).contiguous()
            kt, vt = (x.repeat_interleave(hh // kk, dim=2).transpose(1, 2)
                      .contiguous() for x in (k, v))
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         is_causal=True)
            # q, k, v read once, out and lse written once; 4 D operations
            # per attended pair and head.
            nbytes = ((2 * b * s * hh * d + 2 * b * s * kk * d) * esize
                      + b * s * hh * 4)
            impl = flash_impl(dtype, d, lse=True)
            b_ms, b_by = bound(nbytes, 4 * d * hh * b * _attended_pairs(
                s, window), _flash_rate(impl, dname))
            rec = dict(phase="kernel", kernel="flash_attention", case=case,
                       dtype=dname, impl=impl, B=b, S=s, H=hh, KV=kk, D=d,
                       window=window, max_abs_err=err, lse_err=lse_err,
                       kernel_ms=time_ms(kern, iters=50),
                       plain_ms=time_ms(plain, iters=5, warmup=1),
                       library_ms=time_ms(lib, iters=50),
                       bound_ms=b_ms, bound_by=b_by,
                       kernel_device_ms=device_ms(kern, FLASH_SYMBOLS[impl]),
                       plain_device_ms=device_ms(plain, iters=3),
                       library_device_ms=device_ms(lib, iters=5))
            emit(**rec)
            check(rec["kernel_device_ms"] is not None,
                  f"flash/{case}/{dname}: no {FLASH_SYMBOLS[impl]} in the "
                  "profile")
            del qt, kt, vt


def bwd_kernel_phase(torch):
    """Phase 30: ``flash_attention_bwd`` and ``ssm_scan_bwd`` against their
    plain backwards and autograd of the plain forwards (the scan's up to
    S 64), float32 and bfloat16; the learner's and the long shapes
    timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda, flash_bwd_impl)
    from repro_torch.kernels.ssm_scan import ssm_bwd_info, ssm_scan_bwd_cuda

    h, kv, w = HYMBA_H, HYMBA_KV, HYMBA_WINDOW
    flash_cases = (   # (case, B, S, H, KV, D, window)
        ("hymba_learner", LEARN_B, LEARN_S, h, kv, 64, w),
        ("qwen_learner", LEARN_B, LEARN_S, 14, 2, 64, None),
        ("long_local", 1, HYMBA_LONG, h, kv, 64, w),
        ("long_global", 1, HYMBA_LONG, h, kv, 64, None),
        ("s1", 2, 1, h, kv, 64, None),
        ("ragged_s37", 2, 37, h, kv, 64, 16),
        # G 7 at S 43: float32 past the short path's shared memory (long),
        # bfloat16 short; G 1 long over a ragged, windowed S.
        ("switch_s43", 2, 43, 14, 2, 64, 9),
        ("g1_long_s333", 1, 333, 4, 4, 64, 50),
        ("sweep_32", 2, 100, 4, 2, 32, 30),
        ("sweep_8", 2, 65, 2, 2, 8, None))
    # Timed: the learner shapes in both dtypes, the long ones in float32.
    timed = {"float32": ("hymba_learner", "qwen_learner", "long_local",
                         "long_global"),
             "bfloat16": ("hymba_learner", "qwen_learner")}
    headline, worst = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for case, b, s, hh, kk, d, window in flash_cases:
            t_case = time.perf_counter()
            q, k, v, d_out = _flash_bwd_case(torch, dtype, b, s, hh, kk, d,
                                             seed=s + hh)
            out, lse = flash_attention_cuda(q, k, v, window=window,
                                            return_lse=True)
            got = flash_attention_bwd_cuda(q, k, v, out, lse, d_out,
                                           window=window)
            plain = ref.ref_attention_backward(q, k, v, out, lse, d_out,
                                               window=window)
            leaves = [x.detach().clone().requires_grad_(True)
                      for x in (q, k, v)]
            auto = torch.autograd.grad(
                ref.ref_attention(*leaves, window=window), leaves, d_out)
            torch.cuda.synchronize()
            err = 0.0
            for name, g, p_, a_ in zip("qkv", got, plain, auto):
                err = max(err, _grad_err(g, p_, FLASH_BWD_TOL[dname],
                                         f"flash_bwd/{case}/{dname}/d{name}"))
                # autograd of the plain forward rounds P to the inputs'
                # dtype before the value product; the kernel keeps float32.
                _grad_err(g, a_, FLASH_BWD_TOL[dname],
                          f"flash_bwd/{case}/{dname}/d{name} vs autograd")
            worst[dname] = max(worst.get(dname, 0.0), err)
            del leaves, auto, plain
            impl = flash_bwd_impl(dtype, s, hh, kk, d)
            if case not in timed[dname]:
                emit(phase="kernel_check", kernel="flash_attention_bwd",
                     case=case, dtype=dname, impl=impl, B=b, S=s, H=hh,
                     KV=kk, D=d, window=window, max_abs_err=err,
                     tol=FLASH_BWD_TOL[dname],
                     seconds=time.perf_counter() - t_case)
                continue
            kern = lambda: flash_attention_bwd_cuda(q, k, v, out, lse, d_out,
                                                    window=window)
            plain_fn = lambda: ref.ref_attention_backward(
                q, k, v, out, lse, d_out, window=window)
            lib = _sdpa_bwd(torch, q, k, v, d_out, window)
            b_ms, b_by = _flash_bwd_bound(b, s, hh, kk, d, window, dname)
            rec = dict(phase="kernel", kernel="flash_attention_bwd",
                       case=case, dtype=dname, impl=impl, B=b, S=s, H=hh,
                       KV=kk, D=d, window=window, max_abs_err=err,
                       tol=FLASH_BWD_TOL[dname],
                       kernel_ms=time_ms(kern, iters=50),
                       plain_ms=time_ms(plain_fn, iters=3, warmup=1),
                       library_ms=time_ms(lib, iters=20),
                       bound_ms=b_ms, bound_by=b_by,
                       kernel_device_ms=device_ms(kern, "flash_bwd_"),
                       plain_device_ms=device_ms(plain_fn, iters=2),
                       library_device_ms=device_ms(lib, iters=5),
                       seconds=time.perf_counter() - t_case)
            if impl.startswith("long"):   # the path's kernels, one call
                rec["kernels_ms"] = profile_kernels(kern, lambda rows: any(
                    "flash_bwd_long" in r[0] for r in rows))[1]
            emit(**rec)
            check(rec["kernel_device_ms"] is not None,
                  f"flash_bwd/{case}/{dname}: no flash_bwd_ in the profile")
            if case == "hymba_learner":     # 30 of a step's 32 launches
                headline[("flash_attention_bwd", dname)] = rec
            del lib
    for dname, err in worst.items():
        headline[("flash_attention_bwd", dname)] = dict(
            headline[("flash_attention_bwd", dname)], max_abs_err=err)

    _flash_fwd_learner(torch)

    i_, n_ = HYMBA_I, HYMBA_N
    ssm_cases = (   # (case, B, S, I, N, carried state, strided b/c)
        ("hymba_learner", LEARN_B, LEARN_S, i_, n_, False, True),
        ("long_b1", 1, HYMBA_LONG, i_, n_, False, True),
        ("s1", 8, 1, i_, n_, True, True),
        ("ragged_s37", 2, 37, i_, n_, True, True),
        ("carried_long", 2, 600, 300, n_, True, False),
        # Four 8-step chunks and a ragged last 64-channel tile; 19 chunks,
        # their starts in device scratch.
        ("chunks_s29", 2, 29, 200, n_, True, True),
        ("scratch_s150", 1, 150, 130, n_, True, False),
        ("sweep_4", 3, 50, 40, 4, True, False))
    timed = {"float32": ("hymba_learner", "long_b1"),
             "bfloat16": ("hymba_learner",)}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        esize = torch.empty((), dtype=dtype).element_size()
        for case, bb, s, ii, nn, state, strided in ssm_cases:
            args = _ssm_args(torch, dtype, bb, s, ii, nn, state,
                             strided=strided, seed=s * ii + 1)
            gen = torch.Generator(device="cuda").manual_seed(s + 2)
            gy = torch.randn(bb, s, ii, generator=gen, device="cuda").to(
                dtype)
            ghf = torch.randn(bb, ii, nn, generator=gen, device="cuda")
            t_case = time.perf_counter()
            got = ssm_scan_bwd_cuda(*args, gy, ghf)
            plain = ref.ref_ssm_scan_backward(*args, gy, ghf)
            leaves = [None if x is None else
                      x.detach().clone().requires_grad_(True) for x in args]
            # Autograd of the plain loop records S steps of graph: held to
            # it up to S 64 (the plain backward covers every case).
            auto = [None] * 6
            if s <= 64:
                y, hf = ref.ref_ssm_scan(*leaves)
                it = iter(torch.autograd.grad(
                    (y, hf), [x for x in leaves if x is not None],
                    (gy, ghf)))
                auto = [None if x is None else next(it) for x in leaves]
                del y, hf
            torch.cuda.synchronize()
            names = ("du", "ddt", "db", "dc", "da", "dh0")
            err = 0.0
            for name, g, p_, leaf, a_ in zip(names, got, plain, leaves,
                                             auto):
                if leaf is None:
                    check(g is None, f"ssm_bwd/{case}: dh0 without h0")
                    continue
                err = max(err, _grad_err(g, p_, SSM_TOL[dname],
                                         f"ssm_bwd/{case}/{dname}/{name}"))
                if a_ is not None:
                    _grad_err(g, a_.to(g.dtype), SSM_TOL[dname],
                              f"ssm_bwd/{case}/{dname}/{name} vs autograd")
            worst[("ssm", dname)] = max(worst.get(("ssm", dname), 0.0), err)
            del leaves, auto, plain
            # Registers, spills, resident blocks and where the chunk
            # starts live, as the card reports them for this S.
            info = ssm_bwd_info(dtype, s)
            if case not in timed[dname]:
                emit(phase="kernel_check", kernel="ssm_scan_bwd", case=case,
                     dtype=dname, B=bb, S=s, I=ii, N=nn, strided=strided,
                     max_abs_err=err, tol=SSM_TOL[dname], **info,
                     seconds=time.perf_counter() - t_case)
                continue
            kern = lambda: ssm_scan_bwd_cuda(*args, gy, ghf)
            plain_fn = lambda: ref.ref_ssm_scan_backward(*args, gy, ghf)
            # u, dt, dy, b, c, a (and h0, the final state's gradient) read
            # once; du, ddt, db, dc, da (and dh0) written once.  About 20
            # float32 operations per state element and step (two
            # exponentials, the recomputed and the reverse recurrences,
            # five gradient terms), at the peak for the inputs' type.
            st = bb * ii * nn * 4
            nbytes = ((5 * bb * s * ii + 4 * bb * s * nn) * esize
                      + 2 * ii * nn * 4 + st * (3 if state else 1))
            b_ms, b_by = bound(nbytes, 20 * bb * s * ii * nn, dname)
            # The plain loop takes ~1.4 s at S 2048: timed once there.
            short = s <= 64
            rec = dict(phase="kernel", kernel="ssm_scan_bwd", case=case,
                       dtype=dname, B=bb, S=s, I=ii, N=nn, strided=strided,
                       max_abs_err=err, tol=SSM_TOL[dname], **info,
                       kernel_ms=time_ms(kern, iters=50),
                       plain_ms=time_ms(plain_fn, iters=2 if short else 1,
                                        warmup=1 if short else 0),
                       library_ms=None, bound_ms=b_ms, bound_by=b_by,
                       kernel_device_ms=device_ms(kern, "ssm_scan_bwd"),
                       plain_device_ms=(device_ms(plain_fn, iters=1)
                                        if short else None))
            rec["seconds"] = time.perf_counter() - t_case
            if case == "hymba_learner":   # the main and the reduce kernel
                rec["kernels_ms"] = profile_kernels(kern, lambda rows: sum(
                    "ssm_scan_bwd" in r[0] for r in rows) >= 2)[1]
            emit(**rec)
            if case == "hymba_learner":      # every layer of a step
                headline[("ssm_scan_bwd", dname)] = rec
                check(info["local_bytes"] == 0 and info["blocks_per_sm"] >= 2
                      and info["starts_on_chip"],
                      f"ssm_bwd/{dname}: {info} at the learner's shape")
    for dname in ("float32", "bfloat16"):
        headline[("ssm_scan_bwd", dname)] = dict(
            headline[("ssm_scan_bwd", dname)],
            max_abs_err=worst[("ssm", dname)])
    return headline


def _train_run(torch, argv):
    """``train rlvr`` with ``argv`` in-process under a span tracer:
    ``(trainer, result, warmup loss, seconds, launches, peak allocated
    GiB, peak reserved GiB, produce spans)``."""
    from repro_torch import kernels
    from repro_torch.launch import train as launcher
    from repro_torch.obs.tracer import Tracer

    args = launcher.build_parser().parse_args(argv)
    tracer = Tracer(detail="spans")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trainer, res, warm_loss = launcher.run(args, tracer)
    torch.cuda.synchronize()
    return (trainer, res, warm_loss, time.perf_counter() - t0,
            kernels.launch_counts(),
            torch.cuda.max_memory_allocated() / 2 ** 30,
            torch.cuda.max_memory_reserved() / 2 ** 30,
            _span_seconds(tracer, "produce"))


def _train_record(tag, trainer, res, warm_loss, seconds, launches, peak,
                  peak_reserved, produce, **extra):
    """The run's JSON line: learner step p50 and mean, generation
    tokens/s over the ``produce`` spans, tv, grad norms, peak memory."""
    hp = trainer.hp
    step = trainer.metrics.histogram("train_step_s").summary()
    gnorm = trainer.metrics.histogram("train_grad_norm").summary()
    batch = hp.prompts_per_minibatch * hp.completions_per_prompt
    emit(phase=tag, config=trainer.bundle.cfg.name,
         layers=trainer.bundle.cfg.n_layers, seconds=seconds,
         warmup_loss=warm_loss, eval_accuracy=res.eval_accuracy,
         learner_steps=len(res.phase_logs),
         learner_step_p50_ms=step["p50"] * 1e3,
         learner_step_mean_ms=step["mean"] * 1e3,
         minibatches_generated=len(produce),
         generation_tokens_per_s=(len(produce) * batch * hp.max_new_tokens
                                  / sum(produce)),
         tv=[l.tv for l in res.phase_logs], **extra,
         grad_norm_mean=gnorm["mean"], peak_memory_gib=peak,
         peak_reserved_gib=peak_reserved, launches=launches)


def _learner_step_profile(torch, trainer, adv_of, want, kernel_keys, tag,
                          resample=None):
    """One more learner step of ``trainer`` on a fresh minibatch with the
    advantages ``adv_of(rows)`` gives (and, with ``resample``, the
    ``(tokens, log_beta)`` it makes of the minibatch's): exactly
    ``want``'s launches, finite loss, grad norm > 0, the params moved;
    then its wall (the median of three), peak memory and one profiled
    step (device busy, idle share, device ms of the kernels whose names
    hold each of ``kernel_keys``), as the ``tag`` line.  Returns the
    step's ``(tokens, log_beta, mask, advantages, grad norm)``."""
    from repro_torch import kernels
    from repro_torch.train import make_update_step
    from repro_torch.utils.tree import tree_leaves

    hp, state = trainer.hp, trainer.state
    mb = trainer.generator.generate_minibatch(state.params)
    tokens, log_beta, mask = mb.gen.tokens, mb.gen.log_beta, mb.gen.mask
    if resample is not None:
        tokens, log_beta = resample(tokens)
    adv = adv_of(mask.shape[0]).to(tokens.device)
    update = make_update_step(trainer.bundle, hp, trainer.dataset.prompt_len)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    new, aux = update(state, tokens, log_beta, mask, adv)
    torch.cuda.synchronize()
    per_step = kernels.launch_counts()
    check(all(per_step[k] == n for k, n in want.items()),
          f"{tag}: the learner step launched {per_step}, want {want}")
    loss_v, gn = aux["loss"].item(), aux["grad_norm"].item()
    check(math.isfinite(loss_v) and math.isfinite(gn) and gn > 0,
          f"{tag}: loss {loss_v}, grad norm {gn}")
    moved = max((a - b_).abs().max().item() for a, b_ in
                zip(tree_leaves(new.params), tree_leaves(state.params)))
    check(moved > 0, f"{tag}: the params did not move")
    del new
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        update(state, tokens, log_beta, mask, adv)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    wall_ms = sorted(walls)[1]
    peak_step = torch.cuda.max_memory_allocated() / 2 ** 30
    peak_step_reserved = torch.cuda.max_memory_reserved() / 2 ** 30
    busy_ms, rows = profile_kernels(
        lambda: update(state, tokens, log_beta, mask, adv))
    kernel_ms = {k: sum(ms for name, ms, _ in rows if k in name)
                 for k in kernel_keys}
    emit(phase=tag, rows=mask.shape[0], seq=tokens.shape[1],
         loss=loss_v, grad_norm=gn, max_param_change=moved,
         launches=per_step, wall_ms=wall_ms, walls_ms=walls,
         device_busy_ms=busy_ms,
         idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
         kernel_ms=kernel_ms, peak_memory_gib=peak_step,
         peak_reserved_gib=peak_step_reserved,
         kernel_launches=sum(n for _, _, n in rows), top_kernels=rows[:8])
    return tokens, log_beta, mask, adv, gn


def hymba_train_phase(torch):
    """Phase 31: ``train rlvr --full-width --arch hymba-1.5b`` in-process
    (2 warmup steps, one phase of 2 minibatches), then one learner step
    with seeded rewards, counted and profiled.  Returns the run's
    launches."""
    from repro_torch.core.losses import group_advantages

    run = _train_run(torch, HYMBA_TRAIN_ARGS)
    trainer, res, warm_loss, _, launches, _, _, produce = run
    cfg, hp = trainer.bundle.cfg, trainer.hp
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.ssm.expand * cfg.d_model, cfg.vocab_size)
          == (HYMBA_L, 1600, HYMBA_H, HYMBA_KV, HYMBA_I, 32001),
          f"hymba train phase is not full width: {cfg}")
    steps = len(res.phase_logs)
    check(steps == hp.n_minibatches and trainer.nonfinite_skipped == 0,
          f"{steps} learner steps logged of {hp.n_minibatches}")
    # Every warmup and learner step's forward and backward run both
    # backward kernels once a layer; the log-prob kernels once a learner
    # step (the warmup's NLL is plain log_softmax).
    grad_steps = hp.warmup_steps + steps
    for name in ("ssm_scan_bwd", "flash_attention_bwd"):
        check(launches[name] == cfg.n_layers * grad_steps,
              f"{name} launched {launches[name]} times in {grad_steps} "
              f"steps of {cfg.n_layers} layers")
    for name in ("fused_logprob", "fused_logprob_bwd"):
        check(launches[name] == steps,
              f"{name} launched {launches[name]} times in {steps} steps")
    generates = len(produce) + 1 + len(res.eval_accuracy)
    check(len(produce) > 0 and launches["flash_attention"]
          == cfg.n_layers * (generates + grad_steps)
          and launches["ssm_scan"] > cfg.n_layers * (generates + grad_steps),
          f"forward launches {launches} for {generates} generates")
    check(all(math.isfinite(l.tv) for l in res.phase_logs)
          and math.isfinite(warm_loss), "non-finite warmup loss or tv")
    gnorm = trainer.metrics.histogram("train_grad_norm").summary()
    check(gnorm["max"] > 0 and math.isfinite(gnorm["max"]),
          f"hymba train: grad norms {gnorm}")
    _train_record("hymba_train", *run)

    # One more learner step with seeded rewards (nonzero advantages).
    def adv_of(rows):
        gen = torch.Generator().manual_seed(11)
        rewards = (torch.rand(rows, generator=gen) < 0.5).float()
        return group_advantages(rewards, hp.completions_per_prompt)

    _learner_step_profile(
        torch, trainer, adv_of,
        {"ssm_scan_bwd": cfg.n_layers, "flash_attention_bwd": cfg.n_layers,
         "flash_attention": cfg.n_layers, "fused_logprob": 1,
         "fused_logprob_bwd": 1},
        ("flash_bwd_", "flash_kernel", "ssm_scan_bwd", "ssm_scan_kernel",
         "logprob"), "hymba_step_profile")
    del trainer, run
    return launches


def hymba_train_parity_phase(torch):
    """Phase 32: 2 full-width hymba layers, dense weights x3: phase 9's
    warmup + VACO step card against CPU, then one B 1 x S 2100 forward
    and backward (the CPU's chunked plain attention against the card's
    kernels) with its param grads compared."""
    from repro_torch.kernels import ref

    cfg, bundle, params = train_parity_phase(
        torch, "hymba-1.5b", dense_scale=3.0, tag="hymba_train_parity",
        same_start=True)
    s = HYMBA_LONG_TRAIN
    check(s > ref.CHUNKED_ATTN_THRESHOLD and s > cfg.window_for_layer(0),
          "phase 32's long forward must pass the chunked threshold")
    _long_train_parity(torch, cfg, bundle, params, s,
                       "hymba_long_train_parity",
                       {"flash_attention_bwd": cfg.n_layers,
                        "ssm_scan_bwd": cfg.n_layers})


def _long_train_parity(torch, cfg, bundle, params, s, tag, want, **extra):
    """One B 1 x S ``s`` forward and backward of ``params`` (the next
    token's cross-entropy) on the CPU's plain path and on the card:
    loss and every param grad within 1e-4 of its largest magnitude; the
    card launches each kernel of ``want`` the times given."""
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.utils.tree import tree_leaves, tree_map, tree_to

    tokens = torch.randint(3, cfg.vocab_size, (1, s),
                           generator=torch.Generator().manual_seed(12))
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.clone().requires_grad_(True),
                     tree_to(params, dev))
        leaves = tree_leaves(p)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        logits = bundle.forward(p, tokens.to(dev)).logits[0, :-1]
        loss = F.cross_entropy(logits.float(), tokens[0, 1:].to(dev))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = dict(loss=loss.item(), seconds=time.perf_counter() - t0,
                        grads=[None if g is None else g.cpu()
                               for g in grads],
                        launches=kernels.launch_counts())
        del logits, loss, grads, leaves, p
    cpu, card = out["cpu"], out["cuda"]
    check(all(card["launches"][k] == n for k, n in want.items()),
          f"{tag}: launches {card['launches']}, want {want}")
    worst_rel, worst_leaf = 0.0, None
    for idx, (g, w) in enumerate(zip(card["grads"], cpu["grads"])):
        check((g is None) == (w is None), f"{tag}: grad {idx} missing")
        if w is None:
            continue
        check(bool(torch.isfinite(g).all()), f"{tag}: grad {idx} NaN")
        rel = (g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        if rel > worst_rel:
            worst_rel, worst_leaf = rel, idx
    rel_loss = abs(card["loss"] - cpu["loss"]) / max(1.0, abs(cpu["loss"]))
    emit(phase=tag, S=s, layers=cfg.n_layers, **extra,
         loss_cpu=cpu["loss"], loss_cuda=card["loss"], loss_rel_err=rel_loss,
         grad_rel_err=worst_rel, worst_leaf=worst_leaf, tol=1e-4,
         cpu_s=cpu["seconds"], cuda_s=card["seconds"])
    check(rel_loss <= 1e-4 and worst_rel <= 1e-4,
          f"{tag}: loss {rel_loss}, grads {worst_rel}")


# ---------------------------------------------------------------------------
# Phases 33-35: training rwkv6 (the wkv6 backward kernel)
# ---------------------------------------------------------------------------

WKV6_BWD_TOL = {"float32": 3e-4, "bfloat16": 2e-2}   # of max(1, |ref|)
# Phase 34: du against float64 on the learner's own inputs, as a share
# of its largest magnitude (ROADMAP C8: a float32 sum of those ~2,560
# cancelling terms is ~1e-5 off in any order; the kernel's compensated
# sums keep ~1e-7).
WKV6_BWD_DU_TOL = 1e-5
RWKV_TRAIN_ARGS = [
    "rlvr", "--full-width", "--arch", "rwkv6-1.6b", "--device", "cuda",
    "--warmup-steps", "2", "--n-minibatches", "2", "--phases", "1"]


def _wkv6_bwd_bound(b, s, h, kd, carried, esize, dname):
    """``wkv6_bwd``'s bound: r, k, v, w and dy read, dr, dk, dv and dw
    written once, u and du once each, and where the call carries them
    the initial state and the final state's gradient read and the
    state's gradient written; 12 operations per state element and step
    (the recomputed state, the dr, dk, dw and dv products, the reverse
    recurrence) at the peak of the inputs' type, as every bound of the
    port takes it (the kernel's own arithmetic is float32 either way)."""
    n_tok = b * s * h * kd
    nbytes = ((9 * n_tok + 2 * h * kd) * esize
              + (3 * b * h * kd * kd * 4 if carried else 0))
    return bound(nbytes, 12 * n_tok * kd, dname)


def wkv6_bwd_kernel_phase(torch):
    """Phase 33: ``wkv6_bwd`` against ``ref_wkv6_backward`` and autograd
    of ``ref_wkv6`` (up to S 64), float32 and bfloat16, each instantiation
    forced at every case (``split`` with ~3 segments) and the one picked,
    two launches bit-identical; the learner shape and B 1 x S 2048 timed
    (both dtypes), the forward at the learner shape, and the
    ``wkv6_bwd_crossover`` sweep that sets the backward's thresholds."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.wkv6 import (BWD_IMPLS, bwd_split_steps,
                                          wkv6_bwd_cuda, wkv6_bwd_impl,
                                          wkv6_bwd_info, wkv6_cuda,
                                          wkv6_impl)

    h = RWKV_H
    cases = (   # (case, B, S, H, K, carried state + final grad, decay)
        ("learner", LEARN_B, LEARN_S, h, 64, False, None),
        ("b8_s32", RWKV_B, RWKV_P, h, 64, False, None),
        ("s1", 2, 1, 3, 64, True, None),
        ("ragged_s37", 2, 37, 3, 64, True, None),
        ("edge_decay", 2, 33, 2, 64, True, "mix"),     # w = 0, 1, 1e-6
        ("long_b1", 1, RWKV_LONG, h, 64, False, None),
        ("scratch_s150", 1, 150, 2, 64, True, None),   # starts off chip
        ("split_ragged", 1, 1000, 3, 64, True, "mix"),  # many segments
        ("k8", 2, 17, 1, 8, True, None),
        ("k16", 2, 32, 2, 16, False, None),
        ("k32", 2, 50, 3, 32, True, "mix"))
    timed = ("learner", "long_b1")
    names = ("dr", "dk", "dv", "dw", "du", "dstate")
    headline, worst = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        esize = torch.empty((), dtype=dtype).element_size()
        tol = WKV6_BWD_TOL[dname]
        info = wkv6_bwd_info(dtype)
        for case, bb, s, hh, kd, carried, decay in cases:
            t_case = time.perf_counter()
            args = _wkv6_inputs(torch, dtype, bb, s, hh, kd, carried, decay,
                                seed=s * hh + kd + 3)
            gen = torch.Generator(device="cuda").manual_seed(s + 5)
            gy = torch.randn(bb, s, hh, kd, generator=gen,
                             device="cuda").to(dtype)
            gs = (torch.randn(bb, hh, kd, kd, generator=gen, device="cuda")
                  if carried else None)
            plain = ref.ref_wkv6_backward(*args, gy, gs)
            auto = [None] * 6
            if s <= 64:        # autograd records S steps of graph
                leaves = [None if x is None else
                          x.detach().clone().requires_grad_(True)
                          for x in args]
                y, final = ref.ref_wkv6(*leaves)
                outs = ((y, final), (gy, gs)) if carried else ((y,), (gy,))
                it = iter(torch.autograd.grad(
                    outs[0], [x for x in leaves if x is not None], outs[1]))
                auto = [None if x is None else next(it) for x in leaves]
                del y, final, leaves
            picked = wkv6_bwd_impl(bb, s, hh)
            forced_seg = 16 * max(1, -(-s // 48))      # ~3 segments
            errs = {}
            for impl in BWD_IMPLS:
                seg = forced_seg if impl == "split" else None
                got = wkv6_bwd_cuda(*args, gy, gs, impl=impl, seg=seg)
                again = wkv6_bwd_cuda(*args, gy, gs, impl=impl, seg=seg)
                torch.cuda.synchronize()
                check(all((a is None and b_ is None) or torch.equal(a, b_)
                          for a, b_ in zip(got, again)),
                      f"wkv6_bwd/{case}/{dname}/{impl}: two launches differ")
                err = 0.0
                for name, g, p_, a_ in zip(names, got, plain, auto):
                    if p_ is None:
                        check(g is None,
                              f"wkv6_bwd/{case}: dstate without state")
                        continue
                    what = f"wkv6_bwd/{case}/{dname}/{impl}/{name}"
                    err = max(err, _grad_err(g, p_, tol, what))
                    if a_ is not None:
                        _grad_err(g, a_.to(g.dtype), tol, what + " vs autograd")
                errs[impl] = err
                del got, again
            if picked == "split":       # the picked segment length too
                got = wkv6_bwd_cuda(*args, gy, gs)
                errs["picked"] = max(
                    _grad_err(g, p_, tol, f"wkv6_bwd/{case}/{dname}/picked")
                    for g, p_ in zip(got, plain) if p_ is not None)
                del got
            err = max(errs.values())
            worst[dname] = max(worst.get(dname, 0.0), err)
            del plain, auto
            seg_picked = (bwd_split_steps(bb, s, hh) if picked == "split"
                          else 0)
            if case not in timed:
                emit(phase="kernel_check", kernel="wkv6_bwd", case=case,
                     dtype=dname, B=bb, S=s, H=hh, K=kd, carried=carried,
                     decay=decay, impl=picked, seg=seg_picked,
                     forced_split_seg=forced_seg, max_abs_err=errs, tol=tol,
                     seconds=time.perf_counter() - t_case)
                continue
            kern = lambda: wkv6_bwd_cuda(*args, gy, gs)
            plain_fn = lambda: ref.ref_wkv6_backward(*args, gy, gs)
            short = s <= 64      # the plain loop takes seconds at S 2048
            b_ms, b_by = _wkv6_bwd_bound(bb, s, hh, kd, carried, esize,
                                         dname)
            rec = dict(phase="kernel", kernel="wkv6_bwd", case=case,
                       dtype=dname, B=bb, S=s, H=hh, K=kd, impl=picked,
                       seg=seg_picked, max_abs_err=err, errs=errs, tol=tol,
                       kernels=info, kernel_ms=time_ms(kern, iters=50),
                       plain_ms=time_ms(plain_fn, iters=2 if short else 1,
                                        warmup=1 if short else 0),
                       library_ms=None, bound_ms=b_ms, bound_by=b_by,
                       kernel_device_ms=device_ms(kern, "wkv6_bwd"),
                       plain_device_ms=(device_ms(plain_fn, iters=1)
                                        if short else None))
            # Each of the call's kernels by device time.
            n_kern = 4 if picked == "split" else 2
            rec["kernels_ms"] = profile_kernels(kern, lambda rows: sum(
                "wkv6_bwd" in r[0] for r in rows) >= n_kern)[1]
            if case == "learner":
                headline[("wkv6_bwd", dname)] = rec
            rec["seconds"] = time.perf_counter() - t_case
            emit(**rec)
            check(rec["kernel_device_ms"] is not None,
                  f"wkv6_bwd/{case}/{dname}: no wkv6_bwd in the profile")
            if case != "learner":
                continue
            # Row 7's learner line: the forward every learner step runs.
            fwd = lambda: wkv6_cuda(*args)
            f_ms, f_by = _wkv6_bound(bb, s, hh, kd, False, esize, dname)
            emit(phase="kernel", kernel="wkv6", case="learner", dtype=dname,
                 B=bb, S=s, H=hh, K=kd, impl=wkv6_impl(bb, s, hh),
                 kernel_ms=time_ms(fwd, iters=50),
                 plain_ms=time_ms(lambda: ref.ref_wkv6(*args), iters=2,
                                  warmup=1),
                 library_ms=None, bound_ms=f_ms, bound_by=f_by,
                 kernel_device_ms=device_ms(fwd, "wkv6_"))
    for dname, err in worst.items():
        headline[("wkv6_bwd", dname)] = dict(headline[("wkv6_bwd", dname)],
                                             max_abs_err=err)
    # Where each instantiation pays: device time of both, forced (split
    # at the picked segment length), at rwkv6's 32 heads of 64, float32,
    # zero state; then the split's segment length at B 1 x S 2048.
    for bb in (1, 2, 4, 8):
        for s in (64, 256, 2048):
            args = _wkv6_inputs(torch, torch.float32, bb, s, h, 64, False,
                                seed=s)
            gy = torch.randn(bb, s, h, 64, device="cuda")
            seg = bwd_split_steps(bb, s, h)
            ms = {impl: device_ms(lambda: wkv6_bwd_cuda(
                *args, gy, None, impl=impl, seg=seg), "wkv6_bwd")
                for impl in BWD_IMPLS}
            emit(phase="wkv6_bwd_crossover", B=bb, S=s, H=h, device_ms=ms,
                 picked=wkv6_bwd_impl(bb, s, h), seg=seg)
    args = _wkv6_inputs(torch, torch.float32, 1, RWKV_LONG, h, 64, False,
                        seed=7)
    gy = torch.randn(1, RWKV_LONG, h, 64, device="cuda")
    emit(phase="wkv6_bwd_crossover", B=1, S=RWKV_LONG, H=h, seg_ms={
        seg: device_ms(lambda: wkv6_bwd_cuda(*args, gy, None, impl="split",
                                             seg=seg), "wkv6_bwd")
        for seg in (32, 64, 128, 256, 512)},
        seg=bwd_split_steps(1, RWKV_LONG, h))
    return headline


def rwkv_train_phase(torch):
    """Phase 34: ``train rlvr --full-width --arch rwkv6-1.6b`` in-process
    (2 warmup steps, one phase of 2 minibatches), then one learner step
    with seeded advantages on seeded completions, counted and profiled,
    and its gradient held against the plain route's.  Returns the run's
    launches."""
    from repro_torch.rollout.sampler import score_tokens

    run = _train_run(torch, RWKV_TRAIN_ARGS)
    trainer, res, warm_loss, _, launches, _, _, produce = run
    cfg, hp = trainer.bundle.cfg, trainer.hp
    check(cfg.attn_free and (cfg.n_layers, cfg.d_model, cfg.d_ff,
                             cfg.vocab_size) == (RWKV_L, 2048, 7168, 65536),
          f"rwkv train phase is not full width: {cfg}")
    steps = len(res.phase_logs)
    check(steps == hp.n_minibatches and trainer.nonfinite_skipped == 0,
          f"{steps} learner steps logged of {hp.n_minibatches}")
    # Every warmup and learner step runs wkv6 and wkv6_bwd once a layer;
    # every generate (each minibatch's, the one in flight, eval) once a
    # layer for its prefill and once for each of its decode steps; the
    # log-prob kernels once a learner step.
    grad_steps = hp.warmup_steps + steps
    generates = len(produce) + 1 + len(res.eval_accuracy)
    want = {"wkv6_bwd": cfg.n_layers * grad_steps,
            "wkv6": cfg.n_layers * (generates * (1 + hp.max_new_tokens)
                                    + grad_steps),
            "fused_logprob": steps, "fused_logprob_bwd": steps}
    check(len(produce) > 0 and all(launches[k] == n
                                   for k, n in want.items()),
          f"rwkv train launched {launches}, want {want} ({generates} "
          f"generates, {grad_steps} steps)")
    check(all(math.isfinite(l.tv) for l in res.phase_logs)
          and math.isfinite(warm_loss), "non-finite warmup loss or tv")
    # A random init earns no reward: then every advantage, and so the
    # learner steps' gradient, is exactly 0 (the seeded step below holds
    # a non-zero one); a reward makes it positive.
    gnorm = trainer.metrics.histogram("train_grad_norm").summary()
    rewards = [l.mean_reward for l in res.phase_logs]
    check(math.isfinite(gnorm["max"])
          and (gnorm["max"] > 0) == any(r > 0 for r in rewards),
          f"rwkv train: grad norms {gnorm}, rewards {rewards}")
    _train_record("rwkv_train", *run, mean_reward=rewards)

    # One more learner step with seeded advantages, N(0, 1) a row (the
    # random init's completions of a prompt can coincide, and then
    # group-normalised advantages cancel), on completions the model did
    # not sample: the init puts p ~ 1 on its own samples, whose gradient
    # is then ~1e-8 and would pass a wrong backward.  Seeded tokens,
    # scored by the current params for log_beta (ratio 1).
    def adv_of(rows):
        return torch.randn(rows, generator=torch.Generator().manual_seed(11))

    def resample(tokens):
        p = trainer.dataset.prompt_len
        comp = torch.randint(
            3, cfg.vocab_size, tokens[:, p:].shape, dtype=tokens.dtype,
            generator=torch.Generator().manual_seed(13)).to(tokens.device)
        tokens = torch.cat([tokens[:, :p], comp], 1)
        with torch.no_grad():
            lp, _, _ = score_tokens(trainer.bundle, trainer.state.params,
                                    tokens, p)
        return tokens, lp

    batch = _learner_step_profile(
        torch, trainer, adv_of,
        {"wkv6": cfg.n_layers, "wkv6_bwd": cfg.n_layers,
         "fused_logprob": 1, "fused_logprob_bwd": 1},
        ("wkv6_bwd", "wkv6_chunk", "wkv6_kernel", "logprob"),
        "rwkv_step_profile", resample=resample)
    _rwkv_step_against_plain(torch, trainer, *batch)
    del trainer, run
    return launches


def _plain_wkv6_with_grad(torch):
    """``ops.wkv6``'s plain stand-in for a full-width gradient on the
    card: ``ref_wkv6`` forward, ``ref_wkv6_backward`` backward (autograd
    through the step loop would keep ~100 MB of states a step and layer
    at the learner shape)."""
    from repro_torch.kernels import ref

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, r, k, v, w, u, state):
            ctx.save_for_backward(r, k, v, w, u, state)
            return ref.ref_wkv6(r, k, v, w, u, state)

        @staticmethod
        def backward(ctx, gy, gstate):
            r, k, v, w, u, state = ctx.saved_tensors
            return ref.ref_wkv6_backward(r, k, v, w, u, state,
                                         gy.to(r.dtype).contiguous(), gstate)

    return lambda r, k, v, w, u, state=None: Plain.apply(r, k, v, w, u,
                                                         state)


def _rwkv_step_against_plain(torch, trainer, tokens, log_beta, mask, adv,
                             step_norm):
    """The seeded step's gradient at full width, twice: through the
    kernels (each layer's wkv6 inputs and its output's cotangent kept)
    and with ``ops.wkv6`` on the plain versions on the card.  The
    kernels' route launches ``wkv6_bwd`` once a layer and the plain one
    never; the grad norm is at least 1e-3 (the loss is O(1)) and within
    1e-4 of the plain route's (relative); on every layer's kept inputs
    each output of ``wkv6_bwd`` (bit-identical to the step's own launch,
    phase 33) is within 3e-4, phase 33's float32 gate, of its largest
    magnitude in ``ref_wkv6_backward`` in float64 (the largest magnitude,
    not max(1, |ref|): these gradients are ~1e-5, where an absolute
    3e-4 would pass anything).  Recorded beside them: each param
    grad's gap to the plain route over the leaf's largest magnitude
    (the two routes' forwards differ too, so this gap is float32's over
    24 layers, not the backward's), and each layer's gap of the kernel
    and of the float32 plain backward to float64 over the output's
    largest magnitude."""
    from repro_torch import kernels
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.wkv6 import wkv6_bwd_cuda
    from repro_torch.train.trainer_rlvr import make_split_update_step
    from repro_torch.utils.tree import tree_leaves_with_path

    cfg = trainer.bundle.cfg
    grad_step, _ = make_split_update_step(trainer.bundle, trainer.hp,
                                          trainer.dataset.prompt_len)
    kept, out, layers = ops.wkv6, {}, []

    def recording(r, k, v, w, u, state=None):
        y, final = kept(r, k, v, w, u, state)
        entry = [t.detach() for t in (r, k, v, w, u)] + [None]
        layers.append(entry)
        y.register_hook(lambda g: entry.__setitem__(5, g.detach()))
        return y, final

    try:
        for route, fn in (("kernels", recording),
                          ("plain", _plain_wkv6_with_grad(torch))):
            ops.wkv6 = fn
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            gr, _ = grad_step(trainer.state, tokens, log_beta, mask, adv)
            torch.cuda.synchronize()
            out[route] = dict(
                seconds=time.perf_counter() - t0,
                wkv6_bwd=kernels.launch_counts()["wkv6_bwd"],
                grads=[(n, g.cpu()) for n, g in tree_leaves_with_path(gr)])
            del gr
    finally:
        ops.wkv6 = kept
    check(out["kernels"]["wkv6_bwd"] == cfg.n_layers
          and out["plain"]["wkv6_bwd"] == 0
          and len(layers) == cfg.n_layers
          and all(e[5] is not None for e in layers),
          f"rwkv step vs plain: wkv6_bwd launches "
          f"{[out[r]['wkv6_bwd'] for r in out]}, {len(layers)} layers kept")
    norm = {r: sum((g.double() ** 2).sum().item()
                   for _, g in out[r]["grads"]) ** 0.5 for r in out}
    worst_rel, worst_leaf = 0.0, None
    for (name, g), (_, w) in zip(out["kernels"]["grads"],
                                 out["plain"]["grads"]):
        rel = (g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        if rel > worst_rel:
            worst_rel, worst_leaf = rel, name
    norm_rel = abs(norm["kernels"] - norm["plain"]) / norm["plain"]
    del out["kernels"]["grads"], out["plain"]["grads"]
    tol = WKV6_BWD_TOL["float32"]
    names = ("dr", "dk", "dv", "dw", "du")
    rel64 = {"kernel": {}, "plain32": {}}
    for i, entry in enumerate(layers):
        args = [t.contiguous() for t in entry[:5]]
        gy = entry[5].contiguous()
        got = wkv6_bwd_cuda(*args, None, gy, None)[:5]
        plain = ref.ref_wkv6_backward(*args, None, gy, None)[:5]
        want = ref.ref_wkv6_backward(*(t.double() for t in args), None,
                                     gy.double(), None)[:5]
        for name, g, p32, w64 in zip(names, got, plain, want):
            check(g.shape == w64.shape and bool(g.isfinite().all()),
                  f"rwkv step layer {i}: bad {name}")
            scale = max(w64.abs().max().item(), 1e-30)
            for route, x in (("kernel", g), ("plain32", p32)):
                rel64[route][name] = max(
                    rel64[route].get(name, 0.0),
                    (x.double() - w64).abs().max().item() / scale)
        del got, plain, want
    del layers
    emit(phase="rwkv_step_vs_plain", layers=cfg.n_layers,
         grad_norm_kernels=norm["kernels"], grad_norm_plain=norm["plain"],
         update_step_grad_norm=step_norm, grad_norm_rel_err=norm_rel,
         norm_tol=1e-4, min_grad_norm=1e-3,
         leaf_rel_err_to_plain=worst_rel, worst_leaf=worst_leaf,
         wkv6_bwd_vs_float64=dict(rel_err=rel64, tol=tol,
                                  du_tol=WKV6_BWD_DU_TOL),
         wkv6_bwd={r: out[r]["wkv6_bwd"] for r in out},
         seconds={r: out[r]["seconds"] for r in out})
    check(norm["kernels"] >= 1e-3 and norm_rel <= 1e-4,
          f"rwkv step vs plain: grad norms {norm}")
    check(all(e <= tol for e in rel64["kernel"].values()),
          f"rwkv step: wkv6_bwd from float64 by {rel64['kernel']} of each "
          f"output's largest magnitude, tolerance {tol}")
    check(rel64["kernel"]["du"] <= WKV6_BWD_DU_TOL,
          f"rwkv step: wkv6_bwd's du from float64 by "
          f"{rel64['kernel']['du']} of its largest magnitude, tolerance "
          f"{WKV6_BWD_DU_TOL}")


def rwkv_train_parity_phase(torch):
    """Phase 35: 2 full-width rwkv6 layers: phase 9's warmup + VACO step
    card against CPU, then one B 1 x S 2048 forward and backward (the
    card's split forward and split backward; the CPU's ``WKV6Fn`` on
    the plain versions) with its param grads compared."""
    from repro_torch.kernels.wkv6 import (bwd_split_steps, wkv6_bwd_impl,
                                          wkv6_bwd_info, wkv6_impl)

    # Unscaled weights: with dense x3 no float32 route holds the learner
    # gradient to 1e-4 of float64 (``--grad-conditioning``); unscaled,
    # every route does.
    cfg, bundle, params = train_parity_phase(
        torch, "rwkv6-1.6b", tag="rwkv_train_parity", same_start=True)
    s, heads = RWKV_LONG, cfg.d_model // 64
    _long_train_parity(torch, cfg, bundle, params, s,
                       "rwkv_long_train_parity",
                       {"wkv6": cfg.n_layers, "wkv6_bwd": cfg.n_layers},
                       forward_impl=wkv6_impl(1, s, heads),
                       backward=dict(impl=wkv6_bwd_impl(1, s, heads),
                                     seg=bwd_split_steps(1, s, heads),
                                     kernels=wkv6_bwd_info(torch.float32)))
    check(wkv6_bwd_impl(1, s, heads) == "split",
          f"rwkv long backward: {wkv6_bwd_impl(1, s, heads)}, not split")


def rwkv_grad_conditioning(torch):
    """``chip_smoke.py --grad-conditioning``: how far float32 holds the
    learner gradient of phase 35's 2 full-width rwkv6 layers on phase
    9's batch (the CPU's warmed params, ``log_beta`` 0.3 nats off), with
    the dense weights x3 (warmed and not) and unscaled.  The yardstick
    is the CPU in float64: every operation of the step, the recurrence
    and its backward, the norms, the decay and the log-probs included,
    keeps float64 inputs float64.  Against it: the CPU in float32, the
    card through the kernels, and the card with ``ops.wkv6`` replaced by
    ``ref_wkv6`` under autograd.  One JSON line a configuration: each
    route's loss, grad norm, its gap to float64's norm and the leaves
    furthest off (max abs error over the leaf's largest magnitude)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models.registry import build
    from repro_torch.optim import adamw_init
    from repro_torch.rollout.sampler import score_tokens
    from repro_torch.train import RLVRHyperparams, make_warmup_step
    from repro_torch.train.trainer_rlvr import (RLVRTrainState,
                                                make_split_update_step)
    from repro_torch.utils.tree import tree_leaves_with_path, tree_map

    cfg = get_config("rwkv6-1.6b").replace(n_layers=2)
    bundle = build(cfg)
    hp = RLVRHyperparams(algorithm="grpo_vaco")
    grad_step, _ = make_split_update_step(bundle, hp, 32)
    norm = lambda gs: sum((x ** 2).sum().item() for x in gs) ** 0.5
    for scale, warmed in ((3.0, True), (3.0, False), (None, True)):
        params = bundle.init(torch.Generator().manual_seed(0))
        if scale is not None:
            params = _scale_dense(params, scale)
        w_tok, w_mask, tokens, mask, adv, rng = _parity_batch(torch, hp)
        if warmed:
            st, _ = make_warmup_step(bundle, hp)(
                RLVRTrainState(params, adamw_init(params), 0),
                torch.as_tensor(w_tok), torch.as_tensor(w_mask))
            params = st.params
        tokens, mask = torch.as_tensor(tokens), torch.as_tensor(mask)
        with torch.no_grad():
            lp, _, _ = score_tokens(bundle, params, tokens, 32)
        log_beta = lp + 0.3 * torch.from_numpy(
            rng.standard_normal(lp.shape).astype(np.float32))

        def grads(dev, dtype=torch.float32, plain=False):
            kept = ops.wkv6
            if plain:
                ops.wkv6 = ref.ref_wkv6
            try:
                on = lambda t: (t.to(dev, dtype) if t.is_floating_point()
                                else t.to(dev))
                gr, aux = grad_step(
                    RLVRTrainState(tree_map(on, params), None, 0),
                    on(tokens), on(log_beta), on(mask), on(adv))
                return aux["loss"].item(), [
                    (name, g.double().cpu())
                    for name, g in tree_leaves_with_path(gr)]
            finally:
                ops.wkv6 = kept

        truth_loss, truth = grads("cpu", torch.float64)
        rec = dict(phase="grad_conditioning", config=cfg.name,
                   layers=cfg.n_layers, dense_scale=scale, warmed=warmed,
                   truth_dtype=str(truth[0][1].dtype), truth_loss=truth_loss,
                   truth_grad_norm=norm(g for _, g in truth))
        for route, kw in (("cpu32", dict(dev="cpu")),
                          ("card_kernels", dict(dev="cuda")),
                          ("card_plain", dict(dev="cuda", plain=True))):
            loss, gr = grads(**kw)
            rel = {n: (g - t).abs().max().item()
                   / max(t.abs().max().item(), 1e-30)
                   for (n, g), (_, t) in zip(gr, truth)}
            gn = norm(g for _, g in gr)
            rec[route] = dict(
                loss=loss, grad_norm=gn,
                grad_norm_rel_err=(abs(gn - rec["truth_grad_norm"])
                                   / rec["truth_grad_norm"]),
                worst_leaves=sorted(rel.items(), key=lambda kv: -kv[1])[:4])
        emit(**rec)


# ---------------------------------------------------------------------------
# Phases 36-39: head dim 128 and the batched prefill (qwen2.5-14b and
# codeqwen1.5-7b at full width)
# ---------------------------------------------------------------------------

# (arch, query heads, kv heads) at head dim 128.
D128_GEOMS = (("qwen2.5-14b", 40, 8), ("codeqwen1.5-7b", 32, 32))
D128_FLASH = (  # (case, B, S, H, KV, D, window); the first four timed
    ("q14b_prefill", 8, 32, 40, 8, 128, None),    # the batched prefill
    ("codeqwen_prefill", 8, 32, 32, 32, 128, None),
    ("q14b_ragged", 8, 37, 40, 8, 128, None),
    ("q14b_long", 1, 2048, 40, 8, 128, None),     # operations-bound
    ("edge_s1", 2, 1, 40, 8, 128, None),
    ("q14b_window", 2, 300, 40, 8, 128, 64),
    ("codeqwen_s65w", 2, 65, 32, 32, 128, 16))
D128_TIMED = 4
# Phase 36's logsumexp checks (case, B, S, H, KV, D, window), both dtypes.
D128_LSE = (D128_FLASH[0], D128_FLASH[1], D128_FLASH[3], D128_FLASH[5])
# The logsumexp's absolute tolerance in both dtypes: float32 sums of exact
# (bfloat16) or float32-accurate (3xTF32) products against the plain
# float32 logsumexp.
FLASH_LSE_TOL = 1e-5
Q14_ARGS = ["--engine", "continuous", "--arch", "qwen2.5-14b",
            "--full-width", "--device", "cuda", "--temperature", "0"]
Q14_ENGINES = (("chunked", []), ("batched", ["--no-chunked-prefill"]),
               ("unbatched", ["--no-chunked-prefill", "--no-batch-prefill"]))
CODEQWEN_ARGS = ["--engine", "continuous", "--arch", "codeqwen1.5-7b",
                 "--full-width", "--device", "cuda", "--temperature", "0",
                 "--no-chunked-prefill"]
# The first token's log-prob, engine against engine, over 48 float32
# layers; a divergence of greedy tokens must sit at a top-2 log-prob gap
# under it.
FIRST_TOKEN_TOL = 1e-4
# Phase 37's long prefill: one prompt of this many tokens, then a few.
Q14_LONG, Q14_LONG_NEW = 2048, 4


# Phase 36's paged cases: (case, row_start (None: decode), lengths,
# window, timed).
D128_PAGED = (("decode", None, [45, 17, 64, 33], None, True),
              ("varlen_t16", [40, 16, 0, 9], [1, 16, 7, 0], None, True))


def _paged_symbol(d):
    """The decode kernel's profiled name at head dim ``d``: the row-tile
    routine up to 128, the context split above."""
    return "paged_attention_kernel" if d <= 128 else \
        "paged_attention_split_kernel"


def _varlen_symbol(d):
    """The varlen kernel's profiled name at head dim ``d``: the row-tile
    routine up to 128, the tensor-core split above."""
    return "paged_attention_varlen_kernel" if d <= 128 else \
        "varlen_d256_kernel"


def _paged_rate(name, d, dname):
    """The ``PEAK_FLOPS`` key of a paged kernel's bound: 3xTF32 on the
    tensor cores for the varlen kernel's float32 above head dim 128, else
    the dtype's (the FMA pipes in float32)."""
    return "tf32x3" if (name == "paged_attention_varlen" and d > 128
                        and dname == "float32") else dname


def _paged_heads(torch, dtype, geom, hh, kk, d=128, cases=D128_PAGED,
                nb=NB, m=M, relative=False):
    """The three paged kernels at head dim ``d`` and ``hh`` / ``kk``
    heads against their plain versions (phase 36 at head dim 128: decode
    at contexts 45/17/64/33, a varlen round of T 16; phase 40 adds
    contexts past a window of 1024 over pools of ``nb`` pages and tables
    of ``m``, and phase 41's long chunk of 64 rows; above head dim 128
    each is called twice for the same bits), then a decode step's K/V
    rows, bit-exact also through
    ``ops.paged_kv_write``; a timed case and the write beside the plain
    version, a library call and the bound.  float32 within 2e-5,
    bfloat16 within 2e-2 (``relative``: of max(1, |plain|), as phase 40
    holds head dim 256).  Returns the records by ``(kernel, case)``."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_attention import (NARROW_MAX_DIM,
                                                     paged_attention_cuda,
                                                     split_geometry)
    from repro_torch.kernels.paged_attention_varlen import (
        paged_attention_varlen_cuda, varlen_splits)
    from repro_torch.kernels.paged_kv_write import paged_kv_write_cuda

    dev = torch.device("cuda")
    dname = str(dtype).split(".")[-1]
    esize = torch.empty((), dtype=dtype).element_size()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator().manual_seed(hh * 100 + kk)
    kp, vp = (torch.randn(kk, nb, BS, d, generator=gen) for _ in range(2))
    kp[:, 0] = vp[:, 0] = 1e4         # the pad page: poison, as phase 3
    kp, vp = (x.to(dtype).to(dev) for x in (kp, vp))
    out = {}
    for case, row_start, lens, window, timed in cases:
        decode = row_start is None
        rows = ([(c - 1, 1) for c in lens] if decode
                else list(zip(row_start, lens)))
        ctx = lens if decode else [a + n for a, n in rows]
        tables = _tables(gen, [max(c, 1) for c in ctx], torch, nb,
                         m).to(dev)
        t = max(16, max(lens))   # a varlen round's rows a slot
        shape = (len(lens), hh, d) if decode else (len(lens), t, hh, d)
        q = torch.randn(shape, generator=gen).to(dtype).to(dev)
        if decode:
            args = (q, kp, vp, tables,
                    torch.tensor(ctx, dtype=torch.int32, device=dev))
            kern = lambda: paged_attention_cuda(*args, window=window)
            plain = lambda: ref.ref_paged_attention(*args, window=window)
            name, symbol = "paged_attention", _paged_symbol(d)
        else:
            args = (q, kp, vp, tables,
                    torch.tensor(row_start, dtype=torch.int32, device=dev),
                    torch.tensor(lens, dtype=torch.int32, device=dev))
            kern = lambda: paged_attention_varlen_cuda(*args, window=window)
            plain = lambda: ref.ref_paged_attention_varlen(*args,
                                                           window=window)
            name, symbol = "paged_attention_varlen", _varlen_symbol(d)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        # bfloat16 of max(1, |plain|): each version rounds its output once.
        scaled = (err if dtype == torch.float32 or not relative else
                  (diff / want.float().abs().clamp(min=1.0)).max().item())
        tag = f"{name}/{geom}/{case}/{dname}"
        check(bool(torch.isfinite(got).all()), f"{tag}: non-finite")
        check(scaled <= TOL[dname],
              f"{tag}: max_abs_err {err} (scaled {scaled}) > {TOL[dname]}")
        g4 = got[:, None] if decode else got
        for b, (_, n) in enumerate(rows):
            check(bool((g4[b, n:] == 0).all()),
                  f"{tag}: padding rows of slot {b} not zero")
            check(ctx[b] > 0 or bool((g4[b] == 0).all()),
                  f"{tag}: slot {b} has no context but is not zero")
        rec = dict(phase="kernel", kernel=name, case=f"{geom}/{case}",
                   dtype=dname, B=len(lens), H=hh, KV=kk, D=d, window=window,
                   contexts=ctx, max_abs_err=err, scaled_err=scaled,
                   tol=TOL[dname])
        if d > NARROW_MAX_DIM:
            # Split over the context: the split count, and the same bits
            # again (the splits merge in a fixed order, the tickets reset).
            rec["splits"] = (split_geometry(len(lens), hh, kk, m, BS,
                                            window, sms) if decode else
                             varlen_splits(t, hh, kk, m, BS, window, sms))
            again = kern()
            torch.cuda.synchronize()
            check(torch.equal(again, got), f"{tag}: a second call differs")
        if timed:
            # SDPA over K/V gathered to dense and GQA-expanded (timed
            # only).
            keys, vals = (ref._gather_pages(x, tables).repeat_interleave(
                hh // kk, 0).transpose(0, 1) for x in (kp, vp))
            qs = q[:, None] if decode else q
            qpos = torch.tensor([[a + i for i in range(qs.shape[1])]
                                 for a, _ in rows], device=dev)
            kpos = torch.arange(m * BS, device=dev)[None, None, :]
            mask = kpos <= qpos[:, :, None]
            if window is not None:
                mask &= qpos[:, :, None] - kpos < window
            qh = qs.transpose(1, 2)
            lib = lambda: F.scaled_dot_product_attention(
                qh, keys, vals, attn_mask=mask[:, None])
            b_ms, b_by = _attention_bound(q, rows, ctx, window,
                                          1 if decode else 2, esize,
                                          _paged_rate(name, d, dname), hh,
                                          kk, d)
            rec.update(
                kernel_ms=time_ms(kern), plain_ms=time_ms(plain),
                library_ms=time_ms(lib), bound_ms=b_ms, bound_by=b_by,
                kernel_device_ms=device_ms(kern, symbol),
                plain_device_ms=device_ms(plain),
                library_device_ms=device_ms(lib))
        out[(name, case)] = rec
        emit(**rec)

    # A decode step's K/V rows into a 4-layer pool at layer 3.
    layers, layer = 4, 3
    pk, pv = (torch.randn(layers, kk, nb, BS, d, generator=gen).to(dtype)
              .to(dev) for _ in range(2))
    kr, vr = (torch.randn(B, kk, d, generator=gen).to(dtype).to(dev)
              for _ in range(2))
    dest = torch.randperm(nb * BS, generator=gen)[:B]
    page = (dest // BS).to(torch.int32).to(dev)
    off = (dest % BS).to(torch.int32).to(dev)
    act = torch.tensor([1, 1, 0, 1], dtype=torch.int32, device=dev)
    wk, wv = pk.clone(), pv.clone()
    ref.ref_paged_kv_write(wk, wv, kr, vr, page, off, act, layer=layer)
    ok, ov = pk.clone(), pv.clone()
    paged_kv_write_cuda(pk, pv, kr, vr, page, off, act, layer=layer)
    ops.paged_kv_write(ok, ov, kr, vr, page, off, act.bool(), layer=layer)
    torch.cuda.synchronize()
    check(torch.equal(pk, wk) and torch.equal(pv, wv)
          and torch.equal(ok, wk) and torch.equal(ov, wv),
          f"paged_kv_write/{geom}/{dname}: not bit-exact")
    kern = lambda: paged_kv_write_cuda(pk, pv, kr, vr, page, off, act,
                                       layer=layer)
    plain = lambda: ref.ref_paged_kv_write(pk, pv, kr, vr, page, off, act,
                                           layer=layer)
    sel = act.bool()
    hs = torch.arange(kk, device=dev)
    rid = (((layer * kk + hs[None, :]) * nb + page[sel].long()[:, None])
           * BS + off[sel].long()[:, None]).reshape(-1)
    ksrc, vsrc = kr[sel].reshape(-1, d), vr[sel].reshape(-1, d)
    fk, fv = pk.view(-1, d), pv.view(-1, d)
    lib = lambda: (fk.index_copy_(0, rid, ksrc), fv.index_copy_(0, rid, vsrc))
    n_act = int(sel.sum())
    b_ms, b_by = bound(2 * 2 * n_act * kk * d * esize + (B + 2 * n_act) * 4,
                       0, dname)
    out[("paged_kv_write", "decode_rows")] = dict(
        phase="kernel", kernel="paged_kv_write", case=f"{geom}/decode_rows",
        dtype=dname, KV=kk, D=d, N=B, max_abs_err=0.0, tol=0.0,
        kernel_ms=time_ms(kern), plain_ms=time_ms(plain),
        library_ms=time_ms(lib), bound_ms=b_ms, bound_by=b_by,
        kernel_device_ms=device_ms(kern, "kv_write_kernel"),
        plain_device_ms=device_ms(plain), library_device_ms=device_ms(lib))
    emit(**out[("paged_kv_write", "decode_rows")])
    return out


def _flash_lse_case(torch, dtype, case, b, s, hh, kk, d, window,
                    tol=TOL):
    """``flash_attention_cuda(return_lse=True)`` against
    ``ref_attention_lse`` on one case: the output within ``tol`` (in
    bfloat16 of max(1, |plain|): each version rounds its output to
    bfloat16 once, and one unit in the last place is 0.03125 at |out| in
    [4, 8)), each row's logsumexp within ``FLASH_LSE_TOL``; emitted.
    Returns the output's max abs error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_impl)

    dname = str(dtype).split(".")[-1]
    gen = torch.Generator(device="cuda").manual_seed(s + hh + d + 1)
    q, k, v = (torch.randn(b, s, n, d, generator=gen,
                           device="cuda").to(dtype)
               for n in (hh, kk, kk))
    out, lse = flash_attention_cuda(q, k, v, window=window, return_lse=True)
    want, want_lse = ref.ref_attention_lse(q, k, v, window=window)
    torch.cuda.synchronize()
    tag = f"flash/{case}_lse/{dname}"
    check(bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
          and out.shape == want.shape and lse.shape == want_lse.shape
          and lse.dtype == torch.float32, f"{tag}: bad output")
    diff = (out.float() - want.float()).abs()
    err = diff.max().item()
    scaled = (err if dtype == torch.float32 else
              (diff / want.float().abs().clamp(min=1.0)).max().item())
    lse_err = (lse - want_lse).abs().max().item()
    emit(phase="kernel", kernel="flash_attention", case=f"{case}_lse",
         dtype=dname, impl=flash_impl(dtype, d, lse=True), B=b, S=s, H=hh,
         KV=kk, D=d, window=window, max_abs_err=err, scaled_err=scaled,
         tol=tol[dname], lse_err=lse_err, lse_tol=FLASH_LSE_TOL)
    check(scaled <= tol[dname] and lse_err <= FLASH_LSE_TOL,
          f"{tag}: out {err} (of max(1, |plain|): {scaled}), lse {lse_err}")
    return err


def d128_kernel_phase(torch):
    """Phase 36: ``flash_attention`` at head dim 128 (both dtypes)
    against its plain version at the batched prefill's shapes of
    qwen2.5-14b and codeqwen1.5-7b, a ragged S 37 and B 1 x S 2048 (all
    timed), S 1 and windowed cases, and with the logsumexp at four of
    them; the three paged kernels at both head geometries.  float32
    within 2e-5, bfloat16 within 2e-2, the logsumexp within 1e-5."""
    headline, worst = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for i, case in enumerate(D128_FLASH):
            err, rec = _flash_case(torch, dtype, *case,
                                   timed=i < D128_TIMED, tol=TOL)
            worst[dname] = max(worst.get(dname, 0.0), err)
            if case[0] == "q14b_prefill":
                headline[("flash_attention_d128", dname)] = rec
        for case in D128_LSE:
            worst[dname] = max(worst[dname],
                               _flash_lse_case(torch, dtype, *case))
        for geom, hh, kk in D128_GEOMS:
            _paged_heads(torch, dtype, geom, hh, kk)
    for dname, err in worst.items():
        headline[("flash_attention_d128", dname)] = dict(
            headline[("flash_attention_d128", dname)], max_abs_err=err)
    return headline


def _argmax_draws(torch, eng):
    """Greedy draws with each token's untempered log-prob: the argmax of
    the logits (sampling at temperature 1 with zero noise), so that
    ``log_beta`` is ``log_softmax(logits)`` at the token (at the
    launcher's floor temperature of 1e-6 it is float32 noise)."""
    from repro_torch.rollout.sampler import sample

    eng._sample = lambda logits: sample(
        logits, 1.0, 1.0, torch.zeros(logits.shape, device=logits.device))


def _untempered_log_beta(torch, eng):
    """The engine's own draws (the launcher's floor temperature 1e-6 and
    its Gumbel noise), each drawn token's ``log_beta`` replaced by its
    untempered ``log_softmax(logits)``: at the floor temperature the
    sampler's own ``log_beta`` is float32 noise of logits x 1e6, so this
    is what the first-token gate compares.  It adds one log-softmax and
    a gather to each sampling step."""
    draw = eng._sample

    def sample(logits):
        tok, _ = draw(logits)
        logp = torch.log_softmax(logits.float(), -1)
        return tok, torch.gather(logp, -1, tok[:, None].long())[:, 0]

    eng._sample = sample


def _top2_logprob_gap(torch, bundle, params, prompt, tokens):
    """The top-2 log-prob gap of the next token after ``prompt +
    tokens``, from a dense forward of the same weights."""
    row = torch.tensor(list(prompt) + list(tokens), device="cuda")[None]
    with torch.no_grad():
        logp = torch.log_softmax(
            bundle.forward(params, row).logits[0, -1].float(), -1)
    top = torch.topk(logp, 2).values
    return float(top[0] - top[1])


def _serve_record(torch, launcher, args, engine, batch):
    """Serve ``batch`` through ``engine`` as the launcher does (submit,
    run between device synchronisations, report), counting launches from
    zero.  Returns ``(trajectories by submission index, launches, stats,
    record)``."""
    from repro_torch import kernels
    from repro_torch.metrics import collect_serve_stats

    meta = launcher.submit_batch(args, engine, batch)
    kernels.reset_launch_counts()
    trajs, seconds = launcher.run(args, engine)
    launches = kernels.launch_counts()
    launcher.report(args, engine, trajs, seconds, meta)
    st = collect_serve_stats(engine)
    index = {rid: i for i, rid in enumerate(meta)}
    rec = dict(requests=len(trajs), tokens_out=st["tokens_out"],
               seconds=seconds, tokens_per_s=st["tokens_out"] / seconds,
               ttft_p50_ms=st["ttft_p50_ms"], ttft_p99_ms=st["ttft_p99_ms"],
               inter_token_p50_ms=st["inter_token_p50_ms"],
               decode_steps=st["decode_steps"], prefills=st["prefills"],
               prefill_dispatches=st["prefill_dispatches"],
               prefill_tokens=st["prefill_tokens"],
               preemptions=st["preemptions"], launches=launches)
    return {index[t.request_id]: t for t in trajs}, launches, st, rec


def _profiled_serve(torch, launcher, args, make_engine, batch,
                    require=None):
    """The idle share of the first wave of ``batch`` (``--max-batch``
    prompts, one engine's slots): its unprofiled wall on one fresh
    engine, then its device busy time under the profiler on another
    (the profiler's own cost, ~10x at this launch count, stays out of
    the wall).  ``require``: a kernel name the profile must hold."""
    wave = args.max_batch
    args = argparse.Namespace(**dict(vars(args), requests=wave))
    head = tuple(x[:wave] for x in batch)
    engine = make_engine()
    launcher.submit_batch(args, engine, head)
    _, wall_s = launcher.run(args, engine)
    engine = make_engine()
    launcher.submit_batch(args, engine, head)
    busy_ms, rows = profile_kernels(lambda: engine.run(max_steps=10_000))
    check(require is None or any(require in r[0] for r in rows),
          f"profiled serve: no {require} among {[r[0] for r in rows]}")
    return dict(profiled_requests=wave, profiled_wall_ms=wall_s * 1e3,
                device_busy_ms=busy_ms,
                idle_share=max(0.0, 1.0 - busy_ms / (wall_s * 1e3)),
                top_kernels=rows[:8])


def _same_greedy_tokens(torch, tag, got, want, prompts, gap):
    """Greedy tokens of each request of ``got`` equal to ``want``'s (``{rid:
    (tokens, first token's log-prob)}``; phase 37: another engine's,
    phase 41: the same run with the plain attention), but at a step where
    the top-2 log-prob gap after ``prompts[rid]`` and the tokens so far
    (``gap``) is under FIRST_TOKEN_TOL; the first tokens' log-probs within
    it.  Returns ``(near ties, first-token max abs error)``."""
    ties, first_err = [], 0.0
    check(sorted(got) == sorted(want), f"{tag}: requests differ")
    for rid, w in want.items():
        a, b = [int(x) for x in got[rid][0]], [int(x) for x in w[0]]
        n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if n is None:
            check(a == b, f"{tag}: request {rid} {a} against {b}")
        else:
            g = gap(prompts[rid], b[:n])
            ties.append(dict(request=rid, step=n, top2_gap=g))
            print(f"{tag}: request {rid} diverges at step {n}, top-2 "
                  f"log-prob gap {g}", flush=True)
            check(g < FIRST_TOKEN_TOL, f"{tag}: request {rid} diverges at "
                  f"step {n} away from a near tie (gap {g})")
        if n != 0:
            first_err = max(first_err, abs(float(got[rid][1])
                                           - float(w[1])))
    check(first_err <= FIRST_TOKEN_TOL,
          f"{tag}: first-token log-probs differ by {first_err}")
    return ties, first_err


def q14b_serve_phase(torch):
    """Phase 37: full-width qwen2.5-14b (48 layers, d 5120, 40 / 8 heads
    of 128, vocab 152064, seeded random init, float32) served with the
    launcher's defaults (8 prompts, 4 slots, 128 blocks of 8, greedy)
    through three continuous engines over one set of params: chunked
    prefill, batched prefill (``--no-chunked-prefill``) and unbatched
    (``--no-batch-prefill``); the batched engine's first wave again,
    for the idle share.  Greedy tokens equal, but where the
    chunked engine's top-2 log-prob gap at the step is under 1e-4; the
    first tokens' log-probs within 1e-4; ``flash_attention`` launched 48
    x the batched engines' prefill dispatches, and not by the chunked
    engine; then one 2,048-token prefill on the same weights
    (:func:`_q14b_long_prefill`)."""
    import warnings

    from repro_torch.data.tokenizer import get_tokenizer
    from repro_torch.launch import serve as launcher
    from repro_torch.utils.tree import tree_leaves

    parser = launcher.build_parser()
    base = parser.parse_args(Q14_ARGS)
    base.requests = base.batch
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    device, bundle, params, ds, store = launcher._model(base)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cfg = bundle.cfg
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab_size)
          == (48, 5120, 40, 8, 128, 13824, 152064),
          f"qwen2.5-14b serve is not full width: {cfg}")
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = ds.sample_batch(base.requests)
    runs, outs = {}, {}
    for label, flags in Q14_ENGINES:
        args = parser.parse_args(Q14_ARGS + flags)
        args.requests = args.batch
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            engine = launcher.make_engine(args, bundle, params, store, device)
        _untempered_log_beta(torch, engine)
        out, launches, st, rec = _serve_record(torch, launcher, args, engine,
                                               batch)
        check(len(out) == args.requests and not engine.has_work,
              f"q14b/{label}: {len(out)} of {args.requests} retired")
        check(engine.allocator.num_free == engine.allocator.num_blocks,
              f"q14b/{label}: pages leaked")
        for t in out.values():
            check(t.num_tokens > 0 and 0 <= t.tokens.min()
                  and t.tokens.max() < cfg.vocab_size
                  and bool(((t.log_beta <= 1e-6)
                            & (t.log_beta > -1e9)).all()),
                  f"q14b/{label}: request {t.request_id} tokens "
                  f"{t.tokens} log_beta {t.log_beta}")
        # Chunked prefill runs the varlen kernel and no flash; the
        # batched prefill flash once a layer a dispatch and no varlen.
        flash = launches["flash_attention"]
        varlen = launches["paged_attention_varlen"]
        for name in ("paged_kv_write", "paged_attention"):
            check(launches[name] > 0, f"q14b/{label}: {name} never launched")
        if label == "chunked":
            check(flash == 0 and varlen > 0,
                  f"q14b/chunked: flash {flash}, varlen {varlen} launches")
        else:
            check(flash == cfg.n_layers * st["prefill_dispatches"] > 0
                  and varlen == 0,
                  f"q14b/{label}: flash launched {flash} times for "
                  f"{st['prefill_dispatches']} prefill dispatches, varlen "
                  f"{varlen}")
        if label == "batched":
            def fresh(args=args):
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", DeprecationWarning)
                    e = launcher.make_engine(args, bundle, params, store,
                                             device)
                _untempered_log_beta(torch, e)
                return e

            rec.update(_profiled_serve(torch, launcher, args, fresh, batch))
        runs[label], outs[label] = rec, out
        del engine
    check(runs["unbatched"]["prefill_dispatches"] == base.requests
          and runs["batched"]["prefill_dispatches"] < base.requests,
          f"q14b: dispatches batched {runs['batched']['prefill_dispatches']}"
          f", unbatched {runs['unbatched']['prefill_dispatches']}")
    # Greedy tokens against the chunked engine's; the first tokens'
    # log-probs within FIRST_TOKEN_TOL.
    pad = get_tokenizer().pad_id
    prompts = {rid: row[row != pad] for rid, row in enumerate(batch[0])}
    gap = lambda prompt, tokens: _top2_logprob_gap(torch, bundle, params,
                                                   prompt, tokens)
    firsts = lambda out: {rid: (t.tokens, t.log_beta[0])
                          for rid, t in out.items()}
    ties, first_err = [], {}
    for label in ("batched", "unbatched"):
        found, first_err[label] = _same_greedy_tokens(
            torch, f"q14b/{label}", firsts(outs[label]),
            firsts(outs["chunked"]), prompts, gap)
        ties += [dict(tie, engine=label) for tie in found]
    tokens = [int(x) for t in outs["chunked"].values() for x in t.tokens]
    emit(phase="q14b_serve", config=cfg.name, layers=cfg.n_layers,
         params=n_params, params_gib=n_params * 4 / 2 ** 30, init_s=init_s,
         init_peak_gib=init_peak,
         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         distinct_tokens=len(set(tokens)), near_ties=ties,
         first_token_logprob_max_abs_err=first_err,
         first_token_tol=FIRST_TOKEN_TOL, runs=runs)
    _q14b_long_prefill(torch, launcher, parser, bundle, params, store,
                       device)
    launches = runs["batched"]["launches"]
    del params, bundle, store
    return launches


def _q14b_long_prefill(torch, launcher, parser, bundle, params, store,
                       device):
    """Phase 37's long prefill: one Q14_LONG-token prompt (ids from the
    seed) through a batched engine over the phase's weights, Q14_LONG_NEW
    new tokens, the launcher's greedy draws.  ``flash_attention`` launched
    exactly once a layer (the prefill is its only caller); the first
    token's untempered log-prob within FIRST_TOKEN_TOL of the same forward
    with the attention replaced, here only, by ``ref.ref_attention`` on
    the card; flash's device share of that forward and the run's peak
    memory recorded."""
    import warnings

    from repro_torch import kernels
    from repro_torch.kernels import ops, ref

    cfg = bundle.cfg
    n_tok = Q14_LONG + Q14_LONG_NEW
    args = parser.parse_args(Q14_ARGS + [
        "--no-chunked-prefill", "--max-batch", "1",
        "--num-blocks", str(-(-n_tok // 8) + 1), "--max-seq-len", str(n_tok)])
    gen = torch.Generator().manual_seed(args.seed + 37)
    prompt = torch.randint(3, cfg.vocab_size, (Q14_LONG,), generator=gen)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        engine = launcher.make_engine(args, bundle, params, store, device)
    _untempered_log_beta(torch, engine)
    engine.submit(prompt.numpy(), Q14_LONG_NEW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    trajs, seconds = launcher.run(args, engine)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(len(trajs) == 1 and not engine.has_work
          and trajs[0].num_tokens > 0,
          f"q14b/long: {len(trajs)} requests retired")
    check(launches["flash_attention"] == cfg.n_layers
          and launches["paged_attention_varlen"] == 0,
          f"q14b/long: flash launched {launches['flash_attention']} times "
          f"for one {Q14_LONG}-token prefill of {cfg.n_layers} layers")
    first = trajs[0]
    row = prompt.to(device)[None]
    saved = ops.attention
    ops.attention = (lambda q, k, v, *, window=None, causal=True,
                     kv_valid=None: ref.ref_attention(
                         q, k, v, causal=causal, window=window,
                         kv_valid=kv_valid))
    try:
        with torch.no_grad():
            logits = bundle.forward(params, row).logits[0, -1].float()
    finally:
        ops.attention = saved
    want = torch.log_softmax(logits, -1)[int(first.tokens[0])].item()
    err = abs(float(first.log_beta[0]) - want)
    del logits
    with torch.no_grad():
        busy, rows = profile_kernels(lambda: bundle.forward(params, row))
    flash_ms = sum(ms for name, ms, _ in rows if "flash_kernel" in name)
    emit(phase="q14b_long_prefill", prompt_tokens=Q14_LONG,
         new_tokens=first.num_tokens, seconds=seconds, launches=launches,
         first_token=int(first.tokens[0]),
         first_token_logprob=float(first.log_beta[0]),
         plain_attention_logprob=want, first_token_logprob_abs_err=err,
         first_token_tol=FIRST_TOKEN_TOL, forward_device_ms=busy,
         flash_device_ms=flash_ms, flash_share=flash_ms / busy,
         peak_gib=peak, top_kernels=rows[:6])
    check(err <= FIRST_TOKEN_TOL,
          f"q14b/long: first-token log-prob {first.log_beta[0]} against "
          f"{want} with the plain attention (|diff| {err})")
    del engine


def codeqwen_serve_phase(torch):
    """Phase 38: full-width codeqwen1.5-7b (32 layers, d 4096, 32 heads
    of 128, vocab 92416, seeded random init, float32) through the
    launcher's ``serve`` with ``--no-chunked-prefill``: every request
    retires, ``flash_attention`` launched 32 x the prefill dispatches."""
    import warnings

    from repro_torch import kernels
    from repro_torch.launch import serve as launcher
    from repro_torch.metrics import collect_serve_stats
    from repro_torch.utils.tree import tree_leaves

    args = launcher.build_parser().parse_args(CODEQWEN_ARGS)
    args.requests = args.batch
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        engine, trajs, seconds = launcher.serve(args)
    launches = kernels.launch_counts()
    cfg = engine.bundle.cfg
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, cfg.vocab_size) == (32, 4096, 32, 32, 128, 92416),
          f"codeqwen serve is not full width: {cfg}")
    st = collect_serve_stats(engine)
    check(len(trajs) == args.requests and not engine.has_work,
          f"codeqwen: {len(trajs)} of {args.requests} requests retired")
    for t in trajs:
        check(t.num_tokens > 0 and t.tokens.max() < cfg.vocab_size
              and bool(((t.log_beta <= 1e-6) & (t.log_beta > -1e9)).all()),
              f"codeqwen: request {t.request_id} tokens {t.tokens}")
    for name in ("paged_kv_write", "paged_attention"):
        check(launches[name] > 0, f"codeqwen: {name} never launched")
    check(launches["flash_attention"]
          == cfg.n_layers * st["prefill_dispatches"] > 0
          and launches["paged_attention_varlen"] == 0,
          f"codeqwen: flash launched {launches['flash_attention']} times "
          f"for {st['prefill_dispatches']} prefill dispatches")
    emit(phase="codeqwen_serve", config=cfg.name, layers=cfg.n_layers,
         params=sum(t.numel() for t in tree_leaves(engine.params)),
         requests=len(trajs), tokens_out=st["tokens_out"], seconds=seconds,
         tokens_per_s=st["tokens_out"] / seconds,
         ttft_p50_ms=st["ttft_p50_ms"],
         inter_token_p50_ms=st["inter_token_p50_ms"],
         prefill_dispatches=st["prefill_dispatches"],
         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         launches=launches)


def batched_parity_phase(torch):
    """Phase 39: 2 layers of qwen2.5-14b's widths (40 / 8 heads of 128,
    d 5120, d_ff 13824; the math tokenizer's vocab of 53, so that the CPU
    side stays quick), dense weights x3, on ``cpu`` (plain path, the
    padding mask applied) and ``cuda`` (flash and paged kernels): the
    prefill ``forward`` with a right-padding mask (logits at each
    prompt's last row within 1e-4, K/V rows below it within 1e-5 of
    their largest magnitude; a mask that is not a prefix raises on the
    card), then the batched-prefill engine greedy (``batch_prefill``;
    the argmax with untempered log-probs) and sampled on the same
    injected noise (without it): equal tokens and prefill counts,
    log_beta within 1e-4, pools within 1e-5 of their largest
    magnitude."""
    import warnings

    from repro_torch.configs import get_config
    from repro_torch.data.tokenizer import get_tokenizer
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import build
    from repro_torch.serve import ServeEngine

    cfg = get_config("qwen2.5-14b").replace(
        n_layers=2, vocab_size=get_tokenizer().vocab_size)
    bundle = build(cfg)
    params = _scale_dense(bundle.init(torch.Generator().manual_seed(0)))
    card = tf.tree_to(params, "cuda")
    prompts = _prompts(4)
    plens = [len(p) for p in prompts]
    pad = -(-max(plens) // BS) * BS
    rows = torch.zeros((4, pad), dtype=torch.int32)
    valid = torch.zeros((4, pad), dtype=torch.bool)
    for i, p in enumerate(prompts):
        rows[i, :len(p)] = torch.as_tensor(p)
        valid[i, :len(p)] = True
    with torch.no_grad():
        want = bundle.forward(params, rows, kv_valid=valid,
                              return_cache=True, cache_len=pad)
        got = bundle.forward(card, rows.cuda(), kv_valid=valid.cuda(),
                             return_cache=True, cache_len=pad)
    idx = torch.tensor(plens) - 1
    g, w = got.logits.cpu()[torch.arange(4), idx], want.logits[
        torch.arange(4), idx]
    check(bool(torch.isfinite(g).all())
          and torch.allclose(g, w, rtol=1e-4, atol=1e-4),
          f"batched parity: prefill logits differ by "
          f"{(g - w).abs().max().item()}")
    rec = dict(phase="batched_parity", config=cfg.name, layers=cfg.n_layers,
               heads=(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
               forward_logits_max_abs_err=(g - w).abs().max().item())
    live = valid[None, :, :, None, None]
    for key in ("k", "v"):
        gk = got.cache[key].cpu().masked_fill(~live, 0)
        wk = want.cache[key].masked_fill(~live, 0)
        rec[f"forward_{key}_max_abs_err"] = _scaled_err(
            gk, wk, 1e-5, f"prefill cache {key}")
    holes = valid.clone().cuda()
    holes[0, 1] = False
    try:
        with torch.no_grad():
            bundle.forward(card, rows.cuda(), kv_valid=holes)
        raised = False
    except ValueError:
        raised = True
    check(raised, "batched parity: a kv_valid with a hole did not raise "
          "on the card")
    kw = dict(num_blocks=128, block_size=BS, max_batch=4, decode_chunk=4,
              seed=2, chunked_prefill=False)
    for mode, batched in (("greedy", True), ("sampled", False)):
        out, engines = {}, {}
        for dev in ("cpu", "cuda"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                eng = ServeEngine(bundle, params if dev == "cpu" else card,
                                  temperature=1.0, device=dev,
                                  batch_prefill=batched, **kw)
            if mode == "greedy":
                _argmax_draws(torch, eng)
            else:
                _injected_noise(torch, eng)
            for i, (p, n) in enumerate(zip(prompts, (4, 8, 16, 8))):
                eng.submit(p, n, request_id=i)
            out[dev] = {t.request_id: t for t in eng.run(max_steps=1000)}
            engines[dev] = eng
        check(sorted(out["cpu"]) == sorted(out["cuda"]) == [0, 1, 2, 3],
              f"batched parity/{mode}: not every request retired")
        worst = 0.0
        for rid, w in out["cpu"].items():
            c = out["cuda"][rid]
            check(c.tokens.tolist() == w.tokens.tolist(),
                  f"batched parity/{mode}: request {rid} cuda {c.tokens} "
                  f"cpu {w.tokens}")
            worst = max(worst, float(abs(c.log_beta - w.log_beta).max()))
        check(worst <= 1e-4, f"batched parity/{mode}: log_beta differs by "
              f"{worst}")
        counts = [(e.stats.prefills, e.stats.prefill_dispatches,
                   e.stats.prefill_tokens) for e in engines.values()]
        check(counts[0] == counts[1], f"batched parity/{mode}: prefill "
              f"counts cpu / cuda {counts}")
        pool_err = {k: _scaled_err(engines["cuda"].pages[k].cpu(),
                                   engines["cpu"].pages[k], 1e-5,
                                   f"{mode} {k}")
                    for k in ("k_pages", "v_pages")}
        distinct = len({int(x) for t in out["cpu"].values()
                        for x in t.tokens})
        if mode == "greedy":
            check(distinct > 5, f"batched parity/greedy: only {distinct} "
                  "distinct tokens")
        else:
            check(min(float(t.log_beta.min()) for t in out["cpu"].values())
                  < -0.1, "batched parity/sampled: every draw was the "
                  "argmax")
        rec[mode] = dict(batch_prefill=batched, distinct_tokens=distinct,
                         prefills_dispatches_tokens=counts[0],
                         log_beta_max_abs_err=worst, tol=1e-4,
                         pool_max_abs_err=pool_err)
    emit(**rec)


# ---------------------------------------------------------------------------
# Phases 40-42: head dim 256 (gemma3-12b at full width)
# ---------------------------------------------------------------------------

D256_FLASH = (  # (case, B, S, H, KV, D, window); the first three timed
    ("g3_prefill", 8, 32, 16, 8, 256, None),      # the batched prefill
    ("g3_long", 1, 2048, 16, 8, 256, None),       # a global layer
    ("g3_long_window", 1, 2048, 16, 8, 256, 1024),   # a local layer
    ("edge_s1", 2, 1, 16, 8, 256, None),
    ("g3_ragged", 2, 37, 16, 8, 256, None),
    ("g3_window", 2, 300, 16, 8, 256, 64),
    ("group4_s65w", 2, 65, 4, 1, 256, 16))
D256_TIMED = 3
D256_LSE = (D256_FLASH[0], D256_FLASH[2], D256_FLASH[4])
# Phase 40's paged cases (as D128_PAGED): the decode contexts, decode
# and a varlen round past gemma3's window of 1024 (decode also at B 1 and
# at contexts 0, 1 and the table's 2,080), a varlen round of T 16, and
# phase 41's long chunk of 64 rows; tables of 260 pages of 8 rows
# (contexts up to 2,080).
D256_PAGED = (
    ("decode", None, [45, 17, 64, 33], None, True),
    ("decode_long_window", None, [1100, 1500, 2050, 1025], 1024, True),
    # Phase 41's long prompt decoding at B 1: a global and a local layer.
    ("decode_b1_global", None, [2064], None, True),
    ("decode_b1_window", None, [2064], 1024, True),
    ("decode_edges", None, [0, 1, 2080, 49], 1024, False),
    ("varlen_t16", [40, 16, 0, 9], [1, 16, 7, 0], None, True),
    ("varlen_long_window", [1030, 1084, 0, 1020], [16, 16, 7, 10], 1024,
     False),
    # Phase 41's last chunked round of the long prompt (64 rows of slot 0
    # at 1,984, three idle slots): a global and a local layer.
    ("varlen_chunk_global", [1984, 0, 0, 0], [64, 0, 0, 0], None, True),
    ("varlen_chunk_window", [1984, 0, 0, 0], [64, 0, 0, 0], 1024, True))
D256_M = 260
D256_NB = B * D256_M + 1
G3_ARGS = ["--engine", "continuous", "--arch", "gemma3-12b", "--full-width",
           "--device", "cuda", "--temperature", "0"]
# Phase 41's long prompt: decode past position 1,024 (every local layer's
# window then masks keys).
G3_LONG, G3_LONG_NEW = 2048, 16
# Chunked and batched; the chunked run takes 64-row tiles, 32 rounds
# rather than the default's 128 (cut for time: each round is host-bound).
G3_LONG_ENGINES = (("chunked", ["--prefill-chunk", "64",
                                "--dispatch-budget", "64"]),
                   Q14_ENGINES[1])


def d256_kernel_phase(torch):
    """Phase 40: ``flash_attention`` at head dim 256 (float32
    ``flash_kernel_d256``, bfloat16 ``flash_kernel_wgmma256``) against its
    plain version at gemma3-12b's batched prefill (B 8 x S 32, 16 / 8
    heads) and at B 1 x S 2048 global and windowed (all timed), S 1,
    ragged and windowed cases, and with the logsumexp at three of them;
    the three paged kernels at 16 / 8 heads of 256 (the split decode at
    contexts 45/17/64/33, past a window of 1024, at B 1 over 2,064 keys
    global and windowed, and at contexts 0 / 1 / 2,080, each called twice
    for the same bits; varlen T 16 near and past the window and phase
    41's last chunked round of the long prompt, global and windowed, each
    called twice for the same bits; the K/V row write).  float32 within
    2e-5, bfloat16 within 2e-2 (paged: of max(1, |plain|)), the
    logsumexp within 1e-5."""
    headline, worst = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for i, case in enumerate(D256_FLASH):
            err, rec = _flash_case(torch, dtype, *case,
                                   timed=i < D256_TIMED, tol=TOL)
            worst[("flash_attention_d256", dname)] = max(
                worst.get(("flash_attention_d256", dname), 0.0), err)
            if case[0] == "g3_prefill":
                headline[("flash_attention_d256", dname)] = rec
        for case in D256_LSE:
            key = ("flash_attention_d256", dname)
            worst[key] = max(worst[key], _flash_lse_case(torch, dtype, *case))
        recs = _paged_heads(torch, dtype, "gemma3-12b", 16, 8, d=256,
                           cases=D256_PAGED, nb=D256_NB, m=D256_M,
                           relative=True)
        for name, case, entry in (
                ("paged_attention", "decode", "paged_attention_d256"),
                ("paged_attention_varlen", "varlen_t16",
                 "paged_attention_varlen_d256"),
                ("paged_attention_varlen", "varlen_chunk_window",
                 "paged_attention_varlen_d256_chunk")):
            key = (entry, dname)
            headline[key] = recs[(name, case)]
            worst[key] = max(r["max_abs_err"] for (n, _), r in recs.items()
                             if n == name)
    for key, err in worst.items():
        headline[key] = dict(headline[key], max_abs_err=err)
    return headline


@contextlib.contextmanager
def _plain_attention():
    """Within the block every attention and K/V row write of the model
    runs its plain version (``kernels.ref``) on whatever device the
    tensors are on: ``ops``' names are rebound, so an engine run can be
    held to the same run without the kernels."""
    from repro_torch.kernels import ops, ref

    names = ("attention", "paged_attention", "paged_attention_varlen",
             "paged_kv_write")
    saved = {n: getattr(ops, n) for n in names}
    ops.attention = (lambda q, k, v, *, window=None, causal=True,
                     kv_valid=None: ref.ref_attention(
                         q, k, v, causal=causal, window=window,
                         kv_valid=kv_valid))
    ops.paged_attention = (lambda q, kp, vp, tables, lens, *, window=None:
                           ref.ref_paged_attention(q, kp, vp, tables, lens,
                                                   window=window))
    ops.paged_attention_varlen = (
        lambda q, kp, vp, tables, start, n, *, window=None, count=None:
        ref.ref_paged_attention_varlen(q, kp, vp, tables, start, n,
                                       window=window))
    ops.paged_kv_write = (
        lambda kp, vp, kr, vr, page, off, active, *, layer:
        ref.ref_paged_kv_write(kp, vp, kr, vr, page, off, active,
                               layer=layer))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def _argmax_sampler(torch):
    """The static engine's draws as :func:`_argmax_draws` makes the
    continuous engine's: ``sampler.sample`` at temperature 1 with zero
    noise inside the block (the argmax, with untempered log-probs)."""
    from repro_torch.rollout import sampler

    draw = sampler.sample
    sampler.sample = lambda logits, temperature, top_p, noise: draw(
        logits, 1.0, 1.0, torch.zeros_like(noise))
    return lambda: setattr(sampler, "sample", draw)


def gemma3_serve_phase(torch):
    """Phase 41: full-width gemma3-12b (48 layers, d 3840, 16 / 8 heads
    of 256, d_ff 15360, vocab 262144, tied, softcap 30, window 1024 on
    five layers of six, seeded random init, float32) with the launcher's
    defaults (8 prompts, 4 slots, 128 blocks of 8, 16 tokens, greedy)
    through the chunked, batched and unbatched continuous engines and
    the static engine over one set of params; then one 2,048-token
    prompt through the chunked and the batched engines (16 new tokens,
    every one past position 1,024).  Each run is held to the same run
    with the plain attention on the card (:func:`_same_greedy_tokens`);
    ``flash_attention`` 48 x each batched prefill dispatch (48 a static
    ``generate``), the varlen kernel only in chunked runs, decode and
    the K/V write in every continuous run; tokens/s, peak memory, the
    batched engine's idle share.  Returns the kernels' launches summed
    over the runs with the kernels."""
    import warnings
    from collections import Counter

    from repro_torch import kernels
    from repro_torch.data.tokenizer import get_tokenizer
    from repro_torch.launch import serve as launcher
    from repro_torch.rollout.sampler import generate
    from repro_torch.utils.tree import tree_leaves

    parser = launcher.build_parser()
    base = parser.parse_args(G3_ARGS)
    base.requests = base.batch
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    device, bundle, params, ds, store = launcher._model(base)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = bundle.cfg
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.logit_softcap,
           cfg.sliding_window, cfg.global_every)
          == (48, 3840, 16, 8, 256, 15360, 262144, 30.0, 1024, 6),
          f"gemma3-12b serve is not full width: {cfg}")
    n_params = sum(t.numel() for t in tree_leaves(params))
    pad = get_tokenizer().pad_id
    batch = ds.sample_batch(base.requests)
    prompts = [row[row != pad] for row in batch[0]]
    total = Counter()

    def engine_of(args):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            eng = launcher.make_engine(args, bundle, params, store, device)
        _untempered_log_beta(torch, eng)
        return eng

    def gap(prompt, tokens):
        return _top2_logprob_gap(torch, bundle, params, prompt, tokens)

    runs = {}
    for label, flags in Q14_ENGINES:
        args = parser.parse_args(G3_ARGS + flags)
        args.requests = args.batch
        out, launches, st, rec = _serve_record(torch, launcher, args,
                                               engine_of(args), batch)
        total.update(launches)
        with _plain_attention():
            want, _, _, _ = _serve_record(torch, launcher, args,
                                          engine_of(args), batch)
        check(len(out) == args.requests,
              f"gemma3/{label}: {len(out)} of {args.requests} retired")
        flash = launches["flash_attention"]
        varlen = launches["paged_attention_varlen"]
        for name in ("paged_kv_write", "paged_attention"):
            check(launches[name] > 0, f"gemma3/{label}: {name} never "
                  "launched")
        if label == "chunked":
            check(flash == 0 and varlen > 0,
                  f"gemma3/chunked: flash {flash}, varlen {varlen} launches")
        else:
            check(flash == cfg.n_layers * st["prefill_dispatches"] > 0
                  and varlen == 0,
                  f"gemma3/{label}: flash launched {flash} times for "
                  f"{st['prefill_dispatches']} prefill dispatches, varlen "
                  f"{varlen}")
        rec["near_ties"], rec["first_token_logprob_max_abs_err"] = \
            _same_greedy_tokens(torch, f"gemma3/{label}",
                           {i: (t.tokens, t.log_beta[0])
                            for i, t in out.items()},
                           {i: (t.tokens, t.log_beta[0])
                            for i, t in want.items()}, prompts, gap)
        if label == "batched":
            rec.update(_profiled_serve(torch, launcher, args,
                                       lambda a=args: engine_of(a), batch,
                                       require=_paged_symbol(cfg.head_dim)))
        runs[label] = rec

    # The static engine: one generate over the same prompts, left-padded.
    args = parser.parse_args(G3_ARGS + ["--engine", "static"])
    rows = torch.from_numpy(batch[0]).to(device)

    def static_run():
        static = launcher.StaticServe(
            device, bundle, params, rows, batch[2],
            lambda: generate(
                bundle, params, rows,
                torch.Generator(device=device).manual_seed(args.seed + 2),
                max_new_tokens=args.max_new_tokens,
                temperature=args.temperature, top_p=args.top_p))
        restore = _argmax_sampler(torch)
        try:
            kernels.reset_launch_counts()
            res, dt = launcher.run_static(static)
            launches = kernels.launch_counts()
        finally:
            restore()
        return static, res, dt, launches

    static, res, dt, launches = static_run()
    launcher.report_static(static, res, dt)
    total.update(launches)
    with _plain_attention():
        _, plain_res, _, _ = static_run()
    check(launches["flash_attention"] == cfg.n_layers
          and sum(launches.values()) == cfg.n_layers,
          f"gemma3/static: launches {launches}")
    # The static engine reads the left-padded rows, pads included.
    n = len(prompts)
    ties, first = _same_greedy_tokens(
        torch, "gemma3/static",
        {i: (res.completion[i], res.log_beta[i, 0]) for i in range(n)},
        {i: (plain_res.completion[i], plain_res.log_beta[i, 0])
         for i in range(n)}, dict(enumerate(batch[0])), gap)
    runs["static"] = dict(tokens_out=res.completion.numel(), seconds=dt,
                          tokens_per_s=res.completion.numel() / dt,
                          launches=launches, near_ties=ties,
                          first_token_logprob_max_abs_err=first)
    del static, res, plain_res
    emit(phase="gemma3_serve", config=cfg.name, layers=cfg.n_layers,
         params=n_params, params_gib=n_params * 4 / 2 ** 30, init_s=init_s,
         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         first_token_tol=FIRST_TOKEN_TOL, runs=runs)
    total.update(_gemma3_long_prompt(torch, launcher, parser, bundle, params,
                                     store, device, gap))
    del params, bundle, store
    return dict(total)


def _gemma3_long_prompt(torch, launcher, parser, bundle, params, store,
                        device, gap):
    """Phase 41's long prompt: G3_LONG ids from the seed through a chunked
    and a batched engine (one slot, a pool for the whole sequence),
    G3_LONG_NEW new tokens, each run held to the same run with the plain
    attention on the card.  The chunked run launches the varlen kernel
    and no flash, the batched run flash exactly once a layer and no
    varlen, both the decode kernel and the K/V write; the batched
    prefill's forward profiled (flash's device share); the decode ms a
    token after the first (request latency less TTFT) of each run with
    the kernels, and one batched decode round profiled
    (:func:`_gemma3_decode_round`).  Returns the launches of the runs with
    the kernels."""
    import warnings
    from collections import Counter

    from repro_torch import kernels
    from repro_torch.metrics.runtime_metrics import collect_serve_stats

    cfg = bundle.cfg
    n_tok = G3_LONG + G3_LONG_NEW
    gen = torch.Generator().manual_seed(41)
    prompt = torch.randint(3, cfg.vocab_size, (G3_LONG,), generator=gen)
    total, rec = Counter(), dict(phase="gemma3_long_prompt",
                                 prompt_tokens=G3_LONG,
                                 new_tokens=G3_LONG_NEW)
    for label, flags in G3_LONG_ENGINES:
        args = parser.parse_args(G3_ARGS + flags + [
            "--max-batch", "1", "--num-blocks", str(-(-n_tok // 8) + 1),
            "--max-seq-len", str(n_tok)])
        outs = []
        for plain in (False, True):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                engine = launcher.make_engine(args, bundle, params, store,
                                              device)
            _untempered_log_beta(torch, engine)
            engine.submit(prompt.numpy(), G3_LONG_NEW)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            if plain:
                with _plain_attention():
                    trajs, seconds = launcher.run(args, engine)
            else:
                trajs, seconds = launcher.run(args, engine)
                launches = kernels.launch_counts()
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                lat = collect_serve_stats(engine)
            check(len(trajs) == 1 and trajs[0].num_tokens == G3_LONG_NEW,
                  f"gemma3/long/{label}: {[t.num_tokens for t in trajs]}")
            outs.append(trajs[0])
            del engine
        total.update(launches)
        flash = launches["flash_attention"]
        varlen = launches["paged_attention_varlen"]
        check(launches["paged_attention"] > 0
              and launches["paged_kv_write"] > 0
              and (flash == 0 and varlen > 0 if label == "chunked"
                   else flash == cfg.n_layers and varlen == 0),
              f"gemma3/long/{label}: launches {launches}")
        ties, first = _same_greedy_tokens(
            torch, f"gemma3/long/{label}",
            {0: (outs[0].tokens, outs[0].log_beta[0])},
            {0: (outs[1].tokens, outs[1].log_beta[0])},
            {0: prompt.tolist()}, gap)
        rec[label] = dict(seconds=seconds, launches=launches, peak_gib=peak,
                          ttft_ms=lat["ttft_mean_ms"],
                          decode_ms_per_token=(
                              lat["request_latency_mean_ms"]
                              - lat["ttft_mean_ms"]) / (G3_LONG_NEW - 1),
                          first_token=int(outs[0].tokens[0]),
                          first_token_logprob=float(outs[0].log_beta[0]),
                          plain_attention_logprob=float(outs[1].log_beta[0]),
                          first_token_logprob_abs_err=first, near_ties=ties)
        if label == "batched":
            rec[label].update(_gemma3_decode_round(
                torch, launcher, args, bundle, params, store, device, prompt,
                require=_paged_symbol(cfg.head_dim)))
    row = prompt.to(device)[None]
    with torch.no_grad():
        busy, rows = profile_kernels(lambda: bundle.forward(params, row))
    flash_ms = sum(ms for name, ms, _ in rows if "flash_kernel" in name)
    rec.update(forward_device_ms=busy, flash_device_ms=flash_ms,
               flash_share=flash_ms / busy, top_kernels=rows[:6])
    emit(**rec)
    return total


def _gemma3_decode_round(torch, launcher, args, bundle, params, store,
                         device, prompt, require=None):
    """One decode round of the long prompt past position 2,048 (every
    local layer's window masks keys), profiled on a fresh engine once a
    round has decoded: its device ms a decode step and the decode
    kernel's share (``require``: a name that kernel must have)."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        engine = launcher.make_engine(args, bundle, params, store, device)
    engine.submit(prompt.numpy(), G3_LONG_NEW)
    while engine.stats.decode_steps == 0:
        engine.step()
    before = engine.stats.decode_steps
    busy, rows = profile_kernels(engine.step)
    steps = engine.stats.decode_steps - before
    paged = sum(ms for name, ms, _ in rows if "paged_attention" in name
                and "varlen" not in name and (require or "") in name)
    check(steps > 0 and paged > 0,
          f"gemma3/long/decode round: {steps} steps, decode kernel "
          f"{require} {paged} ms in {rows[:8]}")
    engine.run(max_steps=10_000)
    return dict(decode_round_steps=steps,
                decode_step_device_ms=busy / steps,
                decode_paged_attention_ms=paged / steps,
                decode_paged_attention_share=paged / busy,
                decode_top_kernels=rows[:6])


def gemma3_parity_phase(torch):
    """Phase 42: the reduced gemma3-12b (2 layers, d 256, 2 / 1 heads,
    window 16 with every second layer global, softcap 30; the math
    tokenizer's vocab) at head dim 256, dense weights x3, on ``cpu``
    (plain versions) and ``cuda`` (the kernels): four 32-token prompts
    and 16 new tokens (past the window) through the chunked and the
    batched engines (the argmax, with untempered log-probs) and the
    static ``generate`` (greedy, no noise): equal tokens, log_beta
    within 1e-4."""
    import warnings

    from repro_torch.configs import reduced_config
    from repro_torch.data.tokenizer import get_tokenizer
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import build
    from repro_torch.rollout.sampler import generate
    from repro_torch.serve import ServeEngine

    vocab = get_tokenizer().vocab_size
    cfg = reduced_config("gemma3-12b", vocab=vocab).replace(d_head=256)
    bundle = build(cfg)
    params = _scale_dense(bundle.init(torch.Generator().manual_seed(0)))
    card = tf.tree_to(params, "cuda")
    prompts = torch.randint(3, vocab, (4, 32),
                            generator=torch.Generator().manual_seed(42))
    rec = dict(phase="gemma3_parity", config=cfg.name, layers=cfg.n_layers,
               heads=(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
               window=cfg.sliding_window)
    for mode in ("chunked", "batched"):
        out = {}
        for dev, p in (("cpu", params), ("cuda", card)):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                eng = ServeEngine(bundle, p, temperature=1.0, device=dev,
                                  num_blocks=48, block_size=8, max_batch=4,
                                  decode_chunk=4, seed=2,
                                  chunked_prefill=mode == "chunked")
            _argmax_draws(torch, eng)
            for i in range(4):
                eng.submit(prompts[i].numpy(), 16, request_id=i)
            out[dev] = {t.request_id: t for t in eng.run(max_steps=1000)}
        check(sorted(out["cpu"]) == sorted(out["cuda"]) == [0, 1, 2, 3],
              f"gemma3 parity/{mode}: not every request retired")
        worst = 0.0
        for rid, w in out["cpu"].items():
            c = out["cuda"][rid]
            check(c.tokens.tolist() == w.tokens.tolist(),
                  f"gemma3 parity/{mode}: request {rid} cuda {c.tokens} "
                  f"cpu {w.tokens}")
            worst = max(worst, float(abs(c.log_beta - w.log_beta).max()))
        check(worst <= 1e-4, f"gemma3 parity/{mode}: log_beta differs by "
              f"{worst}")
        rec[mode] = dict(log_beta_max_abs_err=worst, distinct_tokens=len(
            {int(x) for t in out["cpu"].values() for x in t.tokens}))
    res = {}
    for dev, p in (("cpu", params), ("cuda", card)):
        res[dev] = generate(bundle, p, prompts.to(dev), max_new_tokens=16,
                            temperature=0.0,
                            noise=lambda t, shape: torch.zeros(shape))
    check(torch.equal(res["cpu"].completion, res["cuda"].completion.cpu()),
          f"gemma3 parity/static: cuda {res['cuda'].completion} cpu "
          f"{res['cpu'].completion}")
    rec["static"] = dict(distinct_tokens=len(set(
        res["cpu"].completion.flatten().tolist())))
    check(min(r["distinct_tokens"] for r in (rec["chunked"], rec["batched"],
                                             rec["static"])) > 5,
          f"gemma3 parity: too few distinct tokens {rec}")
    emit(**rec)


KERNELS = (
    ("paged_kv_write", "src/repro_torch/kernels/csrc/paged_kv_write.cu",
     "src/repro/kernels/paged_kv_write_pallas.py:83"),
    ("paged_attention", "src/repro_torch/kernels/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention_pallas.py:128"),
    ("paged_attention_varlen",
     "src/repro_torch/kernels/csrc/paged_attention_varlen.cu",
     "src/repro/kernels/paged_attention_pallas.py:262"),
    # The fixed-T verify shape (a wrapper over kernel 3 in both packages):
    # its launches are the verify passes' (ops.paged_attention_multi).
    ("paged_attention_multi",
     "src/repro_torch/kernels/csrc/paged_attention_varlen.cu",
     "src/repro/kernels/paged_attention_pallas.py:327"),
    ("fused_logprob", "src/repro_torch/kernels/csrc/fused_logprob.cu",
     "src/repro/kernels/fused_logprob_pallas.py:92"),
    # The gradient jax.grad takes through the plain versions (the Pallas
    # kernel is forward-only).
    ("fused_logprob_bwd", "src/repro_torch/kernels/csrc/fused_logprob_bwd.cu",
     "src/repro/kernels/ref.py:284"),
    ("vtrace", "src/repro_torch/kernels/csrc/vtrace.cu",
     "src/repro/kernels/vtrace_pallas.py:81"),
    ("wkv6", "src/repro_torch/kernels/csrc/wkv6.cu",
     "src/repro/kernels/wkv6_pallas.py:97"),
    ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention_pallas.py:109"),
    # The same kernel's head-dim-128 instantiation: numbers at
    # qwen2.5-14b's batched-prefill shape, launches phase 37's.
    ("flash_attention_d128",
     "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention_pallas.py:109"),
    # The head-dim-256 instantiations (gemma3-12b): numbers phase 40's at
    # its batched-prefill shape, the decode contexts and the varlen T 16
    # round, launches phase 41's runs with the kernels together.
    ("paged_attention_d256", "src/repro_torch/kernels/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention_pallas.py:128"),
    ("paged_attention_varlen_d256",
     "src/repro_torch/kernels/csrc/paged_attention_varlen.cu",
     "src/repro/kernels/paged_attention_pallas.py:262"),
    # The same varlen kernel at the long prompt's windowed 64-row chunk
    # (its most launched shape in phase 41): its own bound; launches are
    # the kernel's, the same count as the line above.
    ("paged_attention_varlen_d256_chunk",
     "src/repro_torch/kernels/csrc/paged_attention_varlen.cu",
     "src/repro/kernels/paged_attention_pallas.py:262"),
    ("flash_attention_d256",
     "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention_pallas.py:109"),
    ("ssm_scan", "src/repro_torch/kernels/csrc/ssm_scan.cu",
     "src/repro/kernels/ssm_scan_pallas.py:73"),
    # The gradients jax.grad takes through the plain attention and scan
    # (the Pallas kernels are forward-only).
    ("flash_attention_bwd",
     "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
     "src/repro/models/attention.py:79"),
    ("ssm_scan_bwd", "src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
     "src/repro/models/ssm.py:50"),
    # The gradient jax.grad takes through the plain recurrence (the
    # Pallas kernel is forward-only).
    ("wkv6_bwd", "src/repro_torch/kernels/csrc/wkv6_bwd.cu",
     "src/repro/models/rwkv6.py:74"),
)


# ---------------------------------------------------------------------------
# Comparison mode: ``chip_smoke.py --ab SRC [d256|k256]`` measures the
# head-dim-256 flash forward, paged decode and varlen rounds, and
# gemma3-12b's long prompt's chunked prefill and decode round
# (``ab_d256``; ``d256`` stops there, ``k256`` runs flash and the varlen
# kernel alone), then
# ``paged_kv_write``,
# ``ssm_scan``, ``wkv6`` and ``vtrace`` as the model calls them, the
# ``flash_attention`` forward at the head-dim-128 serve prefills and B 1 x
# S 2048, at hymba's learner shape with the logsumexp and at its B 1 x
# S 2048 forward (``ab_flash_fwd``),
# ``flash_attention_bwd``, ``ssm_scan_bwd`` and ``wkv6_bwd`` at the
# learner shapes (``wkv6_bwd`` also at B 1 x S 2048), and the qwen,
# hymba and rwkv6 serve paths, with the port found under SRC
# (this tree's ``src`` or an unpacked parent commit's), through the entry
# points both trees share.  Run it for the parent and the change in turns
# on one card; it prints JSON lines only (``profile_serve``'s result also
# lands in build/ab_profile_serve.json).
# ---------------------------------------------------------------------------


# ``--ab``'s head-dim-256 cases (gemma3-12b's 16 / 8 heads): the paged
# decode at phase 40's short contexts, past the window at B 4 and at B 1
# over 2,064 keys global and windowed; the same decode at head dims 128
# and 64 (the row-tile routine, which the split leaves as it was).
AB_PAGED = (  # (case, H, KV, D, contexts, window)
    ("g3_decode", 16, 8, 256, [45, 17, 64, 33], None),
    ("g3_decode_long_window", 16, 8, 256, [1100, 1500, 2050, 1025], 1024),
    ("g3_decode_b1_global", 16, 8, 256, [2064], None),
    ("g3_decode_b1_window", 16, 8, 256, [2064], 1024),
    ("g3_decode_b2_window", 16, 8, 256, [2064, 1500], 1024),
    ("g3_decode_b8_window", 16, 8, 256, [1100, 1500, 2050, 1025] * 2, 1024),
    ("g3_decode_long", 16, 8, 256, [1100, 1500, 2050, 1025], None),
    ("q14b_decode", 40, 8, 128, [45, 17, 64, 33], None),
    ("codeqwen_decode_long", 32, 32, 128, [1100, 1500, 2050, 1025], None),
    ("qwen05_decode", 14, 2, 64, [45, 17, 64, 33], None))


# ``--ab``'s varlen cases: phase 40's T 16 round and phase 41's last
# chunked round of the long prompt (global and local) at gemma3's 16 / 8
# heads of 256, a speculative verify round (T 4) there, and T 16 rounds at
# head dims 128 and 64 (the row-tile routine, which the redesign leaves as
# it was); tables of 260 pages as phase 40's.
AB_VARLEN = (  # (case, H, KV, D, row_start, row_len, window)
    ("g3_varlen_t16", 16, 8, 256, [40, 16, 0, 9], [1, 16, 7, 0], None),
    ("g3_varlen_chunk_global", 16, 8, 256, [1984, 0, 0, 0], [64, 0, 0, 0],
     None),
    ("g3_varlen_chunk_window", 16, 8, 256, [1984, 0, 0, 0], [64, 0, 0, 0],
     1024),
    ("g3_verify_t4", 16, 8, 256, [2060, 700, 0, 44], [4, 4, 0, 4], None),
    ("q14b_varlen_t16", 40, 8, 128, [40, 16, 0, 9], [1, 16, 7, 0], None),
    ("qwen05_varlen_t16", 14, 2, 64, [40, 16, 0, 9], [1, 16, 7, 0], None))
AB_VARLEN_SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)
# ``--ab``'s mma.sync probe (``csrc/probe_mma_rate.cu``): its modes, and
# blocks of 8 warps an SM (1: the D-256 kernels' occupancy; 0: as many as
# fit).
AB_MMA_MODES = ("tf32", "3xtf32", "3xtf32_loop")
AB_MMA_BLOCKS = (1, 0)


def _ab_mma_rate(torch):
    """The rate of ``mma.sync.m16n8k8`` in float32 products on this card
    (``csrc/probe_mma_rate.cu``), one line a mode and occupancy: TFLOP/s
    at 2,048 flops a product, from CUDA events over 5 launches after one
    to build and warm."""
    import ctypes

    from repro_torch.kernels import build

    if not (build.CSRC / "probe_mma_rate.cu").exists():
        return
    fn = build.load("probe_mma_rate").probe_mma_rate_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    src = torch.randn(1024, device="cuda")
    iters = 4096
    for mode, name in enumerate(AB_MMA_MODES):
        for per_sm in AB_MMA_BLOCKS:
            active = ctypes.c_int(0)
            blocks = sms * max(per_sm, 1)

            def launch(blocks=blocks):
                out = torch.empty(blocks * 256, device="cuda")
                build.check(fn(src.data_ptr(), out.data_ptr(), mode, blocks,
                               iters, ctypes.byref(active),
                               torch.cuda.current_stream().cuda_stream),
                            "probe_mma_rate")
            launch()
            if per_sm == 0:
                blocks = sms * active.value
                launch(blocks)
            torch.cuda.synchronize()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(5):
                launch(blocks)
            b.record()
            torch.cuda.synchronize()
            ms = a.elapsed_time(b) / 5
            flops = blocks * 8 * iters * 32 * 2048
            emit(phase="ab_mma_rate", mode=name, blocks_per_sm=blocks // sms,
                 active_per_sm=active.value, warps_per_sm=8 * blocks // sms,
                 ms=ms, tflops=flops / ms / 1e9)


def ab_d256(torch, kernels_only=False):
    """``--ab``'s head-dim-256 lines: the ``mma.sync`` probe's rates
    (:func:`_ab_mma_rate`, on a tree that has the probe), flash's forward
    at phase 40's three timed shapes, the paged decode at ``AB_PAGED``
    and the varlen kernel at ``AB_VARLEN``, both dtypes, each beside
    SDPA's time (on gathered K/V for the paged kernels) and its bound; on
    a tree whose decode or varlen kernel splits the context, the split
    sweep of each head-dim-256 decode and long-chunk case
    (``_ab_paged_splits``, ``_ab_varlen_splits``); then full-width
    gemma3-12b on phase 41's long prompt: its chunked prefill and one
    decode round past position 2,048, each profiled
    (``_ab_gemma3_long``).  ``kernels_only`` (``--ab SRC k256``): flash
    and the varlen kernel alone, for many short alternating runs."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_impl)
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    dev = torch.device("cuda")
    if not kernels_only:
        _ab_mma_rate(torch)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        esize = torch.empty((), dtype=dtype).element_size()
        for case, bb, s, hh, kk, d, window in D256_FLASH[:D256_TIMED]:
            gen = torch.Generator(device="cuda").manual_seed(s + hh + d)
            q, k, v = (torch.randn(bb, s, n, d, generator=gen,
                                   device="cuda").to(dtype)
                       for n in (hh, kk, kk))
            kern = lambda: flash_attention_cuda(q, k, v, window=window)
            lib = _sdpa_fwd(torch, q, k, v, window)
            impl = flash_impl(dtype, d)
            b_ms, b_by = bound(
                (2 * bb * s * hh * d + 2 * bb * s * kk * d) * esize,
                4 * d * hh * bb * _attended_pairs(s, window),
                _flash_rate(impl, dname))
            emit(phase="ab_flash_fwd", case=case, dtype=dname, impl=impl,
                 B=bb, S=s, H=hh, KV=kk, D=d, window=window, bound_ms=b_ms,
                 bound_by=b_by, ms=time_ms(kern, iters=50),
                 device_ms=device_ms(kern, "flash_kernel"),
                 library_ms=time_ms(lib, iters=50),
                 library_device_ms=device_ms(lib, iters=5))
            del lib
        for case, hh, kk, d, lens, window in ([] if kernels_only
                                              else AB_PAGED):
            gen = torch.Generator().manual_seed(hh * 100 + kk + d)
            m = -(-max(lens) // BS)
            nb = len(lens) * m + 1
            kp, vp = (torch.randn(kk, nb, BS, d, generator=gen).to(dtype)
                      .to(dev) for _ in range(2))
            tables = _tables(gen, lens, torch, nb, m).to(dev)
            q = torch.randn(len(lens), hh, d, generator=gen).to(dtype).to(dev)
            ctx = torch.tensor(lens, dtype=torch.int32, device=dev)
            kern = lambda: paged_attention_cuda(q, kp, vp, tables, ctx,
                                                window=window)
            got, want = kern(), ref.ref_paged_attention(q, kp, vp, tables,
                                                        ctx, window=window)
            keys, vals = (ref._gather_pages(x, tables).repeat_interleave(
                hh // kk, 0).transpose(0, 1) for x in (kp, vp))
            kpos = torch.arange(m * BS, device=dev)
            qpos = ctx[:, None] - 1
            mask = kpos[None, :] <= qpos
            if window is not None:
                mask &= qpos - kpos[None, :] < window
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], keys, vals, attn_mask=mask[:, None, None])
            b_ms, b_by = _attention_bound(
                q, [(c - 1, 1) for c in lens], lens, window, 1, esize, dname,
                hh, kk, d)
            err = (got.float() - want.float()).abs().max().item()
            emit(phase="ab_paged_decode", case=case, dtype=dname, H=hh,
                 KV=kk, D=d, contexts=lens, window=window, max_abs_err=err,
                 bound_ms=b_ms, bound_by=b_by, ms=time_ms(kern, iters=100),
                 device_ms=device_ms(kern, "paged_attention"),
                 library_ms=time_ms(lib, iters=50),
                 library_device_ms=device_ms(lib, iters=5))
            if d > 128 and hasattr(pa, "plan_splits"):
                _ab_paged_splits(torch, pa, kern, case, dname, lens, window)
            del kp, vp, keys, vals, lib
        for case, hh, kk, d, starts, lens, window in AB_VARLEN:
            _ab_varlen(torch, dtype, case, hh, kk, d, starts, lens, window,
                       sweep=not kernels_only)
    torch.cuda.empty_cache()
    if not kernels_only:
        _ab_gemma3_long(torch)


def _host_ms(fn, iters: int = 200, repeats: int = 7) -> float:
    """Host time a call: the least, over ``repeats``, of the wall time of
    ``iters`` calls issued back to back, divided by ``iters`` (the card
    keeps up when its time a call is the smaller; the least reading is
    the one a busy shared host disturbed least)."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, (time.perf_counter() - t0) * 1e3 / iters)
        torch.cuda.synchronize()
    return best


def _ab_varlen(torch, dtype, case, hh, kk, d, starts, lens, window,
               sweep=True):
    """One ``AB_VARLEN`` case: the varlen kernel against its plain version,
    its events and profiler times (the kernels named ``varlen``: the
    call's one launch), the wrapper's host time a call
    (:func:`_host_ms`), SDPA's on gathered K/V and the bound; with
    ``sweep``, on a tree that splits the varlen rows, the split sweep of
    the long chunks."""
    from repro_torch.kernels import paged_attention_varlen as pav
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    dname = str(dtype).split(".")[-1]
    esize = torch.empty((), dtype=dtype).element_size()
    gen = torch.Generator().manual_seed(hh * 100 + kk + d + 7)
    m = D256_M
    nb = len(lens) * m + 1
    kp, vp = (torch.randn(kk, nb, BS, d, generator=gen).to(dtype).to(dev)
              for _ in range(2))
    ctx = [a + n for a, n in zip(starts, lens)]
    tables = _tables(gen, [max(c, 1) for c in ctx], torch, nb, m).to(dev)
    t = max(lens)
    q = torch.randn(len(lens), t, hh, d, generator=gen).to(dtype).to(dev)
    args = (q, kp, vp, tables,
            torch.tensor(starts, dtype=torch.int32, device=dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))
    kern = lambda: pav.paged_attention_varlen_cuda(*args, window=window)
    got = kern()
    want = ref.ref_paged_attention_varlen(*args, window=window)
    diff = (got.float() - want.float()).abs()
    if dtype != torch.float32:
        diff = diff / want.float().abs().clamp(min=1.0)
    keys, vals = (ref._gather_pages(x, tables).repeat_interleave(
        hh // kk, 0).transpose(0, 1) for x in (kp, vp))
    qpos = torch.tensor([[a + i for i in range(t)] for a in starts],
                        device=dev)
    kpos = torch.arange(m * BS, device=dev)[None, None, :]
    mask = kpos <= qpos[:, :, None]
    if window is not None:
        mask &= qpos[:, :, None] - kpos < window
    qh = q.transpose(1, 2)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, keys, vals, attn_mask=mask[:, None])
    b_ms, b_by = _attention_bound(
        q, list(zip(starts, lens)), ctx, window, 2, esize,
        _paged_rate("paged_attention_varlen", d, dname), hh, kk, d)
    emit(phase="ab_varlen", case=case, dtype=dname, H=hh, KV=kk, D=d,
         row_start=starts, row_len=lens, window=window,
         scaled_err=diff.max().item(), bound_ms=b_ms, bound_by=b_by,
         ms=time_ms(kern, iters=100), device_ms=device_ms(kern, "varlen"),
         host_ms=_host_ms(kern), library_ms=time_ms(lib, iters=50),
         library_device_ms=device_ms(lib, iters=5))
    if sweep and "chunk" in case and hasattr(pav, "plan_varlen_splits"):
        _ab_varlen_splits(torch, pav, kern, case, dname, t, hh, kk, window)
    del kp, vp, keys, vals, lib


def _ab_varlen_splits(torch, pav, kern, case, dname, t, hh, kk, window):
    """The varlen kernel's device ms at each forced split count of
    ``AB_VARLEN_SPLITS`` beside the count the planner picks: what
    ``plan_varlen_splits`` was chosen from."""
    plan = pav.varlen_splits
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    planned = plan(t, hh, kk, D256_M, BS, window, sms)
    ms = {}
    try:
        for n in AB_VARLEN_SPLITS:
            pav.varlen_splits = lambda *a, n=n: n
            ms[n] = device_ms(kern, "varlen")
    finally:
        pav.varlen_splits = plan
    emit(phase="ab_varlen_splits", case=case, dtype=dname, window=window,
         planned=planned, planned_device_ms=device_ms(kern, "varlen"),
         forced=ms)


def _ab_gemma3_long(torch):
    """``--ab``'s end-to-end lines at head dim 256: full-width gemma3-12b
    on phase 41's long prompt.  Its chunked prefill (64-row rounds, as
    phase 41 runs it) profiled on a fresh chunked engine until the first
    token: the device ms of the rounds and the varlen kernel's; then the
    batched engine's decode round past position 2,048
    (:func:`_gemma3_decode_round`)."""
    import warnings

    from repro_torch.launch import serve as launcher

    n_tok = G3_LONG + G3_LONG_NEW
    pool = ["--max-batch", "1", "--num-blocks", str(-(-n_tok // 8) + 1),
            "--max-seq-len", str(n_tok)]
    parser = launcher.build_parser()
    args = parser.parse_args(G3_ARGS + ["--no-chunked-prefill"] + pool)
    device, bundle, params, _, store = launcher._model(args)
    prompt = torch.randint(3, bundle.cfg.vocab_size, (G3_LONG,),
                           generator=torch.Generator().manual_seed(41))
    chunked = parser.parse_args(G3_ARGS + G3_LONG_ENGINES[0][1] + pool)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        engine = launcher.make_engine(chunked, bundle, params, store, device)
    engine.submit(prompt.numpy(), G3_LONG_NEW)

    def prefill():   # the rounds up to the one that ends the prompt
        while engine.stats.prefills == 0:
            engine.step()

    t0 = time.perf_counter()
    busy, rows = profile_kernels(prefill)
    seconds = time.perf_counter() - t0
    rounds = engine.stats.prefill_dispatches
    varlen = [r for r in rows if "varlen" in r[0]]
    engine.run(max_steps=10_000)
    emit(phase="ab_chunked_prefill", rounds=rounds, seconds=seconds,
         device_ms=busy,
         varlen_device_ms=sum(r[1] for r in varlen),
         varlen_launches=sum(r[2] for r in varlen),
         varlen_share=sum(r[1] for r in varlen) / busy, top_kernels=rows[:6])
    del engine
    emit(phase="ab_decode_round", **_gemma3_decode_round(
        torch, launcher, args, bundle, params, store, device, prompt))
    del params, bundle, store
    torch.cuda.empty_cache()


AB_SPLITS = (1, 2, 4, 8, 12, 16, 24, 32)


def _ab_paged_splits(torch, pa, kern, case, dname, lens, window):
    """The split decode's device ms at each forced split count of
    ``AB_SPLITS`` (a floor of one stage a split), beside the count the
    planner picks: what ``plan_splits``' constants were chosen from."""
    plan = pa.plan_splits
    floor = pa.SPLIT_MIN_KEYS
    span = max(lens) if window is None else min(max(lens), window)
    ms = {}
    try:
        pa.SPLIT_MIN_KEYS = pa.SPLIT_STAGE_KEYS
        for n in AB_SPLITS:
            pa.plan_splits = lambda groups, s, sms, n=n: n
            used = -(-span // pa.split_chunk(span, n, pa.SPLIT_STAGE_KEYS))
            ms[n] = dict(used=used, device_ms=device_ms(kern,
                                                        "paged_attention"))
    finally:
        pa.plan_splits, pa.SPLIT_MIN_KEYS = plan, floor
    emit(phase="ab_paged_splits", case=case, dtype=dname, contexts=lens,
         window=window, planned=pa.split_geometry(
             len(lens), 16, 8, -(-max(lens) // BS), BS, window,
             torch.cuda.get_device_properties(0).multi_processor_count),
         planned_device_ms=device_ms(kern, "paged_attention"), forced=ms)


def ab_main(src: str, only: str = "") -> int:
    sys.path.insert(0, str(Path(src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke --ab: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import repro_torch
    from repro_torch import kernels
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.paged_kv_write import paged_kv_write_cuda
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda

    build.build_all()
    emit(phase="ab_tree", src=str(Path(repro_torch.__file__).parent),
         name=torch.cuda.get_device_name(0))
    ab_d256(torch, kernels_only=only == "k256")
    if only in ("d256", "k256"):
        return 0
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1234)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for case, n_rows in (("decode_rows", B), ("varlen_rows", B * 16)):
            pk, pv = (x.to(dev) for x in _pools(gen, dtype, torch, layers=L))
            kr = torch.randn(n_rows, KV, DH, generator=gen).to(dtype).to(dev)
            vr = torch.randn(n_rows, KV, DH, generator=gen).to(dtype).to(dev)
            dest = torch.randperm(NB * BS, generator=gen)[:n_rows]
            page = (dest // BS).to(torch.int32).to(dev)
            off = (dest % BS).to(torch.int32).to(dev)
            mask = (torch.arange(n_rows) % 5 != 3).to(dev)
            act = mask.to(torch.int32)
            sel = mask.cpu()
            rid = (((7 * KV + torch.arange(KV)[None, :]) * NB
                    + page.cpu()[sel].long()[:, None]) * BS
                   + off.cpu()[sel].long()[:, None]).reshape(-1).to(dev)
            ksrc, vsrc = kr[mask].reshape(-1, DH), vr[mask].reshape(-1, DH)
            fk, fv = pk.view(-1, DH), pv.view(-1, DH)
            fns = {
                "ops_bool": lambda: ops.paged_kv_write(
                    pk, pv, kr, vr, page, off, mask, layer=7),
                "direct_int32": lambda: paged_kv_write_cuda(
                    pk, pv, kr, vr, page, off, act, layer=7),
                "index_copy": lambda: (fk.index_copy_(0, rid, ksrc),
                                       fv.index_copy_(0, rid, vsrc))}
            emit(phase="ab_kv_write", case=case, dtype=dname,
                 ms={k: time_ms(f, iters=200) for k, f in fns.items()},
                 device_ms={k: device_ms(f) for k, f in fns.items()})
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for case, bb, s, state in (("prefill", HYMBA_B, HYMBA_P, False),
                                   ("decode", HYMBA_B, 1, True),
                                   ("long", HYMBA_B, 512, True),
                                   ("long_b1", 1, HYMBA_LONG, False)):
            args = _ssm_args(torch, dtype, bb, s, HYMBA_I, HYMBA_N, state,
                             seed=s)
            kern = lambda: ssm_scan_cuda(*args)
            emit(phase="ab_ssm_scan", case=case, dtype=dname, B=bb, S=s,
                 ms=time_ms(kern, iters=50),
                 device_ms=device_ms(kern, "ssm_scan_"))
    # The flash forward at the head-dim-128 serve prefills and B 1 x
    # S 2048, at hymba's learner shape with the logsumexp and at its B 1 x
    # S 2048 forward (windowed and global layers), each beside SDPA's.
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda, flash_impl)

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        esize = torch.empty((), dtype=dtype).element_size()
        for case, bb, s, hh, kk, d, window, lse in (
                ("q14b_prefill", 8, 32, 40, 8, 128, None, False),
                ("q14b_long", 1, 2048, 40, 8, 128, None, False),
                ("codeqwen_prefill", 8, 32, 32, 32, 128, None, False),
                ("hymba_learner_lse", LEARN_B, LEARN_S, HYMBA_H, HYMBA_KV,
                 64, HYMBA_WINDOW, True),
                ("hymba_long_local", 1, HYMBA_LONG, HYMBA_H, HYMBA_KV, 64,
                 HYMBA_WINDOW, False),
                ("hymba_long_global", 1, HYMBA_LONG, HYMBA_H, HYMBA_KV, 64,
                 None, False)):
            gen = torch.Generator(device="cuda").manual_seed(s + hh + d)
            q, k, v = (torch.randn(bb, s, n, d, generator=gen,
                                   device="cuda").to(dtype)
                       for n in (hh, kk, kk))
            kern = lambda: flash_attention_cuda(q, k, v, window=window,
                                                return_lse=lse)
            lib = _sdpa_fwd(torch, q, k, v, window)
            impl = flash_impl(dtype, d, lse)
            nbytes = ((2 * bb * s * hh * d + 2 * bb * s * kk * d) * esize
                      + (bb * s * hh * 4 if lse else 0))
            b_ms, b_by = bound(nbytes, 4 * d * hh * bb * _attended_pairs(
                s, window), _flash_rate(impl, dname))
            emit(phase="ab_flash_fwd", case=case, dtype=dname, impl=impl,
                 B=bb, S=s, H=hh, KV=kk, D=d, window=window, lse=lse,
                 bound_ms=b_ms, bound_by=b_by, ms=time_ms(kern, iters=50),
                 device_ms=device_ms(kern, "flash_kernel"),
                 library_ms=time_ms(lib, iters=50),
                 library_device_ms=device_ms(lib, iters=5))
            del lib
    # The two backward kernels at the learner's B 64 x S 40, and flash's
    # at hymba's B 1 x S 2048, each beside SDPA's backward (its time and
    # the kernels it runs, by device time).
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd_cuda

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for case, bb, s, hh, kk, window in (
                ("hymba_learner", LEARN_B, LEARN_S, HYMBA_H, HYMBA_KV,
                 HYMBA_WINDOW),
                ("qwen_learner", LEARN_B, LEARN_S, 14, 2, None),
                ("long_local", 1, HYMBA_LONG, HYMBA_H, HYMBA_KV,
                 HYMBA_WINDOW),
                ("long_global", 1, HYMBA_LONG, HYMBA_H, HYMBA_KV, None)):
            q, k, v, d_out = _flash_bwd_case(torch, dtype, bb, s, hh, kk, 64,
                                             seed=s + hh)
            out, lse = flash_attention_cuda(q, k, v, window=window,
                                            return_lse=True)
            kern = lambda: flash_attention_bwd_cuda(q, k, v, out, lse, d_out,
                                                    window=window)
            lib = _sdpa_bwd(torch, q, k, v, d_out, window)
            b_ms, b_by = _flash_bwd_bound(bb, s, hh, kk, 64, window, dname)
            emit(phase="ab_flash_bwd", case=case, dtype=dname, B=bb, S=s,
                 H=hh, KV=kk, window=window, bound_ms=b_ms, bound_by=b_by,
                 ms=time_ms(kern, iters=50),
                 device_ms=device_ms(kern, "flash_bwd_"),
                 library_ms=time_ms(lib, iters=20),
                 library_device_ms=device_ms(lib, iters=5),
                 library_kernels_ms=profile_kernels(
                     lib, lambda rows: len(rows) > 0)[1][:4])
            del lib
        args = _ssm_args(torch, dtype, LEARN_B, LEARN_S, HYMBA_I, HYMBA_N,
                         False, strided=True, seed=LEARN_S * HYMBA_I + 1)
        gen = torch.Generator(device="cuda").manual_seed(LEARN_S + 2)
        gy = torch.randn(LEARN_B, LEARN_S, HYMBA_I, generator=gen,
                         device="cuda").to(dtype)
        ghf = torch.randn(LEARN_B, HYMBA_I, HYMBA_N, generator=gen,
                          device="cuda")
        kern = lambda: ssm_scan_bwd_cuda(*args, gy, ghf)
        emit(phase="ab_ssm_scan_bwd", case="hymba_learner", dtype=dname,
             B=LEARN_B, S=LEARN_S, I=HYMBA_I, ms=time_ms(kern, iters=50),
             device_ms=device_ms(kern, "ssm_scan_bwd"))
    # wkv6 as the rwkv6 path calls it, and vtrace at the paper's shape.
    from repro_torch.kernels import wkv6 as wkv6_mod
    from repro_torch.kernels.vtrace import vtrace_cuda
    from repro_torch.kernels.wkv6 import wkv6_cuda

    pick = getattr(wkv6_mod, "wkv6_impl", lambda *a: "serial")
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for case, bb, s, state in (("prefill", RWKV_B, RWKV_P, False),
                                   ("decode", RWKV_B, 1, True),
                                   ("long", RWKV_B, 512, True),
                                   ("long_b1", 1, RWKV_LONG, False)):
            args = _wkv6_inputs(torch, dtype, bb, s, RWKV_H, 64, state,
                                seed=s)
            kern = lambda: wkv6_cuda(*args)
            emit(phase="ab_wkv6", case=case, dtype=dname, B=bb, S=s,
                 impl=pick(bb, s, RWKV_H), ms=time_ms(kern, iters=50),
                 device_ms=device_ms(kern, "wkv6_"))
        # The backward at the learner's shape and B 1 x S 2048 (trees
        # that have it).
        for case, bb, s in (("learner", LEARN_B, LEARN_S),
                            ("long_b1", 1, RWKV_LONG)):
            if not hasattr(wkv6_mod, "wkv6_bwd_cuda"):
                break
            args = _wkv6_inputs(torch, dtype, bb, s, RWKV_H, 64, False,
                                seed=s + 1)
            gy = torch.randn(bb, s, RWKV_H, 64, device="cuda").to(dtype)
            kern = lambda: wkv6_mod.wkv6_bwd_cuda(*args, gy, None)
            emit(phase="ab_wkv6_bwd", case=case, dtype=dname, B=bb, S=s,
                 ms=time_ms(kern, iters=50),
                 device_ms=device_ms(kern, "wkv6_bwd"))
        args = _vtrace_inputs(torch, RL_ACTORS, RL_STEPS, dtype, seed=1)
        kern = lambda: vtrace_cuda(*args)
        emit(phase="ab_vtrace", dtype=dname, B=RL_ACTORS, T=RL_STEPS,
             ms=time_ms(kern, iters=100),
             device_ms=device_ms(kern, "vtrace_kernel"))
    # The qwen serve path: launches and device time a model pass.
    from repro_torch.launch import profile_serve

    out = ROOT / "build" / "ab_profile_serve.json"
    out.parent.mkdir(exist_ok=True)
    profile_serve.main(["--full-width", "--out", str(out)])
    # The hymba static serve path and the long forward.
    from repro_torch.launch import serve as launcher

    static = launcher.prepare_static(launcher.build_parser().parse_args([
        "--engine", "static", "--arch", "hymba-1.5b", "--full-width",
        "--device", "cuda", "--batch", str(HYMBA_B), "--max-new-tokens",
        str(HYMBA_NEW)]))
    static.generate()
    kernels.reset_launch_counts()
    _, seconds = launcher.run_static(static)
    counts = kernels.launch_counts()
    busy, rows = profile_kernels(static.generate)
    emit(phase="ab_hymba_generate", seconds=seconds,
         tokens_per_s=HYMBA_B * HYMBA_NEW / seconds, device_busy_ms=busy,
         kernel_launches=sum(c for _, _, c in rows),
         ssm_scan_ms=sum(ms for k, ms, _ in rows if "ssm_scan_" in k),
         ssm_scan_launches=counts["ssm_scan"], top_kernels=rows[:6])
    tokens = torch.randint(3, static.bundle.cfg.vocab_size, (1, HYMBA_LONG),
                           generator=torch.Generator(device="cuda")
                           .manual_seed(7), device="cuda")
    long_fwd = lambda: static.bundle.forward(static.params, tokens)
    long_fwd()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        long_fwd()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    kernels.reset_launch_counts()
    long_fwd()
    n_scans = kernels.launch_counts()["ssm_scan"]
    busy, rows = profile_kernels(long_fwd, _long_forward_whole)
    emit(phase="ab_hymba_long_forward", wall_ms=sorted(walls)[1],
         device_busy_ms=busy,
         ssm_scan_ms=sum(ms for k, ms, _ in rows if "ssm_scan_" in k),
         ssm_scan_launches=n_scans,
         top_kernels=rows[:6])
    del static, tokens
    torch.cuda.empty_cache()
    # The rwkv6 static serve path and its long forward.
    static = launcher.prepare_static(launcher.build_parser().parse_args([
        "--engine", "static", "--arch", "rwkv6-1.6b", "--full-width",
        "--device", "cuda", "--batch", str(RWKV_B), "--max-new-tokens",
        str(RWKV_NEW)]))
    static.generate()
    kernels.reset_launch_counts()
    _, seconds = launcher.run_static(static)
    counts = kernels.launch_counts()
    busy, rows = profile_kernels(static.generate)
    emit(phase="ab_rwkv_generate", seconds=seconds,
         tokens_per_s=RWKV_B * RWKV_NEW / seconds, device_busy_ms=busy,
         kernel_launches=sum(c for _, _, c in rows),
         wkv6_ms=sum(ms for k, ms, _ in rows if "wkv6_" in k),
         wkv6_launches=counts["wkv6"], top_kernels=rows[:6])
    rwkv_long_forward(torch, static, kernels, pick(1, RWKV_LONG, RWKV_H),
                      tag="ab_rwkv_long_forward")
    return 0


def main() -> int:
    t_start = time.perf_counter()
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    # nvcc builds every kernel while the card initialises.
    t0 = time.perf_counter()
    building = concurrent.futures.ThreadPoolExecutor(1).submit(
        build.build_all)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    probe = torch.empty(1, device="cuda")
    expandable = all(seg.get("is_expandable", False)
                     for seg in torch.cuda.memory_snapshot())
    del probe
    check(expandable, "the CUDA allocator does not map expandable "
          f"segments (PYTORCH_CUDA_ALLOC_CONF="
          f"{os.environ.get('PYTORCH_CUDA_ALLOC_CONF')!r})")
    emit(phase="device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi_line,
         torch=torch.__version__, cuda=torch.version.cuda,
         expandable_segments=expandable)

    times = building.result()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln]
             for name, log in build.build_log.items()}
    emit(phase="build", seconds=time.perf_counter() - t0, nvcc_s=times,
         ptxas=ptxas)
    phase_s = {"1-2 device, build": time.perf_counter() - t_start}

    def run(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[label] = time.perf_counter() - t
        return out

    def release():
        gc.collect()              # the earlier phases' trainers (cycles)
        torch.cuda.empty_cache()

    headline = run("3 kernels", kernel_phase, torch)
    headline.update(run("6 logprob kernels", logprob_kernel_phase, torch))
    launches = run("4 serve", serve_phase, torch)
    run("5 parity", parity_phase, torch)
    trainer, train_launches = run("7 train", train_phase, torch)
    launches.update({k: train_launches[k]
                     for k in ("fused_logprob", "fused_logprob_bwd")})
    run("8 step", step_phase, torch, trainer)
    del trainer
    torch.cuda.empty_cache()
    run("9 train parity", train_parity_phase, torch)
    headline.update(run("10 vtrace kernel", vtrace_kernel_phase, torch))
    launches["vtrace"] = run("11 rl", rl_phase, torch)["vtrace"]
    run("11 rl profile", rl_profile_phase, torch)
    run("12 rl parity", rl_parity_phase, torch)
    headline.update(run("13 wkv6 kernel", wkv6_kernel_phase, torch))
    launches["wkv6"] = run("14 rwkv serve", rwkv_serve_phase, torch)["wkv6"]
    run("15 rwkv parity", rwkv_parity_phase, torch)
    headline.update(run("16 flash kernel", flash_kernel_phase, torch))
    headline.update(run("16 ssm kernel", ssm_kernel_phase, torch))
    hymba = run("17 hymba serve", hymba_serve_phase, torch)
    launches.update({k: hymba[k] for k in ("flash_attention", "ssm_scan")})
    run("18 hymba parity", hymba_parity_phase, torch)
    rlvr_baseline = run("19 serve rlvr", serve_rlvr_phase, torch)
    run("20 swap parity", swap_parity_phase, torch)
    run("21 threaded rl", threaded_rl_phase, torch)
    run("22 threaded serve rlvr", threaded_serve_rlvr_phase, torch)
    run("23 harnesses", harness_phase, torch)
    release()
    trainer = run("24 controllers", controllers_phase, torch)
    run("25 chaos", chaos_phase, torch)
    run("26 checkpoints", checkpoint_phase, torch, trainer)
    del trainer
    release()
    launches["paged_attention_multi"] = run(
        "27 spec serve", spec_serve_phase, torch)["paged_attention_multi"]
    run("28 prefix cache", prefix_cache_phase, torch)
    run("29 spec rlvr", spec_rlvr_phase, torch, rlvr_baseline)
    release()
    headline.update(run("30 bwd kernels", bwd_kernel_phase, torch))
    release()
    hymba_train = run("31 hymba train", hymba_train_phase, torch)
    launches.update({k: hymba_train[k]
                     for k in ("flash_attention_bwd", "ssm_scan_bwd")})
    release()
    run("32 hymba train parity", hymba_train_parity_phase, torch)
    release()
    headline.update(run("33 wkv6 bwd kernel", wkv6_bwd_kernel_phase, torch))
    release()
    launches["wkv6_bwd"] = run("34 rwkv train", rwkv_train_phase,
                               torch)["wkv6_bwd"]
    release()
    run("35 rwkv train parity", rwkv_train_parity_phase, torch)
    release()
    headline.update(run("36 d128 kernels", d128_kernel_phase, torch))
    release()
    launches["flash_attention_d128"] = run(
        "37 qwen2.5-14b serve", q14b_serve_phase, torch)["flash_attention"]
    release()
    run("38 codeqwen serve", codeqwen_serve_phase, torch)
    release()
    run("39 batched parity", batched_parity_phase, torch)
    release()
    headline.update(run("40 d256 kernels", d256_kernel_phase, torch))
    release()
    gemma3 = run("41 gemma3-12b serve", gemma3_serve_phase, torch)
    launches.update({f"{k}_d256": gemma3[k] for k in (
        "paged_attention", "paged_attention_varlen", "flash_attention")})
    launches["paged_attention_varlen_d256_chunk"] = gemma3[
        "paged_attention_varlen"]
    release()
    run("42 gemma3 parity", gemma3_parity_phase, torch)
    print(json.dumps({"phase_seconds": phase_s,
                      "total_s": time.perf_counter() - t_start}))

    rows = []
    for name, source, replaces in KERNELS:
        h = headline[(name, "float32")]
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=h["max_abs_err"],
            ms=h["kernel_ms"], plain_ms=h["plain_ms"],
            bound_ms=h["bound_ms"], bound_by=h["bound_by"],
            library_ms=h["library_ms"]))
        if name.startswith("flash_attention") and "impl" in h:
            rows[-1]["impl"] = h["impl"]   # the instantiation timed
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def conditioning_main() -> int:
    """``--grad-conditioning``: builds the kernels and prints
    :func:`rwkv_grad_conditioning`'s lines and the ``nvidia-smi`` line."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke --grad-conditioning: torch.cuda.is_available() "
              "is false", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build

    build.build_all()
    rwkv_grad_conditioning(torch)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab"]:
        sys.exit(ab_main(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--grad-conditioning"]:
        sys.exit(conditioning_main())
    sys.exit(main())

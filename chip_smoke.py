#!/usr/bin/env python3
"""The quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. device probe: needs ``torch.cuda.is_available()``; prints the card's
   ``nvidia-smi`` name and power limit; float32 matmuls without TF32.
2. build: compiles every CUDA kernel of the port from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel).
3. kernels: each kernel against its plain PyTorch version at the serve
   path's full-width shapes (H=14, KV=2, Dh=64, BS=8, M=32, B=4,
   T in {1, 16, 32}) plus ragged edge cases and contexts of up to 239
   keys (four 64-key tiles, global and windowed), and the speculative
   verify shape (``paged_attention_multi``, B 4 x T 4 at the decode
   contexts), in float32 and bfloat16; float32 within 2e-5, bfloat16
   within 2e-2, the K/V row write bit-exact.  Times each with CUDA
   events beside the plain version, a library call and its bound.  The
   K/V row write is timed twice: the wrapper called directly with an
   int32 mask, and ``ops.paged_kv_write`` with the step's bool mask (what
   a model layer pays), each beside ``index_copy_``.
4. serve: full-width qwen2.5-0.5b (24 layers, seeded random init) through
   the launcher's ``serve`` with its defaults; every request must retire
   and every kernel must have launched.
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
   must launch once on every learner step.
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
    at that scale, each timed and profiled (device busy / idle share).
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
    (``impl``: ``wgmma`` for bfloat16 at D 64, ``fma`` otherwise) and
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
    forward (scorings and eval prefills); finite warmup loss, tv,
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
    the paper's scale (500 actors x 1000 steps, VACO) for 3 phases with
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
    on a reduced grid (fig3 at 500 x 1000: pendulum, vaco and ppo, K 1
    and 4, 1 seed, 3 phases; fig4, fig11 and the ablations at their own
    scale, pendulum, 1 seed, 2 phases; fig5 ``--full-width`` with N 1
    and 2, 1 phase, 4 warmup steps): each report finite with its
    reference's keys, its kernel launched.

Then one JSON line of every kernel's numbers, the ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, published
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
H, KV, DH, BS, NB, M, B, L = 14, 2, 64, 8, 128, 32, 4, 24
# The learner's log-prob shape: 16 prompts x 4 completions x 8 tokens
# over the qwen vocab.
N_LEARN, V_FULL = 512, 151936
LOGPROB_TOL = {"float32": (1e-5, 1e-4, 1e-5),     # logp, entropy, grad
               "bfloat16": (2e-2, 2e-2, 2e-2)}
SERVE_KERNELS = ("paged_kv_write", "paged_attention", "paged_attention_varlen")
# The paper's classic-RL scale (Table 1): 500 envs x 1000 steps.
RL_ACTORS, RL_STEPS, RL_PHASES = 500, 1000, 2
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count
               and e.self_device_time_total
               and (match is None or match in e.key)]
        if not evs:
            continue
        if match is None:
            return sum(e.self_device_time_total for e in evs) / iters / 1e3
        return sum(e.self_device_time_total / e.count for e in evs) / 1e3
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts if complete else 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total]
        rows.sort(key=lambda r: -r[1])
        rows = [[name[:80], ms, n] for name, ms, n in rows]
        if complete is None or complete(rows):
            break
    return sum(r[1] for r in rows), rows


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _tables(gen, lens, torch):
    """Distinct pages per slot drawn from 1..NB-1; pads are page 0."""
    perm = torch.randperm(NB - 1, generator=gen)[: B * M] + 1
    tables = torch.zeros(B, M, dtype=torch.int32)
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


def _attention_bound(q, rows, lens, window, n_scalars, esize, dtype):
    """Least time for one call.  Bytes: the whole output written once;
    ``n_scalars`` int32 per slot; for each live slot its live query rows,
    the K/V rows its oldest row can see and the table entries of their
    pages, each read once.  Flops: the valid (query, key) pairs."""
    nbytes = q.numel() * esize + n_scalars * B * 4
    flops = 0
    for (start, n), ctx in zip(rows, lens):
        if n <= 0:
            continue
        first = 0 if window is None else max(0, start - window + 1)
        nbytes += n * H * DH * esize
        nbytes += 2 * KV * (ctx - first) * DH * esize
        nbytes += (-(-ctx // BS) - first // BS) * 4
        for qpos in range(start, start + n):
            keys = qpos + 1 if window is None else min(qpos + 1, window)
            flops += 4 * H * keys * DH
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
            # paged_attention_multi runs kernel 3: its error is kernel 3's.
            key = (name.replace("_multi", "_varlen"), dname)
            worst[key] = max(worst.get(key, 0.0), err)
            if case in ("decode", "varlen_t16"):
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
    # after warmup and one per eval of the train loop.  The learner's
    # forward, which needs a gradient, never does; pass_through scores
    # no minibatch without one.
    generates = len(produce) + 1 + len(res.eval_accuracy)
    check(len(produce) > 0
          and launches["flash_attention"] == cfg.n_layers * generates,
          f"flash_attention launched {launches['flash_attention']} times "
          f"for {generates} generates of {cfg.n_layers} layers")
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


def train_parity_phase(torch):
    """2 layers at full width: one warmup step and one VACO learner step
    on the CPU (plain path) and the card (kernels)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.losses import group_advantages
    from repro_torch.data.mathgen import MathTaskDataset
    from repro_torch.models.registry import build
    from repro_torch.optim import adamw_init
    from repro_torch.rollout.sampler import score_tokens
    from repro_torch.train import (RLVRHyperparams, make_update_step,
                                   make_warmup_step)
    from repro_torch.train.trainer_rlvr import RLVRTrainState
    from repro_torch.utils.tree import tree_leaves, tree_to

    cfg = get_config("qwen2.5-0.5b").replace(n_layers=2)
    bundle = build(cfg)
    hp = RLVRHyperparams(algorithm="grpo_vaco")
    params = bundle.init(torch.Generator().manual_seed(0))
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
    warm = make_warmup_step(bundle, hp)
    update = make_update_step(bundle, hp, 32)
    out = {}
    log_beta = None
    for dev in ("cpu", "cuda"):
        on = lambda a: torch.as_tensor(a).to(dev)
        p = tree_to(params, dev)
        st, w_loss = warm(RLVRTrainState(p, adamw_init(p), 0), on(w_tok),
                          on(w_mask))
        st = st._replace(opt_state=adamw_init(st.params))
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
                        warm_params=[a.cpu() for a in tree_leaves(st.params)],
                        params=[a.cpu() for a in tree_leaves(st2.params)])
    cpu, card = out["cpu"], out["cuda"]
    init = [a.clone() for a in tree_leaves(params)]
    rec = dict(phase="train_parity", config=cfg.name, layers=cfg.n_layers,
               tol=1e-4, update_tol=1e-2)
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
                          ("params", "warm_params", hp.lr)):
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
          cpu["frac_filtered"] > 0, f"train parity: VACO filter idle {cpu}")
    check(not failures, "train parity: " + "; ".join(failures))


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
    """One collection and one learner phase at the paper's scale, each
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
    producer = MixtureRolloutProducer(env, act, n_actors=RL_ACTORS,
                                      rollout_steps=RL_STEPS, seed=1,
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

    rec = dict(phase="rl_profile", actors=RL_ACTORS, steps=RL_STEPS)
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
        rec["collect"]["kernel_launches"] / RL_STEPS)
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
        for s in (4, 8, 12, 16, 32, 64, 128, 256, 512, 2048):
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
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_impl)

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
        esize = torch.empty((), dtype=dtype).element_size()
        for case, b, s, hh, kk, d, window in cases:
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
            check(err <= FLASH_TOL[dname],
                  f"flash/{case}/{dname}: max_abs_err {err}")
            worst[dname] = max(worst.get(dname, 0.0), err)
            if case not in timed:
                continue
            kern = lambda: flash_attention_cuda(q, k, v, window=window)
            plain = lambda: ref.ref_attention(q, k, v, window=window)
            # Library yardstick, timed only: SDPA on [B, H, S, D] with the
            # kv heads repeated (not timed), causal or with the band mask.
            qt = q.transpose(1, 2).contiguous()
            kt, vt = (x.repeat_interleave(hh // kk, dim=2).transpose(1, 2)
                      .contiguous() for x in (k, v))
            if window is None:
                lib = lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True)
            else:
                i = torch.arange(s, device="cuda")
                band = (i[:, None] >= i[None, :]) & (
                    i[:, None] - i[None, :] < window)
                lib = lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=band)
            # q, k, v read once and out written once; 4 D operations
            # (the two products) per attended (query, key) pair and head.
            nbytes = (2 * b * s * hh * d + 2 * b * s * kk * d) * esize
            flops = 4 * d * hh * b * _attended_pairs(s, window)
            b_ms, b_by = bound(nbytes, flops, dname)
            # The instantiation that ran, by its profiled name.
            impl = flash_impl(dtype, d)
            symbol = ("flash_kernel_wgmma" if impl == "wgmma"
                      else "flash_kernel<")
            rec = dict(phase="kernel", kernel="flash_attention", case=case,
                       dtype=dname, impl=impl, B=b, S=s, H=hh, KV=kk, D=d,
                       window=window, max_abs_err=err, tol=FLASH_TOL[dname],
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
            if case == "prefill_local":      # 30 of a generate's 32 launches
                headline[("flash_attention", dname)] = rec
            del qt, kt, vt
    for dname, err in worst.items():
        headline[("flash_attention", dname)] = dict(
            headline[("flash_attention", dname)], max_abs_err=err)
    return headline


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
    for bb, s in ([(1, s) for s in (64, 96, 192, 256)]
                  + [(bb, s) for bb in (1, 2, 3, 4, 5, 6, 8)
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
    profiled."""
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
    # once a layer; the engine's prefill is paged.
    forwards = steps + 1 + len(res.eval_accuracy)
    check(launches["flash_attention"] == cfg.n_layers * forwards,
          f"flash_attention launched {launches['flash_attention']} times "
          f"for {forwards} no-grad forwards of {cfg.n_layers} layers")
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
    return launches


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
    """``train rl`` at the paper's scale for THREADED_RL_PHASES phases,
    recorded (``_Recorder``); returns (result, recorder, seconds,
    launches, produce spans, learner spans, seconds to the end of the
    last phase's eval: the run's wall without the threaded producer's
    shutdown, which waits for the rollout in progress)."""
    from repro_torch import kernels
    from repro_torch.launch import train as launcher
    from repro_torch.obs.tracer import Tracer
    from repro_torch.runtime import LagRegime

    args = launcher.build_parser().parse_args([
        "rl", "--device", "cuda", "--n-actors", str(RL_ACTORS),
        "--rollout-steps", str(RL_STEPS), "--buffer-capacity",
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
    """``train rl --runtime threaded`` at the paper's scale (500 actors x
    1000 steps, VACO) with K 4 and K 1, beside ``backward_mixture`` at K
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
        env_steps = RL_ACTORS * RL_STEPS
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
    emit(phase="threaded_rl", actors=RL_ACTORS, steps=RL_STEPS,
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
    check(launches["flash_attention"] == cfg.n_layers * forwards,
          f"flash_attention launched {launches['flash_attention']} times "
          f"for {forwards} no-grad forwards of {cfg.n_layers} layers")
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
    ("fig3_backward_lag",
     ["--envs", "pendulum", "--algorithms", "vaco", "ppo", "--capacities",
      "1", "4", "--seeds", "0", "--phases", "3", "--n-actors",
      str(RL_ACTORS), "--rollout-steps", str(RL_STEPS)],
     {"K=1", "K=4", "_raw", "_seconds"}, "vtrace"),
    ("fig4_sample_efficiency",
     ["--envs", "pendulum", "--seeds", "0", "--phases", "2"],
     {"vaco", "ppo", "spo", "impala"}, "vtrace"),
    ("fig11_tv_tracking", ["--envs", "pendulum", "--seeds", "0",
                           "--phases", "2"],
     {"vaco", "ppo", "ppo_kl"}, "vtrace"),
    ("ablation_delta", ["--envs", "pendulum", "--seeds", "0", "--phases",
                        "2"],
     {f"delta={d}" for d in (0.05, 0.1, 0.2, 0.4)}, "vtrace"),
    ("ablation_rho", ["--envs", "pendulum", "--seeds", "0", "--phases",
                      "2"],
     {f"rho={r}" for r in (1.0, 2.0, 8.0)}, "vtrace"),
    ("ablation_realignment", ["--envs", "pendulum", "--seeds", "0",
                              "--phases", "2"],
     {"K=4", "K=16"}, "vtrace"),
    ("fig5_rlvr_forward_lag",
     ["--full-width", "--minibatches", "1", "2", "--phases", "1",
      "--warmup-steps", "4"],
     {"grpo", "grpo_vaco"}, "fused_logprob_bwd"),
)


def harness_phase(torch):
    """The figure runners (``repro_torch.experiments``) on reduced grids:
    fig3 at the paper's collection scale, the rest at their own, fig5 at
    full width; each report finite, with its keys, its kernel launched."""
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


KERNELS = (
    ("paged_kv_write", "src/repro_torch/kernels/csrc/paged_kv_write.cu",
     "src/repro/kernels/paged_kv_write_pallas.py:83"),
    ("paged_attention", "src/repro_torch/kernels/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention_pallas.py:128"),
    ("paged_attention_varlen",
     "src/repro_torch/kernels/csrc/paged_attention_varlen.cu",
     "src/repro/kernels/paged_attention_pallas.py:262"),
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
    ("ssm_scan", "src/repro_torch/kernels/csrc/ssm_scan.cu",
     "src/repro/kernels/ssm_scan_pallas.py:73"),
)


# ---------------------------------------------------------------------------
# Comparison mode: ``chip_smoke.py --ab SRC`` measures ``paged_kv_write``,
# ``ssm_scan``, ``wkv6`` and ``vtrace`` as the model calls them (and the
# qwen, hymba and rwkv6 serve paths), with the port found under SRC
# (this tree's ``src`` or an unpacked parent commit's), through the entry
# points both trees share.  Run it for the parent and the change in turns
# on one card; it prints JSON lines only (``profile_serve``'s result also
# lands in build/ab_profile_serve.json).
# ---------------------------------------------------------------------------


def ab_main(src: str) -> int:
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(phase="device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi_line,
         torch=torch.__version__, cuda=torch.version.cuda)

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    times = build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln]
             for name, log in build.build_log.items()}
    emit(phase="build", seconds=time.perf_counter() - t0, nvcc_s=times,
         ptxas=ptxas)

    headline = kernel_phase(torch)
    headline.update(logprob_kernel_phase(torch))
    launches = serve_phase(torch)
    parity_phase(torch)
    trainer, train_launches = train_phase(torch)
    launches.update({k: train_launches[k]
                     for k in ("fused_logprob", "fused_logprob_bwd")})
    step_phase(torch, trainer)
    del trainer
    torch.cuda.empty_cache()
    train_parity_phase(torch)
    headline.update(vtrace_kernel_phase(torch))
    launches["vtrace"] = rl_phase(torch)["vtrace"]
    rl_profile_phase(torch)
    rl_parity_phase(torch)
    headline.update(wkv6_kernel_phase(torch))
    launches["wkv6"] = rwkv_serve_phase(torch)["wkv6"]
    rwkv_parity_phase(torch)
    headline.update(flash_kernel_phase(torch))
    headline.update(ssm_kernel_phase(torch))
    hymba = hymba_serve_phase(torch)
    launches.update({k: hymba[k] for k in ("flash_attention", "ssm_scan")})
    hymba_parity_phase(torch)
    serve_rlvr_phase(torch)
    swap_parity_phase(torch)
    threaded_rl_phase(torch)
    threaded_serve_rlvr_phase(torch)
    harness_phase(torch)

    rows = []
    for name, source, replaces in KERNELS:
        h = headline[(name, "float32")]
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=h["max_abs_err"],
            ms=h["kernel_ms"], plain_ms=h["plain_ms"],
            bound_ms=h["bound_ms"], bound_by=h["bound_by"],
            library_ms=h["library_ms"]))
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab"]:
        sys.exit(ab_main(sys.argv[2]))
    sys.exit(main())

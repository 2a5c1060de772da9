#!/usr/bin/env python3
"""The quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. device probe: needs ``torch.cuda.is_available()``; prints the card's
   ``nvidia-smi`` name and power limit; float32 matmuls without TF32.
2. build: compiles every CUDA kernel of the serve path from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel).
3. kernels: each kernel against its plain PyTorch version at the serve
   path's full-width shapes (H=14, KV=2, Dh=64, BS=8, M=32, B=4,
   T in {1, 16, 32}) plus ragged edge cases; float32 within 2e-5,
   bfloat16 within 2e-2, the K/V row write bit-exact.  Times each with
   CUDA events beside the plain version, a library call and its bound.
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


def device_ms(fn, match=None, iters: int = 20):
    """Device time per call from a ``torch.profiler`` capture: the CUDA
    kernels whose name contains ``match`` (None: every kernel the call
    runs).  None when the capture holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and (match is None or match in e.key))
    return total / iters / 1e3 if total else None


def profile_kernels(fn):
    """One profiled call of ``fn``: its total CUDA kernel time (ms) and
    every kernel by device time, largest first, as ``[name, ms,
    calls]``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    rows.sort(key=lambda r: -r[1])
    return (sum(r[1] for r in rows),
            [[name[:80], ms, n] for name, ms, n in rows])


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

    from repro_torch.kernels import ref
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
            b_ms, b_by = _attention_bound(q, rows, ctx, window,
                                          1 if decode else 2, esize, dname)
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
                b_ms, b_by = bound(k["nbytes"], k["flops"], "float32")
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
    check(all(math.isfinite(l.tv) for l in res.phase_logs) and
          math.isfinite(warm_loss), "non-finite warmup loss or tv")
    produce = _span_seconds(tracer, "produce")
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
)


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
                    if "registers" in ln or "spill" in ln]
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
    sys.exit(main())

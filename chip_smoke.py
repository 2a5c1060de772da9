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

Then one JSON line of every kernel's numbers, the ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, published
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
H, KV, DH, BS, NB, M, B, L = 14, 2, 64, 8, 128, 32, 4, 24


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
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")
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


KERNELS = (
    ("paged_kv_write", "src/repro_torch/kernels/csrc/paged_kv_write.cu",
     "src/repro/kernels/paged_kv_write_pallas.py:83"),
    ("paged_attention", "src/repro_torch/kernels/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention_pallas.py:128"),
    ("paged_attention_varlen",
     "src/repro_torch/kernels/csrc/paged_attention_varlen.cu",
     "src/repro/kernels/paged_attention_pallas.py:262"),
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
    launches = serve_phase(torch)
    parity_phase(torch)

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

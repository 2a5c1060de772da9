"""Where the serve path's time goes on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve [--full-width] \\
      [--out PATH] [launcher flags...]

Serves the launcher's workload three times on one engine configuration
(fresh engine each time, same seed): a cold run, a warm run (the
throughput and latency numbers), and a warm run under
``torch.profiler`` (CUDA activity only).  From the capture it reports
the device's busy time (the sum of every CUDA kernel's device time; the
port runs on one stream), the kernels ranked by device time, and the
launches and device time per launch of the port's own paged kernels.
The device's idle share divides that busy time by the wall time of the
unprofiled warm run, which serves the same tokens through the same
kernels; the share against the profiled run's own (longer) wall time
is printed beside it.
Prints one JSON object (also written to ``--out``).  Needs CUDA.
"""
from __future__ import annotations

import json
import sys
from typing import List, Optional

import torch


def _kernel_table(prof, limit: int = 12):
    from torch.autograd import DeviceType

    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    rows.sort(key=lambda e: -e.self_device_time_total)
    return [{"kernel": e.key[:120], "launches": e.count,
             "device_ms": e.self_device_time_total / 1e3}
            for e in rows[:limit]], sum(e.self_device_time_total
                                        for e in rows) / 1e3, rows


def _streams(trajs) -> List[List[int]]:
    """Each request's tokens in submission order (request ids count on
    across engines, so they differ from run to run)."""
    return [t.tokens.tolist()
            for t in sorted(trajs, key=lambda t: t.request_id)]


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch import kernels
    from repro_torch.launch import serve as launcher
    from repro_torch.metrics import collect_serve_stats

    argv = list(sys.argv[1:] if argv is None else argv)
    out_path = None
    if "--out" in argv:
        i = argv.index("--out")
        out_path = argv[i + 1]
        del argv[i:i + 2]
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = launcher.build_parser().parse_args(
        ["--engine", "continuous", "--requests", "8",
         "--mixed-lengths", "4,8,16,32", "--temperature", "0"] + argv)

    runs, streams = {}, {}
    for name in ("cold", "warm"):
        engine, meta = launcher.prepare(args)
        trajs, seconds = launcher.run(args, engine)
        launcher.report(args, engine, trajs, seconds, meta)
        streams[name] = _streams(trajs)
        st = collect_serve_stats(engine)
        runs[name] = {"seconds": seconds, "tokens_out": st["tokens_out"],
                      "tokens_per_s": st["tokens_out"] / seconds,
                      "decode_steps": st["decode_steps"],
                      "prefill_dispatches": st["prefill_dispatches"],
                      "ttft_p50_ms": st["ttft_p50_ms"],
                      "ttft_p99_ms": st["ttft_p99_ms"],
                      "inter_token_p50_ms": st["inter_token_p50_ms"],
                      "inter_token_p99_ms": st["inter_token_p99_ms"]}

    from torch.profiler import ProfilerActivity, profile

    engine, _ = launcher.prepare(args)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trajs, seconds = launcher.run(args, engine)
    if _streams(trajs) != streams["warm"]:
        raise SystemExit("the profiled run served other tokens than the "
                         "warm run; its busy time does not fit that wall")
    wall_ms = runs["warm"]["seconds"] * 1e3
    profiled_wall_ms = seconds * 1e3
    top, busy_ms, rows = _kernel_table(prof)
    ours = {}
    for name in kernels.launch_counts():
        tag = "kv_write_kernel" if name == "paged_kv_write" \
            else f"{name}_kernel"
        evs = [e for e in rows if tag in e.key]
        n = sum(e.count for e in evs)
        t = sum(e.self_device_time_total for e in evs) / 1e3
        ours[name] = {"launches": n, "device_ms": t,
                      "device_ms_per_launch": t / n if n else None}
    launches_total = sum(e.count for e in rows)
    # One attention launch per layer per model pass (decode or varlen).
    passes = (ours["paged_attention"]["launches"]
              + ours["paged_attention_varlen"]["launches"]) \
        / engine.bundle.cfg.n_layers
    result = {
        "device": torch.cuda.get_device_name(0),
        "config": engine.bundle.cfg.name,
        "layers": engine.bundle.cfg.n_layers,
        "runs": runs,
        "profiled": {
            "wall_ms": wall_ms,
            "profiled_wall_ms": profiled_wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_idle_share_profiled_wall":
                1.0 - busy_ms / profiled_wall_ms,
            "cuda_kernel_launches": launches_total,
            "model_passes": passes,
            "launches_per_model_pass": launches_total / max(passes, 1),
            "paged_kernels": ours,
            "top_kernels": top,
        },
    }
    text = json.dumps(result)
    print(text)
    if out_path:
        with open(out_path, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""``chip_smoke._kernel_rows`` reads a ``torch.profiler`` capture's raw
Kineto records and must group them as ``key_averages`` does (same names,
summed durations and record counts), since every device time and idle
share the script reports comes from it.  On the card it reads CUDA
kernels; here the same code reads a CPU capture of ops that do not nest:
``key_averages`` also folds a CPU op into a parent of the same name
(``aten::sum`` calls ``aten::sum``), which device records, having no
parents, never need."""

import sys
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def test_kernel_rows_match_key_averages():
    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(300):
            torch.relu(x + 1)
    rows = chip_smoke._kernel_rows(prof, DeviceType.CPU)
    want = {e.key: (e.cpu_time_total / 1e3, e.count)
            for e in prof.key_averages()}
    assert rows and {name for name, _, _ in rows} == set(want)
    for name, ms, n in rows:
        assert n == want[name][1], name
        assert abs(ms - want[name][0]) <= 1e-9 + 1e-9 * want[name][0], name
    assert [r[1] for r in rows] == sorted((r[1] for r in rows), reverse=True)

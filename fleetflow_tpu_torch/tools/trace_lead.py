"""How often torch.profiler loses the first device records of a trace.

    python3 fleetflow_tpu_torch/tools/trace_lead.py [SECONDS]

For SECONDS (default 60) it traces, in turn, three ways of starting a
CUDA trace: at once; after one kernel and a sync; and after one kernel, a
sync and ``obs.CUDA_TRACE_LEAD_S`` of sleep. Each trace holds a small
pageable upload (``torch.tensor([1, 2, 3], device="cuda")``) in a
``record_function`` range, ten 2048x2048 matmuls, and a second upload.
An upload is seen when its "Memcpy HtoD" device record is linked to a
host op inside its range. Between rounds the process makes 200 small
launches outside any trace. Prints, for each way, the traces, the missed
first and second uploads and the traces short of two host-to-device
records (the device records were lost, not unlinked), then up to four
misses in full.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import time


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from fleetflow_tpu_torch.obs import CUDA_TRACE_LEAD_S
    if not torch.cuda.is_available():
        print("trace_lead: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    x = torch.randn(2048, 2048, device=dev)

    def seen(prof, name):
        roots = [e for e in prof.events() if e.name == name
                 and str(e.device_type).endswith("CPU")]
        n, stack = 0, list(roots)
        while stack:
            ev = stack.pop()
            n += sum("HtoD" in k.name for k in ev.kernels)
            stack.extend(ev.cpu_children)
        return n

    def one(warm, lead):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if warm:
                torch.zeros(1, device=dev).add_(1)
                torch.cuda.synchronize()
            time.sleep(lead)
            with record_function("trace_lead.first"):
                torch.tensor([1, 2, 3], device=dev)
            torch.cuda.synchronize()
            for _ in range(10):
                x @ x
            torch.cuda.synchronize()
            with record_function("trace_lead.second"):
                torch.tensor([1, 2, 3], device=dev)
            torch.cuda.synchronize()
        raw = prof.profiler.kineto_results
        t0 = raw.trace_start_ns()
        return dict(first=seen(prof, "trace_lead.first"),
                    second=seen(prof, "trace_lead.second"),
                    device_h2d_us=[(e.start_ns() - t0) / 1e3
                                   for e in raw.events()
                                   if "HtoD" in e.name()])

    ways = {"at once": (False, 0.0), "kernel and sync": (True, 0.0),
            f"kernel, sync, {CUDA_TRACE_LEAD_S} s": (True,
                                                     CUDA_TRACE_LEAD_S)}
    stats = collections.defaultdict(collections.Counter)
    misses = []
    end = time.time() + float(sys.argv[1] if len(sys.argv) > 1 else 60)
    i = 0
    while time.time() < end:
        for way, (warm, lead) in ways.items():
            r = one(warm, lead)
            st = stats[way]
            st["traces"] += 1
            st["first_missed"] += r["first"] == 0
            st["second_missed"] += r["second"] == 0
            st["short_of_two_records"] += len(r["device_h2d_us"]) < 2
            if (not r["first"] or not r["second"]) and len(misses) < 4:
                misses.append(dict(way=way, **r))
        for _ in range(200):
            torch.tensor([i], device=dev).add_(1)
        i += 1
    print(json.dumps({k: dict(v) for k, v in stats.items()}), flush=True)
    print(json.dumps(misses), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

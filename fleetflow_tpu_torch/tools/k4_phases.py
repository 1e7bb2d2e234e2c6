"""Split K4 (the batched greedy seed) into its phases on the card.

    python3 fleetflow_tpu_torch/tools/k4_phases.py

K4 is one cooperative launch that walks every batch and round itself, so a
profiler sees one kernel. This tool builds ``csrc/k4_greedy.cu`` with
``-DK4_PHASES`` (the kernel's own timer stamps) and the package's nvcc
flags into ``_ext_build/k4-phases/``, runs it on the 10k x 1k fleet
(synthetic_problem(10000, 1000, seed=0, n_tenants=8, port_fraction=0.2,
volume_fraction=0.1), its placement order, batch 256, 2 rounds), checks
the assignment against the plain version, and prints, per batch-round,
the median and the sum over the rounds of: choose (block 0 starts it to
the last block done), the grid barrier after it, block 0's commit, and the
barrier after that. The device's global timer ticks in ~1 µs steps on the
H100: medians and sums over the rounds are what it resolves.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from fleetflow_tpu_torch import _ext
    from fleetflow_tpu_torch.lower import tensors as lower
    from fleetflow_tpu_torch.solver import greedy, problem

    out_dir = os.path.join(root, "fleetflow_tpu_torch", "_ext_build",
                           "k4-phases")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libk4phases.so")
    subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, "-DK4_PHASES", "-I",
                    str(_ext._CSRC), str(_ext._CSRC / "k4_greedy.cu"), "-o",
                    so], check=True)
    lib = ctypes.CDLL(so)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    pt = lower.synthetic_problem(10_000, 1_000, seed=0, n_tenants=8,
                                 port_fraction=0.2, volume_fraction=0.1)
    prob = problem.prepare_problem(pt, dev)
    order = torch.tensor(greedy.placement_order(
        pt.demand, pt.dep_depth, problem.unify_conflict_ids(pt)),
        dtype=torch.int32, device=dev)
    S, N, G, M = prob.S, prob.N, prob.G, 256
    n_batches = -(-S // M)
    stamps = torch.zeros(n_batches * 2 * 8, dtype=torch.int64, device=dev)
    if lib.ff_k4_set_phases(ctypes.c_void_p(stamps.data_ptr())) != 0:
        raise SystemExit("k4_phases: cannot set the stamp buffer")

    def run():
        # the arguments of greedy.greedy_place_batched's launch
        a = torch.empty(S, dtype=torch.int32, device=dev)
        load = torch.empty((N, 4), dtype=torch.float32, device=dev)
        taken = torch.empty((G, -(-N // 32)), dtype=torch.int32, device=dev)
        scratch = torch.empty(3 * M + 4 + 3 * n_batches, dtype=torch.int32,
                              device=dev)
        args = [S, N, G, prob.demand, prob.capacity, prob.conflict_ids,
                prob.conflict_ids.shape[1], prob.eligible,
                int(prob.eligible_packed), prob.eligible.shape[1],
                prob.node_valid, prob.preferred, prob.strategy, order, M, 2,
                a, load, taken, scratch]
        c_args = [_ext._c_arg(x) for x in args]
        c_args.append(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        err = lib.ff_k4_greedy(*c_args)
        if err != 0:
            raise SystemExit(f"k4_phases: CUDA error {err}")
        return a

    ref = greedy.greedy_place_batched_plain(prob, order)
    for _ in range(3):
        stamps.zero_()
        out = run()
        torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise SystemExit("k4_phases: the instrumented seed differs from the "
                         "plain version")
    t = stamps.view(n_batches * 2, 8).cpu().numpy().astype(np.float64)
    t = t[t[:, 0] > 0]
    parts = {"choose": (t[:, 1] - t[:, 0]) / 1e3,
             "barrier_1": (t[:, 2] - t[:, 1]) / 1e3,
             "commit": (t[:, 3] - t[:, 2]) / 1e3,
             "barrier_2": (t[:, 4] - t[:, 3]) / 1e3}
    total = (t[-1, 4] - t[0, 0]) / 1e3
    print(f"batch-rounds {len(t)}, {total:.1f} us from the first to the "
          f"last; per round, median (sum) us: " + ", ".join(
              f"{k} {np.median(v):.2f} ({v.sum():.1f})"
              for k, v in parts.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

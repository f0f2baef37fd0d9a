"""Time the reverse Riccati kernel's call of one checkout, to compare two
checkouts on one card.

    python dilqr_tpu_torch/tools/ab_riccati_fused.py --tree DIR

DIR is the root of a checkout of this repository (``.`` for this one): its
``dilqr_tpu_torch`` is imported and its kernels built. Times
``ops/cuda/riccati_fused.riccati_fused(n_state, C, c, F, u, ...)``, the
call the plain iLQR loop's Riccati backward makes, at four shapes (T=20,
random SPD costs, F of scale 0.3, u of unit scale, from fixed seeds):
n_state 5 at B=4096 in box mode with C expanded from one matrix (the
learned-model serving call), n_state 5 at B=1024 in zero mode (a third of
the controls masked), n_state 6 at B=1024 in box mode (the slew-rate
shape) and n_state 5 at B=4096 in free mode. Prints one JSON line with the
card's name and power limit and, for each shape, the median and the runs
of the call (CUDA events around it, after a warm-up: host gaps included),
``kernel_ms``, the mean duration of the Riccati kernel's launches that
torch.profiler recorded over ``--reps`` calls back to back, with
``launches_seen`` (the profiler records only some launches of a burst),
and ``device_ms``, the device's busy time per call over those calls (the
union of all device activities' intervals, the call's other kernels
included).
Run it on two checkouts in turns (A B B A) on one card, one run after the
other: runs on two cards, or at two power limits, do not compare.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

SHAPES = (("nx=5 B=4096 box, C expanded", 5, 4096, "box", True),
          ("nx=5 B=1024 zero", 5, 1024, "zero", False),
          ("nx=6 B=1024 box", 6, 1024, "box", False),
          ("nx=5 B=4096 free", 5, 4096, "free", False))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="root of the checkout to time")
    ap.add_argument("--reps", type=int, default=21, help="timed calls per shape")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    from dilqr_tpu_torch.ops.cuda import riccati_fused as ric

    if not torch.cuda.is_available():
        sys.exit("ab_riccati_fused needs an NVIDIA GPU")
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()

    def ms(fn, reps):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            runs.append(a.elapsed_time(b))
        return statistics.median(runs), runs

    def profiled(fn, reps):
        """(mean Riccati-kernel launch, launches recorded, busy time per call)"""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        host = {e.name for e in events if e.device_type == DeviceType.CPU}
        device = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in host
                  and not getattr(e, "is_user_annotation", False)]
        runs = [e.time_range.end - e.time_range.start for e in device if "riccati" in e.name]
        spans = sorted((e.time_range.start, e.time_range.end) for e in device)
        busy, end = 0.0, float("-inf")
        for a, b in spans:
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        kernel = sum(runs) / len(runs) / 1e3 if runs else float("nan")
        return kernel, len(runs), busy / 1e3 / reps

    rows = {}
    T = 20
    for i, (label, nx, B, mode, expanded) in enumerate(SHAPES):
        gen = torch.Generator(device="cpu").manual_seed(200 + i)
        n = nx + 1
        A = torch.randn(T, B, n, n, generator=gen)
        parts = (A @ A.transpose(-1, -2) + 2.0 * torch.eye(n), torch.randn(T, B, n, generator=gen),
                 0.3 * torch.randn(T - 1, B, nx, n, generator=gen),
                 torch.randn(T, B, 1, generator=gen), torch.rand(T, B, 1, generator=gen) < 0.3)
        C, c, F, u, uz = (a.to(dev) for a in parts)
        if expanded:
            C = C[0, 0].expand(T, B, n, n)
        kw = {"box": dict(u_lower=-1.0, u_upper=1.0), "zero": dict(u_zero_I=uz),
              "free": {}}[mode]

        def call():
            return ric.riccati_fused(nx, C, c, F, u, **kw)

        med, runs = ms(call, args.reps)
        kernel, seen, busy = profiled(call, args.reps)
        rows[label] = {"ms": med, "runs": runs, "kernel_ms": kernel, "launches_seen": seen,
                       "device_ms": busy}
    print(json.dumps({"tree": args.tree, "card": card, "times": rows}), flush=True)


if __name__ == "__main__":
    main()

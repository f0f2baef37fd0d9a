"""Time the module-KKT VJP of one checkout at chip_smoke.py's shapes, to
compare two checkouts on one card.

    python dilqr_tpu_torch/tools/ab_kkt_fused.py --tree DIR

DIR is the root of a checkout of this repository (``.`` for this one): its
``dilqr_tpu_torch`` is imported and its kernels built. Times, with CUDA
events after a warm-up, ``diff/kkt.make_kkt_vjp(...)(g_x, g_u, wants=...)``
in the "Ff" form (what each IFT GMRES matvec runs) and the full form, so
two checkouts are timed through the same entry point whatever each runs
behind it (a kernel and its assembly, one kernel launch, or the plain
scans for a shape the checkout's kernel does not cover). The shapes are
chip_smoke.py's phase-5 ones, T=20: the cartpole (5,1) at B=4096, the
rocket (13,3) at B=1024, the learned model's (5,1) and the slew rate's
(6,1) at B=1024, on random SPD costs, a contracting F and a third of the
controls frozen, from fixed seeds. Prints one JSON line with the card's
name and power limit and, for each shape and form, the median and the runs
of the call (CUDA events around it: the device's time from the call's
start to its end, host gaps included) and ``device_ms``, the time the
device was busy per call (the union of the device activities' intervals
under torch.profiler, over ``--reps`` calls back to back).
Run it on two checkouts in turns (A B B A) on one card, one run after the
other: runs on two cards, or at two power limits, do not compare.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

SHAPES = (("cartpole (5,1) B=4096", 5, 1, 4096), ("rocket (13,3) B=1024", 13, 3, 1024),
          ("learned model (5,1) B=1024", 5, 1, 1024), ("slew rate (6,1) B=1024", 6, 1, 1024))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="root of the checkout to time")
    ap.add_argument("--reps", type=int, default=21, help="timed calls per shape and form")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    from dilqr_tpu_torch.diff.kkt import make_kkt_vjp

    if not torch.cuda.is_available():
        sys.exit("ab_kkt_fused needs an NVIDIA GPU")
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

    def device_ms(fn, reps):
        """Busy time of the device per call: the union of the intervals of
        the device activities of ``reps`` calls, over reps."""
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
        spans = sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == DeviceType.CUDA and e.name not in host
                       and not getattr(e, "is_user_annotation", False))
        busy, end = 0.0, float("-inf")
        for a, b in spans:
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        return busy / 1e3 / reps

    rows = {}
    T = 20
    for i, (label, nx, nu, B) in enumerate(SHAPES):
        gen = torch.Generator(device="cpu").manual_seed(100 + i)
        n = nx + nu
        A = torch.randn(T, B, n, n, generator=gen)
        parts = (A @ A.transpose(-1, -2) + 2.0 * torch.eye(n), torch.randn(T, B, n, generator=gen),
                 (0.5 / n ** 0.5) * torch.randn(T - 1, B, nx, n, generator=gen),
                 torch.randn(T, B, nx, generator=gen), torch.randn(T, B, nu, generator=gen),
                 torch.rand(T, B, nu, generator=gen) < 0.3)
        C, c, F, x, u, uz = (a.to(dev) for a in parts)
        gx = torch.randn(T, B, nx, generator=gen).to(dev)
        gu = torch.randn(T, B, nu, generator=gen).to(dev)
        vjp = make_kkt_vjp(nx, nu, C, c, F, x, u, u_zero_I=uz)
        for wants in ("Ff", "full"):
            med, runs = ms(lambda: vjp(gx, gu, wants=wants), args.reps)
            busy = device_ms(lambda: vjp(gx, gu, wants=wants), args.reps)
            rows[f"{label} {wants}"] = {"ms": med, "runs": runs, "device_ms": busy}
    print(json.dumps({"tree": args.tree, "card": card, "times": rows}), flush=True)


if __name__ == "__main__":
    main()

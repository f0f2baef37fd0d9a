#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dilqr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. require a CUDA device and the package beside this script; print the
     card's name and power limit;
  2. build every CUDA kernel of the main paths from csrc/ (nvcc, sm_90a),
     one nvcc per source, all started together (the whole-solve iLQR, the
     KKT VJP, the reverse Riccati, phase 8's LinDx shapes and the three
     phase 13's gradient fuzz draws, phase 9's jvp libraries and phase
     10's MLP shapes, one library each), and print
     the build seconds and the
     ptxas report, with each whole-solve and KKT instantiation's registers,
     stack and spills; a whole-solve instantiation missing (17: the envs
     and their slew-rate wrappers by cost form and block size) fails, and
     a stack or a spill fails in a whole-solve n_ctrl == 1 instantiation,
     in the KKT instantiations the main paths run (8 lanes for one
     control, 16 for three) or in any of the Riccati kernel's 21
     instantiations (lane teams of 4, 8, 16, 32, n_state 5 and 6 compiled
     in at 8 lanes, and the looped form, each in three modes);
  3. hold each kernel against its plain PyTorch version on the card, on the
     same inputs, at the shapes of the main paths: the whole-solve kernel on
     the cartpole bench problem and three more, and on the rocket (13
     states, 3 controls, the in-kernel box-QP) at bench.py's start with its
     +-20 box and on a ragged two-tile batch with active per-control bounds
     (its active sets compared per control and per step); and the same
     bits from every cluster size the kernel instantiates (8 and 16 blocks
     a tile) on the cartpole bench case and the rocket's active-bound case;
     the KKT-VJP kernel's whole call (one launch, the dF/df/dC assembly
     in it), in its full and "Ff" forms, on the cartpole bench solution,
     five random shapes, the rocket bench solution and, with a generator of
     their own, the shapes JAX's whole gate brought ((6,1), (16,1), (15,2),
     (14,3)), and the same bits from other block sizes and the global
     store;
     then (appended, with a generator of its own) the Riccati kernel in its
     free, box, zero and delta_u modes for n_state 1..9, 12, 16, 24, 31, 48
     (the looped form) and one size whose team memory lies in device
     memory, on C expanded, a bound tensor, a transposed C view and T = 1
     and 2, with the same bits from every block size and team store (see
     check_riccati), and the learned MLP cartpole model's solve with and
     without it;
  4. drive the main paths through their entry points, every launch counter
     set to 0 just before each and read just after:
     serving -- MPC.solve (what MPC.__call__ runs) on cartpole at B=4096
     and B=16384 and receding_horizon at B=1024; the same on the rocket at
     B=1024 and B=16384 and receding_horizon at B=1024; the learned model
     (hidden 100) at B=4096 and in receding_horizon at B=1024 against the
     true cartpole plant;
     training -- the IFT gradient of bench.py's imitation loss at B=4096
     (with and without detach_unconverged), the KKT gradient through
     MPC's defaults, bench.py's imempc train step for 3 steps, ILExp
     (imempc) for 2 epochs on data/cartpole.npz, the IFT gradient of
     bench.py's rocket loss at B=1024 and of the learned model's weights;
     the Riccati kernel's other modes -- the unboxed and the u_zero_I
     learned-model solve -- and the slew-rate cartpole in receding_horizon
     and its IFT gradient, whose forward is the whole-solve kernel
     (Passthrough<Cartpole>) and whose backward the KKT kernel at (6,1);
  5. time the kernels (CUDA events, warm-up, median; the whole-solve kernel
     at each cluster size), print each whole-solve instantiation's
     cudaOccupancyMaxActiveClusters, the clusters of a launch, the SMs its
     blocks ran on and the votes a tile took with their clock share, the
     KKT kernel's "Ff" and full calls at cartpole B=4096, the rocket's
     (13,3), the learned model's (5,1) and the slew rate's (6,1) at B=1024
     beside their bounds, the IFT forward and backward, the train step, the
     Riccati call and the kernel alone at n_state 5 (B=4096 and 1024, C
     full and expanded) and 6 (B=1024) beside their bounds with the device
     operations a call, and the learned-model solve with and without the
     Riccati kernel, and print one JSON line with each kernel's
     numbers. The learned-model and slew-rate paths of phase 4 and their
     times run last, after the earlier paths' times, which thus keep
     their earlier order;
  6. the associative-scan Riccati, the LSTM policy and the utilities (see
     parallel_paths): plqr_backward and plqr_solve against the sequential
     recursion on CUDA tensors at the bench width, with a u_zero_I mask,
     the rocket width and T=512, at f64 and f32, with both paths' times;
     the cartpole IFT gradient at B=4096 with riccati_parallel (no KKT
     launch) against the default; the unboxed learned-model solve with
     riccati_parallel (no Riccati launch) against the Riccati kernel;
     ILExp mode 'nn' for 2 epochs on data/cartpole.npz; numdiff.grad at
     f64 against the cartpole's analytic Jacobian; the verbose table;
  7. the whole-solve kernel's MPC variants and the slew rate (see
     variant_paths): each variant -- a per-example cost, per-time and
     per-example bounds, u_zero_I boxed and unboxed, delta_u, the slew
     rate on cartpole, the pendulum and the rocket (Passthrough<Env>) --
     against its plain version at full width and the same bits at every
     cluster size; the serving paths with these options (MPC.solve,
     receding_horizon) and the slew-rate IFT gradient through their entry
     points, one whole-solve launch a solve and no Riccati launch; each
     path's time against backend="torch" in turns, and the device idle
     share of one profiled slew-rate step;
  8. LinDx (time-varying affine LQR) problems and n_ctrl 2..8 on the
     whole-solve kernel (see lindx_paths; LinDx<NX, NU>, one library per
     shape, built in phase 2 with the rest, a stack or spill failing at
     (3,2) and at one control with up to 6 states): each case against its
     plain version at each cluster size -- the slice's (3,2) at B=4096
     boxed, unboxed, masked, with delta_u, per-time bounds and an
     example-invariant cost, its slew rate (5,2), n_ctrl 4..8, the gate's
     edges (15,2) and (11,8), one control at (6,1) and (15,1); MPC on a
     LinDx with and without the slew rate (one whole-solve launch, no
     Riccati launch) and the IFT gradient (the KKT kernel backward)
     against the plain backward; the kernel and MPC at B=4096 and 135168
     against backend="torch" in turns, and the idle share of one MPC call;
  9. the whole-solve kernel's jvp sweep (see jvp_paths; JvpJac, one
     library per env and method from csrc/ilqr_jvp.cu, built in phase 2
     with the rest, a stack or spill failing at one control): AUTO_DIFF on
     cartpole, the pendulum and the rocket, the complex pendulum and the
     renormalizing rocket under both methods, and the slew rate of each,
     against the plain version at each cluster size; MPC and
     receding_horizon on the complex pendulum, cartpole and the
     renormalizing rocket under AUTO_DIFF (one launch a solve), the AUTO_DIFF
     IFT gradients against the plain backward, ILExp on pendulum-complex;
     each serving path against backend="torch" in turns, and the idle share
     of one complex-pendulum MPC call;
 10. the small MLP on the whole-solve kernel (see small_mlp_paths; Mlp
     with its hand Jacobian for one hidden layer, else JvpJac<Mlp>, one
     library per shape, activation, slew rate and cost form from
     csrc/ilqr_mlp.cu, built in phase 2 with the rest, a stack or spill
     failing at one control): each shape JAX's gate admits, against its
     plain version at each cluster size; MPC.solve and receding_horizon on
     the reference golden's MLP (tests/goldens/nn_dynamics.npz) at B=4096,
     one launch a solve, MPC.solve against backend="torch" in turns, with
     the idle share of one call; the IFT gradient with respect to its weights
     against the plain backward; the learned model at hidden 100 (1,205
     weights, one hidden layer, past JAX's 256; its one library built and
     gated in phase 2) at its cell's B=16,384 against its plain version
     under both methods, and in MPC.solve taking one whole-solve launch
     and no Riccati launch;
 11. the batch sharded over ranks and devices (see multihost_paths;
     parallel/{multihost,mesh,audit}.py): multihost_solve and one
     multihost_train_step in a one-rank NCCL group, with the bits of solve
     and within 1e-6 of the one-process step, their collectives audited,
     multihost_solve's host time against solve's in turns, sharded_solve
     over the card twice; then two ranks over gloo on the one card, one
     process each (tools/multihost_demo.py): 4096 + 4096 with the
     one-process kernel solve's bits, the train step at 2 x 1024, the padded
     uneven 4096 + 1000, every rank's launches and collectives;
 12. torch.func.vmap over the solve (see vmap_paths; the vmap rule of
     diff/modes._SolveWithGrad) on bench.py's cartpole: 8 control weights x
     B=4096 through MPC.solve as one whole-solve launch with each
     candidate's bits, a ragged x_init sweep with the hand-folded solve's
     bits, a params sweep at one launch a candidate, the IFT gradient
     through a sweep (one backward on the folded batch) against the
     hand-folded solve's, the sweep against a loop of its solves in turns,
     the folded launch beside its bound and plain version, the idle share
     of one sweep and examples.cost_sweep once;
 13. per-candidate gradients (see pergrad_paths; the vmap rules of
     diff/modes._SolveBackward and _Unrolled) on bench.py's cartpole:
     vmap(grad) over 8 control weights x B=4096 as one whole-solve launch
     and one folded backward, with the hand-folded backward's KKT launches
     and gradients (the params' reduced per candidate) and each candidate
     near its solo gradient; jacrev of the mean terminal state as one
     folded backward against the one-hot loop; UNROLL and delta_u sweeps
     with each candidate's bits; tools/fuzz_gradients on the card (6 cases,
     --vmap 2); the sweep against the loop of its solo gradients in turns,
     the idle share of one sweep and the folded KKT call beside its bound;
 14. a user's own model and a callable cost on the whole-solve kernel (see
     user_paths; ops/cuda/traced.py traces them with torch.fx into C++,
     csrc/ilqr_user.cu for the model, the DILQR_CALLABLE_COST build of
     csrc/ilqr_fused.cu for the cost, built in phase 2 with the rest, their
     ptxas registers and spills printed, not gated): the 4-state, 2-control
     double pendulum written here as a user writes it, box +-1.5, under
     ANALYTIC and AUTO_DIFF at B=4096, T=20, lqr_iter 20 against its plain
     version on the converged examples (phase 9's bar) and at each cluster
     size, MPC.solve through the kernel (one launch) against
     backend="torch" in turns (under ANALYTIC), each beside the bound from
     traced.py's operation count; a traced copy of the cartpole step (no
     device code) under AUTO_DIFF against env 0's jvp library, the two
     times side by side; the pendulum with a callable cost with params
     against its plain version, the IFT gradient with respect to the cost
     params with the forward on the kernel against backend="torch", and a
     weight the cost captures changed in place between solves; and the route
     check: a step that captures an array takes no whole-solve launch and
     backend="cuda" raises;
 15. print the JSON line, the nvidia-smi line, then the result line
     {"ok": true, "device": {...}} last.

It imports nothing of JAX and nothing of the JAX package. The weights of
this system are the dynamics parameters and the cost; they are the
cartpole's and the rocket's published defaults and, for the learned model,
1,205 MLP weights drawn from a numpy seed; phase 10's MLPs take the
reference golden's 147 weights or weights from a seed; the initial states
come from a seed.
"""
from __future__ import annotations

import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time

SEED = 0
FP32_PEAK = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s
FP64_PEAK = 34e12  # H100 SXM float64 outside the tensor cores, FLOP/s (data sheet)
HBM_RATE = 3.35e12  # H100 SXM device memory, bytes/s


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def fmt_ms(ms: float) -> str:
    """A profiler reading in milliseconds, or "not measured" where the
    window lost a launch (utils/profiling.kernel_ms gives NaN)."""
    return "not measured" if math.isnan(ms) else f"{ms:.4f} ms"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def host_ms(fn, reps: int = 3, warmup: bool = True):
    """Median milliseconds of fn() by the host clock, synchronized before
    and after each run, after one warm-up run."""
    import torch

    if warmup:
        fn()
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t1) * 1e3)
    return statistics.median(ts)


def host_ms_in_turns(fns, rounds: int = 3, warm_both: bool = True, b_once: bool = False):
    """Median host-clock milliseconds of each of two calls, timed in turns
    (a b b a, a b b a, ...) after one warm-up run of each, so that a slow
    stretch of the host falls on both. warm_both False warms the first
    only: the kernel paths against the plain loop, whose second is a
    host-bound PyTorch loop of seconds on kernels every earlier phase ran
    (its discarded warm-up took a minute of the run's time limit). b_once:
    a round is a b a, the second call once between two of the first (the
    plain loop of phases 7 and 9, whose second run took a minute of the
    script's fixed time limit, which phase 13 needed)."""
    (na, fa), (nb, fb) = fns.items()
    fa()
    if warm_both:
        fb()
    ts = {na: [], nb: []}
    for _ in range(rounds):
        for name in (na, nb, na) if b_once else (na, nb, nb, na):
            ts[name].append(host_ms(fns[name], reps=1, warmup=False))
    return {name: (statistics.median(v), v) for name, v in ts.items()}


def cuda_ms(fn, warmup: int, reps: int):
    """Median milliseconds of fn() on the card, CUDA events around each run."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), times


def drive(torch, kernels, total, label, fn, want=None):
    """Run fn with every launch counter set to 0 just before and read just
    after; add the counts to ``total``. want: kernel -> the launches it
    must make (None: at least one); by default every kernel at least once.
    Returns (fn's result, the counts)."""
    for m in kernels.values():
        m.LAUNCHES = 0
    out = fn()
    torch.cuda.synchronize()
    got = {name: m.LAUNCHES for name, m in kernels.items()}
    print(f"{label}: launches {got}", flush=True)
    for name, n in (want or dict.fromkeys(kernels)).items():
        if (got[name] == 0) if n is None else (got[name] != n):
            fail(f"{label}: {got[name]} launches of {name}, want {'some' if n is None else n}")
    for name in total:
        total[name] += got[name]
    return out, got


def parity(torch, fused, name, dyn, params, cfg, x0, cost_small, u0, lo, hi,
           converged_only=False, conv_eps=None, **kw):
    """The whole-solve kernel against its plain version on the same inputs.
    Tolerances (f32). n_iter must be equal. Per-example costs must agree to
    rtol 1e-4 on at least 99% of the examples and to 1e-2 on all: an
    example that is still iterating when lqr_iter ends (the pendulum
    swing-ups) amplifies one-ulp differences -- a line-search step accepted
    in one version and rejected in the other -- into another path, a few
    per thousand by up to ~1e-3 (PERF.md). x and u must agree to 1e-2 and
    2e-2 on every example: at bang-bang switching points u moves by about
    1e-2 between two equally converged optima (docs/DESIGN.md:103-107); the
    examples past the CPU tests' 2e-3 are counted and printed. Returns (the
    largest |kernel - plain| of x and u, the kernel's output, the plain
    version's output). kw: the variants (u_zero_I, delta_u), passed to both.
    converged_only: the x and u bounds hold on the examples converged in
    both versions (du < eps); an example still iterating when lqr_iter ends
    may pass them (ROADMAP C: f32 rounding alone moves such an example's u
    by up to ~1e-1), which is counted and printed (``parity.past``).
    conv_eps: the du below which an example counts as converged, by default
    cfg.eps (a solve compared at eps=0, where every tile runs lqr_iter
    iterations in both versions, names its own)."""
    k_out = fused.ilqr_fused(cfg, dyn, params, x0, cost_small, u0, lo, hi, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    r_out = fused.ilqr_fused_reference(cfg, dyn, params, x0, cost_small, u0, lo, hi, **kw)
    torch.cuda.synchronize()
    parity.plain_ms = (time.perf_counter() - t1) * 1e3
    kx, ku, kc, kdu, kn = k_out
    rx, ru, rc, rdu, rn = r_out
    if not (torch.isfinite(kc).all() and torch.isfinite(ku).all()):
        fail(f"{name}: non-finite kernel output")
    cost_rel = (kc - rc).abs() / rc.abs().clamp(min=1e-6)
    ex_u = (ku - ru).abs().amax(dim=(0, 2))
    ex_x = (kx - rx).abs().amax(dim=(0, 2))
    n_cost = int((cost_rel > 1e-4).sum())
    print(f"parity {name}: cost rel max {cost_rel.max().item():.2e} (past 1e-4: "
          f"{n_cost}/{x0.shape[0]}), u max {ex_u.max().item():.2e} (past 2e-3: "
          f"{int((ex_u > 2e-3).sum())}), x max {ex_x.max().item():.2e}, "
          f"n_iter {int(kn)} vs {int(rn)}", flush=True)
    if cost_rel.max().item() > 1e-2 or n_cost > 0.01 * x0.shape[0]:
        fail(f"{name}: costs disagree past their tolerance")
    if int(kn) != int(rn):
        fail(f"{name}: n_iter {int(kn)} (kernel) != {int(rn)} (plain)")
    past = (ex_x > 1e-2) | (ex_u > 2e-2)
    parity.past = past
    if converged_only:
        ce = cfg.eps if conv_eps is None else conv_eps
        conv = (kdu < ce) & (rdu < ce)
        if bool((past & conv).any()):
            fail(f"{name}: x or u past its bound (1e-2, 2e-2) on a converged example")
        if bool(past.any()):
            print(f"parity {name}: {int(past.sum())} examples past (1e-2, 2e-2), none of them "
                  f"converged in both (u max {ex_u[past].max().item():.2e}); on the "
                  f"{int(conv.sum())} converged in both: u max "
                  f"{ex_u[conv].max().item() if bool(conv.any()) else 0.0:.2e}", flush=True)
        ok = conv if bool(past.any()) else torch.ones_like(conv)
        return max(ex_u[ok].max().item(), ex_x[ok].max().item()), k_out, r_out
    if bool(past.any()):
        fail(f"{name}: x or u past its bound (1e-2, 2e-2)")
    return max(ex_u.max().item(), ex_x.max().item()), k_out, r_out


def ptxas_entries(report: str, entry: str, what: str):
    """(instantiation, registers, stack bytes, spill store bytes, spill load
    bytes) of each kernel in an nvcc -Xptxas -v report whose mangled name
    matches ``entry``; the instantiation as <its template arguments>."""
    import re

    out, name, stack, st, ld = [], None, 0, 0, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '" + entry, line)
        if m:
            name = f"<{', '.join(m.groups())}>"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            stack, st, ld = (int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), stack, st, ld))
            name = None
    if not out:
        fail(f"no {what} kernel in the ptxas report")
    return out


# the whole-solve kernel as <Env, NU, block threads>; the KKT kernel as
# <NU, team lanes>
ILQR_ENTRY = (r"_ZN5dilqr(?:17ilqr_fused_kernel|20ilqr_fused_kernel_mb)INS_\d+(\w+?)ELi(\d+)"
              r"ELi(\d+)ELb(\d)E\w*?EEv")
# <Env, NU, block threads, per-example cost>: cartpole, pendulum and the
# rocket with either cost form and their slew-rate wrappers with the
# per-example one, at 128 and 64 threads a block
ILQR_KERNELS = 18
KKT_ENTRY = r"_ZN5dilqr16kkt_fused_kernelILi(\d+)ELi(\d+)EEEv"
# the KKT instantiations a main path runs: (5,1) and (6,1) at 8 lanes, the
# rocket's (13,3) at 16
KKT_MAIN = ("<1, 8>", "<3, 16>")
# the Riccati kernel as <team lanes, mode, compile-time n_state (0: any)>
# and its looped form as <mode> (modes 0 free, 1 box, 2 zero)
RICCATI_ENTRY = r"_ZN5dilqr20riccati_fused_kernelILi(\d+)ELi(\d+)ELi(\d+)EEEv"
RICCATI_KERNELS = 21  # lanes 4, 8, 16, 32 and n_state 5, 6 at 8 lanes, looped; x 3 modes
RICCATI_LOOPED_ENTRY = r"_ZN5dilqr21riccati_looped_kernelILi(\d+)EEEv"


def same_bits(torch, fused, name, k_out, args, **kw):
    """The kernel's output at every cluster size the env's instantiation
    has must be the bits of the default's (``k_out``): the per-example
    arithmetic and the tile's votes do not depend on how a tile is cut into
    blocks. An env with one cluster size is launched again at it: the same
    bits twice. kw: the variants, as parity's."""
    sizes = fused.kernel_clusters(args[0], args[1])
    for G in sizes:
        out = fused.ilqr_fused(*args, **kw, cluster=G)
        if not all(torch.equal(a, b) for a, b in zip(out, k_out)):
            fail(f"{name}: clusters of {G} blocks change the result")
    print(f"parity {name}: clusters of {sizes} blocks give the same bits", flush=True)


def cluster_report(torch, fused, card, label, args, ms):
    """Phase 5: one probed launch of the whole-solve kernel -- clusters of
    the launch, the SMs its blocks ran on, the votes each tile took and the
    share of the SM clock its rank-0 thread spent in them (the cluster
    barrier's wait included), times the kernel time ``ms``."""
    G = fused.geometry(args[3].shape[0]).cluster
    out, stats, smids = fused.ilqr_fused_probe(*args)
    votes, in_votes, total = (stats[:, i].double() for i in range(3))
    share = (in_votes / total).max().item()
    print(f"clusters {label}: {stats.shape[0]} clusters of {G} blocks in {fused.WAVES} waves, "
          f"{smids.numel()} blocks on "
          f"{len(set(smids.tolist()))} SMs; votes a tile {int(votes.min())}-{int(votes.max())}, "
          f"in votes {share:.3f} of the kernel's clock at most (about {share * ms:.3f} of "
          f"{ms:.3f} ms) [{card}]", flush=True)
    return out


def rocket_checks(name, cfg, k_out, r_out, lo, hi):
    """The rocket's cases, beyond parity's: u within 2e-3 on the examples
    that converged in both versions (du < eps), whose u the problem sets;
    an example still iterating when lqr_iter ends has a u that f32
    rounding alone moves by up to ~1e-2 (PERF.md), which parity's 2e-2
    bounds. And the kernel's active set (|u - bound| < 1e-6) equal to the
    plain version's on all but 1e-3 of each control's entries. Prints the
    shares of controls at a bound; returns the distances."""
    from dilqr_tpu_torch.tools.rounding_witness import describe, distances

    d = distances(k_out, r_out, lo, hi, cfg.eps)
    print(f"parity {name}: {describe(d)}", flush=True)
    if d["converged"] == 0 or max(d["u_max_converged"]) > 2e-3:
        fail(f"{name}: u on the converged examples past 2e-3 (or none converged)")
    entries = k_out[1].shape[0] * k_out[1].shape[1]
    if max(d["active_mismatch"]) > 1e-3 * entries:
        fail(f"{name}: active sets differ in {d['active_mismatch']} of {entries} entries")
    return d


def main():
    import torch

    # ---- 1) the card ----
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        import dilqr_tpu_torch as P
    except ImportError as e:
        fail(f"the package dilqr_tpu_torch does not import ({e}): run this script from the "
             f"root of a checkout of the repository")
    from dilqr_tpu_torch.control import receding_horizon
    from dilqr_tpu_torch.models import cartpole, pendulum, rocket
    from dilqr_tpu_torch.ops.cuda import build
    from dilqr_tpu_torch.ops.cuda import ilqr_fused as fused
    from dilqr_tpu_torch.ops.cuda import kkt_fused as kkt
    from dilqr_tpu_torch.ops.cuda import riccati_fused as ric

    dev = torch.device("cuda:0")
    kernels = {"ilqr_fused": fused, "kkt_fused": kkt, "riccati_fused": ric}
    user = user_problem(torch, P, fused, dev)

    # ---- 2) build ----
    t0 = time.perf_counter()
    reports = build.build_all([m.SOURCE for m in kernels.values()]
                              + [fused.lindx_spec(*shape) for shape in LINDX_SHAPES]
                              + fused.jvp_specs() + small_mlp_specs(fused)
                              + list(user["specs"].values()))
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(reports)} libraries (three sources, "
          f"{len(LINDX_SHAPES)} LinDx shapes, {len(fused.jvp_specs())} jvp libraries, "
          f"{len(small_mlp_specs(fused))} MLP libraries and {len(user['specs'])} traced libraries)",
          flush=True)
    for spec, rep in reports.items():
        src = spec if isinstance(spec, str) else build.library_path(spec).split("/")[-1]
        for line in rep.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry", "error")):
                print(f"ptxas[{src}]: {line.strip()}", flush=True)
    ilqr_seen = set()
    for name, regs, stack, st, ld in ptxas_entries(reports[fused.SOURCE], ILQR_ENTRY,
                                                   "whole-solve"):
        name = re.sub(r"PassthroughINS_\d+(\w+?)EE,", r"Passthrough<\1>,", name)
        print(f"ptxas ilqr_fused {name}: {regs} registers, {stack} bytes stack, {st}/{ld} bytes "
              f"spill stores/loads", flush=True)
        ilqr_seen.add(name)
        if re.search(r", (\d+), \d+, \d>$", name).group(1) == "1" and (stack or st or ld):
            fail(f"ilqr_fused {name} (n_ctrl 1) has a stack frame or spills")
    if len(ilqr_seen) != ILQR_KERNELS:
        fail(f"ilqr_fused: {len(ilqr_seen)} instantiations in the ptxas report, want "
             f"{ILQR_KERNELS}")
    kkt_seen = set()
    for name, regs, stack, st, ld in ptxas_entries(reports[kkt.SOURCE], KKT_ENTRY, "KKT-VJP"):
        print(f"ptxas kkt_fused <n_ctrl, lanes> {name}: {regs} registers, {stack} bytes stack, "
              f"{st}/{ld} bytes spill stores/loads", flush=True)
        kkt_seen.add(name)
        if name in KKT_MAIN and (stack or st or ld):
            fail(f"kkt_fused {name} (a main path's) has a stack frame or spills")
    if not kkt_seen.issuperset(KKT_MAIN):
        fail(f"kkt_fused: the ptxas report lacks {set(KKT_MAIN) - kkt_seen}")
    ric_seen = 0
    for entry, what in ((RICCATI_ENTRY, "<lanes, mode, n_state>"),
                        (RICCATI_LOOPED_ENTRY, "looped <mode>")):
        for name, regs, stack, st, ld in ptxas_entries(reports[ric.SOURCE], entry, "Riccati"):
            print(f"ptxas riccati_fused {what} {name}: {regs} registers, {stack} bytes stack, "
                  f"{st}/{ld} bytes spill stores/loads", flush=True)
            ric_seen += 1
            if stack or st or ld:
                fail(f"riccati_fused {what} {name} has a stack frame or spills")
    if ric_seen != RICCATI_KERNELS:
        fail(f"riccati_fused: {ric_seen} instantiations in the ptxas report, want "
             f"{RICCATI_KERNELS}")
    lindx_ptxas(fused, reports)
    jvp_ptxas(fused, reports)
    small_mlp_ptxas(fused, reports)
    user_ptxas(fused, reports, user)
    print(f"phase 2 ends {time.perf_counter() - t_start:.0f} s into the run", flush=True)

    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def cartpole_x0(B):
        th = math.pi / 1.05 + 0.1 * torch.randn(B, generator=gen)
        z = torch.zeros(B)
        return torch.stack([z, z, th.cos(), th.sin(), z], 1).to(dev)

    def pendulum_x0(B):
        th = -1.5 + 3.0 * torch.rand(B, generator=gen)
        w = 0.5 * torch.randn(B, generator=gen)
        return torch.stack([th.cos(), th.sin(), w], 1).to(dev)

    def cfg_for(dyn, nx, T, lqr_iter, eps):
        return P.ILQRConfig(
            n_state=nx, n_ctrl=1, T=T, lqr_iter=lqr_iter, eps=eps,
            linesearch_decay=dyn.linesearch_decay,
            max_linesearch_iter=dyn.max_linesearch_iter,
            exit_unconverged=False, detach_unconverged=False, backprop=False)

    cp_dyn, cp_params = cartpole.make(), cartpole.default_params(device=dev)
    cp_q, cp_p = cartpole.get_true_obj(device=dev)
    pd_dyn, pd_params = pendulum.make(), pendulum.default_params(device=dev)
    pd_q, pd_p = pendulum.get_true_obj(device=dev)
    T = 20
    bench_cfg = cfg_for(cp_dyn, 5, T, 20, cp_dyn.mpc_eps)

    # ---- 3) kernel against its plain version on the card (see parity) ----
    cases = [
        ("cartpole B=4096 T=20 eps=1e-4 (bench)", cp_dyn, cp_params, bench_cfg,
         cartpole_x0(4096), (torch.diag(cp_q), cp_p), None),
        ("pendulum B=1030 T=20 eps=0", pd_dyn, pd_params,
         cfg_for(pd_dyn, 3, T, 10, 0.0), pendulum_x0(1030),
         (torch.diag(pd_q), pd_p), None),
        ("pendulum B=1030 T=20 eps=1e-3", pd_dyn, pd_params,
         cfg_for(pd_dyn, 3, T, 10, 1e-3), pendulum_x0(1030),
         (torch.diag(pd_q), pd_p), None),
    ]
    scale = torch.linspace(0.5, 2.0, T, device=dev)[:, None]
    cases.append((
        "cartpole B=2048 T=20 warm start, per-time cost", cp_dyn, cp_params, bench_cfg,
        cartpole_x0(2048),
        (torch.diag_embed(scale * cp_q[None]), cp_p.expand(T, 6).contiguous()),
        (0.1 * torch.randn(T, 2048, 1, generator=gen)).to(dev),
    ))
    main_err = None
    for name, dyn, params, cfg, x0, cost_small, u0 in cases:
        err, k_out, _ = parity(torch, fused, name, dyn, params, cfg, x0, cost_small, u0, dyn.lower,
                               dyn.upper)
        if main_err is None:
            main_err = err
            same_bits(torch, fused, name, k_out, (cfg, dyn, params, x0, cost_small, u0, dyn.lower,
                                                  dyn.upper))

    # the rocket: bench.py's rocket stage (bench.py:305-347) with its +-20
    # box, which no control reaches from this start, and a ragged two-tile
    # batch with active bounds, where the box-QP's active set and its
    # per-tile Newton and Armijo votes do the work: the main thrust at most
    # 8 (hovering takes 10) and the side thrusts within +-0.1, where each
    # control sits at a bound in a fifth or more of its entries. Both are
    # held to parity's bounds and to rocket_checks'.
    rgen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    r_dyn, r_params = rocket.make(), rocket.default_params(device=dev)
    r_q, r_p = rocket.get_true_obj(device=dev)
    r_cs = (torch.diag(r_q), r_p)
    r_cfg = P.ILQRConfig(
        n_state=13, n_ctrl=3, T=T, lqr_iter=15, eps=r_dyn.mpc_eps,
        linesearch_decay=r_dyn.linesearch_decay, max_linesearch_iter=r_dyn.max_linesearch_iter,
        exit_unconverged=False, detach_unconverged=True, backprop=False)
    name = "rocket B=1024 T=20 eps=1e-3 (bench, +-20 box)"
    r_err, k_out, r_out = parity(torch, fused, name, r_dyn, r_params, r_cfg,
                                 rocket.bench_start(1024, rgen, device=dev), r_cs, None,
                                 r_dyn.lower, r_dyn.upper)
    rocket_checks(name, r_cfg, k_out, r_out, r_dyn.lower.to(dev), r_dyn.upper.to(dev))
    tight = torch.tensor([8.0, 0.1, 0.1], device=dev)
    name = "rocket B=1030 T=20 eps=1e-3, bounds +-(8, 0.1, 0.1)"
    x0 = rocket.bench_start(1030, rgen, device=dev)
    _, k_out, r_out = parity(torch, fused, name, r_dyn, r_params, r_cfg, x0, r_cs, None, -tight,
                             tight)
    same_bits(torch, fused, name, k_out, (r_cfg, r_dyn, r_params, x0, r_cs, None, -tight, tight))
    d = rocket_checks(name, r_cfg, k_out, r_out, -tight, tight)
    if min(d["active_share"]) < 0.2:
        fail(f"{name}: a control is at a bound in under 20% of its entries: {d['active_share']}")

    kkt_err, kkt_ops, kkt_rocket = check_kkt(torch, dev, gen, kkt, [
        ("cartpole bench solution", cp_dyn, cp_params, bench_cfg, cartpole_x0(4096),
         (torch.diag(cp_q), cp_p)),
        ("rocket bench solution", r_dyn, r_params, r_cfg,
         rocket.bench_start(1024, rgen, device=dev), r_cs)])

    # the reverse Riccati kernel, and the learned model's solve with and
    # without it; a generator of its own keeps the earlier cases' inputs
    mgen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    ric_err = check_riccati(torch, dev, mgen, ric)
    mlp_dyn, mlp_params = mlp_model(torch, dev, SEED)
    mlp_cost = P.QuadCost(torch.diag(cp_q), cp_p)
    mlp_parity(torch, ric, bench_cfg, mlp_dyn, mlp_params, mlp_cost,
               cartpole_start(torch, mgen, 4096, dev))
    # release what the appended cases left cached, so that the paths below
    # start from the allocator state they had before those cases existed
    reserved = torch.cuda.memory_reserved() / 2 ** 20
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 3 ends {time.perf_counter() - t_start:.0f} s into the run", flush=True)
    print(f"allocator: {reserved:.0f} MiB reserved after phase 3, "
          f"{torch.cuda.memory_reserved() / 2 ** 20:.0f} MiB after releasing the cache",
          flush=True)

    # ---- 4) the main paths through their entry points ----
    # serving
    for m in kernels.values():
        m.LAUNCHES = 0
    mpc = P.MPC(5, 1, T, u_lower=-100.0, u_upper=100.0, lqr_iter=20, eps=1e-4,
                linesearch_decay=0.5, max_linesearch_iter=2, backprop=False,
                exit_unconverged=False)
    cost = P.QuadCost(torch.diag(cp_q), cp_p)
    solves = {}
    for B in (4096, 16384):
        x0 = cartpole_x0(B)
        before = fused.LAUNCHES
        res = mpc.solve(x0, cost, cp_dyn, params=cp_params)
        torch.cuda.synchronize()
        if fused.LAUNCHES != before + 1:
            fail(f"MPC at B={B} did not go through the kernel")
        if res.x.shape != (B, T, 5) or res.u.shape != (B, T, 1):
            fail(f"MPC at B={B}: shapes {tuple(res.x.shape)}, {tuple(res.u.shape)}")
        if not (torch.isfinite(res.costs).all() and torch.isfinite(res.x).all()):
            fail(f"MPC at B={B}: non-finite output")
        if res.u.abs().max().item() > 100.0:
            fail(f"MPC at B={B}: controls outside the box")
        conv = res.converged.float().mean().item()
        solves[B] = (x0, res)
        print(f"main path MPC cartpole B={B}: n_iter {int(res.n_iter)}, mean cost "
              f"{res.costs.mean().item():.4f}, converged share {conv:.4f}", flush=True)
    before = fused.LAUNCHES
    ep = receding_horizon(bench_cfg, cp_dyn, cp_params, cost, cartpole_x0(1024), 5,
                          u_lower=cp_dyn.lower, u_upper=cp_dyn.upper)
    torch.cuda.synchronize()
    if fused.LAUNCHES - before != 5:
        fail(f"receding_horizon: {fused.LAUNCHES - before} launches for 5 steps")
    if ep.xs.shape != (1024, 6, 5) or not torch.isfinite(ep.xs).all():
        fail("receding_horizon: bad closed-loop states")
    serving = {name: m.LAUNCHES for name, m in kernels.items()}
    print(f"serving path launches: {serving}", flush=True)
    if serving["ilqr_fused"] == 0:
        fail("kernel ilqr_fused was not launched on the serving path")

    # training: every step zeroes both counters and reads them after
    train = train_path(torch, P, dev, kernels, cp_dyn, cp_params, cp_q, cp_p, bench_cfg,
                       cartpole_x0(4096))
    launches = {name: serving[name] + train["launches"][name] for name in kernels}
    print(f"main path launches (serving + training): {launches}", flush=True)
    for name in ("ilqr_fused", "kkt_fused"):
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the main path")

    # the kernel's answer on the main path, against its plain version
    x0, res = solves[4096]
    ref = fused.ilqr_fused_reference(bench_cfg, cp_dyn, cp_params, x0,
                                     (torch.diag(cp_q), cp_p), None, -100.0, 100.0)
    main_cost_rel = ((res.costs - ref[2]).abs() / ref[2].abs().clamp(min=1e-6)).max().item()
    print(f"main path B=4096 vs plain version: cost rel {main_cost_rel:.2e}", flush=True)
    if main_cost_rel > 1e-4:
        fail("main path costs disagree with the plain version")

    # the rocket's serving and training paths (counters zeroed before each)
    rk = rocket_paths(torch, P, dev, kernels, r_dyn, r_params, r_cs, r_cfg, rgen)

    # ---- 5) times ----
    print(f"phase 4 ends {time.perf_counter() - t_start:.0f} s into the run", flush=True)
    rows = []
    cs = (torch.diag(cp_q), cp_p)
    t_kernel = {}
    for B in (4096, 16384):
        x0 = cartpole_x0(B)
        ms, runs = cuda_ms(lambda: fused.ilqr_fused(bench_cfg, cp_dyn, cp_params, x0, cs,
                                                    None, -100.0, 100.0), 2, 7)
        t_kernel[B] = ms
        out = fused.ilqr_fused(bench_cfg, cp_dyn, cp_params, x0, cs, None, -100.0, 100.0)
        print(f"time ilqr_fused cartpole B={B} T={T}: {ms:.3f} ms median of {len(runs)} "
              f"({', '.join(f'{r:.3f}' for r in runs)}), {B / ms * 1e3:.0f} solves/s, "
              f"n_iter {int(out[4])} [{card}]", flush=True)
        t_e2e = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            mpc.solve(x0, cost, cp_dyn, params=cp_params)
            torch.cuda.synchronize()
            t_e2e.append((time.perf_counter() - t1) * 1e3)
        e2e = statistics.median(t_e2e)
        print(f"time MPC.solve end to end B={B}: {e2e:.3f} ms median of 5 (host clock), "
              f"{B / e2e * 1e3:.0f} solves/s [{card}]", flush=True)
    # one 1024-example tile per SM: the batch at which every SM of an H100
    # holds exactly one block
    B_full = 132 * fused.TILE
    x0 = cartpole_x0(B_full)
    ms, runs = cuda_ms(lambda: fused.ilqr_fused(bench_cfg, cp_dyn, cp_params, x0, cs,
                                                None, -100.0, 100.0), 1, 5)
    print(f"time ilqr_fused cartpole B={B_full} T={T}: {ms:.3f} ms median of {len(runs)}, "
          f"{B_full / ms * 1e3:.0f} solves/s [{card}]", flush=True)
    # the cluster size: every cartpole instantiation at B=4096 and B_full
    # (inputs from a generator of their own), then one probed launch
    cgen = torch.Generator(device="cpu").manual_seed(SEED + 3)
    for B in (4096, B_full):
        xg = cartpole_start(torch, cgen, B, dev)
        figs = []
        for G in fused.CLUSTERS:
            ms_g, runs = cuda_ms(lambda: fused.ilqr_fused(bench_cfg, cp_dyn, cp_params, xg, cs, None,
                                                          -100.0, 100.0, cluster=G), 1, 5)
            figs.append(f"G={G}: {ms_g:.3f} ms ({', '.join(f'{r:.3f}' for r in runs)})")
        print(f"time ilqr_fused cartpole B={B} by cluster size: {'; '.join(figs)} [{card}]",
              flush=True)
    cluster_report(torch, fused, card, "cartpole B=4096",
                   (bench_cfg, cp_dyn, cp_params, cartpole_start(torch, cgen, 4096, dev), cs, None,
                    -100.0, 100.0), t_kernel[4096])
    for env, label in ((0, "cartpole"), (1, "pendulum"), (2, "rocket"), (3, "cartpole slew"),
                       (4, "pendulum slew"), (5, "rocket slew")):
        for G, lanes in ((G, lanes) for G in fused.clusters(env) for lanes in (False, True)
                         if lanes or env not in fused.LANES_ONLY):
            info = fused.kernel_info(env, G, lanes)
            print(f"occupancy ilqr_fused {label} G={G}{' per-example cost' if lanes else ''}: "
                  f"cudaOccupancyMaxActiveClusters "
                  f"{info['max_active_clusters']}, {info['registers']} registers, "
                  f"{info['local_bytes']} local bytes, shared {info['static_smem']} + "
                  f"{info['dynamic_smem']} bytes a block", flush=True)
    # closed loop: one receding-horizon step is one warm-started solve plus
    # the plant step and the plan shift
    x0 = cartpole_x0(1024)
    t_rh = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        receding_horizon(bench_cfg, cp_dyn, cp_params, cost, x0, 5,
                         u_lower=cp_dyn.lower, u_upper=cp_dyn.upper)
        torch.cuda.synchronize()
        t_rh.append((time.perf_counter() - t1) * 1e3 / 5)
    print(f"time receding_horizon cartpole B=1024: {statistics.median(t_rh):.3f} ms per step, "
          f"median of 3 episodes of 5 steps (host clock) [{card}]", flush=True)
    x0 = cartpole_x0(4096)
    plain_ms, runs = cuda_ms(lambda: fused.ilqr_fused_reference(
        bench_cfg, cp_dyn, cp_params, x0, cs, None, -100.0, 100.0), 1, 3)
    print(f"time ilqr_fused_reference (plain) cartpole B=4096: {plain_ms:.1f} ms "
          f"median of 3 [{card}]", flush=True)

    # bound: bench.py's FLOP model of the solve (per example, per step, per
    # iteration) times the iterations this run's tiles ran, over the
    # float32 peak; bytes: each input read once, each output written once
    out = fused.ilqr_fused(bench_cfg, cp_dyn, cp_params, x0, cs, None, -100.0, 100.0)
    nx, nu, B = 5, 1, 4096
    n = nx + nu
    tile_iters = _tile_iters(fused, bench_cfg, cp_dyn, cp_params, x0, cs)
    bytes_ = 4 * (B * nx + n * n + n + 4) + 4 * (T * B * n + 2 * B + len(tile_iters))
    bound_ms, bound_by, flops = cartpole_bound(fused, T, B, tile_iters, bytes_)
    print(f"bound ilqr_fused B=4096: {flops:.3e} FLOP, {bytes_} bytes -> {bound_ms:.4f} ms "
          f"({bound_by}); tile iterations {tile_iters}; no single PyTorch call computes "
          f"an iLQR solve, so library_ms is null", flush=True)
    rows.append({
        "name": "ilqr_fused", "route": "cuda",
        "source": "dilqr_tpu_torch/csrc/ilqr_fused.cu",
        "replaces": "dilqr_tpu/ops/pallas/ilqr_fused.py:699",
        "launches": launches["ilqr_fused"], "max_abs_err": main_err,
        "ms": t_kernel[4096], "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
    })
    del out

    # the KKT-VJP kernel: the bench problem's solution (phase 3 (a)), the
    # rocket's (phase 3 (e)) and two random problems from their own generator
    kt = kkt_times(torch, kkt, card, kkt_ops, kkt_rocket, train, rk,
                   torch.Generator(device="cpu").manual_seed(SEED + 6))
    print(f"time IFT forward+backward B=4096 (host clock, synchronized, median of 3): "
          f"{train['ift_ms']:.2f} ms with detach_unconverged, {train['ift_ms_all']:.2f} ms "
          f"without [{card}]", flush=True)
    print(f"time imempc train step B=4096 (host clock, synchronized, median of 3): "
          f"{train['step_ms']:.2f} ms [{card}]", flush=True)
    kkt_row = {
        "name": "kkt_fused", "route": "cuda",
        "source": "dilqr_tpu_torch/csrc/kkt_fused.cu",
        "replaces": "dilqr_tpu/ops/pallas/kkt_fused.py:173",
        "launches": launches["kkt_fused"] + rk["launches"]["kkt_fused"],
        "max_abs_err": kkt_err, **kt, "library_ms": None,
    }
    rows.append(kkt_row)

    # the rocket variant of the whole-solve kernel (nu=3, in-kernel box-QP)
    r_ms = {}
    for B in (1024, 16384, 132 * fused.TILE):
        x0 = rocket.bench_start(B, rgen, device=dev)
        ms, runs = cuda_ms(lambda: fused.ilqr_fused(r_cfg, r_dyn, r_params, x0, r_cs, None,
                                                    r_dyn.lower, r_dyn.upper), 1, 5)
        r_ms[B] = ms
        out = fused.ilqr_fused(r_cfg, r_dyn, r_params, x0, r_cs, None, r_dyn.lower, r_dyn.upper)
        print(f"time ilqr_fused rocket B={B} T={T}: {ms:.3f} ms median of {len(runs)} "
              f"({', '.join(f'{r:.3f}' for r in runs)}), {B / ms * 1e3:.0f} solves/s, "
              f"n_iter {int(out[4])} [{card}]", flush=True)
    # the rocket's other cluster size (inputs from their own generator),
    # and one probed launch at B=1024 and at B=16384
    cgen = torch.Generator(device="cpu").manual_seed(SEED + 4)
    for B in (1024, 16384, 132 * fused.TILE):
        xg = rocket.bench_start(B, cgen, device=dev)
        figs = []
        for G in fused.CLUSTERS:
            ms_g, runs = cuda_ms(lambda: fused.ilqr_fused(r_cfg, r_dyn, r_params, xg, r_cs, None,
                                                          r_dyn.lower, r_dyn.upper, cluster=G), 1, 3)
            figs.append(f"G={G}: {ms_g:.3f} ms ({', '.join(f'{r:.3f}' for r in runs)})")
        print(f"time ilqr_fused rocket B={B} by cluster size: {'; '.join(figs)} [{card}]",
              flush=True)
    for B in (1024, 16384):
        cluster_report(torch, fused, card, f"rocket B={B}",
                       (r_cfg, r_dyn, r_params, rocket.bench_start(B, cgen, device=dev), r_cs,
                        None, r_dyn.lower, r_dyn.upper), r_ms[B])
    x0 = rocket.bench_start(1024, rgen, device=dev)
    r_plain_ms, _ = cuda_ms(lambda: fused.ilqr_fused_reference(
        r_cfg, r_dyn, r_params, x0, r_cs, None, r_dyn.lower, r_dyn.upper), 1, 3)
    print(f"time ilqr_fused_reference (plain) rocket B=1024: {r_plain_ms:.1f} ms median of 3 "
          f"[{card}]", flush=True)
    r_flops, r_bytes, counts = rocket_work(torch, fused, r_cfg, r_dyn, r_params, x0, r_cs)
    r_bound = max(r_flops / FP32_PEAK, r_bytes / HBM_RATE) * 1e3
    r_by = "operations" if r_flops / FP32_PEAK >= r_bytes / HBM_RATE else "bytes"
    print(f"bound ilqr_fused rocket B=1024: {r_flops:.3e} FLOP, {r_bytes} bytes -> "
          f"{r_bound:.4f} ms ({r_by}); {counts}; no single PyTorch call computes an iLQR "
          f"solve, so library_ms is null", flush=True)
    print(f"time rocket IFT forward+backward B=1024 (host clock, synchronized, median of 3): "
          f"{rk['ift_ms']:.2f} ms; KKT launches per IFT backward {rk['kkt_per_ift']} "
          f"[{card}]", flush=True)
    rows.append({
        "name": "ilqr_fused_rocket", "route": "cuda",
        "source": "dilqr_tpu_torch/csrc/ilqr_fused.cu",
        "replaces": "dilqr_tpu/ops/pallas/ilqr_fused.py:699",
        "launches": rk["launches"]["ilqr_fused"], "max_abs_err": r_err,
        "ms": r_ms[1024], "plain_ms": r_plain_ms, "bound_ms": r_bound, "bound_by": r_by,
        "library_ms": None,
    })

    # ---- 4) and 5) for the learned model and the slew rate ----
    # after the earlier paths' times, so that those run in the order they
    # ran before these paths existed; counters zeroed before each path
    mp = mlp_paths(torch, P, dev, kernels, bench_cfg, mlp_dyn, mlp_params, mlp_cost, cp_dyn,
                   cp_params, mgen)
    kkt_row["launches"] += mp["launches"]["kkt_fused"]
    rows.append(riccati_times(torch, P, dev, mgen, ric, card, bench_cfg, mlp_dyn, mlp_params,
                              mlp_cost, mp, ric_err))

    # ---- 6) the associative-scan Riccati, the LSTM policy, the utilities ----
    print(f"phase 5 ends {time.perf_counter() - t_start:.0f} s into the run", flush=True)
    parallel_paths(torch, P, dev, kernels, card, cp_dyn, cp_params, cp_q, cp_p, bench_cfg,
                   mlp_dyn, mlp_params)

    # ---- 7) the whole-solve kernel's MPC variants and the slew rate ----
    print(f"phase 6 ends {time.perf_counter() - t_start:.0f} s into the run", flush=True)
    vgen = torch.Generator(device="cpu").manual_seed(SEED + 7)
    v_launches, v_err, variants, v_paths = variant_paths(
        torch, P, dev, kernels, card, fused,
        (bench_cfg, r_cfg, cfg_for(pd_dyn, 3, T, 10, 1e-3)),
        {"cartpole": (cp_dyn, cp_params, cp_q, cp_p), "pendulum": (pd_dyn, pd_params, pd_q, pd_p),
         "rocket": (r_dyn, r_params, r_q, r_p)}, vgen)
    rows[0]["launches"] += v_launches["ilqr_fused"]
    rows[0]["max_abs_err_variants"] = v_err
    rows[0]["variants"] = variants
    rows[0]["variant_paths"] = v_paths
    kkt_row["launches"] += v_launches["kkt_fused"]

    # ---- 8) LinDx problems and n_ctrl 2..8 on the whole-solve kernel ----
    print(f"phase 8 starts {time.perf_counter() - t_start:.0f} s into the run", flush=True)
    lgen = torch.Generator(device="cpu").manual_seed(SEED + 8)
    l_launches, l_err, l_cases, l_paths = lindx_paths(torch, P, dev, kernels, card, fused, lgen)
    print(f"phase 8 ends {time.perf_counter() - t_start:.0f} s into the run", flush=True)
    rows[0]["launches"] += l_launches["ilqr_fused"]
    rows[0]["lindx_launches"] = l_launches["ilqr_fused"]
    rows[0]["max_abs_err_lindx"] = l_err
    rows[0]["lindx"] = l_cases
    rows[0]["lindx_paths"] = l_paths
    kkt_row["launches"] += l_launches["kkt_fused"]

    # ---- 9) the whole-solve kernel's jvp sweep ----
    jgen = torch.Generator(device="cpu").manual_seed(SEED + 9)
    j_launches, j_err, j_cases, j_paths = jvp_paths(torch, P, dev, kernels, card, fused, jgen)
    print(f"phase 9 ends {time.perf_counter() - t_start:.0f} s into the run", flush=True)
    rows[0]["launches"] += j_launches["ilqr_fused"]
    rows[0]["jvp_launches"] = j_launches["ilqr_fused"]
    rows[0]["max_abs_err_jvp"] = j_err
    rows[0]["jvp"] = j_cases
    rows[0]["jvp_paths"] = j_paths
    kkt_row["launches"] += j_launches["kkt_fused"]

    # ---- 10) the small MLP on the whole-solve kernel ----
    ngen = torch.Generator(device="cpu").manual_seed(SEED + 10)
    rows.append(small_mlp_paths(torch, P, dev, kernels, card, fused, ngen))
    kkt_row["launches"] += rows[-1].pop("kkt_launches")
    print(f"phase 10 ends {time.perf_counter() - t_start:.0f} s into the run", flush=True)

    # ---- 11) the batch sharded over ranks and devices ----
    hgen = torch.Generator(device="cpu").manual_seed(SEED + 11)
    h_launches = multihost_paths(torch, P, dev, kernels, card, cp_dyn, cp_params, cp_q, cp_p,
                                 bench_cfg, hgen)
    rows[0]["launches"] += h_launches["ilqr_fused"]
    rows[0]["multihost_launches"] = h_launches["ilqr_fused"]
    kkt_row["launches"] += h_launches["kkt_fused"]
    print(f"phase 11 ends {time.perf_counter() - t_start:.0f} s into the run", flush=True)

    # ---- 12) torch.func.vmap over the solve ----
    vgen = torch.Generator(device="cpu").manual_seed(SEED + 12)
    w_launches, rows[0]["vmap_sweep"] = vmap_paths(torch, P, dev, kernels, card, fused, cp_dyn,
                                                   cp_params, cp_q, cp_p, bench_cfg, vgen)
    rows[0]["launches"] += w_launches["ilqr_fused"]
    rows[0]["vmap_launches"] = w_launches["ilqr_fused"]
    kkt_row["launches"] += w_launches["kkt_fused"]
    print(f"phase 12 ends {time.perf_counter() - t_start:.0f} s into the run", flush=True)

    # ---- 13) per-candidate gradients ----
    pgen = torch.Generator(device="cpu").manual_seed(SEED + 13)
    g_launches, kkt_row["pergrad_sweep"] = pergrad_paths(torch, P, dev, kernels, card, kkt,
                                                         cp_dyn, cp_params, cp_q, cp_p,
                                                         bench_cfg, pgen)
    rows[0]["launches"] += g_launches["ilqr_fused"]
    rows[0]["pergrad_launches"] = g_launches["ilqr_fused"]
    kkt_row["launches"] += g_launches["kkt_fused"]
    kkt_row["pergrad_launches"] = g_launches["kkt_fused"]
    print(f"phase 13 ends {time.perf_counter() - t_start:.0f} s into the run", flush=True)

    # ---- 14) a user's own model and a callable cost ----
    ugen = torch.Generator(device="cpu").manual_seed(SEED + 14)
    u_rows, u_launches = user_paths(torch, P, dev, kernels, card, fused, user, ugen)
    rows.extend(u_rows)
    kkt_row["launches"] += u_launches["kkt_fused"]
    print(f"phase 14 ends {time.perf_counter() - t_start:.0f} s into the run", flush=True)

    # ---- 15) the card's line, then the result line ----
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


KKT_FIELDS = ("dx_init", "dC", "dc", "dF", "df")


def check_kkt(torch, dev, gen, kkt, solutions):
    """Phase 3 for the KKT-VJP kernel: the kernel's whole call (one launch:
    the recursions and the dF/df/dC assembly) against kkt_fused_reference on
    the same operands and cotangent, in the full and the "Ff" form, per
    output max|kernel - plain| <= 1e-4 max|plain| + 1e-5 (f32 recursions in
    another summation order, FMA contraction). ``solutions`` lists (label,
    dyn, params, cfg, x0, cost_small) problems whose solution gives the
    operands; the first is the bench problem, the others run after the
    random shapes (a)-(d). Then, with a generator of their own, the shapes
    JAX's whole gate brought: (6,1), (16,1), (15,2), (14,3), masked, at a
    ragged B. The bench problem and the rocket's give the same bits with
    blocks of 64 and 256 threads and with K/k/dtau in the global store.
    Returns (the largest absolute error on the bench problem, its (operands,
    g_x, g_u), the rocket solution's)."""
    import dataclasses

    import dilqr_tpu_torch as P
    from dilqr_tpu_torch.core.linearize import linearize_dynamics
    from dilqr_tpu_torch.diff.modes import _active_set

    def solution_ops(label, dyn, params, cfg, x0, cost_small):
        """C, c and F at a solve's solution, the active set from the bounds"""
        T, B, nx, nu = cfg.T, x0.shape[0], cfg.n_state, cfg.n_ctrl
        n = nx + nu
        res = P.solve(dataclasses.replace(cfg, backprop=False), x0, P.QuadCost(*cost_small), dyn,
                      params=params, u_lower=dyn.lower, u_upper=dyn.upper)
        x, u = res.x.transpose(0, 1), res.u.transpose(0, 1)
        F, _ = linearize_dynamics(dyn.step, params, x, u, linearize_fn=dyn.linearize_point)
        lo, hi = (v.to(dev) if isinstance(v, torch.Tensor) else v for v in (dyn.lower, dyn.upper))
        I = _active_set(u, lo, hi)
        return (f"{label} B={B} T={T} (active share {I.float().mean().item():.3f})",
                kkt.prepare(nx, nu, cost_small[0].expand(T, B, n, n),
                            cost_small[1].expand(T, B, n), F, x, u, I))

    # (a) the bench problem, random cotangents
    cases = [solution_ops(*solutions[0])]

    def random_ops(g, nx, nu, T, B):
        n = nx + nu
        A = torch.randn(T, B, n, n, generator=g)
        C = A @ A.transpose(-1, -2) + 2.0 * torch.eye(n)
        # a contracting F keeps the T-step recursions' values of order one
        F = (0.5 / n ** 0.5) * torch.randn(T - 1, B, nx, n, generator=g)
        parts = (C, torch.randn(T, B, n, generator=g), F, torch.randn(T, B, nx, generator=g),
                 torch.randn(T, B, nu, generator=g), torch.rand(T, B, nu, generator=g) < 0.3)
        return kkt.prepare(nx, nu, *(a.to(dev) for a in parts))

    for nu_ in (1, 2, 3):  # (b)
        cases.append((f"nx=4 nu={nu_} masked B=1030 T=20", random_ops(gen, 4, nu_, 20, 1030)))
    cases.append(("nx=13 nu=3 masked B=1030 T=20", random_ops(gen, 13, 3, 20, 1030)))  # (c)
    cases.append(("cartpole shape nx=5 nu=1 masked B=1030 T=200",
                  random_ops(gen, 5, 1, 200, 1030)))  # (d)
    cases += [solution_ops(*sol) for sol in solutions[1:]]  # (e)
    n_gen = len(cases)
    wgen = torch.Generator(device="cpu").manual_seed(SEED + 5)
    for nx_, nu_ in ((6, 1), (16, 1), (15, 2), (14, 3)):  # JAX's whole gate
        cases.append((f"nx={nx_} nu={nu_} masked B=1030 T=20", random_ops(wgen, nx_, nu_, 20, 1030)))

    main, rocket_case = None, None
    for i, (name, ops) in enumerate(cases):
        # the cotangent as the earlier slices drew it, [T, n, B], from the
        # generator of the case
        r = torch.randn(ops.T, ops.n_state + ops.n_ctrl, ops.B,
                        generator=gen if i < n_gen else wgen).to(dev)
        gx = r[:, :ops.n_state].permute(0, 2, 1).contiguous()
        gu = r[:, ops.n_state:].permute(0, 2, 1).contiguous()
        worst = 0.0
        for full in (True, False):
            before = kkt.LAUNCHES
            got = kkt.kkt_fused(ops, gx, gu, full)
            torch.cuda.synchronize()
            if kkt.LAUNCHES != before + 1:
                fail(f"kkt {name}: not one launch for the call")
            want = kkt.kkt_fused_reference(ops, gx, gu, full)
            figs = []
            for field, a, b in zip(KKT_FIELDS, got, want):
                if b is None:
                    if a is not None:
                        fail(f"kkt {name}: {field} in Ff mode")
                    continue
                if not torch.isfinite(a).all():
                    fail(f"kkt {name}: non-finite {field}")
                err, scale = (a - b).abs().max().item(), b.abs().max().item()
                figs.append(f"{field} {err:.2e}/{scale:.2e}")
                worst = max(worst, err)
                if err > 1e-4 * scale + 1e-5:
                    fail(f"kkt {name} ({'full' if full else 'Ff'}): {field} off by {err:.3e} "
                         f"at scale {scale:.3e}")
            p = kkt.plan(ops)
            print(f"parity kkt {name} {'full' if full else 'Ff'}: max|kernel - plain| / "
                  f"max|plain|: {', '.join(figs)} [{p['L']} lanes, {p['teams']} teams a block, "
                  f"{p['smem']} shared bytes, K/k/dtau {'global' if p['global'] else 'shared'}]",
                  flush=True)
        if main is None or name.startswith("rocket"):
            ref = kkt.kkt_fused(ops, gx, gu, True)
            for block in kkt.BLOCKS:
                for store in ("auto", "global"):
                    out = kkt.kkt_fused(ops, gx, gu, True, block=block, store=store)
                    if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                        fail(f"kkt {name}: blocks of {block} threads, store {store}, change the "
                             "result")
            print(f"parity kkt {name}: blocks of {kkt.BLOCKS} threads, K/k/dtau in shared "
                  f"memory and in the global store give the same bits", flush=True)
        if main is None:
            main = (worst, (ops, gx, gu))
        elif name.startswith("rocket"):
            rocket_case = (ops, gx, gu)
    return main[0], main[1], rocket_case


def kkt_work(ops, full: bool):
    """(FLOP, bytes) of one KKT-VJP call from its shapes. FLOP per example
    and step: the Riccati step (V F, F^T V F on the triangle, q, the gains
    and the V/v update), the rollout step, the two adjoint steps and the
    assembly (dF 3 an entry, dC 4 an entry and dc). Bytes: what the call
    must move -- every input read once (C's triangle, F's T-1 slabs, the
    cotangent, the mask, the adjoint offset, tau) and every output written
    once (dF, df; in full mode also dC, dc, dx_init); no scratch."""
    nx, nu, T, B = ops.n_state, ops.n_ctrl, ops.T, ops.B
    n = nx + nu
    tri = n * (n + 1) // 2
    gains = 2 + 2 * nx if nu == 1 else 2 * nu * nu * (nx + 1) + {2: 6, 3: 30}[nu]
    ric = (2 * nx * nx * n + 2 * nx * tri + tri + 2 * nx * n + n + 3 * nu * nu + gains
           + 2 * nu * nu * (nx + 1) + 8 * nu * nx * nx + 6 * nu * nx + 3 * nx * nx + 3 * nx)
    roll = nu * (2 * nx + 2) + 2 * nx * n
    adj = 4 * nx * nx + 2 * nx * n + 3 * nx
    flops = T * (ric + roll + adj) + (T - 1) * 3 * nx * n + (T * (4 * n * n + n) if full else 0)
    reads = T * (tri + n + nu + nx + n) + (T - 1) * nx * n
    writes = (T - 1) * (nx * n + nx) + ((T * (n * n + n) + nx) if full else 0)
    return B * flops, 4 * B * (reads + writes)


def kkt_times(torch, kkt, card, bench, rocket_case, train, rk, gen):
    """Phase 5 for the KKT-VJP kernel: its "Ff" call (what each GMRES
    matvec runs) and its full call (the final VJP), CUDA events, at the
    cartpole bench solution (B=4096, the main path), the rocket bench
    solution (13,3) at B=1024, and random operands (from ``gen``) at the
    learned model's (5,1) and the slew rate's (6,1), B=1024; each call
    timed with CUDA events around it (host gaps included) and, from the
    profiler, the kernel alone; each beside its bound (kkt_work) and the
    plain version's Ff call. Returns the JSON row's numbers: the bench Ff
    call's."""
    from dilqr_tpu_torch.utils.profiling import kernel_ms

    dev = bench[0].slab.device

    def random_case(nx, nu, B):
        T, n = 20, nx + nu
        A = torch.randn(T, B, n, n, generator=gen)
        C = A @ A.transpose(-1, -2) + 2.0 * torch.eye(n)
        parts = (C, torch.randn(T, B, n, generator=gen),
                 (0.5 / n ** 0.5) * torch.randn(T - 1, B, nx, n, generator=gen),
                 torch.randn(T, B, nx, generator=gen), torch.randn(T, B, nu, generator=gen),
                 torch.rand(T, B, nu, generator=gen) < 0.3)
        ops = kkt.prepare(nx, nu, *(a.to(dev) for a in parts))
        return (ops, torch.randn(T, B, nx, generator=gen).to(dev),
                torch.randn(T, B, nu, generator=gen).to(dev))

    shapes = [("cartpole (5,1) B=4096", bench), ("rocket (13,3) B=1024", rocket_case),
              ("learned model (5,1) B=1024", random_case(5, 1, 1024)),
              ("slew rate (6,1) B=1024", random_case(6, 1, 1024))]
    main = None
    for label, (ops, gx, gu) in shapes:
        ff_ms, runs = cuda_ms(lambda: kkt.kkt_fused(ops, gx, gu, False), 3, 21)
        full_ms, _ = cuda_ms(lambda: kkt.kkt_fused(ops, gx, gu, True), 3, 21)
        ff_dev, n_ff, _ = kernel_ms(lambda: kkt.kkt_fused(ops, gx, gu, False),
                                    "kkt_fused_kernel")
        full_dev, n_full, _ = kernel_ms(lambda: kkt.kkt_fused(ops, gx, gu, True),
                                        "kkt_fused_kernel")
        plain_ms, _ = cuda_ms(lambda: kkt.kkt_fused_reference(ops, gx, gu, False), 1, 5)
        bounds = []
        for full in (False, True):
            flops, bytes_ = kkt_work(ops, full)
            bound = max(flops / FP32_PEAK, bytes_ / HBM_RATE) * 1e3
            by = "operations" if flops / FP32_PEAK >= bytes_ / HBM_RATE else "bytes"
            bounds.append((flops, bytes_, bound, by))
        p = kkt.plan(ops)
        print(f"time kkt_fused {label} T={ops.T}: Ff call {ff_ms:.4f} ms median of {len(runs)} "
              f"({', '.join(f'{x:.4f}' for x in runs)}), full call {full_ms:.4f} ms; the "
              f"kernel alone (profiler, mean of the {n_ff} and {n_full} launches it recorded "
              f"of 20) Ff {fmt_ms(ff_dev)}, full {fmt_ms(full_dev)}; plain version (Ff) "
              f"{plain_ms:.3f} ms; {p['L']} lanes, "
              f"{p['teams']} teams a block, {p['smem']} shared bytes a block [{card}]", flush=True)
        print(f"bound kkt_fused {label}: Ff {bounds[0][0]:.4e} FLOP, {bounds[0][1]} bytes -> "
              f"{bounds[0][2]:.5f} ms ({bounds[0][3]}); full {bounds[1][0]:.4e} FLOP, "
              f"{bounds[1][1]} bytes -> {bounds[1][2]:.5f} ms ({bounds[1][3]})", flush=True)
        if main is None:
            main = {"ms": ff_ms, "plain_ms": plain_ms, "bound_ms": bounds[0][2],
                    "bound_by": bounds[0][3]}
    print(f"kkt_fused launches per IFT backward: cartpole {train['kkt_per_ift']}, rocket "
          f"{rk['kkt_per_ift']}; no single PyTorch call computes a KKT VJP, so library_ms is "
          f"null", flush=True)
    return main


def rocket_paths(torch, P, dev, kernels, dyn, params, cs, cfg, gen):
    """Phase 4 for the rocket, through the entry points a user calls, each
    path with both counters zeroed before it and read after it: serving
    (MPC.solve at B=1024 and B=16384, one launch each; receding_horizon at
    B=1024 for 5 steps, 5 launches) and training (the IFT gradient of
    bench.py's rocket loss, mean u^2 with respect to the params, at B=1024,
    with detach_unconverged; both kernels launch, and the gradient agrees
    with the plain KKT recursions on the same forward solution to max-norm
    rtol 1e-3). Returns the summed launches, the KKT launches of the IFT
    backward and its host time; prints a profiler breakdown of one IFT
    step."""
    import dataclasses

    from dilqr_tpu_torch.control import receding_horizon
    from dilqr_tpu_torch.models import rocket

    total = {name: 0 for name in kernels}
    cost = P.QuadCost(*cs)

    def run(label, fn, want):
        return drive(torch, kernels, total, f"rocket path {label}", fn, want)

    mpc = P.MPC(13, 3, cfg.T, u_lower=dyn.lower, u_upper=dyn.upper, lqr_iter=cfg.lqr_iter,
                eps=cfg.eps, linesearch_decay=cfg.linesearch_decay,
                max_linesearch_iter=cfg.max_linesearch_iter, backprop=False,
                exit_unconverged=False)
    for B in (1024, 16384):
        x0 = rocket.bench_start(B, gen, device=dev)
        res, _ = run(f"serving MPC.solve B={B}", lambda: mpc.solve(x0, cost, dyn, params=params),
                     {"ilqr_fused": 1, "kkt_fused": 0})
        if res.x.shape != (B, cfg.T, 13) or res.u.shape != (B, cfg.T, 3):
            fail(f"rocket MPC at B={B}: shapes {tuple(res.x.shape)}, {tuple(res.u.shape)}")
        if not (torch.isfinite(res.costs).all() and torch.isfinite(res.x).all()):
            fail(f"rocket MPC at B={B}: non-finite output")
        if res.u.abs().max().item() > 20.0:
            fail(f"rocket MPC at B={B}: controls outside the box")
        print(f"rocket MPC B={B}: n_iter {int(res.n_iter)}, mean cost "
              f"{res.costs.mean().item():.4f}, converged share "
              f"{res.converged.float().mean().item():.4f}, max |u| "
              f"{res.u.abs().max().item():.4f}", flush=True)
    x0 = rocket.bench_start(1024, gen, device=dev)
    ep, _ = run("serving receding_horizon B=1024 x5 steps",
                lambda: receding_horizon(cfg, dyn, params, cost, x0, 5, u_lower=dyn.lower,
                                         u_upper=dyn.upper),
                {"ilqr_fused": 5, "kkt_fused": 0})
    if ep.xs.shape != (1024, 6, 13) or not torch.isfinite(ep.xs).all():
        fail("rocket receding_horizon: bad closed-loop states")
    print(f"rocket receding_horizon: mean height {ep.xs[:, :, 0].mean(0).tolist()}", flush=True)

    c_ift = dataclasses.replace(cfg, backprop=True, detach_unconverged=True,
                                backward_mode=P.BackwardMode.IFT)
    x0 = rocket.bench_start(1024, gen, device=dev)

    def grad(c):
        pr = params.clone().requires_grad_(True)
        res = P.solve(c, x0, cost, dyn, params=pr, u_lower=dyn.lower, u_upper=dyn.upper)
        loss = (res.u ** 2).mean()
        (g,) = torch.autograd.grad(loss, pr)
        return loss.detach(), g, res.converged

    (loss, g, conv), got = run("training IFT grad B=1024", lambda: grad(c_ift),
                               {"ilqr_fused": 1, "kkt_fused": None})
    if not (torch.isfinite(loss) and torch.isfinite(g).all()) or g.dtype != torch.float32:
        fail("rocket IFT grad: non-finite or not float32")
    _, g_ref, _ = grad(dataclasses.replace(c_ift, backward_backend="torch"))
    err = (g - g_ref).abs().max().item() / g_ref.abs().max().item()
    print(f"rocket IFT grad: loss {loss.item():.6f}, grad params {g.tolist()}, KKT launches in "
          f"the backward {got['kkt_fused']}, converged share {conv.float().mean().item():.4f}, "
          f"rel. diff to the plain backward {err:.2e}", flush=True)
    if err > 1e-3:
        fail(f"rocket IFT grad: differs from the plain backward's by {err:.3e}")
    if g.abs().max().item() == 0.0:
        fail("rocket IFT grad: the gradient is zero")

    profile_step(torch, "rocket IFT forward+backward B=1024 detach_unconverged=True",
                 lambda: grad(c_ift))
    ts = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grad(c_ift)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t1) * 1e3)
    return {"launches": total, "kkt_per_ift": got["kkt_fused"], "ift_ms": statistics.median(ts)}


def rocket_work(torch, fused, cfg, dyn, params, x0, cs):
    """(FLOP, bytes) of one rocket solve of a one-tile batch from its
    shapes. The work that depends on the data -- the iterations and the
    line-search trials -- is counted from one run of the plain version,
    which takes the kernel's per-tile decisions: with one tile, each call of
    the step or the Jacobian is one call for the tile. The box-QP is
    counted at one Newton step and one Armijo trial per Riccati step; its
    repeats are not counted. FLOP per example: the step 130, the Jacobian
    200, the objective 2n^2 + 3n; a Riccati step V F, Q's triangle,
    C tau + c, F^T v, the box-QP, K, Quu K and the V/v update; a trial step
    K dx, the objective and the step. Bytes: x_init, the cost, params and
    bounds read once, x, u, costs, du and the tile counts written once."""
    import dataclasses

    calls = {"step": 0, "jac": 0}

    def counted(name, fn):
        def f(*a):
            calls[name] += 1
            return fn(*a)
        return f

    cdyn = dataclasses.replace(dyn, kernel_step=counted("step", dyn.kernel_step),
                               jac_lanes=counted("jac", dyn.jac_lanes))
    fused.ilqr_fused_reference(cfg, cdyn, params, x0, cs, None, dyn.lower, dyn.upper)
    T, B, nx, nu = cfg.T, x0.shape[0], 13, 3
    if B > fused.TILE:
        raise ValueError("rocket_work counts a one-tile batch")
    n = nx + nu
    tri = n * (n + 1) // 2
    step_f, jac_f, qp_f = 130, 200, 150
    obj_f = 2 * n * n + 3 * n
    iters = calls["jac"] // (T - 1)
    trials = (calls["step"] - T) // T
    ric = (2 * nx * nx * n + 2 * nx * tri + tri + 2 * n * n + n + 2 * nx * n
           + qp_f + 2 * nu * nu * nx + 2 * nu * nu * (nx + 1)
           + nx * nx * (6 * nu + 3) + nx * (4 * nu + 2))
    trial_t = 2 * nu * nx + 4 * nu + obj_f + step_f
    flops = B * (T * (obj_f + step_f) + calls["jac"] * jac_f + iters * T * ric
                 + trials * T * trial_t)
    bytes_ = 4 * (B * nx + n * n + n + 5 + 2 * nu) + 4 * (T * B * n + 2 * B + 1)
    return flops, bytes_, f"iterations {iters}, line-search trials {trials}"


def train_path(torch, P, dev, kernels, dyn, params, q, p, cfg, x0):
    """Phase 4, training: each step zeroes the counters before and reads
    them after, and fails unless the whole-solve and KKT kernels launched. Returns the summed
    launches, the KKT launches per IFT backward and the step times."""
    import dataclasses
    import os
    import tempfile

    from dilqr_tpu_torch.il.exp import ILExp
    from dilqr_tpu_torch.utils.optim import rmsprop_init, rmsprop_update

    kkt = kernels["kkt_fused"]
    total = {name: 0 for name in kernels}

    def run(label, fn):
        return drive(torch, kernels, total, f"training path {label}", fn,
                     {"ilqr_fused": None, "kkt_fused": None})

    cost = P.QuadCost(torch.diag(q), p)

    def grad(c, mpc=None):
        """bench.py's im_loss (mean u^2) and its gradient with respect to
        the dynamics params and, per example, x_init; through solve with
        config c, or through mpc.solve."""
        pr = params.clone().requires_grad_(True)
        xi = x0.clone().requires_grad_(True)
        if mpc is not None:
            res = mpc.solve(xi, cost, dyn, params=pr)
        else:
            res = P.solve(c, xi, cost, dyn, params=pr, u_lower=dyn.lower, u_upper=dyn.upper)
        loss = (res.u ** 2).mean()
        gp, gx = torch.autograd.grad(loss, (pr, xi))
        return loss.detach(), gp, gx, res.converged

    def check_grad(label, c, mpc=None):
        (loss, gp, gx, conv), got = run(label, lambda: grad(c, mpc))
        if not (torch.isfinite(loss) and torch.isfinite(gp).all() and torch.isfinite(gx).all()):
            fail(f"{label}: non-finite loss or gradient")
        if gp.dtype != torch.float32:  # the reverse-over-forward VJP keeps f32
            fail(f"{label}: the params gradient is {gp.dtype}")
        nonzero = (gx.abs().sum(1) > 0).float().mean().item()
        # the same forward solution (the kernel is deterministic) through
        # the plain KKT recursions on the card; max-norm rtol 1e-3: f32
        # recursions, and GMRES may stop one iteration apart
        _, gp_ref, _, _ = grad(dataclasses.replace(c, backward_backend="torch"))
        err = (gp - gp_ref).abs().max().item() / gp_ref.abs().max().item()
        print(f"{label}: loss {loss.item():.6f}, grad params {gp.tolist()}, KKT launches in "
              f"the backward {got['kkt_fused']}, converged share {conv.float().mean().item():.4f}, "
              f"share of examples with a nonzero gradient {nonzero:.4f}, rel. diff to the "
              f"plain backward {err:.2e}", flush=True)
        if err > 1e-3:
            fail(f"{label}: the gradient differs from the plain backward's by {err:.3e}")
        if nonzero == 0.0:
            fail(f"{label}: every example's gradient is zero")
        return got["kkt_fused"]

    # (i) the IFT gradient, with and without detach_unconverged (bench.py:
    # 276-301 uses detach_unconverged=True)
    ift = {}
    for detach in (True, False):
        c = dataclasses.replace(cfg, backprop=True, detach_unconverged=detach,
                                backward_mode=P.BackwardMode.IFT)
        ift[detach] = (c, check_grad(f"(i) IFT grad B={x0.shape[0]} detach_unconverged={detach}",
                                     c))
    # (ii) the KKT gradient through MPC with its defaults (backprop=True,
    # BackwardMode.KKT)
    for detach in (True, False):
        mpc = P.MPC(cfg.n_state, cfg.n_ctrl, cfg.T, u_lower=dyn.lower, u_upper=dyn.upper,
                    lqr_iter=cfg.lqr_iter, eps=cfg.eps, linesearch_decay=cfg.linesearch_decay,
                    max_linesearch_iter=cfg.max_linesearch_iter, exit_unconverged=False,
                    detach_unconverged=detach)
        check_grad(f"(ii) KKT grad through MPC B={x0.shape[0]} detach_unconverged={detach}",
                   mpc.cfg, mpc)

    # (iii) bench.py's imempc train step (bench.py:349-395): learn a cost
    # logit and the dynamics params, RMSprop(1e-2, decay=0.5)
    p_hat = p / torch.sqrt(q.clamp(min=1e-8))
    qc = q.clamp(1e-4, 0.999)
    leaves0 = {"q_logit": torch.log(qc / (1.0 - qc)), "params": params.clone()}
    u_exp = torch.zeros(x0.shape[0], cfg.T, cfg.n_ctrl, device=dev)
    c_ift = ift[True][0]

    def step(leaves, state):
        lv = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
        qq = torch.sigmoid(lv["q_logit"])
        res = P.solve(c_ift, x0, P.QuadCost(torch.diag(qq), torch.sqrt(qq) * p_hat), dyn,
                      params=lv["params"], u_lower=dyn.lower, u_upper=dyn.upper)
        loss = ((res.u - u_exp) ** 2).mean()
        g = dict(zip(lv, torch.autograd.grad(loss, list(lv.values()))))
        new, state = rmsprop_update(leaves, g, state, lr=1e-2, decay=0.5)
        return new, state, loss.detach()

    def three_steps():
        leaves, state, losses = leaves0, rmsprop_init(leaves0), []
        for _ in range(3):
            leaves, state, loss = step(leaves, state)
            losses.append(loss.item())
        return leaves, losses

    (leaves, losses), _ = run(f"(iii) imempc train step x3 B={x0.shape[0]}", three_steps)
    moved = max((leaves[k] - leaves0[k]).abs().max().item() for k in leaves0)
    print(f"(iii) train step losses {losses}, largest parameter move {moved:.3e}", flush=True)
    if not all(math.isfinite(v) for v in losses) or moved == 0.0:
        fail("(iii) train step: non-finite loss or the parameters did not move")

    # (iv) the trainer on the shipped dataset
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "cartpole.npz")
    with tempfile.TemporaryDirectory() as work:
        exp = ILExp.from_cli(["--env", "cartpole", "--data", data, "--mode", "imempc",
                              "--learn_cost", "--learn_dx", "--n_epoch", "2", "--n_batch", "32",
                              "--n_train", "100", "--work", work], device="cuda")
        best, _ = run("(iv) ILExp imempc cartpole 2 epochs", lambda: exp.run(verbose=False))
        with open(os.path.join(exp.save, "train_losses.csv")) as f:
            rows = [list(map(float, line.split(","))) for line in f.read().splitlines()[1:]]
        ok = os.path.exists(os.path.join(exp.save, "best.ckpt"))
    print(f"(iv) ILExp: {len(rows)} steps, last train losses {rows[-1][1:]}, best val loss "
          f"{best:.6f}, params {{{', '.join(f'{k}: {v.tolist()}' for k, v in exp.params.items())}}}",
          flush=True)
    if not (ok and math.isfinite(best) and all(math.isfinite(v) for r in rows for v in r)):
        fail("(iv) ILExp: non-finite losses or no checkpoint")

    # times: IFT forward + backward, the train step (host clock, synchronized)
    profile_step(torch, "IFT forward+backward B=4096 detach_unconverged=True",
                 lambda: grad(ift[True][0]))
    return {
        "launches": total,
        "kkt_per_ift": f"{ift[True][1]} (detach_unconverged) / {ift[False][1]} (without)",
        "ift_ms": host_ms(lambda: grad(ift[True][0])),
        "ift_ms_all": host_ms(lambda: grad(ift[False][0])),
        "step_ms": host_ms(lambda: step(leaves0, rmsprop_init(leaves0))),
    }


def profile_step(torch, label, fn, counted=None):
    """Where one call's time goes: torch.profiler over one warm call, in a
    window utils/profiling.profiled opens (padded, so that it holds every
    device activity of the call), the wall time of the call, the device's
    busy time and idle share, the number of device kernels and copies, the
    six kernels with the most device time and the five host operators with
    the most self time. counted: (wrapper module, kernel name) whose launch
    counter the recorded launches are printed beside; a window that records
    fewer is opened again, up to utils/profiling.WINDOW_TRIES in all, and
    if the last is short too, its busy time and idle share are printed as
    not measured.

    Busy time is the union of the device activities' intervals. Only the
    activities themselves count: the profiler also gives each host operator
    and each annotated range the device time of the kernels under it, so
    summing every row with device time counts a kernel two or three times.
    Reports, never fails: nothing else relies on the profiler."""
    from torch.autograd import DeviceType

    from dilqr_tpu_torch.utils.profiling import (WINDOW, WINDOW_TRIES, busy_ms, device_events,
                                                 profiled)

    fn()
    complete = True
    for attempt in range(1, WINDOW_TRIES + 1):
        before = counted[0].LAUNCHES if counted else 0
        with profiled() as prof:
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
        device = device_events(prof)
        if counted:
            seen = sum(counted[1] in e.name for e in device)
            print(f"profile {label}: window {attempt}: {seen} {counted[1]} launches recorded "
                  f"of the {counted[0].LAUNCHES - before} its wrapper counted", flush=True)
        complete = not counted or seen >= counted[0].LAUNCHES - before
        if complete:
            break
    busy = busy_ms(device)
    by_name = {}
    for e in device:
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, count + 1)
    share = (f"device busy {busy:.2f} ms (idle share {1.0 - busy / wall:.3f})" if complete else
             f"device busy and idle share not measured (the last window lost a launch)")
    print(f"profile {label}: wall {wall:.2f} ms under the profiler, {share}, {len(device)} "
          f"device kernels and copies", flush=True)
    for key, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"profile {label}:   {ms:8.3f} ms  x{count:<5d} {key[:110]}", flush=True)
    # the host operators of the call: those from the window's mark on
    start = min((e.time_range.start for e in prof.events() if e.name == WINDOW), default=0.0)
    host = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.time_range.start >= start and e.name != WINDOW:
            ms, count = host.get(e.name, (0.0, 0))
            host[e.name] = (ms + e.self_cpu_time_total / 1e3, count + 1)
    for key, (ms, count) in sorted(host.items(), key=lambda kv: -kv[1][0])[:5]:
        print(f"profile {label}:   host {ms:8.3f} ms  x{count:<5d} {key[:100]}", flush=True)


def cartpole_start(torch, gen, B, dev):
    """bench.py's cartpole start, angle pi/1.05 + N(0, 0.1), from ``gen``."""
    th = math.pi / 1.05 + 0.1 * torch.randn(B, generator=gen)
    z = torch.zeros(B)
    return torch.stack([z, z, th.cos(), th.sin(), z], 1).to(dev)


def riccati_problem(torch, gen, T, B, nx, dev):
    """Random symmetric problems in the JAX kernel test's form
    (tests/test_pallas_kernels.py:15-23), with the control iterate at unit
    scale (about a third of the +-1 box gains at a bound) and a zero mask;
    F's scale falls as 1/sqrt(n_state) past 8 states, so that V stays of
    order one over the horizon."""
    n = nx + 1
    A = torch.randn(T, B, n, n, generator=gen)
    C = A @ A.transpose(-1, -2) + 2.0 * torch.eye(n)
    f_scale = 0.3 / max(1.0, (nx / 8) ** 0.5)
    parts = (C, torch.randn(T, B, n, generator=gen),
             f_scale * torch.randn(T - 1, B, nx, n, generator=gen),
             torch.randn(T, B, 1, generator=gen), torch.rand(T, B, 1, generator=gen) < 0.3)
    return [a.to(dev) for a in parts]


BOX = {"u_lower": -1.0, "u_upper": 1.0}


def check_riccati(torch, dev, gen, ric):
    """Phase 3 for the Riccati kernel: kernel against
    riccati_fused_reference on a ragged batch, B=1030, T=20, for n_state
    1..9, 12, 16, 24, 31 (lane teams of 4 to 32), 48 (the looped form, its
    team memory in shared memory) and the first size from 64 on whose team
    memory riccati_fused.plan puts in device memory, in the modes free, box
    (+-1, test_pallas_kernels.py:31), zero (a random mask) and box with
    delta_u=0.2. Then the inputs as callers hand them, at n_state 5, 12 and
    48 in box with delta_u and zero mode: C expanded from one matrix (T and
    B strides 0), a [T,B,1] lower-bound tensor, C as a transposed [B,T]
    view (core/solver.py), and T = 1 and T = 2. Tolerance max|kernel -
    plain| <= 2e-6 + 1e-5 max|plain| on K and k: JAX holds its kernel to
    2e-6 (test_pallas_kernels.py:34-35), and nvcc's FMA contraction moves a
    20-step recursion by a few ulp of its largest values. In the box modes
    more than 10% of the gains must sit at a bound. Teams take no decision
    together: every block size, and the device-memory team store of the
    looped form, must give the bits of the default launch. Returns the
    largest absolute error at nx=5, box, the learned cartpole model's shape."""
    T, B = 20, 1030
    nx_global = next(nx for nx in range(64, 512) if ric.plan(nx, B)["global"])
    main = None

    def held(label, nx, C, c, F, u, kw):
        before = ric.LAUNCHES
        K, k = ric.riccati_fused(nx, C, c, F, u, **kw)
        torch.cuda.synchronize()
        if ric.LAUNCHES != before + 1:
            fail(f"{label}: the kernel did not launch")
        figs, worst = [], 0.0
        for name, a, b in zip(("K", "k"), (K, k), ric.riccati_fused_reference(nx, C, c, F, u,
                                                                             **kw)):
            if not torch.isfinite(a).all():
                fail(f"{label}: non-finite {name}")
            err, scale = (a - b).abs().max().item(), b.abs().max().item()
            figs.append(f"{name} {err:.2e}/{scale:.2e}")
            worst = max(worst, err)
            if err > 2e-6 + 1e-5 * scale:
                fail(f"{label}: {name} off by {err:.3e} at scale {scale:.3e}")
        extra = ""
        if "u_lower" in kw:
            _, lb, ub = ric._operands(C, u, kw["u_lower"], kw["u_upper"], None,
                                      kw.get("delta_u"))
            share = (((k[..., 0] - lb).abs() <= 1e-6)
                     | ((k[..., 0] - ub).abs() <= 1e-6)).float().mean().item()
            extra = f", active share {share:.3f}"
            if share <= 0.1:
                fail(f"{label}: only {share:.3f} of the gains at a bound")
        print(f"parity {label}: max|kernel - plain| / max|plain|: {', '.join(figs)}{extra}",
              flush=True)
        return (K, k), worst

    def same_launch_bits(label, nx, args, kw, ref):
        p = ric.plan(nx, B)
        launches = [(b, "auto") for b in ric.BLOCKS]
        if p["looped"]:
            launches += [(b, "global") for b in ric.BLOCKS]
        for block, store in launches:
            out = ric.riccati_fused(nx, *args, block=block, store=store, **kw)
            if not (torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])):
                fail(f"{label}: block {block}, store {store} change the result")
        print(f"parity {label}: {len(launches)} launches ({ric.BLOCKS} threads a block"
              f"{', shared and device-memory team store' if p['looped'] else ''}) give the bits "
              f"of the default; plan {p}", flush=True)

    for nx in list(range(1, 10)) + [12, 16, 24, 31, 48, nx_global]:
        C, c, F, u, uz = riccati_problem(torch, gen, T, B, nx, dev)
        for mode, kw in (("free", {}), ("box", BOX), ("zero", {"u_zero_I": uz}),
                         ("box delta_u=0.2", dict(BOX, delta_u=0.2))):
            label = f"riccati nx={nx} {mode} B={B} T={T}"
            out, worst = held(label, nx, C, c, F, u, kw)
            if mode == "box" and nx in (5, 31, 48, nx_global):
                same_launch_bits(label, nx, (C, c, F, u), kw, out)
                if nx == 5:
                    main = worst
    for nx in (5, 12, 48):
        for form in ("C expanded", "bound tensor", "C transposed view", "T=1", "T=2"):
            Tf = {"T=1": 1, "T=2": 2}.get(form, T)
            C, c, F, u, uz = riccati_problem(torch, gen, Tf, B, nx, dev)
            if form == "C expanded":
                C = C[0, 0].expand_as(C)
            elif form == "C transposed view":
                C = C.transpose(0, 1).contiguous().transpose(0, 1)
            box = dict(BOX, delta_u=0.2)
            if form == "bound tensor":
                box["u_lower"] = -1.0 - 0.1 * torch.rand(Tf, B, 1, generator=gen).to(dev)
            for mode, kw in (("box delta_u=0.2", box), ("zero", {"u_zero_I": uz})):
                label = f"riccati nx={nx} {form} {mode} B={B} T={Tf}"
                out, _ = held(label, nx, C, c, F, u, kw)
                if form == "C expanded" and mode != "zero":
                    same_launch_bits(label, nx, (C, c, F, u), kw, out)
    return main


def mlp_model(torch, dev, seed):
    """The learned cartpole model: nn_dynamics.make(5, 1), hidden (100,),
    sigmoid, passthrough; its 1,205 weights drawn from numpy's
    RandomState(seed) with the init's distribution U(+-1/sqrt(fan_in))."""
    import numpy as np

    from dilqr_tpu_torch.models import nn_dynamics

    rng = np.random.RandomState(seed)
    params = []
    for n_in, n_out in ((6, 100), (100, 5)):
        W = rng.uniform(-1.0, 1.0, (n_out, n_in)) / math.sqrt(n_in)
        b = rng.uniform(-1.0, 1.0, n_out) / math.sqrt(n_in)
        params.append(tuple(torch.from_numpy(a).to(dev, torch.float32) for a in (W, b)))
    return nn_dynamics.make(5, 1), params


def mlp_parity(torch, ric, cfg, dyn, params, cost, x0):
    """Phase 3, end to end: the learned-model solve (the cartpole bench
    configuration with the MLP dynamics) with backend "auto", whose Riccati
    steps are the kernel (one launch an iteration), and "torch", the plain
    recursion, on the same inputs.

    With random weights this problem is chaotic in f32: no example
    converges in 20 iterations, and from the third iteration on a 2e-7
    nudge of the start moves the plain version's own costs by up to a few
    percent (printed below, plain vs plain nudged). parity()'s bars -- n_iter
    equal, costs within rtol 1e-4 on at least 99% of the examples and 1e-2
    on all, u within 2e-2 -- are therefore held after 2 iterations, where
    rounding has not forked the iterates yet and a wrong gain would show;
    at the serving configuration's 20 iterations the two distances are
    printed side by side and n_iter must agree."""
    import dataclasses

    import dilqr_tpu_torch as P

    B = x0.shape[0]

    def solve(backend, lqr_iter, x):
        before = ric.LAUNCHES
        res = P.solve(dataclasses.replace(cfg, backend=backend, lqr_iter=lqr_iter), x, cost, dyn,
                      params=params, u_lower=-100.0, u_upper=100.0)
        torch.cuda.synchronize()
        want = int(res.n_iter) if backend == "auto" else 0
        if ric.LAUNCHES - before != want:
            fail(f"learned-model solve ({backend}): {ric.LAUNCHES - before} Riccati launches, "
                 f"want {want}")
        if not torch.isfinite(res.costs).all():
            fail(f"learned-model solve ({backend}): non-finite costs")
        return res

    def distance(a, b):
        cost_rel = (a.costs - b.costs).abs() / b.costs.abs().clamp(min=1e-6)
        ex_u = (a.u - b.u).abs().amax(dim=(1, 2))
        text = (f"cost rel max {cost_rel.max().item():.2e} (past 1e-4: "
                f"{int((cost_rel > 1e-4).sum())}/{B}), u max {ex_u.max().item():.2e} (past 2e-3: "
                f"{int((ex_u > 2e-3).sum())}), n_iter {int(a.n_iter)} vs {int(b.n_iter)}")
        return cost_rel, ex_u, text

    for lqr_iter in (2, cfg.lqr_iter):
        k, r = solve("auto", lqr_iter, x0), solve("torch", lqr_iter, x0)
        cost_rel, ex_u, text = distance(k, r)
        print(f"parity learned-model solve B={B} T={cfg.T} lqr_iter={lqr_iter}, kernel vs plain "
              f"Riccati: {text}, mean cost {k.costs.mean().item():.4f}, converged share "
              f"{k.converged.float().mean().item():.4f}", flush=True)
        if int(k.n_iter) != int(r.n_iter):
            fail(f"learned-model solve: n_iter {int(k.n_iter)} (kernel) != {int(r.n_iter)} (plain)")
        if lqr_iter == 2 and (cost_rel.max().item() > 1e-2
                              or int((cost_rel > 1e-4).sum()) > 0.01 * B
                              or ex_u.max().item() > 2e-2):
            fail("learned-model solve: kernel and plain past parity()'s bars after 2 iterations")
        nudged = solve("torch", lqr_iter, x0 * (1.0 + 2e-7))
        print(f"parity learned-model solve lqr_iter={lqr_iter}, plain vs plain with the start "
              f"nudged by 2e-7: {distance(r, nudged)[2]}", flush=True)


def mlp_paths(torch, P, dev, kernels, cfg, dyn, params, cost, cp_dyn, cp_params, gen):
    """Phase 4 for the Riccati kernel, through the entry points, each path
    with every counter zeroed before it and read after it:
    (a) serving with the learned model: MPC.solve at B=4096, one Riccati
        launch an iteration (= n_iter) and none of the whole-solve kernel;
        receding_horizon at B=1024 for 5 steps, planning with the model
        against the true cartpole plant;
    (b) training: the IFT gradient of mean u^2 with respect to every weight
        at B=1024 (the KKT kernel at (5,1) in the backward, the Riccati
        kernel n_iter times in the forward), finite and nonzero, and within
        rtol 1e-3 of the plain backward's on the same forward;
    (c) the other modes on real paths: the unboxed learned-model solve
        (free), the same with a u_zero_I mask (zero; the learned model has
        no device code, so it stays on the plain loop); and the slew-rate
        cartpole (n_state 6) in receding_horizon for 3 steps, now one
        whole-solve launch a step and no Riccati launch, and its IFT
        gradient, whose forward is the whole-solve kernel and whose
        backward is the KKT kernel at (6,1), within rtol 1e-3 of the plain
        backward's.
    Returns the summed launches and the inputs phase 5 times."""
    import dataclasses

    from dilqr_tpu_torch.control import receding_horizon

    total = {name: 0 for name in kernels}
    T = cfg.T
    box = dict(u_lower=-100.0, u_upper=100.0)

    def run(label, fn, want):
        return drive(torch, kernels, total, f"learned-model path {label}", fn, want)

    def check_solve(label, res, got, B):
        if got["riccati_fused"] != int(res.n_iter):
            fail(f"{label}: {got['riccati_fused']} Riccati launches for {int(res.n_iter)} "
                 "iterations")
        if res.x.shape != (B, T, 5) or res.u.shape != (B, T, 1):
            fail(f"{label}: shapes {tuple(res.x.shape)}, {tuple(res.u.shape)}")
        if not (torch.isfinite(res.costs).all() and torch.isfinite(res.x).all()):
            fail(f"{label}: non-finite output")
        print(f"{label}: n_iter {int(res.n_iter)}, mean cost {res.costs.mean().item():.4f}, "
              f"converged share {res.converged.float().mean().item():.4f}, max |u| "
              f"{res.u.abs().max().item():.4f}", flush=True)

    serve = {"ilqr_fused": 0, "kkt_fused": 0, "riccati_fused": None}
    # (a) serving
    mpc = P.MPC(5, 1, T, lqr_iter=cfg.lqr_iter, eps=cfg.eps, linesearch_decay=cfg.linesearch_decay,
                max_linesearch_iter=cfg.max_linesearch_iter, backprop=False,
                exit_unconverged=False, **box)
    x4096 = cartpole_start(torch, gen, 4096, dev)
    label = "(a) serving MPC.solve B=4096"
    res, got = run(label, lambda: mpc.solve(x4096, cost, dyn, params=params), serve)
    check_solve(label, res, got, 4096)
    if res.u.abs().max().item() > 100.0:
        fail(f"{label}: controls outside the box")
    x1024 = cartpole_start(torch, gen, 1024, dev)
    label = "(a) serving receding_horizon B=1024 x5 steps against the true cartpole plant"
    ep, got = run(label, lambda: receding_horizon(cfg, dyn, params, cost, x1024, 5,
                                                  env_step=cp_dyn.step, env_params=cp_params,
                                                  **box), serve)
    if got["riccati_fused"] < 5 or ep.xs.shape != (1024, 6, 5) or not torch.isfinite(ep.xs).all():
        fail(f"{label}: bad closed-loop states or {got['riccati_fused']} launches")
    print(f"{label}: mean cos(theta) per step {ep.xs[:, :, 2].mean(0).tolist()}", flush=True)

    # (b) training
    c_ift = dataclasses.replace(cfg, backprop=True, detach_unconverged=False,
                                backward_mode=P.BackwardMode.IFT)

    def grad(c):
        ws = [tuple(a.clone().requires_grad_(True) for a in layer) for layer in params]
        res = P.solve(c, x1024, cost, dyn, params=ws, **box)
        loss = (res.u ** 2).mean()
        gs = torch.autograd.grad(loss, [a for layer in ws for a in layer])
        return loss.detach(), gs, res.n_iter

    label = "(b) training IFT grad B=1024"
    (loss, gs, n_iter), got = run(label, lambda: grad(c_ift),
                                  {"ilqr_fused": 0, "kkt_fused": None, "riccati_fused": None})
    if got["riccati_fused"] != int(n_iter):
        fail(f"{label}: {got['riccati_fused']} Riccati launches, forward n_iter {int(n_iter)}")
    if not all(torch.isfinite(g).all() and g.abs().max().item() > 0.0 for g in gs):
        fail(f"{label}: a weight's gradient is non-finite or zero")
    # the same forward (deterministic) through the plain KKT recursions;
    # rtol 1e-2 of each leaf's largest entry: f32 recursions and GMRES at
    # iterates that have not converged (see mlp_parity)
    _, gs_ref, _ = grad(dataclasses.replace(c_ift, backward_backend="torch"))
    err = max((g - r).abs().max().item() / r.abs().max().item() for g, r in zip(gs, gs_ref))
    print(f"{label}: loss {loss.item():.6f}, largest |grad| per leaf "
          f"{[round(g.abs().max().item(), 6) for g in gs]}, KKT launches {got['kkt_fused']}, "
          f"rel. diff to the plain backward {err:.2e}", flush=True)
    if err > 1e-2:
        fail(f"{label}: the gradient differs from the plain backward's by {err:.3e}")

    # (c) the free and zero modes with the learned model
    label = "(c) free mode: learned-model solve without a box B=1024"
    res, got = run(label, lambda: P.solve(cfg, x1024, cost, dyn, params=params), serve)
    check_solve(label, res, got, 1024)
    mask = (torch.rand(1024, T, 1, generator=gen) < 0.3).to(dev)
    label = "(c) zero mode: learned-model solve with a u_zero_I mask, no box, B=1024"
    res, got = run(label, lambda: P.solve(cfg, x1024, cost, dyn, params=params, u_zero_I=mask),
                   serve)
    check_solve(label, res, got, 1024)
    if res.u[mask].abs().max().item() != 0.0:
        fail(f"{label}: a masked control is not zero")

    # (c) the slew-rate cartpole (n_state 6), a solve a step on the
    # whole-solve kernel (Passthrough<Cartpole>) and none of the Riccati
    # kernel's, then its gradient
    c_slew = dataclasses.replace(cfg, slew_rate_penalty=1.0)
    label = "(c) slew-rate cartpole receding_horizon B=1024 x3 steps, the whole-solve kernel"
    ep, got = run(label, lambda: receding_horizon(c_slew, cp_dyn, cp_params,
                                                  P.QuadCost(*cost), x1024, 3, **box),
                  {"ilqr_fused": 3, "kkt_fused": 0, "riccati_fused": 0})
    if ep.xs.shape != (1024, 4, 5) or not torch.isfinite(ep.xs).all():
        fail(f"{label}: bad closed-loop states")
    du = (ep.us[:, 1:] - ep.us[:, :-1]).abs().mean().item()
    print(f"{label}: mean |u_t - u_(t-1)| {du:.4f}, mean |u| {ep.us.abs().mean().item():.4f}",
          flush=True)
    c_slew_ift = dataclasses.replace(c_slew, backprop=True, detach_unconverged=False,
                                     backward_mode=P.BackwardMode.IFT)

    def slew_grad(c):
        pr = cp_params.clone().requires_grad_(True)
        res = P.solve(c, x1024, cost, cp_dyn, params=pr, **box)
        (g,) = torch.autograd.grad((res.u ** 2).mean(), pr)
        return g, res.n_iter

    label = ("(c) the slew-rate cartpole IFT grad B=1024, the whole-solve kernel forward, the "
             "KKT kernel at (6,1) in the backward")
    (g, n_iter), got = run(label, lambda: slew_grad(c_slew_ift),
                           {"ilqr_fused": 1, "kkt_fused": None, "riccati_fused": 0})
    g_ref, _ = slew_grad(dataclasses.replace(c_slew_ift, backward_backend="torch"))
    err = (g - g_ref).abs().max().item()
    print(f"{label}: grad params {g.tolist()}, KKT launches {got['kkt_fused']}, whole-solve "
          f"launches {got['ilqr_fused']} (forward n_iter {int(n_iter)}), abs. diff to the "
          f"plain backward {err:.2e}", flush=True)
    if not torch.isfinite(g).all() or g.abs().max().item() == 0.0:
        fail(f"{label}: a non-finite or zero gradient")
    if err > 1e-3 * g_ref.abs().max().item() + 1e-8:
        fail(f"{label}: the gradient differs from the plain backward's by {err:.3e}")
    print(f"learned-model and slew-rate path launches: {total}", flush=True)
    return {"launches": total, "x4096": x4096, "c_ift": c_ift,
            "grad": grad}


def riccati_work(T, B, nx, c_expanded=False):
    """(FLOP, bytes) of one riccati_fused call in box mode from its shapes,
    counted from csrc/riccati_fused.cuh. FLOP per example and step t < T-1:
    the column products V F (N NX (2 NX - 1)), Q's triangle (TRI 2 NX), q
    (N 2 NX), the box gains (2 NX + 8), the V triangle update (7 per entry)
    and v (5 NX + 2); at t = T-1 only the gains and the update. Bytes: the
    function's inputs read once -- C [T,B,n,n] (one [n,n] matrix when it is
    expanded from one), c [T,B,n], F [T-1,B,nx,n], u [T,B,1] -- and its
    outputs K [T,B,1,nx], k [T,B,1] written once."""
    n = nx + 1
    tri = n * (n + 1) // 2
    gains_update = (2 * nx + 8) + 7 * nx * (nx + 1) // 2 + 5 * nx + 2
    step = n * nx * (2 * nx - 1) + tri * 2 * nx + n * 2 * nx + gains_update
    flops = B * ((T - 1) * step + gains_update)
    floats = B * (T * (n + 1 + nx + 1) + (T - 1) * nx * n) + (n * n if c_expanded
                                                            else B * T * n * n)
    return flops, 4 * floats


def riccati_times(torch, P, dev, gen, ric, card, cfg, dyn, params, cost, mp, err):
    """Phase 5 for the Riccati kernel: at the learned-model path's shape
    (T=20, nx=5, box) at B=4096 and B=1024, with C full and C expanded from
    one matrix (the path's example-invariant cost), and at the slew-rate
    shape (nx=6, box, B=1024): the call by CUDA events (host gaps included),
    the kernel alone (the mean of the launches the profiler recorded of 20),
    the bound (riccati_work, an expanded C counted once) and the device
    operations a call, which must be the one kernel launch; the plain
    version at B=4096; then the learned-model MPC.solve end to end with
    backend "auto" and "torch" in turns (host clock, synchronized, median
    of 5 each), a profile of one solve, and the IFT step. Returns the JSON
    row (the B=4096, C full call)."""
    from dilqr_tpu_torch.utils.profiling import kernel_ms

    T = cfg.T
    row = None
    for nx, B in ((5, 4096), (5, 1024), (6, 1024)):
        C, c, F, u, _ = riccati_problem(torch, gen, T, B, nx, dev)
        forms = [("C full", C)] + ([("C expanded", C[0, 0].expand_as(C))] if nx == 5 else [])
        for form, Cf in forms:
            def call():
                return ric.riccati_fused(nx, Cf, c, F, u, **BOX)

            ms, runs = cuda_ms(call, 5, 21)
            k_ms, seen, others = kernel_ms(call, "riccati_fused_kernel")
            if others:
                fail(f"riccati_fused nx={nx} B={B} {form}: other device operations {others}")
            flops, bytes_ = riccati_work(T, B, nx, form == "C expanded")
            bound_ms = max(flops / FP32_PEAK, bytes_ / HBM_RATE) * 1e3
            bound_by = "operations" if flops / FP32_PEAK >= bytes_ / HBM_RATE else "bytes"
            p = ric.plan(nx, B)
            print(f"time riccati_fused B={B} T={T} nx={nx} box {form}: call {ms:.4f} ms median "
                  f"of {len(runs)} ({', '.join(f'{r:.4f}' for r in runs)}); the kernel alone "
                  f"{fmt_ms(k_ms)} (profiler, mean of the {seen} launches it recorded of 20); "
                  f"device operations a call: {1 if seen else 'not seen'} (no other device "
                  f"activity recorded); {p['L']} lanes, {p['teams']} teams a block, "
                  f"{p['smem']} shared bytes a block [{card}]", flush=True)
            print(f"bound riccati_fused B={B} T={T} nx={nx} box {form}: {flops:.4e} FLOP, "
                  f"{bytes_} bytes -> {bound_ms:.5f} ms ({bound_by})", flush=True)
            if row is None:
                plain_ms, _ = cuda_ms(lambda: ric.riccati_fused_reference(nx, C, c, F, u, **BOX),
                                      2, 7)
                print(f"time riccati_fused_reference (plain) B={B} T={T} nx={nx} box: "
                      f"{plain_ms:.3f} ms; no single PyTorch call computes a Riccati "
                      f"recursion, so library_ms is null [{card}]", flush=True)
                row = {
                    "name": "riccati_fused", "route": "cuda",
                    "source": "dilqr_tpu_torch/csrc/riccati_fused.cu",
                    "replaces": "dilqr_tpu/ops/pallas/riccati_fused.py:57",
                    "launches": mp["launches"]["riccati_fused"], "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": None,
                }
                # 20 calls, one learned-model solve's worth
                profile_step(torch, f"riccati_fused wrapper x20 B={B} T={T} nx={nx} box",
                             lambda: [call() for _ in range(20)])

    mpcs = {backend: P.MPC(5, 1, T, lqr_iter=cfg.lqr_iter, eps=cfg.eps,
                           linesearch_decay=cfg.linesearch_decay,
                           max_linesearch_iter=cfg.max_linesearch_iter, backprop=False,
                           exit_unconverged=False, backend=backend, u_lower=-100.0,
                           u_upper=100.0)
            for backend in ("auto", "torch")}

    def solve_ms(backend):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mpcs[backend].solve(mp["x4096"], cost, dyn, params=params)
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) * 1e3

    solve_ms("auto")
    solve_ms("torch")
    t = {"auto": [], "torch": []}
    for order in (("auto", "torch"), ("torch", "auto")) * 2 + (("auto", "torch"),):
        for backend in order:
            t[backend].append(solve_ms(backend))
    print(f"time learned-model MPC.solve B=4096 end to end (host clock, synchronized, median "
          f"of 5, in turns): {statistics.median(t['auto']):.2f} ms with the Riccati kernel "
          f"({', '.join(f'{v:.1f}' for v in t['auto'])}), {statistics.median(t['torch']):.2f} "
          f"ms with the plain recursion ({', '.join(f'{v:.1f}' for v in t['torch'])}) "
          f"[{card}]", flush=True)
    profile_step(torch, "learned-model MPC.solve B=4096 (Riccati kernel)",
                 lambda: mpcs["auto"].solve(mp["x4096"], cost, dyn, params=params))
    ts = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mp["grad"](mp["c_ift"])
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t1) * 1e3)
    print(f"time learned-model IFT forward+backward B=1024 (host clock, synchronized, median "
          f"of 3): {statistics.median(ts):.2f} ms [{card}]", flush=True)
    return row


def lqr_problem(torch, gen, T, B, nx, nu, dev, dtype):
    """tests/test_parallel_riccati.py's well-conditioned random LQR problem
    (C = A A^T + 3 I, F_x = I + 0.08 N, F_u = 0.4 N, f = 0.2 N), with a
    random u_zero_I mask (30% frozen)."""
    n = nx + nu
    A = torch.randn(T, B, n, n, generator=gen, dtype=torch.float64)
    Fx = torch.eye(nx, dtype=torch.float64) + 0.08 * torch.randn(
        T - 1, B, nx, nx, generator=gen, dtype=torch.float64)
    parts = (A @ A.transpose(-1, -2) + 3.0 * torch.eye(n, dtype=torch.float64),
             torch.randn(T, B, n, generator=gen, dtype=torch.float64),
             torch.cat([Fx, 0.4 * torch.randn(T - 1, B, nx, nu, generator=gen,
                                              dtype=torch.float64)], -1),
             0.2 * torch.randn(T - 1, B, nx, generator=gen, dtype=torch.float64),
             torch.randn(B, nx, generator=gen, dtype=torch.float64))
    mask = (torch.rand(T, B, nu, generator=gen) < 0.3).to(dev)
    return [a.to(dev, dtype) for a in parts], mask


def print_turns(card, label, turns):
    figs = [f"{name} {ms:.2f} ms ({', '.join(f'{t:.2f}' for t in runs)})"
            for name, (ms, runs) in turns.items()]
    n = len(next(iter(turns.values()))[1])
    print(f"time {label} (host clock, synchronized, in turns a b b a x{n // 2}, medians of "
          f"{n}): {'; '.join(figs)} [{card}]", flush=True)


# phase 6 (a)'s f32 bar: JAX holds the f32 scan to 5e-4 of the sequential
# recursion at T=128 (tests/test_parallel_riccati.py:54-64), on gains of
# order one; here 5e-4 of the largest |entry| (at least 1), for K, k and x
PLQR_F32_BAR = 5e-4


def parallel_paths(torch, P, dev, kernels, card, cp_dyn, cp_params, cp_q, cp_p, cfg, mlp_dyn,
                   mlp_params):
    """Phase 6, the associative-scan Riccati, the LSTM policy and the
    utilities on the card; every check raises through fail():
    (a) plqr_backward and plqr_solve against the plain sequential
        lqr_backward(backend="torch") and a closed-loop rollout on CUDA
        tensors at the bench width (T=20, B=4096, (5,1)), the same with a
        u_zero_I mask, the rocket width (13,3) (the combine's linalg.solve
        branch) and the long horizon JAX validated (T=512, B=64, (4,2)):
        K, k and x within 1e-10 at f64 and PLQR_F32_BAR at f32; both paths'
        times at f32 (CUDA events, warm-up, median) at the bench width and
        at T=512;
    (b) the cartpole IFT gradient at B=4096 with riccati_parallel=True, the
        backward's auxiliary solve and adjoints as scans: no KKT launch,
        within rtol 1e-3 of the default gradient through the KKT kernel;
        both host-clock times;
    (c) the unboxed learned-model solve at B=4096 with riccati_parallel:
        the plain loop with the scan backward, no Riccati launch, held
        against the same solve through the Riccati kernel after 2
        iterations (mlp_parity's bars);
    (d) ILExp mode 'nn' (the LSTM policy, width 256, Adam) for 2 epochs on
        data/cartpole.npz: finite losses, train_losses.csv and best.ckpt;
        the time an epoch;
    (e) numdiff.grad on the card at f64 against the cartpole's analytic
        jac_lanes and torch.func.jacfwd;
    (f) a verbose=1 solve prints one header and one row an iteration.
    Launches are counted per path, every counter zeroed before it."""
    import contextlib
    import dataclasses
    import io
    import os
    import tempfile

    from dilqr_tpu_torch.il.exp import ILExp
    from dilqr_tpu_torch.ops.parallel_riccati import plqr_backward, plqr_solve
    from dilqr_tpu_torch.ops.riccati import lqr_backward
    from dilqr_tpu_torch.utils import logging as tlog
    from dilqr_tpu_torch.utils import numdiff

    total = {name: 0 for name in kernels}
    none = dict.fromkeys(kernels, 0)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 8)

    def run(label, fn, want):
        return drive(torch, kernels, total, f"phase 6 {label}", fn, want)

    def sequential(nx, nu, C, c, F, f, x0, uz):
        ric = lqr_backward(nx, nu, C, c, F, f, torch.zeros_like(c[..., nx:]), u_zero_I=uz,
                           backend="torch")
        x, xs, us = x0, [], []
        for t in range(C.shape[0]):
            u = torch.einsum("bux,bx->bu", ric.K[t], x) + ric.k[t]
            xs.append(x)
            us.append(u)
            if t < C.shape[0] - 1:
                x = torch.einsum("bij,bj->bi", F[t], torch.cat([x, u], -1)) + f[t]
        return ric.K, ric.k, torch.stack(xs), torch.stack(us)

    # (a)
    cases = [("bench width", 20, 4096, 5, 1, False), ("bench width, u_zero_I", 20, 4096, 5, 1, True),
             ("rocket width", 20, 1024, 13, 3, False), ("long horizon", 512, 64, 4, 2, False)]
    for label, T, B, nx, nu, masked in cases:
        for dtype in (torch.float64, torch.float32):
            (C, c, F, f, x0), mask = lqr_problem(torch, gen, T, B, nx, nu, dev, dtype)
            uz = mask if masked else None
            name = f"(a) plqr {label} T={T} B={B} ({nx},{nu}) {str(dtype)[6:]}"
            (K, k), _ = run(name + " backward", lambda: plqr_backward(nx, nu, C, c, F, f, uz),
                            none)
            res, _ = run(name + " solve", lambda: plqr_solve(nx, nu, C, c, F, f, x0, uz), none)
            rK, rk, rx, ru = sequential(nx, nu, C, c, F, f, x0, uz)
            errs = []
            for what, got, want in (("K", K, rK), ("k", k, rk), ("x", res.x, rx),
                                    ("solve K", res.K, rK), ("u", res.u, ru)):
                err = (got - want).abs().max().item()
                bar = 1e-10 if dtype == torch.float64 else PLQR_F32_BAR * max(
                    1.0, want.abs().max().item())
                errs.append(f"{what} {err:.2e}")
                if not (err <= bar):
                    fail(f"{name}: {what} differs from the sequential path by {err:.3e} "
                         f"(bar {bar:.1e})")
            if masked and (K[mask].abs().max().item() != 0.0 or res.u[mask].abs().max().item()
                           != 0.0):
                fail(f"{name}: a frozen control has a nonzero gain or value")
            print(f"{name}: max |parallel - sequential| {', '.join(errs)}", flush=True)
        if masked:
            continue
        # times at f32 (the last problem drawn): the scan against the
        # sequential recursion, the backward alone and the whole solve
        figs = []
        for what, fn in (("plqr_backward", lambda: plqr_backward(nx, nu, C, c, F, f)),
                         ("lqr_backward torch", lambda: lqr_backward(
                             nx, nu, C, c, F, f, torch.zeros_like(c[..., nx:]), backend="torch")),
                         ("plqr_solve", lambda: plqr_solve(nx, nu, C, c, F, f, x0)),
                         ("sequential solve", lambda: sequential(nx, nu, C, c, F, f, x0, None))):
            ms, runs = cuda_ms(fn, 2, 7)
            figs.append(f"{what} {ms:.3f} ms ({', '.join(f'{r:.3f}' for r in runs)})")
        print(f"time (a) {label} T={T} B={B} ({nx},{nu}) f32, median of 7: {'; '.join(figs)} "
              f"[{card}]", flush=True)

    # (b)
    x0 = cartpole_start(torch, gen, 4096, dev)
    cost = P.QuadCost(torch.diag(cp_q), cp_p)
    c_ift = dataclasses.replace(cfg, backprop=True, detach_unconverged=False,
                                backward_mode=P.BackwardMode.IFT)

    def grad(c):
        pr = cp_params.clone().requires_grad_(True)
        res = P.solve(c, x0, cost, cp_dyn, params=pr, u_lower=cp_dyn.lower, u_upper=cp_dyn.upper)
        (g,) = torch.autograd.grad((res.u ** 2).mean(), pr)
        return g

    c_par = dataclasses.replace(c_ift, riccati_parallel=True)
    label = "(b) IFT grad B=4096 riccati_parallel=True"
    g_par, _ = run(label, lambda: grad(c_par), {"ilqr_fused": 1, "kkt_fused": 0,
                                                "riccati_fused": 0})
    g_ref, got = run("(b) IFT grad B=4096, the default (the KKT kernel)", lambda: grad(c_ift),
                     {"ilqr_fused": 1, "kkt_fused": None, "riccati_fused": 0})
    err = (g_par - g_ref).abs().max().item() / g_ref.abs().max().item()
    print(f"{label}: grad params {g_par.tolist()}, the default's {g_ref.tolist()} "
          f"({got['kkt_fused']} KKT launches), max-norm rel. diff {err:.2e}", flush=True)
    if not torch.isfinite(g_par).all() or err > 1e-3:
        fail(f"{label}: the gradient differs from the default's by {err:.3e}")
    print_turns(card, "(b) IFT forward+backward B=4096", host_ms_in_turns(
        {"riccati_parallel": lambda: grad(c_par), "the default": lambda: grad(c_ift)}))

    # (c)
    xm = cartpole_start(torch, gen, 4096, dev)
    B = xm.shape[0]

    def mlp_solve(c):
        return P.solve(c, xm, cost, mlp_dyn, params=mlp_params)

    c2 = dataclasses.replace(cfg, lqr_iter=2)
    label = "(c) learned-model solve, no box, B=4096, riccati_parallel=True"
    par, _ = run(label + " lqr_iter=2", lambda: mlp_solve(dataclasses.replace(
        c2, riccati_parallel=True)), none)
    ker, got = run("(c) the same through the Riccati kernel", lambda: mlp_solve(c2),
                   {"ilqr_fused": 0, "kkt_fused": 0, "riccati_fused": None})
    if got["riccati_fused"] != int(ker.n_iter):
        fail(f"(c): {got['riccati_fused']} Riccati launches for {int(ker.n_iter)} iterations")
    cost_rel = (par.costs - ker.costs).abs() / ker.costs.abs().clamp(min=1e-6)
    du = (par.u - ker.u).abs().max().item()
    print(f"{label}: after 2 iterations, against the kernel: cost rel max "
          f"{cost_rel.max().item():.2e} (past 1e-4: {int((cost_rel > 1e-4).sum())}/{B}), u max "
          f"{du:.2e}, n_iter {int(par.n_iter)} vs {int(ker.n_iter)}", flush=True)
    if (int(par.n_iter) != int(ker.n_iter) or not torch.isfinite(par.costs).all()
            or cost_rel.max().item() > 1e-2 or int((cost_rel > 1e-4).sum()) > 0.01 * B
            or du > 2e-2):
        fail(f"{label}: past mlp_parity's bars after 2 iterations")
    c20_par = dataclasses.replace(cfg, riccati_parallel=True)
    print_turns(card, f"(c) learned-model solve, no box, B=4096, lqr_iter={cfg.lqr_iter}",
                host_ms_in_turns({"riccati_parallel": lambda: mlp_solve(c20_par),
                                  "the Riccati kernel": lambda: mlp_solve(cfg)}))

    # (d)
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "cartpole.npz")
    with tempfile.TemporaryDirectory() as work:
        exp = ILExp.from_cli(["--env", "cartpole", "--data", data, "--mode", "nn", "--n_epoch",
                              "2", "--n_batch", "32", "--n_train", "100", "--work", work],
                             device="cuda")
        t1 = time.perf_counter()
        best, _ = run("(d) ILExp nn cartpole 2 epochs", lambda: exp.run(verbose=False), none)
        epoch_ms = (time.perf_counter() - t1) * 1e3 / 2
        with open(os.path.join(exp.save, "train_losses.csv")) as fh:
            rows = [list(map(float, line.split(","))) for line in fh.read().splitlines()[1:]]
        ok = os.path.exists(os.path.join(exp.save, "best.ckpt"))
    on_card = all(v.is_cuda for v in exp.params.values())
    print(f"(d) ILExp nn: LSTM width {exp.lstm.n_hidden}, {len(rows)} steps, train losses "
          f"{[r[1] for r in rows]}, best val loss {best:.6f}, parameters on the card {on_card}",
          flush=True)
    if not (ok and on_card and rows and math.isfinite(best)
            and all(math.isfinite(v) for r in rows for v in r)):
        fail("(d) ILExp nn: non-finite losses, no checkpoint or parameters off the card")
    print(f"time (d) ILExp nn cartpole: {epoch_ms:.1f} ms an epoch ({len(rows) // 2} steps of "
          f"32 and the validation and test losses; host clock, the first 2 epochs) [{card}]",
          flush=True)

    # (e)
    xe = cartpole_start(torch, gen, 4096, dev).double()
    ue = (10.0 * torch.randn(4096, 1, generator=gen, dtype=torch.float64)).to(dev)
    pe = cp_params.double()
    xu = torch.cat([xe, ue], -1)
    step = cp_dyn.step_unclamped
    nd = torch.stack([numdiff.grad(lambda v, i=i: step(v[:, :5], v[:, 5:], pe)[:, i], xu)
                      for i in range(5)], 1)
    exact = cp_dyn.jac_lanes(xe, ue, pe)
    jf = torch.func.vmap(torch.func.jacfwd(lambda v: step(v[:5], v[5:], pe)))(xu)
    e_lanes = (nd - exact).abs().max().item()
    e_jf = (nd - jf).abs().max().item()
    bar = 1e-6 * max(1.0, exact.abs().max().item())
    print(f"(e) numdiff.grad of the cartpole step at f64, B=4096: max |numdiff - jac_lanes| "
          f"{e_lanes:.2e}, max |numdiff - jacfwd| {e_jf:.2e} (bar {bar:.1e}), on the card "
          f"{nd.is_cuda}", flush=True)
    if not (nd.is_cuda and e_lanes <= bar and e_jf <= bar):
        fail("(e) numdiff.grad disagrees with the analytic Jacobian")

    # (f)
    tlog._seen_tables.discard("ilqr")
    buf = io.StringIO()
    c_verbose = dataclasses.replace(cfg, lqr_iter=5, eps=0.0, verbose=1, backend="torch")
    with contextlib.redirect_stdout(buf):
        res, _ = run("(f) verbose solve", lambda: P.solve(
            c_verbose, x0[:1024], cost, cp_dyn, params=cp_params, u_lower=cp_dyn.lower,
            u_upper=cp_dyn.upper), none)
    lines = buf.getvalue().splitlines()
    print("\n".join(lines), flush=True)
    table = [ln for ln in lines if ln.startswith("| ")]
    heads = [ln for ln in table if ln == "| du_max | iter | mean_alpha | mean_cost |"]
    if len(heads) != 1 or table[0] != heads[0] or len(table) != 1 + int(res.n_iter):
        fail(f"(f) verbose solve: {len(heads)} header(s) and {len(table) - len(heads)} rows for "
             f"{int(res.n_iter)} iterations")
    print(f"phase 6 launches: {total}", flush=True)


def variant_work(cfg, B, cost, lo, hi, u0, kw):
    """Bytes of one whole-solve call with the MPC variants, each input read
    once and each output written once: x_init, the cost (the per-example
    form [T, B, n*n] and [T, B, n], or one [n,n] and [n]), per-time and
    per-example bounds [T, B, nu] each, the mask as bytes, the warm start,
    x, u, costs, du."""
    T, nx, nu = cfg.T, cfg.n_state, cfg.n_ctrl
    n = nx + nu
    C = cost[0]
    by = 4 * B * nx + 4 * (C.numel() + cost[1].numel())
    by += sum(4 * T * B * nu for v in (lo, hi) if hasattr(v, "dim") and v.dim() == 3)
    by += T * B * nu if kw.get("u_zero_I") is not None else 0
    by += 4 * T * B * nu if u0 is not None else 0
    return by + 4 * (T * B * n + 2 * B)


def variant_paths(torch, P, dev, kernels, card, fused, cfgs, envs, gen):
    """Phase 7: the whole-solve kernel's MPC variants and the slew rate
    (Passthrough<Env> in csrc/ilqr_fused.cuh), at full width: cartpole
    B=4096 and the rocket B=1024, T=20, bench.py's starts and costs.
    (a) parity: the kernel against its plain version on the same CUDA
        inputs (parity's tolerances, the x and u bounds on the examples
        converged in both, with a witness -- the plain version from starts
        one ulp away -- where an unconverged example passes them; for the
        rocket also rocket_checks'), the same bits at every cluster size the
        instantiation has, for a per-example cost (weights scaled in [1,
        1.5] per step and example), per-time and per-example bounds that
        bind, a u_zero_I mask over about 35% of the entries with the box
        and without it (the masked u exactly 0 in both versions), delta_u =
        0.4 (the rocket warm-started at hover and run for 30 iterations:
        in steps of 0.4 none of its examples converges in 15), and the slew
        rate (penalty 1.0) on cartpole,
        the pendulum (B=1030) and the rocket;
    (b) the paths through their entry points, every counter zeroed before
        each and read after: MPC.solve with slew_rate_penalty=1.0 on
        cartpole B=4096 and the rocket B=1024, receding_horizon with it
        (B=1024; cartpole 5 steps, the rocket 3), each solve one
        whole-solve launch and no Riccati launch; MPC.solve on cartpole
        B=4096 with u_zero_I and delta_u, and with a per-example cost and
        per-time bounds; the slew-rate cartpole's IFT gradient at B=4096
        (forward: one whole-solve launch; backward: the KKT kernel);
    (c) each (b) serving path's host time against the same call with
        backend="torch" (the plain loop), in turns (a b b a, once: the
        plain loop takes seconds a call), and the
        device idle share of one profiled slew-rate receding_horizon step.
    Returns (the launches of (b), the largest |kernel - plain| of (a)'s x
    and u, the variants' figures and the paths' figures for the JSON
    line)."""
    import dataclasses

    from dilqr_tpu_torch.control import receding_horizon
    from dilqr_tpu_torch.core.solver import augment_slew_rate, canonicalize_cost
    from dilqr_tpu_torch.models import rocket

    bench_cfg, r_cfg, pd_cfg = cfgs
    T = bench_cfg.T
    cp_dyn, cp_params, cp_q, cp_p = envs["cartpole"]
    pd_dyn, pd_params, pd_q, pd_p = envs["pendulum"]
    r_dyn, r_params, r_q, r_p = envs["rocket"]
    r_lo, r_hi = r_dyn.lower.to(dev), r_dyn.upper.to(dev)

    def rand(*shape):
        return torch.rand(*shape, generator=gen).to(dev)

    def per_example(q, p, B):
        w = 1.0 + 0.5 * rand(T, B, 1)
        n = q.shape[0]
        return (torch.diag(q).expand(T, B, n, n) * w[..., None]).contiguous(), \
            (p.expand(T, B, n) * w).contiguous()

    # ---- (a) parity ----
    variants, worst = [], 0.0
    problems = (
        ("cartpole B=4096", bench_cfg, cp_dyn, cp_params, cp_q, cp_p,
         cartpole_start(torch, gen, 4096, dev), -100.0, 100.0),
        ("rocket B=1024", r_cfg, r_dyn, r_params, r_q, r_p,
         rocket.bench_start(1024, gen, device=dev), r_lo, r_hi),
    )
    for env, cfg, dyn, params, q, p, x0, lo, hi in problems:
        B, nu = x0.shape[0], cfg.n_ctrl
        small = (torch.diag(q), p)
        if nu == 1:  # the bench solution's |u| is below 1.4
            hi_t = 0.1 + 0.5 * rand(T, B, 1)
        else:
            hi_t = torch.stack([8.0 + 2.0 * rand(T, B), 0.05 + 0.1 * rand(T, B),
                                0.05 + 0.1 * rand(T, B)], -1)
        mask = rand(T, B, nu) < 0.35
        hover = None if nu == 1 else torch.tensor([10.0, 0.0, 0.0], device=dev).expand(
            T, B, 3).contiguous()
        # the rocket's trust-region case runs 30 iterations: in steps of 0.4
        # its examples converge after some 25
        du_cfg = cfg if nu == 1 else dataclasses.replace(cfg, lqr_iter=30)
        cases = [
            ("per-example cost", cfg, per_example(q, p, B), None, lo, hi, {}),
            ("per-time and per-example bounds", cfg, small, None, -hi_t, hi_t, {}),
            ("u_zero_I 35%, boxed", cfg, small, None, lo, hi, {"u_zero_I": mask}),
            ("u_zero_I 35%, unboxed", cfg, small, None, None, None, {"u_zero_I": mask}),
            (f"delta_u 0.4, lqr_iter {du_cfg.lqr_iter}", du_cfg, small, hover, lo, hi,
             {"delta_u": 0.4}),
        ]
        for what, c_cfg, cost, u0, lo_c, hi_c, kw in cases:
            label = f"phase 7 (a) {env} T={T} {what}"
            variants.append(variant_case(torch, fused, card, label, c_cfg, dyn, params, x0,
                                         cost, u0, lo_c, hi_c, kw))
            worst = max(worst, variants[-1]["max_abs_err"])
            if what.startswith("per-time"):
                k_u = variants[-1]["u"]
                share = ((k_u.abs() - hi_t).abs() < 1e-6).float().mean().item()
                print(f"{label}: share of controls at their bound {share:.3f}", flush=True)
                if share < 0.02:
                    fail(f"{label}: the bounds do not bind ({share:.3f} of the controls)")
            if what.startswith("delta_u"):
                k_u = variants[-1]["u"]
                start = 0.0 if u0 is None else u0
                reach = (k_u - start).abs().max().item()
                n_iter = variants[-1]["n_iter"]
                print(f"{label}: largest |u - u_init| {reach:.4f} after {n_iter} iterations "
                      f"(at most {n_iter} x 0.4)", flush=True)
                if reach > 0.4 * n_iter + 1e-4:
                    fail(f"{label}: u moved past n_iter x delta_u")
    slews = (
        ("cartpole B=4096", bench_cfg, cp_dyn, cp_params, cp_q, cp_p,
         cartpole_start(torch, gen, 4096, dev), -100.0, 100.0),
        ("pendulum B=1030", pd_cfg, pd_dyn, pd_params, pd_q, pd_p,
         torch.stack([(th := -1.5 + 3.0 * torch.rand(1030, generator=gen)).cos(), th.sin(),
                      0.5 * torch.randn(1030, generator=gen)], 1).to(dev),
         pd_dyn.lower, pd_dyn.upper),
        ("rocket B=1024", r_cfg, r_dyn, r_params, r_q, r_p,
         rocket.bench_start(1024, gen, device=dev), r_lo, r_hi),
    )
    for env, cfg, dyn, params, q, p, x0, lo, hi in slews:
        B = x0.shape[0]
        cost = canonicalize_cost(P.QuadCost(torch.diag(q), p), T, B, cfg.n_state + cfg.n_ctrl)
        a_cfg, a_cost, a_dyn, a_params, a_x0 = augment_slew_rate(
            dataclasses.replace(cfg, slew_rate_penalty=1.0), cost, dyn, params, x0, None)
        label = f"phase 7 (a) slew rate 1.0 {env} T={T} (n_state {a_cfg.n_state})"
        variants.append(variant_case(torch, fused, card, label, a_cfg, a_dyn, a_params, a_x0,
                                     (a_cost.C, a_cost.c), None, lo, hi, {}))
        worst = max(worst, variants[-1]["max_abs_err"])
    for v in variants:
        del v["u"]
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) the entry points ----
    total = {name: 0 for name in kernels}
    one = {"ilqr_fused": 1, "kkt_fused": 0, "riccati_fused": 0}

    def run(label, fn, want):
        return drive(torch, kernels, total, f"phase 7 (b) {label}", fn, want)

    def check(label, res, B, nx, nu, bound):
        if res.x.shape != (B, T, nx) or res.u.shape != (B, T, nu):
            fail(f"{label}: shapes {tuple(res.x.shape)}, {tuple(res.u.shape)}")
        if not (torch.isfinite(res.costs).all() and torch.isfinite(res.x).all()):
            fail(f"{label}: non-finite output")
        if bound is not None and (res.u.abs() - bound).max().item() > 1e-5:
            fail(f"{label}: controls outside the box")
        print(f"{label}: n_iter {int(res.n_iter)}, mean cost {res.costs.mean().item():.4f}, "
              f"converged share {res.converged.float().mean().item():.4f}", flush=True)

    cp_cost = P.QuadCost(torch.diag(cp_q), cp_p)
    r_cost = P.QuadCost(torch.diag(r_q), r_p)
    cp_kw = dict(lqr_iter=20, eps=1e-4, linesearch_decay=0.5, max_linesearch_iter=2,
                 backprop=False, exit_unconverged=False)
    r_kw = dict(lqr_iter=r_cfg.lqr_iter, eps=r_cfg.eps, linesearch_decay=r_cfg.linesearch_decay,
                max_linesearch_iter=r_cfg.max_linesearch_iter, backprop=False,
                exit_unconverged=False)
    x4096 = cartpole_start(torch, gen, 4096, dev)
    x1024 = cartpole_start(torch, gen, 1024, dev)
    xr = rocket.bench_start(1024, gen, device=dev)
    mask = (torch.rand(4096, T, 1, generator=gen) < 0.35).to(dev)
    C_b, c_b = per_example(cp_q, cp_p, 4096)
    lanes_cost = P.QuadCost(C_b.transpose(0, 1), c_b.transpose(0, 1))  # batch-major
    hi_time = (0.2 + 0.6 * torch.rand(T, 1, generator=gen)).to(dev)  # [T, nu], binding

    # name -> (call(backend), B, nx, nu, box, launches a call, steps a call)
    paths = {
        "MPC.solve slew rate cartpole B=4096": (
            lambda be: P.MPC(5, 1, T, u_lower=-100.0, u_upper=100.0, slew_rate_penalty=1.0,
                             backend=be, **cp_kw).solve(x4096, cp_cost, cp_dyn,
                                                        params=cp_params),
            4096, 5, 1, 100.0, 1),
        "MPC.solve slew rate rocket B=1024": (
            lambda be: P.MPC(13, 3, T, u_lower=r_lo, u_upper=r_hi, slew_rate_penalty=1.0,
                             backend=be, **r_kw).solve(xr, r_cost, r_dyn, params=r_params),
            1024, 13, 3, 20.0, 1),
        "receding_horizon slew rate cartpole B=1024 x5 steps": (
            lambda be: receding_horizon(
                dataclasses.replace(bench_cfg, slew_rate_penalty=1.0, backend=be), cp_dyn,
                cp_params, cp_cost, x1024, 5, u_lower=-100.0, u_upper=100.0),
            1024, 5, 1, 100.0, 5),
        "receding_horizon slew rate rocket B=1024 x3 steps": (
            lambda be: receding_horizon(
                dataclasses.replace(r_cfg, slew_rate_penalty=1.0, backend=be), r_dyn,
                r_params, r_cost, xr, 3, u_lower=r_lo, u_upper=r_hi),
            1024, 13, 3, 20.0, 3),
        "MPC.solve cartpole B=4096 u_zero_I 35% and delta_u 0.4": (
            lambda be: P.MPC(5, 1, T, u_lower=-100.0, u_upper=100.0, u_zero_I=mask,
                             delta_u=0.4, backend=be, **cp_kw).solve(
                x4096, cp_cost, cp_dyn, params=cp_params),
            4096, 5, 1, 100.0, 1),
        "MPC.solve cartpole B=4096 per-example cost, per-time bounds": (
            lambda be: P.MPC(5, 1, T, u_lower=-hi_time, u_upper=hi_time, backend=be,
                             **cp_kw).solve(x4096, lanes_cost, cp_dyn, params=cp_params),
            4096, 5, 1, None, 1),
    }
    for label, (call, B, nx, nu, box, n) in paths.items():
        out, _ = run(label, lambda: call("auto"), {**one, "ilqr_fused": n})
        if label.startswith("receding_horizon"):
            if out.xs.shape != (B, n + 1, nx) or not torch.isfinite(out.xs).all():
                fail(f"{label}: bad closed-loop states")
            if out.us.abs().max().item() > box + 1e-5:
                fail(f"{label}: actions outside the box")
            du = (out.us[:, 1:] - out.us[:, :-1]).abs().mean().item()
            print(f"{label}: mean |u_t - u_(t-1)| {du:.4f}, mean |u| "
                  f"{out.us.abs().mean().item():.4f}", flush=True)
            continue
        check(f"phase 7 (b) {label}", out, B, nx, nu, box)
        if "u_zero_I" in label:
            if out.u[mask].abs().max().item() != 0.0:
                fail(f"{label}: a masked control is not zero")
        if "per-time" in label:
            if (out.u.abs() - hi_time[None]).max().item() > 1e-5:
                fail(f"{label}: controls outside their per-time bounds")

    # the slew-rate IFT gradient: the whole-solve kernel forward, the KKT
    # kernel at (6,1) in the backward, within rtol 1e-3 of the plain backward
    c_ift = dataclasses.replace(bench_cfg, slew_rate_penalty=1.0, backprop=True,
                                detach_unconverged=False, backward_mode=P.BackwardMode.IFT)

    def slew_grad(c):
        pr = cp_params.clone().requires_grad_(True)
        res = P.solve(c, x4096, cp_cost, cp_dyn, params=pr, u_lower=-100.0, u_upper=100.0)
        (g,) = torch.autograd.grad((res.u ** 2).mean(), pr)
        return g

    label = "slew-rate cartpole IFT grad B=4096"
    g, _ = run(label, lambda: slew_grad(c_ift),
               {"ilqr_fused": 1, "kkt_fused": None, "riccati_fused": 0})
    g_ref = slew_grad(dataclasses.replace(c_ift, backward_backend="torch"))
    err = (g - g_ref).abs().max().item()
    print(f"phase 7 (b) {label}: grad params {g.tolist()}, abs. diff to the plain backward "
          f"{err:.2e}", flush=True)
    if not torch.isfinite(g).all() or g.abs().max().item() == 0.0:
        fail(f"{label}: a non-finite or zero gradient")
    if err > 1e-3 * g_ref.abs().max().item() + 1e-8:
        fail(f"{label}: the gradient differs from the plain backward's by {err:.3e}")
    print(f"phase 7 (b) launches: {total}", flush=True)

    # ---- (c) times: the kernel path against the plain loop, in turns ----
    figures = []
    for label, (call, B, nx, nu, box, n) in paths.items():
        if label.startswith("receding_horizon slew rate rocket"):
            continue  # driven in (b); its solves are the rocket MPC.solve's
        # one round, a b a: the plain loop takes seconds a call, and the
        # script's time limit is fixed
        got = host_ms_in_turns({"kernel": lambda: call("auto"),
                                "plain loop": lambda: call("torch")}, rounds=1,
                               warm_both=False, b_once=True)
        (k_ms, k_runs), (t_ms, t_runs) = got["kernel"], got["plain loop"]
        per = f" ({k_ms / n:.3f} ms a step)" if n > 1 else ""
        print(f"time phase 7 {label}: {k_ms:.3f} ms{per} with the whole-solve kernel, "
              f"{t_ms:.3f} ms with backend='torch' (host clock, synchronized, median of "
              f"{len(k_runs)} in turns: {', '.join(f'{r:.3f}' for r in k_runs)} / "
              f"{', '.join(f'{r:.3f}' for r in t_runs)}) [{card}]", flush=True)
        figures.append({"name": label, "launches": n, "ms": k_ms, "torch_ms": t_ms})
    call = paths["receding_horizon slew rate cartpole B=1024 x5 steps"][0]
    c_one = dataclasses.replace(bench_cfg, slew_rate_penalty=1.0)
    profile_step(torch, "phase 7 slew-rate receding_horizon step cartpole B=1024",
                 lambda: receding_horizon(c_one, cp_dyn, cp_params, cp_cost, x1024, 1,
                                          u_lower=-100.0, u_upper=100.0),
                 counted=(fused, "ilqr_fused_kernel"))
    return total, worst, variants, figures


def variant_case(torch, fused, card, label, cfg, dyn, params, x0, cost, u0, lo, hi, kw,
                 rocket=True, conv_eps=None):
    """One (a) case of phase 7 (and of phases 9 and 10, by jvp_case and
    small_mlp_case): parity, the same bits at every cluster size, rocket_checks
    for three controls (unless ``rocket`` is False), the masked u exactly
    0, and the
    kernel's time (CUDA events, median of 5) beside the plain version's
    (one run, host clock) and the byte bound. Returns the JSON figures and
    the kernel's u."""
    err, k_out, r_out = parity(torch, fused, label, dyn, params, cfg, x0, cost, u0, lo, hi,
                               converged_only=True, conv_eps=conv_eps, **kw)
    plain_ms = parity.plain_ms
    past = parity.past
    if bool(past.any()):
        # the witness: the plain version itself, from starts one ulp away
        nudged = fused.ilqr_fused_reference(cfg, dyn, params, torch.nextafter(
            x0, torch.full_like(x0, float("inf"))), cost, u0, lo, hi, **kw)
        moved = (nudged[1] - r_out[1]).abs().amax(dim=(0, 2))
        print(f"parity {label}: the plain version from starts 1 ulp away moves u by up to "
              f"{moved.max().item():.2e} ({int((moved > 2e-2).sum())} examples past 2e-2; on "
              f"the kernel's {int(past.sum())}: up to {moved[past].max().item():.2e})",
              flush=True)
    same_bits(torch, fused, label, k_out, (cfg, dyn, params, x0, cost, u0, lo, hi), **kw)
    nu = cfg.n_ctrl
    if nu == 3 and rocket:
        inf = torch.full((3,), float("inf"), device=x0.device)
        rocket_checks(label, cfg, k_out, r_out, -inf if lo is None else lo,
                      inf if hi is None else hi)
    mask = kw.get("u_zero_I")
    if mask is not None:
        if k_out[1][mask].abs().max().item() != 0.0 or r_out[1][mask].abs().max().item() != 0.0:
            fail(f"{label}: a masked control is not exactly zero")
        print(f"{label}: {mask.float().mean().item():.3f} of the controls masked, all exactly 0",
              flush=True)
    ms, runs = cuda_ms(lambda: fused.ilqr_fused(cfg, dyn, params, x0, cost, u0, lo, hi, **kw),
                       1, 5)
    bytes_ = variant_work(cfg, x0.shape[0], cost, lo, hi, u0, kw)
    bound = bytes_ / HBM_RATE * 1e3
    print(f"time {label}: {ms:.3f} ms median of {len(runs)} "
          f"({', '.join(f'{r:.3f}' for r in runs)}); plain version {plain_ms:.1f} ms (one run, "
          f"host clock); {bytes_} bytes -> byte bound {bound:.4f} ms [{card}]", flush=True)
    return {"name": label.replace("phase 7 (a) ", ""), "ms": ms, "plain_ms": plain_ms,
            "byte_bound_ms": bound, "max_abs_err": err, "n_iter": int(k_out[4]), "u": k_out[1]}


# phase 8's LinDx shapes (n_state, n_ctrl, per-example cost), one library
# each, built in phase 2 beside the other sources: the slice's (3,2) in both
# cost forms, its slew rate (5,2), n_ctrl 4..8 at 4 states, the gate's edges
# (15,2) and (11,8), and one control in registers (6,1) and past them (15,1)
LINDX_SHAPES = ((3, 2, True), (3, 2, False), (5, 2, True), (4, 4, True), (4, 5, True),
                (4, 6, True), (4, 7, True), (4, 8, True), (15, 2, True), (11, 8, True),
                (6, 1, True), (15, 1, True),
                # phase 13 (d)'s gradient fuzz draws these
                (3, 1, True), (4, 1, True), (4, 2, True))
# LinDx<NX, NU> in the whole-solve kernel's mangled name
LINDX_NAME = r"LinDxILi(\d+)ELi(\d+)EE"


def lindx_ptxas(fused, reports):
    """Phase 2 for the LinDx libraries: each one's instantiations with
    their registers, stack and spills; a missing instantiation (one per
    cluster size the shape fits) fails, and so does a stack or a spill at
    the slice's shape (3,2) or at one control with at most 6 states (the
    register path)."""
    for nx, nu, lanes in LINDX_SHAPES:
        rep = reports[fused.lindx_spec(nx, nu, lanes)]
        seen = 0
        for name, regs, stack, st, ld in ptxas_entries(rep, ILQR_ENTRY, "LinDx"):
            name = re.sub(LINDX_NAME, r"LinDx<\1, \2>", name)
            print(f"ptxas ilqr_lindx {name}: {regs} registers, {stack} bytes stack, {st}/{ld} "
                  f"bytes spill stores/loads", flush=True)
            seen += 1
            if ((nx, nu) == (3, 2) or (nu == 1 and nx <= fused.REGISTER_NX)) and (
                    stack or st or ld):
                fail(f"ilqr_lindx {name} has a stack frame or spills")
        if seen != len(fused.lindx_clusters(nx, nu)):
            fail(f"ilqr_lindx ({nx}, {nu}) lanes {lanes}: {seen} instantiations, want "
                 f"{len(fused.lindx_clusters(nx, nu))}")


def riccati_trial_flops(nx, nu):
    """FP32 operations of one Riccati step (V F, F^T V F on a triangle,
    C tau + c, F^T v, the gains and the V/v update) and of one line-search
    trial without its step (K dx, the objective), per example."""
    n = nx + nu
    return (2 * nx * nx * n + nx * n * (n + 1) + 2 * n * n + 2 * nx * n
            + 6 * nu * nx * nx + 4 * nu * nu * nx + nu ** 3 + 2 * nu * nx + 2 * n * n + 3 * n)


def lindx_bound(fused, cfg, B, cost, dyn, lo, hi, kw, tile_iters):
    """The least time of one LinDx solve: (ms, "bytes" or "operations",
    FLOP, bytes). Bytes: each input read once (x_init, the cost in its
    form, F, f, tensor bounds, the mask as bytes) and each output written
    once (x, u, costs, du). Operations: per example, step and iteration its
    tile ran, the Riccati step's products (V F, F^T V F on a triangle, C tau
    + c, F^T v, the gains and the V/v update) and one line-search trial (K
    dx, the step F tau + f, the objective); the box-QP's Newton steps depend
    on the data and are not counted, so this is a lower bound."""
    T, nx, nu = cfg.T, cfg.n_state, cfg.n_ctrl
    n = nx + nu
    ins = [cost[0], cost[1], dyn[0]] + [a for a in (dyn[1], lo, hi) if hasattr(a, "dim")]
    by = 4 * B * nx + sum(4 * a.numel() for a in ins)
    by += T * B * nu if kw.get("u_zero_I") is not None else 0
    by += 4 * (T * B * n + 2 * B)
    per_t = riccati_trial_flops(nx, nu) + 2 * nx * n  # the step F tau
    flops = per_t * T * sum(it * min(fused.TILE, B - g * fused.TILE)
                            for g, it in enumerate(tile_iters))
    t_ops, t_by = flops / FP32_PEAK * 1e3, by / HBM_RATE * 1e3
    return max(t_ops, t_by), ("operations" if t_ops >= t_by else "bytes"), flops, by


def tile_iters_of(fused, cfg, dyn, x0, cost, lo, hi, kw):
    """Iterations each 1024-example tile of a LinDx solve ran: one launch
    per tile's own examples (tiles are independent)."""
    import dilqr_tpu_torch as P

    its = []
    for g in range(0, x0.shape[0], fused.TILE):
        sl = slice(g, g + fused.TILE)

        def cut(a):
            return a[:, sl] if hasattr(a, "dim") and a.dim() >= 3 else a
        c = tuple(cut(a) for a in cost)
        d = P.LinDx(cut(dyn[0]), None if dyn[1] is None else cut(dyn[1]))
        k = {name: cut(v) for name, v in kw.items()}
        its.append(int(fused.ilqr_fused(cfg, d, None, x0[sl], c, None, cut(lo), cut(hi),
                                        **k)[4]))
    return its


def lindx_case(torch, fused, card, label, cfg, dyn, x0, cost, lo, hi, kw):
    """One (a) case of phase 8: parity (its tolerances, x and u held on the
    examples converged in both), the same bits at every cluster size the
    shape's library has, the masked u exactly 0, and the kernel's time
    (CUDA events, median of 5) beside the plain version's (one run, host
    clock) and the bound. Returns the JSON figures."""
    err, k_out, r_out = parity(torch, fused, label, dyn, None, cfg, x0, cost, None, lo, hi,
                               converged_only=True, **kw)
    plain_ms = parity.plain_ms
    same_bits(torch, fused, label, k_out, (cfg, dyn, None, x0, cost, None, lo, hi), **kw)
    mask = kw.get("u_zero_I")
    if mask is not None:
        if k_out[1][mask].abs().max().item() != 0.0 or r_out[1][mask].abs().max().item() != 0.0:
            fail(f"{label}: a masked control is not exactly zero")
        print(f"{label}: {mask.float().mean().item():.3f} of the controls masked, all exactly 0",
              flush=True)
    ms, runs = cuda_ms(lambda: fused.ilqr_fused(cfg, dyn, None, x0, cost, None, lo, hi, **kw),
                       1, 5)
    its = tile_iters_of(fused, cfg, dyn, x0, cost, lo, hi, kw)
    bound, by_what, flops, by = lindx_bound(fused, cfg, x0.shape[0], cost, dyn, lo, hi, kw, its)
    info = fused.lindx_info(cfg.n_state, cfg.n_ctrl, 0, cost[0].dim() == 4)
    print(f"time {label}: {ms:.3f} ms median of {len(runs)} "
          f"({', '.join(f'{r:.3f}' for r in runs)}); plain version {plain_ms:.1f} ms (one run, "
          f"host clock); {flops:.3e} FLOP, {by} bytes -> bound {bound:.4f} ms ({by_what}); "
          f"tile iterations {its}; G={info['cluster']}, V/Q/F in {info['store']}, "
          f"{info['registers']} registers, {info['local_bytes']} local bytes, "
          f"cudaOccupancyMaxActiveClusters {info['max_active_clusters']} [{card}]", flush=True)
    return {"name": label.replace("phase 8 (a) ", ""), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by_what, "max_abs_err": err,
            "n_iter": int(k_out[4])}


def lindx_paths(torch, P, dev, kernels, card, fused, gen):
    """Phase 8: LinDx (time-varying affine LQR) problems and n_ctrl 2..8 on
    the whole-solve kernel (LinDx<NX, NU>, one library per shape from
    csrc/ilqr_lindx.cu), on lqr_problem's random problems (C = A A^T + 3 I,
    F = [I + 0.08 N | 0.4 N], f = 0.2 N), T=10.
    (a) parity, the kernel against its plain version on the same CUDA
        inputs at each cluster size the shape has (lindx_case): the slice's
        (3,2) at B=4096, lqr_iter 8, eps 1e-4, with f and the box +-0.5,
        unboxed, unboxed with the 30% u_zero_I mask, with delta_u 0.2,
        with per-time and per-example bounds in [0.2, 0.8], and with an
        example-invariant cost; the slew rate (penalty 1.0) at (5,2); n_ctrl
        4..8 at 4 states, B=1024, boxed (+-0.4) and unboxed; the gate's
        edges (15,2) and (11,8) at B=1024, boxed; one control at (6,1)
        (registers), boxed, and at (15,1) (shared memory), masked;
    (b) the entry points, every counter zeroed before each and read after:
        MPC(...)(x, cost, LinDx) at (3,2) B=4096, one whole-solve launch and
        no Riccati launch; the same with slew_rate_penalty=1.0; and the IFT
        gradient of the LinDx solve with respect to F and f (the
        whole-solve kernel forward, the KKT kernel at (3,2) backward) held
        against the plain backward;
    (c) times at (3,2), T=10, box +-0.5, 8 iterations (eps 0): the kernel
        alone (CUDA events) beside its bound at B=4096 and B=135168, and
        MPC end to end against backend="torch" in turns (a b b a x3, host
        clock); the device idle share of one profiled MPC call.
    Returns (the launches of (b), the largest |kernel - plain| of (a)'s x
    and u, the cases' figures, the paths' figures)."""
    import dataclasses

    from dilqr_tpu_torch.core.solver import augment_slew_rate, canonicalize_cost

    T = 10

    def problem(B, nx, nu):
        (C, c, F, f, x0), mask = lqr_problem(torch, gen, T, B, nx, nu, dev, torch.float32)
        return (C, c), P.LinDx(F, f), x0, mask

    def cfg_of(nx, nu, lqr_iter=8, eps=1e-4):
        return P.ILQRConfig(n_state=nx, n_ctrl=nu, T=T, lqr_iter=lqr_iter, eps=eps,
                            exit_unconverged=False, detach_unconverged=False, backprop=False)

    # ---- (a) parity ----
    cases, worst = [], 0.0

    def case(what, cfg, dyn, x0, cost, lo, hi, kw=None):
        nonlocal worst
        label = f"phase 8 (a) ({cfg.n_state},{cfg.n_ctrl}) B={x0.shape[0]} T={T} {what}"
        cases.append(lindx_case(torch, fused, card, label, cfg, dyn, x0, cost, lo, hi,
                                kw or {}))
        worst = max(worst, cases[-1]["max_abs_err"])

    main_cost, main_dyn, main_x0, mask = problem(4096, 3, 2)
    B = main_x0.shape[0]
    cfg = cfg_of(3, 2)
    hi_t = (0.2 + 0.6 * torch.rand(T, B, 2, generator=gen)).to(dev)
    case("box +-0.5, f", cfg, main_dyn, main_x0, main_cost, -0.5, 0.5)
    case("unboxed", cfg, main_dyn, main_x0, main_cost, None, None)
    case("unboxed, u_zero_I 30%", cfg, main_dyn, main_x0, main_cost, None, None,
         {"u_zero_I": mask})
    case("box +-0.5, delta_u 0.2", cfg, main_dyn, main_x0, main_cost, -0.5, 0.5,
         {"delta_u": 0.2})
    case("per-time and per-example bounds", cfg, main_dyn, main_x0, main_cost, -hi_t, hi_t)
    case("example-invariant cost, box +-0.5", cfg, main_dyn, main_x0,
         (main_cost[0][0, 0].contiguous(), main_cost[1][0, 0].contiguous()), -0.5, 0.5)
    tcost = P.QuadCost(*main_cost)  # time-major, as augment_slew_rate takes it
    a_cfg, a_cost, a_dyn, _, a_x0 = augment_slew_rate(
        dataclasses.replace(cfg, slew_rate_penalty=1.0), tcost, main_dyn, None, main_x0, None)
    case("slew rate 1.0, box +-0.5", a_cfg, a_dyn, a_x0, (a_cost.C, a_cost.c), -0.5, 0.5)
    for nu in (4, 5, 6, 7, 8):
        cost, dyn, x0, _ = problem(1024, 4, nu)
        case("box +-0.4", cfg_of(4, nu), dyn, x0, cost, -0.4, 0.4)
        case("unboxed", cfg_of(4, nu), dyn, x0, cost, None, None)
    for nx, nu in ((15, 2), (11, 8), (6, 1)):
        cost, dyn, x0, _ = problem(1024, nx, nu)
        case("box +-0.5", cfg_of(nx, nu), dyn, x0, cost, -0.5, 0.5)
    cost, dyn, x0, m1 = problem(1024, 15, 1)
    case("unboxed, u_zero_I 30%", cfg_of(15, 1), dyn, x0, cost, None, None, {"u_zero_I": m1})
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) the entry points ----
    total = {name: 0 for name in kernels}
    one = {"ilqr_fused": 1, "kkt_fused": 0, "riccati_fused": 0}

    def bm(a):  # time-major -> batch-major, as MPC takes them
        return a.transpose(0, 1)

    qc = P.QuadCost(bm(main_cost[0]), bm(main_cost[1]))
    lin = P.LinDx(bm(main_dyn.F), bm(main_dyn.f))
    mpc_kw = dict(u_lower=-0.5, u_upper=0.5, lqr_iter=8, eps=1e-4, backprop=False,
                  exit_unconverged=False)
    # what MPC must give: the kernel's bits on the same inputs, the plain
    # version's costs within parity's rule
    direct = fused.ilqr_fused(cfg, main_dyn, None, main_x0, main_cost, None, -0.5, 0.5)
    ref = fused.ilqr_fused_reference(cfg, main_dyn, None, main_x0, main_cost, None, -0.5, 0.5)
    for label, mkw, nx in (("MPC (3,2) B=4096 box +-0.5", {}, 3),
                           ("MPC (3,2) B=4096 slew rate 1.0", {"slew_rate_penalty": 1.0}, 3)):
        (x, u, costs), _ = drive(torch, kernels, total, f"phase 8 (b) {label}",
                                 lambda: P.MPC(3, 2, T, **mpc_kw, **mkw)(main_x0, qc, lin), one)
        if x.shape != (B, T, nx) or u.shape != (B, T, 2):
            fail(f"{label}: shapes {tuple(x.shape)}, {tuple(u.shape)}")
        if not (torch.isfinite(costs).all() and torch.isfinite(x).all()):
            fail(f"{label}: non-finite output")
        if u.abs().max().item() > 0.5 + 1e-6:
            fail(f"{label}: controls outside the box")
        msg = f"phase 8 (b) {label}: mean cost {costs.mean().item():.4f}"
        if not mkw:
            if not (torch.equal(costs, direct[2]) and torch.equal(u, direct[1].transpose(0, 1))):
                fail(f"{label}: MPC's result is not the kernel's on the same inputs")
            rel = (costs - ref[2]).abs() / ref[2].abs().clamp(min=1e-6)
            msg += (f", the kernel's bits; cost rel to the plain version max "
                    f"{rel.max().item():.2e}, past 1e-4: {int((rel > 1e-4).sum())}/{B}")
            if rel.max().item() > 1e-2 or int((rel > 1e-4).sum()) > 0.01 * B:
                fail(f"{label}: costs disagree with the plain version past parity's rule")
        print(msg, flush=True)

    c_ift = dataclasses.replace(cfg, backprop=True, backward_mode=P.BackwardMode.IFT)

    def lindx_grad(c):
        F = lin.F.clone().requires_grad_(True)
        f = lin.f.clone().requires_grad_(True)
        res = P.solve(c, main_x0, qc, P.LinDx(F, f), u_lower=-0.5, u_upper=0.5)
        return torch.autograd.grad((res.u ** 2).mean(), (F, f))

    label = "LinDx (3,2) IFT grad B=4096"
    g, _ = drive(torch, kernels, total, f"phase 8 (b) {label}", lambda: lindx_grad(c_ift),
                 {"ilqr_fused": 1, "kkt_fused": None, "riccati_fused": 0})
    g_ref = lindx_grad(dataclasses.replace(c_ift, backward_backend="torch"))
    for name, a, b in zip(("F", "f"), g, g_ref):
        err = (a - b).abs().max().item()
        print(f"phase 8 (b) {label}: d/d{name} max {b.abs().max().item():.3e}, abs. diff to the "
              f"plain backward {err:.2e}", flush=True)
        if not torch.isfinite(a).all() or a.abs().max().item() == 0.0:
            fail(f"{label}: a non-finite or zero gradient")
        if err > 1e-3 * b.abs().max().item() + 1e-8:
            fail(f"{label}: d/d{name} differs from the plain backward's by {err:.3e}")
    print(f"phase 8 (b) launches: {total}", flush=True)

    # ---- (c) times ----
    figures = []
    t_cfg = cfg_of(3, 2, eps=0.0)
    for first in (True, False):
        # the main problem, then one 1024-example tile per SM
        cost, dyn, x0 = (main_cost, main_dyn, main_x0) if first else problem(132 * 1024, 3,
                                                                              2)[:3]
        Bt = x0.shape[0]
        ms, runs = cuda_ms(lambda: fused.ilqr_fused(t_cfg, dyn, None, x0, cost, None, -0.5, 0.5),
                           1, 5)
        its = tile_iters_of(fused, t_cfg, dyn, x0, cost, -0.5, 0.5, {}) if first \
            else [int(fused.ilqr_fused(t_cfg, dyn, None, x0, cost, None, -0.5, 0.5)[4])] * (
                Bt // fused.TILE)
        bound, by_what, flops, by = lindx_bound(fused, t_cfg, Bt, cost, dyn, -0.5, 0.5, {}, its)
        print(f"time phase 8 ilqr_fused LinDx (3,2) B={Bt} T={T} box +-0.5, 8 iterations: "
              f"{ms:.3f} ms median of {len(runs)} ({', '.join(f'{r:.3f}' for r in runs)}), "
              f"{Bt / ms * 1e3:.0f} solves/s; {flops:.3e} FLOP, {by} bytes -> bound {bound:.4f} "
              f"ms ({by_what}) [{card}]", flush=True)
        mk = P.MPC(3, 2, T, u_lower=-0.5, u_upper=0.5, lqr_iter=8, eps=0.0, backprop=False,
                   exit_unconverged=False)
        mq = P.QuadCost(bm(cost[0]), bm(cost[1]))
        ml = P.LinDx(bm(dyn.F), bm(dyn.f))

        def call(be):
            mk.cfg = dataclasses.replace(mk.cfg, backend=be)
            return mk(x0, mq, ml)

        # a b b a x3, once at the full card: the plain loop takes seconds there
        got = host_ms_in_turns({"kernel": lambda: call("auto"),
                                "plain loop": lambda: call("torch")}, rounds=3 if first else 1,
                               warm_both=False)
        print(f"time phase 8 MPC LinDx (3,2) B={Bt} T={T}, 8 iterations, in turns (host clock, "
              f"synchronized, medians): kernel {got['kernel'][0]:.3f} ms "
              f"({', '.join(f'{t:.3f}' for t in got['kernel'][1])}); plain loop "
              f"{got['plain loop'][0]:.1f} ms "
              f"({', '.join(f'{t:.1f}' for t in got['plain loop'][1])}) [{card}]", flush=True)
        figures.append({"name": f"MPC LinDx (3,2) B={Bt}", "kernel_ms": ms, "bound_ms": bound,
                        "bound_by": by_what, "mpc_ms": got["kernel"][0],
                        "torch_ms": got["plain loop"][0]})
        if first:
            profile_step(torch, "phase 8 MPC LinDx (3,2) B=4096", lambda: call("auto"),
                         counted=(fused, "ilqr_fused_kernel"))
    return total, worst, cases, figures


# phase 9: the device envs by id (csrc/ilqr_fused.cuh EnvId)
JVP_ENV_NAMES = {0: "cartpole", 1: "pendulum", 2: "rocket", 3: "cartpole slew",
                 4: "pendulum slew", 5: "rocket slew", 6: "complex pendulum",
                 7: "rocket normalize_quat", 8: "complex pendulum slew",
                 9: "rocket normalize_quat slew"}
JVP_SLEW_BASE = {3: 0, 4: 1, 5: 2, 8: 6, 9: 7, 11: 10}
# the whole-solve kernel in a jvp library, as <NU, block threads, per-example cost>
JVP_ENTRY = (r"_ZN5dilqr(?:17ilqr_fused_kernel|20ilqr_fused_kernel_mb)I\w+?ELi(\d+)ELi(\d+)"
             r"ELb(\d)E\w*?EEv")


def jvp_label(spec):
    d = dict(spec[1])
    env, clamped = d["DILQR_JVP_ENV"], d["DILQR_JVP_CLAMPED"]
    return env, clamped, f"{JVP_ENV_NAMES[env]} {'AUTO_DIFF' if clamped else 'ANALYTIC'}"


def jvp_ptxas(fused, reports):
    """Phase 2 for the jvp libraries (csrc/ilqr_jvp.cu, one per env and
    method): each instantiation's registers, stack and spills; a missing
    instantiation (one per cluster size and cost form the env has) fails,
    and so does a stack or a spill at one control -- cartpole and the
    pendulum under AUTO_DIFF, the complex pendulum under both methods and
    the slew-rate wrappers of these (at most 6 states). The rocket's forms
    are reported, not gated."""
    for spec in fused.jvp_specs():
        env, _, label = jvp_label(spec)
        seen = 0
        for name, regs, stack, st, ld in ptxas_entries(reports[spec], JVP_ENTRY, "jvp"):
            nu = int(name.strip("<>").split(",")[0])
            print(f"ptxas ilqr_jvp {label} <NU, threads, lanes> {name}: {regs} registers, "
                  f"{stack} bytes stack, {st}/{ld} bytes spill stores/loads", flush=True)
            seen += 1
            if nu == 1 and (stack or st or ld):
                fail(f"ilqr_jvp {label} {name} (n_ctrl 1) has a stack frame or spills")
        want = len(fused.clusters(env)) * (1 if env in fused.LANES_ONLY else 2)
        if seen != want:
            fail(f"ilqr_jvp {label}: {seen} instantiations, want {want}")


def jvp_bound(fused, cfg, B, env, cost, lo, hi, tile_iters, ops=None):
    """The least time of one solve with the jvp sweep: (ms, "bytes" or
    "operations", FP32 and FP64 operations, bytes). Operations, per example,
    step and iteration its tile ran: the Jacobian as JvpJac forms it, the
    base env's step on Duals with its values computed once and the tangent
    operations once for each of its n = nx + nu columns (fused.STEP_OPS),
    the Riccati step's products and one line-search trial (K dx, a float
    step, the objective) as lindx_bound counts them; the box-QP's Newton
    steps and further trials depend on the data and are not counted. The
    FP32 and FP64 times add up: both take the schedulers' dispatch slots, which
    FP32 at its peak fills. Bytes: variant_work's. ops: the step's
    StepOps, by default the base env's STEP_OPS (an MLP passes
    fused.mlp_step_ops of its widths)."""
    T, nx, nu = cfg.T, cfg.n_state, cfg.n_ctrl
    base = JVP_SLEW_BASE.get(env, env)
    ops = ops or fused.STEP_OPS[base]
    n_base = nx if base != env else nx + nu  # a slew-rate state holds the u columns
    per_t = (ops.jvp_f32 + n_base * ops.tangent + riccati_trial_flops(nx, nu) + ops.f32)
    per_t64 = ops.jvp_f64 + ops.f64
    count = T * sum(it * min(fused.TILE, B - g * fused.TILE) for g, it in enumerate(tile_iters))
    flops, flops64 = per_t * count, per_t64 * count
    by = variant_work(cfg, B, cost, lo, hi, None, {})
    t_ops = (flops / FP32_PEAK + flops64 / FP64_PEAK) * 1e3
    t_by = by / HBM_RATE * 1e3
    return max(t_ops, t_by), ("operations" if t_ops >= t_by else "bytes"), flops, flops64, by


def jvp_case(torch, fused, card, label, cfg, dyn, params, x0, cost, lo, hi):
    """One (a) case of phase 9: variant_case's parity (x and u held on the
    examples converged in both, with its witness), the same bits at every
    cluster size, rocket_checks for three controls and the kernel's time
    beside the plain version's, then the bound by jvp_bound from the
    iterations each tile ran. Returns the JSON figures."""
    fig = variant_case(torch, fused, card, label, cfg, dyn, params, x0, cost, None, lo, hi, {})
    its = [int(fused.ilqr_fused(cfg, dyn, params, x0[g:g + fused.TILE],
                                tuple(a[:, g:g + fused.TILE] if a.dim() >= 3 else a
                                      for a in cost), None, lo, hi)[4])
           for g in range(0, x0.shape[0], fused.TILE)]
    bound, by_what, flops, flops64, by = jvp_bound(fused, cfg, x0.shape[0], dyn.device_env, cost,
                                                   lo, hi, its)
    info = fused.kernel_info(dyn.device_env, 0, cost[0].dim() == 4, cfg.grad_method)
    print(f"bound {label}: {flops:.3e} FP32 and {flops64:.3e} FP64 operations, {by} bytes -> "
          f"{bound:.4f} ms ({by_what}); tile "
          f"iterations {its}; G={info['cluster']}, {info['registers']} registers, "
          f"{info['local_bytes']} local bytes, cudaOccupancyMaxActiveClusters "
          f"{info['max_active_clusters']} [{card}]", flush=True)
    return {"name": label.replace("phase 9 (a) ", ""), "ms": fig["ms"],
            "plain_ms": fig["plain_ms"], "bound_ms": bound, "bound_by": by_what,
            "max_abs_err": fig["max_abs_err"], "n_iter": fig["n_iter"]}


def jvp_paths(torch, P, dev, kernels, card, fused, gen):
    """Phase 9: the whole-solve kernel's jvp sweep (JvpJac in
    csrc/ilqr_fused.cuh, one library per env and method from
    csrc/ilqr_jvp.cu): GradMethod.AUTO_DIFF on every device env, the complex
    pendulum (the IL env "pendulum-complex"'s params 10, 1, 1, 1, 0.1) and
    the rocket with normalize_quat=True under both methods, and the
    slew-rate wrapper of each, at full width, T=20.
    (a) parity, the kernel against its plain version (whose Jacobian is a
        batched torch.func.jvp a column of the kernel-form step) on the same
        CUDA inputs at each cluster size the library has (jvp_case): cartpole
        B=4096 AUTO_DIFF (bench.py's problem), the pendulum B=1030 AUTO_DIFF
        (its box is its torque clamp), the rocket B=1024 AUTO_DIFF (bench.py's
        start, +-20), the complex pendulum B=4096 (the IL env's starts, +-2)
        and the renormalizing rocket B=1024 under both methods; then the
        slew rate (penalty 1.0) of each of these seven;
    (b) the entry points, every counter zeroed before each and read after:
        MPC(3, 1, 20)(x, QuadCost, pendulum.make(simple=False), params) at
        B=4096 and receding_horizon on it at B=1024 (5 steps), one
        whole-solve launch a solve; bench.py's cartpole configuration under
        AUTO_DIFF with the box +-1 that saturates (its solution's |u| reaches
        1.4), MPC.solve at B=4096 and
        its IFT gradient (the KKT kernel backward) against the plain
        backward; the complex pendulum's AUTO_DIFF IFT gradient at B=1024
        against the plain backward; the renormalizing rocket under AUTO_DIFF
        (the reference golden's configuration, f32) MPC.solve at B=1024;
        ILExp on "pendulum-complex" in modes imempc and empc (learn_cost; its
        mode sysid and learn_dx raise in the JAX package and the port alike:
        the mis-specified init has 3 values for the 5-param model) for 2
        steps each;
    (c) each (b) serving path's host time against the same call with
        backend="torch", in turns (a b b a, once), and the device idle share
        of one profiled complex-pendulum MPC call.
    Returns (the launches of (b), the largest |kernel - plain| of (a)'s x
    and u, the cases' figures, the paths' figures)."""
    import dataclasses
    import tempfile

    from dilqr_tpu_torch.control import receding_horizon
    from dilqr_tpu_torch.core.solver import augment_slew_rate, canonicalize_cost
    from dilqr_tpu_torch.il.env import sample_xinit
    from dilqr_tpu_torch.il.exp import ILExp
    from dilqr_tpu_torch.models import cartpole, pendulum, rocket

    T = 20
    AD, AN = P.GradMethod.AUTO_DIFF, P.GradMethod.ANALYTIC
    il_params = torch.tensor([10.0, 1.0, 1.0, 1.0, 0.1], device=dev)
    cp, cp_params = cartpole.make(), cartpole.default_params(device=dev)
    pd, pd_params = pendulum.make(), pendulum.default_params(device=dev)
    pc = pendulum.make(simple=False)
    rk, rk_params = rocket.make(), rocket.default_params(device=dev)
    rn = rocket.make(normalize_quat=True)
    cp_q, cp_p = cartpole.get_true_obj(device=dev)
    pd_q, pd_p = pendulum.get_true_obj(device=dev)
    r_q, r_p = rocket.get_true_obj(device=dev)
    r_lo, r_hi = rk.lower.to(dev), rk.upper.to(dev)

    def cfg_of(dyn, nx, nu, lqr_iter, eps, method):
        return P.ILQRConfig(n_state=nx, n_ctrl=nu, T=T, lqr_iter=lqr_iter, eps=eps,
                            linesearch_decay=dyn.linesearch_decay,
                            max_linesearch_iter=dyn.max_linesearch_iter, grad_method=method,
                            exit_unconverged=False, detach_unconverged=False, backprop=False)

    def pend_x0(B):
        th = -1.5 + 3.0 * torch.rand(B, generator=gen)
        return torch.stack([th.cos(), th.sin(), 0.5 * torch.randn(B, generator=gen)], 1).to(dev)

    bench_ad = P.ILQRConfig(n_state=5, n_ctrl=1, T=T, lqr_iter=20, eps=1e-4,
                            linesearch_decay=0.5, max_linesearch_iter=2, grad_method=AD,
                            exit_unconverged=False, detach_unconverged=False, backprop=False)
    # (label, dyn, params, cfg, x0, (q, p), lo, hi)
    problems = [
        ("cartpole B=4096 AUTO_DIFF (bench)", cp, cp_params, bench_ad,
         cartpole_start(torch, gen, 4096, dev), (cp_q, cp_p), -100.0, 100.0),
        ("pendulum B=1030 AUTO_DIFF, box +-2 (the clamp)", pd, pd_params,
         cfg_of(pd, 3, 1, 10, 1e-3, AD), pend_x0(1030), (pd_q, pd_p), -2.0, 2.0),
        ("rocket B=1024 AUTO_DIFF (bench)", rk, rk_params, cfg_of(rk, 13, 3, 15, 1e-3, AD),
         rocket.bench_start(1024, gen, device=dev), (r_q, r_p), r_lo, r_hi),
    ]
    for method in (AN, AD):
        problems.append((f"complex pendulum B=4096 {method.name}, box +-2", pc, il_params,
                         cfg_of(pc, 3, 1, 10, 1e-3, method),
                         sample_xinit(gen, "pendulum-complex", 4096, device=dev), (pd_q, pd_p),
                         -2.0, 2.0))
        problems.append((f"rocket normalize_quat B=1024 {method.name}", rn, rk_params,
                         cfg_of(rn, 13, 3, 15, 1e-3, method),
                         rocket.bench_start(1024, gen, device=dev), (r_q, r_p), r_lo, r_hi))

    # ---- (a) parity ----
    cases, worst = [], 0.0
    for label, dyn, params, cfg, x0, (q, p), lo, hi in problems:
        for slew in (False, True):
            if slew:
                B, n = x0.shape[0], cfg.n_state + cfg.n_ctrl
                cost = canonicalize_cost(P.QuadCost(torch.diag(q), p), T, B, n)
                c_cfg, a_cost, c_dyn, c_params, c_x0 = augment_slew_rate(
                    dataclasses.replace(cfg, slew_rate_penalty=1.0), cost, dyn, params, x0,
                    None)
                c_cost = (a_cost.C, a_cost.c)
                what = f"slew rate 1.0 {label} (n_state {c_cfg.n_state})"
            else:
                c_cfg, c_dyn, c_params, c_x0, c_cost = cfg, dyn, params, x0, (torch.diag(q), p)
                what = label
            if not fused.covered(c_cfg, c_dyn, c_params, torch.float32,
                                 None if slew else c_cost, None, None, lo, hi):
                fail(f"phase 9 {what}: not covered")
            if not fused.uses_jvp(c_cfg.grad_method, c_dyn.device_env):
                fail(f"phase 9 {what}: does not take the jvp sweep")
            cases.append(jvp_case(torch, fused, card, f"phase 9 (a) {what} T={T}", c_cfg, c_dyn,
                                  c_params, c_x0, c_cost, lo, hi))
            worst = max(worst, cases[-1]["max_abs_err"])
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) the entry points ----
    total = {name: 0 for name in kernels}
    one = {"ilqr_fused": 1, "kkt_fused": 0, "riccati_fused": 0}

    def run(label, fn, want):
        return drive(torch, kernels, total, f"phase 9 (b) {label}", fn, want)

    pc_cost = P.QuadCost(torch.diag(pd_q), pd_p)
    pc_kw = dict(u_lower=-2.0, u_upper=2.0, lqr_iter=10, eps=pc.mpc_eps,
                 linesearch_decay=pc.linesearch_decay, max_linesearch_iter=pc.max_linesearch_iter,
                 backprop=False, exit_unconverged=False)
    x_pc = sample_xinit(gen, "pendulum-complex", 4096, device=dev)
    x_pc1 = sample_xinit(gen, "pendulum-complex", 1024, device=dev)
    x_cp = cartpole_start(torch, gen, 4096, dev)
    x_rn = rocket.bench_start(1024, gen, device=dev)
    cp_cost = P.QuadCost(torch.diag(cp_q), cp_p)
    r_cost = P.QuadCost(torch.diag(r_q), r_p)
    cp_kw = dict(lqr_iter=20, eps=1e-4, linesearch_decay=0.5, max_linesearch_iter=2,
                 grad_method=AD, backprop=False, exit_unconverged=False)
    rn_kw = dict(lqr_iter=15, eps=1e-3, linesearch_decay=rn.linesearch_decay,
                 max_linesearch_iter=rn.max_linesearch_iter, grad_method=AD, backprop=False,
                 exit_unconverged=False)
    pc_cfg = cfg_of(pc, 3, 1, 10, pc.mpc_eps, AN)

    # name -> (call(backend), B, nx, nu, box, launches a call)
    paths = {
        "MPC complex pendulum B=4096": (
            lambda be: P.MPC(3, 1, T, backend=be, **pc_kw).solve(x_pc, pc_cost, pc,
                                                                 params=il_params),
            4096, 3, 1, 2.0, 1),
        "receding_horizon complex pendulum B=1024 x5 steps": (
            lambda be: receding_horizon(dataclasses.replace(pc_cfg, backend=be), pc, il_params,
                                        pc_cost, x_pc1, 5, u_lower=-2.0, u_upper=2.0),
            1024, 3, 1, 2.0, 5),
        "MPC.solve cartpole AUTO_DIFF B=4096 box +-1": (
            lambda be: P.MPC(5, 1, T, u_lower=-1.0, u_upper=1.0, backend=be,
                             **cp_kw).solve(x_cp, cp_cost, cp, params=cp_params),
            4096, 5, 1, 1.0, 1),
        "MPC.solve rocket normalize_quat AUTO_DIFF B=1024": (
            lambda be: P.MPC(13, 3, T, u_lower=r_lo, u_upper=r_hi, backend=be,
                             **rn_kw).solve(x_rn, r_cost, rn, params=rk_params),
            1024, 13, 3, 20.0, 1),
    }
    for label, (call, B, nx, nu, box, n) in paths.items():
        out, _ = run(label, lambda: call("auto"), {**one, "ilqr_fused": n})
        if label.startswith("receding_horizon"):
            if out.xs.shape != (B, n + 1, nx) or not torch.isfinite(out.xs).all():
                fail(f"{label}: bad closed-loop states")
            if out.us.abs().max().item() > box + 1e-5:
                fail(f"{label}: actions outside the box")
            print(f"phase 9 (b) {label}: mean |u| {out.us.abs().mean().item():.4f}, final mean "
                  f"cos th {out.xs[:, -1, 0].mean().item():.4f}", flush=True)
            continue
        if out.x.shape != (B, T, nx) or out.u.shape != (B, T, nu):
            fail(f"{label}: shapes {tuple(out.x.shape)}, {tuple(out.u.shape)}")
        if not (torch.isfinite(out.costs).all() and torch.isfinite(out.x).all()):
            fail(f"{label}: non-finite output")
        if (out.u.abs() - box).max().item() > 1e-5:
            fail(f"{label}: controls outside the box")
        at = ((out.u.abs() - box).abs() < 1e-6).float().mean().item()
        print(f"phase 9 (b) {label}: n_iter {int(out.n_iter)}, mean cost "
              f"{out.costs.mean().item():.4f}, converged share "
              f"{out.converged.float().mean().item():.4f}, share of controls at the box "
              f"{at:.4f}", flush=True)
        if "cartpole" in label and at < 0.01:
            fail(f"{label}: the box does not saturate ({at:.4f} of the controls at it)")

    # IFT gradients: the whole-solve kernel forward (jvp sweep), the KKT
    # kernel backward, within 1e-3 of the largest entry of the plain backward's
    def grad(c, x0, cost, dyn, params, lo, hi):
        pr = params.clone().requires_grad_(True)
        res = P.solve(c, x0, cost, dyn, params=pr, u_lower=lo, u_upper=hi)
        (g,) = torch.autograd.grad((res.u ** 2).mean(), pr)
        return g

    for label, c, args in (
            ("cartpole AUTO_DIFF IFT grad B=4096 box +-1",
             dataclasses.replace(bench_ad, backprop=True, backward_mode=P.BackwardMode.IFT),
             (x_cp, cp_cost, cp, cp_params, -1.0, 1.0)),
            ("complex pendulum AUTO_DIFF IFT grad B=1024",
             dataclasses.replace(cfg_of(pc, 3, 1, 10, pc.mpc_eps, AD), backprop=True,
                                 backward_mode=P.BackwardMode.IFT),
             (x_pc1, pc_cost, pc, il_params, -2.0, 2.0))):
        g, _ = run(label, lambda: grad(c, *args),
                   {"ilqr_fused": 1, "kkt_fused": None, "riccati_fused": 0})
        g_ref = grad(dataclasses.replace(c, backward_backend="torch"), *args)
        err = (g - g_ref).abs().max().item()
        print(f"phase 9 (b) {label}: grad params {g.tolist()}, abs. diff to the plain backward "
              f"{err:.2e}", flush=True)
        if not torch.isfinite(g).all() or g.abs().max().item() == 0.0:
            fail(f"{label}: a non-finite or zero gradient")
        if err > 1e-3 * g_ref.abs().max().item() + 1e-8:
            fail(f"{label}: the gradient differs from the plain backward's by {err:.3e}")

    # the IL trainer on the complex pendulum: 2 steps a mode (64 examples,
    # batches of 32), the expert data made by the kernel
    for mode in ("imempc", "empc"):
        label = f"ILExp pendulum-complex {mode} learn_cost, 2 steps"

        def train(work):
            exp = ILExp.from_cli(["--env", "pendulum-complex", "--mode", mode, "--learn_cost",
                                  "--n_epoch", "1", "--n_train", "64", "--n_batch", "32",
                                  "--work", work], device="cuda")
            return exp.run(verbose=False)

        with tempfile.TemporaryDirectory() as work:
            best, _ = run(label, lambda: train(work), {"ilqr_fused": None, "kkt_fused": None,
                                                       "riccati_fused": 0})
        if not math.isfinite(best):
            fail(f"{label}: a non-finite validation loss")
        print(f"phase 9 (b) {label}: best validation loss {best:.6f}", flush=True)
    print(f"phase 9 (b) launches: {total}", flush=True)

    # ---- (c) times: the kernel path against the plain loop, in turns ----
    figures = []
    for label, (call, B, nx, nu, box, n) in paths.items():
        got = host_ms_in_turns({"kernel": lambda: call("auto"),
                                "plain loop": lambda: call("torch")}, rounds=1,
                               warm_both=False, b_once=True)
        (k_ms, k_runs), (t_ms, t_runs) = got["kernel"], got["plain loop"]
        per = f" ({k_ms / n:.3f} ms a step)" if n > 1 else ""
        print(f"time phase 9 {label}: {k_ms:.3f} ms{per} with the whole-solve kernel, "
              f"{t_ms:.3f} ms with backend='torch' (host clock, synchronized, median of "
              f"{len(k_runs)} in turns: {', '.join(f'{r:.3f}' for r in k_runs)} / "
              f"{', '.join(f'{r:.3f}' for r in t_runs)}) [{card}]", flush=True)
        figures.append({"name": label, "launches": n, "ms": k_ms, "torch_ms": t_ms})
    profile_step(torch, "phase 9 MPC complex pendulum B=4096",
                 lambda: paths["MPC complex pendulum B=4096"][0]("auto"),
                 counted=(fused, "ilqr_fused_kernel"))
    return total, worst, cases, figures


# phase 10: the small MLP's cases, one library each (csrc/ilqr_mlp.cu),
# built in phase 2: (label, n_state, n_ctrl, hidden, activation, per-example
# cost, slew rate, batch). The golden's shape (3, 2, (16,)) takes the
# reference golden's weights in every activation, both cost forms and the
# slew rate; the other shapes JAX's gate admits (67-253
# weights) take weights from a seed.
SMALL_MLP_CASES = (
    ("golden (3,2,(16,)) sigmoid", 3, 2, (16,), "sigmoid", False, False, 4096),
    ("golden (3,2,(16,)) sigmoid per-example cost", 3, 2, (16,), "sigmoid", True, False, 4096),
    ("golden (3,2,(16,)) sigmoid slew rate", 3, 2, (16,), "sigmoid", True, True, 4096),
    ("golden (3,2,(16,)) relu", 3, 2, (16,), "relu", False, False, 1030),
    ("golden (3,2,(16,)) elu", 3, 2, (16,), "elu", False, False, 1030),
    ("(3,1,(8,)) sigmoid", 3, 1, (8,), "sigmoid", False, False, 1030),
    ("(3,1,(6,6)) relu", 3, 1, (6, 6), "relu", False, False, 1030),
    ("(3,1,(8,)) elu", 3, 1, (8,), "elu", False, False, 1030),
    ("(5,1,(16,)) sigmoid", 5, 1, (16,), "sigmoid", False, False, 1030),
    ("(6,2,(12,)) sigmoid", 6, 2, (12,), "sigmoid", False, False, 1030),
    ("(13,3,(8,)) sigmoid", 13, 3, (8,), "sigmoid", False, False, 1030),
)
GOLDEN_MLP = "tests/goldens/nn_dynamics.npz"  # NNDynamics(3, 2, [16], sigmoid, passthrough)


def small_mlp_spec(case):
    from dilqr_tpu_torch.models.base import MlpSpec

    _, nx, nu, hidden, act, _, slew, _ = case
    return MlpSpec(nx, nu, hidden, act, True, slew)


def learned_mlp_cases():
    """The learned cartpole model (5, 1, (100,)) sigmoid with the residual:
    its one library (the hand Jacobian, under either method), as (label,
    MlpSpec, lanes)."""
    from dilqr_tpu_torch.models import cartpole_mlp

    return [("learned cartpole (5,1,(100,))", cartpole_mlp.make().device_mlp, False)]


def small_mlp_specs(fused):
    """The build specs of phase 10's MLP libraries and of the learned
    cartpole model's."""
    return [fused.mlp_spec(small_mlp_spec(c), c[5]) for c in SMALL_MLP_CASES] + [
        fused.mlp_spec(m, lanes) for _, m, lanes in learned_mlp_cases()]


def small_mlp_ptxas(fused, reports):
    """Phase 2 for the MLP libraries: each instantiation's registers, stack
    and spills (one per cluster size whose shared memory fits, one cost
    form a library); a missing instantiation fails, and so does a stack or
    a spill at one control."""
    labelled = [(c[0], small_mlp_spec(c)) for c in SMALL_MLP_CASES] + [
        (label, m) for label, m, _ in learned_mlp_cases()]
    for (label, m), spec in zip(labelled, small_mlp_specs(fused)):
        nx = m.n_state + (m.n_ctrl if m.slew else 0)
        seen = 0
        for name, regs, stack, st, ld in ptxas_entries(reports[spec], JVP_ENTRY, "MLP"):
            print(f"ptxas ilqr_mlp {label} <NU, threads, lanes> {name}: {regs} registers, "
                  f"{stack} bytes stack, {st}/{ld} bytes spill stores/loads", flush=True)
            seen += 1
            if m.n_ctrl == 1 and (stack or st or ld):
                fail(f"ilqr_mlp {label} {name} (n_ctrl 1) has a stack frame or spills")
        want = len(fused.mlp_clusters(nx, m.n_ctrl))
        if seen != want:
            fail(f"ilqr_mlp {label}: {seen} instantiations, want {want}")


def golden_mlp(torch, dev):
    """The reference golden's MLP weights [(W0, b0), (W1, b1)], f32 on the
    card, from the checkout."""
    import os

    import numpy as np

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), GOLDEN_MLP)
    if not os.path.exists(path):
        fail(f"{GOLDEN_MLP} is missing: run this script from a checkout of the repository")
    g = np.load(path)
    return [tuple(torch.tensor(g[k], dtype=torch.float32, device=dev) for k in (w, b))
            for w, b in (("W0", "b0"), ("W1", "b1"))]


def small_mlp_case(torch, fused, card, label, cfg, dyn, flat, x0, cost, lo, hi):
    """One (a) case of phase 10: variant_case's parity (x and u held on the
    examples converged in both, with its witness; costs and n_iter on all),
    the same bits at every cluster size and the kernel's time beside the
    plain version's, then the bound by jvp_bound with the MLP's step
    operations (fused.mlp_step_ops) from the iterations each tile ran.
    Returns the JSON figures."""
    before = fused.LAUNCHES
    fused.ilqr_fused(cfg, dyn, flat, x0, cost, None, lo, hi)
    torch.cuda.synchronize()
    if fused.LAUNCHES != before + 1:
        fail(f"{label}: {fused.LAUNCHES - before} launches for one solve")
    fig = variant_case(torch, fused, card, label, cfg, dyn, flat, x0, cost, None, lo, hi, {},
                       rocket=False)
    its = [int(fused.ilqr_fused(cfg, dyn, flat, x0[g:g + fused.TILE],
                                tuple(a[:, g:g + fused.TILE] if a.dim() >= 3 else a
                                      for a in cost), None, lo, hi)[4])
           for g in range(0, x0.shape[0], fused.TILE)]
    spec = dyn.device_mlp
    bound, by_what, flops, flops64, by = jvp_bound(fused, cfg, x0.shape[0], dyn.device_env, cost,
                                                   lo, hi, its, ops=fused.mlp_step_ops(spec))
    info = fused.mlp_info(spec, 0, cost[0].dim() == 4)
    print(f"bound {label}: {spec.n_weights} weights, {flops:.3e} FP32 operations, {by} bytes -> "
          f"{bound:.4f} ms ({by_what}); tile iterations {its}; G={info['cluster']}, "
          f"{info['registers']} registers, {info['local_bytes']} local bytes, V/Q/F in "
          f"{info['store']}, cudaOccupancyMaxActiveClusters {info['max_active_clusters']} "
          f"[{card}]", flush=True)
    return {"name": label.replace("phase 10 (a) ", ""), "ms": fig["ms"],
            "plain_ms": fig["plain_ms"], "bound_ms": bound, "bound_by": by_what,
            "max_abs_err": fig["max_abs_err"], "n_iter": fig["n_iter"]}


LEARNED_MLP_B = 16384  # the learned model's cell, cartpole_mlp.mpc_loop.b16384


def learned_mlp_case(torch, P, fused, card, dev, gen):
    """Phase 10 (a) for the learned cartpole model (models/cartpole_mlp: 5
    states, 1 control, hidden 100 sigmoid with the residual, 1,205 weights
    from a seed, flat) at its cell's batch, B=16,384, on the cartpole's
    cost, box +-100, T=20 and line search. Under ANALYTIC and AUTO_DIFF,
    which one library serves (the hand Jacobian, Mlp::jac): one launch a
    solve, held against its plain version (ilqr_fused_reference, jac_lanes)
    on the same CUDA inputs after 2 iterations, as the card test holds
    MPC.solve against backend="torch", since the random-weight model forks
    in f32 past a few: n_iter 2 in both, every cost within rtol 1e-4, u
    within 2e-2 on every example; the two methods' kernel outputs the same
    bits; the same bits at every cluster size; then the kernel's time at
    the cell's 20 iterations (CUDA events, median of 5). Returns the JSON
    figures."""
    import dataclasses

    from dilqr_tpu_torch.models import cartpole, cartpole_mlp

    B, T, box = LEARNED_MLP_B, 20, 100.0
    dyn = cartpole_mlp.make()
    flat = cartpole_mlp.flat_init_params(21, device=dev)
    q, p = cartpole.get_true_obj(device=dev)
    cost = (torch.diag(q), p)
    x0 = cartpole_start(torch, gen, B, dev)
    label = f"phase 10 (a) learned cartpole (5,1,(100,)) sigmoid B={B} T={T}"
    outs, err = {}, 0.0
    for method in (P.GradMethod.ANALYTIC, P.GradMethod.AUTO_DIFF):
        name = f"{label} {method.name} 2 iterations"
        cfg = P.ILQRConfig(n_state=5, n_ctrl=1, T=T, lqr_iter=2, eps=1e-4, grad_method=method,
                           linesearch_decay=0.5, max_linesearch_iter=2, exit_unconverged=False,
                           detach_unconverged=False, backprop=False)
        if not fused.covered(cfg, dyn, flat, torch.float32, cost, None, None, -box, box):
            fail(f"{name}: not covered")
        before = fused.LAUNCHES
        k_out = fused.ilqr_fused(cfg, dyn, flat, x0, cost, None, -box, box)
        torch.cuda.synchronize()
        if fused.LAUNCHES != before + 1:
            fail(f"{name}: {fused.LAUNCHES - before} launches for one solve")
        r_out = fused.ilqr_fused_reference(cfg, dyn, flat, x0, cost, None, -box, box)
        kc, rc = k_out[2], r_out[2]
        cost_rel = ((kc - rc).abs() / rc.abs().clamp(min=1e-6)).max().item()
        u_err = (k_out[1] - r_out[1]).abs().max().item()
        x_err = (k_out[0] - r_out[0]).abs().max().item()
        print(f"parity {name}: cost rel max {cost_rel:.2e} (bar 1e-4), u max {u_err:.2e} (bar "
              f"2e-2), x max {x_err:.2e}, n_iter {int(k_out[4])} vs {int(r_out[4])} [{card}]",
              flush=True)
        if not (torch.isfinite(kc).all() and torch.isfinite(k_out[1]).all()):
            fail(f"{name}: non-finite kernel output")
        if int(k_out[4]) != 2 or int(r_out[4]) != 2:
            fail(f"{name}: n_iter {int(k_out[4])} (kernel), {int(r_out[4])} (plain), want 2")
        if cost_rel > 1e-4 or u_err > 2e-2:
            fail(f"{name}: the kernel differs from its plain version past (1e-4, 2e-2)")
        err = max(err, u_err)
        outs[method] = k_out
        if method is P.GradMethod.ANALYTIC:
            same_bits(torch, fused, name, k_out, (cfg, dyn, flat, x0, cost, None, -box, box))
    if not all(torch.equal(a, b) for a, b in zip(*outs.values())):
        fail(f"{label}: ANALYTIC and AUTO_DIFF give different bits from one library")
    print(f"parity {label}: ANALYTIC and AUTO_DIFF give the same bits", flush=True)
    cfg = dataclasses.replace(cfg, lqr_iter=20)
    ms, runs = cuda_ms(lambda: fused.ilqr_fused(cfg, dyn, flat, x0, cost, None, -box, box), 1, 5)
    info = fused.mlp_info(dyn.device_mlp)
    print(f"time {label} 20 iterations: {ms:.3f} ms median of {len(runs)} "
          f"({', '.join(f'{r:.3f}' for r in runs)}); G={info['cluster']}, {info['registers']} "
          f"registers, {info['local_bytes']} local bytes, {fused.WAVES} waves [{card}]",
          flush=True)
    return {"name": label.replace("phase 10 (a) ", ""), "ms": ms, "plain_ms": None,
            "bound_ms": None, "bound_by": None, "max_abs_err": err, "n_iter": 20}


def small_mlp_paths(torch, P, dev, kernels, card, fused, gen):
    """Phase 10: the small MLP on the whole-solve kernel (Mlp with its hand
    Jacobian Mlp::jac for one hidden layer, else JvpJac<Mlp>, in
    csrc/ilqr_fused.cuh, one library per case from csrc/ilqr_mlp.cu), T=20,
    box +-0.5, the identity cost (x and u to 0).
    (a) parity, the kernel against its plain version on the same CUDA
        inputs, the weights flat (nn_dynamics.flat_params), at each cluster
        size the library has (small_mlp_case): every case of
        SMALL_MLP_CASES, lqr_iter 10, eps 1e-4, starts randn; the random-weight models fork in f32
        under a 1-ulp nudge by up to about 2e-2 in u while their costs agree
        to 1e-6, so x and u are held on the examples converged in both;
        then the learned cartpole model at its cell's batch of 16,384 under
        both methods, held after 2 iterations (learned_mlp_case);
    (b) serving on the golden's MLP (3 states, 2 controls, hidden 16,
        sigmoid, the residual; its weights as the pytree) through the entry
        points, every counter zeroed before each and read after, one
        whole-solve launch a solve and no other: MPC.solve at B=4096
        (lqr_iter 20, eps 1e-4) and one receding_horizon step at B=4096;
        MPC.solve against backend="torch" in turns (a b b a, once), and the
        device idle share of one profiled MPC call;
    (c) the IFT gradient of mean(u^2) with respect to the golden's weights
        at B=1024: the whole-solve kernel forward, the KKT kernel at (3,2)
        backward, within 1e-3 of the largest entry of the plain
        backward's;
    (d) the learned model at hidden 100 (5 states, 1 control, 1,205
        weights from a seed, past the 256 JAX flattens, which the port's
        kernel_params flattens for one hidden layer) in MPC.solve at
        B=1024: one whole-solve launch (the hand Jacobian's library) and no
        Riccati launch.
    Returns the JSON row, with the KKT launches of (c) under
    "kkt_launches"."""
    import dataclasses

    from dilqr_tpu_torch.control import receding_horizon
    from dilqr_tpu_torch.core.ilqr import kernel_params
    from dilqr_tpu_torch.core.solver import augment_slew_rate, canonicalize_cost
    from dilqr_tpu_torch.models import cartpole, nn_dynamics

    T, box = 20, 0.5
    golden = golden_mlp(torch, dev)

    # ---- (a) parity ----
    cases, worst = [], 0.0
    for case in SMALL_MLP_CASES:
        label, nx, nu, hidden, act, lanes, slew, B = case
        dyn = nn_dynamics.make(nx, nu, activation=act, hidden_sizes=hidden)
        ws = (golden if label.startswith("golden") else nn_dynamics.init_params(
            nx, nu, hidden, generator=gen, device=dev))
        x0 = torch.randn(B, nx, generator=gen).to(dev)
        n = nx + nu
        cfg = P.ILQRConfig(n_state=nx, n_ctrl=nu, T=T, lqr_iter=10, eps=1e-4,
                           exit_unconverged=False, detach_unconverged=False, backprop=False)
        eye, zero = torch.eye(n, device=dev), torch.zeros(n, device=dev)
        cost = (eye, zero)
        if slew:
            c_cost = canonicalize_cost(P.QuadCost(eye, zero), T, B, n)
            cfg, a_cost, dyn, ws, x0 = augment_slew_rate(
                dataclasses.replace(cfg, slew_rate_penalty=1.0), c_cost, dyn, ws, x0, None)
            cost = (a_cost.C, a_cost.c)
        elif lanes:
            cost = tuple(a.contiguous() for a in canonicalize_cost(P.QuadCost(eye, zero), T, B, n))
        flat = kernel_params(dyn, ws)
        if not fused.covered(cfg, dyn, flat, torch.float32, None if lanes else cost, None, None,
                             -box, box):
            fail(f"phase 10 {label}: not covered")
        cases.append(small_mlp_case(torch, fused, card, f"phase 10 (a) {label} B={B} T={T}", cfg,
                                    dyn, flat, x0, cost, -box, box))
        worst = max(worst, cases[-1]["max_abs_err"])
    cases.append(learned_mlp_case(torch, P, fused, card, dev, gen))
    worst = max(worst, cases[-1]["max_abs_err"])
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) serving on the golden's MLP ----
    total = {name: 0 for name in kernels}
    one = {"ilqr_fused": 1, "kkt_fused": 0, "riccati_fused": 0}

    def run(label, fn, want, part="b"):
        return drive(torch, kernels, total, f"phase 10 ({part}) {label}", fn, want)

    dyn = nn_dynamics.make(3, 2, activation="sigmoid", passthrough=True, hidden_sizes=(16,))
    cost = P.QuadCost(torch.eye(5, device=dev), torch.zeros(5, device=dev))
    x_serve = torch.randn(4096, 3, generator=gen).to(dev)
    kw = dict(u_lower=-box, u_upper=box, lqr_iter=20, eps=1e-4, backprop=False,
              exit_unconverged=False)
    cfg = P.ILQRConfig(n_state=3, n_ctrl=2, T=T, lqr_iter=20, eps=1e-4, backprop=False,
                       exit_unconverged=False, detach_unconverged=False)
    # name -> (call(backend), B, launches a call)
    paths = {
        "MPC.solve golden MLP B=4096": (
            lambda be: P.MPC(3, 2, T, backend=be, **kw).solve(x_serve, cost, dyn, params=golden),
            4096, 1),
        "receding_horizon golden MLP B=4096 x1 step": (
            lambda be: receding_horizon(dataclasses.replace(cfg, backend=be), dyn, golden, cost,
                                        x_serve, 1, u_lower=-box, u_upper=box),
            4096, 1),
    }
    for label, (call, B, n) in paths.items():
        out, _ = run(label, lambda: call("auto"), {**one, "ilqr_fused": n})
        if label.startswith("receding_horizon"):
            if out.xs.shape != (B, n + 1, 3) or not torch.isfinite(out.xs).all():
                fail(f"{label}: bad closed-loop states")
            if out.us.abs().max().item() > box + 1e-5:
                fail(f"{label}: actions outside the box")
            print(f"phase 10 (b) {label}: mean |u| {out.us.abs().mean().item():.4f}, mean |x'| "
                  f"{out.xs[:, -1].abs().mean().item():.4f}", flush=True)
            continue
        if out.x.shape != (B, T, 3) or out.u.shape != (B, T, 2):
            fail(f"{label}: shapes {tuple(out.x.shape)}, {tuple(out.u.shape)}")
        if not (torch.isfinite(out.costs).all() and torch.isfinite(out.x).all()):
            fail(f"{label}: non-finite output")
        if (out.u.abs() - box).max().item() > 1e-5:
            fail(f"{label}: controls outside the box")
        at = ((out.u.abs() - box).abs() < 1e-6).float().mean().item()
        print(f"phase 10 (b) {label}: n_iter {int(out.n_iter)}, mean cost "
              f"{out.costs.mean().item():.4f}, converged share "
              f"{out.converged.float().mean().item():.4f}, share of controls at the box "
              f"{at:.4f}", flush=True)

    # ---- (c) the IFT gradient with respect to the golden's weights ----
    x_grad = x_serve[:1024]

    def grad(backward_backend):
        wr = [tuple(a.clone().requires_grad_(True) for a in layer) for layer in golden]
        c = dataclasses.replace(cfg, lqr_iter=10, backprop=True, backward_mode=P.BackwardMode.IFT,
                                backward_backend=backward_backend)
        res = P.solve(c, x_grad, cost, dyn, params=wr, u_lower=-box, u_upper=box)
        gs = torch.autograd.grad((res.u ** 2).mean(), [a for layer in wr for a in layer])
        return torch.cat([g.reshape(-1) for g in gs])

    label = "IFT grad golden MLP weights B=1024"
    g, _ = run(label, lambda: grad(None), {"ilqr_fused": 1, "kkt_fused": None,
                                           "riccati_fused": 0}, "c")
    g_ref = grad("torch")
    err = (g - g_ref).abs().max().item()
    print(f"phase 10 (c) {label}: |grad| max {g.abs().max().item():.4e}, abs. diff to the plain "
          f"backward {err:.2e} over {g.numel()} weights", flush=True)
    if not torch.isfinite(g).all() or g.abs().max().item() == 0.0:
        fail(f"{label}: a non-finite or zero gradient")
    if err > 1e-3 * g_ref.abs().max().item() + 1e-8:
        fail(f"{label}: the gradient differs from the plain backward's by {err:.3e}")

    # ---- (d) hidden 100 on the kernel ----
    big = nn_dynamics.make(5, 1, hidden_sizes=(100,))
    wb = nn_dynamics.init_params(5, 1, (100,), generator=gen, device=dev)
    if nn_dynamics.flat_params(wb) is not None:
        fail("phase 10 (d): flat_params, JAX's mirror, flattens the 1,205 weights of hidden 100")
    if tuple(kernel_params(big, wb).shape) != (1205,):
        fail("phase 10 (d): kernel_params does not flatten the 1,205 weights of hidden 100")
    q, p = cartpole.get_true_obj(device=dev)
    label = "MPC.solve learned model hidden 100 B=1024"
    out, got = run(label, lambda: P.MPC(5, 1, T, u_lower=-100.0, u_upper=100.0, lqr_iter=2,
                                        eps=1e-4, linesearch_decay=0.5, max_linesearch_iter=2,
                                        backprop=False, exit_unconverged=False).solve(
        cartpole_start(torch, gen, 1024, dev), P.QuadCost(torch.diag(q), p), big, params=wb),
        {"ilqr_fused": 1, "kkt_fused": 0, "riccati_fused": 0}, "d")
    if not torch.isfinite(out.costs).all():
        fail(f"{label}: non-finite costs")
    print(f"phase 10 (d) {label}: n_iter {int(out.n_iter)}, Riccati launches "
          f"{got['riccati_fused']}, whole-solve launches {got['ilqr_fused']}", flush=True)
    print(f"phase 10 launches: {total}", flush=True)

    # ---- (b) times: MPC.solve against the plain loop, in turns ----
    figures = []
    for label, (call, B, n) in list(paths.items())[:1]:
        got = host_ms_in_turns({"kernel": lambda: call("auto"),
                                "plain loop": lambda: call("torch")}, rounds=1,
                               warm_both=False)
        (k_ms, k_runs), (t_ms, t_runs) = got["kernel"], got["plain loop"]
        print(f"time phase 10 {label}: {k_ms:.3f} ms with the whole-solve kernel, {t_ms:.3f} ms "
              f"with backend='torch' (host clock, synchronized, median of {len(k_runs)} in "
              f"turns: {', '.join(f'{r:.3f}' for r in k_runs)} / "
              f"{', '.join(f'{r:.3f}' for r in t_runs)}) [{card}]", flush=True)
        figures.append({"name": label, "launches": n, "ms": k_ms, "torch_ms": t_ms})
    profile_step(torch, "phase 10 MPC.solve golden MLP B=4096",
                 lambda: paths["MPC.solve golden MLP B=4096"][0]("auto"),
                 counted=(fused, "ilqr_fused_kernel"))
    head = cases[0]
    return {"name": "ilqr_fused_mlp", "route": "cuda",
            "source": "dilqr_tpu_torch/csrc/ilqr_mlp.cu",
            "replaces": "dilqr_tpu/ops/pallas/ilqr_fused.py:699",
            "launches": total["ilqr_fused"], "max_abs_err": worst, "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None, "cases": cases, "paths": figures,
            "kkt_launches": total["kkt_fused"]}


def multihost_paths(torch, P, dev, kernels, card, dyn, params, q, p, cfg, gen):
    """Phase 11: the batch sharded over ranks (parallel/multihost.py) and
    devices (parallel/mesh.py) on bench.py's cartpole (``cfg``, f32).

    (a) In this process, a one-rank NCCL group: multihost_solve at B=4096
    (one whole-solve launch) with the bits of ``solve`` on the same inputs,
    its collectives audited (none past B elements) and its host time
    against solve's in turns (the wrapper's own cost); one
    multihost_train_step at B=1024 (whole-solve and KKT launches) within
    1e-6 of the one-process step; sharded_solve over the card twice at
    2 x 4096 with the bits of the one-device solve of 8192.
    (b) Two ranks over gloo on the one card, each a process of
    tools/multihost_demo.py (NCCL refuses two ranks on one device, and
    gloo runs its collectives on the host): the solve and the warm-started
    solve at 4096 + 4096 with the one-process kernel solve's bits on every
    example (whole tiles a rank, and the kernel decides per tile), the
    train step at 2 x 1024 within 1e-6 of the one-process step; and the
    padded uneven 4096 + 1000 (2548 a rank, tiles cut otherwise) held on
    the examples converged in both, with its strict 1024-a-rank solve at
    the same bits. Each rank checks itself, exits 0 and reports its
    launches and collectives; a rank that fails, or a cluster past 240 s,
    fails the run. Returns the launches of (a) and of every rank of (b)."""
    import concurrent.futures
    import dataclasses
    import os
    import tempfile

    import numpy as np

    from dilqr_tpu_torch.parallel import audit
    from dilqr_tpu_torch.parallel import multihost as mh
    from dilqr_tpu_torch.parallel.mesh import batch_mesh, sharded_solve
    from dilqr_tpu_torch.tools import multihost_demo as demo
    from dilqr_tpu_torch.utils.optim import rmsprop

    total = {name: 0 for name in kernels}
    cost = P.QuadCost(torch.diag(q), p)
    box = dict(u_lower=dyn.lower, u_upper=dyn.upper)

    def run(label, fn, want):
        return drive(torch, kernels, total, f"phase 11 {label}", fn, want)

    def audited(label, recs, B):
        colls, big = audit.audit_collectives(recs, B)
        sizes = sorted({c.numel for c in colls})
        print(f"phase 11 {label}: {len(colls)} collectives, {sum(c.numel for c in colls)} "
              f"elements (sizes {sizes}; sites {sorted({c.site for c in colls})})", flush=True)
        if big:
            fail(f"phase 11 {label}: per-example collectives {big}")

    # ---- (a) one rank, NCCL, in this process ----
    with tempfile.TemporaryDirectory() as tmp:
        mh.initialize(f"file://{os.path.join(tmp, 'store')}", 1, 0, device=dev, timeout=120)
        try:
            mesh = mh.global_batch_mesh()
            x0 = cartpole_start(torch, gen, 4096, dev)
            one = P.solve(cfg, x0, cost, dyn, params=params, **box)

            def sharded():
                return mh.multihost_solve(mesh, cfg, x0, cost, dyn, params=params, **box)

            with audit.recording() as recs:
                res, _ = run("(a) multihost_solve cartpole B=4096, NCCL, one rank", sharded,
                             {"ilqr_fused": 1, "kkt_fused": 0, "riccati_fused": 0})
            if not all(torch.equal(getattr(res, f), getattr(one, f)) for f in one._fields):
                fail("phase 11 (a): multihost_solve differs from solve on the same inputs")
            audited("(a) multihost_solve B=4096", recs, 4096)
            turns = host_ms_in_turns({"multihost_solve": sharded, "solve": lambda: P.solve(
                cfg, x0, cost, dyn, params=params, **box)}, rounds=5)
            (m_ms, m_runs), (s_ms, s_runs) = turns["multihost_solve"], turns["solve"]
            print(f"time phase 11 (a) cartpole B=4096: multihost_solve {m_ms:.3f} ms, solve "
                  f"{s_ms:.3f} ms (host clock, synchronized, median of {len(m_runs)} in turns: "
                  f"{', '.join(f'{r:.3f}' for r in m_runs)} / "
                  f"{', '.join(f'{r:.3f}' for r in s_runs)}) [{card}]", flush=True)

            c_ift = dataclasses.replace(cfg, backprop=True, backward_mode=P.BackwardMode.IFT)
            opt = rmsprop(1e-2, decay=0.5)
            xt = cartpole_start(torch, gen, 1024, dev)
            ue = torch.zeros(xt.shape[0], cfg.T, 1, device=dev)
            ref, _, ref_loss = demo.one_process_step(c_ift, dyn, opt, params, opt.init(params),
                                                     xt, ue, q, p)
            step = mh.multihost_train_step(mesh, c_ift, dyn, opt)
            with audit.recording() as recs:
                (new, _, loss), got = run(
                    "(a) multihost_train_step cartpole B=1024, NCCL, one rank",
                    lambda: step(params, opt.init(params), xt, ue, q, p),
                    {"ilqr_fused": None, "kkt_fused": None})
            err = (new - ref).abs().max().item()
            print(f"phase 11 (a) train step: params {new.tolist()}, max |diff| to the one-process "
                  f"step {err:.2e} (same bits: {torch.equal(new, ref)}), loss {loss.item():.6f} "
                  f"vs {ref_loss.item():.6f}", flush=True)
            if err > 1e-6 or not torch.isfinite(loss):
                fail(f"phase 11 (a): the train step is {err:.2e} from the one-process step")
            audited("(a) multihost_train_step B=1024", recs, 1024)
        finally:
            mh.shutdown()

    # the single-process mesh: the card twice, a chunk of 4096 each
    x8 = cartpole_start(torch, gen, 8192, dev)
    one = P.solve(cfg, x8, cost, dyn, params=params, **box)
    sres, _ = run("(a) sharded_solve cartpole 2 x 4096 on one card",
                  lambda: sharded_solve(batch_mesh([dev, dev]), cfg, x8, cost, dyn,
                                        params=params, **box),
                  {"ilqr_fused": 2, "kkt_fused": 0, "riccati_fused": 0})
    whole = sres.gather()
    if not all(torch.equal(getattr(whole, f), getattr(one, f)) for f in one._fields):
        fail("phase 11 (a): sharded_solve differs from the one-device solve")
    print(f"phase 11 (a) sharded_solve: chunks at {sres.starts}, the one-device bits", flush=True)

    # ---- (b) two ranks over gloo on the one card, one process each ----
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--device", str(dev), "--backend", "gloo", "--problem", "cartpole",
                  "--timeout", "120"]
        jobs = {"4096 + 4096": ["--batches", "4096,4096", "--train-batch", "1024"],
                "padded 4096 + 1000": ["--batches", "4096,1000"]}
        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
            futs = {k: ex.submit(demo.launch, 2, common + argv + [
                "--out", os.path.join(tmp, f"{i}.npz")], timeout=240.0)
                for i, (k, argv) in enumerate(jobs.items())}
            outs = {}
            for k, fut in futs.items():
                try:
                    outs[k] = fut.result()
                except RuntimeError as e:
                    fail(f"phase 11 (b) {k}: {e}")
        print(f"phase 11 (b): both clusters done in {time.perf_counter() - t1:.1f} s", flush=True)
        res = {k: dict(np.load(os.path.join(tmp, f"{i}.npz"))) for i, k in enumerate(jobs)}
    for k, lines in outs.items():
        for line in lines:
            print(f"phase 11 (b) {k}: {line.strip().splitlines()[-1]}", flush=True)
    even, uneven = res["4096 + 4096"], res["padded 4096 + 1000"]
    # launches: [rank, (ilqr, kkt, riccati) of the solve (, of the step)]
    le, lu = even["launches"], uneven["launches"]
    if not (bool(even["bits_solve"]) and bool(even["bits_warm"]) and bool(uneven["bits_strict"])):
        fail("phase 11 (b): a whole-tile sharded solve differs from the one-process bits")
    if float(even["err_params"]) > 1e-6:
        fail(f"phase 11 (b): the train step is {float(even['err_params']):.2e} off")
    if (le[:, 0] < 1).any() or (le[:, 3] < 1).any() or (le[:, 4] < 1).any() or (lu[:, 0] < 1).any():
        fail(f"phase 11 (b): a rank did not launch its kernels: {le.tolist()}, {lu.tolist()}")
    print(f"phase 11 (b) 4096 + 4096: collectives a rank per solve {even['collectives_solve']}, "
          f"per train step {even['collectives_step']} (count, elements); launches a rank "
          f"(ilqr, kkt, riccati) solve / step {le.tolist()}; train step params "
          f"{even['params'].tolist()}, max |diff| {float(even['err_params']):.2e}", flush=True)
    print(f"phase 11 (b) padded 4096 + 1000: {int(uneven['converged_pad'])} of "
          f"{int(uneven['counts'].sum())} examples "
          f"converged in both, u max {float(uneven['err_pad']):.2e} on them; collectives a rank "
          f"per solve {uneven['collectives_solve']}; launches a rank {lu.tolist()}", flush=True)
    for name, col in (("ilqr_fused", (0, 3)), ("kkt_fused", (1, 4)), ("riccati_fused", (2, 5))):
        total[name] += int(le[:, col[0]].sum() + le[:, col[1]].sum() + lu[:, col[0]].sum())
    print(f"phase 11 launches (a and every rank of b): {total}", flush=True)
    return total


def cartpole_bound(fused, T, B, tile_iters, by):
    """The least time of one cartpole solve on the hand Jacobian: (ms,
    "bytes" or "operations", FLOP) for ``by`` bytes moved. Operations:
    bench.py's FLOP model of the solve per example, step and iteration
    (the step, its Jacobian, the Riccati step, the box-QP and one
    line-search trial) times the iterations each tile ran."""
    nx, nu, step_f = 5, 1, 40.0
    n = nx + nu
    per_t = (n * step_f + 2 * nx * nx * n + 2 * n * nx * n + 2 * n * nx + 10 + 250
             + 2 * (2 * nu * nx + 2 * n * n + step_f))
    flops = per_t * T * sum(int(it) * min(fused.TILE, B - g * fused.TILE)
                            for g, it in enumerate(tile_iters))
    t_ops, t_by = flops / FP32_PEAK, by / HBM_RATE
    return max(t_ops, t_by) * 1e3, ("operations" if t_ops >= t_by else "bytes"), flops


def vmap_paths(torch, P, dev, kernels, card, fused, dyn, params, q, p, cfg, gen):
    """Phase 12: torch.func.vmap over the solve (the vmap rule of
    diff/modes._SolveWithGrad) on bench.py's cartpole (``cfg``: T=20, box
    +-100, lqr_iter 20, f32), every launch counter set to 0 before each step
    and read after, and the rule's route counted (modes.VMAP_STATS).

    (a) vmap over MPC.solve, 8 control-weight candidates at B=4096: one
    whole-solve launch on the folded 32768 examples (the merged route), each
    candidate's x, u, costs and du the bits of its own solve (a 4096 batch
    is whole tiles, and the kernel decides per tile), n_iter the max of the
    eight; (b) an x_init sweep S=3 at B=1000 (tiles mixing candidates): the
    bits of the hand-folded 3000-example solve; (c) a params sweep S=2: one
    launch a candidate (the mapped route: the kernel reads one params
    vector a launch), each the bits of its own solve; (d) the IFT gradient
    of a loss summed over a sweep S=4 at B=1024: one whole-solve launch and
    one backward on the folded batch, the KKT launches of the hand-folded
    4096-example solve's backward, the gradient within 1e-6 relative of that
    solve's; (e) the sweep against a loop of its 8 solves in turns (host
    clock), the folded launch alone by CUDA events beside its bound and its
    plain version (one run), one profiled sweep (the idle share), and
    examples.cost_sweep.main() once, its numbers finite. Returns (the
    launches, the kernel table's sweep row)."""
    import dataclasses

    from dilqr_tpu_torch.diff import modes
    from dilqr_tpu_torch.examples import cost_sweep

    total = {name: 0 for name in kernels}
    box = dict(u_lower=-100.0, u_upper=100.0)
    T, n = cfg.T, cfg.n_tau
    stats = modes.VMAP_STATS
    merged, mapped = {"vmap_merged": 1, "vmap_mapped": 0}, {"vmap_merged": 0, "vmap_mapped": 1}

    def run(label, fn, want, route, into=total):
        before = dict(stats)
        out, got = drive(torch, kernels, into, f"phase 12 {label}", fn, want)
        moved = {k: stats[k] - before[k] for k in stats}
        route = dict(dict.fromkeys(stats, 0), **route)  # no backward is vmapped here
        if moved != route:
            fail(f"phase 12 {label}: routes {moved}, want {route}")
        return out, got

    def same(label, got, want, s=None):
        for name in ("x", "u", "costs", "full_du_norm"):
            a, b = getattr(got, name), getattr(want, name)
            a = a[s] if s is not None else a.reshape(b.shape)
            if not torch.equal(a, b):
                fail(f"phase 12 {label}: {name} differs from its own solve by "
                     f"{(a - b).abs().max().item():.3e}")

    def cost_of(w):
        return P.QuadCost(torch.diag(torch.cat([q[:-1], w[None]])), p)

    mpc = P.MPC(5, 1, T, lqr_iter=cfg.lqr_iter, eps=cfg.eps,
                linesearch_decay=cfg.linesearch_decay, max_linesearch_iter=cfg.max_linesearch_iter,
                exit_unconverged=False, backprop=False, **box)
    one = {"ilqr_fused": 1, "kkt_fused": 0, "riccati_fused": 0}

    # ---- (a) 8 control weights x 4096, one launch ----
    S, B = 8, 4096
    ws = torch.logspace(-3, 0, S, device=dev)
    x0 = cartpole_start(torch, gen, B, dev)

    def sweep():
        return torch.func.vmap(lambda w: mpc.solve(x0, cost_of(w), dyn, params=params))(ws)

    label = f"(a) vmap over MPC.solve, {S} control weights x B={B}"
    res, _ = run(label, sweep, one, merged)
    its = []
    for s in range(S):
        own = mpc.solve(x0, cost_of(ws[s]), dyn, params=params)
        same(f"{label}, candidate {s}", res, own, s)
        its.append(int(own.n_iter))
    if res.n_iter.tolist() != [max(its)] * S:
        fail(f"phase 12 {label}: n_iter {res.n_iter.tolist()}, the candidates' {its}")
    print(f"phase 12 {label}: each candidate's bits, n_iter {int(res.n_iter[0])} (candidates "
          f"{its}), mean cost by candidate {[round(c, 4) for c in res.costs.mean(1).tolist()]}",
          flush=True)

    # ---- (b) an x_init sweep at a ragged B, the hand-folded solve's bits ----
    cost = P.QuadCost(torch.diag(q), p)
    xs = torch.stack([cartpole_start(torch, gen, 1000, dev) for _ in range(3)])
    label = "(b) vmap over MPC.solve, 3 starts x B=1000"
    res_b, _ = run(label, lambda: torch.func.vmap(
        lambda x: mpc.solve(x, cost, dyn, params=params))(xs), one, merged)
    same(f"{label} against the folded 3000", res_b, mpc.solve(xs.reshape(3000, 5), cost, dyn,
                                                              params=params))
    print(f"phase 12 {label}: the hand-folded 3000-example solve's bits, n_iter "
          f"{int(res_b.n_iter[0])}", flush=True)

    # ---- (c) a params sweep: one launch a candidate ----
    ps = torch.stack([params, params * 1.1])
    label = "(c) vmap over MPC.solve, 2 params x B=4096"
    res_c, _ = run(label, lambda: torch.func.vmap(
        lambda pp: mpc.solve(x0, cost, dyn, params=pp))(ps),
        {"ilqr_fused": 2, "kkt_fused": 0, "riccati_fused": 0}, mapped)
    for s in range(2):
        same(f"{label}, candidate {s}", res_c, mpc.solve(x0, cost, dyn, params=ps[s]), s)
    print(f"phase 12 {label}: each candidate's bits, n_iter {res_c.n_iter.tolist()}", flush=True)

    # ---- (d) the IFT gradient through a sweep, one backward ----
    g_cfg = dataclasses.replace(cfg, backprop=True, backward_mode=P.BackwardMode.IFT)
    S4, B4 = 4, 1024
    w4 = torch.logspace(-2, 0, S4, device=dev)
    x4 = cartpole_start(torch, gen, B4, dev)

    def grad(folded):
        pr = params.clone().requires_grad_(True)
        if folded:
            C = torch.stack([cost_of(w).C for w in w4]).repeat_interleave(B4, 0)
            r = P.solve(g_cfg, x4.repeat(S4, 1), P.QuadCost(C[:, None].expand(-1, T, -1, -1),
                                                             p.expand(S4 * B4, T, n)),
                        dyn, params=pr, **box)
        else:
            r = torch.func.vmap(lambda w: P.solve(g_cfg, x4, cost_of(w), dyn, params=pr,
                                                  **box))(w4)
        return torch.autograd.grad((r.u ** 2).mean(), pr)[0]

    both = {"ilqr_fused": 1, "kkt_fused": None, "riccati_fused": 0}
    label = f"(d) IFT gradient through vmap, {S4} control weights x B={B4}"
    g, got = run(label, lambda: grad(False), both, merged)
    g_f, got_f = run(f"{label}, hand-folded", lambda: grad(True), both,
                     {"vmap_merged": 0, "vmap_mapped": 0}, into={name: 0 for name in kernels})
    rel = ((g - g_f).abs().max() / g_f.abs().max()).item()
    print(f"phase 12 {label}: grad params {g.tolist()}, rel. diff to the hand-folded solve's "
          f"{rel:.3e}; KKT launches {got['kkt_fused']} (hand-folded {got_f['kkt_fused']})",
          flush=True)
    if not (torch.isfinite(g).all() and rel <= 1e-6):
        fail(f"phase 12 {label}: gradient off the hand-folded solve's by {rel:.3e}")
    if got["kkt_fused"] != got_f["kkt_fused"]:
        fail(f"phase 12 {label}: {got['kkt_fused']} KKT launches, the folded backward "
             f"{got_f['kkt_fused']}")

    # ---- (e) times ----
    turns = host_ms_in_turns({
        "vmap sweep": sweep,
        "loop of 8 solves": lambda: [mpc.solve(x0, cost_of(w), dyn, params=params) for w in ws]})
    print_turns(card, f"phase 12 (e) vmap over MPC.solve {S} x B={B} against a loop of its "
                f"{S} solves", turns)
    xf = x0.repeat(S, 1)
    cf = (torch.stack([cost_of(w).C for w in ws]).repeat_interleave(B, 0)[None].expand(
        T, -1, -1, -1), p.expand(T, S * B, n))
    args = (cfg, dyn, params, xf, cf, None, -100.0, 100.0)
    k_out = fused.ilqr_fused(*args)
    for a, b in zip(k_out[:4], (res.x, res.u, res.costs, res.full_du_norm)):
        b = b.reshape(S * B, *b.shape[2:])  # candidate-major, batch-major
        if not torch.equal(a, b.transpose(0, 1) if b.dim() > 1 else b):
            fail("phase 12 (e): the folded launch's bits differ from the sweep's")
    ms, runs = cuda_ms(lambda: fused.ilqr_fused(*args), 2, 7)
    plain_ms, _ = cuda_ms(lambda: fused.ilqr_fused_reference(*args), 0, 1)
    its = [int(fused.ilqr_fused(cfg, dyn, params, xf[g:g + fused.TILE],
                                tuple(a[:, g:g + fused.TILE] for a in cf), None, -100.0,
                                100.0)[4]) for g in range(0, S * B, fused.TILE)]
    bound, by_what, flops = cartpole_bound(fused, T, S * B, its,
                                           variant_work(cfg, S * B, cf, -100.0, 100.0, None, {}))
    print(f"time phase 12 ilqr_fused the folded sweep B={S * B} T={T} (per-example cost): "
          f"{ms:.3f} ms median of {len(runs)} ({', '.join(f'{r:.3f}' for r in runs)}), the "
          f"plain version {plain_ms:.1f} ms (one run); bound {flops:.3e} FLOP -> {bound:.4f} ms "
          f"({by_what}); tile iterations {its} [{card}]", flush=True)
    profile_step(torch, f"phase 12 (a) vmap over MPC.solve {S} x B={B}", sweep,
                 counted=(fused, "ilqr_fused_kernel"))
    out, _ = run("(e) examples.cost_sweep.main()", lambda: cost_sweep.main(["--device", "cuda"]),
                 one, merged)
    if not all(math.isfinite(v) for v in out["tracking"] + out["effort"]):
        fail(f"phase 12 (e) cost_sweep: non-finite numbers {out}")
    print(f"phase 12 launches: {total}", flush=True)
    return total, {"name": f"vmap sweep, cartpole S={S} x B={B} folded", "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by_what,
                   "sweep_ms": turns["vmap sweep"][0], "loop_ms": turns["loop of 8 solves"][0]}


# phase 13's bar for a candidate's gradient on the merged route against its
# solo gradient (f32): the folded GMRES runs until every candidate meets the
# IFT tolerance (backward_tol, 1e-4 relative to each example's right-hand
# side), so a candidate may take more iterations than it would alone
# (ROADMAP C); ten times that tolerance, of the largest entry
PERGRAD_SOLO_BAR = 1e-3


def pergrad_paths(torch, P, dev, kernels, card, kkt, dyn, params, q, p, cfg, gen):
    """Phase 13: per-candidate gradients -- torch.func.vmap over
    torch.func.grad, jacrev, UNROLL and delta_u under vmap -- on bench.py's
    cartpole (``cfg``: T=20, box +-100, lqr_iter 20, f32; IFT unless
    named), every launch counter and modes.VMAP_STATS set to 0 before each
    step and read after.

    (a) vmap(grad) of each candidate's imitation loss (sum (u - u*)^2,
    targets from ``gen``) with respect to its control weight and the shared
    params, 8 control weights (examples/cost_sweep.py's logspace) x B=4096:
    one whole-solve launch and one folded backward (vmap_merged and
    bwd_merged once each), whose KKT launches equal the hand-folded
    32768-example backward's; the weights' gradients and the params' summed
    over the candidates within 1e-6 relative of the hand-folded backward's,
    the params' per candidate within 1e-6 of that backward with the
    per-candidate param reduction (modes._backward with the params given
    per example, each candidate's examples summed); each candidate within
    PERGRAD_SOLO_BAR of its solo torch.func.grad, whose KKT launches (the
    GMRES matvecs plus the full call) are printed beside the folded one's;
    (b) jacrev of the batch-mean terminal state (5 outputs) with respect to
    the params at B=4096: one whole-solve launch, one folded backward on the
    5 x 4096 one-hot cotangents, within 1e-5 relative of 5 autograd.grad
    calls on one-hot cotangents (retain_graph), one run of each timed; (c) at S=2, B=256,
    lqr_iter 5, the plain loop: vmap over the UNROLL solve and vmap(grad)
    through it, each candidate the bits of its own solve and gradient (no
    kernel launch); a delta_u sweep S=3 on the mapped route, one
    whole-solve launch a candidate, each with its own solve's bits; (d)
    tools/fuzz_gradients on the card, 6 cases with --vmap 2, every case
    passing; (e) (a) against a Python loop of its 8 solo gradients in
    turns (host clock), one profiled sweep (the idle share, the KKT
    launches recorded), and the folded backward's KKT "Ff" call at 32768
    examples (CUDA events) beside its bound (kkt_work) and plain version.
    Returns (the launches, the kernel table's sub-row 2a)."""
    import dataclasses

    from dilqr_tpu_torch.core.linearize import linearize_dynamics
    from dilqr_tpu_torch.diff import modes
    from dilqr_tpu_torch.tools import fuzz_gradients

    total = {name: 0 for name in kernels}
    box = dict(u_lower=-100.0, u_upper=100.0)
    T, n = cfg.T, cfg.n_tau
    stats = modes.VMAP_STATS
    g_cfg = dataclasses.replace(cfg, backprop=True, backward_mode=P.BackwardMode.IFT)
    some = {"ilqr_fused": 1, "kkt_fused": None, "riccati_fused": 0}
    none = {"ilqr_fused": 0, "kkt_fused": 0, "riccati_fused": 0}

    def run(label, fn, want, route, into=total):
        stats.update(dict.fromkeys(stats, 0))
        t1 = time.perf_counter()
        out, got = drive(torch, kernels, into, f"phase 13 {label}", fn, want)
        run.ms = (time.perf_counter() - t1) * 1e3  # one run, host clock, synchronized
        moved = {k: v for k, v in stats.items() if v}
        if moved != route:
            fail(f"phase 13 {label}: routes {moved}, want {route}")
        return out, got

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    def check(label, err, bar):
        print(f"phase 13 {label}: rel. diff {err:.3e} (bar {bar:g})", flush=True)
        if not err <= bar:
            fail(f"phase 13 {label}: rel. diff {err:.3e} past {bar:g}")

    def cost_of(w):
        return P.QuadCost(torch.diag(torch.cat([q[:-1], w[None]])), p)

    # ---- (a) vmap(grad) at full width ----
    S, B = 8, 4096
    ws = torch.logspace(-3, 0, S, device=dev)
    x0 = cartpole_start(torch, gen, B, dev)
    target = 0.5 * torch.randn(B, T, 1, generator=gen).to(dev)

    def loss(pr, w):
        r = P.solve(g_cfg, x0, cost_of(w), dyn, params=pr, **box)
        return ((r.u - target) ** 2).sum()

    def sweep():
        return torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)), in_dims=(None, 0))(
            params, ws)

    def folded():
        pr, wl = params.clone().requires_grad_(True), ws.clone().requires_grad_(True)
        C = torch.stack([cost_of(w).C for w in wl]).repeat_interleave(B, 0)
        r = P.solve(g_cfg, x0.repeat(S, 1), P.QuadCost(C[:, None].expand(-1, T, -1, -1),
                                                        p.expand(S * B, T, n)),
                    dyn, params=pr, **box)
        return torch.autograd.grad(((r.u.reshape(S, B, T, 1) - target) ** 2).sum(), (pr, wl)), r

    label = f"(a) vmap(grad) over {S} control weights x B={B}"
    (g_p, g_w), got = run(label, sweep, some, {"vmap_merged": 1, "bwd_merged": 1})
    ((f_p, f_w), r_f), got_f = run(f"{label}, hand-folded", folded, some, {},
                                   into={name: 0 for name in kernels})
    if got["kkt_fused"] != got_f["kkt_fused"]:
        fail(f"phase 13 {label}: {got['kkt_fused']} KKT launches, the hand-folded backward "
             f"{got_f['kkt_fused']}")
    if not (torch.isfinite(g_p).all() and torch.isfinite(g_w).all()):
        fail(f"phase 13 {label}: non-finite gradients")
    check(f"{label}: d/dw against the hand-folded backward", rel(g_w, f_w), 1e-6)
    check(f"{label}: d/dparams summed over the candidates against the hand-folded backward",
          rel(g_p.sum(0), f_p), 1e-6)
    # the hand-folded backward with the per-candidate param reduction: the
    # params given per example, each candidate's examples summed
    x_t, u_t = r_f.x.detach().transpose(0, 1), r_f.u.detach().transpose(0, 1)
    C_t = torch.stack([cost_of(w).C for w in ws]).repeat_interleave(B, 0)[None].expand(
        T, -1, -1, -1)
    c_t = p.expand(T, S * B, n)
    gu = 2.0 * (u_t - target.transpose(0, 1).repeat(1, S, 1))
    prob, _ = modes._problem(g_cfg, P.QuadCost(C_t, c_t), dyn, params)
    (_, _, d_pe), got_r = run(f"{label}, hand-folded with the params per example", lambda: (
        modes._backward(prob, x_t, u_t, r_f.full_du_norm, -100.0, 100.0, (C_t, c_t),
                        params.expand(S * B, -1), torch.zeros_like(x_t), gu)),
        {"ilqr_fused": 0, "kkt_fused": None, "riccati_fused": 0}, {},
        into={name: 0 for name in kernels})
    check(f"{label}: d/dparams per candidate against the hand-folded backward's "
          f"per-candidate reduction ({got_r['kkt_fused']} KKT launches)",
          rel(g_p, d_pe.unflatten(0, (S, B)).sum(1)), 1e-6)
    solo_kkt, worst = [], 0.0
    for s in range(S):
        (s_p, s_w), got_s = run(f"{label}, candidate {s} alone",
                                lambda: torch.func.grad(loss, argnums=(0, 1))(params, ws[s]),
                                some, {}, into={name: 0 for name in kernels})
        solo_kkt.append(got_s["kkt_fused"])
        worst = max(worst, rel(g_p[s], s_p), ((g_w[s] - s_w).abs() / s_w.abs()).item())
    print(f"phase 13 {label}: KKT launches (GMRES matvecs + the full call) of the folded "
          f"backward {got['kkt_fused']}, of each candidate alone {solo_kkt}; grad params by "
          f"candidate {[[round(v, 4) for v in r] for r in g_p.tolist()]}, d/dw "
          f"{[f'{v:.4e}' for v in g_w.tolist()]}", flush=True)
    check(f"{label}: each candidate against its solo gradient (largest)", worst,
          PERGRAD_SOLO_BAR)

    # ---- (b) jacrev of the batch-mean terminal state ----
    cost = P.QuadCost(torch.diag(q), p)

    def terminal(pr):
        return P.solve(g_cfg, x0, cost, dyn, params=pr, **box).x[:, -1].mean(0)

    def one_hot():
        pr = params.clone().requires_grad_(True)
        out = terminal(pr)
        return torch.stack([torch.autograd.grad(out, pr, e, retain_graph=True)[0]
                            for e in torch.eye(5, device=dev)])

    label = f"(b) jacrev of the mean terminal state (5) w.r.t. the params, B={B}"
    jac, got_j = run(label, lambda: torch.func.jacrev(terminal)(params), some,
                     {"bwd_merged": 1})
    jac_ms = run.ms
    rows, got_o = run(f"{label}, 5 one-hot backwards", one_hot, some, {},
                      into={name: 0 for name in kernels})
    print(f"phase 13 {label}: KKT launches {got_j['kkt_fused']} (one folded backward of "
          f"{5 * B} examples), the one-hot loop's {got_o['kkt_fused']}; {jac_ms:.1f} ms against "
          f"{run.ms:.1f} ms (one run each, forward included, host clock) [{card}]", flush=True)
    if not torch.isfinite(jac).all() or tuple(jac.shape) != (5, 4):
        fail(f"phase 13 {label}: jacobian of shape {tuple(jac.shape)}, finite "
             f"{bool(torch.isfinite(jac).all())}")
    check(f"{label} against the one-hot loop", rel(jac, rows), 1e-5)

    # ---- (c) UNROLL and delta_u under vmap ----
    B2 = 256
    xc, tc = cartpole_start(torch, gen, B2, dev), target[:B2]
    w2 = torch.tensor([0.01, 0.1], device=dev)
    u_cfg = dataclasses.replace(g_cfg, lqr_iter=5, backward_mode=P.BackwardMode.UNROLL,
                                unroll=True)

    def unrolled(w, pr=params):
        return P.solve(u_cfg, xc, cost_of(w), dyn, params=pr, **box)

    def loss_u(pr, w):
        return ((unrolled(w, pr).u - tc) ** 2).sum()

    def same(label, got, want, s):
        for name in ("x", "u", "costs", "full_du_norm"):
            if not torch.equal(getattr(got, name)[s], getattr(want, name)):
                fail(f"phase 13 {label}: {name} of candidate {s} differs from its own solve's")

    label = f"(c) vmap over the UNROLL solve, 2 x B={B2}, lqr_iter 5"
    res, _ = run(label, lambda: torch.func.vmap(unrolled)(w2), none, {"vmap_mapped": 1})
    for s in range(2):
        same(label, res, unrolled(w2[s]), s)
    label = f"(c) vmap(grad) through the UNROLL solve, 2 x B={B2}"
    g_u, _ = run(label, lambda: torch.func.vmap(torch.func.grad(loss_u), in_dims=(None, 0))(
        params, w2), none, {"vmap_mapped": 1, "bwd_mapped": 1})
    for s in range(2):
        if not torch.equal(g_u[s], torch.func.grad(loss_u)(params, w2[s])):
            fail(f"phase 13 {label}: candidate {s}'s gradient differs from its own")
    print(f"phase 13 (c): UNROLL solves and gradients with each candidate's bits, grad params "
          f"{g_u.tolist()}", flush=True)
    d_cfg = dataclasses.replace(cfg, lqr_iter=5)
    dus = torch.tensor([0.5, 1.0, 2.0], device=dev)

    def trust(du):
        return P.solve(d_cfg, xc, cost, dyn, params=params, delta_u=du, **box)

    label = f"(c) a delta_u sweep, 3 x B={B2}"
    res, _ = run(label, lambda: torch.func.vmap(trust)(dus),
                 {"ilqr_fused": 3, "kkt_fused": 0, "riccati_fused": 0}, {"vmap_mapped": 1})
    for s in range(3):
        same(label, res, trust(dus[s]), s)
    print(f"phase 13 {label}: each candidate's bits, mean cost by candidate "
          f"{[round(c, 4) for c in res.costs.mean(1).tolist()]}", flush=True)

    # ---- (d) the gradient fuzzer on the card ----
    t1 = time.perf_counter()
    rc, _ = drive(torch, kernels, total, "phase 13 (d) tools/fuzz_gradients, 6 cases, --vmap 2",
                  lambda: fuzz_gradients.main(["--device", "cuda", "--cases", "6", "--vmap", "2",
                                               "--seed", str(SEED)]),
                  {"ilqr_fused": None, "kkt_fused": None})
    if rc != 0:
        fail(f"phase 13 (d): tools/fuzz_gradients returned {rc}")
    print(f"phase 13 (d): 6 fuzz cases passed in {time.perf_counter() - t1:.1f} s", flush=True)

    # ---- (e) times ----
    turns = host_ms_in_turns({
        "vmap(grad) sweep": sweep,
        f"loop of {S} solo grads": lambda: [torch.func.grad(loss, argnums=(0, 1))(params, w)
                                            for w in ws]}, warm_both=False)
    print_turns(card, f"phase 13 (e) vmap(grad) {S} x B={B} against a loop of its {S} solo "
                f"gradients", turns)
    profile_step(torch, f"phase 13 (a) vmap(grad) {S} x B={B}", sweep,
                 counted=(kkt, "kkt_fused_kernel"))
    F, _ = linearize_dynamics(dyn.step, params, x_t, u_t, linearize_fn=dyn.linearize_point)
    ops = kkt.prepare(5, 1, C_t, c_t, F, x_t, u_t, modes._active_set(u_t, -100.0, 100.0))
    gx = torch.zeros_like(x_t)
    ms, runs = cuda_ms(lambda: kkt.kkt_fused(ops, gx, gu, False), 3, 10)
    plain_ms, _ = cuda_ms(lambda: kkt.kkt_fused_reference(ops, gx, gu, False), 0, 1)
    flops, by = kkt_work(ops, False)
    t_ops, t_by = flops / FP32_PEAK, by / HBM_RATE
    bound, by_what = max(t_ops, t_by) * 1e3, ("operations" if t_ops >= t_by else "bytes")
    print(f"time phase 13 kkt_fused the folded backward's Ff call B={S * B} T={T} (5,1): "
          f"{ms:.4f} ms median of {len(runs)} ({', '.join(f'{r:.4f}' for r in runs)}), the plain "
          f"version {plain_ms:.2f} ms (one run); bound {bound:.5f} ms ({by_what}: {flops:.3e} "
          f"FLOP, {by:.3e} bytes) [{card}]", flush=True)
    print(f"phase 13 launches: {total}", flush=True)
    return total, {"name": f"folded vmap(grad) backward, cartpole S={S} x B={B} (Ff call at "
                           f"B={S * B})", "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": by_what, "launches": got["kkt_fused"], "solo_launches": solo_kkt,
                   "sweep_ms": turns["vmap(grad) sweep"][0],
                   "loop_ms": turns[f"loop of {S} solo grads"][0]}


# ---- phase 14: a user's own model and a callable cost ----
# the double pendulum (k1, k2, d) and its box, as the JAX package's test
# writes it (tests/test_fused_edge_cases.py:68-92; tests/traced_models.py)
USER_PARAMS = (2.0, 1.5, 0.1)
USER_BOX = 1.5
USER_Q = (1.0, 1.0, 0.1, 0.1, 1e-3, 1e-3)
# the pendulum's callable cost's params: weights, then targets
PEND_COST_PARAMS = (0.5, 0.625, 0.75, 0.875, 0.15, -0.3, 0.06, 0.21)


def user_problem(torch, P, fused, dev):
    """Phase 14's models and cost, written as a user writes them -- plain
    PyTorch on [B, n] (the cost on one point tau [n]) -- their traces on
    ``dev``, the ones the solves find in the cache, and the build specs of
    their libraries."""
    from dilqr_tpu_torch.models import cartpole
    from dilqr_tpu_torch.models.base import Dynamics
    from dilqr_tpu_torch.ops.cuda import traced

    def clip(v):  # jnp.clip's form: the mean of both sides' derivative at a tie
        return torch.minimum(torch.maximum(v, torch.tensor(-USER_BOX)), torch.tensor(USER_BOX))

    def physics(x, u0, u1, params):
        k1, k2, d = params.unbind(-1)
        q0, q1, v0, v1 = x.unbind(-1)
        a0 = -k1 * torch.sin(q0) - d * v0 + u0 + 0.3 * u1
        a1 = -k2 * torch.sin(q1) - d * v1 + u1 - 0.2 * u0
        return torch.stack([q0 + 0.05 * v0, q1 + 0.05 * v1, v0 + 0.05 * a0, v1 + 0.05 * a1], -1)

    def step(x, u, params):
        return physics(x, clip(u[..., 0]), clip(u[..., 1]), params)

    def step_unclamped(x, u, params):
        return physics(x, u[..., 0], u[..., 1], params)

    def pendulum_cost(tau, p):
        acc = None
        for i in range(4):
            d = tau[i] - p[4 + i]
            acc = 0.5 * p[i] * d * d if acc is None else acc + 0.5 * p[i] * d * d
        return acc + 0.01 * tau[3] ** 4

    A = torch.eye(4) + 0.05 * torch.diag(torch.ones(3), 1)

    def capture_step(x, u, params):  # captures a [4, 4] matrix: refused
        return x @ A.to(x).T + 0.05 * torch.cat([u, u], -1)

    dp = Dynamics(n_state=4, n_ctrl=2, step=step, step_unclamped=step_unclamped,
                  lower=-USER_BOX, upper=USER_BOX, linesearch_decay=0.5, max_linesearch_iter=4)
    cp = cartpole.make()
    tcp = Dynamics(n_state=5, n_ctrl=1, step=cp.step, lower=cp.lower, upper=cp.upper,
                   linesearch_decay=cp.linesearch_decay,
                   max_linesearch_iter=cp.max_linesearch_iter)
    m, mc = traced.model(dp, 4, 2, 3, dev), traced.model(tcp, 5, 1, 4, dev)
    pc = traced.cost(pendulum_cost, 4, len(PEND_COST_PARAMS), device=dev)
    if m is None or mc is None or pc is None:
        fail("phase 14: a model or cost of the traced set does not trace")
    AN, AD = P.GradMethod.ANALYTIC, P.GradMethod.AUTO_DIFF
    specs = {"double pendulum ANALYTIC": fused.user_spec(m, None, False, False),
             "double pendulum AUTO_DIFF": fused.user_spec(m, None, True, False),
             "traced cartpole AUTO_DIFF": fused.user_spec(mc, None, True, False),
             "pendulum callable cost": fused.with_cost(fused.env_spec(AN, 1), pc)}
    return dict(dp=dp, tcp=tcp, m=m, mc=mc, pc=pc, cost_fn=pendulum_cost,
                capture=Dynamics(n_state=4, n_ctrl=2, step=capture_step, lower=-USER_BOX,
                                 upper=USER_BOX),
                specs=specs, methods={"ANALYTIC": AN, "AUTO_DIFF": AD})


def user_ptxas(fused, reports, user):
    """Phase 2 for the traced libraries: each instantiation's registers,
    stack and spills, printed and not gated (generated straight-line code);
    a missing instantiation (one a cluster size whose shared memory fits)
    fails."""
    for label, spec in user["specs"].items():
        seen = 0
        for name, regs, stack, st, ld in ptxas_entries(reports[spec], JVP_ENTRY, "traced"):
            print(f"ptxas {label} <NU, threads, lanes> {name}: {regs} registers, {stack} bytes "
                  f"stack, {st}/{ld} bytes spill stores/loads", flush=True)
            seen += 1
        want = (len(fused.clusters(1)) if label.startswith("pendulum")
                else len(fused.lindx_clusters(*((4, 2) if "double" in label else (5, 1)))))
        if seen != want:
            fail(f"{label}: {seen} instantiations, want {want}")


def callable_bound(fused, cfg, B, step_ops, ctr, tile_iters):
    """The least time of one solve with a callable cost: (ms, "bytes" or
    "operations", FP32 and FP64 operations, bytes). Operations, per example,
    step and iteration its tile ran: quad_at's n (n + 1) / 2 evaluations of
    the cost on nested Duals (traced.py's CostOps), the Riccati step's
    products and one line-search trial as lindx_bound counts them, the
    trial's float step (STEP_OPS) and its objective, the true cost; the
    env's hand Jacobian, the box-QP and further trials are not counted.
    Bytes: x_init and the cost params read, x, u, costs and du written."""
    T, nx, nu = cfg.T, cfg.n_state, cfg.n_ctrl
    o = ctr.ops
    per_t = o.hess_evals * o.hess_f32 + o.f32 + riccati_trial_flops(nx, nu) + step_ops.f32
    per_t64 = o.hess_evals * o.hess_f64 + o.f64 + step_ops.f64
    count = T * sum(it * min(fused.TILE, B - g * fused.TILE) for g, it in enumerate(tile_iters))
    by = 4 * B * nx + 4 * ctr.n_params + 4 * (T * B * (nx + nu) + 2 * B)
    t_ops = (per_t * count / FP32_PEAK + per_t64 * count / FP64_PEAK) * 1e3
    t_by = by / HBM_RATE * 1e3
    return (max(t_ops, t_by), "operations" if t_ops >= t_by else "bytes", per_t * count,
            per_t64 * count, by)


def user_paths(torch, P, dev, kernels, card, fused, user, gen):
    """Phase 14 (see the module docstring), B=4096, T=20, lqr_iter 20, f32.
    The kernel is held against its plain version (and the traced cartpole
    against env 0) at eps=0, where every tile runs all lqr_iter iterations
    in both: at eps=1e-4 a tile whose largest du lands within rounding of
    eps stops one iteration apart (PERF.md; ROADMAP C); x and u on
    the examples with du < 1e-4 in both. The serving paths keep eps=1e-4.
    (a) the double pendulum, box +-1.5, under ANALYTIC and AUTO_DIFF:
        MPC.solve through the entry points (one whole-solve launch, no other
        kernel), variant_case's parity against the plain version (x and u
        on the converged examples, with its witness), the same bits at
        every cluster size and the kernel's time beside the plain
        version's and the bound by jvp_bound with traced.py's counts;
        MPC.solve against backend="torch" in turns (a b a) under ANALYTIC
        (the plain loop takes seconds), the kernel's alone under AUTO_DIFF;
    (b) the traced copy of cartpole's step under AUTO_DIFF against device
        env 0's jvp library (costs at parity's bar) and against its plain
        version (parity), both kernels' times, the bound;
    (c) the pendulum with its callable cost with params: parity against
        the plain version, the same bits at every cluster size, the time
        beside callable_bound; the IFT gradient of mean(u^2) with respect
        to the cost params at B=1024 (eps=1e-4), the forward on the kernel,
        against backend="torch", within 1e-3 of the largest entry;
        a weight the cost captures as a one-element tensor, changed in
        place between two solves at B=1024: no new trace, a new u, and the
        bits of a cost made with the new weight;
    (d) a step that captures an array: MPC.solve at B=1024 takes no
        whole-solve launch, and backend="cuda" raises.
    Returns (the JSON rows of the traced model and of the callable cost,
    the launches of every kernel)."""
    import dataclasses

    from dilqr_tpu_torch.models import cartpole, pendulum
    from dilqr_tpu_torch.ops.cuda import traced

    B, T, iters = 4096, 20, 20
    total = {name: 0 for name in kernels}
    one = {"ilqr_fused": 1, "kkt_fused": 0, "riccati_fused": 0}
    dp, m = user["dp"], user["m"]
    params = torch.tensor(USER_PARAMS, device=dev)
    q = torch.tensor(USER_Q, device=dev)
    cost = (torch.diag(q), torch.zeros(6, device=dev))
    x0 = (2.0 * torch.rand(B, 4, generator=gen) - 1.0).to(dev)

    # ---- (a) the double pendulum ----
    cases, worst = [], 0.0
    for method, gm in user["methods"].items():
        label = f"phase 14 (a) double pendulum {method} B={B} T={T}"
        cfg = P.ILQRConfig(n_state=4, n_ctrl=2, T=T, lqr_iter=iters, eps=1e-4, grad_method=gm,
                           linesearch_decay=0.5, max_linesearch_iter=4, backprop=False,
                           exit_unconverged=False, detach_unconverged=False)
        if not fused.covered(cfg, dp, params, torch.float32, cost, None, None, -USER_BOX,
                             USER_BOX):
            fail(f"{label}: not covered")
        mkw = dict(u_lower=-USER_BOX, u_upper=USER_BOX, lqr_iter=iters, eps=1e-4,
                   grad_method=gm, linesearch_decay=0.5, max_linesearch_iter=4, backprop=False,
                   exit_unconverged=False)

        def solve(be, mkw=mkw):
            return P.MPC(4, 2, T, backend=be, **mkw).solve(x0, P.QuadCost(*cost), dp,
                                                            params=params)

        out, _ = drive(torch, kernels, total, f"{label} MPC.solve", lambda: solve("auto"), one)
        if not (torch.isfinite(out.costs).all() and (out.u.abs() <= USER_BOX + 1e-6).all()):
            fail(f"{label}: non-finite costs or controls outside the box")
        cmp = dataclasses.replace(cfg, eps=0.0)
        fig = variant_case(torch, fused, card, f"{label} eps=0", cmp, dp, params, x0, cost,
                           None, -USER_BOX, USER_BOX, {}, rocket=False, conv_eps=1e-4)
        its = [int(fused.ilqr_fused(cmp, dp, params, x0[g:g + fused.TILE], cost, None,
                                    -USER_BOX, USER_BOX)[4])
               for g in range(0, B, fused.TILE)]
        bound, by_what, flops, flops64, by = jvp_bound(
            fused, cmp, B, fused.ENV_TRACED, cost, -USER_BOX, USER_BOX, its,
            ops=m.ops(gm is P.GradMethod.AUTO_DIFF))
        info = fused.user_info(m, None, gm)
        print(f"bound {label}: {flops:.3e} FP32 and {flops64:.3e} FP64 operations (traced.py's "
              f"{m.ops(gm is P.GradMethod.AUTO_DIFF)}), {by} bytes -> {bound:.4f} ms "
              f"({by_what}); tile iterations {its}; G={info['cluster']}, {info['registers']} "
              f"registers, {info['local_bytes']} local bytes, V/Q/F in {info['store']}, "
              f"cudaOccupancyMaxActiveClusters {info['max_active_clusters']} [{card}]",
              flush=True)
        if method == "ANALYTIC":  # the plain loop takes seconds: for one method
            got = host_ms_in_turns({"kernel": lambda: solve("auto"),
                                    "plain loop": lambda: solve("torch")}, rounds=1,
                                   warm_both=False, b_once=True)
            (k_ms, k_runs), (t_ms, t_runs) = got["kernel"], got["plain loop"]
            print(f"time phase 14 (a) MPC.solve double pendulum {method} B={B}: {k_ms:.3f} ms "
                  f"with the whole-solve kernel, {t_ms:.3f} ms with backend='torch' (host "
                  f"clock, synchronized, in turns a b a: "
                  f"{', '.join(f'{r:.3f}' for r in k_runs)} / "
                  f"{', '.join(f'{r:.3f}' for r in t_runs)}) [{card}]", flush=True)
        else:
            k_ms, t_ms = host_ms(lambda: solve("auto"), reps=3, warmup=False), None
            print(f"time phase 14 (a) MPC.solve double pendulum {method} B={B}: {k_ms:.3f} ms "
                  f"with the whole-solve kernel (host clock, synchronized, median of 3; "
                  f"backend='torch' is timed under ANALYTIC only) [{card}]", flush=True)
        cases.append({"name": label.replace("phase 14 (a) ", ""), "ms": fig["ms"],
                      "plain_ms": fig["plain_ms"], "bound_ms": bound, "bound_by": by_what,
                      "max_abs_err": fig["max_abs_err"], "n_iter": fig["n_iter"],
                      "registers": info["registers"], "mpc_ms": k_ms, "mpc_torch_ms": t_ms})
        worst = max(worst, fig["max_abs_err"])
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) the traced copy of cartpole against env 0's jvp library ----
    tcp, cpd = user["tcp"], cartpole.make()
    cprm = cartpole.default_params(device=dev)
    cq, cpp = cartpole.get_true_obj(device=dev)
    ccost = (torch.diag(cq), cpp)
    ccfg = P.ILQRConfig(n_state=5, n_ctrl=1, T=T, lqr_iter=iters, eps=0.0,
                        grad_method=P.GradMethod.AUTO_DIFF, linesearch_decay=cpd.linesearch_decay,
                        max_linesearch_iter=cpd.max_linesearch_iter, backprop=False,
                        exit_unconverged=False, detach_unconverged=False)
    xc = cartpole_start(torch, gen, B, dev)
    label = f"phase 14 (b) traced cartpole AUTO_DIFF B={B} T={T} eps=0"
    kt, _ = drive(torch, kernels, total, label, lambda: fused.ilqr_fused(
        ccfg, tcp, cprm, xc, ccost, None, cpd.lower, cpd.upper), one)
    ke = fused.ilqr_fused(ccfg, cpd, cprm, xc, ccost, None, cpd.lower, cpd.upper)
    rel = (kt[2] - ke[2]).abs() / ke[2].abs().clamp(min=1e-6)
    n_rel = int((rel > 1e-4).sum())
    print(f"{label}: costs against env 0's jvp library rel max {rel.max().item():.2e} (past "
          f"1e-4: {n_rel}/{B}), n_iter {int(kt[4])} vs {int(ke[4])}", flush=True)
    if rel.max().item() > 1e-2 or n_rel > 0.01 * B:
        fail(f"{label}: costs disagree with env 0's past parity's bar")
    b_err, _, _ = parity(torch, fused, label, tcp, cprm, ccfg, xc, ccost, None, cpd.lower,
                         cpd.upper, converged_only=True, conv_eps=1e-4)
    b_plain = parity.plain_ms
    # at eps=0 every tile runs lqr_iter iterations
    b_bound, b_by, b_flops, b_flops64, b_bytes = jvp_bound(
        fused, ccfg, B, fused.ENV_TRACED, ccost, cpd.lower, cpd.upper, [iters] * (B // fused.TILE),
        ops=user["mc"].ops(True))
    print(f"bound {label}: {b_flops:.3e} FP32 and {b_flops64:.3e} FP64 operations (traced.py's "
          f"{user['mc'].ops(True)}), {b_bytes} bytes -> {b_bound:.4f} ms ({b_by}) [{card}]",
          flush=True)
    t_ms, _ = cuda_ms(lambda: fused.ilqr_fused(ccfg, tcp, cprm, xc, ccost, None, cpd.lower,
                                               cpd.upper), 1, 5)
    e_ms, _ = cuda_ms(lambda: fused.ilqr_fused(ccfg, cpd, cprm, xc, ccost, None, cpd.lower,
                                               cpd.upper), 1, 5)
    info = fused.user_info(user["mc"], None, P.GradMethod.AUTO_DIFF)
    print(f"time {label}: {t_ms:.3f} ms generated against {e_ms:.3f} ms hand-written (env 0's "
          f"jvp library; ratio {t_ms / e_ms:.2f}, CUDA events, median of 5; "
          f"{info['registers']} against {fused.kernel_info(0, 0, False, P.GradMethod.AUTO_DIFF)['registers']} "
          f"registers) [{card}]", flush=True)
    cases.append({"name": label.replace("phase 14 (b) ", ""), "ms": t_ms, "env0_ms": e_ms,
                  "plain_ms": b_plain, "bound_ms": b_bound, "bound_by": b_by,
                  "max_abs_err": b_err, "cost_rel_max": rel.max().item(),
                  "registers": info["registers"]})
    worst = max(worst, b_err)
    head = cases[0]
    user_row = {"name": "ilqr_fused_user", "route": "cuda",
                "source": "dilqr_tpu_torch/csrc/ilqr_user.cu",
                "replaces": "dilqr_tpu/ops/pallas/ilqr_fused.py:699",
                "launches": total["ilqr_fused"], "max_abs_err": worst, "ms": head["ms"],
                "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"], "library_ms": None, "cases": cases}
    launches_a = dict(total)

    # ---- (c) the pendulum with a callable cost ----
    pdyn, pprm = pendulum.make(), pendulum.default_params(device=dev)
    pc, cost_fn = user["pc"], user["cost_fn"]
    cp = torch.tensor(PEND_COST_PARAMS, device=dev)
    cc = fused.CallableCost(pc, cost_fn, cp)
    pcfg = P.ILQRConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=iters, eps=1e-4,
                        linesearch_decay=pdyn.linesearch_decay,
                        max_linesearch_iter=pdyn.max_linesearch_iter, backprop=False,
                        exit_unconverged=False, detach_unconverged=False)
    th = 4.0 * torch.rand(B, generator=gen) - 2.0
    xp = torch.stack([th.cos(), th.sin(), torch.zeros(B)], 1).to(dev)
    label = f"phase 14 (c) pendulum callable cost B={B} T={T}"
    if not fused.covered(pcfg, pdyn, pprm, torch.float32, None, None, None, -2.0, 2.0,
                         cost_callable=True):
        fail(f"{label}: not covered")
    out, _ = drive(torch, kernels, total, f"{label} solve", lambda: P.solve(
        pcfg, xp, (cost_fn, cp), pdyn, params=pprm, u_lower=-2.0, u_upper=2.0), one)
    if not torch.isfinite(out.costs).all():
        fail(f"{label}: non-finite costs")
    cmp = dataclasses.replace(pcfg, eps=0.0)
    err, k_out, _ = parity(torch, fused, f"{label} eps=0", pdyn, pprm, cmp, xp, cc, None, -2.0,
                           2.0, converged_only=True, conv_eps=1e-4)
    plain_ms = parity.plain_ms
    same_bits(torch, fused, label, k_out, (cmp, pdyn, pprm, xp, cc, None, -2.0, 2.0))
    ms, runs = cuda_ms(lambda: fused.ilqr_fused(cmp, pdyn, pprm, xp, cc, None, -2.0, 2.0), 1, 5)
    its = [int(fused.ilqr_fused(cmp, pdyn, pprm, xp[g:g + fused.TILE], cc, None, -2.0,
                                2.0)[4]) for g in range(0, B, fused.TILE)]
    bound, by_what, flops, flops64, by = callable_bound(fused, cmp, B, fused.STEP_OPS[1], pc, its)
    info = fused.kernel_info(1, 0, False, P.GradMethod.ANALYTIC, cost=pc)
    print(f"time {label}: {ms:.3f} ms median of {len(runs)} ({', '.join(f'{r:.3f}' for r in runs)}); "
          f"plain version {plain_ms:.1f} ms (one run, host clock); bound {flops:.3e} FP32 and "
          f"{flops64:.3e} FP64 operations (traced.py's {pc.ops}), {by} bytes -> {bound:.4f} ms "
          f"({by_what}); tile iterations {its}; G={info['cluster']}, {info['registers']} "
          f"registers, {info['local_bytes']} local bytes [{card}]", flush=True)

    xg = xp[:1024]

    def grad(backend):
        cpr = cp.clone().requires_grad_(True)
        c = dataclasses.replace(pcfg, backprop=True, backward_mode=P.BackwardMode.IFT,
                                backend=backend)
        res = P.solve(c, xg, (cost_fn, cpr), pdyn, params=pprm, u_lower=-2.0, u_upper=2.0)
        return torch.autograd.grad((res.u ** 2).mean(), cpr)[0]

    glabel = "phase 14 (c) IFT grad wrt the callable cost's params B=1024"
    g, _ = drive(torch, kernels, total, glabel, lambda: grad("auto"),
                 {"ilqr_fused": 1, "kkt_fused": None, "riccati_fused": 0})
    g_ref = grad("torch")
    gerr = (g - g_ref).abs().max().item()
    print(f"{glabel}: |grad| max {g.abs().max().item():.4e}, abs. diff to backend='torch' "
          f"{gerr:.2e} over {g.numel()} params", flush=True)
    if not torch.isfinite(g).all() or g.abs().max().item() == 0.0:
        fail(f"{glabel}: a non-finite or zero gradient")
    if gerr > 1e-3 * g_ref.abs().max().item() + 1e-8:
        fail(f"{glabel}: the gradient differs from backend='torch''s by {gerr:.3e}")
    # a one-element tensor the cost captures (a weight on the control) is
    # read at each launch: changed in place, the next solve takes the new
    # value with no new trace, bit for bit as a cost made with that value
    slabel = "phase 14 (c) a captured weight changed in place B=1024"
    w = torch.full((), 0.1, device=dev)

    def weighted(tau, p):
        return cost_fn(tau, p) + w * tau[3] * tau[3]

    def run(f):
        return P.solve(pcfg, xg, (f, cp), pdyn, params=pprm, u_lower=-2.0, u_upper=2.0)

    first, _ = drive(torch, kernels, total, slabel, lambda: run(weighted), one)
    w.fill_(2.0)
    n_traces = traced.TRACES
    second = run(weighted)
    w2 = torch.full((), 2.0, device=dev)
    fresh = run(lambda tau, p: cost_fn(tau, p) + w2 * tau[3] * tau[3])
    print(f"{slabel}: traces made for the second solve {traced.TRACES - n_traces - 1} (the "
          f"fresh cost's one apart); u moved by up to "
          f"{(second.u - first.u).abs().max().item():.3e}; the same bits as a cost made with the "
          f"new weight: {torch.equal(second.u, fresh.u) and torch.equal(second.costs, fresh.costs)}",
          flush=True)
    if traced.TRACES != n_traces + 1:
        fail(f"{slabel}: the second solve traced the cost again")
    if torch.equal(first.u, second.u):
        fail(f"{slabel}: the kernel kept the old weight")
    if not (torch.equal(second.u, fresh.u) and torch.equal(second.costs, fresh.costs)):
        fail(f"{slabel}: the changed weight and a cost made with it disagree")
    callable_row = {"name": "ilqr_fused_callable", "route": "cuda",
                    "source": "dilqr_tpu_torch/csrc/callable_cost.cuh",
                    "replaces": "dilqr_tpu/ops/pallas/ilqr_fused.py:699",
                    "launches": total["ilqr_fused"] - launches_a["ilqr_fused"],
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": by_what, "library_ms": None, "registers": info["registers"],
                    "grad_abs_diff": gerr}

    # ---- (d) the route check ----
    label = "phase 14 (d) array-capturing step MPC.solve B=1024"
    bad = user["capture"]
    mkw = dict(u_lower=-USER_BOX, u_upper=USER_BOX, lqr_iter=2, eps=1e-4, backprop=False,
               exit_unconverged=False)
    out, _ = drive(torch, kernels, total, label, lambda: P.MPC(4, 2, T, **mkw).solve(
        x0[:1024], P.QuadCost(*cost), bad, params=params), {"ilqr_fused": 0})
    if not torch.isfinite(out.costs).all():
        fail(f"{label}: non-finite costs")
    try:
        P.MPC(4, 2, T, backend="cuda", **mkw).solve(x0[:1024], P.QuadCost(*cost), bad,
                                                     params=params)
    except ValueError as e:
        print(f"{label}: backend='cuda' raises: {e}", flush=True)
    else:
        fail(f"{label}: backend='cuda' did not raise")
    print(f"phase 14 launches: {total}", flush=True)
    return [user_row, callable_row], total


def _tile_iters(fused, cfg, dyn, params, x0, cs):
    """Iterations each 1024-example tile ran: one kernel launch per tile's
    own examples (tiles are independent, so this is the same count)."""
    its = []
    for g in range(0, x0.shape[0], fused.TILE):
        its.append(int(fused.ilqr_fused(cfg, dyn, params, x0[g:g + fused.TILE], cs,
                                        None, -100.0, 100.0)[4]))
    return its


if __name__ == "__main__":
    main()

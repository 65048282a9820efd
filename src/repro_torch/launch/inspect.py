"""What a step spends, by part, on one device: the one-device half of
``src/repro/launch/hlo_inspect.py``'s job (the collective bytes by op
wait for ROADMAP Queue 1 item 14b, the mesh dry-run).

- :func:`device_profile` runs a call under ``torch.profiler`` on the card
  and returns its wall time and device events, checked whole against the
  kernels' launch counters; :func:`kernel_times` sums its device time by
  kernel (``chip_smoke.py`` reads every phase's breakdown so).
- :func:`largest_tensors` runs a call on ``meta`` tensors (no device, no
  allocation) and lists the largest tensors it creates, by op: the
  counterpart of the reference's "largest live tensors".

    PYTHONPATH=src python -m repro_torch.launch.inspect --arch qwen2-7b --shape train_4k
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from collections import Counter
from typing import Dict, List, Tuple

import torch

from .cost import CostCounter


def kernel_key(name: str) -> str:
    """A device kernel's name without its namespaces, template arguments
    and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0].split("::")[-1]


# the device kernel one launch of each counted wrapper (or route) runs,
# besides second passes such as sumsq's sum_partials
DEVICE_KERNELS = {
    "flash_attention/wgmma": ("flash_fwd_sm90",),
    "flash_attention/tf32x3": ("flash_fwd_tf32x3",),
    "flash_attention/wgmma/narrow": ("flash_fwd_sm90_narrow",),
    "flash_attention/tf32x3/narrow": ("flash_fwd_tf32x3_narrow",),
    "rmsnorm": ("rmsnorm_rows",),
    "mamba_scan": ("selective_scan",),
    "noise_sgd_step": ("noise_sgd",),
    "noise_adam_step": ("noise_adam",),
    "sumsq": ("sumsq_partials",),
    "scale_accumulate/vector": ("scale_acc",),
    # the flat call and the client grid run one kernel
    ("scale_accumulate/rows", "scale_accumulate/clients"): ("clip_acc_rows",),
    "fused_pushsum_mix": ("mix_reg", "mix_stream"),
    "fused_stale_mix": ("stale_reg", "stale_stream"),
}
ATTENTION_ROUTES = ("flash_attention/wgmma", "flash_attention/tf32x3",
                    "flash_attention/wgmma/narrow",
                    "flash_attention/tf32x3/narrow")


def device_profile(fn, sessions: int = 3):
    """Wall ms of one synchronised call of ``fn`` under torch.profiler,
    and the device events (kernels and copies) it recorded. ``fn`` runs
    twice in one profiler session: the first call is the session's
    warm-up step, whose events are dropped (on the H100, sessions without
    one lost up to three of their first device kernels once the main path
    had run), the second is recorded. The recorded step must hold a
    device kernel for every kernel launch it recorded on the host (by
    correlation id): a session that lost any (one recorded step lost 44 of
    265 on the H100 after its warm-up) is discarded, said so, and taken
    again, up to ``sessions`` in all, and the run fails if none is whole.
    A whole recording must hold as many device kernels of each counted
    wrapper as the launch counters (reset just before the recorded call,
    read just after) say it launched, or the run fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from .. import kernels

    for attempt in range(1, sessions + 1):
        recorded = {}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: recorded.update(
                         events=p.events())) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
        counts = {**kernels.launch_counts(), **kernels.route_launch_counts()}
        events = recorded["events"]
        # the device events bar the step's own span (ProfilerStep#1)
        on_device = [e for e in events if e.device_type == DeviceType.CUDA
                     and not e.name.startswith("ProfilerStep")]
        launched = {e.id for e in events if e.device_type == DeviceType.CPU
                    and "LaunchKernel" in e.name}
        lost = launched - {e.id for e in on_device}
        if on_device and not lost:
            break
        print(f"profile: session {attempt} of {sessions} recorded no device "
              f"kernel for {len(lost)} of {len(launched)} kernel launches; "
              "discarded")
    else:
        raise AssertionError(f"no whole profile in {sessions} sessions")
    seen = Counter(kernel_key(e.name) for e in on_device)
    # attention folded over a vmapped cohort counts under its own route
    # and runs the kernel of its dtype's: each kernel route's kernels lie
    # between its launches and those plus the folds', and all of
    # attention's kernels are its launches (with no fold, each route's
    # exactly)
    folded = counts.get("flash_attention/clients", 0)
    for counter, names in DEVICE_KERNELS.items():
        got = sum(seen[n] for n in names)
        want = sum(counts.get(c, 0) for c in (
            counter if isinstance(counter, tuple) else (counter,)))
        slack = folded if counter in ATTENTION_ROUTES else 0
        assert want <= got <= want + slack, (
            f"the profile recorded {got} {'/'.join(names)} kernel(s) where "
            f"{counter} launched {want}"
            + (f" and the folds {folded}" if slack else ""))
    got = sum(seen[n] for r in ATTENTION_ROUTES for n in DEVICE_KERNELS[r])
    assert got == counts.get("flash_attention", 0), (
        f"the profile recorded {got} attention kernel(s) where attention "
        f"launched {counts.get('flash_attention', 0)}")
    return wall_ms, on_device


def kernel_times(on_device) -> Dict[str, Tuple[int, float]]:
    """Device events (:func:`device_profile`'s) by kernel: {kernel key:
    (calls, device µs)}, the largest first."""
    calls, us = Counter(), Counter()
    for e in on_device:
        key = kernel_key(e.name)
        calls[key] += 1
        us[key] += e.self_device_time_total
    return {k: (calls[k], t) for k, t in us.most_common()}


def largest_tensors(fn, *args, top: int = 20, **kwargs) -> List[Dict]:
    """Run ``fn(*args, **kwargs)`` (on meta tensors: nothing is computed)
    under the cost counter and return the ``top`` largest tensors it
    created, by op: each {"op", "shape", "dtype", "bytes", "count"}
    (count: how many tensors of that op, shape and dtype the call
    created; views and in-place results create none)."""
    counter = CostCounter(memory=True)
    with counter:
        fn(*args, **kwargs)
    rows = [{"op": op, "shape": list(shape), "dtype": str(dtype),
             "bytes": math.prod(shape) * dtype.itemsize, "count": c}
            for (op, shape, dtype), c in counter.created.items()]
    rows.sort(key=lambda r: -r["bytes"])
    return rows[:top]


def main(argv=None) -> int:
    from ..configs import INPUT_SHAPES, get_config, list_archs
    from .dryrun import DRYRUN_OPTS, step_call

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list_archs(), required=True)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), required=True)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--no-remat", action="store_true")
    args = ap.parse_args(argv)
    opts = dataclasses.replace(DRYRUN_OPTS, remat=not args.no_remat)
    shape = INPUT_SHAPES[args.shape]
    call = step_call(get_config(args.arch), shape, shape.kind, opts=opts)[0]
    print(f"=== largest tensors of {args.arch} × {args.shape} (meta) ===")
    for r in largest_tensors(call, top=args.top):
        print(f"{r['bytes'] / 2**30:9.2f}GiB x{r['count']:<5d} "
              f"{r['op']:24s} {r['dtype']:15s} {r['shape']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

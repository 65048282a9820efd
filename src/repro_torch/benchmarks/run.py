"""The port's benchmark runner: one module per paper table or figure, each
printed as CSV rows (port of ``benchmarks/run.py``).

    PYTHONPATH=src python -m repro_torch.benchmarks.run            # all
    PYTHONPATH=src python -m repro_torch.benchmarks.run --full     # paper scale
    PYTHONPATH=src python -m repro_torch.benchmarks.run --only fig4_comm,fig_hier
    PYTHONPATH=src python -m repro_torch.benchmarks.run --tier fast
    PYTHONPATH=src python -m repro_torch.benchmarks.run --list
    PYTHONPATH=src python -m repro_torch.benchmarks.run --only fig_hier --device cpu

The registry lists the port's drivers only (``src/repro_torch/benchmarks``;
every ``fig_*`` file there is registered). The reference's ``fig_blocks``
and ``fig_ragged`` wait for fused round-blocks and the stacked executor
(ROADMAP.md Queue 1 item 5) and ``roofline`` for the XLA-tooling
analogues (item 14). ``REPRO_BENCH_FULL=1`` is ``--full``. The runner runs
on the card (``--device cuda``, the default) and prints its name and power
limit first.
"""
from __future__ import annotations

import argparse
import csv
import inspect
import io
import sys
import time

from .. import resolve_device
from ..launch.serve import device_label
from . import (fig3_accuracy, fig4_comm, fig5_ablations, fig6_kvasir,
               fig11_batchsize, fig_async, fig_compress, fig_dropout,
               fig_hier, fig_kernels, mia_privacy, table2_histo)
from .common import FULL

# name -> (module, paper anchor, runtime tier). ``--list`` shows each
# module's own docstring's first line. "fast" drivers finish in minutes at
# their default settings; "full" ones are accuracy sweeps.
MODULES = {
    "fig3_accuracy": (fig3_accuracy, "Fig. 3 / Fig. 9", "full"),
    "fig4_comm": (fig4_comm, "Fig. 4 / Fig. 13", "full"),
    "fig5_ablations": (fig5_ablations, "Fig. 5 a-c / Fig. 12", "full"),
    "fig6_kvasir": (fig6_kvasir, "Fig. 6", "full"),
    "table2_histo": (table2_histo, "Fig. 8 / Table 2", "full"),
    "fig11_batchsize": (fig11_batchsize, "Fig. 11", "full"),
    "fig_kernels": (fig_kernels, "beyond-paper", "fast"),
    "fig_hier": (fig_hier, "beyond-paper", "fast"),
    "fig_compress": (fig_compress, "beyond-paper", "full"),
    "fig_async": (fig_async, "beyond-paper", "full"),
    "fig_dropout": (fig_dropout, "paper §3.4", "full"),
    "mia_privacy": (mia_privacy, "beyond-paper", "full"),
}

TIERS = ("fast", "full")


def names_for_tier(tier: str) -> list:
    """Registry names whose runtime tier is ``tier``."""
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r}; expected one of {TIERS}")
    return [n for n, (_, _, t) in MODULES.items() if t == tier]


def _describe(name: str) -> str:
    mod, anchor, tier = MODULES[name]
    first = (mod.__doc__ or "").strip().splitlines()
    return (f"{name}: [{anchor}] ({tier}) "
            f"{first[0] if first else '(no docstring)'}")


def list_benchmarks() -> list:
    """Registry listing, one line per benchmark (the ``--list`` output)."""
    return [_describe(name) for name in MODULES]


def run_one(name: str, full: bool, device: str):
    """Module ``name``'s rows; ``device`` goes to drivers that take one
    (fig. 11 is accountant arithmetic)."""
    mod = MODULES[name][0]
    if "device" in inspect.signature(mod.run).parameters:
        return mod.run(full, device=device)
    return mod.run(full)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="",
                    help="comma-separated subset of benchmark names")
    ap.add_argument("--list", action="store_true",
                    help="print every registered benchmark with its "
                         "one-line description and runtime tier, and exit")
    ap.add_argument("--tier", choices=TIERS, default="",
                    help="run only benchmarks of this runtime tier")
    ap.add_argument("--full", action="store_true", help="paper-scale settings")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.list:
        for line in list_benchmarks():
            print(line)
        return 0
    names = [n.strip() for n in args.only.split(",") if n.strip()] \
        or list(MODULES)
    unknown = [n for n in names if n not in MODULES]
    if unknown:
        raise SystemExit(f"unknown benchmarks {unknown}; --list shows them")
    if args.tier:
        allowed = set(names_for_tier(args.tier))
        names = [n for n in names if n in allowed]
    print(f"[bench] on {device_label(resolve_device(args.device))}",
          flush=True)

    failures = 0
    for name in names:
        t0 = time.time()
        print(f"\n===== {name} =====", flush=True)
        try:
            rows = run_one(name, args.full or FULL, args.device)
        except Exception as e:
            print(f"BENCH FAILED {name}: {type(e).__name__}: {e}",
                  file=sys.stderr)
            failures += 1
            continue
        if not rows:
            print("(no rows)")
            continue
        keys = sorted({k for r in rows for k in r})
        buf = io.StringIO()
        w = csv.DictWriter(buf, fieldnames=keys)
        w.writeheader()
        for r in rows:
            w.writerow(r)
        print(buf.getvalue().rstrip())
        print(f"[{name}: {len(rows)} rows in {time.time()-t0:.1f}s]")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())

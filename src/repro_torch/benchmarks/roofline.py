"""Roofline report of the port's dry-run: reads the JSON rows written by
``python -m repro_torch.launch.dryrun`` and renders the roofline table (the
three terms of each arch × shape on one H100, the dominant one, the
useful share of the counted FLOPs and whether the step fits the card's
memory) — port of ``benchmarks/roofline.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.benchmarks.roofline
    PYTHONPATH=src python -m repro_torch.benchmarks.run --only roofline

``REPRO_DRYRUN_DIR`` names the directory (``results/dryrun_torch`` by
default, the dry-run's ``--out``).
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

from ..launch.mesh import H100_SXM

RESULTS_DIR = os.environ.get("REPRO_DRYRUN_DIR", "results/dryrun_torch")


def load_rows(results_dir: str = RESULTS_DIR) -> List[Dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def run(full: bool = False, results_dir: str = None) -> List[Dict]:
    """One row a dry-run JSON in ``results_dir`` (:data:`RESULTS_DIR` by
    default): its roofline terms in ms, the device memory the step needs
    (arguments + the most its own tensors hold at once − what a donated
    state takes back) and whether that fits the card's 80 GiB
    (``fits_80g``)."""
    out = []
    for r in load_rows(results_dir or RESULTS_DIR):
        if r.get("status") == "skipped":
            out.append({"arch": r["arch"], "shape": r["shape"],
                        "mesh": r["mesh"], "tag": r.get("tag", ""),
                        "status": "skipped", "reason": r.get("reason", "")})
            continue
        if r.get("status") != "ok":
            out.append({"arch": r["arch"], "shape": r["shape"],
                        "mesh": r["mesh"], "tag": r.get("tag", ""),
                        "status": "FAILED", "reason": r.get("error", "")[:80]})
            continue
        rl = r["roofline"]
        ma = r.get("memory_analysis", {})
        hbm = (ma.get("argument_size_in_bytes", 0)
               + ma.get("temp_size_in_bytes", 0)
               - ma.get("alias_size_in_bytes", 0))  # donated state in place
        out.append({
            "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
            "tag": r.get("tag", ""), "status": "ok",
            "program": r["program"],
            "compute_ms": round(rl["compute_s"] * 1e3, 2),
            "memory_ms": round(rl["memory_s"] * 1e3, 2),
            "collective_ms": round(rl["collective_s"] * 1e3, 2),
            "dominant": rl["dominant"],
            "flops": f"{r['flops_global']:.3e}",
            "bytes": f"{r['bytes_global']:.3e}",
            "argument_gib": round(r["argument_bytes_per_device"] / 2**30, 2),
            "hbm_gib_per_dev": round(hbm / 2**30, 2),
            "fits_80g": hbm < H100_SXM["hbm_bytes"],
            "model_flops": f"{r['model_flops']:.3e}",
            "useful_ratio": round(r["useful_flops_ratio"] or 0, 3),
        })
    return out


def markdown_table(rows: List[Dict]) -> str:
    """The rows as a markdown table (a tag follows its program; the
    collective term, 0 on one device, is left out), then the skipped and
    the failed pairs."""
    ok = [r for r in rows if r.get("status") == "ok"]
    hdr = ("| arch | shape | program | FLOPs | bytes | model FLOPs "
           "| useful ratio | compute ms | memory ms | dominant "
           "| argument GiB | HBM GiB | fits 80 GiB |")
    sep = "|" + "---|" * 13
    lines = [hdr, sep]
    for r in sorted(ok, key=lambda r: (r["arch"], r["shape"],
                                       r.get("program", ""), r["tag"])):
        program = r.get("program", "") + (f" × {r['tag']}" if r["tag"]
                                          else "")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {program} | {r['flops']} "
            f"| {r['bytes']} | {r['model_flops']} | {r['useful_ratio']} "
            f"| {r['compute_ms']} | {r['memory_ms']} | {r['dominant']} "
            f"| {r['argument_gib']} | {r['hbm_gib_per_dev']} "
            f"| {'yes' if r['fits_80g'] else 'NO'} |")
    skipped = [r for r in rows if r.get("status") == "skipped"]
    if skipped:
        lines.append("")
        lines.append("Skipped (the long_500k rule): "
                     + ", ".join(f"{r['arch']}×{r['shape']}" for r in skipped))
    failed = [r for r in rows if r.get("status") == "FAILED"]
    if failed:
        lines.append("")
        lines.append("FAILED: " + ", ".join(
            f"{r['arch']}×{r['shape']}: {r['reason']}" for r in failed))
    return "\n".join(lines)


if __name__ == "__main__":
    print(markdown_table(run()))

"""Dry-run of one step on one device: prove a step of every registered
architecture holds together at the reference's input shapes, and cost it,
with no allocation (port of ``src/repro/launch/dryrun.py`` for one device).

For an (architecture × input shape) this builds the step's state and
inputs as empty ``meta`` tensors (``launch.steps.train_state_shapes``,
``serve_state_shapes``, ``input_specs``: the reference's
``jax.ShapeDtypeStruct`` trees) and runs the step on them under the cost
counter of :mod:`.cost`, which charges every op by the reference's rules
(loops and backward passes counted by running them). It reports the
step's FLOPs, bytes, argument bytes, ``model_flops`` (the useful work) and
the roofline against the H100 (:data:`.mesh.H100_SXM`). JSON rows go to
``--out``, read by ``repro_torch.benchmarks.roofline``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch falcon-mamba-7b \\
        --shape long_500k --no-remat --tag noremat

Nothing runs on a device and nothing is allocated, so it runs on a CPU-only
machine. The mesh programs (``--mesh``, ``--program fl_round|round_block|
hier_block``, ``--clients-per-shard``, ``--expert-parallel``,
``--serve-2d``) and the collective term wait for ROADMAP Queue 1 item 14b.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, Optional, Union

import torch

from ..configs import INPUT_SHAPES, get_config, list_archs
from ..configs.base import DPConfig, InputShape, ModelConfig, ProxyFLConfig
from ..configs.registry import proxy_of, smoke_variant
from ..nn.modules import tree_bytes, tree_leaves, tree_size
from .cost import CostCounter
from .mesh import H100_SXM
from .steps import (StepOptions, init_serve_state, input_specs,
                    make_decode_step, make_prefill_step, make_train_step,
                    serve_state_shapes, train_state_shapes)

# Architectures with sub-quadratic context handling run long_500k; pure
# full-attention architectures skip it (the reference's long_500k rule).
LONG_CONTEXT_OK = {
    "falcon-mamba-7b",       # SSM: O(1) state
    "jamba-1.5-large-398b",  # hybrid: KV only on every 8th layer
    "gemma3-4b",             # 5:1 sliding-window
    "qwen2-7b-swa",          # beyond-paper dense->SWA override
}

PROGRAMS = ("train", "prefill", "decode")

#: the mesh label and device count of every row: one card
MESH = "one"


# ---------------------------------------------------------------------------
# roofline


def roofline(flops_dev: float, bytes_dev: float,
             coll: Optional[Dict[str, Any]] = None,
             hw=H100_SXM) -> Dict[str, Any]:
    """Three-term roofline in seconds a step on ONE device, the
    reference's formula against the H100: compute over the bf16 tensor-core
    peak, memory over the HBM bandwidth. On one device nothing crosses a
    link: the collective term is 0 with empty breakdowns (``coll`` comes
    with the mesh dry-run, item 14b)."""
    coll = coll or {"total_wire_bytes": 0.0, "wire_bytes": {},
                    "op_counts": {}}
    coll_total = coll["total_wire_bytes"]
    t_compute = flops_dev / hw["peak_flops_bf16"]
    t_memory = bytes_dev / hw["hbm_bandwidth"]
    t_collective = coll_total / hw["link_bandwidth"] if coll_total else 0.0
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    dominant = max(terms, key=terms.get)
    return {**terms, "dominant": dominant.replace("_s", ""),
            "collective_bytes_per_device": coll_total,
            "collective_breakdown": coll["wire_bytes"],
            "collective_op_counts": coll["op_counts"]}


def model_flops(cfg: ModelConfig, shape: InputShape, proxy: Optional[ModelConfig],
                fl_dp: bool = True) -> float:
    """Useful-work FLOPs for one step: 6·N_active·tokens for training (the
    ProxyFL DML step trains private AND proxy, plus each model runs one
    extra peer forward → private 6+2, proxy 6+2), 2·N_active·tokens for
    inference."""
    counts = cfg.param_counts()
    n_act = counts["active"]
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        f = 8.0 * n_act * toks  # 6 (fwd+bwd) + 2 (peer forward for proxy's KL)
        if proxy is not None:
            n_px = proxy.param_counts()["active"]
            f += 8.0 * n_px * toks
        return f
    toks = shape.global_batch * (shape.seq_len if shape.kind == "prefill" else 1)
    return 2.0 * n_act * toks


# ---------------------------------------------------------------------------
# one dry-run combination


#: dry-run defaults: the reference's DRYRUN_OPTS without its mesh-only
#: ``shard_acts`` (remat on, DP chunks of 16)
DRYRUN_OPTS = StepOptions(dp_chunk=16)


def _shape(shape: Union[str, InputShape]) -> InputShape:
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def step_call(cfg: ModelConfig, shape: InputShape, program: str, *,
              opts: StepOptions = DRYRUN_OPTS, use_pallas: bool = False,
              device="meta"):
    """One step of ``cfg`` at ``shape`` ready to run: ``(call, state,
    argument bytes, model_flops)``, ``call()`` returning the step's
    (state, metrics or logits). On ``meta`` (the default) the state and
    inputs are empty shapes; on another device the serving steps get
    random weights (seed 0) and zero caches, and their tokens are zeros
    (a train step builds on meta only). ``program`` as in :func:`run_one`;
    ``use_pallas`` runs the kernels where the model calls them (on meta
    and under the cost counter each charged its plain version)."""
    fl = ProxyFLConfig(dp=DPConfig(enabled=True), use_pallas=use_pallas)
    batch = input_specs(cfg, shape)
    if program == "train":
        if torch.device(device).type != "meta":
            raise ValueError("a train step is built on meta only")
        proxy = proxy_of(cfg)
        state = train_state_shapes(cfg, proxy, fl, opts)
        step = make_train_step(cfg, proxy, fl, opts)
        n_noise = tree_size(state["proxy"]["params"])

        def call():
            # the DP noise drawn in the step, as the reference draws it
            return step(state, batch, noise=torch.randn(n_noise,
                                                        device="meta"))
        arg_bytes = tree_bytes(batch) + tree_bytes(state)
        return call, state, arg_bytes, model_flops(cfg, shape, proxy)
    if torch.device(device).type == "meta":
        state = serve_state_shapes(cfg, shape)
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        state = init_serve_state(gen, cfg, shape)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                 for k, v in batch.items()}
    maker = make_prefill_step if program == "prefill" else make_decode_step
    step = maker(cfg, opts, use_pallas=use_pallas)
    # a decode step reads its position on the host: the last slot
    inputs = dict(batch, pos=shape.seq_len - 1) if program == "decode" \
        else batch

    def call():
        return step(state, inputs)
    arg_bytes = tree_bytes(batch) + tree_bytes(state)
    return call, state, arg_bytes, model_flops(cfg, shape, None)


def run_one(arch: str, shape_name: Union[str, InputShape], *,
            program: str = "auto", opts: StepOptions = DRYRUN_OPTS,
            tag: str = "", verbose: bool = True,
            smoke: bool = False) -> Dict[str, Any]:
    """Cost one step of ``arch`` at ``shape_name`` (a name of
    ``INPUT_SHAPES`` or an ``InputShape``) on meta tensors.

    ``program`` is ``train`` (one client's DML step with the reference's
    proxy, ``proxy_of``, and DP on; its noise drawn in the step, as the
    reference draws it from its key), ``prefill`` or ``decode`` (the
    serving steps, a decode at the last position of the cache); ``auto``
    picks by the shape's kind. The model runs its plain path, as the
    reference's model does (:func:`step_call` takes ``use_pallas``).
    ``smoke`` takes the arch's ``smoke_variant``.

    The result has the reference's keys with ``chips`` 1 and ``mesh``
    ``"one"``, except:

    - ``xla_cost_analysis_raw`` is left out (no compiler report);
    - ``lower_s`` is the seconds to build the meta state, inputs and step,
      ``compile_s`` those of the counted run;
    - ``matmul_flops_global`` is added: the matmul and convolution part of
      ``flops_global``, what the tests hold exactly to the reference;
    - ``memory_analysis`` holds what is known on meta:
      ``argument_size_in_bytes`` (the state and the batch, exact),
      ``output_size_in_bytes`` (the returned state, metrics or logits),
      ``temp_size_in_bytes`` (the most bytes the step's own tensors held
      at once, outputs included) and ``alias_size_in_bytes`` (what a
      donated state would take back: the new train state's bytes; serving
      writes its cache in place and creates no state to alias).
    """
    cfg = get_config(arch)
    if smoke:
        cfg = smoke_variant(cfg)
    shape = _shape(shape_name)
    if program == "auto":
        program = {"train": "train", "prefill": "prefill",
                   "decode": "decode"}[shape.kind]
    if program not in PROGRAMS:
        raise ValueError(f"program {program!r}: one device runs {PROGRAMS}; "
                         "the mesh programs wait for the mesh dry-run")

    if shape.name == "long_500k" and arch not in LONG_CONTEXT_OK:
        return {"arch": arch, "shape": shape.name, "mesh": MESH,
                "program": program, "status": "skipped",
                "reason": "pure full-attention architecture (long_500k "
                          "skip rule)"}

    t0 = time.time()
    call, state, arg_bytes, mf = step_call(cfg, shape, program, opts=opts)
    t_lower = time.time() - t0
    counter = CostCounter(memory=True)
    with counter:
        new_state, out = call()
    t_count = time.time() - t0 - t_lower
    created = {id(t) for t in tree_leaves(state)}
    new_bytes = sum(t.numel() * t.element_size()
                    for t in tree_leaves(new_state) if id(t) not in created)
    memory = {"argument_size_in_bytes": arg_bytes,
              "output_size_in_bytes": tree_bytes(new_state)
              + tree_bytes(out),
              "temp_size_in_bytes": counter.peak_bytes,
              "alias_size_in_bytes": new_bytes if program == "train" else 0}
    flops, nbytes = counter.flops, counter.bytes
    rl = roofline(flops, nbytes)
    counts = cfg.param_counts()
    result = {
        "arch": arch, "shape": shape.name, "mesh": MESH,
        "program": program, "tag": tag, "status": "ok",
        "chips": 1, "sharding_modes": None,
        "lower_s": round(t_lower, 1), "compile_s": round(t_count, 1),
        "flops_global": flops,
        "bytes_global": nbytes,
        "matmul_flops_global": counter.matmul_flops,
        "flops_per_device": flops,
        "bytes_per_device": nbytes,
        "argument_bytes_per_device": arg_bytes,
        "memory_analysis": memory,
        "roofline": rl,
        "model_flops": mf,
        "useful_flops_ratio": (mf / flops) if flops else None,
        "params_total": counts["total"],
        "params_active": counts["active"],
        "opts": {k: getattr(opts, k) for k in
                 ("remat", "accum", "dp_chunk", "kv_chunk", "mamba_chunk",
                  "moment_dtype")},
    }
    if verbose:
        print(f"[dryrun] {arch} × {shape.name} × {MESH} × {program}"
              f"{' × ' + tag if tag else ''}")
        print(f"  build {t_lower:.1f}s  count {t_count:.1f}s  chips 1")
        print(f"  memory_analysis: {memory}")
        print(f"  cost: flops/dev {flops:.3e}  bytes/dev {nbytes:.3e}  "
              f"matmul flops {counter.matmul_flops:.3e}")
        print(f"  roofline: compute {rl['compute_s'] * 1e3:.2f}ms  memory "
              f"{rl['memory_s'] * 1e3:.2f}ms  collective "
              f"{rl['collective_s'] * 1e3:.2f}ms  → {rl['dominant']}-bound")
        print(f"  MODEL_FLOPS {mf:.3e}  useful/counted "
              f"{result['useful_flops_ratio']:.3f}")
    return result


# ---------------------------------------------------------------------------
# CLI


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="every (arch × shape)")
    ap.add_argument("--out", default="results/dryrun_torch",
                    help="JSON output dir")
    ap.add_argument("--tag", default="", help="perf-iteration tag")
    # StepOptions overrides (the §Perf levers)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--accum", type=int)
    ap.add_argument("--dp-chunk", type=int)
    ap.add_argument("--kv-chunk", type=int)
    ap.add_argument("--mamba-chunk", type=int)
    ap.add_argument("--moment-dtype")
    args = ap.parse_args(argv)

    kw = {}
    if args.no_remat:
        kw["remat"] = False
    for name in ("accum", "dp_chunk", "kv_chunk", "mamba_chunk",
                 "moment_dtype"):
        v = getattr(args, name)
        if v is not None:
            kw[name] = v
    opts = dataclasses.replace(DRYRUN_OPTS, **kw)

    if args.all:
        combos = [(a, s) for a in list_archs() for s in sorted(INPUT_SHAPES)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        combos = [(args.arch, args.shape)]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    t0 = time.time()
    for a, s in combos:
        try:
            res = run_one(a, s, opts=opts, tag=args.tag)
        except Exception as e:  # a dry-run failure is a bug in the system
            failures += 1
            res = {"arch": a, "shape": s, "mesh": MESH, "status": "FAILED",
                   "error": f"{type(e).__name__}: {e}"}
            print(f"[dryrun] FAILED {a} × {s}: {e}", file=sys.stderr)
        program = res.get("program", INPUT_SHAPES[s].kind)
        fname = f"{a}__{s}__{MESH}__{program}"
        if args.tag:
            fname += f"__{args.tag}"
        with open(os.path.join(args.out, fname + ".json"), "w") as f:
            json.dump(res, f, indent=1)
    print(f"[dryrun] {len(combos)} combinations, {failures} failed, "
          f"{time.time() - t0:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Ranks of a ``torch.distributed`` gloo group for the port's ``shard_map``
tests, and the scenarios they run.

The module imports torch, numpy and ``repro_torch`` only, so a rank that
``torch.multiprocessing`` spawns never loads JAX. A test module writes a
job (a list of scenarios) with :func:`write_job`, starts the ranks with
:func:`spawn` (one process a rank, a ``file://`` store under the test's
temporary directory, no TCP port), does its own work meanwhile, and joins
them; every rank runs every scenario on ``backend="shard_map"`` and writes
what it saw to ``<out>/<name>.r<rank>.pt``. :func:`run_scenario` runs a
scenario on any backend, so the test process runs the same scenario on
``"vmap"`` to compare.

A scenario is a dict:

* ``name``; ``cfg`` (``ProxyFLConfig`` keywords, ``dp`` as a dict of
  ``DPConfig`` keywords); ``mix``; ``model`` (``(name, shape,
  n_classes)`` of a vision model for both roles); ``data`` (per-client
  ``(x, y)`` numpy pairs); ``seed``;
* ``plan``: the round-blocks ``(t0, T)`` run one after another with
  :meth:`FederationEngine.run_rounds`;
* optional: ``draws`` (``{(k, t, s): (idx, noise)}``, the replay hook's
  table), ``init`` (the K per-client initial states, port tensors),
  ``accountant`` (``(sigma, q, delta)``, one accountant a client),
  ``save`` (``(dir, i)``: a :class:`FederationCheckpointer` snapshot after
  block i), ``restore`` (a checkpoint directory to resume from before the
  plan).

A scenario of ``kind="gossip"`` runs :func:`gossip_cases` instead.

A rank's result: ``metrics`` (each block's ``[T, K]`` dict), ``eps`` and
``steps`` of the K accountants, ``states`` (the K exported client states,
on rank 0 only), ``restored`` (the K states right after the restore) and
``done`` (the restored round count).
"""
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.checkpoint import FederationCheckpointer
from repro_torch.configs import DPConfig, ProxyFLConfig
from repro_torch.core.accountant import PrivacyAccountant
from repro_torch.core.engine import dml_engine
from repro_torch.core.protocol import ModelSpec
from repro_torch.nn.vision import get_vision_model

AXIS = "clients"


def init_ranks(rank: int, world: int, store: str, axis: str = AXIS):
    """One torch thread, the gloo group over a file store, and a 1-D CPU
    device mesh whose dim is ``axis``."""
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    return init_device_mesh("cpu", (world,), mesh_dim_names=(axis,))


def _spec(name, shape, n_classes):
    vm = get_vision_model(name)
    return ModelSpec(name, lambda g: vm.init(g, tuple(shape), n_classes),
                     vm.apply)


def engine_of(scn, backend: str, mesh=None):
    cfg = dict(scn["cfg"])
    cfg["dp"] = DPConfig(**cfg.get("dp", {}))
    cfg = ProxyFLConfig(**cfg)
    spec = _spec(*scn["model"])
    table = scn.get("draws")
    draws = None if table is None else (lambda k, t, s: table[(k, t, s)])
    K = len(scn["data"])
    eng = dml_engine((spec,) * K, spec, cfg, backend=backend,
                     mix=scn["mix"], device="cpu", draws=draws, mesh=mesh)
    if scn.get("accountant"):
        eng.attach_accountants([PrivacyAccountant(*scn["accountant"])
                                for _ in range(K)])
    return eng


def run_scenario(scn, backend: str, mesh=None):
    """Scenario ``scn`` on ``backend`` (module docstring)."""
    eng = engine_of(scn, backend, mesh)
    seed = scn["seed"]
    data = [(torch.as_tensor(x), torch.as_tensor(y)) for x, y in scn["data"]]
    out = {}
    if scn.get("init") is not None:
        init = scn["init"]
        state = ([init[eng.rank]] if eng.backend == "shard_map"
                 else list(init))
    else:
        state = eng.init_states(seed)
    if scn.get("restore"):
        state, out["done"] = FederationCheckpointer(
            scn["restore"], verify=True).restore_latest(
                eng, like=eng.init_states(seed), seed=seed)
        out["restored"] = eng.export_states(state)
    out["metrics"] = []
    for i, (t0, T) in enumerate(scn["plan"]):
        state, m = eng.run_rounds(state, data, t0, T, seed)
        out["metrics"].append(m)
        if scn.get("save") and scn["save"][1] == i:
            FederationCheckpointer(scn["save"][0]).save(eng, state,
                                                        t0 + T - 1, seed=seed)
    out["states"] = eng.export_states(state)
    out["eps"] = [a.epsilon() for a in eng.accountants if a is not None]
    out["steps"] = [a.steps for a in eng.accountants if a is not None]
    return out


def gossip_cases(scn, rank: int, group):
    """``pushsum_gossip_shard`` of rank ``rank``'s rows of ``scn["theta"]``
    [K, D] and ``scn["w"]`` [K] for each ``(t, topology, self_weight,
    active)`` of ``scn["cases"]``: the rank's mixed ``([1, D], [1])``."""
    from repro_torch.core.gossip import pushsum_gossip_shard
    K = len(scn["w"])
    theta = torch.as_tensor(scn["theta"][rank:rank + 1])
    w = torch.as_tensor(scn["w"][rank:rank + 1])
    return [pushsum_gossip_shard(theta, w, t, group, K, topo, sw, act)
            for t, topo, sw, act in scn["cases"]]


def _rank_main(rank, world, store, job_path, out_dir):
    mesh = init_ranks(rank, world, store)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    try:
        for scn in job:
            if scn.get("kind") == "gossip":
                res = gossip_cases(scn, rank, mesh.get_group(AXIS))
            else:
                res = run_scenario(scn, "shard_map", mesh)
            if rank and isinstance(res, dict):
                res.pop("states")
                res.pop("restored", None)
            torch.save(res, os.path.join(out_dir, f"{scn['name']}.r{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _mesh_rank_main(rank, world, store, job_path, out_dir):
    """Pod ``rank`` of the mesh steps' job (``tests/test_torch_mesh_steps.
    py``): ``make_fl_round_step`` on its client, ``make_round_block_step``
    and the same rounds one by one, and ``make_hier_round_block_step`` on
    its shard of ``clients_per_pod`` clients."""
    from repro_torch.configs import get_config, proxy_of, smoke_variant
    from repro_torch.core.engine import stack_states
    from repro_torch.launch import steps

    mesh = init_ranks(rank, world, store, axis=steps.POD)
    try:
        job = torch.load(job_path, weights_only=False)
        cfg = smoke_variant(get_config(job["arch"])).with_(dtype=job["dtype"])
        proxy = smoke_variant(proxy_of(cfg))
        fl = ProxyFLConfig(dp=DPConfig(enabled=True), batch_size=job["batch"],
                           use_pallas=True)
        opts = steps.StepOptions(**job["opts"])
        T, t0, L = job["n_rounds"], job["t0"], job["clients_per_pod"]
        state, batch = job["states"][rank], job["batches"][rank]
        out = {"fl": steps.make_fl_round_step(
            cfg, proxy, fl, mesh, world, opts, round_t=t0)(
                state, batch, noise=job["noise_fl"][rank])}
        noises = job["noise_block"][rank]
        out["block"] = steps.make_round_block_step(
            cfg, proxy, fl, mesh, world, opts, n_rounds=T, t0=t0)(
                state, batch, noises=noises)
        rows = []
        for i in range(T):
            state, m = steps.make_fl_round_step(
                cfg, proxy, fl, mesh, world, opts, round_t=t0 + i)(
                    state, batch, noise=noises[i])
            rows.append(m)
        out["rounds"] = (state, rows)
        mine = range(rank * L, (rank + 1) * L)
        out["hier"] = steps.make_hier_round_block_step(
            cfg, proxy, fl, mesh, world, L, opts, n_rounds=T, t0=t0)(
                stack_states([job["states"][k] for k in mine]),
                stack_states([job["batches"][k] for k in mine]),
                torch.stack([job["noise_block"][k] for k in mine], dim=1))
        torch.save(out, os.path.join(out_dir, f"mesh.r{rank}.pt"))
    finally:
        dist.destroy_process_group()


def write_job(job, tmp) -> str:
    path = os.path.join(str(tmp), "job.pkl")
    with open(path, "wb") as f:
        pickle.dump(job, f)
    return path


def spawn(world: int, job_path: str, tmp, fn=_rank_main):
    """Start ``world`` ranks running ``fn(rank, world, store, job_path,
    out_dir)``; returns ``(context, out_dir)``. Join with :func:`join`."""
    out_dir = os.path.join(str(tmp), "out")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(str(tmp), "store")
    ctx = mp.start_processes(fn, args=(world, store, job_path, out_dir),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, out_dir


def join(ctx) -> None:
    """Wait for every rank; a rank's exception is raised here."""
    while not ctx.join():
        pass


def results(out_dir: str, name: str, world: int):
    return [torch.load(os.path.join(out_dir, f"{name}.r{r}.pt"),
                       weights_only=False) for r in range(world)]

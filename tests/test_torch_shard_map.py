"""The ``shard_map`` backend on ``torch.distributed``: one client per rank of
a gloo group, the PushSum exchange as send/recv.

Four gloo ranks (``tests/torch_shard_ranks.py``: spawned processes, a
``file://`` store, one torch thread each) run every scenario below once for
the module, while this process runs the same scenarios on the port's vmap
backend and the JAX package's ``shard_map`` runs at K = 4 in one
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(``tests/jax_shard_reference.py``; this process sees one device). mlp on
14x14x1, 10 classes, B = 8, one local step, DP on, two rounds then a
block of three.

* ``pushsum_gossip_shard`` on the four ranks against P(t) from
  ``adjacency_matrix`` applied to the stacked rows, over rounds, the three
  topologies and memberships: the sparse mixes bit for bit, dense mixing
  at ``close``.
* Against the port's vmap backend, bit for bit: the pushsum and ring
  mixes, a dropout seed (per-round path; a dropped rank skips its local
  phase), a ragged cohort in epoch mode (each rank its own step count)
  and the kernels on (their plain versions here). Each mixed coordinate
  is two exact halvings and one rounded sum in both executors, and a
  rank's local phase is the vmap executor's on a cohort of one. The mean
  mix (a sum over the ranks, then ÷A, against 1/A weights in a matmul) at
  the conformance ``close`` grade (atol 1e-5, rtol 1e-4). Every rank
  returns the cohort's [T, K] metrics and steps all K accountants.
* Against the JAX package's ``shard_map`` at K = 4 with §3.4 dropout, from
  its initial states with warm Adam moments (:func:`_warm`) and on its
  draws: params, moments and w at ``close``, metrics' NaN pattern and
  values, epsilon exactly.
* Snapshots: ``shard_map``'s (written by rank 0, every rank calling) equal
  vmap's file by file (npz arrays, manifest, audit trail and LATEST bytes,
  meta but its time), and restore into the JAX engine bit for bit; a JAX
  snapshot restores into ``shard_map`` bit for bit, and the run continues
  bit-equal to vmap's.
* K = 1 in this process (a one-rank gloo group): equal to vmap bit for
  bit, and to the JAX package's ``shard_map`` on a 1-device mesh at
  ``close`` (``tests/test_conformance.py::test_shard_map_k1_matches_vmap_
  bitwise``'s set-up), and the refusals: a compressed exchange (its
  message names shard_map, as in ``tests/test_compress.py``), a
  heterogeneous cohort, step functions that cannot be vmapped.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_shard_ranks as ranks  # noqa: E402
from repro.checkpoint import FederationCheckpointer as JaxCheckpointer  # noqa: E402
from repro.configs.base import DPConfig as JaxDPConfig  # noqa: E402
from repro.configs.base import ProxyFLConfig as JaxProxyFLConfig  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core.dp import _flat_gaussian_like  # noqa: E402
from repro.core.protocol import ModelSpec as JaxModelSpec  # noqa: E402
from repro.nn.vision import get_vision_model as jax_vision  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import DPConfig, ProxyFLConfig  # noqa: E402
from repro_torch.core import engine, gossip  # noqa: E402
from repro_torch.core.protocol import ModelSpec  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402
from repro_torch.nn.vision import get_vision_model  # noqa: E402
from test_torch_checkpoint import (_assert_npz_equal,  # noqa: E402
                                   _assert_state_equals_numpy)

HERE = Path(__file__).resolve().parent
K, SHAPE, N_CLASSES, B, N = 4, (14, 14, 1), 10, 8, 48
SEED = 0
CLOSE = dict(atol=1e-5, rtol=1e-4)
PLAN = [(0, 1), (1, 1), (2, 3)]
ACCOUNTANT = (1.0, B / N, 1e-5)
BIT_EQUAL = ["pushsum", "ring", "dropout", "ragged", "kernels"]


def _data(lengths=(N,) * K, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((n,) + SHAPE, dtype=np.float32),
             rng.integers(0, N_CLASSES, n)) for n in lengths]


def _scenario(name, mix="pushsum", plan=PLAN, data=None, **knobs):
    cfg = dict(n_clients=K, batch_size=B, local_steps=1, seed=SEED,
               dp=dict(enabled=True))
    cfg.update(knobs)
    return dict(name=name, cfg=cfg, mix=mix, model=("mlp", SHAPE, N_CLASSES),
                data=data or _data(), seed=SEED, plan=plan,
                accountant=ACCOUNTANT)


def _gossip_job():
    rng = np.random.default_rng(5)
    cases = []
    for t in range(4):
        for topo, sw in (("exponential", 0.5), ("ring", 0.0),
                         ("ring", 0.5), ("full", 0.5)):
            for act in (None, rng.random(K) >= 0.4,
                        np.array([True, False, True, False])):
                cases.append((t, topo, sw, None if act is None
                              else [bool(a) for a in act]))
    return dict(name="gossip", kind="gossip", cases=cases,
                theta=rng.standard_normal((K, 37)).astype(np.float32),
                w=rng.uniform(0.5, 1.5, K).astype(np.float32))


def _jax_knobs(scn):
    return {k: v for k, v in scn["cfg"].items() if k != "dp"}


def _jax_spec():
    jv = jax_vision("mlp")
    return JaxModelSpec("mlp", lambda k: jv.init(k, SHAPE, N_CLASSES),
                        jv.apply)


def _jax_engine(scn):
    cfg = JaxProxyFLConfig(dp=JaxDPConfig(enabled=True), **_jax_knobs(scn))
    return jax_engine.dml_engine((_jax_spec(),) * K, _jax_spec(), cfg,
                                 backend="vmap", mix=scn["mix"])


def _jax_draws(scn, theta_like):
    """The reference's batch indices and DP noise of every (k, t, s) the
    plan runs (``tests/test_torch_hier.py``'s replay), as a table."""
    base = jax.random.PRNGKey(scn["seed"])
    table = {}
    for t0, T in scn["plan"]:
        for t in range(t0, t0 + T):
            for k in range(K):
                ck = jax.random.fold_in(jax_engine.round_key(base, t), k)
                ck, kb, kn = jax.random.split(ck, 3)
                idx = jax.random.randint(kb, (B,), 0, N)
                table[(k, t, 0)] = (
                    np.asarray(idx),
                    np.asarray(_flat_gaussian_like(theta_like, kn)))
    return table


def _warm(state, k):
    """``state`` with warm Adam moments (m ~ N(0, 1e-3²), v ~ 1e-6·(1 +
    |N(0, 1)|), t = 5; ``tests/test_torch_train_step.py``): from zero
    moments Adam's first step is lr·g/(|g| + ε), which turns a last-bit
    difference in a gradient coordinate near ε into a step past ``close``
    (1 of the 39,200 first-layer private coordinates at this set-up)."""
    rng = np.random.default_rng(100 + k)
    out = dict(state)
    for role in ("private", "proxy"):
        opt = state[role]["opt"]
        m = jax.tree_util.tree_map(lambda x: (1e-3 * rng.standard_normal(
            x.shape)).astype(np.float32), opt.m)
        v = jax.tree_util.tree_map(lambda x: (1e-6 * (1 + np.abs(
            rng.standard_normal(x.shape)))).astype(np.float32), opt.v)
        out[role] = dict(state[role], opt=opt._replace(
            m=m, v=v, t=np.asarray(5, np.int32)))
    return out


def _port_states(jstate_list):
    return [convert.state_from_numpy(s) for s in jstate_list]


def _export(eng, state):
    return [jax.tree_util.tree_map(np.asarray, s)
            for s in eng.export_states(state)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard")
    # the reference at K = 4, in its own process with four host devices
    ref_scn = _scenario("reference", plan=[(0, 1), (1, 3)],
                        dropout_rate=0.25)
    jeng = _jax_engine(ref_scn)
    base = jax.random.PRNGKey(SEED)
    jinit = _export(jeng, jeng.init_states(base))
    warm = [_warm(s, k) for k, s in enumerate(jinit)]
    ref_job = dict(knobs=_jax_knobs(ref_scn), shape=SHAPE,
                   n_classes=N_CLASSES, data=ref_scn["data"], seed=SEED,
                   plan=ref_scn["plan"], accountant=ACCOUNTANT, init=warm)
    with open(tmp / "ref_job.pkl", "wb") as f:
        pickle.dump(ref_job, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(HERE.parent / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    ref = subprocess.Popen(
        [sys.executable, str(HERE / "jax_shard_reference.py"),
         str(tmp / "ref_job.pkl"), str(tmp / "ref_out.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ref_scn.update(draws=_jax_draws(ref_scn, jinit[0]["proxy"]["params"]),
                   init=_port_states(warm))

    # a JAX snapshot of the initial states, as if after round 1
    snap = _scenario("snapshot", plan=[(0, 2), (2, 1)])
    jdir = str(tmp / "jax_ckpt")
    JaxCheckpointer(jdir).save(_jax_engine(snap), jeng.init_states(base), 0,
                               base_key=base)
    job = [_gossip_job(),
           _scenario("pushsum"), _scenario("ring", mix="ring"),
           _scenario("dropout", dropout_rate=0.25),
           _scenario("ragged", local_steps=0,
                     data=_data((48, 32, 24, 40), seed=2)),
           _scenario("kernels", use_pallas=True),
           _scenario("mean", mix="mean"),
           dict(snap, save=(str(tmp / "shard_ckpt"), 0)),
           dict(_scenario("restore", plan=[(1, 2)]), restore=jdir),
           ref_scn]
    ctx, out = ranks.spawn(K, ranks.write_job(job, tmp), tmp)
    vmap = {}
    for scn in job[1:-1]:
        if scn["name"] == "snapshot":
            scn = dict(scn, save=(str(tmp / "vmap_ckpt"), 0))
        vmap[scn["name"]] = ranks.run_scenario(scn, "vmap")
    ranks.join(ctx)
    log, _ = ref.communicate(timeout=600)
    assert ref.returncode == 0, log
    with open(tmp / "ref_out.pkl", "rb") as f:
        want = pickle.load(f)
    shard = {scn["name"]: ranks.results(out, scn["name"], K) for scn in job}
    return dict(shard=shard, vmap=vmap, want=want, jinit=jinit, jdir=jdir,
                tmp=tmp, job={scn["name"]: scn for scn in job})


# ---------------------------------------------------------------------------
# the exchange


def test_gossip_matches_the_mix_matrix(runs):
    scn = runs["job"]["gossip"]
    theta, w = scn["theta"], scn["w"]
    got = runs["shard"]["gossip"]
    for i, (t, topo, sw, act) in enumerate(scn["cases"]):
        P = gossip.adjacency_matrix(t, K, topo, sw, act).astype(np.float32)
        want_t, want_w = P @ theta, P @ w
        mixed = np.concatenate([got[r][i][0].numpy() for r in range(K)])
        w2 = np.concatenate([got[r][i][1].numpy() for r in range(K)])
        if topo == "full":
            np.testing.assert_allclose(mixed, want_t, **CLOSE)
            np.testing.assert_allclose(w2, want_w, **CLOSE)
        else:
            np.testing.assert_array_equal(mixed, want_t, err_msg=str(i))
            np.testing.assert_array_equal(w2, want_w, err_msg=str(i))


# ---------------------------------------------------------------------------
# against the port's vmap backend


def _assert_states_equal(ours, theirs):
    a = [x for s in ours for x in tree_leaves(s)]
    b = [x for s in theirs for x in tree_leaves(s)]
    assert len(a) == len(b) == 39 * K
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _assert_metrics(ours, theirs, **tol):
    assert len(ours) == len(theirs)
    for m, n in zip(ours, theirs):
        assert sorted(m) == sorted(n)
        for key in n:
            assert m[key].shape == n[key].shape
            if tol:
                np.testing.assert_allclose(m[key], n[key], **tol)
            else:
                np.testing.assert_array_equal(m[key], n[key])


@pytest.mark.parametrize("name", BIT_EQUAL)
def test_bit_equal_to_vmap(runs, name):
    shard, vmap = runs["shard"][name], runs["vmap"][name]
    _assert_states_equal(shard[0]["states"], vmap["states"])
    _assert_metrics(shard[0]["metrics"], vmap["metrics"])
    assert shard[0]["eps"] == vmap["eps"]
    assert shard[0]["steps"] == vmap["steps"]


@pytest.mark.parametrize("name", BIT_EQUAL + ["mean"])
def test_every_rank_returns_the_cohorts_metrics(runs, name):
    shard = runs["shard"][name]
    for r in range(1, K):
        _assert_metrics(shard[r]["metrics"], shard[0]["metrics"])
        assert shard[r]["eps"] == shard[0]["eps"]
    for m in shard[0]["metrics"]:
        assert all(v.shape[1] == K for v in m.values())


def test_dropout_drops_clients_and_ragged_steps_differ(runs):
    cfg = ProxyFLConfig(**dict(runs["job"]["dropout"]["cfg"],
                               dp=DPConfig(enabled=True)))
    masks = [engine.active_mask(t, K, cfg) for t0, T in PLAN
             for t in range(t0, t0 + T)]
    assert any(not m.all() for m in masks)
    m = np.concatenate([b["proxy_loss"]
                        for b in runs["shard"]["dropout"][0]["metrics"]])
    np.testing.assert_array_equal(np.isnan(m), ~np.stack(masks))
    steps = runs["shard"]["ragged"][0]["steps"]
    assert len(set(steps)) == K


def test_mean_mix_close_to_vmap(runs):
    shard, vmap = runs["shard"]["mean"][0], runs["vmap"]["mean"]
    a = [x for s in shard["states"] for x in tree_leaves(s)]
    b = [x for s in vmap["states"] for x in tree_leaves(s)]
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **CLOSE)
    _assert_metrics(shard["metrics"], vmap["metrics"], **CLOSE)
    assert shard["eps"] == vmap["eps"]


# ---------------------------------------------------------------------------
# against the JAX package's shard_map at K = 4


@pytest.mark.parametrize("role", ["private", "proxy"])
def test_reference_k4_params_and_moments_close(runs, role):
    ours = runs["shard"]["reference"][0]["states"]
    for o, t in zip(ours, runs["want"]["states"]):
        for a_tree, b_tree in ((o[role]["params"], t[role]["params"]),
                               (o[role]["opt"].m, t[role]["opt"].m),
                               (o[role]["opt"].v, t[role]["opt"].v)):
            for a, b in zip(tree_leaves(a_tree),
                            jax.tree_util.tree_leaves(b_tree)):
                np.testing.assert_allclose(a.numpy(), b, **CLOSE)
        assert int(o[role]["opt"].t) == int(t[role]["opt"].t)


def test_reference_k4_weights_metrics_and_epsilon(runs):
    ours, want = runs["shard"]["reference"][0], runs["want"]
    np.testing.assert_allclose([float(s["w"]) for s in ours["states"]],
                               [float(s["w"]) for s in want["states"]],
                               **CLOSE)
    assert len(ours["metrics"]) == len(want["metrics"])
    for m, n in zip(ours["metrics"], want["metrics"]):
        for key in n:
            np.testing.assert_array_equal(np.isnan(m[key]), np.isnan(n[key]))
            np.testing.assert_allclose(m[key], n[key], **CLOSE)
    assert any(np.isnan(m["proxy_loss"]).any() for m in want["metrics"])
    assert ours["eps"] == want["eps"]


# ---------------------------------------------------------------------------
# snapshots


def test_snapshot_equals_vmaps_file_by_file(runs):
    sdir, vdir = str(runs["tmp"] / "shard_ckpt"), str(runs["tmp"] / "vmap_ckpt")
    base = "round_000002"
    _assert_npz_equal(os.path.join(sdir, base + ".npz"),
                      os.path.join(vdir, base + ".npz"))
    for name in (base + ".json", "audit.jsonl", "LATEST"):
        with open(os.path.join(sdir, name), "rb") as f, \
                open(os.path.join(vdir, name), "rb") as g:
            assert f.read() == g.read(), name
    with open(os.path.join(sdir, "audit.jsonl")) as f:
        assert len(f.read().splitlines()) == 1     # written once, not K times
    with open(os.path.join(sdir, base + ".meta.json")) as f, \
            open(os.path.join(vdir, base + ".meta.json")) as g:
        sm, vm = json.load(f), json.load(g)
    for m in (sm, vm):
        m.pop("saved_unix_time")
    assert sm.pop("backend") == "shard_map" and vm.pop("backend") == "vmap"
    assert sm == vm


def test_shard_map_snapshot_restores_into_jax(runs):
    scn = runs["job"]["snapshot"]
    jeng = _jax_engine(scn)
    base = jax.random.PRNGKey(SEED)
    state, done = JaxCheckpointer(str(runs["tmp"] / "shard_ckpt"),
                                  verify=True).restore_latest(
        jeng, like=jeng.init_states(base), base_key=base)
    assert done == 2
    # the snapshot holds the state after block 0: vmap's run to there
    vm = ranks.engine_of(dict(scn, plan=[(0, 2)]), "vmap")
    data = [(torch.as_tensor(x), torch.as_tensor(y)) for x, y in scn["data"]]
    after, _ = vm.run_rounds(vm.init_states(SEED), data, 0, 2, SEED)
    for ours, theirs in zip(after, _export(jeng, state)):
        _assert_state_equals_numpy(ours, theirs)


def test_jax_snapshot_restores_into_shard_map(runs):
    got = runs["shard"]["restore"][0]
    assert got["done"] == 1
    for ours, theirs in zip(got["restored"], runs["jinit"]):
        _assert_state_equals_numpy(ours, theirs)
    _assert_states_equal(got["states"], runs["vmap"]["restore"]["states"])
    assert got["steps"] == runs["vmap"]["restore"]["steps"]


# ---------------------------------------------------------------------------
# K = 1 in this process, and the refusals


@pytest.fixture(scope="module")
def one_rank_mesh(tmp_path_factory):
    store = str(tmp_path_factory.mktemp("one_rank") / "store")
    mesh = ranks.init_ranks(0, 1, store)
    yield mesh
    dist.destroy_process_group()


def _one_client():
    vm = get_vision_model("mlp")
    spec = ModelSpec("mlp", lambda g: vm.init(g, SHAPE, N_CLASSES), vm.apply)
    cfg = ProxyFLConfig(n_clients=1, rounds=3, batch_size=16, local_steps=2,
                        dp=DPConfig(enabled=False))
    return spec, cfg, _data((48,))[:1]


def test_k1_equals_vmap_and_the_reference(one_rank_mesh):
    """One client on a one-rank gloo group: no exchange, the local phase
    equal to vmap's bit for bit, and to the JAX package's ``shard_map`` on
    a 1-device mesh at ``close`` on its batch draws (DP off)."""
    spec, cfg, data_np = _one_client()
    data = [(torch.as_tensor(x), torch.as_tensor(y)) for x, y in data_np]
    jcfg = JaxProxyFLConfig(n_clients=1, rounds=3, batch_size=16,
                            local_steps=2, dp=JaxDPConfig(enabled=False))
    like = jax_engine.single_model_engine(_jax_spec(), jcfg, False,
                                          mix="pushsum", backend="vmap",
                                          n_clients=1)
    jeng = jax_engine.FederationEngine(
        jcfg, n_clients=1, step_fns=like.step_fns[0],
        init_fns=like.init_fns[0], sample_fn=like.sample_fn,
        backend="shard_map", mix="pushsum",
        mesh=jax.make_mesh((1,), ("clients",)), axis="clients")
    key = jax.random.PRNGKey(SEED)
    jstate = jeng.init_states(key)
    jinit = _export(jeng, jstate)
    jstate, _ = jeng.run_rounds(jstate, [tuple(map(jnp.asarray, d))
                                         for d in data_np], 0, 3, key)

    def draws(k, t, s):
        ck = jax.random.fold_in(jax_engine.round_key(key, t), k)
        for _ in range(s + 1):
            ck, kb, _ = jax.random.split(ck, 3)
        return np.asarray(jax.random.randint(kb, (16,), 0, 48)), None

    finals = {}
    for backend in ("shard_map", "vmap"):
        eng = engine.single_model_engine(
            spec, cfg, False, mix="pushsum", backend=backend, n_clients=1,
            device="cpu", draws=draws, mesh=one_rank_mesh)
        assert eng.stacked and not eng.mixing
        state, m = eng.run_rounds(_port_states(jinit), data, 0, 3, SEED)
        finals[backend] = tree_leaves(eng.export_states(state))
        assert m["loss"].shape == (3, 1)
    assert len(finals["shard_map"]) == len(finals["vmap"])
    for a, b in zip(finals["shard_map"], finals["vmap"]):
        assert torch.equal(a, b)
    for a, b in zip(finals["shard_map"],
                    jax.tree_util.tree_leaves(_export(jeng, jstate))):
        np.testing.assert_allclose(a.numpy(), b, **CLOSE)


@pytest.mark.parametrize("case", ["compressed", "heterogeneous",
                                  "not_stackable"])
def test_refusals(one_rank_mesh, case):
    spec, cfg, _ = _one_client()
    if case == "compressed":
        cfg = dataclasses.replace(cfg, compress="int8")
        with pytest.raises(ValueError, match="shard_map"):
            engine.single_model_engine(spec, cfg, False, mix="pushsum",
                                       backend="shard_map", n_clients=1,
                                       device="cpu", mesh=one_rank_mesh)
    elif case == "heterogeneous":
        lv = get_vision_model("lenet5")
        other = ModelSpec("lenet5", lambda g: lv.init(g, SHAPE, N_CLASSES),
                          lv.apply)
        with pytest.raises(ValueError, match="shard_map backend requires a "
                                             "homogeneous cohort"):
            engine.dml_engine((spec, other), spec,
                              dataclasses.replace(cfg, n_clients=2),
                              backend="shard_map", device="cpu",
                              mesh=one_rank_mesh)
    else:
        eng = engine.single_model_engine(spec, cfg, False, backend="vmap",
                                         n_clients=1, device="cpu")
        with pytest.raises(ValueError, match="torch.func.vmap"):
            engine.FederationEngine(
                cfg, n_clients=1, step_fns=eng.step_fns[0],
                init_fns=eng.init_fns[0], sample_fn=eng.sample_fn,
                backend="shard_map", device="cpu", mesh=one_rank_mesh)

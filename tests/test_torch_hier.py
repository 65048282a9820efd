"""The hier backend (two-level factored PushSum, sync and stale) in the port
against the JAX package.

* The numpy factoring (``hier_layout``, ``hier_mix_split``,
  ``hier_mix_schedule``) and its oracle ``hier_gossip_reference`` are
  array-equal to the reference's over K ∈ {2, 4, 6, 8}, every S that
  divides K, the topologies and mixes, with and without a random
  membership; where the reference raises, the port raises the same
  message.
* ``hier_mix_debiased`` and ``hier_stale_mix_apply`` (the port's plain path)
  against the reference's, plain and with ``use_pallas`` (its Pallas kernel
  in interpret mode), and the shard-grid wrapper ``fused_pushsum_mix_blocks``
  against the reference's vmapped ``fused_pushsum_mix``, at the kernel
  tolerances of tests/test_kernels.py (f32 rtol = atol = 2e-5, bf16 2e-2).
  The wrapper's plain version equals S calls of ``fused_pushsum_mix_ref``
  bit for bit; a ``cuda``-marked test holds the kernel to S launches of the
  flat kernel on the card.
* Engine parity: JAX ``dml_engine(..., backend="hier")`` at K = 4, S = 2,
  τ ∈ {0, 2}, ``dropout_rate=0.25``, DP on, ``use_pallas=True``, mlp on
  14x14x1, B = 8, one local step, 4 rounds. The port starts from the
  reference's initial state (``repro_torch.convert``) and replays its batch
  indices and DP noise. Params, Adam moments, de-bias weights and the
  cross-shard buffer at the conformance ``close`` grade (atol 1e-5, rtol
  1e-4); epsilon exactly. A JAX hier τ = 2 snapshot after round 2 restores
  into the port bit for bit, buffer included, and the port's snapshot of
  that state equals the reference's files and restores into JAX.
* The port alone: hier τ = 0 at S ∈ {1, 2} (and S = 1 at τ = 2) equals
  vmap bit for bit; mass (clients plus buffer) is conserved at τ = 2 under
  §3.4 dropout; the reference's refusals, with its messages.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import FederationCheckpointer as JaxCheckpointer  # noqa: E402
from repro.configs.base import DPConfig as JaxDPConfig  # noqa: E402
from repro.configs.base import ProxyFLConfig as JaxProxyFLConfig  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core import gossip as jax_gossip  # noqa: E402
from repro.core.accountant import PrivacyAccountant as JaxAccountant  # noqa: E402
from repro.core.dp import _flat_gaussian_like  # noqa: E402
from repro.core.protocol import ModelSpec as JaxModelSpec  # noqa: E402
from repro.data.synthetic import make_classification_data  # noqa: E402
from repro.kernels.pushsum_mix import \
    fused_pushsum_mix as jax_fused_pushsum_mix  # noqa: E402
from repro.nn.vision import get_vision_model as jax_vision  # noqa: E402
from repro_torch import convert, kernels  # noqa: E402
from repro_torch.checkpoint import FederationCheckpointer  # noqa: E402
from repro_torch.configs import DPConfig, ProxyFLConfig  # noqa: E402
from repro_torch.core import engine, gossip  # noqa: E402
from repro_torch.core.accountant import PrivacyAccountant  # noqa: E402
from repro_torch.core.baselines import run_federated  # noqa: E402
from repro_torch.core.protocol import ModelSpec  # noqa: E402
from repro_torch.kernels.ref import (fused_pushsum_mix_blocks_ref,  # noqa: E402
                                     fused_pushsum_mix_ref)
from repro_torch.nn.modules import tree_flatten_vector, tree_leaves  # noqa: E402
from repro_torch.nn.vision import get_vision_model  # noqa: E402
from test_torch_checkpoint import (_assert_npz_equal,  # noqa: E402
                                   _assert_state_equals_numpy, _bits)
from test_torch_kernels import TOL, _np, _pair  # noqa: E402

K, S, N_CLASSES, SHAPE, B, N_PER, ROUNDS, TAU = 4, 2, 10, (14, 14, 1), 8, \
    300, 4, 2
SEED = 0
CLOSE = dict(atol=1e-5, rtol=1e-4)
SIZES_K = [2, 4, 6, 8]
TOPOLOGIES = ("exponential", "ring", "full")
MIXES = ("pushsum", "mean", "ring", "none")


def _divisors(n):
    return [s for s in range(1, n + 1) if n % s == 0]


def _same_outcome(ours, theirs):
    """Call both; array-equal results, or the same ValueError message."""
    try:
        want = theirs()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ours()
        assert str(got.value) == str(e)
        return False
    got = ours()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    return True


# ---------------------------------------------------------------------------
# numpy factoring: array-equal to the reference


@pytest.mark.parametrize("n", [0, 3, 5, None])
def test_hier_layout_matches_reference(n):
    for k in SIZES_K:
        _same_outcome(lambda: gossip.hier_layout(k, n),
                      lambda: jax_gossip.hier_layout(k, n))


@pytest.mark.parametrize("Kc", SIZES_K)
@pytest.mark.parametrize("with_active", [False, True])
def test_hier_split_and_schedule_array_equal(Kc, with_active):
    rng = np.random.default_rng(Kc + 10 * with_active)
    t0, T = 2, 5
    act = rng.random((T, Kc)) >= 0.3 if with_active else None
    factored = refused = 0
    for n in _divisors(Kc):
        for topo in TOPOLOGIES:
            for mix in MIXES:
                P = gossip.mix_schedule(mix, t0, T, Kc, topo, active=act)
                for i in range(T):
                    ok = _same_outcome(
                        lambda: gossip.hier_mix_split(P[i], n),
                        lambda: jax_gossip.hier_mix_split(P[i], n))
                    factored += ok
                    refused += not ok
                    if ok:   # the split rebuilds P exactly
                        blocks, src, scale = gossip.hier_mix_split(P[i], n)
                        L = Kc // n
                        rebuilt = np.zeros((Kc, Kc))
                        for s in range(n):
                            rebuilt[s * L:(s + 1) * L,
                                    s * L:(s + 1) * L] = blocks[s]
                        rebuilt[np.arange(Kc), src] += scale
                        np.testing.assert_array_equal(rebuilt, P[i])
                _same_outcome(
                    lambda: gossip.hier_mix_schedule(mix, t0, T, Kc, n, topo,
                                                     act),
                    lambda: jax_gossip.hier_mix_schedule(mix, t0, T, Kc, n,
                                                         topo, act))
    # both outcomes were compared (two clients have no dense cross part)
    assert factored and (refused or Kc == 2)


@pytest.mark.parametrize("Kc", SIZES_K)
@pytest.mark.parametrize("tau", [0, 1, 2])
def test_hier_gossip_reference_array_equal(Kc, tau):
    rng = np.random.default_rng(100 * Kc + tau)
    z0 = rng.standard_normal((Kc, 6))
    w0 = rng.uniform(0.5, 1.5, Kc)
    act = rng.random((6, Kc)) >= 0.3
    Ps = gossip.mix_schedule("pushsum", 0, 6, Kc, "exponential", active=act)
    for n in _divisors(Kc):
        ours = gossip.hier_gossip_reference(z0, w0, Ps, n, tau)
        for a, b in zip(ours, jax_gossip.hier_gossip_reference(z0, w0, Ps, n,
                                                               tau)):
            np.testing.assert_array_equal(a, b)
        if tau == 0:   # τ = 0: the flat synchronous oracle, bit for bit
            for a, b in zip(ours[:2],
                            gossip.stale_gossip_reference(z0, w0, Ps, 0)):
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the exchanges against the reference's


EXCHANGE_SHAPES = [(4, 300, 2, "float32"), (6, 100, 3, "float32"),
                   (8, 65, 8, "float32"), (8, 777, 4, "bfloat16"),
                   (8, 33, 1, "float32")]


def _hier_args(Kc, D, n, dtype):
    """flat, w, blocks, src, scale, buf_t0, buf_w0 as jax and torch
    arguments: the split of a ring or exponential P(t) with self weight 0.3
    over a random membership, w in [0.3, 2.0], buf_t0 = 0.1·N(0, 1), buf_w0
    in [0, 0.5]."""
    rng = np.random.default_rng(Kc * 13 + D + n)
    act = rng.random(Kc) >= 0.25
    P = gossip.mix_matrix("pushsum", 3, Kc, "ring" if D % 2 else
                          "exponential", act, self_weight=0.3)
    blocks, src, scale = gossip.hier_mix_split(P, n)
    flat = _pair(rng.standard_normal((Kc, D), dtype=np.float32), dtype)
    w = _pair(rng.uniform(0.3, 2.0, Kc).astype(np.float32), dtype)
    buf_t0 = _pair(0.1 * rng.standard_normal((Kc, D), dtype=np.float32),
                   dtype)
    buf_w0 = _pair(rng.uniform(0.0, 0.5, Kc).astype(np.float32), dtype)
    sched = [(jnp.asarray(a, dt), torch.as_tensor(a).to(tt))
             for a, dt, tt in ((blocks, jnp.float32, torch.float32),
                               (src, jnp.int32, torch.int64),
                               (scale, jnp.float32, torch.float32))]
    args = [flat, w, *sched, buf_t0, buf_w0]
    return [a[0] for a in args], [a[1] for a in args]


@pytest.mark.parametrize("Kc,D,n,dtype", EXCHANGE_SHAPES)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_hier_mix_debiased_matches_reference(Kc, D, n, dtype, use_pallas):
    jargs, targs = _hier_args(Kc, D, n, dtype)
    want = jax_gossip.hier_mix_debiased(*jargs[:5], use_pallas=use_pallas,
                                        interpret=True)
    got = gossip.hier_mix_debiased(*targs[:5])
    assert [g.dtype for g in got] == [targs[0].dtype, targs[1].dtype]
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL[dtype])


@pytest.mark.parametrize("Kc,D,n,dtype", EXCHANGE_SHAPES)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_hier_stale_mix_apply_matches_reference(Kc, D, n, dtype, use_pallas):
    jargs, targs = _hier_args(Kc, D, n, dtype)
    want = jax_gossip.hier_stale_mix_apply(*jargs, use_pallas=use_pallas,
                                           interpret=True)
    got = gossip.hier_stale_mix_apply(*targs)
    assert [tuple(g.shape) for g in got] == [(Kc, D), (Kc, D), (Kc,), (Kc,)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL[dtype])


@pytest.mark.parametrize("Kc,D,n,dtype", EXCHANGE_SHAPES)
@pytest.mark.parametrize("debias", [False, True])
def test_blocks_wrapper_matches_the_vmapped_reference_kernel(Kc, D, n, dtype,
                                                             debias):
    """The shard-grid wrapper on CPU tensors (its plain version) against
    the reference's ``_hier_intra``: ``fused_pushsum_mix`` vmapped over the
    shards, in interpret mode."""
    jargs, targs = _hier_args(Kc, D, n, dtype)
    L = Kc // n
    want = jax.vmap(lambda f, ww, p: jax_fused_pushsum_mix(
        f, ww, p, debias=debias, interpret=True))(
            jargs[0].reshape(n, L, D), jargs[1].reshape(n, L), jargs[2])
    got = kernels.fused_pushsum_mix_blocks(targs[0], targs[1], targs[2],
                                           debias=debias)
    assert got[0].dtype == targs[0].dtype and got[1].dtype == targs[1].dtype
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w).reshape(_np(g).shape),
                                   **TOL[dtype])


@pytest.mark.parametrize("n,L,D", [(1, 8, 300), (2, 4, 777), (4, 2, 100),
                                   (8, 1, 65), (2, 9, 33), (3, 17, 64),
                                   (2, 33, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("debias", [False, True])
def test_blocks_plain_version_is_s_flat_plain_calls(n, L, D, dtype, debias):
    rng = np.random.default_rng(n * 100 + L + D)
    flat = torch.as_tensor(rng.standard_normal((n * L, D),
                                               dtype=np.float32)).to(
        getattr(torch, dtype))
    w = torch.as_tensor(rng.uniform(0.3, 2.0, n * L).astype(np.float32))
    blocks = torch.as_tensor(rng.uniform(0.0, 1.0, (n, L, L)).astype(
        np.float32))
    got = fused_pushsum_mix_blocks_ref(flat, w, blocks, debias=debias)
    parts = [fused_pushsum_mix_ref(flat[s * L:(s + 1) * L],
                                   w[s * L:(s + 1) * L], blocks[s],
                                   debias=debias) for s in range(n)]
    assert torch.equal(got[0], torch.cat([p[0] for p in parts]))
    assert torch.equal(got[1], torch.cat([p[1] for p in parts]))


# the card's check of the shard-grid kernel, collected here too (it skips
# without a CUDA device; tests/test_torch_cuda.py runs it on the card)
from test_torch_cuda import \
    test_blocks_kernel_is_s_flat_launches_on_the_card  # noqa: E402,F401


# ---------------------------------------------------------------------------
# engine parity with the JAX hier engine, dropout on, mail in flight


def _export(eng, state):
    """The reference engine's state as numpy: a per-client list, wrapped
    with the cross-shard buffer at τ > 0."""
    clients = [jax.tree_util.tree_map(np.asarray, s)
               for s in eng.export_states(state)]
    if isinstance(state, dict) and "clients" in state:
        return {"clients": clients,
                **{key: np.asarray(value) for key, value in state.items()
                   if key != "clients"}}
    return clients


def _to_port(state):
    if isinstance(state, dict):
        return convert.async_state_from_numpy(state)
    return [convert.state_from_numpy(s) for s in state]


def _clients(state):
    return state["clients"] if isinstance(state, dict) else state


def _federation(staleness, tmp_root):
    x, y = make_classification_data(jax.random.PRNGKey(0), K * N_PER, SHAPE,
                                    N_CLASSES, sep=2.0)
    jdata = [(x[i * N_PER:(i + 1) * N_PER], y[i * N_PER:(i + 1) * N_PER])
             for i in range(K)]
    jv = jax_vision("mlp")
    jspec = JaxModelSpec("mlp", lambda k: jv.init(k, SHAPE, N_CLASSES),
                         jv.apply)
    knobs = dict(n_clients=K, rounds=ROUNDS, local_steps=1, batch_size=B,
                 use_pallas=True, staleness=staleness, n_shards=S,
                 dropout_rate=0.25)
    ref = jax_engine.dml_engine(
        (jspec,) * K, jspec,
        JaxProxyFLConfig(dp=JaxDPConfig(enabled=True), **knobs),
        backend="hier")
    q = B / N_PER
    jaccs = [JaxAccountant(1.0, q, 1e-5) for _ in range(K)]
    ref.attach_accountants(jaccs)
    base = jax.random.PRNGKey(SEED)
    jstate = ref.init_states(base)
    jstates, jmetrics = [_export(ref, jstate)], []
    snapshot = None
    for t in range(ROUNDS):
        jstate, m = ref.run_round(jstate, jdata, t,
                                  jax_engine.round_key(base, t))
        jstates.append(_export(ref, jstate))
        jmetrics.append({k: np.asarray(v) for k, v in m.items()})
        if staleness and t == 1:   # a hier τ>0 snapshot after round 2
            jdir = str(tmp_root / "jax")
            JaxCheckpointer(jdir).save(ref, jstate, t, base_key=base)
            snapshot = dict(jdir=jdir, jstate=jstate, state=jstates[-1],
                            steps=[a.steps for a in jaccs])
    theta_like = _clients(jstates[0])[0]["proxy"]["params"]

    def draws(k, t, s):
        ck = jax.random.fold_in(jax_engine.round_key(base, t), k)
        for _ in range(s + 1):
            ck, kb, kn = jax.random.split(ck, 3)
        idx = jax.random.randint(kb, (B,), 0, N_PER)
        return np.asarray(idx), np.asarray(_flat_gaussian_like(theta_like, kn))

    tv = get_vision_model("mlp")
    tspec = ModelSpec("mlp", lambda g: tv.init(g, SHAPE, N_CLASSES), tv.apply)
    tcfg = ProxyFLConfig(dp=DPConfig(enabled=True), **knobs)

    def port_engine(replay=True):
        eng = engine.dml_engine((tspec,) * K, tspec, tcfg, backend="hier",
                                device="cpu", draws=draws if replay else None)
        eng.attach_accountants([PrivacyAccountant(1.0, q, 1e-5)
                                for _ in range(K)])
        return eng

    port = port_engine()
    tdata = [(torch.as_tensor(np.array(a)), torch.as_tensor(np.array(b)))
             for a, b in jdata]
    tstate, tmetrics = port.run_rounds(_to_port(jstates[0]), tdata, 0,
                                       ROUNDS, seed=SEED)
    masks = [engine.active_mask(t, K, tcfg) for t in range(ROUNDS)]
    return dict(ref=ref, jstate=jstates[-1], tstate=tstate, jaccs=jaccs,
                taccs=port.accountants, jmetrics=jmetrics, tmetrics=tmetrics,
                masks=masks, port_engine=port_engine, snapshot=snapshot,
                tmp_root=tmp_root)


@pytest.fixture(scope="module")
def federations(tmp_path_factory):
    """The federation at each τ, run once for the module."""
    runs = {}

    def get(tau):
        if tau not in runs:
            runs[tau] = _federation(tau, tmp_path_factory.mktemp(f"hier{tau}"))
        return runs[tau]

    return get


@pytest.fixture(scope="module", params=[0, TAU], ids=["tau0", "tau2"])
def hier_runs(request, federations):
    return federations(request.param)


@pytest.fixture(scope="module")
def stale_runs(federations):
    return federations(TAU)


def test_the_seed_drops_clients(hier_runs):
    assert any(m is not None and not m.all() for m in hier_runs["masks"])


@pytest.mark.parametrize("role", ["private", "proxy"])
def test_params_and_moments_close(hier_runs, role):
    for ours, theirs in zip(_clients(hier_runs["tstate"]),
                            _clients(hier_runs["jstate"])):
        o, t = ours[role], theirs[role]
        for a_tree, b_tree in ((o["params"], t["params"]),
                               (o["opt"].m, t["opt"].m),
                               (o["opt"].v, t["opt"].v)):
            for a, b in zip(tree_leaves(a_tree),
                            jax.tree_util.tree_leaves(b_tree)):
                np.testing.assert_allclose(a.numpy(), b, **CLOSE)
        assert int(o["opt"].t) == int(t["opt"].t)


def test_debias_weights_close(hier_runs):
    ours = np.asarray([float(s["w"]) for s in _clients(hier_runs["tstate"])])
    theirs = np.asarray([float(s["w"])
                         for s in _clients(hier_runs["jstate"])])
    np.testing.assert_allclose(ours, theirs, **CLOSE)


def test_cross_shard_buffer_close(stale_runs):
    ours, theirs = stale_runs["tstate"], stale_runs["jstate"]
    assert sorted(ours) == sorted(theirs) == ["clients", "hier_buffer",
                                              "hier_w"]
    assert tuple(ours["hier_buffer"].shape) == theirs["hier_buffer"].shape \
        == (TAU, K, ours["hier_buffer"].shape[2])
    assert np.abs(theirs["hier_w"]).sum() > 0   # mail really in flight
    for key in ("hier_buffer", "hier_w"):
        np.testing.assert_allclose(ours[key].numpy(), theirs[key], **CLOSE)


def test_epsilon_exact(hier_runs):
    assert [a.epsilon() for a in hier_runs["taccs"]] == \
        [a.epsilon() for a in hier_runs["jaccs"]]
    steps = [sum(m is None or bool(m[k]) for m in hier_runs["masks"])
             for k in range(K)]
    assert [a.steps for a in hier_runs["taccs"]] == steps


def test_metrics_nan_where_reference_is(hier_runs):
    ours = hier_runs["tmetrics"]
    assert sorted(ours) == sorted(hier_runs["jmetrics"][0])
    for key in ours:
        want = np.stack([m[key] for m in hier_runs["jmetrics"]])
        np.testing.assert_array_equal(np.isnan(ours[key]), np.isnan(want))
        np.testing.assert_allclose(ours[key], want, **CLOSE)


# ---------------------------------------------------------------------------
# hier snapshots move both ways between the packages


def test_jax_hier_snapshot_restores_into_the_port(stale_runs):
    snap = stale_runs["snapshot"]
    eng = stale_runs["port_engine"]()
    state, done = FederationCheckpointer(snap["jdir"], verify=True) \
        .restore_latest(eng, like=eng.init_states(SEED), seed=SEED)
    assert done == 2
    assert [a.steps for a in eng.accountants] == snap["steps"]
    assert sorted(state) == ["clients", "hier_buffer", "hier_w"]
    for ours, theirs in zip(state["clients"], snap["state"]["clients"]):
        _assert_state_equals_numpy(ours, theirs)
    for key in ("hier_buffer", "hier_w"):
        assert _bits(state[key]).tobytes() == \
            _bits(snap["state"][key]).tobytes()
    assert np.abs(snap["state"]["hier_w"]).sum() > 0


def test_port_hier_snapshot_equals_the_references_and_restores_into_jax(
        stale_runs):
    snap, ref = stale_runs["snapshot"], stale_runs["ref"]
    eng = stale_runs["port_engine"]()
    for a, n in zip(eng.accountants, snap["steps"]):
        a.steps = n
    tdir = str(stale_runs["tmp_root"] / "port")
    FederationCheckpointer(tdir).save(eng, _to_port(snap["state"]), 1,
                                      seed=SEED)
    jdir, base = snap["jdir"], "round_000002"
    _assert_npz_equal(os.path.join(jdir, base + ".npz"),
                      os.path.join(tdir, base + ".npz"))
    for name in (base + ".json", "audit.jsonl", "LATEST"):
        with open(os.path.join(jdir, name), "rb") as f, \
                open(os.path.join(tdir, name), "rb") as g:
            assert f.read() == g.read(), name
    with open(os.path.join(jdir, base + ".meta.json")) as f, \
            open(os.path.join(tdir, base + ".meta.json")) as g:
        jm, tm = json.load(f), json.load(g)
    for m in (jm, tm):
        m.pop("saved_unix_time")
    assert jm == tm
    for a in ref.accountants:
        a.steps = 0
    state, done = JaxCheckpointer(tdir, verify=True).restore_latest(
        ref, like=snap["jstate"], base_key=jax.random.PRNGKey(SEED))
    assert done == 2 and [a.steps for a in ref.accountants] == snap["steps"]
    got = _export(ref, state)
    for key in ("hier_buffer", "hier_w"):
        assert got[key].tobytes() == snap["state"][key].tobytes()
    for ours, theirs in zip(got["clients"], snap["state"]["clients"]):
        for a, b in zip(jax.tree_util.tree_leaves(ours),
                        jax.tree_util.tree_leaves(theirs)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# the port's own invariants


def _port_setup(n=K, **knobs):
    tv = get_vision_model("mlp")
    spec = ModelSpec("mlp", lambda g: tv.init(g, SHAPE, N_CLASSES), tv.apply)
    rng = np.random.default_rng(0)
    data = [(torch.as_tensor(rng.standard_normal((50,) + SHAPE,
                                                 dtype=np.float32)),
             torch.as_tensor(rng.integers(0, N_CLASSES, 50)))
            for _ in range(n)]
    cfg = ProxyFLConfig(n_clients=n, batch_size=B, local_steps=1, **knobs)
    return spec, data, cfg


@pytest.mark.parametrize("n_shards,staleness", [(1, 0), (2, 0), (4, 0),
                                                (1, 2)])
def test_hier_equals_vmap_bitwise(n_shards, staleness):
    """τ = 0 at S ∈ {1, 2, 4}, and S = 1 at τ = 2 (every edge intra-shard):
    every leaf and w bit for bit, the state unwrapped, epsilon equal."""
    spec, data, cfg = _port_setup(rounds=3, dropout_rate=0.25,
                                  use_pallas=True, n_shards=n_shards,
                                  staleness=staleness,
                                  dp=DPConfig(enabled=True))
    out, eps = [], []
    for backend in ("hier", "vmap"):
        eng = engine.dml_engine((spec,) * K, spec, cfg, backend=backend,
                                device="cpu")
        eng.attach_accountants([PrivacyAccountant(1.0, B / 50, 1e-5)
                                for _ in range(K)])
        state, _ = eng.run_rounds(eng.init_states(0), data, 0, 3, seed=0)
        assert isinstance(state, list)   # no buffer, no wrapper
        out.append(tree_leaves(state))
        eps.append([a.epsilon() for a in eng.accountants])
    assert len(out[0]) == len(out[1]) and eps[0] == eps[1]
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_hier_stale_mass_conserved_engine_level():
    """τ = 2, S = 2 with §3.4 dropout, lr = 0 to isolate the exchange: the
    raw PushSum mass Σ z·w and the total de-bias weight, clients plus the
    cross-shard buffer, are conserved every round."""
    spec, data, cfg = _port_setup(rounds=4, lr=0.0, staleness=2, n_shards=2,
                                  dp=DPConfig(enabled=False))
    eng = engine.dml_engine((spec,) * K, spec, cfg, backend="hier",
                            device="cpu")
    state = eng.init_states(0)

    def masses(st):
        z = torch.stack([tree_flatten_vector(s["proxy"]["params"])
                         for s in st["clients"]]).double()
        w = torch.stack([s["w"] for s in st["clients"]]).double()
        return (float((z * w[:, None]).sum() + st["hier_buffer"].sum()),
                float(w.sum() + st["hier_w"].sum()))

    theta0, w0 = masses(state)
    assert w0 == K
    masks = [np.array([True, False, True, True]),
             np.array([False, True, False, True]),
             None,
             np.array([True, True, False, False])]
    for t, act in enumerate(masks):
        state, m = eng.run_round(state, data, t, seed=0, active=act)
        theta_m, w_m = masses(state)
        np.testing.assert_allclose(theta_m, theta0, rtol=1e-5)
        np.testing.assert_allclose(w_m, K, rtol=1e-6)
        if act is not None:
            np.testing.assert_array_equal(np.isnan(m["proxy_loss"]), ~act)
    assert float(state["hier_w"].sum()) > 0   # mass was in flight


def _refusal(case):
    """(port call, reference call) building the engine ``case`` asks for."""
    kn = dict(n_clients=K, n_shards=2, staleness=0)
    mix, backend, hetero = "pushsum", "hier", False
    if case == "mean":
        mix = "mean"
    elif case == "full":
        kn["topology"] = "full"
    elif case == "ring_stale":
        mix, kn["staleness"] = "ring", 2
    elif case == "compressed":
        kn["compress"] = "topk"
    elif case == "heterogeneous":
        hetero = True
    elif case == "uneven":
        kn["n_shards"] = 3
    tv, jv = get_vision_model("mlp"), jax_vision("mlp")
    specs = [ModelSpec("mlp", lambda g: tv.init(g, SHAPE, N_CLASSES),
                       tv.apply)]
    jspecs = [JaxModelSpec("mlp", lambda k: jv.init(k, SHAPE, N_CLASSES),
                           jv.apply)]
    if hetero:
        lv, jl = get_vision_model("lenet5"), jax_vision("lenet5")
        specs.append(ModelSpec("lenet5", lambda g: lv.init(g, SHAPE,
                                                           N_CLASSES),
                               lv.apply))
        jspecs.append(JaxModelSpec("lenet5", lambda k: jl.init(k, SHAPE,
                                                               N_CLASSES),
                                   jl.apply))
    privs = [specs[k % len(specs)] for k in range(K)]
    jprivs = [jspecs[k % len(jspecs)] for k in range(K)]
    return (lambda: engine.dml_engine(tuple(privs), specs[0],
                                      ProxyFLConfig(**kn), backend=backend,
                                      mix=mix, device="cpu"),
            lambda: jax_engine.dml_engine(tuple(jprivs), jspecs[0],
                                          JaxProxyFLConfig(**kn),
                                          backend=backend, mix=mix))


@pytest.mark.parametrize("case", ["mean", "full", "ring_stale", "compressed",
                                  "uneven"])
def test_the_references_refusals_with_its_messages(case):
    ours, theirs = _refusal(case)
    with pytest.raises(ValueError) as want:
        theirs()
    with pytest.raises(ValueError) as got:
        ours()
    assert str(got.value) == str(want.value)


def test_heterogeneous_cohort_refused():
    """The reference asserts; the port raises a ValueError naming the loop
    backend."""
    ours, theirs = _refusal("heterogeneous")
    with pytest.raises(AssertionError, match="homogeneous"):
        theirs()
    with pytest.raises(ValueError, match="hier backend requires a "
                                         "homogeneous cohort"):
        ours()


@pytest.mark.parametrize("case", ["mean", "ring_stale", "compressed"])
def test_what_hier_refuses_at_two_shards_runs_at_one(case):
    """n_shards = 1 keeps every edge intra-shard: dense mixing and
    compression run (the flat exchange verbatim); ring at τ > 0 stays
    refused, as in the reference."""
    kn = dict(n_clients=K, n_shards=1)
    mix = "mean" if case == "mean" else "pushsum"
    if case == "compressed":
        kn["compress"] = "int8"
    if case == "ring_stale":
        mix, kn["staleness"] = "ring", 2
    spec, data, _ = _port_setup()
    make = (lambda: engine.dml_engine(
        (spec,) * K, spec, ProxyFLConfig(batch_size=B, local_steps=1, **kn),
        backend="hier", mix=mix, device="cpu"))
    if case == "ring_stale":
        with pytest.raises(ValueError, match="hier staleness>0"):
            make()
        return
    eng = make()
    state, _ = eng.run_round(eng.init_states(0), data, 0, seed=0)
    assert len(eng.export_states(state)) == K


def test_run_federated_hier_on_cpu_equals_vmap():
    """``run_federated(backend="hier", n_shards=2)``, τ = 0: the clients'
    params, w and epsilon equal the vmap run's bit for bit; at τ = 2 it
    runs, every client finite with positive w."""
    spec, data, cfg = _port_setup(rounds=2, dropout_rate=0.25,
                                  use_pallas=True, dp=DPConfig(enabled=True))
    runs = {backend: run_federated("proxyfl", [spec] * K, spec, data,
                                   data[0], cfg, backend=backend,
                                   n_shards=2 if backend == "hier" else None,
                                   device="cpu")
            for backend in ("hier", "vmap")}
    assert runs["hier"]["epsilon"] == runs["vmap"]["epsilon"]
    for a, b in zip(runs["hier"]["clients"], runs["vmap"]["clients"]):
        assert a.w == b.w
        for x, y in zip(tree_leaves(a.proxy_params),
                        tree_leaves(b.proxy_params)):
            assert torch.equal(x, y)
    stale = run_federated("proxyfl", [spec] * K, spec, data, data[0],
                          dataclasses.replace(cfg, staleness=2),
                          backend="hier", n_shards=2, device="cpu")
    assert [r["round"] for r in stale["history"]] == [1, 2]
    for c in stale["clients"]:
        assert 0.0 < c.w
        assert all(torch.isfinite(x).all() for x in
                   tree_leaves(c.proxy_params))

"""The async stale-gossip backend (staleness τ>0) and §3.4 dropout in the
port against the JAX package.

* The numpy schedule functions (block schedules, the stale split, the
  stale-gossip oracle, the dropout masks) are array-equal to the
  reference's over K ∈ {1, 2, 3, 5, 8}, every topology and mix, with and
  without a random membership.
* ``stale_mix_apply``, plain and with ``use_pallas`` (the reference's Pallas
  kernel in interpret mode, the port's plain version on the CPU), at the
  shapes of tests/test_kernels.py and the kernel tolerances there (f32
  rtol = atol = 2e-5, bf16 2e-2); compressed (top-k and int8) at the
  ``close`` grade, the public copies bit for bit.
* Engine parity: JAX ``dml_engine(..., backend="async")`` at τ = 2 and the
  sync ``vmap`` backend, both with ``dropout_rate=0.25``, DP on,
  ``use_pallas=True``, K = 4 clients, mlp on 14x14x1, B = 8, one local
  step, 4 rounds. The port starts from the reference's initial state
  (``repro_torch.convert``) and replays its batch indices and DP noise, as
  tests/test_torch_slice.py does. Params, Adam moments, de-bias weights and
  both in-flight buffers at the conformance ``close`` grade (atol 1e-5,
  rtol 1e-4); epsilon exactly; metrics NaN exactly where the reference's
  are. A second port run starts from the reference's state after two
  rounds, with mail in flight.
* The port's async backend at τ = 0 equals its sync backend bit for bit;
  the engine-level mass-conservation twin of tests/test_conformance.py
  (rtol 1e-5 for θ-mass, 1e-6 for w-mass, the same masks); the ring mix
  is refused at τ>0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import DPConfig as JaxDPConfig  # noqa: E402
from repro.configs.base import ProxyFLConfig as JaxProxyFLConfig  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core import gossip as jax_gossip  # noqa: E402
from repro.core.accountant import PrivacyAccountant as JaxAccountant  # noqa: E402
from repro.core.compress import CompressionSpec as JaxCompressionSpec  # noqa: E402
from repro.core.dp import _flat_gaussian_like  # noqa: E402
from repro.core.protocol import ModelSpec as JaxModelSpec  # noqa: E402
from repro.data.synthetic import make_classification_data  # noqa: E402
from repro.nn.vision import get_vision_model as jax_vision  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import DPConfig, ProxyFLConfig  # noqa: E402
from repro_torch.core import engine, gossip  # noqa: E402
from repro_torch.core.accountant import PrivacyAccountant  # noqa: E402
from repro_torch.core.baselines import run_federated  # noqa: E402
from repro_torch.core.compress import CompressionSpec  # noqa: E402
from repro_torch.core.protocol import ModelSpec  # noqa: E402
from repro_torch.nn.modules import tree_flatten_vector, tree_leaves  # noqa: E402
from repro_torch.nn.vision import get_vision_model  # noqa: E402
from test_torch_kernels import TOL, _np, _stale_args  # noqa: E402

K, N_CLASSES, SHAPE, B, N_PER, ROUNDS, TAU = 4, 10, (14, 14, 1), 8, 300, 4, 2
CLOSE = dict(atol=1e-5, rtol=1e-4)
SIZES_K = [1, 2, 3, 5, 8]
TOPOLOGIES = ("exponential", "ring", "full")
MIXES = ("pushsum", "mean", "ring", "none")


def _same(a, b) -> None:
    """Array-equal, or both None."""
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# numpy schedules: array-equal to the reference


@pytest.mark.parametrize("K", SIZES_K)
@pytest.mark.parametrize("with_active", [False, True])
def test_block_schedules_array_equal(K, with_active):
    rng = np.random.default_rng(K + 10 * with_active)
    t0, T = 3, 7
    act = rng.random((T, K)) >= 0.3 if with_active else None
    for topo in TOPOLOGIES:
        for n in range(K + 1):
            _same(gossip.shift_schedule(t0, T, n, topo),
                  jax_gossip.shift_schedule(t0, T, n, topo))
        _same(gossip.adjacency_schedule(t0, T, K, topo, 0.5, act),
              jax_gossip.adjacency_schedule(t0, T, K, topo, 0.5, act))
        for mix in MIXES:
            P = gossip.mix_schedule(mix, t0, T, K, topo, active=act)
            _same(P, jax_gossip.mix_schedule(mix, t0, T, K, topo, active=act))
            for i in range(T):
                _same(P[i], gossip.mix_matrix(
                    mix, t0 + i, K, topo, None if act is None else act[i]))
            for a, b in zip(gossip.stale_mix_split(P),
                            jax_gossip.stale_mix_split(P)):
                _same(a, b)
            for a, b in zip(
                    gossip.stale_mix_schedule(mix, t0, T, K, topo, act),
                    jax_gossip.stale_mix_schedule(mix, t0, T, K, topo, act)):
                _same(a, b)


@pytest.mark.parametrize("K", SIZES_K)
@pytest.mark.parametrize("tau", [0, 1, 2])
def test_stale_gossip_reference_array_equal(K, tau):
    rng = np.random.default_rng(100 * K + tau)
    z0 = rng.standard_normal((K, 6))
    w0 = rng.uniform(0.5, 1.5, K)
    act = rng.random((6, K)) >= 0.3
    Ps = gossip.mix_schedule("pushsum", 0, 6, K, "exponential", active=act)
    for a, b in zip(gossip.stale_gossip_reference(z0, w0, Ps, tau),
                    jax_gossip.stale_gossip_reference(z0, w0, Ps, tau)):
        _same(a, b)


@pytest.mark.parametrize("K", SIZES_K)
@pytest.mark.parametrize("rate,min_active,seed",
                         [(0.0, 1, 0), (0.25, 1, 0), (0.6, 3, 5)])
def test_active_masks_array_equal(K, rate, min_active, seed):
    knobs = dict(dropout_rate=rate, min_active=min_active, seed=seed)
    ours, theirs = ProxyFLConfig(**knobs), JaxProxyFLConfig(**knobs)
    for t in range(12):
        _same(engine.active_mask(t, K, ours),
              jax_engine.active_mask(t, K, theirs))
    _same(engine.active_schedule(2, 9, K, ours),
          jax_engine.active_schedule(2, 9, K, theirs))


# ---------------------------------------------------------------------------
# stale_mix_apply against the reference's


STALE_SHAPES = [(1, 300, "float32"), (4, 300, "float32"),
                (4, 100, "float32"), (8, 777, "bfloat16")]


@pytest.mark.parametrize("K,D,dtype", STALE_SHAPES)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_stale_mix_apply_matches_reference(K, D, dtype, use_pallas):
    jargs, targs = _stale_args(K, D, dtype)
    want = jax_gossip.stale_mix_apply(*jargs, use_pallas=use_pallas,
                                      interpret=True)
    got = gossip.stale_mix_apply(*targs, use_pallas=use_pallas)
    assert [g.dtype for g in got] == [targs[0].dtype] * 2 + [targs[1].dtype] * 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL[dtype])


@pytest.mark.parametrize("mode", ["topk", "int8"])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("silent", [False, True])
def test_compressed_stale_mix_apply_matches_reference(mode, use_pallas,
                                                      silent):
    """The compressed stale exchange (public copies of the numerator,
    int8 noise from the same U[0,1) block) runs and matches the
    reference's; ``use_pallas`` changes nothing on it, in either package.
    ``silent``: client 1 sends nothing (its column of ``sent`` zero, its
    mass kept), so its public copy stays bit for bit."""
    jargs, targs = _stale_args(4, 100, "float32")
    if silent:
        kept, sent = targs[2].clone(), targs[3].clone()
        kept[1] += sent[:, 1].sum()
        sent[:, 1] = 0.0
        targs[2:4] = kept, sent
        jargs[2:4] = jnp.asarray(kept.numpy()), jnp.asarray(sent.numpy())
    rng = np.random.default_rng(4)
    pub = (0.9 * rng.standard_normal((4, 100))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.uniform(key, (4, 100)))
    want = jax_gossip.stale_mix_apply(
        *jargs, use_pallas=use_pallas, interpret=True,
        compress=JaxCompressionSpec(mode=mode), ef_state=jnp.asarray(pub),
        key=key)
    got = gossip.stale_mix_apply(
        *targs, use_pallas=use_pallas,
        compress=CompressionSpec(mode=mode), ef_state=torch.tensor(pub),
        noise=torch.tensor(noise))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **CLOSE)
    np.testing.assert_array_equal(_np(got[4]), _np(want[4]))
    if silent:
        np.testing.assert_array_equal(_np(got[4])[1], pub[1])


def test_stale_mix_apply_is_one_round_of_the_oracle():
    """From an empty buffer of depth 1, one application equals one round of
    stale_gossip_reference (float64 oracle, f32 grade)."""
    rng = np.random.default_rng(7)
    z0, w0 = rng.standard_normal((5, 40)), rng.uniform(0.5, 1.5, 5)
    P = gossip.mix_matrix("pushsum", 1, 5, active=[1, 0, 1, 1, 1])
    kept, sent = gossip.stale_mix_split(P)
    z, w, bt, bw = gossip.stale_gossip_reference(z0, w0, [P], 1)
    f32 = dict(dtype=torch.float32)
    got = gossip.stale_mix_apply(
        torch.tensor(z0, **f32), torch.tensor(w0, **f32), kept, sent,
        torch.zeros(5, 40), torch.zeros(5))
    for g, want in zip(got, (z, bt[0], w, bw[0])):
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# engine parity with the JAX engine, dropout on, mail in flight


def _export(eng, state):
    """The reference engine's state as numpy: a per-client list, wrapped
    with both buffers on the stale async backend."""
    clients = [jax.tree_util.tree_map(np.asarray, s)
               for s in eng.export_states(state)]
    if isinstance(state, dict) and "stale_theta" in state:
        return {"clients": clients,
                "stale_theta": np.asarray(state["stale_theta"]),
                "stale_w": np.asarray(state["stale_w"])}
    return clients


def _to_port(state):
    if isinstance(state, dict):
        return convert.async_state_from_numpy(state)
    return [convert.state_from_numpy(s) for s in state]


def _federation(backend: str, staleness: int):
    x, y = make_classification_data(jax.random.PRNGKey(0), K * N_PER, SHAPE,
                                    N_CLASSES, sep=2.0)
    jdata = [(x[i * N_PER:(i + 1) * N_PER], y[i * N_PER:(i + 1) * N_PER])
             for i in range(K)]
    jv = jax_vision("mlp")
    jspec = JaxModelSpec("mlp", lambda k: jv.init(k, SHAPE, N_CLASSES),
                         jv.apply)
    knobs = dict(n_clients=K, rounds=ROUNDS, local_steps=1, batch_size=B,
                 use_pallas=True, staleness=staleness, dropout_rate=0.25)
    ref = jax_engine.dml_engine(
        (jspec,) * K, jspec,
        JaxProxyFLConfig(dp=JaxDPConfig(enabled=True), **knobs),
        backend=backend)
    q = B / N_PER
    jaccs = [JaxAccountant(1.0, q, 1e-5) for _ in range(K)]
    ref.attach_accountants(jaccs)
    base = jax.random.PRNGKey(0)
    jstate = ref.init_states(base)
    jstates, jmetrics = [_export(ref, jstate)], []
    for t in range(ROUNDS):
        jstate, m = ref.run_round(jstate, jdata, t,
                                  jax_engine.round_key(base, t))
        jstates.append(_export(ref, jstate))
        jmetrics.append({k: np.asarray(v) for k, v in m.items()})
    first = jstates[0]["clients"] if staleness else jstates[0]
    theta_like = first[0]["proxy"]["params"]

    def draws(k, t, s):
        """The reference's batch indices and DP noise of client k's local
        step s in round t."""
        ck = jax.random.fold_in(jax_engine.round_key(base, t), k)
        for _ in range(s + 1):
            ck, kb, kn = jax.random.split(ck, 3)
        idx = jax.random.randint(kb, (B,), 0, N_PER)
        return np.asarray(idx), np.asarray(_flat_gaussian_like(theta_like, kn))

    tv = get_vision_model("mlp")
    tspec = ModelSpec("mlp", lambda g: tv.init(g, SHAPE, N_CLASSES), tv.apply)
    tcfg = ProxyFLConfig(dp=DPConfig(enabled=True), **knobs)
    port = engine.dml_engine((tspec,) * K, tspec, tcfg, backend=backend,
                             device="cpu", draws=draws)
    taccs = [PrivacyAccountant(1.0, q, 1e-5) for _ in range(K)]
    port.attach_accountants(taccs)
    tdata = [(torch.as_tensor(np.array(a)), torch.as_tensor(np.array(b)))
             for a, b in jdata]
    tstate, tmetrics = port.run_rounds(_to_port(jstates[0]), tdata, 0,
                                       ROUNDS, seed=0)
    # a second run from the reference's state after two rounds: with τ = 2
    # both of its rounds consume mail sent before it started
    port.attach_accountants([None] * K)
    resumed, _ = port.run_rounds(_to_port(jstates[2]), tdata, 2, ROUNDS - 2,
                                 seed=0)
    masks = [engine.active_mask(t, K, tcfg) for t in range(ROUNDS)]
    return dict(jstate=jstates[-1], tstate=tstate, resumed=resumed,
                jaccs=jaccs, taccs=taccs, jmetrics=jmetrics,
                tmetrics=tmetrics, masks=masks, port=port)


@pytest.fixture(scope="module")
def async_runs():
    return _federation("async", TAU)


@pytest.fixture(scope="module")
def sync_runs():
    return _federation("vmap", 0)


RUNS = ["async_runs", "sync_runs"]


def _clients(state):
    return state["clients"] if isinstance(state, dict) else state


@pytest.mark.parametrize("runs", RUNS)
def test_the_seed_drops_clients(request, runs):
    r = request.getfixturevalue(runs)
    assert any(m is not None and not m.all() for m in r["masks"])


@pytest.mark.parametrize("runs", RUNS)
@pytest.mark.parametrize("which", ["tstate", "resumed"])
@pytest.mark.parametrize("role", ["private", "proxy"])
def test_params_and_moments_close(request, runs, which, role):
    r = request.getfixturevalue(runs)
    for ours, theirs in zip(_clients(r[which]), _clients(r["jstate"])):
        o, t = ours[role], theirs[role]
        for a_tree, b_tree in ((o["params"], t["params"]),
                               (o["opt"].m, t["opt"].m),
                               (o["opt"].v, t["opt"].v)):
            for a, b in zip(tree_leaves(a_tree),
                            jax.tree_util.tree_leaves(b_tree)):
                np.testing.assert_allclose(a.numpy(), b, **CLOSE)
        assert int(o["opt"].t) == int(t["opt"].t)


@pytest.mark.parametrize("runs", RUNS)
@pytest.mark.parametrize("which", ["tstate", "resumed"])
def test_debias_weights_close(request, runs, which):
    r = request.getfixturevalue(runs)
    ours = np.asarray([float(s["w"]) for s in _clients(r[which])])
    theirs = np.asarray([float(s["w"]) for s in _clients(r["jstate"])])
    np.testing.assert_allclose(ours, theirs, **CLOSE)


@pytest.mark.parametrize("which", ["tstate", "resumed"])
def test_in_flight_buffers_close(async_runs, which):
    ours, theirs = async_runs[which], async_runs["jstate"]
    assert tuple(ours["stale_theta"].shape) == theirs["stale_theta"].shape
    assert np.abs(theirs["stale_w"]).sum() > 0   # mail really in flight
    for key in ("stale_theta", "stale_w"):
        np.testing.assert_allclose(ours[key].numpy(), theirs[key], **CLOSE)


@pytest.mark.parametrize("runs", RUNS)
def test_epsilon_exact(request, runs):
    r = request.getfixturevalue(runs)
    assert [a.epsilon() for a in r["taccs"]] == \
        [a.epsilon() for a in r["jaccs"]]
    steps = [sum(m is None or bool(m[k]) for m in r["masks"])
             for k in range(K)]
    assert [a.steps for a in r["taccs"]] == steps
    assert min(steps) < ROUNDS   # a dropped client took fewer steps


@pytest.mark.parametrize("runs", RUNS)
def test_metrics_nan_where_reference_is(request, runs):
    r = request.getfixturevalue(runs)
    ours = r["tmetrics"]
    assert sorted(ours) == sorted(r["jmetrics"][0])
    for key in ours:
        want = np.stack([m[key] for m in r["jmetrics"]])
        assert ours[key].shape == (ROUNDS, K)
        np.testing.assert_array_equal(np.isnan(ours[key]), np.isnan(want))
        assert np.isnan(want).any()
        np.testing.assert_allclose(ours[key], want, **CLOSE)


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


def test_async_tau0_equals_sync_bitwise():
    spec, data, cfg = _port_setup(rounds=3, dropout_rate=0.25,
                                  use_pallas=True, staleness=0,
                                  dp=DPConfig(enabled=True))
    out = []
    for backend in ("async", "vmap"):
        eng = engine.dml_engine((spec,) * K, spec, cfg, backend=backend,
                                device="cpu")
        state, _ = eng.run_rounds(eng.init_states(0), data, 0, 3, seed=0)
        assert isinstance(state, list)   # τ = 0: no buffer, no wrapper
        out.append(tree_leaves(state))
    assert len(out[0]) == len(out[1])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_async_stale_mass_conserved_engine_level():
    """τ = 2 with §3.4 dropout, lr = 0 to isolate the exchange: total raw
    PushSum mass Σ z·w and total de-bias weight, clients plus the in-flight
    buffer, are conserved every round (the twin of
    tests/test_conformance.py::test_async_stale_mass_conserved_engine_level,
    same masks)."""
    spec, data, cfg = _port_setup(rounds=4, lr=0.0, staleness=2,
                                  dp=DPConfig(enabled=False))
    eng = engine.dml_engine((spec,) * K, spec, cfg, backend="async",
                            device="cpu")
    state = eng.init_states(0)

    def masses(st):
        z = torch.stack([tree_flatten_vector(s["proxy"]["params"])
                         for s in st["clients"]]).double()
        w = torch.stack([s["w"] for s in st["clients"]]).double()
        return (float((z * w[:, None]).sum() + st["stale_theta"].sum()),
                float(w.sum() + st["stale_w"].sum()))

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


def test_ring_mix_refused_at_positive_staleness():
    spec, _, cfg = _port_setup(staleness=2)
    with pytest.raises(ValueError, match="ring"):
        engine.dml_engine((spec,) * K, spec, cfg, backend="async",
                          mix="ring", device="cpu")
    tau0 = ProxyFLConfig(n_clients=K, staleness=0)
    eng = engine.dml_engine((spec,) * K, spec, tau0, backend="async",
                            mix="ring", device="cpu")
    assert eng.staleness == 0
    with pytest.raises(ValueError, match="staleness"):
        engine.dml_engine((spec,) * K, spec,
                          ProxyFLConfig(n_clients=K, staleness=-1),
                          backend="async", device="cpu")


def test_run_federated_async_with_dropout_on_cpu():
    spec, data, cfg = _port_setup(rounds=3, staleness=2, dropout_rate=0.25,
                                  use_pallas=True, dp=DPConfig(enabled=True))
    res = run_federated("proxyfl", [spec] * K, spec, data, data[0], cfg,
                        backend="async", device="cpu")
    assert [row["round"] for row in res["history"]] == [1, 2, 3]
    assert len(res["clients"]) == K
    for c in res["clients"]:
        assert all(torch.isfinite(x).all() for x in
                   tree_leaves(c.proxy_params))
        assert 0.0 < c.w
    eps = res["epsilon"]
    assert all(e is not None and e > 0 for e in eps)

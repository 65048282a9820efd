"""The DP, data and protocol remainders of the port against the JAX
package's functions, on the same numpy inputs with the reference's draws
injected (its Bernoulli selection, its DP noise, its batch indices).

* ``data/loader.py``: ``poisson_batch`` (the reference's selection fed in;
  selected examples first in a stable order), ``expected_batch``,
  ``steps_per_epoch``; ``data/synthetic.py::lm_examples``.
* ``core/dp.py``: ``dp_gradient_poisson``; ``dp_gradient(vectorized=True)``
  (no kernel, whatever ``use_pallas`` says); ``microbatch = 2`` units on
  ``dp_gradient`` (plain and kernel paths) and ``dp_adam_update``;
  ``dp_adam_update``'s fallback on bf16 params (their f32 master copy)
  and bf16 moments.
* ``core/protocol.py``: ``init_client``, ``local_round``,
  ``gossip_proxies`` and ``proxyfl_round`` against the JAX functions on
  the reference's draws, and ``local_round`` / ``proxyfl_round`` bit for
  bit against the port's own engine round.

Grades: f32 at the conformance ``close`` grade (atol 1e-5, rtol 1e-4),
bf16 at 2e-2 (``tests/test_kernels.py``'s), epsilon exactly. Sizes: mlp on
14x14x1 images, 10 classes, B = 8, K = 4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import DPConfig as JaxDPConfig  # noqa: E402
from repro.configs.base import ProxyFLConfig as JaxProxyFLConfig  # noqa: E402
from repro.core import dp as jax_dp  # noqa: E402
from repro.core import protocol as jax_protocol  # noqa: E402
from repro.data import loader as jax_loader  # noqa: E402
from repro.data.synthetic import lm_examples as jax_lm_examples  # noqa: E402
from repro.nn.losses import cross_entropy as jax_ce  # noqa: E402
from repro.nn.losses import dml_loss as jax_dml_loss  # noqa: E402
from repro.nn.vision import get_vision_model as jax_vision  # noqa: E402
from repro.optim.optimizers import Adam as JaxAdam  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import DPConfig, ProxyFLConfig  # noqa: E402
from repro_torch.core import dp, protocol  # noqa: E402
from repro_torch.core.engine import dml_engine, stream_seed  # noqa: E402
from repro_torch.data import loader  # noqa: E402
from repro_torch.data.synthetic import lm_examples  # noqa: E402
from repro_torch.nn.losses import cross_entropy, dml_loss  # noqa: E402
from repro_torch.nn.modules import tree_leaves, tree_map  # noqa: E402
from repro_torch.nn.vision import get_vision_model  # noqa: E402
from repro_torch.optim import Adam, AdamState  # noqa: E402

CLOSE = dict(atol=1e-5, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
SHAPE, N_CLASSES, B, K, N_PER = (14, 14, 1), 10, 8, 4, 48
DP = dict(clip_norm=0.5, noise_multiplier=1.0)
JV, TV = jax_vision("mlp"), get_vision_model("mlp")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_port(tree):
    return convert.params_from_numpy(_np_tree(tree))


def _close(ours, theirs, tol=CLOSE):
    lo, lt = tree_leaves(ours), jax.tree_util.tree_leaves(theirs)
    assert len(lo) == len(lt)
    for a, b in zip(lo, lt):
        a = a.detach().to(torch.float32).numpy()
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **tol)


@pytest.fixture(scope="module")
def setup():
    theta = JV.init(jax.random.PRNGKey(1), SHAPE, N_CLASSES)
    phi = JV.init(jax.random.PRNGKey(2), SHAPE, N_CLASSES)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B,) + SHAPE, dtype=np.float32)
    y = rng.integers(0, N_CLASSES, B)

    def jax_loss(t, b):
        return jax_dml_loss(JV.apply(t, b[0]), JV.apply(phi, b[0]), b[1], 0.5)

    phi_t = _to_port(phi)

    def torch_loss(t, b):
        return dml_loss(TV.apply(t, b[0]), TV.apply(phi_t, b[0]), b[1], 0.5)

    return dict(theta=theta, jax_loss=jax_loss, torch_loss=torch_loss,
                jbatch=(jnp.asarray(x), jnp.asarray(y)),
                tbatch=(torch.as_tensor(x), torch.as_tensor(y)))


def _noise(params, key):
    return torch.as_tensor(np.array(jax_dp._flat_gaussian_like(params, key)))


# ---------------------------------------------------------------------------
# data


@pytest.mark.parametrize("n,q,max_batch", [(40, 0.2, 12), (40, 0.2, 4),
                                           (17, 0.9, 20), (30, 0.0, 5)])
def test_poisson_batch_matches_the_reference(n, q, max_batch):
    key = jax.random.PRNGKey(n)
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    y = np.arange(n) % 7
    jx, jy, jm = jax_loader.poisson_batch(key, jnp.asarray(x), jnp.asarray(y),
                                          q, max_batch)
    sel = np.asarray(jax.random.bernoulli(key, q, (n,)))
    tx, ty, tm = loader.poisson_batch(None, torch.as_tensor(x),
                                      torch.as_tensor(y), q, max_batch,
                                      selected=sel)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tm.dtype == torch.float32
    # the selected examples lead, in index order
    n_sel = int(min(sel.sum(), max_batch))
    assert tm[:n_sel].sum() == n_sel and tm[n_sel:].sum() == 0
    np.testing.assert_array_equal(tx[:n_sel, 0].numpy() / 3,
                                  np.flatnonzero(sel)[:n_sel])


def test_poisson_batch_draws_from_the_generator():
    x, y = torch.arange(200.0)[:, None], torch.arange(200)
    draw = lambda: loader.poisson_batch(  # noqa: E731
        torch.Generator().manual_seed(4), x, y, 0.25, 80)
    (a, _, ma), (b, _, mb) = draw(), draw()
    assert torch.equal(a, b) and torch.equal(ma, mb)
    assert 20 < int(ma.sum()) < 80


@pytest.mark.parametrize("n,batch", [(1000, 250), (1001, 250), (3, 8),
                                     (0, 8), (64, 64)])
def test_batch_counts_match_the_reference(n, batch):
    assert loader.steps_per_epoch(n, batch) == jax_loader.steps_per_epoch(
        n, batch)
    q = batch / max(n, 1)
    assert loader.expected_batch(q, n) == jax_loader.expected_batch(q, n)


def test_lm_examples_match_the_reference():
    stream = np.arange(103, dtype=np.int32)
    jx, jy = jax_lm_examples(jnp.asarray(stream), 10)
    tx, ty = lm_examples(torch.as_tensor(stream), 10)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


# ---------------------------------------------------------------------------
# core/dp.py


def test_dp_gradient_poisson(setup):
    key, q, max_batch = jax.random.PRNGKey(7), 0.5, B
    sel = np.zeros(B, bool)
    sel[[0, 3, 4, 6]] = True
    mask = sel.astype(np.float32)
    jg, jm = jax_dp.dp_gradient_poisson(
        setup["jax_loss"], setup["theta"], setup["jbatch"], jnp.asarray(mask),
        key, expected_batch=q * max_batch, **DP)
    tg, tm = dp.dp_gradient_poisson(
        setup["torch_loss"], _to_port(setup["theta"]), setup["tbatch"],
        torch.as_tensor(mask), expected_batch=q * max_batch,
        noise=_noise(setup["theta"], key), **DP)
    _close(tg, jg)
    for k in ("loss", "mean_grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **CLOSE)


@pytest.mark.parametrize("microbatch", [1, 2])
def test_dp_gradient_vectorized(setup, microbatch):
    key = jax.random.PRNGKey(8)
    jg, jm = jax_dp.dp_gradient(setup["jax_loss"], setup["theta"],
                                setup["jbatch"], key, vectorized=True,
                                microbatch=microbatch, **DP)
    params = _to_port(setup["theta"])
    kw = dict(noise=_noise(setup["theta"], key), vectorized=True,
              microbatch=microbatch, **DP)
    tg, tm = dp.dp_gradient(setup["torch_loss"], params, setup["tbatch"],
                            **kw)
    _close(tg, jg)
    for k in ("loss", "mean_grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **CLOSE)
    # use_pallas changes nothing: the vectorized mode launches no kernel
    tg2, _ = dp.dp_gradient(setup["torch_loss"], params, setup["tbatch"],
                            use_pallas=True, **kw)
    for a, b in zip(tree_leaves(tg), tree_leaves(tg2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_dp_gradient_microbatch_units(setup, use_pallas):
    key = jax.random.PRNGKey(9)
    jg, jm = jax_dp.dp_gradient(setup["jax_loss"], setup["theta"],
                                setup["jbatch"], key, microbatch=2,
                                use_pallas=use_pallas, interpret=True, **DP)
    tg, tm = dp.dp_gradient(setup["torch_loss"], _to_port(setup["theta"]),
                            setup["tbatch"],
                            noise=_noise(setup["theta"], key), microbatch=2,
                            use_pallas=use_pallas, **DP)
    _close(tg, jg)
    for k in ("loss", "mean_grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **CLOSE)
    with pytest.raises(ValueError, match="microbatch"):
        dp.dp_gradient(setup["torch_loss"], _to_port(setup["theta"]),
                       setup["tbatch"], noise=_noise(setup["theta"], key),
                       microbatch=3, **DP)


def test_dp_adam_update_microbatch_units(setup):
    key = jax.random.PRNGKey(10)
    jopt, opt = JaxAdam(lr=1e-3, weight_decay=1e-4), Adam(lr=1e-3,
                                                          weight_decay=1e-4)
    jp, js, jm = jax_dp.dp_adam_update(
        setup["jax_loss"], setup["theta"], jopt.init(setup["theta"]),
        setup["jbatch"], key, opt=jopt, microbatch=2, interpret=True, **DP)
    tp0 = _to_port(setup["theta"])
    tp, ts, tm = dp.dp_adam_update(
        setup["torch_loss"], tp0, opt.init(tp0), setup["tbatch"], opt=opt,
        noise=_noise(setup["theta"], key), microbatch=2, **DP)
    _close((tp, ts.m, ts.v), (jp, js.m, js.v))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **CLOSE)


@pytest.mark.parametrize("case", ["bf16_params", "bf16_moments",
                                  "bf16_both"])
def test_dp_adam_update_on_non_f32_state(setup, case):
    """The reference's fallback: bf16 params train through their f32
    master copy ``p32``; bf16 moments are stored rounded. Two steps from
    the same state and draws, at bf16 2e-2 (f32 leaves at ``close``)."""
    p_dtype = jnp.bfloat16 if case != "bf16_moments" else jnp.float32
    m_dtype = "bfloat16" if case != "bf16_params" else "float32"
    x, y = setup["jbatch"]

    def jax_loss(p, b):
        p = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), p)
        return jax_ce(JV.apply(p, b[0]), b[1])

    def torch_loss(p, b):
        return cross_entropy(TV.apply(tree_map(lambda a: a.float(), p),
                                      b[0]), b[1])

    jopt = JaxAdam(lr=1e-2, weight_decay=1e-4, moment_dtype=m_dtype)
    opt = Adam(lr=1e-2, weight_decay=1e-4, moment_dtype=m_dtype)
    jp = jax.tree_util.tree_map(lambda a: a.astype(p_dtype), setup["theta"])
    js = jopt.init(jp)
    tp = _to_port(jp)
    ts = opt.init(tp)
    assert (ts.p32 is None) == (js.p32 is None) == (case == "bf16_moments")
    for step in range(2):
        key = jax.random.PRNGKey(20 + step)
        jp, js, jm = jax_dp.dp_adam_update(jax_loss, jp, js, (x, y), key,
                                           opt=jopt, interpret=True, **DP)
        tp, ts, tm = dp.dp_adam_update(
            torch_loss, tp, ts, setup["tbatch"], opt=opt,
            noise=_noise(setup["theta"], key), **DP)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **CLOSE)
    assert {a.dtype for a in tree_leaves(tp)} == {
        torch.bfloat16 if case != "bf16_moments" else torch.float32}
    assert int(ts.t) == int(js.t) == 2
    _close((tp, ts.m, ts.v), (jp, js.m, js.v), BF16)
    if ts.p32 is not None:
        _close(ts.p32, js.p32, BF16)


# ---------------------------------------------------------------------------
# core/protocol.py


def _cfgs(**kw):
    base = dict(n_clients=K, local_steps=2, batch_size=B, lr=1e-3,
                weight_decay=1e-4)
    return (ProxyFLConfig(dp=DPConfig(enabled=True), **base, **kw),
            JaxProxyFLConfig(dp=JaxDPConfig(enabled=True), **base, **kw))


@pytest.fixture(scope="module")
def cohort():
    """K JAX clients from ``init_client``, their data, and the port's
    ClientStates carrying the same numbers."""
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((K, N_PER) + SHAPE, dtype=np.float32)
    ys = rng.integers(0, N_CLASSES, (K, N_PER))
    jspec = jax_protocol.ModelSpec(
        "mlp", lambda k: JV.init(k, SHAPE, N_CLASSES), JV.apply)
    tspec = protocol.ModelSpec(
        "mlp", lambda g: TV.init(g, SHAPE, N_CLASSES), TV.apply)
    _, jcfg = _cfgs()
    jclients = [jax_protocol.init_client(jax.random.PRNGKey(30 + k), jspec,
                                         jspec, jcfg, N_PER)
                for k in range(K)]
    return dict(jspec=jspec, tspec=tspec, jclients=jclients,
                jdata=[(jnp.asarray(xs[k]), jnp.asarray(ys[k]))
                       for k in range(K)],
                tdata=[(torch.as_tensor(xs[k]), torch.as_tensor(ys[k]))
                       for k in range(K)])


def _port_client(jc, cfg):
    """A port ClientState holding a JAX ClientState's numbers (a fresh
    accountant of the same rate and steps)."""
    opt = lambda s: AdamState(_to_port(s.m), _to_port(s.v),  # noqa: E731
                              torch.tensor(int(s.t), dtype=torch.int32))
    acc = None
    if jc.accountant is not None:
        acc = protocol.PrivacyAccountant(jc.accountant.noise_multiplier,
                                         jc.accountant.sample_rate,
                                         jc.accountant.delta)
        acc.steps = jc.accountant.steps
    return protocol.ClientState(_to_port(jc.private_params),
                                opt(jc.private_opt),
                                _to_port(jc.proxy_params), opt(jc.proxy_opt),
                                float(jc.w), acc)


def _copy_jax_client(jc):
    return dataclasses.replace(
        jc, accountant=None if jc.accountant is None
        else dataclasses.replace(jc.accountant))


def _assert_clients_close(tcs, jcs, tol=CLOSE):
    for tc, jc in zip(tcs, jcs):
        _close((tc.private_params, tc.proxy_params, tc.private_opt.m,
                tc.proxy_opt.m, tc.proxy_opt.v),
               (jc.private_params, jc.proxy_params, jc.private_opt.m,
                jc.proxy_opt.m, jc.proxy_opt.v), tol)
        np.testing.assert_allclose(tc.w, float(jc.w), **CLOSE)
        if jc.accountant is not None:
            assert tc.accountant.steps == jc.accountant.steps
            assert tc.accountant.epsilon() == jc.accountant.epsilon()


def _key_draws(key_of_client, theta_like):
    """The reference's (batch idx, DP noise) of a step: ``split(key, 3)``
    once per step from the client's key, ``randint`` and
    ``_flat_gaussian_like``, as ``repro.core.protocol.local_round`` and
    the loop engine draw them."""
    def draws(k, t, s):
        key = key_of_client(k)
        for _ in range(s + 1):
            key, kb, kn = jax.random.split(key, 3)
        idx = jax.random.randint(kb, (B,), 0, N_PER)
        return np.asarray(idx), np.asarray(_flat_noise(theta_like, kn))
    return draws


def _flat_noise(like, key):
    return jax_dp._flat_gaussian_like(like, key)


def test_init_client_matches_the_reference_layout(cohort):
    cfg, jcfg = _cfgs()
    tc = protocol.init_client(torch.Generator().manual_seed(0),
                              cohort["tspec"], cohort["tspec"], cfg, N_PER,
                              device="cpu")
    jc = cohort["jclients"][0]
    for ours, theirs in ((tc.private_params, jc.private_params),
                         (tc.proxy_opt.m, jc.proxy_opt.m)):
        lo, lt = tree_leaves(ours), jax.tree_util.tree_leaves(theirs)
        assert [tuple(a.shape) for a in lo] == [b.shape for b in lt]
    assert int(tc.proxy_opt.t) == int(jc.proxy_opt.t) == 0
    assert tc.w == jc.w == 1.0
    assert tc.accountant.sample_rate == jc.accountant.sample_rate == B / N_PER
    assert protocol.init_client(torch.Generator(), cohort["tspec"],
                                cohort["tspec"], dataclasses.replace(
                                    cfg, dp=DPConfig(enabled=False)),
                                N_PER, device="cpu").accountant is None


def test_init_client_draws_the_engines_values_on_its_device(cohort):
    """From a CPU generator seeded as the engine seeds client k, the
    client's params and Adam states are the engine's initial state, bit
    for bit; the device defaults to CUDA, which this CPU build refuses."""
    cfg, _ = _cfgs()
    eng = dml_engine((cohort["tspec"],) * K, cohort["tspec"], cfg,
                     backend="loop", device="cpu")
    want = eng.init_states(9)[2]
    tc = protocol.init_client(torch.Generator().manual_seed(
        stream_seed(9, 2)), cohort["tspec"], cohort["tspec"], cfg, N_PER,
        device="cpu")
    got = (tc.private_params, tc.private_opt, tc.proxy_params, tc.proxy_opt)
    exp = (want["private"]["params"], want["private"]["opt"],
           want["proxy"]["params"], want["proxy"]["opt"])
    for a, b in zip(tree_leaves(got), tree_leaves(exp)):
        assert a.device.type == "cpu" and torch.equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            protocol.init_client(torch.Generator(), cohort["tspec"],
                                 cohort["tspec"], cfg, N_PER)


def test_local_round_matches_the_reference(cohort):
    cfg, jcfg = _cfgs()
    jc = _copy_jax_client(cohort["jclients"][1])
    tc = _port_client(jc, cfg)
    key = jax.random.PRNGKey(40)
    jm = jax_protocol.local_round(jc, (cohort["jspec"],) * 2,
                                  cohort["jdata"][1], key, jcfg)
    draws = _key_draws(lambda k: key, jc.proxy_params)
    tm = protocol.local_round(tc, (cohort["tspec"],) * 2, cohort["tdata"][1],
                              0, cfg, k=1, draws=draws)
    assert sorted(tm) == sorted(jm)
    for name in tm:
        np.testing.assert_allclose(tm[name], jm[name], **CLOSE)
    _assert_clients_close([tc], [jc])


def test_local_round_is_the_engines_client_step(cohort):
    """Without a hook, client k's local round draws the engine's streams:
    bit-equal to the engine's round with the exchange off."""
    cfg, _ = _cfgs(use_pallas=True)
    tc = _port_client(cohort["jclients"][2], cfg)
    eng = dml_engine((cohort["tspec"],) * K, cohort["tspec"], cfg,
                     mix="none", device="cpu")
    states = [{"private": {"params": tc.private_params,
                           "opt": tc.private_opt},
               "proxy": {"params": tc.proxy_params, "opt": tc.proxy_opt},
               "w": torch.tensor(1.0)}] * K
    out, _ = eng.run_round(states, cohort["tdata"], 3, 11)
    protocol.local_round(tc, (cohort["tspec"],) * 2, cohort["tdata"][2], 3,
                         cfg, seed=11, k=2)
    want = out[2]
    for a, b in zip(tree_leaves((tc.private_params, tc.proxy_params,
                                 tc.proxy_opt)),
                    tree_leaves((want["private"]["params"],
                                 want["proxy"]["params"],
                                 want["proxy"]["opt"]))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_gossip_proxies_matches_the_reference(cohort, use_pallas):
    cfg, jcfg = _cfgs(use_pallas=use_pallas)
    jcs = [_copy_jax_client(c) for c in cohort["jclients"]]
    jcs[1].w = 0.5   # a client whose mass is not 1
    tcs = [_port_client(c, cfg) for c in jcs]
    active = np.array([True, False, True, True])
    for t in range(3):
        jax_protocol.gossip_proxies(jcs, t, jcfg, active=active if t else
                                    None)
        protocol.gossip_proxies(tcs, t, cfg, active=active if t else None)
    for tc, jc in zip(tcs, jcs):
        _close(tc.proxy_params, jc.proxy_params)
        np.testing.assert_allclose(tc.w, float(jc.w), **CLOSE)
    # the de-bias mass is conserved
    np.testing.assert_allclose(sum(c.w for c in tcs), 3.5, rtol=1e-6)


def test_proxyfl_round_matches_the_reference(cohort):
    cfg, jcfg = _cfgs()
    jcs = [_copy_jax_client(c) for c in cohort["jclients"]]
    tcs = [_port_client(c, cfg) for c in jcs]
    key = jax.random.PRNGKey(50)
    pairs_j = [(cohort["jspec"],) * 2] * K
    pairs_t = [(cohort["tspec"],) * 2] * K
    jm = jax_protocol.proxyfl_round(jcs, pairs_j, cohort["jdata"], 1, key,
                                    jcfg)
    draws = _key_draws(lambda k: jax.random.fold_in(key, k),
                       jcs[0].proxy_params)
    tm = protocol.proxyfl_round(tcs, pairs_t, cohort["tdata"], 1, cfg,
                                draws=draws)
    for a, b in zip(tm, jm):
        assert sorted(a) == sorted(b)
        for name in a:
            np.testing.assert_allclose(a[name], b[name], **CLOSE)
    _assert_clients_close(tcs, jcs)


def test_proxyfl_round_is_the_engines_round(cohort):
    """On the port's own streams: one ``proxyfl_round`` is bit for bit the
    loop engine's round over the same states, dropout included."""
    cfg, _ = _cfgs(dropout_rate=0.5, seed=2)
    tcs = [_port_client(c, cfg) for c in cohort["jclients"]]
    states = [{"private": {"params": c.private_params, "opt": c.private_opt},
               "proxy": {"params": c.proxy_params, "opt": c.proxy_opt},
               "w": torch.tensor(c.w)} for c in tcs]
    eng = dml_engine((cohort["tspec"],) * K, cohort["tspec"], cfg,
                     backend="loop", device="cpu")
    want, metrics = eng.run_round(states, cohort["tdata"], 4, 7)
    got = protocol.proxyfl_round(tcs, [(cohort["tspec"],) * 2] * K,
                                 cohort["tdata"], 4, cfg, seed=7)
    assert np.isnan([m["private_loss"] for m in got]).sum() == \
        np.isnan(metrics["private_loss"]).sum()
    for c, s in zip(tcs, want):
        assert c.w == float(s["w"])
        for a, b in zip(tree_leaves((c.private_params, c.proxy_params)),
                        tree_leaves((s["private"]["params"],
                                     s["proxy"]["params"]))):
            assert torch.equal(a, b)

"""The port's stacked executor on the CPU: the client-grid routes of the DP
kernels, the vmapped client step against the loop, and the stacked round
against the JAX engine's ``vmap`` backend.

* The client-grid plain versions (``clip_accumulate_rows_clients``,
  ``noise_adam_step_clients``) and the ``torch.func.vmap`` rules of
  ``sumsq_rows``, ``clip_accumulate_rows``, ``scale_accumulate`` and
  ``noise_adam_step`` are bit-equal to K flat plain calls.
* Port ``vmap`` against port ``loop`` in lockstep (both rounds from the
  same state, every round): the reference's conformance ``close`` grade
  (tests/test_conformance.py), every method, with and without §3.4
  dropout, ragged epoch mode included; epsilon exact.
* The stacked round against ``repro.core.engine.dml_engine(...,
  backend="vmap")`` on a ragged cohort in epoch mode under dropout, from
  the reference's initial state and on its draws (the replay machinery of
  tests/test_torch_slice.py, the batch drawn below each client's own
  length): ``close``; epsilon exact.

K ≤ 4, a 14x14x1 mlp, batches of 8 to 16, two rounds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
from torch.func import vmap  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import DPConfig, ProxyFLConfig  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.baselines import METHODS, run_federated  # noqa: E402
from repro_torch.core.protocol import ModelSpec  # noqa: E402
from repro_torch.data.synthetic import make_classification_data  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402
from repro_torch.nn.vision import get_vision_model  # noqa: E402

K, N_CLASSES, SHAPE = 4, 10, (14, 14, 1)
CLOSE = dict(atol=1e-5, rtol=1e-4)
SIZES = (40, 25, 33, 17)      # a ragged cohort


def _spec():
    vm = get_vision_model("mlp")
    return ModelSpec("mlp", lambda g: vm.init(g, SHAPE, N_CLASSES), vm.apply)


def _data(sizes=SIZES, seed=0):
    x, y = make_classification_data(torch.Generator().manual_seed(seed),
                                    sum(sizes), SHAPE, N_CLASSES, sep=2.0)
    out, i = [], 0
    for n in sizes:
        out.append((x[i:i + n], y[i:i + n]))
        i += n
    return out


def _cfg(**kw):
    base = dict(n_clients=K, rounds=2, local_steps=2, batch_size=8,
                use_pallas=True, dp=DPConfig(enabled=True))
    base.update(kw)
    return ProxyFLConfig(**base)


# ---------------------------------------------------------------------------
# the client-grid routes


@pytest.mark.parametrize("Kc,B,D,dtype", [
    (1, 1, 1, torch.float32), (3, 7, 1_025, torch.float32),
    (4, 5, 33, torch.bfloat16), (8, 16, 200, torch.float32)])
def test_clip_accumulate_rows_clients_is_k_flat_calls(Kc, B, D, dtype):
    g = torch.randn(Kc, B, D + 3)[:, :, :D].to(dtype)
    s = torch.rand(Kc, B) + 0.01
    got = kernels.clip_accumulate_rows_clients(g, s)
    want = torch.stack([kernels.clip_accumulate_rows(g[k], s[k])
                        for k in range(Kc)])
    assert torch.equal(got, want)
    assert torch.equal(ref.clip_accumulate_rows_clients_ref(g, s), want)
    assert torch.equal(vmap(kernels.clip_accumulate_rows)(g, s), want)
    assert torch.equal(vmap(kernels.sumsq_rows)(g), torch.stack(
        [kernels.sumsq_rows(g[k]) for k in range(Kc)]))


@pytest.mark.parametrize("Kc,D", [(1, 1), (3, 5), (4, 1_025), (8, 200)])
def test_noise_adam_step_clients_is_k_flat_calls(Kc, D):
    acc, noise, p, m = (torch.randn(Kc, D) for _ in range(4))
    v = torch.rand(Kc, D)
    t = torch.arange(1, Kc + 1, dtype=torch.float32)
    c1, c2 = 1 - 0.9 ** t, 1 - 0.999 ** t
    hp = dict(stddev=1.0, n_units=8, lr=1e-3, weight_decay=1e-4)
    got = kernels.noise_adam_step_clients(acc, noise, p, m, v, c1=c1,
                                          c2=c2, **hp)
    flat = [kernels.noise_adam_step(acc[k], noise[k], p[k], m[k], v[k],
                                    c1=c1[k], c2=c2[k], **hp)
            for k in range(Kc)]
    vm = vmap(lambda a, n, pp, mm, vv, x1, x2: kernels.noise_adam_step(
        a, n, pp, mm, vv, c1=x1, c2=x2, **hp))(acc, noise, p, m, v, c1, c2)
    for i in range(3):
        want = torch.stack([f[i] for f in flat])
        assert torch.equal(got[i], want) and torch.equal(vm[i], want)


def test_scale_accumulate_vmaps_to_its_vector_route():
    """One scale for the cohort (the DP noise add's): the 1-D route over
    the flattened [K·D], K flat calls bit for bit; a scale per client is
    refused."""
    acc, g = torch.randn(3, 50), torch.randn(3, 50)
    one = torch.tensor(0.7)
    got = vmap(kernels.scale_accumulate, in_dims=(0, 0, None))(acc, g, one)
    assert torch.equal(got, torch.stack(
        [kernels.scale_accumulate(acc[k], g[k], one) for k in range(3)]))
    with pytest.raises(ValueError, match="one scale"):
        vmap(kernels.scale_accumulate)(acc, g, torch.rand(3))


@pytest.mark.parametrize("case", ["k=1 d mismatch", "bad c1", "2-D g",
                                  "short scales"])
def test_client_grid_routes_refuse_bad_shapes(case):
    with pytest.raises((TypeError, ValueError)):
        if case == "k=1 d mismatch":
            kernels.noise_adam_step_clients(
                *(torch.zeros(2, 3) for _ in range(4)), torch.zeros(2, 4),
                c1=torch.ones(2), c2=torch.ones(2), stddev=1.0, n_units=1,
                lr=0.1)
        elif case == "bad c1":
            kernels.noise_adam_step_clients(
                *(torch.zeros(2, 3) for _ in range(5)), c1=torch.ones(3),
                c2=torch.ones(2), stddev=1.0, n_units=1, lr=0.1)
        elif case == "2-D g":
            kernels.clip_accumulate_rows_clients(torch.zeros(2, 3),
                                                 torch.ones(2))
        else:
            kernels.clip_accumulate_rows_clients(torch.zeros(2, 3, 4),
                                                 torch.ones(2, 2))


# ---------------------------------------------------------------------------
# vmap against loop, in lockstep


def _engines(cfg, mix="pushsum", method="proxyfl"):
    spec = _spec()
    out = {}
    for backend in ("loop", "vmap"):
        if method in ("proxyfl", "fml"):
            out[backend] = engine.dml_engine((spec,) * K, spec, cfg,
                                             backend=backend, mix=mix,
                                             device="cpu")
        else:
            out[backend] = engine.single_model_engine(
                spec, cfg, cfg.dp.enabled, mix=mix, backend=backend,
                n_clients=K, device="cpu")
    assert not out["loop"].stacked and out["vmap"].stacked
    return out


def _assert_close(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if x.is_floating_point():
            torch.testing.assert_close(x, y, **CLOSE)
        else:
            assert torch.equal(x, y)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("dropout", [0.0, 0.4])
@pytest.mark.parametrize("local_steps", [2, 0])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_vmap_is_close_to_loop_round_by_round(ragged, dropout, local_steps,
                                              use_pallas):
    """Each round from the loop's state on both backends: the stacked
    round within ``close`` of the loop's (every leaf, w and metrics;
    dropped clients keep their state and report NaN); epsilon exact."""
    data = _data(SIZES if ragged else (32,) * K)
    cfg = _cfg(local_steps=local_steps, dropout_rate=dropout,
               use_pallas=use_pallas, min_active=2)
    engs = _engines(cfg)
    for e in engs.values():
        e.attach_accountants([engine_accountant(cfg, x.shape[0])
                              for x, _ in data])
    state = engs["loop"].init_states(0)
    for t in range(2):
        outs = {b: e.run_round(state, data, t, seed=3)
                for b, e in engs.items()}
        _assert_close(outs["vmap"][0], outs["loop"][0])
        for key, v in outs["loop"][1].items():
            np.testing.assert_allclose(outs["vmap"][1][key], v, **CLOSE)
        state = outs["loop"][0]
    assert [a.epsilon() for a in engs["vmap"].accountants] == \
        [a.epsilon() for a in engs["loop"].accountants]


def engine_accountant(cfg, n):
    from repro_torch.core.accountant import PrivacyAccountant
    return PrivacyAccountant(cfg.dp.noise_multiplier,
                             min(1.0, cfg.batch_size / n), cfg.dp.delta)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
@pytest.mark.parametrize("method", METHODS)
def test_every_method_vmap_close_to_loop(method, dropout):
    """``run_federated`` on both backends, 2 rounds of 2 steps (Joint: its
    pooled client's 8): params at ``close``, epsilon exact."""
    spec = _spec()
    data = _data((24,) * K)
    test = _data((30,), seed=1)[0]
    cfg = _cfg(dropout_rate=dropout, min_active=2)
    res = {b: run_federated(method, [spec] * K, spec, data, test, cfg,
                            seed=0, backend=b, device="cpu")
           for b in ("loop", "vmap")}
    assert res["vmap"]["epsilon"] == res["loop"]["epsilon"]
    fields = (("private_params", "private_opt", "proxy_params", "proxy_opt")
              if method in ("proxyfl", "fml") else ("params", "opt"))
    for a, b in zip(res["vmap"]["clients"], res["loop"]["clients"]):
        _assert_close([getattr(a, f) for f in fields],
                      [getattr(b, f) for f in fields])
        if method in ("proxyfl", "fml"):
            np.testing.assert_allclose(a.w, b.w, **CLOSE)


def test_stacked_step_runs_the_client_grid_routes(monkeypatch):
    """A stacked DP round makes one batched call of each DP op a local
    step: the client-grid routes at [K, B, D] and [K, D]."""
    import repro_torch.kernels.dp_clip as dp_clip
    import repro_torch.kernels.dp_step as dp_step
    seen = []
    clip, adam = (dp_clip.clip_accumulate_rows_clients,
                  dp_step.noise_adam_step_clients)
    monkeypatch.setattr(dp_clip, "clip_accumulate_rows_clients",
                        lambda g, s: seen.append(("clip", tuple(g.shape)))
                        or clip(g, s))
    monkeypatch.setattr(dp_step, "noise_adam_step_clients",
                        lambda *a, **kw: seen.append(
                            ("adam", tuple(a[0].shape))) or adam(*a, **kw))
    cfg = _cfg()
    eng = _engines(cfg)["vmap"]
    eng.run_round(eng.init_states(0), _data((32,) * K), 0, seed=0)
    D = sum(x.numel() for x in tree_leaves(
        eng.init_states(0)[0]["proxy"]["params"]))
    assert seen == [("clip", (K, 8, D)), ("adam", (K, D))] * 2


# ---------------------------------------------------------------------------
# the stacked round against the JAX engine's vmap backend


@pytest.fixture(scope="module")
def reference_runs():
    jax = pytest.importorskip("jax")
    from repro.configs.base import DPConfig as JDP
    from repro.configs.base import ProxyFLConfig as JCfg
    from repro.core import engine as jeng
    from repro.core.accountant import PrivacyAccountant as JAcc
    from repro.core.dp import _flat_gaussian_like
    from repro.core.protocol import ModelSpec as JSpec
    from repro.nn.vision import get_vision_model as jvision

    from repro_torch import convert
    from repro_torch.core.accountant import PrivacyAccountant

    data = _data(SIZES)
    jdata = [(x.numpy(), y.numpy()) for x, y in data]
    jv = jvision("mlp")
    jspec = JSpec("mlp", lambda k: jv.init(k, SHAPE, N_CLASSES), jv.apply)
    kw = dict(n_clients=K, rounds=2, local_steps=0, batch_size=8,
              use_pallas=True, dropout_rate=0.3, min_active=2, seed=5)
    jcfg = JCfg(dp=JDP(enabled=True), **kw)
    ref_eng = jeng.dml_engine((jspec,) * K, jspec, jcfg, backend="vmap")
    jaccs = [JAcc(1.0, min(1.0, 8 / n), 1e-5) for n in SIZES]
    ref_eng.attach_accountants(jaccs)
    base = jax.random.PRNGKey(0)
    jstate = ref_eng.init_states(base)
    init = [jax.tree_util.tree_map(np.asarray, s)
            for s in ref_eng.export_states(jstate)]
    theta_like = init[0]["proxy"]["params"]
    jstate, jm = ref_eng.run_rounds(jstate, jdata, 0, 2, base)

    def draws(k, t, s):
        ck = jax.random.fold_in(jeng.round_key(base, t), k)
        for _ in range(s + 1):
            ck, kb, kn = jax.random.split(ck, 3)
        idx = jax.random.randint(kb, (8,), 0, SIZES[k])
        return np.asarray(idx), np.asarray(_flat_gaussian_like(theta_like,
                                                               kn))

    cfg = ProxyFLConfig(dp=DPConfig(enabled=True), **kw)
    spec = _spec()
    port = engine.dml_engine((spec,) * K, spec, cfg, backend="vmap",
                             device="cpu", draws=draws)
    assert port.stacked
    taccs = [PrivacyAccountant(1.0, min(1.0, 8 / n), 1e-5) for n in SIZES]
    port.attach_accountants(taccs)
    tstate = [convert.state_from_numpy(s) for s in init]
    tstate, tm = port.run_rounds(tstate, data, 0, 2, seed=0)
    return dict(j=[jax.tree_util.tree_map(np.asarray, s)
                   for s in ref_eng.export_states(jstate)],
                t=tstate, jm=jm, tm=tm, jaccs=jaccs, taccs=taccs)


@pytest.mark.parametrize("role", ["private", "proxy"])
def test_stacked_round_close_to_the_reference_vmap(reference_runs, role):
    import jax
    for ours, theirs in zip(reference_runs["t"], reference_runs["j"]):
        for a, b in zip(tree_leaves(ours[role]),
                        jax.tree_util.tree_leaves(theirs[role])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **CLOSE)
    w = [float(s["w"]) for s in reference_runs["t"]]
    np.testing.assert_allclose(w, [float(s["w"]) for s in
                                   reference_runs["j"]], **CLOSE)


def test_stacked_metrics_and_epsilon_match_the_reference(reference_runs):
    tm, jm = reference_runs["tm"], reference_runs["jm"]
    assert sorted(tm) == sorted(jm)
    for key in tm:
        assert tm[key].shape == (2, K)
        np.testing.assert_allclose(tm[key], np.asarray(jm[key]), **CLOSE)
    assert [a.epsilon() for a in reference_runs["taccs"]] == \
        [a.epsilon() for a in reference_runs["jaccs"]]
    assert [a.steps for a in reference_runs["taccs"]] == \
        [a.steps for a in reference_runs["jaccs"]]

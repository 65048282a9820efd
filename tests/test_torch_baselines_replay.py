"""The port's ``run_federated`` for the single-model fig. 3 methods, run on
the JAX package's own fig. 3 data, initial state and draws, against the
reference's ``run_federated`` on the same configuration.

The data are the reference's ``benchmarks/common.py::federation_data``
arrays (the mnist stand-in, K = 3 clients of 50 examples) and the
configuration is fig. 3's (``bench_methods``: DP σ = 1, C = 1, epoch
mode), at B = 20 and 2 rounds, so each client takes 2 steps a round and
Joint 7. The reference runs as its ``bench_methods`` runs it by default
(``use_pallas=False``), the port as its fig. 3 driver does
(``use_pallas=True``, the kernels' plain versions on the CPU). The port
starts from the reference engine's initial state and replays its batch
indices and DP noise through the engine's replay hook, as
tests/test_torch_baselines.py does.

Grades: final params, Adam moments and every history row's per-client
test accuracy at the conformance ``close`` grade (atol 1e-5, rtol 1e-4);
epsilon exactly.

The compressed exchange runs the same way (AvgPush, K = 4 clients, both
codecs, ``cfg.compress``): the port starts from the reference's public
copies too and replays the int8 codec's noise block of each round,
``jax.random.uniform(compress_round_key(round_key), (K, D))``, through the
engine's ``codec_draws`` hook. Each exchange is also run by the
reference on the port's inputs (public copies bit for bit, the mix at
``close``). Top-k's whole run and its final public copies are held at
``close``. So is int8's, except where a stochastic-rounding decision
flipped: the packages' local steps differ in the last bit, and where the
noise value falls between the two fractional parts ``x − floor(x)`` the
codec rounds the other way, one codec step apart. Each such coordinate is
found from both packages' exchange inputs (the reference's captured in
its compiled round), its cause checked (inputs one last bit apart, the
noise between the two fractions) and its departure bounded (at most
:data:`INT8_MAX_FLIPS` of the 796,840 copy coordinates, each one codec
step of its row).

Run as a script, it repeats the comparison at fig. 3's quick cifar10
configuration, and also trains the port on the reference's arrays with
its own draws and on its own data (about 15 minutes on a CPU):

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_baselines_replay.py
"""
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import benchmarks.common as jax_common  # noqa: E402
import jax  # noqa: E402

from repro.configs.base import DPConfig as JaxDPConfig  # noqa: E402
from repro.configs.base import ProxyFLConfig as JaxProxyFLConfig  # noqa: E402
from repro.core import baselines as jax_baselines  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import gossip as jax_gossip  # noqa: E402
from repro.core.compress import CompressionSpec as JaxCompressionSpec  # noqa: E402
from repro.core.compress import compress_round_key  # noqa: E402
from repro.core.dp import _flat_gaussian_like  # noqa: E402
from repro_torch.configs import DPConfig, ProxyFLConfig  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.core import engine as port_engine_module  # noqa: E402
from repro_torch.benchmarks import common  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402
from test_torch_baselines import export, to_port, to_torch  # noqa: E402

CLOSE = dict(atol=1e-5, rtol=1e-4)
# flipped int8 rounding decisions allowed in the 2-round K = 4 run (of
# 796,840 copy coordinates): each needs a last-bit input difference and a
# noise value within it, about 1e-5 of the coordinates at round 0's scale
INT8_MAX_FLIPS = 8


def _recording(eng, name):
    """``eng`` with its round method ``name`` wrapped to keep the state it
    last returned as ``eng.last_state``."""
    raw = getattr(eng, name)

    def recorded(*args, **kwargs):
        out = raw(*args, **kwargs)
        eng.last_state = out[0]
        return out

    setattr(eng, name, recorded)
    return eng


def replay_run_federated(method, dataset, n_clients, rounds, seed, *,
                         n_train_factor, batch_size, compress="none",
                         engines=None):
    """``method`` through the reference's ``run_federated`` and the port's,
    both on the reference's ``federation_data(dataset, ...)``; the port
    from the reference engine's initial state and on its draws (the int8
    codec's too). Returns (port result, reference result); ``engines``, a
    list, receives (port engine, reference engine)."""
    jdata, jtest, d = jax_common.federation_data(
        dataset, n_clients, seed, n_train_factor=n_train_factor)
    knobs = dict(alpha=0.5, beta=0.5, n_clients=n_clients, rounds=rounds,
                 batch_size=batch_size, seed=seed, compress=compress)
    dp = dict(enabled=True, noise_multiplier=1.0, clip_norm=1.0)
    jcfg = JaxProxyFLConfig(dp=JaxDPConfig(**dp), use_pallas=False, **knobs)
    tcfg = ProxyFLConfig(dp=DPConfig(**dp), use_pallas=True, **knobs)
    jspec = jax_common.spec_of("mlp", d["shape"], d["n_classes"])
    tspec = common.spec_of("mlp", d["shape"], d["n_classes"])

    made = []

    def capture(*args, **kwargs):
        made.append(_recording(jax_engine.single_model_engine(*args,
                                                              **kwargs),
                               "run_rounds"))
        return made[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_baselines, "single_model_engine", capture)
        want = jax_baselines.run_federated(
            method, [jspec] * n_clients, jspec, jdata, jtest, jcfg,
            seed=seed, eval_every=1)
    (ref,) = made
    base = jax.random.PRNGKey(seed)
    init = export(ref, ref.init_states(base))
    theta_like = (init["clients"] if isinstance(init, dict)
                  else init)[0]["proxy"]["params"]
    D = sum(int(np.size(x)) for x in jax.tree_util.tree_leaves(theta_like))
    sizes = [int(x.shape[0]) for x, _ in jdata]
    if method == "joint":
        sizes = [sum(sizes)]

    def draws(k, t, s):
        ck = jax.random.fold_in(jax_engine.round_key(base, t), k)
        for _ in range(s + 1):
            ck, kb, kn = jax.random.split(ck, 3)
        idx = jax.random.randint(kb, (batch_size,), 0, sizes[k])
        return np.asarray(idx), np.asarray(_flat_gaussian_like(theta_like, kn))

    def codec_draws(t):
        key = compress_round_key(jax_engine.round_key(base, t))
        return np.asarray(jax.random.uniform(key, (len(sizes), D)))

    port_engine = baselines.single_model_engine

    def replay_engine(*args, **kwargs):
        eng = port_engine(*args, draws=draws, codec_draws=codec_draws,
                          **kwargs)
        eng.init_states = lambda _seed: to_port(init)
        # the driver runs round-blocks, as the reference's does
        _recording(eng, "run_rounds")
        if engines is not None:
            engines.append(eng)
        return eng

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(baselines, "single_model_engine", replay_engine)
        got = baselines.run_federated(
            method, [tspec] * n_clients, tspec, to_torch(jdata),
            to_torch([jtest])[0], tcfg, seed=seed, eval_every=1,
            device="cpu")
    if engines is not None:
        engines.append(ref)
    return got, want


def assert_runs_close(got, want, params=True):
    """Epsilon exactly; history, Adam moments and (with ``params``) the
    final params at ``close``."""
    assert got["epsilon"] == want["epsilon"]
    assert [r["round"] for r in got["history"]] == \
        [r["round"] for r in want["history"]]
    for row, ref_row in zip(got["history"], want["history"]):
        assert sorted(row) == sorted(ref_row) == ["acc", "round"]
        np.testing.assert_allclose(row["acc"], ref_row["acc"], **CLOSE)
    assert len(got["clients"]) == len(want["clients"])
    for c, rc in zip(got["clients"], want["clients"]):
        trees = [(c.opt.m, rc.opt.m), (c.opt.v, rc.opt.v)]
        if params:
            trees.append((c.params, rc.params))
        for a_tree, b_tree in trees:
            la, lb = tree_leaves(a_tree), jax.tree_util.tree_leaves(b_tree)
            assert len(la) == len(lb)
            for x, y in zip(la, lb):
                np.testing.assert_allclose(x.numpy(), np.asarray(y), **CLOSE)
        assert int(c.opt.t) == int(rc.opt.t)
        assert c.accountant.steps == rc.accountant.steps


@pytest.mark.parametrize("method", sorted(baselines._SINGLE_MIX))
def test_run_federated_on_reference_data_and_draws(method):
    got, want = replay_run_federated(method, "mnist", 3, 2, 0,
                                     n_train_factor=0.05, batch_size=20)
    steps = 7 if method == "joint" else 2
    assert all(c.accountant.steps == 2 * steps for c in got["clients"])
    assert_runs_close(got, want)


@functools.lru_cache(maxsize=None)
def compressed_replay(mode):
    """AvgPush with the compressed exchange (K = 4, 2 rounds) replayed in
    the port, each of its exchanges also run by the reference's eager
    ``pushsum_mix_debiased`` on the same inputs and noise block. Both
    packages' exchange inputs are kept: ``ports`` (flat, public copies,
    noise) and ``refs`` (flat, public copies), the latter read out of the
    reference's compiled round by a debug callback."""
    spec = JaxCompressionSpec(mode=mode)
    pairs, ports, refs = [], [], []
    raw = port_engine_module.pushsum_mix_debiased
    raw_ref = jax_engine.pushsum_mix_debiased

    def keep_ref(flat, w, P, **kw):
        jax.debug.callback(
            lambda f, e: refs.append((np.asarray(f), np.asarray(e))),
            flat, kw["ef_state"])
        return raw_ref(flat, w, P, **kw)

    def both(flat, w, P, **kw):
        noise = kw["noise"]
        ports.append((flat.numpy().copy(), kw["ef_state"].numpy().copy(),
                      None if noise is None else noise.numpy().copy()))
        out = raw(flat, w, P, **kw)
        t = len(pairs)
        key = compress_round_key(jax_engine.round_key(jax.random.PRNGKey(0),
                                                      t))
        want = jax_gossip.pushsum_mix_debiased(
            jnp.asarray(flat.numpy()), jnp.asarray(w.numpy()),
            jnp.asarray(P, jnp.float32), compress=spec,
            ef_state=jnp.asarray(kw["ef_state"].numpy()), key=key)
        pairs.append((out, want))
        return out

    engines = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_engine_module, "pushsum_mix_debiased", both)
        mp.setattr(jax_engine, "pushsum_mix_debiased", keep_ref)
        got, want = replay_run_federated(
            "avgpush", "mnist", 4, 2, 0, n_train_factor=0.05, batch_size=20,
            compress=mode, engines=engines)
    return dict(mode=mode, got=got, want=want, engines=engines, pairs=pairs,
                ports=ports, refs=refs)


@pytest.mark.parametrize("mode", ["topk", "int8"])
def test_compressed_exchanges_equal_the_reference_in_lockstep(mode):
    """Each exchange of the port's compressed run against the reference's
    exchange from the same inputs and noise block: the public copies bit
    for bit (the codecs are bit-equal), z' and w' at ``close``."""
    replay = compressed_replay(mode)
    port, ref = replay["engines"]
    assert port.compress.mode == ref.compress.mode == mode
    assert port._compressed and ref._compressed
    pairs = replay["pairs"]
    assert len(pairs) == 2
    for (z2, w2, pub2), (jz2, jw2, jpub2) in pairs:
        np.testing.assert_array_equal(pub2.numpy(), np.asarray(jpub2))
        np.testing.assert_allclose(z2.numpy(), np.asarray(jz2), **CLOSE)
        np.testing.assert_allclose(w2.numpy(), np.asarray(jw2), **CLOSE)


def test_compressed_topk_run_federated_on_reference_data_and_draws():
    """Top-k: the whole trajectory and the public copies it leaves against
    the reference's from the same state and draws at ``close``."""
    replay = compressed_replay("topk")
    assert_runs_close(replay["got"], replay["want"])
    port, ref = replay["engines"]
    ours, theirs = port.last_state["ef_state"], ref.last_state["ef_state"]
    assert tuple(ours.shape) == theirs.shape == (4, 199_210)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **CLOSE)


def _int8_fraction(u):
    """The int8 codec's per-row step, ``floor(x)`` and ``x − floor(x)`` of
    ``x = u / step``, in f32 as ``int8_reference`` computes them."""
    step = (np.maximum(np.abs(u).max(axis=1), np.float32(1e-12))
            / np.float32(127.0))
    x = u / step[:, None]
    lo = np.floor(x)
    return step, lo, x - lo


def _flat(tree, leaves):
    return np.concatenate([np.asarray(x).ravel() for x in leaves(tree)])


def test_compressed_int8_run_federated_on_reference_data_and_draws():
    """Int8: the whole run against the reference's from the same state and
    draws. Every rounding decision that differs between the packages'
    exchanges is explained: the two inputs one last bit apart, the same
    floor, and the noise value between the two fractional parts. The
    final public copies and proxies are at ``close`` except at those
    coordinates, where they are one codec step of the flipping row apart
    (a proxy by its mixing weight's share of it); the rest of the run is
    at ``close``."""
    replay = compressed_replay("int8")
    assert len(replay["ports"]) == len(replay["refs"]) == 2
    flips = {}                      # (client, coordinate) -> codec step
    for (pf, ppub, noise), (rf, rpub) in zip(replay["ports"],
                                             replay["refs"]):
        p_step, p_lo, p_frac = _int8_fraction(pf - ppub)
        r_step, r_lo, r_frac = _int8_fraction(rf - rpub)
        differ = (p_lo + (noise < p_frac)) != (r_lo + (noise < r_frac))
        for k, i in zip(*np.nonzero(differ)):
            assert p_lo[k, i] == r_lo[k, i]
            lo, hi = sorted((p_frac[k, i], r_frac[k, i]))
            assert lo <= noise[k, i] < hi
            ulp = np.spacing(np.float32(max(abs(pf[k, i]), abs(ppub[k, i]),
                                            abs(rf[k, i]), abs(rpub[k, i]))))
            assert abs((pf[k, i] - ppub[k, i]) - (rf[k, i] - rpub[k, i])) \
                <= 2 * ulp
            np.testing.assert_allclose(p_step[k], r_step[k], **CLOSE)
            flips[(k, i)] = float(r_step[k])
    assert len(flips) <= INT8_MAX_FLIPS
    assert_runs_close(replay["got"], replay["want"], params=False)
    port, ref = replay["engines"]
    ours = port.last_state["ef_state"].numpy()
    theirs = np.asarray(ref.last_state["ef_state"])
    assert ours.shape == theirs.shape == (4, 199_210)
    for k, i in zip(*np.nonzero(~np.isclose(ours, theirs, **CLOSE))):
        assert (k, i) in flips
        np.testing.assert_allclose(abs(ours[k, i] - theirs[k, i]),
                                   flips[(k, i)], **CLOSE)
    steps = {i: s for (_, i), s in flips.items()}
    for c, rc in zip(replay["got"]["clients"], replay["want"]["clients"]):
        a = _flat(c.params, tree_leaves)
        b = _flat(rc.params, jax.tree_util.tree_leaves)
        for i in np.flatnonzero(~np.isclose(a, b, **CLOSE)):
            assert i in steps
            assert abs(a[i] - b[i]) <= steps[i] * (1 + CLOSE["rtol"])


def reference_arrays(dataset, n_clients, seed, *, n_train_factor=1.0,
                     device="cpu"):
    """The reference's ``federation_data`` as CPU tensors, in the port's
    ``federation_data`` signature."""
    data, test, d = jax_common.federation_data(
        dataset, n_clients, seed, n_train_factor=n_train_factor)
    return to_torch(data), to_torch([test])[0], d


def main():
    """Fig. 3's quick cifar10 (4 clients of 1,200 examples, 3 rounds,
    B = 250, seeds 0-4) for FedAvg, Regular and AvgPush on the reference's
    arrays: the reference's run beside the port's on the reference's
    initial state and draws, then the port's on its own draws; last the
    port on its own data, drawn on the CPU. One JSON line per method and
    run."""
    for method in ("fedavg", "regular", "avgpush"):
        jax_accs, port_accs, acc_diff, param_diff = [], [], 0.0, 0.0
        for seed in range(5):
            got, want = replay_run_federated(method, "cifar10", 4, 3, seed,
                                             n_train_factor=0.4,
                                             batch_size=250)
            ga, wa = got["history"][-1]["acc"], want["history"][-1]["acc"]
            port_accs += ga
            jax_accs += wa
            acc_diff = max(acc_diff, float(np.abs(np.subtract(ga, wa)).max()))
            for c, rc in zip(got["clients"], want["clients"]):
                for x, y in zip(tree_leaves(c.params),
                                jax.tree_util.tree_leaves(rc.params)):
                    param_diff = max(param_diff, float(
                        np.abs(x.numpy() - np.asarray(y)).max()))
            assert got["epsilon"] == want["epsilon"]
        print(json.dumps(dict(
            method=method, run="reference", acc_mean=np.mean(jax_accs),
            acc_std=np.std(jax_accs))), flush=True)
        print(json.dumps(dict(
            method=method, run="port on the reference's draws",
            acc_mean=np.mean(port_accs), acc_std=np.std(port_accs),
            max_acc_diff=acc_diff, max_param_diff=param_diff)), flush=True)
        quick = dict(n_clients=4, rounds=3, seeds=range(5),
                     n_train_factor=0.4, device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(common, "federation_data", reference_arrays)
            (row,) = common.bench_methods("cifar10", (method,), **quick)
        print(json.dumps(dict(method=method, run="port on its own draws",
                              acc_mean=row["acc_mean"],
                              acc_std=row["acc_std"])), flush=True)
        (row,) = common.bench_methods("cifar10", (method,), **quick)
        print(json.dumps(dict(method=method,
                              run="port on its own data drawn on the CPU",
                              acc_mean=row["acc_mean"],
                              acc_std=row["acc_std"])), flush=True)


if __name__ == "__main__":
    main()

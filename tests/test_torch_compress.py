"""The compressed proxy exchange of the port (``repro_torch.core.compress``
and the compressed branches of ``core.gossip``) against the JAX package.

* ``encode_decode`` bit for bit against the numpy oracles
  ``topk_reference`` and ``int8_reference`` at tests/test_compress.py's
  shapes and ratios, and against the reference's own (run eagerly, as its
  own tests run it) where the cases differ (k = 1, k = D, a general k,
  int8), over planted equal-magnitude ties (lowest index first, as
  ``lax.top_k``), and the pinned tie case.
* ``wire_bytes``, ``topk_k`` and ``comm_cost_per_round`` equal over a
  sweep.
* The public-copy core against ``ef_encode_reference``: the decoded delta
  and the copy bit for bit, ``c + (m − pub') == m − pub`` per sender,
  silent clients' copies untouched down to the sign of zero.
* ``compressed_pushsum_mix`` against the reference's from the same inputs
  and noise at the conformance ``close`` grade (atol 1e-5, rtol 1e-4),
  and against ``compressed_gossip_reference`` over 3 rounds (the stale
  mix's twin is in tests/test_torch_async.py).
* Engine: w-mass conserved under compressed async (τ = 2, int8, §3.4
  dropout, the twin of tests/test_compress.py); ``compress="none"`` runs
  bit-equal to the exchange as it was before compression was ported
  (kept here as the oracle), sync and async.

The engine against the reference's engine with its draws replayed is in
tests/test_torch_baselines_replay.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import compress as jax_compress  # noqa: E402
from repro.core import gossip as jax_gossip  # noqa: E402
from repro_torch.configs import DPConfig, ProxyFLConfig  # noqa: E402
from repro_torch.core import compress, engine, gossip  # noqa: E402
from repro_torch.core.protocol import ModelSpec  # noqa: E402
from repro_torch.nn.modules import tree_flatten_vector, tree_leaves  # noqa: E402
from repro_torch.nn.vision import get_vision_model  # noqa: E402

K = 4
CLOSE = dict(atol=1e-5, rtol=1e-4)
MODES = ("topk", "int8")


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _spec(mode, ratio=0.25):
    return (compress.CompressionSpec(mode=mode, ratio=ratio),
            jax_compress.CompressionSpec(mode=mode, ratio=ratio))


# ---------------------------------------------------------------------------
# codecs


TOPK_SHAPES = [(1, 1), (2, 7), (3, 64), (4, 333), (5, 1024)]


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


@pytest.mark.parametrize("shape", TOPK_SHAPES)
@pytest.mark.parametrize("ratio", [0.1, 0.25, 1.0])
def test_topk_bit_equal_to_oracle(shape, ratio):
    """tests/test_compress.py's grid against ``topk_reference``, which the
    reference's own tests hold bit-equal to its ``encode_decode``."""
    u = _normal(shape, shape[1])
    got = compress.encode_decode(torch.tensor(u), _spec("topk", ratio)[0])
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(jax_compress.topk_reference(u, ratio)))
    assert (np.count_nonzero(got.numpy(), axis=1)
            <= compress.topk_k(shape[1], ratio)).all()


# k = 1 (D = 1, and the floor of a small ratio), k = D, and a general k
@pytest.mark.parametrize("shape,ratio", [((1, 1), 0.25), ((2, 7), 0.1),
                                         ((3, 64), 1.0), ((5, 1024), 0.1)])
def test_topk_bit_equal_to_reference_and_oracle(shape, ratio):
    u = _normal(shape, shape[1])
    ours, theirs = _spec("topk", ratio)
    got = compress.encode_decode(torch.tensor(u), ours).numpy()
    want = np.asarray(jax_compress.encode_decode(
        jnp.asarray(u), jax.random.PRNGKey(0), theirs))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got),
                                  _bits(jax_compress.topk_reference(u, ratio)))


def test_topk_tie_breaking_pinned():
    u = np.array([[0.5, -2.0, 2.0, 1.0, -1.0]], np.float32)
    got = compress.encode_decode(torch.tensor(u), _spec("topk", 0.4)[0])
    np.testing.assert_array_equal(got.numpy(), [[0.0, -2.0, 2.0, 0.0, 0.0]])
    np.testing.assert_array_equal(got.numpy(),
                                  jax_compress.topk_reference(u, 0.4))


@pytest.mark.parametrize("D,ratio", [(64, 0.25), (1000, 0.1), (4096, 0.25)])
def test_topk_planted_ties_lowest_index_first(D, ratio):
    """Rows whose magnitudes tie across the kept/dropped boundary: a run
    of equal |values| of both signs straddles the k-th place."""
    rng = np.random.default_rng(D)
    u = rng.normal(size=(3, D)).astype(np.float32) * 0.1
    u[0, ::3] = 0.75
    u[0, 1::7] = -0.75
    u[1, :] = np.where(rng.random(D) < 0.5, 1.0, -1.0)   # every entry tied
    u[2, rng.choice(D, D // 2, replace=False)] = -0.5
    ours, theirs = _spec("topk", ratio)
    got = compress.encode_decode(torch.tensor(u), ours).numpy()
    want = np.asarray(jax_compress.encode_decode(
        jnp.asarray(u), jax.random.PRNGKey(0), theirs))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got),
                                  _bits(jax_compress.topk_reference(u, ratio)))
    k = compress.topk_k(D, ratio)
    assert np.flatnonzero(got[1]).tolist() == list(range(k))


@pytest.mark.parametrize("D", [3, 50, 512])
def test_int8_bit_equal_to_reference_and_oracle(D):
    u = _normal((3, D), D) * 5.0
    key = jax_compress.compress_round_key(jax.random.PRNGKey(7))
    noise = np.asarray(jax.random.uniform(key, u.shape, jnp.float32))
    got = compress.encode_decode(torch.tensor(u), _spec("int8")[0],
                                 torch.tensor(noise)).numpy()
    want = np.asarray(jax_compress.encode_decode(jnp.asarray(u), key,
                                                 _spec("int8")[1]))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(got), _bits(jax_compress.int8_reference(u, noise)))


def test_int8_needs_its_noise_block():
    with pytest.raises(ValueError, match="noise"):
        compress.encode_decode(torch.ones(2, 3), _spec("int8")[0])


def test_wire_bytes_topk_k_and_comm_cost_equal():
    for D in (1, 7, 8, 9, 1000, 44_860, 199_210, 7_615_283_200):
        for ratio in (0.01, 0.1, 0.25, 0.5, 1.0):
            assert compress.topk_k(D, ratio) == jax_compress.topk_k(D, ratio)
            for mode in ("none", "topk", "int8"):
                for db in (2, 4):
                    assert compress.wire_bytes(mode, D, ratio, db) == \
                        jax_compress.wire_bytes(mode, D, ratio, db)
    for method in ("fedavg", "fml", "avgpush", "cwt", "proxyfl", "regular",
                   "joint"):
        for n in (1, 4, 128):
            for mb, pb, bw in ((796_840, 199_214, 50e9), (10, 3, 1.0)):
                assert gossip.comm_cost_per_round(method, n, mb, pb, bw) == \
                    jax_gossip.comm_cost_per_round(method, n, mb, pb, bw)
    with pytest.raises(ValueError):
        compress.wire_bytes("gzip", 100)
    with pytest.raises(ValueError):
        gossip.comm_cost_per_round("gzip", 4, 1, 1)


def test_compress_spec_from_config():
    assert compress.compress_spec(ProxyFLConfig()) is None
    spec = compress.compress_spec(ProxyFLConfig(compress="topk",
                                                compress_ratio=0.1))
    assert spec == compress.CompressionSpec("topk", 0.1)
    assert compress.COMPRESS_KEY_FOLD == jax_compress.COMPRESS_KEY_FOLD
    assert compress.MODES == jax_compress.MODES


# ---------------------------------------------------------------------------
# the public-copy core


def _exchange_inputs(seed, D, drop=None):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(K, D)).astype(np.float32)
    pub = rng.normal(scale=0.9, size=(K, D)).astype(np.float32)
    pub[:, 0] = -0.0          # signed zeros a silent client must keep
    act = None
    if drop is not None:
        act = np.ones(K, bool)
        act[drop] = False
    P = np.asarray(gossip.mix_matrix("pushsum", seed, K, "exponential", act),
                   np.float32)
    noise = rng.random(size=(K, D)).astype(np.float32)
    return m, pub, P, noise


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("drop", [None, 2])
def test_ef_encode_bit_equal_to_oracle_and_conserving(mode, drop):
    m, pub, P, noise = _exchange_inputs(3, 333, drop)
    sent = P.copy()
    np.fill_diagonal(sent, 0.0)
    ours, theirs = _spec(mode)
    c, pub2 = compress._ef_encode(torch.tensor(m), torch.tensor(pub),
                                  torch.tensor(sent), torch.tensor(noise),
                                  ours)
    rc, rpub2 = jax_compress.ef_encode_reference(m, pub, sent, theirs,
                                                 noise=noise)
    np.testing.assert_array_equal(_bits(c.numpy()), _bits(rc))
    np.testing.assert_array_equal(_bits(pub2.numpy()), _bits(rpub2))
    sends = sent.sum(axis=0) > 0
    c, pub2 = c.numpy(), pub2.numpy()
    np.testing.assert_array_equal((pub + c)[sends], pub2[sends])
    np.testing.assert_allclose((c + (m - pub2))[sends], (m - pub)[sends],
                               rtol=1e-6, atol=1e-6)
    if drop is not None:
        assert not sends[drop]
        np.testing.assert_array_equal(c[drop], 0.0)
        np.testing.assert_array_equal(_bits(pub2[drop]), _bits(pub[drop]))
        assert np.signbit(pub2[drop, 0])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("drop", [None, 1])
def test_compressed_pushsum_mix_matches_reference(mode, drop):
    m, pub, P, noise = _exchange_inputs(5, 96, drop)
    w = np.random.default_rng(1).uniform(0.5, 1.5, K).astype(np.float32)
    ours, theirs = _spec(mode)
    key = jax.random.PRNGKey(11)
    if mode == "int8":
        noise = np.asarray(jax.random.uniform(key, m.shape, jnp.float32))
    got = gossip.pushsum_mix_debiased(
        torch.tensor(m), torch.tensor(w), P, compress=ours,
        ef_state=torch.tensor(pub), noise=torch.tensor(noise))
    want = jax_gossip.pushsum_mix_debiased(
        jnp.asarray(m), jnp.asarray(w), jnp.asarray(P), compress=theirs,
        ef_state=jnp.asarray(pub), key=key)
    assert len(got) == 3
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **CLOSE)
    np.testing.assert_array_equal(_bits(got[2].numpy()),
                                  _bits(np.asarray(want[2])))


@pytest.mark.parametrize("mode", MODES)
def test_compressed_sync_mix_follows_the_gossip_oracle(mode):
    """Three rounds of the port's compressed mix, copies warm-started at
    z0, against ``compressed_gossip_reference`` (one noise block a round
    for int8), z, w and the copies at ``close``."""
    rng = np.random.default_rng(9)
    z0 = rng.normal(size=(K, 200)).astype(np.float32)
    w0 = np.ones(K, np.float32)
    act = [None, np.array([True, False, True, True]), None]
    Ps = [gossip.mix_matrix("pushsum", t, K, "exponential", a)
          for t, a in enumerate(act)]
    noises = [rng.random((K, 200)).astype(np.float32) for _ in Ps]
    ours, theirs = _spec(mode)
    z, w = torch.tensor(z0), torch.tensor(w0)
    pub = z.clone()
    for P, noise in zip(Ps, noises):
        z, w, pub = compress.compressed_pushsum_mix(
            z, w, P, pub, torch.tensor(noise), ours)
    rz, rw, rpub = jax_compress.compressed_gossip_reference(
        z0, w0, Ps, theirs, noises=noises if mode == "int8" else None)
    for g, r in ((z, rz), (w, rw), (pub, rpub)):
        np.testing.assert_allclose(g.numpy(), r, **CLOSE)


# ---------------------------------------------------------------------------
# the engine


SHAPE, N_CLASSES = (8, 8, 1), 10


def _setup(**knobs):
    vm = get_vision_model("mlp")
    spec = ModelSpec("mlp", lambda g: vm.init(g, SHAPE, N_CLASSES), vm.apply)
    rng = np.random.default_rng(0)
    data = [(torch.as_tensor(rng.standard_normal((40,) + SHAPE,
                                                 dtype=np.float32)),
             torch.as_tensor(rng.integers(0, N_CLASSES, 40)))
            for _ in range(K)]
    knobs.setdefault("dp", DPConfig(enabled=False))
    cfg = ProxyFLConfig(n_clients=K, batch_size=8, local_steps=1, **knobs)
    return spec, data, cfg


@pytest.mark.parametrize("mode", MODES)
def test_stale_w_mass_conserved_under_compression(mode):
    """Async τ = 2 with §3.4 dropout: the de-bias weights are never
    compressed, so clients' plus in-flight w-mass stays K every round, and
    θ-mass is carried by the public copies' dense sends."""
    spec, data, cfg = _setup(lr=0.0, staleness=2, compress=mode)
    eng = engine.dml_engine((spec,) * K, spec, cfg, backend="async",
                            device="cpu")
    state = eng.init_states(0)
    assert sorted(state) == ["clients", "ef_state", "stale_theta", "stale_w"]
    np.testing.assert_array_equal(
        state["ef_state"].numpy(),
        torch.stack([tree_flatten_vector(s["proxy"]["params"])
                     for s in state["clients"]]).numpy())
    masks = [np.array([True, False, True, True]), None,
             np.array([False, True, False, True]), None]
    for t, act in enumerate(masks):
        state, _ = eng.run_round(state, data, t, seed=0, active=act)
        w_mass = (torch.stack([s["w"] for s in state["clients"]]).sum()
                  + state["stale_w"].sum())
        np.testing.assert_allclose(float(w_mass), K, rtol=1e-6)


def _old_mix(self, flat, w, carry, inp):
    """The uncompressed exchange as it was before compression was ported,
    on the engine's round inputs: the sync mix, or the stale one with its
    buffer rotation (both executors call ``_mix``)."""
    if not self._stale:
        unb, w2 = gossip.pushsum_mix_debiased(flat, w, inp["P"],
                                              use_pallas=self.use_pallas)
        return unb, w2, {}
    buf_t, buf_w = carry["stale_theta"], carry["stale_w"]
    unb, send_t, w2, send_w = gossip.stale_mix_apply(
        flat, w, inp["kept"], inp["sent"], buf_t[0], buf_w[0],
        use_pallas=self.use_pallas)
    return unb, w2, {
        "stale_theta": torch.cat([buf_t[1:], send_t[None]]),
        "stale_w": torch.cat([buf_w[1:], send_w[None].to(buf_w.dtype)])}


@pytest.mark.parametrize("backend,staleness", [("vmap", 0), ("loop", 0),
                                               ("async", 2)])
def test_compress_none_runs_bit_equal_to_the_uncompressed_exchange(
        backend, staleness):
    spec, data, cfg = _setup(rounds=3, staleness=staleness,
                             dropout_rate=0.25, use_pallas=True,
                             dp=DPConfig(enabled=True))
    leaves = []
    for old in (False, True):
        eng = engine.dml_engine((spec,) * K, spec, cfg, backend=backend,
                                device="cpu")
        assert eng.compress is None and not eng._compressed
        if old:
            eng._mix = _old_mix.__get__(eng)
        state, _ = eng.run_rounds(eng.init_states(0), data, 0, 3, seed=0)
        assert isinstance(state, dict) == bool(staleness)
        if staleness:
            assert sorted(state) == ["clients", "stale_theta", "stale_w"]
        leaves.append(tree_leaves(state))
    assert len(leaves[0]) == len(leaves[1])
    assert all(torch.equal(a, b) for a, b in zip(*leaves))


@pytest.mark.parametrize("mode", MODES)
def test_compressed_engine_wraps_and_moves_its_copies(mode):
    """A compressed sync run wraps the state, warm-starts the copies at the
    initial proxies, advances them each round, and differs from the
    uncompressed run; a mix-less engine never wraps."""
    spec, data, cfg = _setup(rounds=2, compress=mode)
    eng = engine.dml_engine((spec,) * K, spec, cfg, device="cpu")
    state0 = eng.init_states(0)
    assert sorted(state0) == ["clients", "ef_state"]
    state, _ = eng.run_rounds(state0, data, 0, 2, seed=0)
    assert not torch.equal(state["ef_state"], state0["ef_state"])
    plain = engine.dml_engine((spec,) * K, spec,
                              dataclasses.replace(cfg, compress="none"),
                              device="cpu")
    ref, _ = plain.run_rounds(plain.init_states(0), data, 0, 2, seed=0)
    assert not all(torch.equal(a, b) for a, b in zip(
        tree_leaves(state["clients"]), tree_leaves(ref)))
    lone = engine.single_model_engine(spec, cfg, False, mix="none",
                                      device="cpu")
    assert not lone._compressed and isinstance(lone.init_states(0), list)

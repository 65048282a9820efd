"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``), on the CPU.

Part 1 ports ``tests/test_checkpoint.py``'s cases: key-path restore
(dtypes with bf16 and ints, missing and unexpected keys, shape mismatch,
a reordered template), the fingerprint's refusal, the cadence, ``LATEST``
and rotation, a torn audit line, the base-key check.

Part 2 moves snapshots between the frameworks. A JAX ``dml_engine`` run
(loop and vmap, DP on; K = 4 mlp clients on 14x14x1, B = 8, one local
step a round) is checkpointed after round 1 by the reference's
checkpointer; the port's checkpointer restores it (every leaf, ``w``,
accountant steps and ``rounds_done`` bit-equal, the chain verified) and
runs round 2 on the reference's draws (the replay hook), at the
conformance ``close`` grade of JAX's round 2. The same state, carried into
the port (``convert.state_from_numpy``), is checkpointed by the port: its
npz holds the reference snapshot's keys and arrays, its manifest and audit
lines are byte-equal, its meta equal but for the save time, and the
reference's engine and ``verify_chain`` accept it. Fingerprints and the
base key's words are equal across the frameworks. A snapshot in the
reference train driver's layout (bf16 params and master copies) resumes
in the port's driver.
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
from repro.checkpoint import config_fingerprint as jax_fingerprint  # noqa: E402
from repro.checkpoint import load_checkpoint as jax_load  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.configs.base import DPConfig as JaxDPConfig  # noqa: E402
from repro.configs.base import ProxyFLConfig as JaxProxyFLConfig  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core.accountant import PrivacyAccountant as JaxAccountant  # noqa: E402
from repro.core.dp import _flat_gaussian_like  # noqa: E402
from repro.core.protocol import ModelSpec as JaxModelSpec  # noqa: E402
from repro.data.synthetic import make_classification_data as jax_data  # noqa: E402
from repro.nn.vision import get_vision_model as jax_vision  # noqa: E402
from repro.optim import Adam as JaxAdam  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import (FederationCheckpointer,  # noqa: E402
                                    config_fingerprint, load_checkpoint,
                                    manifest_path, save_checkpoint)
from repro_torch.checkpoint.federation import \
    DEFAULT_FINGERPRINT_EXCLUDE  # noqa: E402
from repro_torch.configs import DPConfig, ProxyFLConfig  # noqa: E402
from repro_torch.core.accountant import PrivacyAccountant  # noqa: E402
from repro_torch.core.commit import CommitmentError  # noqa: E402
from repro_torch.core.engine import dml_engine, seed_key_words  # noqa: E402
from repro_torch.core.protocol import ModelSpec  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402
from repro_torch.nn.vision import get_vision_model  # noqa: E402
from repro_torch.optim import Adam  # noqa: E402

K, N_CLASSES, SHAPE, N_PER, B, SEED = 4, 10, (14, 14, 1), 64, 8, 3
CLOSE = dict(atol=1e-5, rtol=1e-4)
CFG = dict(n_clients=K, rounds=2, local_steps=1, batch_size=B)


@pytest.fixture(scope="module")
def tspec():
    vm = get_vision_model("mlp")
    return ModelSpec("mlp", lambda g: vm.init(g, SHAPE, N_CLASSES), vm.apply)


def _tiny_engine(tspec, **kw):
    cfg = ProxyFLConfig(**{**CFG, "dp": DPConfig(enabled=False), **kw})
    return dml_engine((tspec,) * K, tspec, cfg, device="cpu")


# ---------------------------------------------------------------------------
# part 1: ckpt.py and the checkpointer


def test_roundtrip_preserves_dtypes_incl_bf16_and_int(tmp_path):
    """bf16 params with their f32 master copy and bf16 moments, ints of
    three widths and a bool: each leaf back in its dtype, bit for bit;
    the manifest names the reference's dtypes."""
    opt = Adam(lr=1e-3, moment_dtype="bfloat16")
    params = {"w": torch.linspace(-1, 1, 8).to(torch.bfloat16)}
    state = opt.init(params)
    state = state._replace(m={"w": torch.linspace(0, 1, 8).to(
        torch.bfloat16)}, t=torch.tensor(7, dtype=torch.int32))
    tree = {"params": params, "opt": state,
            "counters": {"steps": torch.tensor(7, dtype=torch.int32),
                         "mask": torch.tensor([True, False]),
                         "ids": torch.tensor([1, 2, 3], dtype=torch.uint32),
                         "big": torch.tensor([1 << 40])}}
    p = os.path.join(tmp_path, "ckpt")
    save_checkpoint(p, tree)
    like = {"params": {"w": torch.zeros(8, dtype=torch.bfloat16)},
            "opt": opt.init({"w": torch.zeros(8, dtype=torch.bfloat16)}),
            "counters": {k: torch.zeros_like(v)
                         for k, v in tree["counters"].items()}}
    loaded = load_checkpoint(p, like)
    assert loaded["opt"].p32 is not None
    for a, b in zip(tree_leaves(tree), tree_leaves(loaded)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    with open(manifest_path(p)) as f:
        manifest = json.load(f)
    assert manifest["params/w"]["dtype"] == "bfloat16"
    assert manifest["opt/m/w"]["dtype"] == "bfloat16"
    assert manifest["opt/p32/w"]["dtype"] == "float32"
    assert manifest["opt/t"] == {"dtype": "int32", "shape": []}
    assert manifest["counters/ids"]["dtype"] == "uint32"
    assert manifest["counters/big"]["dtype"] == "int64"
    assert manifest["counters/mask"]["dtype"] == "bool"
    with np.load(p + ".npz") as z:
        assert z["params/w"].dtype == np.float32
        assert z["counters/big"].dtype == np.int64


def test_bf16_tree_files_equal_the_references(tmp_path):
    """The same bf16 values saved by both frameworks: equal manifests and
    equal arrays (widened to f32 in both)."""
    w = jnp.linspace(-1, 1, 8, dtype=jnp.bfloat16)
    jtree = {"w": w, "n": jnp.asarray(3, jnp.int32)}
    ttree = {"w": convert.tensor_from_numpy(np.asarray(w)),
             "n": torch.tensor(3, dtype=torch.int32)}
    jp, tp = os.path.join(tmp_path, "jax"), os.path.join(tmp_path, "port")
    jax_save(jp, jtree)
    save_checkpoint(tp, ttree)
    with open(manifest_path(jp), "rb") as f, open(manifest_path(tp),
                                                  "rb") as g:
        assert f.read() == g.read()
    _assert_npz_equal(jp + ".npz", tp + ".npz")


def test_load_checkpoint_reports_missing_and_unexpected_keys(tmp_path):
    p = os.path.join(tmp_path, "ckpt")
    save_checkpoint(p, {"a": torch.ones(2), "gone": torch.ones(3)})
    with pytest.raises(KeyError) as e:
        load_checkpoint(p, {"a": torch.zeros(2), "absent": torch.zeros(1)})
    msg = str(e.value)
    assert "absent" in msg and "gone" in msg


def test_load_checkpoint_shape_mismatch_raises(tmp_path):
    p = os.path.join(tmp_path, "ckpt")
    save_checkpoint(p, {"a": torch.ones((2, 3))})
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(p, {"a": torch.zeros((3, 2))})


def test_load_checkpoint_not_fooled_by_reordered_template(tmp_path):
    p = os.path.join(tmp_path, "ckpt")
    save_checkpoint(p, {"a": torch.full((3,), 1.0), "b": torch.full((3,),
                                                                    2.0)})
    loaded = load_checkpoint(p, {"b": torch.zeros(3), "a": torch.zeros(3)})
    assert torch.equal(loaded["a"], torch.full((3,), 1.0))
    assert torch.equal(loaded["b"], torch.full((3,), 2.0))


def test_duplicate_key_paths_are_refused(tmp_path):
    with pytest.raises(ValueError, match="duplicate"):
        save_checkpoint(os.path.join(tmp_path, "c"),
                        {"a/b": torch.ones(1), "a": {"b": torch.ones(1)}})


def test_checkpointer_fingerprint_mismatch_refuses(tmp_path, tspec):
    eng = _tiny_engine(tspec)
    state = eng.init_states(0)
    ck = FederationCheckpointer(str(tmp_path),
                                fingerprint=config_fingerprint(eng.cfg))
    ck.save(eng, state, 0, seed=0)
    other = dataclasses.replace(eng.cfg, lr=5e-4)
    ck2 = FederationCheckpointer(str(tmp_path),
                                 fingerprint=config_fingerprint(other))
    with pytest.raises(ValueError, match="fingerprint"):
        ck2.restore_latest(eng, like=state)
    # rounds, backend and verify_commitments are excluded
    assert (config_fingerprint(eng.cfg) == config_fingerprint(
        dataclasses.replace(eng.cfg, rounds=99, backend="loop",
                            verify_commitments=True)))


def test_checkpointer_cadence_latest_and_rotation(tmp_path, tspec):
    eng = _tiny_engine(tspec, rounds=4)
    data = [(torch.zeros(16, *SHAPE), torch.zeros(16, dtype=torch.int64))
            ] * K
    state = eng.init_states(0)
    ck = FederationCheckpointer(str(tmp_path), every=2, keep=1)
    assert [t for t in range(4) if ck.should_save(t)] == [1, 3]
    for t in range(4):
        state, _ = eng.run_round(state, data, t, 0)
        ck.maybe_save(eng, state, t, seed=0)
    assert ck.saved_rounds() == [4]       # keep=1 rotated round_000002
    assert ck.latest_round() == 4
    assert ck.restore_latest(eng, like=eng.init_states(0))[1] == 4
    # a garbage LATEST falls back to the scan; an incomplete snapshot
    # (no meta) is never resumed from
    with open(os.path.join(str(tmp_path), "LATEST"), "w") as f:
        f.write("round_garbage")
    assert ck.latest_round() == 4
    os.remove(os.path.join(str(tmp_path), "round_000004.meta.json"))
    assert ck.latest_round() is None
    empty = FederationCheckpointer(os.path.join(str(tmp_path), "void"))
    assert empty.latest_round() is None
    assert empty.restore_latest(eng, like=state) is None


def test_torn_audit_line(tmp_path, tspec):
    """A kill mid-append tears the last audit line: reading stops there,
    the intact round still restores, the torn one is refused."""
    eng = _tiny_engine(tspec)
    state = eng.init_states(0)
    ck = FederationCheckpointer(str(tmp_path))
    ck.save(eng, state, 0, seed=0)
    ck.save(eng, state, 1, seed=0)
    with open(ck.audit_path) as f:
        lines = f.readlines()
    with open(ck.audit_path, "w") as f:
        f.write(lines[0] + lines[1][: len(lines[1]) // 2])
    assert len(ck._audit_entries()) == 1
    assert ck.restore(eng, 1, like=state, seed=0)[1] == 1
    with pytest.raises(CommitmentError, match="no entry for round 2") as e:
        ck.restore(eng, 2, like=state, seed=0)
    assert e.value.round == 2


def test_resaving_an_audited_round_with_other_params_is_refused(tmp_path,
                                                                tspec):
    eng = _tiny_engine(tspec)
    state = eng.init_states(0)
    ck = FederationCheckpointer(str(tmp_path))
    ck.save(eng, state, 0, seed=0)
    ck.save(eng, state, 0, seed=0)      # a bit-identical re-save is a no-op
    assert len(ck._audit_entries()) == 1
    with pytest.raises(CommitmentError, match="DIFFERENT payload"):
        ck.save(eng, eng.init_states(1), 0, seed=0)


def test_engine_state_roundtrip_and_base_key(tmp_path, tspec):
    eng = _tiny_engine(tspec)
    eng.attach_accountants([PrivacyAccountant(1.0, 0.2) for _ in range(K)])
    for a in eng.accountants:
        a.steps = 2
    state = eng.init_states(0)
    path = os.path.join(tmp_path, "round_000001")
    eng.save_state(path, state, 0, seed=SEED)
    for a in eng.accountants:
        a.steps = 999
    restored, done = eng.restore_state(path, like=eng.init_states(1),
                                       seed=SEED)
    assert done == 1 and all(a.steps == 2 for a in eng.accountants)
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="base RNG key"):
        eng.restore_state(path, seed=999)
    # seed 0's key words are all zeros; it still counts as recorded
    p0 = os.path.join(tmp_path, "seed0")
    eng.save_state(p0, state, 0, seed=0)
    with pytest.raises(ValueError, match="base RNG key"):
        eng.restore_state(p0, seed=1)
    # no seed recorded: any seed resumes
    pn = os.path.join(tmp_path, "noseed")
    eng.save_state(pn, state, 0)
    assert eng.restore_state(pn, seed=5)[1] == 1


# ---------------------------------------------------------------------------
# part 2: the two frameworks read each other's snapshots


@pytest.mark.parametrize("seed", [0, 1, SEED, 12345, 2**31 - 1, 2**31,
                                  2**32 - 1])
def test_base_key_words_are_jax_prng_key_words(seed):
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)),
                      np.uint32)
    assert seed_key_words(seed).dtype == np.uint32
    np.testing.assert_array_equal(seed_key_words(seed), want)


@pytest.mark.parametrize("seed", [-1, 2**32])
def test_seeds_without_key_words_are_refused(seed):
    with pytest.raises(ValueError, match="outside"):
        seed_key_words(seed)


@pytest.mark.parametrize("knobs,extra", [
    ({}, {}),
    (dict(lr=5e-4, compress="int8"), dict(n_clients=4, mix="pushsum")),
    (dict(staleness=2, dropout_rate=0.25),
     dict(method="proxyfl", seed=0, n_clients=8, private=["mlp"] * 8,
          proxy="mlp")),
    (dict(local_steps=10, batch_size=8),
     dict(arch="repro-100m", proxy="repro-100m-proxy", clients=4,
          size_skew=0.0))])
def test_fingerprints_are_string_equal(knobs, extra):
    dp = dict(enabled=True, noise_multiplier=1.4)
    ours = ProxyFLConfig(dp=DPConfig(**dp), **knobs)
    theirs = JaxProxyFLConfig(dp=JaxDPConfig(**dp), **knobs)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert config_fingerprint(ours, **extra) == jax_fingerprint(theirs,
                                                                **extra)
    assert config_fingerprint(ProxyFLConfig()) == "ebcfd4defe2c8e14"


def test_default_exclusions_are_the_references():
    from repro.checkpoint.federation import \
        DEFAULT_FINGERPRINT_EXCLUDE as JAX_EXCLUDE
    assert DEFAULT_FINGERPRINT_EXCLUDE == JAX_EXCLUDE


def _assert_npz_equal(a, b):
    """Same key set, and each array equal in dtype, shape and bytes (the
    files themselves differ: zip members carry their write times)."""
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            x, y = za[k], zb[k]
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert x.tobytes() == y.tobytes(), k


def _jax_draws(base, theta_like):
    def draws(k, t, s):
        ck = jax.random.fold_in(jax_engine.round_key(base, t), k)
        for _ in range(s + 1):
            ck, kb, kn = jax.random.split(ck, 3)
        idx = jax.random.randint(kb, (B,), 0, N_PER)
        return np.asarray(idx), np.asarray(_flat_gaussian_like(theta_like,
                                                               kn))
    return draws


@pytest.fixture(scope="module", params=["loop", "vmap"])
def interop(request, tmp_path_factory):
    """A JAX run's round 1, checkpointed by the reference (``jdir``), and
    the same state carried into the port and checkpointed there
    (``tdir``); JAX's round 2 for the further-round comparison."""
    backend = request.param
    root = tmp_path_factory.mktemp(f"interop_{backend}")
    x, y = jax_data(jax.random.PRNGKey(0), K * N_PER, SHAPE, N_CLASSES,
                    sep=2.0)
    jdata = [(x[i * N_PER:(i + 1) * N_PER], y[i * N_PER:(i + 1) * N_PER])
             for i in range(K)]
    jv = jax_vision("mlp")
    jspec = JaxModelSpec("mlp", lambda k: jv.init(k, SHAPE, N_CLASSES),
                         jv.apply)
    jcfg = JaxProxyFLConfig(dp=JaxDPConfig(enabled=True), **CFG)
    ref = jax_engine.dml_engine((jspec,) * K, jspec, jcfg, backend=backend)
    q = B / N_PER
    ref.attach_accountants([JaxAccountant(1.0, q, 1e-5) for _ in range(K)])
    base = jax.random.PRNGKey(SEED)
    jstate = ref.init_states(base)
    jstate, _ = ref.run_round(jstate, jdata, 0, jax_engine.round_key(base,
                                                                       0))
    round1 = [jax.tree_util.tree_map(np.asarray, s)
              for s in ref.export_states(jstate)]
    jdir = str(root / "jax")
    JaxCheckpointer(jdir).save(ref, jstate, 0, base_key=base)
    jstate2, _ = ref.run_round(jstate, jdata, 1, jax_engine.round_key(base,
                                                                        1))
    round2 = [jax.tree_util.tree_map(np.asarray, s)
              for s in ref.export_states(jstate2)]

    tv = get_vision_model("mlp")
    tspec = ModelSpec("mlp", lambda g: tv.init(g, SHAPE, N_CLASSES),
                      tv.apply)
    tcfg = ProxyFLConfig(dp=DPConfig(enabled=True), **CFG)

    def port_engine(draws=None):
        eng = dml_engine((tspec,) * K, tspec, tcfg, backend=backend,
                         device="cpu", draws=draws)
        eng.attach_accountants([PrivacyAccountant(1.0, q, 1e-5)
                                for _ in range(K)])
        return eng

    carried = port_engine()
    for a in carried.accountants:
        a.steps = 1
    tdir = str(root / "port")
    FederationCheckpointer(tdir).save(
        carried, [convert.state_from_numpy(s) for s in round1], 0,
        seed=SEED)
    tdata = [(torch.as_tensor(np.array(a)), torch.as_tensor(np.array(b)))
             for a, b in jdata]
    return dict(backend=backend, ref=ref, jstate=jstate, round1=round1,
                round2=round2, jdir=jdir, tdir=tdir, tdata=tdata,
                port_engine=port_engine,
                draws=_jax_draws(base, round1[0]["proxy"]["params"]))


def _bits(a) -> np.ndarray:
    """A leaf's raw bytes as numpy (a bf16 leaf of either framework by its
    16-bit pattern)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_state_equals_numpy(ours, theirs):
    lo = tree_leaves(ours)
    lt = jax.tree_util.tree_leaves(theirs)
    assert len(lo) == len(lt)
    for a, b in zip(lo, lt):
        x, y = _bits(a), _bits(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_jax_snapshot_restores_into_the_port(interop):
    eng = interop["port_engine"]()
    ck = FederationCheckpointer(interop["jdir"], verify=True)
    state, done = ck.restore_latest(eng, like=eng.init_states(0), seed=SEED)
    assert done == 1
    assert [a.steps for a in eng.accountants] == [1] * K
    for ours, theirs in zip(eng.export_states(state), interop["round1"]):
        _assert_state_equals_numpy(ours, theirs)
        assert float(ours["w"]) == float(theirs["w"])
    with open(os.path.join(interop["jdir"], "round_000001.meta.json")) as f:
        assert ck.verify_chain(1) == json.load(f)["commitment"]
    with pytest.raises(ValueError, match="base RNG key"):
        ck.restore_latest(eng, like=eng.init_states(0), seed=SEED + 1)


def test_jax_snapshot_continues_on_the_port_at_close(interop):
    """Round 2 after the restore, on the reference's draws, against JAX's
    round 2 from the same snapshot."""
    eng = interop["port_engine"](draws=interop["draws"])
    state, start = FederationCheckpointer(interop["jdir"]).restore(
        eng, like=eng.init_states(0), seed=SEED)
    state, _ = eng.run_round(state, interop["tdata"], start, SEED)
    for ours, theirs in zip(eng.export_states(state), interop["round2"]):
        lo, lt = tree_leaves(ours), jax.tree_util.tree_leaves(theirs)
        assert len(lo) == len(lt)
        for a, b in zip(lo, lt):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **CLOSE)
    assert [a.steps for a in eng.accountants] == [2] * K


def test_port_snapshot_files_equal_the_references(interop):
    jdir, tdir = interop["jdir"], interop["tdir"]
    base = "round_000001"
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


def test_port_snapshot_restores_into_jax(interop):
    ref = interop["ref"]
    ck = JaxCheckpointer(interop["tdir"], verify=True)
    assert ck.verify_chain(1) is not None
    for a in ref.accountants:
        a.steps = 0
    state, done = ck.restore_latest(ref, like=interop["jstate"],
                                    base_key=jax.random.PRNGKey(SEED))
    assert done == 1 and [a.steps for a in ref.accountants] == [1] * K
    for ours, theirs in zip(ref.export_states(state), interop["round1"]):
        for a, b in zip(jax.tree_util.tree_leaves(ours),
                        jax.tree_util.tree_leaves(theirs)):
            assert np.asarray(a).dtype == b.dtype
            assert np.asarray(a).tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="base RNG key"):
        ck.restore_latest(ref, like=interop["jstate"],
                          base_key=jax.random.PRNGKey(SEED + 1))


def test_bf16_adam_state_moves_between_the_frameworks(tmp_path):
    """A bf16 proxy's Adam state (bf16 moments, the f32 master copy) saved
    by JAX restores into the port's template bit for bit, and back."""
    jopt = JaxAdam(lr=1e-3, moment_dtype="bfloat16")
    w = jnp.linspace(-1, 1, 6, dtype=jnp.bfloat16).reshape(2, 3)
    jstate = jopt.init({"w": w})
    jstate = jstate._replace(m={"w": w * 0.5}, t=jnp.asarray(4, jnp.int32))
    jtree = {"params": {"w": w}, "opt": jstate}
    jp = os.path.join(tmp_path, "jax")
    jax_save(jp, jtree)
    opt = Adam(lr=1e-3, moment_dtype="bfloat16")
    tw = torch.zeros(2, 3, dtype=torch.bfloat16)
    like = {"params": {"w": tw}, "opt": opt.init({"w": tw})}
    ours = load_checkpoint(jp, like)
    _assert_state_equals_numpy(ours, jtree)
    tp = os.path.join(tmp_path, "port")
    save_checkpoint(tp, ours)
    back = jax.tree_util.tree_map(np.asarray, jax_load(tp, jtree))
    _assert_state_equals_numpy(ours, back)
    _assert_npz_equal(jp + ".npz", tp + ".npz")


def test_a_jax_train_driver_snapshot_resumes_in_the_port_driver(tmp_path):
    """A snapshot in the reference train driver's layout and fingerprint
    (qwen1.5-4b's smoke variant, bf16 params with their f32 master
    copies, K = 2, after round 1) restores into the port driver's state
    bit for bit; ``python -m repro_torch.launch.train ... --resume`` then
    runs round 2 into the same directory, and the reference's
    ``verify_chain`` accepts the chain the two frameworks wrote."""
    from test_torch_train_step import reference_state
    from repro_torch.launch import train

    d = str(tmp_path)
    argv = ["--arch", "qwen1.5-4b", "--smoke", "--clients", "2",
            "--steps-per-round", "1", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--rounds", "2", "--checkpoint-dir", d]
    args = train.parse_args(argv)
    run = train.setup(args)
    jfl = JaxProxyFLConfig(**{**dataclasses.asdict(run.fl),
                              "dp": JaxDPConfig(**dataclasses.asdict(
                                  run.fl.dp))})
    jstates = [reference_state("qwen1.5-4b", run.cfg.dtype, seed=k)
               for k in range(2)]
    ref = jax_engine.FederationEngine(
        jfl, n_clients=2, step_fns=lambda *a: a, init_fns=lambda k: {},
        sample_fn=lambda *a: a, backend="loop")
    ref.attach_accountants([JaxAccountant(1.0, 2 / 64, 1e-5, steps=1)
                            for _ in range(2)])
    JaxCheckpointer(d, fingerprint=jax_fingerprint(
        jfl, arch=run.cfg.name, proxy=run.proxy.name, clients=2,
        size_skew=0.0)).save(ref, jstates, 0,
                             base_key=jax.random.PRNGKey(0))
    state, start = train.checkpointer(run, args).restore_latest(
        run.engine, like=run.state, seed=0)
    assert start == 1 and [a.steps for a in run.engine.accountants] == [1, 1]
    assert run.cfg.dtype == "bfloat16"
    for ours, theirs in zip(state, jstates):
        _assert_state_equals_numpy(ours, jax.tree_util.tree_map(np.asarray,
                                                                theirs))
    assert train.main(argv + ["--resume"]) == 0
    assert FederationCheckpointer(d).saved_rounds() == [1, 2]
    assert JaxCheckpointer(d, verify=True).verify_chain(2) is not None

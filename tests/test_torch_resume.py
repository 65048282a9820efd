"""Kill and resume in the port, on the CPU: a run killed after round t and
resumed from its checkpoint finishes bit-identically to the uninterrupted
run (every param leaf, the de-bias weights, epsilon exactly), through
``run_federated`` (proxyfl on vmap and loop, fedavg, a sparse cadence), the
engine (async τ = 2 across its in-flight buffer, compressed int8 with its
public copies), the train driver's ``--checkpoint-dir/--resume`` and
``bench_methods``' environment knobs; a tampered snapshot, a changed
configuration and another seed are refused (``tests/test_checkpoint.py``,
``tests/test_compress.py`` and ``tests/test_commit.py``'s contracts).

Sizes: mlp on 14x14x1 images, K = 4 clients of 96 examples, B = 16,
at most 3 rounds of 2 local steps.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.benchmarks import common  # noqa: E402
from repro_torch.checkpoint import FederationCheckpointer  # noqa: E402
from repro_torch.configs import DPConfig, ProxyFLConfig  # noqa: E402
from repro_torch.core.accountant import PrivacyAccountant  # noqa: E402
from repro_torch.core.baselines import run_federated  # noqa: E402
from repro_torch.core.commit import CommitmentError  # noqa: E402
from repro_torch.core.engine import dml_engine  # noqa: E402
from repro_torch.core.protocol import ModelSpec  # noqa: E402
from repro_torch.data.synthetic import make_classification_data  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402
from repro_torch.nn.vision import get_vision_model  # noqa: E402

K, N_CLASSES, SHAPE, N_PER, B = 4, 10, (14, 14, 1), 96, 16
SMOKE = ["--smoke", "--clients", "2", "--steps-per-round", "1", "--batch",
         "2", "--seq", "16", "--device", "cpu"]


@pytest.fixture(scope="module")
def fed_data():
    x, y = make_classification_data(torch.Generator().manual_seed(0),
                                    K * N_PER, SHAPE, N_CLASSES, sep=2.0)
    return [(x[i * N_PER:(i + 1) * N_PER], y[i * N_PER:(i + 1) * N_PER])
            for i in range(K)]


@pytest.fixture(scope="module")
def spec():
    vm = get_vision_model("mlp")
    return ModelSpec("mlp", lambda g: vm.init(g, SHAPE, N_CLASSES), vm.apply)


def _cfg(**kw):
    base = dict(n_clients=K, rounds=3, batch_size=B, local_steps=2,
                dp=DPConfig(enabled=True))
    return ProxyFLConfig(**{**base, **kw})


def _run(method, spec, data, cfg, backend="vmap", **kw):
    return run_federated(method, [spec] * K, spec, data, data[0], cfg,
                         seed=0, eval_every=cfg.rounds, backend=backend,
                         device="cpu", **kw)


def _leaves(res, roles):
    return [leaf for c in res["clients"] for role in roles
            for leaf in tree_leaves(getattr(c, role))]


def _assert_bit_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _kill_and_resume(method, spec, data, cfg, tmp_path, kill_after,
                     backend="vmap", **kw):
    """(uninterrupted result, resumed result): the killed run stops after
    ``kill_after`` rounds with checkpoints on, the resume finishes it."""
    full = _run(method, spec, data, cfg, backend, **kw)
    d = str(tmp_path)
    _run(method, spec, data, dataclasses.replace(cfg, rounds=kill_after),
         backend, checkpoint_dir=d, **kw)
    resumed = _run(method, spec, data, cfg, backend, checkpoint_dir=d,
                   resume=True, **kw)
    return full, resumed


@pytest.mark.parametrize("backend", ["vmap", "loop"])
def test_proxyfl_resume_is_bit_identical(tmp_path, fed_data, spec, backend):
    """Killed after round 1 of 3 (DP and §3.4 dropout on, so the active
    masks replay too): every private and proxy leaf, the de-bias weights
    and epsilon equal the uninterrupted run's; history resumes at round
    3."""
    cfg = _cfg(dropout_rate=0.25, seed=5)
    full, resumed = _kill_and_resume("proxyfl", spec, fed_data, cfg,
                                     tmp_path, 1, backend)
    _assert_bit_equal(_leaves(full, ("private_params", "proxy_params",
                                     "private_opt", "proxy_opt")),
                      _leaves(resumed, ("private_params", "proxy_params",
                                        "private_opt", "proxy_opt")))
    assert [c.w for c in full["clients"]] == [c.w for c in
                                               resumed["clients"]]
    assert full["epsilon"] == resumed["epsilon"]
    assert [h["round"] for h in resumed["history"]] == [3]
    ckpt = FederationCheckpointer(os.path.join(str(tmp_path), "proxyfl_s0"))
    assert ckpt.saved_rounds() == [1, 2, 3]


def test_single_model_method_resumes(tmp_path, fed_data, spec):
    cfg = _cfg(rounds=2, dp=DPConfig(enabled=False))
    full, resumed = _kill_and_resume("fedavg", spec, fed_data, cfg,
                                     tmp_path, 1)
    _assert_bit_equal(_leaves(full, ("params",)), _leaves(resumed,
                                                          ("params",)))


def test_resume_replays_from_the_last_snapshot_on_the_cadence(
        tmp_path, fed_data, spec):
    """checkpoint_every=2 over 3 rounds: one snapshot, after round 2 (the
    cadence, not the end of the run); a resume from it replays round 3
    into the uninterrupted run's final state."""
    cfg = _cfg(dp=DPConfig(enabled=False))
    full = _run("proxyfl", spec, fed_data, cfg)
    d = str(tmp_path)
    _run("proxyfl", spec, fed_data, cfg, checkpoint_dir=d,
         checkpoint_every=2)
    ckpt = FederationCheckpointer(os.path.join(d, "proxyfl_s0"))
    assert ckpt.saved_rounds() == [2]
    resumed = _run("proxyfl", spec, fed_data, cfg, checkpoint_dir=d,
                   checkpoint_every=2, resume=True)
    assert [h["round"] for h in resumed["history"]] == [3]
    _assert_bit_equal(_leaves(full, ("private_params", "proxy_params")),
                      _leaves(resumed, ("private_params", "proxy_params")))


def test_resume_of_a_finished_run_reevaluates(tmp_path, fed_data, spec):
    cfg = _cfg(rounds=1, dp=DPConfig(enabled=False))
    d = str(tmp_path)
    first = _run("proxyfl", spec, fed_data, cfg, checkpoint_dir=d)
    again = _run("proxyfl", spec, fed_data, cfg, checkpoint_dir=d,
                 resume=True)
    assert [h["round"] for h in again["history"]] == [1]
    assert again["history"] == first["history"]
    _assert_bit_equal(_leaves(first, ("proxy_params",)),
                      _leaves(again, ("proxy_params",)))


def _engine_kill_and_resume(spec, data, cfg, tmp_path, rounds, kill_after,
                            backend):
    """Engine-level kill and resume: (uninterrupted state after
    ``kill_after`` rounds, its final state, the restored state, the
    resumed final state)."""
    def make():
        eng = dml_engine((spec,) * K, spec, cfg, backend=backend,
                         device="cpu")
        eng.attach_accountants([PrivacyAccountant(1.0, B / N_PER)
                                for _ in range(K)])
        return eng

    eng = make()
    state = eng.init_states(0)
    mid = None
    for t in range(rounds):
        state, _ = eng.run_round(state, data, t, 0)
        if t + 1 == kill_after:
            mid = state
    killed = make()
    ckpt = FederationCheckpointer(str(tmp_path), every=1)
    st = killed.init_states(0)
    for t in range(kill_after):
        st, _ = killed.run_round(st, data, t, 0)
        ckpt.maybe_save(killed, st, t, seed=0)
    res = make()
    restored, start = ckpt.restore_latest(res, like=res.init_states(0),
                                          seed=0)
    assert start == kill_after
    assert [a.steps for a in res.accountants] == [a.steps for a in
                                                  killed.accountants]
    st = restored
    for t in range(start, rounds):
        st, _ = res.run_round(st, data, t, 0)
    assert [a.epsilon() for a in res.accountants] == [
        a.epsilon() for a in eng.accountants]
    return mid, state, restored, st


def test_async_resume_restores_the_in_flight_buffer(tmp_path, fed_data,
                                                    spec):
    """Async τ = 2, killed after round 2 of 3: the restored buffer holds
    the mail still in flight bit for bit, and round 3 delivers it."""
    cfg = _cfg(staleness=2, dp=DPConfig(enabled=False))
    mid, full, restored, resumed = _engine_kill_and_resume(
        spec, fed_data, cfg, tmp_path, 3, 2, "async")
    for key in ("stale_theta", "stale_w"):
        assert torch.equal(restored[key], mid[key])
        assert torch.equal(resumed[key], full[key])
    assert float(restored["stale_theta"].abs().sum()) > 0
    _assert_bit_equal(tree_leaves(full["clients"]),
                      tree_leaves(resumed["clients"]))


def test_compressed_resume_restores_the_public_copies(tmp_path, fed_data,
                                                      spec):
    """int8 with error feedback, killed after round 1 of 2: the public
    copies come back bit for bit and the run finishes identically; a
    resume under top-k is refused by the fingerprint."""
    cfg = _cfg(rounds=2, compress="int8")
    mid, full, restored, resumed = _engine_kill_and_resume(
        spec, fed_data, cfg, tmp_path, 2, 1, "vmap")
    assert torch.equal(restored["ef_state"], mid["ef_state"])
    assert torch.equal(resumed["ef_state"], full["ef_state"])
    _assert_bit_equal(tree_leaves(full["clients"]),
                      tree_leaves(resumed["clients"]))
    d = str(tmp_path / "driver")
    _run("proxyfl", spec, fed_data, dataclasses.replace(cfg, rounds=1),
         checkpoint_dir=d)
    with pytest.raises(ValueError, match="fingerprint"):
        _run("proxyfl", spec, fed_data,
             dataclasses.replace(cfg, compress="topk"), checkpoint_dir=d,
             resume=True)


def _flip_bit(npz_path, key_part):
    """Flip one mantissa bit of the first entry of the first leaf whose
    key contains ``key_part``; returns that key."""
    with np.load(npz_path) as z:
        arrays = {k: z[k] for k in z.files}
    key = next(k for k in arrays if key_part in k)
    a = arrays[key].copy()
    a.reshape(-1).view(np.uint32)[0] ^= 1
    arrays[key] = a
    np.savez(npz_path, **arrays)
    return key


def test_strict_verify_and_a_flipped_bit_are_refused(tmp_path, fed_data,
                                                     spec):
    """Under ``verify_commitments`` the resume replays the chain: a
    snapshot with one proxy bit flipped after it was committed is refused
    with ``CommitmentError`` naming the round and the leaf; a directory
    without an audit trail is refused in strict mode."""
    cfg = _cfg(rounds=2, dp=DPConfig(enabled=False), verify_commitments=True)
    d = str(tmp_path)
    _run("proxyfl", spec, fed_data, dataclasses.replace(cfg, rounds=1),
         "loop", checkpoint_dir=d)
    resumed = _run("proxyfl", spec, fed_data, cfg, "loop", checkpoint_dir=d,
                   resume=True)
    assert resumed["history"][-1]["round"] == 2
    run_dir = os.path.join(d, "proxyfl_s0")
    key = _flip_bit(os.path.join(run_dir, "round_000002.npz"),
                    "c0001/proxy/params/")
    with pytest.raises(CommitmentError) as e:
        _run("proxyfl", spec, fed_data, cfg, "loop", checkpoint_dir=d,
             resume=True)
    assert e.value.round == 2 and e.value.client == 1
    assert e.value.leaf == key.split("c0001/")[1]
    os.remove(os.path.join(run_dir, "audit.jsonl"))
    for name in os.listdir(run_dir):
        if name.endswith(".meta.json"):
            path = os.path.join(run_dir, name)
            with open(path) as f:
                meta = json.load(f)
            meta.pop("commitment")
            with open(path, "w") as f:
                json.dump(meta, f)
    with pytest.raises(CommitmentError, match="no commitment records"):
        _run("proxyfl", spec, fed_data, cfg, "loop", checkpoint_dir=d,
             resume=True)


def test_another_seed_is_refused(tmp_path, fed_data, spec):
    cfg = _cfg(rounds=1, dp=DPConfig(enabled=False))
    eng = dml_engine((spec,) * K, spec, cfg, device="cpu")
    state, _ = eng.run_round(eng.init_states(0), fed_data, 0, 0)
    ckpt = FederationCheckpointer(str(tmp_path))
    ckpt.save(eng, state, 0, seed=0)
    assert ckpt.restore(eng, seed=0)[1] == 1
    with pytest.raises(ValueError, match="base RNG key"):
        ckpt.restore(eng, seed=1)
    with pytest.raises(ValueError, match="outside"):
        ckpt.save(eng, state, 1, seed=-1)


def test_train_driver_resumes_bit_identically(tmp_path):
    """The LLM driver on qwen1.5-4b's smoke variant: 2 rounds straight,
    and 1 round then ``--resume`` from ``--checkpoint-dir``."""
    argv = ["--arch", "qwen1.5-4b"] + SMOKE
    _, full = train.train(train.parse_args(argv + ["--rounds", "2"]))
    d = str(tmp_path)
    assert train.main(argv + ["--rounds", "1", "--checkpoint-dir", d]) == 0
    run, resumed = train.train(train.parse_args(
        argv + ["--rounds", "2", "--checkpoint-dir", d, "--resume"]))
    _assert_bit_equal(tree_leaves(full), tree_leaves(resumed))
    assert run.engine.accountants[0].steps == 2
    assert FederationCheckpointer(d).saved_rounds() == [1, 2]
    with pytest.raises(ValueError, match="fingerprint"):
        train.main(argv + ["--rounds", "2", "--checkpoint-dir", d,
                           "--resume", "--size-skew", "0.5"])


def test_bench_methods_reads_the_checkpoint_environment(tmp_path,
                                                        monkeypatch):
    kw = dict(n_clients=2, seeds=(0,), n_train_factor=0.02, device="cpu",
              batch_size=8)
    full = common.bench_methods("mnist", ("proxyfl",), rounds=2, **kw)
    monkeypatch.setenv("REPRO_BENCH_CKPT_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_BENCH_CKPT_EVERY", "1")
    common.bench_methods("mnist", ("proxyfl",), rounds=1, **kw)
    run_dir = os.path.join(str(tmp_path), "mnist", "proxyfl_s0")
    assert FederationCheckpointer(run_dir).saved_rounds() == [1]
    monkeypatch.setenv("REPRO_BENCH_RESUME", "1")
    resumed = common.bench_methods("mnist", ("proxyfl",), rounds=2, **kw)
    assert FederationCheckpointer(run_dir).saved_rounds() == [1, 2]
    for a, b in zip(full, resumed):
        assert a["acc_mean"] == b["acc_mean"] and a["epsilon"] == b["epsilon"]

"""Round-blocks on the port (port of tests/test_blocks.py): any block size
replays the per-round trajectory bit for bit, on the CPU.

* ``FederationEngine.run_rounds`` in blocks of any size equals B = 1 bit
  for bit on ``vmap``, ``async`` τ = 2 and ``hier`` S = 2 (τ 0 and 2),
  with §3.4 dropout; the metrics come back [T, K] with NaN where a client
  was dropped; the accountants, stepped once per block, land on the
  per-round counters and epsilon.
* ``async`` at τ = 0 and ``hier`` at S > 1, τ = 0 equal stacked ``vmap``
  bit for bit (the shared stacked local phase).
* ``run_federated(rounds_per_block=)``: the snapshots and history rows at
  block edges cut at the checkpoint and evaluation cadences, a resume from
  a block edge bit-equal to the straight run; ``bench_methods``' block
  knob (``REPRO_BENCH_BLOCK``); the ``fig_blocks`` and ``fig_ragged``
  drivers at tiny sizes.

K ≤ 8, a 14x14x1 mlp, DP on unless a driver's protocol has it off.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.benchmarks import common, fig_blocks, fig_ragged  # noqa: E402
from repro_torch.configs import DPConfig, ProxyFLConfig  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.accountant import PrivacyAccountant  # noqa: E402
from repro_torch.core.baselines import run_federated  # noqa: E402
from repro_torch.core.protocol import ModelSpec  # noqa: E402
from repro_torch.data.synthetic import make_classification_data  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402
from repro_torch.nn.vision import get_vision_model  # noqa: E402

K, N_CLASSES, SHAPE, N = 4, 10, (14, 14, 1), 24
ROUNDS = 4


def _spec():
    vm = get_vision_model("mlp")
    return ModelSpec("mlp", lambda g: vm.init(g, SHAPE, N_CLASSES), vm.apply)


def _data(k=K, n=N, seed=0):
    x, y = make_classification_data(torch.Generator().manual_seed(seed),
                                    k * n, SHAPE, N_CLASSES, sep=2.0)
    return [(x[i * n:(i + 1) * n], y[i * n:(i + 1) * n]) for i in range(k)]


def _cfg(**kw):
    base = dict(n_clients=K, rounds=ROUNDS, local_steps=2, batch_size=8,
                use_pallas=True, dropout_rate=0.25, min_active=2,
                dp=DPConfig(enabled=True))
    base.update(kw)
    return ProxyFLConfig(**base)


def _engine(cfg, backend):
    spec = _spec()
    eng = engine.dml_engine((spec,) * K, spec, cfg, backend=backend,
                            device="cpu")
    eng.attach_accountants([PrivacyAccountant(1.0, 8 / N, 1e-5)
                            for _ in range(K)])
    return eng


def _blocks(cfg, backend, block, data):
    eng = _engine(cfg, backend)
    state, rows = eng.init_states(0), []
    for t, n in engine.block_spans(0, ROUNDS, block):
        state, m = eng.run_rounds(state, data, t, n, seed=1)
        rows.append(m)
    return state, eng, {k: np.concatenate([r[k] for r in rows])
                        for k in rows[0]}


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


CONFIGS = {"vmap": ("vmap", {}),
           "async tau=2": ("async", dict(staleness=2)),
           "hier S=2": ("hier", dict(n_shards=2)),
           "hier S=2 tau=2": ("hier", dict(n_shards=2, staleness=2))}


@pytest.mark.parametrize("block", [2, 3, ROUNDS])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_any_block_size_is_bit_equal_to_per_round(name, block):
    backend, kw = CONFIGS[name]
    cfg = _cfg(**kw)
    data = _data()
    one, e1, m1 = _blocks(cfg, backend, 1, data)
    many, e2, m2 = _blocks(cfg, backend, block, data)
    assert e1.stacked and _equal(one, many)
    for key in m1:
        np.testing.assert_array_equal(m1[key], m2[key])
    assert [a.steps for a in e1.accountants] == \
        [a.steps for a in e2.accountants]
    assert [a.epsilon() for a in e1.accountants] == \
        [a.epsilon() for a in e2.accountants]


def test_block_metrics_are_t_by_k_with_nan_for_dropped_clients():
    cfg = _cfg()
    eng = _engine(cfg, "vmap")
    _, m = eng.run_rounds(eng.init_states(0), _data(), 0, ROUNDS, seed=1)
    act = engine.active_schedule(0, ROUNDS, K, cfg)
    assert act is not None and not act.all()
    assert sorted(m) == ["private_loss", "proxy_loss"]
    for v in m.values():
        assert v.shape == (ROUNDS, K)
        assert np.isnan(v[~act]).all() and np.isfinite(v[act]).all()


def test_block_accountants_step_once_per_active_round():
    """Bulk-stepped at the block's edge: each client's steps are its active
    rounds × its local steps, the per-round loop's counters."""
    cfg = _cfg()
    eng = _engine(cfg, "vmap")
    eng.run_rounds(eng.init_states(0), _data(), 0, ROUNDS, seed=1)
    act = engine.active_schedule(0, ROUNDS, K, cfg)
    assert [a.steps for a in eng.accountants] == \
        [int(act[:, k].sum()) * cfg.local_steps for k in range(K)]
    loop = _engine(cfg, "loop")
    state = loop.init_states(0)
    for t in range(ROUNDS):
        state, _ = loop.run_round(state, _data(), t, seed=1)
    assert [a.epsilon() for a in eng.accountants] == \
        [a.epsilon() for a in loop.accountants]


@pytest.mark.parametrize("other", [("async", dict(staleness=0)),
                                   ("hier", dict(n_shards=2)),
                                   ("hier", dict(n_shards=4))])
def test_tau0_backends_equal_stacked_vmap(other):
    backend, kw = other
    data = _data()
    ref, _, mr = _blocks(_cfg(), "vmap", 2, data)
    got, eng, mg = _blocks(_cfg(**kw), backend, 2, data)
    assert eng.stacked and eng.backend == backend
    assert _equal(ref, got)
    for key in mr:
        np.testing.assert_array_equal(mr[key], mg[key])


def test_a_block_leaves_the_input_state_untouched():
    eng = _engine(_cfg(), "vmap")
    state = eng.init_states(0)
    before = [x.clone() for x in tree_leaves(state)]
    eng.run_rounds(state, _data(), 0, 2, seed=1)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 tree_leaves(state)))
    with pytest.raises(ValueError, match="at least one round"):
        eng.run_rounds(state, _data(), 0, 0, seed=1)


# ---------------------------------------------------------------------------
# the driver loop


def _federate(tmp_path=None, **kw):
    spec = _spec()
    data = _data()
    test = _data(1, 40, seed=1)[0]
    cfg = _cfg(rounds=kw.pop("rounds", ROUNDS))
    return run_federated("proxyfl", [spec] * K, spec, data, test, cfg,
                         seed=0, device="cpu", **kw)


def _leaves(res):
    return [x for c in res["clients"] for x in tree_leaves(
        (c.private_params, c.proxy_params, c.proxy_opt))]


@pytest.mark.parametrize("backend", ["vmap", "loop"])
def test_run_federated_blocks_equal_per_round(backend):
    one = _federate(backend=backend, eval_every=2, rounds_per_block=1)
    many = _federate(backend=backend, eval_every=2, rounds_per_block=3)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(one),
                                                 _leaves(many)))
    assert [r["round"] for r in many["history"]] == [2, 4]
    assert many["history"] == one["history"]
    assert many["epsilon"] == one["epsilon"]


def test_checkpoints_land_on_block_edges_and_resume_bit_equal(tmp_path):
    """Blocks of 4 cut at the cadence of 2: snapshots after rounds 2 and 4,
    as per round; a run killed after round 2 resumes at that edge and ends
    where the straight run does."""
    straight = _federate(eval_every=4, rounds_per_block=4,
                         checkpoint_dir=str(tmp_path / "a"),
                         checkpoint_every=2)
    snaps = sorted(p.name for p in (tmp_path / "a" / "proxyfl_s0").glob(
        "round_*.npz"))
    assert snaps == ["round_000002.npz", "round_000004.npz"]
    _federate(rounds=2, eval_every=2, rounds_per_block=4,
              checkpoint_dir=str(tmp_path / "b"), checkpoint_every=2)
    resumed = _federate(eval_every=4, rounds_per_block=4,
                        checkpoint_dir=str(tmp_path / "b"),
                        checkpoint_every=2, resume=True)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(straight),
                                                 _leaves(resumed)))
    assert resumed["epsilon"] == straight["epsilon"]
    assert [r["round"] for r in resumed["history"]] == [4]


def test_bench_methods_block_knob(monkeypatch):
    kw = dict(n_clients=2, rounds=2, seeds=(0,), device="cpu", dp=False,
              n_train_factor=0.01, batch_size=8, local_steps=1)
    for var in list(os.environ):
        if var.startswith("REPRO_BENCH_"):
            monkeypatch.delenv(var)
    base = common.bench_methods("mnist", ("fedavg",), **kw)
    monkeypatch.setenv("REPRO_BENCH_BLOCK", "2")
    seen = []
    real = common.run_federated
    monkeypatch.setattr(common, "run_federated", lambda *a, **k: (
        seen.append(k["rounds_per_block"]), real(*a, **k))[1])
    blocked = common.bench_methods("mnist", ("fedavg",), **kw)
    assert seen == [2]
    assert blocked[0]["acc_mean"] == base[0]["acc_mean"]
    assert blocked[0]["epsilon"] == base[0]["epsilon"]


# ---------------------------------------------------------------------------
# the drivers


def test_fig_blocks_rows(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_BENCH_BLOCKS_JSON", str(tmp_path / "b.json"))
    rows = fig_blocks.run(False, "cpu", clients=(2,), rounds=2,
                          n_train_factor=0.01)
    assert json.loads((tmp_path / "b.json").read_text()) == rows
    assert [(r["backend"], r["rounds_per_block"]) for r in rows] == \
        [("loop", 1)] + [("vmap", b) for b in fig_blocks.BLOCKS]
    for r in rows:
        assert r["clients"] == 2 and r["sec_per_round"] > 0
        assert r["card"] == "the CPU"
        if r["rounds_per_block"] == 1:
            assert r["speedup_vs_b1"] == 1.0


def test_fig_ragged_rows(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_BENCH_RAGGED_JSON", str(tmp_path / "r.json"))
    rows = fig_ragged.run(False, "cpu", rounds=1, n_train_factor=0.02)
    assert json.loads((tmp_path / "r.json").read_text()) == rows
    assert [(r["regime"], r["backend"]) for r in rows] == [
        (g, b) for g in ("gossip", "epoch") for b in ("loop", "vmap")]
    for r in rows:
        assert r["min_client"] < r["max_client"]
        assert 0 < r["pad_fraction"] < 1 and r["sec_per_round"] > 0
    assert rows[0]["speedup_vs_loop"] == 1.0

"""The port's drivers that need no new engine work, at a tiny size on the
CPU: ``bench_methods``' engine knobs and their environment variables (the
reference's, ``benchmarks/common.py``), ``fig_hier``, ``fig_kernels`` and
``fig_async`` (the reference's row keys, the analytic columns against the
JAX package's schedule, fig_async's τ = 0 row equal to the async backend
at τ = 0 exactly), and the runner's registry (every ``fig_*`` file of
``src/repro_torch/benchmarks`` registered and listed)."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

from repro.core import gossip as jax_gossip  # noqa: E402
from repro_torch.benchmarks import (common, fig_async, fig_hier,  # noqa: E402
                                    fig_kernels, run as runner)
from repro_torch.configs import DPConfig, ProxyFLConfig  # noqa: E402
from repro_torch.core.baselines import run_federated  # noqa: E402
from repro_torch.nn.modules import tree_size  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "benchmarks"
ENV = ("REPRO_BENCH_BACKEND", "REPRO_BENCH_STALENESS", "REPRO_BENCH_SHARDS",
       "REPRO_BENCH_PALLAS", "REPRO_BENCH_VERIFY", "REPRO_BENCH_COMPRESS",
       "REPRO_BENCH_COMPRESS_RATIO", "REPRO_BENCH_CKPT_DIR",
       "REPRO_BENCH_CKPT_EVERY", "REPRO_BENCH_RESUME")
TINY = dict(n_clients=4, rounds=1, seeds=(0,), n_train_factor=0.01,
            device="cpu")


@pytest.fixture
def no_bench_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.fixture
def captured(no_bench_env):
    """``bench_methods``' calls of ``run_federated``: (config, backend)."""
    seen = []

    def capture(method, privs, prox, data, test, cfg, **kw):
        seen.append((cfg, kw.get("backend")))
        return {"history": [{"round": 1, "acc": [0.5] * len(data)}],
                "epsilon": [None] * len(data), "clients": []}

    no_bench_env.setattr(common, "run_federated", capture)
    return seen


def test_bench_methods_defaults(captured):
    common.bench_methods("mnist", ("fedavg",), **TINY)
    ((cfg, backend),) = captured
    assert backend == "auto"
    default = ProxyFLConfig()
    assert (cfg.staleness, cfg.n_shards, cfg.use_pallas, cfg.compress,
            cfg.compress_ratio, cfg.verify_commitments) == \
        (0, 1, True, "none", default.compress_ratio, False)
    for name in ("local_steps", "lr", "weight_decay", "topology",
                 "min_active"):
        assert getattr(cfg, name) == getattr(default, name), name


KNOBS = dict(backend="hier", staleness=2, n_shards=2, use_pallas=False,
             compress="int8", compress_ratio=0.5, verify_commitments=True,
             local_steps=3, lr=0.01, weight_decay=0.0, topology="ring",
             min_active=2)


def test_bench_methods_passes_every_knob(captured):
    common.bench_methods("mnist", ("fedavg",), **TINY, **KNOBS)
    ((cfg, backend),) = captured
    assert backend == "hier"
    for name, value in KNOBS.items():
        if name != "backend":
            assert getattr(cfg, name) == value, name


def test_bench_methods_reads_the_references_environment(captured,
                                                        no_bench_env):
    env = dict(REPRO_BENCH_BACKEND="hier", REPRO_BENCH_STALENESS="2",
               REPRO_BENCH_SHARDS="2", REPRO_BENCH_PALLAS="0",
               REPRO_BENCH_VERIFY="yes", REPRO_BENCH_COMPRESS="topk",
               REPRO_BENCH_COMPRESS_RATIO="0.125")
    for name, value in env.items():
        no_bench_env.setenv(name, value)
    common.bench_methods("mnist", ("fedavg",), **TINY)
    ((cfg, backend),) = captured
    assert backend == "hier"
    assert (cfg.staleness, cfg.n_shards, cfg.use_pallas,
            cfg.verify_commitments, cfg.compress, cfg.compress_ratio) == \
        (2, 2, False, True, "topk", 0.125)


@pytest.mark.parametrize("knobs,env,message", [
    (dict(staleness=1), {}, "requires backend='async' or 'hier'"),
    (dict(staleness=1, backend="vmap"), {}, "REPRO_BENCH_BACKEND=async"),
    (dict(n_shards=2), {}, "requires backend='hier'"),
    (dict(n_shards=2, backend="async"), {}, "REPRO_BENCH_BACKEND=hier"),
    ({}, dict(REPRO_BENCH_SHARDS="2"), "requires backend='hier'"),
    ({}, dict(REPRO_BENCH_COMPRESS_RATIO="a"), "must be a float"),
    ({}, dict(REPRO_BENCH_STALENESS="x"), "must be an integer"),
])
def test_bench_methods_refusals(captured, no_bench_env, knobs, env,
                                message):
    for name, value in env.items():
        no_bench_env.setenv(name, value)
    with pytest.raises(SystemExit, match=message):
        common.bench_methods("mnist", ("fedavg",), **TINY, **knobs)
    assert not captured


def test_bench_methods_hier_rows_equal_vmaps(no_bench_env):
    """Two shards at τ = 0 run the vmap trajectory bit for bit, so the
    rows' accuracies and epsilon are the same numbers."""
    kw = dict(TINY, n_clients=4, rounds=2)
    hier = common.bench_methods("mnist", ("proxyfl",), backend="hier",
                                n_shards=2, **kw)
    flat = common.bench_methods("mnist", ("proxyfl",), backend="vmap", **kw)
    for a, b in zip(hier, flat):
        for key in ("method", "acc_mean", "acc_std", "epsilon"):
            assert a[key] == b[key], key


# ---------------------------------------------------------------------------
# the figure drivers


# the reference's row keys (benchmarks/fig_hier.py, fig_kernels.py,
# fig_async.py)
HIER_KEYS = {"figure", "K", "backend", "n_shards", "staleness",
             "rounds_per_block", "devices", "sec_per_round",
             "rounds_per_sec", "speedup_vs_loop", "bytes_cross_per_client",
             "note"}
KERNELS_KEYS = {"dataset", "clients", "d_params", "path", "sec_per_round",
                "rounds_per_sec", "exchange_bytes_per_round",
                "speedup_fused"}
ASYNC_KEYS = {"dataset", "clients", "rounds", "staleness", "backend",
              "proxy_acc_mean", "proxy_acc_std", "private_acc_mean",
              "acc_delta_vs_sync", "sec_per_round", "rounds_per_sec"}


def test_fig_hier_rows(no_bench_env, tmp_path):
    path = tmp_path / "fig_hier.json"
    no_bench_env.setenv("REPRO_BENCH_HIER_JSON", str(path))
    rows = fig_hier.run(False, "cpu", clients=(8, 16), rounds=2)
    assert json.loads(path.read_text()) == rows
    # the reference's shard_map row where K is the device count: 8 gloo
    # ranks on the CPU, at K = 8 only
    assert [(r["K"], r["backend"], r["n_shards"], r["staleness"])
            for r in rows] == [
        (K, b, s, t) for K in (8, 16)
        for b, s, t in (("loop", 1, 0), ("vmap", 1, 0), ("hier", 8, 0),
                        ("hier", 8, 2)) + ((("shard_map", 8, 0),)
                                           if K == 8 else ())]
    D = tree_size(fig_hier.spec_of("mlp", fig_hier.SHAPE,
                                   fig_hier.N_CLASSES).init(
        torch.Generator().manual_seed(0)))
    for r in rows:
        assert HIER_KEYS <= set(r) and r["card"] == "the CPU"
        # each timed pass is one block of the 2 rounds
        assert r["rounds_per_block"] == 2 and r["sec_per_round"] > 0
        if r["backend"] == "loop":
            assert r["speedup_vs_loop"] == 1.0
        if r["backend"] == "hier":
            _, _, scale = jax_gossip.hier_mix_schedule("pushsum", 0, 2,
                                                       r["K"], 8)
            assert r["bytes_cross_per_client"] == \
                float((np.asarray(scale) > 0).mean()) * 4 * D
        elif r["backend"] == "shard_map":
            assert r["bytes_cross_per_client"] == 4.0 * D
            assert r["devices"] == fig_hier.CPU_RANKS
        else:
            assert r["bytes_cross_per_client"] is None
        assert bool(r["note"]) == bool(r["staleness"]
                                       or r["backend"] == "shard_map")


def test_fig_kernels_rows(no_bench_env, tmp_path):
    no_bench_env.setenv("REPRO_BENCH_KERNELS_JSON",
                        str(tmp_path / "k.json"))
    rows = fig_kernels.run(False, "cpu", clients=(4,), rounds=1,
                           n_train_factor=0.05)
    assert [(r["clients"], r["path"]) for r in rows] == [(4, "plain"),
                                                         (4, "fused")]
    for r in rows:
        assert KERNELS_KEYS <= set(r) and r["d_params"] == 199_210
        k_d = 4 * 4 * 199_210
        assert r["exchange_bytes_per_round"] == (
            2 if r["path"] == "fused" else 4) * k_d
    assert rows[0]["speedup_fused"] == 1.0


def test_fig_async_tau0_row_is_the_async_backend_at_tau0(no_bench_env,
                                                         tmp_path):
    """The τ = 0 row runs the sync backend, which the async backend at τ =
    0 equals exactly: the same accuracies, to the last bit."""
    no_bench_env.setenv("REPRO_BENCH_ASYNC_JSON", str(tmp_path / "a.json"))
    rows = fig_async.run(False, "cpu", rounds=2, n_train_factor=0.05)
    assert [r["staleness"] for r in rows] == list(fig_async.STALENESS)
    for r in rows:
        # the whole horizon is one block
        assert ASYNC_KEYS <= set(r) and r["rounds_per_block"] == 2
    assert rows[0]["acc_delta_vs_sync"] == 0.0
    data, test, d = common.federation_data("mnist", 4, 0, device="cpu",
                                           n_train_factor=0.05)
    spec = common.spec_of("mlp", d["shape"], d["n_classes"])
    cfg = ProxyFLConfig(n_clients=4, rounds=2, local_steps=2, batch_size=64,
                        seed=0, use_pallas=True, dp=DPConfig(enabled=False))
    res = run_federated("proxyfl", [spec] * 4, spec, data, test,
                        dataclasses.replace(cfg, staleness=0), seed=0,
                        eval_every=2, backend="async", device="cpu")
    row = res["history"][-1]
    assert rows[0]["proxy_acc_mean"] == float(np.mean(row["proxy_acc"]))
    assert rows[0]["private_acc_mean"] == float(np.mean(row["private_acc"]))


# ---------------------------------------------------------------------------
# the runner


def test_every_fig_file_is_registered():
    on_disk = {p.stem for p in BENCH_DIR.glob("fig*.py")}
    assert on_disk and on_disk <= set(runner.MODULES)
    for name, (mod, _, tier) in runner.MODULES.items():
        assert mod.__name__ == f"repro_torch.benchmarks.{name}"
        assert tier in runner.TIERS and callable(mod.run)
    assert {"fig_hier", "fig_kernels", "fig_async", "fig_blocks",
            "fig_ragged"} <= set(runner.MODULES)
    assert runner.names_for_tier("fast") == ["fig_kernels", "fig_hier",
                                             "fig_blocks"]
    with pytest.raises(ValueError):
        runner.names_for_tier("slow")


def test_runner_list_and_refusal(capsys):
    assert runner.main(["--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [l.split(":")[0] for l in lines] == list(runner.MODULES)
    for l in lines:
        assert "(no docstring)" not in l
    with pytest.raises(SystemExit, match="unknown benchmarks"):
        runner.main(["--only", "no_such_benchmark", "--device", "cpu"])


def test_runner_runs_a_driver_on_the_cpu(capsys):
    assert runner.main(["--only", "fig11_batchsize", "--device",
                        "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("[bench] on the CPU")
    assert "===== fig11_batchsize =====" in out and "rows in" in out

"""The port stands alone: importing all of ``repro_torch`` loads neither jax
nor the JAX package, and its entry points run on the GPU unless the caller
asks for the CPU."""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.benchmarks.common import bench_methods  # noqa: E402
from repro_torch.configs import ProxyFLConfig  # noqa: E402
from repro_torch.core.baselines import run_federated  # noqa: E402
from repro_torch.core.engine import (dml_engine,  # noqa: E402
                                     single_model_engine)
from repro_torch.core.protocol import ModelSpec  # noqa: E402
from repro_torch.nn.vision import get_vision_model  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


def test_import_loads_no_jax_and_no_reference_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        assert "repro_torch.benchmarks.fig3_accuracy" in names
        assert "repro_torch.checkpoint.federation" in names
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20   # every module was imported


def _tiny():
    vm = get_vision_model("mlp")
    spec = ModelSpec("mlp", lambda g: vm.init(g, (4, 4, 1), 3), vm.apply)
    data = [(torch.zeros(8, 4, 4, 1), torch.zeros(8, dtype=torch.int64))] * 2
    cfg = ProxyFLConfig(n_clients=2, rounds=1, local_steps=1, batch_size=4)
    return spec, data, cfg


def test_entry_points_need_cuda_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    spec, data, cfg = _tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dml_engine((spec,) * 2, spec, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        single_model_engine(spec, cfg, True)
    for method in ("proxyfl", "fedavg"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_federated(method, [spec] * 2, spec, data, data[0], cfg)
        res = run_federated(method, [spec] * 2, spec, data, data[0], cfg,
                            device="cpu")
        assert len(res["history"]) == 1 and len(res["clients"]) == 2
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_methods("mnist", ("fedavg",), n_clients=2, rounds=1,
                      seeds=(0,), n_train_factor=0.01)


@pytest.mark.parametrize("backend,item", [("shard_map", 12)])
def test_unported_backends_name_the_roadmap_item(backend, item):
    spec, _, cfg = _tiny()
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md Queue 1 item {item}"):
        dml_engine((spec,) * 2, spec, cfg, backend=backend, device="cpu")


@pytest.mark.parametrize("backend,n_shards,staleness",
                         [("hier", 2, 0), ("hier", 2, 1), ("hier", 1, 0)])
def test_hier_constructs_an_engine_on_the_cpu(backend, n_shards, staleness):
    """The backend the isolation test once refused now runs a round."""
    spec, data, cfg = _tiny()
    cfg = dataclasses.replace(cfg, n_shards=n_shards, staleness=staleness)
    eng = dml_engine((spec,) * 2, spec, cfg, backend=backend, device="cpu")
    assert eng.backend == "hier" and eng.n_shards == n_shards
    state, _ = eng.run_round(eng.init_states(0), data, 0, seed=0)
    assert len(eng.export_states(state)) == 2
    assert isinstance(state, dict) == (n_shards > 1 and staleness > 0)


@pytest.mark.parametrize("knobs", [dict(compress="topk"),
                                   dict(compress="int8"),
                                   dict(verify_commitments=True)])
@pytest.mark.parametrize("backend", ["auto", "loop", "async"])
def test_compression_and_commitments_construct_an_engine_on_the_cpu(
        knobs, backend):
    spec, data, cfg = _tiny()
    cfg = dataclasses.replace(cfg, **knobs)
    eng = dml_engine((spec,) * 2, spec, cfg, backend=backend, device="cpu")
    assert eng.verify_commitments == cfg.verify_commitments
    assert (eng.compress is None) == (cfg.compress == "none")
    state, _ = eng.run_round(eng.init_states(0), data, 0, seed=0)
    assert len(eng.export_states(state)) == 2

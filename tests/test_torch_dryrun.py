"""The dry-run for one device (``repro_torch.launch.dryrun``), its shapes on
the meta device, ``StepOptions.remat``, the roofline report and the
inspector, against the reference where it has a counterpart.

* ``model_flops`` equals the reference's for every arch × input shape;
  ``roofline`` keeps its formula against the H100's constants.
* ``train_state_shapes``, ``serve_state_shapes`` and ``input_specs`` build
  on ``meta`` the reference's ``jax.eval_shape`` trees, leaf for leaf (key
  path, shape, dtype), at every arch's full size.
* ``run_one`` runs every arch's smoke variant (train, prefill, decode; the
  long_500k rule) and its CLI writes the rows the roofline report reads.
* ``remat=True`` gives gradients bit-equal to ``remat=False`` on the CPU:
  one client's DP step of every arch, and two stacked-executor rounds.
"""
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402

from repro.configs import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import DPConfig as JaxDPConfig  # noqa: E402
from repro.configs.base import ProxyFLConfig as JaxProxyFLConfig  # noqa: E402
from repro.configs.registry import proxy_of as jax_proxy_of  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro_torch.benchmarks import roofline  # noqa: E402
from repro_torch.benchmarks import run as runner  # noqa: E402
from repro_torch.configs import (INPUT_SHAPES, DPConfig,  # noqa: E402
                                 InputShape, ProxyFLConfig, get_config,
                                 list_archs, proxy_of, smoke_variant)
from repro_torch.core.engine import FederationEngine  # noqa: E402
from repro_torch.launch import dryrun, inspect, steps, train  # noqa: E402
from repro_torch.launch.mesh import H100_SXM  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402


@pytest.fixture(scope="module")
def jax_dryrun():
    """The reference's dry-run module. Its first statements set XLA_FLAGS
    for 512 host devices; the flags are put back as they were at once, so
    no backend of this process or its children sees them."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as module
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return module


# ---------------------------------------------------------------------------
# model_flops, roofline, the constants


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_equal_the_reference(jax_dryrun, arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    want = jax_dryrun.model_flops(jcfg, JAX_SHAPES[shape],
                                  jax_proxy_of(jcfg))
    assert dryrun.model_flops(cfg, INPUT_SHAPES[shape], proxy_of(cfg)) \
        == want
    if INPUT_SHAPES[shape].kind != "train":
        assert dryrun.model_flops(cfg, INPUT_SHAPES[shape], None) == want


def test_roofline_is_the_reference_formula_on_the_h100(jax_dryrun):
    rl = dryrun.roofline(3e15, 6e12)
    assert rl["compute_s"] == 3e15 / 989e12
    assert rl["memory_s"] == 6e12 / 3.35e12
    assert rl["collective_s"] == 0.0 and rl["dominant"] == "compute"
    assert rl["collective_breakdown"] == {} and rl["collective_op_counts"] \
        == {}
    coll = {"total_wire_bytes": 0.0, "wire_bytes": {}, "op_counts": {}}
    hw = dict(H100_SXM, ici_bandwidth=1.0)
    assert jax_dryrun.roofline(3e15, 6e12, coll, hw) == rl
    assert dryrun.LONG_CONTEXT_OK == jax_dryrun.LONG_CONTEXT_OK
    assert H100_SXM == {"peak_flops_bf16": 989e12, "peak_flops_f32": 67e12,
                        "peak_flops_tf32x3": 495e12 / 3,
                        "hbm_bandwidth": 3.35e12, "hbm_bytes": 80 * 2 ** 30,
                        "l2_bytes": 50 * 2 ** 20}


def test_step_options_carry_the_reference_defaults():
    ref = jax_steps.StepOptions()
    opts = steps.StepOptions()
    for f in ("remat", "accum", "dp_chunk", "moment_dtype", "kv_chunk",
              "mamba_chunk"):
        assert getattr(opts, f) == getattr(ref, f), f
    assert dryrun.DRYRUN_OPTS == steps.StepOptions(dp_chunk=16)


# ---------------------------------------------------------------------------
# shapes on the meta device


def _path_key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def jax_leaves(tree):
    return sorted((tuple(_path_key(k) for k in path), tuple(x.shape),
                   str(x.dtype))
                  for path, x in jax.tree_util.tree_flatten_with_path(tree)[0])


def port_leaves(tree, path=()):
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = [leaf for k in tree for leaf in port_leaves(tree[k],
                                                          path + (k,))]
    elif hasattr(tree, "_fields"):
        out = [leaf for f in tree._fields
               for leaf in port_leaves(getattr(tree, f), path + (f,))]
    elif isinstance(tree, (tuple, list)):
        out = [leaf for i, t in enumerate(tree)
               for leaf in port_leaves(t, path + (i,))]
    else:
        assert tree.device.type == "meta", path
        out = [(path, tuple(tree.shape), str(tree.dtype).split(".")[-1])]
    return sorted(out)


@pytest.mark.parametrize("arch", list_archs())
def test_shape_trees_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    fl = ProxyFLConfig(dp=DPConfig(enabled=True))
    jfl = JaxProxyFLConfig(dp=JaxDPConfig(enabled=True))
    want = jax_steps.train_state_shapes(jcfg, jax_proxy_of(jcfg), jfl,
                                        jax_steps.StepOptions())
    got = steps.train_state_shapes(cfg, proxy_of(cfg), fl)
    assert port_leaves(got) == jax_leaves(want)
    for name, shape in INPUT_SHAPES.items():
        jshape = JAX_SHAPES[name]
        assert port_leaves(steps.serve_state_shapes(cfg, shape)) \
            == jax_leaves(jax_steps.serve_state_shapes(jcfg, jshape)), name
        for n in (0, 3):
            assert port_leaves(steps.input_specs(cfg, shape, n_clients=n)) \
                == jax_leaves(jax_steps.input_specs(jcfg, jshape,
                                                    n_clients=n)), (name, n)


def test_meta_is_admitted_only_where_shapes_are_built():
    from repro_torch import resolve_device
    from repro_torch.nn.model import init_cache

    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert resolve_device("meta", shapes_only=True).type == "meta"
    cache = init_cache(smoke_variant(get_config("qwen2-7b")), 2, 8,
                       device="meta")
    assert all(t.device.type == "meta" for t in tree_leaves(cache))


# ---------------------------------------------------------------------------
# run_one, the CLI, the report

SMALL = {"train": InputShape("small_train", 16, 2, "train"),
         "prefill": InputShape("small_prefill", 16, 2, "prefill"),
         "decode": InputShape("small_decode", 16, 2, "decode")}
SMALL_OPTS = dataclasses.replace(dryrun.DRYRUN_OPTS, accum=2, dp_chunk=2,
                                 kv_chunk=8, mamba_chunk=4)


@pytest.mark.parametrize("arch", list_archs())
def test_run_one_on_the_smoke_variant(arch):
    for program, shape in SMALL.items():
        r = dryrun.run_one(arch, shape, opts=SMALL_OPTS, smoke=True,
                           verbose=False)
        assert r["status"] == "ok" and r["program"] == program
        assert r["chips"] == 1 and r["mesh"] == "one"
        assert 0 < r["matmul_flops_global"] < r["flops_global"]
        assert r["bytes_global"] > 0 and r["useful_flops_ratio"] > 0
        ma = r["memory_analysis"]
        assert ma["argument_size_in_bytes"] == r["argument_bytes_per_device"]
        assert ma["temp_size_in_bytes"] > 0
        assert (ma["alias_size_in_bytes"] > 0) == (program == "train")
        rl = r["roofline"]
        assert rl["compute_s"] == r["flops_global"] / 989e12
        assert "xla_cost_analysis_raw" not in r
    skipped = dryrun.run_one(arch, "long_500k", smoke=True, verbose=False)
    assert (skipped["status"] == "skipped") \
        == (arch not in dryrun.LONG_CONTEXT_OK)


def test_argument_bytes_are_the_state_and_the_batch():
    cfg = smoke_variant(get_config("qwen2-7b"))
    shape = SMALL["prefill"]
    call, state, arg_bytes, _ = dryrun.step_call(cfg, shape, "prefill",
                                                 device="cpu")
    batch = steps.input_specs(cfg, shape)
    want = sum(t.numel() * t.element_size()
               for t in tree_leaves(state) + tree_leaves(batch))
    assert arg_bytes == want
    new, logits = call()
    assert logits.shape == (2, cfg.vocab_size)
    assert torch.isfinite(logits).all()


def test_cli_rows_render_in_the_report(tmp_path, capsys, monkeypatch):
    out = tmp_path / "rows"
    assert dryrun.main(["--arch", "falcon-mamba-7b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "qwen2-7b", "--shape", "long_500k",
                        "--out", str(out), "--no-remat", "--tag", "t"]) == 0
    names = sorted(os.listdir(out))
    assert names == ["falcon-mamba-7b__long_500k__one__decode.json",
                     "qwen2-7b__long_500k__one__decode__t.json"]
    rows = roofline.run(results_dir=str(out))
    assert [r["status"] for r in rows] == ["ok", "skipped"]
    ok = rows[0]
    raw = json.loads((out / names[0]).read_text())
    assert ok["compute_ms"] == round(raw["roofline"]["compute_s"] * 1e3, 2)
    assert ok["fits_80g"] is True   # one sequence's state and cache
    table = roofline.markdown_table(rows)
    lines = table.splitlines()
    assert lines[0].startswith("| arch | shape | program | FLOPs |")
    assert lines[2].startswith("| falcon-mamba-7b | long_500k | decode |")
    assert "Skipped (the long_500k rule): qwen2-7b×long_500k" in table
    monkeypatch.setattr(roofline, "RESULTS_DIR", str(out))
    capsys.readouterr()
    assert runner.main(["--only", "roofline"]) == 0
    printed = capsys.readouterr().out
    assert "===== roofline =====" in printed and "2 rows in" in printed


def test_runner_lists_the_roofline(capsys):
    assert "roofline" in runner.MODULES
    assert runner.main(["--list"]) == 0
    assert any(line.startswith("roofline: [§Roofline]")
               for line in capsys.readouterr().out.splitlines())


def test_largest_tensors_on_meta():
    cfg = smoke_variant(get_config("qwen2-7b"))
    call = dryrun.step_call(cfg, SMALL["prefill"], "prefill")[0]
    rows = inspect.largest_tensors(call, top=50)
    assert [r["bytes"] for r in rows] == sorted(
        (r["bytes"] for r in rows), reverse=True)
    for r in rows:
        itemsize = torch.empty((), dtype=getattr(
            torch, r["dtype"].split(".")[-1])).element_size()
        assert r["bytes"] == itemsize * int(torch.tensor(r["shape"]).prod())
    # the logits of every position, [B, S, V] in bf16, among them
    assert any(r["shape"] == [2, 16, cfg.vocab_size] for r in rows)


def test_kernel_times_sum_device_time_by_kernel():
    from types import SimpleNamespace as E
    events = [E(name="(anonymous namespace)::flash_fwd_sm90<128>(int)",
                self_device_time_total=5.0),
              E(name="rmsnorm_rows<float>", self_device_time_total=1.0),
              E(name="flash_fwd_sm90<64>()", self_device_time_total=2.5)]
    assert inspect.kernel_times(events) == {"flash_fwd_sm90": (2, 7.5),
                                            "rmsnorm_rows": (1, 1.0)}


# ---------------------------------------------------------------------------
# remat: bit-equal gradients


def _batch(cfg, gen, B=4, S=16):
    shape = (B, S, cfg.n_codebooks) if cfg.modality == "audio" else (B, S)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, shape,
                                     generator=gen)}
    if cfg.modality == "vlm":
        batch["img"] = torch.randn(B, cfg.n_image_tokens, cfg.frontend_dim,
                                   generator=gen).to(getattr(torch,
                                                             cfg.dtype))
    return batch


@pytest.mark.parametrize("arch", list_archs())
def test_remat_gradients_are_bit_equal(arch):
    """One client's DML step with DP on: KV chunks of 8 (the chunks
    rematerialized inside the rematerialized repeats), scan chunks of 4."""
    cfg = smoke_variant(get_config(arch))
    proxy = proxy_of(cfg, n_layers=2, d_model=64)
    fl = ProxyFLConfig(dp=DPConfig(enabled=True))
    gen = torch.Generator().manual_seed(0)
    state = steps.init_train_state(gen, cfg, proxy, fl)
    batch = _batch(cfg, gen)
    noise = torch.randn(sum(t.numel() for t in
                            tree_leaves(state["proxy"]["params"])),
                        generator=gen)
    out = {}
    for remat in (False, True):
        opts = steps.StepOptions(remat=remat, accum=2, dp_chunk=2,
                                 kv_chunk=8, mamba_chunk=4)
        out[remat] = steps.make_train_step(cfg, proxy, fl, opts)(
            state, batch, noise=noise)
    for a, b in zip(tree_leaves(out[False]), tree_leaves(out[True])):
        assert torch.equal(a, b)


def test_remat_stacked_rounds_are_bit_equal():
    """Two rounds of K = 3 clients on the stacked executor (the step
    vmapped over the cohort), with and without remat."""
    args = train.parse_args(["--arch", "qwen1.5-4b", "--smoke", "--clients",
                             "3", "--rounds", "2", "--steps-per-round", "1",
                             "--batch", "2", "--seq", "16", "--device",
                             "cpu"])
    run = train.setup(args)
    finals = {}
    for remat in (False, True):
        opts = steps.StepOptions(remat=remat, accum=1, dp_chunk=2,
                                 kv_chunk=8)
        eng = FederationEngine(
            run.fl, n_clients=3,
            step_fns=steps.make_train_step(run.cfg, run.proxy, run.fl, opts),
            init_fns=lambda g: steps.init_train_state(g, run.cfg, run.proxy,
                                                      run.fl, opts),
            sample_fn=train.lm_sampler(2), backend="vmap", mix="pushsum",
            device="cpu", stackable=True, noisy_steps=True)
        assert eng.stacked
        state = eng.init_states(args.seed)
        finals[remat] = eng.run_rounds(state, run.data, 0, 2, args.seed)[0]
    for a, b in zip(tree_leaves(finals[False]), tree_leaves(finals[True])):
        assert torch.equal(a, b)

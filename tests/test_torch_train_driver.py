"""The port's LLM ProxyFL training driver and engine against the JAX
package's: a port-only train step of every registry name's smoke variant
(``tests/test_models.py``'s ``test_smoke_train_step``); 2 clients × 1 round
× 2 local steps of the engine on the reference's batch and noise draws from
the same states, at the conformance ``close`` grade (atol 1e-5, rtol 1e-4);
``python -m repro_torch.launch.train`` on the CPU with the reference
accountant's epsilon, its other modalities and backends (hier at two
shards bit-equal to vmap); and the reference's refusals, word for word."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import DPConfig as JaxDPConfig  # noqa: E402
from repro.configs.base import ProxyFLConfig as JaxProxyFLConfig  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core.accountant import PrivacyAccountant as JaxAccountant  # noqa: E402
from repro.core.dp import _flat_gaussian_like  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro_torch.configs import (DPConfig, ProxyFLConfig,  # noqa: E402
                                 get_config, list_archs, proxy_of,
                                 smoke_variant)
from repro_torch.convert import state_from_numpy  # noqa: E402
from repro_torch.core.accountant import PrivacyAccountant  # noqa: E402
from repro_torch.core.engine import FederationEngine  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import (StepOptions,  # noqa: E402
                                      init_train_state, make_train_step)
from repro_torch.nn.model import init_model  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402
from test_torch_train_step import (CLOSE, XLA_OPTIONS,  # noqa: E402
                                   jax_cfgs, leaves, port_cfgs,
                                   reference_state, to_numpy)


# ---------------------------------------------------------------------------
# one port step of every registry name


@pytest.mark.parametrize("arch", list_archs())
def test_smoke_train_step(arch):
    cfg = smoke_variant(get_config(arch))
    proxy = smoke_variant(proxy_of(cfg))
    fl = ProxyFLConfig(dp=DPConfig(enabled=True), batch_size=2)
    opts = StepOptions(accum=1, dp_chunk=2)
    gen = torch.Generator().manual_seed(0)
    state = init_train_state(gen, cfg, proxy, fl, opts)
    shape = (2, 16, cfg.n_codebooks) if cfg.modality == "audio" else (2, 16)
    batch = {k: torch.randint(0, cfg.vocab_size, shape, generator=gen)
             for k in ("tokens", "labels")}
    if cfg.modality == "vlm":
        batch["img"] = torch.randn(
            (2, cfg.n_image_tokens, cfg.frontend_dim), generator=gen).to(
                getattr(torch, cfg.dtype))
    new, metrics = make_train_step(cfg, proxy, fl, opts)(state, batch, gen)
    assert all(torch.isfinite(metrics[k]) for k in ("private_loss",
                                                    "proxy_loss"))
    # params moved (embed values ~0.02 resolve a 1e-3 step in bf16; norm
    # gains at 1.0 do not, which the f32 master copy is for)
    before = state["private"]["params"]["embed"]["e"]
    assert not torch.allclose(before, new["private"]["params"]["embed"]["e"])
    opt = new["private"]["opt"]
    assert int(opt.t) == 1 and int(new["t"]) == 1
    assert (opt.p32 is None) == (cfg.dtype == "float32")
    if opt.p32 is not None:
        g0 = state["private"]["opt"].p32["norm_f"]["g"]
        assert not torch.allclose(g0, opt.p32["norm_f"]["g"])


# ---------------------------------------------------------------------------
# the engine on the reference's draws


ARCH, K, B, S, N_SEQ, STEPS = "qwen1.5-4b", 2, 4, 8, 12, 2


def _jax_sample(toks, kb, n_valid=None):
    """``src/repro/launch/train.py``'s sampler."""
    hi = toks.shape[0] if n_valid is None else n_valid
    idx = jax.random.randint(kb, (B,), 0, hi)
    return {"tokens": toks[idx, :-1], "labels": toks[idx, 1:]}


def test_engine_round_on_reference_draws():
    """2 clients, 1 round of 2 local steps and the PushSum exchange, from
    the same (warm) states, on the reference's batch indices and DP noise:
    states and losses at ``close``."""
    cfg, proxy = jax_cfgs(ARCH, "float32")
    knobs = dict(n_clients=K, rounds=1, local_steps=STEPS, batch_size=B)
    jfl = JaxProxyFLConfig(dp=JaxDPConfig(enabled=True), **knobs)
    opts = dict(accum=1, dp_chunk=B)
    states = [reference_state(ARCH, "float32", seed=k) for k in range(K)]
    rng = np.random.default_rng(5)
    data = [rng.integers(0, 512, (N_SEQ, S + 1)).astype(np.int32)
            for _ in range(K)]
    ref = jax_engine.FederationEngine(
        jfl, n_clients=K, step_fns=jax_steps.make_train_step(
            cfg, proxy, jfl, jax_steps.StepOptions(remat=False, **opts)),
        init_fns=None, sample_fn=_jax_sample, backend="loop", mix="pushsum")
    one = ref._one_step(0)
    ref._loop_steps[id(ref.step_fns[0])] = jax.jit(one).lower(
        states[0], jnp.asarray(data[0]), jax.random.PRNGKey(0)).compile(
            XLA_OPTIONS)
    base = jax.random.PRNGKey(3)
    want, wm = ref.run_rounds(states, [jnp.asarray(d) for d in data], 0, 1,
                              base)
    theta = states[0]["proxy"]["params"]

    def draws(k, t, s):
        ck = jax.random.fold_in(jax_engine.round_key(base, t), k)
        for _ in range(s + 1):
            ck, kb, kn = jax.random.split(ck, 3)
        return (np.asarray(jax.random.randint(kb, (B,), 0, N_SEQ)),
                np.array(_flat_gaussian_like(theta, kn)))

    tcfg, tproxy = port_cfgs(ARCH, "float32")
    fl = ProxyFLConfig(dp=DPConfig(enabled=True), use_pallas=True, **knobs)
    eng = FederationEngine(
        fl, n_clients=K, step_fns=make_train_step(tcfg, tproxy, fl,
                                                  StepOptions(**opts)),
        init_fns=None, sample_fn=train.lm_sampler(B), backend="loop",
        device="cpu", draws=draws)
    got, gm = eng.run_rounds([state_from_numpy(to_numpy(s)) for s in states],
                             [torch.as_tensor(d) for d in data], 0, 1, 0)
    for g, w in zip(got, want):
        ours, theirs = leaves(g), leaves(w)
        assert [n for n, _ in ours] == [n for n, _ in theirs]
        for (name, a), (_, b) in zip(ours, theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       err_msg=name, **CLOSE)
        assert int(g["t"]) == STEPS
    for k in ("private_loss", "proxy_loss"):
        np.testing.assert_allclose(gm[k], np.asarray(wm[k]), **CLOSE)


# ---------------------------------------------------------------------------
# the driver


SMOKE = ["--smoke", "--clients", "2", "--rounds", "1", "--steps-per-round",
         "1", "--batch", "2", "--seq", "32", "--device", "cpu"]


def test_driver_prints_the_reference_lines_and_epsilon(capsys):
    assert train.main(["--arch", "qwen1.5-4b"] + SMOKE) == 0
    out = capsys.readouterr().out
    assert "[train] private=qwen1.5-4b-smoke" in out
    line = next(l for l in out.splitlines() if l.startswith("[round 1/1]"))
    # q = B / n_k = 2 / 64, sigma 1, one step, delta 1e-5
    want = JaxAccountant(1.0, 2 / 64, 1e-5)
    want.step(1)
    got = PrivacyAccountant(1.0, 2 / 64, 1e-5)
    got.step(1)
    assert got.epsilon() == want.epsilon()
    assert f"eps={want.epsilon():.3f} " in line
    assert "active=2/2" in line and "client0_test_ppl=" in line


@pytest.mark.parametrize("arch,extra", [
    ("phi-3-vision-4.2b", ["--backend", "loop"]),
    ("musicgen-medium", ["--backend", "async", "--staleness", "1",
                         "--rounds", "2"]),
    ("jamba-1.5-large-398b", ["--rounds", "2", "--rounds-per-block", "2",
                              "--dropout-rate", "0.5", "--size-skew", "0.5",
                              "--use-pallas", "--no-dp"]),
])
def test_driver_runs_other_modalities_and_backends(arch, extra, capsys):
    """The reference's driver feeds every model 2-D token batches (its VLM
    and audio runs fail in the first step); the port's gives an audio
    client codebook tokens and a VLM client stub images."""
    rounds = 2 if "--rounds" in extra else 1
    assert train.main(["--arch", arch] + SMOKE + extra) == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("[round ")]
    assert len(lines) == rounds
    # the host evaluates at block edges only
    assert ["client0_test_ppl=" in l for l in lines] == (
        [False, True] if "--rounds-per-block" in extra else [True] * rounds)
    assert ("eps=nan" in lines[-1]) == ("--no-dp" in extra)


@pytest.mark.parametrize("flags,message", [
    (["--n-shards", "2"], "--n-shards > 1 requires --backend hier "
                          "(the flat backends have no shard level)"),
    (["--backend", "vmap", "--staleness", "1"],
     "--staleness requires --backend async or hier (the synchronous "
     "backends deliver every round)")])
def test_driver_refuses_what_the_reference_refuses(flags, message):
    """The reference driver's own refusals, word for word
    (``src/repro/launch/train.py``)."""
    with pytest.raises(SystemExit) as e:
        train.main(["--arch", "qwen1.5-4b"] + SMOKE + flags)
    assert str(e.value) == message


@pytest.mark.parametrize("staleness", [0, 2])
def test_driver_hier_two_shards(staleness, capsys):
    """``--backend hier --n-shards 2`` on the CPU: at τ = 0 every leaf and
    w of the final state equals the ``--backend vmap`` run's bit for bit;
    at τ = 2 the cross-shard buffer is in the state and the run finishes
    with finite losses."""
    argv = ["--arch", "qwen1.5-4b"] + SMOKE + ["--clients", "4",
                                               "--rounds", "2",
                                               "--use-pallas"]
    hier = ["--backend", "hier", "--n-shards", "2",
            "--staleness", str(staleness)]
    _, state = train.train(train.parse_args(argv + hier))
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("[round ")]
    assert len(lines) == 2 and "nan" not in lines[-1]
    if staleness:
        assert sorted(state) == ["clients", "hier_buffer", "hier_w"]
        assert float(state["hier_w"].sum()) > 0
        return
    _, flat = train.train(train.parse_args(argv + ["--backend", "vmap"]))
    assert isinstance(state, list) and len(state) == 4
    ours, theirs = tree_leaves(state), tree_leaves(flat)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)


def test_driver_needs_cuda_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    argv = ["--arch", "qwen1.5-4b"] + SMOKE[:-2]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(argv)


def test_preset_100m_is_the_reference_configuration():
    from repro.launch.train import preset_100m as jax_preset
    cfg = train.preset_100m()
    assert cfg.param_counts() == jax_preset().param_counts()
    proxy = proxy_of(cfg, n_layers=4, d_model=256)
    assert proxy.param_counts()["total"] == 6_291_456
    assert cfg.param_counts()["total"] == 119_537_664
    assert train.tree_size_of(cfg) == "12L/d768"
    # the flat proxy the exchange mixes also holds the 9 RMSNorm gains of
    # 256, which the analytic count leaves out: D = 6,293,760
    assert sum(x.numel() for x in tree_leaves(
        init_model(torch.Generator().manual_seed(0), proxy))) \
        == 6_291_456 + 9 * 256

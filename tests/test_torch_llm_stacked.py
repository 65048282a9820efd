"""The LLM train engine on the stacked executor, on the CPU: the client
routes of the peers' kernels and the stacked LLM round.

* The ``torch.func.vmap`` rules of ``rmsnorm`` (one gain: the rows folded;
  a gain per client: the client route), of attention (the clients folded
  into the batch) and of ``mamba_scan`` (the client route, each client its
  own A), and the client-route plain versions, equal K calls of the flat
  plain version; the vmapped rules also hold against ``jax.vmap`` of the
  JAX package's Pallas kernels in interpret mode (the reference's
  tolerances: f32 2e-5, bf16 2e-2, the scan 2e-4).
* The train driver's ``vmap``, ``async`` and ``hier`` backends build the
  stacked engine, ``loop`` does not; a stacked batched step runs each
  peer kernel once for the cohort, on its client route.
* One round of ``qwen1.5-4b``'s smoke variant in f32 on the port's stacked
  engine against the JAX package's ``backend="vmap"`` engine over
  ``repro.launch.steps.make_train_step``, from the reference's states and
  on its draws: every leaf and loss at the conformance ``close`` grade,
  epsilon exact.
* A ``--size-skew`` cohort (padded, never drawn past a client's own
  corpus) stacked against the loop; async τ = 2 stacked against the async
  loop; a run killed at a block edge and resumed equal to the straight
  run bit for bit. (Hier at two shards and τ = 0 equal to vmap bit for
  bit, both stacked: ``tests/test_torch_train_driver.py``.)

The eleven registry names against the loop are in
``tests/test_torch_llm_stacked_archs.py``.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.func import vmap  # noqa: E402

import repro.kernels as jk  # noqa: E402
from repro.configs.base import DPConfig as JaxDPConfig  # noqa: E402
from repro.configs.base import ProxyFLConfig as JaxProxyFLConfig  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core.accountant import PrivacyAccountant as JaxAccountant  # noqa: E402
from repro.core.dp import _flat_gaussian_like  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import (DPConfig, ProxyFLConfig,  # noqa: E402
                                 get_config, proxy_of, smoke_variant)
from repro_torch.convert import state_from_numpy  # noqa: E402
from repro_torch.core.accountant import PrivacyAccountant  # noqa: E402
from repro_torch.core.engine import FederationEngine  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import StepOptions, make_train_step  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402
from test_torch_train_step import (CLOSE, jax_cfgs, leaves,  # noqa: E402
                                   port_cfgs, reference_state, to_numpy)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SCAN_TOL = 2e-4
K = 3


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen).to(dtype)


def _close(got, want, tol):
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the client routes


@pytest.mark.parametrize("shared_gain", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead,d", [((5,), 16), ((2, 7), 255)])
def test_rmsnorm_vmap_rule_is_k_flat_calls(lead, d, dtype, shared_gain):
    gen = torch.Generator().manual_seed(0)
    x = _randn(gen, K, *lead, d, dtype=dtype)
    g = _randn(gen, *((d,) if shared_gain else (K, d)), dtype=dtype)
    gk = [g if shared_gain else g[k] for k in range(K)]
    want = torch.stack([kernels.rmsnorm(x[k], gk[k]) for k in range(K)])
    fn = (lambda a: kernels.rmsnorm(a, g)) if shared_gain \
        else kernels.rmsnorm
    got = vmap(fn)(x) if shared_gain else vmap(fn)(x, g)
    assert torch.equal(got, want)
    if not shared_gain:
        rows = x.reshape(K, -1, d)
        flat = torch.stack([ref.rmsnorm_ref(rows[k], g[k])
                            for k in range(K)])
        assert torch.equal(ref.rmsnorm_clients_ref(rows, g), flat)
        assert torch.equal(kernels.rmsnorm_clients(rows, g), flat)


def test_rmsnorm_vmap_rule_takes_strided_gains():
    """A layer's gains indexed out of a stacked [R, d] leaf per client:
    rows at stride R·d, no copy needed."""
    gen = torch.Generator().manual_seed(1)
    x, stack = _randn(gen, K, 4, 32), _randn(gen, K, 3, 32)
    got = vmap(lambda a, s: kernels.rmsnorm(a, s[1]))(x, stack)
    want = torch.stack([ref.rmsnorm_ref(x[k], stack[k, 1])
                        for k in range(K)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,window", [(1, None), (2, None), (2, 3)])
def test_attention_vmap_rule_folds_into_the_batch(dtype, group, window):
    gen = torch.Generator().manual_seed(2)
    B, S, H, D = 2, 9, 4, 8
    q = _randn(gen, K, B, S, H, D, dtype=dtype)
    k, v = (_randn(gen, K, B, S, H // group, D, dtype=dtype)
            for _ in range(2))
    got = vmap(lambda a, b, c: kernels.gqa_flash_attention(
        a, b, c, window=window))(q, k, v)
    want = torch.stack([ref.gqa_flash_attention_ref(
        q[i], k[i], v[i], window=window) for i in range(K)])
    _close(got, want, TOL[dtype])
    # the [B, H, S, D] layout, the same fold
    qt, kt, vt = (t.transpose(2, 3) for t in (q, q, q))
    got = vmap(lambda a, b, c: kernels.flash_attention(
        a, b, c, window=window))(qt, kt, vt)
    want = torch.stack([ref.flash_attention_ref(
        qt[i], kt[i], vt[i], window=window) for i in range(K)])
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("shared_a", [False, True])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_vmap_rule_is_k_flat_calls(dtype, state, shared_a):
    gen = torch.Generator().manual_seed(3)
    B, S, di, ds = 2, 11, 6, 5
    dt = torch.nn.functional.softplus(_randn(gen, K, B, S, di))
    x = _randn(gen, K, B, S, di, dtype=dtype)
    Bm, Cm = _randn(gen, K, B, S, ds), _randn(gen, K, B, S, ds)
    A = -torch.exp(_randn(gen, *((di, ds) if shared_a else (K, di, ds))))
    h0 = _randn(gen, K, B, di, ds) if state else None
    kw = dict(return_state=True) if state else {}
    ak = [A if shared_a else A[k] for k in range(K)]
    want = [kernels.mamba_scan(dt[k], x[k], Bm[k], Cm[k], ak[k],
                               h0=None if h0 is None else h0[k], **kw)
            for k in range(K)]
    if state:
        got = vmap(lambda a, b, c, d, e, h: kernels.mamba_scan(
            a, b, c, d, e, h0=h, return_state=True),
            in_dims=(0, 0, 0, 0, None if shared_a else 0, 0))(
                dt, x, Bm, Cm, A, h0)
        for g, w in zip(got, zip(*want)):
            _close(g, torch.stack(w), SCAN_TOL)
    else:
        got = vmap(kernels.mamba_scan,
                   in_dims=(0, 0, 0, 0, None if shared_a else 0))(
            dt, x, Bm, Cm, A)
        _close(got, torch.stack(want), SCAN_TOL)
    if not shared_a:
        flat = [ref.mamba_scan_ref(dt[k], x[k], Bm[k], Cm[k], A[k],
                                   None if h0 is None else h0[k], state)
                for k in range(K)]
        out = ref.mamba_scan_clients_ref(dt, x, Bm, Cm, A, h0, state)
        if state:
            for g, w in zip(out, zip(*flat)):
                assert torch.equal(g, torch.stack(w))
        else:
            assert torch.equal(out, torch.stack(flat))


def test_vmapped_rules_hold_against_the_vmapped_pallas_kernels():
    """``jax.vmap`` of the JAX package's Pallas kernels (interpret mode,
    as its own tests run them on the CPU) against the port's vmap rules on
    the same numpy draws: rmsnorm with a gain per client, GQA attention,
    the scan with an A per client."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((K, 8, 32), np.float32)
    g = rng.standard_normal((K, 32), np.float32)
    want = jax.vmap(lambda a, b: jax_rmsnorm(a, b, interpret=True))(x, g)
    got = vmap(kernels.rmsnorm)(torch.as_tensor(x), torch.as_tensor(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    q = rng.standard_normal((K, 1, 16, 4, 8), np.float32)
    k, v = (rng.standard_normal((K, 1, 16, 2, 8), np.float32)
            for _ in range(2))
    want = jax.vmap(lambda a, b, c: jops.gqa_flash_attention(
        a, b, c, causal=True, interpret=True))(q, k, v)
    got = vmap(kernels.gqa_flash_attention)(
        *(torch.as_tensor(t) for t in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    B, S, di, ds = 1, 16, 8, 4
    dt = np.log1p(np.exp(rng.standard_normal((K, B, S, di)))).astype(
        np.float32)
    xs = rng.standard_normal((K, B, S, di), np.float32)
    Bm, Cm = (rng.standard_normal((K, B, S, ds), np.float32)
              for _ in range(2))
    A = -np.exp(rng.standard_normal((K, di, ds))).astype(np.float32)
    want = jax.vmap(lambda *a: jk.mamba_scan(*a, interpret=True))(
        dt, xs, Bm, Cm, A)
    got = vmap(kernels.mamba_scan)(
        *(torch.as_tensor(t) for t in (dt, xs, Bm, Cm, A)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=SCAN_TOL, atol=SCAN_TOL)


def test_client_routes_refuse_bad_shapes():
    gen = torch.Generator().manual_seed(5)
    with pytest.raises(ValueError, match="rmsnorm_clients"):
        kernels.rmsnorm_clients(_randn(gen, K, 4, 8), _randn(gen, K, 7))
    with pytest.raises(ValueError, match="rmsnorm_clients"):
        kernels.rmsnorm_clients(_randn(gen, 4, 8), _randn(gen, 8))
    dt, x = _randn(gen, K, 1, 4, 6), _randn(gen, K, 1, 4, 6)
    Bm = _randn(gen, K, 1, 4, 2)
    with pytest.raises(ValueError, match="mamba_scan_clients"):
        kernels.mamba_scan_clients(dt, x, Bm, Bm, _randn(gen, 6, 2))


@pytest.mark.parametrize("name", ["rmsnorm", "attention", "scan"])
def test_only_transformed_calls_go_through_the_custom_op(name, monkeypatch):
    """A call outside every ``torch.func`` transform (serving, evaluation)
    runs the op's body without the dispatcher; a call under
    ``torch.func.vmap`` goes through the custom op and its vmap rule."""
    import sys
    gen = torch.Generator().manual_seed(7)
    mod, op = {"rmsnorm": ("rmsnorm", "_rmsnorm_op"),
               "attention": ("flash_attention", "_attention_op"),
               "scan": ("mamba_scan", "_mamba_scan_op")}[name]
    mod = sys.modules[f"repro_torch.kernels.{mod}"]
    calls = []
    raw = getattr(mod, op)

    def counting(*a):
        calls.append(1)
        return raw(*a)
    monkeypatch.setattr(mod, op, counting)
    if name == "rmsnorm":
        args, fn = (_randn(gen, K, 4, 8), _randn(gen, K, 8)), kernels.rmsnorm
    elif name == "attention":
        args = tuple(_randn(gen, K, 1, 4, 2, 8) for _ in range(3))
        fn = kernels.gqa_flash_attention
    else:
        args = (_randn(gen, K, 1, 4, 6).abs(), _randn(gen, K, 1, 4, 6),
                _randn(gen, K, 1, 4, 2), _randn(gen, K, 1, 4, 2),
                -_randn(gen, K, 6, 2).abs())
        fn = kernels.mamba_scan
    flat = torch.stack([fn(*(a[k] for a in args)) for k in range(K)])
    assert not calls
    got = vmap(fn)(*args)
    assert calls == [1]
    assert torch.equal(got, flat)


def test_vmap_rules_count_no_launch_on_the_cpu():
    """Only a kernel launch counts: the plain versions on the CPU, under
    the vmap rules too, leave every counter at 0."""
    gen = torch.Generator().manual_seed(6)
    kernels.reset_launch_counts()
    vmap(kernels.rmsnorm)(_randn(gen, K, 4, 8), _randn(gen, K, 8))
    vmap(kernels.gqa_flash_attention)(*(_randn(gen, K, 1, 4, 2, 8)
                                        for _ in range(3)))
    assert not any(kernels.count_state().values())


# ---------------------------------------------------------------------------
# the driver's engine


SMOKE = ["--arch", "qwen1.5-4b", "--smoke", "--clients", "2", "--rounds",
         "1", "--steps-per-round", "2", "--batch", "2", "--seq", "16",
         "--device", "cpu"]


@pytest.mark.parametrize("backend,extra,stacked", [
    ("vmap", [], True), ("loop", [], False),
    ("async", ["--staleness", "2"], True),
    ("hier", ["--n-shards", "2", "--clients", "4"], True)])
def test_driver_backends_build_the_stacked_engine(backend, extra, stacked):
    args = train.parse_args(SMOKE + ["--backend", backend] + extra)
    run = train.setup(args)
    assert run.engine.stacked == stacked
    assert run.engine.noisy_steps and run.engine.sample_fn.batch_size == 2
    assert not train.make_engine(
        run.cfg, run.proxy, run.fl, train.parse_args(
            SMOKE + ["--backend", backend, "--no-dp"] + extra),
        run.n_seqs, "cpu").noisy_steps


def _counting(monkeypatch):
    """Count the plain versions each route runs on the CPU, by route."""
    calls = {}
    mods = {name: sys.modules[f"repro_torch.kernels.{name}"]
            for name in ("rmsnorm", "flash_attention", "mamba_scan")}
    for mod, fn in (("rmsnorm", "rmsnorm_ref"),
                    ("rmsnorm", "rmsnorm_clients_ref"),
                    ("flash_attention", "gqa_flash_attention_ref"),
                    ("flash_attention", "_attention"),
                    ("mamba_scan", "mamba_scan_ref"),
                    ("mamba_scan", "mamba_scan_clients_ref")):
        raw = getattr(mods[mod], fn)

        def wrapped(*a, raw=raw, key=fn, **kw):
            calls[key] = calls.get(key, 0) + 1
            return raw(*a, **kw)
        monkeypatch.setattr(mods[mod], fn, wrapped)
    return calls


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "jamba-1.5-large-398b"])
def test_a_batched_step_runs_each_peer_kernel_once_for_the_cohort(
        arch, monkeypatch):
    """One stacked round of 2 steps with the kernels on: every RMSNorm,
    attention and scan of the two peers' forwards runs once a batched
    step on its client route (rmsnorm's and the scan's client routes,
    attention's fold), and no flat call runs inside the round."""
    from repro_torch.nn.model import layer_plan
    argv = ["--arch", arch] + SMOKE[2:] + ["--use-pallas", "--clients", "3"]
    args = train.parse_args(argv)
    run = train.setup(args)
    calls = _counting(monkeypatch)
    run.engine.run_rounds(run.state, run.data, 0, 1, 0)
    want = {}
    for cfg in (run.cfg, run.proxy):
        for spec, *_ in layer_plan(cfg):
            want["rmsnorm_clients_ref"] = want.get(
                "rmsnorm_clients_ref", 0) + 1 + (spec.ffn != "none") + (
                2 if spec.kind == "attn" and cfg.attn_impl == "mla" else 0)
            key = ("mamba_scan_clients_ref" if spec.kind == "mamba" else
                   "_attention" if cfg.attn_impl != "mla" else None)
            if key:
                want[key] = want.get(key, 0) + 1
        want["rmsnorm_clients_ref"] += 1    # the final norm
    # the fold's plain version runs inside the folded call: once each
    want["gqa_flash_attention_ref"] = want.get("_attention", 0)
    steps = args.steps_per_round
    assert calls == {key: n * steps for key, n in want.items() if n}, calls


# ---------------------------------------------------------------------------
# the stacked round against the JAX package's vmap engine


ARCH, B, S, N_SEQ, STEPS = "qwen1.5-4b", 4, 8, 12, 2


def _jax_sample(toks, kb, n_valid=None):
    """``src/repro/launch/train.py``'s sampler."""
    hi = toks.shape[0] if n_valid is None else n_valid
    idx = jax.random.randint(kb, (B,), 0, hi)
    return {"tokens": toks[idx, :-1], "labels": toks[idx, 1:]}


@pytest.fixture(scope="module")
def reference_round():
    """One round of 2 clients × 2 steps and the PushSum exchange on the
    JAX engine's ``vmap`` backend, from numpy-drawn states, with
    accountants; the reference's draws as the port's replay hook."""
    cfg, proxy = jax_cfgs(ARCH, "float32")
    knobs = dict(n_clients=2, rounds=1, local_steps=STEPS, batch_size=B)
    jfl = JaxProxyFLConfig(dp=JaxDPConfig(enabled=True), **knobs)
    states = [reference_state(ARCH, "float32", seed=k) for k in range(2)]
    rng = np.random.default_rng(5)
    data = [rng.integers(0, 512, (N_SEQ, S + 1)).astype(np.int32)
            for _ in range(2)]
    ref_eng = jax_engine.FederationEngine(
        jfl, n_clients=2, step_fns=jax_steps.make_train_step(
            cfg, proxy, jfl, jax_steps.StepOptions(
                remat=False, accum=1, dp_chunk=B)),
        init_fns=None, sample_fn=_jax_sample, backend="vmap", mix="pushsum")
    ref_eng.attach_accountants([JaxAccountant(1.0, B / N_SEQ, 1e-5)
                                for _ in range(2)])
    base = jax.random.PRNGKey(3)
    want, wm = ref_eng.run_rounds(jax_engine.stack_states(states),
                                  [jnp.asarray(d) for d in data], 0, 1, base)
    theta = states[0]["proxy"]["params"]

    def draws(k, t, s):
        ck = jax.random.fold_in(jax_engine.round_key(base, t), k)
        for _ in range(s + 1):
            ck, kb, kn = jax.random.split(ck, 3)
        return (np.asarray(jax.random.randint(kb, (B,), 0, N_SEQ)),
                np.array(_flat_gaussian_like(theta, kn)))

    return dict(knobs=knobs, states=[to_numpy(s) for s in states],
                data=data, want=ref_eng.export_states(want), wm=wm,
                draws=draws,
                eps=[a.epsilon() for a in ref_eng.accountants])


@pytest.mark.parametrize("use_pallas", [True, False])
def test_stacked_round_close_to_the_reference_vmap_engine(reference_round,
                                                          use_pallas):
    r = reference_round
    tcfg, tproxy = port_cfgs(ARCH, "float32")
    fl = ProxyFLConfig(dp=DPConfig(enabled=True), use_pallas=use_pallas,
                       **r["knobs"])
    eng = FederationEngine(
        fl, n_clients=2, step_fns=make_train_step(
            tcfg, tproxy, fl, StepOptions(accum=1, dp_chunk=B)),
        init_fns=None, sample_fn=train.lm_sampler(B), backend="vmap",
        device="cpu", draws=r["draws"], stackable=True, noisy_steps=True)
    assert eng.stacked
    eng.attach_accountants([PrivacyAccountant(1.0, B / N_SEQ, 1e-5)
                            for _ in range(2)])
    got, gm = eng.run_rounds([state_from_numpy(s) for s in r["states"]],
                             [torch.as_tensor(d) for d in r["data"]], 0, 1,
                             0)
    for g, w in zip(got, r["want"]):
        ours, theirs = leaves(g), leaves(w)
        assert [n for n, _ in ours] == [n for n, _ in theirs]
        for (name, a), (_, b) in zip(ours, theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       err_msg=name, **CLOSE)
        assert int(g["t"]) == STEPS
    for key in ("private_loss", "proxy_loss"):
        np.testing.assert_allclose(gm[key], np.asarray(r["wm"][key]),
                                   **CLOSE)
    assert [a.epsilon() for a in eng.accountants] == r["eps"]


# ---------------------------------------------------------------------------
# ragged, async, resume


def _f32_cfgs(monkeypatch):
    """The driver's smoke configurations in f32 (the conformance grade's
    dtype: the registry's bf16 rounds batched products otherwise)."""
    def cfgs(args):
        cfg = smoke_variant(get_config(args.arch)).with_(dtype="float32")
        return cfg, smoke_variant(proxy_of(cfg))
    monkeypatch.setattr(train, "build_cfgs", cfgs)


def _assert_close_states(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if x.is_floating_point():
            torch.testing.assert_close(x, y, **CLOSE)
        else:
            assert torch.equal(x, y)


def test_size_skew_cohort_stacked_against_the_loop(monkeypatch):
    """``--size-skew 0.5`` over 3 clients (corpora of 64, 32 and 16
    sequences, padded to 64 on the stacked executor, each client's draw
    below its own count): vmap within ``close`` of the loop, epsilon
    equal."""
    _f32_cfgs(monkeypatch)
    argv = SMOKE + ["--clients", "3", "--size-skew", "0.5", "--rounds", "2",
                    "--use-pallas"]
    out = {}
    for backend in ("vmap", "loop"):
        run, state = train.train(train.parse_args(argv + ["--backend",
                                                          backend]))
        out[backend] = (run, state)
    run = out["vmap"][0]
    assert run.engine.stacked and sorted(run.n_seqs) == [16, 32, 64]
    _assert_close_states(out["vmap"][1], out["loop"][1])
    assert [a.epsilon() for a in run.engine.accountants] == \
        [a.epsilon() for a in out["loop"][0].engine.accountants]


def test_async_stacked_against_the_async_loop(monkeypatch):
    """``--backend async --staleness 2``, 3 rounds: the stacked engine
    within ``close`` of the same engine run client by client (its loop),
    the in-flight buffer included."""
    _f32_cfgs(monkeypatch)
    args = train.parse_args(SMOKE + ["--backend", "async", "--staleness",
                                     "2", "--rounds", "3"])
    run = train.setup(args)
    states = {}
    for stacked in (True, False):
        eng = train.make_engine(run.cfg, run.proxy, run.fl, args,
                                run.n_seqs, "cpu")
        assert eng.stacked
        eng.stacked = stacked     # False: the loop on the same engine
        states[stacked], _ = eng.run_rounds(run.state, run.data, 0, 3, 0)
    assert sorted(states[True]) == ["clients", "stale_theta", "stale_w"]
    _assert_close_states(states[True], states[False])


def test_resume_at_a_block_edge_is_bit_equal(tmp_path):
    """4 rounds in blocks of 2 with a snapshot every 2, killed after round
    2 and resumed: every leaf equal to the straight run's and to the
    per-round run's."""
    argv = SMOKE + ["--rounds-per-block", "2", "--use-pallas"]
    _, straight = train.train(train.parse_args(argv + ["--rounds", "4"]))
    _, per_round = train.train(train.parse_args(
        argv + ["--rounds", "4", "--rounds-per-block", "1"]))
    d = str(tmp_path / "ck")
    ck = ["--checkpoint-dir", d, "--checkpoint-every", "2"]
    assert train.main(argv + ["--rounds", "2"] + ck) == 0
    run, resumed = train.train(train.parse_args(
        argv + ["--rounds", "4", "--resume"] + ck))
    assert run.engine.stacked
    for a, b, c in zip(tree_leaves(straight), tree_leaves(per_round),
                       tree_leaves(resumed), strict=True):
        assert torch.equal(a, b) and torch.equal(a, c)

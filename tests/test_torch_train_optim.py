"""The pieces under the port's LLM training step against the JAX package's:
Adam with its f32 master copy (``p32``) and bf16 moments, SGD,
``dp_gradient_chunked`` (the reference's noise injected; ``prepare_chunk``
once per chunk, outside the per-example transform) and
``non_dp_gradient(accum=2)``, at the conformance ``close`` grade (atol
1e-5, rtol 1e-4), bf16 params within one bf16 ulp; ``make_lm_data``;
``block_spans`` and the engine's epoch length on a bare token tensor;
``dp_adam_update``'s refusal of non-f32 params or moments; and the kernel
wrappers' refusal of an input that requires grad
(on the CPU through the same dispatch as on the card), with the serve and
federation paths, which pass no such input, still running.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.func import grad  # noqa: E402

from repro.configs.base import ProxyFLConfig as JaxProxyFLConfig  # noqa: E402
from repro.core import dp as jax_dp  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.optim.optimizers import SGD as JaxSGD  # noqa: E402
from repro.optim.optimizers import Adam as JaxAdam  # noqa: E402
from repro_torch import convert, kernels  # noqa: E402
from repro_torch.configs import (InputShape, ProxyFLConfig,  # noqa: E402
                                 get_config, smoke_variant)
from repro_torch.core import dp  # noqa: E402
from repro_torch.core.engine import (FederationEngine,  # noqa: E402
                                     block_spans)
from repro_torch.data.synthetic import make_lm_data  # noqa: E402
from repro_torch.launch.steps import (init_serve_state,  # noqa: E402
                                      make_prefill_step)
from repro_torch.nn.model import init_model  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402
from repro_torch.optim import SGD, Adam, AdamState  # noqa: E402

CLOSE = dict(atol=1e-5, rtol=1e-4)
DP = dict(clip_norm=0.5, noise_multiplier=1.0)


def _np(x):
    return np.asarray(x.detach().float()) if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _trees_close(ours, theirs, **tol):
    la, lb = tree_leaves(ours), jax.tree_util.tree_leaves(theirs)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        np.testing.assert_allclose(_np(a), _np(b), **(tol or CLOSE))


def _within_one_ulp(ours, theirs):
    """bf16 leaves at most one bf16 ulp of the larger magnitude apart."""
    for a, b in zip(tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        a, b = _np(a), _np(b)
        ulp = np.maximum(np.abs(a), np.abs(b)) * 2.0 ** -7 + 1e-30
        assert np.all(np.abs(a - b) <= ulp), float(np.max(np.abs(a - b)))


# ---------------------------------------------------------------------------
# optimizers


def _opt_case(dtype):
    """A mixed tree: a norm gain at 1.0 and weights in ``dtype``, a router
    kept in f32 (as ``init_model`` keeps MoE routers); three gradients."""
    rng = np.random.default_rng(0)
    jd = jnp.dtype(dtype)
    params = {"g": jnp.ones((6,), jd),
              "w": jnp.asarray(0.02 * rng.standard_normal((5, 4)), jd),
              "router": jnp.asarray(0.02 * rng.standard_normal((4, 3)),
                                    jnp.float32)}
    grads = [jax.tree_util.tree_map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape), p.dtype), params) for _ in range(3)]
    return params, grads


def _to_port(tree):
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("dtype,moments", [("float32", "float32"),
                                           ("bfloat16", "float32"),
                                           ("bfloat16", "bfloat16"),
                                           ("float32", "bfloat16")])
def test_adam_master_copy_and_moments_match_reference(dtype, moments):
    params, grads = _opt_case(dtype)
    kw = dict(lr=1e-3, weight_decay=1e-4, moment_dtype=moments)
    jopt, topt = JaxAdam(**kw), Adam(**kw)
    js, ts = jopt.init(params), topt.init(_to_port(params))
    assert (js.p32 is None) == (ts.p32 is None) == (dtype == "float32")
    jp, tp = params, _to_port(params)
    tp0 = tp
    for g in grads:
        jp, js = jopt.update(g, js, jp)
        tp, ts = topt.update(_to_port(g), ts, tp)
    assert int(ts.t) == int(js.t) == 3
    if dtype == "float32":
        _trees_close(tp, jp)
    else:
        _within_one_ulp(tp, jp)
        _trees_close(ts.p32, js.p32)
        # the params are the master copy rounded; a gain at 1.0 cannot
        # absorb a 1e-3 step in bf16 (resolution 4e-3 below 1.0) without it
        for p, p32 in zip(tree_leaves(tp), tree_leaves(ts.p32)):
            assert torch.equal(p, p32.to(p.dtype))
        assert not np.allclose(_np(ts.p32["g"]), 1.0)
        bare, bs = tp0, Adam(**kw, master_weights=False).init(tp0)
        for g in grads:
            bare, bs = Adam(**kw, master_weights=False).update(
                _to_port(g), bs, bare)
        assert bs.p32 is None and torch.equal(bare["g"], tp0["g"])
    for ours, theirs in ((ts.m, js.m), (ts.v, js.v)):
        assert {x.dtype for x in tree_leaves(ours)} == {
            getattr(torch, moments)}
        if moments == "float32":
            _trees_close(ours, theirs)
        else:
            _within_one_ulp(ours, theirs)


def test_adam_steps_from_the_master_copy_not_the_params():
    """With a master copy a step starts from ``p32`` and ignores the
    params' values, in both packages: params replaced between steps (as
    the PushSum exchange replaces a bf16 proxy's) leave the next step's
    result unchanged."""
    params, grads = _opt_case("bfloat16")
    other = jax.tree_util.tree_map(lambda p: p + jnp.asarray(0.5, p.dtype),
                                   params)
    jopt, topt = JaxAdam(lr=1e-3), Adam(lr=1e-3)
    js, ts = jopt.init(params), topt.init(_to_port(params))
    for opt, state, conv, flat in (
            (jopt, js, lambda t: t, jax.tree_util.tree_leaves),
            (topt, ts, _to_port, tree_leaves)):
        a = opt.update(conv(grads[0]), state, conv(params))
        b = opt.update(conv(grads[0]), state, conv(other))
        for x, y in zip(flat(a), flat(b)):
            np.testing.assert_array_equal(_np(x), _np(y))


def test_adam_state_with_master_copy_converts():
    params, _ = _opt_case("bfloat16")
    js = JaxAdam(lr=1e-3).init(params)
    state = convert.state_from_numpy(jax.tree_util.tree_map(np.asarray, {
        "private": {"params": params, "opt": js},
        "proxy": {"params": params, "opt": js},
        "w": jnp.ones(()), "t": jnp.asarray(3, jnp.int32)}))
    opt = state["private"]["opt"]
    assert isinstance(opt, AdamState) and int(state["t"]) == 3
    _trees_close(opt.p32, js.p32, atol=0, rtol=0)
    assert {x.dtype for x in tree_leaves(opt.p32)} == {torch.float32}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sgd_matches_reference(dtype):
    params, grads = _opt_case(dtype)
    jopt, topt = JaxSGD(lr=0.1, weight_decay=1e-4), SGD(lr=0.1,
                                                        weight_decay=1e-4)
    jp, tp = params, _to_port(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js = jopt.update(g, js, jp)
        tp, ts = topt.update(_to_port(g), ts, tp)
    (_trees_close if dtype == "float32" else _within_one_ulp)(tp, jp)


# ---------------------------------------------------------------------------
# DP and plain gradients over a batch tree


B, CHUNK = 6, 2


def _grad_case():
    rng = np.random.default_rng(1)
    params = {"w1": (0.5 * rng.standard_normal((5, 7))).astype(np.float32),
              "w2": (0.5 * rng.standard_normal((7, 3))).astype(np.float32)}
    batch = {"x": rng.standard_normal((B, 5)).astype(np.float32),
             "y": rng.standard_normal((B, 3)).astype(np.float32)}
    return params, batch


def _jax_loss(p, b):
    peer = 0.5 * jnp.tanh(b["x"][:, :3])
    out = jnp.tanh(b["x"] @ p["w1"]) @ p["w2"]
    return jnp.mean((out - b["y"]) ** 2) + jnp.mean((out - peer) ** 2)


def _port_loss(p, b):
    out = torch.tanh(b["x"] @ p["w1"]) @ p["w2"]
    return torch.mean((out - b["y"]) ** 2) + torch.mean((out - b["peer"]) ** 2)


def _counting_prepare(calls):
    def prepare(b):
        calls.append(torch.is_grad_enabled())
        return dict(b, peer=0.5 * torch.tanh(b["x"][:, :3]))
    return prepare


def test_dp_gradient_chunked_matches_reference():
    params, batch = _grad_case()
    key = jax.random.PRNGKey(7)
    want, wm = jax_dp.dp_gradient_chunked(
        _jax_loss, jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, batch), key, chunk=CHUNK, **DP)
    noise = torch.as_tensor(np.array(jax_dp._flat_gaussian_like(params,
                                                                key)))
    calls = []
    got, gm = dp.dp_gradient_chunked(
        _port_loss, _to_port(params), _to_port(batch), chunk=CHUNK,
        prepare_chunk=_counting_prepare(calls), noise=noise, **DP)
    # once per chunk, outside the per-example transform, without a grad
    assert calls == [False] * (B // CHUNK)
    _trees_close(got, want)
    for k in ("loss", "mean_grad_norm"):
        np.testing.assert_allclose(_np(gm[k]), _np(wm[k]), **CLOSE)


def test_dp_gradient_chunked_clips_every_example():
    """σ = 0 and a clip far below every example's norm: the mean of B unit
    vectors times C, whatever the chunking."""
    params, batch = _grad_case()
    outs = []
    for chunk in (1, 2, 3, 6):
        g, m = dp.dp_gradient_chunked(
            _port_loss, _to_port(params), _to_port(batch), chunk=chunk,
            prepare_chunk=_counting_prepare([]), clip_norm=1e-3,
            noise_multiplier=0.0, noise=torch.zeros(56))
        outs.append(torch.cat([x.reshape(-1) for x in tree_leaves(g)]))
        assert float(m["mean_grad_norm"]) > 1e-3
    for o in outs:
        torch.testing.assert_close(o, outs[0], **CLOSE)
    assert float(outs[0].norm()) <= 1e-3 * (1 + 1e-5)


def test_non_dp_gradient_accumulated_matches_reference():
    params, batch = _grad_case()
    want, wm = jax_dp.non_dp_gradient(
        _jax_loss, jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, batch), accum=2)
    calls = []
    got, gm = dp.non_dp_gradient(_port_loss, _to_port(params),
                                 _to_port(batch), accum=2,
                                 prepare=_counting_prepare(calls))
    assert calls == [False, False]
    _trees_close(got, want)
    np.testing.assert_allclose(_np(gm["loss"]), _np(wm["loss"]), **CLOSE)
    assert {x.dtype for x in tree_leaves(got)} == {torch.float32}


# ---------------------------------------------------------------------------
# synthetic LM corpora


def test_make_lm_data_deterministic_per_seed_and_domain():
    a = make_lm_data(3, 500, 64, domain=1)
    assert a.dtype == torch.int32 and a.shape == (500,)
    assert int(a.min()) >= 0 and int(a.max()) < 64
    assert torch.equal(a, make_lm_data(3, 500, 64, domain=1))
    assert not torch.equal(a, make_lm_data(4, 500, 64, domain=1))
    assert not torch.equal(a, make_lm_data(3, 500, 64, domain=2))


def test_make_lm_data_domains_are_different_chains():
    """Bigram counts of long streams: a domain's two streams (two seeds)
    agree far better than two domains' (the chain is the domain's, the
    stream the seed's)."""
    V = 8

    def bigrams(seed, domain):
        t = make_lm_data(seed, 20_000, V, domain=domain).numpy()
        c = np.zeros((V, V))
        np.add.at(c, (t[:-1], t[1:]), 1)
        return c / c.sum(1, keepdims=True)

    same = np.abs(bigrams(0, 0) - bigrams(1, 0)).mean()
    other = np.abs(bigrams(0, 0) - bigrams(0, 1)).mean()
    assert same < 0.02 < other


# ---------------------------------------------------------------------------
# engine: epoch length, round blocks


@pytest.mark.parametrize("n,batch", [(64, 8), (33, 8), (5, 8)])
def test_epoch_mode_reads_the_first_leaf_of_a_bare_token_tensor(n, batch):
    """``local_steps=0``: one epoch, n_k // B from the leading dim of the
    first leaf; a bare [n, S+1] tensor's, not its sequence length."""
    toks = np.zeros((n, 129), np.int32)
    kw = dict(local_steps=0, batch_size=batch, n_clients=1)
    ref = jax_engine.FederationEngine(
        JaxProxyFLConfig(**kw), n_clients=1, step_fns=lambda *a: a,
        init_fns=lambda k: {}, sample_fn=lambda *a: a, backend="loop")
    eng = FederationEngine(ProxyFLConfig(**kw), n_clients=1,
                           step_fns=lambda *a: a, init_fns=lambda g: {},
                           sample_fn=lambda *a: a, backend="loop",
                           device="cpu")
    want = ref.n_steps(jnp.asarray(toks))
    assert eng.n_steps(torch.as_tensor(toks)) == want == max(1, n // batch)
    assert eng.n_steps({"img": torch.zeros(n, 2), "tokens":
                        torch.as_tensor(toks)}) == want


@pytest.mark.parametrize("args", [(0, 10, 1), (0, 10, 4), (3, 10, 4),
                                  (0, 10, 4, 3), (2, 11, 5, 3, 4),
                                  (0, 7, 0), (0, 6, 2, 0)])
def test_block_spans_match_reference(args):
    assert list(block_spans(*args)) == list(jax_engine.block_spans(*args))


# ---------------------------------------------------------------------------
# dp_adam_update's fused chain is Adam's f32 update only


@pytest.mark.parametrize("case", ["bf16_params", "bf16_moments"])
def test_dp_adam_update_refuses_non_f32(case):
    dtype = torch.bfloat16 if case == "bf16_params" else torch.float32
    params = {"w": torch.zeros(3, dtype=dtype)}
    opt = Adam(moment_dtype="bfloat16" if case == "bf16_moments"
               else "float32")

    def loss(p, b):
        return (p["w"].float() * b).sum()

    with pytest.raises(NotImplementedError, match="item 6"):
        dp.dp_adam_update(loss, params, opt.init(params), torch.ones(2, 3),
                          opt=opt, clip_norm=1.0, noise_multiplier=1.0)


# ---------------------------------------------------------------------------
# kernel wrappers refuse an input that requires grad


def _wrapper_calls():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)

    P = torch.full((3, 3), 1 / 3)
    one = torch.ones(())
    return {
        "sumsq": (kernels.sumsq, (r(8),), {}),
        "scale_accumulate": (kernels.scale_accumulate,
                             (r(8), r(8), one), {}),
        "sumsq_rows": (kernels.sumsq_rows, (r(2, 8),), {}),
        "clip_accumulate_rows": (kernels.clip_accumulate_rows,
                                 (r(2, 8), torch.ones(2)), {}),
        "noise_sgd_step": (kernels.noise_sgd_step, (r(8), r(8), r(8)),
                           dict(stddev=1.0, n_units=2, lr=0.1)),
        "noise_adam_step": (kernels.noise_adam_step,
                            (r(8), r(8), r(8), r(8), r(8).abs()),
                            dict(stddev=1.0, n_units=2, lr=0.1,
                                 c1=0.1 * one, c2=0.01 * one)),
        "fused_pushsum_mix": (kernels.fused_pushsum_mix,
                              (r(3, 8), torch.ones(3), P), {}),
        "fused_stale_mix": (kernels.fused_stale_mix,
                            (r(3, 8), torch.ones(3), torch.full((3,), .5),
                             P / 2, r(3, 8), torch.zeros(3)), {}),
        "rmsnorm": (kernels.rmsnorm, (r(4, 8), torch.ones(8)), {}),
        "flash_attention": (kernels.flash_attention,
                            (r(1, 2, 5, 8), r(1, 2, 5, 8), r(1, 2, 5, 8)),
                            {}),
        "gqa_flash_attention": (kernels.gqa_flash_attention,
                                (r(1, 5, 4, 8), r(1, 5, 2, 8),
                                 r(1, 5, 2, 8)), {}),
        "mamba_scan": (kernels.mamba_scan,
                       (r(1, 6, 4).abs(), r(1, 6, 4), r(1, 6, 2),
                        r(1, 6, 2), -r(4, 2).exp()), {}),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_kernel_wrapper_refuses_an_input_that_requires_grad(name):
    fn, args, kw = _wrapper_calls()[name]
    live = (args[0].clone().requires_grad_(True),) + args[1:]
    with pytest.raises(RuntimeError, match="requires grad"):
        fn(*live, **kw)
    # inside a torch.func transform too
    first = lambda x: fn(x, *args[1:], **kw)  # noqa: E731

    def total(x):
        out = first(x)
        return sum(o.float().sum() for o in (out if isinstance(out, tuple)
                                             else (out,)))

    with pytest.raises(RuntimeError, match="requires grad"):
        grad(total)(args[0].clone())
    # without a gradient the plain version runs
    with torch.no_grad():
        fn(*live, **kw)
    fn(*args, **kw)


def test_serve_and_federation_paths_pass_no_differentiated_input():
    """With grad mode on, as a caller leaves it: a prefill through the
    kernel wrappers, and a ProxyFL round with ``use_pallas`` (the DP
    kernels and the mix on already-computed gradients and proxies)."""
    from test_torch_isolation import _tiny
    from repro_torch.core.engine import dml_engine

    cfg = smoke_variant(get_config("jamba-1.5-large-398b"))
    gen = torch.Generator().manual_seed(0)
    state = init_serve_state(gen, cfg, InputShape("s", 8, 2, "prefill"))
    tok = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    assert torch.is_grad_enabled()
    _, logits = make_prefill_step(cfg)(state, {"tokens": tok})
    assert torch.isfinite(logits.float()).all()
    spec, data, pcfg = _tiny()
    pcfg = dataclasses.replace(pcfg, use_pallas=True)
    eng = dml_engine((spec,) * 2, spec, pcfg, device="cpu")
    _, m = eng.run_round(eng.init_states(0), data, 0, seed=0)
    assert np.isfinite(m["proxy_loss"]).all()

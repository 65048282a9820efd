"""The port's LLM ProxyFL train step (``repro_torch.launch.steps.
make_train_step``) against the JAX package's, one step from the same state
on the same batch and DP noise (the reference's draws: ``add_gaussian_noise``
on the proxy's tree, flattened in sorted-key order into the port's flat
``noise``), for the smoke variants of qwen1.5-4b (dense), phi-3-vision-4.2b
(VLM) and musicgen-medium (audio); deepseek-v2-236b (MLA + MoE) is in
``test_torch_train_moe.py`` and jamba-1.5-large-398b (hybrid) in
``test_torch_train_hybrid.py``, files of their own for their reference
compile times.

Cast to f32 the new state (params, Adam moments, step counts) and both
losses agree at the conformance ``close`` grade (atol 1e-5, rtol 1e-4). As
registered, in bf16: every leaf normwise within 2e-2, the f32 master
copies ``p32`` by their update (p32' − p32, normwise 2e-2: elementwise the
step's bf16 gradients part by rounding, which Adam carries into p32 at up
to 16 times ``close``'s allowance on jamba's hybrid), and the bf16 params
the master copies rounded, bit for bit; the reference runs as one program
with XLA's excess precision off, so its bf16 ops round as the port's do.
Since the warm moments dominate a p32 update, the bf16 step's gradients
are also held by themselves: each leaf's (1 − b1)·g = m' − b1·m against
the f32 step's at the same point (the port's own f32 step from the bf16
state cast up, MoE choices pinned alike), the port's no further from it
than 1.25 times the reference's (the two bf16 gradients part by up to 3.2%,
each 1–2.6% from the f32 one).

The state comes from numpy draws in the reference's tree (its
``init_model`` draws eagerly cost seconds a model), through
``repro_torch.convert``, with warm Adam moments (t = 5): from zero moments
Adam's first step is lr·g/(|g| + ε), which turns a last-bit difference in
a gradient coordinate near ε into a step difference past ``close`` (7 of
the f32 qwen1.5-4b private model's ~700,000 coordinates do so; the
gradients themselves, the moments, agree at ``close``).

Top-k routing is the MoE models' one discontinuity: in bf16 the two
frameworks' router probabilities part by rounding (about 2e-3 after a few
layers), and where two experts are that close the choice flips (one token
of jamba's third MoE layer, probabilities 0.27032 / 0.26912 in the
reference, 0.26879 / 0.26946 in the port), after which the layers below
see different inputs. So a bf16 MoE model's step is compared with each
MoE layer's expert choice pinned to the reference's (recorded from an
op-by-op run of its forward), the port computing everything else, and
each choice of the port's own that differs is checked to be a near tie.

The port runs its step with ``use_pallas=True``: the peers' forwards go
through the kernel wrappers (their plain versions on CPU tensors), the
differentiated forwards through the model's plain path.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import DPConfig as JaxDPConfig  # noqa: E402
from repro.configs.base import ProxyFLConfig as JaxProxyFLConfig  # noqa: E402
from repro.configs.registry import proxy_of as jax_proxy_of  # noqa: E402
from repro.configs.registry import smoke_variant as jax_smoke  # noqa: E402
from repro.core.dp import _flat_gaussian_like  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.nn import model as jax_model  # noqa: E402
from repro.optim.optimizers import Adam as JaxAdam  # noqa: E402
from repro_torch.configs import (DPConfig, ProxyFLConfig,  # noqa: E402
                                 get_config, proxy_of, smoke_variant)
from repro_torch.convert import state_from_numpy  # noqa: E402
from repro_torch.launch.steps import (StepOptions,  # noqa: E402
                                      make_train_step)
from repro_torch.nn.modules import tree_leaves  # noqa: E402

CLOSE = dict(atol=1e-5, rtol=1e-4)
BF16_NORMWISE = 2e-2
# a bf16 step's gradient, leaf by leaf, normwise from the f32 gradient at
# the same point: the port's within 1.25 times the reference's distance
# (measured: 1.078 times at most over the five models' leaves; each bf16
# gradient 1-2.6% from the f32 one by rounding, and the two up to 3.2%
# apart, on jamba's routers)
GRAD_VS_F32 = 1.25
B, S = 4, 8
OPTS = dict(accum=2, dp_chunk=2)
# each op rounded to its dtype; LLVM unoptimised (the programs are tiny,
# and their compile time is what a test pays)
XLA_OPTIONS = {"xla_allow_excess_precision": False,
               "xla_backend_optimization_level": 0}


def jax_cfgs(arch, dtype):
    cfg = jax_smoke(jax_get_config(arch)).with_(dtype=dtype)
    return cfg, jax_smoke(jax_proxy_of(cfg))


def port_cfgs(arch, dtype):
    cfg = smoke_variant(get_config(arch)).with_(dtype=dtype)
    return cfg, smoke_variant(proxy_of(cfg))


def _fill(path, leaf, rng):
    """An f32 draw for one leaf of ``init_model``'s tree: gains and the
    mamba skip at 1, A_log the S4D-real log(1..ds), the rest N(0, 0.02)."""
    name = path[-1].key
    shape = leaf.shape
    if name in ("g", "D"):
        return np.ones(shape, np.float32)
    if name == "A_log":
        return np.broadcast_to(np.log(np.arange(
            1, shape[-1] + 1, dtype=np.float32)), shape).copy()
    return 0.02 * rng.standard_normal(shape, dtype=np.float32)


def _model_state(cfg, rng):
    """(params in their dtypes, Adam state): the params the rounding of f32
    draws, which are the master copy where a leaf is below f32; the
    moments warm, m ~ N(0, 1e-3²), v ~ 1e-6·(1 + |N(0, 1)|) at t = 5, a
    state mid-run."""
    shapes = jax.eval_shape(lambda k: jax_model.init_model(k, cfg),
                            jax.random.PRNGKey(0))
    p32 = jax.tree_util.tree_map_with_path(
        lambda p, s: _fill(p, s, rng), shapes)
    params = jax.tree_util.tree_map(lambda x, s: jnp.asarray(x, s.dtype),
                                    p32, shapes)
    opt = JaxAdam(lr=1e-3, weight_decay=1e-4).init(params)
    m = jax.tree_util.tree_map(lambda x: jnp.asarray(
        1e-3 * rng.standard_normal(x.shape), jnp.float32), params)
    v = jax.tree_util.tree_map(lambda x: jnp.asarray(
        1e-6 * (1 + np.abs(rng.standard_normal(x.shape))), jnp.float32),
        params)
    return params, opt._replace(
        m=m, v=v, t=jnp.asarray(5, jnp.int32),
        p32=None if opt.p32 is None else jax.tree_util.tree_map(
            jnp.asarray, p32))


def reference_state(arch, dtype, seed=0):
    """One client's reference train state (jax arrays) from numpy draws."""
    cfg, proxy = jax_cfgs(arch, dtype)
    rng = np.random.default_rng(seed)
    phi, opt_phi = _model_state(cfg, rng)
    theta, opt_theta = _model_state(proxy, rng)
    return {"private": {"params": phi, "opt": opt_phi},
            "proxy": {"params": theta, "opt": opt_theta},
            "w": jnp.ones((), jnp.float32), "t": jnp.zeros((), jnp.int32)}


def batch_of(cfg, n=B, seq=S, seed=3):
    rng = np.random.default_rng(seed)
    shape = (n, seq, cfg.n_codebooks) if cfg.modality == "audio" \
        else (n, seq)
    batch = {k: rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
             for k in ("tokens", "labels")}
    if cfg.modality == "vlm":
        batch["img"] = np.asarray(jnp.asarray(rng.standard_normal(
            (n, cfg.n_image_tokens, cfg.frontend_dim)), jnp.dtype(cfg.dtype)))
    return batch


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_batch(batch):
    from repro_torch.convert import tensor_from_numpy
    return {k: tensor_from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def reference_run(arch, dtype):
    """(state, batch, flat noise, new state, metrics) of one reference step
    (numpy), the step compiled once."""
    cfg, proxy = jax_cfgs(arch, dtype)
    fl = JaxProxyFLConfig(dp=JaxDPConfig(enabled=True), batch_size=B)
    step = jax_steps.make_train_step(
        cfg, proxy, fl, jax_steps.StepOptions(remat=False, **OPTS))
    state = reference_state(arch, dtype)
    batch = jax.tree_util.tree_map(jnp.asarray, batch_of(cfg))
    key = jax.random.PRNGKey(11)
    run = jax.jit(step).lower(state, batch, key).compile(XLA_OPTIONS)
    new, metrics = run(state, batch, key)
    noise = _flat_gaussian_like(state["proxy"]["params"], key)
    return (to_numpy(state), to_numpy(batch), np.array(noise),
            to_numpy(new), to_numpy(metrics))


def reference_routes(arch, dtype, state_np, batch_np):
    """The reference private model's top-k expert choices, MoE layer by
    layer, on each 2-example slice of the batch (the step's microbatches
    and DP chunks), from an op-by-op run of its forward (each bf16 op
    rounded, as in the compiled step; its layers run under ``lax.scan``,
    whose body a compiled run could not hand the choices out of)."""
    cfg, _ = jax_cfgs(arch, dtype)
    params = jax.tree_util.tree_map(jnp.asarray, state_np["private"]["params"])
    routes, top_k = [], jax.lax.top_k

    def recording(probs, k):
        out = top_k(probs, k)
        routes[-1].append(np.asarray(out[1]))
        return out

    n = OPTS["dp_chunk"]
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jax.lax, "top_k", recording)
        for i in range(0, B, n):
            routes.append([])
            jax_model.forward(params, cfg, jnp.asarray(
                batch_np["tokens"][i:i + n]), None if "img" not in batch_np
                else jnp.asarray(batch_np["img"][i:i + n]))
    return routes


def port_step(arch, dtype, state_np, batch_np, noise, routes=None):
    """One port step; ``routes`` (per slice, per MoE layer) pins each MoE
    layer's expert choice to the reference's, in the order the step runs
    the private model: its microbatches (the private loss), then its DP
    chunks (the private peer). Returns (state, metrics, flips): flips the
    port's own choices that differ, with the port's probability gap."""
    from repro_torch.nn import moe

    cfg, proxy = port_cfgs(arch, dtype)
    fl = ProxyFLConfig(dp=DPConfig(enabled=True), batch_size=B,
                       use_pallas=True)
    # remat off, as the reference step it is held to: the routes replay
    # the reference's top_k calls in order, and a recompute calls again
    step = make_train_step(cfg, proxy, fl, StepOptions(remat=False, **OPTS))
    state, batch = state_from_numpy(state_np), port_batch(batch_np)
    if routes is None:
        return step(state, batch, noise=torch.as_tensor(noise)) + ([],)
    order = iter([r for _ in range(2) for rs in routes for r in rs])
    flips, own_top_k = [], moe.top_k

    def pinned(probs, k):
        idx = torch.as_tensor(next(order), dtype=torch.int64)
        own = own_top_k(probs, k)[1]
        for t in torch.nonzero((torch.sort(own, -1).values
                                != torch.sort(idx, -1).values).any(-1)):
            p = probs[t[0]].detach()
            flips.append(float(p[own[t[0]]].sum() - p[idx[t[0]]].sum()))
        return torch.gather(probs, -1, idx), idx

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "top_k", pinned)
        new, metrics = step(state, batch, noise=torch.as_tensor(noise))
    assert next(order, None) is None
    return new, metrics, flips


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def leaves(new):
    """The state's leaves as (name, leaf), private then proxy: params,
    Adam m, v, t and p32; then w and t."""
    flat = tree_leaves if isinstance(new["w"], torch.Tensor) \
        else jax.tree_util.tree_leaves
    out = []
    for role in ("private", "proxy"):
        m, v, t, p32 = new[role]["opt"]
        for part, tree in (("params", new[role]["params"]), ("m", m),
                           ("v", v), ("t", t), ("p32", p32)):
            out += [(f"{role}/{part}/{i}", x)
                    for i, x in enumerate(flat(tree))]
    return out + [("w", new["w"]), ("t", new["t"])]


def _normwise(a, b, name, grade=BF16_NORMWISE):
    err = np.linalg.norm(a - b)
    assert err <= grade * np.linalg.norm(b) + 1e-30, \
        (name, err / max(np.linalg.norm(b), 1e-30))


def assert_step_matches(got, want, dtype, state):
    """f32: every leaf and both losses at ``close``. bf16: every leaf
    normwise within 2e-2 (the master copies by their update, p32' − p32,
    where the step's bf16 gradients enter them), the losses at 2e-2, and
    the bf16 params the master copies rounded, bit for bit."""
    (g_state, g_m), (w_state, w_m) = got, want
    ours, theirs = leaves(g_state), leaves(w_state)
    before = dict(leaves(state))
    assert [n for n, _ in ours] == [n for n, _ in theirs]
    for (name, a), (_, b) in zip(ours, theirs):
        a, b = _f32(a), _f32(b)
        assert a.shape == b.shape, name
        if dtype == "float32" or "/t/" in name or name in ("w", "t"):
            np.testing.assert_allclose(a, b, err_msg=name, **CLOSE)
        elif "/p32/" in name:
            p0 = _f32(before[name])
            _normwise(a - p0, b - p0, name)
        else:
            _normwise(a, b, name)
    for k in ("private_loss", "proxy_loss"):
        np.testing.assert_allclose(_f32(g_m[k]), _f32(w_m[k]),
                                   **(CLOSE if dtype == "float32"
                                      else dict(atol=2e-2, rtol=2e-2)))
    if dtype != "float32":
        for role in ("private", "proxy"):
            p32 = g_state[role]["opt"].p32
            assert {x.dtype for x in tree_leaves(p32)} == {torch.float32}
            for p, m in zip(tree_leaves(g_state[role]["params"]),
                            tree_leaves(p32)):
                assert torch.equal(p, m.to(p.dtype))


def as_f32(tree):
    """A numpy state or batch with every float leaf in f32 and no master
    copies."""
    def cast(x):
        return x if np.issubdtype(x.dtype, np.integer) else \
            np.asarray(x, np.float32)
    out = jax.tree_util.tree_map(cast, tree)
    for role in ("private", "proxy"):
        if role in out:
            out[role]["opt"] = out[role]["opt"]._replace(p32=None)
    return out


def assert_gradients_near_f32(got, want, truth):
    """A bf16 step's gradient, each leaf's (1 − b1)·g = m' − b1·m (the
    warm moment both steps start from cancels), normwise from the f32
    step's at the same point: the port's no further than ``GRAD_VS_F32``
    times the reference's."""
    ref, f32 = dict(leaves(want)), dict(leaves(truth))
    for name, a in leaves(got):
        if "/m/" not in name:
            continue
        m32 = _f32(f32[name])
        port = np.linalg.norm(_f32(a) - m32)
        theirs = np.linalg.norm(_f32(ref[name]) - m32)
        assert port <= GRAD_VS_F32 * theirs + 1e-6 * np.linalg.norm(m32), \
            (name, port, theirs)


ARCHS = ("qwen1.5-4b", "phi-3-vision-4.2b", "musicgen-medium")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, dtype):
    check_step(arch, dtype)


def check_step(arch, dtype):
    """The port's step against the reference's; a bf16 MoE model with its
    expert choices pinned to the reference's (each differing choice of
    the port's own a near tie, within the bf16 grade)."""
    state, batch, noise, new, metrics = reference_run(arch, dtype)
    moe = dtype == "bfloat16" and port_cfgs(arch, dtype)[0].moe is not None
    routes = reference_routes(arch, dtype, state, batch) if moe else None
    *got, flips = port_step(arch, dtype, state, batch, noise, routes)
    assert all(0 <= gap < BF16_NORMWISE for gap in flips), flips
    assert_step_matches(got, (new, metrics), dtype, state)
    assert int(got[0]["t"]) == 1 + int(state["t"])
    if dtype == "bfloat16":
        assert got[0]["private"]["opt"].p32 is not None
        truth = port_step(arch, "float32", as_f32(state), as_f32(batch),
                          noise, routes)[0]
        assert_gradients_near_f32(got[0], new, truth)
    return flips

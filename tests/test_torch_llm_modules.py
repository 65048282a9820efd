"""The port's LLM building blocks (``repro_torch.nn``: modules, attention,
mamba, MLA, MoE) against the JAX package's on the same numpy inputs and
the same params (the reference's ``init_*`` draws, converted).

Grade: the conformance ``close`` grade (atol 1e-5, rtol 1e-4,
tests/test_conformance.py) in f32, where only the summation order differs
between the frameworks; bf16 at 2e-2. Params are drawn with numpy in the
layout and dtypes of the reference's ``init_*`` (the per-model tests in
tests/test_torch_serve.py start from its own draws). The kernel route of
each block
(``use_pallas=True``, which on CPU tensors runs the kernel wrappers' plain
versions) is held against the same JAX output. Each JAX function runs
under one ``jax.jit`` (a test compiles it once, not op by op).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jax_base  # noqa: E402
from repro.nn import attention as jax_attention  # noqa: E402
from repro.nn import mamba as jax_mamba  # noqa: E402
from repro.nn import mla as jax_mla  # noqa: E402
from repro.nn import modules as jax_modules  # noqa: E402
from repro.nn import moe as jax_moe  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.convert import model_params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.kernels import mamba_scan  # noqa: E402
from repro_torch.nn import attention, mamba, mla, modules, moe  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402

CLOSE = dict(atol=1e-5, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
GRADE = {"float32": CLOSE, "bfloat16": BF16}


def _cfgs(**kw):
    """The same model configuration in both packages."""
    def conv(mod, v):
        if isinstance(v, tuple):
            return tuple(conv(mod, s) for s in v)
        if dataclasses.is_dataclass(v):
            return getattr(mod, type(v).__name__)(**dataclasses.asdict(v))
        return v
    return (jax_base.ModelConfig(**{k: conv(jax_base, v) for k, v in kw.items()}),
            base.ModelConfig(**{k: conv(base, v) for k, v in kw.items()}))


def _t(a):
    return tensor_from_numpy(np.asarray(a))


def _params(tree):
    return model_params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def _close(got, want, grade=CLOSE, **kw):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **grade, **kw)


def _jit(fn, **static):
    """``fn`` compiled with its configuration (and other non-array
    arguments) bound."""
    return jax.jit(lambda *a, **kw: fn(*a, **static, **kw))


def _init(init_fn, seed=0, scale=0.1, **static):
    """Params in the layout and dtypes ``init_fn`` gives (traced for its
    shapes only, so no random kernel is compiled), drawn with numpy."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: init_fn(k, **static),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda s: jnp.asarray(scale * rng.standard_normal(s.shape), s.dtype),
        shapes)


def _rand(rng, shape, dtype="float32"):
    return jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                       jnp.dtype(dtype))


# ---------------------------------------------------------------------------
# modules


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = _rand(rng, (3, 5, 48), dtype)
    g = {"g": _rand(rng, (48,), dtype)}
    want = jax.jit(jax_modules.rmsnorm)(g, x)
    tg = _params(g)
    _close(modules.rmsnorm(tg, _t(x), use_pallas=False), want, GRADE[dtype])
    # the kernel's plain version: the gain applied in f32, one rounding
    _close(modules.rmsnorm(tg, _t(x), use_pallas=True), want, GRADE[dtype])


@pytest.mark.parametrize("offset,theta", [(0, 10_000.0), (1_000, 1e6)])
def test_apply_rope(offset, theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, (2, 7, 3, 16))
    pos = jnp.arange(offset, offset + 7, dtype=jnp.int32)
    want = _jit(jax_modules.apply_rope, theta=theta)(x, pos)
    got = modules.apply_rope(_t(x), torch.arange(offset, offset + 7), theta)
    _close(got, want)


def test_mlp_and_embedding():
    rng = np.random.default_rng(2)
    p = _init(jax_modules.init_mlp, d_model=32, d_ff=64)
    e = _init(jax_modules.init_embedding, seed=1, vocab=50, d=32)
    ids = rng.integers(0, 50, (2, 5))
    x = jax.jit(jax_modules.embed)(e, jnp.asarray(ids))
    tx = modules.embed(_params(e), torch.from_numpy(ids))
    _close(tx, x)
    _close(modules.mlp(_params(p), tx), jax.jit(jax_modules.mlp)(p, x))
    _close(modules.unembed(_params(e), tx),
           jax.jit(jax_modules.unembed)(e, x))


# ---------------------------------------------------------------------------
# attend

ATTEND_CASES = {
    "dense": dict(Sq=9, Sk=9, Hq=4, Hkv=4, D=16, window=None, chunk=1024),
    "chunked padded": dict(Sq=37, Sk=37, Hq=4, Hkv=4, D=16, window=None,
                           chunk=16),
    "window": dict(Sq=37, Sk=37, Hq=4, Hkv=4, D=16, window=5, chunk=16),
    "window dense": dict(Sq=9, Sk=9, Hq=4, Hkv=2, D=16, window=3,
                         chunk=1024),
    "gqa": dict(Sq=21, Sk=21, Hq=6, Hkv=2, D=8, window=None, chunk=8),
    "mqa dqk != dv": dict(Sq=11, Sk=11, Hq=4, Hkv=1, D=12, Dv=8,
                          window=None, chunk=4),
    "queries at an offset": dict(Sq=3, Sk=20, Hq=4, Hkv=2, D=8, window=6,
                                 chunk=8, q_off=17),
}


@pytest.mark.parametrize("case", sorted(ATTEND_CASES))
def test_attend(case):
    c = ATTEND_CASES[case]
    rng = np.random.default_rng(3)
    q = _rand(rng, (2, c["Sq"], c["Hq"], c["D"]))
    k = _rand(rng, (2, c["Sk"], c["Hkv"], c["D"]))
    v = _rand(rng, (2, c["Sk"], c["Hkv"], c.get("Dv", c["D"])))
    q_off = c.get("q_off", 0)
    q_pos = np.arange(q_off, q_off + c["Sq"])
    kv_pos = np.arange(c["Sk"])
    want = _jit(jax_attention.attend, window=c["window"],
                kv_chunk=c["chunk"])(q, k, v,
                                     q_pos=jnp.asarray(q_pos, jnp.int32),
                                     kv_pos=jnp.asarray(kv_pos, jnp.int32))
    got = attention.attend(_t(q), _t(k), _t(v), q_pos=torch.from_numpy(q_pos),
                           kv_pos=torch.from_numpy(kv_pos),
                           window=c["window"], kv_chunk=c["chunk"])
    _close(got, want)


# ---------------------------------------------------------------------------
# attention layer and its three cache cases

ATTN_KW = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
               qkv_bias=True, rope_theta=10_000.0)


@functools.lru_cache(maxsize=None)
def _jax_attention(case):
    """The reference through the case's (offset, length) calls on one cache
    (or none): params, inputs, and each call's output and cache leaves
    (once for both routes of the port)."""
    spec_kw, cache_len, cache_window, steps = ATTN_CACHE_CASES[case]
    jcfg, _ = _cfgs(**ATTN_KW)
    p = _init(jax_attention.init_attention, cfg=jcfg)
    step = _jit(jax_attention.apply_attention, cfg=jcfg,
                spec=jax_base.LayerSpec(**spec_kw), kv_chunk=4)
    rng = np.random.default_rng(4)
    jc = None if cache_len is None else jax_attention.init_kv_cache(
        jcfg, 2, cache_len, window=cache_window)
    calls = []
    for off, S in steps:
        x = _rand(rng, (2, S, 32))
        y, jc = step(p, x=x, pos_offset=jnp.int32(off), cache=jc)
        calls.append((off, x, y, jax.tree_util.tree_leaves(jc)))
    return p, calls


ATTN_CACHE_CASES = {
    # no cache: the forward of a block, causal and windowed
    "no cache": (dict(), None, None, [(0, 9)]),
    "no cache window": (dict(window=3), None, None, [(0, 9)]),
    # the linear cache: prefill, decode, then a second block at an offset
    "linear": (dict(), 16, None, [(0, 5), (5, 1), (6, 1), (7, 4), (11, 1)]),
    # the ring buffer of a windowed layer: a prefill longer than the
    # window, decode steps that wrap, a block at an offset
    "ring": (dict(window=4, rope_theta=1e6), 16, 4,
             [(0, 6), (6, 1), (7, 1), (8, 1), (9, 3), (12, 1)]),
    # window decode over a full-length cache (allocated without the window)
    "window over a full cache": (dict(window=4), 12, None,
                                 [(0, 6), (6, 1), (7, 1), (8, 1), (9, 1)]),
}


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain", "kernel route"])
@pytest.mark.parametrize("case", sorted(ATTN_CACHE_CASES))
def test_apply_attention(case, use_pallas):
    spec_kw, cache_len, cache_window, _ = ATTN_CACHE_CASES[case]
    _, tcfg = _cfgs(**ATTN_KW)
    p, calls = _jax_attention(case)
    tp = _params(p)
    tc = None if cache_len is None else attention.init_kv_cache(
        tcfg, 2, cache_len, window=cache_window)
    for off, x, y, cache in calls:
        ty, tc = attention.apply_attention(
            tp, tcfg, base.LayerSpec(**spec_kw), _t(x), pos_offset=off,
            cache=tc, kv_chunk=4, use_pallas=use_pallas)
        _close(ty, y, err_msg=f"output at offset {off}")
        for a, b in zip(tree_leaves(tc), cache):
            _close(a, b, err_msg=f"cache after offset {off}")


# ---------------------------------------------------------------------------
# mamba

MAMBA_KW = dict(d_model=16, mamba=jax_base.MambaConfig(d_state=5, d_conv=4,
                                                       expand=2, dt_rank=3))


MAMBA_CASES = {
    "S <= chunk": [9],
    "padded chunks": [11],
    "prefill then decode (S == 1)": [6, 1, 1, 2, 1],
    "short blocks on the conv state": [2, 1, 13],
}


@functools.lru_cache(maxsize=None)
def _jax_mamba(branch):
    """The reference without a cache on the first length, then through
    every length on one cache: params, and (cached, x, y, cache) a call."""
    jcfg, _ = _cfgs(**MAMBA_KW)
    p = _init(jax_mamba.init_mamba, cfg=jcfg)
    step = _jit(jax_mamba.apply_mamba, cfg=jcfg, chunk=4)
    rng = np.random.default_rng(5)
    calls = []
    for cached in (False, True):
        jc = jax_mamba.init_mamba_cache(jcfg, 2) if cached else None
        for S in (MAMBA_CASES[branch] if cached else MAMBA_CASES[branch][:1]):
            x = _rand(rng, (2, S, 16))
            y, jc = step(p, x=x, cache=jc)
            calls.append((cached, x, y, jc))
    return p, calls


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain", "kernel route"])
@pytest.mark.parametrize("branch", sorted(MAMBA_CASES))
def test_apply_mamba(branch, use_pallas):
    _, tcfg = _cfgs(**MAMBA_KW)
    p, calls = _jax_mamba(branch)
    tp = _params(p)
    tc = None
    for cached, x, y, jc in calls:
        if cached and tc is None:
            tc = mamba.init_mamba_cache(tcfg, 2)
        ty, tc = mamba.apply_mamba(tp, tcfg, _t(x), cache=tc, chunk=4,
                                   use_pallas=use_pallas)
        S = x.shape[1]
        _close(ty, y, err_msg=f"output, S = {S}")
        if cached:   # the conv state and h_last
            _close(tc["conv"], jc["conv"])
            _close(tc["ssm"], jc["ssm"], err_msg=f"h_last, S = {S}")


def test_associative_scan_is_the_reference_recursion():
    """Lengths odd and even at every level of the recursion: the same pairs combined in the same order, so in f32
    the scan of products and affine maps agrees to the last bits that the
    two frameworks' multiply-adds allow."""
    rng = np.random.default_rng(6)
    scan = jax.jit(lambda a, b: jax.lax.associative_scan(
        lambda l, r: (l[0] * r[0], l[1] * r[0] + r[1]), (a, b), axis=1))
    for n in (1, 2, 3, 5, 6, 7, 16, 17, 33):
        a = rng.uniform(0.5, 1.0, (2, n, 3)).astype(np.float32)
        b = rng.standard_normal((2, n, 3)).astype(np.float32)
        want = scan(jnp.asarray(a), jnp.asarray(b))
        got = mamba.associative_scan(mamba._combine,
                                     (torch.from_numpy(a), torch.from_numpy(b)))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


def test_scan_wrapper_state_in_and_out_on_the_cpu():
    """``kernels.mamba_scan`` with ``h0`` and ``return_state`` (its plain
    version here) against the reference's ``_chunk_scan`` from the same
    state: y and the final state."""
    rng = np.random.default_rng(7)
    B, S, di, ds = 2, 13, 6, 5
    dt = rng.uniform(0.01, 0.2, (B, S, di)).astype(np.float32)
    x, h0 = (rng.standard_normal(s).astype(np.float32)
             for s in ((B, S, di), (B, di, ds)))
    Bm, Cm = (rng.standard_normal((B, S, ds)).astype(np.float32)
              for _ in range(2))
    A = -rng.uniform(0.5, 2.0, (di, ds)).astype(np.float32)
    want_y, want_h = jax.jit(jax_mamba._chunk_scan)(
        *(jnp.asarray(t) for t in (h0, dt, A, Bm, Cm, x)))
    y, h = mamba_scan(*(torch.from_numpy(t) for t in (dt, x, Bm, Cm, A)),
                      h0=torch.from_numpy(h0), return_state=True)
    _close(y, want_y)
    _close(h, want_h)
    y0 = mamba_scan(*(torch.from_numpy(t) for t in (dt, x, Bm, Cm, A)))
    y1, _ = mamba_scan(*(torch.from_numpy(t) for t in (dt, x, Bm, Cm, A)),
                       return_state=True)
    assert torch.equal(y0, y1)
    with pytest.raises(ValueError):
        mamba_scan(*(torch.from_numpy(t) for t in (dt, x, Bm, Cm, A)),
                   h0=torch.zeros(B, di, ds + 1))


# ---------------------------------------------------------------------------
# MLA

MLA_KW = dict(d_model=32, n_heads=4, n_kv_heads=4, attn_impl="mla",
              mla=jax_base.MLAConfig(kv_lora_rank=16, q_lora_rank=24,
                                     qk_nope_head_dim=8, qk_rope_head_dim=4,
                                     v_head_dim=6))


MLA_CASES = {
    "expanded, no cache": None,
    "expanded prefill, absorbed decode": [(0, 6), (6, 1), (7, 1), (8, 3),
                                          (11, 1)],
}


@functools.lru_cache(maxsize=None)
def _jax_mla(path):
    jcfg, _ = _cfgs(**MLA_KW)
    p = _init(jax_mla.init_mla, cfg=jcfg)
    step = _jit(jax_mla.apply_mla, cfg=jcfg,
                spec=jax_base.LayerSpec(rope_theta=1e4), kv_chunk=4)
    rng = np.random.default_rng(8)
    steps = MLA_CASES[path]
    jc = None if steps is None else jax_mla.init_mla_cache(jcfg, 2, 14)
    calls = []
    for off, S in steps or [(0, 7)]:
        x = _rand(rng, (2, S, 32))
        y, jc = step(p, x=x, pos_offset=jnp.int32(off), cache=jc)
        calls.append((off, x, y, jc))
    return p, calls


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain", "kernel route"])
@pytest.mark.parametrize("path", sorted(MLA_CASES))
def test_mla(path, use_pallas):
    _, tcfg = _cfgs(**MLA_KW)
    p, calls = _jax_mla(path)
    tp = _params(p)
    tc = None if MLA_CASES[path] is None else mla.init_mla_cache(tcfg, 2, 14)
    for off, x, y, jc in calls:
        ty, tc = mla.apply_mla(tp, tcfg, base.LayerSpec(rope_theta=1e4),
                               _t(x), pos_offset=off, cache=tc, kv_chunk=4,
                               use_pallas=use_pallas)
        _close(ty, y, err_msg=f"offset {off}")
        if jc is not None:
            _close(tc["ckv"], jc["ckv"])
            _close(tc["kr"], jc["kr"])


# ---------------------------------------------------------------------------
# MoE

MOE_KW = dict(d_model=16, moe=jax_base.MoEConfig(
    n_experts=4, top_k=2, d_ff_expert=8, n_shared_experts=1,
    dense_residual_d_ff=8))


def _tie(p):
    """Router columns 1 and 2 (and 0 and 3) equal: every token's
    probabilities tie in pairs, so top-k decides by index alone."""
    r = np.asarray(p["router"]).copy()
    r[:, 2] = r[:, 1]
    r[:, 3] = r[:, 0]
    return dict(p, router=jnp.asarray(r))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["routed", "tie", "capacity drop",
                                  "tie and capacity drop"])
def test_moe(case, dtype):
    kw = dict(MOE_KW, dtype=dtype)
    if "capacity" in case:   # capacity 1 of 24 tokens x 2 slots
        kw["moe"] = dataclasses.replace(kw["moe"], capacity_factor=0.1)
    jcfg, tcfg = _cfgs(**kw)
    p = _init(jax_moe.init_moe, cfg=jcfg, dtype=jnp.dtype(dtype))
    if "tie" in case:
        p = _tie(p)
    x = _rand(np.random.default_rng(9), (2, 12, 16), dtype)
    y, aux = _jit(jax_moe.apply_moe, cfg=jcfg)(p, x=x)
    ty, taux = moe.apply_moe(_params(p), tcfg, _t(x))
    _close(ty, y, GRADE[dtype])
    _close(taux, aux)
    if "tie" in case:   # lower index first, as lax.top_k
        probs = torch.softmax(_t(x).reshape(-1, 16).float()
                              @ _t(p["router"]), -1)
        _, idx = moe.top_k(probs, 2)
        assert set(idx[:, 0].tolist()) <= {0, 1}
        want = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)[1]
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want))

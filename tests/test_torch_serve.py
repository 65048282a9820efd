"""The port's LLM serving path (``repro_torch.nn.model``,
``repro_torch.launch``) against the JAX package's, for the smoke variant of
every registered architecture, from the same params (the reference's
``init_model`` draws, converted: threefry and Philox draws cannot match).

Per architecture and dtype: the no-cache forward's logits and aux loss,
and prefill (7 tokens) + 5 decode steps (logits, and the KV/SSM caches
after each), at the conformance ``close`` grade (atol 1e-5, rtol 1e-4) in
f32 and at 2e-2 in bf16; the kernel route (``use_pallas=True``: on CPU
tensors the kernel wrappers' plain versions) against the model's plain
path at the same grades; the param and cache trees' layout against the
reference's; and the serve command on the CPU.

The reference runs as one compiled program an architecture and dtype
(the forward, the prefill, and the decode steps under ``lax.scan``), with
XLA's excess precision off: by default XLA on the CPU computes a fused
chain of bf16 elementwise ops in f32 and rounds once, where each op of the
port (and of the reference run op by op) rounds to bf16, so the bf16
comparison is made against the reference's op-by-op rounding. The bf16 params are the f32
draws rounded (the leaves that ``init_model`` keeps in f32, MoE routers,
stay f32). Registry names whose smoke variants are one model (qwen1.5-4b,
qwen1.5-110b and qwen2-7b) share one run of each side.

A MoE model in bf16 is compared layer by layer (:func:`_lockstep`): each
layer of the reference, of the port's plain path and of its kernel route
takes the same input, the port's plain path's own activation. Top-k
routing is the model's one discontinuity, and whole runs part at a near
tie: in arctic's second MoE layer one token's probabilities for two
experts swap order under one bf16 ulp of difference in the layer's
input, which the frameworks' matmuls reach by rounding alone.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_archs as jax_list_archs  # noqa: E402
from repro.configs.registry import smoke_variant as jax_smoke  # noqa: E402
from repro.nn import blocks as jax_blocks  # noqa: E402
from repro.nn import model as jax_model  # noqa: E402
from repro.nn import modules as jax_modules  # noqa: E402
from repro_torch.configs import get_config, list_archs, smoke_variant  # noqa: E402
from repro_torch.convert import cache_from_numpy, model_params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import (StepOptions, _text_logits,  # noqa: E402
                                      init_serve_state, make_decode_step,
                                      make_prefill_step)
from repro_torch.nn import model  # noqa: E402
from repro_torch.nn.blocks import apply_layer  # noqa: E402
from repro_torch.nn.modules import rmsnorm, tree_leaves  # noqa: E402

CLOSE = dict(atol=1e-5, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
GRADE = {"float32": CLOSE, "bfloat16": BF16}
ARCHS = list_archs()
DTYPES = ("float32", "bfloat16")
B, S, S0 = 2, 12, 7
# reference compiles: each op rounded to its dtype; LLVM unoptimised (the
# programs are tiny, and their compile time is what a test pays)
XLA_OPTIONS = {"xla_allow_excess_precision": False,
               "xla_backend_optimization_level": 0}


def _cfgs(arch, dtype):
    return (jax_smoke(jax_get_config(arch)).with_(dtype=dtype),
            smoke_variant(get_config(arch)).with_(dtype=dtype))


def _n_img(cfg):
    return cfg.n_image_tokens if cfg.modality == "vlm" else 0


def _same_model(arch):
    """The first registry name whose smoke variant is ``arch``'s, up to
    its name and source."""
    def model_of(a):
        return smoke_variant(get_config(a)).with_(name="", source="")
    return next(a for a in ARCHS if model_of(a) == model_of(arch))


@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    """The reference's f32 ``init_model`` draws (numpy)."""
    cfg, _ = _cfgs(arch, "float32")
    params = jax_model.init_model(jax.random.PRNGKey(0), cfg)
    return jax.tree_util.tree_map(np.asarray, params)


def _params(arch, dtype):
    """The draws in the dtypes ``init_model`` gives each leaf at ``dtype``."""
    cfg, _ = _cfgs(arch, dtype)
    shapes = jax.eval_shape(lambda k: jax_model.init_model(k, cfg),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda a, s: np.asarray(
        jnp.asarray(a, s.dtype)), _reference_params(arch), shapes)


def _inputs(cfg):
    rng = np.random.default_rng(3)
    shape = (B, S, cfg.n_codebooks) if cfg.modality == "audio" else (B, S)
    tok = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    img = (rng.standard_normal((B, cfg.n_image_tokens, cfg.frontend_dim))
           .astype(np.float32) if cfg.modality == "vlm" else None)
    return tok, img


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(XLA_OPTIONS)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_run(arch, dtype):
    return _jax_model_run(_same_model(arch), dtype)


@functools.lru_cache(maxsize=None)
def _jax_model_run(arch, dtype):
    """The reference: forward, prefill of S0 tokens, then one decode step a
    token (under ``lax.scan``), one compiled program; logits, aux and the
    cache leaves after each call (f32 numpy)."""
    cfg, _ = _cfgs(arch, dtype)
    params = jax.tree_util.tree_map(jnp.asarray, _params(arch, dtype))
    tok, img = _inputs(cfg)
    img = None if img is None else jnp.asarray(img, jnp.dtype(dtype))
    n_img = _n_img(cfg)

    def run(p, tok, img):
        full, _, aux = jax_model.forward(p, cfg, tok, img)
        cache = jax_model.init_cache(cfg, B, S + n_img)
        logits, cache, _ = jax_model.forward(p, cfg, tok[:, :S0], img,
                                             cache=cache, pos_offset=0)

        def step(cache, xs):
            t, pos = xs
            lg, cache, _ = jax_model.forward(p, cfg, t, None, cache=cache,
                                             pos_offset=pos)
            return cache, (lg, cache)
        # decode inputs [S - S0, B, 1(, K)], one a step
        toks = jnp.moveaxis(tok[:, S0:], 1, 0)[:, :, None]
        pos = jnp.arange(S0, S, dtype=jnp.int32) + n_img
        _, decoded = jax.lax.scan(step, cache, (toks, pos))
        return full, aux, logits, cache, decoded

    full, aux, logits, cache, (lgs, caches) = _compile(run, params, tok,
                                                       img)(params, tok, img)
    steps = [(_f32(logits), [_f32(c) for c in
                             jax.tree_util.tree_leaves(cache)])]
    steps += [(_f32(lgs[i]), [_f32(c[i]) for c in
                              jax.tree_util.tree_leaves(caches)])
              for i in range(S - S0)]
    return {"full": _f32(full), "aux": float(aux), "steps": steps}


def _torch_run(arch, dtype, use_pallas):
    return _torch_model_run(_same_model(arch), dtype, use_pallas)


@functools.lru_cache(maxsize=None)
def _torch_model_run(arch, dtype, use_pallas):
    """The port through the same calls as :func:`_jax_run`."""
    _, cfg = _cfgs(arch, dtype)
    params = model_params_from_numpy(_params(arch, dtype))
    tok, img = _inputs(cfg)
    tok = torch.from_numpy(tok).long()
    img = None if img is None else torch.from_numpy(img).to(
        getattr(torch, dtype))
    n_img = _n_img(cfg)
    kw = dict(use_pallas=use_pallas)
    full, _, aux = model.forward(params, cfg, tok, img, **kw)
    cache = model.init_cache(cfg, B, S + n_img, device="cpu")
    steps = []
    for t, im, pos, _ in _calls(cfg, tok, img)[1:]:
        logits, cache, _ = model.forward(params, cfg, t, im, cache=cache,
                                         pos_offset=pos, **kw)
        steps.append((logits.float().numpy(),
                      [c.float().numpy().copy() for c in tree_leaves(cache)]))
    return {"full": full.float().numpy(), "aux": float(aux), "steps": steps}


def _calls(cfg, tok, img):
    """(tokens, img, pos_offset, with a cache) of each call of a run: the
    forward, the prefill, then one decode step a token."""
    n_img = _n_img(cfg)
    return ([(tok, img, 0, False), (tok[:, :S0], img, 0, True)]
            + [(tok[:, i:i + 1], None, i + n_img, True)
               for i in range(S0, S)])


class _Compiled:
    """``fn`` compiled with :data:`XLA_OPTIONS`, once per argument
    structure and shapes."""

    def __init__(self, fn):
        self.fn, self.done = fn, {}

    def __call__(self, *args):
        leaves, tree = jax.tree_util.tree_flatten(args)
        key = (tree, tuple((x.shape, x.dtype) for x in leaves))
        if key not in self.done:
            self.done[key] = _compile(self.fn, *args)
        return self.done[key](*args)


def _jax_layer_of(tree, group, i, r):
    one = tree[group][i]
    return one if r is None else jax.tree_util.tree_map(lambda t: t[r], one)


@functools.lru_cache(maxsize=None)
def _lockstep(arch, dtype):
    """Every call of a run layer by layer: each layer of the reference, of
    the port's plain path and of its kernel route from the same input (the
    port's plain activation), each with its own cache; then the final norm
    and logits from the same input. Returns (what, reference, plain,
    kernel) rows of f32 arrays: layer outputs, aux losses, caches, logits."""
    jcfg, cfg = _cfgs(arch, dtype)
    np_params = _params(arch, dtype)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = model_params_from_numpy(np_params)
    tok, img = _inputs(cfg)
    tok = torch.from_numpy(tok).long()
    img = None if img is None else torch.from_numpy(img).to(
        getattr(torch, dtype))
    plan = model.layer_plan(cfg)
    max_len = S + _n_img(cfg)
    caches = [model.init_cache(cfg, B, max_len, device="cpu")
              for _ in range(2)]
    jcaches = [jax_blocks.init_layer_cache(jcfg, spec, B, max_len,
                                           jnp.dtype(dtype))
               for spec, *_ in plan]
    layers = {spec: _Compiled(functools.partial(
        lambda spec, p, x, c, pos: jax_blocks.apply_layer(
            p, jcfg, spec, x, pos_offset=pos, cache=c), spec))
        for spec, *_ in plan}
    head = _Compiled(lambda p, x: jax_model._logits(
        p, jcfg, jax_modules.rmsnorm(p["norm_f"], x)))
    rows = []
    for c, (t, im, pos, cached) in enumerate(_calls(cfg, tok, img)):
        x = model._embed_inputs(tparams, cfg, t, im)
        for n, (spec, group, i, r) in enumerate(plan):
            p = model.layer_of(tparams, group, i, r)
            outs = []
            for use_pallas, cache in zip((False, True), caches):
                outs.append(apply_layer(
                    p, cfg, spec, x, pos_offset=pos, use_pallas=use_pallas,
                    cache=model.layer_of(cache, group, i, r)
                    if cached else None))
            y, jc, aux = layers[spec](_jax_layer_of(jparams, group, i, r),
                                      jnp.asarray(x.float().numpy(),
                                                  jnp.dtype(dtype)),
                                      jcaches[n] if cached else None,
                                      jnp.int32(pos))
            what = f"call {c}, layer {n}"
            rows.append((what, _f32(y), *(o[0].float().numpy()
                                          for o in outs)))
            rows.append((what + " aux", _f32(aux),
                         *(o[2].float().numpy() for o in outs)))
            if cached:
                jcaches[n] = jc
                for k, leaf in enumerate(jax.tree_util.tree_leaves(jc)):
                    rows.append((f"{what} cache {k}", _f32(leaf), *(
                        tree_leaves(o[1])[k].float().numpy().copy()
                        for o in outs)))
            x = outs[0][0]
        rows.append((f"call {c}, logits",
                     _f32(head(jparams, jnp.asarray(x.float().numpy(),
                                                    jnp.dtype(dtype)))),
                     *(model._logits(tparams, cfg, rmsnorm(
                         tparams["norm_f"], x, use_pallas=k)).float()
                       .numpy() for k in (False, True))))
    return rows


def _lockstep_compared(arch, dtype):
    """Whether the whole-run comparison gives way to :func:`_lockstep`."""
    return dtype == "bfloat16" and _cfgs(arch, dtype)[1].moe is not None


def _compare(got, want, grade):
    np.testing.assert_allclose(got["full"], want["full"], **grade,
                               err_msg="forward logits")
    np.testing.assert_allclose(got["aux"], want["aux"], **CLOSE,
                               err_msg="aux loss")
    assert len(got["steps"]) == len(want["steps"])
    for n, ((lg, cache), (wlg, wcache)) in enumerate(zip(got["steps"],
                                                         want["steps"])):
        what = "prefill" if n == 0 else f"decode step {n}"
        np.testing.assert_allclose(lg, wlg, **grade,
                                   err_msg=f"{what} logits")
        assert len(cache) == len(wcache)
        for c, wc in zip(cache, wcache):
            np.testing.assert_allclose(c, wc, **grade,
                                       err_msg=f"cache after {what}")


def test_registry_names_are_the_reference_names():
    assert ARCHS == jax_list_archs()
    assert len(ARCHS) == 11


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_the_reference(arch, dtype):
    if _lockstep_compared(arch, dtype):
        for what, want, plain, _ in _lockstep(arch, dtype):
            np.testing.assert_allclose(plain, want, **GRADE[dtype],
                                       err_msg=what)
        return
    _compare(_torch_run(arch, dtype, False), _jax_run(arch, dtype),
             GRADE[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_route_matches_the_plain_path(arch, dtype):
    """``use_pallas=True`` (RMSNorm's plain version applies the gain in f32
    and rounds once: in bf16 up to one bf16 rounding from the model's) at
    the dtype's grade, and against the reference too."""
    if _lockstep_compared(arch, dtype):
        for what, want, plain, kernel in _lockstep(arch, dtype):
            np.testing.assert_allclose(kernel, plain, **GRADE[dtype],
                                       err_msg=what)
            np.testing.assert_allclose(kernel, want, **GRADE[dtype],
                                       err_msg=what)
        return
    got = _torch_run(arch, dtype, True)
    _compare(got, _torch_run(arch, dtype, False), GRADE[dtype])
    _compare(got, _jax_run(arch, dtype), GRADE[dtype])


def _layout(tree):
    return [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in tree]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_trees_have_the_reference_layout(arch):
    """Leaf order (one flat vector, one .npz layout), shapes and dtypes of
    ``init_model`` and ``init_cache`` against the reference's."""
    jcfg, cfg = _cfgs(arch, "bfloat16")
    params = model.init_model(torch.Generator().manual_seed(0), cfg)
    want = jax.eval_shape(lambda k: jax_model.init_model(k, jcfg),
                          jax.random.PRNGKey(0))
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(want)[0]]
    assert len(paths) == len(tree_leaves(params))
    assert _layout(tree_leaves(params)) == _layout(
        jax.tree_util.tree_leaves(want))
    cache = model.init_cache(cfg, B, S, device="cpu")
    want = jax.eval_shape(lambda: jax_model.init_cache(jcfg, B, S))
    assert _layout(tree_leaves(cache)) == _layout(
        jax.tree_util.tree_leaves(want))
    assert all(float(c.abs().sum()) == 0 for c in tree_leaves(cache))


def test_serve_steps_on_the_reference_state():
    """``make_prefill_step`` / ``make_decode_step`` return the last
    position's logits of the forward they wrap; the VLM's text logits drop
    the image positions."""
    arch = "phi-3-vision-4.2b"
    _, cfg = _cfgs(arch, "float32")
    want = _jax_run(arch, "float32")
    tok, img = _inputs(cfg)
    state = {"params": model_params_from_numpy(_params(arch, "float32")),
             "cache": cache_from_numpy(jax.tree_util.tree_map(
                 np.asarray, jax_model.init_cache(_cfgs(arch, "float32")[0],
                                                  B, S + _n_img(cfg))))}
    opts = StepOptions()
    state, logits = make_prefill_step(cfg, opts)(state, {
        "tokens": torch.from_numpy(tok[:, :S0]).long(),
        "img": torch.from_numpy(img)})
    np.testing.assert_allclose(logits.numpy(), want["steps"][0][0][:, -1],
                               **CLOSE)
    state, logits = make_decode_step(cfg, opts)(state, {
        "tokens": torch.from_numpy(tok[:, S0:S0 + 1]).long(),
        "pos": S0 + _n_img(cfg)})
    np.testing.assert_allclose(logits.numpy(), want["steps"][1][0][:, -1],
                               **CLOSE)
    text = _text_logits(cfg, torch.from_numpy(want["full"]))
    assert text.shape[1] == S


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_command_on_the_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "6", "--gen", "3",
                       "--temperature", "0.7" if "vision" in arch else "0",
                       "--seed", "1"]) == 0
    out = capsys.readouterr().out
    assert f"{arch}-smoke: prefill B=2 S=6" in out
    assert "decoded 2 steps x batch 2" in out and "on the CPU" in out


def test_serve_state_and_command_need_cuda_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "qwen2-7b", "--smoke"])
    _, cfg = _cfgs("qwen2-7b", "float32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_cache(cfg, 1, 4)
    from repro_torch.configs import InputShape
    state = init_serve_state(torch.Generator().manual_seed(0), cfg,
                             InputShape("s", 4, 1, "prefill"))
    assert state["cache"]["stack"][0]["k"].device.type == "cpu"


def test_kernel_routes_on_the_serve_path_count_no_launch_on_the_cpu():
    """On CPU tensors the kernel wrappers run their plain versions: a whole
    prefill and decode through them launches nothing."""
    from repro_torch import kernels
    kernels.reset_launch_counts()
    _torch_model_run.__wrapped__("jamba-1.5-large-398b", "float32", True)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)

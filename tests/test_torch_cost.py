"""The dry-run's cost counter (``repro_torch.launch.cost``) against the
reference's cost model (``repro.launch.hlo_cost``).

* Mirrors of the reference's seven ``step_cost`` cases
  (``tests/test_hlo_cost.py``), with its expected numbers: a Python loop
  stands where the reference's ``lax.scan`` stands, ``torch.func.grad``
  where ``jax.grad``, ``nn.modules.checkpoint`` where ``jax.checkpoint``.
* On every registered arch's smoke variant, the port's ``matmul_flops`` of
  a prefill and a decode equal the reference's dot and conv FLOPs of the
  same step, summed from its jaxpr with its own ``_dot_flops`` /
  ``_conv_flops`` (the train step: ``tests/test_torch_cost_train.py``).
* The charge rule for the kernels: a step with ``use_pallas`` counts what
  the same step with each kernel replaced by its plain version counts,
  its products what its twin without the kernels counts; each kernel's
  ``torch.library`` op, on meta or on a device's tensors, is charged its
  plain version on meta and nothing of its own; a custom op under
  ``torch.func.vmap`` counts its client route's plain version.
"""
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import DPConfig as JaxDPConfig  # noqa: E402
from repro.configs.base import InputShape as JaxInputShape  # noqa: E402
from repro.configs.base import ProxyFLConfig as JaxProxyFLConfig  # noqa: E402
from repro.configs.registry import proxy_of as jax_proxy_of  # noqa: E402
from repro.configs.registry import smoke_variant as jax_smoke  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.launch.hlo_cost import (_conv_flops, _dot_flops,  # noqa: E402
                                   _sub_jaxprs)
from repro_torch.configs import (DPConfig, InputShape,  # noqa: E402
                                 ProxyFLConfig, get_config, list_archs,
                                 proxy_of, smoke_variant)
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.cost import CostCounter, step_cost  # noqa: E402
from repro_torch.nn.modules import checkpoint, tree_size  # noqa: E402


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# the reference's seven cases (tests/test_hlo_cost.py)


def test_dot_flops_exact():
    c = step_cost(lambda a, b: a @ b, meta(64, 128), meta(128, 32))
    assert c["flops"] == pytest.approx(2 * 64 * 128 * 32, rel=0.01)
    assert c["matmul_flops"] == 2 * 64 * 128 * 32


def test_batched_dot_flops():
    c = step_cost(lambda a, b: torch.einsum("bik,bkj->bij", a, b),
                  meta(4, 8, 16), meta(4, 16, 8))
    assert c["flops"] == pytest.approx(2 * 4 * 8 * 16 * 8, rel=0.01)
    assert c["matmul_flops"] == 2 * 4 * 8 * 16 * 8


def test_loop_multiplies_body_cost():
    def f(ws, x):
        for w in ws:   # the reference's lax.scan over 10 weights
            x = x @ w
        return x

    c = step_cost(f, meta(10, 32, 32), meta(4, 32))
    one = 2 * 4 * 32 * 32
    assert c["flops"] == pytest.approx(10 * one, rel=0.05)


def test_nested_loop():
    def f(ws, x):
        for group in ws:
            for w in group:
                x = x @ w
        return x

    c = step_cost(f, meta(3, 5, 16, 16), meta(2, 16))
    assert c["flops"] == pytest.approx(15 * 2 * 2 * 16 * 16, rel=0.05)


def test_grad_counts_backward():
    def f(w):
        return torch.func.grad(lambda w: torch.sum((w @ w) ** 2))(w)

    c = step_cost(f, meta(32, 32))
    fwd = 2 * 32 ** 3
    # fwd + 2 matmuls in backward ≈ 3x forward
    assert c["flops"] >= 2.5 * fwd


def test_remat_recompute_counted():
    def body(tensors, lazy):
        c, w = tensors
        return (torch.tanh(c @ w),)

    def make(remat):
        def f(ws, x):
            def loss(ws, x):
                for w in ws:
                    x = checkpoint(body, x, w)[0] if remat \
                        else body((x, w), False)[0]
                return torch.sum(x)
            return torch.func.grad(loss, argnums=(0, 1))(ws, x)
        return f

    W, x = meta(8, 64, 64), meta(4, 64)
    base = step_cost(make(False), W, x)["flops"]
    rm = step_cost(make(True), W, x)["flops"]
    assert rm > base * 1.2  # recompute visible in the count


def test_memory_traffic_counts_major_ops():
    c = step_cost(lambda a, b: a @ b, meta(64, 128), meta(128, 32))
    want = (64 * 128 + 128 * 32 + 64 * 32) * 4
    assert c["bytes"] == pytest.approx(want, rel=0.01)


def test_views_are_free_and_reductions_count_their_input():
    c = step_cost(lambda a: a.reshape(8, 16).t().sum(0), meta(128))
    assert c == {"flops": 128.0, "bytes": 128 * 4 + 8 * 4,
                 "matmul_flops": 0.0}
    x = meta(256)
    with CostCounter(memory=True) as counter:
        y = torch.relu(x) + 1.0
        del y
        z = x.view(16, 16)
    assert counter.peak_bytes == 2 * 256 * 4   # relu's and add's outputs
    assert counter.live_bytes == 0 and z.shape == (16, 16)


# ---------------------------------------------------------------------------
# matmul FLOPs against the reference, every arch's smoke variant

B, S = 2, 32
OPTS = dict(accum=2, dp_chunk=2, kv_chunk=16, mamba_chunk=8)


def jaxpr_matmul_flops(jaxpr, mult=1.0):
    """The reference's dot and conv FLOPs of a jaxpr, trip counts
    multiplied through as its ``jaxpr_cost`` does."""
    jaxpr = getattr(jaxpr, "jaxpr", jaxpr)
    total = 0.0
    for eqn in jaxpr.eqns:
        subs = _sub_jaxprs(eqn)
        if subs:
            total += sum(jaxpr_matmul_flops(sub, mult * m)
                         for sub, m in subs)
        elif eqn.primitive.name == "dot_general":
            total += mult * _dot_flops(eqn)
        elif eqn.primitive.name == "conv_general_dilated":
            total += mult * _conv_flops(eqn)
    return total


def reference_flops(arch: str, program: str, remat: bool) -> float:
    cfg = jax_smoke(jax_get_config(arch))
    opts = jax_steps.StepOptions(remat=remat, **OPTS)
    shape = JaxInputShape("parity", S, B, program)
    batch = jax_steps.input_specs(cfg, shape)
    if program == "train":
        proxy = jax_proxy_of(cfg)
        fl = JaxProxyFLConfig(dp=JaxDPConfig(enabled=True))
        state = jax_steps.train_state_shapes(cfg, proxy, fl, opts)
        step = jax_steps.make_train_step(cfg, proxy, fl, opts)
        args = (state, batch, jax.ShapeDtypeStruct((2,), jnp.uint32))
    else:
        state = jax_steps.serve_state_shapes(cfg, shape)
        maker = jax_steps.make_prefill_step if program == "prefill" \
            else jax_steps.make_decode_step
        step, args = maker(cfg, opts), (state, batch)
    return jaxpr_matmul_flops(jax.make_jaxpr(step)(*args))


def port_cost(arch: str, program: str, remat: bool,
              use_pallas: bool = False) -> dict:
    cfg = smoke_variant(get_config(arch))
    opts = steps.StepOptions(remat=remat, **OPTS)
    shape = InputShape("parity", S, B, program)
    batch = steps.input_specs(cfg, shape)
    if program == "train":
        proxy = proxy_of(cfg)
        fl = ProxyFLConfig(dp=DPConfig(enabled=True), use_pallas=use_pallas)
        state = steps.train_state_shapes(cfg, proxy, fl, opts)
        step = steps.make_train_step(cfg, proxy, fl, opts)
        n = tree_size(state["proxy"]["params"])
        return step_cost(lambda: step(state, batch,
                                      noise=torch.randn(n, device="meta")))
    state = steps.serve_state_shapes(cfg, shape)
    maker = steps.make_prefill_step if program == "prefill" \
        else steps.make_decode_step
    if program == "decode":
        batch = dict(batch, pos=S - 1)
    return step_cost(maker(cfg, opts, use_pallas=use_pallas), state, batch)


@pytest.mark.parametrize("program", ["prefill", "decode"])
@pytest.mark.parametrize("arch", list_archs())
def test_serving_matmul_flops_equal_the_reference(arch, program):
    """Exactly, MoE (arctic, deepseek-v2, jamba) and MLA (deepseek-v2)
    included: the port's expert dispatch, capacity slots and latent
    attention run the reference's products. (The train step, remat off
    and on: ``tests/test_torch_cost_train.py``.)"""
    assert port_cost(arch, program, False)["matmul_flops"] \
        == reference_flops(arch, program, False)


def test_remat_recompute_seen_in_a_train_step():
    off = port_cost("qwen2-7b", "train", False)
    on = port_cost("qwen2-7b", "train", True)
    assert on["matmul_flops"] > off["matmul_flops"]
    assert on["flops"] > off["flops"]


# ---------------------------------------------------------------------------
# the charge rule for the kernels


def _plain_kernels(monkeypatch):
    """Each kernel the model calls replaced by its plain version."""
    import sys
    rms = sys.modules["repro_torch.kernels.rmsnorm"]
    monkeypatch.setattr(rms, "rmsnorm", lambda x, g, eps=1e-6, **_:
                        ref.rmsnorm_ref(x, g, eps))

    def attention(q, k, v, causal=True, window=None, **_):
        # the plain version's work, its output in the kernel's layout (a
        # new [B, S, H, D] tensor: an allocation, which costs nothing)
        ref.gqa_flash_attention_ref(q, k, v, causal=causal, window=window)
        return torch.empty_like(q)
    monkeypatch.setattr("repro_torch.nn.attention.gqa_flash_attention",
                        attention)

    def scan(dt, x, B_in, C_in, A, h0=None, return_state=False):
        return ref.mamba_scan_ref(dt, x, B_in, C_in, A, h0, return_state)
    monkeypatch.setattr("repro_torch.nn.mamba.mamba_scan", scan)


@pytest.mark.parametrize("arch,program", [("qwen2-7b", "prefill"),
                                          ("jamba-1.5-large-398b", "prefill"),
                                          ("gemma3-4b", "train")])
def test_kernel_calls_count_as_their_plain_versions(arch, program,
                                                    monkeypatch):
    kernels_on = port_cost(arch, program, True, use_pallas=True)
    twin = port_cost(arch, program, True, use_pallas=False)
    # the kernels' plain versions and the model's plain path do the same
    # products (attention over whole KV chunks either way at S = 32)
    assert kernels_on["matmul_flops"] == twin["matmul_flops"]
    _plain_kernels(monkeypatch)
    assert port_cost(arch, program, True, use_pallas=True) == kernels_on


def _op_calls():
    """Each kernel's custom op with small inputs, beside its plain version
    (``kernels/ref.py``) on the same inputs."""
    gen = torch.Generator().manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen)

    ops = torch.ops.repro_torch
    x, g = randn(6, 16), randn(16)
    q, k = randn(2, 8, 4, 16), randn(2, 8, 2, 16)
    dt, xs = randn(2, 8, 6).abs(), randn(2, 8, 6)
    Bm, Cm, A = randn(2, 8, 3), randn(2, 8, 3), -randn(6, 3).abs()
    scales, acc = randn(6).abs(), randn(16)
    vecs = [randn(32) for _ in range(4)] + [randn(32).abs()]   # v >= 0
    c = (torch.tensor([0.1]), torch.tensor([0.01]))
    adam = dict(stddev=0.5, n_units=4.0, lr=1e-3, weight_decay=0.01,
                b1=0.9, b2=0.999, eps=1e-8)
    return {
        "rmsnorm": ((ops.rmsnorm, x, g, 1e-6),
                    (ref.rmsnorm_ref, x, g, 1e-6)),
        "flash_attention": (
            (ops.flash_attention, q, k, k, 2, True, None, 0.25),
            (lambda *a: ref.gqa_flash_attention_ref(*a, scale=0.25),
             q, k, k)),
        "mamba_scan": ((ops.mamba_scan, dt, xs, Bm, Cm, A, None, True),
                       (ref.mamba_scan_ref, dt, xs, Bm, Cm, A, None, True)),
        "sumsq_rows": ((ops.sumsq_rows, x), (ref.sumsq_rows_ref, x)),
        "clip_accumulate_rows": ((ops.clip_accumulate_rows, x, scales),
                                 (ref.clip_accumulate_rows_ref, x, scales)),
        "scale_accumulate": ((ops.scale_accumulate, acc, g, scales[0]),
                             (ref.scale_accumulate_ref, acc, g, scales[0])),
        "noise_adam_step": (
            (ops.noise_adam_step, *vecs, *c, *adam.values()),
            (lambda *a: ref.noise_adam_step_ref(*a[:5], c1=a[5], c2=a[6],
                                                **adam), *vecs, *c)),
    }


def _on_meta(args):
    return [torch.empty_like(a, device="meta")
            if isinstance(a, torch.Tensor) else a for a in args]


@pytest.mark.parametrize("name", sorted(_build.OP_BODIES))
def test_each_kernel_op_is_charged_its_plain_version(name):
    """On meta tensors, and on a device's (here the CPU's, where the op's
    body is the plain version; on the card, a launch), a call of the op
    counts its plain version's work on meta, nothing of its own, and the
    op's own result comes back."""
    (op, *args), (plain, *plain_args) = _op_calls()[name.split("::")[1]]
    want = step_cost(plain, *_on_meta(plain_args))
    assert want["flops"] > 0
    assert step_cost(op, *_on_meta(args)) == want
    with CostCounter() as counter:
        got = op(*args)
    assert {"flops": counter.flops, "bytes": counter.bytes,
            "matmul_flops": counter.matmul_flops} == want
    for a, b in zip(_leaves_of(got), _leaves_of(plain(*plain_args))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _leaves_of(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def test_a_vmapped_custom_op_counts_its_client_route():
    from repro_torch.kernels.rmsnorm import rmsnorm

    x, g = meta(3, 5, 16), meta(3, 16)
    got = step_cost(lambda: torch.func.vmap(rmsnorm)(x, g))
    want = step_cost(ref.rmsnorm_clients_ref, meta(3, 5, 16), meta(3, 16))
    assert got == want and got["flops"] > 0
    shared = step_cost(lambda: torch.func.vmap(rmsnorm, in_dims=(0, None))(
        x, meta(16)))
    assert shared == step_cost(ref.rmsnorm_ref, meta(3, 5, 16), meta(16))


@pytest.mark.parametrize("arch", ["qwen2-7b", "jamba-1.5-large-398b"])
def test_a_step_with_launches_counts_as_on_meta(arch, monkeypatch):
    """The wrappers' CUDA branches run on CPU tensors, their launches
    stubbed out: each is charged its plain version on meta copies, and
    the step counts exactly what it counts on meta (the card's check,
    ``chip_smoke.py``'s dryrun phase, on the CPU)."""
    import dataclasses
    import sys

    from repro_torch.launch import dryrun

    # two query heads a KV head, as qwen2-7b's seven (the plain
    # attention's repeat of the KV heads included)
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), n_kv_heads=2)
    shape = InputShape("launches", 32, 2, "prefill")
    flash_attention = sys.modules["repro_torch.kernels.flash_attention"]
    on_meta = step_cost(dryrun.step_call(cfg, shape, "prefill",
                                         use_pallas=True)[0])
    call = dryrun.step_call(cfg, shape, "prefill", use_pallas=True,
                            device="cpu")[0]
    monkeypatch.setattr(_build, "plain", lambda t: t.device.type == "meta")
    monkeypatch.setattr(_build, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch", lambda *a, **k: None)
    monkeypatch.setattr(flash_attention, "check_tma", lambda *a, **k: None)
    assert step_cost(call) == on_meta


def test_a_custom_op_seen_by_the_counter_counts_its_body():
    """Inside a ``torch.func`` transform a kernel call goes through its
    ``torch.library`` op, which the counter sees (no vmap rule took it):
    it runs the op's body, the plain version on meta, under the counter
    entered again, and leaves no hook behind."""
    from repro_torch.kernels.rmsnorm import rmsnorm

    x, g = meta(5, 16), meta(16)

    def loss(kernel):
        return lambda y: torch.sum(y * kernel(x, g))

    with torch.no_grad():
        got = step_cost(lambda: torch.func.grad(loss(rmsnorm))(meta(5, 16)))
        want = step_cost(lambda: torch.func.grad(loss(ref.rmsnorm_ref))(
            meta(5, 16)))
    assert got == want


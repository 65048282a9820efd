"""The port's CUDA kernels on the card: each against its plain version (the
ops API's at the full widths of qwen2-7b, falcon-mamba-7b and the mlp
proxy; both tensor-core attention routes over ragged lengths, groups and
windows at compiled and zero-padded head dims, their narrow loaders at
unaligned head dims and on misaligned views; the sync mix at its register
bucket edges; both rmsnorm
instantiations; the DP clip pair's rows route bit
for bit against its 1-D route; the scan at falcon-mamba-7b's and
jamba-1.5-large's widths and over a sweep of state sizes and lengths, and
from a state with its final state out; noise_adam_step and noise_sgd_step
bit for bit and as one device kernel a call), the wrappers' refusals,
small federations (ProxyFL sync, and async at staleness 2 with dropout;
each of the six other fig. 3 methods) through the kernels against the
plain path on the same seed, and the smoke variant of every registered
LLM served (prefill and decode) through the kernels against the plain
path.

Every test here needs a CUDA device and skips without one. The file
imports torch and ``repro_torch`` only (no jax), so on a GPU machine
without JAX it runs with the suite's conftest left out:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import DPConfig, ProxyFLConfig  # noqa: E402
from repro_torch.core.baselines import run_federated  # noqa: E402
from repro_torch.core.protocol import ModelSpec  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402
from repro_torch.nn.vision import get_vision_model  # noqa: E402

pytestmark = pytest.mark.cuda
F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
D = 199_210   # the main path's proxy width (mlp 784-200-200-10)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _pairs(got, want):
    return zip(got if isinstance(got, tuple) else (got,),
               want if isinstance(want, tuple) else (want,))


@pytest.mark.parametrize("name", sorted(kernels.KERNELS))
def test_kernel_matches_plain_at_main_shape(gen, name):
    x = torch.randn(D, generator=gen, device="cuda")
    t = torch.full((), 3.0, device="cuda")
    tol = F32
    if name == "noise_sgd_step":
        hp = dict(stddev=1.0, n_units=250, lr=1e-3, weight_decay=1e-4)
        got = kernels.noise_sgd_step(x, x.flip(0), x.roll(1), **hp)
        want = ref.noise_sgd_step_ref(x, x.flip(0), x.roll(1), **hp)
    elif name == "rmsnorm":   # qwen2-7b: d_model 3,584 over 4,096 rows
        xs = torch.randn((4_096, 3_584), generator=gen,
                         device="cuda").bfloat16()
        g = torch.randn(3_584, generator=gen, device="cuda").bfloat16()
        got, want, tol = kernels.rmsnorm(xs, g), ref.rmsnorm_ref(xs, g), BF16
    elif name == "flash_attention":   # qwen2-7b: 28 query, 4 KV heads
        q = torch.randn((1, 4_096, 28, 128), generator=gen,
                        device="cuda").bfloat16()
        k, v = (torch.randn((1, 4_096, 4, 128), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        got = kernels.gqa_flash_attention(q, k, v)
        want = ref.gqa_flash_attention_ref(q, k, v)
        tol = BF16
    elif name == "mamba_scan":   # falcon-mamba-7b: di 8,192, ds 16
        shape = (1, 4_096, 8_192)
        dt = torch.nn.functional.softplus(
            torch.randn(shape, generator=gen, device="cuda"))
        xs = torch.randn(shape, generator=gen, device="cuda")
        Bm, C = (torch.randn((1, 4_096, 16), generator=gen, device="cuda")
                 for _ in range(2))
        A = -torch.exp(torch.randn((8_192, 16), generator=gen,
                                   device="cuda"))
        got = kernels.mamba_scan(dt, xs, Bm, C, A)
        want = ref.mamba_scan_ref(dt, xs, Bm, C, A)
        tol = dict(rtol=2e-4, atol=2e-4)   # tests/test_kernels.py's
    elif name == "sumsq":
        got, want = kernels.sumsq(x), ref.sumsq_ref(x)
    elif name == "scale_accumulate":
        s = torch.rand((), generator=gen, device="cuda")
        got = kernels.scale_accumulate(x, x.flip(0), s)
        want = ref.scale_accumulate_ref(x, x.flip(0), s)
    elif name == "noise_adam_step":
        hp = dict(stddev=1.0, n_units=250, lr=1e-3, weight_decay=1e-4,
                  c1=1 - 0.9 ** t, c2=1 - 0.999 ** t)
        args = (x, x.flip(0), x.roll(1), x.roll(2), x.abs())
        got = kernels.noise_adam_step(*args, **hp)
        want = ref.noise_adam_step_ref(*args, **hp)
    else:
        P = torch.rand((8, 8), generator=gen, device="cuda")
        P = P / P.sum(0, keepdim=True)
        flat = torch.randn((8, D), generator=gen, device="cuda")
        w = torch.rand(8, generator=gen, device="cuda") + 0.5
        if name == "fused_pushsum_mix":
            got = kernels.fused_pushsum_mix(flat, w, P)
            want = ref.fused_pushsum_mix_ref(flat, w, P)
        elif name == "fused_pushsum_mix_blocks":   # hier: 2 shards of 4
            blocks = torch.rand((2, 4, 4), generator=gen, device="cuda")
            got = kernels.fused_pushsum_mix_blocks(flat, w, blocks)
            want = ref.fused_pushsum_mix_blocks_ref(flat, w, blocks)
        else:
            assert name == "fused_stale_mix", name
            kept = torch.diagonal(P).contiguous()
            args = (flat, w, kept, P - torch.diag(kept), 0.1 * flat.flip(0),
                    0.5 * torch.rand(8, generator=gen, device="cuda"))
            got = kernels.fused_stale_mix(*args)
            want = ref.fused_stale_mix_ref(*args)
    torch.cuda.synchronize()
    for g, w_ in _pairs(got, want):
        torch.testing.assert_close(g, w_, **tol)


@pytest.mark.parametrize("name", ["noise_sgd_step", "rmsnorm",
                                  "flash_attention", "gqa_flash_attention",
                                  "mamba_scan"])
def test_ops_api_raises_instead_of_falling_back(gen, name):
    """Each op given CUDA tensors its kernel does not take raises (no plain
    version, no emulator)."""
    x = torch.randn(64, generator=gen, device="cuda")
    kernels.reset_launch_counts()
    with pytest.raises((TypeError, ValueError)):
        if name == "noise_sgd_step":
            kernels.noise_sgd_step(x, x, x.double(), stddev=1.0, n_units=2,
                                   lr=0.1)
        elif name == "rmsnorm":
            kernels.rmsnorm(x.reshape(8, 8).t(), x[:8])   # not contiguous
        elif name == "flash_attention":
            q = torch.randn((1, 1, 4, 512), generator=gen, device="cuda")
            kernels.flash_attention(q, q, q)   # D = 512 > 256
        elif name == "gqa_flash_attention":
            q = x.reshape(1, 4, 4, 4)
            kernels.gqa_flash_attention(q, q[:, :, :3].contiguous(),
                                        q[:, :, :3].contiguous())
        else:
            y = x.reshape(1, 8, 8)
            kernels.mamba_scan(y, y, y, y, x.reshape(8, 8).double())
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


@pytest.mark.parametrize("G", [1, 2, 7])
@pytest.mark.parametrize("D", [64, 128, 256, 40, 96, 136])
def test_wgmma_attention_matches_plain(gen, D, G):
    """bf16 at the wgmma route's compiled head dims and at aligned ones
    zero-padded up to them (40 onto 64, 96 onto 128, 136 onto 256, where a
    64-column block lies wholly past D), over lengths around its tiles,
    causal and not, windows {None, 1, 17, 64, 0}, B = 2 and two KV heads
    (group 1 through the [B, H, S, D] entry point); a causal window of 0
    masks every key and gives exactly 0."""
    for S in (1, 63, 64, 65, 127, 129, 257):
        q = torch.randn((2, S, 2 * G, D), generator=gen,
                        device="cuda").bfloat16()
        k, v = (torch.randn((2, S, 2, D), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        if G == 1:
            q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            kern, plain = kernels.flash_attention, ref.flash_attention_ref
        else:
            kern = kernels.gqa_flash_attention
            plain = ref.gqa_flash_attention_ref
        for causal in (True, False):
            for window in (None, 1, 17, 64, 0):
                got = kern(q, k, v, causal=causal, window=window)
                want = plain(q, k, v, causal=causal, window=window)
                torch.testing.assert_close(got, want, **BF16)
                if causal and window == 0:
                    assert bool((got == 0).all())


def _misaligned(t, off):
    """A copy of t whose base lies ``off`` elements past a 16-byte
    boundary."""
    es = t.element_size()
    flat = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    base = (-(flat.data_ptr() // es)) % (16 // es)
    return flat[base + off:base + off + t.numel()].view(t.shape).copy_(t)


def test_wgmma_route_refuses_misaligned_views(gen):
    """The TMA loader refuses a view 2 bytes off 16 (check_tma raises);
    both entry points run it on the narrow loader instead, and agree with
    the plain version."""
    from repro_torch.kernels.flash_attention import check_tma
    x = torch.randn((1, 2, 4, 64), generator=gen, device="cuda").bfloat16()
    off = _misaligned(x, 1)   # 2 bytes off 16
    with pytest.raises(ValueError, match="aligned"):
        check_tma("t", off)
    kernels.reset_launch_counts()
    torch.testing.assert_close(kernels.flash_attention(off, off, off),
                               ref.flash_attention_ref(x, x, x), **BF16)
    torch.testing.assert_close(kernels.gqa_flash_attention(off, off, off),
                               ref.gqa_flash_attention_ref(x, x, x), **BF16)
    routes = kernels.route_launch_counts()
    assert routes["flash_attention/wgmma/narrow"] == 2
    assert routes["flash_attention/wgmma"] == 0


@pytest.mark.parametrize("G", [1, 2, 7])
@pytest.mark.parametrize("D", [64, 96, 128, 256, 40, 72, 136])
def test_tf32x3_attention_matches_plain(gen, D, G):
    """f32 at the split-TF32 route's compiled head dims and at aligned ones
    zero-padded up to them (40 onto 64, 72 onto 96, 136 onto 256), over
    lengths around its
    128-row and 64-key (16 at D = 256) tiles, causal and not, windows
    {None, 1, 17, 64, 0}, B = 2 and two KV heads (group 1 through the
    [B, H, S, D] entry point), at the f32 tolerance; every call takes the
    tf32x3 kernel, and a causal window of 0 gives exactly 0."""
    kernels.reset_launch_counts()
    n = 0
    for S in (1, 15, 16, 17, 63, 64, 65, 127, 129, 257):
        q = torch.randn((2, S, 2 * G, D), generator=gen, device="cuda")
        k, v = (torch.randn((2, S, 2, D), generator=gen, device="cuda")
                for _ in range(2))
        if G == 1:
            q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            kern, plain = kernels.flash_attention, ref.flash_attention_ref
        else:
            kern = kernels.gqa_flash_attention
            plain = ref.gqa_flash_attention_ref
        for causal in (True, False):
            for window in (None, 1, 17, 64, 0):
                got = kern(q, k, v, causal=causal, window=window)
                want = plain(q, k, v, causal=causal, window=window)
                torch.testing.assert_close(got, want, **F32)
                if causal and window == 0:
                    assert bool((got == 0).all())
                n += 1
    assert kernels.route_launch_counts()["flash_attention/tf32x3"] == n


def test_tf32x3_route_refuses_misaligned_views(gen):
    """The 16-byte loader refuses a view 4 bytes off 16 (check_tma
    raises); both entry points run it on the narrow loader instead, and
    agree with the plain version."""
    from repro_torch.kernels.flash_attention import check_tma
    x = torch.randn((1, 2, 4, 64), generator=gen, device="cuda")
    off = _misaligned(x, 1)   # 4 bytes off 16
    with pytest.raises(ValueError, match="aligned"):
        check_tma("t", off)
    kernels.reset_launch_counts()
    torch.testing.assert_close(kernels.flash_attention(off, off, off),
                               ref.flash_attention_ref(x, x, x), **F32)
    torch.testing.assert_close(kernels.gqa_flash_attention(off, off, off),
                               ref.gqa_flash_attention_ref(x, x, x), **F32)
    routes = kernels.route_launch_counts()
    assert routes["flash_attention/tf32x3/narrow"] == 2
    assert routes["flash_attention/tf32x3"] == 0


@pytest.mark.parametrize("dtype,off", [
    (torch.bfloat16, 1), (torch.bfloat16, 2), (torch.bfloat16, 4),
    (torch.float32, 1), (torch.float32, 2), (torch.float32, 3)])
def test_misaligned_views_run_on_the_narrow_loader(gen, dtype, off):
    """q, k and v each ``off`` elements past 16 bytes at D = 64 (copy
    widths 2, 4 and 8 bytes in bf16; 4, 8 and 4 in f32), S = 129, groups 1
    and 2, causal and windowed: every call on the narrow loader, each
    against the plain version."""
    tol = BF16 if dtype == torch.bfloat16 else F32
    route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    kernels.reset_launch_counts()
    n = 0
    for G in (1, 2):
        q = torch.randn((1, 129, 2 * G, 64), generator=gen,
                        device="cuda").to(dtype)
        k, v = (torch.randn((1, 129, 2, 64), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        if G == 1:
            q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            kern, plain = kernels.flash_attention, ref.flash_attention_ref
        else:
            kern = kernels.gqa_flash_attention
            plain = ref.gqa_flash_attention_ref
        views = [_misaligned(t, off) for t in (q, k, v)]
        for causal, window in ((True, None), (False, 17)):
            torch.testing.assert_close(
                kern(*views, causal=causal, window=window),
                plain(q, k, v, causal=causal, window=window), **tol)
            n += 1
    routes = kernels.route_launch_counts()
    assert routes[f"flash_attention/{route}/narrow"] == n
    assert routes[f"flash_attention/{route}"] == 0


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 36),
                                     (torch.bfloat16, 100),
                                     (torch.float32, 30), (torch.float32, 98)])
def test_cuda_core_attention_at_unaligned_head_dims(gen, dtype, D):
    """Head dims whose rows are not whole 16 bytes, which a CUDA-core
    kernel took until the narrow loaders: every call of both entry points
    takes its tensor-core kernel's narrow loader and agrees with the plain
    version."""
    tol = BF16 if dtype == torch.bfloat16 else F32
    kernels.reset_launch_counts()
    n = 0
    for S, G in ((1, 1), (65, 2), (129, 1), (257, 7)):
        q = torch.randn((2, S, 2 * G, D), generator=gen,
                        device="cuda").to(dtype)
        k, v = (torch.randn((2, S, 2, D), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        if G == 1:
            q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            kern, plain = kernels.flash_attention, ref.flash_attention_ref
        else:
            kern = kernels.gqa_flash_attention
            plain = ref.gqa_flash_attention_ref
        for causal, window in ((True, None), (False, None), (True, 17),
                               (False, 64)):
            got = kern(q, k, v, causal=causal, window=window)
            torch.testing.assert_close(
                got, plain(q, k, v, causal=causal, window=window), **tol)
            n += 1
    routes = kernels.route_launch_counts()
    route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    assert routes[f"flash_attention/{route}/narrow"] == n
    assert routes["flash_attention/wgmma"] == routes[
        "flash_attention/tf32x3"] == 0


@pytest.mark.parametrize("dtype,rows,d,off,route", [
    (torch.bfloat16, 4_096, 3_584, 0, "vector"),
    (torch.float32, 4_096, 3_584, 0, "vector"),
    (torch.bfloat16, 300, 33, 0, "scalar"),
    (torch.bfloat16, 64, 3_584, 1, "scalar"),
    (torch.float32, 3, 40_000, 0, "vector"),
    (torch.bfloat16, 3, 9_001, 0, "scalar")])
def test_rmsnorm_instantiations_match_plain_and_repeat_exactly(
        gen, dtype, rows, d, off, route):
    """Both instantiations (16-byte vectors; one element an access, for a
    row that is not whole 16 bytes or a view one element off), rows held in
    registers and rows past them (re-read), against the plain version at
    the dtype's tolerance; two calls give the same bits (a fixed-order
    reduction, no atomics)."""
    x = torch.randn(rows * d + off, generator=gen, device="cuda").to(dtype)
    x = x[off:].view(rows, d)
    g = torch.randn(d, generator=gen, device="cuda").to(dtype)
    kernels.reset_launch_counts()
    a, b = kernels.rmsnorm(x, g), kernels.rmsnorm(x, g)
    torch.cuda.synchronize()
    assert kernels.route_launch_counts()[f"rmsnorm/{route}"] == 2
    torch.testing.assert_close(a, ref.rmsnorm_ref(x, g),
                               **(BF16 if dtype == torch.bfloat16 else F32))
    assert torch.equal(a, b)


def _mix_args(gen, K, D, dtype, off=0):
    P = torch.rand((K, K), generator=gen, device="cuda")
    P = P / P.sum(0, keepdim=True)
    w = torch.rand(K, generator=gen, device="cuda") + 0.5
    flat = torch.randn(K * D + off, generator=gen, device="cuda").to(dtype)
    return flat[off:].view(K, D), w, P


@pytest.mark.parametrize("K", [8, 9, 16, 17, 32, 33])
def test_pushsum_mix_at_the_register_bucket_edges(gen, K):
    """K = 8, 9, 16, 17, 32 and 33 cross the 8-, 16- and 32-wide register
    buckets and the streaming kernel above; D = 1 and 65,537 take single
    columns, 1,000 four at a time at K = 8, two at 9 and 16 and one at 17
    and 32; then rows one element off 16 bytes (single columns); de-biased
    and not, both dtypes."""
    for D_, off in ((1, 0), (1_000, 0), (65_537, 0), (1_000, 1)):
        for dtype, tol in ((torch.float32, F32), (torch.bfloat16, BF16)):
            flat, w, P = _mix_args(gen, K, D_, dtype, off)
            for debias in (True, False):
                got = kernels.fused_pushsum_mix(flat, w, P, debias=debias)
                want = ref.fused_pushsum_mix_ref(flat, w, P, debias=debias)
                for g, w_ in _pairs(got, want):
                    torch.testing.assert_close(g, w_, **tol)


def _stale_args(gen, K, D, dtype):
    P = torch.rand((K, K), generator=gen, device="cuda") * 0.9 + 0.1
    P = P / P.sum(0, keepdim=True)
    kept = torch.diagonal(P).contiguous()
    w = torch.rand(K, generator=gen, device="cuda") * 1.7 + 0.3
    return (torch.randn((K, D), generator=gen, device="cuda").to(dtype),
            w.to(dtype), kept, P - torch.diag(kept),
            (0.1 * torch.randn((K, D), generator=gen,
                               device="cuda")).to(dtype),
            (0.5 * torch.rand(K, generator=gen, device="cuda")).to(dtype))


@pytest.mark.parametrize("K", [16, 17, 32])
def test_stale_mix_at_the_register_bucket_edges(gen, K):
    """K = 16, 17 and 32 cross the 16- and 32-wide register buckets; odd
    D takes single columns, even D column pairs; z' stays bit-equal in
    f32."""
    for D_ in (1, 1_000, 65_537):
        for dtype, tol in ((torch.float32, F32), (torch.bfloat16, BF16)):
            args = _stale_args(gen, K, D_, dtype)
            got = kernels.fused_stale_mix(*args)
            want = ref.fused_stale_mix_ref(*args)
            for g, w_ in _pairs(got, want):
                torch.testing.assert_close(g, w_, **tol)
            if dtype == torch.float32:
                assert torch.equal(got[0], want[0])


def test_stale_mix_z_is_bit_equal_at_main_shape(gen):
    args = _stale_args(gen, 8, D, torch.float32)
    kernels.reset_launch_counts()
    z, send, *_ = kernels.fused_stale_mix(*args)
    assert kernels.launch_counts()["fused_stale_mix"] == 1
    z_ref, send_ref, *_ = ref.fused_stale_mix_ref(*args)
    assert torch.equal(z, z_ref)
    torch.testing.assert_close(send, send_ref, **F32)


def test_wrappers_raise_instead_of_falling_back(gen):
    x = torch.randn(64, generator=gen, device="cuda")
    with pytest.raises(TypeError):
        kernels.sumsq(x.double())
    with pytest.raises(ValueError):
        kernels.scale_accumulate(x[::2], x[::2].contiguous(),
                                 torch.ones((), device="cuda"))
    with pytest.raises(ValueError):
        kernels.sumsq(x[:1].expand(4))   # stride 0: not contiguous


def _scan_inputs(gen, B, S, di, ds):
    """dt = softplus(N(0, 1)), x, B, C ~ N(0, 1), A = −exp(N(0, 1)) on the
    card, as tests/test_kernels.py draws them."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    return (torch.nn.functional.softplus(randn(B, S, di)), randn(B, S, di),
            randn(B, S, ds), randn(B, S, ds), -torch.exp(randn(di, ds)))


SCAN = dict(rtol=2e-4, atol=2e-4)   # tests/test_kernels.py's


@pytest.mark.parametrize("di", [8_192, 16_384])
def test_scan_matches_plain_at_model_widths(gen, di):
    """falcon-mamba-7b (di 8,192) and jamba-1.5-large (di 16,384), ds 16,
    S 4,096, f32: one launch each, within the scan's tolerance."""
    args = _scan_inputs(gen, 1, 4_096, di, 16)
    kernels.reset_launch_counts()
    got = kernels.mamba_scan(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["mamba_scan"] == 1
    torch.testing.assert_close(got, ref.mamba_scan_ref(*args), **SCAN)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("ds", [1, 3, 8, 16, 17, 32, 64])
def test_scan_sweep_matches_plain(gen, ds, bf16):
    """State sizes around the lane and state buckets, lengths around the
    32-step chunks, batch 1 and 3, di = 96 + ds (rows aligned to 16 bytes
    or not), in f32 and with dt, B and C in bf16 (y in x's f32), within the
    scan's tolerance."""
    for S in (1, 31, 33, 4_097):
        for B in (1, 3):
            dt, x, Bm, C, A = _scan_inputs(gen, B, S, 96 + ds, ds)
            if bf16:
                dt, Bm, C = (t.bfloat16() for t in (dt, Bm, C))
            got = kernels.mamba_scan(dt, x, Bm, C, A)
            assert got.dtype == torch.float32
            torch.testing.assert_close(
                got, ref.mamba_scan_ref(dt, x, Bm, C, A), **SCAN)


def _adam_vectors(gen, n, off):
    """acc, noise, p, m ~ N(0, 1) and v ~ U(0, 1), each starting ``off``
    elements past a 16-byte boundary."""
    def vec(draw):
        return draw(n + 4, generator=gen, device="cuda")[off:off + n]
    return [vec(torch.randn) for _ in range(4)] + [vec(torch.rand)]


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 65_537, D])
def test_noise_adam_step_is_bit_equal_to_plain(gen, n, off):
    """Every element the plain version's arithmetic bit for bit, at four
    columns a thread (aligned) and at one (every vector one element off 16
    bytes), with the tail past the last group of four: against the plain
    version with n_units a device tensor, so that it divides (with a host
    scalar PyTorch's CUDA division multiplies by the scalar's f32
    reciprocal instead: within the f32 tolerance)."""
    t = torch.full((), 3.0, device="cuda")
    hp = dict(stddev=1.0, n_units=250, lr=1e-3, weight_decay=1e-4,
              c1=1 - 0.9 ** t, c2=1 - 0.999 ** t)
    vecs = _adam_vectors(gen, n, off)
    got = kernels.noise_adam_step(*vecs, **hp)
    dividing = ref.noise_adam_step_ref(
        *vecs, **dict(hp, n_units=torch.full((), 250.0, device="cuda")))
    assert all(torch.equal(g, w) for g, w in zip(got, dividing))
    for g, w in zip(got, ref.noise_adam_step_ref(*vecs, **hp)):
        torch.testing.assert_close(g, w, **F32)


def test_noise_adam_step_is_one_device_kernel(gen):
    """One wrapper call runs exactly one device kernel (no scalar vector
    assembled on the device), by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t = torch.full((), 3.0, device="cuda")
    hp = dict(stddev=1.0, n_units=250, lr=1e-3, weight_decay=1e-4,
              c1=1 - 0.9 ** t, c2=1 - 0.999 ** t)
    vecs = _adam_vectors(gen, D, 0)
    kernels.noise_adam_step(*vecs, **hp)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        kernels.noise_adam_step(*vecs, **hp)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "noise_adam" in names[0], names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 65_537, D])
def test_noise_sgd_step_is_bit_equal_to_plain(gen, n, off, dtype):
    """Every element the plain version's arithmetic bit for bit, p f32 and
    bf16, at four columns a thread (aligned) and at one (every vector one
    element off), with the tail past the last group of four: against the
    plain version with n_units a device tensor (with a host scalar PyTorch's
    CUDA division multiplies by the scalar's f32 reciprocal: within the
    tolerance of p's dtype)."""
    hp = dict(stddev=1.0, n_units=250, lr=1e-3, weight_decay=1e-4)
    acc, noise = (torch.randn(n + 4, generator=gen, device="cuda")[off:off + n]
                  for _ in range(2))
    p = torch.randn(n + 4, generator=gen, device="cuda").to(dtype)[off:off + n]
    got = kernels.noise_sgd_step(acc, noise, p, **hp)
    assert torch.equal(got, ref.noise_sgd_step_ref(
        acc, noise, p, **dict(hp, n_units=torch.full((), 250.0,
                                                     device="cuda"))))
    torch.testing.assert_close(got, ref.noise_sgd_step_ref(acc, noise, p,
                                                           **hp),
                               **(F32 if dtype == torch.float32 else BF16))


def test_noise_sgd_step_is_one_device_kernel(gen):
    """One wrapper call runs exactly one device kernel (its scalars go by
    value), by torch.profiler: the second of two calls in one session, the
    first its warm-up step (a session's first kernels can go unrecorded
    on the card)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    hp = dict(stddev=1.0, n_units=250, lr=1e-3, weight_decay=1e-4)
    acc, noise, p = (torch.randn(D, generator=gen, device="cuda")
                     for _ in range(3))
    recorded = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda pr: recorded.update(
                     events=pr.events())) as prof:
        for _ in range(2):
            kernels.noise_sgd_step(acc, noise, p, **hp)
            torch.cuda.synchronize()
            prof.step()
    names = [e.name for e in recorded["events"]
             if e.device_type == DeviceType.CUDA
             and not e.name.startswith("ProfilerStep")]
    assert len(names) == 1 and "noise_sgd" in names[0], names


def _padded_rows(gen, B, n, dtype):
    """[B, n] view of a buffer whose row stride is padded to 128 bytes, as
    the DP path lays out its per-example gradients."""
    per_line = 128 // torch.tensor([], dtype=dtype).element_size()
    buf = torch.randn((B, -(-n // per_line) * per_line), generator=gen,
                      device="cuda").to(dtype)
    return buf[:, :n]


@pytest.mark.parametrize("B,n,dtype", [(250, D, torch.float32)] + [
    (B, n, dtype) for B in (1, 3, 257) for n in (1, 1_023, 1_025)
    for dtype in (torch.float32, torch.bfloat16)])
def test_clip_rows_are_bit_equal_to_the_vector_loop(gen, B, n, dtype):
    """sumsq_rows equals sumsq row by row, and clip_accumulate_rows equals B
    chained scale_accumulate calls from 0, bit for bit; both within the
    dtype's tolerance of their plain versions."""
    x = _padded_rows(gen, B, n, dtype)
    kernels.reset_launch_counts()
    norms2 = kernels.sumsq_rows(x)
    scales = 1.0 / torch.clamp(torch.sqrt(norms2) / 1.0, min=1.0)
    acc = kernels.clip_accumulate_rows(x, scales)
    torch.cuda.synchronize()
    assert kernels.route_launch_counts()["sumsq/rows"] == 1
    assert kernels.route_launch_counts()["scale_accumulate/rows"] == 1
    loop_norms = torch.stack([kernels.sumsq(x[i]) for i in range(B)])
    loop_acc = torch.zeros(n, device="cuda")
    for i in range(B):
        loop_acc = kernels.scale_accumulate(loop_acc, x[i], scales[i])
    assert torch.equal(norms2, loop_norms)
    assert torch.equal(acc, loop_acc)
    tol = BF16 if dtype == torch.bfloat16 else F32
    torch.testing.assert_close(norms2, ref.sumsq_rows_ref(x), **tol)
    torch.testing.assert_close(acc, ref.clip_accumulate_rows_ref(x, scales),
                               **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_clip_rows_take_unpadded_views_bit_for_bit(gen, dtype):
    """Unpadded rows of 199,210 elements (odd rows 8 or 4 bytes off a
    16-byte boundary) and a base one element off give the same bits as
    the 1-D loop: the rows kernels need no alignment."""
    for x in (torch.randn((3, D), generator=gen, device="cuda").to(dtype),
              _padded_rows(gen, 3, D + 1, dtype)[:, 1:]):
        s = torch.rand(3, generator=gen, device="cuda")
        assert torch.equal(kernels.sumsq_rows(x),
                           torch.stack([kernels.sumsq(r) for r in x]))
        loop = torch.zeros(D, device="cuda")
        for i in range(3):
            loop = kernels.scale_accumulate(loop, x[i], s[i])
        assert torch.equal(kernels.clip_accumulate_rows(x, s), loop)


def test_clip_rows_refuse_host_scales_and_launch_nothing(gen):
    x = _padded_rows(gen, 3, D, torch.float32)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError):   # scales on the host
        kernels.clip_accumulate_rows(x, torch.ones(3))
    with pytest.raises(ValueError):   # one scale short
        kernels.clip_accumulate_rows(x, torch.ones(2, device="cuda"))
    with pytest.raises(ValueError):   # columns not unit-stride
        kernels.sumsq_rows(x[:, ::2])
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    assert not any(kernels.route_launch_counts().values())


def test_small_federation_through_every_kernel(gen):
    vm = get_vision_model("mlp")
    shape = (6, 6, 1)
    spec = ModelSpec("mlp", lambda g: vm.init(g, shape, 4), vm.apply)
    data = [(torch.randn((40,) + shape, generator=gen, device="cuda"),
             torch.randint(0, 4, (40,), generator=gen, device="cuda"))
            for _ in range(3)]
    cfg = ProxyFLConfig(n_clients=3, rounds=2, batch_size=10,
                        use_pallas=True, dp=DPConfig(enabled=True))
    kernels.reset_launch_counts()
    fused = run_federated("proxyfl", [spec] * 3, spec, data, data[0], cfg)
    steps = cfg.rounds * 3 * (40 // cfg.batch_size)
    # one launch of each clip kernel per DP step, on the rows route
    assert kernels.launch_counts() == dict(
        dict.fromkeys(kernels.KERNELS, 0), sumsq=steps,
        scale_accumulate=steps, noise_adam_step=steps,
        fused_pushsum_mix=cfg.rounds)
    routes = kernels.route_launch_counts()
    assert (routes["sumsq/rows"], routes["scale_accumulate/rows"],
            routes["sumsq/vector"], routes["scale_accumulate/vector"]) == (
                steps, steps, 0, 0)
    plain = run_federated("proxyfl", [spec] * 3, spec, data, data[0], cfg,
                          use_pallas=False)
    for a, b in zip(fused["clients"], plain["clients"]):
        for role in ("private_params", "proxy_params"):
            for x, y in zip(tree_leaves(getattr(a, role)),
                            tree_leaves(getattr(b, role))):
                torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-4)
    assert fused["epsilon"] == plain["epsilon"]


def test_small_async_federation_through_the_stale_kernel(gen):
    vm = get_vision_model("mlp")
    shape = (6, 6, 1)
    spec = ModelSpec("mlp", lambda g: vm.init(g, shape, 4), vm.apply)
    data = [(torch.randn((40,) + shape, generator=gen, device="cuda"),
             torch.randint(0, 4, (40,), generator=gen, device="cuda"))
            for _ in range(3)]
    cfg = ProxyFLConfig(n_clients=3, rounds=4, batch_size=10, local_steps=1,
                        staleness=2, dropout_rate=0.25, use_pallas=True,
                        dp=DPConfig(enabled=False))
    kernels.reset_launch_counts()
    fused = run_federated("proxyfl", [spec] * 3, spec, data, data[0], cfg,
                          backend="async")
    assert kernels.launch_counts() == dict(
        dict.fromkeys(kernels.KERNELS, 0), fused_stale_mix=cfg.rounds)
    plain = run_federated("proxyfl", [spec] * 3, spec, data, data[0], cfg,
                          backend="async", use_pallas=False)
    for a, b in zip(fused["clients"], plain["clients"]):
        assert abs(a.w - b.w) <= 1e-5 + 1e-4 * abs(b.w)
        for x, y in zip(tree_leaves(a.proxy_params),
                        tree_leaves(b.proxy_params)):
            torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("method", ["fml", "fedavg", "avgpush", "cwt",
                                    "regular", "joint"])
def test_small_federation_of_each_other_method(gen, method):
    """Two rounds of each of the six other fig. 3 methods through the
    kernels against the plain path on the same seed: one launch of each
    clip kernel (rows route) and of Adam per DP step, one mix a round
    where the method exchanges, none where it does not."""
    vm = get_vision_model("mlp")
    shape = (6, 6, 1)
    spec = ModelSpec("mlp", lambda g: vm.init(g, shape, 4), vm.apply)
    data = [(torch.randn((40,) + shape, generator=gen, device="cuda"),
             torch.randint(0, 4, (40,), generator=gen, device="cuda"))
            for _ in range(3)]
    cfg = ProxyFLConfig(n_clients=3, rounds=2, batch_size=10,
                        use_pallas=True, dp=DPConfig(enabled=True))
    kernels.reset_launch_counts()
    fused = run_federated(method, [spec] * 3, spec, data, data[0], cfg)
    steps = cfg.rounds * 3 * (40 // cfg.batch_size)
    mixes = 0 if method in ("regular", "joint") else cfg.rounds
    assert kernels.launch_counts() == dict(
        dict.fromkeys(kernels.KERNELS, 0), sumsq=steps,
        scale_accumulate=steps, noise_adam_step=steps,
        fused_pushsum_mix=mixes)
    routes = kernels.route_launch_counts()
    assert (routes["sumsq/rows"], routes["scale_accumulate/rows"]) == (
        steps, steps)
    plain = run_federated(method, [spec] * 3, spec, data, data[0], cfg,
                          use_pallas=False)
    roles = (("private_params", "proxy_params") if method == "fml"
             else ("params",))
    for a, b in zip(fused["clients"], plain["clients"]):
        for role in roles:
            for x, y in zip(tree_leaves(getattr(a, role)),
                            tree_leaves(getattr(b, role))):
                torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-4)
    assert fused["epsilon"] == plain["epsilon"]


@pytest.mark.parametrize("B,S", [(2, 300), (4, 1_024)])
def test_scan_final_state_matches_plain(gen, B, S):
    """The scan as a mamba prefill runs it: from the cache's state h0 with
    the final state out (falcon-mamba-7b's di 8,192, ds 16, f32), y and
    the state within the scan's tolerance of the plain version; y bit for
    bit the same whether or not the state is asked for, from zero."""
    dt, x, Bm, C, A = _scan_inputs(gen, B, S, 8_192, 16)
    h0 = torch.randn((B, 8_192, 16), generator=gen, device="cuda")
    kernels.reset_launch_counts()
    got = kernels.mamba_scan(dt, x, Bm, C, A, h0=h0, return_state=True)
    assert kernels.launch_counts()["mamba_scan"] == 1
    want = ref.mamba_scan_ref(dt, x, Bm, C, A, h0, return_state=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **SCAN)
    y, h = kernels.mamba_scan(dt, x, Bm, C, A, return_state=True)
    assert torch.equal(y, kernels.mamba_scan(dt, x, Bm, C, A))
    torch.testing.assert_close(h, ref.mamba_scan_ref(
        dt, x, Bm, C, A, return_state=True)[1], **SCAN)


@pytest.mark.parametrize("arch", [
    "arctic-480b", "deepseek-v2-236b", "falcon-mamba-7b", "gemma3-4b",
    "jamba-1.5-large-398b", "musicgen-medium", "phi-3-vision-4.2b",
    "qwen1.5-110b", "qwen1.5-4b", "qwen2-7b", "qwen2-7b-swa"])
def test_smoke_model_serves_through_the_kernels(gen, arch):
    """The smoke variant in f32 (dropless MoE): a prefill and two decode
    steps with the kernels launch RMSNorm, attention and the scan where
    the model has them, and give the plain path's logits and caches at
    the f32 kernel grade."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.nn.model import forward, init_cache, init_model
    cfg = smoke_variant(get_config(arch)).with_(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    params = init_model(gen, cfg)
    shape = (2, 9, cfg.n_codebooks) if cfg.modality == "audio" else (2, 9)
    tokens = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                           device="cuda")
    img = torch.randn((2, cfg.n_image_tokens, cfg.frontend_dim),
                      generator=gen, device="cuda") \
        if cfg.modality == "vlm" else None
    n_img = cfg.n_image_tokens if cfg.modality == "vlm" else 0
    runs = []
    for use_pallas in (True, False):
        kernels.reset_launch_counts()
        cache = init_cache(cfg, 2, 9 + n_img)
        logits = [forward(params, cfg, tokens[:, :7], img, cache=cache,
                          use_pallas=use_pallas)[0]]
        for i in (7, 8):
            logits.append(forward(params, cfg, tokens[:, i:i + 1],
                                  cache=cache, pos_offset=i + n_img,
                                  use_pallas=use_pallas)[0])
        runs.append((logits, tree_leaves(cache),
                     dict(kernels.launch_counts())))
    (got, got_cache, counts), (want, want_cache, plain_counts) = runs
    assert sum(plain_counts.values()) == 0
    assert counts["rmsnorm"] > 0
    kinds = {s.kind for s in cfg.layout()}
    assert (counts["mamba_scan"] > 0) == ("mamba" in kinds)
    assert (counts["flash_attention"] > 0) == (
        "attn" in kinds and cfg.attn_impl != "mla")
    for g, w in zip(got + got_cache, want + want_cache):
        torch.testing.assert_close(g, w, **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,D", [(2, 4, 199_210), (8, 8, 199_210),
                                   (2, 9, 1_001), (2, 33, 4_097)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocks_kernel_is_s_flat_launches_on_the_card(n, L, D, dtype):
    """The hier exchange's shard-grid mix (one launch) equals S launches of
    the flat kernel on the shards' rows bit for bit, and its plain version
    within the kernel tolerance; across the register buckets' edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flat = torch.randn((n * L, D), generator=gen, device="cuda").to(dtype)
    w = torch.rand(n * L, generator=gen, device="cuda") + 0.5
    blocks = torch.rand((n, L, L), generator=gen, device="cuda")
    kernels.reset_launch_counts()
    got = kernels.fused_pushsum_mix_blocks(flat, w, blocks)
    assert kernels.launch_counts()["fused_pushsum_mix_blocks"] == 1
    flats = [kernels.fused_pushsum_mix(flat[s * L:(s + 1) * L],
                                       w[s * L:(s + 1) * L], blocks[s],
                                       debias=False) for s in range(n)]
    assert torch.equal(got[0], torch.cat([f[0] for f in flats]))
    want = ref.fused_pushsum_mix_blocks_ref(flat, w, blocks)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got[0], want[0], rtol=tol, atol=tol)

"""The port's ops API (``repro_torch.kernels``) against the JAX package's
``repro.kernels``: flash attention and its GQA wrapper, the mamba scan,
rmsnorm, the fused noise + SGD step and the clip-and-accumulate composites;
the routing of attention and rmsnorm between their kernels, and the
arithmetic of the tensor-core attention kernels (bf16 P, split TF32).

On CPU tensors each port wrapper runs its plain torch version; the Pallas
kernels run in interpret mode, as tests/test_kernels.py runs them. The same
inputs (numpy, seeded) go to both sides, over the sweeps of
tests/test_kernels.py and tests/test_poisson_kernels.py, with their
tolerances: f32 2e-5, bf16 2e-2, the scan 2e-4, clip_accumulate rtol 1e-5 /
atol 1e-6. The CUDA kernels are held against the same plain versions on the
card by chip_smoke.py and tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.kernels as jk  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    check_tma, flash_copy_width, flash_route, padded_head_dim)
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    LANE_COUNTS, scan_lanes, scan_states)
from repro_torch.kernels.rmsnorm import rmsnorm_route  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SCAN = dict(rtol=2e-4, atol=2e-4)
CLIP = dict(rtol=1e-5, atol=1e-6)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str = "float32"):
    """The same values as a jax array and a CPU torch tensor of ``dtype``
    (bf16 rounded once, on the torch side, and shared)."""
    t = torch.as_tensor(np.ascontiguousarray(a)).to(DTYPES[dtype][1])
    return jnp.asarray(t.float().numpy()).astype(DTYPES[dtype][0]), t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _qkv(seed, shape, dtype="float32"):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal(shape, dtype=np.float32), dtype)
            for _ in range(3)]


def _flash_case(seed, shape, dtype="float32", **kw):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(seed, shape, dtype)
    want = jk.flash_attention(qj, kj, vj, interpret=True, **kw)
    got = kernels.flash_attention(qt, kt, vt, **kw)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


# ---------------------------------------------------------------------------
# flash attention (tests/test_kernels.py:25-74)


@pytest.mark.parametrize("S", [64, 128, 256, 384])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_attention_shapes(S, D):
    _flash_case(S + D, (2, 2, S, D), causal=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_dtypes_masks(dtype, causal):
    _flash_case(1, (1, 4, 128, 64), dtype, causal=causal)


@pytest.mark.parametrize("window", [32, 64, 128])
def test_flash_attention_sliding_window(window):
    _flash_case(2, (1, 2, 256, 32), causal=True, window=window)


@pytest.mark.parametrize("blocks", [(64, 64), (128, 128), (64, 128)])
def test_flash_attention_block_shapes(blocks):
    bq, bk = blocks
    _flash_case(3, (1, 2, 256, 64), causal=True, block_q=bq, block_k=bk)


@pytest.mark.parametrize("S,window,causal", [(100, 16, False), (90, None,
                                                                 True)])
def test_flash_attention_ragged_length_and_one_sided_window(S, window,
                                                            causal):
    """S not a multiple of the tile (padded keys masked) and a window with
    causal=False (one-sided: every later key stays visible)."""
    _flash_case(4, (1, 2, S, 32), causal=causal, window=window, block_q=32,
                block_k=32)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_gqa_flash_attention(G):
    B, S, Hkv, D = 2, 128, 2, 64
    rng = np.random.default_rng(10 + G)
    qj, qt = _pair(rng.standard_normal((B, S, Hkv * G, D), dtype=np.float32))
    kj, kt = _pair(rng.standard_normal((B, S, Hkv, D), dtype=np.float32))
    vj, vt = _pair(rng.standard_normal((B, S, Hkv, D), dtype=np.float32))
    want = jops.gqa_flash_attention(qj, kj, vj, causal=True, interpret=True)
    got = kernels.gqa_flash_attention(qt, kt, vt, causal=True)
    assert got.shape == qt.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 32, "wgmma"),
    (torch.bfloat16, 96, "wgmma"), (torch.bfloat16, 16, "wgmma"),
    (torch.bfloat16, 8, "wgmma"), (torch.bfloat16, 136, "wgmma"),
    (torch.bfloat16, 36, "wgmma"), (torch.bfloat16, 100, "wgmma"),
    (torch.bfloat16, 4, "wgmma"), (torch.bfloat16, 255, "wgmma"),
    (torch.float32, 64, "tf32x3"), (torch.float32, 128, "tf32x3"),
    (torch.float32, 256, "tf32x3"), (torch.float32, 32, "tf32x3"),
    (torch.float32, 96, "tf32x3"), (torch.float32, 4, "tf32x3"),
    (torch.float32, 36, "tf32x3"), (torch.float32, 30, "tf32x3"),
    (torch.float32, 98, "tf32x3"), (torch.float32, 1, "tf32x3")])
def test_flash_route_is_fixed_by_dtype_and_head_dim(dtype, D, route):
    """At every head dim bf16 takes the wgmma kernel and f32 the split-TF32
    one, both on the tensor cores; where a row is not whole 16 bytes (bf16
    36, 100, 4, 255; f32 30, 98, 1) the loader, not the kernel, differs."""
    assert flash_route(dtype, D) == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", range(1, 257))
def test_every_head_dim_runs_on_the_tensor_cores(D, dtype):
    """Every head dim 1..256 of both dtypes routes to a tensor-core kernel
    whose padded width holds it."""
    route = flash_route(dtype, D)
    assert route == {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}[dtype]
    assert padded_head_dim(D, route) >= D


_ALIGNED = 1 << 20   # a base address 16-byte aligned


@pytest.mark.parametrize("D,itemsize,offset,strides,width", [
    # whole 16-byte rows, aligned bases and strides: the 16-byte loader
    (128, 2, 0, (4096 * 128, 128), 16), (96, 4, 0, (32 * 96, 96), 16),
    (64, 2, 0, (28 * 64, 64), 16),
    # a row of 8-byte multiples (bf16 D = 100, f32 D = 98): 8-byte copies
    (100, 2, 0, (4096 * 100, 100), 8), (98, 4, 0, (32 * 98, 98), 8),
    # 4-byte rows (bf16 D = 34, f32 D = 33): 4-byte copies
    (34, 2, 0, (256 * 34, 34), 4), (33, 4, 0, (256 * 33, 33), 4),
    # an odd bf16 head dim: 2-byte loads
    (33, 2, 0, (256 * 33, 33), 2), (255, 2, 0, (255,), 2),
    # a misaligned view at an aligned D: the base decides
    (64, 2, 2, (256 * 64, 64), 2), (64, 2, 4, (256 * 64, 64), 4),
    (64, 2, 8, (256 * 64, 64), 8), (64, 4, 4, (256 * 64, 64), 4),
    (64, 4, 8, (256 * 64, 64), 8), (128, 4, 12, (128,), 4),
    # an aligned D in rows whose stride is not a multiple of 16 bytes
    (64, 2, 0, (68,), 8), (64, 2, 0, (66,), 4), (64, 2, 0, (65,), 2),
    (64, 4, 0, (66,), 8), (64, 4, 0, (65,), 4)])
def test_flash_copy_width_is_the_widest_every_base_and_stride_allows(
        D, itemsize, offset, strides, width):
    """The loader a call takes, from D, the base addresses (one of them
    ``offset`` bytes past a 16-byte boundary) and the strides: 16 where the
    16-byte loaders take it, else 8, 4 or (bf16) 2 bytes a copy."""
    addresses = (_ALIGNED, _ALIGNED + 256, _ALIGNED + offset)
    assert flash_copy_width(D, itemsize, addresses, strides) == width


def test_flash_copy_width_refuses_strides_that_are_not_positive():
    with pytest.raises(ValueError, match="positive"):
        flash_copy_width(64, 2, (_ALIGNED,), (0, 64))


def test_flash_copy_width_of_tensors_agrees_with_the_tma_check():
    """A 16-byte width is exactly what check_tma accepts: an aligned view
    and a view one element off, both dtypes."""
    for dtype in (torch.bfloat16, torch.float32):
        storage = torch.zeros(2 * 64 * 4 + 8, dtype=dtype)
        es = storage.element_size()
        base = (-(storage.data_ptr() // es)) % (16 // es)
        for off, want in ((0, 16), (1, es)):
            t = storage[base + off:base + off + 2 * 64 * 4].view(1, 2, 4, 64)
            width = flash_copy_width(64, es, (t.data_ptr(),),
                                     t.stride()[:-1])
            assert width == want
            if width == 16:
                check_tma("t", t)
            else:
                with pytest.raises(ValueError):
                    check_tma("t", t)


@pytest.mark.parametrize("D", [0, 257, 512])
def test_flash_route_refuses_head_dims_past_the_kernels(D):
    with pytest.raises(ValueError, match="head dim"):
        flash_route(torch.bfloat16, D)
    with pytest.raises(ValueError, match="head dim"):
        padded_head_dim(D)


@pytest.mark.parametrize("route", ["wgmma", "tf32x3"])
@pytest.mark.parametrize("D", range(1, 257))
def test_padded_head_dim_is_the_next_compiled_width(D, route):
    """The tensor-core kernels run head dim D at the smallest width they
    are compiled at that holds it: 64, 128 or 256, and for split TF32 also
    96."""
    widths = {"wgmma": (64, 128, 256), "tf32x3": (64, 96, 128, 256)}[route]
    Dp = padded_head_dim(D, route)
    assert Dp in widths and Dp >= D
    assert all(w < D for w in widths if w < Dp)


@pytest.mark.parametrize("D", [40, 96, 33, 100])
@pytest.mark.parametrize("G", [1, 2])
def test_attention_at_padded_head_dims_matches_jax(D, G):
    """Head dims the tensor-core routes run zero-padded (40 onto 64, 96,
    phi-3-vision's, onto 128; the unaligned 33 onto 64 and 100 onto 128,
    which the narrow loaders fill): the port's plain version against the
    Pallas kernel in interpret mode, causal and with a window, S not a
    multiple of the tile."""
    B, S, Hkv = 1, 100, 2
    rng = np.random.default_rng(50 + D + G)
    qj, qt = _pair(rng.standard_normal((B, S, Hkv * G, D), dtype=np.float32))
    kj, kt = _pair(rng.standard_normal((B, S, Hkv, D), dtype=np.float32))
    vj, vt = _pair(rng.standard_normal((B, S, Hkv, D), dtype=np.float32))
    for kw in (dict(causal=True), dict(causal=True, window=24)):
        want = jops.gqa_flash_attention(qj, kj, vj, interpret=True, **kw)
        got = kernels.gqa_flash_attention(qt, kt, vt, **kw)
        assert got.shape == qt.shape
        np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def test_tma_check_refuses_misaligned_tensors():
    """The wgmma route's tensor maps need 16-byte aligned bases and strides
    of 16-byte multiples; the check raises on anything else."""
    storage = torch.zeros(2 * 64 * 4 + 8, dtype=torch.bfloat16)
    base = 0 if storage.data_ptr() % 16 == 0 else \
        (16 - storage.data_ptr() % 16) // 2
    aligned = storage[base:base + 2 * 64 * 4].view(1, 2, 4, 64)
    check_tma("t", aligned)
    with pytest.raises(ValueError, match="aligned"):
        check_tma("t", storage[base + 1:base + 1 + 2 * 64 * 4].view(
            1, 2, 4, 64))
    with pytest.raises(ValueError, match="multiples of 16"):
        check_tma("t", torch.zeros(1, 2, 4, 36, dtype=torch.bfloat16))


def _attention_bf16_p(q, k, v, *, causal, window, block_k, scale=None):
    """The wgmma kernel's arithmetic in torch: an online softmax over key
    tiles of ``block_k`` in f32, with P rounded to bf16 before P·V — the
    one rounding the reference does not do. ``scale`` defaults to the
    width's D**-0.5."""
    B, H, S, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    qf, kf, vf = (t.float() for t in (q, k, v))
    qp = torch.arange(S)[:, None]
    m = torch.full((B, H, S, 1), float("-inf"))
    l, acc = torch.zeros(B, H, S, 1), torch.zeros(B, H, S, D)
    for k0 in range(0, S, block_k):
        kp = torch.arange(k0, min(k0 + block_k, S))[None, :]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + block_k]) \
            * scale
        ok = torch.ones(S, kp.shape[1], dtype=torch.bool)
        if causal:
            ok &= kp <= qp
        if window is not None:
            ok &= (qp - kp) < window
        s = torch.where(ok, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_safe = torch.where(m_new == float("-inf"), 0.0, m_new)
        corr = torch.where(m == float("-inf"), 0.0, torch.exp(m - m_safe))
        p = torch.exp(s - m_safe)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum(
            "bhqk,bhkd->bhqd", p.bfloat16().float(), vf[:, :, k0:k0 + block_k])
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("D", [128, 256])
def test_bf16_p_rounding_stays_within_the_bf16_tolerance(D, window):
    """P rounded to bf16 before P·V, as the wgmma kernel does, against the
    f32-P reference at S = 1,024, causal, with and without a window."""
    rng = np.random.default_rng(20 + D + (window or 0))
    q, k, v = (torch.as_tensor(rng.standard_normal(
        (1, 2, 1_024, D), dtype=np.float32)).bfloat16() for _ in range(3))
    got = _attention_bf16_p(q, k, v, causal=True, window=window,
                            block_k=128 if D <= 128 else 64)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL["bfloat16"])


def _narrow_stage(x, p0, rows, Dp):
    """The narrow wgmma loader's staging of one tile in torch: positions
    p0 .. p0 + rows − 1 of x [S, d] (bf16) written at the byte address the
    loader computes for (row r, column c): 64-column block c // 64 at
    rows·128 bytes a block, row r at r·128, 16-byte chunk (c % 64) // 8 XOR
    r % 8, 2 bytes a column, into a zeroed tile of the compiled width Dp;
    rows at or past S and columns at or past d stay zero."""
    S, d = x.shape
    buf = torch.zeros(Dp // 64 * rows * 128, dtype=torch.uint8)
    n = max(0, min(rows, S - p0))
    r, c = torch.arange(n)[:, None], torch.arange(d)[None, :]
    addr = (c // 64) * rows * 128 + r * 128 + \
        ((((c % 64) // 8) ^ (r % 8)) << 4) + (c % 8) * 2
    raw = x[p0:p0 + n].contiguous().view(torch.int16).to(torch.int32)
    buf[addr.flatten()] = (raw & 0xff).to(torch.uint8).flatten()
    buf[addr.flatten() + 1] = ((raw >> 8) & 0xff).to(torch.uint8).flatten()
    return buf


def _swizzled_read(buf, rows, Dp):
    """The tile as wgmma reads it, by the 128-byte swizzle as the hardware
    defines it on byte offsets from a 1,024-byte aligned base: bits 4–6
    XOR bits 7–9; column c of row r at logical offset (c // 64)·rows·128 +
    r·128 + (c % 64)·2."""
    r, c = torch.arange(rows)[:, None], torch.arange(Dp)[None, :]
    logical = (c // 64) * rows * 128 + r * 128 + (c % 64) * 2
    phys = logical ^ (((logical >> 7) & 7) << 4)
    lo, hi = buf[phys].to(torch.int32), buf[phys + 1].to(torch.int32)
    return ((hi << 8) | lo).to(torch.int16).view(torch.bfloat16)


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("D", [1, 33, 100, 129, 255])
def test_narrow_wgmma_staging_matches_the_plain_version(D, window):
    """Q, K and V staged tile by tile as the narrow loader writes them (its
    swizzled addresses, zeros past S and D), read back through the
    hardware's swizzle, then the wgmma kernel's arithmetic at the compiled
    width with the real D's scale: columns < D agree with the plain
    version at the bf16 tolerance and columns ≥ D are exactly 0, at odd
    and even D, S = 200 (a partial last tile), causal."""
    S, H = 200, 2
    Dp = padded_head_dim(D, "wgmma")
    bk = 128 if Dp <= 128 else 64
    rng = np.random.default_rng(60 + D)
    q, k, v = (torch.as_tensor(rng.standard_normal(
        (1, H, S, D), dtype=np.float32)).bfloat16() for _ in range(3))

    def staged(x, rows):
        tiles = [_swizzled_read(_narrow_stage(x[0, h], p0, rows, Dp), rows,
                                Dp)
                 for h in range(H) for p0 in range(0, S, rows)]
        out = torch.stack([torch.cat(tiles[h * len(tiles) // H:
                                           (h + 1) * len(tiles) // H])
                           for h in range(H)])[None]
        assert not bool(out[:, :, S:].any()) and not bool(out[..., D:].any())
        assert torch.equal(out[:, :, :S, :D], x)
        return out[:, :, :S]

    qs, ks, vs = staged(q, 128), staged(k, bk), staged(v, bk)
    got = _attention_bf16_p(qs, ks, vs, causal=True, window=window,
                            block_k=bk, scale=D ** -0.5)
    assert not bool(got[..., D:].any())
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got[..., :D].float(), want.float(),
                               **TOL["bfloat16"])


def _tf32_split(x):
    """x = hi + lo as the split-TF32 kernel forms it: hi rounded to TF32
    half away from zero (cvt.rna), lo the exact residual truncated to the
    19 bits the tensor core reads."""
    mask = ~0x1fff
    hi = ((x.contiguous().view(torch.int32) + 0x1000) & mask).view(
        torch.float32)
    lo = ((x - hi).view(torch.int32) & mask).view(torch.float32)
    return hi, lo


def _x3(eq, a, b):
    """A product in split TF32: a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, each of
    TF32 operands (exact in f32), summed in f32."""
    (ah, al), (bh, bl) = _tf32_split(a), _tf32_split(b)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) \
        + torch.einsum(eq, ah, bh)


def _attention_tf32x3(q, k, v, *, causal, window, block_k):
    """The split-TF32 kernel's arithmetic in torch: both products in split
    TF32 with f32 accumulation, an online softmax in log2 units over key
    tiles of ``block_k`` (scale·log2(e) folded into the scores, exp2), the
    reference's m_safe, corr = 0 for an empty row and l clamped at 1e-30."""
    B, H, S, D = q.shape
    scale_log2 = torch.tensor(D ** -0.5, dtype=torch.float32) \
        * torch.tensor(1.4426950408889634, dtype=torch.float32)
    qp = torch.arange(S)[:, None]
    m = torch.full((B, H, S, 1), float("-inf"))
    l, acc = torch.zeros(B, H, S, 1), torch.zeros(B, H, S, D)
    for k0 in range(0, S, block_k):
        kp = torch.arange(k0, min(k0 + block_k, S))[None, :]
        s = _x3("bhqd,bhkd->bhqk", q, k[:, :, k0:k0 + block_k]) * scale_log2
        ok = torch.ones(S, kp.shape[1], dtype=torch.bool)
        if causal:
            ok &= kp <= qp
        if window is not None:
            ok &= (qp - kp) < window
        s = torch.where(ok, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_safe = torch.where(m_new == float("-inf"), 0.0, m_new)
        corr = torch.where(m == float("-inf"), 0.0, torch.exp2(m - m_safe))
        p = torch.exp2(s - m_safe)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _x3("bhqk,bhkd->bhqd", p, v[:, :, k0:k0 + block_k])
        m = m_new
    return acc / l.clamp_min(1e-30)


def test_tf32_split_rounds_half_away_and_keeps_the_residual():
    x = torch.tensor([1.0 + 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 2 ** -12,
                      1.0 + 3 * 2 ** -11 + 2 ** -20, 0.0, -3.25e-7])
    hi, lo = _tf32_split(x)
    # the tie rounds away from zero, both signs; below the tie rounds down
    assert hi[:3].tolist() == [1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0]
    assert bool(((hi.view(torch.int32) & 0x1fff) == 0).all())
    # the residual is exact where it fits 11 bits, and hi + lo is x to 2^-21
    assert float(x[2] - hi[2]) == float(lo[2])
    torch.testing.assert_close(hi + lo, x, rtol=2 ** -21, atol=0)


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("D", [128, 256])
def test_split_tf32_attention_stays_within_the_f32_tolerance(D, window):
    """Both products in split TF32, as the f32 tensor-core kernel forms
    them, with its key tiles (64 keys, 16 at D = 256), against the f32
    reference at S = 1,024, causal, with and without a window."""
    rng = np.random.default_rng(40 + D + (window or 0))
    q, k, v = (torch.as_tensor(rng.standard_normal(
        (1, 2, 1_024, D), dtype=np.float32)) for _ in range(3))
    got = _attention_tf32x3(q, k, v, causal=True, window=window,
                            block_k=64 if D <= 128 else 16)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got, want, **TOL["float32"])


# ---------------------------------------------------------------------------
# mamba selective scan (tests/test_kernels.py:81-108)


def _scan_case(seed, B, S, di, ds, **kw):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, di), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di), dtype=np.float32)))
    A = -np.exp(rng.standard_normal((di, ds), dtype=np.float32))
    Bm = rng.standard_normal((B, S, ds), dtype=np.float32)
    C = rng.standard_normal((B, S, ds), dtype=np.float32)
    pairs = [_pair(a) for a in (dt, x, Bm, C, A)]
    want = jk.mamba_scan(*(p[0] for p in pairs), interpret=True, **kw)
    got = kernels.mamba_scan(*(p[1] for p in pairs), **kw)
    assert got.shape == (B, S, di) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **SCAN)


@pytest.mark.parametrize("S,chunk", [(64, 16), (128, 32), (96, 32),
                                     (256, 128)])
def test_mamba_scan_chunks(S, chunk):
    _scan_case(S, 2, S, 16, 8, chunk=chunk)


@pytest.mark.parametrize("di,ds", [(8, 4), (32, 16), (64, 8)])
def test_mamba_scan_dims(di, ds):
    _scan_case(di + ds, 1, 64, di, ds, chunk=16)


def _scan_lanes_emulated(dt, x, Bm, C, A):
    """The scan kernel's arithmetic in torch, each f32 op rounded on its
    own: the inputs converted to f32 at use, a channel's states over
    ``scan_lanes(ds)`` lanes of ``scan_states(ds)`` states each (zero past
    ds), exp as expf(dt·A); each lane's y partial summed in state order, the
    partials added pairwise in lane order ((p0 + p1) + (p2 + p3)), as
    __shfl_xor_sync at offsets 1, 2, 4, 8 adds them; y in x's dtype."""
    Bsz, S, di = x.shape
    ds = A.shape[1]
    lanes, ns = scan_lanes(ds), scan_states(ds)
    width = lanes * ns
    a = torch.zeros(di, width)
    a[:, :ds] = A
    bp, cp = (torch.zeros(Bsz, S, width) for _ in range(2))
    bp[..., :ds], cp[..., :ds] = Bm.float(), C.float()
    dtf, xf = dt.float(), x.float()
    h = torch.zeros(Bsz, di, width)
    ys = []
    for t in range(S):
        e = torch.exp(dtf[:, t, :, None] * a)
        dx = dtf[:, t] * xf[:, t]
        h = e * h + dx[..., None] * bp[:, t, None, :]
        hc = (h * cp[:, t, None, :]).view(Bsz, di, lanes, ns)
        part = hc[..., 0]
        for k in range(1, ns):
            part = part + hc[..., k]
        off = 1
        while off < lanes:
            part = part.clone()
            part[..., ::2 * off] = part[..., ::2 * off] + part[..., off::2 * off]
            off *= 2
        ys.append(part[..., 0])
    return torch.stack(ys, dim=1).to(x.dtype)


def _scan_numpy(seed, B, S, di, ds):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, di), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di), dtype=np.float32)))
    A = -np.exp(rng.standard_normal((di, ds), dtype=np.float32))
    Bm = rng.standard_normal((B, S, ds), dtype=np.float32)
    C = rng.standard_normal((B, S, ds), dtype=np.float32)
    return dt, x, Bm, C, A


@pytest.mark.parametrize("ds", [1, 3, 8, 9, 16, 17, 32, 64])
def test_scan_lane_split_stays_within_the_scan_tolerance(ds):
    """The kernel's arithmetic at every compiled (lanes, states a lane)
    pair against the JAX reference (repro.kernels.ref.mamba_scan_ref) over
    S = 4,096 steps, di 32, at the scan's 2e-4."""
    arrays = _scan_numpy(7, 1, 4_096, 32, ds)
    want = jax_ref.mamba_scan_ref(*(jnp.asarray(a) for a in arrays))
    got = _scan_lanes_emulated(*(torch.as_tensor(a) for a in arrays))
    np.testing.assert_allclose(_np(got), _np(want), **SCAN)


@pytest.mark.parametrize("bf16_dt_b_c", [False, True])
@pytest.mark.parametrize("B,S,di,ds,chunk", [
    (2, 64, 16, 8, 16), (2, 128, 16, 8, 32), (2, 96, 16, 8, 32),
    (2, 256, 16, 8, 128), (1, 64, 8, 4, 16), (1, 64, 32, 16, 16),
    (1, 64, 64, 8, 16)])
def test_scan_lane_split_matches_pallas(B, S, di, ds, chunk, bf16_dt_b_c):
    """The kernel's arithmetic, at the lanes it takes for ds, against the
    Pallas kernel in interpret mode at the shapes of test_mamba_scan_chunks
    and test_mamba_scan_dims, in f32 and with dt, B and C in bf16 (both
    convert them at use), at the scan's 2e-4."""
    dt, x, Bm, C, A = _scan_numpy(S + di + ds, B, S, di, ds)
    jx = [jnp.asarray(a) for a in (dt, x, Bm, C, A)]
    if bf16_dt_b_c:
        for i in (0, 2, 3):
            jx[i] = jx[i].astype(jnp.bfloat16)
    want = jk.mamba_scan(*jx, chunk=chunk, interpret=True)
    got = _scan_lanes_emulated(*(torch.from_numpy(
        np.array(a.astype(jnp.float32))).to(
            torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
        for a in jx))
    np.testing.assert_allclose(_np(got), _np(want), **SCAN)


@pytest.mark.parametrize("ds", range(1, 65))
def test_scan_lanes_keep_at_most_four_states_a_lane(ds):
    """The fewest compiled lanes that hold ds states at four a lane, and a
    lane's states a power of two that covers ds."""
    lanes = scan_lanes(ds)
    assert lanes == min(n for n in LANE_COUNTS if 4 * n >= ds)
    ns = scan_states(ds)
    assert ns in (1, 2, 4) and lanes * ns >= ds
    assert ns == 1 or lanes * (ns // 2) < ds


@pytest.mark.parametrize("ds,ns", [(1, 1), (2, 1), (3, 2), (4, 2), (5, 4),
                                   (16, 4), (17, 4), (64, 4)])
def test_scan_states_round_up_to_a_power_of_two(ds, ns):
    assert scan_states(ds) == ns


@pytest.mark.parametrize("ds", [0, 65])
def test_scan_lanes_refuse_state_sizes_past_the_kernel(ds):
    with pytest.raises(ValueError):
        scan_lanes(ds)


# ---------------------------------------------------------------------------
# rmsnorm (tests/test_poisson_kernels.py:89-120)


@pytest.mark.parametrize("shape", [(4, 128), (2, 16, 256), (1, 512),
                                   (3, 1024)])
def test_rmsnorm_shapes(shape):
    rng = np.random.default_rng(len(shape) + shape[-1])
    xj, xt = _pair(rng.standard_normal(shape, dtype=np.float32))
    gj, gt = _pair(rng.standard_normal(shape[-1], dtype=np.float32))
    got = kernels.rmsnorm(xt, gt)
    assert got.shape == xt.shape
    np.testing.assert_allclose(_np(got), _np(jax_rmsnorm(xj, gj,
                                                         interpret=True)),
                               **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_dtypes(dtype):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng.standard_normal((64, 256), dtype=np.float32), dtype)
    gj, gt = _pair(rng.standard_normal(256, dtype=np.float32), dtype)
    got = kernels.rmsnorm(xt, gt)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(
        _np(got), _np(jax_rmsnorm(xj, gj, interpret=True)), **TOL[dtype])


@pytest.mark.parametrize("rows,block_rows", [(77, 32), (300, 256), (1, 8)])
def test_rmsnorm_block_boundaries(rows, block_rows):
    rng = np.random.default_rng(rows)
    xj, xt = _pair(rng.standard_normal((rows, 64), dtype=np.float32))
    gj, gt = _pair(rng.standard_normal(64, dtype=np.float32))
    np.testing.assert_allclose(
        _np(kernels.rmsnorm(xt, gt, block_rows=block_rows)),
        _np(jax_rmsnorm(xj, gj, block_rows=block_rows, interpret=True)),
        **TOL["float32"])


def _at(dtype, n, off):
    """A CPU tensor of n elements of ``dtype`` that starts ``off`` elements
    past a 16-byte boundary."""
    es = torch.tensor([], dtype=dtype).element_size()
    storage = torch.zeros(n + off + 16, dtype=dtype)
    base = (-storage.data_ptr() % 16) // es
    return storage[base + off:base + off + n]


@pytest.mark.parametrize("dtype,d,x_off,g_off,route", [
    (torch.bfloat16, 3_584, 0, 0, "vector"), (torch.float32, 3_584, 0, 0,
                                              "vector"),
    (torch.bfloat16, 8, 0, 0, "vector"), (torch.float32, 4, 0, 0, "vector"),
    (torch.bfloat16, 1_000, 0, 0, "vector"),
    (torch.bfloat16, 33, 0, 0, "scalar"), (torch.float32, 6, 0, 0, "scalar"),
    (torch.bfloat16, 1_001, 0, 0, "scalar"),
    (torch.bfloat16, 3_584, 1, 0, "scalar"),
    (torch.float32, 3_584, 0, 1, "scalar")])
def test_rmsnorm_route_is_fixed_by_row_bytes_and_alignment(dtype, d, x_off,
                                                           g_off, route):
    """The vector instantiation (16-byte accesses) takes x, g and out that
    start on 16-byte boundaries with rows of whole 16 bytes; anything else
    the scalar one."""
    x = _at(dtype, 3 * d, x_off).view(3, d)
    g = _at(dtype, d, g_off)
    out = _at(dtype, 3 * d, 0).view(3, d)
    assert rmsnorm_route(x, g, out) == route


# ---------------------------------------------------------------------------
# the DP ops: noise + SGD step, clip-and-accumulate (tests/test_kernels.py
# :115-154)


@pytest.mark.parametrize("D", [1, 1_000, 65_537, 199_210])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_noise_sgd_step(D, dtype):
    rng = np.random.default_rng(D + 3)
    acc, noise = (rng.standard_normal(D, dtype=np.float32) for _ in range(2))
    pj, pt = _pair(rng.standard_normal(D, dtype=np.float32), dtype)
    hp = dict(stddev=1.3, n_units=250, lr=1e-3, weight_decay=1e-4)
    want = jk.noise_sgd_step(jnp.asarray(acc), jnp.asarray(noise), pj, **hp,
                             interpret=True)
    got = kernels.noise_sgd_step(torch.as_tensor(acc),
                                 torch.as_tensor(noise), pt, **hp)
    assert got.dtype == pt.dtype and got.shape == (D,)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("n,clip", [(1024, 0.5), (4096, 1.0), (65536, 3.0)])
def test_clip_accumulate(n, clip):
    rng = np.random.default_rng(n)
    gj, gt = _pair(rng.standard_normal(n, dtype=np.float32))
    aj, at = _pair(rng.standard_normal(n, dtype=np.float32))
    want = jk.clip_accumulate(aj, gj, clip, interpret=True)
    got = kernels.clip_accumulate(at, gt, clip)
    np.testing.assert_allclose(_np(got), _np(want), **CLIP)
    np.testing.assert_allclose(_np(got),
                               _np(kernels.ref.clip_accumulate_ref(at, gt,
                                                                   clip)),
                               **CLIP)


def test_tree_clip_accumulate_matches_jax():
    rng = np.random.default_rng(3)
    leaves = {"a": rng.standard_normal((128, 8), dtype=np.float32),
              "b": {"c": rng.standard_normal(64, dtype=np.float32)}}
    acc = {"a": rng.standard_normal((128, 8), dtype=np.float32),
           "b": {"c": rng.standard_normal(64, dtype=np.float32)}}
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    to_t = lambda t: {"a": torch.as_tensor(t["a"]),  # noqa: E731
                      "b": {"c": torch.as_tensor(t["b"]["c"])}}
    want = jops.tree_clip_accumulate(to_j(acc), to_j(leaves), 0.5,
                                     interpret=True)
    got = kernels.tree_clip_accumulate(to_t(acc), to_t(leaves), 0.5)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(_np(a), _np(b), **CLIP)


# ---------------------------------------------------------------------------
# the API itself


def test_every_public_name_has_a_counterpart():
    missing = [n for n in jk.__all__ if not hasattr(kernels, n)]
    assert not missing, missing
    assert set(jk.__all__) <= set(kernels.__all__)
    assert {"noise_sgd_step", "rmsnorm", "flash_attention",
            "mamba_scan"} <= set(kernels.KERNELS)


def test_interpret_is_decided_by_the_device():
    assert kernels.default_interpret("cpu") is True
    assert kernels.default_interpret("cuda") is False
    assert kernels.resolve_interpret(None, "cpu") is True
    assert kernels.resolve_interpret(True, "cpu") is True
    with pytest.raises(ValueError):   # no plain version on CUDA tensors
        kernels.resolve_interpret(True, "cuda")
    with pytest.raises(ValueError):   # no kernel on CPU tensors
        kernels.resolve_interpret(False, "cpu")


def test_cpu_calls_launch_nothing():
    kernels.reset_launch_counts()
    x = torch.randn(2, 64, 2, 32)
    kernels.flash_attention(x, x, x)
    kernels.gqa_flash_attention(x, x[:, :, :1].contiguous(),
                                x[:, :, :1].contiguous())
    kernels.rmsnorm(x, torch.ones(32))
    kernels.mamba_scan(x[0].abs(), x[0], x[0, :, :, :4], x[0, :, :, :4],
                       -torch.ones(32, 4))
    v = torch.randn(100)
    kernels.noise_sgd_step(v, v, v, stddev=1.0, n_units=2, lr=0.1)
    kernels.clip_accumulate(v, v, 1.0)
    kernels.tree_clip_accumulate({"w": v}, {"w": v}, 1.0)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def test_cpu_calls_count_no_route():
    """Calls on CPU tensors, on every route's dtype and head dim, leave the
    per-route counts of attention, rmsnorm, the DP clip pair, the Adam
    step and the scan at 0 (the client routes under ``torch.func.vmap``
    too)."""
    from torch.func import vmap
    kernels.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        for D in (32, 128):
            x = torch.randn(1, 2, 16, D).to(dtype)
            kernels.flash_attention(x, x, x)
            xs = torch.stack([x, x])
            vmap(kernels.flash_attention)(xs, xs, xs)
        kernels.rmsnorm(torch.randn(4, 33).to(dtype), torch.ones(33))
        vmap(kernels.rmsnorm)(torch.randn(2, 4, 33).to(dtype),
                              torch.ones(2, 33))
        g = torch.randn(3, 40).to(dtype)
        kernels.clip_accumulate_rows(g, kernels.sumsq_rows(g))
        kernels.clip_accumulate(torch.zeros(40), g[0], 1.0)
        s = torch.rand(2, 1, 4, 3)
        vmap(kernels.mamba_scan)(s, s.to(dtype), s[..., :2], s[..., :2],
                                 -torch.rand(2, 3, 2))
    counts = kernels.route_launch_counts()
    assert set(counts) == {"flash_attention/wgmma",
                           "flash_attention/wgmma/narrow",
                           "flash_attention/tf32x3",
                           "flash_attention/tf32x3/narrow",
                           "flash_attention/clients", "rmsnorm/vector",
                           "rmsnorm/scalar", "rmsnorm/clients",
                           "sumsq/vector", "sumsq/rows",
                           "scale_accumulate/vector",
                           "scale_accumulate/rows",
                           "scale_accumulate/clients",
                           "noise_adam_step/flat", "noise_adam_step/clients",
                           "mamba_scan/flat", "mamba_scan/clients"}
    assert not any(counts.values())


def _refusal(case):
    x = torch.randn(16)
    q = torch.randn(1, 2, 8, 4)
    if case == "sgd p dtype":
        kernels.noise_sgd_step(x, x, x.double(), stddev=1.0, n_units=2,
                               lr=0.1)
    elif case == "sgd acc dtype":
        kernels.noise_sgd_step(x.bfloat16(), x, x, stddev=1.0, n_units=2,
                               lr=0.1)
    elif case == "sgd shapes":
        kernels.noise_sgd_step(x, x[:8], x, stddev=1.0, n_units=2, lr=0.1)
    elif case == "rmsnorm gain":
        kernels.rmsnorm(x.reshape(4, 4), torch.ones(5))
    elif case == "rmsnorm dtype":
        kernels.rmsnorm(x.reshape(4, 4).double(), torch.ones(4))
    elif case == "flash dtypes":
        kernels.flash_attention(q, q.bfloat16(), q)
    elif case == "flash head dim":
        big = torch.randn(1, 1, 4, 512)
        kernels.flash_attention(big, big, big)
    elif case == "flash kv shape":
        kernels.flash_attention(q, q[:, :1], q[:, :1])
    elif case == "gqa groups":
        kernels.gqa_flash_attention(q, q[:, :, :3].contiguous(),
                                    q[:, :, :3].contiguous())
    elif case == "mamba block_d":
        y = torch.randn(1, 4, 24)
        b = torch.randn(1, 4, 4)
        kernels.mamba_scan(y, y, b, b, torch.randn(24, 4), block_d=16)
    elif case == "mamba state":
        y = torch.randn(1, 4, 8)
        b = torch.randn(1, 4, 65)
        kernels.mamba_scan(y, y, b, b, torch.randn(8, 65))
    elif case == "mamba shapes":
        y = torch.randn(1, 4, 8)
        kernels.mamba_scan(y, y, y, y, torch.randn(8, 4))
    else:
        raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "sgd p dtype", "sgd acc dtype", "sgd shapes", "rmsnorm gain",
    "rmsnorm dtype", "flash dtypes", "flash head dim", "flash kv shape",
    "gqa groups", "mamba block_d", "mamba state", "mamba shapes"])
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    with pytest.raises((TypeError, ValueError)):
        _refusal(case)

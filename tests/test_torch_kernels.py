"""The port's five kernels against the JAX package's Pallas kernels.

On CPU tensors each ``repro_torch.kernels`` wrapper runs its plain torch
version; the Pallas kernels run in interpret mode, as tests/test_kernels.py
runs them. Same inputs (numpy, seeded) on both sides, at the sizes
chip_smoke.py checks on the card, with the kernel tolerances of
tests/test_kernels.py. The CUDA kernels themselves are held against the
same plain versions on the card by chip_smoke.py and
tests/test_torch_cuda.py.
"""
import ctypes
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro.kernels.dp_clip import scale_accumulate as jax_scale_accumulate  # noqa: E402
from repro.kernels.dp_clip import sumsq as jax_sumsq  # noqa: E402
from repro.kernels.dp_step import noise_adam_step as jax_noise_adam_step  # noqa: E402
from repro.kernels.pushsum_mix import fused_pushsum_mix as jax_mix  # noqa: E402
from repro.kernels.pushsum_mix import fused_stale_mix as jax_stale_mix  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.dp_step import step_columns  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SIZES_D = [1, 1_000, 65_537, 199_210]
SIZES_K = [1, 3, 8, 33]


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a CPU torch tensor of ``dtype``
    (bf16 rounded once, on the torch side, and shared)."""
    t = torch.as_tensor(a).to(DTYPES[dtype][1])
    return jnp.asarray(t.float().numpy()).astype(DTYPES[dtype][0]), t


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("D", SIZES_D)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sumsq(D, dtype):
    rng = np.random.default_rng(D)
    xj, xt = _pair(rng.standard_normal(D, dtype=np.float32), dtype)
    want = jax_sumsq(xj, interpret=True)
    got = kernels.sumsq(xt)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("D", SIZES_D)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_accumulate(D, dtype):
    rng = np.random.default_rng(D + 1)
    acc = rng.standard_normal(D, dtype=np.float32)
    gj, gt = _pair(rng.standard_normal(D, dtype=np.float32), dtype)
    scale = np.float32(rng.random())
    want = jax_scale_accumulate(jnp.asarray(acc), gj, jnp.asarray(scale),
                                interpret=True)
    got = kernels.scale_accumulate(torch.as_tensor(acc), gt,
                                   torch.tensor(scale))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


@pytest.mark.parametrize("D", SIZES_D)
def test_noise_adam_step(D):
    rng = np.random.default_rng(D + 2)
    acc, noise, p, m = (rng.standard_normal(D, dtype=np.float32)
                        for _ in range(4))
    v = rng.random(D, dtype=np.float32)
    hp = dict(stddev=1.0, n_units=250, lr=1e-3, weight_decay=1e-4,
              b1=0.9, b2=0.999, eps=1e-8)
    t = 3.0
    want = jax_noise_adam_step(
        *(jnp.asarray(a) for a in (acc, noise, p, m, v)), **hp,
        c1=1 - 0.9 ** jnp.float32(t), c2=1 - 0.999 ** jnp.float32(t),
        interpret=True)
    tf = torch.tensor(t)
    got = kernels.noise_adam_step(
        *(torch.as_tensor(a) for a in (acc, noise, p, m, v)), **hp,
        c1=1 - 0.9 ** tf, c2=1 - 0.999 ** tf)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL["float32"])


@pytest.mark.parametrize("D", [3, 4, 5])
def test_noise_adam_step_around_a_group_of_four(D):
    """The lengths around the Adam kernel's four-column groups (a tail of
    D % 4 elements), against the Pallas kernel."""
    test_noise_adam_step(D)


@pytest.mark.parametrize("offs,cols", [
    ((0,) * 8, 4), ((2,) * 8, 2), ((1,) * 8, 1), ((3,) * 8, 1),
    ((0,) * 7 + (2,), 2), ((0,) * 7 + (1,), 1), ((2,) * 7 + (1,), 1),
    # bf16 vectors (offsets in bf16 elements): four a thread at 8 bytes
    ((("bf16", 0),) * 3, 4), ((("bf16", 4),) * 3, 4),
    ((("bf16", 2),) * 3, 2), ((("bf16", 6),) * 3, 2),
    ((("bf16", 1),) * 3, 1), ((("bf16", 4),) * 2 + (("bf16", 3),), 1),
    # the SGD step's mix: f32 acc and noise, bf16 p and p'
    ((0, 0, ("bf16", 4), ("bf16", 0)), 4),
    ((0, 0, ("bf16", 2), ("bf16", 0)), 2),
    ((2, 0, ("bf16", 4), ("bf16", 0)), 2),
    ((0, 1, ("bf16", 0), ("bf16", 0)), 1)])
def test_adam_columns_are_the_widest_every_vector_is_aligned_to(offs, cols):
    """Four elements a thread where every vector's base is aligned to four
    of its elements (16 bytes of f32, 8 of bf16), two where to two, else
    one; a vector one element off holds all back. An offset is in f32
    elements, or ("bf16", n) in bf16 elements."""
    stores = {dt: torch.zeros(64, dtype=dt)
              for dt in (torch.float32, torch.bfloat16)}
    vecs = []
    for o in offs:
        dt, o = (torch.bfloat16, o[1]) if isinstance(o, tuple) else \
            (torch.float32, o)
        store = stores[dt]
        es = store.element_size()
        base = (-(store.data_ptr() // es)) % (16 // es)   # 16-byte aligned
        vecs.append(store[base + o:base + o + 8])
    assert step_columns(*vecs) == cols


@pytest.mark.parametrize("K", SIZES_K)
@pytest.mark.parametrize("D", [1, 1_000, 65_537])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_pushsum_mix(K, D, dtype):
    rng = np.random.default_rng(K * 7 + D)
    P = rng.random((K, K))
    P = P / P.sum(0, keepdims=True)   # dense column-stochastic
    w = (rng.random(K) + 0.5).astype(np.float32)
    fj, ft = _pair(rng.standard_normal((K, D), dtype=np.float32), dtype)
    for debias in (True, False):
        zj, wj = jax_mix(fj, jnp.asarray(w), jnp.asarray(P, jnp.float32),
                         debias=debias, interpret=True)
        zt, wt = kernels.fused_pushsum_mix(ft, torch.as_tensor(w),
                                           torch.as_tensor(P), debias=debias)
        assert zt.dtype == ft.dtype and zt.shape == (K, D)
        np.testing.assert_allclose(_np(zt), _np(zj), **TOL[dtype])
        np.testing.assert_allclose(_np(wt), _np(wj), **TOL["float32"])


def test_fused_pushsum_mix_main_shape():
    """The main path's exchange: K = 8 clients of the 199,210-wide mlp."""
    test_fused_pushsum_mix(8, 199_210, "float32")


def _stale_args(K, D, dtype):
    """flat, w, kept, sent, buf_t0, buf_w0 as tests/test_kernels.py builds
    them (kept/sent split from a column-stochastic P, w in [0.3, 2.0],
    buf_t0 = 0.1·N(0, 1), buf_w0 in [0, 0.5]), as jax and torch pairs."""
    rng = np.random.default_rng(K * 11 + D)
    P = rng.uniform(0.1, 1.0, (K, K))
    P = P / P.sum(0, keepdims=True)
    kept = np.diag(P).astype(np.float32)
    sent = (P - np.diag(np.diag(P))).astype(np.float32)
    flat = _pair(rng.standard_normal((K, D), dtype=np.float32), dtype)
    w = _pair(rng.uniform(0.3, 2.0, K).astype(np.float32), dtype)
    buf_t0 = _pair(0.1 * rng.standard_normal((K, D), dtype=np.float32), dtype)
    buf_w0 = _pair(rng.uniform(0.0, 0.5, K).astype(np.float32), dtype)
    kept, sent = (jnp.asarray(kept), torch.as_tensor(kept)), \
        (jnp.asarray(sent), torch.as_tensor(sent))
    args = (flat, w, kept, sent, buf_t0, buf_w0)
    return [a[0] for a in args], [a[1] for a in args]


@pytest.mark.parametrize("K", SIZES_K)
@pytest.mark.parametrize("D", [1, 1_000, 65_537])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_stale_mix(K, D, dtype):
    jargs, targs = _stale_args(K, D, dtype)
    want = jax_stale_mix(*jargs, interpret=True)
    got = kernels.fused_stale_mix(*targs)
    assert [tuple(g.shape) for g in got] == [(K, D), (K, D), (K,), (K,)]
    assert got[0].dtype == got[1].dtype == targs[0].dtype
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL[dtype])


def test_fused_stale_mix_main_shape():
    """The async path's exchange: K = 8 clients of the 199,210-wide mlp."""
    test_fused_stale_mix(8, 199_210, "float32")


def test_cpu_calls_launch_nothing():
    kernels.reset_launch_counts()
    x = torch.randn(1_000)
    kernels.sumsq(x)
    kernels.scale_accumulate(x, x, torch.tensor(0.5))
    t = torch.tensor(1.0)
    kernels.noise_adam_step(x, x, x, x, x.abs(), stddev=1.0, n_units=2,
                            lr=1e-3, c1=1 - 0.9 ** t, c2=1 - 0.999 ** t)
    kernels.fused_pushsum_mix(x.reshape(4, 250), torch.ones(4),
                              torch.eye(4))
    kernels.fused_stale_mix(x.reshape(4, 250), torch.ones(4), torch.ones(4),
                            torch.zeros(4, 4), x.reshape(4, 250),
                            torch.zeros(4))
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.randn(16)
    with pytest.raises(ValueError):
        kernels.sumsq(x.reshape(4, 4))
    with pytest.raises(TypeError):
        kernels.sumsq(x.double())
    with pytest.raises(ValueError):
        kernels.scale_accumulate(x.bfloat16(), x, torch.tensor(1.0))
    with pytest.raises(ValueError):
        kernels.fused_pushsum_mix(x.reshape(4, 4), torch.ones(3),
                                  torch.eye(4))
    z, w = x.reshape(4, 4), torch.ones(4)
    with pytest.raises(ValueError):   # buf_t0 of another dtype
        kernels.fused_stale_mix(z, w, w, torch.zeros(4, 4), z.bfloat16(), w)
    with pytest.raises(ValueError):   # sent not [K, K]
        kernels.fused_stale_mix(z, w, w, torch.zeros(4), z, w)
    with pytest.raises(TypeError):
        kernels.fused_stale_mix(z.double(), w, w, torch.zeros(4, 4),
                                z.double(), w)
    t = torch.tensor(1.0)
    with pytest.raises(ValueError):
        kernels.noise_adam_step(x, x, x, x, x.bfloat16(), stddev=1.0,
                                n_units=2, lr=1e-3, c1=t, c2=t)


_C_TYPES = {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
            "float": ctypes.c_float}


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_ctypes_signatures_match_the_c_entry_points(name):
    """Each entry point's ctypes argument types are the parameters its
    ``extern "C"`` declaration in kernels/csrc has, in order (a pointer as
    c_void_p): ctypes passes what it is told, so a mismatch would hand the
    kernel a cut pointer or a float as an int."""
    src = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src, re.S)
    assert m is not None, name
    params = tuple(ctypes.c_void_p if "*" in p else _C_TYPES[p.split()[0]]
                   for p in m.group(1).split(","))
    assert params == _build._SIGNATURES[name]

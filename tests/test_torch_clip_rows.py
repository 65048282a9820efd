"""The ``"rows"`` route of the DP clip pair on the CPU: ``sumsq_rows`` and
``clip_accumulate_rows`` against the JAX package's Pallas ``sumsq`` and
``scale_accumulate`` applied row by row in interpret mode, the kernel
path's ``_flat_clip_accumulate`` against the per-example loop it replaced,
and the wrappers' refusals.

Inputs are made with numpy from a seed; bf16 values are rounded once on the
torch side and shared. Tolerances are tests/test_kernels.py's: f32
rtol = atol = 2e-5, bf16 2e-2. The CUDA kernels are held bit for bit
against the 1-D kernels on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro.kernels.dp_clip import scale_accumulate as jax_scale_accumulate  # noqa: E402
from repro.kernels.dp_clip import sumsq as jax_sumsq  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import dp  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ROWS_B = [1, 3, 17]
ROWS_D = [1, 1_000, 65_537]


def _matrix(B: int, D: int, dtype: str, seed: int):
    """[B, D] as a jax array and as a CPU torch view of a buffer whose row
    stride is padded to 128 bytes (the layout the DP path builds)."""
    a = np.random.default_rng(seed).standard_normal((B, D), dtype=np.float32)
    t = torch.as_tensor(a).to(DTYPES[dtype][1])
    per_line = 128 // t.element_size()
    buf = torch.zeros((B, -(-D // per_line) * per_line), dtype=t.dtype)
    buf[:, :D] = t
    return jnp.asarray(t.float().numpy()).astype(DTYPES[dtype][0]), buf[:, :D]


@pytest.mark.parametrize("B", ROWS_B)
@pytest.mark.parametrize("D", ROWS_D)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sumsq_rows_matches_pallas_row_by_row(B, D, dtype):
    xj, xt = _matrix(B, D, dtype, seed=B * 100_003 + D)
    want = np.array([float(jax_sumsq(xj[i], interpret=True))
                     for i in range(B)], np.float32)
    got = kernels.sumsq_rows(xt)
    assert got.dtype == torch.float32 and got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("B", ROWS_B)
@pytest.mark.parametrize("D", ROWS_D)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_accumulate_rows_matches_chained_pallas(B, D, dtype):
    gj, gt = _matrix(B, D, dtype, seed=B * 100_003 + D + 1)
    scales = np.random.default_rng(D).random(B, dtype=np.float32) + 0.01
    acc = jnp.zeros((D,), jnp.float32)
    for i in range(B):
        acc = jax_scale_accumulate(acc, gj[i], jnp.asarray(scales[i:i + 1]),
                                   interpret=True)
    got = kernels.clip_accumulate_rows(gt, torch.as_tensor(scales))
    assert got.dtype == torch.float32 and got.shape == (D,)
    np.testing.assert_allclose(got.numpy(), np.asarray(acc), **TOL[dtype])


def _per_example_loop(losses, grads, clip_norm, D, device):
    """``_flat_clip_accumulate`` as it was before the rows route: one
    ``sumsq`` and one ``scale_accumulate`` per example, in order."""
    B = losses.shape[0]
    flat = torch.cat([g.reshape(B, -1) for g in tree_leaves(grads)], dim=1)
    acc = torch.zeros((D,), dtype=torch.float32, device=device)
    norms = []
    for i in range(B):
        norm = torch.sqrt(kernels.sumsq(flat[i]))
        scale = 1.0 / torch.clamp(norm / clip_norm, min=1.0)
        acc = kernels.scale_accumulate(acc, flat[i], scale)
        norms.append(norm)
    metrics = {"loss": losses.sum() / B,
               "mean_grad_norm": torch.stack(norms).sum() / B}
    return acc, metrics


# (B, leaf shapes after the batch dim, leaf dtypes, clip norm): a long row
# (a 1-D CPU sum splits it across threads), a ragged width, bf16 leaves,
# mixed dtypes (promoted to f32) and a clip that leaves every row whole
GRAD_CASES = [
    (6, [(300, 300), (300,), (7,)], ["float32"] * 3, 1.0),
    (17, [(13, 11), (3,)], ["float32"] * 2, 0.5),
    (5, [(40, 25), (9,)], ["bfloat16"] * 2, 0.1),
    (4, [(33, 17), (5,)], ["float32", "bfloat16"], 2.0),
    (3, [(10, 10)], ["float32"], 1e6),
]


@pytest.mark.parametrize("case", range(len(GRAD_CASES)))
def test_flat_clip_accumulate_equals_the_per_example_loop(case):
    B, shapes, dtypes, clip_norm = GRAD_CASES[case]
    rng = np.random.default_rng(case)
    grads = {f"l{i}": torch.as_tensor(
        rng.standard_normal((B,) + s, dtype=np.float32)).to(
            DTYPES[dt][1])
        for i, (s, dt) in enumerate(zip(shapes, dtypes))}
    losses = torch.as_tensor(rng.random(B, dtype=np.float32))
    D = sum(int(np.prod(s)) for s in shapes)
    acc, metrics = dp._flat_clip_accumulate(losses, grads, clip_norm, D,
                                            "cpu")
    want_acc, want = _per_example_loop(losses, grads, clip_norm, D, "cpu")
    assert acc.dtype == torch.float32 and acc.shape == (D,)
    assert torch.equal(acc, want_acc)
    for key in ("loss", "mean_grad_norm"):
        assert torch.equal(metrics[key], want[key]), key


@pytest.mark.parametrize("dtype,ld", [(torch.float32, 199_232),
                                      (torch.bfloat16, 199_232)])
def test_flat_clip_accumulate_pads_rows_to_whole_cache_lines(
        monkeypatch, dtype, ld):
    """The DP path hands both rows wrappers one [B, D] view of a buffer
    whose row stride is a whole number of 128-byte lines (199,210 f32 or
    bf16 rows are not), once each per step."""
    seen = []

    def spy(fn):
        def wrapped(g, *args):
            seen.append((fn.__name__, g.shape, g.stride(),
                         g.stride(0) * g.element_size() % 128))
            return fn(g, *args)
        return wrapped

    monkeypatch.setattr(dp, "sumsq_rows", spy(kernels.sumsq_rows))
    monkeypatch.setattr(dp, "clip_accumulate_rows",
                        spy(kernels.clip_accumulate_rows))
    B, D = 3, 199_210
    grads = {"w": torch.randn(B, D - 10).to(dtype),
             "b": torch.randn(B, 10).to(dtype)}
    dp._flat_clip_accumulate(torch.ones(B), grads, 1.0, D, "cpu")
    assert seen == [(name, (B, D), (ld, 1), 0) for name in
                    ("sumsq_rows", "clip_accumulate_rows")]


def test_cpu_rows_calls_launch_nothing():
    kernels.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.randn(5, 77).to(dtype)
        kernels.clip_accumulate_rows(g, kernels.sumsq_rows(g))
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    assert not any(kernels.route_launch_counts().values())


def _rows_refusal(case):
    g = torch.randn(4, 10)
    s = torch.ones(4)
    calls = {
        "1-D x": lambda: kernels.sumsq_rows(g[0]),
        "3-D x": lambda: kernels.sumsq_rows(g.reshape(2, 2, 10)),
        "empty x": lambda: kernels.sumsq_rows(g[:, :0]),
        "f64 x": lambda: kernels.sumsq_rows(g.double()),
        "int x": lambda: kernels.sumsq_rows(g.int()),
        "column-major x": lambda: kernels.sumsq_rows(g.t()),
        "overlapping rows": lambda: kernels.sumsq_rows(
            g[0].expand(4, 10)),
        "1-D g": lambda: kernels.clip_accumulate_rows(g[0], s),
        "f16 g": lambda: kernels.clip_accumulate_rows(g.half(), s),
        "strided columns": lambda: kernels.clip_accumulate_rows(
            g[:, ::2], s),
        "f64 scales": lambda: kernels.clip_accumulate_rows(g, s.double()),
        "short scales": lambda: kernels.clip_accumulate_rows(g, s[:3]),
        "2-D scales": lambda: kernels.clip_accumulate_rows(
            g, s.reshape(4, 1)),
        "float scales": lambda: kernels.clip_accumulate_rows(g, 1.0),
        "meta scales": lambda: kernels.clip_accumulate_rows(
            g, torch.ones(4, device="meta")),
    }
    calls[case]()


@pytest.mark.parametrize("case", [
    "1-D x", "3-D x", "empty x", "f64 x", "int x", "column-major x",
    "overlapping rows", "1-D g", "f16 g", "strided columns", "f64 scales",
    "short scales", "2-D scales", "float scales", "meta scales"])
def test_rows_wrappers_refuse_what_the_kernels_do_not_take(case):
    kernels.reset_launch_counts()
    with pytest.raises((TypeError, ValueError)):
        _rows_refusal(case)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)

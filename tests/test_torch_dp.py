"""The port's DP-SGD against ``repro.core.dp`` on one small batch.

The loss is the ProxyFL proxy loss (DML against a frozen private mlp), the
reference's noise is injected through the port's ``noise`` argument
(``repro.core.dp._flat_gaussian_like``, the draws the reference's fused
path uses), and the reference's kernels run in interpret mode. Tolerance:
the conformance ``close`` grade (atol 1e-5, rtol 1e-4) — per-example
gradients and their sums round differently in the two frameworks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import dp as jax_dp  # noqa: E402
from repro.nn.losses import dml_loss as jax_dml_loss  # noqa: E402
from repro.nn.vision import get_vision_model as jax_vision  # noqa: E402
from repro.optim.optimizers import Adam as JaxAdam  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import dp  # noqa: E402
from repro_torch.nn.losses import dml_loss  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402
from repro_torch.nn.vision import get_vision_model  # noqa: E402
from repro_torch.optim import Adam  # noqa: E402

CLOSE = dict(atol=1e-5, rtol=1e-4)
SHAPE, N_CLASSES, B = (14, 14, 1), 10, 6
DP = dict(clip_norm=0.5, noise_multiplier=1.0)


@pytest.fixture(scope="module")
def setup():
    jv, tv = jax_vision("mlp"), get_vision_model("mlp")
    theta = jv.init(jax.random.PRNGKey(1), SHAPE, N_CLASSES)
    phi = jv.init(jax.random.PRNGKey(2), SHAPE, N_CLASSES)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B,) + SHAPE, dtype=np.float32)
    y = rng.integers(0, N_CLASSES, B)

    def jax_loss(t, b):
        return jax_dml_loss(jv.apply(t, b[0]), jv.apply(phi, b[0]), b[1], 0.5)

    phi_t = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, phi))

    def torch_loss(t, b):
        return dml_loss(tv.apply(t, b[0]), tv.apply(phi_t, b[0]), b[1], 0.5)

    return dict(theta=theta, jax_loss=jax_loss, torch_loss=torch_loss,
                jbatch=(jnp.asarray(x), jnp.asarray(y)),
                tbatch=(torch.as_tensor(x), torch.as_tensor(y)))


def _close(ours, theirs):
    ours, theirs = tree_leaves(ours), jax.tree_util.tree_leaves(theirs)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **CLOSE)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_dp_gradient(setup, use_pallas):
    key = jax.random.PRNGKey(5)
    jg, jm = jax_dp.dp_gradient(setup["jax_loss"], setup["theta"],
                                setup["jbatch"], key, use_pallas=use_pallas,
                                interpret=True, **DP)
    noise = np.array(jax_dp._flat_gaussian_like(setup["theta"], key))
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, setup["theta"]))
    tg, tm = dp.dp_gradient(setup["torch_loss"], params, setup["tbatch"],
                            noise=torch.as_tensor(noise),
                            use_pallas=use_pallas, **DP)
    _close(tg, jg)
    for k in ("loss", "mean_grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **CLOSE)
    # the clip is active: some example's norm is above C
    assert float(tm["mean_grad_norm"]) > DP["clip_norm"]


def test_dp_adam_update_two_steps(setup):
    jopt, opt = JaxAdam(lr=1e-3, weight_decay=1e-4), Adam(lr=1e-3,
                                                          weight_decay=1e-4)
    jp, js = setup["theta"], jopt.init(setup["theta"])
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    ts = opt.init(tp)
    for step in range(2):
        key = jax.random.PRNGKey(10 + step)
        jp, js, jm = jax_dp.dp_adam_update(
            setup["jax_loss"], jp, js, setup["jbatch"], key, opt=jopt,
            interpret=True, **DP)
        noise = torch.as_tensor(np.array(
            jax_dp._flat_gaussian_like(setup["theta"], key)))
        tp, ts, tm = dp.dp_adam_update(setup["torch_loss"], tp, ts,
                                       setup["tbatch"], opt=opt, noise=noise,
                                       **DP)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **CLOSE)
    assert int(ts.t) == int(js.t) == 2
    _close((tp, ts.m, ts.v), (jp, js.m, js.v))


def test_noise_is_drawn_from_the_generator_when_absent(setup):
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, setup["theta"]))
    draw = lambda: dp.dp_gradient(  # noqa: E731
        setup["torch_loss"], params, setup["tbatch"],
        generator=torch.Generator().manual_seed(3), use_pallas=True, **DP)[0]
    a, b = draw(), draw()
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        dp.dp_gradient(setup["torch_loss"], params, setup["tbatch"], **DP)

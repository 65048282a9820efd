"""The port's conv vision models against the JAX package's
(``repro.nn.vision``): lenet5, cnn1, cnn2, the small VGG (``"vgg"``) and
the GroupNorm residual CNN (``"resnet_gn"``), beside mlp.

Every model starts from the reference's own init (``jax.random.PRNGKey``),
carried across with ``repro_torch.convert.params_from_numpy``. Checked:

* the registry's names, key paths, leaf shapes and sizes, and the
  ``tree_flatten_vector`` wire order against ``jax.tree_util``;
* logits, and per-example gradients of the cross-entropy against
  ``jax.vmap(jax.grad(...))``, at the conformance ``close`` grade (atol
  1e-5, rtol 1e-4), at the datasets' image sizes (MNIST 28×28×1, camelyon
  32×32×3, kvasir's 25×20×3 VGG), resnet_gn at even (32) and odd (25) H,
  and a non-square two-channel image for the flatten order;
* the pieces that differ from a plain PyTorch layer: XLA's ``"SAME"``
  padding, the NHWC flatten order of NCHW activations and GroupNorm's
  group count and population variance;
* batched evaluation (``vmap`` over stacked conv params) equal to the
  per-client evaluation.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.nn import losses as jax_losses  # noqa: E402
from repro.nn import vision as jax_vision  # noqa: E402
from repro.nn.modules import tree_flatten_vector as jax_flatten  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.protocol import ModelSpec, evaluate, evaluate_batched  # noqa: E402
from repro_torch.nn import losses, vision  # noqa: E402
from repro_torch.nn.modules import tree_flatten_vector, tree_leaves, tree_map  # noqa: E402

CLOSE = dict(atol=1e-5, rtol=1e-4)

# (model, image shape, classes, proxy size D of the JAX package's init
# where the table of the port's widths lists it)
CASES = [
    ("mlp", (28, 28, 1), 10, 199_210),
    ("lenet5", (28, 28, 1), 10, 107_786),
    ("cnn1", (28, 28, 1), 10, 51_830),
    ("cnn2", (28, 28, 1), 10, 211_594),
    ("cnn1", (32, 32, 3), 2, 66_778),
    ("vgg", (25, 20, 3), 8, 110_792),
    ("resnet_gn", (32, 32, 3), 2, 307_842),
    ("resnet_gn", (25, 25, 3), 2, 307_842),
    ("lenet5", (13, 11, 2), 3, None),
]
IDS = [f"{m}-{'x'.join(map(str, s))}" for m, s, _, _ in CASES]


@functools.lru_cache(maxsize=None)
def reference(name, shape, n_classes, n=3, seed=0):
    """The JAX package's init and a seeded batch, as numpy (read only)."""
    params = jax_vision.get_vision_model(name).init(
        jax.random.PRNGKey(seed), shape, n_classes)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + shape).astype(np.float32)
    y = rng.integers(0, n_classes, n).astype(np.int32)
    return jax.tree_util.tree_map(np.asarray, params), x, y


def key_paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in key_paths(tree[k],
                                                           prefix + (k,))]
    return [(prefix, tuple(tree.shape))]


def test_registry_names_equal_reference():
    assert sorted(vision.MODELS) == sorted(jax_vision.MODELS)
    for name, model in vision.MODELS.items():
        assert model.name == jax_vision.MODELS[name].name == name


@pytest.mark.parametrize("name,shape,n_classes,D", CASES, ids=IDS)
def test_init_layout_and_wire_order_equal_reference(name, shape, n_classes,
                                                    D):
    jparams, _, _ = reference(name, shape, n_classes)
    ours = vision.get_vision_model(name).init(
        torch.Generator().manual_seed(0), shape, n_classes)
    assert key_paths(ours) == key_paths(jparams)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert paths == ["".join(f"['{k}']" for k in p)
                     for p, _ in key_paths(jparams)]
    carried = convert.params_from_numpy(jparams)
    np.testing.assert_array_equal(tree_flatten_vector(carried).numpy(),
                                  np.asarray(jax_flatten(jparams)))
    if D is not None:
        assert tree_flatten_vector(ours).numel() == D


@pytest.mark.parametrize("name,shape,n_classes,D", CASES, ids=IDS)
def test_logits_and_per_example_grads_match_reference(name, shape,
                                                      n_classes, D):
    jparams, x, y = reference(name, shape, n_classes)
    jm, tm = jax_vision.get_vision_model(name), vision.get_vision_model(name)
    params = convert.params_from_numpy(jparams)
    want = np.asarray(jm.apply(jparams, x))
    got = tm.apply(params, torch.as_tensor(x))
    assert got.shape == want.shape == (x.shape[0], n_classes)
    np.testing.assert_allclose(got.detach().numpy(), want, **CLOSE)

    def jax_loss(p, xi, yi):
        return jax_losses.cross_entropy(jm.apply(p, xi[None]), yi[None])

    def torch_loss(p, xi, yi):
        return losses.cross_entropy(tm.apply(p, xi[None]), yi[None])

    want_g = jax.jit(jax.vmap(jax.grad(jax_loss), in_axes=(None, 0, 0)))(
        jparams, jnp.asarray(x), jnp.asarray(y))
    got_g = torch.func.vmap(torch.func.grad(torch_loss),
                            in_dims=(None, 0, 0))(
        params, torch.as_tensor(x), torch.as_tensor(y).long())
    la, lb = tree_leaves(got_g), jax.tree_util.tree_leaves(want_g)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **CLOSE)


@pytest.mark.parametrize("size", range(1, 34))
@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (5, 1), (1, 2),
                                      (3, 2)])
def test_same_pads_equal_xla(size, k, stride):
    (want,) = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")
    assert vision.same_pads(size, k, stride) == tuple(want)


def test_flatten_order_is_nhwc():
    """A flatten of NCHW activations lists them as the reference's NHWC
    reshape does: (h, w, c), channels fastest."""
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    np.testing.assert_array_equal(
        vision._flatten_nhwc(x.permute(0, 3, 1, 2)).numpy(),
        x.reshape(2, -1).numpy())


@pytest.mark.parametrize("channels", [1, 3, 6, 12, 20, 32, 128])
def test_groupnorm_matches_reference(channels):
    rng = np.random.default_rng(channels)
    x = (3.0 * rng.standard_normal((2, 5, 4, channels)) + 1.5).astype(
        np.float32)
    p = {"g": rng.standard_normal(channels).astype(np.float32),
         "b": rng.standard_normal(channels).astype(np.float32)}
    want = np.asarray(jax_vision._groupnorm(p, jnp.asarray(x)))
    module = vision.GroupNorm(channels)
    got = torch.func.functional_call(
        module, {k: torch.as_tensor(v) for k, v in p.items()},
        (torch.as_tensor(x).permute(0, 3, 1, 2),))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               want, **CLOSE)


@pytest.mark.parametrize("name,shape,n_classes", [
    ("lenet5", (12, 12, 1), 10), ("cnn1", (12, 12, 3), 2),
    ("cnn2", (8, 8, 1), 4), ("vgg", (25, 20, 3), 8),
    ("resnet_gn", (25, 25, 3), 2)])
def test_batched_evaluation_equals_per_client(name, shape, n_classes):
    tm = vision.get_vision_model(name)
    spec = ModelSpec(name, lambda g: tm.init(g, shape, n_classes), tm.apply)
    trees = [spec.init(torch.Generator().manual_seed(k)) for k in range(3)]
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((40,) + shape, generator=gen)
    y = torch.randint(0, n_classes, (40,), generator=gen)
    stacked = tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])
    assert evaluate_batched(spec, stacked, x, y, batch=16) == \
        [evaluate(spec, t, x, y, batch=16) for t in trees]

"""Membership-inference attacks in the port (``repro_torch.core.attacks``)
against the JAX package: ``auc_from_scores`` equal on
tests/test_attacks.py's cases (ties and the empty-side error included) and
on random draws; ``per_example_losses`` and ``loss_threshold_mia`` at the
conformance ``close`` grade (atol 1e-5, rtol 1e-4) on a linear model and
on the mlp with converted params; ``bitflip_proxy`` bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import attacks as jax_attacks  # noqa: E402
from repro.nn.vision import get_vision_model as jax_vision  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import attacks  # noqa: E402
from repro_torch.nn.vision import get_vision_model  # noqa: E402

CLOSE = dict(atol=1e-5, rtol=1e-4)

AUC_CASES = [
    (np.asarray([0.1, 0.2, 0.05]), np.asarray([1.0, 2.0, 3.0])),
    (np.asarray([5.0, 6.0]), np.asarray([0.1, 0.2])),
    (np.ones(10), np.ones(10)),
    (np.asarray([0.3, 0.3, 0.1, 0.7]), np.asarray([0.3, 0.7, 0.7])),
]


@pytest.mark.parametrize("case", range(len(AUC_CASES)))
def test_auc_equal_on_the_reference_cases(case):
    m, n = AUC_CASES[case]
    assert attacks.auc_from_scores(m, n) == jax_attacks.auc_from_scores(m, n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auc_equal_on_random_scores(seed):
    rng = np.random.default_rng(seed)
    a, b = rng.normal(size=20), rng.normal(size=30)
    b[:5] = a[:5]                       # ties across the two sides
    got = attacks.auc_from_scores(a, b)
    assert got == jax_attacks.auc_from_scores(a, b)
    assert 0.0 <= got <= 1.0
    assert attacks.auc_from_scores(b, a) == pytest.approx(1.0 - got,
                                                          abs=1e-9)
    s = rng.normal(size=4000)
    assert abs(attacks.auc_from_scores(s[:2000], s[2000:]) - 0.5) < 0.05


def test_auc_empty_side_raises():
    for m, n in ((np.array([]), np.ones(3)), (np.ones(3), np.array([])),
                 (np.array([]), np.array([]))):
        with pytest.raises(ValueError, match="non-empty"):
            attacks.auc_from_scores(m, n)


def test_per_example_losses_linear_model():
    k = jax.random.PRNGKey(0)
    w = jax.random.normal(k, (6, 4))
    x = jax.random.normal(jax.random.fold_in(k, 1), (32, 6))
    y = jax.random.randint(jax.random.fold_in(k, 2), (32,), 0, 4)
    want = jax_attacks.per_example_losses(lambda p, xb: xb @ p, w, x, y,
                                          batch=8)
    got = attacks.per_example_losses(
        lambda p, xb: xb @ p, torch.tensor(np.asarray(w)),
        torch.tensor(np.asarray(x)), torch.tensor(np.asarray(y)), batch=8)
    assert got.shape == (32,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **CLOSE)


def test_per_example_losses_and_mia_on_the_mlp():
    shape, n_classes = (8, 8, 1), 10
    params = jax_vision("mlp").init(jax.random.PRNGKey(3), shape, n_classes)
    rng = np.random.default_rng(5)
    xm = rng.normal(size=(40,) + shape).astype(np.float32)
    ym = rng.integers(0, n_classes, 40)
    xn = rng.normal(size=(70,) + shape).astype(np.float32)
    yn = rng.integers(0, n_classes, 70)
    jspec, tspec = jax_vision("mlp"), get_vision_model("mlp")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    want = jax_attacks.per_example_losses(jspec.apply, params,
                                          jnp.asarray(xm), jnp.asarray(ym),
                                          batch=16)
    got = attacks.per_example_losses(tspec.apply, tparams, torch.tensor(xm),
                                     torch.tensor(ym), batch=16)
    np.testing.assert_allclose(got, want, **CLOSE)
    auc = attacks.loss_threshold_mia(
        tspec.apply, tparams, (torch.tensor(xm), torch.tensor(ym)),
        (torch.tensor(xn), torch.tensor(yn)))
    jauc = jax_attacks.loss_threshold_mia(
        jspec.apply, params, (jnp.asarray(xm), jnp.asarray(ym)),
        (jnp.asarray(xn), jnp.asarray(yn)))
    assert auc == pytest.approx(jauc, abs=CLOSE["atol"], rel=CLOSE["rtol"])
    assert 0.0 <= auc <= 1.0


@pytest.mark.parametrize("bit,index,rounds", [(0, 0, None), (22, 5, (1,)),
                                              (31, 99, (0, 2))])
def test_bitflip_proxy_bit_equal(bit, index, rounds):
    flat = np.random.default_rng(bit).normal(size=(4, 100)).astype(np.float32)
    ours = attacks.bitflip_proxy(2, bit=bit, index=index, rounds=rounds)
    theirs = jax_attacks.bitflip_proxy(2, bit=bit, index=index, rounds=rounds)
    for t in range(3):
        got, want = ours(flat, t), theirs(flat, t)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        flipped = rounds is None or t in rounds
        assert (got.view(np.uint32) != flat.view(np.uint32)).sum() == flipped

"""Ragged (size-skewed) cohorts on the port's stacked executor (port of
tests/test_ragged.py's stacked checks), on the CPU: the padded stack
(``data.ragged.pad_stack``), padding never drawn, exhausted clients frozen
in epoch mode, the keyed stacked-data LRU, the refusals of the stacked
path, a ragged resume bit-equal, and table 2's cnn1 cohort (cut to a few
dozen examples a client) on ``vmap`` within ``close`` of the loop round by
round.
"""
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.benchmarks import common, table2_histo  # noqa: E402
from repro_torch.configs import DPConfig, ProxyFLConfig  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.engine import (FederationEngine,  # noqa: E402
                                     _sampler_accepts_n_valid,
                                     classifier_sampler, dml_engine)
from repro_torch.core.protocol import ModelSpec  # noqa: E402
from repro_torch.data.ragged import (client_lengths, pad_compatible,  # noqa: E402
                                     pad_stack)
from repro_torch.data.synthetic import make_classification_data  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402
from repro_torch.nn.vision import get_vision_model  # noqa: E402

K, N_CLASSES, SHAPE = 4, 10, (14, 14, 1)
SIZES = (40, 25, 33, 9)
CLOSE = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def ragged():
    x, y = make_classification_data(torch.Generator().manual_seed(0),
                                    sum(SIZES), SHAPE, N_CLASSES, sep=2.0)
    out, i = [], 0
    for n in SIZES:
        out.append((x[i:i + n], y[i:i + n]))
        i += n
    return out


@pytest.fixture(scope="module")
def spec():
    vm = get_vision_model("mlp")
    return ModelSpec("mlp", lambda g: vm.init(g, SHAPE, N_CLASSES), vm.apply)


def _cfg(**kw):
    base = dict(n_clients=K, rounds=1, batch_size=8, local_steps=0,
                use_pallas=True, dp=DPConfig(enabled=True))
    base.update(kw)
    return ProxyFLConfig(**base)


def _finite(state):
    return all(torch.isfinite(x).all() for x in tree_leaves(state)
               if x.is_floating_point())


# ---------------------------------------------------------------------------
# the padded stack


def test_pad_stack_shapes_lengths_and_fill(ragged):
    stacked, n_valid = pad_stack(ragged, fill=float("nan"))
    n_max = max(SIZES)
    assert stacked[0].shape == (K, n_max) + SHAPE
    assert stacked[1].shape == (K, n_max)
    assert n_valid.tolist() == list(SIZES) == client_lengths(ragged).tolist()
    for k, (x, y) in enumerate(ragged):
        assert torch.equal(stacked[0][k, :SIZES[k]], x)
        assert torch.equal(stacked[1][k, :SIZES[k]], y)
        assert torch.isnan(stacked[0][k, SIZES[k]:]).all()
        # an integer leaf takes its dtype's least value for a NaN fill
        assert (stacked[1][k, SIZES[k]:] ==
                torch.iinfo(y.dtype).min).all()


def test_pad_stack_of_a_rectangular_cohort_is_a_plain_stack(ragged):
    square = [(x[:9], y[:9]) for x, y in ragged]
    stacked, n_valid = pad_stack(square)
    assert torch.equal(stacked[0], torch.stack([x for x, _ in square]))
    assert n_valid.tolist() == [9] * K


def test_pad_stack_refuses_an_empty_client(ragged):
    bad = list(ragged) + [(ragged[0][0][:0], ragged[0][1][:0])]
    with pytest.raises(ValueError, match="zero examples"):
        pad_stack(bad)


def test_sampler_protocol():
    assert _sampler_accepts_n_valid(classifier_sampler(8))
    assert _sampler_accepts_n_valid(lambda d, g, *, n_valid: d)
    assert not _sampler_accepts_n_valid(lambda d, g, idx=None: d)
    assert not _sampler_accepts_n_valid(lambda d, g, temperature=0.5: d)
    assert not _sampler_accepts_n_valid(len)


def test_masked_sampler_never_draws_padding():
    n_valid = 37
    x = torch.cat([torch.ones(n_valid, 3), torch.full((63, 3), math.nan)])
    y = torch.cat([torch.zeros(n_valid), torch.full((63,), math.nan)])
    sample = classifier_sampler(16)
    for i in range(50):
        xb, yb = sample((x, y), torch.Generator().manual_seed(i),
                        n_valid=n_valid)
        assert torch.isfinite(xb).all() and torch.isfinite(yb).all()


# ---------------------------------------------------------------------------
# the stacked executor on a ragged cohort


def test_engine_round_never_reads_padding(ragged, spec, monkeypatch):
    """NaN padding inside the engine's stack: one drawn padding row, or
    one unmasked step, would make a param or a metric non-finite."""
    monkeypatch.setattr(engine, "pad_stack",
                        lambda data: pad_stack(data, fill=float("nan")))
    eng = dml_engine((spec,) * K, spec, _cfg(dropout_rate=0.3), device="cpu")
    assert eng.stacked
    state, metrics = eng.run_rounds(eng.init_states(0), ragged, 0, 2, seed=0)
    assert _finite(state)
    act = engine.active_schedule(0, 2, K, _cfg(dropout_rate=0.3))
    for v in metrics.values():
        assert np.isfinite(v[act]).all()


def test_exhausted_clients_are_frozen(ragged, spec):
    """Epoch mode: client k takes its own n_k // B steps (at least one), so
    its Adam counts are its steps and its state is the loop's, although
    the stacked round runs the cohort's largest count."""
    cfg = _cfg()
    steps = [max(1, n // cfg.batch_size) for n in SIZES]
    assert len(set(steps)) > 1
    out = {}
    for backend in ("loop", "vmap"):
        eng = dml_engine((spec,) * K, spec, cfg, backend=backend,
                         device="cpu")
        out[backend] = eng.run_round(eng.init_states(0), ragged, 0, seed=0)
    state = out["vmap"][0]
    assert [int(s["proxy"]["opt"].t) for s in state] == steps
    assert [int(s["private"]["opt"].t) for s in state] == steps
    for a, b in zip(tree_leaves(state), tree_leaves(out["loop"][0])):
        if a.is_floating_point():
            torch.testing.assert_close(a, b, **CLOSE)
        else:
            assert torch.equal(a, b)


def test_stack_cache_does_not_thrash(ragged, spec):
    """Two datasets alternating round by round are stacked once each; the
    LRU keeps at most four."""
    cfg = _cfg(local_steps=1, dp=DPConfig(enabled=False))
    eng = dml_engine((spec,) * K, spec, cfg, device="cpu")
    other = [(x[:max(1, x.shape[0] // 2)], y[:max(1, y.shape[0] // 2)])
             for x, y in ragged]
    state = eng.init_states(0)
    for t, data in enumerate([ragged, other, ragged, other]):
        state, _ = eng.run_round(state, data, t, seed=0)
    assert eng._stack_misses == 2
    for n in range(3, 7):
        state, _ = eng.run_round(state, [(x[:n], y[:n]) for x, y in ragged],
                                 4 + n, seed=0)
    assert eng._stack_misses == 6 and len(eng._data_cache) == 4


def test_ragged_cohort_needs_a_masked_sampler(ragged, spec):
    cfg = _cfg(local_steps=1)
    base = dml_engine((spec,) * K, spec, cfg, device="cpu")

    def legacy(data_k, generator, idx=None):
        x, y = data_k
        return x[idx], y[idx]

    legacy.batch_size = 8
    eng = FederationEngine(cfg, n_clients=K, step_fns=base.step_fns[0],
                           init_fns=base.init_fns[0], sample_fn=legacy,
                           backend="vmap", device="cpu", stackable=True,
                           noisy_steps=True)
    with pytest.raises(ValueError, match="masked sampler"):
        eng.run_round(eng.init_states(0), ragged, 0, seed=0)
    square = [(x[:9], y[:9]) for x, y in ragged]
    state, _ = eng.run_round(eng.init_states(0), square, 0, seed=0)
    assert _finite(state)


@pytest.mark.parametrize("case", ["trailing dims", "dtypes", "structure"])
def test_stacked_path_refuses_incompatible_trees(ragged, spec, case):
    data = list(ragged)
    x, y = data[0]
    data[0] = {"trailing dims": (x[:, :7], y), "dtypes": (x.double(), y),
               "structure": {"x": x, "y": y}}[case]
    assert not pad_compatible(data)
    eng = dml_engine((spec,) * K, spec, _cfg(local_steps=1), device="cpu")
    with pytest.raises(ValueError, match="stacked executor"):
        eng.run_round(eng.init_states(0), data, 0, seed=0)


def test_stackable_engine_needs_a_sampler_batch_size(spec):
    base = dml_engine((spec,) * K, spec, _cfg(), device="cpu")
    with pytest.raises(ValueError, match="batch_size"):
        FederationEngine(_cfg(), n_clients=K, step_fns=base.step_fns[0],
                         init_fns=base.init_fns[0],
                         sample_fn=lambda d, g, idx=None: d, backend="vmap",
                         device="cpu", stackable=True)


def test_loop_passes_the_length_to_a_masked_sampler(ragged, spec):
    """A sampler whose ``n_valid`` has no default runs on the loop too,
    given each client's own length."""
    cfg = _cfg(local_steps=1)
    base = dml_engine((spec,) * K, spec, cfg, device="cpu")
    seen = []

    def strict(data_k, generator, idx=None, *, n_valid):
        seen.append(n_valid)
        x, y = data_k
        if idx is None:
            idx = torch.randint(0, n_valid, (8,), generator=generator)
        return x[idx], y[idx]

    eng = FederationEngine(cfg, n_clients=K, step_fns=base.step_fns[0],
                           init_fns=base.init_fns[0], sample_fn=strict,
                           backend="loop", device="cpu")
    state, _ = eng.run_round(eng.init_states(0), ragged, 0, seed=0)
    assert seen == list(SIZES) and _finite(state)


def test_ragged_checkpoint_resume_is_bit_equal(ragged, spec, tmp_path):
    cfg = _cfg(rounds=2)
    eng = dml_engine((spec,) * K, spec, cfg, device="cpu")
    state, _ = eng.run_round(eng.init_states(0), ragged, 0, seed=0)
    path = os.path.join(str(tmp_path), "snap")
    eng.save_state(path, state, 0, seed=0)
    cont, _ = eng.run_round(state, ragged, 1, seed=0)
    restored, done = eng.restore_state(path, seed=0)
    assert done == 1
    resumed, _ = eng.run_round(restored, ragged, 1, seed=0)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cont),
                                                 tree_leaves(resumed)))


def test_table2_cohort_vmap_close_to_loop_round_by_round():
    """Table 2's configuration (camelyon, a Dirichlet cohort of 4, cnn1,
    B = 32, σ 1.4, C 0.7, α 0.3, epoch mode), cut to 2% of the data: both
    backends from the loop's state each round, ``close``."""
    conf = table2_histo.configuration(True)
    for key in ("methods", "seeds", "rounds"):
        conf.pop(key)
    conf["n_train_factor"] = 0.02
    data, _, priv, prox, cfg = common.method_setup(
        conf.pop("dataset"), conf.pop("n_clients"), 0, rounds=2,
        device="cpu", **conf)
    sizes = [x.shape[0] for x, _ in data]
    assert len(set(sizes)) > 1 and cfg.local_steps in (0, None)
    Kc = len(data)
    engs = {b: dml_engine((priv,) * Kc, prox, cfg, backend=b, device="cpu")
            for b in ("loop", "vmap")}
    state = engs["loop"].init_states(0)
    for t in range(2):
        outs = {b: e.run_round(state, data, t, seed=0)
                for b, e in engs.items()}
        for a, b in zip(tree_leaves(outs["vmap"][0]),
                        tree_leaves(outs["loop"][0])):
            if a.is_floating_point():
                torch.testing.assert_close(a, b, **CLOSE)
            else:
                assert torch.equal(a, b)
        state = outs["loop"][0]

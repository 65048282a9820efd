"""The configuration registry of the port (``repro_torch.configs``) against
the JAX package's ``repro.configs``: the same registered names, and for
every registered arch the config, ``param_counts()``, ``layout()`` and the
derived sizes, ``proxy_of(cfg)`` and ``smoke_variant(cfg)`` equal field
by field; ``INPUT_SHAPES``, the paper's protocols and the protocol
dataclasses' fields and defaults equal; ``nn.modules.tree_bytes`` equal to
the reference's on converted params (fig. 4 reports it)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.configs import paper_small as jax_paper  # noqa: E402
from repro.nn.modules import tree_bytes as jax_tree_bytes  # noqa: E402
from repro.nn.vision import get_vision_model as jax_vision  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch.configs import paper_small  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.nn.modules import tree_bytes, tree_map  # noqa: E402

ARCHS = jax_configs.list_archs()


def _fields(cfg):
    return dataclasses.asdict(cfg)


def test_same_registered_names():
    assert configs.list_archs() == ARCHS
    assert configs.ASSIGNED_ARCHS == jax_configs.ASSIGNED_ARCHS
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("name", ARCHS)
def test_arch_config_and_derived_equal(name):
    ours, theirs = configs.get_config(name), jax_configs.get_config(name)
    assert _fields(ours) == _fields(theirs)
    assert ours.param_counts() == theirs.param_counts()
    assert [_fields(s) for s in ours.layout()] == \
        [_fields(s) for s in theirs.layout()]
    assert ours.pattern_plan() == theirs.pattern_plan()
    for attr in ("resolved_head_dim", "d_inner", "resolved_dt_rank"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr


@pytest.mark.parametrize("name", ARCHS)
def test_proxy_of_and_smoke_variant_equal(name):
    ours, theirs = configs.get_config(name), jax_configs.get_config(name)
    for fn in ("proxy_of", "smoke_variant"):
        a = getattr(configs, fn)(ours)
        b = getattr(jax_configs, fn)(theirs)
        assert _fields(a) == _fields(b), fn
        assert a.param_counts() == b.param_counts(), fn
    small = configs.proxy_of(ours, n_layers=2, d_model=256)
    assert _fields(small) == _fields(
        jax_configs.proxy_of(theirs, n_layers=2, d_model=256))


def test_shapes_protocols_and_config_defaults_equal():
    assert {k: _fields(v) for k, v in configs.INPUT_SHAPES.items()} == \
        {k: _fields(v) for k, v in jax_configs.INPUT_SHAPES.items()}
    for cls in ("DPConfig", "ProxyFLConfig", "ModelConfig", "LayerSpec",
                "MoEConfig", "MLAConfig", "MambaConfig"):
        assert _fields(getattr(configs, cls)()) == \
            _fields(getattr(jax_configs, cls)()), cls
    for fn in ("paper_benchmark_protocol", "paper_histo_protocol"):
        assert _fields(getattr(paper_small, fn)(rounds=3)) == \
            _fields(getattr(jax_paper, fn)(rounds=3))
    assert {k: _fields(v) for k, v in paper_small.DATASETS.items()} == \
        {k: _fields(v) for k, v in jax_paper.DATASETS.items()}


@pytest.mark.parametrize("arch", ["mlp", "lenet5"])
def test_tree_bytes_equal_on_converted_params(arch):
    """Fig. 4's two paper-scale models on MNIST geometry, f32 and bf16."""
    params = jax_vision(arch).init(jax.random.PRNGKey(0), (28, 28, 1), 10)
    ported = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    assert tree_bytes(ported) == jax_tree_bytes(params)
    half = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), params)
    assert tree_bytes(tree_map(lambda x: x.to(torch.bfloat16), ported)) == \
        jax_tree_bytes(half)

"""The port's ``matmul_flops`` of one client's DML train step (DP on)
with ``StepOptions.remat`` against the reference's dot and conv FLOPs of
the same step, on every registered arch's smoke variant (the helpers:
``tests/test_torch_cost.py``; remat off: ``test_torch_cost_train.py``).

Both recompute the same: each repeat's layers but the last layer's
trailing projections (the reference's ``jax.checkpoint`` drops what no
gradient reads), and, inside, each KV chunk's scores again.
"""
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.configs import list_archs  # noqa: E402
from test_torch_cost import port_cost, reference_flops  # noqa: E402


@pytest.mark.parametrize("arch", list_archs())
def test_remat_train_matmul_flops_equal_the_reference(arch):
    assert port_cost(arch, "train", True)["matmul_flops"] \
        == reference_flops(arch, "train", True)

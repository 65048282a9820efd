"""The port's ``matmul_flops`` of one client's DML train step (DP on,
remat off) against the reference's dot and conv FLOPs of the same step,
on every registered arch's smoke variant (the helpers:
``tests/test_torch_cost.py``; remat on: ``test_torch_cost_remat.py``).

Exactly, MoE (arctic, deepseek-v2, jamba) and MLA (deepseek-v2) included:
the port's expert dispatch, capacity slots and latent attention run the
reference's products. Both recompute each KV chunk's scores in the
backward but not its p·v product: the reference checkpoints its chunk
scan body in every differentiated attention, remat or not.
"""
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.configs import list_archs  # noqa: E402
from test_torch_cost import port_cost, reference_flops  # noqa: E402


@pytest.mark.parametrize("arch", list_archs())
def test_train_matmul_flops_equal_the_reference(arch):
    assert port_cost(arch, "train", False)["matmul_flops"] \
        == reference_flops(arch, "train", False)

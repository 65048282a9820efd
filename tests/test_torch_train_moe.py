"""The port's LLM train step against the JAX package's for the MLA + MoE
deepseek-v2-236b smoke variant, in f32 at ``close`` and as registered
(bf16) normwise within 2e-2, its expert choices pinned to the reference's:
the grades and set-up of ``test_torch_train_step.py``, in a file of its
own for its reference compile time."""
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_train_step import check_step  # noqa: E402


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_moe_train_step_matches_reference(dtype):
    check_step("deepseek-v2-236b", dtype)

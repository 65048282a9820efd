"""The port's LLM train step against the JAX package's for the hybrid
(attention + mamba + MoE) jamba-1.5-large-398b smoke variant, in f32 at
``close`` and as registered (bf16) normwise within 2e-2: the grades and
set-up of ``test_torch_train_step.py`` (in bf16 with the expert choices
pinned to the reference's: one token's choice flips at a near tie), in a
file of its own for its reference compile time."""
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_train_step import check_step  # noqa: E402


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_train_step_matches_reference(dtype):
    check_step("jamba-1.5-large-398b", dtype)

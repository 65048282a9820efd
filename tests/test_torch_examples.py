"""The port's examples (``examples/torch_*.py``), each the counterpart of a
reference example, run on the CPU with ``--device cpu`` at a cut size in a
process of its own: each finishes, prints what its reference example
prints, names the device, and imports nothing of jax or the JAX
package."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = {
    "torch_quickstart": (["--rounds", "1"],
                         ["method      test-acc   epsilon", "proxyfl ",
                          "joint ", "resumed from round 1/1",
                          "top-k compressed exchange",
                          "hier backend, 2 shards"]),
    "torch_heterogeneous_archs": (["--rounds", "1", "--per-client", "60"],
                                  ["client arch", "mlp ", "lenet5 ",
                                   "cnn1 ", "cnn2 "]),
    "torch_serve_demo": ([], ["[serve] gemma3-4b-smoke: prefill B=4 S=32",
                              "[serve] decoded 7 steps x batch 4",
                              "sample tokens"]),
    "torch_llm_proxyfl": (["--arch", "qwen1.5-4b", "--smoke", "--rounds",
                           "1", "--steps-per-round", "1", "--batch", "2",
                           "--seq", "16", "--backend", "hier",
                           "--n-shards", "2"],
                          ["[train] private=qwen1.5-4b-smoke",
                           "backend=hier", "[round 1/1]"]),
}


def test_every_reference_example_has_a_port():
    ref = {p.stem for p in (ROOT / "examples").glob("*.py")
           if not p.stem.startswith("torch_")}
    assert {f"torch_{name}" for name in ref} == set(EXAMPLES)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    args, expected = EXAMPLES[name]
    probe = ("import runpy, sys; sys.argv = sys.argv[1:]; "
             "runpy.run_path(sys.argv[0], run_name='__main__')")
    guard = ("import sys; sys.modules['jax'] = None; "
             "sys.modules['repro'] = None; ")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", guard + probe,
         str(ROOT / "examples" / f"{name}.py"), "--device", "cpu", *args],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    text = out.stdout
    assert "the CPU" in text
    for line in expected:
        assert line in text, (line, text[-2000:])

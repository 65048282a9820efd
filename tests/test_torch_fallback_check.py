"""chip_smoke.py's check of ``dp_adam_update``'s non-f32 fallback sees the
faults it is there to see. On the CPU the kernel wrappers run their plain
versions through the same flat glue, so a fault planted in what the glue
hands the kernels (the clip scales, the noise add, the rows' layout, the
accumulated sum) reaches the check as a kernel fault would on the card.
The check must pass on the code as it is and fail on each planted fault.

Sizes: the mlp on 14x14x1 images, 10 classes, B = 16.
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.core import dp  # noqa: E402
from repro_torch.core.protocol import ModelSpec  # noqa: E402
from repro_torch.data.synthetic import make_classification_data  # noqa: E402
from repro_torch.nn.vision import get_vision_model  # noqa: E402

SHAPE, N_CLASSES, B = (14, 14, 1), 10, 16


@pytest.fixture(scope="module")
def chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_checks", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def inputs():
    vm = get_vision_model("mlp")
    spec = ModelSpec("mlp", lambda g: vm.init(g, SHAPE, N_CLASSES),
                     vm.apply)
    x, y = make_classification_data(torch.Generator().manual_seed(0), B,
                                    SHAPE, N_CLASSES, sep=2.5, task_seed=7)
    return spec, x, y


def _faults():
    rows, vector = dp.clip_accumulate_rows, dp.scale_accumulate
    return {
        "clip off": ("clip_accumulate_rows",
                     lambda g, s: rows(g, torch.ones_like(s))),
        "noise dropped": ("scale_accumulate",
                          lambda acc, g, s: vector(acc, g, 0.0 * s)),
        "rows shifted": ("clip_accumulate_rows",
                         lambda g, s: rows(torch.roll(g, 1, dims=1), s)),
        "zero gradient": ("clip_accumulate_rows",
                          lambda g, s: 0.0 * rows(g, s)),
    }


def _run(chip_smoke, monkeypatch, inputs):
    monkeypatch.setattr(chip_smoke, "counted", lambda fn: (fn(), {}))
    monkeypatch.setattr(chip_smoke, "expect", lambda *a, **k: None)
    return chip_smoke.dp_adam_fallback_check(*inputs, device="cpu")


def test_fallback_check_passes_the_code_as_it_is(chip_smoke, monkeypatch,
                                                 inputs):
    out = _run(chip_smoke, monkeypatch, inputs)
    assert sorted(out) == ["bfloat16", "float32"]
    for moments, (_, worst, errs, fault_errs) in out.items():
        tol = chip_smoke.FALLBACK_NORM_TOL[moments]
        assert worst <= 2e-2 and max(errs) <= tol
        assert min(fault_errs.values()) > 10 * tol


@pytest.mark.parametrize("fault", sorted(_faults()))
def test_fallback_check_fails_a_planted_fault(chip_smoke, monkeypatch,
                                              inputs, fault):
    name, fn = _faults()[fault]
    monkeypatch.setattr(dp, name, fn)
    with pytest.raises(AssertionError):
        _run(chip_smoke, monkeypatch, inputs)

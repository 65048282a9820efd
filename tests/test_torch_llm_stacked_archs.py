"""The stacked LLM round against the loop for the smoke variant of every
registry name, on the CPU.

Each architecture's smoke variant in f32 (the conformance grade's dtype;
the registry's bf16 rounds batched products otherwise), K = 2, B = 2, S =
16, DP on: one round of the loop warms the clients' Adam moments (a first
Adam step takes lr·g/(|g| + ε), so a last-bit gradient difference on a
leaf whose gradient is ~0, as a key bias's, becomes a step of ±lr), then
one round of 2 steps from that state on ``--backend vmap`` (the stacked
executor) and on ``--backend loop``, with the kernels on and off. Every
leaf and loss at the conformance ``close`` grade (atol 1e-5, rtol 1e-4),
but that the params and Adam moments may hold at most 5 in 10⁷ of their
coordinates past it (the card's budget for stacked against per-client
steps: batched products round otherwise); epsilon equal. Then each
variant in its own bf16, step by step against the loop's client step at
the bf16 grade (:func:`test_bf16_stacked_steps_against_the_loop`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.configs import (get_config, list_archs,  # noqa: E402
                                 proxy_of, smoke_variant)
from repro_torch.launch import train  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402

CLOSE = dict(atol=1e-5, rtol=1e-4)
OUTLIERS_PER_COORD = 5e-7
ARGV = ["--smoke", "--clients", "2", "--rounds", "2", "--steps-per-round",
        "2", "--batch", "2", "--seq", "16", "--device", "cpu"]


@pytest.fixture
def f32_configs(monkeypatch):
    def cfgs(args):
        cfg = smoke_variant(get_config(args.arch)).with_(dtype="float32")
        return cfg, smoke_variant(proxy_of(cfg))
    monkeypatch.setattr(train, "build_cfgs", cfgs)


def _opt_paths(state):
    """Each leaf of a client state list with whether it is a param or an
    Adam moment of a model (the leaves the outlier budget covers)."""
    out = []
    for s in state:
        for key in sorted(s):
            if key in ("private", "proxy"):
                opt = s[key]["opt"]
                out += [(x, True) for x in tree_leaves(s[key]["params"])]
                out += [(x, True) for x in tree_leaves((opt.m, opt.v))]
                out += [(x, False) for x in tree_leaves((opt.t, opt.p32))]
            else:
                out.append((s[key], False))
    return out


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("arch", list_archs())
def test_stacked_round_close_to_the_loop(arch, use_pallas, f32_configs):
    argv = ["--arch", arch] + ARGV + (["--use-pallas"] if use_pallas
                                      else [])
    loop_args = train.parse_args(argv + ["--backend", "loop"])
    run = train.setup(loop_args)
    warm, _ = run.engine.run_rounds(run.state, run.data, 0, 1, 0)
    out = {}
    for backend in ("vmap", "loop"):
        args = train.parse_args(argv + ["--backend", backend])
        eng = train.make_engine(run.cfg, run.proxy, run.fl, args,
                                run.n_seqs, "cpu")
        assert eng.stacked == (backend == "vmap")
        out[backend] = eng.run_rounds(warm, run.data, 1, 1, 0) + (eng,)
    (got, gm, geng), (want, wm, weng) = out["vmap"], out["loop"]
    coords = outliers = 0
    for (a, budget), (b, _) in zip(_opt_paths(got), _opt_paths(want),
                                   strict=True):
        if not a.is_floating_point():
            assert torch.equal(a, b)
            continue
        off = (a - b).abs() > CLOSE["atol"] + CLOSE["rtol"] * b.abs()
        if budget:
            coords += a.numel()
            outliers += int(off.sum())
        else:
            assert not off.any(), (arch, a.shape)
    assert outliers <= OUTLIERS_PER_COORD * coords, (outliers, coords)
    for key in ("private_loss", "proxy_loss"):
        np.testing.assert_allclose(gm[key], wm[key], **CLOSE)
    assert [a.epsilon() for a in geng.accountants] == \
        [a.epsilon() for a in weng.accountants]


BF16 = 2e-2


def _rel(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


@pytest.mark.parametrize("arch", list_archs())
def test_bf16_stacked_steps_against_the_loop(arch):
    """The registry's smoke variant in its own dtype (bf16, f32 master
    params), the kernels on, K = 2, one round of 2 steps from the initial
    state: each batched step of the stacked executor against the loop's
    client step on the same state, batch and noise, client by client, at
    the bf16 grade (2e-2) normwise a leaf: the losses, each leaf's
    gradient g = (m' − b1·m) / (1 − b1) and both Adam moments; the master
    params over the coordinates whose two gradients agree elementwise
    within the grade. The rest are masked and counted: there the gradient
    is a near-cancellation that bf16 rounding dominates (most of an
    attention key bias's, whose gradient sums softmax-gradient rows that
    add to 0, RoPE only partly breaking the cancellation), and Adam, which
    steps every coordinate by about lr whatever its gradient's size,
    turns a different rounding into a different step (up to 2·lr), which
    is all the params' gap on such a leaf. Prints the worst of each
    quantity (``pytest -s``)."""
    from repro_torch.core import engine as eng_mod
    from repro_torch.core.engine import unstack_state
    from repro_torch.nn.modules import tree_map
    args = train.parse_args(["--arch", arch] + ARGV + ["--use-pallas"])
    run = train.setup(args)
    eng = run.engine
    assert eng.stacked and run.cfg.dtype == "bfloat16"
    b1 = 0.9
    worst = dict.fromkeys(("loss", "grad", "m", "v", "params"), 0.0)
    masked = coords = steps = 0
    unmasked = 0.0     # the params' worst without the mask, printed only
    raw = eng_mod.FederationEngine._vstep

    def vstep(self, stacked, batch, noise, step=None):
        nonlocal masked, coords, steps, unmasked
        out = raw(self, stacked, batch, noise, step)
        for k in range(self.K):
            before = unstack_state(stacked, k)
            want, wm = self.step_fns[0](
                before, tree_map(lambda x: x[k], batch), None,
                None if noise is None else noise[k])
            got = unstack_state(out[0], k)
            for key in ("private_loss", "proxy_loss"):
                worst["loss"] = max(worst["loss"], abs(
                    float(out[1][key][k] - wm[key]) / float(wm[key])))
            for role in ("private", "proxy"):
                og, ow, o0 = (s[role]["opt"] for s in (got, want, before))
                assert torch.equal(og.t, ow.t)
                pg, pw = ((o.p32 if o.p32 is not None else s[role]["params"])
                          for o, s in ((og, got), (ow, want)))
                for a, b, ma, mb, m0, va, vb in zip(
                        *(tree_leaves(x) for x in (pg, pw, og.m, ow.m, o0.m,
                                                   og.v, ow.v)),
                        strict=True):
                    ga, gb = ma - b1 * m0, mb - b1 * m0
                    worst["grad"] = max(worst["grad"], _rel(ga, gb))
                    worst["m"] = max(worst["m"], _rel(ma, mb))
                    worst["v"] = max(worst["v"], _rel(va, vb))
                    near = (ga - gb).abs() > BF16 * gb.abs()
                    unmasked = max(unmasked, _rel(a, b))
                    masked += int(near.sum())
                    coords += near.numel()
                    if not near.all():
                        worst["params"] = max(worst["params"],
                                              _rel(a[~near], b[~near]))
            steps += 1
        return out

    eng_mod.FederationEngine._vstep = vstep
    try:
        eng.run_rounds(run.state, run.data, 0, 1, 0)
    finally:
        eng_mod.FederationEngine._vstep = raw
    print(f"{arch}: {steps} client steps, worst normwise "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f"; {masked} of {coords} param coordinates masked (params "
          f"unmasked {unmasked:.3e})")
    assert steps == 2 * 2
    assert all(v <= BF16 for v in worst.values()), worst

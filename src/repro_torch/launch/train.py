"""End-to-end ProxyFL training driver for the LLM path (port of
``src/repro/launch/train.py``).

Runs the protocol across K simulated clients on synthetic non-IID
language-modelling data: each round, every client's local DML steps
(private model without DP, proxy with per-example DP-SGD; Algorithm 1
lines 2–5, :func:`repro_torch.launch.steps.make_train_step`), then the
PushSum exchange of the proxies (lines 7–11), through
:class:`repro_torch.core.engine.FederationEngine`. ``--backend`` ``loop``
and ``vmap`` run the synchronous exchange (this port runs clients one at
a time on either), ``async --staleness T`` the stale one, and ``hier
--n-shards S [--staleness T]`` the two-level one: S shards of clients/S
clients mixing shard-locally (one launch of the shard-grid mix kernel
under ``--use-pallas``) plus at most one cross-shard edge per client, the
cross-shard edges T rounds late. The default
``--preset 100m`` trains a ~120M-parameter private model around a 6.3M
proxy; ``--arch NAME --smoke`` a registry architecture's reduced variant.

    PYTHONPATH=src python -m repro_torch.launch.train --preset 100m \\
        --rounds 10 --use-pallas
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \\
        --smoke --clients 2 --rounds 1 --steps-per-round 1 --batch 2 \\
        --seq 32 --device cpu

runs on the GPU (``--use-pallas``: the exchange's mix kernel, and the
RMSNorm, attention and scan kernels in the forwards no gradient passes
through), or on the CPU with ``--device cpu`` (the kernels' plain
versions). ``--rounds-per-block`` cuts the rounds into blocks as the
reference does (the host evaluates, checkpoints and prints at block
edges); the engine runs a block's rounds one by one (fused blocks:
ROADMAP.md Queue 1 item 5). ``--checkpoint-dir D`` snapshots the
federation every ``--checkpoint-every`` rounds in the reference's files
(:mod:`repro_torch.checkpoint`), and ``--resume`` continues a killed run
from the newest snapshot there, bit for bit:

    PYTHONPATH=src python -m repro_torch.launch.train --preset 100m \
        --rounds 10 --use-pallas --checkpoint-dir ckpt/run0 --resume

    PYTHONPATH=src python -m repro_torch.launch.train --preset 100m \
        --backend hier --n-shards 2 --staleness 2 --use-pallas

``--staleness`` needs ``--backend async`` or ``hier`` and ``--n-shards >
1`` needs ``hier``, with the reference's messages.

Each client's corpus is a token stream from its own bigram chain (domain
= client id), cut into sequences of ``--seq + 1`` tokens; the test stream
mixes all domains. The reference's driver feeds every architecture 2-D
token sequences, so its audio and VLM architectures fail in their first
step; here an audio client's corpus is ``n_codebooks`` tokens a position
and a VLM client's sequences each carry a stub image (N(0, 1) patch
embeddings, as the model's frontend stub takes them).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint import FederationCheckpointer, config_fingerprint
from ..configs import get_config, list_archs, proxy_of, smoke_variant
from ..configs.base import DPConfig, LayerSpec, ModelConfig, ProxyFLConfig
from ..core.accountant import PrivacyAccountant
from ..core.engine import FederationEngine, block_spans, stream_seed
from ..data.synthetic import make_lm_data
from ..nn.losses import cross_entropy
from ..nn.model import forward
from ..nn.modules import torch_dtype
from .serve import device_label
from .steps import StepOptions, init_train_state, make_train_step


def preset_100m(vocab: int = 8192) -> ModelConfig:
    """~100M-parameter dense decoder for the end-to-end example."""
    return ModelConfig(
        name="repro-100m", arch_type="dense", vocab_size=vocab, d_model=768,
        n_layers=12, n_heads=12, n_kv_heads=12, head_dim=64, d_ff=3072,
        pattern=(LayerSpec(),), tie_embeddings=True,
        source="end-to-end driver preset")


def build_cfgs(args):
    if args.preset == "100m":
        cfg = preset_100m()
        proxy = proxy_of(cfg, n_layers=4, d_model=256)
    else:
        cfg = get_config(args.arch)
        if args.smoke:
            cfg = smoke_variant(cfg)
        proxy = smoke_variant(proxy_of(cfg)) if args.smoke else proxy_of(cfg)
    return cfg, proxy


@torch.no_grad()
def evaluate_ppl(params, cfg: ModelConfig, tokens: torch.Tensor,
                 batch: int = 8, *, use_pallas: bool = True) -> float:
    """exp of the mean next-token cross-entropy over batches of
    ``batch`` sequences (text positions only, as the reference's)."""
    losses = []
    for i in range(0, tokens.shape[0], batch):
        t = tokens[i:i + batch]
        logits = forward(params, cfg, t[:, :-1], use_pallas=use_pallas)[0]
        losses.append(float(cross_entropy(logits, t[:, 1:])))
    return float(np.exp(np.mean(losses)))


def lm_set(cfg: ModelConfig, seed: int, n_seqs: int, seq: int,
           domain: int) -> torch.Tensor:
    """``n_seqs`` sequences of ``seq + 1`` tokens of ``domain``'s chain
    (``[n, seq+1, n_codebooks]`` for audio), int32 on the CPU."""
    v = min(cfg.vocab_size, 2048)
    nb = cfg.n_codebooks if cfg.modality == "audio" else 1
    stream = make_lm_data(seed, n_seqs * (seq + 1) * nb, v, domain=domain)
    shape = (n_seqs, seq + 1) + ((nb,) if cfg.modality == "audio" else ())
    return stream.reshape(shape)


def client_data(cfg: ModelConfig, seed: int, n_seqs: int, seq: int,
                domain: int):
    """One client's corpus: its token sequences, and for a VLM a dict of
    them with one stub image [n_image_tokens, frontend_dim] a sequence."""
    toks = lm_set(cfg, stream_seed(seed, 100 + domain), n_seqs, seq, domain)
    if cfg.modality != "vlm":
        return toks
    gen = torch.Generator().manual_seed(stream_seed(seed, 200 + domain))
    img = torch.randn((n_seqs, cfg.n_image_tokens, cfg.frontend_dim),
                      generator=gen).to(torch_dtype(cfg.dtype))
    return {"tokens": toks, "img": img}


def lm_sampler(batch_size: int):
    """Uniform-with-replacement batch draw of sequences, cut into inputs
    and next-token labels; ``idx`` (the replay hook's) replaces the draw."""

    def sample(data_k, generator, idx=None):
        toks = data_k["tokens"] if isinstance(data_k, dict) else data_k
        if idx is None:
            idx = torch.randint(0, toks.shape[0], (batch_size,),
                                generator=generator, device=toks.device)
        batch = {"tokens": toks[idx, :-1], "labels": toks[idx, 1:]}
        if isinstance(data_k, dict):
            batch["img"] = data_k["img"][idx]
        return batch

    return sample


def tree_size_of(cfg: ModelConfig) -> str:
    return f"{cfg.n_layers}L/d{cfg.d_model}"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--preset", choices=("100m",), default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family variant")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps-per-round", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--weight-decay", type=float, default=1e-4)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--no-dp", action="store_true")
    ap.add_argument("--sigma", type=float, default=1.0)
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--topology", default="exponential",
                    choices=("exponential", "ring", "full"))
    ap.add_argument("--backend", default="vmap",
                    choices=("loop", "vmap", "async", "hier"),
                    help="federation engine backend (loop and vmap: the "
                         "synchronous exchange; async: staleness-τ stale "
                         "gossip, see --staleness; hier: two-level cohort "
                         "of --n-shards shards with block-diagonal "
                         "intra-shard mixing and sparse cross-shard edges, "
                         "see --n-shards)")
    ap.add_argument("--staleness", type=int, default=0,
                    help="gossip delay τ for --backend async or hier: the "
                         "round-t exchange merges neighbor proxy mass sent "
                         "τ rounds earlier; with hier only the cross-shard "
                         "edges are delayed; 0 runs the synchronous "
                         "exchange")
    ap.add_argument("--n-shards", type=int, default=1,
                    help="two-level cohort layout for --backend hier: "
                         "n_shards shards of clients/n_shards clients each "
                         "(must divide evenly); 1 keeps every edge "
                         "intra-shard and runs the flat exchange verbatim")
    ap.add_argument("--dropout-rate", type=float, default=0.0,
                    help="per-round client dropout probability (§3.4)")
    ap.add_argument("--min-active", type=int, default=1,
                    help="floor on participating clients per round when "
                         "--dropout-rate > 0")
    ap.add_argument("--rounds-per-block", type=int, default=1,
                    help="rounds between host evaluations (block edges); "
                         "the engine runs a block's rounds one by one")
    ap.add_argument("--size-skew", type=float, default=0.0,
                    help="per-client corpus size skew in [0, 1): client k "
                         "holds ~64*(1-skew)^k sequences")
    ap.add_argument("--use-pallas", action="store_true",
                    help="the hand-written kernels on the card: the "
                         "exchange's mix, and RMSNorm, attention and the "
                         "scan in the forwards no gradient passes through "
                         "(the peers' logits, the evaluation); the "
                         "gradients and the DP step stay plain torch")
    ap.add_argument("--compress", default="none",
                    choices=("none", "topk", "int8"),
                    help="compressed proxy exchange (repro_torch.core."
                         "compress): top-k or int8 deltas against public "
                         "copies with error feedback")
    ap.add_argument("--compress-ratio", type=float, default=0.25,
                    help="top-k kept fraction of the flattened proxy")
    ap.add_argument("--verify-commitments", action="store_true",
                    help="check every received proxy against its sender's "
                         "commitment before mixing (loop backend)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="snapshot complete federation state here (enables "
                         "preemption-tolerant runs; see repro_torch."
                         "checkpoint; the JAX package's files)")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    help="rounds between snapshots (with --checkpoint-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="restart from the newest snapshot in "
                         "--checkpoint-dir (bit-identical continuation)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    if not args.preset and not args.arch:
        args.preset = "100m"
    if args.staleness and args.backend not in ("async", "hier"):
        raise SystemExit("--staleness requires --backend async or hier "
                         "(the synchronous backends deliver every round)")
    if args.n_shards > 1 and args.backend != "hier":
        raise SystemExit("--n-shards > 1 requires --backend hier "
                         "(the flat backends have no shard level)")
    return args


class Run(NamedTuple):
    """A driver run, set up: the configurations, the engine and its
    initial state, each client's corpus and sequence count, the test set."""
    cfg: ModelConfig
    proxy: ModelConfig
    fl: ProxyFLConfig
    engine: FederationEngine
    state: list
    data: list
    n_seqs: list
    test: torch.Tensor


def setup(args) -> Run:
    dev = resolve_device(args.device)
    cfg, proxy = build_cfgs(args)
    K = args.clients
    fl = ProxyFLConfig(
        alpha=args.alpha, beta=args.alpha, n_clients=K, rounds=args.rounds,
        local_steps=args.steps_per_round, lr=args.lr,
        weight_decay=args.weight_decay, batch_size=args.batch,
        topology=args.topology, seed=args.seed,
        dropout_rate=args.dropout_rate, min_active=args.min_active,
        staleness=args.staleness, n_shards=args.n_shards,
        use_pallas=args.use_pallas,
        compress=args.compress, compress_ratio=args.compress_ratio,
        verify_commitments=args.verify_commitments,
        dp=DPConfig(enabled=not args.no_dp, clip_norm=args.clip,
                    noise_multiplier=args.sigma))

    # non-IID synthetic LM data: each client's stream comes from its own
    # bigram chain (domain = client id); the test stream mixes all domains
    n_seqs = [max(args.batch, int(round(64 * (1.0 - args.size_skew) ** k)))
              for k in range(K)]
    data: List = [client_data(cfg, args.seed, n_seqs[k], args.seq, k)
                  for k in range(K)]
    test = torch.cat([
        lm_set(cfg, stream_seed(args.seed, 999 + k), max(1, 32 // K),
               args.seq, k) for k in range(K)]).to(dev)
    data = [{key: x.to(dev) for key, x in d.items()} if isinstance(d, dict)
            else d.to(dev) for d in data]

    engine = make_engine(cfg, proxy, fl, args, n_seqs, dev)
    return Run(cfg, proxy, fl, engine, engine.init_states(args.seed), data,
               n_seqs, test)


def make_engine(cfg: ModelConfig, proxy: ModelConfig, fl: ProxyFLConfig,
                args, n_seqs: List[int], device) -> FederationEngine:
    """The driver's engine over ``make_train_step`` (one microbatch, one DP
    chunk of the batch), with an accountant per client under DP."""
    opts = StepOptions(accum=1, dp_chunk=args.batch)
    engine = FederationEngine(
        fl, n_clients=args.clients,
        step_fns=make_train_step(cfg, proxy, fl, opts),
        init_fns=lambda gen: init_train_state(gen, cfg, proxy, fl, opts),
        sample_fn=lm_sampler(args.batch), backend=args.backend,
        mix="pushsum", device=device)
    if not args.no_dp:
        # DP sample rate q = B / n_local from each client's own corpus
        engine.attach_accountants([
            PrivacyAccountant(args.sigma, min(1.0, args.batch / n), 1e-5)
            for n in n_seqs])
    return engine


def checkpointer(run: Run, args) -> Optional[FederationCheckpointer]:
    """The run's checkpointer under ``--checkpoint-dir`` (None without
    it), fingerprinted as the reference's driver does: the protocol
    config, the architectures, the cohort size and the corpus skew."""
    if not args.checkpoint_dir:
        return None
    return FederationCheckpointer(
        args.checkpoint_dir, every=args.checkpoint_every,
        fingerprint=config_fingerprint(
            run.fl, arch=run.cfg.name, proxy=run.proxy.name,
            clients=args.clients,
            # data-shaping flag: resuming under a different skew would
            # silently continue on a different cohort
            size_skew=args.size_skew),
        verify=run.fl.verify_commitments)


def train(args):
    """The driver's run: set-up, the resume from ``--checkpoint-dir`` when
    asked, the rounds in blocks (evaluation, snapshot and the round lines
    at block edges). Returns the run and its final state."""
    run = setup(args)
    cfg, proxy, fl, engine, state = run[:5]
    K = args.clients
    print(f"[train] private={cfg.name} ({tree_size_of(cfg)} params approx: "
          f"{cfg.param_counts()['total']/1e6:.1f}M)  proxy={proxy.name} "
          f"({proxy.param_counts()['total']/1e6:.1f}M)  clients={K} "
          f"backend={args.backend}  device={device_label(engine.device)}")

    ckpt = checkpointer(run, args)
    start = 0
    if ckpt is not None and args.resume:
        t0 = time.perf_counter()
        # the run's own state is the template: a throwaway one would cost
        # another set of K models at LLM sizes
        restored = ckpt.restore_latest(engine, like=state, seed=args.seed)
        if restored is not None:
            state, start = restored
            print(f"[train] resumed from {args.checkpoint_dir} at round "
                  f"{start} (verified and restored in "
                  f"{time.perf_counter() - t0:.3f} s)")

    # the host evaluates, checkpoints and prints at block edges, and every
    # checkpoint-cadence round is a block edge
    for t, n_block in block_spans(start, args.rounds, args.rounds_per_block,
                                  ckpt.every if ckpt is not None else 0):
        t0 = time.time()
        state, metrics = engine.run_rounds(state, run.data, t, n_block,
                                           args.seed)
        if ckpt is not None:
            t1 = time.perf_counter()
            base = ckpt.maybe_save(engine, state, t + n_block - 1,
                                   seed=args.seed)
            if base is not None:
                print(f"[train] saved {os.path.basename(base)} "
                      f"({os.path.getsize(base + '.npz')} bytes) in "
                      f"{time.perf_counter() - t1:.3f} s")
        dt = time.time() - t0
        ppl = evaluate_ppl(engine.client_params(state, 0, "private"), cfg,
                           run.test, use_pallas=fl.use_pallas)
        # worst case over clients: under --size-skew the smallest client
        # has the largest sample rate and spends epsilon fastest
        eps = max((a.epsilon() for a in engine.accountants if a is not None),
                  default=float("nan"))
        for i in range(n_block):
            n_active = int(np.sum(~np.isnan(metrics["private_loss"][i])))
            line = (f"[round {t+i+1}/{args.rounds}] "
                    f"private_loss={np.nanmean(metrics['private_loss'][i]):.4f} "
                    f"proxy_loss={np.nanmean(metrics['proxy_loss'][i]):.4f} "
                    f"active={n_active}/{K} ")
            if i == n_block - 1:  # block edge: host-synced ppl/eps/time
                line += f"client0_test_ppl={ppl:.2f} eps={eps:.3f} ({dt:.1f}s)"
            print(line)
    return run, state


def main(argv=None) -> int:
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

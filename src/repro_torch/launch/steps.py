"""ProxyFL steps on the LLM stack (port of ``src/repro/launch/steps.py``):
one client's training step (Algorithm 1 lines 2–5) and the serving steps
on its private model (the paper: "after training, a client's private
model can be used for inference").

Training
--------
:func:`init_train_state` builds one client's state ``{"private":
{"params", "opt"}, "proxy": {"params", "opt"}, "w", "t"}`` (the
reference's layout) and :func:`make_train_step` its local DML step,
``step(state, batch, generator=None, noise=None) -> (state, metrics)``, the
engine's contract: the private model takes a plain Adam step on Eq. (4),
the proxy a DP-SGD Adam step on Eq. (5) with per-example clipping (Eq. 7,
``core.dp.dp_gradient_chunked``). ``noise`` is the proxy's flat N(0, 1)
draws (absent: drawn from ``generator``). The step reads no tensor value
on the host and allocates no shape from one, so the stacked executor of
``repro_torch.core.engine`` runs it under ``torch.func.vmap`` over the
cohort (no generator; each client's batch and noise drawn before the
round), as the reference's engine runs it under ``jax.vmap``, and on a
CUDA device captures the round into a CUDA graph. Adam's f32 master copy
(``AdamState.p32``) rides in the state and the exchange leaves it
unmixed, on both executors, as the reference's does.

The peer logits take no gradient (θ₀ and φ₀ are constants of the step),
so they are computed outside every gradient transform, under
``torch.no_grad()``: the proxy peer once per microbatch of the private
loss, the private peer once per DP chunk (``prepare_chunk``). There, with
``fl.use_pallas``, the model runs its RMSNorm, attention and scan kernels
(vmapped over a cohort, their client routes: one launch a call for the
K clients).
The forwards a gradient passes through run the model's plain path
(``use_pallas=False``): the kernels have no backward, and the reference
trains through XLA's autodiff of its plain path.

Rounds on a mesh
----------------
The reference's multi-pod round programs, on a ``torch.distributed``
process group: the mesh is a ``DeviceMesh`` with a ``"pod"`` dim, and
every rank (pod) calls the program on what it holds.
:func:`make_fl_round_step` and :func:`make_round_block_step` hold one
client a pod: its local DML step (:func:`make_train_step`), then the
PushSum exchange of the flat proxy with the pod the round's shift ahead
(:func:`repro_torch.core.gossip.pushsum_gossip_shard`, one send/recv),
then the de-bias. :func:`make_hier_round_block_step` holds L clients a
pod, stepped at once (:func:`repro_torch.core.engine.vmap_step`, the
kernels' client routes), and factors each round's P(t) as the hier
backend does: an [L, L] intra-pod matmul, and the cross-pod edge as at
most two send/recv of the [L, D] pod block. The per-round schedules are
fixed on the host, as the reference's are static at trace time. A round
takes each client's batch and its DP noise (absent: drawn from a
generator, one-client programs only), so a test can replay the
reference's draws.

Serving
-------
A serving step takes a state ``{"params", "cache"}`` and a batch and
returns the state and the last position's logits. The cache is written in
place (the returned state holds the same tensors). ``use_pallas`` runs
the RMSNorm, attention and scan kernels where they compute the model's
function (``nn.model``); False runs the model's plain path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from ..configs.base import InputShape, ModelConfig, ProxyFLConfig
from ..core.dp import dp_gradient_chunked, non_dp_gradient
from ..core.engine import vmap_step
from ..core.gossip import (gossip_shift, hier_mix_schedule,
                           pushsum_gossip_shard)
from ..nn.losses import dml_loss
from ..nn.model import forward, init_cache, init_model
from ..nn.modules import (ShapeOnly, torch_dtype, tree_flatten_vector,
                          tree_leaves, tree_map, tree_unflatten_vector)
from ..optim import Adam

POD = "pod"


@dataclass(frozen=True)
class StepOptions:
    """Implementation knobs of the steps. ``remat`` rematerializes each
    repeat of the layer pattern in the forwards a gradient passes through
    (``nn.model.forward``); the train and serve drivers pin it off, as the
    reference's do. The reference's mesh fields (``shard_acts``,
    ``expert_parallel`` and ``serve_2d``, GSPMD placements) wait for
    ROADMAP.md Queue 1 item 12b, their DTensor / FSDP / TP form."""

    remat: bool = True            # rematerialize the layer-stack repeats
    accum: int = 8                # private-grad microbatch accumulation chunks
    dp_chunk: int = 8             # examples per DP vmap chunk
    moment_dtype: str = "float32"  # Adam m/v dtype ("bfloat16" halves them)
    kv_chunk: int = 1024          # online-softmax KV chunk length
    mamba_chunk: int = 256        # chunked-scan block length


# ---------------------------------------------------------------------------
# step shapes on the meta device (the reference's ShapeDtypeStruct trees)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape, *,
                n_clients: int = 0) -> Dict[str, torch.Tensor]:
    """A step's inputs at ``shape`` as empty ``meta`` tensors, with the
    reference's keys, shapes and dtypes (int32 token ids; a VLM's patch
    embeddings in the model's dtype; a decode step's ``pos`` an int32
    scalar). With ``n_clients`` > 0 a leading client dim is added."""
    B, S = shape.global_batch, shape.seq_len
    lead = (n_clients,) if n_clients else ()

    def tok(shape_):
        return _meta(lead + shape_, torch.int32)

    def img():
        return _meta(lead + (B, cfg.n_image_tokens, cfg.frontend_dim),
                     torch_dtype(cfg.dtype))

    audio = cfg.modality == "audio"
    if shape.kind == "train":
        dims = (B, S, cfg.n_codebooks) if audio else (B, S)
        specs = {"tokens": tok(dims), "labels": tok(dims)}
        if cfg.modality == "vlm":
            specs["img"] = img()
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": tok((B, S, cfg.n_codebooks) if audio else (B, S))}
        if cfg.modality == "vlm":
            specs["img"] = img()
        return specs
    if shape.kind == "decode":
        return {"tokens": tok((B, 1, cfg.n_codebooks) if audio else (B, 1)),
                "pos": _meta(lead, torch.int32)}
    raise ValueError(shape.kind)


def train_state_shapes(cfg_priv: ModelConfig, cfg_proxy: ModelConfig,
                       fl: ProxyFLConfig,
                       opts: StepOptions = StepOptions()) -> Dict:
    """:func:`init_train_state`'s tree as empty ``meta`` tensors (built by
    the same code, drawing nothing: ``nn.modules.ShapeOnly``)."""
    return init_train_state(ShapeOnly(), cfg_priv, cfg_proxy, fl, opts)


def serve_state_shapes(cfg: ModelConfig, shape: InputShape) -> Dict:
    """:func:`init_serve_state`'s tree as empty ``meta`` tensors."""
    return init_serve_state(ShapeOnly(), cfg, shape)


def init_train_state(generator: torch.Generator, cfg_priv: ModelConfig,
                     cfg_proxy: ModelConfig, fl: ProxyFLConfig,
                     opts: StepOptions = StepOptions()) -> Dict:
    """One client's random private and proxy models (drawn in that order
    from ``generator``, on its device) with their Adam states."""
    opt = Adam(lr=fl.lr, weight_decay=fl.weight_decay,
               moment_dtype=opts.moment_dtype)
    phi = init_model(generator, cfg_priv)
    theta = init_model(generator, cfg_proxy)
    dev = generator.device
    return {
        "private": {"params": phi, "opt": opt.init(phi)},
        "proxy": {"params": theta, "opt": opt.init(theta)},
        "w": torch.ones((), dtype=torch.float32, device=dev),
        "t": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _text_logits(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Drop image-position logits so labels align with text tokens."""
    if cfg.modality == "vlm" and cfg.n_image_tokens:
        return logits[:, cfg.n_image_tokens:]
    return logits


def _forward_logits(params, cfg: ModelConfig, batch: Dict,
                    opts: StepOptions, *, use_pallas: bool):
    logits, _, aux = forward(params, cfg, batch["tokens"], batch.get("img"),
                             remat=opts.remat, kv_chunk=opts.kv_chunk,
                             mamba_chunk=opts.mamba_chunk,
                             use_pallas=use_pallas)
    return _text_logits(cfg, logits), aux


def make_train_step(cfg_priv: ModelConfig, cfg_proxy: ModelConfig,
                    fl: ProxyFLConfig, opts: StepOptions = StepOptions()):
    """One client's local DML step (module docstring). A batch is a dict
    ``{"tokens", "labels"[, "img"]}`` with a leading batch dim B, a
    multiple of ``opts.accum`` and, under DP, of ``opts.dp_chunk``."""
    opt = Adam(lr=fl.lr, weight_decay=fl.weight_decay,
               moment_dtype=opts.moment_dtype)
    kernels = fl.use_pallas

    def step(state, batch, generator=None, noise=None):
        phi0 = state["private"]["params"]
        theta0 = state["proxy"]["params"]

        # ---- private model: Eq. (4), non-DP, microbatch-accumulated; the
        # proxy peer's logits once per microbatch, without a gradient
        def add_proxy_peer(mb):
            peer, _ = _forward_logits(theta0, cfg_proxy, mb, opts,
                                      use_pallas=kernels)
            return dict(mb, peer=peer)

        def ploss(phi, mb):
            own, aux = _forward_logits(phi, cfg_priv, mb, opts,
                                       use_pallas=False)
            return dml_loss(own, mb["peer"], mb["labels"], fl.alpha) + aux

        g_phi, m_phi = non_dp_gradient(ploss, phi0, batch, accum=opts.accum,
                                       prepare=add_proxy_peer)

        # ---- proxy model: Eq. (5) with per-example DP-SGD (Eq. 7); the
        # private peer's logits once per DP chunk, one batched forward
        def add_peer(cb):
            peer, _ = _forward_logits(phi0, cfg_priv, cb, opts,
                                      use_pallas=kernels)
            return dict(cb, peer=peer)

        def xloss(theta, ex):
            own, aux = _forward_logits(theta, cfg_proxy, ex, opts,
                                       use_pallas=False)
            return dml_loss(own, ex["peer"], ex["labels"], fl.beta) + aux

        if fl.dp.enabled:
            g_theta, m_theta = dp_gradient_chunked(
                xloss, theta0, batch, clip_norm=fl.dp.clip_norm,
                noise_multiplier=fl.dp.noise_multiplier,
                chunk=opts.dp_chunk, prepare_chunk=add_peer, noise=noise,
                generator=generator)
        else:
            g_theta, m_theta = non_dp_gradient(
                xloss, theta0, batch, accum=opts.accum, prepare=add_peer)

        phi1, opt_phi1 = opt.update(g_phi, state["private"]["opt"], phi0)
        theta1, opt_theta1 = opt.update(g_theta, state["proxy"]["opt"],
                                        theta0)
        new_state = {
            "private": {"params": phi1, "opt": opt_phi1},
            "proxy": {"params": theta1, "opt": opt_theta1},
            "w": state["w"],
            "t": state["t"] + 1,
        }
        return new_state, {"private_loss": m_phi["loss"],
                           "proxy_loss": m_theta["loss"]}

    return step


# ---------------------------------------------------------------------------
# rounds on a mesh: one client (or one shard of clients) per pod


def _from_pods_back(offsets, tensors, group, n_pods: int):
    """For each offset, every pod's ``tensors`` delivered to the pod that
    offset ahead: this pod gets pod (p − offset)'s. An offset ≡ 0 (mod
    n_pods) is the pod's own, no traffic; the rest go in one
    ``batch_isend_irecv``. Returns one list of tensors an offset."""
    import torch.distributed as dist
    me = dist.get_rank(group)
    out, ops = [], []
    for off in offsets:
        if off % n_pods == 0:
            out.append(list(tensors))
            continue
        dst = dist.get_global_rank(group, (me + off) % n_pods)
        src = dist.get_global_rank(group, (me - off) % n_pods)
        got = [torch.empty_like(x) for x in tensors]
        ops += [dist.P2POp(dist.isend, x.contiguous(), dst, group)
                for x in tensors]
        ops += [dist.P2POp(dist.irecv, x, src, group) for x in got]
        out.append(got)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def make_fl_round_step(cfg_priv: ModelConfig, cfg_proxy: ModelConfig,
                       fl: ProxyFLConfig, mesh, n_clients: int,
                       opts: StepOptions = StepOptions(), round_t: int = 0):
    """A full Algorithm-1 round with one client per pod of ``mesh``'s
    ``"pod"`` dim (``n_clients`` pods): ``round_step(state, batch,
    noise=None, generator=None) -> (state, metrics)`` on each pod's own
    client, its local DML step and then the PushSum exchange of its flat
    proxy with the pod the round's shift ahead, self weight ½, de-biased
    by ``max(w, 1e-9)``. ``round_t`` fixes the round's shift."""
    dml = make_train_step(cfg_priv, cfg_proxy, fl, opts)
    group = mesh.get_group(POD)

    def round_step(state, batch, noise=None, generator=None):
        new, metrics = dml(state, batch, generator, noise)
        theta = new["proxy"]["params"]
        flat = tree_flatten_vector(theta)[None]
        w = new["w"].reshape(1)
        mixed, w2 = pushsum_gossip_shard(flat, w, round_t, group, n_clients,
                                         fl.topology, 0.5)
        unb = mixed / torch.clamp_min(w2, 1e-9)[:, None]
        new = dict(new, w=w2[0].to(new["w"].dtype))
        new["proxy"] = dict(new["proxy"],
                            params=tree_unflatten_vector(unb[0], theta))
        return new, metrics

    return round_step


def _stack_rows(rows):
    return {k: torch.stack([m[k] for m in rows]) for k in rows[0]}


def make_round_block_step(cfg_priv: ModelConfig, cfg_proxy: ModelConfig,
                          fl: ProxyFLConfig, mesh, n_clients: int,
                          opts: StepOptions = StepOptions(),
                          n_rounds: int = 4, t0: int = 0):
    """``n_rounds`` rounds of :func:`make_fl_round_step`, rounds ``t0 ..
    t0+n_rounds-1`` with their own shifts: ``block_step(state, batch,
    noises=None, generators=None)``, one batch for every round (as in the
    reference), ``noises[i]`` / ``generators[i]`` round i's; the metrics
    stacked to [n_rounds]. Equal to n_rounds separate round steps bit for
    bit: it is them."""
    rounds = [make_fl_round_step(cfg_priv, cfg_proxy, fl, mesh, n_clients,
                                 opts, round_t=t0 + i)
              for i in range(n_rounds)]

    def block_step(state, batch, noises=None, generators=None):
        rows = []
        for i, round_step in enumerate(rounds):
            state, m = round_step(
                state, batch, None if noises is None else noises[i],
                None if generators is None else generators[i])
            rows.append(m)
        return state, _stack_rows(rows)

    return block_step


def make_hier_round_block_step(cfg_priv: ModelConfig, cfg_proxy: ModelConfig,
                               fl: ProxyFLConfig, mesh, n_shards: int,
                               clients_per_shard: int,
                               opts: StepOptions = StepOptions(),
                               n_rounds: int = 4, t0: int = 0):
    """The two-level round-block with one shard of L = ``clients_per_shard``
    clients per pod (``n_shards`` pods): ``block_step(stacked_state,
    stacked_batch, noises=None)`` on each pod's [L, ...] clients, one
    batch for every round, ``noises`` [n_rounds, L, D] under DP. A round
    steps the L clients at once, then factors the flat PushSum P(t)
    (:func:`repro_torch.core.gossip.hier_mix_schedule`): the intra-pod
    [L, L] block as a matmul, and the shift σ(t) = q·L + r as the pod
    blocks of pods q and q + 1 back (at most two send/recv), client j's
    cross edge reading row j − r of the first or row L − r + j of the
    second; then the de-bias by ``max(w, 1e-9)``. Metrics [n_rounds,
    L]."""
    dml = make_train_step(cfg_priv, cfg_proxy, fl, opts)
    group = mesh.get_group(POD)
    S, L = n_shards, clients_per_shard
    K = S * L

    def make_exchange(t):
        shift = gossip_shift(t, K, fl.topology) % K
        if shift == 0:
            return None
        blocks, _, scale = hier_mix_schedule("pushsum", t, 1, K, S,
                                             fl.topology)
        q, r = divmod(shift, L)

        def exchange(x, w):
            import torch.distributed as dist
            p = dist.get_rank(group)
            # the f32 schedule promotes the products, as in the reference
            dt = torch.promote_types(x.dtype, torch.float32)
            x, w = x.to(dt), w.to(dt)
            blk = torch.as_tensor(blocks[0][p], dtype=dt, device=x.device)
            sc = torch.as_tensor(scale[0][p * L:(p + 1) * L], dtype=dt,
                                 device=x.device)
            intra, wm = blk @ x, blk @ w
            got = _from_pods_back([q, q + 1] if r else [q], [x, w], group, S)
            rx, rw = got[0]
            if r:
                rx = torch.cat([got[1][0][L - r:], rx[:L - r]])
                rw = torch.cat([got[1][1][L - r:], rw[:L - r]])
            return intra + sc[:, None] * rx, wm + sc * rw

        return exchange

    exchanges = [make_exchange(t0 + i) for i in range(n_rounds)]

    def block_step(stacked_state, stacked_batch, noises=None):
        rows = []
        for i, ex in enumerate(exchanges):
            new, m = vmap_step(dml, stacked_state, stacked_batch,
                               None if noises is None else noises[i])
            if ex is not None:
                theta = new["proxy"]["params"]
                flat = torch.cat([x.reshape(L, -1)
                                  for x in tree_leaves(theta)], dim=1)
                mixed, w2 = ex(flat, new["w"])
                unb = mixed / torch.clamp_min(w2, 1e-9)[:, None]
                pieces = iter(torch.split(
                    unb, [x[0].numel() for x in tree_leaves(theta)], dim=1))
                theta = tree_map(lambda x: next(pieces).reshape(
                    x.shape).to(x.dtype), theta)
                new = dict(new, w=w2.to(new["w"].dtype))
                new["proxy"] = dict(new["proxy"], params=theta)
            stacked_state = new
            rows.append(m)
        return stacked_state, _stack_rows(rows)

    return block_step


def init_serve_state(generator: torch.Generator, cfg: ModelConfig,
                     shape: InputShape) -> Dict:
    """Random params (on the generator's device) and empty caches for
    ``shape.global_batch`` sequences of ``shape.seq_len`` tokens (plus the
    image tokens of a VLM)."""
    max_len = shape.seq_len + (cfg.n_image_tokens
                               if cfg.modality == "vlm" else 0)
    return {"params": init_model(generator, cfg),
            "cache": init_cache(cfg, shape.global_batch, max_len,
                                device=generator.device)}


def make_prefill_step(cfg: ModelConfig, opts: StepOptions = StepOptions(),
                      *, use_pallas: bool = True):
    def prefill(state, batch):
        logits, cache, _ = forward(state["params"], cfg, batch["tokens"],
                                   batch.get("img"), cache=state["cache"],
                                   pos_offset=0, kv_chunk=opts.kv_chunk,
                                   mamba_chunk=opts.mamba_chunk,
                                   use_pallas=use_pallas)
        return {"params": state["params"], "cache": cache}, logits[:, -1]

    return prefill


def make_decode_step(cfg: ModelConfig, opts: StepOptions = StepOptions(),
                     *, use_pallas: bool = True):
    def decode(state, batch):
        # tokens [B, 1] (or [B, 1, K] audio); pos: the current length (int)
        logits, cache, _ = forward(state["params"], cfg, batch["tokens"],
                                   cache=state["cache"],
                                   pos_offset=int(batch["pos"]),
                                   kv_chunk=opts.kv_chunk,
                                   mamba_chunk=opts.mamba_chunk,
                                   use_pallas=use_pallas)
        return {"params": state["params"], "cache": cache}, logits[:, -1]

    return decode

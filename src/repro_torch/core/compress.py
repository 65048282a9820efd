"""Compressed proxy exchange: top-k and int8 gossip with error feedback
(port of ``src/repro/core/compress.py``).

Each client keeps a PUBLIC COPY ``ẑ_k`` of its vector that every receiver
already holds, transmits a compressed DELTA ``c_k = C(m_k − ẑ_k)`` against
it, and sender and receivers advance the copy in lockstep, ``ẑ'_k = ẑ_k +
c_k``; receivers mix the dense updated copies and de-bias by the
uncompressed PushSum weights. What the codec drops stays in the implicit
residual ``m_k − ẑ'_k`` and is sent in later rounds. Per transmitting
client ``c + (m − ẑ') == m − ẑ`` exactly where the codec sent nothing
(c = 0) and up to one rounding of the copy update elsewhere (the
reference's docstring calls it exact in f32; its tests hold it at 1e-6);
a client that sends nothing this round (a §3.4 dropout, identity column)
keeps its copy bit for bit.

Codecs (wire bytes by :func:`wire_bytes`):

``"topk"``
    The ``k = ratio · D`` largest-magnitude entries of each row, values
    rounded to bf16, positions as a D-bit bitmap. Equal magnitudes go
    lowest index first, as ``jax.lax.top_k`` orders them: the selection is
    a stable sort of ``−|u|`` (``torch.topk`` promises no order among
    ties).
``"int8"``
    Per-row scale ``max|u| / 127``, entries stochastically rounded by a
    given U[0,1) block of u's shape; the engine draws the block from the
    round's codec stream, so the codec itself takes no generator.

The exchanges here are plain torch: the mix kernels implement the
uncompressed chain only, so a compressed exchange runs no kernel whatever
``use_pallas`` says, as in the reference. The numpy oracles of the
reference (``topk_reference``, ``int8_reference``,
``compressed_gossip_reference``) are not copied: the parity tests import
them from the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

# round t's codec noise comes from its own stream, seeded from (seed,
# ROUND_KEY_OFFSET + t, COMPRESS_KEY_FOLD); the word lies far outside the
# client indices 0..K-1 that seed the local-step streams
COMPRESS_KEY_FOLD = 987_654_321

MODES = ("none", "topk", "int8")


@dataclass(frozen=True)
class CompressionSpec:
    """Codec configuration."""

    mode: str = "none"      # "topk" | "int8" ("none" never builds a spec)
    ratio: float = 0.25     # top-k kept fraction of D (int8 ignores it)

    def __post_init__(self):
        assert self.mode in MODES, self.mode
        assert 0.0 < self.ratio <= 1.0, self.ratio


def compress_spec(cfg) -> Optional[CompressionSpec]:
    """``CompressionSpec`` from a ProxyFLConfig, or None for ``"none"``
    (None keeps the engine's uncompressed exchange as it is)."""
    mode = getattr(cfg, "compress", "none") or "none"
    if mode == "none":
        return None
    return CompressionSpec(mode=mode,
                           ratio=float(getattr(cfg, "compress_ratio", 0.25)))


def topk_k(D: int, ratio: float) -> int:
    """Entries kept per client: ``max(1, round(ratio · D))``, capped at D."""
    return max(1, min(int(round(ratio * D)), D))


# ---------------------------------------------------------------------------
# codecs: encode and decode at once (``c`` is what a receiver rebuilds)


def _topk_encode_decode(u: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row top-k by |u| with bf16 wire values, lowest index first among
    equal magnitudes: dense [K, D], zeros at the dropped positions."""
    order = torch.sort(-u.abs(), dim=1, stable=True).indices[:, :k]
    mask = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    mask.scatter_(1, order, True)
    wire = u.to(torch.bfloat16).to(torch.float32)
    return torch.where(mask, wire, torch.zeros((), device=u.device))


def _int8_encode_decode(u: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Per-row-scaled int8 stochastic rounding; ``noise`` ~ U[0,1) of
    u's shape decides each entry's round-up."""
    # a true quotient, as the reference computes it eagerly and its numpy
    # oracle does (under jit XLA folds ``/ 127.0`` into a product with the
    # reciprocal, one ulp off on some rows). The divisor is a tensor on u's
    # device: CUDA turns a division by a host scalar into that product too
    scale = (torch.clamp_min(u.abs().amax(dim=1), 1e-12)
             / torch.full((), 127.0, device=u.device))
    x = u / scale[:, None]
    lo = torch.floor(x)
    q = lo + (noise < (x - lo)).to(torch.float32)
    q = torch.clamp(q, -127.0, 127.0)
    return q * scale[:, None]


def encode_decode(u: torch.Tensor, spec: CompressionSpec,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decoded transmission ``C(u)`` of a stacked f32 [K, D] delta block;
    int8 rounds with ``noise`` (U[0,1) of u's shape), top-k ignores it."""
    if spec.mode == "topk":
        return _topk_encode_decode(u, topk_k(u.shape[1], spec.ratio))
    if spec.mode == "int8":
        if noise is None:
            raise ValueError("the int8 codec needs its U[0,1) noise block")
        return _int8_encode_decode(u, noise)
    raise ValueError(spec.mode)


def wire_bytes(mode: str, D: int, ratio: float = 0.25,
               dtype_bytes: int = 4) -> int:
    """Bytes ONE client puts on the wire for one D-entry message: none, D
    values; topk, a D-bit bitmap and k bf16 values; int8, D bytes and one
    f32 scale. De-bias weights are left out everywhere."""
    if mode == "none":
        return D * dtype_bytes
    if mode == "topk":
        return (D + 7) // 8 + 2 * topk_k(D, ratio)
    if mode == "int8":
        return D + 4
    raise ValueError(mode)


# ---------------------------------------------------------------------------
# compressed exchanges (dispatched from core.gossip)


def _split_P(Pf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    kept = torch.diagonal(Pf).clone()
    sent = Pf.clone()
    sent.fill_diagonal_(0.0)
    return kept, sent


def _ef_encode(m, pub, sent, noise, spec):
    """Message and copy to (decoded delta c, copy'): ``c = C(m − pub)``,
    ``pub' = pub + c`` for clients with off-diagonal column mass; the rest
    send nothing and keep their copy."""
    sends = (sent.sum(dim=0) > 0)[:, None]
    u = m - pub
    zero = torch.zeros((), device=m.device)
    c = torch.where(sends, encode_decode(u, spec, noise), zero)
    # where, not pub + 0: a silent client's copy stays bit for bit (x + 0
    # turns -0.0 into +0.0)
    pub2 = torch.where(sends, pub + c, pub)
    return c, pub2


def compressed_pushsum_mix(flat, w, P, pub, noise, spec: CompressionSpec):
    """Synchronous exchange with delta-coded transmissions: ``z' =
    (kept·z + sent @ (pub + C(z − pub))) / (P·w)``, f32. Returns ``(z', w',
    pub')``; a lossless codec gives the plain ``P @ z`` exchange."""
    f = flat.to(torch.float32)
    Pf = torch.as_tensor(P, dtype=torch.float32, device=flat.device)
    kept, sent = _split_P(Pf)
    c, pub2 = _ef_encode(f, pub, sent, noise, spec)
    mixed = kept[:, None] * f + sent @ pub2
    w2 = Pf @ w.to(torch.float32)
    z2 = mixed / w2[:, None]
    return z2.to(flat.dtype), w2.to(w.dtype), pub2


def compressed_stale_mix(flat, w, kept, sent, buf_t0, buf_w0, pub, noise,
                         spec: CompressionSpec):
    """Stale (async τ>0) exchange with delta-coded transmissions: the copy
    tracks the raw numerator θ = z·w, ``sent @ (pub + C(θ − pub))`` enters
    the in-flight buffer dense, kept mass and deliveries stay exact.
    Returns ``(z', send_t, w', send_w, pub')``; the caller rotates the
    buffer. The de-bias weights are never compressed, so the w-mass of
    clients and buffer is conserved exactly."""
    dev = flat.device
    f = flat.to(torch.float32)
    wf = w.to(torch.float32)
    kept = torch.as_tensor(kept, dtype=torch.float32, device=dev)
    sent = torch.as_tensor(sent, dtype=torch.float32, device=dev)
    theta = f * wf[:, None]
    c, pub2 = _ef_encode(theta, pub, sent, noise, spec)
    send_t = sent @ pub2
    send_w = sent @ wf
    mixed = kept[:, None] * theta + buf_t0.to(torch.float32)
    w2 = kept * wf + buf_w0.to(torch.float32)
    z2 = mixed / w2[:, None]
    return (z2.to(flat.dtype), send_t.to(flat.dtype), w2.to(w.dtype),
            send_w.to(w.dtype), pub2)

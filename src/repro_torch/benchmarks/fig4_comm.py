"""Paper fig. 4 / fig. 13 on the port: communication per round, method ×
compression (port of ``benchmarks/fig4_comm.py``).

Centralized schemes (FedAvg, FML) serialize at the server, O(K);
decentralized PushSum sends exactly one model a client, O(1). The rows
give the analytic link model (bytes over 50 GB/s links) over the real
serialized sizes of the paper reproduction's models (lenet5 private, mlp
proxy, MNIST geometry) and of the LLM-scale proxy (qwen2-7b and its
``proxy_of``, bf16), crossed with the wire formats of
:mod:`repro_torch.core.compress`. The top-k payload of the paper-scale
rows is measured: the nonzero count of a real encode of the initialized
flat parameter vector on the device. The rows are also written as JSON
(``REPRO_BENCH_COMM_JSON``, default ``fig4_comm.json`` in the working
directory) for ``scripts/check_comm_claim.py``, the gate that fails if
ProxyFL's per-client bytes a round ever grow with K.

    python -m repro_torch.benchmarks.fig4_comm [--full] [--device cpu]
    python scripts/check_comm_claim.py fig4_comm.json fig_compress.json

prints one JSON row per (scale, K, method, compression). Quick: K = 4, 8,
32, 128 at paper scale; ``--full`` adds 16 and 64. The LLM rows take K =
8, 64, 512 in both.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import torch

from .. import resolve_device
from ..configs import get_config, proxy_of
from ..core.compress import CompressionSpec, encode_decode, topk_k, wire_bytes
from ..core.gossip import comm_cost_per_round
from ..nn.modules import tree_bytes, tree_flatten_vector
from ..nn.vision import get_vision_model

METHODS = ("proxyfl", "fml", "avgpush", "fedavg", "cwt")
COMPRESS = ("none", "topk", "int8")
RATIO = 0.25  # top-k kept fraction; fig_compress sweeps accuracy at it


def measured_wire_bytes(flat: torch.Tensor, mode: str,
                        ratio: float = RATIO) -> int:
    """Bytes ONE client puts on the wire for one message, measured by
    running the codec on a real flat parameter vector: top-k's payload is
    the nonzero count of the decoded transmission (a position bitmap and 2
    bytes a bf16 value; an entry that rounds to bf16 zero costs its bit but
    ships no value); int8 and none are fixed by construction."""
    D = int(flat.shape[0])
    if mode == "topk":
        c = encode_decode(flat.to(torch.float32)[None, :],
                          CompressionSpec(mode="topk", ratio=ratio))
        nnz = int(torch.count_nonzero(c))
        assert nnz <= topk_k(D, ratio), (nnz, topk_k(D, ratio))
        return (D + 7) // 8 + 2 * nnz
    return wire_bytes(mode, D, ratio)


def _rows_for(scale: str, clients, model_wire, proxy_wire, pb, xb,
              dtype_bytes: int) -> List[Dict]:
    """One row per (K, method, compression mode); bytes_per_round is the
    traffic at the bottleneck node (the server for FedAvg and FML, any one
    client for the decentralized schemes)."""
    rows = []
    for K in clients:
        for m in METHODS:
            for cm in COMPRESS:
                mbw, xbw = model_wire[cm], proxy_wire[cm]
                rows.append({
                    "scale": scale, "clients": K, "method": m,
                    "compress": cm, "dtype_bytes": dtype_bytes,
                    "model_bytes": pb, "proxy_bytes": xb,
                    "wire_model_bytes": mbw, "wire_proxy_bytes": xbw,
                    "bytes_per_round": int(comm_cost_per_round(
                        m, K, mbw, xbw, link_bandwidth=1.0)),
                    "comm_s_per_round": comm_cost_per_round(m, K, mbw, xbw),
                })
    return rows


def init_params(device="cuda"):
    """The paper-scale private (lenet5) and proxy (mlp) params on MNIST
    geometry, from generators seeded 0 and 1 on ``device``."""
    dev = resolve_device(device)
    priv = get_vision_model("lenet5").init(
        torch.Generator(device=dev).manual_seed(0), (28, 28, 1), 10)
    prox = get_vision_model("mlp").init(
        torch.Generator(device=dev).manual_seed(1), (28, 28, 1), 10)
    return priv, prox


def rows_of(priv_params, prox_params, full: bool = False) -> List[Dict]:
    """Fig. 4's rows from given paper-scale params (top-k wire bytes
    measured on their flats) and the registry's LLM configurations."""
    priv_flat = tree_flatten_vector(priv_params)
    prox_flat = tree_flatten_vector(prox_params)
    rows = _rows_for(
        "paper(lenet5/mlp)",
        (4, 8, 16, 32, 64, 128) if full else (4, 8, 32, 128),
        {cm: measured_wire_bytes(priv_flat, cm) for cm in COMPRESS},
        {cm: measured_wire_bytes(prox_flat, cm) for cm in COMPRESS},
        tree_bytes(priv_params), tree_bytes(prox_params), dtype_bytes=4)
    # LLM scale: the common proxy of the assigned archs, analytic param
    # counts, a bf16 full-precision baseline
    cfg = get_config("qwen2-7b")
    proxy = proxy_of(cfg)
    Dp = cfg.param_counts()["total"]
    Dx = proxy.param_counts()["total"]
    rows += _rows_for(
        "llm(qwen2-7b/proxy)", (8, 64, 512),
        {cm: wire_bytes(cm, Dp, RATIO, dtype_bytes=2) for cm in COMPRESS},
        {cm: wire_bytes(cm, Dx, RATIO, dtype_bytes=2) for cm in COMPRESS},
        Dp * 2, Dx * 2, dtype_bytes=2)
    return rows


def run(full: bool = False, device="cuda") -> List[Dict]:
    """The rows from params initialized on ``device``, also written to
    ``REPRO_BENCH_COMM_JSON`` (default ``fig4_comm.json``)."""
    rows = rows_of(*init_params(device), full=full)
    path = os.environ.get("REPRO_BENCH_COMM_JSON", "fig4_comm.json")
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the paper's cohort sizes")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for row in run(args.full, args.device):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()

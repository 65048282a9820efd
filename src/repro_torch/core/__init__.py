"""ProxyFL core of the port (``repro.core`` counterpart).

- ``dp``          DP-SGD per-example clipping + Gaussian noise (Eq. 7)
- ``accountant``  RDP accounting of the sampled Gaussian mechanism (§3.3)
- ``gossip``      PushSum on time-varying directed graphs (§3.4)
- ``protocol``    Algorithm 1: DML client step + gossip round
- ``engine``      FederationEngine: the round executor (loop, vmap, async,
                  hier)
- ``commit``      hash-chained proxy commitments (verifiable federation)
- ``baselines``   FedAvg / FML / AvgPush / CWT / Regular / Joint (§4.1)

The reference's exports, but for ``pushsum_gossip_shard`` (the shard_map
exchange, ROADMAP.md Queue 1 item 12); its jitted ``make_dml_step`` and
``make_ce_step`` are the plain step factories ``dml_step_fn`` and
``ce_step_fn`` here.
"""
from .accountant import PrivacyAccountant, epsilon_for, rdp_sampled_gaussian, rdp_to_eps
from .commit import CommitmentError, chain_step, client_commitment, leaf_digest
from .dp import add_gaussian_noise, clip_by_global_norm, dp_gradient, non_dp_gradient
from .engine import FederationEngine, active_mask, dml_engine, single_model_engine
from .gossip import (
    adjacency_matrix,
    comm_cost_per_round,
    debias,
    exponential_offsets,
    gossip_shift,
    mix_matrix,
    pushsum_mix,
)
from .protocol import (
    ClientState,
    ModelSpec,
    ce_step_fn,
    dml_step_fn,
    evaluate,
    gossip_proxies,
    init_client,
    local_round,
    proxyfl_round,
)
from .baselines import METHODS, final_mean_acc, run_federated

__all__ = [
    "PrivacyAccountant", "epsilon_for", "rdp_sampled_gaussian", "rdp_to_eps",
    "add_gaussian_noise", "clip_by_global_norm", "dp_gradient", "non_dp_gradient",
    "CommitmentError", "chain_step", "client_commitment", "leaf_digest",
    "FederationEngine", "active_mask", "dml_engine", "single_model_engine",
    "adjacency_matrix", "comm_cost_per_round", "debias", "exponential_offsets",
    "gossip_shift", "mix_matrix", "pushsum_mix",
    "ClientState", "ModelSpec", "evaluate", "gossip_proxies", "init_client",
    "local_round", "ce_step_fn", "dml_step_fn", "proxyfl_round",
    "METHODS", "final_mean_acc", "run_federated",
]

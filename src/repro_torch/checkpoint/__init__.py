"""repro_torch.checkpoint — tree checkpoints + per-round federation
snapshots (``repro.checkpoint`` counterpart, the same files).

Two layers:

* :mod:`repro_torch.checkpoint.ckpt` — tree <-> ``.npz`` serialization.
  Leaves live under '/'-joined key paths and are restored BY KEY PATH with
  descriptive missing/unexpected-key errors (never by flatten order).
* :mod:`repro_torch.checkpoint.federation` —
  :class:`FederationCheckpointer`, which snapshots COMPLETE federation
  state every N rounds (per-client engine states incl. optimizer moments,
  PushSum de-bias weights ``w``, the round counter, the base seed's key
  words, DP accountant step counts, and a config fingerprint) and restores
  it bit-exactly.

Checkpoint usage
----------------
Periodic snapshots + resume around a
:class:`repro_torch.core.engine.FederationEngine` round loop::

    from repro_torch.checkpoint import (FederationCheckpointer,
                                        config_fingerprint)

    ckpt = FederationCheckpointer("ckpts/run0", every=5,
                                  fingerprint=config_fingerprint(cfg))
    state = engine.init_states(seed)
    start = 0
    restored = ckpt.restore_latest(engine, like=state, seed=seed)
    if restored is not None:                 # fresh start when None
        state, start = restored              # continue at t = rounds_done
    for t in range(start, cfg.rounds):
        state, _ = engine.run_round(state, data, t, seed)
        ckpt.maybe_save(engine, state, t, seed=seed)

Or let the drivers do it — every entry point threads the same three
knobs:

* ``repro_torch.core.baselines.run_federated(..., checkpoint_dir=..,
  checkpoint_every=.., resume=True)``
* ``python -m repro_torch.launch.train --checkpoint-dir d
  --checkpoint-every 5 --resume``
* ``repro_torch.benchmarks.common.bench_methods(..., checkpoint_dir=..)``
  (env: ``REPRO_BENCH_CKPT_DIR`` / ``REPRO_BENCH_CKPT_EVERY`` /
  ``REPRO_BENCH_RESUME``)

Resume contract: a run killed after round t and resumed from its
checkpoint produces bit-identical final parameters and accountant epsilon
versus the uninterrupted run. State is stored per client in the
reference's layout, so a snapshot restores into a loop or a vmap engine
alike, and a directory the JAX package wrote (same configuration, same
seed) resumes here.
"""
from .ckpt import load_checkpoint, manifest_path, save_checkpoint
from .federation import FederationCheckpointer, config_fingerprint

__all__ = ["FederationCheckpointer", "config_fingerprint",
           "load_checkpoint", "manifest_path", "save_checkpoint"]

"""FederationCheckpointer — per-round snapshots of COMPLETE federation state
(port of ``src/repro/checkpoint/federation.py``).

A federation run is resumable iff five things survive the kill: every
client's state pytree (private model, proxy, optimizer moments), the
PushSum de-bias weights ``w``, the round counter, the run's base seed
the round streams derive from, and each client's DP accountant step
count. This module snapshots all five through
:meth:`repro_torch.core.engine.FederationEngine.save_state` (a per-client
canonical payload, the reference's layout) and restores them bit-exactly,
so a run killed after round t and resumed from its checkpoint produces the
SAME final parameters and epsilon as an uninterrupted run. The files are
the reference's: a snapshot the JAX package wrote restores here, and one
written here restores there.

On-disk layout (one directory per federation)::

    <dir>/round_000002.npz        # all leaves, '/'-joined key paths
    <dir>/round_000002.json       # shape/dtype manifest (inspectable)
    <dir>/round_000002.meta.json  # rounds_done, config fingerprint, ...
    <dir>/LATEST                  # tag of the newest complete snapshot

``LATEST`` is written (atomically) only after the snapshot is fully on
disk, so a kill mid-write can never be resumed from. A config fingerprint
(:func:`config_fingerprint`) is stamped into each snapshot and verified on
restore — resuming under a different protocol configuration raises instead
of silently diverging. ``rounds`` and ``backend`` are excluded from the
fingerprint by default: extending a finished run and switching between the
loop/vmap execution backends are both legitimate resume scenarios.

Commitment chain (verifiable federation)
----------------------------------------
Every snapshot is additionally committed to by the hash chain of
:mod:`repro_torch.core.commit`: ``h_t = H(h_{t-1} || round metadata ||
chunked-leaf digests of each client's released proxy)``, computed from the
canonical arrays the ``.npz`` stores (backend-invariant by construction).
``.meta.json`` records ``commitment``/``prev_commitment`` and the
append-only ``audit.jsonl`` in the federation directory records one entry
per snapshot — per-client commitments AND per-leaf digests, so the trail
outlives snapshot rotation. Restore replays the whole chain and recomputes
the restored round's leaf digests from the npz; any divergence raises
:class:`repro_torch.core.commit.CommitmentError` (distinct from the fingerprint
``ValueError``) naming the first divergent round and leaf path. Under
``verify=True`` (``cfg.verify_commitments``) a snapshot with NO commitment
records is refused too; otherwise legacy snapshots only warn.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
import warnings
from typing import Any, List, Optional, Tuple

import numpy as np

from .ckpt import manifest_path

_TAG = "round_{:06d}"
_LATEST = "LATEST"
_AUDIT = "audit.jsonl"


def _commit_mod():
    """Lazy import of :mod:`repro_torch.core.commit`: importing it at
    module level would cycle (core.commit -> checkpoint.ckpt -> this
    package's ``__init__`` -> this module)."""
    from ..core import commit
    return commit

# Config knobs a resume is allowed to change. Every entry carries its
# justifying comment: an exclusion is a CLAIM that run identity survives
# changing the field. The tuple is the reference's, so both frameworks
# print the same fingerprint for the same configuration.
DEFAULT_FINGERPRINT_EXCLUDE = (
    "rounds",   # horizon only: rounds=50 resumed to 100 replays rounds
                # 0..49 bit-identically (round_key is absolute in t)
    "backend",  # loop/vmap/shard_map/async are conformance-tested to
                # produce identical trajectories (tests/test_conformance.py;
                # the port's stacked vmap within close of its loop)
    "verify_commitments",  # verification knob only: the verified run's
                # trajectory is bit-identical to the unverified one (the
                # hashes observe state, never change it — tests/test_commit,
                # tests/test_torch_resume.py)
)


def config_fingerprint(cfg, exclude=DEFAULT_FINGERPRINT_EXCLUDE,
                       **extra) -> str:
    """Stable short hash of a ProxyFLConfig (+ caller context such as the
    method name or architecture names). Two runs share a fingerprint iff
    their checkpoints are interchangeable."""
    blob = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else dict(cfg)
    for k in exclude:
        blob.pop(k, None)
    payload = json.dumps({"cfg": blob, **extra}, sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


class FederationCheckpointer:
    """Directory-of-rounds checkpoint manager for a FederationEngine run.

    Parameters
    ----------
    directory : str
        One federation per directory (callers namespace by method/seed).
    every : int
        Snapshot cadence in rounds; ``should_save(t)`` is true after
        rounds ``every, 2*every, ...``. ``0`` disables periodic saves
        (explicit :meth:`save` still works).
    keep : int
        Retain only the newest ``keep`` snapshots (0 = keep all).
    fingerprint : str, optional
        Expected :func:`config_fingerprint`; verified against each
        snapshot's recorded fingerprint on save collision / restore. When
        omitted, a fingerprint is DERIVED from the engine's config at save
        and restore time — constructing the checkpointer without one no
        longer makes the check silently vacuous.
    verify : bool
        Strict commitment mode (``cfg.verify_commitments``): a restore is
        refused (instead of warned about) when the snapshot carries no
        commitment records or no recorded fingerprint. Chain/digest
        MISMATCHES are refused regardless of this flag.
    """

    def __init__(self, directory: str, every: int = 1, keep: int = 0,
                 fingerprint: Optional[str] = None, verify: bool = False):
        self.directory = directory
        self.every = int(every)
        self.keep = int(keep)
        self.fingerprint = fingerprint
        self.verify = bool(verify)

    # -- paths ---------------------------------------------------------------

    def _base(self, rounds_done: int) -> str:
        return os.path.join(self.directory, _TAG.format(rounds_done))

    def _meta_path(self, rounds_done: int) -> str:
        return self._base(rounds_done) + ".meta.json"

    @property
    def audit_path(self) -> str:
        return os.path.join(self.directory, _AUDIT)

    def _complete(self, rounds_done: int) -> bool:
        """ONE completeness criterion for every discovery path: a snapshot
        is resumable iff npz + manifest + meta are all on disk (they are
        written in that order, so any prefix means a kill mid-write). The
        LATEST pointer used to trust npz-only while the scan required
        meta.json — the two paths could disagree about the same file set."""
        base = self._base(rounds_done)
        return all(os.path.exists(p) for p in
                   (base + ".npz", manifest_path(base),
                    self._meta_path(rounds_done)))

    def _expected_fingerprint(self, engine=None) -> Optional[str]:
        """The fingerprint snapshots must carry: the explicit one when the
        checkpointer was constructed with it, else one derived from the
        engine's own config — so save() never stamps null and restore
        never skips the comparison just because the caller forgot to pass
        a fingerprint."""
        if self.fingerprint:
            return self.fingerprint
        if engine is not None and getattr(engine, "cfg", None) is not None:
            return config_fingerprint(engine.cfg, n_clients=engine.K,
                                      mix=engine.mix)
        return None

    # -- save ----------------------------------------------------------------

    def should_save(self, t: int) -> bool:
        """True when round t (0-based, just completed) is on the cadence."""
        return self.every > 0 and (t + 1) % self.every == 0

    def _audit_entries(self) -> List[dict]:
        """Parsed ``audit.jsonl`` entries, in file order. Reading stops at
        the first malformed line (a kill mid-append tears at most the last
        line — everything before it stays verifiable; whether the torn
        round is resumable is decided by the chain check, which refuses
        when the RESTORED round has no intact entry)."""
        if not os.path.exists(self.audit_path):
            return []
        out: List[dict] = []
        with open(self.audit_path) as f:
            for line in f:
                if not line.strip():
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    break
        return out

    def _append_audit(self, entry: dict) -> None:
        with open(self.audit_path, "a") as f:
            f.write(json.dumps(entry, sort_keys=True) + "\n")

    def _commit_snapshot(self, engine, rounds_done: int) -> Tuple[str, str]:
        """Compute this snapshot's commitment from the canonical arrays the
        npz ACTUALLY stores (what restore will recompute from), chain it to
        the previous audit entry, and append the audit record. Returns
        ``(commitment, prev_commitment)`` for the meta stamp. Re-saving a
        round already in the trail verifies bit-identity and skips the
        append; a different payload for an audited round is refused."""
        commit = _commit_mod()
        with np.load(self._base(rounds_done) + ".npz") as npz:
            digests, leaves = commit.snapshot_client_digests(npz, engine.K)
        entries = self._audit_entries()
        prev = commit.GENESIS
        for e in entries:
            if e.get("rounds_done") == rounds_done:
                # already audited: a bit-identical replay (a resume's
                # re-save, or a killed run deterministically re-run into
                # its own directory) is a no-op; a DIFFERENT payload is a
                # history rewrite and refused
                if e.get("commitment") != commit.chain_step(
                        e.get("prev_commitment", commit.GENESIS),
                        rounds_done, engine.K, digests):
                    raise commit.CommitmentError(
                        f"round {rounds_done} is already committed in "
                        f"{self.audit_path!r} with a DIFFERENT payload; "
                        "refusing to overwrite an audited snapshot — use a "
                        "fresh checkpoint directory", round=rounds_done)
                return e["commitment"], e.get("prev_commitment",
                                              commit.GENESIS)
            prev = e.get("commitment", prev)
        later = [e["rounds_done"] for e in entries
                 if e.get("rounds_done", 0) > rounds_done]
        if later:
            raise commit.CommitmentError(
                f"audit trail {self.audit_path!r} already records rounds "
                f"{later} after round {rounds_done}, which it never "
                "committed; appending it now would fork the chain — point "
                "the run at a fresh checkpoint directory", round=rounds_done)
        h = commit.chain_step(prev, rounds_done, engine.K, digests)
        self._append_audit({"rounds_done": rounds_done,
                            "n_clients": engine.K,
                            "prev_commitment": prev,
                            "commitment": h,
                            "clients": digests,
                            "leaves": leaves})
        return h, prev

    def save(self, engine, state, t: int, seed=None) -> str:
        """Snapshot ``state`` after completed round ``t`` of a run under
        base ``seed`` (None: no seed recorded); returns the base path of
        the written snapshot. Write order is load-bearing: npz +
        manifest, then the audit entry, then meta, then the LATEST pointer
        — a complete meta implies a complete audit entry, and only a
        complete snapshot is ever published. On a ``shard_map`` engine
        every rank calls it and the engine's writer rank writes every file
        once, the others waiting for it (``engine.run_on_writer``)."""
        rounds_done = t + 1
        base = self._base(rounds_done)
        engine.save_state(base, state, t, seed=seed)
        engine.run_on_writer(lambda: self._publish(engine, rounds_done))
        return base

    def _publish(self, engine, rounds_done: int) -> None:
        """The audit entry, meta and LATEST of a snapshot on disk."""
        commitment, prev = self._commit_snapshot(engine, rounds_done)
        meta = {
            "rounds_done": rounds_done,
            "fingerprint": self._expected_fingerprint(engine),
            "n_clients": engine.K,
            "backend": engine.backend,
            "mix": engine.mix,
            "commitment": commitment,
            "prev_commitment": prev,
            "saved_unix_time": time.time(),
        }
        with open(self._meta_path(rounds_done), "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True)
        # publish atomically only once the snapshot is complete on disk
        tmp = os.path.join(self.directory, _LATEST + ".tmp")
        with open(tmp, "w") as f:
            f.write(_TAG.format(rounds_done))
        os.replace(tmp, os.path.join(self.directory, _LATEST))
        self._rotate()

    def maybe_save(self, engine, state, t: int, seed=None
                   ) -> Optional[str]:
        if not self.should_save(t):
            return None
        return self.save(engine, state, t, seed=seed)

    def _rotate(self) -> None:
        if self.keep <= 0:
            return
        for r in self.saved_rounds()[:-self.keep]:
            base = self._base(r)
            for p in (base + ".npz", manifest_path(base), self._meta_path(r)):
                if os.path.exists(p):
                    os.remove(p)

    # -- discovery / restore -------------------------------------------------

    def saved_rounds(self) -> list:
        """Ascending list of rounds_done with a snapshot on disk."""
        if not os.path.isdir(self.directory):
            return []
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("round_") and name.endswith(".npz"):
                try:
                    out.append(int(name[len("round_"):-len(".npz")]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_round(self) -> Optional[int]:
        """rounds_done of the newest COMPLETE snapshot (LATEST pointer,
        falling back to a directory scan), or None when the directory holds
        no resumable state. Both paths trust the SAME completeness
        criterion (:meth:`_complete`: npz + manifest + meta on disk), and a
        corrupt/garbage LATEST file falls back to the scan instead of
        crashing the resume."""
        latest = os.path.join(self.directory, _LATEST)
        if os.path.exists(latest):
            with open(latest) as f:
                tag = f.read().strip()
            if tag.startswith("round_"):
                try:
                    r = int(tag[len("round_"):])
                except ValueError:
                    r = None  # garbage pointer: fall back to the scan
                if r is not None and self._complete(r):
                    return r
        complete = [r for r in self.saved_rounds() if self._complete(r)]
        return complete[-1] if complete else None

    def _check_meta(self, rounds_done: int, engine=None) -> dict:
        mp = self._meta_path(rounds_done)
        meta = {}
        if os.path.exists(mp):
            try:
                with open(mp) as f:
                    meta = json.load(f)
            except json.JSONDecodeError:
                meta = {}  # truncated by a kill mid-write; npz is complete
        theirs = meta.get("fingerprint")
        expected = self._expected_fingerprint(engine)
        if not theirs:
            # pre-derivation snapshots stamped null — the comparison used
            # to pass vacuously; now it is at least loud, and refused in
            # strict mode
            msg = (f"checkpoint {self._base(rounds_done)!r} records no "
                   "config fingerprint — cannot verify it belongs to this "
                   "run's configuration")
            if self.verify:
                raise _commit_mod().CommitmentError(
                    msg + " (verify_commitments is on; refusing)",
                    round=rounds_done)
            warnings.warn(msg, stacklevel=3)
        elif expected and theirs != expected:
            raise ValueError(
                f"checkpoint {self._base(rounds_done)!r} was written under a "
                f"different federation configuration (fingerprint {theirs} != "
                f"expected {expected}); refusing to resume — point "
                "--checkpoint-dir at a fresh directory or rerun with the "
                "original configuration")
        return meta

    def verify_chain(self, rounds_done: int, meta: Optional[dict] = None
                     ) -> Optional[str]:
        """Replay the commitment chain from GENESIS and recompute the
        restored round's leaf digests from its npz; raise
        :class:`~repro_torch.core.commit.CommitmentError` naming the first
        divergent round (and leaf path, for leaf-level tampering) on any
        mismatch. Returns the verified commitment, or None when the
        directory predates the audit trail (warned, refused under
        ``verify=True``)."""
        commit = _commit_mod()
        meta = self._check_meta(rounds_done) if meta is None else meta
        entries = self._audit_entries()
        if not entries and "commitment" not in meta:
            msg = (f"checkpoint directory {self.directory!r} carries no "
                   "commitment records (pre-audit-trail snapshot) — the "
                   "proxy payload cannot be verified")
            if self.verify:
                raise commit.CommitmentError(
                    msg + " (verify_commitments is on; refusing)",
                    round=rounds_done)
            warnings.warn(msg, stacklevel=3)
            return None
        prev, last_r, target = commit.GENESIS, 0, None
        for e in entries:
            r = e.get("rounds_done")
            if not isinstance(r, int) or r <= last_r:
                raise commit.CommitmentError(
                    f"audit trail {self.audit_path!r} is out of order at "
                    f"entry for round {r!r} (after round {last_r}) — the "
                    "trail has been edited or reordered", round=r)
            if e.get("prev_commitment") != prev:
                raise commit.CommitmentError(
                    f"commitment chain broken at round {r}: entry links to "
                    f"{e.get('prev_commitment')!r} but round {last_r}'s "
                    f"commitment is {prev!r} — an earlier snapshot was "
                    "rewritten or the trail was truncated", round=r)
            digests = e.get("clients", {})
            expect = {c: hashlib.sha256(json.dumps(
                lv, sort_keys=True).encode()).hexdigest()
                for c, lv in e.get("leaves", {}).items()}
            if expect != digests:
                bad = sorted(c for c in set(digests) | set(expect)
                             if digests.get(c) != expect.get(c))
                raise commit.CommitmentError(
                    f"audit entry for round {r} is internally inconsistent "
                    f"(client commitment != hash of recorded leaf digests "
                    f"for {bad}) — the trail has been edited", round=r)
            h = commit.chain_step(prev, r, e.get("n_clients", 0), digests)
            if e.get("commitment") != h:
                raise commit.CommitmentError(
                    f"commitment chain diverges at round {r}: recorded "
                    f"{e.get('commitment')!r}, recomputed {h!r}", round=r)
            if r == rounds_done:
                target = e
            prev, last_r = h, r
        if target is None:
            raise commit.CommitmentError(
                f"audit trail {self.audit_path!r} has no entry for round "
                f"{rounds_done} (last recorded round: {last_r}) — the trail "
                "was truncated or the snapshot bypassed it; refusing to "
                "restore an uncommitted round", round=rounds_done)
        if meta.get("commitment") != target["commitment"]:
            raise commit.CommitmentError(
                f"meta.json of round {rounds_done} records commitment "
                f"{meta.get('commitment')!r} but the audit trail says "
                f"{target['commitment']!r} — meta files were swapped, "
                "reordered or rewritten", round=rounds_done)
        # leaf-level recheck of the round actually being restored: the
        # chain above proves the TRAIL is intact; this proves the npz still
        # holds the bytes the trail committed to
        with np.load(self._base(rounds_done) + ".npz") as npz:
            n = int(target.get("n_clients", 0))
            _, leaves = commit.snapshot_client_digests(npz, n)
        for ckey in sorted(target.get("leaves", {})):
            recorded = target["leaves"][ckey]
            actual = leaves.get(ckey, {})
            for path in sorted(set(recorded) | set(actual)):
                if recorded.get(path) != actual.get(path):
                    raise commit.CommitmentError(
                        f"checkpoint leaf {ckey}/{commit.PROXY_PREFIX}"
                        f"{path} of round {rounds_done} does not match its "
                        f"committed digest (recorded "
                        f"{recorded.get(path)!r}, recomputed "
                        f"{actual.get(path)!r}) — the snapshot was "
                        "tampered with after it was committed",
                        round=rounds_done, leaf=f"{commit.PROXY_PREFIX}{path}",
                        client=int(ckey[1:]))
        return target["commitment"]

    def restore(self, engine, rounds_done: Optional[int] = None, *,
                like=None, seed=None) -> Tuple[Any, int]:
        """Load a snapshot into ``engine``'s state layout; returns
        ``(state, rounds_done)`` — the caller continues the round loop at
        ``t = rounds_done``. Also restores attached accountant counters;
        a ``seed`` other than the one the snapshot records is refused.
        The commitment chain is verified BEFORE any state is materialized
        (tampered snapshots refuse with the divergent round/leaf named)."""
        if rounds_done is None:
            rounds_done = self.latest_round()
            if rounds_done is None:
                raise FileNotFoundError(
                    f"no federation checkpoint found under {self.directory!r}")
        meta = self._check_meta(rounds_done, engine)
        self.verify_chain(rounds_done, meta)
        state, done = engine.restore_state(self._base(rounds_done), like=like,
                                           seed=seed)
        if done != rounds_done:
            raise ValueError(
                f"checkpoint {self._base(rounds_done)!r} records "
                f"rounds_done={done}, expected {rounds_done}")
        return state, done

    def restore_latest(self, engine, *, like=None, seed=None
                       ) -> Optional[Tuple[Any, int]]:
        """Like :meth:`restore`, but returns None when there is nothing to
        resume from (fresh start) instead of raising."""
        if self.latest_round() is None:
            return None
        return self.restore(engine, like=like, seed=seed)

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--parent DIR]

1. Prints the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions, then builds the hand-written kernels from
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` and prints the build time
   and, from ptxas's ``-v`` report, the registers and spills of the two
   tensor-core attention kernels, the register kernels of both mixes, the
   rmsnorm instantiations, the clip pair's rows accumulate, the mamba
   scan's instantiations and the Adam step's (0 spill bytes each).
2. Holds each of the fifteen kernels (nine TPU kernels; the mix also as
   the hier exchange's shard-grid entry, the clip accumulate and Adam also
   on the stacked executor's client grid; attention has four:
   bf16 on wgmma and f32 in split TF32, both on the tensor cores at every
   head dim, zero-padded up to their compiled widths (64, 128 and 256;
   split TF32 also 96), each with a 16-byte loader (TMA, cp.async) for
   aligned calls and a narrow one (8-, 4- or 2-byte copies) for the rest)
   and the
   ``"rows"`` route of the DP clip pair (``sumsq_rows`` and
   ``clip_accumulate_rows`` over the [250, 199,210] per-example gradients
   and over fig. 3's cifar10 proxy's [250, 656,810], table 2's cnn1
   proxy's [32, 66,778], fig. 6's VGG's [128, 110,792] and fig. 5b's
   Regular proxies' [250, D] (D = 107,786, 51,830, 211,594), also bit for bit
   against a loop of the 1-D kernels; the stacked executor's
   ``sumsq_rows`` over [2,000, D] and the client-grid routes
   ``clip_accumulate_rows_clients`` [8, 250, D] and
   ``noise_adam_step_clients`` [8, D] at D = 199,210 and 656,810, each
   also bit for bit against K launches of the flat kernel, the clip
   timed beside ``torch.einsum``) against its
   plain PyTorch version on the
   card, at the main paths' shapes (D = 199,210 f32, K = 8; the LLM
   kernels at the full widths of qwen2-7b, gemma3-4b, falcon-mamba-7b and
   (the scan) jamba-1.5-large,
   attention in bf16 and f32, phi-3-vision's head dim 96 in both, and the
   narrow loaders at phi-3-vision's length and heads with D = 100 (bf16)
   and 98 (f32); rmsnorm on both its vector and its scalar path)
   and at ragged sizes (the sync mix and Adam also at D = 656,810 and at
   the figures phase's widths: Adam at 66,778 and 110,792, the mix at
   [4, 199,210], [4, 66,778] and [8, 110,792]; the
   sync mix also on the dense "mean" P of FedAvg and FML and the "ring"
   permutation of CWT; the mixes at K across every register bucket edge,
   the sync mix also on rows one element off; z' of the f32 stale mix
   bit-equal), with the kernel tests' tolerances (f32 rtol = atol = 2e-5,
   bf16 2e-2, the mamba scan 2e-4, also over a sweep of state sizes 1-64,
   lengths around its 32-step chunks and batch 1 and 3, in f32 and with dt,
   B and C in bf16; noise_adam_step also with L2 flushed before each call),
   then sweeps both tensor-core attention
   routes' 16-byte loaders over head dims (compiled and zero-padded),
   lengths, groups, masks and windows, checks misaligned views of an
   aligned head dim at every copy width on the narrow loaders, and sweeps
   the narrow loaders at unaligned head dims (bf16 33, 34, 36, 100, 255;
   f32 1, 30, 33, 98, 255: every copy width), each call asserted on its
   narrow launch key; counts the device kernels of one ``noise_adam_step``
   and one ``noise_sgd_step`` call (one each) and holds both bit for bit to
   the plain version with n_units a device tensor; with ``--parent DIR``
   (a checkout of the commit before the narrow loaders and the one-launch
   SGD step, whose C entry points are checked against the arguments
   passed) builds its attention and DP-step kernels into a library of
   their own and times them in turns with this tree's (the unaligned head
   dims against its CUDA-core kernel; the aligned attention, Adam and SGD
   bit for bit against its kernels);
   times each kernel over
   CUDA-event-timed launches (200, or 10 at the LLM widths) beside its
   plain version, one PyTorch library call computing the same function
   where there is one, and its bound (bytes over 3.35 TB/s, operations
   over 67 TFLOP/s f32, 989 TFLOP/s for bf16 attention, or 165 TFLOP/s of
   f32-grade products, three TF32 products at 495, for f32 attention on
   the tensor cores): once eagerly
   (what a caller pays, host launch cost included) and once replayed from a
   CUDA graph (the device's time per call), with the rate it reaches.
   Then drives the ops API (``repro_torch.kernels``) once at full width:
   ``gqa_flash_attention`` (qwen2-7b: S = 4,096, 28 query and 4 KV heads,
   D = 128, bf16, causal), ``rmsnorm`` (d = 3,584 over 4,096 bf16 rows),
   ``mamba_scan`` (di = 8,192, ds = 16, S = 4,096, f32), ``noise_sgd_step``
   and ``tree_clip_accumulate`` (the mlp proxy, D = 199,210), with the
   launch counters reset just before and read just after (exactly one
   launch of each kernel, one ``sumsq`` and one ``scale_accumulate`` on
   their 1-D route), each
   result finite and within tolerance of its plain version; then gemma3-4b's
   local attention (D = 256, window 1,024), rmsnorm in f32, qwen2-7b's
   attention in f32 (the split-TF32 kernel; SDPA's f32 kernel named from
   the profiler), phi-3-vision's attention (D = 96) in bf16 (wgmma) and in
   f32 (split TF32) and the flat ``clip_accumulate``, one launch window
   each, each with its route's launch pinned.
3. Times the first client step of the process (set-up cost), then
   drives the sync DP path: ``run_federated("proxyfl", ...)`` on the
   paper's MNIST protocol (synthetic data), mlp 784-200-200-10, 8 clients
   of 1,000 examples, batch 250, DP sigma = 1, C = 1, ``use_pallas=True``,
   two rounds on ``cuda`` (the stacked executor, each round replayed from
   its CUDA graph), with the kernel launch counters reset just before and
   read just after; checks the exact launch counts (a local step of the
   cohort one ``sumsq_rows`` over [K·B, D], one client-grid
   ``clip_accumulate_rows`` and one client-grid ``noise_adam_step``: 4 /
   4 / 4 and one mix a round; none of the ops API's four kernels), finite
   losses, accuracy above chance, the pinned epsilon, and that the plain
   path on the same seed reaches the same params at the conformance
   ``close`` grade.
4. Drives the six other fig. 3 methods (``fml``, ``fedavg``,
   ``avgpush``, ``cwt``, ``regular``, ``joint``) through
   ``run_federated`` on the same set-up, two rounds each on ``cuda``, the
   counters reset just before and read just after each: exact launch
   counts (the stacked counts: 4 of each DP kernel a round, Joint's 32 on
   its one pooled client; one ``fused_pushsum_mix`` a round for FML, FedAvg,
   AvgPush and CWT, none for Regular and Joint; nothing else), the pinned
   epsilon (Joint's for its pooled sample rate), finite test losses and
   accuracies in [0, 1], and the same run with ``use_pallas=False`` at the
   ``close`` grade; prints each method's rounds/s with the kernels and on
   the plain path beside the card.
5. Drives the "figures" configurations through the port's own drivers
   (``fig5_ablations.hetero_setup``, ``table2_histo.configuration``,
   ``fig6_kvasir.configuration``) and ``run_federated``, one round each,
   seed 0, at full width: fig. 5b's heterogeneous cohort (privates mlp,
   lenet5, cnn1 and cnn2 around an mlp proxy, 4 clients of 1,000 MNIST
   examples, B = 250) and the Regular baseline of each architecture;
   table 2's camelyon (cnn1, a Dirichlet cohort of 4, B = 32, sigma 1.4,
   C 0.7, alpha 0.3) and fig. 6's kvasir (the small VGG, a Dirichlet
   cohort of 8, B = 128), ProxyFL and FedAvg or AvgPush each. The counters
   reset just before and read just after each run: on the heterogeneous
   cohort (the loop) one ``sumsq_rows``, one flat clip accumulate and one
   flat Adam step per client step, sum_k max(1, n_k // B) a round; on the
   homogeneous ones (stacked) one of each a batched step, max_k max(1,
   n_k // B) a round, exhausted clients masked; one ``fused_pushsum_mix`` a
   round where the method mixes, nothing else; each client's epsilon the
   accountant's for its own sample rate and steps, and table 2's privacy
   rows the JAX package's; finite losses; a second run bit-equal, each of
   its client steps against the plain path's from the same state at the
   ``close`` grade (:class:`Lockstep`; a stacked step against the plain
   step vmapped alike); rounds/s with the kernels and plain.
6. Drives the async path: ``run_federated(..., backend="async")`` on
   fig_async's protocol (staleness 2, 2 local steps of batch 64, DP off)
   on the same data for 6 rounds, counters reset just before and read just
   after (exactly one stale-mix launch a round, nothing else); checks
   finite losses and accuracy above chance, and that the same rounds with
   ``use_pallas=False`` reach the same params, de-bias weights and
   in-flight buffers at the ``close`` grade; times the stale exchange.
   Then checks that async at staleness 0 equals the sync backend bit for
   bit, and that PushSum mass (clients plus in-flight buffer) is conserved
   round by round at staleness 2 under §3.4 dropout.
7. Drives the compressed exchange, commitments and attacks (the
   "exchange" phase): (a) the top-k and int8 codecs and the public-copy
   core at [8, 199,210] (a row of planted ties) bit-equal to the CPU's,
   ``c + (m − pub') == m − pub`` exact where nothing was sent and at the
   reference's 1e-6 elsewhere; (b) compressed ProxyFL (top-k, int8) on the
   main path's set-up, 2 rounds: 32 of each DP kernel a round and no mix
   kernel, the pinned epsilon, warm public copies, a second run bit-equal
   with each client step against the plain path's and each exchange
   against the CPU's (public copies bit for bit), rounds/s and exchange ms
   beside the uncompressed run's; (c) async τ = 2 int8 on fig_async's
   protocol, 6 rounds: w-mass conserved every round, no kernel launched;
   (d) a verified loop run bit-equal to the unverified, a bit flip of
   client 1 in round 1 refused with ``CommitmentError``, commitments of
   the card's proxies equal the CPU's; (e) ``mia_privacy``'s quick
   configuration (AUCs in [0, 1], the pinned epsilon, the rows printed);
   (f) ``fig4_comm.run(False)`` and ``scripts/check_comm_claim.py`` on
   the JSON it writes (``chiprun_out/fig4_comm.json``).
8. Breaks one warm client step, one engine round, the exchange and the
   evaluation of the sync path down on the host clock, and profiles one
   step with torch.profiler for the device's busy share.
9. Drives the LLM serving path (the "serve" phase) on random weights from
   a seeded generator on the card, through the serve steps
   (``repro_torch.launch.steps``): (a) qwen2-7b and (b) falcon-mamba-7b
   at full depth and width, B = 4 prompts of 1,024 tokens and 16 greedy
   tokens, (c) gemma3-4b at full width over one 5:1 pattern (6 layers), B
   = 2 prompts of 2,048 tokens over its 1,024-token window, and
   phi-3-vision-4.2b at full depth and width (576 image tokens before the
   prompt; head dim 96, zero-padded to 128 by the wgmma kernel), with the
   kernels and on the plain path: the launches of every prefill and decode
   step exact (one rmsnorm a norm, on its vector route; one attention a
   GQA layer, on wgmma, and one scan a mamba layer in a prefill; rmsnorm
   alone in a decode step), prefill and decode ms and tok/s beside their
   bounds, the peak device memory, the greedy tokens of both paths
   (reported, not gated: a random model's logits are near ties); then
   each layer of a prefill and a decode step from the same input with the
   kernels and on the plain path, each with its own cache, held normwise
   at bf16 2e-2, and every kernel launch in it held element by element to
   the model's plain function on its own inputs (RMSNorm and attention at
   their kernel grade, the scan's y and final state at 2e-4); the same at
   full width and 2 layers in f32 at 2e-5 (split TF32 attention); the
   smoke variant of every registry name (launches exact, the lockstep,
   and in f32 with dropless MoE prefill + decode against the no-cache
   forward at 2e-4, tests/test_models.py's check). Before it, on every
   scan case: y bit for bit the same with and without the final state,
   and from a random state y and the final state against the plain
   version; with ``--parent-scan DIR`` (a checkout of a commit whose scan
   takes no state) also this tree's scan bit for bit against that
   commit's.
10. Drives the LLM ProxyFL training path (the "train" phase) through
   ``repro_torch.launch.train``'s set-up and the engine, on the stacked
   executor (each local step one client step vmapped over the cohort):
   (a) its default ``--preset 100m`` at full width (private 12 layers of
   d 768, vocab 8,192; proxy 4 layers of d 256, D = 6,293,760), K = 4, 3
   rounds of 3 steps, B = 8, S = 128, DP sigma 1, C 1, the vmap backend
   (the first round eager, the second captured into a CUDA graph, the
   third replayed), with the kernels and on the plain path: launches
   exact with the replays counted (per batched step one forward of each
   peer without a gradient for the cohort: rmsnorm on its client grid and
   split-TF32 attention folded over the clients, one launch a call; one
   evaluation a round on the flat routes; one mix a round; none in the
   differentiated forwards, counted), captured bit-equal to eager, a
   second run bit-equal, each batched step against the loop's kernel step
   client by client (:class:`Lockstep`, the first-Adam-step mask and the
   ``OUTLIERS_PER_COORD`` budget, counts printed) and against the plain
   path's step vmapped alike (moments and losses at ``close``; each leaf's
   gradient, from the moments, normwise within 1e-4; params at ``close``
   but for a first Adam step's coordinates at |g| < 100 eps, masked by
   that rule and counted), epsilon the JAX package's, rounds/s without
   evaluation of the loop, the stacked round eager and captured, a
   captured round's device busy share and device µs by kernel, peak
   memory, the loop's step breakdown and its busy share; (b) the preset
   on ``--backend async --staleness 2``, 3 rounds: one stale mix a round
   at [4, 6,293,760], launches exact; (c) the smoke variant of every
   registry name, K = 2, one round of one step: launches exact (the
   mamba models' scans on the scan's client route), the bf16 runs' f32
   master copies moved. The kernel table also times the mix and the stale
   mix at [4, 6,293,760], the peers' rmsnorm and attention at the
   preset's shapes, and the client routes: ``rmsnorm_clients`` at [4,
   1,024, 256] and [4, 1,024, 768], the folded attention at [32, 128, 8,
   32] and [32, 128, 12, 64] and ``mamba_scan_clients`` at [4, 8, 128,
   8,192], each bit-equal to K flat launches.
11. Drives checkpoints and resume (the "resume" phase), every run on
   ``cuda`` with the kernels on and the counters reset around it: times
   one main-path snapshot's save, chain verification and restore; (a) the
   main path through ``run_federated`` on the vmap and the loop backends,
   3 rounds straight and killed after round 2 (a snapshot every round)
   then resumed for round 3 under ``verify_commitments``: every leaf and
   w bit-equal, epsilon exact (the JAX package's), the resumed round's
   launches exactly 4 ``sumsq_rows`` and 4 of each client-grid route
   (vmap; 32 of each flat route on the loop) and 1 mix; one mantissa bit
   of a committed proxy
   leaf of the newest snapshot flipped and the next resume refused with
   ``CommitmentError`` naming round 3, client 1 and the leaf; (b) async
   τ = 2 on fig_async's protocol, 6 rounds killed after round 3: the
   in-flight buffer restored bit for bit, the resumed rounds bit-equal,
   one stale mix each; (c) compressed int8 on the main set-up killed after
   round 1 of 2: the public copies restored, the result bit-equal, a
   top-k resume refused by the fingerprint; (d) the train driver at
   ``--preset 100m``, full width, K = 2, B = 8, S = 128, 2 rounds of 1
   step, killed after round 1 and resumed through ``main([...,
   "--checkpoint-dir", d, "--resume"])``: its round-2 snapshot equal leaf
   for leaf to the straight run's final state, its launches one round's,
   the snapshot's bytes and its save, verify and restore seconds printed
   and the directory removed; (e) ``dp_adam_update`` on bf16 params at
   the mlp proxy's width, with f32 and with bf16 moments (the rows
   kernels on the widened gradients, the 1-D ``scale_accumulate``),
   Adam's second step against its plain version: every leaf at bf16
   2e-2, p32' − p32, m and v normwise at 1e-5 (f32 moments) or 2^-8
   (bf16), and a plain version with the noise dropped or the clip off
   shown to fail that grade; ``gossip_proxies`` against the plain mix at
   f32 2e-5; launches pinned.
12. Drives the hier backend (the "hier" phase), every run on ``cuda``
   with the kernels on and the counters reset around it: (a) the main path
   through ``run_federated(..., backend="hier", n_shards=S)``, 2 rounds at
   S = 1, 2 and 4, without and with §3.4 dropout 0.25: every param, Adam
   moment, w and epsilon bit-equal to the vmap run's (S = 1 runs the flat
   exchange), per round exactly one ``sumsq_rows``, one client-grid clip
   accumulate and one client-grid Adam step a batched step (4, dropped
   clients masked) and one shard-grid mix (S > 1) or flat mix (S = 1);
   (b) τ = 2, S = 2 on fig_async's protocol, 6 rounds: with DP on, one
   shard-grid mix a round and epsilon vmap's; with lr 0 and dropout 0.25,
   the mass of the clients plus the cross-shard buffer conserved every
   round; killed after round 3 and resumed, the buffer restored and the
   rounds bit-equal; dense mixing, ring at τ > 0 and compression refused
   at S = 2; (c) the shard-grid mix in the kernel table (item 2): [8,
   199,210] at S = 2, 4, 8, [64, 199,210] at S = 8, L across every bucket
   edge, the train shape [4, 6,293,760] at S = 2, f32 and bf16, bit-equal
   to S launches of the flat kernel, timed beside its plain version and
   ``torch.bmm``; (d) the train driver's preset, K = 4, 2 rounds of 1
   step, on ``--backend hier --n-shards 2``: leaf-equal to ``--backend
   vmap``, one shard-grid mix a round, then ``--staleness 2`` for 3
   rounds, launches pinned (both stacked: the peers' kernels once a
   batched step); (e) ``fig_hier``'s rows at K = 8 and 64 and
   ``fig_kernels``' at K = 8, printed and written to ``chiprun_out/``.
13. Drives the stacked executor (the "stacked" phase), on the main
   set-up unless said: (a) a block of 2 rounds (the first eager, the
   capture's warm-up; the second captured and replayed), its launches
   exact with the replay counted (4 ``sumsq_rows``, 4 client-grid clip
   accumulates, 4 client-grid Adam steps and 1 mix a round), epsilon
   pinned, the [2, K] metrics finite; (b) the same block eager against
   it (bit-equal predicted, the difference printed; ``close`` gated); (c)
   blocks of 1, 2 and 4 of 4 rounds bit-equal, and a second dataset of
   the same shapes replaying the one graph against eager rounds on it;
   (d) each batched step of 2
   rounds against the loop's kernel step client by client
   (:class:`Lockstep`), the ReLU sign changes between the batched and the
   per-client products counted; (e) rounds/s of the loop, the stacked
   round eager and captured (8 rounds as one block after a warm-up round,
   evaluation excluded), and the device's busy share of one captured
   round and of a block of 4 under the profiler; (f) table 2's ragged
   cnn1 cohort in epoch mode, one round: max_k n_k // B launches of each DP
   kernel, each client's own epsilon, each batched step against the
   loop's; (g) async τ = 2 (fig_async's protocol) and hier S = 2, 4 rounds
   captured, blocks of 1 and 4 bit-equal, launches exact; (h)
   ``run_federated(rounds_per_block=2)`` killed after round 2 of 4 and
   resumed at the block edge, bit-equal to the straight and the
   per-round run.
14. Prints one JSON line ``{"kernels": [...]}`` (attention's two kernels
   and their narrow loaders, the clip pair's rows route, and the
   client-grid routes of the clip accumulate and of Adam, under their own
   keys, each with its launches on its own path: the flat clip and Adam on
   fig. 5b's heterogeneous cohort (the loop), the client grid on the main
   path; the DP kernels and the mix also with their launches on each
   method's path and each figures run's, with its shape, and on each
   compressed run's, the MIA federations' and compressed async's; the
   LLM kernels with their launches on the serve path (qwen2-7b's served
   run for rmsnorm and attention, falcon-mamba-7b's for the scan), per
   prefill and decode step of each served model, and their serve-shape
   rows; the mixes, rmsnorm, attention and the scan with their launches
   on the train path and their train-shape rows; every kernel with its
   launches in the resume phase's resumed runs and (e)'s calls, and on
   each hier run and each stacked-phase run; the shard-grid mix under its
   own key, its launches on the hier main set-up at S = 2; the client
   routes of rmsnorm and attention with their launches on the train
   preset's stacked rounds, the scan's on the mamba smoke variants'; every
   kernel with its launches on each shard_map-phase run); every kernel
   of the line must have launched on its path, or the run fails. Last, the
   result line ``{"ok": true, "device": {...}}``.
15. Drives the ``shard_map`` backend (the "shard_map" phase, before the
   line of 14) on an in-process NCCL group at world size = the card count
   (one rank: a ``FileStore`` in a temporary directory, 1-D meshes over
   ``"clients"`` and ``"pod"``): (a) the main set-up's mlp at D = 199,210,
   B = 250, DP on, the kernels on, one client (K = the card count), 2
   rounds and then one block of 4 on ``shard_map`` and on vmap: every
   leaf, w, metric and epsilon bit-equal, launches exactly 4
   ``sumsq_rows``, 4 client-grid clip accumulates and 4 client-grid Adam
   steps a round (K = 1: no exchange), the two snapshots byte-equal and
   each restored by the other backend, a cohort of 2 refused (the mesh
   holds one rank), rounds/s of both and the device busy share of a
   captured block of 4 on ``shard_map``; (b) ``launch.steps.
   make_hier_round_block_step`` on ``--preset 100m`` (proxy D =
   6,293,760), 1 pod of L = 4 clients, 3 rounds, against the engine's
   vmap rounds on the same draws: every leaf at ``close``, the peers'
   client-route launches exact.
16. Drives the dry-run (the "dryrun" phase, before the line of 14;
   ``repro_torch.launch.dryrun``): (a) ``run_one`` on the meta device for
   qwen2-7b × train_4k, prefill_32k and decode_32k and falcon-mamba-7b ×
   long_500k (the reference's full shapes, nothing allocated), each
   row's FLOPs, bytes, argument bytes, model FLOPs, useful share and the
   roofline's three terms printed beside the card; (b) qwen2-7b's prefill
   at B = 4 × 1,024 with the kernels (rmsnorm and bf16 attention launch)
   counted by the cost counter on the card, held exactly to the count of
   the same step on meta (FLOPs, matmul FLOPs, bytes). On both, each
   kernel's op is charged its plain version's count on meta copies, so
   what the equality holds is that the model's own ops on the card are
   those on meta, and that each op's meta output has the layout the
   kernel writes. Its argument bytes equal the storage bytes of the
   state and batch built on the card, and its CUDA-event time is printed
   beside its roofline time and their ratio (not gated);
   its launches join the line of 14; (c) ``StepOptions.remat`` under the
   stacked executor's CUDA graph: qwen1.5-4b's smoke variant, K = 3, with
   and without remat, each round-key's second round captured and the
   third replayed, the states at ``close`` (bit-equality printed).

Any failure raises and exits nonzero. The script needs a CUDA device and
the repository's ``src/`` beside it; it never runs on the CPU.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import os
import re
import contextlib
import io
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional

# CUPTI torn down after one profiler session and brought up again for the
# next does not go with CUDA graphs (PyTorch's own profiler keeps it up
# when it has seen a graph, on CUDA older than 12.6); this script replays
# graphs before it profiles, and on the H100 (CUDA 12.8) later sessions
# lost some or all of their device kernels. Set before torch loads.
os.environ.setdefault("TEARDOWN_CUPTI", "0")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.launch.inspect import (device_profile,  # noqa: E402
                                        kernel_key, kernel_times)
from repro_torch.launch.mesh import H100_SXM  # noqa: E402

# repro.core.accountant.epsilon_for(noise_multiplier=1.0, sample_rate=0.25,
# steps=8, delta=1e-5) — 2 rounds x 4 steps of B = 250 on 1,000 examples —
# evaluated once with the JAX package's accountant and pinned here.
EPSILON_2_ROUNDS = 6.528418259356986
# epsilon_for(noise_multiplier=1.0, sample_rate=250 / 8_000, steps=64,
# delta=1e-5) — Joint: the eight clients' 8,000 examples pooled, 2 rounds x
# 32 steps — from the JAX package's accountant, pinned the same way.
EPSILON_JOINT_2_ROUNDS = 2.325589769765162
OTHER_METHODS = ("fml", "fedavg", "avgpush", "cwt", "regular", "joint")

# the H100 SXM's published figures, from the package's one home for them
HBM_BYTES_PER_S = H100_SXM["hbm_bandwidth"]       # device memory
F32_OPS_PER_S = H100_SXM["peak_flops_f32"]        # f32 off the tensor cores
L2_BYTES = H100_SXM["l2_bytes"]                   # L2 cache
BF16_OPS_PER_S = H100_SXM["peak_flops_bf16"]      # dense bf16, tensor cores
TF32X3_OPS_PER_S = H100_SXM["peak_flops_tf32x3"]  # three TF32 products
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SCAN_TOL = 2e-4             # tests/test_kernels.py's mamba scan tolerance
MAIN_D, MAIN_K = 199_210, 8
# the figures phase's proxies (table 2's cnn1 on camelyon's 32x32x3, 2
# classes; fig. 6's small VGG on kvasir's 25x20x3, 8 classes; fig. 5b's
# Regular baselines of lenet5, cnn1 and cnn2 on MNIST) and batches
TABLE2_D, TABLE2_B, TABLE2_K = 66_778, 32, 4
FIG6_D, FIG6_B, FIG6_K = 110_792, 128, 8
FIG5_REGULAR_D = (107_786, 51_830, 211_594)
# one round each keeps the phase near 90 s: the plain path's per-example
# loop and the lockstep run cost 20-40x a kernel round
FIGURE_ROUNDS = 1
# table 2's privacy rows (benchmarks/table2_histo.py: sigma 1.4, batch 32,
# 30 epochs, delta 1e-5, each institution's training-set size), evaluated
# with the JAX package's accountant on the CPU and pinned here
TABLE2_EPSILONS = {"C1": 2.381721055853542, "C2": 2.1759964739464497,
                   "C3": 2.0809329681079025, "C4": 2.1198894308107272,
                   "Joint": 1.0006292618507429}
MAIN_B = 250                 # examples of a DP step (the clip rows)
MAIN_PER_CLIENT = 1_000      # examples of each main-path client
# the mlp on fig. 3's cifar10 stand-in (32x32x3): 32·32·3·200 + 200 +
# 200·200 + 200 + 200·10 + 10 params, its proxy's width on that path
CIFAR_D = 656_810
ROWS_RAGGED = [(B, D) for B in (1, 3, 257) for D in (1, 1_023, 1_025)]
RAGGED_D = (1, 1_000, 65_537)
RAGGED_K = (1, 3, 8, 16, 17, 32, 33)   # every K bucket edge of the mixes
TIMED_LAUNCHES = 200
FULL_WIDTH_CALLS = 10        # calls timed for the LLM-width kernels
CLOSE = dict(atol=1e-5, rtol=1e-4)   # tests/test_conformance.py "close"
ASYNC_ROUNDS, ASYNC_TAU = 6, 2   # fig_async runs 30 rounds; cut to 6
# the hier phase: the main set-up at these shard counts (S = 1 runs the
# flat exchange), with and without §3.4 dropout; the stale run at S = 2;
# fig_hier's cohorts (its S = 8) and fig_kernels' at K = 8
HIER_SHARDS, HIER_DROPOUT, HIER_STALE_S = (1, 2, 4), 0.25, 2
HIER_FIG_K, HIER_FIG_ROUNDS = 64, 2
# the train driver's preset on --backend hier --n-shards 2, 1 step a round
HIER_TRAIN_ROUNDS, HIER_TRAIN_STALE_ROUNDS = 2, 3
COMPRESS_RATIO = 0.25           # the drivers' top-k kept fraction
# repro.core.accountant.epsilon_for(noise_multiplier=2.0, sample_rate=25 /
# 150, steps=24, delta=1e-5) — mia_privacy's quick DP federation: 4 rounds
# of 6 steps of B = 25 on each client's 150 members — evaluated once with
# the JAX package's accountant and pinned here
EPSILON_MIA_QUICK = 2.2433641537608517
# the ops API at the full widths of models the repo has (one layer's call)
QWEN_ATTN = dict(B=1, S=4_096, Hq=28, Hkv=4, D=128)       # configs/qwen2_7b.py
GEMMA_LOCAL = dict(B=1, S=4_096, Hq=8, Hkv=4, D=256, window=1_024)  # gemma3_4b
PHI3V_ATTN = dict(B=1, S=4_096, Hq=32, Hkv=32, D=96)   # phi_3_vision_4_2b
# the narrow loaders' timed calls: phi-3-vision's length and heads at the
# nearest head dims whose rows are not whole 16 bytes (bf16 rows of 200
# bytes, f32 of 392: 8-byte copies)
UNALIGNED_ATTN = dict(PHI3V_ATTN, D=100)
UNALIGNED_ATTN_F32 = dict(PHI3V_ATTN, D=98)
# and the narrower copies at the same length and heads: bf16 rows of 196
# bytes (4-byte copies) and 198 (2-byte loads), f32 rows of 388 (4-byte)
NARROWER_ATTN = (("4-byte", torch.bfloat16, 98),
                 ("2-byte", torch.bfloat16, 99),
                 ("f32 4-byte", torch.float32, 97))
RMS_ROWS, RMS_D = 4_096, 3_584                            # qwen2-7b d_model
MAMBA = dict(B=1, S=4_096, di=8_192, ds=16)   # configs/falcon_mamba_7b.py
# configs/jamba_1_5_large_398b.py: d_model 8,192, expand 2, d_state 16
JAMBA = dict(B=1, S=4_096, di=16_384, ds=16)
# the scan's sweep: state sizes around its lane and state buckets, lengths
# around its 32-step chunks, di = 96 + ds (aligned and unaligned rows)
SCAN_DS = (1, 3, 8, 16, 17, 32, 64)
SCAN_S = (1, 31, 33, 4_097)
SCAN_B = (1, 3)
# the serve phase: B = 4 prompts of 1,024 tokens and 16 greedy tokens
# (qwen2-7b, falcon-mamba-7b at full depth and width); gemma3-4b at full
# width, one 5:1 pattern (6 layers), B = 2 prompts of 2,048 tokens over its
# 1,024-token window; the smoke variants at B = 2, a 7-token prompt and 5
# decode steps (tests/test_models.py's 12 tokens, S0 = 7)
SERVE_TOKENS, SERVE_GEN = (4, 1_024), 16
# the train phase: python -m repro_torch.launch.train's --preset 100m (12
# layers, d 768, vocab 8,192; its proxy 4 layers of d 256, 8 heads of 32)
# at K = 4, B = 8, S = 128, DP sigma = 1, C = 1, the kernels on
TRAIN_ARGS = ["--preset", "100m", "--clients", "4", "--steps-per-round",
              "3", "--batch", "8", "--seq", "128", "--use-pallas"]
TRAIN_ROUNDS, TRAIN_ASYNC_ROUNDS, TRAIN_TAU = 3, 3, 2
TRAIN_RATE_ROUNDS = 3   # rounds of each timed block of the preset
TRAIN_SMOKE_ARGS = ["--smoke", "--clients", "2", "--rounds", "1",
                    "--steps-per-round", "1", "--batch", "2", "--seq", "32",
                    "--use-pallas"]
# the preset's flat proxy (6,291,456 params and 9 RMSNorm gains of 256),
# and its peers' and evaluation's rows: B x S tokens of d 256 / 768;
# attention [B, S, H, D] f32 (split TF32): proxy 8 heads of 32, private 12
# of 64
TRAIN_D, TRAIN_K = 6_293_760, 4
TRAIN_ATTN = {"proxy": dict(B=8, S=128, Hq=8, Hkv=8, D=32),
              "private": dict(B=8, S=128, Hq=12, Hkv=12, D=64)}
TRAIN_RMS = {"proxy": (1_024, 256), "private": (1_024, 768)}
# the scan's client route at falcon-mamba-7b's width (di 8,192, ds 16) over
# the preset's cohort and batch (K = 4, B = 8, S = 128)
TRAIN_SCAN = dict(B=8, S=128, di=8_192, ds=16)
# the train lockstep's grade on each leaf's gradient, kernel path against
# plain, normwise: only the peers' logits differ between the two, whose
# kernels agree with their plain versions to about 1e-6
TRAIN_GRAD_NORMWISE = 1e-4
# repro.core.accountant.epsilon_for(noise_multiplier=1.0, sample_rate=8 /
# 64, steps=9, delta=1e-5): the preset's 3 rounds x 3 steps, and the async
# run's; (sample_rate=2 / 64, steps=1): a smoke run's one step; from the
# JAX package's accountant, pinned here
EPSILON_TRAIN = 3.9927285274659177
EPSILON_TRAIN_SMOKE = 1.3620407962879644
# the resume phase: the main path killed after round 2 of 3 and resumed
# (epsilon_for(noise_multiplier=1.0, sample_rate=0.25, steps=12,
# delta=1e-5), 3 rounds x 4 steps, from the JAX package's accountant); the
# compressed run after round 1 of 2; async after round 3 of 6; the
# preset at K = 2, B = 8, S = 128, 2 rounds of 1 step after round 1
# (epsilon_for(1.0, 8 / 64, 2, 1e-5) pinned the same way)
RESUME_ROUNDS, RESUME_KILL = 3, 2
EPSILON_3_ROUNDS = 7.391781649014032
RESUME_TRAIN_ARGS = ["--preset", "100m", "--clients", "2",
                     "--steps-per-round", "1", "--batch", "8", "--seq",
                     "128", "--use-pallas"]
EPSILON_RESUME_TRAIN = 2.7241486272446718
GEMMA_TOKENS, GEMMA_LAYERS = (2, 2_048), 6
SMOKE_SERVE = (2, 12, 7)
DECODE_TOL = 2e-4   # tests/test_models.py:85-116, prefill + decode vs forward
# the serve phase's kernel calls: a prefill's attention of qwen2-7b and of a
# gemma3-4b local layer; rmsnorm's decode rows are SERVE_TOKENS[0] x RMS_D
SERVE_ATTN = dict(B=4, S=1_024, Hq=28, Hkv=4, D=128)
GEMMA_SERVE_ATTN = dict(B=2, S=2_048, Hq=8, Hkv=4, D=256, window=1_024)
SERVE_SCAN = dict(B=4, S=1_024, di=8_192, ds=16)
C_TYPES = {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
           "float": ctypes.c_float}   # of the parent's entry points
SFU_PER_CLOCK_SM, SMS = 16, 132   # H100 SXM: exponentials a clock an SM
# the attention routes' sweep: head dims of the tensor-core kernels (their
# compiled widths, then aligned widths zero-padded up to them: 8 and 40 (36
# f32) onto 64, 96 onto 128 in bf16, 72 onto 96 in f32, 136 and 248 onto
# 256), lengths around their 128-row and 16/64/128-key tiles, query heads
# per KV head, windows (0 masks every key of a causal row); the narrow
# loaders at head dims of every copy width (bf16: 2-byte rows at 33 and 255,
# 4-byte at 34, 8-byte at 36 and 100; f32: 4-byte at 1, 33 and 255, 8-byte
# at 30 and 98)
ROUTE_D = {torch.bfloat16: (64, 128, 256, 8, 40, 96, 136, 248),
           torch.float32: (64, 96, 128, 256, 8, 36, 40, 72, 136, 248)}
NARROW_D = {torch.bfloat16: (33, 34, 36, 100, 255),
            torch.float32: (1, 30, 33, 98, 255)}
ROUTE_S = (1, 63, 64, 65, 127, 129, 257)
ROUTE_GROUPS = (1, 2, 7)
ROUTE_WINDOWS = (None, 1, 17, 64, 0)


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.strip()
    return float(out.splitlines()[0]) * 1e6


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    return out.splitlines()[0]


def cuda_us(fn, n: int = TIMED_LAUNCHES) -> float:
    """Mean µs per call of ``fn`` over n back-to-back calls, timed with
    CUDA events after a warm-up of min(n, 10) calls."""
    for _ in range(min(n, 10)):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / n


def graph_us(fn, n: int = TIMED_LAUNCHES) -> float:
    """Mean µs per call of ``fn`` replayed from a CUDA graph of n captured
    calls: the device's time per call without the host's launch cost
    (``cuda_us`` includes it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / (5 * n)


def cold_us(fn, n: int = 20) -> float:
    """Mean device µs of ``fn`` with the L2 cache flushed before each call:
    a sum over 256 MB (about 80 µs of device time, five times the 50 MB L2,
    read only, so no dirty line is left to write back), then CUDA events
    around the call alone; the sum gives the host time to enqueue the call
    before the device reaches it."""
    flush = torch.zeros(64 * 2 ** 20, device="cuda")
    fn()
    total = 0.0
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.sum()
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end) * 1e3
    return total / n


def max_err(got, want) -> float:
    got, want = (torch.atleast_1d(t).float() for t in (got, want))
    return float((got - want).abs().max())


def check(name, got, want, dtype, tol: Optional[float] = None) -> float:
    """assert_close at the kernel tolerance (``tol`` where the kernel's
    tests state their own); the largest abs error."""
    tol = TOL[dtype] if tol is None else tol
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol,
                                   msg=lambda m: f"{name}: {m}")
    return max(max_err(g, w) for g, w in zip(got, want))


def tol_share(got, want, tol: float) -> float:
    """The largest |got − want| / (tol + tol·|want|): the share of the
    tolerance assert_close allows (rtol = atol = tol) that the worst
    element uses."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(float(((g.float() - w.float()).abs()
                      / (tol + tol * w.float().abs())).max())
               for g, w in zip(got, want))


def bound_us(n_bytes: float, n_ops: float, peak: float = F32_OPS_PER_S):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak
    return max(t_bytes, t_ops) * 1e6, "bytes" if t_bytes >= t_ops else \
        "operations"


class Case(NamedTuple):
    """One check of a kernel against its plain version; the first case of
    each ``row`` (the main shape) is also timed."""
    name: str
    dtype: torch.dtype
    shape: tuple
    kern: Callable
    plain: Callable
    lib: Optional[Callable]
    n_bytes: float
    n_ops: float
    peak: float = F32_OPS_PER_S     # the ops rate of the bound
    tol: Optional[float] = None     # None: TOL[dtype]
    calls: int = TIMED_LAUNCHES     # calls timed per column
    plain_calls: Optional[int] = None   # None: calls
    plain_graph: bool = True        # False: the plain version's graph
    row: Optional[str] = None       # the timed row it opens (None: name)
    exact: Optional[Callable] = None   # must equal the kernel bit for bit
    padded_ops: Optional[float] = None  # operations at the compiled width
    cold: bool = False              # also time with L2 flushed per call
    ops_name: str = "FLOP"          # what n_ops counts


def attention_pairs(S: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs the attention mask keeps at length S."""
    qp = np.arange(S)
    hi = qp if causal else np.full(S, S - 1)
    lo = np.zeros(S, np.int64) if window is None else \
        np.maximum(qp - window + 1, 0)
    return int(np.maximum(hi - lo + 1, 0).sum())


# ---------------------------------------------------------------------------
# the kernels against their plain versions


def attention_inputs(gen, B, S, Hq, Hkv, D, dtype, window=None,
                     causal=True):
    """q [B, S, Hq, D], k, v [B, S, Hkv, D] on the card, and the library
    yardstick: scaled_dot_product_attention on [B, H, S, D] views with the
    KV heads repeated beforehand (an explicit mask for a window)."""
    dev = torch.device("cuda")
    q = torch.randn((B, S, Hq, D), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    kr, vr = (t.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
              for t in (k, v))
    qt = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window is None:
        def lib():
            return sdpa(qt, kr, vr, is_causal=causal)
    else:
        pos = torch.arange(S, device=dev)
        mask = (pos[:, None] - pos[None, :]) < window
        if causal:
            mask &= pos[None, :] <= pos[:, None]

        def lib():
            return sdpa(qt, kr, vr, attn_mask=mask)
    return q, k, v, lib


def attention_cost(B, S, Hq, Hkv, D, dtype, window=None, causal=True):
    """(bytes, operations) of one attention call: q, k, v, out each once;
    4·D flops per kept (query, key) pair."""
    es = torch.tensor([], dtype=dtype).element_size()
    return (2 * B * S * Hq * D * es + 2 * B * S * Hkv * D * es,
            4 * D * B * Hq * attention_pairs(S, causal, window))


def mamba_inputs(gen, B, S, di, ds, dtype=torch.float32):
    """dt = softplus(N(0, 1)), x, B, C ~ N(0, 1), A = −exp(N(0, 1)), as
    tests/test_kernels.py draws them."""
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(randn(B, S, di))
    return (dt, randn(B, S, di).to(dtype), randn(B, S, ds), randn(B, S, ds),
            -torch.exp(randn(di, ds)))


def padded_rows(gen, B, D, dtype):
    """[B, D] on the card as core/dp.py lays out the per-example gradients:
    a view of a buffer whose row stride is padded to 128 bytes."""
    per_line = 128 // torch.tensor([], dtype=dtype).element_size()
    buf = torch.randn((B, -(-D // per_line) * per_line), generator=gen,
                      device="cuda").to(dtype)
    return buf[:, :D]


def clip_rows_cases(gen):
    """The rows route of the clip pair at the main path's [B, D] f32, then
    ragged B and D in f32 and bf16; each also bit for bit against the loop
    of the 1-D kernels it replaces on the main path."""
    from repro_torch import kernels
    from repro_torch.kernels import ref

    def vector_norms(x):
        return torch.stack([kernels.sumsq(r) for r in x])

    def vector_acc(x, s):
        acc = torch.zeros(x.shape[1], device="cuda")
        for i in range(x.shape[0]):
            acc = kernels.scale_accumulate(acc, x[i], s[i])
        return acc

    shapes = [(MAIN_B, MAIN_D, torch.float32, None),
              (MAIN_B, CIFAR_D, torch.float32, "cifar10"),
              (TABLE2_B, TABLE2_D, torch.float32, "table2"),
              (FIG6_B, FIG6_D, torch.float32, "fig6")] + [
        (MAIN_B, D, torch.float32, None) for D in FIG5_REGULAR_D] + [
        (B, D, dt, None) for B, D in ROWS_RAGGED
        for dt in (torch.float32, torch.bfloat16)]
    for B, D, dt, tag in shapes:
        es = torch.tensor([], dtype=dt).element_size()
        x = padded_rows(gen, B, D, dt)
        s = torch.rand((B,), generator=gen, device="cuda") + 0.01
        f32 = dt == torch.float32
        yield Case("sumsq_rows", dt, (B, D),
                   lambda x=x: kernels.sumsq_rows(x),
                   lambda x=x: ref.sumsq_rows_ref(x),
                   (lambda x=x: torch.linalg.vecdot(x, x)) if f32 else None,
                   B * D * es + 4 * B, 2 * B * D, plain_calls=10,
                   exact=lambda x=x: vector_norms(x),
                   row=tag and f"sumsq_rows {tag}")
        yield Case("clip_accumulate_rows", dt, (B, D),
                   lambda x=x, s=s: kernels.clip_accumulate_rows(x, s),
                   lambda x=x, s=s: ref.clip_accumulate_rows_ref(x, s),
                   (lambda x=x, s=s: torch.mv(x.T, s)) if f32 else None,
                   B * D * es + 4 * B + 4 * D, 2 * B * D, plain_calls=10,
                   exact=lambda x=x, s=s: vector_acc(x, s),
                   row=tag and f"clip_accumulate_rows {tag}")


def client_grid_cases(gen):
    """The stacked executor's launches: ``sumsq_rows`` over the cohort's
    [K·B, D] rows and the client-grid routes of the clip accumulate ([K,
    B, D] → [K, D]) and of Adam ([K, D], c1 / c2 per client) at the main
    round's K = 8, B = 250 and D = 199,210, then fig. 3's cifar10 D =
    656,810, then ragged shapes in f32 (and bf16 for the clip); each bit
    for bit against K launches of the flat kernel and within f32 2e-5 of
    its plain version. The library yardstick of the clip is
    ``torch.einsum`` over the cohort."""
    from repro_torch import kernels
    from repro_torch.kernels import ref

    def cohort(K, B, D, dt):
        rows = padded_rows(gen, K * B, D, dt)
        # [K, B, D] with the padded row stride, as core/dp.py's stacked
        # per-example gradients are laid out
        return rows.as_strided((K, B, D), (B * rows.stride(0),
                                           rows.stride(0), 1))

    hp = dict(stddev=1.0, n_units=MAIN_B, lr=1e-3, weight_decay=1e-4,
              b1=0.9, b2=0.999, eps=1e-8)
    shapes = [(MAIN_K, MAIN_B, MAIN_D, torch.float32, None),
              (MAIN_K, MAIN_B, CIFAR_D, torch.float32, "cifar10"),
              (3, 7, 1_025, torch.float32, "ragged"),
              (3, 7, 1_025, torch.bfloat16, "ragged")]
    for K, B, D, dt, tag in shapes:
        es = torch.tensor([], dtype=dt).element_size()
        g = cohort(K, B, D, dt)
        s = torch.rand((K, B), generator=gen, device="cuda") + 0.01
        suffix = "" if tag is None else f" {tag}"
        f32 = dt == torch.float32
        if f32:
            flat = g.reshape(K * B, D)
            yield Case("sumsq_rows", dt, (K * B, D),
                       lambda x=flat: kernels.sumsq_rows(x),
                       lambda x=flat: ref.sumsq_rows_ref(x),
                       lambda x=flat: torch.linalg.vecdot(x, x),
                       K * B * D * es + 4 * K * B, 2 * K * B * D,
                       plain_calls=3, calls=50,
                       exact=lambda x=flat, B=B: torch.cat(
                           [kernels.sumsq_rows(x[i:i + B])
                            for i in range(0, x.shape[0], B)]),
                       row=f"sumsq_rows clients{suffix}")
        yield Case("clip_accumulate_rows_clients", dt, (K, B, D),
                   lambda g=g, s=s: kernels.clip_accumulate_rows_clients(
                       g, s),
                   lambda g=g, s=s: ref.clip_accumulate_rows_clients_ref(
                       g, s),
                   (lambda g=g, s=s: torch.einsum("kbd,kb->kd", g, s))
                   if f32 else None,
                   K * B * D * es + 4 * K * B + 4 * K * D, 2 * K * B * D,
                   plain_calls=3, calls=50,
                   exact=lambda g=g, s=s: torch.stack(
                       [kernels.clip_accumulate_rows(g[k], s[k])
                        for k in range(g.shape[0])]),
                   row=None if tag is None else
                   f"clip_accumulate_rows_clients {tag}")
        if not f32:
            continue
        vecs = tuple(torch.randn((K, D), generator=gen, device="cuda")
                     for _ in range(4)) + (
            torch.rand((K, D), generator=gen, device="cuda"),)
        t = torch.arange(1, K + 1, device="cuda", dtype=torch.float32)
        c1, c2 = 1 - 0.9 ** t, 1 - 0.999 ** t
        yield Case("noise_adam_step_clients", dt, (K, D),
                   lambda v=vecs, c1=c1, c2=c2: kernels.noise_adam_step_clients(
                       *v, c1=c1, c2=c2, **hp),
                   lambda v=vecs, c1=c1, c2=c2:
                   ref.noise_adam_step_clients_ref(*v, c1=c1, c2=c2, **hp),
                   None, 32 * K * D + 8 * K, 19 * K * D, cold=tag is None,
                   exact=lambda v=vecs, c1=c1, c2=c2: tuple(
                       torch.stack(x) for x in zip(*(
                           kernels.noise_adam_step(
                               *(a[k] for a in v), c1=c1[k], c2=c2[k], **hp)
                           for k in range(v[0].shape[0])))),
                   row=None if tag is None else
                   f"noise_adam_step_clients {tag}")


def kernel_cases(gen):
    """Yield a :class:`Case` per checked shape; the main-path shape comes
    first per kernel."""
    from repro_torch import kernels
    from repro_torch.core.gossip import mix_matrix
    from repro_torch.kernels import ref
    dev = torch.device("cuda")

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for D in (MAIN_D,) + RAGGED_D:
        for dt in (torch.float32, torch.bfloat16):
            es = torch.tensor([], dtype=dt).element_size()
            x = randn(D, dtype=dt)
            yield Case("sumsq", dt, (D,), lambda x=x: kernels.sumsq(x),
                   lambda x=x: ref.sumsq_ref(x),
                   (lambda x=x: torch.dot(x, x)) if dt == torch.float32
                   else None, D * es + 4, 2 * D)
            acc, g = randn(D), randn(D, dtype=dt)
            scale = torch.rand((), generator=gen, device=dev)
            yield Case("scale_accumulate", dt, (D,),
                   lambda a=acc, g=g, s=scale: kernels.scale_accumulate(a, g, s),
                   lambda a=acc, g=g, s=scale: ref.scale_accumulate_ref(a, g, s),
                   (lambda a=acc, g=g, s=scale: torch.addcmul(a, g, s))
                   if dt == torch.float32 else None, 8 * D + D * es + 4, 2 * D)
        acc, noise, p, m = (randn(D) for _ in range(4))
        v = torch.rand((D,), generator=gen, device=dev)
        t = torch.full((), 3.0, device=dev)
        hp = dict(stddev=1.0, n_units=250, lr=1e-3, weight_decay=1e-4,
                  b1=0.9, b2=0.999, eps=1e-8, c1=1 - 0.9 ** t,
                  c2=1 - 0.999 ** t)
        args = (acc, noise, p, m, v)
        # bit for bit the plain version's arithmetic where it divides by
        # n_units (given as a tensor on the card: with a host scalar,
        # PyTorch's CUDA division multiplies by its f32 reciprocal; see
        # adam_checks); 6.4 MB at the main shape, which stays in the 50 MB
        # L2 across graph replays: also timed with L2 flushed
        yield Case("noise_adam_step", torch.float32, (D,),
               lambda a=args, hp=hp: kernels.noise_adam_step(*a, **hp),
               lambda a=args, hp=hp: ref.noise_adam_step_ref(*a, **hp),
               None, 32 * D + 8, 19 * D, cold=True,
               exact=lambda a=args, hp=hp: ref.noise_adam_step_ref(
                   *a, **dict(hp, n_units=torch.full((), 250.0, device=dev))))
    # the Adam step of fig. 3's cifar10 proxy
    args = tuple(randn(CIFAR_D) for _ in range(4)) + (
        torch.rand((CIFAR_D,), generator=gen, device=dev),)
    yield Case("noise_adam_step", torch.float32, (CIFAR_D,),
               lambda a=args, hp=hp: kernels.noise_adam_step(*a, **hp),
               lambda a=args, hp=hp: ref.noise_adam_step_ref(*a, **hp),
               None, 32 * CIFAR_D + 8, 19 * CIFAR_D, cold=True,
               row="noise_adam_step cifar10",
               exact=lambda a=args, hp=hp: ref.noise_adam_step_ref(
                   *a, **dict(hp, n_units=torch.full((), 250.0, device=dev))))
    # the Adam steps of the figures phase's conv proxies
    for D, tag in ((TABLE2_D, "table2"), (FIG6_D, "fig6")):
        args = tuple(randn(D) for _ in range(4)) + (
            torch.rand((D,), generator=gen, device=dev),)
        yield Case("noise_adam_step", torch.float32, (D,),
                   lambda a=args, hp=hp: kernels.noise_adam_step(*a, **hp),
                   lambda a=args, hp=hp: ref.noise_adam_step_ref(*a, **hp),
                   None, 32 * D + 8, 19 * D, row=f"noise_adam_step {tag}",
                   exact=lambda a=args, hp=hp: ref.noise_adam_step_ref(
                       *a, **dict(hp, n_units=torch.full((), 250.0,
                                                         device=dev))))
    # every vector one element off 16 bytes: the one-column accesses
    off = [randn(MAIN_D + 1)[1:] for _ in range(4)] + \
        [torch.rand((MAIN_D + 1,), generator=gen, device=dev)[1:]]
    yield Case("noise_adam_step", torch.float32, (MAIN_D, "off 1"),
               lambda a=off, hp=hp: kernels.noise_adam_step(*a, **hp),
               lambda a=off, hp=hp: ref.noise_adam_step_ref(*a, **hp),
               None, 0, 0,
               exact=lambda a=off, hp=hp: ref.noise_adam_step_ref(
                   *a, **dict(hp, n_units=torch.full((), 250.0, device=dev))))
    yield from clip_rows_cases(gen)
    yield from client_grid_cases(gen)
    mix_shapes = [(MAIN_K, MAIN_D), (MAIN_K, CIFAR_D)] + [
        (K, D) for K in RAGGED_K for D in RAGGED_D]
    # the figures phase's exchanges: fig. 5b's four mlp proxies, table 2's
    # four cnn1 proxies and fig. 6's eight VGG proxies
    mix_rows = {(MAIN_K, CIFAR_D): "fused_pushsum_mix cifar10",
                (TABLE2_K, TABLE2_D): "fused_pushsum_mix table2",
                (FIG6_K, FIG6_D): "fused_pushsum_mix fig6"}
    for K, D in mix_shapes + [(4, MAIN_D), (TABLE2_K, TABLE2_D),
                              (FIG6_K, FIG6_D)]:
        P = torch.rand((K, K), generator=gen, device=dev)
        P = P / P.sum(0, keepdim=True)   # column-stochastic, dense
        w = torch.rand((K,), generator=gen, device=dev) + 0.5
        for dt in (torch.float32, torch.bfloat16):
            es = torch.tensor([], dtype=dt).element_size()
            flat = randn(K, D, dtype=dt)
            for debias in (True, False):
                yield Case("fused_pushsum_mix", dt, (K, D, debias),
                       lambda f=flat, P=P, w=w, d=debias:
                       kernels.fused_pushsum_mix(f, w, P, debias=d),
                       lambda f=flat, P=P, w=w, d=debias:
                       ref.fused_pushsum_mix_ref(f, w, P, debias=d),
                       # the library yardstick is the product alone
                       (lambda f=flat, P=P: torch.matmul(P, f))
                       if dt == torch.float32 else None,
                       2 * K * D * es + 4 * K * K + 4 * K, 2 * K * K * D,
                       cold=True,
                       row=mix_rows.get((K, D)) if dt == torch.float32
                       and debias else None)
    # rows that start one element off 16 bytes: the one-column accesses
    P = torch.rand((MAIN_K, MAIN_K), generator=gen, device=dev)
    P = P / P.sum(0, keepdim=True)
    w = torch.rand((MAIN_K,), generator=gen, device=dev) + 0.5
    for dt in (torch.float32, torch.bfloat16):
        flat = randn(MAIN_K * MAIN_D + 1, dtype=dt)[1:].view(MAIN_K, MAIN_D)
        for debias in (True, False):
            yield Case("fused_pushsum_mix", dt, (MAIN_K, MAIN_D, debias, "off 1"),
                       lambda f=flat, P=P, w=w, d=debias:
                       kernels.fused_pushsum_mix(f, w, P, debias=d),
                       lambda f=flat, P=P, w=w, d=debias:
                       ref.fused_pushsum_mix_ref(f, w, P, debias=d),
                       None, 0, 0)
    # the exchanges of FedAvg and FML (mix "mean": every entry of P
    # non-zero) and CWT ("ring": a permutation, zero diagonal) at both
    # proxy widths of fig. 3
    for mix in ("mean", "ring"):
        P = torch.as_tensor(mix_matrix(mix, 0, MAIN_K), dtype=torch.float32,
                            device=dev)
        w = torch.rand((MAIN_K,), generator=gen, device=dev) + 0.5
        for D in (MAIN_D, CIFAR_D):
            flat = randn(MAIN_K, D)
            yield Case("fused_pushsum_mix", torch.float32,
                       (MAIN_K, D, True, mix),
                       lambda f=flat, P=P, w=w:
                       kernels.fused_pushsum_mix(f, w, P, debias=True),
                       lambda f=flat, P=P, w=w:
                       ref.fused_pushsum_mix_ref(f, w, P, debias=True),
                       None, 0, 0)
    # the stale exchange, inputs as tests/test_kernels.py:_stale_inputs
    for K, D in mix_shapes:
        P = torch.rand((K, K), generator=gen, device=dev) * 0.9 + 0.1
        P = P / P.sum(0, keepdim=True)
        kept = torch.diagonal(P).contiguous()
        sent = P - torch.diag(kept)
        for dt in (torch.float32, torch.bfloat16):
            es = torch.tensor([], dtype=dt).element_size()
            w = torch.rand((K,), generator=gen, device=dev) * 1.7 + 0.3
            buf_w0 = torch.rand((K,), generator=gen, device=dev) * 0.5
            args = (randn(K, D, dtype=dt), w.to(dt), kept, sent,
                    (0.1 * randn(K, D)).to(dt), buf_w0.to(dt))
            yield Case("fused_stale_mix", dt, (K, D),
                   lambda a=args: kernels.fused_stale_mix(*a),
                   lambda a=args: ref.fused_stale_mix_ref(*a),
                   # the library yardstick is the send product alone
                   (lambda a=args: torch.matmul(a[3], a[0]))
                   if dt == torch.float32 else None,
                   4 * K * D * es + 4 * K * K + 5 * K * es + 8 * K,
                   2 * K * K * D + 4 * K * D)
    yield from blocks_cases(gen)
    yield from llm_kernel_cases(gen)


def blocks_case(gen, K, D, S, dt, debias=False, row=None, cold=True):
    """One check of the shard-grid mix (the hier exchange's intra-shard
    half) on S shards of [K / S, K / S] column-stochastic blocks, against
    its plain version, and, not de-biased (as the hier exchange calls it),
    bit for bit against S launches of the flat kernel on the shards' rows
    (the mixed rows; the weights are torch products, and de-biased each
    path divides by its own product, whose rounding depends on the
    product's order); ``torch.bmm`` of the blocks with the shards' rows is
    the library yardstick (f32)."""
    from repro_torch import kernels
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    L = K // S
    blocks = torch.rand((S, L, L), generator=gen, device=dev)
    blocks = blocks / blocks.sum(1, keepdim=True)
    w = torch.rand((K,), generator=gen, device=dev) + 0.5
    flat = torch.randn((K, D), generator=gen, device=dev).to(dt)
    es = torch.tensor([], dtype=dt).element_size()

    def flat_launches():
        return (torch.cat([kernels.fused_pushsum_mix(
            flat[s * L:(s + 1) * L], w[s * L:(s + 1) * L], blocks[s],
            debias=debias)[0] for s in range(S)]),)

    return Case("fused_pushsum_mix_blocks", dt, (K, D, S, debias),
                lambda: kernels.fused_pushsum_mix_blocks(flat, w, blocks,
                                                         debias=debias),
                lambda: ref.fused_pushsum_mix_blocks_ref(flat, w, blocks,
                                                         debias=debias),
                (lambda: torch.bmm(blocks, flat.view(S, L, D)))
                if dt == torch.float32 else None,
                2 * K * D * es + 4 * S * L * L + 4 * K, 2 * S * L * L * D,
                cold=cold, row=row,
                exact=None if debias else flat_launches)


def blocks_cases(gen):
    """The shard-grid mix: the hier main set-up's [8, 199,210] at S = 2,
    4 and 8 (S = 2 not de-biased, as the hier exchange calls it, timed as
    the kernel's row; S = 4 and 8 timed under their own rows), fig_hier's
    [64, 199,210] at S = 8, L across every register bucket edge (8/9,
    16/17, 32/33) at two shards, f32 and bf16, with and without the
    de-bias; the train shape in :func:`train_kernel_cases`."""
    for S in (2, 4, 8):
        for dt in (torch.float32, torch.bfloat16):
            for debias in (False, True):
                yield blocks_case(
                    gen, MAIN_K, MAIN_D, S, dt, debias,
                    row=None if S == 2 else f"fused_pushsum_mix_blocks S={S}")
    for dt in (torch.float32, torch.bfloat16):
        yield blocks_case(gen, HIER_FIG_K, MAIN_D, 8, dt,
                          row="fused_pushsum_mix_blocks K=64")
    for L in (8, 9, 16, 17, 32, 33):
        for D in RAGGED_D:
            for dt in (torch.float32, torch.bfloat16):
                for debias in (False, True):
                    yield blocks_case(gen, 2 * L, D, 2, dt, debias,
                                      cold=False)


def llm_kernel_cases(gen):
    """The ops API's kernels: noise_sgd_step at the mlp proxy's width, the
    three LLM kernels at the full widths of qwen2-7b, gemma3-4b and
    falcon-mamba-7b, then ragged sizes."""
    from repro_torch import kernels
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_route, padded_head_dim
    dev = torch.device("cuda")

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    bf16 = torch.bfloat16
    hp = dict(stddev=1.0, n_units=250, lr=1e-3, weight_decay=1e-4)
    # bit for bit the plain version's arithmetic where it divides by
    # n_units (a tensor on the card; see adam_checks), at four, two and one
    # columns a thread (every vector aligned, or p one element off)
    dividing = dict(hp, n_units=torch.full((), 250.0, device=dev))
    for D in (MAIN_D,) + RAGGED_D:
        for dt in (torch.float32, torch.bfloat16):
            es = torch.tensor([], dtype=dt).element_size()
            for off in (0, 1) if D == MAIN_D else (0,):
                args = (randn(D), randn(D), randn(D + off, dtype=dt)[off:])
                yield Case("noise_sgd_step", dt,
                           (D,) + (("off 1",) if off else ()),
                           lambda a=args: kernels.noise_sgd_step(*a, **hp),
                           lambda a=args: ref.noise_sgd_step_ref(*a, **hp),
                           None, 8 * D + 2 * D * es, 7 * D,
                           exact=lambda a=args: ref.noise_sgd_step_ref(
                               *a, **dividing))

    # (rows, d, dtype, elements x is offset by, gain dtype): the vector path,
    # the scalar one (a row not a multiple of 16 bytes, or x off 16 bytes),
    # rows past the registers (re-read), a gain in the other dtype
    f32 = torch.float32
    for rows, d, dt, off, gdt in [
            (RMS_ROWS, RMS_D, bf16, 0, bf16), (RMS_ROWS, RMS_D, f32, 0, f32),
            (RMS_ROWS, RMS_D, bf16, 1, bf16), (1, 64, f32, 0, f32),
            (77, 1_000, f32, 0, f32), (77, 1_000, bf16, 0, bf16),
            (300, 33, bf16, 0, bf16), (2, 8_192, f32, 0, f32),
            (77, 1_000, bf16, 0, f32), (5, 3_584, f32, 3, bf16),
            (3, 40_000, f32, 0, f32), (3, 9_001, bf16, 0, bf16),
            (9, 70_000, bf16, 0, bf16)]:
        es = torch.tensor([], dtype=dt).element_size()
        x = randn(rows * d + off, dtype=dt)[off:].view(rows, d)
        g = randn(d, dtype=gdt)
        row = {(bf16, 0): "rmsnorm", (f32, 0): "rmsnorm f32",
               (bf16, 1): "rmsnorm scalar"}.get((dt, off)) \
            if (rows, d) == (RMS_ROWS, RMS_D) else "rmsnorm"
        yield Case("rmsnorm", dt, (rows, d, off, str(gdt)),
                   lambda x=x, g=g: kernels.rmsnorm(x, g),
                   lambda x=x, g=g: ref.rmsnorm_ref(x, g),
                   lambda x=x, g=g, d=d: torch.nn.functional.rms_norm(
                       x, (d,), weight=g.to(x.dtype), eps=1e-6),
                   2 * rows * d * es + d * g.element_size(), 4 * rows * d,
                   row=row)

    for label, shape in (("flash_attention", QWEN_ATTN),
                         ("flash_attention window", GEMMA_LOCAL)):
        q, k, v, lib = attention_inputs(gen, dtype=bf16, **shape)
        win = shape.get("window")
        yield Case("flash_attention", bf16, tuple(shape.values()),
                   lambda q=q, k=k, v=v, w=win:
                   kernels.gqa_flash_attention(q, k, v, window=w),
                   lambda q=q, k=k, v=v, w=win:
                   ref.gqa_flash_attention_ref(q, k, v, window=w),
                   lib, *attention_cost(dtype=bf16, **shape),
                   peak=BF16_OPS_PER_S, calls=FULL_WIDTH_CALLS, row=label)
    # f32 runs the split-TF32 kernel, bound by f32-grade products at 165
    # TFLOP/s; phi-3-vision's head dim 96 runs the wgmma kernel at its
    # 128-wide instantiation (its bound at D = 96, and beside it the padded
    # work's) and the split-TF32 kernel at its own width; the unaligned head
    # dims 100 (bf16) and 98 (f32) run the narrow loaders at the 128-wide
    # instantiations
    for label, dt, shape, peak in (
            ("flash_attention f32", torch.float32, QWEN_ATTN, TF32X3_OPS_PER_S),
            ("flash_attention phi-3-vision", bf16, PHI3V_ATTN,
             BF16_OPS_PER_S),
            ("flash_attention phi-3-vision f32", torch.float32, PHI3V_ATTN,
             TF32X3_OPS_PER_S),
            ("flash_attention unaligned", bf16, UNALIGNED_ATTN,
             BF16_OPS_PER_S),
            ("flash_attention unaligned f32", torch.float32,
             UNALIGNED_ATTN_F32, TF32X3_OPS_PER_S)) + tuple(
            (f"flash_attention unaligned {name}", dt, dict(PHI3V_ATTN, D=D),
             BF16_OPS_PER_S if dt == bf16 else TF32X3_OPS_PER_S)
            for name, dt, D in NARROWER_ATTN):
        q, k, v, lib = attention_inputs(gen, dtype=dt, **shape)
        route = flash_route(dt, shape["D"])
        padded = dict(shape, D=padded_head_dim(shape["D"], route))
        yield Case("flash_attention", dt, tuple(shape.values()),
                   lambda q=q, k=k, v=v: kernels.gqa_flash_attention(q, k, v),
                   lambda q=q, k=k, v=v: ref.gqa_flash_attention_ref(q, k, v),
                   lib, *attention_cost(dtype=dt, **shape), peak=peak,
                   calls=FULL_WIDTH_CALLS, row=label,
                   padded_ops=attention_cost(dtype=dt, **padded)[1]
                   if padded != shape else None)
    for D in (32, 64, 128, 256):
        for S, G, causal, win in [(1, 1, True, None), (100, 2, False, None),
                                  (257, 7, True, 64), (130, 1, False, 30)]:
            for dt in (torch.float32, bf16):
                q, k, v, _ = attention_inputs(gen, 2, S, G, 1, D, dt,
                                              window=win, causal=causal)
                kw = dict(causal=causal, window=win)
                if G == 1:   # the [B, H, S, D] entry point
                    args = tuple(t.transpose(1, 2).contiguous()
                                 for t in (q, k, v))
                    kern = lambda a=args, kw=kw: kernels.flash_attention(*a, **kw)
                    plain = lambda a=args, kw=kw: ref.flash_attention_ref(*a, **kw)
                else:
                    kern = lambda a=(q, k, v), kw=kw: \
                        kernels.gqa_flash_attention(*a, **kw)
                    plain = lambda a=(q, k, v), kw=kw: \
                        ref.gqa_flash_attention_ref(*a, **kw)
                yield Case("flash_attention", dt, (2, S, G, 1, D, causal, win),
                           kern, plain, None, 0, 0)

    # the scan's bound: its bytes, or one exponential a state and step on
    # the special-function units (every exp on MUFU, as expf forms it; FMA
    # polynomials could take some off them), whichever takes longer
    sfu = SFU_PER_CLOCK_SM * SMS * sm_clock_hz()
    for row, dt, shape, args in scan_cases(gen):
        B, S, di, ds = shape[:4]
        timed = dict(row=row, calls=FULL_WIDTH_CALLS, plain_calls=2,
                     plain_graph=False, peak=sfu, ops_name="exp") \
            if row is not None else {}
        yield Case("mamba_scan", dt, shape,
                   lambda a=args: kernels.mamba_scan(*a),
                   lambda a=args: ref.mamba_scan_ref(*a), None,
                   4 * (3 * B * S * di + 2 * B * S * ds + di * ds)
                   if row else 0, B * S * di * ds if row else 0,
                   tol=SCAN_TOL if dt == torch.float32 else None, **timed)

    # the serve phase's shapes: a prefill's attention (qwen2-7b; a gemma3-4b
    # local layer over its window), rmsnorm's decode step (its prefill call
    # is the "rmsnorm" row's 4,096 x 3,584), the scan's prefill from the
    # cache's state with the final state out (xc, dt, B, C in f32)
    for label, shape in (("flash_attention serve", SERVE_ATTN),
                         ("flash_attention serve window", GEMMA_SERVE_ATTN)):
        q, k, v, lib = attention_inputs(gen, dtype=bf16, **shape)
        win = shape.get("window")
        yield Case("flash_attention", bf16, tuple(shape.values()),
                   lambda q=q, k=k, v=v, w=win:
                   kernels.gqa_flash_attention(q, k, v, window=w),
                   lambda q=q, k=k, v=v, w=win:
                   ref.gqa_flash_attention_ref(q, k, v, window=w),
                   lib, *attention_cost(dtype=bf16, **shape),
                   peak=BF16_OPS_PER_S, calls=FULL_WIDTH_CALLS, row=label)
    x, g = randn(SERVE_TOKENS[0], RMS_D, dtype=bf16), randn(RMS_D, dtype=bf16)
    yield Case("rmsnorm", bf16, (SERVE_TOKENS[0], RMS_D, 0, str(bf16)),
               lambda: kernels.rmsnorm(x, g), lambda: ref.rmsnorm_ref(x, g),
               lambda: torch.nn.functional.rms_norm(x, (RMS_D,), weight=g,
                                                    eps=1e-6),
               2 * SERVE_TOKENS[0] * RMS_D * 2 + RMS_D * 2,
               4 * SERVE_TOKENS[0] * RMS_D, row="rmsnorm serve decode")
    B, S, di, ds = SERVE_SCAN.values()
    args = mamba_inputs(gen, B, S, di, ds)
    h0 = randn(B, di, ds)
    yield Case("mamba_scan", torch.float32, (B, S, di, ds, "h0, final state"),
               lambda: kernels.mamba_scan(*args, h0=h0, return_state=True),
               lambda: ref.mamba_scan_ref(*args, h0, return_state=True),
               None, 4 * (3 * B * S * di + 2 * B * S * ds + di * ds
                          + 2 * B * di * ds),
               B * S * di * ds, peak=sfu, ops_name="exp", tol=SCAN_TOL,
               calls=FULL_WIDTH_CALLS, plain_calls=2, plain_graph=False,
               row="mamba_scan serve")
    yield from train_kernel_cases(gen)


def train_kernel_cases(gen):
    """The train phase's shapes: the sync and the stale mix of the
    preset's four proxies [4, 6,293,760] f32 (P column-stochastic, as the
    exponential graph's), and the peers' and evaluation's RMSNorm and
    attention (f32, the split-TF32 route) at B = 8, S = 128."""
    from repro_torch import kernels
    from repro_torch.kernels import ref
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    K, D = TRAIN_K, TRAIN_D
    P = torch.rand((K, K), generator=gen, device=dev) * 0.9 + 0.1
    P = P / P.sum(0, keepdim=True)
    w = torch.rand((K,), generator=gen, device=dev) + 0.5
    flat = randn(K, D)
    yield Case("fused_pushsum_mix", torch.float32, (K, D, True),
               lambda: kernels.fused_pushsum_mix(flat, w, P),
               lambda: ref.fused_pushsum_mix_ref(flat, w, P),
               lambda: torch.matmul(P, flat),
               2 * K * D * 4 + 4 * K * K + 4 * K, 2 * K * K * D,
               row="fused_pushsum_mix train")
    yield blocks_case(gen, K, D, 2, torch.float32,
                      row="fused_pushsum_mix_blocks train")
    kept = torch.diagonal(P).contiguous()
    sent = P - torch.diag(kept)
    args = (flat, w, kept, sent, 0.1 * randn(K, D),
            torch.rand((K,), generator=gen, device=dev) * 0.5)
    yield Case("fused_stale_mix", torch.float32, (K, D),
               lambda: kernels.fused_stale_mix(*args),
               lambda: ref.fused_stale_mix_ref(*args),
               lambda: torch.matmul(sent, flat),
               4 * K * D * 4 + 4 * K * K + 5 * K * 4 + 8 * K,
               2 * K * K * D + 4 * K * D, row="fused_stale_mix train")
    for model, shape in TRAIN_ATTN.items():
        q, k, v, lib = attention_inputs(gen, dtype=torch.float32, **shape)
        yield Case("flash_attention", torch.float32, tuple(shape.values()),
                   lambda q=q, k=k, v=v: kernels.gqa_flash_attention(q, k, v),
                   lambda q=q, k=k, v=v: ref.gqa_flash_attention_ref(q, k, v),
                   lib, *attention_cost(dtype=torch.float32, **shape),
                   peak=TF32X3_OPS_PER_S, row=f"flash_attention train {model}")
    for model, (rows, d) in TRAIN_RMS.items():
        x, g = randn(rows, d), randn(d)
        yield Case("rmsnorm", torch.float32, (rows, d, 0, str(torch.float32)),
                   lambda x=x, g=g: kernels.rmsnorm(x, g),
                   lambda x=x, g=g: ref.rmsnorm_ref(x, g),
                   lambda x=x, g=g, d=d: torch.nn.functional.rms_norm(
                       x, (d,), weight=g, eps=1e-6),
                   2 * rows * d * 4 + d * 4, 4 * rows * d,
                   row=f"rmsnorm train {model}")
    yield from client_route_cases(gen)


def client_route_cases(gen):
    """The client routes that a client step vmapped over the preset's
    cohort (K = 4) launches in its peers' forwards: rmsnorm's client grid
    at the proxy's and the private model's rows ([4, 1,024, 256] / [4,
    1,024, 768] f32, each client its own gain; also the scalar
    instantiation at d = 255 and bf16), attention with the clients folded
    into its batch ([32, 128, 8, 32] / [32, 128, 12, 64] f32, split TF32)
    and the scan's client route at falcon-mamba-7b's width ([4, 8, 128,
    8,192], ds 16, each client its own A); each bit for bit against K
    launches of the flat kernel and within its tolerance of its plain
    version. Library yardsticks: ``F.rms_norm`` under ``torch.func.vmap``
    (one gain a client), SDPA on the folded batch, none for the scan."""
    from torch.func import vmap

    from repro_torch import kernels
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    K = TRAIN_K

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    rms_shapes = [(rows, d, torch.float32, f"rmsnorm_clients{tag}")
                  for tag, (rows, d) in zip(("", " private"),
                                            TRAIN_RMS.values())]
    rms_shapes += [(64, 255, torch.float32, None),
                   (64, 264, torch.bfloat16, None)]
    for rows, d, dt, row in rms_shapes:
        x, g = randn(K, rows, d, dtype=dt), randn(K, d, dtype=dt)
        es = torch.tensor([], dtype=dt).element_size()
        yield Case("rmsnorm_clients", dt, (K, rows, d),
                   lambda x=x, g=g: kernels.rmsnorm_clients(x, g),
                   lambda x=x, g=g: ref.rmsnorm_clients_ref(x, g),
                   lambda x=x, g=g, d=d: vmap(
                       lambda a, b: torch.nn.functional.rms_norm(
                           a, (d,), weight=b, eps=1e-6))(x, g),
                   2 * K * rows * d * es + K * d * es, 4 * K * rows * d,
                   exact=lambda x=x, g=g: torch.stack(
                       [kernels.rmsnorm(x[k], g[k]) for k in range(K)]),
                   row=row)
    for tag, shape in zip(("", " private"), TRAIN_ATTN.values()):
        folded = dict(shape, B=K * shape["B"])
        q, k, v, lib = attention_inputs(gen, dtype=torch.float32, **folded)
        q, k, v = (t.reshape((K, shape["B"]) + tuple(t.shape[1:]))
                   for t in (q, k, v))
        yield Case("flash_attention_clients", torch.float32,
                   tuple(folded.values()),
                   lambda q=q, k=k, v=v: vmap(kernels.gqa_flash_attention)(
                       q, k, v),
                   lambda q=q, k=k, v=v: ref.gqa_flash_attention_ref(
                       *(t.flatten(0, 1) for t in (q, k, v))).reshape(
                           q.shape),
                   lib, *attention_cost(dtype=torch.float32, **folded),
                   peak=TF32X3_OPS_PER_S,
                   exact=lambda q=q, k=k, v=v: torch.stack(
                       [kernels.gqa_flash_attention(q[i], k[i], v[i])
                        for i in range(K)]),
                   row=f"flash_attention_clients{tag}")
    B, S, di, ds = TRAIN_SCAN.values()
    per = [mamba_inputs(gen, B, S, di, ds) for _ in range(K)]
    args = tuple(torch.stack(t) for t in zip(*per))
    yield Case("mamba_scan_clients", torch.float32, (K, B, S, di, ds),
               lambda: kernels.mamba_scan_clients(*args),
               lambda: ref.mamba_scan_clients_ref(*args), None,
               4 * K * (3 * B * S * di + 2 * B * S * ds + di * ds),
               K * B * S * di * ds,
               peak=SFU_PER_CLOCK_SM * SMS * sm_clock_hz(), ops_name="exp",
               tol=SCAN_TOL, calls=FULL_WIDTH_CALLS, plain_calls=2,
               plain_graph=False,
               exact=lambda: torch.stack([kernels.mamba_scan(*p)
                                          for p in per]),
               row="mamba_scan_clients")


def scan_cases(gen):
    """The scan's checks as (timed row or None, dtype, shape, (dt, x, B, C,
    A)): falcon-mamba-7b's and jamba-1.5-large's widths (timed), the sweep
    of state sizes, lengths and batches in f32 and with dt, B and C in
    bf16, then ragged widths in f32 and bf16."""
    bf16 = torch.bfloat16
    for label, width in (("mamba_scan", MAMBA), ("mamba_scan jamba", JAMBA)):
        B, S, di, ds = width.values()
        yield label, torch.float32, (B, S, di, ds), mamba_inputs(gen, B, S,
                                                                 di, ds)
    for ds in SCAN_DS:
        for S in SCAN_S:
            for B in SCAN_B:
                for bf in (False, True):
                    dt, x, Bm, C, A = mamba_inputs(gen, B, S, 96 + ds, ds)
                    if bf:   # bf16 inputs, f32 out: dt, B and C in bf16
                        dt, Bm, C = (t.to(bf16) for t in (dt, Bm, C))
                    yield None, torch.float32, (
                        B, S, 96 + ds, ds, "bf16 dt B C" if bf else "f32"), \
                        (dt, x, Bm, C, A)
    for B, S, di, ds in [(2, 100, 100, 16), (1, 257, 1_024, 4),
                         (2, 33, 64, 64), (1, 1, 8, 8)]:
        for dt in (torch.float32, bf16):
            yield None, dt, (B, S, di, ds), mamba_inputs(gen, B, S, di, ds,
                                                         dt)


def scan_state_checks():
    """On every scan case: y bit for bit the same whether the final state
    is asked for or not; from a random state h0, y and the final state
    against the plain version's at the scan's tolerance."""
    from repro_torch import kernels
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(7)
    n, worst = 0, 0.0
    for _, dt, shape, args in scan_cases(gen):
        y = kernels.mamba_scan(*args)
        y2, _ = kernels.mamba_scan(*args, return_state=True)
        assert torch.equal(y, y2), f"mamba_scan {shape}: y changed bits " \
            "when the final state was asked for"
        h0 = torch.randn((shape[0], shape[2], shape[3]), generator=gen,
                         device="cuda")
        worst = max(worst, check(
            f"mamba_scan {dt} {shape} from h0", kernels.mamba_scan(
                *args, h0=h0, return_state=True),
            ref.mamba_scan_ref(*args, h0, return_state=True),
            dt, SCAN_TOL if dt == torch.float32 else None))
        n += 1
    print(f"scan state: {n} cases, y bit-equal with and without the final "
          f"state; from h0 y and the final state within {worst:.3e} of the "
          "plain version")


def parent_scan(parent: Path):
    """This tree's scan without a state, bit for bit against the scan of
    ``parent`` (a checkout of a commit whose scan takes no state: before
    the serve path), built with nvcc from its csrc into a library of its
    own, on every scan case."""
    from repro_torch import kernels
    from repro_torch.kernels import _build
    src = parent / "src" / "repro_torch" / "kernels" / "csrc" / \
        "mamba_scan.cu"
    P, I = ctypes.c_void_p, ctypes.c_int
    want = (P, I, P, I, P, I, P, I, P, P, I, ctypes.c_int64, I, I, P)
    got = c_params(src, "repro_mamba_scan")
    if got != want:
        raise SystemExit(f"--parent-scan: repro_mamba_scan in {parent} is "
                         f"declared with {[t.__name__ for t in got]}; this "
                         f"comparison calls it with "
                         f"{[t.__name__ for t in want]}")
    out_dir = _build.BUILD_ROOT.parent / "parent_scan"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libparent_scan.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-cudart", "shared",
                    "-shared", str(src), "-o", str(lib_path)], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib_path)).repro_mamba_scan
    fn.argtypes = got
    codes = _build.DTYPE_CODES
    gen = torch.Generator(device="cuda").manual_seed(8)
    n = 0
    for _, _, shape, (dt, x, Bm, C, A) in scan_cases(gen):
        y = torch.empty_like(x)
        err = fn(dt.data_ptr(), codes[dt.dtype], x.data_ptr(),
                 codes[x.dtype], Bm.data_ptr(), codes[Bm.dtype], C.data_ptr(),
                 codes[C.dtype], A.data_ptr(), y.data_ptr(), x.shape[0],
                 x.shape[1], x.shape[2], A.shape[1],
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        assert torch.equal(kernels.mamba_scan(dt, x, Bm, C, A), y), \
            f"mamba_scan {shape}: differs from the parent's scan"
        n += 1
    print(f"before/after mamba_scan: bit-equal to the parent's scan on all "
          f"{n} scan cases")


SOURCES = {
    "sumsq": ("src/repro_torch/kernels/csrc/dp_clip.cu",
              "src/repro/kernels/dp_clip.py:40",
              "src/repro/kernels/dp_clip.py::sumsq"),
    "scale_accumulate": ("src/repro_torch/kernels/csrc/dp_clip.cu",
                         "src/repro/kernels/dp_clip.py:68",
                         "src/repro/kernels/dp_clip.py::scale_accumulate"),
    # the rows routes of the two: the DP step's [B, D] in one call each
    "sumsq_rows": ("src/repro_torch/kernels/csrc/dp_clip.cu",
                   "src/repro/kernels/dp_clip.py:40",
                   "src/repro/kernels/dp_clip.py::sumsq"),
    "clip_accumulate_rows": ("src/repro_torch/kernels/csrc/dp_clip.cu",
                             "src/repro/kernels/dp_clip.py:68",
                             "src/repro/kernels/dp_clip.py::"
                             "scale_accumulate"),
    "noise_adam_step": ("src/repro_torch/kernels/csrc/dp_step.cu",
                        "src/repro/kernels/dp_step.py:115",
                        "src/repro/kernels/dp_step.py::noise_adam_step"),
    # the client-grid routes: the stacked executor's one launch a local
    # step for the cohort, where the reference's jax.vmap over the
    # pallas_call adds a grid axis
    "clip_accumulate_rows_clients": ("src/repro_torch/kernels/csrc/"
                                     "dp_clip.cu",
                                     "src/repro/kernels/dp_clip.py:68",
                                     "src/repro/kernels/dp_clip.py::"
                                     "scale_accumulate"),
    "noise_adam_step_clients": ("src/repro_torch/kernels/csrc/dp_step.cu",
                                "src/repro/kernels/dp_step.py:115",
                                "src/repro/kernels/dp_step.py::"
                                "noise_adam_step"),
    "fused_pushsum_mix": ("src/repro_torch/kernels/csrc/pushsum_mix.cu",
                          "src/repro/kernels/pushsum_mix.py:63",
                          "src/repro/kernels/pushsum_mix.py::"
                          "fused_pushsum_mix"),
    # the hier exchange's intra-shard half: the mix kernel on a grid over
    # the shards, where the reference vmaps fused_pushsum_mix over them
    # (src/repro/core/gossip.py:497-512)
    "fused_pushsum_mix_blocks": ("src/repro_torch/kernels/csrc/pushsum_mix.cu",
                                 "src/repro/kernels/pushsum_mix.py:63",
                                 "src/repro/kernels/pushsum_mix.py::"
                                 "fused_pushsum_mix"),
    "fused_stale_mix": ("src/repro_torch/kernels/csrc/stale_mix.cu",
                        "src/repro/kernels/pushsum_mix.py:117",
                        "src/repro/kernels/pushsum_mix.py::fused_stale_mix"),
    "noise_sgd_step": ("src/repro_torch/kernels/csrc/dp_step.cu",
                       "src/repro/kernels/dp_step.py:62",
                       "src/repro/kernels/dp_step.py::noise_sgd_step"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:48",
                "src/repro/kernels/rmsnorm.py::rmsnorm"),
    # bf16 at every head dim of whole 16-byte rows: the tensor cores (the
    # ops API's calls)
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
                        "src/repro/kernels/flash_attention.py:106",
                        "src/repro/kernels/flash_attention.py::"
                        "flash_attention"),
    # f32 at every head dim of whole 16-byte rows: split TF32 on the
    # tensor cores
    "flash_attention_tf32x3": (
        "src/repro_torch/kernels/csrc/flash_attention_tf32x3.cu",
        "src/repro/kernels/flash_attention.py:106",
        "src/repro/kernels/flash_attention.py::flash_attention"),
    # the narrow loaders of both: every call the 16-byte loaders do not
    # take (the unaligned head dims, misaligned views)
    "flash_attention_narrow": (
        "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "src/repro/kernels/flash_attention.py:106",
        "src/repro/kernels/flash_attention.py::flash_attention"),
    "flash_attention_tf32x3_narrow": (
        "src/repro_torch/kernels/csrc/flash_attention_tf32x3.cu",
        "src/repro/kernels/flash_attention.py:106",
        "src/repro/kernels/flash_attention.py::flash_attention"),
    "mamba_scan": ("src/repro_torch/kernels/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan.py:74",
                   "src/repro/kernels/mamba_scan.py::mamba_scan"),
    # the client routes of a client step vmapped over the cohort (the
    # stacked LLM train step's peers): rmsnorm and the scan on a grid over
    # clients, attention (split TF32 at the train shapes) with the clients
    # folded into its batch, where the reference's jax.vmap over the
    # pallas_call adds a grid axis
    "rmsnorm_clients": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                        "src/repro/kernels/rmsnorm.py:48",
                        "src/repro/kernels/rmsnorm.py::rmsnorm"),
    "flash_attention_clients": (
        "src/repro_torch/kernels/csrc/flash_attention_tf32x3.cu",
        "src/repro/kernels/flash_attention.py:106",
        "src/repro/kernels/flash_attention.py::flash_attention"),
    "mamba_scan_clients": ("src/repro_torch/kernels/csrc/mamba_scan.cu",
                           "src/repro/kernels/mamba_scan.py:74",
                           "src/repro/kernels/mamba_scan.py::mamba_scan"),
}


def check_kernels():
    """Every case checked; the first case of each row (the main-path shape
    of each kernel) timed."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for c in kernel_cases(gen):
        got, want = c.kern(), c.plain()
        err = check(f"{c.name} {c.dtype} {c.shape}", got, want, c.dtype,
                    c.tol)
        tol = TOL[c.dtype] if c.tol is None else c.tol
        if c.name == "fused_stale_mix" and c.dtype == torch.float32:
            # explicitly rounded re-bias, merge and de-bias: z' bit-equal
            assert torch.equal(got[0], want[0]), f"z' differs at {c.shape}"
        if c.exact is not None:
            exact = c.exact()
            assert all(torch.equal(g, w) for g, w in zip(
                got if isinstance(got, tuple) else (got,),
                exact if isinstance(exact, tuple) else (exact,))), \
                f"{c.name} {c.dtype} {c.shape} differs bit for bit"
        torch.cuda.synchronize()
        print(f"check {c.name:18s} {str(c.dtype):15s} {str(c.shape):22s} "
              f"max_abs_err {err:.3e}")
        row = c.row or c.name
        if row in rows:
            continue
        b_us, b_by = bound_us(c.n_bytes, c.n_ops, c.peak)
        pn = c.plain_calls or c.calls
        rows[row] = dict(
            shape=c.shape, dtype=str(c.dtype), err=err, n_bytes=c.n_bytes,
            n_ops=c.n_ops, ops_name=c.ops_name,
            share=tol_share(got, want, tol),
            padded_bound_us=None if c.padded_ops is None
            else bound_us(c.n_bytes, c.padded_ops, c.peak)[0],
            kernel_us=cuda_us(c.kern, c.calls), plain_us=cuda_us(c.plain, pn),
            bound_us=b_us, bound_by=b_by,
            bytes_bound_us=c.n_bytes / HBM_BYTES_PER_S * 1e6,
            library_us=cuda_us(c.lib, c.calls) if c.lib else None,
            kernel_graph_us=graph_us(c.kern, c.calls),
            plain_graph_us=graph_us(c.plain, pn) if c.plain_graph else None,
            library_graph_us=graph_us(c.lib, c.calls) if c.lib else None,
            kernel_cold_us=cold_us(c.kern) if c.cold else None,
            library_cold_us=cold_us(c.lib) if c.cold and c.lib else None)
        if not c.plain_graph:
            print(f"{row}: the plain version's CUDA-graph time is not "
                  "measured: it is a Python loop over the sequence, about "
                  "ten torch ops a step, too many nodes for a graph of "
                  "repeated calls")
        torch.cuda.empty_cache()
    return rows


def route_sweep(gen, dt, key, head_dims):
    """Every case of one attention launch key (``wgmma``, ``tf32x3`` or
    either's ``/narrow`` loader) at ``head_dims`` (B = 2, two KV heads;
    group 1 through the [B, H, S, D] entry point), each against its plain
    version at its dtype's tolerance, every call launched under ``key``; a
    causal window of 0 gives exactly 0. Returns the number of cases."""
    from repro_torch import kernels
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_route

    n, worst = 0, {}
    kernels.reset_launch_counts()
    for D in head_dims:
        assert flash_route(dt, D) == key.split("/")[0], (dt, D)
        for S in ROUTE_S:
            for G in ROUTE_GROUPS:
                q, k, v, _ = attention_inputs(gen, 2, S, 2 * G, 2, D, dt)
                if G == 1:
                    q, k, v = (t.transpose(1, 2).contiguous()
                               for t in (q, k, v))
                    kern, plain = kernels.flash_attention, \
                        ref.flash_attention_ref
                else:
                    kern, plain = kernels.gqa_flash_attention, \
                        ref.gqa_flash_attention_ref
                for causal in (True, False):
                    for win in ROUTE_WINDOWS:
                        kw = dict(causal=causal, window=win)
                        got = kern(q, k, v, **kw)
                        err = check(f"attention {key} D={D} S={S} G={G} "
                                    f"{kw}", got, plain(q, k, v, **kw), dt)
                        if causal and win == 0:
                            assert bool((got == 0).all()), (D, S, G)
                        worst[D] = max(worst.get(D, 0.0), err)
                        n += 1
    torch.cuda.synchronize()
    routes = kernels.route_launch_counts()
    expect(routes, **{f"flash_attention/{key}": n})
    print(f"attention routes: {n} {dt} cases on {key} (D {head_dims}, S "
          f"{ROUTE_S}, groups {ROUTE_GROUPS}, causal and not, windows "
          f"{ROUTE_WINDOWS}) agree with the plain version; max abs err by D "
          + ", ".join(f"{d}: {e:.3e}" for d, e in worst.items()))
    return n


def misaligned_views(gen, dt):
    """Views of an aligned head dim (64) whose bases lie past a 16-byte
    boundary (bf16 2, 4 and 8 bytes; f32 4, 8 and 12; before the narrow
    loaders the tensor-core kernels refused them): each on the narrow
    loader at the copy width its alignment allows, against the plain
    version, both entry points. Returns the launches."""
    from repro_torch import kernels
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_copy_width

    es = torch.tensor([], dtype=dt).element_size()
    widths, n = set(), 0
    kernels.reset_launch_counts()
    for off in {torch.bfloat16: (1, 2, 4), torch.float32: (1, 2, 3)}[dt]:
        for G in (1, 2):
            q, k, v, _ = attention_inputs(gen, 1, 129, 2 * G, 2, 64, dt)
            if G == 1:
                q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            views = []
            for t in (q, k, v):
                flat = torch.empty(t.numel() + 16, dtype=dt, device="cuda")
                base = (-(flat.data_ptr() // es)) % (16 // es)
                view = flat[base + off:base + off + t.numel()].view(t.shape)
                views.append(view.copy_(t))
            widths.add(flash_copy_width(64, es, [t.data_ptr() for t in views],
                                        views[0].stride()[:-1]))
            kern, plain = (kernels.flash_attention, ref.flash_attention_ref) \
                if G == 1 else (kernels.gqa_flash_attention,
                                ref.gqa_flash_attention_ref)
            for causal, win in ((True, None), (False, 17)):
                got = kern(*views, causal=causal, window=win)
                check(f"misaligned {dt} view off {off} G={G}", got,
                      plain(q, k, v, causal=causal, window=win), dt)
                n += 1
    route = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}[dt]
    expect(kernels.route_launch_counts(),
           **{f"flash_attention/{route}/narrow": n})
    print(f"attention routes: {n} misaligned {dt} views of D = 64 (copy "
          f"widths {sorted(widths)}) run on the narrow loader and agree with "
          "the plain version")
    return n


def attention_routes():
    """Both tensor-core kernels, bf16 (wgmma) and f32 (split TF32): their
    16-byte loaders at the compiled head dims and at aligned head dims
    zero-padded up to them; misaligned views of an aligned head dim and the
    unaligned head dims (every copy width) on their narrow loaders; each
    case against its plain version, every launch on its key. Returns the
    narrow launches by dtype."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    narrow = {}
    for dt, route in ((torch.bfloat16, "wgmma"), (torch.float32, "tf32x3")):
        route_sweep(gen, dt, route, ROUTE_D[dt])
        narrow[dt] = misaligned_views(gen, dt) + route_sweep(
            gen, dt, f"{route}/narrow", NARROW_D[dt])
    return narrow


def adam_checks():
    """noise_adam_step at the main shape: the device kernels of one wrapper
    call of it and one of noise_sgd_step, from one torch.profiler session
    (exactly one each: both take their scalars by value); the Adam kernel
    bit for bit against the plain version with n_units given as a device
    tensor (it divides, as the kernel does); and how far the plain version
    with n_units a host scalar (PyTorch's CUDA division then multiplies by
    the scalar's f32 reciprocal) lies from it. Returns the device kernels
    of one call of each, {"noise_adam_step": n, "noise_sgd_step": n}."""
    from repro_torch import kernels
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(5)
    vecs = [torch.randn(MAIN_D, generator=gen, device="cuda")
            for _ in range(4)] + [torch.rand(MAIN_D, generator=gen,
                                             device="cuda")]
    t = torch.full((), 3.0, device="cuda")
    hp = dict(stddev=1.0, n_units=250, lr=1e-3, weight_decay=1e-4,
              c1=1 - 0.9 ** t, c2=1 - 0.999 ** t)
    sgd_hp = dict(stddev=1.0, n_units=250, lr=1e-3, weight_decay=1e-4)
    got = kernels.noise_adam_step(*vecs, **hp)
    _, on_device = device_profile(lambda: (
        kernels.noise_adam_step(*vecs, **hp),
        kernels.noise_sgd_step(*vecs[:3], **sgd_hp)))
    names = [e.name for e in on_device]
    per_call = {name: sum(key in n for n in names) for name, key in
                (("noise_adam_step", "noise_adam"),
                 ("noise_sgd_step", "noise_sgd"))}
    print(f"noise_adam_step and noise_sgd_step: one wrapper call of each "
          f"runs {len(names)} device kernel(s): {names}")
    assert len(names) == 2 and per_call == dict(noise_adam_step=1,
                                                noise_sgd_step=1), names

    dividing = ref.noise_adam_step_ref(
        *vecs, **dict(hp, n_units=torch.full((), 250.0, device="cuda")))
    host = ref.noise_adam_step_ref(*vecs, **hp)
    x = vecs[0] + 1.0 * vecs[1]
    recip = torch.equal(x / 250, x * (torch.ones((), device="cuda") / 250))
    divides = torch.equal(x / 250, x / torch.full((), 250.0, device="cuda"))
    print(f"noise_adam_step: on the card x / 250 (a host scalar) "
          f"{'equals' if recip else 'differs from'} x times the f32 "
          f"reciprocal of 250, and {'equals' if divides else 'differs from'}"
          " x divided by 250 held on the card")
    for name, k, d, h in zip(("p'", "m'", "v'"), got, dividing, host):
        assert torch.equal(k, d), name
        print(f"noise_adam_step {name}: bit-equal to the plain version with "
              f"n_units a device tensor; with n_units a host scalar it "
              f"differs in {int((k != h).sum()):,} of {MAIN_D:,} elements, "
              f"max abs {max_err(k, h):.3e}")
    return per_call


def sgd_checks():
    """noise_sgd_step at the main shape, p f32 and bf16: the kernel bit for
    bit against the plain version with n_units a device tensor, and how far
    the plain version with n_units a host scalar lies from it (its device
    kernels a call are counted in adam_checks' profile)."""
    from repro_torch import kernels
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(7)
    hp = dict(stddev=1.0, n_units=250, lr=1e-3, weight_decay=1e-4)
    n_units = torch.full((), 250.0, device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        acc, noise, p = (torch.randn(MAIN_D, generator=gen, device="cuda")
                         for _ in range(3))
        p = p.to(dt)
        got = kernels.noise_sgd_step(acc, noise, p, **hp)
        assert torch.equal(got, ref.noise_sgd_step_ref(
            acc, noise, p, **dict(hp, n_units=n_units))), dt
        host = ref.noise_sgd_step_ref(acc, noise, p, **hp)
        print(f"noise_sgd_step p {dt}: bit-equal to the plain version with "
              f"n_units a device tensor; with n_units a host scalar it "
              f"differs in {int((got != host).sum()):,} of {MAIN_D:,} "
              f"elements, max abs {max_err(got, host):.3e}")


def c_params(path: Path, fn_name: str) -> tuple:
    """The ctypes types of the parameters of ``extern "C" int fn_name(...)``
    as the source at ``path`` declares them."""
    m = re.search(r'extern "C" int ' + fn_name + r"\((.*?)\)\s*\{",
                  path.read_text(), re.S)
    if m is None:
        raise SystemExit(f"--parent: no extern \"C\" {fn_name} in {path}")
    types = []
    for param in m.group(1).split(","):
        if "*" in param:
            types.append(ctypes.c_void_p)
        elif param.split()[0] in C_TYPES:
            types.append(C_TYPES[param.split()[0]])
        else:
            raise SystemExit(f"--parent: {fn_name}: unknown parameter "
                             f"{param.strip()!r} in {path}")
    return tuple(types)


def parent_kernels(parent: Path):
    """Before times, in this process: the parent commit's attention and
    DP-step kernels, built with nvcc from ``parent``'s csrc into a library
    of their own under build/ and called through their C entry points,
    timed in turns parent, this tree, this tree, parent against this tree's
    wrappers on the same inputs. phi-3-vision's length and heads at D = 100
    (bf16) and 98 (f32) on the parent's CUDA-core kernel against the narrow
    loaders, both against the plain version; the aligned attention
    (qwen2-7b and phi-3-vision, bf16 and f32), the SGD step (p f32 and
    bf16, aligned and one element off 16 bytes, with the parent's device
    scalar vector) and the Adam step (aligned and one element off) bit for
    bit against the parent's kernels. Returns {row: {"parent": [µs, µs],
    "tree": [µs, µs], ...}}."""
    from repro_torch import kernels
    from repro_torch.kernels import _build, ref

    csrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
    out_dir = _build.BUILD_ROOT.parent / "parent_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    srcs = ("flash_attention", "flash_attention_sm90",
            "flash_attention_tf32x3", "dp_step")
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c",
                               str(csrc / f"{n}.cu"), "-o",
                               str(out_dir / f"{n}.o")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for n in srcs]
    for p in procs:
        assert p.wait() == 0, p.stdout.read()
    lib_path = out_dir / "libparent.so"
    # linked against the CUDA runtime torch has loaded: a second, static
    # runtime first used after a torch.profiler session makes every later
    # session lose its first device kernel
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-cudart", "shared", "-shared",
                    *(str(out_dir / f"{n}.o") for n in srcs),
                    "-o", str(lib_path)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    # the calls below pass the parent's arguments as these entry points
    # took them before the narrow loaders and the one-launch SGD step (the
    # CUDA-core attention with its dtype code, the SGD scalars in one
    # device vector); a parent that declares any of them otherwise is
    # refused
    P, I = ctypes.c_void_p, ctypes.c_int
    calls_as = {
        "repro_flash_attention": ("flash_attention", (P,) * 4 + (I,) * 6
                                  + (ctypes.c_int64,) * 6
                                  + (ctypes.c_float,) + (I,) * 3 + (P,)),
        "repro_flash_attention_sm90": ("flash_attention_sm90",
                                       (*_build._FLASH, P)),
        "repro_flash_attention_tf32x3": ("flash_attention_tf32x3",
                                         (*_build._FLASH, P)),
        "repro_noise_adam_step": ("dp_step", _build._SIGNATURES[
            "repro_noise_adam_step"]),
        "repro_noise_sgd_step": ("dp_step", (P, P, P, P, I, P,
                                             ctypes.c_int64, P))}
    for fn_name, (src, want) in calls_as.items():
        got = c_params(csrc / f"{src}.cu", fn_name)
        if got != want:
            raise SystemExit(
                f"--parent: {fn_name} in {parent} is declared with "
                f"{[t.__name__ for t in got]}; this comparison calls it with "
                f"{[t.__name__ for t in want]}")
        getattr(lib, fn_name).argtypes = got

    def call(fn, *args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        assert err == 0, err

    def turns(name, tree, old, n):
        """parent, tree, tree, parent: graph µs (and eager)."""
        r = {"parent": [], "tree": []}
        for who, fn in (("parent", old), ("tree", tree), ("tree", tree),
                        ("parent", old)):
            r[who].append(graph_us(fn, n))
        r["eager"] = {"parent": cuda_us(old, n), "tree": cuda_us(tree, n)}
        print(f"before/after {name}: from a CUDA graph parent "
              f"{' '.join(f'{u:.3f}' for u in r['parent'])} us, this tree "
              f"{' '.join(f'{u:.3f}' for u in r['tree'])} us (turns parent, "
              f"tree, tree, parent); eager parent {r['eager']['parent']:.3f}"
              f", tree {r['eager']['tree']:.3f} us")
        return r

    def old_attention(entry, q, k, v, *code):
        """The parent's kernel on q [B, S, H, D], k, v [B, S, Hkv, D],
        causal, the default scale."""
        o = torch.empty_like(q)
        B, S, H, D = q.shape
        call(getattr(lib, entry), q.data_ptr(), k.data_ptr(), v.data_ptr(),
             o.data_ptr(), *code, B, H, H // k.shape[2], S, D, q.stride(0),
             q.stride(2), q.stride(1), k.stride(0), k.stride(2), k.stride(1),
             D ** -0.5, 1, 0, 0)
        return o

    gen = torch.Generator(device="cuda").manual_seed(6)
    bf16, f32 = torch.bfloat16, torch.float32
    res = {}
    for label, dt, shape, entry in (
            ("flash_attention unaligned", bf16, UNALIGNED_ATTN, None),
            ("flash_attention unaligned f32", f32, UNALIGNED_ATTN_F32, None),
            ("flash_attention", bf16, QWEN_ATTN, "repro_flash_attention_sm90"),
            ("flash_attention phi-3-vision", bf16, PHI3V_ATTN,
             "repro_flash_attention_sm90"),
            ("flash_attention f32", f32, QWEN_ATTN,
             "repro_flash_attention_tf32x3"),
            ("flash_attention phi-3-vision f32", f32, PHI3V_ATTN,
             "repro_flash_attention_tf32x3")):
        q, k, v, _ = attention_inputs(gen, dtype=dt, **shape)

        def new(q=q, k=k, v=v):
            return kernels.gqa_flash_attention(q, k, v)
        if entry is None:   # the parent's CUDA-core kernel
            def old(q=q, k=k, v=v, dt=dt):
                return old_attention("repro_flash_attention", q, k, v,
                                     _build.DTYPE_CODES[dt])
            want = ref.gqa_flash_attention_ref(q, k, v)
            errs = {who: check(f"{label} ({who})", fn(), want, dt)
                    for who, fn in (("parent", old), ("tree", new))}
            print(f"before/after {label}: max abs err against the plain "
                  f"version: parent's CUDA-core kernel {errs['parent']:.3e}, "
                  f"this tree's narrow loader {errs['tree']:.3e}")
        else:
            def old(q=q, k=k, v=v, entry=entry):
                return old_attention(entry, q, k, v)
            assert torch.equal(new(), old()), f"{label} changed bits"
            print(f"before/after {label}: bit-equal to the parent's kernel")
        res[label] = turns(label, new, old, FULL_WIDTH_CALLS)
        del q, k, v
        torch.cuda.empty_cache()

    t = torch.full((), 3.0, device="cuda")
    c1, c2 = 1 - 0.9 ** t, 1 - 0.999 ** t
    hp = dict(stddev=1.0, n_units=250, lr=1e-3, weight_decay=1e-4)
    for off in (0, 1):
        vecs = [torch.randn(MAIN_D + 1, generator=gen, device="cuda")[off:]
                [:MAIN_D] for _ in range(4)] + \
            [torch.rand(MAIN_D + 1, generator=gen, device="cuda")[off:]
             [:MAIN_D]]
        outs = [torch.empty_like(vecs[0]) for _ in range(3)]
        call(lib.repro_noise_adam_step, c1.data_ptr(), c2.data_ptr(),
             *(x.data_ptr() for x in vecs + outs), MAIN_D, *hp.values(), 0.9,
             0.999, 1.0 - 0.9, 1.0 - 0.999, 1e-8,
             kernels.dp_step.step_columns(*vecs, *outs))
        assert all(torch.equal(g, w) for g, w in zip(
            kernels.noise_adam_step(*vecs, **hp, c1=c1, c2=c2), outs)), \
            f"noise_adam_step differs from the parent's kernel (off {off})"
    print("before/after noise_adam_step: bit-equal to the parent's kernel at "
          "the main shape, aligned and one element off 16 bytes")

    for dt in (f32, bf16):
        for off in (0, 1):
            acc, noise = (torch.randn(MAIN_D + 1, generator=gen,
                                      device="cuda")[off:][:MAIN_D]
                          for _ in range(2))
            p = torch.randn(MAIN_D + 1, generator=gen,
                            device="cuda").to(dt)[off:][:MAIN_D]

            def old_sgd(acc=acc, noise=noise, p=p):
                sc = torch.stack([acc.new_full((), x) for x in hp.values()])
                out = torch.empty_like(p)
                call(lib.repro_noise_sgd_step, sc.data_ptr(), acc.data_ptr(),
                     noise.data_ptr(), p.data_ptr(),
                     _build.DTYPE_CODES[p.dtype], out.data_ptr(), MAIN_D)
                return out

            def new_sgd(acc=acc, noise=noise, p=p):
                return kernels.noise_sgd_step(acc, noise, p, **hp)
            assert torch.equal(new_sgd(), old_sgd()), \
                f"noise_sgd_step changed bits (p {dt}, off {off})"
            if off == 0:
                res["noise_sgd_step" + ("" if dt == f32 else " bf16")] = \
                    turns(f"noise_sgd_step p {dt}", new_sgd, old_sgd,
                          TIMED_LAUNCHES)
    print("before/after noise_sgd_step: bit-equal to the parent's kernel at "
          "p f32 and bf16, aligned and one element off 16 bytes")
    return res


def ptxas_lines():
    """Registers and spills of the two tensor-core attention kernels (both
    loaders), the register kernels of both mixes, the rmsnorm
    instantiations, the clip pair's rows accumulate, the scan's
    instantiations and the Adam and SGD steps', from ptxas's -v report of
    this build; every one spills 0 bytes."""
    from repro_torch.kernels import _build
    for name, regs, stores, loads, stack in _build.ptxas_report():
        if not any(k in name for k in ("flash_fwd_sm90", "flash_fwd_tf32x3",
                                        "stale_reg", "mix_reg",
                                        "rmsnorm_rows", "clip_acc_rows",
                                        "selective_scan", "noise_adam",
                                        "noise_sgd")):
            continue
        print(f"ptxas: {name}: {regs} registers, {stores} bytes spill "
              f"stores, {loads} bytes spill loads, {stack} bytes stack")
        assert stores == 0 and loads == 0, name


# ---------------------------------------------------------------------------
# the ops API


def counted(fn):
    """Launch counts of one call of ``fn``, by kernel and by route
    (``flash_attention/<route>``, ``rmsnorm/<route>``): counters reset just
    before, read just after; returns (result, counts)."""
    from repro_torch import kernels
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    return out, {**kernels.launch_counts(), **kernels.route_launch_counts()}


def expect(counts, **want):
    full = dict.fromkeys(counts, 0)
    full.update(want)
    assert counts == full, (counts, full)


def dp_launches(n: int, stacked: bool = True):
    """The counters of n DP steps' launches (one ``sumsq_rows``, one clip
    accumulate and one Adam step each): on the stacked executor's client
    grid (a step of the whole cohort), or the loop's flat routes (a step
    of one client)."""
    clip, adam = ("clients", "clients") if stacked else ("rows", "flat")
    return {"sumsq": n, "scale_accumulate": n, "noise_adam_step": n,
            "sumsq/rows": n, f"scale_accumulate/{clip}": n,
            f"noise_adam_step/{adam}": n}


def ops_api():
    """Each public op of the ops API once at full width, through the entry
    points a caller uses, with the launch counts pinned: gqa_flash_attention
    (qwen2-7b causal), rmsnorm (qwen2-7b bf16), mamba_scan
    (falcon-mamba-7b), noise_sgd_step and tree_clip_accumulate (the mlp
    proxy's tree) in one window; then gemma3-4b's windowed attention,
    rmsnorm in f32, qwen2-7b's attention in f32 (the split-TF32 route),
    phi-3-vision's (D = 96, zero-padded onto the 128-wide tensor-core
    kernels) in bf16 (wgmma) and in f32 (split TF32) and the flat
    clip_accumulate, one window each, with each window's attention or
    rmsnorm route pinned. Every result is finite, of the expected shape,
    and agrees with its plain version."""
    from repro_torch import kernels
    from repro_torch.kernels import ref
    from repro_torch.nn.modules import (tree_flatten_vector, tree_leaves,
                                        tree_unflatten_vector)
    from repro_torch.nn.vision import get_vision_model

    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = torch.device("cuda")

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    bf16 = torch.bfloat16
    q, k, v, _ = attention_inputs(gen, dtype=bf16, **QWEN_ATTN)
    x, g = randn(RMS_ROWS, RMS_D, dtype=bf16), randn(RMS_D, dtype=bf16)
    scan = mamba_inputs(gen, *MAMBA.values())
    acc, noise, p = randn(MAIN_D), randn(MAIN_D), randn(MAIN_D)
    hp = dict(stddev=1.0, n_units=250, lr=1e-3, weight_decay=1e-4)
    like = get_vision_model("mlp").init(
        torch.Generator(device=dev).manual_seed(0), (28, 28, 1), 10)
    grads = tree_unflatten_vector(randn(MAIN_D), like)
    zeros = tree_unflatten_vector(torch.zeros(MAIN_D, device=dev), like)

    t0 = time.perf_counter()
    out, counts = counted(lambda: dict(
        attn=kernels.gqa_flash_attention(q, k, v),
        norm=kernels.rmsnorm(x, g),
        scan=kernels.mamba_scan(*scan),
        sgd=kernels.noise_sgd_step(acc, noise, p, **hp),
        clip=kernels.tree_clip_accumulate(zeros, grads, 1.0)))
    seconds = time.perf_counter() - t0
    print(f"ops API: one call of each op in {seconds:.3f} s; launches "
          f"{counts}")
    expect(counts, flash_attention=1, rmsnorm=1, mamba_scan=1,
           noise_sgd_step=1, sumsq=1, scale_accumulate=1,
           **{"flash_attention/wgmma": 1, "rmsnorm/vector": 1,
              "mamba_scan/flat": 1, "sumsq/vector": 1,
              "scale_accumulate/vector": 1})

    want = dict(attn=ref.gqa_flash_attention_ref(q, k, v),
                norm=ref.rmsnorm_ref(x, g),
                scan=ref.mamba_scan_ref(*scan),
                sgd=ref.noise_sgd_step_ref(acc, noise, p, **hp))
    for key, tol in (("attn", None), ("norm", None), ("scan", SCAN_TOL),
                     ("sgd", None)):
        got = out[key]
        assert got.shape == want[key].shape and got.dtype == want[key].dtype
        assert bool(torch.isfinite(got).all()), key
        err = check(f"ops API {key}", got, want[key], got.dtype, tol)
        print(f"ops API: {key} {tuple(got.shape)} {got.dtype} agrees with "
              f"its plain version, max abs err {err:.3e}")
    flat = ref.clip_accumulate_ref(torch.zeros(MAIN_D, device=dev),
                                   tree_flatten_vector(grads), 1.0)
    for a, b in zip(tree_leaves(out["clip"]),
                    tree_leaves(tree_unflatten_vector(flat, like))):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    norm = float(torch.linalg.vector_norm(tree_flatten_vector(out["clip"])))
    assert abs(norm - 1.0) < 1e-5, norm   # clipped to C = 1
    print(f"ops API: tree_clip_accumulate over {len(tree_leaves(like))} "
          f"leaves agrees with the plain composite; clipped norm {norm:.6f}")
    del out, want

    # where the window's time goes on the device
    wall_ms, on_device = device_profile(lambda: (
        kernels.gqa_flash_attention(q, k, v), kernels.rmsnorm(x, g),
        kernels.mamba_scan(*scan), kernels.noise_sgd_step(acc, noise, p, **hp),
        kernels.tree_clip_accumulate(zeros, grads, 1.0)))
    busy = {k: us for k, (_, us) in kernel_times(on_device).items()}
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:8]
    print(f"ops API profile: one call of each op: wall {wall_ms:.3f} ms, "
          f"device busy {sum(busy.values()) / 1e3:.3f} ms "
          f"({sum(busy.values()) / 10 / wall_ms:.2f}%), {len(on_device)} "
          "device kernels and copies; device us by kernel "
          + ", ".join(f"{n} {t:.3f}" for n, t in top))
    scan_us = busy.get("selective_scan", 0.0)
    print(f"ops API profile: the scan (selective_scan) {scan_us:.3f} us, "
          f"{scan_us / sum(busy.values()):.2%} of the device's busy time")
    del q, k, v, x, g, scan

    q, k, v, _ = attention_inputs(gen, dtype=bf16, **GEMMA_LOCAL)
    w = GEMMA_LOCAL["window"]
    got, c = counted(lambda: kernels.gqa_flash_attention(q, k, v, window=w))
    expect(c, flash_attention=1, **{"flash_attention/wgmma": 1})
    err = check("ops API gemma window", got,
                ref.gqa_flash_attention_ref(q, k, v, window=w), bf16)
    x, g = randn(RMS_ROWS, RMS_D), randn(RMS_D)
    got, c = counted(lambda: kernels.rmsnorm(x, g))
    expect(c, rmsnorm=1, **{"rmsnorm/vector": 1})
    err_f32 = check("ops API rmsnorm f32", got, ref.rmsnorm_ref(x, g),
                    torch.float32)
    q, k, v, lib32 = attention_inputs(gen, dtype=torch.float32, **QWEN_ATTN)
    got, f32_counts = counted(lambda: kernels.gqa_flash_attention(q, k, v))
    expect(f32_counts, flash_attention=1, **{"flash_attention/tf32x3": 1})
    want = ref.gqa_flash_attention_ref(q, k, v)
    err_attn32 = check("ops API qwen2-7b attention f32", got, want,
                       torch.float32)
    share32 = tol_share(got, want, TOL[torch.float32])
    print("ops API: SDPA in f32 (the library yardstick) runs "
          + ", ".join(sorted({e.name for e in device_profile(lib32)[1]})))
    err_phi = {}
    for dt, route in ((bf16, "wgmma"), (torch.float32, "tf32x3")):
        q, k, v, _ = attention_inputs(gen, dtype=dt, **PHI3V_ATTN)
        got, c = counted(lambda: kernels.gqa_flash_attention(q, k, v))
        expect(c, flash_attention=1, **{f"flash_attention/{route}": 1})
        assert bool(torch.isfinite(got).all())
        want = ref.gqa_flash_attention_ref(q, k, v)
        err_phi[dt] = (check(f"ops API phi-3-vision attention {dt}", got,
                             want, dt), tol_share(got, want, TOL[dt]))
        del q, k, v, got, want
    del lib32
    got, c = counted(lambda: kernels.clip_accumulate(acc, noise, 1.0))
    expect(c, sumsq=1, scale_accumulate=1,
           **{"sumsq/vector": 1, "scale_accumulate/vector": 1})
    torch.testing.assert_close(got, ref.clip_accumulate_ref(acc, noise, 1.0),
                               rtol=1e-5, atol=1e-6)
    print(f"ops API: gemma3-4b local attention (window {w}) max abs err "
          f"{err:.3e}, rmsnorm f32 {err_f32:.3e}, qwen2-7b attention in f32 "
          f"(the split-TF32 kernel) {err_attn32:.3e} ({share32:.1%} of the "
          "f32 tolerance), phi-3-vision attention (D = 96) bf16 on wgmma "
          f"{err_phi[bf16][0]:.3e} ({err_phi[bf16][1]:.1%}), f32 on tf32x3 "
          f"{err_phi[torch.float32][0]:.3e} ({err_phi[torch.float32][1]:.1%} "
          "of the f32 tolerance), clip_accumulate agrees; one launch window "
          "each")
    torch.cuda.empty_cache()
    return counts, {"flash_attention_tf32x3": f32_counts["flash_attention"]}


# ---------------------------------------------------------------------------
# the main path


def mnist_setup():
    """The main path's model, data and configuration on the card."""
    from repro_torch.configs import DPConfig, ProxyFLConfig
    from repro_torch.core.protocol import ModelSpec
    from repro_torch.data.partition import partition_major
    from repro_torch.data.synthetic import make_classification_data
    from repro_torch.nn.vision import get_vision_model

    dev = torch.device("cuda")
    shape, n_classes, K, per_client = (28, 28, 1), 10, MAIN_K, MAIN_PER_CLIENT
    vm = get_vision_model("mlp")
    spec = ModelSpec("mlp", lambda g: vm.init(g, shape, n_classes), vm.apply)
    # the MNIST stand-in of benchmarks/common.py: sep 2.5, p_major 0.8,
    # a 2x pool for the partitioner, a 1,000-example shared test set
    x, y = make_classification_data(
        torch.Generator(device=dev).manual_seed(0), 2 * K * per_client, shape,
        n_classes, sep=2.5, task_seed=7)
    xt, yt = make_classification_data(
        torch.Generator(device=dev).manual_seed(1), 1_000, shape, n_classes,
        sep=2.5, task_seed=7)
    idxs = partition_major(np.random.default_rng(0), y.cpu().numpy(), K,
                           per_client, 0.8, n_classes)
    data = [(x[torch.as_tensor(i, device=dev)],
             y[torch.as_tensor(i, device=dev)]) for i in idxs]
    cfg = ProxyFLConfig(alpha=0.5, beta=0.5, n_clients=K, rounds=2,
                        batch_size=250, lr=1e-3, weight_decay=1e-4,
                        use_pallas=True,
                        dp=DPConfig(enabled=True, noise_multiplier=1.0,
                                    clip_norm=1.0, delta=1e-5))
    return spec, data, (xt, yt), cfg


def cold_step(spec, data, test, cfg):
    """Set-up cost a fresh process pays once: the first client step of
    the main path's configuration (CUDA and library first use), timed
    beside the second. Runs before the main path, outside its counts."""
    from repro_torch.core.engine import dml_engine

    eng = dml_engine((spec,) * len(data), spec, cfg, device="cuda")
    state = eng.init_states(0)[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step_fns[0](state, eng.sample_fn(data[0], gen), gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"set-up: first client step of the process {times[0]:.3f} s, "
          f"second {times[1] * 1e3:.3f} ms")


def main_path(spec, data, test, cfg):
    from repro_torch import kernels
    from repro_torch.core.baselines import run_federated
    from repro_torch.nn.losses import cross_entropy

    K, (xt, yt), per_client = len(data), test, data[0][0].shape[0]
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_federated("proxyfl", [spec] * K, spec, data, test, cfg,
                        seed=0, eval_every=cfg.rounds, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {**kernels.launch_counts(), **kernels.route_launch_counts()}

    row = res["history"][-1]
    priv, prox = np.asarray(row["private_acc"]), np.asarray(row["proxy_acc"])
    losses = [float(cross_entropy(spec.apply(getattr(c, role), xt), yt))
              for c in res["clients"]
              for role in ("private_params", "proxy_params")]
    print(f"main path: {cfg.rounds} rounds in {seconds:.3f} s = "
          f"{cfg.rounds / seconds:.3f} rounds/s (evaluation included)")
    print(f"main path: private acc {np.round(priv, 4).tolist()} mean "
          f"{priv.mean():.4f}; proxy acc {np.round(prox, 4).tolist()} mean "
          f"{prox.mean():.4f}; epsilon {res['epsilon'][0]!r}")
    print(f"main path: test losses {np.round(losses, 4).tolist()}")
    print(f"main path: launches {counts}")

    # the stacked executor: one launch of each DP kernel a local step for
    # the whole cohort (sumsq_rows over its [K·B, D] rows, the clip and
    # Adam on the client grid), one mix a round
    steps = cfg.rounds * (per_client // cfg.batch_size)
    expect(counts, **dp_launches(steps), fused_pushsum_mix=cfg.rounds)
    assert all(math.isfinite(v) for v in losses), losses
    assert priv.mean() > 0.2, priv
    assert all(e == EPSILON_2_ROUNDS for e in res["epsilon"]), res["epsilon"]

    # the plain path on the same seed draws the same batches and noise, so
    # it must reach the same params up to summation order
    t0 = time.perf_counter()
    plain = run_federated("proxyfl", [spec] * K, spec, data, test, cfg,
                          seed=0, eval_every=cfg.rounds, device="cuda",
                          use_pallas=False)
    torch.cuda.synchronize()
    plain_seconds = time.perf_counter() - t0
    assert {**kernels.launch_counts(), **kernels.route_launch_counts()} \
        == counts, "plain path launched a kernel"
    worst = 0.0
    for a, b in zip(res["clients"], plain["clients"]):
        for role in ("private_params", "proxy_params"):
            for key in ("fc1", "fc2", "fc3"):
                for leaf in ("w", "b"):
                    got = getattr(a, role)[key][leaf]
                    ref = getattr(b, role)[key][leaf]
                    torch.testing.assert_close(got, ref, **CLOSE)
                    worst = max(worst, max_err(got, ref))
    print(f"main path: kernels vs plain path after {cfg.rounds} rounds, "
          f"max abs param diff {worst:.3e} (close grade atol 1e-5 rtol 1e-4)")
    print(f"plain path (use_pallas=False, run second): {cfg.rounds} rounds "
          f"in {plain_seconds:.3f} s = {cfg.rounds / plain_seconds:.3f} "
          "rounds/s")
    return counts, cfg.rounds / seconds


def param_trees(result, method):
    """Each client's model params of a ``run_federated`` result."""
    roles = (("private_params", "proxy_params")
             if method in ("proxyfl", "fml") else ("params",))
    return [getattr(c, role) for c in result["clients"] for role in roles]


def methods_path(spec, data, test, cfg, card):
    """The six other fig. 3 methods through ``run_federated`` on the main
    path's set-up, each with the counters reset just before and read just
    after: exact launches (one ``sumsq`` and one ``scale_accumulate`` on
    the rows route and one ``noise_adam_step`` per DP step, one
    ``fused_pushsum_mix`` a round where the method exchanges), the pinned
    epsilon, finite test losses, accuracies in [0, 1], and the plain path
    on the same seed at the ``close`` grade. Returns each method's counts
    and its rounds/s with the kernels and on the plain path."""
    from repro_torch import kernels
    from repro_torch.core.baselines import run_federated
    from repro_torch.nn.losses import cross_entropy

    K, (xt, yt), per_client = len(data), test, data[0][0].shape[0]
    out = {}
    for method in OTHER_METHODS:
        # stacked: a launch of each DP kernel a local step of the cohort;
        # Joint's one pooled client takes the K clients' steps
        steps = cfg.rounds * (per_client // cfg.batch_size) * (
            K if method == "joint" else 1)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_federated(method, [spec] * K, spec, data, test, cfg,
                            seed=0, eval_every=cfg.rounds, device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {**kernels.launch_counts(), **kernels.route_launch_counts()}
        mixes = 0 if method in ("regular", "joint") else cfg.rounds
        expect(counts, **dp_launches(steps), fused_pushsum_mix=mixes)
        want_eps = (EPSILON_JOINT_2_ROUNDS if method == "joint"
                    else EPSILON_2_ROUNDS)
        assert len(res["epsilon"]) == (1 if method == "joint" else K)
        assert all(e == want_eps for e in res["epsilon"]), \
            (method, res["epsilon"])
        row = res["history"][-1]
        acc = np.asarray(row["private_acc" if method == "fml" else "acc"])
        assert ((acc >= 0) & (acc <= 1)).all(), (method, acc)
        trees = param_trees(res, method)
        with torch.no_grad():
            losses = [float(cross_entropy(spec.apply(p, xt), yt))
                      for p in trees]
        assert all(math.isfinite(v) for v in losses), (method, losses)

        t0 = time.perf_counter()
        plain = run_federated(method, [spec] * K, spec, data, test, cfg,
                              seed=0, eval_every=cfg.rounds, device="cuda",
                              use_pallas=False)
        torch.cuda.synchronize()
        plain_seconds = time.perf_counter() - t0
        assert {**kernels.launch_counts(), **kernels.route_launch_counts()} \
            == counts, f"{method}: the plain path launched a kernel"
        worst = 0.0
        for a, b in zip(trees, param_trees(plain, method)):
            for key in ("fc1", "fc2", "fc3"):
                for leaf in ("w", "b"):
                    torch.testing.assert_close(a[key][leaf], b[key][leaf],
                                               **CLOSE)
                    worst = max(worst, max_err(a[key][leaf], b[key][leaf]))
        assert plain["epsilon"] == res["epsilon"]
        rate, plain_rate = cfg.rounds / seconds, cfg.rounds / plain_seconds
        print(f"methods: {method:8s} acc mean {acc.mean():.4f} "
              f"{np.round(acc, 4).tolist()}; epsilon {res['epsilon'][0]!r}; "
              f"test loss mean {np.mean(losses):.4f}; kernels vs plain max "
              f"abs param diff {worst:.3e} (close grade atol 1e-5 rtol "
              f"1e-4); {rate:.4f} rounds/s with the kernels, "
              f"{plain_rate:.4f} plain (evaluation included) on {card}; "
              f"launches sumsq/rows {counts['sumsq/rows']} "
              f"scale_accumulate/clients "
              f"{counts['scale_accumulate/clients']} "
              f"noise_adam_step/clients {counts['noise_adam_step/clients']} "
              f"fused_pushsum_mix {counts['fused_pushsum_mix']}")
        out[method] = dict(counts=counts, rate=rate, plain_rate=plain_rate)
    return out


def all_leaves(result, method):
    """Every model param of a ``run_federated`` result, in client order."""
    from repro_torch.nn.modules import tree_leaves
    return [leaf for tree in param_trees(result, method)
            for leaf in tree_leaves(tree)]


def figure_runs():
    """The figures phase's runs, each (name, method, client data, test set,
    private specs, proxy spec, config): fig. 5b's heterogeneous cohort
    (privates mlp / lenet5 / cnn1 / cnn2, an mlp proxy) and the Regular
    baseline of each architecture; table 2's and fig. 6's ``--full``
    configurations (seed 0), ProxyFL and one single-model method each. All
    at full width (image size, client count, all the data, batch), cut to
    ``FIGURE_ROUNDS`` rounds, from the port's own drivers."""
    from repro_torch.benchmarks import (common, fig5_ablations,
                                        fig6_kvasir, table2_histo)

    data, test, specs, proxy, cfg = fig5_ablations.hetero_setup(
        True, "cuda", rounds=FIGURE_ROUNDS)
    K = len(specs)
    yield "fig5b hetero", "proxyfl", data, test, specs, proxy, cfg
    for arch, spec in zip(fig5_ablations.HETERO_ARCHS, specs):
        yield f"fig5b {arch}", "regular", data, test, [spec] * K, spec, cfg
    for fig, module, single in (("table2", table2_histo, "fedavg"),
                                ("fig6", fig6_kvasir, "avgpush")):
        conf = module.configuration(True)
        for key in ("methods", "seeds", "rounds"):
            conf.pop(key)
        data, test, priv, prox, cfg = common.method_setup(
            conf.pop("dataset"), conf.pop("n_clients"), 0,
            rounds=FIGURE_ROUNDS, device="cuda", **conf)
        K = len(data)
        for method in ("proxyfl", single):
            yield fig, method, data, test, [priv] * K, prox, cfg


class Lockstep:
    """Within the block, every client step the engines take is also taken
    from the same state and the same draws by a twin, and the two results
    are compared at the ``close`` grade; the engine's state goes on. The
    twin is the plain path's step (``use_pallas=False``; ``against=
    "plain"``) or the loop's own kernel step (``against="loop"``); an
    engine whose step no factory made (the LLM train driver's) gets its
    twin as ``twin``. On the
    loop a client step is twinned where it runs (a twin of its generator).
    On the stacked executor, which the block runs eagerly, a batched step
    is twinned on the same state, batch and noise: against the plain path
    by the plain step vmapped alike (the same batched products, so only
    the DP chain's order differs, held at ``close`` everywhere as on the
    loop); against the loop client by client. There the batched products
    round otherwise than the twin's per-client ones, so the gradients
    differ in their last bits, and the params of a
    first Adam step are held as the train phase holds them: at ``close``
    but for the coordinates at |g| < 100·ε on the twin (g from the
    moments), where lr·g/(|g| + ε) turns a last-bit gradient difference
    into a step difference past ``close``; those are masked and counted
    (``eps_masked``, and ``eps_past`` of them past ``close``). And a ReLU
    whose pre-activation is within rounding of 0 may fire on one path and
    not on the other (:func:`relu_ties` counts them for the mlp,
    ``ties``), which moves one example's gradient of the units behind it:
    where a coordinate's whole gradient is that small, its step leaves
    ``close``, and its Adam moments move with it. So against the loop the
    params and moments may hold at most ``OUTLIERS_PER_COORD`` of their
    coordinates past ``close`` (``outliers`` of ``coords``, counted and
    printed); every other leaf holds at ``close`` everywhere. Over a run
    the two trajectories may part further, since a one-ulp
    difference in a near-zero first Adam step, spread by the conv models'
    max-pool near-ties, grows from step to step (fig. 6's ProxyFL:
    9.595e-05 after 2 rounds on the H100).

    With ``grad_normwise`` (the LLM train step against the plain path,
    where ``close``'s atol is about a coordinate's size and elementwise
    holds little) a batched step is also held as the loop's is against
    the loop: the losses at ``close``, each leaf's gradient g = (m' −
    b1·m) / (1 − b1) normwise within the grade (``grad_worst``,
    ``grad_beyond``), a first Adam step's params at |g| < 100·ε masked;
    the params and moments have no outlier budget there."""

    def __init__(self, against: str = "plain", twin=None,
                 grad_normwise: Optional[float] = None):
        self.against, self.twin = against, twin
        self.grad_normwise = grad_normwise
        self.worst, self.beyond, self.steps = 0.0, 0, 0
        self.grad_worst, self.grad_beyond = 0.0, 0
        self.eps_masked, self.eps_past = 0, 0
        self.coords, self.outliers, self.ties = 0, 0, 0
        self.twins = {}

    def __enter__(self):
        from repro_torch.core import engine
        self.engine = engine
        self.raw = (engine._dml_state_step, engine._ce_state_step,
                    engine.FederationEngine._vstep)
        dml_raw, ce_raw, vstep_raw = self.raw
        plain = self.against == "plain"

        def dml(private_spec, proxy_spec, cfg):
            return self.both(
                dml_raw(private_spec, proxy_spec, cfg),
                dml_raw(private_spec, proxy_spec,
                        dataclasses.replace(cfg, use_pallas=not plain
                                            and cfg.use_pallas)))

        def ce(spec, cfg, dp):
            return self.both(ce_raw(spec, cfg, dp), ce_raw(
                spec, dataclasses.replace(cfg, use_pallas=not plain
                                          and cfg.use_pallas), dp))

        def vstep(eng, stacked, batch, noise):
            from repro_torch.core.engine import unstack_state
            from repro_torch.nn.modules import tree_map
            out = vstep_raw(eng, stacked, batch, noise)
            # the twin of a factory's step, or the one given (an engine
            # built elsewhere, as the LLM train driver's)
            twin = self.twins.get(id(eng.step_fns[0]), self.twin)
            if self.against == "plain":
                # the plain step vmapped alike: the same batched products
                ref = vstep_raw(eng, stacked, batch, noise, step=twin)
                grads = self.grad_normwise is not None
                if grads:
                    for key in ("private_loss", "proxy_loss"):
                        self.held(out[1][key], ref[1][key])
                for k in range(eng.K):
                    self.compare(unstack_state(out[0], k),
                                 unstack_state(ref[0], k),
                                 unstack_state(stacked, k) if grads
                                 else None)
                return out
            self.ties += relu_ties(stacked, batch)
            for k in range(eng.K):
                before = unstack_state(stacked, k)
                ref = twin(before, tree_map(lambda x: x[k], batch), None,
                           None if noise is None else noise[k])
                self.compare(unstack_state(out[0], k), ref[0], before)
            return out

        engine._dml_state_step, engine._ce_state_step = dml, ce
        engine.FederationEngine._vstep = vstep
        engine.FederationEngine._eager_stacked = True
        return self

    def __exit__(self, *exc):
        engine = self.engine
        (engine._dml_state_step, engine._ce_state_step,
         engine.FederationEngine._vstep) = self.raw
        engine.FederationEngine._eager_stacked = False

    def held(self, a, b, mask=None, budget=False):
        """a at ``close`` to b, the coordinates of ``mask`` counted apart;
        with ``budget`` (a param or moment against the loop) those past
        ``close`` count against the outlier budget."""
        if not a.is_floating_point():
            assert torch.equal(a, b)
            return
        off = (a - b).abs() > CLOSE["atol"] + CLOSE["rtol"] * b.abs()
        if mask is not None:
            self.eps_masked += int(mask.sum())
            self.eps_past += int((off & mask).sum())
            off, a, b = off & ~mask, a[~mask], b[~mask]
        if a.numel():
            self.worst = max(self.worst, max_err(a, b))
        if budget and self.against == "loop":
            self.coords += a.numel()
            self.outliers += int(off.sum())
        else:
            self.beyond += int(off.sum())

    def compare(self, got, want, before=None):
        """Every leaf of a client's new state at ``close``; with
        ``before`` (the state the step started from) a first Adam step's
        params at |g| < 100·ε masked and, with ``grad_normwise``, each
        leaf's gradient held normwise."""
        from repro_torch.nn.modules import tree_leaves
        for key in sorted(want):
            g, w = got[key], want[key]
            opt = w.get("opt") if isinstance(w, dict) else None
            if before is None or getattr(opt, "t", None) is None:
                for a, b in zip(tree_leaves(g), tree_leaves(w)):
                    self.held(a, b)
                continue
            for a, b in zip(tree_leaves(g["opt"]), tree_leaves(opt)):
                self.held(a, b, budget=True)
            for pa, pb, m1, m2, m0 in zip(
                    tree_leaves(g["params"]), tree_leaves(w["params"]),
                    tree_leaves(g["opt"].m), tree_leaves(opt.m),
                    tree_leaves(before[key]["opt"].m)):
                grad = (m2 - 0.9 * m0) / (1 - 0.9)
                if self.grad_normwise is not None:
                    rel = float(torch.linalg.vector_norm(
                        (m1 - 0.9 * m0) / (1 - 0.9) - grad)
                        / torch.linalg.vector_norm(grad).clamp_min(1e-30))
                    self.grad_worst = max(self.grad_worst, rel)
                    self.grad_beyond += int(rel > self.grad_normwise)
                self.held(pa, pb, grad.abs() < 100 * 1e-8
                          if int(opt.t) == 1 else None, budget=True)
        self.steps += 1

    def check(self, steps: int) -> None:
        """The block's gates: every step twinned, nothing past ``close``
        but the params' outliers within their budget, every gradient
        within its normwise grade."""
        assert self.steps == steps, (self.steps, steps)
        assert not self.beyond, (self.beyond, self.worst)
        assert self.outliers <= OUTLIERS_PER_COORD * self.coords, \
            (self.outliers, self.coords)
        assert not self.grad_beyond, (self.grad_beyond, self.grad_worst)

    def both(self, kernel_step, twin_step):
        def step(state, batch, generator, noise=None):
            if generator is None:
                # vmapped by the stacked executor: twinned at its steps
                return kernel_step(state, batch, generator, noise)
            twin = torch.Generator(device=generator.device)
            twin.set_state(generator.get_state())
            out = kernel_step(state, batch, generator, noise)
            self.compare(out[0], twin_step(state, batch, twin, noise)[0])
            return out

        self.twins[id(step)] = twin_step
        return step


def figures_path(card):
    """The configurations of fig. 5b, table 2 and fig. 6 through
    ``run_federated`` (:func:`figure_runs`), each with the counters reset
    just before and read just after: one ``sumsq`` and one
    ``scale_accumulate`` on the rows route and one ``noise_adam_step`` per
    DP step, Σ_k max(1, n_k // B) steps a round from the clients' own
    sizes, one ``fused_pushsum_mix`` a round for the mixing methods and
    none for Regular, nothing else; every client's epsilon the port
    accountant's for its own sample rate and steps; finite test losses; a
    second run of the same seed bit-equal (cuDNN deterministic), each of
    its client steps also taken on the plain path (``use_pallas=False``)
    from the same state and draws and equal to it at the ``close`` grade
    (:class:`Lockstep`); the whole plain run timed, and how far its params
    end from the kernel run's printed. Also table 2's privacy rows against
    the JAX package's pinned epsilons. Returns each run's launches, proxy
    width, rounds/s with the kernels and plain, and both differences."""
    from repro_torch import kernels
    from repro_torch.benchmarks import table2_histo
    from repro_torch.core.accountant import epsilon_for
    from repro_torch.core.baselines import run_federated
    from repro_torch.nn.losses import cross_entropy
    from repro_torch.nn.modules import tree_size

    for row in table2_histo.privacy_rows():
        n = (sum(table2_histo.TRAIN_SIZES.values()) if row["client"] ==
             "Joint" else table2_histo.TRAIN_SIZES[row["client"]])
        eps = epsilon_for(noise_multiplier=1.4, sample_rate=32 / n,
                          steps=30 * (n // 32), delta=1e-5)
        assert eps == TABLE2_EPSILONS[row["client"]], (row, eps)
        assert row["epsilon"] == round(eps, 3)
    print(f"figures: table 2's privacy rows equal the JAX package's "
          f"epsilons {TABLE2_EPSILONS}")

    out, failures = {}, []
    for name, method, data, test, privs, prox, cfg in figure_runs():
        key = f"{name} {method}"
        sizes = [x.shape[0] for x, _ in data]
        B = cfg.batch_size
        steps = [max(1, n // B) for n in sizes]
        # a homogeneous cohort runs stacked: a launch of each DP kernel a
        # batched step, the cohort's largest count a round (exhausted
        # clients masked); the heterogeneous one on the loop, a launch a
        # client step
        stacked = all(p == privs[0] for p in privs)
        total = cfg.rounds * (max(steps) if stacked else sum(steps))
        twinned = cfg.rounds * (max(steps) * len(sizes) if stacked
                                else sum(steps))
        D = tree_size(prox.init(torch.Generator(device="cuda")))

        def run(use_pallas):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_federated(method, privs, prox, data, test, cfg, seed=0,
                                eval_every=cfg.rounds, device="cuda",
                                use_pallas=use_pallas)
            torch.cuda.synchronize()
            return res, cfg.rounds / (time.perf_counter() - t0)

        kernels.reset_launch_counts()
        res, rate = run(True)
        counts = {**kernels.launch_counts(), **kernels.route_launch_counts()}
        mixes = 0 if method == "regular" else cfg.rounds
        expect(counts, **dp_launches(total, stacked),
               fused_pushsum_mix=mixes)
        sigma, delta = cfg.dp.noise_multiplier, cfg.dp.delta
        want_eps = [epsilon_for(noise_multiplier=sigma,
                                sample_rate=min(1.0, B / n),
                                steps=cfg.rounds * s, delta=delta)
                    for n, s in zip(sizes, steps)]
        assert res["epsilon"] == want_eps, (key, res["epsilon"], want_eps)
        models = []
        for c, spec in zip(res["clients"], privs):
            models += ([(spec, c.private_params), (prox, c.proxy_params)]
                       if method == "proxyfl" else [(prox, c.params)])
        with torch.no_grad():
            losses = [float(cross_entropy(spec.apply(p, test[0]), test[1]))
                      for spec, p in models]
        assert all(math.isfinite(v) for v in losses), (key, losses)
        row = res["history"][-1]
        acc = np.asarray(row["private_acc" if method == "proxyfl" else "acc"])
        assert ((acc >= 0) & (acc <= 1)).all(), (key, acc)

        plain, plain_rate = run(False)
        assert {**kernels.launch_counts(), **kernels.route_launch_counts()} \
            == counts, f"{key}: the plain path launched a kernel"
        apart = max(max_err(a, b) for a, b in zip(all_leaves(res, method),
                                                   all_leaves(plain, method)))
        assert plain["epsilon"] == res["epsilon"]
        # the second run of the seed: each step also on the plain path
        with Lockstep() as lock:
            again, _ = run(True)
        assert lock.steps == twinned, (key, lock.steps)
        if lock.beyond:
            failures.append(f"{key}: {lock.beyond} values of a step differ "
                            "from the plain path's beyond the close grade "
                            f"(max abs diff {lock.worst:.3e})")
        assert all(torch.equal(a, b) for a, b in zip(
            all_leaves(res, method), all_leaves(again, method))), \
            f"{key}: a second run of the same seed differs"
        print(f"figures: {key:24s} K {len(sizes)} sizes {sizes} B {B} D {D:,}"
              f"; acc mean {acc.mean():.4f}; epsilon max "
              f"{max(res['epsilon'])!r}; each of {lock.steps} client steps "
              "against the plain path's from the same state: max abs diff "
              f"{lock.worst:.3e} (close grade); the two paths' params "
              f"{apart:.3e} apart after {cfg.rounds} round(s); a second run "
              f"bit-equal; {rate:.4f} rounds/s with the kernels, "
              f"{plain_rate:.4f} plain (evaluation included) on {card}; "
              f"{'stacked' if stacked else 'loop'}: launches sumsq/rows "
              f"{counts['sumsq/rows']} scale_accumulate/"
              f"{'clients' if stacked else 'rows'} {counts['scale_accumulate']}"
              f" noise_adam_step {counts['noise_adam_step']} "
              f"fused_pushsum_mix {counts['fused_pushsum_mix']}")
        out[key] = dict(counts=counts, rate=rate, plain_rate=plain_rate,
                        step_diff=lock.worst, apart=apart, rows=[B, D],
                        K=len(sizes), stacked=stacked)
    assert not failures, failures
    return out


def timed_round(eng, state, data, t):
    """Host-clock seconds of one engine round and of each local step in
    it (each step synchronised and timed in place; none on the stacked
    executor, whose steps run inside its captured round)."""
    step_s = []
    if eng.stacked:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_round(state, data, t, seed=0)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, step_s
    raw_steps = eng.step_fns

    def timed(raw_step):
        def timed_step(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = raw_step(*args)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return out
        return timed_step

    eng.step_fns = [timed(f) for f in raw_steps]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_round(state, data, t, seed=0)
        torch.cuda.synchronize()
    finally:
        eng.step_fns = raw_steps
    return time.perf_counter() - t0, step_s


def async_config(cfg):
    """fig_async's protocol (benchmarks/fig_async.py:60-84) on the main
    path's cohort: 2 local steps of batch 64, lr 1e-3, wd 1e-4, DP off,
    staleness 2, the kernels on; 6 rounds instead of 30."""
    from repro_torch.configs import DPConfig
    return dataclasses.replace(cfg, rounds=ASYNC_ROUNDS, local_steps=2,
                               batch_size=64, staleness=ASYNC_TAU,
                               dp=DPConfig(enabled=False), use_pallas=True)


def host_ms(fn, n=20) -> float:
    """Mean host-clock ms of ``fn`` over n synchronised calls, after one."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def async_path(spec, data, test, cfg):
    """The async backend at staleness 2 through the stale-mix kernel,
    against the same rounds on the plain path."""
    from repro_torch import kernels
    from repro_torch.core.baselines import run_federated
    from repro_torch.core.engine import dml_engine
    from repro_torch.nn.losses import cross_entropy
    from repro_torch.nn.modules import tree_leaves

    acfg = async_config(cfg)
    K, (xt, yt) = len(data), test
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_federated("proxyfl", [spec] * K, spec, data, test, acfg,
                        seed=0, eval_every=acfg.rounds, backend="async",
                        device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()

    row = res["history"][-1]
    priv, prox = np.asarray(row["private_acc"]), np.asarray(row["proxy_acc"])
    losses = [float(cross_entropy(spec.apply(getattr(c, role), xt), yt))
              for c in res["clients"]
              for role in ("private_params", "proxy_params")]
    print(f"async path: staleness {acfg.staleness}, {acfg.rounds} rounds in "
          f"{seconds:.3f} s = {acfg.rounds / seconds:.3f} rounds/s "
          "(evaluation included)")
    print(f"async path: private acc {np.round(priv, 4).tolist()} mean "
          f"{priv.mean():.4f}; proxy acc {np.round(prox, 4).tolist()} mean "
          f"{prox.mean():.4f}")
    print(f"async path: test losses {np.round(losses, 4).tolist()}")
    print(f"async path: launches {counts}")
    want = dict.fromkeys(counts, 0)
    want["fused_stale_mix"] = acfg.rounds
    assert counts == want, (counts, want)
    assert all(math.isfinite(v) for v in losses), losses
    assert priv.mean() > 0.2, priv

    # the same rounds through the engine on the same seed, in turns
    # kernels, plain, plain, kernels: the same draws, so the same state up
    # to summation order
    engines, finals, rates = {}, {}, {True: [], False: []}
    for use_pallas in (True, False, False, True):
        eng = dml_engine((spec,) * K, spec,
                         dataclasses.replace(acfg, use_pallas=use_pallas),
                         backend="async", device="cuda")
        state = eng.init_states(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = eng.run_rounds(state, data, 0, acfg.rounds, seed=0)
        torch.cuda.synchronize()
        rates[use_pallas].append(acfg.rounds / (time.perf_counter() - t0))
        engines[use_pallas], finals[use_pallas] = eng, state
    fused, plain = finals[True], finals[False]
    for c, s in zip(res["clients"], fused["clients"]):
        for a, b in zip(tree_leaves(c.proxy_params),
                        tree_leaves(s["proxy"]["params"])):
            assert torch.equal(a, b), "engine run differs from run_federated"
    pairs = [(a, b) for ca, cb in zip(fused["clients"], plain["clients"])
             for role in ("private", "proxy")
             for a, b in zip(tree_leaves(ca[role]["params"]),
                             tree_leaves(cb[role]["params"]))]
    pairs += [(ca["w"], cb["w"])
              for ca, cb in zip(fused["clients"], plain["clients"])]
    pairs += [(fused[k], plain[k]) for k in ("stale_theta", "stale_w")]
    worst = 0.0
    for a, b in pairs:
        torch.testing.assert_close(a, b, **CLOSE)
        worst = max(worst, max_err(a, b))
    assert float(fused["stale_w"].abs().sum()) > 0, "no mail in flight"
    print(f"async path: kernels vs plain path after {acfg.rounds} rounds, "
          f"max abs diff of params, w and both buffers {worst:.3e} (close "
          "grade atol 1e-5 rtol 1e-4)")
    print(f"async path: engine rounds (no evaluation; a fresh engine, "
          f"its capture included), run in turns "
          f"kernels, plain, plain, kernels: kernels "
          f"{' '.join(f'{r:.3f}' for r in rates[True])} rounds/s, plain "
          f"path {' '.join(f'{r:.3f}' for r in rates[False])} rounds/s")
    exchange = {p: host_ms(lambda p=p: engines[p]._exchange(
        finals[p]["clients"], 0, None, finals[p], 0)) for p in (True, False)}
    print(f"async path: stale exchange of {K} proxies (flatten, mix, "
          f"unflatten, buffer rotation) kernels {exchange[True]:.3f} ms, "
          f"plain {exchange[False]:.3f} ms")

    # where a warm async round's time goes (the stacked round replayed:
    # its local steps run inside the graph)
    eng, state = engines[True], finals[True]
    round_s, _ = timed_round(eng, state, data, acfg.rounds)
    print(f"async breakdown: one engine round {round_s * 1e3:.3f} ms "
          "(a replay of the captured stacked round and its draws)")
    wall_ms, on_device = device_profile(
        lambda: eng.run_round(state, data, acfg.rounds, seed=0))
    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    stale_us = [e.self_device_time_total for e in on_device
                if "stale_reg" in e.name]
    print(f"async profile: one engine round under the profiler: wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.2f}%), {len(on_device)} device "
          f"kernels and copies; stale_reg device time "
          f"{' '.join(f'{u:.3f}' for u in stale_us)} us")
    return counts, {p: float(np.mean(r)) for p, r in rates.items()}, \
        exchange


def tau0_equals_sync(spec, data, cfg):
    """Async at staleness 0 runs the synchronous exchange verbatim."""
    from repro_torch.core.engine import dml_engine
    from repro_torch.nn.modules import tree_leaves

    zcfg = dataclasses.replace(async_config(cfg), staleness=0)
    leaves = []
    for backend in ("async", "vmap"):
        eng = dml_engine((spec,) * len(data), spec, zcfg, backend=backend,
                         device="cuda")
        state, _ = eng.run_rounds(eng.init_states(0), data, 0, 2, seed=0)
        assert isinstance(state, list), "staleness 0 must not wrap the state"
        leaves.append(tree_leaves(state))
    assert len(leaves[0]) == len(leaves[1])
    assert all(torch.equal(a, b) for a, b in zip(*leaves))
    print(f"async staleness 0 vs sync backend after 2 rounds: all "
          f"{len(leaves[0])} state tensors equal")


def mass_conservation(spec, data, cfg):
    """Staleness 2, lr 0, §3.4 dropout 0.25, 4 rounds: Σ z·w plus the
    in-flight θ and Σ w plus the in-flight w stay at their start (the card
    twin of tests/test_conformance.py:528-559)."""
    from repro_torch.core.engine import active_mask, dml_engine
    from repro_torch.nn.modules import tree_flatten_vector

    K = len(data)
    mcfg = dataclasses.replace(async_config(cfg), lr=0.0, dropout_rate=0.25,
                               rounds=4)
    eng = dml_engine((spec,) * K, spec, mcfg, backend="async", device="cuda")
    state = eng.init_states(0)

    def masses(st):
        z = torch.stack([tree_flatten_vector(s["proxy"]["params"])
                         for s in st["clients"]]).double()
        w = torch.stack([s["w"] for s in st["clients"]]).double()
        return (float((z * w[:, None]).sum() + st["stale_theta"].sum()),
                float(w.sum() + st["stale_w"].sum()))

    theta0, w0 = masses(state)
    assert w0 == K, w0
    dropped, worst = 0, (0.0, 0.0)
    for t in range(mcfg.rounds):
        act = active_mask(t, K, mcfg)
        dropped += 0 if act is None else int((~act).sum())
        state, _ = eng.run_round(state, data, t, seed=0)
        theta_m, w_m = masses(state)
        rel = (abs(theta_m - theta0) / abs(theta0), abs(w_m - K) / K)
        assert rel[0] <= 1e-5 and rel[1] <= 1e-6, (t, theta_m, theta0, w_m)
        worst = (max(worst[0], rel[0]), max(worst[1], rel[1]))
    assert dropped > 0, "the dropout masks dropped no client"
    print(f"mass conservation: staleness 2, dropout 0.25 ({dropped} client-"
          f"rounds dropped of {K * mcfg.rounds}), {mcfg.rounds} rounds: "
          f"largest relative drift of theta-mass {worst[0]:.3e} (start "
          f"{theta0:.6f}), of w-mass {worst[1]:.3e}")


# ---------------------------------------------------------------------------
# the compressed exchange, commitments, membership inference and fig. 4


def codec_checks():
    """(a) The codecs at the main path's width, [8, 199,210] f32 at ratio
    0.25, with a row of planted equal-magnitude ties: each card result
    bit-equal to the port's codec on the CPU over the same input (int8 with
    the same noise block); the public-copy core's decoded delta and copy
    too, with what of ``c + (m − pub') == m − pub`` holds exactly (dropped
    coordinates and silent clients) and the rest at the reference's own
    grade (tests/test_compress.py: rtol = atol = 1e-6). Returns the codec
    times."""
    from repro_torch.core import compress
    gen = torch.Generator().manual_seed(22)
    K, D = MAIN_K, MAIN_D
    m = 0.05 * torch.randn(K, D, generator=gen)
    pub = m + 1e-3 * torch.randn(K, D, generator=gen)
    m[0, ::3] = 0.75
    m[0, 1::7] = -0.75
    pub[0] = 0.0                       # row 0's delta: ties at ±0.75
    noise = torch.rand(K, D, generator=gen)
    sent = torch.as_tensor(np.asarray(
        mix_matrix_of(K, silent=5), np.float32))
    sent.fill_diagonal_(0.0)
    times = {}
    for mode in ("topk", "int8"):
        spec = compress.CompressionSpec(mode, COMPRESS_RATIO)
        u = m - pub
        want = compress.encode_decode(u, spec, noise)
        got = compress.encode_decode(u.cuda(), spec, noise.cuda())
        assert torch.equal(got.cpu(), want), f"{mode}: card codec differs"
        if mode == "topk":
            k = compress.topk_k(D, COMPRESS_RATIO)
            assert int(torch.count_nonzero(got[0])) == k
            tied = (u[0].abs() == 0.75).nonzero()[:, 0]
            kept = got[0].cpu().nonzero()[:, 0]
            assert torch.equal(kept, tied[:k]), "ties not lowest index first"
        c, pub2 = compress._ef_encode(m.cuda(), pub.cuda(), sent.cuda(),
                                      noise.cuda(), spec)
        rc, rpub2 = compress._ef_encode(m, pub, sent, noise, spec)
        assert torch.equal(c.cpu(), rc) and torch.equal(pub2.cpu(), rpub2)
        c, pub2 = c.cpu(), pub2.cpu()
        lhs, rhs = c + (m - pub2), m - pub
        exact = (c == 0)
        assert torch.equal(lhs[exact], rhs[exact])
        assert torch.equal(pub2[5].view(torch.int32), pub[5].view(torch.int32))
        torch.testing.assert_close(lhs, rhs, rtol=1e-6, atol=1e-6)
        inexact = int((lhs != rhs).sum())
        u_dev, noise_dev = u.cuda(), noise.cuda()
        times[mode] = cuda_us(lambda: compress.encode_decode(
            u_dev, spec, noise_dev), n=20)
        print(f"exchange (a): {mode} codec at [{K}, {D:,}] on the card bit-"
              f"equal to the CPU's, the public-copy core too; c + (m - pub') "
              f"== m - pub exactly at the {int(exact.sum()):,} entries "
              f"where c is 0 and at the silent client, {inexact:,} of "
              f"{K * D:,} entries one rounding off (max "
              f"{max_err(lhs, rhs):.3e}; rtol = atol = 1e-6); "
              f"{times[mode]:.3f} us a call (eager, CUDA events)")
    return times


def mix_matrix_of(K, silent):
    """Round 0's exponential P with client ``silent`` dropped (identity
    column: it sends nothing)."""
    from repro_torch.core.gossip import mix_matrix
    act = np.ones(K, bool)
    act[silent] = False
    return mix_matrix("pushsum", 0, K, "exponential", act)


class ExchangeLockstep:
    """Within the block, every compressed exchange the engines run on the
    card also runs on the CPU from the same inputs and the same noise
    block: the public copies bit for bit, z' and w' at the ``close``
    grade. A one-ulp difference in a step can flip a stochastic-rounding
    decision or a near-tied top-k entry of a later round, so two whole
    runs may part; each exchange may not."""

    def __init__(self):
        self.worst, self.calls = 0.0, 0

    def __enter__(self):
        from repro_torch.core import engine
        self.engine, self.raw = engine, engine.pushsum_mix_debiased

        def both(flat, w, P, **kw):
            out = self.raw(flat, w, P, **kw)
            if kw.get("compress") is not None:
                cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                       for k, v in kw.items()}
                ref = self.raw(flat.cpu(), w.cpu(), torch.as_tensor(P).cpu(),
                               **cpu)
                assert torch.equal(out[2].cpu(), ref[2]), "public copies"
                for a, b in zip(out[:2], ref[:2]):
                    torch.testing.assert_close(a.cpu(), b, **CLOSE)
                    self.worst = max(self.worst, max_err(a.cpu(), b))
                self.calls += 1
            return out

        engine.pushsum_mix_debiased = both
        return self

    def __exit__(self, *exc):
        self.engine.pushsum_mix_debiased = self.raw


class PerRound:
    """Within the block, the launch counts of each engine round-block
    (each round, at ``run_federated``'s default of one round a block):
    reset just before the block and read just after; their sum stays in
    the counters when the block ends."""

    def __init__(self):
        self.rounds = []

    def __enter__(self):
        from repro_torch import kernels
        from repro_torch.core.engine import FederationEngine
        self.cls, self.raw = FederationEngine, FederationEngine.run_rounds
        raw, rounds = self.raw, self.rounds

        def counted_block(eng, *args, **kwargs):
            kernels.reset_launch_counts()
            out = raw(eng, *args, **kwargs)
            torch.cuda.synchronize()
            rounds.append({**kernels.launch_counts(),
                           **kernels.route_launch_counts()})
            return out

        self.cls.run_rounds = counted_block
        return self

    def __exit__(self, *exc):
        self.cls.run_rounds = self.raw

    def total(self):
        return {k: sum(r[k] for r in self.rounds) for k in self.rounds[0]}


def compressed_path(spec, data, test, cfg, card):
    """(b) Compressed ProxyFL (top-k and int8) on the main path's set-up:
    exact launches each round (:class:`PerRound`: the DP kernels as on
    the main path, no mix kernel),
    the pinned epsilon, finite losses, warm public copies; a second run
    bit-equal, each client step against the plain path's (``Lockstep``)
    and each exchange against the CPU's (:class:`ExchangeLockstep`);
    rounds/s beside the uncompressed run's, the exchange's ms."""
    from repro_torch import kernels
    from repro_torch.core.baselines import run_federated
    from repro_torch.core.engine import dml_engine
    from repro_torch.nn.losses import cross_entropy
    from repro_torch.nn.modules import tree_flatten_vector

    K, (xt, yt), per_client = len(data), test, data[0][0].shape[0]
    S = per_client // cfg.batch_size
    steps = cfg.rounds * K * S
    out = {}
    for mode in ("none", "topk", "int8"):
        ccfg = dataclasses.replace(cfg, compress=mode,
                                   compress_ratio=COMPRESS_RATIO)

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_federated("proxyfl", [spec] * K, spec, data, test,
                                ccfg, seed=0, eval_every=ccfg.rounds,
                                device="cuda")
            torch.cuda.synchronize()
            return res, ccfg.rounds / (time.perf_counter() - t0)

        kernels.reset_launch_counts()
        with PerRound() as per_round:
            res, rate = run()
        counts = per_round.total()
        eng = dml_engine((spec,) * K, spec, ccfg, device="cuda")
        state0 = eng.init_states(0)
        if mode == "none":
            out[mode] = dict(rate=rate, counts=counts)
            ms = host_ms(lambda: eng._exchange(state0, 0))
            out[mode]["exchange_ms"] = ms
            print(f"exchange (b): uncompressed ProxyFL {rate:.4f} rounds/s "
                  f"(evaluation included); exchange {ms:.3f} ms on {card}")
            continue
        assert len(per_round.rounds) == ccfg.rounds
        for round_counts in per_round.rounds:
            expect(round_counts, **dp_launches(S))
        assert all(e == EPSILON_2_ROUNDS for e in res["epsilon"]), \
            (mode, res["epsilon"])
        with torch.no_grad():
            losses = [float(cross_entropy(spec.apply(getattr(c, role), xt),
                                          yt))
                      for c in res["clients"]
                      for role in ("private_params", "proxy_params")]
        assert all(math.isfinite(v) for v in losses), (mode, losses)
        flats = torch.stack([tree_flatten_vector(s["proxy"]["params"])
                             for s in state0["clients"]])
        assert torch.equal(state0["ef_state"], flats), "copies not warm"
        assert float(state0["ef_state"].abs().sum()) > 0
        with Lockstep() as lock, ExchangeLockstep() as xlock:
            again, _ = run()
        assert lock.steps == steps and xlock.calls == ccfg.rounds, \
            (lock.steps, xlock.calls)
        assert not lock.beyond, (mode, lock.beyond, lock.worst)
        assert all(torch.equal(a, b) for a, b in zip(
            all_leaves(res, "proxyfl"), all_leaves(again, "proxyfl"))), \
            f"{mode}: a second run of the same seed differs"
        state, _ = eng.run_rounds(state0, data, 0, ccfg.rounds, seed=0)
        assert torch.isfinite(state["ef_state"]).all()
        assert not torch.equal(state["ef_state"], state0["ef_state"])
        kernels.reset_launch_counts()
        ms = host_ms(lambda: eng._exchange(state["clients"], 0, None, state,
                                           0))
        assert kernels.launch_counts()["fused_pushsum_mix"] == 0
        row = res["history"][-1]
        priv = np.asarray(row["private_acc"])
        print(f"exchange (b): {mode} ProxyFL acc mean {priv.mean():.4f}; "
              f"epsilon {res['epsilon'][0]!r}; test loss mean "
              f"{np.mean(losses):.4f}; launches sumsq/rows "
              f"{counts['sumsq/rows']} scale_accumulate/clients "
              f"{counts['scale_accumulate/clients']} noise_adam_step/clients "
              f"{counts['noise_adam_step/clients']} fused_pushsum_mix "
              f"{counts['fused_pushsum_mix']}; each of {lock.steps} client "
              f"steps against the plain path's max abs diff "
              f"{lock.worst:.3e}, each of {xlock.calls} exchanges against "
              f"the CPU's {xlock.worst:.3e} (public copies bit-equal); a "
              f"second run bit-equal; {rate:.4f} rounds/s against "
              f"{out['none']['rate']:.4f} uncompressed; exchange {ms:.3f} ms "
              f"against {out['none']['exchange_ms']:.3f} on {card}")
        out[mode] = dict(rate=rate, counts=counts, exchange_ms=ms,
                         step_diff=lock.worst, exchange_diff=xlock.worst)
    return out


def compressed_async(spec, data, cfg):
    """(c) Async τ = 2 with int8 on fig_async's protocol, 6 rounds: the
    w-mass of clients plus buffer conserved round by round, no kernel
    launched (the stale mix kernel is uncompressed only; DP is off)."""
    from repro_torch import kernels
    from repro_torch.core.engine import dml_engine

    K = len(data)
    acfg = dataclasses.replace(async_config(cfg), compress="int8")
    eng = dml_engine((spec,) * K, spec, acfg, backend="async",
                     device="cuda")
    state = eng.init_states(0)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    worst = 0.0
    for t in range(acfg.rounds):
        state, m = eng.run_round(state, data, t, seed=0)
        w = torch.stack([s["w"] for s in state["clients"]]).double().sum()
        drift = abs(float(w + state["stale_w"].double().sum()) - K) / K
        assert drift <= 1e-6, (t, drift)
        worst = max(worst, drift)
    torch.cuda.synchronize()
    rate = acfg.rounds / (time.perf_counter() - t0)
    counts = {**kernels.launch_counts(), **kernels.route_launch_counts()}
    expect(counts)
    assert float(state["stale_w"].abs().sum()) > 0, "no mail in flight"
    assert all(math.isfinite(float(v)) for v in m["proxy_loss"])
    print(f"exchange (c): async staleness {acfg.staleness} int8, "
          f"{acfg.rounds} rounds, {rate:.3f} engine rounds/s: w-mass of "
          f"clients and buffer within {worst:.3e} of {K} every round; "
          f"launches {counts} (no fused_stale_mix)")
    return counts, rate


def commitments_path(spec, data, test, cfg):
    """(d) A 2-round loop run with ``verify_commitments`` bit-equal to the
    same run without; ``bitflip_proxy(client=1, rounds=(1,))`` refused
    with a ``CommitmentError`` naming client 1 and round 1; the final
    proxies' commitment on the card string-equal to that of the same
    params on the CPU."""
    from repro_torch.core.attacks import bitflip_proxy
    from repro_torch.core.baselines import run_federated
    from repro_torch.core.commit import CommitmentError, client_commitment
    from repro_torch.nn.modules import tree_map

    K = len(data)

    def run(verify, tamper=None):
        vcfg = dataclasses.replace(cfg, verify_commitments=verify)
        t0 = time.perf_counter()
        res = run_federated("proxyfl", [spec] * K, spec, data, test, vcfg,
                            seed=0, eval_every=vcfg.rounds, backend="loop",
                            device="cuda", transmit_tamper=tamper)
        torch.cuda.synchronize()
        return res, vcfg.rounds / (time.perf_counter() - t0)

    plain, plain_rate = run(False)
    verified, rate = run(True)
    assert all(torch.equal(a, b) for a, b in zip(
        all_leaves(plain, "proxyfl"), all_leaves(verified, "proxyfl"))), \
        "the verified run differs"
    try:
        run(True, bitflip_proxy(1, rounds=(1,)))
    except CommitmentError as err:
        assert (err.client, err.round) == (1, 1), (err.client, err.round)
        assert "client 1 at round 1" in str(err), str(err)
    else:
        raise AssertionError("the bit-flipped proxy was not refused")
    digests = [client_commitment(c.proxy_params)[0]
               for c in verified["clients"]]
    on_cpu = [client_commitment(tree_map(lambda x: x.cpu(),
                                         c.proxy_params))[0]
              for c in verified["clients"]]
    assert digests == on_cpu
    print(f"exchange (d): verified loop run bit-equal to the unverified "
          f"({rate:.4f} against {plain_rate:.4f} rounds/s); the bit flip "
          f"of client 1 in round 1 refused (CommitmentError, client 1, "
          f"round 1); {K} commitments of the card's proxies equal the CPU's "
          f"({digests[0][:16]}...)")
    return rate, plain_rate


def mia_path(card):
    """(e) ``mia_privacy``'s quick configuration on the card (4 clients, 4
    rounds, 0.3 of the data, σ = 2, C = 0.5, B = 25): every AUC in [0, 1],
    the DP federation's epsilon the JAX accountant's, the rows printed."""
    from repro_torch import kernels
    from repro_torch.benchmarks import mia_privacy

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp = mia_privacy.experiment(False, "cuda")
    rows = mia_privacy.rows_of(exp)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {**kernels.launch_counts(), **kernels.route_launch_counts()}
    assert exp["results"][True]["epsilon"] == [EPSILON_MIA_QUICK] * 4, \
        exp["results"][True]["epsilon"]
    for row in rows:
        for key in ("mia_auc_proxy_dp", "mia_auc_proxy_no_dp",
                    "mia_auc_private_nonreleased"):
            assert 0.0 <= row[key] <= 1.0, row
        print(f"exchange (e): mia {json.dumps(row)}")
    print(f"exchange (e): mia_privacy quick in {seconds:.3f} s on {card}; "
          f"launches {counts}")
    return counts


def fig4_path():
    """(f) ``fig4_comm.run(False)`` on the card, and
    ``scripts/check_comm_claim.py`` passing on the JSON it writes."""
    from repro_torch.benchmarks import fig4_comm

    here = Path(__file__).resolve().parent
    out = here / "chiprun_out"
    out.mkdir(exist_ok=True)
    path = out / "fig4_comm.json"
    old = os.environ.get("REPRO_BENCH_COMM_JSON")
    os.environ["REPRO_BENCH_COMM_JSON"] = str(path)
    try:
        rows = fig4_comm.run(False, device="cuda")
    finally:
        if old is None:
            del os.environ["REPRO_BENCH_COMM_JSON"]
        else:
            os.environ["REPRO_BENCH_COMM_JSON"] = old
    gate = subprocess.run(
        [sys.executable, str(here / "scripts" / "check_comm_claim.py"),
         str(path), str(out / "no_fig_compress.json")],
        capture_output=True, text=True, timeout=120)
    print(gate.stdout.strip())
    assert gate.returncode == 0, gate.stderr
    paper = [r for r in rows if r["scale"].startswith("paper")
             and r["clients"] == 8 and r["method"] == "proxyfl"]
    print("exchange (f): fig. 4 on the card, proxyfl at K = 8: " + ", ".join(
        f"{r['compress']} {r['bytes_per_round']:,} B/round" for r in paper)
        + f"; {len(rows)} rows in {path.name}")


def step_breakdown(spec, data, test, cfg):
    """Where the main path's time goes: host-clock times of synchronised
    phases of one client's local step (each warmed up, then the mean of
    3), of the exchange and of the evaluation, and a torch.profiler trace
    of one step for the device's busy share."""
    from repro_torch.core import dp
    from repro_torch.core.engine import dml_engine
    from repro_torch.core.protocol import evaluate_batched
    from repro_torch.nn.losses import dml_loss
    from repro_torch.nn.modules import tree_size
    from repro_torch.optim import Adam

    # one client's step on the loop (the stacked round's breakdown is the
    # stacked phase's)
    eng = dml_engine((spec,) * len(data), spec, cfg, backend="loop",
                     device="cuda")
    t0 = time.perf_counter()
    states = eng.init_states(0)
    torch.cuda.synchronize()
    print(f"breakdown: init_states of {len(data)} clients "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    state = states[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = eng.sample_fn(data[0], gen)
    theta, phi = state["proxy"]["params"], state["private"]["params"]
    opt = Adam(lr=cfg.lr, weight_decay=cfg.weight_decay)

    def proxy_loss(t, b):
        return dml_loss(spec.apply(t, b[0]), spec.apply(phi, b[0]), b[1],
                        cfg.beta)

    def private_loss(p, b):
        return dml_loss(spec.apply(p, b[0]), spec.apply(theta, b[0]), b[1],
                        cfg.alpha)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 3 * 1e3, out

    step_ms, _ = timed(lambda: eng.step_fns[0](state, batch, gen))
    grads_ms, (losses, grads) = timed(
        lambda: dp._per_example(proxy_loss, theta, batch))
    clip_ms, _ = timed(lambda: dp._flat_clip_accumulate(
        losses, grads, cfg.dp.clip_norm, tree_size(theta), "cuda"))
    proxy_ms, _ = timed(lambda: dp.dp_adam_update(
        proxy_loss, theta, state["proxy"]["opt"], batch, opt=opt,
        clip_norm=cfg.dp.clip_norm, noise_multiplier=cfg.dp.noise_multiplier,
        generator=gen))
    private_ms, _ = timed(lambda: opt.update(
        dp.non_dp_gradient(private_loss, phi, batch)[0],
        state["private"]["opt"], phi))
    exchange_ms, _ = timed(lambda: eng._exchange(states, 0))
    eval_ms, _ = timed(lambda: evaluate_batched(
        spec, eng.stacked_params(states, "private"), *test))
    print(f"breakdown: one client step {step_ms:.3f} ms; its parts, each "
          f"timed alone: proxy DP update {proxy_ms:.3f} ms (of it "
          f"per-example grads {grads_ms:.3f} ms and the "
          f"{cfg.batch_size}-example clip loop {clip_ms:.3f} ms), private "
          f"update {private_ms:.3f} ms")
    print(f"breakdown: exchange of {len(data)} proxies {exchange_ms:.3f} ms; "
          f"evaluation of {len(data)} models on {test[0].shape[0]} examples "
          f"{eval_ms:.3f} ms")

    # one whole round inside the engine, each local step timed in place
    round_s, step_s = timed_round(eng, states, data, 0)
    print(f"breakdown: one engine round {round_s * 1e3:.3f} ms, of it "
          f"{len(step_s)} local steps {sum(step_s) * 1e3:.3f} ms (min "
          f"{min(step_s) * 1e3:.3f}, median {np.median(step_s) * 1e3:.3f}, "
          f"max {max(step_s) * 1e3:.3f} ms per step)")

    wall_ms, on_device = device_profile(
        lambda: eng.step_fns[0](state, batch, gen))
    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    print(f"profile: one client step under the profiler: wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.2f}%), {len(on_device)} device "
          "kernels and copies")
    busy = {k: us for k, (_, us) in kernel_times(on_device).items()}
    print("profile: device us by kernel in the step: " + ", ".join(
        f"{n} {t:.3f}" for n, t in sorted(busy.items(),
                                          key=lambda kv: -kv[1])[:10]))
    for kname in ("sumsq_partials", "sum_partials", "clip_acc_rows",
                  "noise_adam"):
        ts = [e.self_device_time_total for e in on_device
              if kernel_key(e.name) == kname]
        print(f"profile: {kname} device time {np.mean(ts):.3f} us per "
              f"launch over {len(ts)} launches")


# ---------------------------------------------------------------------------
# the serve phase: the LLM serving path at full width


def serve_launches(cfg):
    """Exact kernel launches of one prefill (S > 1 from position 0) and of
    one decode step of ``cfg`` with the kernels on, by kernel and route:
    every layer's norm1, norm2 where it has an FFN, MLA's two latent norms,
    the final norm; one attention launch a GQA layer and one scan a mamba
    layer in the prefill, neither in a decode step."""
    from repro_torch.kernels.flash_attention import TENSOR_CORE_ROUTE
    from repro_torch.nn.model import layer_plan
    from repro_torch.nn.modules import torch_dtype
    rms, attn, scan = 1, 0, 0
    for spec, *_ in layer_plan(cfg):
        rms += 1 + (spec.ffn != "none")
        if spec.kind == "mamba":
            scan += 1
        elif cfg.attn_impl == "mla":
            rms += 2
        else:
            attn += 1
    route = TENSOR_CORE_ROUTE[torch_dtype(cfg.dtype)]
    decode = {"rmsnorm": rms, "rmsnorm/vector": rms}
    prefill = dict(decode, flash_attention=attn,
                   **{f"flash_attention/{route}": attn,
                      "mamba_scan/flat": scan}, mamba_scan=scan)
    return prefill, decode


def serve_run(params, cfg, tokens, gen_steps, use_pallas, img=None,
              counts=True):
    """Prefill ``tokens`` [B, S] (after a warm-up prefill), then
    ``gen_steps`` greedy decode steps, through the serve steps; each call's
    launches counted and held to :func:`serve_launches` where ``counts``.
    Returns the greedy tokens, prefill ms, decode ms a step and the peak
    device memory."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.nn.model import init_cache
    B, S = tokens.shape[:2]
    n_img = cfg.n_image_tokens if cfg.modality == "vlm" else 0
    prefill = make_prefill_step(cfg, use_pallas=use_pallas)
    decode = make_decode_step(cfg, use_pallas=use_pallas)
    want_prefill, want_decode = serve_launches(cfg)
    batch = {"tokens": tokens, "img": img}

    def fresh():
        return {"params": params, "cache": init_cache(
            cfg, B, S + n_img + gen_steps)}
    with torch.inference_mode():
        prefill(fresh(), batch)   # warm-up: library heuristics, allocator
        state = fresh()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (state, logits), got = counted(lambda: prefill(state, batch))
        prefill_ms = (time.perf_counter() - t0) * 1e3
        if counts and use_pallas:
            expect(got, **want_prefill)
        out = [torch.argmax(logits, dim=-1)]
        t0 = time.perf_counter()
        for i in range(gen_steps):
            tok = out[-1][:, None, :] if cfg.modality == "audio" \
                else out[-1][:, None]
            (state, logits), got = counted(lambda: decode(state, {
                "tokens": tok, "pos": S + n_img + i}))
            if counts and use_pallas:
                expect(got, **want_decode)
            out.append(torch.argmax(logits, dim=-1))
        decode_ms = (time.perf_counter() - t0) * 1e3 / max(gen_steps, 1)
    return (torch.stack(out, dim=1), prefill_ms, decode_ms,
            torch.cuda.max_memory_allocated())


def rel_err(got, want) -> float:
    """Normwise relative error ‖got − want‖₂ / ‖want‖₂ (in f64)."""
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / max(float(torch.linalg.vector_norm(want)), 1e-30))


class OnPath:
    """While active, every launch of the three LLM kernels from the model
    is also held, on the same inputs, against the model's own plain
    function: RMSNorm against the model's ``rmsnorm`` (they differ by up to
    one rounding: the kernel applies the gain in f32), attention against
    ``attend`` over the same fresh keys, the scan (y and the final state)
    against the model's chunked scan from the same state. Each at its
    kernel grade (``TOL`` of its dtype, the scan's 2e-4), element by
    element; the worst error of each and the launches checked are kept."""

    def __init__(self):
        self.worst = {"rmsnorm": 0.0, "flash_attention": 0.0,
                      "mamba_scan": 0.0}
        self.checked = dict.fromkeys(self.worst, 0)

    def __enter__(self):
        # the names the model's modules call (the kernels' own modules
        # count launches through their global names, left as they are)
        from repro_torch.nn import attention, blocks, mamba, mla, modules
        norm, attn, scan = (modules.rmsnorm, attention.gqa_flash_attention,
                            mamba.mamba_scan)

        def note(name, got, want, dtype, tol=None):
            self.worst[name] = max(self.worst[name], check(
                f"{name} on the model path", got, want, dtype, tol))
            self.checked[name] += 1

        def rmsnorm(p, x, eps=1e-6, use_pallas=True):
            out = norm(p, x, eps, use_pallas=use_pallas)
            if use_pallas:
                note("rmsnorm", out, norm(p, x, eps, use_pallas=False),
                     x.dtype)
            return out

        def gqa_flash_attention(q, k, v, *, causal=True, window=None,
                                **kw):
            out = attn(q, k, v, causal=causal, window=window, **kw)
            pos = attention.positions(0, q.shape[1], q.device)
            assert causal
            note("flash_attention", out, attention.attend(
                q, k, v, q_pos=pos, kv_pos=pos, window=window), q.dtype)
            return out

        def mamba_scan(dt, x, B_in, C_in, A, *, h0=None,
                       return_state=False, **kw):
            out = scan(dt, x, B_in, C_in, A, h0=h0,
                       return_state=return_state, **kw)
            start = h0 if h0 is not None else torch.zeros(
                (x.shape[0], x.shape[2], A.shape[1]), device=x.device)
            y, h_last = mamba.selective_scan(start, dt, A, B_in, C_in, x,
                                             dt.shape[1])
            note("mamba_scan", out, (y, h_last) if return_state else y,
                 torch.float32, SCAN_TOL)
            return out

        patches = [(blocks, "rmsnorm", rmsnorm), (mla, "rmsnorm", rmsnorm),
                   (attention, "gqa_flash_attention", gqa_flash_attention),
                   (mamba, "mamba_scan", mamba_scan)]
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name, _ in patches]
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def serve_lockstep(params, cfg, tokens, decode_steps, tol, img=None):
    """Every layer of a prefill of ``tokens`` and of ``decode_steps``
    decode steps after it, with the kernels and on the plain path from the
    same input (the kernel path's activation), each path with its own
    cache; then the final norm and logits. Each output and cache is held
    to the plain path's at ``tol`` normwise (‖Δ‖ / ‖plain‖): element by
    element the two differ by more, since a normed layer carries the bf16
    attention's rounding (its P is rounded to bf16) through d_ff-wide
    products (at qwen2-7b's full width some elements of its layers part
    by more than 2e-2 elementwise; the run prints the largest). Each
    kernel launch of the
    kernel path is held, element by element, to the model's plain
    function on its own inputs (:class:`OnPath`). Returns the largest
    errors: layers and logits normwise, the kernels elementwise."""
    from repro_torch.nn import model
    from repro_torch.nn.blocks import apply_layer
    from repro_torch.nn.modules import rmsnorm, tree_leaves
    B, S = tokens.shape[:2]
    n_img = cfg.n_image_tokens if cfg.modality == "vlm" else 0
    caches = [model.init_cache(cfg, B, S + n_img + decode_steps)
              for _ in range(2)]
    plan = model.layer_plan(cfg)
    worst = {"layers": 0.0, "logits": 0.0, "layers_elementwise": 0.0}
    calls = [(tokens, img, 0)] + [(tokens[:, i:i + 1], None, S + n_img + i)
                                  for i in range(decode_steps)]

    def held(what, got, want):
        err = rel_err(got, want)
        assert err <= tol, f"{what}: normwise {err:.3e} > {tol}"
        return err

    with torch.inference_mode(), OnPath() as on_path:
        for c, (t, im, pos) in enumerate(calls):
            x = model._embed_inputs(params, cfg, t, im)
            for n, (spec, group, i, r) in enumerate(plan):
                p = model.layer_of(params, group, i, r)
                layer_caches = [model.layer_of(cache, group, i, r)
                                for cache in caches]
                (yk, _, ak), (yp, _, ap) = (
                    apply_layer(p, cfg, spec, x, pos_offset=pos,
                                cache=lc, use_pallas=k)
                    for k, lc in zip((True, False), layer_caches))
                what = f"{cfg.name} call {c} layer {n}"
                worst["layers"] = max(
                    worst["layers"], held(what, yk, yp),
                    held(what + " aux", ak, ap) if float(ap) else 0.0, *(
                        held(f"{what} cache", a, b)
                        for a, b in zip(*map(tree_leaves, layer_caches))))
                worst["layers_elementwise"] = max(
                    worst["layers_elementwise"], max_err(yk, yp))
                x = yk
            logits = [model._logits(params, cfg, rmsnorm(
                params["norm_f"], x, use_pallas=k)) for k in (True, False)]
            worst["logits"] = max(worst["logits"], held(
                f"{cfg.name} call {c} logits", *logits))
    worst["kernels"] = on_path.worst
    worst["kernels_checked"] = on_path.checked
    return worst


def lockstep_line(worst) -> str:
    k = worst["kernels"]
    return (f"lockstep: layers normwise {worst['layers']:.3e} (elementwise "
            f"{worst['layers_elementwise']:.3e}), logits normwise "
            f"{worst['logits']:.3e}; kernels on the model path elementwise: "
            + ", ".join(f"{name} {k[name]:.3e} ({n} launches)"
                        for name, n in worst["kernels_checked"].items()))


def serve_full(card, arch, tokens_shape, gen_steps, n_layers=None):
    """One registry model at full width (``n_layers`` cuts the depth):
    random weights from a seeded generator on the card, greedy serving with
    the kernels (launches exact on every call) and on the plain path, and
    the layer-by-layer lockstep of a prefill and one decode step."""
    from repro_torch.configs import get_config
    from repro_torch.nn.model import init_model
    from repro_torch.nn.modules import tree_bytes, tree_size
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.with_(n_layers=n_layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_model(gen, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.randint(0, cfg.vocab_size, tokens_shape, generator=gen,
                           device="cuda")
    img = torch.randn((tokens_shape[0], cfg.n_image_tokens,
                       cfg.frontend_dim), generator=gen, device="cuda").to(
        torch.bfloat16) if cfg.modality == "vlm" else None
    runs = {k: serve_run(params, cfg, tokens, gen_steps - 1, k, img)
            for k in (True, False)}
    worst = serve_lockstep(params, cfg, tokens, 1, TOL[torch.bfloat16], img)
    (toks, pre_ms, dec_ms, peak), (ptoks, ppre_ms, pdec_ms, _) = \
        runs[True], runs[False]
    B = tokens_shape[0]
    S = tokens_shape[1] + (cfg.n_image_tokens if img is not None else 0)
    n, weight_bytes = tree_size(params), tree_bytes(params)
    r = dict(arch=arch, layers=cfg.n_layers, B=B, S=S, gen=gen_steps,
             params=n, weight_bytes=weight_bytes, init_s=init_s,
             prefill_ms=pre_ms, decode_ms=dec_ms,
             prefill_tok_s=B * S / (pre_ms / 1e3),
             decode_tok_s=B / (dec_ms / 1e3), peak_bytes=peak,
             plain_prefill_ms=ppre_ms, plain_decode_ms=pdec_ms,
             prefill_bound_ms=2 * n * B * S / BF16_OPS_PER_S * 1e3,
             decode_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
             launches=serve_launches(cfg), lockstep=worst,
             tokens_agree=int((toks == ptoks).sum()),
             tokens=toks[0].tolist(), plain_tokens=ptoks[0].tolist())
    print(f"serve {arch} ({cfg.n_layers} layers, {n:,} params, "
          f"{weight_bytes / 1e9:.3f} GB): B={B} S={S} prefill "
          f"{pre_ms:.3f} ms ({r['prefill_tok_s']:.1f} tok/s; bound "
          f"{r['prefill_bound_ms']:.3f} ms), decode {dec_ms:.3f} ms a step "
          f"({r['decode_tok_s']:.1f} tok/s; bound {r['decode_bound_ms']:.3f} "
          f"ms), peak {peak / 1e9:.3f} GB; plain path prefill "
          f"{ppre_ms:.3f} ms, decode {pdec_ms:.3f} ms a step; "
          f"{lockstep_line(worst)}; greedy tokens equal {r['tokens_agree']} of "
          f"{toks.numel()}; init {init_s:.3f} s; on {card}")
    print(f"serve {arch} tokens: kernels {r['tokens']}, plain "
          f"{r['plain_tokens']}")
    del params, runs
    torch.cuda.empty_cache()
    return r


def serve_f32(card):
    """qwen2-7b at full width and 2 layers in f32 (the split-TF32 attention
    route): the layer-by-layer lockstep at the f32 grade, and the launches
    of a served prefill and decode step."""
    from repro_torch.configs import get_config
    from repro_torch.nn.model import init_model
    cfg = get_config("qwen2-7b").with_(n_layers=2, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_model(gen, cfg)
    tokens = torch.randint(0, cfg.vocab_size, SERVE_TOKENS, generator=gen,
                           device="cuda")
    serve_run(params, cfg, tokens, 1, True)
    worst = serve_lockstep(params, cfg, tokens, 1, TOL[torch.float32])
    print(f"serve qwen2-7b f32, 2 layers: {lockstep_line(worst)} "
          f"(tolerance {TOL[torch.float32]}) on {card}")
    del params
    torch.cuda.empty_cache()
    return worst


def serve_smoke(card):
    """The smoke variant of every registry name on the card: greedy serving
    with exact launches on every call, the lockstep against the plain
    path (bf16), and prefill + decode against the no-cache forward in f32
    with dropless MoE (tests/test_models.py:85-116's check, kernels on)."""
    from repro_torch.configs import get_config, list_archs, smoke_variant
    from repro_torch.nn.model import forward, init_cache, init_model
    B, S, S0 = SMOKE_SERVE
    out = {}
    for arch in list_archs():
        cfg = smoke_variant(get_config(arch))
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = init_model(gen, cfg)
        shape = (B, S, cfg.n_codebooks) if cfg.modality == "audio" else (B, S)
        tokens = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                               device="cuda")
        img = torch.randn((B, cfg.n_image_tokens, cfg.frontend_dim),
                          generator=gen, device="cuda").to(torch.bfloat16) \
            if cfg.modality == "vlm" else None
        toks = serve_run(params, cfg, tokens[:, :S0], S - S0, True, img)[0]
        worst = serve_lockstep(params, cfg, tokens[:, :S0], S - S0,
                               TOL[torch.bfloat16], img)
        # decode against forward: f32, dropless MoE
        cfg32 = cfg.with_(dtype="float32")
        if cfg32.moe is not None:
            cfg32 = cfg32.with_(moe=dataclasses.replace(
                cfg32.moe, capacity_factor=float(cfg32.moe.n_experts)))
        params32 = init_model(gen, cfg32)
        img32 = None if img is None else img.float()
        n_img = cfg.n_image_tokens if cfg.modality == "vlm" else 0
        with torch.inference_mode():
            full, _, _ = forward(params32, cfg32, tokens, img32)
            cache = init_cache(cfg32, B, S + n_img)
            logits, cache, _ = forward(params32, cfg32, tokens[:, :S0], img32,
                                       cache=cache)
            errs = [check(f"{arch} prefill against forward", logits,
                          full[:, :S0 + n_img], torch.float32, DECODE_TOL)]
            for i in range(S0, S):
                logits, cache, _ = forward(params32, cfg32,
                                           tokens[:, i:i + 1], cache=cache,
                                           pos_offset=i + n_img)
                errs.append(check(f"{arch} decode {i} against forward",
                                  logits[:, 0], full[:, n_img + i],
                                  torch.float32, DECODE_TOL))
        out[arch] = dict(lockstep=worst, decode_vs_forward=max(errs),
                         launches=serve_launches(cfg))
        print(f"serve smoke {arch}: launches a prefill {serve_launches(cfg)[0]}"
              f", a decode step {serve_launches(cfg)[1]}; "
              f"{lockstep_line(worst)}; "
              f"f32 decode against forward {max(errs):.3e} (tolerance "
              f"{DECODE_TOL}); tokens {toks[0].reshape(-1).tolist()[:12]}")
        del params, params32
    torch.cuda.empty_cache()
    return out


def serve_path(card):
    """The serve phase: (a) qwen2-7b and (b) falcon-mamba-7b at full depth
    and width, B = 4, a 1,024-token prompt, 16 greedy tokens; (c)
    gemma3-4b at full width and one 5:1 pattern (6 layers), B = 2, a
    2,048-token prompt over its 1,024-token window; phi-3-vision-4.2b at
    full depth and width (its 576 image tokens before the prompt; head dim
    96 on the 128-wide wgmma instantiation); qwen2-7b in f32 at 2 layers;
    the smoke variant of every registry name."""
    t0 = time.perf_counter()
    res = {"qwen2-7b": serve_full(card, "qwen2-7b", SERVE_TOKENS, SERVE_GEN),
           "falcon-mamba-7b": serve_full(card, "falcon-mamba-7b",
                                         SERVE_TOKENS, SERVE_GEN),
           "gemma3-4b": serve_full(card, "gemma3-4b", GEMMA_TOKENS,
                                   SERVE_GEN, n_layers=GEMMA_LAYERS),
           "phi-3-vision-4.2b": serve_full(card, "phi-3-vision-4.2b",
                                           SERVE_TOKENS, SERVE_GEN)}
    res["qwen2-7b f32"] = serve_f32(card)
    res["smoke"] = serve_smoke(card)
    print(f"serve phase: {time.perf_counter() - t0:.1f} s")
    return res

# ---------------------------------------------------------------------------
# the train phase: the LLM ProxyFL training path


def add_counts(*pairs):
    """Σ n · counts over (n, counts) pairs, key by key."""
    out = {}
    for n, counts in pairs:
        for key, v in counts.items():
            out[key] = out.get(key, 0) + n * v
    return out


def peer_launches(cfg):
    """The launches of one peer forward of ``cfg`` without a gradient on
    the stacked executor: a forward without a cache (:func:`serve_launches`'
    prefill counts) for the whole cohort, each kernel once and on its
    client route (rmsnorm's client grid, attention folded over the
    clients, the scan's client route) in place of its flat ones."""
    out = {}
    for key, n in serve_launches(cfg)[0].items():
        name = key.split("/")[0]
        if key == name:
            out[name] = n
        else:
            out[f"{name}/clients"] = out.get(f"{name}/clients", 0) + n
    return out


def train_launches(run, steps: int, evals: int, mixes: int, stale: bool):
    """Exact launches of a training run with the kernels on: each client
    step (on the stacked executor each batched step, ``steps`` of them)
    runs the proxy peer's forward once (one microbatch) and the private
    peer's once (one DP chunk of the batch), each a forward without a
    cache (:func:`peer_launches`); each evaluation the private model's
    over the test set in batches of 8 (flat routes); each exchange one mix
    (the stale one under async τ > 0). The differentiated forwards run the
    plain path: none."""
    test_batches = -(-run.test.shape[0] // 8)
    want = add_counts((steps, peer_launches(run.proxy)),
                      (steps, peer_launches(run.cfg)),
                      (evals * test_batches, serve_launches(run.cfg)[0]))
    want["fused_stale_mix" if stale else "fused_pushsum_mix"] = mixes
    return {k: v for k, v in want.items() if v}


def train_engine(run, args, use_pallas: bool):
    """A fresh driver engine over ``run``'s configuration and corpora
    (kernels on or the plain path), with fresh accountants."""
    from repro_torch.launch import train
    return train.make_engine(run.cfg, run.proxy, dataclasses.replace(
        run.fl, use_pallas=use_pallas), args, run.n_seqs, "cuda")


def clone(tree):
    from repro_torch.nn.modules import tree_map
    return tree_map(lambda x: x.clone(), tree)


def train_drive(eng, run, args):
    """The driver's loop (``launch/train.py::main``) from a copy of the
    run's initial state: blocks of rounds, the client-0 private model's
    test perplexity at each block edge. Returns (state, metrics rows,
    perplexities, wall s)."""
    from repro_torch.core.engine import block_spans
    from repro_torch.launch.train import evaluate_ppl
    state = clone(run.state)
    rows, ppls = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t, n in block_spans(0, args.rounds, args.rounds_per_block):
        state, m = eng.run_rounds(state, run.data, t, n, args.seed)
        rows.append(m)
        ppls.append(evaluate_ppl(eng.client_params(state, 0, "private"),
                                 run.cfg, run.test,
                                 use_pallas=eng.use_pallas))
    torch.cuda.synchronize()
    return state, rows, ppls, time.perf_counter() - t0


def train_breakdown(run, args, card):
    """One warm client step of the preset and its parts on the host
    clock (each timed in place: the synchronised wall of the private
    update's gradient, of the proxy's DP gradient and, of it, the
    per-example gradients; Adam's two updates and the rest are the step
    less these), the exchange of the four proxies, one evaluation, and one
    step under torch.profiler for the device's busy share."""
    from repro_torch.core import dp
    from repro_torch.launch import steps
    from repro_torch.launch.train import evaluate_ppl

    eng = train_engine(run, args, use_pallas=True)
    states = clone(run.state)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = eng.sample_fn(run.data[0], gen)
    spent = {"private": 0.0, "proxy": 0.0, "per_example": 0.0}

    def timed_call(key, fn):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return out
        return wrapped

    def per_example_vmap(f, *a, **kw):
        return timed_call("per_example", dp_vmap(f, *a, **kw))

    dp_vmap = dp.vmap
    n = 3
    step = eng.step_fns[0]
    step(states[0], batch, gen)   # warm-up
    saved = (steps.non_dp_gradient, steps.dp_gradient_chunked, dp.vmap)
    steps.non_dp_gradient = timed_call("private", steps.non_dp_gradient)
    steps.dp_gradient_chunked = timed_call("proxy", steps.dp_gradient_chunked)
    dp.vmap = per_example_vmap
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step(states[0], batch, gen)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / n * 1e3
    finally:
        steps.non_dp_gradient, steps.dp_gradient_chunked, dp.vmap = saved
    private_ms, proxy_ms, pe_ms = (spent[k] / n * 1e3 for k in
                                   ("private", "proxy", "per_example"))

    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    exchange_ms = timed(lambda: eng._exchange(states, 0))
    eval_ms = timed(lambda: evaluate_ppl(states[0]["private"]["params"],
                                         run.cfg, run.test))
    rest_ms = step_ms - private_ms - proxy_ms
    print(f"train breakdown: one client step of the preset {step_ms:.3f} ms "
          f"(B = {args.batch}, S = {args.seq}; each part timed in place, "
          f"synchronised): private update's gradient {private_ms:.3f} ms "
          f"(with the proxy peer's forward), proxy DP gradient "
          f"{proxy_ms:.3f} ms (with the private peer's forward; of it "
          f"per-example gradients {pe_ms:.3f} ms), Adam's two updates and "
          f"the rest {rest_ms:.3f} ms; exchange of {args.clients} proxies "
          f"{exchange_ms:.3f} ms; one evaluation of {run.test.shape[0]} "
          f"sequences {eval_ms:.3f} ms on {card}")
    wall_ms, on_device = device_profile(lambda: step(states[0], batch, gen))
    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    print(f"train profile: one client step under the profiler: wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.2f}%), {len(on_device)} device "
          "kernels and copies")
    busy = {k: us for k, (_, us) in kernel_times(on_device).items()}
    print("train profile: device us by kernel in the step: " + ", ".join(
        f"{k} {t:.3f}" for k, t in sorted(busy.items(),
                                          key=lambda kv: -kv[1])[:10]))
    return dict(step_ms=step_ms, private_ms=private_ms, proxy_ms=proxy_ms,
                per_example_ms=pe_ms, rest_ms=rest_ms,
                exchange_ms=exchange_ms, eval_ms=eval_ms, wall_ms=wall_ms,
                busy_ms=busy_ms)


def free_engines():
    """Drop what engines no longer referenced hold on the card: an engine
    with captured rounds lives in a reference cycle, and each graph keeps
    its memory pool until the collector frees it."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def train_rates(run, args):
    """Rounds/s of the preset without evaluation, each as one block of
    ``TRAIN_RATE_ROUNDS`` rounds after two warm-up rounds (on the captured
    path the key's eager first round and the capture): the loop, the
    stacked round eager and captured."""
    from repro_torch.launch import train
    rates = {}
    for label, backend, eager in (("loop", "loop", False),
                                  ("eager", "vmap", True),
                                  ("captured", "vmap", False)):
        a = train.parse_args(TRAIN_ARGS + ["--backend", backend])
        eng = train.make_engine(run.cfg, run.proxy, run.fl, a, run.n_seqs,
                                "cuda")
        eng._eager_stacked = eager
        state, _ = eng.run_rounds(clone(run.state), run.data, 0, 2, a.seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = eng.run_rounds(state, run.data, 2, TRAIN_RATE_ROUNDS,
                                  a.seed)
        torch.cuda.synchronize()
        rates[label] = TRAIN_RATE_ROUNDS / (time.perf_counter() - t0)
        del eng, state
        free_engines()
    return rates


def train_profile(run, args, card):
    """A captured round of the preset under the profiler (after the key's
    eager first round and the capture): the device's busy share and its
    device µs by kernel."""
    eng = train_engine(run, args, use_pallas=True)
    state, _ = eng.run_rounds(clone(run.state), run.data, 0, 2, args.seed)
    wall_ms, on_device = device_profile(
        lambda: eng.run_rounds(state, run.data, 2, 1, args.seed))
    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    busy = {k: us for k, (_, us) in kernel_times(on_device).items()}
    print(f"train phase (a): a captured round of the preset under the "
          f"profiler: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.2f}%), {len(on_device)} device "
          f"kernels and copies on {card}")
    print("train phase (a): device us a captured round by kernel: " + ", ".join(
        f"{k} {t:.3f}" for k, t in sorted(busy.items(),
                                          key=lambda kv: -kv[1])[:12]))
    del eng, state
    free_engines()
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, by_kernel=busy)


def train_preset(card):
    """(a) the preset, 3 rounds of 3 steps on the vmap backend (the
    stacked executor: the first round eager, the second captured, the
    third replayed), with the kernels and on the plain path: launches
    exact with the replays counted (none inside the differentiated
    forwards), captured bit-equal to eager, a second run bit-equal, each
    batched step against the loop's kernel steps client by client and
    against the plain path's vmapped alike (:class:`Lockstep`), epsilon
    the JAX package's; rounds/s of the loop, eager and captured, a
    captured round's busy share and device µs by kernel, peak memory, the
    loop's step breakdown."""
    from repro_torch import kernels
    from repro_torch.launch import steps, train
    from repro_torch.nn.modules import tree_leaves

    args = train.parse_args(TRAIN_ARGS + ["--rounds", str(TRAIN_ROUNDS)])
    t0 = time.perf_counter()
    run = train.setup(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    K, S = args.clients, args.steps_per_round
    print(f"train phase (a): {run.cfg.name} {train.tree_size_of(run.cfg)} "
          f"({sum(x.numel() for x in tree_leaves(run.state[0]['private']['params'])):,} "
          f"params) around {run.proxy.name} (D = "
          f"{sum(x.numel() for x in tree_leaves(run.state[0]['proxy']['params'])):,}), "
          f"K = {K}; set-up (corpora, {K} clients' initial states drawn on "
          f"the CPU, moved) {setup_s:.3f} s")

    # launches inside the differentiated forwards: every forward that a
    # gradient passes through, its launches counted
    inside = {"calls": 0, "launches": 0}
    raw_fwd = steps._forward_logits

    def fwd(params, cfg, batch, opts, *, use_pallas):
        if torch.is_grad_enabled():
            before = sum(kernels.launch_counts().values())
            out = raw_fwd(params, cfg, batch, opts, use_pallas=use_pallas)
            inside["calls"] += 1
            inside["launches"] += sum(kernels.launch_counts().values()) \
                - before
            return out
        return raw_fwd(params, cfg, batch, opts, use_pallas=use_pallas)

    eng = train_engine(run, args, use_pallas=True)
    assert eng.stacked
    free_engines()
    torch.cuda.reset_peak_memory_stats()
    steps._forward_logits = fwd
    try:
        (state, rows, ppls, wall), got = counted(
            lambda: train_drive(eng, run, args))
    finally:
        steps._forward_logits = raw_fwd
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.memory_reserved()
    # per batched step, one launch of each peer kernel for the cohort on
    # its client route; the evaluations on the flat routes; replays
    # counted by the capture's counts
    want = train_launches(run, S * args.rounds, args.rounds, args.rounds,
                          stale=False)
    expect(got, **want)
    assert len(eng._graphs) == 1, len(eng._graphs)
    # the forwards a gradient passes through, traced once a batched step
    # by the rounds whose Python ran (the eager round and the capture; a
    # replay runs none): the private loss's and the proxy's per-example
    # one (one call under the DP vmap)
    assert inside["launches"] == 0 and inside["calls"] == \
        2 * S * min(args.rounds, 2), inside
    eps = [a.epsilon() for a in eng.accountants]
    assert all(e == EPSILON_TRAIN for e in eps), eps
    for m in rows:
        for key in ("private_loss", "proxy_loss"):
            assert np.isfinite(m[key]).all(), (key, m[key])
    assert all(np.isfinite(p) for p in ppls), ppls
    del eng
    free_engines()
    # captured against eager: bit-equal predicted, the difference printed
    eager_eng = train_engine(run, args, use_pallas=True)
    eager_eng._eager_stacked = True
    eager = train_drive(eager_eng, run, args)[0]
    diff = max(max_err(a, b) for a, b in zip(tree_leaves(state),
                                             tree_leaves(eager)))
    assert states_equal(state, eager), f"captured differs from eager {diff}"
    del eager_eng, eager
    free_engines()
    # the rate of the second run: the first pays the process's first
    # calls at these shapes (library heuristics, the allocator's growth)
    second, _, _, warm = train_drive(train_engine(run, args,
                                                  use_pallas=True), run, args)
    for a, b in zip(tree_leaves(state), tree_leaves(second)):
        assert torch.equal(a, b), "a second run of the seed differs"
    del second
    free_engines()
    rate = args.rounds / warm
    print(f"train phase (a): launches {got_nonzero(got)} in {args.rounds} "
          f"rounds of {S} batched steps (per batched step, for the cohort: "
          f"{serve_launches(run.proxy)[0]['rmsnorm']} rmsnorm and "
          f"{serve_launches(run.proxy)[0]['flash_attention']} attention in "
          f"the proxy peer, {serve_launches(run.cfg)[0]['rmsnorm']} and "
          f"{serve_launches(run.cfg)[0]['flash_attention']} in the private "
          f"peer, on their client routes); the first round eager, the "
          f"second captured, the third replayed, captured bit-equal to "
          f"eager (max abs diff {diff:.3e}); {inside['calls']} "
          f"differentiated forwards traced, {inside['launches']} launches "
          f"in them; eps {eps[0]!r}; client-0 test ppl "
          f"{['%.3f' % p for p in ppls]}; {rate:.4f} rounds/s ({warm:.3f} "
          f"s for {args.rounds} rounds, evaluation included; the process's "
          f"first run {wall:.3f} s), peak {peak / 1e9:.3f} GB allocated, "
          f"{reserved / 1e9:.3f} GB reserved, on {card}")

    # each batched step against the loop's kernel step, client by client
    lock_eng = train_engine(run, args, use_pallas=True)
    with Lockstep(against="loop", twin=lock_eng.step_fns[0]) as lock:
        train_drive(lock_eng, run, args)
    lock.check(S * args.rounds * K)
    print(f"train phase (a): each of {lock.steps} client steps of the "
          f"stacked rounds against the loop's kernel step from the same "
          f"state, batch and noise: max abs diff {lock.worst:.3e} (close "
          f"grade; in first Adam steps {lock.eps_masked} param coordinates "
          f"at |g| < 100 eps masked, {lock.eps_past} of them past close; "
          f"{lock.outliers} of {lock.coords:,} param and moment coordinates "
          f"past close) on {card}")
    del lock_eng
    free_engines()
    plain_eng = train_engine(run, args, use_pallas=False)
    plain_wall = train_drive(plain_eng, run, args)[3]
    # the plain step, without its engine's captured round (one graph's
    # pool on the card at a time)
    plain_step = plain_eng.step_fns[0]
    del plain_eng
    free_engines()
    lock_eng = train_engine(run, args, use_pallas=True)
    with Lockstep(twin=plain_step, grad_normwise=TRAIN_GRAD_NORMWISE) \
            as tlock:
        train_drive(lock_eng, run, args)
    tlock.check(K * S * args.rounds)
    print(f"train phase (a): a second run bit-equal; each of {tlock.steps} "
          f"client steps against the plain path's vmapped alike from the "
          f"same state: losses, moments and params at close, worst "
          f"{tlock.worst:.3e}; each leaf's gradient normwise, worst "
          f"{tlock.grad_worst:.3e} (grade {TRAIN_GRAD_NORMWISE:g}); in first "
          f"Adam steps {tlock.eps_masked} param coordinates at |g| < 100 eps "
          f"masked by rule, {tlock.eps_past} of them past close; plain path "
          f"{args.rounds / plain_wall:.4f} rounds/s on {card}")
    del lock_eng
    free_engines()
    rates = train_rates(run, args)
    print(f"train phase (a): rounds/s of the preset without evaluation "
          f"({TRAIN_RATE_ROUNDS} rounds of {S} steps as one block after two "
          f"warm-up rounds): loop {rates['loop']:.4f}, eager stacked "
          f"{rates['eager']:.4f}, captured {rates['captured']:.4f} on {card}")
    profile = train_profile(run, args, card)
    breakdown = train_breakdown(run, args, card)
    return dict(counts=got, rate=rate, plain_rate=args.rounds / plain_wall,
                peak=peak, reserved=reserved, breakdown=breakdown,
                lock_worst=tlock.worst, grad_worst=tlock.grad_worst,
                eps_masked=tlock.eps_masked, eps_past=tlock.eps_past,
                loop_worst=lock.worst, outliers=lock.outliers,
                coords=lock.coords, rates=rates, profile=profile, ppl=ppls,
                captured_vs_eager=diff)


def got_nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def train_async(card):
    """(b) the preset on ``--backend async --staleness 2``, 3 rounds: one
    stale mix a round at [4, 6,293,760], launches exact, epsilon."""
    from repro_torch.launch import train
    args = train.parse_args(TRAIN_ARGS + [
        "--rounds", str(TRAIN_ASYNC_ROUNDS), "--backend", "async",
        "--staleness", str(TRAIN_TAU)])
    run = train.setup(args)
    eng = train_engine(run, args, use_pallas=True)
    (state, rows, ppls, wall), got = counted(
        lambda: train_drive(eng, run, args))
    K = args.clients
    expect(got, **train_launches(
        run, args.steps_per_round * args.rounds, args.rounds,
        args.rounds, stale=True))
    assert tuple(state["stale_theta"].shape) == (TRAIN_TAU, K, TRAIN_D)
    assert all(a.epsilon() == EPSILON_TRAIN for a in eng.accountants)
    assert all(np.isfinite(m["proxy_loss"]).all() for m in rows)
    print(f"train phase (b): async tau = {TRAIN_TAU}, {args.rounds} rounds: "
          f"launches {got_nonzero(got)}; {args.rounds / wall:.4f} rounds/s "
          f"on {card}")
    return dict(counts=got, rate=args.rounds / wall)


def train_smoke(card):
    """(c) the smoke variant of every registry name, K = 2, 1 round of one
    step (B = 2, S = 32) with the kernels on: launches exact, epsilon, the
    bf16 runs' master copies moved."""
    from repro_torch.configs import list_archs
    from repro_torch.launch import train
    from repro_torch.nn.modules import tree_leaves
    counts = {}
    for arch in list_archs():
        args = train.parse_args(["--arch", arch] + TRAIN_SMOKE_ARGS)
        run = train.setup(args)
        eng = train_engine(run, args, use_pallas=True)
        (state, rows, ppls, _), got = counted(
            lambda: train_drive(eng, run, args))
        assert eng.stacked
        # one batched step: each peer kernel once for the cohort
        expect(got, **train_launches(run, 1, 1, 1, stale=False))
        assert all(a.epsilon() == EPSILON_TRAIN_SMOKE
                   for a in eng.accountants)
        assert np.isfinite(rows[0]["private_loss"]).all()
        p32 = state[0]["private"]["opt"].p32
        assert (p32 is None) == (run.cfg.dtype == "float32")
        if p32 is not None:
            before = run.state[0]["private"]["opt"].p32
            assert not all(torch.equal(a, b) for a, b in zip(
                tree_leaves(p32), tree_leaves(before))), arch
            assert not torch.equal(p32["norm_f"]["g"],
                                   before["norm_f"]["g"]), arch
        counts[arch] = got_nonzero(got)
        print(f"train phase (c): {arch} smoke ({run.cfg.dtype}): launches "
              f"{counts[arch]}" + ("" if p32 is None else
                                   ", the master copy moved"))
    return counts


def train_path(card):
    """The train phase (module docstring, 10)."""
    t0 = time.perf_counter()
    res = {"preset": train_preset(card)}
    res["async"] = train_async(card)
    free_engines()
    res["smoke"] = train_smoke(card)
    free_engines()
    print(f"train phase: {time.perf_counter() - t0:.1f} s")
    return res


# ---------------------------------------------------------------------------
# the resume phase: checkpoints and kill / resume on the card


def launch_key(name: str) -> str:
    """The counter of a kernel-line name: the clip pair's rows route and
    1-D route, the client-grid routes, Adam's flat route, attention by its
    route, the rest by name."""
    return {"sumsq_rows": "sumsq/rows",
            "clip_accumulate_rows": "scale_accumulate/rows",
            "clip_accumulate_rows_clients": "scale_accumulate/clients",
            "noise_adam_step": "noise_adam_step/flat",
            "noise_adam_step_clients": "noise_adam_step/clients",
            "sumsq": "sumsq/vector",
            "scale_accumulate": "scale_accumulate/vector",
            "flash_attention": "flash_attention/wgmma",
            "flash_attention_tf32x3": "flash_attention/tf32x3",
            "flash_attention_narrow": "flash_attention/wgmma/narrow",
            "flash_attention_tf32x3_narrow":
            "flash_attention/tf32x3/narrow",
            "rmsnorm_clients": "rmsnorm/clients",
            "flash_attention_clients": "flash_attention/clients",
            "mamba_scan_clients": "mamba_scan/clients"}.get(name, name)


def flip_mantissa_bit(npz_path: str, key_part: str) -> str:
    """Flip the lowest mantissa bit of the first entry of the first leaf
    whose key holds ``key_part`` in a snapshot; returns that key."""
    with np.load(npz_path) as z:
        arrays = {k: z[k] for k in z.files}
    key = next(k for k in arrays if key_part in k)
    a = arrays[key].copy()
    a.reshape(-1).view(np.uint32)[0] ^= 1
    arrays[key] = a
    np.savez(npz_path, **arrays)
    return key


def snapshot_timings(spec, cfg):
    """Bytes of one main-path snapshot (K clients' private and proxy
    models with their Adam moments) and the ms to save it, verify its
    commitment chain and restore it (the verify included) on the card."""
    from repro_torch.checkpoint import FederationCheckpointer
    from repro_torch.core.engine import dml_engine

    eng = dml_engine((spec,) * MAIN_K, spec, cfg, device="cuda")
    state = eng.init_states(0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        ck = FederationCheckpointer(d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(eng, state, 0, seed=0)
        save_ms = (time.perf_counter() - t0) * 1e3
        n_bytes = os.path.getsize(os.path.join(d, "round_000001.npz"))
        t0 = time.perf_counter()
        ck.verify_chain(1)
        verify_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        restored, _ = ck.restore(eng, like=state, seed=0)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
    assert states_equal(state, restored), "the restored snapshot differs"
    return dict(bytes=n_bytes, save_ms=save_ms, verify_ms=verify_ms,
                restore_ms=restore_ms)


def resume_main(spec, data, test, cfg):
    """(a) The main path through ``run_federated`` on the vmap and the
    loop backends: an uninterrupted 3-round run, the same run killed after
    round 2 (a snapshot every round), its resume for round 3 under
    ``verify_commitments``: every leaf bit-equal, epsilon exact, the
    resumed part's launches those of one round; then one mantissa bit of
    a committed proxy leaf of the newest snapshot flipped, and the next
    resume refused naming the round and the leaf."""
    from repro_torch.core.baselines import run_federated
    from repro_torch.core.commit import CommitmentError

    K, per_client = len(data), data[0][0].shape[0]
    S = per_client // cfg.batch_size
    rcfg = dataclasses.replace(cfg, rounds=RESUME_ROUNDS)
    out = {}
    for backend in ("vmap", "loop"):
        # a round: S batched steps stacked, K·S client steps on the loop
        stacked = backend == "vmap"
        steps = S if stacked else K * S
        def run(c, **kw):
            return run_federated("proxyfl", [spec] * K, spec, data, test, c,
                                 seed=0, eval_every=c.rounds,
                                 backend=backend, device="cuda", **kw)

        full = run(rcfg)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as d:
            run(dataclasses.replace(rcfg, rounds=RESUME_KILL),
                checkpoint_dir=d, checkpoint_every=1)
            resumed, counts = counted(lambda: run(
                dataclasses.replace(rcfg, verify_commitments=True),
                checkpoint_dir=d, checkpoint_every=1, resume=True))
            expect(counts, **dp_launches(steps, stacked),
                   fused_pushsum_mix=1)
            assert all(torch.equal(a, b) for a, b in zip(
                all_leaves(full, "proxyfl"), all_leaves(resumed, "proxyfl"))
            ), f"{backend}: the resumed run differs"
            assert [c.w for c in full["clients"]] == [
                c.w for c in resumed["clients"]]
            assert full["epsilon"] == resumed["epsilon"] == \
                [EPSILON_3_ROUNDS] * K, (full["epsilon"], resumed["epsilon"])
            assert [h["round"] for h in resumed["history"]] == [3]
            newest = os.path.join(d, "proxyfl_s0", "round_000003.npz")
            key = flip_mantissa_bit(newest, "c0001/proxy/params/")
            leaf = key.split("c0001/", 1)[1]
            try:
                run(dataclasses.replace(rcfg, verify_commitments=True),
                    checkpoint_dir=d, resume=True)
            except CommitmentError as err:
                assert (err.round, err.client, err.leaf) == (3, 1, leaf), \
                    (err.round, err.client, err.leaf)
            else:
                raise AssertionError("the tampered snapshot was resumed")
        print(f"resume phase (a): proxyfl on {backend}, killed after round "
              f"{RESUME_KILL} of {RESUME_ROUNDS} and resumed with "
              f"verify_commitments: every leaf and w bit-equal, epsilon "
              f"{resumed['epsilon'][0]!r}; the resumed round's launches "
              f"{got_nonzero(counts)}; a flipped bit of {leaf} of client 1 "
              f"refused (CommitmentError, round 3)")
        out[backend] = counts
    return out


def engine_kill_and_resume(make, data, rounds: int, kill_after: int,
                           directory: str):
    """Engine-level kill and resume on the card: the uninterrupted run
    (its state after ``kill_after`` rounds kept), the killed run with a
    snapshot every round into ``directory``, and the resume, its rounds
    counted. Returns (state at the kill, final state, restored state,
    resumed final state, the resumed rounds' launches, the
    checkpointer)."""
    from repro_torch.checkpoint import FederationCheckpointer

    eng = make()
    state = eng.init_states(0)
    mid = None
    for t in range(rounds):
        state, _ = eng.run_round(state, data, t, 0)
        if t + 1 == kill_after:
            mid = clone(state)
    ck = FederationCheckpointer(directory)
    killed = make()
    st = killed.init_states(0)
    for t in range(kill_after):
        st, _ = killed.run_round(st, data, t, 0)
        ck.maybe_save(killed, st, t, seed=0)
    res = make()
    restored, start = ck.restore_latest(res, like=res.init_states(0), seed=0)
    assert start == kill_after
    restored = clone(restored)

    def finish():
        s = restored
        for t in range(start, rounds):
            s, _ = res.run_round(s, data, t, 0)
        return s

    final, counts = counted(finish)
    return mid, state, restored, final, counts, ck


def states_equal(a, b) -> bool:
    from repro_torch.nn.modules import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def resume_async(spec, data, cfg):
    """(b) Async τ = 2 on fig_async's protocol, 6 rounds, killed after
    round 3: the in-flight buffer restored bit for bit, the resumed rounds
    bit-equal, one stale mix a resumed round and nothing else."""
    from repro_torch.core.engine import dml_engine

    acfg = async_config(cfg)
    kill = acfg.rounds // 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as d:
        mid, full, restored, final, counts, _ = engine_kill_and_resume(
            lambda: dml_engine((spec,) * len(data), spec, acfg,
                               backend="async", device="cuda"),
            data, acfg.rounds, kill, d)
    for key in ("stale_theta", "stale_w"):
        assert torch.equal(restored[key], mid[key]), key
    assert float(restored["stale_w"].abs().sum()) > 0, "nothing in flight"
    assert states_equal(full, final), "the resumed async run differs"
    expect(counts, fused_stale_mix=acfg.rounds - kill)
    print(f"resume phase (b): async tau = {acfg.staleness}, killed after "
          f"round {kill} of {acfg.rounds}: the in-flight buffer "
          f"{tuple(restored['stale_theta'].shape)} restored bit for bit, "
          f"the resumed rounds bit-equal; launches {got_nonzero(counts)}")
    return counts


def resume_compressed(spec, data, cfg):
    """(c) Compressed int8 on the main set-up, 2 rounds, killed after
    round 1: the public copies restored bit for bit, the result bit-equal,
    the resumed round's DP launches and no mix; a resume under top-k
    refused by the fingerprint."""
    from repro_torch.core.accountant import PrivacyAccountant
    from repro_torch.core.engine import dml_engine

    K, per_client = len(data), data[0][0].shape[0]
    steps = per_client // cfg.batch_size     # stacked: a launch a step
    ccfg = dataclasses.replace(cfg, compress="int8")

    def make(c=ccfg):
        eng = dml_engine((spec,) * K, spec, c, device="cuda")
        eng.attach_accountants([PrivacyAccountant(
            1.0, cfg.batch_size / per_client, 1e-5) for _ in range(K)])
        return eng

    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as d:
        mid, full, restored, final, counts, ck = engine_kill_and_resume(
            make, data, 2, 1, d)
        assert torch.equal(restored["ef_state"], mid["ef_state"])
        assert states_equal(full, final), "the resumed int8 run differs"
        expect(counts, **dp_launches(steps))
        topk = make(dataclasses.replace(ccfg, compress="topk"))
        try:
            ck.restore_latest(topk, like=topk.init_states(0), seed=0)
        except ValueError as err:
            assert "fingerprint" in str(err), str(err)
        else:
            raise AssertionError("a top-k resume of an int8 run was taken")
    print(f"resume phase (c): int8, killed after round 1 of 2: the public "
          f"copies {tuple(restored['ef_state'].shape)} restored bit for "
          f"bit, the result bit-equal; launches {got_nonzero(counts)}; a "
          f"top-k resume refused by the fingerprint")
    return counts


def driver_lines(argv):
    """``launch/train.py``'s ``main(argv)``, its output kept and echoed."""
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train.main(argv) == 0
    text = buf.getvalue()
    print(text, end="")
    return text.splitlines()


def resume_train(card):
    """(d) The train driver at ``--preset 100m`` full width, K = 2, B = 8,
    S = 128, 2 rounds of 1 step: straight through, and killed after round
    1 then resumed through ``main([..., "--checkpoint-dir", d,
    "--resume"])``; the resumed run's round-2 snapshot equal leaf for leaf
    to the straight run's final state, its round line and epsilon equal,
    its launches one round's. Prints the snapshot's bytes and its save,
    verify and restore seconds; the directory goes at the end."""
    from repro_torch.checkpoint import FederationCheckpointer
    from repro_torch.checkpoint.ckpt import flatten_with_paths, host_array
    from repro_torch.launch import train

    argv = RESUME_TRAIN_ARGS + ["--rounds", "2"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run, full = train.train(train.parse_args(argv))
    print(buf.getvalue(), end="")
    straight = buf.getvalue().splitlines()
    round_line = next(l for l in straight if l.startswith("[round 2/2]"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as d:
        t0 = time.perf_counter()
        killed = driver_lines(RESUME_TRAIN_ARGS + [
            "--rounds", "1", "--checkpoint-dir", d])
        killed_s = time.perf_counter() - t0
        lines, counts = counted(lambda: driver_lines(argv + [
            "--checkpoint-dir", d, "--resume"]))
        expect(counts, **train_launches(run, steps=1, evals=1, mixes=1,
                                        stale=False))
        resumed_line = next(l for l in lines if l.startswith("[round 2/2]"))
        assert resumed_line.rsplit("(", 1)[0] == round_line.rsplit("(", 1)[0], \
            (resumed_line, round_line)
        assert f"eps={EPSILON_RESUME_TRAIN:.3f}" in resumed_line
        save_s = [float(re.search(r"in ([0-9.]+) s", l).group(1))
                  for l in killed + lines if l.startswith("[train] saved")]
        restore_s = float(re.search(
            r"restored in ([0-9.]+) s",
            next(l for l in lines if "resumed from" in l)).group(1))
        ck = FederationCheckpointer(d)
        assert ck.saved_rounds() == [1, 2]
        t0 = time.perf_counter()
        ck.verify_chain(2)
        verify_s = time.perf_counter() - t0
        n_bytes = os.path.getsize(os.path.join(d, "round_000002.npz"))
        want = flatten_with_paths(run.engine._ckpt_payload(full, 1, 0))
        with np.load(os.path.join(d, "round_000002.npz")) as z:
            assert sorted(z.files) == sorted(want), "snapshot keys differ"
            for key, leaf in want.items():
                a = host_array(leaf)
                b = z[key]
                assert a.dtype == b.dtype and a.shape == b.shape and \
                    a.tobytes() == b.tobytes(), key
    print(f"resume phase (d): {run.cfg.name} preset, K = {run.engine.K}, "
          f"killed after round 1 of 2 ({killed_s:.1f} s) and resumed "
          f"through main(--checkpoint-dir, --resume): the final state "
          f"bit-equal leaf for leaf, {resumed_line.split('] ')[1]}; "
          f"launches {got_nonzero(counts)}")
    print(f"resume phase (d): one snapshot {n_bytes:,} bytes "
          f"({n_bytes / 1e9:.3f} GB); save {' / '.join(f'{x:.3f}' for x in save_s)} "
          f"s, verify (chain + proxy digests) {verify_s:.3f} s, restore "
          f"(verify included) {restore_s:.3f} s on {card}")
    return dict(counts=counts, bytes=n_bytes, save_s=save_s,
                verify_s=verify_s, restore_s=restore_s)


def rel_norm_err(got, want) -> float:
    """||got − want|| / ||want|| over lists of tensors, in f64."""
    num = sum(float(((a.double() - b.double()) ** 2).sum())
              for a, b in zip(got, want))
    return (num / sum(float((b.double() ** 2).sum()) for b in want)) ** 0.5


# normwise grades of (e)'s f32 quantities: f32 accumulation in another
# order; bf16 moments: near-equal values rounded apart by one ulp at most
FALLBACK_NORM_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}


def dp_adam_fallback_check(spec, x, y, device="cuda"):
    """(e)'s first half: ``dp_adam_update`` on bf16 params (f32 master
    copy) with f32 and with bf16 moments, the fallback route (the rows
    kernels on the per-example gradients widened to f32, the noise add on
    ``scale_accumulate``'s 1-D route, then ``Adam.update``), from the same
    state and draws as two plain versions.

    The checked step is Adam's second, from a first step shared by all,
    so that the update is smooth in the gradient (a first step moves each
    coordinate by lr·sign(g)). Every leaf is held at bf16 2e-2 against
    the reference's plain path (``use_pallas=False``, which rounds each
    clipped gradient to the leaf's bf16). The f32 work of the kernels,
    p32' − p32 and the moments m and v, is held normwise at
    ``FALLBACK_NORM_TOL`` against the plain path that does the same
    arithmetic in f32 (``vectorized=True``: widened gradients, f32 scales,
    one contraction, no kernel). Two faulted versions of the latter, the
    noise dropped and the clip turned off (σC kept), must fail that
    grade: this is what the check can see. Returns, by moment dtype,
    (the launch counts, the worst bf16-grade abs error, the normwise
    errors of step, m and v, the faults' worst normwise errors)."""
    from repro_torch.core import dp
    from repro_torch.nn.losses import cross_entropy
    from repro_torch.nn.modules import tree_leaves, tree_map
    from repro_torch.optim import Adam

    params = tree_map(lambda a: a.to(torch.bfloat16).to(device),
                      spec.init(torch.Generator().manual_seed(5)))
    D = sum(a.numel() for a in tree_leaves(params))
    gen = torch.Generator(device=device).manual_seed(6)
    noise1, noise2 = (torch.randn((D,), generator=gen, device=device)
                      for _ in range(2))
    C, sigma, huge = 1.0, 1.0, 1e9

    def loss(p, b):
        return cross_entropy(spec.apply(tree_map(lambda a: a.float(), p),
                                        b[0]), b[1])

    def quantities(s, s1):
        return ([a - b for a, b in zip(tree_leaves(s.p32),
                                       tree_leaves(s1.p32))],
                tree_leaves(s.m), tree_leaves(s.v))

    out = {}
    for moments in ("float32", "bfloat16"):
        opt = Adam(lr=1e-3, weight_decay=1e-4, moment_dtype=moments)
        g1, _ = dp.dp_gradient(loss, params, (x, y), clip_norm=C,
                               noise_multiplier=sigma, noise=noise1)
        p1, s1 = opt.update(g1, opt.init(params), params)

        def plain(vectorized=True, **kw):
            g, _ = dp.dp_gradient(loss, p1, (x, y), use_pallas=False,
                                  vectorized=vectorized, **kw)
            return opt.update(g, s1, p1)

        kw = dict(clip_norm=C, noise_multiplier=sigma, noise=noise2)
        (p2, s2, _), counts = counted(lambda: dp.dp_adam_update(
            loss, p1, s1, (x, y), opt=opt, **kw))
        expect(counts, sumsq=1, scale_accumulate=2,
               **{"sumsq/rows": 1, "scale_accumulate/rows": 1,
                  "scale_accumulate/vector": 1})
        want_p, want_s = plain(vectorized=False, **kw)
        worst = 0.0
        for a, b in zip(tree_leaves((p2, s2)),
                        tree_leaves((want_p, want_s))):
            assert a.dtype == b.dtype
            worst = max(worst, check(f"dp_adam_update bf16/{moments}",
                                     a.float(), b.float(), torch.bfloat16))
        want_q = quantities(plain(**kw)[1], s1)
        errs = [rel_norm_err(g, w) for g, w in zip(quantities(s2, s1),
                                                    want_q)]
        tol = FALLBACK_NORM_TOL[moments]
        assert max(errs) <= tol, (moments, errs, tol)
        faults = {
            "noise dropped": plain(clip_norm=C, noise_multiplier=sigma,
                                   noise=torch.zeros_like(noise2)),
            "clip off": plain(clip_norm=huge, noise_multiplier=sigma * C
                              / huge, noise=noise2)}
        fault_errs = {}
        for name, (_, fs) in faults.items():
            fault_errs[name] = max(rel_norm_err(g, w) for g, w in zip(
                quantities(fs, s1), want_q))
            assert fault_errs[name] > tol, (moments, name, fault_errs)
        out[moments] = (counts, worst, errs, fault_errs)
    return out


def resume_kernels(spec, data, cfg):
    """(e) ``dp_adam_update`` on bf16 params at the mlp proxy's width
    (:func:`dp_adam_fallback_check`), launches pinned; ``gossip_proxies``
    of the main cohort against the plain mix at f32 2e-5, one mix
    launch."""
    from repro_torch.core import protocol
    from repro_torch.core.engine import dml_engine
    from repro_torch.nn.modules import tree_leaves

    x, y = data[0][0][:MAIN_B], data[0][1][:MAIN_B]
    checked = dp_adam_fallback_check(spec, x, y)
    counts = {}
    for moments, (c, worst, errs, fault_errs) in checked.items():
        counts = {k: counts.get(k, 0) + v for k, v in c.items()}
        print(f"resume phase (e): dp_adam_update on bf16 params (D = "
              f"{MAIN_D:,}, B = {MAIN_B}, f32 master copy, {moments} "
              f"moments), Adam's 2nd step against its plain version: max "
              f"abs err {worst:.3e} (bf16 2e-2); normwise p32 step / m / v "
              f"{' / '.join(f'{e:.3e}' for e in errs)} (grade "
              f"{FALLBACK_NORM_TOL[moments]:.3e}); faulted plain versions "
              + ", ".join(f"{k} {v:.3e}" for k, v in fault_errs.items())
              + f" (must exceed the grade); launches {got_nonzero(c)}")

    # gossip_proxies over the main cohort's initial clients, w not all 1
    eng = dml_engine((spec,) * MAIN_K, spec, cfg, device="cuda")

    def cohort():
        return [protocol.ClientState(
            s["private"]["params"], s["private"]["opt"],
            s["proxy"]["params"], s["proxy"]["opt"], 1.0 + 0.125 * k)
            for k, s in enumerate(eng.init_states(0))]

    kernel_clients, plain_clients = cohort(), cohort()
    _, mix_counts = counted(lambda: protocol.gossip_proxies(
        kernel_clients, 1, cfg))
    expect(mix_counts, fused_pushsum_mix=1)
    protocol.gossip_proxies(plain_clients, 1,
                            dataclasses.replace(cfg, use_pallas=False))
    worst_mix = 0.0
    for a, b in zip(kernel_clients, plain_clients):
        for u, v in zip(tree_leaves(a.proxy_params),
                        tree_leaves(b.proxy_params)):
            worst_mix = max(worst_mix, check("gossip_proxies", u, v,
                                             torch.float32))
        assert abs(a.w - b.w) <= 2e-5 * (1 + abs(b.w)), (a.w, b.w)
    print(f"resume phase (e): gossip_proxies of {MAIN_K} proxies (D = "
          f"{MAIN_D:,}) against the plain mix: max abs err "
          f"{worst_mix:.3e} (f32 2e-5); launches {got_nonzero(mix_counts)}")
    return {"bf16 dp_adam_update": counts, "gossip_proxies": mix_counts}


def resume_path(setup, card):
    """The resume phase (module docstring, 11)."""
    spec, data, test, cfg = setup
    t0 = time.perf_counter()
    timings = snapshot_timings(spec, cfg)
    print(f"resume phase: one main-path snapshot ({MAIN_K} clients, "
          f"private and proxy mlp with Adam moments) {timings['bytes']:,} "
          f"bytes ({timings['bytes'] / 1e6:.3f} MB): save "
          f"{timings['save_ms']:.3f} ms, verify {timings['verify_ms']:.3f} "
          f"ms, restore (verify included) {timings['restore_ms']:.3f} ms on "
          f"{card}")
    main_counts = resume_main(spec, data, test, cfg)
    res = {"vmap resume": main_counts["vmap"],
           "loop resume": main_counts["loop"],
           "async resume": resume_async(spec, data, cfg),
           "int8 resume": resume_compressed(spec, data, cfg)}
    trained = resume_train(card)
    res["preset resume"] = trained["counts"]
    res.update(resume_kernels(spec, data, cfg))
    print(f"resume phase: {time.perf_counter() - t0:.1f} s")
    return res


# ---------------------------------------------------------------------------
# the hier backend: the two-level factored exchange on the shard-grid mix


def client_leaves(result):
    """Every param and Adam moment of every client of a ProxyFL
    ``run_federated`` result, in client order, then the de-bias weights."""
    from repro_torch.nn.modules import tree_leaves
    leaves = [leaf for c in result["clients"]
              for role in ("private", "proxy")
              for tree in (getattr(c, f"{role}_params"),
                           getattr(c, f"{role}_opt").m,
                           getattr(c, f"{role}_opt").v)
              for leaf in tree_leaves(tree)]
    return leaves, [c.w for c in result["clients"]]


def hier_main(spec, data, test, cfg, card):
    """(a) ``run_federated("proxyfl", backend="hier")`` on the main set-up,
    2 rounds, at each of HIER_SHARDS, without and with §3.4 dropout: every
    param, moment, w and epsilon bit-equal to the vmap run's (P's entries
    are 0, ½ and 1 and each client has at most one cross-shard in-edge, so
    each factored row rounds once, as the flat one does); the launches
    exact: one clip pair and one Adam step a batched step of the cohort
    (dropped clients are masked, not skipped), and a round's one
    shard-grid mix (S > 1) or flat mix (S = 1)."""
    from repro_torch.core.baselines import run_federated

    K = len(data)
    per_client = data[0][0].shape[0] // cfg.batch_size
    out = {}
    for rate in (0.0, HIER_DROPOUT):
        dcfg = dataclasses.replace(cfg, dropout_rate=rate)
        steps = dcfg.rounds * per_client
        flat = run_federated("proxyfl", [spec] * K, spec, data, test, dcfg,
                             seed=0, eval_every=dcfg.rounds, backend="vmap",
                             device="cuda")
        flat_leaves, flat_w = client_leaves(flat)
        for S in HIER_SHARDS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, counts = counted(lambda: run_federated(
                "proxyfl", [spec] * K, spec, data, test, dcfg, seed=0,
                eval_every=dcfg.rounds, backend="hier", n_shards=S,
                device="cuda"))
            seconds = time.perf_counter() - t0
            mix = "fused_pushsum_mix_blocks" if S > 1 else \
                "fused_pushsum_mix"
            expect(counts, **dp_launches(steps), **{mix: dcfg.rounds})
            leaves, w = client_leaves(res)
            assert len(leaves) == len(flat_leaves)
            assert all(torch.equal(a, b) for a, b in zip(leaves,
                                                         flat_leaves)), \
                f"hier S={S} dropout {rate} differs from vmap"
            assert w == flat_w and res["epsilon"] == flat["epsilon"]
            if not rate:
                assert all(e == EPSILON_2_ROUNDS for e in res["epsilon"])
            label = f"S={S}" + (f" dropout {rate}" if rate else "")
            out[label] = dict(counts=counts, rate=dcfg.rounds / seconds)
            print(f"hier phase (a): {label}, {dcfg.rounds} rounds: every "
                  f"one of {len(leaves)} params and moments, w and epsilon "
                  f"{res['epsilon'][0]!r} bit-equal to vmap; launches "
                  f"{got_nonzero(counts)}; {dcfg.rounds / seconds:.4f} "
                  f"rounds/s (evaluation included) on {card}")
    return out


def hier_stale(spec, data, cfg, card):
    """(b) hier τ = 2, S = 2 on fig_async's protocol, 6 rounds: with DP
    on, one shard-grid mix a round and the DP launches, epsilon vmap's;
    with lr 0 and dropout 0.25, the mass of the clients plus the
    cross-shard buffer conserved every round; killed after round 3 and
    resumed, the buffer restored and the rounds bit-equal; the reference's
    refusals at S > 1 (dense mean, ring at τ > 0, compression)."""
    from repro_torch.configs import DPConfig
    from repro_torch.core.baselines import run_federated
    from repro_torch.core.engine import dml_engine
    from repro_torch.nn.modules import tree_flatten_vector

    K = len(data)
    acfg = dataclasses.replace(async_config(cfg), n_shards=HIER_STALE_S)
    dpcfg = dataclasses.replace(acfg, dp=cfg.dp)
    steps = dpcfg.rounds * dpcfg.local_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, counts = counted(lambda: run_federated(
        "proxyfl", [spec] * K, spec, data, data[0], dpcfg, seed=0,
        eval_every=dpcfg.rounds, backend="hier", device="cuda"))
    seconds = time.perf_counter() - t0
    expect(counts, **dp_launches(steps),
           fused_pushsum_mix_blocks=dpcfg.rounds)
    flat = run_federated("proxyfl", [spec] * K, spec, data, data[0], dpcfg,
                         seed=0, eval_every=dpcfg.rounds, backend="vmap",
                         device="cuda")
    assert res["epsilon"] == flat["epsilon"], (res["epsilon"],
                                               flat["epsilon"])
    leaves, w = client_leaves(res)
    assert all(bool(torch.isfinite(x).all()) for x in leaves)
    assert all(0.0 < v for v in w), w
    print(f"hier phase (b): tau = {dpcfg.staleness}, S = "
          f"{dpcfg.n_shards}, DP on, {dpcfg.rounds} rounds: launches "
          f"{got_nonzero(counts)}; epsilon {res['epsilon'][0]!r} = vmap's; "
          f"{dpcfg.rounds / seconds:.4f} rounds/s (evaluation included) on "
          f"{card}")

    mcfg = dataclasses.replace(acfg, lr=0.0, dropout_rate=HIER_DROPOUT)
    eng = dml_engine((spec,) * K, spec, mcfg, backend="hier", device="cuda")
    state = eng.init_states(0)

    def masses(st):
        z = torch.stack([tree_flatten_vector(c["proxy"]["params"])
                         for c in st["clients"]]).double()
        ws = torch.stack([c["w"] for c in st["clients"]]).double()
        return (float((z * ws[:, None]).sum() + st["hier_buffer"].sum()),
                float(ws.sum() + st["hier_w"].sum()))

    theta0, w0 = masses(state)
    assert w0 == K, w0
    worst = (0.0, 0.0)
    for t in range(mcfg.rounds):
        state, _ = eng.run_round(state, data, t, seed=0)
        theta_m, w_m = masses(state)
        rel = (abs(theta_m - theta0) / abs(theta0), abs(w_m - K) / K)
        assert rel[0] <= 1e-5 and rel[1] <= 1e-6, (t, theta_m, theta0, w_m)
        worst = (max(worst[0], rel[0]), max(worst[1], rel[1]))
    assert float(state["hier_w"].sum()) > 0, "no cross-shard mail in flight"
    print(f"hier phase (b): lr 0, dropout {HIER_DROPOUT}, {mcfg.rounds} "
          f"rounds: largest relative drift of theta-mass (clients plus "
          f"buffer) {worst[0]:.3e}, of w-mass {worst[1]:.3e}")

    kill = acfg.rounds // 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hier_") as d:
        mid, full, restored, final, resumed, _ = engine_kill_and_resume(
            lambda: dml_engine((spec,) * K, spec, acfg, backend="hier",
                               device="cuda"), data, acfg.rounds, kill, d)
    for key in ("hier_buffer", "hier_w"):
        assert torch.equal(restored[key], mid[key]), key
    assert float(restored["hier_w"].abs().sum()) > 0, "nothing in flight"
    assert states_equal(full, final), "the resumed hier run differs"
    expect(resumed, fused_pushsum_mix_blocks=acfg.rounds - kill)
    print(f"hier phase (b): killed after round {kill} of {acfg.rounds}: "
          f"the cross-shard buffer {tuple(restored['hier_buffer'].shape)} "
          f"restored bit for bit, the resumed rounds bit-equal; launches "
          f"{got_nonzero(resumed)}")

    refusals = {"mean": (dict(), "mean", "dense mixing"),
                "ring tau > 0": (dict(), "ring", "staleness>0"),
                "compressed": (dict(compress="topk"), "pushsum",
                               "compressed gossip")}
    for label, (knobs, mix, text) in refusals.items():
        try:
            dml_engine((spec,) * K, spec, dataclasses.replace(acfg, **knobs),
                       backend="hier", mix=mix, device="cuda")
        except ValueError as e:
            assert text in str(e), (label, e)
        else:
            raise AssertionError(f"hier with {label} was not refused")
    print(f"hier phase (b): refused at S = {acfg.n_shards}: "
          f"{', '.join(refusals)}")
    return {"stale DP": counts, "stale resume": resumed}


def hier_train(card):
    """(d) the train driver's preset, K = 4, 2 rounds of 1 step, on
    ``--backend hier --n-shards 2``: every leaf and w equal to the
    ``--backend vmap`` run's, epsilon too, one shard-grid mix a round;
    then ``--staleness 2`` for 3 rounds, launches pinned."""
    from repro_torch.launch import train

    base = TRAIN_ARGS + ["--steps-per-round", "1"]
    hier = ["--backend", "hier", "--n-shards", "2"]

    def args_of(extra, rounds):
        return train.parse_args(base + extra + ["--rounds", str(rounds)])

    vmap_args = args_of([], HIER_TRAIN_ROUNDS)
    run = train.setup(vmap_args)
    K = vmap_args.clients

    def engine(args):
        fl = dataclasses.replace(run.fl, n_shards=args.n_shards,
                                 staleness=args.staleness)
        return train.make_engine(run.cfg, run.proxy, fl, args, run.n_seqs,
                                 "cuda")

    out = {}
    flat_eng = engine(vmap_args)
    flat_state = train_drive(flat_eng, run, vmap_args)[0]
    flat_eps = [a.epsilon() for a in flat_eng.accountants]
    # one captured preset engine on the card at a time: each graph holds
    # its memory pool
    del flat_eng
    free_engines()
    for tau, rounds in ((0, HIER_TRAIN_ROUNDS), (TRAIN_TAU,
                                                 HIER_TRAIN_STALE_ROUNDS)):
        args = args_of(hier + ["--staleness", str(tau)], rounds)
        eng = engine(args)
        # at τ > 0 the state is the wrapper with the empty buffer
        start = run if not tau else run._replace(
            state=eng.init_states(args.seed))
        (state, rows, ppls, wall), got = counted(
            lambda: train_drive(eng, start, args))
        want = train_launches(run, rounds, rounds, rounds, stale=False)
        want["fused_pushsum_mix_blocks"] = want.pop("fused_pushsum_mix")
        expect(got, **want)
        assert all(np.isfinite(m["proxy_loss"]).all() for m in rows)
        if tau:
            assert tuple(state["hier_buffer"].shape) == (tau, K, TRAIN_D)
            assert float(state["hier_w"].sum()) > 0
            what = (f"the cross-shard buffer "
                    f"{tuple(state['hier_buffer'].shape)} in the state")
        else:
            assert states_equal(state, flat_state), \
                "the hier train run differs from vmap's"
            assert [a.epsilon() for a in eng.accountants] == flat_eps
            what = "every leaf and w equal to --backend vmap's, epsilon too"
        label = f"preset hier tau={tau}"
        out[label] = got
        print(f"hier phase (d): {label}, {rounds} rounds of 1 step: {what}; "
              f"launches {got_nonzero(got)}; {rounds / wall:.4f} rounds/s "
              f"(evaluation included) on {card}")
        del eng, state
        free_engines()
    return out


def hier_drivers(card):
    """(e) ``fig_hier``'s rows at K = 8 and 64 and ``fig_kernels``' at K =
    8 on the card, each row printed; their JSON in ``chiprun_out/``."""
    from repro_torch.benchmarks import fig_hier, fig_kernels

    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    runs = (("REPRO_BENCH_HIER_JSON", "fig_hier.json",
             lambda: fig_hier.run(False, "cuda", clients=(8, HIER_FIG_K),
                                  rounds=HIER_FIG_ROUNDS)),
            ("REPRO_BENCH_KERNELS_JSON", "fig_kernels.json",
             lambda: fig_kernels.run(False, "cuda", clients=(MAIN_K,))))
    rows = {}
    for env, name, fn in runs:
        old = os.environ.get(env)
        os.environ[env] = str(out / name)
        try:
            rows[name] = fn()
        finally:
            if old is None:
                del os.environ[env]
            else:
                os.environ[env] = old
        for r in rows[name]:
            assert r["card"] == card, (r["card"], card)
            print(f"hier phase (e): {name[:-5]} {json.dumps(r)}")
    hier = [r for r in rows["fig_hier.json"] if r["backend"] == "hier"]
    assert all(r["bytes_cross_per_client"] > 0 for r in hier)
    return rows


# ---------------------------------------------------------------------------
# the stacked phase: the stacked executor, its captured round and blocks


STACKED_RATE_ROUNDS = 8    # rounds of each timed block
# coordinates of the params and Adam moments of a stacked step allowed
# past ``close`` against its per-client twin: ReLU near-ties (Lockstep).
# On the H100: 12 of 76,492,876 param and moment coordinates (1.6e-7) on
# the main set-up's 2 rounds, 0 of 52,874,193 on table 2's cohort; the
# budget is about 3x the first. A client-grid Adam that leaves the last
# coordinate of each client's row as it was puts 1.8e-6 past ``close``,
# one client's clip scales 1% off 6.9e-6 (the mlp at D 199,210, K 4,
# B 16, 2 rounds, plain versions on the CPU): both fail it.
OUTLIERS_PER_COORD = 5e-7


def relu_ties(stacked, batch) -> int:
    """ReLUs of an mlp step that fire on one path and not on the other:
    both hidden layers' pre-activations of every client's batch formed
    batched over the cohort (as the stacked step forms them) and client by
    client (as the loop does), for the private and the proxy model; the
    count of sign changes (0 for a model that is not an mlp)."""
    from torch.func import vmap
    if not isinstance(batch, (tuple, list)):
        return 0   # an LLM batch: no ReLU
    K = batch[0].shape[0]
    x = batch[0].reshape(K, batch[0].shape[1], -1)
    flips = 0
    for role in ("private", "proxy"):
        p = stacked.get(role, {}).get("params", {})
        if not {"fc1", "fc2"} <= set(p) or p["fc1"]["w"].shape[1] != \
                x.shape[-1]:
            continue   # not an mlp on the flat input
        hs, hl = x, x
        for layer in ("fc1", "fc2"):
            w, b = p[layer]["w"], p[layer]["b"]
            zs = vmap(lambda h, w, b: h @ w + b)(hs, w, b)
            zl = torch.stack([hl[k] @ w[k] + b[k] for k in range(K)])
            flips += int(((zs > 0) != (zl > 0)).sum())
            hs, hl = torch.relu(zs), torch.relu(zl)
    return flips


def stacked_engine(spec, cfg, K, backend="vmap", eager=False):
    """A ProxyFL engine of the main set-up on the card with DP
    accountants, run eagerly when asked."""
    from repro_torch.core.accountant import PrivacyAccountant
    from repro_torch.core.engine import dml_engine
    eng = dml_engine((spec,) * K, spec, cfg, backend=backend, device="cuda")
    if eager:
        eng._eager_stacked = True
    if cfg.dp.enabled:
        eng.attach_accountants([PrivacyAccountant(
            cfg.dp.noise_multiplier, cfg.batch_size / MAIN_PER_CLIENT,
            cfg.dp.delta)
            for _ in range(K)])
    return eng


def blocks_of(make, data, rounds: int, block: int):
    """A fresh engine's state after ``rounds`` rounds in blocks of
    ``block``, and the engine."""
    from repro_torch.core.engine import block_spans
    eng = make()
    state = eng.init_states(0)
    for t, n in block_spans(0, rounds, block):
        state, _ = eng.run_rounds(state, data, t, n, 0)
    return state, eng


def rounds_per_s(eng, data, rounds: int = STACKED_RATE_ROUNDS) -> float:
    """Rounds/s of ``rounds`` rounds as one block, after two warm-up
    rounds (on the captured path the eager first round and the capture),
    evaluation excluded."""
    state = eng.init_states(0)
    state, _ = eng.run_rounds(state, data, 0, 2, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_rounds(state, data, 2, rounds, 0)
    torch.cuda.synchronize()
    return rounds / (time.perf_counter() - t0)


def stacked_main(spec, data, cfg, card):
    """(a)-(e) of the stacked phase on the main set-up."""
    from repro_torch.nn.modules import tree_leaves

    K = len(data)
    S = data[0][0].shape[0] // cfg.batch_size
    out = {}
    # (a) a 2-round block captured: launches exact, replays counted
    eng = stacked_engine(spec, cfg, K)
    state0 = eng.init_states(0)
    (cap, metrics), counts = counted(
        lambda: eng.run_rounds(state0, data, 0, 2, 0))
    expect(counts, **dp_launches(2 * S), fused_pushsum_mix=2)
    assert all(a.epsilon() == EPSILON_2_ROUNDS for a in eng.accountants)
    assert all(v.shape == (2, K) and np.isfinite(v).all()
               for v in metrics.values()), metrics
    out["counts"] = counts
    # (b) the same block eager: bit-equal predicted, the difference printed
    eager, _ = stacked_engine(spec, cfg, K, eager=True).run_rounds(
        state0, data, 0, 2, 0)
    diff = max(max_err(a, b) for a, b in zip(tree_leaves(cap),
                                             tree_leaves(eager)))
    for a, b in zip(tree_leaves(cap), tree_leaves(eager)):
        torch.testing.assert_close(a, b, **CLOSE)
    print(f"stacked: captured round against eager, 2 rounds: max abs diff "
          f"{diff:.3e} ({'bit-equal' if states_equal(cap, eager) else 'not bit-equal'})")
    out["captured_vs_eager"] = diff
    # (c) blocks of 1, 2 and all 4 rounds bit-equal
    finals = [blocks_of(lambda: stacked_engine(spec, cfg, K), data, 4, b)[0]
              for b in (1, 2, 4)]
    assert states_equal(finals[0], finals[1]) and \
        states_equal(finals[0], finals[2]), "a block size changed the run"
    # another dataset of the same shapes (the clients in reverse) replays
    # the same graph, its data reloaded: as the eager round on it
    e = stacked_engine(spec, cfg, K)
    st, _ = e.run_rounds(e.init_states(0), data, 0, 2, 0)
    other = data[::-1]
    got, _ = e.run_rounds(st, other, 2, 2, 0)
    want, _ = stacked_engine(spec, cfg, K, eager=True).run_rounds(
        st, other, 2, 2, 0)
    assert len(e._graphs) == 1, len(e._graphs)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a, b, **CLOSE)
    print("stacked: a second dataset of the same shapes replays the one "
          "captured round, its data reloaded: "
          f"{'bit-equal' if states_equal(got, want) else 'close'} to the "
          "eager rounds on it")
    # (d) each batched step against the loop's kernel steps, client by
    # client, on the same state, batch and noise
    with Lockstep(against="loop") as lock:
        e = stacked_engine(spec, cfg, K)
        e.run_rounds(e.init_states(0), data, 0, 2, 0)
    lock.check(2 * S * K)
    print(f"stacked: blocks of 1 / 2 / 4 rounds bit-equal; each of "
          f"{lock.steps} client steps of the stacked rounds against the "
          f"loop's from the same state: max abs diff {lock.worst:.3e} "
          f"(close grade; in first Adam steps {lock.eps_masked} param "
          f"coordinates at |g| < 100 eps masked, {lock.eps_past} of them "
          f"past close; {lock.outliers} of {lock.coords:,} param and moment "
          f"coordinates past close; {lock.ties} hidden ReLUs of the steps' "
          "batches fire on one path only); epsilon after 2 rounds "
          f"{eng.accountants[0].epsilon()!r}")
    out["lockstep"] = lock.worst
    # (e) rounds/s: the loop, the stacked round eager and captured
    rates = {"loop": rounds_per_s(stacked_engine(spec, cfg, K, "loop"),
                                  data),
             "eager": rounds_per_s(stacked_engine(spec, cfg, K, eager=True),
                                   data),
             "captured": rounds_per_s(stacked_engine(spec, cfg, K), data)}
    out["rates"] = rates
    # a block of captured rounds under the profiler: the device's busy
    # share, and one round alone (the host's draws not overlapped)
    e = stacked_engine(spec, cfg, K)
    st, _ = e.run_rounds(e.init_states(0), data, 0, 2, 0)
    busy = {}
    for T in (1, 4):
        wall_ms, on_device = device_profile(
            lambda T=T: e.run_rounds(st, data, 2, T, 0))
        busy_ms = sum(ev.self_device_time_total for ev in on_device) / 1e3
        busy[T] = (busy_ms, wall_ms, len(on_device))
    out["busy"] = busy
    by_kernel = {k: us for k, (_, us)   # the block of 4
                 in kernel_times(on_device).items()}
    print("stacked: device us a captured round by kernel (a block of 4 "
          "rounds / 4): " + ", ".join(
              f"{n} {t / 4:.3f}" for n, t in sorted(
                  by_kernel.items(), key=lambda kv: -kv[1])[:12]))
    print(f"stacked: rounds/s (evaluation excluded, {STACKED_RATE_ROUNDS} "
          f"rounds as one block) loop {rates['loop']:.4f}, eager stacked "
          f"{rates['eager']:.4f}, captured {rates['captured']:.4f}; "
          "captured under the profiler: " + "; ".join(
              f"a block of {T} round(s) wall {w:.3f} ms, device busy "
              f"{b:.3f} ms ({100 * b / w:.2f}%), {n} device kernels and "
              "copies" for T, (b, w, n) in busy.items()) + f", on {card}")
    return out


def stacked_ragged(card):
    """(f) Table 2's ragged cnn1 cohort in epoch mode, one round: each
    batched step against the loop's kernel steps, launches S = max n_k //
    B a round, epsilon each client's own."""
    from repro_torch.benchmarks import common, table2_histo
    from repro_torch.core.accountant import epsilon_for
    from repro_torch.core.baselines import run_federated

    conf = table2_histo.configuration(True)
    for key in ("methods", "seeds", "rounds"):
        conf.pop(key)
    data, test, priv, prox, cfg = common.method_setup(
        conf.pop("dataset"), conf.pop("n_clients"), 0, rounds=1,
        device="cuda", **conf)
    K, B = len(data), cfg.batch_size
    sizes = [x.shape[0] for x, _ in data]
    S = max(max(1, n // B) for n in sizes)
    res, counts = counted(lambda: run_federated(
        "proxyfl", [priv] * K, prox, data, test, cfg, seed=0, eval_every=1,
        device="cuda"))
    expect(counts, **dp_launches(S), fused_pushsum_mix=1)
    want = [epsilon_for(noise_multiplier=cfg.dp.noise_multiplier,
                        sample_rate=min(1.0, B / n), steps=max(1, n // B),
                        delta=cfg.dp.delta) for n in sizes]
    assert res["epsilon"] == want, (res["epsilon"], want)
    with Lockstep(against="loop") as lock:
        run_federated("proxyfl", [priv] * K, prox, data, test, cfg, seed=0,
                      eval_every=1, device="cuda")
    lock.check(S * K)
    print(f"stacked: table 2's cohort (sizes {sizes}, B {B}) in epoch mode: "
          f"{S} batched steps a round (the loop: "
          f"{sum(max(1, n // B) for n in sizes)}"
          f" client steps); each of {lock.steps} client steps against the "
          f"loop's: max abs diff {lock.worst:.3e} (close grade; "
          f"{lock.eps_masked} first-Adam-step coordinates masked, "
          f"{lock.eps_past} past close; {lock.outliers} of "
          f"{lock.coords:,} param and moment coordinates past close) on "
          f"{card}")
    return dict(counts=counts, lockstep=lock.worst, steps=S)


def stacked_async_hier(spec, data, cfg):
    """(g) async τ = 2 on fig_async's protocol and hier S = 2 on the main
    set-up, stacked and captured: 4 rounds as blocks of 1 and of 4
    bit-equal, launches exact (a stale mix a round; 4 / 4 / 4 DP launches
    and a shard-grid mix a round)."""
    K, out = len(data), {}
    acfg = async_config(cfg)
    hcfg = dataclasses.replace(cfg, n_shards=2)
    for name, backend, c, mixes in (
            ("async", "async", acfg, {"fused_stale_mix": 4}),
            ("hier", "hier", hcfg, {"fused_pushsum_mix_blocks": 4,
                                    **dp_launches(4 * 4)})):
        def make(c=c, backend=backend):
            return stacked_engine(spec, c, K, backend)
        one, _ = blocks_of(make, data, 4, 1)
        (whole, _), counts = counted(lambda: blocks_of(make, data, 4, 4))
        assert states_equal(one, whole), f"{name}: blocks differ"
        expect(counts, **mixes)
        out[name] = counts
        print(f"stacked: {name} 4 rounds, blocks of 1 and 4 bit-equal; "
              f"launches {dict((k, v) for k, v in counts.items() if v)}")
    return out


def stacked_resume(spec, data, test, cfg):
    """(h) ``run_federated(rounds_per_block=2)``, 4 rounds, a snapshot
    every 2: killed after round 2 and resumed, bit-equal to the straight
    run and to the per-round run."""
    from repro_torch.core.baselines import run_federated
    from repro_torch.nn.modules import tree_leaves
    K = len(data)
    c4 = dataclasses.replace(cfg, rounds=4)

    def run(c, **kw):
        res = run_federated("proxyfl", [spec] * K, spec, data, test, c,
                            seed=0, eval_every=2, device="cuda", **kw)
        return [leaf for cl in res["clients"] for leaf in tree_leaves(
            (cl.private_params, cl.proxy_params))], res["epsilon"]

    straight, eps = run(c4, rounds_per_block=2)
    per_round, _ = run(c4, rounds_per_block=1)
    with tempfile.TemporaryDirectory() as d:
        run(dataclasses.replace(cfg, rounds=2), rounds_per_block=2,
            checkpoint_dir=d, checkpoint_every=2)
        resumed, eps2 = run(c4, rounds_per_block=2, checkpoint_dir=d,
                            checkpoint_every=2, resume=True)
    assert all(torch.equal(a, b) for a, b in zip(straight, per_round))
    assert all(torch.equal(a, b) for a, b in zip(straight, resumed))
    assert eps == eps2
    print("stacked: run_federated in blocks of 2, killed after round 2 and "
          "resumed at the block edge: bit-equal to the straight run and to "
          "the per-round run")


def stacked_path(setup, card):
    """The stacked phase (module docstring, 13)."""
    spec, data, test, cfg = setup
    t0 = time.perf_counter()
    res = {"main": stacked_main(spec, data, cfg, card)}
    res["ragged"] = stacked_ragged(card)
    res["async_hier"] = stacked_async_hier(spec, data, cfg)
    stacked_resume(spec, data, test, cfg)
    print(f"stacked phase: {time.perf_counter() - t0:.1f} s")
    return res


def hier_path(setup, card):
    """The hier phase (module docstring, 12)."""
    spec, data, test, cfg = setup
    t0 = time.perf_counter()
    res = {"main": hier_main(spec, data, test, cfg, card)}
    res["stale"] = hier_stale(spec, data, cfg, card)
    res["train"] = hier_train(card)
    res["drivers"] = hier_drivers(card)
    print(f"hier phase: {time.perf_counter() - t0:.1f} s")
    return res


# ---------------------------------------------------------------------------
# the shard_map phase: the backend on torch.distributed, one rank a card


SHARD_ROUNDS, SHARD_BLOCK = 2, 4     # (a): 2 rounds, then one block of 4
SHARD_HIER_ROUNDS, SHARD_HIER_L = 3, 4   # (b): 1 pod of 4 clients


def shard_group():
    """An in-process NCCL group over a FileStore in a temporary directory
    at world size = the card count, and its 1-D meshes over ``"clients"``
    (the engine's axis) and ``"pod"`` (the round programs'). Returns
    (clients mesh, pod mesh, the directory)."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = torch.cuda.device_count()
    assert world == 1, ("the shard_map phase runs its group in this "
                        f"process: one rank, one card ({world} present)")
    tmp = tempfile.mkdtemp(prefix="shard_map_")
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=0, world_size=world, device_id=torch.device("cuda", 0))
    assert dist.get_backend() == "nccl"
    return (init_device_mesh("cuda", (world,), mesh_dim_names=("clients",)),
            init_device_mesh("cuda", (world,), mesh_dim_names=("pod",)), tmp)


def shard_engine(spec, cfg, backend, mesh):
    """One client of the main set-up on ``backend`` (vmap, or shard_map
    on ``mesh``) with a DP accountant."""
    from repro_torch.core.accountant import PrivacyAccountant
    from repro_torch.core.engine import dml_engine
    eng = dml_engine((spec,), spec, cfg, backend=backend, device="cuda",
                     mesh=mesh if backend == "shard_map" else None)
    eng.attach_accountants([PrivacyAccountant(
        cfg.dp.noise_multiplier, cfg.batch_size / MAIN_PER_CLIENT,
        cfg.dp.delta)])
    return eng


def snapshot_files_equal(a: str, b: str, rounds_done: int) -> None:
    """Two checkpoint directories hold the same snapshot: every npz array
    equal in dtype, shape and bytes, the manifest, the audit trail and
    LATEST byte for byte."""
    base = f"round_{rounds_done:06d}"
    with np.load(os.path.join(a, base + ".npz")) as x, \
            np.load(os.path.join(b, base + ".npz")) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype and x[k].tobytes() == \
                y[k].tobytes(), k
    for name in (base + ".json", "audit.jsonl", "LATEST"):
        with open(os.path.join(a, name), "rb") as f, \
                open(os.path.join(b, name), "rb") as g:
            assert f.read() == g.read(), name


def shard_main(spec, data, cfg, mesh, tmp, card):
    """(a) the main set-up at K = 1 on shard_map against vmap: 2 rounds and
    a block of 4 bit-equal, DP launches exact, snapshots byte-equal and
    restored across the backends, rounds/s and the busy share."""
    from repro_torch.checkpoint import FederationCheckpointer
    from repro_torch.core.engine import dml_engine

    cfg1 = dataclasses.replace(cfg, n_clients=1)
    data1 = data[:1]
    S = MAIN_PER_CLIENT // cfg.batch_size
    out, finals = {}, {}
    for backend in ("shard_map", "vmap"):
        eng = shard_engine(spec, cfg1, backend, mesh)
        assert eng.device.type == "cuda" and not eng.mixing

        def drive():
            state, rows = eng.init_states(0), []
            for t in range(SHARD_ROUNDS):
                state, m = eng.run_round(state, data1, t, 0)
                rows.append(m)
            state, m = eng.run_rounds(state, data1, SHARD_ROUNDS,
                                      SHARD_BLOCK, 0)
            return state, rows + [m]

        (state, rows), counts = counted(drive)
        expect(counts, **dp_launches((SHARD_ROUNDS + SHARD_BLOCK) * S))
        assert all(np.isfinite(v).all() for m in rows for v in m.values())
        d = os.path.join(tmp, backend)
        FederationCheckpointer(d).save(eng, state,
                                       SHARD_ROUNDS + SHARD_BLOCK - 1, seed=0)
        finals[backend] = (state, rows, [a.epsilon()
                                         for a in eng.accountants], d)
        out[f"{backend} {SHARD_ROUNDS}+{SHARD_BLOCK} rounds"] = counts
        del eng
    (s_state, s_rows, s_eps, s_dir), (v_state, v_rows, v_eps, v_dir) = (
        finals["shard_map"], finals["vmap"])
    assert states_equal(s_state, v_state), "shard_map differs from vmap"
    assert s_eps == v_eps
    for a, b in zip(s_rows, v_rows):
        assert sorted(a) == sorted(b)
        assert all(np.array_equal(a[k], b[k]) for k in a), (a, b)
    rounds_done = SHARD_ROUNDS + SHARD_BLOCK
    snapshot_files_equal(s_dir, v_dir, rounds_done)
    for backend, src in (("shard_map", v_dir), ("vmap", s_dir)):
        eng = shard_engine(spec, cfg1, backend, mesh)
        state, done = FederationCheckpointer(src, verify=True).restore_latest(
            eng, like=eng.init_states(0), seed=0)
        assert done == rounds_done and states_equal(state, s_state)
    # a cohort larger than the card count is refused, never run elsewhere
    try:
        dml_engine((spec,) * 2, spec, dataclasses.replace(cfg, n_clients=2),
                   backend="shard_map", device="cuda", mesh=mesh)
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("a shard_map engine of 2 clients on 1 card ran")
    rates = {b: rounds_per_s(shard_engine(spec, cfg1, b, mesh), data1)
             for b in ("shard_map", "vmap")}
    e = shard_engine(spec, cfg1, "shard_map", mesh)
    st, _ = e.run_rounds(e.init_states(0), data1, 0, 2, 0)
    wall_ms, on_device = device_profile(
        lambda: e.run_rounds(st, data1, 2, SHARD_BLOCK, 0))
    busy_ms = sum(ev.self_device_time_total for ev in on_device) / 1e3
    print(f"shard_map phase (a): K = 1 on an NCCL group of 1 rank, "
          f"{SHARD_ROUNDS} rounds then a block of {SHARD_BLOCK}: every leaf, "
          f"w, metric and epsilon ({s_eps[0]!r}) bit-equal to vmap's; "
          f"launches {got_nonzero(out[f'shard_map {SHARD_ROUNDS}+{SHARD_BLOCK} rounds'])}; "
          f"the snapshots byte-equal, each restored by the other backend; "
          f"K = 2 refused: {refusal}")
    print(f"shard_map phase (a): rounds/s (evaluation excluded, "
          f"{STACKED_RATE_ROUNDS} rounds as one block) shard_map "
          f"{rates['shard_map']:.4f}, vmap {rates['vmap']:.4f}; a block of "
          f"{SHARD_BLOCK} captured rounds on shard_map wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.2f}%), "
          f"{len(on_device)} device kernels and copies on {card}")
    return dict(counts=out, rates=rates, busy=(busy_ms, wall_ms))


def shard_hier_train(pods, card):
    """(b) ``make_hier_round_block_step`` on the train preset at 1 pod of
    L = 4 clients, 3 rounds, against the engine's vmap rounds on the same
    draws (a batch fixed per client, as the program takes one for every
    round; each round's noise): every leaf at ``close``, the client
    routes' launches exact."""
    from repro_torch.core.engine import draw_batch_idx, stack_states
    from repro_torch.launch import steps, train
    from repro_torch.nn.modules import tree_leaves

    free_engines()
    args = train.parse_args(TRAIN_ARGS + [
        "--steps-per-round", "1", "--rounds", str(SHARD_HIER_ROUNDS),
        "--clients", str(SHARD_HIER_L)])
    run = train.setup(args)
    gen = torch.Generator(device="cuda").manual_seed(7)
    idx = [draw_batch_idx(gen, n, args.batch, "cuda").cpu()
           for n in run.n_seqs]
    cpu_gen = torch.Generator().manual_seed(8)
    noise = torch.randn((SHARD_HIER_ROUNDS, SHARD_HIER_L, TRAIN_D),
                        generator=cpu_gen)
    eng = train.make_engine(run.cfg, run.proxy, run.fl, args, run.n_seqs,
                            "cuda")
    eng.draws = lambda k, t, s: (idx[k], noise[t, k])
    want = eng.run_rounds(clone(run.state), run.data, 0, SHARD_HIER_ROUNDS,
                          args.seed)[0]
    del eng
    free_engines()
    block = steps.make_hier_round_block_step(
        run.cfg, run.proxy, run.fl, pods, 1, SHARD_HIER_L,
        steps.StepOptions(remat=False, accum=1, dp_chunk=args.batch),
        n_rounds=SHARD_HIER_ROUNDS)
    batch = stack_states([run.engine.sample_fn(
        d, None, i.to(tree_leaves(d)[0].device))
        for d, i in zip(run.data, idx)])
    (got, metrics), counts = counted(lambda: block(
        stack_states(run.state), batch, noise.cuda()))
    expect(counts, **add_counts((SHARD_HIER_ROUNDS, peer_launches(run.proxy)),
                                (SHARD_HIER_ROUNDS, peer_launches(run.cfg))))
    assert all(torch.isfinite(v).all() for v in metrics.values())
    worst = 0.0
    for k, w in enumerate(want):
        for a, b in zip(tree_leaves(got), tree_leaves(w)):
            worst = max(worst, max_err(a[k], b))
            torch.testing.assert_close(a[k], b, **CLOSE)
    print(f"shard_map phase (b): make_hier_round_block_step on --preset 100m, "
          f"1 pod of {SHARD_HIER_L} clients, {SHARD_HIER_ROUNDS} rounds: every "
          f"leaf within close of the engine's vmap rounds on the same draws "
          f"(max abs diff {worst:.3e}); launches {got_nonzero(counts)} on "
          f"{card}")
    del got, want, run
    free_engines()
    return counts


def shard_map_path(setup, card):
    """The shard_map phase (module docstring, 15)."""
    import shutil

    import torch.distributed as dist

    spec, data, test, cfg = setup
    t0 = time.perf_counter()
    free_engines()
    mesh, pods, tmp = shard_group()
    try:
        res = {"main": shard_main(spec, data, cfg, mesh, tmp, card)}
        res["hier"] = shard_hier_train(pods, card)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"shard_map phase: {time.perf_counter() - t0:.1f} s")
    return res


# ---------------------------------------------------------------------------
# the dryrun phase: the dry-run at the reference's shapes, and its count
# held against a step on the card

DRYRUN_COMBOS = (("qwen2-7b", "train_4k"), ("qwen2-7b", "prefill_32k"),
                 ("qwen2-7b", "decode_32k"), ("falcon-mamba-7b", "long_500k"))
DRYRUN_PREFILL = dict(B=4, S=1_024)   # the serve phase's qwen2-7b prefill


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree``'s tensors: what the
    card holds for them."""
    from repro_torch.nn.modules import tree_leaves

    seen = {}
    for t in tree_leaves(tree):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def dryrun_path(card):
    t_phase = time.perf_counter()
    # (a) the reference's full shapes on meta: host work alone, in two
    # processes of their own (no CUDA device; the train step, the rest)
    # while (b) and (c) run on the card
    code = ("import json, sys, time\n"
            "from repro_torch.launch import dryrun\n"
            "for arch, shape in json.loads(sys.argv[1]):\n"
            "    t0 = time.perf_counter()\n"
            "    r = dryrun.run_one(arch, shape, verbose=False)\n"
            "    r['seconds'] = time.perf_counter() - t0\n"
            "    print(json.dumps(r), flush=True)\n")
    src = str(Path(__file__).resolve().parent / "src")
    meta_runs = [subprocess.Popen(
        [sys.executable, "-c", code, json.dumps(combos)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=src, CUDA_VISIBLE_DEVICES=""))
        for combos in (DRYRUN_COMBOS[:1], DRYRUN_COMBOS[1:])]
    try:
        t0 = time.perf_counter()
        prefill = dryrun_prefill(card)
        t1 = time.perf_counter()
        remat = dryrun_remat_capture(card)
        t2 = time.perf_counter()
        results = [p.communicate(timeout=600) for p in meta_runs]
    finally:
        for p in meta_runs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(meta_runs, results):
        assert p.returncode == 0, err[-4000:]
    out = "".join(o for o, _ in results)
    t3 = time.perf_counter()
    # (b)'s time, the meta runs done: the host is the step's alone
    b_result = dryrun_prefill_time(card, *prefill)
    print(f"dryrun phase parts: (b) count {t1 - t0:.1f} s, (c) "
          f"{t2 - t1:.1f} s, (a) waited for {t3 - t2:.1f} s more, (b) "
          f"timed {time.perf_counter() - t3:.1f} s")
    rows = {}
    for line in out.splitlines():
        r = json.loads(line)
        assert r["status"] == "ok", r
        rl = r["roofline"]
        rows[f"{r['arch']} {r['shape']}"] = r
        print(f"dryrun (a) {r['arch']} x {r['shape']} ({r['program']}, "
              f"meta, {r['seconds']:.1f} s): flops "
              f"{r['flops_global']:.6e} (matmul "
              f"{r['matmul_flops_global']:.6e}), bytes "
              f"{r['bytes_global']:.6e}, argument bytes "
              f"{r['argument_bytes_per_device']}, model flops "
              f"{r['model_flops']:.6e}, useful ratio "
              f"{r['useful_flops_ratio']:.4f}; roofline compute "
              f"{rl['compute_s'] * 1e3:.3f} ms, memory "
              f"{rl['memory_s'] * 1e3:.3f} ms, collective "
              f"{rl['collective_s'] * 1e3:.3f} ms ({rl['dominant']}-bound) "
              f"on {card}")
    assert len(rows) == len(DRYRUN_COMBOS), sorted(rows)
    phase_s = time.perf_counter() - t_phase
    print(f"dryrun phase: {phase_s:.1f} s on {card}")
    return dict(b_result, rows=rows, seconds=phase_s, remat=remat)


def dryrun_remat_capture(card):
    """The dryrun phase's (c): ``StepOptions.remat`` under the stacked
    executor's CUDA graph. Two engines over qwen1.5-4b's smoke variant (K
    = 3, B = 2, S = 16, KV chunks of 8, the kernels on the peers), one
    with remat and one without, 3 rounds each (the first eager, the
    second captured, the third replayed): both capture, and their states
    agree (at ``close``; bit-equal on the CPU, tests/test_torch_dryrun.py)."""
    from repro_torch.core.engine import FederationEngine
    from repro_torch.launch import steps, train
    from repro_torch.nn.modules import tree_leaves

    args = train.parse_args(["--arch", "qwen1.5-4b", "--smoke", "--clients",
                             "3", "--rounds", "3", "--steps-per-round", "1",
                             "--batch", "2", "--seq", "16", "--use-pallas"])
    run = train.setup(args)
    finals = {}
    for remat in (False, True):
        opts = steps.StepOptions(remat=remat, accum=1, dp_chunk=2,
                                 kv_chunk=8)
        eng = FederationEngine(
            run.fl, n_clients=3,
            step_fns=steps.make_train_step(run.cfg, run.proxy, run.fl, opts),
            init_fns=lambda g: steps.init_train_state(
                g, run.cfg, run.proxy, run.fl, opts),
            sample_fn=train.lm_sampler(2), backend="vmap", mix="pushsum",
            device="cuda", stackable=True, noisy_steps=True)
        assert eng.stacked
        state = clone(run.state)
        for t in range(3):
            state = eng.run_rounds(state, run.data, t, 1, args.seed)[0]
        torch.cuda.synchronize()
        assert eng._graphs, "the round was not captured"
        finals[remat] = [x.float() for x in tree_leaves(state)]
        del eng
        free_engines()
    worst = max(float((a - b).abs().max())
                for a, b in zip(finals[False], finals[True]))
    same = all(torch.equal(a, b) for a, b in zip(finals[False], finals[True]))
    for a, b in zip(finals[False], finals[True]):
        torch.testing.assert_close(b, a, **CLOSE)
    print(f"dryrun (c) remat under the captured stacked round (qwen1.5-4b "
          f"smoke, K = 3, 3 rounds, the first eager, the second captured): "
          f"both captured; remat against none: max abs diff {worst:.3e}"
          f"{' (bit-equal)' if same else ''} on {card}")
    return {"max_abs_diff": worst, "bit_equal": same}


def dryrun_prefill(card):
    """The dryrun phase's (b): qwen2-7b's prefill with the kernels, counted
    on meta and on the card."""
    from repro_torch import kernels
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.cost import CostCounter

    cfg = get_config("qwen2-7b")
    shape = InputShape("serve_prefill", DRYRUN_PREFILL["S"],
                       DRYRUN_PREFILL["B"], "prefill")
    meta_call, _, meta_args, mf = dryrun.step_call(cfg, shape, "prefill",
                                                   use_pallas=True)
    with CostCounter() as on_meta:
        meta_call()
    call, state, card_args, _ = dryrun.step_call(
        cfg, shape, "prefill", use_pallas=True, device="cuda")
    torch.cuda.synchronize()
    built = storage_bytes(state) + DRYRUN_PREFILL["B"] * DRYRUN_PREFILL["S"] \
        * 4   # the int32 tokens
    assert meta_args == card_args == built, (meta_args, card_args, built)
    call()   # the first call (a pass over the weights, nothing counted)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with CostCounter() as on_card:
        _, logits = call()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    got = (on_card.flops, on_card.matmul_flops, on_card.bytes)
    want = (on_meta.flops, on_meta.matmul_flops, on_meta.bytes)
    assert got == want, f"the card's count {got} != meta's {want}"
    assert torch.isfinite(logits.float()).all()
    assert launches["rmsnorm"] > 0 and launches["flash_attention"] > 0, \
        launches
    assert not {k: v for k, v in launches.items()
                if v and k not in ("rmsnorm", "flash_attention")}, launches
    print(f"dryrun (b) qwen2-7b prefill B = {shape.global_batch} x "
          f"{shape.seq_len}, the kernels on: flops {on_card.flops:.6e} "
          f"(matmul {on_card.matmul_flops:.6e}), bytes "
          f"{on_card.bytes:.6e}, equal on the card and on meta; argument "
          f"bytes {card_args} (the built state and tokens); launches "
          f"rmsnorm {launches['rmsnorm']}, flash_attention "
          f"{launches['flash_attention']}; model flops {mf:.6e} on {card}")
    return call, state, on_meta, launches


def dryrun_prefill_time(card, call, state, on_meta, launches):
    """(b)'s step timed with CUDA events beside its roofline time."""
    from repro_torch.launch import dryrun

    call()   # warm-up
    # the step's time from CUDA events, beside its roofline
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    n = 5
    start.record()
    for _ in range(n):
        call()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / n
    rl = dryrun.roofline(on_meta.flops, on_meta.bytes)
    bound_ms = 1e3 * max(rl["compute_s"], rl["memory_s"],
                         rl["collective_s"])
    print(f"dryrun (b) qwen2-7b prefill B = {DRYRUN_PREFILL['B']} x "
          f"{DRYRUN_PREFILL['S']}: measured {ms:.3f} ms a call (CUDA "
          f"events, {n} calls), roofline {bound_ms:.3f} ms "
          f"({rl['dominant']}-bound: compute {rl['compute_s'] * 1e3:.3f}, "
          f"memory {rl['memory_s'] * 1e3:.3f}), measured / roofline "
          f"{ms / bound_ms:.3f} on {card}")
    del state, call
    free_engines()
    return {"launches": launches, "ms": ms, "bound_ms": bound_ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-scan", type=Path, default=None,
                    help="a checkout of a commit whose mamba scan takes no "
                    "state (before the serve path): hold this tree's scan, "
                    "without a state, bit for bit against its scan on every "
                    "scan case")
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the commit before the narrow "
                    "attention loaders and the one-launch SGD step: time its "
                    "attention and SGD kernels beside this tree's, and hold "
                    "its aligned attention, Adam and SGD kernels bit for bit "
                    "(refused where its entry points are declared "
                    "otherwise)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc, sm_90a, {_build.BUILD_ROOT})")

    ptxas_lines()
    rows = check_kernels()
    scan_state_checks()
    if args.parent_scan:
        parent_scan(args.parent_scan)
    before_after = parent_kernels(args.parent) if args.parent else None
    narrow_launches = attention_routes()
    ops_counts, route_windows = ops_api()
    step_kernels = adam_checks()
    sgd_checks()
    setup = mnist_setup()
    spec, data, test, cfg = setup
    cold_step(*setup)
    counts, rounds_per_s = main_path(*setup)
    methods = methods_path(*setup, card)
    figures = figures_path(card)
    async_counts, async_rates, _ = async_path(*setup)
    tau0_equals_sync(spec, data, cfg)
    mass_conservation(spec, data, cfg)
    codec_us = codec_checks()
    compressed = compressed_path(*setup, card)
    async_compressed_counts, _ = compressed_async(spec, data, cfg)
    commitments_path(*setup)
    mia_counts = mia_path(card)
    fig4_path()
    step_breakdown(*setup)
    serve = serve_path(card)
    trained = train_path(card)
    resumed = resume_path(setup, card)
    hier = hier_path(setup, card)
    stacked = stacked_path(setup, card)
    shard = shard_map_path(setup, card)
    dry = dryrun_path(card)

    # each kernel's launches on the path that runs it
    # the main path (stacked): sumsq_rows, the client-grid clip and Adam,
    # the mix; the flat clip and Adam: fig. 5b's heterogeneous cohort on
    # the loop; the 1-D routes: the ops window; the narrow loaders: their
    # sweeps; the shard-grid mix: the hier main set-up at S = 2
    loop_counts = figures["fig5b hetero proxyfl"]["counts"]
    counts = dict(counts, fused_stale_mix=async_counts["fused_stale_mix"],
                  fused_pushsum_mix_blocks=hier["main"]["S=2"]["counts"][
                      "fused_pushsum_mix_blocks"],
                  sumsq_rows=counts["sumsq/rows"],
                  clip_accumulate_rows=loop_counts["scale_accumulate/rows"],
                  noise_adam_step=loop_counts["noise_adam_step/flat"],
                  clip_accumulate_rows_clients=counts[
                      "scale_accumulate/clients"],
                  noise_adam_step_clients=counts["noise_adam_step/clients"],
                  sumsq=ops_counts["sumsq/vector"],
                  scale_accumulate=ops_counts["scale_accumulate/vector"])
    counts["noise_sgd_step"] = ops_counts["noise_sgd_step"]
    # the LLM kernels: their launches on the serve path (qwen2-7b's served
    # prefill and 15 decode steps; falcon-mamba-7b's for the scan)
    serve_launches_of = {
        arch: {"prefill": serve[arch]["launches"][0],
               "decode_step": serve[arch]["launches"][1]}
        for arch in ("qwen2-7b", "falcon-mamba-7b", "gemma3-4b",
                     "phi-3-vision-4.2b")}
    for name, arch in (("rmsnorm", "qwen2-7b"), ("flash_attention",
                                                 "qwen2-7b"),
                       ("mamba_scan", "falcon-mamba-7b")):
        pre, dec = serve[arch]["launches"]
        counts[name] = pre[name] + (SERVE_GEN - 1) * dec.get(name, 0)
    # the client routes: their launches on the train preset's stacked
    # rounds (rmsnorm, attention) and on the mamba smoke variants' (the
    # scan)
    preset_counts = trained["preset"]["counts"]
    counts["rmsnorm_clients"] = preset_counts["rmsnorm/clients"]
    counts["flash_attention_clients"] = preset_counts[
        "flash_attention/clients"]
    counts["mamba_scan_clients"] = sum(
        c.get("mamba_scan/clients", 0) for c in trained["smoke"].values())
    counts.update(route_windows,
                  flash_attention_narrow=narrow_launches[torch.bfloat16],
                  flash_attention_tf32x3_narrow=narrow_launches[
                      torch.float32])
    # sumsq_rows: the main path's launches take the cohort's [K·B, D] rows
    row_of = {"sumsq_rows": "sumsq_rows clients",
              "flash_attention_tf32x3": "flash_attention f32",
              "flash_attention_narrow": "flash_attention unaligned",
              "flash_attention_tf32x3_narrow":
              "flash_attention unaligned f32"}
    # the DP kernels' and the mix's launches on each other method's path
    key_of = {name: launch_key(name) for name in (
        "sumsq_rows", "clip_accumulate_rows", "noise_adam_step",
        "clip_accumulate_rows_clients", "noise_adam_step_clients",
        "fused_pushsum_mix")}
    by_method = {name: {"proxyfl": counts[key],
                        **{m: r["counts"][key] for m, r in methods.items()}}
                 for name, key in key_of.items()}
    # every kernel's launches on each hier path
    hier_counts = {**{f"main {k}": v["counts"]
                      for k, v in hier["main"].items()},
                   **hier["stale"], **hier["train"]}
    # every kernel's launches on each stacked-phase run
    shard_counts = dict(shard["main"]["counts"],
                        **{"preset hier block 3 rounds": shard["hier"]})
    stacked_counts = {"main 2 rounds": stacked["main"]["counts"],
                      "table2 1 round": stacked["ragged"]["counts"],
                      **{f"{k} 4 rounds": v
                         for k, v in stacked["async_hier"].items()}}
    out = []
    for name, (source, replaces, tpu_kernel) in SOURCES.items():
        r = rows[row_of.get(name, name)]
        lib_us = r["library_us"]
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "tpu_kernel": tpu_kernel,
            "launches": counts[name], "max_abs_err": r["err"],
            "max_err": r["err"], "ms": r["kernel_us"] / 1e3,
            "plain_ms": r["plain_us"] / 1e3, "bound_ms": r["bound_us"] / 1e3,
            "bound_by": r["bound_by"],
            "bytes_bound_ms": r["bytes_bound_us"] / 1e3,
            "library_ms": None if lib_us is None else lib_us / 1e3,
            "kernel_us": r["kernel_us"], "plain_us": r["plain_us"],
            "bound_us": r["bound_us"], "library_us": lib_us,
            "graph_ms": r["kernel_graph_us"] / 1e3,
            "plain_graph_ms": None if r["plain_graph_us"] is None
            else r["plain_graph_us"] / 1e3,
            "library_graph_ms": None if r["library_graph_us"] is None
            else r["library_graph_us"] / 1e3,
            "shape": r["shape"], "dtype": r["dtype"]})
        if name in key_of or name == "fused_stale_mix":
            key = key_of.get(name, name)
            out[-1]["launches_by_exchange"] = {
                "proxyfl topk": compressed["topk"]["counts"][key],
                "proxyfl int8": compressed["int8"]["counts"][key],
                "async int8": async_compressed_counts[key],
                "mia quick": mia_counts[key]}
        if name in by_method:
            out[-1]["launches_by_method"] = by_method[name]
            out[-1]["launches_by_figure"] = {
                run: {"launches": f["counts"][key_of[name]],
                      "shape": ([f["K"], f["rows"][1]]
                                if name in ("fused_pushsum_mix",
                                            "noise_adam_step_clients") else
                                [f["rows"][1]] if name == "noise_adam_step"
                                else [f["K"], *f["rows"]]
                                if name == "clip_accumulate_rows_clients"
                                else f["rows"])}
                for run, f in figures.items()}
            for fig in ("table2", "fig6"):
                if f"{name} {fig}" in rows:
                    out[-1][f"{fig}_row"] = rows[f"{name} {fig}"]
        if name == "sumsq_rows":
            out[-1]["loop_row"] = rows["sumsq_rows"]   # a client's [B, D]
        if name == "flash_attention":
            out[-1]["window_row"] = rows["flash_attention window"]
            out[-1]["phi3_row"] = rows["flash_attention phi-3-vision"]
        if name == "flash_attention_tf32x3":
            out[-1]["phi3_row"] = rows["flash_attention phi-3-vision f32"]
        if name == "rmsnorm":
            out[-1]["f32_row"] = rows["rmsnorm f32"]
            out[-1]["scalar_row"] = rows["rmsnorm scalar"]
        if name == "mamba_scan":
            out[-1]["jamba_row"] = rows["mamba_scan jamba"]
        if name in ("rmsnorm", "flash_attention", "mamba_scan"):
            out[-1]["launches_ops_window"] = ops_counts[name]
            out[-1]["launches_serve"] = {
                arch: {k: v.get(name, 0) for k, v in per.items()}
                for arch, per in serve_launches_of.items()}
            # rmsnorm's prefill call is its main row's shape
            out[-1]["serve_rows"] = {
                "rmsnorm": {"decode": rows["rmsnorm serve decode"]},
                "flash_attention": {
                    "prefill": rows["flash_attention serve"],
                    "prefill window": rows["flash_attention serve window"]},
                "mamba_scan": {"prefill": rows["mamba_scan serve"]}}[name]
        if name in ("rmsnorm_clients", "flash_attention_clients"):
            out[-1]["private_row"] = rows[f"{name} private"]
        if name in ("fused_pushsum_mix", "fused_stale_mix", "rmsnorm",
                    "flash_attention", "mamba_scan", "rmsnorm_clients",
                    "flash_attention_clients", "mamba_scan_clients"):
            # the train path: the preset's 3 rounds (the stale mix: its
            # async run's 3), each registry name's smoke round
            key = "async" if name == "fused_stale_mix" else "preset"
            ckey = launch_key(name) if name.endswith("_clients") else name
            out[-1]["launches_train"] = {
                "preset 100m" + (" async" if key == "async" else ""):
                trained[key]["counts"].get(ckey, 0),
                **{f"{arch} smoke": c.get(ckey, 0)
                   for arch, c in trained["smoke"].items()}}
            out[-1]["train_rows"] = {
                label: rows[label] for label in rows
                if label.startswith(f"{name} train")}
        if name == "noise_adam_step":
            out[-1]["cold_us"] = r["kernel_cold_us"]
            out[-1]["device_kernels_per_call"] = step_kernels[name]
        if name == "noise_sgd_step":
            out[-1]["device_kernels_per_call"] = step_kernels[name]
        # the resume phase's runs: each kernel's launches in the resumed
        # part of each killed run, and in (e)'s two calls
        out[-1]["launches_resume"] = {
            run: c.get(launch_key(name), 0) for run, c in resumed.items()}
        out[-1]["launches_hier"] = {
            run: c.get(launch_key(name), 0) for run, c in hier_counts.items()}
        out[-1]["launches_stacked"] = {
            run: c.get(launch_key(name), 0)
            for run, c in stacked_counts.items()}
        out[-1]["launches_shard_map"] = {
            run: c.get(launch_key(name), 0)
            for run, c in shard_counts.items()}
        if name in ("rmsnorm", "flash_attention"):
            # the dryrun phase's counted prefill (qwen2-7b, B = 4 x 1,024)
            out[-1]["launches_dryrun"] = dry["launches"][name]
        if name == "fused_pushsum_mix_blocks":
            out[-1]["hier_rows"] = {
                label: rows[label] for label in rows
                if label.startswith(f"{name} ")}
        if before_after and row_of.get(name, name) in before_after:
            out[-1]["before_after"] = before_after[row_of.get(name, name)]
    for row, r in rows.items():
        lib_us, lib_graph = r["library_us"], r["library_graph_us"]
        plain_graph = r["plain_graph_us"]
        print(f"{row:22s} {r['dtype']:14s} {str(r['shape']):28s} per call, "
              f"eager: kernel {r['kernel_us']:10.3f} us, plain "
              f"{r['plain_us']:12.3f} us, library "
              f"{'-' if lib_us is None else f'{lib_us:10.3f} us'}; from a "
              f"CUDA graph: kernel {r['kernel_graph_us']:10.3f} us, plain "
              f"{'not measured' if plain_graph is None else f'{plain_graph:10.3f} us'}"
              f", library "
              f"{'-' if lib_graph is None else f'{lib_graph:10.3f} us'}; "
              f"bound {r['bound_us']:9.3f} us ({r['bound_by']})"
              + ("" if r["bound_by"] == "bytes" or not r["n_bytes"] else
                 f", bytes alone {r['bytes_bound_us']:9.3f} us")
              + ("" if r["padded_bound_us"] is None else
                 f", at the compiled width {r['padded_bound_us']:9.3f} us")
              + f"; max abs err {r['err']:.3e} ({r['share']:.1%} of the "
              f"tolerance); launches {counts.get(row, '-')}")
    for row, r in rows.items():
        if r["kernel_cold_us"] is not None:
            lib = r["library_cold_us"]
            print(f"{row:22s} with L2 flushed before each call: kernel "
                  f"{r['kernel_cold_us']:.3f} us, library "
                  f"{'-' if lib is None else f'{lib:.3f} us'}; bound "
                  f"{r['bound_us']:.3f} us")
    for row, r in rows.items():
        # a graph replays the same operands: where they fit in the L2 its
        # time is an L2 time against a bound at the HBM rate, and only the
        # L2-flushed time is held to that bound
        g, cold = r["kernel_graph_us"], r["kernel_cold_us"]
        resident = (0 < r["n_bytes"] <= L2_BYTES
                    and r["bound_by"] == "bytes")
        print(f"{row:22s} from a CUDA graph"
              + (", operands L2-resident" if resident else "")
              + f": {r['n_ops'] / g / 1e6:.3f} "
              f"T{r['ops_name']}/s, {r['n_bytes'] / g / 1e3:.3f} GB/s, "
              f"{100 * r['bound_us'] / g:.2f}% of its bound "
              f"({r['bound_by']})"
              + ("" if cold is None else
                 f"; with L2 flushed {100 * r['bound_us'] / cold:.2f}%"))
    print(f"main path rounds/s {rounds_per_s:.4f} on {card}")
    for method, r in methods.items():
        print(f"methods path {method} rounds/s {r['rate']:.4f} (plain path "
              f"{r['plain_rate']:.4f}) on {card}")
    for run, r in figures.items():
        print(f"figures path {run} rounds/s {r['rate']:.4f} (plain path "
              f"{r['plain_rate']:.4f}) on {card}")
    print(f"async path engine rounds/s {async_rates[True]:.4f} (plain path "
          f"{async_rates[False]:.4f}, means of two runs each) on {card}")
    for mode in ("none", "topk", "int8"):
        r = compressed[mode]
        print(f"exchange path proxyfl compress={mode} rounds/s "
              f"{r['rate']:.4f}, exchange {r['exchange_ms']:.3f} ms"
              + ("" if mode == "none" else
                 f", codec {codec_us[mode]:.3f} us a call (eager)")
              + f" on {card}")
    for arch in ("qwen2-7b", "falcon-mamba-7b", "gemma3-4b",
                 "phi-3-vision-4.2b"):
        r = serve[arch]
        print(f"serve path {arch}: prefill {r['prefill_tok_s']:.1f} tok/s "
              f"({r['prefill_ms']:.3f} ms), decode {r['decode_tok_s']:.1f} "
              f"tok/s ({r['decode_ms']:.3f} ms a step), peak "
              f"{r['peak_bytes'] / 1e9:.3f} GB on {card}")
    pre = trained["preset"]
    b, tr, prof = pre["breakdown"], pre["rates"], pre["profile"]
    print(f"train path preset 100m (stacked): rounds/s without evaluation "
          f"loop {tr['loop']:.4f}, eager stacked {tr['eager']:.4f}, captured "
          f"{tr['captured']:.4f}; a captured round's device busy "
          f"{100 * prof['busy_ms'] / prof['wall_ms']:.2f}%; peak "
          f"{pre['peak'] / 1e9:.3f} GB allocated, {pre['reserved'] / 1e9:.3f} "
          f"GB reserved on {card}")
    print(f"train path preset 100m: {pre['rate']:.4f} rounds/s (plain path "
          f"{pre['plain_rate']:.4f}), async tau = {TRAIN_TAU} "
          f"{trained['async']['rate']:.4f} rounds/s; the loop's client step "
          f"{b['step_ms']:.3f} ms (private update {b['private_ms']:.3f}, "
          f"proxy DP update {b['proxy_ms']:.3f} of it per-example grads "
          f"{b['per_example_ms']:.3f}, the rest {b['rest_ms']:.3f}), exchange "
          f"{b['exchange_ms']:.3f} ms, evaluation {b['eval_ms']:.3f} ms; "
          f"device busy {100 * b['busy_ms'] / b['wall_ms']:.2f}% of a "
          f"profiled loop step on {card}")
    for label, r in hier["main"].items():
        print(f"hier path main set-up {label} rounds/s {r['rate']:.4f} on "
              f"{card}")
    rates, busy = stacked["main"]["rates"], stacked["main"]["busy"]
    print(f"stacked path main set-up rounds/s (evaluation excluded): loop "
          f"{rates['loop']:.4f}, eager stacked {rates['eager']:.4f}, captured "
          f"{rates['captured']:.4f}; device busy over a block of 4 captured "
          f"rounds {100 * busy[4][0] / busy[4][1]:.2f}% on {card}")
    rates, (busy_ms, wall_ms) = (shard["main"]["rates"],
                                 shard["main"]["busy"])
    print(f"shard_map path main set-up K = 1 rounds/s (evaluation excluded): "
          f"shard_map {rates['shard_map']:.4f}, vmap {rates['vmap']:.4f}; "
          f"device busy over a block of {SHARD_BLOCK} captured rounds "
          f"{100 * busy_ms / wall_ms:.2f}% on {card}")
    missing = [r["name"] for r in out if not r["launches"]]
    assert not missing, f"kernels launched no time on their path: {missing}"
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

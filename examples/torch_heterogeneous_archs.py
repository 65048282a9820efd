"""Model heterogeneity (paper Fig. 5b) on the PyTorch/CUDA port: each client
keeps a DIFFERENT private architecture (MLP, LeNet5, CNN1, CNN2) while
agreeing only on the small shared proxy. Canonical FL (FedAvg et al.)
cannot do this at all.

    PYTHONPATH=src python examples/torch_heterogeneous_archs.py
        [--device cpu] [--rounds N] [--per-client N]
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import DPConfig, ProxyFLConfig
from repro_torch.core.baselines import run_federated
from repro_torch.core.protocol import ModelSpec
from repro_torch.data.partition import partition_major
from repro_torch.data.synthetic import make_classification_data
from repro_torch.launch.serve import device_label
from repro_torch.nn.vision import get_vision_model

N_CLASSES, IMG = 10, (14, 14, 1)
ARCHS = ("mlp", "lenet5", "cnn1", "cnn2")
K = len(ARCHS)

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ap.add_argument("--rounds", type=int, default=5)
ap.add_argument("--per-client", type=int, default=500)
args = ap.parse_args()
dev = resolve_device(args.device)
print(f"on {device_label(dev)}")

x, y = make_classification_data(torch.Generator(device=dev).manual_seed(0),
                                4000, IMG, N_CLASSES, sep=2.0)
xt, yt = make_classification_data(torch.Generator(device=dev).manual_seed(1),
                                  1000, IMG, N_CLASSES, sep=2.0)
parts = partition_major(np.random.default_rng(0), y.cpu().numpy(), K,
                        args.per_client, 0.8, N_CLASSES)
client_data = [(x[torch.as_tensor(i, device=dev)],
                y[torch.as_tensor(i, device=dev)]) for i in parts]

specs = []
for name in ARCHS:
    vm = get_vision_model(name)
    specs.append(ModelSpec(name, lambda g, vm=vm: vm.init(g, IMG, N_CLASSES),
                           vm.apply))
proxy_vm = get_vision_model("mlp")
proxy = ModelSpec("proxy-mlp", lambda g: proxy_vm.init(g, IMG, N_CLASSES),
                  proxy_vm.apply)

cfg = ProxyFLConfig(n_clients=K, rounds=args.rounds,
                    batch_size=min(100, args.per_client),
                    dp=DPConfig(enabled=True), use_pallas=True)

# A heterogeneous cohort runs on the per-client loop backend; checkpoints
# are stored per client, so four different architectures snapshot and
# resume bit for bit. The directory is stable across invocations: kill the
# script mid-run and rerun it to watch the federation pick up where it
# stopped (a finished run's snapshots just re-evaluate).
ckpt_dir = os.path.join(tempfile.gettempdir(),
                        f"proxyfl_torch_hetero_ckpts_{args.rounds}_"
                        f"{args.per_client}_{dev.type}")
fed = run_federated("proxyfl", specs, proxy, client_data, (xt, yt), cfg,
                    eval_every=cfg.rounds, checkpoint_dir=ckpt_dir,
                    checkpoint_every=2, resume=True, device=dev)
solo = {}
for k, name in enumerate(ARCHS):
    r = run_federated("regular", [specs[k]] * K, specs[k], client_data,
                      (xt, yt), cfg, eval_every=cfg.rounds, device=dev)
    solo[name] = float(np.mean(r["history"][-1]["acc"]))

print(f"{'client arch':12s} {'regular':>8s} {'proxyfl':>8s}")
row = fed["history"][-1]
for k, name in enumerate(ARCHS):
    print(f"{name:12s} {solo[name]:8.3f} {row['private_acc'][k]:8.3f}")
print("\nEvery architecture improves by collaborating through the shared "
      "proxy; weaker models gain the most (paper Fig. 5b).")

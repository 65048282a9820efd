"""End-to-end driver on the PyTorch/CUDA port: ProxyFL over ~100M-parameter
language models.

Each client's private model is the ``repro-100m`` dense decoder (12
layers, d 768, ~120M params); the shared proxy is a 4-layer, d 256
decoder. Clients hold synthetic bigram-domain corpora (non-IID by
construction); each round every client runs local DML steps (private Adam
+ proxy DP-SGD), then the proxies travel the PushSum exponential graph
through the port's mix kernel. The defaults are a short run on the card:

    PYTHONPATH=src python examples/torch_llm_proxyfl.py

Any flag of ``python -m repro_torch.launch.train`` overrides them (those
after ``--`` too), for example a longer run, the two-level backend, or a
registry architecture's reduced variant on the CPU:

    PYTHONPATH=src python examples/torch_llm_proxyfl.py -- --rounds 20 \\
        --steps-per-round 10 --batch 8 --seq 256
    PYTHONPATH=src python examples/torch_llm_proxyfl.py --backend hier \\
        --n-shards 2 --clients 4
    PYTHONPATH=src python examples/torch_llm_proxyfl.py --device cpu \\
        --arch qwen1.5-4b --smoke --rounds 1 --steps-per-round 1
"""
import sys

from repro_torch.launch.train import main

DEFAULTS = ["--clients", "2", "--rounds", "2", "--steps-per-round", "3",
            "--batch", "4", "--seq", "128", "--use-pallas"]

if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--"]
    if "--arch" not in args and "--preset" not in args:
        args = ["--preset", "100m"] + args
    # flags given later override the defaults (argparse keeps the last)
    raise SystemExit(main(DEFAULTS + args))

"""Batched serving of a client's private model after federation, on the
PyTorch/CUDA port: prefill a batch of prompts, then step the greedy or
sampled decode loop through the KV cache, with the port's RMSNorm and
attention kernels on the card. Uses the reduced gemma3-4b family variant
(5:1 sliding window).

    PYTHONPATH=src python examples/torch_serve_demo.py [--device cpu]
        [any other flag of python -m repro_torch.launch.serve]
"""
import sys

from repro_torch.launch.serve import main

DEFAULTS = ["--arch", "gemma3-4b", "--smoke", "--batch", "4",
            "--prompt-len", "32", "--gen", "8", "--temperature", "0.8"]

if __name__ == "__main__":
    # flags given later override the defaults (argparse keeps the last)
    raise SystemExit(main(DEFAULTS + sys.argv[1:]))

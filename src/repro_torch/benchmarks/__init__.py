"""The paper's figure drivers on the port (``benchmarks`` counterpart);
they import torch, numpy and the standard library only."""

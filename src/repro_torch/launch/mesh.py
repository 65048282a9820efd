"""Device constants of the port (the counterpart of ``src/repro/launch/
mesh.py``): ``H100_SXM`` stands where the reference's ``TPU_V5E`` (:22)
stands, the one home of the card's published figures for the dry-run's
roofline (``launch/dryrun.py``) and for ``chip_smoke.py``'s kernel bounds.
The functions that make meshes (``make_production_mesh``,
``make_client_mesh``) join it with ROADMAP Queue 1 item 14b.
"""
from __future__ import annotations

#: NVIDIA H100 SXM5 (80 GB), published figures: dense bf16 on the tensor
#: cores; f32 outside them; f32-grade products as three TF32 products at
#: the dense TF32 rate; HBM3 bandwidth; device memory; L2 cache
H100_SXM = {
    "peak_flops_bf16": 989e12,
    "peak_flops_f32": 67e12,
    "peak_flops_tf32x3": 495e12 / 3,
    "hbm_bandwidth": 3.35e12,
    "hbm_bytes": 80 * 2 ** 30,
    "l2_bytes": 50 * 2 ** 20,
}

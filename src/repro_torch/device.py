"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch

# SMs of the H100 the kernels' partitions are cut for: the single-pass
# attention walks' cluster ranks (kernels/paged_attention.py::cluster_ranks)
# and the bit-sliced GEMMs' tiling (kernels/lut_gemm_bitsliced.py::
# bs_partition) both fill this many SMs in one wave
CARD_SMS = 132


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. A CUDA request with no card visible raises instead of
    carrying on quietly on the CPU."""
    d = torch.device("cuda" if device is None else device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' (--device cpu) to "
            "run the plain PyTorch path on the CPU")
    return d

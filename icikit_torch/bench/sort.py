"""Sort-benchmark helpers: the card's memory nameplate and the
physical floor of one sort."""

from __future__ import annotations

import torch

from icikit_torch.ops.cuda_sort import sort_passes

# Published device-memory rates (NVIDIA data sheets). The SXM part
# reports itself to CUDA as "NVIDIA H100 80GB HBM3", the PCIe part as
# "NVIDIA H100 PCIe". Other names get no nameplate.
_H100_SXM_BPS = 3.35e12
_H100_PCIE_BPS = 2.0e12


def hbm_nameplate_bytes(device_name: str | None = None) -> float | None:
    """Nameplate memory bandwidth (bytes/s) of the card, keyed on its
    CUDA name (default: device 0's); None for a name not known here or
    without a card."""
    if device_name is None:
        if not torch.cuda.is_available():
            return None
        device_name = torch.cuda.get_device_name(0)
    if "H100" not in device_name:
        return None
    if "PCIe" in device_name:
        return _H100_PCIE_BPS
    if "HBM3" in device_name or "SXM" in device_name:
        return _H100_SXM_BPS
    return None


def sort_floor_s(n: int, p: int, itemsize: int,
                 device_name: str | None = None) -> float | None:
    """Physical lower bound on one sort's seconds: each kernel launch of
    the local sort of a rank's share n/p reads and writes it once, at
    the nameplate rate, and all p ranks share the one card. Windows
    faster than this are impossible and are discarded by
    ``timeit_windows``. None without a nameplate."""
    bw = hbm_nameplate_bytes(device_name)
    if bw is None:
        return None
    n_loc = max(1, n // p)
    return 2.0 * p * n_loc * itemsize * sort_passes(n_loc) / bw

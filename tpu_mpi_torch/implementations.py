"""Backend/platform introspection.

Reference: MPI.jl src/implementations.jl — queries
MPI_Get_library_version (:15-27), regex-parses vendor+version into an MPIImpl
enum (:57-66,80-132), and exposes MPI_VERSION (:154-170). The port's analog:
identify the accelerator (CUDA and the card, by ``torch.cuda.get_device_name``)
and the runtime library (torch and its CUDA versions), so programs can adapt
like MPI programs adapt to MPICH vs OpenMPI.
"""

from __future__ import annotations

import enum
import re
from typing import Optional

import torch


class Backend(enum.Enum):
    """The transport 'implementation' (analog of MPIImpl, implementations.jl:57-66)."""
    UNKNOWN = 0
    CPU = 1            # torch on the host (the test substrate)
    CUDA = 2           # NVIDIA cards through torch.cuda


# Pattern table: device-name string -> card key (the analog of the vendor
# version-string regexes in implementations.jl:80-132).
_CARD_KINDS = [
    (re.compile(r"H100.*PCIe", re.I), "h100-pcie"),
    (re.compile(r"H100", re.I), "h100-sxm"),
]


def get_backend() -> Backend:
    """Which accelerator backs the job (implementations.jl MPI_LIBRARY analog)."""
    return Backend.CUDA if torch.cuda.is_available() else Backend.CPU


def device_name(index: int = 0) -> Optional[str]:
    """``torch.cuda.get_device_name`` of a card, or None without CUDA."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(index)


def card() -> Optional[str]:
    """'h100-sxm' / 'h100-pcie' / None (no CUDA, or a card without a row)."""
    name = device_name()
    if name is None:
        return None
    for pat, key in _CARD_KINDS:
        if pat.search(name):
            return key
    return None


def Get_library_version() -> str:
    """Version string of the runtime stack (implementations.jl:15-27)."""
    parts = [f"torch {torch.__version__}"]
    if torch.version.cuda is not None:
        parts.append(f"cuda {torch.version.cuda}")
    name = device_name()
    if name is not None:
        parts.append(f"device {name}")
    return ", ".join(parts)


def Get_version() -> tuple[int, int]:
    """API version of this framework (implementations.jl:154-170 reports the
    MPI standard version; we report the capability surface we mirror)."""
    return (3, 1)


def device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


# ---------------------------------------------------------------------------
# Per-card capability table — the analog of the pre-baked ABI constant
# tables deps/consts_*.jl (SURVEY.md §2.4). SPEC-SHEET FIGURES, not
# measurements: NVIDIA's H100 data sheet (dense rates, no sparsity, at the
# full power limit). A card set below its limit runs slower; measured rates
# come from chip_smoke.py, beside the card's name and power limit.
# ---------------------------------------------------------------------------

CAPABILITIES: dict[str, dict[str, float]] = {
    "h100-sxm": {"hbm_gbps": 3350.0, "hbm_gib": 80.0, "sms": 132,
                 "nvlink_gbps": 900.0, "bf16_tflops": 989.0,
                 "fp32_tflops": 67.0, "spec_sheet": True},
    "h100-pcie": {"hbm_gbps": 2000.0, "hbm_gib": 80.0, "sms": 114,
                  "nvlink_gbps": 600.0, "bf16_tflops": 756.0,
                  "fp32_tflops": 51.0, "spec_sheet": True},
}


def platform_probe() -> dict:
    """One-shot platform report — the runtime analog of the reference's
    build-time ``gen_consts`` probe (MPI.jl deps/gen_consts.jl)."""
    return {
        "backend": get_backend().name,
        "library_version": Get_library_version(),
        "api_version": list(Get_version()),
        "card": card(),
        "device_count": device_count(),
        "devices": [device_name(i) for i in range(device_count())],
        "capabilities": capabilities(),
    }


def capabilities(key: Optional[str] = None) -> dict[str, float]:
    """Capability row for a card (default: the local one; the H100 SXM row
    when the card is unknown, so ratios stay computable)."""
    return dict(CAPABILITIES.get(key or card() or "", CAPABILITIES["h100-sxm"]))


MPI_LIBRARY = "tpu_mpi_torch"

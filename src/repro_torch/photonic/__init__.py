"""`repro_torch.photonic` — port of `repro.photonic`: the weight-stationary
photonic execution engine and one-time weight prepacking."""

from repro_torch.kernels.photonic_gemm.epilogue import (
    ACTIVATIONS,
    Epilogue,
    EpilogueArgs,
    EpilogueSpec,
    as_epilogue,
)
from repro_torch.photonic.engine import (
    EngineInfo,
    PhotonicEngine,
    SitePolicy,
    engine_for,
)
from repro_torch.photonic.packing import PackedDense, pack_dense, prepack_params

__all__ = [
    "ACTIVATIONS",
    "EngineInfo",
    "Epilogue",
    "EpilogueArgs",
    "EpilogueSpec",
    "PackedDense",
    "PhotonicEngine",
    "SitePolicy",
    "as_epilogue",
    "engine_for",
    "pack_dense",
    "prepack_params",
]

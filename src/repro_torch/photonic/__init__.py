"""`repro_torch.photonic` — port of `repro.photonic`: the weight-stationary
photonic execution engine, its bit-sliced mode, and one-time weight
prepacking, and its tensor-parallel (K-sharded) execution."""

from repro_torch.kernels.photonic_gemm.epilogue import (
    ACTIVATIONS,
    Epilogue,
    EpilogueArgs,
    EpilogueSpec,
    as_epilogue,
)
from repro_torch.photonic.engine import (
    PLANE_STREAM_TAG,
    EngineInfo,
    PhotonicEngine,
    SitePolicy,
    engine_for,
)
from repro_torch.photonic.packing import (
    PackedDense,
    fuse_qkv_params,
    pack_dense,
    prepack_params,
)
from repro_torch.photonic.sharded import (
    manual_tp,
    psum_int_gemm,
    shard_local_engine,
    tensor_parallel,
)
from repro_torch.photonic.slicing import SlicingSpec, resolve_slicing

__all__ = [
    "ACTIVATIONS",
    "PLANE_STREAM_TAG",
    "EngineInfo",
    "Epilogue",
    "EpilogueArgs",
    "EpilogueSpec",
    "PackedDense",
    "PhotonicEngine",
    "SitePolicy",
    "SlicingSpec",
    "as_epilogue",
    "engine_for",
    "fuse_qkv_params",
    "manual_tp",
    "pack_dense",
    "prepack_params",
    "psum_int_gemm",
    "resolve_slicing",
    "shard_local_engine",
    "tensor_parallel",
]

"""Launch profile: allocator, logging and build-cache environment for the
port's entry points, the dry-run sweep and ``chip_smoke.py``.

Port of ``repro.launch.profile``.  The reference curates a JAX/XLA
environment; here the same knobs are the torch ones, kept as a library so
every entry point applies one identical, recorded profile:

* **tcmalloc** — detected, never injected in-process: ``LD_PRELOAD`` is
  read by the dynamic linker at ``exec`` time, so :func:`apply` only
  reports whether it is active, and :func:`child_env` builds the
  environment of a subprocess (the dry-run sweep) where it takes effect.
* **log hygiene** — ``TORCH_CPP_LOG_LEVEL``, ``NCCL_DEBUG`` and the
  tcmalloc large-allocation report threshold are defaulted with
  ``setdefault``: a value the user set always wins.
* **``PYTORCH_CUDA_ALLOC_CONF``** — curated allocator options are merged
  option by option, as the reference merges ``XLA_FLAGS``: an option
  already present keeps its value.  Nothing in the curated set changes a
  bit of any result (it is empty for now, :data:`ALLOC_CONF_DEFAULTS`).
* **build cache** — the nvcc build directory ``build/repro_torch/``
  (``repro_torch.kernels._build``, keyed by a hash of each source) plays
  the part of the reference's persistent compilation cache.

:func:`apply` never turns on TF32, ``cudnn.benchmark`` or any other switch
that changes numerics; the parity tiers depend on that, and
:func:`describe` records that they are off.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict, List, Optional

from repro_torch.kernels._build import build_dir

# Known tcmalloc install paths (Debian/Ubuntu multiarch, RH, and the running
# interpreter's own prefix, where conda puts it).
TCMALLOC_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
    "/usr/lib64/libtcmalloc.so.4",
    os.path.join(sys.prefix, "lib", "libtcmalloc.so"),
)

# Quiet c10 and NCCL logging and tcmalloc's large-allocation reports (60 GB
# threshold: big weight buffers are expected, not leaks).
ENV_DEFAULTS = {
    "TORCH_CPP_LOG_LEVEL": "ERROR",
    "NCCL_DEBUG": "WARN",
    "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "60000000000",
}

# Merged into PYTORCH_CUDA_ALLOC_CONF only where the option is absent.
# Empty: every allocator option changes where memory lands (and some,
# such as expandable segments, how CUDA graphs and IPC handles behave), and
# none has been measured to help the port on the card.  The merge is the
# hook for one that is.
ALLOC_CONF_DEFAULTS: List[str] = []


def find_tcmalloc() -> Optional[str]:
    """Path of an installed tcmalloc shared object, or ``None``.
    Reference: ``repro.launch.profile:find_tcmalloc``."""
    for path in TCMALLOC_CANDIDATES:
        if os.path.exists(path):
            return path
    return None


def tcmalloc_active() -> bool:
    """Whether this process was launched with tcmalloc preloaded.
    Reference: ``repro.launch.profile:tcmalloc_active``."""
    return "tcmalloc" in os.environ.get("LD_PRELOAD", "")


def _merged(current: str, extra: List[str]) -> str:
    """``current`` (comma-separated ``option:value``) with the options of
    ``extra`` it lacks appended: a set option always wins."""
    present = {tok.split(":", 1)[0].strip() for tok in current.split(",") if tok.strip()}
    return ",".join(filter(None, [current, *(o for o in extra if o.split(":", 1)[0] not in present)]))


def _merge_alloc_conf(extra: List[str]) -> str:
    """Merge ``extra`` into ``PYTORCH_CUDA_ALLOC_CONF``.  Reference:
    ``repro.launch.profile:_merge_xla_flags``."""
    merged = _merged(os.environ.get("PYTORCH_CUDA_ALLOC_CONF", ""), extra)
    if merged:
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = merged
    return merged


def apply() -> Dict[str, object]:
    """Apply the launch profile to this process and return
    :func:`describe`'s snapshot.  Idempotent.  The allocator options only
    take effect before the first CUDA allocation, so entry points call
    this first; after that the merge is recorded and harmless.
    Reference: ``repro.launch.profile:apply``."""
    for key, val in ENV_DEFAULTS.items():
        os.environ.setdefault(key, val)
    _merge_alloc_conf(ALLOC_CONF_DEFAULTS)
    return describe()


def _card() -> Optional[str]:
    """``name, power.limit`` of the first card from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def describe() -> Dict[str, object]:
    """Snapshot of the effective profile, recorded beside measurements.
    Reference: ``repro.launch.profile:describe``."""
    import torch

    return {
        "tcmalloc_found": find_tcmalloc(),
        "tcmalloc_active": tcmalloc_active(),
        "ld_preload": os.environ.get("LD_PRELOAD") or None,
        "torch_cpp_log_level": os.environ.get("TORCH_CPP_LOG_LEVEL"),
        "nccl_debug": os.environ.get("NCCL_DEBUG"),
        "pytorch_cuda_alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF") or None,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "card": _card(),
        "build_dir": str(build_dir()),
        "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
        "tf32_cudnn": torch.backends.cudnn.allow_tf32,
        "cudnn_benchmark": torch.backends.cudnn.benchmark,
    }


def child_env(base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Environment of a child process under the full profile, including
    ``LD_PRELOAD=tcmalloc`` where tcmalloc exists (only the next ``exec``
    can honour it).  Used by the dry-run sweep's per-cell subprocesses.
    Reference: ``repro.launch.profile:child_env``."""
    env = dict(os.environ if base is None else base)
    for key, val in ENV_DEFAULTS.items():
        env.setdefault(key, val)
    tc = find_tcmalloc()
    if tc and "tcmalloc" not in env.get("LD_PRELOAD", ""):
        env["LD_PRELOAD"] = ":".join(filter(None, [env.get("LD_PRELOAD"), tc]))
    merged = _merged(env.get("PYTORCH_CUDA_ALLOC_CONF", ""), ALLOC_CONF_DEFAULTS)
    if merged:
        env["PYTORCH_CUDA_ALLOC_CONF"] = merged
    return env

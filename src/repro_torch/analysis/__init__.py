"""`repro_torch.analysis` — the port's machine-enforced contracts (the
counterpart of `repro.analysis`).

Two levels:

* **Level 1 — AST lint** (:mod:`repro_torch.analysis.core`, rules in
  :mod:`repro_torch.analysis.rules`): the reference's ten RPR rules in
  torch spelling over the port's own files — the import boundary
  (RPR001), single-point org and platform resolution (RPR002, RPR009),
  engine-only GEMM routing (RPR003), engine-derived randomness (RPR004),
  reciprocal-multiply quantization (RPR005), the
  tensor_parallel/manual_tp nesting ban (RPR006), paged KV only through
  ``kv_cache`` (RPR007), no post-GEMM shoulders (RPR008), and timing
  arithmetic only in the mapper (RPR010).
* **Level 2 — contract checks over recorded runs**
  (:mod:`repro_torch.analysis.contracts`): :class:`ContractChecker`.

CLI: ``python -m repro_torch.analysis``.
"""

from repro_torch.analysis.contracts import ContractChecker, ContractViolation
from repro_torch.analysis.core import (
    Finding,
    Rule,
    all_rules,
    check_source,
    register_rule,
    run_all,
)

__all__ = [
    "ContractChecker",
    "ContractViolation",
    "Finding",
    "Rule",
    "all_rules",
    "check_source",
    "register_rule",
    "run_all",
]

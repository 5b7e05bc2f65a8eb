"""`repro_torch.analysis` — contract checks over recorded runs (the port's
counterpart of `repro.analysis.contracts`)."""

from repro_torch.analysis.contracts import ContractChecker, ContractViolation

__all__ = ["ContractChecker", "ContractViolation"]

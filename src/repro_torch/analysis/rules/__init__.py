"""Rule plugins. Importing this package registers every RPR rule.

Port of ``repro.analysis.rules``: the same ten IDs, each module named as
its reference, with scopes retargeted to the port's paths and matchers in
torch spelling.  Each module defines one themed rule and registers it via
:func:`repro_torch.analysis.core.register_rule`.
"""

from repro_torch.analysis.rules import (  # noqa: F401
    compat,
    engine,
    epilogue,
    mapper,
    orgs,
    platforms,
    quant,
    randomness,
    serving,
    sharding,
)

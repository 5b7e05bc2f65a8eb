"""RPR004 — models/kernels draw no randomness outside the engine's streams.

Port of ``repro.analysis.rules.randomness``.  Noise in the photonic
channel is keyed per (site, layer, shard) by the engine's seed derivation
(``stream_seed`` / ``DPUConfig.noise_seed_array``, drawn through
``repro_torch.prng``) so runs are reproducible and shards decorrelate
deterministically.  A model or kernel sampling from torch's global
generator (``torch.randn``, ``x.normal_()``) or from a generator of its
own (``torch.Generator(...)``) forks the stream and breaks the
bitwise-stability story.  Parameter initialization (``init*`` functions,
host-side setup) is exempt.
"""

from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.core import (
    Finding,
    Rule,
    dotted_name,
    enclosing_functions,
    register_rule,
)

# torch.<name> samplers (referenced or called).
_SAMPLERS = frozenset(
    {
        "rand",
        "rand_like",
        "randn",
        "randn_like",
        "randint",
        "randint_like",
        "randperm",
        "normal",
        "bernoulli",
        "multinomial",
        "poisson",
    }
)

# A generator of one's own is a stream of one's own.
_GENERATOR = "torch.Generator"

# In-place samplers on any tensor (``w.normal_()``, ``nn.init.normal_``).
_INPLACE_SAMPLERS = frozenset(
    {
        "normal_",
        "uniform_",
        "random_",
        "exponential_",
        "bernoulli_",
        "geometric_",
        "cauchy_",
        "log_normal_",
    }
)

_SCOPED_PREFIXES = ("src/repro_torch/models/", "src/repro_torch/kernels/")


def _sample_site(node: ast.AST):
    """The spelling of a draw at ``node``, or None."""
    if isinstance(node, ast.Attribute):
        dotted = dotted_name(node)
        if dotted is not None and dotted.startswith("torch."):
            if dotted[len("torch."):] in _SAMPLERS:
                return dotted
    elif isinstance(node, ast.Call):
        func = node.func
        if dotted_name(func) == _GENERATOR:
            return _GENERATOR
        if isinstance(func, ast.Attribute) and func.attr in _INPLACE_SAMPLERS:
            return f"{dotted_name(func) or '.' + func.attr}()"
    return None


@register_rule
class ModelRandomnessRule(Rule):
    id = "RPR004"
    summary = "torch sampling in models/kernels outside init paths"
    rationale = (
        "All model/kernel randomness must come from the engine's seed "
        "derivation (stream_seed / noise_seed_array) so noise streams are "
        "(site, layer, shard)-keyed and reproducible; ad-hoc torch "
        "sampling (torch.randn, .normal_(), a torch.Generator) forks the "
        "stream."
    )

    def applies_to(self, relpath: str) -> bool:
        return relpath.startswith(_SCOPED_PREFIXES)

    def check(self, tree: ast.Module, text: str, relpath: str) -> Iterable[Finding]:
        enclosing = enclosing_functions(tree)
        for node in ast.walk(tree):
            spelling = _sample_site(node)
            if spelling is None:
                continue
            fns = enclosing.get(node, [])
            if any(f.name.lstrip("_").startswith("init") for f in fns):
                continue  # parameter initialization is host-side setup
            yield self.finding(
                relpath,
                node,
                f"{spelling} sampled outside an init path; derive randomness "
                "from the engine stream (stream_seed / noise_seed_array)",
            )

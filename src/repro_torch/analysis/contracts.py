"""Contract checks over one recorded run of a function.

Port of ``repro.analysis.contracts``.  The reference traces a jaxpr
(``jax.make_jaxpr``) and asserts execution contracts over it; PyTorch runs
eagerly, so :class:`ContractChecker` *records* one run instead: the
function runs once under :class:`repro_torch.launch.hlo_analysis.Recorder`
(a ``TorchDispatchMode``), real kernels included, and the checker keeps
every aten op with its input shapes and dtypes, every ``c10d``
collective, and the hand-written kernels' launches (``LAUNCHES`` deltas
and the wrappers' launch record).  The contracts:

* **weight-stationary decode** — a decode step over prepacked params runs
  no ``round`` over a weight-sized input (:meth:`ContractChecker.
  assert_zero_weight_rounds`);
* **one all-reduce per routed GEMM** — the sharded integer path reduces
  each GEMM's int32 partials exactly once (:meth:`ContractChecker.
  assert_psum_per_gemm`);
* **noisy needs a source** — a noisy channel without a key source raises
  (:meth:`ContractChecker.assert_untraceable_without_source`).

The reference's ``hlo_text`` has no counterpart: the port compiles no
HLO, and :meth:`~ContractChecker.collective_summary` /
:meth:`~ContractChecker.matmul_traffic_bytes` read the recorded run.

:data:`ALL_REDUCES` counts the collectives of tensor-parallel execution:
``repro_torch.photonic.sharded.psum_int_gemm`` adds one for each int32
all-reduce it issues, the forward counterpart of the reference
``ContractChecker``'s "one psum per routed GEMM".  :data:`ROW_GATHERS`
counts the mesh-mode GEMMs whose rows split over the data axes and were
gathered back (``repro_torch.photonic.sharded``, ``"tp_rows"``: one a
GEMM; none on a step under ``repro_torch.runtime.sharding.placement``,
whose rows are local already), and the placed outputs gathered into the
replicated value the reference's ``out_shardings`` ask for
(``"outputs"``: one a dimension gathered).  Under a placement,
:data:`SCALE_REDUCTIONS` counts the routed GEMMs whose activation scale
is a ``MAX`` all-reduce of local abs-maxima, and :data:`HEAD_GATHERS` the
attention outputs whose heads were gathered over ``model`` before a
``wo`` that cannot take its K block (the digital path on whole weights).
Where the parameters are placed too (``runtime.sharding.place_params``),
:data:`PARAM_REDUCES` counts the SUM all-reduces of the two GEMM forms
over ``model``: ``"column_input"``, the backward of a column-parallel
GEMM's input (``sharding.copy_to_model``); ``"row_output"``, the forward
of a float row-parallel GEMM's partial products
(``sharding.reduce_from_model``; a routed one sums its int32 partials in
``psum_int_gemm`` instead); ``"vocab"``, the vocab-parallel embedding
lookup and the loss's sums; ``"weight_words"``, the noise-stream content
words of a column block's whole weight (one a noisy column-parallel
GEMM); ``"weight_scale"``, the per-column abs-max of a K-placed weight
(one a routed row-parallel GEMM on a placed float weight);
``"expert_combine"``, the forward sum of the ranks' partial combines of an
expert-parallel MoE (one a MoE layer); ``"expert_input"``, the backward of
its experts' input and gate values (one a MoE layer).
:data:`RECURRENT_COLLECTIVES` counts the collectives of the recurrent
families' placed forms (``inner`` / ``mamba_heads`` over ``model``):
``"xin"``, the all-gather of the mLSTM's ``xin`` columns that its
``wq`` / ``wk`` / ``wv`` rows read whole (one an mLSTM layer);
``"parts"``, the all-gathers of column parts every rank reads whole (the
mLSTM's ``v``, the sLSTM's gate preacts, Mamba2's ``B`` / ``C``: one a
layer); ``"state_sum"``, the mLSTM's f32 SUM of its partial readouts of
the state placed on its key dimension (one an mLSTM layer); ``"norm"``,
the all-gather of Mamba2's gated-norm input (one a Mamba2 layer); and
``"split_input"``, the backward SUM of a replicated value that rank-split
work reads (the mLSTM's gates and ``v``, Mamba2's ``B`` / ``C``, a norm's
output ahead of a row-parallel GEMM).  The row-parallel ``down`` /
``out_proj`` reduce as every row-parallel GEMM does (``psum_int_gemm``
routed, ``PARAM_REDUCES["row_output"]`` digital).
:data:`SEQ_COLLECTIVES` counts the collectives of the placed sequence
axes (``runtime.sharding``): ``"gather"``, the all-gathers of the
residual's ``seq_sp`` blocks where a block reads the whole sequence (two
a decoder layer, one a Mamba2 layer, one before the head, one for a
prefill's last position; of a norm's output in the Megatron entry);
``"split_grad"``, the backward all-gathers of the residual's gradient
where a block's output was cut to this rank's block; ``"scatter"``, the
reduce-scatters of a block's row-parallel output over the sequence (its
psum or ``row_output`` / ``expert_combine`` / ``vocab`` sum, counted there
too); ``"gather_grad"``, the backward reduce-scatters of a Megatron
entry's partial input gradients; ``"norm_grad"``, the SUM of that entry's
norm-parameter gradients; ``"kv_max"`` / ``"kv_sum"``, the decode softmax
merged over the ``kv_seq`` blocks of the cache (one ``MAX`` of the
scores' row max and one SUM of the exp-sums and ``P @ V`` partials side
by side, a decode attention); ``"kv_word"``, the SUM of an expanded MLA
decode's latent rows' content word over the blocks (one a noisy ``wuk``
/ ``wuv`` at a row origin); ``"kv_rows"``, the all-gathers of the latent
rows where an expanded MLA decode expands them whole.
:data:`SEQ_WIRE_BYTES` holds the ring wire bytes a rank of each
(:func:`count_seq`).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

from repro_torch.launch import hlo_analysis


ALL_REDUCES = {"psum_int_gemm": 0}
ROW_GATHERS = {"tp_rows": 0, "outputs": 0}
SCALE_REDUCTIONS = {"amax": 0}
HEAD_GATHERS = {"heads": 0}
PARAM_REDUCES = {"column_input": 0, "row_output": 0, "vocab": 0, "weight_words": 0, "weight_scale": 0,
                 "expert_combine": 0, "expert_input": 0}
RECURRENT_COLLECTIVES = {"xin": 0, "parts": 0, "state_sum": 0, "norm": 0, "split_input": 0}
SEQ_COLLECTIVES = {"gather": 0, "split_grad": 0, "scatter": 0, "gather_grad": 0, "norm_grad": 0, "kv_max": 0,
                   "kv_sum": 0, "kv_word": 0, "kv_rows": 0}
SEQ_WIRE_BYTES = dict.fromkeys(SEQ_COLLECTIVES, 0.0)


def reset_all_reduces() -> None:
    """Zero :data:`ALL_REDUCES`, :data:`ROW_GATHERS`,
    :data:`SCALE_REDUCTIONS`, :data:`HEAD_GATHERS`, :data:`PARAM_REDUCES`,
    :data:`RECURRENT_COLLECTIVES` and :data:`SEQ_COLLECTIVES`."""
    for counts in (ALL_REDUCES, ROW_GATHERS, SCALE_REDUCTIONS, HEAD_GATHERS, PARAM_REDUCES, RECURRENT_COLLECTIVES,
                   SEQ_COLLECTIVES, SEQ_WIRE_BYTES):
        for name in counts:
            counts[name] = 0


def count_seq(what: str, kind: str, out_bytes: int, group: int) -> None:
    """Add one to ``SEQ_COLLECTIVES[what]`` and the collective's ring wire
    bytes a rank (``hlo_analysis``'s formula: ``kind`` "all-gather",
    "reduce-scatter" or "all-reduce", its output bytes, its group's size)
    to ``SEQ_WIRE_BYTES[what]``."""
    SEQ_COLLECTIVES[what] += 1
    SEQ_WIRE_BYTES[what] += hlo_analysis._wire_bytes(kind, out_bytes, group)


def count_collective(what: str) -> None:
    """Add one to ``what``'s count: a key of :data:`PARAM_REDUCES`, of
    :data:`SEQ_COLLECTIVES` or of :data:`RECURRENT_COLLECTIVES`."""
    counts = PARAM_REDUCES if what in PARAM_REDUCES else SEQ_COLLECTIVES if what in SEQ_COLLECTIVES else (
        RECURRENT_COLLECTIVES)
    counts[what] += 1


def min_weight_size(defs: Any) -> int:
    """Elements of the smallest routed weight (a two-dimensional ``w`` of a
    dense def) in a parameter-definition tree: the ``min_size`` at which a
    ``round`` counts as a weight round."""
    from repro_torch.models.common import P

    sizes = []

    def walk(node):
        if isinstance(node, dict):
            w = node.get("w")
            if isinstance(w, P) and len(w.shape) == 2:
                sizes.append(math.prod(w.shape))
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(defs)
    if not sizes:
        raise ValueError("the definition tree holds no routed weight")
    return min(sizes)


class ContractViolation(AssertionError):
    """A recorded run broke one of the repo's execution contracts.
    Reference: ``repro.analysis.contracts:ContractViolation``."""


class ContractChecker:
    """Contract assertions over one recorded run of a function.  Build with
    :meth:`record`; every assertion raises :class:`ContractViolation` with
    the offending counts.  Reference:
    ``repro.analysis.contracts:ContractChecker``."""

    def __init__(self, recorder: hlo_analysis.Recorder, launches: Dict[str, int], label: str = "<recorded fn>",
                 output: Any = None):
        self.ops = recorder.ops
        self.collectives = recorder.collectives
        self.launch_records = recorder.launches
        self.launches = launches
        self.label = label
        self.output = output

    @classmethod
    def record(cls, fn: Callable, *args, label: Optional[str] = None, **kwargs) -> "ContractChecker":
        """Run ``fn(*args, **kwargs)`` once under a recorder (the port's
        ``jax.make_jaxpr``: the real kernels run, on the card where the
        tensors are) and keep what it dispatched; ``output`` holds the
        result.  Reference: ``repro.analysis.contracts:ContractChecker.trace``."""
        from repro_torch.kernels.flash_attention import kernel as F
        from repro_torch.kernels.photonic_gemm import kernel as K

        before = dict(K.LAUNCHES, **F.LAUNCHES)
        with hlo_analysis.Recorder() as rec:
            out = fn(*args, **kwargs)
        after = dict(K.LAUNCHES, **F.LAUNCHES)
        launches = {k: after[k] - before[k] for k in after}
        return cls(rec, launches, label=label or getattr(fn, "__name__", "<recorded fn>"), output=out)

    # -- generic counting ---------------------------------------------------
    def count(self, primitive: str, *, substring: bool = False) -> int:
        """Ops named ``primitive`` (an aten or c10d op name, e.g. ``round``,
        ``mm``, ``allreduce_``)."""
        return sum(1 for op in self.ops if op.name == primitive or (substring and primitive in op.name))

    def primitive_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for op in self.ops:
            out[op.name] = out.get(op.name, 0) + 1
        return out

    # -- contract: weight-stationary decode ---------------------------------
    def weight_round_ops(self, min_size: int) -> int:
        """``round`` ops with an input of at least ``min_size`` elements.
        Reference: ``repro.analysis.contracts:count_weight_round_ops``."""
        return sum(1 for op in self.ops if "round" in op.name
                   and any(math.prod(shape or (1,)) >= min_size for shape, _ in op.inputs))

    def assert_zero_weight_rounds(self, min_size: int) -> "ContractChecker":
        n = self.weight_round_ops(min_size)
        if n != 0:
            raise ContractViolation(
                f"{self.label}: weight-stationary contract broken — "
                f"{n} round op(s) over arrays >= {min_size} elements "
                "(prepacked decode must quantize activations only)"
            )
        return self

    # -- contract: one all-reduce per routed GEMM --------------------------------
    def all_reduces(self) -> int:
        return sum(1 for c in self.collectives if c.kind == "all-reduce")

    def assert_psum_per_gemm(self, gemms: int) -> "ContractChecker":
        """Exactly ``gemms`` all-reduces (the reference's ``psum``), one per
        routed GEMM of a tensor-parallel step."""
        n = self.all_reduces()
        if n != gemms:
            raise ContractViolation(
                f"{self.label}: sharded-GEMM contract broken — expected "
                f"exactly {gemms} psum (one per routed GEMM), recorded {n} all-reduces"
            )
        return self

    # -- collective and GEMM traffic (launch.hlo_analysis over the record) ----
    def collective_summary(self) -> Dict[str, float]:
        """Wire bytes per collective kind of the recorded run."""
        return hlo_analysis.collective_summary(self.collectives)

    def matmul_traffic_bytes(self) -> int:
        """Operands plus output of every GEMM of the recorded run."""
        return hlo_analysis.matmul_traffic_bytes(self.ops, self.launch_records)

    # -- contract: noisy channels need a key source --------------------------
    @staticmethod
    def assert_untraceable_without_source(fn: Callable, *args, match: str = "randomness source", **kwargs) -> None:
        """Calling ``fn`` must fail with the documented seed-source
        ``ValueError``: noise with an unpinned seed is unrepresentable."""
        try:
            fn(*args, **kwargs)
        except ValueError as e:
            if match in str(e):
                return
            raise ContractViolation(
                f"the call raised ValueError, but not the documented "
                f"seed-source error ({match!r}): {e}"
            ) from e
        raise ContractViolation(
            "noisy channel ran without a key source; expected ValueError "
            f"matching {match!r}"
        )

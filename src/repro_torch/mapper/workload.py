"""Private copy of ``repro.mapper.workload`` for the PyTorch port (``import
repro_torch`` loads nothing of ``repro``); only intra-package imports
differ; ``from_model_config`` takes the port's ``ModelConfig``.

Workload-graph front-end of the mapper (DESIGN.md §16).

Every schedulable workload — the paper's CNN layer tables
(:mod:`repro.core.cnn_workloads`) *and* the LM configs' per-layer GEMM
sites — lowers to one uniform representation: a DAG of
:class:`GemmNode`\\ s.  A node is an im2col-style integer GEMM (``rows x
k x cols``, ``groups`` for depthwise); a dependency edge means the
producer's outputs feed the consumer's activations, so the consumer
cannot start streaming before the producer drains.

The graph is *batch-free*: ``rows`` counts the output positions of ONE
inference (one image, one sequence).  Input batching is a scheduling
decision — :class:`repro.mapper.mapping.MapperOptions.batch` multiplies
the streamed rows at tiling time, which is exactly how the hardware
amortizes a programmed weight tile over many inputs.

Lowering rules:

* ``from_layers`` — a CNN layer list becomes a dependency *chain* (the
  paper's batch-1 inference order; branch-level parallelism inside
  inception-style modules is not reconstructed from the flat table).
* ``from_model_config`` — an LM :class:`~repro.models.common.ModelConfig`
  becomes per-layer GEMM sites with the real intra-layer parallelism:
  ``attn.wq``/``wk``/``wv`` (or the MLA ``wq``/``wdkv`` → ``wuk``/``wuv``
  chain) fan out from the layer input, join at ``attn.wo``, feed the FFN
  (fused SwiGLU ``ffn.wi`` → ``ffn.wo``; MoE prices the *active* experts
  per token and keeps the router digital, matching the engine's default
  site policy), and the last layer feeds ``lm_head``.  Node names carry
  the dotted site (``L3.attn.wq``) so timelines read like engine traces.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.cnn_workloads import GemmLayer

if TYPE_CHECKING:  # annotation only — keeps core/mapper import-light
    from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class GemmNode:
    """One tiled-GEMM site of a workload DAG (batch-free, see module doc)."""

    name: str
    rows: int      # output positions per inference (im2col rows / tokens)
    k: int         # dot-product length per group
    cols: int      # output channels per group
    groups: int = 1
    deps: Tuple[str, ...] = ()
    site: Optional[str] = None  # dotted engine site name, when lowered from an LM

    def __post_init__(self):
        if min(self.rows, self.k, self.cols, self.groups) < 1:
            raise ValueError(f"non-positive GEMM dims in node {self.name!r}: {self}")

    @property
    def dots(self) -> int:
        return self.rows * self.cols * self.groups

    @property
    def macs(self) -> int:
        return self.dots * self.k


class WorkloadGraph:
    """A validated DAG of :class:`GemmNode`\\ s, iterated in topological order."""

    def __init__(self, name: str, nodes: Sequence[GemmNode]):
        self.name = name
        self._nodes: Dict[str, GemmNode] = {}
        for node in nodes:
            if node.name in self._nodes:
                raise ValueError(f"duplicate node name {node.name!r} in {name!r}")
            self._nodes[node.name] = node
        for node in nodes:
            for dep in node.deps:
                if dep not in self._nodes:
                    raise ValueError(
                        f"node {node.name!r} depends on unknown node {dep!r}"
                    )
        self._topo = self._toposort()

    # -- construction --------------------------------------------------------
    @classmethod
    def from_layers(
        cls, layers: Iterable[GemmLayer], name: str = "cnn"
    ) -> "WorkloadGraph":
        """A CNN layer list as a dependency chain (paper §V-B batch-1 order)."""
        nodes: List[GemmNode] = []
        prev: Tuple[str, ...] = ()
        for layer in layers:
            nodes.append(
                GemmNode(
                    name=layer.name,
                    rows=layer.rows,
                    k=layer.k,
                    cols=layer.cols,
                    groups=layer.groups,
                    deps=prev,
                )
            )
            prev = (layer.name,)
        return cls(name, nodes)

    @classmethod
    def from_model_config(
        cls,
        cfg: "ModelConfig",
        *,
        seq_len: int,
        name: Optional[str] = None,
    ) -> "WorkloadGraph":
        """Lower an LM config's per-layer weight-GEMM sites to a DAG.

        Covers the dense/GQA, MoE (active experts only; the router stays
        digital, mirroring the engine's default ``photonic_exclude``) and
        MLA attention families.  Encoder-decoder, SSM and hybrid configs
        have recurrent/scan GEMM structure the tile mapper does not model
        yet and are rejected eagerly.
        """
        if (
            cfg.encoder_decoder
            or cfg.attn_every
            or cfg.slstm_every
            or cfg.cross_attn_every
        ):
            raise NotImplementedError(
                f"cannot lower family {cfg.family!r} ({cfg.arch_id}): "
                "encoder-decoder / hybrid / cross-attention GEMM structure "
                "is not mapper-schedulable yet"
            )
        if cfg.family in ("ssm", "audio"):
            raise NotImplementedError(
                f"cannot lower family {cfg.family!r} ({cfg.arch_id})"
            )
        head_dim = cfg.head_dim or cfg.d_model // cfg.num_heads
        d = cfg.d_model
        t = seq_len
        nodes: List[GemmNode] = []
        prev: Tuple[str, ...] = ()

        def add(nm: str, rows: int, k: int, cols: int, deps: Tuple[str, ...]):
            site = nm.split(".", 1)[1] if "." in nm else nm
            nodes.append(
                GemmNode(name=nm, rows=rows, k=k, cols=cols, deps=deps, site=site)
            )

        for i in range(cfg.num_layers):
            p = f"L{i}"
            if cfg.mla:
                q_cols = cfg.num_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
                add(f"{p}.attn.wq", t, d, q_cols, prev)
                kv_cols = cfg.kv_lora_rank + cfg.qk_rope_head_dim
                add(f"{p}.attn.wdkv", t, d, kv_cols, prev)
                add(
                    f"{p}.attn.wuk", t, cfg.kv_lora_rank,
                    cfg.num_heads * cfg.qk_nope_head_dim, (f"{p}.attn.wdkv",),
                )
                add(
                    f"{p}.attn.wuv", t, cfg.kv_lora_rank,
                    cfg.num_heads * cfg.v_head_dim, (f"{p}.attn.wdkv",),
                )
                add(
                    f"{p}.attn.wo", t, cfg.num_heads * cfg.v_head_dim, d,
                    (f"{p}.attn.wq", f"{p}.attn.wuk", f"{p}.attn.wuv"),
                )
            else:
                add(f"{p}.attn.wq", t, d, cfg.num_heads * head_dim, prev)
                add(f"{p}.attn.wk", t, d, cfg.num_kv_heads * head_dim, prev)
                add(f"{p}.attn.wv", t, d, cfg.num_kv_heads * head_dim, prev)
                add(
                    f"{p}.attn.wo", t, cfg.num_heads * head_dim, d,
                    (f"{p}.attn.wq", f"{p}.attn.wk", f"{p}.attn.wv"),
                )
            attn_out = (f"{p}.attn.wo",)

            wi_mult = 2 if cfg.ffn_act == "swiglu" else 1  # fused SwiGLU bank
            if cfg.num_experts > 0:
                # Active experts only: each token streams through its top-k
                # routed experts, so the streamed rows are t * top_k per
                # expert bank (capacity effects ignored — the mapper prices
                # the GEMM work, not the dispatch).  Router: digital.
                f = cfg.moe_d_ff or cfg.d_ff
                rows = t * cfg.num_experts_per_tok
                add(f"{p}.ffn.wi", rows, d, wi_mult * f, attn_out)
                add(f"{p}.ffn.wo", rows, f, d, (f"{p}.ffn.wi",))
                layer_out = [f"{p}.ffn.wo"]
                if cfg.num_shared_experts:
                    fs = cfg.num_shared_experts * (cfg.moe_d_ff or cfg.d_ff)
                    add(f"{p}.ffn.shared.wi", t, d, wi_mult * fs, attn_out)
                    add(f"{p}.ffn.shared.wo", t, fs, d, (f"{p}.ffn.shared.wi",))
                    layer_out.append(f"{p}.ffn.shared.wo")
                prev = tuple(layer_out)
            else:
                add(f"{p}.ffn.wi", t, d, wi_mult * cfg.d_ff, attn_out)
                add(f"{p}.ffn.wo", t, cfg.d_ff, d, (f"{p}.ffn.wi",))
                prev = (f"{p}.ffn.wo",)

        add("lm_head", t, d, cfg.vocab_size, prev)
        return cls(name or cfg.arch_id, nodes)

    # -- access --------------------------------------------------------------
    @property
    def nodes(self) -> Tuple[GemmNode, ...]:
        return tuple(self._nodes.values())

    def __len__(self) -> int:
        return len(self._nodes)

    def __getitem__(self, name: str) -> GemmNode:
        return self._nodes[name]

    def topological(self) -> Tuple[GemmNode, ...]:
        """Nodes in a dependency-respecting order (stable: insertion order
        breaks ties), validated acyclic at construction."""
        return self._topo

    @property
    def total_macs(self) -> int:
        return sum(n.macs for n in self._nodes.values())

    def _toposort(self) -> Tuple[GemmNode, ...]:
        indeg = {n: len(self._nodes[n].deps) for n in self._nodes}
        consumers: Dict[str, List[str]] = {n: [] for n in self._nodes}
        for node in self._nodes.values():
            for dep in node.deps:
                consumers[dep].append(node.name)
        order: List[GemmNode] = []
        ready = [n for n in self._nodes if indeg[n] == 0]  # insertion-ordered
        while ready:
            nm = ready.pop(0)
            order.append(self._nodes[nm])
            for c in consumers[nm]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(order) != len(self._nodes):
            cyclic = sorted(n for n in self._nodes if indeg[n] > 0)
            raise ValueError(f"dependency cycle through {cyclic}")
        return tuple(order)

    def __repr__(self):
        return (
            f"WorkloadGraph({self.name!r}, nodes={len(self)}, "
            f"macs={self.total_macs / 1e9:.2f}G)"
        )

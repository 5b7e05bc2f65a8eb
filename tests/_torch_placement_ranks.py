"""Rank bodies for the port's placement tests (``tests/test_torch_placement.py``).

Each function runs in every rank of a group of four that
``repro_torch.launch.mesh.spawn`` starts on the ``gloo`` backend (CPU), as
the (data 2, model 2) mesh, and returns plain numpy / Python values.  This
module imports no ``jax``.
"""

import dataclasses
import os

import numpy as np
import torch

from _torch_train_tp_ranks import _leaves, _np, _train, ideal_dpu, smwa_dpu
from repro_torch.analysis import contracts

BATCH, PROMPT, MAX_SEQ, STEPS = 4, 8, 16, 4


def _mesh():
    from repro_torch.launch import mesh as M

    return M.build_mesh((2, 2), ("data", "model"), device="cpu")


def _counts():
    return dict(psum=contracts.ALL_REDUCES["psum_int_gemm"], tp_rows=contracts.ROW_GATHERS["tp_rows"],
                outputs=contracts.ROW_GATHERS["outputs"], amax=contracts.SCALE_REDUCTIONS["amax"],
                heads=contracts.HEAD_GATHERS["heads"])


def serve_cfg(dpu):
    """qwen2-0.5b's smoke config padded for a model degree of 2 (8 q heads
    and 2 KV heads: 4 and 1 a rank), photonic on the kernel backend (its
    twin on the CPU)."""
    from repro_torch.models import registry

    arch = registry.get("qwen2-0.5b")
    cfg = dataclasses.replace(arch.smoke_config.pad_for_mesh(2), photonic=dpu, photonic_backend="kernel")
    return arch, cfg


def _inputs(cfg):
    rng = np.random.default_rng(7)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int64))
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, (STEPS, BATCH, 1)).astype(np.int64))
    return prompt, steps


def _decode_run(arch, cfg, params, prompt, steps, place=None):
    """The prefill's last logits and each decode step's, global; with
    ``place`` (a placement) the tokens go in as this rank's rows and the
    logits come back gathered."""
    from repro_torch.runtime import sharding as shd

    tok_axes = ("batch", None)
    logit_axes = ("batch", None, None)
    if place is not None:
        prompt = shd.place_tree(prompt, tok_axes)
    with torch.no_grad():
        logits, cache = arch.prefill(params, {"tokens": prompt}, cfg, MAX_SEQ)
        out = [logits]
        for t in steps:
            if place is not None:
                t = shd.place_tree(t, tok_axes)
            logits, cache = arch.decode(params, t, cache, cfg)
            out.append(logits)
    if place is not None:
        out = [shd.gather_tree(x, logit_axes) for x in out]
    return [_np(x) for x in out], {k: tuple(v.shape) for k, v in cache["layers"].items()}


def decode_suite(rank, world):
    """Prefill and four decode steps of the smoke config on the (2, 2)
    mesh, TP over "model", ideal and SMWA: the replicated program and the
    placed one (rows over "data", heads over "model"), and on ideal TP = 1
    (no mesh scope at all)."""
    from repro_torch.models.common import init_params
    from repro_torch.photonic import sharded
    from repro_torch.runtime import sharding as shd

    mesh = _mesh()
    out = {"coords": (mesh.get_local_rank("data"), mesh.get_local_rank("model"))}
    for name, dpu in (("ideal", ideal_dpu()), ("SMWA", smwa_dpu())):
        arch, cfg = serve_cfg(dpu)
        params = init_params(cfg, 0, "cpu", defs=arch.param_defs(cfg))
        prompt, steps = _inputs(cfg)
        sizes = {"batch": BATCH, "heads": cfg.n_q_heads, "kv_heads": cfg.num_kv_heads}
        with shd.use_rules(mesh), sharded.tensor_parallel(mesh, "model"):
            contracts.reset_all_reduces()
            rep, rep_cache = _decode_run(arch, cfg, params, prompt, steps)
            rep_counts = _counts()
            contracts.reset_all_reduces()
            with shd.placement(mesh, sizes) as pl:
                placed, placed_cache = _decode_run(arch, cfg, params, prompt, steps, place=pl)
            placed_counts = _counts()
            fallbacks = shd.fallback_log()
        res = dict(replicated=rep, placed=placed, replicated_counts=rep_counts, placed_counts=placed_counts,
                   replicated_cache=rep_cache, placed_cache=placed_cache, fallbacks=fallbacks,
                   blocks={k: (b.part, b.index, b.count, b.size) for k, b in pl.blocks.items()})
        if name == "ideal":
            res["tp1"], _ = _decode_run(arch, cfg, params, prompt, steps)
        out[name] = res
    return out


def _digital_decode(out, mesh):
    """The same run with no engine: the dense path gathers the heads over
    "model" before ``attn.wo``."""
    from repro_torch.models.common import init_params
    from repro_torch.runtime import sharding as shd

    arch, cfg = serve_cfg(None)
    params = init_params(cfg, 0, "cpu", defs=arch.param_defs(cfg))
    prompt, steps = _inputs(cfg)
    sizes = {"batch": BATCH, "heads": cfg.n_q_heads, "kv_heads": cfg.num_kv_heads}
    with shd.use_rules(mesh):
        rep, _ = _decode_run(arch, cfg, params, prompt, steps)
        contracts.reset_all_reduces()
        with shd.placement(mesh, sizes) as pl:
            placed, _ = _decode_run(arch, cfg, params, prompt, steps, place=pl)
        out["digital"] = dict(replicated=rep, placed=placed, counts=_counts())


def train_suite(rank, world, root):
    """``train(mesh=(2, 2), tp_axis="model")`` on the smoke config, ideal
    channel: two steps with the rows placed against two replicated steps
    (``place_rows=False``); a placed run killed at step 1 and resumed,
    against the uninterrupted placed run; two microbatches, digital,
    placed and replicated; the ZeRO-1 update against the replicated one
    given the same gradient; the digital decode."""
    from _torch_train_tp_ranks import smoke

    mesh = _mesh()
    out = {}
    arch, cfg = smoke()
    rep = _train(arch, cfg, os.path.join(root, "rep"), mesh, "model", steps=2, place_rows=False)
    contracts.reset_all_reduces()
    placed = _train(arch, cfg, os.path.join(root, "placed"), mesh, "model", steps=2)
    counts = _counts()
    try:
        _train(arch, cfg, os.path.join(root, "killed"), mesh, "model", steps=2, ckpt_every=1, fail_at_step=1)
        crashed = False
    except RuntimeError:
        crashed = True
    resumed = _train(arch, cfg, os.path.join(root, "killed"), mesh, "model", steps=2, ckpt_every=1)
    out["train"] = dict(rep_losses=rep["losses"], rep_params=_leaves(rep["params"]), losses=placed["losses"],
                        params=_leaves(placed["params"]), counts=counts, crashed=crashed,
                        resumed_losses=resumed["losses"], resumed_params=_leaves(resumed["params"]),
                        resumed_final=resumed["final_step"])
    # two microbatches, digital: the placed run splits each rank's rows
    _, digital = smoke(photonic=None)
    mbs = {place: _train(arch, digital, os.path.join(root, f"mb{place}"), mesh, steps=2, microbatches=2,
                         place_rows=place) for place in (False, True)}
    out["microbatches"] = {place: _leaves(r["params"]) for place, r in mbs.items()}
    out["zero1"] = zero1_run(mesh, arch, cfg)
    _digital_decode(out, mesh)
    return out


def zero1_run(mesh, arch, cfg):
    """Two AdamW steps from the same gradients (seeded, equal on every
    rank), replicated and ZeRO-1 over "data": the parameters and the
    moment blocks."""
    from repro_torch._tree import tree_items, tree_map
    from repro_torch.models.common import axes_tree, init_params
    from repro_torch.optim import adamw

    params = init_params(cfg, 0, "cpu", defs=arch.param_defs(cfg))
    shards = adamw.zero1(params, axes_tree(arch.param_defs(cfg)), mesh)
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=3)
    gen = torch.Generator().manual_seed(5)
    grads = [tree_map(lambda p: torch.randn(p.shape, generator=gen).to(p.dtype), params) for _ in range(2)]
    p_rep, s_rep = params, adamw.init(params)
    p_z, s_z = params, adamw.init(params, shards)
    for g in grads:
        p_rep, s_rep, _ = adamw.update(opt, p_rep, g, s_rep)
        p_z, s_z, _ = adamw.update(opt, p_z, g, s_z, shards=shards)
    dims = tree_items(shards.dims)
    mine = {k: _np(shards.take(v, dims[k])) for k, v in tree_items(s_rep.mu).items()}
    return dict(rep=_leaves(p_rep), zero1=_leaves(p_z), mu=_leaves(s_z.mu), mu_block_of_rep=mine,
                shapes={k: (tuple(v.shape), tuple(tree_items(s_z.mu)[k].shape), dims[k])
                        for k, v in tree_items(params).items()},
                count=shards.count, part=shards.part)

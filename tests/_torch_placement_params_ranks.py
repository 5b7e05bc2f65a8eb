"""Rank bodies for the port's parameter-placement tests
(``tests/test_torch_placement_params.py``).

Each function runs in every rank of a group of four that
``repro_torch.launch.mesh.spawn`` starts on the ``gloo`` backend (CPU), as
the (data 2, model 2) mesh, and returns plain numpy / Python values.  This
module imports no ``jax``: the reference's parameters arrive as numpy
trees.
"""

import contextlib
import dataclasses

import numpy as np
import torch

from _torch_placement_ranks import BATCH, MAX_SEQ, _inputs, _mesh
from _torch_train_tp_ranks import _np, ideal_dpu, smwa_dpu
from repro_torch.analysis import contracts

DECODE_STEPS = 2  # of the placement tests' four decode tokens
TRAIN_SEQ, TRAIN_STEPS = 16, 2
TRUE_VOCAB, PADDED_VOCAB = 10, 12


def _counts():
    return dict(psum=contracts.ALL_REDUCES["psum_int_gemm"], amax=contracts.SCALE_REDUCTIONS["amax"],
                outputs=contracts.ROW_GATHERS["outputs"], tp_rows=contracts.ROW_GATHERS["tp_rows"],
                heads=contracts.HEAD_GATHERS["heads"], **contracts.PARAM_REDUCES)


def _cfg(dpu):
    """qwen2-0.5b's smoke config (8 q / 2 KV heads, d_ff 512, vocab 256:
    the (2, 2) mesh's model degree divides them all), photonic on the
    kernel backend's CPU twin, or digital without ``dpu``."""
    from repro_torch.models import registry

    arch = registry.get("qwen2-0.5b")
    cfg = arch.smoke_config.pad_for_mesh(2)
    if dpu is not None:
        cfg = dataclasses.replace(cfg, photonic=dpu, photonic_backend="kernel")
    return arch, cfg


def _params(params_np, cfg):
    from repro_torch.weights import params_from_jax

    return params_from_jax(params_np, cfg, "cpu")


def _shape(kind, seq=MAX_SEQ):
    from repro_torch.models.registry import ShapeSpec

    return ShapeSpec(f"smoke_{kind}", seq, BATCH, kind)


def _serve(arch, cfg, params, mesh, *, place, tp):
    """The prefill's last logits and each decode step's, global, with the
    mesh's rules active; ``tp``: routed GEMMs under TP over "model";
    ``place`` "all": the rows, heads, ``d_ff`` and vocab placed, the
    parameters cut to this rank's blocks (``place_params``), "rows": the
    rows alone; the tokens cut to this rank's rows, the logits gathered
    over rows and vocab.  Also the cache leaves' shapes and the parameter
    bytes the run held."""
    from repro_torch.models.common import axes_tree
    from repro_torch.photonic import sharded
    from repro_torch.runtime import sharding as shd

    prompt, steps = _inputs(cfg)
    steps = steps[:DECODE_STEPS]
    tok_axes, logit_axes = ("batch", None), ("batch", None, "vocab")
    with contextlib.ExitStack() as scopes:
        scopes.enter_context(shd.use_rules(mesh))
        if tp:
            scopes.enter_context(sharded.tensor_parallel(mesh, "model"))
        if place:
            sizes = arch.placement_sizes(cfg, _shape("decode")) if place == "all" else {"batch": BATCH}
            scopes.enter_context(shd.placement(mesh, sizes))
            params = shd.place_params(params, axes_tree(arch.param_defs(cfg)))
            prompt = shd.place_tree(prompt, tok_axes)
        with torch.no_grad():
            logits, cache = arch.prefill(params, {"tokens": prompt}, cfg, MAX_SEQ)
            out = [logits]
            for t in steps:
                logits, cache = arch.decode(params, shd.place_tree(t, tok_axes) if place else t, cache, cfg)
                out.append(logits)
        if place:
            out = [shd.gather_tree(x, logit_axes) for x in out]
        held = sum(t.numel() * t.element_size() for t in _tensors(params))
    return [_np(x) for x in out], {k: tuple(v.shape) for k, v in cache["layers"].items()}, held


def _tensors(tree):
    from repro_torch._tree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def serve_suite(rank, world, params_np):
    """Prefill and decode of the smoke config on the (2, 2) mesh from the
    reference's parameters: on the ideal channel and under SMWA with its
    noise key (``noise_seed``), the replicated TP program (whole
    parameters, nothing placed) against the placed one; digital, the
    unsharded run against the placed one; SMWA without a TP scope, the
    rows alone placed against everything placed (the column GEMMs then
    take the fused single-device stream at their column origins)."""
    mesh = _mesh()
    out = {"coords": (mesh.get_local_rank("data"), mesh.get_local_rank("model"))}
    cases = (("ideal", ideal_dpu(), True), ("SMWA", smwa_dpu(), True), ("digital", None, False),
             ("SMWA without TP", smwa_dpu(), False))
    for name, dpu, tp in cases:
        arch, cfg = _cfg(dpu)
        params = _params(params_np, cfg)
        contracts.reset_all_reduces()
        base = "rows" if name == "SMWA without TP" else None
        rep, rep_cache, rep_bytes = _serve(arch, cfg, params, mesh, place=base, tp=tp)
        rep_counts = _counts()
        contracts.reset_all_reduces()
        placed, placed_cache, placed_bytes = _serve(arch, cfg, params, mesh, place="all", tp=tp)
        out[name] = dict(replicated=rep, placed=placed, replicated_counts=rep_counts, placed_counts=_counts(),
                         replicated_cache=rep_cache, placed_cache=placed_cache, replicated_bytes=rep_bytes,
                         placed_bytes=placed_bytes)
    return out


# ---------------------------------------------------------------------------
# The dry run's train step on placed parameters
# ---------------------------------------------------------------------------
def _batches(cfg):
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (TRAIN_STEPS, BATCH, TRAIN_SEQ + 1))
    return [{"tokens": torch.from_numpy(t[:, :-1]).long(), "labels": torch.from_numpy(t[:, 1:]).long()} for t in toks]


def _grads(arch, cfg, params, batch):
    from repro_torch.runtime.train_loop import _mean_over_rows, _value_and_grad

    loss, grads = _value_and_grad(lambda p, b: arch.loss(p, b, cfg), params, batch)
    return _mean_over_rows(loss, grads)


def train_suite(rank, world, params_np):
    """The dry run's train step (``dryrun.build_step``: parameters placed
    by their ``param_axes``, ZeRO-1 moments, the placed gradient norm) on
    the (2, 2) mesh for ``TRAIN_STEPS`` steps, digital and on the ideal
    channel (TP over "model"), against the replicated step on whole
    parameters (every rank the same); the first step's gradient placed
    against this rank's blocks of the replicated one; the parameters
    placed against the blocks of the replicated run's."""
    from repro_torch._tree import tree_items
    from repro_torch.launch import dryrun
    from repro_torch.models.common import axes_tree
    from repro_torch.optim import adamw
    from repro_torch.photonic import sharded
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.train_loop import build_train_step

    mesh = _mesh()
    out = {}
    for name, dpu in (("digital", None), ("ideal", ideal_dpu())):
        arch, cfg = _cfg(dpu)
        shape = _shape("train", TRAIN_SEQ)
        defs = arch.param_defs(cfg)
        axes = axes_tree(defs)
        params = _params(params_np, cfg)
        batches = _batches(cfg)
        opt_cfg = adamw.AdamWConfig()
        step = build_train_step(lambda p, b: arch.loss(p, b, cfg), opt_cfg)
        p_rep, s_rep, rep_losses, rep_norms = params, adamw.init(params), [], []
        _, rep_grads = _grads(arch, cfg, params, batches[0])
        for b in batches:
            p_rep, s_rep, m = step(p_rep, s_rep, b)
            rep_losses.append(float(m["loss"]))
            rep_norms.append(float(m["grad_norm"]))
        contracts.reset_all_reduces()
        placed_step = dryrun.build_step(arch, cfg, shape, mesh)
        sizes = arch.placement_sizes(cfg, shape)
        batch_axes = {"tokens": ("batch", None), "labels": ("batch", None)}
        with shd.use_rules(mesh):
            with shd.placement(mesh, sizes):
                p = shd.place_params(params, axes)
                blocks_of = lambda tree: shd.place_params(tree, axes)  # noqa: E731
                local = [shd.place_tree(b, batch_axes) for b in batches]
                with contextlib.ExitStack() as scopes:
                    if dpu is not None:
                        scopes.enter_context(sharded.tensor_parallel(mesh, "model"))
                    _, grads = _grads(arch, cfg, p, local[0])
                want_grads = blocks_of(rep_grads)
                want_params = blocks_of(p_rep)
            contracts.reset_all_reduces()
            s = adamw.init(p, adamw.zero1(defs, axes, mesh))
            losses, norms = [], []
            for b in local:
                p, s, m = placed_step(p, s, b)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        lrs = [float(adamw.schedule_lr(opt_cfg, torch.tensor(i + 1))) for i in range(TRAIN_STEPS)]
        out[name] = dict(losses=losses, rep_losses=rep_losses, norms=norms, rep_norms=rep_norms, lrs=lrs,
                         params={k: _np(v) for k, v in tree_items(p).items()},
                         want_params={k: _np(v) for k, v in tree_items(want_params).items()},
                         grads={k: _np(v) for k, v in tree_items(grads).items()},
                         want_grads={k: _np(v) for k, v in tree_items(want_grads).items()},
                         counts=_counts())
    out["loss"] = vocab_loss(mesh)
    out["heads"] = train_heads(mesh)
    return out


def _train_on_mesh(cfg, mesh, root, batch, place):
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import registry
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainConfig, train

    contracts.reset_all_reduces()
    res = train(arch=registry.get("qwen2-0.5b"), model_cfg=cfg,
                data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=batch, seed=1),
                train_cfg=TrainConfig(steps=1, ckpt_every=1000, ckpt_dir=root, log_every=100),
                opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=3), mesh=mesh, tp_axis="model",
                place_rows=place, log=lambda m: None, device="cpu")
    return dict(losses=res["losses"], params={k: _np(v) for k, v in _items(res["params"])}, counts=_counts())


def _items(tree):
    from repro_torch._tree import tree_items

    return tree_items(tree).items()


def train_heads(mesh):
    """``train(mesh=(2, 2), tp_axis="model")`` on the padded smoke config,
    ideal channel, one step, whose parameters stay whole: a batch of 3
    (the data degree does not divide it, so only the heads are placed)
    against the replicated program (``place_rows=False``), and a batch of 4
    (rows and heads placed) against it."""
    import tempfile

    _, cfg = _cfg(ideal_dpu())
    out = {}
    with tempfile.TemporaryDirectory() as root:
        for batch in (3, 4):
            runs = {place: _train_on_mesh(cfg, mesh, f"{root}/{batch}{place}", batch, place) for place in (False, True)}
            out[batch] = runs
    return out


def suite(rank, world, params_np):
    """:func:`serve_suite` and :func:`train_suite` in one group."""
    return {"serve": serve_suite(rank, world, params_np), "train": train_suite(rank, world, params_np)}


def vocab_loss(mesh):
    """The vocab-parallel loss of seeded logits over a padded vocab
    (``PADDED_VOCAB`` columns, ``TRUE_VOCAB`` real: the model block of rank
    1 holds the two padded ones), its value and its gradient block, against
    the replicated loss and this rank's block of its gradient; labels land
    in both blocks."""
    from repro_torch.models.common import softmax_cross_entropy
    from repro_torch.runtime import sharding as shd

    gen = torch.Generator().manual_seed(9)
    logits = torch.randn(2, 3, PADDED_VOCAB, generator=gen)
    labels = torch.randint(0, TRUE_VOCAB, (2, 3), generator=gen)
    labels[0, 0], labels[1, 2] = 0, TRUE_VOCAB - 1
    whole = logits.clone().requires_grad_(True)
    want = softmax_cross_entropy(whole, labels, TRUE_VOCAB)
    want.backward()
    with shd.placement(mesh, {"vocab": PADDED_VOCAB}) as pl:
        b = pl.blocks["vocab"]
        mine = b.take(logits, 2).clone().requires_grad_(True)
        got = softmax_cross_entropy(mine, labels, TRUE_VOCAB)
        got.backward()
        want_grad = b.take(whole.grad, 2)
    return dict(loss=float(got), want=float(want), grad=_np(mine.grad), want_grad=_np(want_grad),
                block=(b.index, b.local))

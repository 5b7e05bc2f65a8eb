"""Rank bodies for the port's data- and tensor-parallel training tests.

Each function runs in every rank of a group that
``repro_torch.launch.mesh.spawn`` starts on the ``gloo`` backend (CPU),
and returns plain numpy / Python values for the test process to check.
This module imports no ``jax``, so the ranks start quickly.
"""

import dataclasses
import os

import numpy as np
import torch

from repro_torch.analysis import contracts

DATA = dict(seq_len=16, global_batch=4, seed=1)
OPT = dict(lr=3e-3, warmup_steps=1, total_steps=3)
SITE = "attn.wq"


def ideal_dpu():
    from repro_torch.core.dpu import DPUConfig

    return DPUConfig(organization="SMWA", bits=4, datarate_gs=5.0)


def smwa_dpu():
    from repro_torch.core.dpu import DPUConfig
    from repro_torch.noise.channel import build_channel_model

    return DPUConfig(organization="SMWA", bits=4, dpe_size=16, channel=build_channel_model("SMWA", n=16),
                     noise_seed=3)


def smoke(**kw):
    """qwen2-0.5b's smoke config on the ideal channel and the kernel
    backend (its twin on the CPU)."""
    from repro_torch.models import registry

    arch = registry.get("qwen2-0.5b")
    cfg = dataclasses.replace(arch.smoke_config, **{"photonic": ideal_dpu(), "photonic_backend": "kernel", **kw})
    return arch, cfg


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _leaves(tree):
    from repro_torch._tree import tree_items

    return {k: _np(v) for k, v in tree_items(tree).items()}


def _train(arch, cfg, d, mesh=None, tp_axis=None, steps=3, **kw):
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainConfig, train

    return train(
        arch=arch, model_cfg=cfg, data_cfg=DataConfig(vocab_size=cfg.vocab_size, **DATA),
        train_cfg=TrainConfig(steps=steps, ckpt_every=kw.pop("ckpt_every", 1000), ckpt_dir=str(d), log_every=100,
                              async_checkpoint=kw.pop("async_checkpoint", True),
                              microbatches=kw.pop("microbatches", 1)),
        opt_cfg=AdamWConfig(**OPT), mesh=mesh, tp_axis=tp_axis, log=lambda m: None, device="cpu", **kw,
    )


def _counted_train(*a, **kw):
    contracts.reset_all_reduces()
    out = _train(*a, **kw)
    return out, contracts.ALL_REDUCES["psum_int_gemm"], contracts.ROW_GATHERS["tp_rows"]


def _saves(fn):
    """``fn()`` with ``ckpt.save`` counted; returns (result, saves)."""
    from repro_torch.checkpoint import ckpt

    save, n = ckpt.save, {"n": 0}

    def counting(*a, **k):
        n["n"] += 1
        return save(*a, **k)

    ckpt.save = counting
    try:
        return fn(), n["n"]
    finally:
        ckpt.save = save


def _global_batch(cfg, step=0):
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens, make_global_batch

    return make_global_batch(SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, **DATA)), step, "cpu")


def dp_step_run(mesh, tp_axis, compress=False, photonic=True):
    """One ``make_dp_train_step`` step from ``init_params`` seed 0 on the
    global batch of step 0 (the smoke config digital without
    ``photonic``): (loss, grad norm, params)."""
    from repro_torch.models.common import init_params
    from repro_torch.optim import adamw
    from repro_torch.runtime.dp_step import make_dp_train_step

    arch, cfg = smoke() if photonic else smoke(photonic=None)
    params = init_params(cfg, 0, "cpu")
    step = make_dp_train_step(lambda p, b: arch.loss(p, b, cfg), adamw.AdamWConfig(**OPT), mesh,
                              compress_grads=compress, tp_axis=tp_axis)
    p, _, loss, gnorm = step(params, adamw.init(params), _global_batch(cfg))
    return float(loss), float(gnorm), _leaves(p)


def one_rank_suite(rank, world, params_np, batch_np):
    """The port's DP step on a (1, 1) mesh from the given (reference)
    parameters and batch: loss, grad norm and updated parameters."""
    from repro_torch.launch import mesh as M
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.runtime.dp_step import make_dp_train_step
    from repro_torch.weights import params_from_jax

    arch = registry.get("qwen2-0.5b")
    cfg = dataclasses.replace(arch.smoke_config, remat=False)
    params = params_from_jax(params_np, cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    step = make_dp_train_step(lambda p, b: arch.loss(p, b, cfg), adamw.AdamWConfig(), M.make_smoke_mesh(device="cpu"))
    p, _, loss, gnorm = step(params, adamw.init(params), batch)
    return float(loss), float(gnorm), _leaves(p)


def remat_outside_scope(mesh):
    """The loss's forward under ``tensor_parallel`` and its backward after
    the scope closed (as on the card, where autograd recomputes on its own
    thread): all-reduces after the forward and after the backward, and
    whether the gradients equal the unsharded ones bitwise."""
    from repro_torch._tree import tree_items, tree_unflatten
    from repro_torch.models.common import init_params
    from repro_torch.photonic import tensor_parallel
    from repro_torch.runtime.train_loop import _value_and_grad

    arch, cfg = smoke()
    params = init_params(cfg, 0, "cpu")
    batch = _global_batch(cfg)
    _, want = _value_and_grad(lambda p, b: arch.loss(p, b, cfg), params, batch)
    leaves = [p.detach().requires_grad_(True) for p in tree_items(params).values()]
    contracts.reset_all_reduces()
    with tensor_parallel(mesh, "model"):
        loss = arch.loss(tree_unflatten(params, leaves), batch, cfg)
    forward = contracts.ALL_REDUCES["psum_int_gemm"]
    loss.backward()
    same = all(torch.equal(p.grad, w) for p, w in zip(leaves, tree_items(want).values()))
    return forward, contracts.ALL_REDUCES["psum_int_gemm"], same


def pair_suite(rank, world, root):
    """A group of two: ``train(mesh=(1, 2), tp_axis="model")`` against the
    unsharded ``train()`` on the same rank, with its collective counts and
    checkpoint writers; a run killed at step 6 and resumed against an
    uninterrupted run on the mesh; the DP step on a (2, 1) mesh."""
    from repro_torch.launch import mesh as M

    out = {}
    arch, cfg = smoke()
    mesh = M.build_mesh((1, world), ("data", "model"), device="cpu")
    base, n_ar, n_rg = _counted_train(arch, cfg, os.path.join(root, f"unsharded{rank}"))
    out["unsharded"] = dict(losses=base["losses"], params=_leaves(base["params"]), all_reduces=n_ar)
    (tp, n_ar, n_rg), saves = _saves(lambda: _counted_train(arch, cfg, os.path.join(root, "tp"), mesh, "model"))
    out["tp"] = dict(losses=tp["losses"], params=_leaves(tp["params"]), all_reduces=n_ar, row_gathers=n_rg,
                     saves=saves, final_step=tp["final_step"])

    def run(d, **kw):
        return _train(arch, cfg, os.path.join(root, d), mesh, "model", steps=10, ckpt_every=3,
                      async_checkpoint=False, **kw)

    ref, ref_saves = _saves(lambda: run("ref"))
    try:
        _saves(lambda: run("ft", fail_at_step=6))
        out["failed"] = None
    except RuntimeError as e:
        out["failed"] = str(e)
    from repro_torch.checkpoint import ckpt

    out["latest_after_failure"] = ckpt.latest_step(os.path.join(root, "ft"))
    resumed, resumed_saves = _saves(lambda: run("ft"))
    out["resume"] = dict(ref_losses=ref["losses"], ref_params=_leaves(ref["params"]), losses=resumed["losses"],
                         params=_leaves(resumed["params"]), final_step=resumed["final_step"],
                         saves=(ref_saves, resumed_saves))
    out["remat_outside_scope"] = remat_outside_scope(mesh)
    dp = M.build_mesh((world, 1), ("data", "model"), device="cpu")
    out["dp"] = dp_step_run(dp, "model")
    out["dp_digital"] = dp_step_run(dp, "model", photonic=False)
    return out


def row_gemms(mesh):
    """``dense`` under ``tensor_parallel(mesh, "model")`` on rows the data
    axis splits (12) and on rows it does not divide (5), with the unsharded
    port beside: float weights and a K-sharded pack on the ideal channel
    (kernel backend), float weights under SMWA (``ref`` backend, as the
    reference's side runs).  Returns {name: (unsharded, tp, all-reduces,
    row gathers)} and the operands."""
    from repro_torch.models.common import ModelConfig, dense
    from repro_torch.photonic import PhotonicEngine, pack_dense, prepack_params, tensor_parallel

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 6, 64)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(64, 24)) / 8).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(24,)).astype(np.float32))
    out = {"x": _np(x), "w": _np(w), "b": _np(b)}
    eng = PhotonicEngine(dpu=ideal_dpu(), backend="kernel")
    defs = {"attn": {"wq": {"w": w, "b": b}}}
    local = prepack_params(defs, defs, eng, mesh=mesh, axis="model")["attn"]["wq"]
    whole = pack_dense({"w": w, "b": b}, eng)
    cases = [("ideal/float", ideal_dpu(), "kernel", {"w": w, "b": b}, {"w": w, "b": b}),
             ("ideal/packed", ideal_dpu(), "kernel", whole, local),
             ("SMWA/float", smwa_dpu(), "ref", {"w": w, "b": b}, {"w": w, "b": b})]
    for name, dpu, backend, unsharded, sharded in cases:
        cfg = ModelConfig(photonic=dpu, photonic_backend=backend)
        for rows, xs in (("split", x), ("odd", x[:1, :5])):
            base = dense(unsharded, xs, cfg, site=SITE, layer=1)
            contracts.reset_all_reduces()
            with tensor_parallel(mesh, "model"):
                tp = dense(sharded, xs, cfg, site=SITE, layer=1)
            out[f"{name}/{rows}"] = (_np(base), _np(tp), contracts.ALL_REDUCES["psum_int_gemm"],
                                     contracts.ROW_GATHERS["tp_rows"])
    return out


def grid_suite(rank, world, root):
    """A group of four on the (2, 2) ("data", "model") mesh: row-sharded
    TP GEMMs; ``train(mesh=, tp_axis="model", place_rows=False)`` (the
    replicated program) against the unsharded ``train()``; the DP step
    with TP, plain and int8-compressed."""
    from repro_torch.launch import mesh as M

    mesh = M.build_mesh((2, 2), ("data", "model"), device="cpu")
    out = {"coords": (mesh.get_local_rank("data"), mesh.get_local_rank("model")), "gemms": row_gemms(mesh)}
    arch, cfg = smoke()
    base = _train(arch, cfg, os.path.join(root, f"unsharded{rank}"), steps=2)
    (tp, n_ar, n_rg), saves = _saves(lambda: _counted_train(arch, cfg, os.path.join(root, "tp"), mesh, "model",
                                                            steps=2, place_rows=False))
    out["train"] = dict(base_losses=base["losses"], base_params=_leaves(base["params"]), losses=tp["losses"],
                        params=_leaves(tp["params"]), all_reduces=n_ar, row_gathers=n_rg, saves=saves)
    out["dp"] = dp_step_run(mesh, "model")
    out["dp_digital"] = dp_step_run(mesh, "model", photonic=False)
    out["dp_int8"] = dp_step_run(mesh, "model", compress=True)
    return out


def collectives_suite(rank, world, root, inputs):
    """A group of four on the (2, 2) mesh: ``compressed_psum`` and
    ``ring_int8_allreduce`` over groups of one, two and four ranks (the
    ``bf`` leaf as bf16); ``restore(shardings=)`` of a checkpoint rank 0
    wrote; ``make_global_batch(sharding=)``."""
    import torch.distributed as dist

    from repro_torch.checkpoint import ckpt
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens, make_global_batch
    from repro_torch.launch import mesh as M
    from repro_torch.optim.compress import compressed_psum, ring_int8_allreduce
    from repro_torch.runtime import sharding as shd

    groups = {1: dist.new_group([0]), 2: dist.new_group([0, 1]), 4: dist.group.WORLD}
    mine = {k: torch.from_numpy(v).to(torch.bfloat16) if k == "bf" else torch.from_numpy(v)
            for k, v in inputs[rank].items()}
    col = {}
    for n, group in groups.items():
        if rank >= n:
            continue
        for name, fn in (("psum", compressed_psum), ("ring", ring_int8_allreduce)):
            res = fn(dict(mine), group)
            assert all(res[k].dtype == mine[k].dtype for k in mine)
            col.update({f"{n}|{name}|{k}": _np(v) for k, v in res.items()})
    out = {"collectives": col}

    mesh = M.build_mesh((2, 2), ("data", "model"), device="cpu")
    gen = torch.Generator().manual_seed(0)
    tree = {"params": {"embed": torch.randn(10, 6, generator=gen), "w": torch.randn(6, 8, generator=gen),
                       "b": torch.randn(8, generator=gen).to(torch.bfloat16), "s": torch.randn(5, 3, generator=gen)},
            "step": torch.tensor(7, dtype=torch.int32)}
    axes = {"params": {"embed": ("batch", None), "w": (None, "d_ff"), "b": ("d_ff",), "s": ("batch", None)},
            "step": ()}
    if rank == 0:
        ckpt.save(root, 3, tree)
    dist.barrier()
    like = {"params": {k: torch.zeros_like(v) for k, v in tree["params"].items()}, "step": torch.tensor(0, dtype=torch.int32)}
    back = ckpt.restore(root, 3, like, shardings=shd.tree_shardings(mesh, like, axes))
    from repro_torch._tree import tree_items

    leaves, types = {}, []
    for key, d in tree_items(back).items():
        types.append(type(d).__name__)
        want = tree_items(tree)[key]
        local = want
        for axis, p in zip(mesh.mesh_dim_names, d.placements):
            if p.is_shard():
                chunks = torch.chunk(local, mesh.size(mesh.mesh_dim_names.index(axis)), dim=p.dim)
                i = mesh.get_local_rank(axis)
                local = chunks[i] if i < len(chunks) else local.narrow(p.dim, 0, 0)
        assert d.dtype == want.dtype
        leaves[key] = (_np(d.full_tensor()), _np(want), _np(d.to_local()), _np(local), [f"Shard({p.dim})" if p.is_shard() else "Replicate" for p in d.placements])
    out["restore"] = dict(leaves=leaves, types=types, placements={k: v[4] for k, v in leaves.items()})
    stream = SyntheticTokens(DataConfig(vocab_size=256, **DATA))
    rows = make_global_batch(stream, 0, "cpu", sharding=shd.NamedSharding(mesh, (("data",),)))
    out["batch_rows"] = {"tokens": rows["tokens"].numpy(), "global": stream.batch_at(0)["tokens"]}
    out["coords"] = (mesh.get_local_rank("data"), mesh.get_local_rank("model"))
    return out

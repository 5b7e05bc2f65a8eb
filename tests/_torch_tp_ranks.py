"""Rank bodies for the port's tensor-parallel tests.

Each function runs in every rank of a group that
``repro_torch.launch.mesh.spawn`` starts on the ``gloo`` backend (CPU),
and returns plain numpy / Python values for the test process to check.
This module imports no ``jax``, so the ranks start quickly.
"""

import dataclasses

import numpy as np
import torch

from repro_torch.analysis import contracts
from repro_torch.core.dpu import DPUConfig
from repro_torch.noise.channel import build_channel_model

SITE = "attn.wq"


def _channels():
    return {
        "ideal": DPUConfig(organization="SMWA", bits=4, dpe_size=16),
        "SMWA": DPUConfig(organization="SMWA", bits=4, dpe_size=16,
                          channel=build_channel_model("SMWA", n=16), noise_seed=3),
        "ASMW": DPUConfig(organization="ASMW", bits=4, dpe_size=16,
                          channel=build_channel_model("ASMW", n=16), noise_seed=3),
    }


def _operands(k=64, c=24, r=5, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(r, k)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(k, c)) / np.sqrt(k)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(c,)).astype(np.float32))
    return x, w, b


def _np(t):
    return t.detach().to(torch.float32).numpy()


def dense_suite(rank, world):
    """``dense`` under ``tensor_parallel`` against the unsharded port on the
    same rank, for float weights (f32 and bf16 activations), K-sharded
    packs, the int8-stored layout and bit-sliced execution; fall-throughs;
    noise determinism and the shard streams; STE gradients; ``manual_tp``.
    Returns ``{name: value}``."""
    from repro_torch.launch import mesh as M
    from repro_torch.models.common import ModelConfig, dense
    from repro_torch.photonic import (
        PhotonicEngine,
        manual_tp,
        pack_dense,
        prepack_params,
        shard_local_engine,
        tensor_parallel,
    )

    mesh = M.make_tp_smoke_mesh(world, device="cpu")
    out = {"rank": rank, "axis_rank": mesh.get_local_rank("model")}
    x, w, b = _operands()
    chans = _channels()

    def counted(fn):
        contracts.reset_all_reduces()
        y = fn()
        return y, contracts.ALL_REDUCES["psum_int_gemm"]

    for name, dpu in chans.items():
        for backend in ("kernel", "ref", "exact") if name == "ideal" else ("kernel",):
            cfg = ModelConfig(photonic=dpu, photonic_backend=backend)
            tag = f"{name}/{backend}"
            for dt in (torch.float32, torch.bfloat16):
                xd = x.to(dt)
                base = dense({"w": w, "b": b}, xd, cfg, site=SITE, layer=1)
                with tensor_parallel(mesh, "model"):
                    tp, n = counted(lambda: dense({"w": w, "b": b}, xd, cfg, site=SITE, layer=1))
                out[f"float/{tag}/{dt}"] = (_np(base), _np(tp), n)
            # A K-sharded pack, this rank's block only, as prepack_params
            # keeps it under the mesh; the unsharded pack's result beside.
            eng = PhotonicEngine(dpu=dpu, backend=backend)
            defs = {"attn": {"wq": {"w": w, "b": b}}}
            local = prepack_params(defs, defs, eng, mesh=mesh, axis="model")["attn"]["wq"]
            whole = pack_dense({"w": w, "b": b}, eng)
            base = dense(whole, x, cfg, site=SITE, layer=1)
            with tensor_parallel(mesh, "model"):
                tp, n = counted(lambda: dense(local, x, cfg, site=SITE, layer=1))
            out[f"packed/{tag}"] = (_np(base), _np(tp), n)
            out[f"packed_layout/{tag}"] = (local["w"].shards, local["w"].shard, tuple(local["w"].wq.shape))
    # The int8-stored layout (w int8 + w_scale): raw rows sliced per rank.
    cfg = ModelConfig(photonic=chans["ideal"], photonic_backend="kernel", photonic_scope="weights_int8")
    qw = pack_dense({"w": w}, PhotonicEngine(dpu=chans["ideal"], backend="exact"))["w"]
    p8 = {"w": qw.wq, "w_scale": qw.w_scale, "b": b}
    base = dense(p8, x, cfg, site=SITE)
    with tensor_parallel(mesh, "model"):
        tp, n = counted(lambda: dense(p8, x, cfg, site=SITE))
    out["int8_layout"] = (_np(base), _np(tp), n)
    # Fall-throughs: K the degree does not divide, an unrouted site.
    cfg = ModelConfig(photonic=chans["ideal"], photonic_backend="kernel")
    xo, wo, _ = _operands(k=63, seed=1)
    base = dense({"w": wo}, xo, cfg, site=SITE)
    with tensor_parallel(mesh, "model"):
        tp, n = counted(lambda: dense({"w": wo}, xo, cfg, site=SITE))
    out["fall/odd_k"] = (_np(base), _np(tp), n)
    base = dense({"w": w}, x, cfg, site="ffn.router")
    with tensor_parallel(mesh, "model"):
        tp, n = counted(lambda: dense({"w": w}, x, cfg, site="ffn.router"))
    out["fall/unrouted"] = (_np(base), _np(tp), n)
    try:
        with tensor_parallel(mesh, "tensor"):
            pass
        out["bad_axis"] = None
    except ValueError as e:
        out["bad_axis"] = str(e)
    # Bit-sliced execution under TP: every plane pass of each shard.
    cfg = ModelConfig(photonic=chans["ideal"], photonic_backend="kernel", photonic_slicing=2)
    base = dense({"w": w, "b": b}, x, cfg, site=SITE)
    with tensor_parallel(mesh, "model"):
        tp, n = counted(lambda: dense({"w": w, "b": b}, x, cfg, site=SITE))
    out["sliced/ideal"] = (_np(base), _np(tp), n)
    # manual_tp over the default group.
    cfg = ModelConfig(photonic=chans["ideal"], photonic_backend="kernel")
    base = dense({"w": w, "b": b}, x, cfg, site=SITE)
    with manual_tp("model"):
        tp, n = counted(lambda: dense({"w": w, "b": b}, x, cfg, site=SITE))
    out["manual/ideal"] = (_np(base), _np(tp), n)
    # Noise: deterministic per seed and per key, key-sensitive, unlike the
    # unsharded stream; the shards' own partials on identical blocks differ.
    from repro_torch import prng

    for name in ("SMWA", "ASMW"):
        cfg = ModelConfig(photonic=chans[name], photonic_backend="kernel")
        base = dense({"w": w}, x, cfg, site=SITE)
        with tensor_parallel(mesh, "model"):
            y1 = dense({"w": w}, x, cfg, site=SITE)
            y2 = dense({"w": w}, x, cfg, site=SITE)
            k1 = dense({"w": w}, x, cfg, site=SITE, prng_key=prng.PRNGKey(1))
            k1b = dense({"w": w}, x, cfg, site=SITE, prng_key=prng.PRNGKey(1))
            k2 = dense({"w": w}, x, cfg, site=SITE, prng_key=prng.PRNGKey(2))
        out[f"noise/{name}"] = {n_: _np(v) for n_, v in
                                dict(base=base, y1=y1, y2=y2, k1=k1, k1b=k1b, k2=k2).items()}
        eng = shard_local_engine(PhotonicEngine(dpu=chans[name]), 64 // world)
        rng = np.random.default_rng(7)
        xq = torch.from_numpy(rng.integers(-127, 128, (4, 64 // world)).astype(np.int8))
        wq = torch.from_numpy(rng.integers(-127, 128, (64 // world, 8)).astype(np.int8))
        out[f"partial/{name}"] = eng.int_gemm(xq, wq, site=SITE, shard=rank).numpy()
    # STE gradients: float and packed, against the unsharded backward.
    cfg = ModelConfig(photonic=chans["ideal"], photonic_backend="kernel")
    g = torch.from_numpy(np.random.default_rng(3).normal(size=(5, 24)).astype(np.float32))

    def grads(params, fn_scope):
        xs = x.clone().requires_grad_(True)
        ps = {k_: (v.clone().requires_grad_(True) if v.is_floating_point() else v) if torch.is_tensor(v) else v
              for k_, v in params.items()}
        with fn_scope():
            y = dense(ps, xs, cfg, site=SITE)
        y.backward(g)
        res = {"dx": _np(xs.grad)}
        for k_, v in ps.items():
            if torch.is_tensor(v) and v.requires_grad:
                res["d" + k_] = _np(v.grad)
        return res

    import contextlib

    for kind in ("float", "packed"):
        if kind == "float":
            params, whole = {"w": w, "b": b}, {"w": w, "b": b}
        else:
            eng = PhotonicEngine(dpu=chans["ideal"], backend="kernel")
            defs = {"attn": {"wq": {"w": w, "b": b}}}
            params = prepack_params(defs, defs, eng, mesh=mesh, axis="model")["attn"]["wq"]
            whole = pack_dense({"w": w, "b": b}, eng)
        base = grads(whole, contextlib.nullcontext)
        tp = grads(params, lambda: tensor_parallel(mesh, "model"))
        out[f"grad/{kind}"] = (base, tp)
    return out


def serve_suite(rank, world):
    """qwen2-0.5b's smoke config served through ``Engine(mesh=)`` at TP =
    world and without a mesh on the same rank, ideal channel; the decode
    step's weight-shaped rounds under TP; all-reduces against the routed
    GEMMs of the unsharded run."""
    from repro_torch.launch import mesh as M
    from repro_torch.models import registry
    from repro_torch.models.common import init_params
    from repro_torch.photonic.engine import PhotonicEngine
    from repro_torch.runtime.serve import Engine, ServeConfig
    from repro_torch.serving import Request

    mesh = M.make_tp_smoke_mesh(world, device="cpu")
    arch = registry.get("qwen2-0.5b")
    params = init_params(arch.smoke_config, 0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, arch.smoke_config.vocab_size, n).astype(np.int32) for n in (5, 9, 3)]
    chans = _channels()
    out = {}
    calls = {"n": 0}
    matmul = PhotonicEngine.matmul

    def counting(self, *a, **k):
        calls["n"] += 1
        return matmul(self, *a, **k)

    for name in ("ideal",):
        cfg = dataclasses.replace(arch.smoke_config, photonic=chans[name], photonic_backend="kernel")
        runs = {}
        for label, m in (("tp1", None), ("tp", mesh), ("tp_again", mesh)):
            eng = Engine(arch, cfg, params, ServeConfig(batch_size=2, max_seq=32), mesh=m, device="cpu")
            reqs = [Request(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
            calls["n"] = 0
            contracts.reset_all_reduces()
            PhotonicEngine.matmul = counting
            try:
                eng.run(reqs)
            finally:
                PhotonicEngine.matmul = matmul
            runs[label] = dict(tokens=[r.output for r in reqs], routed=calls["n"],
                               all_reduces=contracts.ALL_REDUCES["psum_int_gemm"],
                               forwards=eng.stats["prefill_chunks"] + eng.stats["decode_steps"])
            if label == "tp":
                runs[label]["decode_rounds"] = eng.impl.decode_weight_rounds()
        out[name] = runs
    out["layers"] = arch.smoke_config.num_layers
    return out


def mesh_suite(rank, world):
    """The mesh helpers inside a live group of ``world`` ranks."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as M

    out = {"world": dist.get_world_size(), "max_tp": M.max_tp_degree(), "max_tp_2": M.max_tp_degree(limit=2)}
    m = M.make_tp_smoke_mesh(device="cpu")
    out["tp_mesh"] = (m.mesh_dim_names, tuple(m.mesh.shape), m.get_local_rank("model"), m.get_local_rank("data"))
    m1 = M.make_smoke_mesh(device="cpu")
    out["smoke_mesh"] = (m1.mesh_dim_names, tuple(m1.mesh.shape))
    m2 = M.build_mesh((world // 2, 2), ("data", "model"), device="cpu")
    out["dp_tp_mesh"] = (m2.mesh_dim_names, tuple(m2.mesh.shape), m2.get_local_rank("data"),
                         m2.get_local_rank("model"))
    errors = {}
    for what, fn in (
        ("production", lambda: M.make_production_mesh(device="cpu")),
        ("multi_pod", lambda: M.make_production_mesh(multi_pod=True, device="cpu")),
        ("too_wide", lambda: M.make_tp_smoke_mesh(2 * world, device="cpu")),
        ("ragged", lambda: M.build_mesh((world,), ("data", "model"), device="cpu")),
    ):
        try:
            fn()
            errors[what] = None
        except (RuntimeError, ValueError) as e:
            errors[what] = str(e)
    out["errors"] = errors
    # An int32 sum over the model axis wraps as JAX's int32 psum does.
    t = torch.tensor([2**31 - 1, -(2**31), rank], dtype=torch.int32)
    dist.all_reduce(t, group=m.get_group("model"))
    out["int32_sum"] = t.tolist()
    return out


def failing_rank(rank, world):
    """Rank 1 raises; the others return."""
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return rank


def tp_suite(rank, world):
    """:func:`dense_suite` and :func:`serve_suite` in one group."""
    return {"dense": dense_suite(rank, world), "serve": serve_suite(rank, world)}


def cuda_suite(rank, world):
    """``dense`` under ``tensor_parallel`` on the CUDA kernels (ranks
    sharing one card over ``gloo``), float weights and a K-sharded pack,
    ideal channel, against the unsharded kernels on the same rank."""
    from repro_torch.kernels.photonic_gemm import kernel as K
    from repro_torch.launch import mesh as M
    from repro_torch.models.common import ModelConfig, dense
    from repro_torch.photonic import PhotonicEngine, pack_dense, prepack_params, tensor_parallel

    mesh = M.make_tp_smoke_mesh(world, device="cuda")
    x, w, b = (t.cuda() for t in _operands(k=896, c=136, r=12))
    dpu = _channels()["ideal"]
    cfg = ModelConfig(photonic=dpu, photonic_backend="kernel")
    eng = PhotonicEngine(dpu=dpu, backend="kernel")
    defs = {"attn": {"wq": {"w": w, "b": b}}}
    local = prepack_params(defs, defs, eng, mesh=mesh, axis="model")["attn"]["wq"]
    whole = pack_dense({"w": w, "b": b}, eng)
    out = {}
    for key, unsharded, sharded in (("float", {"w": w, "b": b}, {"w": w, "b": b}), ("packed", whole, local)):
        base = dense(unsharded, x, cfg, site=SITE)
        contracts.reset_all_reduces()
        K.reset_launches()
        with tensor_parallel(mesh, "model"):
            tp = dense(sharded, x, cfg, site=SITE)
        n = contracts.ALL_REDUCES["psum_int_gemm"]
        assert K.LAUNCHES["photonic_gemm"] == n == 1, (dict(K.LAUNCHES), n)
        out[key] = (_np(base.cpu()), _np(tp.cpu()), n)
    return out

"""Rank bodies for the MoE decoders' parameter-placement tests
(``tests/test_torch_placement_moe.py``).

Each function runs in every rank of a group of four that
``repro_torch.launch.mesh.spawn`` starts on the ``gloo`` backend (CPU), as
the (data 2, model 2) mesh, and returns plain numpy / Python values.  This
module imports no ``jax``: the reference's parameters arrive as numpy
trees, one for each arch.
"""

import contextlib
import dataclasses

import numpy as np
import torch

from _torch_placement_ranks import BATCH, MAX_SEQ, _inputs, _mesh
from _torch_train_tp_ranks import _np, ideal_dpu, smwa_dpu
from repro_torch.analysis import contracts

DEEPSEEK, PHI = "deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b"
DECODE_STEPS = 2
TRAIN_SEQ, TRAIN_STEPS = 16, 2
# (case, arch, channel, absorbed decode): the serve cases of (a) and (c)
SERVE_CASES = [("ideal", DEEPSEEK, "ideal", False), ("SMWA", DEEPSEEK, "SMWA", False),
               ("ideal absorbed", DEEPSEEK, "ideal", True), ("SMWA absorbed", DEEPSEEK, "SMWA", True),
               ("digital", DEEPSEEK, "digital", False), ("ideal", PHI, "ideal", False), ("SMWA", PHI, "SMWA", False),
               ("digital", PHI, "digital", False)]
# (case, arch, channel): the dry run's train step of (d)
TRAIN_CASES = [("digital", DEEPSEEK, "digital"), ("ideal", DEEPSEEK, "ideal"), ("digital", PHI, "digital")]


def _counts():
    return dict(psum=contracts.ALL_REDUCES["psum_int_gemm"], amax=contracts.SCALE_REDUCTIONS["amax"],
                outputs=contracts.ROW_GATHERS["outputs"], tp_rows=contracts.ROW_GATHERS["tp_rows"],
                heads=contracts.HEAD_GATHERS["heads"], **contracts.PARAM_REDUCES)


def _cfg(name, channel, absorbed=False, **kw):
    """The arch's smoke config padded for a model degree of 2, photonic on
    the kernel backend's CPU twin (``channel`` "ideal" / "SMWA"), or
    digital."""
    from repro_torch.models import registry

    arch = registry.get(name)
    cfg = dataclasses.replace(arch.smoke_config.pad_for_mesh(2), mla_absorb=absorbed, **kw)
    if channel != "digital":
        cfg = dataclasses.replace(cfg, photonic=ideal_dpu() if channel == "ideal" else smwa_dpu(),
                                  photonic_backend="kernel")
    return arch, cfg


def _shape(kind, seq=MAX_SEQ):
    from repro_torch.models.registry import ShapeSpec

    return ShapeSpec(f"smoke_{kind}", seq, BATCH, kind)


def _tensors(tree):
    from repro_torch._tree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _serve(arch, cfg, params, mesh, *, place, tp, log):
    """The prefill's last logits and each decode step's, global, with the
    mesh's rules active; ``tp``: routed GEMMs under TP over "model";
    ``place`` "all": the rows, heads, ``d_ff``, vocab and experts placed,
    the parameters cut to this rank's blocks (``place_params``);
    "no experts": the same with the experts left whole; ``None``: nothing
    placed.  ``log`` gets every GEMM (``models.common.recording``), a
    ``None`` before each forward.  Also the parameter bytes the run held."""
    from repro_torch.models.common import axes_tree, recording
    from repro_torch.photonic import sharded
    from repro_torch.runtime import sharding as shd

    prompt, steps = _inputs(cfg)
    steps = steps[:DECODE_STEPS]
    tok_axes, logit_axes = ("batch", None), ("batch", None, "vocab")
    with contextlib.ExitStack() as scopes:
        scopes.enter_context(shd.use_rules(mesh))
        scopes.enter_context(recording(log))
        if tp:
            scopes.enter_context(sharded.tensor_parallel(mesh, "model"))
        if place:
            sizes = arch.placement_sizes(cfg, _shape("decode"))
            if place == "no experts":
                sizes.pop("experts")
            scopes.enter_context(shd.placement(mesh, sizes))
            params = shd.place_params(params, axes_tree(arch.param_defs(cfg)))
            prompt = shd.place_tree(prompt, tok_axes)
        with torch.no_grad():
            log.append(None)
            logits, cache = arch.prefill(params, {"tokens": prompt}, cfg, MAX_SEQ)
            out = [logits]
            for t in steps:
                log.append(None)
                logits, cache = arch.decode(params, shd.place_tree(t, tok_axes) if place else t, cache, cfg)
                out.append(logits)
        if place:
            out = [shd.gather_tree(x, logit_axes) for x in out]
        held = sum(t.numel() * t.element_size() for t in _tensors(params))
    return [_np(x) for x in out], held


def compare_gemms(rep_log, placed_log, absorbed=False):
    """Each GEMM of the placed run that precedes its forward's first expert
    combine (every input it reads then is the replicated program's)
    against this rank's rows and columns of the replicated run's output:
    ``(checked sites, bitwise count, mismatches, the rest)``.  In an
    absorbed decode step the GEMMs from the first ``attn.wo`` on are the
    rest, held to a float tolerance and not bitwise: the absorbed core's
    batched products fold the heads into their rows, which rounds by the
    head count a rank holds.  The rest are ``(site, layer, max |d|, the
    share of elements more than 1e-5 off, max |replicated|)``.  The runs
    must make the same calls."""
    assert len(rep_log) == len(placed_log), (len(rep_log), len(placed_log))
    checked, same, bad, rest, forward = set(), 0, [], [], -1
    for rep, got in zip(rep_log, placed_log):
        if rep is None or got is None:
            assert rep is got is None
            start, forward, core = None, forward + 1, False
            continue
        assert (rep.site, rep.layer) == (got.site, got.layer)
        if start is None:
            start = got.reduces["expert_combine"]
        if got.reduces["expert_combine"] != start:
            continue
        want = rep.y
        if got.rows is not None:
            want = want.narrow(0, got.rows[0] * got.rows[1], got.rows[1])
        if got.segments is not None:
            want = torch.cat([want.narrow(-1, o, w) for o, w in got.segments], dim=-1)
        checked.add((got.site, got.layer))
        core = core or (absorbed and forward > 0 and got.site == "attn.wo")
        if core and want.shape == got.y.shape:
            d = (got.y.double() - want.double()).abs()
            rest.append((got.site, got.layer, float(d.max()), float((d > 1e-5).double().mean()),
                         float(want.abs().max())))
        elif want.shape == got.y.shape and torch.equal(want, got.y):
            same += 1
        else:
            bad.append((got.site, got.layer, tuple(got.y.shape), tuple(want.shape),
                        float((got.y.float() - want.float()).abs().max()) if want.shape == got.y.shape else None))
    return sorted(checked, key=str), same, bad, rest


def serve_suite(rank, world, params_np):
    """Prefill and decode of both smoke configs on the (2, 2) mesh from the
    reference's parameters (``params_np[arch]``), each of
    :data:`SERVE_CASES`: photonic, the replicated TP program (whole
    parameters, nothing placed) against everything placed and, on the
    ideal channel, against all but the experts placed; digital, the
    unsharded run against everything placed.  The GEMMs of each placed run against the replicated run's
    (:func:`compare_gemms`)."""
    from repro_torch.weights import params_from_jax

    mesh = _mesh()
    out = {"coords": (mesh.get_local_rank("data"), mesh.get_local_rank("model"))}
    for case, name, channel, absorbed in SERVE_CASES:
        arch, cfg = _cfg(name, channel, absorbed)
        params = params_from_jax(params_np[name], cfg, "cpu")
        tp = channel != "digital"
        res, logs = {}, {}
        for label, place in (("replicated", None), ("placed", "all"), ("no_experts", "no experts")):
            if label == "no_experts" and channel != "ideal":  # the noisy twin is slow on the CPU
                continue
            contracts.reset_all_reduces()
            logs[label] = []
            logits, held = _serve(arch, cfg, params, mesh, place=place, tp=tp, log=logs[label])
            res[label] = dict(logits=logits, counts=_counts(), bytes=held)
        for label in ("placed", "no_experts"):
            if label in logs:
                res[label]["gemms"] = compare_gemms(logs["replicated"], logs[label], absorbed)
        out[(name, case)] = res
    return out


# ---------------------------------------------------------------------------
# (b) moe() alone
# ---------------------------------------------------------------------------
def moe_inputs(cfg, seed=3):
    """Seeded ``(params, x)`` of one MoE layer at ``cfg``'s widths, 4 x 8
    tokens."""
    from repro_torch.models import ffn
    from repro_torch.models.common import init_params

    params = init_params(cfg, seed, "cpu", defs=ffn.moe_def(cfg))
    gen = torch.Generator().manual_seed(seed)
    return params, torch.randn(BATCH, 8, cfg.d_model, generator=gen)


def moe_suite(mesh):
    """``ffn.moe`` of each arch's smoke config, with the default capacity
    and with a binding one (``capacity_factor`` 0.5), replicated against
    expert-parallel (the experts and the shared experts' ``d_ff`` placed
    over "model", the stacks cut to this rank's block): the outputs and
    aux losses."""
    from repro_torch.models import ffn
    from repro_torch.models.common import axes_tree
    from repro_torch.runtime import sharding as shd

    out = {}
    for name in (DEEPSEEK, PHI):
        for factor in (1.25, 0.5):
            _, cfg = _cfg(name, "digital", capacity_factor=factor)
            params, x = moe_inputs(cfg)
            with torch.no_grad():
                want, want_aux = ffn.moe(params, x, cfg, layer=1)
                contracts.reset_all_reduces()
                with shd.placement(mesh, {"experts": cfg.num_experts, "d_ff": cfg.d_ff}):
                    mine = shd.place_params(params, axes_tree(ffn.moe_def(cfg)))
                    got, aux = ffn.moe(mine, x, cfg, layer=1)
                    stack = tuple(mine["wi"].shape)
            out[(name, factor)] = dict(out=_np(got), want=_np(want), aux=float(aux), want_aux=float(want_aux),
                                       stack=stack, counts=_counts())
    return out


# ---------------------------------------------------------------------------
# (d) the dry run's train step on placed parameters
# ---------------------------------------------------------------------------
def _batches(cfg):
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (TRAIN_STEPS, BATCH, TRAIN_SEQ + 1))
    return [{"tokens": torch.from_numpy(t[:, :-1]).long(), "labels": torch.from_numpy(t[:, 1:]).long()} for t in toks]


def _grads(arch, cfg, params, batch, loss=None):
    from repro_torch.runtime.train_loop import _mean_over_rows, _value_and_grad

    loss_fn = loss or (lambda p, b: arch.loss(p, b, cfg))
    value, grads = _value_and_grad(loss_fn, params, batch)
    return _mean_over_rows(value, grads)


def _aux_loss(cfg):
    """The aux term of ``lm_loss`` alone (``0.01 x`` the summed aux)."""
    from repro_torch.models import lm

    return lambda p, b: 0.01 * lm.lm_logits(p, b["tokens"], cfg)[1]


def train_suite(rank, world, params_np):
    """The dry run's train step (``dryrun.build_step``: parameters placed
    by their ``param_axes``, experts included, ZeRO-1 moments, the placed
    gradient norm) on the (2, 2) mesh for ``TRAIN_STEPS`` steps, each of
    :data:`TRAIN_CASES`, against the replicated step on whole parameters;
    the first step's gradient placed against this rank's blocks of the
    replicated one; the replicated gradient of the aux term alone (what
    counting it once per model rank would add to the router's)."""
    from repro_torch._tree import tree_items
    from repro_torch.launch import dryrun
    from repro_torch.models.common import axes_tree
    from repro_torch.optim import adamw
    from repro_torch.photonic import sharded
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.train_loop import build_train_step
    from repro_torch.weights import params_from_jax

    mesh = _mesh()
    out = {}
    for case, name, channel in TRAIN_CASES:
        arch, cfg = _cfg(name, channel)
        shape = _shape("train", TRAIN_SEQ)
        defs = arch.param_defs(cfg)
        axes = axes_tree(defs)
        params = params_from_jax(params_np[name], cfg, "cpu")
        batches = _batches(cfg)
        opt_cfg = adamw.AdamWConfig()
        step = build_train_step(lambda p, b: arch.loss(p, b, cfg), opt_cfg)
        p_rep, s_rep, rep_losses = params, adamw.init(params), []
        _, rep_grads = _grads(arch, cfg, params, batches[0])
        _, aux_grads = _grads(arch, cfg, params, batches[0], loss=_aux_loss(cfg))
        for b in batches:
            p_rep, s_rep, m = step(p_rep, s_rep, b)
            rep_losses.append(float(m["loss"]))
        placed_step = dryrun.build_step(arch, cfg, shape, mesh)
        batch_axes = {"tokens": ("batch", None), "labels": ("batch", None)}
        with shd.use_rules(mesh):
            with shd.placement(mesh, arch.placement_sizes(cfg, shape)):
                p = shd.place_params(params, axes)
                local = [shd.place_tree(b, batch_axes) for b in batches]
                contracts.reset_all_reduces()
                with contextlib.ExitStack() as scopes:
                    if channel != "digital":
                        scopes.enter_context(sharded.tensor_parallel(mesh, "model"))
                    _, grads = _grads(arch, cfg, p, local[0])
                grad_counts = _counts()
                want_grads = shd.place_params(rep_grads, axes)
            s = adamw.init(p, adamw.zero1(defs, axes, mesh))
            losses = []
            for b in local:
                p, s, m = placed_step(p, s, b)
                losses.append(float(m["loss"]))
        routers = [k for k in tree_items(grads) if k.endswith("ffn/router/w")]
        out[(name, case)] = dict(
            losses=losses, rep_losses=rep_losses, grad_counts=grad_counts,
            grads={k: _np(v) for k, v in tree_items(grads).items()},
            want_grads={k: _np(v) for k, v in tree_items(want_grads).items()},
            aux_router={k: _np(tree_items(aux_grads)[k]) for k in routers},
            stacks={k: tuple(v.shape) for k, v in tree_items(p).items() if k.endswith(("ffn/wi", "ffn/wo"))},
            moment_stacks={k: tuple(v.shape) for k, v in tree_items(s.mu).items() if k.endswith(("ffn/wi", "ffn/wo"))})
    return out


def suite(rank, world, params_np):
    """:func:`serve_suite`, :func:`moe_suite` and :func:`train_suite` in
    one group."""
    return {"serve": serve_suite(rank, world, params_np), "moe": moe_suite(_mesh()),
            "train": train_suite(rank, world, params_np)}

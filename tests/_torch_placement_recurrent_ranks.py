"""Rank bodies for the recurrent, audio and vision families'
parameter-placement tests (``tests/test_torch_placement_recurrent.py``:
xlstm-350m, zamba2-2.7b; ``tests/test_torch_placement_cross.py`` through
``tests/_torch_placement_cross_ranks.py``: whisper-medium,
llama-3.2-vision-90b).

Each suite runs in every rank of a group of four that
``repro_torch.launch.mesh.spawn`` starts on the ``gloo`` backend (CPU), as
the (data 2, model 2) mesh, and returns plain numpy / Python values.  This
module imports no ``jax``: the reference's parameters arrive as numpy
trees, one for each arch.
"""

import contextlib
import dataclasses
import time

import numpy as np
import torch

from _torch_placement_ranks import BATCH, MAX_SEQ, _inputs, _mesh
from _torch_train_tp_ranks import _np, ideal_dpu, smwa_dpu
from repro_torch.analysis import contracts

XLSTM, ZAMBA, WHISPER, VISION = "xlstm-350m", "zamba2-2.7b", "whisper-medium", "llama-3.2-vision-90b"
DECODE_STEPS = 2
NOISY_STEPS = 0  # SMWA's decode steps: the noisy twin is slow on the CPU, so its prefill alone
ENC_SEQ = 16  # whisper's encoder frames at smoke size
TRAIN_SEQ, TRAIN_STEPS = 16, 2
CHANNELS = ("ideal", "SMWA", "digital")
# The leaves the reference initializes to zeros or ones that would hide a
# placement fault (a gate at zero makes a cross layer the identity; zero
# mLSTM gates and Mamba2 biases make every head alike): the tests draw
# them from a seeded normal, on both sides.
SEEDED = ("wi/w", "wf/w", "conv_b", "a_log", "dt_bias", "d_skip", "gate", "gate_ffn")


def seed_leaves(tree, seed=11):
    """``tree`` (nested dicts / lists of numpy arrays) with the
    :data:`SEEDED` leaves drawn from ``N(0, 0.5^2)``."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{path}/{i}") for i, v in enumerate(node))
        if path.endswith(SEEDED) and "/ffn/" not in path:
            return (0.5 * rng.standard_normal(node.shape)).astype(node.dtype)
        return node

    return walk(tree, "")


def counts():
    return dict(psum=contracts.ALL_REDUCES["psum_int_gemm"], amax=contracts.SCALE_REDUCTIONS["amax"],
                outputs=contracts.ROW_GATHERS["outputs"], tp_rows=contracts.ROW_GATHERS["tp_rows"],
                heads=contracts.HEAD_GATHERS["heads"], **contracts.PARAM_REDUCES,
                **{f"recurrent_{k}": v for k, v in contracts.RECURRENT_COLLECTIVES.items()})


def cfg_of(name, channel, **kw):
    """The arch's smoke config padded for a model degree of 2, photonic on
    the kernel backend's CPU twin (``channel`` "ideal" / "SMWA"), or
    digital."""
    from repro_torch.models import registry

    arch = registry.get(name)
    cfg = dataclasses.replace(arch.smoke_config.pad_for_mesh(2), **kw)
    if channel != "digital":
        cfg = dataclasses.replace(cfg, photonic=ideal_dpu() if channel == "ideal" else smwa_dpu(),
                                  photonic_backend="kernel")
    return arch, cfg


def shape_of(kind, seq=MAX_SEQ):
    from repro_torch.models.registry import ShapeSpec

    return ShapeSpec(f"smoke_{kind}", seq, BATCH, kind)


def batch_of(arch, cfg, tokens, seed=5):
    """``{"tokens"}`` and the family's memory input: ``audio_embed``
    (whisper, ``ENC_SEQ`` frames) or ``vision`` (``vision_seq`` patches),
    seeded; with the batch's logical axes."""
    batch, axes = {"tokens": tokens}, {"tokens": ("batch", None)}
    rng = np.random.default_rng(seed)
    if arch.family == "audio":
        batch["audio_embed"] = torch.from_numpy(rng.standard_normal((tokens.shape[0], ENC_SEQ, cfg.d_model))
                                                .astype(np.float32))
        axes["audio_embed"] = ("batch", "seq_sp", None)  # the reference's axes: its frames go in by seq_sp
    if arch.family == "vlm":
        batch["vision"] = torch.from_numpy(rng.standard_normal((tokens.shape[0], cfg.vision_seq, cfg.d_model))
                                           .astype(np.float32))
        axes["vision"] = ("batch", None, None)
    return batch, axes


def tensors(tree):
    from repro_torch._tree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def steps_of(channel):
    return NOISY_STEPS if channel == "SMWA" else DECODE_STEPS


def serve(arch, cfg, params, mesh, *, place, tp, log, steps=DECODE_STEPS):
    """The prefill's last logits and each decode step's, global, with the
    mesh's rules active; ``tp``: routed GEMMs under TP over "model";
    ``place``: every name the arch places (``placement_sizes``) and the
    parameters cut to this rank's blocks (``place_params``), else nothing
    placed.  ``log`` gets every GEMM (``models.common.recording``), a
    ``None`` before each forward.  Also the parameter and recurrent-state
    bytes the rank held."""
    from repro_torch.models.common import axes_tree, recording
    from repro_torch.photonic import sharded
    from repro_torch.runtime import sharding as shd

    prompt, tokens = _inputs(cfg)
    batch, batch_axes = batch_of(arch, cfg, prompt)
    tok_axes, logit_axes = ("batch", None), ("batch", None, "vocab")
    with contextlib.ExitStack() as scopes:
        scopes.enter_context(shd.use_rules(mesh))
        scopes.enter_context(recording(log))
        if tp:
            scopes.enter_context(sharded.tensor_parallel(mesh, "model"))
        if place:
            scopes.enter_context(shd.placement(mesh, arch.placement_sizes(cfg, shape_of("decode"))))
            params = shd.place_params(params, axes_tree(arch.param_defs(cfg)))
            batch = shd.place_tree(batch, batch_axes)
        with torch.no_grad():
            log.append(None)
            logits, cache = arch.prefill(params, batch, cfg, MAX_SEQ)
            out = [logits]
            for t in tokens[:steps]:
                log.append(None)
                logits, cache = arch.decode(params, shd.place_tree(t, tok_axes) if place else t, cache, cfg)
                out.append(logits)
        if place:
            out = [shd.gather_tree(x, logit_axes) for x in out]
        held = sum(t.numel() * t.element_size() for t in tensors(params))
    states = {k: v for k, v in cache.items() if k in ("mlstm", "slstm", "mamba")}
    return dict(logits=[_np(x) for x in out], bytes=held,
                state_bytes=sum(t.numel() * t.element_size() for t in tensors(states)),
                state_shapes={f"{k}/{n}": tuple(t.shape) for k, v in states.items() for n, t in v.items()})


def replay(rep_log, placed_log, cfg):
    """Every routed GEMM of the placed run called again (its recorded
    parameters and keywords) on this rank's block of the replicated run's
    input to it, against this rank's block of the replicated run's output:
    ``(checked sites, bitwise count, mismatches)``.  The runs must make the
    same calls; every rank replays in the same order (the row-parallel and
    K-sharded forms all-reduce)."""
    from repro_torch.models.common import dense, engine_from_model_config

    def mine(t, rows, segments=None, kb=None):
        if rows is not None:
            t = t.narrow(0, rows[0] * rows[1], rows[1])
        if segments is not None:
            t = torch.cat([t.narrow(-1, o, w) for o, w in segments], dim=-1)
        if kb is not None:
            n = t.shape[-1] // kb[1]
            t = t.narrow(-1, kb[0] * n, n)
        return t

    assert len(rep_log) == len(placed_log), (len(rep_log), len(placed_log))
    eng = engine_from_model_config(cfg)
    checked, same, bad = set(), 0, []
    for rep, got in zip(rep_log, placed_log):
        if rep is None or got is None:
            assert rep is got is None
            continue
        assert (rep.site, rep.layer) == (got.site, got.layer)
        if not eng.routes(got.site):
            continue
        with torch.no_grad():
            y = dense(got.params, mine(rep.x, got.rows, kb=got.k_block), cfg, **got.kwargs)
        want = mine(rep.y, got.rows, got.segments)
        checked.add(got.site)
        if want.shape == y.shape and torch.equal(want, y):
            same += 1
        else:
            bad.append((got.site, tuple(y.shape), tuple(want.shape),
                        float((y - want).abs().max()) if want.shape == y.shape else None))
    return sorted(checked), same, bad


def serve_suite(names, params_np):
    """Prefill and decode of each of ``names``' smoke configs on the (2, 2)
    mesh from the reference's parameters (``params_np[name]``), each
    channel of :data:`CHANNELS`: the replicated program (whole parameters,
    nothing placed; TP over "model" where photonic) against everything
    placed, and the routed GEMMs replayed (:func:`replay`)."""
    from repro_torch.models.common import recording
    from repro_torch.photonic import sharded
    from repro_torch.runtime import sharding as shd
    from repro_torch.weights import params_from_jax

    mesh = _mesh()
    out = {"coords": (mesh.get_local_rank("data"), mesh.get_local_rank("model"))}
    for name in names:
        for channel in CHANNELS:
            t0 = time.perf_counter()
            arch, cfg = cfg_of(name, channel)
            params = params_from_jax(params_np[name], cfg, "cpu")
            tp = channel != "digital"
            res, logs = {}, {}
            for label, place in (("replicated", False), ("placed", True)):
                contracts.reset_all_reduces()
                logs[label] = []
                res[label] = serve(arch, cfg, params, mesh, place=place, tp=tp, log=logs[label],
                                   steps=steps_of(channel))
                res[label]["counts"] = counts()
            if tp:
                with contextlib.ExitStack() as scopes, recording([]):
                    scopes.enter_context(shd.use_rules(mesh))
                    scopes.enter_context(sharded.tensor_parallel(mesh, "model"))
                    scopes.enter_context(shd.placement(mesh, arch.placement_sizes(cfg, shape_of("decode"))))
                    res["replay"] = replay(logs["replicated"], logs["placed"], cfg)
            res["seconds"] = time.perf_counter() - t0
            out[(name, channel)] = res
    return out


# ---------------------------------------------------------------------------
# The dry run's train step on placed parameters
# ---------------------------------------------------------------------------
def train_batches(arch, cfg):
    """``TRAIN_STEPS`` seeded batches of ``TRAIN_SEQ`` tokens (whisper: as
    many frames, a quarter of them as decoder tokens) and their axes."""
    rng = np.random.default_rng(5)
    t = TRAIN_SEQ // cfg.decoder_ratio if arch.family == "audio" else TRAIN_SEQ
    out = []
    for i, toks in enumerate(rng.integers(0, cfg.vocab_size, (TRAIN_STEPS, BATCH, t + 1))):
        b, axes = batch_of(arch, cfg, torch.from_numpy(toks[:, :-1]).long(), seed=20 + i)
        if arch.family == "audio":
            b["audio_embed"] = b["audio_embed"].repeat(1, TRAIN_SEQ // ENC_SEQ, 1)
        b["labels"], axes["labels"] = torch.from_numpy(toks[:, 1:]).long(), ("batch", None)
        out.append((b, axes))
    return out


def grads_of(arch, cfg, params, batch):
    from repro_torch.runtime.train_loop import _mean_over_rows, _value_and_grad

    value, grads = _value_and_grad(lambda p, b: arch.loss(p, b, cfg), params, batch)
    return _mean_over_rows(value, grads)


def train_suite(cases, params_np):
    """The dry run's train step (``dryrun.build_step``: parameters placed
    by their ``param_axes``, ZeRO-1 moments, the placed gradient norm) on
    the (2, 2) mesh for ``TRAIN_STEPS`` steps, each of ``cases`` ``(name,
    channel)``, against the replicated step on whole parameters; the first
    step's gradient placed against this rank's blocks of the replicated
    one."""
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
    for name, channel in cases:
        t0 = time.perf_counter()
        arch, cfg = cfg_of(name, channel)
        shape = shape_of("train", TRAIN_SEQ)
        defs = arch.param_defs(cfg)
        axes = axes_tree(defs)
        params = params_from_jax(params_np[name], cfg, "cpu")
        batches = train_batches(arch, cfg)
        step = build_train_step(lambda p, b: arch.loss(p, b, cfg), adamw.AdamWConfig())
        _, rep_grads = grads_of(arch, cfg, params, batches[0][0])
        p_rep, s_rep, rep_losses = params, adamw.init(params), []
        for b, _ in batches:
            p_rep, s_rep, m = step(p_rep, s_rep, b)
            rep_losses.append(float(m["loss"]))
        placed_step = dryrun.build_step(arch, cfg, shape, mesh)
        with shd.use_rules(mesh):
            with shd.placement(mesh, arch.placement_sizes(cfg, shape)):
                p = shd.place_params(params, axes)
                local = [shd.place_tree(b, a) for b, a in batches]
                contracts.reset_all_reduces()
                with contextlib.ExitStack() as scopes:
                    if channel != "digital":
                        scopes.enter_context(sharded.tensor_parallel(mesh, "model"))
                    _, grads = grads_of(arch, cfg, p, local[0])
                grad_counts = counts()
                want_grads = shd.place_params(rep_grads, axes)
            s = adamw.init(p, adamw.zero1(defs, axes, mesh))
            losses = []
            for b in local:
                p, s, m = placed_step(p, s, b)
                losses.append(float(m["loss"]))
        out[(name, channel)] = dict(
            seconds=time.perf_counter() - t0, losses=losses, rep_losses=rep_losses, grad_counts=grad_counts,
            grads={k: _np(v) for k, v in tree_items(grads).items()},
            want_grads={k: _np(v) for k, v in tree_items(want_grads).items()})
    return out


SERVE_ARCHS = (XLSTM, ZAMBA)
TRAIN_CASES = [(XLSTM, "digital"), (ZAMBA, "digital"), (XLSTM, "ideal")]


def suite(rank, world, params_np):
    """:func:`serve_suite` and :func:`train_suite` of the recurrent
    families in one group."""
    return {"serve": serve_suite(SERVE_ARCHS, params_np), "train": train_suite(TRAIN_CASES, params_np)}

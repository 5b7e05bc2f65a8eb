"""Rank bodies for the sequence-placement tests
(``tests/test_torch_placement_seq.py``): the residual stream placed by
``seq_sp`` over "model" in prefill and training, and the decode cache placed
by ``kv_seq`` over "data" under the merged decode softmax.

Each suite runs in every rank of a group of four that
``repro_torch.launch.mesh.spawn`` starts on the ``gloo`` backend (CPU), as
the (data 2, model 2) mesh, and returns plain numpy / Python values.  This
module imports no ``jax``; (d)'s parameters are the reference's, drawn by
the port from ``prng.PRNGKey(0)`` (``init_params``: ``init_tree``'s draw
bit for bit).
"""

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

from _torch_placement_ranks import _mesh
from _torch_train_tp_ranks import _leaves, _np, _train, ideal_dpu, smoke, smwa_dpu
from repro_torch.analysis import contracts

ROWS, PROMPT = 4, 8  # (a): the prefill's 8 positions, 4 a rank of "model"
ENC_SEQ, DEC_SEQ = 16, 4  # (c): whisper's frames and decoder tokens
KV_MAX_SEQ, KV_STEPS = 32, 3  # (d): the cache's 32 positions, 16 a rank of "data"
KV_PROMPTS = (20, 14)  # a prompt across both blocks; one whose decode steps cross the boundary at 16
NOISY_LAYERS, NOISY_PROMPT, NOISY_STEPS = 2, 15, 2  # the noisy MLA decode: the first block and one MoE layer, 15-16
QWEN, DEEPSEEK, WHISPER, ZAMBA = "qwen2-0.5b", "deepseek-v2-lite-16b", "whisper-medium", "zamba2-2.7b"


def _cfg(name, channel, **kw):
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


def _shape(kind, seq, rows):
    from repro_torch.models.registry import ShapeSpec

    return ShapeSpec(f"smoke_{kind}", seq, rows, kind)


@contextlib.contextmanager
def residual_log(log):
    """Every ``("batch", "seq_sp", None)`` constraint in the scope appends
    the shape of the residual it checks to ``log``."""
    from repro_torch.models import common as cm
    from repro_torch.runtime import sharding as shd

    inner = shd.logical_constraint

    def record(x, axes):
        if tuple(axes) == shd.RESIDUAL:
            log.append(tuple(x.shape))
        return inner(x, axes)

    cm.logical_constraint = shd.logical_constraint = record
    try:
        yield log
    finally:
        cm.logical_constraint = shd.logical_constraint = inner


@contextlib.contextmanager
def _scopes(mesh, cfg, sizes, tp=True):
    """The mesh's rules, TP over "model" where photonic (and ``tp``), and
    the placement of ``sizes`` (nothing placed with ``None``)."""
    from repro_torch.photonic import sharded
    from repro_torch.runtime import sharding as shd

    with contextlib.ExitStack() as scopes:
        scopes.enter_context(shd.use_rules(mesh))
        if cfg.photonic is not None and tp:
            scopes.enter_context(sharded.tensor_parallel(mesh, "model"))
        yield scopes.enter_context(shd.placement(mesh, sizes)) if sizes else None


# ---------------------------------------------------------------------------
# (a) and (c): seq_sp in prefill and in the training forward
# ---------------------------------------------------------------------------
def _batch(arch, cfg, rows, t, seed):
    """Seeded tokens and, for whisper, ``ENC_SEQ`` frames; the reference's
    batch axes."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, t)).astype(np.int64))}
    axes = {"tokens": ("batch", None)}
    if arch.family == "audio":
        batch["audio_embed"] = torch.from_numpy(rng.standard_normal((rows, ENC_SEQ, cfg.d_model)).astype(np.float32))
        axes["audio_embed"] = ("batch", "seq_sp", None)
    return batch, axes


def _forward(arch, cfg, params, batch, axes, mesh, sizes, kind):
    """The prefill's last logits (``kind`` "prefill") or the training
    forward's logits of every position ("train"), global, with the
    residual shapes the constraints saw and the sequence collectives."""
    from repro_torch.models import lm, whisper, zamba2
    from repro_torch.runtime import sharding as shd

    contracts.reset_all_reduces()
    log = []
    with _scopes(mesh, cfg, sizes), residual_log(log), torch.no_grad():
        if sizes:
            batch = shd.place_tree(batch, axes)
        if kind == "prefill":
            logits, _ = arch.prefill(params, batch, cfg, 2 * PROMPT)
        elif arch.family == "audio":
            logits, _ = whisper.whisper_logits(params, batch, cfg)
        elif arch.family == "hybrid":
            logits, _ = zamba2.zamba2_logits(params, batch["tokens"], cfg)
        else:
            logits, _ = lm.lm_logits(params, batch["tokens"], cfg)
        if sizes:
            logits = shd.gather_tree(logits, ("batch", None, "vocab"))
    return dict(logits=_np(logits), residuals=log, seq=dict(contracts.SEQ_COLLECTIVES))


def seq_cases():
    """``(name, channel, kind, tokens)`` of (a) and (c)."""
    return [(QWEN, "ideal", "prefill", PROMPT), (QWEN, "SMWA", "prefill", PROMPT), (QWEN, "ideal", "train", PROMPT),
            (WHISPER, "ideal", "prefill", DEC_SEQ), (WHISPER, "ideal", "train", DEC_SEQ),
            (ZAMBA, "ideal", "prefill", PROMPT), (ZAMBA, "ideal", "train", PROMPT)]


def seq_suite(mesh):
    """(a) / (c): each of :func:`seq_cases` replicated (TP over "model",
    nothing placed) and with the rows, heads where the arch places them
    without its parameters (``placement_sizes(params=False)``) and
    ``seq_sp`` placed."""
    from repro_torch.models.common import init_params

    out = {}
    for name, channel, kind, t in seq_cases():
        arch, cfg = _cfg(name, channel)
        params = init_params(cfg, 3, "cpu", defs=arch.param_defs(cfg))
        batch, axes = _batch(arch, cfg, ROWS, t, seed=7)
        seq = ENC_SEQ if arch.family == "audio" else t
        sizes = arch.placement_sizes(cfg, _shape(kind, seq, ROWS), params=False)
        rep = _forward(arch, cfg, params, batch, axes, mesh, None, kind)
        placed = _forward(arch, cfg, params, batch, axes, mesh, sizes, kind)
        out[(name, channel, kind)] = dict(replicated=rep, placed=placed, sizes=sizes)
    return out


# ---------------------------------------------------------------------------
# (b): train(mesh=) with seq_sp placed against the run without it
# ---------------------------------------------------------------------------
def _without_seq(arch):
    """``arch`` whose ``placement_sizes`` leaves ``seq_sp`` out."""
    from repro_torch.models.registry import Arch

    class NoSeq(Arch):
        def placement_sizes(self, cfg, shape, *, params=True):
            return {k: v for k, v in Arch.placement_sizes(self, cfg, shape, params=params).items() if k != "seq_sp"}

    return NoSeq(**{f.name: getattr(arch, f.name) for f in dataclasses.fields(arch)})


def train_suite(mesh, root):
    """(b): two ``train(mesh=(2, 2), tp_axis="model")`` steps of the smoke
    config on the ideal channel, the rows, heads and ``seq_sp`` placed,
    against the same run without ``seq_sp`` and the replicated run
    (``place_rows=False``)."""
    arch, cfg = smoke()
    out = {}
    for label, a, kw in (("seq", arch, {}), ("no_seq", _without_seq(arch), {}),
                         ("replicated", arch, {"place_rows": False})):
        contracts.reset_all_reduces()
        res = _train(a, cfg, os.path.join(root, label), mesh, "model", steps=2, **kw)
        out[label] = dict(losses=res["losses"], params=_leaves(res["params"]), seq=dict(contracts.SEQ_COLLECTIVES))
    return out


# ---------------------------------------------------------------------------
# (d): kv_seq, the decode cache over "data" at one row
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def dropped_max():
    """The negative control: the decode softmax's row max kept rank-local
    (its ``MAX`` all-reduce over the ``kv_seq`` blocks skipped)."""
    from repro_torch.runtime import sharding as shd

    inner = shd.kv_merge

    def merge(t, op):
        return t if op == "max" else inner(t, op)

    shd.kv_merge = merge
    try:
        yield
    finally:
        shd.kv_merge = inner


def _decode(arch, cfg, params, prompt, steps, mesh, sizes, tp=True, log=None, after=None):
    """The prefill's last logits and each decode step's (one row), and the
    cache leaves' shapes; the cache placed by ``kv_seq`` with ``sizes``
    (whisper's cross cache by its ``ENC_SEQ`` frames); TP over "model"
    with ``tp``.  ``log`` gets every GEMM of the decode steps
    (``models.common.recording``); ``after()`` runs last, in the run's
    scopes."""
    from repro_torch.models.common import recording

    batch = {"tokens": prompt}
    if arch.family == "audio":
        batch["audio_embed"] = _batch(arch, cfg, 1, prompt.shape[1], seed=3)[0]["audio_embed"]
    contracts.reset_all_reduces()
    with _scopes(mesh, cfg, sizes, tp), torch.no_grad():
        logits, cache = arch.prefill(params, batch, cfg, KV_MAX_SEQ)
        out = [logits]
        with contextlib.nullcontext() if log is None else recording(log):
            for t in steps:
                logits, cache = arch.decode(params, t, cache, cfg)
                out.append(logits)
        seq = dict(contracts.SEQ_COLLECTIVES)
        if after is not None:
            after()
    leaves = {f"{k}/{n}": tuple(v.shape) for k in ("layers", "first", "self") for n, v in cache.get(k, {}).items()}
    leaves.update({f"cross/{i}": tuple(v.shape) for i, v in enumerate(cache.get("cross", ()))})
    return dict(logits=[_np(x) for x in out], cache=leaves, seq=seq)


def replay(rep_log, placed_log, cfg):
    """Every routed GEMM of the placed steps called again, in the placed
    run's scopes, on this rank's block (rows, the ``kv_seq`` positions of
    an expanded MLA decode's latent rows, K) of the replicated run's input
    to it, against this rank's block of the replicated run's output (as
    ``chip_smoke.py``'s phase 10 replays them).  Returns (GEMMs checked,
    bitwise, the sites that were not)."""
    from repro_torch.models.common import dense, engine_from_model_config
    from repro_torch.runtime import sharding as shd

    def mine(t, rows, segments=None, kb=None, seq=None):
        if rows is not None:
            t = t.narrow(0, rows[0] * rows[1], rows[1])
        if seq is not None:
            t = t.narrow(1, seq[0] * seq[1], seq[1])
        if segments is not None:
            t = torch.cat([t.narrow(-1, o, w) for o, w in segments], dim=-1)
        if kb is not None:
            n = t.shape[-1] // kb[1]
            t = t.narrow(-1, kb[0] * n, n)
        return t

    eng = engine_from_model_config(cfg)
    checked, same, bad = 0, 0, []
    for rep, got in zip(rep_log, placed_log):
        if not eng.routes(got.site):
            continue
        x = mine(rep.x, got.rows, kb=got.k_block, seq=got.seq)
        with torch.no_grad(), (shd.rows_over("kv_seq") if got.seq else contextlib.nullcontext()):
            y = dense(got.params, x, cfg, **got.kwargs)
        want = mine(rep.y, got.rows, got.segments, seq=got.seq)
        checked += 1
        if want.shape == y.shape and torch.equal(want, y):
            same += 1
        else:
            bad.append((got.site, got.layer))
    return checked, same, bad


@contextlib.contextmanager
def origin_at_zero():
    """Negative control: every block of a placed ``kv_seq``'s rows drawn at
    row origin 0."""
    from repro_torch.runtime import sharding as shd

    inner = shd.row_segments

    def zero(lead):
        seg = inner(lead)
        return seg if seg is None else ((0,) * len(seg[0]), seg[1])

    shd.row_segments = zero
    try:
        yield
    finally:
        shd.row_segments = inner


@contextlib.contextmanager
def block_word():
    """Negative control: the content word of a block of a placed
    ``kv_seq``'s rows taken from the block alone (no SUM over the
    blocks)."""
    from repro_torch.noise.stages import U32
    from repro_torch.runtime import sharding as shd

    inner = shd.rows_word
    shd.rows_word = lambda word: word & U32
    try:
        yield
    finally:
        shd.rows_word = inner


def _kv_sizes(arch, cfg, rows=1):
    """The decode step's placement (rows, heads, ``kv_seq``) at ``rows``
    rows that "data" does not divide: a cache of ``KV_MAX_SEQ`` positions
    (whisper's decode shape names its encoder frames, ``decoder_ratio``
    times its decoder's)."""
    seq = KV_MAX_SEQ * (cfg.decoder_ratio if arch.family == "audio" else 1)
    return arch.placement_sizes(cfg, _shape("decode", seq, rows), params=False)


def kv_inputs(cfg, t, rows=1):
    """``rows`` seeded prompts of ``t`` tokens and ``KV_STEPS`` decode
    tokens (the test's reference logits read the same)."""
    rng = np.random.default_rng(13 + t + 100 * (rows - 1))
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, t)).astype(np.int64))
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, (KV_STEPS, rows, 1)).astype(np.int64))
    return prompt, steps


def kv_cases():
    """``(name, channel, absorbed, prompts)`` of (d)."""
    return [(QWEN, "digital", False, KV_PROMPTS[:1]), (QWEN, "ideal", False, KV_PROMPTS),
            (WHISPER, "digital", False, KV_PROMPTS[:1]),
            (DEEPSEEK, "digital", False, KV_PROMPTS[1:]), (DEEPSEEK, "digital", True, KV_PROMPTS[1:]),
            (DEEPSEEK, "ideal", False, KV_PROMPTS[1:])]


def _reference_init(arch, cfg):
    """The reference's initial parameters of ``cfg`` (``init_tree`` under
    ``PRNGKey(0)``), drawn by the port."""
    from repro_torch import prng
    from repro_torch.models.common import init_params

    return init_params(cfg, prng.PRNGKey(0), "cpu", defs=arch.param_defs(cfg))


def kv_suite(mesh):
    """(d): each of :func:`kv_cases` from the reference's parameters, one
    row, a cache of ``KV_MAX_SEQ`` positions, each prompt of
    :data:`KV_PROMPTS` and ``KV_STEPS`` decode steps: replicated (nothing
    placed) against the rows (which fall back), heads and ``kv_seq``
    placed; the second prompt's ideal qwen2 run again with the ``MAX``
    skipped (its first decode steps leave the second block all masked);
    the expanded MLA decode under keyed SMWA (:func:`noisy_mla`)."""

    out = {}
    for name, channel, absorbed, prompts in kv_cases():
        arch, cfg = _cfg(name, channel, mla_absorb=absorbed)
        params = _reference_init(arch, cfg)
        sizes = _kv_sizes(arch, cfg)
        for t in prompts:
            prompt, steps = kv_inputs(cfg, t)
            res = dict(replicated=_decode(arch, cfg, params, prompt, steps, mesh, None),
                       placed=_decode(arch, cfg, params, prompt, steps, mesh, sizes))
            if (name, channel, t) == (QWEN, "ideal", KV_PROMPTS[1]):
                with dropped_max():
                    res["no_max"] = _decode(arch, cfg, params, prompt, steps, mesh, sizes)
            out[(name, channel, absorbed, t)] = res
    arch, cfg = _cfg(QWEN, "ideal")
    with _scopes(mesh, cfg, _kv_sizes(arch, cfg)) as pl:
        out["blocks"] = {k: (b.part, b.index, b.count, b.size) for k, b in pl.blocks.items()}
    out["smwa_expanded"] = noisy_mla(mesh)
    return out


def noisy_cases():
    """``(backend, tp, rows)`` of the noisy expanded MLA decode: TP over
    "model" (the replicated program splits the latent rows over "data"
    itself: at one row a rank's block of the positions is its split; at
    three the split cuts across the rows, and a rank gathers the latent
    rows and expands them whole) or none (the replicated program runs them
    whole, and each row's block runs at its row origin with the whole
    operand's word; several rows' blocks, one launch each, are
    ``tests/test_torch_row_origin.py``'s)."""
    return [("kernel", True, 1), ("kernel", True, 3), ("kernel", False, 1), ("ref", False, 1)]


def noisy_mla(mesh):
    """deepseek-v2-lite's expanded MLA decode on seeded SMWA at
    ``NOISY_LAYERS`` layers, a prompt of ``NOISY_PROMPT`` and
    ``NOISY_STEPS`` steps across the blocks' boundary,
    replicated against ``kv_seq`` placed, for each of :func:`noisy_cases`:
    the logits, the sequence collectives, every routed GEMM of the placed
    steps replayed on the replicated run's input; without TP on the
    kernel backend the two negative controls' replays too."""
    out = {}
    arch, cfg = _cfg(DEEPSEEK, "SMWA", mla_absorb=False, num_layers=NOISY_LAYERS)
    params = _reference_init(arch, cfg)
    for backend, tp, rows in noisy_cases():
        cfg = dataclasses.replace(cfg, photonic_backend=backend)
        prompt, steps = kv_inputs(cfg, NOISY_PROMPT, rows)
        steps = steps[:NOISY_STEPS]
        rep_log, placed_log, got = [], [], {}

        def after():
            got["replay"] = replay(rep_log, placed_log, cfg)
            if backend == "kernel" and not tp and rows == 1:
                with origin_at_zero():
                    got["origin_0"] = replay(rep_log, placed_log, cfg)
                with block_word():
                    got["block_word"] = replay(rep_log, placed_log, cfg)

        rep = _decode(arch, cfg, params, prompt, steps, mesh, None, tp=tp, log=rep_log)
        placed = _decode(arch, cfg, params, prompt, steps, mesh, _kv_sizes(arch, cfg, rows), tp=tp, log=placed_log,
                         after=after)
        out[(backend, tp, rows)] = dict(replicated=rep, placed=placed, **got)
    return out


def suite(rank, world, root):
    """(a)-(d) in one group, with each part's seconds."""
    mesh = _mesh()
    out, seconds = {"coords": (mesh.get_local_rank("data"), mesh.get_local_rank("model"))}, {}
    for part, run in (("seq", lambda: seq_suite(mesh)), ("train", lambda: train_suite(mesh, root)),
                      ("kv", lambda: kv_suite(mesh))):
        t0 = time.perf_counter()
        out[part] = run()
        seconds[part] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out

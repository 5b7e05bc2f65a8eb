"""Checks shared by ``tests/test_torch_placement_recurrent.py`` and
``tests/test_torch_placement_cross.py``: the reference's parameters for
the ranks, the JAX reference's prefill / decode logits, leaf blocks against
the reference's ``resolve_spec``, and the full-width decode_32k cells run
as dry-run subprocesses beside the group.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_placement_recurrent_ranks as ranks
from _torch_placement_ranks import MAX_SEQ, _inputs
from repro import compat
from repro.models import registry as jreg
from repro.models.common import P as JP
from repro.models.common import init_tree
from repro.runtime import sharding as jshd
from repro_torch._tree import tree_items
from repro_torch.launch import dryrun
from repro_torch.models import registry as treg
from repro_torch.runtime import sharding as tshd

ROOT = Path(__file__).resolve().parents[1]


def reference_params(names):
    """The reference's initial parameters of each arch's smoke config
    padded for a model degree of 2, as numpy trees, the zero-initialized
    gates and biases seeded (``ranks.seed_leaves``)."""
    out = {}
    for name in names:
        cfg = jreg.get(name).smoke_config.pad_for_mesh(2)
        tree = jax.tree.map(np.asarray, init_tree(jreg.get(name).param_defs(cfg), jax.random.PRNGKey(0),
                                                  cfg.param_dtype))
        out[name] = ranks.seed_leaves(tree)
    return out


def reference_logits(name, params):
    """The JAX reference's digital prefill logits and its first
    ``ranks.DECODE_STEPS`` decode steps' on ``params`` (numpy), jitted."""
    jarch = jreg.get(name)
    jc = jarch.smoke_config.pad_for_mesh(2)
    tarch, tcfg = ranks.cfg_of(name, "digital")
    prompt, steps = _inputs(tcfg)
    batch, _ = ranks.batch_of(tarch, tcfg, prompt)
    jbatch = {k: jnp.asarray(v.numpy(), jnp.int32 if k == "tokens" else jnp.float32) for k, v in batch.items()}
    prefill = jax.jit(lambda p, b: jarch.prefill(p, b, jc, MAX_SEQ))
    decode = jax.jit(lambda p, t, c: jarch.decode(p, t, c, jc))
    logits, cache = prefill(params, jbatch)
    out = [np.asarray(logits)]
    for t in steps[:ranks.DECODE_STEPS]:
        logits, cache = decode(params, jnp.asarray(t.numpy(), jnp.int32), cache)
        out.append(np.asarray(logits))
    return out


def f64_logits(name, params):
    """The port's replicated prefill and decode logits in f64 (digital,
    one process): the reference point of the recurrent bar."""
    from repro_torch.weights import params_from_jax

    arch, cfg = ranks.cfg_of(name, "digital")
    c64 = dataclasses.replace(cfg, param_dtype=torch.float64, compute_dtype=torch.float64)
    prompt, steps = _inputs(cfg)
    batch, _ = ranks.batch_of(arch, cfg, prompt)
    batch = {k: v if k == "tokens" else v.double() for k, v in batch.items()}
    p = params_from_jax(params, c64, "cpu")
    with torch.no_grad():
        logits, cache = arch.prefill(p, batch, c64, MAX_SEQ)
        out = [logits.numpy()]
        for t in steps[:ranks.DECODE_STEPS]:
            logits, cache = arch.decode(p, t, cache, c64)
            out.append(logits.numpy())
    return out


def _block(shape, spec, sizes):
    out = []
    for d, n in enumerate(shape):
        part = spec[d] if d < len(spec) else None
        names = () if part is None else (part if isinstance(part, tuple) else (part,))
        out.append(n // math.prod(sizes[a] for a in names))
    return tuple(out)


def check_leaf_blocks(name, model):
    """Every parameter and decode-cache leaf's block on an abstract (data
    16 / 2, model ``model``) mesh, the smoke config padded for it: where
    the reference's ``resolve_spec`` places a dimension along a logical
    name the port places (``placed_parts``), the port's block is the
    reference's; any other placed dimension is whole and listed under the
    dry run's ``replicated_by_port``.  Returns the names placed."""
    dims = (16 if model == 16 else 2, model)
    jmesh = compat.abstract_mesh(dims, ("data", "model"))
    tmesh = tshd.abstract_mesh(dims, ("data", "model"))
    sizes = dict(zip(("data", "model"), dims))
    arch = treg.get(name)
    cfg = arch.smoke_config.pad_for_mesh(model)
    shape = treg.ShapeSpec("decode16", 16, 16, "decode")
    placed = set(tshd.placed_parts(arch.placement_sizes(cfg, shape), tmesh))
    gaps = {(g["leaf"], g["logical"]) for g in dryrun.replicated_leaves(arch, cfg, shape, tmesh)}
    glob, axes = arch.param_specs(cfg, shape)
    loc, _ = arch.param_specs(cfg, shape, mesh=tmesh)
    (_, _), (cache, cache_axes) = arch.decode_specs(cfg, shape)
    (_, _), (lcache, _) = arch.decode_specs(cfg, shape, mesh=tmesh)
    leaves = [(f"params/{k}", s, a, ls) for (k, s), a, ls in zip(
        tree_items(glob).items(), tshd._axes_items(axes, tree_items(glob)).values(), tree_items(loc).values())]
    leaves += [(f"inputs/cache/{k}", s, a, ls) for (k, s), a, ls in zip(
        tree_items(cache).items(), tshd._axes_items(cache_axes, tree_items(cache)).values(),
        tree_items(lcache).values())]
    for key, spec, ax, local in leaves:
        ref = jshd.resolve_spec(spec.shape, tuple(ax), jmesh)
        want = _block(spec.shape, ref, sizes)
        for d, (n, name_d) in enumerate(zip(spec.shape, ax)):
            part = ref[d] if d < len(ref) else None
            if part is not None and name_d in placed:
                assert local.shape[d] == want[d], (key, d, name_d)
            else:
                assert local.shape[d] == n, (key, d, name_d)
                if part is not None:
                    assert (key, name_d) in gaps, (key, name_d)
    return placed


def reference_param_bytes(name):
    """The bytes of one device's blocks of the reference's parameters on
    the ``single`` (16, 16) mesh: each leaf's ``resolve_spec`` block."""
    jarch = jreg.get(name)
    cfg = jarch.config.pad_for_mesh(16)
    mesh = compat.abstract_mesh((16, 16), ("data", "model"))
    total = 0
    for p in jax.tree.leaves(jarch.param_defs(cfg), is_leaf=lambda x: isinstance(x, JP)):
        spec = tuple(jshd.resolve_spec(p.shape, p.axes, mesh))
        total += math.prod(_block(p.shape, spec, mesh.shape)) * jnp.dtype(p.dtype or cfg.param_dtype).itemsize
    return total


def port_param_bytes(name):
    """The bytes of one rank's parameter blocks in the port's decode_32k
    cell on the ``single`` (16, 16) mesh: the registry's placed specs,
    which the dry run materializes (its ``param_bytes``)."""
    arch = treg.get(name)
    cfg = arch.config.pad_for_mesh(16)
    specs, _ = arch.param_specs(cfg, treg.SHAPES["decode_32k"], mesh=tshd.abstract_mesh((16, 16), ("data", "model")))
    return sum(s.nbytes for s in tree_items(specs).values())


def start_cells(names, out):
    """The full-width decode_32k cells of ``names``, each a subprocess of
    the dry run's CLI (fake tensors on the CPU)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    return {name: subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", name, "--shape",
                                    "decode_32k", "--mesh", "single", "--device", "cpu", "--out", str(out)],
                                   env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
            for name in names}


def read_cells(out, procs):
    res = {}
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-2000:]
        res[name] = json.loads(dryrun._cell_path(out, name, "decode_32k", "single").read_text())
    return res


def stop_cells(procs):
    for proc in procs.values():
        proc.kill()
        proc.communicate()

"""End-to-end serving example (the paper's kind: inference).

Serves a reduced qwen2-0.5b through the paged continuous-batching
scheduler (``repro_torch.serving``: block KV cache + chunked prefill
interleaved with decode), with every weight GEMM routed through the
photonic SMWA DPU datapath (int8, bit-sliced, psum-chunked), then repeats
with the exact float path and reports agreement and throughput.  The
weights are the reference example's: ``init_tree`` under ``PRNGKey(0)``.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

Reference: ``examples/serve_lm.py``.
"""

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import prng
from repro_torch._device import resolve_device
from repro_torch.core.dpu import DPUConfig
from repro_torch.examples import add_device_arg, backend_for
from repro_torch.models import registry
from repro_torch.models.common import init_tree
from repro_torch.serving import Request, Scheduler, ServingConfig

SERVING = ServingConfig(batch_size=4, max_seq=64, block_size=16, chunk_tokens=16)
PROMPT_LENGTHS = [8, 40, 8, 8, 40, 8, 8, 8]  # long prompts chunk; short ones don't wait


def run(photonic: bool, params, arch, cfg, prompts, device):
    if photonic:
        cfg = dataclasses.replace(
            cfg, photonic=DPUConfig(organization="SMWA", bits=4, datarate_gs=5.0),
            photonic_backend=backend_for(device))
    sch = Scheduler(arch, cfg, params, SERVING, device=device)
    if sch.photonic is not None:
        print(f"  engine: {sch.photonic.describe()} (weights prepacked once)")
    reqs = [Request(uid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(prompts)]
    t0 = time.time()
    sch.run(reqs)
    dt = time.time() - t0
    toks = sum(len(r.output) for r in reqs)
    return reqs, toks / dt, sch.stats


def main(argv=None) -> dict:
    from repro_torch.launch import profile

    profile.apply()
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    dev = resolve_device(ap.parse_args(argv).device)
    arch = registry.get("qwen2-0.5b")
    cfg = dataclasses.replace(arch.smoke_config, remat=False)
    params = init_tree(arch.param_defs(cfg), prng.PRNGKey(0), cfg.param_dtype, dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in PROMPT_LENGTHS]

    exact_reqs, exact_tps, stats = run(False, params, arch, cfg, prompts, dev)
    print(f"float path:    {exact_tps:8.1f} tok/s  {stats}")
    photo_reqs, photo_tps, photo_stats = run(True, params, arch, cfg, prompts, dev)
    print(f"photonic path: {photo_tps:8.1f} tok/s  {photo_stats}")

    agree = float(np.mean([
        np.mean(np.array(a.output) == np.array(b.output))
        for a, b in zip(exact_reqs, photo_reqs)
    ]))
    print(f"token agreement photonic vs float: {agree:.2%}")
    print("sample output (req 0):", exact_reqs[0].output)
    return dict(float_tokens=[r.output for r in exact_reqs], photonic_tokens=[r.output for r in photo_reqs],
                float_tok_s=exact_tps, photonic_tok_s=photo_tps, float_stats=stats, photonic_stats=photo_stats,
                agreement=agree)


if __name__ == "__main__":
    main()

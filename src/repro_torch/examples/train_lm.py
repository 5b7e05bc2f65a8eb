"""Training example: a small LM on the synthetic pipeline with the full
fault-tolerance stack (checkpoint/resume, straggler watchdog, preemption).
``train()`` draws its weights from ``PRNGKey(seed)``, the reference's.

Pass --photonic to train *through* the photonic DPU forward path
(straight-through-estimator backward): photonic-aware QAT.  Routing is
per-site (``repro_torch.photonic.SitePolicy``): by default every weight
GEMM goes photonic except MoE routers.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] [--photonic] [--device cpu]

Reference: ``examples/train_lm.py``.
"""

import argparse
import dataclasses
import tempfile

from repro_torch._device import resolve_device
from repro_torch.core.dpu import DPUConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.examples import add_device_arg, backend_for
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import TrainConfig, train


def main(argv=None) -> dict:
    from repro_torch.launch import profile

    profile.apply()
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--photonic", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    arch = registry.get(args.arch)
    cfg = dataclasses.replace(
        arch.smoke_config,
        num_layers=4, d_model=128, d_ff=256, num_heads=4, num_kv_heads=2,
        vocab_size=512, remat=False,
    )
    if args.photonic:
        cfg = dataclasses.replace(
            cfg, photonic=DPUConfig(organization="SMWA", bits=4, datarate_gs=5.0),
            photonic_backend=backend_for(dev))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_")
    out = train(
        arch=arch,
        model_cfg=cfg,
        data_cfg=data,
        train_cfg=TrainConfig(steps=args.steps, ckpt_every=50, ckpt_dir=ckpt_dir),
        opt_cfg=adamw.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps),
        device=dev,
    )
    print(
        f"done: loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}, "
        f"{len(out['straggler_events'])} straggler events, ckpts in {ckpt_dir}"
    )
    return dict(out, ckpt_dir=ckpt_dir)


if __name__ == "__main__":
    main()

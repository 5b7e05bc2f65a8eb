"""Quickstart: the photonic DPU GEMM in five minutes.

1. Ask the scalability model (paper Eq.1-3) what DPE size N each
   organization supports at your precision/datarate.
2. Build a DPUConfig and run a GEMM through the photonic datapath.
3. Compare against the exact result; flip organizations and noise.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Reference: ``examples/quickstart.py``.  Its "pallas kernel == ref" line
is here the CUDA kernel against its plain twin (the same call on CPU
copies of the operands), on a card only.
"""

import argparse

import numpy as np
import torch

from repro_torch import prng
from repro_torch._device import resolve_device
from repro_torch.core import scalability as sc
from repro_torch.core.dpu import DPUConfig, noise_sigma_from_snr, photonic_matmul
from repro_torch.examples import add_device_arg, backend_for
from repro_torch.kernels.photonic_gemm.ops import photonic_gemm
from repro_torch.noise import build_channel_model
from repro_torch.photonic import engine_for, pack_dense


def _rel(y: torch.Tensor, exact: torch.Tensor) -> float:
    return float(torch.linalg.norm(y - exact) / torch.linalg.norm(exact))


def main(argv=None) -> dict:
    from repro_torch.launch import profile

    profile.apply()
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    dev = resolve_device(ap.parse_args(argv).device)
    backend = backend_for(dev)
    out = {}

    print("=== 1. scalability: achievable DPE size N (=M) ===")
    out["table_v"] = {}
    for org in ("ASMW", "MASW", "SMWA"):
        ns = [sc.calibrated_max_n(org, 4, dr) for dr in (1, 5, 10)]
        out["table_v"][org] = ns
        print(f"  {org}: N @ {{1,5,10}} GS/s = {ns}   (paper Table V: "
              f"{[sc.TABLE_V_N[(org, d)] for d in (1, 5, 10)]})")

    print("\n=== 2. GEMM through the SMWA DPU datapath ===")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(64, 256)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(size=(256, 128)).astype(np.float32)).to(dev)
    exact = x @ w

    cfg = DPUConfig(organization="SMWA", bits=4, datarate_gs=5.0)
    out["operating_point"] = (cfg.n, cfg.m, cfg.num_slices, cfg.passes, cfg.num_chunks(256))
    print(
        f"  operating point: N={cfg.n}, M={cfg.m}, "
        f"{cfg.num_slices} slices x {cfg.num_slices} = {cfg.passes} passes, "
        f"{cfg.num_chunks(256)} psum chunks for k=256"
    )
    y = photonic_matmul(x, w, cfg)
    out["ideal_rel"] = _rel(y, exact)
    print(f"  ideal datapath rel-error vs float GEMM: {out['ideal_rel']:.4f} (int8 quantization)")

    if dev.type == "cuda":
        y_kernel = photonic_gemm(x, w, cfg, "kernel")
        y_twin = photonic_gemm(x.cpu(), w.cpu(), cfg, "kernel")  # CPU tensors take the twin
        out["kernel_equals_twin"] = bool(torch.allclose(y_kernel.cpu(), y_twin))
        print(f"  cuda kernel == twin: {out['kernel_equals_twin']}")
    else:
        out["kernel_equals_twin"] = None
        print("  cuda kernel == twin: needs a card (run with --device cuda)")

    print("\n=== 3. analog noise at the scalability budget ===")
    out["noise"] = []
    for mult in (1.0, 4.0):
        sigma = mult * noise_sigma_from_snr(cfg)
        ncfg = DPUConfig(organization="SMWA", bits=4, datarate_gs=5.0, noise_sigma_lsb=sigma)
        yn = photonic_matmul(x, w, ncfg, prng_key=prng.PRNGKey(0))
        rel = _rel(yn, exact)
        out["noise"].append((mult, sigma, rel))
        print(f"  noise {mult:>3.0f}x budget (sigma={sigma:.1f} LSB): rel-error {rel:.4f}")

    print("\n=== 4. the organization-aware channel model (repro_torch.noise) ===")
    out["channels"] = {}
    for org in ("ASMW", "MASW", "SMWA"):
        ch = build_channel_model(org, n=17, bits=4, datarate_gs=5.0)
        ocfg = DPUConfig(organization=org, bits=4, dpe_size=17, channel=ch, noise_seed=0)
        rel = _rel(photonic_matmul(x, w, ocfg), exact)
        out["channels"][org] = (ch.through_loss_db, ch.detector_sigma_lsb, ch.intermod_eps, ch.crossweight_eps,
                                ch.filter_alpha, rel)
        print(
            f"  {org}: through-loss {ch.through_loss_db:.2f} dB, "
            f"sigma {ch.detector_sigma_lsb:.1f} LSB, "
            f"xtalk (im/cw/filt) = ({ch.intermod_eps:.3f}/"
            f"{ch.crossweight_eps:.3f}/{ch.filter_alpha:.3f}) "
            f"-> rel-error {rel:.4f}"
        )

    print("\n=== 5. the execution engine: prepacked weight-stationary GEMM ===")
    eng = engine_for(cfg, backend)
    out["describe"] = str(eng.describe())
    print(f"  {out['describe']}")
    packed = pack_dense({"w": w}, eng)["w"]
    y_pack = eng.matmul(x, packed, site="demo")
    y_call = eng.matmul_float(x, w, site="demo")
    out["prepacked_equal"] = bool(torch.equal(y_pack, y_call))
    print(f"  prepacked == per-call quantization: {out['prepacked_equal']}  ({packed})")
    out["routes"] = (eng.routes("ffn.wi"), eng.routes("ffn.router"))
    print(
        "  routing policy: "
        f"routes('ffn.wi')={out['routes'][0]}, "
        f"routes('ffn.router')={out['routes'][1]} "
        "(MoE routing stays digital by default)"
    )
    return out


if __name__ == "__main__":
    main()

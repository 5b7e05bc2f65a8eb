"""One-shot paper reproduction: runs every paper experiment and prints a
side-by-side comparison with the published claims.  Analytic: it runs on
the host whatever ``--device`` says.

Run:  PYTHONPATH=src python -m repro_torch.examples.paper_repro [--device cpu]

Reference: ``examples/paper_repro.py``.
"""

import argparse

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import scalability as sc
from repro_torch.core.simulator import evaluate_all
from repro_torch.examples import add_device_arg

MODELS = ("googlenet", "resnet50", "mobilenet_v2", "shufflenet_v2")


def gmean(x):
    return float(np.exp(np.mean(np.log(x))))


def main(argv=None) -> dict:
    from repro_torch.launch import profile

    profile.apply()
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    resolve_device(ap.parse_args(argv).device)
    print("=" * 72)
    print("Table V — achievable DPU size N (B=4): ours vs paper")
    print("=" * 72)
    ours = sc.table_v()
    exact = 0
    for (org, dr), n_paper in sorted(sc.TABLE_V_N.items()):
        n = ours[(org, dr)]
        mark = "==" if n == n_paper else f"ours {n}"
        exact += n == n_paper
        print(f"  {org} @ {dr:>2} GS/s: paper N={n_paper:>3}   {mark}")
    print(
        f"  -> {exact}/9 cells exact, calibration residual "
        f"{sc.calibration().mean_abs_rel_err:.1%} mean abs"
    )

    print()
    print("=" * 72)
    print("Fig. 7 — SMWA advantage (gmean | max over 4 CNNs): ours vs paper")
    print("=" * 72)
    res = evaluate_all()
    paper_fps = {(1, "ASMW"): 2.5, (5, "ASMW"): 3.9, (10, "ASMW"): 4.4,
                 (1, "MASW"): 2.3, (5, "MASW"): 3.6, (10, "MASW"): 3.9}
    ratios = {}
    for dr in (1, 5, 10):
        for other in ("ASMW", "MASW"):
            r = [res[("SMWA", dr, m)].fps / res[(other, dr, m)].fps for m in MODELS]
            ratios[(dr, other)] = r
            print(
                f"  FPS SMWA/{other} @ {dr:>2} GS/s: "
                f"ours g{gmean(r):.2f}/max{max(r):.2f}"
                f"   paper 'up to' {paper_fps[(dr, other)]}x"
            )
    # Trend checks the paper asserts:
    f = lambda o, dr: res[(o, dr, "resnet50")].fps  # noqa: E731
    trends = (
        all(f(o, 1) > f(o, 5) > f(o, 10) for o in ("ASMW", "MASW", "SMWA")),
        all(f("MASW", d) >= f("ASMW", d) for d in (1, 5, 10)),
    )
    print("\n  trends: FPS decreases with DR for every org:", trends[0])
    print("  trends: MASW slightly beats ASMW everywhere:", trends[1])
    return dict(table_v=ours, exact_cells=exact, ratios=ratios, trends=trends)


if __name__ == "__main__":
    main()

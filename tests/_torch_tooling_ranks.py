"""Rank bodies for the port's tooling tests (``tests/test_torch_tooling.py``).

Each function runs in every rank of a group that
``repro_torch.launch.mesh.spawn`` starts on the ``gloo`` backend (CPU) and
returns plain Python values for the test process to check.  This module
imports no ``jax``.
"""

import numpy as np
import torch
import torch.distributed as dist

# (elements, dtype) of each known collective's tensor
SIZES = {"all_reduce": (1000, torch.float32), "all_gather": (96, torch.int32), "reduce_scatter": (64, torch.float32),
         "send": (250, torch.int8)}


def collectives_suite(rank, world):
    """Known collectives under a ``Recorder``: an all-reduce, an
    all-gather into a tensor, a reduce-scatter of a tensor, and one ring
    hop of point-to-point send / recv (rank r sends to r + 1, receives from
    r - 1); then a ``ContractChecker`` over one and over two chained
    ``psum_int_gemm`` calls on the whole group.  Returns the records, the
    summary and the checkers' counts."""
    from repro_torch.analysis.contracts import ContractChecker, ContractViolation
    from repro_torch.core.dpu import DPUConfig
    from repro_torch.launch import hlo_analysis
    from repro_torch.photonic import engine_for, psum_int_gemm

    n, dt = SIZES["all_reduce"]
    ar = torch.ones(n, dtype=dt)
    n, dt = SIZES["all_gather"]
    ag_in, ag_out = torch.full((n,), rank, dtype=dt), torch.empty(n * world, dtype=dt)
    n, dt = SIZES["reduce_scatter"]
    rs_in, rs_out = torch.ones(n * world, dtype=dt), torch.empty(n, dtype=dt)
    n, dt = SIZES["send"]
    msg, got = torch.full((n,), rank, dtype=dt), torch.empty(n, dtype=dt)
    with hlo_analysis.Recorder() as rec:
        dist.all_reduce(ar)
        dist.all_gather_into_tensor(ag_out, ag_in)
        dist.reduce_scatter_tensor(rs_out, rs_in)
        ops = [dist.P2POp(dist.isend, msg, (rank + 1) % world), dist.P2POp(dist.irecv, got, (rank - 1) % world)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    out = {
        "records": [(r.kind, r.out_bytes, r.group_size) for r in rec.collectives],
        "summary": hlo_analysis.collective_summary(rec.collectives),
        "values_ok": bool(ar.eq(world).all() and torch.equal(ag_out, torch.arange(world).repeat_interleave(96).int())
                          and rs_out.eq(world).all() and got.eq((rank - 1) % world).all()),
    }

    eng = engine_for(DPUConfig(organization="SMWA", bits=4, datarate_gs=5.0), "ref")
    rng = np.random.default_rng(0)
    xq = torch.from_numpy(rng.integers(-7, 8, (4, 16)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-7, 8, (16, 16)).astype(np.int8))

    def chain(n_gemms):
        def body(a, b):
            y = psum_int_gemm(eng, a, b, group=dist.group.WORLD, site="ffn.wi")
            for _ in range(n_gemms - 1):
                y = psum_int_gemm(eng, y.clamp(-7, 7).to(torch.int8), b, group=dist.group.WORLD, site="ffn.wo")
            return y

        return ContractChecker.record(body, xq, wq, label=f"{n_gemms}-gemm")

    one, two = chain(1), chain(2)
    one.assert_psum_per_gemm(1)
    two.assert_psum_per_gemm(2)
    try:
        two.assert_psum_per_gemm(1)
        out["mismatch_raises"] = False
    except ContractViolation as e:
        out["mismatch_raises"] = "psum" in str(e)
    out["psum_counts"] = [one.all_reduces(), two.all_reduces()]
    out["psum_wire_bytes"] = two.collective_summary()["bytes_all-reduce"]
    return out

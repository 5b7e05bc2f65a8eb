"""The port's server under the SMWA analog channel against the JAX server.

Both schedulers run the small qwen2 config (``tests/test_serving.py``) in
f32 with the reference's weights, every weight GEMM through the noisy SMWA
channel (filter truncation + detector noise, ``noise_seed=0``): the port on
its ``kernel`` backend (the CUDA kernel's twin on CPU), the reference on
``pallas`` in interpret mode, i.e. the same tile-seeded noise stream.  The
DPE size is 128 so the reference's interpret-mode kernels stay small.

Greedy tokens are held equal and logits at ``atol=1e-5``.  This holds only
while every GEMM quantizes its activation identically on both sides: the
noise seed hashes the int8 activation, so a single one-LSB quantization
flip would draw a different (equally valid) stream for that GEMM.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.dpu import DPUConfig as JDPU  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.common import init_tree  # noqa: E402
from repro.noise.channel import build_channel_model as jbuild  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import ServingConfig as JServingConfig  # noqa: E402
from repro_torch.core.dpu import DPUConfig as TDPU  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.noise.channel import build_channel_model as tbuild  # noqa: E402
from repro_torch.serving import Request as TRequest  # noqa: E402
from repro_torch.serving import Scheduler as TScheduler  # noqa: E402
from repro_torch.serving import ServingConfig as TServingConfig  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)
SC = dict(batch_size=2, max_seq=32, block_size=8, chunk_tokens=8, record_logits=True)


def test_smwa_server_matches_reference_pallas_interpret():
    ja, ta = jreg.get("qwen2-0.5b"), treg.get("qwen2-0.5b")
    jc = dataclasses.replace(
        ja.smoke_config, remat=False, **SMALL, photonic_backend="pallas",
        photonic=JDPU(organization="SMWA", bits=4, dpe_size=128,
                      channel=jbuild("SMWA", n=128, bits=4), noise_seed=0),
    )
    tc = dataclasses.replace(
        ta.smoke_config, **SMALL, photonic_backend="kernel",
        photonic=TDPU(organization="SMWA", bits=4, dpe_size=128,
                      channel=tbuild("SMWA", n=128, bits=4), noise_seed=0),
    )
    params = init_tree(ja.param_defs(jc), jax.random.PRNGKey(0), jc.param_dtype)
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, 64, 8).astype(np.int32) for _ in range(2)]

    js = JScheduler(ja, jc, params, JServingConfig(**SC))
    jr = [JRequest(uid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(prompts)]
    js.run(jr)
    ts = TScheduler(
        ta, tc, params_from_jax(jax.tree.map(np.asarray, params), tc, "cpu"),
        TServingConfig(**SC), device="cpu",
    )
    tr = [TRequest(uid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(prompts)]
    ts.run(tr)
    assert ts.photonic.describe().channel == "analog"
    for a, b in zip(jr, tr):
        assert b.done and a.output == b.output
        for x, y in zip(a.logits, b.logits):
            np.testing.assert_allclose(y, np.asarray(x), atol=1e-5, rtol=1e-5)
    # The noise is live: the same server on the ideal channel answers otherwise.
    ideal = dataclasses.replace(tc, photonic=TDPU(organization="SMWA", bits=4, dpe_size=128))
    ti = TScheduler(
        ta, ideal, params_from_jax(jax.tree.map(np.asarray, params), tc, "cpu"),
        TServingConfig(**SC), device="cpu",
    )
    ri = [TRequest(uid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(prompts)]
    ti.run(ri)
    assert any(
        not np.array_equal(x, y) for a, b in zip(tr, ri) for x, y in zip(a.logits, b.logits)
    )

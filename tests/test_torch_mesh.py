"""The port's mesh helpers (``repro_torch.launch.mesh``) against the
reference's ``repro.launch.mesh``.

Without a process group the port sees one rank, as the reference's CPU
JAX sees one device: ``max_tp_degree`` is 1 and ``require_devices`` raises
with the reference's sentence.  Inside spawned ``gloo`` groups of 2 and 4
ranks (``repro_torch.launch.mesh.spawn``, a ``FileStore`` rendezvous, so
no port can collide under ``-n 6``): the meshes' axis names, shapes and
each rank's coordinates; the production meshes refuse with the number of
devices they need; the int32 sum over the model axis wraps as JAX's int32
``psum`` does; a failing rank fails ``spawn`` with its traceback.  On the
card (``cuda`` marker): two ranks sharing it over ``gloo`` with CUDA
tensors run ``dense`` under ``tensor_parallel`` on the CUDA kernels,
bitwise the unsharded kernels.  JAX is imported inside the tests that
call the reference, so the ``cuda`` test also runs where JAX is absent.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_tp_ranks as ranks  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402


@pytest.fixture(scope="module")
def jmesh():
    pytest.importorskip("jax")
    from repro.launch import mesh

    return mesh


def _first_sentence(msg: str) -> str:
    return msg.split(". ")[0] + "."


def test_one_rank_without_a_process_group(jmesh):
    assert M.max_tp_degree() == jmesh.max_tp_degree() == 1
    M.require_devices(1)
    with pytest.raises(RuntimeError) as got:
        M.require_devices(2)
    with pytest.raises(RuntimeError) as want:
        jmesh.require_devices(2)
    assert _first_sentence(str(got.value)) == _first_sentence(str(want.value)) == "need 2 devices but have 1."
    with pytest.raises(RuntimeError, match="need 256 devices but have 1"):
        M.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="default process group"):
        M.make_smoke_mesh(device="cpu")


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def group(request):
    return request.param, M.spawn(ranks.mesh_suite, request.param, backend="gloo", timeout=300)


def test_spawn_returns_each_ranks_result_in_order(group):
    world, res = group
    assert len(res) == world and [r["world"] for r in res] == [world] * world


def test_max_tp_degree_counts_the_live_ranks(group):
    world, res = group
    for r in res:
        assert r["max_tp"] == world and r["max_tp_2"] == 2


def test_tp_smoke_mesh_axes_shape_and_coordinates(group):
    world, res = group
    for i, r in enumerate(res):
        assert r["tp_mesh"] == (("data", "model"), (1, world), i, 0)
        assert r["smoke_mesh"] == (("data", "model"), (1, 1))


def test_data_by_model_mesh_is_row_major(group):
    world, res = group
    for i, r in enumerate(res):
        assert r["dp_tp_mesh"] == (("data", "model"), (world // 2, 2), i // 2, i % 2)


@pytest.mark.parametrize("what,need", [("production", 256), ("multi_pod", 512), ("too_wide", None)])
def test_meshes_wider_than_the_group_refuse(group, jmesh, what, need):
    world, res = group
    need = need or 2 * world
    with pytest.raises(RuntimeError) as want:
        jmesh.require_devices(need)
    msg = res[0]["errors"][what]
    assert msg.startswith(f"need {need} devices but have {world}.")
    assert _first_sentence(str(want.value)).split(" but")[0] == msg.split(" but")[0]


def test_axes_and_shape_must_agree(group):
    _, res = group
    assert "differ in length" in res[0]["errors"]["ragged"]


def test_int32_sum_wraps_as_jax_int32_psum(group, jmesh):
    import jax.numpy as jnp

    world, res = group
    vals = np.array([[2**31 - 1, -(2**31), i] for i in range(world)], np.int32)
    want = np.asarray(jnp.sum(jnp.asarray(vals), axis=0, dtype=jnp.int32)).tolist()
    for r in res:
        assert r["int32_sum"] == want


def test_a_failing_rank_fails_spawn_with_its_traceback():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        M.spawn(ranks.failing_rank, 2, backend="gloo", timeout=120)


@pytest.mark.cuda
def test_two_ranks_on_one_card_bitwise_unsharded():
    """Two ranks on one card over gloo with CUDA tensors: ``dense`` under
    ``tensor_parallel`` on the CUDA kernels (one unfused launch and one
    all-reduce a GEMM), bitwise the unsharded kernels on the ideal
    channel, for a float weight and a K-sharded pack."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    res = M.spawn(ranks.cuda_suite, 2, backend="gloo", device="cuda", timeout=600)
    for r in res:
        for base, tp, n in r.values():
            np.testing.assert_array_equal(tp, base)
            assert n == 1

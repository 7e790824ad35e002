"""The superblock layer's mesh branch against the reference's, on the CPU:
tests/test_superblocks.py:52
(`test_one_program_per_level_across_superblock_counts`) at D = 2 and 4,
the port on D gloo ranks (`run_on_mesh`, bodies in
tests/test_torch_mesh_ranks.py) and the reference on
`make_mesh(n_devices=D)` of tests/conftest.py's 8 virtual devices.  With a
mesh, the batched coarse level (superblocks as pools, kc 1) runs
`pool_sharded_coarse` and the fine batch `pool_sharded_match`; the port's
assignments and geometry equal the reference's at the same D and the
port's own run without a mesh, and its compile observatory hears one
padded shape per level across 5, 6 and 7 superblocks, where the
reference's compiles one program per level."""
import pytest
import torch

import jax

from cook_tpu.parallel.mesh import make_mesh
from cook_tpu_torch.parallel import mesh as port_mesh
from tests import test_torch_mesh_ranks as ranks
from tests.test_torch_mesh_scheduler import (
    GROUP_TIMEOUT_S,
    MESH_SIZES,
    check_hierarchical,
    hier_inputs,
    ref_hier,
)

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

# tests/test_superblocks.py:52: 5, 6 and 7 superblocks of 64 nodes
SUPERBLOCKS = [(dict(j=512, n=n, seed=n),
                dict(nodes_per_block=32, superblock_nodes=64, chunk=64,
                     kc=32))
               for n in (320, 384, 448)]


@pytest.fixture(scope="module", params=MESH_SIZES,
                ids=[f"D{d}" for d in MESH_SIZES])
def runs(request):
    d = request.param
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    port, (sb, programs) = ranks.alongside(
        lambda: port_mesh.run_on_mesh(
            d, ranks.scheduler_cases,
            dict(superblocks=hier_inputs(SUPERBLOCKS)), backend="gloo",
            device="cpu", timeout_s=GROUP_TIMEOUT_S),
        lambda: ref_hier(SUPERBLOCKS, make_mesh(n_devices=d)))
    return d, dict(superblocks=sb, superblocks_programs=programs), port


def test_superblock_mesh_solves_like_the_reference(runs):
    _, ref, port = runs
    check_hierarchical(ref, port, "superblocks", SUPERBLOCKS)
    for (shape, _), (_, stats) in zip(SUPERBLOCKS, ref["superblocks"]):
        assert stats["superblocks"] == shape["n"] // 64
        assert stats["super_shape"] == (512, 8)
        assert stats["coarse_shape"] == (8, 256, 2)
        assert stats["fine_shape"] == (16, 128, 32)


def test_superblock_rank_reads_its_mesh(runs):
    # every rank's accessor returns its mesh, which the config lets the
    # two-level path use
    assert runs[2]["hier_mesh"] == (True, True)

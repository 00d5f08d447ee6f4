"""The sharding resolver and the mesh constructors, on the CPU.

``repro_torch.distributed.sharding.spec_for`` against the reference's on
the same shapes and logical axes over the production mesh shapes
{"pod": 2, "data": 16, "model": 16} and (16, 16), and the small (4, 2)
and (1, 1) ones (the reference's resolver reads only ``mesh.shape``, so a
stand-in carries the sizes); ``batch_sharding``'s spec against the
reference's, which rows each rank of a 2 x 2 gloo mesh holds, and the
mesh constructors' errors.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.distributed import sharding as jshard  # noqa: E402
from repro_torch.distributed import sharding as tshard  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
import torch_fleet_workers as workers  # noqa: E402

MESHES = [{"pod": 2, "data": 16, "model": 16}, {"data": 16, "model": 16},
          {"data": 4, "model": 2}, {"data": 1, "model": 1}]
# (shape, logical axes): parameters and activations of the LM stack's
# kinds, dims that divide some axes and not others, axis reuse
CASES = [
    ((1024, 4096), ("embed", "mlp")),
    ((4096, 1024), ("mlp", "embed")),
    ((32, 2048, 64), ("act_batch", "act_seq", "act_embed")),
    ((8, 128, 16, 64), ("act_batch", None, "act_heads", "head_dim")),
    ((6, 100), ("act_batch", "act_vocab")),
    ((25, 64, 48), ("heads", "embed", "head_dim")),
    ((12, 8, 16, 384, 128), ("layers", "act_batch", "act_kv", "act_kvlen",
                             None)),
    ((50304, 512), ("vocab", "embed")),
    ((64, 8, 256), ("experts", "embed", "mlp")),
    ((3, 5), (None, None)),
    ((16, 16), ("embed", "embed")),
]


def _want(shape, axes, sizes):
    spec = jshard.spec_for(shape, axes, types.SimpleNamespace(shape=sizes))
    return tuple(spec)


@pytest.mark.parametrize("sizes", MESHES, ids=lambda m: "x".join(
    f"{k}{v}" for k, v in m.items()))
@pytest.mark.parametrize("shape,axes", CASES)
def test_spec_for_matches_reference(shape, axes, sizes):
    assert tshard.spec_for(shape, axes, sizes) == _want(shape, axes, sizes)


@pytest.mark.parametrize("sizes", MESHES, ids=lambda m: "x".join(
    f"{k}{v}" for k, v in m.items()))
@pytest.mark.parametrize("shape", [(512, 7), (32, 3, 2), (6,), (1, 9)])
def test_batch_sharding_matches_reference(shape, sizes):
    got = tshard.batch_sharding(sizes, shape)
    want = _want(shape, ["act_batch"] + [None] * (len(shape) - 1), sizes)
    assert got.spec == want
    axes = want[0] if want else None
    axes = () if axes is None else (axes,) if isinstance(axes, str) else axes
    assert got.shards == int(np.prod([sizes[a] for a in axes]))
    assert got.index == 0
    assert got.rows(shape[0]) == slice(0, shape[0] // got.shards)


def test_batch_sharding_on_a_one_by_one_jax_mesh():
    """The reference's own ``batch_sharding`` on a real (1, 1) mesh."""
    mesh = jax.make_mesh((1, 1), ("pod", "data"))
    want = jshard.batch_sharding(mesh, (8, 3))
    got = tshard.batch_sharding({"pod": 1, "data": 1}, (8, 3))
    assert got.spec == tuple(want.spec)


def test_mesh_rules_context():
    assert tshard.active_mesh() is None
    with tshard.use_mesh_rules({"data": 2}):
        assert tshard.active_mesh() == {"data": 2}
    assert tshard.active_mesh() is None


def test_each_rank_holds_its_rows(tmp_path):
    """On a 2 x 2 gloo mesh, rank (pod, data) holds row block 2 pod + data
    of a batch of 8, the reference's ``P(("pod", "data"))`` layout."""
    workers.spawn(_rows_worker, 4, str(tmp_path))
    for rank in range(4):
        got = np.load(tmp_path / f"rows{rank}.npy")
        np.testing.assert_array_equal(got, [2 * rank, 2 * rank + 1])


def _rows_worker(rank, world, port, out):
    import torch.distributed as dist
    from repro_torch.training.steps import sim_batch_shardings
    workers.join(rank, world, port)
    mesh = tmesh.make_fleet_mesh(pods=2)
    sh = tshard.batch_sharding(mesh, (8, 3))
    assert sh.spec == (("pod", "data"),) and sh.shards == 4
    assert sim_batch_shardings({"actions": torch.empty(8, 5)},
                               mesh)["actions"] == sh
    np.save(f"{out}/rows{rank}.npy", np.arange(8)[sh.rows(8)])
    dist.destroy_process_group()


def test_mesh_constructors_raise():
    """Importing the module starts no process group; the constructors say
    what they need."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="3 devices do not split into 2"):
        tmesh.make_fleet_mesh(3, pods=2)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_fleet_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh_for()


def test_backend_choice():
    """gloo on the CPU and where ranks outnumber the cards; the CUDA
    choice needs cards (``chip_smoke.py`` phase 12c takes NCCL)."""
    assert tmesh.fleet_backend(4, "cpu") == "gloo"
    assert tmesh.fleet_backend(1, "cpu") == "gloo"
    if torch.cuda.device_count() == 0:
        assert tmesh.fleet_backend(1, "cuda") == "gloo"


def test_sim_input_specs_match_reference():
    """One training batch's stand-ins: the reference's ShapeDtypeStructs'
    shapes and dtypes, as meta tensors (no storage)."""
    from repro.scenarios.core import ScenarioConfig as JScen
    from repro.training.steps import sim_input_specs as jspecs
    from repro_torch.scenarios.core import ScenarioConfig as TScen
    from repro_torch.training.steps import sim_input_specs as tspecs
    kw = dict(num_map=8, num_agents=3, num_steps=7)
    want = jspecs(JScen(**kw), 16)
    got = tspecs(TScen(**kw), 16)
    assert sorted(got) == sorted(want)
    for k, spec in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(spec.shape), k
        assert str(got[k].dtype).split(".")[-1] == str(spec.dtype), k

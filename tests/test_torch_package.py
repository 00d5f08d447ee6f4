"""The port's package contract: it imports nothing of JAX or of the JAX
package, its entry points refuse to run on the CPU unless asked, and the
weight bridge round-trips exactly."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.nn import agent_sim as jsim  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro_torch import configs, params  # noqa: E402
from repro_torch.nn import agent_sim as tsim  # noqa: E402
from repro_torch.runtime import RolloutEngine, SimServer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "benchmarks").glob("torch_*.py"))
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                       re.MULTILINE)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax_and_no_reference(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: imports {hits}"


def test_port_import_loads_no_jax_module():
    code = ("import sys, repro_torch, repro_torch.configs, repro_torch.params,"
            " repro_torch.runtime, repro_torch.scenarios, repro_torch.kernels,"
            " repro_torch.optim, repro_torch.training, repro_torch.data,"
            " repro_torch.obs, repro_torch.checkpoint,"
            " repro_torch.runtime.trainer, repro_torch.training.comparison,"
            " repro_torch.launch.train_sim, repro_torch.launch.obs_report,"
            " repro_torch.launch.obs_merge, repro_torch.runtime.sim_server,"
            " repro_torch.chaos, repro_torch.launch.serve_sim,"
            " repro_torch.launch.chaos, repro_torch.prng,"
            " repro_torch.kernels.categorical, repro_torch.launch.mesh,"
            " repro_torch.distributed, repro_torch.distributed.sharding,"
            " repro_torch.distributed.dp_compress,"
            " repro_torch.optim.compression, repro_torch.nn.transformer,"
            " repro_torch.runtime.server, repro_torch.runtime.steps,"
            " repro_torch.launch.serve, repro_torch.launch.train,"
            " repro_torch.data.synthetic_lm;"
            " bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    arch = configs.get_sim_arch("sim-se2-fourier").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.AgentSimModel(arch.agent_sim_config())
    model = tsim.AgentSimModel(arch.agent_sim_config(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RolloutEngine(model, arch.scenario_config(), num_slots=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimServer(model, arch.scenario_config(), num_slots=2)


SIM_ARCHS = ["sim-absolute", "sim-rope2d", "sim-se2-fourier",
             "sim-se2-repr"]


@pytest.mark.parametrize("name", SIM_ARCHS)
def test_sim_arch_registered_and_builds(name):
    """Every sim arch builds, at full width and with the reference's
    parameter count and cache widths, and refuses the CPU unless asked."""
    assert sorted(configs.SIM_ARCHS) == SIM_ARCHS
    full = configs.get_sim_arch(name)
    assert (full.d_model, full.num_layers, full.num_heads, full.head_dim,
            full.d_ff, full.fourier_terms) == (256, 6, 8, 24, 1024, 12)
    cfg = full.agent_sim_config()
    model = tsim.AgentSimModel(cfg, device="cpu")
    jmodel = jsim.AgentSimModel(jsim.AgentSimConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name not in ("attn_impl", "decode_impl")}))
    assert sum(p.numel() for p in model.parameters()) == \
        jmodule.count_params(jmodel.specs())
    assert model.blocks[0].attn.cache_dims == jmodel.attn.cache_dims
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsim.AgentSimModel(cfg)


def _reference_tree(arch, seed):
    jmodel = jsim.AgentSimModel(jsim.AgentSimConfig(
        **{f: getattr(arch.agent_sim_config(), f) for f in (
            "d_model", "num_layers", "num_heads", "head_dim", "d_ff",
            "num_actions", "fourier_terms", "encoding")}))
    return jax.tree.map(np.asarray, jmodule.init_params(jmodel.specs(),
                                                        jax.random.key(seed)))


def test_params_round_trip_exact():
    arch = configs.get_sim_arch("sim-se2-fourier").reduced()
    tree = _reference_tree(arch, 3)
    model = tsim.AgentSimModel(arch.agent_sim_config(), device="cpu")
    model.load_state_dict(params.from_reference(tree), strict=True)
    back = params.to_reference(model)
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa
    want, got = flat(tree), flat(back)
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, arr in want.items():
        assert got[path].dtype == arr.dtype and got[path].shape == arr.shape
        np.testing.assert_array_equal(got[path], arr, err_msg=str(path))


def test_params_round_trip_carries_pose_proj():
    """The absolute baseline's top-level ``pose_proj`` Dense crosses over
    both ways bit for bit."""
    arch = configs.get_sim_arch("sim-absolute").reduced()
    tree = _reference_tree(arch, 4)
    model = tsim.AgentSimModel(arch.agent_sim_config(), device="cpu")
    model.load_state_dict(params.from_reference(tree), strict=True)
    np.testing.assert_array_equal(model.pose_proj.kernel.numpy(),
                                  tree["pose_proj"]["kernel"])
    back = params.to_reference(model)
    assert sorted(back) == sorted(tree)
    assert back["pose_proj"].keys() == tree["pose_proj"].keys()
    for key, arr in tree["pose_proj"].items():
        assert back["pose_proj"][key].dtype == arr.dtype
        np.testing.assert_array_equal(back["pose_proj"][key], arr)


def test_seeded_init_is_deterministic_and_shaped():
    cfg = configs.get_sim_arch("sim-se2-fourier").reduced().agent_sim_config()
    a = tsim.AgentSimModel(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(4))
    b = tsim.AgentSimModel(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(4))
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    assert torch.equal(a.blocks[0].norm1.scale, torch.ones(cfg.d_model))
    std = a.blocks[0].mlp.down.kernel.std().item()
    assert abs(std - cfg.d_ff ** -0.5) < 0.2 * cfg.d_ff ** -0.5

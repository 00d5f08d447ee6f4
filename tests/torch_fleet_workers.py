"""Multi-process helpers for the port's fleet tests (no JAX, no tests).

Each worker runs in a process of its own, joins a gloo group at
``tcp://localhost:<port>`` and writes what it computed under ``out``;
the tests compare the files. Workers run one CPU thread each, so their
numbers do not depend on how many other workers share the machine.
"""
import json
import os
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SCEN_KW = dict(num_map=8, num_agents=3, num_steps=7)
CFG = dict(d_model=48, num_layers=2, num_heads=2, head_dim=24, d_ff=96,
           fourier_terms=8)
T_HIST = 3


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(worker, world: int, *args):
    """Run ``worker(rank, world, port, *args)`` in ``world`` processes and
    wait for them; a worker that raises fails the call."""
    mp.spawn(worker, args=(world, free_port(), *args), nprocs=world,
             join=True)


def join(rank: int, world: int, port: int):
    from repro_torch.launch.mesh import init_fleet
    torch.set_num_threads(1)
    init_fleet(rank, world, f"tcp://localhost:{port}", device="cpu")


def tiny_model(scen, seed: int = 0, **kw):
    from repro_torch.nn.agent_sim import AgentSimConfig, AgentSimModel
    return AgentSimModel(
        AgentSimConfig(**{**CFG, **kw}, num_actions=scen.num_actions),
        device="cpu", generator=torch.Generator().manual_seed(seed))


def mixed_scenes(scen, n: int, seed: int = 5):
    """``n`` scenes dealt over the seven families in turn."""
    from repro_torch.scenarios import registry
    fams = registry.names()
    return [registry.generate_scene(fams[i % len(fams)], seed, i, scen)
            for i in range(n)]


# ---- fleet rollouts and evaluation ----------------------------------------

def fleet_worker(rank, world, port, out):
    """A 2 x 2 fleet: ``num_slots=6`` (rounded to 8) over 10 mixed scenes
    x 2 samples, and ``evaluate_families`` over the seven families; every
    rank also runs the single-process engine (8 slots) and the engine
    with its local lane count, and tries a mesh with a "model" axis."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.runtime.evaluation import EvalConfig, evaluate_families
    from repro_torch.runtime.rollout import RolloutEngine
    from repro_torch.scenarios.core import ScenarioConfig
    join(rank, world, port)
    scen = ScenarioConfig(**SCEN_KW)
    model = tiny_model(scen)
    scenes = mixed_scenes(scen, 10)
    mesh = make_fleet_mesh(pods=2)
    eng = RolloutEngine(model, scen, num_slots=6, device="cpu", mesh=mesh)
    run = dict(t_hist=T_HIST, n_samples=2, seed=9)
    fut = eng.run(scenes, **run)
    res = {"slots": [eng.num_slots, eng.local_slots], "fut": fut,
           "acts": eng.last_actions}
    one = RolloutEngine(model, scen, num_slots=8, device="cpu")
    res["one_fut"] = one.run(scenes, **run)
    res["one_acts"] = one.last_actions
    ecfg = EvalConfig(t_hist=T_HIST, n_samples=2, seed=4)
    tables = {
        "fleet": evaluate_families(model, scen, ecfg, n_scenes_per_family=1,
                                   num_slots=6, device="cpu", mesh=mesh),
        "one": evaluate_families(model, scen, ecfg, n_scenes_per_family=1,
                                 num_slots=8, device="cpu")}
    bad = DeviceMesh("cpu", torch.arange(world).reshape(2, world // 2),
                     mesh_dim_names=("data", "model"))
    try:
        RolloutEngine(model, scen, num_slots=4, device="cpu", mesh=bad)
        res["model_axis_error"] = ""
    except ValueError as e:
        res["model_axis_error"] = str(e)
    np.savez(os.path.join(out, f"fleet{rank}.npz"),
             **{k: np.asarray(v) for k, v in res.items()})
    with open(os.path.join(out, f"tables{rank}.json"), "w") as f:
        json.dump(tables, f)
    dist.destroy_process_group()


# ---- the compressed-DP step -----------------------------------------------

def dp_worker(rank, world, port, out, pods, data_path, compress, nan_rank):
    """The sim DP step over a (pods, world / pods) mesh from the weights
    and global batches in ``data_path`` (written by the reference's run);
    writes the losses and the final parameters. With ``nan_rank`` >= 0,
    first a global batch whose rows on that rank are NaN goes through the
    Trainer, which must leave every rank's state bitwise unchanged."""
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.params import from_reference, to_reference
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.scenarios.core import ScenarioConfig
    from repro_torch.training.steps import (bc_optimizer,
                                            make_sim_dp_train_step,
                                            sim_dp_state)
    join(rank, world, port)
    data = dict(np.load(data_path, allow_pickle=True))
    scen = ScenarioConfig(**SCEN_KW)
    model = tiny_model(scen)
    model.load_state_dict(from_reference(data["weights"].item()))
    mesh = make_fleet_mesh(pods=pods)
    opt = bc_optimizer(3e-3, 10)
    step = make_sim_dp_train_step(model, opt, mesh, compress=bool(compress))
    state = sim_dp_state(opt, dict(model.named_parameters()))
    batches = list(data["batches"])
    res = {}
    if nan_rank >= 0:
        bad = {k: v.copy() for k, v in batches[0].items()}
        per = bad["agent_feats"].shape[0] // world
        bad["agent_feats"][nan_rank * per:(nan_rank + 1) * per] = np.nan
        before = _state_arrays(model, state)
        trainer = Trainer(step, model, state, _Batches([bad]),
                          os.path.join(out, "nan_ckpt"),
                          TrainerConfig(total_steps=1, ckpt_every=100))
        trainer.run()
        after = _state_arrays(model, trainer.opt_state)
        res["nan_skipped"] = trainer.nan_guard.total_skipped
        res["nan_unchanged"] = all(np.array_equal(before[k], after[k])
                                   for k in before)
        state = trainer.opt_state
    losses = []
    for batch in batches:
        grads, metrics = step.grads(batch)
        losses.append(float(metrics["loss"]))
        state = step.update(state, grads)
    res["losses"] = np.asarray(losses)
    params = to_reference(model)
    flat = {f"p/{k}": v for k, v in _flat(params).items()}
    np.savez(os.path.join(out, f"dp{rank}.npz"), **res, **flat)
    dist.destroy_process_group()


class _Batches:
    """The trainer's data source over a fixed list of batches."""

    def __init__(self, batches):
        self.batches, self.cursor = batches, 0

    def __next__(self):
        self.cursor += 1
        return self.batches[self.cursor - 1]

    def state_dict(self):
        return {"cursor": self.cursor}

    def load_state_dict(self, state):
        self.cursor = int(state["cursor"])

    def close(self):
        pass


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else str(k)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}/#{i}"))
        return out
    return {path: np.asarray(tree.detach().cpu() if torch.is_tensor(tree)
                             else tree)}


def _state_arrays(model, state):
    out = {f"param/{k}": v.detach().clone().numpy()
           for k, v in model.state_dict().items()}
    for k, v in _flat(state).items():
        out[f"state/{k}"] = v.copy()
    return out


def int8_psum_worker(rank, world, port, out, data_path):
    """``_int8_psum`` over the "pod" group of a 2 x 2 mesh: member (pod,
    data) sends row [pod, data] of the stacked inputs."""
    from repro_torch.distributed.dp_compress import _int8_psum
    from repro_torch.launch.mesh import make_fleet_mesh
    join(rank, world, port)
    mesh = make_fleet_mesh(pods=2)
    pod, data = mesh.get_coordinate()
    g = torch.from_numpy(np.load(data_path)["g"][pod, data])
    summed, sent = _int8_psum(g, mesh.get_group("pod"))
    np.savez(os.path.join(out, f"psum{rank}.npz"), summed=summed.numpy(),
             sent=sent.numpy())
    dist.destroy_process_group()


# ---- the trainer and the launcher across ranks -----------------------------

def train_sim_worker(rank, world, port, out, argv):
    """``train_sim.train_single`` on this rank's share of every global
    batch; writes the loss history and the final parameters."""
    from repro_torch.launch import train_sim
    from repro_torch.params import to_reference
    join(rank, world, port)
    args = train_sim.build_parser().parse_args(list(argv))
    res = train_sim.train_single(args)
    flat = {f"p/{k}": v for k, v in
            _flat(to_reference(res["trainer"].model)).items()}
    np.savez(os.path.join(out, f"ts{rank}.npz"),
             history=np.asarray(res["trainer"].history), **flat)
    dist.destroy_process_group()


def restart_worker(rank, world, port, out):
    """Across 2 ranks with the global-batch step: 4 steps straight, and 2
    then 2 more after a restore from rank 0's checkpoint; counts each
    rank's checkpoint writes. Then ``run_comparison`` over a fleet mesh."""
    from repro_torch.checkpoint import manager
    from repro_torch.configs import get_sim_arch
    from repro_torch.data.pipeline import ShardedIterator
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.training.comparison import run_comparison
    from repro_torch.training.data import make_batch_fn
    from repro_torch.training.steps import bc_optimizer, make_sim_train_step
    join(rank, world, port)
    writes = {"n": 0}
    write_once = manager.CheckpointManager._write_once

    def counted(self, *a, **kw):
        writes["n"] += 1
        return write_once(self, *a, **kw)

    manager.CheckpointManager._write_once = counted
    arch = get_sim_arch("sim-se2-fourier").reduced().reduced(
        num_map=12, num_agents=4, num_steps=8)
    scen = arch.scenario_config()

    def trainer(ckpt, total):
        model = _arch_model(arch)
        opt = bc_optimizer(3e-3, 4)
        step = make_sim_train_step(model, opt,
                                   group=dist.group.WORLD)
        data = ShardedIterator(make_batch_fn(scen), batch_size=2, seed=0,
                               host_rank=rank, world=world)
        return Trainer(step, model, opt.init(dict(model.named_parameters())),
                       data, os.path.join(out, ckpt),
                       TrainerConfig(total_steps=total, ckpt_every=2))

    straight = trainer("straight", 4)
    straight.run()
    straight.data.close()
    first = trainer("restart", 2)
    first.run()
    first.data.close()
    second = trainer("restart", 4)
    assert second.restore_if_available()
    second.run()
    second.data.close()
    res = {"writes": writes["n"],
           "restart_bitwise": all(
               torch.equal(a, b) for a, b in zip(
                   straight.model.state_dict().values(),
                   second.model.state_dict().values())),
           "history": np.asarray(straight.history),
           "history_restart": np.asarray(first.history + second.history)}
    mesh = make_fleet_mesh()
    rows = run_comparison(arch, ("se2_fourier",), steps=2, batch=2, seed=0,
                          holdout_n=1, n_scenes_per_family=1, eval_samples=1,
                          mesh=mesh, eval_mesh=mesh, device="cpu")
    row = rows["se2_fourier"]
    res["cmp"] = np.asarray([row["open_loop_nll"],
                             row["closed_loop_min_ade"], row["loss_first"],
                             row["loss_last"]])
    np.savez(os.path.join(out, f"restart{rank}.npz"), **res)
    dist.destroy_process_group()


def _arch_model(arch):
    from repro_torch.nn.agent_sim import AgentSimModel
    return AgentSimModel(arch.agent_sim_config(), device="cpu",
                         generator=torch.Generator().manual_seed(0))


def generic_dp_worker(rank, world, port, out, data_path):
    """``make_compressed_dp_step`` on a least-squares loss over a
    (world / 2, 2) mesh (or (1, 1)), SGD, from the weights and batches in
    ``data_path``; writes the weights, residuals and losses."""
    from repro_torch.distributed.dp_compress import make_compressed_dp_step
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.optim import sgd
    join(rank, world, port)
    data = np.load(data_path)
    params = {"w": torch.from_numpy(data["w"]).requires_grad_(True)}
    residual = {"w": torch.zeros_like(params["w"])}
    opt = sgd(0.1)
    state = opt.init(params)
    mesh = make_fleet_mesh(pods=max(1, world // 2))
    step = make_compressed_dp_step(
        lambda p, b: torch.mean((b["x"] @ p["w"] - b["y"]) ** 2), opt, mesh)
    losses = []
    for i in range(data["x"].shape[0]):
        batch = {"x": torch.from_numpy(data["x"][i]),
                 "y": torch.from_numpy(data["y"][i])}
        params, state, residual, loss = step(params, state, residual, batch)
        losses.append(float(loss))
    np.savez(os.path.join(out, f"generic{rank}.npz"),
             w=params["w"].detach().numpy(), r=residual["w"].numpy(),
             losses=np.asarray(losses))
    dist.destroy_process_group()

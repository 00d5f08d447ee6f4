"""Runtime: the closed-loop rollout engine, the continuous-batching sim
server and the evaluation over them; the LM's serving loop and its train,
prefill and serve steps."""
from repro_torch.runtime.evaluation import (EvalConfig, evaluate_families,
                                            evaluate_scenes)
from repro_torch.runtime.rollout import RolloutEngine
from repro_torch.runtime.server import Request, Server
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.trainer import TrainStep
from repro_torch.runtime.sim_server import (SceneRequest, SimResult,
                                            SimServer, poisson_drive,
                                            serve_scenes)

__all__ = ["RolloutEngine", "EvalConfig", "evaluate_families",
           "evaluate_scenes", "SceneRequest", "SimResult", "SimServer",
           "poisson_drive", "serve_scenes", "Request", "Server", "TrainStep",
           "make_train_step"]

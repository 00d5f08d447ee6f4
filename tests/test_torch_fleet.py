"""Fleet rollouts and evaluation over a 2 x 2 gloo mesh, on the CPU.

Four processes form a ("pod", "data") = (2, 2) mesh
(``repro_torch.launch.mesh.make_fleet_mesh``); ``RolloutEngine(...,
mesh=)`` rounds 6 slots up to 8, each rank runs 2 lanes of every chunk,
and the futures and actions are gathered in rank order. Over 10 scenes of
the seven families x 2 samples (3 chunks, the last one padded), every
rank's result equals the single-process engine's bitwise, as do the
``evaluate_families`` tables; a mesh with a "model" axis is refused,
naming it. The reference pins the same contract on a forced CPU mesh
(``tests/test_distributed.py``); the workers are in
``tests/torch_fleet_workers.py``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_fleet_workers as workers  # noqa: E402

WORLD = 4


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    out = tmp_path_factory.mktemp("fleet")
    workers.spawn(workers.fleet_worker, WORLD, str(out))
    runs = [dict(np.load(out / f"fleet{r}.npz")) for r in range(WORLD)]
    tables = [json.loads((out / f"tables{r}.json").read_text())
              for r in range(WORLD)]
    return runs, tables


def test_slots_round_up_to_the_shards(fleet):
    runs, _ = fleet
    for run in runs:
        assert run["slots"].tolist() == [8, 2]


@pytest.mark.parametrize("rank", range(WORLD))
def test_fleet_rollout_equals_single_process_bitwise(fleet, rank):
    run = fleet[0][rank]
    assert run["fut"].shape == (10, 2, 4, 3, 3)
    np.testing.assert_array_equal(run["fut"], run["one_fut"])
    np.testing.assert_array_equal(run["acts"], run["one_acts"])
    np.testing.assert_array_equal(run["fut"], fleet[0][0]["fut"])


@pytest.mark.parametrize("rank", range(WORLD))
def test_fleet_evaluation_tables_equal_single_process(fleet, rank):
    tables = fleet[1][rank]
    assert tables["fleet"] == tables["one"]
    assert tables["fleet"] == fleet[1][0]["fleet"]
    assert len(tables["fleet"]) == 8             # seven families + overall


def test_model_axis_is_refused(fleet):
    for run in fleet[0]:
        msg = str(run["model_axis_error"])
        assert "model" in msg and "scene axes" in msg, msg

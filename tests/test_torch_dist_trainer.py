"""The trainer stack across ranks, on the CPU (two gloo processes).

* ``train_sim.train_single`` at world 2 (``--batch 2`` a rank) against
  the single-process run on the global batch (``--batch 4``): each rank
  draws its share of every global batch and the step all-reduces the
  NLL's sum and valid count before the division, so the loss history
  agrees within the reference trainer's rtol 1e-5 / atol 1e-6
  (``tests/test_trainer_server.py``), the sums taken in another order,
  and the final parameters within rtol 1e-5 / atol 1e-5: AdamW divides
  each element's step by its own second moment, so an element whose
  gradient is near zero turns the sums' rounding into a relative error of
  its step of size lr = 3e-3 (one element of 32,768 at 4.6e-6 after six
  steps, measured). Both ranks end bitwise equal.
* Checkpoints across ranks: rank 0 alone writes, and a 2 + 2 restart from
  its checkpoint ends bitwise equal to 4 steps straight on every rank.
* ``run_comparison(mesh=, eval_mesh=)`` over a (1, 2) fleet mesh: finite
  rows, the same on both ranks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_fleet_workers as workers  # noqa: E402
from repro_torch.launch import train_sim  # noqa: E402
from repro_torch.params import to_reference  # noqa: E402

ARGV = ["--smoke", "--device", "cpu", "--steps", "6", "--lr", "3e-3",
        "--eval-scenes-per-family", "1", "--eval-samples", "1",
        "--holdout-batches", "1", "--ckpt-every", "3"]


def _flat_params(model):
    return {f"p/{k}": v for k, v in
            workers._flat(to_reference(model)).items()}


def test_train_sim_world_two_matches_global_batch(tmp_path):
    world_dir, one_dir = tmp_path / "world", tmp_path / "one"
    world_dir.mkdir()
    workers.spawn(workers.train_sim_worker, 2, str(world_dir),
                  ARGV + ["--batch", "2", "--ckpt-dir",
                          str(world_dir / "ckpt")])
    runs = [dict(np.load(world_dir / f"ts{r}.npz")) for r in range(2)]
    torch.set_num_threads(1)
    one = train_sim.train_single(train_sim.build_parser().parse_args(
        ARGV + ["--batch", "4", "--ckpt-dir", str(one_dir)]))
    want = _flat_params(one["trainer"].model)
    for k, v in runs[1].items():
        np.testing.assert_array_equal(v, runs[0][k], err_msg=k)
    np.testing.assert_allclose(runs[0]["history"], one["trainer"].history,
                               rtol=1e-5, atol=1e-6)
    for k, v in want.items():
        np.testing.assert_allclose(runs[0][k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.fixture(scope="module")
def restart(tmp_path_factory):
    out = tmp_path_factory.mktemp("restart")
    workers.spawn(workers.restart_worker, 2, str(out))
    return [dict(np.load(out / f"restart{r}.npz")) for r in range(2)], out


def test_one_writer_per_checkpoint(restart):
    runs, out = restart
    assert int(runs[0]["writes"]) > 0
    assert int(runs[1]["writes"]) == 0
    for d in ("straight", "restart"):
        names = sorted(p.name for p in (out / d).iterdir())
        assert names and not [n for n in names if n.endswith(".tmp")], names


def test_restart_is_bitwise(restart):
    runs, _ = restart
    for run in runs:
        assert bool(run["restart_bitwise"])
        np.testing.assert_array_equal(run["history"], run["history_restart"])
        np.testing.assert_array_equal(run["history"], runs[0]["history"])


def test_comparison_over_a_fleet_mesh(restart):
    runs, _ = restart
    for run in runs:
        assert np.isfinite(run["cmp"]).all()
        np.testing.assert_array_equal(run["cmp"], runs[0]["cmp"])

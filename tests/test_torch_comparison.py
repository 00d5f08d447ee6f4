"""The port's Table-I comparison (``repro_torch.training.comparison``)
against the reference's, on the CPU at the launcher's smoke size (2 layers,
d_model 64, 12 map + 8 x 4 agent tokens).

The two packages draw their initial weights from different generators, so
the rows' numbers differ; what must agree is the rows' shape (every key,
the per-family tables' keys) and the table ``format_table`` prints from
one rows dict.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.training import comparison as jcmp  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.training import comparison as tcmp  # noqa: E402

ENCODINGS = ("se2_fourier", "absolute")
SMOKE = dict(num_map=12, num_agents=4, num_steps=8)
BUDGET = dict(steps=3, batch=2, holdout_n=1, n_scenes_per_family=1,
              eval_samples=1)


def _arch(configs):
    return configs.get_sim_arch("sim-se2-fourier").reduced().reduced(**SMOKE)


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    root = tmp_path_factory.mktemp("cmp")
    reports = {"torch": [], "jax": []}
    port = tcmp.run_comparison(
        _arch(tconfigs), ENCODINGS, ckpt_root=str(root / "torch"),
        report=lambda *a: reports["torch"].append(a[0]), device="cpu",
        **BUDGET)
    ref = jcmp.run_comparison(
        _arch(jconfigs), ENCODINGS, ckpt_root=str(root / "jax"),
        report=lambda *a: reports["jax"].append(a[0]), **BUDGET)
    return port, ref, reports, root


def test_constants_match():
    assert tcmp.COMPARISON_ENCODINGS == jcmp.COMPARISON_ENCODINGS
    assert tcmp.CLOSED_LOOP_METRICS == jcmp.CLOSED_LOOP_METRICS


def test_rows_have_the_reference_keys(rows):
    port, ref, reports, root = rows
    assert list(port) == list(ref) == [*ENCODINGS, "summary"]
    assert port["summary"].keys() == ref["summary"].keys()
    for enc in ENCODINGS:
        assert port[enc].keys() == ref[enc].keys(), enc
        assert port[enc]["families"].keys() == ref[enc]["families"].keys()
        for fam, row in ref[enc]["families"].items():
            assert port[enc]["families"][fam].keys() == row.keys(), fam
        assert port[enc]["status"] == "done"
        assert port[enc]["steps"] == BUDGET["steps"]
        for k in ("open_loop_nll", "open_loop_accuracy",
                  "closed_loop_min_ade", "loss_first", "loss_last"):
            assert np.isfinite(port[enc][k]), (enc, k)
        # every run went through the Trainer: its final checkpoint is there
        assert (root / "torch" / enc).is_dir()
    assert reports["torch"] == reports["jax"]


def test_format_table_prints_the_reference_string(rows):
    port, ref, _, _ = rows
    for r in (port, ref):
        assert tcmp.format_table(r) == jcmp.format_table(r)
    nan_row = {enc: dict(port[enc], open_loop_nll=float("nan"))
               for enc in ENCODINGS}
    assert tcmp.format_table(nan_row) == jcmp.format_table(nan_row)


def test_train_one_resumes_a_finished_run(rows):
    """A second ``train_one`` on the same checkpoint dir restores the
    finished run and trains nothing more."""
    _, _, _, root = rows
    arch = dataclasses.replace(_arch(tconfigs), encoding="se2_fourier")
    model, summary = tcmp.train_one(arch, steps=BUDGET["steps"], batch=2,
                                    ckpt_dir=str(root / "torch" /
                                                 "se2_fourier"),
                                    device="cpu")
    assert summary["status"] == "done"
    assert summary["steps"] == BUDGET["steps"]
    assert np.isnan(summary["loss_first"])        # no step ran here
    assert model.device.type == "cpu"

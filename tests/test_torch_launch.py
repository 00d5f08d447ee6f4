"""The port's launcher, ``python -m repro_torch.launch.train_sim``, on the
CPU: ``--smoke --device cpu`` passes its own assertions and writes its
telemetry (rendered by the port's ``obs_report``, merged by
``obs_merge``); ``--inject-nan-at`` halts with a tagged checkpoint and a
flight-recorder bundle that renders; a relaunch refuses that checkpoint
without ``--force``; without ``--device cpu`` and without a card it
raises. The flags are the reference's, less ``--production-mesh``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.launch import train_sim as jtrain_sim  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch import obs_merge, obs_report  # noqa: E402
from repro_torch.launch import train_sim  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _flags(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_flags_are_the_reference_flags():
    import argparse
    captured = {}

    def grab(self, *a, **k):
        captured["parser"] = self
        raise SystemExit(0)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            jtrain_sim.main()
    finally:
        argparse.ArgumentParser.parse_args = orig
    ref = _flags(captured["parser"])
    port = _flags(train_sim.build_parser())
    assert ref - port == set()
    assert port - ref == {"--device"}


def test_smoke_passes_its_assertions_and_writes_telemetry(tmp_path, capsys):
    trace = tmp_path / "run.trace.jsonl"
    prom = tmp_path / "run.prom"
    tel_dir = tmp_path / "tel"
    result = train_sim.main([
        "--smoke", "--device", "cpu", "--steps", "12", "--eval-every", "6",
        "--ckpt-every", "4", "--ckpt-dir", str(tmp_path / "ckpt"),
        "--telemetry-out", str(trace), "--prom-out", str(prom),
        "--telemetry-dir", str(tel_dir)])
    assert result["status"] == "done" and result["steps"] == 12
    assert result["loss_last"] < result["loss_first"]
    trainer = result["trainer"]
    assert trainer.ckpt.available_steps() == [4, 8, 12]
    for key in ("final_nll", "closed_min_ade", "closed_offroad_rate"):
        assert key in result
    assert obs_report.main([str(trace), "--json"]) == 0
    agg = json.loads(capsys.readouterr().out)
    assert agg["spans"]["trainer.step"]["count"] == 12
    # periodic evals at 6 and 12; no extra final eval
    assert agg["spans"]["trainer.eval"]["count"] == 2
    assert agg["spans"]["trainer.checkpoint"]["count"] == 4
    assert agg["spans"]["rollout.chunk"]["count"] == 2
    assert "trainer_step_seconds" in prom.read_text()
    assert obs_merge.main([str(tel_dir), "-o",
                           str(tmp_path / "merged.jsonl")]) == 0


def test_nan_drill_halts_and_its_bundle_renders(tmp_path, capsys):
    bundle = tmp_path / "postmortem.json"
    ckpt = tmp_path / "ckpt"
    with pytest.raises(FloatingPointError):
        train_sim.main(["--smoke", "--device", "cpu", "--steps", "12",
                        "--inject-nan-at", "3", "--ckpt-dir", str(ckpt),
                        "--postmortem-out", str(bundle)])
    assert obs_report.main(["--postmortem", str(bundle)]) == 0
    text = capsys.readouterr().out
    assert "nan_halt" in text and "nan_skipped_total" in text
    (sub,) = list(ckpt.iterdir())
    _, extra = CheckpointManager(str(sub)).restore(fallback=True)
    assert extra["halt_reason"] == "nan" and extra["step"] == 7
    with pytest.raises(RuntimeError, match="--force"):
        train_sim.main(["--smoke", "--device", "cpu", "--steps", "12",
                        "--ckpt-dir", str(ckpt)])
    forced = train_sim.main(["--smoke", "--device", "cpu", "--steps", "12",
                             "--ckpt-dir", str(ckpt), "--force"])
    assert forced["status"] == "done" and forced["steps"] == 12


def test_launcher_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_sim", "--smoke",
         "--steps", "2"], env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr


def test_compare_smoke_prints_the_table(tmp_path, capsys):
    out = tmp_path / "rows.json"
    rows = train_sim.main(["--compare", "--smoke", "--device", "cpu",
                           "--steps", "20", "--out", str(out)])
    text = capsys.readouterr().out
    assert "| encoding | NLL |" in text and "relative_beats_absolute" in text
    assert list(rows) == ["se2_fourier", "absolute", "summary"]
    assert json.loads(out.read_text()).keys() == rows.keys()

"""The roofline arithmetic of the port's dry-run (``launch/roofline.py``),
its report (``launch/report.py``) and the ``data/scenarios.py`` shim, on
the CPU.

* ``model_flops_for`` and ``roofline_terms`` against the reference's on
  every arch x shape (1e-12 relative), the terms on equal inputs with the
  port's H100 table; the port's gradient all-reduce bytes against the
  reference's ``parse_collectives`` on the equivalent HLO line.
* ``report.py`` prints the reference's text on the same records (ok,
  skipped, error, count-only, multi-pod).
* ``data/scenarios.py``: ``generate_scene`` / ``generate_batch`` bitwise
  the reference's for three seeds, and the rest of its surface.
"""
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401

from repro import configs as jconfigs  # noqa: E402
from repro.data import scenarios as jscen  # noqa: E402
from repro.launch import report as jreport  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import scenarios as tscen  # noqa: E402
from repro_torch.launch import report, roofline  # noqa: E402
from repro_torch.launch.mesh import HW  # noqa: E402
from repro_torch.nn.transformer import build_model  # noqa: E402

REL = 1e-12


def _close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)


@pytest.mark.parametrize("arch", tconfigs.ARCH_NAMES)
def test_model_flops_and_terms_match_reference(arch):
    from repro_torch.nn.module import count_params
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    n_params = count_params(build_model(tcfg, device="meta"))
    for i, (name, shape) in enumerate(tconfigs.SHAPES.items()):
        # the first shape counts the meta model itself
        got = roofline.model_flops_for(tcfg, shape, n_params if i else None)
        want = jroof.model_flops_for(jcfg, jconfigs.SHAPES[name])
        assert _close(got, want), (name, got, want)
        for sizes in ({"data": 16, "model": 16},
                      {"pod": 2, "data": 16, "model": 16}):
            coll = roofline.placement_collectives(shape.mode, 4.0 * got,
                                                  sizes)
            jcoll = jroof.CollectiveStats(
                per_chip_bytes=coll.per_chip_bytes, by_kind=coll.by_kind,
                count=coll.count)
            for flops, nbytes in ((got, 3.0e12), (got / 7, got * 9)):
                t = roofline.roofline_terms(flops, nbytes, coll, HW)
                w = jroof.roofline_terms(flops, nbytes, jcoll, 256, HW)
                assert sorted(t) == sorted(w)
                for k in t:
                    assert (t[k] == w[k]) if isinstance(t[k], str) \
                        else _close(t[k], w[k]), (name, k)


@pytest.mark.parametrize("sizes,n", [({"data": 16, "model": 16}, 16),
                                     ({"pod": 2, "data": 16, "model": 16},
                                      32)])
def test_all_reduce_matches_parse_collectives(sizes, n):
    elems = 3_836_021_760
    got = roofline.placement_collectives("train", 4.0 * elems, sizes)
    line = (f"  %all-reduce.7 = f32[{elems}]{{0}} all-reduce(f32[{elems}]"
            f"{{0}} %grads), channel_id=1, replica_groups=[{512 // n},{n}]"
            f"<=[512], use_global_device_ids=true, to_apply=%add\n")
    want = jroof.parse_collectives(line)
    assert got.per_chip_bytes == want.per_chip_bytes > 0
    assert got.by_kind == want.by_kind and got.count == want.count == 1
    assert got.f32_bytes == want.f32_bytes
    # the port moves the payload at its own dtype: nothing to undo
    assert got.bf16_corrected == got.per_chip_bytes
    assert sorted(got.to_dict()) == sorted(want.to_dict())
    for mode in ("prefill", "decode"):
        none = roofline.placement_collectives(mode, 4.0 * elems, sizes)
        assert none.per_chip_bytes == 0 and none.count == 0
    one = roofline.placement_collectives("train", 4.0, {"data": 1,
                                                        "model": 16})
    assert one.count == 0


def _records():
    terms = {"compute_s": 0.0123, "memory_s": 0.0456, "collective_s": 0.0007,
             "collective_s_raw_f32": 0.0007, "dominant": "memory",
             "bound_s": 0.0456, "roofline_fraction_of_compute": 0.27}
    ok = {"arch": "a-ok", "shape": "train_4k", "mesh": "single",
          "status": "ok", "terms": terms, "useful_flops_frac": 0.0441,
          "hbm_per_chip_gib": 12.34, "fits_hbm": True,
          "memory_replicated": {"hbm_per_chip_gib": 99.5, "fits_hbm": False}}
    return [
        ok,
        {"arch": "b-skip", "shape": "long_500k", "mesh": "single",
         "status": "skipped", "reason": "n/a"},
        {"arch": "c-err", "shape": "decode_32k", "mesh": "single",
         "status": "error", "error": "RuntimeError: " + "x" * 100},
        {"arch": "d-sim", "shape": "sim_train", "mesh": "single",
         "status": "ok", "hbm_per_chip_gib": 0.25, "fits_hbm": True},
        dict(ok, arch="e-multi", mesh="multi"),
        {"arch": "f-multi-err", "shape": "train_4k", "mesh": "multi",
         "status": "error", "error": "ValueError: boom"},
        {"arch": "g-multi-skip", "shape": "long_500k", "mesh": "multi",
         "status": "skipped"},
    ]


def test_report_prints_the_reference_text(tmp_path, capsys, monkeypatch):
    for i, rec in enumerate(_records()):
        (tmp_path / f"{i}_{rec['arch']}.json").write_text(json.dumps(rec))
    for mesh in ("single", "multi"):
        report.main(["--dir", str(tmp_path), "--mesh", mesh])
        got = capsys.readouterr().out
        monkeypatch.setattr(sys, "argv", ["report", "--dir", str(tmp_path),
                                          "--mesh", mesh])
        jreport.main()
        assert got == capsys.readouterr().out
    report.main(["--dir", str(tmp_path), "--replicated"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].endswith("replicated GiB/chip | fits |")
    assert lines[2].endswith("| 12.3 | Y | 99.5 | N |")


def test_scenarios_shim_matches_reference():
    assert tscen.__all__ == jscen.__all__
    assert (tscen.DT, tscen.MAX_SPEED) == (jscen.DT, jscen.MAX_SPEED)
    cfg = tscen.ScenarioConfig(num_map=16, num_agents=5, num_steps=8)
    jcfg = jscen.ScenarioConfig(num_map=16, num_agents=5, num_steps=8)
    for seed in (0, 1, 7):
        got = tscen.generate_scene(seed, 3, cfg)
        want = jscen.generate_scene(seed, 3, jcfg)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        gb = tscen.generate_batch(seed, 2, 3, cfg)
        wb = jscen.generate_batch(seed, 2, 3, jcfg)
        for k in gb:
            np.testing.assert_array_equal(gb[k], wb[k])
    rng = np.random.default_rng(0)
    pose = rng.normal(size=(4, 3))
    speed, accel, yaw = (rng.normal(size=4) for _ in range(3))
    for a, b in zip(tscen.step_kinematics(pose, speed, accel, yaw),
                    jscen.step_kinematics(pose, speed, accel, yaw)):
        np.testing.assert_array_equal(a, np.asarray(b))
    ids = np.arange(cfg.num_actions)
    np.testing.assert_array_equal(
        np.asarray(tscen.decode_action(cfg, ids)),
        np.asarray(jscen.decode_action(jcfg, ids)))

"""The port's dry-run (``launch/dryrun.py``) and the kernel wrappers'
meta route, on the CPU.

* ``lower_cell`` on ``meta`` for reduced dense, MoE, SSM and
  encoder-decoder configs and ``lower_sim_cell`` on a reduced sim arch:
  FLOPs and bytes accessed equal to ``CostAccounted``'s count of the same step run on the CPU
  through the plain versions, ``extrapolation_rel_err`` under 1e-6, every
  reference record key present. No card, no nvcc: ``cuda.build_all``,
  ``cuda.launcher`` and ``cuda.load`` raise throughout.
* The CLI, and a cell ``applicable`` skips.
* The kernel wrappers on meta tensors: outputs of the right shapes and
  dtypes, nothing built.
"""
import json

import pytest

torch = pytest.importorskip("torch")
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.kernels import cuda  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.nn.transformer import build_model  # noqa: E402
from repro_torch.obs.cost import CostAccounted  # noqa: E402
from repro_torch.obs.registry import NULL  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

SMALL_MESH = {"data": 2, "model": 2}
LM_KEYS = {"arch", "shape", "mesh", "status", "chips", "n_params", "mode",
           "full_compile_s", "full_lower_s", "memory", "hbm_per_chip_gib",
           "fits_hbm", "flops", "bytes_accessed", "per_iter_flops",
           "collectives", "variant_measurements", "terms", "model_flops",
           "useful_flops_frac"}
SIM_KEYS = {"arch", "shape", "mesh", "status", "chips", "n_params", "mode",
            "encoding", "full_compile_s", "full_lower_s", "memory",
            "hbm_per_chip_gib", "fits_hbm"}


@pytest.fixture(autouse=True)
def no_card(monkeypatch):
    """Nothing here may build or load a kernel."""
    def refuse(*a, **k):
        raise AssertionError("a kernel build or load on the CPU")
    for name in ("build_all", "launcher", "load"):
        monkeypatch.setattr(cuda, name, refuse)


def _cpu_inputs(cfg, shape, model, gen):
    ins = {}
    for k, v in tsteps.input_specs(cfg, shape, model).items():
        if k == "cache" or k == "index":
            continue
        if v.dtype == torch.int32:
            ins[k] = torch.randint(1, cfg.vocab_size, tuple(v.shape),
                                   generator=gen, dtype=torch.int32)
        else:
            ins[k] = torch.randn(tuple(v.shape), generator=gen).to(v.dtype)
    return ins


def _cpu_count(cfg, shape):
    """``CostAccounted``'s count of the dry-run's step on the CPU, through
    the plain versions of the kernels, at ``shape``'s batch."""
    model = build_model(cfg, device="cpu")
    ins = _cpu_inputs(cfg, shape, model, torch.Generator().manual_seed(1))
    if shape.mode == "train":
        opt = dryrun.choose_optimizer(cfg)
        state = opt.init(dict(model.named_parameters()))
        step = CostAccounted(tsteps.make_train_step(model, opt), "t",
                             registry=NULL)
        grads, _ = step.grads(ins)
        step.update(state, grads)
    elif shape.mode == "prefill":
        step = CostAccounted(tsteps.make_prefill_step(model), "p",
                             registry=NULL)
        step(ins)
    else:
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 cfg.compute_dtype)
        step = CostAccounted(tsteps.make_serve_step(model), "d",
                             registry=NULL)
        step(cache, ins["tokens"], shape.seq_len - 1,
             enc_out=ins.get("enc_out"))
    return step.cost


CELLS = [(arch, mode) for arch in ("phi4-mini-3.8b", "deepseek-v2-lite-16b",
                                   "rwkv6-7b", "whisper-base")
         for mode in ("train", "prefill", "decode")]


@pytest.mark.parametrize("arch,mode", CELLS)
def test_lower_cell_counts_as_the_cpu_step(arch, mode):
    cfg = tconfigs.get_config(arch).reduced()
    shape = ShapeConfig(f"small_{mode}", 16, 4, mode)
    rec = dryrun.lower_cell(arch, shape.name, False, cfg=cfg, shape=shape,
                            mesh=SMALL_MESH)
    assert rec["status"] == "ok" and LM_KEYS <= set(rec)
    assert rec["batch_per_rank"] == 2 and rec["chips"] == 4
    want = _cpu_count(cfg, dryrun.rank_shape(shape, SMALL_MESH))
    assert rec["full_depth"]["flops"] == want["flops"] > 0
    assert rec["full_depth"]["kernel_flops"] == want["kernel_flops"]
    assert rec["full_depth"]["bytes_accessed"] == want["bytes_accessed"]
    assert rec["extrapolation_rel_err"] < 1e-6
    assert [m["iters"] for m in rec["variant_measurements"]] == [
        cfg.depth_variant(i).scan_iters() for i in dryrun.VARIANT_ITERS]
    mem = rec["memory"]
    assert mem["temp_bytes"] > 0 and mem["argument_bytes"] > 0
    # the rules shard the parameters over "model" and "data"; today's
    # placement holds them whole
    assert rec["memory_replicated"]["argument_bytes"] > mem["argument_bytes"]
    assert rec["terms"]["bound_s"] > 0
    assert 0 < rec["useful_flops_frac"] < 1
    json.dumps(rec)
    if (arch, mode) == ("phi4-mini-3.8b", "decode"):
        multi = dryrun.lower_cell(arch, shape.name, True, cfg=cfg,
                                  shape=shape,
                                  mesh={"pod": 2, "data": 2, "model": 2})
        assert "terms" not in multi and multi["batch_per_rank"] == 1


def test_lower_sim_cell_counts_as_the_cpu_step():
    from repro_torch.nn.agent_sim import AgentSimModel
    from repro_torch.training.data import make_sim_batch
    from repro_torch.training.steps import make_sim_train_step
    from repro_torch.optim import adamw, chain, clip_by_global_norm
    sim = tconfigs.get_sim_arch("sim-se2-fourier").reduced()
    rec = dryrun.lower_sim_cell(sim.name, False, sim=sim, batch=8,
                                mesh=SMALL_MESH)
    assert rec["status"] == "ok" and SIM_KEYS <= set(rec)
    model = AgentSimModel(sim.agent_sim_config(), device="cpu")
    opt = chain(clip_by_global_norm(1.0), adamw(3e-4))
    state = opt.init(dict(model.named_parameters()))
    step = CostAccounted(make_sim_train_step(model, opt), "s", registry=NULL)
    grads, _ = step.grads(make_sim_batch(0, 0, rec["batch_per_rank"],
                                         sim.scenario_config()))
    step.update(state, grads)
    assert rec["full_depth"]["flops"] == step.cost["flops"] > 0
    assert rec["full_depth"]["kernel_flops"] == step.cost["kernel_flops"] > 0
    assert rec["full_depth"]["bytes_accessed"] == \
        step.cost["bytes_accessed"] > 0


def test_dryrun_cli_and_skipped_cells(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "phi4-mini-3.8b", "--shape", "long_500k",
                     "--mesh", "both", "--out", str(tmp_path)])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "done; 0 failures" in out
    for mesh in ("single", "multi"):
        rec = json.loads((tmp_path / f"phi4-mini-3.8b_long_500k_{mesh}"
                          ".json").read_text())
        assert rec["status"] == "skipped"


def test_kernel_wrappers_meta_route():
    from repro_torch.core.encodings import SE2Fourier
    from repro_torch.kernels import categorical as cat
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    from repro_torch.kernels import se2_project as se2
    m = dict(device="meta")
    q = torch.empty(2, 8, 5, 32, dtype=torch.bfloat16, **m)
    k = torch.empty(2, 2, 7, 32, dtype=torch.bfloat16, **m)
    v = torch.empty(2, 2, 7, 24, dtype=torch.bfloat16, **m)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    assert out.shape == (2, 8, 5, 24) and out.dtype == torch.bfloat16
    assert lse.shape == (2, 8, 5) and lse.dtype == torch.float32
    do = torch.empty_like(out)
    dq, dk, dv = fab.flash_attention_bwd(q, k, v, out, lse, do)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert out.device.type == dq.device.type == "meta"
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    y = ops.attention(qr, kr, vr, causal=True)
    y.sum().backward()
    assert y.shape == (2, 8, 5, 24) and qr.grad.shape == q.shape
    kc = torch.empty(3, 2, 2, 64, 32, **m)
    vc = torch.empty(3, 2, 2, 64, 24, **m)
    kvl = torch.empty(2, dtype=torch.int32, **m)
    qd = torch.empty(2, 8, 1, 32, **m)
    o = fd.flash_decode(qd, kc, vc, kvl, layer=1)
    assert o.shape == (2, 8, 1, 24) and o.dtype == torch.float32
    o = ops.decode_attention(qd, kc[0], vc[0], kv_length=kvl)
    assert o.shape == (2, 8, 1, 24)
    enc = SE2Fourier(head_dim=24, num_terms=4)
    x = torch.empty(2, 3, 6, 24, **m)
    pose = torch.empty(2, 6, 3, **m)
    for mode in ("q", "k"):
        y = se2.se2_fourier_project(x, pose, enc, mode)
        assert y.shape == (2, 3, 6, enc.expanded_dim)
        assert se2.se2_fourier_project_t(y, pose, enc, mode).shape == \
            x.shape
    keys = torch.empty(4, 2, dtype=torch.int64, **m)
    steps = torch.empty(4, dtype=torch.int32, **m)
    acts = cat.categorical(keys, steps, torch.empty(4, 3, 9, **m))
    assert acts.shape == (4, 3) and acts.dtype == torch.int64



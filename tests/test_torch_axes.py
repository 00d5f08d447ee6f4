"""Logical axes and the sharding resolvers of the port, on the CPU.

* ``ModelConfig.depth_variant`` / ``scan_iters`` field by field against
  the reference's, and linear in the iterations.
* Every parameter's axes, for every LM arch at full width on ``meta`` and
  every sim arch, equal those of the reference leaf that
  ``params.from_reference`` maps onto it (the reference's ``specs()``
  allocate nothing); a stacked leaf's leading ``"layers"`` axis is the
  port's layer index. The specs ``sharding_for_specs`` resolves at the
  (16, 16) and (2, 16, 16) sizes equal the reference's ``spec_for``, which
  reads only ``mesh.shape`` (a stand-in carries the sizes).
* ``derive_opt_shardings`` over AdamW (phi4-mini) and adafactor (kimi-k2)
  against the reference's (its ``NamedSharding`` patched to return the
  spec, so no device mesh is needed).
* ``input_specs``' shapes and dtypes against the reference's for every
  arch x shape; the decode cache's total bytes are equal, and its layout
  differs where named below. ``cache_sharding`` / ``batch_shardings``
  against the reference's where the layouts agree.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import sharding as jshard  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro.nn.agent_sim import AgentSimModel as JAgentSimModel  # noqa: E402
from repro.nn.transformer import build_model as jbuild  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.distributed import sharding as tshard  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.nn.agent_sim import AgentSimModel  # noqa: E402
from repro_torch.nn.module import ParamSpec, param_specs  # noqa: E402
from repro_torch.nn.transformer import build_model  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

ARCHS = tconfigs.ARCH_NAMES
SIZES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]


def _mesh(sizes):
    return types.SimpleNamespace(shape=sizes)


def _ref_leaves(spec_tree):
    return {".".join(path): s for path, s in jmodule._walk(spec_tree)}


def _pairs(model, ref_specs):
    """(port name, port spec, reference spec, stacked) of every port
    parameter, through ``params.reference_leaf``."""
    ref = _ref_leaves(ref_specs)
    specs = param_specs(model)
    groups = tparams.reference_groups(specs)
    out = []
    for leaf, names in groups.items():
        stacked = tparams.is_stacked(leaf, names)
        for n in names:
            out.append((n, specs[n], ref[leaf], stacked))
    assert {leaf for leaf in groups} == set(ref)
    return out


def _spec_of(ref_spec, stacked):
    """A reference leaf's resolved spec as the port's per-layer tensor
    has it: the leading "layers" dim (replicated) dropped."""
    spec = tuple(ref_spec)
    return spec[1:] if stacked else spec


def test_param_spec_checks_axes_length():
    with pytest.raises(ValueError):
        ParamSpec((2, 3), axes=("embed",))


def test_dp_shard_count():
    assert tshard.dp_shard_count() == 1
    for sizes in SIZES:
        with tshard.use_mesh_rules(sizes):
            assert tshard.dp_shard_count() == sizes.get("pod", 1) * 16


@pytest.mark.parametrize("arch", ARCHS)
def test_depth_variant_matches_reference(arch):
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert tcfg.scan_iters() == jcfg.scan_iters()
    for it in (2, 3, 4):
        tv, jv = tcfg.depth_variant(it), jcfg.depth_variant(it)
        assert dataclasses.asdict(tv) == dataclasses.asdict(jv)
        assert tv.scan_iters() == jv.scan_iters()


def test_depth_variant_scan_iters_consistent():
    """depth_variant(i).scan_iters() is linear in i for every arch: the
    precondition of the dry-run's extrapolation."""
    for arch in ARCHS:
        cfg = tconfigs.get_config(arch)
        s2 = cfg.depth_variant(2).scan_iters()
        s3 = cfg.depth_variant(3).scan_iters()
        s4 = cfg.depth_variant(4).scan_iters()
        assert s4 - s3 == s3 - s2 != 0, arch
        assert cfg.scan_iters() >= s4, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_reference(arch):
    model = build_model(tconfigs.get_config(arch), device="meta")
    ref_specs = jbuild(jconfigs.get_config(arch)).specs()
    pairs = _pairs(model, ref_specs)
    for name, spec, ref, stacked in pairs:
        want = ref.axes[1:] if stacked else ref.axes
        assert len(spec.axes) == len(spec.shape), name
        assert spec.axes == tuple(want), (name, spec.axes, ref.axes)
        assert spec.shape == (ref.shape[1:] if stacked else ref.shape), name
        if stacked:
            assert ref.axes[0] == "layers", name
    for sizes in SIZES:
        shards = tshard.sharding_for_specs(model, sizes)
        for name, spec, ref, stacked in pairs:
            got = shards[name]
            want = _spec_of(jshard.spec_for(ref.shape, ref.axes,
                                            _mesh(sizes)), stacked)
            assert got.spec == want, (name, sizes)
            parts = [1] * len(spec.shape)
            for i, p in enumerate(got.spec):
                for a in (() if p is None else (p,) if isinstance(p, str)
                          else p):
                    parts[i] *= sizes[a]
            assert got.shape == tuple(d // n for d, n in
                                      zip(spec.shape, parts)), name
            assert got.nbytes == 4 * int(np.prod(got.shape)), name


@pytest.mark.parametrize("arch", tconfigs.SIM_ARCH_NAMES)
def test_sim_param_axes_match_reference(arch):
    sim = tconfigs.get_sim_arch(arch)
    model = AgentSimModel(sim.agent_sim_config(), device="meta")
    ref_specs = JAgentSimModel(
        jconfigs.get_sim_arch(arch).agent_sim_config()).specs()
    for name, spec, ref, stacked in _pairs(model, ref_specs):
        assert spec.axes == tuple(ref.axes[1:] if stacked else ref.axes), \
            name


def _ref_opt(jcfg, sizes, monkeypatch, adafactor):
    from repro.optim import adafactor as jadafactor
    from repro.optim import adamw as jadamw
    from repro.optim import chain as jchain
    from repro.optim import clip_by_global_norm as jclip
    specs = jbuild(jcfg).specs()
    opt = jchain(jclip(1.0), jadafactor(1e-4) if adafactor
                 else jadamw(3e-4))
    state = jax.eval_shape(opt.init, jmodule.abstract_params(specs))
    monkeypatch.setattr(jshard, "NamedSharding", lambda mesh, spec: spec)
    return jshard.derive_opt_shardings(specs, state, _mesh(sizes))


def _at(tree, leaf):
    for key in leaf.split("."):
        tree = tree[key]
    return tree


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "kimi-k2-1t-a32b"])
def test_opt_shardings_match_reference(arch, monkeypatch):
    tcfg = tconfigs.get_config(arch)
    adafactor = arch.startswith("kimi")
    model = build_model(tcfg, device="meta")
    state = dryrun.choose_optimizer(tcfg).init(
        dict(model.named_parameters()))
    names = list(param_specs(model))
    groups = tparams.reference_groups(names)
    for sizes in SIZES:
        want = _ref_opt(jconfigs.get_config(arch), sizes, monkeypatch,
                        adafactor)
        got = tshard.derive_opt_shardings(model, state, sizes)
        assert got[0] == () and want[0] == ()
        tstate, jstate = got[1], want[1]
        assert tstate["step"].spec == () and tuple(jstate["step"]) == ()
        for leaf, ns in groups.items():
            stacked = tparams.is_stacked(leaf, ns)
            for n in ns:
                if adafactor:
                    ref = _at(jstate["v"], leaf)
                    assert sorted(tstate["v"][n]) == sorted(ref), n
                    for k, sh in tstate["v"][n].items():
                        assert sh.spec == _spec_of(ref[k], stacked), (n, k)
                else:
                    for k in ("mu", "nu"):
                        assert tstate[k][n].spec == _spec_of(
                            _at(jstate[k], leaf), stacked), (n, k)
        assert tshard.shard_bytes(got) > 0


def _dtype_name(x):
    return str(x).split(".")[-1] if isinstance(x, torch.dtype) \
        else np.dtype(x).name


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


def _port_path(path):
    """The port's cache path of a reference cache leaf: the attention
    rows sit in the block's dict, not under "attn"."""
    return tuple(p for p in path if p != "attn")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    """Train and prefill inputs, and decode's tokens, index and enc_out,
    in the reference's shapes and dtypes. The decode cache holds the
    reference's bytes in all; its layouts differ so: the port keeps the
    attention rows in the block's dict (the reference under "attn"); a
    group of one layer is stacked too (a leading dim of 1: hymba's
    global layers, the MoE configs' leading dense layer); MLA keeps
    ``ckv`` and ``kr`` side by side in one (L, B, 1, S, r + dr) ``ckv``
    (deepseek, kimi)."""
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    model = build_model(tcfg, device="meta")
    for name, shape in tconfigs.SHAPES.items():
        got = tsteps.input_specs(tcfg, shape, model)
        want = jsteps.input_specs(jcfg, jconfigs.SHAPES[name])
        assert sorted(got) == sorted(want), name
        for k, v in got.items():
            if k == "cache":
                continue
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), (name, k)
            assert _dtype_name(v.dtype) == _dtype_name(want[k].dtype)
        if shape.mode != "decode":
            continue
        tc, jc = dict(_flat(got["cache"])), dict(_flat(want["cache"]))
        assert sum(v.numel() * v.element_size() for v in tc.values()) == \
            sum(int(np.prod(v.shape)) * np.dtype(v.dtype).itemsize
                for v in jc.values()), name
        for path, ref in jc.items():
            port = tc.get(_port_path(path))
            if port is None:                # MLA's kr, within the port's ckv
                assert tcfg.attention_kind == "mla" and path[-1] == "kr"
                continue
            shp = tuple(port.shape)
            if tcfg.attention_kind == "mla" and path[-1] == "ckv":
                shp = shp[:-1] + (tcfg.mla.kv_lora_rank,)
            assert shp in (tuple(ref.shape), (1,) + tuple(ref.shape)), path
            assert _dtype_name(port.dtype) == _dtype_name(ref.dtype), path


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "rwkv6-7b",
                                  "whisper-base", "gemma2-27b"])
def test_cache_and_batch_shardings_match_reference(arch, monkeypatch):
    monkeypatch.setattr(jshard, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jsteps, "NamedSharding", lambda mesh, spec: spec,
                        raising=False)
    import jax.sharding as jsh
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    for sizes in SIZES:
        got = tsteps.batch_shardings(tsteps.input_specs(
            tcfg, tconfigs.SHAPES["decode_32k"]), sizes)
        want = jsteps.batch_shardings(jsteps.input_specs(
            jcfg, jconfigs.SHAPES["decode_32k"]), _mesh(sizes))
        for k in ("tokens", "index", "enc_out"):
            if k in want:
                assert got[k].spec == tuple(want[k]), (k, sizes)
        tc = dict(_flat(got["cache"]))
        for path, ref in _flat(want["cache"]):
            assert tc[_port_path(path)].spec == tuple(ref), (path, sizes)

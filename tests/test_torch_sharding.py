"""The port's logical-axis sharding (`repro_torch.sharding`), its
`ParamDef.axes` and `AdamW.state_axes` against the JAX package's.

The JAX side needs no 512 devices: the rules and specs are taken under a
`jax.sharding.AbstractMesh` of the production shapes, set into the
thread-local that `repro.sharding.use_mesh` sets.  Only the slices each
device holds (`NamedSharding.shard_shape` and the index of each device's
slice) need devices: one subprocess runs JAX on 8 fake XLA devices as a
(2, 4) mesh for every case of the file.

The port keeps one parameter a layer where the JAX package stacks layers
along leading axes, so a port parameter `layers.3.attn.wq` is the JAX
leaf `layers/attn/wq`, whose axes (and specs) carry one leading None a
stacking axis.
"""

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import sharding as JSH
from repro.configs import get_config as jax_config
from repro.models import common as JC
from repro.models import lm as JLM
from repro.optim import adamw as JOPT
from repro_torch import sharding as SH
from repro_torch.configs import REGISTRY, get_config
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import common as C
from repro_torch.models import lm as LM
from repro_torch.optim import adamw as OPT

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(REGISTRY)
POD_SHAPES = {"pod1": ((16, 16), ("data", "model")),
              "pod2": ((2, 16, 16), ("pod", "data", "model"))}
META = torch.device("meta")


def _port_mesh(name):
    return make_production_mesh(multi_pod=name == "pod2",
                                devices=[META] * 512)


@contextlib.contextmanager
def _jax_mesh(name, fsdp=True):
    shape, axes = POD_SHAPES[name]
    amesh = AbstractMesh(shape, axes)
    prev = (JSH._CTX.mesh, JSH._CTX.rules)
    JSH._CTX.mesh, JSH._CTX.rules = amesh, JSH.make_rules(amesh, fsdp)
    try:
        yield
    finally:
        JSH._CTX.mesh, JSH._CTX.rules = prev


@contextlib.contextmanager
def both(name, fsdp=True):
    with _jax_mesh(name, fsdp), SH.use_mesh(_port_mesh(name), fsdp):
        yield


def _spec(p):
    return tuple(p)


def _split(name):
    parts = name.split(".")
    return "/".join(x for x in parts if not x.isdigit()), \
        sum(x.isdigit() for x in parts)


def _jax_leaves(tree, is_leaf):
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=is_leaf)[0]}


@pytest.mark.parametrize("name", ["pod1", "pod2"])
@pytest.mark.parametrize("fsdp", [True, False])
def test_make_rules_match_jax(name, fsdp):
    shape, axes = POD_SHAPES[name]
    want = JSH.make_rules(AbstractMesh(shape, axes), fsdp)
    assert SH.make_rules(_port_mesh(name), fsdp) == want
    assert SH.make_rules(None) == JSH.make_rules(None) == {}


CASES = [
    (("batch", None), (256, 4096)),
    (("embed", "heads", None), (4096, 48, 128)),
    (("embed", "kv_heads", None), (4096, 8, 128)),       # 8 on 16: whole
    (("batch", "act_seq", "kv_heads", None), (128, 32768, 8, 128)),
    (("batch", "act_seq", "kv_heads", None), (128, 1, 16, 128)),
    (("vocab", "embed"), (256000, 4096)),
    (("expert", "embed", None), (256, 7168, 2048)),
    (("expert_full", "embed", None), (256, 7168, 2048)),
    (("qblocks", None), (4096, 128)),
    (("embed", "embed"), (64, 64)),                      # first one wins
    ((None, "mlp"), (4, 3)),
    ((), ()),
]


@pytest.mark.parametrize("name", ["pod1", "pod2"])
def test_logical_spec_matches_jax(name):
    with both(name):
        for axes, shape in CASES:
            for shp in (shape, None):
                got = SH.logical_spec(axes, shp)
                want = JSH.logical_spec(axes, shp)
                assert _spec(got) == _spec(want), (axes, shp, got, want)
    # no mesh: every dimension whole
    assert _spec(SH.logical_spec(("batch", "embed"))) == (None, None)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_jax_leaf_by_leaf(arch):
    """Every parameter's axes at full size, and the decode cache's, equal
    the JAX leaf's with one None a stacking axis; every JAX leaf has a
    port parameter."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    defs = LM.model_defs(cfg)
    jdefs = _jax_leaves(JLM.model_defs(jcfg), JC.is_def)
    cache = _named_cache(LM.cache_defs(cfg, 2, 64))
    jcache = _jax_leaves(JLM.cache_defs(jcfg, 2, 64), JC.is_def)
    for port, jax_ in ((defs, jdefs), (cache, jcache)):
        seen = set()
        for name, d in port.items():
            path, k = _split(name)
            jd = jax_[path]
            assert jd.axes == (None,) * k + d.axes, (name, d.axes, jd.axes)
            assert tuple(jd.shape[k:]) == d.shape, name
            seen.add(path)
        assert seen == set(jax_) - {"pos"}, set(jax_) ^ seen


def _named_cache(tree, prefix=""):
    out = {}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree))
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, C.ParamDef):
            out[name] = v
        elif isinstance(v, (dict, list)):
            out.update(_named_cache(v, name + "."))
    return out


@pytest.mark.parametrize("name", ["pod1", "pod2"])
@pytest.mark.parametrize("arch", ["minitron-8b", "deepseek-v3-671b",
                                  "whisper-large-v3", "zamba2-2.7b"])
def test_spec_tree_matches_jax(arch, name):
    """`common.spec_tree` (the divisibility fallback on) at full size."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    defs = LM.model_defs(cfg)
    with both(name):
        got = C.spec_tree(defs)
        want = _jax_leaves(JC.spec_tree(JLM.model_defs(jcfg)),
                           lambda t: isinstance(t, jax.sharding.PartitionSpec))
    for n, spec in got.items():
        path, k = _split(n)
        assert (None,) * k + _spec(spec) == _spec(want[path]), n


@pytest.mark.parametrize("bits", [32, 8])
@pytest.mark.parametrize("arch", ["minitron-8b", "moonshot-v1-16b-a3b",
                                  "mamba2-1.3b"])
def test_state_axes_and_their_specs_match_jax(arch, bits):
    cfg, jcfg = get_config(arch), jax_config(arch)
    axes = C.axes_tree(LM.model_defs(cfg))
    jaxes = JC.axes_tree(JLM.model_defs(jcfg))
    got = OPT.state_axes(axes, OPT.AdamWConfig(state_bits=bits))
    want = JOPT.state_axes(jaxes, JOPT.AdamWConfig(state_bits=bits))
    assert got.step == want.step == ()
    is_axes = lambda t: isinstance(t, tuple) and all(
        a is None or isinstance(a, str) for a in t)
    with both("pod1"):
        got_specs = SH.spec_tree(got)
        want_specs = JSH.spec_tree(want)
    for field in ("m", "v"):
        mine, theirs = getattr(got, field), getattr(want, field)
        mine_s, theirs_s = getattr(got_specs, field), \
            getattr(want_specs, field)
        if bits == 8:
            jq = _jax_leaves(theirs, lambda t: isinstance(t, JOPT.QTensor))
            js = _jax_leaves(theirs_s, lambda t: isinstance(t, JOPT.QTensor))
            for n, q in mine.items():
                path, _ = _split(n)
                assert isinstance(q, OPT.QTensor)
                assert (q.q, q.scale) == (jq[path].q, jq[path].scale)
                s = mine_s[n]
                assert (_spec(s.q), _spec(s.scale)) == \
                    (_spec(js[path].q), _spec(js[path].scale))
            continue
        ja = _jax_leaves(theirs, is_axes)
        js = _jax_leaves(theirs_s,
                         lambda t: isinstance(t, jax.sharding.PartitionSpec))
        for n, a in mine.items():
            path, k = _split(n)
            assert ja[path] == (None,) * k + a, n
            assert _spec(js[path]) == (None,) * k + _spec(mine_s[n]), n


JAX_SHARDS = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
cases = json.loads(sys.argv[1])
mesh = jax.make_mesh((2, 4), ("data", "model"))
out = []
for shape, spec in cases:
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    sh = NamedSharding(mesh, P(*spec))
    idx = sh.devices_indices_map(tuple(shape))
    blocks = [[[s.start or 0, s.stop if s.stop is not None else n]
               for s, n in zip(idx[d], shape)] for d in mesh.devices.flat]
    out.append([list(sh.shard_shape(tuple(shape))), blocks])
print(json.dumps(out))
"""

SHARD_CASES = [
    ((8, 12), ("data", "model")),
    ((8, 12), ("model", None)),
    ((16, 6, 4), (("data", "model"), None, None)),
    ((16, 6, 4), (("model", "data"), None, None)),
    ((6, 8), (None, "data")),
    ((4, 4), ()),
    ((8,), ("model",)),
]


def test_named_sharding_slices_match_jax():
    """`shard_shape` and the slice each mesh position holds (row-major)
    equal JAX's `shard_shape` and `devices_indices_map` on a (2, 4) mesh
    of 8 fake devices; `shard` then `gather` gives the tensor back."""
    import json
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    cases = [[list(s), [list(e) if isinstance(e, tuple) else e for e in sp]]
             for s, sp in SHARD_CASES]
    r = subprocess.run([sys.executable, "-c", JAX_SHARDS, json.dumps(cases)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    mesh = Mesh(np.array([torch.device("cpu")] * 8, dtype=object)
                .reshape(2, 4), ("data", "model"))
    for (shape, spec), (jshape, jblocks) in zip(SHARD_CASES, want):
        sh = SH.NamedSharding(mesh, spec)
        assert list(sh.shard_shape(shape)) == jshape, (shape, spec)
        for pos, jb in enumerate(jblocks):
            got = [[s.start, s.stop] for s in sh.block(pos, shape)]
            assert got == jb, (shape, spec, pos)
        t = torch.arange(int(np.prod(shape))).reshape(shape)
        parts = sh.shard(t)
        assert len(parts) == 8
        assert torch.equal(sh.gather(parts, shape), t)


def test_named_sharding_refuses_what_does_not_split():
    mesh = Mesh(np.array([torch.device("cpu")] * 8, dtype=object)
                .reshape(2, 4), ("data", "model"))
    with pytest.raises(ValueError, match="does not split"):
        SH.NamedSharding(mesh, ("model",)).shard_shape((6,))
    with pytest.raises(ValueError, match="no mesh axis"):
        SH.NamedSharding(mesh, ("pod",))
    with pytest.raises(ValueError, match="twice"):
        SH.NamedSharding(mesh, ("data", "data"))


def test_constrain_changes_nothing():
    x = torch.randn(4, 6)
    with SH.use_mesh(_port_mesh("pod1")):
        assert SH.constrain(x, "batch", "embed") is x
    assert SH.current_mesh() is None


def test_abstract_params_allocate_nothing_and_keep_dtypes():
    cfg = get_config("deepseek-v3-671b")
    defs = LM.model_defs(cfg)
    params = C.abstract_params(defs, cfg.torch_dtype)
    assert all(t.device.type == "meta" for t in params.values())
    assert sum(t.numel() for t in params.values()) == \
        sum(int(np.prod(d.shape)) for d in defs.values())
    router = [n for n in params if n.endswith("moe.router")][0]
    assert params[router].dtype == torch.float32
    with SH.use_mesh(_port_mesh("pod1")):
        shardings = SH.sharding_tree(C.axes_tree(defs))
    assert all(isinstance(s, SH.NamedSharding) for s in shardings.values())
    assert all(s is None for s in SH.sharding_tree(
        C.axes_tree(defs)).values())

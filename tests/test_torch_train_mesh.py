"""`train(mesh=)` and `launch.train --mesh/--fake-devices` on logical CPU
meshes.

With one batch shard (a 1 x 4 mesh: the "batch" rule maps to "data", of
size 1) the run equals `train()` bit for bit: the forward and backward are
the one-device step's, the global norm is taken over the whole gradient,
and AdamW's update is elementwise, so updating the parameter and moment
slices of the FSDP specs is updating the whole leaves.  With two batch
shards (2 x 2) the gradients are the mean of two half-batch gradients,
which parts from the whole-batch gradient by float32 rounding: after 3
steps the losses stay within 1e-5 relative and every parameter within
1e-4 of max|p| (the card-against-CPU gate of PERF.md §2).  A checkpoint
holds whole arrays, so a 2 x 2 run restores under no mesh and under 1 x 4
bit for bit, and the next step of both is the same.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from repro_torch import configs as TCONF
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import train as LAUNCH
from repro_torch.launch.mesh import logical_mesh
from repro_torch.optim import adamw as OPT
from repro_torch.train.loop import TrainConfig, train
from test_torch_train_common import few_threads  # noqa: F401

QUIET = dict(log_every=1000)
LOSS_REL = 1e-5
PARAM_REL = 1e-4


def _cfg():
    return dataclasses.replace(TCONF.reduced(TCONF.get_config("minitron-8b")),
                               dtype="float32")


def _run(mesh=None, steps=3, bits=32, **tkw):
    cfg = _cfg()
    data = DataConfig(vocab=cfg.vocab_, seq_len=32, global_batch=4)
    kw = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
    return train(cfg, TrainConfig(steps=steps, **QUIET, **tkw), data,
                 OPT.AdamWConfig(state_bits=bits), log_fn=lambda s: None,
                 **kw)


def _params(out):
    return {n: p.detach().clone() for n, p in
            out["params"].named_parameters()}


def _moments(out):
    flat = {}
    for f in ("m", "v"):
        for n, x in getattr(out["opt_state"], f).items():
            if isinstance(x, OPT.QTensor):
                flat[f"{f}/{n}/q"], flat[f"{f}/{n}/s"] = x.q, x.scale
            else:
                flat[f"{f}/{n}"] = x
    return flat


def _assert_equal(a, b):
    assert a["history"] == b["history"]
    pa, pb = _params(a), _params(b)
    assert pa.keys() == pb.keys()
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
    ma, mb = _moments(a), _moments(b)
    assert ma.keys() == mb.keys()
    for n in ma:
        assert torch.equal(ma[n], mb[n]), n
    assert a["opt_state"].step == b["opt_state"].step


@pytest.fixture(scope="module")
def plain():
    return _run()


@pytest.mark.parametrize("bits", [32, 8])
def test_one_batch_shard_is_bit_equal_to_train(plain, bits):
    ref = plain if bits == 32 else _run(bits=8)
    got = _run(logical_mesh("cpu", (1, 4)), bits=bits)
    _assert_equal(got, ref)
    assert got["final_step"] == 3


def test_two_batch_shards_stay_within_the_gate(plain):
    got = _run(logical_mesh("cpu", (2, 2)))
    h, w = np.array(got["history"]), np.array(plain["history"])
    assert np.abs(h - w).max() <= LOSS_REL * np.abs(w).max(), (h, w)
    pa, pb = _params(got), _params(plain)
    for n in pa:
        top = float(pb[n].abs().max())
        err = float((pa[n] - pb[n]).abs().max())
        assert err <= PARAM_REL * max(top, 1e-30), (n, err, top)


def test_resume_across_meshes_is_exact(tmp_path):
    """2 x 2 saves at step 2; restored under no mesh and under 1 x 4 the
    state is the saved one bit for bit, and the third step taken under
    each is the same."""
    saved = _run(logical_mesh("cpu", (2, 2)), steps=2,
                 ckpt_dir=str(tmp_path / "a"), ckpt_every=2)
    for tag in ("none", "1x4", "none3", "1x4_3"):
        shutil.copytree(tmp_path / "a", tmp_path / tag)
    mesh14 = lambda: logical_mesh("cpu", (1, 4))
    back_none = _run(steps=2, ckpt_dir=str(tmp_path / "none"))
    back_14 = _run(mesh14(), steps=2, ckpt_dir=str(tmp_path / "1x4"))
    for back in (back_none, back_14):
        assert back["history"] == [] and back["final_step"] == 2
        _assert_equal(dict(back, history=saved["history"]), saved)
    on_none = _run(steps=3, ckpt_dir=str(tmp_path / "none3"))
    on_14 = _run(mesh14(), steps=3, ckpt_dir=str(tmp_path / "1x4_3"))
    assert len(on_none["history"]) == 1
    _assert_equal(on_14, on_none)


def test_launch_train_on_a_host_mesh_of_fake_devices(capsys, tmp_path):
    rc = LAUNCH.main(["--arch", "minitron-8b", "--reduced", "--steps", "2",
                      "--seq-len", "16", "--global-batch", "4",
                      "--device", "cpu", "--mesh", "host",
                      "--fake-devices", "4",
                      "--ckpt-dir", str(tmp_path / "run")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "mesh: {'data': 1, 'model': 4} (4 shard(s) of cpu)" in out
    assert "final loss" in out and "after 2 steps" in out


@pytest.mark.parametrize("mesh,need", [("pod1", 256), ("pod2", 512)])
def test_launch_train_refuses_a_pod_mesh_without_its_devices(capsys, mesh,
                                                             need):
    with pytest.raises(SystemExit) as e:
        LAUNCH.main(["--arch", "minitron-8b", "--reduced", "--steps", "1",
                     "--device", "cpu", "--mesh", mesh,
                     "--fake-devices", "8"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert f"--mesh {mesh}: " in err and f"needs {need} devices, have 8" in err

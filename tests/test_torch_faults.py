"""The port's fault injection (`repro_torch.faults`) against the JAX
package's (`repro.faults`): the same rule strings and tags fire on the
same occurrences in both, `classify_error` sorts the same exceptions the
same way, and `corrupt_file` flips the same bytes."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import faults as JFLT  # noqa: E402
from repro_torch import faults as TFLT  # noqa: E402

RULES = [
    "chunk_crash:at=3",
    "chunk_crash:at=1,4,5",
    "slow_chunk:after=2:times=3:delay=0",
    "slow_chunk:times=inf:delay=0",
    "chunk_crash@job-7:at=2",
    "ckpt_corrupt:p=0.3:seed=9",
    "ckpt_corrupt:p=0.7:seed=2;chunk_crash@job-1:after=1:times=2",
    "compile_fail:p=0.5",
]
TAGS = ["job-1|fused|chunk=1", "job-7|fused|chunk=2", "job-1|fused|chunk=3",
        "job-7|islands|chunk=4", "|reference|chunk=5", "job-1|fused|chunk=6"]


def _decisions(mod, text):
    inj = mod.parse_faults(text)
    out = []
    for i in range(40):
        tag = TAGS[i % len(TAGS)]
        for site in mod.SITES:
            rule = inj.fires(site, tag)
            out.append(None if rule is None else
                       (site, rule.site, rule.match, rule.at, rule.after,
                        rule.times, rule.p, rule.seed, rule.delay_s))
    return out, inj.stats()


@pytest.mark.parametrize("text", RULES)
def test_same_fire_sequence(text):
    assert _decisions(TFLT, text) == _decisions(JFLT, text)


def test_same_sites_env_var_and_permanent_types():
    assert TFLT.SITES == JFLT.SITES
    assert TFLT.ENV_VAR == JFLT.ENV_VAR == "REPRO_GA_FAULTS"
    assert TFLT.PERMANENT_TYPES == JFLT.PERMANENT_TYPES
    for n in range(1, 50):
        assert TFLT._hash01(7, "chunk_crash", n) == \
            JFLT._hash01(7, "chunk_crash", n)


@pytest.mark.parametrize("bad", ["nope:at=1", "chunk_crash:when=3",
                                 "chunk_crash:p=1.5"])
def test_same_rule_errors(bad):
    with pytest.raises(ValueError):
        JFLT.parse_faults(bad)
    with pytest.raises(ValueError):
        TFLT.parse_faults(bad)


def _errors(mod):
    return [mod.ChunkCrash("c"), mod.CompileFail("f"), ValueError("v"),
            TypeError("t"), KeyError("k"), IndexError("i"),
            AttributeError("a"), AssertionError("s"),
            NotImplementedError("n"), ZeroDivisionError("z"),
            RuntimeError("CUDA error: an illegal memory access"),
            torch.cuda.OutOfMemoryError("CUDA out of memory"), OSError("io")]


def test_same_error_classes():
    got = [TFLT.classify_error(e) for e in _errors(TFLT)]
    want = [JFLT.classify_error(e) for e in _errors(JFLT)]
    assert got == want
    # the card's errors stay worth a retry
    assert got[-3:] == ["transient"] * 3


def test_inject_actions():
    inj = TFLT.parse_faults("chunk_crash:at=2;compile_fail:at=1;"
                            "slow_chunk:at=1:delay=0;ckpt_corrupt:at=1")
    assert inj.inject("chunk_crash", "a") is None
    with pytest.raises(TFLT.ChunkCrash) as e:
        inj.inject("chunk_crash", "b")
    assert e.value.tag == "b" and TFLT.classify_error(e.value) == "transient"
    with pytest.raises(TFLT.CompileFail):
        inj.inject("compile_fail", "c")
    assert inj.inject("slow_chunk", "d").delay_s == 0.0
    assert inj.inject("ckpt_corrupt", "e").site == "ckpt_corrupt"
    assert inj.stats() == {"chunk_crash": 1, "compile_fail": 1,
                           "slow_chunk": 1, "ckpt_corrupt": 1}
    inj.add_rule("chunk_crash@late:at=1")
    with pytest.raises(TFLT.ChunkCrash):
        inj.inject("chunk_crash", "late")


def test_resolve_and_ambient(monkeypatch):
    monkeypatch.delenv(TFLT.ENV_VAR, raising=False)
    assert TFLT.resolve_faults(None) is None
    monkeypatch.setenv(TFLT.ENV_VAR, "chunk_crash:at=2")
    amb = TFLT.resolve_faults(None)
    assert amb is TFLT.resolve_faults(None)       # memoized per rule string
    assert TFLT.resolve_faults(False) is None     # disarms against the env
    inj = TFLT.parse_faults("slow_chunk:at=1")
    assert TFLT.resolve_faults(inj) is inj
    assert isinstance(TFLT.resolve_faults("chunk_crash:at=1"),
                      TFLT.FaultInjector)
    with pytest.raises(TypeError):
        TFLT.resolve_faults(3)


def test_corrupt_file_flips_the_same_bytes(tmp_path):
    data = np.random.default_rng(0).integers(0, 256, 4096,
                                             dtype=np.uint8).tobytes()
    paths = []
    for mod in (JFLT, TFLT):
        p = os.path.join(str(tmp_path), mod.__name__)
        with open(p, "wb") as f:
            f.write(data)
        mod.corrupt_file(p, seed=5, nbytes=16)
        paths.append(p)
    a, b = (open(p, "rb").read() for p in paths)
    assert a == b and a != data

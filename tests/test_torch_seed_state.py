"""The initial state's seed words (`kernels.lfsr_kernel.seed_state_kernel`)
on the CPU: its plain twin against the seed words laid out from
`core.lfsr.np_seeds` in NumPy, `core.ga.init_states`' dispatch by device
(the CPU never loads the kernel library), and the wrapper's refusals.  The
kernel against the twin on the card is `tests/test_torch_cuda.py::
test_seed_state_kernel_matches_plain`, over the same kinds of case with the
cells' shapes at full size, and `chip_smoke.py`'s `seed_state` row, whose
stacks are checked here against the benchmark's configurations:

    PYTHONPATH=src python -m pytest -q tests/test_torch_seed_state.py
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ga as TG  # noqa: E402
from repro_torch.core import islands as TISL  # noqa: E402
from repro_torch.core import lfsr  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import lfsr_kernel as K4  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# (seed, word): seeds whose splitmix stream has a raw 0 at that word
# (0-based) of an N=16, V=2 state, one in each bank (sel 0-31, cross 32-47,
# mut 48-79, population 80-111); the 0xDEADBEEF rule replaces it.  Found
# once by a sweep of seeds 0 to 213,909,503 on a card, in PyTorch's int64
# arithmetic; `test_zero_word_becomes_deadbeef` checks each pair in NumPy,
# and `tests/test_torch_cuda.py` holds the kernel to them.
ZERO_WORDS = ((74_344_218, 21), (31_088_890, 46), (84_749_951, 60),
              (117_373_398, 82))

# (n, v, c, seeds): the cells' shapes at CPU sizes (a D=100 stack cut to 2
# replicas), N not a power of two, V=1 and R=1, c of 1, 16 and 32, seeds at
# the edges of 32 bits and past them, a packed job's seed list, an island
# ring's seeds
CASES = {
    "d10": (1024, 10, 16, list(range(7, 7 + 51))),
    "d100": (4096, 100, 16, [3_000_000_017, 3_000_000_018]),
    "n66": (66, 3, 10, [1, 2, 3]),
    "n100": (100, 2, 12, [5, 6]),
    "v1-r1": (16, 1, 10, [123]),
    "c1": (64, 4, 1, [0, 1]),
    "c32": (64, 4, 32, [0, 1]),
    "seed-edges": (32, 2, 10, [0, 2**32 - 1, -5, 2**32 + 7]),
    "packed": (64, 2, 10, [9, 2, 1_000_003, 2, 77]),
    "islands": (32, 2, 10, [11 + 7919 * (i + 1) for i in range(8)]),
    "zero-words": (16, 2, 10, [1] + [sd for sd, _ in ZERO_WORDS]),
}


def expected_state(n, v, c, seeds):
    """The five leaves as uint32 from `np_seeds` alone, in NumPy."""
    words = np.stack([lfsr.np_seeds(sd, K4.state_words(n, v))
                      for sd in seeds])
    r, a, b = len(seeds), 2 * n, 2 * n + v * (n // 2)
    init = lfsr.np_steps(words[:, b + v * n:].reshape(r, n, v), 8)
    x = init if c == 32 else init >> np.uint32(32 - c)
    return (x, words[:, :a].reshape(r, 2, n),
            words[:, a:b].reshape(r, v, n // 2),
            words[:, b:b + v * n].reshape(r, v, n),
            np.zeros(r, np.uint32))


def as_u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_twin_matches_np_seeds(case):
    n, v, c, seeds = CASES[case]
    got = K4.seed_state_plain(n, v, c, seeds, "cpu")
    for name, g, w in zip(("x", "sel", "cross", "mut", "k"), got,
                          expected_state(n, v, c, seeds)):
        assert g.dtype == torch.int32 and g.is_contiguous(), name
        np.testing.assert_array_equal(as_u32(g), w, err_msg=name)


@pytest.mark.parametrize("seed,word", ZERO_WORDS)
def test_zero_word_becomes_deadbeef(seed, word):
    # arrays, not scalars: NumPy wraps uint64 arrays without a warning
    z = np.array([word + 1], np.uint64) + np.array([seed], np.uint64) * \
        np.uint64(0x9E3779B9)
    z = z * np.uint64(0xBF58476D1CE4E5B9)
    z ^= z >> np.uint64(31)
    z = z * np.uint64(0x94D049BB133111EB)
    z ^= z >> np.uint64(27)
    assert int(z[0]) & 0xFFFFFFFF == 0
    assert lfsr.np_seeds(seed, word + 1)[word] == 0xDEADBEEF
    x, sel, cross, mut, _ = K4.seed_state_plain(16, 2, 10, [seed], "cpu")
    raw = np.concatenate([as_u32(t).ravel() for t in (sel, cross, mut)])
    if word < raw.size:
        assert raw[word] == 0xDEADBEEF
    else:
        init = lfsr.np_steps(np.array([0xDEADBEEF], np.uint32), 8)
        assert as_u32(x).ravel()[word - raw.size] == init[0] >> 22


@pytest.fixture
def no_kernel_library(monkeypatch):
    def refuse(name, declare):
        raise AssertionError(f"the CPU path loaded kernel library {name!r}")
    monkeypatch.setattr(build, "library", refuse)


@pytest.mark.parametrize("seeds", [[4], [4, 5, 6], [2**40, -1]])
def test_cpu_init_never_loads_the_kernel_library(no_kernel_library, seeds):
    cfg = TG.GAConfig(n=32, c=10, v=3, seed=seeds[0])
    st = TG.init_states(cfg, seeds, device="cpu")
    assert st.x.shape == (len(seeds), 32, 3)
    TG.init_state(cfg, device="cpu")
    TISL.init_islands(TISL.IslandConfig(cfg, n_islands=len(seeds)),
                      device="cpu")


@pytest.mark.parametrize("kw,err", [
    (dict(device="meta"), "CPU or a CUDA"),
    (dict(n=15), "even N"),
    (dict(n=0), "even N"),
    (dict(v=0), "V >= 1"),
    (dict(c=0), r"\[1, 32\]"),
    (dict(c=33), r"\[1, 32\]"),
    (dict(seeds=[]), "at least one seed"),
])
def test_wrapper_refuses(kw, err):
    args = dict(n=16, v=2, c=10, seeds=[1], device="cpu")
    args.update(kw)
    with pytest.raises(ValueError, match=err):
        K4.seed_state_kernel(args.pop("n"), args.pop("v"), args.pop("c"),
                             args.pop("seeds"), **args)


@pytest.mark.parametrize("config", ["cec17-rastrigin-d10",
                                    "cec17-rastrigin-d100"])
def test_chip_smoke_holds_the_cells_stacks(config):
    """`chip_smoke.py`'s `seed_state` row holds the kernel to its twin, and
    times it, at each benchmark configuration's initial stack."""
    spec = json.loads((ROOT / "gabench" / "configs" /
                       f"{config}.json").read_text())["spec"]
    where = importlib.util.spec_from_file_location("chip_smoke",
                                                   ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(where)
    where.loader.exec_module(smoke)
    v = int(spec["problem"].split(":")[1])
    assert (spec["n"], v, spec["n_repeats"]) in smoke.SEED_STATE_SHAPES

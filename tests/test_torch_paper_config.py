"""The paper's experiment grid in the port (`repro_torch.configs.ga_paper`)
against the JAX package's `repro.configs.ga_paper`: the four constants,
and every configuration of the grid field for field (exact: they are
integers, booleans, strings and one float literal)."""

import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import ga_paper as JP  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import ga_paper as TP  # noqa: E402


def test_constants_match_jax():
    assert (TP.POPULATIONS, TP.BIT_WIDTHS, TP.K_GENERATIONS,
            TP.MUTATION_RATE) == (JP.POPULATIONS, JP.BIT_WIDTHS,
                                  JP.K_GENERATIONS, JP.MUTATION_RATE)
    assert len(TP.POPULATIONS) * len(TP.BIT_WIDTHS) * 3 == 75


@pytest.mark.parametrize("mode", ["lut", "arith"])
@pytest.mark.parametrize("m", JP.BIT_WIDTHS)
@pytest.mark.parametrize("n", JP.POPULATIONS)
def test_paper_config_matches_jax(n, m, mode):
    got = dataclasses.asdict(TP.paper_config(n=n, m=m, mode=mode, seed=3))
    want = dataclasses.asdict(JP.paper_config(n=n, m=m, mode=mode, seed=3))
    assert got == want
    t, j = TP.paper_config(n=n, m=m, mode=mode), JP.paper_config(n=n, m=m,
                                                                 mode=mode)
    assert (t.p, t.idx_bits, t.cut_bits, t.m) == (j.p, j.idx_bits,
                                                  j.cut_bits, j.m)


def test_defaults_match_jax_and_stay_out_of_the_lm_registry():
    assert dataclasses.asdict(TP.paper_config()) == \
        dataclasses.asdict(JP.paper_config())
    assert "ga_paper" not in configs.REGISTRY
    assert not any("paper" in name for name in configs.list_archs())

"""The port on the card: the CUDA kernel K1 against its plain PyTorch version
on the same card tensors, and the fused backend against the reference.

Every test here needs an NVIDIA GPU and nvcc; elsewhere they skip.  Only
torch and the port are imported, so the file also runs on a machine
without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerance: F1-F3 use only +, -, *, / and sqrt, which the kernel rounds
exactly as PyTorch's elementwise kernels do (it is built with -fmad=false),
so state, y and best are bit-exact.  Problems that call cos or exp may
differ from PyTorch's library by an ulp: y within ``1e-6 * max|y|``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert, ga  # noqa: E402
from repro_torch.core import fitness as TF  # noqa: E402
from repro_torch.core import ga as TG  # noqa: E402
from repro_torch.kernels import ga_step as K  # noqa: E402

Y_TOL = 1e-6
EXACT = ("F1", "F2", "F3")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _stack(cfg, replicas, device):
    return TG.stack_states([TG.init_state(dataclasses.replace(cfg, seed=s),
                                          device=device)
                            for s in range(cfg.seed, cfg.seed + replicas)])


# Past N=1024 a block still has 1024 threads, so each thread takes several
# individuals in every phase: N=2048 and 4096 (V=2) cover that strided path.
SHAPES = ([(p, n) for p in EXACT for n in (64, 1024, 2048, 4096)]
          + [(p, n) for p in ("rastrigin:8", "ackley:8") for n in (64, 1024)])


@pytest.mark.cuda
@pytest.mark.parametrize("gens", [1, 16])
@pytest.mark.parametrize("problem,n", SHAPES)
@pytest.mark.parametrize("minimize", [True, False])
def test_kernel_matches_plain(cuda_device, problem, n, gens, minimize):
    prog = TF.compile_program(problem=problem, bits_per_var=10)
    cfg = TG.GAConfig(n=n, c=10, v=prog.n_vars, mutation_rate=0.02, seed=4,
                      minimize=minimize, mode="arith", sel_lane="gather")
    st = _stack(cfg, 6, cuda_device)
    args = (st.x, st.sel_lfsr, st.cross_lfsr, st.mut_lfsr)
    before = K.LAUNCHES["ga_generation"]
    got = K.ga_generation_kernel(*args, cfg=cfg, program=prog, gens=gens,
                                 track_best=True)
    torch.cuda.synchronize()
    assert K.LAUNCHES["ga_generation"] == before + 1
    want = K.ga_generation_plain(*args, cfg=cfg, program=prog, gens=gens,
                                 track_best=True)
    y, wy = got[4].cpu().numpy(), want[4].cpu().numpy()
    assert np.max(np.abs(y - wy)) <= Y_TOL * np.max(np.abs(wy))
    if prog.name in EXACT:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.cuda
def test_shared_memory_formula_matches_kernel(cuda_device):
    lib = K.kernel_library()
    assert lib.ga_step_smem_limit() == K.SMEM_LIMIT
    for n, v in ((2, 1), (64, 2), (1024, 8), (4096, 2), (8192, 2)):
        assert lib.ga_step_smem_bytes(n, v) == K.smem_bytes(n, v)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda_device):
    cfg = TG.GAConfig(n=8192, c=10, v=2, seed=1, mode="arith",
                      sel_lane="gather")
    prog = TF.compile_program(problem="F3", bits_per_var=10)
    st = _stack(cfg, 1, cuda_device)
    before = K.LAUNCHES["ga_generation"]
    with pytest.raises(ValueError, match="shared memory"):
        K.ga_generation_kernel(st.x, st.sel_lfsr, st.cross_lfsr,
                               st.mut_lfsr, cfg=cfg, program=prog)
    assert K.LAUNCHES["ga_generation"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("problem", ["F3", "rosenbrock:5", "sphere:8"])
def test_fused_solve_matches_reference_on_card(cuda_device, problem):
    spec = ga.GASpec(problem=problem, n=64, bits_per_var=10, mode="arith",
                     generations=40, n_repeats=4, gens_per_epoch=8, seed=3)
    before = K.LAUNCHES["ga_generation"]
    f = ga.solve(spec, backend="fused")
    assert f.backend == "fused"
    assert K.LAUNCHES["ga_generation"] == before + 5
    r = ga.solve(dataclasses.replace(spec, gens_per_epoch=1),
                 backend="reference")
    for a, b in zip(convert.state_to_numpy(f.state)[:4],
                    convert.state_to_numpy(r.state)[:4]):
        np.testing.assert_array_equal(a, b)
    assert f.best_fitness == r.best_fitness
    np.testing.assert_array_equal(f.best_x, r.best_x)

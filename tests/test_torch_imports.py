"""The port stands alone: no module under src/repro_torch/, no
scripts/torch_*.py, no examples/torch_*.py and not chip_smoke.py imports
`jax` or anything of the JAX package `repro`; and nothing under
src/repro_torch/ calls a library attention kernel."""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += sorted((ROOT / "scripts").glob("torch_*.py"))
    files += sorted((ROOT / "examples").glob("torch_*.py"))
    smoke = ROOT / "chip_smoke.py"
    if smoke.exists():
        files.append(smoke)
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_files_found():
    names = {p.name for p in _port_files()}
    assert {"lfsr.py", "fitness.py", "ga.py", "engine.py",
            "ga_step.py"} <= names
    # the serving stack and its launcher fall under the same walk, and
    rel = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"src/repro_torch/serve/scheduler.py",
            "src/repro_torch/serve/journal.py",
            "src/repro_torch/serve/metrics_http.py",
            "src/repro_torch/serve/engine.py",
            "src/repro_torch/launch/ga_serve.py"} <= rel
    # so do autotune, evolve and the run and sweep launchers
    assert {"src/repro_torch/autotune/__init__.py",
            "src/repro_torch/autotune/table.py",
            "src/repro_torch/autotune/stability.py",
            "src/repro_torch/autotune/runner.py",
            "src/repro_torch/core/evolve.py",
            "src/repro_torch/launch/ga_run.py",
            "src/repro_torch/launch/ga_autotune.py"} <= rel
    # and the mesh with its scheduler and chaos smokes
    assert {"src/repro_torch/launch/mesh.py",
            "scripts/torch_scheduler_smoke.py",
            "scripts/torch_chaos_smoke.py"} <= rel
    # and the GA side's last modules and smokes
    assert {"src/repro_torch/kernels/ops.py",
            "src/repro_torch/configs/ga_paper.py",
            "src/repro_torch/roofline.py",
            "scripts/torch_streaming_smoke.py",
            "scripts/torch_autotune_smoke.py"} <= rel
    # and the LM serving path, its launcher and the examples
    assert {"src/repro_torch/configs/base.py",
            "src/repro_torch/configs/__init__.py",
            "src/repro_torch/models/common.py",
            "src/repro_torch/models/attention.py",
            "src/repro_torch/models/lm.py",
            "src/repro_torch/models/convert.py",
            "src/repro_torch/launch/serve.py",
            "examples/torch_quickstart.py",
            "examples/torch_custom_fitness.py"} <= rel
    # and LM training: data, optimizers, the step, the loop, compressed
    # DP, the step's parity harness, the launcher and the two training
    # examples
    assert {"src/repro_torch/data/pipeline.py",
            "src/repro_torch/optim/adamw.py",
            "src/repro_torch/optim/compress.py",
            "src/repro_torch/train/step.py",
            "src/repro_torch/train/loop.py",
            "src/repro_torch/train/dp_compressed.py",
            "src/repro_torch/train/parity.py",
            "src/repro_torch/launch/train.py",
            "examples/torch_train_lm_e2e.py",
            "examples/torch_evolve_hparams.py"} <= rel
    # and the model-parallel half: expert parallelism, the logical-axis
    # rules, the sharded training state, the shape grid and the dry run
    assert {"src/repro_torch/models/moe_a2a.py",
            "src/repro_torch/sharding.py",
            "src/repro_torch/train/sharded.py",
            "src/repro_torch/launch/shapes.py",
            "src/repro_torch/launch/dryrun.py"} <= rel


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# library attention and MoE kernels the port must not call: its attention
# is the JAX package's float32 einsum form
LIBRARY_KERNELS = ("scaled_dot_product_attention", "flash_attn",
                   "flash_attention", "xformers", "memory_efficient_attention",
                   "MultiheadAttention", "grouped_mm", "_grouped_mm")


@pytest.mark.parametrize(
    "path", sorted((ROOT / "src" / "repro_torch").rglob("*.py")),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_library_attention(path):
    text = path.read_text()
    bad = [name for name in LIBRARY_KERNELS if name in text]
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


def test_mesh_holds_the_cards_constants_not_a_tpus():
    """`launch.mesh`'s roofline constants are one NVIDIA H100's: no TPU
    v5e figure (197e12 FLOP/s, 819e9 B/s, 50e9 B/s) stands in its text or
    its values."""
    from repro_torch.launch import mesh as M
    text = (ROOT / "src" / "repro_torch" / "launch" / "mesh.py").read_text()
    for tpu in ("197e12", "819e9", "50e9"):
        assert not re.search(r"(?<![\d.])" + tpu, text), tpu
    values = {M.PEAK_FLOPS_BF16, M.HBM_BW, M.NVLINK_BW}
    assert not values & {197e12, 819e9, 50e9}
    assert (M.PEAK_FLOPS_BF16, M.HBM_BW, M.NVLINK_BW) == (989e12, 3.35e12,
                                                          450e9)

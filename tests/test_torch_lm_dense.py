"""The dense family of the port's LM (minitron, yi, qwen1.5, gemma3) at reduced
size against the JAX package: forward, prefill and two decode steps in float32
and bf16, and in bf16 again at one or two layers and at full depth, the
caches, the port's own prefill/decode against its forward, and the parameter
count.  The harness and the bounds are in tests/test_torch_lm_common.py."""

import pytest

import test_torch_lm_common as H

ARCHS = ("minitron-8b", "yi-34b", "qwen1.5-32b", "gemma3-27b")


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    return H.run_arch(request.param)


@pytest.mark.parametrize("which", ["forward", "prefill", "decode1",
                                   "decode2"])
def test_logits_match_jax_f32(run, which):
    H.check_logits_f32(run, which)


def test_cache_matches_jax_f32(run):
    H.check_cache_f32(run)


@pytest.mark.parametrize("which", ["forward", "prefill", "decode1",
                                   "decode2"])
def test_bf16_matches_jax(run, which):
    H.check_bf16_matches_jax(run, which)


def test_bf16_as_accurate_as_jax(run):
    H.check_bf16_accuracy(run)


def test_bf16_deep_matches_jax(run):
    H.check_bf16_deep_matches_jax(run)


@pytest.mark.parametrize("dtype", H.DTYPES)
def test_prefill_decode_match_forward(run, dtype):
    H.check_self_consistency(run, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_jax(arch):
    H.check_param_count(arch)

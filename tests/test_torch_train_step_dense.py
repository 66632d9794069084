"""One train step of the port's dense and vlm architectures (minitron,
yi, qwen1.5, gemma3, pixtral) at reduced size against the JAX package's:
the loss, every gradient and the global norm with remat on and off, remat
bit-equal to no remat, the AdamW update, and the bf16 loss at one or two
layers.  The harness and the bounds are in tests/test_torch_train_common.py."""

import pytest

import test_torch_train_common as T
from test_torch_train_common import few_threads  # noqa: F401

ARCHS = ("minitron-8b", "yi-34b", "qwen1.5-32b", "gemma3-27b", "pixtral-12b")


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    return T.run_step(request.param)


@pytest.mark.parametrize("remat", ["remat", "plain"])
def test_loss_matches_jax(run, remat):
    T.check_losses(run, remat)


@pytest.mark.parametrize("remat", ["remat", "plain"])
def test_grads_match_jax(run, remat):
    T.check_grads(run, remat)


def test_grad_norm_matches_jax(run):
    T.check_grad_norm(run)


def test_remat_is_bit_equal(run):
    T.check_remat_bit_equal(run)


def test_update_matches_jax(run):
    T.check_update(run)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_shallow_loss_matches_jax(arch):
    T.check_bf16_loss(*T.run_bf16_shallow(arch))

"""One train step of the port's audio, SSM and hybrid architectures
(whisper, mamba2, zamba2) at reduced size against the JAX package's:
the loss, every gradient and the global norm with remat on and off, remat
bit-equal to no remat, the AdamW update, and the bf16 loss at one or two
layers.  The harness and the bounds are in tests/test_torch_train_common.py."""

import pytest

import test_torch_train_common as T
from test_torch_train_common import few_threads  # noqa: F401

ARCHS = ("whisper-large-v3", "mamba2-1.3b", "zamba2-2.7b")


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


def test_ssd_gradients_are_finite_at_the_published_chunk():
    """mamba2 reduced with its published chunk of 256 over 256 tokens: the
    port's loss equals JAX's (the forward is unchanged), but where JAX's
    `where(tri, exp(li), 0)` back-propagates 0 * inf = NaN into every
    gradient (li passes 88 above the diagonal), the port, which masks li
    before the exp, gives finite gradients; mamba2-1.3b trains at full
    width only so (chip_smoke.py phase 14)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    import test_torch_lm_common as H
    from repro.train import step as JTS
    from repro_torch.models import convert as CV
    from repro_torch.train import step as TTS

    cfg, tcfg = (dataclasses.replace(c, ssm_chunk=256)
                 for c in H.configs("mamba2-1.3b", "float32"))
    params = H.jax_params(cfg, 256, "float32")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 257))
    data = {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        JTS.make_loss_fn(cfg), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in data.items()})
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(jgrads))
    model = CV.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    loss, _, grads = TTS.value_and_grad(
        TTS.make_loss_fn(tcfg), model, T.port_batch(data))
    assert T.rel(float(loss), float(jloss)) <= T.LOSS_REL
    assert all(bool(g.isfinite().all()) for g in grads.values())

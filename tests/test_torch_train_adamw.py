"""The port's AdamW against the JAX package's `OPT.update`, fed the same
numpy parameters, gradients and state.  JAX's update runs eagerly, not
jitted: XLA's CPU jit contracts multiply-adds into FMAs (hazard H1).

The three-step tests set `grad_clip` out of reach, so the clip factor is
1 in both packages: the global norm sums each leaf's squares in another
order in the two libraries and may part by an ulp, which
`test_clip_path_matches_jax` bounds on its own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JO
from repro_torch.optim import adamw as TO
from test_torch_train_common import few_threads  # noqa: F401

SHAPES = {"a": (4, 256), "b": (300,), "c": (2, 3, 128), "d": (5, 7),
          "e": (128,)}


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _run(bits: int, steps: int = 3, grad_clip: float = 1e6, scale=3.0,
         seed: int = 0):
    rng = np.random.default_rng(seed)
    kw = dict(lr=1e-2, state_bits=bits, grad_clip=grad_clip)
    jc, tc = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = JO.init(jp, jc), TO.init(tp, tc)
    out = []
    for _ in range(steps):
        grads = {k: (rng.normal(size=s) * scale).astype(np.float32)
                 for k, s in SHAPES.items()}
        jp, js, jm = JO.update(jp, {k: jnp.asarray(v)
                                    for k, v in grads.items()}, js, jc)
        ts, tm = TO.update(tp, {k: torch.tensor(v)
                                for k, v in grads.items()}, ts, tc)
        out.append((jp, js, jm, {k: v.clone() for k, v in tp.items()},
                    _snapshot(ts), tm))
    return out


def _snapshot(st: TO.AdamState) -> TO.AdamState:
    """A copy of the port's state: `update` changes its moments in place."""
    def one(x):
        if isinstance(x, TO.QTensor):
            return TO.QTensor(x.q.clone(), x.scale.clone(), x.shape, x.npad)
        return x.clone()
    return TO.AdamState(st.step, {k: one(v) for k, v in st.m.items()},
                        {k: one(v) for k, v in st.v.items()})


def test_32bit_three_steps_within_two_ulps():
    for step, (jp, js, jm, tp, ts, tm) in enumerate(_run(32), start=1):
        assert ts.step == step and int(js.step) == step
        for k in SHAPES:
            assert _ulps(jp[k], tp[k].numpy()).max() <= 2, k
            assert _ulps(js.m[k], ts.m[k].numpy()).max() <= 2, k
            assert _ulps(js.v[k], ts.v[k].numpy()).max() <= 2, k


def test_8bit_three_steps():
    """q equal in all but 0.1% of the elements and within 1 where it
    differs; scale within 1 ulp; params within 2 ulps plus the move of one
    quantum of m (lr * scale_m / bc1 / (sqrt(v_hat) + eps), bounded here
    by lr * 10, the clip)."""
    for step, (jp, js, jm, tp, ts, tm) in enumerate(_run(8), start=1):
        assert ts.step == step
        for k in SHAPES:
            jq, tq = js.m[k], ts.m[k]
            if TO.quantizable(SHAPES[k], 128):
                assert isinstance(tq, TO.QTensor)
                assert tq.q.dtype == torch.int8
                assert tq.scale.dtype == torch.float32
                assert tuple(tq.scale.shape) == SHAPES[k][:-1] + (
                    SHAPES[k][-1] // 128,)
                for jt, tt in ((jq, tq), (js.v[k], ts.v[k])):
                    dq = np.abs(np.asarray(jt.q).astype(int)
                                - tt.q.numpy().astype(int))
                    assert dq.max() <= 1 and np.mean(dq > 0) <= 1e-3, k
                    assert _ulps(jt.scale, tt.scale.numpy()).max() <= 1, k
                quantum = 1e-2 * 10.0
            else:
                assert _ulps(jq, tq.numpy()).max() <= 2, k
                quantum = 0.0
            d = np.abs(np.asarray(jp[k]) - tp[k].numpy())
            ulp2 = 2 * np.spacing(np.abs(np.asarray(jp[k])))
            assert np.all(d <= ulp2 + quantum), k


def test_clip_path_matches_jax():
    """With the clip active (|g| ~ 100 against grad_clip 1): the global
    norm within 1e-6 relative; the parameters within 2 ulps plus 1e-6 lr
    (an ulp of the clip factor scales m and sqrt(v) alike, so it moves a
    step by a few ulps of the step: 2.3e-7 lr at most over four seeds);
    the moments within 1e-6 of their largest element."""
    for jp, js, jm, tp, ts, tm in _run(32, grad_clip=1.0, scale=5.0,
                                       seed=1):
        gn_j, gn_t = float(jm["grad_norm"]), float(tm["grad_norm"])
        assert gn_j > 1.0
        assert abs(gn_j - gn_t) <= 1e-6 * gn_j
        for k in SHAPES:
            a = np.asarray(jp[k])
            assert np.all(np.abs(a - tp[k].numpy())
                          <= 2 * np.spacing(np.abs(a)) + 1e-6 * 1e-2), k
            for jt, tt in ((js.m[k], ts.m[k]), (js.v[k], ts.v[k])):
                jt = np.asarray(jt)
                assert np.abs(jt - tt.numpy()).max() <= \
                    1e-6 * np.abs(jt).max(), k


def test_unquantizable_leaf_is_clipped_in_8bit_mode():
    """A leaf too small to quantize keeps float32 moments, but its step is
    still clipped to +-10 in 8-bit mode, as JAX clips every leaf: with
    m = 1 and v = 0 the raw step is ~1e8."""
    kw = dict(lr=1e-2, state_bits=8)
    p = np.linspace(-1, 1, 35).astype(np.float32).reshape(5, 7)
    g = np.zeros_like(p)
    m = np.ones_like(p)
    v = np.zeros_like(p)
    jc, tc = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    jst = JO.AdamState(jnp.int32(0), {"w": jnp.asarray(m)},
                       {"w": jnp.asarray(v)})
    jp, _, _ = JO.update({"w": jnp.asarray(p)}, {"w": jnp.asarray(g)}, jst,
                         jc)
    tp = {"w": torch.tensor(p)}
    TO.update(tp, {"w": torch.tensor(g)},
              TO.AdamState(0, {"w": torch.tensor(m)}, {"w": torch.tensor(v)}),
              tc)
    want = p - np.float32(1e-2) * (np.float32(10.0) + np.float32(0.1) * p)
    np.testing.assert_array_equal(tp["w"].numpy(), np.asarray(jp["w"]))
    assert _ulps(tp["w"].numpy(), want).max() <= 1
    # and unclipped in 32-bit mode
    tp32 = {"w": torch.tensor(p)}
    TO.update(tp32, {"w": torch.tensor(g)},
              TO.AdamState(0, {"w": torch.tensor(m)}, {"w": torch.tensor(v)}),
              TO.AdamWConfig(lr=1e-2))
    assert np.abs(tp32["w"].numpy() - p).max() > 1e4


@pytest.mark.parametrize("bits", [32, 8])
def test_bf16_params_are_cast_back(bits):
    rng = np.random.default_rng(2)
    kw = dict(lr=1e-2, state_bits=bits, grad_clip=1e6)
    p32 = rng.normal(size=(3, 256)).astype(np.float32)
    jp = {"w": jnp.asarray(p32, jnp.bfloat16)}
    tp = {"w": torch.tensor(p32).to(torch.bfloat16)}
    js = JO.init(jp, JO.AdamWConfig(**kw))
    ts = TO.init(tp, TO.AdamWConfig(**kw))
    for _ in range(3):
        g = rng.normal(size=(3, 256)).astype(np.float32)
        jp, js, _ = JO.update(jp, {"w": jnp.asarray(g, jnp.bfloat16)}, js,
                              JO.AdamWConfig(**kw))
        ts, _ = TO.update(tp, {"w": torch.tensor(g).to(torch.bfloat16)}, ts,
                          TO.AdamWConfig(**kw))
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["w"].float().numpy(), np.asarray(jp["w"].astype(jnp.float32)))


@pytest.mark.parametrize("bits", [32, 8])
def test_chunking_is_bit_identical(bits, monkeypatch):
    """A 4096x1024 leaf updated in chunks of 4 rows equals the update in
    one piece, bit for bit (parameters, moments and the clipped norm)."""
    rng = np.random.default_rng(3)
    cfg = TO.AdamWConfig(lr=1e-3, state_bits=bits, grad_clip=0.5)
    p = rng.normal(size=(4096, 1024)).astype(np.float32)
    runs, norms = [], []
    for chunk in (TO.CHUNK_ELEMS, 4 * 1024):
        monkeypatch.setattr(TO, "CHUNK_ELEMS", chunk)
        rng_g = np.random.default_rng(4)
        tp = {"w": torch.tensor(p), "b": torch.tensor(p[0, :100])}
        st = TO.init(tp, cfg)
        for _ in range(2):
            g = {"w": torch.tensor(rng_g.normal(size=p.shape)
                                   .astype(np.float32)),
                 "b": torch.tensor(rng_g.normal(size=100)
                                   .astype(np.float32))}
            st, om = TO.update(tp, g, st, cfg)
            norms.append(float(om["grad_norm"]))
        runs.append((tp, st))
    assert norms[:2] == norms[2:]
    (pa, sa), (pb, sb) = runs
    for k in ("w", "b"):
        assert torch.equal(pa[k], pb[k])
        for ma, mb in ((sa.m[k], sb.m[k]), (sa.v[k], sb.v[k])):
            if isinstance(ma, TO.QTensor):
                assert torch.equal(ma.q, mb.q)
                assert torch.equal(ma.scale, mb.scale)
            else:
                assert torch.equal(ma, mb)


def test_update_consumes_the_grads():
    tp = {"w": torch.ones(4, 128), "b": torch.ones(3)}
    grads = {"w": torch.ones(4, 128), "b": torch.ones(3)}
    st = TO.init(tp, TO.AdamWConfig(state_bits=8))
    TO.update(tp, grads, st, TO.AdamWConfig(state_bits=8))
    assert grads == {}


def test_bias_corrections_match_xla_for_steps_1_to_1000():
    """1 - b ** step in float32 is the word XLA computes, steps 1-1000."""
    cfg = TO.AdamWConfig()
    steps = jnp.arange(1, 1001, dtype=jnp.int32)
    for b, which in ((cfg.b1, 0), (cfg.b2, 1)):
        want = np.asarray(1.0 - b ** steps.astype(jnp.float32))
        got = np.array([TO.bias_corrections(s, cfg)[which]
                        for s in range(1, 1001)], np.float32)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_quantize_matches_jax():
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(6, 384)) * 10.0 ** rng.integers(-3, 3, (6, 1))
         ).astype(np.float32)
    x[2, :128] = 0.0                      # an all-zero block
    jq = JO._quantize(jnp.asarray(x), 128)
    tq = TO._quantize(torch.tensor(x), 128)
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_array_equal(TO._dequantize(tq).numpy(),
                                  np.asarray(JO._dequantize(jq)))
